"""Data loader construction.

Port of maskrcnn_tpu/data/build.py (after the reference
maskrcnn_benchmark/data/build.py): dataset(s) from the catalog (COCO,
Pascal VOC, Cityscapes; several training datasets concatenated) -> sampler
-> GroupedBatchSampler (aspect ratio) -> IterationBasedBatchSampler ->
``torch.utils.data.DataLoader`` with the BatchCollator and
DATALOADER.NUM_WORKERS worker processes. The JAX package's own
shared-memory loader (maskrcnn_tpu/data/loader.py) exists because that
package has no torch; here torch's loader takes its place. For testing, one
loader per name in DATASETS.TEST, each in order (sequential sampler, no
aspect grouping), TEST.IMS_PER_BATCH images a batch; every batch carries
the images' dataset indices. Under test-time augmentation
(TEST.BBOX_AUG.ENABLED) a test loader has no transforms and its batches
are (images, targets, indices) tuples of the untransformed images
(BBoxAugCollator), as the JAX package's; engine/bbox_aug.py transforms
each pass.

The workers run the dataset, the transforms and the collator on the CPU and
hand back CPU tensors; they never touch CUDA, so the default fork start is
safe after the parent has initialized the card. On a CUDA device the loader
pins its batches, so that the copies to the card are asynchronous.
Batch-size semantics: SOLVER.IMS_PER_BATCH and TEST.IMS_PER_BATCH are the
global batch; with is_distributed each process loads its share of it
(IMS_PER_BATCH // data_size images) from its data coordinate's shard of a
DistributedSampler: shuffled from the epoch's seed for training, in order
for testing (padded to a multiple of the data coordinates: evaluation
gathers by dataset index). The processes of one data coordinate (its model
group, parallel/mesh.py) load the same images in the same order, and their
workers draw the same transforms (seeded alike).
"""

import os

import torch
import torch.utils.data

from ..config import paths_catalog
from ..parallel.distributed import images_per_process
from ..utils import comm
from ..utils.imports import import_file
from ..utils.miscellaneous import cfg_device
from .collate import BatchCollator, BBoxAugCollator
from .datasets import CityScapesDataset, COCODataset, ConcatDataset, PascalVOCDataset
from .samplers import (
    BatchSampler,
    DistributedSampler,
    GroupedBatchSampler,
    IterationBasedBatchSampler,
    RandomSampler,
    SequentialSampler,
)
from .transforms import build_transforms


_FACTORIES = {
    "COCODataset": COCODataset,
    "CityScapesDataset": CityScapesDataset,
    "PascalVOCDataset": PascalVOCDataset,
}


def build_dataset(dataset_list, transforms, dataset_catalog, is_train=True):
    """The datasets of `dataset_list`, as JAX data/build.py:40-60: for
    training one dataset, the concatenation of all of them where there are
    several; for testing one per name. COCO drops images without usable
    annotations for training; VOC keeps difficult objects for testing."""
    if not isinstance(dataset_list, (list, tuple)):
        raise RuntimeError("dataset_list should be a list of strings, got {}".format(dataset_list))
    datasets = []
    for name in dataset_list:
        data = dataset_catalog.get(name)
        args = dict(data["args"])
        if data["factory"] == "COCODataset":
            args["remove_images_without_annotations"] = is_train
        if data["factory"] == "PascalVOCDataset":
            args["use_difficult"] = not is_train
        args["transforms"] = transforms
        datasets.append(_FACTORIES[data["factory"]](**args))
    if is_train and len(datasets) > 1:
        return [ConcatDataset(datasets)]
    return datasets


def _compute_aspect_ratio_groups(dataset):
    groups = []
    for i in range(len(dataset)):
        info = dataset.get_img_info(i)
        groups.append(0 if info["width"] >= info["height"] else 1)
    return groups


def make_batch_sampler(dataset, sampler, aspect_grouping, images_per_batch, num_iters=None,
                       start_iter=0):
    if aspect_grouping:
        batch_sampler = GroupedBatchSampler(
            sampler, _compute_aspect_ratio_groups(dataset), images_per_batch, drop_uneven=False)
    else:
        batch_sampler = BatchSampler(sampler, images_per_batch, drop_last=False)
    if num_iters is not None:
        batch_sampler = IterationBasedBatchSampler(batch_sampler, num_iters, start_iter)
    return batch_sampler


class TensorBatches:
    """The collator's numpy batch as CPU tensors (which the loader can pin)."""

    def __init__(self, collator):
        self.collator = collator

    def __call__(self, samples):
        return {k: torch.from_numpy(v) for k, v in self.collator(samples).items()}


def _seed_worker(worker_id):
    """Give each worker's transforms their own random draws (the loader's
    per-worker seed), as torch seeds each worker's torch and random. The
    datasets of a concatenation share one pipeline."""
    info = torch.utils.data.get_worker_info()
    parts = info.dataset.datasets if isinstance(info.dataset, ConcatDataset) else [info.dataset]
    for transforms in {id(d.transforms): d.transforms for d in parts}.values():
        if transforms is not None:
            transforms.rng.seed(info.seed)


def _resolve_catalog(cfg):
    """The DatasetCatalog of cfg.PATHS_CATALOG: the port's own, or the one
    of a user's module at that path."""
    path = cfg.PATHS_CATALOG
    if os.path.abspath(path) == os.path.abspath(paths_catalog.__file__):
        return paths_catalog.DatasetCatalog
    return import_file("maskrcnn_tpu_torch_paths_catalog", path).DatasetCatalog


def make_data_loader(cfg, is_train=True, is_distributed=False, start_iter=0):
    """The training loader (SOLVER.MAX_ITER batches of SOLVER.IMS_PER_BATCH
    images from DATASETS.TRAIN, resuming after `start_iter`) or, with
    is_train=False, a list of one loader per name in DATASETS.TEST. With
    is_distributed, this process's share of each batch from its shard of
    the dataset; ValueError if the processes cannot share the batch evenly.
    Batches are dicts of CPU tensors in the collator's layout, pinned when
    MODEL.DEVICE is CUDA; under test-time augmentation, a test loader's
    batches are BBoxAugCollator's tuples."""
    num_replicas, rank = (comm.data_size(), comm.data_rank()) if is_distributed else (1, 0)
    if is_train:
        images_per_batch = cfg.SOLVER.IMS_PER_BATCH
        key = "SOLVER.IMS_PER_BATCH"
        num_iters = cfg.SOLVER.MAX_ITER
        dataset_list = cfg.DATASETS.TRAIN
    else:
        images_per_batch = cfg.TEST.IMS_PER_BATCH
        key = "TEST.IMS_PER_BATCH"
        num_iters = None
        start_iter = 0
        dataset_list = cfg.DATASETS.TEST
    if is_distributed:
        images_per_batch = images_per_process(images_per_batch, key)
    bbox_aug = not is_train and cfg.TEST.BBOX_AUG.ENABLED
    transforms = None if bbox_aug else build_transforms(cfg, is_train)
    datasets = build_dataset(dataset_list, transforms, _resolve_catalog(cfg), is_train)
    if cfg.MODEL.MASK_ON:
        # build the native mask ops once, before the workers start
        from ..utils import maskops

        maskops.library()
    collator = BBoxAugCollator() if bbox_aug else TensorBatches(BatchCollator(cfg, is_train))
    generator = None
    if is_distributed and comm.model_size() > 1:
        # a model group loads the same batches: its workers take the seeds
        # of the group's first process (drawn from the default generator)
        seeds = comm.all_gather(int(torch.empty((), dtype=torch.int64).random_()))
        generator = torch.Generator().manual_seed(seeds[comm.get_mesh().model_ranks[0]])
    loaders = []
    for dataset in datasets:
        if is_distributed:
            sampler = DistributedSampler(dataset, num_replicas, rank, shuffle=is_train)
        elif is_train:
            sampler = RandomSampler(dataset)
        else:
            sampler = SequentialSampler(dataset)
        batch_sampler = make_batch_sampler(
            dataset, sampler, cfg.DATALOADER.ASPECT_RATIO_GROUPING and is_train,
            images_per_batch, num_iters, start_iter)
        loaders.append(torch.utils.data.DataLoader(
            dataset, batch_sampler=batch_sampler,
            collate_fn=collator,
            num_workers=cfg.DATALOADER.NUM_WORKERS, worker_init_fn=_seed_worker,
            generator=generator,
            pin_memory=cfg_device(cfg).type == "cuda" and not bbox_aug,
        ))
    return loaders[0] if is_train else loaders
