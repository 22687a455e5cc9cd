"""The port's data pipeline (maskrcnn_tpu_torch.data, structures, utils.maskops)
against the JAX package's, on the synthetic COCO tree of tests/synthetic_coco.py.

Tolerances: dataset targets' boxes 1e-5 and labels exact; polygon
rasterization exact (the same C++ routine); after the transforms, images
within one grey level (PyTorch's antialiased bilinear against PIL's) and
boxes 1e-4; the collator's gt_masks exact; sampler index sequences exact;
the port's loader with 0 and 2 worker processes gives the batches of the
JAX package's loader with 0 workers.
"""

import shutil

import numpy as np
import pytest
import torch

from maskrcnn_tpu.config.paths_catalog import DatasetCatalog as JaxCatalog
from maskrcnn_tpu.data import make_data_loader as jax_make_data_loader
from maskrcnn_tpu.data import samplers as jax_samplers
from maskrcnn_tpu.data.collate import BatchCollator as JaxCollator
from maskrcnn_tpu.data.datasets import COCODataset as JaxCOCO
from maskrcnn_tpu.data.transforms import build_transforms as jax_build_transforms
from maskrcnn_tpu.utils.maskops import polygons_to_mask as jax_polygons_to_mask
from maskrcnn_tpu_torch.data import samplers
from maskrcnn_tpu_torch.data.build import make_data_loader
from maskrcnn_tpu_torch.data.collate import BatchCollator
from maskrcnn_tpu_torch.data.datasets import COCODataset
from maskrcnn_tpu_torch.data.transforms import build_transforms
from maskrcnn_tpu_torch.structures import SegmentationMask
from maskrcnn_tpu_torch.utils.maskops import polygons_to_mask
from synthetic_coco import make_synthetic_coco
from torch_port_fixtures import configs


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A data root laid out as the catalogs expect (coco_2017_train), with
    one image whose only annotation is too small to keep."""
    root = tmp_path_factory.mktemp("data")
    img_dir, ann_file = make_synthetic_coco(str(root / "gen"), num_images=7, num_classes=3,
                                            seed=3)
    import json

    with open(ann_file) as f:
        data = json.load(f)
    data["annotations"] = [a for a in data["annotations"] if a["image_id"] != 4]
    data["annotations"].append({"id": 999, "image_id": 4, "category_id": 1, "iscrowd": 0,
                                "bbox": [5.0, 5.0, 1.0, 30.0], "area": 30.0,
                                "segmentation": [[5, 5, 6, 5, 6, 35, 5, 35]]})
    (root / "coco" / "annotations").mkdir(parents=True)
    with open(root / "coco" / "annotations" / "instances_train2017.json", "w") as f:
        json.dump(data, f)
    shutil.move(img_dir, str(root / "coco" / "train2017"))
    return root


def _configs(flip_h=0.0, flip_v=0.0, min_size=96, max_size=200, workers=0):
    jcfg, tcfg = configs()
    for c in (jcfg, tcfg):
        c.INPUT.MIN_SIZE_TRAIN = (min_size,)
        c.INPUT.MAX_SIZE_TRAIN = max_size
        c.INPUT.HORIZONTAL_FLIP_PROB_TRAIN = flip_h
        c.INPUT.VERTICAL_FLIP_PROB_TRAIN = flip_v
        c.DATASETS.TRAIN = ("coco_2017_train",)
        c.SOLVER.IMS_PER_BATCH = 3
        c.SOLVER.MAX_ITER = 5
        c.TPU.GT_MASK_SIZE = 28
        c.DATALOADER.NUM_WORKERS = workers
    tcfg.MODEL.DEVICE = "cpu"
    return jcfg, tcfg


def _datasets(tree, jcfg=None, tcfg=None):
    ann = str(tree / "coco" / "annotations" / "instances_train2017.json")
    img = str(tree / "coco" / "train2017")
    jt = jax_build_transforms(jcfg, True) if jcfg is not None else None
    tt = build_transforms(tcfg, True) if tcfg is not None else None
    return (JaxCOCO(ann, img, remove_images_without_annotations=True, transforms=jt),
            COCODataset(ann, img, remove_images_without_annotations=True, transforms=tt))


def _polys(masks):
    return [[p for p in inst.polygons] for inst in masks.instances.polygons]


def test_dataset_targets_match_jax(tree):
    jd, td = _datasets(tree)
    assert len(td) == len(jd) == 6 and td.ids == jd.ids
    assert td.json_category_id_to_contiguous_id == jd.json_category_id_to_contiguous_id
    for i in range(len(td)):
        want, got = jd.get_target(i), td.get_target(i)
        np.testing.assert_allclose(got.bbox, want.bbox, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got.get_field("labels"), want.get_field("labels"))
        for a, b in zip(_polys(got.get_field("masks")), _polys(want.get_field("masks"))):
            np.testing.assert_array_equal(np.concatenate(a), np.concatenate(b))
        assert td.get_img_info(i) == jd.get_img_info(i)
    image = td._load_image(0)
    assert image.dtype == np.uint8 and image.shape == (120, 160, 3) and image.flags.writeable


def test_polygons_to_mask_matches_jax_exactly():
    rs = np.random.RandomState(0)
    for _ in range(40):
        polys = [rs.uniform(-8, 70, 2 * rs.randint(1, 12)) for _ in range(rs.randint(1, 4))]
        h, w = rs.randint(1, 60, 2)
        np.testing.assert_array_equal(polygons_to_mask(polys, h, w),
                                      jax_polygons_to_mask(polys, h, w))
    assert polygons_to_mask([], 3, 4).shape == (3, 4)


@pytest.mark.parametrize("flip_h,flip_v", [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0)])
def test_transforms_match_jax(tree, flip_h, flip_v):
    jcfg, tcfg = _configs(flip_h, flip_v, min_size=144)
    jd, td = _datasets(tree, jcfg, tcfg)
    for i in range(len(td)):
        (jimg, jt, _), (timg, tt, _) = jd[i], td[i]
        assert timg.dtype == jimg.dtype == np.uint8 and timg.shape == jimg.shape == (144, 192, 3)
        assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 1
        np.testing.assert_allclose(tt.bbox, jt.bbox, rtol=0, atol=1e-4)
        assert tt.size == jt.size
        assert (getattr(tt, "_hflipped", False), getattr(tt, "_vflipped", False)) == \
            (getattr(jt, "_hflipped", False), getattr(jt, "_vflipped", False)) == \
            (flip_h > 0, flip_v > 0)
        for a, b in zip(_polys(tt.get_field("masks")), _polys(jt.get_field("masks"))):
            np.testing.assert_allclose(np.concatenate(a), np.concatenate(b), rtol=0, atol=1e-4)


@pytest.mark.parametrize("flip", [0.0, 1.0])
def test_collator_matches_jax(tree, flip):
    jcfg, tcfg = _configs(flip, flip, min_size=144)
    jd, td = _datasets(tree, jcfg, tcfg)
    jc, tc = JaxCollator(jcfg), BatchCollator(tcfg)
    for idx in ([0, 1, 2], [3, 4, 5], [0, 1, 2]):  # the last batch hits the patch cache
        want = jc([jd[i] for i in idx])
        got = tc([td[i] for i in idx])
        assert set(got) == set(want) == {"images", "image_sizes", "indices", "gt_boxes",
                                         "gt_labels", "gt_masks"}
        for k in ("image_sizes", "indices", "gt_labels", "gt_masks"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["images"].shape == want["images"].shape == (3, 160, 224, 3)
        assert np.abs(got["images"].astype(int) - want["images"].astype(int)).max() <= 1
        np.testing.assert_allclose(got["gt_boxes"], want["gt_boxes"], rtol=0, atol=1e-4)
        assert got["gt_masks"].sum() > 0


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


def test_samplers_match_jax():
    group_ids = np.random.RandomState(0).randint(0, 2, 23)
    for batch, start, iters in ((4, 0, 9), (3, 5, 12)):
        seqs = []
        for mod in (jax_samplers, samplers):
            sampler = mod.RandomSampler(_Sized(23))
            grouped = mod.GroupedBatchSampler(sampler, group_ids, batch)
            seqs.append((list(sampler), list(grouped),
                         list(mod.IterationBasedBatchSampler(grouped, iters, start)),
                         list(mod.BatchSampler(mod.SequentialSampler(_Sized(23)), batch))))
        assert seqs[0] == seqs[1]
        assert len(seqs[1][2]) == iters - start


@pytest.mark.parametrize("workers", [0, 2])
def test_make_data_loader_matches_jax(tree, monkeypatch, workers):
    jcfg, tcfg = _configs(min_size=96, workers=workers)
    jcfg.DATALOADER.NUM_WORKERS = 0
    monkeypatch.setattr(JaxCatalog, "DATA_DIR", str(tree))
    monkeypatch.setenv("MASKRCNN_TPU_DATA_DIR", str(tree))
    want = list(jax_make_data_loader(jcfg, is_train=True, start_iter=1))
    got = list(make_data_loader(tcfg, is_train=True, start_iter=1))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert all(isinstance(v, torch.Tensor) for v in g.values())
        for k in ("image_sizes", "indices", "gt_labels", "gt_masks"):
            np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)
        assert np.abs(g["images"].numpy().astype(int) - w["images"].astype(int)).max() <= 1
        np.testing.assert_allclose(g["gt_boxes"].numpy(), w["gt_boxes"], rtol=0, atol=1e-4)


def test_unported_data_options_raise(tree, monkeypatch):
    """The data options that once raised, naming their ROADMAP items, now
    run: tracing binary masks into polygons (item 17; its parity with
    OpenCV in tests/test_torch_polygon.py) and the test-time-augmentation
    loader (item 14: untransformed images, tests/test_torch_tta.py).
    ColorJitter, binary masks, VOC, Cityscapes and concatenation
    (tests/test_torch_datasets.py) and keypoint targets
    (tests/test_torch_keypoint.py) are ported."""
    _, tcfg = _configs()
    tcfg.INPUT.BRIGHTNESS = 0.2
    assert type(build_transforms(tcfg, True).transforms[0]).__name__ == "ColorJitter"
    rect = np.zeros((2, 6, 6), np.uint8)
    rect[1, 1:5, 1:4] = 1
    polys = SegmentationMask(rect, (6, 6), mode="mask").convert("poly")
    assert polys.mode == "poly"
    assert [[p.tolist() for p in inst.polygons] for inst in polys.instances.polygons] == [
        [], [[1.0, 1.0, 1.0, 4.0, 3.0, 4.0, 3.0, 1.0]]]
    _, tcfg = _configs()
    tcfg.MODEL.KEYPOINT_ON = True
    assert BatchCollator(tcfg).keypoint_on
    monkeypatch.setenv("MASKRCNN_TPU_DATA_DIR", str(tree))
    _, tcfg = _configs()
    tcfg.TEST.BBOX_AUG.ENABLED = True
    tcfg.DATASETS.TEST = ("coco_2017_train",)
    tcfg.TEST.IMS_PER_BATCH = 4
    (loader,) = make_data_loader(tcfg, is_train=False)
    batches = list(loader)
    assert [list(b[2]) for b in batches] == [[0, 1, 2, 3], [4, 5, 6]]
    images, targets = batches[0][:2]
    assert all(t.size == (160, 120) for t in targets)
    assert all(im.dtype == np.uint8 and im.shape == (120, 160, 3) for im in images)


def test_paths_catalog_from_the_config(tree, tmp_path):
    """cfg.PATHS_CATALOG may name a user's catalog module, as in the JAX
    package; the default is the port's own config/paths_catalog.py."""
    catalog = tmp_path / "my_catalog.py"
    catalog.write_text(
        "class DatasetCatalog:\n"
        "    @staticmethod\n"
        "    def get(name):\n"
        "        return dict(factory='COCODataset', args=dict(\n"
        "            root={!r}, ann_file={!r}))\n".format(
            str(tree / "coco" / "train2017"),
            str(tree / "coco" / "annotations" / "instances_train2017.json")))
    _, tcfg = _configs()
    assert tcfg.PATHS_CATALOG.endswith("maskrcnn_tpu_torch/config/paths_catalog.py")
    tcfg.PATHS_CATALOG = str(catalog)
    tcfg.DATASETS.TRAIN = ("anything",)
    loader = make_data_loader(tcfg, is_train=True)
    assert loader.dataset.root == str(tree / "coco" / "train2017") and len(loader) == 5
