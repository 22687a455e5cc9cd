"""The rest of the port's data layer against the JAX package's: Pascal VOC and
Cityscapes with their evaluators, ConcatDataset, binary masks, ColorJitter,
the collator's binary-mask patches, and train_net on two concatenated
datasets from a catalog:// weight.

Tolerances: VOC and Cityscapes items (images, boxes, labels, difficult
flags, masks) and their evaluators' results exact; BinaryMaskList's
transpose, crop and resize exact against OpenCV's INTER_NEAREST (the JAX
package's); ColorJitter exact against Pillow's ImageEnhance and HSV under
the same seeds (one grey level would be allowed, but for Brightness alone),
and the whole training transform within one grey level (its resize
is PyTorch's bilinear against PIL's); the collator's mask-mode gt_masks
exact. The evaluators are given the same predictions on both sides; the
Cityscapes one pastes masks with the port's native paste against the JAX
package's OpenCV Masker.
"""

import json
import os
import random
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from maskrcnn_tpu.data import samplers as jax_samplers
from maskrcnn_tpu.data.build import _compute_aspect_ratio_groups as jax_groups
from maskrcnn_tpu.data.collate import BatchCollator as JaxCollator
from maskrcnn_tpu.data.datasets import CityScapesDataset as JaxCityscapes
from maskrcnn_tpu.data.datasets import COCODataset as JaxCOCO
from maskrcnn_tpu.data.datasets import ConcatDataset as JaxConcat
from maskrcnn_tpu.data.datasets import PascalVOCDataset as JaxVOC
from maskrcnn_tpu.data.evaluation import evaluate as jax_evaluate
from maskrcnn_tpu.data.evaluation import voc_eval as jax_voc_eval
from maskrcnn_tpu.data.transforms import ColorJitter as JaxColorJitter
from maskrcnn_tpu.data.transforms import build_transforms as jax_build_transforms
from maskrcnn_tpu.structures import BoxList as JaxBoxList
from maskrcnn_tpu.structures.segmentation_mask import BinaryMaskList as JaxBinaryMaskList
from maskrcnn_tpu_torch.data import samplers
from maskrcnn_tpu_torch.data.build import _compute_aspect_ratio_groups, build_dataset
from maskrcnn_tpu_torch.data.collate import BatchCollator
from maskrcnn_tpu_torch.data.datasets import (
    CityScapesDataset,
    COCODataset,
    ConcatDataset,
    PascalVOCDataset,
)
from maskrcnn_tpu_torch.data.evaluation import evaluate
from maskrcnn_tpu_torch.data.evaluation import voc_eval
from maskrcnn_tpu_torch.data.transforms import ColorJitter, build_transforms
from maskrcnn_tpu_torch.structures import BoxList
from maskrcnn_tpu_torch.structures.boxlist import FLIP_LEFT_RIGHT, FLIP_TOP_BOTTOM
from maskrcnn_tpu_torch.structures.segmentation_mask import BinaryMaskList
from synthetic_cityscapes import make_synthetic_cityscapes
from synthetic_coco import make_synthetic_coco
from synthetic_voc import make_synthetic_voc
from torch_port_fixtures import configs


def _same_boxlist(got, want, fields):
    assert got.size == want.size and got.mode == want.mode
    np.testing.assert_array_equal(got.bbox, want.bbox)
    for f in fields:
        np.testing.assert_array_equal(np.asarray(got.get_field(f)),
                                      np.asarray(want.get_field(f)), err_msg=f)


# -- Pascal VOC ---------------------------------------------------------------


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc") / "VOC2007"
    make_synthetic_voc(str(root), num_images=5)
    # one difficult object, kept for testing only
    path = root / "Annotations" / "000002.xml"
    text = path.read_text()
    path.write_text(text.replace("<difficult>0</difficult>", "<difficult>1</difficult>", 1))
    return str(root)


@pytest.mark.parametrize("use_difficult", [True, False])
def test_voc_items_equal_jax(voc, use_difficult):
    ds = PascalVOCDataset(voc, "test", use_difficult=use_difficult)
    jds = JaxVOC(voc, "test", use_difficult=use_difficult)
    assert len(ds) == len(jds) == 5 and ds.ids == jds.ids
    assert ds.categories == jds.categories and ds.id_to_img_map == jds.id_to_img_map
    n_difficult = 0
    for i in range(len(ds)):
        assert ds.get_img_info(i) == jds.get_img_info(i)
        _same_boxlist(ds.get_groundtruth(i), jds.get_groundtruth(i), ("labels", "difficult"))
        n_difficult += int(ds.get_groundtruth(i).get_field("difficult").sum())
        img, target, idx = ds[i]
        jimg, jtarget, jidx = jds[i]
        assert idx == jidx == i
        np.testing.assert_array_equal(img, np.asarray(jimg))
        _same_boxlist(target, jtarget, ("labels", "difficult"))
    assert n_difficult == (1 if use_difficult else 0)


def _voc_boxlists(box_cls, size, boxes, labels, scores=None, difficult=None):
    b = box_cls(np.asarray(boxes, np.float32).reshape(-1, 4), size)
    b.add_field("labels", np.asarray(labels, np.int64))
    if scores is not None:
        b.add_field("scores", np.asarray(scores, np.float32))
    if difficult is not None:
        b.add_field("difficult", np.asarray(difficult, np.uint8))
    return b


def _voc_hand_case(box_cls):
    """tests/test_voc.py's hand-computed curve: a duplicate, a difficult
    match, a false positive (AP 8.5/11 in VOC07, 0.75 continuous)."""
    size = (100, 100)
    g1, g2, g3, far = [0, 0, 9, 9], [20, 20, 29, 29], [0, 0, 9, 9], [50, 50, 59, 59]
    gts = [_voc_boxlists(box_cls, size, [g1, g2], [1, 1], difficult=[0, 1]),
           _voc_boxlists(box_cls, size, [g3], [1], difficult=[0])]
    preds = [_voc_boxlists(box_cls, size, [g1, g1, g2], [1, 1, 1], scores=[0.9, 0.8, 0.7]),
             _voc_boxlists(box_cls, size, [far, g3], [1, 1], scores=[0.6, 0.5])]
    return preds, gts


def _voc_absent_case(box_cls):
    size = (100, 100)
    gts = [_voc_boxlists(box_cls, size, [[0, 0, 9, 9]], [1], difficult=[0])]
    preds = [_voc_boxlists(box_cls, size, [[0, 0, 9, 9]], [2], scores=[0.9])]
    return preds, gts


def _voc_dataset_predictions(box_cls, ds, kind):
    """Per image of the dataset: its gt as detections ("perfect"), none
    ("misses"), or the gt shifted and rescored with a false positive."""
    rs = np.random.RandomState(7)
    preds = []
    for i in range(len(ds)):
        gt = ds.get_groundtruth(i)
        n = len(gt)
        if kind == "misses":
            preds.append(_voc_boxlists(box_cls, gt.size, np.zeros((0, 4)), [], scores=[]))
            continue
        boxes = np.asarray(gt.bbox, np.float32).copy()
        labels = np.asarray(gt.get_field("labels"))
        scores = np.ones(n, np.float32)
        if kind == "shifted":
            boxes += rs.uniform(-8, 8, boxes.shape).astype(np.float32)
            scores = rs.uniform(0.1, 1, n).astype(np.float32)
            boxes = np.concatenate([boxes, [[1, 1, 30, 30]]]).astype(np.float32)
            labels = np.concatenate([labels, [labels[0]]])
            scores = np.concatenate([scores, [0.95]]).astype(np.float32)
        preds.append(_voc_boxlists(box_cls, gt.size, boxes, labels, scores=scores))
    return preds


def _same_voc_result(got, want):
    np.testing.assert_array_equal(got["ap"], want["ap"])  # nan where nan
    assert (got["map"] == want["map"]) or (np.isnan(got["map"]) and np.isnan(want["map"]))


@pytest.mark.parametrize("case", ["hand_computed", "class_without_gt"])
@pytest.mark.parametrize("use_07_metric", [True, False])
def test_voc_eval_hand_cases_equal_jax(case, use_07_metric):
    make = _voc_hand_case if case == "hand_computed" else _voc_absent_case
    got = voc_eval.eval_detection_voc(*make(BoxList), use_07_metric=use_07_metric)
    want = jax_voc_eval.eval_detection_voc(*make(JaxBoxList), use_07_metric=use_07_metric)
    _same_voc_result(got, want)
    if case == "hand_computed":
        assert got["ap"][1] == pytest.approx(8.5 / 11 if use_07_metric else 0.75, abs=1e-9)


@pytest.mark.parametrize("kind", ["perfect", "misses", "shifted"])
def test_voc_evaluation_equal_jax(voc, tmp_path, kind):
    ds, jds = PascalVOCDataset(voc, "test", True), JaxVOC(voc, "test", True)
    got = evaluate(ds, _voc_dataset_predictions(BoxList, ds, kind), str(tmp_path))
    want = jax_evaluate(jds, _voc_dataset_predictions(JaxBoxList, jds, kind), None)
    _same_voc_result(got, want)
    assert got["map"] == {"perfect": 1.0, "misses": 0.0}.get(kind, got["map"])
    assert 0 < got["map"] < 1 or kind != "shifted"
    assert (tmp_path / "result.txt").read_text().startswith("mAP: ")


# -- Cityscapes ---------------------------------------------------------------


@pytest.fixture(scope="module")
def cityscapes(tmp_path_factory):
    root = tmp_path_factory.mktemp("cityscapes")
    img_root, ann_root, _ = make_synthetic_cityscapes(str(root), num_images=4)
    return img_root, ann_root


CITYSCAPES_CASES = [("poly", 0, None), ("mask", 0, None), ("poly", 2000, None),
                    ("mask", 2000, None), ("poly", 0, 2), ("mask", 0, 2)]


def _same_cityscapes_item(got, want):
    img, target, idx = got
    jimg, jtarget, jidx = want
    assert idx == jidx
    np.testing.assert_array_equal(img, np.asarray(jimg))
    _same_boxlist(target, jtarget, ("labels",))
    masks, jmasks = target.get_field("masks"), jtarget.get_field("masks")
    assert masks.mode == jmasks.mode and masks.size == jmasks.size
    got_m, want_m = masks.get_mask_tensor(), jmasks.get_mask_tensor()
    assert got_m.dtype == want_m.dtype
    np.testing.assert_array_equal(got_m, want_m)


@pytest.mark.parametrize("mode,min_area,mini", CITYSCAPES_CASES)
def test_cityscapes_items_equal_jax(cityscapes, mode, min_area, mini):
    img_root, ann_root = cityscapes
    kw = dict(mode=mode, min_area=min_area, mini=mini)
    ds = CityScapesDataset(img_root, ann_root, "val", **kw)
    jds = JaxCityscapes(img_root, ann_root, "val", **kw)
    assert len(ds) == len(jds) == (2 if mini else 4)
    assert ds.img_paths == jds.img_paths and ds.ann_paths == jds.ann_paths
    for i in range(len(ds)):
        assert ds.get_img_info(i) == jds.get_img_info(i)
        _same_cityscapes_item(ds[i], jds[i])


def test_cityscapes_substitutes_an_empty_sample(cityscapes):
    """An image without instances is replaced by the next one with some,
    its own index reported; a split with none raises."""
    img_root, ann_root = cityscapes

    def emptied(cls, empty):
        class Emptied(cls):
            def _load_anno(self, idx):
                return ([], [], []) if idx in empty else super()._load_anno(idx)
        return Emptied(img_root, ann_root, "val", mode="mask")

    ds, jds = emptied(CityScapesDataset, {1, 2}), emptied(JaxCityscapes, {1, 2})
    img, target, idx = ds[1]
    _same_cityscapes_item((img, target, idx), jds[1])
    assert idx == 1
    np.testing.assert_array_equal(img, ds[3][0])
    with pytest.raises(RuntimeError):
        emptied(CityScapesDataset, set(range(4)))[0]


def _cityscapes_predictions(box_cls, ds, kind):
    """Per image: its gt as detections with mask probabilities (the gt
    instance cropped to its box at 28x28), decreasing scores; "shifted"
    moves the boxes by a few pixels, drops the last instance and adds a
    false positive."""
    rs = np.random.RandomState(11)
    preds = []
    for idx in range(len(ds)):
        _, target, _ = ds[idx]
        target = target.convert("xyxy")
        n = len(target)
        boxes = np.asarray(target.bbox, np.float32).copy()
        labels = np.asarray(target.get_field("labels"))
        masks = target.get_field("masks")
        probs = []
        for j in range(n):
            m = np.asarray(masks[j].crop(target.bbox[j]).resize((28, 28)).get_mask_tensor(),
                           np.float32)
            probs.append(m[0] if m.ndim == 3 else m)
        probs = np.stack(probs)[:, None]
        scores = np.linspace(0.95, 0.6, n).astype(np.float32)
        if kind == "shifted":
            boxes = boxes[:-1] + rs.uniform(-3, 3, (n - 1, 4)).astype(np.float32)
            boxes = np.concatenate([boxes, [[2, 2, 40, 30]]]).astype(np.float32)
            labels = np.concatenate([labels[:-1], [labels[0]]])
            scores = np.concatenate([scores[:-1], [0.9]]).astype(np.float32)
            probs = np.concatenate([probs[:-1], np.full((1, 1, 28, 28), 0.8, np.float32)])
        p = box_cls(boxes, target.size, "xyxy")
        p.add_field("labels", labels)
        p.add_field("scores", scores)
        p.add_field("mask", probs)
        preds.append(p)
    return preds


def _nan_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _nan_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _nan_equal(x, y)
    else:
        assert a == b or (a != a and b != b), (a, b)


@pytest.mark.parametrize("mode,kind", [("poly", "perfect"), ("mask", "perfect"),
                                       ("poly", "shifted"), ("mask", "shifted")])
def test_cityscapes_evaluation_equal_jax(cityscapes, tmp_path, mode, kind):
    img_root, ann_root = cityscapes
    ds = CityScapesDataset(img_root, ann_root, "val", mode=mode)
    jds = JaxCityscapes(img_root, ann_root, "val", mode=mode)
    out, jout = tmp_path / "port", tmp_path / "jax"
    got = evaluate(ds, _cityscapes_predictions(BoxList, ds, kind), str(out),
                   iou_types=("bbox", "segm"))
    want = jax_evaluate(jds, _cityscapes_predictions(JaxBoxList, jds, kind), str(jout),
                        iou_types=("bbox", "segm"))
    _nan_equal(got, want)
    for name in ("boxResult.json", "maskResult.json"):
        with open(out / "evaluationResults" / name) as f, \
                open(jout / "evaluationResults" / name) as g:
            _nan_equal(json.load(f), json.load(g))
    if kind == "perfect":
        assert got["bbox"]["allAp50%"] == got["segm"]["allAp50%"] == pytest.approx(1.0)
    else:
        assert 0 < got["bbox"]["allAp"] < 1


# per frame, (class, (x0, y0, x1, y1)) rectangles, later ones in front: the
# two persons of frame 0 overlap at IoU 0.695, the first keeps 1150 of its
# 6400 pixels in sight
OVERLAPPING = [[("person", (20, 20, 100, 100)), ("person", (30, 25, 110, 105)),
                ("car", (150, 10, 230, 60)), ("car", (170, 30, 250, 90))],
               [("person", (10, 40, 90, 120)), ("car", (60, 20, 200, 100)),
                ("person", (120, 50, 180, 125))]]


def _overlapping_cityscapes(root):
    """A val split of 128x256 frames whose instances overlap: each
    instance's polygon is its whole rectangle, its pixels in the
    *_instanceIds.png only those in sight, as in annotations of occluded
    objects."""
    labels = {"person": 24, "car": 26}
    img_dir = os.path.join(root, "leftImg8bit", "val", "overlap")
    ann_dir = os.path.join(root, "gtFine", "val", "overlap")
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    for i, rects in enumerate(OVERLAPPING):
        ids = np.zeros((128, 256), np.uint16)
        objects, counts = [], {}
        for name, (x0, y0, x1, y1) in rects:
            counts[name] = counts.get(name, 0) + 1
            ids[y0:y1, x0:x1] = labels[name] * 1000 + counts[name]
            objects.append({"label": name, "polygon": [[x0, y0], [x1 - 1, y0],
                                                       [x1 - 1, y1 - 1], [x0, y1 - 1]]})
        base = "overlap_{:06d}_000019".format(i)
        Image.fromarray((ids % 251).astype(np.uint8)[..., None].repeat(3, -1)).save(
            os.path.join(img_dir, base + "_leftImg8bit.png"))
        Image.fromarray(ids).save(os.path.join(ann_dir, base + "_gtFine_instanceIds.png"))
        with open(os.path.join(ann_dir, base + "_gtFine_polygons.json"), "w") as f:
            json.dump({"imgHeight": 128, "imgWidth": 256, "objects": objects}, f)
    return os.path.join(root, "leftImg8bit"), os.path.join(root, "gtFine")


@pytest.mark.parametrize("mode", ["poly", "mask"])
def test_cityscapes_evaluation_of_overlapping_instances_equal_jax(tmp_path, mode):
    """Each instance as its own detection, on frames where instances hide
    parts of each other. In "poly" mode the gt masks are the whole polygons:
    each of the two persons that overlap at IoU 0.7 matches both, the
    protocol demotes the lower-scored match of a gt to a false positive, and
    AP50 falls below 1 in the port and in JAX alike. In "mask" mode the gt
    masks are the pixels in sight, which overlap nowhere."""
    img_root, ann_root = _overlapping_cityscapes(str(tmp_path / "tree"))
    ds = CityScapesDataset(img_root, ann_root, "val", mode=mode)
    jds = JaxCityscapes(img_root, ann_root, "val", mode=mode)
    got = evaluate(ds, _cityscapes_predictions(BoxList, ds, "perfect"), str(tmp_path / "port"),
                   iou_types=("bbox", "segm"))
    want = jax_evaluate(jds, _cityscapes_predictions(JaxBoxList, jds, "perfect"),
                        str(tmp_path / "jax"), iou_types=("bbox", "segm"))
    _nan_equal(got, want)
    if mode == "poly":
        assert got["segm"]["allAp50%"] < 1
    else:
        assert got["segm"]["allAp50%"] == pytest.approx(1.0)


def test_cityscapes_expected_results_gate_as_jax(cityscapes, tmp_path):
    img_root, ann_root = cityscapes
    ds = CityScapesDataset(img_root, ann_root, "val", mode="poly")
    preds = _cityscapes_predictions(BoxList, ds, "perfect")
    evaluate(ds, preds, None, iou_types=("bbox",),
             expected_results=[("bbox", "allAp50%", 1.0, 0.01)], expected_results_sigma_tol=4)
    with pytest.raises(AssertionError, match="FAILED"):
        evaluate(ds, preds, None, iou_types=("bbox",),
                 expected_results=[("bbox", "allAp50%", 0.2, 0.01)],
                 expected_results_sigma_tol=4)


# -- ConcatDataset ------------------------------------------------------------


@pytest.fixture(scope="module")
def coco_pair(tmp_path_factory):
    """Two synthetic COCO trees: 5 landscape images and 4 portrait ones."""
    root = tmp_path_factory.mktemp("coco2")
    trees = []
    for name, n, size, seed in (("a", 5, (120, 160), 0), ("b", 4, (160, 112), 1)):
        img_dir, ann_file = make_synthetic_coco(str(root / name), num_images=n, size=size,
                                                seed=seed)
        trees.append((ann_file, img_dir))
    return trees


def test_concat_dataset_and_aspect_groups_equal_jax(coco_pair):
    ours = ConcatDataset([COCODataset(a, r) for a, r in coco_pair])
    theirs = JaxConcat([JaxCOCO(a, r) for a, r in coco_pair])
    assert len(ours) == len(theirs) == 9 and ours.cumulative_sizes == theirs.cumulative_sizes
    for i in range(len(ours)):
        assert ours.get_idxs(i) == theirs.get_idxs(i)
        assert ours.get_img_info(i) == theirs.get_img_info(i)
        img, target, idx = ours[i]
        jimg, jtarget, jidx = theirs[i]
        assert idx == jidx == i
        np.testing.assert_array_equal(img, np.asarray(jimg))
        _same_boxlist(target, jtarget, ("labels",))
    assert ours.contiguous_category_id_to_json_id == theirs.contiguous_category_id_to_json_id
    groups = _compute_aspect_ratio_groups(ours)
    assert groups == jax_groups(theirs) == [0] * 5 + [1] * 4
    for world in (1, 2):
        for rank in range(world):
            s = samplers.DistributedSampler(ours, world, rank)
            js = jax_samplers.DistributedSampler(theirs, world, rank)
            got = list(samplers.GroupedBatchSampler(s, groups, 2))
            assert got == list(jax_samplers.GroupedBatchSampler(js, groups, 2))
            assert all(len({groups[i] for i in b}) == 1 for b in got)


def test_build_dataset_concatenates_for_training(tmp_path, coco_pair):
    class Catalog:
        @staticmethod
        def get(name):
            ann, root = coco_pair[int(name)]
            return dict(factory="COCODataset", args=dict(root=root, ann_file=ann))

    (train,) = build_dataset(["0", "1"], None, Catalog, is_train=True)
    assert isinstance(train, ConcatDataset) and len(train) == 9
    test = build_dataset(["0", "1"], None, Catalog, is_train=False)
    assert [type(d) for d in test] == [COCODataset, COCODataset]


# -- binary masks -------------------------------------------------------------

RESIZES = [((1024, 2048), (800, 1600)), ((37, 53), (112, 112)), ((1024, 2048), (1008, 2016)),
           ((112, 112), (28, 28)), ((5, 7), (112, 112)), ((300, 211), (97, 401))]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_binary_masks_equal_jax(src, dst):
    rs = np.random.RandomState(src[0] + dst[1])
    (h, w), (oh, ow) = src, dst
    masks = (rs.rand(3, h // 4 + 1, w // 4 + 1) > 0.5).repeat(4, 1).repeat(4, 2)[:, :h, :w]
    ours, theirs = BinaryMaskList(masks, (w, h)), JaxBinaryMaskList(masks, (w, h))
    got, want = ours.resize((ow, oh)), theirs.resize((ow, oh))
    assert got.size == want.size == (ow, oh)
    assert got.masks.dtype == want.masks.dtype == np.uint8
    np.testing.assert_array_equal(got.masks, want.masks)
    for method in (FLIP_LEFT_RIGHT, FLIP_TOP_BOTTOM):
        np.testing.assert_array_equal(ours.transpose(method).masks,
                                      theirs.transpose(method).masks)
    for box in ([3.4, 2.6, w * 0.7, h * 0.8], [-5, -3, w + 4.2, h + 7], [w - 2, h - 2, w, h]):
        c, jc = ours.crop(box), theirs.crop(box)
        assert c.size == jc.size
        np.testing.assert_array_equal(c.masks, jc.masks)
        np.testing.assert_array_equal(c.resize((112, 112)).masks,
                                      jc.resize((112, 112)).masks)


def test_collator_mask_patches_equal_jax(cityscapes):
    """The collator's gt_masks from Cityscapes binary masks (crop and resize
    per instance), after a resize and a flip of the targets."""
    img_root, ann_root = cityscapes
    jcfg, tcfg = configs()
    for c in (jcfg, tcfg):
        c.INPUT.MIN_SIZE_TRAIN = (96,)
        c.INPUT.MAX_SIZE_TRAIN = 200
    ds = CityScapesDataset(img_root, ann_root, "val", mode="mask")
    jds = JaxCityscapes(img_root, ann_root, "val", mode="mask")
    batch, jbatch = [], []
    for i in range(len(ds)):
        img, target, _ = ds[i]
        _, jtarget, _ = jds[i]
        size = (int(target.size[0] * 0.75), int(target.size[1] * 0.75))
        target, jtarget = target.resize(size), jtarget.resize(size)
        if i % 2:
            target, jtarget = target.transpose(FLIP_LEFT_RIGHT), jtarget.transpose(FLIP_LEFT_RIGHT)
        small = img[:size[1], :size[0]]
        batch.append((small, target, i))
        jbatch.append((small, jtarget, i))
    got = BatchCollator(tcfg, is_train=True)(batch)
    want = JaxCollator(jcfg, is_train=True)(jbatch)
    for k in ("images", "image_sizes", "gt_boxes", "gt_labels", "gt_masks"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["gt_masks"].sum() > 0


# -- ColorJitter --------------------------------------------------------------

JITTERS = [(0.4, 0, 0, 0), (0, 0.4, 0, 0), (0, 0, 0.4, 0), (0, 0, 0, 0.1),
           (0.2, 0.2, 0.2, 0.05), (0.9, 0.9, 0.9, 0.5)]


@pytest.mark.parametrize("jitter", JITTERS)
def test_color_jitter_equals_pillow(jitter):
    rs = np.random.RandomState(0)
    for seed in range(6):
        img = rs.randint(0, 256, (57, 83, 3)).astype(np.uint8)
        random.seed(seed)
        want = np.asarray(JaxColorJitter(*jitter)(Image.fromarray(img), None)[0])
        got, _ = ColorJitter(*jitter, rng=random.Random(seed))(img, None)
        assert got.dtype == np.uint8 and got.shape == img.shape
        np.testing.assert_array_equal(got, want)


def test_training_transform_with_jitter_as_jax(cityscapes):
    """ColorJitter first, then the resize and flip, their draws in JAX's
    order from one seed: the same sizes and flips, images within one grey
    level (the resize)."""
    img_root, ann_root = cityscapes
    jcfg, tcfg = configs()
    for c in (jcfg, tcfg):
        c.INPUT.MIN_SIZE_TRAIN = (96, 112, 128)
        c.INPUT.MAX_SIZE_TRAIN = 400
        c.INPUT.HORIZONTAL_FLIP_PROB_TRAIN = 0.5
        c.INPUT.BRIGHTNESS, c.INPUT.CONTRAST, c.INPUT.SATURATION, c.INPUT.HUE = 0.2, 0.2, 0.2, 0.05
    ds = CityScapesDataset(img_root, ann_root, "val", mode="poly")
    ours = build_transforms(tcfg, True, seed=5)
    theirs = jax_build_transforms(jcfg, True)
    assert [type(t).__name__ for t in ours.transforms][:2] == ["ColorJitter", "Resize"]
    random.seed(5)
    for i in range(len(ds)):
        img, target, _ = ds[i]
        got, gt = ours(img, target)
        want, wt = theirs(Image.fromarray(img), target)
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        np.testing.assert_allclose(gt.bbox, wt.bbox, rtol=0, atol=1e-4)
        assert getattr(gt, "_hflipped", False) == getattr(wt, "_hflipped", False)


# -- train_net on two datasets from a catalog:// weight ------------------------


def test_train_net_on_two_datasets_from_a_catalog_weight(tmp_path, monkeypatch):
    """The flagship's YAML (two training datasets, a catalog:// ImageNet
    weight) at the narrow widths of tests/test_torch_train_net.py on the CPU:
    the weight comes from a pre-populated cache (urllib raises), and the
    loader draws from both trees."""
    import urllib.error
    import urllib.request

    from chip_smoke import detectron_blobs, write_pkl
    from maskrcnn_tpu_torch.models import build_detection_model
    from maskrcnn_tpu_torch.tools import train_net
    from test_torch_train_net import CONFIG, OPTS

    root = tmp_path / "datasets"
    for split, ann, n, seed in (("train2014", "instances_train2014.json", 4, 0),
                                ("val2014", "instances_valminusminival2014.json", 3, 1)):
        img_dir, ann_file = make_synthetic_coco(str(tmp_path / split), num_images=n,
                                                num_classes=3, seed=seed)
        (root / "coco" / "annotations").mkdir(parents=True, exist_ok=True)
        shutil.move(ann_file, str(root / "coco" / "annotations" / ann))
        shutil.move(img_dir, str(root / "coco" / split))
    opts = [o for o in OPTS]
    for key in ("MODEL.WEIGHT", "DATASETS.TRAIN"):  # the YAML's own
        i = opts.index(key)
        del opts[i:i + 2]
    cfg = train_net.default_cfg.clone()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(opts)
    assert cfg.MODEL.WEIGHT == "catalog://ImageNetPretrained/MSRA/R-50"
    assert cfg.DATASETS.TRAIN == ("coco_2014_train", "coco_2014_valminusminival")
    state = {k: v.numpy() for k, v in build_detection_model(cfg, device="cpu", seed=9)
             .state_dict().items()}
    cache = tmp_path / "cache"
    write_pkl(str(cache / "R-50.pkl"), detectron_blobs(np, state, imagenet=True), wrap=False)

    def no_network(*args, **kwargs):
        raise urllib.error.URLError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    monkeypatch.setenv("MASKRCNN_TPU_CACHE", str(cache))
    monkeypatch.setenv("MASKRCNN_TPU_DATA_DIR", str(root))
    seen, start = [], {}
    do_train = train_net.do_train

    def recording(model, optimizer, scheduler, data_loader, *args, **kwargs):
        start.update((k, v.detach().clone()) for k, v in model.state_dict().items())
        seen.append(data_loader.dataset)
        return do_train(model, optimizer, scheduler, data_loader, *args, **kwargs)

    monkeypatch.setattr(train_net, "do_train", recording)
    model, meters = train_net.main(["--config-file", CONFIG, "--skip-test"] + opts + [
        "SOLVER.MAX_ITER", "2", "OUTPUT_DIR", str(tmp_path / "out"),
        "DATALOADER.NUM_WORKERS", "0"])
    (dataset,) = seen
    assert isinstance(dataset, ConcatDataset) and len(dataset) == 7
    conv = "backbone.body.layer1.0.conv2.weight"
    assert torch.equal(start[conv], torch.from_numpy(state[conv]))
    assert all(np.isfinite(m.global_avg) for k, m in meters.meters.items() if k.startswith("loss"))
    assert os.path.exists(tmp_path / "out" / "model_final.pth")
