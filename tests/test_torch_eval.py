"""The port's evaluation pieces against the JAX package's, on the CPU.

* The RLE ops of maskrcnn_tpu_torch/utils/maskops.py: the COCO string codec
  (byte for byte, both directions, on the JAX package's output), areas,
  ``rle_iou`` with crowd gt, ``merge_rles``, ``polygons_to_rle`` and the
  native ``paste_encode_mask`` (bit-equal to the JAX package's native one,
  boxes partly off the image and degenerate ones included). All exact.
* ``COCOEvaluator`` on the hand cases of tests/test_cocoeval.py, with the
  same expected values, and its whole stats dict equal to the JAX one's.
* ``do_coco_evaluation`` and ``evaluate_box_proposals`` against the JAX
  package's on the same BoxList predictions over a synthetic COCO tree: the
  bbox and segm stats, and the recalls, exactly equal; the regression gate
  ``check_expected_results`` passing and failing.
* ``detections_to_boxlists`` against the JAX one on the same padded dict,
  and ``boxlist_iou`` / ``cat_boxlist``: exact.
* The test collator on a batch that mixes portrait and landscape images.
"""

import json

import numpy as np
import pytest
import torch

from maskrcnn_tpu.data.datasets import COCODataset as JaxCOCO
from maskrcnn_tpu.data.evaluation import coco_eval as jax_coco_eval
from maskrcnn_tpu.data.evaluation.cocoeval import COCOEvaluator as JaxEvaluator
from maskrcnn_tpu.engine.inference import detections_to_boxlists as jax_detections_to_boxlists
from maskrcnn_tpu.structures import BoxList as JaxBoxList
from maskrcnn_tpu.structures.boxlist_ops import boxlist_iou as jax_boxlist_iou
from maskrcnn_tpu.utils import maskops as jax_maskops
from maskrcnn_tpu_torch.config import cfg as torch_cfg
from maskrcnn_tpu_torch.data.collate import BatchCollator
from maskrcnn_tpu_torch.data.datasets import COCODataset
from maskrcnn_tpu_torch.data.evaluation import coco_eval, evaluate
from maskrcnn_tpu_torch.data.evaluation.cocoeval import IOU_THRS, COCOEvaluator, bbox_iou_xywh
from maskrcnn_tpu_torch.engine.inference import detections_to_boxlists
from maskrcnn_tpu_torch.structures import BoxList
from maskrcnn_tpu_torch.structures.boxlist_ops import boxlist_iou, cat_boxlist
from maskrcnn_tpu_torch.utils import maskops
from synthetic_coco import make_synthetic_coco
from torch_port_fixtures import random_boxes

pytest.importorskip("maskrcnn_tpu.utils._maskops_native")


def _random_masks(rs, n, h, w):
    """Blobby random masks (runs of several lengths), one all zero and one
    all one."""
    small = rs.rand(n, (h + 3) // 4, (w + 3) // 4) > 0.6
    masks = small.repeat(4, 1).repeat(4, 2)[:, :h, :w].astype(np.uint8)
    masks[0] = 0
    masks[1] = 1
    return masks


# -- RLE ops -------------------------------------------------------------------


def test_rle_string_codec_matches_jax_both_ways():
    rs = np.random.RandomState(0)
    for m in _random_masks(rs, 12, 37, 29):
        want = jax_maskops.encode_mask(m)
        got = maskops.encode_mask(m)
        assert got == want
        counts = jax_maskops.mask_to_rle_counts(m)
        np.testing.assert_array_equal(maskops.mask_to_rle_counts(m), counts)
        np.testing.assert_array_equal(maskops.rle_string_to_counts(want["counts"]), counts)
        np.testing.assert_array_equal(maskops.rle_string_to_counts(want["counts"].encode()),
                                      counts)
        np.testing.assert_array_equal(maskops.decode_rle(want), m)
        np.testing.assert_array_equal(maskops.decode_rle({"size": [37, 29],
                                                          "counts": counts.tolist()}), m)
        assert maskops.rle_area(want) == jax_maskops.rle_area(want) == int(m.sum())
    # counts whose deltas are large and negative (the sign bit of a group)
    counts = [0, 5000, 3, 1, 70000, 2, 9, 123456]
    s = maskops.rle_counts_to_string(counts)
    assert s == jax_maskops.rle_counts_to_string(counts)
    np.testing.assert_array_equal(maskops.rle_string_to_counts(s), counts)


def test_rle_iou_merge_and_polygons_match_jax():
    rs = np.random.RandomState(1)
    h, w = 41, 53
    dts = [maskops.encode_mask(m) for m in _random_masks(rs, 6, h, w)]
    gts = [maskops.encode_mask(m) for m in _random_masks(rs, 5, h, w)]
    gts.append({"size": [h, w], "counts": maskops.mask_to_rle_counts(
        _random_masks(rs, 3, h, w)[2]).tolist()})  # uncompressed counts
    iscrowd = [0, 1, 0, 0, 1, 0]
    for crowd in (None, iscrowd):
        want = jax_maskops.rle_iou(dts, gts, iscrowd=crowd)
        got = maskops.rle_iou(dts, gts, iscrowd=crowd)
        np.testing.assert_array_equal(got, want)
    # crowd IoU is intersection over the detection's area
    a, b = maskops.decode_rle(dts[2]), maskops.decode_rle(gts[1])
    assert got[2, 1] == (a & b).sum() / a.sum()
    assert maskops.run_intersection(maskops.mask_to_rle_counts(a),
                                    maskops.mask_to_rle_counts(b)) == int((a & b).sum())
    assert maskops.merge_rles(dts[2:5]) == jax_maskops.merge_rles(dts[2:5])
    assert maskops.merge_rles(dts[:1]) is dts[0]
    polys = [[3.2, 4.1, 30.5, 6.0, 25.0, 38.7, 5.5, 30.0], [40, 2, 50, 2, 45, 12]]
    assert maskops.polygons_to_rle(polys, h, w) == jax_maskops.polygons_to_rle(polys, h, w)


def test_paste_encode_mask_bit_equal_to_jax_native():
    rs = np.random.RandomState(2)
    h, w = 61, 83
    masks = rs.uniform(size=(40, 28, 28)).astype(np.float32)
    boxes = random_boxes(rs, 40, -20, 100, 0.5, 70).astype(np.float64)
    boxes[0] = [-30.0, -25.0, 10.0, 8.0]    # off the top-left corner
    boxes[1] = [70.0, 50.0, 130.0, 90.0]    # off the bottom-right corner
    boxes[2] = [100.0, 70.0, 120.0, 80.0]   # entirely outside the image
    boxes[3] = [30.4, 20.7, 29.9, 60.2]     # negative width
    boxes[4] = [10.0, 10.0, 10.3, 10.2]     # under a pixel
    masks[5] = 0.5                          # exactly at the threshold
    for mask, box in zip(masks, boxes):
        want = jax_maskops.paste_encode_mask(mask, box, h, w)
        got = maskops.paste_encode_mask(mask, box, h, w)
        assert got == want
    with pytest.raises(ValueError):
        maskops.paste_encode_mask(masks[0][None], boxes[0], h, w)


# -- the evaluator on hand cases (tests/test_cocoeval.py) ------------------------


class FakeDataset:
    def __init__(self, anns_by_img, sizes, cats=(1,)):
        self.ids = sorted(anns_by_img.keys())
        self.anns_by_img = anns_by_img
        self.imgs = {i: {"id": i, "height": sizes[i][0], "width": sizes[i][1]} for i in self.ids}
        self.categories = {c: "c{}".format(c) for c in cats}


def _gt(cat, bbox, iscrowd=0):
    return {"image_id": 1, "category_id": cat, "bbox": list(bbox), "area": bbox[2] * bbox[3],
            "iscrowd": iscrowd}


def _dt(cat, bbox, score):
    return {"image_id": 1, "category_id": cat, "bbox": list(bbox), "score": score}


_SHIFT_IOU = bbox_iou_xywh(np.array([(20, 10, 40, 40)], float),
                           np.array([(10, 10, 40, 40)], float), [0])[0, 0]
_SQUARE = np.zeros((50, 50), np.uint8)
_SQUARE[10:30, 10:30] = 1

HAND_CASES = {
    "perfect": ([_gt(1, (10, 10, 40, 40))], (100, 100), [_dt(1, (10, 10, 40, 40), 0.9)],
                "bbox", {"AP": 1.0, "AP75": 1.0}),
    "iou_60": ([_gt(1, (10, 10, 40, 40))], (100, 100), [_dt(1, (20, 10, 40, 40), 0.9)],
               "bbox", {"AP": (IOU_THRS <= _SHIFT_IOU).sum() / 10, "AP50": 1.0, "AP75": 0.0}),
    "false_positive_first": ([_gt(1, (10, 10, 40, 40))], (100, 100),
                             [_dt(1, (70, 70, 20, 20), 0.95), _dt(1, (10, 10, 40, 40), 0.9)],
                             "bbox", {"AP50": 0.5}),
    "crowd_absorbs": ([_gt(1, (10, 10, 40, 40), iscrowd=1)], (100, 100),
                      [_dt(1, (12, 12, 36, 36), 0.9)], "bbox", {"AP": -1.0}),
    "missed_gt": ([_gt(1, (10, 10, 40, 40)), _gt(1, (60, 60, 30, 30))], (120, 120),
                  [_dt(1, (10, 10, 40, 40), 0.9)], "bbox", {"AP50": 51 / 101}),
    "area_ranges": ([_gt(1, (5, 5, 16, 16)), _gt(1, (30, 30, 100, 100))], (200, 200),
                    [_dt(1, (5, 5, 16, 16), 0.9), _dt(1, (30, 30, 100, 100), 0.8)], "bbox",
                    {"APs": 1.0, "APl": 1.0, "APm": -1.0}),
    "segm": ([{"image_id": 1, "category_id": 1, "bbox": [10, 10, 20, 20], "area": 400,
               "iscrowd": 0, "segmentation": [[10, 10, 29, 10, 29, 29, 10, 29]]}], (50, 50),
             [{"image_id": 1, "category_id": 1, "score": 0.9, "bbox": [10, 10, 20, 20],
               "segmentation": jax_maskops.encode_mask(_SQUARE)}], "segm", {"AP50": 1.0}),
}


@pytest.mark.parametrize("case", sorted(HAND_CASES))
def test_evaluator_hand_cases_match_jax(case):
    gts, size, dts, iou_type, expected = HAND_CASES[case]
    ds = FakeDataset({1: gts}, {1: size})
    stats = COCOEvaluator(ds, iou_type).evaluate({1: dts})
    for k, v in expected.items():
        assert stats[k] == pytest.approx(v, abs=1e-6), k
    assert stats == JaxEvaluator(ds, iou_type).evaluate({1: dts})


# -- do_coco_evaluation and evaluate_box_proposals against JAX --------------------


@pytest.fixture(scope="module")
def coco_tree(tmp_path_factory):
    """A synthetic COCO tree with sparse json category ids (1, 3, 7) and a
    crowd annotation, opened by both packages."""
    root = tmp_path_factory.mktemp("eval")
    img_dir, ann_file = make_synthetic_coco(str(root), num_images=6, num_classes=3, seed=4)
    with open(ann_file) as f:
        data = json.load(f)
    remap = {1: 1, 2: 3, 3: 7}
    for a in data["annotations"]:
        a["category_id"] = remap[a["category_id"]]
    for c in data["categories"]:
        c["id"] = remap[c["id"]]
    crowd = dict(data["annotations"][0], id=999, iscrowd=1)
    data["annotations"].append(crowd)
    with open(ann_file, "w") as f:
        json.dump(data, f)
    return COCODataset(ann_file, img_dir), JaxCOCO(ann_file, img_dir)


def _predictions(dataset, seed=5):
    """Per image: detections near each gt (jittered) plus random ones, with
    masks and objectness; as (port BoxLists, JAX BoxLists)."""
    rs = np.random.RandomState(seed)
    ours, theirs = [], []
    for i in range(len(dataset)):
        info = dataset.get_img_info(i)
        w, h = info["width"], info["height"]
        anns = dataset.anns_by_img[dataset.id_to_img_map[i]]
        gt = np.asarray([a["bbox"] for a in anns], np.float32).reshape(-1, 4)
        near = np.concatenate([gt[:, :2], gt[:, :2] + gt[:, 2:] - 1], 1)
        near = near + rs.normal(0, 2, near.shape).astype(np.float32)
        boxes = np.concatenate([near, random_boxes(rs, 4, 0, min(w, h), 4, 60)])
        boxes = np.clip(boxes, 0, [w - 1, h - 1, w - 1, h - 1]).astype(np.float32)
        n = len(boxes)
        labels = np.concatenate([[dataset.json_category_id_to_contiguous_id[a["category_id"]]
                                  for a in anns], rs.randint(1, 4, 4)]).astype(np.int64)
        fields = {"scores": rs.uniform(0.05, 1, n).astype(np.float32), "labels": labels,
                  "mask": rs.uniform(size=(n, 28, 28)).astype(np.float32),
                  "objectness": rs.uniform(size=n).astype(np.float32)}
        pair = []
        for cls in (BoxList, JaxBoxList):
            bl = cls(boxes, (w, h), mode="xyxy")
            for k, v in fields.items():
                bl.add_field(k, v)
            pair.append(bl)
        ours.append(pair[0])
        theirs.append(pair[1])
    return ours, theirs


def test_do_coco_evaluation_matches_jax(coco_tree):
    ds, jds = coco_tree
    assert ds.contiguous_category_id_to_json_id == jds.contiguous_category_id_to_json_id \
        == {1: 1, 2: 3, 3: 7}
    assert ds.id_to_img_map == jds.id_to_img_map
    ours, theirs = _predictions(ds)
    kw = dict(box_only=False, output_folder=None, iou_types=["bbox", "segm"],
              expected_results=(), expected_results_sigma_tol=4)
    got, _ = evaluate(ds, ours, None, iou_types=("bbox", "segm"))
    want, _ = jax_coco_eval.do_coco_evaluation(jds, theirs, **kw)
    assert got.results == want.results
    assert 0 < got.results["bbox"]["AP"] < 1 and 0 <= got.results["segm"]["AP"] < 1
    # the COCO-format records themselves
    assert coco_eval.prepare_for_coco_detection(ours, ds) == \
        jax_coco_eval.prepare_for_coco_detection(theirs, jds)
    assert coco_eval.prepare_for_coco_segmentation(ours, ds) == \
        jax_coco_eval.prepare_for_coco_segmentation(theirs, jds)
    # keypoint records need the detections' keypoints, in both packages
    # (tests/test_torch_keypoint.py holds them to JAX's)
    with pytest.raises(KeyError):
        coco_eval.prepare_for_coco_keypoint(ours, ds)
    with pytest.raises(KeyError):
        jax_coco_eval.prepare_for_coco_keypoint(theirs, jds)
    with pytest.raises(NotImplementedError):
        evaluate(object(), ours, None)


def test_evaluate_box_proposals_matches_jax(coco_tree):
    ds, jds = coco_tree
    ours, theirs = _predictions(ds, seed=6)
    for area, limit in (("all", None), ("small", 3), ("medium", 100), ("large", 1000)):
        got = coco_eval.evaluate_box_proposals(ours, ds, area=area, limit=limit)
        want = jax_coco_eval.evaluate_box_proposals(theirs, jds, area=area, limit=limit)
        assert got["num_pos"] == want["num_pos"]
        for k in ("ar", "recalls", "thresholds", "gt_overlaps"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got, _ = coco_eval.do_coco_evaluation(ds, ours, True, None, ["bbox"], (), 4)
    want, _ = jax_coco_eval.do_coco_evaluation(jds, theirs, True, None, ["bbox"], (), 4)
    assert got.results == want.results and got.results["box_proposal"]["AR@100"] > 0


@pytest.mark.parametrize("mean,passes", [(0.5, True), (0.9, False)])
def test_check_expected_results(mean, passes):
    res = coco_eval.COCOResults("bbox", "segm")
    res.update("bbox", {"AP": 0.51, "AP50": 0.8, "unknown": 3.0})
    assert res.results["bbox"]["AP"] == 0.51 and "unknown" not in res.results["bbox"]
    assert res.results["segm"]["AP"] == -1.0
    expected = [["bbox", "AP", mean, 0.01], ["bbox", "AP50", 0.8, 0.01]]
    if passes:
        coco_eval.check_expected_results(res, expected, 4)
    else:
        with pytest.raises(AssertionError, match="bbox > AP sanity check FAILED"):
            coco_eval.check_expected_results(res, expected, 4)
        with pytest.raises(AssertionError):
            jax_coco_eval.check_expected_results(res, expected, 4)
    with pytest.raises(ValueError):
        coco_eval.COCOResults("bbox", "boxes")


# -- detections, BoxList ops, the test collator ---------------------------------


def test_detections_to_boxlists_match_jax():
    rs = np.random.RandomState(7)
    b, d = 3, 6
    det = {"boxes": random_boxes(rs, b * d, 0, 90, 2, 40).reshape(b, d, 4),
           "scores": rs.uniform(size=(b, d)).astype(np.float32),
           "labels": rs.randint(1, 81, (b, d)).astype(np.int32),
           "valid": rs.rand(b, d) > 0.4,
           "masks": rs.uniform(size=(b, d, 28, 28)).astype(np.float32)}
    det["valid"][2] = False  # an image without detections
    sizes = np.array([[100, 90], [80, 96], [64, 64]], np.int32)
    want = jax_detections_to_boxlists(det, sizes)
    got = detections_to_boxlists({k: torch.from_numpy(v) for k, v in det.items()},
                                 torch.from_numpy(sizes))
    assert len(got) == len(want) == b and len(got[2]) == 0
    for g, w in zip(got, want):
        assert g.size == w.size and g.mode == w.mode
        np.testing.assert_array_equal(g.bbox, w.bbox)
        for k in ("scores", "labels", "mask"):
            np.testing.assert_array_equal(g.get_field(k), w.get_field(k))
        # the resize back to the original image scales the boxes only
        g2, w2 = g.resize((300, 200)), w.resize((300, 200))
        np.testing.assert_array_equal(g2.bbox, w2.bbox)
        np.testing.assert_array_equal(g2.get_field("mask"), g.get_field("mask"))
    # decoded keypoints [B, D, K, 4] ride along and resize with the boxes
    det["keypoints"] = rs.uniform(0, 90, (b, d, 17, 4)).astype(np.float32)
    want = jax_detections_to_boxlists(det, sizes)
    got = detections_to_boxlists({k: torch.from_numpy(v) for k, v in det.items()},
                                 torch.from_numpy(sizes))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.get_field("keypoints")),
                                      np.asarray(w.get_field("keypoints")))
        np.testing.assert_array_equal(
            np.asarray(g.resize((300, 200)).get_field("keypoints")),
            np.asarray(w.resize((300, 200)).get_field("keypoints")))


def test_boxlist_iou_and_cat():
    rs = np.random.RandomState(8)
    a, b = random_boxes(rs, 7, 0, 50, 0, 20), random_boxes(rs, 5, 0, 50, 0, 20)
    got = boxlist_iou(BoxList(a, (60, 60)), BoxList(b, (60, 60)).convert("xywh"))
    want = jax_boxlist_iou(JaxBoxList(a, (60, 60)), JaxBoxList(b, (60, 60)).convert("xywh"))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError):
        boxlist_iou(BoxList(a, (60, 60)), BoxList(b, (60, 61)))
    parts = [BoxList(a, (60, 60)), BoxList(b, (60, 60))]
    for p, s in zip(parts, (np.arange(7), np.arange(5))):
        p.add_field("scores", s)
    cat = cat_boxlist(parts)
    np.testing.assert_array_equal(cat.bbox, np.concatenate([a, b]))
    np.testing.assert_array_equal(cat.get_field("scores"), np.r_[np.arange(7), np.arange(5)])
    with pytest.raises(ValueError):
        cat_boxlist([parts[0], BoxList(b, (60, 61))])


def test_test_collator_takes_mixed_orientations():
    """A test batch of a landscape and a portrait image (no aspect grouping
    at test time) fits neither bucket; it is padded to the largest height by
    the largest width of the buckets (the JAX collator's fallback overflows)."""
    c = torch_cfg.clone()
    collate = BatchCollator(c, is_train=False)
    assert collate.buckets == [(800, 1344), (1344, 800)]
    land, port = np.ones((800, 1066, 3), np.uint8), np.full((1066, 800, 3), 2, np.uint8)
    out = collate([(land, None, 0), (port, None, 1)])
    assert out["images"].shape == (2, 1344, 1344, 3)
    assert (out["images"][0, :800, :1066] == 1).all() and out["images"][0, 800:].sum() == 0
    assert (out["images"][1, :1066, :800] == 2).all() and out["images"][1, :, 800:].sum() == 0
    np.testing.assert_array_equal(out["image_sizes"], [[800, 1066], [1066, 800]])
    np.testing.assert_array_equal(out["indices"], [0, 1])
    assert collate([(land, None, 0)])["images"].shape == (1, 800, 1344, 3)
