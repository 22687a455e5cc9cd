"""Mask-to-polygon tracing in the port (utils/maskops.py:trace_contours, C++
in csrc/maskops.cpp, and its plain Python twin) against OpenCV's
findContours(RETR_EXTERNAL, CHAIN_APPROX_TC89_L1), which the JAX package's
BinaryMaskList.convert_to_polygon calls.

A seeded sweep of 400 masks: random noise, blocky blobs, discs with holes
(and islands in them), one-pixel lines, masks touching every border,
single pixels and empty masks, from 1 x 1 to 100 x 100; then
``SegmentationMask.convert("poly")`` and the round trip back to a mask
against the JAX package's, on the same masks.
"""

import numpy as np
import pytest

from maskrcnn_tpu.structures.segmentation_mask import SegmentationMask as JaxSegmentationMask
from maskrcnn_tpu_torch.structures.segmentation_mask import SegmentationMask
from maskrcnn_tpu_torch.utils.maskops import trace_contours, trace_contours_plain

cv2 = pytest.importorskip("cv2")


def _mask(rs, kind):
    h, w = (int(v) for v in rs.randint(1, 101 if kind != "tiny" else 9, 2))
    yy, xx = np.mgrid[:h, :w]
    if kind in ("noise", "tiny"):
        m = rs.rand(h, w) < rs.uniform(0.1, 0.9)
    elif kind == "blocks":
        m = (rs.rand(max(h // 5, 1), max(w // 5, 1)) < 0.5).repeat(5, 0).repeat(5, 1)
        m = np.pad(m, ((0, max(h - m.shape[0], 0)), (0, max(w - m.shape[1], 0))))[:h, :w]
    elif kind == "holes":
        m = np.zeros((h, w), bool)
        for _ in range(rs.randint(1, 4)):
            cy, cx, r = rs.uniform(0, h), rs.uniform(0, w), rs.uniform(1, 30)
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            m |= d2 < r * r
            m &= ~(d2 < (r * rs.uniform(0.2, 0.7)) ** 2)
            m |= d2 < (r * rs.uniform(0, 0.15)) ** 2  # an island in the hole
    elif kind == "lines":
        m = np.zeros((h, w), bool)
        for _ in range(rs.randint(1, 6)):
            if rs.rand() < 0.5:
                m[rs.randint(h), rs.randint(w):] = True
            else:
                m[rs.randint(h):, rs.randint(w)] = True
    elif kind == "borders":
        m = rs.rand(h, w) < 0.3
        m[0], m[-1], m[:, 0], m[:, -1] = True, True, True, True
    elif kind == "pixel":
        m = np.zeros((h, w), bool)
        m[rs.randint(h), rs.randint(w)] = True
    else:
        m = np.zeros((h, w), bool)
    return m.astype(np.uint8)


KINDS = ("noise", "blocks", "holes", "lines", "borders", "pixel", "tiny", "empty")


@pytest.mark.parametrize("kind", KINDS)
def test_contours_equal_findcontours_point_for_point(kind):
    rs = np.random.RandomState(KINDS.index(kind))
    for _ in range(50):
        m = _mask(rs, kind)
        want, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_TC89_L1)
        want = [c.reshape(-1, 2).tolist() for c in want]
        assert [c.tolist() for c in trace_contours(m)] == want
        assert [c.tolist() for c in trace_contours_plain(m)] == want


def test_native_and_plain_agree_on_a_large_mask():
    m = np.random.RandomState(9).rand(300, 400) < 0.45
    got, plain = trace_contours(m), trace_contours_plain(m)
    assert len(got) == len(plain) > 100
    assert all(np.array_equal(a, b) for a, b in zip(got, plain))


def test_convert_poly_round_trip_matches_jax():
    rs = np.random.RandomState(10)
    for kind in ("holes", "blocks", "borders", "empty"):
        h, w = 60, 80
        masks = np.zeros((3, h, w), np.uint8)
        for i in range(3 if kind != "empty" else 0):
            m = _mask(rs, kind)
            masks[i, :min(h, m.shape[0]), :min(w, m.shape[1])] = m[:h, :w]
        ours = SegmentationMask(masks, (w, h), mode="mask").convert("poly")
        theirs = JaxSegmentationMask(masks, (w, h), mode="mask").convert("poly")
        assert ours.mode == theirs.mode == "poly"
        got = [[p.tolist() for p in inst.polygons] for inst in ours.instances.polygons]
        want = [[p.tolist() for p in inst.polygons] for inst in theirs.instances.polygons]
        assert got == want
        assert all(len(p) >= 6 for inst in got for p in inst)
        back = ours.convert("mask").get_mask_tensor()
        np.testing.assert_array_equal(back, theirs.convert("mask").get_mask_tensor())
