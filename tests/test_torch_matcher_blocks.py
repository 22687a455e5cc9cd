"""The pruned restore of the port's anchor-matcher kernel (csrc/matcher.cu),
against the JAX package.

The CUDA kernel's blocks walk anchor tiles grid-stride; each keeps its own
maximum IoU per gt, and after the grid-wide barrier revisits its anchors
only for the gt whose block maximum equals the gt's final best (> 0). Its
plain-PyTorch rendering ``ops/matcher.py:match_anchors_blocked`` (tile and
grid as parameters) is held exactly against the JAX ``match_anchors_streaming``
(the reference Matcher with allow_low_quality_matches=True) on
  * one anchor repeated in several tiles and blocks, tying a gt's best
    below the low threshold (every copy is restored, whichever block holds
    it);
  * an image without a valid gt (all -1);
  * a gt that no anchor meets (best IoU 0: no restore);
  * validity holes inside the gt rows, and gt rows past the last valid one.
The kernel itself is held against the plain version on the card by
tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tpu.ops.matcher import match_anchors_streaming
from maskrcnn_tpu_torch.ops.box_ops import box_iou
from maskrcnn_tpu_torch.ops.matcher import match_anchors_blocked, match_anchors_plain
from torch_port_fixtures import random_boxes

COPY = [600.0, 600.0, 640.0, 630.0]  # far from the random anchors and gt


def _problem(n=3000, g=12, seed=0):
    rs = np.random.RandomState(seed)
    anchors = random_boxes(rs, n, 0, 500, 4, 150)
    anchors[5::611] = COPY  # in tiles and blocks of every layout below
    gt = np.stack([random_boxes(rs, g, 0, 500, 20, 200) for _ in range(3)])
    valid = np.ones((3, g), bool)
    valid[0, 1] = valid[0, 4] = False  # holes
    valid[0, 9:] = False               # rows past the last valid one
    gt[0, 2] = [560, 560, 700, 700]    # met by the copies only, IoU ~0.06 < 0.3
    gt[0, 3] = [2000, 2000, 2010, 2010]  # met by no anchor: best 0
    valid[1] = False                   # no valid gt
    return anchors, gt.astype(np.float32), valid


@pytest.mark.parametrize("tile,grid", [(256, 4), (64, 5), (100, 1), (7, 13)])
def test_pruned_restore_matches_jax_streaming(tile, grid):
    anchors, gt, valid = _problem()
    want = np.asarray(jax.vmap(lambda g_, v_: match_anchors_streaming(
        jnp.asarray(anchors), g_, v_, 0.7, 0.3, chunk=1024))(jnp.asarray(gt), jnp.asarray(valid)))
    got = match_anchors_blocked(torch.from_numpy(anchors), torch.from_numpy(gt),
                                torch.from_numpy(valid), 0.7, 0.3, tile, grid).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 5::611] == 2).all()       # every copy restored to gt 2
    assert (got[1] == -1).all()
    assert not (got[0] == 3).any()           # best IoU 0: nothing restored
    assert not np.isin(got[0], [1, 4, 9, 10, 11]).any()
    assert (got[2] >= 0).any() and (got == -2).any()


def test_pruned_restore_without_gt_slots():
    anchors, _, _ = _problem(n=500)
    empty = torch.zeros((2, 0, 4))
    got = match_anchors_blocked(torch.from_numpy(anchors), empty,
                                torch.zeros((2, 0), dtype=torch.bool), 0.7, 0.3)
    want = match_anchors_plain(torch.from_numpy(anchors), empty,
                               torch.zeros((2, 0), dtype=torch.bool), 0.7, 0.3)
    assert torch.equal(got, want) and (got == -1).all()


def test_warp_skip_only_where_every_iou_is_zero():
    """The kernel's pass 1 skips a gt for a warp when the gt lies outside the
    warp's anchors' hull widened by 2 (each bound rounded in float32). Held
    here on anchors of one warp and gt around the hull's edges, a quarter
    pixel apart: wherever the test skips, every IoU is exactly +0."""
    rs = np.random.RandomState(3)
    skipped = 0
    for trial in range(40):
        anchors = random_boxes(rs, 64, 0, 300, 4, 120)
        x1, y1 = anchors[:, 0].min(), anchors[:, 1].min()
        x2, y2 = anchors[:, 2].max(), anchors[:, 3].max()
        f = np.float32
        ext = (f(x1) - f(2), f(y1) - f(2), f(x2) + f(2), f(y2) + f(2))
        offs = np.arange(-12, 12, dtype=np.float32) * f(0.25)
        side = rs.uniform(1, 60, (len(offs), 1)).astype(np.float32)
        gt = np.concatenate([
            np.stack([x1 - side[:, 0] + offs - 3, rs.uniform(0, 300, len(offs)),
                      x1 + offs - 3, rs.uniform(300, 400, len(offs))], 1),
            np.stack([x2 + offs + 3, y1 - 5 + offs, x2 + offs + 3 + side[:, 0], y2 + offs], 1),
            np.stack([rs.uniform(0, 300, len(offs)), y1 - side[:, 0] + offs - 3,
                      rs.uniform(300, 400, len(offs)), y1 + offs - 3], 1),
            np.stack([x1 + offs, y2 + offs + 3, x2 + 0 * offs, y2 + offs + 3 + side[:, 0]], 1),
        ]).astype(np.float32)
        skip = (gt[:, 2] < ext[0]) | (gt[:, 0] > ext[2]) | (gt[:, 3] < ext[1]) | (gt[:, 1] > ext[3])
        iou = box_iou(torch.from_numpy(gt), torch.from_numpy(anchors)).numpy()
        assert (iou[skip] == 0).all() and not np.signbit(iou[skip]).any()
        skipped += int(skip.sum())
        assert (iou[~skip] > 0).any()  # the edge cases include gt that do meet
    assert skipped > 1000
