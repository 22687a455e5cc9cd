"""The port's multi-level ROIAlign (models/poolers.py) against the JAX pooler.

The port's plain version ``multilevel_roi_align_plain`` (what the wrapper
``multilevel_roi_align`` runs on CPU tensors) is held
  * against the JAX exact gather path at rtol = atol = 1e-5 (float32; the
    only difference is the order of the S x S mean), and
  * against the TPU kernel ``multilevel_roi_align_pallas`` in interpret mode
    on ROIs of at most 40 feature cells, within the 2e-4 the JAX package's
    own test allows that kernel (its bilinear weights go through matmuls).
The CUDA kernel is held against the plain version on the card by
tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maskrcnn_tpu.models.poolers import PoolerConfig as JaxPoolerConfig
from maskrcnn_tpu.models.poolers import assign_levels as jax_assign_levels
from maskrcnn_tpu.models.poolers import multilevel_roi_align as jax_roi_align
from maskrcnn_tpu.ops.pallas.roi_align_kernel import multilevel_roi_align_pallas
from maskrcnn_tpu_torch.models.poolers import (
    PoolerConfig,
    assign_levels,
    multilevel_roi_align,
    multilevel_roi_align_plain,
)
from torch_port_fixtures import random_boxes

SCALES = (0.25, 0.125, 0.0625, 0.03125)


def _pyramid(c, seed=0, b=2, h=64, w=80):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h >> i, w >> i, c).astype(np.float32) for i in range(4)]


def _rois(seed, r, lo, hi, min_wh, max_wh, b=2):
    rs = np.random.RandomState(seed)
    return random_boxes(rs, r, lo, hi, min_wh, max_wh), rs.randint(0, b, r).astype(np.int32)


def _port(feats, boxes, bidx, p):
    return multilevel_roi_align_plain(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes),
        torch.from_numpy(bidx), PoolerConfig(p, SCALES, 2)).numpy()


def test_assign_levels_matches_jax():
    boxes, _ = _rois(0, 400, -50, 1400, 0.5, 900)
    want = jax_assign_levels(jnp.asarray(boxes), JaxPoolerConfig(7, SCALES, 2))
    got = assign_levels(torch.from_numpy(boxes), PoolerConfig(7, SCALES, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", [7, 14])
def test_plain_matches_jax_gather_path(p):
    feats = _pyramid(16)
    # boxes inside, straddling and far outside the 256 x 320 image; tiny
    # boxes (the max(.., 1) floor) and large ones that reach the top level
    boxes, bidx = _rois(1, 60, -40, 300, 0.2, 260)
    boxes[:3] = [[-500, -500, -400, -400], [1000, 10, 1200, 50], [5, 5, 5, 5]]
    want = jax_roi_align([jnp.asarray(f) for f in feats], jnp.asarray(boxes),
                         jnp.asarray(bidx), JaxPoolerConfig(p, SCALES, 2),
                         compute_dtype=jnp.float32, backend="gather")
    np.testing.assert_allclose(_port(feats, boxes, bidx, p), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_plain_matches_pallas_kernel_interpret():
    feats = _pyramid(128, seed=2)
    # within 40 cells of every level: the TPU kernel's window clamp never binds
    boxes, bidx = _rois(3, 24, 20, 220, 10, 120)
    want = multilevel_roi_align_pallas(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), jnp.asarray(bidx),
        JaxPoolerConfig(7, SCALES, 2), compute_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(_port(feats, boxes, bidx, 7), np.asarray(want), atol=2e-4)


def test_wrapper_runs_plain_version_on_cpu_tensors():
    feats = _pyramid(8, seed=4)
    boxes, bidx = _rois(5, 10, 0, 250, 4, 100)
    pcfg = PoolerConfig(7, SCALES, 2)
    before = multilevel_roi_align.launches
    got = multilevel_roi_align([torch.from_numpy(f) for f in feats], torch.from_numpy(boxes),
                               torch.from_numpy(bidx), pcfg)
    np.testing.assert_array_equal(got.numpy(), _port(feats, boxes, bidx, 7))
    assert multilevel_roi_align.launches == before
    with pytest.raises(ValueError):
        multilevel_roi_align([torch.from_numpy(f) for f in feats[:3]], torch.from_numpy(boxes),
                             torch.from_numpy(bidx), pcfg)


def test_plain_bfloat16_stays_near_float32():
    feats = _pyramid(16, seed=6)
    boxes, bidx = _rois(7, 30, 0, 250, 4, 150)
    pcfg = PoolerConfig(7, SCALES, 2)
    f32 = _port(feats, boxes, bidx, 7)
    bf16 = multilevel_roi_align_plain(
        [torch.from_numpy(f).bfloat16() for f in feats], torch.from_numpy(boxes),
        torch.from_numpy(bidx), pcfg)
    assert bf16.dtype == torch.bfloat16
    scale = np.abs(np.concatenate([f.ravel() for f in feats])).max()
    assert np.abs(bf16.float().numpy() - f32).max() <= 1e-2 * scale
