"""The port's NMS (ops/nms.py) against the JAX package's, held three ways.

The port's plain version ``batched_nms_plain`` (what ``batched_nms`` runs on
a CPU tensor) must give exactly the keep-mask of
  * the JAX plain scan ``batched_nms_mask`` / ``nms_mask``,
  * the TPU kernel ``nms_mask_pallas`` run in interpret mode, and
  * the host golden ``nms_numpy``.
Keep-masks are compared exactly. The CUDA kernel is held against the plain
version on the card by tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maskrcnn_tpu.ops.nms import batched_nms_mask, nms_mask, nms_numpy
from maskrcnn_tpu.ops.pallas.nms_kernel import nms_mask_pallas
from maskrcnn_tpu_torch.ops.nms import batched_nms, batched_nms_plain
from torch_port_fixtures import random_boxes


def _lanes(seed, g, n, invalid_frac=0.15, ties=False):
    rs = np.random.RandomState(seed)
    boxes = np.stack([random_boxes(rs, n, 0, 300, 4, 120) for _ in range(g)])
    scores = rs.uniform(size=(g, n)).astype(np.float32)
    if ties:  # coarse scores: many equal values, order set by position
        scores = np.round(scores * 8) / 8
    valid = rs.uniform(size=(g, n)) > invalid_frac
    return boxes, scores, valid


def _plain(boxes, scores, valid, t):
    return batched_nms_plain(torch.from_numpy(boxes), torch.from_numpy(scores),
                             torch.from_numpy(valid), t).numpy()


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("ties", [False, True])
def test_plain_matches_jax_scan(thresh, ties):
    boxes, scores, valid = _lanes(0, 5, 150, ties=ties)
    want = np.asarray(batched_nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                       jnp.asarray(valid), thresh))
    np.testing.assert_array_equal(_plain(boxes, scores, valid, thresh), want)


def test_plain_matches_single_lane_scan_with_padding():
    boxes, scores, valid = _lanes(1, 1, 96)
    valid[0, 80:] = False
    boxes[0, 80:] = 0.0  # padded rows: degenerate boxes that must never act
    want = np.asarray(nms_mask(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                               jnp.asarray(valid[0]), 0.5))
    got = _plain(boxes, scores, valid, 0.5)[0]
    np.testing.assert_array_equal(got, want)
    assert not got[80:].any()


@pytest.mark.parametrize("g,n,thresh", [(5, 200, 0.7), (12, 128, 0.5)])
def test_plain_matches_pallas_kernel_interpret(g, n, thresh):
    boxes, scores, valid = _lanes(2, g, n)
    want = np.asarray(nms_mask_pallas(jnp.asarray(boxes), jnp.asarray(scores),
                                      jnp.asarray(valid), thresh, interpret=True))
    np.testing.assert_array_equal(_plain(boxes, scores, valid, thresh), want)


def test_plain_matches_numpy_golden():
    boxes, scores, valid = _lanes(3, 4, 180, invalid_frac=0.0)
    got = _plain(boxes, scores, valid, 0.6)
    for lane in range(4):
        want = np.zeros(180, bool)
        want[nms_numpy(boxes[lane], scores[lane], 0.6)] = True
        np.testing.assert_array_equal(got[lane], want)


def test_wrapper_runs_plain_version_on_cpu_tensors():
    boxes, scores, valid = _lanes(4, 3, 64)
    before = batched_nms.launches
    got = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      torch.from_numpy(valid), 0.5).numpy()
    np.testing.assert_array_equal(got, _plain(boxes, scores, valid, 0.5))
    assert batched_nms.launches == before  # no kernel ran


def test_wrapper_rejects_bad_shapes_and_devices():
    b = torch.zeros(2, 8, 4)
    s = torch.zeros(2, 8)
    v = torch.ones(2, 8, dtype=torch.bool)
    with pytest.raises(ValueError):
        batched_nms(b[0], s, v, 0.5)
    with pytest.raises(ValueError):
        batched_nms(b, s, v[:, :4], 0.5)
    with pytest.raises(ValueError):
        batched_nms(b.to("meta"), s.to("meta"), v.to("meta"), 0.5)
