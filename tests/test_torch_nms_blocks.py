"""The blocked walk of the port's NMS kernel (csrc/nms.cu), against the JAX package.

The CUDA kernel resolves a lane's score-sorted boxes 64 rows at a time: a
block's rows in order from its diagonal suppression word, then every later
column by the block's kept rows at once, stopping after the last block that
holds a valid row. Its plain-PyTorch rendering ``ops/nms.py:
blocked_nms_sorted`` (block size a parameter) is held here bit for bit
against
  * the TPU kernel ``nms_sorted_pallas`` in interpret mode, on the same
    sorted lanes, and
  * the JAX greedy scan ``batched_nms_mask``, in the original order,
on lanes with score ties and duplicate boxes, lanes without a valid box,
lanes whose valid boxes all lie past the first block, n of 1, 63, 65 and
200 (not multiples of the block, one block and a half, one past a block)
and thresholds 0.3, 0.5 and 0.7. The kernel itself is held against the
plain version on the card by tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maskrcnn_tpu.ops.nms import batched_nms_mask
from maskrcnn_tpu.ops.pallas.nms_kernel import nms_sorted_pallas
from maskrcnn_tpu_torch.ops.nms import _sort_lanes, batched_nms_plain, blocked_nms_sorted
from torch_port_fixtures import random_boxes


def _lanes(n, seed):
    """Five lanes: random with coarse (tied) scores; no valid box; one box
    repeated with equal scores; random with every box duplicated; valid
    boxes only past the first 64 rows."""
    rs = np.random.RandomState(seed)
    boxes = np.stack([random_boxes(rs, n, 0, 200, 4, 120) for _ in range(5)])
    scores = (np.round(rs.uniform(size=(5, n)) * 6) / 6).astype(np.float32)
    valid = rs.uniform(size=(5, n)) > 0.15
    valid[1] = False
    boxes[2] = [20, 30, 90, 70]
    scores[2] = 0.5
    valid[2] = True
    half = (n + 1) // 2
    boxes[3, half:2 * half] = boxes[3, :n - half]
    scores[3, half:2 * half] = scores[3, :n - half]
    valid[4, :64] = False
    return boxes, scores, valid


def _sorted(boxes, scores, valid):
    order, sboxes, svalid = _sort_lanes(torch.from_numpy(boxes), torch.from_numpy(scores),
                                        torch.from_numpy(valid))
    return order, sboxes, svalid


@pytest.mark.parametrize("n", [1, 63, 65, 200])
@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_blocked_walk_matches_jax_scan_and_pallas_kernel(n, thresh):
    boxes, scores, valid = _lanes(n, seed=n)
    order, sboxes, svalid = _sorted(boxes, scores, valid)
    got_sorted = blocked_nms_sorted(sboxes, svalid, thresh)
    pallas = np.asarray(nms_sorted_pallas(jnp.asarray(sboxes.numpy()), jnp.asarray(svalid.numpy()),
                                          thresh, interpret=True))
    np.testing.assert_array_equal(got_sorted.numpy(), pallas)
    got = torch.zeros_like(got_sorted).scatter_(1, order, got_sorted).numpy()
    want = np.asarray(batched_nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                       jnp.asarray(valid), thresh))
    np.testing.assert_array_equal(got, want)
    assert not got[1].any() and got[2].sum() == 1 and got[2, 0]
    assert not got[4, :64].any()


@pytest.mark.parametrize("block", [1, 8, 64, 128])
def test_blocked_walk_does_not_depend_on_the_block_size(block):
    boxes, scores, valid = _lanes(200, seed=7)
    order, sboxes, svalid = _sorted(boxes, scores, valid)
    got = blocked_nms_sorted(sboxes, svalid, 0.5, block)
    got = torch.zeros_like(got).scatter_(1, order, got)
    want = batched_nms_plain(torch.from_numpy(boxes), torch.from_numpy(scores),
                             torch.from_numpy(valid), 0.5)
    assert torch.equal(got, want)
