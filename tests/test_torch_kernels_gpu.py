"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips on a machine without a CUDA
device. The file imports neither JAX nor the JAX package, so it also runs
where only PyTorch is installed:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

Tolerances: NMS keep-masks exact; ROIAlign in float32 atol 1e-5 (the kernel
and the plain version round the same products and sums, in another order
for the S x S mean); in bfloat16 at most 1e-2 * max|x| (the plain version
rounds every step in bfloat16, the kernel accumulates in float32).
"""

import numpy as np
import pytest
import torch

from maskrcnn_tpu_torch.models.poolers import (
    PoolerConfig,
    multilevel_roi_align,
    multilevel_roi_align_plain,
)
from maskrcnn_tpu_torch.ops.nms import batched_nms, batched_nms_plain

SCALES = (0.25, 0.125, 0.0625, 0.03125)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _boxes(rs, shape, lo=0.0, hi=800.0, min_wh=4.0, max_wh=300.0):
    ctr = rs.uniform(lo, hi, shape + (2,))
    wh = rs.uniform(min_wh, max_wh, shape + (2,))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("g,n,thresh", [(5, 1000, 0.7), (80, 200, 0.5), (2, 4161, 0.5)])
def test_nms_kernel_matches_plain(cuda, g, n, thresh):
    rs = np.random.RandomState(n)
    boxes = torch.from_numpy(_boxes(rs, (g, n))).to(cuda)
    scores = torch.from_numpy(np.round(rs.uniform(size=(g, n)) * 64) / 64).float().to(cuda)
    valid = torch.from_numpy(rs.uniform(size=(g, n)) > 0.1).to(cuda)
    before = batched_nms.launches
    got = batched_nms(boxes, scores, valid, thresh)
    torch.cuda.synchronize()
    assert batched_nms.launches == before + 1
    want = batched_nms_plain(boxes, scores, valid, thresh)
    assert torch.equal(got, want)
    assert not got[~valid].any()


@pytest.mark.gpu
def test_nms_kernel_rejects_what_it_does_not_take(cuda):
    boxes = torch.zeros(2, 8, 4, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        batched_nms(boxes, torch.zeros(2, 8, device=cuda),
                    torch.ones(2, 8, dtype=torch.bool, device=cuda), 0.5)


def _pyramid(cuda, dtype, c=256, b=2, h=200, w=336, seed=0):
    g = torch.Generator().manual_seed(seed)
    feats = []
    for i in range(4):
        x = torch.randn(b, c, h >> i, w >> i, generator=g).to(cuda, dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        feats.append(x.permute(0, 2, 3, 1))  # NHWC view, contiguous
    return feats


def _rois(cuda, r, b=2, seed=1):
    rs = np.random.RandomState(seed)
    boxes = _boxes(rs, (r,), -50, 1400, 0.5, 700)
    boxes[:2] = [[-400, -400, -300, -300], [1300, 700, 1600, 900]]  # outside
    bidx = rs.randint(0, b, r).astype(np.int32)
    return torch.from_numpy(boxes).to(cuda), torch.from_numpy(bidx).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("p,r", [(7, 1000), (14, 100)])
def test_roi_align_kernel_matches_plain_float32(cuda, p, r):
    feats = _pyramid(cuda, torch.float32)
    boxes, bidx = _rois(cuda, r)
    pcfg = PoolerConfig(p, SCALES, 2)
    before = multilevel_roi_align.launches
    got = multilevel_roi_align(feats, boxes, bidx, pcfg)
    torch.cuda.synchronize()
    assert multilevel_roi_align.launches == before + 1
    want = multilevel_roi_align_plain(feats, boxes, bidx, pcfg)
    assert got.shape == want.shape == (r, p, p, 256)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_roi_align_kernel_matches_plain_bfloat16(cuda):
    feats = _pyramid(cuda, torch.bfloat16)
    boxes, bidx = _rois(cuda, 1000)
    pcfg = PoolerConfig(7, SCALES, 2)
    got = multilevel_roi_align(feats, boxes, bidx, pcfg)
    want = multilevel_roi_align_plain(feats, boxes, bidx, pcfg)
    assert got.dtype == torch.bfloat16
    scale = max(f.abs().max().item() for f in feats)
    assert (got.float() - want.float()).abs().max().item() <= 1e-2 * scale


@pytest.mark.gpu
def test_roi_align_kernel_rejects_strided_levels(cuda):
    feats = [f.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
             for f in _pyramid(cuda, torch.float32, c=8, h=32, w=32)]
    boxes, bidx = _rois(cuda, 4)
    with pytest.raises(ValueError):
        multilevel_roi_align(feats, boxes, bidx, PoolerConfig(7, SCALES, 2))
