"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips on a machine without a CUDA
device. The file imports neither JAX nor the JAX package, so it also runs
where only PyTorch is installed:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

Tolerances: NMS keep-masks and matcher outputs exact; ROIAlign in float32
atol 1e-5 (the kernel and the plain version round the same products and
sums, in another order for the S x S mean); in bfloat16 at most
1e-2 * max|x| (the plain version rounds every step in bfloat16, the kernel
accumulates in float32). The ROIAlign backward against autograd through the
plain version: float32 within 1e-5 * max|grad| (float32 atomic adds in an
order that changes from run to run), bfloat16 against the float32 plain
gradient within 1e-2 * max|grad| (one rounding of each sum to bfloat16); the
same for the "rmw" and "chunk" backwards (window sums in another order than
the per-sample adds).
"""

import numpy as np
import pytest
import torch

from maskrcnn_tpu_torch.models.anchors import AnchorGenerator
from maskrcnn_tpu_torch.models.poolers import (
    BACKWARD_KERNELS,
    PoolerConfig,
    assign_levels,
    multilevel_roi_align,
    multilevel_roi_align_plain,
    roi_align_backward,
    roi_align_backward_rmw,
    window_layout,
)
from maskrcnn_tpu_torch.ops.matcher import match_anchors_batched, match_anchors_plain
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
@pytest.mark.parametrize("g,n,thresh", [(5, 1000, 0.7), (80, 200, 0.5), (2, 4161, 0.5),
                                         (40, 2000, 0.7)])
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


def _anchor_problem(cuda, b=8, g=100):
    """The flagship's anchors at 800x1344 (268,569) and gt with a validity
    hole, an image without gt, gt rows past the last valid one, and a small
    gt on the anchor grid (its best IoU below 0.3 is tied by anchors)."""
    gen = AnchorGenerator((32, 64, 128, 256, 512), (0.5, 1.0, 2.0), (4, 8, 16, 32, 64))
    anchors = torch.cat([gen.grid_anchors_level(l, -(-800 // s), -(-1344 // s), cuda)
                         for l, s in enumerate((4, 8, 16, 32, 64))])
    assert anchors.shape[0] == 268569
    rs = np.random.RandomState(0)
    gt = _boxes(rs, (b, g), 0, 1300, 8, 500)
    n_valid = np.clip(rs.lognormal(1.7, 0.8, b), 1, g).astype(int)
    valid = np.arange(g)[None, :] < n_valid[:, None]
    valid[0, 1] = False                         # hole inside the valid prefix
    valid[1] = False                            # no gt at all
    valid[2, :] = True                          # every row valid
    gt[3, 0] = [100, 100, 107, 107]             # tiny: best IoU < 0.3, tied
    gt[3, 1] = [-10.0, -10.0, 2000.0, 2000.0]   # covers the whole image
    return anchors, torch.from_numpy(gt).to(cuda), torch.from_numpy(valid).to(cuda)


@pytest.mark.gpu
def test_matcher_kernel_matches_plain_at_flagship_anchors(cuda):
    anchors, gt, valid = _anchor_problem(cuda)
    before = match_anchors_batched.launches
    got = match_anchors_batched(anchors, gt, valid, 0.7, 0.3)
    torch.cuda.synchronize()
    assert match_anchors_batched.launches == before + 1
    want = match_anchors_plain(anchors, gt, valid, 0.7, 0.3)
    assert got.dtype == torch.int32 and got.shape == (8, 268569)
    assert torch.equal(got, want)
    assert (got[1] == -1).all()
    assert (got[3] == 0).sum() >= 2  # the tiny gt's tied best anchors restored
    assert (got >= 0).any() and (got == -2).any()


@pytest.mark.gpu
def test_matcher_kernel_rejects_what_it_does_not_take(cuda):
    anchors, gt, valid = _anchor_problem(cuda, b=4, g=4)
    with pytest.raises(TypeError):
        match_anchors_batched(anchors.double(), gt, valid, 0.7, 0.3)
    with pytest.raises(TypeError):
        match_anchors_batched(anchors, gt, valid.int(), 0.7, 0.3)
    big = torch.zeros(1, 5000, 4, device=cuda)
    with pytest.raises(ValueError):
        match_anchors_batched(anchors, big, torch.ones(1, 5000, dtype=torch.bool, device=cuda),
                              0.7, 0.3)


def _edge_rois(cuda, r, b=2):
    boxes, bidx = _rois(cuda, r, b)
    # ROIs reaching the last row/column of P2 (200 x 336 at stride 4): the
    # samples snap to the edge and both corners of an axis are one cell
    boxes[2:6] = torch.tensor([[1300, 780, 1343.9, 799.9], [0, 790, 40, 812],
                               [1330, 0, 1350, 30], [1335.5, 795.5, 1344, 800]], device=cuda)
    return boxes, bidx


@pytest.mark.gpu
@pytest.mark.parametrize("p,r", [(7, 1000), (14, 200)])
def test_roi_align_backward_matches_plain_autograd(cuda, p, r):
    boxes, bidx = _edge_rois(cuda, r)
    pcfg = PoolerConfig(p, SCALES, 2)
    g = torch.Generator().manual_seed(p)
    dout = torch.randn(r, p, p, 256, generator=g).to(cuda)

    plain_feats = [f.detach().requires_grad_() for f in _pyramid(cuda, torch.float32)]
    (multilevel_roi_align_plain(plain_feats, boxes, bidx, pcfg) * dout).sum().backward()
    want = [f.grad for f in plain_feats]
    scale = max(w.abs().max().item() for w in want)
    assert scale > 0

    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        feats = [f.detach().requires_grad_() for f in _pyramid(cuda, dtype)]
        before = roi_align_backward.launches
        out = multilevel_roi_align(feats, boxes, bidx, pcfg)
        out.backward(dout.to(dtype))
        torch.cuda.synchronize()
        assert roi_align_backward.launches == before + 1
        for f, w in zip(feats, want):
            assert f.grad.dtype == dtype and f.grad.shape == w.shape
            err = (f.grad.float() - w).abs().max().item()
            assert err <= tol * scale, (dtype, err, scale)


@pytest.mark.gpu
def test_roi_align_backward_rejects_what_it_does_not_take(cuda):
    boxes, bidx = _rois(cuda, 4)
    pcfg = PoolerConfig(7, SCALES, 2)
    lvl = torch.zeros(4, dtype=torch.int32, device=cuda)
    shapes = [(2, 200 >> i, 336 >> i, 256) for i in range(4)]
    with pytest.raises(TypeError):
        roi_align_backward(torch.zeros(4, 7, 7, 256, dtype=torch.float16, device=cuda),
                           shapes, boxes, bidx, lvl, pcfg)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rmw", "chunk"])
@pytest.mark.parametrize("p,r", [(7, 1000), (14, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_backward_matches_plain_autograd(cuda, monkeypatch, kind, p, r, dtype):
    """Edge ROIs, one oversize ROI (a long thin box at P2, scattered
    exactly), and a third image that no ROI pools from."""
    monkeypatch.setenv("MASKRCNN_POOLER_BWD_P%d" % p, kind)
    boxes, bidx = _edge_rois(cuda, r, b=2)
    boxes[6] = torch.tensor([10.0, 40.0, 1300.0, 60.0], device=cuda)
    pcfg = PoolerConfig(p, SCALES, 2)
    lay = window_layout([(3, 200 >> i, 336 >> i, 256) for i in range(4)], boxes, bidx,
                        assign_levels(boxes, pcfg), pcfg)
    assert bool(lay["oversize"][6]) and int(lay["oversize"].sum()) >= 1
    g = torch.Generator().manual_seed(p)
    dout = torch.randn(r, p, p, 256, generator=g).to(cuda)

    plain_feats = [f.detach().requires_grad_() for f in _pyramid(cuda, torch.float32, b=3)]
    (multilevel_roi_align_plain(plain_feats, boxes, bidx, pcfg) * dout).sum().backward()
    want = [f.grad for f in plain_feats]
    scale = max(w.abs().max().item() for w in want)

    feats = [f.detach().requires_grad_() for f in _pyramid(cuda, dtype, b=3)]
    before = {k: fn.launches for k, fn in BACKWARD_KERNELS.items()}
    multilevel_roi_align(feats, boxes, bidx, pcfg).backward(dout.to(dtype))
    torch.cuda.synchronize()
    after = {k: fn.launches for k, fn in BACKWARD_KERNELS.items()}
    assert after == {k: v + (k == kind) for k, v in before.items()}
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for f, w in zip(feats, want):
        assert f.grad.dtype == dtype and f.grad.shape == w.shape
        assert not f.grad[2].any()
        err = (f.grad.float() - w).abs().max().item()
        assert err <= tol * scale, (kind, dtype, err, scale)


@pytest.mark.gpu
def test_window_backward_rejects_what_it_does_not_take(cuda):
    boxes, bidx = _rois(cuda, 4)
    lvl = torch.zeros(4, dtype=torch.int32, device=cuda)
    shapes = [(2, 200 >> i, 336 >> i, 256) for i in range(4)]
    with pytest.raises(ValueError):
        roi_align_backward_rmw(torch.zeros(4, 40, 40, 256, device=cuda), shapes, boxes, bidx,
                               lvl, PoolerConfig(40, SCALES, 2))
