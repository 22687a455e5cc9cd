"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the flagship's training step read through utils/profiling.py there.

Every test here is marked ``gpu`` and skips on a machine without a CUDA
device. The file imports neither JAX nor the JAX package, so it also runs
where only PyTorch is installed:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

Tolerances: NMS keep-masks and matcher outputs exact; ROIAlign in float32
atol 1e-5 (the kernel and the plain version round the same products and
sums, in another order for the S x S mean); in bfloat16 at most
1e-2 * max|x| (the plain version rounds every step in bfloat16, the kernel
accumulates in float32). The ROIAlign backwards against autograd through
the plain version: float32 within 1e-5 * max|grad| (the tile sums of all
three backwards run in another order than the per-sample adds), bfloat16
against the float32 plain gradient within 1e-2 * max|grad| (one rounding of
each sum to bfloat16). All three sum in a fixed order: two calls are
bitwise equal.
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
    window_kernel_inputs,
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


def _nms_edge_lanes(rs, n):
    """Lanes of n boxes for the blocked walk's edges: a dense lane (rows of
    later blocks already removed by earlier ones), a lane with no valid box,
    a lane of one box repeated (one kept), a lane whose only valid boxes sit
    past the first block, a lane where every box is valid, and pairs at
    exactly IoU 0.5 and 0.7 (not suppressed: the test is IoU > threshold)."""
    boxes = _boxes(rs, (5, n), 0, 300, 4, 200)
    scores = np.round(rs.uniform(size=(5, n)) * 16) / 16  # ties: order by position
    valid = rs.uniform(size=(5, n)) > 0.1
    valid[1] = False
    boxes[2] = [10, 20, 110, 90]
    scores[2] = 0.5  # all equal: the first one is kept
    valid[2] = True
    valid[3, :min(n, 70)] = False
    valid[4] = True
    if n >= 4:  # [0,0,9,9] vs [0,0,9,19]: 100 / 200; vs [0,0,9,6]: 70 / 100
        boxes[0, :4] = [[0, 0, 9, 9], [0, 0, 9, 19], [100, 100, 109, 109], [100, 100, 109, 106]]
        scores[0, :4] = [2.0, 1.9, 1.8, 1.7]
        valid[0, :4] = True
    return boxes, scores.astype(np.float32), valid


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 63, 64, 65, 200, 2049, 8192])
@pytest.mark.parametrize("thresh", [0.5, 0.7])
def test_nms_kernel_blocked_edges(cuda, n, thresh):
    rs = np.random.RandomState(n)
    boxes, scores, valid = (torch.from_numpy(x).to(cuda) for x in _nms_edge_lanes(rs, n))
    got = batched_nms(boxes, scores, valid, thresh)
    again = batched_nms(boxes, scores, valid, thresh)
    torch.cuda.synchronize()
    want = batched_nms_plain(boxes, scores, valid, thresh)
    assert torch.equal(got, want) and torch.equal(again, got)
    assert not got[1].any() and int(got[2].sum()) == 1 and bool(got[2, 0])
    if n >= 4:
        # IoU exactly at the threshold does not suppress; 0.7 > 0.5 does
        assert got[0, :4].tolist() == [True, True, True, thresh >= 0.7]


@pytest.mark.gpu
def test_nms_kernel_on_transposed_inputs(cuda):
    """Boxes, scores and validity as strided views (the box head's scores
    are a transpose): the kernel's sorted inputs must still be contiguous."""
    rs = np.random.RandomState(9)
    boxes = torch.from_numpy(_boxes(rs, (200, 80))).to(cuda).transpose(0, 1)
    scores = torch.from_numpy(rs.uniform(size=(200, 80)).astype(np.float32)).to(cuda).t()
    valid = torch.from_numpy(rs.uniform(size=(200, 80)) > 0.1).to(cuda).t()
    assert not scores.is_contiguous() and not boxes.is_contiguous()
    got = batched_nms(boxes, scores, valid, 0.5)
    torch.cuda.synchronize()
    want = batched_nms_plain(boxes.contiguous(), scores.contiguous(), valid.contiguous(), 0.5)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8193, 12000, 12288])
def test_nms_kernel_takes_lanes_above_8192_boxes(cuda, n):
    """Lanes past 128 words: the C4 training lanes (12000 boxes) and the
    cap, 12288 (192 words), in the reduce launch of six owned words a lane;
    12289 boxes raise."""
    rs = np.random.RandomState(n)
    g = 3
    boxes = torch.from_numpy(_boxes(rs, (g, n), 0, 1300, 4, 400)).to(cuda)
    scores = torch.from_numpy(np.round(rs.uniform(size=(g, n)) * 4096) / 4096).float().to(cuda)
    valid = torch.from_numpy(rs.uniform(size=(g, n)) > 0.05).to(cuda)
    valid[1, : n // 2] = False  # a lane whose first valid box sits past 64 blocks
    got = batched_nms(boxes, scores, valid, 0.7)
    want = batched_nms_plain(boxes, scores, valid, 0.7)
    assert torch.equal(got, want)
    assert int(got.sum()) > 1000 and not got[~valid].any()
    with pytest.raises(ValueError, match="at most 12288"):
        batched_nms(boxes[:1, :1].expand(1, 12289, 4).contiguous(),
                    torch.zeros(1, 12289, device=cuda),
                    torch.ones(1, 12289, dtype=torch.bool, device=cuda), 0.7)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_kernel_matches_plain(cuda, dtype, p, r):
    feats = _pyramid(cuda, dtype)
    boxes, bidx = _rois(cuda, r)
    pcfg = PoolerConfig(p, SCALES, 2)
    before = multilevel_roi_align.launches
    got = multilevel_roi_align(feats, boxes, bidx, pcfg)
    torch.cuda.synchronize()
    assert multilevel_roi_align.launches == before + 1
    want = multilevel_roi_align_plain(feats, boxes, bidx, pcfg)
    assert got.dtype == dtype and got.shape == want.shape == (r, p, p, 256)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
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
def test_matcher_kernel_at_1024_gt_and_ties_across_blocks(cuda):
    """1024 gt slots with validity holes and the last slot valid; one anchor
    copied into many tiles of 256, so a gt's best is tied in several blocks;
    an image without valid gt."""
    rs = np.random.RandomState(5)
    n, g = 40000, 1024
    anchors = _boxes(rs, (n,), 0, 1300, 8, 400)
    anchors[::997] = [2000, 2000, 2060, 2050]  # the same anchor in ~40 tiles
    gt = _boxes(rs, (3, g), 0, 1300, 8, 500)
    valid = rs.uniform(size=(3, g)) > 0.5
    valid[:, -1] = True
    gt[0, 7] = [1900, 1900, 2300, 2300]  # met by the copies only, IoU ~0.02
    valid[0, 7] = True
    valid[2] = False
    anchors, gt, valid = (torch.from_numpy(x).to(cuda) for x in (anchors, gt, valid))
    got = match_anchors_batched(anchors, gt, valid, 0.7, 0.3)
    torch.cuda.synchronize()
    want = match_anchors_plain(anchors, gt, valid, 0.7, 0.3)
    assert torch.equal(got, want)
    assert (got[0, ::997] == 7).all() and (got[2] == -1).all()


@pytest.mark.gpu
def test_matcher_kernel_with_more_anchor_tiles_than_resident_blocks(cuda):
    """2,000,000 anchors: more tiles of 256 than blocks the card holds at
    once, so each block walks several tiles in both passes."""
    rs = np.random.RandomState(6)
    anchors = torch.from_numpy(_boxes(rs, (2000000,), 0, 1300, 8, 400)).to(cuda)
    gt = torch.from_numpy(_boxes(rs, (2, 12), 0, 1300, 16, 500)).to(cuda)
    valid = torch.ones(2, 12, dtype=torch.bool, device=cuda)
    valid[1, 5:] = False
    got = match_anchors_batched(anchors, gt, valid, 0.7, 0.3)
    torch.cuda.synchronize()
    assert torch.equal(got, match_anchors_plain(anchors, gt, valid, 0.7, 0.3))


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


def _plain_grad(cuda, boxes, bidx, pcfg, dout, b=2):
    feats = [f.detach().requires_grad_() for f in _pyramid(cuda, torch.float32, b=b)]
    (multilevel_roi_align_plain(feats, boxes, bidx, pcfg) * dout).sum().backward()
    return [f.grad for f in feats]


@pytest.mark.gpu
@pytest.mark.parametrize("p,r", [(7, 1000), (14, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_matches_plain_autograd(cuda, dtype, p, r):
    boxes, bidx = _edge_rois(cuda, r)
    pcfg = PoolerConfig(p, SCALES, 2)
    g = torch.Generator().manual_seed(p)
    dout = torch.randn(r, p, p, 256, generator=g).to(cuda)
    want = _plain_grad(cuda, boxes, bidx, pcfg, dout)
    scale = max(w.abs().max().item() for w in want)
    assert scale > 0

    tol = 1e-5 if dtype == torch.float32 else 1e-2
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


def _roi_backward(cuda, dout, boxes, bidx, pcfg, b=2):
    shapes = [(b, 200 >> i, 336 >> i, dout.shape[-1]) for i in range(4)]
    lvl = assign_levels(boxes, pcfg)
    return roi_align_backward(dout, shapes, boxes, bidx.int(), lvl, pcfg)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_is_deterministic(cuda, dtype):
    boxes, bidx = _edge_rois(cuda, 1000)
    pcfg = PoolerConfig(7, SCALES, 2)
    dout = torch.randn(1000, 7, 7, 256, generator=torch.Generator().manual_seed(3)).to(cuda, dtype)
    first = _roi_backward(cuda, dout, boxes, bidx, pcfg)
    second = _roi_backward(cuda, dout, boxes, bidx, pcfg)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert any(a.any() for a in first)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_without_rois_is_zero(cuda, dtype):
    pcfg = PoolerConfig(14, SCALES, 2)
    boxes = torch.zeros(0, 4, device=cuda)
    bidx = torch.zeros(0, dtype=torch.int32, device=cuda)
    grads = _roi_backward(cuda, torch.zeros(0, 14, 14, 256, dtype=dtype, device=cuda), boxes,
                          bidx, pcfg)
    assert [tuple(g.shape) for g in grads] == [(2, 200 >> i, 336 >> i, 256) for i in range(4)]
    assert all(g.dtype == dtype and not g.any() for g in grads)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("p", [7, 14])
def test_roi_align_kernels_on_rois_beyond_the_map_and_degenerate(cuda, p):
    """ROIs wholly or partly outside the 800 x 1344 image, degenerate and
    zero-width ROIs, ROIs in [-1, 0) and snapped at the far edges; the third
    image gets no ROI."""
    boxes = torch.tensor([
        [-3, -2, 30, 25], [1300, 780, 1343.9, 799.9], [1320, 790, 1400, 820],
        [1330, 10, 1500, 60], [1400, 820, 1500, 900], [-400, -400, -300, -300],
        [100, 100, 100, 100], [50, 60, 50, 90], [0, 0, 1343, 799], [-50, 700, 60, 900],
    ], device=cuda)
    bidx = torch.tensor([0, 1, 0, 1, 0, 1, 0, 1, 0, 1], dtype=torch.int32, device=cuda)
    pcfg = PoolerConfig(p, SCALES, 2)
    f32 = [f.detach().requires_grad_() for f in _pyramid(cuda, torch.float32, b=3)]
    got = multilevel_roi_align(f32, boxes, bidx, pcfg)
    want = multilevel_roi_align_plain(f32, boxes, bidx, pcfg)
    assert (got - want).abs().max().item() <= 1e-5
    dout = torch.randn(got.shape, generator=torch.Generator().manual_seed(p)).to(cuda)
    got.backward(dout)
    plain = _plain_grad(cuda, boxes, bidx, pcfg, dout, b=3)
    scale = max(w.abs().max().item() for w in plain)
    for f, w in zip(f32, plain):
        assert not f.grad[2].any()
        assert (f.grad - w).abs().max().item() <= 1e-5 * scale


@pytest.mark.gpu
def test_roi_align_kernels_refuse_unaligned_buffers_and_c_not_multiple_of_8(cuda):
    boxes, bidx = _rois(cuda, 4)
    pcfg = PoolerConfig(7, SCALES, 2)
    lvl = assign_levels(boxes, pcfg)
    odd = _pyramid(cuda, torch.float32, c=12, h=32, w=32)
    with pytest.raises(ValueError):
        multilevel_roi_align(odd, boxes, bidx, pcfg)
    shapes = [(2, 32 >> i, 32 >> i, 12) for i in range(4)]
    with pytest.raises(ValueError):
        roi_align_backward(torch.zeros(4, 7, 7, 12, device=cuda), shapes, boxes, bidx, lvl, pcfg)

    def shifted(shape):  # contiguous, 4 bytes past a 16-byte boundary
        return torch.zeros(int(np.prod(shape)) + 1, device=cuda)[1:].view(shape)

    feats = _pyramid(cuda, torch.float32, c=8, h=32, w=32)
    feats[1] = shifted(feats[1].shape)
    with pytest.raises(ValueError):
        multilevel_roi_align(feats, boxes, bidx, pcfg)
    shapes = [(2, 32 >> i, 32 >> i, 8) for i in range(4)]
    with pytest.raises(ValueError):
        roi_align_backward(shifted((4, 7, 7, 8)), shapes, boxes, bidx, lvl, pcfg)


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


def _window_backward(cuda, kind, dout, boxes, bidx, pcfg, b=2):
    shapes = [(b, 200 >> i, 336 >> i, dout.shape[-1]) for i in range(4)]
    lvl = assign_levels(boxes, pcfg)
    return BACKWARD_KERNELS[kind](dout, shapes, boxes, bidx.int(), lvl, pcfg)


def _check_window_backward(cuda, kind, dout, boxes, bidx, pcfg, tol=1e-5):
    """The kernel of `kind` against autograd through the plain float32
    version, within tol * max|grad|; returns the kernel's gradients."""
    got = _window_backward(cuda, kind, dout, boxes, bidx, pcfg)
    torch.cuda.synchronize()
    want = _plain_grad(cuda, boxes, bidx, pcfg, dout.float())
    scale = max(w.abs().max().item() for w in want)
    assert scale > 0
    for g, w in zip(got, want):
        assert g.dtype == dout.dtype and g.shape == w.shape
        err = (g.float() - w).abs().max().item()
        assert err <= tol * scale, (kind, err, scale)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rmw", "chunk"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_backward_is_deterministic(cuda, kind, dtype):
    boxes, bidx = _edge_rois(cuda, 1000)
    boxes[6] = torch.tensor([10.0, 40.0, 1300.0, 60.0], device=cuda)  # oversize
    pcfg = PoolerConfig(7, SCALES, 2)
    dout = torch.randn(1000, 7, 7, 256, generator=torch.Generator().manual_seed(3)).to(cuda, dtype)
    first = _window_backward(cuda, kind, dout, boxes, bidx, pcfg)
    second = _window_backward(cuda, kind, dout, boxes, bidx, pcfg)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert any(a.any() for a in first)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rmw", "chunk"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_backward_without_rois_is_zero(cuda, kind, dtype):
    pcfg = PoolerConfig(14, SCALES, 2)
    boxes = torch.zeros(0, 4, device=cuda)
    bidx = torch.zeros(0, dtype=torch.int32, device=cuda)
    grads = _window_backward(cuda, kind, torch.zeros(0, 14, 14, 256, dtype=dtype, device=cuda),
                             boxes, bidx, pcfg)
    assert [tuple(g.shape) for g in grads] == [(2, 200 >> i, 336 >> i, 256) for i in range(4)]
    assert all(g.dtype == dtype and not g.any() for g in grads)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rmw", "chunk"])
@pytest.mark.parametrize("p", [7, 14])
def test_window_backward_when_every_roi_is_oversize(cuda, kind, p):
    """Long thin boxes that stay at P2 and reach beyond their 48-cell
    window: the index lists no window row, and the tiles add them all from
    the oversize lists."""
    rs = np.random.RandomState(p)
    r = 64
    y = rs.uniform(0, 780, r)
    x = rs.uniform(0, 300, r)
    boxes = np.stack([x, y, x + rs.uniform(400, 1000, r), y + rs.uniform(4, 12, r)], 1)
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(cuda)
    bidx = torch.from_numpy(rs.randint(0, 2, r).astype(np.int32)).to(cuda)
    pcfg = PoolerConfig(p, SCALES, 2)
    shapes = [(2, 200 >> i, 336 >> i, 256) for i in range(4)]
    idx = window_kernel_inputs(kind, shapes, boxes, bidx, assign_levels(boxes, pcfg), pcfg)
    assert bool(idx["oversize"].all()) and not (idx["roi"] >= 0).any()
    dout = torch.randn(r, p, p, 256, generator=torch.Generator().manual_seed(p)).to(cuda)
    _check_window_backward(cuda, kind, dout, boxes, bidx, pcfg)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rmw", "chunk"])
def test_window_backward_on_a_tile_met_by_300_rois(cuda, kind):
    """300 small ROIs of one image around one point of P2, as the training
    box head's positives cluster on a small gt box (up to 176 ROIs a tile
    there), with 200 others spread over the map."""
    rs = np.random.RandomState(11)
    ctr = np.array([412.0, 300.0]) + rs.uniform(-6, 6, (300, 2))
    wh = rs.uniform(20, 44, (300, 2))
    crowd = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1)
    boxes = np.concatenate([crowd, _boxes(rs, (200,), 0, 1300, 8, 300)]).astype(np.float32)
    boxes = torch.from_numpy(boxes).to(cuda)
    bidx = torch.from_numpy(np.r_[np.zeros(300), rs.randint(0, 2, 200)].astype(np.int32)).to(cuda)
    pcfg = PoolerConfig(7, SCALES, 2)
    lvl = assign_levels(boxes, pcfg)
    assert bool((lvl[:300] == 0).all())
    # the tile of P2 holding the crowd's centre (cell 103, 75) meets them all
    foot = torch.stack([boxes[:300, 1] / 4, boxes[:300, 3] / 4, boxes[:300, 0] / 4,
                        boxes[:300, 2] / 4], 1)
    assert bool(((foot[:, 0] <= 79) & (foot[:, 1] >= 72) & (foot[:, 2] <= 103)
                 & (foot[:, 3] >= 96)).all())
    g = torch.Generator().manual_seed(5)
    dout = torch.randn(500, 7, 7, 256, generator=g).to(cuda)
    _check_window_backward(cuda, kind, dout, boxes, bidx, pcfg)
    _check_window_backward(cuda, kind, dout.bfloat16(), boxes, bidx, pcfg, tol=1e-2)


@pytest.mark.gpu
def test_chunk_backward_sums_a_crowded_tiles_pure_chunks_on_the_tensor_cores(cuda):
    """300 ROIs of one window's neighbourhood: their pure chunks reach the
    tile blocks many at a time, and in bf16 "chunk" adds them on the tensor
    cores (operands rounded to bf16) where "rmw" adds each on the CUDA
    cores: both hold the plain gradient, and they differ in the last bits
    only there (P2; the other levels get no ROI)."""
    rs = np.random.RandomState(12)
    ctr = np.array([412.0, 300.0]) + rs.uniform(-6, 6, (300, 2))
    wh = rs.uniform(20, 44, (300, 2))
    boxes = torch.from_numpy(np.concatenate([ctr - wh / 2, ctr + wh / 2], 1)
                             .astype(np.float32)).to(cuda)
    bidx = torch.zeros(300, dtype=torch.int32, device=cuda)
    pcfg = PoolerConfig(7, SCALES, 2)
    shapes = [(2, 200 >> i, 336 >> i, 256) for i in range(4)]
    idx = window_kernel_inputs("chunk", shapes, boxes, bidx, assign_levels(boxes, pcfg), pcfg)
    assert int(idx["chunks"]["pure"].sum()) >= 8
    dout = torch.randn(300, 7, 7, 256, generator=torch.Generator().manual_seed(6)).to(cuda)
    got = _check_window_backward(cuda, "chunk", dout.bfloat16(), boxes, bidx, pcfg, tol=1e-2)
    ref = _check_window_backward(cuda, "rmw", dout.bfloat16(), boxes, bidx, pcfg, tol=1e-2)
    assert not torch.equal(got[0], ref[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1:], ref[1:]))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["roi", "rmw", "chunk"])
def test_roi_align_backwards_on_transposed_dout(cuda, kind):
    """A gradient that reaches the backward as a strided view: the wrapper
    makes it contiguous for the kernel's 16-byte loads."""
    boxes, bidx = _edge_rois(cuda, 300)
    pcfg = PoolerConfig(7, SCALES, 2)
    dout = torch.randn(300, 256, 7, 7, generator=torch.Generator().manual_seed(8)).to(cuda)
    dout = dout.permute(0, 2, 3, 1)
    assert not dout.is_contiguous()
    _check_window_backward(cuda, kind, dout, boxes, bidx, pcfg)


# The kernels at the shapes each of two ranks gives them at the flagship's
# global training batch of 8 (4 images of 800x1344 a rank): RPN NMS over 20
# lanes of 2000, the matcher on 4 x 268,569 anchors, the box head's 2048
# ROIs at P=7 and the mask head's rows at P=14 (256 would be a per-rank cap;
# the global batch's cap leaves each rank 4 x 128 = 512 rows).

@pytest.mark.gpu
def test_nms_kernel_at_a_ranks_training_lanes(cuda):
    rs = np.random.RandomState(20)
    boxes = torch.from_numpy(_boxes(rs, (20, 2000))).to(cuda)
    scores = torch.from_numpy(rs.uniform(size=(20, 2000))).float().to(cuda)
    valid = torch.from_numpy(rs.uniform(size=(20, 2000)) > 0.05).to(cuda)
    assert torch.equal(batched_nms(boxes, scores, valid, 0.7),
                       batched_nms_plain(boxes, scores, valid, 0.7))


@pytest.mark.gpu
def test_matcher_kernel_at_a_ranks_four_images(cuda):
    anchors, gt, valid = _anchor_problem(cuda, b=4)
    got = match_anchors_batched(anchors, gt, valid, 0.7, 0.3)
    assert got.shape == (4, 268569)
    assert torch.equal(got, match_anchors_plain(anchors, gt, valid, 0.7, 0.3))


@pytest.mark.gpu
@pytest.mark.parametrize("p,r", [(7, 2048), (14, 256), (14, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_forward_and_backward_at_a_ranks_rois(cuda, dtype, p, r):
    boxes, bidx = _edge_rois(cuda, r, b=4)
    pcfg = PoolerConfig(p, SCALES, 2)
    feats = [f.detach().requires_grad_() for f in _pyramid(cuda, dtype, b=4)]
    got = multilevel_roi_align(feats, boxes, bidx, pcfg)
    want = multilevel_roi_align_plain(feats, boxes, bidx, pcfg)
    assert got.shape == (r, p, p, 256)
    scale = max(f.abs().max().item() for f in feats)
    tol = 1e-5 if dtype == torch.float32 else 1e-2 * scale
    assert (got.float() - want.float()).abs().max().item() <= tol

    dout = torch.randn(r, p, p, 256, generator=torch.Generator().manual_seed(r)).to(cuda)
    grads = _plain_grad(cuda, boxes, bidx, pcfg, dout, b=4)
    gscale = max(g.abs().max().item() for g in grads)
    before = roi_align_backward.launches
    got.backward(dout.to(dtype))
    assert roi_align_backward.launches == before + 1
    gtol = 1e-5 if dtype == torch.float32 else 1e-2
    for f, w in zip(feats, grads):
        assert (f.grad.float() - w).abs().max().item() <= gtol * gscale


# the phase ranges of the flagship's training step: the JAX package's named
# scopes (image_prep holds no operation for a float batch, but its range is
# recorded all the same)
TRAIN_PHASES = {"image_prep", "backbone", "stem", "layer1", "layer2", "layer3", "layer4", "fpn",
                "rpn_head", "rpn_loss", "proposals", "box_targets", "box_head", "box_loss",
                "mask_head", "mask_targets", "optimizer"}


@pytest.mark.gpu
def test_flagship_profiled_step_fits_its_wall_time_and_records_every_phase(cuda, monkeypatch):
    """The flagship's training step at batch 2 under torch.profiler: the
    device busy time (the ranges' own device spans left out) within the
    wall time, every phase range recorded, and the phase table adding up
    to the device time linked to an op, within 2% of the busy time (the
    profiler links a few of the hand kernels' launches to no op)."""
    from maskrcnn_tpu_torch.tools import profile_train
    from maskrcnn_tpu_torch.utils import profiling

    monkeypatch.delenv("MASKRCNN_TPU_PROFILE_CONFIG", raising=False)
    step, _, batch = profile_train.build_step(2, cuda)
    step(batch)
    prof, wall_ms = profiling.timed(step, batch, 1, cuda)
    busy_ms, _ = profiling.device_busy(prof, 1)
    assert 0 < busy_ms <= wall_ms
    assert TRAIN_PHASES <= profiling.range_names(prof)
    reading = profiling.phase_breakdown(prof, 1, cuda)
    assert reading["linked_ms"] == pytest.approx(sum(reading["phases"].values()))
    assert 0.98 * busy_ms <= reading["linked_ms"] <= busy_ms * 1.0001
