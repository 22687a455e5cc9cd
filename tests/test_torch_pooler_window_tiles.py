"""The decomposition of the port's "rmw" and "chunk" ROIAlign backwards,
against the gather pooler and the JAX package.

The CUDA kernels (csrc/roi_align.cu, roi_align_bwd_tile_kernel walking the
window index) own 8 x 8 cell tiles of the gradient as the "roi" backward's
blocks do, but take each tile's ROIs from the window index that
``window_kernel_inputs`` builds from the TPU kernels' window sort: the rows
of the 6 x 6 windows whose origin can reach the tile, then the (level,
image)'s oversize ROIs. Held here, float32, on level sides that are not
multiples of the tile, levels narrower than a 48-cell window and origins
clipped at the far edges:
  * the index lists each window's ROIs exactly as ``window_layout`` sorts
    them, and every ROI whose samples touch a tile is among that tile's
    candidates;
  * ``window_tile_gradient``, the kernels' decomposition in plain PyTorch,
    equals autograd through the gather pooler within 1e-5 * max|grad|
    (sums in another order), with oversize ROIs, impure chunks and padding
    rows, and when every ROI is oversize;
  * it equals ``jax.grad`` of the TPU "rmw" and "chunk" backwards in
    interpret mode within 1e-5 * max|grad| (float32; no ROI there is
    oversize, which the TPU kernels clamp).
The kernels themselves are held against the plain gradient on the card by
tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tpu.models.poolers import PoolerConfig as JaxPoolerConfig
from maskrcnn_tpu.ops.pallas.roi_align_kernel import make_trainable_roi_align
from maskrcnn_tpu_torch.models import poolers
from maskrcnn_tpu_torch.models.poolers import PoolerConfig
from test_torch_pooler_tiles import SCALES, SHAPES, _problem
from test_torch_pooler_windows import _problem as _jax_problem

# long thin boxes that stay at a fine level and reach beyond their window,
# one past the map's edge
OVERSIZE = [[10, 40, 600, 52], [100, 20, 112, 390], [300, 10, 318, 700]]


def _boxes(p, case):
    boxes, bidx, dout = _problem(p)
    if case == "all_oversize":
        boxes = torch.tensor(OVERSIZE * 4, dtype=torch.float32)
        bidx = torch.tensor([0, 1, 1] * 4, dtype=torch.int32)
        dout = dout[:12]
    elif case == "with_oversize":
        boxes = torch.cat([boxes, torch.tensor(OVERSIZE, dtype=torch.float32)])
        bidx = torch.cat([bidx, torch.tensor([0, 1, 1], dtype=torch.int32)])
        dout = torch.cat([dout, dout[:3] * -0.5])
    return boxes, bidx, dout


def _plain_gradient(boxes, bidx, pcfg, dout):
    leaves = [torch.zeros(s, requires_grad=True) for s in SHAPES]
    out = poolers.multilevel_roi_align_plain(leaves, boxes, bidx, pcfg)
    return torch.autograd.grad(out, leaves, dout)


def _candidates(idx, l, b, ty, tx):
    """The ROIs the kernel's block of tile (l, b, ty, tx) tests, in order."""
    nb = SHAPES[0][0]
    base = sum(nb * -(-h // 8) * -(-w // 8) for _, h, w, _ in SHAPES[:l])
    ty_n, tx_n = -(-SHAPES[l][1] // 8), -(-SHAPES[l][2] // 8)
    first, end, roi = idx["first"].tolist(), idx["end"].tolist(), idx["roi"].tolist()
    out = []
    for wy in range(max(ty - poolers.SPAN + 1, 0), ty + 1):
        for wx in range(max(tx - poolers.SPAN + 1, 0), tx + 1):
            key = base + (b * ty_n + wy) * tx_n + wx
            out += [r for r, _ in map(poolers.row_roi, roi[first[key]:end[key]]) if r >= 0]
    seg = idx["over_seg"].tolist()
    return out + idx["over_order"].tolist()[seg[l * nb + b]:seg[l * nb + b + 1]]


@pytest.mark.parametrize("p", [7, 14])
@pytest.mark.parametrize("kind", ["rmw", "chunk"])
def test_window_index_lists_the_layout_and_covers_every_touched_tile(kind, p):
    boxes, bidx, _ = _boxes(p, "with_oversize")
    pcfg = PoolerConfig(p, SCALES, 2)
    lvl = poolers.assign_levels(boxes, pcfg)
    idx = poolers.window_kernel_inputs(kind, SHAPES, boxes, bidx, lvl, pcfg)
    lay = poolers.window_layout(SHAPES, boxes, bidx, lvl, pcfg)
    assert torch.equal(idx["oversize"], lay["oversize"]) and int(lay["oversize"].sum()) >= 3
    assert all(t.dtype == torch.int32 for k, t in idx.items()
               if k in ("roi", "first", "end", "over_order", "over_seg"))

    # each window's rows hold the ROIs the layout gives it that fit it, in
    # sorted order; the oversize ROIs are listed apart, once
    r = boxes.shape[0]
    windows = {}
    for i in range(r):
        roi = int(lay["perm"][i])
        key = tuple(int(lay[k][i]) for k in ("lvl", "b", "y0", "x0"))
        windows.setdefault(key, [])
        if not lay["oversize"][roi]:
            windows[key].append(roi)
    nb = SHAPES[0][0]
    for (l, b, y0, x0), rois in windows.items():
        assert y0 % 8 == 0 and x0 % 8 == 0
        base = sum(nb * -(-h // 8) * -(-w // 8) for _, h, w, _ in SHAPES[:l])
        key = base + (b * -(-SHAPES[l][1] // 8) + y0 // 8) * -(-SHAPES[l][2] // 8) + x0 // 8
        rows = idx["roi"][int(idx["first"][key]):int(idx["end"][key])].tolist()
        assert [poolers.row_roi(v)[0] for v in rows if v >= 0] == rois
    assert sum(v >= 0 for v in idx["roi"].tolist()) == r - int(lay["oversize"].sum())
    # "chunk" flags the rows of its pure chunks, "rmw" none
    pure = idx["chunks"]["pure"].tolist() if kind == "chunk" else None
    assert [poolers.row_roi(v)[1] for v in idx["roi"].tolist()] == \
        [v >= 0 and kind == "chunk" and bool(pure[j // poolers.CHUNK])
         for j, v in enumerate(idx["roi"].tolist())]
    assert sorted(idx["over_order"][:int(idx["over_seg"][-1])].tolist()) == \
        torch.nonzero(lay["oversize"]).flatten().tolist()

    # the cells every ROI's samples touch (the gather's corners): each such
    # tile lists the ROI among its candidates
    index, weight, outside = poolers.sample_corners([s[:3] for s in SHAPES], boxes, bidx, pcfg)
    offsets = np.cumsum([0] + [b * h * w for b, h, w, _ in SHAPES])[:-1]
    touched = set()
    for k in range(4):
        live = (weight[k] != 0) & ~outside
        for roi, i in zip(torch.nonzero(live)[:, 0].tolist(), index[k][live].tolist()):
            l = int(lvl[roi])
            _, h, w, _ = SHAPES[l]
            b, cell = divmod(i - int(offsets[l]), h * w)
            touched.add((l, b, cell // w // 8, cell % w // 8, roi))
    for l, b, ty, tx, roi in touched:
        assert roi in _candidates(idx, l, b, ty, tx), (l, b, ty, tx, roi)

    # the problem has windows on levels narrower than a window, and origins
    # clipped at the far edge (the window starts before the ROI's first cell)
    narrow = [l for l, (_, h, w, _) in enumerate(SHAPES) if min(h, w) < poolers.PATCH]
    assert any(key[0] in narrow for key in windows)
    ys, _ = poolers._sample_coords(boxes, lvl.long(), pcfg)
    first_cell = torch.floor(ys.amin(dim=1).clamp(min=0)).long() // 8 * 8
    assert (lay["y0"][:r] < first_cell[lay["perm"]]).any()


@pytest.mark.parametrize("case", ["with_oversize", "all_oversize"])
@pytest.mark.parametrize("p", [7, 14])
@pytest.mark.parametrize("kind", ["rmw", "chunk"])
def test_window_tile_gradient_equals_gather_gradient(kind, p, case):
    boxes, bidx, dout = _boxes(p, case)
    pcfg = PoolerConfig(p, SCALES, 2)
    idx = poolers.window_kernel_inputs(kind, SHAPES, boxes, bidx,
                                       poolers.assign_levels(boxes, pcfg), pcfg)
    if case == "all_oversize":
        assert bool(idx["oversize"].all()) and not (idx["roi"] >= 0).any()
    elif kind == "chunk":  # pure and impure chunks, and padding rows
        ch = idx["chunks"]
        assert (ch["pure"] == 1).any() and (ch["pure"] == 0).any() and not ch["real"].all()
        assert bool((idx["roi"] == -1).any())
    got = poolers.window_tile_gradient(kind, SHAPES, boxes, bidx, pcfg, dout)
    want = _plain_gradient(boxes, bidx, pcfg, dout)
    scale = max(w.abs().max().item() for w in want)
    assert scale > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("kind", ["rmw", "chunk"])
def test_window_tile_gradient_equals_jax_window_backward(kind):
    """The problem of tests/test_pallas_roi_align.py:165-196 (C = 128)."""
    shapes, boxes, bidx, p = _jax_problem("setup")
    assert shapes == [(2, 64 >> i, 80 >> i, 128) for i in range(4)]
    cot = np.random.RandomState(1).randn(len(boxes), p, p, 128).astype(np.float32)
    fn = make_trainable_roi_align(JaxPoolerConfig(p, SCALES, 2), compute_dtype=jnp.float32,
                                  bwd_impl=kind, interpret=True)
    want = jax.grad(lambda fs: (fn(tuple(fs), jnp.asarray(boxes), jnp.asarray(bidx))
                                * cot).sum())([jnp.zeros(s, jnp.float32) for s in shapes])
    pcfg = PoolerConfig(p, SCALES, 2)
    tb, ti = torch.from_numpy(boxes), torch.from_numpy(bidx)
    assert not poolers.window_kernel_inputs(kind, shapes, tb, ti, poolers.assign_levels(tb, pcfg),
                                            pcfg)["oversize"].any()
    got = poolers.window_tile_gradient(kind, shapes, tb, ti, pcfg, torch.from_numpy(cot))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-5 * scale


@pytest.mark.parametrize("kind", ["rmw", "chunk"])
def test_window_index_without_rois(kind):
    pcfg = PoolerConfig(14, SCALES, 2)
    boxes, bidx = torch.zeros(0, 4), torch.zeros(0, dtype=torch.int32)
    idx = poolers.window_kernel_inputs(kind, SHAPES, boxes, bidx, torch.zeros(0, dtype=torch.int32),
                                       pcfg)
    ntiles = sum(b * -(-h // 8) * -(-w // 8) for b, h, w, _ in SHAPES)
    assert idx["first"].shape == idx["end"].shape == (ntiles,)
    assert (idx["end"] <= idx["first"]).all() and idx["roi"].numel() == 0
    assert idx["over_seg"].tolist() == [0] * (len(SHAPES) * SHAPES[0][0] + 1)
    grads = poolers.window_tile_gradient(kind, SHAPES, boxes, bidx, pcfg,
                                         torch.zeros(0, 14, 14, SHAPES[0][3]))
    assert [tuple(g.shape) for g in grads] == SHAPES and not any(g.any() for g in grads)
