"""The decomposition of the port's "roi" ROIAlign backward, against the gather
pooler and the JAX package.

The CUDA kernel (csrc/roi_align.cu, roi_align_bwd_tile_kernel) owns 8 x 8
cell tiles of the gradient; each tile sums RowW^T . dOut . ColW over the
ROIs whose footprint meets it, with RowW / ColW built from the ROI's
separable sample axes. Its plain-PyTorch counterparts in models/poolers.py
are held here, float32, on level sides that are not multiples of the tile,
with samples in [-1, 0), samples snapped to the last row and column,
samples outside the map and degenerate boxes:
  * ``sample_axes``, as an outer product, equals ``sample_corners``' indices,
    weights and outside flags exactly (the same roundings);
  * every non-zero (ROI, cell) pair of the gather's corners lies in a tile
    whose ``tile_lists`` entry lists the ROI;
  * ``roi_tile_inputs`` groups the ROIs by (level, image) in index order, as
    the tile lists do;
  * ``tile_owner_gradient`` equals autograd through the gather pooler and
    ``jax.grad`` of the JAX gather pooler within 1e-5 * max|grad| (sums in
    another order);
  * so it does on the adaptive grid (POOLER_SAMPLING_RATIO 0: each ROI's own
    samples a bin, their weights 1/n folded into RowW / ColW, as the
    kernel's adaptive instance folds them), against autograd through
    ``adaptive_roi_align`` and the JAX adaptive pooler, on a C4-like level
    of 21 x 37 cells at stride 16 and on the pyramid.
The kernel itself is held against the plain gradient on the card by
tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tpu.models.poolers import PoolerConfig as JaxPoolerConfig
from maskrcnn_tpu.models.poolers import multilevel_roi_align as jax_roi_align
from maskrcnn_tpu_torch.models import poolers
from maskrcnn_tpu_torch.models.poolers import PoolerConfig

SCALES = (0.25, 0.125, 0.0625, 0.03125)
# an image of 404 x 680: level sides that are not multiples of 8
SHAPES = [(2, 101, 170, 16), (2, 51, 85, 16), (2, 26, 43, 16), (2, 13, 22, 16)]
EDGE_BOXES = [
    [-3, -2, 30, 25],          # first samples in [-1, 0) on P2: clamped to row/column 0
    [640, 380, 679, 403],      # last samples in (H - 1, H]: snapped to the last row/column
    [600, 395, 640, 410],      # lower samples beyond H: outside
    [660, 10, 720, 60],        # straddles the right edge
    [700, 420, 760, 470],      # wholly beyond the map
    [-400, -400, -300, -300],  # wholly before it
    [100, 100, 100, 100],      # degenerate: roi_w = roi_h = 1
    [50, 60, 50, 90],          # zero width
    [0, 0, 600, 400],          # large: a coarse level
]


def _problem(p, r=40, seed=0):
    rs = np.random.RandomState(seed + p)
    ctr = rs.uniform(-20, 700, (r, 2)) * [1.0, 0.6]
    wh = rs.uniform(2, 300, (r, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    boxes[:len(EDGE_BOXES)] = EDGE_BOXES
    bidx = rs.randint(0, 2, r).astype(np.int32)
    dout = rs.randn(r, p, p, SHAPES[0][3]).astype(np.float32)
    return torch.from_numpy(boxes), torch.from_numpy(bidx), torch.from_numpy(dout)


def _levels(boxes, pcfg):
    return poolers.assign_levels(boxes, pcfg)


@pytest.mark.parametrize("p", [7, 14])
def test_sample_axes_outer_product_equals_sample_corners(p):
    boxes, bidx, _ = _problem(p)
    pcfg = PoolerConfig(p, SCALES, 2)
    lvl = _levels(boxes, pcfg).long()
    index, weight, outside = poolers.sample_corners([s[:3] for s in SHAPES], boxes, bidx, pcfg)
    rows, cols = poolers.sample_axes(SHAPES, boxes, lvl, pcfg)

    offsets = np.cumsum([0] + [b * h * w for b, h, w, _ in SHAPES])[:-1]
    hw = torch.tensor([[h, w] for _, h, w, _ in SHAPES])[lvl]
    base = (torch.from_numpy(offsets)[lvl] + bidx.long() * hw[:, 0] * hw[:, 1])[:, None, None]
    w_l = hw[:, 1][:, None, None]
    corners = [(rows["lo"], cols["lo"], rows["wlo"], cols["wlo"]),
               (rows["lo"], cols["hi"], rows["wlo"], cols["whi"]),
               (rows["hi"], cols["lo"], rows["whi"], cols["wlo"]),
               (rows["hi"], cols["hi"], rows["whi"], cols["whi"])]
    for k, (ry, cx, wy, wx) in enumerate(corners):
        assert torch.equal(index[k], base + ry[:, :, None] * w_l + cx[:, None, :])
        assert torch.equal(weight[k], wy[:, :, None] * wx[:, None, :])
    assert torch.equal(outside, ~(rows["valid"][:, :, None] & cols["valid"][:, None, :]))

    # the problem reaches every edge rule on both axes
    ys, _ = poolers._sample_coords(boxes, lvl, pcfg)
    h_r = hw[:, 0][:, None].float()
    assert ((ys >= -1) & (ys < 0)).any()
    assert (rows["valid"] & (rows["lo"] == rows["hi"])).any()
    assert (ys > h_r).any() and (ys < -1).any()


@pytest.mark.parametrize("p", [7, 14])
def test_tile_lists_cover_gather_corners(p):
    boxes, bidx, _ = _problem(p)
    pcfg = PoolerConfig(p, SCALES, 2)
    lvl = _levels(boxes, pcfg)
    index, weight, outside = poolers.sample_corners([s[:3] for s in SHAPES], boxes, bidx, pcfg)
    lists = poolers.tile_lists(SHAPES, boxes, bidx, lvl, pcfg)
    listed = {(key, r) for key, rois in lists.items() for r in rois}

    offsets = np.cumsum([0] + [b * h * w for b, h, w, _ in SHAPES])[:-1]
    touched = set()
    for k in range(4):
        live = (weight[k] != 0) & ~outside
        rr = torch.nonzero(live)[:, 0]
        for r, i in zip(rr.tolist(), index[k][live].tolist()):
            l = int(lvl[r])
            _, h, w, _ = SHAPES[l]
            b, cell = divmod(i - int(offsets[l]), h * w)
            touched.add(((l, b, cell // w // poolers.TILE, cell % w // poolers.TILE), r))
    assert touched and touched <= listed
    # a superset, but not a loose one: a footprint's margin adds at most a
    # ring of tiles around the ones the samples touch
    assert len(listed) <= 4 * len(touched)


@pytest.mark.parametrize("r", [40, 0])
def test_roi_tile_inputs_group_rois_as_tile_lists(r):
    boxes, bidx, _ = _problem(7, r=max(r, len(EDGE_BOXES)))
    boxes, bidx = boxes[:r], bidx[:r]
    pcfg = PoolerConfig(7, SCALES, 2)
    lvl = _levels(boxes, pcfg)
    got = poolers.roi_tile_inputs(SHAPES, bidx, lvl)
    order, seg = got["order"].long(), got["seg"].long()
    assert got["order"].dtype == got["seg"].dtype == torch.int32
    nb = SHAPES[0][0]
    assert seg.shape == (len(SHAPES) * nb + 1,) and int(seg[-1]) == r
    for key, rois in poolers.tile_lists(SHAPES, boxes, bidx, lvl, pcfg).items():
        s = key[0] * nb + key[1]
        segment = order[seg[s]:seg[s + 1]].tolist()
        assert segment == sorted(segment)
        assert [i for i in segment if i in rois] == rois
    for s in range(len(SHAPES) * nb):
        for i in order[seg[s]:seg[s + 1]].tolist():
            assert int(lvl[i]) * nb + int(bidx[i]) == s


@pytest.mark.parametrize("p", [7, 14])
def test_tile_owner_gradient_equals_gather_and_jax_gradients(p):
    boxes, bidx, dout = _problem(p)
    pcfg = PoolerConfig(p, SCALES, 2)
    got = poolers.tile_owner_gradient(SHAPES, boxes, bidx, pcfg, dout)

    leaves = [torch.zeros(s, requires_grad=True) for s in SHAPES]
    out = poolers.multilevel_roi_align_plain(leaves, boxes, bidx, pcfg)
    want = torch.autograd.grad(out, leaves, dout)
    scale = max(w.abs().max().item() for w in want)
    assert scale > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= 1e-5 * scale

    jpcfg = JaxPoolerConfig(p, SCALES, 2)
    jb, ji, jd = jnp.asarray(boxes.numpy()), jnp.asarray(bidx.numpy()), jnp.asarray(dout.numpy())
    jgrad = jax.grad(lambda fs: (jax_roi_align(fs, jb, ji, jpcfg, compute_dtype=jnp.float32,
                                               backend="gather") * jd).sum())(
        [jnp.zeros(s, jnp.float32) for s in SHAPES])
    for g, w in zip(got, jgrad):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-5 * scale


# a C4-like level at stride 16 (an image of 336 x 592: sides that are not
# multiples of the tile), the adaptive grid's cap min(8, max(ceil(H / P),
# ceil(W / P), 1)): 6 at P=7, 3 at P=14
C4_SHAPES = [(2, 21, 37, 16)]
C4_SCALES = (1 / 16,)
C4_EDGE_BOXES = [
    [0, 0, 591, 335],          # the whole image: the cap's samples on the long axis
    [100, 100, 104, 103],      # under a cell: roi_w = roi_h = 1, one sample a bin
    [200, 150, 200, 150],      # degenerate
    [-40, -30, 120, 90],       # partly before the map: samples in [-1, 0) and outside
    [500, 300, 700, 400],      # partly beyond it: snapped to the last row and column
    [560, 10, 591, 330],       # tall and narrow: many samples down, one across
]


def _c4_problem(p, shapes, r=24, seed=0):
    rs = np.random.RandomState(seed + p)
    _, h, w, c = shapes[0]
    hw = np.array([592.0, 336.0]) if len(shapes) == 1 else np.array([680.0, 404.0])
    ctr = rs.uniform(0, 1, (r, 2)) * hw
    wh = rs.uniform(4, 400, (r, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    boxes = np.clip(boxes, 0, np.concatenate([hw, hw]) - 1).astype(np.float32)
    boxes[:len(C4_EDGE_BOXES)] = C4_EDGE_BOXES
    bidx = rs.randint(0, shapes[0][0], r).astype(np.int32)
    dout = rs.randn(r, p, p, c).astype(np.float32)
    return torch.from_numpy(boxes), torch.from_numpy(bidx), torch.from_numpy(dout)


@pytest.mark.parametrize("p,shapes,scales", [(7, C4_SHAPES, C4_SCALES),
                                             (14, C4_SHAPES, C4_SCALES),
                                             (7, SHAPES, SCALES)],
                         ids=["c4_p7", "c4_p14", "pyramid_p7"])
def test_adaptive_tile_owner_gradient_equals_gather_and_jax_gradients(p, shapes, scales):
    boxes, bidx, dout = _c4_problem(p, shapes)
    pcfg = PoolerConfig(p, scales, 0)
    s = poolers.adaptive_cap(pcfg, shapes)
    assert s == (min(8, -(-37 // p)) if len(shapes) == 1 else 8)
    # the problem reaches one sample a bin and the cap, on both axes
    lvl = poolers.assign_levels(boxes, pcfg) if len(shapes) > 1 else \
        torch.zeros(boxes.shape[0], dtype=torch.int32)
    _, wy, _, wx = poolers._adaptive_axes(boxes, lvl, pcfg, s)
    for wt in (wy, wx):
        n = (wt.reshape(-1, p, s) > 0).sum(-1)
        assert (n == 1).any() and (n > 1).any()
    assert ((wx.reshape(-1, p, s) > 0).sum(-1) == s).any() or len(shapes) > 1

    got = poolers.tile_owner_gradient(shapes, boxes, bidx, pcfg, dout)
    leaves = [torch.zeros(sh, requires_grad=True) for sh in shapes]
    out = poolers.adaptive_roi_align(leaves, boxes, bidx, pcfg)
    want = torch.autograd.grad(out, leaves, dout)
    scale = max(w.abs().max().item() for w in want)
    assert scale > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= 1e-5 * scale

    jpcfg = JaxPoolerConfig(p, scales, 0)
    jb, ji, jd = jnp.asarray(boxes.numpy()), jnp.asarray(bidx.numpy()), jnp.asarray(dout.numpy())
    jgrad = jax.grad(lambda fs: (jax_roi_align(fs, jb, ji, jpcfg, compute_dtype=jnp.float32,
                                               backend="gather") * jd).sum())(
        [jnp.zeros(sh, jnp.float32) for sh in shapes])
    for g, w in zip(got, jgrad):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-5 * scale
