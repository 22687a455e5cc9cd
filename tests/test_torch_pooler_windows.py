"""The window layout of the port's "rmw" and "chunk" ROIAlign backwards, and
the backward selection, against the JAX package.

  * ``window_layout`` equals ``_precompute`` of the TPU kernel on ROIs that
    fit their window: perm, rnew, rwid, lvl, b, y0 and x0 exactly, the
    weights to 1e-6; ``chunk_layout`` equals ``_chunk_layout`` exactly
    (row sources, window starts, pure flags).
  * The window form the TPU kernels compute from that layout (per sorted
    row, RowW^T . dOut . ColW added into its window; oversize ROIs exactly,
    as the port gives them), written out here in plain PyTorch, equals the
    gradient of the exact gather pooler to 1e-5 * max|grad| (float32, sums
    in another order), oversize ROIs and level edges included.
  * The plain gradient (autograd through the gather pooler, what the port
    runs on CPU tensors) equals ``jax.grad`` of the TPU "rmw" and "chunk"
    backwards in interpret mode to 1e-5 * max|grad|.
The port's kernels take their ROIs from the window index instead
(tests/test_torch_pooler_window_tiles.py); on the card they are held
against the plain gradient by tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tpu.models.poolers import PoolerConfig as JaxPoolerConfig
from maskrcnn_tpu.ops.pallas.roi_align_kernel import (
    _chunk_layout,
    _precompute,
    make_trainable_roi_align,
)
from maskrcnn_tpu_torch.models import poolers
from maskrcnn_tpu_torch.models.poolers import PoolerConfig

SCALES = (0.25, 0.125, 0.0625, 0.03125)


def _problem(name):
    """(level shapes, boxes, image indices, P): the TPU kernel's gradient
    test problem (tests/test_pallas_roi_align.py:_setup, C = 128), or level
    maps whose sides are not multiples of 8 with ROIs at their edges."""
    if name == "setup":
        rs = np.random.RandomState(0)
        shapes = [(2, 64 >> i, 80 >> i, 128) for i in range(4)]
        for s in shapes:
            rs.randn(*s)  # keep the RandomState sequence of _setup
        ctr = rs.uniform(20, 220, (24, 2))
        wh = rs.uniform(10, 120, (24, 2))
        boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
        return shapes, boxes, rs.randint(0, 2, 24).astype(np.int32), 7
    rs = np.random.RandomState(5)
    shapes = [(2, 101, 170, 16), (2, 51, 85, 16), (2, 26, 43, 16), (2, 13, 22, 16)]
    ctr = rs.uniform(0, 400, (37, 2)) * [1.7, 1.0]
    wh = rs.uniform(8, 150, (37, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    boxes[:4] = [[600, 330, 679, 403], [640, 380, 679, 403], [0, 390, 50, 403],
                 [650, 0, 679, 30]]
    return shapes, boxes, rs.randint(0, 2, 37).astype(np.int32), 14


def _torch_layout(shapes, boxes, bidx, p):
    pcfg = PoolerConfig(p, SCALES, 2)
    tb, ti = torch.from_numpy(boxes), torch.from_numpy(bidx)
    return poolers.window_layout(shapes, tb, ti, poolers.assign_levels(tb, pcfg), pcfg)


def _jax_layout(shapes, boxes, bidx, p):
    feats = [jnp.zeros(s, jnp.float32) for s in shapes]
    return _precompute(feats, jnp.asarray(boxes), jnp.asarray(bidx),
                       JaxPoolerConfig(p, SCALES, 2))


@pytest.mark.parametrize("name", ["setup", "edges"])
def test_window_layout_matches_jax_precompute(name):
    shapes, boxes, bidx, p = _problem(name)
    got = _torch_layout(shapes, boxes, bidx, p)
    want = _jax_layout(shapes, boxes, bidx, p)
    assert not got["oversize"].any()
    assert got["rp"] == want["rnew"].shape[0]
    np.testing.assert_array_equal(got["perm"].numpy(), np.asarray(want["perm"]))
    for k in ("rnew", "rwid", "lvl", "b", "y0", "x0"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("roww", "colw"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["setup", "edges"])
def test_chunk_layout_matches_jax(name):
    shapes, boxes, bidx, p = _problem(name)
    lay = _torch_layout(shapes, boxes, bidx, p)
    got = poolers.chunk_layout(lay)
    dout = jnp.zeros((boxes.shape[0], p, p, shapes[0][3]), jnp.float32)
    want = _chunk_layout(_jax_layout(shapes, boxes, bidx, p), poolers.CHUNK, dout)
    assert got["n"] == want["s_total"]
    src = got["src"]
    np.testing.assert_array_equal(got["rnew"].numpy(), np.asarray(want["rnew"]))
    np.testing.assert_array_equal(got["pure"].numpy(), np.asarray(want["pure"]))
    for k in ("rwid", "lvl", "b", "y0", "x0"):
        np.testing.assert_array_equal(lay[k][src].numpy(), np.asarray(want[k]), err_msg=k)
    real = got["real"][:, None, None].float()
    np.testing.assert_array_equal((lay["roww"][src] * real).numpy(), np.asarray(want["roww"]))
    assert got["pure"].sum() > 0 and (got["pure"] == 0).sum() > 0


def _window_form_gradient(kind, shapes, boxes, bidx, pcfg, dout):
    """What the TPU "rmw" / "chunk" kernels compute from the layout, in plain
    PyTorch: every sorted row they visit (each in turn, or by chunk rows)
    adds RowW^T . dOut . ColW into its window, clipped to the level; the
    oversize ROIs get their exact gradient (here autograd through the
    gather pooler)."""
    lvl = poolers.assign_levels(boxes, pcfg)
    lay = poolers.window_layout(shapes, boxes, bidx, lvl, pcfg)
    r = boxes.shape[0]
    if kind == "rmw":
        visited = range(lay["rp"])
    else:
        ch = poolers.chunk_layout(lay)
        visited = [int(i) for i, real in zip(ch["src"], ch["real"]) if real]
        assert sorted(visited) == list(range(lay["rp"]))
    grads = [torch.zeros(s) for s in shapes]
    for i in visited:
        if i >= r or lay["oversize"][lay["perm"][i]]:
            continue
        roi = int(lay["perm"][i])
        l, b, y0, x0 = (int(lay[k][i]) for k in ("lvl", "b", "y0", "x0"))
        t = torch.einsum("pqc,qx->pxc", dout[roi], lay["colw"][i])
        patch = torch.einsum("py,pxc->yxc", lay["roww"][i], t)
        h, w = shapes[l][1], shapes[l][2]
        ye, xe = min(y0 + poolers.PATCH, h), min(x0 + poolers.PATCH, w)
        grads[l][b, y0:ye, x0:xe] += patch[: ye - y0, : xe - x0]
        assert not patch[ye - y0:].any() and not patch[:, xe - x0:].any()
    over = lay["oversize"]
    if over.any():
        leaves = [torch.zeros(s, requires_grad=True) for s in shapes]
        out = poolers.multilevel_roi_align_plain(leaves, boxes[over], bidx[over], pcfg)
        for g, e in zip(grads, torch.autograd.grad(out, leaves, dout[over])):
            g += e
    return grads, lay


def _plain_gradient(shapes, boxes, bidx, pcfg, dout):
    leaves = [torch.zeros(s, requires_grad=True) for s in shapes]
    out = poolers.multilevel_roi_align_plain(leaves, boxes, bidx, pcfg)
    return torch.autograd.grad(out, leaves, dout)


@pytest.mark.parametrize("kind", ["rmw", "chunk"])
def test_window_form_with_oversize_rois_equals_gather_gradient(kind):
    shapes, boxes, bidx, p = _problem("edges")
    # oversize: longer than the window at the level FPN gives them (a long
    # thin box stays at a fine level), one reaching past the map's edge
    boxes = np.concatenate([boxes, np.array(
        [[10, 40, 600, 52], [100, 20, 112, 390], [300, 10, 318, 700]], np.float32)])
    bidx = np.concatenate([bidx, np.array([0, 1, 1], np.int32)])
    pcfg = PoolerConfig(p, SCALES, 2)
    tb, ti = torch.from_numpy(boxes), torch.from_numpy(bidx)
    dout = torch.from_numpy(np.random.RandomState(3).randn(len(boxes), p, p, 16)
                            .astype(np.float32))
    got, lay = _window_form_gradient(kind, shapes, tb, ti, pcfg, dout)
    assert lay["oversize"][-3:].tolist() == [True, True, True]
    assert not lay["oversize"][:-3].any()
    want = _plain_gradient(shapes, tb, ti, pcfg, dout)
    scale = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("kind", ["rmw", "chunk"])
def test_plain_gradient_matches_jax_window_backward(kind, monkeypatch):
    """The problem of tests/test_pallas_roi_align.py:165-196 (C = 128):
    autograd through the port's pooler on CPU tensors, with the variable
    naming the backward, against jax.grad of the TPU kernel it names."""
    shapes, boxes, bidx, p = _problem("setup")
    rs = np.random.RandomState(0)
    feats = [rs.randn(*s).astype(np.float32) for s in shapes]
    cot = np.random.RandomState(1).randn(len(boxes), p, p, 128).astype(np.float32)
    fn = make_trainable_roi_align(JaxPoolerConfig(p, SCALES, 2), compute_dtype=jnp.float32,
                                  bwd_impl=kind, interpret=True)
    want = jax.grad(lambda fs: (fn(tuple(fs), jnp.asarray(boxes), jnp.asarray(bidx))
                                * cot).sum())([jnp.asarray(f) for f in feats])
    monkeypatch.setenv("MASKRCNN_POOLER_BWD", kind)
    leaves = [torch.from_numpy(f).requires_grad_() for f in feats]
    out = poolers.multilevel_roi_align(leaves, torch.from_numpy(boxes), torch.from_numpy(bidx),
                                       PoolerConfig(p, SCALES, 2))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-5 * scale


def test_backward_choice_on_cpu_tensors(monkeypatch):
    shapes, boxes, bidx, p = _problem("edges")
    pcfg = PoolerConfig(p, SCALES, 2)
    tb, ti = torch.from_numpy(boxes), torch.from_numpy(bidx)
    dout = torch.from_numpy(np.random.RandomState(4).randn(len(boxes), p, p, 16)
                            .astype(np.float32))
    want = _plain_gradient(shapes, tb, ti, pcfg, dout)
    # the same computation; the CPU's scatter-add sums in a thread-dependent order
    tol = 1e-6 * max(w.abs().max().item() for w in want)

    def gradient():
        leaves = [torch.zeros(s, requires_grad=True) for s in shapes]
        return torch.autograd.grad(poolers.multilevel_roi_align(leaves, tb, ti, pcfg), leaves,
                                   dout)

    monkeypatch.delenv("MASKRCNN_POOLER_BWD", raising=False)
    monkeypatch.delenv("MASKRCNN_POOLER_BWD_P14", raising=False)
    assert poolers.backward_choice(pcfg) == "roi"
    for kind in poolers.BACKWARDS:
        monkeypatch.setenv("MASKRCNN_POOLER_BWD", kind)
        assert poolers.backward_choice(pcfg) == kind
        for g, w in zip(gradient(), want):
            assert (g - w).abs().max().item() <= tol
    # the per-size variable wins; only this pooler's size reads it
    monkeypatch.setenv("MASKRCNN_POOLER_BWD_P14", "chunk")
    monkeypatch.setenv("MASKRCNN_POOLER_BWD", "rmw")
    assert poolers.backward_choice(pcfg) == "chunk"
    assert poolers.backward_choice(PoolerConfig(7, SCALES, 2)) == "rmw"
    for bad in ("scatter", "RMW", ""):
        monkeypatch.setenv("MASKRCNN_POOLER_BWD_P14", bad)
        with pytest.raises(ValueError):
            gradient()
