"""The group norm kernels (csrc/group_norm.cu) against group_norm_plain at
the GN training cell's shapes, and their times.

Run from the root of a checkout, with one CUDA card visible:

    python3 -m maskrcnn_tpu_torch.tools.profile_group_norm [--no-times]

For each shape of SHAPES (the distinct group norms of the GN Mask R-CNN
R-50-FPN Xconv1fc step at batch 16 of 800x1344, and a C4-style res5 ROI
batch) and each dtype it prints one JSON line: the path each direction
takes ("sample" or "spans"), the errors against group_norm_plain (forward
at the same dtype, as the largest difference over max|y|'s bf16 ulp or
absolute in float32; dx, dscale and dbias against autograd of the plain
version in float32 on the same values, over max|grad|), whether two calls
gave the same bits, and (unless --no-times) by CUDA events over 20 calls the wrapper's
and the kernels' ms forward and backward, their bound (x read and y
written once; x and dy read and dx written once; at 3.35 TB/s), the plain
version's forward and backward ms and F.group_norm's forward ms on the same
channels_last tensor as a yardstick (the port never calls it). Exits 1
where an error is past its tolerance or a repeat differs.
"""

import argparse
import json
import math
import sys

import torch
import torch.nn.functional as F

from ..models import layers
from ..ops import native
from ..utils.profiling import device_line

GROUPS = 32
# name -> (N, C, H, W): batch 16 of 800x1344 (the stem at 400x672; res2 to
# res5 and P2-P6 at strides 4-64), the Xconv box head's 8192 ROIs at 7x7,
# the mask head's 1024 positives at 14x14, a C4 res5 head's ROIs
SHAPES = {
    "stem": (16, 64, 400, 672),
    "res2_mid": (16, 64, 200, 336),
    "res2_out": (16, 256, 200, 336),
    "res5_mid": (16, 512, 25, 42),
    "res5_out": (16, 2048, 25, 42),
    "fpn_p2": (16, 256, 200, 336),
    "fpn_p6": (16, 256, 13, 21),
    "box_rois": (8192, 256, 7, 7),
    "mask_rois": (1024, 256, 14, 14),
    "c4_rois": (4096, 2048, 7, 7),
}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
PEAK_BYTES_S = 3.35e12
FWD_TOL = {torch.float32: 1e-5}  # bf16: one ulp of max|y|
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
ITERS = 20


def bf16_ulp(v):
    """The spacing of bfloat16 numbers at magnitude v."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def inputs(shape, dtype, seed=0):
    """x (offset from 0, so the variance is a two-pass one), scale, bias and
    dy on the card, x and dy channels_last in dtype."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]

    def maps(offset, spread):
        t = torch.randn(shape, generator=gen, device="cuda") * spread + offset
        return t.to(dtype).contiguous(memory_format=torch.channels_last)

    x = maps(0.5, 2.0)
    scale = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
    return x, scale, bias, maps(0.0, 1.0)


def _grads(fn, x, scale, bias, dy):
    xr, sr, br = (t.detach().requires_grad_() for t in (x, scale, bias))
    y = fn(xr, sr, br, GROUPS)
    return (y.detach(), *torch.autograd.grad(y, (xr, sr, br), dy))


def check(shape, dtype, seed=0):
    """The kernels against group_norm_plain at one shape: errors, repeats,
    paths and the launch counters' moves."""
    x, scale, bias, dy = inputs(shape, dtype, seed)
    before = (layers.group_norm.launches, layers.group_norm.bwd_launches)
    got = _grads(layers.group_norm, x, scale, bias, dy)
    again = _grads(layers.group_norm, x, scale, bias, dy)
    moved = (layers.group_norm.launches - before[0], layers.group_norm.bwd_launches - before[1])
    with torch.no_grad():
        y_plain = layers.group_norm_plain(x, scale, bias, GROUPS)
    ref = _grads(layers.group_norm_plain, x.float(), scale, bias, dy.float())
    y_max = y_plain.float().abs().max().item()
    y_err = (got[0].float() - y_plain.float()).abs().max().item()
    fwd_scale = 1.0 if dtype == torch.float32 else bf16_ulp(y_max)
    grad_err, grad_abs_err = {}, {}
    for name, a, b in zip(("dx", "dscale", "dbias"), got[1:], ref[1:]):
        grad_abs_err[name] = (a.float() - b).abs().max().item()
        grad_err[name] = grad_abs_err[name] / b.abs().max().item()
    out = {
        "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
        "path": {"forward": layers.group_norm_path(x, GROUPS)[0],
                 "backward": layers.group_norm_path(x, GROUPS, backward=True)[0]},
        "forward_err": y_err / fwd_scale,
        "forward_abs_err": y_err,
        "forward_tol": FWD_TOL.get(dtype, 1.0),
        "grad_err": grad_err, "grad_abs_err": grad_abs_err, "grad_tol": GRAD_TOL[dtype],
        "repeat_equal": all(torch.equal(a, b) for a, b in zip(got, again)),
        "launches": list(moved),
        "y_channels_last": got[0].is_contiguous(memory_format=torch.channels_last),
    }
    out["ok"] = (out["forward_err"] <= out["forward_tol"] and out["repeat_equal"]
                 and max(grad_err.values()) <= out["grad_tol"] and moved == (2, 2)
                 and out["y_channels_last"])
    return out


def _events_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def times(shape, dtype, iters=ITERS, seed=0):
    """ms a call (CUDA events): the wrapper and the kernels alone, forward
    and backward; the bound; the plain version, forward and backward;
    F.group_norm's forward."""
    x, scale, bias, dy = inputs(shape, dtype, seed)
    n, c, h, w = shape
    lib = layers._gn_lib()
    code = layers._GN_DTYPES[dtype]
    stream = torch.cuda.current_stream().cuda_stream
    y = torch.empty_like(x)
    stats = torch.empty((2, n, GROUPS), dtype=torch.float32, device="cuda")
    _, ws_f = layers.group_norm_path(x, GROUPS)
    _, ws_b = layers.group_norm_path(x, GROUPS, backward=True)
    dx = torch.empty_like(x)
    dscale, dbias = torch.empty_like(scale), torch.empty_like(scale)

    def kernel_fwd():
        native.check(lib.group_norm_forward(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), n, h * w, c, GROUPS, 1e-5, code,
            y.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), ws_f.data_ptr(),
            ws_f.numel(), stream), "group_norm")

    def kernel_bwd():
        native.check(lib.group_norm_backward(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), stats[0].data_ptr(),
            stats[1].data_ptr(), n, h * w, c, GROUPS, code, dx.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), ws_b.data_ptr(), ws_b.numel(), stream), "group_norm backward")

    xr, sr, br = (t.detach().requires_grad_() for t in (x, scale, bias))
    out = layers.group_norm(xr, sr, br, GROUPS)
    item = x.element_size()
    res = {
        "kernel_fwd_ms": _events_ms(kernel_fwd, iters),
        "kernel_bwd_ms": _events_ms(kernel_bwd, iters),
        "wrapper_fwd_ms": _events_ms(
            lambda: layers.group_norm(x, scale, bias, GROUPS), iters),
        "wrapper_bwd_ms": _events_ms(
            lambda: torch.autograd.grad(out, (xr, sr, br), dy, retain_graph=True), iters),
        "bound_fwd_ms": 2 * x.numel() * item / PEAK_BYTES_S * 1e3,
        "bound_bwd_ms": 3 * x.numel() * item / PEAK_BYTES_S * 1e3,
    }
    del out, dx, y
    plain_iters = max(2, iters // 5)
    out = layers.group_norm_plain(xr, sr, br, GROUPS)
    res["plain_bwd_ms"] = _events_ms(
        lambda: torch.autograd.grad(out, (xr, sr, br), dy, retain_graph=True), plain_iters)
    del out
    with torch.no_grad():
        res["plain_fwd_ms"] = _events_ms(
            lambda: layers.group_norm_plain(x, scale, bias, GROUPS), plain_iters)
        ws, bs = scale.to(dtype), bias.to(dtype)
        res["library_fwd_ms"] = _events_ms(lambda: F.group_norm(x, GROUPS, ws, bs), iters)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--no-times", action="store_true", help="the checks alone")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_group_norm needs a CUDA card")
    card = device_line("cuda")
    logs = native.build(("group_norm",))
    for line in logs.get("group_norm", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  ptxas: " + line.strip(), flush=True)
    failed = []
    for dname in DTYPES:
        for name in SHAPES:
            got = check(SHAPES[name], DTYPES[dname])
            if not args.no_times:
                got.update(times(SHAPES[name], DTYPES[dname]))
            got.update(name=name, card=card)
            print(json.dumps(got), flush=True)
            if not got["ok"]:
                failed.append("{} {}".format(name, dname))
            torch.cuda.empty_cache()
    if failed:
        print("out of tolerance: " + ", ".join(failed), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
