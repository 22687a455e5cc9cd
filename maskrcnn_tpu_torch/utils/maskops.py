"""Mask utilities: polygon rasterization, the COCO RLE codec, RLE IoU and the
fused paste-and-encode of a detection's mask.

Port of maskrcnn_tpu/utils/maskops.py as that package runs with its native
build (maskrcnn_tpu/utils/_maskops_native.py): ``polygons_to_mask``,
``run_intersection`` and ``paste_encode_mask`` are the same C++ routines,
copied as ``csrc/maskops.cpp``, built by ``ops/native.py`` with the host
compiler at first use and called through ctypes. There is no other path
for them (the JAX package's numpy fallbacks need OpenCV), so a failed build
raises. The rest is numpy.

The RLE string codec is COCO's compressed format exactly (column-major runs,
delta-coded counts from index 3 on, 5-bit groups with a continuation bit,
chars offset by 48), so encoded masks are interchangeable with pycocotools'.
"""

import ctypes

import numpy as np

from ..ops import native

_I64 = ctypes.c_int64


def library():
    """The ctypes handle of the native mask ops, built on first use."""
    lib = native.load("maskops")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.polygons_to_mask.argtypes = [p, p, _I64, _I64, _I64, p]
        lib.polygons_to_mask.restype = None
        lib.run_intersection.argtypes = [p, _I64, p, _I64]
        lib.run_intersection.restype = _I64
        lib.paste_encode_mask.argtypes = [p, _I64, _I64, p, ctypes.c_double, _I64, _I64, p]
        lib.paste_encode_mask.restype = _I64
        lib._typed = True
    return lib


# -- polygon rasterization -----------------------------------------------------


def polygons_to_mask(polygons, height, width):
    """Rasterize flat [x0, y0, x1, y1, ...] polygons (COCO's frPoly: 5x
    supersampled fill with the boundary, max-pooled) to a uint8 [H, W]
    mask; polygons of fewer than 3 points are skipped."""
    height, width = int(height), int(width)
    polys = [np.asarray(p, np.float64).reshape(-1) for p in polygons]
    polys = [p for p in polys if p.size >= 6]
    out = np.zeros(height * width, np.uint8)
    if not polys:
        return out.reshape(height, width)
    coords = np.ascontiguousarray(np.concatenate(polys))
    sizes = np.asarray([p.size for p in polys], np.int64)
    library().polygons_to_mask(coords.ctypes.data, sizes.ctypes.data, len(polys), height,
                               width, out.ctypes.data)
    return out.reshape(height, width)


# -- RLE codec -----------------------------------------------------------------


def mask_to_rle_counts(mask):
    """Dense [H, W] -> uncompressed counts (column-major runs, first run is
    zeros)."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    n = flat.size
    if n == 0:
        return np.zeros(0, np.int64)
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    boundaries = np.concatenate(([0], change, [n]))
    counts = np.diff(boundaries)
    if flat[0] == 1:
        counts = np.concatenate(([0], counts))
    return counts.astype(np.int64)


def rle_counts_to_mask(counts, height, width):
    counts = np.asarray(counts, np.int64)
    flat = np.zeros(height * width, np.uint8)
    pos = np.concatenate(([0], np.cumsum(counts)))
    for i in range(1, len(counts), 2):
        flat[pos[i]:pos[i + 1]] = 1
    return flat.reshape((height, width), order="F")


def rle_counts_to_string(counts):
    """COCO compressed RLE string from counts (maskApi.c rleToString)."""
    out = []
    counts = [int(c) for c in counts]
    for i, c in enumerate(counts):
        x = c
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            out.append(chr(ch + 48))
    return "".join(out)


def rle_string_to_counts(s):
    """Inverse of rle_counts_to_string (maskApi.c rleFrString)."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts = []
    p = 0
    n = len(s)
    while p < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.int64)


def _counts(rle):
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        return rle_string_to_counts(counts)
    return np.asarray(counts, np.int64)


def encode_mask(mask):
    """Dense [H, W] -> COCO RLE dict {'size': [h, w], 'counts': str}."""
    h, w = mask.shape
    return {
        "size": [int(h), int(w)],
        "counts": rle_counts_to_string(mask_to_rle_counts(mask)),
    }


def decode_rle(rle):
    """COCO RLE dict -> dense uint8 [H, W]. Accepts compressed (str/bytes
    counts) or uncompressed (list counts) RLEs."""
    h, w = rle["size"]
    return rle_counts_to_mask(_counts(rle), int(h), int(w))


def rle_area(rle):
    return int(_counts(rle)[1::2].sum())


def run_intersection(a_counts, b_counts):
    """Intersection area of two run-length encodings of one image size."""
    a = np.ascontiguousarray(a_counts, np.int64)
    b = np.ascontiguousarray(b_counts, np.int64)
    return int(library().run_intersection(a.ctypes.data, a.size, b.ctypes.data, b.size))


def rle_iou(dt_rles, gt_rles, iscrowd=None):
    """Pairwise IoU between two lists of RLE dicts. [D, G] float64.

    iscrowd: optional [G] flags; for a crowd gt, IoU = inter / area(dt)
    (COCOeval semantics).
    """
    d, g = len(dt_rles), len(gt_rles)
    out = np.zeros((d, g), np.float64)
    dt_counts = [_counts(r) for r in dt_rles]
    gt_counts = [_counts(r) for r in gt_rles]
    dt_areas = [int(c[1::2].sum()) for c in dt_counts]
    gt_areas = [int(c[1::2].sum()) for c in gt_counts]
    for i in range(d):
        for j in range(g):
            inter = run_intersection(dt_counts[i], gt_counts[j])
            if iscrowd is not None and iscrowd[j]:
                denom = dt_areas[i]
            else:
                denom = dt_areas[i] + gt_areas[j] - inter
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out


def merge_rles(rles):
    """Union-merge a list of RLEs (crowd gt composition)."""
    if len(rles) == 1:
        return rles[0]
    h, w = rles[0]["size"]
    m = np.zeros((h, w), np.uint8)
    for r in rles:
        m |= decode_rle(r)
    return encode_mask(m)


def polygons_to_rle(polygons, height, width):
    return encode_mask(polygons_to_mask(polygons, height, width))


def paste_encode_mask(mask, box, im_h, im_w, thresh=0.5, padding=1):
    """One detection's [M, M] float mask probabilities pasted into its xyxy
    box on an [im_h, im_w] image (the Masker's semantics: zero padding, the
    box expanded by (M + 2 padding) / M, bilinear resize, strict threshold)
    and encoded as a COCO RLE dict, in one native pass without the canvas."""
    mask = np.ascontiguousarray(mask, np.float32)
    box = np.ascontiguousarray(box, np.float64)
    m = mask.shape[-1]
    if mask.shape != (m, m) or box.shape != (4,):
        raise ValueError("paste_encode_mask takes an [M, M] mask and a [4] box, got {} and {}"
                         .format(mask.shape, box.shape))
    im_h, im_w = int(im_h), int(im_w)
    counts = np.empty(im_h * im_w + 2, np.int64)
    nc = library().paste_encode_mask(mask.ctypes.data, m, int(padding), box.ctypes.data,
                                     float(thresh), im_h, im_w, counts.ctypes.data)
    return {"size": [im_h, im_w], "counts": rle_counts_to_string(counts[:nc])}
