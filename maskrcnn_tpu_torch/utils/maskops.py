"""Mask utilities: polygon rasterization, the COCO RLE codec, RLE IoU and the
fused paste-and-encode of a detection's mask.

Port of maskrcnn_tpu/utils/maskops.py as that package runs with its native
build (maskrcnn_tpu/utils/_maskops_native.py): ``polygons_to_mask``,
``run_intersection`` and ``paste_encode_mask`` are the same C++ routines,
copied as ``csrc/maskops.cpp``, built by ``ops/native.py`` with the host
compiler at first use and called through ctypes. There is no other path
for them (the JAX package's numpy fallbacks need OpenCV), so a failed build
raises. ``trace_contours`` (the outer contours of a binary mask, which the
JAX package takes from OpenCV's findContours) is C++ of the port's own in
the same file, with a plain Python twin, ``trace_contours_plain``, that
the tests hold it to. The rest is numpy.

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
        lib.find_external_contours.argtypes = [p, _I64, _I64, p, _I64, p, _I64, p]
        lib.find_external_contours.restype = _I64
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


# -- outer contours ------------------------------------------------------------


def trace_contours(mask):
    """The outer contours of a binary [H, W] mask (nonzero = foreground), as
    OpenCV's findContours(RETR_EXTERNAL, CHAIN_APPROX_TC89_L1) returns them:
    a list of int32 [K, 2] (x, y) arrays, the last contour found first
    (csrc/maskops.cpp:find_external_contours)."""
    m = np.ascontiguousarray(mask)
    if m.dtype != np.uint8:
        m = (m != 0).astype(np.uint8)
    h, w = m.shape
    lib = library()
    point_cap, size_cap = 4 * (h + w) + 64, 64
    n_points = ctypes.c_int64(0)
    while True:
        points = np.empty((point_cap, 2), np.int32)
        sizes = np.empty(size_cap, np.int64)
        n = lib.find_external_contours(m.ctypes.data, h, w, points.ctypes.data, point_cap,
                                       sizes.ctypes.data, size_cap, ctypes.byref(n_points))
        if n <= size_cap and n_points.value <= point_cap:
            break
        point_cap, size_cap = max(point_cap, n_points.value), max(size_cap, n)
    return np.split(points[:n_points.value], np.cumsum(sizes[:n])[:-1]) if n else []


_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_ABS_DIFF = (1, 2, 3, 4, 3, 2, 1, 0, 1, 2, 3, 4, 3, 2, 1)


def _follow_border(img, stride, i0):
    """Suzuki-Abe: follow the outer border starting at flat index i0 of the
    bordered image (a list, row stride `stride`), marking its pixels (-126
    where the right neighbour is background, else 2); its Freeman codes."""
    deltas = [1, 1 - stride, -stride, -stride - 1, -1, stride - 1, stride, stride + 1] * 2
    s_end = s = 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if img[i1] != 0 or s == s_end:
            break
    if s == s_end:  # a single pixel
        img[i0] = -126
        return []
    codes = []
    i3 = i0
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:
            img[i3] = -126
        elif img[i3] == 1:
            img[i3] = 2
        codes.append(s)
        if i4 == i0 and i3 == i1:
            return codes
        i3 = i4
        s = (s + 4) & 7


def _tc89_l1(codes, origin):
    """The Teh-Chin L1 reduction of a closed chain of Freeman codes from
    `origin`: the kept (x, y) points. The passes of OpenCV's approx.cpp over
    a linked list (indices into the chain; `head` stands before the first).
    OpenCV 5 rewrote the last pass, and its output differs from the older
    code's in three places, kept here: a couple's first point is really
    removed; when the list starts at the chain's first point, a run there
    keeps its second point as well; when only the chain's first and last
    points survive around the start, the first stays at the front as well
    as being copied to the end."""
    n = len(codes)
    if n == 0:
        return [origin]
    nil, head = -1, n + 1
    pts, s, k, nxt = [None] * (n + 2), [0] * (n + 2), [0] * (n + 2), [nil] * (n + 2)
    x, y = origin
    prev, cur = codes[-1], head
    for i, c in enumerate(codes):  # pass 0: the 1-curvature of each point
        s[i] = _ABS_DIFF[c - prev + 7]
        if s[i] != 0:
            nxt[cur] = cur = i
        pts[i] = (x, y)
        x, y, prev = x + _DX[c], y + _DY[c], c
    nxt[cur] = nil
    cur = nxt[head]
    while cur != nil:  # pass 1: the support region of each point
        (x0, y0), l, d_num, kk = pts[cur], 0, 0, 1
        while True:
            a, b = pts[(cur - kk) % n], pts[(cur + kk) % n]
            dx, dy = b[0] - a[0], b[1] - a[1]
            lk = dx * dx + dy * dy
            dk_num = (x0 - a[0]) * dy - (y0 - a[1]) * dx
            d = d_num * lk - dk_num * l
            if kk > 1 and (l >= lk or (d_num > 0 and d <= 0) or (d_num < 0 and d >= 0)):
                break
            d_num, l, kk = dk_num, lk, kk + 1
        k[cur] = kk - 1
        cur = nxt[cur]
    cur, prev_cur = nxt[head], head
    while cur != nil:  # pass 2: non-maxima suppression
        j = 1
        while j <= k[cur] >> 1 and s[(cur - j) % n] <= s[cur] and s[(cur + j) % n] <= s[cur]:
            j += 1
        if j <= k[cur] >> 1:
            nxt[prev_cur], s[cur] = nxt[cur], 0
        else:
            prev_cur = cur
        cur = nxt[cur]
    cur, prev_cur = nxt[head], head
    while cur != nil:  # pass 3: points whose support is one point
        if k[cur] == 1 and (s[cur] <= s[(cur - 1) % n] or s[cur] <= s[(cur + 1) % n]):
            nxt[prev_cur], s[cur] = nxt[cur], 0
        else:
            prev_cur = cur
        cur = nxt[cur]
    if s[0] != 0 and s[n - 1] != 0:  # pass 4: a run across the chain's start
        i1 = 1
        while i1 < n and s[i1] != 0:
            s[i1 - 1] = 0
            i1 += 1
        if i1 == n:
            return _linked_points(pts, nxt, head)
        i1 -= 1
        i2 = n - 2
        while i2 > 0 and s[i2] != 0:
            nxt[i2], s[i2 + 1] = nil, 0
            i2 -= 1
        i2 += 1
        if i1 == 0 and i2 == n - 1:  # only two points: the first also at the end
            pts[n], s[n], k[n], nxt[n] = pts[0], s[0], k[0], nil
            nxt[n - 1] = n
        nxt[head] = i1
    cur = nxt[head]
    first = prev_cur = 0 if cur == 0 else head
    count = 1
    while cur != nil:  # pass 4: couples and longer runs of neighbours
        if nxt[cur] == nil or nxt[cur] - cur != 1:
            if count == 2:
                if s[prev_cur] > s[cur] or (s[prev_cur] == s[cur] and k[prev_cur] <= k[cur]):
                    nxt[prev_cur] = nxt[cur]  # drop the second
                    cur = prev_cur
                else:
                    nxt[head if first == prev_cur else first] = cur  # drop the first
            elif count > 2:
                nxt[nxt[first]] = cur  # keep the run's ends
            first, count = cur, 1
        else:
            count += 1
        prev_cur, cur = cur, nxt[cur]
    return _linked_points(pts, nxt, head)


def _linked_points(pts, nxt, head):
    out, cur = [], nxt[head]
    while cur != -1:
        out.append(pts[cur])
        cur = nxt[cur]
    return out


def trace_contours_plain(mask):
    """trace_contours in plain Python (the same scan, border following and
    reduction, a pixel at a time): the twin the native routine is held to."""
    m = np.asarray(mask)
    h, w = m.shape
    stride = w + 2
    grid = np.zeros((h + 2, stride), np.int8)
    grid[1:-1, 1:-1] = m != 0
    img = grid.reshape(-1).tolist()
    found = []
    for y in range(1, h + 1):
        row, prev = y * stride, 0
        lnbd = row
        for x in range(1, w + 1):
            p = img[row + x]
            if p == prev:
                continue
            if prev == 0 and p == 1 and img[lnbd] <= 0:
                codes = _follow_border(img, stride, row + x)
                found.append(_tc89_l1(codes, (x - 1, y - 1)))
                p = img[row + x]
            prev = p
            if prev & -2:
                lnbd = row + x
    return [np.asarray(c, np.int32).reshape(-1, 2) for c in found[::-1]]
