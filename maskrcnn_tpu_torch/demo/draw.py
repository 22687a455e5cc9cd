"""Raster drawing for the demo, in numpy, without OpenCV.

The JAX package's demo draws with OpenCV, which the card's machine does not
have. These functions compute what its calls compute:

* ``rectangle``: cv2.rectangle with thickness 1 (the four 1-pixel edges) or
  -1 (filled), both clipped to the image;
* ``dilate`` / ``erode``: cv2.dilate / cv2.erode with a 3 x 3 square kernel
  and OpenCV's default border (outside the image counts as background for
  the dilation and as foreground for the erosion);
* ``resize_by``: cv2.resize(src, None, fx=1/d, fy=1/d) of a float32 image
  with INTER_LINEAR: OpenCV's rounded output size, its 2 x 2 block average
  when d is 2 (the area path it takes then) and its float32 two-pass
  bilinear otherwise;
* ``apply_jet``: cv2.applyColorMap(..., COLORMAP_JET), its 256 BGR entries
  kept below;
* ``add_weighted``: cv2.addWeighted on uint8 images (float32 fused
  multiply-adds, rounded half to even).

Text and keypoint strokes are this module's own and differ from OpenCV's
by design: ``put_text`` draws a 3 x 5 pixel font at twice its size, where
OpenCV renders its built-in font, and ``line`` / ``circle`` are solid, where
the JAX demo asks for anti-aliased strokes (same width and radius).
"""

import numpy as np

_JET_BGR = bytes.fromhex(
    "8000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000"
    "b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc0000"
    "e00000e40000e80000ec0000f00000f40000f80000fc0000ff0000ff0400ff0800ff0c00"
    "ff1000ff1400ff1800ff1c00ff2000ff2400ff2800ff2c00ff3000ff3400ff3800ff3c00"
    "ff4000ff4400ff4800ff4c00ff5000ff5400ff5800ff5c00ff6000ff6400ff6800ff6c00"
    "ff7000ff7400ff7800ff7c00ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00"
    "ffa000ffa400ffa800ffac00ffb000ffb400ffb800ffbc00ffc000ffc400ffc800ffcc00"
    "ffd000ffd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00"
    "feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff2ad2ff2e"
    "ceff32caff36c6ff3ac2ff3ebeff42baff46b6ff4ab2ff4eaeff52aaff56a6ff5aa2ff5e"
    "9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e7eff827aff8676ff8a72ff8e"
    "6eff926aff9666ff9a62ff9e5effa25affa656ffaa52ffae4effb24affb646ffba42ffbe"
    "3effc23affc636ffca32ffce2effd22affd626ffda22ffde1effe21affe616ffea12ffee"
    "0efff20afff606fffa01fffe00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff"
    "00dcff00d8ff00d4ff00d0ff00ccff00c8ff00c4ff00c0ff00bcff00b8ff00b4ff00b0ff"
    "00acff00a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff"
    "007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054ff0050ff"
    "004cff0048ff0044ff0040ff003cff0038ff0034ff0030ff002cff0028ff0024ff0020ff"
    "001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff0000fc0000f80000f40000f0"
    "0000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c0"
    "0000bc0000b80000b40000b00000ac0000a80000a40000a000009c000098000094000090"
    "00008c000088000084000080")


def rectangle(image, p0, p1, color, thickness=1):
    """Draw the rectangle with corners p0 = (x0, y0) and p1 = (x1, y1)
    (inclusive) on an HWC uint8 image in place: its edges (thickness 1) or
    its whole area (thickness -1), clipped to the image."""
    h, w = image.shape[:2]
    xa, xb = sorted((int(p0[0]), int(p1[0])))
    ya, yb = sorted((int(p0[1]), int(p1[1])))
    cx0, cx1 = max(xa, 0), min(xb, w - 1)
    cy0, cy1 = max(ya, 0), min(yb, h - 1)
    if cx0 > cx1 or cy0 > cy1:
        return image
    if thickness < 0:
        image[cy0:cy1 + 1, cx0:cx1 + 1] = color
        return image
    for y in (ya, yb):
        if 0 <= y < h:
            image[y, cx0:cx1 + 1] = color
    for x in (xa, xb):
        if 0 <= x < w:
            image[cy0:cy1 + 1, x] = color
    return image


def _square_filter(mask, radius, reduce, outside):
    """max or min of a (2 radius + 1) square window, `outside` beyond the
    image."""
    h, w = mask.shape
    padded = np.full((h + 2 * radius, w + 2 * radius), outside, mask.dtype)
    padded[radius:radius + h, radius:radius + w] = mask
    out = padded[radius:radius + h, radius:radius + w].copy()
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            out = reduce(out, padded[radius + dy:radius + dy + h, radius + dx:radius + dx + w])
    return out


def dilate(mask, iterations=1):
    """cv2.dilate(mask, np.ones((3, 3)), iterations=n) of a uint8 mask."""
    return _square_filter(mask, iterations, np.maximum, 0)


def erode(mask, iterations=1):
    """cv2.erode(mask, np.ones((3, 3)), iterations=n) of a uint8 mask."""
    return _square_filter(mask, iterations, np.minimum, 255)


def _round_half_even(x):
    return int(np.rint(x))


def _linear_taps(dst, src, scale):
    """OpenCV's INTER_LINEAR taps along one axis: source index, its
    neighbour (clamped) and the float32 weights of both."""
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    lo = np.floor(f).astype(np.int64)
    f = f - lo.astype(np.float32)
    f[lo < 0] = 0
    lo[lo < 0] = 0
    last = lo >= src - 1
    f[last] = 0
    lo[last] = src - 1
    hi = np.minimum(lo + 1, src - 1)
    return lo, hi, (np.float32(1) - f).astype(np.float32), f.astype(np.float32)


def resize_by(src, d):
    """cv2.resize(src, None, fx=1.0 / d, fy=1.0 / d) of a float32 [H, W]
    image (INTER_LINEAR)."""
    src = np.asarray(src, np.float32)
    h, w = src.shape
    inv = 1.0 / d
    oh, ow = _round_half_even(h * inv), _round_half_even(w * inv)
    scale = 1.0 / inv
    if scale == 2.0:
        return _area_by_two(src, oh, ow)
    ylo, yhi, b0, b1 = _linear_taps(oh, h, scale)
    xlo, xhi, a0, a1 = _linear_taps(ow, w, scale)
    rows = src[:, xlo] * a0 + src[:, xhi] * a1
    return rows[ylo] * b0[:, None] + rows[yhi] * b1[:, None]


def _area_by_two(src, oh, ow):
    """OpenCV's fast area path at scale 2: the mean of each 2 x 2 block,
    of what lies inside the image on the last row and column."""
    h, w = src.shape
    out = np.zeros((oh, ow), np.float32)
    fh, fw = min(oh, h // 2), min(ow, w // 2)
    block = src[:2 * fh, :2 * fw].reshape(fh, 2, fw, 2)
    out[:fh, :fw] = (block[:, 0, :, 0] + block[:, 0, :, 1] + block[:, 1, :, 0]
                     + block[:, 1, :, 1]) * np.float32(0.25)
    for y in range(oh):
        xs = range(fw, ow) if y < fh else range(ow)
        for x in xs:
            cells = src[2 * y:2 * y + 2, 2 * x:2 * x + 2]
            out[y, x] = np.float32(cells.sum(dtype=np.float32)) / np.float32(cells.size) \
                if cells.size else 0
    return out


def apply_jet(gray):
    """cv2.applyColorMap(gray, cv2.COLORMAP_JET): uint8 [H, W] -> BGR uint8
    [H, W, 3]."""
    lut = np.frombuffer(_JET_BGR, np.uint8).reshape(256, 3)
    return lut[np.asarray(gray, np.uint8)]


def add_weighted(a, alpha, b, beta, gamma=0.0):
    """cv2.addWeighted(a, alpha, b, beta, gamma) of uint8 images as OpenCV's
    vector code computes it: two float32 fused multiply-adds,
    a * alpha + (b * beta + gamma), each rounded once (the products are exact
    in float64), then rounded half to even and saturated."""
    alpha, beta, gamma = (np.float64(np.float32(v)) for v in (alpha, beta, gamma))
    inner = (b.astype(np.float64) * beta + gamma).astype(np.float32)
    t = (a.astype(np.float64) * alpha + inner.astype(np.float64)).astype(np.float32)
    return np.clip(np.rint(t), 0, 255).astype(np.uint8)


# -- the demo's own text and strokes -------------------------------------------

# A 3 x 5 pixel font: each glyph is its five rows, "#" for ink. Letters are
# drawn as capitals; characters without a glyph are drawn as "?".
_GLYPHS = {
    " ": "... ... ... ... ...", "A": ".#. #.# ### #.# #.#", "B": "##. #.# ##. #.# ##.",
    "C": ".## #.. #.. #.. .##", "D": "##. #.# #.# #.# ##.", "E": "### #.. ##. #.. ###",
    "F": "### #.. ##. #.. #..", "G": ".## #.. #.# #.# .##", "H": "#.# #.# ### #.# #.#",
    "I": "### .#. .#. .#. ###", "J": "..# ..# ..# #.# .#.", "K": "#.# #.# ##. #.# #.#",
    "L": "#.. #.. #.. #.. ###", "M": "#.# ### ### #.# #.#", "N": "##. #.# #.# #.# #.#",
    "O": ".#. #.# #.# #.# .#.", "P": "##. #.# ##. #.. #..", "Q": ".#. #.# #.# ##. .##",
    "R": "##. #.# ##. #.# #.#", "S": ".## #.. .#. ..# ##.", "T": "### .#. .#. .#. .#.",
    "U": "#.# #.# #.# #.# ###", "V": "#.# #.# #.# #.# .#.", "W": "#.# #.# ### ### #.#",
    "X": "#.# #.# .#. #.# #.#", "Y": "#.# #.# .#. .#. .#.", "Z": "### ..# .#. #.. ###",
    "0": "### #.# #.# #.# ###", "1": ".#. ##. .#. .#. ###", "2": "##. ..# .#. #.. ###",
    "3": "##. ..# .#. ..# ##.", "4": "#.# #.# ### ..# ..#", "5": "### #.. ##. ..# ##.",
    "6": ".## #.. ### #.# ###", "7": "### ..# .#. .#. .#.", "8": "### #.# ### #.# ###",
    "9": "### #.# ### ..# ##.", ":": "... .#. ... .#. ...", ".": "... ... ... ... .#.",
    "_": "... ... ... ... ###", "-": "... ... ### ... ...", "'": ".#. .#. ... ... ...",
    "?": "##. ..# .#. ... .#.",
}
GLYPH_SCALE = 2
ADVANCE = 4 * GLYPH_SCALE  # 3 columns of ink and one of space
TEXT_HEIGHT = 5 * GLYPH_SCALE
BASELINE = 2


def text_size(text):
    """((width, height), baseline) of put_text's text, as cv2.getTextSize
    returns them."""
    return (ADVANCE * len(text) + 1, TEXT_HEIGHT), BASELINE


def put_text(image, text, org, color):
    """Draw `text` with its baseline's left end at org = (x, y), in place,
    clipped to the image."""
    h, w = image.shape[:2]
    x0, y0 = int(org[0]), int(org[1]) - TEXT_HEIGHT
    for i, ch in enumerate(text):
        rows = _GLYPHS.get(ch.upper(), _GLYPHS["?"]).split()
        ink = np.array([[c == "#" for c in row] for row in rows])
        ink = ink.repeat(GLYPH_SCALE, 0).repeat(GLYPH_SCALE, 1)
        ys, xs = np.nonzero(ink)
        ys, xs = ys + y0, xs + x0 + 1 + i * ADVANCE
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        image[ys[keep], xs[keep]] = color
    return image


def circle(image, center, radius, color):
    """A filled disc (solid, no anti-aliasing), in place, clipped."""
    h, w = image.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    ys, xs = np.mgrid[cy - radius:cy + radius + 1, cx - radius:cx + radius + 1]
    keep = ((xs - cx) ** 2 + (ys - cy) ** 2 <= radius * radius) & (ys >= 0) & (ys < h) \
        & (xs >= 0) & (xs < w)
    image[ys[keep], xs[keep]] = color
    return image


def line(image, p, q, color, thickness=2):
    """A solid line from p to q, `thickness` pixels wide, in place, clipped."""
    (x0, y0), (x1, y1) = (int(v) for v in p), (int(v) for v in q)
    n = max(abs(x1 - x0), abs(y1 - y0), 1)
    t = np.linspace(0.0, 1.0, n + 1)
    xs = np.rint(x0 + (x1 - x0) * t).astype(np.int64)
    ys = np.rint(y0 + (y1 - y0) * t).astype(np.int64)
    h, w = image.shape[:2]
    lo = -((thickness - 1) // 2)
    for dy in range(lo, lo + thickness):
        for dx in range(lo, lo + thickness):
            yy, xx = ys + dy, xs + dx
            keep = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            image[yy[keep], xx[keep]] = color
    return image
