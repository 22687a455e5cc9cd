"""Paired (image, target) transforms on HWC uint8 numpy images.

Port of maskrcnn_tpu/data/transforms.py (after the reference
maskrcnn_benchmark/data/transforms), without Pillow: images stay HWC uint8
RGB numpy arrays from the dataset to ToArray. Resize is PyTorch's
antialiased bilinear in float32, rounded half up: PIL's ``Image.BILINEAR``
resize rounds between its horizontal and vertical passes, so it stays
within half a grey level of that exact value and the two agree to within
one level (PyTorch's own uint8 path, which imitates PIL's two passes,
differs by two at a few pixels). The boxes and polygons scale by the same
ratios as in the JAX package. The random choices (the training scale, the
flips, the jitter factors) come from one ``random.Random`` that
``build_transforms`` creates and the loader seeds in each worker
(``Compose.rng``). ColorJitter computes what the JAX package's Pillow calls
compute, in numpy: ImageEnhance's Brightness, Contrast and Color as PIL's
blend (float32, truncated, clipped), and the hue shift through PIL's uint8
HSV conversions.
"""

import random

import numpy as np
import torch
import torch.nn.functional as F

from ..structures.boxlist import FLIP_LEFT_RIGHT, FLIP_TOP_BOTTOM


class Compose:
    def __init__(self, transforms, rng):
        self.transforms = transforms
        self.rng = rng

    def __call__(self, image, target):
        for t in self.transforms:
            image, target = t(image, target)
        return image, target


class Resize:
    def __init__(self, min_size, max_size, rng):
        if not isinstance(min_size, (list, tuple)):
            min_size = (min_size,)
        self.min_size = min_size
        self.max_size = max_size
        self.rng = rng

    def get_size(self, image_size):
        """(w, h) -> (oh, ow): the shorter side to a size drawn from
        min_size, the longer side capped at max_size."""
        w, h = image_size
        size = self.rng.choice(self.min_size)
        max_size = self.max_size
        if max_size is not None:
            min_original = float(min((w, h)))
            max_original = float(max((w, h)))
            if max_original / min_original * size > max_size:
                size = int(round(max_size * min_original / max_original))
        if (w <= h and w == size) or (h <= w and h == size):
            return h, w
        if w < h:
            ow = size
            oh = int(size * h / w)
        else:
            oh = size
            ow = int(size * w / h)
        return oh, ow

    def __call__(self, image, target=None):
        oh, ow = self.get_size((image.shape[1], image.shape[0]))
        x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None].float()
        x = F.interpolate(x, size=(oh, ow), mode="bilinear", antialias=True, align_corners=False)
        x = x.add_(0.5).floor_().clamp_(0, 255).to(torch.uint8)
        image = x[0].permute(1, 2, 0).numpy()
        if target is not None:
            target = target.resize((ow, oh))
        return image, target


class RandomHorizontalFlip:
    def __init__(self, prob, rng):
        self.prob = prob
        self.rng = rng

    def __call__(self, image, target):
        if self.rng.random() < self.prob:
            # BoxList.transpose returns a new object: both flip markers are
            # carried over, or the collator's mask-patch cache would key an
            # h+v-flipped sample as v-only
            h = getattr(target, "_hflipped", False)
            v = getattr(target, "_vflipped", False)
            image = image[:, ::-1]
            target = target.transpose(FLIP_LEFT_RIGHT)
            target._hflipped = not h
            target._vflipped = v
        return image, target


class RandomVerticalFlip:
    def __init__(self, prob, rng):
        self.prob = prob
        self.rng = rng

    def __call__(self, image, target):
        if self.rng.random() < self.prob:
            h = getattr(target, "_hflipped", False)
            v = getattr(target, "_vflipped", False)
            image = image[::-1]
            target = target.transpose(FLIP_TOP_BOTTOM)
            target._hflipped = h
            target._vflipped = not v
        return image, target


def luminance(image):
    """PIL's "L" conversion of an RGB uint8 image: (19595 R + 38470 G +
    7471 B + 2^15) >> 16."""
    rgb = image.astype(np.int32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def blend(degenerate, image, factor):
    """PIL's Image.blend(degenerate, image, factor) on uint8 arrays:
    degenerate + factor * (image - degenerate) in float32, truncated and
    clipped to 0..255."""
    a = np.float32(factor)
    d = degenerate.astype(np.float32)
    out = d + a * (image.astype(np.float32) - d)
    return np.clip(np.trunc(out), 0, 255).astype(np.uint8)


def rgb_to_hsv(image):
    """PIL's RGB -> HSV conversion (uint8 H, S, V), its float and double
    steps kept."""
    rgb = image.astype(np.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    gray = maxc == minc
    cr = np.where(gray, 1, maxc - minc).astype(np.float32)
    s = cr / np.where(gray, 1, maxc).astype(np.float32)
    rc = (maxc - r).astype(np.float32) / cr
    gc = (maxc - g).astype(np.float32) / cr
    bc = (maxc - b).astype(np.float32) / cr
    h = np.where(r == maxc, (bc - gc).astype(np.float64),
                 np.where(g == maxc, 2.0 + rc.astype(np.float64) - bc,
                          4.0 + gc.astype(np.float64) - rc)).astype(np.float32)
    h = np.fmod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(np.float32)
    uh = np.clip((h.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    us = np.clip((s.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    out = np.stack([np.where(gray, 0, uh), np.where(gray, 0, us), maxc], -1)
    return out.astype(np.uint8)


def _round_half_away(x):
    fl = np.floor(x)
    return fl + (x - fl >= 0.5)


def hsv_to_rgb(hsv):
    """PIL's HSV -> RGB conversion of uint8 H, S, V."""
    h = hsv[..., 0].astype(np.float32)
    s = hsv[..., 1].astype(np.int32)
    v = hsv[..., 2].astype(np.int32)
    x = h.astype(np.float64) * 6.0 / 255.0
    i = np.floor(x).astype(np.int64)
    f = (x - i.astype(np.float32)).astype(np.float32).astype(np.float64)
    fs = (s.astype(np.float32) / 255.0).astype(np.float32).astype(np.float64)
    vf = v.astype(np.float32).astype(np.float64)
    p = np.clip(_round_half_away(vf * (1.0 - fs)), 0, 255).astype(np.int32)
    q = np.clip(_round_half_away(vf * (1.0 - fs * f)), 0, 255).astype(np.int32)
    t = np.clip(_round_half_away(vf * (1.0 - fs * (1.0 - f))), 0, 255).astype(np.int32)
    sector = i % 6
    choose = lambda *c: np.select([sector == k for k in range(6)], c)  # noqa: E731
    rgb = np.stack([choose(v, q, p, p, t, v), choose(t, v, v, q, p, p),
                    choose(p, p, t, v, v, q)], -1)
    gray = (s == 0)[..., None]
    return np.where(gray, v[..., None], rgb).astype(np.uint8)


class ColorJitter:
    """The JAX package's ColorJitter (Pillow's ImageEnhance and HSV) on HWC
    uint8 RGB arrays: each factor above 0 draws, in this order, a
    brightness, contrast and saturation factor 1 + U(-x, x) and a hue shift
    U(-x, x) of the 0..255 hue circle (taken modulo 255, as there)."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0, rng=random):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.rng = rng

    def __call__(self, image, target):
        if self.brightness > 0:
            f = 1 + self.rng.uniform(-self.brightness, self.brightness)
            image = blend(np.zeros_like(image), image, f)
        if self.contrast > 0:
            f = 1 + self.rng.uniform(-self.contrast, self.contrast)
            lum = luminance(image)
            mean = int(float(lum.sum(dtype=np.int64)) / lum.size + 0.5)
            image = blend(np.full_like(image, mean), image, f)
        if self.saturation > 0:
            f = 1 + self.rng.uniform(-self.saturation, self.saturation)
            image = blend(np.repeat(luminance(image)[..., None], 3, -1), image, f)
        if self.hue > 0:
            h = self.rng.uniform(-self.hue, self.hue)
            hsv = rgb_to_hsv(image)
            hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(h * 255)) % 255
            image = hsv_to_rgb(hsv)
        return image, target


class ToArray:
    """HWC RGB, contiguous: uint8 stays uint8 (Normalize maps it through a
    lookup table), anything else becomes float32."""

    def __call__(self, image, target):
        if image.dtype == np.uint8:
            return np.ascontiguousarray(image), target
        return np.ascontiguousarray(image, np.float32), target


class Normalize:
    def __init__(self, mean, std, to_bgr255=True, uint8_passthrough=False):
        """uint8_passthrough: leave uint8 images untouched (the model
        normalizes them on the device, TPU.DEVICE_NORMALIZE) but still
        normalize float inputs."""
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_bgr255 = to_bgr255
        self.uint8_passthrough = uint8_passthrough
        # per-output-channel table over the 256 uint8 values: one gather
        # pass replaces the flip, subtract and divide passes
        v = np.arange(256, dtype=np.float32)
        scaled = v if to_bgr255 else v / 255.0
        self._lut = np.stack([(scaled - self.mean[c]) / self.std[c] for c in range(len(self.mean))])
        self._src = np.arange(len(self.mean))[::-1] if to_bgr255 else np.arange(len(self.mean))

    def __call__(self, image, target):
        if image.dtype == np.uint8 and image.ndim == 3:
            if self.uint8_passthrough:
                return image, target
            out = np.empty(image.shape[:2] + (len(self._src),), np.float32)
            for c, sc in enumerate(self._src):
                out[:, :, c] = self._lut[c][image[:, :, sc]]
            return out, target
        if self.to_bgr255:
            image = image[:, :, ::-1]  # RGB -> BGR, stays 0-255
        else:
            image = image / 255.0
        image = (image - self.mean) / self.std
        return np.ascontiguousarray(image, np.float32), target


def build_transforms(cfg, is_train=True, seed=0):
    """The pipeline of maskrcnn_tpu/data/transforms.py:build_transforms,
    its random choices drawn from random.Random(seed) (``Compose.rng``)."""
    if is_train:
        min_size = cfg.INPUT.MIN_SIZE_TRAIN
        max_size = cfg.INPUT.MAX_SIZE_TRAIN
        flip_h = cfg.INPUT.HORIZONTAL_FLIP_PROB_TRAIN
        flip_v = cfg.INPUT.VERTICAL_FLIP_PROB_TRAIN
        jitter = (cfg.INPUT.BRIGHTNESS, cfg.INPUT.CONTRAST, cfg.INPUT.SATURATION, cfg.INPUT.HUE)
    else:
        min_size = cfg.INPUT.MIN_SIZE_TEST
        max_size = cfg.INPUT.MAX_SIZE_TEST
        flip_h = flip_v = 0.0
        jitter = (0.0,) * 4
    rng = random.Random(seed)
    ts = [ColorJitter(*jitter, rng=rng)] if any(jitter) else []
    ts.append(Resize(min_size, max_size, rng))
    if flip_h > 0:
        ts.append(RandomHorizontalFlip(flip_h, rng))
    if flip_v > 0:
        ts.append(RandomVerticalFlip(flip_v, rng))
    ts.append(ToArray())
    ts.append(Normalize(cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD, cfg.INPUT.TO_BGR255,
                        uint8_passthrough=cfg.TPU.DEVICE_NORMALIZE))
    return Compose(ts, rng)
