"""Polygon rasterization for the data pipeline.

The port's counterpart of ``polygons_to_mask`` in maskrcnn_tpu/utils/maskops.py
where the JAX package runs its native build (maskrcnn_tpu/utils/_maskops_native.py):
the same C++ routine, copied as ``csrc/maskops.cpp``, built by ``ops/native.py``
with the host compiler at first use and called through ctypes. There is no
other path (the JAX package's numpy fallback needs OpenCV).
"""

import ctypes

import numpy as np

from ..ops import native


def library():
    """The ctypes handle of the rasterizer, built on first use."""
    lib = native.load("maskops")
    if not getattr(lib, "_typed", False):
        lib.polygons_to_mask.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.polygons_to_mask.restype = None
        lib._typed = True
    return lib


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
