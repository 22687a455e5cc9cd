"""PyTorch and CUDA port of maskrcnn_tpu, for NVIDIA Hopper (H100).

The JAX package ``maskrcnn_tpu`` is the reference; this package imports
nothing of it and no JAX. Its modules mirror the JAX layout (``config``,
``models``, ``models/roi_heads``, ``ops``, ``utils``); the TPU kernels on its
path are hand-written CUDA in ``csrc/``, built by ``ops/native.py`` at first
use. Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .config import cfg, flagship_cfg
from .models.detector import build_detection_model
from .predictor import Predictor

__all__ = ["cfg", "flagship_cfg", "build_detection_model", "Predictor"]
