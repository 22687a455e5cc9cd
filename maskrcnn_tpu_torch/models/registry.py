"""Model registry (port of maskrcnn_tpu/models/registry.py).

``build_detection_model`` consults META_ARCHITECTURES before the built-in
GeneralizedRCNN, so a user's architecture is selected from the config::

    from maskrcnn_tpu_torch.models import registry

    @registry.META_ARCHITECTURES.register("MyDetector")
    class MyDetector(torch.nn.Module):
        def __init__(self, cfg): ...

    # cfg.MODEL.META_ARCHITECTURE = "MyDetector"

The JAX module's eight component registries (BACKBONES, RPN_HEADS, the ROI
heads' extractors and predictors) are left out: neither package's model code
consults them, so a class registered there would never be built.
"""

from ..utils.registry import Registry

META_ARCHITECTURES = Registry()
