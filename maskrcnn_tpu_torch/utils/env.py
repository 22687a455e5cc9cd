"""Environment customization hook (port of maskrcnn_tpu/utils/env.py).

When MASKRCNN_TPU_ENV_MODULE names a module (a file path or an importable
name), importing this module imports that one and calls its
``setup_environment()``, so that a user's environment can patch paths or
the configuration first. As in the JAX package, the hook runs when this
module is imported, and only then.
"""

import importlib
import os


def setup_environment():
    custom_module_path = os.environ.get("MASKRCNN_TPU_ENV_MODULE")
    if custom_module_path:
        setup_custom_environment(custom_module_path)


def setup_custom_environment(custom_module_path):
    if os.path.isfile(custom_module_path):
        from .imports import import_file

        module = import_file("maskrcnn_tpu_torch.utils.env.custom_module", custom_module_path)
    else:
        module = importlib.import_module(custom_module_path)
    if not callable(getattr(module, "setup_environment", None)):
        raise AttributeError(
            "Custom environment module defined in {} does not have the required callable "
            "attribute 'setup_environment'.".format(custom_module_path))
    module.setup_environment()


setup_environment()
