"""Import a module from a file path (port copy of maskrcnn_tpu/utils/imports.py)."""

import importlib.util
import sys


def import_file(module_name, file_path, make_importable=False):
    spec = importlib.util.spec_from_file_location(module_name, file_path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if make_importable:
        sys.modules[module_name] = module
    return module
