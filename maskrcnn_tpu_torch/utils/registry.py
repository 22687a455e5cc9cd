"""String-keyed registry.

Port copy of maskrcnn_tpu/utils/registry.py (after the reference
maskrcnn_benchmark/utils/registry.py): a dict whose ``register`` adds an
entry once, as a call or as a decorator::

    REGISTRY = Registry()

    @REGISTRY.register("name")
    def f(...): ...
"""


def _register_generic(module_dict, module_name, module):
    if module_name in module_dict:
        raise KeyError("{!r} is already registered".format(module_name))
    module_dict[module_name] = module


class Registry(dict):
    def register(self, module_name, module=None):
        if module is not None:
            _register_generic(self, module_name, module)
            return module

        def register_fn(fn):
            _register_generic(self, module_name, fn)
            return fn

        return register_fn
