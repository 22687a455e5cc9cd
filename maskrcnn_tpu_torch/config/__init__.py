from .cfgnode import CfgNode
from .defaults import _C as cfg
from .flagship import flagship_cfg

__all__ = ["CfgNode", "cfg", "flagship_cfg"]
