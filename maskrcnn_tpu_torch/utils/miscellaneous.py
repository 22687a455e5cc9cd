"""Small helpers of the entry points (port of maskrcnn_tpu/utils/miscellaneous.py)."""

import json
import os

import torch

from . import comm


def cfg_device(cfg):
    """The torch.device MODEL.DEVICE names: "cuda" (the default, as in the
    reference) or "cpu". The JAX package's "tpu" means nothing here."""
    name = cfg.MODEL.DEVICE
    if name.split(":")[0] not in ("cuda", "cpu"):
        raise ValueError("MODEL.DEVICE {!r}: the port runs on cuda or cpu".format(name))
    return torch.device(name)


def mkdir(path):
    os.makedirs(path, exist_ok=True)


def save_labels(dataset_list, output_dir):
    if comm.is_main_process():
        ids_to_labels = {}
        for dataset in dataset_list:
            if hasattr(dataset, "categories"):
                ids_to_labels.update(dataset.categories)
        if ids_to_labels:
            with open(os.path.join(output_dir, "labels.json"), "w") as f:
                json.dump(ids_to_labels, f, indent=2)


def save_config(cfg, path):
    """The configuration as YAML (``CfgNode.dump``, which needs no PyYAML)."""
    if comm.is_main_process():
        with open(path, "w") as f:
            f.write(cfg.dump())
