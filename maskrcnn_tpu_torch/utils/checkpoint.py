"""Checkpointing with the reference's resume contract.

Port of maskrcnn_tpu/utils/checkpoint.py (after the reference
maskrcnn_benchmark/utils/checkpoint.py): ``model_{iter:07d}.pth`` files and
a ``last_checkpoint`` tag in save_dir naming the newest. A checkpoint holds
the model's, the optimizer's and the scheduler's state_dicts and the
caller's extras (the iteration), written with ``torch.save``. ``load``
resumes from the tag when save_dir has one, else reads the file it is given
(MODEL.WEIGHT): a ``.pth`` of this package, or a ``.npz`` that the JAX
package's Checkpointer wrote, whose model parameters ``params_from_jax``
converts (its optimizer state, in optax's layout, and its iteration are not
read: training starts afresh from those weights). DetectronCheckpointer
also resolves ``catalog://`` names (config/paths_catalog.py ModelCatalog)
to URLs, URLs to files of the local cache (utils/model_zoo.py), and reads
Detectron's Caffe2 ``.pkl`` files (utils/c2_loading.py), as the JAX
package's does.

In a process group rank 0 writes (``save_to_disk``) and every rank loads,
onto its own device: ``load`` waits at a barrier first, so that the tag and
the file rank 0 wrote before it are whole when any rank reads them. A
checkpoint keeps the full layout under the mesh's "model" axis too, so that
it loads in one process and the other way round: ``save`` gathers the
sharded blocks and their momentum over rank 0's model group (every process
of data coordinate 0 joins, parallel/mesh.py:gather_state) before rank 0
writes, and ``load`` is called before the model is sharded.
"""

import os

import numpy as np
import torch

from ..parallel.mesh import gather_state
from . import comm
from .convert import params_from_jax


class Checkpointer:
    def __init__(self, model, optimizer=None, scheduler=None, save_dir="", save_to_disk=None,
                 logger=None):
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.save_dir = save_dir
        self.save_to_disk = comm.is_main_process() if save_to_disk is None else save_to_disk
        self.logger = logger

    def _log(self, msg):
        if self.logger:
            self.logger.info(msg)

    def save(self, name, **kwargs):
        gathering = comm.model_size() > 1 and comm.data_rank() == 0
        if not self.save_dir or not (self.save_to_disk or gathering):
            return
        model_state, opt_state = gather_state(self.model, self.optimizer)
        if not self.save_to_disk:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        data = {"model": model_state}
        if self.optimizer is not None:
            data["optimizer"] = opt_state
        if self.scheduler is not None:
            data["scheduler"] = self.scheduler.state_dict()
        data.update(kwargs)
        path = os.path.join(self.save_dir, "{}.pth".format(name))
        self._log("Saving checkpoint to {}".format(path))
        torch.save(data, path)
        self.tag_last_checkpoint(path)

    def tag_last_checkpoint(self, path):
        with open(os.path.join(self.save_dir, "last_checkpoint"), "w") as f:
            f.write(path)

    def has_checkpoint(self):
        return os.path.exists(os.path.join(self.save_dir, "last_checkpoint"))

    def get_checkpoint_file(self):
        try:
            with open(os.path.join(self.save_dir, "last_checkpoint")) as f:
                return f.read().strip()
        except OSError:
            return ""

    def load(self, f=None):
        """Load the resume checkpoint of save_dir if there is one, else `f`
        (reference checkpoint.py:57-66). Restores the model, and the
        optimizer and scheduler when the file has them; returns the
        remaining extras (e.g. {"iteration": n}), {} when nothing is
        loaded. In a process group every rank calls it (a barrier)."""
        comm.synchronize()
        if self.has_checkpoint():
            f = self.get_checkpoint_file()
        if not f:
            self._log("No checkpoint found. Initializing model from scratch")
            return {}
        self._log("Loading checkpoint from {}".format(f))
        checkpoint = self._load_file(f)
        self._load_model(checkpoint.pop("model"))
        for key, obj in (("optimizer", self.optimizer), ("scheduler", self.scheduler)):
            if key in checkpoint and obj is not None:
                self._log("Loading {} from {}".format(key, f))
                obj.load_state_dict(checkpoint.pop(key))
        return checkpoint

    def _load_file(self, f):
        return torch.load(f, map_location="cpu", weights_only=True)

    def _load_model(self, loaded):
        """Copy the entries whose name and shape match the model's; keep the
        model's own values elsewhere (as the JAX package's partial load)."""
        own = self.model.state_dict()
        matched = {k: v for k, v in loaded.items() if k in own and own[k].shape == v.shape}
        if len(matched) < len(own):
            self._log("Parameters not found in checkpoint (kept init): {} of {}".format(
                len(own) - len(matched), len(own)))
        self.model.load_state_dict(matched, strict=False)


def _unflatten_params(flat):
    """{"a/b/0/w": array} -> nested dicts, with digit-keyed levels as lists
    (holes for the None placeholders the JAX package does not save)."""
    root = {}
    for path, val in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            n = max(int(k) for k in node) + 1
            return [listify(node[str(i)]) if str(i) in node else None for i in range(n)]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_jax_npz(f):
    """The model parameters of a JAX package checkpoint (.npz) as this
    package's state_dict."""
    with np.load(f, allow_pickle=False) as data:
        flat = {k[len("model/"):]: data[k] for k in data.files if k.startswith("model/")}
    return params_from_jax(_unflatten_params(flat))


class DetectronCheckpointer(Checkpointer):
    """Checkpointer that also reads catalog:// names, URLs, Detectron .pkl
    files and the JAX package's .npz checkpoints (JAX
    utils/checkpoint.py:175-200)."""

    def __init__(self, cfg, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.cfg = cfg.clone()

    def _load_file(self, f):
        if f.startswith("catalog://"):
            from ..config.paths_catalog import ModelCatalog

            catalog_f = ModelCatalog.get(f[len("catalog://"):])
            self._log("{} points to {}".format(f, catalog_f))
            f = catalog_f
        if f.startswith(("http://", "https://")):
            from .model_zoo import cache_url

            cached = cache_url(f)
            self._log("url {} cached in {}".format(f, cached))
            f = cached
        if f.endswith(".pkl"):
            from .c2_loading import load_c2_weights

            return {"model": load_c2_weights(f, self.cfg, self.model.state_dict())}
        if f.endswith(".npz"):
            return {"model": load_jax_npz(f)}
        return super()._load_file(f)
