"""The system under test, maskrcnn_tpu_torch, as the benchmark drives it:
its configuration, its model with the benchmark's weights, its training
step (engine.make_train_step with solver.make_optimizer and
make_lr_scheduler), its evaluation step (engine.make_eval_step), its
launch counters, the pooler entry that a traced run wraps, and the stages
that the check follows (capture). No other module of the benchmark names
the program.
"""

import importlib

import torch

PACKAGE = "maskrcnn_tpu_torch"
# the program's entry that its heads call for every ROI pooling, box and mask,
# forward (its backward joins by sequence number); a traced run wraps it
POOLER_ENTRY = ("maskrcnn_tpu_torch.models.detector", "multilevel_roi_align")


def program_cfg(config, overrides=None):
    """The program's CfgNode: its defaults under the configuration file's
    "config", then `overrides` (nested dict, tests only)."""
    from maskrcnn_tpu_torch.config import cfg as defaults

    c = defaults.clone()
    c.merge_from_other_cfg(config["config"])
    if overrides:
        c.merge_from_other_cfg(overrides)
    c.freeze()
    return c


def build_model(cfg, state, device):
    """The program's GeneralizedRCNN of `cfg` on `device`, holding `state`
    (the benchmark's weights; strict: every leaf and buffer)."""
    from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN

    with torch.device(device):
        model = GeneralizedRCNN(cfg)
    model.load_state_dict(state, strict=True)
    return model.eval()


def state_shapes(cfg):
    """{name: shape} of the program's state dict, from a model built on the
    meta device (no memory, no init)."""
    from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN

    with torch.device("meta"):
        model = GeneralizedRCNN(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def train_step(cfg, model):
    """(step, optimizer): step(batch, draws) -> the losses and their sum."""
    from maskrcnn_tpu_torch.engine import make_train_step
    from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer

    optimizer = make_optimizer(cfg, model)
    step = make_train_step(model, optimizer, make_lr_scheduler(cfg, optimizer))
    return step, optimizer


def eval_step(model):
    from maskrcnn_tpu_torch.engine.train_step import make_eval_step

    return make_eval_step(model)


def counter(path):
    """The value of one of the program's launch counters, named
    "<module of the program>:<attribute>[.<attribute>...]" (a kernel
    family's "counters", kernels/<family>.json)."""
    module, _, attrs = path.partition(":")
    if module.split(".")[0] != PACKAGE or not attrs:
        raise ValueError("{!r} names no counter of {}".format(path, PACKAGE))
    value = importlib.import_module(module)
    for a in attrs.split("."):
        value = getattr(value, a)
    return value


def launch_counters(families):
    """{family: launches so far} of the program's hand-kernel wrappers, the
    sum of each family's counters (spec.kernel_families)."""
    return {fam: sum(counter(c) for c in f["counters"]) for fam, f in families.items()}


def copied(x, device="cpu"):
    """A copy of a tensor, or of the tensors of nested lists, tuples and
    dicts, on `device`."""
    if isinstance(x, dict):
        return {k: copied(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(copied(t, device) for t in x)
    return x.detach().to(device, copy=True)


class capture:
    """Within the block, records each call of the program's proposal stage
    (detector.select_proposals: its RPN head outputs in, its proposals out)
    and of its box post-process (detector.box_head_inference: the box
    head's class logits and box regression in): in `calls`, one dict a call
    of select_proposals, with "rpn" (objectness, bbox_reg per level) and
    "proposals" (boxes, scores, valid), and "box_head" (class logits, box
    regression) added by the box post-process that follows it. Copied to
    the host (a wait for the device), or with on_device=True kept as copies
    on the device, for a timed window that must not wait."""

    def __init__(self, on_device=False):
        self.on_device = on_device

    MODULE = "maskrcnn_tpu_torch.models.detector"
    NAMES = ("select_proposals", "box_head_inference")

    def __enter__(self):
        self.module = detector = importlib.import_module(self.MODULE)
        self.saved = {n: getattr(detector, n) for n in self.NAMES}
        self.calls = []
        proposals, post = (self.saved[n] for n in self.NAMES)

        def keep(x):
            return copied(x, x[0].device if self.on_device else "cpu")

        def select_proposals(anchors, objectness, bbox_reg, *args, **kwargs):
            out = proposals(anchors, objectness, bbox_reg, *args, **kwargs)
            self.calls.append({"rpn": (keep(objectness), keep(bbox_reg)), "proposals": keep(out)})
            return out

        def box_head_inference(class_logits, box_regression, *args, **kwargs):
            self.calls[-1]["box_head"] = keep((class_logits, box_regression))
            return post(class_logits, box_regression, *args, **kwargs)

        detector.select_proposals = select_proposals
        detector.box_head_inference = box_head_inference
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.module, n, f)

    def stages(self, n):
        """The first n calls' records; an error where the program made
        fewer."""
        if len(self.calls) < n:
            raise RuntimeError("{} of {} calls of the program's proposal stage seen".format(
                len(self.calls), n))
        return self.calls[:n]
