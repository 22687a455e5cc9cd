"""Op-level profile of the training step (or of inference) on the card.

    python -m maskrcnn_tpu_torch.tools.profile_train [BATCH] [--infer] [--device cpu]

PyTorch counterpart of the JAX package's tools/profile_train.py. It builds
the flagship Mask R-CNN R-50-FPN (config/flagship.py), or the YAML in
MASKRCNN_TPU_PROFILE_CONFIG with MODEL.WEIGHT "" (seeded weights), on the
card (MODEL.DEVICE, unless --device says otherwise), and bench.py's
synthetic batch at the configuration's first training size (test size with
--infer), landscape and padded to DATALOADER.SIZE_DIVISIBILITY: 800x1333 in
an 800x1344 batch for the published COCO files. BATCH defaults to 8 (1
with --infer).

It prints the steady-state ms a step and img/s (one warm-up step, then 5),
then reads one torch.profiler trace of 3 steps through utils/profiling.py:
the device's busy ms a step and its idle share, a table by span (the
model's and the step's spans: the JAX package's named scopes and the port's
own, utils/profiling.py PHASES and PORT_SPANS; a kernel belongs to the
innermost span around its op, a backward kernel to its forward op's span as
"<span> bwd"), a table by op family (hand
kernels, conv/matmul, sort/top-k, other; forward and backward), and the
MASKRCNN_TPU_PROFILE_TOP (default 45) kernels with the most time. Every
number stands beside the card's name and power limit. With a CPU device
the tables time the host's ops instead, and say so; no device number is
printed then.
"""

import argparse
import os
import time

import numpy as np
import torch

from ..config import cfg as default_cfg
from ..config import flagship_cfg
from ..engine import make_train_step
from ..models import build_detection_model
from ..solver import make_lr_scheduler, make_optimizer
from ..utils import profiling

WARMUP, TIMED, TRACED = 1, 5, 3


def train_batch(b, hw, sizes, gt_per_image, mask_size, seed, device, block_masks=False,
                keypoints=False):
    """bench.py's synthetic training batch: float32 images (standard normal,
    as if normalized) of hw with image sizes `sizes`, COCO-like gt
    (lognormal instance counts of mean ~7, log-uniform sides of 16-500 px),
    random labels, binary gt mask patches of mask_size (per pixel, or in
    4 x 4 blocks with block_masks; none for mask_size None) and, with
    keypoints, 17 joints an instance (uniform over the image, visibility 0-2;
    labels 1), drawn in that order from RandomState(seed)."""
    h, w = hw
    g = gt_per_image
    rs = np.random.RandomState(seed)
    gt_boxes = np.zeros((b, g, 4), np.float32)
    gt_labels = np.zeros((b, g), np.int32)
    for i in range(b):
        n_gt = int(np.clip(rs.lognormal(mean=1.7, sigma=0.8), 1, g))
        side = np.exp(rs.uniform(np.log(16), np.log(min(500, h, w)), (n_gt, 2)))
        ctr = rs.uniform(0, 1, (n_gt, 2)) * np.array([w - 1, h - 1])
        lo = np.clip(ctr - side / 2, 0, None)
        hi = np.minimum(ctr + side / 2, [w - 1, h - 1])
        hi = np.maximum(hi, lo + 2)
        gt_boxes[i, :n_gt, :2] = lo
        gt_boxes[i, :n_gt, 2:] = hi
        gt_labels[i, :n_gt] = rs.randint(1, 81, n_gt)
    batch = dict(images=rs.randn(b, h, w, 3).astype(np.float32),
                 image_sizes=np.asarray([sizes] * b, np.int32), gt_boxes=gt_boxes,
                 gt_labels=gt_labels)
    if mask_size is not None:
        if block_masks:
            blocks = rs.rand(b, g, mask_size // 4, mask_size // 4) > 0.5
            masks = blocks.repeat(4, 2).repeat(4, 3)
        else:
            masks = rs.rand(b, g, mask_size, mask_size) > 0.5
        batch["gt_masks"] = masks.astype(np.uint8)
    if keypoints:
        kx = rs.uniform(0, w - 1, (b, g, 17, 1))
        ky = rs.uniform(0, h - 1, (b, g, 17, 1))
        kv = rs.randint(0, 3, (b, g, 17, 1))
        batch["gt_keypoints"] = np.concatenate([kx, ky, kv], -1).astype(np.float32)
        batch["gt_labels"] = np.minimum(gt_labels, 1)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def profile_config():
    """The flagship, or MASKRCNN_TPU_PROFILE_CONFIG's YAML with MODEL.WEIGHT
    "" (frozen)."""
    path = os.environ.get("MASKRCNN_TPU_PROFILE_CONFIG")
    if path:
        c = default_cfg.clone()
        c.merge_from_file(path)
        c.MODEL.WEIGHT = ""
    else:
        c = flagship_cfg()
    c.freeze()
    return c


def _sizes(c, min_size, max_size):
    """(image size, padded size) of a landscape image at (min_size,
    max_size), padded to the size divisibility."""
    d = max(c.DATALOADER.SIZE_DIVISIBILITY, 1)
    sizes = (min_size, max_size)
    return sizes, tuple(-(-s // d) * d for s in sizes)


def build_step(b, device=None):
    """(step, model, batch): the train step (make_train_step with the
    config's solver, sampler draws from a generator seeded 0) of the
    profiled config's model (seed 0), and bench.py's batch of b images at
    its first training size, on `device` (default MODEL.DEVICE)."""
    c = profile_config()
    device = torch.device(device or c.MODEL.DEVICE)
    model = build_detection_model(c, device=device, seed=0)
    optimizer = make_optimizer(c, model)
    step = make_train_step(model, optimizer, make_lr_scheduler(c, optimizer),
                           generator=torch.Generator(device=device).manual_seed(0))
    sizes, hw = _sizes(c, c.INPUT.MIN_SIZE_TRAIN[0], c.INPUT.MAX_SIZE_TRAIN)
    heads = not c.MODEL.RETINANET_ON
    batch = train_batch(b, hw, sizes, c.TPU.MAX_GT_BOXES,
                        c.TPU.GT_MASK_SIZE if c.MODEL.MASK_ON and heads else None, 0, device,
                        keypoints=c.MODEL.KEYPOINT_ON and heads)
    return step, model, batch


def build_infer(b, device=None):
    """(step, model, batch) for --infer: step(batch) is the profiled
    config's infer_forward on b standard-normal images at its test size."""
    c = profile_config()
    device = torch.device(device or c.MODEL.DEVICE)
    model = build_detection_model(c, device=device, seed=0)
    sizes, (h, w) = _sizes(c, c.INPUT.MIN_SIZE_TEST, c.INPUT.MAX_SIZE_TEST)
    rs = np.random.RandomState(0)
    batch = {"images": torch.from_numpy(rs.randn(b, h, w, 3).astype(np.float32)).to(device),
             "image_sizes": torch.tensor([sizes] * b, dtype=torch.int32, device=device)}
    return model.infer_forward, model, batch


def measure(step, batch, device):
    """Steady-state seconds a step (WARMUP, then TIMED steps) and the
    reading of a trace of TRACED steps: the wall ms a step under the
    profiler, and phase_breakdown's tables; on the card also the device busy
    ms a step, the idle share, and the busy time linked to no op. Raises
    where a card trace holds no device time, or reads busier than the wall
    clock."""
    for _ in range(WARMUP):
        step(batch)
    profiling.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(TIMED):
        step(batch)
    profiling.synchronize(device)
    step_s = (time.perf_counter() - t0) / TIMED
    prof, wall_ms = profiling.timed(step, batch, TRACED, device)
    res = {"step_s": step_s, "wall_ms": wall_ms}
    res.update(profiling.phase_breakdown(prof, TRACED, device))
    if torch.device(device).type == "cuda":
        busy_ms, _ = profiling.device_busy(prof, TRACED)
        if busy_ms <= 0:
            raise RuntimeError("the profiler saw no device time")
        profiling.check_busy(busy_ms, wall_ms)
        res.update(device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                   unlinked_ms=busy_ms - res["linked_ms"])
    return res


def report(res, b, card, top_n=None):
    """Print measure()'s reading, each number beside `card`."""
    top_n = top_n or int(os.environ.get("MASKRCNN_TPU_PROFILE_TOP", "45"))
    print("steady-state: {:.2f} ms/step, {:.2f} img/s [{}]".format(
        res["step_s"] * 1e3, b / res["step_s"], card))
    if "device_busy_ms" in res:
        print("device busy: {:.2f} ms/step of {:.2f} ms wall under the profiler, idle share "
              "{:.3f} [{}]".format(res["device_busy_ms"], res["wall_ms"], res["idle_share"],
                                   card))
        total = res["device_busy_ms"]
    else:
        total = res["linked_ms"]
    print("timed: {}; {:.3f} ms/step linked to an op{}".format(
        res["timed"], res["linked_ms"], "; {:.3f} ms/step linked to none".format(
            res["unlinked_ms"]) if "unlinked_ms" in res else ""))
    for title, table in (("by span (PORT_SPANS, then PHASES)", res["phases"]),
                         ("by op family", res["families"])):
        print("\n{} [{}]:".format(title, card))
        for k, v in table.items():
            print("  {:24s} {:9.3f} ms/step {:5.1f}%".format(k, v, 100 * v / total))
    print("\n{:60s} {:>9s} {:>5s}  phase / op [{}]".format("kernel" if "device_busy_ms" in res
                                                           else "op", "ms/step", "%", card))
    for k, v in list(res["ops"].items())[:top_n]:
        print("{:60s} {:9.3f} {:5.1f}  {}".format(k[:60], v, 100 * v / total, res["origin"][k]))


def main(argv=None):
    parser = argparse.ArgumentParser(description="op-level profile of the train step")
    parser.add_argument("batch", nargs="?", type=int)
    parser.add_argument("--infer", action="store_true")
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    b = args.batch or (1 if args.infer else 8)
    step, model, batch = (build_infer if args.infer else build_step)(b, args.device)
    device = next(model.parameters()).device
    card = profiling.device_line(device)
    res = measure(step, batch, device)
    report(res, b, card)
    return res


if __name__ == "__main__":
    main()
