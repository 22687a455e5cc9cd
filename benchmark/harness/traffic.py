"""The one traffic generator: every mix is a traffic/<name>.json of
parameters that these functions read.

Training ("kind": "train"): a pool of distinct batches on the device, cycled
by the window. The gt follows bench.py's synthetic batch (after
maskrcnn_tpu_torch/tools/profile_train.py:train_batch): per image a
lognormal count of instances (mean ~7) capped at MAX_GT_BOXES, log-uniform
sides, uniform centres, labels 1-80. The counts and sides are one set for
every seed (gt_sizes); the seed deals them to the pool's images and draws
the centres and labels on the host, and the images (standard normal
float32, as if normalized), the binary gt mask patches and the samplers'
uniform draws on the card in bulk, so the program and the reference
sample alike.

Inference ("kind": "infer"): a pool of host batches of uint8 RGB images at
the resized size of the source sizes (the predictor's resize rule), one
orientation a batch, padded to the size divisibility; each orientation
fills half of the pool, in an order drawn from the seed, so every seed
runs the same shapes.
"""

import numpy as np
import torch


def sub_seeds(seed, n):
    """n independent 31-bit seeds from any whole number `seed`."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n) % (2 ** 31)]


def padded(h, w, div):
    d = max(int(div), 1)
    return -(-h // d) * d, -(-w // d) * d


def resized_size(h, w, min_size, max_size):
    """(new_h, new_w) of the resize rule (short side to min_size, long side
    at most max_size)."""
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(round(h * scale)), int(round(w * scale))


def feature_sizes(h, w, cfg):
    """The (H, W) of each map the RPN sees, from the convs' arithmetic:
    C2-C5 and P6 (the stride-2 subsample of P5) for an FPN, C4 alone for a
    C4 body."""
    def conv(x, k, s, p):
        return (x + 2 * p - k) // s + 1

    size = [conv(conv(x, 7, 2, 3), 3, 2, 1) for x in (h, w)]
    maps = [tuple(size)]
    for _ in range(3):
        size = [conv(x, 1, 2, 0) for x in size]
        maps.append(tuple(size))
    if "FPN" in cfg["MODEL"]["BACKBONE"]["CONV_BODY"]:
        return maps + [tuple(-(-x // 2) for x in maps[-1])]
    return [maps[2]]


def draw_counts(hw, cfg):
    """(anchors an image, proposals an image in training, with the gt)."""
    r = cfg["MODEL"]["RPN"]
    maps = feature_sizes(hw[0], hw[1], cfg)
    per_loc = len(r["ASPECT_RATIOS"]) * (len(r["ANCHOR_SIZES"]) if len(maps) == 1 else 1)
    levels = [fh * fw * per_loc for fh, fw in maps]
    k_max = max(min(r["PRE_NMS_TOP_N_TRAIN"], n) for n in levels)
    k_post = min(r["POST_NMS_TOP_N_TRAIN"], k_max)
    props = min(r["FPN_POST_NMS_TOP_N_TRAIN"], len(levels) * k_post) if len(levels) > 1 else k_post
    return sum(levels), props + cfg["TPU"]["MAX_GT_BOXES"]


def gt_sizes(n_images, g, h, w, gt):
    """The instance sides of n_images images, as bench.py draws them (a
    lognormal count of mean ~7 capped at g, log-uniform sides) from its own
    RandomState(0): the same set for every seed, so that a seed changes
    which image holds which instances and where, not how much pooling,
    matching and NMS a step does."""
    rs = np.random.RandomState(0)
    out = []
    for _ in range(n_images):
        n = int(np.clip(rs.lognormal(mean=gt["lognormal_mean"], sigma=gt["lognormal_sigma"]), 1, g))
        out.append(np.exp(rs.uniform(np.log(gt["side_min"]), np.log(min(gt["side_max"], h, w)),
                                     (n, 2))))
    return out


def _gt(rs, sides, g, h, w, gt):
    """Boxes [B, G, 4] and labels [B, G] of images with the given sides:
    uniform centres and labels 1..num_labels from rs."""
    b = len(sides)
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int32)
    for i, side in enumerate(sides):
        n = side.shape[0]
        ctr = rs.uniform(0, 1, (n, 2)) * np.array([w - 1, h - 1])
        lo = np.clip(ctr - side / 2, 0, None)
        hi = np.maximum(np.minimum(ctr + side / 2, [w - 1, h - 1]), lo + 2)
        boxes[i, :n, :2] = lo
        boxes[i, :n, 2:] = hi
        labels[i, :n] = rs.randint(1, gt["num_labels"] + 1, n)
    return boxes, labels


def train_pool(traffic, cfg, seed, device):
    """[(batch, draws)] * traffic["pool"]: batch holds images [B, H, W, 3]
    float32, image_sizes [B, 2], gt_boxes [B, G, 4], gt_labels [B, G],
    gt_masks [B, G, S, S] uint8; draws the samplers' rpn_pos, rpn_neg
    [B, anchors] and box_pos, box_neg [B, proposals]."""
    b = traffic["batch"]
    h, w = traffic["image_size"]
    ph, pw = padded(h, w, cfg["DATALOADER"]["SIZE_DIVISIBILITY"])
    g, s = cfg["TPU"]["MAX_GT_BOXES"], cfg["TPU"]["GT_MASK_SIZE"]
    host_seed, dev_seed = sub_seeds(seed, 2)
    rs = np.random.RandomState(host_seed)
    gen = torch.Generator(device=device).manual_seed(dev_seed)
    n_anchors, n_props = draw_counts((ph, pw), cfg)
    sizes = torch.tensor([[h, w]] * b, dtype=torch.int32, device=device)
    sides = gt_sizes(traffic["pool"] * b, g, h, w, traffic["gt"])
    order = rs.permutation(len(sides))
    pool = []
    for k in range(traffic["pool"]):
        boxes, labels = _gt(rs, [sides[j] for j in order[k * b:(k + 1) * b]], g, h, w,
                            traffic["gt"])
        images = torch.zeros((b, ph, pw, 3), device=device)
        images[:, :h, :w] = torch.randn((b, h, w, 3), generator=gen, device=device)
        masks = (torch.rand((b, g, s, s), generator=gen, device=device) > 0.5).to(torch.uint8)
        batch = dict(images=images, image_sizes=sizes, gt_boxes=torch.from_numpy(boxes).to(device),
                     gt_labels=torch.from_numpy(labels).to(device), gt_masks=masks)
        draws = {k: torch.rand((b, n), generator=gen, device=device)
                 for k, n in (("rpn_pos", n_anchors), ("rpn_neg", n_anchors),
                              ("box_pos", n_props), ("box_neg", n_props))}
        pool.append((batch, draws))
    return pool


def infer_pool(traffic, cfg, seed, device):
    """[batch] * traffic["pool"] of host (pinned, where there is a card)
    uint8 batches: images [B, H, W, 3] (zero padded), image_sizes [B, 2]."""
    b, n = traffic["batch"], traffic["pool"]
    shapes = [tuple(x) for x in traffic["source_sizes"]]
    order_seed, dev_seed = sub_seeds(seed, 2)
    order = np.random.RandomState(order_seed).permutation(
        np.arange(n) % len(shapes))
    gen = torch.Generator(device=device).manual_seed(dev_seed)
    i = cfg["INPUT"]
    dims = []
    for k in order:
        h, w = resized_size(*shapes[k], i["MIN_SIZE_TEST"], i["MAX_SIZE_TEST"])
        dims.append(((h, w), padded(h, w, cfg["DATALOADER"]["SIZE_DIVISIBILITY"])))
    # one host buffer for the pool (pinned once, where there is a card)
    numel = max(b * ph * pw * 3 for _, (ph, pw) in dims)
    host = torch.empty((n, numel), dtype=torch.uint8,
                       pin_memory=torch.device(device).type == "cuda")
    pool = []
    for k, ((h, w), (ph, pw)) in enumerate(dims):
        images = torch.zeros((b, ph, pw, 3), dtype=torch.uint8, device=device)
        images[:, :h, :w] = torch.randint(0, 256, (b, h, w, 3), generator=gen, device=device,
                                          dtype=torch.uint8)
        view = host[k, :images.numel()].view(images.shape)
        view.copy_(images)
        pool.append(dict(images=view,
                         image_sizes=torch.tensor([[h, w]] * b, dtype=torch.int32)))
    return pool
