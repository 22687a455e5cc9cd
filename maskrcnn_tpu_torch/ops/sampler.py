"""Balanced positive/negative sampling with fixed shapes.

PyTorch counterpart of maskrcnn_tpu/ops/sampler.py (``top_k_fast``,
``sample_topk_indices``): every candidate gets a random priority, the
positives compete for the positive quota, the negatives fill the rest, and
exactly K indices come out, positives first, with validity masks.

The JAX package draws the priorities inside the function from a PRNG key.
Here the caller passes the uniform draws, one [..., N] tensor for the
positives and one for the negatives, so that a test can hand in the draws
JAX made and a training step can draw them from its own torch.Generator.
"""

import torch

NEG_INF = -1e10


def top_k_fast(x, k):
    """lax.top_k over the last axis: values descending, ties broken by the
    lower index. (The JAX package's top_k_fast gives the same values; its
    approximate-top-k route may order tied indices otherwise.)"""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def sample_topk_indices(labels, pos_draw, neg_draw, batch_size_per_image,
                        positive_fraction):
    """labels [..., N] int (>= 1 positive, 0 negative, -1 ignored), uniform
    draws pos_draw and neg_draw [..., N] in [0, 1).

    Returns (indices [..., K] int64, valid [..., K] bool, is_pos [..., K]
    bool), K = min(batch_size_per_image, N); invalid rows carry arbitrary
    indices."""
    n = labels.shape[-1]
    k_out = min(batch_size_per_image, n)
    num_pos_quota = min(int(batch_size_per_image * positive_fraction), k_out)
    neg_inf = torch.full_like(pos_draw, NEG_INF)
    pos_priority = torch.where(labels >= 1, pos_draw, neg_inf)
    neg_priority = torch.where(labels == 0, neg_draw, neg_inf)

    neg_vals, neg_idx = top_k_fast(neg_priority, k_out)
    real_neg = neg_vals > NEG_INF / 2
    if num_pos_quota > 0:
        pos_vals, pos_idx = top_k_fast(pos_priority, num_pos_quota)
        real_pos = pos_vals > NEG_INF / 2
        num_pos = real_pos.sum(dim=-1, keepdim=True)
        # real candidates in the bands (2, 3) and (1, 2), so one sort puts
        # the positives first; negatives rank-gated to their quota
        pos_vals = torch.where(real_pos, pos_vals + 2.0, torch.full_like(pos_vals, NEG_INF))
        rank = torch.arange(k_out, device=labels.device)
        neg_ok = (rank < batch_size_per_image - num_pos) & real_neg
        neg_vals = torch.where(neg_ok, neg_vals + 1.0, torch.full_like(neg_vals, NEG_INF))
        cand_vals = torch.cat([pos_vals, neg_vals], dim=-1)
        cand_idx = torch.cat([pos_idx, neg_idx], dim=-1)
    else:  # POSITIVE_FRACTION 0: negatives only
        cand_vals = torch.where(real_neg, neg_vals + 1.0, torch.full_like(neg_vals, NEG_INF))
        cand_idx = neg_idx
    top_p, sel = top_k_fast(cand_vals, k_out)
    idx = torch.gather(cand_idx, -1, sel)
    # >= : a positive drawn at exactly 0.0 has priority 2.0
    return idx, top_p > 0, top_p >= 2.0


def uniform_draws(shape, generator, device):
    """The (positive, negative) uniform draws of one sampling call."""
    return (torch.rand(shape, generator=generator, device=device),
            torch.rand(shape, generator=generator, device=device))
