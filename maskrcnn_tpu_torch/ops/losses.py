"""Loss functions: smooth-L1, sigmoid focal loss, masked softmax
cross-entropy, binary cross-entropy with logits.

PyTorch counterpart of maskrcnn_tpu/ops/losses.py. Reductions are the
callers' explicit masked sums, as in the JAX package. The focal loss is
plain torch, as it is plain jnp there (the original maskrcnn-benchmark's
CUDA SigmoidFocalLoss has no counterpart among the TPU kernels).
"""

import torch
import torch.nn.functional as F

from ..utils import comm


def smooth_l1_loss(input, target, beta=1.0 / 9):
    """Elementwise beta-parameterised Huber loss."""
    n = (input - target).abs()
    return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)


def sigmoid_focal_loss(logits, targets, gamma=2.0, alpha=0.25):
    """Elementwise focal loss. logits [..., C] for classes 1..C; targets
    [...] int: 0 background, 1..C a class, -1 ignored (no loss). Returns
    [..., C]; the caller sums and normalises."""
    c = logits.shape[-1]
    classes = torch.arange(1, c + 1, dtype=targets.dtype, device=targets.device)
    t = targets[..., None]
    p = torch.sigmoid(logits)
    # log(p) = -softplus(-x), log(1 - p) = -softplus(x)
    term_pos = (1.0 - p) ** gamma * -F.softplus(-logits)
    term_neg = p ** gamma * -F.softplus(logits)
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    return torch.where(t == classes, -alpha * term_pos,
                       torch.where((t != classes) & (t >= 0), -(1.0 - alpha) * term_neg, zero))


def softmax_cross_entropy(logits, labels, mask=None):
    """Mean cross-entropy over the masked rows. logits [N, C], labels [N]
    int (clamped into range; masked-out rows may carry -1). In a process
    group the masked rows are counted over every process (the global
    batch's mean)."""
    log_probs = F.log_softmax(logits, dim=-1)
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    nll = -log_probs.gather(-1, safe[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.to(logits.dtype)
    return (nll * mask).sum() / comm.global_sum(mask.sum()).clamp(min=1.0)


def binary_cross_entropy_with_logits(logits, targets):
    """Elementwise BCE with logits: softplus(x) - x * t."""
    return F.softplus(logits) - logits * targets
