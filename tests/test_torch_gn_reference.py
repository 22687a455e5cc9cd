"""The port's GN Mask R-CNN with its group-norm mask head against the plain
float32 reference that decides the benchmark's `correct`
(benchmark/reference/mask_rcnn_gn.py), on the CPU: the GN mask head alone,
forward and gradients; configs/gn_baselines/e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.yaml
as written (ROI_MASK_HEAD.USE_GN on, which the JAX package ignores, so these
tests hold the port to the reference and not to JAX), its train_forward
losses and every gradient with the samplers' draws handed to both, its
detections and masks; and a training step's group norms (the calls of
models/layers.py:group_norm and the shapes they saw) against the counts
module's gn_calls and gn_bound_s (benchmark/counts/mask_rcnn_gn.py).

Narrow widths (torch_port_fixtures.narrow, as tests/test_torch_gn.py) with
NUM_GROUPS 2, so each group keeps 8-64 channels as the published widths do,
and the group norms at scale U(0.5, 1.5), bias U(-0.2, 0.2) (its
_spread_gn), the rest of the weights the port's own seeded init.

Tolerances: both sides compute in float32 and differ only in the order of
their sums (the port's statistics over the NHWC view, the reference's over
x.view(N, G, -1); the convolutions alike), each rounding by ~1e-7 of a
value. The mask head's output and gradients: 1e-5 of their tensor's
largest value, a hundred such roundings through five layers. The losses:
rtol 1e-5. The whole model's gradients: 2e-3 of a tensor's largest value,
the float32 spread of these models that tests/test_torch_gn.py measured.
A whole model's gradient is not smooth in its weights: a ReLU whose input
lies within rounding of 0 passes its element's gradient on one side and
not on the other, and a group norm's backward spreads that element over
its group. On the fixture's draw the two sides agree to 5e-6 of a
tensor's largest value; on others (the port's init at seeds 3, 11, 14 and
15) rounding flips such gates and moves gradients by 0.7-6%, as moving
each of the reference's own weights by 1e-7 of itself does (measured on
the CPU), so no tolerance there could tell the port from rounding: the
comparison keeps one draw on which it is sharp. Detections: labels and
validity exact, scores 1e-5, boxes 1e-3 px, masks 1e-4, as
tests/test_torch_detector.py holds the flagship.
"""

import os
import sys

import numpy as np
import pytest
import torch

from maskrcnn_tpu_torch.config import cfg as torch_defaults
from maskrcnn_tpu_torch.models import build_detection_model
from maskrcnn_tpu_torch.models import layers
from maskrcnn_tpu_torch.models.roi_heads.mask_head import MaskHead
from test_models import tiny
from torch_port_fixtures import narrow, one_torch_thread, train_batch  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmark.counts import mask_rcnn_gn as gn_counts  # noqa: E402
from benchmark.harness import traffic as gen  # noqa: E402
from benchmark.reference import mask_rcnn_gn as ref  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")
YAML = os.path.join(REPO, "configs", "gn_baselines", "e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.yaml")
LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg",
          "loss_mask")


def _configs():
    """(the port's CfgNode, the reference's nested dicts) of the file as
    written, at the narrow widths, two groups, float32."""
    c = torch_defaults.clone()
    c.merge_from_file(YAML)
    narrow(tiny(c))
    c.MODEL.WEIGHT = ""
    c.MODEL.DEVICE = "cpu"
    c.MODEL.GROUP_NORM.NUM_GROUPS = 2
    c.MODEL.ROI_BOX_HEAD.CONV_HEAD_DIM = 32
    assert c.MODEL.ROI_MASK_HEAD.USE_GN and c.MODEL.ROI_BOX_HEAD.USE_GN and c.MODEL.FPN.USE_GN
    return c, _plain(c)


def _plain(node):
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    return list(node) if isinstance(node, tuple) else node


def _spread_gn(module, seed):
    """Every group norm of `module` at scale U(0.5, 1.5), bias U(-0.2, 0.2)."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, layers.GroupNorm):
                m.scale.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, m.scale.shape[0])))
                m.bias.copy_(torch.from_numpy(rs.uniform(-0.2, 0.2, m.bias.shape[0])))


def _close_to_max(got, want, tol, name):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= tol * scale, (name, err, scale)


@pytest.fixture(scope="module")
def models():
    tcfg, rcfg = _configs()
    tm = build_detection_model(tcfg, device="cpu", seed=12)
    _spread_gn(tm, 13)
    rm = ref.MaskRCNN(rcfg)
    rm.load_state_dict(tm.state_dict(), strict=True)
    return tcfg, rcfg, tm.eval(), rm.eval()


def test_gn_mask_head_matches_the_reference():
    """MaskHead under ROI_MASK_HEAD.USE_GN: each conv without a bias, a
    group norm after it; its probabilities at each ROI's label and the
    training logits, with the gradients of its input and every leaf, equal
    the reference's."""
    tcfg, rcfg = _configs()
    head = MaskHead(tcfg, 32)
    head.reset_parameters(torch.Generator().manual_seed(5))
    _spread_gn(head, 6)
    convs = head.feature_extractor.convs
    assert all(b.conv.bias is None and isinstance(b.gn, layers.GroupNorm) for b in convs)
    assert all(b.gn.num_groups == 2 for b in convs)
    want_head = ref.MaskHead(rcfg, 32)
    want_head.load_state_dict(head.state_dict(), strict=True)
    rs = np.random.RandomState(7)
    pooled = torch.from_numpy(rs.randn(6, 14, 14, 32).astype(np.float32))
    labels = torch.tensor([1, 3, 0, 80, 7, 2])
    cot = torch.from_numpy(rs.randn(6, 28, 28).astype(np.float32))
    with torch.no_grad():
        _close_to_max(head(pooled, labels), want_head(pooled, labels), 1e-5, "probabilities")
    grads = []
    for h in (head, want_head):
        x = pooled.clone().requires_grad_()
        out = h.logits_at_class(x, labels)
        (out * cot).sum().backward()
        grads.append([out.detach(), x.grad] + [p.grad for _, p in sorted(h.named_parameters())])
    names = ["logits", "input"] + [n for n, _ in sorted(head.named_parameters())]
    assert sum(n.endswith(".gn.scale") for n in names) == 4
    for name, got, want in zip(names, *grads):
        _close_to_max(got, want, 1e-5, name)


def test_gn_train_forward_matches_the_reference(models):
    """train_forward of the file as written: the five losses and the
    gradient of every trainable leaf (the mask head's group norms among
    them) against the reference, the samplers' draws handed to both; the
    frozen stem and layer1 (FREEZE_CONV_BODY_AT 2) get none."""
    tcfg, rcfg, tm, rm = models
    nb = train_batch(b=2, h=128, w=160)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    n_anchors, n_props = gen.draw_counts((128, 160), rcfg)
    g = torch.Generator().manual_seed(8)
    draws = {k: torch.rand((2, n), generator=g) for k, n in (
        ("rpn_pos", n_anchors), ("rpn_neg", n_anchors), ("box_pos", n_props),
        ("box_neg", n_props))}
    tm.zero_grad(set_to_none=True)
    rm.zero_grad(set_to_none=True)
    got = tm.train_forward(batch, draws=draws)
    want = rm.train_forward(batch, draws, tcfg.TPU.MASK_ROI_CAP)
    assert tuple(got) == LOSSES and set(want) == set(LOSSES)
    for k in LOSSES:
        np.testing.assert_allclose(got[k].item(), want[k].item(), rtol=1e-5, err_msg=k)
    assert got["loss_box_reg"] > 0 and got["loss_mask"] > 0
    sum(got.values()).backward()
    sum(want.values()).backward()
    want_grads = dict(rm.named_parameters())
    trainable = gn = 0
    for name, p in tm.named_parameters():
        if name.startswith(("backbone.body.stem.", "backbone.body.layer1.")):
            assert not p.requires_grad and p.grad is None, name
            assert not want_grads[name].requires_grad, name
            continue
        trainable += 1
        gn += name.endswith(".scale")
        _close_to_max(p.grad, want_grads[name].grad, 2e-3, name)
    # group norms: res3-res5's 3 a block and their shortcuts', the FPN's 8,
    # the Xconv head's 4 and the mask head's 4
    assert gn == 3 * (4 + 6 + 3) + 3 + 8 + 4 + 4
    assert trainable > gn


def test_gn_infer_forward_matches_the_reference(models):
    _, _, tm, rm = models
    rs = np.random.RandomState(0)
    batch = {"images": torch.from_numpy(rs.randint(0, 256, (2, 128, 160, 3)).astype(np.uint8)),
             "image_sizes": torch.tensor([[128, 160], [112, 136]], dtype=torch.int32)}
    with torch.no_grad():
        got = tm.infer_forward(batch)
    want = rm.infer_forward(batch)
    assert set(got) == set(want) == {"boxes", "scores", "labels", "valid", "masks"}
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: v.numpy() for k, v in want.items()}
    assert want["valid"].sum() >= 8
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["masks"], want["masks"], rtol=1e-4, atol=1e-4)


def test_gn_step_counts_match_a_training_step(models, monkeypatch):
    """One training step of the port: its calls of layers.group_norm and
    those whose input carries a gradient equal the
    counts module's gn_calls and gn_calls_bwd, and the bytes of the shapes
    they saw, forward and backward, gn_bound_s at 3.35 TB/s."""
    tcfg, rcfg, tm, _ = models
    seen = []
    plain = layers.group_norm

    def recording(x, *args, **kwargs):
        seen.append((x.numel(), x.requires_grad))
        return plain(x, *args, **kwargs)

    monkeypatch.setattr(layers, "group_norm", recording)
    nb = train_batch(b=2, h=128, w=160)
    tm.train_forward({k: torch.from_numpy(v) for k, v in nb.items()},
                     generator=torch.Generator().manual_seed(9))
    counts = gn_counts.step_counts(rcfg, 2, (128, 160), True)
    assert len(seen) == counts["gn_calls"] == 69
    assert sum(bwd for _, bwd in seen) == counts["gn_calls_bwd"] == 58
    assert counts["gn_bound_s"] == pytest.approx(gn_counts.gn_bytes(rcfg, seen) / 3.35e12,
                                                 rel=1e-12)
    assert sorted(seen) == sorted(gn_counts.step(rcfg, 2, (128, 160), True).norms)
