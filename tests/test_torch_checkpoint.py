"""The port's checkpoints (maskrcnn_tpu_torch/utils/checkpoint.py).

* Save, load and resume: model, optimizer and scheduler state come back
  exactly; the extras (the iteration) are returned; ``last_checkpoint``
  names the newest file and wins over the file given to ``load``; entries
  whose shape does not match keep the model's own values.
* A ``.npz`` written by the JAX package's DetectronCheckpointer for the
  narrow test model, loaded by the port, gives ``infer_forward`` detections
  equal to the JAX model's at the tolerances of tests/test_torch_detector.py
  (labels and validity exact, scores 1e-5, boxes 1e-3 px, masks 1e-4);
  a catalog:// name that is not in the cache and a missing .pkl raise.
"""

import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tpu.models import build_detection_model as build_jax_model
from maskrcnn_tpu.utils.checkpoint import DetectronCheckpointer as JaxCheckpointer
from maskrcnn_tpu_torch.models import build_detection_model
from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer
from maskrcnn_tpu_torch.utils.checkpoint import Checkpointer, DetectronCheckpointer
from torch_port_fixtures import configs, numpy_params, train_batch


def _trainable(seed):
    _, c = configs()
    c.SOLVER.BASE_LR = 0.01
    model = build_detection_model(c, device="cpu", seed=seed)
    optimizer = make_optimizer(c, model)
    return c, model, optimizer, make_lr_scheduler(c, optimizer)


def _state(model, optimizer, scheduler):
    return model.state_dict(), optimizer.state_dict(), scheduler.state_dict()


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def test_save_load_resume_round_trip(tmp_path):
    c, model, optimizer, scheduler = _trainable(seed=0)
    batch = {k: torch.from_numpy(v) for k, v in train_batch(b=1, h=96, w=128).items()}
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):  # momentum buffers and a scheduler count to save
        optimizer.zero_grad()
        sum(model.train_forward(batch, generator=gen).values()).backward()
        optimizer.step()
        scheduler.step()
    saver = Checkpointer(model, optimizer, scheduler, str(tmp_path), save_to_disk=True)
    saver.save("model_0000002", iteration=2)
    with open(tmp_path / "last_checkpoint") as f:
        assert f.read() == str(tmp_path / "model_0000002.pth")
    saved = _state(model, optimizer, scheduler)

    _, model2, optimizer2, scheduler2 = _trainable(seed=1)
    assert not torch.equal(model2.state_dict()["rpn.conv.weight"],
                           saved[0]["rpn.conv.weight"])
    loader = Checkpointer(model2, optimizer2, scheduler2, str(tmp_path))
    assert loader.has_checkpoint()
    # the resume tag wins over the file given
    extra = loader.load(str(tmp_path / "elsewhere.pth"))
    assert extra == {"iteration": 2}
    _assert_same(_state(model2, optimizer2, scheduler2), saved)
    assert optimizer2.param_groups[0]["lr"] == optimizer.param_groups[0]["lr"]

    # no tag and no file: nothing loaded
    empty = tmp_path / "empty"
    assert Checkpointer(model2, save_dir=str(empty)).load() == {}
    # a .pth of weights only (MODEL.WEIGHT): the model, no extras; entries
    # whose shape differs keep the model's own values
    weights = saved[0].copy()
    weights["roi_heads.box.predictor.cls_score.weight"] = torch.zeros(3, 3)
    torch.save({"model": weights}, tmp_path / "weights.pth")
    _, model3, _, _ = _trainable(seed=2)
    own = model3.state_dict()["roi_heads.box.predictor.cls_score.weight"].clone()
    assert Checkpointer(model3, save_dir="").load(str(tmp_path / "weights.pth")) == {}
    assert torch.equal(model3.state_dict()["rpn.conv.weight"], saved[0]["rpn.conv.weight"])
    assert torch.equal(model3.state_dict()["roi_heads.box.predictor.cls_score.weight"], own)


def test_jax_npz_checkpoint_loads_into_the_port(tmp_path, monkeypatch):
    jcfg, tcfg = configs()
    jm = build_jax_model(jcfg)
    params = numpy_params(jm, seed=0)
    JaxCheckpointer(jcfg, save_dir=str(tmp_path), save_to_disk=True).save(
        "model_final", params, iteration=5)
    path = os.path.join(str(tmp_path), "model_final.npz")
    assert os.path.exists(path)

    model = build_detection_model(tcfg, device="cpu", seed=3)
    ck = DetectronCheckpointer(tcfg, model, save_dir="")
    assert ck.load(path) == {}
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (2, 128, 160, 3)).astype(np.uint8)
    sizes = np.array([[128, 160], [112, 136]], np.int32)
    want = jax.jit(jm.infer_forward)(jax.tree.map(jnp.asarray, params),
                                     {"images": jnp.asarray(images),
                                      "image_sizes": jnp.asarray(sizes)})
    got = model.infer_forward({"images": torch.from_numpy(images),
                               "image_sizes": torch.from_numpy(sizes)})
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert want["valid"].sum() >= 8
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["masks"], want["masks"], rtol=1e-4, atol=1e-4)

    # catalog:// names and .pkl files load (tests/test_torch_weights.py); a
    # catalog name missing from the cache, without a network, raises naming
    # where to place the file, and a missing .pkl raises
    monkeypatch.setenv("MASKRCNN_TPU_CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(urllib.request, "urlretrieve", _no_network)
    with pytest.raises(RuntimeError, match="place it at"):
        ck.load("catalog://ImageNetPretrained/MSRA/R-50")
    with pytest.raises(FileNotFoundError):
        ck.load(str(tmp_path / "model.pkl"))


def _no_network(*args, **kwargs):
    raise urllib.error.URLError("no network in the tests")
