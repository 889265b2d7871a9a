"""The canonical UNet's two training routes (``StepConfig.train_route``)
reach the functions they should.  The launch counts stay 0 on the CPU, so
the stage functions ``models/backbones.py`` and ``nn/blocks.py`` call and
the backward wrappers ``kernels/encoder_train.py`` and
``kernels/decoder_fuse.py`` call are wrapped with counters:

- ``"paired"`` (JAX's ``PAIRED_TRAIN=1``, the default): every stage the
  kernels tile trains through its training kernels — at 128² the stem and
  blocks 2-4 through ``vgg_stem_train`` / ``vgg_block_train`` (one
  ``vgg_stem_bwd`` / ``vgg_block_bwd`` each in the backward), block 5
  (8x8, no multiple of 16 wide) plain, all four decoder stages through
  ``unetup_train_full`` (four ``unetup_bwd_full``), whatever the loss;
- ``"fused"`` (``FUSED_TRAIN=1``): the encoder plain, up1 →
  ``unetup_train`` (one #13 ``unetup_bwd``), up2-up4 plain.

The ``up_conv`` head of ``unet_resnet50`` and ``self_net`` trains through
``upconv_train`` (one #12 ``upconv_bwd``) under ``"paired"`` and through
``upconv_plain`` under ``"fused"``; ResNet50 trains plain on both."""
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch

from tpu_unet_torch.kernels import decoder_fuse, encoder_train, upconv
from tpu_unet_torch.models import backbones, unet
from tpu_unet_torch.models.registry import build_model, init_model
from tpu_unet_torch.nn import blocks
from tpu_unet_torch.train import step as tstep

WRAPPED = {blocks: ("unetup_train_full", "unetup_train", "unetup_plain"),
           decoder_fuse: ("unetup_bwd_full", "unetup_bwd"),
           backbones: ("vgg_stem_train", "vgg_block_train", "vgg_stem_plain", "vgg_block_plain"),
           encoder_train: ("vgg_stem_bwd", "vgg_block_bwd"),
           unet: ("upconv_train", "upconv_plain"), upconv: ("upconv_bwd",)}
ENCODER_PAIRED = {"vgg_stem_train": 1, "vgg_block_train": 3, "vgg_block_plain": 1,
                  "vgg_stem_bwd": 1, "vgg_block_bwd": 3}


@pytest.fixture
def calls(monkeypatch):
    counts = {}

    def counting(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    for module, names in WRAPPED.items():
        for name in names:
            counting(module, name)
    return counts


def _step(route, focal=False, model="unet_vgg", size=128):
    net = init_model(build_model(model, 4), seed=0)
    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(0, 256, (1, size, size, 3)).astype(np.uint8),
             "label": rng.integers(0, 4, (1, size, size)).astype(np.int32)}
    cfg = tstep.StepConfig(4, (1.0,) * 4, use_focal=focal, use_dice=True, train_route=route)
    state = tstep.TrainState(net, tstep.make_optimizer(net))
    _, m = tstep.make_train_step(net, cfg)(state, batch, 1e-4)
    assert torch.isfinite(m["loss"])


@pytest.mark.parametrize("route,focal,expect", [
    ("paired", False, {**ENCODER_PAIRED, "unetup_train_full": 4, "unetup_bwd_full": 4}),
    ("paired", True, {**ENCODER_PAIRED, "unetup_train_full": 4, "unetup_bwd_full": 4}),
    ("fused", False, {"vgg_stem_plain": 1, "vgg_block_plain": 4, "unetup_train": 1,
                      "unetup_plain": 3, "unetup_bwd": 1}),
])
def test_routes_reach_their_functions(calls, route, focal, expect):
    _step(route, focal)
    assert calls == expect


@pytest.mark.parametrize("model,route,expect", [
    # at 256² every unet_resnet50 decoder stage tiles (up4 at 16x16)
    ("unet_resnet50", "paired", {"unetup_train_full": 4, "unetup_bwd_full": 4,
                                 "upconv_train": 1, "upconv_bwd": 1}),
    ("unet_resnet50", "fused", {"unetup_train": 1, "unetup_plain": 3, "unetup_bwd": 1,
                                "upconv_plain": 1}),
    ("self_net", "paired", {**ENCODER_PAIRED, "unetup_train_full": 4, "unetup_bwd_full": 4,
                            "upconv_train": 1, "upconv_bwd": 1}),
    ("self_net", "fused", {"vgg_stem_plain": 1, "vgg_block_plain": 4, "unetup_train": 1,
                           "unetup_plain": 3, "unetup_bwd": 1, "upconv_plain": 1}),
])
def test_head_models_reach_their_functions(calls, model, route, expect):
    """The two models with the ``up_conv`` head, each route: the head
    through ``upconv_train`` and its backward #12 (``"paired"``, JAX's
    ``fused_upconv_train``) or the plain composition (``"fused"``, JAX's
    ``reference_upconv`` under autodiff); the decoder and encoder as
    unet_vgg's."""
    _step(route, model=model, size=256 if model == "unet_resnet50" else 128)
    assert calls == expect


@pytest.mark.parametrize("model,fused", [("unet_vgg", True), ("unet_resnet50", True),
                                         ("self_net", False), ("traditional", False)])
def test_fused_loss_route_is_jax_feat_model_rule(model, fused):
    """The fused final-conv + loss (#27 / #29) takes a canonical UNet whose
    features come out at the target's size — unet_vgg, unet_resnet50 — as
    JAX's ``feat_model`` with ``_fused_shape_ok``; self_net's 2x logits take
    the plain losses; CE only (focal takes the logit-level loss)."""
    net = build_model(model, 4)
    cfg = tstep.StepConfig(4, (1.0,) * 4, use_dice=True)
    assert tstep._fused_route(net, cfg) == fused
    focal = tstep.StepConfig(4, (1.0,) * 4, use_focal=True)
    assert not tstep._fused_route(net, focal)


def test_default_route_is_paired():
    assert tstep.StepConfig(4, (1.0,) * 4).train_route == "paired"


def test_unknown_route_raises():
    with pytest.raises(ValueError, match="train_route"):
        tstep.StepConfig(4, (1.0,) * 4, train_route="wide")


@pytest.mark.parametrize("h,w,cs,cx,f,route", [
    (8, 16, 128, 256, 128, "full"), (8, 16, 64, 192, 128, "full"),
    (8, 16, 1024, 2048, 512, "full"), (4, 16, 64, 128, 64, "plain"),
    (8, 8, 64, 128, 64, "plain"), (8, 16, 4, 124, 64, "plain")])
def test_stage_gate_is_the_kernel_shape_rule(monkeypatch, h, w, cs, cx, f, route):
    """Under "paired" a decoder stage takes ``unetup_train_full`` exactly
    where the stage kernels tile it (``stage_shape_ok``: 2H % 8, 2W % 16,
    F % 64, (Cs + Cx) % 64, Cs % 8), on every device alike; JAX's gates
    (``_wide_train_ok``, ``deep_invalid``) are Mosaic layout rules the CUDA
    kernels do not have."""
    seen = []
    monkeypatch.setattr(blocks, "unetup_train_full", lambda *a: seen.append("full"))
    monkeypatch.setattr(blocks, "unetup_plain", lambda *a: seen.append("plain"))
    blocks.UnetUp(cs + cx, f)(torch.zeros(1, h, w, cs), torch.zeros(1, h // 2, w // 2, cx),
                              train=True)
    assert seen == [route]


@pytest.mark.parametrize("h,w,chans,route", [
    (8, 16, [64, 128, 128], "train"), (16, 16, [128, 256, 256, 256], "train"),
    (8, 8, [512, 512, 512, 512], "plain"), (4, 16, [64, 128, 128], "plain"),
    (8, 16, [32, 128, 128], "plain")])
def test_encoder_gate_is_the_kernel_shape_rule(h, w, chans, route):
    """A VGG block trains through its kernels where they tile it
    (``vgg_block_train_ok``: H % 8, W % 16, every width % 64)."""
    ok = encoder_train.vgg_block_train_ok(h, w, chans)
    assert ok == (route == "train")
