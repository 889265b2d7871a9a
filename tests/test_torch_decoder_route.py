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
  ``unetup_train`` (one #13 ``unetup_bwd``), up2-up4 plain."""
import numpy as np
import pytest
import torch

from tpu_unet_torch.kernels import decoder_fuse, encoder_train
from tpu_unet_torch.models import backbones
from tpu_unet_torch.models.registry import build_model, init_model
from tpu_unet_torch.nn import blocks
from tpu_unet_torch.train import step as tstep

WRAPPED = {blocks: ("unetup_train_full", "unetup_train", "unetup_plain"),
           decoder_fuse: ("unetup_bwd_full", "unetup_bwd"),
           backbones: ("vgg_stem_train", "vgg_block_train", "vgg_stem_plain", "vgg_block_plain"),
           encoder_train: ("vgg_stem_bwd", "vgg_block_bwd")}
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


def _step(route, focal=False):
    net = init_model(build_model("unet_vgg", 4), seed=0)
    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(0, 256, (1, 128, 128, 3)).astype(np.uint8),
             "label": rng.integers(0, 4, (1, 128, 128)).astype(np.int32)}
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
