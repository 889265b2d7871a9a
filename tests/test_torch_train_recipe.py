"""The port's training recipe pieces against ``tpu_unet``'s on the CPU: the
plain losses and f_score (``train/losses.py``), the lr schedules, the freeze
phase, and the configurations that raise instead of running a plain path
on the card."""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_unet.train import losses as jl
from tpu_unet.train import schedules as js
from tpu_unet_torch.models.registry import build_model, init_model
from tpu_unet_torch.train import losses as tl
from tpu_unet_torch.train import schedules as ts
from tpu_unet_torch.train import step as tstep

C = 5


def _logits_target(seed, size=(2, 8, 12)):
    rng = np.random.RandomState(seed)
    logits = rng.randn(*size, C).astype(np.float32) * 2
    target = rng.randint(0, C + 1, size).astype(np.int32)
    target[0, 0, :4] = 255
    return logits, target


@pytest.mark.parametrize("resize", [False, True])
def test_losses_match_jax(resize):
    """ce, focal, dice, f_score and deep supervision, with the align-corners
    resize when the logits are smaller than the target."""
    logits, target = _logits_target(0)
    if resize:
        logits = logits[:, ::2, ::2]
    cw = (1.0, 2.0, 0.5, 1.5, 1.0)
    jt, jlog = jnp.asarray(target), jnp.asarray(logits)
    joh = jnp.asarray(np.eye(C + 1, dtype=np.float32)[np.minimum(target, C)])
    tt, tlog = torch.from_numpy(target), torch.from_numpy(logits)
    toh = tl.one_hot(tt, C)
    np.testing.assert_array_equal(toh.numpy(), np.asarray(joh))
    pairs = [(tl.ce_loss(tlog, tt, cw, C), jl.ce_loss(jlog, jt, cw, C)),
             (tl.focal_loss(tlog, tt, cw, C), jl.focal_loss(jlog, jt, cw, C)),
             (tl.dice_loss(tlog, toh), jl.dice_loss(jlog, joh)),
             (tl.f_score(tlog, toh), jl.f_score(jlog, joh)),
             (tl.deep_supervision_loss([tlog, tlog * 0.5], tt, toh, cw, C, True, True),
              jl.deep_supervision_loss([jlog, jlog * 0.5], jt, joh, cw, C, True, True))]
    for a, b in pairs:
        assert abs(a.item() - float(b)) <= 1e-5 * max(abs(float(b)), 1e-6)


def test_schedules_match_jax():
    for kind in ("cos", "step"):
        a = ts.get_lr_scheduler(kind, 1e-3, 1e-5, 100)
        b = js.get_lr_scheduler(kind, 1e-3, 1e-5, 100)
        assert [a(e) for e in range(100)] == [b(e) for e in range(100)]
    for opt in ("adam", "sgd"):
        for bs in (2, 16, 96):
            assert ts.adaptive_lr(1e-2, 1e-4, bs, opt) == js.adaptive_lr(1e-2, 1e-4, bs, opt)


def _batch(seed, size=32):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (2, size, size, 3)).astype(np.uint8),
            "label": rng.integers(0, 4, (2, size, size)).astype(np.int32)}


def test_freeze_phase_leaves_backbone_bit_unchanged():
    """In the freeze phase ``vgg.*`` gets no update and no decay; the rest
    moves."""
    net = init_model(build_model("unet_vgg", 4), seed=0)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    opt = tstep.make_optimizer(net, "sgd", 0.9, 1e-2, tstep.FREEZE_PREFIXES["unet_vgg"])
    state = tstep.TrainState(net, opt)
    fn = tstep.make_train_step(net, tstep.StepConfig(4, (1.0,) * 4, use_dice=True))
    for i in range(2):
        state, _ = fn(state, _batch(i), 1e-2)
    for k, v in net.state_dict().items():
        if k.startswith("vgg."):
            assert torch.equal(v, before[k]), k
    assert not torch.equal(net.final.weight, before["final.weight"])
    assert not torch.equal(net.up_concat1.conv1.weight, before["up_concat1.conv1.weight"])


def test_plain_route_trains_focal_and_self_net():
    """On the CPU the recipes without kernels run through the plain
    versions: focal with unet_vgg, and self_net (the up_conv head)."""
    for model, focal in (("unet_vgg", True), ("self_net", False)):
        net = init_model(build_model(model, 4), seed=0)
        state = tstep.TrainState(net, tstep.make_optimizer(net))
        fn = tstep.make_train_step(net, tstep.StepConfig(4, (1.0,) * 4, use_focal=focal,
                                                         use_dice=True))
        _, m = fn(state, _batch(0), 1e-4)
        assert torch.isfinite(m["loss"]) and 0 <= m["f_score"].item() <= 1
        assert all(p.grad is not None for p in net.parameters())


@pytest.mark.parametrize("case", ["focal", "self_net", "f32", "batch_norm", "aux", "resnet50",
                                  "f32_up_conv", "f32_resnet50", "f32_datab"])
def test_unported_configurations_raise(case):
    """On the card: deep supervision raises.  Focal (#25/#26), batch norm
    in train mode (the DataB slice), the up_conv head (self_net, #12) in
    bf16, unet_resnet50 (its ResNet50 in train mode), and float32 on both
    training routes for unet_vgg, self_net and unet_resnet50 (the float32
    instantiations, the up_conv head's #10 / #12 among them) and for a
    DataB model (``traditional``: cuDNN and the logit-level loss, which
    takes float32 logits) are ported: they pass on both devices."""
    bf = torch.bfloat16
    model, cfg = "unet_vgg", tstep.StepConfig(4, (1.0,) * 4, compute_dtype=bf)
    if case == "focal":
        cfg = tstep.StepConfig(4, (1.0,) * 4, use_focal=True, compute_dtype=bf)
    elif case == "self_net":
        model = "self_net"
    elif case == "f32":
        cfg = tstep.StepConfig(4, (1.0,) * 4)
    elif case == "f32_up_conv":
        model, cfg = "self_net", tstep.StepConfig(4, (1.0,) * 4)
    elif case == "f32_resnet50":
        model, cfg = "unet_resnet50", tstep.StepConfig(4, (1.0,) * 4, use_dice=True)
    elif case == "f32_datab":
        model = "traditional"
        cfg = tstep.StepConfig(4, (1, 15, 0, 0), use_focal=True, use_dice=True)
    elif case == "batch_norm":
        model = "traditional"
        cfg = tstep.StepConfig(4, (1, 15, 0, 0), use_focal=True, use_dice=True, compute_dtype=bf)
    elif case == "aux":
        cfg = tstep.StepConfig(4, (1.0,) * 4, aux_weights=(1.0, 0.4), compute_dtype=bf)
    else:
        model = "unet_resnet50"
    net = build_model(model, 4)
    if case in ("focal", "batch_norm", "self_net", "resnet50"):
        for dev in ("cuda", "cpu"):
            tstep.check_ported(net, cfg, torch.device(dev))
        return
    if case.startswith("f32"):
        assert cfg.compute_dtype == torch.float32
        for dev, route in itertools.product(("cuda", "cpu"), tstep.TRAIN_ROUTES):
            tstep.check_ported(net, dataclasses.replace(cfg, train_route=route),
                               torch.device(dev))
        return
    with pytest.raises(NotImplementedError, match="deep supervision"):
        tstep.check_ported(net, cfg, torch.device("cuda"))
    # the same model and recipe run on the CPU
    tstep.check_ported(net, cfg, torch.device("cpu"))
    ok = tstep.StepConfig(4, (1.0,) * 4, use_dice=True, compute_dtype=bf)
    tstep.check_ported(build_model("unet_vgg", 4), ok, torch.device("cuda"))
    # a compute dtype that has no kernel instantiation raises on the card
    with pytest.raises(NotImplementedError, match="bf16 or float32"):
        tstep.check_ported(build_model("unet_vgg", 4),
                           tstep.StepConfig(4, (1.0,) * 4, compute_dtype=torch.float16),
                           torch.device("cuda"))
