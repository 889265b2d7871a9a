"""The port's unet_vgg train step against ``tpu_unet``'s, on the CPU in
float32: JAX with the kernel configuration of the training slice forced
(fused loss, fused decoder, fused train on, paired train off; the Pallas
kernels in interpret mode), the port through the plain versions of #27,
#29 and #13 (``train_route="fused"``) and of #27, #29, #14-#19 and the
training encoder #2 / #20-#24 (``"paired"``, the default).  JAX's FUSED_TRAIN and PAIRED_TRAIN
configurations compute the same math (JAX's own
``test_paired_train_head_end_to_end`` holds the paired one to the natural
composition); running JAX's paired step itself would add its interpret-mode
stem kernel #20 (``tests/test_torch_encoder_train.py`` holds the port's
encoder to the references JAX's encoder VJPs are held to), so both port routes are held to JAX's one step, computed
once (``jax_step``).  Weights are carried across by the bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_unet.core import fusion
from tpu_unet.kernels.loss import final_ce_dice_loss_grad
from tpu_unet.models.registry import build_model as jbuild
from tpu_unet.models.registry import init_model as jinit
from tpu_unet.train import step as jstep
from tpu_unet_torch.infer.convert import state_dict_from_flax
from tpu_unet_torch.models.registry import build_model
from tpu_unet_torch.train import step as tstep

SIZE, B, C = 64, 2, 21
CW = tuple(1.0 + 0.05 * i for i in range(C))
LR = 1e-3


def _batch(seed):
    rng = np.random.default_rng(seed)
    lbl = rng.integers(0, C + 1, (B, SIZE, SIZE)).astype(np.int32)
    lbl[:, :2] = 255  # a raw VOC border: the ignore class
    return {"image": rng.integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8),
            "label": lbl}


@pytest.fixture(scope="module")
def kernel_config():
    """JAX's training-slice configuration (TPU_UNET_FUSED_LOSS=1
    TPU_UNET_FUSED_TRAIN=1 TPU_UNET_PAIRED_TRAIN=0), reset afterwards."""
    fusion.set_fused_loss(True)
    fusion.set_fused_decoder(True)
    fusion.set_fused_train(True)
    fusion.set_paired_train(False)
    try:
        model = jbuild("unet_vgg", C)
        variables = jax.tree_util.tree_map(np.asarray, jinit(model, (SIZE, SIZE), seed=0,
                                                             train=True))
        yield model, variables
    finally:
        for setter in (fusion.set_fused_loss, fusion.set_fused_decoder,
                       fusion.set_fused_train, fusion.set_paired_train):
            setter(None)


# the batch of the one step both routes are held to: PyTorch's and XLA's
# float32 encoder forwards differ by ~1e-6 of the scale, so a decoder
# pre-activation that close to 0 takes another ReLU mask in each, and every
# gradient above it moves by up to a few 1e-3 on both routes alike (at
# _batch(0), 2 of up2's conv1; at _batch(5), one of up1's).  _batch(1) has
# none: there the paired route's decoder and final gradients lie within
# 2.2e-6 of JAX's.
STEP_BATCH = 1


@pytest.fixture(scope="module")
def jax_step(kernel_config):
    """JAX's loss, f_score and gradients of one step on
    ``_batch(STEP_BATCH)`` in the kernel configuration, and the loss
    ``make_train_step`` reports."""
    model, variables = kernel_config
    batch = _batch(STEP_BATCH)
    feat_model = model.clone(features_out=True)
    imgs, target, _ = jstep._prepare_batch(jax.tree_util.tree_map(jnp.asarray, batch), C,
                                           jnp.float32)

    def loss_fn(params):
        feats, _ = feat_model.apply({"params": params, "batch_stats": {}}, imgs, True,
                                    rngs={"dropout": jax.random.PRNGKey(0)},
                                    mutable=["batch_stats"])
        return final_ce_dice_loss_grad(feats, params["final"]["kernel"],
                                       params["final"]["bias"], target, CW, C,
                                       with_dice=True)

    (jloss, jfs), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    tx = jstep.make_optimizer("adam", 0.9)
    jstate = jstep.create_train_state(model, variables, tx)
    _, metrics = jstep.make_train_step(model, jstep.StepConfig(
        num_classes=C, cls_weights=CW, use_dice=True))(jstate, batch, LR,
                                                       jax.random.PRNGKey(0))
    return (float(jloss), float(jfs), float(metrics["loss"]),
            state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads)))


def _port(variables):
    net = build_model("unet_vgg", C)
    net.load_state_dict(state_dict_from_flax(variables), strict=True)
    return net


def _cfg(**kw):
    return tstep.StepConfig(num_classes=C, cls_weights=CW, use_dice=True, **kw)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# the gradients the slice's kernels produce: #29 (final) and #13 with its
# weight gradients (up1)
KERNEL_GRADS = ("final.", "up_concat1.")


def _port_step(variables, route):
    """The port's step on ``_batch(STEP_BATCH)``: (loss, f_score,
    gradients)."""
    net = _port(variables)
    state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9))
    _, m = tstep.make_train_step(net, _cfg(train_route=route))(
        state, _batch(STEP_BATCH), LR)
    return m["loss"].item(), m["f_score"].item(), dict(net.named_parameters())


def test_train_step_matches_jax_kernel_config(kernel_config, jax_step):
    """Loss, f_score and the gradients of the kernels' parameters within
    1e-4 relative of JAX's step in the kernel configuration (its loss is
    make_train_step's).  The gradients above them run through PyTorch's
    and XLA's float32 convolutions, whose forwards differ by ~3e-6 of the
    scale at up3 (their summation order): that may flip the ReLU mask of
    the few pre-activations within 1e-6 of 0 (2 of 262,144 at up2's conv1
    on ``_batch(0)``) and move a channel's gradient sum by up to a few
    1e-3, while JAX's own two configurations (fused and plain) agree within
    6e-7.  Those gradients are held at a cosine of 0.99999 and 5e-3
    relative."""
    _, variables = kernel_config
    jloss, jfs, jstep_loss, ref = jax_step
    np.testing.assert_allclose(jstep_loss, jloss, rtol=1e-6)
    loss, fs, params = _port_step(variables, "fused")
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)
    assert abs(fs - jfs) <= 1e-4 * abs(jfs)
    assert set(ref) == set(params)
    for k, v in ref.items():
        g, r = params[k].grad.numpy().ravel(), v.numpy().ravel()
        if k.startswith(KERNEL_GRADS):
            assert _rel(g, r) <= 1e-4, (k, _rel(g, r))
        else:
            cos = float(g @ r / (np.linalg.norm(g) * np.linalg.norm(r)))
            assert cos >= 0.99999 and _rel(g, r) <= 5e-3, (k, cos, _rel(g, r))


def test_paired_route_matches_jax_step(kernel_config, jax_step):
    """The default ``"paired"`` route (at 64² the stem and blocks 2-3
    through the training encoder's plain backward, up1-up3 through the whole
    stage backward; block 4-5 and up4, untileable at 8x8 and below, plain)
    against the same JAX step: loss and f_score
    within 1e-4, every decoder and final gradient within 1e-4 relative (on
    a batch without a decoder ReLU near-tie, see ``STEP_BATCH``), the
    encoder (PyTorch's and XLA's float32 convolutions under autograd, as
    above) at a cosine of 0.99999 and 5e-3 relative."""
    _, variables = kernel_config
    jloss, jfs, _, ref = jax_step
    loss, fs, params = _port_step(variables, "paired")
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)
    assert abs(fs - jfs) <= 1e-4 * abs(jfs)
    assert set(ref) == set(params)
    for k, v in ref.items():
        g, r = params[k].grad.numpy().ravel(), v.numpy().ravel()
        if not k.startswith("vgg."):
            assert _rel(g, r) <= 1e-4, (k, _rel(g, r))
        else:
            cos = float(g @ r / (np.linalg.norm(g) * np.linalg.norm(r)))
            assert cos >= 0.99999 and _rel(g, r) <= 5e-3, (k, cos, _rel(g, r))


def test_fused_route_matches_plain_autograd(kernel_config):
    """Every gradient of the port's fused route (#27 / #29 and up1 through
    #13) within 1e-4 relative of autograd of the plain composition (up1 by
    ``unetup_plain``, logits, ``ce_loss`` + ``dice_loss``) on the same
    forward."""
    from tpu_unet_torch.kernels.decoder_fuse import unetup_plain
    from tpu_unet_torch.train.losses import ce_loss, dice_loss, one_hot

    _, variables = kernel_config
    batch = _batch(1)
    net = _port(variables)
    state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9))
    tstep.make_train_step(net, _cfg(train_route="fused"))(state, batch, 0.0)
    fused = {k: p.grad.clone() for k, p in net.named_parameters()}

    plain = _port(variables)
    x = torch.from_numpy(batch["image"]).float() / 255.0
    target = torch.from_numpy(batch["label"]).long()
    feats = plain.vgg(x, True, "fused")
    up = feats[4]
    for i, skip in zip((4, 3, 2, 1), feats[3::-1]):
        m = getattr(plain, f"up_concat{i}")
        up = unetup_plain(skip, up, m.conv1.weight, m.conv1.bias, m.conv2.weight,
                          m.conv2.bias)
    logits = up @ plain.final.weight.reshape(C, -1).t() + plain.final.bias
    (ce_loss(logits, target, CW, C) + dice_loss(logits, one_hot(target, C))).backward()
    for k, p in plain.named_parameters():
        assert _rel(fused[k].numpy(), p.grad.numpy()) <= 1e-4, k


@pytest.mark.parametrize("opt,wd", [("adam", 0.0), ("sgd", 1e-4)])
def test_two_steps_match_jax(kernel_config, opt, wd):
    """Parameters after two steps of Adam, and of nesterov SGD with weight
    decay, against JAX's.  SGD within 1e-6 absolute.  Adam moves an element
    whose gradient is at the noise level by ±lr whatever its size, so two
    steps may put such an element up to 2·lr per step away (measured: 19
    elements of 24.9M beyond lr after step 1, up_concat2's conv1 behind the
    ReLU near-ties of the test above); the mean distance stays under
    lr / 100."""
    model, variables = kernel_config
    cfg = jstep.StepConfig(num_classes=C, cls_weights=CW, use_dice=True)
    tx = jstep.make_optimizer(opt, 0.9, weight_decay=wd)
    jstate = jstep.create_train_state(model, variables, tx)
    jfn = jstep.make_train_step(model, cfg)
    net = _port(variables)
    state = tstep.TrainState(net, tstep.make_optimizer(net, opt, 0.9, wd))
    fn = tstep.make_train_step(net, _cfg(train_route="fused"))
    for i in range(2):
        jstate, jm = jfn(jstate, _batch(i), LR, jax.random.PRNGKey(i))
        state, m = fn(state, _batch(i), LR)
        if i == 0:  # from the same weights
            assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-4 * abs(float(jm["loss"]))
    ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    d = torch.cat([(p.detach() - ref[k]).abs().reshape(-1) for k, p in net.named_parameters()])
    if opt == "sgd":
        assert d.max().item() <= 1e-6, d.max().item()
    else:
        assert d.max().item() <= 2 * LR * 2 and d.mean().item() <= LR / 100, \
            (d.max().item(), d.mean().item())


@pytest.mark.parametrize("route", tstep.TRAIN_ROUTES)
def test_f32_card_arithmetic_step_matches_jax(kernel_config, jax_step, route):
    """(c) The float32 step the card runs (``check_ported`` lets unet_vgg
    through on the card in float32, both routes), here on the CPU with
    every kernel's TF32 arithmetic emulated (``kernels/tf32.py::
    emulated_plain_versions``: truncated activations, rounded weights,
    rounded weight-gradient operands, float64 sums): loss, f_score and
    every gradient against JAX's float32 step.  The readings times 4 lie
    within the bounds that ``chip_smoke.py`` holds the card's float32 step
    to against a plain float32 step (``kernels/tf32.py``:
    STEP_LOSS_REL_TOL, STEP_GRAD_REL_TOL, STEP_GRAD_COS); the loss's bound
    is fixed by the same emulation at the card's shape, which
    ``chip_smoke.py`` reads on the card in each run."""
    from tpu_unet_torch.kernels import tf32

    _, variables = kernel_config
    jloss, jfs, _, ref = jax_step
    tstep.check_ported(_port(variables), _cfg(train_route=route), torch.device("cuda"))
    with tf32.emulated_plain_versions():
        loss, fs, params = _port_step(variables, route)
    worst_rel, worst_cos = 0.0, 1.0
    for k, v in ref.items():
        g, r = params[k].grad.numpy().ravel(), v.numpy().ravel()
        worst_rel = max(worst_rel, _rel(g, r))
        worst_cos = min(worst_cos, float(g @ r / (np.linalg.norm(g) * np.linalg.norm(r))))
    lrel = abs(loss - jloss) / abs(jloss)
    print(route, {"loss": lrel, "f_score": abs(fs - jfs), "grad_rel": worst_rel,
                  "grad_1-cos": 1 - worst_cos})
    assert lrel * 4 <= tf32.STEP_LOSS_REL_TOL
    assert worst_rel * 4 <= tf32.STEP_GRAD_REL_TOL
    assert (1 - worst_cos) * 4 <= 1 - tf32.STEP_GRAD_COS
    if route != "paired":
        return
    # the kind of batch the card's check trains on (chip_smoke.rect_batch:
    # a rectangle on a uniform gray field), where the TF32 errors of the
    # many equal pixels do not average out: the emulated step against the
    # port's plain float32 step, as the card's check reads it (the routes
    # read alike; the paired one)
    rect = _rect_batch(7)
    net = _port(variables)
    state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9))
    _, pm = tstep.make_train_step(net, _cfg(train_route=route))(state, rect, LR)
    plain = {k: p.grad.clone() for k, p in net.named_parameters()}
    net = _port(variables)
    state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9))
    with tf32.emulated_plain_versions():
        _, em = tstep.make_train_step(net, _cfg(train_route=route))(state, rect, LR)
    rlrel = abs(em["loss"].item() - pm["loss"].item()) / abs(pm["loss"].item())
    rrel = max(_rel(p.grad.numpy(), plain[k].numpy()) for k, p in net.named_parameters())
    print(route, "rectangles", {"loss": rlrel, "grad_rel": rrel})
    assert rlrel * 4 <= tf32.STEP_LOSS_REL_TOL
    assert rrel * 4 <= tf32.STEP_GRAD_REL_TOL


def _rect_batch(seed):
    """A batch like ``chip_smoke.rect_batch``'s: each image a rectangle of
    its class's colour on a gray field, labelled inside, 0 outside, a
    2-pixel 255 border."""
    rng = np.random.default_rng(seed)
    img = np.full((B, SIZE, SIZE, 3), 128, np.uint8)
    lbl = np.zeros((B, SIZE, SIZE), np.int32)
    palette = rng.integers(0, 256, (C, 3))
    for i in range(B):
        c = int(rng.integers(1, C))
        h, w = rng.integers(SIZE // 4, SIZE // 2, 2)
        y0, x0 = rng.integers(0, SIZE - h), rng.integers(0, SIZE - w)
        img[i, y0:y0 + h, x0:x0 + w] = palette[c]
        lbl[i, y0:y0 + h, x0:x0 + w] = c
    lbl[:, :2], lbl[:, -2:], lbl[:, :, :2], lbl[:, :, -2:] = 255, 255, 255, 255
    return {"image": img, "label": lbl}

