"""The ``up_conv`` head's training path (``tpu_unet_torch/kernels/upconv.py``)
against the JAX package on the CPU, in float32: ``upconv_bwd_plain`` (the
plain version of #12's port) and ``upconv_train``'s gradients against
``fused_upconv_bwd_impl`` (#12) in interpret mode — called directly and
asserted not ``None``, so that ``reference_upconv``'s fallback in
``_t_bwd`` cannot stand in for the kernel — with JAX's column-paired
tensors unpaired by the free reshape; and the CUDA wrapper's shape rule."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_stage import rel_err

from tpu_unet.kernels.upconv import fused_upconv_bwd_impl, fused_upconv_impl
from tpu_unet_torch.kernels import launch_counts
from tpu_unet_torch.kernels.upconv import (_upconv_bwd_cuda, upconv_bwd, upconv_bwd_plain,
                                           upconv_train, upconv_train_ok)

# (B, H, W, Cx, F): x (B, H, W, Cx) → (B, 2H, 2W, F); both tile #12 (F < 128,
# 2H % 16, H % 8) and the port's kernel rule (2H % 8, 2W % 16, Cx, F % 64)
SHAPES = [(2, 8, 16, 64, 64), (1, 16, 16, 64, 64)]
NAMES = ("dx", "dk1", "db1", "dk2", "db2")
# float32 both sides, the same products summed in another order
TOL = 1e-5


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _case(B, H, W, Cx, F, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, Cx)).astype(np.float32)
    k1 = (rng.standard_normal((3, 3, Cx, F)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(F) * 0.1).astype(np.float32)
    k2 = (rng.standard_normal((3, 3, F, F)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(F) * 0.1).astype(np.float32)
    g = rng.standard_normal((B, 2 * H, 2 * W, F)).astype(np.float32)
    return (x, k1, b1, k2, b2), g


def _jax_bwd(args, g):
    """#12 in interpret mode on JAX's own forward's out and y1: (out, y1)
    unpaired and (dx, dk1 HWIO, db1, dk2 HWIO, db2)."""
    x, k1, b1, k2, b2 = (jnp.asarray(a) for a in args)
    fwd = fused_upconv_impl(x, k1, b1, k2, b2, want_y1=True)
    assert fwd is not None, "JAX up_conv forward kernel fell back"
    out_p, y1_p = fwd
    B, H2, W, F2 = out_p.shape
    res = fused_upconv_bwd_impl(jnp.asarray(g).reshape(B, H2, W, F2), out_p, y1_p, x, k1, k2)
    assert res is not None, "#12 refused the shape: reference_upconv would stand in"
    nat = (B, H2, 2 * W, F2 // 2)
    return (np.array(out_p).reshape(nat), np.array(y1_p).reshape(nat)), \
        [np.array(r) for r in res]


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def case(request):
    args, g = _case(*request.param, seed=sum(request.param))
    return args, g, *_jax_bwd(args, g)


def _assert_close(port, ref):
    errs = {}
    for name, p, r in zip(NAMES, port, ref):
        p = p.detach().numpy() if isinstance(p, torch.Tensor) else p
        if name in ("dk1", "dk2"):
            p = p.transpose(2, 3, 1, 0)  # OIHW → HWIO
        assert p.shape == r.shape, name
        errs[name] = rel_err(p, r)
    assert all(e <= TOL for e in errs.values()), errs


def test_upconv_bwd_plain_matches_jax_kernel(case):
    """The five outputs of the plain version on JAX's out and y1 within
    1e-5 of max |#12|, the weight and bias gradients in float32."""
    args, g, (out, y1), ref = case
    x, k1, _, k2, _ = args
    n = launch_counts["upconv_bwd"]
    res = upconv_bwd(torch.from_numpy(g), torch.from_numpy(out), torch.from_numpy(y1),
                     torch.from_numpy(x), _oihw(k1), _oihw(k2))
    assert launch_counts["upconv_bwd"] == n  # the CPU path launches nothing
    assert all(r.dtype == torch.float32 for r in res)
    _assert_close(res, ref)


def test_upconv_train_gradients_match_jax_kernel(case):
    """``upconv_train`` under autograd (its own plain forward keeping y1,
    the backward through ``upconv_bwd``) against #12's gradients."""
    args, g, _, ref = case
    t = [(_oihw(a) if a.ndim == 4 and i else torch.from_numpy(a)).requires_grad_()
         for i, a in enumerate(args)]
    out = upconv_train(*t)
    grads = torch.autograd.grad(out, t, torch.from_numpy(g))
    _assert_close(grads, ref)


def test_upconv_train_is_autograd_of_the_plain_head():
    """Forward equal to ``upconv_plain`` and gradients within 1e-5 of
    autograd of it, at a shape #12 does not take (F = 128)."""
    from tpu_unet_torch.kernels.upconv import upconv_plain

    args, g = _case(1, 4, 8, 64, 128, seed=3)
    t = [(_oihw(a) if a.ndim == 4 and i else torch.from_numpy(a)).requires_grad_()
         for i, a in enumerate(args)]
    out = upconv_train(*t)
    ref = upconv_plain(*t)
    assert torch.equal(out, ref)
    grads = torch.autograd.grad(out, t, torch.from_numpy(g))
    rgrads = torch.autograd.grad(ref, t, torch.from_numpy(g))
    for a, b in zip(grads, rgrads):
        assert rel_err(a.numpy(), b.numpy()) <= TOL


def test_plain_backward_is_the_stage_backward_at_no_skip():
    """The head's plain backward is the UnetUp stage backward with a
    zero-channel skip: with a skip of 8 channels whose weights are zero the
    stage's dx, conv1 up-channel and conv2 gradients are the head's (float32
    sums of the same products, the convs' algorithms free: within 1e-5)."""
    from tpu_unet_torch.kernels.decoder_train import unetup_bwd_full_plain

    (x, k1, _, k2, _), g = _case(1, 4, 8, 64, 64, seed=4)
    rng = np.random.default_rng(0)
    B, H2, W2, F = g.shape
    out = np.maximum(rng.standard_normal(g.shape), 0).astype(np.float32)
    y1 = np.maximum(rng.standard_normal(g.shape), 0).astype(np.float32)
    t = [torch.from_numpy(a) for a in (g, out, y1, x)]
    res = upconv_bwd_plain(*t, _oihw(k1), _oihw(k2))
    skip = torch.zeros((B, H2, W2, 8))
    w1 = torch.cat([torch.zeros((F, 8, 3, 3)), _oihw(k1)], dim=1)
    full = unetup_bwd_full_plain(*t[:3], skip, t[3], w1, _oihw(k2))
    pairs = zip(res, (full[1], full[2][:, 8:], *full[3:]))
    assert all(rel_err(a.numpy(), b.numpy()) <= TOL for a, b in pairs)


@pytest.mark.parametrize("h,w,cx,f", [(3, 8, 64, 64),    # 2H % 8
                                      (4, 4, 64, 64),    # 2W % 16
                                      (4, 8, 32, 64),    # Cx % 64 (the forward takes 32)
                                      (4, 8, 64, 32)])   # F % 64
def test_upconv_bwd_kernel_refuses_untileable_shapes(h, w, cx, f):
    """The training head's rule is checked before the device: a shape the
    backward kernel cannot take raises, on any device, and never falls
    back; the model routes such a head to the plain composition."""
    bf = torch.bfloat16
    assert not upconv_train_ok(2 * h, 2 * w, cx, f)
    g = torch.zeros(1, 2 * h, 2 * w, f, dtype=bf)
    x = torch.zeros(1, h, w, cx, dtype=bf)
    w1, w2 = torch.zeros(f, cx, 3, 3, dtype=bf), torch.zeros(f, f, 3, 3, dtype=bf)
    with pytest.raises(ValueError, match="upconv_bwd kernel"):
        _upconv_bwd_cuda(g, g, g, x, w1, w2)


@pytest.mark.parametrize("h,w,cx,f", [(3, 8, 64, 64),    # 2H % 8
                                      (4, 4, 64, 64),    # 2W % 16
                                      (4, 8, 32, 64),    # Cx % 64 (float32's tap is 32)
                                      (4, 8, 64, 32)])   # F % 64
def test_upconv_bwd_kernel_refuses_untileable_shapes_f32(h, w, cx, f):
    """The training head's rule is the same in float32: its 32-channel K
    slices would take Cx = 32 as conv1's input, but conv1's dgrad writes Cx
    channels in N tiles of 64 or more (``sm90.conv_tile_n``), so Cx % 64
    stays; a shape outside it raises before the device, and the model
    routes such a head to the plain composition."""
    assert not upconv_train_ok(2 * h, 2 * w, cx, f)
    g = torch.zeros(1, 2 * h, 2 * w, f)
    x = torch.zeros(1, h, w, cx)
    w1, w2 = torch.zeros(f, cx, 3, 3), torch.zeros(f, f, 3, 3)
    with pytest.raises(ValueError, match="upconv_bwd kernel"):
        _upconv_bwd_cuda(g, g, g, x, w1, w2)


# --- self_net's step --------------------------------------------------------

SIZE, B, C = 64, 2, 21
CW = tuple(1.0 + 0.05 * i for i in range(C))
# a batch with no ReLU near-tie between PyTorch's and XLA's float32
# forwards (see tests/test_torch_train.py): on _batch(4) the decoder's,
# head's and final's gradients lie within 1.2e-6 of JAX's, the encoder's
# within 2e-6; batches 0-3 and 5 have one, which moves a decoder stage's
# gradients by 2.5e-4 to 2.8e-3 of their largest
STEP_BATCH = 4


def _batch(seed):
    rng = np.random.default_rng(seed)
    lbl = rng.integers(0, C + 1, (B, SIZE, SIZE)).astype(np.int32)
    lbl[:, :2] = 255  # a raw VOC border: the ignore class
    return {"image": rng.integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8),
            "label": lbl}


@pytest.fixture(scope="module")
def self_net_steps():
    """JAX's ``make_train_step`` for self_net in its default TPU
    configuration (fused loss and decoder, ``PAIRED_TRAIN=1``): its logits
    at 2× the input fail ``_fused_shape_ok``, so ``loss_fn`` runs — the
    plain losses on the resized logits, up2-up4 through the wide stage
    kernels in interpret mode, the head under XLA autodiff
    (models/unet.py:115-119).  Its gradients are handed back by an
    optimizer that keeps them.  And the port's step (``"paired"``: the head
    through ``upconv_train``) from the same weights."""
    import jax
    import optax

    from tpu_unet.core import fusion
    from tpu_unet.models.registry import build_model as jbuild
    from tpu_unet.train import step as jstep
    from tpu_unet_torch.infer.convert import state_dict_from_flax
    from tpu_unet_torch.models.registry import build_model
    from tpu_unet_torch.train import step as tstep

    fusion.set_fused_loss(True)
    fusion.set_fused_decoder(True)
    fusion.set_fused_train(False)
    fusion.set_paired_train(True)
    try:
        model = jbuild("self_net", C)
        x = np.zeros((1, SIZE, SIZE, 3), np.float32)
        jv = jax.tree_util.tree_map(np.array, jax.jit(model.init, static_argnums=2)(
            jax.random.PRNGKey(0), x, False))
        keep = optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
        state = jstep.create_train_state(model, jv, keep)
        new, m = jstep.make_train_step(model, jstep.StepConfig(
            num_classes=C, cls_weights=CW, use_dice=True))(state, _batch(STEP_BATCH), 1e-3,
                                                          jax.random.PRNGKey(0))
        jgrads = state_dict_from_flax(jax.tree_util.tree_map(np.array, new.opt_state),
                                      "self_net")
        jres = float(m["loss"]), float(m["f_score"]), jgrads
    finally:
        for setter in (fusion.set_fused_loss, fusion.set_fused_decoder,
                       fusion.set_fused_train, fusion.set_paired_train):
            setter(None)
    sd = state_dict_from_flax(jv, "self_net")
    net = build_model("self_net", C)
    net.load_state_dict(sd, strict=True)
    tstate = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9))
    _, tm = tstep.make_train_step(net, tstep.StepConfig(C, CW, use_dice=True))(
        tstate, _batch(STEP_BATCH), 1e-3)
    return jres, (tm["loss"].item(), tm["f_score"].item(), net), sd


def test_self_net_step_matches_jax(self_net_steps):
    """Loss and f_score within 1e-5 of JAX's step; the head's, the
    decoder's and ``final``'s gradients within 1e-4 relative (the head
    through #12's plain version here, through XLA autodiff in JAX: one
    function); the encoder's, behind PyTorch's and XLA's float32 convs, at a
    cosine of 0.99999 and 5e-3 relative, as unet_vgg's
    (``tests/test_torch_train.py``)."""
    (jloss, jfs, jgrads), (loss, fs, net), _ = self_net_steps
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert abs(fs - jfs) <= 1e-5 * abs(jfs)
    params = dict(net.named_parameters())
    assert set(params) == set(jgrads)
    for k, p in params.items():
        g, r = p.grad.numpy().ravel(), jgrads[k].numpy().ravel()
        if k.startswith("vgg."):
            cos = float(g @ r / (np.linalg.norm(g) * np.linalg.norm(r)))
            assert cos >= 0.99999 and rel_err(g, r) <= 5e-3, (k, cos, rel_err(g, r))
        else:
            assert rel_err(g, r) <= 1e-4, (k, rel_err(g, r))


def test_f32_card_arithmetic_step_matches_jax_self_net(self_net_steps):
    """The float32 step the card runs for self_net (``check_ported`` lets
    it through on the card in float32, both routes), here on the CPU with
    every kernel's TF32 arithmetic emulated (``kernels/tf32.py::
    emulated_plain_versions``: the VGG16 encoder, the decoder stages and
    the up_conv head's #10 / #12 on truncated activations and rounded
    weights, the weight gradients on rounded operands, float64 sums) on the
    ``"paired"`` route: loss, f_score and every gradient against JAX's
    float32 step.  The readings times 4 lie within the bounds that
    ``chip_smoke.py`` holds the card's float32 step to (``kernels/tf32.py``:
    STEP_LOSS_REL_TOL, STEP_GRAD_REL_TOL, STEP_GRAD_COS)."""
    import dataclasses

    from tpu_unet_torch.kernels import tf32
    from tpu_unet_torch.models.registry import build_model
    from tpu_unet_torch.train import step as tstep

    (jloss, jfs, jgrads), _, sd = self_net_steps
    cfg = tstep.StepConfig(C, CW, use_dice=True)
    assert cfg.compute_dtype == torch.float32 and cfg.train_route == "paired"
    net = build_model("self_net", C)
    for route in tstep.TRAIN_ROUTES:
        tstep.check_ported(net, dataclasses.replace(cfg, train_route=route),
                           torch.device("cuda"))
    net.load_state_dict(sd, strict=True)
    state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9))
    with tf32.emulated_plain_versions():
        _, m = tstep.make_train_step(net, cfg)(state, _batch(STEP_BATCH), 1e-3)
    lrel = abs(m["loss"].item() - jloss) / abs(jloss)
    worst_rel, worst_cos = 0.0, 1.0
    for k, p in net.named_parameters():
        g, r = p.grad.numpy().ravel(), jgrads[k].numpy().ravel()
        worst_rel = max(worst_rel, rel_err(g, r))
        worst_cos = min(worst_cos, float(g @ r / (np.linalg.norm(g) * np.linalg.norm(r))))
    print({"loss": lrel, "f_score": abs(m["f_score"].item() - jfs), "grad_rel": worst_rel,
           "grad_1-cos": 1 - worst_cos})
    assert lrel * 4 <= tf32.STEP_LOSS_REL_TOL
    assert worst_rel * 4 <= tf32.STEP_GRAD_REL_TOL
    assert (1 - worst_cos) * 4 <= 1 - tf32.STEP_GRAD_COS
