"""``unet_resnet50`` training in the port against ``tpu_unet`` on the CPU, in
float32: ResNet50 in train mode (features and the running statistics
against flax's ``mutable=["batch_stats"]``), the ceil-mode max-pool's tie
routing against ``jax.vjp``, the train step against JAX's
``make_train_step`` in its default TPU configuration (fused loss, fused
decoder, ``PAIRED_TRAIN=1``: #27 / #29 on the head's features, up2 / up3
through the wide stage kernels #16, the head through #12, all in interpret
mode), the encoder's gradients against a float64 evaluation of the port,
the freeze phase, and ``cli train --preset voc_resnet50``.  Weights are
carried across by the bridge, batch norm drawn at random."""
import contextlib
import io
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch
from test_torch_fit import write_voc
from test_torch_resnet import randomize_batch_norm, to_numpy

from tpu_unet.core import fusion
from tpu_unet.models.backbones import ResNet50 as JaxResNet50
from tpu_unet.models.registry import build_model as jbuild
from tpu_unet.nn.blocks import max_pool_ceil as jax_max_pool_ceil
from tpu_unet.train import step as jstep
from tpu_unet_torch import cli
from tpu_unet_torch.infer.convert import state_dict_from_flax
from tpu_unet_torch.models.registry import build_model
from tpu_unet_torch.nn.blocks import max_pool_ceil
from tpu_unet_torch.train import step as tstep
from tpu_unet_torch.train.checkpoint import load_any

SIZE, B, C = 64, 2, 21
CW = tuple(1.0 + 0.05 * i for i in range(C))
# the batch of the step held to JAX's: PyTorch's and XLA's float32
# forwards differ by ~1e-6 of the scale, so a pre-activation that close to
# 0 may take another ReLU mask in each and move every gradient above it
# (tests/test_torch_train.py); this batch has no such near-tie
STEP_BATCH = 5


@pytest.fixture
def tmp_path(tmp_path):
    """The test's directory, removed once the test is done: the whole-model
    checkpoints written there would otherwise stay behind."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _batch(seed):
    rng = np.random.default_rng(seed)
    lbl = rng.integers(0, C + 1, (B, SIZE, SIZE)).astype(np.int32)
    lbl[:, :2] = 255  # a raw VOC border: the ignore class
    return {"image": rng.integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8),
            "label": lbl}


@pytest.fixture(scope="module")
def rn50():
    """JAX's default TPU training configuration (TPU_UNET_FUSED_LOSS=1,
    the fused decoder, TPU_UNET_PAIRED_TRAIN=1, FUSED_TRAIN=0), reset
    afterwards; unet_resnet50's JAX model and variables at 64² with batch
    norm drawn at random."""
    fusion.set_fused_loss(True)
    fusion.set_fused_decoder(True)
    fusion.set_fused_train(False)
    fusion.set_paired_train(True)
    try:
        model = jbuild("unet_resnet50", C)
        x = np.zeros((1, SIZE, SIZE, 3), np.float32)
        jv = to_numpy(jax.jit(model.init, static_argnums=2)(jax.random.PRNGKey(0), x, False))
        yield model, randomize_batch_norm(jv, seed=3)
    finally:
        for setter in (fusion.set_fused_loss, fusion.set_fused_decoder,
                       fusion.set_fused_train, fusion.set_paired_train):
            setter(None)


def _port(jv):
    net = build_model("unet_resnet50", C)
    net.load_state_dict(state_dict_from_flax(jv, "unet_resnet50"), strict=True)
    return net


def _keep_gradients():
    """An optax transformation whose state is the last gradient and whose
    update is zero: JAX's step hands back its own gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def jax_step(rn50):
    """JAX's ``make_train_step`` on ``_batch(STEP_BATCH)``: loss, f_score,
    gradients and the new running statistics, in the port's names."""
    model, jv = rn50
    state = jstep.create_train_state(model, jv, _keep_gradients())
    new, m = jstep.make_train_step(model, jstep.StepConfig(
        num_classes=C, cls_weights=CW, use_dice=True))(state, _batch(STEP_BATCH), 1e-3,
                                                      jax.random.PRNGKey(0))
    grads = state_dict_from_flax({"params": to_numpy(new.opt_state),
                                  "batch_stats": jv["batch_stats"]}, "unet_resnet50")
    stats = state_dict_from_flax({"params": jv["params"],
                                  "batch_stats": to_numpy(new.batch_stats)}, "unet_resnet50")
    return float(m["loss"]), float(m["f_score"]), grads, stats


def _port_step(jv, freeze=()):
    """The port's default-route step on ``_batch(STEP_BATCH)``: (loss,
    f_score, the model after it)."""
    net = _port(jv)
    state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9, freeze_prefixes=freeze))
    cfg = tstep.StepConfig(num_classes=C, cls_weights=CW, use_dice=True)
    _, m = tstep.make_train_step(net, cfg)(state, _batch(STEP_BATCH), 1e-3)
    return m["loss"].item(), m["f_score"].item(), net


@pytest.fixture(scope="module")
def port_step(rn50):
    return _port_step(rn50[1])


# ResNet50's five stages (bn1, layer1-4) in train mode at 64², batch 2,
# against flax, relative to max |flax|: float32 sums in another order,
# amplified stage by stage by the batch-norm normalisations over the batch
# statistics (layer4 normalises 8 values a channel).  Measured on the CPU:
# features 4.4e-6, 1.1e-5, 2.0e-5, 1.7e-4, 1.1e-3 and running statistics
# up to 3.8e-7, 1.9e-6, 1.0e-6, 2.1e-5, 9.6e-5; flax lies 3-5× further from a
# float64 evaluation than the port at every stage (asserted below)
FEAT_TOL = (1e-5, 5e-5, 1e-4, 5e-4, 3e-3)
STAT_TOL = (1e-5, 1e-5, 1e-5, 1e-4, 3e-4)


def _stage(key):
    """The ResNet50 stage (0 for the stem's bn1, 1-4 for layer1-4) of a
    ``resnet.*`` state-dict key."""
    part = key.split(".")[1]
    return int(part[5:]) if part.startswith("layer") else 0


def test_resnet50_train_mode_matches_flax(rn50):
    """Features and every running mean / var after one train-mode forward
    (batch statistics, flax's biased E[x²]−E[x]²), against flax's
    ``mutable=["batch_stats"]``, on a 2×64×64 batch, within ``FEAT_TOL`` /
    ``STAT_TOL``; at every stage the port's features lie no further from a
    float64 evaluation of the port than flax's do."""
    _, jv = rn50
    x = np.random.default_rng(0).random((B, SIZE, SIZE, 3), np.float32)
    apply = jax.jit(lambda v, x: JaxResNet50().apply(v, x, True, mutable=["batch_stats"]))
    ref, mut = apply({"params": jv["params"]["resnet"],
                      "batch_stats": jv["batch_stats"]["resnet"]}, jnp.asarray(x))
    net = _port(jv)
    with torch.no_grad():
        out64 = _port(jv).double().resnet(torch.from_numpy(x).double(), train=True)
    with torch.no_grad():
        out = net.resnet(torch.from_numpy(x), train=True)
    for i, (o, r, d) in enumerate(zip(out, ref, out64)):
        o, r, d = o.numpy(), np.asarray(r), d.numpy()
        assert o.shape == r.shape
        assert _rel(o, r) <= FEAT_TOL[i], (f"feat{i + 1}", _rel(o, r))
        assert _rel(o, d) <= _rel(r, d), (f"feat{i + 1}", _rel(o, d), _rel(r, d))
    new = state_dict_from_flax({"params": jv["params"],
                                "batch_stats": {**jv["batch_stats"],
                                                "resnet": to_numpy(mut["batch_stats"])}},
                               "unet_resnet50")
    own = net.state_dict()
    for k, v in new.items():
        if k.startswith("resnet.") and "running" in k:
            assert _rel(own[k], v) <= STAT_TOL[_stage(k)], (k, _rel(own[k], v))


@pytest.mark.parametrize("h,w", [(9, 11), (8, 13)])
def test_ceil_pool_routes_ties_as_jax(h, w):
    """The 3×3 / stride-2 ceil-mode pool's backward (autograd of
    ``F.max_pool2d``) routes each window's gradient to its first maximum in
    row-major order, as ``jax.vjp`` of JAX's ``max_pool_ceil`` does, on
    tied positive values in overlapping windows and the ceil edge."""
    rng = np.random.default_rng(h * w)
    x = rng.integers(1, 3, (2, h, w, 4)).astype(np.float32)
    out, vjp = jax.vjp(lambda v: jax_max_pool_ceil(v, 3, 2), jnp.asarray(x))
    g = rng.standard_normal(out.shape).astype(np.float32)
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_()
    y = max_pool_ceil(xt, 3, 2)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(out))
    grad, = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(grad.numpy(), ref)


def _loss64(logits, target):
    """CE (class weights ``CW``) + dice in float64, as ``train/losses.py``
    computes them (dice over every pixel's probabilities, the ignored ones'
    target row zero)."""
    t = target.long()
    valid = t < C
    oh = torch.nn.functional.one_hot(torch.where(valid, t, 0), C).double() * valid[..., None]
    logp = torch.log_softmax(logits, -1)
    w = oh @ torch.tensor(CW, dtype=torch.float64)
    ce = (-(logp * oh).sum(-1) * w).sum() / w.sum()
    p = logp.exp()
    tp, ps, ts = (p * oh).sum((0, 1, 2)), p.sum((0, 1, 2)), oh.sum((0, 1, 2))
    return ce + 1 - ((2 * tp + 1e-5) / (ps + ts + 1e-5)).mean()


@pytest.fixture(scope="module")
def f64_grads(rn50):
    """The gradients of a float64 evaluation of the port's model on the
    step's batch (the same routes; ``bn`` takes a float64 input's batch
    statistics in float64, as flax does)."""
    n64 = _port(rn50[1]).double()
    batch = _batch(STEP_BATCH)
    logits = n64(torch.from_numpy(batch["image"]).double() / 255.0, train=True)
    _loss64(logits, torch.from_numpy(batch["label"])).backward()
    return {k: p.grad.numpy() for k, p in n64.named_parameters()}


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_train_step_matches_jax_default_config(jax_step, port_step, f64_grads):
    """Loss and f_score within 1e-5 of JAX's step, every running mean / var
    within ``STAT_TOL``, ``final``'s gradients within 1e-5.  The decoder's
    and the head's gradients at a cosine of 0.999 with JAX's, each no
    further from the float64 evaluation than JAX's: on this CPU JAX's
    float32 step puts them 6e-4 to 1.3e-1 (up_concat4's conv2) from
    float64, the port 1e-6 to 1.9e-4, because JAX's float32 ResNet50
    features in train mode lie 3-5× further from float64 than the port's
    (see ``FEAT_TOL``) and every gradient above them inherits that.  The
    step in float64 on both sides holds them within 1e-4
    (``tests/test_torch_resnet_x64.py``).  The encoder's gradients: the
    test below."""
    jloss, jfs, jgrads, jstats = jax_step
    loss, fs, net = port_step
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert abs(fs - jfs) <= 1e-5 * abs(jfs)
    params = dict(net.named_parameters())
    assert set(jgrads) >= set(params)
    for k, p in params.items():
        g = p.grad.numpy()
        if k.startswith("final."):
            assert _rel(g, jgrads[k]) <= 1e-5, (k, _rel(g, jgrads[k]))
        elif not k.startswith("resnet."):
            ours, theirs = _rel(g, f64_grads[k]), _rel(jgrads[k], f64_grads[k])
            assert _cos(g, jgrads[k]) >= 0.999 and ours <= theirs, (k, ours, theirs)
    own = net.state_dict()
    for k, v in jstats.items():
        if "running" in k:
            assert _rel(own[k], v) <= STAT_TOL[_stage(k)], (k, _rel(own[k], v))


def test_step_gradients_match_float64(port_step, f64_grads):
    """The port's float32 step against the float64 evaluation: the head's,
    ``final``'s and up1-up3's gradients within 1e-4 relative (measured ≤
    4.3e-5); up4's, whose 4×4 stage runs the plain composition on feat5,
    within 5e-4 (1.9e-4); the encoder's, behind up to 53 batch-norm
    backwards whose float32 batch statistics of 8-512 values a channel
    cancel, at a cosine of 0.998 (≥ 0.99941 measured; their largest
    elements move by up to 24%, as the two float64 steps of
    ``tests/test_torch_resnet_x64.py`` move them by 8.5% between each
    other)."""
    _, _, net = port_step
    for k, p in net.named_parameters():
        g, r = p.grad.numpy(), f64_grads[k]
        if k.startswith("resnet."):
            assert _cos(g, r) >= 0.998, (k, _cos(g, r))
        else:
            tol = 5e-4 if k.startswith("up_concat4.") else 1e-4
            assert _rel(g, r) <= tol, (k, _rel(g, r))


def test_frozen_step(rn50, port_step):
    """The freeze phase (``FREEZE_PREFIXES["unet_resnet50"]``): no
    ``resnet.*`` gradient and no update, the running statistics moved as in
    the unfrozen step (``mutable=["batch_stats"]`` holds in both phases, as
    JAX's), the decoder's, head's and final's gradients those of the
    unfrozen step."""
    _, jv = rn50
    _, _, full = port_step
    before = _port(jv).state_dict()
    _, _, net = _port_step(jv, freeze=tstep.FREEZE_PREFIXES["unet_resnet50"])
    own, ref = net.state_dict(), full.state_dict()
    for k, p in net.named_parameters():
        if k.startswith("resnet."):
            assert p.grad is None and torch.equal(p, before[k]), k
        else:
            g = full.get_parameter(k).grad
            assert _rel(p.grad.numpy(), g.numpy()) <= 1e-6, k
    for k in own:
        if "running" in k:
            assert torch.equal(own[k], ref[k]) and not torch.equal(own[k], before[k]), k


def test_cli_train_voc_resnet50(tmp_path):
    """``cli train --preset voc_resnet50 --no-pretrained --cpu`` on a
    seeded VOC tree at 64²: one epoch of the freeze phase, its checkpoint
    with the frozen backbone unchanged from the random init it drew."""
    root = str(tmp_path / "data")
    write_voc(root, 4, 2, seed=3)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["train", "--preset", "voc_resnet50", "--no-pretrained", "--cpu",
                  "--data-root", root, "--input-shape", "64", "64", "--batch-size", "2",
                  "--epochs", "1", "--no-eval", "--save-dir", str(tmp_path / "logs")])
    assert "Epoch 1/1" in buf.getvalue()
    last = load_any(str(tmp_path / "logs" / "last_epoch_weights.pth"))
    assert last["epoch"] == 1 and last["step"] == 2
