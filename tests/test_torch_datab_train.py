"""The DataB training slice of the port against ``tpu_unet`` on the CPU, in
float32: batch norm in train mode (output and the running statistics after
it, against flax's ``mutable=["batch_stats"]``), Dropout2d, the train
steps of ``traditional``, ``ultralight`` and ``ultralight_large_optimized``
(its bridge dropout at 0 on both sides) through the logit-level loss
against JAX's ``make_train_step`` with the fused loss forced (its Pallas
kernels in interpret mode), ``lightweight`` on the plain losses, the eval
step on the running statistics (``test_torch_datab_init.py`` holds
``reinit_weights`` and the step's gradients).  Weights are carried across
by the bridge, batch norm drawn at random."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch
from test_torch_resnet import randomize_batch_norm, to_numpy

from tpu_unet.core import fusion
from tpu_unet.models.registry import build_model as jbuild
from tpu_unet.nn import blocks as jblocks
from tpu_unet.train import step as jstep
from tpu_unet_torch.infer.convert import (_conv_bn_relu, _double_conv, _light_block,
                                          _residual, state_dict_from_flax)
from tpu_unet_torch.models.registry import build_model
from tpu_unet_torch.nn import blocks
from tpu_unet_torch.train import step as tstep

C, SIZE, B, LR = 4, 32, 2, 1e-3
CW = {"traditional": (1.0, 15.0, 0.0, 0.0)}   # the presets' class weights
LADDER_CW = (1.0, 15.0, 1.5, 2.0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# --- batch norm in train mode -------------------------------------------

def _block_pair(name, x):
    """(JAX module, port module, bridge function, args) of one block."""
    cin = x.shape[-1]
    if name == "DoubleConv":
        return jblocks.DoubleConv(24), blocks.DoubleConv(cin, 24), _double_conv
    if name == "ConvBNReLU":
        return jblocks.ConvBNReLU(24), blocks.ConvBNReLU(cin, 24), _conv_bn_relu
    if name == "LightConvBlock":
        return (jblocks.LightConvBlock(24, mid_floor=16), blocks.LightConvBlock(cin, 24, 16),
                _light_block)
    return jblocks.ResidualBlock(), blocks.ResidualBlock(cin), _residual


@pytest.mark.parametrize("name", ["DoubleConv", "ConvBNReLU", "LightConvBlock",
                                  "ResidualBlock"])
def test_batch_norm_train_mode_matches_flax(name):
    """Output and new running mean / var after one train-mode call, on a
    2×8×8 batch (128 values a channel: torch's unbiased running variance
    would be 128/127 of flax's biased one)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 8, 8, 16)) + 0.5).astype(np.float32)
    jmod, mod, bridge = _block_pair(name, x)
    jv = randomize_batch_norm(to_numpy(jmod.init(jax.random.PRNGKey(0), x, False)), seed=5)
    ref, mut = jmod.apply(jv, x, True, mutable=["batch_stats"])
    sd = {}
    bridge(jv["params"], jv["batch_stats"], sd, "m")
    mod.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    out = mod(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(ref)).max())
    new = {}
    bridge(jv["params"], to_numpy(mut["batch_stats"]), new, "m")
    for k, v in new.items():
        if "running" in k:
            assert _rel(mod.state_dict()[k[2:]], v) <= 1e-5, k


# --- Dropout2d ------------------------------------------------------------

def test_dropout2d_zeroes_whole_channels_and_scales():
    x = torch.rand(4, 6, 5, 32) + 0.5
    y = blocks.dropout2d(x, 0.25, torch.Generator().manual_seed(0))
    kept = (y != 0).all(dim=(1, 2))
    dropped = (y == 0).all(dim=(1, 2))
    assert bool((kept | dropped).all())           # one decision per (N, C)
    assert 0 < int(dropped.sum()) < dropped.numel()
    torch.testing.assert_close(y[kept[:, None, None, :].expand_as(y)],
                               (x / 0.75)[kept[:, None, None, :].expand_as(x)])


def test_dropout2d_generator_and_modes():
    x = torch.rand(2, 3, 3, 16)
    a = blocks.dropout2d(x, 0.5, torch.Generator().manual_seed(7))
    b = blocks.dropout2d(x, 0.5, torch.Generator().manual_seed(7))
    c = blocks.dropout2d(x, 0.5, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert blocks.dropout2d(x, 0.5, train=False) is x
    assert blocks.dropout2d(x, 0.0) is x


def test_dropout2d_rate():
    """Over 64 × 512 channels the share dropped is the rate, within 4σ."""
    y = blocks.dropout2d(torch.ones(64, 1, 1, 512), 0.15, torch.Generator().manual_seed(3))
    share = (y == 0).float().mean().item()
    assert abs(share - 0.15) <= 4 * (0.15 * 0.85 / y.numel()) ** 0.5


# --- train steps against JAX's --------------------------------------------

def _batch(seed):
    rng = np.random.default_rng(seed)
    lbl = rng.integers(0, C + 1, (B, SIZE, SIZE)).astype(np.int32)
    lbl[:, :2] = 255  # a raw VOC border: the ignore class
    return {"image": rng.integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8), "label": lbl}


_JAX_VARS = {}


def _key_tree(tree):
    return {k: _key_tree(v) if hasattr(v, "items") else None for k, v in tree.items()}


def _ordered(tree, keys):
    """``tree`` with its dict keys in the order of ``keys``."""
    return {k: tree[k] if sub is None else _ordered(tree[k], sub) for k, sub in keys.items()}


def _jax_vars(name, size=SIZE):
    """``init_model(model, (size, size), seed=0, train=True)`` of ``name``,
    jitted (eager init compiles every op on its own), its dicts put back in
    flax's insertion order — recorded while tracing — as ``fit`` hands the
    tree to ``reinit_weights``; made once a module, a copy returned."""
    if (name, size) not in _JAX_VARS:
        model, keys = jbuild(name, C), {}

        def init(rngs, x):
            variables = model.init(rngs, x, True)
            keys["tree"] = _key_tree(variables)
            return variables

        rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
        variables = jax.jit(init)(rngs, jnp.zeros((1, size, size, 3), jnp.float32))
        _JAX_VARS[name, size] = _ordered(to_numpy(variables), keys["tree"])
    return to_numpy(_JAX_VARS[name, size])


@pytest.fixture
def fused_loss():
    """JAX's TPU default: the fused loss (TPU_UNET_FUSED_LOSS=1)."""
    fusion.set_fused_loss(True)
    yield
    fusion.set_fused_loss(None)


@pytest.fixture
def no_dropout(monkeypatch):
    """lightweight's Dropout2d(0.1) layers off on both sides (flax's
    ``nn.Dropout`` as the identity, the port's rate at 0)."""
    import flax.linen as fnn

    from tpu_unet_torch.models import lightweight

    class Identity(fnn.Module):
        rate: float = 0.0
        broadcast_dims: tuple = ()
        deterministic: bool = True

        def __call__(self, x):
            return x

    monkeypatch.setattr(fnn, "Dropout", Identity)
    monkeypatch.setattr(lightweight, "_DROP", 0.0)


def _pair(name):
    """JAX's model and variables (batch norm drawn at random) and the port's
    model on the same weights; the optimized model's bridge dropout at 0 on
    both sides."""
    model = jbuild(name, C)
    if name == "ultralight_large_optimized":
        model = model.clone(dropout=0.0)
    variables = randomize_batch_norm(_jax_vars(name), seed=3)
    net = build_model(name, C)
    net.load_state_dict(state_dict_from_flax(variables, name), strict=True)
    if name == "ultralight_large_optimized":
        net.dropout = 0.0
    return model, variables, net


@pytest.mark.parametrize("name", ["traditional", "ultralight", "ultralight_large_optimized",
                                  "lightweight"])
def test_two_steps_match_jax(fused_loss, no_dropout, name):
    """Two Adam steps (the presets' optimizer, weight decay 1e-4) of the
    port against JAX's ``make_train_step``.  Step 1, from the same weights:
    loss and f_score within 1e-5, every running mean / var within 1e-5, the
    parameters within 2·lr of JAX's and on average within lr/20.  Adam's
    first step moves an element by ±lr whatever the size of its gradient,
    so an element whose gradient is at the noise level (a conv bias before
    a batch norm, exact gradient 0), or whose float32 gradient JAX's XLA
    gets a few % off (see ``test_step_gradients_match_float64``), may land
    2·lr away.  Step 2: loss within 1e-3, f_score (a count of pixels above
    0.5) within 1e-2, the parameters within 4·lr.  ``traditional`` also
    runs the eval step on the running statistics after the steps.
    ``lightweight``'s half-size logits take the plain losses on both sides,
    as ``_fused_shape_ok`` routes them."""
    focal = name != "lightweight"
    cw = CW.get(name, LADDER_CW) if focal else (1.0,) * C
    model, variables, net = _pair(name)
    jcfg = jstep.StepConfig(num_classes=C, cls_weights=cw, use_focal=focal, use_dice=True)
    tx = jstep.make_optimizer("adam", 0.9, weight_decay=1e-4)
    jstate = jstep.create_train_state(model, jax.tree_util.tree_map(jnp.asarray, variables), tx)
    jfn = jstep.make_train_step(model, jcfg)
    cfg = tstep.StepConfig(C, cw, use_focal=focal, use_dice=True)
    state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9, 1e-4))
    fn = tstep.make_train_step(net, cfg)
    params = dict(net.named_parameters())
    for i, tol, ftol in ((0, 1e-5, 1e-5), (1, 1e-3, 1e-2)):
        jstate, jm = jfn(jstate, _batch(i), LR, jax.random.PRNGKey(i))
        state, m = fn(state, _batch(i), LR)
        assert abs(m["loss"].item() - float(jm["loss"])) <= tol * abs(float(jm["loss"])), \
            (i, m["loss"].item(), float(jm["loss"]))
        # f_score counts pixels above 0.5: after a step apart, a few cross
        assert abs(m["f_score"].item() - float(jm["f_score"])) <= ftol, \
            (i, m["f_score"].item(), float(jm["f_score"]))
        ref = state_dict_from_flax(to_numpy({"params": jstate.params,
                                             "batch_stats": jstate.batch_stats}), name)
        d = torch.cat([(params[k].detach() - v).abs().reshape(-1) for k, v in ref.items()
                       if k in params])
        assert d.max().item() <= 2 * LR * (i + 1), (i, d.max().item())
        if i == 0:
            sd = net.state_dict()
            worst = max(_rel(sd[k], v) for k, v in ref.items() if "running" in k)
            assert worst <= 1e-5, worst
            assert d.mean().item() <= LR / 20, d.mean().item()
    if name == "traditional":
        jm = jstep.make_eval_step(model, jcfg)(jstate, _batch(6))
        m = tstep.make_eval_step(net, cfg)(state, _batch(6))
        assert abs(m["val_loss"].item() - float(jm["val_loss"])) <= 1e-3 * float(jm["val_loss"])
        assert abs(m["val_f_score"].item() - float(jm["val_f_score"])) <= 1e-3


def test_dropout_is_live_in_train_steps():
    """The ladder bridge's Dropout2d draws from the step's generator: the
    same generator seed gives the same loss, another seed another loss."""
    from tpu_unet_torch.models.registry import init_model

    losses = []
    for seed in (0, 0, 1):
        net = init_model(build_model("ultralight_large_optimized", C), seed=0)
        state = tstep.TrainState(net, tstep.make_optimizer(net))
        fn = tstep.make_train_step(net, tstep.StepConfig(C, LADDER_CW, use_focal=True,
                                                         use_dice=True))
        _, m = fn(state, _batch(0), 0.0, torch.Generator().manual_seed(seed))
        losses.append(m["loss"].item())
    assert losses[0] == losses[1] != losses[2]
