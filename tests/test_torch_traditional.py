"""The port's DataB competition path on the CPU: the TraditionalUnet blocks
and models (``traditional``, ``traditional22``) against ``tpu_unet``'s on
bridged weights with batch norm drawn at random, the bridge's keys, the
seeded init, and ``Unet.serving_step`` against the JAX serving step with
its natural-layout tail forced on (Pallas in interpret mode) — at 64×64,
where the histogram tail runs, and at 40×40, where the mask-only tail does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import shutil
import torch
from test_torch_resnet import randomize_batch_norm, to_numpy

from tpu_unet.core import fusion
from tpu_unet.infer.wrapper import Unet as JaxUnet
from tpu_unet.nn import blocks as jax_blocks
from tpu_unet_torch.infer import wrapper
from tpu_unet_torch.infer.convert import _double_conv, state_dict_from_flax
from tpu_unet_torch.infer.wrapper import Unet
from tpu_unet_torch.kernels import launch_counts
from tpu_unet_torch.models.registry import _TRUNC_STD, build_model, init_model
from tpu_unet_torch.nn.blocks import DoubleConv, Down, Up

SIZE, CLASSES = 64, 4
BASE = {"traditional": 32, "traditional22": 22}


@pytest.fixture(autouse=True)
def _reset_switches():
    yield
    fusion.set_fused_tail256(None)


@pytest.fixture(scope="module", params=["traditional", "traditional22"])
def pair(request, tmp_path_factory):
    """tpu_unet's wrapper at 64×64 (batch norm drawn at random) and the
    port's, loaded from the bridged weights of the JAX one."""
    name = request.param
    ju = JaxUnet(model=name, num_classes=CLASSES, input_shape=[SIZE, SIZE])
    variables_np = randomize_batch_norm(to_numpy(ju.variables), seed=21)
    ju.variables = jax.tree_util.tree_map(jnp.asarray, variables_np)
    path = tmp_path_factory.mktemp("w") / f"{name}.pth"
    torch.save(state_dict_from_flax(variables_np, name), path)
    tu = Unet(model=name, num_classes=CLASSES, input_shape=[SIZE, SIZE],
              cuda=False, model_path=str(path))
    yield name, ju, tu, variables_np
    shutil.rmtree(path.parent, ignore_errors=True)


def _images(seed, n=2, size=SIZE):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3)).astype(np.uint8)


def _close(out, ref):
    # f32 both sides, 14 3×3 convs and 14 batch norms summed in another order
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def test_logits_match_jax(pair):
    name, ju, tu, _ = pair
    x = np.random.default_rng(0).random((2, SIZE, SIZE, 3), np.float32)
    ref = np.asarray(jax.jit(ju.net.apply, static_argnums=2)(ju.variables, x, False))
    assert ref.shape == (2, SIZE, SIZE, CLASSES)
    with torch.no_grad():
        out = tu.net(torch.from_numpy(x)).numpy()
    _close(out, ref)


def test_features_out_match_jax(pair):
    name, ju, tu, _ = pair
    x = np.random.default_rng(1).random((2, SIZE, SIZE, 3), np.float32)
    ref = np.asarray(ju.net.clone(features_out=True).apply(ju.variables, x, False))
    with torch.no_grad():
        out = tu.net(torch.from_numpy(x), features_out=True)
    assert out.shape == (2, SIZE, SIZE, BASE[name]) and out.is_contiguous()
    _close(out.numpy(), ref)


def test_bridge_keys_in_model_order(pair):
    name, _, tu, variables_np = pair
    sd = state_dict_from_flax(variables_np, name)
    # 7 DoubleConvs × (2 convs × 2 + 2 BN × 5), outc × 2
    assert len(sd) == 7 * 14 + 2 == 100
    assert list(sd) == list(build_model(name, CLASSES).state_dict())
    np.testing.assert_array_equal(
        sd["down3.maxpool_conv.1.double_conv.4.running_var"].numpy(),
        variables_np["batch_stats"]["down3"]["conv"]["bn2"]["var"])
    np.testing.assert_array_equal(
        sd["up1.conv.double_conv.0.weight"].numpy(),
        variables_np["params"]["up1"]["conv"]["conv1"]["kernel"].transpose(3, 2, 0, 1))


@pytest.mark.parametrize("block", ["DoubleConv", "Down", "Up"])
def test_block_matches_jax(block):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 12, 6)).astype(np.float32)
    skip = rng.standard_normal((2, 16, 24, 4)).astype(np.float32)
    jmod = getattr(jax_blocks, block)(10)
    jargs = (x, skip) if block == "Up" else (x,)
    jv = to_numpy(jmod.init(jax.random.PRNGKey(0), *jargs, False))
    randomize_batch_norm(jv, seed=6)
    ref = np.asarray(jmod.apply(jv, *jargs, False))
    # the port's module and where the bridge puts its DoubleConv
    mod, key = {"DoubleConv": (DoubleConv(6, 10), "m"),
                "Down": (Down(6, 10), "maxpool_conv.1"),
                "Up": (Up(10, 10), "conv")}[block]
    p, s = jv["params"], jv["batch_stats"]
    if block != "DoubleConv":
        p, s = p["conv"], s["conv"]
    sd = {}
    _double_conv(p, s, sd, key)
    if block == "DoubleConv":
        sd = {k[len("m."):]: v for k, v in sd.items()}
    mod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = mod.eval()(*(torch.from_numpy(a) for a in jargs)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", ["traditional", "traditional22"])
def test_init_model_draws_in_module_order(name):
    """Batch norm starts as flax's; every conv kernel is the next
    lecun-normal draw of one numpy generator, in state-dict order."""
    net = init_model(build_model(name, CLASSES), seed=3)
    bns = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == 14
    for bn in bns:
        assert torch.equal(bn.weight, torch.ones_like(bn.weight))
        assert not bn.bias.any() and not bn.running_mean.any()
    rng = np.random.default_rng(3)
    convs = [(k, v) for k, v in net.state_dict().items()
             if k.endswith("weight") and v.ndim == 4]
    assert len(convs) == 15
    for key, w in convs:
        shape = tuple(w.shape)
        vals = rng.standard_normal(shape)
        bad = np.abs(vals) >= 2.0
        while bad.any():
            vals[bad] = rng.standard_normal(int(bad.sum()))
            bad = np.abs(vals) >= 2.0
        std = np.sqrt(1.0 / np.prod(shape[1:])) / _TRUNC_STD
        np.testing.assert_array_equal(w.numpy(), (vals * std).astype(np.float32), err_msg=key)
        assert not net.state_dict()[key[:-len("weight")] + "bias"].any()


@pytest.mark.parametrize("size", [SIZE, 40])
def test_serving_step_matches_jax(pair, size):
    """Masks equal wherever the top-1/top-2 logit gap exceeds 1e-4 of the
    logit scale (f32 on both sides), hist = bincount(masks)."""
    name, ju, tu, _ = pair
    fusion.set_fused_tail256(True)  # the accelerator default, forced here
    ju._serving = None
    imgs = _images(size, size=size)
    jfn, jvars = ju.serving_step()
    jm, jh = (np.asarray(a) for a in jfn(jvars, imgs))
    fn, net = tu.serving_step()
    counts = dict(launch_counts)
    masks, hist = fn(net, imgs)
    assert launch_counts == counts  # the CPU path launches nothing
    masks, hist = masks.numpy(), hist.numpy()
    assert masks.shape == (2, size, size) and masks.dtype == np.uint8
    assert hist.shape == (2, CLASSES) and hist.dtype == np.int32
    logits = np.asarray(ju.net.apply(ju.variables, imgs.astype(np.float32) / 255.0, False))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    differ = masks != jm
    assert not np.any(differ & (gap > 1e-4 * np.abs(logits).max()))
    for i in range(2):
        np.testing.assert_array_equal(hist[i], np.bincount(masks[i].ravel(), minlength=CLASSES))
    if not differ.any():
        np.testing.assert_array_equal(hist, jh)
    np.testing.assert_array_equal(tu.batch_infer(imgs), masks.astype(np.int32))


@pytest.mark.parametrize("model,size,tail", [
    ("traditional22", 64, "final_argmax_hist"), ("traditional22", 40, "final_argmax"),
    ("traditional22", 48, "final_argmax"),
    # the canonical UNets follow the CUDA kernel's own 256-pixel rule, which
    # every size their encoders take (H, W multiples of 16) meets
    ("unet_vgg", 32, "final_argmax_hist"), ("unet_vgg", 48, "final_argmax_hist")])
def test_serving_tail_dispatch_follows_jax(monkeypatch, model, size, tail):
    """TraditionalUnet: the histogram tail when H·W is a multiple of the
    JAX tail's 1024-row block, else the mask-only tail and a separate
    histogram (``postprocess.py:146-152``)."""
    called = []
    for fn_name in ("final_argmax_hist", "final_argmax"):
        real = getattr(wrapper, fn_name)
        monkeypatch.setattr(wrapper, fn_name,
                            lambda *a, _n=fn_name, _f=real: called.append(_n) or _f(*a))
    u = Unet(model=model, num_classes=CLASSES, input_shape=[size, size], cuda=False)
    fn, net = u.serving_step()
    masks, hist = fn(net, _images(2, n=1, size=size))
    assert called == [tail]
    assert int(hist.sum()) == size * size
    np.testing.assert_array_equal(hist[0].numpy(),
                                  np.bincount(masks[0].numpy().ravel(), minlength=CLASSES))
