"""The port's ladder family (``ultralight``, ``ultralight_large``,
``ultralight_large_optimized``, ``ultralight44``) and ``lightweight`` on the
CPU against ``tpu_unet``: the new blocks, whole-model logits at 64×64 on
bridged weights with batch norm and dense biases drawn at random, the
bridge's keys, the seeded init, the serving step, the trained
``examples/medical_ultralight.msgpack`` weights, and the checkpoint loading
of ``Unet(model_path=...)``."""
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch
from test_torch_resnet import randomize_batch_norm, to_numpy

from tpu_unet.infer.wrapper import Unet as JaxUnet
from tpu_unet.nn import blocks as jax_blocks
from tpu_unet.train.checkpoint import load_any
from tpu_unet_torch.infer.convert import (_light_block, _residual, _se,
                                          load_state_dict, state_dict_from_flax)
from tpu_unet_torch.infer.wrapper import Unet
from tpu_unet_torch.kernels import launch_counts
from tpu_unet_torch.models.ladder import LadderUNet
from tpu_unet_torch.models.registry import build_model, init_model
from tpu_unet_torch.nn import blocks

SIZE, CLASSES = 64, 4
MODELS = ["ultralight", "ultralight_large", "ultralight_large_optimized",
          "ultralight44", "lightweight"]
ARTIFACT = Path(__file__).resolve().parents[1] / "examples" / "medical_ultralight.msgpack"


@pytest.fixture
def tmp_path(tmp_path):
    """The test's directory, removed once the test is done: the whole-model
    checkpoints written there would otherwise stay behind."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def randomize_dense_biases(params, rng):
    """Draw every dense bias of a flax params tree (in place): flax starts
    them at 0."""
    for k, v in params.items():
        if k.startswith("fc") and "bias" in v:
            v["bias"] = (0.1 * rng.standard_normal(v["bias"].shape)).astype(np.float32)
        elif isinstance(v, dict):
            randomize_dense_biases(v, rng)


@torch.no_grad()
def randomize(net, seed):
    """Draw every bias and every batch norm's weight, bias, mean and var
    (in place) after the seeded init, so that no layer is trivial."""
    rng = np.random.default_rng(seed)
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            n = m.num_features
            m.weight.copy_(torch.from_numpy(1 + 0.2 * rng.standard_normal(n)))
            m.running_mean.copy_(torch.from_numpy(0.1 * rng.standard_normal(n)))
            m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
        if getattr(m, "bias", None) is not None:
            m.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(m.bias.shape)))
    return net


@pytest.fixture(scope="module", params=MODELS)
def pair(request, tmp_path_factory):
    """The port's seeded weights (biases and batch norm drawn at random)
    saved as a reference ``.pth``, read by ``tpu_unet``'s converter and by
    the port at 64×64; the JAX logits of a seeded uint8 batch / 255."""
    name = request.param
    net = randomize(init_model(build_model(name, CLASSES), seed=40), seed=41)
    path = tmp_path_factory.mktemp("w") / f"{name}.pth"
    torch.save(net.state_dict(), path)
    ju = JaxUnet(model=name, num_classes=CLASSES, input_shape=[SIZE, SIZE],
                 model_path=str(path))
    tu = Unet(model=name, num_classes=CLASSES, input_shape=[SIZE, SIZE],
              cuda=False, model_path=str(path))
    imgs = np.random.default_rng(7).integers(0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)
    logits = np.asarray(jax.jit(ju.net.apply, static_argnums=2)(
        ju.variables, imgs.astype(np.float32) / 255.0, False))
    yield name, ju, tu, str(path), imgs, logits
    shutil.rmtree(path.parent, ignore_errors=True)


def test_logits_match_jax(pair):
    """Float32 logits within 1e-4 of max|logit| (the same convs and batch
    norms summed in another order)."""
    name, _, tu, _, imgs, ref = pair
    side = SIZE // 2 if name == "lightweight" else SIZE
    assert ref.shape == (2, side, side, CLASSES)
    with torch.no_grad():
        out = tu.net(torch.from_numpy(imgs.astype(np.float32) / 255.0)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_bridge_keys_in_model_order(pair):
    """flax → torch bridge of the variables JAX read from the ``.pth``
    gives back that state dict, key for key in the model's order."""
    name, ju, _, path, _, _ = pair
    variables_np = to_numpy(ju.variables)
    sd = state_dict_from_flax(variables_np, name)
    saved = torch.load(path, weights_only=True)
    assert list(sd) == list(saved) == list(build_model(name, CLASSES).state_dict())
    for k, v in saved.items():
        assert torch.equal(sd[k], v.to(sd[k].dtype)), k
    if name != "lightweight":
        np.testing.assert_array_equal(
            sd["enc2.conv.3.depthwise.weight"].numpy(),
            variables_np["params"]["enc2"]["dw"]["depthwise"]["kernel"].transpose(3, 2, 0, 1))


def test_serving_step_matches_jax(pair):
    """The generic serving step (``argmax_mask``, uint8) against JAX's
    generic step (``wrapper.py:423-444``: logits → align-corners resize
    where the sizes differ → argmax): masks equal wherever the top-1/top-2
    logit gap exceeds 1e-4 of the logit scale; hist = bincount(masks); the
    CPU path launches nothing."""
    name, ju, tu, _, imgs, logits = pair
    if logits.shape[1] != SIZE:
        from tpu_unet.nn.resize import resize_bilinear

        logits = np.asarray(resize_bilinear(jnp.asarray(logits), (SIZE, SIZE),
                                            align_corners=True))
    fn, net = tu.serving_step()
    counts = dict(launch_counts)
    masks, hist = fn(net, imgs)
    assert launch_counts == counts
    masks, hist = masks.numpy(), hist.numpy()
    assert masks.shape == (2, SIZE, SIZE) and masks.dtype == np.uint8
    top2 = np.sort(logits, axis=-1)[..., -2:]
    differ = masks != logits.argmax(-1)
    assert not np.any(differ & (top2[..., 1] - top2[..., 0] > 1e-4 * np.abs(logits).max()))
    for i in range(2):
        np.testing.assert_array_equal(hist[i], np.bincount(masks[i].ravel(), minlength=CLASSES))


@pytest.mark.parametrize("name", MODELS)
def test_parameter_counts(name):
    """Parameter counts equal JAX's; the submission model has the
    reference's 926,347 at 4 classes (models/ladder.py:110-115)."""
    from tpu_unet.models.registry import build_model as jax_build_model

    n = sum(p.numel() for p in build_model(name, CLASSES).parameters())
    model = jax_build_model(name, CLASSES)
    jv = jax.eval_shape(lambda key, x: model.init(key, x, False), jax.random.PRNGKey(0),
                        jnp.zeros((1, 32, 32, 3)))
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jv["params"]))
    if name == "ultralight_large_optimized":
        assert n == 926_347


def test_init_model_fan_in():
    """Depthwise (C, 1, 3, 3) kernels get fan-in 9 and Linear (out, in)
    weights fan-in ``in``, as flax counts them; batch norm starts as flax's."""
    net = init_model(build_model("ultralight_large_optimized", CLASSES), seed=3)
    dw = net.enc3.conv[3].depthwise.weight
    assert tuple(dw.shape) == (88, 1, 3, 3)
    assert abs(dw.std().item() - 1 / 3) < 0.05
    fc = net.se4.fc[0].weight
    assert tuple(fc.shape) == (88, 352)
    assert abs(fc.std().item() - 352 ** -0.5) < 0.1 * 352 ** -0.5
    assert not net.se4.fc[0].bias.any()
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert torch.equal(m.running_var, torch.ones_like(m.running_var))


def test_unported_block_kinds_raise():
    """Every block kind of JAX's ``_make_block`` builds; an unknown one
    raises ``ValueError`` as there."""
    for kind in ("light8", "light16", "sk", "repvgg", "fusedmb"):
        LadderUNet(CLASSES, (16, 16, 16, 16, 16), block=kind)
    with pytest.raises(ValueError, match="unknown block kind 'dense'"):
        LadderUNet(CLASSES, (8, 8, 8, 8, 8), block="dense")


def _jax_block_vars(jmod, *args):
    jv = to_numpy(jmod.init(jax.random.PRNGKey(0), *args))
    if "batch_stats" in jv:
        randomize_batch_norm(jv, seed=8)
    randomize_dense_biases(jv["params"], np.random.default_rng(9))
    return jv


@pytest.mark.parametrize("block", ["LightConvBlock", "SE", "ResidualBlock"])
def test_block_matches_jax(block):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)
    if block == "LightConvBlock":
        jmod, mod = jax_blocks.LightConvBlock(24, mid_floor=16), blocks.LightConvBlock(16, 24, 16)
        jv = _jax_block_vars(jmod, x, False)
        sd = {}
        _light_block(jv["params"], jv["batch_stats"], sd, "m")
        args = (x, False)
    elif block == "SE":
        jmod, mod = jax_blocks.SE(jax_blocks.se_light_large(16)), blocks.SE(16, 8)
        jv = _jax_block_vars(jmod, x)
        sd = {}
        _se(jv["params"], sd, "m")
        args = (x,)
    else:
        jmod, mod = jax_blocks.ResidualBlock(), blocks.ResidualBlock(16)
        jv = _jax_block_vars(jmod, x, False)
        sd = {}
        _residual(jv["params"], jv["batch_stats"], sd, "m")
        args = (x, False)
    ref = np.asarray(jmod.apply(jv, *args))
    mod.load_state_dict({k[len("m."):]: v for k, v in sd.items()
                         if "num_batches_tracked" not in k}, strict=False)
    with torch.no_grad():
        out = mod.eval()(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_se_width_rules():
    for c in (16, 44, 88, 352, 704):
        assert blocks.se_quarter(c) == jax_blocks.se_quarter(c)
        assert blocks.se_light(c) == jax_blocks.se_light(c)
        assert blocks.se_light_large(c) == jax_blocks.se_light_large(c)
        assert blocks.se_lightweight(c) == jax_blocks.se_lightweight(c)


def test_trained_medical_ultralight_masks_match_jax():
    """Real weights: the committed ``ultralight`` (2 classes) msgpack, read
    through ``tpu_unet``'s loader and bridged into the port, on two smooth
    seeded 256×256 images.  Masks equal JAX's wherever the top-1/top-2
    logit gap exceeds 1e-4 of the logit scale; in practice every pixel
    agrees."""
    from tpu_unet.models.registry import build_model as jax_build_model

    variables = load_any(str(ARTIFACT))
    variables_np = to_numpy({k: variables[k] for k in ("params", "batch_stats")})
    net = build_model("ultralight", 2)
    net.load_state_dict(state_dict_from_flax(variables_np, "ultralight"), strict=True)
    yy, xx = np.mgrid[0:256, 0:256] / 256.0
    rng = np.random.default_rng(11)
    imgs = []
    for _ in range(2):
        f = rng.uniform(2, 6, 3)
        img = 0.5 + 0.4 * np.sin(f[None, None] * (xx[..., None] + 0.7 * yy[..., None]) * 6.28)
        imgs.append(img + 0.05 * rng.standard_normal(img.shape))
    x = np.clip(np.stack(imgs), 0, 1).astype(np.float32)
    ref = np.asarray(jax.jit(jax_build_model("ultralight", 2).apply, static_argnums=2)(
        jax.tree_util.tree_map(jnp.asarray, variables_np), x, False))
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    top2 = np.sort(ref, axis=-1)
    gap = top2[..., -1] - top2[..., -2]
    differ = out.argmax(-1) != ref.argmax(-1)
    assert not np.any(differ & (gap > 1e-4 * np.abs(ref).max()))
    assert differ.mean() <= 1e-3
    assert len(np.unique(ref.argmax(-1))) == 2  # both classes appear


def test_checkpoint_wrappers_load(tmp_path):
    """A reference EarlyStopping checkpoint (``{"model_state_dict": ...}``)
    and a state dict without ``num_batches_tracked`` both load and give the
    same logits as the plain one; a missing or extra weight raises with its
    name."""
    net = init_model(build_model("ultralight", CLASSES), seed=2)
    sd = net.state_dict()
    assert any("num_batches_tracked" in k for k in sd)
    plain, wrapped, bare, broken = (tmp_path / f"{n}.pth" for n in
                                    ("plain", "wrapped", "bare", "broken"))
    torch.save(sd, plain)
    torch.save({"model_state_dict": sd, "epoch": 3}, wrapped)
    torch.save({k: v for k, v in sd.items() if "num_batches_tracked" not in k}, bare)
    x = torch.from_numpy(np.random.default_rng(3).random((1, 32, 32, 3), np.float32))
    with torch.no_grad():
        ref = net.eval()(x)
        for path in (plain, wrapped, bare):
            u = Unet(model="ultralight", num_classes=CLASSES, input_shape=[32, 32],
                     cuda=False, model_path=str(path))
            assert torch.equal(u.net(x), ref)
    torch.save({**{k: v for k, v in sd.items() if k != "final.bias"}, "extra.weight": x},
               broken)
    with pytest.raises(ValueError, match=r"final\.bias.*extra\.weight"):
        load_state_dict(build_model("ultralight", CLASSES), str(broken))


def test_checkpoint_from_jax_export_loads(pair, tmp_path):
    """A ``.pth`` written by ``tpu_unet``'s exporter from the variables it
    read (BN counters at 0), wrapped as EarlyStopping saves it, loads into
    the port and gives the same logits."""
    from tpu_unet.infer.convert import export_state_dict

    name, ju, tu, path, imgs, _ = pair
    template = {k: v.numpy() for k, v in torch.load(path, weights_only=True).items()}
    exported = export_state_dict(to_numpy(ju.variables), name, template)
    wrapped = tmp_path / "wrapped.pth"
    torch.save({"model_state_dict": {k: torch.as_tensor(np.asarray(v))
                                     for k, v in exported.items()}}, wrapped)
    u = Unet(model=name, num_classes=CLASSES, input_shape=[SIZE, SIZE], cuda=False,
             model_path=str(wrapped))
    x = torch.from_numpy(imgs.astype(np.float32) / 255.0)
    with torch.no_grad():
        assert torch.equal(u.net(x), tu.net(x))
