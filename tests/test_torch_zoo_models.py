"""The last eight registry models (``sk_ultralight``, ``repvgg_segnet``,
``improved_ultralight``, ``hybrid_efficientseg`` and the four balancedseg
models) on the CPU against ``tpu_unet``: parameter counts, the bridge's keys
(in the model's order, and read back by JAX's own converter), eval logits
at 64×64 on seeded weights in JAX's variables tree carried across by the
bridge (batch norm and dense biases drawn at random), the generic serving
step's masks, the single-image API, ``fold_repvgg`` and ``cli fold``.  One
JAX tree, one jitted JAX forward and one bridge per model, shared by the
file's cases."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch
from test_torch_datab_train import _key_tree, _ordered
from test_torch_ladder import randomize_dense_biases
from test_torch_resnet import randomize_batch_norm, to_numpy

from tpu_unet.infer.convert import CONVERTERS
from tpu_unet.models.registry import MODELS as JAX_MODELS
from tpu_unet.models.registry import build_model as jbuild
from tpu_unet.models.repvgg import fold_repvgg as jfold
from tpu_unet_torch import cli
from tpu_unet_torch.infer.convert import state_dict_from_flax
from tpu_unet_torch.infer.wrapper import Unet
from tpu_unet_torch.kernels import launch_counts
from tpu_unet_torch.models.registry import MODELS, build_model
from tpu_unet_torch.models.repvgg import fold_repvgg

SIZE, C = 64, 4
# the JAX package's parameter counts at 4 classes (tests/test_models.py:14-33)
COUNTS = {"improved_ultralight": 759_252, "sk_ultralight": 1_105_563,
          "repvgg_segnet": 4_629_563, "hybrid_efficientseg": 960_896,
          "balancedseg": 802_096, "balancedseg_fpn": 803_520,
          "balancedseg_fpn_sup": 804_428, "balancedseg_crfs": 800_190}
NAMES = list(COUNTS)


def seeded_variables(name, size=32, seed=0):
    """JAX's variables tree of ``name`` (its dicts in flax's insertion order,
    recorded while ``jax.eval_shape`` traces ``init``, so nothing is
    compiled) with seeded numpy values: kernels N(0, 1/fan-in), biases
    0.1·N(0, 1), batch norm as flax starts it.  Made anew each call."""
    model, keys = jbuild(name, C), {}

    def init(x):
        variables = model.init({"params": jax.random.PRNGKey(0),
                                "dropout": jax.random.PRNGKey(1)}, x, True)
        keys["tree"] = _key_tree(variables)
        return variables

    shapes = jax.eval_shape(init, jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        kind = path[-1].key
        if kind == "kernel":
            std = np.prod(leaf.shape[:-1]) ** -0.5
            return (std * rng.standard_normal(leaf.shape)).astype(np.float32)
        if kind == "bias" and path[0].key == "params":
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (np.ones if kind in ("scale", "var") else np.zeros)(leaf.shape, np.float32)

    return _ordered(jax.tree_util.tree_map_with_path(fill, shapes), keys["tree"])


@pytest.fixture
def tmp_path(tmp_path):
    """The test's directory, removed once the test is done."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


_LOADED: dict = {}


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    """The directory of the file's checkpoints, removed with the loaded
    models at the end of the module."""
    path = tmp_path_factory.mktemp("w")
    yield path
    _LOADED.clear()
    shutil.rmtree(path, ignore_errors=True)


def _load(name, weights_dir):
    """Seeded JAX weights at 64² (batch norm and dense biases drawn),
    the port's model on them through the bridge, saved as a ``.pth``, and
    JAX's float32 eval logits of a seeded uint8 batch / 255; made once a
    model."""
    if name not in _LOADED:
        jv = seeded_variables(name, SIZE)
        randomize_batch_norm(jv, seed=3)
        randomize_dense_biases(jv["params"], np.random.default_rng(4))
        sd = state_dict_from_flax(jv, name)
        net = build_model(name, C)
        net.load_state_dict(sd, strict=True)
        imgs = np.random.default_rng(7).integers(0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)
        logits = np.asarray(jax.jit(jbuild(name, C).apply, static_argnums=2)(
            jax.tree_util.tree_map(jnp.asarray, jv), imgs.astype(np.float32) / 255.0, False))
        path = weights_dir / f"{name}.pth"
        torch.save(sd, path)
        _LOADED[name] = (name, jv, sd, net.eval(), str(path), imgs, logits)
    return _LOADED[name]


@pytest.fixture(scope="module", params=NAMES)
def zoo(request, weights_dir):
    return _load(request.param, weights_dir)


@pytest.fixture(scope="module")
def repvgg(weights_dir):
    return _load("repvgg_segnet", weights_dir)


@pytest.fixture(scope="module")
def balanced(weights_dir):
    return _load("balancedseg", weights_dir)


def test_registry_has_jax_names():
    assert list(MODELS) == list(JAX_MODELS)


@pytest.mark.parametrize("name", NAMES)
def test_parameter_counts(name):
    """The port's count, JAX's and the JAX package's recorded one agree."""
    n = sum(p.numel() for p in build_model(name, C).parameters())
    model = jbuild(name, C)
    jv = jax.eval_shape(lambda key, x: model.init(key, x, False), jax.random.PRNGKey(0),
                        jnp.zeros((1, 32, 32, 3)))
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jv["params"]))
    assert n == COUNTS[name]


def test_logits_match_jax(zoo):
    """Float32 eval logits within 1e-4 of max|logit| of JAX's."""
    _, _, _, net, _, imgs, ref = zoo
    assert ref.shape == (2, SIZE, SIZE, C)
    with torch.no_grad():
        out = net(torch.from_numpy(imgs.astype(np.float32) / 255.0)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_bridge_keys_in_model_order(zoo):
    """The bridge gives the model's state-dict keys in its order, and JAX's
    own converter (``tpu_unet/infer/convert.py::CONVERTERS``, the reference
    torch names) reads the port's state dict back into JAX's variables."""
    name, jv, sd, net, _, _, _ = zoo
    assert list(sd) == list(net.state_dict())
    back = CONVERTERS[name]({k: v.numpy() for k, v in sd.items()
                             if "num_batches_tracked" not in k})
    flat = jax.tree_util.tree_flatten_with_path(back)[0]
    ref = dict(jax.tree_util.tree_flatten_with_path(jv)[0])
    assert len(flat) == len(ref)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(leaf), ref[path], err_msg=str(path))


def test_serving_step_matches_jax(zoo):
    """``Unet(model_path=...)`` on the CPU: the generic serving step
    (``argmax_mask``'s plain version) against JAX's logits: masks equal
    wherever the top-1/top-2 gap exceeds 1e-4 of the logit scale, hist =
    bincount(masks), no kernel launched."""
    name, _, _, _, path, imgs, logits = zoo
    u = Unet(model=name, num_classes=C, input_shape=[SIZE, SIZE], cuda=False,
             model_path=path)
    fn, net = u.serving_step()
    counts = dict(launch_counts)
    masks, hist = fn(net, imgs)
    assert launch_counts == counts
    masks, hist = masks.numpy(), hist.numpy()
    assert masks.shape == (2, SIZE, SIZE) and masks.dtype == np.uint8
    top2 = np.sort(logits, axis=-1)[..., -2:]
    differ = masks != logits.argmax(-1)
    assert not np.any(differ & (top2[..., 1] - top2[..., 0] > 1e-4 * np.abs(logits).max()))
    for i in range(2):
        np.testing.assert_array_equal(hist[i], np.bincount(masks[i].ravel(), minlength=C))


def test_single_image_api():
    """``detect_image`` / ``get_miou_png`` of a deep-supervision model on the
    CPU: sizes and modes of the outputs, the mask a class index."""
    from PIL import Image

    u = Unet(model="balancedseg_fpn_sup", num_classes=C, input_shape=[SIZE, SIZE],
             cuda=False)
    image = Image.fromarray(np.random.default_rng(2).integers(0, 256, (40, 52, 3),
                                                              dtype=np.uint8))
    out = u.detect_image(image)
    assert out.size == image.size and out.mode == "RGB"
    png = u.get_miou_png(image, fast=True)
    assert png.size == image.size and int(np.asarray(png).max()) < C


def test_reference_balancedseg_checkpoint_skips_unused_modules(balanced, tmp_path):
    """A reference OptimizedBalancedSeg checkpoint holds CBAM and edge
    weights that its forward never applies: the wrapper loads it without
    them, as ``convert_balancedseg`` does; another unknown key still
    raises."""
    name, _, sd, _, _, _, _ = balanced
    extra = {"enc1_cbam.channel_attention.shared_mlp.0.weight": torch.ones(2, 32),
             "edge_enhancement.conv.0.weight": torch.ones(16, 32, 3, 3)}
    torch.save({"model_state_dict": {**sd, **extra}}, tmp_path / "ref.pth")
    u = Unet(model=name, num_classes=C, input_shape=[SIZE, SIZE], cuda=False,
             model_path=str(tmp_path / "ref.pth"))
    assert torch.equal(u.net.aux_head.weight, sd["aux_head.weight"])
    torch.save({**sd, "enc1_se.extra.weight": torch.ones(1)}, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="enc1_se.extra.weight"):
        Unet(model=name, num_classes=C, input_shape=[SIZE, SIZE], cuda=False,
             model_path=str(tmp_path / "bad.pth"))


# --- RepVGG fold -------------------------------------------------------------

def test_fold_matches_jax_fold(repvgg):
    """``fold_repvgg`` on the port's state dict against JAX's
    ``fold_repvgg`` on its variables, carried across by the bridge: the
    deploy model's keys in its order, every folded kernel and bias within
    1e-6 of its scale, every other entry equal; the running statistics of
    the folded batch norms are gone."""
    _, jv, sd, _, _, _, _ = repvgg
    folded = fold_repvgg(sd)
    ref = state_dict_from_flax(to_numpy(jfold(jv)), "repvgg_segnet")
    deploy = build_model("repvgg_segnet", C, deploy=True)
    assert list(folded) == list(ref) == list(deploy.state_dict())
    assert sum(".reparam." in k for k in folded) == 2 * 9
    assert not any(".conv.3.bn1." in k or ".id_bn." in k for k in folded)
    for k, v in folded.items():
        if ".reparam." in k:
            err = (v - ref[k]).abs().max() / ref[k].abs().max()
            assert err <= 1e-6, (k, err)
        else:
            assert torch.equal(v, ref[k]), k


def test_folded_model_matches_training_form(repvgg):
    """The deploy model on the folded weights against the training form in
    eval: logits within 1e-5 of max|logit|."""
    _, _, sd, net, _, imgs, _ = repvgg
    deploy = build_model("repvgg_segnet", C, deploy=True)
    deploy.load_state_dict(fold_repvgg(sd), strict=True)
    x = torch.from_numpy(imgs.astype(np.float32) / 255.0)
    with torch.no_grad():
        ref, out = net(x), deploy.eval()(x)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_cli_fold_end_to_end(repvgg, tmp_path):
    """``cli fold`` on a port full-state checkpoint writes the deploy state
    dict; ``Unet(model_path=...)`` builds the deploy model from it and
    serves the training form's masks wherever the top-1/top-2 gap exceeds
    1e-4 of the logit scale."""
    _, _, sd, net, _, imgs, _ = repvgg
    src, out = tmp_path / "train.pth", tmp_path / "out" / "deploy.pth"
    torch.save({"model_state_dict": sd, "optimizer": {}, "epoch": 1, "best_val": 0.5,
                "step": 3}, src)
    cli.main(["fold", "--model-path", str(src), "--out", str(out)])
    saved = torch.load(out, weights_only=True)
    assert list(saved) == list(fold_repvgg(sd))
    u = Unet(model="repvgg_segnet", num_classes=C, input_shape=[SIZE, SIZE], cuda=False,
             model_path=str(out))
    assert u.net.enc1.conv[3].deploy and not hasattr(u.net.enc1.conv[3], "conv1")
    with torch.no_grad():
        logits = net(torch.from_numpy(imgs.astype(np.float32) / 255.0)).numpy()
    masks = u.batch_infer(imgs)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    differ = masks != logits.argmax(-1)
    assert not np.any(differ & (top2[..., 1] - top2[..., 0] > 1e-4 * np.abs(logits).max()))
