"""The port's second slice end to end on the CPU: ``unet_resnet50`` (random
batch norm) and ``self_net`` through the weight bridge, their logits and
``Unet.serving_step`` against ``tpu_unet``'s on the same weights and batch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import shutil
import torch
from test_torch_resnet import randomize_batch_norm, to_numpy

from tpu_unet.infer.wrapper import Unet as JaxUnet
from tpu_unet.nn.resize import resize_bilinear as jax_resize_bilinear
from tpu_unet_torch.infer.convert import state_dict_from_flax
from tpu_unet_torch.infer.wrapper import Unet
from tpu_unet_torch.models.registry import build_model

SIZE, CLASSES = 64, 21


@pytest.fixture(scope="module", params=["unet_resnet50", "self_net"])
def pair(request, tmp_path_factory):
    """tpu_unet's wrapper at 64×64 (batch norm drawn at random) and the
    port's, loaded from the bridged weights of the JAX one."""
    name = request.param
    ju = JaxUnet(model=name, num_classes=CLASSES, input_shape=[SIZE, SIZE])
    variables_np = to_numpy(ju.variables)
    if "batch_stats" in variables_np:
        randomize_batch_norm(variables_np, seed=11)
    ju.variables = jax.tree_util.tree_map(jnp.asarray, variables_np)
    ju._serving = None
    path = tmp_path_factory.mktemp("w") / f"{name}.pth"
    torch.save(state_dict_from_flax(variables_np, name), path)
    tu = Unet(model=name, num_classes=CLASSES, input_shape=[SIZE, SIZE],
              cuda=False, model_path=str(path))
    yield name, ju, tu
    shutil.rmtree(path.parent, ignore_errors=True)


def _images(seed, n=2):
    return np.random.default_rng(seed).integers(
        0, 256, (n, SIZE, SIZE, 3)).astype(np.uint8)


def _jax_logits(ju, imgs):
    return np.asarray(jax.jit(ju.net.apply)(ju.variables,
                                            imgs.astype(np.float32) / 255.0))


def test_bridge_logits_match(pair):
    name, ju, tu = pair
    imgs = _images(0)
    ref = _jax_logits(ju, imgs)
    # self_net's head doubles the resolution
    assert ref.shape == (2, 2 * SIZE if name == "self_net" else SIZE,
                         ref.shape[2], CLASSES)
    with torch.no_grad():
        out = tu.net(torch.from_numpy(imgs.astype(np.float32) / 255.0)).numpy()
    # f32 both sides, up to 60 conv layers summed in another order
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def test_bridge_key_count(pair):
    name, ju, tu = pair
    sd = state_dict_from_flax(to_numpy(ju.variables), name)
    assert len(sd) == {"unet_resnet50": 340, "self_net": 2 * (13 + 8 + 2 + 1)}[name]
    assert list(sd) == list(build_model(name, CLASSES).state_dict())


def test_serving_step_matches_jax(pair):
    """Masks equal wherever the top-1/top-2 logit gap exceeds 1e-4 of the
    logit scale (f32 on both sides), hist = bincount(masks)."""
    name, ju, tu = pair
    imgs = _images(1)
    jfn, jvars = ju.serving_step()
    jm, jh = (np.asarray(a) for a in jfn(jvars, imgs))
    fn, net = tu.serving_step()
    masks, hist = fn(net, imgs)
    masks, hist = masks.numpy(), hist.numpy()
    assert masks.shape == (2, SIZE, SIZE) and masks.dtype == np.uint8
    assert hist.shape == (2, CLASSES) and hist.dtype == np.int32
    logits = _jax_logits(ju, imgs)
    if logits.shape[1:3] != (SIZE, SIZE):
        logits = np.asarray(jax_resize_bilinear(jnp.asarray(logits), (SIZE, SIZE),
                                                align_corners=True))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    differ = masks != jm
    assert not np.any(differ & (gap > 1e-4 * np.abs(logits).max()))
    assert hist.sum() == 2 * SIZE * SIZE
    for i in range(2):
        np.testing.assert_array_equal(hist[i], np.bincount(masks[i].ravel(), minlength=CLASSES))
    if not differ.any():
        np.testing.assert_array_equal(hist, jh)
    np.testing.assert_array_equal(tu.batch_infer(imgs), masks.astype(np.int32))
