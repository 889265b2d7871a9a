"""The port's ResNet50 encoder (models/backbones.py) and its pieces against
tpu_unet's, in float32 on the CPU: the five features on bridged weights with
batch norm made non-trivial, the ceil-mode max-pool, the bridge's key set
with the batch-norm buffers, and the seeded init of batch norm."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch

from tpu_unet.models.backbones import ResNet50 as JaxResNet50
from tpu_unet.models.registry import build_model as jax_build_model
from tpu_unet.nn.blocks import max_pool_ceil as jax_max_pool_ceil
from tpu_unet_torch.infer.convert import state_dict_from_flax
from tpu_unet_torch.models.registry import build_model, init_model
from tpu_unet_torch.nn.blocks import max_pool_ceil

SIZE, CLASSES = 64, 21


def to_numpy(tree):
    """JAX variables → nested dict of writable float32 numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.array(tree, np.float32)


def randomize_batch_norm(variables_np, seed):
    """Draw every batch norm's scale, bias, mean and var (in place), so that
    no batch norm is the identity of a fresh init."""
    rng = np.random.default_rng(seed)

    def walk(p, s):
        if "mean" in s:
            n = s["mean"].shape
            p["scale"] = (1 + 0.2 * rng.standard_normal(n)).astype(np.float32)
            p["bias"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
            s["mean"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
            s["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            return
        for k in s:
            walk(p[k], s[k])

    walk(variables_np["params"], variables_np["batch_stats"])
    return variables_np


@pytest.fixture(scope="module")
def rn50():
    """tpu_unet's unet_resnet50 variables at 64×64 with random batch norm,
    and the port's model loaded strictly from their bridge."""
    model = jax_build_model("unet_resnet50", CLASSES)
    x = np.zeros((1, SIZE, SIZE, 3), np.float32)
    # jitted: an eager flax init of ResNet50 takes several times longer
    jv = to_numpy(jax.jit(model.init, static_argnums=2)(jax.random.PRNGKey(0), x, False))
    randomize_batch_norm(jv, seed=3)
    net = build_model("unet_resnet50", CLASSES)
    net.load_state_dict(state_dict_from_flax(jv, "unet_resnet50"), strict=True)
    return jv, net.eval()


def test_resnet50_features_match_jax(rn50):
    jv, net = rn50
    x = np.random.default_rng(0).random((2, SIZE, SIZE, 3), np.float32)
    ref = JaxResNet50().apply({"params": jv["params"]["resnet"],
                               "batch_stats": jv["batch_stats"]["resnet"]},
                              jnp.asarray(x), False)
    with torch.no_grad():
        out = net.resnet(torch.from_numpy(x))
    widths = (64, 256, 512, 1024, 2048)
    for i, (o, r) in enumerate(zip(out, ref)):
        r = np.asarray(r)
        assert o.shape == r.shape == (2, SIZE >> (i + 1), SIZE >> (i + 1), widths[i])
        assert o.is_contiguous()
        # f32 both sides, up to 53 convs summed in another order
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max(), err_msg=f"feat{i + 1}")


@pytest.mark.parametrize("h,w", [(7, 9), (8, 33), (9, 8), (33, 7)])
def test_max_pool_ceil_matches_jax(h, w):
    x = np.random.default_rng(h * w).standard_normal((2, h, w, 5)).astype(np.float32)
    ref = np.asarray(jax_max_pool_ceil(jnp.asarray(x), 3, 2))
    out = max_pool_ceil(torch.from_numpy(x), 3, 2).numpy()
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_bridge_is_strict_with_bn_buffers(rn50):
    jv, _ = rn50
    sd = state_dict_from_flax(jv, "unet_resnet50")
    # resnet: conv1 + bn1 (5 keys), 16 bottlenecks × (3 convs + 3 BN × 5),
    # 4 downsamples × (conv + BN × 5); decoder 8 convs, head 2, final 1 (×2)
    assert len(sd) == 6 + 16 * 18 + 4 * 6 + 2 * (8 + 2 + 1) == 340
    assert sd["resnet.layer2.0.downsample.1.num_batches_tracked"].dtype == torch.int64
    np.testing.assert_array_equal(
        sd["resnet.layer4.2.bn3.running_var"].numpy(),
        jv["batch_stats"]["resnet"]["layer4_2"]["bn3"]["var"])
    net = build_model("unet_resnet50", CLASSES)
    sd.pop("resnet.layer3.5.bn2.running_mean")
    with pytest.raises(RuntimeError, match="running_mean"):
        net.load_state_dict(sd, strict=True)


def test_bridge_refuses_unported_model():
    """The bridge covers every registry name and refuses any other."""
    with pytest.raises(ValueError, match="weight bridge"):
        state_dict_from_flax({}, "sk_ultralight_v2")


def test_init_model_batch_norm_as_flax():
    net = init_model(build_model("unet_resnet50", CLASSES), seed=0)
    bns = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == 53
    for bn in bns:
        assert torch.equal(bn.weight, torch.ones_like(bn.weight))
        assert not bn.bias.any() and not bn.running_mean.any()
        assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    # ResNet convs carry no bias; their kernels are lecun-normal draws
    assert net.resnet.conv1.bias is None
    w = net.resnet.layer4[2].conv2.weight
    assert abs(w.std().item() * np.sqrt(9 * 512) - 1.0) < 0.02
