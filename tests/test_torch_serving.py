"""The port's slice end to end on the CPU: weight bridge, registry init, and
``Unet.serving_step`` against ``tpu_unet``'s on the same weights and batch."""
import jax
import numpy as np
import pytest
import shutil
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch

from tpu_unet.infer.wrapper import Unet as JaxUnet
from tpu_unet_torch.infer.convert import state_dict_from_flax
from tpu_unet_torch.infer.wrapper import Unet
from tpu_unet_torch.models.registry import build_model, init_model

SIZE, CLASSES = 64, 21


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """tpu_unet's unet_vgg wrapper at 64×64 and the port's, loaded from the
    bridged weights of the JAX one."""
    ju = JaxUnet(model="unet_vgg", num_classes=CLASSES, input_shape=[SIZE, SIZE])
    variables_np = jax.tree_util.tree_map(np.asarray, ju.variables)
    path = tmp_path_factory.mktemp("w") / "unet_vgg.pth"
    torch.save(state_dict_from_flax(variables_np), path)
    tu = Unet(model="unet_vgg", num_classes=CLASSES, input_shape=[SIZE, SIZE],
              cuda=False, model_path=str(path))
    yield ju, tu, variables_np
    shutil.rmtree(path.parent, ignore_errors=True)


def _images(seed, n=2):
    return np.random.default_rng(seed).integers(
        0, 256, (n, SIZE, SIZE, 3)).astype(np.uint8)


def test_bridge_logits_match(pair):
    ju, tu, _ = pair
    imgs = _images(0)
    ref = np.asarray(ju.net.apply(ju.variables, imgs.astype(np.float32) / 255.0, False))
    with torch.no_grad():
        out = tu.net(torch.from_numpy(imgs)).numpy()
    # f32 both sides, 21 conv layers summed in another order
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_bridge_is_strict(pair):
    _, _, variables_np = pair
    sd = state_dict_from_flax(variables_np)
    assert len(sd) == 2 * (13 + 8 + 1)
    net = build_model("unet_vgg", CLASSES)
    net.load_state_dict(sd, strict=True)
    sd.pop("final.bias")
    with pytest.raises(RuntimeError):
        net.load_state_dict(sd, strict=True)


def test_serving_step_matches_jax(pair):
    """The slice: masks equal wherever the top-1/top-2 logit gap exceeds
    1e-4 of the logit scale (f32 on both sides), hist = bincount(masks)."""
    ju, tu, _ = pair
    imgs = _images(1)
    jfn, jvars = ju.serving_step()
    jm, jh = (np.asarray(a) for a in jfn(jvars, imgs))
    fn, net = tu.serving_step()
    masks, hist = fn(net, imgs)
    masks, hist = masks.numpy(), hist.numpy()
    assert masks.shape == (2, SIZE, SIZE) and masks.dtype == np.uint8
    assert hist.shape == (2, CLASSES) and hist.dtype == np.int32
    logits = np.asarray(ju.net.apply(ju.variables, imgs.astype(np.float32) / 255.0, False))
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


def test_cuda_default_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert Unet.get_defaults("cuda") is True
    with pytest.raises(RuntimeError, match="CUDA"):
        Unet(input_shape=[SIZE, SIZE])


def test_init_model_seeded_lecun():
    a = init_model(build_model("unet_vgg", CLASSES), seed=0)
    b = init_model(build_model("unet_vgg", CLASSES), seed=0)
    c = init_model(build_model("unet_vgg", CLASSES), seed=1)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb)
        if name.endswith("bias"):
            assert not pa.any()
        else:
            assert not torch.equal(pa, pc)
    # lecun normal: std sqrt(1 / fan_in) within 2% on the 2.4M-weight conv
    w = a.vgg.features[28].weight
    assert abs(w.std().item() * np.sqrt(9 * 512) - 1.0) < 0.02
