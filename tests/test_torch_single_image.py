"""The port's single-image API (``detect_image``, ``get_miou_png``,
``get_FPS`` and the pieces under them) against ``tpu_unet``'s wrapper on
the CPU, on the same weights and the same seeded PIL image: 50×40, so the
64×64 letterbox has gray bars, for ``traditional`` (DataB's 4 classes,
batch norm drawn at random) and ``unet_vgg`` (21 classes)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import shutil
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch
from PIL import Image
from test_torch_resnet import randomize_batch_norm, to_numpy

from tpu_unet.data.transforms import cvt_rgb as jax_cvt_rgb
from tpu_unet.data.transforms import letterbox_image as jax_letterbox_image
from tpu_unet.infer.wrapper import Unet as JaxUnet
from tpu_unet_torch.data.transforms import cvt_rgb, letterbox_image
from tpu_unet_torch.infer.convert import state_dict_from_flax
from tpu_unet_torch.infer.wrapper import Unet
from tpu_unet_torch.kernels import launch_counts

SIZE = 64


def _image(seed=0, size=(50, 40), mode="RGB"):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (size[1], size[0], 3)).astype(np.uint8)
    return Image.fromarray(arr).convert(mode)


@pytest.fixture(scope="module", params=[("traditional", 4), ("unet_vgg", 21)])
def pair(request, tmp_path_factory):
    """tpu_unet's wrapper at 64×64 and the port's, loaded from the bridged
    weights of the JAX one."""
    name, classes = request.param
    ju = JaxUnet(model=name, num_classes=classes, input_shape=[SIZE, SIZE])
    variables_np = to_numpy(ju.variables)
    if "batch_stats" in variables_np:
        randomize_batch_norm(variables_np, seed=31)
    ju.variables = jax.tree_util.tree_map(jnp.asarray, variables_np)
    path = tmp_path_factory.mktemp("w") / f"{name}.pth"
    torch.save(state_dict_from_flax(variables_np, name), path)
    tu = Unet(model=name, num_classes=classes, input_shape=[SIZE, SIZE],
              cuda=False, model_path=str(path))
    yield ju, tu
    shutil.rmtree(path.parent, ignore_errors=True)


@pytest.mark.parametrize("size", [(50, 40), (40, 50), (64, 64), (130, 20)])
@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
def test_letterbox_bit_equal(size, mode):
    image = _image(sum(size), size, mode)
    rgb, jrgb = cvt_rgb(image), jax_cvt_rgb(image)
    assert rgb.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(rgb), np.asarray(jrgb))
    canvas, nw, nh = letterbox_image(rgb, (SIZE, SIZE))
    jcanvas, jnw, jnh = jax_letterbox_image(jrgb, (SIZE, SIZE))
    assert (nw, nh) == (jnw, jnh) and canvas.size == (SIZE, SIZE)
    np.testing.assert_array_equal(np.asarray(canvas), np.asarray(jcanvas))


def test_probs_match_jax(pair):
    ju, tu = pair
    image = _image()
    counts = dict(launch_counts)
    pr, rgb = tu._probs_for(image)
    assert launch_counts == counts  # the CPU path launches nothing
    ref, _ = ju._probs_for(image)
    assert pr.shape == ref.shape == (51, 64, tu.num_classes)  # bars cropped
    assert pr.dtype == np.float32 and rgb.mode == "RGB"
    np.testing.assert_allclose(pr, ref, atol=1e-5)
    np.testing.assert_allclose(pr.sum(-1), 1.0, atol=1e-5)


def test_device_mask_is_host_argmax(pair):
    ju, tu = pair
    image = _image(1)
    mask, _ = tu._device_mask_for(image)
    pr, _ = tu._probs_for(image)
    assert mask.dtype == np.uint8 and mask.shape == pr.shape[:2]
    np.testing.assert_array_equal(mask, pr.argmax(-1))
    jmask, _ = ju._device_mask_for(image)
    _equal_outside_ties(mask, np.asarray(jmask), ju._probs_for(image)[0])


def _equal_outside_ties(out, ref, probs):
    """Class maps equal wherever the top-1/top-2 probability gap of the JAX
    side exceeds 1e-4 (f32 on both sides, summed in another order)."""
    top2 = np.sort(probs, axis=-1)[..., -2:]
    differ = out != ref
    assert not np.any(differ & (top2[..., 1] - top2[..., 0] > 1e-4))
    return ~differ


def test_miou_png_and_detect_image_match_jax(pair, capsys):
    """``get_miou_png`` against JAX's, and ``detect_image``'s bytes for
    mix_type 0/1/2 equal wherever the two masks are."""
    ju, tu = pair
    image = _image(2)
    png, jpng = tu.get_miou_png(image), ju.get_miou_png(image)
    assert png.mode == "L" and png.size == image.size
    pr = ju._resize_probs(ju._probs_for(image)[0], *image.size)
    same = _equal_outside_ties(np.asarray(png), np.asarray(jpng), pr)
    for mix in (0, 1, 2):
        tu.mix_type = ju.mix_type = mix
        out = np.asarray(tu.detect_image(image, count=True))
        text = capsys.readouterr().out
        ref = np.asarray(ju.detect_image(image, count=True))
        assert out.shape == ref.shape == (40, 50, 3)
        np.testing.assert_array_equal(out[same], ref[same])
        if same.all():  # the class table printed by count=True, too
            assert text == capsys.readouterr().out
    tu.mix_type = ju.mix_type = 0


def test_fast_paths_and_fps_run(pair):
    ju, tu = pair
    image = _image(3, (70, 30))
    png, jpng = tu.get_miou_png(image, fast=True), ju.get_miou_png(image, fast=True)
    assert png.size == image.size
    mask, _ = tu._device_mask_for(image)
    jmask, _ = ju._device_mask_for(image)
    if np.array_equal(mask, np.asarray(jmask)):
        np.testing.assert_array_equal(np.asarray(png), np.asarray(jpng))
    for mix in (0, 1, 2):
        tu.mix_type = mix
        out = tu.detect_image(image, fast=True)
        assert out.size == image.size and out.mode == "RGB"
    tu.mix_type = 0
    for full_d2h in (False, True):
        seconds = tu.get_FPS(image, 2, full_d2h=full_d2h)
        assert 0 < seconds < 60


def test_resize_probs_without_cv2(pair, monkeypatch):
    """Without OpenCV the probability map is resized by the port's own
    bilinear resize (half-pixel centres), as the JAX wrapper does."""
    from tpu_unet_torch.infer import wrapper

    ju, tu = pair
    pr = np.random.default_rng(4).random((51, 64, tu.num_classes), np.float32)
    with_cv2 = tu._resize_probs(pr, 50, 40)
    monkeypatch.setattr(wrapper, "_cv2", lambda: None)
    without = tu._resize_probs(pr, 50, 40)
    assert without.shape == with_cv2.shape == (40, 50, tu.num_classes)
    # cv2 rounds its bilinear weights to 11 bits
    np.testing.assert_allclose(without, with_cv2, atol=2e-3)


def test_without_cv2_matches_jax(pair, monkeypatch):
    """Without OpenCV both wrappers resize the probabilities with their own
    bilinear resize and the fast mask with PIL's nearest; the class maps
    agree wherever the JAX probabilities are not near a tie."""
    import tpu_unet.infer.wrapper as jax_wrapper
    from tpu_unet_torch.infer import wrapper

    ju, tu = pair
    monkeypatch.setattr(wrapper, "_cv2", lambda: None)
    monkeypatch.setattr(jax_wrapper, "cv2", None)
    image = _image(5, (70, 30))
    pr = ju._resize_probs(ju._probs_for(image)[0], *image.size)
    png, jpng = tu.get_miou_png(image), ju.get_miou_png(image)
    _equal_outside_ties(np.asarray(png), np.asarray(jpng), pr)
    fast, jfast = tu.get_miou_png(image, fast=True), ju.get_miou_png(image, fast=True)
    assert fast.size == image.size
    if np.array_equal(tu._device_mask_for(image)[0], np.asarray(ju._device_mask_for(image)[0])):
        np.testing.assert_array_equal(np.asarray(fast), np.asarray(jfast))


def test_colors(pair):
    _, tu = pair
    assert tu.colors[:2] == [(0, 0, 0), (128, 0, 0)]
    wide = Unet(model="traditional22", num_classes=30, input_shape=[SIZE, SIZE],
                cuda=False)
    assert len(wide.colors) == 30 and wide.colors[0] == (255, 0, 0)


def test_card_api_raises_without_card(monkeypatch):
    """``cuda=True`` (the default) never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Unet(model="traditional", num_classes=4, input_shape=[SIZE, SIZE])
