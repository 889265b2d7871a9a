"""The port's ``ctypes`` binding of ``native/loader.cc`` (``data/native.py``):
built with ``g++`` into ``build/``, byte-equal to the PIL letterbox and to
``tpu_unet``'s binding, a decode failure raising ``RuntimeError``, and the
PIL path where the library cannot be built."""
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tpu_unet.data import native as jax_native
from tpu_unet_torch.data import native
from tpu_unet_torch.data.transforms import cvt_rgb, letterbox_image

HEADERS = all(Path(f"/usr/include/{h}").exists() for h in ("jpeglib.h", "png.h"))


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None or not HEADERS:
        pytest.skip("needs g++ and the libjpeg / libpng headers")
    assert native.available(), native.route()
    return native.get_lib()


def _images(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i, (w, h, ext) in enumerate([(40, 30, ".png"), (31, 77, ".jpg"), (128, 128, ".png"),
                                     (300, 200, ".jpg")]):
        arr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        p = tmp_path / f"img{i}{ext}"
        Image.fromarray(arr).save(p, quality=90)
        paths.append(str(p))
    return paths


def test_library_is_built_in_build_dir(lib):
    assert native.route() == "native"
    path = Path(lib._name)
    assert path.parent == native.BUILD and path.name.startswith("libtpuunet_loader_")
    assert path.resolve() != (native.SOURCE.parent / "libtpuunet_loader.so").resolve()


@pytest.mark.parametrize("out", [(128, 128), (100, 64)])
def test_letterbox_batch_equals_pil_and_jax(lib, tmp_path, out):
    paths = _images(tmp_path)
    batch, nws, nhs = native.load_letterbox_batch(paths, *out, n_threads=3)
    assert batch.shape == (len(paths), *out, 3) and batch.dtype == np.uint8
    for i, p in enumerate(paths):
        boxed, nw, nh = letterbox_image(cvt_rgb(Image.open(p)), out)
        np.testing.assert_array_equal(batch[i], np.asarray(boxed))
        assert (nws[i], nhs[i]) == (nw, nh)
    jbatch, jnws, jnhs = jax_native.load_letterbox_batch(paths, *out)
    np.testing.assert_array_equal(batch, jbatch)
    np.testing.assert_array_equal(nws, jnws)
    np.testing.assert_array_equal(nhs, jnhs)


def test_resize_bicubic_equals_pil(lib):
    arr = np.random.default_rng(1).integers(0, 256, (53, 37, 3)).astype(np.uint8)
    for nh, nw in ((256, 256), (20, 90)):
        ref = np.asarray(Image.fromarray(arr).resize((nw, nh), Image.BICUBIC))
        np.testing.assert_array_equal(native.resize_bicubic(arr, nh, nw), ref)


def test_decode_failure_raises(lib, tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8not a real jpeg")
    with pytest.raises(RuntimeError, match="failed to decode"):
        native.load_letterbox_batch([str(bad)], 64, 64)


def test_pil_path_without_library(monkeypatch, tmp_path):
    """Where the library cannot be built every entry point takes the PIL
    path, with the same bytes, and ``route`` says why."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_why_not", None)
    monkeypatch.setattr(native, "_cxx", lambda: None)
    paths = _images(tmp_path)
    assert not native.available()
    assert native.route().startswith("PIL (no C++ compiler")
    batch, nws, nhs = native.load_letterbox_batch(paths, 96, 96)
    for i, p in enumerate(paths):
        boxed, nw, nh = letterbox_image(cvt_rgb(Image.open(p)), (96, 96))
        np.testing.assert_array_equal(batch[i], np.asarray(boxed))
        assert (nws[i], nhs[i]) == (nw, nh)
    arr = np.asarray(Image.open(paths[0]).convert("RGB"))
    np.testing.assert_array_equal(native.resize_bicubic(arr, 10, 12),
                                  np.asarray(Image.fromarray(arr).resize((12, 10),
                                                                         Image.BICUBIC)))
