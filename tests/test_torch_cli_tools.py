"""The port's parameter count, ``summary`` (``tools/summary.py``, ``cli
summary``), competition export (``tools/results_export.py``) and dataset
annotation tools (``tools/annotation.py``) on the CPU against ``tpu_unet``:
the parameter count of all 18 registry models (JAX's from ``jax.eval_shape``,
nothing compiled), the FLOP count against one worked out from the weight
shapes and each stage's feature size, ``export_results`` on three seeded
images with two models, the packed submission and the NaN audit, and the
split files, label audit and labelme conversion byte for byte."""
import base64
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch
from PIL import Image
from test_torch_ladder import randomize

from tpu_unet.infer.wrapper import Unet as JaxUnet
from tpu_unet.models.registry import MODELS as JAX_MODELS
from tpu_unet.models.registry import build_model as jbuild
from tpu_unet.models.registry import count_params as jcount_params
from tpu_unet.tools import annotation as jann
from tpu_unet.tools import results_export as jres
from tpu_unet_torch import cli
from tpu_unet_torch.infer.wrapper import Unet
from tpu_unet_torch.models.registry import MODELS, build_model, count_params, init_model
from tpu_unet_torch.tools import annotation as tann
from tpu_unet_torch.tools import results_export as tres
from tpu_unet_torch.tools.summary import summarize


@pytest.fixture
def tmp_path(tmp_path):
    """The test's directory, removed once the test is done."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("name", sorted(JAX_MODELS))
def test_count_params_matches_jax(name):
    assert set(MODELS) == set(JAX_MODELS)
    model = jbuild(name, 4)
    shapes = jax.eval_shape(
        lambda x: model.init({"params": jax.random.PRNGKey(0),
                              "dropout": jax.random.PRNGKey(1)}, x, False),
        jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32))
    with torch.device("meta"):  # shapes only, no init
        net = build_model(name, 4)
    # batch norm's running statistics are buffers, outside both counts
    assert count_params(net) == jcount_params(shapes) > 0


def _stage(name):
    """Each conv's feature-size divisor, by its module name."""
    if name.startswith("vgg.features."):
        i = int(name.split(".")[2])
        return 1 if i < 5 else 2 if i < 10 else 4 if i < 17 else 8 if i < 24 else 16
    if name.startswith("up_concat"):
        return 2 ** (int(name[9]) - 1)
    for prefix, d in (("down1", 2), ("down2", 4), ("down3", 8), ("up1", 4), ("up2", 2)):
        if name.startswith(prefix):
            return d
    return 1  # inc, up3, outc, final


@pytest.mark.parametrize("name,size,classes", [("traditional", 32, 4), ("unet_vgg", 64, 21)])
def test_summary_flops_from_the_shapes(name, size, classes, capsys):
    """2 × the multiply-adds of every conv (``outc`` / ``final`` run as a
    matrix product) at its stage's feature size; the params line as JAX
    prints it."""
    res = summarize(name, (size, size), classes)
    with torch.device("meta"):
        net = build_model(name, classes)
    want = 0
    for mname, m in net.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            o, i, kh, kw = m.weight.shape
            want += 2 * (size // _stage(mname)) ** 2 * o * i * kh * kw
    assert res == {"params": count_params(net), "flops": float(want)}
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == [f"model: {name} @ {(size, size)} batch=1",
                         f"Total params:  {count_params(net):,}"]
    assert lines[2] == f"Total GFLOPs:  {want / 1e9:.3f}"


def test_cli_summary_prints_jax_params(capsys):
    cli.main(["summary", "--model", "traditional", "--size", "32", "--num-classes", "4", "--cpu"])
    out = capsys.readouterr().out
    # JAX's CLI prints the same (tests/test_cli.py:26-30)
    assert out.splitlines()[:2] == ["model: traditional @ (32, 32) batch=1",
                                    "Total params:  1,949,796"]


def _write_images(root, n=3, size=(40, 30), classes=4):
    rng = np.random.default_rng(11)
    img_dir, gt_dir = root / "jpg", root / "png"
    img_dir.mkdir()
    gt_dir.mkdir()
    ids = [f"im{i}" for i in range(n)]
    for name in ids:
        arr = rng.integers(0, 256, (size[1], size[0], 3)).astype(np.uint8)
        Image.fromarray(arr).save(img_dir / f"{name}.jpg")
        Image.fromarray(rng.integers(0, classes, (size[1], size[0])).astype(np.uint8)).save(
            gt_dir / f"{name}.png")
    return ids, str(img_dir), str(gt_dir)


def wrapper_pair(name, tmp_path, size=32, classes=4, seed=5):
    """tpu_unet's wrapper and the port's on the same weights: the port's
    seeded init with every bias and batch norm drawn at random, saved as a
    reference ``.pth`` that both read (no JAX init is compiled)."""
    net = randomize(init_model(build_model(name, classes), seed=seed), seed=seed + 1)
    path = tmp_path / f"{name}.pth"
    torch.save(net.state_dict(), path)
    kw = dict(model=name, num_classes=classes, input_shape=[size, size], model_path=str(path))
    return JaxUnet(**kw), Unet(cuda=False, **kw)


def test_export_results_matches_jax(tmp_path, capsys):
    """Two models over three seeded images: IoUs, mIoU, parameter counts and
    every ``.npy`` dump equal to JAX's; the metrics file is the dict's
    ``repr``; then the packed submission and the NaN audit."""
    ids, img_dir, gt_dir = _write_images(tmp_path)
    (jt, tt), (jl, tl) = wrapper_pair("traditional", tmp_path), wrapper_pair("ultralight", tmp_path)
    out, jout = tmp_path / "port", tmp_path / "jax"
    got = tres.export_results({"UNet": tt, "OursModel": tl}, ids, img_dir, gt_dir, 4,
                              str(out), fps_iters=1)
    ref = jres.export_results({"UNet": jt, "OursModel": jl}, ids, img_dir, gt_dir, 4,
                              str(jout), fps_iters=1)
    for m in ("UNet", "OursModel"):
        fps = got[m].pop("FPS")
        assert fps > 0 and ref[m].pop("FPS") > 0
        assert got[m] == ref[m]
        files = sorted(os.listdir(out / m))
        assert files == sorted(os.listdir(jout / m)) and len(files) == 6
        for f in files:
            a, b = np.load(out / m / f), np.load(jout / m / f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    text = (out / tres.METRICS_FILE).read_text(encoding="utf-8")
    assert text.startswith("{'UNet': {'Class1_IoU': ") and "'Parameters': 1949796" in text

    capsys.readouterr()
    np.save(out / "OursModel" / "prediction_000009.npy", np.array([0.5, np.nan], np.float32))
    assert tres.check_nan_in_npy(str(out / "OursModel")) == 1
    assert jres.check_nan_in_npy(str(out / "OursModel")) == 1
    assert tres.check_nan_in_npy(str(out / "UNet")) == 0
    text = capsys.readouterr().out
    assert text.count("NaN found in prediction_000009.npy") == 2 and "0 files with NaN" in text
    archive = tres.pack_submission(str(out), str(tmp_path / "sub.zip"))
    assert archive == str(tmp_path / "sub.zip")
    import zipfile
    with zipfile.ZipFile(archive) as z:
        names = set(z.namelist())
    assert tres.METRICS_FILE in names and "UNet/prediction_000000.npy" in names


def _labels(seg, arrays):
    seg.mkdir()
    for i, a in enumerate(arrays):
        Image.fromarray(a).save(seg / f"lab{i:02d}.png")


@pytest.mark.parametrize("case", ["multi", "binary_255", "binary_gt1"])
def test_splits_and_label_audit_match_jax(case, tmp_path, capsys):
    rng = np.random.default_rng(3)
    if case == "multi":
        arrays = [rng.integers(0, 5, (6, 7)).astype(np.uint8) for _ in range(11)]
        arrays.append(rng.integers(0, 5, (6, 7, 3)).astype(np.uint8))  # not gray
    elif case == "binary_255":
        arrays = [(rng.integers(0, 2, (6, 7)) * 255).astype(np.uint8) for _ in range(5)]
    else:
        arrays = [rng.integers(0, 3, (6, 7)).astype(np.uint8) for _ in range(5)]
    _labels(tmp_path / "seg", arrays)
    seg = str(tmp_path / "seg")
    splits = tann.generate_splits(seg, str(tmp_path / "a"), 0.9, 0.75, seed=4)
    text = capsys.readouterr().out
    assert splits == jann.generate_splits(seg, str(tmp_path / "b"), 0.9, 0.75, seed=4)
    assert text == capsys.readouterr().out
    for f in ("train", "val", "trainval", "test"):
        assert (tmp_path / "a" / f"{f}.txt").read_bytes() == \
            (tmp_path / "b" / f"{f}.txt").read_bytes()
    classes = 2 if case.startswith("binary") else 5
    counts = tann.audit_labels(seg, splits["trainval"], classes)
    text = capsys.readouterr().out
    np.testing.assert_array_equal(counts, jann.audit_labels(seg, splits["trainval"], classes))
    assert text == capsys.readouterr().out and "| %15s |" % "Key" in text


def test_json_to_dataset_matches_jax(tmp_path):
    """A seeded labelme JSON (its image base64 in ``imageData``, polygons of
    two known labels and one unknown) → identical jpg and png."""
    rng = np.random.default_rng(9)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)).save(buf, "PNG")
    shapes = [{"label": "crack", "points": [[2, 2], [20, 3], [12, 18]]},
              {"label": "hole", "points": [[25, 5], [31, 5], [31, 20], [24, 22]]},
              {"label": "other", "points": [[0, 20], [8, 23], [2, 23]]}]
    (tmp_path / "json").mkdir()
    for k in range(2):
        doc = {"imageData": base64.b64encode(buf.getvalue()).decode(), "shapes": shapes[k:]}
        (tmp_path / "json" / f"s{k}.json").write_text(json.dumps(doc), encoding="utf-8")
    classes = ["_background_", "crack", "hole"]
    for mod, out in ((tann, "a"), (jann, "b")):
        mod.json_to_dataset(str(tmp_path / "json"), str(tmp_path / out / "jpg"),
                            str(tmp_path / out / "png"), classes)
    for sub in ("jpg", "png"):
        names = sorted(os.listdir(tmp_path / "a" / sub))
        assert names == sorted(os.listdir(tmp_path / "b" / sub)) and len(names) == 2
        for f in names:
            assert (tmp_path / "a" / sub / f).read_bytes() == (tmp_path / "b" / sub / f).read_bytes()
    mask = np.asarray(Image.open(tmp_path / "a" / "png" / "s0.png"))
    assert set(np.unique(mask)) == {0, 1, 2}
