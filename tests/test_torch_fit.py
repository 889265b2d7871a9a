"""The port's data pipeline and ``fit`` on the CPU: dataset samples and the
loader's order byte-equal to ``tpu_unet``'s, ``reinit_weights`` drawing
JAX's numbers, ``fit`` writing the reference's checkpoints, a full-state
resume, ``partial_load``, and ``cli train --cpu`` (dry run and one epoch)
over a seeded synthetic VOC-layout tree."""
import contextlib
import io
import os
import shutil

import jax
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch
from PIL import Image

from tpu_unet.data.datasets import VOCSegDataset as JaxVOC
from tpu_unet.data.loader import Loader as JaxLoader
from tpu_unet.models.registry import build_model as jbuild
from tpu_unet.models.registry import init_model as jinit
from tpu_unet.train.fit import reinit_weights as jreinit
from tpu_unet_torch import cli
from tpu_unet_torch.configs.presets import get_preset
from tpu_unet_torch.data.datasets import VOCSegDataset
from tpu_unet_torch.data.loader import Loader
from tpu_unet_torch.infer.convert import state_dict_from_flax
from tpu_unet_torch.models.registry import build_model
from tpu_unet_torch.train.checkpoint import load_any, partial_load
from tpu_unet_torch.train.fit import fit, reinit_weights

CLASSES = 4


@pytest.fixture
def tmp_path(tmp_path):
    """The test's directory, removed once the test is done: the whole-model
    checkpoints written there would otherwise stay behind."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def write_voc(root, n_train, n_val, seed=0, size=(40, 48)):
    """VOCdevkit/VOC2012 with rectangle images: a coloured rectangle on a
    gray field, its class as the label, a 2-pixel 255 border."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "VOCdevkit", "VOC2012")
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    ids = [f"im{i:03d}" for i in range(n_train + n_val)]
    h, w = size
    for name in ids:
        img = np.full((h, w, 3), 128, np.uint8)
        lbl = np.zeros((h, w), np.uint8)
        c = int(rng.integers(1, CLASSES))
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        img[y0:y0 + h // 2, x0:x0 + w // 2] = rng.integers(0, 256, 3)
        lbl[y0:y0 + h // 2, x0:x0 + w // 2] = c
        lbl[:2], lbl[-2:], lbl[:, :2], lbl[:, -2:] = 255, 255, 255, 255
        Image.fromarray(img).save(os.path.join(base, "JPEGImages", name + ".jpg"), quality=95)
        Image.fromarray(lbl).save(os.path.join(base, "SegmentationClass", name + ".png"))
    sets = os.path.join(base, "ImageSets", "Segmentation")
    with open(os.path.join(sets, "train.txt"), "w") as f:
        f.write("\n".join(ids[:n_train]))
    with open(os.path.join(sets, "val.txt"), "w") as f:
        f.write("\n".join(ids[n_train:]))
    return ids[:n_train], ids[n_train:]


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    train_ids, val_ids = write_voc(str(root), 6, 2)
    yield str(root), train_ids, val_ids
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("train", [True, False])
def test_samples_byte_equal_to_jax(voc, train):
    root, ids, _ = voc
    path = os.path.join(root, "VOCdevkit")
    a = VOCSegDataset(ids, (32, 32), CLASSES, train=train, dataset_path=path, seed=11)
    b = JaxVOC(ids, (32, 32), CLASSES, train=train, dataset_path=path, seed=11)
    for i in range(len(ids)):
        for epoch in (0, 3):
            (ai, al), (bi, bl) = a.__getitem__(i, epoch=epoch), b.__getitem__(i, epoch=epoch)
            np.testing.assert_array_equal(ai, bi)
            np.testing.assert_array_equal(al, bl)
            assert ai.dtype == np.uint8 and al.dtype == np.int32


def test_loader_order_equal_to_jax(voc):
    root, ids, _ = voc
    path = os.path.join(root, "VOCdevkit")
    ds = VOCSegDataset(ids, (32, 32), CLASSES, train=True, dataset_path=path, seed=3)
    jds = JaxVOC(ids, (32, 32), CLASSES, train=True, dataset_path=path, seed=3)
    a, b = Loader(ds, 2, seed=3, num_workers=2), JaxLoader(jds, 2, seed=3, num_workers=2)
    for epoch in (0, 1):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        np.testing.assert_array_equal(a._epoch_order(), b._epoch_order())
        batches = list(zip(a, b))
        assert len(batches) == len(a) == 3
        for x, y in batches:
            np.testing.assert_array_equal(x["image"], y["image"])
            np.testing.assert_array_equal(x["label"], y["label"])


def test_reinit_weights_draws_jax_numbers():
    # as JAX's fit hands them over: flax's insertion-ordered tree (a
    # tree_map first would sort the keys, and so the draws)
    variables = jinit(jbuild("unet_vgg", CLASSES), (32, 32), seed=0)
    ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jreinit(variables, seed=7)))
    net = reinit_weights(build_model("unet_vgg", CLASSES), seed=7)
    for k, v in net.state_dict().items():
        assert torch.equal(v, ref[k]), k


def _cfg(root, save_dir, **kw):
    over = dict(num_classes=CLASSES, input_shape=(32, 32), unfreeze_epoch=2,
                unfreeze_batch_size=2, save_period=1, num_workers=2,
                save_dir=str(save_dir), dataset_path=os.path.join(root, "VOCdevkit"))
    return get_preset("train_py", **{**over, **kw})


def test_fit_checkpoints_and_resume(voc, tmp_path):
    """Two epochs write best / per-epoch / last checkpoints that serve; a
    resume restores the epoch, best_val and the Adam moments."""
    from tpu_unet_torch.infer.wrapper import Unet

    root, train_ids, val_ids = voc
    state = fit(_cfg(root, tmp_path), train_ids, val_ids, device="cpu", verbose=False)
    names = sorted(os.listdir(tmp_path))
    assert "best_epoch_weights.pth" in names and "last_epoch_weights.pth" in names
    assert sum(n.startswith("ep00") and n.endswith(".pth") for n in names) == 2
    last = load_any(str(tmp_path / "last_epoch_weights.pth"))
    assert last["epoch"] == 2 and last["step"] == state.step == 6
    assert set(last) == {"model_state_dict", "optimizer", "epoch", "best_val", "step"}
    for name in ("best_epoch_weights.pth", "last_epoch_weights.pth"):
        u = Unet(model="unet_vgg", num_classes=CLASSES, input_shape=[32, 32], cuda=False,
                 model_path=str(tmp_path / name))
        assert u.batch_infer(np.zeros((1, 32, 32, 3), np.uint8)).shape == (1, 32, 32)

    out = tmp_path / "resumed"
    resumed = fit(_cfg(root, out, unfreeze_epoch=3, resume=True,
                       model_path=str(tmp_path / "last_epoch_weights.pth")),
                  train_ids, val_ids, device="cpu", verbose=False)
    again = load_any(str(out / "last_epoch_weights.pth"))
    assert again["epoch"] == 3 and again["step"] == 9 and resumed.step == 9
    assert again["best_val"] <= last["best_val"]
    # the moments were restored: Adam's step count went on from 6
    steps = {float(s["step"]) for s in again["optimizer"]["state"].values()}
    assert steps == {9.0}


def test_resume_across_freeze_phases_warns(voc, tmp_path, capsys):
    """A checkpoint of the other freeze phase: the weights and the epoch
    are restored, the moments start fresh, with a warning."""
    root, train_ids, val_ids = voc
    fit(_cfg(root, tmp_path, unfreeze_epoch=1), train_ids, val_ids, device="cpu",
        verbose=False)
    fit(_cfg(root, tmp_path / "b", unfreeze_epoch=2, freeze_train=True, freeze_epoch=2,
             resume=True, model_path=str(tmp_path / "last_epoch_weights.pth")),
        train_ids, val_ids, device="cpu", verbose=False)
    assert "fresh optimizer moments" in capsys.readouterr().out


def test_partial_load_reports_mismatches():
    a = build_model("unet_vgg", CLASSES).state_dict()
    b = build_model("unet_vgg", 7).state_dict()
    b["extra.weight"] = torch.zeros(3)
    merged, ok, skipped = partial_load(a, b, verbose=False)
    assert sorted(skipped) == ["extra.weight", "final.bias", "final.weight"]
    assert len(ok) == len(a) - 2
    assert torch.equal(merged["final.weight"], a["final.weight"])
    assert torch.equal(merged["vgg.features.0.weight"], b["vgg.features.0.weight"])


def _run_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def test_cli_train_dry_run_and_one_epoch(voc, tmp_path):
    root, _, _ = voc
    common = ["train", "--preset", "train_py", "--no-pretrained", "--cpu",
              "--data-root", root, "--num-classes", str(CLASSES), "--input-shape", "32", "32",
              "--batch-size", "2", "--save-dir", str(tmp_path), "--no-eval"]
    text = _run_cli(common + ["--dry-run"])
    assert "dry-run OK" in text and '"train_ids": 6' in text
    assert not os.path.exists(tmp_path / "last_epoch_weights.pth")
    text = _run_cli(common + ["--epochs", "1"])
    assert "Epoch 1/1" in text
    assert load_any(str(tmp_path / "last_epoch_weights.pth"))["epoch"] == 1
    with pytest.raises(NotImplementedError, match="wandb"):
        _run_cli(common + ["--wandb"])


def test_cli_train_voc_preset_float32(voc, tmp_path, monkeypatch):
    """(d) The float32 recipe of the reference's train.py (``--preset voc``:
    fp16=False, the VGG frozen first), ``--no-pretrained --cpu`` at 64²:
    one frozen epoch (its optimizer holds the decoder and the final conv
    only) and one unfrozen (every parameter), the float32 weights written
    and the VGG's trained in the second."""
    from tpu_unet_torch.configs import presets
    from tpu_unet_torch.train import fit as fit_mod

    phases = []
    make = fit_mod.make_optimizer

    def spy(model, *args, **kw):
        opt = make(model, *args, **kw)
        phases.append(len(opt.param_groups[0]["params"]))
        return opt

    monkeypatch.setattr(fit_mod, "make_optimizer", spy)
    # the preset's frozen phase cut to its first epoch
    monkeypatch.setattr(presets, "get_preset",
                        lambda name, **kw: get_preset(name, **{**kw, "freeze_epoch": 1}))
    root, _, _ = voc
    text = _run_cli(["train", "--preset", "voc", "--no-pretrained", "--cpu", "--data-root", root,
                     "--input-shape", "64", "64", "--batch-size", "3", "--epochs", "2",
                     "--no-eval", "--save-dir", str(tmp_path)])
    assert "Epoch 1/2" in text and "Epoch 2/2" in text
    names = [n for n, _ in build_model("unet_vgg", 21).named_parameters()]
    assert phases == [sum(not n.startswith("vgg.") for n in names), len(names)]
    last = load_any(str(tmp_path / "last_epoch_weights.pth"))
    w = last["model_state_dict"]["vgg.features.0.weight"]
    assert last["epoch"] == 2 and w.dtype == torch.float32
    assert len(last["optimizer"]["param_groups"][0]["params"]) == len(names)


def test_missing_pretrained_backbone_raises_as_jax(tmp_path, monkeypatch):
    """The ``voc`` preset asks for ImageNet VGG16 weights: both packages look
    in ``<base_dir>/model_data`` (or ``$TPU_UNET_PRETRAINED_DIR``) and raise
    the same error when the file is absent; nothing is downloaded."""
    from tpu_unet.configs.presets import get_preset as jget
    from tpu_unet.train.fit import resolve_pretrained_path as jresolve
    from tpu_unet_torch.train.fit import resolve_pretrained_path

    monkeypatch.delenv("TPU_UNET_PRETRAINED_DIR", raising=False)
    errors = []
    for resolve, cfg in ((resolve_pretrained_path, get_preset("voc")),
                         (jresolve, jget("voc"))):
        with pytest.raises(FileNotFoundError) as e:
            resolve(cfg, str(tmp_path))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "vgg16-397923af.pth" in errors[0]
    (tmp_path / "model_data").mkdir()
    (tmp_path / "model_data" / "vgg16-397923af.pth").write_bytes(b"")
    assert resolve_pretrained_path(get_preset("voc"), str(tmp_path)).endswith(
        "vgg16-397923af.pth")


@pytest.mark.parametrize("name", ["voc", "train_py", "medical", "traditional", "lightweight",
                                  "ultralight", "ultralight_large",
                                  "ultralight_large_optimized", "wandb_traditional",
                                  "voc_resnet50"])
def test_presets_match_jax(name):
    """The port's copy of each preset it can train equals JAX's, field by
    field (tuples and lists compared as tuples)."""
    import dataclasses

    from tpu_unet.configs.presets import get_preset as jget

    def fields(cfg):
        return {k: tuple(v) if isinstance(v, (list, tuple)) else v
                for k, v in dataclasses.asdict(cfg).items()}

    assert fields(get_preset(name)) == fields(jget(name))
