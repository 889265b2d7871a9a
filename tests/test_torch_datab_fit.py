"""The DataB training recipe around the step, on the CPU: ``heavy_aug`` and
``HeavyAugDataset`` byte-equal to ``tpu_unet``'s, ``WandbLogger`` and
``fit(wandb_logger=)`` through a fake ``wandb`` module (as
``tests/test_wandb_logging.py``), the repaired ``MIoUEvalCallback``
(mIoU and per-class IoU against JAX's callback on the same weights and
images, both curves written, the ``predict_fn`` route), and
``cli train --preset traditional --cpu`` over a seeded VOC-layout tree."""
import contextlib
import io
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from test_torch_fit import write_voc
from test_torch_resnet import randomize_batch_norm, to_numpy
from test_wandb_logging import _fake_wandb

from tpu_unet.data import transforms as JT
from tpu_unet.data.datasets import HeavyAugDataset as JaxHeavy
from tpu_unet.models.registry import build_model as jbuild
from tpu_unet.models.registry import init_model as jinit
from tpu_unet.train.callbacks import MIoUEvalCallback as JaxMIoU
from tpu_unet_torch import cli
from tpu_unet_torch.configs.presets import get_preset
from tpu_unet_torch.data import transforms as T
from tpu_unet_torch.data.datasets import HeavyAugDataset
from tpu_unet_torch.infer.convert import state_dict_from_flax
from tpu_unet_torch.models.registry import build_model
from tpu_unet_torch.train.callbacks import MIoUEvalCallback
from tpu_unet_torch.train.checkpoint import load_any
from tpu_unet_torch.train.fit import fit

CLASSES = 4


@pytest.fixture
def tmp_path(tmp_path):
    """The test's directory, removed once the test is done: the whole-model
    checkpoints written there would otherwise stay behind."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc_heavy")
    train_ids, val_ids = write_voc(str(root), 4, 4, seed=5)
    yield str(root), train_ids, val_ids
    shutil.rmtree(root, ignore_errors=True)


def test_heavy_aug_byte_equal_to_jax():
    """20 seeds: every branch of the suite, every draw in JAX's order."""
    rng = np.random.default_rng(1)
    for seed in range(20):
        img = rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
        lbl = rng.integers(0, CLASSES + 1, (48, 40), dtype=np.uint8)
        a = T.heavy_aug(img.copy(), lbl.copy(), np.random.RandomState(seed))
        b = JT.heavy_aug(img.copy(), lbl.copy(), np.random.RandomState(seed))
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("train", [True, False])
def test_heavy_dataset_byte_equal_to_jax(voc, train):
    """Letterbox, then the heavy suite in train only; 4 images × 5 epochs."""
    root, ids, _ = voc
    path = os.path.join(root, "VOCdevkit")
    a = HeavyAugDataset(ids, (32, 32), CLASSES, train=train, dataset_path=path, seed=11)
    b = JaxHeavy(ids, (32, 32), CLASSES, train=train, dataset_path=path, seed=11)
    for i in range(len(ids)):
        for epoch in range(5):
            (ai, al), (bi, bl) = a.__getitem__(i, epoch=epoch), b.__getitem__(i, epoch=epoch)
            np.testing.assert_array_equal(ai, bi)
            np.testing.assert_array_equal(al, bl)
            assert ai.dtype == np.uint8 and al.dtype == np.int32


@pytest.fixture
def fake_wandb(monkeypatch):
    mod = _fake_wandb()
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


def test_wandb_logger_records_through_fake(fake_wandb):
    from tpu_unet_torch.train.wandb_logging import WandbLogger

    lg = WandbLogger(project="p", name="n", config={"lr": 1e-2})
    assert lg.active and fake_wandb.calls["init"][0]["project"] == "p"
    lg.log_step(3, loss=0.5, f_score=0.9, lr=1e-2)
    lg.log_epoch(1, loss=0.4, val_loss=0.6, lr=1e-2)
    lg.save_checkpoint("ck.pth")
    lg.finish()
    assert fake_wandb.calls["log"] == [{"loss": 0.5, "f_score": 0.9, "lr": 1e-2, "step": 3},
                                       {"loss": 0.4, "val_loss": 0.6, "lr": 1e-2, "epoch": 1}]
    assert fake_wandb.calls["save"] == ["ck.pth"]


def test_wandb_logger_noops_without_wandb(monkeypatch):
    from tpu_unet_torch.train.wandb_logging import WandbLogger

    monkeypatch.setitem(sys.modules, "wandb", None)  # import → ImportError
    lg = WandbLogger()
    assert not lg.active
    lg.log_step(0, loss=1.0)
    lg.log_epoch(0, loss=1.0)
    lg.save_checkpoint("x")
    lg.finish()


def _cfg(root, save_dir, **kw):
    over = dict(input_shape=(32, 32), unfreeze_epoch=1, unfreeze_batch_size=2, save_period=1,
                num_workers=2, save_dir=str(save_dir), dataset_path=os.path.join(root, "VOCdevkit"))
    return get_preset("traditional", **{**over, **kw})


def test_fit_drives_wandb_logger(fake_wandb, voc, tmp_path):
    """``fit`` logs each step and the epoch and saves the periodic
    checkpoint through the logger (the fit_one_epoch_use_wandb contract)."""
    from tpu_unet_torch.train.wandb_logging import WandbLogger

    root, train_ids, val_ids = voc
    fit(_cfg(root, tmp_path), train_ids, val_ids, device="cpu", verbose=False,
        wandb_logger=WandbLogger(project="test"))
    steps = [d for d in fake_wandb.calls["log"] if "step" in d]
    epochs = [d for d in fake_wandb.calls["log"] if "epoch" in d]
    assert [d["step"] for d in steps] == [1, 2] and all(np.isfinite(d["loss"]) for d in steps)
    assert len(epochs) == 1 and epochs[0]["epoch"] == 0
    assert [os.path.basename(p)[:6] for p in fake_wandb.calls["save"]] == ["ep001-"]


def test_miou_callback_matches_jax(voc, tmp_path):
    """The same ``traditional`` weights (batch norm drawn at random) and
    validation images: the port's mIoU and per-class IoU row equal JAX's
    callback's (float32 on both sides), its print has the row, and both
    curves are written; the ``predict_fn`` route gives the same row."""
    root, _, val_ids = voc
    ds = HeavyAugDataset(val_ids, (32, 32), CLASSES, train=False,
                         dataset_path=os.path.join(root, "VOCdevkit"))
    model = jbuild("traditional", CLASSES)
    variables = randomize_batch_norm(to_numpy(jinit(model, (32, 32), seed=2)), seed=6)
    jcb = JaxMIoU(dataset=ds, num_classes=CLASSES, model=model, log_dir=str(tmp_path / "jax"),
                  batch_size=3)
    jmiou = jcb.on_epoch_end(0, jax.tree_util.tree_map(np.asarray, variables))

    net = build_model("traditional", CLASSES)
    net.load_state_dict(state_dict_from_flax(variables, "traditional"), strict=True)
    log = tmp_path / "port"
    cb = MIoUEvalCallback(dataset=ds, num_classes=CLASSES, model=net, log_dir=str(log),
                          batch_size=3)
    assert cb.eval_dtype(torch.device("cpu")) == torch.float32
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        miou = cb.on_epoch_end(0)
    assert cb.on_epoch_end(0) is not None and len(cb.class_ious) == 2
    assert miou == jmiou and np.array_equal(cb.class_ious[0], jcb.class_ious[0])
    assert "per-class" in out.getvalue()
    for name in ("epoch_miou.txt", "epoch_miou.png", "epoch_class_iou.png"):
        assert (log / name).exists(), name

    def predict(img):
        with torch.no_grad():
            x = torch.from_numpy(np.asarray(img, np.float32)[None] / 255.0)
            return net(x)[0].argmax(-1)

    by_fn = MIoUEvalCallback(predict, dataset=ds, num_classes=CLASSES,
                             log_dir=str(tmp_path / "fn"))
    with contextlib.redirect_stdout(io.StringIO()):
        assert by_fn.on_epoch_end(0) == miou
    with pytest.raises(ValueError, match="predict_fn or model"):
        MIoUEvalCallback(dataset=ds, num_classes=CLASSES)


def test_cli_train_traditional_preset(voc, tmp_path):
    """``cli train --preset traditional --cpu``: focal + dice on the heavy
    set, 1 epoch of 2 steps, evaluation on (both curves written), the last
    checkpoint with its epoch."""
    root, _, _ = voc
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["train", "--preset", "traditional", "--cpu", "--data-root", root,
                  "--input-shape", "32", "32", "--batch-size", "2", "--epochs", "1",
                  "--eval-period", "1", "--save-dir", str(tmp_path)])
    text = buf.getvalue()
    assert "Epoch 1/1" in text and "val mIoU" in text
    assert load_any(str(tmp_path / "last_epoch_weights.pth"))["epoch"] == 1
    logs = [d for d in os.listdir(tmp_path) if d.startswith("loss_")]
    assert len(logs) == 1
    for name in ("epoch_miou.png", "epoch_class_iou.png"):
        assert (tmp_path / logs[0] / name).exists(), name
