"""The port's inference entry points on the CPU against ``tpu_unet``'s: the
batched folder path, the video paths, the offline mIoU evaluation and
its confusion matrix, the presets and both CLI subcommands with ``--cpu``.
Both packages read the same ``.pth`` (the port's seeded ``ultralight``
weights, biases and batch norm drawn at random) at 64×64, 4 classes."""
import jax
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch
from PIL import Image
from test_torch_ladder import randomize

from tpu_unet.configs.infer_presets import INFER_PRESETS as JAX_PRESETS
from tpu_unet.data.datasets import read_split as jax_read_split
from tpu_unet.eval import driver as jax_driver
from tpu_unet.eval.metrics import confusion_matrix as jax_confusion_matrix
from tpu_unet.infer.wrapper import Unet as JaxUnet
from tpu_unet.tools import predict as jax_predict
from tpu_unet_torch import cli
from tpu_unet_torch.configs.infer_presets import INFER_PRESETS, build_wrapper
from tpu_unet_torch.data.datasets import read_split
from tpu_unet_torch.data.native import load_letterbox_batch
from tpu_unet_torch.eval import driver
from tpu_unet_torch.eval.metrics import confusion_matrix
from tpu_unet_torch.infer.wrapper import Unet
from tpu_unet_torch.kernels import launch_counts
from tpu_unet_torch.models.registry import build_model, init_model
from tpu_unet_torch.tools import predict

SIZE, CLASSES, MODEL = 64, 4, "ultralight"
SIZES = [(60, 45, ".jpg"), (64, 64, ".png"), (37, 80, ".jpg"), (100, 70, ".png"),
         (64, 64, ".jpg"), (50, 50, ".png")]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(weights path, image dir, ids, ground-truth dir, JAX wrapper, port
    wrapper)."""
    root = tmp_path_factory.mktemp("tools")
    path = root / "w.pth"
    torch.save(randomize(init_model(build_model(MODEL, CLASSES), seed=50), seed=51).state_dict(),
               path)
    img_dir, gt_dir = root / "img", root / "gt"
    img_dir.mkdir()
    gt_dir.mkdir()
    rng = np.random.default_rng(52)
    ids = []
    for i, (w, h, ext) in enumerate(SIZES):
        yy, xx = np.mgrid[0:h, 0:w]
        f = rng.uniform(0.05, 0.3, 3)
        arr = 127 + 120 * np.sin(f * (xx[..., None] + 0.5 * yy[..., None]))
        arr = np.clip(arr + rng.normal(0, 10, arr.shape), 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(img_dir / f"im{i}{ext}", quality=95)
        gt = rng.integers(0, CLASSES, (h, w)).astype(np.uint8)
        gt[:2] = 255  # ignored border
        Image.fromarray(gt).save(gt_dir / f"im{i}.png")
        if ext == ".jpg":
            ids.append(f"im{i}")
    ju = JaxUnet(model=MODEL, num_classes=CLASSES, input_shape=[SIZE, SIZE],
                 model_path=str(path))
    tu = Unet(model=MODEL, num_classes=CLASSES, input_shape=[SIZE, SIZE], cuda=False,
              model_path=str(path))
    return str(path), img_dir, ids, gt_dir, ju, tu


def _pngs(d):
    return {p.name: np.asarray(Image.open(p)) for p in sorted(d.glob("*.png"))}


def test_predict_dir_batched_matches_jax(setup, tmp_path):
    """One PNG per image at the model's size; the classes equal JAX's
    wherever the JAX top-1/top-2 logit gap exceeds 1e-4 of the scale (in
    practice everywhere); the CPU path launches nothing."""
    path, img_dir, _, _, ju, tu = setup
    counts = dict(launch_counts)
    n = predict.predict_dir_batched(tu, str(img_dir), str(tmp_path / "t"), batch_size=4)
    assert launch_counts == counts
    assert n == jax_predict.predict_dir_batched(ju, str(img_dir), str(tmp_path / "j"),
                                                batch_size=4) == len(SIZES)
    ours, ref = _pngs(tmp_path / "t"), _pngs(tmp_path / "j")
    assert list(ours) == list(ref) == [f"im{i}.png" for i in range(len(SIZES))]
    paths = sorted(str(p) for p in img_dir.iterdir())
    batch, _, _ = load_letterbox_batch(paths, SIZE, SIZE)
    logits = np.asarray(jax.jit(ju.net.apply, static_argnums=2)(
        ju.variables, batch.astype(np.float32) / 255.0, False))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    for i, name in enumerate(ours):
        assert ours[name].shape == (SIZE, SIZE) and ours[name].dtype == np.uint8
        differ = ours[name] != ref[name]
        assert not np.any(differ & (gap[i] > 1e-4 * np.abs(logits).max())), name


def test_predict_video_frame_counts(setup, tmp_path):
    cv2 = pytest.importorskip("cv2")
    *_, tu = setup
    clip = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (80, 48))
    assert writer.isOpened()
    rng = np.random.default_rng(53)
    for _ in range(10):
        writer.write(rng.integers(0, 256, (48, 80, 3)).astype(np.uint8))
    writer.release()

    def frames(p):
        cap = cv2.VideoCapture(p)
        n = 0
        while cap.read()[0]:
            n += 1
        cap.release()
        return n

    assert predict.predict_video_batched(tu, clip, str(tmp_path / "b.avi"), batch_size=4) == 10
    assert frames(str(tmp_path / "b.avi")) == 10
    assert predict.predict_video_batched(tu, clip, str(tmp_path / "c.avi"), batch_size=4,
                                         max_frames=5) == 8  # whole batches
    n, fps = predict.predict_video(tu, clip, str(tmp_path / "v.avi"), max_frames=6)
    assert n == 6 and fps > 0 and frames(str(tmp_path / "v.avi")) == 6


def test_evaluate_matches_jax(setup, tmp_path, capsys):
    """``evaluate`` writes the same prediction PNGs as JAX's and gives the
    same summary and printout; a size-mismatched pair is skipped."""
    _, img_dir, ids, gt_dir, ju, tu = setup
    out = driver.evaluate(tu, ids, str(gt_dir), CLASSES, image_dir=str(img_dir),
                          pred_dir=str(tmp_path / "t"))
    text = capsys.readouterr().out
    ref = jax_driver.evaluate(ju, ids, str(gt_dir), CLASSES, image_dir=str(img_dir),
                              pred_dir=str(tmp_path / "j"))
    assert text == capsys.readouterr().out and "mIoU" in text
    ours, jpngs = _pngs(tmp_path / "t"), _pngs(tmp_path / "j")
    assert list(ours) == list(jpngs) == [f"{i}.png" for i in ids]
    for k in ours:
        np.testing.assert_array_equal(ours[k], jpngs[k])
    for k in ("miou", "mpa", "accuracy"):
        assert out[k] == ref[k]
    for k in ("per_class_iou", "per_class_recall", "per_class_precision"):
        np.testing.assert_array_equal(out[k], ref[k])
    assert out["hist"].sum() == sum((np.asarray(Image.open(gt_dir / f"{i}.png")) < 255).sum()
                                    for i in ids)
    # a ground truth of another size is skipped
    Image.fromarray(np.zeros((5, 5), np.uint8)).save(tmp_path / "small.png")
    (tmp_path / "gt2").mkdir()
    for i in ids:
        (tmp_path / "gt2" / f"{i}.png").write_bytes((gt_dir / f"{i}.png").read_bytes())
    (tmp_path / "gt2" / f"{ids[0]}.png").write_bytes((tmp_path / "small.png").read_bytes())
    skip = driver.evaluate(tu, ids, str(tmp_path / "gt2"), CLASSES, image_dir=str(img_dir))
    assert "skipped 1 size-mismatched pairs" in capsys.readouterr().out
    assert skip["hist"].sum() < out["hist"].sum()
    driver.show_results(out, str(tmp_path / "res"))
    np.testing.assert_array_equal(
        np.loadtxt(tmp_path / "res" / "confusion_matrix.csv", delimiter=",", dtype=np.int64),
        out["hist"])


def test_evaluate_npy_matches_jax(tmp_path):
    rng = np.random.default_rng(54)
    for i in range(4):
        shape = (20, 30) if i != 2 else (20, 31)
        gt = rng.integers(0, CLASSES, shape)
        gt[0] = 255
        np.save(tmp_path / f"ground_truth_{i:06d}.npy", gt if i != 2 else gt[:, :30])
        np.save(tmp_path / f"prediction_{i:06d}.npy", rng.integers(-1, CLASSES + 2, shape))
    np.save(tmp_path / "prediction_000009.npy", np.zeros((20, 30), np.int64))  # no gt
    out = driver.evaluate_npy(str(tmp_path), str(tmp_path), CLASSES, verbose=False)
    ref = jax_driver.evaluate_npy(str(tmp_path), str(tmp_path), CLASSES, verbose=False)
    for k in ("miou", "mpa", "accuracy"):
        assert out[k] == ref[k]
    np.testing.assert_array_equal(out["per_class_iou"], ref["per_class_iou"])
    assert out["hist"].sum() == 3 * 19 * 30


@pytest.mark.parametrize("n", [2, 4, 21])
def test_confusion_matrix_exact(n):
    """Ground truth 255 and outside [0, n) ignored, predictions clipped."""
    rng = np.random.default_rng(n)
    gt = rng.integers(0, n, (3, 33, 47))
    gt[:, :3] = 255
    gt[0, 5, :4] = -1
    pred = rng.integers(-2, n + 3, gt.shape)
    out = confusion_matrix(gt, pred, n)
    assert out.dtype == torch.int64 and tuple(out.shape) == (n, n)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax_confusion_matrix(gt, pred, n)))
    valid = (gt >= 0) & (gt < n)
    assert int(out.sum()) == int(valid.sum())
    t = confusion_matrix(torch.from_numpy(gt.astype(np.uint8)), torch.from_numpy(pred), n)
    valid_u8 = gt.astype(np.uint8) < n
    assert int(t.sum()) == int(valid_u8.sum())


def test_presets_and_split_match_jax(tmp_path):
    assert INFER_PRESETS == JAX_PRESETS
    split = tmp_path / "val.txt"
    split.write_text("a\n\n b \nc\n")
    assert read_split(str(split)) == jax_read_split(str(split)) == ["a", "b", "c"]
    u = build_wrapper("ultralight_large_optimized", cuda=False, input_shape=[32, 32])
    assert (u.model, u.num_classes, u.input_shape, u.device.type) == \
        ("ultralight_large_optimized", 4, [32, 32], "cpu")
    with pytest.raises(KeyError, match="unknown inference preset"):
        build_wrapper("nope", cuda=False)


def test_cli_predict_and_miou(setup, tmp_path, capsys):
    """Both subcommands in the process with ``--cpu``: ``dir_batched``
    writes what ``predict_dir_batched`` writes, ``miou`` prints what
    ``evaluate`` prints; ``single`` saves a blended image."""
    path, img_dir, ids, gt_dir, _, tu = setup
    common = ["--model-path", path, "--input-shape", str(SIZE), str(SIZE), "--cpu"]
    cli.main(["predict", "--preset", MODEL, "--mode", "dir_batched", "--input", str(img_dir),
              "--output", str(tmp_path / "cli"), "--batch-size", "4", *common])
    assert f"processed {len(SIZES)} images" in capsys.readouterr().out
    predict.predict_dir_batched(tu, str(img_dir), str(tmp_path / "api"), batch_size=4)
    ours, ref = _pngs(tmp_path / "cli"), _pngs(tmp_path / "api")
    assert list(ours) == list(ref)
    for k in ours:
        np.testing.assert_array_equal(ours[k], ref[k])

    split = tmp_path / "val.txt"
    split.write_text("\n".join(ids))
    cli.main(["miou", "--preset", MODEL, "--split", str(split), "--image-dir", str(img_dir),
              "--gt-dir", str(gt_dir), *common])
    text = capsys.readouterr().out
    driver.evaluate(tu, ids, str(gt_dir), CLASSES, image_dir=str(img_dir))
    assert text == capsys.readouterr().out and "mIoU" in text

    cli.main(["predict", "--preset", MODEL, "--mode", "single", "--input",
              str(img_dir / "im0.jpg"), "--output", str(tmp_path / "one"), *common])
    assert Image.open(tmp_path / "one.jpg").size == (60, 45)
    cli.main(["predict", "--preset", MODEL, "--mode", "dir", "--input", str(img_dir),
              "--output", str(tmp_path / "dir"), "--save-npy", *common])
    assert sorted(p.name for p in (tmp_path / "dir").glob("seg_*.jpg")) == \
        [f"seg_im{i}.jpg" for i in range(len(SIZES))]
    assert np.load(tmp_path / "dir" / "seg_im3.npy").shape == (70, 100)
    capsys.readouterr()
    cli.main(["predict", "--preset", MODEL, "--mode", "fps", "--input", str(img_dir / "im1.png"),
              "--test-interval", "2", *common])
    assert "FPS, @batch_size 1" in capsys.readouterr().out
