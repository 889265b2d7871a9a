"""Training callbacks of the port (counterpart of
``tpu_unet/train/callbacks.py``; reference: utils/callbacks.py):

- ``LossHistory``: per-epoch train / val loss → ``epoch_loss.txt`` /
  ``epoch_val_loss.txt``, plus TensorBoard scalars and a loss-curve PNG
  where ``torch.utils.tensorboard`` and matplotlib import;
- ``MIoUEvalCallback``: periodic validation mIoU and per-class IoU
  through the port's confusion matrix (``eval/metrics.py``), with their
  curves;
- ``EarlyStopping``: validation-loss plateau halt with the best state kept.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch


class LossHistory:
    def __init__(self, log_dir: str):
        self.log_dir = os.path.join(log_dir, time.strftime("loss_%Y_%m_%d_%H_%M_%S"))
        os.makedirs(self.log_dir, exist_ok=True)
        self.losses, self.val_losses = [], []
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(self.log_dir)
        except Exception:
            pass

    def append(self, epoch: int, loss: float, val_loss: Optional[float] = None):
        self.losses.append(float(loss))
        with open(os.path.join(self.log_dir, "epoch_loss.txt"), "a") as f:
            f.write(f"{loss}\n")
        if val_loss is not None:
            self.val_losses.append(float(val_loss))
            with open(os.path.join(self.log_dir, "epoch_val_loss.txt"), "a") as f:
                f.write(f"{val_loss}\n")
        if self._writer is not None:
            self._writer.add_scalar("loss", loss, epoch)
            if val_loss is not None:
                self._writer.add_scalar("val_loss", val_loss, epoch)
        self.plot()

    def plot(self):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        n = range(len(self.losses))
        plt.figure()
        plt.plot(n, self.losses, "red", linewidth=2, label="train loss")
        if len(self.val_losses) == len(self.losses):
            plt.plot(n, self.val_losses, "coral", linewidth=2, label="val loss")
        plt.grid(True)
        plt.xlabel("Epoch")
        plt.ylabel("Loss")
        plt.legend(loc="upper right")
        plt.savefig(os.path.join(self.log_dir, "epoch_loss.png"))
        plt.close("all")


class MIoUEvalCallback:
    """Every ``period`` epochs: the validation set's confusion matrix
    (``eval/metrics.py``) → mIoU appended to ``epoch_miou.txt``, the
    per-class IoU row to ``class_ious``, both printed and plotted into
    ``epoch_miou.png`` / ``epoch_class_iou.png`` (reference:
    utils/callbacks.py:244-530; JAX's ``MIoUEvalCallback``).

    Predictions come from ``predict_fn`` (uint8 HWC image → int mask, one
    image at a time) or from ``model``'s serving forward, batched (the live
    model: ``fit`` trains it in place, so ``on_epoch_end`` needs no
    variables).  The model route evaluates in float32 — the float32
    parameters on ``x / 255`` — as JAX's does (its callbacks.py:124-129),
    except where the model's serving forward runs kernels that take bf16
    only: the canonical UNets on the card (``kernels/decoder_fuse.py``),
    evaluated in ``compute_dtype``.  A model whose logits come out at
    another size than the labels (``lightweight``'s half size) fails in the
    confusion matrix, as in JAX, which has no resize there.
    """

    def __init__(self, predict_fn=None, dataset=None, num_classes: int = 21,
                 log_dir: str = "logs", period: int = 1, max_images: Optional[int] = None,
                 model=None, name_classes: Optional[list] = None, batch_size: int = 16,
                 compute_dtype: torch.dtype = torch.bfloat16):
        if predict_fn is None and model is None:
            raise ValueError("need predict_fn or model")
        self.predict_fn = predict_fn
        self.model = model
        self.dataset = dataset
        self.num_classes = num_classes
        self.log_dir = log_dir
        self.period = period
        self.max_images = max_images
        self.name_classes = name_classes
        self.batch_size = max(1, batch_size)
        self.compute_dtype = compute_dtype
        self.mious, self.epochs = [], []
        self.class_ious = []                  # one per-class IoU row per evaluation
        os.makedirs(log_dir, exist_ok=True)

    def eval_dtype(self, device: torch.device) -> torch.dtype:
        """float32, or ``compute_dtype`` for a canonical UNet on the card."""
        from tpu_unet_torch.models.unet import Unet

        if device.type == "cuda" and isinstance(self.model, Unet):
            return self.compute_dtype
        return torch.float32

    @torch.no_grad()
    def _predict(self, imgs: np.ndarray) -> torch.Tensor:
        from torch.func import functional_call

        from tpu_unet_torch.train.step import cast_params

        dev = next(self.model.parameters()).device
        dt = self.eval_dtype(dev)
        x = (torch.from_numpy(imgs).to(dev).float() / 255.0).to(dt)
        logits = functional_call(self.model, cast_params(self.model, dt), (x,))
        if isinstance(logits, (tuple, list)):  # deep supervision
            logits = logits[0]
        return logits.float().argmax(-1)

    def on_epoch_end(self, epoch: int) -> Optional[float]:
        if (epoch + 1) % self.period:
            return None
        from tpu_unet_torch.eval.metrics import confusion_matrix, per_class_iou

        n = len(self.dataset)
        if self.max_images:
            n = min(n, self.max_images)
        hist = torch.zeros((self.num_classes, self.num_classes), dtype=torch.int64)
        if self.predict_fn is not None:
            for i in range(n):
                img, lbl = self.dataset[i]
                hist += confusion_matrix(lbl, self.predict_fn(img), self.num_classes).cpu()
        else:
            for start in range(0, n, self.batch_size):
                samples = [self.dataset[i] for i in range(start, min(start + self.batch_size, n))]
                preds = self._predict(np.stack([s[0] for s in samples]).astype(np.uint8))
                for (_, lbl), pred in zip(samples, preds):
                    hist += confusion_matrix(lbl, pred.cpu(), self.num_classes)
        ious = np.asarray(per_class_iou(hist.numpy()), np.float64)
        miou = float(np.nanmean(ious))
        self.mious.append(miou)
        self.epochs.append(epoch)
        self.class_ious.append(ious)
        with open(os.path.join(self.log_dir, "epoch_miou.txt"), "a") as f:
            f.write(f"{miou}\n")
        print(f"epoch {epoch}: val mIoU {100 * miou:.2f} "
              f"(per-class {[f'{100 * x:.1f}' for x in ious]})")
        self.plot()
        return miou

    def plot(self):
        """mIoU and per-class IoU curves (reference: utils/callbacks.py:464-498),
        where matplotlib imports."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        plt.figure()
        plt.plot(self.epochs, self.mious, "red", linewidth=2, label="mIoU")
        plt.grid(True)
        plt.xlabel("Epoch")
        plt.ylabel("mIoU")
        plt.title("Validation mIoU")
        plt.legend(loc="lower right")
        plt.savefig(os.path.join(self.log_dir, "epoch_miou.png"))
        plt.close("all")

        rows = np.stack(self.class_ious)     # (evaluations, classes)
        plt.figure()
        for c in range(rows.shape[1]):
            label = self.name_classes[c] if self.name_classes else f"class {c}"
            plt.plot(self.epochs, rows[:, c], linewidth=1.5, label=label)
        plt.grid(True)
        plt.xlabel("Epoch")
        plt.ylabel("IoU")
        plt.title("Per-class validation IoU")
        plt.legend(loc="lower right", fontsize="small")
        plt.savefig(os.path.join(self.log_dir, "epoch_class_iou.png"))
        plt.close("all")


class EarlyStopping:
    """Validation-loss plateau halt (reference: utils/callbacks.py:30-171)."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0, mode: str = "min"):
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.best = None
        self.counter = 0
        self.stopped = False
        self.best_state = None

    def __call__(self, metric: float, state=None) -> bool:
        improved = (
            self.best is None
            or (self.mode == "min" and metric < self.best - self.min_delta)
            or (self.mode == "max" and metric > self.best + self.min_delta)
        )
        if improved:
            self.best = metric
            self.counter = 0
            if state is not None:
                # a thunk, so the host copy is made only on improvement
                self.best_state = state() if callable(state) else state
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.stopped = True
        return self.stopped

    def load_best_model(self):
        return self.best_state
