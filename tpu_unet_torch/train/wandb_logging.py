"""wandb experiment tracking (the port's own copy of
``tpu_unet/train/wandb_logging.py``; reference: utils/utils_fit.py:286-471,
per-iteration and per-epoch ``wandb.log`` and the checkpoints'
``wandb.save``, and the training scripts' ``wandb.init`` blocks,
dataB-train_Supervision.py:104-124).

Every call does nothing when ``wandb`` does not import or its ``init``
fails: training never depends on the tracker.  ``cli train --wandb`` checks
the import first and raises with the reason.
"""
from __future__ import annotations

from typing import Optional


class WandbLogger:
    def __init__(self, project: str = "tpu-unet", name: Optional[str] = None,
                 config: Optional[dict] = None, enabled: bool = True):
        self._run = None
        if not enabled:
            return
        try:
            import wandb

            self._wandb = wandb
            self._run = wandb.init(project=project, name=name, config=config or {})
        except Exception:
            self._run = None

    @property
    def active(self) -> bool:
        return self._run is not None

    def log_step(self, step: int, **metrics):
        """Per-iteration metrics (reference: utils/utils_fit.py:363-372)."""
        if self._run is not None:
            self._wandb.log({**metrics, "step": step})

    def log_epoch(self, epoch: int, **metrics):
        """Per-epoch metrics (reference: utils/utils_fit.py:419-427)."""
        if self._run is not None:
            self._wandb.log({**metrics, "epoch": epoch})

    def save_checkpoint(self, path: str):
        """reference: utils/utils_fit.py:458-471."""
        if self._run is not None:
            self._wandb.save(path)

    def finish(self):
        if self._run is not None:
            self._run.finish()
