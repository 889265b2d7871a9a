"""The full training recipe of the port (counterpart of
``tpu_unet/train/fit.py``; reference: train.py:40-506, utils/utils_fit.py):
seed → model build / init / partial load → the freeze and unfreeze phases
(optimizer rebuilt and its moments reset at the boundary, batch size and
lr recomputed) → per-epoch cos / step lr → train and validation epochs →
callbacks and checkpoints, with early stopping and a full-state resume;
``wandb_logger`` logs each step and epoch and saves the periodic
checkpoints, as JAX's.

Each step's Dropout2d draws from its own generator on the device, seeded
from ``(cfg.seed, epoch · 100003 + step)`` as JAX folds its dropout key
(``fit.py:298``): the structure of JAX's keys, not their bits.

Everything runs on the card (``device="cuda"``, the default) unless the
caller asks for the CPU.  JAX's mesh calls have no counterpart: one
process, one device (multi-GPU is ROADMAP §1 item 6).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from tpu_unet_torch.configs.presets import TrainConfig
from tpu_unet_torch.core.precision import BF16_PRECISION, DEFAULT_PRECISION
from tpu_unet_torch.data.datasets import (DefectSegDataset, HeavyAugDataset,
                                          MedicalSegDataset, VOC2007SegDataset,
                                          VOCSegDataset)
from tpu_unet_torch.data.loader import Loader
from tpu_unet_torch.models.registry import build_model, init_model
from tpu_unet_torch.train.callbacks import EarlyStopping, LossHistory
from tpu_unet_torch.train.checkpoint import (load_any, partial_load, save_full_state,
                                             save_variables)
from tpu_unet_torch.train.schedules import adaptive_lr, get_lr_scheduler
from tpu_unet_torch.train.step import (FREEZE_PREFIXES, StepConfig, TrainState,
                                       make_eval_step, make_optimizer, make_train_step)

DATASETS = {
    "voc": VOCSegDataset,
    "voc2007": VOC2007SegDataset,
    "medical": MedicalSegDataset,
    "defect": DefectSegDataset,
    "heavy": HeavyAugDataset,
}

# the torchvision ImageNet checkpoints the reference downloads into
# ./model_data (nets/vgg.py:69, nets/resnet.py:181), by model
BACKBONE_FOR_MODEL = {"unet_vgg": "vgg", "unet_resnet50": "resnet50", "self_net": "vgg"}
TORCHVISION_FILES = {"vgg": "vgg16-397923af.pth", "resnet50": "resnet50-19c8e357.pth"}


@torch.no_grad()
def reinit_weights(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """weights_init (reference: nets/unet_training.py:58-76), as JAX's
    ``reinit_weights`` draws it with its defaults: ``np.random.RandomState
    (seed)``, batch-norm scales ~ N(1, 0.02) first, then every conv kernel
    ~ N(0, 0.02) in HWIO order, zero biases (dense layers' too, as JAX
    zeroes the bias of every layer with a kernel); dense kernels keep their
    init.  ``model.modules()`` lists the batch norms and convs in flax's
    param-tree order for every model of the registry: where the two trees
    order their entries differently (the ladder's ``enc{i}`` / ``se{i}``,
    balancedseg's ``enc{i}_se``), the entries in between are SE gates,
    which hold neither; the other models register their modules in flax's
    creation order (improved_ultralight's ``fusion{i}`` before ``dec{i}``,
    SKConv's ``conv.{i}`` before ``fc1``, RepVGG's 3×3 branch before its
    1×1 and identity, the FPN's aux heads 3, 2, 1)."""
    rng = np.random.RandomState(seed)
    mods = list(model.modules())
    for m in mods:
        if isinstance(m, torch.nn.BatchNorm2d):
            m.weight.copy_(torch.from_numpy(
                np.asarray(rng.normal(1.0, 0.02, tuple(m.weight.shape)), np.float32)))
            m.bias.zero_()
    for m in mods:
        if not isinstance(m, torch.nn.Conv2d):
            continue
        o, i, kh, kw = m.weight.shape
        k = rng.normal(0.0, 0.02, (kh, kw, i, o))  # HWIO, as JAX draws it
        m.weight.copy_(torch.from_numpy(np.asarray(k, np.float32).transpose(3, 2, 0, 1)))
        if m.bias is not None:
            m.bias.zero_()
    for m in mods:
        if isinstance(m, torch.nn.Linear) and m.bias is not None:
            m.bias.zero_()
    return model


def resolve_pretrained_path(cfg: TrainConfig, base_dir: str = ".") -> str:
    """The torchvision ImageNet checkpoint for ``cfg.model``: its explicit
    path, else ``$TPU_UNET_PRETRAINED_DIR`` or ``<base_dir>/model_data``;
    raises when absent (nothing is downloaded)."""
    if cfg.model not in BACKBONE_FOR_MODEL:
        raise KeyError(
            f"pretrained_backbone=True but model {cfg.model!r} has no "
            f"ImageNet-pretrainable backbone (only {sorted(BACKBONE_FOR_MODEL)})")
    if cfg.pretrained_path:
        candidates = [cfg.pretrained_path]
    else:
        fname = TORCHVISION_FILES[BACKBONE_FOR_MODEL[cfg.model]]
        dirs = []
        if os.environ.get("TPU_UNET_PRETRAINED_DIR"):
            dirs.append(os.environ["TPU_UNET_PRETRAINED_DIR"])
        dirs.append(os.path.join(base_dir, "model_data"))
        candidates = [os.path.join(d, fname) for d in dirs]
    for path in candidates:
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(
        f"pretrained_backbone=True but no ImageNet checkpoint found at "
        f"{candidates} — download the torchvision file, place it there or "
        f"set TrainConfig.pretrained_path / $TPU_UNET_PRETRAINED_DIR, or "
        f"set pretrained_backbone=False to train from random init.")


def load_pretrained_backbone(model: torch.nn.Module, path: str, model_name: str):
    """A torchvision ImageNet checkpoint into the backbone (``vgg.*`` or
    ``resnet.*``), every backbone key required (reference: train.py:271-279)."""
    prefix = "vgg" if BACKBONE_FOR_MODEL[model_name] == "vgg" else "resnet"
    src = torch.load(path, map_location="cpu", weights_only=True)
    own = {k: v for k, v in model.state_dict().items() if k.startswith(prefix + ".")}
    sd = {f"{prefix}.{k}": v for k, v in src.items() if f"{prefix}.{k}" in own}
    missing = sorted(set(own) - set(sd))
    if missing:
        raise ValueError(f"{path}: backbone keys missing: {missing[:10]}")
    model.load_state_dict(sd, strict=False)
    return model


def make_datasets(cfg: TrainConfig, base_dir: str, train_ids, val_ids, seed: int):
    ds_cls = DATASETS[cfg.dataset]
    root = cfg.dataset_path if os.path.isabs(cfg.dataset_path) \
        else os.path.join(base_dir, cfg.dataset_path)
    return (ds_cls(train_ids, cfg.input_shape, cfg.num_classes, train=True,
                   dataset_path=root, seed=seed),
            ds_cls(val_ids, cfg.input_shape, cfg.num_classes, train=False,
                   dataset_path=root, seed=seed))


def fit(cfg: TrainConfig, train_ids, val_ids, base_dir: str = ".",
        device: str | torch.device = "cuda", max_steps_per_epoch: Optional[int] = None,
        verbose: bool = True, wandb_logger=None, miou_callback=None,
        auto_eval_callback: bool = False) -> TrainState:
    """Run the two-phase training; returns the final :class:`TrainState`.
    ``device="cpu"`` runs on the CPU through the kernels' plain versions.
    ``wandb_logger``: a :class:`~tpu_unet_torch.train.wandb_logging.WandbLogger`
    (reference: utils/utils_fit.py:286-471); ``miou_callback``: a
    :class:`~tpu_unet_torch.train.callbacks.MIoUEvalCallback`, or one over the
    validation set with ``auto_eval_callback`` (reference: train.py:445-446)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit(device='cuda') needs a CUDA device; pass "
                           "device='cpu' to train on the CPU")
    model = init_model(build_model(cfg.model, cfg.num_classes), seed=cfg.seed)
    if not cfg.pretrained_backbone and not cfg.model_path:
        reinit_weights(model, seed=cfg.seed)
    if cfg.pretrained_backbone:
        path = resolve_pretrained_path(cfg, base_dir)
        if verbose:
            print(f"Loading ImageNet backbone weights from {path}.")
        load_pretrained_backbone(model, path, cfg.model)
    resumed = None
    if cfg.model_path:
        loaded = load_any(cfg.model_path)
        merged, _, _ = partial_load(model.state_dict(),
                                    loaded.get("model_state_dict", loaded), verbose)
        model.load_state_dict(merged)
        if cfg.resume:
            if "optimizer" not in loaded:
                raise ValueError(
                    f"resume=True but {cfg.model_path} is a weights-only checkpoint "
                    f"(no optimizer state) — set resume=False and init_epoch by "
                    f"hand for a weights-only warm start")
            resumed = loaded
    model = model.to(device).train()

    step_cfg = StepConfig(
        num_classes=cfg.num_classes, cls_weights=tuple(cfg.resolved_cls_weights()),
        use_focal=cfg.focal_loss, use_dice=cfg.dice_loss,
        aux_weights=tuple(cfg.aux_weights),
        compute_dtype=(BF16_PRECISION if cfg.fp16 else DEFAULT_PRECISION).compute_dtype)
    train_step = make_train_step(model, step_cfg)
    eval_step = make_eval_step(model, step_cfg)

    train_ds, val_ds = make_datasets(cfg, base_dir, train_ids, val_ids, cfg.seed)
    loss_history = LossHistory(cfg.save_dir) if verbose else None
    if auto_eval_callback and miou_callback is None and cfg.eval_flag and len(val_ds):
        from tpu_unet_torch.train.callbacks import MIoUEvalCallback

        miou_callback = MIoUEvalCallback(
            dataset=val_ds, num_classes=cfg.num_classes, model=model,
            log_dir=loss_history.log_dir if loss_history else cfg.save_dir,
            period=cfg.eval_period, compute_dtype=step_cfg.compute_dtype)
    stopper = EarlyStopping(cfg.patience) if cfg.patience else None

    state = None
    best_val = np.inf
    frozen_now = None
    epoch = cfg.init_epoch
    if resumed is not None:
        epoch = int(resumed["epoch"])
        best_val = float(resumed.get("best_val", np.inf))
        if epoch >= cfg.unfreeze_epoch:
            raise ValueError(
                f"resume checkpoint {cfg.model_path!r} was saved at epoch {epoch} "
                f">= unfreeze_epoch={cfg.unfreeze_epoch} — training is already "
                f"complete.  Raise unfreeze_epoch to continue, or serve the "
                f"weights directly (resume=False)")
        if verbose:
            print(f"Resuming full training state at epoch {epoch} "
                  f"(best_val={best_val:.4f}).")
    while epoch < cfg.unfreeze_epoch:
        freeze_phase = cfg.freeze_train and epoch < cfg.freeze_epoch
        if freeze_phase != frozen_now:
            # (re)build the optimizer and lr schedule for this phase
            # (reference: train.py:389-418, :458-492); fresh moments
            frozen_now = freeze_phase
            batch_size = cfg.freeze_batch_size if freeze_phase else cfg.unfreeze_batch_size
            init_lr_fit, min_lr_fit = adaptive_lr(cfg.init_lr, cfg.min_lr, batch_size,
                                                  cfg.optimizer_type)
            lr_sched = get_lr_scheduler(cfg.lr_decay_type, init_lr_fit, min_lr_fit,
                                        cfg.unfreeze_epoch)
            prefixes = FREEZE_PREFIXES.get(cfg.model, ()) if freeze_phase else ()
            opt = make_optimizer(model, cfg.optimizer_type, cfg.momentum,
                                 cfg.weight_decay, prefixes)
            if state is None:
                state = TrainState(model=model, optimizer=opt)
                if resumed is not None:
                    try:
                        opt.load_state_dict(resumed["optimizer"])
                    except (KeyError, ValueError) as e:
                        # a checkpoint of the other freeze phase: weights and
                        # epoch are restored, the moments start fresh
                        print("warning: resume opt_state does not match this "
                              f"phase's optimizer structure ({e}); continuing "
                              "with fresh optimizer moments (weights + epoch "
                              "are restored)")
                    state.step = int(resumed.get("step", 0))
                    resumed = None
            else:
                state.optimizer = opt
            train_loader = Loader(train_ds, batch_size, shuffle=True, seed=cfg.seed,
                                  num_workers=cfg.num_workers)
            # a small validation set gets a shrunk batch so it still makes
            # one full batch
            val_bs = min(batch_size, len(val_ds))
            val_loader = Loader(val_ds, val_bs, shuffle=False, seed=cfg.seed,
                                num_workers=cfg.num_workers) if val_bs > 0 else None

        lr = lr_sched(epoch)
        train_loader.set_epoch(epoch)
        tloss, nb = 0.0, 0
        for batch in train_loader:
            gen = torch.Generator(device).manual_seed(
                (cfg.seed << 32) + epoch * 100_003 + nb)
            state, metrics = train_step(state, batch, lr, gen)
            step_loss = float(metrics["loss"])
            tloss += step_loss
            nb += 1
            if wandb_logger is not None:
                # per-iteration metrics (reference: utils/utils_fit.py:363-372)
                wandb_logger.log_step(state.step, loss=step_loss,
                                      f_score=float(metrics["f_score"]), lr=lr)
            if max_steps_per_epoch and nb >= max_steps_per_epoch:
                break
        tloss /= max(nb, 1)

        vloss, nvb = 0.0, 0
        if cfg.eval_flag and val_loader is not None:
            for batch in val_loader:
                vloss += float(eval_step(state, batch)["val_loss"])
                nvb += 1
                if max_steps_per_epoch and nvb >= max_steps_per_epoch:
                    break
            vloss /= max(nvb, 1)

        # printing follows verbose; checkpoints are written regardless
        if verbose:
            print(f"Epoch {epoch + 1}/{cfg.unfreeze_epoch}: lr {lr:.3e} "
                  f"loss {tloss:.4f} val_loss {vloss:.4f}")
            if loss_history:
                loss_history.append(epoch, tloss, vloss if nvb else None)
        if wandb_logger is not None:
            wandb_logger.log_epoch(epoch, loss=tloss, val_loss=vloss, lr=lr)
        if miou_callback is not None:
            miou_callback.on_epoch_end(epoch)
        # checkpoint cadence of utils/utils_fit.py:153-172: best weights
        # only, periodic and last with the full state
        if nvb and vloss < best_val:
            best_val = vloss
            save_variables(os.path.join(cfg.save_dir, "best_epoch_weights.pth"), model)
        if (epoch + 1) % cfg.save_period == 0 or epoch + 1 == cfg.unfreeze_epoch:
            ck_path = os.path.join(
                cfg.save_dir, f"ep{epoch + 1:03d}-loss{tloss:.3f}-val_loss{vloss:.3f}.pth")
            save_full_state(ck_path, state, epoch + 1, best_val)
            if wandb_logger is not None:
                # reference: utils/utils_fit.py:458-471 wandb.save
                wandb_logger.save_checkpoint(ck_path)
        save_full_state(os.path.join(cfg.save_dir, "last_epoch_weights.pth"),
                        state, epoch + 1, best_val)

        snapshot = (lambda: {k: v.detach().cpu().clone()
                             for k, v in model.state_dict().items()})
        if stopper is not None and nvb and stopper(vloss, snapshot):
            if verbose:
                print(f"early stopping at epoch {epoch + 1}")
            break
        epoch += 1
    return state
