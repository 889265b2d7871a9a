"""Training configuration — one dataclass, per-variant presets (the port's
own copy of ``tpu_unet/configs/presets.py``; values lifted from the
reference's training scripts, cited per preset).

Only the presets of models the port can train are copied: ``voc``,
``train_py`` and ``medical`` (unet_vgg, CE ± dice), ``voc_resnet50``
(unet_resnet50, CE + dice, 50 frozen then 50 unfrozen epochs; its
ImageNet ResNet50 file is not in the repository: ``--no-pretrained`` /
``pretrained_backbone=False``), and the DataB presets
``traditional``, ``lightweight``, ``ultralight``, ``ultralight_large``,
``ultralight_large_optimized`` and ``wandb_traditional`` (focal or CE +
dice on the heavy-augmentation set), ``hybrid_efficientseg`` (heavy
augmentation), and ``balancedseg_fpn``, ``balancedseg_crfs`` and
``balancedseg_fpn_sup`` (deep supervision, aux weights (1.0, 0.4, 0.3,
0.2)) on the DataB defect layout.  That is every preset of the JAX
package.  Every preset trains on the card in either precision:
``fp16=True`` in bf16, ``fp16=False`` (the default) in float32 on the
kernels' float32 instantiations (TF32 products,
``train/step.py::check_ported``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class TrainConfig:
    # model / task
    model: str = "unet_vgg"
    num_classes: int = 21
    input_shape: Tuple[int, int] = (512, 512)
    model_path: str = ""                  # resume/pretrain checkpoint
    # True resume: when model_path is a full-state checkpoint (saved by
    # train/checkpoint.py::save_full_state), also restore opt_state, the
    # epoch counter (overriding init_epoch) and best-val tracking —
    # improves on the reference's manual weights-only resume
    # (train.py:96-97, :288-302)
    resume: bool = False
    pretrained_backbone: bool = False
    # explicit path to a torchvision vgg16/resnet50 ImageNet .pth; when
    # empty, resolved via $TPU_UNET_PRETRAINED_DIR or ./model_data
    # (reference downloads there, nets/vgg.py:69 / nets/resnet.py:181)
    pretrained_path: str = ""
    # epochs & phases (reference: train.py:96-177)
    init_epoch: int = 0
    freeze_epoch: int = 50
    unfreeze_epoch: int = 100
    freeze_batch_size: int = 2
    unfreeze_batch_size: int = 2
    freeze_train: bool = False
    # optimization (reference: train.py:182-213)
    init_lr: float = 1e-4
    min_lr_ratio: float = 0.01            # Min_lr = Init_lr * ratio
    optimizer_type: str = "adam"
    momentum: float = 0.9
    weight_decay: float = 0.0
    lr_decay_type: str = "cos"
    # loss (reference: train.py:219-240)
    dice_loss: bool = False
    focal_loss: bool = False
    cls_weights: Tuple[float, ...] = ()
    aux_weights: Tuple[float, ...] = ()   # deep supervision
    # precision / misc (reference: train.py:68, :214-248)
    fp16: bool = False                    # → bf16 compute
    seed: int = 11
    save_period: int = 5
    save_dir: str = "logs"
    eval_flag: bool = True
    eval_period: int = 5
    dataset: str = "voc"                  # voc | voc2007 | medical | defect | heavy
    dataset_path: str = "VOCdevkit"
    num_workers: int = 4
    # early stopping ("dataB-train .py":83)
    patience: Optional[int] = None

    @property
    def min_lr(self) -> float:
        return self.init_lr * self.min_lr_ratio

    def resolved_cls_weights(self) -> Tuple[float, ...]:
        return self.cls_weights or tuple([1.0] * self.num_classes)


PRESETS = {
    # reference: train.py:45-248
    "voc": TrainConfig(
        model="unet_vgg", num_classes=21, input_shape=(512, 512),
        freeze_epoch=50, unfreeze_epoch=100, freeze_batch_size=2,
        unfreeze_batch_size=2, freeze_train=True, init_lr=1e-4,
        dice_loss=False, focal_loss=False, fp16=False,
        pretrained_backbone=True, save_period=5, dataset="voc"),
    # the shipped train.py constants (steel-defect 4-class via canonical UNet)
    "train_py": TrainConfig(
        model="unet_vgg", num_classes=4, input_shape=(256, 256),
        freeze_epoch=50, unfreeze_epoch=100, freeze_batch_size=2,
        unfreeze_batch_size=32, freeze_train=False, init_lr=1e-4,
        dice_loss=True, focal_loss=False, fp16=True, save_period=2,
        eval_period=2, dataset="voc"),
    # reference: train_medical.py:43-248
    "medical": TrainConfig(
        model="unet_vgg", num_classes=2, input_shape=(512, 512),
        pretrained_backbone=True, freeze_epoch=50, unfreeze_epoch=100,
        freeze_batch_size=2, unfreeze_batch_size=2, freeze_train=True,
        init_lr=1e-4, dice_loss=False, focal_loss=False, fp16=False,
        save_period=5, eval_flag=False, dataset="medical",
        dataset_path="Medical_Datasets"),
    # reference: TraditionalUnet_Train.py (Init_lr 1e-2, cls_weights [1,15,0,0])
    "traditional": TrainConfig(
        model="traditional", num_classes=4, input_shape=(256, 256),
        freeze_epoch=100, unfreeze_epoch=400, freeze_batch_size=32,
        unfreeze_batch_size=32, freeze_train=False, init_lr=1e-2,
        weight_decay=1e-4, dice_loss=True, focal_loss=True, fp16=True,
        cls_weights=(1, 15, 0, 0), dataset="heavy"),
    # reference: LightweightUnet_Train.py
    "lightweight": TrainConfig(
        model="lightweight", num_classes=4, input_shape=(256, 256),
        freeze_epoch=100, unfreeze_epoch=300, freeze_batch_size=32,
        unfreeze_batch_size=32, freeze_train=True, init_lr=1e-4,
        weight_decay=1e-4, dice_loss=True, focal_loss=False, fp16=True,
        dataset="heavy"),
    # reference: UltraLightweightUnet_Train.py
    "ultralight": TrainConfig(
        model="ultralight", num_classes=4, input_shape=(256, 256),
        freeze_epoch=100, unfreeze_epoch=400, freeze_batch_size=32,
        unfreeze_batch_size=32, init_lr=1e-4, weight_decay=1e-4,
        dice_loss=True, focal_loss=True, fp16=True,
        cls_weights=(1, 15, 1.5, 2), dataset="heavy"),
    # reference: UltraLightweightUnet_large_Train.py
    "ultralight_large": TrainConfig(
        model="ultralight_large", num_classes=4, input_shape=(256, 256),
        freeze_epoch=100, unfreeze_epoch=400, freeze_batch_size=32,
        unfreeze_batch_size=32, init_lr=1e-4, weight_decay=1e-4,
        dice_loss=True, focal_loss=True, fp16=True,
        cls_weights=(1, 15, 1.5, 2), dataset="heavy"),
    # reference: UltraLightweightUnet_large_optimized_Train.py
    "ultralight_large_optimized": TrainConfig(
        model="ultralight_large_optimized", num_classes=4,
        input_shape=(256, 256), freeze_epoch=100, unfreeze_epoch=400,
        freeze_batch_size=32, unfreeze_batch_size=32, init_lr=1e-4,
        weight_decay=1e-4, dice_loss=True, focal_loss=True, fp16=True,
        cls_weights=(1, 15, 1.5, 2), dataset="heavy"),
    # reference: HybridEfficientSeg_Train.py (cls_weights [0,15,0,0])
    "hybrid_efficientseg": TrainConfig(
        model="hybrid_efficientseg", num_classes=4, input_shape=(256, 256),
        freeze_epoch=100, unfreeze_epoch=150, freeze_batch_size=32,
        unfreeze_batch_size=32, init_lr=1e-2, weight_decay=1e-4,
        dice_loss=True, focal_loss=True, fp16=True,
        cls_weights=(0, 15, 0, 0), dataset="heavy"),
    # reference: "dataB-train .py" (FPN, 1000 epochs, batch 96, Min_lr 1e-3·lr,
    # EarlyStopping patience 100)
    "balancedseg_fpn": TrainConfig(
        model="balancedseg_fpn", num_classes=4, input_shape=(256, 256),
        freeze_epoch=100, unfreeze_epoch=1000, freeze_batch_size=16,
        unfreeze_batch_size=96, init_lr=1e-2, min_lr_ratio=0.001,
        weight_decay=1e-4, dice_loss=True, focal_loss=True, fp16=True,
        patience=100, dataset="defect", dataset_path="datasets"),
    # reference: "dataB-train_OptimizedBalancedSegWithCRFS .py"
    "balancedseg_crfs": TrainConfig(
        model="balancedseg_crfs", num_classes=4, input_shape=(256, 256),
        freeze_epoch=100, unfreeze_epoch=400, freeze_batch_size=16,
        unfreeze_batch_size=16, init_lr=1e-2, weight_decay=1e-4,
        dice_loss=True, focal_loss=True, fp16=True, patience=10,
        dataset="defect", dataset_path="datasets"),
    # reference: dataB-train_Supervision.py (deep supervision; the script's
    # fit function is missing upstream — the aux weights are the JAX
    # package's)
    "balancedseg_fpn_sup": TrainConfig(
        model="balancedseg_fpn_sup", num_classes=4, input_shape=(256, 256),
        freeze_epoch=100, unfreeze_epoch=400, freeze_batch_size=16,
        unfreeze_batch_size=16, init_lr=1e-2, weight_decay=1e-4,
        dice_loss=False, focal_loss=False, fp16=True,
        aux_weights=(1.0, 0.4, 0.3, 0.2), dataset="defect",
        dataset_path="datasets"),
    # reference: "wandb-unet-train .py" (TraditionalUnet on heavy aug)
    "wandb_traditional": TrainConfig(
        model="traditional", num_classes=4, input_shape=(256, 256),
        freeze_epoch=100, unfreeze_epoch=400, freeze_batch_size=16,
        unfreeze_batch_size=16, init_lr=1e-2, weight_decay=1e-4,
        dice_loss=True, focal_loss=True, fp16=True, dataset="heavy"),
    # the VOC12+SBD mIoU-parity recipe (BASELINE.md #2)
    "voc_resnet50": TrainConfig(
        model="unet_resnet50", num_classes=21, input_shape=(512, 512),
        pretrained_backbone=True, freeze_epoch=50, unfreeze_epoch=100,
        freeze_batch_size=16, unfreeze_batch_size=16, freeze_train=True,
        init_lr=1e-4, dice_loss=True, focal_loss=False, fp16=True,
        dataset="voc"),
}


def get_preset(name: str, **overrides) -> TrainConfig:
    cfg = dataclasses.replace(PRESETS[name], **overrides)
    return cfg
