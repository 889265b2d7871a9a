"""The train and eval steps of the port (counterpart of
``tpu_unet/train/step.py``).

- Mixed precision as ``_cast_params`` (step.py:107-117): the float32 master
  parameters are cast to the compute dtype for the forward
  (``torch.func.functional_call`` with the cast tensors) and the gradients
  flow back through the cast, so the optimizer updates float32.
- Inputs as ``_prepare_batch`` (:120-126): uint8 images / 255 in float32,
  then the compute dtype; int labels.
- Routing as ``make_train_step`` (:151-216) with the fused loss on: a
  canonical ``Unet`` whose features come out at the target's size
  (``unet_vgg``, and ``unet_resnet50`` after its ``up_conv`` head) with CE
  (± dice) emits its 64-channel features and the fused
  final-conv + loss (``kernels/loss.py``, #27 / #29) applies ``final``, as
  JAX's ``feat_model`` (:159-161, :197-205); every other model whose logits
  come out at the target's size (``_fused_shape_ok``, :226-243), with CE or
  focal (± dice), takes the logit-level loss (#25 / #26; ``unet_vgg``
  and ``unet_resnet50`` with focal too; a model that returns heads in train
  mode with no aux weights, its first head, as JAX's ``fused_loss_fn``,
  :177-189); with aux weights (deep supervision) every head at the
  target's size takes its own #25 / #26 launch and the step sums the
  weighted losses, the f_score from the first head's, which computes
  JAX's ``_total_loss`` (:129-141); the rest (``self_net``'s and
  ``lightweight``'s logits at 2× and ½ the input) take the plain losses on
  the logits (``train/losses.py``, which resize them to the target as
  JAX's do; ``_total_loss``, the plain version of the deep-supervision
  sum).  The eval step always takes the plain losses (:246-261) on the
  serving forward, batch norm on the running statistics.
- The canonical UNets' encoder, decoder and head as JAX's training
  switches route them, named by ``StepConfig.train_route``: ``"paired"``
  (JAX's TPU default) trains every stage the kernels tile through its
  kernel forward and its one backward kernel (the VGG16 stem #2 / #20,
  block 2 #21 / #22, blocks 3-5 #23 / #24, the decoder stages #1 and
  #14-#19, the ``up_conv`` head #10 / #12); ``"fused"`` trains the VGG16
  encoder plain, up1 through #1 and #13 and the other decoder stages and
  the head plain.  ResNet50 trains plain on both (cuDNN under autograd),
  as JAX runs it outside any Pallas kernel.
- Batch norm and dropout as ``apply(..., True, rngs={"dropout": key},
  mutable=["batch_stats"])``: the training forward normalises with the
  batch statistics and updates the modules' float32 running statistics in
  place (the ``batch_stats`` JAX carries in the state; they are buffers, not
  parameters, so the compute-dtype cast leaves them float32); Dropout2d
  draws from the step's ``generator``.
- Optimizer as ``make_optimizer`` (:69-94): ``adam`` with betas
  (momentum, 0.999) and eps 1e-8, ``sgd`` nesterov; L2 weight decay added to
  the raw gradient; the update ``-lr·u`` with ``lr`` set per call; frozen
  prefixes left out of the optimizer with ``requires_grad=False``, so they
  get no update and no decay.  ``torch.optim.Adam`` / ``SGD`` compute the
  optax chain's math.

On the card only what has kernels trains: in bf16 the canonical UNets
(``unet_vgg``, ``unet_resnet50``, ``self_net``) and the DataB models
(``traditional``, ``traditional22``, the ladder family; ``lightweight`` on
the plain losses, as JAX; the other eight registry models through cuDNN
and #25 / #26, deep supervision included), and in float32 (``fp16=False``,
``TrainConfig``'s default and the ``voc`` and ``medical`` presets') every
one of them, through the float32 instantiations of the kernels (TF32
products, float32 everywhere else; the up_conv head's #10 / #12 as well).
A compute dtype other than bf16 or float32 raises (:func:`check_ported`)
instead of running a plain path silently; on the CPU every recipe runs
through the plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn
from torch.func import functional_call

from tpu_unet_torch.kernels.loss import ce_dice_loss, final_ce_dice_loss
from tpu_unet_torch.models.unet import Unet
from tpu_unet_torch.train.losses import ce_loss, dice_loss, f_score, focal_loss, one_hot

# top-level parameter names of each model's backbone for the freeze phase
# (reference freeze_backbone methods, e.g. nets/unet.py:80-94)
FREEZE_PREFIXES = {
    "unet_vgg": ("vgg",),
    "unet_resnet50": ("resnet",),
    "self_net": ("vgg",),
    "traditional": ("inc", "down1", "down2", "down3"),
    "traditional22": ("inc", "down1", "down2", "down3"),
    "lightweight": ("backbone",),
}


# the two training routes of the canonical UNet (StepConfig.train_route)
TRAIN_ROUTES = ("paired", "fused")


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """``train_route`` is the counterpart of JAX's two training switches
    (``core/fusion.py:101-112``): ``"paired"`` is ``TPU_UNET_PAIRED_TRAIN=1
    TPU_UNET_FUSED_TRAIN=0``, JAX's TPU default (the training stem and
    encoder blocks, ``models/backbones.py:79-145``, every decoder stage
    with its whole stage backward, #14-#19, and the ``up_conv`` head with
    #12); ``"fused"`` is ``TPU_UNET_FUSED_TRAIN=1 TPU_UNET_PAIRED_TRAIN=0``
    (the encoder plain, the F < 128 decoder stages through #13, the wider
    ones and the head plain).  It routes ``Unet``'s encoder, decoder and
    head (``models/backbones.py::VGG16``, ``nn/blocks.py::UnetUp``,
    ``models/unet.py``); on the CPU all run the plain versions.  Validated
    here only."""
    num_classes: int
    cls_weights: tuple
    use_focal: bool = False
    use_dice: bool = False
    aux_weights: tuple = ()      # () = no deep supervision
    compute_dtype: torch.dtype = torch.float32
    train_route: str = "paired"

    def __post_init__(self):
        if self.train_route not in TRAIN_ROUTES:
            raise ValueError(f"train_route {self.train_route!r}, expected one of "
                             f"{TRAIN_ROUTES}")


@dataclasses.dataclass
class TrainState:
    """The model (float32 master parameters), its optimizer and the number
    of steps taken."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(model: nn.Module, optimizer_type: str = "adam",
                   momentum: float = 0.9, weight_decay: float = 0.0,
                   freeze_prefixes: Sequence[str] = ()) -> torch.optim.Optimizer:
    """adam (betas (momentum, 0.999)) | nesterov sgd, with L2 weight decay on
    the raw gradient (reference: train.py:402-405).  Parameters under a
    frozen prefix get ``requires_grad=False`` and stay out of the optimizer;
    every other one is made trainable.  The lr is set by the step."""
    frozen = tuple(freeze_prefixes)
    params = []
    for name, p in model.named_parameters():
        trainable = name.split(".")[0] not in frozen
        p.requires_grad_(trainable)
        if trainable:
            params.append(p)
    if optimizer_type == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(momentum, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    if optimizer_type == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=momentum,
                               nesterov=momentum > 0, dampening=0.0,
                               weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {optimizer_type!r}")


def _fused_route(model: nn.Module, cfg: StepConfig) -> bool:
    """The fused final-conv + loss route: a canonical UNet whose features
    come out at the input's (the target's) size — ``unet_vgg``, and
    ``unet_resnet50``, whose head doubles its stride-2 decoder output;
    not ``self_net``, whose head doubles the input size — with no aux heads
    and CE (± dice)."""
    return (isinstance(model, Unet) and (model.up_conv is None) == (model.backbone == "vgg")
            and not cfg.aux_weights and not cfg.use_focal)


def check_ported(model: nn.Module, cfg: StepConfig, device: torch.device) -> None:
    """Raise for a training configuration the port cannot run on ``device``
    without a kernel that is not ported yet; never fall back silently."""
    if torch.device(device).type != "cuda":
        return
    # every kernel on the models' training paths has a bf16 and a float32
    # instantiation
    if cfg.compute_dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"compute dtype {cfg.compute_dtype} on the card: the kernels take bf16 or "
            "float32")


def cast_params(model: nn.Module, dtype: torch.dtype) -> dict:
    """The model's parameters in ``dtype`` (float32 ones cast, the cast
    differentiable), as ``_cast_params``."""
    return {n: (p.to(dtype) if p.dtype == torch.float32 and dtype != torch.float32 else p)
            for n, p in model.named_parameters()}


def prepare_batch(batch, compute_dtype: torch.dtype, device: torch.device):
    """{"image": uint8 (N, H, W, 3), "label": int (N, H, W)} → (images in
    ``compute_dtype``, int32 targets; the fused loss packs them into the
    one byte a pixel its kernels read) on ``device``."""
    imgs = torch.as_tensor(batch["image"]).to(device)
    imgs = (imgs.float() / 255.0).to(compute_dtype)
    target = torch.as_tensor(batch["label"]).to(device=device, dtype=torch.int32)
    return imgs, target


def _total_loss(outputs, target, onehot, cfg: StepConfig):
    """The weighted sum of every head's plain loss and the first head's
    float32 logits (``step.py:129-141``)."""
    if not isinstance(outputs, (tuple, list)):
        outputs = (outputs,)
    weights = cfg.aux_weights or (1.0,)
    total = 0.0
    for out, w in zip(outputs, weights):
        out = out.float()
        base = (focal_loss if cfg.use_focal else ce_loss)(
            out, target, cfg.cls_weights, cfg.num_classes)
        if cfg.use_dice:
            base = base + dice_loss(out, onehot)
        total = total + w * base
    return total, outputs[0].float()


def make_train_step(model: nn.Module, cfg: StepConfig):
    """``train_step(state, batch, lr, generator=None) → (state, {"loss",
    "f_score"})``: one optimizer step of ``state.model`` on ``batch`` at
    learning rate ``lr``, dropout drawn from ``generator`` (on the model's
    device; ``None`` takes the default one); the metrics are float32
    scalars on the model's device."""
    device = next(model.parameters()).device
    check_ported(model, cfg, device)
    fused = _fused_route(model, cfg)

    def train_step(state: TrainState, batch, lr: float, generator=None):
        imgs, target = prepare_batch(batch, cfg.compute_dtype, device)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        params = cast_params(state.model, cfg.compute_dtype)
        kwargs = {"train": True, "generator": generator}
        if isinstance(state.model, Unet):
            kwargs["route"] = cfg.train_route
        if fused:
            feats = functional_call(state.model, params, (imgs,),
                                    {"features_out": True, **kwargs})
            loss, fs = final_ce_dice_loss(
                feats, params["final.weight"], params["final.bias"], target,
                cfg.cls_weights, cfg.num_classes, with_dice=cfg.use_dice)
        else:
            outputs = functional_call(state.model, params, (imgs,), kwargs)
            heads = tuple(outputs) if isinstance(outputs, (tuple, list)) else (outputs,)
            weights = cfg.aux_weights or (1.0,)
            heads = heads[:len(weights)]
            if all(h.shape[1:3] == target.shape[1:3] for h in heads):
                # one #25 / #26 launch a head, the weighted sum of the losses
                loss, fs = ce_dice_loss(heads[0], target, cfg.cls_weights, cfg.num_classes,
                                        with_dice=cfg.use_dice, use_focal=cfg.use_focal)
                loss = loss * weights[0] if cfg.aux_weights else loss
                for h, w in zip(heads[1:], weights[1:]):
                    loss = loss + w * ce_dice_loss(
                        h, target, cfg.cls_weights, cfg.num_classes, with_dice=cfg.use_dice,
                        use_focal=cfg.use_focal)[0]
            else:
                onehot = one_hot(target, cfg.num_classes)
                loss, main = _total_loss(outputs, target, onehot, cfg)
                with torch.no_grad():
                    fs = f_score(main, onehot)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in state.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:  # not reached by the loss: JAX's zero gradient
                    p.grad = torch.zeros_like(p)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "f_score": fs.detach()}

    return train_step


def make_eval_step(model: nn.Module, cfg: StepConfig):
    """``eval_step(state, batch) → {"val_loss", "val_f_score"}``: the
    serving forward (kernels on the card; batch norm on the running
    statistics) and the plain losses on its logits (reference:
    utils/utils_fit.py:111-151)."""
    device = next(model.parameters()).device
    plain_cfg = dataclasses.replace(cfg, aux_weights=())

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        imgs, target = prepare_batch(batch, cfg.compute_dtype, device)
        onehot = one_hot(target, cfg.num_classes)
        outputs = functional_call(state.model, cast_params(state.model, cfg.compute_dtype),
                                  (imgs,))
        loss, main = _total_loss(outputs, target, onehot, plain_cfg)
        return {"val_loss": loss, "val_f_score": f_score(main, onehot)}

    return eval_step
