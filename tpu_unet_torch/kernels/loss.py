"""The training losses on the card: weighted cross-entropy or focal loss +
soft dice + the f_score metric, and their gradients (counterpart of
``tpu_unet/kernels/loss.py``).

Two pairs of CUDA kernels:

- the logit-level loss, ``csrc/loss_logits.cu``: ``ce_dice_fwd`` replaces
  ``loss.py::_reductions`` (#25) and ``ce_dice_bwd`` replaces
  ``loss.py::_vjp_bwd`` (#26), the entry :func:`ce_dice_loss` as
  ``ce_dice_loss_grad`` (:205-237).  CE or focal (α 0.5, γ 2), ± dice, on
  logits that come out at the target's size.  Each is one Hopper kernel a
  pass: a persistent grid of at most 132 blocks fed tiles of a power of
  two pixels (their logits and target bytes) by 1-D bulk copies through a
  ring of stages, 512 consumer threads taking two pixel slots at once, G
  threads a pixel each holding K of its classes, the
  forward's sums reduced in a fixed order and its ``_finish`` on the
  device, the backward's ``dice_coefs`` / ``_inv`` in its prologue and its
  dlogits written back by a bulk store a tile: one launch a pass and no
  eager op around it.  :func:`logit_loss_plan` gives the launch its shape,
  which the C entry checks against the kernel's own;
- the final 1×1 classifier fused into the loss (CE only), ``csrc/loss.cu``:
  ``final_ce_dice_fwd`` replaces ``_final_fwd_impl`` (#27) and
  ``final_ce_dice_bwd`` replaces ``_final_vjp_bwd`` (#29), the entry
  :func:`final_ce_dice_loss` as the natural-layout
  ``final_ce_dice_loss_grad``.  Each reads the (pixels, 64) feature map
  once and recomputes the logits per pixel, so the logit map is never
  stored.  Both are one Hopper kernel a pass: a persistent grid of at most
  132 blocks fed 128-pixel tiles by a TMA ring, the logits and the two
  gradient products on ``wgmma``, the softmax and the sums in registers,
  and the scalar epilogue on the device (the forward's ``_finish``, the
  backward's ``dice_coefs`` / ``_inv``): one launch a pass and no eager op
  around it.  :func:`final_loss_plan` gives the launch its shape (C padded
  to 16, 32, 64 or 128 classes, the ring's stages, its shared memory, the
  grid), which the C entry checks against the kernel's own.

Block partial sums are added in a fixed order (the loss is the same on
every run).  Bounds and designs in the source notes.

Numerics, as ``_reduce_body`` / ``_grad_body`` / ``_fwd_impl`` /
``_dice_coefs`` / ``_final_reduce_kernel`` (loss.py:43-116, 248-294,
367-419):

- #27 / #29's logits: the float32-accumulated product rounded to the
  feature dtype, the bias added in that dtype, then float32; #25 / #26 read
  the logits as given and compute in float32;
- targets: ``min(target, C)``, so a raw 255 is the ignore class C; an
  ignored pixel counts in the dice and f_score probability sums, not in CE;
- CE: the mean divided by the sum of the weights of the contributing
  pixels; focal: Σ α(1−e^{−u})^γ·u over all pixels (ignored ones included)
  divided by their count, u the pixel's weighted NLL, its gradient factor
  α[(1−pt)^γ + γ·u·pt·(1−pt)^{γ−1}] with 1−pt clamped at 1e-12; dice: β = 1,
  smooth = 1e-5, the gradient in the closed form of ``_dice_coefs``;
  f_score at threshold 0.5 carries no gradient;
- dlogits in the logits' dtype; dfeat = dlog·W in the feature dtype; dW and
  db summed in float32, then cast to the weight's and the bias's dtype;
- #29 on the card feeds its float32 dlog to the bf16 tensor cores as two
  pieces, hi = bf16(dlog) and lo = bf16(dlog − hi), two products into one
  float32 accumulator: dlog to ~2⁻¹⁶ relative, where one bf16 dlog (the
  TPU's paired route, #30) would give 2⁻⁹.  Float32 features and weights
  are split the same way (hi·hi + hi·lo + lo·hi).  The logits of bf16
  features are exact products with float32 sums, as before; only the
  order of the sums changes.  The kernels' softmax takes one exp an
  element (the hardware's 2^x, p = e · rcp(Σe), nll = log Σe + max − x[t]):
  float32 rounding apart from ``log_softmax``, well inside the 1e-4 loss
  bound.

Limits: 1 ≤ C ≤ 126 (JAX's int8 target encoding, loss.py:220-224,
670-673), 64 features for #27 / #29.  The CUDA kernels read one byte a
target (:func:`pack_targets`, as JAX casts ``min(target, C)`` to int8
before its kernels) and take bf16 or float32 logits / features.  The
float32 train step of ``unet_vgg`` reaches #27 / #29's float32
instantiations, counted under their ``_f32`` launch keys.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from tpu_unet_torch.kernels import _build
from tpu_unet_torch.kernels._plain import on_cpu

_CF = 64
_MAX_CLASSES = 126
_SMOOTH = 1e-5
# both Hopper losses: the most blocks of a pass (a constant, so the pixels
# of a partial sum depend on n only), the shared memory a block may take,
# the bytes of per-class constants and scalars
_CTAS = 132
_SMEM_MAX = 232448
_SMALL = 4096
# csrc/loss.cu (#27 / #29): pixels a tile, the ring's most stages
_TILE = 128
_MAX_STAGES = 6
# csrc/loss_logits.cu (#25 / #26): the logit bytes a stage aims at, the
# tile's most pixels, the ring's most stages, the forward's bytes of sums at
# the target class a class slot, the consumer threads and the pixel slots
# each takes at once
_LOGIT_STAGE_BYTES = 16384
_LOGIT_MAX_TILE = 2048
_LOGIT_MAX_STAGES = 8
_LOGIT_TARGET_SUMS = 12
LOGIT_THREADS, LOGIT_SLOTS = 512, 2


def _check_classes(num_classes: int) -> None:
    if not 1 <= num_classes <= _MAX_CLASSES:
        raise ValueError(f"fused loss supports 1 <= num_classes <= {_MAX_CLASSES} "
                         f"(JAX's int8 target encoding); got {num_classes}. Use "
                         "train/losses.py for more classes.")


def _logits(f2, weight, bias, num_classes):
    """(pixels, Cf) features → float32 logits as the kernels compute them."""
    dt = f2.dtype
    w = weight.reshape(num_classes, -1).to(dt).float()
    x = (f2.float() @ w.t()).to(dt)
    return (x + bias.to(dt)).float()


def _pieces(x, t, cw, c):
    """log-probabilities, probabilities, one-hot (ignore → zero row) and the
    per-pixel CE weight (0 where ignored) of float32 logits ``x``."""
    logp = torch.log_softmax(x, dim=-1)
    probs = torch.exp(logp)
    onehot = (torch.arange(c, device=x.device) == t[:, None]).float()
    w_pix = (onehot * cw).sum(-1, keepdim=True)
    return logp, probs, onehot, w_pix


def _clamped(target, c):
    """Flat int64 targets: min(t, C), and C (ignore) for t < 0."""
    t = torch.clamp_max(target.reshape(-1).long(), c)
    return torch.where(t < 0, torch.full_like(t, c), t)


def pack_targets(target, num_classes: int):
    """Targets as the kernels read them: uint8, ``min(t, C)``, and C (ignore)
    for t < 0.  uint8 targets pass as they are (the kernels clamp them)."""
    if target.dtype == torch.uint8:
        return target
    c = num_classes
    return torch.where((target < 0) | (target > c), c, target).to(torch.uint8)


def _cw(cls_weights, num_classes, device):
    cw = torch.as_tensor(cls_weights, dtype=torch.float32).reshape(-1).to(device)
    if cw.numel() != num_classes:
        raise ValueError(f"{cw.numel()} class weights for {num_classes} classes")
    return cw


def _sums(x, t, cw, c, focal=None):
    """float32 logits (pixels, C), clamped targets → the (2 + 5C) sums of
    ``_reduce_body``: [S, Σw, tp, psum, tsum, tp@0.5, pos@0.5], S = Σ w·nll,
    or Σ α(1−e^{−u})^γ·u with ``focal`` = (α, γ)."""
    logp, probs, onehot, w_pix = _pieces(x, t, cw, c)
    u = w_pix * -(logp * onehot).sum(-1, keepdim=True)
    if focal is not None:
        alpha, gamma = focal
        u = alpha * (1.0 - torch.exp(-u)) ** gamma * u
    pt = (probs > 0.5).float()
    return torch.cat([u.sum().reshape(1), w_pix.sum().reshape(1),
                      (probs * onehot).sum(0), probs.sum(0), onehot.sum(0),
                      (pt * onehot).sum(0), pt.sum(0)])


def _finish(sums, num_classes, with_dice, focal_pixels=None):
    """(2 + 5C) sums → (loss, f_score, residuals (s_w, denom, score)); the
    first sum divided by ``focal_pixels`` (focal) or by Σw (CE)."""
    c = num_classes
    s_wnll, s_w = sums[0], sums[1]
    tp, psum, tsum, tpt, ptsum = sums[2:].reshape(5, c)
    if focal_pixels is not None:
        loss_ce = s_wnll / float(focal_pixels)
    else:
        loss_ce = s_wnll / torch.clamp_min(s_w, 1e-12)
    fp, fn = psum - tp, tsum - tp
    denom = 2.0 * tp + fn + fp + _SMOOTH
    score = (2.0 * tp + _SMOOTH) / denom
    loss = loss_ce + (1.0 - score.mean()) if with_dice else loss_ce
    fpt, fnt = ptsum - tpt, tsum - tpt
    fscore = ((2 * tpt + _SMOOTH) / (2 * tpt + fnt + fpt + _SMOOTH)).mean()
    return loss, fscore, (s_w, denom, score)


def _inv(gl, s_w, focal_pixels=None):
    """The CE gradient's scale: dL / Σw, or dL / pixels for focal."""
    if focal_pixels is not None:
        return gl / float(focal_pixels)
    return gl / torch.clamp_min(s_w, 1e-12)


def _dlogits(x, t, cw, c, coef_a, coef_b, inv, focal=None):
    """float32 logits (pixels, C) → float32 dlogits (``_grad_body``)."""
    logp, probs, onehot, w_pix = _pieces(x, t, cw, c)
    kw = w_pix
    if focal is not None:
        alpha, gamma = focal
        u = w_pix * -(logp * onehot).sum(-1, keepdim=True)
        pt = torch.exp(-u)
        base = torch.clamp_min(1.0 - pt, 1e-12)
        kw = alpha * (base ** gamma + gamma * u * pt * base ** (gamma - 1.0)) * w_pix
    dldp = coef_a * onehot + coef_b
    inner = (dldp * probs).sum(-1, keepdim=True)
    return kw * (probs - onehot) * inv + probs * (dldp - inner)


def dice_coefs(score, denom, num_classes, gl, with_dice):
    """Per-class coefficients of the dice gradient w.r.t. the probabilities,
    dL/dp[k] = A_k·onehot + B_k, scaled by the loss cotangent ``gl``
    (``_dice_coefs``, loss.py:275-294)."""
    num = score * denom
    a = (-(2.0 / denom) / num_classes) * gl
    b = (-(-num / (denom * denom)) / num_classes) * gl
    if not with_dice:
        return torch.zeros_like(a), torch.zeros_like(b)
    return a, b


def final_ce_dice_fwd_plain(feats, w, b, target, cls_weights, num_classes: int,
                            with_dice: bool):
    """(B, H, W, 64) features, final conv weight (C, 64, 1, 1) and bias (C,),
    int targets (B, H, W) → (loss, f_score, residuals (s_w, denom, score))."""
    c = num_classes
    _check_classes(c)
    x = _logits(feats.reshape(-1, feats.shape[-1]), w, b, c)
    return _finish(_sums(x, _clamped(target, c), _cw(cls_weights, c, x.device), c), c,
                   with_dice)


def final_ce_dice_bwd_plain(feats, w, b, target, cls_weights, num_classes: int,
                            with_dice: bool, residuals, gl):
    """Gradient of the loss (cotangent ``gl``) → (dfeat (feats' shape and
    dtype), dW (w's), db (b's))."""
    c = num_classes
    s_w, denom, score = residuals
    coef_a, coef_b = dice_coefs(score, denom, c, gl, with_dice)
    f2 = feats.reshape(-1, feats.shape[-1])
    x = _logits(f2, w, b, c)
    dlog = _dlogits(x, _clamped(target, c), _cw(cls_weights, c, x.device), c, coef_a, coef_b,
                    _inv(gl, s_w))
    wf = w.reshape(c, -1).to(feats.dtype).float()
    dfeat = (dlog @ wf).to(feats.dtype).reshape(feats.shape)
    dw = (f2.float().t() @ dlog).t().reshape(w.shape).to(w.dtype)
    return dfeat, dw, dlog.sum(0).to(b.dtype)


class LossPlan(NamedTuple):
    np: int      # classes padded to a wgmma width
    stages: int  # of the TMA ring
    smem: int    # a block's dynamic shared memory, bytes
    row: int     # floats of a block's partial row


@functools.lru_cache(maxsize=None)
def final_loss_plan(num_classes: int, f32: bool, backward: bool) -> LossPlan:
    """The launch shape of #27 (``backward`` False) or #29 for ``num_classes``
    and bf16 (or float32, ``f32``) features, as ``csrc/loss.cu::Layout``
    computes it: ``np`` the classes padded to a ``wgmma`` width (16, 32, 64
    or 128), ``stages`` of the TMA ring (as many 128-pixel tiles and their
    target bytes as fit beside W, the backward's dlogᵀ tiles and its dfeat
    boxes for the TMA store, at most 6), ``smem`` the block's dynamic shared memory and
    ``row`` the floats of a block's partial row (the forward's 2 + 5C sums;
    the backward's dW (C, 64) then db (C))."""
    c = num_classes
    _check_classes(c)
    np_ = max(16, 1 << (c - 1).bit_length())
    size = 4 if f32 else 2
    ft = 128 * _CF * size
    wt = np_ * 128
    fixed = (2 if f32 else 1) * wt + _SMALL + 1024
    if backward:
        fixed += 4 * wt + 2 * 64 * _CF * size
    per_stage = ft + 128 + 16
    stages = min(_MAX_STAGES, (_SMEM_MAX - fixed) // per_stage)
    return LossPlan(np_, stages, fixed + stages * per_stage,
                    (_CF + 1) * c if backward else 2 + 5 * c)


def final_loss_grid(n: int) -> int:
    """Blocks of a #27 / #29 pass over n pixels: one a 128-pixel tile, at
    most 132; block i sums the tiles i, i + grid, ..."""
    return min(_CTAS, math.ceil(n / _TILE))


_cw_cache: dict = {}
_tickets: dict = {}


def _cw_device(cls_weights, num_classes, device):
    """The class weights on ``device``, copied there once per tuple."""
    key = (tuple(float(v) for v in cls_weights), num_classes, device)
    cw = _cw_cache.get(key)
    if cw is None:
        cw = _cw_cache[key] = _cw(key[0], num_classes, device)
    return cw


def _ticket(device):
    """The pass's ticket counter on ``device`` for the current stream: zero
    before a pass, and set back to zero by the pass's last block."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    key = (idx, torch._C._cuda_getCurrentRawStream(idx))
    t = _tickets.get(key)
    if t is None:
        t = _tickets[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


def _aligned(t):
    """``t``, or a copy of it where its data is not 16-byte aligned (a TMA
    tensor map's base must be)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _operands(feats, w, b, target, cls_weights, num_classes, name):
    """Shape rule (before the device), then the CUDA operands: uint8
    targets, the (C, 64) weights and the bias in the feature dtype (one
    cast at most: none for bf16 parameters and features), the class
    weights (cached on the device)."""
    c = num_classes
    _check_classes(c)
    if feats.dtype not in (torch.bfloat16, torch.float32) or feats.shape[-1] != _CF:
        raise ValueError(f"{name} kernel: (..., {_CF}) bf16 or float32 features, "
                         f"got {tuple(feats.shape)} {feats.dtype}")
    _build.check(feats, "feats", feats.dtype)
    if target.shape != feats.shape[:-1]:
        raise ValueError(f"{name} kernel: target {tuple(target.shape)} for "
                         f"features {tuple(feats.shape)}")
    if w.shape[0] != c or w.numel() != c * _CF or b.shape != (c,):
        raise ValueError(f"{name} kernel: final conv {tuple(w.shape)} / "
                         f"{tuple(b.shape)} for {c} classes")
    dev, dt = feats.device, feats.dtype
    t8 = _aligned(pack_targets(target.to(dev), c).contiguous())
    wt = w.reshape(c, _CF).to(device=dev, dtype=dt).contiguous()
    bt = b.to(device=dev, dtype=dt).contiguous()
    return _aligned(feats), t8, wt, bt, _cw_device(cls_weights, c, dev)


def _launch_shape(feats, c, backward):
    n = feats.numel() // _CF
    plan = final_loss_plan(c, feats.dtype == torch.float32, backward)
    return n, plan, (final_loss_grid(n) if n else 0)


def _fwd_cuda(feats, w, b, target, cls_weights, num_classes, with_dice):
    """#27 on the card → (loss, f_score, residuals (s_w, denom, score),
    the sums [Σw·nll, Σw, tp, psum, tsum, tp@0.5, pos@0.5]), all written
    by the kernel (views of one buffer but the two scalars)."""
    _build.no_grad_inputs("final_ce_dice_fwd", feats, w, b)
    c = num_classes
    feats, t8, wt, bt, cw = _operands(feats, w, b, target, cls_weights, c, "final_ce_dice_fwd")
    n, plan, grid = _launch_shape(feats, c, False)
    dev = feats.device
    if not n:
        sums = torch.zeros(2 + 5 * c, dtype=torch.float32, device=dev)
        return (*_finish(sums, c, with_dice), sums)
    partial = torch.empty((grid, plan.row), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    fscore = torch.empty((), dtype=torch.float32, device=dev)
    res = torch.empty(3 + 7 * c, dtype=torch.float32, device=dev)
    _build.call("tu_final_ce_dice_fwd", feats.data_ptr(), int(feats.dtype == torch.bfloat16),
                t8.data_ptr(), wt.data_ptr(), bt.data_ptr(), cw.data_ptr(), partial.data_ptr(),
                _ticket(dev).data_ptr(), loss.data_ptr(), fscore.data_ptr(), res.data_ptr(), n,
                c, int(with_dice), plan.np, plan.stages, plan.smem, grid)
    _build.launch_counts[_build.count_key("final_ce_dice_fwd", feats.dtype)] += 1
    return loss, fscore, (res[0], res[1:1 + c], res[1 + c:1 + 2 * c]), res[1 + 2 * c:]


def _bwd_cuda(feats, w, b, target, cls_weights, num_classes, with_dice, residuals, gl):
    """#29 on the card → (dfeat, dW, db, coefs [A, B, inv] as the kernel
    computed them, the blocks' partial rows)."""
    _build.no_grad_inputs("final_ce_dice_bwd", feats, w, b)
    c = num_classes
    feats, t8, wt, bt, cw = _operands(feats, w, b, target, cls_weights, c, "final_ce_dice_bwd")
    n, plan, grid = _launch_shape(feats, c, True)
    dev = feats.device
    s_w, denom, score = (r.to(device=dev, dtype=torch.float32).contiguous() for r in residuals)
    gl = gl.to(device=dev, dtype=torch.float32).contiguous()
    dfeat = torch.empty_like(feats)
    if not n:
        zero = torch.zeros(c, _CF, dtype=torch.float32, device=dev)
        return dfeat, zero.reshape(w.shape).to(w.dtype), zero[:, 0].to(b.dtype), None, None
    gdt = torch.bfloat16 if (w.dtype, b.dtype) == (torch.bfloat16,) * 2 else torch.float32
    dw = torch.empty((c, _CF), dtype=gdt, device=dev)
    db = torch.empty(c, dtype=gdt, device=dev)
    coefs = torch.empty(2 * c + 1, dtype=torch.float32, device=dev)
    partial = torch.empty((grid, plan.row), dtype=torch.float32, device=dev)
    _build.call("tu_final_ce_dice_bwd", feats.data_ptr(), int(feats.dtype == torch.bfloat16),
                t8.data_ptr(), wt.data_ptr(), bt.data_ptr(), cw.data_ptr(), gl.data_ptr(),
                s_w.data_ptr(), denom.data_ptr(), score.data_ptr(), partial.data_ptr(),
                _ticket(dev).data_ptr(), dfeat.data_ptr(), dw.data_ptr(), db.data_ptr(),
                coefs.data_ptr(), n, c, int(with_dice), int(gdt == torch.bfloat16),
                plan.np, plan.stages, plan.smem, grid)
    _build.launch_counts[_build.count_key("final_ce_dice_bwd", feats.dtype)] += 1
    return (dfeat, dw.reshape(w.shape).to(w.dtype), db.to(b.dtype), coefs, partial)


def final_ce_dice_fwd(feats, w, b, target, cls_weights, num_classes: int,
                      with_dice: bool = True):
    """Dispatching wrapper of #27: plain version for CPU tensors, the CUDA
    kernel for tensors on the card.  → (loss, f_score, residuals)."""
    if on_cpu(feats):
        return final_ce_dice_fwd_plain(feats, w, b, target, cls_weights, num_classes,
                                       with_dice)
    return _fwd_cuda(feats, w, b, target, cls_weights, num_classes, with_dice)[:3]


def final_ce_dice_bwd(feats, w, b, target, cls_weights, num_classes: int,
                      with_dice: bool, residuals, gl):
    """Dispatching wrapper of #29: plain version for CPU tensors, the CUDA
    kernel for tensors on the card.  → (dfeat, dW, db)."""
    if on_cpu(feats):
        return final_ce_dice_bwd_plain(feats, w, b, target, cls_weights, num_classes,
                                       with_dice, residuals, gl)
    return _bwd_cuda(feats, w, b, target, cls_weights, num_classes, with_dice,
                     residuals, gl)[:3]


class _FinalCEDice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, weight, bias, target, cls_weights, num_classes, with_dice):
        feats = feats.contiguous()
        target = pack_targets(target, num_classes)  # once for both passes
        loss, fscore, (s_w, denom, score) = final_ce_dice_fwd(
            feats, weight, bias, target, cls_weights, num_classes, with_dice)
        ctx.save_for_backward(feats, weight, bias, target, s_w, denom, score)
        ctx.cfg = (cls_weights, num_classes, with_dice)
        ctx.mark_non_differentiable(fscore)
        ctx.set_materialize_grads(False)  # no zeros launched for f_score's gradient
        return loss, fscore

    @staticmethod
    def backward(ctx, gl, _gfs):
        if gl is None:
            return None, None, None, None, None, None, None
        feats, weight, bias, target, s_w, denom, score = ctx.saved_tensors
        cls_weights, num_classes, with_dice = ctx.cfg
        dfeat, dw, db = final_ce_dice_bwd(feats, weight, bias, target, cls_weights,
                                          num_classes, with_dice, (s_w, denom, score),
                                          gl.float())
        return dfeat, dw, db, None, None, None, None


def final_ce_dice_loss(feats, weight, bias, target, cls_weights, num_classes: int,
                       with_dice: bool = True):
    """``final`` 1×1 conv → CE (+ dice) loss and f_score, with its gradient
    through #29: (B, H, W, 64) features, weight (C, 64, 1, 1), bias (C,),
    int targets (B, H, W) (values ≥ C are ignored) → (loss, f_score), both
    float32 scalars; f_score carries no gradient (``_final_vjp_bwd``, :789)."""
    _check_classes(num_classes)
    cw = tuple(float(v) for v in cls_weights)
    return _FinalCEDice.apply(feats, weight, bias, target, cw, num_classes, with_dice)


# ---------------------------------------------------------------------------
# The logit-level loss: #25 (forward sums) and #26 (dlogits)
# ---------------------------------------------------------------------------

def _focal(use_focal, alpha, gamma):
    return (float(alpha), float(gamma)) if use_focal else None


def ce_dice_fwd_plain(logits, target, cls_weights, num_classes: int, with_dice: bool,
                      focal: bool = False, alpha: float = 0.5, gamma: float = 2.0):
    """(B, H, W, C) logits, int targets (B, H, W) → (loss, f_score,
    residuals (s_w, denom, score)); CE, or focal with ``focal``."""
    c = num_classes
    _check_classes(c)
    x = logits.reshape(-1, c).float()
    sums = _sums(x, _clamped(target, c), _cw(cls_weights, c, x.device), c,
                 _focal(focal, alpha, gamma))
    return _finish(sums, c, with_dice, x.shape[0] if focal else None)


def ce_dice_bwd_plain(logits, target, cls_weights, num_classes: int, with_dice: bool,
                      focal: bool, alpha: float, gamma: float, residuals, gl):
    """Gradient of the loss (cotangent ``gl``) → dlogits (the logits' shape
    and dtype)."""
    c = num_classes
    s_w, denom, score = residuals
    coef_a, coef_b = dice_coefs(score, denom, c, gl, with_dice)
    x = logits.reshape(-1, c).float()
    dlog = _dlogits(x, _clamped(target, c), _cw(cls_weights, c, x.device), c, coef_a,
                    coef_b, _inv(gl, s_w, x.shape[0] if focal else None),
                    _focal(focal, alpha, gamma))
    return dlog.to(logits.dtype).reshape(logits.shape)


class LogitPlan(NamedTuple):
    k: int       # classes a thread holds: 4, 6 or 8
    g: int       # threads a pixel, a power of two
    tile: int    # pixels a tile, a power of two
    stages: int  # of the bulk-copy ring
    smem: int    # a block's dynamic shared memory, bytes
    row: int     # floats of a block's partial row (the forward's 2 + 5C sums)


@functools.lru_cache(maxsize=None)
def logit_loss_plan(num_classes: int, f32: bool, backward: bool) -> LogitPlan:
    """The launch shape of #25 (``backward`` False) or #26 for
    ``num_classes`` and bf16 (or float32, ``f32``) logits, as
    ``csrc/loss_logits.cu::plan_for`` computes it: ``g`` threads a pixel (1
    up to 8 classes, else ⌈C / 8⌉ rounded up to a power of two) and ``k``
    classes a thread (4, 6 or 8, the fewest that hold C); ``tile`` the
    largest power of two up to 2048 pixels whose logits fit 16 KB, but
    LOGIT_SLOTS · LOGIT_THREADS pixel slots (tile · g) at least, so every
    step of every consumer thread is whole; ``stages`` of the ring (a
    stage: the tile's logits, its target bytes, two barriers), as many as
    fit up to 8 beside the forward's sums at the target class (12 bytes a
    class slot of a consumer thread); ``smem`` the block's dynamic shared
    memory; ``row`` the
    floats of the forward's partial row (0 for the backward, which sums
    nothing across pixels)."""
    c = num_classes
    _check_classes(c)
    g = 1
    while 8 * g < c:
        g *= 2
    k = 4 if c <= 4 else 6 if -(-c // g) <= 6 else 8
    b = c * (4 if f32 else 2)
    tile = _LOGIT_MAX_TILE
    while tile * b > _LOGIT_STAGE_BYTES and tile * g > LOGIT_SLOTS * LOGIT_THREADS:
        tile //= 2
    per_stage = tile * b + tile + 16
    fixed = _SMALL + (0 if backward else _LOGIT_TARGET_SUMS * k * LOGIT_THREADS)
    stages = min(_LOGIT_MAX_STAGES, (_SMEM_MAX - fixed) // per_stage)
    return LogitPlan(k, g, tile, stages, fixed + stages * per_stage,
                     0 if backward else 2 + 5 * c)


def logit_loss_grid(n: int, tile: int) -> int:
    """Blocks of a #25 / #26 pass over n pixels: one a tile, at most 132;
    block i takes the tiles i, i + grid, ..."""
    return min(_CTAS, math.ceil(n / tile))


def _logit_operands(logits, target, cls_weights, num_classes, name):
    """Shape rule (before the device), then the CUDA operands: the logits
    (copied only where a view is not 16-byte aligned), uint8 targets, the
    class weights (cached on the device), the launch plan and grid."""
    c = num_classes
    _check_classes(c)
    if logits.dtype not in (torch.bfloat16, torch.float32) or logits.shape[-1] != c:
        raise ValueError(f"{name} kernel: (..., {c}) bf16 or float32 logits, "
                         f"got {tuple(logits.shape)} {logits.dtype}")
    _build.check(logits, "logits", logits.dtype)
    if target.shape != logits.shape[:-1]:
        raise ValueError(f"{name} kernel: target {tuple(target.shape)} for "
                         f"logits {tuple(logits.shape)}")
    dev = logits.device
    t8 = _aligned(pack_targets(target.to(dev), c).contiguous())
    n = logits.numel() // c
    plan = logit_loss_plan(c, logits.dtype == torch.float32, name == "ce_dice_bwd")
    return (_aligned(logits), t8, _cw_device(cls_weights, c, dev), n, plan,
            logit_loss_grid(n, plan.tile) if n else 0)


def _ce_fwd_cuda(logits, target, cls_weights, num_classes, with_dice, focal, alpha, gamma):
    """#25 on the card → (loss, f_score, residuals (s_w, denom, score),
    the sums [S, Σw, tp, psum, tsum, tp@0.5, pos@0.5]), all written by the
    kernel (views of one buffer but the two scalars)."""
    _build.no_grad_inputs("ce_dice_fwd", logits)
    c = num_classes
    logits, t8, cw, n, plan, grid = _logit_operands(logits, target, cls_weights, c,
                                                    "ce_dice_fwd")
    dev = logits.device
    if not n:
        sums = torch.zeros(2 + 5 * c, dtype=torch.float32, device=dev)
        return (*_finish(sums, c, with_dice, 0 if focal else None), sums)
    partial = torch.empty((grid, plan.row), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    fscore = torch.empty((), dtype=torch.float32, device=dev)
    res = torch.empty(3 + 7 * c, dtype=torch.float32, device=dev)
    _build.call("tu_ce_dice_fwd", logits.data_ptr(), int(logits.dtype == torch.bfloat16),
                t8.data_ptr(), cw.data_ptr(), partial.data_ptr(), _ticket(dev).data_ptr(),
                loss.data_ptr(), fscore.data_ptr(), res.data_ptr(), n, c, int(with_dice),
                int(focal), float(alpha), float(gamma), plan.tile, plan.stages, plan.smem, grid)
    _build.launch_counts["ce_dice_fwd"] += 1
    return loss, fscore, (res[0], res[1:1 + c], res[1 + c:1 + 2 * c]), res[1 + 2 * c:]


def _ce_bwd_cuda(logits, target, cls_weights, num_classes, with_dice, focal, alpha, gamma,
                 residuals, gl):
    """#26 on the card → (dlogits, coefs [A, B, inv] as the kernel computed
    them)."""
    _build.no_grad_inputs("ce_dice_bwd", logits)
    c = num_classes
    logits, t8, cw, n, plan, grid = _logit_operands(logits, target, cls_weights, c,
                                                    "ce_dice_bwd")
    dev = logits.device
    s_w, denom, score = (r.to(device=dev, dtype=torch.float32).contiguous() for r in residuals)
    gl = gl.to(device=dev, dtype=torch.float32).contiguous()
    dlog = torch.empty_like(logits)
    if not n:
        return dlog, None
    coefs = torch.empty(2 * c + 1, dtype=torch.float32, device=dev)
    _build.call("tu_ce_dice_bwd", logits.data_ptr(), int(logits.dtype == torch.bfloat16),
                t8.data_ptr(), cw.data_ptr(), gl.data_ptr(), s_w.data_ptr(), denom.data_ptr(),
                score.data_ptr(), dlog.data_ptr(), coefs.data_ptr(), n, c, int(with_dice),
                int(focal), float(alpha), float(gamma), plan.tile, plan.stages, plan.smem, grid)
    _build.launch_counts["ce_dice_bwd"] += 1
    return dlog, coefs


def ce_dice_fwd(logits, target, cls_weights, num_classes: int, with_dice: bool = True,
                focal: bool = False, alpha: float = 0.5, gamma: float = 2.0):
    """Dispatching wrapper of #25: plain version for CPU tensors, the CUDA
    kernel for tensors on the card.  → (loss, f_score, residuals)."""
    if on_cpu(logits):
        return ce_dice_fwd_plain(logits, target, cls_weights, num_classes, with_dice, focal,
                                 alpha, gamma)
    return _ce_fwd_cuda(logits, target, cls_weights, num_classes, with_dice, focal, alpha,
                        gamma)[:3]


def ce_dice_bwd(logits, target, cls_weights, num_classes: int, with_dice: bool,
                focal: bool, alpha: float, gamma: float, residuals, gl):
    """Dispatching wrapper of #26: plain version for CPU tensors, the CUDA
    kernel for tensors on the card.  → dlogits."""
    if on_cpu(logits):
        return ce_dice_bwd_plain(logits, target, cls_weights, num_classes, with_dice, focal,
                                 alpha, gamma, residuals, gl)
    return _ce_bwd_cuda(logits, target, cls_weights, num_classes, with_dice, focal, alpha,
                        gamma, residuals, gl)[0]


class _CEDice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target, cfg):
        logits = logits.contiguous()
        cls_weights, num_classes = cfg[0], cfg[1]
        target = pack_targets(target, num_classes)  # once for both passes
        loss, fscore, (s_w, denom, score) = ce_dice_fwd(logits, target, cls_weights,
                                                        num_classes, *cfg[2:])
        ctx.save_for_backward(logits, target, s_w, denom, score)
        ctx.cfg = cfg
        ctx.mark_non_differentiable(fscore)
        ctx.set_materialize_grads(False)  # no zeros launched for f_score's gradient
        return loss, fscore

    @staticmethod
    def backward(ctx, gl, _gfs):
        if gl is None:
            return None, None, None
        logits, target, s_w, denom, score = ctx.saved_tensors
        cls_weights, num_classes, *rest = ctx.cfg
        dlog = ce_dice_bwd(logits, target, cls_weights, num_classes, *rest,
                           (s_w, denom, score), gl.float())
        return dlog, None, None


def ce_dice_loss(logits, target, cls_weights, num_classes: int, with_dice: bool = True,
                 use_focal: bool = False, alpha: float = 0.5, gamma: float = 2.0):
    """CE-or-focal (+ dice) loss and f_score on (B, H, W, C) logits at the
    target's size, with its gradient through #26: int targets (B, H, W)
    (values ≥ C are ignored) → (loss, f_score), both float32 scalars;
    f_score carries no gradient (``_vjp_bwd``, loss.py:300)."""
    _check_classes(num_classes)
    cfg = (tuple(float(v) for v in cls_weights), num_classes, with_dice, bool(use_focal),
           float(alpha), float(gamma))
    return _CEDice.apply(logits, target, cfg)
