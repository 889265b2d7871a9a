"""The training losses on the card: weighted cross-entropy or focal loss +
soft dice + the f_score metric, and their gradients (counterpart of
``tpu_unet/kernels/loss.py``).

Two pairs of CUDA kernels:

- the logit-level loss, ``csrc/loss_logits.cu``: ``ce_dice_fwd`` replaces
  ``loss.py::_reductions`` (#25) and ``ce_dice_bwd`` replaces
  ``loss.py::_vjp_bwd`` (#26), the entry :func:`ce_dice_loss` as
  ``ce_dice_loss_grad`` (:205-237).  CE or focal (α 0.5, γ 2), ± dice, on
  logits that come out at the target's size;
- the final 1×1 classifier fused into the loss (CE only), ``csrc/loss.cu``:
  ``final_ce_dice_fwd`` replaces ``_final_fwd_impl`` (#27) and
  ``final_ce_dice_bwd`` replaces ``_final_vjp_bwd`` (#29), the entry
  :func:`final_ce_dice_loss` as the natural-layout
  ``final_ce_dice_loss_grad``.  Each reads the (pixels, 64) feature map
  once and recomputes the logits per pixel, so the logit map is never
  stored.

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
  db summed in float32, then cast to the weight's and the bias's dtype.

Limits: 1 ≤ C ≤ 126 (JAX's int8 target encoding, loss.py:220-224,
670-673), 64 features for #27 / #29.  The CUDA kernels read one byte a
target (:func:`pack_targets`, as JAX casts ``min(target, C)`` to int8
before its kernels) and take bf16 or float32 logits / features.  The train
step reaches only bf16 on the card today (``train/step.py::check_ported``);
the float32 instantiations match JAX's float32 kernel cases and wait for
the f32 compute path of training (ROADMAP §1).
"""
from __future__ import annotations

import math

import torch

from tpu_unet_torch.kernels import _build
from tpu_unet_torch.kernels._plain import on_cpu

_CF = 64
_MAX_CLASSES = 126
# csrc/loss.cu: pixels a tile and the most blocks (partial-sum rows)
_TILE = 128
_MAX_BLOCKS = 1024
_SMOOTH = 1e-5


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


def _operands(feats, w, b, target, cls_weights, num_classes, name):
    """Shape rule (before the device), then the CUDA operands: uint8
    targets, (C, 64) float32 weights and the float32 bias holding the
    feature-dtype values, float32 class weights."""
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
    t8 = pack_targets(target.to(dev), c).contiguous()
    wt = w.reshape(c, _CF).to(dev).to(dt).float().contiguous()
    bf = b.to(dev).to(dt).float().contiguous()
    return t8, wt, bf, _cw(cls_weights, c, dev)


def _rows(n: int) -> int:
    return min(math.ceil(n / _TILE), _MAX_BLOCKS)


def _fwd_cuda(feats, w, b, target, cls_weights, num_classes, with_dice):
    _build.no_grad_inputs("final_ce_dice_fwd", feats, w, b)
    c = num_classes
    t8, wt, bf, cw = _operands(feats, w, b, target, cls_weights, c, "final_ce_dice_fwd")
    n = feats.numel() // _CF
    sums = torch.zeros(2 + 5 * c, dtype=torch.float32, device=feats.device)
    if n:
        partial = torch.empty((_rows(n), 2 + 5 * c), dtype=torch.float32,
                              device=feats.device)
        _build.call("tu_final_ce_dice_fwd", feats.data_ptr(),
                    int(feats.dtype == torch.bfloat16), t8.data_ptr(), wt.data_ptr(),
                    bf.data_ptr(), cw.data_ptr(), partial.data_ptr(), sums.data_ptr(),
                    n, c)
        _build.launch_counts["final_ce_dice_fwd"] += 1
    return _finish(sums, c, with_dice)


def _bwd_cuda(feats, w, b, target, cls_weights, num_classes, with_dice, residuals, gl):
    _build.no_grad_inputs("final_ce_dice_bwd", feats, w, b)
    c = num_classes
    t8, wt, bf, cw = _operands(feats, w, b, target, cls_weights, c, "final_ce_dice_bwd")
    s_w, denom, score = residuals
    a, bb = dice_coefs(score, denom, c, gl, with_dice)
    a, bb = a.float().contiguous(), bb.float().contiguous()
    inv = (gl / torch.clamp_min(s_w, 1e-12)).float().reshape(1).contiguous()
    n = feats.numel() // _CF
    dfeat = torch.empty_like(feats)
    acc = torch.zeros((_CF + 1) * c, dtype=torch.float32, device=feats.device)
    if n:
        partial = torch.empty((_rows(n), (_CF + 1) * c), dtype=torch.float32,
                              device=feats.device)
        _build.call("tu_final_ce_dice_bwd", feats.data_ptr(),
                    int(feats.dtype == torch.bfloat16), t8.data_ptr(), wt.data_ptr(),
                    bf.data_ptr(), cw.data_ptr(), a.data_ptr(), bb.data_ptr(),
                    inv.data_ptr(), dfeat.data_ptr(), partial.data_ptr(), acc.data_ptr(),
                    n, c)
        _build.launch_counts["final_ce_dice_bwd"] += 1
    acc = acc.reshape(_CF + 1, c)
    dw = acc[:_CF].t().reshape(w.shape).to(w.dtype)
    return dfeat, dw, acc[_CF].to(b.dtype)


def final_ce_dice_fwd(feats, w, b, target, cls_weights, num_classes: int,
                      with_dice: bool = True):
    """Dispatching wrapper of #27: plain version for CPU tensors, the CUDA
    kernel for tensors on the card.  → (loss, f_score, residuals)."""
    if on_cpu(feats):
        return final_ce_dice_fwd_plain(feats, w, b, target, cls_weights, num_classes,
                                       with_dice)
    return _fwd_cuda(feats, w, b, target, cls_weights, num_classes, with_dice)


def final_ce_dice_bwd(feats, w, b, target, cls_weights, num_classes: int,
                      with_dice: bool, residuals, gl):
    """Dispatching wrapper of #29: plain version for CPU tensors, the CUDA
    kernel for tensors on the card.  → (dfeat, dW, db)."""
    if on_cpu(feats):
        return final_ce_dice_bwd_plain(feats, w, b, target, cls_weights, num_classes,
                                       with_dice, residuals, gl)
    return _bwd_cuda(feats, w, b, target, cls_weights, num_classes, with_dice,
                     residuals, gl)


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
        return loss, fscore

    @staticmethod
    def backward(ctx, gl, _gfs):
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


def _logit_operands(logits, target, cls_weights, num_classes, name):
    """Shape rule, then the CUDA operands: uint8 targets, float32 class
    weights."""
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
    return pack_targets(target.to(dev), c).contiguous(), _cw(cls_weights, c, dev)


def _ce_fwd_cuda(logits, target, cls_weights, num_classes, with_dice, focal, alpha, gamma):
    _build.no_grad_inputs("ce_dice_fwd", logits)
    c = num_classes
    t8, cw = _logit_operands(logits, target, cls_weights, c, "ce_dice_fwd")
    n = logits.numel() // c
    sums = torch.zeros(2 + 5 * c, dtype=torch.float32, device=logits.device)
    if n:
        partial = torch.empty((_rows(n), 2 + 5 * c), dtype=torch.float32,
                              device=logits.device)
        _build.call("tu_ce_dice_fwd", logits.data_ptr(), int(logits.dtype == torch.bfloat16),
                    t8.data_ptr(), cw.data_ptr(), partial.data_ptr(), sums.data_ptr(), n, c,
                    int(focal), float(alpha), float(gamma))
        _build.launch_counts["ce_dice_fwd"] += 1
    return _finish(sums, c, with_dice, n if focal else None)


def _ce_bwd_cuda(logits, target, cls_weights, num_classes, with_dice, focal, alpha, gamma,
                 residuals, gl):
    _build.no_grad_inputs("ce_dice_bwd", logits)
    c = num_classes
    t8, cw = _logit_operands(logits, target, cls_weights, c, "ce_dice_bwd")
    s_w, denom, score = residuals
    n = logits.numel() // c
    a, bb = dice_coefs(score, denom, c, gl, with_dice)
    a, bb = a.float().contiguous(), bb.float().contiguous()
    inv = _inv(gl, s_w, n if focal else None).float().reshape(1).contiguous()
    dlog = torch.empty_like(logits)
    if n:
        _build.call("tu_ce_dice_bwd", logits.data_ptr(), int(logits.dtype == torch.bfloat16),
                    t8.data_ptr(), cw.data_ptr(), a.data_ptr(), bb.data_ptr(), inv.data_ptr(),
                    dlog.data_ptr(), n, c, int(focal), float(alpha), float(gamma))
        _build.launch_counts["ce_dice_bwd"] += 1
    return dlog


def ce_dice_fwd(logits, target, cls_weights, num_classes: int, with_dice: bool = True,
                focal: bool = False, alpha: float = 0.5, gamma: float = 2.0):
    """Dispatching wrapper of #25: plain version for CPU tensors, the CUDA
    kernel for tensors on the card.  → (loss, f_score, residuals)."""
    if on_cpu(logits):
        return ce_dice_fwd_plain(logits, target, cls_weights, num_classes, with_dice, focal,
                                 alpha, gamma)
    return _ce_fwd_cuda(logits, target, cls_weights, num_classes, with_dice, focal, alpha,
                        gamma)


def ce_dice_bwd(logits, target, cls_weights, num_classes: int, with_dice: bool,
                focal: bool, alpha: float, gamma: float, residuals, gl):
    """Dispatching wrapper of #26: plain version for CPU tensors, the CUDA
    kernel for tensors on the card.  → dlogits."""
    if on_cpu(logits):
        return ce_dice_bwd_plain(logits, target, cls_weights, num_classes, with_dice, focal,
                                 alpha, gamma, residuals, gl)
    return _ce_bwd_cuda(logits, target, cls_weights, num_classes, with_dice, focal, alpha,
                        gamma, residuals, gl)


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
        return loss, fscore

    @staticmethod
    def backward(ctx, gl, _gfs):
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
