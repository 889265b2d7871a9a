"""The float32 path's TF32 arithmetic, emulated in float64, and the bounds
it fixes.

The float32 instantiations of the Hopper kernels keep activations, weights,
gradients and accumulators in float32 and multiply in TF32 (PTX: a .tf32
operand's low 13 mantissa bits are not used).  Which operands are rounded
and which are cut depends on how they reach the tensor cores:

- the conv core (``csrc/conv3x3_sm90.cuh``; #1's other convs,
  #2's conv1_2, #3, #13, #22 / #24): the activation or gradient operand
  comes straight from a TMA box, so it is truncated (:func:`trunc_tf32`);
  the weights are rounded to nearest when they are packed
  (``_build.pack_conv3x3``, :func:`round_tf32`);
- the halo mainloop (``csrc/conv3x3_halo_sm90.cuh``, the launches whose
  record names it, ``sm90.halo_conv_launch``): the up_conv head's four
  convs (#10 / #11's conv1 and conv2, #12's masked dgrad of conv2 and its
  dgrad of conv1), #1's conv1 (over [skip | up]) and conv2 at F ≤ 256
  (``sm90.unetup_launches``: both models' up1-up3) and #20's masked
  dgrad of conv1_2 (``sm90.stem_bwd_launches``): the activation or
  gradient reaches the tensor cores as register fragments, loaded from
  halo boxes that the kernel's producer warpgroup rounds in place, so it
  is rounded to nearest (``cvt.rna.tf32.f32``, :func:`round_tf32`), and
  the weights are rounded as packed; its K walk is slice-major
  (``sm90.halo_walk``: per 32-channel slice of in, then of in2, the nine
  taps); :func:`launch_rule` reads the rule off a launch;
- the weight-gradient GEMM (``csrc/wgrad_sm90.cuh::wgrad_tf32_kernel``,
  TF32 ``wgmma``): G is restaged K-major and the input's boxes are
  rounded in place by the kernel's restaging warpgroup before the
  consumers load their register fragments from them, so both operands
  are rounded to nearest (``cvt.rna.tf32.f32``); a fragment loaded
  unrounded would be truncated, which shrinks a ReLU'd input's products
  by ~2⁻¹² each (systematic, not averaging out over the pixels);
- the image GEMMs (``csrc/stem.cu`` on ``wgmma``, ``csrc/encoder_train.cu``
  on ``mma.sync``): every operand is gathered or stored by the kernel
  itself, and rounded to nearest.

The functions here compute a kernel's result from such operands in
float64; the CPU tests hold them to the plain float32 versions and to the
JAX package's references, and read the distance that fixes the bounds
below.  ``chip_smoke.py`` and the card's tests hold the kernels to the
plain versions (TF32 off) within those bounds, and one tile of each to
these emulations (the witness: whether the card truncated or rounded, held
within :func:`tile_rel_tol`).  Nothing on the port's path calls this
module.
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F

from tpu_unet_torch.kernels import sm90
from tpu_unet_torch.kernels._build import round_tf32

# The bounds of the float32 kernels against their plain float32 versions,
# relative to the plain output's largest magnitude, each at least 4 times
# the CPU emulation's largest reading at the path's widths
# (tests/test_torch_tf32.py): one conv reads ~5e-4 (a truncated activation
# and a rounded weight in each product), a chain of three convs 1.32e-3
# (block 5's forward), dx / dskip up to 1.25e-3; a weight gradient of
# rounded operands from exact inputs 4.4e-4 (the stem's conv1_2), one
# behind kernel dgrads 9.7e-4 (block 5's first conv).
CONV_REL_TOL = 1e-2          # a conv, or a chain of 2-3 convs (#1, #2, #3, #13)
WGRAD_REL_TOL = 2e-3         # a weight or bias gradient from exact inputs
WGRAD_CHAIN_REL_TOL = 5e-3   # ... behind kernel dgrads (the stage backwards)
# The float32 train step (every kernel above) against a float32 step
# without TF32 from the same weights and batch: the loss, every gradient's
# largest deviation relative to its largest entry, every gradient's
# cosine; each bound 4 times the emulated step's reading (the step with
# :func:`emulated_plain_versions`, float64 sums) or more.  At 64², batch 2
# (tests/test_torch_train.py, against JAX's float32 step and the port's
# plain one) that reads at most 1.3e-6, 8.6e-2 (block 5's conv 3: 32
# pixels a channel, where a ReLU mask the TF32 products flip weighs most)
# and 1 - 1.14e-3.  The loss's bound is fixed at the card's shapes and
# batches instead (chip_smoke.py's, read there on an H100 through the
# plain versions on the card): with the halo mainloop's rounding at #1's
# up1-up3 and #20's dgrad, 1.98e-6 at 512², batch 8 against the plain
# float32 step (gradients 3.9e-2, cosine 1 - 1.6e-4), 5.94e-6 at 128², batch
# 1 against the CPU's float32 step (where the card's kernels read 6.10e-6);
# STEP_LOSS_EMULATED is the larger, rounded up, and chip_smoke.py checks
# that the emulation still reads within it.
STEP_LOSS_EMULATED = 6.0e-6
STEP_LOSS_REL_TOL = 4 * STEP_LOSS_EMULATED
STEP_GRAD_REL_TOL = 0.4
STEP_GRAD_COS = 0.995
# A model whose emulated step reads its loss above STEP_LOSS_EMULATED at
# the card's shape gets a reading of its own, set from the emulation (never
# from the kernels' step), and 4 times it as its loss bound: unet_resnet50's
# step (CE + dice) emulated at 512², batch 8 reads 7.61e-6 against the plain
# float32 step on an H100 (the kernels' step 7.26e-6).
STEP_LOSS_EMULATED_BY_MODEL = {"unet_resnet50": 7.7e-6}
# unet_resnet50's emulated step at 64², batch 2 against JAX's float64 step
# (tests/test_torch_resnet_x64.py; JAX's float32 step lies up to 13% from
# float64 behind the batch norms): its up4 sees 32 pixels a channel over
# Cs + Cx = 3072 input channels, where the TF32 products flip the most ReLU
# masks — up4's conv1 weight gradient reads 0.158 from float64 (the plain
# float32 step 1.9e-4), and the batch norms carry that back into ResNet50
# at a cosine of 1 - 1.67e-3.  That test's bounds, 4 times those readings
# rounded up, set from the emulation as STEP_LOSS_EMULATED is; the card's
# steps at 512², batch 8 are held to the bounds above.
STEP_GRAD_REL_TOL_RN50_64PX = 0.65
STEP_GRAD_COS_RN50_64PX = 0.993


def step_loss_emulated(model: str) -> float:
    """The emulated step's loss reading that fixes ``model``'s loss bound."""
    return STEP_LOSS_EMULATED_BY_MODEL.get(model, STEP_LOSS_EMULATED)


def step_loss_rel_tol(model: str) -> float:
    """The bound of ``model``'s float32 step's loss against a plain float32
    step: 4 times :func:`step_loss_emulated`."""
    return 4 * step_loss_emulated(model)


def tile_rel_tol(k: int) -> float:
    """The bound of a float32 kernel's product over a reduction of ``k``
    TF32 products against its emulation from the same TF32 operands summed
    in float64, relative to the largest output.  The tensor cores add each
    k8 step's products to the float32 accumulator and round it toward
    zero, not to nearest as IEEE float32 does: at most 2⁻²³ of the running
    sum a step, ceil(k / 8) steps in a chain of k; then at most ceil(k /
    128) split-K partials (8 × 16-pixel patches) and the epilogue's bias
    add, rounded to nearest (2⁻²⁴ each); the running sums taken no larger
    than the largest output.  At the conv core's widest K (9 × 1024) that
    is 1.4e-4, a third of the 4e-4-7e-4 between the emulations of the two
    operand rules, so a product within it tells which rule the card
    applied (tests/test_torch_tf32.py holds a float64 model of that
    accumulation within it and below half that distance)."""
    return -(-k // 8) * 2.0 ** -23 + (-(-k // 128) + 1) * 2.0 ** -24


def trunc_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` with its low 13 mantissa bits cleared: the TF32 value
    the tensor cores use of a float32 word they are handed as it is."""
    return (t.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


RULES = {"trunc": trunc_tf32, "round": round_tf32}


def launch_rule(ln: dict) -> str:
    """The rule a float32 conv launch takes its activation or gradient
    operand to TF32 by: ``"round"`` on the halo mainloop (register
    fragments of a box rounded in place), ``"trunc"`` on the conv core (a
    TMA box's words as they are)."""
    return "round" if ln.get("mainloop") == sm90.MAINLOOP_HALO else "trunc"


def conv3x3(x: torch.Tensor, w: torch.Tensor, rule: str = "trunc") -> torch.Tensor:
    """The conv core's products of a 3×3 SAME conv, no bias: NHWC ``x``
    taken to TF32 by ``rule`` (``"trunc"``: as a TMA box hands it over;
    ``"round"``), OIHW ``w`` rounded as packed; summed in float64 → NHWC
    float64."""
    xt = RULES[rule](x).double().permute(0, 3, 1, 2)
    y = F.conv2d(xt, round_tf32(w).double(), padding=1)
    return y.permute(0, 2, 3, 1)


def conv3x3_relu(x, w, b, rule: str = "trunc") -> torch.Tensor:
    """:func:`conv3x3` with the float32 bias and the ReLU of the forward's
    epilogue."""
    return torch.relu(conv3x3(x, w, rule) + b.double())


def wgrad(v: torch.Tensor, g: torch.Tensor, rule: str = "round") -> torch.Tensor:
    """The weight-gradient GEMM's (F, C, 3, 3) from NHWC input ``v`` and
    output gradient ``g``, both taken to TF32 by ``rule`` (``"round"``: as
    the float32 GEMM's fragments and restaged G are), summed in
    float64."""
    vf = RULES[rule](v).double().permute(0, 3, 1, 2)
    gf = RULES[rule](g).double().permute(0, 3, 1, 2)
    like = torch.empty((gf.shape[1], vf.shape[1], 3, 3), dtype=torch.float64, device=v.device)
    return torch.ops.aten.convolution_backward(gf, vf, like, None, [1, 1], [1, 1], [1, 1], False,
                                               [0, 0], 1, [False, True, False])[1]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| relative to max |b|, in float64."""
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-300)).item()


# ---- the step: the plain building blocks swapped for their TF32 forms ------

def _ste(rule, t):
    """``t`` taken to TF32 by ``rule``, its gradient passed straight
    through (the plain stages that autograd differentiates)."""
    return t + (RULES[rule](t.detach()) - t).detach()


def _conv3x3_relu(x, w, b, rule=None):
    if rule is None:  # the stem's image GEMM rounds, the conv core truncates
        rule = "round" if x.shape[-1] == 3 else "trunc"
    y = F.conv2d(_ste(rule, x).double().permute(0, 3, 1, 2), _ste("round", w).double(),
                 b.double(), padding=1)
    return torch.relu(y).permute(0, 2, 3, 1).float().contiguous()


def _conv_nobias(x, w, rule="trunc"):
    y = F.conv2d(_ste(rule, x).double().permute(0, 3, 1, 2), _ste("round", w).double(),
                 padding=1)
    return y.permute(0, 2, 3, 1).float().contiguous()


def _conv_wgrad(v, gout):
    return wgrad(v, gout).float()


def _dgrads_rounded(mod, fn):
    """``fn`` with the dgrads it reaches through ``mod._conv_nobias`` on the
    halo mainloop's rule (the gradient rounded): the head's backward (both
    its dgrads), the stem's (its one, conv1_2's); the decoder stages' and
    the blocks' stay truncating."""
    def run(*args):
        keep = mod._conv_nobias
        mod._conv_nobias = lambda a, w: _conv_nobias(a, w, "round")
        try:
            return fn(*args)
        finally:
            mod._conv_nobias = keep
    return run


def _unetup_plain_y1(skip, x, w1, b1, w2, b2):
    """#1's plain stage (``decoder_fuse._unetup_plain_y1``) with each conv
    on the rule of the mainloop its float32 plan puts it on."""
    from tpu_unet_torch.kernels.decoder_fuse import upsample2x

    B, H2, W2, cs = skip.shape
    r1, r2 = (launch_rule(ln) for ln in
              sm90.unetup_launches(B, H2, W2, cs, x.shape[-1], w1.shape[0], True))
    y1 = _conv3x3_relu(torch.cat([skip, upsample2x(x)], dim=-1), w1, b1, r1)
    return _conv3x3_relu(y1, w2, b2, r2), y1


@contextlib.contextmanager
def emulated_plain_versions():
    """Within the block, the plain versions that the float32 step reaches
    compute as the float32 kernels do: every 3×3 conv and dgrad on TF32
    operands (truncated activations, rounded weights; the image rounded;
    on the halo mainloop — the up_conv head's four convs, #1's two convs
    where its plan puts them there, the stem's masked dgrad — rounded
    activations and gradients), every weight gradient on rounded operands,
    all summed in float64 and stored in float32."""
    from tpu_unet_torch.kernels import (decoder_fuse, decoder_train, encoder, encoder_train,
                                        stem, upconv)

    swaps = [(encoder, "conv3x3_relu", _conv3x3_relu), (stem, "conv3x3_relu", _conv3x3_relu),
             (decoder_fuse, "_unetup_plain_y1", _unetup_plain_y1),
             (upconv, "conv3x3_relu", functools.partial(_conv3x3_relu, rule="round")),
             (upconv, "upconv_bwd_plain", _dgrads_rounded(decoder_train, upconv.upconv_bwd_plain)),
             (encoder_train, "vgg_stem_bwd_plain",
              _dgrads_rounded(encoder_train, encoder_train.vgg_stem_bwd_plain)),
             (encoder_train, "conv3x3_relu", _conv3x3_relu),
             (encoder_train, "_conv_nobias", _conv_nobias),
             (decoder_train, "_conv_nobias", _conv_nobias),
             (encoder_train, "conv_wgrad", _conv_wgrad), (decoder_train, "conv_wgrad", _conv_wgrad)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, fn in swaps:
            setattr(m, n, fn)
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
