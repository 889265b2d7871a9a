"""The float32 path's TF32 arithmetic, emulated in float64, and the bounds
it fixes.

The float32 instantiations of the Hopper kernels keep activations, weights,
gradients and accumulators in float32 and multiply in TF32 (PTX: a .tf32
operand's low 13 mantissa bits are not used).  Which operands are rounded
and which are cut depends on how they reach the tensor cores:

- the conv core (``csrc/conv3x3_sm90.cuh``; #1, #2's conv1_2, #3, #13,
  #20 / #22 / #24): the activation or gradient operand comes straight
  from a TMA box, so it is truncated (:func:`trunc_tf32`); the weights
  are rounded to nearest when they are packed (``_build.pack_conv3x3``,
  :func:`round_tf32`);
- the halo mainloop (``csrc/conv3x3_halo_sm90.cuh``; the up_conv head's
  four convs: #10 / #11's conv1 and conv2, #12's masked dgrad of conv2
  and its dgrad of conv1, ``sm90.halo_conv_launch``): the activation or
  gradient reaches the tensor cores as register fragments, loaded from
  halo boxes that the kernel's producer warpgroup rounds in place, so it
  is rounded to nearest (``cvt.rna.tf32.f32``, :func:`round_tf32`), and
  the weights are rounded as packed; its K walk is slice-major
  (``sm90.halo_walk``: per 32-channel slice, the nine taps);
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
# plain versions on the card): 1.32e-5 at 512², batch 8 against the plain
# float32 step (gradients 3.1e-2, cosine 1 - 5.9e-5), 1.52e-5 at 128²,
# batch 1 against the CPU's float32 step; STEP_LOSS_EMULATED is the larger,
# rounded up, and chip_smoke.py checks that the emulation still reads
# within it.
STEP_LOSS_EMULATED = 1.6e-5
STEP_LOSS_REL_TOL = 4 * STEP_LOSS_EMULATED
STEP_GRAD_REL_TOL = 0.4
STEP_GRAD_COS = 0.995
# A model whose emulated step reads its loss above STEP_LOSS_EMULATED at
# the card's shape gets a reading of its own, set from the emulation (never
# from the kernels' step), and 4 times it as its loss bound: unet_resnet50's
# step (CE + dice) emulated at 512², batch 8 reads 2.63e-5 against the plain
# float32 step on an H100 (the kernels' step the same, to the last bit).
STEP_LOSS_EMULATED_BY_MODEL = {"unet_resnet50": 2.7e-5}
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


@contextlib.contextmanager
def emulated_plain_versions():
    """Within the block, the plain versions that the float32 step reaches
    compute as the float32 kernels do: every 3×3 conv and dgrad on TF32
    operands (truncated activations, rounded weights; the image rounded;
    the up_conv head's four convs on rounded activations and gradients),
    every weight gradient on rounded operands, all summed in float64 and
    stored in float32."""
    from tpu_unet_torch.kernels import (decoder_fuse, decoder_train, encoder, encoder_train,
                                        stem, upconv)

    head_bwd_plain = upconv.upconv_bwd_plain

    def head_bwd(g, out, y1, x, w1, w2):
        # the head's two dgrads on the halo mainloop's rule (the gradient
        # rounded); the decoder stages' stay truncating
        keep = decoder_train._conv_nobias
        decoder_train._conv_nobias = lambda a, w: _conv_nobias(a, w, "round")
        try:
            return head_bwd_plain(g, out, y1, x, w1, w2)
        finally:
            decoder_train._conv_nobias = keep

    swaps = [(encoder, "conv3x3_relu", _conv3x3_relu), (stem, "conv3x3_relu", _conv3x3_relu),
             (decoder_fuse, "conv3x3_relu", _conv3x3_relu),
             (upconv, "conv3x3_relu", functools.partial(_conv3x3_relu, rule="round")),
             (upconv, "upconv_bwd_plain", head_bwd),
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
