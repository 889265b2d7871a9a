"""Time the Hopper kernels on one CUDA card:

    python -m tpu_unet_torch.tools.bench_sm90 [part ...]

with parts ``tiles``, ``stages``, ``blocks``, ``stem``, ``head``,
``stem_fwd``, ``head_bwd``, ``loss``, ``logit_loss``, ``adjoint``,
``tail``, ``argmax``, ``palette`` (all by default), ``wgrad_f32``,
``f32_conv`` (``f32_conv:<text>``: the cases whose name holds it),
``sass`` and ``ptxas``:

- the VGG16 blocks 2-5 in training (#21 / #23 forward, #22 / #24
  backward, all on the Hopper kernels) at unet_vgg's training shapes (512²
  input, batch 8): one JSON line per block with the forward's and the
  backward's ms per launch in each of 5 rounds of 20 launches (CUDA
  events, after 3 warm-up launches), their medians and those medians'
  shares of the bf16 bound, and the device time by kernel (``torch.profiler``,
  ms per launch) of both;
- block 2's forward (8 × 256², 64 → 128 → 128 + pool) with its convs at
  the conv core's two pixel tiles, 128 (persistent, 5 stages) and 256 (4
  stages of 48 KB, a block a tile): conv 1 / conv 2 at 128 / 128, 256 /
  128 and 256 / 256, in turns (each plan, then the same in reverse): one
  JSON line with each turn's ms per forward and its convs by kernel;
- the UnetUp decoder stages (#1 forward, #13 ``unetup_bwd``,
  ``unetup_wgrad``) at the eight stages of unet_vgg and unet_resnet50
  (512², batch 8): one JSON line per stage with each kernel's ms per
  launch in the same rounds, their medians, the cuDNN yardsticks of
  ``chip_smoke.py`` (the stage's forward chain; ``convolution_backward``'s
  data outputs of both convs; its weight and bias outputs), each median's
  share of its bound, and the device time by kernel in launch order:
  conv1, conv2 and the upsample pass of #1; the mask pass and the two
  dgrads of #13; the three GEMMs and their reduce passes of
  ``unetup_wgrad``;
- the stem's backward (#20) at 8 × 512²: ms per launch in the same
  rounds, the median, autograd of the cuDNN chain, the share of the bound
  and the device time by kernel in launch order (the pool pass, conv1_2's
  GEMM and reduce pass and its masked dgrad on the Hopper kernels,
  conv1_1's GEMM over the image and its reduce pass), with conv1_1's
  floor: reading its output gradient once;
- the ``up_conv`` head's forward (#10) at unet_resnet50's (8 × 256² →
  512²) and self_net's (8 × 512² → 1024²) shapes: the same, against
  cuDNN's chain (interpolate and two convs), by kernel the upsample pass,
  conv1 and conv2;
- the stem's forward (#2) at 8 × 512² from a uint8 batch and at 1 × 512²
  from a bf16 image: the same, against cuDNN's chain (the /255, two convs,
  the pool), by kernel conv1_1's image GEMM and conv1_2 with the pool,
  with the function's bound (operations) and the two-launch floor (the
  bytes with a1 stored and read back) and conv1_1's floor (writing a1);
- the head's backward (#12) at both heads' shapes: the same, against
  autograd of the cuDNN chain, by kernel the upsample pass, the mask
  pass, the two dgrads, the two GEMMs and their reduce passes and the
  adjoint; and, in turns with the shipped call, the backward from an
  ``up`` given (the forward's, kept from the forward instead of written
  again), with the bytes that keeping it would hold;
- the fused loss (#27 / #29) at 8 × 512² × 21 and 32 × 256² × 4 bf16, and
  its float32 instantiations at 8 × 512² × 21 and × 2;
- the logit-level loss (#25 / #26), focal + dice, at the DataB presets'
  32 × 256² × 4 bf16 (weights (1, 15, 0, 0)) and 8 × 512² × 21 bf16: per
  pass the ms per call in the same rounds and their median, the device
  time by ``torch.profiler`` of the pass's own kernels (a second launch
  that adds partial rows counted in) and of everything the wrapper
  launches, the plain version, one PyTorch yardstick (``cross_entropy``
  and the softmax sums; autograd of that chain), the bytes bound and the
  device time's share of it, the kernels in launch order and a hash of
  the outputs (loss, f_score, residuals; dlogits); then the device
  kernels of ``ce_dice_loss``'s forward and backward as a DataB step runs
  them (int32 targets, ``backward()``);
- the upsample's adjoint (#19, ``upsample_adjoint``) at every dx shape it
  serves: unet_vgg's and unet_resnet50's four decoder stages and both
  heads (512², batch 8): ms per launch in the same rounds and their
  median, the device time by ``torch.profiler``, each one's share of the
  bytes bound, autograd of ``upsample2x`` as the library yardstick, the
  launch plan where the tree has one, and a hash of dx (its int16 view's
  sum and a sha1 of its bytes; each shape's dups come from a generator of
  its own seed, so runs of two trees show whether their dx are
  bit-identical);
- the serving tails, one kernel (``csrc/tail_sm90.cu``): #4 (F = 64) at
  8 × 512² × 64 → 21 with the histogram and the mask alone at 8 × 500²
  (no multiple of 256 an image, the mask-only call); #5 (F = 32 and 22,
  the TraditionalUnet family) at the DataB batch 32 × 256² → 4, → 21 and
  (F = 32) → 32; #7 (mask only) at 32 × 200² × 32 → 4: ms per call in the
  same rounds (the host's cost per call at these sizes), the device time
  by ``torch.profiler`` warm and cold (each call after a read that
  evicts the L2), the bytes bound and each time's share of it, the plain
  version, ``F.linear`` + ``argmax`` (+ the offset ``bincount``), and a
  hash of the masks (and histogram);
- the argmax mask (#6, ``argmax_mask``, uint8 out) at self_net's 8 ×
  512² × 21 float32, the ladder models' 32 × 256² × 4 bf16 and
  lightweight's 32 × 256² × 4 float32, against ``torch.argmax``, and the
  palette blend (#8, ``mask_palette``) at 8 × 256² beside its eager
  composition (no single PyTorch call blends a palette): the same
  readings;
- ``wgrad_f32`` (not in the default set): the float32 weight-gradient
  GEMM alone at each of its shapes in the float32 path at 512², batch 8
  (``WGRAD_F32_CALLS``): device ms of its launches, cuDNN's float32
  weight gradient alone with TF32 on, the TF32 bound and the share; the
  float32 kernels that hold it (#22 / #24 at blocks 2-5,
  ``unetup_wgrad`` at the eight decoder stages, #12 at both heads) by
  events beside their bounds; and the stem's float32 backward: ms per
  call in each round, the median's share of the TF32 bound, by kernel, a
  hash of the output;
- ``f32_conv`` (not in the default set): every float32 call that runs
  the conv core, at 512², batch 8 — #13 (``unetup_bwd``) and #1 at the
  eight decoder stages, the block forwards #21 / #23 and backwards #22 /
  #24 at blocks 2-5, the stem's forward #2 and backward #20, the head's
  #10 and #12 at both heads: ms per call in the same rounds, the device
  time by kernel split into the weight pack (the pack kernel, or the
  eager kernels that packed before it) and the rest, the conv launches'
  mainloops (the head's, #1's at F ≤ 256 and #20's dgrad on the halo
  mainloop), tiles, stages and persistence, each conv launch's device
  time by the profiler beside its TF32 bound and share, cuDNN's float32
  call with TF32
  on, the TF32 bound and its share, and a digest of every output (inputs
  from a seed a case, so two trees' outputs can be held bit-identical);
- ``sass`` (not in the default set): the shared-memory (``LDS`` /
  ``STS``), generic (``LD`` / ``ST``) and global loads and stores, the
  tensor-core products (``HGMMA``: wgmma, ``HMMA``: mma.sync) and the
  conversions (``F2F``, ``F2FP``, ``FRND``) in the SASS of each instance
  of the kernels that stage in shared memory — the tail kernel, the conv
  core, the weight-gradient GEMMs, the stem's image GEMMs, the adjoint
  (#19) and the fused loss (#27 / #29), bf16 and float32 (``cuobjdump
  -sass`` of the built library) — with each one's registers a thread and
  static shared memory (``cuobjdump -res-usage``), and ptxas's report of
  the tail's and the weight-gradient GEMM's registers when they were built
  in the call;
- ``ptxas`` (not in the default set): ptxas's registers, stack frame and
  spill bytes of every conv-core instance (element type, tile, op) and
  pack-kernel instance, from the build that the call makes (run first in
  a tree of its own).

Every line carries the card's name and power limit.  Another tree's
kernels are timed by running this file with that tree's root first on
``PYTHONPATH`` (``PYTHONPATH=<root> python <this file> adjoint tail``).
The cases' inputs come from generators of their own seeds, so two trees'
hashes can be compared.
"""
from __future__ import annotations

import hashlib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

import torch.nn.functional as F

from tpu_unet_torch.kernels import (decoder_fuse, decoder_train, encoder, encoder_train, loss,
                                    postprocess, sm90, stem, upconv)
from tpu_unet_torch.nn.resize import upsample2x

PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s
PEAK_TF32 = 494.7e12  # H100 SXM dense TF32 FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
BLOCKS = ((256, [64, 128, 128], True), (128, [128, 256, 256, 256], True),
          (64, [256, 512, 512, 512], True), (32, [512, 512, 512, 512], False))
# the decoder stages at 512², batch 8: (model, x H, Cs, Cx, F)
STAGES = (("vgg", 256, 64, 128, 64), ("vgg", 128, 128, 256, 128), ("vgg", 64, 256, 512, 256),
          ("vgg", 32, 512, 512, 512), ("rn50", 128, 64, 128, 64), ("rn50", 64, 256, 256, 128),
          ("rn50", 32, 512, 512, 256), ("rn50", 16, 1024, 2048, 512))
# #19's dx shapes (B, h, C): unet_vgg up1-up4, unet_resnet50 up1-up4, the
# unet_resnet50 and self_net heads
ADJOINT_SHAPES = (("vgg up1", 8, 256, 128), ("vgg up2", 8, 128, 256), ("vgg up3", 8, 64, 512),
                  ("vgg up4", 8, 32, 512), ("rn50 up1", 8, 128, 128), ("rn50 up2", 8, 64, 256),
                  ("rn50 up3", 8, 32, 512), ("rn50 up4", 8, 16, 2048),
                  ("rn50 head", 8, 256, 64), ("self_net head", 8, 512, 64))
ROUNDS, REPS = 5, 20


def _rounds(fn, reps=REPS):
    """ms per call of ``fn`` in each of ROUNDS rounds of ``reps`` calls."""
    for _ in range(3):
        fn()
    out = []
    for _ in range(ROUNDS):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1) / reps)
    return out


def _digest(*ts):
    """A hash of tensors' bytes: the sum of their 16-bit (bf16) or 8-bit
    views and a sha1 of the bytes."""
    h, total = hashlib.sha1(), 0
    for t in ts:
        v = t.contiguous().reshape(-1)
        v = v.view(torch.int16 if v.element_size() == 2 else torch.uint8)
        total += int(v.sum(dtype=torch.int64))
        h.update(v.cpu().numpy().tobytes())
    return {"sum": total, "sha1": h.hexdigest()}


def _by_kernel(fn, reps=5):
    """``fn``'s device time by kernel name, ms per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if t:
            times[ev.key] = times.get(ev.key, 0.0) + t / 1e3 / reps
    return times


def _short_name(name):
    """A kernel's name without its namespaces, template arguments and
    parameters."""
    name = name.replace("(anonymous namespace)::", "").split("<")[0].split("(")[0]
    return name.split("::")[-1].split(" ")[-1]


def _kernel_sequence(fn, reps=5):
    """Each device kernel ``fn`` launches, in launch order, as (name, ms per
    call): kernels of one name numbered by their place among that name's
    launches of one call (conv1 and conv2 share a kernel's name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that lost kernels (not a whole sequence a call) is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        if evs and len(evs) % reps == 0:
            break
    else:
        return {}
    per_call = len(evs) // reps
    out = {}
    for i, e in enumerate(evs[:per_call * reps]):
        key = f"{i % per_call}:{_short_name(e.name)}"
        out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return out


def _stage(smi, gen, model, h, cs, cx, f, B=8):
    dev, bf = "cuda", torch.bfloat16
    h2 = 2 * h

    def act(*shape):
        return torch.relu(torch.randn(shape, generator=gen, device=dev)).to(bf)

    def conv_w(fo, c):
        return (torch.randn((fo, c, 3, 3), generator=gen, device=dev) / (9 * c) ** 0.5).to(bf), \
            (0.1 * torch.randn(fo, generator=gen, device=dev)).to(bf)

    skip, x = act(B, h2, h2, cs), act(B, h, h, cx)
    (w1, b1), (w2, b2) = conv_w(f, cs + cx), conv_w(f, f)
    fwd_fn = lambda: decoder_fuse._unetup_cuda(skip, x, w1, b1, w2, b2)  # noqa: E731

    def fwd_lib():
        up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                           align_corners=True)
        cc = torch.cat([skip.permute(0, 3, 1, 2), up], dim=1)
        y = torch.relu(F.conv2d(cc, w1, b1, padding=1))
        return torch.relu(F.conv2d(y, w2, b2, padding=1))

    dz1, y1 = act(B, h2, h2, f), act(B, h2, h2, f)
    g2 = torch.randn((B, h2, h2, f), generator=gen, device=dev).to(bf)
    wg_fn = lambda: decoder_train._unetup_wgrad_cuda(skip, x, dz1, y1, g2)  # noqa: E731
    cb = torch.ops.aten.convolution_backward
    out_ = act(B, h2, h2, f)
    bwd_fn = lambda: decoder_train._unetup_bwd_cuda(g2, out_, y1, w1, w2, cs)  # noqa: E731
    cc_like = torch.empty((B, cs + cx, h2, h2), dtype=bf, device=dev,
                          memory_format=torch.channels_last)

    def bwd_lib():
        g = torch.where(out_ > 0, g2, 0)
        d = cb(g.permute(0, 3, 1, 2), y1.permute(0, 3, 1, 2), w2, None, [1, 1], [1, 1], [1, 1],
               False, [0, 0], 1, [True, False, False])[0]
        d = torch.where(y1.permute(0, 3, 1, 2) > 0, d, 0)
        return cb(d, cc_like, w1, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                  [True, False, False])[0]

    def wg_lib():
        up = decoder_train.upsample2x(x)
        cc = torch.cat([skip.permute(0, 3, 1, 2), up.permute(0, 3, 1, 2)], dim=1)
        _, dk1, db1 = cb(dz1.permute(0, 3, 1, 2), cc, w1, [f], [1, 1], [1, 1], [1, 1], False,
                         [0, 0], 1, [False, True, True])
        _, dk2, db2 = cb(g2.permute(0, 3, 1, 2), y1.permute(0, 3, 1, 2), w2, [f], [1, 1], [1, 1],
                         [1, 1], False, [0, 0], 1, [False, True, True])
        return dk1, db1, dk2, db2

    px = B * h2 * h2
    c1, c2 = 2.0 * px * 9 * (cs + cx) * f / PEAK_BF16 * 1e3, 2.0 * px * 9 * f * f / PEAK_BF16 * 1e3
    up_bound = 2.0 * (B * h * h * cx + px * cx) / PEAK_BYTES * 1e3
    # #13's bytes: g, out, y1 read; g2, dz1, dskip, dups written
    bwd_bound = max(c1 + c2, 2.0 * px * (5 * f + cs + cx) / PEAK_BYTES * 1e3)
    fwd, lib = _rounds(fwd_fn), _rounds(fwd_lib)
    bwd, blib = _rounds(bwd_fn), _rounds(bwd_lib)
    wg, wlib = _rounds(wg_fn), _rounds(wg_lib)
    fwd_ms, lib_ms = statistics.median(fwd), statistics.median(lib)
    bwd_ms, blib_ms = statistics.median(bwd), statistics.median(blib)
    wg_ms, wlib_ms = statistics.median(wg), statistics.median(wlib)
    line = {"stage": f"{model} {B}x{h2}x{h2} Cs={cs} Cx={cx} F={f}",
            "unetup_ms_rounds": fwd, "unetup_ms": fwd_ms, "unetup_cudnn_ms": lib_ms,
            "unetup_bound_ms": c1 + c2, "unetup_share_of_bound": (c1 + c2) / fwd_ms,
            "unetup_ms_by_kernel": _kernel_sequence(fwd_fn),
            "conv1_bound_ms": c1, "conv2_bound_ms": c2, "upsample2x_bound_ms": up_bound,
            "unetup_bwd_ms_rounds": bwd, "unetup_bwd_ms": bwd_ms,
            "unetup_bwd_cudnn_ms": blib_ms, "unetup_bwd_bound_ms": bwd_bound,
            "unetup_bwd_share_of_bound": bwd_bound / bwd_ms,
            "unetup_bwd_ms_by_kernel": _kernel_sequence(bwd_fn),
            "unetup_wgrad_ms_rounds": wg, "unetup_wgrad_ms": wg_ms,
            "unetup_wgrad_cudnn_ms": wlib_ms, "unetup_wgrad_bound_ms": c1 + c2,
            "unetup_wgrad_share_of_bound": (c1 + c2) / wg_ms,
            "unetup_wgrad_ms_by_kernel": _kernel_sequence(wg_fn)}
    line["gpu"] = smi
    print(json.dumps(line), flush=True)


def _block2_tiles(smi, gen, B=8, h=256):
    """Block 2's forward with its two convs at 128 or 256 pixels, in turns:
    each turn's ms per forward, by kernel, and whether its outputs equal
    the first turn's."""
    dev, bf, chans = "cuda", torch.bfloat16, (64, 128, 128)
    x = torch.relu(torch.randn((B, h, h, 64), generator=gen, device=dev)).to(bf)
    ws = [(torch.randn((f, c, 3, 3), generator=gen, device=dev) / (9 * c) ** 0.5).to(bf)
          for c, f in zip(chans[:-1], chans[1:])]
    bs = [(0.1 * torch.randn(f, generator=gen, device=dev)).to(bf) for f in chans[1:]]
    tiles = ((128, 128), (256, 128), (256, 256))
    plans = {t: sm90.encode([sm90.conv_launch(sm90.OP_FWD, B, h, h, 64, 128, tile_m=t[0]),
                             sm90.conv_launch(sm90.OP_FWD_POOL, B, h, h, 128, 128, tile_m=t[1])])
             for t in tiles}
    rule = encoder.block_plan
    turns, ref = [], None
    try:
        for t in tiles + tiles[::-1]:
            encoder.block_plan = lambda *_a, t=t: plans[t]  # noqa: E731
            fn = lambda: encoder._vgg_block_cuda(x, ws, bs, True)  # noqa: E731
            out = fn()
            ref = out if ref is None else ref
            same = all(torch.equal(a, b) for a, b in zip(out[:2], ref[:2]))
            turns.append({"tile_m": t, "ms_rounds": _rounds(fn),
                          "ms_by_kernel": _kernel_sequence(fn), "equal_to_first": same})
    finally:
        encoder.block_plan = rule
    c1 = 2.0 * B * h * h * 9 * 64 * 128 / PEAK_BF16 * 1e3
    print(json.dumps({"block2_tiles": f"{B}x{h}x{h} {list(chans)}", "turns": turns,
                      "conv1_bound_ms": c1, "conv2_bound_ms": 2 * c1, "gpu": smi}), flush=True)


def _stem_bwd(smi, gen, B=8, h=512):
    """The stem's backward at unet_vgg's training shape against autograd of
    the cuDNN chain, by kernel."""
    dev, bf = "cuda", torch.bfloat16
    x = torch.rand((B, h, h, 3), generator=gen, device=dev).to(bf)
    w11, w12 = [(torch.randn((64, c, 3, 3), generator=gen, device=dev) / (9 * c) ** 0.5).to(bf)
                for c in (3, 64)]
    b11, b12 = [(0.1 * torch.randn(64, generator=gen, device=dev)).to(bf) for _ in range(2)]
    skip, pooled, a1 = encoder_train._vgg_stem_cuda(x, w11, b11, w12, b12)
    dskip = torch.randn(skip.shape, generator=gen, device=dev).to(bf)
    dpool = torch.randn(pooled.shape, generator=gen, device=dev).to(bf)
    fn = lambda: encoder_train.vgg_stem_bwd(dskip, dpool, x, a1, skip, w11, w12)  # noqa: E731
    with torch.enable_grad():
        ws = [t.detach().requires_grad_() for t in (w11, b11, w12, b12)]
        y = torch.relu(F.conv2d(x.permute(0, 3, 1, 2), ws[0], ws[1], padding=1))
        y = torch.relu(F.conv2d(y, ws[2], ws[3], padding=1))
        outs = [y, F.max_pool2d(y, 2)]
    cots = [dskip.permute(0, 3, 1, 2), dpool.permute(0, 3, 1, 2)]
    lib = lambda: torch.autograd.grad(outs, ws, cots, retain_graph=True)  # noqa: E731
    px = B * h * h
    bound = 2.0 * px * 9 * (64 * 64 + 3 * 64 + 64 * 64) / PEAK_BF16 * 1e3
    ms, lib_ms = _rounds(fn), _rounds(lib)
    med = statistics.median(ms)
    print(json.dumps({"stem_bwd": f"{B}x{h}x{h} [3, 64, 64]", "ms_rounds": ms, "ms": med,
                      "cudnn_ms": statistics.median(lib_ms), "bound_ms": bound,
                      "share_of_bound": bound / med, "ms_by_kernel": _kernel_sequence(fn),
                      "conv1_1_wgrad_floor_ms": 2.0 * px * 64 / PEAK_BYTES * 1e3,
                      "gpu": smi}), flush=True)


# The float32 weight-gradient GEMM's shapes at 512², batch 8: every
# distinct (H, C, F) at which the float32 path launches it (a dk1 over a
# concat [skip | up] as its pair of launches into one dk), each reached
# through the three launches of ``tu_unetup_wgrad`` at a stage (H2, Cs, Cx,
# F): skip's (0), up's (1) and dk2's (2).  Per stage call, the shapes it
# reads: name -> (the launches summed, C, with the bias).
WGRAD_F32_CALLS = (
    ((512, 64, 128, 64), {"vgg up1 dk1": ((0, 1), 192),
                          "stem conv1_2 / vgg up1 dk2 / rn50 head": ((2,), 64)}),
    ((256, 128, 256, 128), {"vgg up2 dk1": ((0, 1), 384),
                            "block2 conv2 / vgg up2 dk2": ((2,), 128)}),
    ((128, 256, 512, 256), {"vgg up3 dk1": ((0, 1), 768),
                            "block3 conv2-3 / vgg up3 dk2": ((2,), 256)}),
    ((64, 512, 512, 512), {"vgg up4 dk1": ((0, 1), 1024),
                           "block4 conv2-3 / vgg up4 dk2": ((2,), 512)}),
    ((256, 64, 128, 64), {"rn50 up1 dk1": ((0, 1), 192), "rn50 up1 dk2": ((2,), 64)}),
    ((128, 256, 256, 128), {"rn50 up2 dk1": ((0, 1), 512), "rn50 up2 dk2": ((2,), 128)}),
    ((64, 512, 512, 256), {"rn50 up3 dk1": ((0, 1), 1024), "rn50 up3 dk2": ((2,), 256)}),
    ((32, 1024, 2048, 512), {"rn50 up4 dk1": ((0, 1), 3072),
                             "block5 / rn50 up4 dk2": ((2,), 512)}),
    ((256, 64, 64, 128), {"block2 conv1": ((0,), 64)}),
    ((128, 128, 128, 256), {"block3 conv1": ((0,), 128)}),
    ((64, 256, 256, 512), {"block4 conv1": ((0,), 256)}),
    ((1024, 64, 64, 64), {"self_net head dk1 / dk2": ((0,), 64)}),
)


def _tf32_on(fn):
    """``fn`` run with cuDNN's TF32 on (PyTorch's default; the bench turns
    it off for everything else)."""
    def run():
        torch.backends.cudnn.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cudnn.allow_tf32 = False
    return run


def _f32_holders(smi, gen, dev, B):
    """The float32 kernels that hold the weight-gradient GEMM, by CUDA
    events in the rounds of ``_rounds`` (the median), each beside its TF32
    bound: #22 / #24 (``vgg_block_bwd``) at blocks 2-5, ``unetup_wgrad`` at
    the eight decoder stages and #12 (``upconv_bwd``) at both heads, at
    512², batch 8."""
    def act(*shape):
        return torch.relu(torch.randn(shape, generator=gen, device=dev))

    def conv(h, c, f):
        return 2.0 * B * h * h * 9 * c * f / PEAK_TF32 * 1e3

    for h, chans, pool in BLOCKS:
        x = act(B, h, h, chans[0])
        ws = [torch.randn((f, c, 3, 3), generator=gen, device=dev) / (9 * c) ** 0.5
              for c, f in zip(chans[:-1], chans[1:])]
        mids = [act(B, h, h, f) for f in chans[1:-1]]
        skip = act(B, h, h, chans[-1])
        dskip = torch.randn(skip.shape, generator=gen, device=dev)
        dpool = torch.randn((B, h // 2, h // 2, chans[-1]), generator=gen, device=dev) \
            if pool else None
        fn = lambda: encoder_train.vgg_block_bwd(dskip, dpool, x, mids, skip, ws)  # noqa: E731
        med = statistics.median(_rounds(fn))
        bound = 2 * sum(conv(h, c, f) for c, f in zip(chans[:-1], chans[1:]))
        print(json.dumps({"block_bwd_f32": f"{B}x{h}x{h} {chans}", "ms": med, "bound_ms": bound,
                          "share_of_bound": bound / med, "gpu": smi}), flush=True)
        del x, ws, mids, skip, dskip, dpool
        torch.cuda.empty_cache()
    for model, h, cs, cx, f in STAGES:
        h2 = 2 * h
        skip, x, dz1, y1 = act(B, h2, h2, cs), act(B, h, h, cx), act(B, h2, h2, f), \
            act(B, h2, h2, f)
        g2 = torch.randn((B, h2, h2, f), generator=gen, device=dev)
        fn = lambda: decoder_train._unetup_wgrad_cuda(skip, x, dz1, y1, g2)  # noqa: E731
        med = statistics.median(_rounds(fn))
        bound = conv(h2, cs + cx, f) + conv(h2, f, f)
        print(json.dumps({"unetup_wgrad_f32": f"{model} {B}x{h2}x{h2} Cs={cs} Cx={cx} F={f}",
                          "ms": med, "bound_ms": bound, "share_of_bound": bound / med,
                          "gpu": smi}), flush=True)
        del skip, x, dz1, y1, g2
        torch.cuda.empty_cache()
    for name, h in (("rn50 head", 256), ("self_net head", 512)):
        h2 = 2 * h
        x = act(B, h, h, 64)
        g = torch.randn((B, h2, h2, 64), generator=gen, device=dev)
        out_, y1 = act(B, h2, h2, 64), act(B, h2, h2, 64)
        w1, w2 = [torch.randn((64, 64, 3, 3), generator=gen, device=dev) / 24 for _ in range(2)]
        fn = lambda: upconv.upconv_bwd(g, out_, y1, x, w1, w2)  # noqa: E731
        med = statistics.median(_rounds(fn))
        bound = 4 * conv(h2, 64, 64)
        print(json.dumps({"upconv_bwd_f32": f"{name} {B}x{h}x{h}x64->{h2}^2x64", "ms": med,
                          "bound_ms": bound, "share_of_bound": bound / med, "gpu": smi}),
              flush=True)
        del x, g, out_, y1
        torch.cuda.empty_cache()


def _wgrad_f32(smi, B=8):
    """The float32 weight-gradient GEMM alone at each of its shapes
    (``WGRAD_F32_CALLS``): the device time of its launches and their
    reduce passes (``torch.profiler``, ms per call, in launch order within
    ``tu_unetup_wgrad``: the same reading in any tree that has that entry),
    and where the tree has the single-GEMM entry ``tu_wgrad`` its ms by
    CUDA events; beside it cuDNN's float32 weight gradient alone with TF32
    on (``convolution_backward``, output mask [False, True, False], NCHW
    views of the same tensors; events and device time), the TF32 bound and
    the share; and the stage's dk1 / dk2 against ``convolution_backward``
    with TF32 off (inputs from seed 20).  Then the stem's float32 backward
    at 512², batch 8 (its image GEMM, conv1_2's GEMM and dgrad)."""
    from tpu_unet_torch.kernels import _build

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(20)
    cb = torch.ops.aten.convolution_backward

    def act(*shape):
        return torch.relu(torch.randn(shape, generator=gen, device=dev))

    def cudnn(a, g, f):
        like = torch.empty((f, a.shape[-1], 3, 3), device=dev)
        return cb(g.permute(0, 3, 1, 2), a.permute(0, 3, 1, 2), like, None, [1, 1], [1, 1],
                  [1, 1], False, [0, 0], 1, [False, True, False])[1]

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    single = "tu_wgrad" in _build.SIGNATURES
    for (h2, cs, cx, f), shapes in WGRAD_F32_CALLS:
        skip, up, dz1, y1 = act(B, h2, h2, cs), act(B, h2, h2, cx), act(B, h2, h2, f), \
            act(B, h2, h2, f)
        g2 = torch.randn((B, h2, h2, f), generator=gen, device=dev)
        plan, ns, words = decoder_train.wgrad_plan(B, h2, h2, cs, cx, f, True)
        fl = dict(dtype=torch.float32, device=dev)
        work = torch.empty(words, **fl)
        dk1, db1 = torch.empty((f, cs + cx, 3, 3), **fl), torch.empty(f, **fl)
        dk2, db2 = torch.empty((f, f, 3, 3), **fl), torch.empty(f, **fl)

        def call():
            _build.call("tu_unetup_wgrad", skip.data_ptr(), up.data_ptr(), dz1.data_ptr(),
                        y1.data_ptr(), g2.data_ptr(), work.data_ptr(), dk1.data_ptr(),
                        db1.data_ptr(), dk2.data_ptr(), db2.data_ptr(), B, h2, h2, cs, cx, f, 1,
                        plan.data_ptr())

        call()
        torch.cuda.synchronize()
        cc = torch.cat([skip, up], -1)
        errs = {"dk1_rel_err_vs_tf32_off": rel(dk1, cudnn(cc, dz1, f)),
                "dk2_rel_err_vs_tf32_off": rel(dk2, cudnn(y1, g2, f))}
        seq = list(_kernel_sequence(call).items())
        for name, (idx, c) in shapes.items():
            a, g = (cc, dz1) if idx == (0, 1) else (skip, dz1) if idx == (0,) else (y1, g2)
            ms = sum(v for k, v in seq if int(k.split(":")[0]) // 2 in idx)
            lib = _tf32_on(lambda a=a, g=g: cudnn(a, g, f))
            lib_ms = statistics.median(_rounds(lib))
            lib_dev = sum(_by_kernel(lib).values())
            bound = 2.0 * B * h2 * h2 * 9 * c * f / PEAK_TF32 * 1e3
            line = {"wgrad_f32": name, "shape": f"{B}x{h2}x{h2} C={c} F={f}",
                    "nsplit": [ns[i] for i in idx], "device_ms": ms,
                    "kernels": [k for k, _ in seq if int(k.split(":")[0]) // 2 in idx],
                    "cudnn_tf32_ms": lib_ms, "cudnn_tf32_device_ms": lib_dev,
                    "bound_ms": bound, "share_of_bound": bound / ms,
                    "vs_cudnn": ms / lib_dev, **errs}
            if single:
                line["events_ms"] = statistics.median(_rounds(
                    lambda idx=idx: [decoder_train.wgrad_gemm(*(
                        (skip, dz1, cs + cx, 0, True) if i == 0 else
                        (up, dz1, cs + cx, cs, False) if i == 1 else (y1, g2, f, 0, True)))
                        for i in idx]))
            line["gpu"] = smi
            print(json.dumps(line), flush=True)
        del skip, up, dz1, y1, g2, cc, work
        torch.cuda.empty_cache()
    _f32_holders(smi, gen, dev, B)
    h = 512
    x = torch.rand((B, h, h, 3), generator=gen, device=dev)
    w11, w12 = [torch.randn((64, c, 3, 3), generator=gen, device=dev) / (9 * c) ** 0.5
                for c in (3, 64)]
    b11, b12 = [0.1 * torch.randn(64, generator=gen, device=dev) for _ in range(2)]
    skip, pooled, a1 = encoder_train._vgg_stem_cuda(x, w11, b11, w12, b12)
    dskip = torch.randn(skip.shape, generator=gen, device=dev)
    dpool = torch.randn(pooled.shape, generator=gen, device=dev)
    fn = lambda: encoder_train.vgg_stem_bwd(dskip, dpool, x, a1, skip, w11, w12)  # noqa: E731
    ms = _rounds(fn)
    med = statistics.median(ms)
    bound = 2.0 * B * h * h * 9 * (64 * 64 + 3 * 64 + 64 * 64) / PEAK_TF32 * 1e3
    print(json.dumps({"stem_bwd_f32": f"{B}x{h}x{h} [3, 64, 64]", "ms_rounds": ms, "ms": med,
                      "bound_ms": bound, "share_of_bound": bound / med,
                      "ms_by_kernel": _kernel_sequence(fn),
                      "digest": _digest(*[t for r in fn() for t in r]), "gpu": smi}), flush=True)


def _port_kernels():
    """The names of the ``__global__`` functions in the measured tree's
    ``csrc/`` (a kernel of any other name in a call's sequence is
    PyTorch's)."""
    from tpu_unet_torch.kernels import _build

    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)")
    return {n for p in _build.CSRC.iterdir() for n in pat.findall(p.read_text())}


def _tensors(out):
    """The tensors of a nested result, in order (None left out)."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in (out or ()) for t in _tensors(o)]


def _f32_line(smi, port, kernel, case, fn, lib, flops, nbytes, launches):
    """One JSON line of ``f32_conv``: ms per call in the rounds and their
    median, the device time by kernel in launch order split into the weight
    pack (``pack_kernel``, or the eager PyTorch kernels that packed the
    weights before it: every kernel of the call not in ``csrc/``) and the
    rest, cuDNN's float32 call with TF32 on, the bound at the TF32 peak
    (or the bytes), the conv launches' mainloops (the conv core's per-tap
    slices, or the halo mainloop's), tiles, stages and persistence, each
    one's device time (the call's conv kernels in launch order, the
    ``launches`` in plan order) beside its operations at the TF32 peak and
    that bound's share, and a digest of every output."""
    ms = _rounds(fn)
    med = statistics.median(ms)
    # by name where the trace lost the call's sequence
    seq = _kernel_sequence(fn) or {f"{i}:{_short_name(k)}": v
                                   for i, (k, v) in enumerate(_by_kernel(fn).items())}
    pack = sum(v for k, v in seq.items()
               if k.split(":", 1)[1] == "pack_kernel" or k.split(":", 1)[1] not in port)
    rest = sum(seq.values()) - pack
    lib_ms = statistics.median(_rounds(_tf32_on(lib)))
    t_ops, t_mem = flops / PEAK_TF32 * 1e3, nbytes / PEAK_BYTES * 1e3
    bound = max(t_ops, t_mem)
    out = fn()
    torch.cuda.synchronize()
    halo = getattr(sm90, "MAINLOOP_HALO", None)  # a parent tree's plan may have none
    plan = [{"tile": list(ln["tile"]), "stages": ln["stages"],
             "mainloop": "halo" if halo is not None and ln.get("mainloop") == halo else "tap",
             "persistent": (halo is not None and ln.get("mainloop") == halo)
             or sm90.conv_own_staging(ln["tile"][1], ln["tile"][0], True)}
            for ln in launches]
    conv_ms = [v for k, v in seq.items()
               if k.split(":", 1)[1] in ("conv_sm90_kernel", "halo_conv_kernel")]
    if len(conv_ms) == len(launches):
        for p, ln, t in zip(plan, launches, conv_ms):
            _, w, h, b = ln["maps"][0]["dims"]
            ct, _, f = ln["maps"][1]["dims"]  # the weights (F, 9, C [+ C2])
            p_bound = 2.0 * b * h * w * 9 * ct * f / PEAK_TF32 * 1e3
            p.update({"device_ms": t, "bound_ms": p_bound, "share_of_bound": p_bound / t})
    print(json.dumps({"f32_conv": kernel, "case": case, "ms_rounds": ms, "ms": med,
                      "pack_device_ms": pack, "kernels_device_ms": rest, "ms_by_kernel": seq,
                      "cudnn_tf32_ms": lib_ms, "vs_cudnn": med / lib_ms, "bound_ms": bound,
                      "bound_by": "operations" if t_ops >= t_mem else "bytes",
                      "share_of_bound": bound / med, "kernels_share_of_bound": bound / rest
                      if rest else None, "conv_launches": plan,
                      "digest": _digest(*_tensors(out)), "gpu": smi}), flush=True)


def _f32_conv(smi, B=8, only=""):
    """``f32_conv``: the float32 calls that run the conv core at 512², batch
    8 — #13 and #1 at the eight decoder stages, the block forwards #21 /
    #23 (#3's kernel) at blocks 2-5, the stem's forward #2, the head's #10
    and #12 at both heads, the stem's backward #20 and the block backwards
    #22 / #24 — each through :func:`_f32_line`, the inputs of each from a
    generator of its own seed, so that two trees' digests can be compared
    (the parent's by ``PYTHONPATH``).  With ``only`` the cases whose name
    holds it (``f32_conv:8x256x256``: the 256-pixel tiles' shapes).  The
    bytes bound counts each input read once and each output written
    once."""
    dev = "cuda"
    port = _port_kernels()
    cb = torch.ops.aten.convolution_backward
    seed = iter(range(100, 200))

    def gens():
        return torch.Generator(device=dev).manual_seed(next(seed))

    def act(gen, *shape):
        return torch.relu(torch.randn(shape, generator=gen, device=dev))

    def conv_w(gen, f, c):
        return (torch.randn((f, c, 3, 3), generator=gen, device=dev) / (9 * c) ** 0.5,
                0.1 * torch.randn(f, generator=gen, device=dev))

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in _tensors(ts))

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    def up2(x):
        return F.interpolate(nchw(x), scale_factor=2, mode="bilinear", align_corners=True)

    def grads(outs, ins, cots):
        """autograd of a cuDNN chain built once: a call recomputes the
        gradients of ``ins``."""
        return lambda: torch.autograd.grad(outs, ins, cots, retain_graph=True)  # noqa: E731

    for model, h, cs, cx, f in STAGES:
        gen, h2 = gens(), 2 * h
        px = B * h2 * h2
        name = f"{model} {B}x{h2}x{h2} Cs={cs} Cx={cx} F={f}"
        if only not in name:
            continue
        (w1, b1), (w2, b2) = conv_w(gen, f, cs + cx), conv_w(gen, f, f)
        g2 = torch.randn((B, h2, h2, f), generator=gen, device=dev)
        out_, y1 = act(gen, B, h2, h2, f), act(gen, B, h2, h2, f)
        like = torch.empty((B, cs + cx, h2, h2), device=dev, memory_format=torch.channels_last)

        def bwd_lib():
            g = torch.where(out_ > 0, g2, 0)
            d = cb(nchw(g), nchw(y1), w2, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                   [True, False, False])[0]
            d = torch.where(nchw(y1) > 0, d, 0)
            return cb(d, like, w1, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                      [True, False, False])[0]

        flops = 2.0 * px * 9 * f * (f + cs + cx)
        _f32_line(smi, port, "unetup_bwd_f32", name,
                  lambda: decoder_train._unetup_bwd_cuda(g2, out_, y1, w1, w2, cs), bwd_lib,
                  flops, 4.0 * px * (5 * f + cs + cx) + nb(w1, w2),
                  sm90.unetup_bwd_launches(B, h2, h2, cs, cx, f, True))
        skip, x = act(gen, B, h2, h2, cs), act(gen, B, h, h, cx)

        def fwd_lib():
            cc = torch.cat([nchw(skip), up2(x)], dim=1)
            y = torch.relu(F.conv2d(cc, w1, b1, padding=1))
            return torch.relu(F.conv2d(y, w2, b2, padding=1))

        _f32_line(smi, port, "unetup_f32", name,
                  lambda: decoder_fuse._unetup_cuda(skip, x, w1, b1, w2, b2, want_y1=True),
                  fwd_lib, flops, nb(skip, x, w1, w2) + 2 * 4.0 * px * f,
                  sm90.unetup_launches(B, h2, h2, cs, cx, f, True))
        del w1, w2, g2, out_, y1, like, skip, x
        torch.cuda.empty_cache()
    for h, chans, pool in BLOCKS:
        gen = gens()
        n = len(chans) - 1
        x = act(gen, B, h, h, chans[0])
        wb = [conv_w(gen, fo, c) for c, fo in zip(chans[:-1], chans[1:])]
        ws, bs = [w for w, _ in wb], [b for _, b in wb]
        key = encoder_train.block_key(n, "fwd")
        name = f"{B}x{h}x{h} {chans}"
        if only not in name:
            continue
        flops = sum(2.0 * B * h * h * 9 * c * fo for c, fo in zip(chans[:-1], chans[1:]))
        skip, pooled, mids = encoder._vgg_block_cuda(x, ws, bs, pool, key)

        def blk_lib():
            y = nchw(x)
            for w, b in zip(ws, bs):
                y = torch.relu(F.conv2d(y, w, b, padding=1))
            return (y, F.max_pool2d(y, 2)) if pool else y

        _f32_line(smi, port, key + "_f32", name,
                  lambda: encoder._vgg_block_cuda(x, ws, bs, pool, key), blk_lib, flops,
                  nb(x, ws, skip, pooled, mids),
                  sm90.block_fwd_launches(B, h, h, chans, pool, True))
        dskip = torch.randn(skip.shape, generator=gen, device=dev)
        dpool = torch.randn(pooled.shape, generator=gen, device=dev) if pool else None
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            wg = [t.detach().requires_grad_() for t in ws + bs]
            y = nchw(xg)
            for w, b in zip(wg[:n], wg[n:]):
                y = torch.relu(F.conv2d(y, w, b, padding=1))
            outs = [y, F.max_pool2d(y, 2)] if pool else [y]
        cots = [nchw(dskip)] + ([nchw(dpool)] if pool else [])
        _f32_line(smi, port, encoder_train.block_key(n, "bwd") + "_f32", name,
                  lambda: encoder_train.vgg_block_bwd(dskip, dpool, x, mids, skip, ws),
                  grads(outs, [xg, *wg], cots), 2 * flops,
                  nb(x, mids, skip, ws, dskip, dpool) + nb(x, ws),  # + dx, dks
                  sm90.block_bwd_launches(B, h, h, chans, True, True)[1::2])
        del x, ws, bs, wb, skip, pooled, mids, dskip, dpool, xg, wg, y, outs, cots
        torch.cuda.empty_cache()
    gen, h = gens(), 512
    case = f"{B}x{h}x{h} [3, 64, 64]"
    if only in case:
        img = torch.rand((B, h, h, 3), generator=gen, device=dev)
        (w11, b11), (w12, b12) = conv_w(gen, 64, 3), conv_w(gen, 64, 64)
        px = B * h * h
        flops = 2.0 * px * 9 * (3 * 64 + 64 * 64)
        skip, pooled, a1 = stem._vgg_stem_cuda(img, w11, b11, w12, b12)

        def stem_lib():
            y = torch.relu(F.conv2d(nchw(img), w11, b11, padding=1))
            y = torch.relu(F.conv2d(y, w12, b12, padding=1))
            return y, F.max_pool2d(y, 2)

        _f32_line(smi, port, "vgg_stem_f32", case,
                  lambda: stem._vgg_stem_cuda(img, w11, b11, w12, b12), stem_lib, flops,
                  nb(img, skip, pooled, a1), sm90.stem_fwd_launches(B, h, h, 64, True)[1:])
        dskip = torch.randn(skip.shape, generator=gen, device=dev)
        dpool = torch.randn(pooled.shape, generator=gen, device=dev)
        with torch.enable_grad():
            wg = [t.detach().requires_grad_() for t in (w11, b11, w12, b12)]
            y = torch.relu(F.conv2d(nchw(img), wg[0], wg[1], padding=1))
            y = torch.relu(F.conv2d(y, wg[2], wg[3], padding=1))
            outs = [y, F.max_pool2d(y, 2)]
        _f32_line(smi, port, "vgg_stem_bwd_f32", case,
                  lambda: encoder_train.vgg_stem_bwd(dskip, dpool, img, a1, skip, w11, w12),
                  grads(outs, wg, [nchw(dskip), nchw(dpool)]),
                  flops + 2.0 * px * 9 * 64 * 64,
                  nb(img, a1, skip, dskip, dpool, w11, w12) + nb(w11, w12),  # + dks
                  sm90.stem_bwd_launches(B, h, h, 64, True)[3:])
        del img, skip, pooled, a1, dskip, dpool, wg, y, outs
        torch.cuda.empty_cache()
    for name, h in (("rn50 head", 256), ("self_net head", 512)):
        gen, h2 = gens(), 2 * h
        px = B * h2 * h2
        case = f"{name} {B}x{h}x{h}x64->{h2}^2x64"
        if only not in case:
            continue
        x = act(gen, B, h, h, 64)
        (w1, b1), (w2, b2) = conv_w(gen, 64, 64), conv_w(gen, 64, 64)
        flops = 2 * 2.0 * px * 9 * 64 * 64

        def head_lib():
            y = torch.relu(F.conv2d(up2(x), w1, b1, padding=1))
            return torch.relu(F.conv2d(y, w2, b2, padding=1))

        out_, y1 = upconv._upconv_cuda(x, w1, b1, w2, b2, want_y1=True)
        _f32_line(smi, port, "upconv_f32", case,
                  lambda: upconv._upconv_cuda(x, w1, b1, w2, b2, want_y1=True), head_lib, flops,
                  nb(x, out_, y1), sm90.unetup_launches(B, h2, h2, 0, 64, 64, True))
        g = torch.randn((B, h2, h2, 64), generator=gen, device=dev)
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            wg = [t.detach().requires_grad_() for t in (w1, b1, w2, b2)]
            y = torch.relu(F.conv2d(up2(xg), wg[0], wg[1], padding=1))
            y = torch.relu(F.conv2d(y, wg[2], wg[3], padding=1))
        _f32_line(smi, port, "upconv_bwd_f32", case,
                  lambda: upconv._upconv_bwd_cuda(g, out_, y1, x, w1, w2),
                  grads([y], [xg, *wg], [nchw(g)]), 2 * flops,
                  nb(g, out_, y1, x, w1, w2) + nb(x, w1, w2),  # + dx, dk1, dk2
                  sm90.upconv_bwd_launches(B, h2, h2, 64, 64, True)[:2])
        del x, out_, y1, g, xg, wg, y
        torch.cuda.empty_cache()


def _head(smi, gen, B, h):
    """The up_conv head's forward at x (B, h, h, 64) against cuDNN's chain,
    by kernel."""
    dev, bf = "cuda", torch.bfloat16
    x = torch.relu(torch.randn((B, h, h, 64), generator=gen, device=dev)).to(bf)
    (w1, b1), (w2, b2) = [((torch.randn((64, 64, 3, 3), generator=gen, device=dev) / 24).to(bf),
                           (0.1 * torch.randn(64, generator=gen, device=dev)).to(bf))
                          for _ in range(2)]
    fn = lambda: upconv._upconv_cuda(x, w1, b1, w2, b2)  # noqa: E731

    def lib():
        up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                           align_corners=True)
        y = torch.relu(F.conv2d(up, w1, b1, padding=1))
        return torch.relu(F.conv2d(y, w2, b2, padding=1))

    h2 = 2 * h
    conv = 2.0 * B * h2 * h2 * 9 * 64 * 64 / PEAK_BF16 * 1e3
    ms, lib_ms = _rounds(fn), _rounds(lib)
    med = statistics.median(ms)
    print(json.dumps({"upconv": f"{B}x{h}x{h}x64->{h2}^2x64", "ms_rounds": ms, "ms": med,
                      "cudnn_ms": statistics.median(lib_ms), "bound_ms": 2 * conv,
                      "share_of_bound": 2 * conv / med, "conv_bound_ms": conv,
                      "upsample2x_bound_ms": 2.0 * B * 64 * (h * h + h2 * h2) / PEAK_BYTES * 1e3,
                      "ms_by_kernel": _kernel_sequence(fn), "gpu": smi}), flush=True)


def _stem_fwd(smi, gen, B, h, u8):
    """The stem's forward at (B, h, h, 3) uint8 (or bf16 from the normalize
    step) against cuDNN's chain, by kernel, with its floors."""
    dev, bf = "cuda", torch.bfloat16
    img = torch.randint(0, 256, (B, h, h, 3), generator=gen, device=dev, dtype=torch.uint8)
    xb = img.to(bf) / torch.tensor(255.0, dtype=bf, device=dev)
    x = img if u8 else xb
    (w11, b11), (w12, b12) = [((torch.randn((64, c, 3, 3), generator=gen, device=dev)
                                / (9 * c) ** 0.5).to(bf),
                               (0.1 * torch.randn(64, generator=gen, device=dev)).to(bf))
                              for c in (3, 64)]
    fn = lambda: stem._vgg_stem_cuda(x, w11, b11, w12, b12)  # noqa: E731

    def lib():
        v = (img.to(bf) / torch.tensor(255.0, dtype=bf, device=dev)) if u8 else xb
        y = torch.relu(F.conv2d(v.permute(0, 3, 1, 2), w11, b11, padding=1))
        y = torch.relu(F.conv2d(y, w12, b12, padding=1))
        return y, F.max_pool2d(y, 2)

    px = B * h * h
    bound = 2.0 * px * 9 * (3 * 64 + 64 * 64) / PEAK_BF16 * 1e3
    a1_bytes = 2.0 * px * 64
    floor = (x.numel() * x.element_size() + 3 * a1_bytes + a1_bytes / 4) / PEAK_BYTES * 1e3
    ms, lib_ms = _rounds(fn), _rounds(lib)
    med = statistics.median(ms)
    print(json.dumps({"stem_fwd": f"{B}x{h}x{h}x3 {'uint8' if u8 else 'bf16'}->64",
                      "ms_rounds": ms, "ms": med, "cudnn_ms": statistics.median(lib_ms),
                      "bound_ms": bound, "share_of_bound": bound / med,
                      "two_launch_floor_ms": floor,
                      "conv1_1_floor_ms": a1_bytes / PEAK_BYTES * 1e3,
                      "conv1_2_bound_ms": 2.0 * px * 9 * 64 * 64 / PEAK_BF16 * 1e3,
                      "ms_by_kernel": _kernel_sequence(fn), "gpu": smi}), flush=True)


def _head_bwd(smi, gen, B, h):
    """The up_conv head's backward at x (B, h, h, 64) against autograd of the
    cuDNN chain, by kernel; then the shipped call and the backward from a
    kept ``up`` in turns."""
    dev, bf = "cuda", torch.bfloat16
    h2 = 2 * h
    x = torch.relu(torch.randn((B, h, h, 64), generator=gen, device=dev)).to(bf)
    g = torch.randn((B, h2, h2, 64), generator=gen, device=dev).to(bf)
    out_, y1 = [torch.relu(torch.randn((B, h2, h2, 64), generator=gen, device=dev)).to(bf)
                for _ in range(2)]
    w1, w2 = [(torch.randn((64, 64, 3, 3), generator=gen, device=dev) / 24).to(bf)
              for _ in range(2)]
    fn = lambda: upconv.upconv_bwd(g, out_, y1, x, w1, w2)  # noqa: E731
    up = decoder_train.up2x(x)
    kept = lambda: upconv._upconv_bwd_launch(g, out_, y1, up, w1, w2)  # noqa: E731
    with torch.enable_grad():
        xg = x.detach().requires_grad_()
        wg = [w.detach().requires_grad_() for w in (w1, w2)]
        bg = [torch.zeros(64, dtype=bf, device=dev, requires_grad=True) for _ in range(2)]
        y = torch.relu(F.conv2d(decoder_train.upsample2x(xg).permute(0, 3, 1, 2), wg[0], bg[0],
                                padding=1))
        y = torch.relu(F.conv2d(y, wg[1], bg[1], padding=1))
    cot = g.permute(0, 3, 1, 2)
    lib = lambda: torch.autograd.grad(y, [xg, *wg, *bg], cot, retain_graph=True)  # noqa: E731
    conv = 2.0 * B * h2 * h2 * 9 * 64 * 64 / PEAK_BF16 * 1e3
    ms, lib_ms = _rounds(fn), _rounds(lib)
    med = statistics.median(ms)
    turns = [("shipped", fn), ("up_kept", kept), ("up_kept", kept), ("shipped", fn)]
    turn_ms = [(name, statistics.median(_rounds(f))) for name, f in turns]
    print(json.dumps({"upconv_bwd": f"{B}x{h}x{h}x64->{h2}^2x64", "ms_rounds": ms, "ms": med,
                      "cudnn_ms": statistics.median(lib_ms), "bound_ms": 4 * conv,
                      "share_of_bound": 4 * conv / med, "conv_bound_ms": conv,
                      "mask_bound_ms": 6.0 * B * h2 * h2 * 64 / PEAK_BYTES * 1e3,
                      "ms_by_kernel": _kernel_sequence(fn) or _by_kernel(fn), "turns_ms": turn_ms,
                      "up_kept_bytes": up.numel() * up.element_size(), "gpu": smi}), flush=True)


def _blocks(smi, gen, B=8):
    dev, bf = "cuda", torch.bfloat16
    for h, chans, pool in BLOCKS:
        x = torch.relu(torch.randn((B, h, h, chans[0]), generator=gen, device=dev)).to(bf)
        ws = [(torch.randn((f, c, 3, 3), generator=gen, device=dev) / (9 * c) ** 0.5).to(bf)
              for c, f in zip(chans[:-1], chans[1:])]
        bs = [(0.1 * torch.randn(f, generator=gen, device=dev)).to(bf) for f in chans[1:]]
        key = encoder_train.block_key(len(ws), "fwd")
        skip, pooled, mids = encoder._vgg_block_cuda(x, ws, bs, pool, key)
        dskip = torch.randn(skip.shape, generator=gen, device=dev).to(bf)
        dpool = None if pooled is None else \
            torch.randn(pooled.shape, generator=gen, device=dev).to(bf)
        fwd = _rounds(lambda: encoder._vgg_block_cuda(x, ws, bs, pool, key))

        def bwd_fn():
            return encoder_train.vgg_block_bwd(dskip, dpool, x, mids, skip, ws)
        bwd = _rounds(bwd_fn)
        bound = sum(2.0 * B * h * h * 9 * c * f
                    for c, f in zip(chans[:-1], chans[1:])) / PEAK_BF16 * 1e3
        fwd_ms, bwd_ms = statistics.median(fwd), statistics.median(bwd)
        print(json.dumps({"block": f"{B}x{h}x{h} {chans}", "fwd_ms_rounds": fwd,
                          "bwd_ms_rounds": bwd, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                          "fwd_share_of_bound": bound / fwd_ms,
                          "fwd_ms_by_kernel": _kernel_sequence(
                              lambda: encoder._vgg_block_cuda(x, ws, bs, pool, key)),
                          "bwd_share_of_bound": 2 * bound / bwd_ms,
                          "bwd_ms_by_kernel": _by_kernel(bwd_fn), "gpu": smi}), flush=True)


def _loss(smi, gen, B, h, c, dt=torch.bfloat16):
    """#27 and #29 at (B, h, h, 64) features of ``dt`` (bf16, or float32:
    the float32 path's instantiations) → c classes (see the module
    note)."""
    dev, bf = "cuda", torch.bfloat16
    feats = torch.relu(torch.randn((B, h, h, 64), generator=gen, device=dev)).to(dt)
    w = torch.randn((c, 64, 1, 1), generator=gen, device=dev) / 8
    b = 0.1 * torch.randn(c, generator=gen, device=dev)
    if dt == bf:
        w, b = w.to(bf).float(), b.to(bf).float()
    tag = "bf16" if dt == bf else "float32"
    t32 = torch.randint(0, c, (B, h, h), generator=gen, device=dev, dtype=torch.int32)
    t32 = torch.where(torch.rand((B, h, h), generator=gen, device=dev) < 0.03,
                      torch.full_like(t32, c), t32)
    t = loss.pack_targets(t32, c)
    cw = tuple(1.0 + 0.1 * i for i in range(c))
    gl = torch.tensor(1.0, device=dev)
    res = loss.final_ce_dice_fwd(feats, w, b, t, cw, c, True)[2]
    passes = {
        "final_ce_dice_fwd": (lambda: loss.final_ce_dice_fwd(feats, w, b, t, cw, c, True),
                              lambda: loss.final_ce_dice_fwd_plain(feats, w, b, t, cw, c, True)),
        "final_ce_dice_bwd": (lambda: loss.final_ce_dice_bwd(feats, w, b, t, cw, c, True, res, gl),
                              lambda: loss.final_ce_dice_bwd_plain(feats, w, b, t, cw, c, True,
                                                                   res, gl)),
    }
    f2, w2, tl = feats.reshape(-1, 64), w.reshape(c, 64).to(dt), torch.clamp_max(t, c).long()
    cw_t = torch.tensor(cw, device=dev)

    def chain(f2, w2, b2):
        lf = F.linear(f2, w2, b2).float()
        ce = F.cross_entropy(lf, tl.reshape(-1), weight=cw_t, ignore_index=c)
        p = torch.softmax(lf, -1)
        oh = F.one_hot(tl.reshape(-1), c + 1)[:, :c].float()
        tp, ps, ts = (p * oh).sum(0), p.sum(0), oh.sum(0)
        return ce + 1 - ((2 * tp + 1e-5) / (2 * tp + (ts - tp) + (ps - tp) + 1e-5)).mean()

    with torch.enable_grad():
        leaves = [f2.detach().clone().requires_grad_(), w2.detach().clone().requires_grad_(),
                  b.to(dt).detach().clone().requires_grad_()]
        graph = chain(*leaves)
    libs = {"final_ce_dice_fwd": lambda: chain(f2, w2, b.to(dt)),
            "final_ce_dice_bwd": lambda: torch.autograd.grad(graph, leaves, retain_graph=True)}
    fb = feats.numel() * feats.element_size()
    in_bytes = fb + t.numel() + c * 65 * 4
    out_bytes = {"final_ce_dice_fwd": 4 * (5 + 2 * c), "final_ce_dice_bwd": fb + c * 65 * 4}
    for name, (fn, plain) in passes.items():
        ms = _rounds(fn)
        med = statistics.median(ms)
        bound = (in_bytes + out_bytes[name]) / PEAK_BYTES * 1e3
        print(json.dumps({"kernel": name, "case": f"{B}x{h}x{h}x64 {tag} -> {c}", "ms_rounds": ms,
                          "ms": med, "plain_ms": statistics.median(_rounds(plain)),
                          "library_ms": statistics.median(_rounds(libs[name])),
                          "bound_ms": bound, "bound_by": "bytes", "share_of_bound": bound / med,
                          "ms_by_kernel": _kernel_sequence(fn) or _by_kernel(fn), "gpu": smi}),
              flush=True)
    # the device kernels of the loss and its backward, as a train step calls them
    with torch.enable_grad():
        fg = feats.detach().clone().requires_grad_()
        wg = w.to(dt).detach().requires_grad_()
        bg = b.to(dt).detach().requires_grad_()

        def step():
            fg.grad = wg.grad = bg.grad = None  # as the step's zero_grad(set_to_none=True)
            lo, _ = loss.final_ce_dice_loss(fg, wg, bg, t32, cw, c, True)
            lo.backward()
        seq = _kernel_sequence(step)
    print(json.dumps({"loss_step_kernels": f"{B}x{h}x{h}x64 {tag} -> {c}", "launches": len(seq),
                      "kernels": sorted(seq), "gpu": smi}), flush=True)


def _logit_loss(smi, B, h, c):
    """#25 and #26 at (B, h, h, c) bf16 logits, focal + dice (see the
    module note)."""
    gen = torch.Generator(device="cuda").manual_seed(11 * h + c)
    dev, bf = "cuda", torch.bfloat16
    x = (2 * torch.randn((B, h, h, c), generator=gen, device=dev)).to(bf)
    t32 = torch.randint(0, c, (B, h, h), generator=gen, device=dev, dtype=torch.int32)
    r = torch.rand((B, h, h), generator=gen, device=dev)
    t32 = torch.where(r < 0.03, torch.full_like(t32, c), t32)
    t32 = torch.where(r > 0.98, torch.full_like(t32, 255), t32)
    t = loss.pack_targets(t32, c)
    cw = (1.0, 15.0, 0.0, 0.0) if c == 4 else tuple(1.0 + 0.1 * i for i in range(c))
    gl = torch.tensor(1.0, device=dev)
    lo, fs, res = loss.ce_dice_fwd(x, t, cw, c, True, True)
    _, _, pres = loss.ce_dice_fwd_plain(x, t, cw, c, True, True)
    dlog = loss.ce_dice_bwd(x, t, cw, c, True, True, 0.5, 2.0, res, gl)
    passes = {
        "ce_dice_fwd": (lambda: loss.ce_dice_fwd(x, t, cw, c, True, True),
                        lambda: loss.ce_dice_fwd_plain(x, t, cw, c, True, True)),
        "ce_dice_bwd": (lambda: loss.ce_dice_bwd(x, t, cw, c, True, True, 0.5, 2.0, res, gl),
                        lambda: loss.ce_dice_bwd_plain(x, t, cw, c, True, True, 0.5, 2.0,
                                                       pres, gl)),
    }
    xf, tl, cw_t = x.reshape(-1, c), t.long().reshape(-1), torch.tensor(cw, device=dev)

    def chain(lf):
        ce = F.cross_entropy(lf, tl, weight=cw_t, ignore_index=c)
        p = torch.softmax(lf, -1)
        oh = F.one_hot(torch.clamp_max(tl, c), c + 1)[:, :c].float()
        pt = (p > 0.5).float()
        tp, ps, ts = (p * oh).sum(0), p.sum(0), oh.sum(0)
        dice = 1 - ((2 * tp + 1e-5) / (2 * tp + (ts - tp) + (ps - tp) + 1e-5)).mean()
        return ce + dice, (pt * oh).sum(0), pt.sum(0)

    with torch.enable_grad():
        xg = xf.detach().float().requires_grad_()
        graph = chain(xg)[0]
    libs = {"ce_dice_fwd": lambda: chain(xf.float()),
            "ce_dice_bwd": lambda: torch.autograd.grad(graph, [xg], retain_graph=True)}
    outs = {"ce_dice_fwd": (lo, fs, *res), "ce_dice_bwd": (dlog,)}
    in_bytes = x.numel() * 2 + t.numel()
    out_bytes = {"ce_dice_fwd": 0, "ce_dice_bwd": x.numel() * 2}
    plan = getattr(loss, "logit_loss_plan", None)
    for name, (fn, plain) in passes.items():
        ms = _rounds(fn)
        med = statistics.median(ms)
        by = _by_kernel(fn, reps=20)
        own = sum(v for k, v in by.items() if "ce_dice" in k or "sum_rows" in k)
        bound = (in_bytes + out_bytes[name]) / PEAK_BYTES * 1e3
        print(json.dumps({"kernel": name, "case": f"{B}x{h}x{h}x{c} bf16 focal + dice",
                          "ms_rounds": ms, "ms": med, "device_ms": own,
                          "wrapper_device_ms": sum(by.values()),
                          "plain_ms": statistics.median(_rounds(plain)),
                          "library_ms": statistics.median(_rounds(libs[name])),
                          "bound_ms": bound, "bound_by": "bytes",
                          "share_of_bound": bound / own, "events_share_of_bound": bound / med,
                          "ms_by_kernel": _kernel_sequence(fn) or by,
                          "plan": plan(c, False, name == "ce_dice_bwd")._asdict() if plan else None,
                          "outputs": _digest(*outs[name]), "gpu": smi}), flush=True)
    # the device kernels of the loss and its backward, as a DataB step calls them
    with torch.enable_grad():
        lg = x.detach().clone().requires_grad_()

        def step():
            lg.grad = None  # as the step's zero_grad(set_to_none=True)
            lo_, _ = loss.ce_dice_loss(lg, t32, cw, c, True, True)
            lo_.backward()
        seq = _kernel_sequence(step)
    print(json.dumps({"loss_step_kernels": f"{B}x{h}x{h}x{c} bf16 focal + dice",
                      "launches": len(seq), "kernels": sorted(seq), "gpu": smi}), flush=True)


def _adjoint(smi, name, B, h, c):
    """#19 at dx (B, h, h, c) (see the module note)."""
    gen = torch.Generator(device="cuda").manual_seed(1000 * h + c)
    dups = torch.randn((B, 2 * h, 2 * h, c), generator=gen, device="cuda").to(torch.bfloat16)
    x = torch.zeros((B, h, h, c), dtype=torch.bfloat16, device="cuda")

    def fn():
        return decoder_train.upsample2x_adjoint(dups, h, h)

    def lib():
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            up = upsample2x(xg)
        return torch.autograd.grad(up, xg, dups)[0]

    dx = fn()
    ms = _rounds(fn)
    med = statistics.median(ms)
    by = _by_kernel(fn, reps=20)
    dev_ms = sum(v for k, v in by.items() if "upsample_adjoint" in k)
    bound = 2 * (dups.numel() + dx.numel()) / PEAK_BYTES * 1e3
    plan = getattr(decoder_train, "adjoint_plan", None)
    print(json.dumps({"kernel": "upsample_adjoint", "case": f"{name}: {B}x{2 * h}^2x{c} -> {h}^2",
                      "ms_rounds": ms, "ms": med, "device_ms": dev_ms,
                      "library_ms": statistics.median(_rounds(lib, reps=2)), "bound_ms": bound,
                      "bound_by": "bytes", "share_of_bound": bound / dev_ms,
                      "events_share_of_bound": bound / med, "ms_by_kernel": by,
                      "plan": plan(B, h, h, c)._asdict() if plan else None,
                      "dx": _digest(dx), "gpu": smi}), flush=True)


def _cold_device_ms(fn, match, reps=20):
    """The device time per call of ``fn``'s kernels whose name holds one of
    ``match`` (``torch.profiler``), each call after a 256 MB read that
    evicts its inputs from the 50 MB L2 (the read not counted; a read
    leaves no dirty lines to write back during the call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.zeros(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.sum()
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and any(m in e.name for m in match)) \
        / 1e3 / reps


def _small_kernel(smi, kernel, case, fn, plain, lib, match, nbytes, digest, lib_label):
    """One JSON line for a small kernel: events (the host's cost per call
    at these sizes), the profiler's device time warm and cold, the bytes
    bound and each share of it, the plain version's and the library's
    events, a hash of the output."""
    ms = _rounds(fn)
    med = statistics.median(ms)
    by = _by_kernel(fn, reps=20)
    dev_ms = sum(v for k, v in by.items() if any(m in k for m in match))
    cold = _cold_device_ms(fn, match)
    bound = nbytes / PEAK_BYTES * 1e3
    print(json.dumps({"kernel": kernel, "case": case, "ms_rounds": ms, "ms": med,
                      "device_ms": dev_ms, "device_ms_cold": cold,
                      "plain_ms": statistics.median(_rounds(plain, reps=5)),
                      lib_label: None if lib is None else statistics.median(_rounds(lib)),
                      "bound_ms": bound, "bound_by": "bytes",
                      "share_of_bound": bound / dev_ms if dev_ms else None,
                      "cold_share_of_bound": bound / cold if cold else None,
                      "events_share_of_bound": bound / med,
                      "ms_by_kernel": by, "out": digest, "gpu": smi}), flush=True)


# the tails' kernels under both trees' names (the F = 22 / 32 template of
# csrc/postprocess.cu before the one tail kernel)
TAIL_KERNELS = ("final_tail_kernel", "final_argmax_kernel")


def _tail(smi, B, h, c, hist, f=64):
    """A serving tail at (B, h, h, f) bf16 features → c classes (see the
    module note)."""
    gen = torch.Generator(device="cuda").manual_seed(7 * h + c + (0 if f == 64 else 1000 * f))
    bf = torch.bfloat16
    feats = torch.relu(torch.randn((B, h, h, f), generator=gen, device="cuda")).to(bf)
    w = (torch.randn((c, f, 1, 1), generator=gen, device="cuda") / f ** 0.5).to(bf)
    b = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(bf)
    tail = postprocess.final_argmax_hist if hist else postprocess.final_argmax
    plain = postprocess.final_argmax_hist_plain if hist else postprocess.final_argmax_plain
    w2 = w.reshape(c, f)
    offs = torch.arange(B, device="cuda").reshape(B, 1, 1) * c

    def fn():
        return tail(feats, w, b, c)

    def lib():  # cuBLAS bf16 logits, argmax (+ one offset bincount)
        cls = F.linear(feats, w2, b).argmax(-1)
        return torch.bincount((cls + offs).reshape(-1), minlength=B * c) if hist else cls

    out = fn()
    outs = out if hist else (out,)
    _small_kernel(smi, "final_argmax_hist" if hist else "final_argmax", f"{B}x{h}x{h}x{f} -> {c}",
                  fn, lambda: plain(feats, w, b, c), lib, TAIL_KERNELS,
                  feats.numel() * 2 + sum(t.numel() * t.element_size() for t in outs),
                  _digest(*outs), "library_ms")


def _argmax(smi, n, h, c, dt):
    """#6 (``argmax_mask``, uint8 out) at a generic serving step's shape:
    small-integer logits (ties on most pixels), a NaN every 37th row."""
    from tpu_unet_torch.kernels.postprocess import argmax_mask, argmax_mask_plain

    gen = torch.Generator(device="cuda").manual_seed(n * h + c)
    x = torch.randint(-3, 4, (n, h, h, c), generator=gen, device="cuda").to(dt)
    x.view(-1, c)[::37, c // 2] = float("nan")
    u8 = torch.uint8
    out = argmax_mask(x, u8)
    _small_kernel(smi, "argmax_mask", f"{n}x{h}x{h}x{c} {str(dt).split('.')[-1]}->uint8",
                  lambda: argmax_mask(x, u8), lambda: argmax_mask_plain(x, u8),
                  lambda: torch.argmax(x, dim=-1), ("argmax_kernel",),
                  x.numel() * x.element_size() + out.numel(), _digest(out), "library_ms")


def _palette(smi, n, h):
    """#8 (``mask_palette``) over n frames of h x h with 4-class masks; no
    single PyTorch call blends a palette: the eager composition (the plain
    version) is timed in its place."""
    from tpu_unet_torch.infer.wrapper import VOC_COLORS
    from tpu_unet_torch.kernels.render import mask_palette, mask_palette_plain, palette_tensor

    gen = torch.Generator(device="cuda").manual_seed(n * h)
    pal = palette_tensor(VOC_COLORS, "cuda")
    mask = torch.randint(0, 4, (n, h, h), generator=gen, device="cuda", dtype=torch.uint8)
    img = torch.randint(0, 256, (n, h, h, 3), generator=gen, device="cuda", dtype=torch.uint8)
    out = mask_palette(mask, img, pal)
    _small_kernel(smi, "mask_palette", f"{n}x{h}x{h} uint8 mask, {pal.shape[0]} colours",
                  lambda: mask_palette(mask, img, pal), lambda: mask_palette_plain(mask, img, pal),
                  lambda: mask_palette_plain(mask, img, pal), ("palette_kernel",),
                  mask.numel() + img.numel() + out.numel() + pal.numel(), _digest(out),
                  "eager_composition_ms")


# the kernels whose shared memory ``sass`` reads, by their names' stems
SASS_KERNELS = ("final_tail_kernel", "conv_sm90_kernel", "halo_conv_kernel",
                "wgrad_sm90_kernel", "wgrad_f32_kernel", "wgrad_tf32_kernel",
                "wgrad_image_kernel", "wgrad_image_f32_kernel", "conv_image_kernel",
                "upsample_adjoint_kernel", "final_loss_fwd_kernel", "final_loss_bwd_kernel")
SASS_OPS = ("LDS", "LD", "LDG", "STS", "ST", "STG", "LDSM", "HGMMA", "HMMA", "F2F", "F2FP",
            "FRND")


def _sass(smi):
    """The shared-memory and generic loads and stores, the tensor-core
    products and the conversions in the SASS of each instance of
    ``SASS_KERNELS`` (``cuobjdump -sass`` of the built library; shared
    memory reached through a generic pointer shows as ``LD`` / ``ST``, not
    ``LDS`` / ``STS``), each with its registers a thread
    (``cuobjdump -res-usage``)."""
    import re

    from tpu_unet_torch.kernels import _build

    so = _build.build()
    log = _build.build_log  # ptxas's registers, spills and shared memory, when built here
    for src in ("tail_sm90", "unetup_wgrad"):
        m = re.search(rf"^{src}\.cu:\n(.*?)(?=^\w+\.cu:$|\Z)", log, re.S | re.M)
        if m:
            print(m.group(1), flush=True)
    tool = str(Path(_build._nvcc()).with_name("cuobjdump"))
    res = subprocess.run([tool, "-res-usage", str(so)], capture_output=True, text=True,
                         check=True).stdout
    usage = dict(re.findall(r"Function (\S+):\s*\n\s*(REG:.*)", res))
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    parts = re.split(r"Function : (\S+)", text)
    for name, body in zip(parts[1::2], parts[2::2]):
        if not any(k in name for k in SASS_KERNELS):
            continue
        ops = {}
        for line in body.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", line)
            if m:
                op = m.group(1).split(".")[0]
                if op in SASS_OPS:
                    ops[op] = ops.get(op, 0) + 1
        print(json.dumps({"sass": name, "ops": ops, "usage": usage.get(name, ""), "gpu": smi}),
              flush=True)


CONV_OPS = ("fwd", "fwd_pool", "dgrad_mask", "dgrad_split")  # kernels/sm90.py's OP_* order


def _ptxas(smi):
    """ptxas's report (``-Xptxas=-v``) of every conv-core instance
    (``conv_sm90_kernel<T, TN, OP, PH>``), halo-mainloop instance
    (``halo_conv_kernel<OP, PH>``) and pack-kernel instance in the
    library that this process builds: one JSON line each with its source,
    element type, N tile, op and pixel tile (``conv``) or layout and store
    width (``pack``), registers a thread, stack frame and spill bytes.  Run
    it first in a tree of its own: a library already built leaves no
    report."""
    import re

    from tpu_unet_torch.kernels import _build

    _build.build()
    if not _build.build_log:
        print(json.dumps({"ptxas": None, "why": "the library was built before this process",
                          "gpu": smi}), flush=True)
        return
    src = name = frame = None
    for line in _build.build_log.splitlines():
        if m := re.match(r"^(\w+)\.cu:$", line):
            src = m.group(1)
        elif m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            frame = [int(v) for v in m.groups()]
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            row = {"source": f"{src}.cu", "registers": int(m.group(1)), "stack": frame[0],
                   "spill_stores": frame[1], "spill_loads": frame[2], "gpu": smi}
            dt = r"(13__nv_bfloat16|f)"
            if c := re.search(rf"conv_sm90_kernelI{dt}Li(\d+)ELi(\d+)ELi(\d+)E", name):
                t, tn, op, ph = c.groups()
                print(json.dumps({"ptxas": "conv_sm90_kernel", "dtype": "float32" if t == "f"
                                  else "bf16", "tile": [16 * int(ph), int(tn)],
                                  "op": CONV_OPS[int(op)], **row}), flush=True)
            elif c := re.search(r"halo_conv_kernelILi(\d+)ELi(\d+)E", name):
                op, ph = c.groups()
                print(json.dumps({"ptxas": "halo_conv_kernel", "dtype": "float32",
                                  "tile": [16 * int(ph), 64], "op": CONV_OPS[int(op)], **row}),
                      flush=True)
            elif c := re.search(rf"pack_kernelI{dt}Lb(\d)ELb(\d)E", name):
                t, flip, vec = c.groups()
                print(json.dumps({"ptxas": "pack_kernel", "dtype": "float32" if t == "f"
                                  else "bf16", "flip": flip == "1", "vec": vec == "1", **row}),
                      flush=True)
            name = None


def main(argv=None) -> int:
    parts = list(argv if argv is not None else sys.argv[1:]) or \
        ["tiles", "stages", "blocks", "stem", "head", "stem_fwd", "head_bwd", "loss",
         "logit_loss", "adjoint", "tail", "argmax", "palette"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cudnn.allow_tf32 = False
    for part in parts:
        if part == "tiles":
            _block2_tiles(smi, gen)
        elif part == "stages":
            for stage in STAGES:
                _stage(smi, gen, *stage)
                torch.cuda.empty_cache()
        elif part == "blocks":
            _blocks(smi, gen)
        elif part == "stem":
            _stem_bwd(smi, gen)
        elif part == "head":
            for B, h in ((8, 256), (8, 512)):
                _head(smi, gen, B, h)
                torch.cuda.empty_cache()
        elif part == "stem_fwd":
            for B, u8 in ((8, True), (1, False)):
                _stem_fwd(smi, gen, B, 512, u8)
        elif part == "head_bwd":
            for B, h in ((8, 256), (8, 512)):
                _head_bwd(smi, gen, B, h)
                torch.cuda.empty_cache()
        elif part == "loss":
            for B, h, c in ((8, 512, 21), (32, 256, 4)):
                _loss(smi, gen, B, h, c)
                torch.cuda.empty_cache()
            for c in (21, 2):  # the float32 path: voc's and medical's classes
                _loss(smi, gen, 8, 512, c, torch.float32)
                torch.cuda.empty_cache()
        elif part == "logit_loss":
            for B, h, c in ((32, 256, 4), (8, 512, 21)):
                _logit_loss(smi, B, h, c)
                torch.cuda.empty_cache()
        elif part == "adjoint":
            for name, B, h, c in ADJOINT_SHAPES:
                _adjoint(smi, name, B, h, c)
                torch.cuda.empty_cache()
        elif part == "tail":
            _tail(smi, 8, 512, 21, True)
            _tail(smi, 8, 500, 21, False)
            # #5 at the DataB serving batch (traditional, traditional22) and
            # at 21 classes, #7 at 200² (mask only)
            for f, h, c, hist in ((32, 256, 4, True), (22, 256, 4, True), (32, 200, 4, False),
                                  (32, 256, 21, True), (22, 256, 21, True), (32, 256, 32, True)):
                _tail(smi, 32, h, c, hist, f)
                torch.cuda.empty_cache()
        elif part == "argmax":  # #6 at self_net's, the ladder models' and lightweight's shapes
            for n, h, c, dt in ((8, 512, 21, torch.float32), (32, 256, 4, torch.bfloat16),
                                (32, 256, 4, torch.float32)):
                _argmax(smi, n, h, c, dt)
        elif part == "palette":  # #8 at the batched video path's 8 frames
            _palette(smi, 8, 256)
        elif part == "wgrad_f32":
            _wgrad_f32(smi)
        elif part.split(":")[0] == "f32_conv":
            _f32_conv(smi, only=part.partition(":")[2])
        elif part == "sass":
            _sass(smi)
        elif part == "ptxas":
            _ptxas(smi)
        else:
            raise SystemExit(f"bench_sm90: unknown part {part!r}")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
