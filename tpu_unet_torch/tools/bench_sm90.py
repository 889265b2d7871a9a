"""Time the Hopper kernels on one CUDA card:

    python -m tpu_unet_torch.tools.bench_sm90 [part ...]

with parts ``tiles``, ``stages``, ``blocks``, ``stem``, ``head``,
``stem_fwd``, ``head_bwd`` (all by default):

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
  again), with the bytes that keeping it would hold.

Every line carries the card's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

import torch.nn.functional as F

from tpu_unet_torch.kernels import (decoder_fuse, decoder_train, encoder, encoder_train, sm90,
                                    stem, upconv)

PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
BLOCKS = ((256, [64, 128, 128], True), (128, [128, 256, 256, 256], True),
          (64, [256, 512, 512, 512], True), (32, [512, 512, 512, 512], False))
# the decoder stages at 512², batch 8: (model, x H, Cs, Cx, F)
STAGES = (("vgg", 256, 64, 128, 64), ("vgg", 128, 128, 256, 128), ("vgg", 64, 256, 512, 256),
          ("vgg", 32, 512, 512, 512), ("rn50", 128, 64, 128, 64), ("rn50", 64, 256, 256, 128),
          ("rn50", 32, 512, 512, 256), ("rn50", 16, 1024, 2048, 512))
ROUNDS, REPS = 5, 20


def _rounds(fn):
    """ms per call of ``fn`` in each of ROUNDS rounds of REPS calls."""
    for _ in range(3):
        fn()
    out = []
    for _ in range(ROUNDS):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        for _ in range(REPS):
            fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1) / REPS)
    return out


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
        name = e.name.replace("(anonymous namespace)::", "").split("<")[0].split("(")[0]
        name = name.split("::")[-1].split(" ")[-1]
        key = f"{i % per_call}:{name}"
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


def main(argv=None) -> int:
    parts = list(argv if argv is not None else sys.argv[1:]) or \
        ["tiles", "stages", "blocks", "stem", "head", "stem_fwd", "head_bwd"]
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
        else:
            raise SystemExit(f"bench_sm90: unknown part {part!r}")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
