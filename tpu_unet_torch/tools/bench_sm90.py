"""Time the Hopper kernels on one CUDA card:

    python -m tpu_unet_torch.tools.bench_sm90

- the three-conv VGG16 blocks (#23 forward, #24 backward) at unet_vgg's
  training shapes (512² input, batch 8: blocks 3, 4 and 5): one JSON line
  per block with the forward's and the backward's ms per launch in each of
  5 rounds of 20 launches (CUDA events, after 3 warm-up launches), their
  medians and those medians' shares of the bf16 bound, and the backward's
  device time by kernel (``torch.profiler``, ms per launch);
- the UnetUp decoder stages (#1 forward, ``unetup_wgrad``) at the eight
  stages of unet_vgg and unet_resnet50 (512², batch 8): one JSON line per
  stage with #1's and ``unetup_wgrad``'s ms per launch in the same rounds,
  their medians, the cuDNN yardsticks of ``chip_smoke.py`` (the stage's
  forward chain, and ``convolution_backward``'s weight and bias outputs of
  both convs), each median's share of its bound, and the device time by
  kernel: conv1, conv2 and the upsample pass of #1, the three GEMMs and
  their reduce passes of ``unetup_wgrad``.

Every line carries the card's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess

import torch

import torch.nn.functional as F

from tpu_unet_torch.kernels import decoder_fuse, decoder_train, encoder, encoder_train

PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
BLOCKS = ((128, [128, 256, 256, 256], True), (64, [256, 512, 512, 512], True),
          (32, [512, 512, 512, 512], False))
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
    fwd, lib = _rounds(fwd_fn), _rounds(fwd_lib)
    wg, wlib = _rounds(wg_fn), _rounds(wg_lib)
    fwd_ms, lib_ms = statistics.median(fwd), statistics.median(lib)
    wg_ms, wlib_ms = statistics.median(wg), statistics.median(wlib)
    line = {"stage": f"{model} {B}x{h2}x{h2} Cs={cs} Cx={cx} F={f}",
            "unetup_ms_rounds": fwd, "unetup_ms": fwd_ms, "unetup_cudnn_ms": lib_ms,
            "unetup_bound_ms": c1 + c2, "unetup_share_of_bound": (c1 + c2) / fwd_ms,
            "unetup_ms_by_kernel": _kernel_sequence(fwd_fn),
            "conv1_bound_ms": c1, "conv2_bound_ms": c2, "upsample2x_bound_ms": up_bound,
            "unetup_wgrad_ms_rounds": wg, "unetup_wgrad_ms": wg_ms,
            "unetup_wgrad_cudnn_ms": wlib_ms, "unetup_wgrad_bound_ms": c1 + c2,
            "unetup_wgrad_share_of_bound": (c1 + c2) / wg_ms,
            "unetup_wgrad_ms_by_kernel": _kernel_sequence(wg_fn)}
    line["gpu"] = smi
    print(json.dumps(line), flush=True)


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev, bf, B = "cuda", torch.bfloat16, 8
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.backends.cudnn.allow_tf32 = False
    for stage in STAGES:
        _stage(smi, gen, *stage)
        torch.cuda.empty_cache()
    for h, chans, pool in BLOCKS:
        x = torch.relu(torch.randn((B, h, h, chans[0]), generator=gen, device=dev)).to(bf)
        ws = [(torch.randn((f, c, 3, 3), generator=gen, device=dev) / (9 * c) ** 0.5).to(bf)
              for c, f in zip(chans[:-1], chans[1:])]
        bs = [(0.1 * torch.randn(f, generator=gen, device=dev)).to(bf) for f in chans[1:]]
        skip, pooled, mids = encoder._vgg_block_cuda(x, ws, bs, pool, "vgg_block3_fwd")
        dskip = torch.randn(skip.shape, generator=gen, device=dev).to(bf)
        dpool = None if pooled is None else \
            torch.randn(pooled.shape, generator=gen, device=dev).to(bf)
        fwd = _rounds(lambda: encoder._vgg_block_cuda(x, ws, bs, pool, "vgg_block3_fwd"))

        def bwd_fn():
            return encoder_train.vgg_block_bwd(dskip, dpool, x, mids, skip, ws)
        bwd = _rounds(bwd_fn)
        bound = sum(2.0 * B * h * h * 9 * c * f
                    for c, f in zip(chans[:-1], chans[1:])) / PEAK_BF16 * 1e3
        fwd_ms, bwd_ms = statistics.median(fwd), statistics.median(bwd)
        print(json.dumps({"block": f"{B}x{h}x{h} {chans}", "fwd_ms_rounds": fwd,
                          "bwd_ms_rounds": bwd, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                          "fwd_share_of_bound": bound / fwd_ms,
                          "bwd_share_of_bound": 2 * bound / bwd_ms,
                          "bwd_ms_by_kernel": _by_kernel(bwd_fn), "gpu": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
