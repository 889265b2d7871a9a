"""Time the three-conv VGG16 blocks (#23 forward, #24 backward) on the
Hopper kernels at unet_vgg's training shapes (512² input, batch 8: blocks
3, 4 and 5), on one CUDA card:

    python -m tpu_unet_torch.tools.bench_sm90

One JSON line per block: the forward's and the backward's ms per launch in
each of 5 rounds of 20 launches (CUDA events, after 3 warm-up launches),
their medians and those medians' shares of the bf16 bound, the backward's
device time by kernel (``torch.profiler``, ms per launch), and the card's
name and power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess

import torch

from tpu_unet_torch.kernels import encoder, encoder_train

PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s
BLOCKS = ((128, [128, 256, 256, 256], True), (64, [256, 512, 512, 512], True),
          (32, [512, 512, 512, 512], False))
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


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev, bf, B = "cuda", torch.bfloat16, 8
    gen = torch.Generator(device=dev).manual_seed(0)
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
