"""Time the normalize kernel's call (#9) on one CUDA card, host and device
apart:

    python -m tpu_unet_torch.tools.bench_launch

At the single-image forward's shapes (1×256², 1×512²) and a DataB batch
(32×256²), uint8 to float32 and to bfloat16: one JSON line per case with
the ms per call of back-to-back calls (CUDA events over 5 rounds of 200
calls, after warm-up: the larger of the host's and the device's cost), the
host time per call (the host clock over 200 calls not waited for), the
device time per call (``torch.profiler``, the kernels' durations), each of
the wrapper and of the library's two ops (``img.to(dtype).mul_(1 / 255)``),
and the bytes bound.  Run from a checkout's root it times that checkout's
``tpu_unet_torch``, so two trees are compared in one call by running it
in each, in turns.  Every line carries the card's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

from tpu_unet_torch.kernels.preprocess import normalize_images

PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
CASES = ((1, 256), (1, 512), (32, 256))
ROUNDS, REPS = 5, 200


def _events_ms(fn):
    for _ in range(20):
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
    return statistics.median(out)


def host_ms(fn, reps: int = REPS) -> float:
    """``fn``'s host time per call: the host clock over ``reps`` calls not
    waited for (what issuing one costs), after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return host


def device_ms(fn, reps: int = 20, tries: int = 3) -> float:
    """``fn``'s device time per call: its kernels' durations
    (``torch.profiler``) summed over ``reps`` calls.  A window in which the
    profiler recorded no device event at all (it has returned such a window
    on an H100 for calls that launch) is profiled again, up to ``tries``
    windows; 0.0 if none holds one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    total = 0.0
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            break
    return total / 1e3 / reps


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, h in CASES:
        img = torch.randint(0, 256, (n, h, h, 3), generator=gen, device="cuda",
                            dtype=torch.uint8)
        for dt in (torch.float32, torch.bfloat16):
            line = {"case": f"{n}x{h}x{h}x3 u8->{str(dt).split('.')[-1]}",
                    "bound_ms": img.numel() * (1 + dt.itemsize) / PEAK_BYTES * 1e3}
            for who, fn in (("kernel", lambda: normalize_images(img, dt)),
                            ("library", lambda: img.to(dt).mul_(1 / 255))):
                line[f"{who}_events_ms"] = _events_ms(fn)
                line[f"{who}_host_ms"] = host_ms(fn)
                line[f"{who}_device_ms"] = device_ms(fn)
            line["gpu"] = smi
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
