"""Time ``unet_vgg``'s serving on one CUDA card: the batched serving step at
8 × 512² (a seeded uint8 batch on the device) and the single-image API at
512² (``get_FPS`` on a seeded 300×200 image, crop and argmax on the device):

    python -m tpu_unet_torch.tools.bench_serving

One JSON line per case: ms per step by CUDA events (median of 5 rounds of
20 steps after warm-up), the host's ms to enqueue one step (the host clock
over 20 steps not waited for: what the Python around the kernels costs)
and, for the single image, the seconds per image of ``get_FPS``; the
timers are ``tools/bench_launch.py``'s.  Run from a checkout's root (or
with ``PYTHONPATH`` at it) it times that checkout's ``tpu_unet_torch``, so
two trees are compared in one call by running it in each, in turns.
Every line carries the card's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess

import numpy as np
import torch

from tpu_unet_torch.tools.bench_launch import ROUNDS, events_rounds, host_ms

REPS = 20


def main() -> int:
    from PIL import Image

    import tpu_unet_torch
    from tpu_unet_torch.infer.wrapper import Unet

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    tree = str(tpu_unet_torch.__file__)
    u = Unet(model="unet_vgg", num_classes=21, input_shape=[512, 512])
    fn, net = u.serving_step()
    gen = torch.Generator(device="cuda").manual_seed(1)
    imgs = torch.randint(0, 256, (8, 512, 512, 3), generator=gen, device="cuda",
                         dtype=torch.uint8)
    step = lambda: fn(net, imgs)  # noqa: E731
    ev = events_rounds(step, REPS, warm=5)
    print(json.dumps({"case": "unet_vgg serving 8x512^2", "events_ms": statistics.median(ev),
                      "events_ms_rounds": ev, "host_enqueue_ms": host_ms(step, REPS),
                      "img_per_s": 8e3 / statistics.median(ev), "tree": tree, "gpu": smi}),
          flush=True)

    image = Image.fromarray(np.random.default_rng(5).integers(0, 256, (200, 300, 3),
                                                               dtype=np.uint8))
    x, nw, nh, _ = u._letterbox(image)
    once = lambda: u._mask_for(x, nh, nw)  # noqa: E731
    ev = events_rounds(once, REPS, warm=5)
    fps = [u.get_FPS(image, REPS) for _ in range(ROUNDS)]
    print(json.dumps({"case": "unet_vgg single image 512^2 (device mask)",
                      "events_ms": statistics.median(ev), "events_ms_rounds": ev,
                      "get_FPS_s": statistics.median(fps), "get_FPS_s_rounds": fps,
                      "tree": tree, "gpu": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
