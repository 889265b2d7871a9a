#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final result line):

0. device: the card's name and power limit (nvidia-smi);
1. build: compile ``tpu_unet_torch/csrc/*.cu`` into ``build/`` with nvcc;
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card at the shapes its serving or training path gives it (the loss
   kernels at the DataB presets' 32x256^2x4 and at 8x512^2x21) — ``unet_vgg``,
   ``unet_resnet50`` and ``self_net`` at 512x512, batch 8 (the self_net
   head at batch 2; the stem also at one 512x512 image of the normalize
   kernel's bf16 output, as the single-image forward gives it), the
   TraditionalUnet tails at 256x256 (F = 32 and 22, also F = 32 at 21
   classes) and 200x200, batch 32, the normalize kernel at one image and at 32 (with the host
   time per call and the profiler's device time of the kernel and of the
   library's two ops beside the events time), the argmax-mask
   kernel at its three generic serving shapes (ties and NaNs included) and
   the palette kernel at 8 frames of 256x256 (also against the host
   render), the decoder stage's forward (#1: the upsample kernel, bit-exact
   against the plain bf16 upsample, and conv1 over [skip | up] and conv2 on
   the Hopper conv core) at the four unet_vgg and the four unet_resnet50
   stages, with a single-tile float64 witness of conv1 and of dk1, the
   whole decoder-stage backward (#13's dgrads, the weight gradients on the
   Hopper GEMM, the upsample's adjoint; a planted dropped split read
   against the weight-gradient bounds) at the same eight stages, the
   up_conv head's forward (#10: the upsample kernel, then conv1 over up
   and conv2 on the Hopper conv core) and backward (#12) at both heads'
   shapes (batch 8; a planted dropped split as well), and the training
   encoder (the block forwards keeping their intermediates, the stem's and
   the blocks' backwards; the stem's conv1_2 and blocks 2-5 on the Hopper
   conv core and weight-gradient GEMM, a planted dropped split of the GEMM
   as well) at its five stages, bit-identical on a second launch — error,
   kernel time,
   plain time, library time, bound and the share of the bound; and the
   pack kernel (the conv core's weight operand, forward and dgrad layouts)
   at every weight shape the ported models pack, bf16 and float32,
   bit-equal to the eager plain pack and on a relaunch, with its time and
   its bytes bound;
3. serving: ``tpu_unet_torch.infer.wrapper.Unet(model=..., num_classes=...,
   input_shape=...).serving_step()`` for ``unet_vgg``, ``unet_resnet50``
   and ``self_net`` (21 classes, a seeded uint8 batch of 8 at 512x512),
   ``traditional`` and ``traditional22`` (the DataB competition path: 4
   classes, batch 32 at 256x256), ``traditional`` at 200x200 (the
   mask-only tail), and the generic step of ``ultralight_large_optimized``
   (the DataB submission model), ``lightweight``, ``ultralight``,
   ``ultralight_large``, ``ultralight44`` and the last eight registry
   models (``sk_ultralight``, ``repvgg_segnet``, ``improved_ultralight``,
   ``hybrid_efficientseg``, ``balancedseg``, ``balancedseg_fpn``,
   ``balancedseg_fpn_sup``, ``balancedseg_crfs``: one #6 a step) at
   256x256 / batch 32 / 4 classes — launch counts (set to 0 just before the counted step,
   read just after), img/s, peak memory, a ``torch.profiler`` breakdown
   (with the in-step device time of the tail or argmax-mask kernel),
   masks against the plain versions on the card, and a small batch against
   the CPU float32 path;
4. single image: ``detect_image`` (mix_type 0/1/2, ``count``, ``fast``),
   ``get_miou_png`` and ``get_FPS`` (both protocols) of ``traditional`` and
   ``balancedseg_fpn_sup`` at 256x256 and ``unet_vgg`` at 512x512 on a
   seeded 300x200 PIL image —
   launches of each counted forward, the device mask against the argmax of
   the probabilities and against the CPU float32 path on the same weights
   and letterboxed image, seconds and FPS at batch 1;
5. tools, on seeded files in a temporary directory: ``predict_dir_batched``
   (``traditional``, 40 JPEG/PNG images of mixed sizes, batch 32) against
   ``batch_infer`` on PIL-letterboxed copies, with images per second and
   the loader route; ``predict_video_batched`` (``ultralight_large_optimized``,
   a 20-frame 256x256 MJPG clip, batch 8, the palette kernel on the card,
   its three launches' device time read by the profiler on a second run);
   ``evaluate`` over 8 images against the CPU float32 path; the ``predict``
   and ``miou`` CLI subcommands in the process;
5b. the rest of the CLI and tools: ``cli summary --model unet_vgg --size
   512`` (JAX's parameter count); ``cli export --preset voc_vgg`` of
   ``unet_vgg`` and of ``self_net`` at 512² on the card, each program's
   graph (the kernels' operators, no convolution of aten), loaded back and
   run on a seeded float32 image: its launches (the float32 kernels, those
   of the live float32 forward), its probabilities bit-equal to the live
   forward's; the logits within ``kernels/tf32.py``'s conv bound (relative
   to their scale) and the probabilities within ``EXPORT_PROBS_ABS_TOL``
   of the plain float32 forward on the card; ``quantized_apply`` of ``unet_vgg`` at
   512², batch 8, against the plain float32 forward with the same
   dequantized weights, and the int8 / float32 bytes; ``export_results``
   with ``voc_vgg`` (4 classes) and ``traditional`` over four seeded
   images, ``pack_submission`` and ``check_nan_in_npy``;
6. training: (a) the ``unet_vgg`` train step (``train/step.py``) at
   512x512, batch 8, 21 classes, bf16, CE + dice, Adam, from
   ``init_model(seed=0)`` weights on seeded rectangle batches made on the
   device, under both training routes (``"paired"``, the default: the
   encoder and decoder through their training kernels, and ``"fused"``) —
   exact launch counts, step time, img/s, peak memory, a
   profiler breakdown (no ``index_add_`` on the paired route), loss and
   every gradient against a plain step composed here; then, on the default
   route, one 128^2 step against the CPU float32 path and the loss over 20
   steps on one batch; (b) ``cli.main(["train", "--preset", "train_py", ...])``
   over a seeded VOC-layout directory (64 + 16 images at 256^2, batch 32,
   2 epochs), a full-state resume for a third epoch, and
   ``serving_step()`` from the trained ``.pth``; (c) the DataB train steps
   of ``traditional`` and ``ultralight_large_optimized`` (its bridge
   dropout live) at 256^2, batch 32, 4 classes, bf16, focal + dice with
   the presets' class weights, Adam at the learning rate ``fit`` gives the
   presets — exact launch counts (the logit-level loss kernels #25 / #26
   once each), step time, img/s, peak memory, a profiler breakdown, loss,
   every gradient and the running statistics against a plain step on the
   card with the same dropout generator, one 64^2 step against the CPU
   float32 path, 20 steps on one batch — and one ``lightweight`` step (the
   plain losses, no kernel); (d) ``cli train --preset traditional`` over
   a seeded VOC-layout directory with the heavy augmentation (2 epochs of
   2 steps, evaluation each epoch), a resume, and ``serving_step()``
   through the natural-layout tail from the trained ``.pth``; (e) the
   ``unet_resnet50`` step (the ``voc_resnet50`` recipe: 512x512, batch 8,
   21 classes, bf16, CE + dice, Adam 1e-4; its decoder stages and up_conv
   head through their kernels, the loss through #27 / #29, ResNet50 on
   cuDNN with batch norm on the batch statistics) — exact launch counts,
   time, img/s, peak memory, profile (no ``index_add_``), loss, every
   gradient and the running statistics against ``plain_step`` — then one
   step of the freeze phase, one at the preset's batch 16, a 128^2 step
   against the CPU float32 path and 20 learning steps; (f) the ``self_net``
   step at 512x512, batch 8 (unet_vgg's training kernels, the head, the
   plain losses on its 2x logits) held the same way; (g) ``fit`` with the
   ``voc_resnet50`` preset (no ImageNet file) over a seeded VOC-layout
   directory at 256^2: one frozen and one unfrozen epoch, a resume, and
   serving from the trained ``.pth``; (h) the bf16 step of each of the
   last eight registry models at 256^2, 4 classes, the preset's batch
   (``unfreeze_batch_size``) and recipe where the JAX package has one
   (``hybrid_efficientseg``, ``balancedseg_fpn`` at batch 96,
   ``balancedseg_crfs``, ``balancedseg_fpn_sup`` with its aux weights),
   else the ladder presets' (batch 32, focal + dice) — exact launches
   (#25 / #26 once a head: four each for ``balancedseg_fpn_sup``), loss,
   every gradient the loss reaches and the running statistics against a
   plain step with the same dropout generator, step time, img/s, peak
   memory, device time and idle share; (i) ``repvgg_segnet`` folded by
   ``cli fold`` and served in its deploy form against the training form;
7. the float32 path (``fp16=False``, the default: every model's float32
   training): the float32 instantiations of the conv core, the
   weight-gradient GEMM, the image GEMMs and the elementwise passes at the
   training encoder's five stages, the four unet_vgg and the four
   unet_resnet50 decoder stages and both up_conv heads (#10 / #11 and #12;
   512², batch 8), and #27 / #29 in float32 at 21 and 2 classes, each against its
   plain float32 version (TF32 off) within the bounds of
   ``tpu_unet_torch/kernels/tf32.py``, bit-identical on a second launch,
   a planted dropped split of the float32 GEMM read above its bounds, the
   first tile of each product against a float64 TF32 emulation under
   either operand rule (which one the card applied), timed against its
   plain version and cuDNN's float32 with TF32 on, bound at the TF32 peak;
   the float32 ``"paired"`` and ``"fused"`` steps against a plain float32
   step, closer to it than the bf16 step on the same weights and batch in
   the loss and every gradient, with exact launches, times, idle share
   and peak memory beside the bf16 step's (times under PyTorch's default
   TF32 switches); the same for the ``"paired"`` steps of
   ``unet_resnet50`` and ``self_net`` (CE + dice, the running statistics
   too) and the DataB steps of ``traditional`` and
   ``ultralight_large_optimized`` and the deep-supervision step of
   ``balancedseg_fpn_sup`` (four heads, #25 / #26 four times each); the
   preset's batch 2; a 128²
   step against the CPU float32 path; 20 learning steps; ``cli train
   --preset voc --no-pretrained`` (one frozen and one unfrozen epoch at
   512², batch 2), a resume, serving from the trained ``.pth``, and
   ``--preset medical`` for one epoch;
8. one ``{"kernels": [...]}`` line (the float32 instantiations under their
   ``_f32`` keys beside the bf16 ones), then the card line, then
   ``{"ok": true, "device": {...}}`` last.

Imports nothing of JAX or of the ``tpu_unet`` package.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
BATCH, SIZE = 8, 512              # the canonical UNets' serving shape
DATAB_BATCH, DATAB_SIZE = 32, 256  # the TraditionalUnet family's (DataB)
# classes of each model: VOC's 21, DataB's 4 (Background / Inclusions /
# Patches / Scratches)
# the last eight registry models: their own blocks on cuDNN (as XLA runs
# them in JAX), serving through #6, training through #25 / #26 once a head
ZOO = ("sk_ultralight", "repvgg_segnet", "improved_ultralight", "hybrid_efficientseg",
       "balancedseg", "balancedseg_fpn", "balancedseg_fpn_sup", "balancedseg_crfs")
CLASSES = {"unet_vgg": 21, "unet_resnet50": 21, "self_net": 21,
           "traditional": 4, "traditional22": 4, "ultralight": 4,
           "ultralight_large": 4, "ultralight_large_optimized": 4,
           "ultralight44": 4, "lightweight": 4, **dict.fromkeys(ZOO, 4)}
# the models whose serving step is the generic one with no kernel before
# the argmax-mask kernel (self_net runs the VGG kernels first)
GENERIC = ("ultralight", "ultralight_large", "ultralight_large_optimized",
           "ultralight44", "lightweight", *ZOO)
PEAK_BF16 = 989e12     # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
PEAK_TF32 = 494.7e12   # H100 SXM dense TF32 tensor-core FLOP/s (data sheet)
PEAK_F32 = 67e12       # H100 SXM float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
# conv outputs: bf16 storage with float32 sums taken in another order than
# cuDNN's — a few bf16 ulps (2^-8 relative each) after a 2-3 conv chain
CONV_REL_TOL = 2e-2
# tail masks must be identical wherever the plain top-1/top-2 logit gap
# exceeds this share of the logit scale (the f32 dot products differ only
# in summation order, ~1e-6 relative)
TAIL_MARGIN = 1e-3
# serving masks: 20-70 bf16 layers of kernel vs cuDNN summation order move
# the logits by ~1% of their scale; flips are allowed only inside that
# margin, and in at most 1% of the pixels overall.  The same limits hold
# the 256px batch and the single image against the CPU float32 path for
# every model: the bf16
# rounding of ResNet50's batch norms and of self_net's logits adds to the
# drift, yet the largest flip measured on an H100 is 0.6% of the scale
SERVE_MARGIN = 5e-2
SERVE_MISMATCH = 1e-2
WARM, REPS = 2, 10
# cuDNN's and cuBLAS's TF32 switches as PyTorch sets them in a fresh process
# (read before main() turns both off for the checks)
TF32_DEFAULT = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

failures: list[str] = []


def check(ok: bool, what: str) -> bool:
    if not ok:
        failures.append(what)
        print(f"FAIL: {what}", flush=True)
    return ok


def time_ms(fn, reps: int = REPS) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16):
    t_ops, t_mem = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def conv_flops(b, h, w, cin, f, taps=9):
    return 2.0 * b * h * w * taps * cin * f


def rel_err(out, ref):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def cl(x):
    """NHWC tensor → channels-last NCHW view (for the cuDNN chain)."""
    return x.permute(0, 3, 1, 2)


def cudnn_chain(x, ws, bs, pool):
    y = cl(x)
    for w, b in zip(ws, bs):
        y = torch.relu(F.conv2d(y, w, b, padding=1))
    return (y, F.max_pool2d(y, 2)) if pool else y


def record_case(results, card, kernel, case, outs, refs, fn, plain_fn, lib_fn, flops, nb,
                peak=PEAK_BF16, extra=None, reps=REPS):
    """Time one case of ``kernel`` against its plain version (and the
    library yardstick) over ``reps`` calls each, print its JSON line (with
    ``extra``'s keys) and add it to ``results``; returns the largest error
    relative to the reference's scale."""
    errs = [rel_err(o, r) for o, r in zip(outs, refs)]
    err = max(e[0] for e in errs)
    rel = max(e[1] for e in errs)
    ms, plain_ms = time_ms(fn, reps), time_ms(plain_fn, reps)
    lib_ms = time_ms(lib_fn, reps) if lib_fn is not None else None
    b_ms, b_by = bound(flops, nb, peak)
    line = {"kernel": kernel, "case": case, "max_abs_err": err,
            "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / ms, **(extra or {}), "gpu": card}
    print(json.dumps(line), flush=True)
    r = results.setdefault(kernel, {"max_abs_err": 0.0, "rel_err": 0.0,
                                    "ms": 0.0, "plain_ms": 0.0,
                                    "library_ms": 0.0, "bound_ms": 0.0,
                                    "flops": 0.0, "bytes": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["rel_err"] = max(r["rel_err"], rel)
    for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                 ("flops", flops), ("bytes", nb)):
        r[k] += v
    r["library_ms"] = None if lib_ms is None or r["library_ms"] is None \
        else r["library_ms"] + lib_ms
    r["peak"] = peak
    return rel


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    name = torch.cuda.get_device_name(0)
    print(f"phase 0: device {name}; nvidia-smi: {line}", flush=True)
    return line


def phase_build():
    from tpu_unet_torch.kernels import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    print(f"phase 1: built {so.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("registers", "spill", "error", "Performance Loss")):
            print("  ptxas:", line.strip())


def phase_kernels(card: str):
    from tpu_unet_torch.infer.wrapper import VOC_COLORS
    from tpu_unet_torch.kernels.decoder_fuse import unetup, unetup_plain
    from tpu_unet_torch.kernels.decoder_train import up2x
    from tpu_unet_torch.kernels.encoder import vgg_block, vgg_block_plain
    from tpu_unet_torch.kernels.postprocess import (argmax_mask, argmax_mask_plain,
                                                    final_argmax,
                                                    final_argmax_hist,
                                                    final_argmax_hist_plain,
                                                    final_argmax_plain)
    from tpu_unet_torch.kernels.preprocess import (normalize_images,
                                                   normalize_images_plain)
    from tpu_unet_torch.kernels.render import mask_palette, mask_palette_plain, palette_tensor
    from tpu_unet_torch.kernels.stem import vgg_stem, vgg_stem_plain
    from tpu_unet_torch.kernels.upconv import upconv, upconv_plain
    from tpu_unet_torch.nn.resize import upsample2x
    from tpu_unet_torch.tools.bench_launch import device_ms, host_ms
    from tpu_unet_torch.tools.predict import render

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def act(*shape):
        return torch.relu(torch.randn(shape, generator=gen, device=dev)).to(bf)

    def conv_w(f, c):
        w = torch.randn((f, c, 3, 3), generator=gen, device=dev) / (9 * c) ** 0.5
        return w.to(bf), (0.1 * torch.randn(f, generator=gen, device=dev)).to(bf)

    B, S = BATCH, SIZE
    results = {}

    record = functools.partial(record_case, results, card)

    # stem: raw uint8 image → skip + pooled
    img = torch.randint(0, 256, (B, S, S, 3), generator=gen, device=dev,
                        dtype=torch.uint8)
    w11, b11 = conv_w(64, 3)
    w12, b12 = conv_w(64, 64)
    out = vgg_stem(img, w11, b11, w12, b12)
    check(all(torch.equal(a, b) for a, b in zip(out, vgg_stem(img, w11, b11, w12, b12))),
          "vgg_stem: two launches differ")
    ref = vgg_stem_plain(img, w11, b11, w12, b12)
    xn = img.to(bf) / torch.tensor(255.0, dtype=bf, device=dev)
    rel = record("vgg_stem", f"{B}x{S}x{S}x3->64", out, ref,
                 lambda: vgg_stem(img, w11, b11, w12, b12),
                 lambda: vgg_stem_plain(img, w11, b11, w12, b12),
                 lambda: cudnn_chain(xn, [w11, w12], [b11, b12], True),
                 conv_flops(B, S, S, 3, 64) + conv_flops(B, S, S, 64, 64),
                 nbytes(img, w11, b11, w12, b12, *out))
    check(rel <= CONV_REL_TOL, f"vgg_stem rel err {rel:.3g} > {CONV_REL_TOL}")
    # stem: the single-image forward's input, the normalize kernel's bf16
    # output at one 512^2 image (conv1_1's gather of a bf16 image)
    img1 = torch.randint(0, 256, (1, S, S, 3), generator=gen, device=dev, dtype=torch.uint8)
    x1 = normalize_images(img1, bf)
    out = vgg_stem(x1, w11, b11, w12, b12)
    ref = vgg_stem_plain(x1, w11, b11, w12, b12)
    rel = record("vgg_stem", f"1x{S}x{S}x3 bf16->64", out, ref,
                 lambda: vgg_stem(x1, w11, b11, w12, b12),
                 lambda: vgg_stem_plain(x1, w11, b11, w12, b12),
                 lambda: cudnn_chain(x1, [w11, w12], [b11, b12], True),
                 conv_flops(1, S, S, 3, 64) + conv_flops(1, S, S, 64, 64),
                 nbytes(x1, w11, b11, w12, b12, *out))
    check(rel <= CONV_REL_TOL, f"vgg_stem bf16 input rel err {rel:.3g} > {CONV_REL_TOL}")
    del img, img1, x1, out, ref

    # encoder blocks 2-5
    blocks = [(S // 2, [64, 128, 128], True), (S // 4, [128, 256, 256, 256], True),
              (S // 8, [256, 512, 512, 512], True), (S // 16, [512, 512, 512, 512], False)]
    for h, chans, pool in blocks:
        x = act(B, h, h, chans[0])
        wb = [conv_w(f, c) for c, f in zip(chans[:-1], chans[1:])]
        ws, bs = [w for w, _ in wb], [b for _, b in wb]
        out, again = vgg_block(x, ws, bs, pool), vgg_block(x, ws, bs, pool)
        ref = vgg_block_plain(x, ws, bs, pool)
        outs = [o for o in out if o is not None]
        refs = [r for r in ref if r is not None]
        check(all(torch.equal(a, b) for a, b in zip(outs, again)),
              f"vgg_block {chans}: two launches differ")
        flops = sum(conv_flops(B, h, h, c, f) for c, f in zip(chans[:-1], chans[1:]))
        rel = record("vgg_block", f"{B}x{h}x{h} {chans} pool={pool}", outs, refs,
                     lambda: vgg_block(x, ws, bs, pool),
                     lambda: vgg_block_plain(x, ws, bs, pool),
                     lambda: cudnn_chain(x, ws, bs, pool),
                     flops, nbytes(x, *ws, *bs, *outs))
        check(rel <= CONV_REL_TOL, f"vgg_block {chans} rel err {rel:.3g}")

    # decoder stages up4 … up1: (model, x H, Cs, Cx, F)
    for m, h, cs, cx, f in [("vgg", S // 16, 512, 512, 512), ("vgg", S // 8, 256, 512, 256),
                            ("vgg", S // 4, 128, 256, 128), ("vgg", S // 2, 64, 128, 64),
                            ("rn50", S // 32, 1024, 2048, 512), ("rn50", S // 16, 512, 512, 256),
                            ("rn50", S // 8, 256, 256, 128), ("rn50", S // 4, 64, 128, 64)]:
        skip, x = act(B, 2 * h, 2 * h, cs), act(B, h, h, cx)
        w1, b1 = conv_w(f, cs + cx)
        w2, b2 = conv_w(f, f)
        out = unetup(skip, x, w1, b1, w2, b2)
        ref = unetup_plain(skip, x, w1, b1, w2, b2)

        def lib(skip=skip, x=x, w1=w1, b1=b1, w2=w2, b2=b2):
            up = F.interpolate(cl(x), scale_factor=2, mode="bilinear",
                               align_corners=True)
            cc = torch.cat([cl(skip), up], dim=1)
            y = torch.relu(F.conv2d(cc, w1, b1, padding=1))
            return torch.relu(F.conv2d(y, w2, b2, padding=1))

        flops = conv_flops(B, 2 * h, 2 * h, cs + cx, f) + conv_flops(B, 2 * h, 2 * h, f, f)
        rel = record("unetup", f"{m} up x{h} Cs={cs} Cx={cx} F={f}", [out], [ref],
                     lambda: unetup(skip, x, w1, b1, w2, b2),
                     lambda: unetup_plain(skip, x, w1, b1, w2, b2), lib,
                     flops, nbytes(skip, x, w1, b1, w2, b2, out))
        check(rel <= CONV_REL_TOL, f"unetup {m} F={f} rel err {rel:.3g}")
        # the stage's upsample pass alone: bit-exact against the plain bf16
        # upsample; the yardstick is F.interpolate (another rounding)
        up, uref = up2x(x), upsample2x(x)
        case = f"{m} {B}x{h}x{h}x{cx}->{2 * h}^2"
        check(bool(torch.equal(up, uref)), f"upsample2x {case}: not bit-exact")
        record("upsample2x", case, [up], [uref], lambda: up2x(x), lambda: upsample2x(x),
               lambda: F.interpolate(cl(x), scale_factor=2, mode="bilinear", align_corners=True),
               9.0 * up.numel(), nbytes(x, up), peak=PEAK_F32)
        del skip, x, out, ref, up, uref
    stage_single_tile_float64(gen)

    # up_conv head: unet_resnet50's (x 256^2) and self_net's (x 512^2, at
    # batch 2 to bound the plain version's time and memory)
    for b, h in [(B, S // 2), (2, S)]:
        x = act(b, h, h, 64)
        w1, b1 = conv_w(64, 64)
        w2, b2 = conv_w(64, 64)
        out, again = upconv(x, w1, b1, w2, b2), upconv(x, w1, b1, w2, b2)
        check(bool(torch.equal(out, again)), f"upconv {b}x{h}^2: two launches differ")
        ref = upconv_plain(x, w1, b1, w2, b2)

        def lib(x=x, w1=w1, b1=b1, w2=w2, b2=b2):
            up = F.interpolate(cl(x), scale_factor=2, mode="bilinear",
                               align_corners=True)
            y = torch.relu(F.conv2d(up, w1, b1, padding=1))
            return torch.relu(F.conv2d(y, w2, b2, padding=1))

        flops = 2 * conv_flops(b, 2 * h, 2 * h, 64, 64)
        rel = record("upconv", f"{b}x{h}x{h}x64->{2 * h}^2x64", [out], [ref],
                     lambda: upconv(x, w1, b1, w2, b2),
                     lambda: upconv_plain(x, w1, b1, w2, b2), lib,
                     flops, nbytes(x, w1, b1, w2, b2, out))
        check(rel <= CONV_REL_TOL, f"upconv {b}x{h}^2 rel err {rel:.3g}")
        del x, out, again, ref
    # the self_net head's kernel and cuDNN's chain at the serving batch (no
    # plain version: it is timed at batch 2 above)
    x = act(B, S, S, 64)
    head_ms = time_ms(lambda: upconv(x, w1, b1, w2, b2))
    lib_ms = time_ms(lambda: lib(x, w1, b1, w2, b2))
    print(json.dumps({"kernel": "upconv", "case": f"{B}x{S}x{S}x64->{2 * S}^2x64",
                      "ms": head_ms, "library_ms": lib_ms, "gpu": card}), flush=True)
    del x

    def tail(kernel, n, h, w, f, c, hist, into=None):
        """A serving tail (final 1x1 conv + argmax, with or without the
        histogram) against its plain version: masks identical wherever the
        plain top-1/top-2 gap exceeds TAIL_MARGIN of the logit scale, hist
        = bincount of the kernel's own masks, a second launch bit-identical.
        Its error is the largest per-class count difference against plain
        (hist), or the largest class-index difference (mask only).  Every
        width runs its products on the tensor cores, as the TPU kernel
        does (its bound at the bf16 peak: the bytes).  ``into``: the
        results it is summed into (the kernel's line by default)."""
        feats = act(n, h, w, f)
        wf = (torch.randn((c, f, 1, 1), generator=gen, device=dev) / f ** 0.5).to(bf)
        bfin = (0.1 * torch.randn(c, generator=gen, device=dev)).to(bf)
        fn, plain_fn = (final_argmax_hist, final_argmax_hist_plain) if hist \
            else (final_argmax, final_argmax_plain)
        out, ref = fn(feats, wf, bfin, c), plain_fn(feats, wf, bfin, c)
        again = fn(feats, wf, bfin, c)
        masks, pm = (out[0], ref[0]) if hist else (out, ref)
        logits = feats.reshape(-1, f).float() @ wf.reshape(c, f).float().t() + bfin.float()
        top2 = logits.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).reshape(masks.shape)
        differ = masks != pm
        flips_outside = int((differ & (gap > TAIL_MARGIN * logits.abs().max())).sum())
        case = f"{n}x{h}x{w}x{f}->{c}"
        check(flips_outside == 0, f"{kernel} {case}: {flips_outside} mask flips outside the margin")
        check(all(torch.equal(a, b) for a, b in zip(out, again)) if hist
              else torch.equal(out, again), f"{kernel} {case}: two launches differ")
        if hist:
            own_hist = torch.stack([torch.bincount(m.flatten().long(), minlength=c)
                                    for m in masks]).to(torch.int32)
            check(bool(torch.equal(own_hist, out[1])), f"{kernel} {case}: hist != bincount(own mask)")
            check(bool(differ.any() or torch.equal(out[1], ref[1])),
                  f"{kernel} {case}: masks equal plain's but hist does not")
        print(json.dumps({"kernel": kernel, "case": case,
                          "mask_mismatch": differ.float().mean().item(),
                          "flips_outside_margin": flips_outside}), flush=True)
        del logits, top2, gap, differ
        w2 = wf.reshape(c, f)

        def lib():  # cuBLAS bf16 logits, argmax (+ one offset bincount)
            cls = F.linear(feats, w2, bfin).argmax(-1)
            if not hist:
                return cls
            offs = torch.arange(n, device=dev).reshape(n, 1, 1) * c
            return torch.bincount((cls + offs).reshape(-1), minlength=n * c)

        record_case(results if into is None else into, card, kernel, case,
                    [out[1].float()] if hist else [masks.float()],
                    [ref[1].float()] if hist else [pm.float()],
                    lambda: fn(feats, wf, bfin, c), lambda: plain_fn(feats, wf, bfin, c), lib,
                    2.0 * n * h * w * f * c, nbytes(feats, wf, bfin, *(out if hist else [out])))
        del feats, out, ref, again

    # tails: the canonical UNets' (F = 64, 21 classes); the TraditionalUnet
    # family's at DataB's 256x256 / batch 32 / 4 classes (F = 32 and 22),
    # and at 21 classes (F = 32), which the wrapper allows; the mask-only
    # tail at 200x200, whose 40,000 pixels an image the JAX tail's
    # 1024-row block does not divide
    tail("final_argmax_hist", B, S, S, 64, CLASSES["unet_vgg"], True)
    c4 = CLASSES["traditional"]
    for f in (32, 22):
        tail("final_argmax_hist_natural", DATAB_BATCH, DATAB_SIZE, DATAB_SIZE, f, c4, True)
    tail("final_argmax_hist_natural", DATAB_BATCH, DATAB_SIZE, DATAB_SIZE, 32, 21, True)
    tail("final_argmax", DATAB_BATCH, 200, 200, 32, c4, False)
    # the F = 64 mask-only tail (csrc/tail_sm90.cu), which the canonical
    # UNets take where H*W is no multiple of 256: its own line, not summed
    # into final_argmax's (the traditional tail at 200x200)
    tail("final_argmax", B, 500, 500, 64, CLASSES["unet_vgg"], False, into={})

    # normalize: the single image at each model's size, and a DataB batch;
    # bit-exact against the plain version.  Back-to-back calls of so small
    # a kernel time the host's cost per call (over 200 calls: 10 read the
    # host's noise), so each case also reads the host time per call and the
    # profiler's device time, of the kernel and of the library's two ops
    for n, h in ((1, DATAB_SIZE), (DATAB_BATCH, DATAB_SIZE), (1, S)):
        img = torch.randint(0, 256, (n, h, h, 3), generator=gen, device=dev, dtype=torch.uint8)
        for dt in (torch.float32, torch.bfloat16):
            out, ref = normalize_images(img, dt), normalize_images_plain(img, dt)
            case = f"{n}x{h}x{h}x3 u8->{str(dt).split('.')[-1]}"
            check(bool(torch.equal(out, ref)), f"normalize_images {case}: not bit-exact")
            kern, lib = (lambda: normalize_images(img, dt)), (lambda: img.to(dt).mul_(1 / 255))
            record("normalize_images", case, [out], [ref], kern,
                   lambda: normalize_images_plain(img, dt), lib, 0.0, nbytes(img, out),
                   extra={"host_ms": host_ms(kern), "device_ms": device_ms(kern),
                          "library_host_ms": host_ms(lib), "library_device_ms": device_ms(lib)},
                   reps=200)

    # argmax mask at the generic step's shapes: self_net (f32 after the
    # resize), the ladder models (bf16 logits), lightweight (f32 after the
    # resize); small-integer logits tie on most pixels, every 37th row
    # holds a NaN; exact against the plain version
    u8 = torch.uint8
    for n, h, c, dt in ((B, S, CLASSES["self_net"], torch.float32),
                        (DATAB_BATCH, DATAB_SIZE, 4, bf),
                        (DATAB_BATCH, DATAB_SIZE, 4, torch.float32)):
        x = torch.randint(-3, 4, (n, h, h, c), generator=gen, device=dev).to(dt)
        x.view(-1, c)[::37, c // 2] = float("nan")
        out, ref = argmax_mask(x, u8), argmax_mask_plain(x, u8)
        case = f"{n}x{h}x{h}x{c} {str(dt).split('.')[-1]}->uint8"
        check(bool(torch.equal(out, ref)), f"argmax_mask {case}: != plain")
        record("argmax_mask", case, [out], [ref], lambda: argmax_mask(x, u8),
               lambda: argmax_mask_plain(x, u8), lambda: torch.argmax(x, dim=-1),
               float(x.numel()), nbytes(x, out), peak=PEAK_F32)
        del x, out, ref

    # palette blend of 8 frames at 256x256 with 4-class uint8 masks: exact
    # against the plain version and the host render; no PyTorch call blends
    # a palette, so no library time
    n, h = 8, DATAB_SIZE
    pal = palette_tensor(VOC_COLORS, dev)
    mask = torch.randint(0, 4, (n, h, h), generator=gen, device=dev, dtype=u8)
    img = torch.randint(0, 256, (n, h, h, 3), generator=gen, device=dev, dtype=u8)
    out, ref = mask_palette(mask, img, pal), mask_palette_plain(mask, img, pal)
    case = f"{n}x{h}x{h} uint8 mask, {pal.shape[0]} colours"
    check(bool(torch.equal(out, ref)), f"mask_palette {case}: != plain")
    host = np.stack([render(f, m, np.asarray(VOC_COLORS, np.uint8), 0.7, (0, 0, h, h), (h, h))
                     for f, m in zip(img.cpu().numpy(), mask.cpu().numpy())])
    check(bool(np.array_equal(out.cpu().numpy(), host)), f"mask_palette {case}: != host render")
    record("mask_palette", case, [out], [ref], lambda: mask_palette(mask, img, pal),
           lambda: mask_palette_plain(mask, img, pal), None, 9.0 * mask.numel(),
           nbytes(mask, img, out), peak=PEAK_F32)
    return results


# a single-tile witness (one 8 x 16 output tile, batch 1) of the stage
# kernels against float64 on the same bf16 operands: a conv whose only
# rounding is its bf16 store (#1's y1; #13's dz1 from g2, which is exact,
# and its [dskip | dups] from the kernel's own dz1) within one bf16 ulp of
# the largest value, and the weight gradient dk1 within float32's sums over
# 128 pixels (a wrong tap, channel offset, split or mask reads O(1) there)
SINGLE_TILE_STORE_REL_TOL = 2.0 ** -8
SINGLE_TILE_DK_REL_TOL = 1e-5


def stage_single_tile_readings(gen, cs, cx, f):
    """#1's conv1 (y1), ``unetup_wgrad``'s dk1 and #13's two dgrads (dz1,
    [dskip | dups]) at one 8×16 tile with Cs, Cx and F channels, and the
    plain versions', each read against float64 from the same bf16 inputs:
    skip, up2x(x) and the weights for y1 and dk1; for #13 the forward's
    out and y1, a seeded g, and each dgrad's own bf16 input (g2, then the
    version's own dz1)."""
    from tpu_unet_torch.kernels.decoder_fuse import _unetup_cuda, _unetup_plain_y1
    from tpu_unet_torch.kernels.decoder_train import (flip_t, unetup_bwd, unetup_bwd_plain,
                                                      unetup_wgrad, unetup_wgrad_plain)
    from tpu_unet_torch.nn.resize import upsample2x

    dev, bf, f64 = torch.device("cuda"), torch.bfloat16, torch.float64
    skip = torch.relu(torch.randn((1, 8, 16, cs), generator=gen, device=dev)).to(bf)
    x = torch.relu(torch.randn((1, 4, 8, cx), generator=gen, device=dev)).to(bf)
    w1 = (torch.randn((f, cs + cx, 3, 3), generator=gen, device=dev) / (9 * (cs + cx)) ** 0.5)
    w1 = w1.to(bf)
    b1 = (0.1 * torch.randn(f, generator=gen, device=dev)).to(bf)
    w2 = (torch.randn((f, f, 3, 3), generator=gen, device=dev) / (9 * f) ** 0.5).to(bf)
    out, y1 = _unetup_cuda(skip, x, w1, b1, w2, b1, want_y1=True)
    _, py1 = _unetup_plain_y1(skip, x, w1, b1, w2, b1)
    cc = torch.cat([skip, upsample2x(x)], -1).to(f64)
    ey1 = torch.relu(F.conv2d(cl(cc), w1.to(f64), b1.to(f64), padding=1)).permute(0, 2, 3, 1)
    dz1 = torch.randn((1, 8, 16, f), generator=gen, device=dev).to(bf)
    dk1 = unetup_wgrad(skip, x, dz1, y1, dz1)[0]
    pdk1 = unetup_wgrad_plain(skip, x, dz1, y1, dz1)[0]
    edk1 = torch.ops.aten.convolution_backward(
        cl(dz1.to(f64)), cl(cc), w1.to(f64), None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [False, True, False])[1]

    def dgrad64(v, w):
        return F.conv2d(cl(v.to(f64)), flip_t(w).to(f64), padding=1).permute(0, 2, 3, 1)

    g = torch.randn((1, 8, 16, f), generator=gen, device=dev).to(bf)
    dskip, dups, g2, kdz1 = unetup_bwd(g, out, y1, w1, w2, cs)
    pskip, pups, pg2, pdz1 = unetup_bwd_plain(g, out, y1, w1, w2, cs)
    edz1 = torch.where(y1 > 0, dgrad64(g2, w2), 0)
    return {"y1": {"kernel_vs_float64": rel_err(y1, ey1)[1],
                   "plain_vs_float64": rel_err(py1, ey1)[1]},
            "dk1": {"kernel_vs_float64": rel_err(dk1, edk1)[1],
                    "plain_vs_float64": rel_err(pdk1, edk1)[1]},
            "g2_equal": bool(torch.equal(g2, pg2)),
            "dz1": {"kernel_vs_float64": rel_err(kdz1, edz1)[1],
                    "plain_vs_float64": rel_err(pdz1, edz1)[1]},
            "dskip_dups": {
                "kernel_vs_float64": rel_err(torch.cat([dskip, dups], -1), dgrad64(kdz1, w1))[1],
                "plain_vs_float64": rel_err(torch.cat([pskip, pups], -1), dgrad64(pdz1, w1))[1]}}


def stage_single_tile_float64(gen):
    """:func:`stage_single_tile_readings` at unet_vgg's up1 and up4 widths
    and unet_resnet50's up4's, printed and held to the single-tile limits,
    so that a reading at full size can be told from a fault."""
    for cs, cx, f in ((64, 128, 64), (512, 512, 512), (1024, 2048, 512)):
        r = stage_single_tile_readings(gen, cs, cx, f)
        print(json.dumps({"stage_single_tile_float64": f"1x8x16 Cs={cs} Cx={cx} F={f}",
                          "readings": r}), flush=True)
        for name in ("y1", "dz1", "dskip_dups"):
            check(r[name]["kernel_vs_float64"] <= SINGLE_TILE_STORE_REL_TOL,
                  f"stage single tile Cs={cs}: {name} {r[name]['kernel_vs_float64']:.3g} "
                  "from float64")
        check(r["g2_equal"], f"unetup_bwd single tile Cs={cs}: g2 != plain")
        check(r["dk1"]["kernel_vs_float64"] <= SINGLE_TILE_DK_REL_TOL,
              f"unetup_wgrad single tile Cs={cs}: dk1 {r['dk1']['kernel_vs_float64']:.3g} "
              "from float64")


def final_bwd_witness(card, feats, w, b, t, cw, c, dice, res, gl, out, ref, case):
    """#29's dW and db against a float64 evaluation of the same function
    (the logits rounded as both versions round them, then the residuals,
    dlog and both sums in float64): the kernel's and the plain version's
    distances to it; and a planted fault, the kernel's dW without one
    block's partial row, read against the 1e-3 bound."""
    from tpu_unet_torch.kernels import loss as L

    f2 = feats.reshape(-1, 64)
    x = L._logits(f2, w, b, c).double()
    tc = L._clamped(t, c)
    cw64 = torch.tensor(cw, dtype=torch.float64, device=x.device)
    _, _, (s_w, denom, score) = L._finish(L._sums(x, tc, cw64, c), c, dice)
    g64 = gl.double()
    a, bb = L.dice_coefs(score, denom, c, g64, dice)
    dlog = L._dlogits(x, tc, cw64, c, a, bb, L._inv(g64, s_w))
    dw64, db64 = (f2.double().t() @ dlog).t(), dlog.sum(0)
    del x, dlog
    partial = L._bwd_cuda(feats, w, b, t, cw, c, dice, res, gl)[4]
    g = partial.shape[0]
    keep = torch.arange(g, device=partial.device) != g // 2
    dropped = partial[keep].sum(0)[:64 * c].reshape(c, 64)
    line = {"witness": "final_ce_dice_bwd float64", "case": case,
            "kernel_dw_vs_f64": rel_err(out[1].reshape(c, 64), dw64)[1],
            "plain_dw_vs_f64": rel_err(ref[1].reshape(c, 64), dw64)[1],
            "kernel_db_vs_f64": rel_err(out[2], db64)[1],
            "plain_db_vs_f64": rel_err(ref[2], db64)[1],
            "blocks": g, "dropped_block_dw_vs_plain": rel_err(dropped, ref[1].reshape(c, 64))[1],
            "bound": 1e-3, "gpu": card}
    print(json.dumps(line), flush=True)
    check(line["dropped_block_dw_vs_plain"] > 1e-3,
          f"final_ce_dice_bwd {case}: a dropped block partial reads "
          f"{line['dropped_block_dw_vs_plain']:.3g}, inside the 1e-3 bound")


def phase_train_kernels(card: str, results: dict):
    """#27 / #29 and #13 against their plain versions at the shapes the two
    training recipes give them: unet_vgg at 512², batch 8, 21 classes (the
    canonical recipe; #13 at the eight decoder stages of unet_vgg and
    unet_resnet50, bit-identical on a second launch) and at 256², batch
    32, 4 classes (``train_py``; #13 at up1)."""
    from tpu_unet_torch.kernels.decoder_train import unetup_bwd, unetup_bwd_plain
    from tpu_unet_torch.kernels.loss import (final_ce_dice_bwd, final_ce_dice_bwd_plain,
                                             final_ce_dice_fwd, final_ce_dice_fwd_plain,
                                             pack_targets)

    record = functools.partial(record_case, results, card)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    for n, size, c in ((BATCH, SIZE, CLASSES["unet_vgg"]), (DATAB_BATCH, DATAB_SIZE, 4)):
        feats = torch.relu(torch.randn((n, size, size, 64), generator=gen, device=dev)).to(bf)
        # float32 weights holding bf16 values, as the step's cast gives them
        # to the loss: dW and db come back in float32, unrounded
        w = (torch.randn((c, 64, 1, 1), generator=gen, device=dev) / 8).to(bf).float()
        b = (0.1 * torch.randn(c, generator=gen, device=dev)).to(bf).float()
        t = torch.randint(0, c, (n, size, size), generator=gen, device=dev, dtype=torch.int32)
        r = torch.rand((n, size, size), generator=gen, device=dev)
        t = torch.where(r < 0.03, torch.full_like(t, c), t)      # ignore class
        t = torch.where(r > 0.98, torch.full_like(t, 255), t)    # raw VOC border
        t = pack_targets(t, c)  # one byte a pixel, as the kernels read them
        cw = tuple(1.0 + 0.1 * i for i in range(c))
        cw_t = torch.tensor(cw, device=dev)
        t_cl = torch.clamp_max(t, c).long().reshape(-1)
        f2, w2 = feats.reshape(-1, 64), w.reshape(c, 64).to(bf)
        npix = feats.numel() // 64
        gl = torch.tensor(1.0, device=dev)

        def lib_chain(f2=f2, w2=w2, b=b, c=c, t_cl=t_cl, cw_t=cw_t):
            lf = F.linear(f2, w2, b.to(bf)).float()
            ce = F.cross_entropy(lf, t_cl, weight=cw_t, ignore_index=c)
            p = torch.softmax(lf, -1)
            oh = F.one_hot(t_cl, c + 1)[:, :c].float()
            tp, ps, ts = (p * oh).sum(0), p.sum(0), oh.sum(0)
            pt = (p > 0.5).float()
            tpt, pts = (pt * oh).sum(0), pt.sum(0)
            dice = 1 - ((2 * tp + 1e-5) / (2 * tp + (ts - tp) + (ps - tp) + 1e-5)).mean()
            fs = ((2 * tpt + 1e-5) / (2 * tpt + (ts - tpt) + (pts - tpt) + 1e-5)).mean()
            return ce + dice, fs

        for dice in (True, False):
            case = f"{n}x{size}x{size}x64 bf16 -> {c} classes, dice={dice}"
            loss, fs, res = final_ce_dice_fwd(feats, w, b, t, cw, c, dice)
            ploss, pfs, pres = final_ce_dice_fwd_plain(feats, w, b, t, cw, c, dice)
            again = final_ce_dice_fwd(feats, w, b, t, cw, c, dice)
            check(bool(torch.equal(loss, again[0]) and torch.equal(fs, again[1])),
                  f"final_ce_dice_fwd {case}: two runs differ")
            lrel = abs(loss.item() - ploss.item()) / abs(ploss.item())
            check(lrel <= 1e-4, f"final_ce_dice_fwd {case}: loss rel err {lrel:.3g} > 1e-4")
            check(abs(fs.item() - pfs.item()) <= 1e-4,
                  f"final_ce_dice_fwd {case}: f_score {fs.item()} vs {pfs.item()}")
            record("final_ce_dice_fwd", case, [loss, fs], [ploss, pfs],
                   lambda: final_ce_dice_fwd(feats, w, b, t, cw, c, dice),
                   lambda: final_ce_dice_fwd_plain(feats, w, b, t, cw, c, dice),
                   lib_chain, 2.0 * npix * 64 * c, nbytes(feats, t, w, b))
            out = final_ce_dice_bwd(feats, w, b, t, cw, c, dice, res, gl)
            ref = final_ce_dice_bwd_plain(feats, w, b, t, cw, c, dice, pres, gl)
            rels = [rel_err(o, r_)[1] for o, r_ in zip(out, ref)]
            check(rels[0] <= CONV_REL_TOL, f"final_ce_dice_bwd {case}: dfeat rel err {rels[0]:.3g}")
            check(max(rels[1:]) <= 1e-3, f"final_ce_dice_bwd {case}: dW/db rel err {max(rels[1:]):.3g}")
            again_b = final_ce_dice_bwd(feats, w, b, t, cw, c, dice, res, gl)
            check(all(torch.equal(x, y) for x, y in zip(out, again_b)),
                  f"final_ce_dice_bwd {case}: two runs differ")
            del again_b
            if n == BATCH and dice:
                final_bwd_witness(card, feats, w, b, t, cw, c, dice, res, gl, out, ref, case)
            fg = f2.detach().clone().requires_grad_()
            wg, bg = w2.clone().requires_grad_(), b.to(bf).clone().requires_grad_()
            lf = F.linear(fg, wg, bg).float()
            p = torch.softmax(lf, -1)
            oh = F.one_hot(t_cl, c + 1)[:, :c].float()
            tp, ps, ts = (p * oh).sum(0), p.sum(0), oh.sum(0)
            graph = F.cross_entropy(lf, t_cl, weight=cw_t, ignore_index=c)
            if dice:
                graph = graph + 1 - ((2 * tp + 1e-5) / (2 * tp + (ts - tp) + (ps - tp) + 1e-5)).mean()
            record("final_ce_dice_bwd", case, list(out), list(ref),
                   lambda: final_ce_dice_bwd(feats, w, b, t, cw, c, dice, res, gl),
                   lambda: final_ce_dice_bwd_plain(feats, w, b, t, cw, c, dice, pres, gl),
                   lambda: torch.autograd.grad(graph, [fg, wg, bg], retain_graph=True),
                   6.0 * npix * 64 * c, nbytes(feats, t, w, b, *out))
            del out, ref, fg, wg, bg, lf, p, oh, graph
        del feats, t, r, t_cl, f2

    # #13 at the eight decoder stages (512², batch 8) and at up1 of the
    # train_py recipe (256², batch 32)
    stages = [(BATCH, 2 * h, cs, cx, f) for h, cs, cx, f in VGG_STAGES + RN50_STAGES]
    for n, size, cs, cx, f in stages + [(DATAB_BATCH, DATAB_SIZE, 64, 128, 64)]:
        g = torch.randn((n, size, size, f), generator=gen, device=dev).to(bf)
        out_ = torch.relu(torch.randn((n, size, size, f), generator=gen, device=dev)).to(bf)
        y1 = torch.relu(torch.randn((n, size, size, f), generator=gen, device=dev)).to(bf)
        w1 = torch.randn((f, cs + cx, 3, 3), generator=gen, device=dev) / (9 * (cs + cx)) ** 0.5
        w1 = w1.to(bf)
        w2 = (torch.randn((f, f, 3, 3), generator=gen, device=dev) / (9 * f) ** 0.5).to(bf)
        res, again = unetup_bwd(g, out_, y1, w1, w2, cs), unetup_bwd(g, out_, y1, w1, w2, cs)
        ref = unetup_bwd_plain(g, out_, y1, w1, w2, cs)
        case = f"{n}x{size}x{size} Cs={cs} Cx={cx} F={f}"
        check(all(torch.equal(a, b) for a, b in zip(res, again)),
              f"unetup_bwd {case}: two launches differ")
        check(bool(torch.equal(res[2], ref[2])), f"unetup_bwd {case}: g2 != plain")
        placeholder = torch.empty((n, cs + cx, size, size), dtype=bf, device=dev,
                                  memory_format=torch.channels_last)

        def lib13(g=g, out_=out_, y1=y1, w1=w1, w2=w2, placeholder=placeholder):
            cb = torch.ops.aten.convolution_backward
            g2 = torch.where(out_ > 0, g, 0)
            dz1 = cb(cl(g2), cl(y1), w2, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                     [True, False, False])[0]
            dz1 = torch.where(cl(y1) > 0, dz1, 0)
            return cb(dz1, placeholder, w1, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                      [True, False, False])[0]

        rel = record("unetup_bwd", case, [res[3], res[0], res[1]], [ref[3], ref[0], ref[1]],
                     lambda: unetup_bwd(g, out_, y1, w1, w2, cs),
                     lambda: unetup_bwd_plain(g, out_, y1, w1, w2, cs), lib13,
                     conv_flops(n, size, size, f, f) + conv_flops(n, size, size, f, cs + cx),
                     nbytes(g, out_, y1, w1, w2, *res))
        check(rel <= CONV_REL_TOL, f"unetup_bwd {case}: rel err {rel:.3g} > {CONV_REL_TOL}")
        del g, out_, y1, res, again, ref, placeholder
        torch.cuda.empty_cache()
    decoder_bwd_kernels(record, gen)
    upconv_bwd_kernels(record, gen)
    encoder_train_kernels(record, gen)
    logit_loss_kernels(record, gen)
    pack_kernels(record, gen)
    print("phase 2: training kernels done", flush=True)


# the decoder stages at 512², batch 8: (x H, Cs, Cx, F), up1 … up4, of
# unet_vgg and of unet_resnet50 (its stride-2 pyramid, the head after up1)
VGG_STAGES = ((SIZE // 2, 64, 128, 64), (SIZE // 4, 128, 256, 128),
              (SIZE // 8, 256, 512, 256), (SIZE // 16, 512, 512, 512))
RN50_STAGES = ((SIZE // 4, 64, 128, 64), (SIZE // 8, 256, 256, 128),
               (SIZE // 16, 512, 512, 256), (SIZE // 32, 1024, 2048, 512))
# weight / bias gradients, relative to max |plain|: float32 sums of the same
# bf16 products in another order (the kernel's split-K runs vs cuDNN's) over
# up to 2.1M pixels.  The sound readings on an H100 (700 W) are at most
# 1.49e-4 (up1's dk1) for the GEMM alone;
# through a whole stage backward the inputs of all but the last conv's
# gradient also carry the kernel dgrads' bf16 rounding (2.15e-4 at up4's
# dk1; 7.1e-4 at block 5's first conv, behind two kernel dgrads).  A
# dropped split-K partial — the fault these bounds must catch — reads
# 8.7e-2 at up1's dk2 (one split of 118) on an H100, and is planted and read
# in every run (sm90_wgrad_fault_reading).  The bounds sit between the two.
WGRAD_REL_TOL = 5e-4
WGRAD_CHAIN_REL_TOL = 1e-3
# the upsample's adjoint: float32 sums of the same products rounded once to
# bf16 (one ulp, 2^-8 of an element) relative to max |plain|
ADJOINT_REL_TOL = 1e-2


def _fault_check(kernel, case, ns, fault):
    print(json.dumps({"wgrad_planted_fault": f"{kernel} {case}", "dropped_split_of": ns,
                      "rel_err": fault, "bounds": [WGRAD_REL_TOL, WGRAD_CHAIN_REL_TOL]}),
          flush=True)
    check(fault > max(WGRAD_REL_TOL, WGRAD_CHAIN_REL_TOL),
          f"{kernel} {case}: a dropped split reads {fault:.3g}, inside the bounds")


def first_split_mask(B, H, W, ns, scale=1):
    """(B, H / scale, W / scale) bool: the pixels of the first of ``ns``
    splits of the Hopper weight-gradient GEMM's 8×16 pixel patches (in
    (b, row, column) order, ``kernels/sm90.py::split_ranges``), on an
    image ``scale`` times smaller (the pool's)."""
    from tpu_unet_torch.kernels.sm90 import PATCH_H, PATCH_W, split_ranges

    th, tw = H // PATCH_H, W // PATCH_W
    lost = torch.zeros(B * th * tw, dtype=torch.bool, device="cuda")
    lost[:split_ranges(B * th * tw, ns)[0][1]] = True
    lost = lost.view(B, th, tw)
    return lost.repeat_interleave(PATCH_H // scale, 1).repeat_interleave(PATCH_W // scale, 2)


def sm90_wgrad_fault_reading(key, case, ns, dskip, dpool, run, refs):
    """Plant a dropped split in the Hopper weight-gradient GEMM
    (``csrc/wgrad_sm90.cuh``) of a block's last conv, of a decoder stage's
    dk2 (``dskip`` = g2, no ``dpool``) or of the up_conv head's dk2
    (``dskip`` = g, whose ReLU mask gives g2), and read it as the checks
    read the kernel: zeroing the skip's and the pool's gradients over the
    first split's patches zeroes the GEMM's G operand there, which is what
    losing that split's partial computes; ``run(dskip, dpool)`` returns the
    (dk, db) the kernel then computes, ``refs`` the plain version's on the
    sound gradients."""
    B, H, W, _ = dskip.shape
    faulty = dskip.masked_fill(first_split_mask(B, H, W, ns)[..., None], 0)
    fpool = None if dpool is None else \
        dpool.masked_fill(first_split_mask(B, H, W, ns, 2)[..., None], 0)
    _fault_check(key, case, ns, max(rel_err(a, b)[1] for a, b in zip(run(faulty, fpool), refs)))


def decoder_bwd_kernels(record, gen):
    """The port of #14-#19 at the four unet_vgg and the four unet_resnet50
    decoder stages (512², batch 8):
    ``unetup_bwd_full`` against ``unetup_bwd_full_plain`` (dskip / dx within
    CONV_REL_TOL, the weight and bias gradients within WGRAD_CHAIN_REL_TOL,
    all six bit-identical on a second launch), against the cuDNN chain
    (``convolution_backward`` with the data, weight and bias outputs of both
    convs, and autograd of ``upsample2x``); then ``unetup_wgrad`` and
    ``upsample_adjoint`` each against its plain version on the same inputs
    (the adjoint bit-identical on a second launch, its launch plan the
    host's), the adjoint also at both heads' shapes."""
    from tpu_unet_torch.kernels.decoder_train import (unetup_bwd_full, unetup_bwd_full_plain,
                                                      unetup_bwd_plain, unetup_wgrad,
                                                      unetup_wgrad_plain, wgrad_plan)
    from tpu_unet_torch.nn.resize import upsample2x

    dev, bf, B = torch.device("cuda"), torch.bfloat16, BATCH
    cb = torch.ops.aten.convolution_backward
    for h, cs, cx, f in VGG_STAGES + RN50_STAGES:
        h2, cp = 2 * h, cs + cx
        skip = torch.relu(torch.randn((B, h2, h2, cs), generator=gen, device=dev)).to(bf)
        x = torch.relu(torch.randn((B, h, h, cx), generator=gen, device=dev)).to(bf)
        g = torch.randn((B, h2, h2, f), generator=gen, device=dev).to(bf)
        out_ = torch.relu(torch.randn((B, h2, h2, f), generator=gen, device=dev)).to(bf)
        y1 = torch.relu(torch.randn((B, h2, h2, f), generator=gen, device=dev)).to(bf)
        w1 = (torch.randn((f, cp, 3, 3), generator=gen, device=dev) / (9 * cp) ** 0.5).to(bf)
        w2 = (torch.randn((f, f, 3, 3), generator=gen, device=dev) / (9 * f) ** 0.5).to(bf)
        args = (g, out_, y1, skip, x, w1, w2)
        case = f"{B}x{h2}x{h2} Cs={cs} Cx={cx} F={f}"
        res, again = unetup_bwd_full(*args), unetup_bwd_full(*args)
        check(all(torch.equal(a, b) for a, b in zip(res, again)),
              f"unetup_bwd_full {case}: two launches differ")
        ref = unetup_bwd_full_plain(*args)
        errs = {n: rel_err(a, b)[1] for n, a, b in
                zip(("dskip", "dx", "dk1", "db1", "dk2", "db2"), res, ref)}
        for n, e in errs.items():
            tol = CONV_REL_TOL if n in ("dskip", "dx") else WGRAD_CHAIN_REL_TOL
            check(e <= tol, f"unetup_bwd_full {case}: {n} rel err {e:.3g} > {tol}")
        print(json.dumps({"unetup_bwd_full": case, "rel_err_by_output": errs}), flush=True)

        def lib(g=g, out_=out_, y1=y1, skip=skip, x=x, w1=w1, w2=w2, cs=cs, f=f):
            g2 = torch.where(out_ > 0, g, 0)
            dy1, dk2, db2 = cb(cl(g2), cl(y1), w2, [f], [1, 1], [1, 1], [1, 1], False, [0, 0],
                               1, [True, True, True])
            dz1 = torch.where(cl(y1) > 0, dy1, 0)
            with torch.enable_grad():
                xg = x.detach().requires_grad_()
                up = upsample2x(xg)
            cc = torch.cat([cl(skip), cl(up.detach())], dim=1)
            dcc, dk1, db1 = cb(dz1, cc, w1, [f], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                               [True, True, True])
            dx, = torch.autograd.grad(up, xg, dcc[:, cs:].permute(0, 2, 3, 1))
            return dcc[:, :cs], dx, dk1, db1, dk2, db2

        n_pix = B * h2 * h2
        dflops = conv_flops(B, h2, h2, f, f) + conv_flops(B, h2, h2, f, cp)
        record("unetup_bwd_full", case, list(res), list(ref), lambda: unetup_bwd_full(*args),
               lambda: unetup_bwd_full_plain(*args), lib, 2 * dflops,
               nbytes(*args, *res))
        # the two new kernels alone, on the plain chain's dz1 / g2 / dups
        _, dups, g2, dz1 = unetup_bwd_plain(g, out_, y1, w1, w2, cs)
        wres, wref = unetup_wgrad(skip, x, dz1, y1, g2), unetup_wgrad_plain(skip, x, dz1, y1, g2)
        check(all(torch.equal(a, b) for a, b in zip(wres, unetup_wgrad(skip, x, dz1, y1, g2))),
              f"unetup_wgrad {case}: two launches differ")

        def lib_w(skip=skip, x=x, dz1=dz1, y1=y1, g2=g2, w1=w1, w2=w2, f=f):
            up = upsample2x(x)
            cc = torch.cat([cl(skip), cl(up)], dim=1)
            _, dk1, db1 = cb(cl(dz1), cc, w1, [f], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                             [False, True, True])
            _, dk2, db2 = cb(cl(g2), cl(y1), w2, [f], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                             [False, True, True])
            return dk1, db1, dk2, db2

        rel = record("unetup_wgrad", case, list(wres), list(wref),
                     lambda: unetup_wgrad(skip, x, dz1, y1, g2),
                     lambda: unetup_wgrad_plain(skip, x, dz1, y1, g2), lib_w,
                     conv_flops(B, h2, h2, cp, f) + conv_flops(B, h2, h2, f, f),
                     nbytes(skip, x, dz1, y1, g2, *wres))
        check(rel <= WGRAD_REL_TOL, f"unetup_wgrad {case}: rel err {rel:.3g} > {WGRAD_REL_TOL}")
        if f == 64:
            ns = wgrad_plan(B, h2, h2, cs, cx, f)[1][2]
            sm90_wgrad_fault_reading("unetup_wgrad", case, ns, g2, None,
                                     lambda t, _: unetup_wgrad(skip, x, dz1, y1, t)[2:], wref[2:])
        adjoint_case(record, dups, h)
        del skip, x, g, out_, y1, res, again, ref, dups, g2, dz1, wres, wref
        torch.cuda.empty_cache()
    # the heads' adjoints (unet_resnet50's 8 x 512^2 x 64 and self_net's
    # 8 x 1024^2 x 64 dups)
    for h in (256, 512):
        adjoint_case(record, torch.randn((B, 2 * h, 2 * h, 64), generator=gen, device=dev).to(bf),
                     h)
        torch.cuda.empty_cache()


def adjoint_case(record, dups, h):
    """``upsample_adjoint`` of (B, 2h, 2h, C) ``dups`` against its plain
    version (ADJOINT_REL_TOL), bit-identical on a second launch, launched
    with the host's plan; recorded against autograd of ``upsample2x``."""
    from tpu_unet_torch.kernels.decoder_train import (adjoint_plan, adjoint_plan_on_card,
                                                      upsample2x_adjoint,
                                                      upsample2x_adjoint_plain)
    from tpu_unet_torch.nn.resize import upsample2x

    B, h2, c = dups.shape[0], 2 * h, dups.shape[-1]
    case = f"{B}x{h2}x{h2}x{c}->{h}^2"
    ares, aref = upsample2x_adjoint(dups, h, h), upsample2x_adjoint_plain(dups, h, h)
    check(torch.equal(ares, upsample2x_adjoint(dups, h, h)),
          f"upsample_adjoint {case}: two launches differ")
    plan = adjoint_plan(B, h, h, c)
    check(adjoint_plan_on_card(B, h, h, c) == plan,
          f"upsample_adjoint {case}: the kernel's plan is not the host's {plan}")
    x = torch.zeros((B, h, h, c), dtype=dups.dtype, device=dups.device)

    def lib_a():
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            up = upsample2x(xg)
        return torch.autograd.grad(up, xg, dups)[0]

    rel = record("upsample_adjoint", case, [ares], [aref], lambda: upsample2x_adjoint(dups, h, h),
                 lambda: upsample2x_adjoint_plain(dups, h, h), lib_a,
                 2.0 * 4 * dups.numel(), nbytes(dups, ares), peak=PEAK_F32,
                 extra={"plan": plan._asdict()})
    check(rel <= ADJOINT_REL_TOL, f"upsample_adjoint {case}: rel err {rel:.3g} > {ADJOINT_REL_TOL}")


def upconv_bwd_kernels(record, gen):
    """The port of #12 at the two heads' shapes, batch 8: unet_resnet50's
    (x 256^2 -> 512^2) and self_net's (x 512^2 -> 1024^2), 64 channels.
    ``upconv_bwd`` against ``upconv_bwd_plain``: dx within CONV_REL_TOL,
    dk2 / db2 (from g2, which the kernel masks exactly as the plain version,
    and the given y1) within WGRAD_REL_TOL, dk1 / db1 (from dz1, which
    carries the kernel dgrad's bf16 rounding) within WGRAD_CHAIN_REL_TOL,
    all five bit-identical on a second launch, and a planted dropped split
    of the dk2 GEMM (``csrc/wgrad_sm90.cuh``, the plan's split count) read
    above both bounds; a witness line of dk2, the kernel's and the plain
    version's, against a float64 evaluation on the card (8.4M pixels a GEMM
    at self_net's head, where the bounds were set at up to 2.1M); timed
    against autograd of the cuDNN chain with ``upsample2x`` (its adjoint an
    ``index_add_``)."""
    from tpu_unet_torch.kernels.upconv import bwd_plan, upconv_bwd, upconv_bwd_plain
    from tpu_unet_torch.nn.resize import upsample2x

    dev, bf, B = torch.device("cuda"), torch.bfloat16, BATCH
    for h in (SIZE // 2, SIZE):
        h2 = 2 * h
        x = torch.relu(torch.randn((B, h, h, 64), generator=gen, device=dev)).to(bf)
        g = torch.randn((B, h2, h2, 64), generator=gen, device=dev).to(bf)
        out_ = torch.relu(torch.randn((B, h2, h2, 64), generator=gen, device=dev)).to(bf)
        y1 = torch.relu(torch.randn((B, h2, h2, 64), generator=gen, device=dev)).to(bf)
        w1 = (torch.randn((64, 64, 3, 3), generator=gen, device=dev) / 24).to(bf)
        w2 = (torch.randn((64, 64, 3, 3), generator=gen, device=dev) / 24).to(bf)
        args = (g, out_, y1, x, w1, w2)
        case = f"{B}x{h}x{h}x64->{h2}^2x64"
        res, again = upconv_bwd(*args), upconv_bwd(*args)
        check(all(torch.equal(a, b) for a, b in zip(res, again)),
              f"upconv_bwd {case}: two launches differ")
        ref = upconv_bwd_plain(*args)
        errs = {n: rel_err(a, b)[1] for n, a, b in
                zip(("dx", "dk1", "db1", "dk2", "db2"), res, ref)}
        tols = {"dx": CONV_REL_TOL, "dk1": WGRAD_CHAIN_REL_TOL, "db1": WGRAD_CHAIN_REL_TOL,
                "dk2": WGRAD_REL_TOL, "db2": WGRAD_REL_TOL}
        for n, e in errs.items():
            check(e <= tols[n], f"upconv_bwd {case}: {n} rel err {e:.3g} > {tols[n]}")
        print(json.dumps({"upconv_bwd": case, "rel_err_by_output": errs}), flush=True)
        g2 = torch.where(out_ > 0, g, 0).double()
        dk2_64 = torch.ops.aten.convolution_backward(
            cl(g2), cl(y1.double()), w2.double(), None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [False, True, False])[1]
        print(json.dumps({"upconv_bwd_dk2_float64": case,
                          "kernel_vs_float64": rel_err(res[3], dk2_64)[1],
                          "plain_vs_float64": rel_err(ref[3], dk2_64)[1],
                          "kernel_vs_plain": errs["dk2"], "bound": WGRAD_REL_TOL}), flush=True)
        del g2, dk2_64
        sm90_wgrad_fault_reading("upconv_bwd", case, bwd_plan(B, h2, h2, 64, 64)[1][0], g, None,
                                 lambda t, _: upconv_bwd(t, out_, y1, x, w1, w2)[3:], ref[3:])
        # the library yardstick: autograd of the cuDNN chain, graph built once
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            wg = [w.detach().requires_grad_() for w in (w1, w2)]
            bg = [torch.zeros(64, dtype=bf, device=dev, requires_grad=True) for _ in range(2)]
            y = torch.relu(F.conv2d(cl(upsample2x(xg)), wg[0], bg[0], padding=1))
            y = torch.relu(F.conv2d(y, wg[1], bg[1], padding=1))
        lib = lambda: torch.autograd.grad(y, [xg, *wg, *bg], cl(g), retain_graph=True)  # noqa: E731
        record("upconv_bwd", case, list(res), list(ref), lambda: upconv_bwd(*args),
               lambda: upconv_bwd_plain(*args), lib, 4 * conv_flops(B, h2, h2, 64, 64),
               nbytes(*args, *res))
        del x, g, out_, y1, res, again, ref, xg, wg, bg, y, lib
        torch.cuda.empty_cache()


# unet_vgg's encoder stages in training at 512², batch 8: (H, widths, pool)
VGG_TRAIN_STAGES = ((SIZE, [3, 64, 64], True), (SIZE // 2, [64, 128, 128], True),
                    (SIZE // 4, [128, 256, 256, 256], True),
                    (SIZE // 8, [256, 512, 512, 512], True),
                    (SIZE // 16, [512, 512, 512, 512], False))


def encoder_train_kernels(record, gen):
    """The port of the training encoder (#2 / #20, #21 / #22, #23 / #24) at
    the unet_vgg train step's shapes: the block forward keeping its
    intermediates (``vgg_block2_fwd`` / ``vgg_block3_fwd``; the stem's is
    phase 2's ``vgg_stem``) against the plain chain, and the stage backward
    against its plain version on the same intermediates — dx within
    CONV_REL_TOL, the last conv's weight and bias gradients (its input
    gradient is exact) within WGRAD_REL_TOL, the others within
    WGRAD_CHAIN_REL_TOL, all bit-identical on a second launch, and a
    planted dropped split of the last conv's Hopper weight-gradient GEMM
    read above both bounds — timed against autograd of the cuDNN chain,
    each with its share of the bound."""
    from tpu_unet_torch.kernels._plain import conv3x3_relu
    from tpu_unet_torch.kernels.encoder_train import (_vgg_block_cuda, _vgg_stem_cuda,
                                                      block_key, bwd_plan, vgg_block_bwd,
                                                      vgg_block_bwd_plain, vgg_stem_bwd,
                                                      vgg_stem_bwd_plain)

    dev, bf, B = torch.device("cuda"), torch.bfloat16, BATCH
    for h, chans, pool in VGG_TRAIN_STAGES:
        stem = chans[0] == 3
        n = len(chans) - 1
        x = (torch.rand((B, h, h, 3), generator=gen, device=dev) if stem else
             torch.relu(torch.randn((B, h, h, chans[0]), generator=gen, device=dev))).to(bf)
        ws = [(torch.randn((f, c, 3, 3), generator=gen, device=dev) / (9 * c) ** 0.5).to(bf)
              for c, f in zip(chans[:-1], chans[1:])]
        bs = [(0.1 * torch.randn(f, generator=gen, device=dev)).to(bf) for f in chans[1:]]
        case = f"{B}x{h}x{h} {chans} pool={pool}"
        flops = sum(conv_flops(B, h, h, c, f) for c, f in zip(chans[:-1], chans[1:]))

        def plain_fwd(x=x, ws=ws, bs=bs, pool=pool):
            y, acts = x, []
            for w, b in zip(ws, bs):
                y = conv3x3_relu(y, w, b)
                acts.append(y)
            return acts, (F.max_pool2d(cl(y), 2).permute(0, 2, 3, 1) if pool else None)

        if stem:
            skip, pooled, a1 = _vgg_stem_cuda(x, ws[0], bs[0], ws[1], bs[1])
            mids = [a1]
        else:
            key = block_key(n, "fwd")
            skip, pooled, mids = _vgg_block_cuda(x, ws, bs, pool, key)
            acts, ppool = plain_fwd()
            outs = [*mids, skip] + ([pooled] if pool else [])
            refs = acts + ([ppool] if pool else [])
            rel = record(key, case, outs, refs, lambda: _vgg_block_cuda(x, ws, bs, pool, key),
                         plain_fwd, lambda: cudnn_chain(x, ws, bs, pool), flops,
                         nbytes(x, *ws, *bs, *outs))
            check(rel <= CONV_REL_TOL, f"{key} {case}: rel err {rel:.3g} > {CONV_REL_TOL}")
        dskip = torch.randn(skip.shape, generator=gen, device=dev).to(bf)
        dpool = (torch.randn((B, h // 2, h // 2, chans[-1]), generator=gen, device=dev).to(bf)
                 if pool else None)
        if stem:
            key = "vgg_stem_bwd"

            def run(fn):
                return (None, *fn(dskip, dpool, x, mids[0], skip, ws[0], ws[1]))

            kern, plain = (lambda: run(vgg_stem_bwd)), (lambda: run(vgg_stem_bwd_plain))
        else:
            key = block_key(n, "bwd")
            kern = lambda: vgg_block_bwd(dskip, dpool, x, mids, skip, ws)  # noqa: E731
            plain = lambda: vgg_block_bwd_plain(dskip, dpool, x, mids, skip, ws)  # noqa: E731
        res, again, ref = kern(), kern(), plain()
        flat = lambda r: ([] if r[0] is None else [r[0]]) + list(r[1]) + list(r[2])  # noqa: E731
        check(all(torch.equal(a, b) for a, b in zip(flat(res), flat(again))),
              f"{key} {case}: two launches differ")
        errs = {} if res[0] is None else {"dx": rel_err(res[0], ref[0])[1]}
        for i in range(n):
            errs[f"dk{i}"] = rel_err(res[1][i], ref[1][i])[1]
            errs[f"db{i}"] = rel_err(res[2][i], ref[2][i])[1]
        for name, e in errs.items():
            tol = CONV_REL_TOL if name == "dx" else \
                WGRAD_REL_TOL if name[2:] == str(n - 1) else WGRAD_CHAIN_REL_TOL
            check(e <= tol, f"{key} {case}: {name} rel err {e:.3g} > {tol}")
        print(json.dumps({key: case, "rel_err_by_output": errs}), flush=True)
        ns = bwd_plan(B, h, h, tuple(chans), not stem)[1][n - 1]
        if stem:
            def faulty(ds, dp):
                return [r[n - 1] for r in vgg_stem_bwd(ds, dp, x, mids[0], skip, ws[0], ws[1])]
        else:
            def faulty(ds, dp):
                return [r[n - 1] for r in vgg_block_bwd(ds, dp, x, mids, skip, ws)[1:]]
        sm90_wgrad_fault_reading(key, case, ns, dskip, dpool, faulty,
                                 [ref[1][n - 1], ref[2][n - 1]])
        # the library yardstick: autograd of the cuDNN chain, graph built once
        with torch.enable_grad():
            xg = cl(x).detach().requires_grad_(not stem)
            wg = [w.detach().requires_grad_() for w in ws]
            bg = [b.detach().requires_grad_() for b in bs]
            y = cudnn_chain(xg.permute(0, 2, 3, 1), wg, bg, pool)
            outs, cots = ((list(y), [cl(dskip), cl(dpool)]) if pool else ([y], [cl(dskip)]))
        wrt = ([] if stem else [xg]) + wg + bg
        lib = lambda: torch.autograd.grad(outs, wrt, cots, retain_graph=True)  # noqa: E731
        # a weight gradient and a dgrad per conv; the stem has no dgrad to x
        bwd_flops = 2 * flops - (conv_flops(B, h, h, 3, chans[1]) if stem else 0)
        record(key, case, flat(res), flat(ref), kern, plain, lib, bwd_flops,
               nbytes(x, *mids, skip, dskip, dpool, *ws, *flat(res)))
        del x, ws, bs, skip, pooled, mids, dskip, dpool, res, again, ref, xg, wg, bg, y, outs
        torch.cuda.empty_cache()


# (F, C) of every conv weight that the ported models pack for the conv core
# (unet_vgg's encoder and decoder, unet_resnet50's decoder, the up_conv
# head; self_net packs unet_vgg's and the head's), the stem's conv1_1
# padded to one 128-byte box
PACK_SHAPES = sorted({(chans[i + 1], chans[i]) for _, chans, _ in VGG_TRAIN_STAGES
                      for i in range(len(chans) - 1)}
                     | {s for _, cs, cx, f in VGG_STAGES + RN50_STAGES
                        for s in ((f, cs + cx), (f, f))} | {(64, 64)})


def pack_kernels(record, gen):
    """The pack kernel (``csrc/pack_weights.cu``) at every weight shape of
    PACK_SHAPES, in the forward and the dgrad layout (conv1_1, never a
    dgrad's, in the forward layout with its pad), bf16 and float32:
    bit-equal (``torch.equal``) to the eager plain pack on the same weights,
    bit-identical on a relaunch; its time against the plain pack's and its
    bytes bound (each weight read once, its operand written once)."""
    from tpu_unet_torch.kernels import sm90
    from tpu_unet_torch.kernels._build import pack_conv3x3_plain, pack_weights

    for dt in (torch.bfloat16, torch.float32):
        key = "pack_weights_f32" if dt == torch.float32 else "pack_weights"
        for f, c in PACK_SHAPES:
            w = (torch.randn((f, c, 3, 3), generator=gen, device="cuda") / (9 * c) ** 0.5).to(dt)
            kp = sm90.slice_c(dt == torch.float32) if c == 3 else None
            for flip in (False,) if c == 3 else (False, True):
                case = f"({f}, {c}, 3, 3) {'dgrad' if flip else 'forward'} {dt}"
                fn = functools.partial(pack_weights, [w], dt, flip, [kp])
                out, again = fn()[0], fn()[0]
                ref = pack_conv3x3_plain(w, kp, dt, flip)
                check(torch.equal(out, ref) and torch.equal(out, again),
                      f"{key} {case}: not bit-equal to the plain pack or its relaunch")
                record(key, case, [out], [ref], fn,
                       functools.partial(pack_conv3x3_plain, w, kp, dt, flip), None, 0.0,
                       nbytes(w, out))


def logit_loss_kernels(record, gen):
    """#25 / #26 against their plain versions: the DataB presets' shape
    (32x256^2x4 bf16; ``traditional``'s weights (1, 15, 0, 0) and the
    ladder's (1, 15, 1.5, 2)), CE + dice, unet_vgg + focal's 8x512^2x21
    bf16, the widest class count (126: sixteen threads a pixel) and a
    float32 case; targets with the ignore class and raw 255s.  Loss and
    f_score within 1e-4 relative, dlogits within 1% of max |plain| (bf16)
    or 1e-5 (float32), the loss bit-identical run to run.  Each line also
    carries the pass's device time (``torch.profiler``: every kernel the
    wrapper launches) and its share of the bound."""
    from tpu_unet_torch.kernels.loss import (ce_dice_bwd, ce_dice_bwd_plain, ce_dice_fwd,
                                             ce_dice_fwd_plain, pack_targets)
    from tpu_unet_torch.tools.bench_launch import device_ms

    dev = torch.device("cuda")
    bf = torch.bfloat16
    trad, ladder = (1.0, 15.0, 0.0, 0.0), (1.0, 15.0, 1.5, 2.0)
    cases = [(DATAB_BATCH, DATAB_SIZE, 4, bf, trad, True, True),
             (DATAB_BATCH, DATAB_SIZE, 4, bf, ladder, True, True),
             (DATAB_BATCH, DATAB_SIZE, 4, bf, ladder, False, True),
             (BATCH, SIZE, 21, bf, tuple(1.0 + 0.1 * i for i in range(21)), True, True),
             (4, DATAB_SIZE, 126, bf, tuple(1.0 + 0.01 * i for i in range(126)), True, True),
             (4, DATAB_SIZE, 4, torch.float32, ladder, True, True)]
    for n, size, c, dt, cw, focal, dice in cases:
        x = (2 * torch.randn((n, size, size, c), generator=gen, device=dev)).to(dt)
        t = torch.randint(0, c, (n, size, size), generator=gen, device=dev, dtype=torch.int32)
        r = torch.rand((n, size, size), generator=gen, device=dev)
        t = torch.where(r < 0.03, torch.full_like(t, c), t)      # ignore class
        t = torch.where(r > 0.98, torch.full_like(t, 255), t)    # raw VOC border
        t = pack_targets(t, c)  # one byte a pixel, as the kernels read them
        t_cl, cw_t = t.long().reshape(-1), torch.tensor(cw, device=dev)
        npix = x.numel() // c
        gl = torch.tensor(1.0, device=dev)
        case = (f"{n}x{size}x{size}x{c} {str(dt).split('.')[-1]} "
                f"{'focal' if focal else 'CE'}{' + dice' if dice else ''} w={list(cw)}")
        loss, fs, res = ce_dice_fwd(x, t, cw, c, dice, focal)
        ploss, pfs, pres = ce_dice_fwd_plain(x, t, cw, c, dice, focal)
        again = ce_dice_fwd(x, t, cw, c, dice, focal)
        check(bool(torch.equal(loss, again[0]) and torch.equal(fs, again[1])),
              f"ce_dice_fwd {case}: two runs differ")
        lrel = abs(loss.item() - ploss.item()) / abs(ploss.item())
        check(lrel <= 1e-4, f"ce_dice_fwd {case}: loss rel err {lrel:.3g} > 1e-4")
        check(abs(fs.item() - pfs.item()) <= 1e-4 * max(abs(pfs.item()), 1e-30),
              f"ce_dice_fwd {case}: f_score {fs.item()} vs {pfs.item()}")
        xf = x.reshape(-1, c)

        def lib(xf=xf, t_cl=t_cl, cw_t=cw_t, c=c):
            lf = xf.float()
            ce = F.cross_entropy(lf, t_cl, weight=cw_t, ignore_index=c)
            p = torch.softmax(lf, -1)
            oh = F.one_hot(t_cl, c + 1)[:, :c].float()
            pt = (p > 0.5).float()
            return ce, (p * oh).sum(0), p.sum(0), oh.sum(0), (pt * oh).sum(0), pt.sum(0)

        kern = lambda: ce_dice_fwd(x, t, cw, c, dice, focal)  # noqa: E731
        dms = device_ms(kern)
        check(dms > 0, f"ce_dice_fwd {case}: no device events in the profile")
        record("ce_dice_fwd", case, [loss, fs], [ploss, pfs], kern,
               lambda: ce_dice_fwd_plain(x, t, cw, c, dice, focal), lib,
               12.0 * npix * c, nbytes(x, t), peak=PEAK_F32,
               extra={"device_ms": dms, "device_share_of_bound":
                      bound(12.0 * npix * c, nbytes(x, t), PEAK_F32)[0] / max(dms, 1e-9)})
        out = ce_dice_bwd(x, t, cw, c, dice, focal, 0.5, 2.0, res, gl)
        ref = ce_dice_bwd_plain(x, t, cw, c, dice, focal, 0.5, 2.0, pres, gl)
        drel = rel_err(out, ref)[1]
        tol = 1e-2 if dt == bf else 1e-5
        check(out.dtype == dt and drel <= tol, f"ce_dice_bwd {case}: dlogits rel err {drel:.3g}")
        xg = xf.detach().clone().requires_grad_()
        lf = xg.float()
        p = torch.softmax(lf, -1)
        oh = F.one_hot(t_cl, c + 1)[:, :c].float()
        tp, ps, ts = (p * oh).sum(0), p.sum(0), oh.sum(0)
        graph = F.cross_entropy(lf, t_cl, weight=cw_t, ignore_index=c) + \
            1 - ((2 * tp + 1e-5) / (ps + ts + 1e-5)).mean()
        check(bool(torch.equal(out, ce_dice_bwd(x, t, cw, c, dice, focal, 0.5, 2.0, res, gl))),
              f"ce_dice_bwd {case}: two runs differ")
        kern = lambda: ce_dice_bwd(x, t, cw, c, dice, focal, 0.5, 2.0, res, gl)  # noqa: E731
        dms = device_ms(kern)
        check(dms > 0, f"ce_dice_bwd {case}: no device events in the profile")
        record("ce_dice_bwd", case, [out], [ref], kern,
               lambda: ce_dice_bwd_plain(x, t, cw, c, dice, focal, 0.5, 2.0, pres, gl),
               lambda: torch.autograd.grad(graph, [xg], retain_graph=True),
               14.0 * npix * c, nbytes(x, t, out), peak=PEAK_F32,
               extra={"device_ms": dms, "device_share_of_bound":
                      bound(14.0 * npix * c, nbytes(x, t, out), PEAK_F32)[0] / max(dms, 1e-9)})
        del x, t, r, t_cl, out, ref, xg, lf, p, oh, graph


def plain_logits(model, net, imgs):
    """The serving step's float32 logits (N·H·W, C) at the input size,
    composed of the plain versions on the same device."""
    from tpu_unet_torch.core.precision import normalize_u8
    from tpu_unet_torch.kernels.decoder_fuse import unetup_plain
    from tpu_unet_torch.kernels.encoder import vgg_block_plain
    from tpu_unet_torch.kernels.stem import vgg_stem_plain
    from tpu_unet_torch.kernels.upconv import upconv_plain
    from tpu_unet_torch.models.backbones import _STAGES
    from tpu_unet_torch.nn.resize import resize_bilinear

    if model in GENERIC:  # plain PyTorch up to the argmax, as the step
        logits = net(normalize_u8(imgs, next(net.parameters()).dtype))
        if logits.shape[1:3] != imgs.shape[1:3]:
            logits = resize_bilinear(logits.float(), imgs.shape[1:3], align_corners=True)
        return logits.float().reshape(-1, logits.shape[-1])
    if model.startswith("traditional"):  # plain PyTorch up to the tail
        up = net(normalize_u8(imgs, net.outc.weight.dtype), features_out=True)
        c = net.outc.weight.shape[0]
        w = net.outc.weight.reshape(c, -1)
        return up.reshape(-1, up.shape[-1]).float() @ w.float().t() + net.outc.bias.float()
    if net.backbone == "vgg":
        fs = net.vgg.features
        wb = [([fs[i].weight for i in idx], [fs[i].bias for i in idx]) for idx in _STAGES]
        (w0, w2), (b0, b2) = wb[0]
        feat, x = vgg_stem_plain(imgs, w0, b0, w2, b2)
        feats = [feat]
        for si in range(1, 5):
            skip, pooled = vgg_block_plain(x, *wb[si], pool=si < 4)
            feats.append(skip)
            x = pooled
    else:  # plain PyTorch on both paths
        feats = net.resnet(normalize_u8(imgs, net.final.weight.dtype))
    up = feats[4]
    for i, skip in zip((4, 3, 2, 1), feats[3::-1]):
        m = getattr(net, f"up_concat{i}")
        up = unetup_plain(skip, up, m.conv1.weight, m.conv1.bias,
                          m.conv2.weight, m.conv2.bias)
    del feats
    if net.up_conv is not None:
        c1, c2 = net.up_conv[1], net.up_conv[3]
        up = upconv_plain(up, c1.weight, c1.bias, c2.weight, c2.bias)
    c = net.final.weight.shape[0]
    w = net.final.weight.reshape(c, -1)
    if model != "self_net":  # as the fused tail: float32 dot products
        return up.reshape(-1, up.shape[-1]).float() @ w.float().t() + net.final.bias.float()
    # as the generic branch: bf16 logits, float32 resize to the input size
    logits = (up @ w.t() + net.final.bias).float()
    del up
    return resize_bilinear(logits, imgs.shape[1:3], align_corners=True).reshape(-1, c)


def compare_masks(masks, logits, margin):
    """(share of pixels that differ from argmax(logits), flips where the
    top-1/top-2 gap exceeds ``margin`` of the logit scale, largest gap of a
    flip as a share of the scale)."""
    top2 = logits.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).reshape(masks.shape).to(masks.device)
    ref = logits.argmax(-1).reshape(masks.shape).to(masks.device)
    differ = masks.long() != ref
    scale = logits.abs().max().item()
    outside = int((differ & (gap > margin * scale)).sum())
    need = gap[differ].max().item() / scale if differ.any() else 0.0
    return differ.float().mean().item(), outside, need


# the kernels whose wrappers pack their conv weights on the card: one launch
# of the pack kernel a call (pack_weights, float32 pack_weights_f32)
PACKING = ("vgg_stem", "vgg_block", "vgg_block2_fwd", "vgg_block3_fwd", "vgg_stem_bwd",
           "vgg_block2_bwd", "vgg_block3_bwd", "unetup", "unetup_bwd", "upconv", "upconv_bwd")


def expected(launches: dict) -> dict:
    """``launches`` with the pack kernel's launches that they make and every
    other kernel at 0."""
    from tpu_unet_torch.kernels import launch_counts

    out = {k: launches.get(k, 0) for k in launch_counts}
    for sfx in ("", "_f32"):
        out["pack_weights" + sfx] = sum(launches.get(k + sfx, 0) for k in PACKING)
    return out


# each counted serving step (model, batch, size) and the launches it must
# make; every other kernel 0.  Serving normalises in plain PyTorch, as the
# JAX step does, so normalize_images is 0 throughout.  The upsample kernel
# runs once in each UnetUp stage and once in the up_conv head.
SERVING = {
    ("unet_vgg", BATCH, SIZE): {"final_argmax_hist": 1, "vgg_stem": 1, "vgg_block": 4,
                                "unetup": 4, "upsample2x": 4},
    ("unet_resnet50", BATCH, SIZE): {"final_argmax_hist": 1, "unetup": 4, "upsample2x": 5,
                                     "upconv": 1},
    ("self_net", BATCH, SIZE): {"vgg_stem": 1, "vgg_block": 4, "unetup": 4, "upsample2x": 5,
                                "upconv": 1, "argmax_mask": 1},
    ("traditional", DATAB_BATCH, DATAB_SIZE): {"final_argmax_hist": 1},
    ("traditional22", DATAB_BATCH, DATAB_SIZE): {"final_argmax_hist": 1},
    # 40,000 pixels an image: the mask-only tail and a separate histogram
    ("traditional", DATAB_BATCH, 200): {"final_argmax": 1},
    # the generic step: plain PyTorch net, the argmax-mask kernel
    **{(m, DATAB_BATCH, DATAB_SIZE): {"argmax_mask": 1} for m in GENERIC},
}
# counted steps without the profiler breakdown
UNPROFILED = ("ultralight", "ultralight_large", "ultralight44")


def entry(model: str, kernel: str) -> str:
    """The ``kernels`` line entry a launch counts for: the TraditionalUnet
    family's histogram tail replaces another TPU function (#5) than the
    canonical UNets' (#4), through the same CUDA kernel."""
    if kernel == "final_argmax_hist" and model.startswith("traditional"):
        return "final_argmax_hist_natural"
    return kernel


def profiled(run, activities, tries: int = 3):
    """``run()`` under ``torch.profiler`` with ``activities``; a window in
    which the profiler recorded no device event at all (it has returned
    such a window on an H100 for steps that launch kernels) is taken again,
    up to ``tries`` windows.  Returns the last profile; the caller's checks
    read it."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    for _ in range(tries):
        with profile(activities=activities) as prof:
            run()
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            break
    return prof


def device_breakdown(fn, net, imgs, steps: int = 3):
    """Device time per serving step by kernel (torch.profiler over
    ``steps`` steps) and the device's idle share between the first kernel's
    start and the last kernel's end.  The port's kernels are named
    ``conv3x3_kernel<Loader, pool>``, ``final_tail_kernel<F, NP, hist>``,
    ``normalize_kernel<T>``, ``argmax_kernel<T, V, Out>``,
    ``palette_kernel<M>``, ``wgrad_kernel<Loader>``, ``wgrad_reduce_kernel``,
    ``upsample_adjoint_kernel``, the training encoder's
    ``(pool_)relu_grad_kernel``, the Hopper core's
    ``conv_sm90_kernel<TN, OP, PH>``, ``wgrad_sm90_kernel<TN, NS>``, the
    float32 head's ``halo_conv_kernel<OP, PH>``, the
    float32 ``wgrad_tf32_kernel`` and ``wgrad_sm90_reduce_kernel``, the
    stem's ``wgrad_image_kernel`` and
    ``wgrad_image_reduce_kernel``, ``upsample2x_kernel`` and the weight
    pack's ``pack_kernel`` (all summed in ``port_kernels_ms``);
    ``index_add_ms`` sums PyTorch's ``index_add_`` kernels;
    ``loss_kernels_ms`` gives the loss kernels' own (#25-#29),
    ``tail_adjoint_kernels_ms`` the serving tails' and the upsample
    adjoint's (#4, #5, #7, #19), ``small_kernels_ms`` the tails', the
    argmax mask's and the palette blend's (#4-#8)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn(net, imgs)
    torch.cuda.synchronize()

    def run():
        for _ in range(steps):
            fn(net, imgs)
        torch.cuda.synchronize()

    # the device's events alone: nothing here reads the host's, whose tens of
    # thousands a training step took seconds a window to process
    prof = profiled(run, [ProfilerActivity.CUDA])
    spans, by_name, index_add = [], {}, 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        name = e.name
        if "indexFunc" in name:  # index_add_ (the plain upsample's adjoint)
            index_add += e.time_range.elapsed_us() / 1e3 / steps
        if "final_loss_fwd_kernel" in name or "final_loss_bwd_kernel" in name:
            name = "port " + ("final_loss_fwd_kernel" if "fwd" in name else "final_loss_bwd_kernel")
        elif "ce_dice_fwd_kernel" in name or "ce_dice_bwd_kernel" in name:
            name = "port " + ("ce_dice_fwd_kernel" if "fwd" in name else "ce_dice_bwd_kernel")
        elif kind := next((k for k in ("conv_sm90_kernel", "wgrad_sm90_kernel",
                                        "halo_conv_kernel") if k in name), None):
            name = f"port {kind}<{name[name.index('<') + 1:name.index('>')]}>"
        elif "wgrad_tf32_kernel" in name:
            name = "port wgrad_tf32_kernel"
        elif "wgrad_image" in name:
            name = "port " + ("wgrad_image_reduce_kernel" if "reduce" in name
                              else "wgrad_image_kernel")
        elif "wgrad_sm90_reduce_kernel" in name or "upsample2x_kernel" in name:
            name = "port " + ("upsample2x_kernel" if "upsample2x" in name
                              else "wgrad_sm90_reduce_kernel")
        elif "relu_grad_kernel" in name:
            name = "port " + ("pool_relu_grad_kernel" if "pool" in name else "relu_grad_kernel")
        elif "upsample_adjoint_kernel" in name:
            name = "port upsample_adjoint_kernel"
        elif "conv_image_kernel" in name:
            name = "port conv_image_kernel"
        elif "final_tail_kernel" in name:
            name = f"port final_tail_kernel<{'hist' if 'true' in name else 'mask'}>"
        elif "normalize_kernel" in name:
            name = "port normalize_kernel"
        elif "argmax_kernel" in name:
            name = "port argmax_kernel"
        elif "palette_kernel" in name:
            name = "port palette_kernel"
        elif "pack_kernel" in name:
            name = "port pack_kernel"
        else:
            name = name[:70]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    check(bool(spans), "profiler: no device events in the serving step")
    spans.sort()
    busy, end = 0.0, spans[0][0]
    for a, b in spans:  # union of the kernel intervals
        busy += max(0, b - max(a, end))
        end = max(end, b)
    window = end - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    port = sum(v for k, v in top if k.startswith("port "))
    return {"device_ms_per_step": busy / 1e3 / steps, "port_kernels_ms": port,
            "index_add_ms": index_add, "idle_share": 1 - busy / window if window else 0.0,
            "top_kernels_ms": [[k, v] for k, v in top[:8]],
            "loss_kernels_ms": {k: v for k, v in top if "final_loss" in k or "ce_dice" in k},
            "tail_adjoint_kernels_ms": {k: v for k, v in top if "final_tail" in k
                                        or "upsample_adjoint" in k},
            "small_kernels_ms": {k: v for k, v in top if "final_tail" in k or "argmax_kernel" in k
                                 or "palette_kernel" in k}}


# the device kernels of a step's small kernels and the launch keys they
# count under
SMALL_KERNELS = (("final_tail_kernel<hist>", "final_argmax_hist"),
                 ("final_tail_kernel<mask>", "final_argmax"), ("argmax_kernel", "argmax_mask"),
                 ("palette_kernel", "mask_palette"))


def serve(model: str, batch: int, size: int, card: str):
    """Drive ``model``'s serving step on a seeded uint8 batch; return its
    launch counts."""
    from tpu_unet_torch.core.precision import normalize_u8
    from tpu_unet_torch.infer.wrapper import Unet
    from tpu_unet_torch.kernels import launch_counts, reset_launch_counts
    from tpu_unet_torch.nn.resize import resize_bilinear

    classes = CLASSES[model]
    tag = f"{model} {batch}x{size}^2"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = t_serve = time.perf_counter()
    u = Unet(model=model, num_classes=classes, input_shape=[size, size])
    fn, net = u.serving_step()
    print(f"phase 3: {tag} built in {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    imgs = torch.randint(0, 256, (batch, size, size, 3), generator=gen,
                         device="cuda", dtype=torch.uint8)
    fn(net, imgs)
    torch.cuda.synchronize()

    reset_launch_counts()
    masks, hist = fn(net, imgs)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    expect = expected(SERVING[(model, batch, size)])
    check(counts == expect, f"{tag} launch counts {counts} != {expect}")

    steps = 5
    t0 = time.perf_counter()
    for _ in range(steps):
        fn(net, imgs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    step_ms = time_ms(lambda: fn(net, imgs), reps=steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the net without its tail: kernels for VGG16, cuDNN for ResNet50 and
    # the TraditionalUnet; for the generic models the net up to the logits
    traditional = model.startswith("traditional")
    vgg = not traditional and model not in GENERIC and net.backbone == "vgg"
    dtype = next(net.parameters()).dtype
    x = imgs if vgg else normalize_u8(imgs, dtype)
    if model in GENERIC:
        enc = lambda: net(x)  # noqa: E731
    elif traditional:
        enc = lambda: net(x, features_out=True)  # noqa: E731
    else:
        enc = lambda: (net.vgg if vgg else net.resnet)(x)  # noqa: E731
    with torch.no_grad():
        enc_ms = time_ms(enc, reps=steps)
    breakdown = None if model in UNPROFILED else device_breakdown(fn, net, imgs)

    check(masks.shape == (batch, size, size) and masks.dtype == torch.uint8,
          f"{tag} masks {tuple(masks.shape)} {masks.dtype}")
    check(hist.shape == (batch, classes) and hist.dtype == torch.int32,
          f"{tag} hist {tuple(hist.shape)} {hist.dtype}")
    check(int(hist.sum()) == batch * size * size, f"{tag} hist sum {int(hist.sum())}")
    own = torch.stack([torch.bincount(m.flatten().long(), minlength=classes)
                       for m in masks]).to(torch.int32)
    check(bool(torch.equal(own, hist)), f"{tag} serving hist != bincount(masks)")

    with torch.no_grad():
        logits = plain_logits(model, net, imgs)
    mism, outside, need = compare_masks(masks, logits, SERVE_MARGIN)
    check(mism <= SERVE_MISMATCH, f"{tag} mask mismatch {mism:.4f} > {SERVE_MISMATCH}")
    check(outside == 0, f"{tag}: {outside} flips outside the margin")
    del logits, masks

    # small batch against the CPU float32 path (the path the tests hold
    # against the JAX package), same seeded weights
    small_size = min(size, 256)
    small = torch.randint(0, 256, (1, small_size, small_size, 3), generator=gen,
                          device="cuda", dtype=torch.uint8)
    m_gpu, _ = fn(net, small)
    cpu = Unet(model=model, num_classes=classes, input_shape=[small_size] * 2, cuda=False)
    with torch.no_grad():
        xs = small.cpu() if vgg else normalize_u8(small.cpu(), torch.float32)
        cpu_logits = cpu.net(xs)
        cpu_logits = resize_bilinear(cpu_logits, (small_size,) * 2, align_corners=True)
    mism_cpu, outside_cpu, need_cpu = compare_masks(m_gpu.cpu(), cpu_logits.reshape(-1, classes),
                                                    SERVE_MARGIN)
    check(mism_cpu <= SERVE_MISMATCH,
          f"{tag} {small_size}px vs CPU f32 mismatch {mism_cpu:.4f}")
    check(outside_cpu == 0,
          f"{tag} {small_size}px vs CPU f32: {outside_cpu} flips outside the margin")

    line = {"serving": model, "batch": batch, "size": size, "classes": classes,
            "img_per_s": batch * steps / dt, "step_ms_host": dt / steps * 1e3,
            "step_ms_events": step_ms, "encoder_ms_events": enc_ms, "launches": counts,
            "mask_mismatch_vs_plain": mism, "flips_outside_margin": outside,
            "largest_flip_gap": need, f"mask_mismatch_vs_cpu_f32_{small_size}px": mism_cpu,
            "largest_flip_gap_vs_cpu": need_cpu, "peak_mem_gib": peak,
            "wall_s": time.perf_counter() - t_serve, "gpu": card}
    print(json.dumps(line), flush=True)
    if breakdown is not None:
        print(json.dumps({"serving": model, "size": size, "profile": breakdown}), flush=True)
        # the in-step device time of the step's tail or argmax-mask kernel
        # (#4 / #5 / #7 / #6), ms a step
        for k, v in breakdown["small_kernels_ms"].items():
            key = next(key for part, key in SMALL_KERNELS if part in k)
            print(json.dumps({"in_step": model, "batch": batch, "size": size,
                              "kernel": entry(model, key), "device_kernel": k,
                              "device_ms": v, "gpu": card}), flush=True)
    del u, fn, net, imgs, x
    return counts


def phase_serving(card: str):
    """Each serving path with its own counted step; the launches by
    ``kernels`` entry."""
    totals: dict = {}
    t0 = time.perf_counter()
    for model, batch, size in SERVING:
        for k, v in serve(model, batch, size, card).items():
            totals[entry(model, k)] = totals.get(entry(model, k), 0) + v
    print(f"phase 3: serving in {time.perf_counter() - t0:.1f} s", flush=True)
    return totals


# the single-image API: (model, input size, get_FPS iterations) and the
# launches of each forward; every other kernel 0.  The forward runs the
# normalize kernel once, then the net; its logits go through softmax, not a
# tail kernel.
SINGLE = {
    ("traditional", DATAB_SIZE, 50): {"normalize_images": 1},
    # a deep-supervision model: its eval forward gives the final head only
    ("balancedseg_fpn_sup", DATAB_SIZE, 20): {"normalize_images": 1},
    ("unet_vgg", SIZE, 20): {"normalize_images": 1, "vgg_stem": 1, "vgg_block": 4,
                             "unetup": 4, "upsample2x": 4},
}


def single_image(model: str, size: int, reps: int, card: str):
    """Drive the single-image API of ``model`` on a seeded 300x200 image
    (the letterbox has gray bars); return the launches of its two counted
    forwards."""
    from PIL import Image

    from tpu_unet_torch.infer.wrapper import Unet
    from tpu_unet_torch.kernels import launch_counts, reset_launch_counts

    classes = CLASSES[model]
    tag = f"{model} single image {size}^2"
    u = Unet(model=model, num_classes=classes, input_shape=[size, size])
    rng = np.random.default_rng(5)
    image = Image.fromarray(rng.integers(0, 256, (200, 300, 3), dtype=np.uint8))
    u._probs_for(image)  # warm-up: cuDNN plans
    torch.cuda.synchronize()
    expect = expected(SINGLE[(model, size, reps)])
    totals = dict.fromkeys(expect, 0)

    reset_launch_counts()
    pr, rgb = u._probs_for(image)
    counts = dict(launch_counts)
    check(counts == expect, f"{tag} _probs_for launches {counts} != {expect}")
    for k, v in counts.items():
        totals[k] += v
    reset_launch_counts()
    mask, _ = u._device_mask_for(image)
    counts = dict(launch_counts)
    check(counts == expect, f"{tag} _device_mask_for launches {counts} != {expect}")
    for k, v in counts.items():
        totals[k] += v

    x, nw, nh, _ = u._letterbox(image)
    check(pr.shape == (nh, nw, classes) and nh < size, f"{tag} cropped probabilities {pr.shape}")
    check(bool(np.allclose(pr.sum(-1), 1.0, atol=1e-4)), f"{tag} probabilities do not sum to 1")
    check(mask.dtype == np.uint8 and mask.shape == (nh, nw), f"{tag} mask {mask.shape}")
    check(bool(np.array_equal(mask, pr.argmax(-1))),
          f"{tag} device mask != argmax of the probabilities")

    # the card's mask against the CPU float32 path (the path the tests hold
    # against the JAX package): same seeded weights, same letterboxed image
    cpu = Unet(model=model, num_classes=classes, input_shape=[size, size], cuda=False)
    cpu_logits = cpu._crop(cpu._forward_logits(x)[0], nh, nw)
    mism_cpu, outside_cpu, need_cpu = compare_masks(torch.from_numpy(mask),
                                                    cpu_logits.reshape(-1, classes), SERVE_MARGIN)
    check(mism_cpu <= SERVE_MISMATCH, f"{tag} mask vs CPU f32 mismatch {mism_cpu:.4f}")
    check(outside_cpu == 0, f"{tag} mask vs CPU f32: {outside_cpu} flips outside the margin")
    prob_err = float(np.abs(pr - torch.softmax(cpu_logits, -1).numpy()).max())
    del cpu, cpu_logits

    s_mask = u.get_FPS(image, reps)
    s_full = u.get_FPS(image, reps, full_d2h=True)
    shapes = {}
    for mix in (0, 1, 2):
        u.mix_type = mix
        out = u.detect_image(image)
        check(out.size == image.size and out.mode == "RGB", f"{tag} detect_image mix {mix}")
        shapes[f"detect_mix{mix}"] = [out.size, out.mode]
    u.mix_type = 0
    fast = u.detect_image(image, count=True, fast=True)
    check(fast.size == image.size and fast.mode == "RGB", f"{tag} detect_image fast")
    png, png_fast = u.get_miou_png(image), u.get_miou_png(image, fast=True)
    for p, what in ((png, "get_miou_png"), (png_fast, "get_miou_png fast")):
        check(p.size == image.size and p.mode == "L" and int(np.asarray(p).max()) < classes,
              f"{tag} {what} {p.size} {p.mode}")
    print(json.dumps({
        "single_image": model, "size": size, "classes": classes, "image": list(image.size),
        "letterboxed": [nw, nh], "launches_per_forward": counts,
        "mask_mismatch_vs_cpu_f32": mism_cpu, "largest_flip_gap_vs_cpu": need_cpu,
        "probs_max_abs_err_vs_cpu_f32": prob_err,
        "get_FPS_s_device_mask": s_mask, "fps_device_mask": 1 / s_mask,
        "get_FPS_s_full_d2h": s_full, "fps_full_d2h": 1 / s_full, "reps": reps,
        "miou_png_fast_agreement": float((np.asarray(png) == np.asarray(png_fast)).mean()),
        "outputs": shapes, "gpu": card}), flush=True)
    del u
    return totals


def phase_single_image(card: str):
    totals: dict = {}
    t0 = time.perf_counter()
    for model, size, reps in SINGLE:
        for k, v in single_image(model, size, reps, card).items():
            totals[k] = totals.get(k, 0) + v
    print(f"phase 4: single image in {time.perf_counter() - t0:.1f} s", flush=True)
    return totals


def _seeded_image(rng, w: int, h: int) -> np.ndarray:
    """A smooth seeded RGB image with noise (so JPEG keeps some structure)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = rng.uniform(0.01, 0.06, 3).astype(np.float32)
    arr = 127 + 110 * np.sin(f * (xx[..., None] + 0.6 * yy[..., None]))
    return np.clip(arr + rng.normal(0, 12, arr.shape), 0, 255).astype(np.uint8)


def counted(expect: dict, what: str, fn):
    """Run ``fn`` with the launch counts set to 0; fail unless they equal
    ``expect`` (every other kernel 0).  Returns (fn's result, counts)."""
    from tpu_unet_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    check(counts == expected(expect), f"{what} launches {counts} != {expected(expect)}")
    return out, counts


def phase_tools(card: str):
    """The inference entry points on seeded files; returns their launches
    by ``kernels`` entry."""
    import contextlib
    import io
    import tempfile

    import cv2
    from PIL import Image

    from tpu_unet_torch import cli
    from tpu_unet_torch.configs.infer_presets import build_wrapper
    from tpu_unet_torch.data import native
    from tpu_unet_torch.data.transforms import cvt_rgb, letterbox_image
    from tpu_unet_torch.eval.driver import evaluate
    from tpu_unet_torch.tools import predict as P

    totals: dict = {}

    def add(model, counts):
        for k, v in counts.items():
            totals[entry(model, k)] = totals.get(entry(model, k), 0) + v

    t_phase = time.perf_counter()
    rng = np.random.default_rng(9)
    size, batch = DATAB_SIZE, DATAB_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        img_dir = tmp / "img"
        img_dir.mkdir()
        dims = [(300, 200), (256, 256), (640, 480)]
        for i in range(40):
            w, h = dims[i % 3]
            Image.fromarray(_seeded_image(rng, w, h)).save(
                img_dir / f"im{i:02d}{'.jpg' if i % 2 == 0 else '.png'}", quality=90)
        names = sorted(p.name for p in img_dir.iterdir())

        # predict_dir_batched: traditional at 256^2, batch 32 (two batches,
        # the second padded); the loader is built before the clock starts
        route = native.route()
        u = build_wrapper("traditional")
        u.batch_infer(np.zeros((batch, size, size, 3), np.uint8))  # cuDNN plans
        t0 = time.perf_counter()
        n, counts = counted({"final_argmax_hist": 2}, "predict_dir_batched", lambda: P.predict_dir_batched(
            u, str(img_dir), str(tmp / "out"), batch_size=batch))
        dt = time.perf_counter() - t0
        add("traditional", counts)
        check(n == 40, f"predict_dir_batched wrote {n} of 40")
        pngs = np.stack([np.asarray(Image.open(tmp / "out" / (Path(nm).stem + ".png")))
                         for nm in names])
        check(pngs.shape == (40, size, size), f"predict_dir_batched PNGs {pngs.shape}")
        # against batch_infer on PIL-letterboxed copies, in the same chunks
        ref, mism, outside, need = [], 0.0, 0, 0.0
        for c0 in range(0, 40, batch):
            chunk = names[c0:c0 + batch]
            boxed = np.zeros((batch, size, size, 3), np.uint8)
            for i, nm in enumerate(chunk):
                boxed[i] = np.asarray(letterbox_image(cvt_rgb(Image.open(img_dir / nm)),
                                                      (size, size))[0])
            ref.append(u.batch_infer(boxed)[:len(chunk)])
            fn, net = u.serving_step()
            with torch.no_grad():
                logits = plain_logits("traditional", net, torch.from_numpy(boxed).cuda())
            logits = logits.reshape(batch, -1, logits.shape[-1])[:len(chunk)].reshape(
                -1, logits.shape[-1])
            m, o, g = compare_masks(torch.from_numpy(pngs[c0:c0 + len(chunk)]).cuda(), logits,
                                    SERVE_MARGIN)
            mism, outside, need = max(mism, m), outside + o, max(need, g)
            del logits
        same = float((pngs == np.concatenate(ref)).mean())
        check(mism <= SERVE_MISMATCH, f"predict_dir_batched mask mismatch {mism:.4f}")
        check(outside == 0, f"predict_dir_batched: {outside} flips outside the margin")
        print(json.dumps({"tools": "predict_dir_batched", "model": "traditional", "images": n,
                          "batch": batch, "size": size, "loader": route,
                          "img_per_s_end_to_end": n / dt, "seconds": dt, "launches": counts,
                          "agreement_with_batch_infer_on_pil_copies": same,
                          "mask_mismatch_vs_plain": mism, "largest_flip_gap": need,
                          "gpu": card}), flush=True)

        # predict_video_batched: the submission model on a 20-frame 256^2
        # MJPG clip at batch 8; the blend runs on the card (3 batches)
        clip = str(tmp / "clip.avi")
        writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (size, size))
        if not writer.isOpened():
            raise RuntimeError("cv2 cannot write an MJPG clip")
        for _ in range(20):
            writer.write(_seeded_image(rng, size, size))
        writer.release()
        uv = build_wrapper("ultralight_large_optimized")
        uv.batch_infer(np.zeros((8, size, size, 3), np.uint8))  # cuDNN plans
        t0 = time.perf_counter()
        done, counts = counted({"argmax_mask": 3, "mask_palette": 3}, "predict_video_batched",
                               lambda: P.predict_video_batched(uv, clip, str(tmp / "out.avi"),
                                                               batch_size=8))
        dt = time.perf_counter() - t0
        add("ultralight_large_optimized", counts)
        cap = cv2.VideoCapture(str(tmp / "out.avi"))
        written = 0
        while cap.read()[0]:
            written += 1
        cap.release()
        check(done == 20 and written == 20, f"predict_video_batched: {done} done, {written} written")
        # #8's device time in predict_video_batched: its three launches, read by the
        # profiler over a second run (not the timed one)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity

        def second_run():
            P.predict_video_batched(uv, clip, str(tmp / "out2.avi"), batch_size=8)
            torch.cuda.synchronize()

        prof = profiled(second_run, [ProfilerActivity.CUDA])
        pal = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == DeviceType.CUDA and "palette_kernel" in e.name]
        check(len(pal) == 3, f"predict_video_batched: {len(pal)} palette kernels in the profile")
        print(json.dumps({"tools": "predict_video_batched", "model": "ultralight_large_optimized",
                          "frames": done, "written": written, "batch": 8, "size": size,
                          "frames_per_s_end_to_end": done / dt, "launches": counts,
                          "mask_palette_device_ms": pal, "gpu": card}), flush=True)

        # evaluate over 8 images with ground-truth PNGs, against the CPU
        # float32 path on the same seeded weights
        ev, gt_dir = tmp / "eval", tmp / "gt"
        ev.mkdir()
        gt_dir.mkdir()
        ids = [f"e{i}" for i in range(8)]
        for name in ids:
            Image.fromarray(_seeded_image(rng, 300, 200)).save(ev / f"{name}.jpg", quality=90)
            gt = rng.integers(0, 4, (200, 300)).astype(np.uint8)
            gt[:4] = 255
            Image.fromarray(gt).save(gt_dir / f"{name}.png")
        res, counts = counted({"normalize_images": 8}, "evaluate", lambda: evaluate(
            u, ids, str(gt_dir), 4, image_dir=str(ev), pred_dir=str(tmp / "pred"), verbose=False))
        add("traditional", counts)
        res_cpu = evaluate(build_wrapper("traditional", cuda=False), ids, str(gt_dir), 4,
                           image_dir=str(ev), pred_dir=str(tmp / "pred_cpu"), verbose=False)
        flips = np.mean([np.mean(np.asarray(Image.open(tmp / "pred" / f"{i}.png"))
                                 != np.asarray(Image.open(tmp / "pred_cpu" / f"{i}.png")))
                         for i in ids])
        d_miou = abs(res["miou"] - res_cpu["miou"])
        check(int(res["hist"].sum()) == 8 * 196 * 300, f"evaluate counted {res['hist'].sum()}")
        check(flips <= SERVE_MISMATCH, f"evaluate masks vs CPU f32 differ on {flips:.4f}")
        check(d_miou <= SERVE_MISMATCH, f"evaluate mIoU {res['miou']:.5f} vs CPU f32 "
                                        f"{res_cpu['miou']:.5f}")
        print(json.dumps({"tools": "evaluate", "model": "traditional", "images": 8,
                          "miou": res["miou"], "miou_cpu_f32": res_cpu["miou"],
                          "mask_mismatch_vs_cpu_f32": float(flips), "launches": counts,
                          "gpu": card}), flush=True)

        # the CLI in the process, its standard output captured
        def quiet(argv):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(argv)
            return buf.getvalue()

        text, counts = counted({"final_argmax_hist": 2}, "cli predict", lambda: quiet([
            "predict", "--preset", "traditional", "--mode", "dir_batched", "--input",
            str(img_dir), "--output", str(tmp / "cli"), "--batch-size", str(batch)]))
        add("traditional", counts)
        cli_pngs = np.stack([np.asarray(Image.open(tmp / "cli" / (Path(nm).stem + ".png")))
                             for nm in names])
        check("processed 40 images" in text, f"cli predict said {text!r}")
        cli_same = bool(np.array_equal(cli_pngs, pngs))
        check(cli_same, "cli predict PNGs != predict_dir_batched's")
        (tmp / "val.txt").write_text("\n".join(ids))
        text, counts = counted({"normalize_images": 8}, "cli miou", lambda: quiet([
            "miou", "--preset", "traditional", "--split", str(tmp / "val.txt"),
            "--image-dir", str(ev), "--gt-dir", str(gt_dir)]))
        add("traditional", counts)
        check(f"mIoU: {100 * res['miou']:.2f}" in text, f"cli miou said {text!r}")
        print(json.dumps({"tools": "cli", "predict_dir_batched_pngs_equal": cli_same,
                          "miou_line": text.strip().splitlines()[-1],
                          "gpu": card}), flush=True)
    print(f"phase 5: tools in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return totals


# the float32 forward of the export and of the quantized bundle (JAX's
# float branch): the float32 instantiations of the kernels the eval forward
# reaches, each upsample kernel once a decoder stage and once in the head
EXPORT = {
    "unet_vgg": {"vgg_stem_f32": 1, "vgg_block_f32": 4, "unetup_f32": 4, "upsample2x_f32": 4},
    "self_net": {"vgg_stem_f32": 1, "vgg_block_f32": 4, "unetup_f32": 4, "upsample2x_f32": 5,
                 "upconv_f32": 1},
}
# the exported programs' probabilities from the plain float32 forward's:
# about 4x the readings on an H100 (2.46e-5 unet_vgg, 1.33e-5 self_net)
EXPORT_PROBS_ABS_TOL = 1e-4
# get_miou_png's single-image forward (bf16) at 512² for unet_vgg, 256² for
# traditional
MIOU_PNG = {"unet_vgg": SINGLE[("unet_vgg", SIZE, 20)],
            "traditional": SINGLE[("traditional", DATAB_SIZE, 50)]}


def export_case(model: str, card: str, tmp: Path, totals: dict, add):
    """``cli export`` of ``model`` (the ``voc_vgg`` preset) at 512² on the
    card, loaded back and run on a seeded float32 image: its launches
    (those of the live float32 forward), its probabilities against the live
    forward's, the logits and probabilities against the plain float32
    forward's on the card (TF32 off), and its graph (the kernels'
    operators, no convolution of aten)."""
    import contextlib
    import io

    from tpu_unet_torch import cli
    from tpu_unet_torch.configs.infer_presets import build_wrapper
    from tpu_unet_torch.infer.wrapper import input_res_logits
    from tpu_unet_torch.kernels import tf32
    from tpu_unet_torch.tools.export import ProbsForward, load_program

    path = tmp / f"{model}.pt2"
    argv = ["export", "--preset", "voc_vgg", "--out", str(path)]
    if model != "unet_vgg":
        argv += ["--model", model]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        _, counts = counted({}, f"cli export {model}", lambda: cli.main(argv))
    t_export = time.perf_counter() - t0
    check("torch.export program saved to" in buf.getvalue(), f"cli export said {buf.getvalue()!r}")
    program = torch.export.load(str(path))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    ops = {t: targets.count(t) for t in targets if t.startswith("tpu_unet_torch.")}
    want_ops = {"tpu_unet_torch.vgg_stem.default": 1, "tpu_unet_torch.vgg_block.default": 4,
                "tpu_unet_torch.unetup.default": 4}
    if model == "self_net":
        want_ops["tpu_unet_torch.upconv.default"] = 1
    check(ops == want_ops, f"export {model}: the graph's kernel operators {ops} != {want_ops}")
    stand_ins = [t for t in targets if "conv" in t and not t.startswith("tpu_unet_torch.")]
    check(not stand_ins, f"export {model}: {stand_ins} in the graph where the kernels run")
    del program

    x = torch.from_numpy(np.random.default_rng(7).random((1, SIZE, SIZE, 3), np.float32)).cuda()
    run = load_program(str(path))
    run(x)  # warm-up
    out, counts = counted(EXPORT[model], f"exported {model}", lambda: run(x))
    add(model, counts)
    u = build_wrapper("voc_vgg", model=model)
    live_fn = ProbsForward(u.net).eval()
    with torch.no_grad():
        live, live_counts = counted(EXPORT[model], f"live float32 {model}", lambda: live_fn(x))
        logits = input_res_logits(u.net(x), x.shape[1:3])
        with plain_on_card():
            plain_logits = input_res_logits(u.net(x), x.shape[1:3])
    bit_equal = bool(torch.equal(out, live))
    check(bit_equal, f"export {model}: probabilities differ from the live forward's by "
                     f"{(out - live).abs().max().item():.3e}")
    # the program is the live forward, bit for bit; the kernels are held
    # to the plain float32 forward on the logits, relative to their scale
    # (a wrong kernel moves them by O(1) of it, TF32 by ~1e-3), and on the
    # probabilities against EXPORT_PROBS_ABS_TOL
    _, lrel = rel_err(logits, plain_logits)
    check(lrel <= tf32.CONV_REL_TOL,
          f"export {model}: logits {lrel:.3e} of their scale from the plain float32 forward")
    err = (out - torch.softmax(plain_logits, -1)).abs().max().item()
    check(err <= EXPORT_PROBS_ABS_TOL,
          f"export {model}: probabilities {err:.3e} from the plain float32 forward")
    check(tuple(out.shape) == (1, SIZE, SIZE, 21) and out.dtype == torch.float32
          and bool(torch.isfinite(out).all())
          and (out.sum(-1) - 1).abs().max().item() < 1e-4, f"export {model}: output")
    ms = time_ms(lambda: run(x))
    with torch.no_grad():
        live_ms = time_ms(lambda: live_fn(x))
    print(json.dumps({"tools": "export", "model": model, "size": SIZE,
                      "bytes": path.stat().st_size, "export_s": t_export,
                      "graph_kernel_ops": ops, "launches": counts,
                      "equals_live_forward": bit_equal,
                      "logits_rel_err_vs_plain_f32": lrel, "logits_bound": tf32.CONV_REL_TOL,
                      "max_abs_err_vs_plain_f32": err, "bound": EXPORT_PROBS_ABS_TOL,
                      "program_ms": ms, "live_ms": live_ms, "gpu": card}), flush=True)
    del u, live_fn, run
    torch.cuda.empty_cache()


def quantized_case(card: str, add):
    """``quantized_apply`` of unet_vgg at 512², batch 8, on the card
    (float32 through the float32 kernels) against the plain float32
    forward with the same dequantized weights; the int8 / float32 bytes."""
    from tpu_unet_torch.configs.infer_presets import build_wrapper
    from tpu_unet_torch.kernels import tf32
    from tpu_unet_torch.tools.quantization import (dequantize_params, quantization_report,
                                                   quantize_variables, quantized_apply)

    u = build_wrapper("voc_vgg")
    bundle = quantize_variables(u.net)
    report = quantization_report(u.net)
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.rand((BATCH, SIZE, SIZE, 3), generator=gen, device="cuda")
    quantized_apply(u.net, bundle, x)  # warm-up
    out, counts = counted(EXPORT["unet_vgg"], "quantized_apply unet_vgg",
                          lambda: quantized_apply(u.net, bundle, x))
    add("unet_vgg", counts)
    state = {**dequantize_params(bundle["quantized"], bundle["rest"]), **bundle["batch_stats"]}
    with torch.no_grad(), plain_on_card():
        ref = torch.func.functional_call(u.net, state, (x,))
    err, rel = rel_err(out, ref)
    check(rel <= tf32.CONV_REL_TOL, f"quantized_apply: {rel:.3e} of the plain float32 logits")
    w = u.net.vgg.features[0].weight
    q = bundle["quantized"]["vgg.features.0.weight"]
    check(q["values"].dtype == torch.int8 and q["values"].device == w.device
          and q["scale"].shape == (w.shape[0], 1, 1, 1), "quantized bundle layout")
    print(json.dumps({"tools": "quantized_apply", "model": "unet_vgg", "batch": BATCH,
                      "size": SIZE, "launches": counts, "max_abs_err": err, "rel_err": rel,
                      "bound": tf32.CONV_REL_TOL, "ms": time_ms(lambda: quantized_apply(
                          u.net, bundle, x), 3),
                      "f32_bytes": report["f32_bytes"], "int8_bytes": report["int8_bytes"],
                      "int8_over_f32": report["ratio"], "gpu": card}), flush=True)
    del u, bundle, state, out, ref
    torch.cuda.empty_cache()


def phase_export_tools(card: str):
    """Phase 5b, the rest of the CLI and tools: ``cli summary``, ``cli
    export`` of unet_vgg and self_net, ``quantized_apply``, the competition
    export (``export_results``, ``pack_submission``, ``check_nan_in_npy``).
    Returns the launches of the counted runs by ``kernels`` entry."""
    import contextlib
    import io
    import tempfile

    from PIL import Image

    from tpu_unet_torch import cli
    from tpu_unet_torch.configs.infer_presets import build_wrapper
    from tpu_unet_torch.tools.results_export import (METRICS_FILE, check_nan_in_npy,
                                                     export_results, pack_submission)

    totals: dict = {}

    def add(model, counts):
        for k, v in counts.items():
            totals[entry(model, k)] = totals.get(entry(model, k), 0) + v

    t_phase = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["summary", "--model", "unet_vgg", "--size", "512"])
    check("Total params:  24,892,437" in buf.getvalue(), f"cli summary said {buf.getvalue()!r}")
    print(json.dumps({"tools": "summary", "lines": buf.getvalue().splitlines(),
                      "seconds": time.perf_counter() - t_phase}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for model in ("unet_vgg", "self_net"):
            export_case(model, card, tmp, totals, add)
        quantized_case(card, add)

        # the competition export: two wrappers over four seeded images
        rng = np.random.default_rng(12)
        img_dir, gt_dir = tmp / "img", tmp / "gt"
        img_dir.mkdir()
        gt_dir.mkdir()
        ids = [f"c{i}" for i in range(4)]
        for name in ids:
            Image.fromarray(_seeded_image(rng, 300, 200)).save(img_dir / f"{name}.jpg", quality=90)
            Image.fromarray(rng.integers(0, 4, (200, 300)).astype(np.uint8)).save(
                gt_dir / f"{name}.png")
        models = {"UNet": build_wrapper("voc_vgg", num_classes=4),
                  "OursModel": build_wrapper("traditional")}
        iters = 5
        calls = len(ids) + 1 + iters  # the images, calculate_fps' warm-up and loop
        expect = {}
        for m in MIOU_PNG.values():
            for k, v in m.items():
                expect[k] = expect.get(k, 0) + v * calls
        t0 = time.perf_counter()
        metrics, counts = counted(expect, "export_results", lambda: export_results(
            models, ids, str(img_dir), str(gt_dir), 4, str(tmp / "sub"), fps_iters=iters))
        t_res = time.perf_counter() - t0
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        text = (tmp / "sub" / METRICS_FILE).read_text(encoding="utf-8")
        check(text == repr(metrics), "export_results: the metrics file is not the dict's repr")
        for name, m in metrics.items():
            ok = all(np.isfinite(v) for v in m.values()) and m["FPS"] > 0 and 0 <= m["mIoU"] <= 1
            check(ok and len(list((tmp / "sub" / name).glob("*.npy"))) == 2 * len(ids),
                  f"export_results {name}: {m}")
        check(metrics["UNet"]["Parameters"] == 24_891_332
              and metrics["OursModel"]["Parameters"] == 1_949_796,
              f"export_results parameters {[m['Parameters'] for m in metrics.values()]}")
        archive = pack_submission(str(tmp / "sub"), str(tmp / "submission.zip"))
        nan = [check_nan_in_npy(str(tmp / "sub" / name)) for name in metrics]
        check(Path(archive).stat().st_size > 0 and nan == [0, 0], f"pack / NaN audit {nan}")
        print(json.dumps({"tools": "export_results", "models": {
            k: {"model": u._model_name(), "size": u.input_shape[0]} for k, u in models.items()},
            "images": len(ids), "metrics": metrics, "seconds": t_res, "launches": counts,
            "archive_bytes": Path(archive).stat().st_size, "nan_files": nan, "gpu": card}),
            flush=True)
        del models
        torch.cuda.empty_cache()
    print(f"phase 5b: the rest of the CLI and tools in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return totals


# the unet_vgg training step's launches under each route
# (StepConfig.train_route); every other kernel 0.  "paired" (the default,
# JAX's TPU configuration) runs the stem (#2 / #20), block 2 (#21 / #22),
# blocks 3-5 (#23 / #24) and all four decoder stages (#1 and the whole stage
# backward) through their kernels; "fused" trains the encoder through cuDNN
# under autograd, up1 through #1 and #13 and the F >= 128 stages plain.  A
# stage's upsample kernel runs in #1 and again in unetup_wgrad
TRAIN_STEP = {
    "paired": {"vgg_stem": 1, "vgg_block2_fwd": 1, "vgg_block3_fwd": 3, "vgg_stem_bwd": 1,
               "vgg_block2_bwd": 1, "vgg_block3_bwd": 3, "unetup": 4, "upsample2x": 8,
               "unetup_bwd": 4, "unetup_wgrad": 4, "upsample_adjoint": 4,
               "final_ce_dice_fwd": 1, "final_ce_dice_bwd": 1},
    "fused": {"unetup": 1, "upsample2x": 1, "unetup_bwd": 1, "final_ce_dice_fwd": 1,
              "final_ce_dice_bwd": 1},
}


def rect_batch(gen, n, size, classes, device):
    """Seeded rectangles on a gray field: each image one rectangle of its
    class's colour, the label its class inside and 0 outside, a 4-pixel
    border of 255 (the VOC ignore label)."""
    palette = torch.randint(0, 256, (classes, 3), generator=torch.Generator().manual_seed(0),
                            dtype=torch.uint8).to(device)
    imgs = torch.full((n, size, size, 3), 128, dtype=torch.uint8, device=device)
    lbl = torch.zeros((n, size, size), dtype=torch.int32, device=device)
    r = torch.randint(0, 1 << 30, (n, 5), generator=gen).tolist()
    for i, (c, y0, x0, h, w) in enumerate(r):
        c = 1 + c % (classes - 1)
        h, w = size // 4 + h % (size // 4), size // 4 + w % (size // 4)
        y0, x0 = y0 % (size - h), x0 % (size - w)
        imgs[i, y0:y0 + h, x0:x0 + w] = palette[c]
        lbl[i, y0:y0 + h, x0:x0 + w] = c
    lbl[:, :4], lbl[:, -4:], lbl[:, :, :4], lbl[:, :, -4:] = 255, 255, 255, 255
    return {"image": imgs, "label": lbl}


def plain_step(net, batch, num_classes, cls_weights, dtype=torch.bfloat16, dice=True):
    """Loss, float32 gradients and the running statistics after one bf16
    (or ``dtype``) step of a canonical UNet (``unet_vgg``,
    ``unet_resnet50``, ``self_net``) composed here of the plain modules and
    ``train/losses.py`` under autograd, no kernel: a copy of ``net`` in
    ``dtype`` (a cast's backward is the gradient's cast, so these are the
    gradients of the float32 masters), ResNet50's batch norm on the batch
    statistics, self_net's 2x logits resized to the target by the losses;
    CE, + dice with ``dice``.  ``tests/test_torch_gpu.py`` holds its train
    steps to this same reference."""
    from tpu_unet_torch.kernels.decoder_fuse import unetup_plain
    from tpu_unet_torch.kernels.upconv import upconv_plain
    from tpu_unet_torch.train.losses import ce_loss, dice_loss, one_hot
    from tpu_unet_torch.train.step import prepare_batch

    n16 = copy.deepcopy(net)
    for p in n16.parameters():
        p.data = p.data.to(dtype)
    imgs, target = prepare_batch(batch, dtype, "cuda")
    # the encoders' plain compositions
    feats = n16.vgg(imgs, True, "fused") if n16.backbone == "vgg" else n16.resnet(imgs, True)
    up = feats[4]
    for i, skip in zip((4, 3, 2, 1), feats[3::-1]):
        m = getattr(n16, f"up_concat{i}")
        up = unetup_plain(skip, up, m.conv1.weight, m.conv1.bias, m.conv2.weight, m.conv2.bias)
    if n16.up_conv is not None:
        c1, c2 = n16.up_conv[1], n16.up_conv[3]
        up = upconv_plain(up, c1.weight, c1.bias, c2.weight, c2.bias)
    logits = (up @ n16.final.weight.reshape(num_classes, -1).t() + n16.final.bias).float()
    loss = ce_loss(logits, target, cls_weights, num_classes)
    if dice:
        loss = loss + dice_loss(logits, one_hot(target, num_classes))
    loss.backward()
    return (loss.item(), {k: p.grad.float() for k, p in n16.named_parameters()},
            bn_stats(n16))


def phase_train(card: str):
    """(a) the unet_vgg training step at 512², batch 8, 21 classes, bf16,
    CE + dice, Adam; (e)-(g) unet_resnet50 and self_net; (b) ``cli train``
    of the ``train_py`` preset over a seeded VOC-layout directory, a
    resume, and serving from the trained weights; (c), (d) the DataB
    steps and ``cli train``.  Returns the launches of the counted runs."""
    from tpu_unet_torch.models.registry import build_model, init_model
    from tpu_unet_torch.train import step as tstep

    totals: dict = {}
    t_phase = time.perf_counter()
    classes = CLASSES["unet_vgg"]
    cw = tuple(1.0 for _ in range(classes))
    cfg = tstep.StepConfig(classes, cw, use_dice=True, compute_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(6)
    batch = rect_batch(gen, BATCH, SIZE, classes, "cuda")
    init = init_model(build_model("unet_vgg", classes), seed=0).cuda()

    # the plain step first, from the initial weights
    ploss, pgrads, _ = plain_step(init, batch, classes, cw)
    for route in ("paired", "fused"):
        rcfg = dataclasses.replace(cfg, train_route=route)
        net = copy.deepcopy(init)
        state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9))
        fn = tstep.make_train_step(net, rcfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (state, m), counts = counted(TRAIN_STEP[route], f"train step ({route})",
                                     lambda: fn(state, batch, 1e-4))
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        loss0 = m["loss"].item()
        lrel = abs(loss0 - ploss) / abs(ploss)
        check(lrel <= 1e-3, f"train step ({route}) loss {loss0} vs plain step {ploss}: "
                            f"rel {lrel:.3g}")
        grad_stats, worst_cos, worst_rel = {}, 1.0, 0.0
        for k, p in net.named_parameters():
            a, b = p.grad.float().ravel(), pgrads[k].ravel()
            cos = (a @ b / (a.norm() * b.norm()).clamp_min(1e-30)).item()
            rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            grad_stats[k] = [round(cos, 6), rel]
            worst_cos, worst_rel = min(worst_cos, cos), max(worst_rel, rel)
            check(cos >= 0.99 and rel <= 5e-2,
                  f"gradient of {k} ({route}): cosine {cos:.5f}, rel err {rel:.3g}")
        print(json.dumps({"train_grads_vs_plain_step": grad_stats, "route": route}),
              flush=True)

        step = lambda: fn(state, batch, 1e-4)  # noqa: E731
        step_ms = time_ms(step, reps=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        profile = device_breakdown(lambda _net, _imgs: step(), None, None)
        if route == "paired":  # every stage's upsample adjoint is the kernel's
            check(profile["index_add_ms"] == 0.0,
                  f"train step (paired): index_add kernels ran {profile['index_add_ms']} ms")
        print(json.dumps({
            "train_step": "unet_vgg", "train_route": route, "batch": BATCH, "size": SIZE,
            "classes": classes, "dtype": "bf16", "recipe": "CE + dice, Adam",
            "launches": counts, "step_ms_events": step_ms, "img_per_s": BATCH * 10 / host,
            "step_ms_host": host / 10 * 1e3, "peak_mem_gib": peak, "profile": profile,
            "loss": loss0, "loss_plain_step": ploss, "loss_rel_err_vs_plain": lrel,
            "worst_grad_cosine": worst_cos, "worst_grad_rel_err": worst_rel,
            "gpu": card}), flush=True)
        del net, state, fn, step
    del pgrads

    # the card (default route) against the CPU float32 path: one step at
    # batch 1, 128²
    small = rect_batch(gen, 1, 128, classes, "cuda")
    card_net = copy.deepcopy(init)
    cpu_net = copy.deepcopy(init).cpu()
    _, mc = tstep.make_train_step(card_net, cfg)(
        tstep.TrainState(card_net, tstep.make_optimizer(card_net)), small, 1e-4)
    f32 = tstep.StepConfig(classes, cw, use_dice=True)
    _, mcpu = tstep.make_train_step(cpu_net, f32)(
        tstep.TrainState(cpu_net, tstep.make_optimizer(cpu_net)),
        {k: v.cpu() for k, v in small.items()}, 1e-4)
    cpu_rel = abs(mc["loss"].item() - mcpu["loss"].item()) / abs(mcpu["loss"].item())
    check(cpu_rel <= 2e-2, f"train step 128² vs CPU f32: loss rel {cpu_rel:.3g} > 2e-2")
    del card_net, cpu_net

    # it learns: 20 steps on one fixed batch from the initial weights
    lnet = copy.deepcopy(init)
    lstate = tstep.TrainState(lnet, tstep.make_optimizer(lnet, "adam", 0.9))
    lfn = tstep.make_train_step(lnet, cfg)
    losses = [lfn(lstate, batch, 1e-4)[1]["loss"].item() for _ in range(20)]
    check(losses[-1] <= 0.9 * losses[0], f"20 steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
                                         "not 10% lower")
    del lnet, lstate, init
    print(json.dumps({
        "train_step": "unet_vgg", "train_route": cfg.train_route,
        "loss_rel_err_vs_cpu_f32_128px": cpu_rel, "losses_20_steps": losses,
        "gpu": card}), flush=True)
    torch.cuda.empty_cache()
    for part in (rn50_training, self_net_training, fit_voc_resnet50, cli_train, datab_training,
                 cli_train_datab, zoo_training, repvgg_fold):
        t_part = time.perf_counter()
        for k, v in part(card).items():
            totals[k] = totals.get(k, 0) + v
        print(f"phase 6: {part.__name__} in {time.perf_counter() - t_part:.1f} s", flush=True)
    print(f"phase 6: training in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return totals


# ---- phase 6h / 6i: the last eight registry models' training, and the fold ----

def zoo_recipe(name: str, dtype=torch.bfloat16):
    """(batch, StepConfig, lr, weight decay) of a zoo model's step at 256²,
    4 classes: its preset's (batch ``unfreeze_batch_size``, loss, class
    weights, aux weights) where the JAX package has one, else the ladder
    presets' (``ultralight_large_optimized``: batch 32, focal + dice with
    (1, 15, 1.5, 2), Adam 1e-4, weight decay 1e-4); the lr as ``fit`` gives
    it for that batch."""
    from tpu_unet_torch.configs.presets import PRESETS, get_preset
    from tpu_unet_torch.train import step as tstep
    from tpu_unet_torch.train.schedules import adaptive_lr

    p = get_preset(name if name in PRESETS else "ultralight_large_optimized")
    n = p.unfreeze_batch_size
    cfg = tstep.StepConfig(4, p.resolved_cls_weights(), use_focal=p.focal_loss,
                           use_dice=p.dice_loss, aux_weights=tuple(p.aux_weights),
                           compute_dtype=dtype)
    return n, cfg, adaptive_lr(p.init_lr, p.min_lr, n, p.optimizer_type)[0], p.weight_decay


def plain_zoo_step(net, batch, cfg, seed, dtype=torch.bfloat16):
    """Loss, float32 gradients (of the parameters the loss reaches) and the
    running statistics after one step composed here of a copy of ``net`` in
    ``dtype`` in train mode (its dropout drawn from a generator seeded
    ``seed``) and ``train/step.py::_total_loss``, the plain losses of every
    head weighted by ``cfg.aux_weights`` (the first head's alone without),
    under autograd: no kernel."""
    from tpu_unet_torch.train.losses import one_hot
    from tpu_unet_torch.train.step import _total_loss, prepare_batch

    n16 = copy.deepcopy(net)
    for p in n16.parameters():
        p.data = p.data.to(dtype)
    imgs, target = prepare_batch(batch, dtype, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    outputs = n16(imgs, train=True, generator=gen)
    loss, _ = _total_loss(outputs, target, one_hot(target, cfg.num_classes), cfg)
    loss.backward()
    return (loss.item(), {k: p.grad.float() for k, p in n16.named_parameters()
                          if p.grad is not None}, bn_stats(n16))


def bn_fed_biases(net):
    """The conv biases of the zoo's blocks that the next batch norm cancels
    (their exact gradient is 0, so both steps give noise): LightConvBlock's
    three, LightSKBlock's and RepVGGStem's 1×1 reduce, DWSeparableBNReLU's
    two."""
    from tpu_unet_torch.nn import blocks

    parts = ((blocks.LightConvBlock, ("conv.0", "conv.3.depthwise", "conv.3.pointwise")),
             (blocks.LightSKBlock, ("conv1.0",)), (blocks.RepVGGStem, ("conv.0",)),
             (blocks.DWSeparableBNReLU, ("depthwise", "pointwise")))
    params = dict(net.named_parameters())
    return {f"{name}.{sub}.bias" for name, m in net.named_modules() for cls, subs in parts
            if isinstance(m, cls) for sub in subs} & set(params)


def zoo_step(name: str, card: str):
    """Phase 6h for one zoo model: its bf16 step (``zoo_recipe``) from
    ``init_model(seed=0)`` weights on seeded rectangles, counted (#25 / #26
    once a head), against ``plain_zoo_step`` with the same dropout
    generator: the loss within 1e-3, every gradient the loss reaches at
    cosine >= 0.99 (the biases a batch norm cancels left out), the running
    statistics within 1e-2 and moved; step time, img/s, peak memory and a
    profile.  Returns the launches."""
    from tpu_unet_torch.models.registry import build_model, init_model
    from tpu_unet_torch.train import step as tstep

    t_model = time.perf_counter()
    n, cfg, lr, wd = zoo_recipe(name)
    heads = len(cfg.aux_weights) or 1
    batch = rect_batch(torch.Generator().manual_seed(21), n, DATAB_SIZE, 4, "cuda")
    init = init_model(build_model(name, 4), seed=0).cuda()
    before = bn_stats(init)
    ploss, pgrads, pstats = plain_zoo_step(init, batch, cfg, seed=5)
    net = copy.deepcopy(init)
    state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9, wd))
    fn = tstep.make_train_step(net, cfg)
    dgen = torch.Generator(device="cuda").manual_seed(5)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (state, m), counts = counted({"ce_dice_fwd": heads, "ce_dice_bwd": heads},
                                 f"{name} train step", lambda: fn(state, batch, lr, dgen))
    loss0 = m["loss"].item()
    lrel = abs(loss0 - ploss) / abs(ploss)
    check(lrel <= 1e-3, f"{name} step loss {loss0} vs plain step {ploss}: rel {lrel:.3g}")
    noise, unreached, worst_cos = bn_fed_biases(net), [], 1.0
    for k, p in net.named_parameters():
        if k not in pgrads:  # the loss does not reach it (an aux head, CRFS's conv_g)
            unreached.append(k)
            continue
        if k in noise:
            continue
        a, b = p.grad.float().ravel(), pgrads[k].ravel()
        cos = (a @ b / (a.norm() * b.norm()).clamp_min(1e-30)).item()
        worst_cos = min(worst_cos, cos)
        check(cos >= 0.99, f"{name} gradient of {k}: cosine {cos:.5f} against the plain step")
    stats = bn_stats(net)
    stat_rel = max(((stats[k] - v).abs().max() / v.abs().max().clamp_min(1e-30)).item()
                   for k, v in pstats.items())
    moved = min(((stats[k] - v).abs().max()).item() for k, v in before.items())
    check(stat_rel <= 1e-2 and moved > 0,
          f"{name} running statistics: rel err {stat_rel:.3g} vs plain, least move {moved:.3g}")
    del pgrads, pstats
    step = lambda: fn(state, batch, lr, dgen)  # noqa: E731 (warm: the counted step)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(3):  # the same three steps by events and by the host's clock
        step()
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / 3
    step_ms = start.elapsed_time(end) / 3
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile = device_breakdown(lambda _net, _imgs: step(), None, None, steps=1)
    print(json.dumps({
        "train_step": name, "batch": n, "size": DATAB_SIZE, "classes": 4, "dtype": "bf16",
        "recipe": f"{'focal' if cfg.use_focal else 'CE'}{' + dice' if cfg.use_dice else ''}, "
                  f"w={list(cfg.cls_weights)}, aux={list(cfg.aux_weights)}, Adam lr {lr:g} "
                  f"wd {wd:g}", "launches": counts, "step_ms_events": step_ms,
        "img_per_s": n / host, "step_ms_host": host * 1e3, "peak_mem_gib": peak,
        "device_ms": profile["device_ms_per_step"], "idle_share": profile["idle_share"],
        "loss_kernels_ms": profile["loss_kernels_ms"], "top_kernels_ms": profile["top_kernels_ms"],
        "loss": loss0, "loss_plain_step": ploss, "loss_rel_err_vs_plain": lrel,
        "worst_grad_cosine": worst_cos, "params_unreached_by_loss": unreached,
        "running_stats_rel_err_vs_plain": stat_rel,
        "wall_s": time.perf_counter() - t_model, "gpu": card}), flush=True)
    del net, state, fn, step, init
    torch.cuda.empty_cache()
    return counts


def zoo_training(card: str):
    """Phase 6h: the zoo models' bf16 steps; returns their launches."""
    totals: dict = {}
    t0 = time.perf_counter()
    for name in ZOO:
        for k, v in zoo_step(name, card).items():
            totals[k] = totals.get(k, 0) + v
    print(f"phase 6h: zoo training in {time.perf_counter() - t0:.1f} s", flush=True)
    return totals


# the masks of the deploy form against the training form's logits: equal
# wherever the top-1/top-2 gap exceeds this share of the logit scale (both
# bf16 on the card, the folded 3x3 summing in another order)
FOLD_MARGIN = 5e-2


def repvgg_fold(card: str):
    """Phase 6i: ``repvgg_segnet`` with seeded batch norms saved, folded by
    ``cli fold``, both checkpoints served by ``Unet(model_path=...)`` (the
    folded one builds the deploy form) on a seeded 32 x 256² batch: the
    deploy masks against the training form's logits (plain PyTorch on the
    card), within FOLD_MARGIN; the two forms' float32 logits (TF32 off);
    both serving steps' times.  Returns the launches of the deploy form's
    counted step."""
    import io
    import tempfile

    from tpu_unet_torch import cli
    from tpu_unet_torch.core.precision import normalize_u8
    from tpu_unet_torch.infer.wrapper import Unet
    from tpu_unet_torch.models.registry import build_model, init_model

    net = init_model(build_model("repvgg_segnet", 4), seed=0)
    g = torch.Generator().manual_seed(23)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(1 + 0.2 * torch.randn(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
    shape = [DATAB_SIZE, DATAB_SIZE]
    with tempfile.TemporaryDirectory() as tmp:
        train_path, deploy_path = Path(tmp) / "train.pth", Path(tmp) / "deploy.pth"
        torch.save(net.state_dict(), train_path)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["fold", "--model-path", str(train_path), "--out", str(deploy_path)])
        ut = Unet(model="repvgg_segnet", num_classes=4, input_shape=shape,
                  model_path=str(train_path))
        ud = Unet(model="repvgg_segnet", num_classes=4, input_shape=shape,
                  model_path=str(deploy_path))
    check(ud.net.enc1.conv[3].deploy and not ut.net.enc1.conv[3].deploy,
          "cli fold: the folded checkpoint did not build the deploy form")
    gen = torch.Generator(device="cuda").manual_seed(24)
    imgs = torch.randint(0, 256, (DATAB_BATCH, *shape, 3), generator=gen, device="cuda",
                         dtype=torch.uint8)
    fd, nd = ud.serving_step()
    ft, nt = ut.serving_step()
    fd(nd, imgs)
    (masks, _), counts = counted({"argmax_mask": 1}, "repvgg_segnet deploy serving",
                                 lambda: fd(nd, imgs))
    with torch.no_grad():
        logits = plain_logits("repvgg_segnet", nt, imgs)
        x = normalize_u8(imgs[:4], torch.float32)
        l32t, l32d = ut.net(x), ud.net(x)
    mism, outside, need = compare_masks(masks, logits, FOLD_MARGIN)
    check(outside == 0, f"repvgg_segnet deploy masks: {outside} flips outside {FOLD_MARGIN} "
                        "of the training form's logit scale")
    f32_rel = ((l32d - l32t).abs().max() / l32t.abs().max()).item()
    check(f32_rel <= 1e-4, f"repvgg_segnet deploy vs training form float32 logits: rel "
                           f"{f32_rel:.3g}")
    ms_d, ms_t = time_ms(lambda: fd(nd, imgs), reps=5), time_ms(lambda: ft(nt, imgs), reps=5)
    print(json.dumps({
        "repvgg_fold": "cli fold -> Unet(model_path=...)", "batch": DATAB_BATCH,
        "size": DATAB_SIZE, "launches": counts, "mask_mismatch_vs_training_form": mism,
        "flips_outside_margin": outside, "largest_flip_gap": need,
        "f32_logits_rel_err_vs_training_form": f32_rel,
        "serving_ms_events_deploy": ms_d, "serving_ms_events_training_form": ms_t,
        "img_per_s_deploy": DATAB_BATCH / ms_d * 1e3,
        "img_per_s_training_form": DATAB_BATCH / ms_t * 1e3, "gpu": card}), flush=True)
    del ut, ud, fd, nd, ft, nt, imgs, logits
    torch.cuda.empty_cache()
    return counts


# unet_resnet50's default-route step: its four decoder stages (#1, #13,
# unetup_wgrad, upsample_adjoint) and the up_conv head (#10 / #12) through
# their kernels, the loss through #27 / #29, ResNet50 through cuDNN; the
# upsample kernel twice a stage and twice in the head (its forward's and
# its backward's up)
RN50_STEP = {"unetup": 4, "upsample2x": 10, "unetup_bwd": 4, "unetup_wgrad": 4,
             "upsample_adjoint": 4,
             "upconv": 1, "upconv_bwd": 1, "final_ce_dice_fwd": 1, "final_ce_dice_bwd": 1}
# self_net's: unet_vgg's training encoder and decoder kernels, the head, and
# the plain losses on its 2x logits (no loss kernel, as JAX's loss_fn)
SELF_NET_STEP = {**{k: v for k, v in TRAIN_STEP["paired"].items()
                    if not k.startswith("final_")}, "upsample2x": 10, "upconv": 1,
                 "upconv_bwd": 1}


def canonical_step(name: str, card: str, expect: dict, seed: int):
    """One default-route step of ``name`` (21 classes, 512², batch 8, bf16,
    CE + dice, Adam 1e-4, the ``voc_resnet50`` recipe) from
    ``init_model(seed=0)`` weights, held to ``plain_step`` from the same
    weights: exact launches, loss within 1e-3, every gradient at a cosine
    ≥ 0.99, the running statistics within 1e-2 (and moved); then its time,
    rate, peak memory and profile.  Returns (initial model, batch, config,
    plain gradients, launches)."""
    from tpu_unet_torch.models.registry import build_model, init_model
    from tpu_unet_torch.train import step as tstep

    classes = CLASSES[name]
    cw = tuple(1.0 for _ in range(classes))
    cfg = tstep.StepConfig(classes, cw, use_dice=True, compute_dtype=torch.bfloat16)
    batch = rect_batch(torch.Generator().manual_seed(seed), BATCH, SIZE, classes, "cuda")
    init = init_model(build_model(name, classes), seed=0).cuda()
    before = bn_stats(init)
    ploss, pgrads, pstats = plain_step(init, batch, classes, cw)
    net = copy.deepcopy(init)
    state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9))
    fn = tstep.make_train_step(net, cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (state, m), counts = counted(expect, f"{name} train step", lambda: fn(state, batch, 1e-4))
    loss0 = m["loss"].item()
    lrel = abs(loss0 - ploss) / abs(ploss)
    check(lrel <= 1e-3, f"{name} step loss {loss0} vs plain step {ploss}: rel {lrel:.3g}")
    worst_cos, worst_rel = 1.0, 0.0
    for k, p in net.named_parameters():
        a, b = p.grad.float().ravel(), pgrads[k].ravel()
        cos = (a @ b / (a.norm() * b.norm()).clamp_min(1e-30)).item()
        worst_cos = min(worst_cos, cos)
        worst_rel = max(worst_rel, ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item())
        check(cos >= 0.99, f"{name} gradient of {k}: cosine {cos:.5f} against the plain step")
    stats = bn_stats(net)
    stat_rel = max((((stats[k] - v).abs().max() / v.abs().max().clamp_min(1e-30)).item()
                    for k, v in pstats.items()), default=0.0)
    moved = min((((stats[k] - v).abs().max()).item() for k, v in before.items()), default=1.0)
    check(stat_rel <= 1e-2 and moved > 0,
          f"{name} running statistics: rel err {stat_rel:.3g} vs plain, least move {moved:.3g}")

    step = lambda: fn(state, batch, 1e-4)  # noqa: E731
    step_ms = time_ms(step, reps=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile = device_breakdown(lambda _net, _imgs: step(), None, None)
    if name == "unet_resnet50":  # every adjoint of the decoder and head is a kernel's
        check(profile["index_add_ms"] == 0.0,
              f"{name} train step: index_add kernels ran {profile['index_add_ms']} ms")
    print(json.dumps({
        "train_step": name, "train_route": cfg.train_route, "batch": BATCH, "size": SIZE,
        "classes": classes, "dtype": "bf16", "recipe": "CE + dice, Adam 1e-4",
        "launches": counts, "step_ms_events": step_ms, "img_per_s": BATCH * 10 / host,
        "step_ms_host": host / 10 * 1e3, "peak_mem_gib": peak, "profile": profile,
        "loss": loss0, "loss_plain_step": ploss, "loss_rel_err_vs_plain": lrel,
        "worst_grad_cosine": worst_cos, "worst_grad_rel_err": worst_rel,
        "running_stats_rel_err_vs_plain": stat_rel, "gpu": card}), flush=True)
    del net, state, fn, step
    torch.cuda.empty_cache()
    return init, batch, cfg, pgrads, counts


def rn50_training(card: str):
    """Phase 6e: the unet_resnet50 step (``canonical_step``), one step of
    the freeze phase (``resnet.*`` frozen: no gradient, the running
    statistics still moved, the rest held to the plain step), one step at
    the preset's batch 16 with its peak memory, a 128^2 step at batch 4
    against the CPU float32 loss, 20 learning steps.  Returns the launches
    of the counted steps."""
    from tpu_unet_torch.train import step as tstep

    totals: dict = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    init, batch, cfg, pgrads, counts = canonical_step("unet_resnet50", card, RN50_STEP, seed=16)
    add(counts)
    before = bn_stats(init)

    net = copy.deepcopy(init)
    frozen = tstep.FREEZE_PREFIXES["unet_resnet50"]
    state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9, freeze_prefixes=frozen))
    _, counts = counted(RN50_STEP, "unet_resnet50 frozen step",
                        lambda: tstep.make_train_step(net, cfg)(state, batch, 1e-4))
    add(counts)
    worst_cos = 1.0
    for k, p in net.named_parameters():
        if k.startswith("resnet."):
            check(p.grad is None, f"frozen step: {k} has a gradient")
            continue
        a, b = p.grad.float().ravel(), pgrads[k].ravel()
        cos = (a @ b / (a.norm() * b.norm()).clamp_min(1e-30)).item()
        worst_cos = min(worst_cos, cos)
        check(cos >= 0.99, f"frozen step: gradient of {k}: cosine {cos:.5f}")
    after = bn_stats(net)
    moved = min(((after[k] - v).abs().max()).item() for k, v in before.items())
    check(moved > 0, f"frozen step: a running statistic did not move ({moved})")
    del net, state, pgrads

    # the preset's batch 16
    big = rect_batch(torch.Generator().manual_seed(17), 16, SIZE, CLASSES["unet_resnet50"], "cuda")
    net = copy.deepcopy(init)
    state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9))
    fn = tstep.make_train_step(net, cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (_, m16), counts = counted(RN50_STEP, "unet_resnet50 step at batch 16",
                               lambda: fn(state, big, 1e-4))
    add(counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn(state, big, 1e-4)
    torch.cuda.synchronize()
    b16_ms = (time.perf_counter() - t0) / 3 * 1e3
    peak16 = torch.cuda.max_memory_allocated() / 2**30
    check(bool(torch.isfinite(m16["loss"])), f"batch 16 step loss {m16['loss'].item()}")
    del net, state, fn, big
    torch.cuda.empty_cache()

    # the card against the CPU float32 path: one step at 128², batch 4
    small = rect_batch(torch.Generator().manual_seed(18), 4, 128, CLASSES["unet_resnet50"], "cuda")
    card_net, cpu_net = copy.deepcopy(init), copy.deepcopy(init).cpu()
    _, mc = tstep.make_train_step(card_net, cfg)(
        tstep.TrainState(card_net, tstep.make_optimizer(card_net)), small, 1e-4)
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    _, mcpu = tstep.make_train_step(cpu_net, f32)(
        tstep.TrainState(cpu_net, tstep.make_optimizer(cpu_net)),
        {k: v.cpu() for k, v in small.items()}, 1e-4)
    cpu_rel = abs(mc["loss"].item() - mcpu["loss"].item()) / abs(mcpu["loss"].item())
    check(cpu_rel <= 2e-2, f"unet_resnet50 128² step vs CPU f32: loss rel {cpu_rel:.3g} > 2e-2")
    del card_net, cpu_net

    # it learns: 20 steps on one fixed batch from the initial weights
    lnet = copy.deepcopy(init)
    lstate = tstep.TrainState(lnet, tstep.make_optimizer(lnet, "adam", 0.9))
    lfn = tstep.make_train_step(lnet, cfg)
    losses = [lfn(lstate, batch, 1e-4)[1]["loss"].item() for _ in range(20)]
    check(losses[-1] <= 0.9 * losses[0], f"unet_resnet50 20 steps: loss {losses[0]:.4f} -> "
                                         f"{losses[-1]:.4f}, not 10% lower")
    print(json.dumps({
        "train_step": "unet_resnet50", "frozen_step_worst_grad_cosine": worst_cos,
        "frozen_step_least_running_stat_move": moved, "batch16_step_ms_host": b16_ms,
        "batch16_img_per_s": 16e3 / b16_ms, "batch16_peak_mem_gib": peak16,
        "loss_rel_err_vs_cpu_f32_128px_b4": cpu_rel, "losses_20_steps": losses,
        "gpu": card}), flush=True)
    del lnet, lstate, lfn, init
    torch.cuda.empty_cache()
    return totals


def self_net_training(card: str):
    """Phase 6f: the self_net step (``canonical_step``): unet_vgg's training
    encoder and decoder kernels, the head through #10 / #12, the plain
    losses on its 2x logits.  Returns its launches."""
    init, *_, counts = canonical_step("self_net", card, SELF_NET_STEP, seed=19)
    del init
    torch.cuda.empty_cache()
    return counts


def fit_voc_resnet50(card: str):
    """Phase 6g: ``fit`` with ``get_preset("voc_resnet50",
    pretrained_backbone=False, freeze_epoch=1, unfreeze_epoch=2)`` over 16 +
    8 seeded VOC-layout rectangle images at 256², batch 8 (2 steps an
    epoch): epoch 1 in the freeze phase (the backbone's parameters as
    ``fit`` drew them, the rest trained), epoch 2 unfrozen (the backbone
    moves), a full-state resume for a third epoch, and serving from the best
    weights; returns the launches.  A functional check: its wall time is no
    rate."""
    import contextlib
    import io
    import tempfile

    from tpu_unet_torch.configs.presets import get_preset
    from tpu_unet_torch.infer.wrapper import Unet
    from tpu_unet_torch.kernels import launch_counts, reset_launch_counts
    from tpu_unet_torch.models.registry import build_model, init_model
    from tpu_unet_torch.train.checkpoint import load_any
    from tpu_unet_torch.train.fit import fit, reinit_weights

    classes, size = CLASSES["unet_resnet50"], DATAB_SIZE
    totals: dict = {}

    def add():
        for k, v in launch_counts.items():
            totals[k] = totals.get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        train_ids, val_ids = write_voc(tmp, 16, 8, size, classes, seed=20)
        save = tmp / "logs"
        cfg = get_preset("voc_resnet50", pretrained_backbone=False, freeze_epoch=1,
                         unfreeze_epoch=2, input_shape=(size, size), freeze_batch_size=8,
                         unfreeze_batch_size=8, save_period=1, eval_period=1,
                         save_dir=str(save))
        buf = io.StringIO()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            fit(cfg, train_ids, val_ids, base_dir=str(tmp))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        add()
        trained = dict(launch_counts)
        # 2 epochs x 2 steps of the default route
        check(all(trained[k] == 16 for k in ("unetup_bwd", "unetup_wgrad", "upsample_adjoint"))
              and trained["upconv_bwd"] == 4 and trained["final_ce_dice_fwd"] == 4
              and trained["final_ce_dice_bwd"] == 4, f"fit voc_resnet50: launches {trained}")
        drawn = reinit_weights(init_model(build_model("unet_resnet50", classes), seed=cfg.seed),
                               seed=cfg.seed).state_dict()
        ckpt = {n[:5]: load_any(str(save / n)) for n in sorted(p.name for p in save.iterdir())
                if n.startswith(("ep001", "ep002"))}
        w1, w2 = (ckpt[e].get("model_state_dict", ckpt[e]) for e in ("ep001", "ep002"))
        backbone = [k for k, v in drawn.items() if k.startswith("resnet.")
                    and v.is_floating_point() and "running" not in k]
        check(all(torch.equal(w1[k].cpu(), drawn[k]) for k in backbone)
              and not torch.equal(w1["up_conv.1.weight"].cpu(), drawn["up_conv.1.weight"]),
              "fit voc_resnet50: epoch 1 (frozen) moved the backbone or not the head")
        check(any(not torch.equal(w2[k], w1[k]) for k in backbone),
              "fit voc_resnet50: epoch 2 (unfrozen) left the backbone as it was")

        rcfg = get_preset("voc_resnet50", resume=True, pretrained_backbone=False, freeze_epoch=1,
                          unfreeze_epoch=3, input_shape=(size, size), freeze_batch_size=8,
                          unfreeze_batch_size=8, eval_flag=False,
                          model_path=str(save / "last_epoch_weights.pth"),
                          save_dir=str(tmp / "resumed"))
        buf2 = io.StringIO()
        reset_launch_counts()
        with contextlib.redirect_stdout(buf2):
            state = fit(rcfg, train_ids, val_ids, base_dir=str(tmp))
        torch.cuda.synchronize()
        add()
        again = load_any(str(tmp / "resumed" / "last_epoch_weights.pth"))
        check("Resuming full training state at epoch 2" in buf2.getvalue()
              and again["epoch"] == 3 and state.step == 6,
              f"resume voc_resnet50: epoch {again['epoch']}, steps {state.step}")

        u = Unet(model="unet_resnet50", num_classes=classes, input_shape=[size, size],
                 model_path=str(save / "best_epoch_weights.pth"))
        fn, net = u.serving_step()
        val = rect_batch(torch.Generator().manual_seed(21), 8, size, classes, "cuda")
        (masks, hist), served = counted({"final_argmax_hist": 1, "unetup": 4, "upsample2x": 5,
                                         "upconv": 1},
                                        "serving the trained voc_resnet50 .pth",
                                        lambda: fn(net, val["image"]))
        for k, v in served.items():
            totals[k] = totals.get(k, 0) + v
        check(masks.shape == (8, size, size) and int(hist.sum()) == 8 * size ** 2,
              f"serving from the trained weights: masks {tuple(masks.shape)}")
        print(json.dumps({
            "fit": "voc_resnet50", "images": [len(train_ids), len(val_ids)], "size": size,
            "epochs": "1 frozen + 1 unfrozen, then 1 resumed",
            "seconds_wall_incl_warmup": secs,
            "epoch_lines": [ln for ln in buf.getvalue().splitlines() if ln.startswith("Epoch")],
            "resumed_epoch_lines": [ln for ln in buf2.getvalue().splitlines()
                                    if ln.startswith("Epoch")],
            "launches": totals, "gpu": card}), flush=True)
    return totals


# the DataB train step's launches: the logit-level loss kernels once each,
# every other kernel 0 (the models train through cuDNN, as XLA in JAX)
DATAB_STEP = {"ce_dice_fwd": 1, "ce_dice_bwd": 1}
# the presets' class weights: traditional's, and the ladder models'
DATAB_CW = {"traditional": (1.0, 15.0, 0.0, 0.0),
            "ultralight_large_optimized": (1.0, 15.0, 1.5, 2.0)}


def bn_stats(net):
    """The running statistics of every batch norm, by state-dict key."""
    return {k: v.clone() for k, v in net.state_dict().items() if "running_" in k}


def cancelled_biases(net):
    """The biases of the convs that feed a batch norm (every conv but the
    classifier; the ladder's depthwise one through the linear pointwise
    conv): their exact gradient is 0, so both steps give noise."""
    return {f"{k}.bias" for k, m in net.named_modules()
            if isinstance(m, torch.nn.Conv2d) and k not in ("outc", "final")}


def plain_datab_step(net, batch, cfg, seed, dtype=torch.bfloat16):
    """Loss, float32 gradients and the running statistics after one bf16
    (or ``dtype``) step composed here of a copy of ``net`` in that dtype in
    train mode (its dropout drawn from a generator seeded ``seed``) and the
    plain losses of ``train/losses.py`` under autograd, no kernel.
    ``tests/test_torch_gpu.py`` holds its DataB step to this same
    reference."""
    from tpu_unet_torch.train.losses import dice_loss, focal_loss, one_hot
    from tpu_unet_torch.train.step import prepare_batch

    n16 = copy.deepcopy(net)
    for p in n16.parameters():
        p.data = p.data.to(dtype)
    imgs, target = prepare_batch(batch, dtype, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = n16(imgs, train=True, generator=gen).float()
    loss = focal_loss(logits, target, cfg.cls_weights, cfg.num_classes) + \
        dice_loss(logits, one_hot(target, cfg.num_classes))
    loss.backward()
    return loss.item(), {k: p.grad.float() for k, p in n16.named_parameters()}, bn_stats(n16)


def datab_step(name: str, card: str):
    """Phase 6c for one DataB model; returns its counted step's launches."""
    from tpu_unet_torch.configs.presets import get_preset
    from tpu_unet_torch.models.registry import build_model, init_model
    from tpu_unet_torch.train import step as tstep
    from tpu_unet_torch.train.schedules import adaptive_lr

    classes, n, size = 4, DATAB_BATCH, DATAB_SIZE
    preset = get_preset(name)
    lr = adaptive_lr(preset.init_lr, preset.min_lr, n, preset.optimizer_type)[0]
    cfg = tstep.StepConfig(classes, DATAB_CW[name], use_focal=True, use_dice=True,
                           compute_dtype=torch.bfloat16)
    batch = rect_batch(torch.Generator().manual_seed(12), n, size, classes, "cuda")
    init = init_model(build_model(name, classes), seed=0).cuda()
    before = bn_stats(init)
    ploss, pgrads, pstats = plain_datab_step(init, batch, cfg, seed=5)

    net = copy.deepcopy(init)
    state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9, preset.weight_decay))
    fn = tstep.make_train_step(net, cfg)
    dgen = torch.Generator(device="cuda").manual_seed(5)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (state, m), counts = counted(DATAB_STEP, f"{name} train step",
                                 lambda: fn(state, batch, lr, dgen))
    loss0 = m["loss"].item()
    lrel = abs(loss0 - ploss) / abs(ploss)
    check(lrel <= 1e-3, f"{name} step loss {loss0} vs plain step {ploss}: rel {lrel:.3g}")
    noise = cancelled_biases(net)
    worst_cos, worst_noise = 1.0, 0.0
    for k, p in net.named_parameters():
        a, b = p.grad.float().ravel(), pgrads[k].ravel()
        if k in noise:
            worst_noise = max(worst_noise, a.abs().max().item(), b.abs().max().item())
            continue
        cos = (a @ b / (a.norm() * b.norm()).clamp_min(1e-30)).item()
        worst_cos = min(worst_cos, cos)
        check(cos >= 0.99, f"{name} gradient of {k}: cosine {cos:.5f} against the plain step")
    stats = bn_stats(net)
    stat_rel = max(((stats[k] - v).abs().max() / v.abs().max().clamp_min(1e-30)).item()
                   for k, v in pstats.items())
    moved = min(((stats[k] - v).abs().max()).item() for k, v in before.items())
    check(stat_rel <= 1e-2 and moved > 0,
          f"{name} running statistics: rel err {stat_rel:.3g} vs plain, least move {moved:.3g}")
    del pgrads, pstats

    step = lambda: fn(state, batch, lr, dgen)  # noqa: E731
    step_ms = time_ms(step, reps=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile = device_breakdown(lambda _net, _imgs: step(), None, None)

    # the card against the CPU float32 path: one 64^2 step at batch 8, the
    # bridge dropout off on both sides (the two devices draw other masks).
    # At batch 2 the ladder's 4x4 bridge normalises 32 values a channel and
    # bf16 alone moves its loss 2.9% (so does a bf16 step on the CPU)
    small = rect_batch(torch.Generator().manual_seed(13), 8, 64, classes, "cuda")
    card_net, cpu_net = copy.deepcopy(init), copy.deepcopy(init).cpu()
    for m_ in (card_net, cpu_net):
        if hasattr(m_, "dropout"):
            m_.dropout = 0.0
    _, mc = tstep.make_train_step(card_net, cfg)(
        tstep.TrainState(card_net, tstep.make_optimizer(card_net)), small, lr)
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    _, mcpu = tstep.make_train_step(cpu_net, f32)(
        tstep.TrainState(cpu_net, tstep.make_optimizer(cpu_net)),
        {k: v.cpu() for k, v in small.items()}, lr)
    cpu_rel = abs(mc["loss"].item() - mcpu["loss"].item()) / abs(mcpu["loss"].item())
    check(cpu_rel <= 2e-2, f"{name} 64^2 step vs CPU f32: loss rel {cpu_rel:.3g} > 2e-2")
    del card_net, cpu_net

    # it learns: 20 steps on one fixed batch from the initial weights
    lnet = copy.deepcopy(init)
    lstate = tstep.TrainState(lnet, tstep.make_optimizer(lnet, "adam", 0.9, preset.weight_decay))
    lfn = tstep.make_train_step(lnet, cfg)
    lgen = torch.Generator(device="cuda").manual_seed(7)
    losses = [lfn(lstate, batch, lr, lgen)[1]["loss"].item() for _ in range(20)]
    check(losses[-1] <= 0.9 * losses[0], f"{name} 20 steps: loss {losses[0]:.4f} -> "
                                         f"{losses[-1]:.4f}, not 10% lower")
    print(json.dumps({
        "train_step": name, "batch": n, "size": size, "classes": classes, "dtype": "bf16",
        "recipe": f"focal + dice, w={list(cfg.cls_weights)}, Adam lr {lr:g} wd "
                  f"{preset.weight_decay:g}", "launches": counts, "step_ms_events": step_ms,
        "img_per_s": n * 10 / host, "step_ms_host": host / 10 * 1e3, "peak_mem_gib": peak,
        "profile": profile, "loss": loss0, "loss_plain_step": ploss,
        "loss_rel_err_vs_plain": lrel, "worst_grad_cosine": worst_cos,
        "largest_cancelled_bias_grad": worst_noise, "running_stats_rel_err_vs_plain": stat_rel,
        "loss_rel_err_vs_cpu_f32_64px": cpu_rel, "losses_20_steps": losses, "gpu": card}),
        flush=True)
    del net, state, fn, lnet, lstate, init
    torch.cuda.empty_cache()
    return counts


def datab_training(card: str):
    """Phase 6c: the DataB steps; returns their counted launches."""
    from tpu_unet_torch.models.registry import build_model, init_model
    from tpu_unet_torch.train import step as tstep

    totals: dict = {}
    for name in DATAB_CW:
        for k, v in datab_step(name, card).items():
            totals[k] = totals.get(k, 0) + v
    # lightweight: half-size logits take the plain losses, as in JAX
    net = init_model(build_model("lightweight", 4), seed=0).cuda()
    cfg = tstep.StepConfig(4, (1.0,) * 4, use_dice=True, compute_dtype=torch.bfloat16)
    batch = rect_batch(torch.Generator().manual_seed(14), DATAB_BATCH, DATAB_SIZE, 4, "cuda")
    fn = tstep.make_train_step(net, cfg)
    state = tstep.TrainState(net, tstep.make_optimizer(net))
    gen = torch.Generator(device="cuda").manual_seed(1)
    (_, m), counts = counted({}, "lightweight train step", lambda: fn(state, batch, 1e-4, gen))
    check(bool(torch.isfinite(m["loss"])), f"lightweight step loss {m['loss'].item()}")
    print(json.dumps({"train_step": "lightweight", "batch": DATAB_BATCH, "size": DATAB_SIZE,
                      "recipe": "CE + dice on the plain losses (half-size logits)",
                      "loss": m["loss"].item(), "launches": counts, "gpu": card}), flush=True)
    del net, state, fn
    return totals


def cli_train_datab(card: str):
    """Phase 6d: ``cli train --preset traditional`` (focal + dice, the
    heavy augmentation, bf16) for 2 epochs of 2 steps over 64 + 16 seeded
    rectangle images with evaluation each epoch, a full-state resume for a
    third epoch, and serving from the best weights through the natural-
    layout tail; returns the launches of all three."""
    import contextlib
    import io
    import tempfile

    from tpu_unet_torch import cli
    from tpu_unet_torch.configs.presets import get_preset
    from tpu_unet_torch.infer.wrapper import Unet
    from tpu_unet_torch.train.checkpoint import load_any
    from tpu_unet_torch.train.fit import fit

    def quiet(fn, buf):
        with contextlib.redirect_stdout(buf):
            return fn()

    try:
        import matplotlib  # noqa: F401
        plots = True
    except ImportError:  # the curves need matplotlib, in JAX's callback too
        plots = False
    totals: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        train_ids, val_ids = write_voc(tmp, 64, 16, DATAB_SIZE, 4, seed=10)
        save = tmp / "logs"
        buf = io.StringIO()
        t0 = time.perf_counter()
        _, trained = counted({"ce_dice_fwd": 4, "ce_dice_bwd": 4}, "cli train traditional",
                             lambda: quiet(lambda: cli.main([
                                 "train", "--preset", "traditional", "--data-root", str(tmp),
                                 "--epochs", "2", "--eval-period", "1", "--save-dir",
                                 str(save)]), buf))
        secs = time.perf_counter() - t0
        text = buf.getvalue()
        logs = [d for d in save.iterdir() if d.name.startswith("loss_")]
        check(len(logs) == 1 and (logs[0] / "epoch_miou.txt").exists()
              and text.count("val mIoU") == 2, f"cli train traditional: mIoU lines {text!r}")
        pngs = sorted(p.name for p in logs[0].glob("epoch_*iou.png")) if logs else []
        if plots:
            check(pngs == ["epoch_class_iou.png", "epoch_miou.png"], f"curves {pngs}")
        last = load_any(str(save / "last_epoch_weights.pth"))
        check(last["epoch"] == 2 and last["step"] == 4, f"last checkpoint epoch "
              f"{last['epoch']} step {last['step']}")
        cfg = get_preset("traditional", resume=True, unfreeze_epoch=3, eval_flag=False,
                         model_path=str(save / "last_epoch_weights.pth"),
                         save_dir=str(tmp / "resumed"))
        buf2 = io.StringIO()
        state, resumed = counted({"ce_dice_fwd": 2, "ce_dice_bwd": 2}, "resume traditional",
                                 lambda: quiet(lambda: fit(cfg, train_ids, val_ids,
                                                           base_dir=str(tmp)), buf2))
        again = load_any(str(tmp / "resumed" / "last_epoch_weights.pth"))
        moments = {float(s["step"]) for s in again["optimizer"]["state"].values()}
        check("Resuming full training state at epoch 2" in buf2.getvalue()
              and again["epoch"] == 3 and state.step == 6 and moments == {6.0},
              f"resume: epoch {again['epoch']}, steps {state.step}, Adam steps {moments}")
        u = Unet(model="traditional", num_classes=4, input_shape=[DATAB_SIZE, DATAB_SIZE],
                 model_path=str(save / "best_epoch_weights.pth"))
        fn, net = u.serving_step()
        val = rect_batch(torch.Generator().manual_seed(9), 8, DATAB_SIZE, 4, "cuda")
        (masks, hist), served = counted({"final_argmax_hist": 1}, "serving the trained .pth",
                                        lambda: fn(net, val["image"]))
        check(masks.shape == (8, DATAB_SIZE, DATAB_SIZE)
              and int(hist.sum()) == 8 * DATAB_SIZE ** 2,
              f"serving from the trained weights: masks {tuple(masks.shape)}")
        for counts in (trained, resumed, served):
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
        print(json.dumps({
            "cli_train": "traditional", "images": [len(train_ids), len(val_ids)], "epochs": 2,
            # a functional check: at 2 steps an epoch this wall time is
            # warm-up, loader start, evaluation and checkpoint writes
            "seconds_wall_incl_warmup": secs,
            "epoch_lines": [ln for ln in text.splitlines() if ln.startswith(("Epoch", "epoch"))],
            "curves": pngs if plots else "matplotlib absent: no curves (nor in JAX's callback)",
            "resumed_epoch_lines": [ln for ln in buf2.getvalue().splitlines()
                                    if ln.startswith("Epoch")],
            "launches": totals, "gpu": card}), flush=True)
    return totals


def write_voc(root: Path, n_train: int, n_val: int, size: int, classes: int, seed: int):
    """A seeded VOC2012-layout tree of rectangle images (JPEG) and labels
    (PNG, 4-pixel 255 border) with its train / val splits."""
    from PIL import Image

    base = root / "VOCdevkit" / "VOC2012"
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        (base / d).mkdir(parents=True, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    ids = [f"r{i:03d}" for i in range(n_train + n_val)]
    for i0 in range(0, len(ids), 16):
        chunk = ids[i0:i0 + 16]
        bt = rect_batch(gen, len(chunk), size, classes, "cpu")
        for name, img, lbl in zip(chunk, bt["image"].numpy(), bt["label"].numpy()):
            Image.fromarray(img).save(base / "JPEGImages" / f"{name}.jpg", quality=95)
            Image.fromarray(lbl.astype(np.uint8)).save(base / "SegmentationClass" / f"{name}.png")
    sets = base / "ImageSets" / "Segmentation"
    (sets / "train.txt").write_text("\n".join(ids[:n_train]))
    (sets / "val.txt").write_text("\n".join(ids[n_train:]))
    return ids[:n_train], ids[n_train:]


def cli_train(card: str):
    """``cli train --preset train_py --no-pretrained`` (unet_vgg, 4 classes,
    256², batch 32, CE + dice, bf16) for 2 epochs over 64 + 16 seeded
    rectangle images, a full-state resume for a third epoch, and serving
    from the best weights; returns the launches of all three."""
    import contextlib
    import io
    import tempfile

    from tpu_unet_torch import cli
    from tpu_unet_torch.configs.presets import get_preset
    from tpu_unet_torch.infer.wrapper import Unet
    from tpu_unet_torch.kernels import launch_counts, reset_launch_counts
    from tpu_unet_torch.train.checkpoint import load_any
    from tpu_unet_torch.train.fit import fit

    totals: dict = {}

    def add():
        for k, v in launch_counts.items():
            totals[k] = totals.get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        train_ids, val_ids = write_voc(tmp, 64, 16, DATAB_SIZE, 4, seed=8)
        save = tmp / "logs"
        buf = io.StringIO()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["train", "--preset", "train_py", "--no-pretrained", "--data-root",
                      str(tmp), "--epochs", "2", "--save-dir", str(save)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        add()
        text = buf.getvalue()
        trained = dict(launch_counts)
        # 4 steps of the default route: 4 decoder stages a step
        check(all(trained[k] == 16 for k in ("unetup_bwd", "unetup_wgrad", "upsample_adjoint"))
              and trained["final_ce_dice_fwd"] == 4 and trained["final_ce_dice_bwd"] == 4,
              f"cli train: 2 epochs x 2 steps, launches {trained}")
        names = sorted(p.name for p in save.iterdir())
        ckpts = [n for n in names if n.endswith(".pth")]
        check({"best_epoch_weights.pth", "last_epoch_weights.pth"} <= set(ckpts)
              and any(n.startswith("ep002-") for n in ckpts), f"cli train wrote {names}")
        last = load_any(str(save / "last_epoch_weights.pth"))
        check(last["epoch"] == 2 and last["step"] == 4, f"last checkpoint epoch "
              f"{last['epoch']} step {last['step']}")

        cfg = get_preset("train_py", resume=True, model_path=str(save / "last_epoch_weights.pth"),
                         unfreeze_epoch=3, pretrained_backbone=False, save_dir=str(tmp / "resumed"))
        buf2 = io.StringIO()
        reset_launch_counts()
        with contextlib.redirect_stdout(buf2):
            state = fit(cfg, train_ids, val_ids, base_dir=str(tmp))
        torch.cuda.synchronize()
        add()
        again = load_any(str(tmp / "resumed" / "last_epoch_weights.pth"))
        moments = {float(s["step"]) for s in again["optimizer"]["state"].values()}
        check("Resuming full training state at epoch 2" in buf2.getvalue()
              and again["epoch"] == 3 and state.step == 6 and moments == {6.0},
              f"resume: epoch {again['epoch']}, steps {state.step}, Adam steps {moments}")

        reset_launch_counts()
        u = Unet(model="unet_vgg", num_classes=4, input_shape=[DATAB_SIZE, DATAB_SIZE],
                 model_path=str(save / "best_epoch_weights.pth"))
        fn, net = u.serving_step()
        val = rect_batch(torch.Generator().manual_seed(9), 8, DATAB_SIZE, 4, "cuda")
        masks, hist = fn(net, val["image"])
        torch.cuda.synchronize()
        add()
        lbl = val["label"]
        known = lbl != 255
        acc = (masks.long()[known] == lbl.long()[known]).float().mean().item()
        check(masks.shape == (8, DATAB_SIZE, DATAB_SIZE) and int(hist.sum()) == 8 * DATAB_SIZE ** 2,
              f"serving from the trained weights: masks {tuple(masks.shape)}")
        print(json.dumps({
            "cli_train": "train_py", "images": [len(train_ids), len(val_ids)], "epochs": 2,
            # a functional check: at 2 steps an epoch this wall time is
            # warm-up, loader start, evaluation and checkpoint writes, not a
            # training rate (the step's rate is phase 6a's)
            "seconds_wall_incl_warmup": secs,
            "epoch_lines": [ln for ln in text.splitlines() if ln.startswith("Epoch")],
            "checkpoints": ckpts, "resumed_epoch_lines": [
                ln for ln in buf2.getvalue().splitlines() if ln.startswith("Epoch")],
            "serving_pixel_accuracy_on_rectangles": acc, "launches": totals,
            "gpu": card}), flush=True)
    return totals


# ---- phase 7: the float32 path (TF32 products, float32 everywhere else) ----
#
# unet_vgg's float32 training (the voc and medical presets, fp16=False) on
# the float32 instantiations of its kernels: each against its plain float32
# version with TF32 off (main() sets both switches), within the bounds of
# tpu_unet_torch/kernels/tf32.py that the CPU emulation fixes; a single-tile
# float64 witness of each product (which operand rule the card applied); a
# planted dropped split read above the weight-gradient bounds; a second
# launch bit-identical.  Times beside the plain version's and cuDNN's float32
# with TF32 on (the same arithmetic), bounds at the TF32 peak.


def tf32_on(fn):
    """``fn`` run with cuDNN's and cuBLAS's TF32 on: the library's float32
    yardstick, which computes in the kernels' arithmetic."""
    def run():
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
    return run


def f32_tile(maps, w, rule, b=None, mask=None, last=False):
    """The TF32 emulation in float64 of a 3×3 SAME conv's first 8×16 output
    tile of image 0 or, with ``last``, its last of the last image (its
    halo's zeros the SAME padding: above and left of the first, below and
    right of the last): the channel concat of NHWC ``maps`` taken to TF32
    by ``rule``, OIHW ``w`` rounded as packed; + bias and ReLU with ``b``,
    times [mask > 0] with ``mask``."""
    from tpu_unet_torch.kernels import tf32

    if last:
        x = torch.cat([m[-1:, -9:, -17:] for m in maps], -1)
        pad = (17 - x.shape[2], 1, 9 - x.shape[1], 1)
    else:
        x = torch.cat([m[:1, :9, :17] for m in maps], -1)
        pad = (1, 17 - x.shape[2], 1, 9 - x.shape[1])
    xt = F.pad(tf32.RULES[rule](x).double().permute(0, 3, 1, 2), pad)
    y = F.conv2d(xt, tf32.round_tf32(w).double()).permute(0, 2, 3, 1)
    if b is not None:
        y = torch.relu(y + b.double())
    if mask is not None:
        y = torch.where((mask[-1:, -8:, -16:] if last else mask[:1, :8, :16]) > 0, y, 0)
    return y


def f32_witness(what, out, emulate, k, rule="trunc", last=False):
    """Print one float32 product's first tile (with ``last``: its last
    tile of the last image) against its TF32 emulation under either
    operand rule (truncated, rounded), and check the distance under
    ``rule``, the one ``kernels/tf32.py`` states for the product
    (``"trunc"``: a TMA operand of the conv core; ``"round"``: the gathered
    image, the halo mainloop's fragments), against ``tile_rel_tol(k)`` for
    its reduction of ``k`` products; returns the readings."""
    from tpu_unet_torch.kernels import tf32

    tile = out[-1:, -8:, -16:] if last else out[:1, :8, :16]
    d = {r: rel_err(tile, emulate(r))[1] for r in ("trunc", "round")}
    tol = tf32.tile_rel_tol(k)
    line = {"f32_witness": what, "tile": "last" if last else "first",
            "kernel_vs_tf32_truncated": d["trunc"],
            "kernel_vs_tf32_rounded": d["round"], "rule": rule, "k": k, "bound": tol}
    print(json.dumps(line), flush=True)
    check(d[rule] <= tol, f"{what}: float32 tile {d} from its TF32 emulation "
                          f"({rule}) > {tol:.3g}")
    return line


def f32_encoder_kernels(record, gen):
    """The training encoder in float32 at unet_vgg's five stages (512²,
    batch 8): the stem's forward (``vgg_stem_f32``), the blocks' forwards
    keeping their intermediates (``vgg_block2_fwd_f32`` /
    ``vgg_block3_fwd_f32``, and the serving key ``vgg_block_f32``), each
    stage's backward (``vgg_stem_bwd_f32``, ``vgg_block2_bwd_f32``,
    ``vgg_block3_bwd_f32``), as phase 2's bf16 checks with float32's
    bounds; the first tile of each forward's last conv (and the stem's
    conv1_1) against its TF32 emulation; the stem backward's masked dgrad
    of conv1_2 one line (mainloop, tile, K slices, FLOP a byte of L2: the
    halo mainloop, checked), its first and last tiles against their TF32
    emulations under the halo mainloop's rule (the gradient rounded),
    bit-identical on a second launch."""
    from tpu_unet_torch.kernels._plain import conv3x3_relu
    from tpu_unet_torch.kernels.decoder_train import flip_t
    from tpu_unet_torch.kernels.encoder import vgg_block
    from tpu_unet_torch.kernels.encoder_train import (_bwd_cuda, _vgg_block_cuda,
                                                      _vgg_stem_cuda, block_key, bwd_plan,
                                                      vgg_block_bwd, vgg_block_bwd_plain,
                                                      vgg_stem_bwd, vgg_stem_bwd_plain)
    from tpu_unet_torch.kernels.stem import vgg_stem_plain

    from tpu_unet_torch.kernels import sm90, tf32

    dev, B = torch.device("cuda"), BATCH
    for h, chans, pool in VGG_TRAIN_STAGES:
        stem = chans[0] == 3
        n = len(chans) - 1
        x = (torch.rand((B, h, h, 3), generator=gen, device=dev) if stem else
             torch.relu(torch.randn((B, h, h, chans[0]), generator=gen, device=dev)))
        ws = [torch.randn((f, c, 3, 3), generator=gen, device=dev) / (9 * c) ** 0.5
              for c, f in zip(chans[:-1], chans[1:])]
        bs = [0.1 * torch.randn(f, generator=gen, device=dev) for f in chans[1:]]
        case = f"{B}x{h}x{h} {chans} pool={pool} float32"
        flops = sum(conv_flops(B, h, h, c, f) for c, f in zip(chans[:-1], chans[1:]))

        def plain_fwd(x=x, ws=ws, bs=bs, pool=pool):
            y, acts = x, []
            for w, b in zip(ws, bs):
                y = conv3x3_relu(y, w, b)
                acts.append(y)
            return acts, (F.max_pool2d(cl(y), 2).permute(0, 2, 3, 1) if pool else None)

        if stem:
            skip, pooled, a1 = _vgg_stem_cuda(x, ws[0], bs[0], ws[1], bs[1])
            mids = [a1]
            ref = vgg_stem_plain(x, ws[0], bs[0], ws[1], bs[1])
            again = _vgg_stem_cuda(x, ws[0], bs[0], ws[1], bs[1])
            check(all(torch.equal(a, b) for a, b in zip((skip, pooled, a1), again)),
                  f"vgg_stem_f32 {case}: two launches differ")
            rel = record("vgg_stem_f32", case, [skip, pooled], list(ref),
                         lambda: _vgg_stem_cuda(x, ws[0], bs[0], ws[1], bs[1]),
                         lambda: vgg_stem_plain(x, ws[0], bs[0], ws[1], bs[1]),
                         tf32_on(lambda: cudnn_chain(x, ws, bs, True)), flops,
                         nbytes(x, *ws, *bs, skip, pooled), peak=PEAK_TF32)
            check(rel <= tf32.CONV_REL_TOL, f"vgg_stem_f32 {case}: rel err {rel:.3g}")
            f32_witness("vgg_stem_f32 conv1_1 (the gathered image)", a1,
                        lambda r: f32_tile([x], ws[0], r, bs[0]), 27, "round")
            f32_witness("vgg_stem_f32 conv1_2", skip, lambda r: f32_tile([a1], ws[1], r, bs[1]),
                        9 * 64)
            del again
        else:
            key = block_key(n, "fwd")
            skip, pooled, mids = _vgg_block_cuda(x, ws, bs, pool, key)
            again = _vgg_block_cuda(x, ws, bs, pool, key)
            check(torch.equal(skip, again[0]), f"{key}_f32 {case}: two launches differ")
            acts, ppool = plain_fwd()
            outs = [*mids, skip] + ([pooled] if pool else [])
            refs = acts + ([ppool] if pool else [])
            rel = record(key + "_f32", case, outs, refs,
                         lambda: _vgg_block_cuda(x, ws, bs, pool, key), plain_fwd,
                         tf32_on(lambda: cudnn_chain(x, ws, bs, pool)), flops,
                         nbytes(x, *ws, *bs, *outs), peak=PEAK_TF32)
            check(rel <= tf32.CONV_REL_TOL, f"{key}_f32 {case}: rel err {rel:.3g}")
            # the serving key: the same kernel through vgg_block
            record("vgg_block_f32", case, [t for t in vgg_block(x, ws, bs, pool) if t is not None],
                   [acts[-1], ppool] if pool else [acts[-1]],
                   lambda: vgg_block(x, ws, bs, pool), plain_fwd,
                   tf32_on(lambda: cudnn_chain(x, ws, bs, pool)), flops,
                   nbytes(x, *ws, *bs, *outs), peak=PEAK_TF32)
            last_in = mids[-1] if mids else x
            f32_witness(f"{key}_f32 {chans} last conv", skip,
                        lambda r: f32_tile([last_in], ws[-1], r, bs[-1]), 9 * chans[-2])
            del again, acts, ppool
        dskip = torch.randn(skip.shape, generator=gen, device=dev)
        dpool = torch.randn((B, h // 2, h // 2, chans[-1]), generator=gen, device=dev) \
            if pool else None
        if stem:
            key = "vgg_stem_bwd"
            kern = lambda: (None, *vgg_stem_bwd(dskip, dpool, x, mids[0], skip, ws[0], ws[1]))  # noqa: E731
            plain = lambda: (None, *vgg_stem_bwd_plain(dskip, dpool, x, mids[0], skip, ws[0],  # noqa: E731
                                                       ws[1]))
        else:
            key = block_key(n, "bwd")
            kern = lambda: vgg_block_bwd(dskip, dpool, x, mids, skip, ws)  # noqa: E731
            plain = lambda: vgg_block_bwd_plain(dskip, dpool, x, mids, skip, ws)  # noqa: E731
        res, again, ref = kern(), kern(), plain()
        flat = lambda r: ([] if r[0] is None else [r[0]]) + list(r[1]) + list(r[2])  # noqa: E731
        check(all(torch.equal(a, b) for a, b in zip(flat(res), flat(again))),
              f"{key}_f32 {case}: two launches differ")
        errs = {} if res[0] is None else {"dx": rel_err(res[0], ref[0])[1]}
        for i in range(n):
            errs[f"dk{i}"] = rel_err(res[1][i], ref[1][i])[1]
            errs[f"db{i}"] = rel_err(res[2][i], ref[2][i])[1]
        for name, e in errs.items():
            tol = tf32.CONV_REL_TOL if name == "dx" else \
                tf32.WGRAD_REL_TOL if name[2:] == str(n - 1) else tf32.WGRAD_CHAIN_REL_TOL
            check(e <= tol, f"{key}_f32 {case}: {name} rel err {e:.3g} > {tol}")
        print(json.dumps({key + "_f32": case, "rel_err_by_output": errs}), flush=True)
        if stem:  # conv1_2's masked dgrad on the halo mainloop: g in ga, the dgrad in gb
            ln = sm90.stem_bwd_launches(B, h, h, chans[1], True)[3]
            halo = ln.get("mainloop") == sm90.MAINLOOP_HALO
            print(json.dumps({"f32_stem_bwd_launch": "dgrad of conv1_2 (masked)", "case": case,
                              "mainloop": "halo" if halo else "tap", "tile": list(ln["tile"]),
                              "k_slices": ln["k_slices"],
                              "flop_per_l2_byte": sm90.flop_per_l2_byte(ln)}), flush=True)
            check(halo, f"vgg_stem_bwd_f32 {case}: its dgrad not on the halo mainloop")
            bufs = [_bwd_cuda(key, dskip, dpool, x, mids, skip, ws, False, True)[3:]
                    for _ in range(2)]
            check(all(torch.equal(a, b) for a, b in zip(*bufs)),
                  f"{key}_f32 {case}: the dgrad's two launches differ")
            g, dz = bufs[0]
            for last in (False, True):
                f32_witness(f"{key}_f32 {case} dgrad of conv1_2", dz,
                            lambda r: f32_tile([g], flip_t(ws[1]), r, mask=mids[0], last=last),
                            9 * chans[2], tf32.launch_rule(ln), last)
            del bufs, g, dz
        ns = bwd_plan(B, h, h, tuple(chans), not stem, True)[1][n - 1]
        if stem:
            def faulty(ds, dp):
                return [r[n - 1] for r in vgg_stem_bwd(ds, dp, x, mids[0], skip, ws[0], ws[1])]
        else:
            def faulty(ds, dp):
                return [r[n - 1] for r in vgg_block_bwd(ds, dp, x, mids, skip, ws)[1:]]
        B_, H_, W_, _ = dskip.shape
        bad = dskip.masked_fill(first_split_mask(B_, H_, W_, ns)[..., None], 0)
        badp = None if dpool is None else \
            dpool.masked_fill(first_split_mask(B_, H_, W_, ns, 2)[..., None], 0)
        fault = max(rel_err(a, b)[1] for a, b in zip(faulty(bad, badp),
                                                     [ref[1][n - 1], ref[2][n - 1]]))
        print(json.dumps({"wgrad_planted_fault": f"{key}_f32 {case}", "dropped_split_of": ns,
                          "rel_err": fault,
                          "bounds": [tf32.WGRAD_REL_TOL, tf32.WGRAD_CHAIN_REL_TOL]}), flush=True)
        check(fault > tf32.WGRAD_CHAIN_REL_TOL,
              f"{key}_f32 {case}: a dropped split reads {fault:.3g}, inside the bounds")
        with torch.enable_grad():
            xg = cl(x).detach().requires_grad_(not stem)
            wg = [w.detach().requires_grad_() for w in ws]
            bg = [b.detach().requires_grad_() for b in bs]
            y = tf32_on(lambda: cudnn_chain(xg.permute(0, 2, 3, 1), wg, bg, pool))()
            outs, cots = ((list(y), [cl(dskip), cl(dpool)]) if pool else ([y], [cl(dskip)]))
        wrt = ([] if stem else [xg]) + wg + bg
        lib = tf32_on(lambda: torch.autograd.grad(outs, wrt, cots, retain_graph=True))
        bwd_flops = 2 * flops - (conv_flops(B, h, h, 3, chans[1]) if stem else 0)
        record(key + "_f32", case, flat(res), flat(ref), kern, plain, lib, bwd_flops,
               nbytes(x, *mids, skip, dskip, dpool, *ws, *flat(res)), peak=PEAK_TF32)
        del x, ws, bs, skip, pooled, mids, dskip, dpool, res, again, ref, xg, wg, bg, y, outs
        torch.cuda.empty_cache()


def f32_decoder_kernels(record, gen):
    """The four unet_vgg and the four unet_resnet50 decoder stages in
    float32 (512², batch 8; unet_resnet50's Cs + Cx up to 3072): #1
    (``unetup_f32``, its upsample ``upsample2x_f32`` bit-equal to the plain
    float32 upsample), #13 (``unetup_bwd_f32``: g2 equal to the plain mask
    pass's), ``unetup_wgrad_f32`` (a planted dropped split at up1's dk2) and
    ``upsample_adjoint_f32`` (its plan the host's), each against its plain
    float32 version, bit-identical on a second launch; #1's two convs one
    line each (mainloop, tile, K slices, FLOP a byte of L2: the halo
    mainloop at F ≤ 256, conv1 over its two maps, checked), their first and
    last tiles against their TF32 emulations under their mainloop's rule
    (``tf32.launch_rule``: rounded on the halo mainloop, truncated on the
    core); #13's dz1's first tile; the whole stage backward against the
    plain one."""
    from tpu_unet_torch.kernels.decoder_fuse import _unetup_cuda, _unetup_plain_y1
    from tpu_unet_torch.kernels.decoder_train import (
        adjoint_plan, adjoint_plan_on_card, flip_t, up2x, unetup_bwd, unetup_bwd_full,
        unetup_bwd_full_plain, unetup_bwd_plain, unetup_wgrad, unetup_wgrad_plain, wgrad_plan,
        upsample2x_adjoint, upsample2x_adjoint_plain)
    from tpu_unet_torch.nn.resize import upsample2x

    from tpu_unet_torch.kernels import sm90, tf32

    dev, B = torch.device("cuda"), BATCH
    cb = torch.ops.aten.convolution_backward
    for h, cs, cx, f in VGG_STAGES + RN50_STAGES:
        h2, cp = 2 * h, cs + cx
        case = f"{B}x{h2}x{h2} Cs={cs} Cx={cx} F={f} float32"
        convs = sm90.unetup_launches(B, h2, h2, cs, cx, f, True)
        for name, ln in zip(("conv1", "conv2"), convs):
            halo = ln.get("mainloop") == sm90.MAINLOOP_HALO
            print(json.dumps({"f32_decoder_launch": name, "case": case,
                              "mainloop": "halo" if halo else "tap", "tile": list(ln["tile"]),
                              "k_slices": ln["k_slices"], "maps": len(ln["maps"]) - 1,
                              "flop_per_l2_byte": sm90.flop_per_l2_byte(ln)}), flush=True)
            check(halo == (f <= 256), f"unetup f32 {case} {name}: on the "
                                      f"{'halo' if halo else 'tap'} mainloop, not its plan's")
        skip = torch.relu(torch.randn((B, h2, h2, cs), generator=gen, device=dev))
        x = torch.relu(torch.randn((B, h, h, cx), generator=gen, device=dev))
        w1 = torch.randn((f, cp, 3, 3), generator=gen, device=dev) / (9 * cp) ** 0.5
        w2 = torch.randn((f, f, 3, 3), generator=gen, device=dev) / (9 * f) ** 0.5
        b1, b2 = (0.1 * torch.randn(f, generator=gen, device=dev) for _ in range(2))
        up = up2x(x)
        check(torch.equal(up, upsample2x(x)), f"upsample2x_f32 {case}: not the plain upsample")
        record("upsample2x_f32", case, [up], [upsample2x(x)], lambda: up2x(x),
               lambda: upsample2x(x), None, 6.0 * up.numel(), nbytes(x, up), peak=PEAK_F32)
        out, y1 = _unetup_cuda(skip, x, w1, b1, w2, b2, want_y1=True)
        check(torch.equal(out, _unetup_cuda(skip, x, w1, b1, w2, b2)),
              f"unetup_f32 {case}: two launches differ")
        pout, py1 = _unetup_plain_y1(skip, x, w1, b1, w2, b2)

        def lib_f(skip=skip, x=x, w1=w1, b1=b1, w2=w2, b2=b2):
            cc = torch.cat([cl(skip), cl(upsample2x(x))], 1)
            return F.relu(F.conv2d(F.relu(F.conv2d(cc, w1, b1, padding=1)), w2, b2, padding=1))

        rel = record("unetup_f32", case, [out, y1], [pout, py1],
                     lambda: _unetup_cuda(skip, x, w1, b1, w2, b2),
                     lambda: _unetup_plain_y1(skip, x, w1, b1, w2, b2), tf32_on(lib_f),
                     conv_flops(B, h2, h2, cp, f) + conv_flops(B, h2, h2, f, f),
                     nbytes(skip, x, w1, w2, out, y1), peak=PEAK_TF32)
        check(rel <= tf32.CONV_REL_TOL, f"unetup_f32 {case}: rel err {rel:.3g}")
        r1, r2 = (tf32.launch_rule(ln) for ln in convs)
        for last in (False, True):
            f32_witness(f"unetup_f32 {case} conv1", y1,
                        lambda r: f32_tile([skip, up], w1, r, b1, last=last), 9 * cp, r1, last)
            f32_witness(f"unetup_f32 {case} conv2", out,
                        lambda r: f32_tile([y1], w2, r, b2, last=last), 9 * f, r2, last)
        g = torch.randn((B, h2, h2, f), generator=gen, device=dev)
        args = (g, out, y1, skip, x, w1, w2)
        res = unetup_bwd_full(*args)
        check(all(torch.equal(a, b) for a, b in zip(res, unetup_bwd_full(*args))),
              f"unetup_bwd_full_f32 {case}: two launches differ")
        ref = unetup_bwd_full_plain(*args)
        errs = {n: rel_err(a, b)[1] for n, a, b in
                zip(("dskip", "dx", "dk1", "db1", "dk2", "db2"), res, ref)}
        for n, e in errs.items():
            tol = tf32.CONV_REL_TOL if n in ("dskip", "dx") else tf32.WGRAD_CHAIN_REL_TOL
            check(e <= tol, f"unetup_bwd_full_f32 {case}: {n} rel err {e:.3g} > {tol}")
        print(json.dumps({"unetup_bwd_full_f32": case, "rel_err_by_output": errs}), flush=True)
        del res, ref
        # #13 alone
        r13 = unetup_bwd(g, out, y1, w1, w2, cs)
        p13 = unetup_bwd_plain(g, out, y1, w1, w2, cs)
        check(all(torch.equal(a, b) for a, b in zip(r13, unetup_bwd(g, out, y1, w1, w2, cs))),
              f"unetup_bwd_f32 {case}: two launches differ")
        check(bool(torch.equal(r13[2], p13[2])), f"unetup_bwd_f32 {case}: g2 != plain")
        f32_witness(f"unetup_bwd_f32 {case} dz1", r13[3],
                    lambda r: f32_tile([r13[2]], flip_t(w2), r, mask=y1), 9 * f)
        placeholder = torch.empty((B, cp, h2, h2), device=dev, memory_format=torch.channels_last)

        def lib13(g=g, out=out, y1=y1, w1=w1, w2=w2, placeholder=placeholder):
            g2 = torch.where(out > 0, g, 0)
            dz1 = cb(cl(g2), cl(y1), w2, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                     [True, False, False])[0]
            dz1 = torch.where(cl(y1) > 0, dz1, 0)
            return cb(dz1, placeholder, w1, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                      [True, False, False])[0]

        rel = record("unetup_bwd_f32", case, [r13[3], r13[0], r13[1]], [p13[3], p13[0], p13[1]],
                     lambda: unetup_bwd(g, out, y1, w1, w2, cs),
                     lambda: unetup_bwd_plain(g, out, y1, w1, w2, cs), tf32_on(lib13),
                     conv_flops(B, h2, h2, f, f) + conv_flops(B, h2, h2, f, cp),
                     nbytes(g, out, y1, w1, w2, *r13), peak=PEAK_TF32)
        check(rel <= tf32.CONV_REL_TOL, f"unetup_bwd_f32 {case}: rel err {rel:.3g}")
        _, dups, g2, dz1 = p13
        del r13, placeholder
        wres, wref = unetup_wgrad(skip, x, dz1, y1, g2), unetup_wgrad_plain(skip, x, dz1, y1, g2)
        check(all(torch.equal(a, b) for a, b in zip(wres, unetup_wgrad(skip, x, dz1, y1, g2))),
              f"unetup_wgrad_f32 {case}: two launches differ")

        def lib_w(skip=skip, x=x, dz1=dz1, y1=y1, g2=g2, w1=w1, w2=w2, f=f):
            cc = torch.cat([cl(skip), cl(upsample2x(x))], dim=1)
            _, dk1, db1 = cb(cl(dz1), cc, w1, [f], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                             [False, True, True])
            _, dk2, db2 = cb(cl(g2), cl(y1), w2, [f], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                             [False, True, True])
            return dk1, db1, dk2, db2

        rel = record("unetup_wgrad_f32", case, list(wres), list(wref),
                     lambda: unetup_wgrad(skip, x, dz1, y1, g2),
                     lambda: unetup_wgrad_plain(skip, x, dz1, y1, g2), tf32_on(lib_w),
                     conv_flops(B, h2, h2, cp, f) + conv_flops(B, h2, h2, f, f),
                     nbytes(skip, x, dz1, y1, g2, *wres), peak=PEAK_TF32)
        check(rel <= tf32.WGRAD_REL_TOL, f"unetup_wgrad_f32 {case}: rel err {rel:.3g}")
        if f == 64:
            ns = wgrad_plan(B, h2, h2, cs, cx, f, True)[1][2]
            bad = g2.masked_fill(first_split_mask(B, h2, h2, ns)[..., None], 0)
            fault = max(rel_err(a, b)[1] for a, b in
                        zip(unetup_wgrad(skip, x, dz1, y1, bad)[2:], wref[2:]))
            print(json.dumps({"wgrad_planted_fault": f"unetup_wgrad_f32 {case}",
                              "dropped_split_of": ns, "rel_err": fault,
                              "bounds": [tf32.WGRAD_REL_TOL, tf32.WGRAD_CHAIN_REL_TOL]}),
                  flush=True)
            check(fault > tf32.WGRAD_CHAIN_REL_TOL,
                  f"unetup_wgrad_f32 {case}: a dropped split reads {fault:.3g}")
        ares = upsample2x_adjoint(dups, h, h)
        check(torch.equal(ares, upsample2x_adjoint(dups, h, h)),
              f"upsample_adjoint_f32 {case}: two launches differ")
        check(adjoint_plan_on_card(B, h, h, cx, True) == adjoint_plan(B, h, h, cx, True),
              f"upsample_adjoint_f32 {case}: the kernel's plan is not the host's")
        xz = torch.zeros((B, h, h, cx), device=dev)

        def lib_a(xz=xz, dups=dups):
            with torch.enable_grad():
                xg = xz.detach().requires_grad_()
                u = upsample2x(xg)
            return torch.autograd.grad(u, xg, dups)[0]

        rel = record("upsample_adjoint_f32", case, [ares],
                     [upsample2x_adjoint_plain(dups, h, h)],
                     lambda: upsample2x_adjoint(dups, h, h),
                     lambda: upsample2x_adjoint_plain(dups, h, h), lib_a,
                     2.0 * 4 * dups.numel(), nbytes(dups, ares), peak=PEAK_F32)
        check(rel <= F32_ADJOINT_REL_TOL, f"upsample_adjoint_f32 {case}: rel err {rel:.3g}")
        del skip, x, g, out, y1, up, wres, wref, dups, g2, dz1, ares, p13
        torch.cuda.empty_cache()


def f32_head_kernels(record, gen):
    """The up_conv head in float32 at both heads (batch 8, 64 channels):
    unet_resnet50's (x 256² → 512²) and self_net's (x 512² → 1024²), its
    four convs on the halo mainloop (one line each: its mainloop, tile and
    FLOP a byte of L2).  #10 / #11 (``upconv_f32``: y1 and out within
    CONV_REL_TOL of the plain float32 head, conv1's and conv2's first and
    last tiles against their TF32 emulations under the halo mainloop's
    rule, the activation rounded) and #12 (``upconv_bwd_f32``: dx within
    CONV_REL_TOL, dk1 / db1 / dk2 / db2 within WGRAD_CHAIN_REL_TOL of
    ``upconv_bwd_plain``, the first and last tiles of its two dgrads
    against their emulations), each bit-identical on a second launch; a
    planted dropped split of the dk2 GEMM (g zeroed over the split's
    patches: g2, its G operand, vanishes there) and of the dk1
    GEMM (dz1, its G operand, then vanishes over that split's patches but
    their one-pixel border) read above the bounds; dk2 and the plain
    version's against a float64 evaluation on the card; timed against the
    plain version and cuDNN's float32 with TF32 on, bound at the TF32
    peak."""
    from tpu_unet_torch.kernels.decoder_train import flip_t
    from tpu_unet_torch.kernels.upconv import (_upconv_bwd_cuda, _upconv_cuda, _upconv_plain_y1,
                                               bwd_plan, upconv_bwd, upconv_bwd_plain)
    from tpu_unet_torch.nn.resize import upsample2x

    from tpu_unet_torch.kernels import sm90, tf32

    dev, B, f = torch.device("cuda"), BATCH, 64
    for h in (SIZE // 2, SIZE):
        h2 = 2 * h
        x = torch.relu(torch.randn((B, h, h, f), generator=gen, device=dev))
        w1, w2 = (torch.randn((f, f, 3, 3), generator=gen, device=dev) / 24 for _ in range(2))
        b1, b2 = (0.1 * torch.randn(f, generator=gen, device=dev) for _ in range(2))
        case = f"{B}x{h}x{h}x{f}->{h2}^2x{f} float32"
        flops = 2 * conv_flops(B, h2, h2, f, f)
        convs = zip(("conv1", "conv2", "dgrad of conv2 (masked)", "dgrad of conv1"),
                    sm90.unetup_launches(B, h2, h2, 0, f, f, True)
                    + sm90.upconv_bwd_launches(B, h2, h2, f, f, True)[:2])
        for name, ln in convs:
            halo = ln.get("mainloop") == sm90.MAINLOOP_HALO
            print(json.dumps({"f32_head_launch": name, "case": case,
                              "mainloop": "halo" if halo else "tap", "tile": list(ln["tile"]),
                              "k_slices": ln["k_slices"],
                              "flop_per_l2_byte": sm90.flop_per_l2_byte(ln)}), flush=True)
            check(halo, f"upconv f32 {case} {name}: not on the halo mainloop")
        out, y1 = _upconv_cuda(x, w1, b1, w2, b2, want_y1=True)
        check(torch.equal(out, _upconv_cuda(x, w1, b1, w2, b2)),
              f"upconv_f32 {case}: two launches differ")
        pout, py1 = _upconv_plain_y1(x, w1, b1, w2, b2)

        def lib_f(x=x, w1=w1, b1=b1, w2=w2, b2=b2):
            return F.relu(F.conv2d(F.relu(F.conv2d(cl(upsample2x(x)), w1, b1, padding=1)), w2,
                                   b2, padding=1))

        rel = record("upconv_f32", case, [out, y1], [pout, py1],
                     lambda: _upconv_cuda(x, w1, b1, w2, b2),
                     lambda: _upconv_plain_y1(x, w1, b1, w2, b2), tf32_on(lib_f), flops,
                     nbytes(x, w1, w2, out, y1), peak=PEAK_TF32)
        check(rel <= tf32.CONV_REL_TOL, f"upconv_f32 {case}: rel err {rel:.3g}")
        up = upsample2x(x)
        for last in (False, True):
            f32_witness(f"upconv_f32 {case} conv1", y1,
                        lambda r: f32_tile([up], w1, r, b1, last=last), 9 * f, "round", last)
            f32_witness(f"upconv_f32 {case} conv2", out,
                        lambda r: f32_tile([y1], w2, r, b2, last=last), 9 * f, "round", last)
        del pout, py1, up
        g = torch.randn((B, h2, h2, f), generator=gen, device=dev)
        args = (g, out, y1, x, w1, w2)
        res = upconv_bwd(*args)
        check(all(torch.equal(a, b) for a, b in zip(res, upconv_bwd(*args))),
              f"upconv_bwd_f32 {case}: two launches differ")
        ref = upconv_bwd_plain(*args)
        errs = {n: rel_err(a, b)[1] for n, a, b in
                zip(("dx", "dk1", "db1", "dk2", "db2"), res, ref)}
        for n, e in errs.items():
            tol = tf32.CONV_REL_TOL if n == "dx" else tf32.WGRAD_CHAIN_REL_TOL
            check(e <= tol, f"upconv_bwd_f32 {case}: {n} rel err {e:.3g} > {tol}")
        g2 = torch.where(out > 0, g, 0)
        dk2_64 = torch.ops.aten.convolution_backward(
            cl(g2.double()), cl(y1.double()), w2.double(), None, [1, 1], [1, 1], [1, 1], False,
            [0, 0], 1, [False, True, False])[1]
        print(json.dumps({"upconv_bwd_f32": case, "rel_err_by_output": errs,
                          "dk2_kernel_vs_float64": rel_err(res[3], dk2_64)[1],
                          "dk2_plain_vs_float64": rel_err(ref[3], dk2_64)[1]}), flush=True)
        del dk2_64
        dz1, dups = _upconv_bwd_cuda(*args)[5:]
        for last in (False, True):
            f32_witness(f"upconv_bwd_f32 {case} dz1", dz1,
                        lambda r: f32_tile([g2], flip_t(w2), r, mask=y1, last=last), 9 * f,
                        "round", last)
            f32_witness(f"upconv_bwd_f32 {case} dups", dups,
                        lambda r: f32_tile([dz1], flip_t(w1), r, last=last), 9 * f, "round",
                        last)
        del dz1, dups, g2
        # the planted dropped split: the first of the dk2 GEMM's splits (the
        # dk1 GEMM's plan has the same, both over the 64 channels' pixels)
        ns = bwd_plan(B, h2, h2, f, f, True)[1]
        check(ns[0] == ns[1], f"upconv_bwd_f32 {case}: split counts {ns}")
        bad = g.masked_fill(first_split_mask(B, h2, h2, ns[0])[..., None], 0)
        fres = upconv_bwd(bad, out, y1, x, w1, w2)
        fault = {"dk1": rel_err(fres[1], ref[1])[1], "dk2": rel_err(fres[3], ref[3])[1]}
        print(json.dumps({"wgrad_planted_fault": f"upconv_bwd_f32 {case}",
                          "dropped_split_of": ns[0], "rel_err": fault,
                          "bounds": [tf32.WGRAD_REL_TOL, tf32.WGRAD_CHAIN_REL_TOL]}), flush=True)
        check(min(fault.values()) > tf32.WGRAD_CHAIN_REL_TOL,
              f"upconv_bwd_f32 {case}: a dropped split reads {fault}, inside the bounds")
        del bad, fres
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            wg = [w.detach().requires_grad_() for w in (w1, w2)]
            bg = [b.detach().requires_grad_() for b in (b1, b2)]
            yl = tf32_on(lambda: F.relu(F.conv2d(F.relu(F.conv2d(
                cl(upsample2x(xg)), wg[0], bg[0], padding=1)), wg[1], bg[1], padding=1)))()
        lib = tf32_on(lambda: torch.autograd.grad(yl, [xg, *wg, *bg], cl(g), retain_graph=True))
        record("upconv_bwd_f32", case, list(res), list(ref), lambda: upconv_bwd(*args),
               lambda: upconv_bwd_plain(*args), lib, 2 * flops, nbytes(*args, *res),
               peak=PEAK_TF32)
        del x, g, out, y1, res, ref, args, xg, wg, bg, yl, lib
        torch.cuda.empty_cache()


# the float32 adjoint against its plain version: the same float32 products
# summed in another order (fused multiply-adds against index_add_'s rounded
# products and sums)
F32_ADJOINT_REL_TOL = 1e-5


def f32_loss_kernels(record, gen):
    """#27 / #29's float32 instantiations at the float32 step's shapes:
    8 × 512² × 21 (voc, CE without dice) and the medical preset's C = 2, each
    against its plain version (loss within 1e-4, f_score within 1e-4, dW /
    db within 1e-3, dfeat within the conv bound), bit-identical on a second
    run."""
    from tpu_unet_torch.kernels.loss import (final_ce_dice_bwd, final_ce_dice_bwd_plain,
                                             final_ce_dice_fwd, final_ce_dice_fwd_plain,
                                             pack_targets)

    from tpu_unet_torch.kernels import tf32

    dev = torch.device("cuda")
    for c in (CLASSES["unet_vgg"], 2):
        feats = torch.relu(torch.randn((BATCH, SIZE, SIZE, 64), generator=gen, device=dev))
        w = torch.randn((c, 64, 1, 1), generator=gen, device=dev) / 8
        b = 0.1 * torch.randn(c, generator=gen, device=dev)
        t = torch.randint(0, c, (BATCH, SIZE, SIZE), generator=gen, device=dev,
                          dtype=torch.int32)
        t = pack_targets(torch.where(torch.rand(t.shape, generator=gen, device=dev) < 0.03,
                                     torch.full_like(t, 255), t), c)
        cw = tuple(1.0 for _ in range(c))
        npix = feats.numel() // 64
        gl = torch.tensor(1.0, device=dev)
        case = f"{BATCH}x{SIZE}x{SIZE}x64 float32 -> {c} classes, dice=False"
        loss, fs, res = final_ce_dice_fwd(feats, w, b, t, cw, c, False)
        ploss, pfs, pres = final_ce_dice_fwd_plain(feats, w, b, t, cw, c, False)
        again = final_ce_dice_fwd(feats, w, b, t, cw, c, False)
        check(bool(torch.equal(loss, again[0])), f"final_ce_dice_fwd_f32 {case}: runs differ")
        lrel = abs(loss.item() - ploss.item()) / abs(ploss.item())
        check(lrel <= 1e-4 and abs(fs.item() - pfs.item()) <= 1e-4,
              f"final_ce_dice_fwd_f32 {case}: loss rel {lrel:.3g}, f_score {fs.item()}")
        f2, t_cl = feats.reshape(-1, 64), torch.clamp_max(t, c).long().reshape(-1)

        def lib_fwd(f2=f2, w=w, b=b, t_cl=t_cl, c=c):
            return F.cross_entropy(F.linear(f2, w.reshape(c, 64), b), t_cl, ignore_index=c)

        record("final_ce_dice_fwd_f32", case, [loss, fs], [ploss, pfs],
               lambda: final_ce_dice_fwd(feats, w, b, t, cw, c, False),
               lambda: final_ce_dice_fwd_plain(feats, w, b, t, cw, c, False),
               tf32_on(lib_fwd), 2.0 * npix * 64 * c, nbytes(feats, t, w, b), peak=PEAK_TF32)
        out = final_ce_dice_bwd(feats, w, b, t, cw, c, False, res, gl)
        ref = final_ce_dice_bwd_plain(feats, w, b, t, cw, c, False, pres, gl)
        rels = [rel_err(o, r)[1] for o, r in zip(out, ref)]
        check(rels[0] <= tf32.CONV_REL_TOL and max(rels[1:]) <= 1e-3,
              f"final_ce_dice_bwd_f32 {case}: rel errs {rels}")
        check(all(torch.equal(a, b) for a, b in
                  zip(out, final_ce_dice_bwd(feats, w, b, t, cw, c, False, res, gl))),
              f"final_ce_dice_bwd_f32 {case}: two runs differ")
        fg = f2.detach().clone().requires_grad_()
        wg, bg = w.reshape(c, 64).clone().requires_grad_(), b.clone().requires_grad_()
        with torch.enable_grad():
            graph = F.cross_entropy(F.linear(fg, wg, bg), t_cl, ignore_index=c)
        record("final_ce_dice_bwd_f32", case, list(out), list(ref),
               lambda: final_ce_dice_bwd(feats, w, b, t, cw, c, False, res, gl),
               lambda: final_ce_dice_bwd_plain(feats, w, b, t, cw, c, False, pres, gl),
               tf32_on(lambda: torch.autograd.grad(graph, [fg, wg, bg], retain_graph=True)),
               6.0 * npix * 64 * c, nbytes(feats, t, w, b, *out), peak=PEAK_TF32)
        del feats, t, out, ref, fg, wg, bg, graph, f2, t_cl
        torch.cuda.empty_cache()


def f32_single_tile_readings(gen):
    """One 8 × 16 tile of each float32 product at the path's widths, as
    phase 2 reads the bf16 ones: the stem (conv1_1 over a float32 image,
    conv1_2), up1's and up4's conv1 over [skip | up], #13's two dgrads and
    the weight-gradient GEMM's dk (the first two against the TF32
    emulation of both operand rules, dk against the rounding one, the only
    one its register fragments take; conv1 under the rule of the mainloop
    its plan names, ``tf32.launch_rule``); kernel and plain version against
    the exact float64 product too."""
    from tpu_unet_torch.kernels.decoder_fuse import _unetup_cuda
    from tpu_unet_torch.kernels.decoder_train import flip_t, unetup_bwd, unetup_wgrad
    from tpu_unet_torch.nn.resize import upsample2x

    from tpu_unet_torch.kernels import sm90, tf32

    dev = torch.device("cuda")
    lines = []
    for cs, cx, f in ((64, 128, 64), (512, 512, 512)):
        skip = torch.relu(torch.randn((1, 8, 16, cs), generator=gen, device=dev))
        x = torch.relu(torch.randn((1, 4, 8, cx), generator=gen, device=dev))
        w1 = torch.randn((f, cs + cx, 3, 3), generator=gen, device=dev) / (9 * (cs + cx)) ** 0.5
        w2 = torch.randn((f, f, 3, 3), generator=gen, device=dev) / (9 * f) ** 0.5
        b1 = 0.1 * torch.randn(f, generator=gen, device=dev)
        out, y1 = _unetup_cuda(skip, x, w1, b1, w2, b1, want_y1=True)
        up = upsample2x(x)
        rule = tf32.launch_rule(sm90.unetup_launches(1, 8, 16, cs, cx, f, True)[0])
        lines.append(f32_witness(f"single tile Cs={cs} Cx={cx} F={f} conv1", y1,
                                 lambda r: f32_tile([skip, up], w1, r, b1), 9 * (cs + cx),
                                 rule))
        g = torch.randn((1, 8, 16, f), generator=gen, device=dev)
        dskip, dups, g2, dz1 = unetup_bwd(g, out, y1, w1, w2, cs)
        lines.append(f32_witness(f"single tile F={f} dz1", dz1,
                                 lambda r: f32_tile([g2], flip_t(w2), r, mask=y1), 9 * f))
        lines.append(f32_witness(f"single tile F={f} [dskip | dups]",
                                 torch.cat([dskip, dups], -1),
                                 lambda r: f32_tile([dz1], flip_t(w1), r), 9 * f))
        dk1 = unetup_wgrad(skip, x, dz1, y1, dz1)[0]
        cc = torch.cat([skip, up], -1)
        e = {"round": rel_err(dk1, tf32.wgrad(cc, dz1))[1],
             "exact": rel_err(dk1, torch.ops.aten.convolution_backward(
                 cl(dz1.double()), cl(cc.double()), w1.double(), None, [1, 1], [1, 1], [1, 1],
                 False, [0, 0], 1, [False, True, False])[1])[1]}
        tol = tf32.tile_rel_tol(8 * 16)  # the 128 pixels of the tile
        print(json.dumps({"f32_witness": f"single tile dk1 Cs={cs} Cx={cx} F={f}",
                          "kernel_vs_tf32_rounded": e["round"],
                          "kernel_vs_float64": e["exact"], "rule": "round", "k": 128,
                          "bound": tol}), flush=True)
        check(e["round"] <= tol, f"single tile dk1 F={f}: {e}")
    return lines


# The float32 weight-gradient GEMM's shapes in the float32 path at 512²,
# batch 8 (the stem, blocks 2-5, both decoders, both heads): every distinct
# (H, C, F), a dk1 over a concat [skip | up] as its pair of launches into one
# dk (Cx > 0): (what, H, Cs, Cx, F); tests/test_torch_tf32.py holds it to
# the float32 plans' launches
WGRAD_F32_SHAPES = (
    ("stem conv1_2, vgg up1 dk2, rn50 head", 512, 64, 0, 64),
    ("vgg up1 dk1", 512, 64, 128, 64),
    ("block 2 conv 1", 256, 64, 0, 128),
    ("block 2 conv 2, vgg up2 dk2", 256, 128, 0, 128),
    ("vgg up2 dk1", 256, 128, 256, 128),
    ("rn50 up1 dk1", 256, 64, 128, 64),
    ("rn50 up1 dk2", 256, 64, 0, 64),
    ("block 3 conv 1", 128, 128, 0, 256),
    ("block 3 conv 2-3, vgg up3 dk2", 128, 256, 0, 256),
    ("vgg up3 dk1", 128, 256, 512, 256),
    ("rn50 up2 dk1", 128, 256, 256, 128),
    ("rn50 up2 dk2", 128, 128, 0, 128),
    ("block 4 conv 1", 64, 256, 0, 512),
    ("block 4 conv 2-3, vgg up4 dk2", 64, 512, 0, 512),
    ("vgg up4 dk1", 64, 512, 512, 512),
    ("rn50 up3 dk1", 64, 512, 512, 256),
    ("rn50 up3 dk2", 64, 256, 0, 256),
    ("block 5, rn50 up4 dk2", 32, 512, 0, 512),
    ("rn50 up4 dk1", 32, 1024, 2048, 512),
    ("self_net head", 1024, 64, 0, 64),
)


def f32_wgrad_gemm(card: str, gen):
    """The float32 weight-gradient GEMM alone (``decoder_train.wgrad_gemm``,
    TF32 wgmma) at each of its shapes (``WGRAD_F32_SHAPES``): against
    ``conv_wgrad``'s plain float32 version (TF32 off) within WGRAD_REL_TOL,
    the bias exact to float32's sums; a single-tile float64 witness (one 8
    × 16 patch, a chain of 128 pixels) under the rule ``kernels/tf32.py``
    states (both operands rounded) within ``tile_rel_tol``, the truncating
    rule's reading beside; a planted dropped split (the first of the
    plan's) read above WGRAD_REL_TOL; a second launch bit-identical; ms by
    CUDA events beside cuDNN's float32 weight gradient alone with TF32 on
    (``convolution_backward``, output mask [False, True, False]), the TF32
    bound and the share."""
    from tpu_unet_torch.kernels import sm90, tf32
    from tpu_unet_torch.kernels.decoder_train import conv_wgrad, wgrad_gemm

    dev, B, cb = torch.device("cuda"), BATCH, torch.ops.aten.convolution_backward
    t0 = time.perf_counter()
    for what, h, cs, cx, f in WGRAD_F32_SHAPES:
        c = cs + cx
        v = torch.relu(torch.randn((B, h, h, c), generator=gen, device=dev))
        g = torch.randn((B, h, h, f), generator=gen, device=dev)
        parts = [v[..., :cs].contiguous(), v[..., cs:].contiguous()] if cx else [v]

        def gemm(g=g, parts=parts, c=c):
            dk, db = wgrad_gemm(parts[0], g, c, 0, True)
            if len(parts) > 1:
                wgrad_gemm(parts[1], g, c, cs, False, dk)
            return dk, db

        dk, db = gemm()
        again = gemm()
        check(torch.equal(dk, again[0]) and torch.equal(db, again[1]),
              f"wgrad_gemm_f32 {what}: two launches differ")
        ref = conv_wgrad(v, g)
        rel = rel_err(dk, ref)[1]
        db_rel = rel_err(db, g.double().sum((0, 1, 2)))[1]
        check(rel <= tf32.WGRAD_REL_TOL, f"wgrad_gemm_f32 {what}: rel err {rel:.3g}")
        check(db_rel <= 1e-5, f"wgrad_gemm_f32 {what}: db rel err {db_rel:.3g}")
        # the first split of the first launch's plan dropped
        ns = sm90.wgrad_launch(B, h, h, cs, f, c, 0, True, True)["nsplit"]
        bad = g.masked_fill(first_split_mask(B, h, h, ns)[..., None], 0)
        fault = rel_err(gemm(bad)[0], ref)[1]
        check(fault > tf32.WGRAD_REL_TOL,
              f"wgrad_gemm_f32 {what}: a dropped split reads {fault:.3g}")
        # one patch: the K chain of 128 pixels
        v1, g1 = v[:1, :8, :16].contiguous(), g[:1, :8, :16].contiguous()
        tile = gemm(g1, [p[:1, :8, :16].contiguous() for p in parts])[0]
        wit = {r: rel_err(tile, tf32.wgrad(v1, g1, r))[1] for r in ("round", "trunc")}
        tol = tf32.tile_rel_tol(128)
        check(wit["round"] <= tol, f"wgrad_gemm_f32 {what}: single tile {wit} > {tol:.3g}")
        ms = time_ms(gemm)
        lib_ms = time_ms(tf32_on(lambda v=v, g=g, f=f, c=c: cb(
            cl(g), cl(v), torch.empty((f, c, 3, 3), device=dev), None, [1, 1], [1, 1], [1, 1],
            False, [0, 0], 1, [False, True, False])[1]))
        b_ms = conv_flops(B, h, h, c, f) / PEAK_TF32 * 1e3
        print(json.dumps({"wgrad_gemm_f32": what, "shape": f"{B}x{h}x{h} C={cs}"
                          + (f"+{cx}" if cx else "") + f" F={f}", "nsplit": ns,
                          "rel_err": rel, "db_rel_err": db_rel, "dropped_split_rel_err": fault,
                          "tile_vs_tf32_rounded": wit["round"],
                          "tile_vs_tf32_truncated": wit["trunc"], "tile_bound": tol, "ms": ms,
                          "cudnn_tf32_ms": lib_ms, "bound_ms": b_ms,
                          "share_of_bound": b_ms / ms, "gpu": card}), flush=True)
        del v, g, parts, dk, db, again, ref, bad
        torch.cuda.empty_cache()
    print(f"float32 GEMM alone at {len(WGRAD_F32_SHAPES)} shapes in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


@contextlib.contextmanager
def plain_on_card():
    """Within the block, every kernel wrapper takes its plain version for
    the card's tensors too (its ``on_cpu`` test answers yes): the port's
    step in plain PyTorch on the card, no kernel launched."""
    import importlib
    import pkgutil

    import tpu_unet_torch.kernels as kernels

    mods = [importlib.import_module(f"tpu_unet_torch.kernels.{m.name}")
            for m in pkgutil.iter_modules(kernels.__path__)]
    saved = [(m, m.on_cpu) for m in mods if hasattr(m, "on_cpu")]
    try:
        for m, _ in saved:
            m.on_cpu = lambda t: True
        yield
    finally:
        for m, fn in saved:
            m.on_cpu = fn


def emulated_f32_step(init, batch, cfg):
    """Loss and float32 gradients of one step of the port's float32 step
    from ``init`` with every kernel's TF32 arithmetic emulated
    (``kernels/tf32.py::emulated_plain_versions``: TF32 operands, float64
    sums) through the plain versions on the card: the reading that fixes
    STEP_LOSS_REL_TOL at the card's shapes."""
    from tpu_unet_torch.kernels import tf32
    from tpu_unet_torch.train import step as tstep

    net = copy.deepcopy(init)
    state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9))
    with plain_on_card(), tf32.emulated_plain_versions():
        _, m = tstep.make_train_step(net, cfg)(state, batch, 1e-4)
    grads = {k: p.grad.float().clone() for k, p in net.named_parameters()}
    del net, state
    return m["loss"].item(), grads


def read_emulated_step(name, init, batch, cfg, ploss, pgrads, card):
    """Read ``name``'s float32 step with the TF32 arithmetic emulated
    (:func:`emulated_f32_step`) against the plain float32 step's loss and
    gradients: its loss within ``tf32.step_loss_emulated(name)``, the
    reading that fixes the model's loss bound (STEP_LOSS_EMULATED, or the
    model's own), its gradients times 4 within STEP_GRAD_REL_TOL and
    STEP_GRAD_COS."""
    from tpu_unet_torch.kernels import tf32

    t0 = time.perf_counter()
    eloss, egrads = emulated_f32_step(init, batch, cfg)
    elrel, er = abs(eloss - ploss) / abs(ploss), grad_readings(egrads, pgrads)
    del egrads
    emulated = tf32.step_loss_emulated(name)
    worst = max(er, key=lambda k: er[k][0])
    print(json.dumps({
        "f32_emulated_step": name, "batch": batch["image"].shape[0], "size": SIZE,
        "loss_rel_err_vs_plain": elrel, "worst_grad_rel_err": er[worst][0],
        "worst_grad": worst, "worst_grad_cosine": min(v[1] for v in er.values()),
        "fixes": {"step_loss_emulated": emulated,
                  "step_loss_rel_tol": tf32.step_loss_rel_tol(name)},
        "seconds": time.perf_counter() - t0, "gpu": card}), flush=True)
    check(elrel <= emulated, f"emulated float32 {name} step: loss rel {elrel:.3g} over the "
                             f"reading {emulated:.3g} that fixes its loss bound")
    check(4 * er[worst][0] <= tf32.STEP_GRAD_REL_TOL
          and 4 * (1 - min(v[1] for v in er.values())) <= 1 - tf32.STEP_GRAD_COS,
          f"emulated float32 {name} step: gradients times 4 outside STEP_GRAD_REL_TOL / "
          "STEP_GRAD_COS")


def f32_train_step(card: str):
    """The float32 ``"paired"`` step of unet_vgg at 512², batch 8, 21
    classes, as the voc preset trains (CE without dice, Adam 1e-4), from
    ``init_model(seed=0)`` weights: exact launches of the float32 keys,
    loss and every gradient against a plain float32 step (TF32 off): closer
    to it than the bf16 step on the same weights and batch is, in the loss
    and in every gradient, the loss within STEP_LOSS_REL_TOL, every
    gradient within STEP_GRAD_REL_TOL and STEP_GRAD_COS; first, the same
    step with the TF32 arithmetic emulated in float64 (the reading that
    fixes STEP_LOSS_REL_TOL, which must still hold it); times (events,
    host, device, port kernels, idle share) and peak memory beside the bf16
    step's; the ``"fused"`` route held the same way; the preset's batch 2;
    a 128² step against the CPU float32 path, closer than the bf16 step and
    within STEP_LOSS_REL_TOL (the emulation read there too);
    20 steps on one batch, the loss falling.  Returns the launches."""
    from tpu_unet_torch.models.registry import build_model, init_model
    from tpu_unet_torch.train import step as tstep

    from tpu_unet_torch.kernels import tf32

    totals: dict = {}
    classes = CLASSES["unet_vgg"]
    cw = tuple(1.0 for _ in range(classes))
    f32 = tstep.StepConfig(classes, cw)
    bf = dataclasses.replace(f32, compute_dtype=torch.bfloat16)
    batch = rect_batch(torch.Generator().manual_seed(20), BATCH, SIZE, classes, "cuda")
    init = init_model(build_model("unet_vgg", classes), seed=0).cuda()
    ploss, pgrads, _ = plain_step(init, batch, classes, cw, torch.float32, dice=False)

    read_emulated_step("unet_vgg", init, batch, f32, ploss, pgrads, card)

    for route in ("paired", "fused"):
        cfg32 = dataclasses.replace(f32, train_route=route)
        cfg16 = dataclasses.replace(bf, train_route=route)
        loss16, g16, _, _, t16 = timed_train_step(init, batch, cfg16, 1e-4, reps=5)
        loss32, g32, st32, counts, t32 = timed_train_step(
            init, batch, cfg32, 1e-4, F32_TRAIN_STEP[route], f"float32 train step ({route})",
            reps=5)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        r32, r16 = grad_readings(g32, pgrads), grad_readings(g16, pgrads)
        held = hold_f32_step(f"float32 step ({route})", loss32, g32, st32, loss16, g16, ploss,
                             pgrads, {})
        print(json.dumps({
            "train_step": "unet_vgg", "dtype": "float32 (TF32 products)", "train_route": route,
            "batch": BATCH, "size": SIZE, "classes": classes, "recipe": "voc: CE, Adam 1e-4",
            "launches": counts, **t32, "loss": loss32, "loss_plain_f32_step": ploss, **held,
            "grad_rel_err_f32_vs_bf16": {k: [r32[k][0], r16[k][0]] for k in r32},
            "bf16_step": t16, "gpu": card}), flush=True)
        del g16, g32
    del pgrads
    torch.cuda.empty_cache()

    # the preset's batch 2
    small = {k: v[:2] for k, v in batch.items()}
    net = copy.deepcopy(init)
    state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9))
    fn = tstep.make_train_step(net, f32)
    (_, m), counts = counted(F32_TRAIN_STEP["paired"], "float32 step, batch 2",
                             lambda: fn(state, small, 1e-4))
    ms = time_ms(lambda: fn(state, small, 1e-4), reps=5)
    print(json.dumps({"train_step": "unet_vgg float32", "batch": 2, "size": SIZE,
                      "step_ms_events": ms, "img_per_s": 2e3 / ms, "loss": m["loss"].item(),
                      "gpu": card}), flush=True)
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    del net, state, fn

    # the card against the CPU float32 path: one step at batch 1, 128², the
    # float32 step closer to it than the bf16 step
    one = rect_batch(torch.Generator().manual_seed(21), 1, 128, classes, "cuda")
    cpu_net = copy.deepcopy(init).cpu()
    _, mcpu = tstep.make_train_step(cpu_net, f32)(
        tstep.TrainState(cpu_net, tstep.make_optimizer(cpu_net)),
        {k: v.cpu() for k, v in one.items()}, 1e-4)
    cpu_rel = {}
    for name, cfg in (("float32", f32), ("bf16", bf)):
        card_net = copy.deepcopy(init)
        _, mc = tstep.make_train_step(card_net, cfg)(
            tstep.TrainState(card_net, tstep.make_optimizer(card_net)), one, 1e-4)
        cpu_rel[name] = abs(mc["loss"].item() - mcpu["loss"].item()) / abs(mcpu["loss"].item())
        del card_net
    eloss, _ = emulated_f32_step(init, one, f32)
    cpu_rel["emulated float32"] = abs(eloss - mcpu["loss"].item()) / abs(mcpu["loss"].item())
    check(cpu_rel["float32"] < cpu_rel["bf16"],
          f"float32 step 128² vs CPU float32: loss rel {cpu_rel}, not closer than bf16's")
    check(cpu_rel["float32"] <= tf32.STEP_LOSS_REL_TOL
          and cpu_rel["emulated float32"] <= tf32.STEP_LOSS_EMULATED,
          f"float32 step 128² vs CPU float32: loss rel {cpu_rel}, bound "
          f"{tf32.STEP_LOSS_REL_TOL:.3g} (the emulation's {tf32.STEP_LOSS_EMULATED:.3g})")
    del cpu_net

    lnet = copy.deepcopy(init)
    lstate = tstep.TrainState(lnet, tstep.make_optimizer(lnet, "adam", 0.9))
    lfn = tstep.make_train_step(lnet, f32)
    losses = [lfn(lstate, batch, 1e-4)[1]["loss"].item() for _ in range(20)]
    check(losses[-1] <= 0.9 * losses[0],
          f"float32, 20 steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}, not 10% lower")
    print(json.dumps({"train_step": "unet_vgg float32",
                      "loss_rel_err_vs_cpu_f32_128px_by_dtype": cpu_rel,
                      "losses_20_steps": losses, "gpu": card}), flush=True)
    del lnet, lstate, init
    torch.cuda.empty_cache()
    return totals


# the float32 step's launches: the paired route's kernels under their
# float32 keys; "fused" as its bf16 counterpart
F32_TRAIN_STEP = {route: {k + "_f32": v for k, v in TRAIN_STEP[route].items()}
                  for route in TRAIN_STEP}
# unet_resnet50's and self_net's float32 "paired" steps: their bf16
# steps' kernels under the float32 keys
F32_MODEL_STEP = {"unet_resnet50": {k + "_f32": v for k, v in RN50_STEP.items()},
                  "self_net": {k + "_f32": v for k, v in SELF_NET_STEP.items()}}


@contextlib.contextmanager
def library_tf32_default():
    """Within the block, cuDNN's and cuBLAS's TF32 switches as PyTorch
    leaves them in a user's process (``TF32_DEFAULT``, read when this
    script is imported: cuDNN's on, cuBLAS's matmuls off); ``main()`` turns
    both off for the checks.  The float32 steps' times are taken under
    them: ResNet50, the DataB convs and the plain parts run on cuDNN."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = TF32_DEFAULT
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def grad_readings(grads: dict, ref: dict, skip=()) -> dict:
    """Each gradient's largest deviation from ``ref``'s relative to its
    largest entry, and its cosine, by name (``skip`` left out)."""
    out = {}
    for k, g in grads.items():
        if k in skip:
            continue
        a, b = g.ravel(), ref[k].ravel()
        cos = (a @ b / (a.norm() * b.norm()).clamp_min(1e-30)).item()
        out[k] = (((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item(), cos)
    return out


def timed_train_step(init, batch, cfg, lr, expect=None, what="", weight_decay=0.0,
                     seed=None, reps=3):
    """One step of the port's train step from a copy of ``init`` (Adam,
    momentum 0.9, ``weight_decay``; the dropout from a generator seeded
    ``seed``), counted against ``expect`` where given: (loss, float32
    gradients, running statistics, launches, times), the times — events,
    host, the profiler's device time, the port's kernels, the idle share —
    and the peak memory taken over further steps with the library's TF32 as
    PyTorch leaves it (:func:`library_tf32_default`)."""
    from tpu_unet_torch.train import step as tstep

    net = copy.deepcopy(init)
    state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9, weight_decay))
    fn = tstep.make_train_step(net, cfg)
    gen = None if seed is None else torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = lambda: fn(state, batch, lr, gen)  # noqa: E731
    if expect is None:
        _, m = step()
        counts = None
    else:
        (_, m), counts = counted(expect, what, step)
    loss = m["loss"].item()
    grads = {k: p.grad.float().clone() for k, p in net.named_parameters() if p.grad is not None}
    stats = bn_stats(net)
    with library_tf32_default():
        ms = time_ms(step, reps=reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / reps
        profile = device_breakdown(lambda _n, _i: step(), None, None, steps=2)
    n = batch["image"].shape[0]
    times = {"step_ms_events": ms, "step_ms_host": host * 1e3, "img_per_s": n / host,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
             "device_ms": profile["device_ms_per_step"],
             "port_kernels_ms": profile["port_kernels_ms"], "idle_share": profile["idle_share"],
             "top_kernels_ms": profile["top_kernels_ms"],
             "library_tf32": "PyTorch's default: cuDNN {}, cuBLAS matmul {}".format(
                 *("on" if v else "off" for v in TF32_DEFAULT))}
    del net, state, fn, step
    return loss, grads, stats, counts, times


def hold_f32_step(what, loss32, g32, st32, loss16, g16, ploss, pgrads, pstats, skip=(),
                  loss_tol=None):
    """Hold a float32 step to the plain float32 step (TF32 off): closer to
    it than the bf16 step is, in the loss and in every gradient (``skip``
    left out), the loss within ``loss_tol`` (STEP_LOSS_REL_TOL, or a
    model's own, ``tf32.step_loss_rel_tol``), every gradient within
    STEP_GRAD_REL_TOL and STEP_GRAD_COS, the running statistics within
    1e-2.  Returns the readings."""
    from tpu_unet_torch.kernels import tf32

    loss_tol = tf32.STEP_LOSS_REL_TOL if loss_tol is None else loss_tol
    lrel32, lrel16 = abs(loss32 - ploss) / abs(ploss), abs(loss16 - ploss) / abs(ploss)
    r32, r16 = grad_readings(g32, pgrads, skip), grad_readings(g16, pgrads, skip)
    check(lrel32 < lrel16 or lrel32 == 0.0,
          f"{what}: loss rel {lrel32:.3g} not closer than bf16's {lrel16:.3g}")
    check(lrel32 <= loss_tol, f"{what}: loss rel {lrel32:.3g} > {loss_tol:.3g}")
    worse = [k for k in r32 if not r32[k][0] < r16[k][0]]
    check(not worse, f"{what}: gradients not closer than bf16's: {worse}")
    for k, (rel, cos) in r32.items():
        check(rel <= tf32.STEP_GRAD_REL_TOL and cos >= tf32.STEP_GRAD_COS,
              f"{what}: gradient of {k}: rel {rel:.3g}, cosine {cos:.6f}")
    stat_rel = max((((st32[k] - v).abs().max() / v.abs().max().clamp_min(1e-30)).item()
                    for k, v in pstats.items()), default=0.0)
    check(stat_rel <= 1e-2, f"{what}: running statistics rel err {stat_rel:.3g} vs plain")
    return {"loss_rel_err_vs_plain": lrel32, "loss_bound": loss_tol,
            "bf16_loss_rel_err_vs_plain": lrel16,
            "worst_grad_rel_err": max(v[0] for v in r32.values()),
            "worst_grad": max(r32, key=lambda k: r32[k][0]),
            "worst_grad_cosine": min(v[1] for v in r32.values()),
            "bf16_worst_grad_rel_err": max(v[0] for v in r16.values()),
            "bf16_worst_grad_cosine": min(v[1] for v in r16.values()),
            "running_stats_rel_err_vs_plain": stat_rel}


def f32_model_step(name: str, card: str, seed: int):
    """The float32 ``"paired"`` step of ``unet_resnet50`` (the
    ``voc_resnet50`` recipe with ``fp16=False``, ResNet50 on cuDNN with
    batch norm on the batch statistics) or ``self_net`` (the plain losses
    on its 2x logits) at 512², batch 8, 21 classes, CE + dice, Adam 1e-4,
    from ``init_model(seed=0)`` weights: first the step with the TF32
    arithmetic emulated (its loss within ``tf32.step_loss_emulated(name)``,
    STEP_LOSS_EMULATED or the model's own reading; its gradients times 4
    within STEP_GRAD_REL_TOL / STEP_GRAD_COS), then the kernels' step with
    exact launches of the float32 keys held by :func:`hold_f32_step`, the
    loss within ``tf32.step_loss_rel_tol(name)``;
    times and peak memory beside the bf16 step's.  Returns the launches."""
    from tpu_unet_torch.models.registry import build_model, init_model
    from tpu_unet_torch.train import step as tstep

    from tpu_unet_torch.kernels import tf32

    classes = CLASSES[name]
    cw = tuple(1.0 for _ in range(classes))
    f32 = tstep.StepConfig(classes, cw, use_dice=True)
    bf = dataclasses.replace(f32, compute_dtype=torch.bfloat16)
    batch = rect_batch(torch.Generator().manual_seed(seed), BATCH, SIZE, classes, "cuda")
    init = init_model(build_model(name, classes), seed=0).cuda()
    ploss, pgrads, pstats = plain_step(init, batch, classes, cw, torch.float32)
    read_emulated_step(name, init, batch, f32, ploss, pgrads, card)
    torch.cuda.empty_cache()
    loss16, g16, _, _, t16 = timed_train_step(init, batch, bf, 1e-4)
    loss32, g32, st32, counts, t32 = timed_train_step(init, batch, f32, 1e-4,
                                                      F32_MODEL_STEP[name],
                                                      f"float32 {name} train step")
    held = hold_f32_step(f"float32 {name} step", loss32, g32, st32, loss16, g16, ploss, pgrads,
                         pstats, loss_tol=tf32.step_loss_rel_tol(name))
    print(json.dumps({
        "train_step": name, "dtype": "float32 (TF32 products)", "train_route": "paired",
        "batch": BATCH, "size": SIZE, "classes": classes, "recipe": "CE + dice, Adam 1e-4",
        "launches": counts, **t32, "loss": loss32, "loss_plain_f32_step": ploss, **held,
        "bf16_step": t16, "gpu": card}), flush=True)
    del init, pgrads, pstats, g16, g32
    torch.cuda.empty_cache()
    return counts


def f32_datab_step(name: str, card: str):
    """The float32 DataB step of ``name`` (``datab_step``'s recipe with
    ``fp16=False``: 256², batch 32, 4 classes, focal + dice with the
    preset's class weights, Adam at ``fit``'s learning rate; cuDNN, batch
    norm on the batch statistics, the logit-level loss #25 / #26 on float32
    logits) held by :func:`hold_f32_step` against a plain float32 step with
    the same dropout generator (the biases that feed a batch norm, whose
    exact gradient is 0, left out); times beside the bf16 step's.  Returns
    the launches."""
    from tpu_unet_torch.configs.presets import get_preset
    from tpu_unet_torch.models.registry import build_model, init_model
    from tpu_unet_torch.train import step as tstep
    from tpu_unet_torch.train.schedules import adaptive_lr

    classes, n, size = 4, DATAB_BATCH, DATAB_SIZE
    preset = get_preset(name)
    lr = adaptive_lr(preset.init_lr, preset.min_lr, n, preset.optimizer_type)[0]
    f32 = tstep.StepConfig(classes, DATAB_CW[name], use_focal=True, use_dice=True)
    bf = dataclasses.replace(f32, compute_dtype=torch.bfloat16)
    batch = rect_batch(torch.Generator().manual_seed(12), n, size, classes, "cuda")
    init = init_model(build_model(name, classes), seed=0).cuda()
    ploss, pgrads, pstats = plain_datab_step(init, batch, f32, seed=5, dtype=torch.float32)
    wd = preset.weight_decay
    loss16, g16, _, _, t16 = timed_train_step(init, batch, bf, lr, weight_decay=wd, seed=5)
    loss32, g32, st32, counts, t32 = timed_train_step(
        init, batch, f32, lr, DATAB_STEP, f"float32 {name} train step", wd, seed=5)
    held = hold_f32_step(f"float32 {name} step", loss32, g32, st32, loss16, g16, ploss, pgrads,
                         pstats, cancelled_biases(init))
    print(json.dumps({
        "train_step": name, "dtype": "float32", "batch": n, "size": size, "classes": classes,
        "recipe": f"focal + dice, w={list(f32.cls_weights)}, Adam lr {lr:g} wd {wd:g}",
        "launches": counts, **t32, "loss": loss32, "loss_plain_f32_step": ploss, **held,
        "bf16_step": t16, "gpu": card}), flush=True)
    del init, pgrads, pstats, g16, g32
    torch.cuda.empty_cache()
    return counts


def f32_zoo_step(card: str):
    """Phase 7's deep-supervision step: ``balancedseg_fpn_sup`` in float32
    (its preset with ``fp16=False``: 256², batch 16, CE, aux weights (1.0,
    0.4, 0.3, 0.2); cuDNN, #25 / #26 on float32 logits once a head) held by
    :func:`hold_f32_step` against ``plain_zoo_step`` in float32 with the
    same dropout generator; times beside the bf16 step's.  Returns the
    launches."""
    from tpu_unet_torch.models.registry import build_model, init_model

    name = "balancedseg_fpn_sup"
    n, f32, lr, wd = zoo_recipe(name, torch.float32)
    bf = dataclasses.replace(f32, compute_dtype=torch.bfloat16)
    heads = len(f32.aux_weights)
    batch = rect_batch(torch.Generator().manual_seed(22), n, DATAB_SIZE, 4, "cuda")
    init = init_model(build_model(name, 4), seed=0).cuda()
    ploss, pgrads, pstats = plain_zoo_step(init, batch, f32, seed=5, dtype=torch.float32)
    loss16, g16, _, _, t16 = timed_train_step(init, batch, bf, lr, weight_decay=wd, seed=5)
    loss32, g32, st32, counts, t32 = timed_train_step(
        init, batch, f32, lr, {"ce_dice_fwd": heads, "ce_dice_bwd": heads},
        f"float32 {name} train step", wd, seed=5)
    held = hold_f32_step(f"float32 {name} step", loss32, g32, st32, loss16, g16, ploss, pgrads,
                         pstats, bn_fed_biases(init) | (set(g32) - set(pgrads)))
    print(json.dumps({
        "train_step": name, "dtype": "float32", "batch": n, "size": DATAB_SIZE, "classes": 4,
        "recipe": f"CE, aux={list(f32.aux_weights)}, Adam lr {lr:g} wd {wd:g}",
        "launches": counts, **t32, "loss": loss32, "loss_plain_f32_step": ploss, **held,
        "bf16_step": t16, "gpu": card}), flush=True)
    del init, pgrads, pstats, g16, g32
    torch.cuda.empty_cache()
    return counts


def write_medical(root: Path, n: int, size: int, seed: int):
    """A seeded Medical_Datasets tree (Images/*.png, Labels/*.png: a dark
    cell (label ≤ 127, class 1) on a bright field) with its train split."""
    from PIL import Image

    base = root / "Medical_Datasets"
    for d in ("Images", "Labels", "ImageSets/Segmentation"):
        (base / d).mkdir(parents=True, exist_ok=True)
    bt = rect_batch(torch.Generator().manual_seed(seed), n, size, 2, "cpu")
    ids = [f"m{i:03d}" for i in range(n)]
    for name, img, lbl in zip(ids, bt["image"].numpy(), bt["label"].numpy()):
        Image.fromarray(img).save(base / "Images" / f"{name}.png")
        Image.fromarray(np.where(lbl == 1, 0, 255).astype(np.uint8)).save(
            base / "Labels" / f"{name}.png")
    (base / "ImageSets" / "Segmentation" / "train.txt").write_text("\n".join(ids))
    return ids


@contextlib.contextmanager
def first_epoch_frozen():
    """Within the block, a preset's frozen phase is its first epoch only
    (``get_preset`` as ``cli train`` calls it, with ``freeze_epoch=1``)."""
    from tpu_unet_torch.configs import presets

    real = presets.get_preset
    presets.get_preset = lambda name, **kw: real(name, **{**kw, "freeze_epoch": 1})
    try:
        yield
    finally:
        presets.get_preset = real


def cli_train_f32(card: str):
    """``cli.main(["train", "--preset", "voc", "--no-pretrained", ...])`` at
    512², batch 2, over a seeded VOC-layout directory, the preset's frozen
    phase cut to its first epoch: one frozen epoch (the VGG frozen) and one
    unfrozen epoch of 2 steps each, a full-state
    resume for a third, ``serving_step()`` from the trained ``.pth``; then
    ``--preset medical`` (2 classes) for one epoch.  Launch counts of the
    float32 keys; returns them."""
    import io
    import tempfile

    from tpu_unet_torch import cli
    from tpu_unet_torch.configs.presets import get_preset
    from tpu_unet_torch.infer.wrapper import Unet
    from tpu_unet_torch.kernels import launch_counts, reset_launch_counts
    from tpu_unet_torch.train.checkpoint import load_any
    from tpu_unet_torch.train.fit import fit

    totals: dict = {}

    def add():
        for k, v in launch_counts.items():
            totals[k] = totals.get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        train_ids, val_ids = write_voc(tmp, 4, 2, SIZE, 21, seed=22)
        save = tmp / "voc"
        buf = io.StringIO()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), first_epoch_frozen():
            cli.main(["train", "--preset", "voc", "--no-pretrained", "--data-root", str(tmp),
                      "--epochs", "2", "--save-dir", str(save), "--no-eval"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        add()
        trained = dict(launch_counts)
        # 2 epochs of 2 steps, the paired route: the frozen epoch's VGG runs
        # its training kernels forward only (no backward: no weight of it
        # trains and the image needs no gradient)
        check(trained["unetup_bwd_f32"] == 16 and trained["final_ce_dice_bwd_f32"] == 4
              and trained["vgg_block3_bwd_f32"] == 6 and trained["vgg_stem_f32"] >= 4,
              f"cli train voc: launches {trained}")
        check(all(v == 0 for k, v in trained.items() if k in TRAIN_STEP["paired"]),
              f"cli train voc: bf16 kernels launched {trained}")
        last = load_any(str(save / "last_epoch_weights.pth"))
        check(last["epoch"] == 2 and last["step"] == 4,
              f"voc: last checkpoint epoch {last['epoch']} step {last['step']}")
        cfg = get_preset("voc", resume=True, model_path=str(save / "last_epoch_weights.pth"),
                         unfreeze_epoch=3, freeze_epoch=1, pretrained_backbone=False,
                         eval_flag=False, save_dir=str(tmp / "resumed"))
        buf2 = io.StringIO()
        reset_launch_counts()
        with contextlib.redirect_stdout(buf2):
            state = fit(cfg, train_ids, val_ids, base_dir=str(tmp))
        torch.cuda.synchronize()
        add()
        again = load_any(str(tmp / "resumed" / "last_epoch_weights.pth"))
        check("Resuming full training state at epoch 2" in buf2.getvalue()
              and again["epoch"] == 3 and state.step == 6,
              f"voc resume: epoch {again['epoch']}, steps {state.step}")
        reset_launch_counts()
        u = Unet(model="unet_vgg", num_classes=21, input_shape=[SIZE, SIZE],
                 model_path=str(save / "last_epoch_weights.pth"))
        fn, net = u.serving_step()
        val = rect_batch(torch.Generator().manual_seed(23), 2, SIZE, 21, "cuda")
        masks, hist = fn(net, val["image"])
        torch.cuda.synchronize()
        add()
        check(masks.shape == (2, SIZE, SIZE) and int(hist.sum()) == 2 * SIZE ** 2,
              f"voc serving from the trained weights: masks {tuple(masks.shape)}")
        medical_ids = write_medical(tmp, 4, SIZE, seed=24)
        buf3 = io.StringIO()
        reset_launch_counts()
        with contextlib.redirect_stdout(buf3), first_epoch_frozen():
            cli.main(["train", "--preset", "medical", "--no-pretrained", "--data-root",
                      str(tmp), "--epochs", "1", "--save-dir", str(tmp / "medical")])
        torch.cuda.synchronize()
        add()
        med = dict(launch_counts)
        mlast = load_any(str(tmp / "medical" / "last_epoch_weights.pth"))
        check(mlast["epoch"] == 1 and mlast["step"] == 2 and med["final_ce_dice_fwd_f32"] == 2,
              f"cli train medical: epoch {mlast['epoch']} step {mlast['step']}, launches {med}")
        print(json.dumps({
            "cli_train_f32": ["voc", "medical"], "images": [len(train_ids), len(medical_ids)],
            "seconds_wall_incl_warmup": secs,
            "epoch_lines": [ln for ln in (buf.getvalue() + buf3.getvalue()).splitlines()
                            if ln.startswith("Epoch")],
            "resumed_epoch_lines": [ln for ln in buf2.getvalue().splitlines()
                                    if ln.startswith("Epoch")],
            "launches": totals, "gpu": card}), flush=True)
    return totals


def phase_f32(card: str, results: dict):
    """Phase 7, the float32 path: its kernels (encoder, decoder at both
    models' widths, the up_conv head at both heads, loss), the single-tile
    witnesses, the unet_vgg, unet_resnet50, self_net and DataB steps,
    ``cli train`` of the voc and medical presets.  Returns the launches of
    the counted runs."""
    t0 = time.perf_counter()
    record = functools.partial(record_case, results, card)
    gen = torch.Generator(device="cuda").manual_seed(20)
    f32_single_tile_readings(gen)
    f32_encoder_kernels(record, gen)
    f32_decoder_kernels(record, gen)
    f32_wgrad_gemm(card, gen)
    f32_head_kernels(record, gen)
    f32_loss_kernels(record, gen)
    t_steps = time.perf_counter()
    print(f"phase 7: kernels in {t_steps - t0:.1f} s", flush=True)
    totals = f32_train_step(card)
    counts = [f32_model_step("unet_resnet50", card, seed=16), f32_model_step("self_net", card, 19)]
    counts += [f32_datab_step(name, card) for name in DATAB_CW]
    t_zoo = time.perf_counter()
    counts.append(f32_zoo_step(card))
    t_cli = time.perf_counter()
    counts.append(cli_train_f32(card))
    print(f"phase 7: steps in {t_zoo - t_steps:.1f} s, balancedseg_fpn_sup in "
          f"{t_cli - t_zoo:.1f} s, cli train in {time.perf_counter() - t_cli:.1f} s", flush=True)
    for c in counts:
        for k, v in c.items():
            totals[k] = totals.get(k, 0) + v
    print(f"phase 7: float32 path in {time.perf_counter() - t0:.1f} s", flush=True)
    return totals


SOURCES = {
    # conv1_1's image GEMM (csrc/stem.cu, its gather csrc/image_gather.cuh)
    # and conv1_2 with the pool on the Hopper conv core
    "vgg_stem": ("tpu_unet_torch/csrc/stem.cu", "tpu_unet/kernels/stem.py:220"),
    # blocks 2-5 on the Hopper core (wgmma, TMA), from csrc/encoder.cu
    "vgg_block": ("tpu_unet_torch/csrc/conv3x3_sm90.cuh", "tpu_unet/kernels/encoder.py:288"),
    "unetup": ("tpu_unet_torch/csrc/decoder_fuse.cu",
               "tpu_unet/kernels/decoder_fuse.py:1149"),
    # #1's up2x(x), written once for the Hopper conv core's TMA boxes (the
    # TPU kernel lerps it inside the conv)
    "upsample2x": ("tpu_unet_torch/csrc/decoder_fuse.cu",
                   "tpu_unet/kernels/decoder_fuse.py:1149"),
    # the serving tails at every width: csrc/tail_sm90.cu, through the C
    # entries of csrc/postprocess.cu
    "final_argmax_hist": ("tpu_unet_torch/csrc/tail_sm90.cu",
                          "tpu_unet/kernels/postprocess.py:244"),
    # the head's two convs on the Hopper core, from csrc/upconv.cu (its
    # up2x(x) counted under upsample2x)
    "upconv": ("tpu_unet_torch/csrc/conv3x3_sm90.cuh", "tpu_unet/kernels/upconv.py:227"),
    # the mask pass, the two Hopper dgrads, the dk2 and dk1 GEMMs on the
    # Hopper weight-gradient core and the adjoint, from csrc/upconv.cu
    "upconv_bwd": ("tpu_unet_torch/csrc/wgrad_sm90.cuh", "tpu_unet/kernels/upconv.py:475"),
    "final_argmax_hist_natural": ("tpu_unet_torch/csrc/tail_sm90.cu",
                                  "tpu_unet/kernels/postprocess.py:154"),
    "final_argmax": ("tpu_unet_torch/csrc/tail_sm90.cu",
                     "tpu_unet/kernels/postprocess.py:92"),
    "normalize_images": ("tpu_unet_torch/csrc/preprocess.cu",
                         "tpu_unet/kernels/preprocess.py:39"),
    "argmax_mask": ("tpu_unet_torch/csrc/argmax.cu", "tpu_unet/kernels/postprocess.py:56"),
    "mask_palette": ("tpu_unet_torch/csrc/palette.cu", "tpu_unet/kernels/postprocess.py:300"),
    # the mask pass and the two Hopper dgrads, from csrc/decoder_train.cu
    "unetup_bwd": ("tpu_unet_torch/csrc/conv3x3_sm90.cuh",
                   "tpu_unet/kernels/decoder_train.py:140"),
    # the in-kernel weight gradients of #14 (:506) and #16 (:1459)
    "unetup_wgrad": ("tpu_unet_torch/csrc/unetup_wgrad.cu",
                     "tpu_unet/kernels/decoder_train.py:1459"),
    # #19, the dx epilogue of #14 / #16
    "upsample_adjoint": ("tpu_unet_torch/csrc/upsample_adjoint.cu",
                         "tpu_unet/kernels/decoder_train.py:1208"),
    # the training encoder: block forwards keeping their intermediates (the
    # block kernel of encoder.cu under its training keys, on the Hopper
    # core) and the backwards
    "vgg_block2_fwd": ("tpu_unet_torch/csrc/conv3x3_sm90.cuh",
                       "tpu_unet/kernels/encoder_train.py:139"),
    "vgg_block3_fwd": ("tpu_unet_torch/csrc/conv3x3_sm90.cuh",
                       "tpu_unet/kernels/encoder3_train.py:279"),
    # the stem's conv1_2 and blocks 2-5: the Hopper weight-gradient GEMM
    # and dgrads, from csrc/encoder_train.cu (the stem's conv1_1 GEMM over
    # the image is that file's own)
    "vgg_stem_bwd": ("tpu_unet_torch/csrc/wgrad_sm90.cuh",
                     "tpu_unet/kernels/stem_train.py:245"),
    "vgg_block2_bwd": ("tpu_unet_torch/csrc/wgrad_sm90.cuh",
                       "tpu_unet/kernels/encoder_train.py:329"),
    "vgg_block3_bwd": ("tpu_unet_torch/csrc/wgrad_sm90.cuh",
                       "tpu_unet/kernels/encoder3_train.py:349"),
    # #27 / #29: one persistent kernel a pass, wgmma behind a TMA ring
    # (csrc/loss.cu on csrc/sm90.cuh), the scalar epilogue on the device
    "final_ce_dice_fwd": ("tpu_unet_torch/csrc/loss.cu", "tpu_unet/kernels/loss.py:704"),
    "final_ce_dice_bwd": ("tpu_unet_torch/csrc/loss.cu", "tpu_unet/kernels/loss.py:804"),
    "ce_dice_fwd": ("tpu_unet_torch/csrc/loss_logits.cu", "tpu_unet/kernels/loss.py:173"),
    "ce_dice_bwd": ("tpu_unet_torch/csrc/loss_logits.cu", "tpu_unet/kernels/loss.py:313"),
    # the float32 path (phase 7): the same sources' float32 instantiations,
    # TF32 products (the weight-gradient GEMM's on TF32 wgmma, G restaged
    # K-major, in csrc/wgrad_sm90.cuh; the image GEMMs' in stem.cu /
    # encoder_train.cu)
    "vgg_stem_f32": ("tpu_unet_torch/csrc/stem.cu", "tpu_unet/kernels/stem.py:220"),
    "vgg_block_f32": ("tpu_unet_torch/csrc/conv3x3_sm90.cuh", "tpu_unet/kernels/encoder.py:288"),
    # #1's two convs on the halo mainloop at F <= 256 (conv1 over [skip |
    # up], both models' up1-up3), on the conv core at up4
    "unetup_f32": ("tpu_unet_torch/csrc/conv3x3_halo_sm90.cuh",
                   "tpu_unet/kernels/decoder_fuse.py:1149"),
    "upsample2x_f32": ("tpu_unet_torch/csrc/upsample2x.cuh",
                       "tpu_unet/kernels/decoder_fuse.py:1149"),
    "unetup_bwd_f32": ("tpu_unet_torch/csrc/conv3x3_sm90.cuh",
                       "tpu_unet/kernels/decoder_train.py:140"),
    "unetup_wgrad_f32": ("tpu_unet_torch/csrc/wgrad_sm90.cuh",
                         "tpu_unet/kernels/decoder_train.py:1459"),
    "upsample_adjoint_f32": ("tpu_unet_torch/csrc/upsample_adjoint.cuh",
                             "tpu_unet/kernels/decoder_train.py:1208"),
    "vgg_block2_fwd_f32": ("tpu_unet_torch/csrc/conv3x3_sm90.cuh",
                           "tpu_unet/kernels/encoder_train.py:139"),
    "vgg_block3_fwd_f32": ("tpu_unet_torch/csrc/conv3x3_sm90.cuh",
                           "tpu_unet/kernels/encoder3_train.py:279"),
    # csrc/encoder_train.cu's float32 chain: conv1_2's masked dgrad on the
    # halo mainloop, its weight gradient on the float32 GEMM, conv1_1's on
    # the image GEMM
    "vgg_stem_bwd_f32": ("tpu_unet_torch/csrc/conv3x3_halo_sm90.cuh",
                         "tpu_unet/kernels/stem_train.py:245"),
    "vgg_block2_bwd_f32": ("tpu_unet_torch/csrc/wgrad_sm90.cuh",
                           "tpu_unet/kernels/encoder_train.py:329"),
    "vgg_block3_bwd_f32": ("tpu_unet_torch/csrc/wgrad_sm90.cuh",
                           "tpu_unet/kernels/encoder3_train.py:349"),
    "final_ce_dice_fwd_f32": ("tpu_unet_torch/csrc/loss.cu", "tpu_unet/kernels/loss.py:704"),
    "final_ce_dice_bwd_f32": ("tpu_unet_torch/csrc/loss.cu", "tpu_unet/kernels/loss.py:804"),
    # the up_conv head in float32: csrc/upconv.cu's float32 instantiations
    # (#10 / #11 forward, #12 backward), the four convs on the halo mainloop
    # (csrc/conv3x3_halo_sm90.cuh)
    "upconv_f32": ("tpu_unet_torch/csrc/conv3x3_halo_sm90.cuh",
                   "tpu_unet/kernels/upconv.py:227"),
    "upconv_bwd_f32": ("tpu_unet_torch/csrc/upconv.cu", "tpu_unet/kernels/upconv.py:475"),
    # the conv core's weight operand, packed on the card in one pass (bf16
    # and TF32-rounded float32) by every wrapper that runs the core; the TPU
    # kernels take theirs from XLA, which flips and transposes them for the
    # dgrads (_flip_t, ahead of the pallas_call at decoder_train.py:140)
    "pack_weights": ("tpu_unet_torch/csrc/pack_weights.cu", "tpu_unet/kernels/decoder_train.py:55"),
    "pack_weights_f32": ("tpu_unet_torch/csrc/pack_weights.cu",
                         "tpu_unet/kernels/decoder_train.py:55"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "tpu_unet_torch" / "csrc").is_dir():
        print("chip_smoke: tpu_unet_torch/ not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    card = phase_device()
    phase_build()
    t2 = time.perf_counter()
    results = phase_kernels(card)
    phase_train_kernels(card, results)
    from tpu_unet_torch.tools.bench_launch import EMPTY_WINDOWS
    print(f"phase 2: kernels in {time.perf_counter() - t2:.1f} s; "
          f"{EMPTY_WINDOWS['windows']} empty profiler windows retaken", flush=True)
    counts = phase_serving(card)
    for phase in (phase_single_image, phase_tools, phase_export_tools, phase_train):
        for k, v in phase(card).items():
            counts[k] = counts.get(k, 0) + v
    for k, v in phase_f32(card, results).items():
        counts[k] = counts.get(k, 0) + v
    kernels = []
    for name, (src, repl) in SOURCES.items():
        r = results[name]
        b_ms, b_by = bound(r["flops"], r["bytes"], r["peak"])
        check(counts.get(name, 0) > 0, f"{name}: no launch on its path")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": counts.get(name, 0),
                        "max_abs_err": r["max_abs_err"], "rel_err": r["rel_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": r["library_ms"]})
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    if failures:
        print("chip_smoke failed:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
