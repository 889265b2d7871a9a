"""Build, load and call the port's CUDA kernels.

``csrc/*.cu`` are compiled with ``nvcc`` for ``sm_90a`` — one ``nvcc`` per
source, all started together — and linked into one shared library with a
plain C interface under ``build/`` at the repository root, on first use
(never at import).  The library is loaded with ``ctypes`` and each C
entry is resolved once, when it loads.  Every C entry launches on the
stream it is given and returns ``cudaGetLastError()``; :func:`call` raises
when that is not 0.

The build is keyed by a hash of the sources, so an edited kernel is rebuilt
and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from tpu_unet_torch.kernels._plain import flip_t, on_cpu

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG.parent / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
         "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry: pointers and the stream are c_void_p
SIGNATURES = {
    # feats, w (F,C) f32, b f32, mask, hist, n_pix, per_img, F, C, stream
    "tu_final_argmax_hist": [_P] * 5 + [_I] * 4 + [_P],
    # feats, w (F,C) f32, b f32, mask, n_pix, F, C, stream
    "tu_final_argmax": [_P] * 4 + [_I] * 3 + [_P],
    # u8 in, out, n (int64), out is bf16, stream
    "tu_normalize_images": [_P, _P, ctypes.c_longlong, _I, _P],
    # img, is_u8, w11, b11, w12, b12, a1, skip, pooled, B, H, W, F, f32,
    # plan (int64 launch records), stream
    "tu_vgg_stem": [_P, _I] + [_P] * 7 + [_I] * 5 + [_P, _P],
    # x, n_convs, ws[3], bs[3], mids[2], skip, pooled, B, H, W, chans[4],
    # f32, plan (int64 launch records, three convs), stream
    "tu_vgg_block": [_P, _I] + [_P] * 10 + [_I] * 8 + [_P, _P],
    # x, ridx, rw, cidx, cw, up, B, H2, W2, Cx, f32, stream
    "tu_upsample2x": [_P] * 6 + [_I] * 5 + [_P],
    # skip, up, w1, b1, w2, b2, y1, out, B, H2, W2, Cs, Cx, F, f32,
    # plan (int64 launch records), stream
    "tu_unetup": [_P] * 8 + [_I] * 7 + [_P, _P],
    # up, w1, b1, w2, b2, y1, out, B, H2, W2, Cx, F, f32,
    # plan (int64 launch records), stream
    "tu_upconv": [_P] * 7 + [_I] * 6 + [_P, _P],
    # g, out, y1, up, aridx, arw, anr, acidx, acw, anc, w2t, w1t, g2, dz1,
    # dups, work, dk1, db1, dk2, db2, dx, B, H2, W2, Cx, F, f32,
    # plan (int64 launch records), stream
    "tu_upconv_bwd": [_P] * 6 + [_I] + [_P] * 2 + [_I] + [_P] * 11 + [_I] * 6 + [_P, _P],
    # logits, out, n_pix (int64), C, logits are bf16, out is uint8, stream
    "tu_argmax_mask": [_P, _P, ctypes.c_longlong, _I, _I, _I, _P],
    # mask, mask is int32, img, palette, C, alpha, 1 - alpha, out,
    # n_pix (int64), stream
    "tu_mask_palette": [_P, _I, _P, _P, _I, ctypes.c_float, ctypes.c_float,
                        _P, ctypes.c_longlong, _P],
    # feats, is_bf16, target, wt, bias, cls_weights, partial, ticket, loss,
    # fscore, res, n_pix (int64), C, with_dice, np, stages, smem, grid,
    # stream
    "tu_final_ce_dice_fwd": [_P, _I] + [_P] * 9 + [ctypes.c_longlong] + [_I] * 6 + [_P],
    # feats, is_bf16, target, wt, bias, cls_weights, gl, s_w, denom, score,
    # partial, ticket, dfeat, dw, db, coefs, n_pix (int64), C, with_dice,
    # grad_bf16, np, stages, smem, grid, stream
    "tu_final_ce_dice_bwd": [_P, _I] + [_P] * 14 + [ctypes.c_longlong] + [_I] * 7 + [_P],
    # g, out, y1, w2t, w1t, g2, dz1, dskip, dups, B, H2, W2, Cs, Cx, F, f32,
    # plan (int64 launch records), stream
    "tu_unetup_bwd": [_P] * 9 + [_I] * 7 + [_P, _P],
    # skip, up, dz1, y1, g2, work, dk1, db1, dk2, db2, B, H2, W2, Cs, Cx, F,
    # f32, plan (int64 launch records), stream
    "tu_unetup_wgrad": [_P] * 10 + [_I] * 7 + [_P, _P],
    # gout, in, work, dk, db, B, H, W, C, F, f32, record (int64), stream
    "tu_wgrad": [_P] * 5 + [_I] * 6 + [_P, _P],
    # x, is_image, mid0, mid1, out, dskip, dpool, wt0..2, ga, gb, dx, work,
    # dk0..2, db0..2, n, B, H, W, chans[4], f32, plan (int64 launch
    # records), stream
    "tu_vgg_block_bwd": [_P, _I] + [_P] * 18 + [_I] * 9 + [_P, _P],
    # dup, ridx, rw, nr, cidx, cw, nc, dx, B, H, W, C, f32, stream
    "tu_upsample_adjoint": [_P] * 3 + [_I] + [_P] * 2 + [_I] + [_P] + [_I] * 5 + [_P],
    # B, H, W, C, f32, out (10 int64): the adjoint's launch plan (no stream)
    "tu_upsample_adjoint_plan": [_I] * 5 + [_P],
    # logits, is_bf16, target, cls_weights, partial, ticket, loss, fscore,
    # res, n_pix (int64), C, with_dice, focal, alpha, gamma, tile, stages,
    # smem, grid, stream
    "tu_ce_dice_fwd": [_P, _I] + [_P] * 7 + [ctypes.c_longlong] + [_I] * 3 + [_F, _F]
                      + [_I] * 4 + [_P],
    # logits, is_bf16, target, cls_weights, gl, s_w, denom, score, dlogits,
    # coefs, n_pix (int64), C, with_dice, focal, alpha, gamma, tile, stages,
    # smem, grid, stream
    "tu_ce_dice_bwd": [_P, _I] + [_P] * 8 + [ctypes.c_longlong] + [_I] * 3 + [_F, _F]
                      + [_I] * 4 + [_P],
    # desc (n x 5 int64: w, out, F, C, kp), n, f32, flip, stream
    "tu_pack_weights": [_P] + [_I] * 3 + [_P],
}

# launches of each kernel wrapper; a wrapper adds one where it calls its
# C entry and nowhere else.  A kernel with a float32 instantiation counts
# its float32 launches under its key + "_f32" (:func:`count_key`).
F32_KERNELS = ("vgg_stem", "vgg_block", "unetup", "upsample2x", "unetup_bwd", "unetup_wgrad",
               "wgrad_gemm", "pack_weights",
               "upsample_adjoint", "vgg_block2_fwd", "vgg_block3_fwd", "vgg_stem_bwd",
               "vgg_block2_bwd", "vgg_block3_bwd", "final_ce_dice_fwd", "final_ce_dice_bwd",
               "upconv", "upconv_bwd")
launch_counts = {"final_argmax_hist": 0, "final_argmax": 0,
                 "normalize_images": 0, "vgg_stem": 0, "vgg_block": 0,
                 "unetup": 0, "upsample2x": 0, "upconv": 0, "upconv_bwd": 0,
                 "argmax_mask": 0, "mask_palette": 0, "unetup_bwd": 0, "unetup_wgrad": 0,
                 "wgrad_gemm": 0,
                 "upsample_adjoint": 0, "vgg_block2_fwd": 0,
                 "vgg_block3_fwd": 0, "vgg_stem_bwd": 0, "vgg_block2_bwd": 0,
                 "vgg_block3_bwd": 0, "final_ce_dice_fwd": 0,
                 "final_ce_dice_bwd": 0, "ce_dice_fwd": 0, "ce_dice_bwd": 0,
                 "pack_weights": 0,
                 **{k + "_f32": 0 for k in F32_KERNELS}}

_lock = threading.Lock()
_lib = None
# C entry name -> its ctypes function (argtypes set), filled once by lib()
_entries: dict = {}
build_log = ""  # nvcc/ptxas output of the last build (registers, spills)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def count_key(key: str, dtype: torch.dtype) -> str:
    """The launch key of kernel ``key``'s instantiation for ``dtype``."""
    return key + "_f32" if dtype == torch.float32 else key


def conv_dtype(t: torch.Tensor, name: str) -> torch.dtype:
    """The element type of a conv kernel's call: ``t``'s, which must be
    bf16 or float32 (the two instantiations); no other is cast or taken."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: dtype {t.dtype}, the kernels take bf16 or float32")
    return t.dtype


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``build/libtpu_unet_torch_<hash>.so``
    (skipped when that file exists) and return its path."""
    global build_log
    BUILD.mkdir(parents=True, exist_ok=True)
    out = BUILD / f"libtpu_unet_torch_{_digest()}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *ARCH, *FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors, logs = [], []
        for src, p in procs:
            log = p.communicate()[0].decode(errors="replace")
            logs.append(f"{src.name}:\n{log}")
            if p.returncode:
                errors.append(logs[-1])
        build_log = "\n".join(logs)
        if errors:
            raise RuntimeError("nvcc failed\n" + "\n".join(errors))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_so), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode:
            raise RuntimeError("nvcc link failed\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(tmp_so, out)
    return out


def lib():
    """The loaded kernel library (built on first call).  Every entry of
    SIGNATURES is resolved into ``_entries`` before the library is
    published, so once it is loaded no lock is taken."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _entries[name] = fn
            _lib = handle
    return _lib


def call(name: str, *args) -> None:
    """Call C entry ``name`` on the current stream; raise on a launch error.

    The cost a call adds to the launch is the fewest Python operations: the
    entry resolved at load (no lock, no lookup by name on the library) and
    the raw handle of the stream that is current on the current device,
    read at every call (never a stream cached across calls) without
    building a ``torch.cuda.Stream``."""
    fn = _entries.get(name)
    if fn is None:
        lib()
        fn = _entries[name]
    err = fn(*args, torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice()))
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def query(name: str, *args) -> None:
    """Call host-only C entry ``name`` (no stream, nothing launched); raise
    when it returns an error."""
    lib()
    err = _entries[name](*args)
    if err:
        raise RuntimeError(f"{name}: error {err}")


def traced(x: torch.Tensor) -> bool:
    """True while ``torch.export`` or ``torch.compile`` traces a wrapper
    (its input a fake or functional tensor, or the compiler's flag set):
    the wrapper then calls its kernel's operator, which the graph keeps.
    An eager call launches the kernel directly, without the operator's
    dispatch."""
    return type(x) is not torch.Tensor or torch.compiler.is_compiling()


def no_grad_inputs(name: str, *tensors) -> None:
    """Raise when autograd would record a call to kernel ``name``: its CUDA
    output has no ``grad_fn``, so every parameter upstream would silently
    get no gradient.  Lists of tensors are looked into."""
    if not torch.is_grad_enabled():
        return
    flat = []
    for t in tensors:
        flat += list(t) if isinstance(t, (list, tuple)) else [t]
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in flat):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; call it "
                           "under torch.no_grad() (serving), or train through "
                           "the model's train=True path")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
          device: torch.device | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape`` where given, ``None`` entries free)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None:
        if t.ndim != len(shape) or any(
                s is not None and s != d for s, d in zip(shape, t.shape)):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 (10 mantissa bits; to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``), stored as float32."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def pack_conv3x3(w: torch.Tensor, k_pad: int | None = None,
                 dtype: torch.dtype = torch.bfloat16, flip: bool = False) -> torch.Tensor:
    """OIHW (F, C, 3, 3) conv weight → (F, K) bf16 (or float32, its values
    rounded to TF32 by :func:`round_tf32`) with K index ``(ky * 3 + kx) * C
    + c``, zero-padded to ``k_pad`` columns, K contiguous: the weight
    operand of the Hopper conv core, which reads it as (F, 9, C) through
    TMA boxes of one tap's 128 bytes of channels (``csrc/conv3x3_sm90.cuh``;
    ``kernels/sm90.py::weight_map``), and, at C = 3 padded to 128 bytes of
    columns, of the stem's conv1_1 GEMM (``csrc/stem.cu``).  With ``flip``
    the operand of the dgrad, the same of ``_plain.flip_t(w)``: (C, 9F).
    :func:`pack_weights` of the one weight."""
    return pack_weights([w], dtype, flip, [k_pad])[0]


def pack_conv3x3_plain(w: torch.Tensor, k_pad: int | None = None,
                       dtype: torch.dtype = torch.bfloat16, flip: bool = False) -> torch.Tensor:
    """:func:`pack_conv3x3` in eager PyTorch, on any device: the flip copy,
    the permute copy and the rounding."""
    if flip:
        w = flip_t(w)
    f, c = w.shape[0], w.shape[1]
    p = w.permute(0, 2, 3, 1).reshape(f, 9 * c)
    p = round_tf32(p) if dtype == torch.float32 else p.to(dtype)
    if k_pad is not None and k_pad > 9 * c:
        p = torch.nn.functional.pad(p, (0, k_pad - 9 * c))
    return p.contiguous()


PACK_MAX_WEIGHTS = 3  # csrc/pack_weights.cu: the weights of one launch


def pack_weights(ws, dtype: torch.dtype = torch.bfloat16, flip: bool = False,
                 k_pads=None) -> list:
    """:func:`pack_conv3x3` of each weight of ``ws`` (``k_pads`` each one's
    ``k_pad``, default none): for CPU tensors its plain body, one weight at
    a time; for CUDA tensors one launch of the pack kernel
    (``csrc/pack_weights.cu``, launch key ``pack_weights``, float32 outputs
    ``pack_weights_f32``) for all of them — at most three, on one card,
    contiguous, of ``dtype`` — bit-identical to the plain body, or a
    raise."""
    k_pads = list(k_pads) if k_pads is not None else [None] * len(ws)
    if on_cpu(ws[0]):
        if not all(on_cpu(w) for w in ws):
            raise ValueError("pack_weights: the weights lie on two devices")
        return [pack_conv3x3_plain(w, kp, dtype, flip) for w, kp in zip(ws, k_pads)]
    if not 1 <= len(ws) <= PACK_MAX_WEIGHTS or len(k_pads) != len(ws):
        raise ValueError(f"pack_weights: 1-{PACK_MAX_WEIGHTS} weights and as many k_pads")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"pack_weights: dtype {dtype}, the kernel writes bf16 or float32")
    outs, words = [], []
    for i, (w, kp) in enumerate(zip(ws, k_pads)):
        check(w, f"ws[{i}]", dtype, (None, None, 3, 3), ws[0].device)
        f, c = int(w.shape[0]), int(w.shape[1])
        rows, taps = (c, 9 * f) if flip else (f, 9 * c)
        cols = max(taps, kp or 0)
        outs.append(torch.empty((rows, cols), dtype=dtype, device=w.device))
        words += [w.data_ptr(), outs[-1].data_ptr(), f, c, cols]  # a weight's descriptor
    desc = (ctypes.c_int64 * len(words))(*words)
    call("tu_pack_weights", desc, len(ws), int(dtype == torch.float32), int(flip))
    launch_counts[count_key("pack_weights", dtype)] += 1
    return outs


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()
