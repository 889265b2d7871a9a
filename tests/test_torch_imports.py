"""The port stands alone: no module of tpu_unet_torch/ (nor chip_smoke.py)
imports JAX, flax or the JAX package; its kernel wrappers never fall back
to the plain version for a tensor that is not on the CPU."""
import ast
from pathlib import Path

import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_unet")


def _bad_imports(source: str, name: str = "<src>"):
    """Imported module names whose first component is forbidden."""
    mods = []
    for node in ast.walk(ast.parse(source, name)):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            mods.append(node.module)
    return [m for m in mods if m.split(".")[0] in FORBIDDEN]


def _files():
    return sorted((ROOT / "tpu_unet_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_jax_or_tpu_unet_imports():
    files = _files()
    assert len(files) > 10
    bad = [(f.relative_to(ROOT), m) for f in files
           for m in _bad_imports(f.read_text(), str(f))]
    assert not bad, bad


def test_scan_compares_whole_names():
    """``tpu_unet_torch`` shares a prefix with ``tpu_unet``: the scan must
    flag the JAX package and JAX itself, not the port."""
    src = ("import tpu_unet_torch.kernels\nfrom tpu_unet_torch import nn\n"
           "import jax.numpy as jnp\nfrom tpu_unet.kernels import stem\n"
           "def f():\n    import flax.linen\n")
    assert _bad_imports(src) == ["jax.numpy", "tpu_unet.kernels", "flax.linen"]


def _cuda_entries():
    from tpu_unet_torch.kernels import (decoder_fuse, decoder_train, encoder, encoder_train,
                                        loss, postprocess, preprocess, render, stem, upconv)

    x3 = torch.zeros(1, 16, 16, 3, dtype=torch.uint8)
    w = torch.zeros(64, 3, 3, 3, dtype=torch.bfloat16)
    w64 = torch.zeros(64, 64, 3, 3, dtype=torch.bfloat16)
    b = torch.zeros(64, dtype=torch.bfloat16)
    f = torch.zeros(1, 16, 16, 64, dtype=torch.bfloat16)
    p = torch.zeros(1, 8, 8, 64, dtype=torch.bfloat16)
    return {
        "stem": lambda: stem._vgg_stem_cuda(x3, w, b, w64, b),
        "block": lambda: encoder._vgg_block_cuda(f, [w64, w64], [b, b], True),
        "unetup": lambda: decoder_fuse._unetup_cuda(
            torch.zeros(1, 32, 32, 64, dtype=torch.bfloat16), f,
            torch.zeros(64, 128, 3, 3, dtype=torch.bfloat16), b, w64, b),
        "tail": lambda: postprocess._final_argmax_hist_cuda(
            f, torch.zeros(21, 64, 1, 1), torch.zeros(21), 21),
        "upconv": lambda: upconv._upconv_cuda(f, w64, b, w64, b),
        "tail_natural": lambda: postprocess._final_argmax_hist_cuda(
            torch.zeros(2, 32, 32, 22, dtype=torch.bfloat16), torch.zeros(4, 22, 1, 1),
            torch.zeros(4), 4),
        "tail_mask_only": lambda: postprocess._final_argmax_cuda(
            torch.zeros(1, 25, 25, 32, dtype=torch.bfloat16), torch.zeros(4, 32, 1, 1),
            torch.zeros(4), 4),
        "normalize": lambda: preprocess._normalize_images_cuda(x3, torch.bfloat16),
        "argmax_mask": lambda: postprocess._argmax_mask_cuda(
            torch.zeros(1, 16, 16, 4, dtype=torch.bfloat16), torch.uint8),
        "mask_palette": lambda: render._mask_palette_cuda(
            torch.zeros(1, 16, 16, dtype=torch.uint8), x3,
            torch.zeros(4, 3, dtype=torch.uint8), 0.7),
        "unetup_bwd": lambda: decoder_train._unetup_bwd_cuda(
            f, f, f, torch.zeros(64, 192, 3, 3, dtype=torch.bfloat16), w64, 64),
        "unetup_wgrad": lambda: decoder_train._unetup_wgrad_cuda(
            torch.zeros(1, 16, 16, 64, dtype=torch.bfloat16),
            torch.zeros(1, 8, 8, 128, dtype=torch.bfloat16), f, f, f),
        "upsample_adjoint": lambda: decoder_train._upsample_adjoint_cuda(
            torch.zeros(1, 16, 16, 128, dtype=torch.bfloat16), 8, 8),
        "upsample2x": lambda: decoder_train._up2x_cuda(
            torch.zeros(1, 8, 8, 128, dtype=torch.bfloat16)),
        "block3_fwd": lambda: encoder._vgg_block_cuda(f, [w64] * 3, [b] * 3, True,
                                                      "vgg_block3_fwd"),
        "stem_bwd": lambda: encoder_train._bwd_cuda(
            "vgg_stem_bwd", f, p, x3, [f], f, [w, w64], False, True),
        "block_bwd": lambda: encoder_train._bwd_cuda(
            "vgg_block2_bwd", f, p, f, [f], f, [w64, w64], True, False),
        "final_ce_dice_fwd": lambda: loss._fwd_cuda(
            f, torch.zeros(21, 64, 1, 1), torch.zeros(21),
            torch.zeros(1, 16, 16, dtype=torch.long), [1.0] * 21, 21, True),
        "final_ce_dice_bwd": lambda: loss._bwd_cuda(
            f, torch.zeros(21, 64, 1, 1), torch.zeros(21),
            torch.zeros(1, 16, 16, dtype=torch.long), [1.0] * 21, 21, True,
            (torch.ones(()), torch.ones(21), torch.ones(21)), torch.ones(())),
        "ce_dice_fwd": lambda: loss._ce_fwd_cuda(
            torch.zeros(1, 16, 16, 4, dtype=torch.bfloat16),
            torch.zeros(1, 16, 16, dtype=torch.long), [1.0] * 4, 4, True, True, 0.5, 2.0),
        "ce_dice_bwd": lambda: loss._ce_bwd_cuda(
            torch.zeros(1, 16, 16, 4, dtype=torch.bfloat16),
            torch.zeros(1, 16, 16, dtype=torch.long), [1.0] * 4, 4, True, True, 0.5, 2.0,
            (torch.ones(()), torch.ones(4), torch.ones(4)), torch.ones(())),
    }


@pytest.mark.parametrize("name", ["stem", "block", "unetup", "tail", "upconv",
                                  "tail_natural", "tail_mask_only", "normalize",
                                  "argmax_mask", "mask_palette", "unetup_bwd",
                                  "unetup_wgrad", "upsample_adjoint", "upsample2x", "block3_fwd",
                                  "stem_bwd", "block_bwd",
                                  "final_ce_dice_fwd", "final_ce_dice_bwd", "ce_dice_fwd",
                                  "ce_dice_bwd"])
def test_kernel_path_refuses_cpu_tensors(name):
    """The kernel side of each wrapper checks its inputs and raises; it
    never computes a CPU tensor (and never builds) on its own."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda_entries()[name]()


def _grad_calls():
    """Each wrapper whose kernel has no backward, called with a float
    argument that requires grad (integer-only kernels — #8, #9 — cannot
    receive one)."""
    from tpu_unet_torch.kernels import (decoder_fuse, decoder_train, encoder, encoder_train,
                                        loss, postprocess, stem, upconv)

    def g(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, requires_grad=True)

    w64, b = g(64, 64, 3, 3), g(64)
    f = g(1, 16, 16, 64)
    t = torch.zeros(1, 16, 16, dtype=torch.long)
    res = (torch.ones(()), torch.ones(21), torch.ones(21))
    return {
        "vgg_stem": (stem, lambda: stem.vgg_stem(g(1, 16, 16, 3), g(64, 3, 3, 3), b, w64, b)),
        "vgg_block": (encoder, lambda: encoder.vgg_block(f, [w64, w64], [b, b])),
        "unetup": (decoder_fuse, lambda: decoder_fuse.unetup(
            g(1, 32, 32, 64), f, g(64, 128, 3, 3), b, w64, b)),
        "upconv": (upconv, lambda: upconv.upconv(f, w64, b, w64, b)),
        "final_argmax_hist": (postprocess, lambda: postprocess.final_argmax_hist(
            f, g(21, 64, 1, 1), g(21), 21)),
        "final_argmax": (postprocess, lambda: postprocess.final_argmax(
            f, g(21, 64, 1, 1), g(21), 21)),
        "argmax_mask": (postprocess, lambda: postprocess.argmax_mask(g(1, 4, 4, 4))),
        "unetup_bwd": (decoder_train, lambda: decoder_train.unetup_bwd(
            f, f, f, g(64, 192, 3, 3), w64, 64)),
        "unetup_wgrad": (decoder_train, lambda: decoder_train.unetup_wgrad(
            g(1, 16, 16, 64), g(1, 8, 8, 128), f, f, f)),
        "upsample_adjoint": (decoder_train, lambda: decoder_train.upsample2x_adjoint(
            g(1, 16, 16, 128), 8, 8)),
        "upsample2x": (decoder_train, lambda: decoder_train.up2x(g(1, 8, 8, 128))),
        "vgg_stem_bwd": (encoder_train, lambda: encoder_train.vgg_stem_bwd(
            f, g(1, 8, 8, 64), g(1, 16, 16, 3), f, f, g(64, 3, 3, 3), w64)),
        "vgg_block2_bwd": (encoder_train, lambda: encoder_train.vgg_block_bwd(
            f, g(1, 8, 8, 64), f, [f], f, [w64, w64])),
        "vgg_block3_bwd": (encoder_train, lambda: encoder_train.vgg_block_bwd(
            f, None, f, [f, f], f, [w64] * 3)),
        "final_ce_dice_fwd": (loss, lambda: loss.final_ce_dice_fwd(
            f, g(21, 64, 1, 1), g(21), t, [1.0] * 21, 21)),
        "final_ce_dice_bwd": (loss, lambda: loss.final_ce_dice_bwd(
            f, g(21, 64, 1, 1), g(21), t, [1.0] * 21, 21, True, res, torch.ones(()))),
        "ce_dice_fwd": (loss, lambda: loss.ce_dice_fwd(g(1, 16, 16, 4), t, [1.0] * 4, 4)),
        "ce_dice_bwd": (loss, lambda: loss.ce_dice_bwd(
            g(1, 16, 16, 4), t, [1.0] * 4, 4, True, True, 0.5, 2.0,
            (torch.ones(()), torch.ones(4), torch.ones(4)), torch.ones(()))),
    }


@pytest.mark.parametrize("name", ["vgg_stem", "vgg_block", "unetup", "upconv",
                                  "final_argmax_hist", "final_argmax", "argmax_mask",
                                  "unetup_bwd", "unetup_wgrad", "upsample_adjoint", "upsample2x",
                                  "vgg_stem_bwd", "vgg_block2_bwd", "vgg_block3_bwd",
                                  "final_ce_dice_fwd", "final_ce_dice_bwd",
                                  "ce_dice_fwd", "ce_dice_bwd"])
def test_kernel_path_refuses_grad_inputs(name, monkeypatch):
    """The CUDA branch of a kernel without a backward raises when autograd
    would record it (its output would have no grad_fn, so every parameter
    upstream would silently get no gradient); under no_grad it goes on to
    its checks.  The device check is mocked so the CPU tensors take the
    CUDA branch."""
    module, call = _grad_calls()[name]
    monkeypatch.setattr(module, "on_cpu", lambda t: False)
    with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel has no backward"):
        call()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        call()


def test_wrapper_rejects_other_devices():
    from tpu_unet_torch.kernels.postprocess import (argmax_mask, final_argmax,
                                                    final_argmax_hist)
    from tpu_unet_torch.kernels.preprocess import normalize_images
    from tpu_unet_torch.kernels.render import mask_palette

    feats = torch.zeros(1, 16, 16, 64, device="meta")
    for tail in (final_argmax_hist, final_argmax):
        with pytest.raises(ValueError, match="unsupported device"):
            tail(feats, torch.zeros(21, 64, 1, 1), torch.zeros(21), 21)
    with pytest.raises(ValueError, match="unsupported device"):
        normalize_images(torch.zeros(1, 4, 4, 3, dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        argmax_mask(torch.zeros(1, 4, 4, 4, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        mask_palette(torch.zeros(1, 4, 4, dtype=torch.uint8, device="meta"),
                     torch.zeros(1, 4, 4, 3, dtype=torch.uint8), torch.zeros(4, 3, dtype=torch.uint8))


def test_native_loader_builds_into_build_dir():
    """The loader binding builds from ``native/loader.cc`` into ``build/``."""
    from tpu_unet_torch.data import native

    assert native.BUILD == ROOT / "build" and native.SOURCE == ROOT / "native" / "loader.cc"


def test_pil_is_imported_inside_functions():
    """The port imports PIL only where an image is handled, so importing
    any of its modules does not need it."""
    files = sorted((ROOT / "tpu_unet_torch").rglob("*.py"))
    top = []
    for f in files:
        for node in ast.parse(f.read_text(), str(f)).body:
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            top += [(f.name, n) for n in names if n.split(".")[0] in ("PIL", "cv2")]
    assert not top, top
