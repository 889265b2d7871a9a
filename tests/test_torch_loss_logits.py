"""The logit-level loss of the port (``kernels/loss.py``: the plain versions
of #25 and #26, and ``ce_dice_loss``) against ``tpu_unet``'s
``ce_dice_loss_grad`` (Pallas in interpret mode on the CPU): loss, f_score
and the dlogits of its custom VJP, CE and focal, dice on and off, the
``traditional`` preset's class weights (1, 15, 0, 0) (zero-weight classes:
the focal factor's 1e-12 clamp) and the ladder presets' (1, 15, 1.5, 2),
ignore pixels and raw 255 labels, 4 and 21 classes.

Float32 runs in this process within 1e-5.  The bf16 references run in a
subprocess with ``XLA_FLAGS=--xla_allow_excess_precision=false``, as in
``test_torch_loss_kernel.py``: XLA on the CPU otherwise keeps bf16 logits
in float32 through the kernel's casts.

Also the paired final-conv kernels #28 / #30 (``_final_fwd_paired``,
``_final_vjp_bwd_paired``): they compute #27 / #29's function on the
column-paired feature map, so the port's ``final_ce_dice_loss`` on the
natural view is held against JAX's paired call, dfeat re-paired."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch

from tpu_unet.kernels.loss import ce_dice_loss_grad, final_ce_dice_loss_grad
from tpu_unet_torch.kernels.loss import (ce_dice_bwd_plain, ce_dice_fwd_plain,
                                         ce_dice_loss, final_ce_dice_loss)
from tpu_unet_torch.train.losses import ce_loss, dice_loss, f_score, focal_loss, one_hot

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = {"trad": (1.0, 15.0, 0.0, 0.0), "ladder": (1.0, 15.0, 1.5, 2.0)}


def _case(seed, n, h, w, c):
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.randn(n, h, w, c)).astype(np.float32)
    target = rng.randint(0, c + 1, (n, h, w)).astype(np.int32)
    target[:, 0, :3] = 255  # raw VOC border labels: the ignore class
    return logits, target


def _weights(key, c):
    return WEIGHTS[key] if c == 4 else tuple((1.0 + 0.1 * np.arange(c)).tolist())


# (weights, focal, dice, classes)
F32_CASES = [(k, f, d, 4) for k in WEIGHTS for f in (True, False) for d in (True, False)] + \
    [("ladder", f, True, 21) for f in (True, False)]
BF16_CASES = [("trad", True, True, 4), ("ladder", True, False, 4), ("ladder", False, True, 4),
              ("ladder", True, True, 21)]


def _key(case):
    return "-".join(map(str, case))


def _shape(c):
    return (2, 8, 16, c)


def _jax(logits, target, cw, c, dice, focal, dt):
    fn = lambda x: ce_dice_loss_grad(x, jnp.asarray(target), cw, c,  # noqa: E731
                                     with_dice=dice, use_focal=focal, interpret=True)
    (l, fs), vjp = jax.vjp(fn, jnp.asarray(logits).astype(dt))
    (g,) = vjp((jnp.ones((), jnp.float32), jnp.zeros((), jnp.float32)))
    return {"loss": np.float32(l), "fs": np.float32(fs), "dlog": np.asarray(g, np.float32)}


_JAX_BF16 = """
import sys
import numpy as np, jax.numpy as jnp
sys.path.insert(0, sys.argv[3])
from test_torch_loss_logits import BF16_CASES, _case, _jax, _key, _shape, _weights
out = {}
for i, case in enumerate(BF16_CASES):
    key, focal, dice, c = case
    logits, target = _case(100 + i, *_shape(c))
    r = _jax(logits, target, _weights(key, c), c, dice, focal, jnp.bfloat16)
    out.update({_key(case) + "/" + k: v for k, v in r.items()})
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def bf16_refs(tmp_path_factory):
    out = tmp_path_factory.mktemp("logit_loss") / "out.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, "-c", _JAX_BF16, "-", str(out), str(ROOT / "tests")],
                   check=True, env=env, cwd=str(ROOT), timeout=600)
    refs = {}
    for k, v in np.load(out).items():
        key, name = k.split("/")
        refs.setdefault(key, {})[name] = v
    return refs


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _port(logits, target, cw, c, dice, focal, dt):
    x, t = torch.from_numpy(logits).to(dt), torch.from_numpy(target)
    loss, fs, res = ce_dice_fwd_plain(x, t, cw, c, dice, focal)
    dlog = ce_dice_bwd_plain(x, t, cw, c, dice, focal, 0.5, 2.0, res, torch.tensor(1.0))
    assert dlog.dtype == dt and dlog.shape == x.shape
    return loss.item(), fs.item(), dlog.float().numpy()


@pytest.mark.parametrize("case", F32_CASES, ids=_key)
def test_plain_matches_pallas_f32(case):
    key, focal, dice, c = case
    logits, target = _case(7, *_shape(c))
    cw = _weights(key, c)
    ref = _jax(logits, target, cw, c, dice, focal, jnp.float32)
    loss, fs, dlog = _port(logits, target, cw, c, dice, focal, torch.float32)
    assert abs(loss - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert abs(fs - ref["fs"]) <= 1e-5
    assert _rel(dlog, ref["dlog"]) <= 1e-5


@pytest.mark.parametrize("case", BF16_CASES, ids=_key)
def test_plain_matches_pallas_bf16(bf16_refs, case):
    """bf16 logits read as they are; dlogits rounded to bf16 from float32
    values that differ only in summation order (one bf16 ulp, 2^-8)."""
    key, focal, dice, c = case
    logits, target = _case(100 + BF16_CASES.index(case), *_shape(c))
    ref = bf16_refs[_key(case)]
    loss, fs, dlog = _port(logits, target, _weights(key, c), c, dice, focal, torch.bfloat16)
    assert abs(loss - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert abs(fs - ref["fs"]) <= 1e-5
    assert _rel(dlog, ref["dlog"]) <= 8e-3


@pytest.mark.parametrize("focal", [True, False])
def test_autograd_function_matches_plain_losses(focal):
    """``ce_dice_loss`` (its backward #26's plain version) against autograd
    of ``focal_loss`` / ``ce_loss`` + ``dice_loss``, with zero-weight classes;
    f_score as ``f_score`` and without a gradient."""
    logits, target = _case(3, 2, 8, 8, 4)
    a = torch.from_numpy(logits).requires_grad_()
    b = torch.from_numpy(logits).requires_grad_()
    tt = torch.from_numpy(target)
    loss, fs = ce_dice_loss(a, tt, WEIGHTS["trad"], 4, True, focal)
    assert not fs.requires_grad
    loss.backward()
    ref = (focal_loss if focal else ce_loss)(b, tt, WEIGHTS["trad"], 4) + \
        dice_loss(b, one_hot(tt, 4))
    ref.backward()
    assert abs(loss.item() - ref.item()) <= 1e-6 * ref.item()
    assert abs(fs.item() - f_score(b.detach(), one_hot(tt, 4)).item()) <= 1e-6
    assert _rel(a.grad, b.grad) <= 1e-5


def test_focal_mean_counts_ignored_pixels():
    """Focal divides by every pixel (``_fwd_impl``, loss.py:254-256): marking
    half the pixels ignored halves nothing but their terms."""
    logits, target = _case(5, 1, 8, 8, 4)
    x = torch.from_numpy(logits)
    t = torch.from_numpy(target)
    full, _, _ = ce_dice_fwd_plain(x, t, WEIGHTS["ladder"], 4, False, True)
    half = t.clone()
    half[:, 4:] = 4
    cut, _, _ = ce_dice_fwd_plain(x, half, WEIGHTS["ladder"], 4, False, True)
    part, _, _ = ce_dice_fwd_plain(x[:, :4], t[:, :4], WEIGHTS["ladder"], 4, False, True)
    assert abs(cut.item() - part.item() / 2) <= 1e-6 * part.item()
    assert cut.item() < full.item()


def test_too_many_classes_raise():
    with pytest.raises(ValueError, match="126"):
        ce_dice_loss(torch.zeros(1, 2, 2, 127), torch.zeros(1, 2, 2, dtype=torch.long),
                     [1.0] * 127, 127)


@pytest.mark.parametrize("with_dice", [True, False])
def test_paired_final_kernels_match_natural(with_dice):
    """#28 / #30: JAX's ``final_ce_dice_loss_grad`` on column-paired
    features (B, H, W/2, 2·64) in interpret mode against the port's
    ``final_ce_dice_loss`` on the natural view (B, H, W, 64) — loss,
    f_score, dfeat (re-paired by the free reshape), dW and db, float32."""
    rng = np.random.RandomState(11)
    n, h, w, c = 2, 8, 16, 21
    feats = np.maximum(rng.randn(n, h, w, 64), 0).astype(np.float32)
    kernel = (rng.randn(1, 1, 64, c) * 0.1).astype(np.float32)
    bias = (rng.randn(c) * 0.1).astype(np.float32)
    target = rng.randint(0, c + 1, (n, h, w)).astype(np.int32)
    target[:, 0, :3] = 255
    cw = tuple((1.0 + 0.1 * np.arange(c)).tolist())
    paired = feats.reshape(n, h, w // 2, 128)
    fn = lambda f, k, b: final_ce_dice_loss_grad(  # noqa: E731
        f, k, b, jnp.asarray(target), cw, c, with_dice=with_dice, interpret=True)
    (jl, jfs), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (paired, kernel, bias)))
    jdf, jdk, jdb = vjp((jnp.ones((), jnp.float32), jnp.zeros((), jnp.float32)))
    assert jdf.shape == paired.shape

    args = [torch.from_numpy(feats),
            torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))),
            torch.from_numpy(bias)]
    args = [a.requires_grad_() for a in args]
    loss, fs = final_ce_dice_loss(*args, torch.from_numpy(target), cw, c, with_dice)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    assert abs(fs.item() - float(jfs)) <= 1e-5
    assert _rel(args[0].grad.numpy().reshape(paired.shape), jdf) <= 1e-4
    assert _rel(args[1].grad.numpy().transpose(2, 3, 1, 0), jdk) <= 1e-4
    assert _rel(args[2].grad, jdb) <= 1e-4
