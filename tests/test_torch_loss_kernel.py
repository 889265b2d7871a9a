"""The plain versions of #27 and #29 (``kernels/loss.py``) against
``tpu_unet``'s ``final_ce_dice_loss_grad`` (Pallas in interpret mode on the
CPU): loss, f_score and ``jax.grad`` for dfeat, dW and db, with float32 and
bf16 features, dice on and off, ignore pixels and raw 255 labels; and the
autograd Function against the plain composition ``conv1x1 → ce_loss +
dice_loss``.

The bf16 references run in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``: by default XLA on the
CPU drops the kernel's f32 → bf16 → f32 rounding of the logits
(loss.py:378-380), which the TPU kernel and the port keep; with the flag
the two agree to the last bit of the loss."""
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

from tpu_unet.kernels.loss import final_ce_dice_loss_grad
from tpu_unet_torch.kernels.loss import (final_ce_dice_bwd_plain,
                                         final_ce_dice_fwd_plain,
                                         final_ce_dice_loss, pack_targets)
from tpu_unet_torch.train.losses import ce_loss, dice_loss, f_score, one_hot


def _case(seed, n, h, w, c):
    rng = np.random.RandomState(seed)
    feats = np.maximum(rng.randn(n, h, w, 64), 0).astype(np.float32)
    kernel = (rng.randn(1, 1, 64, c) * 0.1).astype(np.float32)
    bias = (rng.randn(c) * 0.1).astype(np.float32)
    target = rng.randint(0, c + 1, (n, h, w)).astype(np.int32)
    target[:, 0, :3] = 255  # raw VOC border labels: the ignore class
    cw = tuple((1.0 + 0.1 * np.arange(c)).tolist())
    return feats, kernel, bias, target, cw


def _torch_w(kernel):
    """HWIO (1, 1, 64, C) → the port's final conv weight (C, 64, 1, 1)."""
    return torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


SHAPES = [(2, 8, 16, 21), (1, 16, 8, 4)]
ROOT = Path(__file__).resolve().parents[1]

# JAX side of one case: loss, f_score and the gradients for a cotangent of 1
_JAX_CASE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from tpu_unet.kernels.loss import final_ce_dice_loss_grad
d = dict(np.load(sys.argv[1]))
out = {}
for key in sorted({k.split("/")[0] for k in d}):
    f, k, b, t = (d[key + "/" + n] for n in ("feats", "kernel", "bias", "target"))
    c, with_dice, cw = k.shape[-1], bool(d[key + "/dice"]), tuple(d[key + "/cw"].tolist())
    dt = jnp.bfloat16 if d[key + "/bf16"] else jnp.float32
    fn = lambda f, k, b: final_ce_dice_loss_grad(f, k, b, jnp.asarray(t), cw, c,
                                                 with_dice=with_dice, interpret=True)
    (l, fs), vjp = jax.vjp(fn, *(jnp.asarray(a).astype(dt) for a in (f, k, b)))
    grads = vjp((jnp.ones((), jnp.float32), jnp.zeros((), jnp.float32)))
    for name, v in zip(("loss", "fs", "df", "dk", "db"), (l, fs) + tuple(grads)):
        out[key + "/" + name] = np.asarray(v, np.float32)
np.savez(sys.argv[2], **out)
"""


def _cases():
    return [(dtype, dice, shape) for dtype in ("float32", "bfloat16")
            for dice in (True, False) for shape in SHAPES]


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """JAX's results for every case: float32 in this process, bf16 in a
    subprocess without XLA's excess precision."""
    tmp = tmp_path_factory.mktemp("loss")
    inputs, refs = {}, {}
    for dtype, dice, shape in _cases():
        key = f"{dtype}-{dice}-{'x'.join(map(str, shape))}"
        feats, kernel, bias, target, cw = _case(sum(shape), *shape)
        if dtype == "float32":
            fn = lambda f, k, b: final_ce_dice_loss_grad(  # noqa: E731
                f, k, b, jnp.asarray(target), cw, shape[-1], with_dice=dice,
                interpret=True)
            (l, fs), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (feats, kernel, bias)))
            grads = vjp((jnp.ones((), jnp.float32), jnp.zeros((), jnp.float32)))
            refs[key] = {n: np.asarray(v, np.float32) for n, v in
                         zip(("loss", "fs", "df", "dk", "db"), (l, fs) + tuple(grads))}
            continue
        for n, v in (("feats", feats), ("kernel", kernel), ("bias", bias),
                     ("target", target), ("cw", np.asarray(cw, np.float32)),
                     ("dice", np.asarray(dice)), ("bf16", np.asarray(True))):
            inputs[f"{key}/{n}"] = v
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, "-c", _JAX_CASE, str(tmp / "in.npz"),
                    str(tmp / "out.npz")], check=True, env=env, cwd=str(ROOT),
                   timeout=600)
    for k, v in np.load(tmp / "out.npz").items():
        key, name = k.split("/")
        refs.setdefault(key, {})[name] = v
    return refs


@pytest.mark.parametrize("dtype,with_dice,shape", _cases())
def test_plain_matches_pallas(jax_refs, dtype, with_dice, shape):
    n, h, w, c = shape
    feats, kernel, bias, target, cw = _case(sum(shape), n, h, w, c)
    ref = jax_refs[f"{dtype}-{with_dice}-{'x'.join(map(str, shape))}"]
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tf = torch.from_numpy(feats).to(tdt)
    tw, tb = _torch_w(kernel).to(tdt), torch.from_numpy(bias).to(tdt)
    tt = torch.from_numpy(target)
    loss, fs, res = final_ce_dice_fwd_plain(tf, tw, tb, tt, cw, c, with_dice)
    assert abs(loss.item() - float(ref["loss"])) <= 1e-5 * abs(float(ref["loss"]))
    assert abs(fs.item() - float(ref["fs"])) <= 1e-5
    df, dw, db = final_ce_dice_bwd_plain(tf, tw, tb, tt, cw, c, with_dice, res,
                                         torch.tensor(1.0))
    assert df.dtype == tdt and dw.dtype == tdt and db.dtype == tdt
    # float32: summation order only; bf16: dfeat, dW, db rounded to bf16
    # from float32 sums in another order (one ulp, 2^-8 of the value)
    tol = 1e-4 if dtype == "float32" else 8e-3
    assert _rel(df.float(), ref["df"]) <= tol
    assert _rel(dw.float().numpy().transpose(2, 3, 1, 0), ref["dk"]) <= tol
    assert _rel(db.float(), ref["db"]) <= tol


def test_raw_255_is_the_ignore_class():
    feats, kernel, bias, target, cw = _case(3, 1, 8, 8, 21)
    tf, tw, tb = torch.from_numpy(feats), _torch_w(kernel), torch.from_numpy(bias)
    raw = torch.from_numpy(target)
    clamped = torch.clamp_max(raw, 21)
    a = final_ce_dice_fwd_plain(tf, tw, tb, raw, cw, 21, True)
    b = final_ce_dice_fwd_plain(tf, tw, tb, clamped, cw, 21, True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_packed_targets_match_raw():
    """The one byte a pixel the kernels read: min(t, C), negatives ignored,
    the same loss and f_score as the raw int targets."""
    feats, kernel, bias, target, cw = _case(4, 1, 8, 8, 21)
    raw = torch.from_numpy(target).clone()
    raw[0, 0, :3] = torch.tensor([-1, 300, 22])
    packed = pack_targets(raw, 21)
    assert packed.dtype == torch.uint8 and pack_targets(packed, 21) is packed
    assert torch.equal(packed.long(), torch.where((raw < 0) | (raw > 21), 21, raw).long())
    tf, tw, tb = torch.from_numpy(feats), _torch_w(kernel), torch.from_numpy(bias)
    a = final_ce_dice_fwd_plain(tf, tw, tb, raw, cw, 21, True)
    b = final_ce_dice_fwd_plain(tf, tw, tb, packed, cw, 21, True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("with_dice", [True, False])
def test_autograd_function_matches_plain_composition(with_dice):
    """``final_ce_dice_loss`` (its backward #29) against autograd of
    ``conv1x1 → ce_loss (+ dice_loss)``; f_score as ``f_score`` and without
    a gradient."""
    feats, kernel, bias, target, cw = _case(5, 2, 8, 8, 21)
    args = [torch.from_numpy(feats), _torch_w(kernel), torch.from_numpy(bias)]
    a = [t.clone().requires_grad_() for t in args]
    b = [t.clone().requires_grad_() for t in args]
    tt = torch.from_numpy(target)
    loss, fs = final_ce_dice_loss(*a, tt, cw, 21, with_dice)
    assert not fs.requires_grad
    loss.backward()
    logits = b[0] @ b[1].reshape(21, -1).t() + b[2]
    ref = ce_loss(logits, tt, cw, 21)
    oh = one_hot(tt, 21)
    if with_dice:
        ref = ref + dice_loss(logits, oh)
    ref.backward()
    assert abs(loss.item() - ref.item()) <= 1e-5 * ref.item()
    assert abs(fs.item() - f_score(logits.detach(), oh).item()) <= 1e-6
    for x, y in zip(a, b):
        assert _rel(x.grad, y.grad) <= 1e-4


def test_too_many_classes_raise():
    f = torch.zeros(1, 2, 2, 64)
    with pytest.raises(ValueError, match="126"):
        final_ce_dice_loss(f, torch.zeros(127, 64, 1, 1), torch.zeros(127),
                           torch.zeros(1, 2, 2, dtype=torch.long), [1.0] * 127, 127)
