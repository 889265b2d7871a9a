"""The ``unet_resnet50`` train step in float64 on both sides: JAX's
``make_train_step`` in its default TPU configuration (fused loss, fused
decoder, ``PAIRED_TRAIN=1``; the Pallas kernels in interpret mode) with
``jax_enable_x64`` and ``compute_dtype=float64``, in a subprocess (x64 is
a process-wide switch), against the port's step with
``compute_dtype=torch.float64`` (ResNet50's batch norms take a float64
input's statistics in float64, as flax's do), on the weights and batch
of ``test_torch_resnet_train.py``.  In float32 JAX's CPU step lies up to 13%
from float64 on the decoder's gradients (that file); here the two steps
compute the same function at a precision where its agreement shows.
Neither side is float64 throughout: the Pallas kernels and the port's
plain weight gradients, upsample adjoint and loss keep float32 inside."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_resnet_train import CW, STEP_BATCH, _batch, _cos, _port, _rel, rn50  # noqa: F401

from tpu_unet_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]

# JAX's float64 step: the variables from argv[1], results to argv[2] in the
# port's state-dict names
_JAX_STEP = """
import sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np, optax
from tpu_unet.core import fusion
from tpu_unet.models.registry import build_model
from tpu_unet.train import step as jstep
from tpu_unet_torch.infer.convert import state_dict_from_flax

fusion.set_fused_loss(True); fusion.set_fused_decoder(True)
fusion.set_fused_train(False); fusion.set_paired_train(True)
flat = dict(np.load(sys.argv[1]))
jv = {}
for k, v in flat.items():
    if k.startswith("batch/"):
        continue
    node = jv
    *path, leaf = k.split("/")
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = v.astype(np.float64)
keep = optax.GradientTransformation(
    lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
    lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
model = build_model("unet_resnet50", 21)
state = jstep.create_train_state(model, jv, keep)
cfg = jstep.StepConfig(num_classes=21, cls_weights=tuple(flat["batch/cw"].tolist()),
                       use_dice=True, compute_dtype=jnp.float64)
batch = {"image": flat["batch/image"], "label": flat["batch/label"]}
new, m = jstep.make_train_step(model, cfg)(state, batch, 1e-3, jax.random.PRNGKey(0))
np_ = lambda t: jax.tree_util.tree_map(np.array, t)
grads = state_dict_from_flax({"params": np_(new.opt_state), "batch_stats": jv["batch_stats"]},
                             "unet_resnet50")
stats = state_dict_from_flax({"params": jv["params"], "batch_stats": np_(new.batch_stats)},
                             "unet_resnet50")
out = {f"grad/{k}": v.numpy() for k, v in grads.items()}
out.update({f"stat/{k}": v.numpy() for k, v in stats.items() if "running" in k})
out["loss"] = np.asarray(float(m["loss"]))
out["f_score"] = np.asarray(float(m["f_score"]))
np.savez(sys.argv[2], **out)
"""


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def steps(rn50, tmp_path_factory):
    """(JAX's float64 step's results, the port's float64 step: loss,
    f_score, model after it)."""
    _, jv = rn50
    tmp = tmp_path_factory.mktemp("x64")
    batch = _batch(STEP_BATCH)
    np.savez(tmp / "in.npz", **_flatten(jv), **{"batch/image": batch["image"],
                                                "batch/label": batch["label"],
                                                "batch/cw": np.asarray(CW)})
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", _JAX_STEP, str(tmp / "in.npz"), str(tmp / "out.npz")],
                   check=True, env=env, cwd=str(ROOT), timeout=600)
    ref = dict(np.load(tmp / "out.npz"))
    shutil.rmtree(tmp, ignore_errors=True)
    net = _port(jv).double()
    cfg = tstep.StepConfig(num_classes=len(CW), cls_weights=CW, use_dice=True,
                           compute_dtype=torch.float64)
    state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9))
    _, m = tstep.make_train_step(net, cfg)(state, batch, 1e-3)
    return ref, (m["loss"].item(), m["f_score"].item(), net)


def test_float64_step_matches_jax(steps):
    """Loss and f_score within 1e-6 (measured 1.2e-7: both losses sum in
    float32), every running mean / var within 1e-5 (measured 2.9e-8 at the
    stem's batch norm, growing to 2.6e-6 in layer4: float32 roundings
    enter both forwards), the gradients of the decoder, the head and
    ``final`` within 1e-4 relative (measured ≤ 1.8e-5), the encoder's at a
    cosine of 0.999: behind its batch-norm backwards those roundings move
    their largest elements by up to 8.5%."""
    ref, (loss, fs, net) = steps
    assert abs(loss - ref["loss"]) <= 1e-6 * abs(ref["loss"])
    assert abs(fs - ref["f_score"]) <= 1e-6 * abs(ref["f_score"])
    for k, p in net.named_parameters():
        g, r = p.grad.numpy(), ref[f"grad/{k}"]
        if k.startswith("resnet."):
            assert _cos(g, r) >= 0.999, (k, _cos(g, r))
        else:
            assert _rel(g, r) <= 1e-4, (k, _rel(g, r))
    own = net.state_dict()
    for k in (k for k in own if "running" in k):
        assert _rel(own[k], ref[f"stat/{k}"]) <= 1e-5, (k, _rel(own[k], ref[f"stat/{k}"]))


def test_f32_card_arithmetic_step_matches_float64(rn50, steps):
    """The float32 step the card runs for unet_resnet50 (``check_ported``
    lets it through on the card in float32, both routes), here on the CPU
    with every kernel's TF32 arithmetic emulated (``kernels/tf32.py::
    emulated_plain_versions``: the decoder stages and the up_conv head's
    #10 / #12 on truncated activations and rounded weights, the weight
    gradients on rounded operands, float64 sums; ResNet50 and its batch
    norms plain float32, as cuDNN runs them on the card) on the
    ``"paired"`` route, against JAX's float64 step (JAX's float32 step lies
    up to 13% from it behind the batch norms, ``test_torch_resnet_train.py``):
    the loss times 4 within STEP_LOSS_REL_TOL, the bound of the card's
    float32 steps (``kernels/tf32.py``); the gradients of the decoder, the
    head and ``final``, and every gradient's cosine, times 4 within this
    model's bounds at 64² (STEP_GRAD_REL_TOL_RN50_64PX,
    STEP_GRAD_COS_RN50_64PX: up4 normalises 32 pixels a channel here, 2048
    on the card); the running statistics within 1e-2, as the card's check
    reads them."""
    import dataclasses

    from tpu_unet_torch.kernels import tf32

    _, jv = rn50
    ref, _ = steps
    net = _port(jv)
    cfg = tstep.StepConfig(num_classes=len(CW), cls_weights=CW, use_dice=True)
    assert cfg.compute_dtype == torch.float32 and cfg.train_route == "paired"
    for route in tstep.TRAIN_ROUTES:
        tstep.check_ported(net, dataclasses.replace(cfg, train_route=route),
                           torch.device("cuda"))
    state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9))
    with tf32.emulated_plain_versions():
        _, m = tstep.make_train_step(net, cfg)(state, _batch(STEP_BATCH), 1e-3)
    lrel = abs(m["loss"].item() - ref["loss"]) / abs(ref["loss"])
    dec_rel, enc_rel, worst_cos = 0.0, 0.0, 1.0
    for k, p in net.named_parameters():
        g, r = p.grad.numpy(), ref[f"grad/{k}"]
        if k.startswith("resnet."):
            enc_rel = max(enc_rel, _rel(g, r))
        else:
            dec_rel = max(dec_rel, _rel(g, r))
        worst_cos = min(worst_cos, _cos(g, r))
    own = net.state_dict()
    stat_rel = max(_rel(own[k], ref[f"stat/{k}"]) for k in own if "running" in k)
    print({"loss": lrel, "grad_rel": dec_rel, "encoder_grad_rel": enc_rel,
           "grad_1-cos": 1 - worst_cos, "running_stats": stat_rel})
    assert lrel * 4 <= tf32.STEP_LOSS_REL_TOL
    assert dec_rel * 4 <= tf32.STEP_GRAD_REL_TOL_RN50_64PX
    assert (1 - worst_cos) * 4 <= 1 - tf32.STEP_GRAD_COS_RN50_64PX
    assert stat_rel <= 1e-2
