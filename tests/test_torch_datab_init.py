"""The DataB models' ``reinit_weights`` against ``tpu_unet``'s, and the
DataB step's float32 gradients against a float64 evaluation, on the CPU
(the models and weights of ``test_torch_datab_train.py``)."""
import contextlib

import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch
from test_torch_datab_train import C, CW, LADDER_CW, _batch, _jax_vars, _pair, _rel
from test_torch_resnet import to_numpy

from tpu_unet.train.fit import reinit_weights as jreinit
from tpu_unet_torch.infer.convert import state_dict_from_flax
from tpu_unet_torch.models.registry import build_model
from tpu_unet_torch.nn import blocks
from tpu_unet_torch.train import step as tstep
from tpu_unet_torch.train.fit import reinit_weights


def _bn_float32_stats(x, module, train=False):
    """``blocks.bn`` in train mode with its statistics and normalisation in
    float32 whatever the input's dtype (what ``bn`` did for a float64
    input before it followed flax into float64)."""
    assert train
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    with torch.no_grad():
        for buf, stat in ((module.running_mean, mean), (module.running_var, var)):
            buf.copy_(blocks.BN_MOMENTUM * buf + (1.0 - blocks.BN_MOMENTUM) * stat)
    mul = torch.rsqrt(var + module.eps) * module.weight.float()
    y = (xf - mean[:, None, None]) * mul[:, None, None] + module.bias.float()[:, None, None]
    return y.to(x.dtype)


@contextlib.contextmanager
def float32_batch_norm():
    """The DataB models' batch norms (all in ``nn/blocks.py``) with float32
    statistics while the block runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blocks, "bn", _bn_float32_stats)
        yield


# the largest distance of the float64 evaluation with float32 batch
# statistics from the one in float64 throughout, over every parameter,
# measured on this batch and these weights: 3.49e-2 (traditional,
# ``up3.conv.double_conv.0.weight``) and 2.73e-5 (the ladder,
# ``enc1.conv.1.weight``); each bound is its measurement with about 40%
# room.  Both sides are float64, so no CPU's float32 summation order is in
# it; the float32 step is held to the all-float64 evaluation by the sum of
# this bound and its own (the triangle inequality)
TRUE_F64_TOL = {"traditional": 5e-2, "ultralight_large_optimized": 4e-5}


def _float64_grads(name, variables, batch, cw):
    """The gradients of a float64 evaluation of the model and the loss."""
    import torch.nn.functional as F

    n64 = build_model(name, C).double()
    n64.load_state_dict(state_dict_from_flax(variables, name), strict=True)
    n64.dropout = 0.0
    logits = n64(torch.from_numpy(batch["image"]).double() / 255.0, train=True)
    t = torch.from_numpy(batch["label"]).long().clamp_max(C)
    oh = F.one_hot(t, C + 1)[..., :C].double()
    logp = torch.log_softmax(logits, -1)
    p = logp.exp()
    u = (oh @ torch.tensor(cw, dtype=torch.float64)) * -(logp * oh).sum(-1)
    tp, ps, ts = (p * oh).sum((0, 1, 2)), p.sum((0, 1, 2)), oh.sum((0, 1, 2))
    dice = 1 - ((2 * tp + 1e-5) / (ps + ts + 1e-5)).mean()
    ((0.5 * (1 - torch.exp(-u)) ** 2 * u).mean() + dice).backward()
    return {k: p.grad for k, p in n64.named_parameters()}


@pytest.mark.parametrize("name", ["traditional", "ultralight_large_optimized"])
def test_step_gradients_match_float64(name):
    """The step's float32 gradients (focal + dice through the logit-level
    loss) within 1e-4 of a float64 evaluation of the same model and loss
    whose batch norms take float32 statistics (:func:`float32_batch_norm`)
    (max |error| over max |gradient| of each parameter; 5e-3 for the ladder,
    whose 2×2 bridge normalises 8 values a channel), except the conv biases
    before a batch norm (exact gradient 0; both at noise level).  That
    reference lies within ``TRUE_F64_TOL`` of the evaluation in float64
    throughout, batch norm included: the float32 batch statistics of
    8-2048 values a channel, whose mean cancels, move the gradients behind
    them by up to that much; so the step lies within the sum of the two
    bounds of the all-float64 evaluation.  JAX's float32 step is no arbiter here: on this CPU its
    gradients of these models lie up to 3.5% (traditional) and 12% (the
    ladder, at 64²) from the float64 ones; its fused and plain loss routes
    agree to 2e-6, so that error lies in XLA's float32 backward of the
    model."""
    cw = CW.get(name, LADDER_CW)
    _, variables, net = _pair(name)
    batch = _batch(5)
    state = tstep.TrainState(net, tstep.make_optimizer(net, "sgd", 0.0))
    tstep.make_train_step(net, tstep.StepConfig(C, cw, use_focal=True, use_dice=True))(
        state, batch, 0.0)

    with float32_batch_norm():
        ref = _float64_grads(name, variables, batch, cw)
    true64 = _float64_grads(name, variables, batch, cw)
    # every conv but the classifier feeds a batch norm (the ladder's
    # depthwise one through the linear pointwise conv)
    cancelled = {f"{k}.bias" for k, m in net.named_modules()
                 if isinstance(m, torch.nn.Conv2d) and k not in ("outc", "final")}
    tol = 1e-4 if name == "traditional" else 5e-3
    for k, p32 in net.named_parameters():
        g, r, t = p32.grad.double(), ref[k], true64[k]
        if k in cancelled:
            assert g.abs().max() <= 1e-5 and r.abs().max() <= 1e-5, k
            assert t.abs().max() <= 1e-5, k
        else:
            assert _rel(g, r) <= tol, (k, _rel(g, r))
            assert _rel(r, t) <= TRUE_F64_TOL[name], (k, _rel(r, t))
            assert _rel(g, t) <= tol + TRUE_F64_TOL[name], (k, _rel(g, t))


# --- reinit_weights ---------------------------------------------------------

@pytest.mark.parametrize("name", ["traditional", "traditional22", "lightweight", "ultralight",
                                  "ultralight_large", "ultralight_large_optimized",
                                  "ultralight44", "unet_vgg", "unet_resnet50", "self_net"])
def test_reinit_weights_draws_jax_numbers(name):
    """JAX's ``reinit_weights`` on its flax tree (insertion order, as its
    ``fit`` hands it over) and the port's on the same initial weights:
    every parameter equal (conv kernels and batch-norm scales drawn, biases
    zeroed, dense kernels kept).  The canonical UNets' trees are JAX's
    ``init_model`` at 64² (ResNet50 interleaves its 53 batch norms with its
    convs)."""
    canonical = name in ("unet_vgg", "unet_resnet50", "self_net")
    variables = _jax_vars(name, 64) if canonical else _jax_vars(name)
    net = build_model(name, C)
    net.load_state_dict(state_dict_from_flax(variables, name), strict=True)
    ref = state_dict_from_flax(to_numpy(jreinit(variables, seed=7)), name)
    reinit_weights(net, seed=7)
    for k, v in net.state_dict().items():
        assert torch.equal(v, ref[k]), k
