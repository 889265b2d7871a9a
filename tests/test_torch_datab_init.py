"""The DataB models' ``reinit_weights`` against ``tpu_unet``'s, and the
DataB step's float32 gradients against a float64 evaluation, on the CPU
(the models and weights of ``test_torch_datab_train.py``)."""
import pytest
import torch
from test_torch_datab_train import C, CW, LADDER_CW, _batch, _jax_vars, _pair, _rel
from test_torch_resnet import to_numpy

from tpu_unet.train.fit import reinit_weights as jreinit
from tpu_unet_torch.infer.convert import state_dict_from_flax
from tpu_unet_torch.models.registry import build_model
from tpu_unet_torch.train import step as tstep
from tpu_unet_torch.train.fit import reinit_weights


@pytest.mark.parametrize("name", ["traditional", "ultralight_large_optimized"])
def test_step_gradients_match_float64(name):
    """The step's float32 gradients (focal + dice through the logit-level
    loss) within 1e-4 of a float64 evaluation of the same model and loss
    (max |error| over max |gradient| of each parameter; 5e-3 for the ladder,
    whose 2×2 bridge normalises 8 values a channel), except the conv biases
    before a batch norm (exact gradient 0; both at noise level).  JAX's
    float32 step is no arbiter here: on this CPU its gradients of these
    models lie up to 3.5% (traditional) and 12% (the ladder, at 64²) from
    the float64 ones, while the port's lie within 1e-5 and 5e-3; its fused
    and plain loss routes agree to 2e-6, so that error lies in XLA's
    float32 backward of the model."""
    import torch.nn.functional as F

    cw = CW.get(name, LADDER_CW)
    _, variables, net = _pair(name)
    batch = _batch(5)
    state = tstep.TrainState(net, tstep.make_optimizer(net, "sgd", 0.0))
    tstep.make_train_step(net, tstep.StepConfig(C, cw, use_focal=True, use_dice=True))(
        state, batch, 0.0)

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
    ref = dict(n64.named_parameters())
    # every conv but the classifier feeds a batch norm (the ladder's
    # depthwise one through the linear pointwise conv)
    cancelled = {f"{k}.bias" for k, m in net.named_modules()
                 if isinstance(m, torch.nn.Conv2d) and k not in ("outc", "final")}
    tol = 1e-4 if name == "traditional" else 5e-3
    for k, p32 in net.named_parameters():
        g, r = p32.grad.double(), ref[k].grad
        if k in cancelled:
            assert g.abs().max() <= 1e-5 and r.abs().max() <= 1e-5, k
        else:
            assert _rel(g, r) <= tol, (k, _rel(g, r))


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
