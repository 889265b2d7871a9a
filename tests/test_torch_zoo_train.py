"""Training of the last eight registry models on the CPU against
``tpu_unet``: two Adam steps of ``hybrid_efficientseg``, ``sk_ultralight``,
``repvgg_segnet``, ``balancedseg`` (heads in train mode and no aux weights:
the first head's loss, as JAX's ``fused_loss_fn``) and
``balancedseg_fpn_sup`` with its preset's aux weights (the port's per-head
route against JAX's jnp ``_total_loss``) against JAX's ``make_train_step``,
the bridge dropouts off on both sides, on seeded weights in JAX's tree
carried across by the bridge (batch norm drawn at random), the batches and
the tolerances of ``test_torch_datab_train.py``, in float32
(``sk_ultralight`` in float64 from JAX's init, see ``FLOAT64``); and deep
supervision's one loss a head (``test_torch_zoo_fit.py`` holds
``reinit_weights`` and ``cli train``)."""
import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch
from jax import enable_x64
from test_torch_datab_train import LADDER_CW, _batch, _jax_vars, fused_loss  # noqa: F401
from test_torch_resnet import randomize_batch_norm, to_numpy
from test_torch_zoo_models import seeded_variables

from tpu_unet.core import fusion
from tpu_unet.models.registry import build_model as jbuild
from tpu_unet.train import step as jstep
from tpu_unet_torch.configs.presets import get_preset
from tpu_unet_torch.infer.convert import state_dict_from_flax
from tpu_unet_torch.models.registry import build_model
from tpu_unet_torch.train import step as tstep

C, LR = 4, 1e-3
# SKConv's ``fc1_bn`` normalises the batch's N global averages: on these
# seeded noise images every image has nearly the same ones, so in train mode
# it normalises rounding noise, and any float32 evaluation lies far from the
# exact one (at batch 2, 32²: JAX's float32 forward 3.8e-2 of the logit scale
# from float64, the port's 1.6e-2).  This model's steps run in float64 on
# both sides (JAX under ``enable_x64`` on its jnp loss, which takes the loss
# in float32 as the port's does), from JAX's own initial weights: both
# float32 losses still round their dlogits apart, and on the seeded weights
# of the other cases the second step's loss drifted 1.4e-3 apart through
# these batch norms.  The other cases start from ``seeded_variables``, JAX's
# tree with nothing compiled for its init.
FLOAT64 = ("sk_ultralight",)



@pytest.fixture
def no_dropout(monkeypatch):
    """Every Dropout2d off on the JAX side (flax's ``nn.Dropout`` as the
    identity); the port's models get rate 0 in the test."""

    class Identity(fnn.Module):
        rate: float = 0.0
        broadcast_dims: tuple = ()
        deterministic: bool = True

        def __call__(self, x):
            return x

    monkeypatch.setattr(fnn, "Dropout", Identity)


def _recipe(name):
    """(class weights, focal, dice, aux weights): the preset's where one
    exists, else the ladder presets' focal + dice."""
    if name in ("hybrid_efficientseg", "balancedseg_fpn_sup"):
        p = get_preset(name)
        return (p.resolved_cls_weights(), p.focal_loss, p.dice_loss, tuple(p.aux_weights))
    return LADDER_CW, True, True, ()


@pytest.mark.parametrize("name", ["hybrid_efficientseg", "sk_ultralight", "repvgg_segnet",
                                  "balancedseg", "balancedseg_fpn_sup"])
def test_two_steps_match_jax(fused_loss, no_dropout, name):  # noqa: F811
    """Two Adam steps (weight decay 1e-4) against JAX's ``make_train_step``
    with the fused loss on (the ``balancedseg_fpn_sup`` step takes JAX's
    jnp ``_total_loss``, its aux weights turn the fused loss off; the
    float64 ``sk_ultralight`` step the same jnp loss).  Step 1
    from the same weights: loss and f_score within 1e-5, every running mean
    / var within 1e-5, the parameters within 2·lr of JAX's and on average
    within lr/20 (Adam moves an element by ±lr whatever its gradient, so
    one whose gradient is at the noise level may land 2·lr away).  Step 2:
    loss within 1e-3, f_score within 1e-2, the parameters within 4·lr."""
    cw, focal, dice, aux = _recipe(name)
    f64 = name in FLOAT64
    model = jbuild(name, C)
    variables = _jax_vars(name) if f64 else seeded_variables(name)
    randomize_batch_norm(variables, seed=3)
    net = build_model(name, C)
    net.load_state_dict(state_dict_from_flax(variables, name), strict=True)
    net.dropout = 0.0
    if f64:
        fusion.set_fused_loss(False)
        net.double()
    x64 = enable_x64(True) if f64 else contextlib.nullcontext()
    jdt = jnp.float64 if f64 else jnp.float32
    with x64:
        jcfg = jstep.StepConfig(num_classes=C, cls_weights=cw, use_focal=focal, use_dice=dice,
                                aux_weights=aux, compute_dtype=jdt)
        tx = jstep.make_optimizer("adam", 0.9, weight_decay=1e-4)
        jstate = jstep.create_train_state(
            model, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), variables), tx)
        jfn = jstep.make_train_step(model, jcfg)
    cfg = tstep.StepConfig(C, cw, use_focal=focal, use_dice=dice, aux_weights=aux,
                           compute_dtype=torch.float64 if f64 else torch.float32)
    state = tstep.TrainState(net, tstep.make_optimizer(net, "adam", 0.9, 1e-4))
    fn = tstep.make_train_step(net, cfg)
    params = dict(net.named_parameters())
    for i, tol, ftol in ((0, 1e-5, 1e-5), (1, 1e-3, 1e-2)):
        with x64:
            jstate, jm = jfn(jstate, _batch(i), LR, jax.random.PRNGKey(i))
        state, m = fn(state, _batch(i), LR)
        assert abs(m["loss"].item() - float(jm["loss"])) <= tol * abs(float(jm["loss"])), \
            (i, m["loss"].item(), float(jm["loss"]))
        assert abs(m["f_score"].item() - float(jm["f_score"])) <= ftol, \
            (i, m["f_score"].item(), float(jm["f_score"]))
        ref = state_dict_from_flax(to_numpy({"params": jstate.params,
                                             "batch_stats": jstate.batch_stats}), name)
        d = torch.cat([(params[k].detach().float() - v).abs().reshape(-1)
                       for k, v in ref.items() if k in params])
        # float64 steps: the bridge and the comparison round both sides to
        # float32, which widens a distance by at most one float32 ulp
        ulp = float(np.spacing(np.float32(max(v.abs().max() for v in ref.values()
                                                if v.is_floating_point())))) if f64 else 0.0
        assert d.max().item() <= 2 * LR * (i + 1) + ulp, (i, d.max().item())
        if i == 0:
            sd = net.state_dict()
            worst = max(float((sd[k].float() - v).abs().max() / v.abs().max().clamp_min(1e-30))
                        for k, v in ref.items() if "running" in k)
            assert worst <= 1e-5, worst
            assert d.mean().item() <= LR / 20, d.mean().item()


def test_deep_supervision_runs_one_loss_per_head(monkeypatch):
    """With aux weights every head's loss is one call of the logit-level
    loss (#25 / #26 on the card), summed with the weights; the f_score is
    the first head's."""
    calls = []
    real = tstep.ce_dice_loss

    def spy(logits, *args, **kwargs):
        out = real(logits, *args, **kwargs)
        calls.append((logits.shape, out[0].item(), out[1].item()))
        return out

    monkeypatch.setattr(tstep, "ce_dice_loss", spy)
    net = build_model("balancedseg_fpn_sup", C)
    aux = (1.0, 0.4, 0.3, 0.2)
    fn = tstep.make_train_step(net, tstep.StepConfig(C, (1.0,) * C, aux_weights=aux))
    _, m = fn(tstep.TrainState(net, tstep.make_optimizer(net)), _batch(0), 0.0)
    assert len(calls) == 4 and all(s[1:3] == (32, 32) for s, _, _ in calls)
    want = sum(w * loss for w, (_, loss, _) in zip(aux, calls))
    assert abs(m["loss"].item() - want) <= 1e-6 * want
    assert m["f_score"].item() == calls[0][2]
    assert all(p.grad is not None for p in net.parameters())
