"""The last eight registry models' training recipe on the CPU against
``tpu_unet``: ``reinit_weights`` against JAX's draws on seeded weights
(dense biases not zero), and ``cli train`` of a deep-supervision preset on
the DataB defect layout."""
import contextlib
import io
import os
import shutil

import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch
from test_torch_fit import write_voc
from test_torch_resnet import to_numpy
from test_torch_zoo_models import seeded_variables

from tpu_unet.train.fit import reinit_weights as jreinit
from tpu_unet_torch import cli
from tpu_unet_torch.configs.presets import get_preset
from tpu_unet_torch.infer.convert import state_dict_from_flax
from tpu_unet_torch.models.registry import build_model
from tpu_unet_torch.train.checkpoint import load_any
from tpu_unet_torch.train.fit import reinit_weights

C = 4
ZOO = ["improved_ultralight", "sk_ultralight", "repvgg_segnet", "hybrid_efficientseg",
       "balancedseg", "balancedseg_fpn", "balancedseg_fpn_sup", "balancedseg_crfs"]


@pytest.mark.parametrize("name", ZOO)
def test_reinit_weights_draws_jax_numbers(name):
    """JAX's ``reinit_weights`` on its flax tree (insertion order, as its
    ``fit`` hands it over) and the port's on the same initial weights:
    every parameter and buffer equal (conv kernels and batch-norm scales
    drawn in flax's order, biases zeroed, dense kernels kept)."""
    variables = seeded_variables(name)
    net = build_model(name, C)
    net.load_state_dict(state_dict_from_flax(variables, name), strict=True)
    ref = state_dict_from_flax(to_numpy(jreinit(variables, seed=7)), name)
    reinit_weights(net, seed=7)
    for k, v in net.state_dict().items():
        assert torch.equal(v, ref[k]), k


@pytest.fixture
def tmp_path(tmp_path):
    """The test's directory, removed once the test is done."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_cli_train_deep_supervision_preset(tmp_path):
    """``cli train --preset balancedseg_fpn_sup --cpu`` (deep supervision
    through ``fit``) for 1 epoch of 2 steps at 32² on the DataB defect
    layout (``datasets/DataB``): finite weights and the last checkpoint
    with its epoch."""
    preset = "balancedseg_fpn_sup"
    assert get_preset(preset).dataset == "defect" and get_preset(preset).aux_weights
    write_voc(str(tmp_path), 4, 2, seed=8)
    os.makedirs(tmp_path / "datasets")
    os.rename(tmp_path / "VOCdevkit" / "VOC2012", tmp_path / "datasets" / "DataB")
    out = tmp_path / "logs"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["train", "--preset", preset, "--cpu", "--data-root", str(tmp_path),
                  "--input-shape", "32", "32", "--batch-size", "2", "--epochs", "1",
                  "--no-eval", "--save-dir", str(out)])
    assert "Epoch 1/1" in buf.getvalue()
    state = load_any(str(out / "last_epoch_weights.pth"))
    assert state["epoch"] == 1
    assert all(bool(torch.isfinite(v).all()) for v in state["model_state_dict"].values()
               if v.is_floating_point())
