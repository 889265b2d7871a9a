"""The port's export (``tools/export.py``, ``Unet.convert_to_export``,
``cli export``), its kernels as operators, and its int8 quantization
(``tools/quantization.py``) on the CPU against ``tpu_unet``: the exported
``ultralight`` program against JAX's StableHLO export on the same weights,
``unet_vgg``'s reloaded program against the live forward, the program a card
would export (traced on fake CUDA tensors: the four kernel operators and no
convolution), each operator's fake against its plain version's shapes, and
the quantized values, scales, dequantized weights, byte counts and logits
against JAX's on three models."""
import shutil

import jax
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch
from test_torch_cli_tools import wrapper_pair
from test_torch_zoo_models import seeded_variables
from torch._subclasses.fake_tensor import FakeTensorMode

from tpu_unet.models.registry import build_model as jbuild
from tpu_unet.tools import quantization as jq
from tpu_unet.tools.export import load_stablehlo
from tpu_unet_torch import cli
from tpu_unet_torch.infer.convert import state_dict_from_flax
from tpu_unet_torch.infer.wrapper import Unet
from tpu_unet_torch.kernels import decoder_fuse, encoder, launch_counts, stem, upconv
from tpu_unet_torch.models.registry import build_model
from tpu_unet_torch.tools import quantization as tq
from tpu_unet_torch.tools.export import ProbsForward, load_program

OPS = {"vgg_stem", "vgg_block", "unetup", "upconv"}


@pytest.fixture
def tmp_path(tmp_path):
    """The test's directory, removed once the test is done."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _image(size, seed=0):
    return np.random.default_rng(seed).random((1, size, size, 3)).astype(np.float32)


def test_export_matches_stablehlo(tmp_path):
    """ultralight at 32²: the reloaded program's probabilities within 1e-5
    of JAX's reloaded StableHLO export, summing to 1."""
    ju, tu = wrapper_pair("ultralight", tmp_path)
    x = _image(32)
    ju.convert_to_export(str(tmp_path / "u.stablehlo"))
    ref = np.asarray(load_stablehlo(str(tmp_path / "u.stablehlo"))(x))
    counts = dict(launch_counts)
    tu.convert_to_export(str(tmp_path / "u.pt2"))
    out = load_program(str(tmp_path / "u.pt2"))(x)
    assert launch_counts == counts  # a CPU program runs no kernel
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape == (1, 32, 32, 4)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-5)


def test_export_unet_vgg_and_cli(tmp_path, capsys):
    """unet_vgg at 64² reloads equal to the live float32 forward; ``cli
    export --cpu`` writes a program that loads and runs."""
    tu = Unet(model="unet_vgg", num_classes=21, input_shape=[64, 64], cuda=False)
    x = torch.from_numpy(_image(64, 1))
    tu.convert_to_export(str(tmp_path / "vgg.pt2"))
    out = load_program(str(tmp_path / "vgg.pt2"))(x)
    with torch.no_grad():
        live = ProbsForward(tu.net)(x)
    assert torch.equal(out, live)
    assert all(p.requires_grad for p in tu.net.parameters())  # restored
    cli.main(["export", "--preset", "ultralight", "--input-shape", "32", "32",
              "--out", str(tmp_path / "cli.pt2"), "--cpu"])
    assert "torch.export program saved to" in capsys.readouterr().out
    probs = load_program(str(tmp_path / "cli.pt2"))(_image(32, 2))
    assert tuple(probs.shape) == (1, 32, 32, 4)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)


def _fake_on_card(net):
    """``net``'s parameters as fake CUDA tensors (in the active fake mode)."""
    for mod in net.modules():
        for k, p in list(mod._parameters.items()):
            if p is not None:
                mod._parameters[k] = torch.nn.Parameter(
                    torch.empty(p.shape, device="cuda"), requires_grad=False)
    return net


@pytest.mark.parametrize("name,ops", [("unet_vgg", OPS - {"upconv"}), ("self_net", OPS)])
def test_card_export_holds_the_kernel_ops(name, ops):
    """The program a card would export, traced on fake CUDA tensors at
    256²: each kernel of the live forward is its operator in the graph, and
    no convolution stands in for one."""
    with FakeTensorMode():
        net = _fake_on_card(build_model(name, 21).eval())
        x = torch.zeros((1, 256, 256, 3), device="cuda")
        program = torch.export.export(ProbsForward(net), (x,), strict=False)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    found = {t.split(".")[1] for t in targets if t.startswith("tpu_unet_torch.")}
    assert found == ops
    assert targets.count("tpu_unet_torch.vgg_block.default") == 4
    assert targets.count("tpu_unet_torch.unetup.default") == 4
    assert not any("conv" in t and not t.startswith("tpu_unet_torch.") for t in targets)


def _fake_case(op, dt, device, B=8):
    """(op, plain version, args on ``device``) at unet_vgg's 512² serving
    shapes (the upconv head at self_net's)."""
    e = lambda *s, d=dt: torch.empty(s, dtype=d, device=device)  # noqa: E731
    if op == "vgg_stem":
        return (stem.vgg_stem_op, stem.vgg_stem_plain,
                (e(B, 512, 512, 3, d=torch.uint8), e(64, 3, 3, 3), e(64), e(64, 64, 3, 3), e(64)))
    if op == "vgg_block":
        ws, bs = [e(256, 128, 3, 3), e(256, 256, 3, 3), e(256, 256, 3, 3)], [e(256)] * 3
        return (encoder.vgg_block_op, lambda *a: list(encoder.vgg_block_plain(*a)),
                (e(B, 128, 128, 128), ws, bs, True))
    if op == "unetup":
        return (decoder_fuse.unetup_op, decoder_fuse.unetup_plain,
                (e(B, 512, 512, 64), e(B, 256, 256, 128), e(64, 192, 3, 3), e(64),
                 e(64, 64, 3, 3), e(64)))
    return (upconv.upconv_op, upconv.upconv_plain,
            (e(B, 512, 512, 64), e(64, 64, 3, 3), e(64), e(64, 64, 3, 3), e(64)))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_op_fakes_give_the_plain_shapes(op, dt):
    with FakeTensorMode():
        fn, plain, args = _fake_case(op, dt, "cuda")
        out = fn(*args)
        ref = plain(*_fake_case(op, dt, "cpu")[2])
    out = [out] if isinstance(out, torch.Tensor) else list(out)
    ref = [ref] if isinstance(ref, torch.Tensor) else list(ref)
    assert [(tuple(o.shape), o.dtype, o.device.type) for o in out] == \
        [(tuple(r.shape), r.dtype, "cuda") for r in ref]
    assert all(o.is_contiguous() for o in out)


# each wrapper's module, its operator's and its launch's names
WRAPPERS = {"vgg_stem": (stem, "vgg_stem_op", "_vgg_stem_cuda"),
            "vgg_block": (encoder, "vgg_block_op", "_vgg_block_cuda"),
            "unetup": (decoder_fuse, "unetup_op", "_unetup_cuda"),
            "upconv": (upconv, "upconv_op", "_upconv_cuda")}


@pytest.mark.parametrize("op", sorted(OPS))
def test_wrappers_take_the_operator_only_while_traced(op, monkeypatch):
    """On the card an eager call launches its kernel directly, without the
    operator's dispatch; a traced call (fake tensors) takes the operator,
    which the graph keeps.  The tensors are taken for the card's and the
    operator and launch are spies."""
    mod, op_name, launch = WRAPPERS[op]
    calls = []
    monkeypatch.setattr(mod, "on_cpu", lambda t: False)
    monkeypatch.setattr(mod, op_name, lambda *a: calls.append("operator") or ("y",) * 3)
    monkeypatch.setattr(mod, launch, lambda *a: calls.append("launch") or ("y",) * 3)

    def args():
        x, w, b = torch.zeros(1, 8, 8, 4), torch.zeros(4, 4, 3, 3), torch.zeros(4)
        return {"vgg_stem": (x, w, b, w, b), "vgg_block": (x, [w], [b], True),
                "unetup": (x, x, w, b, w, b), "upconv": (x, w, b, w, b)}[op]

    with torch.no_grad():
        getattr(mod, op)(*args())
        with FakeTensorMode():
            getattr(mod, op)(*args())
    assert calls == ["launch", "operator"]


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _bridge(variables, name, replace):
    """The bridge of ``variables`` with each params leaf at ``path`` replaced
    by ``replace(path, leaf)``."""
    out = {k: v for k, v in variables.items()}
    params = jax.tree_util.tree_map(lambda a: a, variables["params"])
    for path, leaf in list(_paths(params)):
        _leaf(params, path[:-1])[path[-1]] = replace(path, leaf)
    out["params"] = params
    return state_dict_from_flax(out, name)


@pytest.mark.parametrize("name", ["unet_vgg", "traditional", "balancedseg_fpn_sup"])
def test_quantization_matches_jax(name):
    """int8 values and scales bit-equal to JAX's through the bridge, the
    quantized set one to one with JAX's 4-D leaves, the dequantized weights
    and the byte counts equal, the logits within the float32 forward's
    bound (tests/test_torch_zoo_models.py:147)."""
    variables = seeded_variables(name, size=32)
    sd = state_dict_from_flax(variables, name)
    net = build_model(name, 4)
    net.load_state_dict(sd, strict=True)
    net.eval()
    bundle = tq.quantize_variables(net)
    jbundle = jq.quantize_variables(variables)

    # which JAX leaf each port parameter comes from: bridge marker values
    paths = [p for p, _ in _paths(variables["params"])]
    ids = _bridge(variables, name, lambda p, a: np.full(a.shape, paths.index(p), np.float32))
    of = {k: paths[int(ids[k].reshape(-1)[0])] for k, _ in net.named_parameters()}
    assert set(bundle["quantized"]) == {k for k in of if _leaf(variables["params"], of[k]).ndim == 4}
    assert sorted(of[k] for k in bundle["quantized"]) == \
        sorted(p for p, a in _paths(variables["params"]) if a.ndim == 4)

    for k, q in bundle["quantized"].items():
        jqk = _leaf(jbundle["quantized"], of[k])
        assert q["values"].dtype == torch.int8 and q["scale"].dtype == torch.float32
        np.testing.assert_array_equal(q["values"].numpy(), jqk["values"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(q["scale"].numpy().reshape(-1), jqk["scale"].reshape(-1))
    jdeq = jq.dequantize_params(jbundle["quantized"], jbundle["rest"])
    deq = tq.dequantize_params(bundle["quantized"], bundle["rest"])
    ref = _bridge(variables, name, lambda p, a: np.asarray(_leaf(jdeq, p), np.float32))
    for k, v in deq.items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0)
    assert tq.quantization_report(net) == jq.quantization_report(variables)

    x = _image(32, 3)
    jout = jax.jit(lambda b, x: jq.quantized_apply(jbuild(name, 4), b, x))(jbundle, x)
    out = tq.quantized_apply(net, bundle, torch.from_numpy(x))
    out, jout = [o[0] if isinstance(o, (tuple, list)) else o for o in (out, jout)]
    ref = np.asarray(jout)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    for k, v in net.state_dict().items():  # the net's own tensors untouched
        assert torch.equal(v, sd[k]), k
