"""The blocks of the last eight registry models (``nn/blocks.py``: the
depthwise-separable family with batch norm, SK, RepVGG / FusedMBConv,
STDC and decoder blocks, the attention blocks, the multi-scale, edge and
fusion blocks) and ``nn/resize.py::resize_nearest`` against ``tpu_unet`` on
the CPU.  Eval mode in float32 on flax weights carried across by the
bridge (batch norm and dense biases drawn at random); train mode (batch
norm on the batch statistics, the running statistics after it) in float64,
flax under ``jax.enable_x64``, as ``tests/test_torch_bn.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch
from jax import enable_x64
from test_torch_ladder import randomize_dense_biases
from test_torch_resnet import randomize_batch_norm, to_numpy

from tpu_unet.nn import blocks as jb
from tpu_unet.nn import resize as jresize
from tpu_unet_torch.infer import convert as cv
from tpu_unet_torch.nn import blocks as b
from tpu_unet_torch.nn.resize import resize_nearest

C = 16  # input channels of every case but the ones that say otherwise


def _only_conv(path):
    """Bridge of a block whose one conv sits at ``path`` in flax's tree."""
    def bridge(params, stats, sd, key):
        tree = params
        for part in path:
            tree = tree[part]
        cv._conv(tree, sd, f"{key}.conv")
    return bridge


# name → (flax module, port module, bridge, input channels, skip channels
# (None: no second input; 0: called with None), takes ``train``)
CASES = {
    "DWSeparableBNReLU": (lambda: jb.DWSeparableBNReLU(24),
                          lambda: b.DWSeparableBNReLU(C, 24), cv._dw_bn, C, None, True),
    "DWSeparableBNReLU_stride2": (lambda: jb.DWSeparableBNReLU(24, stride=2),
                                  lambda: b.DWSeparableBNReLU(C, 24, 2), cv._dw_bn, C, None,
                                  True),
    "DWConvBNReLU_dilation2": (lambda: jb.DWConvBNReLU(24, dilation=2),
                               lambda: b.DWConvBNReLU(C, 24, dilation=2), cv._dw_bn, C,
                               None, True),
    "DWConvBNReLU_padding2": (lambda: jb.DWConvBNReLU(24, padding=2),
                              lambda: b.DWConvBNReLU(C, 24, padding=2), cv._dw_bn, C, None,
                              True),
    "SKConv": (lambda: jb.SKConv(32), lambda: b.SKConv(C, 32), cv._sk_conv, C, None, True),
    # mid 22 → 44: the clamped group count gcd(32, gcd(22, 44)) = 2
    "LightSKBlock": (lambda: jb.LightSKBlock(44), lambda: b.LightSKBlock(C, 44),
                     cv._sk_block, C, None, True),
    "RepVGGBlock": (lambda: jb.RepVGGBlock(24), lambda: b.RepVGGBlock(C, 24),
                    cv._repvgg_block, C, None, True),
    "RepVGGBlock_identity": (lambda: jb.RepVGGBlock(C), lambda: b.RepVGGBlock(C, C),
                             cv._repvgg_block, C, None, True),
    "RepVGGBlock_deploy": (lambda: jb.RepVGGBlock(24, deploy=True),
                           lambda: b.RepVGGBlock(C, 24, deploy=True), cv._repvgg_block, C,
                           None, True),
    "FusedMBConv": (lambda: jb.FusedMBConv(24), lambda: b.FusedMBConv(C, 24),
                    cv._repvgg_block, C, None, True),
    "FusedMBConv_residual": (lambda: jb.FusedMBConv(C), lambda: b.FusedMBConv(C, C),
                             cv._repvgg_block, C, None, True),
    "RepVGGStem": (lambda: jb.RepVGGStem(24), lambda: b.RepVGGStem(C, 24),
                   cv._repvgg_stem, C, None, True),
    "RepVGGStem_fusedmb": (lambda: jb.RepVGGStem(24, use_repvgg=False),
                           lambda: b.RepVGGStem(C, 24, use_repvgg=False), cv._repvgg_stem, C,
                           None, True),
    "STDCBlock": (lambda: jb.STDCBlock(C), lambda: b.STDCBlock(C, C), cv._stdc, C, None, True),
    "STDCBlock_skip": (lambda: jb.STDCBlock(48), lambda: b.STDCBlock(C, 48), cv._stdc, C,
                       None, True),
    "DecoderBlock": (lambda: jb.DecoderBlock(24), lambda: b.DecoderBlock(C + 8, 24),
                     cv._decoder_block, C, 8, True),
    "ChannelAttention": (lambda: jb.ChannelAttention(4), lambda: b.ChannelAttention(C, 4),
                         cv._channel_attention, C, None, False),
    "SpatialAttention": (lambda: jb.SpatialAttention(), lambda: b.SpatialAttention(),
                         _only_conv(("conv",)), C, None, False),
    "CBAM": (lambda: jb.CBAM(), lambda: b.CBAM(32), cv._cbam, 32, None, False),
    "LightweightSpatialAttention": (lambda: jb.LightweightSpatialAttention(),
                                    lambda: b.LightweightSpatialAttention(),
                                    _only_conv(("attn", "conv")), C, None, False),
    "CRFSAttention": (lambda: jb.CRFSAttention(), lambda: b.CRFSAttention(32), cv._crfs, 32,
                      None, False),
    "EfficientAttention": (lambda: jb.EfficientAttention(), lambda: b.EfficientAttention(48),
                           lambda p, s, sd, k: cv._channel_attention(p["mlp"], s, sd, k), 48,
                           None, False),
    "EfficientDecoderBlock": (lambda: jb.EfficientDecoderBlock(24),
                              lambda: b.EfficientDecoderBlock(C + 8, 24),
                              cv._efficient_decoder, C, 8, True),
    "EfficientDecoderBlock_noskip": (lambda: jb.EfficientDecoderBlock(24),
                                     lambda: b.EfficientDecoderBlock(C, 24),
                                     cv._efficient_decoder, C, 0, True),
    "EdgeEnhancementBlock": (lambda: jb.EdgeEnhancementBlock(24),
                             lambda: b.EdgeEnhancementBlock(C, 24),
                             cv._edge, C, None, True),
    "OptimizedMultiScaleBlock": (lambda: jb.OptimizedMultiScaleBlock(32),
                                 lambda: b.OptimizedMultiScaleBlock(C, 32), cv._multiscale, C,
                                 None, True),
    "FeatureFusion": (lambda: jb.FeatureFusion(24), lambda: b.FeatureFusion(C + 8, 24),
                      cv._fusion, C, 8, False),
}
WITH_BN = [k for k, v in CASES.items() if v[5] and k != "RepVGGBlock_deploy"]


def _inputs(cin, cskip, dtype):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 8, 12, cin)) + 0.3).astype(dtype)
    skip = None if not cskip else (rng.standard_normal((2, 8, 12, cskip)) + 0.3).astype(dtype)
    return x, skip


def _jax_args(x, skip, cskip, train, with_train):
    args = [x] if cskip is None else [x, skip]
    return (*args, train) if with_train else tuple(args)


def _setup(name, dtype):
    """(flax module, its variables, port module loaded with them, flax
    args builder, port call)."""
    jfac, pfac, bridge, cin, cskip, with_train = CASES[name]
    x, skip = _inputs(cin, cskip, np.float32)
    jmod = jfac()
    jv = to_numpy(jmod.init(jax.random.PRNGKey(0), *_jax_args(x, skip, cskip, False,
                                                              with_train)))
    if "batch_stats" in jv:
        randomize_batch_norm(jv, seed=8)
    randomize_dense_biases(jv["params"], np.random.default_rng(9))
    sd = {}
    bridge(jv["params"], jv.get("batch_stats", {}), sd, "m")
    mod = pfac()
    mod.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return jmod, jv, mod.to(dtype), bridge


def _port_call(mod, x, skip, cskip, train, with_train):
    args = [torch.from_numpy(x)]
    if cskip is not None:
        args.append(None if skip is None else torch.from_numpy(skip))
    if with_train:
        return mod(*args, train=train)
    return mod(*args)


@pytest.mark.parametrize("name", list(CASES))
def test_block_eval_matches_flax(name):
    """Float32, batch norm on the running statistics: within 1e-5 of
    max|flax| (the same ops summed in another order)."""
    _, _, _, cin, cskip, with_train = CASES[name]
    jmod, jv, mod, _ = _setup(name, torch.float32)
    x, skip = _inputs(cin, cskip, np.float32)
    ref = np.asarray(jmod.apply(jv, *_jax_args(x, skip, cskip, False, with_train)))
    with torch.no_grad():
        out = _port_call(mod.eval(), x, skip, cskip, False, with_train).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", WITH_BN)
def test_block_train_mode_matches_flax_float64(name):
    """Float64, batch norm on the batch statistics (flax's
    ``mutable=["batch_stats"]`` under ``enable_x64``): the output and every
    updated running mean / var within 1e-10 of flax's."""
    _, _, bridge, cin, cskip, with_train = CASES[name]
    jmod, jv, mod, _ = _setup(name, torch.float64)
    x, skip = _inputs(cin, cskip, np.float64)
    with enable_x64(True):
        jv64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jv)
        ref, mut = jmod.apply(jv64, *_jax_args(x, skip, cskip, True, with_train),
                              mutable=["batch_stats"])
        ref = np.asarray(ref)
        new_stats = jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
    assert ref.dtype == np.float64
    with torch.no_grad():
        out = _port_call(mod, x, skip, cskip, True, with_train).numpy()
    assert out.dtype == np.float64
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10 * np.abs(ref).max())
    sd = {}
    bridge(jv["params"], {k: v for k, v in new_stats.items()}, sd, "m")
    got = mod.state_dict()
    running = [k for k in sd if "running" in k]
    assert running
    for k in running:
        want = np.asarray(sd[k], np.float64)
        err = np.abs(got[k[2:]].numpy() - want).max() / max(np.abs(want).max(), 1e-30)
        # the bridge rounds flax's float64 statistics to float32
        assert err <= 1e-7, (k, err)


@pytest.mark.parametrize("shape,size", [((2, 4, 6, 3), (16, 24)), ((1, 7, 5, 2), (3, 11)),
                                        ((5, 9, 4), (20, 4))])
def test_resize_nearest_matches_jax(shape, size):
    """torch's nearest index rule, as JAX's 0/1 selection matmul: equal in
    float32, and exact in bfloat16 (a selection rounds nothing)."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jresize.resize_nearest(jnp.asarray(x), size))
    out = resize_nearest(torch.from_numpy(x), size)
    np.testing.assert_array_equal(out.numpy(), ref)
    xb = torch.from_numpy(x).bfloat16()
    assert torch.equal(resize_nearest(xb, size), out.bfloat16())
    if len(shape) == 4:
        nchw = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size)
        assert torch.equal(out, nchw.permute(0, 2, 3, 1))
