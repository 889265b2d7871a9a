"""The port's CUDA kernels against their plain versions on the card, at
small shapes.  Marked ``gpu``: they skip where there is no CUDA device (the
decision is made inside the fixture, so every worker collects the same
tests).  On a machine with a card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

This file imports only torch and the port.
"""
import pytest
import _torch_threads  # noqa: F401  (one PyTorch thread a process)
import torch

# conv outputs in bf16 with f32 sums in another order than cuDNN's
CONV_REL_TOL = 2e-2
# a block backward's float32 weight and bias gradients against the plain
# version's at a single 8x16 tile (128 pixels; 1e-3 from 1024 pixels): few
# products average the bf16 rounding of the activation gradients out there,
# and the plain version itself reads 2.6e-3 / 3.0e-3 against the float64
# chain at conv 0 of blocks 3 / 4 (test_block_bwd_single_tile_float64 on an
# H100), the kernel the same; the bound stays under that
SINGLE_TILE_WGRAD_REL_TOL = 2.5e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _act(gen, *shape):
    return torch.relu(torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16)


def _conv(gen, f, c):
    w = torch.randn((f, c, 3, 3), generator=gen, device="cuda") / (9 * c) ** 0.5
    return w.to(torch.bfloat16), (0.1 * torch.randn(f, generator=gen, device="cuda")).to(torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 32, 48), (2, 24, 48)])
def test_stem_kernel(cuda, shape):
    """The stem's forward on the Hopper kernels from a uint8 image: conv1_1's
    image GEMM, then conv1_2 with the pool at the tile rule's pixels (256
    at H = 32, 128 at H = 24); one launch, within CONV_REL_TOL of the plain
    version, bit-identical on a second launch."""
    from tpu_unet_torch.kernels import launch_counts, sm90
    from tpu_unet_torch.kernels.stem import stem_plan, vgg_stem, vgg_stem_plain

    B, H, W = shape
    img = torch.randint(0, 256, (B, H, W, 3), generator=cuda, device="cuda",
                        dtype=torch.uint8)
    w11, b11 = _conv(cuda, 64, 3)
    w12, b12 = _conv(cuda, 64, 64)
    plan = stem_plan(B, H, W, 64)
    assert plan[:, 0].tolist() == [sm90.OP_FWD_IMAGE, sm90.OP_FWD_POOL]
    assert plan[1, 6] == (128 if H % 16 else 256)
    n = launch_counts["vgg_stem"]
    out = vgg_stem(img, w11, b11, w12, b12)
    assert launch_counts["vgg_stem"] == n + 1
    ref = vgg_stem_plain(img, w11, b11, w12, b12)
    for o, r in zip(out, ref):
        assert _rel(o, r) <= CONV_REL_TOL
    assert all(torch.equal(a, b) for a, b in zip(out, vgg_stem(img, w11, b11, w12, b12)))


@pytest.mark.gpu
@pytest.mark.parametrize("u8", [True, False])
def test_stem_single_tile_float64(cuda, u8):
    """At one 8x16 tile (uint8, and bf16 as the normalize kernel gives it):
    the kernel's a1 within one bf16 ulp of the largest value of the float64
    conv1_1 over the same bf16 image values (a uint8 image normalised as
    bf16(bf16(u8) / bf16(255))), its skip within one ulp of the float64
    conv1_2 over its own a1, its pooled the 2x2 max of its skip; prints the
    kernel's and the plain version's readings (pytest -s)."""
    import torch.nn.functional as F

    from chip_smoke import SINGLE_TILE_STORE_REL_TOL
    from tpu_unet_torch.core.precision import normalize_u8
    from tpu_unet_torch.kernels._plain import conv3x3_relu, max_pool2x2
    from tpu_unet_torch.kernels.stem import _vgg_stem_cuda

    img = torch.randint(0, 256, (1, 8, 16, 3), generator=cuda, device="cuda", dtype=torch.uint8)
    x = img if u8 else normalize_u8(img, torch.bfloat16)
    xb = normalize_u8(img, torch.bfloat16)
    w11, b11 = _conv(cuda, 64, 3)
    w12, b12 = _conv(cuda, 64, 64)
    skip, pooled, a1 = _vgg_stem_cuda(x, w11, b11, w12, b12)
    pa1 = conv3x3_relu(xb, w11, b11)
    pskip = conv3x3_relu(pa1, w12, b12)

    def conv64(v, w, b):
        y = F.conv2d(v.permute(0, 3, 1, 2).double(), w.double(), b.double(), padding=1)
        return torch.relu(y).permute(0, 2, 3, 1)

    readings = {"a1": {"kernel_vs_float64": _rel(a1, conv64(xb, w11, b11)),
                       "plain_vs_float64": _rel(pa1, conv64(xb, w11, b11))},
                "skip": {"kernel_vs_float64": _rel(skip, conv64(a1, w12, b12)),
                         "plain_vs_float64": _rel(pskip, conv64(pa1, w12, b12))}}
    print(u8, readings)
    for name, r in readings.items():
        assert r["kernel_vs_float64"] <= SINGLE_TILE_STORE_REL_TOL, name
    assert torch.equal(pooled, max_pool2x2(skip))


@pytest.mark.gpu
def test_stem_kernel_bf16_input(cuda):
    """The single-image forward's input: the normalize kernel's bf16 output
    (conv1_1's gather of a bf16 image)."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.preprocess import normalize_images
    from tpu_unet_torch.kernels.stem import vgg_stem, vgg_stem_plain

    img = torch.randint(0, 256, (1, 32, 48, 3), generator=cuda, device="cuda",
                        dtype=torch.uint8)
    x = normalize_images(img, torch.bfloat16)
    w11, b11 = _conv(cuda, 64, 3)
    w12, b12 = _conv(cuda, 64, 64)
    n = launch_counts["vgg_stem"]
    out = vgg_stem(x, w11, b11, w12, b12)
    assert launch_counts["vgg_stem"] == n + 1
    ref = vgg_stem_plain(x, w11, b11, w12, b12)
    for o, r in zip(out, ref):
        assert _rel(o, r) <= CONV_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("chans,pool,bhw", [
    # every conv runs on the Hopper core (csrc/conv3x3_sm90.cuh): block 2's
    # widths at H % 16 == 0 and != 0 and at one tile, two convs from input
    # width 32; blocks 3-5's widths, the smallest tile, H != W, input width
    # 32 (the forward's rule takes % 32) and F = 64 (the core's narrow
    # instantiation)
    ([64, 128, 128], True, (2, 16, 32)),
    ([64, 128, 128], True, (2, 24, 32)),
    ([64, 128, 128], False, (1, 8, 16)),
    ([32, 64, 64], True, (2, 8, 48)),
    ([128, 256, 256, 256], False, (2, 16, 32)),
    ([128, 256, 256, 256], True, (2, 16, 32)),
    ([256, 512, 512, 512], True, (2, 16, 32)),
    ([512, 512, 512, 512], False, (2, 16, 32)),
    ([256, 512, 512, 512], True, (1, 8, 16)),
    ([128, 256, 256, 256], True, (1, 24, 48)),
    ([32, 64, 128, 128], True, (2, 16, 32)),
    ([64, 64, 64, 64], True, (1, 16, 16))])
def test_block_kernel(cuda, chans, pool, bhw):
    """The block kernel within CONV_REL_TOL of the plain chain (skip and
    pooled), bit-identical on a second launch."""
    from tpu_unet_torch.kernels.encoder import vgg_block, vgg_block_plain

    x = _act(cuda, *bhw, chans[0])
    wb = [_conv(cuda, f, c) for c, f in zip(chans[:-1], chans[1:])]
    ws, bs = [w for w, _ in wb], [b for _, b in wb]
    out, ref = vgg_block(x, ws, bs, pool), vgg_block_plain(x, ws, bs, pool)
    again = vgg_block(x, ws, bs, pool)
    assert _rel(out[0], ref[0]) <= CONV_REL_TOL
    assert torch.equal(out[0], again[0])
    assert (out[1] is None) == (not pool)
    if pool:
        assert _rel(out[1], ref[1]) <= CONV_REL_TOL
        assert torch.equal(out[1], again[1])


@pytest.mark.gpu
@pytest.mark.parametrize("h,cs,cx,f", [(8, 64, 128, 64), (4, 256, 512, 128),
                                       # unet_resnet50's up4 widths
                                       (4, 1024, 2048, 512)])
def test_unetup_kernel(cuda, h, cs, cx, f):
    from tpu_unet_torch.kernels.decoder_fuse import unetup, unetup_plain

    skip, x = _act(cuda, 2, 2 * h, 4 * h, cs), _act(cuda, 2, h, 2 * h, cx)
    w1, b1 = _conv(cuda, f, cs + cx)
    w2, b2 = _conv(cuda, f, f)
    out = unetup(skip, x, w1, b1, w2, b2)
    assert _rel(out, unetup_plain(skip, x, w1, b1, w2, b2)) <= CONV_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 8, 16, 128), (1, 5, 7, 64), (2, 16, 16, 512),
                                   (1, 4, 4, 2048)])
def test_upsample2x_kernel_bit_exact(cuda, shape):
    """The stage's upsample pass: one launch, bit-equal to the plain bf16
    upsample."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.decoder_train import up2x
    from tpu_unet_torch.nn.resize import upsample2x

    x = torch.randn(shape, generator=cuda, device="cuda").to(torch.bfloat16)
    n = launch_counts["upsample2x"]
    up = up2x(x)
    assert launch_counts["upsample2x"] == n + 1
    assert torch.equal(up, upsample2x(x))


@pytest.mark.gpu
@pytest.mark.parametrize("h,cs,cx,f", [(8, 64, 128, 64), (4, 1024, 2048, 512),
                                       (8, 32, 96, 64), (12, 64, 128, 64)])
def test_unetup_stage_on_hopper_core(cuda, h, cs, cx, f):
    """#1 launches the upsample kernel and the two Hopper convs (one count
    each of ``upsample2x`` and ``unetup``), within CONV_REL_TOL of the plain
    version and bit-identical on a second launch; at F = 64 the plan's
    256-pixel conv tile (2H = 16) and its 128-pixel tile (2H = 24, not a
    multiple of 16); ``unetup_wgrad`` within 1e-4 of its plain version,
    bit-identical run to run, one more upsample."""
    from tpu_unet_torch.kernels import launch_counts, sm90
    from tpu_unet_torch.kernels.decoder_fuse import _unetup_cuda, _unetup_plain_y1
    from tpu_unet_torch.kernels.decoder_train import unetup_wgrad, unetup_wgrad_plain

    skip, x = _act(cuda, 2, 2 * h, 4 * h, cs), _act(cuda, 2, h, 2 * h, cx)
    w1, b1 = _conv(cuda, f, cs + cx)
    w2, b2 = _conv(cuda, f, f)
    n = {k: launch_counts[k] for k in ("unetup", "upsample2x")}
    out, y1 = _unetup_cuda(skip, x, w1, b1, w2, b2, want_y1=True)
    assert all(launch_counts[k] == v + 1 for k, v in n.items())
    ref, ry1 = _unetup_plain_y1(skip, x, w1, b1, w2, b2)
    assert _rel(out, ref) <= CONV_REL_TOL and _rel(y1, ry1) <= CONV_REL_TOL
    assert torch.equal(out, _unetup_cuda(skip, x, w1, b1, w2, b2))
    assert sm90.conv_tile_m(2 * h, f) == (256 if f <= 128 and h % 8 == 0 else 128)
    if (cs + cx) % 64:
        return
    dz1 = _act(cuda, 2, 2 * h, 4 * h, f)
    g2 = torch.randn((2, 2 * h, 4 * h, f), generator=cuda, device="cuda").to(torch.bfloat16)
    n = launch_counts["upsample2x"]
    res = unetup_wgrad(skip, x, dz1, y1, g2)
    assert launch_counts["upsample2x"] == n + 1
    assert all(torch.equal(a, b) for a, b in zip(res, unetup_wgrad(skip, x, dz1, y1, g2)))
    for a, b in zip(res, unetup_wgrad_plain(skip, x, dz1, y1, g2)):
        assert _rel(a, b) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("cs,cx,f", [(64, 128, 64), (1024, 2048, 512)])
def test_stage_single_tile_float64(cuda, cs, cx, f):
    """At one 8x16 tile, conv1's y1 and #13's dz1 and [dskip | dups] within
    one bf16 ulp of the largest value of the float64 conv on the same bf16
    operands (each dgrad from its own bf16 input), g2 equal to the plain
    version's, and dk1 within float32's sums over 128 pixels of the float64
    weight gradient: the witness and limits of ``chip_smoke.py``; prints
    the kernel's and the plain version's readings (pytest -s)."""
    from chip_smoke import (SINGLE_TILE_DK_REL_TOL, SINGLE_TILE_STORE_REL_TOL,
                            stage_single_tile_readings)

    readings = stage_single_tile_readings(cuda, cs, cx, f)
    print((cs, cx, f), readings)
    for name in ("y1", "dz1", "dskip_dups"):
        assert readings[name]["kernel_vs_float64"] <= SINGLE_TILE_STORE_REL_TOL, name
    assert readings["g2_equal"]
    assert readings["dk1"]["kernel_vs_float64"] <= SINGLE_TILE_DK_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(8, 8), (4, 16)])
def test_upconv_kernel(cuda, h, w):
    """The head's forward (#10) on the Hopper conv core: the plan's two
    convs at the tile rule's pixels (256 where 2H % 16 == 0, else 128) × 64
    channels, conv1 over the one map up; one ``upconv`` and one
    ``upsample2x`` launch a call; within CONV_REL_TOL of the plain version
    and bit-identical on a second launch."""
    from tpu_unet_torch.kernels import launch_counts, sm90
    from tpu_unet_torch.kernels.decoder_fuse import stage_plan
    from tpu_unet_torch.kernels.upconv import upconv, upconv_plain

    x = _act(cuda, 2, h, w, 64)
    w1, b1 = _conv(cuda, 64, 64)
    w2, b2 = _conv(cuda, 64, 64)
    plan = stage_plan(2, 2 * h, 2 * w, 0, 64, 64)
    tm = 256 if (2 * h) % 16 == 0 else 128
    assert plan[:, 0].tolist() == [sm90.OP_FWD] * 2
    assert plan[:, 1].tolist() == [64, 64] and plan[:, 6].tolist() == [tm, tm]
    assert plan[:, sm90.HEAD_WORDS + 2 * sm90.MAP_WORDS:].abs().sum() == 0  # one input map
    n = {k: launch_counts[k] for k in ("upconv", "upsample2x")}
    out = upconv(x, w1, b1, w2, b2)
    assert {k: launch_counts[k] - v for k, v in n.items()} == {"upconv": 1, "upsample2x": 1}
    assert out.shape == (2, 2 * h, 2 * w, 64)
    assert _rel(out, upconv_plain(x, w1, b1, w2, b2)) <= CONV_REL_TOL
    assert torch.equal(out, upconv(x, w1, b1, w2, b2))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,cx,f", [(2, 8, 8, 64, 64), (1, 4, 16, 64, 64),
                                         (1, 8, 8, 64, 128), (1, 8, 8, 96, 64)])
def test_upconv_f32_halo_kernel(cuda, b, h, w, cx, f):
    """The float32 head's four convs on the halo mainloop at the tile's
    two heights (256 pixels where 2H % 16 == 0, else 128), two channel
    tiles a patch (F = 128) and three slices (Cx = 96, the forward only:
    the backward takes Cx % 64): every conv record names the halo
    mainloop; #10 within ``tf32.CONV_REL_TOL`` of the plain float32 head
    and bit-identical on a second launch; #12's dx within CONV_REL_TOL and
    its weight and bias gradients within WGRAD_CHAIN_REL_TOL of
    ``upconv_bwd_plain``, bit-identical on a second launch."""
    from tpu_unet_torch.kernels import sm90, tf32
    from tpu_unet_torch.kernels.decoder_fuse import stage_plan
    from tpu_unet_torch.kernels.upconv import (_upconv_cuda, _upconv_plain_y1, bwd_plan,
                                               upconv_bwd, upconv_bwd_plain)

    x = torch.relu(torch.randn((b, h, w, cx), generator=cuda, device="cuda"))
    w1, w2 = (torch.randn((f, c, 3, 3), generator=cuda, device="cuda") / (9 * c) ** 0.5
              for c in (cx, f))
    b1, b2 = (0.1 * torch.randn(f, generator=cuda, device="cuda") for _ in range(2))
    assert stage_plan(b, 2 * h, 2 * w, 0, cx, f, True)[:, 9].tolist() == [sm90.MAINLOOP_HALO] * 2
    out, y1 = _upconv_cuda(x, w1, b1, w2, b2, want_y1=True)
    pout, py1 = _upconv_plain_y1(x, w1, b1, w2, b2)
    assert _rel(y1, py1) <= tf32.CONV_REL_TOL and _rel(out, pout) <= tf32.CONV_REL_TOL
    assert torch.equal(out, _upconv_cuda(x, w1, b1, w2, b2))
    if cx % 64:
        return
    assert bwd_plan(b, 2 * h, 2 * w, cx, f, True)[0][:2, 9].tolist() == [sm90.MAINLOOP_HALO] * 2
    g = torch.randn(out.shape, generator=cuda, device="cuda")
    res = upconv_bwd(g, out, y1, x, w1, w2)
    ref = upconv_bwd_plain(g, out, y1, x, w1, w2)
    for i, (a, r) in enumerate(zip(res, ref)):
        assert _rel(a, r) <= (tf32.CONV_REL_TOL if i == 0 else tf32.WGRAD_CHAIN_REL_TOL), i
    assert all(torch.equal(a, z) for a, z in zip(res, upconv_bwd(g, out, y1, x, w1, w2)))


@pytest.mark.gpu
def test_tail_kernel(cuda):
    from tpu_unet_torch.kernels.postprocess import (final_argmax_hist,
                                                    final_argmax_hist_plain)

    feats = _act(cuda, 2, 32, 32, 64)
    w = (torch.randn((21, 64, 1, 1), generator=cuda, device="cuda") / 8).to(torch.bfloat16)
    b = torch.zeros(21, device="cuda", dtype=torch.bfloat16)
    masks, hist = final_argmax_hist(feats, w, b, 21)
    pm, _ = final_argmax_hist_plain(feats, w, b, 21)
    # f32 dot products in another order: flips only at near-ties
    assert (masks != pm).float().mean().item() < 1e-3
    own = torch.stack([torch.bincount(m.flatten().long(), minlength=21) for m in masks])
    assert torch.equal(own.to(torch.int32), hist)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [22, 32, 64])
def test_natural_tail_kernel(cuda, f):
    """The tail at the TraditionalUnet widths (and the canonical 64):
    masks as plain up to near-ties, hist = bincount of its own masks."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.postprocess import (final_argmax_hist,
                                                    final_argmax_hist_plain)

    feats = _act(cuda, 3, 32, 64, f)
    w = (torch.randn((4, f, 1, 1), generator=cuda, device="cuda") / 4).to(torch.bfloat16)
    b = (0.1 * torch.randn(4, generator=cuda, device="cuda")).to(torch.bfloat16)
    n = launch_counts["final_argmax_hist"]
    masks, hist = final_argmax_hist(feats, w, b, 4)
    assert launch_counts["final_argmax_hist"] == n + 1
    pm, _ = final_argmax_hist_plain(feats, w, b, 4)
    assert (masks != pm).float().mean().item() < 1e-3
    own = torch.stack([torch.bincount(m.flatten().long(), minlength=4) for m in masks])
    assert torch.equal(own.to(torch.int32), hist)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 25, 25, 32), (1, 7, 13, 22), (3, 20, 30, 64)])
def test_mask_only_tail_kernel(cuda, shape):
    """Any pixel count: the last block's ragged edge is masked."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.postprocess import final_argmax, final_argmax_plain

    f = shape[-1]
    feats = _act(cuda, *shape)
    w = (torch.randn((4, f, 1, 1), generator=cuda, device="cuda") / 4).to(torch.bfloat16)
    b = torch.zeros(4, device="cuda", dtype=torch.bfloat16)
    n = launch_counts["final_argmax"]
    masks = final_argmax(feats, w, b, 4)
    assert launch_counts["final_argmax"] == n + 1
    assert masks.shape == shape[:3] and masks.dtype == torch.uint8
    assert (masks != final_argmax_plain(feats, w, b, 4)).float().mean().item() < 1e-3


def _tail64(gen, n, h, w, c):
    feats = _act(gen, n, h, w, 64)
    wt = (torch.randn((c, 64, 1, 1), generator=gen, device="cuda") / 8).to(torch.bfloat16)
    b = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
    return feats, wt, b


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 4, 21, 32])
@pytest.mark.parametrize("hist", [True, False])
def test_tail64_kernel(cuda, c, hist):
    """The F = 64 tail on wgmma (csrc/tail_sm90.cu) at 3 images of 128 x
    128 (384 tiles over 132 blocks: ranges that cross images): masks as
    plain up to near-ties, hist = bincount of its own masks, bit-identical
    on relaunch, one launch."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.postprocess import (final_argmax, final_argmax_hist,
                                                    final_argmax_hist_plain, final_argmax_plain)

    feats, w, b = _tail64(cuda, 3, 128, 128, c)
    key, fn = ("final_argmax_hist", final_argmax_hist) if hist else ("final_argmax", final_argmax)
    n = launch_counts[key]
    out = fn(feats, w, b, c)
    assert launch_counts[key] == n + 1
    again = fn(feats, w, b, c)
    masks = out[0] if hist else out
    pm = final_argmax_hist_plain(feats, w, b, c)[0] if hist else final_argmax_plain(feats, w, b, c)
    assert masks.shape == (3, 128, 128) and masks.dtype == torch.uint8
    assert (masks != pm).float().mean().item() < 1e-3
    if hist:
        own = torch.stack([torch.bincount(m.flatten().long(), minlength=c) for m in masks])
        assert torch.equal(own.to(torch.int32), out[1])
        assert all(torch.equal(a, b) for a, b in zip(out, again))
    else:
        assert torch.equal(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("hist", [True, False])
def test_tail64_ties_go_to_the_lower_class(cuda, hist):
    """Classes 2 and 5 (and 9 and 10) share their weights and bias: their
    logits tie exactly, and the lower class wins, as torch.argmax keeps
    the first maximum.  The masks equal those with classes 5 and 10 given
    a -inf bias (which never win), and class 2 wins most pixels."""
    from tpu_unet_torch.kernels.postprocess import (final_argmax, final_argmax_hist,
                                                    final_argmax_plain)

    c = 12
    feats, w, b = _tail64(cuda, 2, 32, 32, c)
    w[5], w[10] = w[2], w[9]
    b[2] = b[5] = 3.0
    b[10] = b[9]
    fn = final_argmax_hist if hist else final_argmax
    out = fn(feats, w, b, c)
    masks = out[0] if hist else out
    b_out = b.clone()
    b_out[5] = b_out[10] = float("-inf")
    without = fn(feats, w, b_out, c)
    assert torch.equal(masks, without[0] if hist else without)
    assert (masks == 2).float().mean().item() > 0.5
    assert (masks != final_argmax_plain(feats, w, b_out, c)).float().mean().item() < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("shape,c", [((3, 20, 30), 4), ((1, 7, 13), 21), ((2, 25, 25), 32),
                                     ((1, 1, 1), 1), ((5, 16, 16), 21)])
def test_tail64_mask_only_ragged(cuda, shape, c):
    """The F = 64 mask-only tail at pixel counts that leave a ragged last
    tile (and at one pixel): masks as plain up to near-ties, bit-identical
    on relaunch."""
    from tpu_unet_torch.kernels.postprocess import final_argmax, final_argmax_plain

    feats, w, b = _tail64(cuda, *shape, c)
    masks = final_argmax(feats, w, b, c)
    assert masks.shape == shape and int(masks.max()) < c
    assert (masks != final_argmax_plain(feats, w, b, c)).float().mean().item() < 1e-3
    assert torch.equal(masks, final_argmax(feats, w, b, c))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1, 5, 8), (2, 3, 5, 16), (2, 4, 8, 8), (1, 3, 8, 24),
                                   (1, 5, 33, 8), (1, 70, 9, 8), (2, 17, 40, 64),
                                   (1, 16, 16, 2048), (2, 3, 8, 2048)])
def test_adjoint_kernel_odd_sizes(cuda, shape):
    """The streamed adjoint at odd sizes and C = 2048: within one bf16 ulp
    (1e-2) of the plain version, bit-identical on relaunch, one launch, its
    plan the host's."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.decoder_train import (adjoint_plan, adjoint_plan_on_card,
                                                      upsample2x_adjoint,
                                                      upsample2x_adjoint_plain)

    B, h, w, c = shape
    dup = torch.randn((B, 2 * h, 2 * w, c), generator=cuda, device="cuda").to(torch.bfloat16)
    n = launch_counts["upsample_adjoint"]
    dx = upsample2x_adjoint(dup, h, w)
    assert launch_counts["upsample_adjoint"] == n + 1
    assert dx.shape == (B, h, w, c) and dx.dtype == torch.bfloat16
    assert torch.equal(dx, upsample2x_adjoint(dup, h, w))
    assert _rel(dx, upsample2x_adjoint_plain(dup, h, w)) <= 1e-2
    assert adjoint_plan_on_card(B, h, w, c) == adjoint_plan(B, h, w, c)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 256, 256, 3), (2, 17, 9, 3)])
def test_normalize_kernel_bit_exact(cuda, shape, dtype):
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.preprocess import (normalize_images,
                                                   normalize_images_plain)

    img = torch.randint(0, 256, shape, generator=cuda, device="cuda", dtype=torch.uint8)
    n = launch_counts["normalize_images"]
    out = normalize_images(img, dtype)
    assert launch_counts["normalize_images"] == n + 1
    assert torch.equal(out, normalize_images_plain(img, dtype))
    # a view that is not 16-byte aligned takes the one-at-a-time path
    flat = img.reshape(-1)[1:]
    assert torch.equal(normalize_images(flat, dtype), normalize_images_plain(flat, dtype))


@pytest.mark.gpu
def test_normalize_kernel_runs_on_current_stream(cuda):
    """Launched inside ``torch.cuda.stream(s)`` the kernel runs on s: it
    reads the images that s copies in after a long sleep (on another stream
    it would read them before the copy)."""
    from tpu_unet_torch.kernels.preprocess import normalize_images, normalize_images_plain

    img = torch.zeros((1, 256, 256, 3), device="cuda", dtype=torch.uint8)
    new = torch.randint(1, 256, img.shape, generator=cuda, device="cuda", dtype=torch.uint8)
    s = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(s):
        torch.cuda._sleep(50_000_000)
        img.copy_(new)
        out = normalize_images(img, torch.bfloat16)
    s.synchronize()
    assert torch.equal(out, normalize_images_plain(new, torch.bfloat16))


@pytest.mark.gpu
def test_normalize_kernel_refuses_on_card(cuda):
    """On the card too every refused input raises and launches nothing."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.preprocess import normalize_images

    n = launch_counts["normalize_images"]
    img = torch.zeros((1, 8, 8, 6), device="cuda", dtype=torch.uint8)
    with pytest.raises(ValueError, match="contiguous"):
        normalize_images(img[..., ::2], torch.bfloat16)
    with pytest.raises(ValueError, match="normalize_images kernel"):
        normalize_images(img.float(), torch.bfloat16)
    with pytest.raises(ValueError, match="normalize_images kernel"):
        normalize_images(img, torch.float16)
    with pytest.raises(RuntimeError, match="no backward"):
        normalize_images(img.float().requires_grad_(), torch.float32)
    assert launch_counts["normalize_images"] == n


# the natural tails' masks must equal the plain version's wherever the
# plain top-1 / top-2 gap exceeds this share of the logit scale (float32
# sums in another order; chip_smoke.py's TAIL_MARGIN)
TAIL_MARGIN = 1e-3


def _natural(gen, shape, f, c):
    feats = _act(gen, *shape, f)
    w = (torch.randn((c, f, 1, 1), generator=gen, device="cuda") / f ** 0.5).to(torch.bfloat16)
    b = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
    return feats, w, b


def _flips_outside_margin(masks, feats, w, b, c):
    """Pixels where the kernel's mask differs from the plain version's
    though the plain top-1 / top-2 gap exceeds TAIL_MARGIN of the scale."""
    from tpu_unet_torch.kernels.postprocess import final_argmax_plain

    f = feats.shape[-1]
    logits = feats.reshape(-1, f).float() @ w.reshape(c, f).float().t() + b.float()
    differ = (masks != final_argmax_plain(feats, w, b, c)).reshape(-1)
    if c == 1:
        return int(differ.sum())
    top2 = logits.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    return int((differ & (gap > TAIL_MARGIN * logits.abs().max())).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("f", [22, 32])
@pytest.mark.parametrize("c", [1, 4, 21, 32])
@pytest.mark.parametrize("hist", [True, False])
def test_natural_tail_on_wgmma(cuda, f, c, hist):
    """The F = 22 / 32 tails on the Hopper tail kernel at 5 images of
    128 x 128 (320 tiles of 256 pixels over 132 blocks: ranges that cross
    images): one launch, masks as the plain version's outside the margin,
    the histogram the bincount of the kernel's own masks, bit-identical on
    relaunch."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.postprocess import final_argmax, final_argmax_hist

    feats, w, b = _natural(cuda, (5, 128, 128), f, c)
    key, fn = ("final_argmax_hist", final_argmax_hist) if hist else ("final_argmax", final_argmax)
    n = launch_counts[key]
    out = fn(feats, w, b, c)
    assert launch_counts[key] == n + 1
    again = fn(feats, w, b, c)
    masks = out[0] if hist else out
    assert masks.shape == (5, 128, 128) and masks.dtype == torch.uint8 and int(masks.max()) < c
    assert _flips_outside_margin(masks, feats, w, b, c) == 0
    if hist:
        own = torch.stack([torch.bincount(m.flatten().long(), minlength=c) for m in masks])
        assert torch.equal(own.to(torch.int32), out[1])
        assert all(torch.equal(x, y) for x, y in zip(out, again))
    else:
        assert torch.equal(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [22, 32])
@pytest.mark.parametrize("shape,c", [((32, 25, 25), 4), ((2, 25, 25), 21), ((1, 7, 13), 32),
                                     ((1, 1, 1), 1), ((3, 20, 30), 4), ((1, 3, 5), 21),
                                     ((32, 200, 200), 4)])
def test_natural_tail_mask_only_ragged(cuda, f, shape, c):
    """The F = 22 / 32 mask-only tail at pixel counts that leave a ragged
    last tile (at F = 22 one whose bytes are no multiple of 16: its rest is
    read in device memory): masks as plain outside the margin,
    bit-identical on relaunch."""
    from tpu_unet_torch.kernels.postprocess import final_argmax

    feats, w, b = _natural(cuda, shape, f, c)
    masks = final_argmax(feats, w, b, c)
    assert masks.shape == shape and int(masks.max()) < c
    assert _flips_outside_margin(masks, feats, w, b, c) == 0
    assert torch.equal(masks, final_argmax(feats, w, b, c))


@pytest.mark.gpu
@pytest.mark.parametrize("f", [22, 32])
@pytest.mark.parametrize("c", [1, 4, 21, 32])
def test_natural_tail_all_tied(cuda, f, c):
    """Every class with zero weights and one bias: every logit ties, and
    every pixel takes class 0 (the first maximum), in the mask and in the
    histogram."""
    from tpu_unet_torch.kernels.postprocess import final_argmax, final_argmax_hist

    feats = _act(cuda, 2, 32, 32, f)
    w = torch.zeros((c, f, 1, 1), device="cuda", dtype=torch.bfloat16)
    b = torch.full((c,), 0.5, device="cuda", dtype=torch.bfloat16)
    masks, hist = final_argmax_hist(feats, w, b, c)
    assert int(masks.max()) == 0 and int(final_argmax(feats, w, b, c).max()) == 0
    want = torch.zeros((2, c), dtype=torch.int32, device="cuda")
    want[:, 0] = 32 * 32
    assert torch.equal(hist, want)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [22, 32])
def test_natural_tail_shape_rule_on_the_card(cuda, f):
    """The shape rule raises on the card before any launch: H·W no
    multiple of 256 with the histogram, more than 32 classes."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.postprocess import final_argmax, final_argmax_hist

    counts = dict(launch_counts)
    feats, w, b = _natural(cuda, (1, 10, 10), f, 4)
    with pytest.raises(ValueError, match="H\\*W=100"):
        final_argmax_hist(feats, w, b, 4)
    feats, w, b = _natural(cuda, (1, 16, 16), f, 33)
    for tail in (final_argmax_hist, final_argmax):
        with pytest.raises(ValueError, match="classes=33"):
            tail(feats, w, b, 33)
    assert launch_counts == counts


@pytest.mark.gpu
def test_tail_rejects_untileable_shape(cuda):
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.postprocess import final_argmax, final_argmax_hist

    w = torch.zeros((4, 48, 1, 1), device="cuda", dtype=torch.bfloat16)
    b = torch.zeros(4, device="cuda", dtype=torch.bfloat16)
    feats = _act(cuda, 1, 16, 16, 48)    # F = 48 has no kernel: raises
    counts = dict(launch_counts)
    for tail in (final_argmax_hist, final_argmax):
        with pytest.raises(ValueError):
            tail(feats, w, b, 4)
    assert launch_counts == counts


@pytest.mark.gpu
def test_kernel_rejects_untileable_shape(cuda):
    from tpu_unet_torch.kernels.encoder import vgg_block

    x = _act(cuda, 1, 12, 16, 64)        # H % 8 != 0: raises, never falls back
    wb = [_conv(cuda, 128, 64), _conv(cuda, 128, 128)]
    with pytest.raises(ValueError):
        vgg_block(x, [w for w, _ in wb], [b for _, b in wb], True)


@pytest.mark.gpu
def test_upconv_rejects_untileable_shape(cuda):
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.upconv import upconv

    x = _act(cuda, 1, 8, 8, 48)          # Cx % 32 != 0: raises, never falls back
    w1, b1 = _conv(cuda, 64, 48)
    w2, b2 = _conv(cuda, 64, 64)
    n = launch_counts["upconv"]
    with pytest.raises(ValueError):
        upconv(x, w1, b1, w2, b2)
    assert launch_counts["upconv"] == n


def _tied_logits(gen, shape, dtype):
    """Small integers (most pixels tie) with a NaN in every 37th row."""
    x = torch.randint(-3, 4, shape, generator=gen, device="cuda").float()
    x.reshape(-1, shape[-1])[::37, shape[-1] // 2] = float("nan")
    return x.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.int32, torch.uint8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 32, 32, 4), (1, 17, 23, 21), (1, 5, 9, 32)])
def test_argmax_mask_kernel_exact(cuda, shape, dtype, out_dtype):
    """Ties to the first maximum, NaN as the maximum: equal to plain, also
    on a view whose rows are not 16-byte aligned (narrower loads)."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.postprocess import argmax_mask, argmax_mask_plain

    x = _tied_logits(cuda, shape, dtype)
    n = launch_counts["argmax_mask"]
    out = argmax_mask(x, out_dtype)
    assert launch_counts["argmax_mask"] == n + 1
    assert out.dtype == out_dtype and out.shape == shape[:3]
    assert torch.equal(out, argmax_mask_plain(x, out_dtype))
    c = shape[-1]
    view = x.reshape(-1)[1:1 + (x.numel() // c - 1) * c].reshape(1, 1, -1, c)
    assert torch.equal(argmax_mask(view, out_dtype), argmax_mask_plain(view, out_dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("mask_dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("alpha", [0.7, 0.123])
def test_mask_palette_kernel_exact(cuda, mask_dtype, alpha):
    """Bit-exact against plain (classes ≥ C black) and, for in-range
    classes, against the host render."""
    import numpy as np

    from tpu_unet_torch.infer.wrapper import VOC_COLORS
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.render import mask_palette, mask_palette_plain, palette_tensor
    from tpu_unet_torch.tools.predict import render

    pal = palette_tensor(VOC_COLORS, "cuda")
    mask = torch.randint(0, len(VOC_COLORS) + 3, (3, 40, 56), generator=cuda,
                         device="cuda").to(mask_dtype)
    img = torch.randint(0, 256, (3, 40, 56, 3), generator=cuda, device="cuda",
                        dtype=torch.uint8)
    n = launch_counts["mask_palette"]
    out = mask_palette(mask, img, pal, alpha)
    assert launch_counts["mask_palette"] == n + 1
    assert torch.equal(out, mask_palette_plain(mask, img, pal, alpha))
    small = (mask % 4).contiguous()
    out = mask_palette(small, img, pal, alpha).cpu().numpy()
    colors = np.asarray(VOC_COLORS, np.uint8)
    for i in range(3):
        assert np.array_equal(out[i], render(img[i].cpu().numpy(), small[i].cpu().numpy(),
                                             colors, alpha, (0, 0, 56, 40), (56, 40)))


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["ultralight_large_optimized", "lightweight"])
def test_generic_serving_step_on_card(cuda, model):
    """One serving step on the card (bf16) launches ``argmax_mask`` once;
    its masks against the CPU float32 path on the same seeded weights flip
    only where the CPU top-1/top-2 gap is under 5% of the logit scale, and
    in at most 2% of the pixels: with random weights about 1% of the
    ladder's pixels lie within 1% of the scale of a tie (0.95% flip at
    64×64 when the bf16 step is emulated on the CPU, largest gap 1.2%)."""
    from tpu_unet_torch.core.precision import normalize_u8
    from tpu_unet_torch.infer.wrapper import Unet
    from tpu_unet_torch.kernels import launch_counts, reset_launch_counts
    from tpu_unet_torch.nn.resize import resize_bilinear

    u = Unet(model=model, num_classes=4, input_shape=[64, 64])
    fn, net = u.serving_step()
    imgs = torch.randint(0, 256, (2, 64, 64, 3), generator=cuda, device="cuda",
                         dtype=torch.uint8)
    reset_launch_counts()
    masks, hist = fn(net, imgs)
    torch.cuda.synchronize()
    assert launch_counts["argmax_mask"] == 1 and sum(launch_counts.values()) == 1
    cpu = Unet(model=model, num_classes=4, input_shape=[64, 64], cuda=False)
    with torch.no_grad():
        logits = cpu.net(normalize_u8(imgs.cpu(), torch.float32))
        logits = resize_bilinear(logits, (64, 64), align_corners=True)
    top2 = logits.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    differ = masks.cpu().long() != logits.argmax(-1)
    share = differ.float().mean().item()
    worst = (gap[differ].max() / logits.abs().max()).item() if differ.any() else 0.0
    assert share <= 2e-2 and worst <= 5e-2, (share, worst)
    own = torch.stack([torch.bincount(m.flatten().long(), minlength=4) for m in masks])
    assert torch.equal(own.to(torch.int32), hist)


def _loss_case(gen, n, h, w, c, dtype):
    """Features, final conv, targets with ~5% ignore pixels and some raw
    255 labels, non-uniform class weights."""
    feats = torch.relu(torch.randn((n, h, w, 64), generator=gen, device="cuda")).to(dtype)
    # float32 weights holding feature-dtype values: dW and db come back in
    # float32, unrounded
    wt = (torch.randn((c, 64, 1, 1), generator=gen, device="cuda") / 8).to(dtype).float()
    b = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype).float()
    t = torch.randint(0, c, (n, h, w), generator=gen, device="cuda")
    r = torch.rand((n, h, w), generator=gen, device="cuda")
    t = torch.where(r < 0.03, torch.full_like(t, c), t)
    t = torch.where(r > 0.98, torch.full_like(t, 255), t)
    cw = tuple(1.0 + 0.1 * i for i in range(c))
    return feats, wt, b, t, cw


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_dice", [True, False])
@pytest.mark.parametrize("c", [21, 4, 1, 126])
@pytest.mark.parametrize("shape", [(2, 24, 40), (1, 9, 23)])
def test_final_loss_kernels(cuda, dtype, with_dice, c, shape):
    """#27 and #29 against their plain versions: loss within 1e-4
    relative, f_score within 1e-4, dW and db within 1e-3 of their largest
    entry, dfeat within CONV_REL_TOL; at every class padding (C = 1, 4,
    21, 126: 16, 16, 32, 128 columns) and at a pixel count no 128-pixel
    tile divides (207: the last tile's rows past n are TMA's zero fill);
    the float32 instantiations counted under their ``_f32`` keys."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels._build import count_key
    from tpu_unet_torch.kernels.loss import (final_ce_dice_bwd, final_ce_dice_bwd_plain,
                                             final_ce_dice_fwd, final_ce_dice_fwd_plain)

    feats, w, b, t, cw = _loss_case(cuda, *shape, c, dtype)
    kf, kb = count_key("final_ce_dice_fwd", dtype), count_key("final_ce_dice_bwd", dtype)
    n0, n1 = launch_counts[kf], launch_counts[kb]
    loss, fs, res = final_ce_dice_fwd(feats, w, b, t, cw, c, with_dice)
    ploss, pfs, pres = final_ce_dice_fwd_plain(feats, w, b, t, cw, c, with_dice)
    assert launch_counts[kf] == n0 + 1
    assert abs(loss.item() - ploss.item()) <= 1e-4 * abs(ploss.item())
    assert abs(fs.item() - pfs.item()) <= 1e-4
    gl = torch.tensor(1.0, device="cuda")
    out = final_ce_dice_bwd(feats, w, b, t, cw, c, with_dice, res, gl)
    ref = final_ce_dice_bwd_plain(feats, w, b, t, cw, c, with_dice, pres, gl)
    assert launch_counts[kb] == n1 + 1
    assert out[0].dtype == dtype and out[1].shape == w.shape and out[2].shape == b.shape
    assert _rel(out[0], ref[0]) <= CONV_REL_TOL
    for o, r in zip(out[1:], ref[1:]):
        assert _rel(o, r) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_final_loss_all_ignored(cuda, dtype):
    """Every target ignored (s_w = 0): the CE term is 0 / max(0, 1e-12) and
    its gradient w·inv = 0 at inv = 1e12, on the kernels as on the plain
    versions; the dice term and its gradient remain."""
    from tpu_unet_torch.kernels.loss import (final_ce_dice_bwd, final_ce_dice_bwd_plain,
                                             final_ce_dice_fwd, final_ce_dice_fwd_plain)

    feats, w, b, t, cw = _loss_case(cuda, 2, 16, 24, 21, dtype)
    t = torch.where(t < 10, torch.full_like(t, 21), torch.full_like(t, 255))
    loss, fs, res = final_ce_dice_fwd(feats, w, b, t, cw, 21, True)
    ploss, pfs, pres = final_ce_dice_fwd_plain(feats, w, b, t, cw, 21, True)
    assert res[0].item() == 0.0 and pres[0].item() == 0.0
    assert abs(loss.item() - ploss.item()) <= 1e-4 * abs(ploss.item())
    assert abs(fs.item() - pfs.item()) <= 1e-4
    gl = torch.tensor(1.0, device="cuda")
    out = final_ce_dice_bwd(feats, w, b, t, cw, 21, True, res, gl)
    ref = final_ce_dice_bwd_plain(feats, w, b, t, cw, 21, True, pres, gl)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    assert _rel(out[0], ref[0]) <= CONV_REL_TOL
    for o, r in zip(out[1:], ref[1:]):
        assert _rel(o, r) <= 1e-3


@pytest.mark.gpu
def test_final_loss_deterministic(cuda):
    """Two runs of #27 give the bit-identical loss, f_score and residuals,
    two runs of #29 the bit-identical dfeat, dW and db (no float atomics:
    the blocks' partial rows are added in row order)."""
    from tpu_unet_torch.kernels.loss import final_ce_dice_bwd, final_ce_dice_fwd

    feats, w, b, t, cw = _loss_case(cuda, 2, 64, 64, 21, torch.bfloat16)
    a = final_ce_dice_fwd(feats, w, b, t, cw, 21, True)
    z = final_ce_dice_fwd(feats, w, b, t, cw, 21, True)
    assert torch.equal(a[0], z[0]) and torch.equal(a[1], z[1])
    assert all(torch.equal(x, y) for x, y in zip(a[2], z[2]))
    gl = torch.tensor(1.0, device="cuda")
    g1 = final_ce_dice_bwd(feats, w, b, t, cw, 21, True, a[2], gl)
    g2 = final_ce_dice_bwd(feats, w, b, t, cw, 21, True, a[2], gl)
    assert all(torch.equal(x, y) for x, y in zip(g1, g2))


@pytest.mark.gpu
@pytest.mark.parametrize("with_dice", [True, False])
def test_final_loss_scalars(cuda, with_dice):
    """The scalar epilogues on the device: #27's loss, f_score and
    residuals (s_w, denom, score) equal the plain ``_finish`` of the
    kernel's own sums, and #29's A, B and inv the plain ``dice_coefs`` /
    ``_inv`` of the residuals and the cotangent, within 1e-6."""
    from tpu_unet_torch.kernels import loss as L

    feats, w, b, t, cw = _loss_case(cuda, 2, 24, 40, 21, torch.bfloat16)
    loss, fs, res, sums = L._fwd_cuda(feats, w, b, t, cw, 21, with_dice)
    ploss, pfs, pres = L._finish(sums, 21, with_dice)

    def close(x, y):
        return bool(((x - y).abs() <= 1e-6 * y.abs().clamp_min(1.0)).all())

    assert close(loss, ploss) and close(fs, pfs)
    assert all(close(x, y) for x, y in zip(res, pres))
    gl = torch.tensor(0.75, device="cuda")
    coefs = L._bwd_cuda(feats, w, b, t, cw, 21, with_dice, res, gl)[3]
    a, bb = L.dice_coefs(res[2], res[1], 21, gl, with_dice)
    assert close(coefs[:21], a) and close(coefs[21:42], bb)
    assert close(coefs[42], L._inv(gl, res[0]))


def _logit_inputs(gen, shape, c, dtype, cw=None):
    """Logits (shape + (C,)), int targets with ~3% the ignore class C and
    ~2% raw 255, class weights 1 + 0.1 c unless given."""
    x = (2 * torch.randn((*shape, c), generator=gen, device="cuda")).to(dtype)
    t = torch.randint(0, c, shape, generator=gen, device="cuda")
    r = torch.rand(shape, generator=gen, device="cuda")
    t = torch.where(r < 0.03, torch.full_like(t, c), t)
    t = torch.where(r > 0.98, torch.full_like(t, 255), t)
    return x, t, cw if cw is not None else tuple(1.0 + 0.1 * i for i in range(c))


def _check_logit_loss(x, t, cw, c, with_dice, focal):
    """#25 and #26 against their plain versions (loss within 1e-4
    relative, f_score within 1e-4 as in test_logit_loss_kernels, dlogits within 1% of max |plain| for bf16, 1e-5 for
    float32), one launch a pass, a relaunch bit-identical."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.loss import (ce_dice_bwd, ce_dice_bwd_plain, ce_dice_fwd,
                                             ce_dice_fwd_plain)

    n0, n1 = launch_counts["ce_dice_fwd"], launch_counts["ce_dice_bwd"]
    loss, fs, res = ce_dice_fwd(x, t, cw, c, with_dice, focal)
    ploss, pfs, pres = ce_dice_fwd_plain(x, t, cw, c, with_dice, focal)
    assert launch_counts["ce_dice_fwd"] == n0 + 1
    assert abs(loss.item() - ploss.item()) <= 1e-4 * abs(ploss.item())
    assert abs(fs.item() - pfs.item()) <= 1e-4
    again = ce_dice_fwd(x, t, cw, c, with_dice, focal)
    assert torch.equal(loss, again[0]) and torch.equal(fs, again[1])
    assert all(torch.equal(a, b) for a, b in zip(res, again[2]))
    gl = torch.tensor(1.0, device="cuda")
    out = ce_dice_bwd(x, t, cw, c, with_dice, focal, 0.5, 2.0, res, gl)
    ref = ce_dice_bwd_plain(x, t, cw, c, with_dice, focal, 0.5, 2.0, pres, gl)
    assert launch_counts["ce_dice_bwd"] == n1 + 1
    assert out.dtype == x.dtype and out.shape == x.shape
    assert _rel(out, ref) <= (1e-2 if x.dtype == torch.bfloat16 else 1e-5)
    assert torch.equal(out, ce_dice_bwd(x, t, cw, c, with_dice, focal, 0.5, 2.0, res, gl))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("focal", [False, True])
@pytest.mark.parametrize("with_dice", [True, False])
@pytest.mark.parametrize("c", [4, 1, 21, 126])
@pytest.mark.parametrize("shape", [(3, 40, 72), (1, 9, 23)])
def test_logit_loss_layouts(cuda, dtype, focal, with_dice, c, shape):
    """#25 / #26 at every thread layout the class counts take (C = 1, 4:
    a thread a pixel; 21: four threads; 126: sixteen), CE and focal, dice
    on and off, over several tiles and blocks (3 x 40 x 72) and at a
    ragged pixel count (207: a last tile whose bytes are no multiple of
    16)."""
    x, t, cw = _logit_inputs(cuda, shape, c, dtype)
    _check_logit_loss(x, t, cw, c, with_dice, focal)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["traditional_weights", "all_ignored", "unaligned", "ragged"])
def test_logit_loss_edges(cuda, dtype, case):
    """The DataB weights (1, 15, 0, 0), focal + dice (u = 0 on two
    classes: the backward's 1 - pt clamped at 1e-12); every target
    ignored (s_w = 0); logits and targets as views no 16 bytes align (the
    wrapper copies them); pixel counts one past a tile and one short."""
    from tpu_unet_torch.kernels.loss import logit_loss_plan

    if case == "traditional_weights":
        x, t, _ = _logit_inputs(cuda, (4, 48, 48), 4, dtype)
        _check_logit_loss(x, t, (1.0, 15.0, 0.0, 0.0), 4, True, True)
    elif case == "all_ignored":
        x, t, cw = _logit_inputs(cuda, (2, 16, 24), 21, dtype)
        t = torch.where(t < 10, torch.full_like(t, 21), torch.full_like(t, 255))
        for focal in (False, True):
            _check_logit_loss(x, t, cw, 21, True, focal)
    elif case == "unaligned":
        x, t, cw = _logit_inputs(cuda, (2, 17, 19), 4, dtype)
        xb = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
        xb[1:] = x.reshape(-1)
        tb = torch.empty(t.numel() + 1, dtype=torch.uint8, device="cuda")
        tb[1:] = torch.clamp(t, max=255).to(torch.uint8).reshape(-1)
        xv, tv = xb[1:].view(x.shape), tb[1:].view(t.shape)
        assert xv.data_ptr() % 16 and tv.data_ptr() % 16
        _check_logit_loss(xv, tv, cw, 4, True, True)
    else:
        tile = logit_loss_plan(4, dtype == torch.float32, False).tile
        for n in (tile + 1, 2 * tile - 1):
            x, t, cw = _logit_inputs(cuda, (1, n), 4, dtype)
            _check_logit_loss(x, t, cw, 4, True, False)


@pytest.mark.gpu
@pytest.mark.parametrize("focal", [False, True])
@pytest.mark.parametrize("with_dice", [True, False])
def test_logit_loss_scalars(cuda, with_dice, focal):
    """The device epilogue and prologue: #25's loss, f_score and residuals
    equal the plain ``_finish`` of the kernel's own sums, and #26's A, B
    and inv the plain ``dice_coefs`` / ``_inv``, within 1e-6."""
    from tpu_unet_torch.kernels import loss as L

    x, t, cw = _logit_inputs(cuda, (2, 24, 40), 21, torch.bfloat16)
    loss, fs, res, sums = L._ce_fwd_cuda(x, t, cw, 21, with_dice, focal, 0.5, 2.0)
    n = x.numel() // 21
    ploss, pfs, pres = L._finish(sums, 21, with_dice, n if focal else None)

    def close(a, b):
        return bool(((a - b).abs() <= 1e-6 * b.abs().clamp_min(1.0)).all())

    assert close(loss, ploss) and close(fs, pfs)
    assert all(close(a, b) for a, b in zip(res, pres))
    gl = torch.tensor(0.75, device="cuda")
    coefs = L._ce_bwd_cuda(x, t, cw, 21, with_dice, focal, 0.5, 2.0, res, gl)[1]
    a, bb = L.dice_coefs(res[2], res[1], 21, gl, with_dice)
    assert close(coefs[:21], a) and close(coefs[21:42], bb)
    assert close(coefs[42], L._inv(gl, res[0], n if focal else None))


def _device_kernels(fn):
    """The device kernels ``fn`` launches, by name, in launch order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    return [e.name for e in evs]


@pytest.mark.gpu
def test_logit_loss_one_kernel_a_pass(cuda):
    """``ce_dice_loss`` forward and backward, as the DataB step runs them:
    with packed targets exactly the two kernels; with int targets those two
    and ``pack_targets``' own kernels, nothing else (no second launch, no
    eager epilogue)."""
    from tpu_unet_torch.kernels.loss import ce_dice_loss, pack_targets

    x, t, _ = _logit_inputs(cuda, (4, 64, 64), 4, torch.bfloat16)
    xg = x.detach().requires_grad_()
    gl = torch.tensor(1.0, device="cuda")
    cw = (1.0, 15.0, 1.5, 2.0)

    def step(target):
        def fn():
            loss, _ = ce_dice_loss(xg, target, cw, 4, True, True)
            torch.autograd.grad(loss, xg, gl)
        return fn

    t8 = pack_targets(t, 4)
    names = _device_kernels(step(t8))
    assert len(names) == 2
    assert "ce_dice_fwd_kernel" in names[0] and "ce_dice_bwd_kernel" in names[1]
    packing = _device_kernels(lambda: pack_targets(t, 4))
    names = _device_kernels(step(t))
    assert [n for n in names if "ce_dice" not in n] == packing
    assert sum("ce_dice" in n for n in names) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,cs,cx,f", [(16, 32, 64, 128, 64), (8, 16, 8, 120, 64)])
def test_unetup_bwd_kernel(cuda, h, w, cs, cx, f):
    """#13 against its plain version: g2 exact, dz1 / dskip / dups within
    CONV_REL_TOL; the plan's dgrad tiles (pixels, channels): conv2's 256 x
    64 at 2H = 16 and 128 x 64 at 2H = 8, conv1's 128 x 192 (Cs + Cx =
    192, the split at 64 inside it) and 128 x 128 (the split at Cs = 8
    inside it)."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.decoder_train import dgrad_plan, unetup_bwd, unetup_bwd_plain

    rec = dgrad_plan(2, h, w, cs, cx, f)
    tiles = list(zip(rec[:, 6].tolist(), rec[:, 1].tolist()))
    assert tiles == ([(256, 64), (128, 192)] if h == 16 else [(128, 64), (128, 128)])

    g = torch.randn((2, h, w, f), generator=cuda, device="cuda").to(torch.bfloat16)
    out = torch.randn((2, h, w, f), generator=cuda, device="cuda").to(torch.bfloat16)
    y1 = torch.randn((2, h, w, f), generator=cuda, device="cuda").to(torch.bfloat16)
    w1, _ = _conv(cuda, f, cs + cx)
    w2, _ = _conv(cuda, f, f)
    n = launch_counts["unetup_bwd"]
    res = unetup_bwd(g, out, y1, w1, w2, cs)
    assert launch_counts["unetup_bwd"] == n + 1
    ref = unetup_bwd_plain(g, out, y1, w1, w2, cs)
    assert torch.equal(res[2], ref[2])
    for i in (3, 0, 1):
        assert res[i].shape == ref[i].shape
        assert _rel(res[i], ref[i]) <= CONV_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("h,cs,cx,f", [(16, 64, 128, 64), (8, 128, 256, 128),
                                       (8, 256, 512, 256), (8, 512, 512, 512)])
def test_unetup_bwd_full_kernels(cuda, h, cs, cx, f):
    """The whole stage backward (#13, ``unetup_wgrad``, ``upsample_adjoint``)
    against its plain version at the unet_vgg stages' channels, batch 2:
    dskip / dx within CONV_REL_TOL, the float32 weight and bias gradients
    within 1e-3 of max |plain| (their inputs carry #13's bf16 rounding), all
    six bit-identical on a second launch; the two new kernels alone on the
    plain chain's inputs (wgrad 1e-4, the adjoint one bf16 ulp: 1e-2)."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.decoder_train import (unetup_bwd_full, unetup_bwd_full_plain,
                                                      unetup_bwd_plain, unetup_wgrad,
                                                      unetup_wgrad_plain, upsample2x_adjoint,
                                                      upsample2x_adjoint_plain)

    h2 = 2 * h
    skip, x = _act(cuda, 2, h2, h2, cs), _act(cuda, 2, h, h, cx)
    g = torch.randn((2, h2, h2, f), generator=cuda, device="cuda").to(torch.bfloat16)
    out, y1 = _act(cuda, 2, h2, h2, f), _act(cuda, 2, h2, h2, f)
    w1, _ = _conv(cuda, f, cs + cx)
    w2, _ = _conv(cuda, f, f)
    args = (g, out, y1, skip, x, w1, w2)
    n = {k: launch_counts[k] for k in ("unetup_bwd", "unetup_wgrad", "upsample_adjoint")}
    res = unetup_bwd_full(*args)
    assert all(launch_counts[k] == v + 1 for k, v in n.items())
    assert all(torch.equal(a, b) for a, b in zip(res, unetup_bwd_full(*args)))
    ref = unetup_bwd_full_plain(*args)
    for i, (a, b) in enumerate(zip(res, ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel(a, b) <= (CONV_REL_TOL if i < 2 else 1e-3), i
    _, dups, g2, dz1 = unetup_bwd_plain(g, out, y1, w1, w2, cs)
    for a, b in zip(unetup_wgrad(skip, x, dz1, y1, g2), unetup_wgrad_plain(skip, x, dz1, y1, g2)):
        assert _rel(a, b) <= 1e-4
    assert _rel(upsample2x_adjoint(dups, h, h), upsample2x_adjoint_plain(dups, h, h)) <= 1e-2


@pytest.mark.gpu
def test_stage_backward_rejects_untileable_shape(cuda):
    """2W = 8 is not a multiple of 16: the wrappers raise, nothing launches."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.decoder_train import unetup_bwd_full, unetup_wgrad

    skip, x = _act(cuda, 1, 8, 8, 64), _act(cuda, 1, 4, 4, 128)
    t = _act(cuda, 1, 8, 8, 64)
    w1, _ = _conv(cuda, 64, 192)
    w2, _ = _conv(cuda, 64, 64)
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="must all be 0"):
        unetup_bwd_full(t, t, t, skip, x, w1, w2)
    with pytest.raises(ValueError, match="must all be 0"):
        unetup_wgrad(skip, x, t, t, t)
    assert dict(launch_counts) == before


@pytest.mark.gpu
@pytest.mark.parametrize("chans,pool,bhw", [
    ([3, 64, 64], True, (2, 16, 32)), ([3, 64, 64], True, (2, 24, 32)),
    ([64, 128, 128], True, (2, 16, 32)),
    ([128, 256, 256, 256], True, (2, 16, 32)), ([512, 512, 512, 512], False, (2, 16, 32)),
    # three convs on the Hopper kernels (csrc/conv3x3_sm90.cuh, wgrad_sm90.cuh):
    # block 4's widths, the smallest tile (8 images of one 8x16 tile, and one
    # image of one: SINGLE_TILE_WGRAD_REL_TOL), H != W, F = 64 (the narrow
    # instantiations, one f warpgroup) and widths % 128 != 0
    ([256, 512, 512, 512], True, (2, 16, 32)), ([256, 512, 512, 512], True, (8, 8, 16)),
    ([128, 256, 256, 256], True, (1, 8, 16)), ([256, 512, 512, 512], True, (1, 8, 16)),
    ([128, 256, 256, 256], True, (1, 24, 48)), ([64, 64, 64, 64], True, (4, 16, 16)),
    ([192, 128, 64, 192], False, (2, 16, 32))])
def test_encoder_train_kernels(cuda, chans, pool, bhw):
    """The training encoder at the VGG16 stages' channels and the edge
    shapes: the forward keeping its intermediates (within CONV_REL_TOL of
    the plain chain), and the stage backward (#20 / #22 / #24) against its
    plain version on the same intermediates — dx within CONV_REL_TOL, the
    float32 weight and bias gradients within 1e-3 of max |plain| (the inner
    convs' inputs carry the kernel's bf16 dgrad rounding;
    SINGLE_TILE_WGRAD_REL_TOL at 128 pixels), bit-identical on a second
    launch, one launch under its key."""
    from tpu_unet_torch.kernels import _plain, launch_counts, sm90
    from tpu_unet_torch.kernels.encoder_train import (_vgg_block_cuda, _vgg_stem_cuda,
                                                      block_key, bwd_plan, vgg_block_bwd,
                                                      vgg_block_bwd_plain, vgg_stem_bwd,
                                                      vgg_stem_bwd_plain)

    stem = chans[0] == 3
    B, H, W = bhw
    x = (torch.rand((B, H, W, 3), generator=cuda, device="cuda").to(torch.bfloat16) if stem
         else _act(cuda, B, H, W, chans[0]))
    ws, bs = zip(*[_conv(cuda, f, c) for c, f in zip(chans[:-1], chans[1:])])
    ws, bs = list(ws), list(bs)
    if stem:
        skip, pooled, a1 = _vgg_stem_cuda(x, ws[0], bs[0], ws[1], bs[1])
        mids = [a1]
    else:
        skip, pooled, mids = _vgg_block_cuda(x, ws, bs, pool, block_key(len(ws), "fwd"))
    y, ref_mids = x, []
    for w, b in zip(ws, bs):
        y = _plain.conv3x3_relu(y, w, b)
        ref_mids.append(y)
    for a, b in zip([*mids, skip], ref_mids):
        assert _rel(a, b) <= CONV_REL_TOL
    assert (pooled is None) == (not pool)
    dskip = torch.randn(skip.shape, generator=cuda, device="cuda").to(torch.bfloat16)
    dpool = (torch.randn((B, H // 2, W // 2, chans[-1]), generator=cuda, device="cuda")
             .to(torch.bfloat16) if pool else None)
    key = "vgg_stem_bwd" if stem else block_key(len(ws), "bwd")
    before = launch_counts[key]
    if stem:
        # conv1_1's weight gradient over the image (its own GEMM), no
        # dgrad; conv1_2's weight gradient and masked dgrad
        rec, ns = bwd_plan(B, H, W, tuple(chans), False)
        assert rec[:, 0].tolist() == [sm90.OP_WGRAD_IMAGE, 0, sm90.OP_WGRAD,
                                      sm90.OP_DGRAD_MASK]
        assert rec[1].abs().sum() == 0 and rec[0::2, 5].tolist() == list(ns)
        assert rec[3, 6] == sm90.conv_tile_m(H, chans[1])
        res = vgg_stem_bwd(dskip, dpool, x, mids[0], skip, ws[0], ws[1])
        again = vgg_stem_bwd(dskip, dpool, x, mids[0], skip, ws[0], ws[1])
        ref = vgg_stem_bwd_plain(dskip, dpool, x, mids[0], skip, ws[0], ws[1])
        res, again, ref = (None, *res), (None, *again), (None, *ref)
    else:
        res = vgg_block_bwd(dskip, dpool, x, mids, skip, ws)
        again = vgg_block_bwd(dskip, dpool, x, mids, skip, ws)
        ref = vgg_block_bwd_plain(dskip, dpool, x, mids, skip, ws)
        assert _rel(res[0], ref[0]) <= CONV_REL_TOL
        assert torch.equal(res[0], again[0])
    assert launch_counts[key] == before + 2
    tol = SINGLE_TILE_WGRAD_REL_TOL if B * H * W == 128 else 1e-3
    for part in (1, 2):
        for a, b, c in zip(res[part], ref[part], again[part]):
            assert a.shape == b.shape and a.dtype == torch.float32
            assert _rel(a, b) <= tol
            assert torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("bhw", [(2, 16, 32), (2, 24, 32)])
def test_block2_train_forward_keeps_mid(cuda, bhw):
    """Block 2's training forward (#21) on the Hopper core: one launch
    under ``vgg_block2_fwd`` (none under serving's ``vgg_block``), the mid
    ReLU output kept, mid / skip / pooled within CONV_REL_TOL of the plain
    chain, bit-identical on a second launch."""
    from tpu_unet_torch.kernels import _plain, launch_counts
    from tpu_unet_torch.kernels.encoder_train import _vgg_block_cuda, block_key

    key = block_key(2, "fwd")
    assert key == "vgg_block2_fwd"
    x = _act(cuda, *bhw, 64)
    ws, bs = zip(*[_conv(cuda, 128, 64), _conv(cuda, 128, 128)])
    before = dict(launch_counts)
    skip, pooled, mids = _vgg_block_cuda(x, list(ws), list(bs), True, key)
    assert launch_counts[key] == before[key] + 1
    assert launch_counts["vgg_block"] == before["vgg_block"]
    assert len(mids) == 1 and mids[0].shape == (*bhw, 128)
    mid = _plain.conv3x3_relu(x, ws[0], bs[0])
    ref = _plain.conv3x3_relu(mid, ws[1], bs[1])
    assert _rel(mids[0], mid) <= CONV_REL_TOL
    assert _rel(skip, ref) <= CONV_REL_TOL
    assert _rel(pooled, _plain.max_pool2x2(ref)) <= CONV_REL_TOL
    again = _vgg_block_cuda(x, list(ws), list(bs), True, key)
    assert all(torch.equal(a, b) for a, b in zip((skip, pooled, *mids),
                                                  (again[0], again[1], *again[2])))


def _block_bwd_float64(dskip, dpool, x, mids, out, ws):
    """``vgg_block_bwd_plain``'s weight and bias gradients in float64 from
    the same bf16 intermediates: the activation gradients are not rounded
    to bf16 between the convs."""
    from tpu_unet_torch.kernels.decoder_train import _conv_nobias, flip_t
    from tpu_unet_torch.kernels.encoder_train import pool_relu_grad_plain

    f64 = torch.float64
    g = pool_relu_grad_plain(dskip.to(f64), None if dpool is None else dpool.to(f64), out)
    ins, n = [x, *mids], len(ws)
    dks, dbs = [None] * n, [None] * n
    for i in range(n - 1, -1, -1):
        v, gn = ins[i].to(f64).permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        like = torch.empty((gn.shape[1], v.shape[1], 3, 3), dtype=f64, device=v.device)
        dks[i] = torch.ops.aten.convolution_backward(
            gn, v, like, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [False, True, False])[1]
        dbs[i] = g.sum((0, 1, 2))
        if i > 0:
            g = torch.where(ins[i] > 0, _conv_nobias(g, flip_t(ws[i])),
                            torch.zeros((), dtype=f64, device=g.device))
    return dks, dbs


@pytest.mark.gpu
@pytest.mark.parametrize("chans", [[128, 256, 256, 256], [256, 512, 512, 512],
                                   [64, 128, 128]])
def test_block_bwd_single_tile_float64(cuda, chans):
    """At one 8x16 tile (128 pixels) the kernel's and the plain version's
    weight and bias gradients (both round the activation gradients to bf16
    where the chain stores them) against the float64 chain from the same
    intermediates: the kernel no further from it than the plain version,
    with a quarter's margin (the readings agree to 3%).  Prints the
    readings (pytest -s)."""
    from tpu_unet_torch.kernels.encoder_train import (_vgg_block_cuda, block_key, vgg_block_bwd,
                                                      vgg_block_bwd_plain)

    x = _act(cuda, 1, 8, 16, chans[0])
    ws, bs = zip(*[_conv(cuda, f, c) for c, f in zip(chans[:-1], chans[1:])])
    skip, pooled, mids = _vgg_block_cuda(x, list(ws), list(bs), True, block_key(len(ws), "fwd"))
    dskip = torch.randn(skip.shape, generator=cuda, device="cuda").to(torch.bfloat16)
    dpool = torch.randn(pooled.shape, generator=cuda, device="cuda").to(torch.bfloat16)
    res = vgg_block_bwd(dskip, dpool, x, mids, skip, list(ws))
    ref = vgg_block_bwd_plain(dskip, dpool, x, mids, skip, list(ws))
    exact = _block_bwd_float64(dskip, dpool, x, mids, skip, list(ws))
    readings = {}
    for part, name in ((0, "dk"), (1, "db")):
        for i, (a, b, e) in enumerate(zip(res[1 + part], ref[1 + part], exact[part])):
            readings[f"{name}{i}"] = {"kernel_vs_plain": _rel(a, b),
                                      "kernel_vs_float64": _rel(a, e),
                                      "plain_vs_float64": _rel(b, e)}
    print(chans, readings)
    for r in readings.values():
        assert r["kernel_vs_float64"] <= 1.25 * r["plain_vs_float64"]


@pytest.mark.gpu
def test_encoder_bwd_rejects_untileable_shape(cuda):
    """W = 8 is not a multiple of 16: the wrapper raises, nothing launches."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.encoder_train import vgg_block_bwd

    x, t = _act(cuda, 1, 8, 8, 64), _act(cuda, 1, 8, 8, 128)
    w1, _ = _conv(cuda, 128, 64)
    w2, _ = _conv(cuda, 128, 128)
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="must all be 0"):
        vgg_block_bwd(t, _act(cuda, 1, 4, 4, 128), x, [t], t, [w1, w2])
    assert dict(launch_counts) == before


# each route's launches in one unet_vgg train step at 128² (block 5's 8x8
# is no multiple of 16 wide: it trains plain)
# pack_weights: one launch of the pack kernel a call of each kernel that
# runs the conv core (16 = 1 + 1 + 2 + 1 + 1 + 2 + 4 + 4)
ROUTE_LAUNCHES = {
    "paired": {"vgg_stem": 1, "vgg_block2_fwd": 1, "vgg_block3_fwd": 2, "vgg_stem_bwd": 1,
               "vgg_block2_bwd": 1, "vgg_block3_bwd": 2, "unetup": 4, "upsample2x": 8,
               "unetup_bwd": 4, "unetup_wgrad": 4, "upsample_adjoint": 4,
               "final_ce_dice_fwd": 1, "final_ce_dice_bwd": 1, "pack_weights": 16},
    "fused": {"unetup": 1, "upsample2x": 1, "unetup_bwd": 1, "final_ce_dice_fwd": 1,
              "final_ce_dice_bwd": 1, "pack_weights": 2},
}


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["paired", "fused"])
def test_train_step_on_card(cuda, route):
    """One unet_vgg step at 128², batch 2, bf16, under each training route:
    exactly the route's launches (``ROUTE_LAUNCHES``); loss within 1e-3 and every gradient at a cosine ≥ 0.99 of the
    plain step's on the card (the plain step of ``chip_smoke.py``, so both
    hold the step to one reference)."""
    from chip_smoke import plain_step
    from tpu_unet_torch.kernels import launch_counts, reset_launch_counts
    from tpu_unet_torch.models.registry import build_model, init_model
    from tpu_unet_torch.train import step as tstep

    net = init_model(build_model("unet_vgg", 21), seed=0).cuda()
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.randint(0, 256, (2, 128, 128, 3), generator=g, dtype=torch.uint8),
             "label": torch.randint(0, 22, (2, 128, 128), generator=g, dtype=torch.int32)}
    cw = tuple(1.0 + 0.05 * i for i in range(21))
    cfg = tstep.StepConfig(21, cw, use_dice=True, compute_dtype=torch.bfloat16,
                           train_route=route)
    state = tstep.TrainState(net, tstep.make_optimizer(net))
    fn = tstep.make_train_step(net, cfg)
    reset_launch_counts()
    _, m = fn(state, batch, 0.0)
    torch.cuda.synchronize()
    assert {k: v for k, v in launch_counts.items() if v} == ROUTE_LAUNCHES[route]
    ploss, pgrads, _ = plain_step(net, batch, 21, cw)
    assert abs(m["loss"].item() - ploss) <= 1e-3 * ploss
    for k, p in net.named_parameters():
        a, b = p.grad.float().ravel(), pgrads[k].float().ravel()
        cos = (a @ b / (a.norm() * b.norm())).item()
        assert cos >= 0.99, (k, cos)


def _logit_case(gen, shape, dtype):
    """Logits and targets with ~3% ignore pixels and ~2% raw 255 labels."""
    c = shape[-1]
    x = (2 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    t = torch.randint(0, c, shape[:3], generator=gen, device="cuda")
    r = torch.rand(shape[:3], generator=gen, device="cuda")
    t = torch.where(r < 0.03, torch.full_like(t, c), t)
    return x, torch.where(r > 0.98, torch.full_like(t, 255), t)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("focal", [True, False])
@pytest.mark.parametrize("c", [4, 21])
def test_logit_loss_kernels(cuda, dtype, focal, c):
    """#25 and #26 against their plain versions, the last tile ragged
    (1702 pixels): loss within 1e-4 relative, f_score within 1e-4, dlogits
    within 1% of max |plain| in bf16 and 1e-5 in float32."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.loss import (ce_dice_bwd, ce_dice_bwd_plain, ce_dice_fwd,
                                             ce_dice_fwd_plain)

    x, t = _logit_case(cuda, (2, 23, 37, c), dtype)
    cw = (1.0, 15.0, 0.0, 0.0) if c == 4 else tuple(1.0 + 0.1 * i for i in range(c))
    n0, n1 = launch_counts["ce_dice_fwd"], launch_counts["ce_dice_bwd"]
    loss, fs, res = ce_dice_fwd(x, t, cw, c, True, focal)
    ploss, pfs, pres = ce_dice_fwd_plain(x, t, cw, c, True, focal)
    assert launch_counts["ce_dice_fwd"] == n0 + 1
    assert abs(loss.item() - ploss.item()) <= 1e-4 * abs(ploss.item())
    assert abs(fs.item() - pfs.item()) <= 1e-4
    gl = torch.tensor(1.0, device="cuda")
    out = ce_dice_bwd(x, t, cw, c, True, focal, 0.5, 2.0, res, gl)
    ref = ce_dice_bwd_plain(x, t, cw, c, True, focal, 0.5, 2.0, pres, gl)
    assert launch_counts["ce_dice_bwd"] == n1 + 1
    assert out.dtype == dtype and out.shape == x.shape
    assert _rel(out, ref) <= (1e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.gpu
def test_logit_loss_deterministic(cuda):
    """Two runs of #25 give the bit-identical loss (no float atomics)."""
    from tpu_unet_torch.kernels.loss import ce_dice_fwd

    x, t = _logit_case(cuda, (4, 64, 64, 4), torch.bfloat16)
    a = ce_dice_fwd(x, t, (1.0, 15.0, 1.5, 2.0), 4, True, True)
    z = ce_dice_fwd(x, t, (1.0, 15.0, 1.5, 2.0), 4, True, True)
    assert torch.equal(a[0], z[0]) and torch.equal(a[1], z[1])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["traditional", "ultralight_large_optimized"])
def test_datab_train_step_on_card(cuda, name):
    """One DataB step at 64², batch 2, bf16, focal + dice: launches #25 and
    #26 once each and no other kernel; loss within 1e-3 and every gradient
    (but the conv biases a batch norm cancels) at a cosine ≥ 0.99 of the
    plain step's on the card with the same dropout generator (the plain
    step of ``chip_smoke.py``)."""
    from chip_smoke import DATAB_CW, cancelled_biases, plain_datab_step
    from tpu_unet_torch.kernels import launch_counts, reset_launch_counts
    from tpu_unet_torch.models.registry import build_model, init_model
    from tpu_unet_torch.train import step as tstep

    net = init_model(build_model(name, 4), seed=0).cuda()
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.randint(0, 256, (2, 64, 64, 3), generator=g, dtype=torch.uint8),
             "label": torch.randint(0, 5, (2, 64, 64), generator=g, dtype=torch.int32)}
    cfg = tstep.StepConfig(4, DATAB_CW[name], use_focal=True, use_dice=True,
                           compute_dtype=torch.bfloat16)
    ploss, pgrads, _ = plain_datab_step(net, batch, cfg, seed=3)
    state = tstep.TrainState(net, tstep.make_optimizer(net))
    reset_launch_counts()
    _, m = tstep.make_train_step(net, cfg)(state, batch, 0.0,
                                           torch.Generator(device="cuda").manual_seed(3))
    torch.cuda.synchronize()
    assert {k: v for k, v in launch_counts.items() if v} == {"ce_dice_fwd": 1, "ce_dice_bwd": 1}
    assert abs(m["loss"].item() - ploss) <= 1e-3 * ploss
    noise = cancelled_biases(net)
    for k, p in net.named_parameters():
        if k not in noise:
            a, b = p.grad.float().ravel(), pgrads[k].ravel()
            assert (a @ b / (a.norm() * b.norm())).item() >= 0.99, k


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(8, 16), (16, 24)])
def test_upconv_bwd_kernel(cuda, h, w):
    """#12's port against its plain version, batch 2, x (2, h, w, 64): one
    counted launch; dx within CONV_REL_TOL, the float32 weight and bias
    gradients within 1e-3 of max |plain| (their inputs carry the kernel
    dgrads' bf16 rounding), all five bit-identical on a second launch."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.upconv import upconv_bwd, upconv_bwd_plain

    x = _act(cuda, 2, h, w, 64)
    g = torch.randn((2, 2 * h, 2 * w, 64), generator=cuda, device="cuda").to(torch.bfloat16)
    out, y1 = _act(cuda, 2, 2 * h, 2 * w, 64), _act(cuda, 2, 2 * h, 2 * w, 64)
    w1, _ = _conv(cuda, 64, 64)
    w2, _ = _conv(cuda, 64, 64)
    n = launch_counts["upconv_bwd"]
    res = upconv_bwd(g, out, y1, x, w1, w2)
    assert launch_counts["upconv_bwd"] == n + 1
    assert all(torch.equal(a, b) for a, b in zip(res, upconv_bwd(g, out, y1, x, w1, w2)))
    ref = upconv_bwd_plain(g, out, y1, x, w1, w2)
    for i, (a, b) in enumerate(zip(res, ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel(a, b) <= (CONV_REL_TOL if i == 0 else 1e-3), i


@pytest.mark.gpu
def test_upconv_bwd_single_tile_float64(cuda):
    """#12 at one 8x16 output tile, each reading against float64 from the
    kernel's own bf16 inputs: dz1 (from g2 = g · [out > 0], exact) and dups
    (from its own dz1) within one bf16 ulp of the largest value of the
    float64 dgrads; dk2 / db2 (from g2 and y1) and dk1 / db1
    (from its own dz1 and up = up2x(x), the plain bf16 upsample's, bit for
    bit) within float32's sums over 128 pixels; dx within one ulp of the
    float64 adjoint of its own dups.  Prints the readings (pytest -s)."""
    import torch.nn.functional as F

    from chip_smoke import SINGLE_TILE_DK_REL_TOL, SINGLE_TILE_STORE_REL_TOL
    from tpu_unet_torch.kernels.decoder_train import flip_t
    from tpu_unet_torch.kernels.upconv import _upconv_bwd_cuda
    from tpu_unet_torch.nn.resize import upsample2x, upsample2x_adjoint_plain

    f64 = torch.float64
    x = _act(cuda, 1, 4, 8, 64)
    g = torch.randn((1, 8, 16, 64), generator=cuda, device="cuda").to(torch.bfloat16)
    out, y1 = _act(cuda, 1, 8, 16, 64), _act(cuda, 1, 8, 16, 64)
    w1, _ = _conv(cuda, 64, 64)
    w2, _ = _conv(cuda, 64, 64)
    dx, dk1, db1, dk2, db2, dz1, dups = _upconv_bwd_cuda(g, out, y1, x, w1, w2)
    g2 = torch.where(out > 0, g, 0)

    def dgrad64(v, w):
        return F.conv2d(v.permute(0, 3, 1, 2).to(f64), flip_t(w).to(f64), padding=1) \
            .permute(0, 2, 3, 1)

    def wgrad64(gout, v):
        like = torch.empty((64, v.shape[-1], 3, 3), dtype=f64, device="cuda")
        return torch.ops.aten.convolution_backward(
            gout.permute(0, 3, 1, 2).to(f64), v.permute(0, 3, 1, 2).to(f64), like, None,
            [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [False, True, False])[1]

    up = upsample2x(x)
    readings = {"dz1": _rel(dz1, torch.where(y1 > 0, dgrad64(g2, w2), 0)),
                "dups": _rel(dups, dgrad64(dz1, w1)),
                "dx": _rel(dx, upsample2x_adjoint_plain(dups.to(f64), 4, 8)),
                "dk2": _rel(dk2, wgrad64(g2, y1)), "db2": _rel(db2, g2.to(f64).sum((0, 1, 2))),
                "dk1": _rel(dk1, wgrad64(dz1, up)), "db1": _rel(db1, dz1.to(f64).sum((0, 1, 2)))}
    print(readings)
    for name in ("dz1", "dups", "dx"):
        assert readings[name] <= SINGLE_TILE_STORE_REL_TOL, name
    for name in ("dk2", "db2", "dk1", "db1"):
        assert readings[name] <= SINGLE_TILE_DK_REL_TOL, name


@pytest.mark.gpu
def test_upconv_train_on_card(cuda):
    """``upconv_train`` on the card, bf16: one launch of the forward kernel
    keeping y1 and one of #12, each after an upsample launch and with one
    pack launch; its gradients are #12's on that forward's own out and y1, cast as
    ``_t_bwd`` casts them (bit for bit); against
    autograd of ``upconv_plain`` in float32 on the same values, the output
    within CONV_REL_TOL and every gradient at a cosine ≥ 0.99 (the bf16
    forward puts a pre-activation near 0 on the other side of its ReLU now
    and then: dx reads 9.5% of its largest there, element-wise)."""
    from tpu_unet_torch.kernels import launch_counts, reset_launch_counts
    from tpu_unet_torch.kernels.upconv import (_upconv_cuda, upconv_bwd, upconv_plain,
                                               upconv_train)

    x = _act(cuda, 2, 16, 16, 64)
    w1, b1 = _conv(cuda, 64, 64)
    w2, b2 = _conv(cuda, 64, 64)
    g = torch.randn((2, 32, 32, 64), generator=cuda, device="cuda").to(torch.bfloat16)
    args = [t.detach().requires_grad_() for t in (x, w1, b1, w2, b2)]
    reset_launch_counts()
    out = upconv_train(*args)
    grads = torch.autograd.grad(out, args, g)
    assert {k: v for k, v in launch_counts.items() if v} == {"upconv": 1, "upsample2x": 2,
                                                              "upconv_bwd": 1,
                                                              "pack_weights": 2}
    with torch.no_grad():
        out_k, y1 = _upconv_cuda(x, w1, b1, w2, b2, want_y1=True)
        own = upconv_bwd(g, out_k, y1, x, w1, w2)
    assert torch.equal(out, out_k)
    assert all(torch.equal(a, b.to(a.dtype)) for a, b in zip(grads, own))
    args32 = [t.detach().float().requires_grad_() for t in args]
    ref = upconv_plain(*args32)
    rgrads = torch.autograd.grad(ref, args32, g.float())
    assert _rel(out, ref) <= CONV_REL_TOL
    for i, (a, b) in enumerate(zip(grads, rgrads)):
        a, b = a.float().ravel(), b.ravel()
        assert (a @ b / (a.norm() * b.norm())).item() >= 0.99, i


@pytest.mark.gpu
def test_upconv_bwd_rejects_untileable_shape(cuda):
    """Cx = 32 tiles the forward but not the backward's conv1 dgrad: the
    wrapper raises and nothing launches."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.upconv import upconv_bwd

    x, t = _act(cuda, 1, 8, 8, 32), _act(cuda, 1, 16, 16, 64)
    w1, _ = _conv(cuda, 64, 32)
    w2, _ = _conv(cuda, 64, 64)
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="must all be 0"):
        upconv_bwd(t, t, t, x, w1, w2)
    assert dict(launch_counts) == before


# unet_resnet50's default-route step at 256² (every decoder stage and the
# head tile): the stage kernels 4 each (the upsample 10: in #1 and in
# unetup_wgrad, and in the head's forward and backward), the head's 1 each,
# the loss's 1 each
RN50_LAUNCHES = {"unetup": 4, "upsample2x": 10, "unetup_bwd": 4, "unetup_wgrad": 4,
                 "upsample_adjoint": 4,
                 "upconv": 1, "upconv_bwd": 1, "final_ce_dice_fwd": 1, "final_ce_dice_bwd": 1,
                 "pack_weights": 10}


@pytest.mark.gpu
def test_resnet50_train_step_on_card(cuda):
    """One unet_resnet50 step at 256², batch 2, bf16, CE + dice: exactly
    ``RN50_LAUNCHES``; loss within 1e-3, every gradient at a cosine ≥ 0.99
    and the running statistics within 1e-2 of the plain step's on the card
    (``chip_smoke.plain_step``)."""
    from chip_smoke import plain_step
    from tpu_unet_torch.kernels import launch_counts, reset_launch_counts
    from tpu_unet_torch.models.registry import build_model, init_model
    from tpu_unet_torch.train import step as tstep

    net = init_model(build_model("unet_resnet50", 21), seed=0).cuda()
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.randint(0, 256, (2, 256, 256, 3), generator=g, dtype=torch.uint8),
             "label": torch.randint(0, 22, (2, 256, 256), generator=g, dtype=torch.int32)}
    cw = tuple(1.0 + 0.05 * i for i in range(21))
    cfg = tstep.StepConfig(21, cw, use_dice=True, compute_dtype=torch.bfloat16)
    ploss, pgrads, pstats = plain_step(net, batch, 21, cw)
    state = tstep.TrainState(net, tstep.make_optimizer(net))
    reset_launch_counts()
    _, m = tstep.make_train_step(net, cfg)(state, batch, 0.0)
    torch.cuda.synchronize()
    assert {k: v for k, v in launch_counts.items() if v} == RN50_LAUNCHES
    assert abs(m["loss"].item() - ploss) <= 1e-3 * ploss
    for k, p in net.named_parameters():
        a, b = p.grad.float().ravel(), pgrads[k].ravel()
        assert (a @ b / (a.norm() * b.norm())).item() >= 0.99, k
    stats = net.state_dict()
    for k, v in pstats.items():
        assert _rel(stats[k], v) <= 1e-2, k


# ---- the float32 path: TF32 instantiations of the Hopper kernels ----------
#
# Each float32 kernel against its plain float32 version (TF32 off, the
# fixture) within the bounds of kernels/tf32.py, which the CPU emulation
# fixes (tests/test_torch_tf32.py), and one product of each against that
# emulation in float64 within tile_rel_tol of its reduction, under the
# operand rule kernels/tf32.py states for it (the witness: the other
# rule's distance printed beside it).


def _act32(gen, *shape):
    return torch.relu(torch.randn(shape, generator=gen, device="cuda"))


def _conv32(gen, f, c):
    w = torch.randn((f, c, 3, 3), generator=gen, device="cuda") / (9 * c) ** 0.5
    return w, 0.1 * torch.randn(f, generator=gen, device="cuda")


def _witness(out, emulate, k, rule="trunc"):
    """The distance of ``out`` to ``emulate(r)`` under either operand rule,
    printed; the stated rule's (``"trunc"``: a TMA operand of the conv
    core; ``"round"``: the halo mainloop's register fragments) within
    ``tf32.tile_rel_tol(k)`` for a reduction of ``k`` products.  Returns
    that distance."""
    from tpu_unet_torch.kernels import tf32

    d = {r: tf32.rel(out, emulate(r)) for r in ("trunc", "round")}
    print("witness", k, rule, d)
    assert d[rule] <= tf32.tile_rel_tol(k), (k, rule, d)
    return d[rule]


@pytest.mark.gpu
@pytest.mark.parametrize("u8", [True, False])
@pytest.mark.parametrize("shape", [(2, 32, 48), (1, 24, 16)])
def test_f32_stem_kernel(cuda, shape, u8):
    """The stem's float32 forward (``vgg_stem_f32``): within CONV_REL_TOL
    of the plain float32 stem; conv1_1's a1 within ``tile_rel_tol`` of its
    emulation (the image rounded to TF32 as the producers gather it,
    through the table f32(v) / 255 for a uint8 image), conv1_2's skip of
    the emulation over the kernel's a1 (a TMA operand), the pool exact;
    bit-identical on a second launch."""
    from tpu_unet_torch.core.precision import normalize_u8
    from tpu_unet_torch.kernels import launch_counts, tf32
    from tpu_unet_torch.kernels._plain import max_pool2x2
    from tpu_unet_torch.kernels.stem import _vgg_stem_cuda, vgg_stem_plain

    B, H, W = shape
    img = (torch.randint(0, 256, (B, H, W, 3), generator=cuda, device="cuda",
                         dtype=torch.uint8) if u8 else
           torch.rand((B, H, W, 3), generator=cuda, device="cuda"))
    w11, b11 = _conv32(cuda, 64, 3)
    w12, b12 = _conv32(cuda, 64, 64)
    n = launch_counts["vgg_stem_f32"]
    skip, pooled, a1 = _vgg_stem_cuda(img, w11, b11, w12, b12)
    assert launch_counts["vgg_stem_f32"] == n + 1 and skip.dtype == torch.float32
    ref = vgg_stem_plain(img, w11, b11, w12, b12)
    for o, r in zip((skip, pooled), ref):
        assert _rel(o, r) <= tf32.CONV_REL_TOL
    x = normalize_u8(img, torch.float32) if u8 else img
    _witness(a1, lambda r: tf32.conv3x3_relu(x, w11, b11, r), 27, "round")
    _witness(skip, lambda r: tf32.conv3x3_relu(a1, w12, b12, r), 9 * 64)
    assert torch.equal(pooled, max_pool2x2(skip))
    again = _vgg_stem_cuda(img, w11, b11, w12, b12)
    assert all(torch.equal(a, b) for a, b in zip((skip, pooled, a1), again))


@pytest.mark.gpu
@pytest.mark.parametrize("chans,pool,bhw", [
    ([64, 128, 128], True, (2, 16, 32)),
    ([64, 128, 128], True, (2, 24, 32)),
    ([128, 256, 256, 256], True, (2, 16, 32)),
    ([256, 512, 512, 512], True, (1, 8, 16)),
    ([512, 512, 512, 512], False, (2, 16, 32)),
    ([32, 64, 64], True, (2, 8, 48))])
def test_f32_block_kernel(cuda, chans, pool, bhw):
    """A block's float32 forward keeping its intermediates: within
    CONV_REL_TOL of the plain chain, each conv within ``tile_rel_tol`` of its
    emulation over the kernel's own input, the pool exact, bit-identical on
    a second launch, counted under ``vgg_block_f32``."""
    from tpu_unet_torch.kernels import launch_counts, tf32
    from tpu_unet_torch.kernels._plain import max_pool2x2
    from tpu_unet_torch.kernels.encoder import _vgg_block_cuda, vgg_block_plain

    x = _act32(cuda, *bhw, chans[0])
    wb = [_conv32(cuda, f, c) for c, f in zip(chans[:-1], chans[1:])]
    ws, bs = [w for w, _ in wb], [b for _, b in wb]
    n = launch_counts["vgg_block_f32"]
    skip, pooled, mids = _vgg_block_cuda(x, ws, bs, pool)
    assert launch_counts["vgg_block_f32"] == n + 1
    ref = vgg_block_plain(x, ws, bs, pool)
    assert _rel(skip, ref[0]) <= tf32.CONV_REL_TOL
    ins, outs = [x, *mids], [*mids, skip]
    for i, (a, o) in enumerate(zip(ins, outs)):
        _witness(o, lambda r, a=a, i=i: tf32.conv3x3_relu(a, ws[i], bs[i], r), 9 * chans[i])
    if pool:
        assert torch.equal(pooled, max_pool2x2(skip))
    again = _vgg_block_cuda(x, ws, bs, pool)
    assert torch.equal(skip, again[0])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 8, 16, 128), (1, 5, 7, 64), (1, 4, 4, 512)])
def test_f32_upsample2x_kernel_bit_exact(cuda, shape):
    """The upsample pass in float32 (``upsample2x_f32``): bit-equal to the
    plain float32 upsample (no rounding between its passes)."""
    from tpu_unet_torch.kernels import launch_counts
    from tpu_unet_torch.kernels.decoder_train import up2x
    from tpu_unet_torch.nn.resize import upsample2x

    x = torch.randn(shape, generator=cuda, device="cuda")
    n = launch_counts["upsample2x_f32"]
    up = up2x(x)
    assert launch_counts["upsample2x_f32"] == n + 1
    assert torch.equal(up, upsample2x(x))


@pytest.mark.gpu
@pytest.mark.parametrize("h,cs,cx,f", [(8, 64, 128, 64), (4, 128, 256, 128),
                                       (4, 256, 512, 256), (4, 512, 512, 512),
                                       (12, 64, 128, 64)])
def test_f32_unetup_stage(cuda, h, cs, cx, f):
    """#1 in float32: y1 and out within CONV_REL_TOL of the plain stage,
    conv1 over [skip | up] and conv2 within ``tile_rel_tol`` of their
    emulations under the rule of the mainloop their plan names
    (``tf32.launch_rule``: at F ≤ 256 the halo mainloop's, the activation
    rounded; at F = 512 the conv core's, truncated; up the kernel's
    upsample, bit-equal to the plain one),
    bit-identical on a second launch; counted as ``unetup_f32`` and
    ``upsample2x_f32``."""
    from tpu_unet_torch.kernels import launch_counts, sm90, tf32
    from tpu_unet_torch.kernels.decoder_fuse import _unetup_cuda, _unetup_plain_y1
    from tpu_unet_torch.nn.resize import upsample2x

    skip, x = _act32(cuda, 2, 2 * h, 4 * h, cs), _act32(cuda, 2, h, 2 * h, cx)
    w1, b1 = _conv32(cuda, f, cs + cx)
    w2, b2 = _conv32(cuda, f, f)
    n = {k: launch_counts[k] for k in ("unetup_f32", "upsample2x_f32")}
    out, y1 = _unetup_cuda(skip, x, w1, b1, w2, b2, want_y1=True)
    assert all(launch_counts[k] == v + 1 for k, v in n.items())
    ref, ry1 = _unetup_plain_y1(skip, x, w1, b1, w2, b2)
    assert _rel(out, ref) <= tf32.CONV_REL_TOL and _rel(y1, ry1) <= tf32.CONV_REL_TOL
    cc = torch.cat([skip, upsample2x(x)], dim=-1)
    r1, r2 = (tf32.launch_rule(ln) for ln in sm90.unetup_launches(2, 2 * h, 4 * h, cs, cx, f,
                                                                  True))
    assert r1 == r2 == ("round" if f <= 256 else "trunc")
    _witness(y1, lambda r: tf32.conv3x3_relu(cc, w1, b1, r), 9 * (cs + cx), r1)
    _witness(out, lambda r: tf32.conv3x3_relu(y1, w2, b2, r), 9 * f, r2)
    assert torch.equal(out, _unetup_cuda(skip, x, w1, b1, w2, b2))


@pytest.mark.gpu
@pytest.mark.parametrize("h,cs,cx,f", [(8, 64, 128, 64), (4, 128, 256, 128),
                                       (4, 512, 512, 512)])
def test_f32_stage_backward(cuda, h, cs, cx, f):
    """The float32 stage backward (#13, ``unetup_wgrad``, #19): the whole
    of it within CONV_REL_TOL (dskip, dx) and WGRAD_CHAIN_REL_TOL (the
    weight and bias gradients) of the plain version, bit-identical on a
    second launch; g2 equal to the plain mask pass's, conv2's masked dgrad
    and conv1's split dgrad within ``tile_rel_tol`` of their emulations over
    the kernel's own inputs; the weight gradients from the plain chain's
    dz1 / g2 within WGRAD_REL_TOL of the plain version and ``tile_rel_tol``
    of their emulation (rounded operands); the adjoint within 1e-5 of its
    plain version (the same float32 products, fused), its plan the
    host's."""
    from tpu_unet_torch.kernels import launch_counts, tf32
    from tpu_unet_torch.kernels.decoder_train import (
        adjoint_plan, adjoint_plan_on_card, flip_t, unetup_bwd, unetup_bwd_full,
        unetup_bwd_full_plain, unetup_bwd_plain, unetup_wgrad, unetup_wgrad_plain,
        upsample2x_adjoint, upsample2x_adjoint_plain)
    from tpu_unet_torch.nn.resize import upsample2x

    B, H2, W2 = 2, 2 * h, 4 * h
    skip, x = _act32(cuda, B, H2, W2, cs), _act32(cuda, B, h, 2 * h, cx)
    g = torch.randn((B, H2, W2, f), generator=cuda, device="cuda")
    out_, y1 = _act32(cuda, B, H2, W2, f), _act32(cuda, B, H2, W2, f)
    w1, _ = _conv32(cuda, f, cs + cx)
    w2, _ = _conv32(cuda, f, f)
    args = (g, out_, y1, skip, x, w1, w2)
    keys = ("unetup_bwd_f32", "unetup_wgrad_f32", "upsample_adjoint_f32")
    n = {k: launch_counts[k] for k in keys}
    res = unetup_bwd_full(*args)
    assert all(launch_counts[k] == v + 1 for k, v in n.items())
    assert all(torch.equal(a, b) for a, b in zip(res, unetup_bwd_full(*args)))
    ref = unetup_bwd_full_plain(*args)
    for name, a, b in zip(("dskip", "dx", "dk1", "db1", "dk2", "db2"), res, ref):
        tol = tf32.CONV_REL_TOL if name in ("dskip", "dx") else tf32.WGRAD_CHAIN_REL_TOL
        assert _rel(a, b) <= tol, name
    dskip, dups, g2, dz1 = unetup_bwd(g, out_, y1, w1, w2, cs)
    pg2 = unetup_bwd_plain(g, out_, y1, w1, w2, cs)[2]
    assert torch.equal(g2, pg2)
    _witness(dz1, lambda r: torch.where(y1 > 0, tf32.conv3x3(g2, flip_t(w2), r), 0), 9 * f)
    _witness(torch.cat([dskip, dups], -1), lambda r: tf32.conv3x3(dz1, flip_t(w1), r), 9 * f)
    _, pdups, pg2, pdz1 = unetup_bwd_plain(g, out_, y1, w1, w2, cs)
    wres = unetup_wgrad(skip, x, pdz1, y1, pg2)
    for a, b in zip(wres, unetup_wgrad_plain(skip, x, pdz1, y1, pg2)):
        assert _rel(a, b) <= tf32.WGRAD_REL_TOL
    cc = torch.cat([skip, upsample2x(x)], dim=-1)
    pixels = B * H2 * W2  # the weight gradients' reduction
    assert tf32.rel(wres[0], tf32.wgrad(cc, pdz1)) <= tf32.tile_rel_tol(pixels)
    assert tf32.rel(wres[2], tf32.wgrad(y1, pg2)) <= tf32.tile_rel_tol(pixels)
    assert tf32.rel(wres[1], pdz1.double().sum((0, 1, 2))) <= 1e-5
    dx = upsample2x_adjoint(pdups, h, 2 * h)
    assert _rel(dx, upsample2x_adjoint_plain(pdups, h, 2 * h)) <= 1e-5
    assert torch.equal(dx, upsample2x_adjoint(pdups, h, 2 * h))
    assert adjoint_plan_on_card(B, h, 2 * h, cx, True) == adjoint_plan(B, h, 2 * h, cx, True)


@pytest.mark.gpu
@pytest.mark.parametrize("chans,hw", [([3, 64, 64], (32, 48)), ([64, 128, 128], (16, 32)),
                                      ([128, 256, 256, 256], (16, 32)),
                                      ([512, 512, 512, 512], (8, 16))])
def test_f32_encoder_backward(cuda, chans, hw):
    """The float32 training encoder's backward (#20 at the stem's widths,
    #22, #24): dx within CONV_REL_TOL, the last conv's weight and bias
    gradients within WGRAD_REL_TOL and the others within
    WGRAD_CHAIN_REL_TOL of the plain version, bit-identical on a second
    launch; the last conv's weight gradient within ``tile_rel_tol`` of its
    emulation from the plain (exact) pool / ReLU gradient; the stem's
    masked dgrad (the halo mainloop's) within ``tile_rel_tol`` of its
    emulation under the rounding rule from the kernel's own g, bit-identical
    on a second launch."""
    from tpu_unet_torch.kernels import launch_counts, tf32
    from tpu_unet_torch.kernels.decoder_train import flip_t
    from tpu_unet_torch.kernels.encoder_train import (_bwd_cuda, block_key,
                                                      pool_relu_grad_plain, vgg_block_bwd,
                                                      vgg_block_bwd_plain, vgg_stem_bwd,
                                                      vgg_stem_bwd_plain)
    from tpu_unet_torch.kernels._plain import conv3x3_relu

    B, (H, W) = 2, hw
    stem, n = chans[0] == 3, len(chans) - 1
    x = (torch.rand((B, H, W, 3), generator=cuda, device="cuda") if stem
         else _act32(cuda, B, H, W, chans[0]))
    wb = [_conv32(cuda, f, c) for c, f in zip(chans[:-1], chans[1:])]
    ws, bs = [w for w, _ in wb], [b for _, b in wb]
    acts, y = [], x
    for w, b in zip(ws, bs):
        y = conv3x3_relu(y, w, b)
        acts.append(y)
    mids, skip = acts[:-1], acts[-1]
    dskip = torch.randn(skip.shape, generator=cuda, device="cuda")
    dpool = torch.randn((B, H // 2, W // 2, chans[-1]), generator=cuda, device="cuda")
    key = "vgg_stem_bwd" if stem else block_key(n, "bwd")
    c0 = launch_counts[key + "_f32"]
    if stem:
        res = (None, *vgg_stem_bwd(dskip, dpool, x, mids[0], skip, ws[0], ws[1]))
        ref = (None, *vgg_stem_bwd_plain(dskip, dpool, x, mids[0], skip, ws[0], ws[1]))
        again = (None, *vgg_stem_bwd(dskip, dpool, x, mids[0], skip, ws[0], ws[1]))
    else:
        res = vgg_block_bwd(dskip, dpool, x, mids, skip, ws)
        ref = vgg_block_bwd_plain(dskip, dpool, x, mids, skip, ws)
        again = vgg_block_bwd(dskip, dpool, x, mids, skip, ws)
    assert launch_counts[key + "_f32"] == c0 + 2
    if not stem:
        assert _rel(res[0], ref[0]) <= tf32.CONV_REL_TOL
        assert torch.equal(res[0], again[0])
    for i in range(n):
        tol = tf32.WGRAD_REL_TOL if i == n - 1 else tf32.WGRAD_CHAIN_REL_TOL
        assert _rel(res[1][i], ref[1][i]) <= tol, i
        assert _rel(res[2][i], ref[2][i]) <= tol, i
        assert torch.equal(res[1][i], again[1][i]) and torch.equal(res[2][i], again[2][i])
    g = pool_relu_grad_plain(dskip, dpool, skip)
    ins = [x, *mids]
    assert tf32.rel(res[1][n - 1], tf32.wgrad(ins[n - 1], g)) <= tf32.tile_rel_tol(B * H * W)
    if stem:  # the kernel's g in ga, conv1_2's masked dgrad in gb
        bufs = [_bwd_cuda("vgg_stem_bwd", dskip, dpool, x, mids, skip, ws, False, True)[3:]
                for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(*bufs))
        kg, dz = bufs[0]
        _witness(dz, lambda r: torch.where(mids[0] > 0, tf32.conv3x3(kg, flip_t(ws[1]), r), 0),
                 9 * chans[2], "round")


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(8, 8), (4, 16)])
def test_f32_upconv_kernel(cuda, h, w):
    """The head's forward in float32 (#10 / #11, ``upconv_f32``): the
    float32 plan's two convs (the tile rule's pixels × 64 channels, conv1
    over the one map up); one ``upconv_f32``, one ``upsample2x_f32`` and one
    ``pack_weights_f32`` launch a call, no bf16 key; y1 and out within CONV_REL_TOL of the plain
    float32 head, each conv within ``tile_rel_tol`` of its TF32 emulation
    over the kernel's own input under the halo mainloop's rule (the
    activation rounded; up bit-equal to the plain upsample; the other
    operand rule printed beside), bit-identical on a second launch."""
    from tpu_unet_torch.kernels import launch_counts, reset_launch_counts, sm90, tf32
    from tpu_unet_torch.kernels.decoder_fuse import stage_plan
    from tpu_unet_torch.kernels.upconv import _upconv_cuda, _upconv_plain_y1, upconv
    from tpu_unet_torch.nn.resize import upsample2x

    x = _act32(cuda, 2, h, w, 64)
    w1, b1 = _conv32(cuda, 64, 64)
    w2, b2 = _conv32(cuda, 64, 64)
    plan = stage_plan(2, 2 * h, 2 * w, 0, 64, 64, True)
    tm = 256 if (2 * h) % 16 == 0 else 128
    assert plan[:, 0].tolist() == [sm90.OP_FWD] * 2 and plan[:, 10].tolist() == [1, 1]
    assert plan[:, 1].tolist() == [64, 64] and plan[:, 6].tolist() == [tm, tm]
    reset_launch_counts()
    out, y1 = _upconv_cuda(x, w1, b1, w2, b2, want_y1=True)
    assert {k: v for k, v in launch_counts.items() if v} == {"upconv_f32": 1,
                                                              "upsample2x_f32": 1,
                                                              "pack_weights_f32": 1}
    assert out.dtype == torch.float32 and out.shape == (2, 2 * h, 2 * w, 64)
    rout, ry1 = _upconv_plain_y1(x, w1, b1, w2, b2)
    assert _rel(out, rout) <= tf32.CONV_REL_TOL and _rel(y1, ry1) <= tf32.CONV_REL_TOL
    _witness(y1, lambda r: tf32.conv3x3_relu(upsample2x(x), w1, b1, r), 9 * 64, "round")
    _witness(out, lambda r: tf32.conv3x3_relu(y1, w2, b2, r), 9 * 64, "round")
    assert torch.equal(out, upconv(x, w1, b1, w2, b2))


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(8, 16), (16, 24)])
def test_f32_upconv_bwd_kernel(cuda, h, w):
    """#12 in float32 (``upconv_bwd_f32``) against its plain float32
    version, batch 2, x (2, h, w, 64): one counted launch; dx within
    CONV_REL_TOL, the weight and bias gradients within WGRAD_CHAIN_REL_TOL,
    all five bit-identical on a second launch; conv2's masked dgrad and
    conv1's dgrad within ``tile_rel_tol`` of their TF32 emulations over the
    kernel's own inputs (g2 exact) under the halo mainloop's rule (the
    gradient rounded), dk2 of its emulation (rounded operands) over the
    whole reduction."""
    from tpu_unet_torch.kernels import launch_counts, tf32
    from tpu_unet_torch.kernels.decoder_train import flip_t
    from tpu_unet_torch.kernels.upconv import _upconv_bwd_cuda, upconv_bwd, upconv_bwd_plain

    x = _act32(cuda, 2, h, w, 64)
    g = torch.randn((2, 2 * h, 2 * w, 64), generator=cuda, device="cuda")
    out, y1 = _act32(cuda, 2, 2 * h, 2 * w, 64), _act32(cuda, 2, 2 * h, 2 * w, 64)
    w1, _ = _conv32(cuda, 64, 64)
    w2, _ = _conv32(cuda, 64, 64)
    n = launch_counts["upconv_bwd_f32"]
    res = upconv_bwd(g, out, y1, x, w1, w2)
    assert launch_counts["upconv_bwd_f32"] == n + 1
    assert all(torch.equal(a, b) for a, b in zip(res, upconv_bwd(g, out, y1, x, w1, w2)))
    ref = upconv_bwd_plain(g, out, y1, x, w1, w2)
    for i, (a, b) in enumerate(zip(res, ref)):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
        assert _rel(a, b) <= (tf32.CONV_REL_TOL if i == 0 else tf32.WGRAD_CHAIN_REL_TOL), i
    _, _, _, dk2, _, dz1, dups = _upconv_bwd_cuda(g, out, y1, x, w1, w2)
    g2 = torch.where(out > 0, g, 0)
    _witness(dz1, lambda r: torch.where(y1 > 0, tf32.conv3x3(g2, flip_t(w2), r), 0), 9 * 64,
             "round")
    _witness(dups, lambda r: tf32.conv3x3(dz1, flip_t(w1), r), 9 * 64, "round")
    assert tf32.rel(dk2, tf32.wgrad(y1, g2)) <= tf32.tile_rel_tol(g.numel() // 64)


@pytest.mark.gpu
def test_f32_upconv_bwd_single_tile_float64(cuda):
    """#12 in float32 at one 8x16 output tile, each reading in float64 from
    the kernel's own float32 inputs: dz1 (from g2, exact) and dups (from
    its own dz1) within ``tile_rel_tol(9 × 64)`` of their TF32 emulations
    under the stated rule (the halo mainloop's: the gradient rounded as its
    register fragments take it, rounded packed weights; the truncating rule
    printed beside), dk2 / db2 (from g2 and y1) and dk1 /
    db1 (from its own dz1 and up, the plain float32 upsample's bit for bit)
    within ``tile_rel_tol(128)`` of theirs (both operands rounded), dx within
    1e-5 of the float64 adjoint of its own dups (float32 sums of the same
    products).  Prints the readings and the distance of each from the exact
    float64 product (pytest -s)."""
    import torch.nn.functional as F

    from tpu_unet_torch.kernels import tf32
    from tpu_unet_torch.kernels.decoder_train import flip_t
    from tpu_unet_torch.kernels.upconv import _upconv_bwd_cuda
    from tpu_unet_torch.nn.resize import upsample2x, upsample2x_adjoint_plain

    f64 = torch.float64
    x = _act32(cuda, 1, 4, 8, 64)
    g = torch.randn((1, 8, 16, 64), generator=cuda, device="cuda")
    out, y1 = _act32(cuda, 1, 8, 16, 64), _act32(cuda, 1, 8, 16, 64)
    w1, _ = _conv32(cuda, 64, 64)
    w2, _ = _conv32(cuda, 64, 64)
    dx, dk1, db1, dk2, db2, dz1, dups = _upconv_bwd_cuda(g, out, y1, x, w1, w2)
    g2 = torch.where(out > 0, g, 0)
    up = upsample2x(x)

    def exact_dgrad(v, w):
        return F.conv2d(v.permute(0, 3, 1, 2).to(f64), flip_t(w).to(f64), padding=1) \
            .permute(0, 2, 3, 1)

    exact = {"dz1": tf32.rel(dz1, torch.where(y1 > 0, exact_dgrad(g2, w2), 0)),
             "dups": tf32.rel(dups, exact_dgrad(dz1, w1))}
    print("float64", exact)
    _witness(dz1, lambda r: torch.where(y1 > 0, tf32.conv3x3(g2, flip_t(w2), r), 0), 9 * 64,
             "round")
    _witness(dups, lambda r: tf32.conv3x3(dz1, flip_t(w1), r), 9 * 64, "round")
    readings = {"dk2": tf32.rel(dk2, tf32.wgrad(y1, g2)),
                "db2": tf32.rel(db2, g2.to(f64).sum((0, 1, 2))),
                "dk1": tf32.rel(dk1, tf32.wgrad(up, dz1)),
                "db1": tf32.rel(db1, dz1.to(f64).sum((0, 1, 2))),
                "dx": tf32.rel(dx, upsample2x_adjoint_plain(dups.to(f64), 4, 8))}
    print(readings)
    for name in ("dk2", "db2", "dk1", "db1"):
        assert readings[name] <= tf32.tile_rel_tol(128), name
    assert readings["dx"] <= 1e-5


@pytest.mark.gpu
def test_f32_upconv_train_on_card(cuda):
    """``upconv_train`` on the card in float32: one launch of the forward
    kernel keeping y1 and one of #12 (``upconv_f32``, ``upconv_bwd_f32``),
    each after an upsample launch and with one pack launch, no bf16 key;
    its gradients are #12's on
    that forward's own out and y1, bit for bit; against autograd of
    ``upconv_plain`` in float32 (TF32 off) on the same values, the output
    within CONV_REL_TOL and every gradient at a cosine ≥ 0.999 (a
    pre-activation near 0 may take the other side of its ReLU under TF32
    products)."""
    from tpu_unet_torch.kernels import launch_counts, reset_launch_counts, tf32
    from tpu_unet_torch.kernels.upconv import (_upconv_cuda, upconv_bwd, upconv_plain,
                                               upconv_train)

    x = _act32(cuda, 2, 16, 16, 64)
    w1, b1 = _conv32(cuda, 64, 64)
    w2, b2 = _conv32(cuda, 64, 64)
    g = torch.randn((2, 32, 32, 64), generator=cuda, device="cuda")
    args = [t.detach().requires_grad_() for t in (x, w1, b1, w2, b2)]
    reset_launch_counts()
    out = upconv_train(*args)
    grads = torch.autograd.grad(out, args, g)
    assert {k: v for k, v in launch_counts.items() if v} == {
        "upconv_f32": 1, "upsample2x_f32": 2, "upconv_bwd_f32": 1, "pack_weights_f32": 2}
    with torch.no_grad():
        out_k, y1 = _upconv_cuda(x, w1, b1, w2, b2, want_y1=True)
        own = upconv_bwd(g, out_k, y1, x, w1, w2)
    assert torch.equal(out, out_k)
    assert all(torch.equal(a, b) for a, b in zip(grads, own))
    args32 = [t.detach().requires_grad_() for t in args]
    ref = upconv_plain(*args32)
    rgrads = torch.autograd.grad(ref, args32, g)
    assert _rel(out, ref) <= tf32.CONV_REL_TOL
    for i, (a, b) in enumerate(zip(grads, rgrads)):
        a, b = a.ravel(), b.ravel()
        assert (a @ b / (a.norm() * b.norm())).item() >= 0.999, i


@pytest.mark.gpu
def test_f32_kernels_refuse_other_dtypes(cuda):
    """A float32 path's wrapper handed float16 (a dtype with no kernel)
    raises; no cast, no fallback."""
    from tpu_unet_torch.kernels.decoder_train import up2x, upsample2x_adjoint
    from tpu_unet_torch.kernels.encoder import vgg_block
    from tpu_unet_torch.kernels.upconv import upconv, upconv_bwd

    x = torch.zeros((1, 8, 16, 64), device="cuda", dtype=torch.float16)
    w = torch.zeros((64, 64, 3, 3), device="cuda", dtype=torch.float16)
    b = torch.zeros(64, device="cuda", dtype=torch.float16)
    g = torch.zeros((1, 16, 32, 64), device="cuda", dtype=torch.float16)
    for fn in (lambda: vgg_block(x, [w, w], [b, b]), lambda: up2x(x),
               lambda: upsample2x_adjoint(x, 4, 8), lambda: upconv(x, w, b, w, b),
               lambda: upconv_bwd(g, g, g, x, w, w)):
        with pytest.raises(ValueError, match="bf16 or float32"):
            fn()
    # mixed: float32 activations with bf16 weights
    with pytest.raises(ValueError, match="dtype"):
        vgg_block(x.float(), [w.to(torch.bfloat16)] * 2, [b.float()] * 2)
    with pytest.raises(ValueError, match="dtype"):
        upconv(x.float(), w.to(torch.bfloat16), b.float(), w.float(), b.float())
    with pytest.raises(ValueError, match="dtype"):
        upconv_bwd(g.float(), g.float(), g.float(), x.float(), w.to(torch.bfloat16), w.float())


def _dropped_first_split(g, ln):
    """``g`` with the pixels of the first split of GEMM launch ``ln`` (its
    contiguous 8 × 16 patches) zeroed: the gradient a GEMM that dropped
    that split's partial would give."""
    from tpu_unet_torch.kernels import sm90

    B, H, W, _ = g.shape
    lo, hi = sm90.split_ranges(ln["npatch"], ln["nsplit"])[0]
    keep = torch.ones(B * (H // 8) * (W // 16), dtype=torch.bool, device=g.device)
    keep[lo:hi] = False
    keep = keep.view(B, H // 8, W // 16).repeat_interleave(8, 1).repeat_interleave(16, 2)
    return torch.where(keep[..., None], g, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("c,f,coff", [(64, 64, 0), (128, 128, 0), (192, 256, 0), (96, 64, 64)])
def test_f32_wgrad_gemm(cuda, c, f, coff):
    """The float32 weight-gradient GEMM alone (``wgrad_gemm``: TF32 wgmma,
    G restaged K-major) at F = 64, at F % 128 == 0 (and C = 192, three
    column tiles) and as a concat's second map (C = 96 into channels [64,
    160) of one dk, a column tile half past C): one launch, within
    WGRAD_REL_TOL of the plain version, the bias exact to float32's sums,
    within ``tile_rel_tol`` of its float64 emulation from operands rounded
    to TF32 (the truncating rule's reading printed beside), bit-identical
    on a second launch, the channels outside its range untouched; a
    planted dropped split (the first of the plan's) reads above
    WGRAD_REL_TOL."""
    from tpu_unet_torch.kernels import launch_counts, sm90, tf32
    from tpu_unet_torch.kernels.decoder_train import conv_wgrad, wgrad_gemm

    B, H, W = 2, 32, 64
    v = _act32(cuda, B, H, W, c)
    g = torch.randn((B, H, W, f), generator=cuda, device="cuda")
    oc = coff + c + (32 if coff else 0)
    base = torch.full((f, oc, 3, 3), 7.0, device="cuda")
    n = launch_counts["wgrad_gemm_f32"]
    dk, db = wgrad_gemm(v, g, oc, coff, True, base.clone())
    assert launch_counts["wgrad_gemm_f32"] == n + 1
    part = dk[:, coff:coff + c]
    assert bool((dk[:, :coff] == 7).all()) and bool((dk[:, coff + c:] == 7).all())
    assert _rel(part, conv_wgrad(v, g)) <= tf32.WGRAD_REL_TOL
    assert tf32.rel(db, g.double().sum((0, 1, 2))) <= 1e-5
    d = {r: tf32.rel(part, tf32.wgrad(v, g, r)) for r in ("round", "trunc")}
    print("wgrad_gemm witness", (c, f, coff), d, tf32.tile_rel_tol(B * H * W))
    assert d["round"] <= tf32.tile_rel_tol(B * H * W)
    dk2, db2 = wgrad_gemm(v, g, oc, coff, True, base.clone())
    assert torch.equal(dk, dk2) and torch.equal(db, db2)
    ln = sm90.wgrad_launch(B, H, W, c, f, oc, coff, True, True)
    assert ln["nsplit"] > 1
    faulty, _ = wgrad_gemm(v, _dropped_first_split(g, ln))
    fault = _rel(faulty, conv_wgrad(v, g))
    print("wgrad_gemm dropped split", (c, f, coff), ln["nsplit"], fault)
    assert fault > tf32.WGRAD_REL_TOL


@pytest.mark.gpu
def test_f32_wgrad_gemm_single_tile_float64(cuda):
    """At one 8 × 16 patch (batch 1, one split, a chain of 128 pixels) the
    float32 GEMM's dk lies within ``tile_rel_tol(128)`` of the float64
    product of its operands rounded to TF32 — the rule ``kernels/tf32.py``
    states for it (the register fragments and the restaged G are both
    rounded) — at F = 64 and 128, C = 64 and 128; the truncating rule's
    reading and the distance from the exact float64 product are printed
    (pytest -s)."""
    from tpu_unet_torch.kernels import tf32
    from tpu_unet_torch.kernels.decoder_train import wgrad_gemm

    for c, f in ((64, 64), (128, 128)):
        v = _act32(cuda, 1, 8, 16, c)
        g = torch.randn((1, 8, 16, f), generator=cuda, device="cuda")
        dk, db = wgrad_gemm(v, g)
        d = {r: tf32.rel(dk, tf32.wgrad(v, g, r)) for r in ("round", "trunc")}
        exact = tf32.rel(dk, torch.ops.aten.convolution_backward(
            g.double().permute(0, 3, 1, 2), v.double().permute(0, 3, 1, 2),
            torch.empty((f, c, 3, 3), dtype=torch.float64, device="cuda"), None, [1, 1], [1, 1],
            [1, 1], False, [0, 0], 1, [False, True, False])[1])
        print("wgrad_gemm single tile", (c, f), d, "float64", exact)
        assert d["round"] <= tf32.tile_rel_tol(128), (c, f, d)
        assert tf32.rel(db, g.double().sum((0, 1, 2))) <= 1e-6


@pytest.mark.gpu
def test_f32_wgrad_gemm_refuses_a_bf16_record(cuda):
    """The float32 GEMM's C entry refuses a bf16 launch record (and the bf16
    one a float32 record): the call raises, nothing is launched."""
    from tpu_unet_torch.kernels import _build, sm90

    v = _act32(cuda, 1, 8, 16, 64)
    g = torch.randn((1, 8, 16, 64), generator=cuda, device="cuda")
    work = torch.empty(1 << 20, device="cuda")
    dk, db = torch.empty((64, 64, 3, 3), device="cuda"), torch.empty(64, device="cuda")
    for f32_tensors, f32_record in ((True, False), (False, True)):
        ln = sm90.wgrad_launch(1, 8, 16, 64, 64, f32=f32_record)
        t = (v, g) if f32_tensors else (v.to(torch.bfloat16), g.to(torch.bfloat16))
        with pytest.raises(RuntimeError, match="tu_wgrad"):
            _build.call("tu_wgrad", t[1].data_ptr(), t[0].data_ptr(), work.data_ptr(),
                        dk.data_ptr(), db.data_ptr(), 1, 8, 16, 64, 64, int(f32_tensors),
                        sm90.encode([ln]).data_ptr())


@pytest.mark.gpu
@pytest.mark.parametrize("shapes,flip,kps", [
    ([(40, 70)], False, [None]), ([(40, 70)], True, [None]),
    ([(64, 3), (64, 64)], False, [64, None]), ([(64, 3), (64, 64)], False, [32, None]),
    ([(33, 65), (96, 33), (32, 32)], True, [None, None, None]),
    ([(33, 65)], True, [9 * 33 + 7]), ([(512, 3072), (512, 512)], True, [None, None]),
    ([(512, 3072), (512, 512)], False, [None, None]), ([(48, 40), (40, 48)], False, [None, None]),
    ([(48, 40), (40, 48)], True, [None, None]), ([(72, 96)], True, [9 * 72 + 8])])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_pack_kernel_bit_equal(cuda, shapes, flip, kps, dt):
    """The pack kernel (``csrc/pack_weights.cu``): one launch for the call's
    weights of ``dt``, each output bit-equal to the plain pack of the same
    weight on the CPU, in bf16 and float32 (TF32), with its 16-byte stores
    (``sm90.pack_vector``) or one value a thread, and on a relaunch."""
    from tpu_unet_torch.kernels import _build, launch_counts

    ws = [torch.randn((f, c, 3, 3), generator=cuda, device="cuda").to(dt) for f, c in shapes]
    key = _build.count_key("pack_weights", dt)
    n = launch_counts[key]
    outs = _build.pack_weights(ws, dt, flip, kps)
    assert launch_counts[key] == n + 1
    again = _build.pack_weights(ws, dt, flip, kps)
    torch.cuda.synchronize()
    for o, a, w, kp in zip(outs, again, ws, kps):
        ref = _build.pack_conv3x3(w.cpu(), kp, dt, flip)
        assert o.dtype == dt and torch.equal(o.cpu(), ref) and torch.equal(o, a)


@pytest.mark.gpu
def test_pack_kernel_refuses_what_it_does_not_take(cuda):
    """float64 weights, a non-contiguous weight, four weights, weights on
    two devices, an output dtype other than bf16 / float32 and weights of
    another type than the output's raise."""
    from tpu_unet_torch.kernels import _build

    w = torch.randn((64, 32, 3, 3), generator=cuda, device="cuda")
    for ws, dt in (([w.double()], torch.float32), ([w.transpose(0, 1)], torch.float32),
                   ([w] * 4, torch.float32), ([w, w.cpu()], torch.float32),
                   ([w], torch.float16), ([w], torch.bfloat16),
                   ([w.bfloat16()], torch.float32)):
        with pytest.raises(ValueError):
            _build.pack_weights(ws, dt)


def _op_case(gen, op, dt):
    """(op, args) at small shapes its kernel tiles, in ``dt``."""
    from tpu_unet_torch.kernels import decoder_fuse, encoder, stem, upconv

    def conv(f, c):
        w, b = _conv(gen, f, c)
        return w.to(dt), b.to(dt)

    act = lambda *s: _act(gen, *s).to(dt)  # noqa: E731
    if op == "vgg_stem":
        img = torch.randint(0, 256, (2, 32, 48, 3), generator=gen, device="cuda",
                            dtype=torch.uint8)
        return stem.vgg_stem_op, (img, *conv(64, 3), *conv(64, 64))
    if op == "vgg_block":
        (w0, b0), (w1, b1) = conv(128, 64), conv(128, 128)
        return encoder.vgg_block_op, (act(2, 32, 32, 64), [w0, w1], [b0, b1], True)
    if op == "unetup":
        return decoder_fuse.unetup_op, (act(2, 32, 32, 64), act(2, 16, 16, 128), *conv(64, 192),
                                        *conv(64, 64))
    return upconv.upconv_op, (act(2, 16, 16, 64), *conv(64, 64), *conv(64, 64))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("op", ["vgg_stem", "vgg_block", "unetup", "upconv"])
def test_kernel_op_opcheck(cuda, op, dt):
    """Each kernel's operator passes ``torch.library.opcheck`` (its schema,
    its autograd registration, its fake against the kernel's outputs, a
    dynamic-shape trace) in bf16 and float32."""
    fn, args = _op_case(cuda, op, dt)
    torch.library.opcheck(fn, args)


@pytest.mark.gpu
@pytest.mark.parametrize("model,expect", [
    ("unet_vgg", {"vgg_stem_f32": 1, "vgg_block_f32": 4, "unetup_f32": 4, "upsample2x_f32": 4,
                  "pack_weights_f32": 9}),
    ("self_net", {"vgg_stem_f32": 1, "vgg_block_f32": 4, "unetup_f32": 4, "upsample2x_f32": 5,
                  "upconv_f32": 1, "pack_weights_f32": 10})])
def test_exported_program_launches_the_kernels(cuda, model, expect, tmp_path):
    """A program exported on the card at 256² holds the kernels' operators
    and no convolution; run, it launches the float32 kernels as the live
    float32 forward does and gives its probabilities bit for bit."""
    import shutil

    from tpu_unet_torch.infer.wrapper import Unet
    from tpu_unet_torch.kernels import launch_counts, reset_launch_counts
    from tpu_unet_torch.tools.export import ProbsForward, load_program

    u = Unet(model=model, num_classes=21, input_shape=[256, 256])
    path = str(tmp_path / "m.pt2")
    reset_launch_counts()
    u.convert_to_export(path)
    assert not any(launch_counts.values())  # tracing launches nothing
    targets = [str(n.target) for n in torch.export.load(path).graph.nodes
               if n.op == "call_function"]
    assert not any("conv" in t and not t.startswith("tpu_unet_torch.") for t in targets)
    x = torch.rand((1, 256, 256, 3), generator=cuda, device="cuda")
    run = load_program(path)
    reset_launch_counts()
    out = run(x)
    torch.cuda.synchronize()
    want = {k: expect.get(k, 0) for k in launch_counts}
    assert dict(launch_counts) == want
    reset_launch_counts()
    with torch.no_grad():
        live = ProbsForward(u.net)(x)
    assert dict(launch_counts) == want
    assert torch.equal(out, live)
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.gpu
def test_quantized_apply_matches_plain(cuda):
    """``quantized_apply`` of unet_vgg at 256², batch 2, on the float32
    kernels against the plain float32 forward with the same dequantized
    weights (TF32 off), within the float32 conv bound."""
    from chip_smoke import plain_on_card

    from tpu_unet_torch.infer.wrapper import Unet
    from tpu_unet_torch.kernels import launch_counts, reset_launch_counts, tf32
    from tpu_unet_torch.tools.quantization import (dequantize_params, quantize_variables,
                                                   quantized_apply)

    u = Unet(model="unet_vgg", num_classes=21, input_shape=[256, 256])
    bundle = quantize_variables(u.net)
    x = torch.rand((2, 256, 256, 3), generator=cuda, device="cuda")
    reset_launch_counts()
    out = quantized_apply(u.net, bundle, x)
    torch.cuda.synchronize()
    assert launch_counts["vgg_stem_f32"] == 1 and launch_counts["unetup_f32"] == 4
    state = {**dequantize_params(bundle["quantized"], bundle["rest"]), **bundle["batch_stats"]}
    with torch.no_grad(), plain_on_card():
        ref = torch.func.functional_call(u.net, state, (x,))
    assert _rel(out, ref) <= tf32.CONV_REL_TOL
