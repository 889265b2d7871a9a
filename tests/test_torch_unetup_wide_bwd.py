"""``unetup_train_full`` (the port of ``fused_unetup_train_wide``, the
F ≥ 128 training stages in JAX's default configuration) against JAX's
custom VJP, Pallas in interpret mode, at the shapes of
``tests/test_decoder_train.py``: the forward and all six gradients for one
numpy cotangent (JAX's output is natural here).  The port runs on its plain
versions (CPU tensors).

- (1, 8, 8, 128, 128, 128): #16 with #19 (``_overlap_add_windows``), every
  gradient within 1e-4 of max |JAX| (JAX's own test holds #16 at 2e-5 of
  its reference; the port's float32 sums run in another order again);
- (1, 8, 8, 128, 256, 128) with ``set_lowres_up(True)``,
  ``set_lowres_bwd(True)`` and ``TPU_UNET_LOWRES_BWD_SHALLOW=1`` (without
  it JAX takes the full-resolution kernel at F = 128,
  decoder_train.py:1356-1359): #17 with #18 (``_repack_wgrad``), within
  5e-4 of max |JAX| as JAX's own test holds it."""
import pytest
from _torch_stage import compare_with_jax, stage_case

from tpu_unet.core import fusion
from tpu_unet.kernels.decoder_fuse import fused_unetup_train_wide
from tpu_unet_torch.kernels.decoder_fuse import unetup_train_full


def test_wide_full_resolution_matches_jax():
    """#16 + #19."""
    args, g = stage_case(31, 1, 8, 8, 128, 128, 128)
    compare_with_jax(fused_unetup_train_wide, unetup_train_full, args, g, 1e-4)


@pytest.fixture
def lowres_wide(monkeypatch):
    monkeypatch.setenv("TPU_UNET_LOWRES_BWD_SHALLOW", "1")
    fusion.set_lowres_up(True)
    fusion.set_lowres_bwd(True)
    yield
    fusion.set_lowres_up(None)
    fusion.set_lowres_bwd(None)


def test_wide_lowres_matches_jax(lowres_wide):
    """#17 + #18."""
    args, g = stage_case(32, 1, 8, 8, 128, 256, 128, scale=0.05)
    compare_with_jax(fused_unetup_train_wide, unetup_train_full, args, g, 5e-4)
