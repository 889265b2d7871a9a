"""``unetup_train_full`` (the port of ``fused_unetup_train_paired``, up1's
training stage in JAX's default configuration) against JAX's custom VJP,
Pallas in interpret mode, at the shapes of ``tests/test_decoder_train.py``:
the forward and all six gradients for one numpy cotangent.  JAX's output is
column-paired, (B, 2H, W, 2F), the free reshape of the port's natural
(B, 2H, 2W, F).  The port runs on its plain versions (CPU tensors).

- (1, 8, 8, 8, 16, 8): #14 with #19 (``_overlap_add_windows``), holding
  every gradient within 1e-4 of max |JAX| (float32 sums in another order,
  as JAX's own test holds #14 to its reference at 2e-4);
- (1, 8, 8, 64, 128, 64) with ``set_lowres_bwd_paired(True)``: #15, the
  low-res schedule (the lerp commuted past conv1), within 5e-4 of max |JAX|
  as JAX's own test holds it."""
import pytest
from _torch_stage import compare_with_jax, stage_case

from tpu_unet.core import fusion
from tpu_unet.kernels.decoder_fuse import fused_unetup_train_paired
from tpu_unet_torch.kernels.decoder_fuse import unetup_train_full


def test_paired_full_resolution_matches_jax():
    """#14 + #19."""
    args, g = stage_case(21, 1, 8, 8, 8, 16, 8)
    compare_with_jax(fused_unetup_train_paired, unetup_train_full, args, g, 1e-4)


@pytest.fixture
def lowres_paired():
    fusion.set_lowres_bwd_paired(True)
    yield
    fusion.set_lowres_bwd_paired(None)


def test_paired_lowres_matches_jax(lowres_paired):
    """#15 (its gate: 2F and Cx multiples of 128)."""
    args, g = stage_case(22, 1, 8, 8, 64, 128, 64, scale=0.05)
    compare_with_jax(fused_unetup_train_paired, unetup_train_full, args, g, 5e-4)
