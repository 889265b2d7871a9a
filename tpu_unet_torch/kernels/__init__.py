"""The port's hand-written CUDA kernels and their plain PyTorch versions.

Each module holds its kernels' dispatching wrappers (plain version for CPU
tensors; the CUDA kernel, or an error, for tensors on the card), their plain
versions, and their launch counts in ``_build.launch_counts``.
"""
from tpu_unet_torch.kernels._build import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
