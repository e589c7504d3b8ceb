"""Stub of uav_airvision_tpu_torch/kernels.py for the frozen plain reference.

The reference runs on CPU tensors only, where every wrapper takes its plain
PyTorch version and never reaches a kernel; anything that would launch one
raises.
"""

SMEM_PER_BLOCK = 232448 - 1024


def observe(name, args):
    """No observer in the reference."""


def _no_kernel(*args, **kwargs):
    raise RuntimeError("the plain reference runs on CPU tensors only: no CUDA kernel")


launch = check_cuda = per_instance = ptr = int64s = int32s = _no_kernel
