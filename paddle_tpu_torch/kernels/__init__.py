"""Hand-written CUDA kernels of the port. Counterpart of
``paddle_tpu/kernels/``.

Each kernel module holds the CUDA wrappers, the ``torch.autograd.Function``
that joins a forward kernel to its backward, and the plain PyTorch versions
that CPU tensors take. ``philox`` is the dropout-mask generator all of them
share. The CUDA sources live in ``csrc/`` and are built by ``_build`` at
first use; ``_build`` also counts each kernel's launches, which
``launch_counts``/``reset_launch_counts`` read and zero, so a run can show
which kernels its path went through. ``plain_versions()`` sends CUDA
tensors to the plain versions, for tests and ``chip_smoke.py`` only.
"""
from . import (_build, flash_attention, fused_dropout_norm, fused_norm,
               philox)
from ._build import KERNELS, plain_versions

__all__ = ['KERNELS', 'launch_counts', 'reset_launch_counts',
           'plain_versions']


def launch_counts():
    """-> {kernel name: launches since the last reset}."""
    return dict(_build.launches)


def reset_launch_counts():
    for name in _build.launches:
        _build.launches[name] = 0
