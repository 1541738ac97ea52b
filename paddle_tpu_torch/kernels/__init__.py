"""Hand-written CUDA kernels of the port. Counterpart of
``paddle_tpu/kernels/``.

Each kernel module holds the CUDA wrapper, the plain PyTorch version that
CPU tensors take, and ``launches``, a count of kernel launches that
``launch_counts``/``reset_launch_counts`` read and zero, so a run can show
which kernels its path went through. The CUDA sources live in ``csrc/``
and are built by ``_build`` at first use.
"""
from . import flash_attention, fused_dropout_norm, fused_norm

__all__ = ['KERNEL_MODULES', 'launch_counts', 'reset_launch_counts']

KERNEL_MODULES = {
    'flash_attention_fwd': flash_attention,
    'layer_norm_fwd': fused_norm,
    'add_layer_norm_fwd': fused_dropout_norm,
}


def launch_counts():
    """-> {kernel name: launches since the last reset}."""
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts():
    for mod in KERNEL_MODULES.values():
        mod.launches = 0
