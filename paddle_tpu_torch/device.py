"""Device resolution. Counterpart of ``paddle_tpu/core/place.py``.

The reference resolves its accelerator place from the JAX backend. The
port's entry points take a ``device`` argument instead: ``None`` means the
CUDA device, and a machine without one is an error, never a quiet fall
back to the CPU (a CPU run would look like a working port and measure
nothing). Tests and CPU users say ``device='cpu'`` explicitly.
"""
import torch

__all__ = ['resolve_device']


def resolve_device(device=None):
    """-> ``torch.device``. ``None`` resolves to the current CUDA device;
    raises ``RuntimeError`` when CUDA is asked for and absent."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch: no CUDA device is available; entry "
                "points run on the GPU unless you pass device='cpu' (the "
                "plain PyTorch path on the CPU)")
        if device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
    return device
