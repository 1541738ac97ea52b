"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

A second package beside ``paddle_tpu`` (the JAX/TPU reference, which it
never imports). Module paths mirror the reference so each port module's
counterpart is easy to find; inside, the code is plain PyTorch:
``nn.Module``s, functions on tensors, an explicit ``device`` and explicit
``torch.Generator``s.

Every Pallas TPU kernel on a ported path becomes a hand-written CUDA C++
kernel for Hopper (``kernels/csrc/``), built with ``nvcc`` at first use.
On CPU tensors each kernel wrapper runs its plain PyTorch version instead.

Entry points run on the CUDA device unless the caller passes
``device='cpu'`` (``device.resolve_device``). ``save`` / ``load`` are
``framework``'s; ``Model``, ``summary`` and ``callbacks`` are ``hapi``'s,
``DataParallel`` is ``distributed``'s, as the reference exports them.
"""
from .device import resolve_device
from .distributed.parallel import DataParallel
from .framework import load, save
from .hapi import callbacks
from .hapi.model import Model
from .hapi.model_summary import summary

__all__ = ['resolve_device', 'save', 'load', 'Model', 'summary',
           'callbacks', 'DataParallel']
