"""Layer containers. Counterpart of ``paddle_tpu/nn/layer/container.py``
(``Sequential``, ``LayerList``).

The reference names a container's children ``'0'``, ``'1'``, ...
(``add_sublayer(str(idx), layer)``), as ``torch.nn.Sequential`` and
``torch.nn.ModuleList`` do, so state-dict keys such as
``blocks.0.mlp.2.weight`` are the reference's and ``interop`` moves them
unchanged: the two are PyTorch's own.
"""
from torch import nn

__all__ = ['Sequential', 'LayerList']

Sequential = nn.Sequential
LayerList = nn.ModuleList
