"""Model summary. Counterpart of ``paddle_tpu/hapi/model_summary.py``
(``summary``, ``flops``).

``summary`` runs one forward in eval mode under ``torch.no_grad`` with a
``register_forward_hook`` on every leaf module, prints the reference's
table (type, module path, output shape, the module's own parameter count)
and returns ``{'total_params', 'trainable_params'}`` over
``net.parameters()`` (a tied weight counts once). Inputs are zeros of
``input_size`` (None or -1 read as 1) in ``dtypes`` (default float32) on
the device of the net's first parameter, or ``input``. ``flops`` counts,
by the reference's formula, 2 x k x (in / groups) x out x the output's
spatial size x the batch for each ``Conv1D/2D/3D`` call (its output's
spatial axes read by its ``data_format``) and 2 x in x out for each
``Linear`` call.
"""
import math

import torch

__all__ = ['summary', 'flops']


def _device_of(net):
    p = next(iter(net.parameters()), None)
    return p.device if p is not None else torch.device('cpu')


def _zeros(size, dtype, device):
    return torch.zeros([1 if s in (None, -1) else s for s in size],
                       dtype=getattr(torch, dtype), device=device)


def _run(net, inputs):
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        if was_training:
            net.train()


def summary(net, input_size=None, dtypes=None, input=None):
    rows = []
    hooks = []

    def register(module, prefix):
        def hook(m, inputs, output):
            out = output[0] if isinstance(output, (list, tuple)) else output
            n_params = sum(p.numel() for p in m.parameters(recurse=False))
            rows.append((type(m).__name__, prefix,
                         list(out.shape) if isinstance(out, torch.Tensor)
                         else '-', n_params))
        hooks.append(module.register_forward_hook(hook))

    for name, m in net.named_modules():
        if name and not list(m.children()):
            register(m, name)

    if input is None:
        if isinstance(input_size, tuple) and input_size and \
                isinstance(input_size[0], (tuple, list)):
            sizes = input_size
        else:
            sizes = [input_size]
        dts = dtypes or ['float32'] * len(sizes)
        device = _device_of(net)
        inputs = [_zeros(size, dt, device) for size, dt in zip(sizes, dts)]
    else:
        inputs = input if isinstance(input, (list, tuple)) else [input]
    try:
        _run(net, inputs)
    finally:
        for h in hooks:
            h.remove()

    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    header = (f"{'Layer (type)':<28}{'Name':<28}{'Output Shape':<22}"
              f"{'Param #':<12}")
    print('-' * len(header))
    print(header)
    print('=' * len(header))
    for t, n, s, p in rows:
        print(f"{t:<28}{n:<28}{str(s):<22}{p:<12}")
    print('=' * len(header))
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print('-' * len(header))
    return {'total_params': int(total), 'trainable_params': int(trainable)}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Rough FLOPs of one forward on zeros of ``input_size``: 2 x k x
    (in / groups) x out x spatial x batch a convolution, 2 x in x out a
    ``Linear`` call."""
    from ..nn import Conv1D, Conv2D, Conv3D, Linear
    total = [0]
    hooks = []

    def conv_hook(m, inputs, output):
        out = output[0] if isinstance(output, (list, tuple)) else output
        spatial = out.shape[1:-1] if not m._data_format.startswith('NC') \
            else out.shape[2:]
        total[0] += 2 * math.prod(m._kernel_size) * \
            (m._in_channels // m._groups) * m._out_channels * \
            math.prod(spatial) * out.shape[0]

    def linear_hook(m, inputs, output):
        total[0] += 2 * m.in_features * m.out_features

    for m in net.modules():
        if isinstance(m, (Conv1D, Conv2D, Conv3D)):
            hooks.append(m.register_forward_hook(conv_hook))
        elif isinstance(m, (Linear, torch.nn.Linear)):
            hooks.append(m.register_forward_hook(linear_hook))
    try:
        _run(net, [_zeros(input_size, 'float32', _device_of(net))])
    finally:
        for h in hooks:
            h.remove()
    if print_detail:
        print(f"Total FLOPs: {total[0]:,}")
    return total[0]
