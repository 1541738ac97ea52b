"""``save`` / ``load`` of nested state. Counterpart of
``paddle_tpu/framework.py`` (``save``, ``load``, ``_to_saveable``,
``_from_saveable``, ``_TensorPayload``).

Tensors are pickled as numpy payloads (``_TensorPayload``: the array, and
whether it was an ``nn.Parameter``), never as torch storages, so a file
holds no device and loads without CUDA. numpy has no bfloat16: a bf16
tensor is stored as its 16-bit words (``uint16``) with ``dtype =
'bfloat16'`` named on the payload, and comes back bit for bit. Writes go
through ``resilience.atomic_io`` (same-directory temp, fsync,
``os.replace``): a crash mid-save leaves the previous file whole, and a
torn file raises the reference's message.
"""
import pickle

import numpy as np
import torch

__all__ = ['save', 'load']

BF16 = 'bfloat16'


class _TensorPayload:
    __slots__ = ('array', 'is_param', 'name', 'dtype')

    def __init__(self, array, is_param=False, name=None, dtype=None):
        self.array = array
        self.is_param = is_param
        self.name = name
        self.dtype = dtype        # 'bfloat16' when ``array`` holds its words


def tensor_to_numpy(t):
    """``(numpy array, dtype name or None)`` of a tensor on any device: a
    bf16 tensor as its ``uint16`` words and ``'bfloat16'``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    return t.numpy(), None


def numpy_to_tensor(array, dtype=None):
    """The inverse of ``tensor_to_numpy``: a CPU tensor (bf16 from its
    words when ``dtype == 'bfloat16'``)."""
    array = np.array(array, order='C')        # a copy; keeps 0-dim shapes
    if dtype == BF16:
        return torch.from_numpy(array.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(array)


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        array, dtype = tensor_to_numpy(obj)
        return _TensorPayload(np.array(array, copy=True),
                              is_param=isinstance(obj, torch.nn.Parameter),
                              dtype=dtype)
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_to_saveable(v) for v in obj)
    return obj


def _from_saveable(obj, return_numpy=False):
    """Payloads back to CPU tensors (``nn.Parameter`` where they were one),
    or with ``return_numpy`` to numpy arrays — except bf16 ones, which
    numpy cannot hold and which come back as bf16 tensors."""
    if isinstance(obj, _TensorPayload):
        if return_numpy and obj.dtype != BF16:
            return obj.array
        t = numpy_to_tensor(obj.array, obj.dtype)
        return torch.nn.Parameter(t, requires_grad=t.is_floating_point()) \
            if obj.is_param else t
    if isinstance(obj, dict):
        return {k: _from_saveable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_from_saveable(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """paddle.save — pickles nested state (tensors -> numpy payloads),
    committed atomically."""
    from .resilience.atomic_io import atomic_pickle_dump
    atomic_pickle_dump(_to_saveable(obj), path, protocol=protocol)


def load(path, **configs):
    """paddle.load — counterpart of ``save()`` (``return_numpy=True`` for
    numpy leaves); also reads ``.npz`` archives."""
    return_numpy = configs.get('return_numpy', False)
    path = str(path)
    if path.endswith('.npz'):
        data = np.load(path, allow_pickle=True)
        return {k: data[k] for k in data.files}
    try:
        with open(path, 'rb') as f:
            payload = pickle.load(f)
    except (EOFError, pickle.UnpicklingError) as e:
        raise RuntimeError(
            "paddle.load: %r is truncated or corrupt (%s). Files written by "
            "this build commit atomically, so this usually means an external "
            "copy was torn; for rotating checkpoints with automatic fallback "
            "to the last good one, use resilience.CheckpointManager."
            % (path, e)) from e
    return _from_saveable(payload, return_numpy)
