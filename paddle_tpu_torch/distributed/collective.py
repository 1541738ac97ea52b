"""Collectives over the process group. Counterpart of
``paddle_tpu/distributed/collective.py``.

The reference runs its collectives inside a traced region on a named mesh
axis (``lax.psum`` and friends), or, eagerly on a replicated value, in a
closed form (``all_reduce`` SUM gives ``v * n``). The port has one process
a rank, and each collective here is ``torch.distributed``'s on the group
``env.init_parallel_env`` joined (NCCL for CUDA tensors, gloo for CPU
ones). A rank holding the value the reference's replicated eager value
holds gets the reference's answer; ranks holding different values get
what the reference's ``shard_map`` collectives give.

- No process group, no collectives: without one each call returns its
  input as one rank's answer (``all_gather`` a list of one), as the
  reference's does without a mesh. With a group of any size the
  collective is issued, world 1 included.
- ``ReduceOp`` (and the fleet metrics' strings ``'sum'``, ``'max'``,
  ``'min'``, ``'prod'``): PROD gathers every rank's value and multiplies
  them in rank order, exact for signs, zeros and integer dtypes, as the
  reference's ``_pprod``.
- Every collective is counted (``collective_counts()``: calls and payload
  bytes an op, always on; and ``observability.record_collective`` while
  telemetry is on) and runs under the deadline (``deadline``): with none
  set it is issued in stream order and nothing waits for it, so a
  collective adds no host sync.
- ``ppermute`` and ``in_jit_all_reduce`` exist only inside a traced region
  in the reference; the port has none: ``in_jit_all_reduce`` raises, and
  the ring shift ``ppermute`` waits for ROADMAP.md Queue 1 item 5b.
- ``reduce_scatter_tensor`` / ``all_gather_into_tensor`` are feature-
  detected against their newer names (``reduce_scatter_single``,
  ``all_gather_single``), so both the installed torches work.
"""
import numpy as np
import torch
import torch.distributed as dist

from .. import observability as _obs
from . import deadline as _deadline
from . import env

__all__ = ['ReduceOp', 'all_reduce', 'all_gather', 'broadcast', 'reduce',
           'scatter', 'reduce_scatter', 'alltoall', 'all_to_all', 'barrier',
           'send', 'recv', 'ppermute', 'split_group', 'new_group',
           'in_jit_all_reduce', 'collective_counts',
           'reset_collective_counts']


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3


_OP_ALIASES = {'sum': ReduceOp.SUM, 'max': ReduceOp.MAX, 'min': ReduceOp.MIN,
               'prod': ReduceOp.PROD, 'product': ReduceOp.PROD}
_TORCH_OP = {ReduceOp.SUM: 'SUM', ReduceOp.MAX: 'MAX', ReduceOp.MIN: 'MIN'}


def _normalize_op(op):
    if isinstance(op, str):
        op = _OP_ALIASES.get(op.lower(), op)
    if op not in (ReduceOp.SUM, ReduceOp.MAX, ReduceOp.MIN, ReduceOp.PROD):
        raise ValueError(f"unknown reduce op {op!r}; expected one of "
                         f"{sorted(_OP_ALIASES)} or a ReduceOp constant")
    return op


def _torch_op(op):
    return getattr(dist.ReduceOp, _TORCH_OP[op])


_gather_single = getattr(dist, 'all_gather_single', None) or \
    dist.all_gather_into_tensor
_scatter_single = getattr(dist, 'reduce_scatter_single', None) or \
    dist.reduce_scatter_tensor

# calls and payload bytes of each collective op this process issued
_counts = {}


def collective_counts():
    """``{op: {'calls': n, 'bytes': b}}`` since the last reset."""
    return {op: dict(c) for op, c in _counts.items()}


def reset_collective_counts():
    _counts.clear()


def _group(group):
    """A group argument -> the ``torch.distributed`` group (None: the
    default one). An int or an axis name is the reference's axis."""
    if group is None or isinstance(group, (int, str)):
        return None
    return group


def _issue(op, nbytes, launch, group=None):
    """Count one ``op`` of ``nbytes`` and issue it under the deadline."""
    c = _counts.setdefault(op, {'calls': 0, 'bytes': 0})
    c['calls'] += 1
    c['bytes'] += int(nbytes)
    _obs.record_collective(op, nbytes)
    _deadline.run_with_deadline(op, launch, group=group)


def _nbytes(t):
    return t.numel() * t.element_size()


def _as_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x))


def _gather_stack(t, g):
    """Every rank's ``t`` stacked on a new leading axis, in rank order."""
    n = dist.get_world_size(g)
    # the concatenated form of the output: what every backend takes
    out = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
    src = t.contiguous().reshape(-1)
    _issue('all_gather', _nbytes(t),
           lambda a: _gather_single(out, src, group=g, async_op=a), g)
    return out.view((n,) + tuple(t.shape))


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the ranks, in place; returns it (a new tensor
    for a numpy input)."""
    op = _normalize_op(op)
    t = _as_tensor(tensor)
    if not env.is_initialized():
        return t
    g = _group(group)
    if op == ReduceOp.PROD:
        t.copy_(_gather_stack(t, g).prod(dim=0).to(t.dtype))
        return t
    _issue('all_reduce', _nbytes(t),
           lambda a: dist.all_reduce(t, _torch_op(op), group=g, async_op=a),
           g)
    return t


def in_jit_all_reduce(value, axis=None, op=ReduceOp.SUM):
    raise NotImplementedError(
        "in_jit_all_reduce: the reference's collective inside a traced "
        "(jit/shard_map) region; the port runs eagerly, one process a "
        "rank: call all_reduce")


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=None):
    """Every rank's ``tensor``: appended to ``tensor_list`` (when given)
    and returned stacked on a new leading axis."""
    t = _as_tensor(tensor)
    if not env.is_initialized():
        out = t.unsqueeze(0)
    else:
        out = _gather_stack(t, _group(group))
    if tensor_list is not None:
        tensor_list.extend(out.unbind(0))
    return out


def broadcast(tensor, src=0, group=None, sync_op=True):
    """``src``'s ``tensor`` on every rank, in place."""
    t = _as_tensor(tensor)
    if env.is_initialized():
        g = _group(group)
        _issue('broadcast', _nbytes(t),
               lambda a: dist.broadcast(t, src, group=g, async_op=a), g)
    return t


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction of ``tensor`` over the ranks, in place on ``dst``
    (the other ranks' tensors are left as the backend leaves them)."""
    op = _normalize_op(op)
    t = _as_tensor(tensor)
    if not env.is_initialized():
        return t
    g = _group(group)
    if op == ReduceOp.PROD:
        t.copy_(_gather_stack(t, g).prod(dim=0).to(t.dtype))
        return t
    _issue('reduce', _nbytes(t),
           lambda a: dist.reduce(t, dst, _torch_op(op), group=g,
                                 async_op=a), g)
    return t


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank ``r``'s ``tensor`` becomes ``src``'s ``tensor_list[r]``."""
    t = _as_tensor(tensor)
    if not env.is_initialized():
        if tensor_list:
            t.copy_(_as_tensor(tensor_list[0]))
        return t
    g = _group(group)
    parts = None
    if dist.get_rank() == src:
        parts = [_as_tensor(x).to(t.device, t.dtype).contiguous()
                 for x in tensor_list]
    _issue('scatter', _nbytes(t),
           lambda a: dist.scatter(t, parts, src=src, group=g, async_op=a), g)
    return t


def reduce_scatter(output, input, op=ReduceOp.SUM, group=None, axis=None):
    """``input`` (a tensor whose leading dim is world x ``output``'s, or a
    list of world tensors) reduced over the ranks; rank ``r`` keeps block
    ``r`` in ``output`` (made when None) and gets it back."""
    op = _normalize_op(op)
    if isinstance(input, (list, tuple)):
        inp = torch.cat([_as_tensor(x) for x in input])
    else:
        inp = _as_tensor(input)
    if not env.is_initialized():
        if output is None:
            return inp
        output.copy_(inp.reshape(output.shape))
        return output
    g = _group(group)
    n = dist.get_world_size(g)
    if output is None:
        output = torch.empty((inp.shape[0] // n,) + tuple(inp.shape[1:]),
                             dtype=inp.dtype, device=inp.device)
    if op == ReduceOp.PROD:
        full = _gather_stack(inp, g).prod(dim=0).to(inp.dtype)
        output.copy_(full.chunk(n)[dist.get_rank(g)].reshape(output.shape))
        return output
    src = inp.contiguous()
    _issue('reduce_scatter', _nbytes(src),
           lambda a: _scatter_single(output, src, _torch_op(op), group=g,
                                     async_op=a), g)
    return output


def alltoall(in_tensor_list, out_tensor_list=None, group=None, axis=None):
    """Rank ``r`` sends its ``in_tensor_list[j]`` to rank ``j`` and gets
    every rank's block ``r``, in rank order -> the list of them."""
    stacked = torch.stack([_as_tensor(x) for x in in_tensor_list])
    if not env.is_initialized():
        outs = list(stacked.unbind(0))
    else:
        g = _group(group)
        out = torch.empty_like(stacked)
        _issue('alltoall', _nbytes(stacked),
               lambda a: dist.all_to_all_single(out, stacked, group=g,
                                                async_op=a), g)
        outs = list(out.unbind(0))
    if out_tensor_list is not None:
        out_tensor_list.extend(outs)
    return outs


all_to_all = alltoall


def ppermute(value, perm, axis=None):
    raise NotImplementedError(
        "ppermute: the ring shift of ring attention and pipelines waits for "
        "ROADMAP.md, Queue 1 item 5b")


def send(tensor, dst=0, group=None, sync_op=True):
    """Point to point: ``tensor`` to rank ``dst``."""
    t = _as_tensor(tensor).contiguous()
    g = _group(group)
    _issue('send', _nbytes(t),
           lambda a: (dist.isend if a else dist.send)(t, dst, group=g), g)


def recv(tensor, src=0, group=None, sync_op=True):
    """Point to point: ``tensor`` filled from rank ``src``, in place."""
    t = _as_tensor(tensor)
    g = _group(group)
    _issue('recv', _nbytes(t),
           lambda a: (dist.irecv if a else dist.recv)(t, src, group=g), g)
    return t


def barrier(group=None):
    """Block until every rank reaches the barrier: a one-element
    all-reduce on the group's device whose result the host waits for.
    Under the deadline a barrier that cannot complete raises
    ``DistributedTimeoutError`` naming the op and the ranks whose
    heartbeats went stale."""
    if not env.is_initialized():
        return
    g = _group(group)
    flag = torch.zeros(1, device=env.device())
    _issue('barrier', _nbytes(flag),
           lambda a: dist.all_reduce(flag, group=g, async_op=a), g)
    flag.cpu()


def new_group(ranks=None, backend=None):
    """A group of ``ranks`` (all by default) of the process group; None
    without one."""
    if not env.is_initialized():
        return None
    return dist.new_group(ranks=ranks)


def split_group(*a, **k):
    return new_group()
