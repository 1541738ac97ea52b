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
- every collective takes ``axis=`` (or the axis name as ``group``, the
  reference's spelling): it runs on that mesh axis's process group
  (``env.axis_group``; default the data axis), and is counted as
  ``'<axis>.<op>'`` on any other axis (``'model.all_reduce'``); on an axis
  of one rank, or one the mesh lacks, it is the identity, as the
  reference's;
- ``ppermute`` (the ring shift of ring attention and the pipeline) is an
  eager ``batch_isend_irecv``; ``in_jit_all_reduce`` exists only inside a
  traced region in the reference, which the port has none of: it raises;
- a gloo group that holds CUDA tensors (two ranks of one card: NCCL
  refuses them) takes no point to point, so ``ppermute`` there is an
  all-gather (``gloo_cuda``), counted, and ``send`` / ``recv`` refuse.
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
    """A ``torch.distributed`` group argument -> the group (None: the
    default one)."""
    if group is None or isinstance(group, (int, str)):
        return None
    return group


def _resolve(group=None, axis=None):
    """``(process group, its size, the op's counter prefix)`` of a
    collective's ``group`` / ``axis``. An axis name (``axis=``, or a string
    ``group``, the reference's spelling), or None / an int (the reference:
    the data axis), runs on that mesh axis's group; a process group runs on
    itself. Ops on any axis but the data axis count as ``'<axis>.<op>'``."""
    if group is not None and not isinstance(group, (int, str)):
        return group, dist.get_world_size(group), ''
    ax = axis or (group if isinstance(group, str) else env.DATA_AXIS)
    g, n, _ = env.axis_group(ax)
    return g, n, '' if ax == env.DATA_AXIS else f'{ax}.'


def gloo_cuda(t, g):
    """True for a CUDA tensor on a gloo group (two ranks of one card: NCCL
    refuses them). Such a group takes CUDA tensors in every collective
    but point to point (``probe_gloo_cuda.py`` on an H100, torch 2.11:
    all_reduce, broadcast, all_gather, reduce_scatter, all_to_all and
    reduce give the right values; send / recv fail, ``writev: Bad
    address``, or abort the process), so ``ppermute`` there gathers every
    rank's value and keeps its source's (``_ppermute``), the one path it
    takes, counted as ``gloo_cuda`` in ``collective_counts()`` and, while
    telemetry is on, as ``host_transfer.collective.gloo_cuda`` (gloo
    stages CUDA tensors through host memory: each byte down and back
    up); ``send`` / ``recv`` refuse."""
    return t.is_cuda and 'nccl' not in str(dist.get_backend(g))


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


def _gather_stack(t, g, prefix=''):
    """Every rank's ``t`` stacked on a new leading axis, in rank order."""
    n = dist.get_world_size(g)
    src = t.contiguous().reshape(-1)
    # the concatenated form of the output: what every backend takes
    out = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
    _issue(prefix + 'all_gather', _nbytes(t),
           lambda a: _gather_single(out, src, group=g, async_op=a), g)
    return out.view((n,) + tuple(t.shape))


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               axis=None):
    """Reduce ``tensor`` over the ranks of ``group`` / ``axis`` (default:
    the data axis; an axis of one rank leaves it as it is), in place;
    returns it (a new tensor for a numpy input)."""
    op = _normalize_op(op)
    t = _as_tensor(tensor)
    if not env.is_initialized():
        return t
    g, n, prefix = _resolve(group, axis)
    if g is env.SINGLE:
        return t
    if op == ReduceOp.PROD:
        t.copy_(_gather_stack(t, g, prefix).prod(dim=0).to(t.dtype))
        return t
    _issue(prefix + 'all_reduce', _nbytes(t),
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
    g, _, prefix = _resolve(group, axis)
    if g is env.SINGLE:
        out = t.unsqueeze(0)
    else:
        out = _gather_stack(t, g, prefix)
    if tensor_list is not None:
        tensor_list.extend(out.unbind(0))
    return out


def _global_rank(index, group, axis):
    """The global rank of rank ``index`` of an axis's group (``group``
    given as a process group: ``index`` is already global)."""
    if group is not None and not isinstance(group, (int, str)):
        return index
    ax = axis or (group if isinstance(group, str) else env.DATA_AXIS)
    return env.axis_ranks(ax)[index]


def broadcast(tensor, src=0, group=None, sync_op=True, axis=None):
    """``src``'s ``tensor`` on every rank, in place (``src``: the rank's
    index on ``axis``, or its global rank in a process group)."""
    t = _as_tensor(tensor)
    if env.is_initialized():
        g, _, prefix = _resolve(group, axis)
        if g is not env.SINGLE:
            root = _global_rank(src, group, axis)
            _issue(prefix + 'broadcast', _nbytes(t),
                   lambda a: dist.broadcast(t, root, group=g, async_op=a), g)
    return t


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True,
           axis=None):
    """The reduction of ``tensor`` over the ranks, in place on ``dst``
    (the other ranks' tensors are left as the backend leaves them)."""
    op = _normalize_op(op)
    t = _as_tensor(tensor)
    if not env.is_initialized():
        return t
    g, _, prefix = _resolve(group, axis)
    if g is env.SINGLE:
        return t
    if op == ReduceOp.PROD:
        t.copy_(_gather_stack(t, g, prefix).prod(dim=0).to(t.dtype))
        return t
    root = _global_rank(dst, group, axis)
    _issue(prefix + 'reduce', _nbytes(t),
           lambda a: dist.reduce(t, root, _torch_op(op), group=g,
                                 async_op=a), g)
    return t


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True,
            axis=None):
    """Rank ``r``'s ``tensor`` becomes ``src``'s ``tensor_list[r]``."""
    t = _as_tensor(tensor)
    g, _, prefix = _resolve(group, axis)
    if g is env.SINGLE:
        if tensor_list:
            t.copy_(_as_tensor(tensor_list[0]))
        return t
    root = _global_rank(src, group, axis)
    parts = None
    if dist.get_rank() == root:
        parts = [_as_tensor(x).to(t.device, t.dtype).contiguous()
                 for x in tensor_list]
    _issue(prefix + 'scatter', _nbytes(t),
           lambda a: dist.scatter(t, parts, src=root, group=g, async_op=a),
           g)
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
    g, n, prefix = _resolve(group, axis)
    if g is env.SINGLE:
        if output is None:
            return inp
        output.copy_(inp.reshape(output.shape))
        return output
    if output is None:
        output = torch.empty((inp.shape[0] // n,) + tuple(inp.shape[1:]),
                             dtype=inp.dtype, device=inp.device)
    if op == ReduceOp.PROD:
        full = _gather_stack(inp, g, prefix).prod(dim=0).to(inp.dtype)
        output.copy_(full.chunk(n)[dist.get_rank(g)].reshape(output.shape))
        return output
    src = inp.contiguous()
    _issue(prefix + 'reduce_scatter', _nbytes(src),
           lambda a: _scatter_single(output, src, _torch_op(op), group=g,
                                     async_op=a), g)
    return output


def alltoall(in_tensor_list, out_tensor_list=None, group=None, axis=None):
    """Rank ``r`` sends its ``in_tensor_list[j]`` to rank ``j`` and gets
    every rank's block ``r``, in rank order -> the list of them."""
    stacked = torch.stack([_as_tensor(x) for x in in_tensor_list])
    g, _, prefix = _resolve(group, axis)
    if g is env.SINGLE:
        outs = list(stacked.unbind(0))
    else:
        out = torch.empty_like(stacked)
        _issue(prefix + 'alltoall', _nbytes(stacked),
               lambda a: dist.all_to_all_single(out, stacked, group=g,
                                                async_op=a), g)
        outs = list(out.unbind(0))
    if out_tensor_list is not None:
        out_tensor_list.extend(outs)
    return outs


all_to_all = alltoall


def _check_perm(perm, n):
    pairs = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or \
            any(not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute: {list(perm)} is not a permutation of "
                         f"part of the {n} ranks of the axis (each rank "
                         f"sends once and receives once at most)")
    return pairs


@torch.no_grad()
def _ppermute(t, pairs, axis):
    g, n, prefix = _resolve(None, axis)
    me = env.get_rank(axis) if g is not env.SINGLE else 0
    send = next((d for s, d in pairs if s == me), None)
    src = next((s for s, d in pairs if d == me), None)
    out = torch.zeros_like(t)
    if g is env.SINGLE:
        if src == me:
            out.copy_(t)
        return out
    if gloo_cuda(t, g):
        # no point to point for CUDA tensors on gloo: every rank's value
        every = _gather_stack(t, g, prefix + 'ppermute.')
        c = _counts.setdefault('gloo_cuda', {'calls': 0, 'bytes': 0})
        c['calls'] += 1
        c['bytes'] += _nbytes(every)
        _obs.record_host_transfer(2 * _nbytes(every),
                                  kind='collective.gloo_cuda')
        if src is not None:
            out.copy_(every[src])
        return out
    if src == me:                  # a rank's pair with itself
        out.copy_(t)
        return out
    ranks = env.axis_ranks(axis)
    value = t.contiguous()
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, value, ranks[send], g))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out, ranks[src], g))

    def launch(a):
        works = dist.batch_isend_irecv(ops) if ops else []
        for w in works:
            w.wait()
    _issue(prefix + 'ppermute',
           _nbytes(value) if send is not None else 0, launch, g)
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, pairs, axis):
        ctx.pairs, ctx.axis = pairs, axis
        return _ppermute(t, pairs, axis)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.pairs]
        return _ppermute(g.contiguous(), back, ctx.axis), None, None


def ppermute(value, perm, axis=None):
    """The reference's ``lax.ppermute``: ``perm`` is a list of ``(src,
    dst)`` pairs of ranks on ``axis`` (default the data axis); rank
    ``dst`` gets rank ``src``'s ``value``, and a rank no pair targets gets
    zeros. Eager, one ``batch_isend_irecv`` of this rank's send and
    receive (NCCL, or gloo on CPU tensors); a gloo group of CUDA tensors
    all-gathers every rank's value (``gloo_cuda``).
    Differentiable: the gradient travels the reversed pairs, as
    ``lax.ppermute``'s transpose."""
    t = _as_tensor(value)
    ax = axis or env.DATA_AXIS
    pairs = _check_perm(perm, env.get_world_size(ax))
    if torch.is_grad_enabled() and t.requires_grad:
        return _PPermute.apply(t, pairs, ax)
    return _ppermute(t, pairs, ax)


def send(tensor, dst=0, group=None, sync_op=True):
    """Point to point: ``tensor`` to rank ``dst``."""
    t = _as_tensor(tensor).contiguous()
    g = _group(group)
    _refuse_p2p(t, g, 'send')
    _issue('send', _nbytes(t),
           lambda a: (dist.isend if a else dist.send)(t, dst, group=g), g)


def recv(tensor, src=0, group=None, sync_op=True):
    """Point to point: ``tensor`` filled from rank ``src``, in place."""
    t = _as_tensor(tensor)
    g = _group(group)
    _refuse_p2p(t, g, 'recv')
    _issue('recv', _nbytes(t),
           lambda a: (dist.irecv if a else dist.recv)(t, src, group=g), g)
    return t


def _refuse_p2p(t, g, op):
    if env.is_initialized() and gloo_cuda(t, g):
        raise NotImplementedError(
            f"{op}: a gloo group takes no CUDA tensor point to point; "
            f"ppermute expresses the exchange with all_reduce")


def barrier(group=None):
    """Block until every rank (of ``group``, default all of them) reaches
    the barrier: a one-element all-reduce on the group's device whose
    result the host waits for. Under the deadline a barrier that cannot
    complete raises ``DistributedTimeoutError`` naming the op and the
    ranks whose heartbeats went stale."""
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
