"""Parameter placement over the ranks, and the FSDP layout of a train
step. Counterpart of ``paddle_tpu/distributed/sharding.py``
(``fsdp_pspecs``, ``first_divisible_spec``, ``param_pspecs``,
``shard_tensor``, ``shard_layer``).

The reference places a tensor on its mesh (``jax.device_put`` with a
``NamedSharding``) and keeps its global shape. In the port a rank holds
its own piece: ``shard_tensor(x, spec)`` returns this rank's piece of ``x``
along the dim ``spec`` puts on the data axis (``x`` itself without a
process group), and ``shard_layer`` swaps each matching parameter of a
layer for its piece. Specs are tuples of axis names and None (the
reference's ``PartitionSpec`` as a plain tuple, ``()`` for replicated).
The tensor-parallel layers (``ColumnParallelLinear``,
``RowParallelLinear``, ``VocabParallelEmbedding``) and specs on the model
axis wait for ROADMAP.md Queue 1 item 5b and raise naming it.

``FlatShards`` is the FSDP recipe of ``engine.build_train_step(sharding=)``
(ZeRO, as the reference's ``ShardingConfig``): every leaf of at least
``min_size`` elements with a dim the world divides is split along its
first such dim, each rank keeping piece ``rank``; smaller leaves stay
whole on every rank. (At world 1 every large leaf is one piece of itself,
so the step's all-gather and reduce-scatter run on the card as copies.)
The pieces of one dtype live in one flat buffer, so the step moves them
with ONE ``all_gather`` (the full parameters, at use) and ONE
``reduce_scatter`` (the gradients' sum, then divided by the world: their
mean) a dtype, and the whole leaves' gradients with one ``all_reduce``.
``norms()`` installs the cross-rank norms of the update (``nn.clip``):
each rank's per-parameter norms of its pieces are all-gathered, and a
parameter's norm is the L2 norm of its column (at world 1 the one row
itself, so the arithmetic is the unsharded step's to the bit); a whole
leaf counts on rank 0 only.
"""
import contextlib

import numpy as np
import torch

from . import env

__all__ = ['shard_tensor', 'shard_layer', 'param_pspecs', 'fsdp_pspecs',
           'first_divisible_spec', 'ColumnParallelLinear',
           'RowParallelLinear', 'VocabParallelEmbedding', 'FlatShards']


def shard_dim(shape, world, min_size):
    """THE FSDP partitioning policy, in one place: a leaf of ``shape``
    with ``min_size`` elements or more splits over ``world`` ranks along
    its first dim that ``world`` divides (at world 1, dim 0); a smaller
    leaf, or one with no such dim, stays whole (None)."""
    size = int(np.prod(shape or (1,)))
    if not shape or size < min_size:
        return None
    for d, s in enumerate(shape):
        if s % world == 0:
            return d
    return None


def first_divisible_spec(shape, n, axis_entry, min_size):
    """The policy as the reference's spec: ``axis_entry`` on the split dim
    over ``n`` ranks, ``()`` (replicated) for a whole leaf and at n = 1
    (a mesh axis of one splits nothing)."""
    dim = shard_dim(tuple(shape), n, min_size) if n > 1 else None
    if dim is None:
        return ()
    parts = [None] * len(shape)
    parts[dim] = axis_entry
    return tuple(parts)


def _shape(p):
    if isinstance(p, (tuple, list)):
        return tuple(p)
    return tuple(p.shape) if hasattr(p, 'shape') else tuple(np.shape(p))


def fsdp_pspecs(layer, axis=env.DATA_AXIS, min_size=1024, n=None):
    """ZeRO-3 style specs ``{name: spec}`` of a module's parameters (or a
    ``{name: value or shape}`` dict) over ``n`` ranks (the group's size by
    default)."""
    if n is None:
        n = env.get_world_size(axis)
    items = (layer.named_parameters() if hasattr(layer, 'named_parameters')
             else layer.items())
    return {name: first_divisible_spec(_shape(p), n, axis, min_size)
            for name, p in items}


def param_pspecs(layer, rules, default=()):
    """``{name: spec}``: the first rule whose key is a substring of the
    parameter's name, else ``default``."""
    out = {}
    for name, _ in layer.named_parameters():
        spec = default
        for pat, s in rules.items():
            if pat in name:
                spec = tuple(s)
                break
        out[name] = spec
    return out


def _data_dim(spec):
    """The dim ``spec`` puts on the data axis (None: replicated)."""
    dim = None
    for d, part in enumerate(tuple(spec)):
        parts = part if isinstance(part, tuple) else (part,)
        if env.MODEL_AXIS in parts:
            raise NotImplementedError(
                f"shard_tensor: spec {spec} uses the model axis; tensor "
                f"parallelism waits for ROADMAP.md, Queue 1 item 5b")
        if env.DATA_AXIS in parts and dim is None:
            dim = d
    return dim


def shard_tensor(x, spec):
    """This rank's piece of ``x`` along the dim ``spec`` puts on the data
    axis (``x`` itself without a process group, or for a replicated
    spec)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    dim = _data_dim(spec)
    n = env.get_world_size()
    if dim is None or n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"shard_tensor: dim {dim} of {tuple(t.shape)} is "
                         f"not divisible by the {n} ranks")
    return t.chunk(n, dim=dim)[env.get_rank()].clone()


def shard_layer(layer, rules):
    """Swap each parameter of ``layer`` matching a ``{name-substring:
    spec}`` rule for this rank's piece, in place -> ``layer``."""
    with torch.no_grad():
        for name, p in layer.named_parameters():
            for pat, spec in rules.items():
                if pat in name:
                    p.data = shard_tensor(p.data, spec)
                    break
    return layer


class _Waits5b:
    def __init__(self, *a, **k):
        raise NotImplementedError(
            f"{type(self).__name__}: the tensor-parallel layers wait for "
            f"ROADMAP.md, Queue 1 item 5b")


class ColumnParallelLinear(_Waits5b):
    pass


class RowParallelLinear(_Waits5b):
    pass


class VocabParallelEmbedding(_Waits5b):
    pass


# each piece starts on a multiple of this many elements of its flat buffer:
# a view there is as aligned as a tensor of its own, so that torch's
# reductions over it (the foreach norms) take the path, and the order of
# summation, they take on an unsharded tensor
ALIGN = 64


def _padded(n):
    return -(-n // ALIGN) * ALIGN


def pack(tensors):
    """``tensors`` (one dtype, one device) copied into one flat buffer at
    ``ALIGN``-padded offsets -> ``(flat, views)``."""
    offs, n = [], 0
    for t in tensors:
        offs.append(n)
        n += _padded(t.numel())
    flat = torch.zeros(n, dtype=tensors[0].dtype, device=tensors[0].device)
    views = [flat[o:o + t.numel()].view(t.shape)
             for o, t in zip(offs, tensors)]
    torch._foreach_copy_(views, list(tensors))
    return flat, views


@torch.no_grad()
def reduce_over_ranks(tensors, mean=False, wire_dtype=None, group=None):
    """Each of ``tensors`` summed (``mean``: averaged) over the ranks: ONE
    all-reduce a (dtype, device) of their packed buffer (sent as
    ``wire_dtype`` when given: fleet's ``dgc``) -> views of the buffers,
    in order."""
    from . import collective as c
    out = [None] * len(tensors)
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    for idx in groups.values():
        flat, views = pack([tensors[i] for i in idx])
        wire = flat if wire_dtype is None else flat.to(wire_dtype)
        c._issue('all_reduce', wire.numel() * wire.element_size(),
                 lambda a: torch.distributed.all_reduce(wire, group=group,
                                                        async_op=a), group)
        if wire is not flat:
            flat.copy_(wire)
        if mean:
            flat.div_(env.get_world_size())
        for i, v in zip(idx, views):
            out[i] = v
    return out


class _Leaf:
    __slots__ = ('dim', 'full_shape', 'shard_shape', 'offset', 'numel')

    def __init__(self, dim, full_shape, shard_shape, offset, numel):
        self.dim, self.full_shape, self.shard_shape = dim, full_shape, \
            shard_shape
        self.offset, self.numel = offset, numel


class FlatShards:
    """The FSDP layout of ``params`` (``{name: full tensor}``, in order)
    over the process group (see the module docstring). ``layout[name]``
    holds each sharded leaf's ``dim``, ``full_shape``, ``shard_shape`` and
    its place in its dtype's flat buffer; ``whole`` names the leaves every
    rank keeps whole; ``config``: the ``ShardingConfig`` it was made from
    (a checkpoint of the step's state takes both: ``save(sharding=)``)."""

    def __init__(self, params, min_size=1024, group=None, config=None):
        from . import collective
        self._c = collective
        self.group = group
        self.config = config
        self.min_size = min_size
        self.world = env.get_world_size()
        self.rank = env.get_rank()
        self.layout, self.whole = {}, []
        self.buckets, self.length = {}, {}
        for name, p in params.items():
            shape = tuple(p.shape)
            dim = shard_dim(shape, self.world, min_size)
            if dim is None:
                self.whole.append(name)
                continue
            part = list(shape)
            part[dim] //= self.world
            numel = p.numel() // self.world
            off = self.length.get(p.dtype, 0)
            self.layout[name] = _Leaf(dim, shape, tuple(part), off, numel)
            self.buckets.setdefault(p.dtype, []).append(name)
            self.length[p.dtype] = off + _padded(numel)
        self._masks = {}   # (names, device) -> which are sharded

    def sharded(self, name):
        return name in self.layout

    # -- placement -----------------------------------------------------------
    @torch.no_grad()
    def shard(self, params):
        """``{name: this rank's piece}``: the sharded leaves copied into
        one flat buffer a dtype (their views), the whole ones as given."""
        out = {}
        for dt, names in self.buckets.items():
            dev = params[names[0]].device
            flat = torch.empty(self.length[dt], dtype=dt, device=dev)
            for n in names:
                view = self._view(flat, n)
                view.copy_(self.piece(params[n], n))
                out[n] = view
        for n in self.whole:
            out[n] = params[n]
        return {n: out[n] for n in params}

    def piece(self, full, name):
        """This rank's piece of the full leaf ``full`` of ``name``."""
        lf = self.layout.get(name)
        if lf is None:
            return full
        return full.chunk(self.world, dim=lf.dim)[self.rank]

    def _view(self, flat, name):
        lf = self.layout[name]
        return flat[lf.offset:lf.offset + lf.numel].view(lf.shard_shape)

    def _flat_of(self, shards, dt, packed):
        """The flat buffer of the pieces of dtype ``dt``: the one they are
        views of (``packed``: ``shard``'s), else a new one."""
        names = [n for n in self.buckets[dt] if n in shards]
        first = shards[names[0]]
        if packed:
            return first._base if first._base is not None else first
        flat = torch.zeros(self.length[dt], dtype=dt, device=first.device)
        torch._foreach_copy_([self._view(flat, n) for n in names],
                             [shards[n] for n in names])
        return flat

    # -- the step's collectives ----------------------------------------------
    @torch.no_grad()
    def gather(self, shards, packed=True):
        """``{name: full tensor}`` of the leaves of ``shards``: one
        all-gather a dtype of the flat pieces, each leaf's pieces then
        joined along its dim. ``packed``: the pieces are ``shard``'s views
        (else they are packed into a new buffer first)."""
        full = {}
        for dt, names in self.buckets.items():
            names = [n for n in names if n in shards]
            if not names:
                continue
            flat = self._flat_of(shards, dt, packed)
            L = self.length[dt]
            out = torch.empty(self.world * L, dtype=dt, device=flat.device)
            self._c._issue(
                'all_gather', flat.numel() * flat.element_size(),
                lambda a: self._c._gather_single(out, flat, group=self.group,
                                                 async_op=a), self.group)
            rows = out.view(self.world, L)
            for n in names:
                lf = self.layout[n]
                parts = [rows[r, lf.offset:lf.offset + lf.numel]
                         .view(lf.shard_shape) for r in range(self.world)]
                full[n] = torch.cat(parts, dim=lf.dim)
        for n in self.whole:
            if n in shards:
                full[n] = shards[n]
        return {n: full[n] for n in shards if n in full}

    @torch.no_grad()
    def reduce_grads(self, grads):
        """``{name: full gradient}`` -> ``{name: this rank's piece of the
        mean gradient}``: one reduce-scatter a dtype of the sharded leaves'
        gradients (zeros where a leaf has none), one all-reduce a dtype of
        the whole leaves'; each sum then divided by the world."""
        out = {}
        for dt, names in self.buckets.items():
            L = self.length[dt]
            dev = next(g.device for g in grads.values())
            inp = torch.zeros(self.world * L, dtype=dt, device=dev)
            rows = inp.view(self.world, L)
            dst, src = [], []
            for n in names:
                g = grads.get(n)
                if g is None:
                    continue
                lf = self.layout[n]
                for r, chunk in enumerate(g.chunk(self.world, dim=lf.dim)):
                    dst.append(rows[r, lf.offset:lf.offset + lf.numel]
                               .view(lf.shard_shape))
                    src.append(chunk)
            if dst:
                torch._foreach_copy_(dst, src)
            flat = torch.empty(L, dtype=dt, device=dev)
            self._c._issue(
                'reduce_scatter', inp.numel() * inp.element_size(),
                lambda a: self._c._scatter_single(
                    flat, inp, self._c._torch_op(self._c.ReduceOp.SUM),
                    group=self.group, async_op=a), self.group)
            flat.div_(self.world)
            for n in names:
                if grads.get(n) is not None:
                    out[n] = self._view(flat, n)
        whole = [n for n in self.whole if grads.get(n) is not None]
        for n, g in zip(whole, reduce_over_ranks(
                [grads[n] for n in whole], mean=True, group=self.group)):
            out[n] = g
        return out

    # -- cross-rank norms ----------------------------------------------------
    @contextlib.contextmanager
    def norms(self, metas):
        """Install the cross-rank norms of ``nn.clip`` for an update whose
        parameters' ``ParamAttr`` holders are ``metas`` (``{name:
        holder}``): keys are parameter names or holders."""
        from ..nn import clip as _clip
        by_id = {id(m): n for n, m in metas.items()}
        masks = self._masks

        def gathered(norms, keys):
            if self.rank != 0:
                names = tuple(k if isinstance(k, str) else by_id.get(id(k))
                              for k in keys)
                key = (names, norms.device)
                if key not in masks:
                    # made once, kept: a copy from the host each step would
                    # wait for the device
                    masks[key] = torch.tensor(
                        [self.sharded(n) for n in names], device=norms.device)
                norms = torch.where(masks[key], norms,
                                    torch.zeros_like(norms))
            return self._c._gather_stack(norms, self.group)

        prev = _clip._rank_norms[0]
        _clip._rank_norms[0] = gathered
        try:
            yield
        finally:
            _clip._rank_norms[0] = prev

    def full_shapes(self):
        """``{name: (dim, full shape)}`` of the sharded leaves."""
        return {n: (lf.dim, lf.full_shape) for n, lf in self.layout.items()}
