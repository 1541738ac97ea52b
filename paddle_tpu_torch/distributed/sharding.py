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
A spec on the model axis (``env.MODEL_AXIS``) cuts this rank's piece by
its index on that axis, as one on the data axis does by its data index.

Tensor parallelism (Megatron; the reference's ``ColumnParallelLinear``,
``RowParallelLinear``, ``VocabParallelEmbedding``): each layer is an
``nn.Module`` that holds its rank's piece of the dense layer, in torch's
(out, in) layout, and moves its activations with the conjugate pairs of
``autograd.Function``s over the model axis: ``_CopyToModel`` (identity,
its gradient all-reduced) and ``_ReduceFromModel`` (all-reduce, identity
gradient), ``_GatherFromModel`` (all-gather of the last dim, its gradient
sliced) and ``_ScatterToModel`` (slice, gradient all-gathered). A
layer's parameters carry ``tp_spec``, the reference's spec of the dense
parameter in its (in, out) layout, and ``tp_dim`` / ``tp_full``, the
torch dim the piece was cut along and the dense shape.
``apply_tensor_parallel`` turns a dense module into the tensor-parallel
one by a config's ``param_rules`` (see its docstring); ``tp_pieces`` cuts
each rank's pieces from a dense state (the reference's state through
``interop``, (in, out) weights transposed first) and ``gather_tp`` joins
them back.

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
           'RowParallelLinear', 'VocabParallelEmbedding', 'FlatShards',
           'apply_tensor_parallel', 'megatron_rules', 'tp_pieces',
           'gather_tp']


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


def _axis_dim(spec, axis):
    """The dim ``spec`` puts on ``axis`` (None: replicated over it)."""
    for d, part in enumerate(tuple(spec)):
        parts = part if isinstance(part, tuple) else (part,)
        if axis in parts:
            return d
    return None


def _data_dim(spec):
    """The dim ``spec`` puts on the data axis (None: replicated)."""
    return _axis_dim(spec, env.DATA_AXIS)


def shard_tensor(x, spec):
    """This rank's piece of ``x``: cut along the dim ``spec`` puts on the
    data axis by this rank's data index, and along the one it puts on the
    model axis by its model index (``x`` itself without a process group,
    or for a replicated spec)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    out = t
    for axis in (env.DATA_AXIS, env.MODEL_AXIS):
        dim = _axis_dim(spec, axis)
        n = env.get_world_size(axis)
        if dim is None or n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"shard_tensor: dim {dim} of "
                             f"{tuple(out.shape)} is not divisible by the "
                             f"{n} ranks of the {axis!r} axis")
        out = out.chunk(n, dim=dim)[env.get_rank(axis)]
    return out if out is t else out.clone()


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


# -- tensor parallelism ------------------------------------------------------

def _all_reduce_model(t, axis):
    """``t``'s sum over the model ``axis``, as a new tensor."""
    from . import collective
    out = t.contiguous().clone()
    collective.all_reduce(out, axis=axis)
    return out


def _gather_last(t, axis):
    """Every model rank's ``t`` joined along the last dim."""
    from . import collective
    g = env.axis_group(axis)[0]
    if g is env.SINGLE:
        return t
    rows = collective._gather_stack(t.contiguous(), g, f'{axis}.')
    return torch.cat(rows.unbind(0), dim=-1)


def _own_last(t, axis):
    _, n, r = env.axis_group(axis)
    return t.chunk(n, dim=-1)[r].contiguous()


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model axis (the
    replicated input of a column-parallel product)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_model(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    """The partial products of a row-parallel layer summed over the model
    axis; identity gradient."""

    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce_model(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The model ranks' column blocks joined on the last dim; the gradient
    is this rank's block."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _gather_last(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _own_last(g, ctx.axis), None


class _ScatterToModel(torch.autograd.Function):
    """This rank's block of the last dim; the gradient gathered."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _own_last(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.axis), None


def _piece_param(p, dim, n, r, spec):
    """A parameter of rank ``r``'s piece of ``p`` (``n`` pieces along torch
    dim ``dim``), with ``p``'s ``ParamAttr`` settings and ``tp_spec`` /
    ``tp_dim`` / ``tp_full``."""
    from ..nn.initializer import _ATTRS
    with torch.no_grad():
        value = p.detach().chunk(n, dim=dim)[r].clone()
    q = torch.nn.Parameter(value, requires_grad=p.requires_grad)
    for a in _ATTRS:
        if hasattr(p, a):
            setattr(q, a, getattr(p, a))
    q.tp_spec, q.tp_dim, q.tp_full = tuple(spec), dim, tuple(p.shape)
    q.tp_axis = next(a for a in spec if a is not None)
    return q


def _divides(n, size, what):
    if size % n:
        raise ValueError(f"{what}: {size} is not divisible by the {n} ranks "
                         f"of the model axis")


class ColumnParallelLinear(torch.nn.Module):
    """``y = x W^T + b`` with the output features split over the model
    axis: this rank holds rows ``r out/n .. (r + 1) out/n`` of the dense
    (out, in) weight and the bias's block. ``gather_output``: the ranks'
    column blocks are all-gathered into the dense output (Megatron's
    semantics); else the output is this rank's block (the input of a
    ``RowParallelLinear(input_is_parallel=True)``). The dense layer is
    drawn as ``nn.Linear`` draws it (from ``generator``), then cut, so
    ranks that share a seed hold the pieces of one dense layer."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, axis=env.MODEL_AXIS,
                 name=None, *, device=None, generator=None):
        super().__init__()
        from ..nn.layer.common import Linear
        dense = Linear(in_features, out_features, weight_attr,
                       None if has_bias else False, device=device,
                       generator=generator)
        self._adopt(dense, gather_output, axis)

    @classmethod
    def from_linear(cls, linear, gather_output=True, axis=env.MODEL_AXIS):
        """The column-parallel form of the dense ``linear``."""
        self = cls.__new__(cls)
        torch.nn.Module.__init__(self)
        self._adopt(linear, gather_output, axis)
        return self

    def _adopt(self, dense, gather_output, axis):
        _, n, r = env.axis_group(axis)
        _divides(n, dense.out_features, 'ColumnParallelLinear out_features')
        self.axis, self.gather_output = axis, bool(gather_output)
        # False where the caller sums the input's gradient over the model
        # axis itself (one all-reduce for the q, k and v of one input)
        self.copy_input = True
        self.in_features, self.out_features = dense.in_features, \
            dense.out_features
        self.weight = _piece_param(dense.weight, 0, n, r, (None, axis))
        self.bias = None if dense.bias is None else \
            _piece_param(dense.bias, 0, n, r, (axis,))

    def forward(self, x):
        from ..nn import functional as F
        if self.copy_input:
            x = _CopyToModel.apply(x, self.axis)
        out = F.linear(x, self.weight, self.bias)
        if self.gather_output:
            out = _GatherFromModel.apply(out, self.axis)
        return out

    def extra_repr(self):
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, gather_output={self.gather_output}")


class RowParallelLinear(torch.nn.Module):
    """``y = x W^T + b`` with the input features split over the model
    axis: this rank holds columns ``r in/n .. (r + 1) in/n`` of the dense
    (out, in) weight, and the whole bias, added once after the partial
    products are all-reduced. ``input_is_parallel``: ``x`` is already this
    rank's block of the input features (a column-parallel layer's
    ungathered output); else the dense ``x`` is sliced here."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, axis=env.MODEL_AXIS,
                 name=None, *, device=None, generator=None):
        super().__init__()
        from ..nn.layer.common import Linear
        dense = Linear(in_features, out_features, weight_attr,
                       None if has_bias else False, device=device,
                       generator=generator)
        self._adopt(dense, input_is_parallel, axis)

    @classmethod
    def from_linear(cls, linear, input_is_parallel=False,
                    axis=env.MODEL_AXIS):
        """The row-parallel form of the dense ``linear``."""
        self = cls.__new__(cls)
        torch.nn.Module.__init__(self)
        self._adopt(linear, input_is_parallel, axis)
        return self

    def _adopt(self, dense, input_is_parallel, axis):
        _, n, r = env.axis_group(axis)
        _divides(n, dense.in_features, 'RowParallelLinear in_features')
        self.axis, self.input_is_parallel = axis, bool(input_is_parallel)
        self.in_features, self.out_features = dense.in_features, \
            dense.out_features
        self.weight = _piece_param(dense.weight, 1, n, r, (axis, None))
        self.bias = dense.bias

    def forward(self, x):
        from ..nn import functional as F
        if not self.input_is_parallel:
            x = _ScatterToModel.apply(x, self.axis)
        out = _ReduceFromModel.apply(F.linear(x, self.weight), self.axis)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out

    def extra_repr(self):
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, input_is_parallel="
                f"{self.input_is_parallel}")


class VocabParallelEmbedding(torch.nn.Module):
    """An embedding table with its rows (the vocabulary) split over the
    model axis: each rank looks up the ids in its block, zero elsewhere,
    and the blocks' lookups are all-reduced (the reference's
    ``shard_map`` branch). The gradient reaches this rank's rows only."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 axis=env.MODEL_AXIS, name=None, *, device=None,
                 generator=None, std=0.02):
        super().__init__()
        from ..nn.layer.common import Embedding
        dense = Embedding(num_embeddings, embedding_dim, std,
                          weight_attr=weight_attr, device=device,
                          generator=generator)
        self._adopt(dense, axis)

    @classmethod
    def from_embedding(cls, embedding, axis=env.MODEL_AXIS):
        self = cls.__new__(cls)
        torch.nn.Module.__init__(self)
        self._adopt(embedding, axis)
        return self

    def _adopt(self, dense, axis):
        _, n, r = env.axis_group(axis)
        rows = dense.weight.shape[0]
        _divides(n, rows, 'VocabParallelEmbedding num_embeddings')
        self.axis, self.num_embeddings = axis, rows
        self.per, self.lo = rows // n, r * (rows // n)
        self.weight = _piece_param(dense.weight, 0, n, r, (axis, None))

    def forward(self, x):
        local = x.to(torch.int64) - self.lo
        inside = (local >= 0) & (local < self.per)
        out = torch.nn.functional.embedding(
            torch.where(inside, local, torch.zeros_like(local)),
            self.weight)
        out = torch.where(inside[..., None], out, torch.zeros_like(out))
        return _ReduceFromModel.apply(out, self.axis)


def megatron_rules(axis=env.MODEL_AXIS):
    """The reference-layout ``param_rules`` of Megatron's transformer split
    for the port's ``MultiHeadAttention`` and ``TransformerEncoderLayer``:
    the q/k/v projections and ``linear1`` column-parallel, ``out_proj``
    and ``linear2`` row-parallel."""
    rules = {}
    for name in ('q_proj', 'k_proj', 'v_proj', 'linear1'):
        rules[f'{name}.weight'] = (None, axis)
        rules[f'{name}.bias'] = (axis,)
    for name in ('out_proj', 'linear2'):
        rules[f'{name}.weight'] = (axis, None)
    return rules


def _rule(rules, name):
    for pat, spec in rules.items():
        if pat in name:
            return tuple(spec)
    return None


def _kind(spec, axis):
    """A Linear's rule -> 'column', 'row' or None (no model axis)."""
    if spec is None or _axis_dim(spec, axis) is None:
        return None
    return 'column' if _axis_dim(spec, axis) == len(spec) - 1 else 'row'


def apply_tensor_parallel(net, rules, axis=env.MODEL_AXIS):
    """Turn ``net`` into its tensor-parallel form, in place, by ``rules``
    (``{name-substring: spec}`` in the reference's (in, out) layout; a
    parameter whose spec does not touch the model axis is left alone) ->
    ``{name: parameter}`` of the model-parallel pieces.

    - a ``MultiHeadAttention`` whose q/k/v weights are column-parallel and
      whose ``out_proj`` is row-parallel, and a ``TransformerEncoderLayer``
      whose ``linear1`` is column-parallel and ``linear2`` row-parallel,
      become Megatron's gather-free pairs: the attention runs on its
      ``num_heads / n`` local heads (its dropout masks keyed on the dense
      model's heads), the FFN on its block of ``dim_feedforward`` (its
      activation dropout keyed on the dense block's columns);
    - any other ``Linear`` with a model-axis rule takes the gathered form
      (column: ``gather_output=True``; row: the dense input sliced), and
      an ``Embedding`` whose rows are on the model axis the
      vocab-parallel form: each computes what the dense layer computes,
      as the reference's rules do under GSPMD;
    - a model-axis rule on any other parameter raises ``ValueError``.

    Modules already tensor-parallel (built as ``ColumnParallelLinear``
    and friends) keep their layout."""
    from ..nn.layer.common import Embedding, Linear
    from ..nn.layer.transformer import (MultiHeadAttention,
                                        TransformerEncoderLayer)
    _, n, r = env.axis_group(axis)

    def kind(prefix):
        return _kind(_rule(rules, f'{prefix}weight'), axis)
    paired = set()
    for prefix, m in net.named_modules():
        pre = prefix + '.' if prefix else ''
        if isinstance(m, MultiHeadAttention) and all(
                isinstance(getattr(m, k), Linear) for k in
                ('q_proj', 'k_proj', 'v_proj', 'out_proj')) and all(
                kind(f'{pre}{k}.') == 'column'
                for k in ('q_proj', 'k_proj', 'v_proj')) and \
                kind(f'{pre}out_proj.') == 'row':
            _divides(n, m.num_heads, 'MultiHeadAttention num_heads')
            for k in ('q_proj', 'k_proj', 'v_proj'):
                col = ColumnParallelLinear.from_linear(getattr(m, k), False,
                                                       axis)
                col.copy_input = False     # the attention copies its inputs
                setattr(m, k, col)
            m.out_proj = RowParallelLinear.from_linear(m.out_proj, True,
                                                       axis)
            m.local_heads(n, r, axis)
            paired.update(id(getattr(m, k)) for k in
                          ('q_proj', 'k_proj', 'v_proj', 'out_proj'))
        if isinstance(m, TransformerEncoderLayer) and \
                isinstance(m.linear1, Linear) and \
                isinstance(m.linear2, Linear) and \
                kind(f'{pre}linear1.') == 'column' and \
                kind(f'{pre}linear2.') == 'row':
            m.linear1 = ColumnParallelLinear.from_linear(m.linear1, False,
                                                         axis)
            m.linear2 = RowParallelLinear.from_linear(m.linear2, True, axis)
            m.dropout.shard = (n, r)
            paired.update((id(m.linear1), id(m.linear2)))
    for prefix, m in list(net.named_modules()):
        if id(m) in paired or not prefix:
            continue
        parent_name, _, attr = prefix.rpartition('.')
        parent = net.get_submodule(parent_name) if parent_name else net
        if isinstance(m, Linear):
            k = kind(prefix + '.')
            if k == 'column':
                setattr(parent, attr, ColumnParallelLinear.from_linear(
                    m, True, axis))
            elif k == 'row':
                setattr(parent, attr, RowParallelLinear.from_linear(
                    m, False, axis))
        elif isinstance(m, Embedding):
            spec = _rule(rules, f'{prefix}.weight')
            if spec is not None and _axis_dim(spec, axis) == 0:
                setattr(parent, attr,
                        VocabParallelEmbedding.from_embedding(m, axis))
    out = {}
    for name, p in net.named_parameters():
        if getattr(p, 'tp_spec', None) is not None:
            out[name] = p
            continue
        spec = _rule(rules, name)
        if spec is not None and _axis_dim(spec, axis) is not None:
            raise ValueError(
                f"apply_tensor_parallel: rule {spec} on {name}: a model-axis "
                f"rule takes a Linear's weight or bias or an Embedding's "
                f"rows")
    return out


@torch.no_grad()
def tp_pieces(state, net):
    """This rank's pieces of a dense state (``{name: full tensor}`` in the
    port's layout: the reference's state through
    ``interop.load_paddle_tpu_state``'s transposes) for the tensor-parallel
    ``net``: each of its model-parallel parameters cut as its ``tp_dim``
    says, the others as they are."""
    out = {}
    for name, p in net.named_parameters():
        v = state[name]
        dim = getattr(p, 'tp_dim', None)
        if dim is not None:
            _, n, r = env.axis_group(p.tp_axis)
            v = v.chunk(n, dim=dim)[r]
        out[name] = v.clone()
    return out


@torch.no_grad()
def gather_tp(params, dims=None):
    """``{name: tensor}`` of a tensor-parallel model's parameters (or of
    values shaped like them: ``dims`` gives ``{name: (tp_dim, tp_axis)}``)
    -> ``{name: dense tensor}``: each model-parallel piece all-gathered
    over its axis and joined along ``tp_dim``; every rank calls it."""
    from . import collective
    out = {}
    for name, p in params.items():
        dim, axis = (dims or {}).get(name) or (getattr(p, 'tp_dim', None),
                                               getattr(p, 'tp_axis', None))
        g = env.axis_group(axis)[0] if dim is not None else env.SINGLE
        if g is env.SINGLE:
            out[name] = p.detach()
            continue
        rows = collective._gather_stack(p.detach(), g, f'{axis}.')
        out[name] = torch.cat(rows.unbind(0), dim=dim)
    return out


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
    """Each of ``tensors`` summed (``mean``: averaged) over the ranks of
    ``group`` (default: the data axis): ONE all-reduce a (dtype, device)
    of their packed buffer (sent as ``wire_dtype`` when given: fleet's
    ``dgc``) -> views of the buffers, in order (the tensors themselves on
    an axis of one rank)."""
    from . import collective as c
    group, n, _ = c._resolve(group)
    if group is env.SINGLE:
        return list(tensors)
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
            flat.div_(n)
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
    over the data axis's group ``group`` of ``world`` ranks, this one
    ``rank`` (default: the whole process group; see the module
    docstring). ``layout[name]`` holds each sharded leaf's ``dim``,
    ``full_shape``, ``shard_shape`` and its place in its dtype's flat
    buffer; ``whole`` names the leaves every rank keeps whole (all of them
    for ``min_size=None``); ``tp`` (``{name: (tp_dim, tp_axis)}``) and
    ``tp_full`` the step's model-parallel pieces, which it never gathers
    and whose gradients it averages over the data axis as the whole
    leaves'; ``config``: the ``ShardingConfig`` it was made from (a
    checkpoint of the step's state takes all of it: ``save(sharding=)``)."""

    def __init__(self, params, min_size=1024, group=None, config=None,
                 world=None, rank=None, tp=None):
        from . import collective
        self._c = collective
        self.group = group
        self.config = config
        self.min_size = min_size
        self.world = env.get_world_size() if world is None else world
        self.rank = env.get_rank() if rank is None else rank
        self.tp = {n: (p.tp_dim, p.tp_axis) for n, p in (tp or {}).items()}
        self.tp_full = {n: tuple(p.tp_full) for n, p in (tp or {}).items()}
        self.layout, self.whole = {}, []
        self.buckets, self.length = {}, {}
        for name, p in params.items():
            shape = tuple(p.shape)
            dim = None if min_size is None else \
                shard_dim(shape, self.world, min_size)
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

    def tp_piece(self, name):
        """The shape of this rank's model-parallel piece of ``name``."""
        dim, axis = self.tp[name]
        shape = list(self.tp_full[name])
        shape[dim] //= env.get_world_size(axis)
        return tuple(shape)

    def localize(self, v, name):
        """A restored leaf of ``name`` at its full (dense) shape -> this
        rank's piece (a model-parallel one cut by its model index); any
        other shape as it is."""
        lf = self.layout.get(name)
        if lf is not None:
            full, dim, n, r = lf.full_shape, lf.dim, self.world, self.rank
        elif name in self.tp:
            dim, axis = self.tp[name]
            full = self.tp_full[name]
            _, n, r = env.axis_group(axis)
        else:
            return v
        if tuple(np.shape(v)) != full:
            return v
        t = v if isinstance(v, torch.Tensor) \
            else torch.from_numpy(np.asarray(v))
        return t.chunk(n, dim=dim)[r]

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
        whole = [n for n in self.whole + list(self.tp)
                 if grads.get(n) is not None]
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
        # with model-parallel pieces a parameter's norm sums over every
        # rank: its FSDP pieces over the data axis (else data index 0's
        # copy), its model-parallel pieces over the model axis (else model
        # index 0's copy)
        axis = next(iter(self.tp.values()))[1] if self.tp else None
        mr = env.get_rank(axis) if axis else 0
        group = None if axis else self.group

        def counts(n):
            return (self.sharded(n) or self.rank == 0) and \
                (n in self.tp or mr == 0)

        def gathered(norms, keys):
            if self.rank != 0 or mr != 0:
                names = tuple(k if isinstance(k, str) else by_id.get(id(k))
                              for k in keys)
                key = (names, norms.device)
                if key not in masks:
                    # made once, kept: a copy from the host each step would
                    # wait for the device
                    masks[key] = torch.tensor(
                        [counts(n) for n in names], device=norms.device)
                norms = torch.where(masks[key], norms,
                                    torch.zeros_like(norms))
            return self._c._gather_stack(norms, group)

        prev = _clip._rank_norms[0]
        _clip._rank_norms[0] = gathered
        try:
            yield
        finally:
            _clip._rank_norms[0] = prev

    def full_shapes(self):
        """``{name: (dim, full shape)}`` of the sharded leaves."""
        return {n: (lf.dim, lf.full_shape) for n, lf in self.layout.items()}
