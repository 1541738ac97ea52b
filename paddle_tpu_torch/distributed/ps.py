"""The parameter-server mode's sparse table, over the model axis.
Counterpart of ``paddle_tpu/distributed/ps.py`` (``SparseShardedTable``).

The reference's PS path: trainers *pull* the embedding rows they touch and
*push* sparse gradients to the servers that hold the vocabulary's shards.
The reference has no server processes (one array sharded over the
``'model'`` mesh axis; pull a gather, push a scatter-add); nor does the
port: each rank of the model axis holds its block of rows, as
``sharding.VocabParallelEmbedding`` does, and

- ``pull(ids)``: each rank looks up the ids in its block (zero elsewhere)
  and the lookups are all-reduced over the axis; differentiable (the
  gradient reaches each rank's own rows);
- ``push(ids, grads, lr)``: each rank applies ``row[id] -= lr * grad`` to
  the ids in its block, duplicate ids accumulated (``index_add_``), the
  servers' merge and update; synchronous, as the reference's.

Without a model axis the table is whole on the rank, and the semantics are
the same. The initial table is drawn whole from ``generator`` (the
reference's ``Normal(0, 0.02)`` by default), then cut, so ranks that share
a seed hold the blocks of one table.
"""
import numpy as np
import torch

from . import env
from .sharding import _ReduceFromModel

__all__ = ['SparseShardedTable']


class SparseShardedTable:
    """A vocab-sharded embedding table with pull/push semantics (see the
    module docstring)."""

    def __init__(self, num_rows, dim, axis=env.MODEL_AXIS, name=None,
                 initializer=None, *, device=None, generator=None):
        from ..device import resolve_device
        from ..nn.initializer import Normal
        self.num_rows, self.dim, self.axis = num_rows, dim, axis
        device = resolve_device(device)
        _, n, r = env.axis_group(axis)
        if num_rows % n:
            raise ValueError(f"SparseShardedTable: {num_rows} rows are not "
                             f"divisible by the {n} ranks of axis {axis!r}")
        self.per, self.lo = num_rows // n, r * (num_rows // n)
        init = initializer or Normal(0.0, 0.02)
        with torch.no_grad():
            full = init((num_rows, dim), device=device, generator=generator)
        self.weight = torch.nn.Parameter(
            full[self.lo:self.lo + self.per].clone())
        self.name = name or 'sparse_table'

    def _local(self, ids):
        local = ids.to(self.weight.device, torch.int64) - self.lo
        inside = (local >= 0) & (local < self.per)
        return torch.where(inside, local, torch.zeros_like(local)), inside

    def pull(self, ids):
        """ids: int ``[...]`` -> rows ``[..., dim]`` (differentiable)."""
        local, inside = self._local(torch.as_tensor(np.asarray(ids))
                                    if not isinstance(ids, torch.Tensor)
                                    else ids)
        out = torch.nn.functional.embedding(local, self.weight)
        out = torch.where(inside[..., None], out, torch.zeros_like(out))
        return _ReduceFromModel.apply(out, self.axis)

    @torch.no_grad()
    def push(self, ids, grads, lr=1.0):
        """``row[id] -= lr * grad`` for this rank's ids, duplicates
        accumulated."""
        ids = ids if isinstance(ids, torch.Tensor) else \
            torch.as_tensor(np.asarray(ids))
        g = grads if isinstance(grads, torch.Tensor) else \
            torch.as_tensor(np.asarray(grads))
        local, inside = self._local(ids.reshape(-1))
        g = g.reshape(-1, g.shape[-1]).to(self.weight)
        self.weight.index_add_(0, local[inside], -lr * g[inside])

    def rows(self):
        return self.num_rows

    @torch.no_grad()
    def state_dict(self):
        """``{'weight': the whole table}`` (the blocks all-gathered over the
        axis; every rank calls it)."""
        from . import collective
        g, n, _ = env.axis_group(self.axis)
        if g is env.SINGLE:
            return {'weight': self.weight.detach().clone()}
        rows = collective._gather_stack(self.weight.detach(), g,
                                        f'{self.axis}.')
        return {'weight': rows.reshape(self.num_rows, self.dim)}

    @torch.no_grad()
    def set_state_dict(self, sd):
        """Load the whole table ``sd['weight']``: this rank keeps its
        block."""
        w = sd['weight']
        w = w if isinstance(w, torch.Tensor) else \
            torch.as_tensor(np.asarray(w))
        self.weight.copy_(w[self.lo:self.lo + self.per])
