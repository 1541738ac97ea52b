"""Ring attention: sequence (context) parallelism over the ``'seq'`` axis.
Counterpart of ``paddle_tpu/distributed/ring_attention.py``.

Each rank holds one block of L/n positions of q, k and v. Its q stays,
while the k and v blocks travel the ring (``collective.ppermute``, rank i
to i + 1) for n - 1 hops, so that every q block meets every k/v block.
The reference computes each block with an einsum and merges the blocks'
online-softmax statistics (``m``, ``l``); the port runs each block through
the flash kernels (``kernels.flash_attention``, their plain versions on
CPU tensors) and merges by their ``lse``:

- forward: block j of rank r's queries is ``flash_attention_forward``
  with ``causal=False`` for a block before the diagonal (j < r), with
  ``causal=True`` for the diagonal block, and skipped after it (every key
  there is in the future); without ``causal`` every block is full. The
  blocks' ``(o_j, lse_j)`` merge in fp32: ``lse = logsumexp_j lse_j``,
  ``o = sum_j exp(lse_j - lse) o_j``;
- backward: a ring again. With the merged ``lse`` and ``delta =
  rowsum(dO * o)`` each block's dQ and dK/dV kernels give its exact share
  (P rebuilt from the merged ``lse`` is the global softmax); dQ sums on
  the rank, and the dK/dV accumulators travel with their k/v block, which
  reaches its owner after one more hop;
- every block is L/n long, so the kernels' ``Lq == Lk`` holds.

The reference's two call forms: ``local=True`` takes this rank's blocks
(the reference inside ``shard_map``) and returns its block of the output;
the default takes the global q, k, v (the same on every rank), runs the
ring on this rank's block and all-gathers the output (the gradients of q,
k and v are all-gathered likewise, so that replicated code around it sees
the global ones). Without a ``'seq'`` axis of more than one rank it is
plain attention (the flash kernel). No dropout, as in the reference.
"""
import math

import torch

from . import collective, env

__all__ = ['ring_attention']


def _ring(axis):
    n = env.get_world_size(axis)
    return n, env.get_rank(axis), [(i, (i + 1) % n) for i in range(n)]


def _blocks(n, r, causal):
    """``(j, causal_j)`` of the blocks rank ``r`` computes at each hop
    (None: skipped): block j = (r - i) mod n at hop i."""
    out = []
    for i in range(n):
        j = (r - i) % n
        if not causal or j < r:
            out.append((j, False))
        elif j == r:
            out.append((j, True))
        else:
            out.append(None)
    return out


def _forward(q, k, v, axis, causal, scale):
    """The ring forward on this rank's blocks -> ``(o in q's dtype, lse
    fp32)``."""
    from ..kernels.flash_attention import flash_attention_forward
    n, r, perm = _ring(axis)
    o = lse = None
    kv = torch.stack((k, v))
    for i, block in enumerate(_blocks(n, r, causal)):
        if block is not None:
            o_j, lse_j = flash_attention_forward(q, kv[0], kv[1], block[1],
                                                 scale)
            o_j = o_j.float()
            if o is None:
                o, lse = o_j, lse_j
            else:
                new = torch.logaddexp(lse, lse_j)
                o = o * torch.exp(lse - new)[..., None] + \
                    o_j * torch.exp(lse_j - new)[..., None]
                lse = new
        if i < n - 1:
            kv = collective.ppermute(kv, perm, axis)
    return o.to(q.dtype), lse


def _backward(q, k, v, o, lse, do, axis, causal, scale):
    """The ring backward on this rank's blocks -> ``(dq, dk, dv)``."""
    from ..kernels.flash_attention import (flash_attention_dkv,
                                           flash_attention_dq)
    n, r, perm = _ring(axis)
    delta = (do.float() * o.float()).sum(-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    # the travelling block: k, v and their gradients' running sums
    kv = torch.stack((k, v))
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
    for i, block in enumerate(_blocks(n, r, causal)):
        if block is not None:
            args = (q, kv[0], kv[1], do, lse, delta, block[1], scale)
            dq += flash_attention_dq(*args).float()
            dk, dv = flash_attention_dkv(*args)
            dkv += torch.stack((dk, dv)).float()
        if i < n - 1:
            kv = collective.ppermute(kv, perm, axis)
        # the sums travel with their block; after the last block one more
        # hop brings them home
        dkv = collective.ppermute(dkv, perm, axis)
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis, causal, scale):
        o, lse = _forward(q, k, v, axis, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (axis, causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return _backward(q, k, v, o, lse, do.contiguous(), *ctx.args) + \
            (None, None, None)


def _own_block(t, axis):
    n, r = env.get_world_size(axis), env.get_rank(axis)
    return t.chunk(n, dim=2)[r].contiguous()


def _gather_blocks(t, axis):
    """Every rank's block along dim 2 (of (B, H, L, D), or of a stack of
    such on a leading dim: dim 3), joined."""
    g, _, _ = env.axis_group(axis)
    rows = collective._gather_stack(t.contiguous(), g, f'{axis}.')
    return torch.cat(rows.unbind(0), dim=t.dim() - 2)


class _RingGlobal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis, causal, scale):
        blocks = tuple(_own_block(t, axis) for t in (q, k, v))
        o, lse = _forward(*blocks, axis, causal, scale)
        ctx.save_for_backward(*blocks, o, lse)
        ctx.args = (axis, causal, scale)
        return _gather_blocks(o, axis)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        axis = ctx.args[0]
        grads = _backward(q, k, v, o, lse, _own_block(do, axis), *ctx.args)
        full = _gather_blocks(torch.stack(grads), axis)
        return full[0], full[1], full[2], None, None, None


def ring_attention(q, k, v, mesh=None, axis=env.SEQ_AXIS, causal=True,
                   scale=None, local=False):
    """q/k/v: (B, H, L, D) -> the attention output, (B, H, L, D).
    ``local``: q/k/v (and the output) are this rank's blocks of L / n
    positions (the reference inside ``shard_map``); else the global
    tensors (see the module docstring). ``mesh`` is accepted for the
    reference's signature; the axis's group is the installed mesh's."""
    from ..kernels.flash_attention import flash_attention_bhld
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n = env.get_world_size(axis)
    if n <= 1:
        return flash_attention_bhld(q, k, v, causal=causal, scale=scale)
    if not local and q.shape[2] % n:
        raise ValueError(f"ring_attention: length {q.shape[2]} is not "
                         f"divisible by the {n} ranks of axis {axis!r}")
    fn = _RingLocal if local else _RingGlobal
    return fn.apply(q, k, v, axis, bool(causal), float(scale))
