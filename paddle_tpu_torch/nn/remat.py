"""Rematerialisation: recompute activations in the backward pass instead
of keeping them. Counterpart of the ``remat=`` policies of
``paddle_tpu/engine/builder.py`` (``_REMAT_POLICIES``, ``_resolve_remat``:
``jax.checkpoint`` around the loss), on ``torch.utils.checkpoint``
(non-reentrant).

``Remat(policy)``:

- ``'full'``: keep only each checkpointed call's inputs and recompute the
  rest;
- ``'dots'``: selective checkpointing
  (``torch.utils.checkpoint.create_selective_checkpoint_contexts``) that
  keeps the outputs of the matrix products (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``) and of the attention forward (``o`` and ``lse``, the
  registered op ``paddle_tpu_torch::flash_attention``), and recomputes the
  rest — ``jax.checkpoint_policies.dots_saveable``;
- a callable: a selective-checkpoint policy ``(ctx, op, *args, **kwargs)
  -> torch.utils.checkpoint.CheckpointPolicy``.

The unit of recomputation is each layer of a ``TransformerEncoder``
(``scope``): checkpointing the whole loss, as the reference does, keeps
nothing in the forward but rebuilds every activation at once at the start
of the backward, so the step's peak memory would not fall. A loss that
runs through no ``TransformerEncoder`` is checkpointed whole
(``engine.build_train_step`` decides when it builds the step).

A recomputed forward must draw the same dropout masks and run at the same
precision as the first one. Every ``DropoutState`` counts its calls on the
host, so the recompute sets each one's ``offset`` back to where the
checkpointed call found it and, afterwards, forward again to where the
backward found it (``kernels.philox.live_states``); and it runs under the
``amp.auto_cast`` state of the first forward, which the backward's thread
(CUDA's autograd worker) would not otherwise have.
"""
import contextlib
import contextvars

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import amp
from ..kernels.philox import live_states

__all__ = ['Remat', 'resolve', 'scope', 'current']

# the ops whose outputs 'dots' keeps: the matrix products and the attention
# forward (kernels/flash_attention.py)
_DOTS = frozenset({'mm', 'addmm', 'bmm', 'baddbmm', 'flash_attention'})


def _dots_policy(ctx, op, *args, **kwargs):
    if getattr(op, 'overloadpacket', None) is not None and \
            op.overloadpacket.__name__ in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class _Contexts:
    """Several context managers entered in order and left in reverse."""

    def __init__(self, *cms):
        self._cms = cms
        self._stack = None

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        for cm in self._cms:
            self._stack.enter_context(cm)
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)


class _Replay:
    """What the first forward of one checkpointed call saw — the dropout
    states' offsets and the ``auto_cast`` state — and its restoration for
    the recompute."""

    def __init__(self):
        self.entry = None
        self.amp_state = None

    @contextlib.contextmanager
    def forward(self):
        self.entry = [(s, s.offset) for s in live_states()]
        self.amp_state = amp.amp_enabled()
        yield

    @contextlib.contextmanager
    def recompute(self):
        reached = [(s, s.offset) for s, _ in self.entry]
        for s, offset in self.entry:
            s.offset = offset
        stack = amp._amp_state()
        stack.append(self.amp_state)
        try:
            yield
        finally:
            stack.pop()
            for s, offset in reached:
                s.offset = offset


class Remat:
    """A rematerialisation policy; ``remat(fn, *args)`` is ``fn(*args)``
    under ``torch.utils.checkpoint``."""

    def __init__(self, policy):
        self.policy = policy
        self.name = policy if isinstance(policy, str) else 'custom'
        self._sac = (_dots_policy if policy == 'dots' else
                     policy if callable(policy) else None)
        self.calls = 0          # checkpointed calls made

    def _contexts(self):
        replay = _Replay()
        fwd, rec = [replay.forward()], [replay.recompute()]
        if self._sac is not None:
            sac_fwd, sac_rec = create_selective_checkpoint_contexts(
                self._sac)
            fwd.append(sac_fwd)
            rec.append(sac_rec)
        return _Contexts(*fwd), _Contexts(*rec)

    def __call__(self, fn, *args):
        self.calls += 1
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=self._contexts)


def resolve(remat):
    """``None`` / ``'none'`` -> None; ``'full'``, ``'dots'`` or a policy
    callable -> a ``Remat``."""
    if remat is None or remat == 'none':
        return None
    if isinstance(remat, Remat):
        return remat
    if callable(remat) or remat in ('full', 'dots'):
        return Remat(remat)
    raise ValueError(
        f"remat: unknown policy {remat!r} (use None, 'full', 'dots', or a "
        f"selective-checkpoint policy callable)")


_current = contextvars.ContextVar('paddle_tpu_torch_remat', default=None)


@contextlib.contextmanager
def scope(remat):
    """While active, every ``TransformerEncoder`` layer runs under
    ``remat`` (a ``Remat``, or None for none)."""
    token = _current.set(remat)
    try:
        yield remat
    finally:
        _current.reset(token)


def current():
    """The ``Remat`` of the innermost ``scope``, or None."""
    return _current.get()
