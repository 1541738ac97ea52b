"""Activation recomputation (gradient checkpointing). Counterpart of
``paddle_tpu/distributed/recompute.py`` (the reference's fleet
``recompute``, there ``jax.checkpoint`` of the traced segment).

``recompute(function, *args)`` runs ``function(*args)`` (a module or any
callable over tensors) under ``torch.utils.checkpoint``, non-reentrant:
its activations are dropped after the forward and recomputed in the
backward, gradients flowing to the module's parameters and the inputs.
The recompute draws the same dropout masks as the first forward (every
``DropoutState`` is set back to where the first forward found it, as
``nn/remat.py`` does for ``remat='full'``) and runs under its
``amp.auto_cast`` state; ``preserve_rng_state`` also restores torch's own
generators, for callables that draw from them.
"""
from torch.utils.checkpoint import checkpoint

from ..nn.remat import Remat

__all__ = ['recompute']


def recompute(function, *args, preserve_rng_state=True):
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state,
                      context_fn=Remat('full')._contexts)
