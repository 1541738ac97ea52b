"""The data-parallel layer wrapper. Counterpart of
``paddle_tpu/distributed/parallel.py`` (``DataParallel``,
``ParallelStrategy``, ``prepare_context``).

``DataParallel(layers)`` is an ``nn.Module`` that runs ``layers``; its
gradients are summed over the ranks of the process group:

- eagerly, the reference's 1.8 idiom: ``loss = dp.scale_loss(loss)`` (the
  loss over the world), ``loss.backward()``,
  ``dp.apply_collective_grads()`` (the ``.grad``s' sum over the ranks, one
  all-reduce of their packed buffer a dtype): together the mean;
- in ``engine.build_train_step(net=DataParallel(...))`` the step runs the
  wrapped module and takes the gradients' mean over the ranks itself.

In a process group each rank draws its own dropout masks: the wrapper
sets the rank into the ``DropoutState``s of ``layers`` (``mask_ranks``).
Without a process group both are the identity. ``parameters``,
``named_parameters``, ``state_dict`` and ``set_state_dict`` are the
wrapped layers' own (no ``_layers.`` prefix), as the reference delegates
them.
"""
import torch

from . import env

__all__ = ['DataParallel', 'ParallelStrategy', 'prepare_context']


def mask_ranks(layers, synced):
    """Key the dropout masks of ``layers`` on this process's rank on the
    data axis where its gradients are averaged over it (``synced``), on
    rank 0's otherwise: the ``rank`` of every ``DropoutState`` the modules
    of ``layers`` hold (``kernels/philox.py``). The model ranks of one
    data replica (tensor parallelism) draw the same masks: their
    replicated activations must drop alike."""
    from ..resilience.checkpoint import dropout_states
    rank = env.get_rank(env.DATA_AXIS) if synced and env.is_initialized() \
        else 0
    for state in dropout_states(layers).values():
        state.rank = rank


class DataParallel(torch.nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False):
        super().__init__()
        self._layers = layers
        mask_ranks(layers, True)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        """The loss over the world (the reference scales by 1/nranks before
        backward; summed gradients then make the mean)."""
        n = env.get_world_size(env.DATA_AXIS)
        if n <= 1:
            return loss
        return loss / n

    @torch.no_grad()
    def apply_collective_grads(self):
        """Sum every parameter's ``.grad`` over the ranks, in place: one
        all-reduce of their packed buffer a dtype."""
        if not env.is_initialized():
            return
        from .sharding import reduce_over_ranks
        grads = [p.grad for p in self._layers.parameters()
                 if p.grad is not None]
        if grads:
            torch._foreach_copy_(grads, reduce_over_ranks(grads))

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def named_parameters(self, prefix='', recurse=True,
                         remove_duplicate=True):
        return self._layers.named_parameters(prefix, recurse,
                                             remove_duplicate)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    load_state_dict = set_state_dict


class ParallelStrategy:
    """Parity: ``fluid/dygraph/parallel.py`` ``ParallelStrategy`` (the C++
    struct's four fields, on the host)."""

    def __init__(self):
        self.nranks = 1
        self.local_rank = 0
        self.trainer_endpoints = []
        self.current_endpoint = ""


def prepare_context(strategy=None):
    """Parity: ``fluid/dygraph/parallel.py:34 prepare_context``: the
    strategy filled from the parallel environment, and the process group
    joined when it names more than one rank."""
    if strategy is None:
        strategy = ParallelStrategy()
        e = env.ParallelEnv()
        strategy.nranks = e.nranks
        strategy.local_rank = e.local_rank
        strategy.trainer_endpoints = list(e.trainer_endpoints)
        strategy.current_endpoint = e.current_endpoint
    if strategy.nranks > 1 and not env.is_initialized():
        env.init_parallel_env()
    return strategy
