"""One train step: forward, backward, optimizer update. Counterpart of
``paddle_tpu/engine/builder.py`` (``build_train_step``, ``TrainStep``,
``StepResult``, ``DeviceLoss``).

The reference compiles a pure function ``(state, batch, key) -> (state,
loss, outputs)`` with ``jax.jit`` and donates the old state. PyTorch runs
eagerly, so the port's step is a plain callable with the same shape of
call — ``state, result = step(state, batch)`` — that differentiates with
``torch.autograd.grad`` and lets the optimizer update parameters and
moments in place; ``state`` is returned for the reference's calling
convention and is the same object. There is no key: a model's dropout
draws from its own ``DropoutState``. The loss stays on the device until
``float()`` is called on it, so a loop of steps never waits for the card.

``scaler=``, ``nan_guard=True``, ``microbatch > 1``, ``remat=``,
``sharding=`` and ``in_shardings=`` raise ``NotImplementedError``: mixed
precision, the NaN guard and microbatching come with the next training
slice (with ``amp/`` and ``engine/loop.py``), rematerialisation and
sharding with ``distributed/``.
"""
import numpy as np
import torch

from ..device import resolve_device

__all__ = ['build_train_step', 'TrainStep', 'StepResult', 'DeviceLoss']


class DeviceLoss:
    """A loss that stays on the device until someone needs the number:
    ``float(loss)`` (or ``.value()``) copies it to the host once."""

    __slots__ = ('_value', '_host')

    def __init__(self, value):
        self._value = value
        self._host = None

    def is_ready(self):
        return self._host is not None

    @property
    def raw(self):
        """The 0-dim tensor on the device (no sync)."""
        return self._value

    def value(self):
        if self._host is None:
            self._host = float(self._value)
        return self._host

    def __float__(self):
        return self.value()

    def __format__(self, spec):
        return format(self.value(), spec)

    def __repr__(self):
        if self._host is not None:
            return f'DeviceLoss({self._host})'
        return 'DeviceLoss(<on device>)'


class StepResult:
    """What one step hands back (besides the state)."""

    __slots__ = ('loss', 'losses', 'outputs')

    def __init__(self, loss, losses, outputs):
        self.loss = loss          # DeviceLoss
        self.losses = losses      # the 0-dim loss tensor on the device
        self.outputs = outputs    # tuple of the model's outputs (detached)


def _net_loss_fn(net, loss):
    """The loss over an ``nn.Module``: ``batch = (batch_x, batch_y)``;
    ``batch_x`` is a tuple of positional feeds or a dict of keyword feeds,
    and list losses are summed, as the reference's eager path does."""
    def loss_fn(params, batch):
        batch_x, batch_y = batch
        out = net(**batch_x) if isinstance(batch_x, dict) else net(*batch_x)
        outs = out if isinstance(out, (list, tuple)) else [out]
        losses = loss(*outs, *batch_y)
        losses = losses if isinstance(losses, (list, tuple)) else [losses]
        total = losses[0]
        for extra in losses[1:]:
            total = total + extra
        return total, tuple(outs)
    return loss_fn


_LATER = {
    'scaler': "an amp.GradScaler comes with bf16 and amp/ in the next "
              "training slice",
    'nan_guard': "the NaN guard comes with the next training slice",
    'microbatch': "microbatching comes with the next training slice",
    'remat': "rematerialisation (torch.utils.checkpoint) comes with the "
             "distributed slice",
    'sharding': "sharded state comes with the distributed slice",
    'in_shardings': "sharded feeds come with the distributed slice",
}


def build_train_step(loss_fn=None, optimizer=None, *, net=None, loss=None,
                     params=None, trainable=None, scaler=None,
                     nan_guard=False, microbatch=1, remat=None,
                     in_shardings=None, sharding=None, device=None):
    """Build ONE train step.

    Either pass ``net=`` and ``loss=`` — the step calls ``net`` on
    ``batch_x`` and ``loss(*outputs, *batch_y)`` — or a ``loss_fn(params,
    batch) -> loss | (loss, outputs)`` with ``params=`` (``{name: leaf
    tensor}``). ``optimizer`` is a ``paddle_tpu_torch.optimizer``
    optimizer; its ``functional_update`` is the update.

    - ``trainable``: optional set of parameter names to update (an empty
      set updates nothing); the others flow through untouched.
    - ``device``: where the step runs — the CUDA device unless
      ``device='cpu'``; the parameters must already live there, feeds are
      moved there.
    """
    asked = {'scaler': scaler is not None, 'nan_guard': bool(nan_guard),
             'microbatch': int(microbatch) != 1, 'remat': remat is not None,
             'sharding': sharding is not None,
             'in_shardings': in_shardings is not None}
    if int(microbatch) < 1:
        raise ValueError(f"build_train_step: microbatch must be >= 1, got "
                         f"{microbatch}")
    for option, on in asked.items():
        if on:
            raise NotImplementedError(
                f"build_train_step: {option}= is not ported yet: "
                f"{_LATER[option]}")
    if net is not None:
        if loss_fn is not None:
            raise ValueError("build_train_step: pass loss_fn OR net+loss, "
                             "not both")
        if loss is None:
            raise ValueError("build_train_step: net= needs loss=")
        loss_fn = _net_loss_fn(net, loss)
        if params is None:
            params = dict(net.named_parameters())
    if loss_fn is None:
        raise ValueError("build_train_step: need loss_fn= or net=+loss=")
    if params is None:
        raise ValueError("build_train_step: loss_fn= needs params=")
    if optimizer is None:
        raise ValueError("build_train_step: optimizer is required")
    return TrainStep(loss_fn, optimizer, dict(params),
                     frozenset(trainable) if trainable is not None else None,
                     resolve_device(device))


class TrainStep:
    """A train step: ``state, result = step(state, batch)``."""

    def __init__(self, loss_fn, optimizer, params, trainable, device):
        self.optimizer = optimizer
        self.device = device
        self._loss_fn = loss_fn
        self._params = params
        self._trainable = trainable
        for name, p in params.items():
            if p.device != device:
                raise ValueError(
                    f"build_train_step: parameter {name} is on {p.device}, "
                    f"the step runs on {device}; build the model there or "
                    f"pass device=")

    def init_state(self, opt_state=None):
        """``{'params': ..., 'opt': ...}``: the live parameters and fresh
        optimizer slots (or ``opt_state``, to resume)."""
        return {'params': self._params,
                'opt': opt_state if opt_state is not None
                else self.optimizer.init_state_values(self._params)}

    def _to_device(self, batch):
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return tuple(self._to_device(v) for v in batch)
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(batch)
        if isinstance(batch, torch.Tensor):
            return batch.to(self.device, non_blocking=True)
        return batch

    def __call__(self, state, batch):
        """Run one step on ``batch``. Parameters and optimizer slots in
        ``state`` are updated in place. Returns ``(state, StepResult)``;
        nothing here waits for the device."""
        params = state['params']
        names = [n for n, p in params.items() if p.requires_grad and
                 (self._trainable is None or n in self._trainable)]
        out = self._loss_fn(params, self._to_device(batch))
        loss, outs = out if isinstance(out, tuple) else (out, None)
        if names:
            grads = torch.autograd.grad(loss, [params[n] for n in names],
                                        allow_unused=True,
                                        materialize_grads=True)
            self.optimizer.functional_update(params, dict(zip(names, grads)),
                                             state['opt'])
        loss = loss.detach()
        if outs is not None:
            outs = tuple(o.detach() for o in outs)
        return state, StepResult(DeviceLoss(loss), loss, outs)
