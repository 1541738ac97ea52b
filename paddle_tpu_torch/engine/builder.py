"""One train step: forward, backward, optimizer update. Counterpart of
``paddle_tpu/engine/builder.py`` (``build_train_step``, ``TrainStep``
with ``_one_step``, ``_advance_scaler``, ``sync`` and ``adopt_state``,
``StepResult``, ``DeviceLoss``).

The reference compiles a pure function ``(state, batch, key) -> (state,
loss, outputs)`` with ``jax.jit`` and donates the old state. PyTorch runs
eagerly, so the port's step is a plain callable with the same shape of
call — ``state, result = step(state, batch)`` — that differentiates with
``torch.autograd.grad`` and lets the optimizer update parameters and
moments in place; ``state`` is returned for the reference's calling
convention and is the same object. There is no key: a model's dropout
draws from its own ``DropoutState``. **A step never waits for the
device**: the loss stays there until ``float()`` is called on it, and the
loss scaler and the NaN guard run on the device too.

- ``scaler=`` (an ``amp.GradScaler``; a disabled one counts as none): the
  loss is multiplied by the scale in ``state['scaler']['scale']``, the
  gradients divided by it; the step is ``ok`` when the loss and every
  gradient are finite, and the scaler's dynamic policy advances on the
  device (``state['scaler']``: ``scale``, ``good``, ``bad``).
- ``nan_guard=True``: the step is ``ok`` only with a finite loss; the
  counters ``steps``, ``skipped``, ``consecutive`` and ``peak`` live in
  ``state['guard']``.
- A step that is not ``ok`` leaves parameters, moments and ``beta*_pow``
  bitwise unchanged: a device-side select (``Optimizer.functional_update
  (ok=)``), not a Python ``if`` on a tensor. ``TrainStep.sync`` reads the
  counters (the one host sync, at the caller's cadence) into the host
  ``GradScaler`` and ``resilience.NanGuard``.
- Buffers (a BatchNorm's running statistics): ``state['buffers']`` holds
  the module's persistent buffers (``net=``'s, or ``buffers=`` beside a
  ``loss_fn``), the live tensors. A training forward updates them in
  place; a step that is not ``ok`` puts every one back bitwise (the same
  device-side select over one snapshot a dtype, taken only when the step
  can be skipped). A ``loss_fn(params, buffers, batch)`` of three
  arguments is the reference's form: it returns ``(loss, outputs,
  new_buffers)`` and the step writes ``new_buffers`` into the live ones.
  Under ``remat`` the recompute in the backward sees the buffers the
  forward saw and leaves them as the forward left them. A model without
  buffers has no ``'buffers'`` in its state and runs as before.
- ``microbatch=k``: one call runs k full steps, one update each, on batch
  leaves with a leading k axis, as the reference's ``lax.scan`` does;
  ``result.losses`` holds the k losses, and outputs are returned only when
  k == 1.
- ``optimizer=`` a ``FlatFusedUpdate``: the parameters are packed into its
  fp32 master buffer, which becomes ``state['params']`` and which the
  given parameters become views of. Each step casts the master once to the
  update's ``compute_dtype`` (when one is set), hands the model views of
  that buffer (detached, each its own autograd leaf: a gradient through
  slices of one buffer would build a buffer-sized zero tensor per slice),
  gathers their gradients into one flat buffer, casts it to the master's
  dtype once and runs the flat update.

- The optimizer's regularizers and clip run inside the step, after the
  gradients are unscaled and before the ``ok`` select, with each
  parameter's ``ParamAttr`` settings (``params_meta``: by default the
  net's named parameters, or ``params``); the learning rate is read from
  the optimizer (a float, or its scheduler's current value) at every
  call, so ``scheduler.step()`` between calls takes effect at once.
- ``remat=`` ``'full'`` / ``'dots'`` / a selective-checkpoint policy
  (``nn.remat``): every ``TransformerEncoder`` layer the loss runs
  through is checkpointed (``torch.utils.checkpoint``, non-reentrant),
  its dropout masks and precision replayed in the recompute. A ``net``
  that holds no ``TransformerEncoder``, or a ``loss_fn``, is checkpointed
  whole from the first call, as the reference's ``jax.checkpoint`` of the
  loss.

Mixed precision: ``amp.auto_cast`` around the step (the model's
``Linear``s cast their inputs), or, as in the reference's ``bench_bert``,
a ``loss_fn`` that casts the fp32 parameters with ``.to(torch.bfloat16)``
(differentiable) and runs the model on the copies through
``torch.func.functional_call``, or a ``FlatFusedUpdate`` with
``compute_dtype``.

Data parallelism (``distributed/``), in a ``torch.distributed`` process
group (``distributed.init_parallel_env``); without one every option below
runs the one-process step, bit for bit as before:

- **a rank feeds its slice** of the global batch
  (``io.DistributedBatchSampler``), and the loss a step returns is the
  global batch's (the ranks' mean: one all-reduce of a few scalars, which
  also makes ``ok`` the AND of every rank's, so that an inf on one rank
  skips the step on all);
- ``sharding=`` (a ``distributed.ShardingConfig``, a fleet
  ``DistributedStrategy`` or a kwargs dict): the FSDP step
  (``distributed.sharding.FlatShards``). ``state['params']`` and the
  optimizer's moments are this rank's pieces; each step all-gathers the
  full parameters (one collective a dtype) into the module's own
  parameters, runs the loss and its gradients as the unsharded step does
  (remat's recompute included), reduce-scatters the gradients (their
  mean) and updates the pieces. The global-norm clip, ``ClipGradByNorm``
  and the per-parameter norms of ``Lamb`` / ``LarsMomentum`` / ``Dpsgd``
  add their sums across the ranks (``nn.clip.rank_norms``). After the
  update the gathered parameters are released, so between steps a rank
  holds only its pieces and the module's sharded parameters are empty
  (until the first step it holds the values it was built with);
  ``write_back`` gathers the state into it (``engine.fit`` does at its
  end);
- tensor parallelism: a ``sharding=`` config whose ``param_rules`` put
  parameters on the model axis turns ``net`` into its tensor-parallel
  form, in place (``distributed.sharding.apply_tensor_parallel``), and
  the parameters of layers built tensor-parallel stay this rank's
  pieces: never gathered, their gradients averaged over the data axis
  as a whole leaf's; FSDP shards only the others, over the data axis;
  ``full_params`` / ``full_slots`` gather the pieces to the dense model's
  layout;
- a ``distributed.DataParallel`` net (or a ``fleet.distributed_optimizer``
  optimizer): the gradients' mean over the ranks, one all-reduce of their
  packed buffer a dtype, before the unscale, the clip and the update;
- with ``sharding=`` or a ``DataParallel`` net, a training ``batch_norm``
  takes its statistics over the global batch (``nn.functional.norm.
  batch_stats_over_ranks``: the per-channel sums all-reduced, forward and
  backward), as the reference's sharded step, one program over the global
  batch, does; each rank draws its own
  dropout masks (the rank is set into the ``net``'s ``DropoutState``s;
  ``kernels/philox.py``); any other step of a ``net`` sets rank 0's
  masks, so ranks that synchronise nothing stay equal;
- ``in_shardings=``: ``(state specs, batch specs)`` as the reference's
  ``jax.jit`` takes them; a batch leaf whose spec puts the data axis on a
  dim is the GLOBAL leaf, and the step keeps this rank's slice of it
  (``sharding=`` derives the feeds' placement itself: pass one or the
  other).

A ``FlatFusedUpdate`` and ``sharding=`` do not combine (its one buffer is
not sharded).

Telemetry (``PADDLE_TPU_TELEMETRY=1`` or ``observability.enable()``), as
the reference's: each call is timed into ``engine.step`` (with the spans'
sampled device wait on the step's losses: the 1st and every
``sync_every``-th call waits, no other), and counted in ``engine.steps``
(k a call) and ``engine.dispatches``; the first call runs under
``observability.costs.capture`` (label ``cost_label``, kind
``train_step``), which counts its FLOPs, bytes and peak memory;
``DeviceLoss.value`` and ``sync`` count their copies to the host
(``host_transfer.engine.loss_fetch`` / ``engine.state_sync``). With
telemetry off none of it runs.
"""
import inspect
import itertools

import numpy as np
import torch

from .. import observability as _obs
from ..device import resolve_device
from ..nn import remat as _remat
from ..nn.functional.norm import batch_stats_over_ranks
from ..nn.layer.transformer import TransformerEncoder
from ..optimizer.fused import FlatFusedUpdate
from ..optimizer.optimizer import _each

__all__ = ['build_train_step', 'TrainStep', 'StepResult', 'DeviceLoss']

# cost-ledger labels: one per step built in the process (frontends that
# care set .cost_label themselves)
_STEP_SEQ = itertools.count()


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
            _obs.record_host_transfer(self._value.element_size(),
                                      kind='engine.loss_fetch')
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
    """What one call hands back (besides the state)."""

    __slots__ = ('loss', 'losses', 'outputs')

    def __init__(self, loss, losses, outputs):
        self.loss = loss          # DeviceLoss of the (last microbatch's) loss
        self.losses = losses      # the loss, or the k losses, on the device
        self.outputs = outputs    # the model's outputs (detached), k == 1


def _net_loss_fn(net, loss, functional):
    """The loss over an ``nn.Module``: ``batch = (batch_x, batch_y)``;
    ``batch_x`` is a tuple of positional feeds or a dict of keyword feeds,
    and list losses are summed, as the reference's eager path does. With
    ``functional`` the module runs on the ``params`` it is given
    (``torch.func.functional_call``), else on its own parameters."""
    def loss_fn(params, batch):
        batch_x, batch_y = batch
        args, kwargs = ((), batch_x) if isinstance(batch_x, dict) \
            else (tuple(batch_x), {})
        out = torch.func.functional_call(net, params, args, kwargs) \
            if functional else net(*args, **kwargs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        losses = loss(*outs, *batch_y)
        losses = losses if isinstance(losses, (list, tuple)) else [losses]
        total = losses[0]
        for extra in losses[1:]:
            total = total + extra
        return total, tuple(outs)
    return loss_fn


def persistent_buffers(net):
    """``{name: buffer}`` of ``net``'s buffers that its state dict holds."""
    keys = set(net.state_dict(keep_vars=True))
    return {n: b for n, b in net.named_buffers() if n in keys}


def _takes_buffers(loss_fn):
    """True for the reference's ``loss_fn(params, buffers, batch)``."""
    try:
        sig = inspect.signature(loss_fn)
    except (TypeError, ValueError):
        return False
    positional = [p for p in sig.parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(positional) == 3


def build_train_step(loss_fn=None, optimizer=None, *, net=None, loss=None,
                     params=None, buffers=None, params_meta=None,
                     trainable=None, scaler=None, nan_guard=False,
                     microbatch=1, remat=None, in_shardings=None,
                     sharding=None, device=None):
    """Build ONE train step.

    Either pass ``net=`` and ``loss=`` — the step calls ``net`` on
    ``batch_x`` and ``loss(*outputs, *batch_y)`` — or a ``loss_fn(params,
    batch) -> loss | (loss, outputs)`` with ``params=`` (``{name: leaf
    tensor}``), or the reference's ``loss_fn(params, buffers, batch) ->
    (loss, outputs, new_buffers)`` with ``buffers=`` (``{name: live
    buffer}``). ``optimizer`` is a ``paddle_tpu_torch.optimizer``
    optimizer (its ``functional_update`` is the update) or a
    ``FlatFusedUpdate`` over those parameters.

    - ``params_meta``: ``{name: parameter}`` whose ``ParamAttr``
      attributes (learning rate, regularizer, ``need_clip``) the update
      honours; by default the parameters themselves.
    - ``trainable``: optional set of parameter names to update (an empty
      set updates nothing); the others flow through untouched.
    - ``scaler``, ``nan_guard``, ``microbatch``, ``remat``: see the
      module docstring.
    - ``device``: where the step runs — the CUDA device unless
      ``device='cpu'``; the parameters must already live there, feeds are
      moved there.
    """
    from ..distributed.parallel import DataParallel, mask_ranks
    from ..distributed.strategy import resolve_sharding
    k = int(microbatch)
    if k < 1:
        raise ValueError(f"build_train_step: microbatch must be >= 1, got "
                         f"{microbatch}")
    sharding = resolve_sharding(sharding)
    if sharding is not None and in_shardings is not None:
        raise ValueError("build_train_step: sharding= derives the step's "
                         "in_shardings itself — pass one or the other")
    if scaler is not None and not scaler.is_enable():
        scaler = None
    flat = isinstance(optimizer, FlatFusedUpdate)
    if flat and sharding is not None:
        raise ValueError("build_train_step: a FlatFusedUpdate's one buffer "
                         "is not sharded; pass a per-parameter optimizer "
                         "with sharding=")
    data_parallel = getattr(optimizer, 'syncs_gradients', False)
    if isinstance(net, DataParallel):
        # the wrapped module runs (functional_call keys are its own names)
        net, data_parallel = net._layers, True
    tp = _tensor_parallel(sharding, net, params)
    if net is not None:
        if loss_fn is not None:
            raise ValueError("build_train_step: pass loss_fn OR net+loss, "
                             "not both")
        if loss is None:
            raise ValueError("build_train_step: net= needs loss=")
        loss_fn = _net_loss_fn(net, loss, flat)
        if params is None:
            params = dict(net.named_parameters())
        if buffers is None:
            buffers = persistent_buffers(net)
    if loss_fn is None:
        raise ValueError("build_train_step: need loss_fn= or net=+loss=")
    if params is None:
        raise ValueError("build_train_step: loss_fn= needs params=")
    if optimizer is None:
        raise ValueError("build_train_step: optimizer is required")
    if flat and trainable is not None:
        raise ValueError("build_train_step: trainable= filters the "
                         "per-parameter update; a FlatFusedUpdate updates "
                         "its whole buffer")
    remat = _remat.resolve(remat)
    by_layer = remat is not None and net is not None and any(
        isinstance(m, TransformerEncoder) for m in net.modules())
    step = TrainStep(loss_fn, optimizer, dict(params),
                     frozenset(trainable) if trainable is not None else None,
                     resolve_device(device), scaler=scaler,
                     nan_guard=bool(nan_guard), microbatch=k,
                     params_meta=(dict(params) if params_meta is None
                                  else dict(params_meta)),
                     remat=remat, remat_by_layer=by_layer,
                     sharding=sharding, data_parallel=data_parallel,
                     in_shardings=in_shardings, tp=tp,
                     buffers=dict(buffers or {}),
                     functional_buffers=net is None and _takes_buffers(
                         loss_fn))
    if net is not None:
        # each rank its own masks where the step averages the gradients
        mask_ranks(net, step._synced)
    return step


def _tensor_parallel(sharding, net, params):
    """The model-parallel parameters of a step (``{name: parameter}``):
    ``net`` turned into its tensor-parallel form by ``sharding``'s
    ``param_rules`` (``distributed.sharding.apply_tensor_parallel``), and
    the parameters of layers built tensor-parallel."""
    from ..distributed.sharding import _axis_dim, apply_tensor_parallel
    if sharding is None:
        return {}
    axis = sharding.model_axis
    rules = {k: v for k, v in sharding.param_rules.items()
             if _axis_dim(v, axis) is not None}
    if net is not None:
        if rules:
            apply_tensor_parallel(net, rules, axis)
        params = dict(net.named_parameters())
    elif rules:
        raise ValueError("build_train_step: param_rules turn the layers of "
                         "net= into their tensor-parallel form; a loss_fn "
                         "step takes tensor-parallel layers as built")
    return {n: p for n, p in (params or {}).items()
            if getattr(p, 'tp_dim', None) is not None}


def _is_spec(spec):
    """A spec is a tuple of axis names and None (``()``: replicated)."""
    return spec is None or (isinstance(spec, tuple) and all(
        s is None or isinstance(s, str) for s in spec))


def _split_feeds(batch, spec, world):
    """This rank's slice of each batch leaf whose spec (``in_shardings``)
    puts the data axis on a dim; ``spec`` mirrors ``batch`` or is one spec
    for every leaf."""
    from ..distributed import env
    from ..distributed.sharding import _data_dim
    if isinstance(batch, dict):
        return {k: _split_feeds(v, spec if _is_spec(spec) else spec[k],
                                world) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return tuple(_split_feeds(v, spec if _is_spec(spec) else spec[i],
                                  world) for i, v in enumerate(batch))
    dim = _data_dim(spec or ())
    if dim is None or not hasattr(batch, 'shape'):
        return batch
    n = batch.shape[dim] // world
    r = env.get_rank(env.DATA_AXIS)
    sl = [slice(None)] * len(batch.shape)
    sl[dim] = slice(r * n, (r + 1) * n)
    return batch[tuple(sl)]


def _unscale_and_check(grads, scale):
    """Divide ``grads`` by the 0-dim ``scale`` in place (the reference's
    ``g / scale``) -> a 0-dim bool tensor: every gradient finite."""
    _each('div_', grads, scale)
    found = torch.zeros((), dtype=torch.float32, device=scale.device)
    one = torch.ones((), dtype=torch.float32, device=scale.device)
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        # multiplies by 1 (no change) and sets `found` on a non-finite value
        torch._amp_foreach_non_finite_check_and_unscale_(group, found, one)
    return found == 0


class TrainStep:
    """A train step: ``state, result = step(state, batch)``."""

    def __init__(self, loss_fn, optimizer, params, trainable, device,
                 scaler=None, nan_guard=False, microbatch=1,
                 params_meta=None, remat=None, remat_by_layer=False,
                 sharding=None, data_parallel=False, in_shardings=None,
                 tp=None, buffers=None, functional_buffers=False):
        from ..distributed import env as _env
        self.optimizer = optimizer
        self.sharding = sharding
        # the process group this step synchronises over (None: one
        # process): the data axis's
        grouped = _env.is_initialized()
        self._data_group, self._world, self._data_rank = \
            _env.axis_group(_env.DATA_AXIS) if grouped else (None, 1, 0)
        # the model-parallel pieces (never gathered; distributed/sharding)
        self._tp = dict(tp or {})
        self._shards = None
        self._dp = grouped and bool(data_parallel) and sharding is None
        self._synced = grouped and (sharding is not None or self._dp)
        self._feed_specs = None if in_shardings is None or not grouped \
            else in_shardings[1]
        self.device = device
        self.scaler = scaler
        self.guard_enabled = nan_guard
        self.k = microbatch
        self.remat = remat
        self.remat_by_layer = remat_by_layer
        self._loss_fn = loss_fn
        self._trainable = trainable
        self._params_meta = params_meta
        self.cost_label = f'engine.train_step{next(_STEP_SEQ)}'
        self._cost_captured = False
        # the live buffers (updated in place by the forward) and whether
        # the loss_fn takes and returns them (the reference's form)
        self._buffers = dict(buffers or {})
        self._functional_buffers = functional_buffers
        for name, p in {**params, **self._buffers}.items():
            if p.device != device:
                raise ValueError(
                    f"build_train_step: parameter {name} is on {p.device}, "
                    f"the step runs on {device}; build the model there or "
                    f"pass device=")
        self._flat = optimizer if isinstance(optimizer, FlatFusedUpdate) \
            else None
        self._full = params            # the module's own parameters
        self._collective_bytes_est = 0
        if self._flat is not None:
            # the master owns the weights: the parameters become its views
            master = self._flat.flatten(params)
            self._flat.bind(params, master)
            self._params = master
        elif sharding is not None and grouped:
            from ..distributed.sharding import FlatShards
            # FSDP over the data axis, of the parameters that are not
            # model-parallel pieces; without fsdp (or on a data axis of one
            # rank of a larger mesh) every leaf stays whole and its
            # gradient is averaged over the data axis
            rest = {n: p for n, p in params.items() if n not in self._tp}
            fsdp = sharding.fsdp and self._data_group is not _env.SINGLE
            self._shards = FlatShards(
                rest, min_size=sharding.min_size if fsdp else None,
                config=sharding, group=self._data_group, world=self._world,
                rank=self._data_rank, tp=self._tp)
            pieces = self._shards.shard(rest)
            self._params = {n: pieces.get(n, p) for n, p in params.items()}
            # what a released parameter holds: nothing, one tensor a dtype
            self._empty = {p.dtype: p.new_empty(0) for p in params.values()}
            self._collective_bytes_est = \
                sharding.collective_bytes_estimate(params)
        else:
            self._params = params

    def init_state(self, opt_state=None, nan_guard=None, scaler=None):
        """``{'params': ..., 'opt': ...}`` (plus ``'guard'`` and
        ``'scaler'`` when the step has them): the live parameters (or the
        flat master) and fresh optimizer slots (or ``opt_state``, to
        resume). ``nan_guard`` / ``scaler`` host objects seed the device
        counters, so a resumed run continues its skip and scale history."""
        if opt_state is None:
            opt_state = (self._flat.init_state(self._params) if self._flat
                         else self.optimizer.init_state_values(self._params))
        elif self._shards is not None:
            opt_state = self._place_slots(opt_state)
        state = {'params': self._params, 'opt': opt_state}
        if self._buffers:
            state['buffers'] = self._buffers

        def i32(v):
            # a fill, not a copy from the host: nothing waits
            return torch.full((), int(v), dtype=torch.int32,
                              device=self.device)
        if self.guard_enabled:
            g = nan_guard
            state['guard'] = {
                'steps': i32(g.total_steps if g else 0),
                'skipped': i32(g.skipped_steps if g else 0),
                'consecutive': i32(g.consecutive_skips if g else 0),
                # the longest streak SINCE THE LAST SYNC, so that a
                # limit-length streak that ends between two syncs still
                # aborts at the next one; sync() sets it back to 0
                'peak': i32(0)}
        if self.scaler is not None:
            s = scaler or self.scaler
            state['scaler'] = {
                'scale': torch.full((), float(s.get_loss_scaling()),
                                    dtype=torch.float32, device=self.device),
                'good': i32(s._good_steps), 'bad': i32(s._bad_steps)}
        if self.sharding is not None and _obs.enabled():
            info = self.sharding_info(state)
            for key in ('param_bytes_per_device', 'opt_bytes_per_device',
                        'state_bytes_per_device', 'mesh_devices',
                        'collective_bytes_per_step_est'):
                _obs.gauge(f'sharding.{key}').set(info[key])
        return state

    @torch.no_grad()
    def _place_slots(self, opt_state):
        """Optimizer slots of full parameters (a resumed optimizer's) ->
        this rank's pieces of those shaped like their sharded parameter."""
        out = {}
        for n, slots in opt_state.items():
            lf = self._shards.layout.get(n)
            out[n] = {s: (self._shards.piece(v, n).clone()
                          if lf is not None and isinstance(v, torch.Tensor)
                          and tuple(v.shape) == lf.full_shape else v)
                      for s, v in slots.items()}
        return out

    def sharding_info(self, state):
        """This rank's resident bytes and the collective traffic of a step,
        as the reference's ``sharding_info``."""
        def nbytes(tree):
            if isinstance(tree, dict):
                return sum(nbytes(v) for v in tree.values())
            if isinstance(tree, torch.Tensor):
                return tree.numel() * tree.element_size()
            return 0
        sharded = 0 if self._shards is None else len(self._shards.layout)
        return {'param_bytes_per_device': nbytes(state['params']),
                'opt_bytes_per_device': nbytes(state.get('opt', {})),
                'state_bytes_per_device': nbytes(state),
                'mesh_devices': self._world if self.sharding is not None
                else 1,
                'collective_bytes_per_step_est': self._collective_bytes_est,
                'sharded_params': sharded}

    @torch.no_grad()
    def full_params(self, state, dense=True):
        """``{name: full parameter}`` of ``state``: gathered from the ranks'
        pieces on a sharded step (one all-gather a dtype; every rank calls
        it), else the state's own; the model-parallel pieces gathered over
        the model axis too (the dense model's parameters) unless
        ``dense=False``."""
        if self._shards is None:
            return state['params']
        full = self._shards.gather(state['params'])
        if dense and self._tp:
            from ..distributed.sharding import gather_tp
            full.update(gather_tp({n: state['params'][n] for n in self._tp},
                                  self._shards.tp))
        return {n: full.get(n, state['params'][n]) for n in state['params']}

    @torch.no_grad()
    def full_slots(self, state, dense=True):
        """The optimizer slots of ``state`` at their parameters' full
        shapes (gathered, one all-gather a slot name and dtype, on a
        sharded step; a model-parallel parameter's slots over the model
        axis too unless ``dense=False``)."""
        opt = state.get('opt', {})
        if self._shards is None:
            return opt
        if dense and self._tp:
            from ..distributed.sharding import gather_tp
            opt = dict(opt)
            for n in self._tp:
                if n not in opt:
                    continue
                shape = tuple(state['params'][n].shape)
                slots = {s: v for s, v in opt[n].items()
                         if isinstance(v, torch.Tensor)
                         and tuple(v.shape) == shape}
                dims = {s: self._shards.tp[n] for s in slots}
                opt[n] = {**opt[n], **gather_tp(slots, dims)}
        by_slot = {}
        for n, slots in opt.items():
            lf = self._shards.layout.get(n)
            for s, v in slots.items():
                if lf is not None and isinstance(v, torch.Tensor) and \
                        tuple(v.shape) == lf.shard_shape:
                    by_slot.setdefault(s, {})[n] = v
        full = {s: self._shards.gather(pieces, packed=False)
                for s, pieces in by_slot.items()}
        return {n: {s: full[s][n] if n in full.get(s, {}) else v
                    for s, v in slots.items()}
                for n, slots in opt.items()}

    @torch.no_grad()
    def write_back(self, state, optimizer=None):
        """Bring ``state`` into the module and ``optimizer``: on a sharded
        step the gathered parameters into the module's own (between steps
        they are released) and the full slots into
        the optimizer's accumulators (every rank calls it: it gathers); on
        an unsharded step, whose state holds the module's parameters, the
        slots only (``engine.write_back_state``)."""
        from .loop import write_back_state
        if self._shards is not None:
            # the model-parallel pieces stay the module's own
            for n, v in self.full_params(state, dense=False).items():
                if v is not self._full[n]:
                    self._full[n].data = v
        if optimizer is not None:
            write_back_state(None, optimizer,
                             {'opt': self.full_slots(state, dense=False)})

    @torch.no_grad()
    def adopt_state(self, state):
        """Align a restored state (``CheckpointManager.restore``'s: numpy
        leaves or CPU tensors, in this step's layout) with this step and
        return the step's live state, as the reference's ``adopt_state``
        (``paddle_tpu/engine/builder.py:489``) does.

        The step updates the network's parameters in place, so the
        restored values are copied INTO them (on the flat path into the
        ``FlatFusedUpdate``'s master buffer, which they are views of), and
        into fresh optimizer slots of this step (keyed by module path, as
        the step's own; 0-dim slots such as ``beta*_pow`` equal across
        parameters become one shared tensor again). Guard and scaler slots
        the checkpoint carries but this step does not use are dropped with
        a warning; missing ones are seeded fresh. A missing, unexpected,
        mis-shaped or mis-typed entry raises ``ValueError``; the values
        are never converted."""
        import warnings
        state = dict(state)
        if self._shards is not None:
            state = self._localize(state)
        saved_buffers = state.pop('buffers', None) or {}
        if saved_buffers and not self._buffers:
            raise ValueError("TrainStep.adopt_state: the checkpoint carries "
                             "buffers; this step keeps none")
        fresh = self.init_state()
        shared = {}

        def adopt(live, saved, where):
            if isinstance(live, dict):
                if not isinstance(saved, dict):
                    raise ValueError(f"TrainStep.adopt_state: {where} is "
                                     f"not a dict in the checkpoint")
                own = {k for k, v in live.items()
                       if not isinstance(v, torch.Generator)}
                if own != set(saved):
                    raise ValueError(
                        f"TrainStep.adopt_state: {where} has keys "
                        f"{sorted(saved)[:8]}, the step's are "
                        f"{sorted(own)[:8]}")
                return {k: v if k not in own else
                        adopt(v, saved[k], f'{where}.{k}')
                        for k, v in live.items()}
            src = saved if isinstance(saved, torch.Tensor) \
                else torch.from_numpy(np.array(saved, order='C'))
            if tuple(src.shape) != tuple(live.shape) or \
                    src.dtype != live.dtype:
                raise ValueError(
                    f"TrainStep.adopt_state: {where} is {src.dtype} "
                    f"{tuple(src.shape)} in the checkpoint, "
                    f"{live.dtype} {tuple(live.shape)} in the step")
            if live.dim() == 0 and not where.startswith('params'):
                key = (where.rpartition('.')[2], src.dtype,
                       src.detach().cpu().reshape(1).view(torch.uint8)
                       .numpy().tobytes())
                if key not in shared:
                    shared[key] = src.detach().to(live.device, copy=True)
                return shared[key]
            live.copy_(src)
            return live

        if self._flat is not None:
            adopt(self._params, state['params'], 'params')
        else:
            adopt(dict(self._params), state['params'], 'params')
        out = {'params': self._params,
               'opt': adopt(fresh['opt'], state['opt'], 'opt')}
        if self._buffers:
            out['buffers'] = adopt(self._buffers, saved_buffers, 'buffers')
        for slot, enabled in (('guard', self.guard_enabled),
                              ('scaler', self.scaler is not None)):
            if enabled:
                out[slot] = (adopt(fresh[slot], state[slot], slot)
                             if slot in state else fresh[slot])
            elif slot in state:
                warnings.warn(
                    f"TrainStep.adopt_state: the checkpoint carries a "
                    f"{slot!r} slot this step was built without; dropping "
                    f"it", RuntimeWarning, stacklevel=2)
        return out

    def _localize(self, state):
        """A restored state's leaves at their full shapes -> this rank's
        pieces (leaves already at their piece's shape stay)."""
        def piece(v, n):
            return self._shards.localize(v, n)
        out = dict(state)
        out['params'] = {n: piece(v, n) for n, v in state['params'].items()}
        out['opt'] = {n: {s: piece(v, n) for s, v in slots.items()}
                      for n, slots in state.get('opt', {}).items()}
        return out

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

    def _microbatch(self, batch, i):
        if isinstance(batch, dict):
            return {k: self._microbatch(v, i) for k, v in batch.items()}
        if isinstance(batch, tuple):
            return tuple(self._microbatch(v, i) for v in batch)
        return batch[i] if isinstance(batch, torch.Tensor) else batch

    def __call__(self, state, batch):
        """Run one call (k steps) on ``batch``. Parameters, optimizer slots
        and the guard and scaler counters in ``state`` are updated in
        place. Returns ``(state, StepResult)``; nothing here waits for the
        device (with telemetry on, the sampled calls of the ``engine.step``
        span wait for their losses)."""
        if not _obs.enabled():
            return self._dispatch(state, batch)
        out = []
        with _obs.timer('engine.step', k=self.k,
                        sync=lambda: out[0][1].losses if out else None):
            if not self._cost_captured:
                # the cost explorer counts the program's first dispatch
                self._cost_captured = True
                out.append(_obs.costs.capture(
                    self.cost_label, self._dispatch, state, batch,
                    kind='train_step',
                    meta={'microbatch': self.k, 'donates': False,
                          'sharded': self.sharding is not None}))
            else:
                out.append(self._dispatch(state, batch))
        _obs.counter('engine.steps').inc(self.k)
        _obs.counter('engine.dispatches').inc()
        if self._collective_bytes_est:
            _obs.counter('sharding.collective_bytes_est').inc(
                self._collective_bytes_est * self.k)
        return out[0]

    def _dispatch(self, state, batch):
        if self._feed_specs is not None:
            batch = _split_feeds(batch, self._feed_specs, self._world)
        batch = self._to_device(batch)
        if self.k == 1:
            loss, outs = self._one_step(state, batch)
            return state, StepResult(DeviceLoss(loss), loss, outs)
        losses = torch.stack([self._one_step(
            state, self._microbatch(batch, i))[0] for i in range(self.k)])
        return state, StepResult(DeviceLoss(losses[-1]), losses, None)

    def _leaves(self, state):
        """-> ``(the params the loss_fn gets, names to differentiate)``."""
        if self._shards is not None:
            # the ZeRO use-time gather, into the module's own parameters
            # (their storage becomes the gathered tensors): from here the
            # step is the unsharded one, remat's recompute included
            for n, v in self._shards.gather(state['params']).items():
                if v is not self._full[n]:
                    self._full[n].data = v
        if self._flat is None:
            params = self._full if self._shards is not None \
                else state['params']
            return params, [n for n, p in params.items() if p.requires_grad
                            and (self._trainable is None
                                 or n in self._trainable)]
        master, dt = state['params'], self._flat.compute_dtype
        work = master.detach() if dt is None or dt == master.dtype \
            else master.detach().to(dt)          # the one cast
        leaves = {k: v.detach().requires_grad_()
                  for k, v in self._flat.unflatten(work).items()}
        return leaves, list(leaves)

    def _flat_grad(self, grads, master):
        """The leaves' gradients (the list is emptied) gathered into one
        flat buffer of their dtype, zero in the gaps, then cast to the
        master's dtype once."""
        buf = torch.zeros(self._flat.numel, dtype=grads[0].dtype,
                          device=master.device)
        views = self._flat.unflatten(buf)
        torch._foreach_copy_([views[n] for n in self._flat.names], grads)
        grads.clear()
        return buf.to(master.dtype)

    def _loss(self, leaves, batch):
        """The loss function, under the step's rematerialisation: each
        encoder layer checkpointed, or the whole loss."""
        r = self.remat
        if r is None:
            return self._loss_fn(leaves, batch)
        if not self.remat_by_layer:
            return r(self._loss_fn, leaves, batch)
        with _remat.scope(r):
            return self._loss_fn(leaves, batch)

    def _snapshot(self):
        """The buffers' values: one flat copy a dtype."""
        by_dtype = {}
        for b in self._buffers.values():
            by_dtype.setdefault(b.dtype, []).append(b)
        return {dt: (group, torch.cat([b.reshape(-1) for b in group]))
                for dt, group in by_dtype.items()}

    @staticmethod
    def _restore(snap, ok=None):
        """Copy ``snap`` back into the buffers (with ``ok``, only where the
        step is NOT ok: a device-side select, no host sync)."""
        for group, old in snap.values():
            if ok is not None:
                now = torch.cat([b.reshape(-1) for b in group])
                old = torch.where(ok, now, old)
            torch._foreach_copy_(group, [v.view_as(b) for v, b in zip(
                old.split([b.numel() for b in group]), group)])

    def _forward(self, leaves, batch):
        """The loss on ``leaves`` -> ``(loss, outputs)``; the reference's
        three-argument ``loss_fn`` gets the buffers and its new ones are
        written into them."""
        if not self._functional_buffers:
            out = self._loss(leaves, batch)
            return out if isinstance(out, tuple) else (out, None)
        r = self.remat
        args = (leaves, self._buffers, batch)
        loss, outs, new = self._loss_fn(*args) if r is None \
            else r(self._loss_fn, *args)
        with torch.no_grad():
            for n, b in self._buffers.items():
                if new[n] is not b:
                    b.copy_(new[n])
        return loss, outs

    def _one_step(self, state, batch):
        with batch_stats_over_ranks(self._synced):
            return self._run_one_step(state, batch)

    def _run_one_step(self, state, batch):
        use_scaler = self.scaler is not None
        use_guard = self.guard_enabled
        keep = self._buffers and (use_scaler or use_guard)
        before = self._snapshot() if keep or \
            (self._buffers and self.remat is not None) else None
        leaves, names = self._leaves(state)
        loss, outs = self._forward(leaves, batch)
        after = None
        if self._buffers and self.remat is not None:
            # the recompute in the backward reruns the forward: from the
            # buffers the forward read, and the forward's result after it
            after = self._snapshot()
            self._restore(before)
        scale = state['scaler']['scale'] if use_scaler else None
        ok = torch.isfinite(loss) if (use_scaler or use_guard) else None
        loss_ok = ok
        if names:
            grads = list(torch.autograd.grad(
                loss * scale if use_scaler else loss,
                [leaves[n] for n in names], allow_unused=True,
                materialize_grads=True))
            if self._flat is not None:
                # the compute-dtype views and their gradients go before
                # the update, whose temporaries make the step's peak
                leaves = None
                grads = [self._flat_grad(grads, state['params'])]
            elif self._shards is not None:
                leaves = None     # the gathered parameters go
                pieces = self._shards.reduce_grads(dict(zip(names, grads)))
                grads = [pieces[n] for n in names]
            elif self._dp:
                from ..distributed.sharding import reduce_over_ranks
                grads = reduce_over_ranks(grads, mean=True,
                                          group=self._data_group)
            if use_scaler:
                ok = ok & _unscale_and_check(grads, scale)
        if after is not None:
            self._restore(after)
        if self._synced:
            loss, ok, loss_ok = self._global(loss, ok, loss_ok)
        if keep:
            self._restore(before, ok)
        if self._shards is not None:
            self._release()
        if names:
            if self._flat is not None:
                self._flat.update(state['params'], grads[0], state['opt'],
                                  ok=ok)
            elif self._shards is not None:
                with self._shards.norms(self._params_meta):
                    self.optimizer.functional_update(
                        state['params'], dict(zip(names, grads)),
                        state['opt'], ok=ok, params_meta=self._params_meta)
            else:
                self.optimizer.functional_update(
                    state['params'], dict(zip(names, grads)), state['opt'],
                    ok=ok, params_meta=self._params_meta)
        if use_guard:
            g = state['guard']
            skipped = ~loss_ok
            streak = torch.where(skipped, g['consecutive'] + 1,
                                 torch.zeros_like(g['consecutive']))
            state['guard'] = {
                'steps': g['steps'] + 1,
                'skipped': g['skipped'] + skipped.to(torch.int32),
                'consecutive': streak,
                'peak': torch.maximum(g['peak'], streak)}
        if use_scaler:
            state['scaler'] = self._advance_scaler(state['scaler'], ok)
        loss = loss.detach()
        if outs is not None:
            outs = tuple(o.detach() for o in outs)
        return loss, outs

    def _release(self):
        """Drop the gathered parameters from the module (at rest a rank
        holds its pieces only; the next step gathers them again)."""
        for n in self._shards.layout:
            p = self._full[n]
            p.data = self._empty[p.dtype]

    def _global(self, loss, ok, loss_ok):
        """The global batch's loss (the ranks' mean) and ``ok`` / the
        loss's finiteness on EVERY rank: one all-reduce (sum) of a few
        scalars on the stream."""
        from ..distributed import collective
        parts = [loss.detach().float()]
        if ok is not None:
            parts += [ok.float(), loss_ok.float()]
        vec = torch.stack(parts)
        collective.all_reduce(vec)
        out = (vec[0] / self._world).to(loss.dtype)
        if ok is None:
            return out, None, None
        return out, vec[1] == self._world, vec[2] == self._world

    def _advance_scaler(self, sc, ok):
        """``GradScaler.update`` on the device (the same policy)."""
        s = self.scaler
        if not s._dynamic:
            return sc
        zero = torch.zeros_like(sc['good'])
        bad1 = sc['bad'] + 1
        dec = bad1 >= s._decr_every
        scale_bad = torch.where(
            dec, torch.clamp_min(sc['scale'] * s._decr_ratio, 1.0),
            sc['scale'])
        good1 = sc['good'] + 1
        inc = good1 >= s._incr_every
        scale_good = torch.where(inc, sc['scale'] * s._incr_ratio,
                                 sc['scale'])
        return {'scale': torch.where(ok, scale_good, scale_bad),
                'good': torch.where(ok, torch.where(inc, zero, good1), zero),
                'bad': torch.where(ok, zero, torch.where(dec, zero, bad1))}

    def sync(self, state, nan_guard=None, scaler=None, raise_on_limit=True):
        """Bring the host objects up to the counters the steps kept on the
        device (the one host sync; call it at the log cadence and before
        checkpointing): the live loss scale into the ``GradScaler``, the
        guard's counters into ``NanGuard`` (warning about the steps skipped
        since the last sync), which raises ``NanStepError`` at its limit.
        -> ``{'guard': {...}, 'scaler': {...}}`` as numbers, read in one
        copy."""
        keys = [(slot, k) for slot in ('guard', 'scaler') if slot in state
                for k in state[slot]]
        if not keys:
            return {}
        # the counters' own bytes, as the reference counts them (the copy
        # itself carries them as float64)
        _obs.record_host_transfer(
            sum(state[slot][k].element_size() for slot, k in keys),
            kind='engine.state_sync')
        # float64 holds every int32 counter and the fp32 scale exactly
        values = torch.stack([state[slot][k].to(torch.float64)
                              for slot, k in keys]).tolist()
        fetched = {}
        for (slot, k), v in zip(keys, values):
            fetched.setdefault(slot, {})[k] = v if k == 'scale' else int(v)
        if 'guard' in fetched:
            # rebase the since-last-sync streak maximum BEFORE judging, so
            # that a caught NanStepError does not re-raise at every sync
            state['guard']['peak'] = torch.zeros_like(
                state['guard']['peak'])
        scaler = scaler or self.scaler
        if 'scaler' in fetched and scaler is not None:
            sv = fetched['scaler']
            scaler._scale = float(sv['scale'])
            scaler._good_steps = int(sv['good'])
            scaler._bad_steps = int(sv['bad'])
        if 'guard' in fetched and nan_guard is not None:
            gv = fetched['guard']
            nan_guard.absorb_device_counts(
                gv['steps'], gv['skipped'], gv['consecutive'],
                # the scaler's decrement already ran on the device;
                # marking it again on the host would decay it twice
                mark_scaler=self.scaler is None,
                raise_on_limit=raise_on_limit,
                peak_consecutive=gv['peak'])
        return fetched
