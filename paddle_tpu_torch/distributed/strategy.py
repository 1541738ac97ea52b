"""The resolved sharding strategy every frontend consumes. Counterpart of
``paddle_tpu/distributed/strategy.py`` (``ShardingConfig``,
``resolve_sharding``, ``current_config``).

The fleet ``DistributedStrategy`` knobs (``sharding``) and the
hapi/engine ``strategy=`` / ``sharding=`` arguments all resolve to a
``ShardingConfig``, which ``engine.build_train_step(sharding=)`` runs as
the FSDP step (``distributed.sharding.FlatShards``). The recipe is
ZeRO's, as the reference's: parameters and optimizer moments live sharded
at rest (each rank holds 1/k of every large tensor), the step all-gathers
the full parameters at use (``gather_params=True``, the only setting:
the port has no sharded matmul to propagate into), reduce-scatters the
gradients (their mean) and updates the shards. Because the gather makes
the compute the replicated step's, sharding trades memory and bandwidth,
not numbers.

The shard rule is the reference's (``sharding.first_divisible_spec``):
each leaf is split along its first dim that the world divides; leaves
under ``min_size`` elements, and leaves with no such dim, stay whole. The
"mesh" is the process group: ``data_degree`` / ``fsdp_degree`` /
``num_devices`` are its size (1 without one). Specs are tuples of axis
names and None, the reference's ``PartitionSpec`` as a plain tuple.

Tensor parallelism (``tensor_parallel_degree > 1``, ``param_rules``)
waits for ROADMAP.md Queue 1 item 5b and raises naming it.
"""
import numpy as np

from . import env

__all__ = ['ShardingConfig', 'resolve_sharding', 'current_config',
           'set_current_config']

# the resolved config fleet.init() / distributed_optimizer() installed, so
# frontends that never see the strategy object still find it; None means
# "no sharding requested"
_current = [None]


def set_current_config(config):
    _current[0] = config


def current_config():
    return _current[0]


def _leaf_shape(v):
    """Shape of a leaf: a tensor or array, or an explicit shape."""
    shape = getattr(v, 'shape', None)
    if shape is None and isinstance(v, (tuple, list)):
        return tuple(v)
    return tuple(shape)


def _nbytes(v):
    try:
        return int(v.numel()) * v.element_size()
    except AttributeError:
        return int(np.prod(_leaf_shape(v) or (1,))) * \
            np.dtype(getattr(v, 'dtype', np.float32)).itemsize


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_leaves(v)
    elif hasattr(tree, 'shape'):
        yield tree


def _waits_5b(what):
    return NotImplementedError(
        f"ShardingConfig: {what}: tensor parallelism waits for ROADMAP.md, "
        f"Queue 1 item 5b")


class ShardingConfig:
    """The resolved sharding plan of a train step.

    - ``mesh``: the process group's ``DeviceMesh`` (``env.get_mesh()``),
      or None for world 1;
    - ``fsdp``: shard parameters and optimizer moments over the ranks;
    - ``min_size``: leaves under this many elements stay whole;
    - ``gather_params``: the ZeRO use-time gather (must be True);
    - ``fsdp_axes``: the data axis (the one axis there is)."""

    def __init__(self, mesh=None, data_axis=env.DATA_AXIS,
                 model_axis=env.MODEL_AXIS, fsdp=True, min_size=1024,
                 fsdp_axes=None, tensor_parallel_degree=1, param_rules=None,
                 gather_params=True):
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.fsdp = bool(fsdp)
        self.min_size = int(min_size)
        self.tensor_parallel_degree = int(tensor_parallel_degree)
        self.param_rules = dict(param_rules or {})
        self.gather_params = bool(gather_params)
        if self.tensor_parallel_degree > 1:
            raise _waits_5b(f"tensor_parallel_degree="
                            f"{self.tensor_parallel_degree}")
        if self.param_rules:
            raise _waits_5b("param_rules")
        if not self.gather_params:
            raise NotImplementedError(
                "ShardingConfig(gather_params=False): the reference lets "
                "GSPMD propagate sharded layouts into the matmuls; the "
                "port's step runs each product on gathered parameters")
        self.fsdp_axes = tuple(fsdp_axes) if fsdp_axes else (data_axis,)
        if self.fsdp_axes != (data_axis,):
            raise ValueError(f"ShardingConfig: fsdp_axes {self.fsdp_axes}: "
                             f"the process group has the one axis "
                             f"{data_axis!r}")
        self.mesh = mesh if mesh is not None else env.get_mesh()

    # -- sizes ---------------------------------------------------------------
    @property
    def data_degree(self):
        if self.mesh is not None:
            return int(self.mesh.size())
        return env.get_world_size()

    fsdp_degree = data_degree
    num_devices = data_degree

    # -- spec derivation -----------------------------------------------------
    def _fsdp_spec(self, shape):
        from .sharding import first_divisible_spec
        return first_divisible_spec(shape, self.fsdp_degree,
                                    self.fsdp_axes[0], self.min_size)

    def param_specs(self, params):
        """``{name: spec}`` for a params dict (name -> value or shape)."""
        return {name: (self._fsdp_spec(_leaf_shape(v)) if self.fsdp
                       else ())
                for name, v in params.items()}

    def gather_names(self, params, specs=None):
        """Parameters the step all-gathers at use: the sharded ones."""
        specs = specs if specs is not None else self.param_specs(params)
        return frozenset(n for n, s in specs.items() if s != ())

    def state_shardings(self, state, specs=None):
        """The spec tree of an engine state (``{'params', 'opt', 'guard'?,
        'scaler'?}``, full shapes): an optimizer slot shards like its
        parameter when their shapes match, other slots stay whole."""
        params = state['params']
        specs = specs if specs is not None else self.param_specs(params)

        def whole(tree):
            if isinstance(tree, dict):
                return {k: whole(v) for k, v in tree.items()}
            return ()
        out = {'params': {n: specs.get(n, ()) for n in params}}
        opt = {}
        for n, slots in state.get('opt', {}).items():
            pshape = _leaf_shape(params[n]) if n in params else None
            opt[n] = {s: (specs.get(n, ()) if pshape is not None
                          and hasattr(v, 'shape')
                          and _leaf_shape(v) == pshape else ())
                      for s, v in slots.items()}
        out['opt'] = opt
        for extra in ('buffers', 'guard', 'scaler'):
            if extra in state:
                out[extra] = whole(state[extra])
        return out

    def batch_sharding(self, microbatch=1):
        """The feeds' spec: split over the ranks on their batch dim (dim 0,
        or dim 1 under microbatching, where dim 0 is the microbatch axis).
        Each rank feeds its own slice (``io.DistributedBatchSampler``)."""
        return (self.data_axis,) if microbatch <= 1 \
            else (None, self.data_axis)

    # -- accounting ----------------------------------------------------------
    def bytes_per_device(self, tree):
        """The bytes this rank holds of ``tree`` (its leaves as they are:
        a sharded step's state holds each rank's shards)."""
        return sum(_nbytes(v) for v in _tree_leaves(tree))

    def collective_bytes_estimate(self, params, specs=None):
        """The reference's analytic per-step traffic a device of the FSDP
        recipe: each sharded parameter's (k-1)/k gathered for the forward
        and the backward and reduce-scattered once (3 x)."""
        specs = specs if specs is not None else self.param_specs(params)
        k = self.fsdp_degree
        if k <= 1:
            return 0
        total = 0
        for name, v in params.items():
            if specs.get(name, ()) == ():
                continue
            total += 3 * _nbytes(v) * (k - 1) // k
        return total

    def describe(self):
        return {'mesh': {self.data_axis: self.data_degree},
                'fsdp': self.fsdp, 'fsdp_axes': list(self.fsdp_axes),
                'min_size': self.min_size,
                'tensor_parallel_degree': self.tensor_parallel_degree,
                'gather_params': self.gather_params, 'tp_rules': {}}


# knobs on fleet.DistributedStrategy that have NO sharded-step
# implementation: accepting them silently would let users believe they
# sharded/compressed when they did not
_UNSUPPORTED_WITH_SHARDING = ('dgc', 'pipeline', 'hierarchical_allreduce')
_SHARDING_CONFIG_KEYS = {'min_size', 'gather_params', 'fsdp_axes',
                         'sharding_degree', 'stage'}
_TP_CONFIG_KEYS = {'tensor_parallel_degree', 'param_rules'}


def resolve_sharding(obj, params_rules=None):
    """Normalize what a frontend accepts into a ``ShardingConfig``.

    ``None`` -> None (unsharded); a ``ShardingConfig`` passes through; a
    fleet ``DistributedStrategy`` with ``sharding`` (or
    ``tensor_parallel``) set resolves, and its unsupported companion knobs
    raise ``NotImplementedError``, as the reference's; a dict is taken as
    ``ShardingConfig`` keyword arguments; anything else is a
    ``TypeError``."""
    if obj is None or isinstance(obj, ShardingConfig):
        return obj
    if isinstance(obj, dict):
        return ShardingConfig(**obj)
    if hasattr(obj, 'sharding') and hasattr(obj, 'tensor_parallel'):
        if not (obj.sharding or obj.tensor_parallel):
            return None
        for knob in _UNSUPPORTED_WITH_SHARDING:
            if getattr(obj, knob, False):
                raise NotImplementedError(
                    f"DistributedStrategy.{knob}=True has no sharded-step "
                    f"implementation — combined with sharding/"
                    f"tensor_parallel it would be silently ignored; unset "
                    f"it or drop the sharding flags")
        scfg = dict(getattr(obj, 'sharding_configs', None) or {})
        stage = scfg.pop('stage', None)
        if stage is not None and stage not in (2, 3):
            raise NotImplementedError(
                f"sharding_configs['stage']={stage!r}: only the ZeRO "
                f"stage-2/3 recipe (params + optimizer states sharded at "
                f"rest, gathered at use) is implemented")
        scfg.pop('sharding_degree', None)   # the degree is the group's
        unknown = set(scfg) - _SHARDING_CONFIG_KEYS
        if unknown:
            raise NotImplementedError(
                f"sharding_configs keys {sorted(unknown)} are not "
                f"implemented (supported: {sorted(_SHARDING_CONFIG_KEYS)})")
        tcfg = dict(getattr(obj, 'tensor_parallel_configs', None) or {})
        tp = int(tcfg.pop('tensor_parallel_degree', 1) or 1)
        if not obj.tensor_parallel:
            tp = 1
        rules = tcfg.pop('param_rules', None)
        if tcfg:
            raise NotImplementedError(
                f"tensor_parallel_configs keys {sorted(tcfg)} are not "
                f"implemented (supported: {sorted(_TP_CONFIG_KEYS)})")
        return ShardingConfig(fsdp=bool(obj.sharding),
                              tensor_parallel_degree=tp,
                              param_rules=rules or params_rules, **scfg)
    raise TypeError(
        f"cannot resolve a sharding config from {type(obj).__name__!r} "
        f"(pass a ShardingConfig, a fleet.DistributedStrategy, a kwargs "
        f"dict, or None)")
