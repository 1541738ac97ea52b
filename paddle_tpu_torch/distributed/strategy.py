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
each leaf is split along its first dim that the data axis divides; leaves
under ``min_size`` elements, and leaves with no such dim, stay whole. The
mesh is the process group's (``env.get_mesh()``): its data axis's size is
``data_degree`` / ``fsdp_degree``, ``num_devices`` is the world (1 without
a group). Specs are tuples of axis names and None, the reference's
``PartitionSpec`` as a plain tuple.

Tensor parallelism composes on the model axis, as in the reference:
``tensor_parallel_degree`` is the model axis's size (the default mesh is
the installed one, which must have a ``'model'`` axis of that size: the
reference's error otherwise), and ``param_rules`` (``{name-substring:
spec}`` in the reference's (in, out) layout) name the parameters that
keep a model-axis layout through the step: the step turns them into
Megatron's layers (``sharding.apply_tensor_parallel``), FSDP shards only
the others, over the data axis, and nothing gathers the model-axis
pieces. ``with_rules_from(layer)`` adds the rules of a module's
tensor-parallel layers (``ColumnParallelLinear`` and friends).
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


def mesh_axes(mesh):
    """``{axis: size}`` of a mesh: ``env.Mesh``'s own, a 1-D
    ``DeviceMesh``'s data axis, ``{'data': 1}`` for None (no group)."""
    if mesh is None:
        return {env.DATA_AXIS: 1}
    if isinstance(mesh, env.Mesh):
        return dict(mesh.shape)
    names = getattr(mesh, 'mesh_dim_names', None) or (env.DATA_AXIS,)
    return {names[i]: int(mesh.size(i)) for i in range(len(names))}


class ShardingConfig:
    """The resolved sharding plan of a train step.

    - ``mesh``: the process group's mesh (``env.get_mesh()``), or None
      for world 1;
    - ``fsdp``: shard parameters and optimizer moments over the data
      axis;
    - ``min_size``: leaves under this many elements stay whole;
    - ``gather_params``: the ZeRO use-time gather (must be True);
    - ``fsdp_axes``: the data axis;
    - ``tensor_parallel_degree``, ``param_rules``: see the module
      docstring."""

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
        if not self.gather_params:
            raise NotImplementedError(
                "ShardingConfig(gather_params=False): the reference lets "
                "GSPMD propagate sharded layouts into the matmuls; the "
                "port's step runs each product on gathered parameters")
        self.fsdp_axes = tuple(fsdp_axes) if fsdp_axes else (data_axis,)
        if self.fsdp_axes != (data_axis,):
            raise ValueError(f"ShardingConfig: fsdp_axes {self.fsdp_axes}: "
                             f"FSDP shards over the data axis {data_axis!r}")
        self.mesh = mesh if mesh is not None else self._default_mesh()
        axes = mesh_axes(self.mesh)
        for ax in self.fsdp_axes + ((model_axis,)
                                    if self.tensor_parallel_degree > 1
                                    else ()):
            if ax not in axes:
                raise ValueError(f"ShardingConfig: axis {ax!r} not in mesh "
                                 f"axes {tuple(axes)}")

    def _default_mesh(self):
        """The installed mesh, if it can carry this plan (the reference's
        errors otherwise); None without a group."""
        existing = env.get_mesh()
        tp = self.tensor_parallel_degree
        if existing is None:
            if tp > 1:
                raise ValueError(
                    f"tensor_parallel_degree={tp} does not divide the 1 "
                    f"available devices")
            return None
        axes = mesh_axes(existing)
        if self.data_axis in axes and \
                (tp <= 1 or axes.get(self.model_axis, 1) == tp):
            return existing
        raise ValueError(
            f"the installed device mesh (axes {axes}) cannot carry this "
            f"sharding plan (need axis {self.data_axis!r}"
            + (f" and {self.model_axis!r} of size {tp}" if tp > 1 else "")
            + "); re-init the mesh or pass mesh= explicitly")

    # -- sizes ---------------------------------------------------------------
    @property
    def data_degree(self):
        return int(mesh_axes(self.mesh).get(self.data_axis, 1))

    fsdp_degree = data_degree

    @property
    def model_degree(self):
        return int(mesh_axes(self.mesh).get(self.model_axis, 1))

    @property
    def num_devices(self):
        return int(np.prod(list(mesh_axes(self.mesh).values())))

    # -- spec derivation -----------------------------------------------------
    def _tp_spec(self, name):
        for pat, spec in self.param_rules.items():
            if pat in name:
                return tuple(spec)
        return None

    def _fsdp_spec(self, shape):
        from .sharding import first_divisible_spec
        return first_divisible_spec(shape, self.fsdp_degree,
                                    self.fsdp_axes[0], self.min_size)

    def param_specs(self, params):
        """``{name: spec}`` for a params dict (name -> value or shape): a
        rule's spec, else the FSDP spec (``()`` without ``fsdp``)."""
        out = {}
        for name, v in params.items():
            spec = self._tp_spec(name)
            if spec is None:
                spec = self._fsdp_spec(_leaf_shape(v)) if self.fsdp else ()
            out[name] = spec
        return out

    def with_rules_from(self, layer):
        """A config with the rules of ``layer``'s tensor-parallel layers
        added (their parameters' ``tp_spec``, the reference's eager
        placements), so that the step keeps their layout; ``self`` when
        there are none."""
        rules = dict(self.param_rules)
        added = False
        for name, p in layer.named_parameters():
            spec = getattr(p, 'tp_spec', None)
            if spec is not None and self.model_axis in spec and \
                    name not in rules:
                rules[name] = tuple(spec)
                added = True
        if not added:
            return self
        import copy
        clone = copy.copy(self)
        clone.param_rules = rules
        return clone

    def gather_names(self, params, specs=None):
        """Parameters the step all-gathers at use: the FSDP-sharded ones
        (a rule's model-axis pieces keep their layout)."""
        specs = specs if specs is not None else self.param_specs(params)
        return frozenset(n for n, s in specs.items()
                         if s != () and self._tp_spec(n) is None)

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
            if specs.get(name, ()) == () or self._tp_spec(name) is not None:
                continue
            total += 3 * _nbytes(v) * (k - 1) // k
        return total

    def describe(self):
        return {'mesh': mesh_axes(self.mesh),
                'fsdp': self.fsdp, 'fsdp_axes': list(self.fsdp_axes),
                'min_size': self.min_size,
                'tensor_parallel_degree': self.tensor_parallel_degree,
                'gather_params': self.gather_params,
                'tp_rules': {k: list(v) for k, v in self.param_rules.items()}}


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
