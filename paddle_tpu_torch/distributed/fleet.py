"""Fleet: the distributed training facade. Counterpart of
``paddle_tpu/distributed/fleet.py`` (``Fleet``, ``DistributedStrategy``,
``distributed_optimizer`` -> ``_DistributedOptimizer``,
``distributed_model``, the role predicates, ``utils.recompute``).

"Collective" mode joins the process group (``env.init_parallel_env``);
``distributed_optimizer`` wraps the optimizer so that its gradients are
averaged over the ranks before it steps: eagerly in ``_sync_grads`` (with
``dgc``, the reference's compression stand-in, as a bf16 all-reduce), and
in ``engine.build_train_step`` by the step itself (the wrapper says so
with ``syncs_gradients``). ``strategy.sharding`` resolves to the
``ShardingConfig`` every frontend then uses (``strategy.current_config``);
the knobs that have no sharded step (``dgc``, ``pipeline``,
``hierarchical_allreduce``) raise with it, as the reference's do.
``strategy.tensor_parallel`` (``tensor_parallel_configs``:
``tensor_parallel_degree``, ``param_rules``) installs the reference's 2-D
``(world / tp, tp)`` ``('data', 'model')`` mesh, or raises its
``tensor_parallel_degree=... does not divide`` error, and the config
carries it to ``engine.fit`` and ``hapi.Model.fit(strategy=)``.
Parameter-server mode is not the port's (no server runs): ``is_server()``
is False.
"""
import torch

from . import collective, env

__all__ = ['Fleet', 'DistributedStrategy', 'fleet', 'init',
           'distributed_optimizer', 'distributed_model', 'utils']


class DistributedStrategy:
    """The reference's ``DistributedStrategy`` knobs."""

    def __init__(self):
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False            # ZeRO/FSDP parameter sharding
        self.sharding_configs = {}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {'tensor_parallel_degree': 1}
        self.pipeline = False
        self.pipeline_configs = {'accumulate_steps': 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {'k_steps': 1}
        self.lamb = False
        self.lars = False
        self.dgc = False                 # gradient compression: bf16
        self.nccl_comm_num = 1
        self.hierarchical_allreduce = False


class _RoleMaker:
    def is_first_worker(self):
        return env.get_rank() == 0

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def worker_index(self):
        return env.get_rank()

    def worker_num(self):
        return max(env.get_world_size(), 1)


class Fleet:
    def __init__(self):
        self._strategy = None
        self._role = _RoleMaker()
        self._user_defined_optimizer = None
        self._sharding_config = None

    def sharding_config(self):
        """The resolved ``ShardingConfig`` (None when sharding is off)."""
        return self._sharding_config

    def init(self, role_maker=None, is_collective=True, strategy=None,
             mesh_shape=None, axis_names=None):
        """Join the process group (once) and install the strategy's
        sharding config process-wide."""
        self._strategy = strategy or DistributedStrategy()
        wants = strategy is not None and (strategy.sharding or
                                          strategy.tensor_parallel)
        tp = (int(strategy.tensor_parallel_configs.get(
            'tensor_parallel_degree', 1) or 1)
            if wants and strategy.tensor_parallel else 1)
        if tp > 1 and mesh_shape is None and \
                env.get_world_size(env.MODEL_AXIS) != tp:
            # the reference's (total // tp, tp) data x model mesh
            total = env.get_world_size() if env.is_initialized() \
                else env._rank_world()[1]
            if total % tp:
                raise ValueError(
                    f"tensor_parallel_degree={tp} does not divide the "
                    f"{total} available devices")
            env.init_parallel_env((total // tp, tp),
                                  (env.DATA_AXIS, env.MODEL_AXIS))
        elif not env.is_initialized():
            env.init_parallel_env(mesh_shape, axis_names)
        self._install_sharding(strategy if wants else None)
        return self

    def _install_sharding(self, strategy):
        """Resolve-or-raise the strategy's sharding knobs into THE config
        and install it process-wide (None when the knobs are off: a stale
        config would keep sharding after the knob is turned off)."""
        from . import strategy as _strategy
        self._sharding_config = (_strategy.resolve_sharding(strategy)
                                 if strategy is not None else None)
        _strategy.set_current_config(self._sharding_config)

    # role predicates -------------------------------------------------------
    def is_first_worker(self):
        return self._role.is_first_worker()

    def worker_index(self):
        return self._role.worker_index()

    def worker_num(self):
        return self._role.worker_num()

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def server_num(self):
        return 0

    def barrier_worker(self):
        collective.barrier()

    def init_worker(self):
        pass

    def init_server(self, *args, **kwargs):
        pass

    def run_server(self):
        pass

    def stop_worker(self):
        pass

    @property
    def worker_endpoints(self):
        return env.ParallelEnv().trainer_endpoints

    # optimizer -------------------------------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        """``optimizer`` wrapped to average its gradients over the ranks;
        ``strategy.lamb`` / ``lars`` swap in ``Lamb`` / ``LarsMomentum``
        with the user's learning rate, parameters and clip, as the
        reference's meta-optimizers do."""
        self._strategy = strategy or self._strategy or DistributedStrategy()
        st = self._strategy
        self._install_sharding(st if (st.sharding or st.tensor_parallel)
                               else None)
        from ..optimizer.optimizer import Lamb, LarsMomentum
        if st.lamb and not isinstance(optimizer, Lamb):
            kw = {}
            wd = getattr(optimizer, '_weight_decay', None)
            if isinstance(wd, (int, float)):
                kw['lamb_weight_decay'] = float(wd)
            optimizer = Lamb(learning_rate=optimizer._lr,
                             parameters=optimizer._parameters,
                             grad_clip=optimizer._grad_clip, **kw)
        elif st.lars and not isinstance(optimizer, LarsMomentum):
            kw = {}
            m = getattr(optimizer, '_momentum', None)
            if isinstance(m, (int, float)):
                kw['momentum'] = float(m)
            wd = getattr(optimizer, '_weight_decay', None)
            if isinstance(wd, (int, float)):
                kw['lars_weight_decay'] = float(wd)
            optimizer = LarsMomentum(learning_rate=optimizer._lr,
                                     parameters=optimizer._parameters,
                                     grad_clip=optimizer._grad_clip, **kw)
        self._user_defined_optimizer = optimizer
        return _DistributedOptimizer(optimizer, st,
                                     sharding_config=self._sharding_config)

    def distributed_model(self, model):
        from .parallel import DataParallel
        return DataParallel(model)


class _DistributedOptimizer:
    """An optimizer whose gradients are averaged over the ranks before it
    steps. Carries the resolved ``sharding_config`` and forwards the
    functional surface, so ``engine.build_train_step`` and hapi's
    ``Model.prepare`` take it wherever a bare optimizer goes."""

    # engine.build_train_step: the step averages the gradients itself
    syncs_gradients = True

    def __init__(self, inner, strategy, sharding_config=None):
        self.inner = inner
        self.strategy = strategy
        self.sharding_config = sharding_config
        self._accum = 0
        self._scaled_pending = False
        self._scaler = None
        if strategy is not None and strategy.amp:
            from ..amp import GradScaler
            cfg = strategy.amp_configs or {}
            self._scaler = GradScaler(
                init_loss_scaling=cfg.get('init_loss_scaling', 2.0 ** 15))

    @property
    def _parameters(self):
        return self.inner._parameters

    @_parameters.setter
    def _parameters(self, value):
        self.inner._parameters = value

    @property
    def _accumulators(self):
        return self.inner._accumulators

    @property
    def _grad_clip(self):
        return self.inner._grad_clip

    def get_lr(self):
        return self.inner.get_lr()

    def init_state_values(self, param_values):
        return self.inner.init_state_values(param_values)

    def functional_update(self, *args, **kwargs):
        return self.inner.functional_update(*args, **kwargs)

    @torch.no_grad()
    def _sync_grads(self):
        if not env.is_initialized():
            return
        from .sharding import reduce_over_ranks
        grads = [p.grad for _, p in self.inner._parameters or []
                 if p.grad is not None]
        dgc = bool(self.strategy and self.strategy.dgc)
        if grads:
            torch._foreach_copy_(grads, reduce_over_ranks(
                grads, mean=True,
                wire_dtype=torch.bfloat16 if dgc else None))

    def _k_steps(self):
        return (self.strategy.gradient_merge_configs.get('k_steps', 1)
                if self.strategy and self.strategy.gradient_merge else 1)

    def step(self):
        self._accum += 1
        if self._accum % self._k_steps() != 0:
            return  # keep accumulating (the .grads sum)
        self._sync_grads()
        if self._scaled_pending:
            # the gradients carry the loss scale (minimize scaled the
            # loss): scaler.step unscales them before the inner update
            self._scaled_pending = False
            self._scaler.step(self.inner)
        else:
            self.inner.step()

    def minimize(self, loss, *args, **kwargs):
        if self._scaler is not None:
            self._scaled_pending = True
            self._scaler.scale(loss).backward()
        else:
            loss.backward()
        self.step()
        self.clear_grad()
        return [], []

    def clear_grad(self):
        if self._accum % self._k_steps() == 0:
            self.inner.clear_grad()

    def state_dict(self):
        return self.inner.state_dict()

    def set_state_dict(self, sd):
        return self.inner.set_state_dict(sd)


class _FleetUtils:
    """``fleet.utils`` (parity: ``paddle.distributed.fleet.utils``)."""

    @staticmethod
    def recompute(function, *args, **kwargs):
        from .recompute import recompute as _recompute
        return _recompute(function, *args, **kwargs)


utils = _FleetUtils()

fleet = Fleet()

# module-level API parity: fleet.init(...), fleet.distributed_optimizer(...)
init = fleet.init
distributed_optimizer = fleet.distributed_optimizer
distributed_model = fleet.distributed_model
is_first_worker = fleet.is_first_worker
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_worker = fleet.is_worker
is_server = fleet.is_server
init_worker = fleet.init_worker
init_server = fleet.init_server
run_server = fleet.run_server
stop_worker = fleet.stop_worker
barrier_worker = fleet.barrier_worker
UserDefinedRoleMaker = _RoleMaker
PaddleCloudRoleMaker = _RoleMaker
