"""The distributed environment: the process group, rank and world.
Counterpart of ``paddle_tpu/distributed/env.py``.

The reference is one process over a ``jax.sharding.Mesh``, and a "rank" is
a mesh position. The port is PyTorch's model: **one process a rank**, a
``torch.distributed`` process group, and collectives that really run:

- ``init_parallel_env()`` joins the group: rank and world from the trainer
  environment ``spawn`` and ``launch`` set (``PADDLE_TRAINER_ID``,
  ``PADDLE_TRAINERS_NUM``; else torch's ``RANK``, ``WORLD_SIZE``; else rank
  0 of 1); the rendezvous from ``MASTER_ADDR``/``MASTER_PORT``, else the
  first of ``PADDLE_TRAINER_ENDPOINTS``, else (a supervised rank) a
  ``file://`` store in the supervisor's run dir, one a generation, so that
  parallel jobs on one machine never race for a TCP port, else (world 1) a
  ``file://`` store in a private temporary directory;
- the backend: NCCL for CUDA tensors and gloo for CPU tensors (one group
  serving both) when the machine has a GPU, gloo alone without one, or the
  one named (``backend='gloo'``; ``'cpu'`` means gloo). A rank's device is
  ``cuda:(rank % device_count)``; NCCL that fails to initialise is an
  error, never a quiet switch to gloo;
- no group, no collectives: without ``init_parallel_env`` every entry
  point of the port runs as one process, and ``get_world_size()`` is 1. A
  group of any size, world 1 included, issues its collectives: nothing
  short-circuits on a world of one;
- ``init_distributed(coordinator_address=...)`` is the rendezvous with the
  reference's retry and backoff, under the collective deadline
  (``deadline.set_timeout``), whose value is also the group's own timeout;
- ``get_mesh()`` is a 1-D ``DeviceMesh`` over the group's ranks with the
  axis ``'data'``, unless ``init_parallel_env(mesh_shape=, axis_names=)``
  installed a ``Mesh`` of its own: a 2-D ``('data', 'model')`` mesh
  (tensor parallelism), or a mesh of one ``'pipe'`` or ``'seq'`` axis
  (the pipeline, ring attention). Ranks follow the reference's
  ``devices.reshape(mesh_shape)``: on a ``(d, m)`` mesh rank ``i * m + j``
  sits at data index ``i``, model index ``j`` (the model axis varies
  fastest). Each axis has a process group of its own (``axis_group``):
  ``get_world_size(axis)`` and ``get_rank(axis)`` answer on it, and an
  axis the mesh lacks has one rank, as the reference's
  ``mesh.shape.get(axis, 1)``.

Under a supervised launch each rank also heartbeats into the run dir and
writes its started marker (``_announce_to_supervisor``).
"""
import datetime
import itertools
import math
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

__all__ = ['init_parallel_env', 'init_distributed', 'get_rank',
           'get_world_size', 'ParallelEnv', 'get_mesh', 'set_mesh',
           'is_initialized', 'device', 'shutdown', 'axis_group', 'axis_ranks',
           'rank_at',
           'Mesh', 'SINGLE',
           'DATA_AXIS', 'MODEL_AXIS', 'PIPE_AXIS', 'SEQ_AXIS']

DATA_AXIS = 'data'
MODEL_AXIS = 'model'
PIPE_AXIS = 'pipe'
SEQ_AXIS = 'seq'

# 'backend': the default a spawned rank's init_parallel_env() takes (spawn's
# backend=)
_global = {'mesh': None, 'heartbeat': None, 'device': None,
           'store_dir': None, 'backend': None}


def _announce_to_supervisor():
    """Under a supervised launch (``PADDLE_TPU_HEARTBEAT_DIR`` /
    ``PADDLE_TPU_STARTED_FILE``) start this rank's heartbeat and write the
    started marker, which ends boot-phase restart eligibility: a rank past
    the rendezvous may have joined collectives. Idempotent."""
    started = os.environ.get('PADDLE_TPU_STARTED_FILE')
    if started and not os.path.exists(started):
        with open(started, 'w'):   # atomic-ok: zero-byte phase marker
            pass
    hb_dir = os.environ.get('PADDLE_TPU_HEARTBEAT_DIR')
    rank = os.environ.get('PADDLE_TRAINER_ID')
    if hb_dir and rank is not None and not _global['heartbeat']:
        from ..resilience.watchdog import Heartbeat
        _global['heartbeat'] = Heartbeat(
            os.path.join(hb_dir, f'hb_{rank}')).start()


def _env_int(*names, default):
    for n in names:
        v = os.environ.get(n, '').strip()
        if v:
            return int(v)
    return default


def _rank_world():
    rank = _env_int('PADDLE_TRAINER_ID', 'RANK', default=0)
    world = _env_int('PADDLE_TRAINERS_NUM', 'WORLD_SIZE', default=1)
    return rank, world


def _init_method(world):
    """The rendezvous URL (see the module docstring for the order)."""
    hb_dir = os.environ.get('PADDLE_TPU_HEARTBEAT_DIR')
    gen = os.environ.get('PADDLE_TPU_ELASTIC_GENERATION', '0') or '0'
    if hb_dir and os.environ.get('PADDLE_TPU_SPAWN_WORKER') == '1':
        return 'file://' + os.path.join(hb_dir, f'store_gen{gen}')
    if os.environ.get('MASTER_ADDR') and os.environ.get('MASTER_PORT'):
        return (f"tcp://{os.environ['MASTER_ADDR']}:"
                f"{os.environ['MASTER_PORT']}")
    eps = [e for e in os.environ.get('PADDLE_TRAINER_ENDPOINTS',
                                     '').split(',') if e]
    if len(eps) > 1 or (eps and world > 1):
        return f'tcp://{eps[0]}'
    if hb_dir:
        return 'file://' + os.path.join(hb_dir, f'store_gen{gen}')
    if world == 1:
        d = tempfile.mkdtemp(prefix='paddle_tpu_torch_pg_')
        _global['store_dir'] = d
        return 'file://' + os.path.join(d, 'store')
    raise ValueError(
        f"init_parallel_env: world {world} needs a rendezvous: set "
        f"MASTER_ADDR and MASTER_PORT, or PADDLE_TRAINER_ENDPOINTS, or run "
        f"the ranks through distributed.spawn / distributed.launch")


def _backend(backend):
    """The process group's backend string for ``backend``."""
    if backend in (None, 'auto', 'gpu', 'cuda', 'nccl'):
        if torch.cuda.is_available():
            return 'cpu:gloo,cuda:nccl'
        if backend == 'nccl':
            raise RuntimeError("init_parallel_env: backend='nccl' needs a "
                               "CUDA device; this machine has none")
        return 'gloo'
    if backend in ('cpu', 'gloo'):
        return 'gloo'
    raise ValueError(f"init_parallel_env: unknown backend {backend!r}; "
                     f"expected None, 'nccl', 'gloo' or 'cpu'")


def _group_timeout():
    from .deadline import get_timeout
    t = get_timeout()
    return None if not t else datetime.timedelta(seconds=float(t))


def _join(backend, init_method, rank, world):
    kwargs = {}
    timeout = _group_timeout()
    if timeout is not None:
        kwargs['timeout'] = timeout
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world, **kwargs)


class Mesh:
    """The device mesh of ``init_parallel_env(mesh_shape=, axis_names=)``:
    ``shape`` (``{axis: size}``, as the reference's ``Mesh.shape``),
    ``axis_names``, this rank's ``coords`` (``{axis: index}``) and, for
    each axis, the global ranks of this rank's group along it
    (``ranks(axis)``) and that group (``get_group(axis)``; None is the
    default group, when the axis spans every rank)."""

    def __init__(self, shape, names, coords, ranks, groups):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)
        self.mesh_dim_names = self.axis_names
        self.coords = coords
        self._ranks = ranks
        self._groups = groups

    def size(self, dim=None):
        if dim is None:
            return math.prod(self.shape.values())
        axis = self.axis_names[dim] if isinstance(dim, int) else dim
        return self.shape[axis]

    def ranks(self, axis):
        return list(self._ranks[axis])

    def get_group(self, axis):
        return self._groups[axis]

    def get_local_rank(self, axis):
        return self.coords[axis]

    def __repr__(self):
        return f"Mesh({self.shape})"


def _install_mesh(shape, names):
    """Make every axis's process groups (each rank makes all of them, in
    one order: ``new_group`` is collective) and install the ``Mesh``."""
    rank, world = dist.get_rank(), dist.get_world_size()
    coords = dict(zip(names, (int(i) for i in np.unravel_index(rank,
                                                                shape))))
    ranks, groups = {}, {}
    for a, axis in enumerate(names):
        others = [range(n) if b != a else [None]
                  for b, n in enumerate(shape)]
        for fixed in itertools.product(*others):
            members = []
            for i in range(shape[a]):
                idx = list(fixed)
                idx[a] = i
                members.append(int(np.ravel_multi_index(idx, shape)))
            mine = rank in members
            if shape[a] == world:
                group = None            # the default group: every rank
            elif shape[a] == 1:
                group = SINGLE
            else:
                group = dist.new_group(ranks=members)
            if mine:
                ranks[axis], groups[axis] = members, group
    _global['mesh'] = Mesh(shape, names, coords, ranks, groups)


def init_parallel_env(mesh_shape=None, axis_names=None, backend=None):
    """Join (once) the process group of this rank -> ``ParallelEnv()``.

    ``mesh_shape``: None (a 1-D ``'data'`` mesh over the ranks), or a
    shape whose product is the world, with ``axis_names`` (default the
    reference's ``('data', 'model', 'pipe', 'seq')[:len(mesh_shape)]``):
    its ``Mesh`` and one process group an axis (see the module
    docstring). ``backend``: None (NCCL for CUDA tensors, gloo for CPU
    ones), ``'nccl'``, ``'gloo'`` or ``'cpu'``."""
    _announce_to_supervisor()
    shape = names = None
    if mesh_shape is not None:
        shape = tuple(int(s) for s in mesh_shape)
        names = tuple(axis_names or (DATA_AXIS, MODEL_AXIS, PIPE_AXIS,
                                     SEQ_AXIS)[:len(shape)])
        if len(names) != len(shape) or len(set(names)) != len(names):
            raise ValueError(f"init_parallel_env: axis names {names} do not "
                             f"name the {len(shape)} axes of {shape}")
    if not dist.is_initialized():
        rank, world = _rank_world()
        if shape is not None and math.prod(shape) != world:
            raise ValueError(f"init_parallel_env: mesh_shape {shape} does "
                             f"not hold the {world} ranks")
        bk = _backend(backend if backend is not None
                      else _global['backend'])
        if 'nccl' in bk:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        _join(bk, _init_method(world), rank, world)
    elif shape is not None and math.prod(shape) != dist.get_world_size():
        raise ValueError(f"init_parallel_env: mesh_shape {shape} does not "
                         f"hold the {dist.get_world_size()} ranks")
    if shape is not None and names != (DATA_AXIS,):
        _install_mesh(shape, names)
    _global['device'] = None
    return ParallelEnv()


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, max_init_retries=3, timeout=None,
                     backend=None):
    """The multi-host rendezvous (parity: ``paddle.distributed.launch``'s
    environment wiring), retried with exponential backoff and jitter
    (``resilience.retry``): a rescheduled coordinator routinely comes up
    seconds after its workers. A failed attempt's partial group is torn
    down so that the next attempt may initialise again. ``timeout`` (or
    the process-wide ``set_timeout``) bounds each attempt and becomes the
    group's own timeout; an attempt that runs out of it raises
    ``DistributedTimeoutError('rendezvous')``."""
    from ..resilience.retry import retry as _retry
    from . import deadline as _deadline
    if coordinator_address is None:
        return init_parallel_env(backend=backend)
    rank = int(process_id if process_id is not None else _rank_world()[0])
    world = int(num_processes if num_processes is not None
                else _rank_world()[1])
    budget = timeout if timeout is not None else _deadline.get_timeout()
    bk = _backend(backend)
    url = coordinator_address if '://' in str(coordinator_address) \
        else f'tcp://{coordinator_address}'

    def connect():
        kwargs = {}
        if budget:
            kwargs['timeout'] = datetime.timedelta(seconds=float(budget))
        try:
            if 'nccl' in bk:
                torch.cuda.set_device(rank % torch.cuda.device_count())
            dist.init_process_group(backend=bk, init_method=url, rank=rank,
                                    world_size=world, **kwargs)
        except Exception as e:
            if dist.is_initialized():
                dist.destroy_process_group()
            if budget and ('imeout' in str(e) or 'imed out' in str(e)):
                raise _deadline._expired('rendezvous', coordinator_address,
                                         budget) from e
            raise
    _announce_to_supervisor()
    if not dist.is_initialized():
        _retry(max_attempts=max_init_retries, backoff=1.0, factor=2.0,
               jitter=0.5,
               retry_on=(RuntimeError, ConnectionError, OSError,
                         TimeoutError))(connect)()
    return ParallelEnv()


def shutdown():
    """Leave the process group (and drop the mesh); a no-op without one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _global['mesh'] = None
    _global['device'] = None
    d, _global['store_dir'] = _global['store_dir'], None
    if d:
        import shutil
        shutil.rmtree(d, ignore_errors=True)


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def _custom_mesh():
    m = _global['mesh']
    return m if isinstance(m, Mesh) else None


def get_world_size(axis=None):
    """The group's size (1 without a group); with ``axis``, that mesh
    axis's size (1 for an axis the mesh lacks)."""
    if not is_initialized():
        return 1
    if axis is None:
        return dist.get_world_size()
    mesh = _custom_mesh()
    if mesh is None:
        return dist.get_world_size() if axis == DATA_AXIS else 1
    return int(mesh.shape.get(axis, 1))


def get_rank(axis=None):
    """This process's rank in the group (0 without a group); with
    ``axis``, its index along that mesh axis."""
    if not is_initialized():
        return 0
    if axis is None:
        return dist.get_rank()
    mesh = _custom_mesh()
    if mesh is None:
        return dist.get_rank() if axis == DATA_AXIS else 0
    return int(mesh.coords.get(axis, 0))


# the group of an axis of one rank that is not the whole world (or that the
# mesh lacks): its collectives are the identity, as the reference's on an
# axis of size 1
SINGLE = 'single-rank axis'


def axis_group(axis):
    """``(group, size, index)`` of this rank along mesh ``axis``: the
    process group to issue its collectives on (None: the default group),
    the axis's size and this rank's index on it. An axis of one rank that
    is not the world, or that the mesh lacks, is ``(SINGLE, 1, 0)``."""
    if not is_initialized():
        return SINGLE, 1, 0
    mesh = _custom_mesh()
    if mesh is None:
        if axis == DATA_AXIS:
            return None, dist.get_world_size(), dist.get_rank()
        return SINGLE, 1, 0
    if axis not in mesh.shape:
        return SINGLE, 1, 0
    return mesh.get_group(axis), mesh.shape[axis], mesh.coords[axis]


def rank_at(coords):
    """The global rank at mesh ``coords`` (``{axis: index}``; an axis not
    given is at index 0)."""
    mesh = _custom_mesh()
    if mesh is None:
        return int(coords.get(DATA_AXIS, 0))
    shape = tuple(mesh.shape.values())
    return int(np.ravel_multi_index(
        tuple(int(coords.get(a, 0)) for a in mesh.axis_names), shape))


def axis_ranks(axis):
    """The global ranks of this rank's group along ``axis``, in axis
    order."""
    mesh = _custom_mesh()
    if mesh is None:
        n = get_world_size(axis)
        return list(range(n)) if n > 1 else [get_rank()]
    if axis not in mesh.shape:
        return [get_rank()]
    return mesh.ranks(axis)


def device():
    """The device this rank's collectives stage scalars on: its CUDA device
    when the group serves CUDA tensors, else the CPU."""
    if _global['device'] is None:
        bk = str(dist.get_backend()) if is_initialized() else ''
        if 'nccl' in bk:
            _global['device'] = torch.device('cuda',
                                             torch.cuda.current_device())
        else:
            _global['device'] = torch.device('cpu')
    return _global['device']


def get_mesh():
    """The ``Mesh`` ``init_parallel_env(mesh_shape=)`` installed, else a
    1-D ``DeviceMesh`` over the group's ranks (axis ``'data'``), or None
    without a group."""
    if not is_initialized():
        return None
    if _global['mesh'] is None:
        from torch.distributed.device_mesh import DeviceMesh
        _global['mesh'] = DeviceMesh(
            device().type, list(range(dist.get_world_size())),
            mesh_dim_names=(DATA_AXIS,))
    return _global['mesh']


def set_mesh(mesh):
    """Install ``mesh`` (a ``Mesh``, a 1-D ``DeviceMesh`` over the group,
    or None)."""
    _global['mesh'] = mesh


def current_data_axis():
    return DATA_AXIS


class ParallelEnv:
    """Parity: ``fluid/dygraph/parallel.py:ParallelEnv``."""

    @property
    def rank(self):
        return get_rank()

    @property
    def local_rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def nranks(self):
        return get_world_size()

    @property
    def dev_id(self):
        d = device() if is_initialized() else torch.device('cpu')
        return d.index or 0

    @property
    def device_type(self):
        d = device() if is_initialized() else torch.device('cpu')
        return 'gpu' if d.type == 'cuda' else 'cpu'

    @property
    def current_endpoint(self):
        return os.environ.get('PADDLE_CURRENT_ENDPOINT', '127.0.0.1:6170')

    @property
    def trainer_endpoints(self):
        return os.environ.get('PADDLE_TRAINER_ENDPOINTS',
                              '127.0.0.1:6170').split(',')
