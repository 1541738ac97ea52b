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
  axis ``'data'``. A mesh of more than one axis (tensor parallelism) waits
  for ROADMAP.md Queue 1 item 5b.

Under a supervised launch each rank also heartbeats into the run dir and
writes its started marker (``_announce_to_supervisor``).
"""
import datetime
import math
import os
import tempfile

import torch
import torch.distributed as dist

__all__ = ['init_parallel_env', 'init_distributed', 'get_rank',
           'get_world_size', 'ParallelEnv', 'get_mesh', 'set_mesh',
           'is_initialized', 'device', 'shutdown', 'DATA_AXIS',
           'MODEL_AXIS', 'PIPE_AXIS', 'SEQ_AXIS']

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


def init_parallel_env(mesh_shape=None, axis_names=None, backend=None):
    """Join (once) the process group of this rank -> ``ParallelEnv()``.

    ``mesh_shape``: None, or the 1-D ``(world,)`` (a second axis of more
    than one rank, tensor parallelism, waits for ROADMAP.md Queue 1 item
    5b). ``backend``: None (NCCL for CUDA tensors, gloo for CPU ones),
    ``'nccl'``, ``'gloo'`` or ``'cpu'``."""
    _announce_to_supervisor()
    shape = None if mesh_shape is None else \
        tuple(int(s) for s in mesh_shape)
    if shape is not None and any(s > 1 for s in shape[1:]):
        raise NotImplementedError(
            f"init_parallel_env: a mesh of shape {shape} has a model axis; "
            f"tensor parallelism waits for ROADMAP.md, Queue 1 item 5b")
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


def get_world_size(axis=None):
    """The group's size (1 without a group). ``axis``: ``'data'`` or None
    is the group; any other axis has one rank (no model axis yet)."""
    if not is_initialized():
        return 1
    if axis not in (None, DATA_AXIS):
        return 1
    return dist.get_world_size()


def get_rank(axis=None):
    """This process's rank in the group (0 without a group)."""
    if not is_initialized() or axis not in (None, DATA_AXIS):
        return 0
    return dist.get_rank()


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
    """A 1-D ``DeviceMesh`` over the group's ranks (axis ``'data'``), or
    None without a group."""
    if not is_initialized():
        return None
    if _global['mesh'] is None:
        from torch.distributed.device_mesh import DeviceMesh
        _global['mesh'] = DeviceMesh(
            device().type, list(range(dist.get_world_size())),
            mesh_dim_names=(DATA_AXIS,))
    return _global['mesh']


def set_mesh(mesh):
    """Install ``mesh`` (a 1-D ``DeviceMesh`` over the group, or None)."""
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
