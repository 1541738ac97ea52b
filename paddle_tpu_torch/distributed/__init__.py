"""``paddle_tpu_torch.distributed``: data- and model-parallel training over
a ``torch.distributed`` process group. Counterpart of
``paddle_tpu/distributed`` (parity: ``python/paddle/distributed``).

One process a rank, a process group (NCCL for CUDA tensors, gloo for CPU
ones) and collectives that really run:

- ``env``: ``init_parallel_env`` / ``init_distributed``, ``get_rank``,
  ``get_world_size``, ``ParallelEnv``, ``get_mesh``; a mesh of several
  axes (``'data'`` x ``'model'``, ``'pipe'``, ``'seq'``) with a process
  group an axis;
- ``collective``: ``all_reduce`` (``ReduceOp``), ``all_gather``,
  ``broadcast``, ``reduce``, ``scatter``, ``reduce_scatter``,
  ``alltoall``, ``ppermute``, ``barrier``, ``send`` / ``recv``,
  ``new_group``, each on an axis (``axis=``), counted and under
  ``deadline``'s ``set_timeout``;
- ``launch``: ``spawn`` and ``launch`` under the supervisor (boot
  restarts, elastic downsize and rejoin, ``RankFailedError``);
- ``parallel.DataParallel``, ``strategy.ShardingConfig`` /
  ``resolve_sharding`` (the FSDP step of ``engine.build_train_step``,
  ``engine.fit``, ``hapi.Model``), ``sharding`` (``fsdp_pspecs``,
  ``shard_tensor``; tensor parallelism: ``ColumnParallelLinear``,
  ``RowParallelLinear``, ``VocabParallelEmbedding``,
  ``apply_tensor_parallel``), ``ring_attention``, ``pipeline``
  (``pipeline_apply``), ``ps`` (``SparseShardedTable``), ``fs``
  (``LocalFS``, ``HDFSClient``), ``fleet``, ``metrics``, ``recompute``.

Rules every module keeps: no process group, no collectives (each entry
point then runs as one process, bit for bit as without this package); a
group of any size issues its collectives, world 1 included; a rank feeds
its slice of the global batch, and a step's loss is the global batch's;
anything that reduces over a whole parameter or the whole model (the
global-norm clip, Lamb's trust ratio, ``ok``) reduces across the ranks
once the gradients are sharded; where the gradients are averaged over
the ranks (a ``sharding=`` or ``DataParallel`` step, an eager
``DataParallel``), each rank draws its own dropout masks
(``kernels.philox.DropoutState``: the rank in the offset's high word), and
ranks that synchronise nothing draw rank 0's; the model ranks of one
data replica draw the same.
"""
from . import deadline, env
from .env import (init_parallel_env, init_distributed, get_rank,
                  get_world_size, ParallelEnv, get_mesh, set_mesh)
from .collective import (ReduceOp, all_reduce, all_gather, broadcast, reduce,
                         scatter, reduce_scatter, alltoall, all_to_all,
                         barrier, send, recv, ppermute, new_group,
                         split_group)
from .parallel import DataParallel, ParallelStrategy, prepare_context
from . import fleet, sharding, strategy
from .sharding import (shard_tensor, shard_layer, ColumnParallelLinear,
                       RowParallelLinear, VocabParallelEmbedding)
from .strategy import ShardingConfig, resolve_sharding
from .ring_attention import ring_attention
from . import pipeline
from .pipeline import pipeline_apply
from .recompute import recompute
from . import ps
from .ps import SparseShardedTable
from .launch import spawn, launch, RankFailedError
from .deadline import set_timeout, get_timeout, DistributedTimeoutError
from .fleet import Fleet, DistributedStrategy  # noqa: F401
from .metrics import (acc, auc, mae, mse, rmse,  # noqa: F401
                      sum, max, min)
from .role_maker import (PaddleCloudRoleMaker,  # noqa: F401
                         UserDefinedRoleMaker)
from .fleet import _FleetUtils as UtilBase  # noqa: F401
from . import fs  # noqa: E402
from .fs import (FS, LocalFS, HDFSClient, ExecuteError,  # noqa: F401
                 FSFileExistsError, FSFileNotExistsError, FSTimeOut,
                 FSShellCmdAborted)


class _FleetDataset:
    """The 1.8 fleet dataset: the configuration surface (``set_use_var``,
    ``set_batch_size``, ``set_filelist``, ...) over reading the listed
    files on the host."""

    def __init__(self, dataset_type):
        self.dataset_type = dataset_type
        self.filelist = []
        self.batch_size = 1
        self.thread_num = 1
        self.use_vars = []
        self.pipe_command = None
        self._records = []

    def set_use_var(self, var_list):
        self.use_vars = list(var_list)

    def set_batch_size(self, batch_size):
        self.batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self.thread_num = int(thread_num)

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def set_pipe_command(self, cmd):
        self.pipe_command = cmd

    def set_hdfs_config(self, fs_name, fs_ugi):
        self._hdfs = (fs_name, fs_ugi)

    def load_into_memory(self):
        self._records = []
        for path in self.filelist:
            with open(path) as f:
                self._records.extend(f.readlines())

    def local_shuffle(self):
        import random
        random.shuffle(self._records)

    def release_memory(self):
        self._records = []

    def get_memory_data_size(self):
        return len(self._records)

    def __iter__(self):
        return iter(self._records)


class DatasetFactory:
    """The 1.8 fleet ``DatasetFactory``: one host-side dataset serves every
    flavour."""

    def create_dataset(self, dataset_type="QueueDataset"):
        return _FleetDataset(dataset_type)
