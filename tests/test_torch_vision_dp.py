"""Data-parallel BatchNorm: the port's two-rank gloo steps of a conv +
BatchNorm net against the reference's sharded step on the CPU.

The reference's ``build_train_step(sharding=)`` is one program over the
global batch, so its BatchNorm takes the global batch's statistics. The
port runs one process a rank; its DataParallel and FSDP steps add the
per-channel sums over the ranks (``nn.functional.norm.
batch_stats_over_ranks``), forward and backward, and so compute the same
function. One ``spawn`` of two gloo ranks (``_torch_dist_ranks.
bn_cases``) steps the net three times with SGD on this rank's half of
each global batch of 8; the losses within 1e-6 and the parameters and
running statistics within 1e-5 of the reference's ``sharding=`` step on
a 2-device mesh. A rank's own half alone would give other statistics:
the same net stepped on rank 0's rows is held to differ. And
``SyncBatchNorm`` in training on each rank's rows against the
reference's inside a ``shard_map`` over the 2-device data axis: the
output (each rank's rows) and the running statistics within 1e-5.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu import engine as r_engine
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as r_opt
from paddle_tpu.core import rng as r_rng
from paddle_tpu.core.tensor import Tensor as JT
from paddle_tpu.distributed import env as r_env
from paddle_tpu.distributed import strategy as r_strategy
from paddle_tpu.nn.layer_base import buffer_values, param_values

from paddle_tpu_torch import distributed as t_dist
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.engine import build_train_step
from paddle_tpu_torch.interop import to_paddle_tpu_state

import _torch_dist_ranks as R

JOIN_S = 60
LR = 0.1


def _data(n=3, b=8, seed=0):
    rs = np.random.RandomState(seed)
    return [((rs.randn(b, 3, 5, 5) * 2 + 1).astype(np.float32),
             rs.randint(0, 3, b).astype(np.int64)) for _ in range(n)]


@pytest.fixture(autouse=True)
def _clean():
    yield
    r_strategy.set_current_config(None)
    r_env.set_mesh(None)
    r_env._global['initialized'] = False
    t_dist.env.shutdown()


@pytest.fixture(scope='module')
def setup():
    paddle.seed(31)
    ref = jnn.Sequential(jnn.Conv2D(3, 4, 3, padding=1), jnn.BatchNorm2D(4),
                         jnn.ReLU(), jnn.Flatten(), jnn.Linear(4 * 5 * 5, 3))
    init = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    data = _data()
    ctx = t_dist.spawn(R.bn_cases, args=(init, data, LR), nprocs=2,
                       backend='gloo', join=False)
    ranks = ctx.join(timeout=JOIN_S)
    cfg = r_strategy.ShardingConfig(
        mesh=Mesh(np.asarray(jax.devices()[:2]), ('data',)))
    step = r_engine.build_train_step(
        net=ref, loss=jnn.CrossEntropyLoss(),
        optimizer=r_opt.SGD(learning_rate=LR), sharding=cfg)
    state = step.init_state(param_values(ref), buffer_values(ref))
    losses = []
    for x, y in data:
        state, out = step(state, ((x,), (y,)), r_rng.next_key())
        losses.append(float(out.loss))
    want = {k: np.asarray(v) for k, v in
            {**state['params'], **state['buffers']}.items()}
    return init, data, ranks, losses, want


@pytest.mark.parametrize('kind', ['dp', 'fsdp'])
def test_two_rank_batchnorm_step_matches_reference_sharded_step(setup,
                                                               kind):
    init, _, ranks, ref_losses, want = setup
    for rank in (0, 1):
        losses, state = ranks[rank][kind]
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-6)
        assert set(state) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(state[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=f'rank {rank} {k}')
    assert not np.array_equal(ranks[0][kind][1]['1._mean'], init['1._mean'])


def test_one_rank_rows_alone_give_other_statistics(setup):
    init, data, _, _, want = setup
    net = R.bn_net(init)
    step = build_train_step(net=net, loss=tnn.CrossEntropyLoss(),
                            optimizer=topt.SGD(learning_rate=LR),
                            device='cpu')
    state = step.init_state()
    for x, y in data:
        state, _ = step(state, ((torch.from_numpy(x[:4]),),
                                (torch.from_numpy(y[:4]),)))
    got = to_paddle_tpu_state(net)
    assert np.abs(got['1._mean'] - want['1._mean']).max() > 1e-4


def test_sync_batch_norm_matches_reference_over_two_ranks(setup):
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    _, data, ranks, _, _ = setup
    x = data[0][0]
    ref = jnn.SyncBatchNorm(3)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ('data',))

    def body(v):
        r_env.set_current_data_axis('data')
        try:
            out = ref(JT(v))
        finally:
            r_env.set_current_data_axis(None)
        return out._value, ref._mean._value, ref._variance._value
    out, rm, rv = shard_map(body, mesh=mesh, in_specs=P('data'),
                            out_specs=(P('data'), P(), P()))(x)
    out = np.asarray(out)
    for rank in (0, 1):
        y, mean, var = ranks[rank]['sync_bn']
        np.testing.assert_allclose(y, out[rank * 4:(rank + 1) * 4],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(mean, np.asarray(rm), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(var, np.asarray(rv), rtol=1e-5,
                                   atol=1e-6)
