"""The port's collectives (``distributed.collective``), ``DataParallel``, the
fleet metrics, the collective counters and the deadline, on real ranks,
against the reference's mesh results.

One module-scoped ``spawn`` of four gloo ranks (``_torch_dist_ranks.
collective_cases``, joined with a 60 s timeout) runs every case at
k = 4 and, in a ``new_group([0, 1])``, at k = 2, in fp32 and bf16. The
reference side runs the same values through ``shard_map`` collectives on
a k-device CPU mesh (``tests/test_distributed.py``'s cases: each rank's
value is the shard a device holds), and its eager API on a replicated
value (each rank holding the same tensor is the reference's replicated
eager value). Values: small integers and halves, exact in bf16, so every
comparison is exact except the DataParallel gradients (the reference's
rtol 1e-4 / atol 1e-5) and the metrics (1e-12; the AUC 1e-6 relative:
the reference all-reduces its histograms in fp32, the port in fp64).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu.distributed import collective as r_collective
from paddle_tpu.distributed import env as r_env
from paddle_tpu.distributed._compat import shard_map

from paddle_tpu_torch import distributed as t_dist

import _torch_dist_ranks as R

JOIN_S = 60
WORLD = 4


@pytest.fixture(scope='module')
def dp_data():
    rs = np.random.RandomState(0)
    w = rs.randn(5, 3).astype(np.float32)        # the reference's layout
    b = rs.randn(3).astype(np.float32)
    x = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    y = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    return w, b, x, y


@pytest.fixture(scope='module')
def ranks(dp_data):
    w, b, x, y = dp_data
    ctx = t_dist.spawn(R.collective_cases,
                       args=((np.ascontiguousarray(w.T), b), x, y),
                       nprocs=WORLD, backend='gloo', join=False)
    return ctx.join(timeout=JOIN_S)


@pytest.fixture
def mesh_of():
    made = []

    def make(n):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ('data',))
        r_env.set_mesh(mesh)
        made.append(mesh)
        return mesh
    yield make
    r_env.set_mesh(None)
    r_env._global['initialized'] = False


def _per_shard(fn, x, mesh, out_spec=P('data')):
    return np.asarray(shard_map(fn, mesh=mesh, in_specs=(P('data'),),
                                out_specs=out_spec, check=False)(x))


def _reference(n, mesh):
    """The reference's answer to each case of ``_collectives`` at ``n``
    ranks -> {case: the array every rank (or the named rank) holds}."""
    prod = r_collective._LAX_REDUCE[r_collective.ReduceOp.PROD]
    ones = jnp.arange(1.0, n + 1.0)
    out = {
        'all_reduce_sum': _per_shard(lambda s: lax.psum(s, 'data'), ones,
                                     mesh)[:1],
        'all_reduce_max': _per_shard(lambda s: lax.pmax(s, 'data'), ones,
                                     mesh)[:1],
        'all_reduce_min': _per_shard(lambda s: lax.pmin(s, 'data'), ones,
                                     mesh)[:1],
        'all_reduce_prod': _per_shard(lambda s: prod(s, 'data'), ones,
                                      mesh)[:1],
        'prod_signs': _per_shard(lambda s: prod(s, 'data'),
                                 jnp.asarray(R.PROD_SIGNS[:n]), mesh)[:1],
        'prod_zero': _per_shard(lambda s: prod(s, 'data'),
                                jnp.asarray(R.PROD_ZERO[:n]), mesh)[:1],
        'prod_int': _per_shard(lambda s: prod(s, 'data'),
                               jnp.asarray(R.PROD_INT[:n], jnp.int32),
                               mesh)[:1]}
    # the eager API on a replicated value: the closed forms
    t = paddle.to_tensor
    out['replicated_sum'] = r_collective.all_reduce(
        t(np.array([1.5, -2.0], np.float32))).numpy()
    out['replicated_max'] = r_collective.all_reduce(
        t(np.array([3.0], np.float32)), op='max').numpy()
    out['replicated_prod'] = r_collective.all_reduce(
        t(np.array([-2.0], np.float32)), op=r_collective.ReduceOp.PROD
    ).numpy()
    # all_gather: shard i holds [2i, 2i + 1]
    rows = jnp.arange(float(2 * n)).reshape(n, 2)
    got = shard_map(lambda s: lax.all_gather(s, 'data'), mesh=mesh,
                    in_specs=(P('data'),), out_specs=P(None, 'data'),
                    check=False)(rows)
    out['all_gather'] = np.asarray(got).reshape(n, n, 2)[:, 0]
    out['all_gather_list'] = len(r_collective.all_gather(
        [], t(np.ones(2, np.float32))))
    # reduce-scatter: shard i holds (i + 1) x ones(n)
    x = jnp.repeat(jnp.arange(1.0, n + 1.0)[:, None], n, axis=1).reshape(-1)
    out['reduce_scatter'] = _per_shard(
        lambda s: lax.psum_scatter(s.reshape(n), 'data', tiled=True), x,
        mesh)[:1]
    out['reduce_scatter_list'] = out['reduce_scatter']
    # all-to-all: shard i holds [i n .. i n + n - 1] and gets column i
    a2a = _per_shard(
        lambda s: lax.all_to_all(s.reshape(n, 1), 'data', split_axis=0,
                                 concat_axis=0).reshape(n),
        jnp.arange(float(n * n)), mesh)
    out['alltoall'] = a2a.reshape(n, n)
    return out


def _check(got, want, n, rank):
    for k in ('all_reduce_sum', 'all_reduce_max', 'all_reduce_min',
              'all_reduce_prod', 'prod_signs', 'prod_zero',
              'replicated_sum', 'replicated_max', 'replicated_prod',
              'reduce_scatter', 'reduce_scatter_list'):
        np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32),
                                      err_msg=k)
    assert got['prod_int'].dtype == np.int32
    np.testing.assert_array_equal(got['prod_int'], want['prod_int'])
    np.testing.assert_array_equal(got['all_gather'], want['all_gather'])
    assert got['all_gather_list'] == want['all_gather_list'] == n
    np.testing.assert_array_equal(got['alltoall'], want['alltoall'][rank])
    # the reference's broadcast / reduce / scatter are identities on its
    # replicated value; with distinct values a rank, paddle's semantics
    np.testing.assert_array_equal(got['broadcast'], [11.0 if n > 1 else 10.0])
    if rank == 0:
        np.testing.assert_array_equal(got['reduce_dst'],
                                      [n * (n + 1) / 2.0])
    np.testing.assert_array_equal(got['scatter'], [rank, -rank])


@pytest.mark.parametrize('n', [2, 4])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_collectives_match_the_reference_mesh(ranks, mesh_of, n, dtype):
    want = _reference(n, mesh_of(n))
    for rank, out in enumerate(ranks[:n]):
        _check(out[f'{n}_{dtype}'], want, n, rank)


def test_bad_op_and_point_to_point(ranks):
    with pytest.raises(ValueError, match='unknown reduce op') as e:
        r_collective._normalize_op('bogus')
    for rank, out in enumerate(ranks):
        assert out['bogus'] == str(e.value)
        want = float(rank - 1) if rank % 2 else 0.0
        np.testing.assert_array_equal(out['recv'], [want] * 3)


def test_collective_counters(ranks):
    for out in ranks:
        assert out['counts'] == {'all_reduce': {'calls': 1, 'bytes': 64},
                                 'all_gather': {'calls': 1, 'bytes': 8}}
        assert out['telemetry'] == {
            'collective.all_reduce.calls': 1,
            'collective.all_reduce.bytes': 64,
            'collective.all_gather.calls': 1,
            'collective.all_gather.bytes': 8}


def test_dataparallel_matches_reference_grad_parity(ranks, dp_data,
                                                    mesh_of):
    """``tests/test_distributed.py::test_dataparallel_wrapper_grad_parity``:
    the full batch's gradient, here from four ranks of one row each."""
    w, b, x, y = dp_data
    mesh_of(WORLD)
    ref = jax.grad(lambda w_: jnp.mean((x @ w_ + b - y) ** 2))(w)
    for out in ranks:
        np.testing.assert_allclose(out['dp_grad'], np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)
        assert out['dp_names'] == ['weight', 'bias']


def test_fleet_metrics_over_ranks(ranks, mesh_of, monkeypatch):
    from paddle_tpu.distributed import metrics as r_metrics
    vals = [np.array([r + 1.0, 2.0 * r]) for r in range(WORLD)]
    allv = np.concatenate(vals)
    pos = sum(np.array([1.0, 2.0, r + 3.0]) for r in range(WORLD))
    neg = WORLD * np.array([3.0, 2.0, 1.0])
    mesh_of(WORLD)
    monkeypatch.setenv('PADDLE_TRAINERS_NUM', str(WORLD))
    r_env._global['initialized'] = True
    want_auc = r_metrics.auc(pos / WORLD, neg / WORLD)
    for out in ranks:
        m = out['metrics']
        assert m['sum'] == allv.sum() and m['max'] == allv.max()
        assert m['min'] == allv.min()
        assert m['acc'] == pytest.approx(sum(r + 1.0 for r in range(WORLD))
                                         / (4.0 * WORLD), abs=1e-12)
        assert m['mae'] == pytest.approx(6.0 / 8.0, abs=1e-12)
        assert m['mse'] == pytest.approx(12.0 / 8.0, abs=1e-12)
        assert m['rmse'] == pytest.approx(np.sqrt(12.0 / 8.0), abs=1e-12)
        # every rank's histograms summed: the reference's integration (it
        # all-reduces in fp32, the port in fp64)
        assert m['auc'] == pytest.approx(want_auc, rel=1e-6)
        # a value every rank holds: the reference's closed form
        assert m['replicated_sum'] == pytest.approx(
            r_metrics.sum(np.array([1.0, 2.0])), abs=1e-12)
        assert m['replicated_max'] == r_metrics.max(np.array([3.0]))


def test_deadline_with_slow_collective(ranks):
    for out in ranks:
        op, timeout, missing, msg = out['deadline']
        assert op == 'all_reduce' and timeout == 0.2
        # the supervisor's heartbeats are fresh: nobody is missing
        assert missing == [] and "'all_reduce'" in msg
