"""``engine.fit(sharding=, world=, rank=)``, ``hapi.Model.fit(strategy=)``
and the resharding restore of the port at k = 2 gloo ranks against the
reference's ``fit(sharding=)`` on a 2-device mesh, and checkpoints across
the packages and world sizes.

One module-scoped ``spawn`` of two ranks (``_torch_dist_ranks.
fit_cases``, joined with a 60 s timeout). The model is the 2-layer BERT of
``test_torch_sharding.py`` on the reference's weights; 8 samples, global
batches of 4 (each rank's 2 from ``io.DistributedBatchSampler``), 2
epochs of SGD. Tolerances: losses rtol 1e-5, parameters rtol 1e-5 / atol
1e-6 (the reference's data-parallel tolerance; SGD for the reason
``test_torch_sharding.py`` gives). The resharding matrix is byte for
byte (``tests/test_elastic_checkpoint.py:278-370`` are its cases): a
checkpoint the reference wrote on a 4-device FSDP mesh restored by each
port rank into its pieces, and the one the port's two ranks wrote (each
its own pieces, rank 0 committing) restored by the reference on one
device, against the state each side saved.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu import engine as r_engine
from paddle_tpu import optimizer as r_opt
from paddle_tpu.distributed import env as r_env
from paddle_tpu.distributed import strategy as r_strategy
from paddle_tpu.nn.layer_base import param_values
from paddle_tpu.resilience import CheckpointManager as RCheckpointManager
from paddle_tpu.text.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.bert import BertForPretraining as JaxBertForPretraining

from paddle_tpu_torch import distributed as t_dist
from paddle_tpu_torch.interop import load_paddle_tpu_state, \
    to_paddle_tpu_state

import _torch_dist_ranks as R

JOIN_S = 60
N_SAMPLES, LR = 8, 0.05


def _ref_model(seed=5):
    paddle.seed(seed)
    return JaxBertForPretraining(JaxBertConfig(**R.SMALL))


def _global_batches():
    """The reference's feed: consecutive runs of 4 samples, stacked."""
    items = R.samples(N_SAMPLES)
    out = []
    for i in range(0, N_SAMPLES, 4):
        run = items[i:i + 4]
        x = tuple(np.stack([s[0][j] for s in run]) for j in range(4))
        y = tuple(np.stack([s[1][j] for s in run]) for j in range(2))
        out.append((x, y))
    return out


def _mesh_cfg(n):
    return r_strategy.ShardingConfig(
        mesh=Mesh(np.asarray(jax.devices()[:n]), ('data',)))


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp('dfit')
    ref = _ref_model()
    params = {k: np.asarray(v)
              for k, v in param_values(ref, trainable_only=False).items()}
    port = R.model()
    load_paddle_tpu_state(port, params)
    init = R.weights(port)
    # the reference's fit(sharding=) on 2 devices: the comparison run
    rep2 = r_engine.fit(ref, ref.pretraining_loss,
                        r_opt.SGD(learning_rate=LR), _global_batches(),
                        epochs=2, sharding=_mesh_cfg(2), log_every=1,
                        prefetch=0)
    want = {k: np.asarray(v) for k, v in rep2['state']['params'].items()}
    # the reference's checkpoint on a 4-device FSDP mesh, 1 epoch of Adam
    # (moments in the state), for the port to restore
    ref4 = _ref_model()
    ref_ckpt = str(root / 'ref4')
    r_engine.fit(ref4, ref4.pretraining_loss,
                 r_opt.Adam(learning_rate=1e-3), _global_batches(),
                 epochs=1, sharding=_mesh_cfg(4), checkpoint=ref_ckpt,
                 async_save=False, prefetch=0, preempt_save=False)
    r_env.set_mesh(None)
    r_env._global['initialized'] = False
    r_strategy.set_current_config(None)
    port_ckpt = str(root / 'port2')
    ctx = t_dist.spawn(R.fit_cases,
                       args=(init, ref_ckpt, port_ckpt, N_SAMPLES, LR),
                       nprocs=2, backend='gloo', join=False)
    ranks = ctx.join(timeout=JOIN_S)
    return {'ranks': ranks, 'init': init, 'ref_loss': rep2['loss'],
            'ref_params': want,
            'ref_ckpt': ref_ckpt, 'port_ckpt': port_ckpt}


def _by_ref_names(port_params):
    return to_paddle_tpu_state(R.model(port_params))


def test_engine_fit_sharded_matches_reference(run):
    for out in run['ranks']:
        e = out['engine']
        assert e['dispatches'] == 4
        np.testing.assert_allclose(e['loss'], run['ref_loss'], rtol=1e-5)
        got = _by_ref_names(e['params'])
        for k, v in run['ref_params'].items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    a, b = (o['engine']['params'] for o in run['ranks'])
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_hapi_fit_strategy_matches_reference(run):
    for out in run['ranks']:
        h = out['hapi']
        assert h['jit'] and h['sharded']
        got = _by_ref_names(h['params'])
        for k, v in run['ref_params'].items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_reference_4_device_checkpoint_restores_into_port_pieces(run):
    mgr = RCheckpointManager(run['ref_ckpt'])
    want, _ = mgr.restore()
    for rank, out in enumerate(run['ranks']):
        got = out['restored']
        assert sorted(got['params']) == sorted(want['params'])
        for k, v in want['params'].items():
            full = np.asarray(v)
            piece = got['params'][k]
            if piece.shape == full.shape:
                assert np.array_equal(piece, full), k
                continue
            dim = next(d for d, (a, b) in enumerate(zip(piece.shape,
                                                        full.shape)) if a != b)
            n = piece.shape[dim]
            sl = [slice(None)] * full.ndim
            sl[dim] = slice(rank * n, (rank + 1) * n)
            assert np.array_equal(piece, full[tuple(sl)]), k
            m1 = np.asarray(want['opt'][k]['moment1'])
            assert np.array_equal(got['opt'][k]['moment1'],
                                  m1[tuple(sl)]), k


def test_unsynced_fit_with_dropout_keeps_the_ranks_equal(run, tmp_path):
    """``engine.fit(world=, rank=)`` without ``sharding=`` synchronises
    nothing: at p = 0.1 on the same batches both ranks draw rank 0's
    masks, and their models equal each other and one process's bit for
    bit (one CPU thread, as the ranks), and the checkpoint the two wrote
    (each its piece, rank 0 committing) holds that model."""
    init = run['init']
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        alone, losses = R.unsynced_fit(init, str(tmp_path / 'alone'))
    finally:
        torch.set_num_threads(prev)
    for out in run['ranks']:
        got, got_losses = out['unsynced']
        assert got_losses == losses
        for k, v in alone.items():
            assert np.array_equal(got[k], v), k
    state, meta = RCheckpointManager(run['port_ckpt'] + '-unsynced')\
        .restore()
    assert meta['world'] == 2
    for k, v in alone.items():
        assert np.array_equal(np.asarray(state['params'][k]), v), k


def test_port_2_rank_checkpoint_restores_on_the_reference(run):
    state, meta = RCheckpointManager(run['port_ckpt']).restore()
    man = RCheckpointManager(run['port_ckpt']).load_manifest(4)
    assert man['world'] == 2 and meta['world'] == 2
    final = run['ranks'][0]['engine']['params']
    for k, v in final.items():
        assert np.array_equal(np.asarray(state['params'][k]), v), k
    # and every step's checkpoint holds both ranks' pieces
    assert sorted(man['shards']) == ['0', '1']
