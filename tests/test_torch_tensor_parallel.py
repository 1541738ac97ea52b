"""Tensor parallelism in the port (``distributed.sharding``'s Megatron
layers, ``build_train_step(sharding=ShardingConfig(tensor_parallel_degree=
2, param_rules=...))``, the TP checkpoint) against the reference's.

Two spawns of gloo ranks on the CPU (``_torch_dist_ranks``), side by side,
joined within 180 s: four ranks on a (data 2, model 2) mesh, and two on
(1, 2), which restore the four's checkpoint once it is committed. The
reference runs on the 8 host devices of ``tests/conftest.py`` with
``shard_map`` meshes, as ``tests/test_distributed.py`` and
``tests/test_sharding_train.py`` run it. Tolerances:

- the layers (``tests/test_distributed.py:341-430``): the outputs within
  1e-5, the gradients within 1e-4 (the reference's own);
- TP with FSDP (``test_sharding_train.py:251``): losses rtol 1e-5,
  parameters rtol 1e-4 / atol 1e-5 (the reference's own);
- BERT (2 layers, hidden 64, 4 heads) at degree 2 against the JAX BERT's
  dense step, 3 AdamW steps on one batch: the losses within 1e-5
  relative, the parameters as ``tests/test_torch_engine.py`` holds the
  one-process step (1e-5 where the gradient is above its noise floor,
  Adam's bound of 3 lr elsewhere);
- the TP model's forward at p = 0.1 equals the dense model's within 1e-5
  (the same masks: a different mask moves outputs by O(1)), and so do an
  encoder layer's output and input gradient with every dropout at 0.1;
- the checkpoint restores bit for bit.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu import engine as r_engine
from paddle_tpu import nn as r_nn
from paddle_tpu import optimizer as r_opt
from paddle_tpu.core import rng as r_rng
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.distributed import env as r_env
from paddle_tpu.distributed._compat import shard_map
from paddle_tpu.distributed.sharding import (
    ColumnParallelLinear as RCol, RowParallelLinear as RRow,
    VocabParallelEmbedding as RVocab)
from paddle_tpu.distributed.strategy import ShardingConfig as RConfig
from paddle_tpu.nn.layer_base import (buffer_values, functional_call,
                                      param_values)
from paddle_tpu.text.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.bert import BertForPretraining as JaxBertForPretraining

from paddle_tpu_torch import distributed as t_dist
from paddle_tpu_torch.interop import load_paddle_tpu_state
from paddle_tpu_torch.nn import Linear, MultiHeadAttention
from paddle_tpu_torch.resilience import CheckpointManager

import _torch_dist_ranks as R

JOIN_S = 180
LR, TOL = 1e-3, 1e-5


@pytest.fixture(autouse=True)
def _clean():
    yield
    r_env.set_mesh(None)
    r_env._global['initialized'] = False


def _model_mesh():
    return Mesh(np.asarray(jax.devices()[:2]), ('model',))


def _reference_layers():
    """The reference's layer cases on a 2-device 'model' mesh -> inputs
    and ``{case: (output, weight grad, bias grad, x grad)}`` (reference
    layout)."""
    rs = np.random.RandomState(0)
    mesh = _model_mesh()
    r_env.set_mesh(mesh)
    paddle.seed(3)
    col = RCol(12, 16)
    row = RRow(16, 12)
    emb = RVocab(64, 8)
    cw, cb = np.asarray(col.weight.numpy()), np.asarray(col.bias.numpy())
    rw, rb = np.asarray(row.weight.numpy()), np.asarray(row.bias.numpy())
    ew = np.asarray(emb.weight.numpy())
    cx = rs.randn(4, 12).astype(np.float32)
    rx = rs.randn(4, 16).astype(np.float32)
    ids = rs.randint(0, 64, (4, 6))
    out = {}

    def run(net, params, x, in_specs, out_spec, has_bias=True):
        names = ['weight', 'bias'] if has_bias else ['weight']

        def f(x_l, *ps):
            o, _ = functional_call(net, dict(zip(names, ps)), JaxTensor(x_l))
            return o._value
        sm = shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_spec,
                       check=False)

        def loss(x, *ps):
            return jnp.sum(sm(x, *ps) ** 2)
        args = [jnp.asarray(x)] + [jnp.asarray(p) for p in params]
        argnums = tuple(range(1, len(args))) + \
            ((0,) if x.dtype != np.int64 else ())
        grads = jax.jit(jax.grad(loss, argnums=argnums))(*args)
        return (np.asarray(jax.jit(sm)(*args)),) + \
            tuple(np.asarray(g) for g in grads)
    for gather in (True, False):
        col.gather_output = gather
        out[f'column_gather_{gather}'] = run(
            col, (cw, cb), cx, (P(), P(None, 'model'), P('model')),
            P() if gather else P(None, 'model'))
    for parallel in (False, True):
        row.input_is_parallel = parallel
        out[f'row_parallel_{parallel}'] = run(
            row, (rw, rb), rx, (P(None, 'model'), P('model', None), P()),
            P())
    out['vocab'] = run(emb, (ew,), ids, (P(), P('model', None)), P(),
                       has_bias=False)
    r_env.set_mesh(None)
    return (cw, cb, cx), (rw, rb, rx), (ew, ids), out


def _ref_tp_block(data):
    """The reference's ``test_tensor_parallel_composes_with_fsdp_config``
    on a (2, 2) mesh -> (dense weights before, losses, parameters)."""
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ('data', 'model'))
    r_env.set_mesh(mesh)

    class Block(r_nn.Layer):
        def __init__(self):
            super().__init__()
            self.col = RCol(64, 128, gather_output=False)
            self.row = RRow(128, 8, input_is_parallel=True)

        def forward(self, x):
            return self.row(self.col(x))
    paddle.seed(11)
    net = Block()
    w0 = {k: np.asarray(v) for k, v in param_values(net).items()}
    cfg = RConfig(mesh=mesh, fsdp=True, min_size=64, tensor_parallel_degree=2)
    opt = paddle.optimizer.Adam(learning_rate=1e-2,
                                parameters=net.parameters())
    step = r_engine.build_train_step(net=net, loss=r_nn.MSELoss(),
                                     optimizer=opt, sharding=cfg)
    state = step.init_state(param_values(net), buffer_values(net))
    losses = []
    for x, y in data:
        paddle.seed(99)
        state, out = step(state, ((x,), (y,)), r_rng.next_key())
        losses.append(float(out.loss))
    r_env.set_mesh(None)
    return w0, losses, {k: np.asarray(v) for k, v in state['params'].items()}


def _block_data():
    rs = np.random.RandomState(0)
    return [(rs.rand(16, 64).astype('float32'),
             rs.rand(16, 8).astype('float32')) for _ in range(3)]


def _ref_bert_steps(ref, x, y, steps=3):
    """The reference's dense AdamW step (``test_torch_engine.py``'s) ->
    losses, parameters, the gradients' magnitudes of each step."""
    opt = r_opt.AdamW(learning_rate=LR, weight_decay=0.01)
    params = param_values(ref, trainable_only=False)
    st = opt.init_state_values(params)

    def loss_of(p):
        (logits, nsp), _ = functional_call(
            ref, p, JaxTensor(x[0]), JaxTensor(x[1]),
            attention_mask=JaxTensor(x[2]),
            masked_positions=JaxTensor(x[3]))
        return ref.pretraining_loss(logits, nsp, JaxTensor(y[0]),
                                    JaxTensor(y[1]))._value

    @jax.jit
    def one(p, st):
        loss, grads = jax.value_and_grad(loss_of)(p)
        p, st = opt.functional_update(p, grads, st)
        return p, st, loss, grads
    losses, grads = [], []
    for _ in range(steps):
        params, st, loss, g = one(params, st)
        losses.append(float(loss))
        grads.append({k: np.abs(np.asarray(v)) for k, v in g.items()})
    return losses, {k: np.asarray(v) for k, v in params.items()}, grads


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp('tp_ckpt'))
    data = _block_data()
    w0, ref_losses, ref_params = _ref_tp_block(data)
    four = t_dist.spawn(R.tp_fsdp_cases, args=(w0, data, ckpt), nprocs=4,
                        backend='gloo', join=False)
    col, row, emb, layers = _reference_layers()
    paddle.seed(5)
    ref = JaxBertForPretraining(JaxBertConfig(**R.SMALL))
    ref.eval()
    port = R.model()
    load_paddle_tpu_state(port, {k: np.asarray(v) for k, v in
                                 param_values(ref, trainable_only=False)
                                 .items()})
    init = R.weights(port)
    x, y = R.batches(1, 4)[0]
    # the two ranks restore the four's checkpoint once it is committed
    two = t_dist.spawn(R.tp_rank_cases,
                       args=(col, row, emb, init, x, y, w0, ckpt),
                       nprocs=2, backend='gloo', join=False)
    bert_ref = _ref_bert_steps(ref, x, y)
    return {'four': four.join(timeout=JOIN_S), 'two': two.join(timeout=JOIN_S),
            'layers': layers, 'block': (w0, ref_losses, ref_params),
            'bert_ref': bert_ref, 'init': init, 'ckpt': ckpt}


def _join_pieces(ranks, case, i, dim):
    return np.concatenate([r['layers'][1][case][i] for r in ranks], axis=dim)


@pytest.mark.parametrize('case', ['column_gather_True', 'column_gather_False',
                                  'row_parallel_False', 'row_parallel_True',
                                  'vocab'])
def test_tp_layers_match_reference_shard_map(runs, case):
    ranks, ref = runs['two'], runs['layers'][case]
    column = case.startswith('column')
    # the outputs: a gathered output is the dense one on each rank,
    # an ungathered column output is each rank's block
    if case == 'column_gather_False':
        got = _join_pieces(ranks, case, 0, -1)
    else:
        got = ranks[0]['layers'][1][case][0]
        np.testing.assert_array_equal(got, ranks[1]['layers'][1][case][0])
    np.testing.assert_allclose(got, ref[0], rtol=1e-5, atol=1e-5)
    # the weight's gradient: the pieces joined along their torch dim, then
    # in the reference's (in, out) layout
    wdim = 0 if column or case == 'vocab' else 1
    gw = _join_pieces(ranks, case, 1, wdim)
    np.testing.assert_allclose(gw if case == 'vocab' else gw.T, ref[1],
                               rtol=1e-4, atol=1e-4)
    if case == 'vocab':
        return
    gb = _join_pieces(ranks, case, 2, 0) if column else \
        ranks[0]['layers'][1][case][2]
    np.testing.assert_allclose(gb, ref[2], rtol=1e-4, atol=1e-4)
    gx = _join_pieces(ranks, case, 3, -1) if case == 'row_parallel_True' \
        else ranks[0]['layers'][1][case][3]
    np.testing.assert_allclose(gx, ref[3], rtol=1e-4, atol=1e-4)


def test_tp_composes_with_fsdp_on_a_2x2_mesh(runs):
    w0, ref_losses, ref_params = runs['block']
    for r in runs['four']:
        np.testing.assert_allclose(r['losses'], ref_losses, rtol=1e-5)
        for k, v in ref_params.items():
            got = r['params'][k]
            np.testing.assert_allclose(got.T if got.ndim == 2 else got, v,
                                       rtol=1e-4, atol=1e-5)
        # the TP pieces kept their Megatron layout; FSDP sharded the rest
        assert r['tp'] == {'col.weight': (0, (64, 64)),
                           'col.bias': (0, (64,)),
                           'row.weight': (1, (8, 64))}
        assert r['fsdp'] == []     # row.bias (8,) is under min_size


def _held_like_engine_test(got, want, grads, key):
    diff = np.abs(got - want)
    assert diff.max() <= 3 * LR * 1.01, key
    least = np.minimum.reduce([g[key] for g in grads])
    top = max(float(g[k].max()) for g in grads for k in g)
    floor = max(1e-3 * max(float(g[key].max()) for g in grads), 1e-6 * top)
    sound = least >= floor
    if sound.any():
        assert diff[sound].max() <= TOL, key
        assert int((diff[~sound] > TOL).sum()) <= max(1, diff.size // 1000)


def test_bert_tensor_parallel_steps_match_dense_reference(runs):
    from paddle_tpu_torch.interop import to_paddle_tpu_state
    ref_losses, ref_params, ref_grads = runs['bert_ref']
    ranks = [r['bert'] for r in runs['two']]
    assert [r['model_rank'] for r in ranks] == [0, 1]
    assert [r['data_rank'] for r in ranks] == [0, 0]
    for r in ranks:
        assert r['heads'] == 2            # 4 heads, 2 a rank
        assert r['pieces']['bert.encoder.layers.0.self_attn.q_proj.weight'] \
            == (32, 64)
        assert r['pieces']['bert.encoder.layers.0.linear2.weight'] == \
            (64, 64)
        for a, b in zip(r['losses'], ref_losses):
            assert abs(a - b) <= TOL * abs(b)
        # two all-reduces a layer forward and two backward, nothing else
        c = r['counts_one_step']
        assert set(c) == {'model.all_reduce'}
        assert c['model.all_reduce']['calls'] == 4 * 2
        got = to_paddle_tpu_state(R.model(r['params']))
        for key, want in ref_params.items():
            _held_like_engine_test(got[key], want, ref_grads, key)
    np.testing.assert_array_equal(ranks[0]['params']['cls.decoder_bias'],
                                  ranks[1]['params']['cls.decoder_bias'])


def test_tensor_parallel_dropout_masks_are_the_dense_models(runs):
    for r in runs['two']:
        got, want, mask_rank = r['bert']['masked_forward']
        assert mask_rank == 0      # the data rank: both model ranks alike
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        (o_dense, g_dense), (o_tp, g_tp) = r['bert']['layer_p01']
        np.testing.assert_allclose(o_tp, o_dense, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g_tp, g_dense, rtol=1e-4, atol=1e-4)


def test_column_parallel_attention_cannot_fold_width_into_length():
    """A column-parallel rank's q/k/v yield E / 2 columns. The old reshape
    ``(B, -1, num_heads, head_dim)`` took them as half the length, silently;
    the attention now names every dim and refuses, and runs on its local
    heads once ``local_heads`` says so (the two-rank cases above)."""
    mha = MultiHeadAttention(64, 4, device='cpu')
    for k in ('q_proj', 'k_proj', 'v_proj'):
        setattr(mha, k, Linear(64, 32, device='cpu'))
    x = torch.randn(2, 16, 64)
    half = mha.q_proj(x)
    assert tuple(half.reshape(2, -1, 4, 16).shape) == (2, 8, 4, 16)
    with pytest.raises(RuntimeError, match='invalid for input of size'):
        mha(x)


def test_tp_checkpoint_restores_at_1x2_and_unsharded(runs):
    saved = runs['four'][0]
    for r in runs['four'][1:]:
        for k in saved['params']:
            np.testing.assert_array_equal(r['params'][k], saved['params'][k])
    with open(os.path.join(runs['ckpt'], 'ckpt_00000003',
                           'manifest.json')) as f:
        manifest = json.load(f)
    assert manifest['mesh']['tensor_parallel_degree'] == 2
    assert manifest['mesh']['axes'] == {'data': 2, 'model': 2}
    assert manifest['world'] == 4
    # at (1, 2): each rank adopts its pieces, the dense state bit for bit
    for r in runs['two']:
        back = r['restore']
        assert back['pieces']['col.weight'] == (64, 64)
        for k, v in saved['params'].items():
            np.testing.assert_array_equal(back['params'][k], v)
        for k, slots in saved['opt'].items():
            for s, v in slots.items():
                np.testing.assert_array_equal(back['opt'][k][s], v)
    # unsharded: the reassembled dense state
    state, _ = CheckpointManager(runs['ckpt']).restore()
    for k, v in saved['params'].items():
        np.testing.assert_array_equal(np.asarray(state['params'][k]), v)


def test_fleet_tensor_parallel_installs_the_mesh_and_carries_into_hapi(runs):
    """``fleet.init`` with ``tensor_parallel``: the reference's (world / tp,
    tp) mesh and config; ``hapi.Model.fit(strategy=)`` then trains the
    tensor-parallel model (SGD, 2 steps) as the same fit trains the dense
    one (1e-5: one summation order per all-reduce). A degree that does not
    divide the world raises the reference's error."""
    for r in runs['two']:
        f = r['fleet']
        assert f['axes'] == {'data': 1, 'model': 2} and f['degree'] == 2
        for k, v in f['dense'].items():
            np.testing.assert_allclose(f['tp'][k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    st = t_dist.fleet.DistributedStrategy()
    st.tensor_parallel = True
    st.tensor_parallel_configs = {'tensor_parallel_degree': 2}
    with pytest.raises(ValueError, match='tensor_parallel_degree=2 does not '
                       'divide the 1 available devices'):
        t_dist.fleet.Fleet().init(strategy=st)
    assert not t_dist.env.is_initialized()


def test_tensor_parallel_attention_mask_probe_reads_the_dense_bits():
    """The attention kernels' head map (``mask_args``), through their plain
    versions on the CPU: heads 2-3 of a 4-head model draw the dense
    model's bits of those heads in the forward, dQ and dK/dV."""
    import chip_smoke
    from paddle_tpu_torch.kernels import philox
    cpu = torch.device('cpu')
    local = chip_smoke.attention_mask_probe(torch.float32, cpu, 130, 0.1,
                                            99, 5, heads=2, head_map=(4, 2))
    for path, (read, want) in local.items():
        assert torch.equal(read, want), path
    dense = philox.keep_mask((3, 4, 130, 130), 0.1, 99, 5)
    block = philox.keep_mask((3, 2, 130, 130), 0.1, 99, 5,
                             within=philox.head_block((3, 2, 130, 130),
                                                      (4, 2)))
    assert torch.equal(block, dense[:, 2:])


def test_rules_on_an_unmodified_module_compute_the_dense_result(runs):
    """``param_rules`` on ``Linear``s outside an attention/FFN pair: the
    gathered forms (column: outputs all-gathered; row: the dense input
    sliced), as the reference's rules under GSPMD keep the global result;
    ``with_rules_from`` reads the layers' specs back; ``shard_tensor`` on a
    model-axis spec cuts the rank's block; the model-axis collectives are
    counted under their own names while telemetry is on."""
    for r in runs['two']:
        rank, out = r['layers']
        (y_dense, gx_dense), (y_tp, gx_tp) = out['gathered']
        np.testing.assert_allclose(y_tp, y_dense, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gx_tp, gx_dense, rtol=1e-5, atol=1e-6)
        assert out['kinds'] == ['ColumnParallelLinear', 'Tanh',
                                'RowParallelLinear']
        assert out['rules_from'] == {'0.weight': (None, 'model'),
                                     '0.bias': ('model',),
                                     '2.weight': ('model', None)}
        np.testing.assert_array_equal(
            out['shard_tensor'], np.arange(8.0).reshape(2, 4)[:, 2 * rank:
                                                              2 * rank + 2])
        assert out['counters']['collective.model.all_gather.calls'] == 2
        assert out['counters']['collective.model.all_reduce.calls'] == 2
