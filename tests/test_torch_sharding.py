"""The port's FSDP step (``engine.build_train_step(sharding=)``,
``distributed.sharding``, ``distributed.strategy``) against its
DataParallel step and the reference's sharded step.

One module-scoped ``spawn`` of two gloo ranks (``_torch_dist_ranks.
sharding_cases``) runs every rank-side case at once, joined with a 60 s
timeout. The model is a 2-layer BERT (hidden 64, vocab 512, L = 64,
dropout 0 unless a case says otherwise) on weights the reference made,
the global batch 4 (2 a rank), three steps. Tolerances:

- the FSDP step equals the DataParallel step bit for bit under AdamW (the
  reduce-scatter and the all-reduce each add the same two addends), and
  within 1e-6 under Lamb with the global-norm clip (the norms are summed
  across the ranks in another order);
- both within rtol 1e-5 / atol 1e-6 of the reference's ``sharding=``
  step on a 2-device mesh over the same global batch (the reference's own
  data-parallel tolerance), with SGD, and with SGD under the global-norm
  clip (the cross-rank norm, held against the reference's): Adam's first
  steps move an element
  by the sign of its gradient, and a gradient at the level of its rounding
  noise flips sign between any two summation orders (the single-process
  comparison, ``test_torch_engine.py``, says so at length);
- the specs (``first_divisible_spec``, ``fsdp_pspecs``) and the refusals
  equal the reference's.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as r_P

import paddle_tpu as paddle
from paddle_tpu import engine as r_engine
from paddle_tpu import optimizer as r_opt
from paddle_tpu.core import rng as r_rng
from paddle_tpu.distributed import env as r_env
from paddle_tpu.distributed import fleet as r_fleet
from paddle_tpu.distributed import strategy as r_strategy
from paddle_tpu.distributed import sharding as r_sharding
from paddle_tpu.distributed.sharding import (
    first_divisible_spec as r_first_divisible, fsdp_pspecs as r_fsdp_pspecs)
from paddle_tpu.nn.layer_base import buffer_values, param_values
from paddle_tpu.text.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.bert import BertForPretraining as JaxBertForPretraining

import paddle_tpu_torch as pt
from paddle_tpu_torch.engine import build_train_step
from paddle_tpu_torch import distributed as t_dist
from paddle_tpu_torch.distributed import fleet as t_fleet
from paddle_tpu_torch.distributed import sharding as t_sharding
from paddle_tpu_torch.distributed import strategy as t_strategy
from paddle_tpu_torch.interop import load_paddle_tpu_state, \
    to_paddle_tpu_state

import _torch_dist_ranks as R

JOIN_S = 60


@pytest.fixture(autouse=True)
def _clean():
    yield
    r_strategy.set_current_config(None)
    t_strategy.set_current_config(None)
    r_env.set_mesh(None)
    r_env._global['initialized'] = False
    t_dist.env.shutdown()


@pytest.fixture(scope='module')
def shared():
    """The reference's BERT, the port's on its weights (port names)."""
    paddle.seed(5)
    ref = JaxBertForPretraining(JaxBertConfig(**R.SMALL))
    params = {k: np.asarray(v)
              for k, v in param_values(ref, trainable_only=False).items()}
    port = R.model()
    load_paddle_tpu_state(port, params)
    return ref, R.weights(port)


@pytest.fixture(scope='module')
def ranks(shared):
    ctx = t_dist.spawn(R.sharding_cases, args=(shared[1],), nprocs=2,
                       backend='gloo', join=False)
    return ctx.join(timeout=JOIN_S)


def _to_ref_names(port_state):
    net = R.model(port_state)
    return to_paddle_tpu_state(net)


def _ref_sharded_sgd(ref, data, lr, grad_clip=None):
    """The reference's ``sharding=`` step (FSDP over a 2-device mesh),
    SGD (with ``grad_clip``), on the global batches -> (losses,
    parameters by reference name)."""
    cfg = r_strategy.ShardingConfig(
        mesh=Mesh(np.asarray(jax.devices()[:2]), ('data',)))
    step = r_engine.build_train_step(
        net=ref, loss=ref.pretraining_loss,
        optimizer=r_opt.SGD(learning_rate=lr, grad_clip=grad_clip),
        sharding=cfg)
    state = step.init_state(param_values(ref), buffer_values(ref))
    losses = []
    for x, y in data:
        state, out = step(state, (x, y), r_rng.next_key())
        losses.append(float(out.loss))
    return losses, {k: np.asarray(v) for k, v in state['params'].items()}


# -- specs and refusals (one process) ----------------------------------------

SHAPES = [(1024, 64), (30522, 1024), (30522, 1023), (3, 5), (7,), (512,),
          (6, 1024), (1023, 4), (2, 1024), (1024,), (13, 17, 4), ()]


@pytest.mark.parametrize('n', [1, 2, 4, 8])
def test_specs_match_reference(n):
    for min_size in (1, 64, 1024):
        for shape in SHAPES:
            want = r_first_divisible(shape, n, 'data', min_size)
            got = t_sharding.first_divisible_spec(shape, n, 'data',
                                                  min_size)
            assert got == tuple(want), (shape, n, min_size)
    shapes = {f'p{i}': s for i, s in enumerate(SHAPES)}
    want = r_fsdp_pspecs(shapes, n=n)
    got = t_sharding.fsdp_pspecs(shapes, n=n)
    assert got == {k: tuple(v) for k, v in want.items()}
    cfg = t_strategy.ShardingConfig()
    assert cfg.param_specs(shapes) == {k: () for k in shapes}  # world 1


def _knobs(side):
    """The reference's refusal cases (tests/test_sharding_train.py), run
    on one side -> what each raised."""
    out = []
    st = side.DistributedStrategy()
    out.append(side_resolve(side)(st) is None)
    st.sharding = True
    out.append(type(side_resolve(side)(st)).__name__)
    for knob in ('dgc', 'pipeline', 'hierarchical_allreduce'):
        setattr(st, knob, True)
        with pytest.raises(NotImplementedError, match=knob):
            side_resolve(side)(st)
        setattr(st, knob, False)
    for cfg, match in (({'segment_size': 2 ** 20}, 'segment_size'),
                       ({'stage': 1}, 'stage')):
        st.sharding_configs = cfg
        with pytest.raises(NotImplementedError, match=match):
            side_resolve(side)(st)
    st.sharding_configs = {'stage': 3, 'min_size': 64}
    out.append(side_resolve(side)(st).min_size)
    st.tensor_parallel = True
    st.tensor_parallel_configs = {'tensor_parallel_degree': 2,
                                  'mp_ring': True}
    with pytest.raises(NotImplementedError, match='mp_ring'):
        side_resolve(side)(st)
    with pytest.raises(TypeError, match='cannot resolve'):
        side_resolve(side)(object())
    return out


def side_resolve(side):
    return (r_strategy if side is r_fleet else t_strategy).resolve_sharding


def test_unsupported_knobs_raise_as_reference():
    assert _knobs(t_fleet) == _knobs(r_fleet) == [True, 'ShardingConfig',
                                                  64]
    # tensor parallelism resolves as the reference's, and a degree the
    # devices do not divide raises its error (the port's one process has
    # one device, the reference's 8 host devices divide 2 but not 3)
    for side, tp, devices in ((t_fleet, 2, 1), (r_fleet, 3, 8)):
        st = side.DistributedStrategy()
        st.tensor_parallel = True
        st.tensor_parallel_configs = {'tensor_parallel_degree': tp}
        with pytest.raises(ValueError, match=f'tensor_parallel_degree={tp} '
                           f'does not divide the {devices} available'):
            side_resolve(side)(st)
    # the layers without a model axis are the dense layers, as the
    # reference's without a mesh
    paddle.seed(2)
    ref_col = r_sharding.ColumnParallelLinear(4, 6)
    col = t_sharding.ColumnParallelLinear.from_linear(
        R._linear(np.asarray(ref_col.weight.numpy()),
                  np.asarray(ref_col.bias.numpy())))
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    np.testing.assert_allclose(
        col(torch.from_numpy(x)).detach().numpy(),
        np.asarray(ref_col(paddle.to_tensor(x)).numpy()), rtol=1e-6)
    for cls in (t_sharding.ColumnParallelLinear,
                t_sharding.RowParallelLinear,
                t_sharding.VocabParallelEmbedding):
        layer = cls(4, 4, device='cpu')
        assert all(getattr(p, 'tp_spec', None) is not None
                   for n, p in layer.named_parameters()
                   if n.endswith('weight'))
    # param_rules: the reference's specs, FSDP for the rest
    rules = {'w': (None, 'model')}
    shapes = {'w': (8, 8), 'v': (2048,)}
    got = t_strategy.ShardingConfig(param_rules=rules).param_specs(shapes)
    want = r_strategy.ShardingConfig(
        mesh=Mesh(np.asarray(jax.devices()[:1]), ('data',)),
        param_rules={'w': r_P(None, 'model')}).param_specs(shapes)
    assert got == {k: tuple(v) for k, v in want.items()}
    with pytest.raises(ValueError, match='FlatFusedUpdate'):
        from paddle_tpu_torch.optimizer.fused import FlatFusedUpdate
        net = R.model()
        build_train_step(
            net=net, loss=net.pretraining_loss,
            optimizer=FlatFusedUpdate(pt.optimizer.AdamW(),
                                      dict(net.named_parameters())),
            sharding=t_strategy.ShardingConfig(), device='cpu')


def test_fleet_optimizer_carries_config_into_hapi():
    st = t_fleet.DistributedStrategy()
    st.sharding = True
    st.sharding_configs = {'min_size': 64}
    net = R.model()
    opt = pt.optimizer.Adam(learning_rate=1e-3,
                            parameters=net.named_parameters())
    dopt = t_fleet.fleet.distributed_optimizer(opt, strategy=st)
    assert isinstance(dopt.sharding_config, t_strategy.ShardingConfig)
    assert t_strategy.current_config() is dopt.sharding_config
    m = pt.Model(net, device='cpu')
    m.prepare(optimizer=dopt, loss=net.pretraining_loss)
    assert m._sharding_cfg is dopt.sharding_config and m._use_jit
    x, y = R.batches(1, 2)[0]
    before = R.weights(net)
    m.train_batch(list(x), list(y))
    m._sync_jit_state()
    assert not R._params_equal(before, R.weights(net))
    # a knobs-off re-init clears the installed config
    t_fleet.fleet.init(strategy=st)
    assert t_strategy.current_config() is not None
    t_fleet.fleet.init(strategy=t_fleet.DistributedStrategy())
    assert t_strategy.current_config() is None


# -- the ranks ---------------------------------------------------------------

def test_fsdp_equals_data_parallel_bitwise_under_adamw(ranks):
    for out in ranks:
        f, d = out['adamw']['fsdp'], out['adamw']['dp']
        assert f[0] == d[0]
        for k in f[1]:
            assert np.array_equal(f[1][k], d[1][k]), k
        for k, slots in f[2].items():
            for s, v in slots.items():
                assert np.array_equal(v, d[2][k][s]), (k, s)
    # every rank holds the same model
    for k, v in ranks[0]['adamw']['fsdp'][1].items():
        assert np.array_equal(v, ranks[1]['adamw']['fsdp'][1][k]), k


def test_in_shardings_split_the_global_batch(ranks):
    """A ``DataParallel`` step with ``in_shardings=(None, ('data',))`` fed
    the global batches equals the one fed each rank's slices, bit for
    bit."""
    for out in ranks:
        assert out['in_shardings'] == out['adamw']['dp'][0]


def test_fsdp_lamb_clip_within_1e6_of_data_parallel(ranks):
    for out in ranks:
        f, d = out['lamb']['fsdp'], out['lamb']['dp']
        np.testing.assert_allclose(f[0], d[0], rtol=1e-6)
        for k in f[1]:
            np.testing.assert_allclose(f[1][k], d[1][k], rtol=0, atol=1e-6,
                                       err_msg=k)


def test_both_steps_match_the_reference_sharded_step(ranks, shared):
    """SGD through the port's FSDP and DataParallel steps at k = 2 against
    the reference's ``sharding=`` step on a 2-device mesh."""
    ref, _ = shared
    ref_losses, ref_params = _ref_sharded_sgd(ref, R.batches(3, 4), 0.05)
    for out in ranks:
        for kind in ('fsdp', 'dp'):
            losses, params, _ = out['sgd'][kind]
            np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
            got = _to_ref_names(params)
            for k, v in ref_params.items():
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                           err_msg=f'{kind} {k}')


def test_global_norm_clip_matches_the_reference_sharded_step(ranks,
                                                             shared):
    """SGD with ``ClipGradByGlobalNorm`` (every step clips) through the
    port's FSDP step, whose norm is summed across the ranks' pieces
    (``nn.clip.rank_norms``), and its DataParallel step at k = 2 against
    the reference's ``sharding=`` step on a 2-device mesh."""
    from paddle_tpu.nn import ClipGradByGlobalNorm as RClip
    ref, _ = shared
    ref_losses, ref_params = _ref_sharded_sgd(
        ref, R.batches(3, 4), 0.05, grad_clip=RClip(R.CLIP_NORM))
    for out in ranks:
        for kind in ('fsdp', 'dp'):
            losses, params, _ = out['sgd_clip'][kind]
            np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
            got = _to_ref_names(params)
            for k, v in ref_params.items():
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                           err_msg=f'{kind} {k}')
        # the clip acted (a scale of 1 would leave plain SGD's bits)
        assert not R._params_equal(out['sgd_clip']['fsdp'][1],
                                   out['sgd']['fsdp'][1])
    # the ranks hold one model
    for k, v in ranks[0]['sgd_clip']['fsdp'][1].items():
        assert np.array_equal(v, ranks[1]['sgd_clip']['fsdp'][1][k]), k


def test_inf_in_one_ranks_piece_skips_the_step_on_both(ranks):
    for out in ranks:
        p = out['poison']
        assert p['unchanged'] and p['finite_loss']
        assert p['sync']['guard']['skipped'] == 0   # the loss was finite
        # one bad step: the scaler's decrement waits for a second
        assert p['sync']['scaler'] == {'scale': 2.0 ** 15, 'good': 0,
                                       'bad': 1}


def test_masks_differ_by_rank_rank0_unchanged_and_survive_remat(ranks,
                                                                 shared):
    _, init = shared
    drop = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    x = R._feed(R.local(R.batches(1, 4)[0], 0, 2))[0]
    alone = R.model(init, **drop).train()
    with torch.no_grad():
        want = alone(*x)[0].numpy()
    # through DataParallel (the gradients averaged): each rank its own
    assert np.array_equal(ranks[0]['masked_forward'], want)
    assert not np.array_equal(ranks[1]['masked_forward'], want)
    # a model that synchronises nothing: rank 0's masks on every rank
    for out in ranks:
        assert np.array_equal(out['unsynced_forward'], want)
    for rank, out in enumerate(ranks):
        plain, remat = out['remat_None'], out['remat_full']
        assert plain[0] == remat[0]
        for k in plain[1]:
            assert np.array_equal(plain[1][k], remat[1][k]), k
        # the sharded step keyed the model's masks on the rank
        assert plain[2] == remat[2] == rank


def test_sharding_gauges_and_collectives(ranks, shared):
    _, init = shared
    params = {k: v.shape for k, v in init.items()}
    specs = r_fsdp_pspecs(params, n=2)
    pieces = sum(int(np.prod(s)) * 4 // (2 if tuple(specs[k]) else 1)
                 for k, s in params.items())
    rcfg = r_strategy.ShardingConfig(
        mesh=Mesh(np.asarray(jax.devices()[:2]), ('data',)))
    est = rcfg.collective_bytes_estimate(
        {k: np.zeros(s, np.float32) for k, s in params.items()})
    for out in ranks:
        g = out['gauges']
        assert g['sharding.param_bytes_per_device'] == pieces
        assert g['sharding.opt_bytes_per_device'] == 2 * pieces + \
            2 * 4 * len(params)   # moments, and the beta powers' 0-dim
        assert g['sharding.mesh_devices'] == 2
        assert g['sharding.collective_bytes_per_step_est'] == est
        assert out['info']['sharded_params'] == sum(
            1 for s in specs.values() if tuple(s))
        # one step: one gather of the parameters, one reduce-scatter of
        # the pieces' gradients, one all-reduce of the whole leaves'
        # gradients and one of the loss
        c = out['counts_one_step']
        assert c['all_gather']['calls'] == 1
        assert c['reduce_scatter']['calls'] == 1
        assert c['all_reduce']['calls'] == 2
        for k, (dim, full, piece) in out['pieces'].items():
            assert tuple(specs[k])[dim] == 'data', k


def test_model_parallel_names_wait_for_5b():
    """The model-parallel names work in one process as the reference's do
    without a model-parallel mesh (their gloo-rank cases:
    tests/test_torch_tensor_parallel.py,
    test_torch_ring_attention.py, test_torch_pipeline.py,
    test_torch_ps_fs.py)."""
    from paddle_tpu.distributed.ring_attention import ring_attention as rr
    from paddle_tpu.kernels.flash_attention import _attn_reference
    rs = np.random.RandomState(0)
    qkv = [rs.randn(1, 2, 16, 8).astype(np.float32) for _ in range(3)]
    # no 'seq' axis: plain causal attention, the reference's fallback
    got = t_dist.ring_attention(*(torch.from_numpy(a) for a in qkv))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(rr(*qkv, mesh=None)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(_attn_reference(*qkv, True, 8 ** -0.5)),
        rtol=1e-5, atol=1e-6)
    # no pipe axis: every stacked stage in sequence
    stacked = {'w': torch.stack([torch.eye(3) * 2, torch.eye(3) * 3])}
    out = t_dist.pipeline.pipeline_apply(lambda p, x: x @ p['w'], stacked,
                                         torch.ones(4, 3), 2)
    assert torch.equal(out, torch.full((4, 3), 6.0))
    table = t_dist.ps.SparseShardedTable(
        8, 4, device='cpu', generator=torch.Generator().manual_seed(0))
    assert tuple(table.pull(torch.tensor([1, 1])).shape) == (2, 4)
    assert t_dist.fs.LocalFS().is_exist('/')
    assert t_dist.HDFSClient is t_dist.fs.HDFSClient
    # a one-rank axis: (0, 0) keeps the value, a rank no pair targets gets
    # zeros, as lax.ppermute's
    x = torch.tensor([1.0, 2.0])
    assert torch.equal(t_dist.ppermute(x, [(0, 0)]), x)
    assert torch.equal(t_dist.ppermute(x, []), torch.zeros(2))
    with pytest.raises(ValueError, match='does not hold the 1 ranks'):
        t_dist.init_parallel_env(mesh_shape=(1, 2))
    with pytest.raises(NotImplementedError, match='all_reduce'):
        t_dist.collective.in_jit_all_reduce(None)


def test_recompute_replays_dropout_and_is_the_direct_call():
    """``recompute(layer, x)`` (the reference's contract: the direct
    call's output and gradients, its activations rebuilt in the backward)
    on an encoder layer at p = 0.1: bit for bit, its masks replayed."""
    net = R.model(hidden_dropout_prob=0.1,
                  attention_probs_dropout_prob=0.1).train()
    layer = net.bert.encoder.layers[0]
    x0 = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(1))
    grads = []
    for use in (False, True):
        net.dropout_state.offset = 0
        x = x0.clone().requires_grad_()
        out = t_dist.recompute(layer, x) if use else layer(x)
        out.sum().backward()
        grads.append((out.detach(), x.grad,
                       [p.grad.clone() for p in layer.parameters()],
                       net.dropout_state.offset))
        layer.zero_grad()
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    for a, b in zip(grads[0][2], grads[1][2]):
        assert torch.equal(a, b)
    # the recompute drew no mask of its own
    assert grads[0][3] == grads[1][3] > 0


def test_role_makers_env_and_dataset_factory(tmp_path, monkeypatch):
    from paddle_tpu.distributed import role_maker as r_roles
    monkeypatch.setenv('PADDLE_TRAINER_ID', '1')
    monkeypatch.setenv('PADDLE_TRAINERS_NUM', '3')
    monkeypatch.setenv('PADDLE_TRAINER_ENDPOINTS', 'a:1,b:2,c:3')

    def roles(mod):
        cloud = mod.PaddleCloudRoleMaker()
        user = mod.UserDefinedRoleMaker(current_id=2, worker_num=4,
                                        role='SERVER')
        return [cloud.worker_index(), cloud.worker_num(),
                cloud.is_first_worker(), cloud.get_trainer_endpoints(),
                user.worker_index(), user.worker_num(), user.is_server(),
                user.is_worker()]
    assert roles(t_dist.role_maker) == roles(r_roles)
    f = tmp_path / 'part'
    f.write_text('a\nb\nc\n')
    ds = t_dist.DatasetFactory().create_dataset('InMemoryDataset')
    ds.set_filelist([str(f)])
    ds.set_batch_size(2)
    ds.load_into_memory()
    assert ds.get_memory_data_size() == 3 and list(ds) == ['a\n', 'b\n',
                                                         'c\n']
    # no process group: one rank, and init_distributed joins one (a
    # file:// rendezvous, then left)
    env = t_dist.ParallelEnv()
    assert (env.rank, env.world_size, env.device_type) == (0, 1, 'cpu')
    got = t_dist.init_distributed(f"file://{tmp_path / 'store'}",
                                  num_processes=1, process_id=0,
                                  backend='gloo')
    assert got.world_size == 1 and t_dist.env.is_initialized()
    assert t_dist.get_mesh().mesh_dim_names == ('data',)
