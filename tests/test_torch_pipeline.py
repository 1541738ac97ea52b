"""The GPipe pipeline (``distributed.pipeline``) against the reference's
``pipeline_apply`` (``tests/test_pipeline.py:38-111``).

Gloo ranks on the CPU, one process a stage (``_torch_dist_ranks.
pipeline_cases``): four stages and two, side by side, joined within 180 s.
The reference runs on ``('pipe', n)`` meshes of the 8 host devices
(``tests/conftest.py``). The stages are the reference's MLP (d = 8,
weights 0.3 N(0, 1) from a seed), the batch 16 x 8. Tolerances: the
reference's own (forward 2e-4 / 2e-5, gradients 5e-4 / 5e-5), against its
pipeline and against the stages run in sequence; ``checkpoint=True``
(recompute) and ``False`` both.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from paddle_tpu.distributed import env as r_env
from paddle_tpu.distributed.pipeline import (
    pipeline_apply as r_pipeline_apply,
    stack_stage_params as r_stack)

from paddle_tpu_torch import distributed as t_dist
from paddle_tpu_torch.distributed import pipeline as t_pipeline

import _torch_dist_ranks as R

JOIN_S = 180
CASES = {4: [(4, True), (8, True), (4, False)], 2: [(2, True), (2, False)]}


@pytest.fixture(autouse=True)
def _clean():
    yield
    r_env.set_mesh(None)
    r_env._global['initialized'] = False


def _mlp_stage(params, x):
    h = jnp.tanh(x @ params['w1'] + params['b1'])
    return h @ params['w2'] + params['b2']


def _make_params(n_stages, d, rs):
    return [{'w1': (rs.randn(d, d) * 0.3).astype(np.float32),
             'b1': np.zeros((d,), np.float32),
             'w2': (rs.randn(d, d) * 0.3).astype(np.float32),
             'b2': np.zeros((d,), np.float32)} for _ in range(n_stages)]


def _inputs(n_stages):
    rs = np.random.RandomState(n_stages)
    per_stage = _make_params(n_stages, 8, rs)
    return per_stage, rs.randn(16, 8).astype(np.float32)


def _reference(per_stage, x, n_micro):
    """The reference's pipeline on a ('pipe', S) mesh -> (output, x's
    gradient, the stacked gradients), loss: sum of the squared output."""
    S = len(per_stage)
    mesh = Mesh(np.asarray(jax.devices()[:S]), ('pipe',))
    stacked = r_stack([{k: jnp.asarray(v) for k, v in p.items()}
                       for p in per_stage])

    def fwd(st, x):
        return r_pipeline_apply(_mlp_stage, st, x, n_micro, mesh=mesh)
    y = jax.jit(fwd)(stacked, jnp.asarray(x))
    g_st, g_x = jax.jit(jax.grad(lambda st, x: jnp.sum(fwd(st, x) ** 2),
                                 argnums=(0, 1)))(stacked, jnp.asarray(x))
    return (np.asarray(y), np.asarray(g_x),
            {k: np.asarray(v) for k, v in g_st.items()})


def _sequential(per_stage, x):
    """The stages one after another on the whole batch, in torch (float64
    holds the reference's tolerances with room) -> (output, x's gradient,
    each stage's gradients)."""
    ps = [{k: torch.from_numpy(v).double().requires_grad_()
           for k, v in p.items()} for p in per_stage]
    xt = torch.from_numpy(x).double().requires_grad_()
    h = xt
    for p in ps:
        h = torch.tanh(h @ p['w1'] + p['b1']) @ p['w2'] + p['b2']
    loss = (h ** 2).sum()
    leaves = [xt] + [v for p in ps for v in p.values()]
    grads = torch.autograd.grad(loss, leaves)
    per = [dict(zip(p, grads[1 + 4 * i:5 + 4 * i]))
           for i, p in enumerate(ps)]
    return h.detach().numpy(), grads[0].numpy(), \
        [{k: v.numpy() for k, v in g.items()} for g in per]


@pytest.fixture(scope='module')
def runs():
    ctx = {S: t_dist.spawn(R.pipeline_cases,
                           args=(*_inputs(S), CASES[S]), nprocs=S,
                           backend='gloo', join=False) for S in (4, 2)}
    ref = {S: {n: _reference(*_inputs(S), n) for n in {m for m, _ in
                                                          CASES[S]}}
           for S in (4, 2)}
    return {S: c.join(timeout=JOIN_S) for S, c in ctx.items()}, ref


def _fwd(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def _grad(got, want):
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize('S,n_micro,ckpt', [(S, n, c) for S in (4, 2)
                                            for n, c in CASES[S]])
def test_pipeline_forward_and_gradients_match_reference(runs, S, n_micro,
                                                        ckpt):
    ranks, ref = runs
    y_ref, gx_ref, gst_ref = ref[S][n_micro]
    seq = _sequential(*_inputs(S))
    for r in ranks[S]:
        y, gx, gst = r[(n_micro, ckpt)]
        _fwd(y, y_ref)                 # the output reaches every stage
        _fwd(y, seq[0])
        _grad(gx, gx_ref)
        _grad(gx, seq[1])
        s = r['rank']
        for k, g in gst.items():       # this stage's parameters
            _grad(g, gst_ref[k][s])
            _grad(g, seq[2][s][k])


def test_pipeline_schedule_and_stage_count_error(runs):
    ranks, _ = runs
    for S in (4, 2):
        for r in ranks[S]:
            assert r['schedule'] == {'ticks': CASES[S][0][0] + S - 1,
                                     'bubble': (S - 1) /
                                     (CASES[S][0][0] + S - 1)}
            assert r['mismatch'] == (f"stacked stage dim ({S + 1}) != mesh "
                                     f"'pipe' size ({S})")


@pytest.mark.parametrize('n_stages', [1, 3])
def test_pipeline_without_a_pipe_axis_runs_every_stage(n_stages):
    """No process group: every stacked stage runs in sequence, as the
    reference's on a 1-device (or missing) pipe mesh."""
    per_stage, x = _inputs(n_stages)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ('pipe',))
    want = np.asarray(r_pipeline_apply(
        _mlp_stage, r_stack([{k: jnp.asarray(v) for k, v in p.items()}
                             for p in per_stage]),
        jnp.asarray(x), 2, mesh=mesh))
    stacked = t_pipeline.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in per_stage])
    got = t_pipeline.pipeline_apply(R._mlp_stage, stacked,
                                    torch.from_numpy(x), 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert t_pipeline.num_stages() == 1
    assert t_pipeline.stage_pspec(stacked) == {
        'w1': ('pipe', None, None), 'b1': ('pipe', None),
        'w2': ('pipe', None, None), 'b2': ('pipe', None)}
