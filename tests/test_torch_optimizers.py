"""The port's optimizers (``paddle_tpu_torch.optimizer``) against the JAX
package's ``functional_update``: the same numpy parameters and gradients,
three steps, every parameter and state slot within 1e-6 of its tensor's
largest value — ``amsgrad``, Nesterov, centered RMSProp, per-parameter
and global regularizers, per-parameter learning rates and all three clips
included. ``Dpsgd`` is exact at ``sigma = 0`` and held in mean and
variance otherwise. The eager ``step()`` gives the functional result bit
for bit; a step whose ``ok`` is False changes no bit; ``FlatFusedUpdate``
with each elementwise rule and the global-norm clip gives the
per-parameter result within 1e-6 and refuses the per-tensor-norm rules;
the state dict round trips, by name and by position; the interop
converters carry every optimizer's slots both ways."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jax_opt
from paddle_tpu.nn import clip as jax_clip
from paddle_tpu.nn import regularizer as jax_reg

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.interop import (load_paddle_tpu_opt_state,
                                      to_paddle_tpu_opt_state)
from paddle_tpu_torch.nn import clip as torch_clip
from paddle_tpu_torch.nn import regularizer as torch_reg
from paddle_tpu_torch.optimizer import FlatFusedUpdate

TOL = 1e-6
SHAPES = {'w': (7, 5), 'b': (5,), 'v': (3, 4, 2)}
STEPS = 3

# name -> (class name, keyword arguments); the same on both sides
CASES = {
    'sgd': ('SGD', dict(learning_rate=0.1)),
    'momentum': ('Momentum', dict(learning_rate=0.05, momentum=0.8)),
    'nesterov': ('Momentum', dict(learning_rate=0.05, momentum=0.8,
                                  use_nesterov=True)),
    'adam': ('Adam', dict(learning_rate=0.01)),
    'adam_amsgrad': ('Adam', dict(learning_rate=0.01, amsgrad=True)),
    'adamw': ('AdamW', dict(learning_rate=0.01, weight_decay=0.1)),
    'adamax': ('Adamax', dict(learning_rate=0.02)),
    'adadelta': ('Adadelta', dict(learning_rate=0.5, rho=0.9)),
    'adagrad': ('Adagrad', dict(learning_rate=0.1,
                                initial_accumulator_value=0.1)),
    'rmsprop': ('RMSProp', dict(learning_rate=0.01, momentum=0.5)),
    'rmsprop_centered': ('RMSProp', dict(learning_rate=0.01, momentum=0.5,
                                         centered=True)),
    'lamb': ('Lamb', dict(learning_rate=0.01, lamb_weight_decay=0.05)),
    'lars': ('LarsMomentum', dict(learning_rate=0.1, lars_coeff=0.01)),
    'ftrl': ('Ftrl', dict(learning_rate=0.1, l1=0.01, l2=0.02)),
    'decayed_adagrad': ('DecayedAdagrad', dict(learning_rate=0.1)),
    'dpsgd': ('Dpsgd', dict(learning_rate=0.1, clip=0.5, batch_size=4.0,
                            sigma=0.0)),
}
# the optimizers whose constructor takes weight_decay=
COUPLED = {'SGD', 'Momentum', 'Adam', 'Adamax', 'Adadelta', 'Adagrad',
           'RMSProp', 'DecayedAdagrad'}
ELEMENTWISE = [c for c in CASES
               if CASES[c][0] not in ('Lamb', 'LarsMomentum', 'Dpsgd')]


def _data(seed=0):
    rs = np.random.RandomState(seed)
    params = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rs.randn(*s) * 2).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


class _Meta:
    """A parameter's attributes, as a reference Parameter and a port
    ``nn.Parameter`` with a ``ParamAttr`` carry them."""

    def __init__(self, lr=1.0, regularizer=None, need_clip=True):
        self.optimize_attr = {'learning_rate': lr}
        self.regularizer = regularizer
        self.need_clip = need_clip


def _metas(pkg_reg):
    return {'w': _Meta(lr=0.5), 'b': _Meta(regularizer=pkg_reg.L1Decay(0.03),
                                          need_clip=False),
            'v': _Meta(regularizer=pkg_reg.L2Decay(0.02))}


def _build(pkg, case, clip=None, weight_decay=None):
    name, kw = CASES[case]
    kw = dict(kw)
    if clip is not None and name != 'Dpsgd':     # Dpsgd clips on its own
        kw['grad_clip'] = clip
    if weight_decay is not None and name in COUPLED:
        kw['weight_decay'] = weight_decay
    return getattr(pkg, name)(**kw)


def _ref_run(case, clip=None, weight_decay=None, meta=False):
    params, grads = _data()
    opt = _build(jax_opt, case, clip, weight_decay)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = opt.init_state_values(p)
    pm = _metas(jax_reg) if meta else None
    for g in grads:
        p, st = opt.functional_update(
            p, {k: jnp.asarray(v) for k, v in g.items()}, st, params_meta=pm)
    return ({k: np.asarray(v) for k, v in p.items()},
            {k: {s: np.asarray(t) for s, t in slots.items() if s != 'key'}
             for k, slots in st.items()})


def _port_run(case, clip=None, weight_decay=None, meta=False):
    params, grads = _data()
    opt = _build(topt, case, clip, weight_decay)
    p = {k: torch.tensor(v) for k, v in params.items()}
    st = opt.init_state_values(p)
    pm = _metas(torch_reg) if meta else None
    for g in grads:
        opt.functional_update(p, {k: torch.tensor(v) for k, v in g.items()},
                              st, params_meta=pm)
    return p, st


def _close(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1e-30), (what, err)


VARIANTS = {
    'plain': dict(),
    'global_norm': dict(clip='global', meta=True),
    'norm_clip': dict(clip='norm', weight_decay=0.01),
    'value_clip': dict(clip='value', weight_decay=0.01, meta=True),
}


def _clip(pkg, which):
    return {None: None, 'global': lambda: pkg.ClipGradByGlobalNorm(1.0),
            'norm': lambda: pkg.ClipGradByNorm(0.7),
            'value': lambda: pkg.ClipGradByValue(0.5)}[which]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_reference(case, variant):
    v = VARIANTS[variant]
    jc, tc = _clip(jax_clip, v.get('clip')), _clip(torch_clip, v.get('clip'))
    want_p, want_s = _ref_run(case, jc and jc(), v.get('weight_decay'),
                              v.get('meta', False))
    got_p, got_s = _port_run(case, tc and tc(), v.get('weight_decay'),
                             v.get('meta', False))
    for k in SHAPES:
        _close(got_p[k], want_p[k], f'{case} {variant} {k}')
        own = {s: t for s, t in got_s[k].items()
               if isinstance(t, torch.Tensor)}
        assert set(own) == set(want_s[k]), (own.keys(), want_s[k].keys())
        for s in own:
            _close(own[s], want_s[k][s], f'{case} {variant} {k}.{s}')


def test_dpsgd_noise_mean_and_variance():
    # zero gradients: each step moves every element of a tensor by the same
    # -lr * noise, noise ~ N(0, sigma) / batch_size
    n, sigma, bs, lr = 400, 0.3, 2.0, 1.0
    samples = {}
    for pkg, make in (('port', lambda v: torch.tensor(v)),
                      ('reference', jnp.asarray)):
        opt = (topt if pkg == 'port' else jax_opt).Dpsgd(
            learning_rate=lr, clip=1.0, batch_size=bs, sigma=sigma, seed=3)
        p = {str(i): make(np.zeros(2, np.float32)) for i in range(n)}
        st = opt.init_state_values(p)
        out = []
        for _ in range(3):
            before = {k: np.array(v) for k, v in p.items()}
            res = opt.functional_update(
                p, {k: make(np.zeros(2, np.float32)) for k in p}, st)
            if pkg == 'reference':
                p, st = res
            out += [float(before[k][0] - np.asarray(p[k])[0]) for k in p]
            assert all(np.asarray(p[k])[0] == np.asarray(p[k])[1]
                       for k in p)
        samples[pkg] = np.array(out) / lr
    std = sigma / bs
    for pkg, x in samples.items():
        assert abs(x.mean()) < 4 * std / np.sqrt(x.size), pkg
        assert abs(x.std() / std - 1) < 0.1, pkg
    # no two parameters share a stream
    first = samples['port'][:n]
    assert len(set(first.tolist())) == n


@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_step_is_the_functional_update_bitwise(case):
    params, grads = _data(1)
    opt = _build(topt, case, torch_clip.ClipGradByGlobalNorm(1.0))
    named = [(k, torch.nn.Parameter(torch.tensor(v)))
             for k, v in params.items()]
    named[0][1].optimize_attr = {'learning_rate': 0.5}
    eager = _build(topt, case, torch_clip.ClipGradByGlobalNorm(1.0))
    eager._parameters = list(named)
    p = {k: torch.tensor(v) for k, v in params.items()}
    st = opt.init_state_values(p)
    for g in grads:
        for k, t in named:
            t.grad = torch.tensor(g[k])
        eager.step()
        opt.functional_update(p, {k: torch.tensor(v) for k, v in g.items()},
                              st, params_meta=dict(named))
    assert eager._global_step == STEPS
    for k, t in named:
        assert torch.equal(t.detach(), p[k]), k
    # the split-phase API applies the pairs given
    pairs = [(t, torch.ones_like(t)) for _, t in named]
    before = [t.detach().clone() for _, t in named]
    assert eager.apply_optimize(None, None, pairs) == []
    assert any(not torch.equal(b, t) for b, (_, t) in zip(before, named))
    eager.clear_grad()
    assert all(t.grad is None for _, t in named)


@pytest.mark.parametrize("case", sorted(CASES))
def test_skipped_step_changes_no_bit(case):
    params, grads = _data(2)
    opt = _build(topt, case, torch_clip.ClipGradByGlobalNorm(1.0), 0.01)
    p = {k: torch.tensor(v) for k, v in params.items()}
    st = opt.init_state_values(p)
    opt.functional_update(p, {k: torch.tensor(v) for k, v in
                              grads[0].items()}, st,
                          ok=torch.tensor(True))

    def tensors():
        out = [t.clone() for t in p.values()]
        for slots in st.values():
            out += [t.clone() for t in slots.values()
                    if isinstance(t, torch.Tensor)]
        return out
    before = tensors()
    bad = {k: torch.full(SHAPES[k], float('nan')) for k in SHAPES}
    opt.functional_update(p, bad, st, ok=torch.tensor(False))
    assert all(torch.equal(a, b) for a, b in zip(before, tensors()))


@pytest.mark.parametrize("case", ELEMENTWISE)
def test_flat_update_matches_the_per_parameter_update(case):
    params, grads = _data(3)
    meta = {k: torch.nn.Parameter(torch.tensor(v))
            for k, v in params.items()}
    meta['w'].optimize_attr = {'learning_rate': 0.5}
    meta['b'].regularizer = torch_reg.L1Decay(0.03)
    meta['b'].need_clip = False

    def make():
        return _build(topt, case, torch_clip.ClipGradByGlobalNorm(1.0), 0.01)
    opt = make()
    p = {k: torch.tensor(v) for k, v in params.items()}
    st = opt.init_state_values(p)
    flat = FlatFusedUpdate(make(), meta)
    fp = flat.flatten(p)
    fst = flat.init_state(fp)
    for g in grads:
        gt = {k: torch.tensor(v) for k, v in g.items()}
        opt.functional_update(p, gt, st, params_meta=meta)
        flat.update(fp, gt, fst)
    got = flat.unflatten(fp)
    for k in SHAPES:
        _close(got[k], p[k].numpy(), f'flat {case} {k}')


@pytest.mark.parametrize("bad", ['lamb', 'lars', 'dpsgd', 'norm_clip'])
def test_flat_update_refuses_per_tensor_norms(bad):
    params = {k: torch.zeros(s) for k, s in SHAPES.items()}
    opt = (_build(topt, 'adam', torch_clip.ClipGradByNorm(1.0))
           if bad == 'norm_clip' else _build(topt, bad))
    with pytest.raises(ValueError, match='norm'):
        FlatFusedUpdate(opt, params)


def test_lamb_honours_its_exclusion_function():
    # an excluded parameter steps as Lamb without decay; the reference
    # decays every parameter (ROADMAP.md, Queue 3)
    params, grads = _data(4)
    got = {}
    for wd, fn in ((0.05, lambda n: n == 'b'), (0.0, None), (0.05, None)):
        opt = topt.Lamb(learning_rate=0.01, lamb_weight_decay=wd,
                        exclude_from_weight_decay_fn=fn)
        p = {k: torch.tensor(v) for k, v in params.items()}
        st = opt.init_state_values(p)
        for g in grads:
            opt.functional_update(p, {k: torch.tensor(v)
                                      for k, v in g.items()}, st)
        got[(wd, fn is None)] = p
    assert torch.equal(got[(0.05, False)]['b'], got[(0.0, True)]['b'])
    assert torch.equal(got[(0.05, False)]['w'], got[(0.05, True)]['w'])
    assert not torch.equal(got[(0.05, True)]['b'], got[(0.0, True)]['b'])


def test_state_dict_by_name_and_by_position():
    params, grads = _data(5)
    named = [(k, torch.nn.Parameter(torch.tensor(v)))
             for k, v in params.items()]
    opt = topt.Adam(learning_rate=0.01, amsgrad=True, parameters=named)
    for k, t in named:
        t.grad = torch.tensor(grads[0][k])
    opt.step()
    sd = opt.state_dict()
    assert sd['global_step'] == 1
    assert list(sd)[:5] == ['w.moment1', 'w.moment2', 'w.beta1_pow',
                            'w.beta2_pow', 'w.moment2_max']
    # a renamed copy of the model: matched by position
    renamed = [(f'x{i}', torch.nn.Parameter(t.detach().clone()))
               for i, (_, t) in enumerate(named)]
    other = topt.Adam(learning_rate=0.01, amsgrad=True, parameters=renamed)
    other.set_state_dict({k: (v.numpy() if isinstance(v, torch.Tensor)
                              else v) for k, v in sd.items()})
    assert torch.equal(other._accumulators['x0']['moment1'],
                       opt._accumulators['w']['moment1'])
    for (_, a), (_, b) in zip(named, renamed):
        a.grad = torch.tensor(grads[1]['w'] if a.shape == (7, 5) else
                              np.ones(tuple(a.shape), np.float32))
        b.grad = a.grad.clone()
    opt.step()
    other.step()
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(named, renamed))
    wrong = [(f'y{i}', torch.nn.Parameter(torch.zeros(2)))
             for i in range(3)]
    with pytest.raises(ValueError, match='positionally'):
        topt.Adam(parameters=wrong).set_state_dict(sd)
    with pytest.raises(ValueError, match='counts differ'):
        topt.Adam(parameters=wrong[:2]).set_state_dict(sd)
    with pytest.warns(UserWarning, match='no matching parameter'):
        topt.Adam(parameters=named[:2] + [('z', named[2][1])]
                  ).set_state_dict(sd)


@pytest.mark.parametrize("case", sorted(CASES))
def test_interop_carries_every_slot(case):
    params, grads = _data(6)
    _, ref_state = _ref_run(case)
    opt = _build(topt, case)
    st = opt.init_state_values({k: torch.tensor(v)
                                for k, v in params.items()})
    module = torch.nn.Module()
    load_paddle_tpu_opt_state(module, st, ref_state)
    back = to_paddle_tpu_opt_state(module, st)
    assert set(back) == set(ref_state)
    for k in ref_state:
        assert set(back[k]) == set(ref_state[k])
        for s in ref_state[k]:
            assert np.array_equal(back[k][s], ref_state[k][s]), (k, s)
    with pytest.raises(ValueError):
        load_paddle_tpu_opt_state(module, st, {'w': ref_state['w']})


def test_aliases_and_constructor_checks():
    assert topt.LambOptimizer is topt.Lamb
    assert topt.DpsgdOptimizer is topt.Dpsgd
    assert topt.MomentumOptimizer is topt.Momentum
    assert topt.SGDOptimizer is topt.SGD
    with pytest.raises(TypeError, match='learning_rate'):
        topt.SGD(learning_rate='0.1')
    assert isinstance(topt.Momentum(weight_decay=0.1)._weight_decay,
                      torch_reg.L2Decay)


def test_reference_fault_lamb_ignores_its_exclusion_function():
    """The reference's ``Lamb`` stores ``exclude_from_weight_decay_fn`` and
    its rule decays every parameter (ROADMAP.md, Queue 3); the port
    honours the function."""
    params, grads = _data(7)
    out = {}
    for side, pkg, make in (('reference', jax_opt, jnp.asarray),
                            ('port', topt, torch.tensor)):
        for fn in (None, lambda name: True):
            opt = pkg.Lamb(learning_rate=0.01, lamb_weight_decay=0.1,
                           exclude_from_weight_decay_fn=fn)
            p = {k: make(v) for k, v in params.items()}
            st = opt.init_state_values(p)
            for g in grads:
                res = opt.functional_update(
                    p, {k: make(v) for k, v in g.items()}, st)
                if side == 'reference':
                    p, st = res
            out[(side, fn is None)] = {k: np.array(v) for k, v in p.items()}
    for k in SHAPES:
        assert np.array_equal(out[('reference', True)][k],
                              out[('reference', False)][k])
        assert not np.array_equal(out[('port', True)][k],
                                  out[('port', False)][k])


def test_reference_fault_flat_update_drops_the_clip_and_takes_lamb():
    """The reference's ``FlatFusedUpdate.update`` never applies the
    optimizer's ``grad_clip``, and runs Lamb's trust ratio over the whole
    buffer instead of per tensor (ROADMAP.md, Queue 3). The port clips on
    the flat path (``test_flat_update_matches_the_per_parameter_update``)
    and refuses Lamb."""
    from paddle_tpu.optimizer.fused import FlatFusedUpdate as JaxFlat
    params, grads = _data(8)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    g = {k: jnp.asarray(v) for k, v in grads[0].items()}
    flat_out = {}
    for clip in (None, jax_clip.ClipGradByGlobalNorm(1e-3)):
        flat = JaxFlat(jax_opt.SGD(learning_rate=0.1, grad_clip=clip), jp)
        fp = flat.flatten(jp)
        new, _ = flat.update(fp, g, flat.init_state(fp))
        flat_out[clip is None] = np.asarray(new)
    assert np.array_equal(flat_out[True], flat_out[False])      # dropped
    lamb = jax_opt.Lamb(learning_rate=0.01)
    flat = JaxFlat(lamb, jp)
    fp = flat.flatten(jp)
    new, _ = flat.update(fp, g, flat.init_state(fp))
    whole = flat.unflatten(new)
    per, _ = lamb.functional_update(jp, g, lamb.init_state_values(jp))
    assert any(np.abs(np.asarray(whole[k]) - np.asarray(per[k])).max()
               > 1e-4 for k in SHAPES)           # one trust ratio for all
    with pytest.raises(ValueError, match='norm'):
        FlatFusedUpdate(topt.Lamb(), {k: torch.tensor(v)
                                      for k, v in params.items()})
