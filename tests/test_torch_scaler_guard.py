"""The loss scaler, the NaN guard, microbatches and the eager optimizer API
of the port against the JAX package's.

- ``GradScaler``: one sequence of good and bad steps through both packages
  gives the same ``scale``, ``good`` and ``bad`` after every step (exact:
  the policy is host arithmetic on Python numbers in both).
- ``build_train_step(scaler=, nan_guard=True)`` on both packages over the
  same batches, one of them poisoned (its loss term is ``inf``): the same
  parameters and optimizer state after every step (fp32, 1e-6 relative to
  each tensor's largest entry plus 1e-7), and the same counters from
  ``sync()`` (exact). In the port the poisoned step leaves parameters,
  moments and ``beta*_pow`` bitwise as they were.
- ``microbatch=2``: against the reference's (the same tolerance), and
  bitwise equal to two ``microbatch=1`` calls; a ``FlatFusedUpdate`` under
  all three options bitwise equal to the per-parameter AdamW (its update is
  the same elementwise ops on one buffer).
- The eager ``Adam`` / ``AdamW`` ``step()`` (with a decay filter) and
  ``GradScaler.minimize`` against the reference's on a ``Linear``: 1e-6.
- ``NanGuard``: the reference's counters, warnings and abort.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.engine import build_train_step as jax_build_train_step
from paddle_tpu.resilience import NanGuard as JaxNanGuard
from paddle_tpu.resilience import NanStepError as JaxNanStepError

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.engine import build_train_step
from paddle_tpu_torch.resilience import NanGuard, NanStepError

REL = 1e-6


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max() + 1e-7, (what, err)


# ---------------------------------------------------------------------------
# GradScaler
# ---------------------------------------------------------------------------

def test_grad_scaler_policy_and_state_dict_match_reference():
    kw = dict(init_loss_scaling=2.0 ** 4, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2)
    ref, port = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    # good x3 (doubles), bad x2 (halves), mark_found_inf x9 (halves to
    # the floor of 1.0 and stays), good x4
    events = ['good'] * 3 + ['bad'] * 2 + ['mark'] * 9 + ['good'] * 4
    for i, ev in enumerate(events):
        for s in (ref, port):
            if ev == 'mark':
                s.mark_found_inf()
            else:
                s._found_inf = ev == 'bad'
                s.update()
        assert port.state_dict() == ref.state_dict(), i
    assert port.get_loss_scaling() == 2.0
    fresh = tamp.GradScaler()
    fresh.load_state_dict(port.state_dict())
    assert fresh.state_dict() == port.state_dict()
    off = tamp.GradScaler(enable=False)
    assert not off.is_enable() and off.get_loss_scaling() == 1.0
    loss = torch.tensor(3.0)
    assert off.scale(loss) is loss
    assert float(tamp.GradScaler(init_loss_scaling=8.0).scale(loss)) == 24.0


# ---------------------------------------------------------------------------
# build_train_step with the scaler, the guard and microbatches
# ---------------------------------------------------------------------------

def _problem(seed=0, n=8, poison_at=2, steps=5):
    rs = np.random.RandomState(seed)
    params = {'w': rs.randn(4, 3).astype(np.float32),
              'b': rs.randn(3).astype(np.float32)}
    batches = []
    for i in range(steps):
        poison = np.float32(np.inf if i == poison_at else 1.0)
        batches.append((rs.randn(n, 4).astype(np.float32),
                        rs.randn(n, 3).astype(np.float32), poison))
    return params, batches


def _jax_loss(p, buffers, batch, key):
    x, y, poison = batch
    pred = x @ p['w'] + p['b']
    return jnp.mean((pred - y) ** 2) * poison, (pred,), buffers


def _port_loss(p, batch):
    x, y, poison = batch
    pred = x @ p['w'] + p['b']
    return ((pred - y) ** 2).mean() * poison, (pred,)


SCALER = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)


def _run_reference(params, batches, k=1):
    opt = jopt.AdamW(learning_rate=0.05, weight_decay=0.1)
    scaler, guard = jamp.GradScaler(**SCALER), JaxNanGuard(verbose=False)
    step = jax_build_train_step(_jax_loss, opt, scaler=scaler,
                                nan_guard=True, microbatch=k)
    state = step.init_state({n: jnp.asarray(v) for n, v in params.items()})
    history = []
    for batch in batches:
        state, _ = step(state, tuple(jnp.asarray(a) for a in batch))
        synced = step.sync(state, nan_guard=guard, scaler=scaler)
        history.append(({n: np.asarray(v) for n, v in
                         state['params'].items()},
                        {n: {s: np.asarray(v) for s, v in st.items()}
                         for n, st in state['opt'].items()}, synced))
    return history


def _port_step(params, k=1, flat=False):
    leaves = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for n, v in params.items()}
    opt = topt.AdamW(learning_rate=0.05, weight_decay=0.1)
    if flat:
        opt = topt.FlatFusedUpdate(opt, leaves)
    step = build_train_step(_port_loss, opt, params=leaves,
                            scaler=tamp.GradScaler(**SCALER),
                            nan_guard=True, microbatch=k, device='cpu')
    return step, leaves


def _port_slots(step, state):
    if step._flat is None:
        return state['opt']
    views = step._flat.unflatten
    st = state['opt']
    m1, m2 = views(st['moment1']), views(st['moment2'])
    return {n: {'moment1': m1[n], 'moment2': m2[n],
                'beta1_pow': st['beta1_pow'], 'beta2_pow': st['beta2_pow']}
            for n in m1}


def test_scaler_and_guard_steps_match_reference_and_skip_bitwise():
    params, batches = _problem()
    ref = _run_reference(params, batches)
    step, leaves = _port_step(params)
    state = step.init_state()
    guard = NanGuard(verbose=False)
    for i, batch in enumerate(batches):
        before = {n: p.detach().clone() for n, p in leaves.items()}
        slots = {n: {s: v.clone() for s, v in st.items()}
                 for n, st in state['opt'].items()}
        state, result = step(state, tuple(torch.from_numpy(np.asarray(a))
                                          for a in batch))
        synced = step.sync(state, nan_guard=guard, scaler=step.scaler)
        rp, ropt, rsync = ref[i]
        assert synced == rsync, i
        if i == 2:
            # the poisoned step: not finite, and nothing moved, bit for bit
            assert not np.isfinite(float(result.loss))
            for n, p in leaves.items():
                assert torch.equal(p.detach(), before[n])
                for s, v in state['opt'][n].items():
                    assert torch.equal(v, slots[n][s]), (n, s)
        for n in params:
            _close(leaves[n], rp[n], f'step {i} {n}')
            for s in ('moment1', 'moment2', 'beta1_pow', 'beta2_pow'):
                _close(state['opt'][n][s], ropt[n][s], f'step {i} {n}.{s}')
    assert guard.state_dict() == {'skipped_steps': 1, 'consecutive_skips': 0,
                                  'total_steps': 5}
    assert step.scaler.state_dict() == rsync['scaler']


def test_microbatch_matches_reference_and_two_single_steps():
    params, batches = _problem(seed=1, poison_at=-1, steps=4)
    stacked = [tuple(np.stack([a, b]) for a, b in zip(batches[i],
                                                      batches[i + 1]))
               for i in (0, 2)]
    ref = _run_reference(params, stacked, k=2)
    runs = {}
    for flat in (False, True):
        for k in (1, 2):
            step, leaves = _port_step(params, k=k, flat=flat)
            state = step.init_state()
            feed = batches if k == 1 else stacked
            for batch in feed:
                state, result = step(state, tuple(
                    torch.from_numpy(np.asarray(a)) for a in batch))
            runs[flat, k] = (leaves, _port_slots(step, state),
                             step.sync(state), result)
    leaves, slots, synced, result = runs[False, 2]
    assert tuple(result.losses.shape) == (2,) and result.outputs is None
    rp, ropt, rsync = ref[-1]
    assert synced == rsync
    for n in params:
        _close(leaves[n], rp[n], n)
        _close(slots[n]['moment2'], ropt[n]['moment2'], n)
    # k = 2 is two k = 1 steps, and the flat update the per-parameter one,
    # bit for bit
    for key in ((False, 1), (True, 1), (True, 2)):
        other, oslots, osync, _ = runs[key]
        assert osync == synced, key
        for n in params:
            assert torch.equal(other[n].detach(), leaves[n].detach()), key
            for s in ('moment1', 'moment2', 'beta1_pow', 'beta2_pow'):
                assert torch.equal(oslots[n][s], slots[n][s]), (key, s)


def test_flat_update_skips_bitwise_under_the_scaler():
    params, batches = _problem(seed=2)
    step, leaves = _port_step(params, flat=True)
    state = step.init_state()
    for i, batch in enumerate(batches):
        master = state['params'].clone()
        opt = {s: v.clone() for s, v in state['opt'].items()}
        state, _ = step(state, tuple(torch.from_numpy(np.asarray(a))
                                     for a in batch))
        moved = not torch.equal(master, state['params'])
        assert moved == (i != 2)
        if i == 2:
            for s, v in state['opt'].items():
                assert torch.equal(v, opt[s]), s
    # the parameters are views of the master buffer
    for n, p in leaves.items():
        assert p.data_ptr() == state['params'][
            step._flat.offsets[n]:].data_ptr()


# ---------------------------------------------------------------------------
# the eager optimizer API
# ---------------------------------------------------------------------------

def _linears(seed=3):
    rs = np.random.RandomState(seed)
    w, b = rs.randn(4, 3).astype(np.float32), rs.randn(3).astype(np.float32)
    ref = paddle.nn.Linear(4, 3)
    ref.weight.set_value(w)
    ref.bias.set_value(b)
    port = tnn.Linear(4, 3, device='cpu')
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(w.T.copy()))
        port.bias.copy_(torch.from_numpy(b))
    x = rs.randn(8, 4).astype(np.float32)
    y = rs.randn(8, 3).astype(np.float32)
    return ref, port, x, y


def _ref_loss(ref, x, y):
    d = ref(paddle.to_tensor(x)) - paddle.to_tensor(y)
    return (d * d).mean()


def _port_loss_of(port, x, y):
    d = port(torch.from_numpy(x)) - torch.from_numpy(y)
    return (d * d).mean()


@pytest.mark.parametrize("kind", ['adam', 'adamw', 'adamw_filter'])
def test_eager_step_matches_reference(kind):
    ref, port, x, y = _linears()
    if kind == 'adam':
        ropt = jopt.Adam(learning_rate=0.05, parameters=ref.parameters(),
                         weight_decay=0.01)
        popt = topt.Adam(learning_rate=0.05, weight_decay=0.01,
                         parameters=port.named_parameters())
    else:
        keep = kind == 'adamw_filter'
        rname = ref.weight.name
        ropt = jopt.AdamW(learning_rate=0.05, parameters=ref.parameters(),
                          weight_decay=0.1, apply_decay_param_fun=(
                              (lambda n: n == rname) if keep else None))
        popt = topt.AdamW(learning_rate=0.05, weight_decay=0.1,
                          parameters=port.named_parameters(),
                          apply_decay_param_fun=(
                              (lambda n: n == 'weight') if keep else None))
    for _ in range(3):
        _ref_loss(ref, x, y).backward()
        ropt.step()
        ropt.clear_grad()
        _port_loss_of(port, x, y).backward()
        popt.step()
        popt.clear_grad()
        assert port.weight.grad is None
    _close(port.weight.detach().T, np.asarray(ref.weight._value), 'weight')
    _close(port.bias, np.asarray(ref.bias._value), 'bias')
    assert popt._global_step == 3
    st = popt._accumulators['weight']
    assert st['beta1_pow'].dtype == torch.float32
    assert st['beta1_pow'].dim() == 0
    with pytest.raises(ValueError, match='without parameters'):
        topt.Adam().step()


def test_grad_scaler_minimize_matches_reference():
    ref, port, x, y = _linears(seed=4)
    ropt = jopt.Adam(learning_rate=0.05, parameters=ref.parameters())
    popt = topt.Adam(learning_rate=0.05, parameters=port.parameters())
    rs, ps = jamp.GradScaler(init_loss_scaling=2.0 ** 12), \
        tamp.GradScaler(init_loss_scaling=2.0 ** 12)
    for _ in range(2):
        rs.minimize(ropt, rs.scale(_ref_loss(ref, x, y)))
        ps.minimize(popt, ps.scale(_port_loss_of(port, x, y)))
    _close(port.weight.detach().T, np.asarray(ref.weight._value), 'weight')
    assert ps.state_dict() == rs.state_dict()
    # a non-finite gradient: no step, and the bad step counted
    before = port.weight.detach().clone()
    ps.minimize(popt, ps.scale(_port_loss_of(port, x, y) * float('inf')))
    assert torch.equal(port.weight.detach(), before)
    assert ps.state_dict()['bad'] == 1 and port.weight.grad is None


# ---------------------------------------------------------------------------
# NanGuard
# ---------------------------------------------------------------------------

def test_nan_guard_counts_warns_and_aborts_as_the_reference():
    losses = [1.0, float('nan'), 2.0, float('inf'), float('inf')]
    rs, ps = jamp.GradScaler(), tamp.GradScaler()
    ref = JaxNanGuard(max_consecutive_skips=3, scaler=rs)
    port = NanGuard(max_consecutive_skips=3).attach_scaler(ps)
    for v in losses:
        with warnings.catch_warnings(record=True) as rw:
            warnings.simplefilter('always')
            rskip = ref.check(np.float32(v))
        with warnings.catch_warnings(record=True) as pw:
            warnings.simplefilter('always')
            pskip = port.check(torch.tensor(v))
        assert rskip == pskip and len(rw) == len(pw)
        assert port.state_dict() == ref.state_dict()
    assert ps.state_dict() == rs.state_dict()
    with pytest.raises(JaxNanStepError):
        ref.check(np.float32('nan'))
    with pytest.raises(NanStepError, match='3 consecutive'):
        port.check(torch.tensor(float('nan')))
    # the device counters: new skips warn and reach the scaler; a streak at
    # the limit seen only as the peak still aborts
    g = NanGuard(max_consecutive_skips=4, scaler=tamp.GradScaler())
    with pytest.warns(UserWarning, match='2 non-finite'):
        assert g.absorb_device_counts(10, 2, 0) == 2
    assert g._scaler.state_dict()['bad'] == 0      # decr_every 2: halved
    assert g._scaler.get_loss_scaling() == 2.0 ** 14
    with pytest.raises(NanStepError):
        g.absorb_device_counts(20, 6, 0, peak_consecutive=4)
    g2 = NanGuard()
    g2.load_state_dict(g.state_dict())
    assert g2.state_dict() == g.state_dict()
