"""The port's learning-rate schedulers (``paddle_tpu_torch.optimizer.lr``)
against the JAX package's (``paddle_tpu.optimizer.lr``): every scheduler's
learning rate over 30 steps within 1e-12 relative (both are Python float
arithmetic), ``state_dict`` round trips within the port and across the
packages (``interop.load_paddle_tpu_scheduler_state``), the fluid-era
aliases, and an optimizer that reads its scheduler at every call."""
import math

import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as jax_lr

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.interop import (load_paddle_tpu_scheduler_state,
                                      to_paddle_tpu_scheduler_state)
from paddle_tpu_torch.optimizer import lr as torch_lr

STEPS = 30


def _cases(lr):
    """(id, factory) pairs: ``factory(lr_module)`` builds the scheduler."""
    return [
        ('noam', lambda m: m.NoamDecay(512, 8, learning_rate=2.0)),
        ('piecewise', lambda m: m.PiecewiseDecay([5, 12, 20],
                                                 [0.1, 0.05, 0.01, 0.001])),
        ('natural_exp', lambda m: m.NaturalExpDecay(0.5, 0.1)),
        ('inverse_time', lambda m: m.InverseTimeDecay(0.5, 0.3)),
        ('polynomial', lambda m: m.PolynomialDecay(0.5, 12, 0.01, 2.0)),
        ('polynomial_cycle', lambda m: m.PolynomialDecay(
            0.5, 7, 0.01, 1.5, cycle=True)),
        ('warmup_float', lambda m: m.LinearWarmup(0.3, 6, 0.01, 0.3)),
        ('warmup_scheduler', lambda m: m.LinearWarmup(
            m.PolynomialDecay(0.3, 15, 0.0, 1.0), 5, 0.0, 0.3)),
        ('exponential', lambda m: m.ExponentialDecay(0.5, 0.9)),
        ('multistep', lambda m: m.MultiStepDecay(0.5, [3, 9, 21], 0.3)),
        ('step', lambda m: m.StepDecay(0.5, 4, 0.7)),
        ('lambda', lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e
                                           + 0.01 * (e % 3))),
        ('cosine', lambda m: m.CosineAnnealingDecay(0.5, 11, 0.02)),
    ]


CASES = _cases(None)
# a plateau, an improvement and a long plateau: both threshold modes and
# both directions see a reduction and a cooldown
METRICS = [5.0, 4.0, 4.0, 3.99999, 4.1, 4.2, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0,
           2.9, 2.9, 2.9, 2.9, 2.9, 2.9, 2.9, 2.5, 2.5, 2.5, 2.5, 2.5, 2.5,
           2.5, 2.5, 2.5, 2.5, 2.5]


def _trace(sched):
    out = [sched()]
    for _ in range(STEPS):
        sched.step()
        out.append(sched())
    return out


def _close(got, want):
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-12 * max(abs(w), 1e-300), (got, want)


@pytest.mark.parametrize("make", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_scheduler_matches_reference(make):
    got, want = _trace(make(torch_lr)), _trace(make(jax_lr))
    assert len(got) == STEPS + 1
    _close(got, want)


@pytest.mark.parametrize("mode,threshold_mode", [
    ('min', 'rel'), ('min', 'abs'), ('max', 'rel'), ('max', 'abs')])
def test_reduce_on_plateau_matches_reference(mode, threshold_mode):
    # max mode sees 10 - m: positive, rising where m falls
    value = (lambda m: m) if mode == 'min' else (lambda m: 10.0 - m)
    kw = dict(mode=mode, factor=0.5, patience=2, threshold=1e-3,
              threshold_mode=threshold_mode, cooldown=1, min_lr=0.01)
    got_s = torch_lr.ReduceOnPlateau(0.4, **kw)
    want_s = jax_lr.ReduceOnPlateau(0.4, **kw)
    got, want = [], []
    for m in METRICS:
        # the port reads a tensor metric with float(), like a number
        got_s.step(torch.tensor(value(m), dtype=torch.float64))
        want_s.step(value(m))
        got.append(got_s())
        want.append(want_s())
    got_s.step(None)          # no metric: nothing changes
    assert got_s() == got[-1]
    assert len(set(got)) > 2          # reduced at least twice
    _close(got, want)
    assert got_s.state_dict() == pytest.approx(want_s.state_dict())


@pytest.mark.parametrize("make", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_state_dict_round_trips(make):
    sched = make(torch_lr)
    for _ in range(7):
        sched.step()
    saved = sched.state_dict()
    assert saved == sched.state_keys()
    fresh = make(torch_lr)
    fresh.set_dict(saved)
    _close(_trace(fresh), _trace(sched))
    # across the packages: the reference picks up where the port left off
    ref = make(jax_lr)
    ref.set_state_dict(to_paddle_tpu_scheduler_state(make(torch_lr)))
    other = make(torch_lr)
    for _ in range(3):
        other.step()
    ref.set_state_dict(to_paddle_tpu_scheduler_state(other))
    back = make(torch_lr)
    load_paddle_tpu_scheduler_state(back, ref.state_dict())
    _close(_trace(back), _trace(ref))


def test_scheduler_state_keys_checked():
    with pytest.raises(ValueError, match='keys'):
        load_paddle_tpu_scheduler_state(torch_lr.StepDecay(0.1, 2),
                                        {'last_epoch': 3})


def test_fluid_aliases_and_module_path():
    pairs = {'NoamLR': 'NoamDecay', 'PiecewiseLR': 'PiecewiseDecay',
             'NaturalExpLR': 'NaturalExpDecay',
             'InverseTimeLR': 'InverseTimeDecay',
             'PolynomialLR': 'PolynomialDecay',
             'LinearLrWarmup': 'LinearWarmup',
             'ExponentialLR': 'ExponentialDecay',
             'MultiStepLR': 'MultiStepDecay', 'StepLR': 'StepDecay',
             'LambdaLR': 'LambdaDecay',
             'ReduceLROnPlateau': 'ReduceOnPlateau',
             'CosineAnnealingLR': 'CosineAnnealingDecay'}
    for alias, name in pairs.items():
        assert getattr(topt, alias) is getattr(torch_lr, name)
    from paddle_tpu_torch.optimizer import lr_scheduler
    assert lr_scheduler._LRScheduler is torch_lr.LRScheduler
    assert set(jax_lr.__all__) <= set(torch_lr.__all__)


def test_optimizer_reads_its_scheduler_at_every_call():
    sched = torch_lr.StepDecay(0.5, step_size=1, gamma=0.5)
    opt = topt.SGD(learning_rate=sched)
    p = {'w': torch.zeros(3)}
    st = opt.init_state_values(p)
    moved = []
    for _ in range(3):
        before = p['w'].clone()
        opt.functional_update(p, {'w': torch.ones(3)}, st)
        moved.append(float((before - p['w'])[0]))
        sched.step()
    assert moved == [0.5, 0.25, 0.125]
    assert opt.get_lr() == 0.0625
    with pytest.raises(RuntimeError, match='LRScheduler'):
        opt.set_lr(0.1)
    sd = opt.state_dict()
    assert sd['LR_Scheduler']['last_epoch'] == 3
    opt2 = topt.SGD(learning_rate=torch_lr.StepDecay(0.5, 1, 0.5))
    opt2.set_state_dict(sd)
    assert opt2.get_lr() == 0.0625
    assert math.isclose(topt.SGD(learning_rate=0.2).get_lr(), 0.2)
    assert np.isfinite(opt.get_lr())


def test_reference_fault_compiled_step_freezes_its_scheduler():
    """The reference reads ``get_lr()`` as a Python float inside the jitted
    step, so the learning rate is traced once and ``scheduler.step()``
    changes nothing afterwards (ROADMAP.md, Queue 3). The port reads it at
    every call."""
    import jax.numpy as jnp
    from paddle_tpu import optimizer as jax_opt
    from paddle_tpu.engine import build_train_step as jax_build_train_step
    from paddle_tpu_torch.engine import build_train_step

    def jax_loss(p, buffers, x, key):
        return jnp.sum(p['w'] * x), (), buffers

    def port_loss(p, x):
        return (p['w'] * x).sum()
    moved = {}
    for side in ('reference', 'port'):
        lr_mod = jax_lr if side == 'reference' else torch_lr
        sched = lr_mod.StepDecay(0.5, step_size=1, gamma=0.5)
        if side == 'reference':
            step = jax_build_train_step(jax_loss,
                                        jax_opt.SGD(learning_rate=sched))
            state = step.init_state({'w': jnp.zeros(3)})
            feed = jnp.ones(3)
        else:
            w = torch.nn.Parameter(torch.zeros(3))
            step = build_train_step(port_loss, topt.SGD(learning_rate=sched),
                                    params={'w': w}, device='cpu')
            state = step.init_state()
            feed = torch.ones(3)
        def now():
            w = state['params']['w']
            return np.array(w.detach() if side == 'port' else w)
        out = []
        for _ in range(3):
            before = now()
            state, _ = step(state, feed)
            out.append(float((before - now())[0]))
            sched.step()
        moved[side] = out
    assert moved['reference'] == [0.5, 0.5, 0.5]        # frozen at 0.5
    assert moved['port'] == [0.5, 0.25, 0.125]
