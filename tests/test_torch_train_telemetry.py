"""The training side's telemetry, the port's against the reference's, on
the CPU.

One scenario runs through ``paddle_tpu.engine.fit`` and
``paddle_tpu_torch.engine.fit`` with telemetry on, on the same weights
(``interop``): a 2-layer narrow BERT, Lamb with the global-norm clip, the
NaN guard, ``microbatch=2``, the data from each package's ``DataLoader``
with sample 5 poisoned (quarantined, which leaves a one-sample batch that
the microbatch grouping drops) and sample 0's extra label NaN (a guard
skip). A first ``fit`` of one epoch saves once, synchronously; a second
resumes from it and runs the second epoch with an async save. Both give
the same counters, the same metric names, the same histogram counts, the
same event kinds in the same order (less ``checkpoint.fence``, which
either side emits only when its async save is still running at the
fence) and losses within ``engine.fit``'s parity tolerance (1e-5
relative). The port's run with telemetry off ends on bitwise the same
losses and parameters, through the same kernel wrappers.

Then each smaller site against the reference's: the eager optimizer
step's timer, a retry, the eager guard's skip and abort (the abort's
flight dump), a failing async save, a watchdog timeout's flight dump.

Each package's telemetry is process-wide: every test resets both and
fails if it leaves a thread (``_torch_spines``). The reference's fits
share a module-local XLA compilation cache, so its second step (and the
cost capture's AOT compile of each) reads the first's executable.
"""
import importlib
import json
import os
import queue
import time

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import engine as r_engine
from paddle_tpu import io as r_io
from paddle_tpu import optimizer as r_opt
from paddle_tpu import resilience as r_res
from paddle_tpu.nn import clip as r_clip
from paddle_tpu.nn.layer_base import param_values
from paddle_tpu.text.bert import BertConfig as RBertConfig
from paddle_tpu.text.bert import BertForPretraining as RBertForPretraining

from paddle_tpu_torch import engine as t_engine
from paddle_tpu_torch import io as t_io
from paddle_tpu_torch import optimizer as t_opt
from paddle_tpu_torch import resilience as t_res
from paddle_tpu_torch.interop import load_paddle_tpu_state
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.text.bert import BertConfig, BertForPretraining

from _torch_spines import (SIDES, clean_spines, names, r_obs,  # noqa: F401
                           reset_spines, t_obs, tallies)

SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=128, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)
SEQ, N_SAMPLES, POISONED = 64, 10, 5
LOSS_RTOL = 1e-5          # engine.fit's parity tolerance (test_torch_fit)
# either side emits it only when the async save is still running at the
# fence: a matter of timing, not of the code
TIMING_EVENTS = ('checkpoint.fence',)


def _samples():
    """10 samples of positional feeds (ids, token types, an all-ones
    mask, masked positions) and labels (MLM ids, NSP label, and a flag
    the loss adds: NaN for sample 0, else 0)."""
    rs = np.random.RandomState(0)
    k = SEQ * 15 // 100
    out = []
    for i in range(N_SAMPLES):
        x = (rs.randint(0, 512, (SEQ,)).astype(np.int32),
             np.zeros(SEQ, np.int32), np.ones(SEQ, np.int32),
             rs.choice(SEQ, k, replace=False).astype(np.int32))
        y = (rs.randint(0, 512, (k,)).astype(np.int32),
             rs.randint(0, 2, (1,)).astype(np.int32),
             np.full((1,), np.nan if i == 0 else 0.0, np.float32))
        out.append((x, y))
    return out


class _Poisoned:
    """The samples, with ``dataset[POISONED]`` raising."""

    def __init__(self):
        self.samples = _samples()

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        if i == POISONED:
            raise ValueError(f'poisoned sample {i}')
        return self.samples[i]


def _scenario(fit, net, opt, loader, guard, root, **kw):
    """The two fits: one epoch with a sync save, then the second epoch
    resumed from it with an async save -> (reports)."""
    def loss(*a):
        return net.pretraining_loss(*a[:-1]) + a[-1].sum()
    first = fit(net, loss, opt, loader, epochs=1, microbatch=2, log_every=1,
                nan_guard=guard(), prefetch=0,
                checkpoint=os.path.join(root, 'sync'), async_save=False,
                **kw)
    second = fit(net, loss, opt, loader, epochs=2, microbatch=2,
                 log_every=1, nan_guard=guard(), prefetch=0,
                 checkpoint=os.path.join(root, 'async'),
                 resume_from=os.path.join(root, 'sync'), async_save=True,
                 **kw)
    return [first, second]


def _kinds(obs):
    return [e['ev'] for e in obs.event_log() if e['ev'] not in TIMING_EVENTS]


@pytest.fixture(scope='module')
def xla_cache(tmp_path_factory):
    jax.config.update('jax_compilation_cache_dir',
                      str(tmp_path_factory.mktemp('xla_cache')))
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.0)
    yield
    jax.config.update('jax_compilation_cache_dir', None)


@pytest.fixture(scope='module')
def reference_run(xla_cache, tmp_path_factory):
    """The reference's two fits with telemetry on -> (initial weights,
    snapshot, event kinds, reports)."""
    reset_spines()
    try:
        r_obs.enable(log_dir=str(tmp_path_factory.mktemp('r_log')))
        paddle.seed(1)
        net = RBertForPretraining(RBertConfig(**SMALL))
        for key, p in net.named_parameters():
            p.name = key      # unique slot names (ROADMAP.md, Queue 3)
        init = {k: np.asarray(v) for k, v in
                param_values(net, trainable_only=False).items()}
        opt = r_opt.Lamb(learning_rate=1e-3, lamb_weight_decay=0.01,
                         epsilon=1e-4,
                         grad_clip=r_clip.ClipGradByGlobalNorm(1.0))
        loader = r_io.DataLoader(_Poisoned(), batch_size=2,
                                 skip_bad_samples=3)
        with pytest.warns(RuntimeWarning):
            reports = _scenario(r_engine.fit, net, opt, loader,
                                r_res.NanGuard,
                                str(tmp_path_factory.mktemp('r_ckpt')))
        return init, r_obs.snapshot(), _kinds(r_obs), reports
    finally:
        reset_spines()


def _port_run(init, root, telemetry):
    """The port's two fits on ``init`` -> (snapshot, event kinds, reports,
    final parameters, kernel wrapper calls)."""
    if telemetry:
        t_obs.enable(log_dir=os.path.join(root, 'log'))
    calls = {}
    listener = (lambda kernel, flops, nbytes:
                calls.__setitem__(kernel, calls.get(kernel, 0) + 1))
    net = BertForPretraining(BertConfig(**SMALL), device='cpu')
    load_paddle_tpu_state(net, init)
    opt = t_opt.Lamb(learning_rate=1e-3, lamb_weight_decay=0.01,
                     epsilon=1e-4, grad_clip=ClipGradByGlobalNorm(1.0))
    loader = t_io.DataLoader(_Poisoned(), batch_size=2, skip_bad_samples=3,
                             device='cpu')
    _build.work_listeners.append(listener)
    try:
        with pytest.warns(RuntimeWarning):
            reports = _scenario(t_engine.fit, net, opt, loader,
                                t_res.NanGuard, root, device='cpu')
    finally:
        _build.work_listeners.remove(listener)
    params = {k: v.detach().clone() for k, v in net.state_dict().items()}
    return t_obs.snapshot(), _kinds(t_obs), reports, params, calls


def test_fit_telemetry_matches_reference(reference_run, tmp_path):
    init, r_snap, r_kinds, r_reports = reference_run
    snap, kinds, reports, _, _ = _port_run(init, str(tmp_path), True)
    assert names(snap) == names(r_snap)
    assert tallies(snap) == tallies(r_snap)
    counters = tallies(snap)[0]
    for name, want in (('engine.steps', 8), ('engine.dispatches', 4),
                       ('checkpoint.saves', 2), ('checkpoint.restores', 1),
                       ('dataloader.batches', 10),
                       ('dataloader.quarantined', 2),
                       ('engine.dropped_batches', 2),
                       ('nan_guard.skips', 3)):
        assert counters[name] == want, name
    assert kinds == r_kinds
    assert kinds == ['quarantine', 'cost.program', 'nan_guard.skip',
                     'checkpoint.save', 'checkpoint.restore', 'quarantine',
                     'cost.program', 'nan_guard.skip', 'checkpoint.save']
    saves = [e for e in t_obs.event_log() if e['ev'] == 'checkpoint.save']
    assert [e['async_'] for e in saves] == [False, True]
    for got, want in zip(reports, r_reports):
        for key in ('steps', 'dispatches', 'checkpoints', 'resumed_from'):
            assert got[key] == want[key], key
        np.testing.assert_allclose(got['loss'], want['loss'],
                                   rtol=LOSS_RTOL)


def test_fit_with_telemetry_equals_fit_without(reference_run, tmp_path):
    """Telemetry changes nothing the step computes: the same kernel wrapper
    calls, bitwise the same losses and parameters."""
    init = reference_run[0]
    on = _port_run(init, str(tmp_path / 'on'), True)
    reset_spines()
    off = _port_run(init, str(tmp_path / 'off'), False)
    assert off[0] == {'counters': {}, 'gauges': {}, 'histograms': {}}
    assert on[4] == off[4] and on[4]['flash_attention_fwd'] == 2 * 2 * 4
    assert [r['loss'] for r in on[2]] == [r['loss'] for r in off[2]]
    assert all(torch.equal(on[3][k], off[3][k]) for k in off[3])


# -- the smaller sites --------------------------------------------------------

def _optimizer_step(side, tmp_path):
    if side is r_obs:
        lin = paddle.nn.Linear(3, 2)
        opt = r_opt.SGD(learning_rate=0.1, parameters=lin.parameters())
        lin(paddle.to_tensor(np.ones((1, 3), np.float32))).sum().backward()
    else:
        lin = torch.nn.Linear(3, 2)
        opt = t_opt.SGD(learning_rate=0.1, parameters=lin.parameters())
        lin(torch.ones(1, 3)).sum().backward()
    opt.step()
    opt.step()


def _module(side, name):
    pkg = 'paddle_tpu' if side is r_obs else 'paddle_tpu_torch'
    return importlib.import_module(f'{pkg}.resilience.{name}')


def _retry(side, tmp_path):
    mod = _module(side, 'retry')
    mod._sleep = lambda s: None
    tries = []

    @mod.retry(max_attempts=3, backoff=0.0, jitter=0.0)
    def flaky():
        tries.append(1)
        if len(tries) < 3:
            raise OSError('transient')
        return 'ok'
    try:
        assert flaky() == 'ok'
    finally:
        mod._sleep = time.sleep


def _guard(side, tmp_path):
    res = r_res if side is r_obs else t_res
    guard = res.NanGuard(max_consecutive_skips=2, verbose=False)
    assert not guard.check(1.0)
    assert guard.check(float('nan'))
    with pytest.raises(res.NanStepError):
        guard.check(float('inf'))


def _async_error(side, tmp_path):
    saver = _module(side, 'async_checkpoint').AsyncSaver()

    def job(should_abort):
        raise OSError('disk full')
    saver.submit(job)
    with pytest.raises(OSError, match='disk full'):
        saver.fence()


def _watchdog(side, tmp_path):
    mod = _module(side, 'watchdog')
    # the next timeout dumps, whatever an earlier one in the process did
    mod._last_flight_dump[0] = None if side is t_obs else -1e9
    with pytest.raises(mod.WatchdogTimeout):
        mod.bounded_get(queue.Queue(), timeout=0.05, tick=0.01,
                        what='nothing')


@pytest.mark.parametrize('site', [_optimizer_step, _retry, _guard,
                                  _async_error, _watchdog],
                         ids=lambda f: f.__name__.strip('_'))
def test_training_site_matches_reference(site, tmp_path, monkeypatch):
    """The same metric names, counts and event kinds; where the site dumps
    the flight recorder, a dump with the same reason, in its own file."""
    got = []
    for side in SIDES:
        d = tmp_path / side.__name__.split('.')[0]
        monkeypatch.setenv('PADDLE_TPU_FLIGHT_DIR', str(d))
        side.enable(log_dir=str(d))
        site(side, d)
        dumps = {}
        for name in sorted(os.listdir(d)) if d.exists() else ():
            if name.startswith('flight_rank') and name.endswith('.json'):
                with open(d / name) as f:
                    doc = json.load(f)
                dumps[name] = (doc['reason'], sorted(doc['counters']) != [],
                               'costs' in doc)
        got.append((names(side.snapshot()), tallies(side.snapshot()),
                    [e['ev'] for e in side.event_log()],
                    [r['ev'] for r in side.flight.records()], dumps))
        side.disable()
    ref, port = got
    assert port == ref
    if site is _optimizer_step:
        assert 'optimizer.step_ms' in port[0]['histograms']
        assert port[1][1]['optimizer.step_ms'] == 2
    if site in (_guard, _watchdog):
        assert port[4] and all(v[2] for v in port[4].values())
