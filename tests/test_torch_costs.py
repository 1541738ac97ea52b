"""The cost explorer (``observability.costs``), the port's against the
reference's, on the CPU.

- ``record_costs``, ``mark_hit``, ``entry``, ``ledger``, ``summary`` and
  ``roofline`` on the same raw numbers, with the peaks and the memory
  budget given by their env knobs, equal the reference's (entries less
  their capture timestamp), and so do the gauges and ``cost.program``
  events they leave.
- The port's defaults: the H100's peaks for ``'gpu'`` (989e12 FLOP/s,
  3.35e12 B/s), no budget on a CPU.
- ``capture`` counts the first dispatch of a train step: a 2-layer narrow
  BERT, one AdamW step (``microbatch=1``: XLA's ``cost_analysis`` counts
  a ``lax.scan`` body once), against the reference's XLA count of the
  same step. Two gaps pull apart: XLA counts elementwise work, which
  ``FlopCounterMode`` leaves out (the port lower), and the port counts the
  flash backward kernels' own work, which recomputes the scores (14
  operations a query-key pair and head dim where the plain autograd XLA
  differentiates does 8: the port higher). At this shape the total is
  within 2 % (0.986); the test holds it within 10 %, and the port's count
  less the recompute surplus below XLA's. Each kernel's share equals its
  formula on the step's shapes.
- ``capture`` runs the function once and returns its result; a hit runs
  it uncounted; a capture that cannot start emits ``cost.capture_error``
  and runs it anyway; the function's own exception propagates and leaves
  no listener or dispatch mode behind.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import engine as r_engine
from paddle_tpu import optimizer as r_opt
from paddle_tpu.text.bert import BertConfig as RBertConfig
from paddle_tpu.text.bert import BertForPretraining as RBertForPretraining

from paddle_tpu_torch import engine as t_engine
from paddle_tpu_torch import optimizer as t_opt
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.text.bert import BertConfig, BertForPretraining

from _torch_spines import SIDES, clean_spines, r_obs, t_obs  # noqa: F401

SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=128, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)
B, SEQ, HEADS = 2, 64, 4
XLA_TOL = 0.10


def _ledger_calls(costs):
    costs.record_costs('exec.p1', 4e9, 2e9, {'argument_bytes': 100,
                                             'output_bytes': 50,
                                             'temp_bytes': 25,
                                             'generated_code_bytes': 5},
                       kind='executor', meta={'fetch': 2})
    costs.record_costs('engine.train_step7', 9e12, 3e10,
                       {'argument_bytes': 6_000_000_000,
                        'output_bytes': 1_000,
                        'temp_bytes': 5_000_000_000}, kind='train_step')
    costs.record_costs('serve.b16', 1e6, 8e8, None, kind='serving')
    costs.mark_hit('exec.p1')
    costs.mark_hit('exec.p1')
    costs.mark_hit('absent')


def _strip(entry):
    return {k: v for k, v in entry.items() if k != 'captured_ts'}


def test_ledger_arithmetic_matches_reference(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_DEVICE_PEAK_FLOPS', '1e15')
    monkeypatch.setenv('PADDLE_TPU_DEVICE_PEAK_BPS', '2.5e12')
    monkeypatch.setenv('PADDLE_TPU_HBM_BUDGET', '16e9')
    got = []
    for obs in SIDES:
        assert obs.costs.record_costs('off', 1, 1) is None   # telemetry off
        obs.enable()
        _ledger_calls(obs.costs)
        events = [{k: v for k, v in e.items() if k != 'ts'}
                  for e in obs.event_log()]
        snap = obs.snapshot()
        got.append(([_strip(e) for e in obs.costs.ledger()],
                    _strip(obs.costs.entry('exec.p1')),
                    obs.costs.summary(),
                    [obs.costs.roofline(f, b) for f, b in
                     ((1e12, 1e9), (1e9, 1e12), (0.0, 0.0))],
                    obs.costs.device_peaks(), obs.costs.hbm_budget(),
                    events, snap['gauges'],
                    {k: v for k, v in snap['counters'].items()
                     if k.startswith('cost.')}))
        obs.costs.reset()
        assert obs.costs.ledger() == [] and obs.costs.entry('exec.p1') is None
    ref, port = got
    assert port == ref
    summary = port[2]
    assert summary['programs'] == 3 and summary['hits'] == 2
    assert summary['max_peak_program'] == 'engine.train_step7'
    assert summary['peak_budget_ratio'] == round(11_000_001_000 / 16e9, 4)


def test_port_defaults(monkeypatch):
    for knob in ('PADDLE_TPU_DEVICE_PEAK_FLOPS', 'PADDLE_TPU_DEVICE_PEAK_BPS',
                 'PADDLE_TPU_HBM_BUDGET'):
        monkeypatch.delenv(knob, raising=False)
    costs = t_obs.costs
    assert costs.device_peaks('gpu') == (989e12, 3.35e12)
    assert costs.device_peaks('cpu') == (2e11, 5e10)
    monkeypatch.setenv('PADDLE_TPU_HBM_BUDGET', '8e9')
    assert costs.hbm_budget() == 8_000_000_000
    if not torch.cuda.is_available():
        monkeypatch.setenv('PADDLE_TPU_HBM_BUDGET', 'not a number')
        assert costs.device_peaks() == (2e11, 5e10)
        assert costs.hbm_budget() is None


def _batch():
    rs = np.random.RandomState(0)
    k = SEQ * 15 // 100
    x = (rs.randint(0, 512, (B, SEQ)).astype(np.int32),
         np.zeros((B, SEQ), np.int32), np.ones((B, SEQ), np.int32),
         np.stack([rs.choice(SEQ, k, replace=False)
                   for _ in range(B)]).astype(np.int32))
    y = (rs.randint(0, 512, (B, k)).astype(np.int32),
         rs.randint(0, 2, (B, 1)).astype(np.int32))
    return x, y


@pytest.fixture
def xla_cache(tmp_path):
    """The reference's cost capture compiles its step once more, ahead
    of time: a compilation cache makes that a read of the first."""
    jax.config.update('jax_compilation_cache_dir', str(tmp_path))
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.0)
    yield
    jax.config.update('jax_compilation_cache_dir', None)


def test_captured_step_flops_against_xla(xla_cache):
    """One fit step each with telemetry on: the reference's ledger holds
    XLA's count, the port's the counted dispatch's."""
    batch = _batch()
    r_obs.enable()
    paddle.seed(1)
    ref = RBertForPretraining(RBertConfig(**SMALL))
    r_engine.fit(ref, ref.pretraining_loss,
                 r_opt.AdamW(learning_rate=1e-3,
                             parameters=ref.parameters()),
                 [batch], prefetch=0)
    (xla,) = r_obs.costs.ledger()
    t_obs.enable()
    # the counts depend on the shapes only, not on the weights
    net = BertForPretraining(BertConfig(**SMALL), device='cpu')
    t_engine.fit(net, net.pretraining_loss,
                 t_opt.AdamW(learning_rate=1e-3,
                             parameters=net.parameters()),
                 [batch], prefetch=0, device='cpu')
    (port,) = t_obs.costs.ledger()
    assert port['kind'] == xla['kind'] == 'train_step'
    assert port['meta']['microbatch'] == 1
    ratio = port['flops'] / xla['flops']
    assert abs(ratio - 1.0) <= XLA_TOL, ratio
    kernels = port['meta']['kernels']
    layers, d = SMALL['num_hidden_layers'], SMALL['hidden_size'] // HEADS
    pairs = B * HEADS * SEQ * SEQ * d
    for name, per in (('flash_attention_fwd', 4), ('flash_attention_dq', 6),
                      ('flash_attention_dkv', 8)):
        assert kernels[name] == {
            'calls': layers, 'flops': float(layers * per * pairs),
            'bytes': kernels[name]['bytes']}, name
    rows, width = B * SEQ, SMALL['hidden_size']
    assert kernels['add_layer_norm_fwd']['flops'] == 2 * layers * 9 * rows \
        * width
    # the embeddings' LayerNorm and the MLM head's (its masked rows)
    masked = B * (SEQ * 15 // 100)
    assert kernels['layer_norm_fwd']['flops'] == 8 * (rows + masked) * width
    surplus = 6 / 14 * (kernels['flash_attention_dq']['flops']
                        + kernels['flash_attention_dkv']['flops'])
    assert port['flops'] - surplus < xla['flops']
    assert port['flops'] == port['meta']['aten_flops'] + sum(
        k['flops'] for k in kernels.values())
    # the CPU measures no peak: arguments and new outputs only
    assert port['meta']['peak_measured'] is False
    assert port['temp_bytes'] == 0 and port['peak_bytes'] == \
        port['argument_bytes'] + port['output_bytes']
    assert port['bytes_accessed'] > port['argument_bytes']
    events = [e for e in t_obs.event_log() if e['ev'] == 'cost.program']
    assert len(events) == 1 and events[0]['flops'] == port['flops']


def test_capture_runs_once_and_never_fails_the_program(monkeypatch):
    costs = t_obs.costs
    calls = []

    def fn(x, scale):
        calls.append(x)
        return torch.mm(x, x) * scale
    x = torch.ones(4, 4)
    assert torch.equal(costs.capture('p', fn, x, 1.0), fn(x, 1.0))  # off
    assert costs.ledger() == []
    t_obs.enable()
    out = costs.capture('p', fn, x, 2.0, kind='k', meta={'a': 1})
    assert torch.equal(out, 2 * torch.mm(x, x)) and len(calls) == 3
    ent = costs.entry('p')
    assert ent['flops'] == 2 * 4 * 4 * 4 and ent['meta']['a'] == 1
    assert ent['argument_bytes'] == 64 and ent['output_bytes'] == 64
    costs.capture('p', fn, x, 1.0)                            # a hit
    assert costs.entry('p')['hits'] == 1 and len(calls) == 4

    def broken(*args, **kwargs):
        raise RuntimeError('no counters here')
    monkeypatch.setattr(costs, '_Count', broken)
    assert torch.equal(costs.capture('q', fn, x, 1.0), fn(x, 1.0))
    assert costs.entry('q') is None
    err = [e for e in t_obs.event_log() if e['ev'] == 'cost.capture_error']
    assert err and 'no counters here' in err[0]['error']
    monkeypatch.undo()

    def fails(x):
        raise ValueError('the program itself')
    with pytest.raises(ValueError, match='the program itself'):
        costs.capture('r', fails, x)
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    assert _build.work_listeners == [] and \
        _get_current_dispatch_mode() is None
    assert costs.entry('r') is None
