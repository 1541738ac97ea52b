"""The port's serving engine against the JAX package's, on the CPU.

The same small BERT (shared weights through ``interop``) is served by the
JAX ``serving.ServingEngine`` (``layer=``) and by the port's engine with
``device='cpu'``; responses are compared request by request at the fp32
model tolerance of ``test_torch_bert.py`` (1e-4). The rest covers the
engine's own contract — buckets and padding, shedding, deadlines, input
validation, the threaded path — and the package's isolation from JAX.
"""
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.serving import BucketSpec as JaxBucketSpec
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.text.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.bert import BertModel as JaxBertModel

from paddle_tpu_torch.interop import load_paddle_tpu_state
from paddle_tpu_torch.serving import (BucketSpec, QueueFullError,
                                      ServingEngine, WatchdogTimeout,
                                      pad_to_bucket, select_bucket)
from paddle_tpu_torch.text.bert import BertConfig, BertModel

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(vocab_size=100, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=64)
SEQ = 16
MODEL_TOL = 1e-4


class _JaxServeBert(paddle.nn.Layer):
    """Names the reference engine's feeds as its forward parameters. The
    reference engine binds feeds positionally in ``forward`` order, which
    would hand ``attention_mask`` to ``token_type_ids`` of ``BertModel``
    itself; the port binds by keyword (see
    ``test_layer_feeds_bind_by_keyword``)."""

    def __init__(self, bert):
        super().__init__()
        self.bert = bert

    def forward(self, input_ids, attention_mask):
        return self.bert(input_ids, attention_mask=attention_mask)


def _requests(n, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for length in rs.randint(1, SEQ + 1, size=n):
        ids = np.zeros(SEQ, np.int32)
        ids[:length] = rs.randint(1, SMALL['vocab_size'], size=length)
        mask = np.zeros(SEQ, np.int32)
        mask[:length] = 1
        out.append({'input_ids': ids, 'attention_mask': mask})
    return out


def _example():
    return {'input_ids': np.zeros(SEQ, np.int32),
            'attention_mask': np.zeros(SEQ, np.int32)}


def test_bert_served_by_both_engines_agrees():
    paddle.seed(11)
    ref = JaxBertModel(JaxBertConfig(**SMALL))
    port = BertModel(BertConfig(**SMALL), device='cpu')
    load_paddle_tpu_state(port, {k: np.asarray(v._value)
                                 for k, v in ref.state_dict().items()})
    buckets = (1, 2, 4)
    jeng = JaxServingEngine()
    jep = jeng.register('bert', layer=_JaxServeBert(ref), example=_example(),
                        bucket_spec=JaxBucketSpec(buckets))
    teng = ServingEngine(device='cpu')
    tep = teng.register('bert', layer=port, example=_example(),
                        bucket_spec=BucketSpec(buckets))
    reqs = _requests(7)
    at = 0
    for wave in (1, 2, 4):              # one batch per bucket on each side
        batch = reqs[at:at + wave]
        at += wave
        jf = [jep.submit(r) for r in batch]
        tf = [tep.submit(r) for r in batch]
        jeng.run_until_idle()
        teng.run_until_idle()
        for a, b in zip(jf, tf):
            ra, rb = a.result(30), b.result(30)
            assert ra.ok and rb.ok
            for x, y in zip(ra.outputs, rb.outputs):
                assert y.shape == np.asarray(x).shape
                np.testing.assert_allclose(y, np.asarray(x), atol=MODEL_TOL,
                                           rtol=MODEL_TOL)
    assert teng.stats()['models']['bert']['batches'] == 3


# ---------------------------------------------------------------------------
# engine contract (a recording predict_fn stands in for a model)
# ---------------------------------------------------------------------------

def _recording_model(calls):
    def fn(feeds):
        calls.append({k: v.clone() for k, v in feeds.items()})
        return feeds['x'] * 2.0
    return fn


def _x(v, n=4):
    return {'x': np.full((n,), v, np.float32)}


def test_batches_pad_to_the_smallest_bucket():
    calls = []
    eng = ServingEngine(device='cpu')
    ep = eng.register('m', predict_fn=_recording_model(calls),
                      example=_x(0), bucket_spec=BucketSpec((1, 4, 8)))
    futs = [ep.submit(_x(i + 1)) for i in range(3)]
    assert eng.run_until_idle() == 1
    (feeds,) = calls
    assert feeds['x'].shape == (4, 4)                  # 3 -> bucket 4
    assert (feeds['x'][3] == 0).all()                  # zero padding row
    for i, f in enumerate(futs):
        r = f.result(5)
        assert r.ok and (r.outputs == 2.0 * (i + 1)).all()
        assert 'run' in r.breakdown
    stats = eng.stats()['models']['m']
    assert stats['batches'] == 1 and stats['mean_batch_occupancy'] == 0.75


def test_more_requests_than_the_largest_bucket_split():
    calls = []
    eng = ServingEngine(device='cpu')
    ep = eng.register('m', predict_fn=_recording_model(calls),
                      example=_x(0), bucket_spec=BucketSpec((1, 2)))
    futs = [ep.submit(_x(i)) for i in range(5)]
    eng.run_until_idle()
    assert [c['x'].shape[0] for c in calls] == [2, 2, 1]
    assert all(f.result(5).ok for f in futs)


def test_warmup_runs_every_bucket_with_zeros():
    calls = []
    eng = ServingEngine(device='cpu')
    eng.register('m', predict_fn=_recording_model(calls), example=_x(0),
                 bucket_spec=BucketSpec((1, 2, 4)))
    assert eng.warmup() == {'m': 3}
    assert [c['x'].shape[0] for c in calls] == [1, 2, 4]
    assert all((c['x'] == 0).all() for c in calls)


def test_queue_full_sheds_at_submit():
    eng = ServingEngine(device='cpu')
    ep = eng.register('m', predict_fn=_recording_model([]), example=_x(0),
                      queue_capacity=2)
    ep.submit(_x(1))
    ep.submit(_x(2))
    with pytest.raises(QueueFullError):
        ep.submit(_x(3))
    assert eng.stats()['shed'] == 1 and eng.stats()['submitted'] == 2
    eng.run_until_idle()
    ep.submit(_x(4))                                   # room again


def test_expired_request_never_runs():
    calls = []
    eng = ServingEngine(device='cpu')
    ep = eng.register('m', predict_fn=_recording_model(calls), example=_x(0))
    late = ep.submit(_x(1), deadline_ms=1)
    live = ep.submit(_x(2), deadline_ms=60000)
    time.sleep(0.02)
    eng.run_until_idle()
    assert late.result(5).status == 'deadline'
    assert late.result(5).outputs is None
    assert live.result(5).ok
    assert len(calls) == 1 and calls[0]['x'].shape[0] == 1
    assert eng.stats()['models']['m']['expired'] == 1


def test_default_deadline_applies():
    eng = ServingEngine(device='cpu', default_deadline_ms=1)
    ep = eng.register('m', predict_fn=_recording_model([]), example=_x(0))
    f = ep.submit(_x(1))
    time.sleep(0.02)
    eng.run_until_idle()
    assert f.result(5).status == 'deadline'


@pytest.mark.parametrize("inputs,match", [
    ({'x': np.zeros((5,), np.float32)}, 'shape/dtype'),
    ({'x': np.zeros((4,), np.float64)}, 'shape/dtype'),
    ({'y': np.zeros((4,), np.float32)}, 'missing inputs'),
])
def test_inputs_validated_at_submit(inputs, match):
    eng = ServingEngine(device='cpu')
    ep = eng.register('m', predict_fn=_recording_model([]), example=_x(0))
    with pytest.raises(ValueError, match=match):
        ep.submit(inputs)
    assert eng.stats()['submitted'] == 0


def test_model_error_fails_the_batch_not_the_engine():
    state = {'fail': True}

    def flaky(feeds):
        if state['fail']:
            raise RuntimeError('boom')
        return feeds['x'] + 1.0

    eng = ServingEngine(device='cpu')
    ep = eng.register('m', predict_fn=flaky, example=_x(0))
    bad = [ep.submit(_x(1)) for _ in range(2)]
    eng.run_until_idle()
    for f in bad:
        with pytest.raises(RuntimeError, match='boom'):
            f.result(5)
    state['fail'] = False
    good = ep.submit(_x(1))
    eng.run_until_idle()
    assert good.result(5).ok
    assert eng.stats()['models']['m']['errors'] == 2


def test_output_without_batch_axis_fails_the_batch():
    eng = ServingEngine(device='cpu')
    ep = eng.register('m', predict_fn=lambda feeds: torch.tensor(1.0),
                      example=_x(0))
    f = ep.submit(_x(1))
    eng.run_until_idle()
    with pytest.raises(IndexError):
        f.result(5)


def test_threaded_start_predict_and_stop():
    seen = []
    eng = ServingEngine(device='cpu')

    def fn(feeds):
        seen.append((threading.current_thread().name,
                     torch.is_inference_mode_enabled()))
        return feeds['x'] * 3.0

    ep = eng.register('m', predict_fn=fn, example=_x(0))
    eng.start()
    try:
        assert eng.alive()
        assert eng.start() is eng                       # idempotent
        r = ep.predict(_x(2), timeout=10)
        assert r.ok and (r.outputs == 6.0).all()
        futs = [ep.submit(_x(i)) for i in range(6)]
        assert all(f.result(10).ok for f in futs)
    finally:
        eng.stop()
    assert not eng.alive()
    assert all(name == 'paddle-tpu-torch-serving' for name, _ in seen)
    # queued after stop: no worker, so the bounded wait raises
    f = ep.submit(_x(1))
    with pytest.raises(WatchdogTimeout):
        f.result(timeout=0.2)
    eng.stop()
    with pytest.raises(RuntimeError, match='stopped before'):
        f.result(1)


def test_layer_runs_in_inference_mode_on_the_worker_thread():
    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.modes = []

        def forward(self, x):
            self.modes.append((torch.is_inference_mode_enabled(),
                               self.training))
            return x + 1.0

    probe = Probe()
    eng = ServingEngine(device='cpu')
    ep = eng.register('p', layer=probe, example=_x(0))
    eng.start()
    try:
        assert ep.predict(_x(1), timeout=10).ok
    finally:
        eng.stop()
    assert probe.modes == [(True, False)]


def test_layer_feeds_bind_by_keyword():
    class ThreeIn(torch.nn.Module):
        def forward(self, x, y=None, z=None):
            assert y is None
            return x + 10.0 * z

    eng = ServingEngine(device='cpu')
    ep = eng.register('three', layer=ThreeIn(),
                      example={'x': np.zeros((4,), np.float32),
                               'z': np.zeros((4,), np.float32)})
    f = ep.submit({'x': np.ones((4,), np.float32),
                   'z': np.full((4,), 2.0, np.float32)})
    eng.run_until_idle()
    np.testing.assert_allclose(f.result(5).outputs, 21.0)
    with pytest.raises(ValueError, match='bind unambiguously'):
        eng.register('bad', layer=ThreeIn(),
                     example={'p': np.zeros((4,), np.float32),
                              'q': np.zeros((4,), np.float32)})


def test_register_argument_errors():
    eng = ServingEngine(device='cpu')
    with pytest.raises(ValueError, match='exactly one model kind'):
        eng.register('m', example=_x(0))
    with pytest.raises(ValueError, match='example='):
        eng.register('m', predict_fn=_recording_model([]))
    eng.register('m', predict_fn=_recording_model([]), example=_x(0))
    with pytest.raises(ValueError, match='already registered'):
        eng.register('m', predict_fn=_recording_model([]), example=_x(0))
    with pytest.raises(KeyError):
        eng.submit('nope', _x(0))


@pytest.mark.parametrize("kwargs", [
    {'jit_compile': True}, {'program': object()},
    {'predictor': object()}, {'artifact_dir': '/nonexistent'},
    {'executor': object()}, {'quantize': 'int8'}])
def test_parts_not_ported_yet_raise(kwargs):
    # each names the ROADMAP item it waits for; tenants, SLOs and
    # jit_compile=False are taken (tests/test_torch_tenancy.py)
    eng = ServingEngine(device='cpu')
    with pytest.raises(NotImplementedError,
                       match='not ported.*Queue 1 item 7'):
        eng.register('m', example=_x(0), **kwargs)
    with pytest.raises(TypeError, match='unexpected keyword'):
        eng.register('m', example=_x(0), no_such_option=1)


@pytest.mark.parametrize("n,buckets,want", [
    (1, (1, 2, 4), 1), (3, (1, 2, 4), 4), (4, (4, 1, 2), 4)])
def test_select_bucket(n, buckets, want):
    assert select_bucket(n, sorted(buckets)) == want
    assert BucketSpec(buckets).batch_bucket(n) == want


def test_bucketing_rejects_oversize_and_never_truncates():
    with pytest.raises(ValueError):
        select_bucket(5, (1, 2, 4))
    with pytest.raises(ValueError):
        pad_to_bucket(np.zeros(5), 4)
    assert pad_to_bucket(np.ones((2, 3)), 4).tolist()[2:] == [[0] * 3] * 2


# ---------------------------------------------------------------------------
# package isolation
# ---------------------------------------------------------------------------

def test_port_imports_no_jax_and_nothing_of_the_reference():
    # every module of the package, the training slices' included
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "
        "'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'paddle_tpu_torch.engine.loop' in sys.modules\n"
        # the fleet layer, the chaos harness and the operator's tools
        "for m in ('serving.router', 'serving.fleet_supervisor', "
        "'serving.autoscaler', 'resilience.faultinject', 'tools.doctor', "
        "'tools.telemetry_dump', 'tools.postmortem', 'tools.perfwatch'):\n"
        "    assert 'paddle_tpu_torch.' + m in sys.modules, m\n"
        # the data-parallel slice: every module of distributed/
        "for m in ('deadline', 'env', 'collective', 'launch', "
        "'_spawn_entry', 'parallel', 'strategy', 'sharding', 'fleet', "
        "'role_maker', 'metrics', 'recompute'):\n"
        "    assert 'paddle_tpu_torch.distributed.' + m in sys.modules, m\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.') "
        "or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
        "print('BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == 'BAD []'


_FORBIDDEN = re.compile(
    r"torch\.nn\.functional\.(scaled_dot_product_attention|layer_norm)"
    r"|torch\.(layer_norm|compile)\b|torch\.ops\.aten"
    r"|cpp_extension|\bimport (triton|jax|flash_attn|xformers|apex)\b"
    r"|\bfrom (jax|paddle_tpu|flash_attn|xformers|apex)\b(?!_torch)"
    r"|\bimport paddle_tpu\b(?!_torch)|cudnn|\b_VF\b")

# Library use the port is allowed, by file: the recurrent layers' route on
# the card is PyTorch's RNN (cuDNN's), reached through ``torch._VF``, the
# counterpart of the reference's ``lax.scan`` (no Pallas kernel runs there).
_PERMITTED = {'paddle_tpu_torch/nn/functional/rnn.py':
              re.compile(r"\btorch\._VF\b")}


def test_port_calls_no_library_kernel():
    pkg = REPO / 'paddle_tpu_torch'
    hits, permitted = [], set()
    for path in sorted(pkg.rglob('*')):
        if path.suffix not in ('.py', '.cu', '.cuh'):
            continue
        rel = str(path.relative_to(REPO))
        allow = _PERMITTED.get(rel)
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if allow is not None and allow.search(line) and \
                    not _FORBIDDEN.search(allow.sub('', line)):
                permitted.add(rel)
                continue
            if _FORBIDDEN.search(line) and not line.lstrip().startswith(
                    ('#', '//', '"', "'")):
                hits.append(f"{rel}:{i}: {line.strip()}")
    assert not hits, hits
    # each allowance is used, so none outlives the call it was made for
    assert permitted == set(_PERMITTED)
    sources = sorted(p.name for p in (pkg / 'kernels' / 'csrc').glob('*.cu'))
    assert sources == ['errors.cu', 'flash_attention.cu',
                       'flash_attention_bwd.cu', 'fused_dropout_norm.cu',
                       'fused_norm.cu']


@pytest.mark.parametrize("where", ['checkout', 'alone'])
def test_chip_smoke_prints_no_result_without_a_gpu(where, tmp_path):
    src = (REPO / 'chip_smoke.py').read_text()
    assert not re.search(r'^\s*(import|from)\s+(jax|paddle_tpu)\b(?!_torch)',
                         src, re.M)
    cwd = REPO
    if where == 'alone':
        (tmp_path / 'chip_smoke.py').write_text(src)
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['CUDA_VISIBLE_DEVICES'] = ''
    out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
