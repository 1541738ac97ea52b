"""``engine.fit``'s checkpoint, resume and preemption on a 2-layer narrow
BERT on the CPU.

With dropout 0.1, Lamb under the global-norm clip, the loss scaler, the
NaN guard and ``microbatch=2`` (the card's ``train_fit`` recipe, fp32), a
run that is stopped and resumed ends bitwise where an uninterrupted one
does: parameters, optimizer slots, the dropout stream's offset and every
logged loss after the resume. Parametrised over where it stops (an epoch
boundary, or a crash in mid-epoch after ``checkpoint_every`` saves), a
sync or an async save, and a SIGTERM at a dispatch (raised from the data
iterator on the main thread while an async save is in flight). Also: a
resume past a truncated latest checkpoint, from an empty directory, and
the SIGTERM handler put back after an exception.

Against the reference, at p = 0 on the same weights (``interop``) and
``microbatch=1`` (each of its ``fit`` calls compiles its step, ~5 s): its
``fit`` with a checkpoint and a resume, and the port's, give the same
losses within 1e-5 relative and the same ``checkpoints``,
``resumed_from``, ``preempted`` and ``dispatches``; and the checkpoint the
reference's ``fit`` committed, read by the port's ``CheckpointManager``
and carried over by ``interop.from_paddle_tpu_train_state``, resumes the
port's run onto the reference's resumed losses."""
import os
import shutil
import signal

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import engine as jax_engine
from paddle_tpu import optimizer as jax_opt
from paddle_tpu.amp import GradScaler as JaxGradScaler
from paddle_tpu.nn import clip as jax_clip
from paddle_tpu.nn.layer_base import param_values
from paddle_tpu.text.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.bert import BertForPretraining as JaxBertForPretraining

from paddle_tpu_torch import engine
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.interop import (from_paddle_tpu_train_state,
                                      load_paddle_tpu_state)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.resilience import CheckpointManager
from paddle_tpu_torch.text.bert import BertConfig, BertForPretraining

SMALL = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=64,
             max_position_embeddings=32, hidden_dropout_prob=0.1,
             attention_probs_dropout_prob=0.1)
EPOCHS, BATCHES, K = 3, 4, 2          # 2 dispatches an epoch, 6 in all


def _batches(n=BATCHES, b=2, seq=16, seed=0, vocab=64):
    rs = np.random.RandomState(seed)
    k = 3
    out = []
    for _ in range(n):
        x = (rs.randint(0, vocab, (b, seq)).astype(np.int32),
             np.zeros((b, seq), np.int32), np.ones((b, seq), np.int32),
             np.stack([rs.choice(seq, k, replace=False)
                       for _ in range(b)]).astype(np.int32))
        y = (rs.randint(0, vocab, (b, k)).astype(np.int32),
             rs.randint(0, 2, (b, 1)).astype(np.int32))
        out.append((x, y))
    return out


class _Data:
    """The same batches every epoch; ``at`` (epoch, batch index) calls
    ``hit()`` when that batch is about to be read."""

    def __init__(self, at=None, hit=None):
        self.batches = _batches()
        self.at, self.hit = at, hit
        self.epoch = -1

    def __iter__(self):
        self.epoch += 1
        for i, b in enumerate(self.batches):
            if (self.epoch, i) == self.at:
                self.hit()
            yield b


def _run(seed=0, data=None, **kw):
    """One ``fit`` on a fresh model from ``seed`` -> (model, optimizer,
    report)."""
    net = BertForPretraining(BertConfig(**SMALL), device='cpu',
                             generator=torch.Generator().manual_seed(seed))
    opt = topt.Lamb(learning_rate=2e-3, grad_clip=ClipGradByGlobalNorm(1.0))
    kw.setdefault('epochs', EPOCHS)
    rep = engine.fit(net, net.pretraining_loss, opt, data or _Data(),
                     microbatch=K, log_every=1, nan_guard=True,
                     scaler=GradScaler(init_loss_scaling=2.0 ** 12),
                     device='cpu', **kw)
    return net, opt, rep


def _snapshot(net, opt, rep):
    return {'params': {k: v.detach().clone()
                       for k, v in net.named_parameters()},
            'opt': {k: {s: t.clone() for s, t in slots.items()}
                    for k, slots in opt._accumulators.items()},
            'offset': net.dropout_state.offset,
            'scaler': {k: v.clone()
                       for k, v in rep['state']['scaler'].items()},
            'loss': list(rep['loss'])}


def _assert_bitwise(got, want):
    assert got['offset'] == want['offset']
    for part in ('params', 'opt', 'scaler'):
        assert sorted(got[part]) == sorted(want[part]), part
    for k, v in want['params'].items():
        assert torch.equal(got['params'][k], v), k
    for k, slots in want['opt'].items():
        for s, t in slots.items():
            assert torch.equal(got['opt'][k][s], t), (k, s)
    for k, v in want['scaler'].items():
        assert torch.equal(got['scaler'][k], v), k


@pytest.fixture(scope='module')
def uninterrupted():
    return _snapshot(*_run())


class _Crash(Exception):
    pass


def _crash():
    raise _Crash('the machine went away')


def _sigterm():
    # fit's guard is installed on this (the main) thread; without it the
    # signal would end the process
    assert signal.getsignal(signal.SIGTERM) not in (signal.SIG_DFL, None)
    signal.raise_signal(signal.SIGTERM)


CASES = {
    # stop after the first epoch; its end-of-epoch checkpoint
    'epoch-sync': dict(stop=dict(epochs=1), async_save=False, at=2),
    'epoch-async': dict(stop=dict(epochs=1), async_save=True, at=2),
    # a crash while the third epoch's second group is read: the last
    # checkpoint (every 3 dispatches) is in mid-epoch 1
    'mid-sync': dict(stop=dict(checkpoint_every=3), async_save=False,
                     crash=(2, 2), at=3),
    'mid-async': dict(stop=dict(checkpoint_every=3), async_save=True,
                      crash=(2, 2), at=3),
    # SIGTERM while dispatch 4's batches are read, a save of dispatch 3 in
    # flight: the guard saves at 4 and stops
    'sigterm': dict(stop=dict(checkpoint_every=1), async_save=True,
                    sigterm=(1, 2), at=4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_resume_is_bitwise(tmp_path, uninterrupted, case):
    c = CASES[case]
    ckpt = str(tmp_path / 'ckpt')
    kw = dict(c['stop'], checkpoint=ckpt, async_save=c['async_save'])
    if 'crash' in c:
        with pytest.raises(_Crash):
            _run(data=_Data(c['crash'], _crash), **kw)
    elif 'sigterm' in c:
        prev = signal.getsignal(signal.SIGTERM)
        _, _, rep = _run(data=_Data(c['sigterm'], _sigterm), **kw)
        assert rep['preempted'] and rep['dispatches'] == c['at']
        assert signal.getsignal(signal.SIGTERM) is prev
    else:
        _, _, rep = _run(**kw)
        assert rep['checkpoints'] == 1 and not rep['preempted']
    assert CheckpointManager(ckpt).latest_step() == c['at']
    net, opt, rep = _run(seed=7, checkpoint=ckpt,
                         async_save=c['async_save'])
    assert rep['resumed_from'] == c['at'] and not rep['preempted']
    assert rep['dispatches'] == EPOCHS * BATCHES // K
    got = _snapshot(net, opt, rep)
    assert got['loss'] == uninterrupted['loss'][c['at']:]
    _assert_bitwise(got, uninterrupted)


def test_resume_past_a_truncated_latest_checkpoint(tmp_path, uninterrupted):
    ckpt = str(tmp_path / 'ckpt')
    with pytest.raises(_Crash):
        _run(data=_Data((2, 2), _crash), checkpoint=ckpt, checkpoint_every=2,
             async_save=False)
    mgr = CheckpointManager(ckpt)
    assert mgr.steps() == [2, 4]
    shard = os.path.join(mgr._v2_dir(4), 'shard_rank0.npz')
    with open(shard, 'r+b') as f:
        f.truncate(os.path.getsize(shard) - 11)
    with pytest.warns(UserWarning, match='step 4.*corrupt.*falling back'):
        net, opt, rep = _run(seed=7, resume_from=ckpt)
    assert rep['resumed_from'] == 2
    _assert_bitwise(_snapshot(net, opt, rep), uninterrupted)


def test_resume_from_an_empty_directory_starts_afresh(tmp_path,
                                                      uninterrupted):
    net, opt, rep = _run(resume_from=str(tmp_path / 'nothing'))
    assert rep['resumed_from'] is None and rep['checkpoints'] == 0
    _assert_bitwise(_snapshot(net, opt, rep), uninterrupted)


def test_sigterm_handler_is_put_back_after_an_exception(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    with pytest.raises(_Crash):
        _run(data=_Data((0, 1), _crash), checkpoint=str(tmp_path))
    assert signal.getsignal(signal.SIGTERM) is prev


# -- against the reference, at p = 0 ------------------------------------------

P0 = dict(SMALL, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _ref_fit(ref, data, **kw):
    opt = jax_opt.Lamb(learning_rate=2e-3, epsilon=1e-4,
                       grad_clip=jax_clip.ClipGradByGlobalNorm(1.0))
    return jax_engine.fit(ref, ref.pretraining_loss, opt, data,
                          microbatch=1, log_every=1, nan_guard=True,
                          scaler=JaxGradScaler(init_loss_scaling=2.0 ** 12),
                          **kw)


def _port_fit(init, data, **kw):
    net = BertForPretraining(BertConfig(**P0), device='cpu')
    load_paddle_tpu_state(net, init)
    opt = topt.Lamb(learning_rate=2e-3, epsilon=1e-4,
                    grad_clip=ClipGradByGlobalNorm(1.0))
    return engine.fit(net, net.pretraining_loss, opt, data, microbatch=1,
                      log_every=1, nan_guard=True,
                      scaler=GradScaler(init_loss_scaling=2.0 ** 12),
                      device='cpu', **kw)


def _ref_model():
    paddle.seed(11)
    ref = JaxBertForPretraining(JaxBertConfig(**P0))
    # unique parameter names: the reference keeps slots by name and its
    # cloned layers share theirs (ROADMAP.md, Queue 3)
    for key, p in ref.named_parameters():
        p.name = key
    return ref


@pytest.fixture(scope='module')
def reference_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('ref')
    ref = _ref_model()
    init = {k: np.asarray(v) for k, v in
            param_values(ref, trainable_only=False).items()}
    data = _batches(2)
    first = _ref_fit(ref, data, epochs=1, checkpoint=str(root / 'a'),
                     checkpoint_every=1)
    second = _ref_fit(_ref_model(), data, epochs=2,
                      checkpoint=str(root / 'b'), resume_from=str(root / 'a'))
    return init, data, root, first, second


REPORT_KEYS = ('checkpoints', 'resumed_from', 'preempted', 'dispatches',
               'steps')


def test_checkpoint_and_resume_match_the_reference(reference_runs, tmp_path):
    init, data, _, ref_first, ref_second = reference_runs
    first = _port_fit(init, data, epochs=1, checkpoint=str(tmp_path / 'a'),
                      checkpoint_every=1)
    second = _port_fit(init, data, epochs=2, checkpoint=str(tmp_path / 'b'),
                       resume_from=str(tmp_path / 'a'))
    for got, want in ((first, ref_first), (second, ref_second)):
        for key in REPORT_KEYS:
            assert got[key] == want[key], key
        np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5)
    assert first['checkpoints'] == 3 and second['resumed_from'] == 2
    assert second['checkpoints'] == 1
    assert CheckpointManager(str(tmp_path / 'a')).steps() == [1, 2]
    assert CheckpointManager(str(tmp_path / 'b')).steps() == [4]


def test_the_references_checkpoint_seeds_the_port(reference_runs, tmp_path):
    """The reference's committed checkpoint, read by the port's manager and
    carried into the port's layout by ``interop``, resumes the port's run
    onto the reference's resumed losses."""
    init, data, root, _, ref_second = reference_runs
    state, meta, extra = CheckpointManager(str(root / 'a')).restore(
        return_extra=True)
    assert sorted(state) == ['buffers', 'guard', 'opt', 'params', 'scaler']
    net = BertForPretraining(BertConfig(**P0), device='cpu')
    ported = from_paddle_tpu_train_state(net, state)
    port_dir = str(tmp_path / 'port')
    CheckpointManager(port_dir).save(ported, step=meta['dispatches'],
                                     meta=meta, extra=extra)
    rep = _port_fit(init, data, epochs=2, resume_from=port_dir)
    assert rep['resumed_from'] == ref_second['resumed_from'] == 2
    np.testing.assert_allclose(rep['loss'], ref_second['loss'], rtol=1e-5)
    # the restored scaler and guard counters are the reference's
    assert rep['state']['guard']['steps'].item() == \
        int(ref_second['state']['guard']['steps'])
    assert rep['state']['scaler']['scale'].item() == \
        float(ref_second['state']['scaler']['scale'])
    shutil.rmtree(port_dir)
