"""``paddle_tpu_torch.hapi.Model`` against ``paddle_tpu.hapi.Model``: a
2-layer, narrow ``BertForPretraining`` at p = 0 on copied weights
(``interop.load_paddle_tpu_state``), AdamW, ``Accuracy(topk=(1, 5))``
on the MLM logits, two shuffled epochs from one ``np.random.seed``. The
port's eager step and its ``jit=True`` step are each held to the
reference's: every step's loss (1e-4) and accuracy, then ``evaluate``'s
logs and ``predict``'s outputs (1e-5). The rate is fixed there: the
reference's compiled step freezes a scheduler's value (ROADMAP.md, Queue
3), so the ``LRScheduler`` callback is held to the reference's schedulers
on their own, and the port's two paths to each other under it. The
reference's
accuracy counts only the batch dimension of the (batch, positions,
classes) logits (ROADMAP.md, Queue 3), so its values are the port's times
the number of masked positions.

Both port paths are held to the reference's compiled step: its eager step
compiles op by op, ~36 s for a first BERT step on this CPU, and computes
the same function. For the same reason the reference's ``evaluate`` and
``predict`` run through its own ``Model`` over the network's forward under
one ``jax.jit`` (``_CompiledForward``).

Also: ``GradScaler`` + ``nan_guard`` skip poisoned batches as the
reference's do (a toy classifier, both port paths against the reference's
compiled step); ``summary``'s counts and ``flops`` equal the reference's;
``EarlyStopping``, ``LRScheduler``, ``ModelCheckpoint`` and ``VisualDL``
act as the reference's; keyword feeds, loader threads and a ``DataLoader``
handed to ``fit`` agree; ``strategy=``, ``save(training=False)`` and
``PADDLE_TPU_TELEMETRY=1`` raise. The resumes are in
``test_torch_hapi_resume.py``."""
import json
import os

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import hapi as jhapi
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn.layer_base import functional_call, param_values
from paddle_tpu.text.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.bert import BertForPretraining as JaxBertForPretraining

import paddle_tpu_torch as pt
from paddle_tpu_torch import io as tio, metric as tmetric
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.interop import load_paddle_tpu_state
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.text.bert import BertConfig, BertForPretraining

SMALL = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=64,
             max_position_embeddings=32, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)
SEQ, K, BATCH = 16, 3, 4


def _samples(n, seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 97, (n, SEQ)).astype(np.int32)
    pos = np.stack([rs.choice(SEQ, K, replace=False)
                    for _ in range(n)]).astype(np.int32)
    return ids, pos, rs.randint(0, 97, (n, K)).astype(np.int32), \
        rs.randint(0, 2, (n, 1)).astype(np.int32)


class _Pretraining:
    """BERT pretraining samples: ((ids, token types, mask, masked
    positions), (MLM labels, NSP label)), the forward's positional
    order."""

    def __init__(self, n, seed):
        self.data = _samples(n, seed)

    def __len__(self):
        return len(self.data[0])

    def __getitem__(self, i):
        ids, pos, lab, nsp = (a[i] for a in self.data)
        return (ids, np.zeros_like(ids), np.ones_like(ids), pos), (lab, nsp)


class JData(_Pretraining, jio.Dataset):
    pass


class TData(_Pretraining, tio.Dataset):
    pass


def _recorder(base):
    class Recorder(base):
        """Each train batch's logs and learning rate, each epoch's start."""

        def __init__(self):
            super().__init__()
            self.logs, self.lrs, self.epochs = [], [], []

        def on_epoch_begin(self, epoch, logs=None):
            self.epochs.append(epoch)

        def on_train_batch_end(self, step, logs=None):
            self.logs.append(dict(logs))
            self.lrs.append(self.model._optimizer.get_lr())
    return Recorder()


class _CompiledForward(paddle.nn.Layer):
    """The reference network's forward under one ``jax.jit``."""

    def __init__(self, net):
        super().__init__()
        self.net = net

        def forward(params, *arrays):
            outs, _ = functional_call(net, params, *map(Tensor, arrays))
            return tuple(o._value for o in outs)
        self._forward = jax.jit(forward)

    def forward(self, *inputs):
        outs = self._forward(param_values(self.net, trainable_only=False),
                             *[x._value for x in inputs])
        return tuple(Tensor(o) for o in outs)


@pytest.fixture(scope='module')
def reference_run():
    paddle.seed(0)
    ref = JaxBertForPretraining(JaxBertConfig(**SMALL))
    init = {k: np.asarray(v) for k, v in
            param_values(ref, trainable_only=False).items()}
    model = jhapi.Model(ref)
    model.prepare(jopt.AdamW(learning_rate=1e-3, weight_decay=0.01,
                             parameters=ref.parameters()),
                  ref.pretraining_loss, jmetric.Accuracy(topk=(1, 5)),
                  jit=True)
    rec = _recorder(jhapi.callbacks.Callback)
    np.random.seed(0)
    model.fit(JData(16, 0), batch_size=BATCH, epochs=2, log_freq=1,
              verbose=0, callbacks=[rec])
    model._sync_jit_state()
    compiled = jhapi.Model(_CompiledForward(ref))
    compiled.prepare(loss=ref.pretraining_loss,
                     metrics=jmetric.Accuracy(topk=(1, 5)))
    eval_logs = compiled.evaluate(JData(8, 1), batch_size=BATCH, verbose=0)
    predicted = compiled.predict(JData(8, 1), batch_size=BATCH,
                                 stack_outputs=True)
    # the counts come from the parameters; the forward is already traced
    counts = jhapi.summary(compiled.network,
                           input=[paddle.to_tensor(np.zeros((1, SEQ),
                                                            np.int32))])
    return dict(init=init, rec=rec, eval=eval_logs, predict=predicted,
                summary=counts)


def _port_bert(init=None, seed=0):
    net = BertForPretraining(BertConfig(**SMALL), device='cpu',
                             generator=torch.Generator().manual_seed(seed))
    if init is not None:
        load_paddle_tpu_state(net, init)
    return net


def _port_model(net, jit, lr=1e-3, metrics=True, **kw):
    model = pt.Model(net, device='cpu')
    opt = topt.AdamW(learning_rate=lr, weight_decay=0.01,
                     parameters=net.parameters())
    model.prepare(opt, net.pretraining_loss,
                  tmetric.Accuracy(topk=(1, 5)) if metrics else None,
                  jit=jit, **kw)
    return model


@pytest.mark.parametrize('jit', [False, True], ids=['eager', 'jit'])
def test_fit_evaluate_predict_match_reference(reference_run, jit):
    ref = reference_run
    net = _port_bert(ref['init'])
    model = _port_model(net, jit)
    rec = _recorder(tcb.Callback)
    np.random.seed(0)
    model.fit(TData(16, 0), batch_size=BATCH, epochs=2, log_freq=1,
              verbose=0, callbacks=[rec])
    assert len(rec.logs) == len(ref['rec'].logs) == 8
    for got, want in zip(rec.logs, ref['rec'].logs):
        assert isinstance(got['loss'], float)
        np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-4)
        # the reference divides the hits by the batch only: K times more
        np.testing.assert_allclose(got['acc_top1'] * K, want['acc_top1'],
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(rec.lrs, ref['rec'].lrs, rtol=1e-12)
    assert rec.epochs == ref['rec'].epochs == [0, 1]

    logs = model.evaluate(TData(8, 1), batch_size=BATCH, verbose=0)
    want = ref['eval']
    assert set(logs) == set(want) == {'loss', 'acc_top1', 'acc_top5'}
    np.testing.assert_allclose(logs['loss'], want['loss'], rtol=1e-5)
    for name in ('acc_top1', 'acc_top5'):
        np.testing.assert_allclose(logs[name] * K, want[name], rtol=1e-5,
                                   atol=1e-7)
        assert 0.0 <= logs[name] <= 1.0
    got = model.predict(TData(8, 1), batch_size=BATCH, stack_outputs=True)
    assert [o.shape for o in got] == [(8, K, 97), (8, 2)]
    for g, w in zip(got, ref['predict']):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)
    per_batch = model.predict(TData(8, 1), batch_size=BATCH)
    assert len(per_batch) == 2 and per_batch[0][0].shape == (BATCH, K, 97)


def test_keyword_feeds_workers_and_loaders_agree():
    """Keyword feeds (the engine's convention), two loader threads and a
    ``DataLoader`` handed to ``fit`` give the positional run's losses."""
    class Keyword(tio.Dataset):
        def __init__(self):
            self.inner = TData(8, 0)

        def __len__(self):
            return len(self.inner)

        def __getitem__(self, i):
            (ids, tt, mask, pos), y = self.inner[i]
            return {'input_ids': ids, 'masked_positions': pos,
                    'token_type_ids': tt}, y

    runs = {}
    for how in ('positional', 'keyword', 'workers', 'loader', 'jit'):
        model = _port_model(_port_bert(), how == 'jit', metrics=False)
        rec = _recorder(tcb.Callback)
        data = Keyword() if how in ('keyword', 'jit') else TData(8, 0)
        if how == 'loader':
            data = tio.DataLoader(data, batch_size=BATCH, device='cpu')
        np.random.seed(1)
        model.fit(data, batch_size=BATCH, epochs=1, log_freq=1, verbose=0,
                  shuffle=False, num_workers=2 if how == 'workers' else 0,
                  callbacks=[rec])
        runs[how] = [r['loss'] for r in rec.logs]
    for how, losses in runs.items():
        np.testing.assert_allclose(losses, runs['positional'], rtol=1e-6,
                                   err_msg=how)


def test_summary_and_flops_match_reference(reference_run, capsys):
    net = _port_bert(reference_run['init'])
    got = pt.summary(net, input=[torch.zeros((1, SEQ), dtype=torch.int64)])
    assert got == reference_run['summary'] == {'total_params': 23683,
                                               'trainable_params': 23683}
    out = capsys.readouterr().out
    assert 'Total params: 23,683' in out
    assert 'bert.encoder.layers.0.self_attn.q_proj' in out
    # a toy MLP: the same rows, counts and FLOPs
    paddle.seed(1)
    jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    tnet = torch.nn.Sequential(Linear(8, 16, device='cpu'),
                               torch.nn.ReLU(), Linear(16, 4, device='cpu'))
    want = jhapi.summary(jnet, input_size=(2, 8))
    ref_rows = capsys.readouterr().out.splitlines()
    assert pt.summary(tnet, input_size=(2, 8)) == want
    rows = capsys.readouterr().out.splitlines()
    assert rows[:3] == ref_rows[:3] and rows[-5:] == ref_rows[-5:]
    for got_row, want_row in zip(rows[3:-5], ref_rows[3:-5]):
        # the type column names torch's own class for the activation
        assert got_row.split()[1:] == want_row.split()[1:]
    assert jhapi.flops(jnet, [2, 8]) == pt.hapi.flops(tnet, [2, 8]) == \
        2 * (8 * 16 + 16 * 4)
    model = pt.Model(tnet, device='cpu')
    assert model.summary((2, 8)) == want
    assert len(list(model.parameters())) == 4


class _Toy:
    """32 samples of 8 features, 4 classes; batches 0 and 1 of 8 can be
    poisoned with a NaN feature."""

    def __init__(self):
        rs = np.random.RandomState(7)
        self.x = rs.randn(32, 8).astype(np.float32)
        self.y = rs.randint(0, 4, 32).astype(np.int64)


def _toy_reference():
    paddle.seed(1)
    net = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    init = {k: np.asarray(v) for k, v in param_values(net).items()}
    model = jhapi.Model(net)
    model.prepare(jopt.Adam(learning_rate=1e-2, parameters=net.parameters()),
                  jnn.CrossEntropyLoss(), jit=True, nan_guard=True,
                  amp_configs=jamp.GradScaler(init_loss_scaling=256.))
    return model, init


def _toy_port(init, jit):
    net = torch.nn.Sequential(Linear(8, 16, device='cpu'), torch.nn.ReLU(),
                              Linear(16, 4, device='cpu'))
    load_paddle_tpu_state(net, init)
    model = pt.Model(net, device='cpu')
    model.prepare(topt.Adam(learning_rate=1e-2, parameters=net.parameters()),
                  lambda logits, y: F.cross_entropy(logits, y), jit=jit,
                  nan_guard=True, amp_configs=GradScaler(init_loss_scaling=256.))
    return model


def test_scaler_and_guard_skip_poisoned_batches_as_reference():
    data = _Toy()
    ref, init = _toy_reference()
    plan = ['clean', 'nan', 'nan', 'clean']

    def batch(i, how):
        x = data.x[8 * i:8 * i + 8].copy()
        if how == 'nan':
            x[0, 0] = np.nan
        return [x], [data.y[8 * i:8 * i + 8]]
    want = [ref.train_batch(*batch(i, how))[0][0]
            for i, how in enumerate(plan)]
    ref._sync_jit_state()
    want_params = {k: np.asarray(v) for k, v in
                   param_values(ref.network).items()}
    for jit in (False, True):
        model = _toy_port(init, jit)
        got, before = [], None
        for i, how in enumerate(plan):
            if how == 'nan' and before is None:
                before = {k: v.clone() for k, v in
                          model.network.state_dict().items()}
            got.append(model.train_batch(*batch(i, how))[0][0])
            if how == 'nan':
                # a poisoned step changes no bit of the parameters
                for k, v in model.network.state_dict().items():
                    assert torch.equal(v, before[k]), k
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert not np.isfinite(got[1]) and not np.isfinite(got[2])
        assert model._scaler.get_loss_scaling() == \
            ref._scaler.get_loss_scaling() == 128.0
        assert model._nan_guard.state_dict() == ref._nan_guard.state_dict()
        model._sync_jit_state()
        # Adam steps sign-like: an element whose gradient is rounding
        # noise moves by up to the rate either way, so the tensors are
        # held to 1e-4 of their largest value
        got_params = pt.interop.to_paddle_tpu_state(model.network)
        for k, v in want_params.items():
            np.testing.assert_allclose(got_params[k], v, rtol=0,
                                       atol=1e-4 * np.abs(v).max())


def test_early_stopping_and_lr_scheduler_act_as_reference():
    # EarlyStopping: one sequence of eval logs into both classes
    class Holder:
        stop_training = False
    seq = [{'loss': 3.0}, {'loss': 2.5}, {'loss': 2.6}, {'loss': 2.4},
           {'loss': 2.45}, {'loss': 2.46}]
    for kw in (dict(), dict(patience=2), dict(min_delta=0.2, patience=1),
               dict(monitor='acc', mode='max', patience=1)):
        got, want = tcb.EarlyStopping(verbose=0, **kw), \
            jhapi.callbacks.EarlyStopping(verbose=0, **kw)
        got.set_model(Holder())
        want.set_model(Holder())
        for logs in seq:
            logs = {**logs, 'acc': [1.0 - logs['loss'] / 4]}
            got.on_eval_end(logs)
            want.on_eval_end(logs)
            assert (got.best, got.wait, got.model.stop_training) == \
                (want.best, want.wait, want.model.stop_training)
    # LRScheduler by step and by epoch: the rates each step used follow
    # the reference's scheduler, and both port paths train on them alike
    for by in (dict(by_step=False, by_epoch=True), dict()):
        losses = []
        for jit in (False, True):
            model = _port_model(
                _port_bert(), jit, metrics=False,
                lr=topt.lr.LinearWarmup(topt.lr.StepDecay(1e-3, 1, 0.5),
                                        2, 1e-4, 1e-3))
            rec = _recorder(tcb.Callback)
            np.random.seed(0)
            model.fit(TData(8, 0), batch_size=BATCH, epochs=3, verbose=0,
                      log_freq=1, callbacks=[rec, tcb.LRScheduler(**by)])
            ref_sched = jopt.lr.LinearWarmup(jopt.lr.StepDecay(1e-3, 1, 0.5),
                                             2, 1e-4, 1e-3)
            want = []
            for _ in range(3):
                for _ in range(2):
                    want.append(ref_sched())
                    if by.get('by_step', True):
                        ref_sched.step()
                if by.get('by_epoch'):
                    ref_sched.step()
            np.testing.assert_allclose(rec.lrs, want, rtol=1e-12)
            assert len(set(rec.lrs)) > 2
            losses.append([r['loss'] for r in rec.logs])
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)


def test_callbacks_stop_and_write(tmp_path):
    """EarlyStopping ends fit after the first eval that does not improve;
    ModelCheckpoint writes what ``Model.load`` reads back; VisualDL writes
    one record a batch."""
    model = _port_model(_port_bert(), True)
    rec = _recorder(tcb.Callback)
    stop = tcb.EarlyStopping(monitor='loss', min_delta=10.0, verbose=0)
    ckpt = tcb.ModelCheckpoint(save_freq=1, save_dir=str(tmp_path / 'ck'))
    vdl = tcb.VisualDL(str(tmp_path / 'vdl'))
    np.random.seed(0)
    model.fit(TData(8, 0), eval_data=TData(4, 1), batch_size=BATCH,
              epochs=5, log_freq=1, verbose=0,
              callbacks=[rec, stop, ckpt, vdl])
    assert rec.epochs == [0, 1] and model.stop_training
    names = sorted(os.listdir(tmp_path / 'ck'))
    assert names == ['0.pdopt', '0.pdparams', '1.pdopt', '1.pdparams',
                     'final.pdopt', 'final.pdparams']
    with open(tmp_path / 'vdl' / 'scalars.jsonl') as f:
        records = [json.loads(line) for line in f]
    assert [r['step'] for r in records] == [0, 1, 2, 3]
    assert all({'loss', 'acc_top1', 'ts'} <= set(r) for r in records)
    assert [r['loss'] for r in records] == [r['loss'] for r in rec.logs]
    # the final save, read back into a fresh model, and its optimizer
    fresh = _port_model(_port_bert(seed=5), False)
    fresh.load(str(tmp_path / 'ck' / 'final'))
    for (k, v), w in zip(fresh.network.state_dict().items(),
                         model.network.state_dict().values()):
        assert torch.equal(v, w), k
    assert set(fresh._optimizer.state_dict()) == \
        set(model._optimizer.state_dict())
    assert any(k.endswith('.moment1') for k in fresh._optimizer.state_dict())


def test_options_that_wait_raise(tmp_path, monkeypatch):
    model = _port_model(_port_bert(), False, metrics=False)
    with pytest.raises(NotImplementedError, match='distributed'):
        model.prepare(strategy=object())
    with pytest.raises(NotImplementedError, match='distributed'):
        model.fit(TData(4, 0), strategy=object(), verbose=0)
    with pytest.raises(NotImplementedError, match='inference'):
        model.save(str(tmp_path / 'm'), training=False)
    monkeypatch.setenv('PADDLE_TPU_TELEMETRY', '1')
    with pytest.raises(NotImplementedError, match='observability'):
        model.fit(TData(4, 0), verbose=0)
    monkeypatch.delenv('PADDLE_TPU_TELEMETRY')
    with pytest.raises(ValueError, match='runs on'):
        pt.Model(_port_bert(), device='meta')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            pt.Model(_port_bert())
