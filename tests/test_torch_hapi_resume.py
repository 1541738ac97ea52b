"""``paddle_tpu_torch.hapi``'s resumes, within the port (the reference
has no counterpart of the port's RNG streams to compare with): a 2-layer,
narrow ``BertForPretraining`` at p = 0.1, so that every step draws dropout
masks, with Adam's slots to carry. ``CheckpointSaver`` stop and resume
(a SIGTERM mid-epoch and on an epoch's last batch, async epoch saves, the
eager and the jit path; an epoch-boundary resume with the loss scaler)
repeats the uninterrupted run bit for bit: parameters, optimizer slots,
the dropout stream, the scale. ``fit(resume_from=)`` continues an
``engine.fit`` checkpoint bit for bit on both paths. Follows
``tests/test_resilience.py``'s kill-and-resume checks of the
reference's ``Model``."""
import signal

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import engine, io as tio
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.text.bert import BertConfig, BertForPretraining

SMALL = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=64,
             max_position_embeddings=32, hidden_dropout_prob=0.1,
             attention_probs_dropout_prob=0.1)
SEQ, K, BATCH = 16, 3, 4


class TData(tio.Dataset):
    """BERT pretraining samples: ((ids, token types, mask, masked
    positions), (MLM labels, NSP label))."""

    def __init__(self, n, seed):
        rs = np.random.RandomState(seed)
        self.ids = rs.randint(0, 97, (n, SEQ)).astype(np.int32)
        self.pos = np.stack([rs.choice(SEQ, K, replace=False)
                             for _ in range(n)]).astype(np.int32)
        self.lab = rs.randint(0, 97, (n, K)).astype(np.int32)
        self.nsp = rs.randint(0, 2, (n, 1)).astype(np.int32)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        ids = self.ids[i]
        return (ids, np.zeros_like(ids), np.ones_like(ids), self.pos[i]), \
            (self.lab[i], self.nsp[i])


def _resume_model(seed, jit, scaler=False):
    """The resume tests' model: p = 0.1, so every step draws dropout
    masks; Adam slots and (optionally) the loss scaler to carry."""
    net = BertForPretraining(BertConfig(**SMALL), device='cpu',
                             generator=torch.Generator().manual_seed(seed))
    model = pt.Model(net, device='cpu')
    model.prepare(topt.Adam(learning_rate=1e-3,
                            parameters=net.parameters()),
                  net.pretraining_loss, jit=jit,
                  amp_configs=GradScaler(init_loss_scaling=64.)
                  if scaler else None)
    return model


def _fit(model, epochs, data=None, shuffle=True, **kw):
    np.random.seed(3)
    model.fit(data or TData(16, 0), batch_size=BATCH, epochs=epochs,
              shuffle=shuffle, verbose=0, **kw)


def _state(model):
    model._sync_jit_state()
    out = {f'net.{k}': v.clone() for k, v in
           model.network.state_dict().items()}
    for k, v in model._optimizer.state_dict().items():
        out[f'opt.{k}'] = v.clone() if isinstance(v, torch.Tensor) else v
    out['dropout_offset'] = model.network.dropout_state.offset
    if model._scaler is not None:
        out['scale'] = model._scaler.state_dict()
    return out


def _assert_bitwise(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), k
        else:
            assert g == w, k


class _PreemptAt(tcb.Callback):
    """A SIGTERM at the end of global batch ``at``."""

    def __init__(self, at):
        super().__init__()
        self.at, self.seen, self.fired = at, 0, False

    def on_train_batch_end(self, step, logs=None):
        if self.seen == self.at and not self.fired:
            self.fired = True
            signal.raise_signal(signal.SIGTERM)
        self.seen += 1


@pytest.mark.parametrize('jit', [False, True], ids=['eager', 'jit'])
def test_checkpoint_saver_sigterm_resume_is_bitwise(tmp_path, jit):
    """3 epochs of 4 steps; a SIGTERM at global step 5 (mid-epoch 1) and
    at step 7 (epoch 1's last batch), with async epoch saves; the resumed
    run, from another seed's model, equals the uninterrupted one bit for
    bit: parameters, Adam slots, the dropout stream."""
    want = _state(_fit_and_return(_resume_model(0, jit), 3))
    prev = signal.getsignal(signal.SIGTERM)
    for at in (5, 7):
        ck = str(tmp_path / f'ck{at}')
        killed = _resume_model(0, jit)
        saver = tcb.CheckpointSaver(ck, async_save=True)
        pre = _PreemptAt(at)
        _fit(killed, 3, callbacks=[pre, saver])
        assert pre.fired and saver.preempted and killed.stop_training
        assert signal.getsignal(signal.SIGTERM) is prev
        resumed = _resume_model(1, jit)
        _fit(resumed, 3, callbacks=[tcb.CheckpointSaver(ck)],
             resume_from=ck)
        _assert_bitwise(_state(resumed), want)


def _fit_and_return(model, epochs, **kw):
    _fit(model, epochs, **kw)
    return model


def test_epoch_resume_with_scaler_is_bitwise(tmp_path):
    """2 epochs with a sync ``CheckpointSaver``, then a fresh model
    resumed for 2 more equals 4 straight epochs, the loss scale too; the
    checkpoint holds the optimizer's slots."""
    straight = _fit_and_return(_resume_model(0, False, scaler=True), 4)
    want = _state(straight)
    ck = str(tmp_path / 'ck')
    _fit(_resume_model(0, False, scaler=True), 2,
         callbacks=[tcb.CheckpointSaver(ck, save_freq=1)])
    state, meta = pt.resilience.CheckpointManager(ck).load()
    assert meta == {'epoch': 2, 'step_in_epoch': 0}
    assert any(k.endswith('.moment1') for k in state['opt'])
    assert set(state['rng']['dropout']) == {'bert.dropout_state'}
    resumed = _resume_model(1, False, scaler=True)
    _fit(resumed, 4, callbacks=[tcb.CheckpointSaver(ck)], resume_from=ck)
    _assert_bitwise(_state(resumed), want)
    # the eager step's slots share one pair of powers, made together and
    # made one again by the restore: a step advances each once
    for model in (straight, resumed):
        slots = model._optimizer._accumulators.values()
        assert len(slots) == len(list(model.network.parameters()))
        assert len({id(s['beta1_pow']) for s in slots}) == 1
        assert len({id(s['beta2_pow']) for s in slots}) == 1
    with pytest.warns(UserWarning, match='no loadable checkpoint'):
        _fit(_resume_model(1, False), 1,
             resume_from=str(tmp_path / 'empty'))


def test_resume_from_an_engine_fit_checkpoint(tmp_path):
    """``engine.fit`` trains epoch 1 and checkpoints; ``Model.fit(
    resume_from=)`` continues epoch 2 from it, on both paths, and equals
    a ``Model`` that trained both epochs (unshuffled, p = 0.1)."""
    data = TData(8, 2)
    batches = [((ids, tt, mask, pos), (lab, nsp)) for
               (ids, tt, mask, pos), (lab, nsp) in
               (tio.default_collate_fn([data[i] for i in range(j, j + 4)])
                for j in (0, 4))]
    straight = _resume_model(0, True)
    _fit(straight, 2, data=data, shuffle=False)
    want = _state(straight)
    for jit in (False, True):
        ck = str(tmp_path / f'engine{jit}')
        first = _resume_model(0, True)
        report = engine.fit(first.network, first.network.pretraining_loss,
                            topt.Adam(learning_rate=1e-3), batches,
                            checkpoint=ck, async_save=False, device='cpu')
        assert report['checkpoints'] == 1
        resumed = _resume_model(1, jit)
        _fit(resumed, 2, data=data, shuffle=False, resume_from=ck)
        got = _state(resumed)
        _assert_bitwise({k: v for k, v in got.items()
                         if not k.startswith('opt.global_step')},
                        {k: v for k, v in want.items()
                         if not k.startswith('opt.global_step')})
