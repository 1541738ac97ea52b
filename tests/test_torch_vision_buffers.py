"""BatchNorm's running statistics in the port's train step against the
reference's ``engine.build_train_step``, on the CPU, on a conv +
BatchNorm net on the reference's weights (Momentum).

- Three steps with one poisoned batch under ``nan_guard=True`` and,
  separately, one ``GradScaler`` step whose scaled gradients overflow:
  the parameters and the running statistics after each step within 1e-5,
  and the skipped steps leave every buffer bitwise as it was.
- ``microbatch=2`` (the reference's three-argument ``loss_fn`` form on
  both sides) carries them: equal to the reference's and bitwise to two
  one-microbatch calls.
- An ``engine.fit`` checkpoint resumes with them: bitwise the
  uninterrupted port run and within 1e-5 of the reference's two-epoch
  ``fit``.
- ``adopt_state`` and ``interop.from_paddle_tpu_train_state`` take them;
  a model without buffers has none in its state.

Also ``LeNet`` through ``hapi.Model.fit`` on the synthetic MNIST (the
first 48 test samples, batch 16, unshuffled, Momentum): each step's loss
within 1e-5 of the reference's ``Model.fit(jit=True)``; and ``hapi.Model``'s
eager ``train_batch`` / ``eval_batch`` / ``predict_batch`` on the conv +
BatchNorm net, which switch BatchNorm's mode as the reference's do: the
losses, outputs and running statistics within 1e-5, eval and predict
leaving the statistics as they were.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu.vision as jvision
from paddle_tpu import amp as jamp
from paddle_tpu import engine as jengine
from paddle_tpu import hapi as jhapi
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Tensor as JT
from paddle_tpu.nn.layer_base import (buffer_values, functional_call,
                                      param_values)

import paddle_tpu_torch as pt
import paddle_tpu_torch.vision as tvision
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import engine as tengine
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.interop import (from_paddle_tpu_train_state,
                                      load_paddle_tpu_state,
                                      to_paddle_tpu_state)
from paddle_tpu_torch.nn import functional as TF

LOSS_TOL = 1e-5


def _state(ref, seed):
    """The reference's state with its running statistics moved off their
    zeros and ones (a swap of the two would pass otherwise)."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in ref.state_dict().items():
        v = np.asarray(v.numpy())
        if k.endswith('_mean'):
            v = (0.1 * rs.randn(*v.shape)).astype(np.float32)
        elif k.endswith('_variance'):
            v = (1 + 0.2 * rs.rand(*v.shape)).astype(np.float32)
        out[k] = v
    return out


def _ref_with(ref, state):
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    return ref


# ---------------------------------------------------------------------------
# BatchNorm's buffers in the train step
# ---------------------------------------------------------------------------

def _bn_net(side, **kw):
    return side.Sequential(side.Conv2D(3, 4, 3, padding=1, **kw),
                           side.BatchNorm2D(4, **kw), side.ReLU(),
                           side.Flatten(), side.Linear(4 * 5 * 5, 3, **kw))


def _bn_pair(seed):
    paddle.seed(seed)
    ref = _bn_net(jnn)
    state = _state(ref, seed)
    _ref_with(ref, state)
    port = _bn_net(tnn, device='cpu')
    load_paddle_tpu_state(port, state)
    return ref, port


def _bn_batches(n, seed, poison_at=None, b=4, poison=np.inf):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        x = (rs.randn(b, 3, 5, 5) * 2 + 1).astype(np.float32)
        y = rs.randint(0, 3, b).astype(np.int64)
        p = np.float32(poison if i == poison_at else 1.0)
        out.append((x, y, p))
    return out


def _ref_bn_loss(ref):
    def loss_fn(params, buffers, batch, key):
        x, y, p = batch
        out, new = functional_call(ref, {**params, **buffers}, JT(x))
        loss = JF.cross_entropy(out, JT(y))._value * p
        return loss, (out._value,), new
    return loss_fn


def _ref_steps(ref, batches, **kw):
    opt = jopt.Momentum(learning_rate=0.1, momentum=0.9)
    scaler = kw.pop('scaler', None)
    step = jengine.build_train_step(_ref_bn_loss(ref), opt, scaler=scaler,
                                    **kw)
    state = step.init_state(param_values(ref, False), buffer_values(ref))
    history = []
    for batch in batches:
        state, _ = step(state, tuple(jnp.asarray(a) for a in batch))
        history.append(({k: np.asarray(v) for k, v in
                         state['params'].items()},
                        {k: np.asarray(v) for k, v in
                         state['buffers'].items()}))
    return history


class _PoisonLoss(torch.nn.Module):
    def forward(self, out, y, p):
        return TF.cross_entropy(out, y) * p


def _port_history(port, step, state, batches):
    history = []
    for x, y, p in batches:
        before = {k: v.clone() for k, v in state['buffers'].items()}
        state, _ = step(state, ((torch.from_numpy(x),),
                                (torch.from_numpy(y), torch.tensor(p))))
        history.append((to_paddle_tpu_state(port), before,
                        {k: v.clone() for k, v in state['buffers'].items()}))
    return history, state


def _held(history, ref_history, skipped):
    for i, ((pstate, before, after), (rparams, rbufs)) in enumerate(
            zip(history, ref_history)):
        for k, v in rparams.items():
            np.testing.assert_allclose(pstate[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=f'step {i} {k}')
        for k, v in rbufs.items():
            np.testing.assert_allclose(after[k].numpy(), v, rtol=1e-5,
                                       atol=1e-6, err_msg=f'step {i} {k}')
            if i in skipped:
                assert torch.equal(after[k], before[k]), (i, k)
            else:
                assert not torch.equal(after[k], before[k]), (i, k)


def test_guarded_step_keeps_the_buffers_as_reference():
    ref, port = _bn_pair(20)
    batches = _bn_batches(3, 21, poison_at=1)
    ref_history = _ref_steps(ref, batches, nan_guard=True)
    step = tengine.build_train_step(
        net=port, loss=_PoisonLoss(), optimizer=topt.Momentum(
            learning_rate=0.1, momentum=0.9), nan_guard=True, device='cpu')
    state = step.init_state()
    assert sorted(state['buffers']) == ['1._mean', '1._variance']
    history, state = _port_history(port, step, state, batches)
    _held(history, ref_history, skipped={1})
    assert step.sync(state)['guard']['skipped'] == 1


def test_overflowed_scaler_step_keeps_the_buffers_as_reference():
    ref, port = _bn_pair(22)
    # a finite loss of ~1e30 whose scaled gradients overflow
    batches = _bn_batches(2, 23, poison_at=0, poison=1e30)
    kw = dict(init_loss_scaling=2.0 ** 40, decr_every_n_nan_or_inf=1)
    ref_history = _ref_steps(ref, batches, scaler=jamp.GradScaler(**kw))
    step = tengine.build_train_step(
        net=port, loss=_PoisonLoss(), optimizer=topt.Momentum(
            learning_rate=0.1, momentum=0.9),
        scaler=tamp.GradScaler(**kw), device='cpu')
    history, state = _port_history(port, step, step.init_state(), batches)
    _held(history, ref_history, skipped={0})


def test_microbatch_two_carries_the_buffers_as_reference():
    """The reference's three-argument ``loss_fn`` form on both sides, one
    call of two microbatches: equal to the reference's and bitwise to two
    one-microbatch calls."""
    ref, port = _bn_pair(24)
    batches = _bn_batches(2, 25)
    stacked = tuple(np.stack([b[i] for b in batches]) for i in range(3))
    ref_history = _ref_steps(ref, [stacked], microbatch=2)
    init = {k: v.clone() for k, v in port.state_dict().items()}

    def loss_fn(params, buffers, batch):
        x, y, p = batch
        out = torch.func.functional_call(port, {**params, **buffers}, (x,))
        return TF.cross_entropy(out, y) * p, (out,), buffers

    def build(k):
        return tengine.build_train_step(
            loss_fn, topt.Momentum(learning_rate=0.1, momentum=0.9),
            params=dict(port.named_parameters()),
            buffers=tengine.builder.persistent_buffers(port), microbatch=k,
            device='cpu')
    step = build(2)
    state, _ = step(step.init_state(), tuple(torch.from_numpy(a)
                                             for a in stacked))
    got = to_paddle_tpu_state(port)
    for k, v in {**ref_history[0][0], **ref_history[0][1]}.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    port.load_state_dict(init)
    step1 = build(1)
    st = step1.init_state()
    for b in batches:
        st, _ = step1(st, tuple(torch.as_tensor(a) for a in b))
    for k, v in to_paddle_tpu_state(port).items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)


def test_fit_checkpoint_resumes_with_the_running_stats(tmp_path):
    """``engine.fit`` one epoch with a checkpoint, then a fresh net resumed
    from it for the second: bitwise the uninterrupted two-epoch run, and
    within 1e-5 of the reference's two-epoch ``fit`` (parameters and
    running statistics)."""
    ref, port = _bn_pair(26)
    init = to_paddle_tpu_state(port)
    data = [((x,), (y,)) for x, y, _ in _bn_batches(3, 27)]
    jengine.fit(ref, jnn.CrossEntropyLoss(),
                jopt.Momentum(learning_rate=0.1, momentum=0.9,
                              parameters=ref.parameters()),
                data, epochs=2, log_every=1)
    want = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}

    def run(epochs, net=None, **kw):
        net = net or _bn_net(tnn, device='cpu')
        load_paddle_tpu_state(net, init)
        tengine.fit(net, tnn.CrossEntropyLoss(),
                    topt.Momentum(learning_rate=0.1, momentum=0.9,
                                  parameters=net.parameters()),
                    data, epochs=epochs, log_every=1, device='cpu', **kw)
        return net
    whole = to_paddle_tpu_state(run(2))
    run(1, checkpoint=str(tmp_path / 'ck'), async_save=False)
    resumed = run(2, checkpoint=str(tmp_path / 'ck'), async_save=False)
    got = to_paddle_tpu_state(resumed)
    assert not np.array_equal(got['1._mean'], init['1._mean'])
    for k, v in whole.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_adopt_state_and_interop_take_the_buffers():
    ref, port = _bn_pair(28)
    step = tengine.build_train_step(
        net=port, loss=tnn.CrossEntropyLoss(),
        optimizer=topt.Momentum(learning_rate=0.1), device='cpu')
    rstep = jengine.build_train_step(
        _ref_bn_loss(ref), jopt.Momentum(learning_rate=0.1))
    rstate = rstep.init_state(param_values(ref, False), buffer_values(ref))
    rstate = {k: ({n: np.asarray(v) if not isinstance(v, dict) else
                   {s: np.asarray(t) for s, t in v.items()}
                   for n, v in val.items()} if isinstance(val, dict)
                  else val) for k, val in rstate.items()}
    rstate['buffers']['1._mean'] = np.full(4, 0.25, np.float32)
    moved = from_paddle_tpu_train_state(port, rstate)
    live = step.adopt_state(moved)
    assert torch.equal(port[1]._mean, torch.full((4,), 0.25))
    assert live['buffers']['1._mean'] is port[1]._mean
    bad = dict(moved, buffers={'1._mean': np.zeros(5, np.float32),
                               '1._variance': np.ones(4, np.float32)})
    with pytest.raises(ValueError):
        step.adopt_state(bad)
    plain = tengine.build_train_step(
        net=tnn.Linear(2, 2, device='cpu'), loss=tnn.MSELoss(),
        optimizer=topt.SGD(learning_rate=0.1), device='cpu')
    assert 'buffers' not in plain.init_state()


# ---------------------------------------------------------------------------
# LeNet through hapi.Model.fit on synthetic MNIST
# ---------------------------------------------------------------------------

class _First:
    def __init__(self, data, n):
        self.data, self.n = data, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.data[i]


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            loss = logs['loss']
            self.losses.append(float(loss[0] if isinstance(
                loss, (list, tuple)) else loss))
    return Recorder()


def test_lenet_hapi_fit_on_synthetic_mnist_matches_reference():
    paddle.seed(17)
    ref = jvision.LeNet()
    init = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    jdata = _First(jvision.datasets.MNIST(mode='test'), 48)
    tdata = _First(tvision.datasets.MNIST(mode='test'), 48)
    assert tdata.data.synthetic and jdata.data.synthetic
    model = jhapi.Model(ref)
    model.prepare(jopt.Momentum(learning_rate=0.05, momentum=0.9,
                                parameters=ref.parameters()),
                  jnn.CrossEntropyLoss(), jit=True)
    rrec = _recorder(jhapi.callbacks.Callback)
    model.fit(jdata, batch_size=16, epochs=1, shuffle=False, verbose=0,
              callbacks=[rrec])
    port = tvision.LeNet(device='cpu')
    load_paddle_tpu_state(port, init)
    tmodel = pt.Model(port, device='cpu')
    tmodel.prepare(topt.Momentum(learning_rate=0.05, momentum=0.9,
                                 parameters=port.parameters()),
                   tnn.CrossEntropyLoss(), jit=True)
    trec = _recorder(tcb.Callback)
    tmodel.fit(tdata, batch_size=16, epochs=1, shuffle=False, verbose=0,
               callbacks=[trec])
    assert len(trec.losses) == len(rrec.losses) == 3
    np.testing.assert_allclose(trec.losses, rrec.losses, rtol=LOSS_TOL)




def test_hapi_switches_batchnorm_mode_as_reference():
    ref, port = _bn_pair(30)
    x, y, _ = _bn_batches(1, 31)[0]
    model = jhapi.Model(ref)
    model.prepare(jopt.SGD(learning_rate=0.1, parameters=ref.parameters()),
                  jnn.CrossEntropyLoss())
    tmodel = pt.Model(port, device='cpu')
    tmodel.prepare(topt.SGD(learning_rate=0.1, parameters=port.parameters()),
                   tnn.CrossEntropyLoss())
    rloss, _ = model.train_batch([x], [y])
    tloss, _ = tmodel.train_batch([x], [y])
    np.testing.assert_allclose(tloss, rloss, rtol=1e-5)
    assert port.training and ref.training

    def stats(side):
        if side == 'port':
            return {k: v.numpy().copy() for k, v in port.state_dict().items()
                    if k.endswith(('_mean', '_variance'))}
        return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()
                if k.endswith(('_mean', '_variance'))}
    after = stats('port')
    for k, v in stats('ref').items():
        np.testing.assert_allclose(after[k], v, rtol=1e-5, atol=1e-6)
    reval, _ = model.eval_batch([x], [y])
    teval, _ = tmodel.eval_batch([x], [y])
    np.testing.assert_allclose(teval, reval, rtol=1e-5)
    assert not port.training and not ref.training
    rout = model.predict_batch([x])
    tout = tmodel.predict_batch([x])
    np.testing.assert_allclose(tout[0], np.asarray(rout[0]), rtol=1e-5,
                               atol=1e-6)
    for k, v in stats('port').items():
        np.testing.assert_array_equal(v, after[k])
