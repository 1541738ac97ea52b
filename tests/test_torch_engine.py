"""The port's train step (``engine.build_train_step`` + ``optimizer.AdamW``)
against the JAX package's, on shared weights and one batch.

The reference side is ``jax.value_and_grad`` over ``functional_call`` and
``AdamW.functional_update`` — the train step of ``bench.py::bench_bert``,
at fp32; the port side is ``build_train_step(net=, loss=, optimizer=)``.
Both run a small ``BertForPretraining`` (2 layers, hidden 64, 4 heads,
L = 128, vocab 512) in eval mode, so ``p = 0``: the two packages draw other
dropout bits by construction (``test_torch_philox.py``). Tolerances, fp32:
three losses within 1e-5 relative; moments after step 3 within 1e-5 of
each tensor's largest entry plus 1e-5 of the largest entry of that slot
over the model (moment2 is of order g^2).

Weights after step 3 are held to 1e-5 absolute (0.3 % of the 3e-3 that
three steps at lr 1e-3 move a weight) tensor by tensor, on every element
whose reference gradient is above the noise floor in each of the three
steps: 1e-3 of its tensor's largest gradient entry and 1e-6 of the
model's. Adam's step ``m_hat / sqrt(v_hat)`` has size lr whatever the
gradient's size, so where a gradient (a sum of cancelling terms) is of the
size of its own rounding noise, another sign of the noise is another step,
and such an element can only be held to Adam's hard bound of 3 lr. The
elements below the floor that do differ by more than 1e-5 are counted per
tensor and may be one in a thousand of it (at least one). Observed here: 1
such element in the model, in ``layers.1.self_attn.k_proj.weight`` (4096
elements, |g| 1e-7 of the tensor's largest), and the worst element above
the floor differs by 4.0e-6. The key biases are the one kind of tensor
wholly below the floor (their true gradient is zero: softmax ignores a
shift of a row's scores; the reference's is 8e-9 of rounding noise), which
the test derives from the gradients, not from the names.
"""
import copy

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jax_opt
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.nn.layer_base import functional_call, param_values
from paddle_tpu.text.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.bert import BertForPretraining as JaxBertForPretraining

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.engine import (DeviceLoss, StepResult, TrainStep,
                                     build_train_step)
from paddle_tpu_torch.interop import (load_paddle_tpu_opt_state,
                                      load_paddle_tpu_state,
                                      to_paddle_tpu_opt_state,
                                      to_paddle_tpu_state)
from paddle_tpu_torch.text.bert import BertConfig, BertForPretraining

SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=128)
TOL = 1e-5
LR, DECAY = 1e-3, 0.01


def _batch(seed=0, b=4, seq=128):
    rs = np.random.RandomState(seed)
    k = seq * 15 // 100
    x = {'input_ids': rs.randint(0, 512, (b, seq)).astype(np.int32),
         'token_type_ids': np.zeros((b, seq), np.int32),
         'masked_positions': np.stack(
             [rs.choice(seq, k, replace=False)
              for _ in range(b)]).astype(np.int32)}
    y = (rs.randint(0, 512, (b, k)).astype(np.int32),
         rs.randint(0, 2, (b, 1)).astype(np.int32))
    return x, y


def _small(seed=0, train=False):
    net = BertForPretraining(BertConfig(**SMALL), device='cpu',
                             generator=torch.Generator().manual_seed(seed))
    return net.train() if train else net.eval()


def _close(got, want, what, floor=0.0):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) + floor
    assert np.abs(np.asarray(got) - want).max() <= TOL * scale, what


def test_three_adamw_steps_match_reference():
    paddle.seed(21)
    ref = JaxBertForPretraining(JaxBertConfig(**SMALL))
    ref.eval()
    x, y = _batch()
    params = param_values(ref, trainable_only=False)
    port = _small()
    load_paddle_tpu_state(port, {k: np.asarray(v) for k, v in params.items()})

    opt = jax_opt.AdamW(learning_rate=LR, weight_decay=DECAY)
    opt_state = opt.init_state_values(params)

    def loss_of(p):
        (logits, nsp), _ = functional_call(
            ref, p, JaxTensor(x['input_ids']), JaxTensor(x['token_type_ids']),
            masked_positions=JaxTensor(x['masked_positions']))
        return ref.pretraining_loss(logits, nsp, JaxTensor(y[0]),
                                    JaxTensor(y[1]))._value

    @jax.jit
    def ref_step(p, st):
        loss, grads = jax.value_and_grad(loss_of)(p)
        p, st = opt.functional_update(p, grads, st)
        return p, st, loss, grads

    step = build_train_step(
        net=port, loss=port.pretraining_loss,
        optimizer=topt.AdamW(learning_rate=LR, weight_decay=DECAY),
        device='cpu')
    state = step.init_state()
    ref_grads = []
    for i in range(3):
        params, opt_state, rloss, grads = ref_step(params, opt_state)
        ref_grads.append({k: np.abs(np.asarray(g)) for k, g in grads.items()})
        state, result = step(state, (x, y))
        assert isinstance(result, StepResult)
        assert abs(float(result.loss) - float(rloss)) <= \
            TOL * abs(float(rloss)), f'loss of step {i}'
    weights = to_paddle_tpu_state(port)
    moments = to_paddle_tpu_opt_state(port, state['opt'])
    assert sorted(weights) == sorted(params)
    assert sorted(moments) == sorted(opt_state)
    largest = {slot: max(float(np.abs(np.asarray(st[slot])).max())
                         for st in opt_state.values())
               for slot in ('moment1', 'moment2')}
    top_grad = max(float(g[k].max()) for g in ref_grads for k in g)
    all_noise = []
    for key in params:
        diff = np.abs(weights[key] - np.asarray(params[key]))
        assert diff.max() <= 3 * LR * 1.01, key
        least = np.minimum.reduce([g[key] for g in ref_grads])
        floor = max(1e-3 * max(float(g[key].max()) for g in ref_grads),
                    1e-6 * top_grad)
        sound = least >= floor
        if sound.any():
            assert diff[sound].max() <= TOL, key
            stragglers = int((diff[~sound] > TOL).sum())
            assert stragglers <= max(1, diff.size // 1000), (key, stragglers)
            # the floor leaves most of what has a gradient at all: a quarter
            # of the rarely hit embedding rows, three quarters elsewhere
            share = sound.sum() / (least > 0).sum()
            assert share >= (0.25 if 'embeddings' in key else 0.75), key
        else:
            all_noise.append(key)
        for slot in ('moment1', 'moment2'):
            _close(moments[key][slot], opt_state[key][slot],
                   f'{key}.{slot}', floor=largest[slot])
        for slot in ('beta1_pow', 'beta2_pow'):
            _close(moments[key][slot], opt_state[key][slot],
                   f'{key}.{slot}')
    assert all_noise == [f'bert.encoder.layers.{i}.self_attn.k_proj.bias'
                         for i in range(2)]
    # the state is the live model: updated in place, returned as given
    assert state['params']['cls.decoder_bias'] is port.cls.decoder_bias
    # and it goes back into a fresh optimizer state
    fresh = topt.AdamW().init_state_values(dict(port.named_parameters()))
    load_paddle_tpu_opt_state(
        port, fresh, {k: {s: np.asarray(v) for s, v in st.items()}
                      for k, st in opt_state.items()})
    for key in fresh:
        _close(fresh[key]['moment2'], state['opt'][key]['moment2'], key,
               floor=largest['moment2'])
        assert fresh[key]['beta1_pow'] == state['opt'][key]['beta1_pow']
    with pytest.raises(ValueError, match='missing keys'):
        load_paddle_tpu_opt_state(port, fresh, {})


def _closed_form_adamw(p, g, steps, lr, b1, b2, eps, coeff):
    m = v = 0.0
    for t in range(1, steps + 1):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        m_hat, v_hat = m / (1 - b1 ** t), v / (1 - b2 ** t)
        p = p - lr * m_hat / (np.sqrt(v_hat) + eps) - lr * coeff * p
    return p


@pytest.mark.parametrize("use_filter", [False, True])
def test_adamw_decay_follows_the_closed_formula(use_filter):
    # no filter: every parameter decays (the reference's functional rule);
    # a filter is honoured (the reference's functional rule ignores it)
    rs = np.random.RandomState(0)
    vals = {'w': rs.randn(3, 4), 'b': rs.randn(4)}
    grads = {k: rs.randn(*v.shape) for k, v in vals.items()}
    params = {k: torch.tensor(v, dtype=torch.float64)
              for k, v in vals.items()}
    fn = (lambda name: name != 'b') if use_filter else None
    opt = topt.AdamW(learning_rate=0.01, weight_decay=0.1,
                     apply_decay_param_fun=fn)
    state = opt.init_state_values(params)
    for _ in range(3):
        opt.functional_update(
            params, {k: torch.tensor(g) for k, g in grads.items()}, state)
    for k in vals:
        coeff = 0.0 if (use_filter and k == 'b') else 0.1
        want = _closed_form_adamw(vals[k], grads[k], 3, 0.01, 0.9, 0.999,
                                  1e-8, coeff)
        np.testing.assert_allclose(params[k].numpy(), want, rtol=1e-6,
                                   atol=1e-9)
        assert state[k]['beta1_pow'] == pytest.approx(0.9 ** 3, rel=1e-12)


def test_adam_l2_decay_and_untouched_parameters():
    p = {'a': torch.ones(3), 'b': torch.ones(3)}
    opt = topt.Adam(learning_rate=0.1, weight_decay=0.5)
    state = opt.init_state_values(p)
    opt.functional_update(p, {'a': torch.zeros(3), 'b': None}, state)
    # grad 0 + 0.5 * p: the first Adam step moves by lr * sign
    torch.testing.assert_close(p['a'], torch.full((3,), 0.9))
    assert torch.equal(p['b'], torch.ones(3))
    assert state['b']['beta1_pow'] == 1.0 and state['a']['beta1_pow'] < 1.0
    # schedulers, clips and amsgrad are ported (tests/test_torch_lr.py,
    # test_torch_optimizers.py); what is none of them is refused
    for bad in (dict(learning_rate=object()), dict(grad_clip=object()),
                dict(weight_decay=object())):
        with pytest.raises(TypeError):
            topt.Adam(**bad)
    assert topt.Adam(amsgrad=True)._amsgrad


@pytest.mark.parametrize("option", [
    dict(sharding=object()), dict(in_shardings=object())],
    ids=lambda o: next(iter(o)))
def test_unsupported_options_raise(option):
    net = _small()
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        build_train_step(net=net, loss=net.pretraining_loss,
                         optimizer=topt.AdamW(), device='cpu', **option)


@pytest.mark.parametrize("option", [
    dict(scaler=True), dict(nan_guard=True), dict(microbatch=2),
    dict(remat='full')], ids=lambda o: next(iter(o)))
def test_options_work(option):
    # once refused, now ported: two steps of the small model move its
    # weights and give finite losses (tests/test_torch_scaler_guard.py
    # holds each against the reference)
    from paddle_tpu_torch.amp import GradScaler
    if 'scaler' in option:
        option = dict(scaler=GradScaler())
    net = _small()
    step = build_train_step(net=net, loss=net.pretraining_loss,
                            optimizer=topt.AdamW(learning_rate=LR),
                            device='cpu', **option)
    state = step.init_state()
    x, y = _batch(b=2)
    k = option.get('microbatch', 1)
    if k > 1:
        x = {n: np.stack([v] * k) for n, v in x.items()}
        y = tuple(np.stack([v] * k) for v in y)
    before = net.cls.decoder_bias.detach().clone()
    for _ in range(2):
        state, result = step(state, (x, y))
    assert np.isfinite(float(result.loss))
    assert tuple(result.losses.shape) == ((k,) if k > 1 else ())
    assert (result.outputs is None) == (k > 1)
    assert not torch.equal(net.cls.decoder_bias.detach(), before)
    synced = step.sync(state)
    if 'nan_guard' in option:
        assert synced['guard']['steps'] == 2
    if 'scaler' in option:
        assert synced['scaler'] == {'scale': 2.0 ** 15, 'good': 2, 'bad': 0}


def test_builder_argument_errors_and_device():
    net = _small()
    opt = topt.AdamW()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_train_step(net=net, loss=net.pretraining_loss, optimizer=opt)
    with pytest.raises(ValueError, match='needs loss='):
        build_train_step(net=net, optimizer=opt, device='cpu')
    with pytest.raises(ValueError, match='not both'):
        build_train_step(lambda p, b: 0, opt, net=net,
                         loss=net.pretraining_loss, device='cpu')
    with pytest.raises(ValueError, match='optimizer is required'):
        build_train_step(net=net, loss=net.pretraining_loss, device='cpu')
    with pytest.raises(ValueError, match='needs params='):
        build_train_step(lambda p, b: 0, opt, device='cpu')
    with pytest.raises(ValueError, match='microbatch must be >= 1'):
        build_train_step(net=net, loss=net.pretraining_loss, optimizer=opt,
                         microbatch=0, device='cpu')
    with pytest.raises(ValueError, match='is on cpu'):
        TrainStep(lambda p, b: 0, opt, dict(net.named_parameters()), None,
                  torch.device('meta'))
    step = build_train_step(net=net, loss=net.pretraining_loss,
                            optimizer=opt, device='cpu')
    assert step.device == torch.device('cpu')


def test_loss_fn_form_trainable_filter_and_device_loss():
    w = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    frozen = torch.nn.Parameter(torch.tensor([3.0]))

    def loss_fn(params, batch):
        (x,) = batch
        pred = (params['w'] * x).sum() + params['frozen'].sum()
        return (pred - 1.0) ** 2, (pred,)
    step = build_train_step(loss_fn, topt.Adam(learning_rate=0.1),
                            params={'w': w, 'frozen': frozen},
                            trainable={'w'}, device='cpu')
    state = step.init_state()
    state2, result = step(state, (np.array([1.0, 1.0], np.float32),))
    assert state2 is state
    assert isinstance(result.loss, DeviceLoss) and not result.loss.is_ready()
    assert 'on device' in repr(result.loss)
    assert float(result.loss) == pytest.approx(25.0)
    assert result.loss.is_ready() and f'{result.loss:.1f}' == '25.0'
    assert result.losses.dim() == 0 and not result.losses.requires_grad
    assert float(result.outputs[0]) == pytest.approx(6.0)
    assert torch.equal(frozen.detach(), torch.tensor([3.0]))   # untouched
    torch.testing.assert_close(w.detach(), torch.tensor([0.9, 1.9]))
    # an empty filter updates nothing
    step0 = build_train_step(loss_fn, topt.Adam(), params={'w': w,
                                                           'frozen': frozen},
                             trainable=set(), device='cpu')
    before = w.detach().clone()
    step0(step0.init_state(), (np.array([1.0, 1.0], np.float32),))
    assert torch.equal(w.detach(), before)


def test_same_seed_gives_identical_training_steps():
    # dropout on (train mode): two models built from the same seed draw the
    # same weights and the same masks, step after step; another seed differs
    x, y = _batch(seed=3, b=2)

    def run(seed):
        net = _small(seed, train=True)
        step = build_train_step(
            net=net, loss=net.pretraining_loss,
            optimizer=topt.AdamW(learning_rate=LR, weight_decay=DECAY),
            device='cpu')
        state = step.init_state()
        losses = []
        for _ in range(3):
            state, r = step(state, (x, y))
            losses.append(float(r.loss))
        return losses, net
    (la, na), (lb, nb), (lc, _) = run(7), run(7), run(8)
    assert la == lb and la != lc
    assert all(torch.equal(a, b) for a, b in
               zip(na.state_dict().values(), nb.state_dict().values()))
    # dropout really is on: the eval loss of the same weights differs
    net = _small(7, train=True)
    feeds = {k: torch.from_numpy(v) for k, v in x.items()}
    with torch.no_grad():
        train_loss = net.pretraining_loss(*net(**feeds),
                                          *(torch.from_numpy(a) for a in y))
        eval_loss = net.eval().pretraining_loss(
            *net(**feeds), *(torch.from_numpy(a) for a in y))
    assert float(train_loss) != float(eval_loss)
    assert float(train_loss) == la[0]


def test_steps_lower_the_loss_on_a_fixed_batch():
    net = _small(1, train=True)
    step = build_train_step(net=net, loss=net.pretraining_loss,
                            optimizer=topt.AdamW(learning_rate=1e-3),
                            device='cpu')
    state = step.init_state()
    x, y = _batch(seed=4, b=2)
    losses = []
    for _ in range(6):
        state, r = step(state, (x, y))
        losses.append(float(r.loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    clone = copy.deepcopy(net)      # a copy carries its own dropout state
    assert clone.dropout_state is not net.dropout_state
    assert clone.dropout_state.offset == net.dropout_state.offset
