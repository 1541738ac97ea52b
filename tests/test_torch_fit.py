"""``paddle_tpu_torch.engine.fit`` against ``paddle_tpu.engine.fit``: a
2-layer narrow ``BertForPretraining`` at p = 0 on copied weights, ``Lamb``
under a ``LinearWarmup`` schedule with the global-norm clip and one
parameter at half the learning rate (``optimize_attr``), ``microbatch=2``,
4 steps in 2 calls. Every parameter after the run within 1e-4 of its
tensor's largest value; the report's ``steps``, ``dispatches`` and
logged-loss count equal, the logged losses within 1e-5 relative.

Lamb's step is sign-like (``m_hat / (sqrt(v_hat) + eps)``), so an element
whose gradient is of the size of its own rounding noise steps by the full
amount in a direction set by that noise. ``epsilon=1e-4`` keeps such
elements (|g| ~ 1e-8) in the linear range, where their step is negligible;
the tensors whose true gradient is zero (the attention key biases:
softmax ignores a shift of a row's scores), found from the gradients,
hold noise only and are held to 1e-6 absolute instead. The reference's
parameters are renamed to their module paths first: its cloned encoder
layers share their names, and its slots, kept by name between the two
``fit`` calls, would collide (a fault of the reference, ROADMAP.md,
Queue 3).

Also: every option ``fit`` does not port raises ``NotImplementedError``;
the guard and the scaler are reconciled; an odd-shaped batch and an
incomplete last group are dropped with a warning; keyword feeds; the
optimizer's state dict sees the run's slots and seeds the next run."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import engine as jax_engine
from paddle_tpu import optimizer as jax_opt
from paddle_tpu.nn import clip as jax_clip
from paddle_tpu.nn.layer_base import param_values
from paddle_tpu.text.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.bert import BertForPretraining as JaxBertForPretraining

from paddle_tpu_torch import engine
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.interop import load_paddle_tpu_state, \
    to_paddle_tpu_state
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.text.bert import BertConfig, BertForPretraining

SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=128, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)
HALF_LR = 'bert.encoder.layers.0.linear1.weight'


def _batches(n, b=2, seq=128, seed=0):
    """``n`` batches of positional feeds (ids, token types, an all-ones
    attention mask, masked positions) and labels."""
    rs = np.random.RandomState(seed)
    k = seq * 15 // 100
    out = []
    for _ in range(n):
        x = (rs.randint(0, 512, (b, seq)).astype(np.int32),
             np.zeros((b, seq), np.int32), np.ones((b, seq), np.int32),
             np.stack([rs.choice(seq, k, replace=False)
                       for _ in range(b)]).astype(np.int32))
        y = (rs.randint(0, 512, (b, k)).astype(np.int32),
             rs.randint(0, 2, (b, 1)).astype(np.int32))
        out.append((x, y))
    return out


def _schedule(lr_mod):
    return lr_mod.LinearWarmup(lr_mod.PolynomialDecay(2e-3, 6, 1e-4), 2,
                               5e-4, 2e-3)


def _port_model(seed=0):
    return BertForPretraining(BertConfig(**SMALL), device='cpu',
                              generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope='module')
def reference_run():
    paddle.seed(11)
    ref = JaxBertForPretraining(JaxBertConfig(**SMALL))
    # the encoder's cloned layers share their Parameter names, under which
    # the reference keeps its optimizer slots between fit calls (ROADMAP.md,
    # Queue 3): unique names, so that the second call continues each
    # layer's own slots, as the port (keyed by module path) does
    for key, p in ref.named_parameters():
        p.name = key
    init = {k: np.asarray(v) for k, v in
            param_values(ref, trainable_only=False).items()}
    dict(ref.named_parameters())[HALF_LR].optimize_attr['learning_rate'] = \
        0.5
    sched = _schedule(jax_opt.lr)
    opt = jax_opt.Lamb(learning_rate=sched, lamb_weight_decay=0.01,
                       epsilon=1e-4, grad_clip=jax_clip.ClipGradByGlobalNorm(
                           1.0))
    data = _batches(4)
    reports = []
    for half in (data[:2], data[2:]):
        reports.append(jax_engine.fit(ref, ref.pretraining_loss, opt, half,
                                      microbatch=2, log_every=1))
        sched.step()
    final = {k: np.asarray(v) for k, v in
             param_values(ref, trainable_only=False).items()}
    return init, final, reports


def test_fit_matches_reference(reference_run):
    init, want, ref_reports = reference_run
    port = _port_model()
    load_paddle_tpu_state(port, init)
    dict(port.named_parameters())[HALF_LR].optimize_attr = \
        {'learning_rate': 0.5}
    # the tensors with no true gradient, from the first batch's gradients
    x, y = _batches(1)[0]
    loss = port.pretraining_loss(*port(*map(torch.from_numpy, x)),
                                 *map(torch.from_numpy, y))
    named = dict(port.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    top = max(float(g.abs().max()) for g in grads.values())
    noise = {n for n, g in grads.items() if float(g.abs().max()) <= 1e-6 * top}
    assert noise == {f'bert.encoder.layers.{i}.self_attn.k_proj.bias'
                     for i in range(2)}
    sched = _schedule(topt.lr)
    opt = topt.Lamb(learning_rate=sched, lamb_weight_decay=0.01,
                    epsilon=1e-4, grad_clip=ClipGradByGlobalNorm(1.0))
    data = _batches(4)
    reports = []
    for half in (data[:2], data[2:]):
        reports.append(engine.fit(port, port.pretraining_loss, opt, half,
                                  microbatch=2, log_every=1, device='cpu'))
        sched.step()
    for got, ref in zip(reports, ref_reports):
        for key in ('steps', 'dispatches', 'microbatch', 'checkpoints',
                    'resumed_from', 'preempted'):
            assert got[key] == ref[key], key
        assert len(got['loss']) == len(ref['loss']) == 1
        np.testing.assert_allclose(got['loss'], ref['loss'], rtol=1e-5)
        assert got['steps'] == 2 and got['steps_per_sec'] > 0
    assert reports[1]['loss'][0] < reports[0]['loss'][0]
    got = to_paddle_tpu_state(port)
    assert sorted(got) == sorted(want)
    for k in want:
        err = np.abs(got[k] - want[k]).max()
        if k in noise:
            assert err <= 1e-6, k
        else:
            assert err <= 1e-4 * np.abs(want[k]).max(), (k, err)
        assert not np.array_equal(want[k], init[k]), k
    # the optimizer's slots are the run's (write_back_state)
    sd = opt.state_dict()
    assert f'{HALF_LR}.moment1' in sd and sd['LR_Scheduler']['last_epoch'] \
        == 2


@pytest.mark.parametrize("option", [
    dict(checkpoint='ckpt'), dict(resume_from='ckpt'), dict(world=2),
    dict(rank=0), dict(sharding=object()), dict(serve_artifacts='art'),
    dict(serve_generative=object())], ids=lambda o: next(iter(o)))
def test_unported_options_raise(option):
    net = _port_model()
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        engine.fit(net, net.pretraining_loss, topt.SGD(), _batches(1),
                   device='cpu', **option)


def test_guard_scaler_prefetch_and_dropped_batches():
    net = _port_model(1)
    opt = topt.AdamW(learning_rate=1e-3)
    data = _batches(5)
    odd = _batches(1, seq=64, seed=3)[0]
    scaler = GradScaler(init_loss_scaling=2.0 ** 10)
    with pytest.warns(RuntimeWarning, match='dropped 2 batch'):
        rep = engine.fit(net, net.pretraining_loss, opt,
                         data[:2] + [odd] + data[2:], microbatch=2,
                         log_every=2, nan_guard=True, scaler=scaler,
                         prefetch=2, remat='full', donate=True,
                         matmul_precision='highest', device='cpu')
    assert rep['dispatches'] == 2 and rep['steps'] == 4
    assert len(rep['loss']) == 2 and rep['donated'] is False
    assert scaler._good_steps == 4
    assert np.isfinite(rep['loss']).all()
    # keyword feeds and a second run seeded from the first one's slots
    kw_data = [({'input_ids': x[0], 'token_type_ids': x[1],
                 'masked_positions': x[3]}, y) for x, y in data[:2]]
    before = {k: v.clone() for k, v in
              opt._accumulators['cls.decoder_bias'].items()}
    rep2 = engine.fit(net, net.pretraining_loss, opt, kw_data, epochs=2,
                      prefetch=0, log_every=3, device='cpu')
    assert rep2['dispatches'] == 4 and len(rep2['loss']) == 2
    m1 = rep2['state']['opt']['cls.decoder_bias']['moment1']
    assert not torch.equal(m1, before['moment1'])
    assert float(rep2['state']['opt']['cls.decoder_bias']['beta1_pow']) == \
        pytest.approx(0.9 ** 8, rel=1e-5)


def test_reference_fault_cloned_layers_share_optimizer_slots():
    """The reference's encoder clones its first layer, and the clones keep
    its Parameter names; the eager optimizer keeps its slots by name
    (``_param_state``, and ``fit`` between calls), so every layer's copy of
    a parameter shares one slot (ROADMAP.md, Queue 3). The port keys its
    slots by module path."""
    paddle.seed(12)
    ref = JaxBertForPretraining(JaxBertConfig(**SMALL))
    named = dict(ref.named_parameters())
    a = named['bert.encoder.layers.0.linear1.weight']
    b = named['bert.encoder.layers.1.linear1.weight']
    assert a.name == b.name
    opt = jax_opt.Momentum(parameters=list(named.values()))
    (ka, sa), (kb, sb) = opt._param_state(a), opt._param_state(b)
    assert ka == kb and sa is sb              # two layers, one velocity
    port = _port_model()
    popt = topt.Momentum(parameters=port.named_parameters())
    for _, p in popt._parameters:
        p.grad = torch.ones_like(p)
    popt.step()
    assert len(popt._accumulators) == len(list(port.parameters()))
