"""The pre-norm encoder layer and rematerialisation.

``TransformerEncoderLayer(normalize_before=True)`` and a two-layer
``TransformerEncoder(norm=LayerNorm)`` against the JAX package's on copied
weights, fp32, p = 0: the output and every parameter's and the input's
gradient within 1e-5 of their largest value (the key biases', which are
rounding noise, within 1e-5 of the model's largest gradient entry).

``build_train_step(remat='full' | 'dots' | a policy)`` on a 2-layer narrow
BERT at p = 0.1 against the same steps without remat: gradients, losses
and the parameters after two steps bit for bit (the recompute replays the
dropout masks and the precision of the first forward), also under
``amp.auto_cast``; 'dots' keeps the attention outputs (one attention
forward a layer, where 'full' runs two); a loss that runs through no
encoder is checkpointed whole from its first call. The attention op that
'dots' keeps by name takes any 64-bit Philox seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.nn import LayerNorm as JaxLayerNorm
from paddle_tpu.nn import TransformerEncoder as JaxEncoder
from paddle_tpu.nn import TransformerEncoderLayer as JaxEncoderLayer
from paddle_tpu.nn.layer_base import functional_call, param_values

from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.engine import build_train_step
from paddle_tpu_torch.interop import load_paddle_tpu_state, \
    to_paddle_tpu_state
from paddle_tpu_torch.kernels import flash_attention
from paddle_tpu_torch.text.bert import BertConfig, BertForPretraining

D, H, FF, B, L = 32, 4, 64, 2, 16
TOL = 1e-5
SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=128, hidden_dropout_prob=0.1,
             attention_probs_dropout_prob=0.1)


def _ref_module(kind):
    paddle.seed(5)
    layer = JaxEncoderLayer(D, H, FF, dropout=0.0, activation='gelu',
                            normalize_before=True)
    if kind == 'layer':
        return layer
    return JaxEncoder(layer, 2, norm=JaxLayerNorm(D))


def _port_module(kind):
    layer = tnn.TransformerEncoderLayer(D, H, FF, dropout=0.0,
                                        activation='gelu',
                                        normalize_before=True, device='cpu')
    if kind == 'layer':
        return layer
    return tnn.TransformerEncoder(layer, 2, norm=tnn.LayerNorm(
        D, device='cpu'))


def _close(got, want, what, floor=1e-30):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= TOL * max(np.abs(want).max(), floor), (what, err)


@pytest.mark.parametrize("kind", ['layer', 'encoder'])
def test_pre_norm_matches_reference(kind):
    rs = np.random.RandomState(7)
    x = rs.randn(B, L, D).astype(np.float32)
    w = rs.randn(B, L, D).astype(np.float32)
    ref = _ref_module(kind)
    ref.train()
    params = {k: jnp.asarray(v) for k, v in
              param_values(ref, trainable_only=False).items()}

    def loss_of(p, xv):
        out, _ = functional_call(ref, p, JaxTensor(xv))
        return jnp.sum(out._value * w), out._value
    (_, want_out), (want_gp, want_gx) = jax.value_and_grad(
        loss_of, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    port = _port_module(kind).train()
    assert all(getattr(m, 'normalize_before', True)
               for m in port.modules()
               if isinstance(m, tnn.TransformerEncoderLayer))
    load_paddle_tpu_state(port, {k: np.asarray(v)
                                 for k, v in params.items()})
    xt = torch.tensor(x, requires_grad=True)
    out = port(xt)
    (out * torch.tensor(w)).sum().backward()
    _close(out.detach().numpy(), want_out, 'output')
    _close(xt.grad.numpy(), want_gx, 'input gradient')
    grads = to_paddle_tpu_state(port, grads=True)
    assert sorted(grads) == sorted(want_gp)
    # the key biases' true gradient is zero (softmax ignores a shift of a
    # row's scores): both sides hold rounding noise there, held to the
    # model's largest gradient entry
    top = max(float(np.abs(np.asarray(g)).max()) for g in want_gp.values())
    noise = {k for k, g in want_gp.items()
             if np.abs(np.asarray(g)).max() <= 1e-4 * top}
    assert noise and all(k.endswith('k_proj.bias') for k in noise)
    for k in grads:
        _close(grads[k], want_gp[k], k, floor=top if k in noise else 0.0)


def test_post_norm_path_is_unchanged():
    # the default stays post-norm through the fused add+LayerNorm
    layer = tnn.TransformerEncoderLayer(D, H, FF, dropout=0.0, device='cpu')
    assert layer.normalize_before is False
    x = torch.randn(B, L, D)
    out = layer(x)
    h = layer.norm1(x + layer.self_attn(x, x, x))
    ffn = layer.linear2(torch.relu(layer.linear1(h)))
    torch.testing.assert_close(out, layer.norm2(h + ffn), rtol=1e-5,
                               atol=1e-5)


def _batch(b=2, seq=128, seed=0):
    rs = np.random.RandomState(seed)
    k = seq * 15 // 100
    x = {'input_ids': rs.randint(0, 512, (b, seq)),
         'token_type_ids': np.zeros((b, seq), np.int64),
         'masked_positions': np.stack([rs.choice(seq, k, replace=False)
                                       for _ in range(b)])}
    y = (rs.randint(0, 512, (b, k)), rs.randint(0, 2, (b, 1)))
    return x, y


def _steps(remat, dtype=None, steps=2):
    net = BertForPretraining(BertConfig(**SMALL), device='cpu',
                             generator=torch.Generator().manual_seed(3))
    step = build_train_step(net=net, loss=net.pretraining_loss,
                            optimizer=topt.AdamW(learning_rate=1e-3),
                            remat=remat, device='cpu')
    state = step.init_state()
    losses = []
    for _ in range(steps):
        with amp.auto_cast(enable=dtype is not None, level='O1',
                           dtype=dtype or 'bfloat16'):
            state, res = step(state, _batch())
        losses.append(res.losses)
    return ([p.detach().clone() for p in net.parameters()],
            torch.stack(losses), net.dropout_state.offset, step)


@pytest.fixture(scope='module')
def plain_run():
    return {dt: _steps(None, dt) for dt in (None, 'bfloat16')}


def _policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket.__name__ ==
            'addmm' else CheckpointPolicy.PREFER_RECOMPUTE)


@pytest.mark.parametrize("dtype", [None, 'bfloat16'], ids=['fp32', 'O1'])
@pytest.mark.parametrize("remat", ['full', 'dots', _policy],
                         ids=['full', 'dots', 'policy'])
def test_remat_steps_are_bitwise_the_plain_steps(plain_run, remat, dtype):
    params0, losses0, offset0, _ = plain_run[dtype]
    params, losses, offset, step = _steps(remat, dtype)
    assert step.remat is not None and step.remat_by_layer
    assert step.remat.calls == 2 * 2            # two layers, two steps
    assert offset == offset0                     # the same masks drawn
    assert torch.equal(losses, losses0)
    assert all(torch.equal(a, b) for a, b in zip(params, params0))


def _grads(remat, calls):
    """One p = 0.1 forward and backward -> (the attention forwards the
    forward ran, every parameter's gradient)."""
    net = BertForPretraining(BertConfig(**SMALL), device='cpu',
                             generator=torch.Generator().manual_seed(3))
    x, y = _batch()
    feeds = {k: torch.from_numpy(v) for k, v in x.items()}
    with tnn.remat.scope(tnn.remat.resolve(remat)):
        loss = net.pretraining_loss(*net.train()(**feeds),
                                    *map(torch.from_numpy, y))
    forward_calls = len(calls)
    return forward_calls, torch.autograd.grad(loss, list(net.parameters()))


@pytest.mark.parametrize("remat,per_layer", [('full', 2), ('dots', 1)])
def test_dots_keeps_the_attention_outputs(remat, per_layer, monkeypatch):
    # the gradients bit for bit those without remat; 'dots' runs one
    # attention forward a layer, 'full' two
    calls = []
    real = flash_attention._forward

    def counting(*args):
        calls.append(1)
        return real(*args)
    monkeypatch.setattr(flash_attention, '_forward', counting)
    _, plain = _grads(None, calls)
    calls.clear()
    forward_calls, got = _grads(remat, calls)
    assert forward_calls == 2
    assert len(calls) == 2 * per_layer
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


def test_attention_op_takes_any_64_bit_seed():
    # the registered op's schema holds int64; a seed at or above 2**63 must
    # give the masks of the unsigned seed, forward and backward
    rs = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 16, 8).astype(np.float32))
               for _ in range(3))
    seed, offset = 2 ** 63 + 5, 3
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention.flash_attention_bhld(*leaves, dropout_p=0.1,
                                             seed=seed, offset=offset)
    do = torch.from_numpy(rs.randn(*o.shape).astype(np.float32))
    o.backward(do)
    ref, lse = flash_attention.flash_attention_forward(
        q, k, v, dropout_p=0.1, seed=seed, offset=offset)
    assert torch.equal(o, ref)
    grads = flash_attention.flash_attention_backward(
        q, k, v, ref, lse, do, dropout_p=0.1, seed=seed, offset=offset)
    assert all(torch.equal(t.grad, g) for t, g in zip(leaves, grads))


def test_a_loss_without_an_encoder_is_checkpointed_whole():
    # from the first call: the loss runs twice a step (forward, then the
    # recompute in the backward) and the forward keeps no activation
    torch.manual_seed(0)
    w = torch.nn.Parameter(torch.randn(8, 8))
    out = {}
    for remat in (None, 'full'):
        p = {'w': torch.nn.Parameter(w.detach().clone())}
        runs, kept = [], []

        def loss_fn(params, batch):
            runs.append(1)
            (x,) = batch
            return torch.tanh(x @ params['w']).pow(2).sum()

        def pack(t):
            kept.append(t.shape)
            return t
        step = build_train_step(loss_fn, topt.SGD(learning_rate=0.1),
                                params=p, remat=remat, device='cpu')
        assert not step.remat_by_layer
        state = step.init_state()
        for i in range(3):
            runs.clear()
            kept.clear()
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                state, _ = step(state, (torch.ones(4, 8) * (i + 1),))
            assert len(runs) == (2 if remat else 1)
            # the checkpoint keeps its inputs itself; no activation is
            # saved for the backward
            assert (kept == []) == bool(remat)
        out[remat] = p['w'].detach()
    assert torch.equal(out[None], out['full'])
    with pytest.raises(ValueError, match='remat'):
        build_train_step(loss_fn, topt.SGD(), params=p, remat='some',
                         device='cpu')
