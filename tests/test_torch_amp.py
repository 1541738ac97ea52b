"""``paddle_tpu_torch.amp`` against ``paddle_tpu.amp``: ``auto_cast`` O1 and
O2 at bf16 and fp16 on a 2-layer narrow ``BertForPretraining`` (hidden 64,
4 heads, batch 2 x 64, vocab 512, p = 0) on shared weights, the lists, and the
places where a cast output meets an fp32 tensor.

The reference off the TPU runs composed XLA attention and LayerNorm in the
low-precision arrays; the port runs its kernels' plain versions (fp32
statistics and accumulators). So the two land near each other and near
fp32, each by its own roundings. Gates, per run, over the largest logit:
port against reference at most 3e-3 (fp16) and 2e-2 (bf16) (observed
1.3e-3 / 1.7e-3 at fp16 O1 / O2, 9.3e-3 / 1.5e-2 at bf16); port against
the fp32 model no worse than 1.5 times the reference's own distance from
it; the loss within 2e-3 (fp16) and 1e-2 (bf16, one bf16 step is 4e-3)
relative. The dtypes of the logits and the NSP logits are the
reference's: under O1 the MLM logits are fp32 (the decoder's ``matmul``
is not cast and promotes), the NSP logits low precision; under O2 both
low precision. Gradients under O1 fp16: per tensor, over its largest entry
(floor 1e-3 of the model's largest), port against the reference at most
twice, and port against fp32 at most 1.5 times, the reference's own
distance from fp32 (observed: 0.021 and 0.0054 against the reference's
0.024; the port keeps its attention and LayerNorm statistics in fp32).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.layer_base import functional_call, param_values
from paddle_tpu.text.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.bert import BertForPretraining as JaxBertForPretraining

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.interop import (load_paddle_tpu_state,
                                      to_paddle_tpu_state)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.text.bert import BertConfig, BertForPretraining

SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=128)
TOL = {'float16': 3e-3, 'bfloat16': 2e-2}
LOSS_TOL = {'float16': 2e-3, 'bfloat16': 1e-2}
TORCH = {'float16': torch.float16, 'bfloat16': torch.bfloat16}


def _batch(seed=0, b=2, seq=64):
    rs = np.random.RandomState(seed)
    k = seq * 15 // 100
    x = {'input_ids': rs.randint(0, 512, (b, seq)).astype(np.int32),
         'token_type_ids': rs.randint(0, 2, (b, seq)).astype(np.int32),
         'masked_positions': np.stack(
             [rs.choice(seq, k, replace=False)
              for _ in range(b)]).astype(np.int32)}
    y = (rs.randint(0, 512, (b, k)).astype(np.int32),
         rs.randint(0, 2, (b, 1)).astype(np.int32))
    return x, y


@pytest.fixture(scope='module')
def models():
    paddle.seed(21)
    ref = JaxBertForPretraining(JaxBertConfig(**SMALL))
    ref.eval()
    params = param_values(ref, trainable_only=False)
    net = BertForPretraining(BertConfig(**SMALL), device='cpu').eval()
    load_paddle_tpu_state(net, {k: np.asarray(v) for k, v in params.items()})
    batch = _batch()
    return ref, net, params, batch, _jax_forward(ref, batch, 'O1', None)


def _jax_forward(ref, batch, level, dtype):
    """The reference's logits, loss and dtypes under ``auto_cast`` (the
    model through ``functional_call`` in one ``jax.jit``: the casts happen
    while it traces)."""
    x, y = batch

    def run(p):
        with jamp.auto_cast(enable=dtype is not None, level=level,
                            dtype=dtype or 'float32'):
            (logits, nsp), _ = functional_call(
                ref, p, JaxTensor(x['input_ids']),
                JaxTensor(x['token_type_ids']),
                masked_positions=JaxTensor(x['masked_positions']))
            loss = ref.pretraining_loss(logits, nsp, JaxTensor(y[0]),
                                        JaxTensor(y[1]))
        return logits._value, loss._value, nsp._value
    logits, loss, nsp = jax.jit(run)(param_values(ref, trainable_only=False))
    return (np.asarray(logits.astype(jnp.float32)), float(loss),
            str(logits.dtype), str(nsp.dtype))


def _port_forward(net, batch, level, dtype):
    x, y = batch
    feeds = {k: torch.from_numpy(v) for k, v in x.items()}
    with torch.no_grad(), tamp.auto_cast(enable=dtype is not None,
                                         level=level,
                                         dtype=dtype or 'float32'):
        logits, nsp = net(**feeds)
        loss = net.pretraining_loss(logits, nsp,
                                    *(torch.from_numpy(a) for a in y))
    return (logits.float().numpy(), float(loss),
            str(logits.dtype).replace('torch.', ''),
            str(nsp.dtype).replace('torch.', ''))


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("level", ['O1', 'O2'])
@pytest.mark.parametrize("dtype", ['float16', 'bfloat16'])
def test_auto_cast_bert_matches_reference(models, level, dtype):
    ref, net, _, batch, r32 = models
    if level == 'O2':
        ref, net = copy.deepcopy(ref), copy.deepcopy(net)
        assert jamp.decorate(models=ref, level='O2', dtype=dtype)[0] is ref
        assert tamp.decorate(models=net, level='O2', dtype=dtype)[0] is net
        assert all(p.dtype == TORCH[dtype] for p in net.parameters())
    r = _jax_forward(ref, batch, level, dtype)
    t = _port_forward(net, batch, level, dtype)
    assert t[2:] == r[2:], (t[2:], r[2:])
    assert t[2] == ('float32' if level == 'O1' else dtype)
    err, ref_err = _rel(t[0], r[0]), _rel(r[0], r32[0])
    assert err <= TOL[dtype], err
    assert _rel(t[0], r32[0]) <= 1.5 * ref_err, (_rel(t[0], r32[0]), ref_err)
    assert abs(t[1] - r[1]) <= LOSS_TOL[dtype] * abs(r[1]), (t[1], r[1])


def _errors(got, want):
    top = max(float(np.abs(w).max()) for w in want.values())
    return {k: float(np.abs(got[k] - w).max()) /
            max(float(np.abs(w).max()), 1e-3 * top)
            for k, w in want.items()}


def test_auto_cast_o1_fp16_gradients_match_reference(models):
    ref, net, params, (x, y), _ = models

    def jax_grads(amp_on):
        def loss_of(p):
            with jamp.auto_cast(enable=amp_on, level='O1', dtype='float16'):
                (logits, nsp), _ = functional_call(
                    ref, p, JaxTensor(x['input_ids']),
                    JaxTensor(x['token_type_ids']),
                    masked_positions=JaxTensor(x['masked_positions']))
                return ref.pretraining_loss(
                    logits, nsp, JaxTensor(y[0]), JaxTensor(y[1]))._value
        g = jax.jit(jax.grad(loss_of))(params)
        return {k: np.asarray(v, np.float32) for k, v in g.items()}

    def port_grads(amp_on):
        feeds = {k: torch.from_numpy(v) for k, v in x.items()}
        with tamp.auto_cast(enable=amp_on, level='O1', dtype='float16'):
            loss = net.pretraining_loss(*net(**feeds),
                                        *(torch.from_numpy(a) for a in y))
        loss.backward()
        for p in net.parameters():
            assert p.grad.dtype == torch.float32   # on the fp32 weights
        out = to_paddle_tpu_state(net, grads=True)
        net.zero_grad(set_to_none=True)
        return out
    ref16, ref32, port16 = jax_grads(True), jax_grads(False), port_grads(True)
    across = _errors(port16, ref16)
    port, own = _errors(port16, ref32), _errors(ref16, ref32)
    assert max(across.values()) <= 2 * max(own.values()), max(
        across.items(), key=lambda kv: kv[1])
    assert max(port.values()) <= 1.5 * max(own.values()), (
        max(port.values()), max(own.values()))


# ---------------------------------------------------------------------------
# the lists, maybe_cast_for, the casts' meeting points
# ---------------------------------------------------------------------------

def test_lists_match_reference():
    assert tamp.white_list == jamp.white_list
    assert tamp.black_list == jamp.black_list
    kw = dict(custom_white_list={'layer_norm', 'gelu'},
              custom_black_list={'matmul'}, custom_black_varnames={'w0'})
    ref, port = jamp.AutoMixedPrecisionLists(**kw), \
        tamp.AutoMixedPrecisionLists(**kw)
    assert (port.white_list, port.black_list, port.black_varnames) == \
        (ref.white_list, ref.black_list, ref.black_varnames)
    assert 'layer_norm' not in port.black_list and 'matmul' in \
        port.black_list
    for mod in (jamp, tamp):
        with pytest.raises(ValueError, match='both contain'):
            mod.AutoMixedPrecisionLists(custom_white_list={'exp'},
                                        custom_black_list={'exp'})
    assert tamp.amp_guard is tamp.auto_cast


def test_linear_casts_where_the_reference_casts():
    x = torch.from_numpy(np.random.RandomState(6).randn(3, 8)
                         .astype(np.float32))
    lin = tnn.Linear(8, 4, device='cpu')
    assert lin(x).dtype == torch.float32
    with tamp.auto_cast(dtype='float16'):
        assert lin(x).dtype == torch.float16
        # nested: an inner disabled auto_cast turns it off
        with tamp.auto_cast(enable=False):
            assert lin(x).dtype == torch.float32
        assert tamp.maybe_cast_for('exp', x)[0].dtype == torch.float32
    with tamp.auto_cast(dtype='bfloat16', custom_black_list={'matmul'}):
        assert lin(x).dtype == torch.float32
    with tamp.auto_cast(level='O2', dtype='float16'):
        # O2 casts every op's floating inputs; integers stay
        a, i = tamp.maybe_cast_for('anything', x, torch.arange(3))
        assert a.dtype == torch.float16 and i.dtype == torch.int64
    assert tamp.amp_enabled() is None
    # the bias follows the product's dtype, as the reference's
    w, b = (paddle.to_tensor(np.ones((8, 4), np.float32)),
            paddle.to_tensor(np.ones(4, np.float32)))
    with jamp.auto_cast(dtype='float16'):
        r = JF.linear(paddle.to_tensor(x.numpy()), w, b)
    with tamp.auto_cast(dtype='float16'):
        t = TF.linear(x, torch.ones(4, 8), torch.ones(4))
    assert str(r._value.dtype) == 'float16' and t.dtype == torch.float16
    # two fp16 steps: the reference rounds the product, then the sum with
    # the bias; torch's linear adds the bias before its one rounding
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(r._value, np.float32), rtol=2e-3,
                               atol=2e-3)


def test_add_layer_norm_of_a_cast_output_and_fp32_residual():
    # the post-norm epilogue under O1: an fp16 sublayer output and the fp32
    # residual. At p = 0 the port's fp32 kernel on the cast-up x is the
    # reference's composed dropout, fp32 add, LayerNorm
    rs = np.random.RandomState(5)
    x = rs.randn(6, 32, 64).astype(np.float32)
    res = rs.randn(6, 32, 64).astype(np.float32) * 2
    w, b = rs.randn(64).astype(np.float32), rs.randn(64).astype(np.float32)
    r = JF.fused_dropout_add_layer_norm(
        paddle.to_tensor(jnp.asarray(x).astype(jnp.float16)),
        paddle.to_tensor(res), paddle.to_tensor(w), paddle.to_tensor(b),
        dropout_p=0.0)
    t = TF.fused_dropout_add_layer_norm(
        torch.from_numpy(x).half(), torch.from_numpy(res),
        torch.from_numpy(w), torch.from_numpy(b))
    assert str(r._value.dtype) == 'float32' and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(r._value), rtol=1e-5,
                               atol=1e-5)
    # a LayerNorm of an fp16 input with fp32 parameters runs at fp16
    y = TF.layer_norm(torch.from_numpy(x).half(), 64, torch.from_numpy(w),
                      torch.from_numpy(b))
    assert y.dtype == torch.float16


def test_decorate_o1_is_a_no_op_and_o2_casts_parameters():
    net = tnn.LayerNorm(8, device='cpu')
    opt = object()
    assert tamp.decorate(optimizer=opt, level='O1') is opt
    assert tamp.decorate(opt, net, level='O1') == (net, opt)
    assert net.weight.dtype == torch.float32
    nets, got = tamp.decorate(opt, [net], level='O2', dtype='float16')
    assert got is opt and nets == [net] and net.weight.dtype == torch.float16
    with pytest.raises(ValueError, match='unknown dtype'):
        with tamp.auto_cast(dtype='int8'):
            pass
