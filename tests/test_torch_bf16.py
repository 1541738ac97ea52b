"""bf16 in the port: the plain versions of the six kernels against the JAX
package's Pallas kernels at bf16, the layers and BERT under bf16
parameters, and the reference's bf16 training recipe.

On the CPU each port wrapper runs its kernel's plain version; the JAX side
runs the Pallas kernel bodies in interpret mode (``jax.grad`` through their
``custom_vjp`` for gradients), as the JAX package's own kernel tests run
them. The same numpy inputs, cast to bf16 on each side (round to nearest
even on both), go to both.

Tolerances. A bf16 output or gradient of a kernel: 1e-2 of its largest
absolute value. Both sides compute in fp32 and round at the same points —
the output, and P, P dropped and dS before the attention products — so
they differ by one bf16 step (2^-8 relative) where sums taken in another
order straddle a rounding boundary, and by that step again where a rounded
P or dS feeds a product (observed at most 4.1e-3 of the max for outputs,
4.8e-3 for attention gradients; the LayerNorm and add+LayerNorm gradients
came out identical). fp32 statistics (``lse``, ``mean``,
``rstd``): 1e-5 relative, the order of summation only.

The model. A 2-layer narrow ``BertForPretraining`` run with
``bench.py::bench_bert``'s recipe — every fp32 parameter cast to bf16
inside the loss, the model through ``functional_call``, the loss on fp32
logits — is held to the same recipe in the JAX package on shared weights,
and to the port's own fp32 step. Rounding compounds over the layers, and
the two frameworks round elsewhere outside the kernels too (the JAX side
runs composed XLA attention and LayerNorm in bf16 on the CPU, with bf16
scores and bf16 reductions), so the gates are per tensor, over each
gradient's largest value (with a floor of 1e-3 of the model's largest):
against fp32 at most 0.1 and on average 0.03 (observed 0.047 and 0.014),
no worse than the JAX package's own bf16 recipe is against its fp32 one
(observed 0.089 and 0.020); against the JAX bf16 recipe at most 0.15
(observed 0.078); losses within 2e-3 relative (observed 7e-4).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.kernels import fused_dropout_norm as jfdn
from paddle_tpu.kernels.fused_norm import _ln_forward as jax_ln_forward
from paddle_tpu.kernels.fused_norm import fused_layer_norm as jax_ln
from paddle_tpu.nn.layer_base import functional_call, param_values
from paddle_tpu.text.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.bert import BertForPretraining as JaxBertForPretraining

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.engine import build_train_step
from paddle_tpu_torch.interop import (load_paddle_tpu_state,
                                      to_paddle_tpu_state)
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import fused_dropout_norm as tfdn
from paddle_tpu_torch.kernels import fused_norm as tfn
from paddle_tpu_torch.kernels import philox
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.text.bert import BertConfig, BertForPretraining

BF = torch.bfloat16
TOL = 1e-2
STAT_TOL = 1e-5


def _rand(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(a).to(BF)


def _j(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, what, tol=TOL):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err)


def _stats_close(got, want, what):
    np.testing.assert_allclose(_np32(got), _np32(want).reshape(
        _np32(got).shape), rtol=STAT_TOL, atol=STAT_TOL, err_msg=what)


def _cos_loss(y):
    yf = y.float()
    return (yf * torch.cos(yf)).sum()


def _jcos_loss(y):
    yf = y.astype(jnp.float32)
    return jnp.sum(yf * jnp.cos(yf))


# ---------------------------------------------------------------------------
# LayerNorm and dropout + add + LayerNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_bf16_matches_pallas(affine):
    x = _rand(0, 48, 256, scale=2.0, shift=0.5)
    w = _rand(1, 256, scale=0.2, shift=1.0) if affine else None
    b = _rand(2, 256) if affine else None
    args = [x] + ([w, b] if affine else [])
    ja = [_j(a) for a in args]
    ry, rmean, rrstd = jax_ln_forward(ja[0], *(ja[1:] if affine
                                               else (None, None)), 1e-5, True)
    ts = [_t(a).requires_grad_() for a in args]
    y, mean, rstd = tfn.layer_norm_stats(ts[0], *(ts[1:] if affine
                                                  else (None, None)), 1e-5)
    assert y.dtype == BF and mean.dtype == rstd.dtype == torch.float32
    _close(y, ry, 'y')
    _stats_close(mean, rmean, 'mean')
    _stats_close(rstd, rrstd, 'rstd')
    ref = jax.grad(lambda *a: _jcos_loss(jax_ln(
        a[0], *(a[1:] if affine else (None, None)), eps=1e-5,
        interpret=True)), argnums=tuple(range(len(args))))(
            *(_j(a) for a in args))
    out = tfn.fused_layer_norm(ts[0], *(ts[1:] if affine else (None, None)),
                               1e-5)
    assert out.dtype == BF
    _cos_loss(out).backward()
    for t, r, name in zip(ts, ref, ('dx', 'dw', 'db')):
        assert t.grad.dtype == BF
        _close(t.grad, r, name)


@pytest.mark.parametrize("affine", [True, False])
def test_add_layer_norm_bf16_matches_pallas(affine):
    # the statistics come from the fp32 sum, y and yin are rounded to bf16,
    # and the backward forms xhat from the rounded yin (_fdln_bwd)
    x, res = _rand(3, 48, 256), _rand(4, 48, 256, scale=2.0)
    w = _rand(5, 256, scale=0.2, shift=1.0) if affine else None
    b = _rand(6, 256) if affine else None
    args = [x, res] + ([w, b] if affine else [])
    wb = lambda a: a[2:] if affine else (None, None)   # noqa: E731
    outs = jfdn._fused_fwd(*(_j(a) for a in args[:2]),
                           *(_j(a) if a is not None else None
                             for a in wb(args)),
                           jnp.zeros((1, 1), jnp.int32), 1e-5, 0.0, True)
    ts = [_t(a).requires_grad_() for a in args]
    got = tfdn._plain_stats(ts[0], ts[1], *wb(ts), 0.0, 1e-5, None, None)
    for g_, r_, name in zip(got, outs, ('y', 'yin', 'mean', 'rstd')):
        if name in ('y', 'yin'):
            assert g_.dtype == BF
            _close(g_, r_, name)
        else:
            assert g_.dtype == torch.float32
            _stats_close(g_, r_, name)
    # yin is the fp32 sum rounded once; the mean is of the fp32 sum itself
    total = ts[1].detach().float() + ts[0].detach().float()
    assert torch.equal(got[1], total.to(BF))
    torch.testing.assert_close(got[2], total.mean(-1), rtol=1e-6, atol=1e-6)
    ref = jax.grad(lambda *a: _jcos_loss(jfdn.fused_dropout_add_layer_norm(
        a[0], a[1], *(a[2:] if affine else (None, None)), dropout_p=0.0,
        interpret=True)), argnums=tuple(range(len(args))))(
            *(_j(a) for a in args))
    y = tfdn.fused_dropout_add_layer_norm(ts[0], ts[1], *wb(ts))
    _cos_loss(y).backward()
    for t, r, name in zip(ts, ref, ('dx', 'dres', 'dw', 'db')):
        assert t.grad.dtype == BF
        _close(t.grad, r, name)


def test_dropout_mask_gradient_bf16_is_the_reference_arithmetic():
    # the reference's _dmask_kernel: g.astype(f32) * keep / (1 - p), cast
    # to g's dtype; with the port's Philox mask (the reference's interpret
    # mode has no random bits) the two agree bit for bit
    p, seed, offset = 0.1, 0x1234567890ABCDEF, 5
    g = _rand(7, 64, 256, scale=3.0)
    keep = philox.keep_mask(g.shape, p, seed, offset).numpy()
    want = (jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32)
            * (keep.astype(np.float32) / (1.0 - p))).astype(jnp.bfloat16)
    got = tfdn.dropout_grad(_t(g), p, seed, offset)
    assert got.dtype == BF
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(want).astype(ml_dtypes.bfloat16).view(np.int16))
    # the mask does not depend on the dtype
    ones = tfdn.dropout_grad(torch.ones(1001, dtype=BF), p, seed, offset)
    assert torch.equal(ones != 0, philox.keep_mask((1001,), p, seed, offset))
    assert torch.equal(ones.float() != 0, tfdn.dropout_grad(
        torch.ones(1001), p, seed, offset) != 0)


def test_add_layer_norm_bf16_dropout_keeps_the_fp32_mask():
    x = torch.ones(32, 128, dtype=BF)
    y32 = tfdn.fused_dropout_add_layer_norm(x.float(), torch.zeros(32, 128),
                                            dropout_p=0.5, seed=3, offset=1)
    y16 = tfdn.fused_dropout_add_layer_norm(x, torch.zeros_like(x),
                                            dropout_p=0.5, seed=3, offset=1)
    assert y16.dtype == BF
    assert torch.equal(y16 > 0, y32 > 0)
    assert torch.equal(y16 > 0, philox.keep_mask((32, 128), 0.5, 3, 1))


def test_functional_dropout_bf16_rounds_once():
    # the reference's where(keep, v / (1 - p), 0) at bf16: the weakly typed
    # 1 - p takes v's dtype (0.9 -> 0.8984375), the quotient rounds once
    from paddle_tpu_torch.kernels.philox import DropoutState
    x = _t(_rand(8, 16, 64, scale=2.0))
    state = DropoutState(11)
    y = TF.dropout(x, 0.1, True, state)
    assert y.dtype == BF
    keep = philox.keep_mask(x.shape, 0.1, 11, 0)
    want = torch.from_numpy(np.where(keep.numpy(), np.asarray(
        (_j(_rand(8, 16, 64, scale=2.0)) / (1.0 - 0.1)).astype(jnp.float32)),
        0.0)).to(BF)
    assert torch.equal(y, want)
    # twice rounded (the scale to bf16, then the product) would differ
    twice = x * (keep.to(BF) * (1.0 / 0.9))
    assert not torch.equal(y, twice)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

B, H, L, D = 2, 3, 128, 16
BQ = BK = 64


def _qkv(seed):
    return [_rand(seed + i, B, H, L, D) for i in range(3)]


def _kpad(seed):
    lengths = np.random.RandomState(seed).randint(L // 2, L + 1, size=B)
    bias = np.zeros((B, L), np.float32)
    for i, n in enumerate(lengths):
        bias[i, n:] = -1e9
    return bias


@pytest.mark.parametrize("causal,with_bias", [(False, False), (True, False),
                                              (False, True)])
def test_flash_forward_bf16_matches_pallas(causal, with_bias):
    q, k, v = _qkv(20)
    bias = _kpad(23) if with_bias else None
    ro, rlse = jfa._flash_forward(
        _j(q), _j(k), _j(v), None if bias is None else jnp.asarray(bias),
        jnp.zeros((1, 1), jnp.int32), causal, 1.0 / np.sqrt(D), BQ, BK, 0.0,
        True)
    o, lse = tfa.flash_attention_forward(
        _t(q), _t(k), _t(v), causal=causal,
        kpad_bias=None if bias is None else torch.from_numpy(bias))
    assert o.dtype == BF and lse.dtype == torch.float32 and ro.dtype == \
        jnp.bfloat16
    _close(o, ro, 'o')
    _stats_close(lse, rlse, 'lse')


@pytest.mark.parametrize("causal,with_bias", [(False, False), (True, False),
                                              (False, True)])
def test_flash_backward_bf16_matches_pallas(causal, with_bias):
    q, k, v = _qkv(70)
    bias = _kpad(73) if with_bias else None
    ref = jax.grad(lambda q_, k_, v_: _jcos_loss(jfa.flash_attention_bhld(
        q_, k_, v_, causal=causal,
        kpad_bias=None if bias is None else jnp.asarray(bias),
        block_q=BQ, block_k=BK, interpret=True)), argnums=(0, 1, 2))(
            _j(q), _j(k), _j(v))
    tb = None if bias is None else torch.from_numpy(bias)
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    o = tfa.flash_attention_bhld(*ts, causal=causal, kpad_bias=tb)
    _cos_loss(o).backward()
    for t, r, name in zip(ts, ref, 'qkv'):
        assert t.grad.dtype == BF
        _close(t.grad, r, f'd{name}')
    # the plain dQ and dK/dV, called as the kernels are: bf16 q/k/v/dO,
    # fp32 lse and delta
    with torch.no_grad():
        tq, tk, tv = (t.detach() for t in ts)
        o2, lse = tfa.flash_attention_forward(tq, tk, tv, causal=causal,
                                              kpad_bias=tb)
        of = o2.float()
        do = (torch.cos(of) - of * torch.sin(of)).to(BF)
        delta = (do.float() * of).sum(-1)
        rest = (lse, delta, causal, 1.0 / np.sqrt(D), tb)
        dq = tfa.flash_attention_dq(tq, tk, tv, do, *rest)
        dk, dv = tfa.flash_attention_dkv(tq, tk, tv, do, *rest)
    for got, r, name in zip((dq, dk, dv), ref, 'qkv'):
        assert got.dtype == BF
        _close(got, r, f'plain d{name}')


def test_flash_plain_versions_round_where_the_reference_casts():
    # P (forward) and P dropped and dS (backward) go into their products
    # as bf16 values: an unrounded plain version would differ from this by
    # more than the bf16 output rounding
    q, k, v = (_t(a) for a in _qkv(40))
    o, lse = tfa._attn_reference(q, k, v, False, 0.25)
    qf, kf, vf = q.float(), k.float(), v.float()
    s = qf @ kf.transpose(-1, -2) * 0.25
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = (p.to(BF).float() @ vf) / p.sum(-1, keepdim=True)
    assert torch.equal(o, want.to(BF))
    unrounded = ((p @ vf) / p.sum(-1, keepdim=True)).to(BF)
    assert not torch.equal(o, unrounded)
    do = _t(_rand(44, B, H, L, D))
    delta = (do.float() * o.float()).sum(-1)
    p_drop, ds = tfa._p_ds(q, k, v, do, lse, delta, False, 0.25, None, 0.1,
                           5, 6)
    assert p_drop.dtype == ds.dtype == torch.float32
    assert torch.equal(p_drop, p_drop.to(BF).float())
    assert torch.equal(ds, ds.to(BF).float())
    # at fp32 the rounding is the identity: the fp32 plain path is as it was
    o32, _ = tfa._attn_reference(qf, kf, vf, False, 0.25)
    want32 = (p @ vf) / p.sum(-1, keepdim=True)
    torch.testing.assert_close(o32, want32, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# what the kernel wrappers refuse (meta tensors take the kernel branch)
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device='meta', dtype=dtype)


# the ids name float16, which the kernels refused until they took it; the
# cases now hold float64, which they refuse
F64 = torch.float64


@pytest.mark.parametrize("call,match", [
    (lambda: tfn.fused_layer_norm(_meta(4, 8, dtype=F64)),
     'float32, bfloat16 or float16, got torch.float64'),
    (lambda: tfn.fused_layer_norm(_meta(4, 8, dtype=BF), _meta(8)),
     'weight: dtype torch.float32, expected torch.bfloat16'),
    (lambda: tfdn.fused_dropout_add_layer_norm(
        _meta(4, 8, dtype=BF), _meta(4, 8)),
     'residual: dtype torch.float32, expected torch.bfloat16'),
    (lambda: tfdn.dropout_grad(_meta(4, 8, dtype=F64), 0.1, 1, 0),
     'got torch.float64'),
    (lambda: tfa.flash_attention_bhld(
        _meta(1, 2, 8, 4, dtype=BF), _meta(1, 2, 8, 4),
        _meta(1, 2, 8, 4, dtype=BF)),
     'k: dtype torch.float32, expected torch.bfloat16'),
    (lambda: tfa.flash_attention_bhld(
        *(_meta(1, 2, 8, 4, dtype=F64),) * 3),
     'got torch.float64'),
], ids=["ln-fp16", "ln-mixed", "add-ln-mixed", "dropout-grad-fp16",
        "flash-mixed", "flash-fp16"])
def test_kernel_wrappers_refuse_other_dtypes(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_require_keeps_statistics_fp32():
    from paddle_tpu_torch.kernels import _build
    with pytest.raises(ValueError, match='lse: dtype torch.bfloat16, '
                                         'expected torch.float32'):
        _build.require(_meta(2, 8, dtype=BF), 'flash attention: lse',
                       torch.device('meta'), dtype=torch.float32)
    assert _build.DTYPES == {torch.float32: 0, torch.bfloat16: 1,
                             torch.float16: 2}


# ---------------------------------------------------------------------------
# BERT under the reference's bf16 recipe
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=128)


def _batch(seed=0, b=4, seq=128):
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


def bf16_recipe(net):
    """``bench_bert``'s ``loss_of`` for ``build_train_step(loss_fn=...)``:
    fp32 leaves cast to bf16 (differentiably), the model through
    ``functional_call``, the loss on fp32 logits."""
    def loss_fn(params, batch):
        x, y = batch
        pc = {k: v.to(BF) if v.dtype == torch.float32 else v
              for k, v in params.items()}
        logits, nsp = torch.func.functional_call(net, pc, (), x)
        loss = net.pretraining_loss(logits.float(), nsp.float(), *y)
        return loss, (logits, nsp)
    return loss_fn


def _jax_recipe(ref, params, x, y, bf16):
    def loss_of(p):
        if bf16:
            p = {k: (v.astype(jnp.bfloat16) if v.dtype == jnp.float32
                     else v) for k, v in p.items()}
        (logits, nsp), _ = functional_call(
            ref, p, JaxTensor(x['input_ids']),
            JaxTensor(x['token_type_ids']),
            masked_positions=JaxTensor(x['masked_positions']))
        return ref.pretraining_loss(
            JaxTensor(logits._value.astype(jnp.float32)),
            JaxTensor(nsp._value.astype(jnp.float32)), JaxTensor(y[0]),
            JaxTensor(y[1]))._value
    loss, grads = jax.jit(jax.value_and_grad(loss_of))(params)
    return float(loss), {k: np.asarray(g) for k, g in grads.items()}


def _port_recipe(net, x, y, bf16):
    params = dict(net.named_parameters())
    batch = ({k: torch.from_numpy(v) for k, v in x.items()},
             tuple(torch.from_numpy(a) for a in y))
    if bf16:
        loss, (logits, _) = bf16_recipe(net)(params, batch)
        assert logits.dtype == BF
    else:
        loss = net.pretraining_loss(*net(**batch[0]), *batch[1])
    grads = torch.autograd.grad(loss, list(params.values()))
    for p, g in zip(params.values(), grads):
        assert g.dtype == torch.float32     # on the fp32 masters
        p.grad = g
    out = to_paddle_tpu_state(net, grads=True)
    for p in params.values():
        p.grad = None
    return float(loss.detach()), out


def _errors(got, want):
    """{key: max abs error over the tensor's max abs value}, with a floor
    of 1e-3 of the model's largest gradient entry (the key biases' true
    gradient is zero: both sides hold rounding noise there)."""
    top = max(float(np.abs(w).max()) for w in want.values())
    return {k: float(np.abs(got[k] - w).max()) /
            max(float(np.abs(w).max()), 1e-3 * top)
            for k, w in want.items()}


@pytest.fixture(scope='module')
def recipe_runs():
    paddle.seed(21)
    ref = JaxBertForPretraining(JaxBertConfig(**SMALL))
    ref.eval()
    params = param_values(ref, trainable_only=False)
    net = BertForPretraining(BertConfig(**SMALL), device='cpu').eval()
    load_paddle_tpu_state(net, {k: np.asarray(v) for k, v in params.items()})
    x, y = _batch()
    return {'jax16': _jax_recipe(ref, params, x, y, True),
            'jax32': _jax_recipe(ref, params, x, y, False),
            'port16': _port_recipe(net, x, y, True),
            'port32': _port_recipe(net, x, y, False), 'net': net}


def test_bf16_recipe_loss_matches_reference_and_fp32(recipe_runs):
    l16, _ = recipe_runs['port16']
    for other in ('jax16', 'port32', 'jax32'):
        want = recipe_runs[other][0]
        assert abs(l16 - want) <= 2e-3 * abs(want), other
    assert np.isfinite(l16)


def test_bf16_recipe_gradients_match_reference_and_fp32(recipe_runs):
    g16 = recipe_runs['port16'][1]
    truth = recipe_runs['port32'][1]
    assert sorted(g16) == sorted(recipe_runs['jax16'][1]) == sorted(truth)
    port = _errors(g16, truth)
    ref = _errors(recipe_runs['jax16'][1], recipe_runs['jax32'][1])
    assert max(port.values()) <= 0.1, max(port, key=port.get)
    assert np.mean(list(port.values())) <= 0.03
    # no worse than the JAX package's own bf16 recipe against its fp32
    assert max(port.values()) <= max(ref.values())
    assert np.mean(list(port.values())) <= np.mean(list(ref.values()))
    across = _errors(g16, recipe_runs['jax16'][1])
    assert max(across.values()) <= 0.15, max(across, key=across.get)


def test_bf16_forward_dtypes_and_tied_decoder(recipe_runs, monkeypatch):
    net = recipe_runs['net']
    x, _ = _batch(seed=1, b=2, seq=32)
    seen = {}
    emb, ln = net.bert.embeddings, net.bert.embeddings.layer_norm
    hooks = [m.register_forward_hook(
        lambda m, a, out, name=name: seen.__setitem__(name, out.dtype))
        for name, m in (('word_embeddings', emb.word_embeddings),
                        ('embedding_norm', ln), ('dropout', emb.dropout),
                        ('pooler', net.bert.pooler))]
    biases = []
    real = TF.transformer.flash_attention_bhld
    monkeypatch.setattr(
        TF.transformer, 'flash_attention_bhld',
        lambda *a, **kw: biases.append(kw['kpad_bias']) or real(*a, **kw))
    monkeypatch.setattr(net.cls, 'activation', lambda h: seen.__setitem__(
        'gelu_in', h.dtype) or TF.gelu(h))
    params = {k: v.detach().to(BF) for k, v in net.named_parameters()}
    assert 'cls.decoder_weight' not in params
    mask = np.ones((2, 32), np.int64)
    mask[1, 20:] = 0
    feeds = {k: torch.from_numpy(v) for k, v in x.items()}
    with torch.no_grad():
        logits, nsp = torch.func.functional_call(
            net, params, (), dict(feeds, attention_mask=torch.from_numpy(
                mask)))
    for h in hooks:
        h.remove()
    assert logits.dtype == nsp.dtype == BF
    assert set(seen.values()) == {BF}
    # the key bias reaches the kernel in fp32, with bf16's values of -1e4
    assert len(biases) == 2 and all(b.dtype == torch.float32 for b in biases)
    assert float(biases[0][1, -1]) == float(torch.tensor(-1e4).to(BF))
    # bf16 logits: the tied decoder read the substituted bf16 word
    # embeddings (the fp32 parameter would not multiply a bf16 activation);
    # outside the call it is the one fp32 parameter again
    assert net.cls.decoder_weight is \
        net.bert.embeddings.word_embeddings.weight
    assert net.cls.decoder_weight.dtype == torch.float32


def test_bf16_recipe_trains_through_build_train_step():
    torch.manual_seed(0)
    net = BertForPretraining(BertConfig(**SMALL), device='cpu',
                             generator=torch.Generator().manual_seed(3))
    net.train()
    step = build_train_step(bf16_recipe(net), topt.AdamW(learning_rate=1e-3),
                            params=dict(net.named_parameters()),
                            device='cpu')
    state = step.init_state()
    x, y = _batch(seed=4, b=2, seq=64)
    losses = []
    for _ in range(4):
        state, result = step(state, (x, y))
        losses.append(float(result.loss))
        assert result.outputs[0].dtype == BF
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    # the masters stay fp32 and are the model's own parameters
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert state['params']['cls.decoder_bias'] is net.cls.decoder_bias
    assert all(s['moment1'].dtype == torch.float32
               for s in state['opt'].values())
