"""The encoder-decoder ``nn.Transformer`` and ``MultiHeadAttention``'s
caches against the JAX package, on shared weights.

Small sizes: d_model 32, 4 heads, FFN 64, 2 + 2 layers, batch 2, source 7
and target 5 (lengths that are no multiple of anything), fp32, p = 0. The
same numpy inputs, made from a seed, go through the reference (its
composed XLA path) and the port (the kernels' plain versions on the CPU).
Tolerances: outputs within 1e-5 of their largest entry, gradients within
1e-4 of each gradient's largest entry (floor 1e-3: the key projection's
bias has a true gradient of zero, rounding noise on both sides).

Also here: the decoder layer pre- and post-norm, incremental decoding
step by step equal to the full causal forward, the fp16 causal mask
(-1e9 becomes -inf) with no NaN, the attention routes (which calls take
the flash kernel) and the weights carried across ``interop`` both ways.
``MultiHeadAttention``'s caches and the functional
``multi_head_attention`` are held in ``test_torch_transformer_cache.py``.
"""
import collections

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.nn.layer_base import functional_call, param_values

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.interop import (load_paddle_tpu_state,
                                      to_paddle_tpu_state)
from paddle_tpu_torch.nn.functional import transformer as tft

D, H, FF, B, LS, LT = 32, 4, 64, 2, 7, 5
OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def _np(t):
    return np.asarray(t._value)


def _state(layer):
    return {k: _np(v) for k, v in layer.state_dict().items()}


def _randomise(ref, seed):
    """Random values everywhere (unit norms and zero biases would hide a
    swap), set on the reference; -> the numpy state."""
    rs = np.random.RandomState(seed)
    state = {k: (0.3 * rs.randn(*v.shape)).astype(np.float32)
             for k, v in _state(ref).items()}
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    return state


def _close(got, want, tol=OUT_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= tol * scale, \
        np.abs(got - want).max() / scale


@pytest.fixture(scope='module')
def transformer_pair():
    paddle.seed(21)
    ref = jnn.Transformer(D, H, 2, 2, FF, dropout=0.0)
    ref.eval()
    state = _randomise(ref, 22)
    port = tnn.Transformer(D, H, 2, 2, FF, dropout=0.0, device='cpu').eval()
    load_paddle_tpu_state(port, state)
    return ref, port, state


@pytest.fixture(scope='module')
def feeds():
    rs = np.random.RandomState(23)
    return (rs.randn(B, LS, D).astype(np.float32),
            rs.randn(B, LT, D).astype(np.float32),
            rs.randn(B, LT, D).astype(np.float32))


def _causal(n):
    return jnn.Transformer.generate_square_subsequent_mask(n)


def test_square_subsequent_mask_matches_reference():
    got = tnn.Transformer.generate_square_subsequent_mask(6, device='cpu')
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _np(_causal(6)))


def test_state_dict_keys_match_reference(transformer_pair):
    ref, port, state = transformer_pair
    assert sorted(port.state_dict()) == sorted(state)
    back = to_paddle_tpu_state(port)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v)
    # a decoder Linear is transposed against the reference's (in, out)
    w = state['decoder.layers.1.cross_attn.k_proj.weight']
    np.testing.assert_array_equal(
        port.decoder.layers[1].cross_attn.k_proj.weight.detach().numpy(),
        w.T)


@pytest.fixture(scope='module')
def reference_run(transformer_pair, feeds):
    """The reference's causal forward on ``feeds``, the loss ``sum(out *
    w)`` and its gradients for the parameters and both inputs, under one
    ``jax.jit`` (op by op the forward alone takes seconds) -> (out, loss,
    (parameter gradients, source gradient, target gradient))."""
    ref, _, _ = transformer_pair
    src, tgt, w = feeds
    params = param_values(ref, trainable_only=False)

    def loss_of(p, s, t):
        out, _ = functional_call(ref, p, JaxTensor(s), JaxTensor(t),
                                 tgt_mask=_causal(LT))
        return (out._value * w).sum(), out._value
    (loss, out), grads = jax.jit(jax.value_and_grad(
        loss_of, argnums=(0, 1, 2), has_aux=True))(params, src, tgt)
    return np.asarray(out), loss, grads


def test_transformer_forward_matches_reference(transformer_pair, feeds,
                                               reference_run):
    _, port, _ = transformer_pair
    src, tgt, _ = feeds
    with torch.no_grad():
        got = port(torch.from_numpy(src), torch.from_numpy(tgt),
                   tgt_mask=tnn.Transformer.generate_square_subsequent_mask(
                       LT, device='cpu'))
    _close(got, reference_run[0])


def test_transformer_gradients_match_reference(transformer_pair, feeds,
                                               reference_run):
    _, port, _ = transformer_pair
    src, tgt, w = feeds
    _, want_loss, (want_p, want_src, want_tgt) = reference_run
    port.zero_grad()
    s = torch.from_numpy(src).requires_grad_()
    t = torch.from_numpy(tgt).requires_grad_()
    out = port(s, t, tgt_mask=tnn.Transformer.generate_square_subsequent_mask(
        LT, device='cpu'))
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= \
        OUT_TOL * abs(float(want_loss))
    grads = to_paddle_tpu_state(port, grads=True)
    assert sorted(grads) == sorted(want_p)
    for key, g in want_p.items():
        g = np.asarray(g)
        scale = max(np.abs(g).max(), 1e-3)
        assert np.abs(grads[key] - g).max() <= GRAD_TOL * scale, key
    for got, want in ((s.grad, want_src), (t.grad, want_tgt)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= \
            GRAD_TOL * np.abs(want).max()


@pytest.mark.parametrize('normalize_before', [False, True])
def test_decoder_layer_matches_reference(normalize_before):
    paddle.seed(31)
    ref = jnn.TransformerDecoderLayer(D, H, FF, dropout=0.0,
                                      activation='gelu',
                                      normalize_before=normalize_before)
    ref.eval()
    state = _randomise(ref, 32)
    port = tnn.TransformerDecoderLayer(
        D, H, FF, dropout=0.0, activation='gelu',
        normalize_before=normalize_before, device='cpu').eval()
    load_paddle_tpu_state(port, state)
    rs = np.random.RandomState(33)
    tgt = rs.randn(B, LT, D).astype(np.float32)
    mem = rs.randn(B, LS, D).astype(np.float32)
    # a key-padding memory mask on the cross-attention
    mmask = np.zeros((B, 1, 1, LS), np.float32)
    mmask[1, ..., 4:] = -1e9
    want = ref(paddle.to_tensor(tgt), paddle.to_tensor(mem),
               _causal(LT), paddle.to_tensor(mmask))
    with torch.no_grad():
        got = port(torch.from_numpy(tgt), torch.from_numpy(mem),
                   tnn.Transformer.generate_square_subsequent_mask(
                       LT, device='cpu'), torch.from_numpy(mmask))
    _close(got, _np(want))


@pytest.mark.parametrize('normalize_before', [False, True])
def test_pre_norm_transformer_has_final_norms(normalize_before):
    port = tnn.Transformer(D, H, 1, 1, FF, normalize_before=normalize_before,
                           device='cpu')
    ref = jnn.Transformer(D, H, 1, 1, FF, normalize_before=normalize_before)
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    assert (port.encoder.norm is None) == (not normalize_before)
    assert (port.decoder.norm is None) == (not normalize_before)


def test_incremental_decoding_equals_full_forward(transformer_pair, feeds):
    _, port, _ = transformer_pair
    src, tgt, _ = feeds
    with torch.no_grad():
        memory = port.encoder(torch.from_numpy(src))
        full = port.decoder(
            torch.from_numpy(tgt), memory,
            tnn.Transformer.generate_square_subsequent_mask(LT,
                                                            device='cpu'))
        cache = port.decoder.gen_cache(memory)
        steps = []
        for t in range(LT):
            x = torch.from_numpy(tgt[:, t:t + 1])
            out, cache = port.decoder(x, memory, None, None, cache)
            steps.append(out)
        incr, static = cache[0]
        assert incr.k.shape == (B, LT, H, D // H)
        assert static.k.shape == (B, LS, H, D // H)
    _close(torch.cat(steps, 1), full.numpy())
    # the reference's own incremental decode: test_torch_transformer_cache


def test_fp16_causal_mask_gives_no_nan():
    port = tnn.TransformerDecoderLayer(D, H, FF, dropout=0.0,
                                       device='cpu').eval().half()
    rs = np.random.RandomState(71)
    tgt = torch.from_numpy(rs.randn(B, LT, D).astype(np.float16))
    mem = torch.from_numpy(rs.randn(B, LS, D).astype(np.float16))
    mask = tnn.Transformer.generate_square_subsequent_mask(LT, device='cpu')
    assert torch.isinf(mask.half()).any()       # -1e9 is -inf in fp16
    with torch.no_grad():
        out = port(tgt, mem, mask)
        full = port.float()(tgt.float(), mem.float(), mask)
    assert out.dtype == torch.float16
    assert torch.isfinite(out).all()
    assert (out.float() - full).abs().max() <= 2e-2 * full.abs().max()


def test_attention_routes(transformer_pair, feeds, monkeypatch):
    """The flash route takes the encoder's self-attention and an
    equal-length, unmasked cross-attention; the causal self-attention and
    a cross-attention over a longer source are composed."""
    _, port, _ = transformer_pair
    src, tgt, _ = feeds
    calls = collections.Counter()
    real_flash, real_composed = tft.flash_attention_bhld, tft._composed

    def flash(q, *a, **k):
        calls['flash', q.shape[2], a[0].shape[2]] += 1
        return real_flash(q, *a, **k)

    def composed(q, k, *a, **kw):
        calls['composed', q.shape[2], k.shape[2]] += 1
        return real_composed(q, k, *a, **kw)
    monkeypatch.setattr(tft, 'flash_attention_bhld', flash)
    monkeypatch.setattr(tft, '_composed', composed)
    mask = tnn.Transformer.generate_square_subsequent_mask(LT, device='cpu')
    with torch.no_grad():
        port(torch.from_numpy(src), torch.from_numpy(tgt), tgt_mask=mask)
        assert calls == {('flash', LS, LS): 2, ('composed', LT, LT): 2,
                         ('composed', LT, LS): 2}
        calls.clear()
        same = torch.from_numpy(src[:, :LT])
        port(same, torch.from_numpy(tgt), tgt_mask=mask)
        assert calls == {('flash', LT, LT): 4, ('composed', LT, LT): 2}


def test_reference_fault_decoder_gen_cache_ignores_do_zip(transformer_pair,
                                                           feeds):
    """The reference's ``TransformerDecoder.gen_cache`` accepts ``do_zip``
    and ignores it (``paddle_tpu/nn/layer/transformer.py:255-256``).
    Upstream Paddle zips the layers' ``(Cache, StaticCache)`` pairs into
    ``[(caches...), (static caches...)]`` when it is set; the port does."""
    ref, port, _ = transformer_pair
    src = feeds[0]
    rz = ref.decoder.gen_cache(ref.encoder(paddle.to_tensor(src)),
                               do_zip=True)
    assert len(rz) == 2 and isinstance(rz[0], tuple)   # per layer: unzipped
    assert isinstance(rz[0][0], jnn.MultiHeadAttention.Cache)
    with torch.no_grad():
        memory = port.encoder(torch.from_numpy(src))
        plain = port.decoder.gen_cache(memory)
        zipped = port.decoder.gen_cache(memory, do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2
    assert all(isinstance(c, tnn.MultiHeadAttention.Cache)
               for c in zipped[0])
    assert all(isinstance(c, tnn.MultiHeadAttention.StaticCache)
               for c in zipped[1])
    assert torch.equal(zipped[1][1].k, plain[1][1].k)
