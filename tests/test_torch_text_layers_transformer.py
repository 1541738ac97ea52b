"""The Transformer family of the port's ``text.layers`` against the JAX
package on shared weights: ``TransformerEncoder`` / ``TransformerDecoder``
(pre-process ``n``, post-process ``da``, p = 0), the decoder's incremental
and static caches, and ``TransformerBeamSearchDecoder`` over a
``TransformerCell`` through ``DynamicDecode``.

Sizes: 2 + 2 layers, 2 heads, d_key = d_value 4, d_model 8, FFN 16,
vocabulary 11, batch 2, sources of 5 and targets of 4 tokens (the second
source padded from 3 through a key bias); the beam search (beam 2, 2
steps) on a 1 + 1-layer model. Tolerances, fp32: outputs and
the loss within 1e-5 of their largest entry, gradients within 1e-4 of
their largest (floor 1e-3); the beams' ids equal and their scores within
1e-5. Each ``n`` command is one ``F.layer_norm`` call (the LayerNorm
kernel on the card): 2 a layer and 1 after the encoder, 3 a layer and 1
after the decoder.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.text as jt
from paddle_tpu.core.tensor import Tensor as JaxTensor

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.text as tt
from paddle_tpu_torch.kernels.philox import DropoutState
from paddle_tpu_torch.nn import functional as TF

from _torch_rnn_pair import assert_close, port_run, ref_run, share

LAYERS, HEADS, DK, D, FF, V = 2, 2, 4, 8, 16, 11
B, LS, LT, BEAM, STEPS = 2, 5, 4, 2, 2
ARGS = (LAYERS, HEADS, DK, DK, D, FF, 0.0, 0.0, 0.0)
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def _biases():
    src_bias = np.zeros((B, 1, 1, LS), np.float32)
    src_bias[1, ..., 3:] = -1e9
    causal = np.triu(np.full((LT, LT), -1e9, np.float32), 1)[None, None]
    return src_bias, causal


@pytest.fixture(scope='module')
def pair():
    paddle.seed(3)
    ref = (jt.TransformerEncoder(*ARGS), jt.TransformerDecoder(*ARGS))
    port = (tt.TransformerEncoder(*ARGS, device='cpu'),
            tt.TransformerDecoder(*ARGS, device='cpu'))
    for r, p, seed in zip(ref, port, (31, 32)):
        share(r, p, seed)
    return ref, port


def _seq_inputs():
    rs = np.random.RandomState(33)
    return [rs.randn(B, LS, D).astype(np.float32),
            rs.randn(B, LT, D).astype(np.float32), *_biases()]


def _run(model, src, trg, src_bias, causal):
    memory = model.enc(src, src_bias)
    out = model.dec(trg, memory, causal, src_bias)
    return (out * out).sum() * 0.5 + memory.sum(), [memory, out]


def test_encoder_decoder_loss_and_gradients_match_reference(pair):
    from paddle_tpu.nn.layer_base import param_values
    from paddle_tpu_torch.interop import to_paddle_tpu_state
    (r_enc, r_dec), (p_enc, p_dec) = pair
    inputs = _seq_inputs()

    class RefBoth(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.enc, self.dec = r_enc, r_dec

    class PortBoth(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.enc, self.dec = p_enc, p_dec
    want = ref_run(RefBoth(), _run, inputs)
    got = port_run(PortBoth(), _run, inputs)
    assert_close(got, want, OUT_TOL, GRAD_TOL)
    assert len(param_values(RefBoth())) == \
        len(to_paddle_tpu_state(PortBoth(), grads=True))


def test_each_n_command_is_one_layer_norm(pair, monkeypatch):
    _, (enc, dec) = pair
    calls = []
    real = TF.layer_norm

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(TF, 'layer_norm', counted)
    src, trg, src_bias, causal = (torch.from_numpy(a) for a in
                                  _seq_inputs())
    with torch.no_grad():
        dec(trg, enc(src, src_bias), causal, src_bias)
    assert len(calls) == (2 * LAYERS + 1) + (3 * LAYERS + 1)


def test_incremental_and_static_caches_match_the_whole_pass(pair):
    """Decoding one token at a time through the growing ``k``/``v`` caches,
    with the cross-attention's keys and values precomputed
    (``prepare_static_cache``) or not, gives the whole causal pass's
    outputs, on both sides."""
    (r_enc, r_dec), (enc, dec) = pair
    src, trg, src_bias, causal = _seq_inputs()
    with torch.no_grad():
        memory = enc(torch.from_numpy(src), torch.from_numpy(src_bias))
        whole = dec(torch.from_numpy(trg), memory, torch.from_numpy(causal),
                    torch.from_numpy(src_bias))
        for static in (False, True):
            caches = dec.prepare_incremental_cache(memory)
            if static:
                caches = [dict(c, **s) for c, s in
                          zip(caches, dec.prepare_static_cache(memory))]
            steps = [dec(torch.from_numpy(trg[:, t:t + 1]), memory, None,
                         torch.from_numpy(src_bias), caches)
                     for t in range(LT)]
            np.testing.assert_allclose(torch.cat(steps, 1).numpy(),
                                       whole.numpy(), rtol=0, atol=1e-5)
            assert caches[0]['k'].shape == (B, HEADS, LT, DK)

    def ref_steps(src, trg, src_bias):
        mem = r_enc(JaxTensor(src), JaxTensor(src_bias))
        caches = r_dec.prepare_incremental_cache(mem)
        return [r_dec(JaxTensor(trg[:, t:t + 1]), mem, None,
                      JaxTensor(src_bias), caches)._value
                for t in range(2)]
    want = np.concatenate(jax.jit(ref_steps)(src, trg, src_bias), 1)
    assert np.abs(whole[:, :2].numpy() - want).max() <= \
        OUT_TOL * np.abs(want).max()


def test_dropout_draws_from_the_model_state():
    gen = torch.Generator().manual_seed(4)
    enc = tt.TransformerEncoder(LAYERS, HEADS, DK, DK, D, FF, 0.1, 0.1, 0.1,
                                device='cpu', generator=gen).train()
    assert isinstance(enc.dropout_state, DropoutState)
    x = torch.randn(B, LS, D)
    a, b = enc(x), enc(x)
    # per layer: 2 'da' commands, the attention weights, the FFN hidden
    assert enc.dropout_state.offset == 2 * LAYERS * 4
    assert not torch.equal(a, b)
    enc.eval()
    with torch.no_grad():
        np.testing.assert_array_equal(enc(x).numpy(), enc(x).numpy())


def _beam_parts(side):
    """The target embedding, the position table and the output layer on
    ``side`` ('ref' or 'port')."""
    if side == 'ref':
        return jnn.Embedding(V, D), jnn.Embedding(16, D), jnn.Linear(D, V)
    return (tnn.Embedding(V, D, device='cpu'),
            tnn.Embedding(16, D, device='cpu'),
            tnn.Linear(D, V, device='cpu'))


def test_beam_search_decoder_matches_reference():
    """One layer a side here: the reference's search runs eagerly (its
    growing caches cannot be traced), each step's shapes compiled anew."""
    paddle.seed(5)
    one = (1,) + ARGS[1:]
    r_enc, r_dec = jt.TransformerEncoder(*one), jt.TransformerDecoder(*one)
    enc, dec = (tt.TransformerEncoder(*one, device='cpu'),
                tt.TransformerDecoder(*one, device='cpu'))
    share(r_enc, enc, 37)
    share(r_dec, dec, 38)
    parts = {side: _beam_parts(side) for side in ('ref', 'port')}
    for r, p, seed in zip(parts['ref'], parts['port'], (34, 35, 36)):
        share(r, p, seed)
    src, _, src_bias, _ = _seq_inputs()
    results = {}
    for side, mod, (e, d), wrap in (
            ('ref', jt, (r_enc, r_dec), JaxTensor),
            ('port', tt, (enc, dec), torch.from_numpy)):
        word, pos, out = parts[side]
        cell = mod.TransformerCell(d, lambda w, p, word=word, pos=pos:
                                   word(w) + pos(p), out)
        search = mod.TransformerBeamSearchDecoder(cell, 0, 1, BEAM, 2)
        memory = e(wrap(src), wrap(src_bias))
        tile = search.tile_beam_merge_with_batch
        static = [{k: tile(v, BEAM) for k, v in c.items()}
                  for c in d.prepare_static_cache(memory)]
        ids, states = mod.DynamicDecode(search, max_step_num=STEPS,
                                        is_test=True)(
            inits=d.prepare_incremental_cache(memory),
            enc_output=tile(memory, BEAM), static_caches=static,
            trg_src_attn_bias=tile(wrap(src_bias), BEAM))
        lp = states['log_probs']
        results[side] = [np.asarray(getattr(ids, '_value', ids)),
                         np.asarray(getattr(lp, '_value', None))
                         if side == 'ref' else lp.numpy()]
    (r_ids, r_lp), (p_ids, p_lp) = results['ref'], results['port']
    assert p_ids.shape == r_ids.shape == (B, STEPS, BEAM)
    np.testing.assert_array_equal(p_ids, r_ids)
    assert np.abs(p_lp - r_lp).max() <= OUT_TOL * np.abs(r_lp).max()
