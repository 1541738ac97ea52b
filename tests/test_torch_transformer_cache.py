"""``MultiHeadAttention``'s caches and the functional
``multi_head_attention`` against the JAX package, on shared weights.

The widths of ``test_torch_transformer_decoder.py``: d_model 32, 4 heads,
FFN 64, batch 2, fp32, p = 0. The same numpy inputs, made from a seed, go
through the reference and the port (the kernels' plain versions on the
CPU). Tolerance: outputs within 1e-5 of their largest entry.

Here: a ``kdim``/``vdim`` that differ from ``embed_dim`` with the
``StaticCache`` (keys and values projected once), the incremental
``Cache`` step by step with ``need_weights``, the encoder's ``gen_cache``
and ``cache=``, the 2 + 2-layer ``Transformer``'s decoder stepped through
its caches against the reference's (the weights of
``test_torch_transformer_decoder.py``), and the functional
``multi_head_attention`` with and without its ``append_k``/``append_v``
cache.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.nn.functional.transformer import \
    multi_head_attention as jax_mha

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.interop import load_paddle_tpu_state
from paddle_tpu_torch.nn import functional as TF

D, H, FF, B, LS, LT = 32, 4, 64, 2, 7, 5
OUT_TOL = 1e-5


def _np(t):
    return np.asarray(t._value)


def _randomise(ref, seed):
    """Random values everywhere, set on the reference; -> the numpy
    state."""
    rs = np.random.RandomState(seed)
    state = {k: (0.3 * rs.randn(*v.shape)).astype(np.float32)
             for k, v in ((k, _np(v)) for k, v in ref.state_dict().items())}
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    return state


def _close(got, want, tol=OUT_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= tol * scale, \
        np.abs(got - want).max() / scale


def test_mha_kdim_vdim_and_static_cache_match_reference():
    paddle.seed(41)
    ref = jnn.MultiHeadAttention(D, H, kdim=12, vdim=20)
    ref.eval()
    state = _randomise(ref, 42)
    port = tnn.MultiHeadAttention(D, H, kdim=12, vdim=20,
                                  device='cpu').eval()
    load_paddle_tpu_state(port, state)
    assert port.k_proj.weight.shape == (D, 12)
    assert port.v_proj.weight.shape == (D, 20)
    rs = np.random.RandomState(43)
    q = rs.randn(B, LT, D).astype(np.float32)
    k = rs.randn(B, LS, 12).astype(np.float32)
    v = rs.randn(B, LS, 20).astype(np.float32)
    want = ref(paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v))
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (q, k, v)))
        _close(got, _np(want))
        # the static cache: k and v projected once, then read in place
        rc = ref.gen_cache(paddle.to_tensor(k), paddle.to_tensor(v),
                           jnn.MultiHeadAttention.StaticCache)
        pc = port.gen_cache(torch.from_numpy(k), torch.from_numpy(v),
                            tnn.MultiHeadAttention.StaticCache)
        assert isinstance(pc, tnn.MultiHeadAttention.StaticCache)
        _close(pc.k, _np(rc.k))
        _close(pc.v, _np(rc.v))
        out, back = port(torch.from_numpy(q), None, None, None, pc)
        assert back is pc
        _close(out, _np(want))


def test_mha_incremental_cache_matches_reference():
    paddle.seed(51)
    ref = jnn.MultiHeadAttention(D, H, need_weights=True)
    ref.eval()
    state = _randomise(ref, 52)
    port = tnn.MultiHeadAttention(D, H, need_weights=True,
                                  device='cpu').eval()
    load_paddle_tpu_state(port, state)
    rs = np.random.RandomState(53)
    xs = rs.randn(B, 4, D).astype(np.float32)
    rcache = ref.gen_cache(paddle.to_tensor(xs))
    with torch.no_grad():
        pcache = port.gen_cache(torch.from_numpy(xs))
        assert pcache.k.shape == (B, 0, H, D // H)
        for t in range(4):
            x = xs[:, t:t + 1]
            rout, rw, rcache = ref(paddle.to_tensor(x), None, None, None,
                                   rcache)
            out, weights, pcache = port(torch.from_numpy(x), None, None,
                                        None, pcache)
            assert rw is None and weights is None
            assert isinstance(pcache, tnn.MultiHeadAttention.Cache)
            assert pcache.k.shape == (B, t + 1, H, D // H)
            _close(out, _np(rout))
            _close(pcache.v, _np(rcache.v))


def test_encoder_cache_matches_reference():
    paddle.seed(61)
    layer = jnn.TransformerEncoderLayer(D, H, FF, dropout=0.0)
    ref = jnn.TransformerEncoder(layer, 2)
    ref.eval()
    state = _randomise(ref, 62)
    port = tnn.TransformerEncoder(
        tnn.TransformerEncoderLayer(D, H, FF, dropout=0.0, device='cpu'),
        2).eval()
    load_paddle_tpu_state(port, state)
    x = np.random.RandomState(63).randn(B, 3, D).astype(np.float32)
    rcache = ref.gen_cache(paddle.to_tensor(x))
    with torch.no_grad():
        pcache = port.gen_cache(torch.from_numpy(x))
        for t in range(3):
            rout, rcache = ref(paddle.to_tensor(x[:, t:t + 1]), None, rcache)
            out, pcache = port(torch.from_numpy(x[:, t:t + 1]), None, pcache)
            _close(out, _np(rout))
    assert len(pcache) == 2 and pcache[1].k.shape == (B, 3, H, D // H)


class _AppendCache:
    """The reference's functional cache protocol."""

    def __init__(self, k, v, cat):
        self.k, self.v, self._cat = k, v, cat

    def append_k(self, k):
        self.k = self._cat(self.k, k)
        return self.k

    def append_v(self, v):
        self.v = self._cat(self.v, v)
        return self.v


@pytest.mark.parametrize('cached', [False, True])
def test_functional_multi_head_attention_matches_reference(cached):
    rs = np.random.RandomState(81)
    ws = [(0.3 * rs.randn(D, D)).astype(np.float32) for _ in range(4)]
    bs = [(0.1 * rs.randn(D)).astype(np.float32) for _ in range(4)]
    q = rs.randn(B, 1 if cached else LT, D).astype(np.float32)
    kv = rs.randn(B, 1 if cached else LS, D).astype(np.float32)
    past = rs.randn(2, B, 3, H, D // H).astype(np.float32)
    rc = pc = None
    if cached:
        import jax.numpy as jnp
        from paddle_tpu.tensor.manipulation import concat
        rc = _AppendCache(JaxTensor(jnp.asarray(past[0])),
                          JaxTensor(jnp.asarray(past[1])),
                          lambda a, b: concat([a, b], axis=1))
        pc = _AppendCache(torch.from_numpy(past[0]),
                          torch.from_numpy(past[1]),
                          lambda a, b: torch.cat([a, b], 1))
    want = jax_mha(paddle.to_tensor(q), paddle.to_tensor(kv),
                   paddle.to_tensor(kv), H,
                   *(paddle.to_tensor(w) for w in ws),
                   *(paddle.to_tensor(b) for b in bs), cache=rc,
                   training=False)
    got = TF.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv), H,
        *(torch.from_numpy(w.T.copy()) for w in ws),
        *(torch.from_numpy(b) for b in bs), cache=pc, training=False)
    _close(got, _np(want))
    if cached:
        assert pc.k.shape == (B, 4, H, D // H)


def test_decoder_incremental_cache_matches_reference():
    """The decoder of ``test_torch_transformer_decoder.py``'s Transformer
    (same seeds, same weights) stepped one target token at a time through
    ``gen_cache``'s self-attention and cross-attention caches, each step's
    output against the reference's own incremental decode."""
    paddle.seed(21)
    ref = jnn.Transformer(D, H, 2, 2, FF, dropout=0.0)
    ref.eval()
    state = _randomise(ref, 22)
    port = tnn.Transformer(D, H, 2, 2, FF, dropout=0.0, device='cpu').eval()
    load_paddle_tpu_state(port, state)
    rs = np.random.RandomState(23)
    src = rs.randn(B, LS, D).astype(np.float32)
    tgt = rs.randn(B, LT, D).astype(np.float32)
    rmem = ref.encoder(paddle.to_tensor(src))
    rcache = ref.decoder.gen_cache(rmem)
    with torch.no_grad():
        memory = port.encoder(torch.from_numpy(src))
        cache = port.decoder.gen_cache(memory)
        for t in range(LT):
            out, cache = port.decoder(torch.from_numpy(tgt[:, t:t + 1]),
                                      memory, None, None, cache)
            rout, rcache = ref.decoder(paddle.to_tensor(tgt[:, t:t + 1]),
                                       rmem, None, None, rcache)
            _close(out, _np(rout))
