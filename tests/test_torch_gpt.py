"""The port's GPT (``text/gpt.py``) against the JAX package's, on shared
weights, on the CPU.

A small JAX ``GPTModel`` (2 layers, hidden 64, 4 heads, vocab 97,
max_seq 64) gives its ``state_dict`` as numpy; the port loads it through
``interop.load_paddle_tpu_state`` unchanged (key by key: the ``Linear``
weights transposed, the tied ``wte`` not). Both run the same numpy ids.
The port's attention runs the flash kernel's plain version here (CPU
tensors), the JAX side its composed XLA path. Tolerance: fp32 logits and
KV buffers within 1e-5 absolute (two layers of 64- to 256-term products
summed in different orders); one attention call within 1e-6; greedy
``generate`` token for token, without and with an eos.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.text.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.text.gpt import GPTModel as JaxGPTModel

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.interop import load_paddle_tpu_state
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.text.gpt import GPTConfig, GPTModel, cached_attention

SMALL = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=64)
LOGIT_TOL = 1e-5
ATTN_TOL = 1e-6


def _state(layer):
    return {k: np.asarray(v._value) for k, v in layer.state_dict().items()}


@pytest.fixture(scope='module')
def pair():
    paddle.seed(11)
    ref = JaxGPTModel(JaxGPTConfig(**SMALL))
    ref.eval()
    port = GPTModel(GPTConfig(**SMALL), device='cpu').eval()
    load_paddle_tpu_state(port, _state(ref))
    return ref, port


def _ids(b=2, length=12, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, SMALL['vocab_size'], size=(b, length)).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).to(torch.int64)


@pytest.fixture(scope='module')
def jax_steps(pair):
    """The reference model's forward, loss and cached step, each under one
    ``jax.jit`` (its eager calls dispatch op by op), its weights baked in
    as constants."""
    ref, _ = pair

    def cached(ids, caches, pos):
        out, new = ref(JaxTensor(ids),
                       [(JaxTensor(k), JaxTensor(v)) for k, v in caches],
                       JaxTensor(pos))
        return out._value, [(k._value, v._value) for k, v in new]

    return (jax.jit(lambda ids: ref(JaxTensor(ids))._value),
            jax.jit(lambda ids, labels: ref.loss(JaxTensor(ids),
                                                 JaxTensor(labels))._value),
            jax.jit(cached))


# ---------------------------------------------------------------------------
# layers the model names
# ---------------------------------------------------------------------------

def test_gelu_sequential_and_layerlist_names():
    x = np.random.RandomState(1).randn(5, 33).astype(np.float32) * 3
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False))
    got = tnn.GELU()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    seq = tnn.Sequential(tnn.Linear(4, 8, device='cpu'), tnn.GELU(),
                         tnn.Linear(8, 4, device='cpu'))
    assert list(seq.state_dict()) == ['0.weight', '0.bias', '2.weight',
                                      '2.bias']
    ll = tnn.LayerList([tnn.LayerNorm(4, device='cpu') for _ in range(3)])
    assert [k.split('.')[0] for k in ll.state_dict()] == \
        ['0', '0', '1', '1', '2', '2']


def test_state_dict_loads_key_by_key(pair):
    ref, port = pair
    theirs = _state(ref)
    own = port.state_dict()
    assert list(own) == list(theirs)
    linear = {f'{n}.weight' for n, m in port.named_modules()
              if isinstance(m, tnn.Linear)}
    assert len(linear) == 4 * SMALL['num_layers']
    for key, value in theirs.items():
        got = own[key].numpy()
        np.testing.assert_array_equal(got.T if key in linear else got,
                                      value, err_msg=key)
    # the tied head reads wte untransposed: (vocab, hidden)
    assert tuple(port.wte.weight.shape) == (SMALL['vocab_size'],
                                            SMALL['hidden_size'])


# ---------------------------------------------------------------------------
# forward: no cache, cached prefill + decode
# ---------------------------------------------------------------------------

def test_no_cache_logits_and_loss(pair, jax_steps):
    _, port = pair
    logits, loss, _ = jax_steps
    ids = _ids()
    labels = _ids(seed=5)
    want = np.asarray(logits(jnp.asarray(ids)))
    want_loss = float(loss(jnp.asarray(ids), jnp.asarray(labels)))
    with torch.no_grad():
        got = port(_t(ids)).numpy()
        got_loss = float(port.loss(_t(ids), _t(labels)))
    assert got.shape == (2, 12, SMALL['vocab_size'])
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    assert abs(got_loss - want_loss) <= LOGIT_TOL


def test_cached_prefill_and_decode_logits(pair, jax_steps):
    ref, port = pair
    _, _, cached = jax_steps
    ids = _ids(length=9)
    steps = _ids(length=4, seed=3)
    T = ids.shape[1] + steps.shape[1]
    jc = [(k._value, v._value) for k, v in ref.init_caches(2, T)]
    tc = port.init_caches(2, T)
    jl, jc = cached(jnp.asarray(ids), jc, jnp.asarray(0))
    with torch.no_grad():
        tl, tc = port(_t(ids), tc, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=LOGIT_TOL, rtol=0)
    for i in range(steps.shape[1]):
        pos = ids.shape[1] + i
        tok = steps[:, i:i + 1]
        jl, jc = cached(jnp.asarray(tok), jc, jnp.asarray(pos))
        with torch.no_grad():
            tl, tc = port(_t(tok), tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0, err_msg=str(i))
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                   atol=LOGIT_TOL, rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                   atol=LOGIT_TOL, rtol=0)


def _qkv_buffers(seed, b=2, t=20, h=4, d=16, s=3, pos=7):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, s, h, d).astype(np.float32)
    kb = rs.randn(b, t, h, d).astype(np.float32)
    vb = rs.randn(b, t, h, d).astype(np.float32)
    return q, kb, vb


@pytest.mark.parametrize("pos,s", [(7, 1), (7, 3), (19, 1)])
def test_sliced_cache_attention_equals_whole_buffer(pos, s):
    q, kb, vb = (torch.from_numpy(a) for a in _qkv_buffers(0, s=s, pos=pos))
    sliced = cached_attention(q, kb, vb, pos)
    whole = cached_attention(q, kb, vb, pos, keys=kb.shape[1])
    # the keys past pos + s are -1e9 before an fp32 softmax: exactly 0
    torch.testing.assert_close(sliced, whole, atol=ATTN_TOL, rtol=0)


def test_flash_prefill_equals_reference_composition(pair):
    """At pos = 0 the port's cached attention is the causal flash forward
    over the prompt's q, k, v; the reference's ``_cached_attention``
    composes it over the whole T-long buffer with -1e9 on later keys."""
    ref, _ = pair
    b, s, t, h, d = 2, 12, 20, 4, 16
    rs = np.random.RandomState(4)
    q, k, v = (rs.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    zeros = np.zeros((b, t, h, d), np.float32)
    attn = ref.blocks[0].attn
    want, _ = attn._cached_attention(
        JaxTensor(jnp.asarray(q)), JaxTensor(jnp.asarray(k)),
        JaxTensor(jnp.asarray(v)),
        (JaxTensor(jnp.asarray(zeros)), JaxTensor(jnp.asarray(zeros))),
        JaxTensor(jnp.asarray(0)))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    flash = TF.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            training=False)
    np.testing.assert_allclose(flash.numpy(), np.asarray(want._value),
                               atol=ATTN_TOL, rtol=0)
    kbuf, vbuf = torch.zeros(b, t, h, d), torch.zeros(b, t, h, d)
    kbuf[:, :s], vbuf[:, :s] = kt, vt
    composed = cached_attention(qt, kbuf, vbuf, 0, keys=t)
    torch.testing.assert_close(flash, composed, atol=ATTN_TOL, rtol=0)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def greedy(pair):
    ref, port = pair
    ids = _ids(b=3, length=6, seed=9)
    want = np.asarray(ref.generate(ids, max_new_tokens=10)._value)
    port.train()
    got = port.generate(ids, max_new_tokens=10)
    assert port.training          # the call restored train()
    port.eval()
    return ids, want, got


def test_greedy_generate_token_exact(greedy):
    ids, want, got = greedy
    assert got.dtype == torch.int32 and got.device.type == 'cpu'
    assert got.shape == (3, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generate_with_eos_pads_like_reference(pair, greedy):
    ref, port = pair
    ids, plain, _ = greedy
    # an eos that row 0 emits mid-way: later tokens become eos there
    eos = int(plain[0, ids.shape[1] + 3])
    want = np.asarray(ref.generate(ids, max_new_tokens=10,
                                   eos_token_id=eos)._value)
    got = port.generate(ids, max_new_tokens=10, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, ids.shape[1] + 3:] == eos).all()


def test_sampled_generate_repeats_under_a_seed(pair):
    _, port = pair
    ids = _ids(b=2, length=5, seed=2)
    kw = dict(max_new_tokens=6, do_sample=True, top_k=5, top_p=0.9,
              temperature=0.7)
    a = port.generate(ids, seed=3, **kw)
    b = port.generate(ids, seed=3, **kw)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert (a[:, :5].numpy() == ids).all()


def test_generate_refuses_past_max_seq_and_ring_attention(pair,
                                                           jax_steps):
    ref, port = pair
    with pytest.raises(ValueError, match='exceeds max_seq_len'):
        port.generate(_ids(length=60), max_new_tokens=5)
    # use_ring_attention without a 'seq' axis: the causal attention of the
    # model without it, as the reference's ring falls back to its plain
    # attention (two ranks: tests/test_torch_ring_attention.py)
    ring = GPTModel(GPTConfig(use_ring_attention=True, **SMALL),
                    device='cpu').eval()
    ring.load_state_dict(port.state_dict())
    ids = _ids()
    with torch.no_grad():
        got = ring(_t(ids)).numpy()
        torch.testing.assert_close(ring(_t(ids)), port(_t(ids)),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jax_steps[0](ids)),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
