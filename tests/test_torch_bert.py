"""The port's layers and BERT against the JAX package, on shared weights.

A small JAX ``BertModel`` (hidden 64, 2 layers, 4 heads, intermediate 128,
vocab 100, max_pos 64) gives its ``state_dict`` as numpy; the port loads it
through ``interop.load_paddle_tpu_state`` and both run the same numpy
inputs on the CPU (the JAX side through its composed XLA path, the port
through its kernels' plain versions). Tolerance: fp32, 1e-4 absolute for
the 2-layer model (products over 64-128 terms and two LayerNorms, summed in
different orders), 2e-5 for single layers.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.text.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.bert import BertModel as JaxBertModel

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.interop import load_paddle_tpu_state
from paddle_tpu_torch.text.bert import (BertConfig, BertModel, bert_base,
                                        bert_large)

SMALL = dict(vocab_size=100, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=64)
MODEL_TOL = 1e-4
LAYER_TOL = 2e-5


def _state(layer):
    return {k: np.asarray(v._value) for k, v in layer.state_dict().items()}


@pytest.fixture(scope='module')
def pair():
    paddle.seed(7)
    ref = JaxBertModel(JaxBertConfig(**SMALL))
    ref.eval()
    port = BertModel(BertConfig(**SMALL), device='cpu').eval()
    load_paddle_tpu_state(port, _state(ref))
    return ref, port


def _inputs(kind, seed=0, b=3, seq=16):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, SMALL['vocab_size'], size=(b, seq)).astype(np.int32)
    feeds = {'input_ids': ids}
    if kind in ('padding', 'types'):
        mask = np.zeros((b, seq), np.int32)
        for i, n in enumerate([seq, 9, 0][:b]):   # row 2: all padding
            mask[i, :n] = 1
        feeds['attention_mask'] = mask
    if kind == 'types':
        feeds['token_type_ids'] = rs.randint(0, 2, size=(b, seq)).astype(
            np.int32)
    return feeds


@pytest.mark.parametrize("kind", ['none', 'padding', 'types'])
def test_bert_matches_reference(pair, kind):
    ref, port = pair
    feeds = _inputs(kind)
    rseq, rpooled = ref(**{k: paddle.to_tensor(v) for k, v in feeds.items()})
    with torch.inference_mode():
        seq, pooled = port(**{k: torch.from_numpy(v)
                              for k, v in feeds.items()})
    assert seq.shape == (3, 16, 64) and pooled.shape == (3, 64)
    assert torch.isfinite(seq).all() and torch.isfinite(pooled).all()
    np.testing.assert_allclose(seq.numpy(), np.asarray(rseq._value),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(rpooled._value),
                               atol=MODEL_TOL, rtol=MODEL_TOL)


def _layer_pairs():
    def mha():
        return (jnn.MultiHeadAttention(32, 4),
                tnn.MultiHeadAttention(32, 4, device='cpu'))

    def enc():
        return (jnn.TransformerEncoderLayer(32, 4, 64, activation='gelu'),
                tnn.TransformerEncoderLayer(32, 4, 64, activation='gelu',
                                            device='cpu'))
    return {
        'linear': lambda: (jnn.Linear(32, 48), tnn.Linear(32, 48,
                                                          device='cpu')),
        'layernorm': lambda: (jnn.LayerNorm(32),
                              tnn.LayerNorm(32, device='cpu')),
        'mha': mha,
        'encoder_layer': enc,
    }


@pytest.mark.parametrize("name", list(_layer_pairs()))
def test_layer_matches_reference(name):
    paddle.seed(3)
    ref, port = _layer_pairs()[name]()
    ref.eval()
    port.eval()
    # random values everywhere (LayerNorm's ones/zeros would hide a swap),
    # small enough that attention stays soft
    rs = np.random.RandomState(4)
    state = {k: (0.2 * rs.randn(*v.shape)).astype(np.float32)
             for k, v in _state(ref).items()}
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    load_paddle_tpu_state(port, state)
    x = rs.randn(2, 5, 32).astype(np.float32)
    out = port(torch.from_numpy(x))
    rout = ref(paddle.to_tensor(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(rout._value),
                               atol=LAYER_TOL, rtol=LAYER_TOL)


def test_interop_transposes_every_linear(pair):
    ref, port = pair
    state = _state(ref)
    w = state['encoder.layers.0.linear1.weight']
    assert w.shape == (64, 128)
    np.testing.assert_array_equal(
        port.encoder.layers[0].linear1.weight.detach().numpy(), w.T)
    # square projections are transposed too (shape cannot tell)
    q = state['encoder.layers.1.self_attn.q_proj.weight']
    np.testing.assert_array_equal(
        port.encoder.layers[1].self_attn.q_proj.weight.detach().numpy(),
        q.T)


@pytest.mark.parametrize("edit,match", [
    ('rename', 'missing keys'),
    ('extra', 'unexpected keys'),
    ('shape', 'has shape'),
])
def test_interop_rejects_bad_state(pair, edit, match):
    ref, _ = pair
    state = _state(ref)
    if edit == 'rename':
        state['pooler.dense.w'] = state.pop('pooler.dense.weight')
    elif edit == 'extra':
        state['pooler.extra'] = np.zeros(3, np.float32)
    else:   # a weight already in torch's (out, in) layout
        state['encoder.layers.0.linear1.weight'] = \
            state['encoder.layers.0.linear1.weight'].T
    fresh = BertModel(BertConfig(**SMALL), device='cpu')
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    with pytest.raises(ValueError, match=match):
        load_paddle_tpu_state(fresh, state)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, before[k])       # nothing copied


def test_state_dict_keys_match_reference(pair):
    ref, port = pair
    assert sorted(port.state_dict()) == sorted(ref.state_dict())


def test_bert_numbers_follow_reference():
    model = BertModel(BertConfig(**SMALL), device='cpu')
    assert model.embeddings.layer_norm.epsilon == 1e-12
    for layer in model.encoder.layers:
        assert layer.norm1.epsilon == layer.norm2.epsilon == 1e-5
        x = torch.linspace(-3, 3, 7)
        exact = 0.5 * x * (1 + torch.erf(x / 2 ** 0.5))
        torch.testing.assert_close(layer.activation(x), exact)
    large = bert_large()
    assert (large.hidden_size, large.num_hidden_layers,
            large.num_attention_heads, large.intermediate_size) == \
        (1024, 24, 16, 4096)
    base = bert_base()
    assert (base.hidden_size, base.num_hidden_layers) == (768, 12)


def test_initialisers_follow_reference_distributions():
    cfg = BertConfig(**{**SMALL, 'vocab_size': 4000})
    gen = torch.Generator().manual_seed(11)
    model = BertModel(cfg, device='cpu', generator=gen)
    w = model.embeddings.word_embeddings.weight.detach()
    assert abs(w.std().item() - 0.02) < 0.002 and abs(w.mean().item()) < 1e-3
    lin = model.encoder.layers[0].linear1
    limit = (6.0 / (64 + 128)) ** 0.5
    assert lin.weight.abs().max().item() <= limit
    assert lin.weight.abs().max().item() > 0.9 * limit
    assert (lin.bias == 0).all()
    norm = model.encoder.layers[0].norm1
    assert (norm.weight == 1).all() and (norm.bias == 0).all()
    # each encoder layer after the first re-draws its matrices
    a = model.encoder.layers[0].self_attn.q_proj.weight
    b = model.encoder.layers[1].self_attn.q_proj.weight
    assert not torch.equal(a, b)


def test_initialisers_draw_from_the_generator():
    def build(seed):
        return BertModel(BertConfig(**SMALL), device='cpu',
                         generator=torch.Generator().manual_seed(seed))
    s1, s2, s3 = (build(s).state_dict() for s in (5, 5, 6))
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert not torch.equal(s1['encoder.layers.1.linear2.weight'],
                           s3['encoder.layers.1.linear2.weight'])
    # no generator: a generator seeded with 0
    d1, d2 = BertModel(BertConfig(**SMALL), device='cpu').state_dict(), \
        build(0).state_dict()
    assert all(torch.equal(d1[k], d2[k]) for k in d1)
