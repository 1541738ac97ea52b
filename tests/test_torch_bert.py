"""The port's layers and BERT against the JAX package, on shared weights.

A small JAX ``BertModel`` (hidden 64, 2 layers, 4 heads, intermediate 128,
vocab 100, max_pos 64) gives its ``state_dict`` as numpy; the port loads it
through ``interop.load_paddle_tpu_state`` and both run the same numpy
inputs on the CPU (the JAX side through its composed XLA path, the port
through its kernels' plain versions). Tolerance: fp32, 1e-4 absolute for
the 2-layer model (products over 64-128 terms and two LayerNorms, summed in
different orders), 2e-5 for single layers.

``BertForPretraining`` (2 layers, hidden 64, 4 heads, L = 128, vocab 512)
is held the same way: logits, ``pretraining_loss`` with ``-1`` labels
ignored, and every gradient against ``jax.value_and_grad`` over
``functional_call`` at ``p = 0``, within 1e-4 of each gradient's largest
entry. The key projection's bias has a true gradient of zero (softmax is
invariant to a shift of a row's scores), so both sides hold rounding noise
of ~1e-8 there: the scale has a floor of 1e-3, the size of the model's
smaller gradients.
"""
import copy

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.nn.layer_base import functional_call, param_values
from paddle_tpu.text.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.bert import BertForPretraining as JaxBertForPretraining
from paddle_tpu.text.bert import BertModel as JaxBertModel

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.interop import (load_paddle_tpu_state,
                                      to_paddle_tpu_state)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.text.bert import (BertConfig, BertForPretraining,
                                        BertModel, bert_base, bert_large)

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


# ---------------------------------------------------------------------------
# pretraining heads, loss and gradients
# ---------------------------------------------------------------------------

PRETRAIN = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=128)
GRAD_TOL = 1e-4


def _pretrain_batch(seed=0, b=3, seq=128, ignore=True):
    """The feeds ``bench_bert`` makes: ids, token types, 15 % masked
    positions, their labels (a few -1, ignored) and NSP labels."""
    rs = np.random.RandomState(seed)
    n_masked = seq * 15 // 100
    feeds = {
        'input_ids': rs.randint(0, PRETRAIN['vocab_size'], (b, seq)),
        'token_type_ids': rs.randint(0, 2, (b, seq)),
        'masked_positions': np.stack([rs.choice(seq, n_masked, replace=False)
                                      for _ in range(b)]),
    }
    mlm = rs.randint(0, PRETRAIN['vocab_size'], (b, n_masked))
    if ignore:
        mlm[rs.rand(b, n_masked) < 0.2] = -1
    nsp = rs.randint(0, 2, (b, 1))
    return ({k: v.astype(np.int32) for k, v in feeds.items()},
            mlm.astype(np.int32), nsp.astype(np.int32))


@pytest.fixture(scope='module')
def pretrain_pair():
    paddle.seed(11)
    ref = JaxBertForPretraining(JaxBertConfig(**PRETRAIN))
    ref.eval()                                   # p = 0 on both sides
    # random values everywhere: zero biases and unit norms would hide a swap
    rs = np.random.RandomState(12)
    state = {k: (v + 0.05 * rs.randn(*v.shape)).astype(np.float32)
             for k, v in _state(ref).items()}
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    port = BertForPretraining(BertConfig(**PRETRAIN), device='cpu').eval()
    load_paddle_tpu_state(port, state)
    return ref, port


def _jax_loss_and_grads(ref, feeds, mlm, nsp):
    params = param_values(ref, trainable_only=False)

    def loss_of(p):
        (logits, nsp_logits), _ = functional_call(
            ref, p, JaxTensor(feeds['input_ids']),
            JaxTensor(feeds['token_type_ids']),
            masked_positions=JaxTensor(feeds['masked_positions']))
        return ref.pretraining_loss(logits, nsp_logits, JaxTensor(mlm),
                                    JaxTensor(nsp))._value
    return jax.value_and_grad(loss_of)(params)


def test_pretraining_forward_matches_reference(pretrain_pair):
    ref, port = pretrain_pair
    feeds, _, _ = _pretrain_batch()
    rlogits, rnsp = ref(**{k: paddle.to_tensor(v) for k, v in feeds.items()})
    with torch.no_grad():
        logits, nsp = port(**{k: torch.from_numpy(v)
                              for k, v in feeds.items()})
    assert logits.shape == (3, 19, 512) and nsp.shape == (3, 2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits._value),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    np.testing.assert_allclose(nsp.numpy(), np.asarray(rnsp._value),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    # without masked positions the MLM head runs on the whole sequence
    with torch.no_grad():
        full, _ = port(torch.from_numpy(feeds['input_ids']))
    assert full.shape == (3, 128, 512)


@pytest.mark.parametrize("ignore", [True, False])
def test_pretraining_loss_and_gradients_match_reference(pretrain_pair,
                                                        ignore):
    ref, port = pretrain_pair
    feeds, mlm, nsp = _pretrain_batch(seed=1, ignore=ignore)
    rloss, rgrads = _jax_loss_and_grads(ref, feeds, mlm, nsp)
    port = copy.deepcopy(port)
    logits, nsp_logits = port(**{k: torch.from_numpy(v)
                                 for k, v in feeds.items()})
    loss = port.pretraining_loss(logits, nsp_logits, torch.from_numpy(mlm),
                                 torch.from_numpy(nsp))
    assert abs(float(loss.detach()) - float(rloss)) <= \
        GRAD_TOL * abs(float(rloss))
    loss.backward()
    grads = to_paddle_tpu_state(port, grads=True)
    assert sorted(grads) == sorted(rgrads)
    for key, want in rgrads.items():
        want = np.asarray(want)
        assert grads[key].shape == want.shape, key
        scale = max(np.abs(want).max(), 1e-3)
        assert np.abs(grads[key] - want).max() <= GRAD_TOL * scale, key


def test_tied_decoder_is_one_parameter_listed_once(pretrain_pair):
    ref, port = pretrain_pair
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    assert 'cls.decoder_weight' not in port.state_dict()
    emb = port.bert.embeddings.word_embeddings.weight
    assert port.cls.decoder_weight is emb
    assert sum(p is emb for p in port.parameters()) == 1
    clone = copy.deepcopy(port)        # the tie survives a copy
    assert clone.cls.decoder_weight is \
        clone.bert.embeddings.word_embeddings.weight
    assert clone.cls.decoder_weight is not emb
    # (vocab, hidden), not transposed like a Linear
    state = _state(ref)
    np.testing.assert_array_equal(
        emb.detach().numpy(), state['bert.embeddings.word_embeddings.weight'])
    back = to_paddle_tpu_state(port)
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("reduction", ['mean', 'sum', 'none'])
def test_cross_entropy_matches_reference(reduction):
    rs = np.random.RandomState(5)
    logits = rs.randn(12, 7).astype(np.float32)
    labels = rs.randint(0, 7, 12).astype(np.int32)
    labels[[1, 4, 9]] = -1
    want = jnn.functional.cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(labels), ignore_index=-1,
        reduction=reduction)
    got = TF.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels), ignore_index=-1,
                           reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                               rtol=LAYER_TOL, atol=LAYER_TOL)
    # (N, 1) labels, and every label ignored: 0, not NaN
    got2 = TF.cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels)[:, None],
                            ignore_index=-1, reduction=reduction)
    assert torch.equal(got, got2)
    none = TF.cross_entropy(torch.from_numpy(logits),
                            torch.full((12,), -1), ignore_index=-1)
    assert float(none) == 0.0


def test_training_mode_shares_one_dropout_state():
    gen = torch.Generator().manual_seed(3)
    model = BertForPretraining(BertConfig(**PRETRAIN), device='cpu',
                               generator=gen).train()
    states = {id(m.dropout_state) for m in model.modules()
              if hasattr(m, 'dropout_state')}
    assert states == {id(model.dropout_state)}
    feeds, _, _ = _pretrain_batch(b=2)
    feeds = {k: torch.from_numpy(v) for k, v in feeds.items()}
    with torch.no_grad():
        a, _ = model(**feeds)
        # 1 embedding dropout + per layer attention and two epilogues
        assert model.dropout_state.offset == 1 + 3 * 2
        b, _ = model(**feeds)
        assert not torch.equal(a, b)
        model.dropout_state.offset = 0
        c, _ = model(**feeds)
        assert torch.equal(a, c)
        before = model.dropout_state.offset
        model.eval()(**feeds)
        assert model.dropout_state.offset == before   # eval draws nothing
