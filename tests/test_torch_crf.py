"""The port's linear-chain CRF (``F.linear_chain_crf``, ``F.crf_decoding``)
and the CRF half of its ``text.layers`` (``LinearChainCRF``,
``CRFDecoding``, ``SequenceTagging``) against the JAX package on shared
numpy inputs and weights.

Batch 6, 7 steps, 5 tags, ragged lengths from 1 to 7 (and all 7 when
none are passed); a second case at 40 x 6 x 57 (LAC's tag count) with
lengths drawn from [1, 6]. ``SequenceTagging`` at vocab 40, 7 tags,
embedding 8, hidden 6, two BiGRUs, batch 4 x 4 steps, its reference loss
and gradients under one ``jax.jit`` of ``jax.value_and_grad``
(``_torch_rnn_pair``). Tolerances, fp32: the per-sequence negative
log-likelihoods and the outputs within 1e-5 of their largest, the
gradients to the emissions, the transition and the parameters within
1e-4 of their largest (the reference's from ``jax.grad``; floor 1e-3 for
the tagger's); the Viterbi paths and the error mask equal.

Faults of the reference, each with a test here: ``SequenceTagging`` takes
``emb_learning_rate`` and ``crf_learning_rate`` and never uses them (the
port sets them on the embedding and the transition; the parity cases pass
1.0); and, followed by the port, ``_GRUEncoder`` passes no lengths, so
its reverse GRU starts in the padding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.text as jt
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.nn import functional as JF

import paddle_tpu_torch.text as tt
from paddle_tpu_torch.nn import functional as F

from _torch_rnn_pair import assert_close, port_run, ref_run, share

OUT_TOL, GRAD_TOL = 1e-5, 1e-4
CASES = {'small': (6, 7, 5, np.array([1, 7, 4, 2, 6, 3])),
         'lac_tags': (40, 6, 57, None)}


def _reference(emission, transition, label, lens):
    """The reference's results of a case under one ``jax.jit``: the NLL
    with lengths, its gradients (``jax.grad``), the paths and the error
    mask, and the NLL (at full lengths) and the paths without lengths."""
    def nll(e, w, length=None):
        return JF.linear_chain_crf(
            JaxTensor(e), JaxTensor(label), JaxTensor(w),
            length=None if length is None else JaxTensor(length))._value

    def all_of(e, w):
        grads = jax.grad(lambda e, w: jnp.sum(nll(e, w, lens)),
                         argnums=(0, 1))(e, w)
        args = [JaxTensor(e), JaxTensor(w)]
        decode = JF.crf_decoding
        return {'nll': nll(e, w, lens), 'grads': grads,
                'paths': decode(*args, length=JaxTensor(lens))._value,
                'mask': decode(*args, length=JaxTensor(lens),
                               label=JaxTensor(label))._value,
                # the reference fills in full lengths for None
                # (``crf.py:71-72``), which its tracing cannot take
                'nll_whole': nll(e, w, np.full_like(lens, e.shape[1])),
                'paths_whole': decode(*args)._value}
    return jax.tree_util.tree_map(np.asarray,
                                  jax.jit(all_of)(emission, transition))


@pytest.fixture(scope='module', params=sorted(CASES))
def case(request):
    B, T, D, lens = CASES[request.param]
    rs = np.random.RandomState(21)
    if lens is None:
        lens = rs.randint(1, T + 1, B)
    emission = rs.randn(B, T, D).astype(np.float32)
    transition = (0.5 * rs.randn(D + 2, D)).astype(np.float32)
    label = rs.randint(0, D, (B, T)).astype(np.int64)
    lens = lens.astype(np.int64)
    return (emission, transition, label, lens,
            _reference(emission, transition, label, lens))


def test_nll_and_gradients_match_reference(case):
    emission, transition, label, lens, ref = case
    e = torch.tensor(emission, requires_grad=True)
    w = torch.tensor(transition, requires_grad=True)
    got = F.linear_chain_crf(e, torch.from_numpy(label), w,
                             length=torch.from_numpy(lens))
    got.sum().backward()
    want = ref['nll']
    assert got.shape == want.shape == (emission.shape[0], 1)
    assert np.abs(got.detach().numpy() - want).max() <= \
        OUT_TOL * np.abs(want).max()
    for g, r in zip((e.grad, w.grad), ref['grads']):
        assert np.abs(g.numpy() - r).max() <= GRAD_TOL * np.abs(r).max()


def test_nll_without_lengths_matches_reference(case):
    emission, transition, label, _, ref = case
    got = F.linear_chain_crf(torch.from_numpy(emission),
                             torch.from_numpy(label),
                             torch.from_numpy(transition)).numpy()
    want = ref['nll_whole']
    assert np.abs(got - want).max() <= OUT_TOL * np.abs(want).max()


def test_viterbi_paths_and_error_mask_match_reference(case):
    emission, transition, label, lens, ref = case
    e, w = torch.from_numpy(emission), torch.from_numpy(transition)
    got = F.crf_decoding(e, w, length=torch.from_numpy(lens))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref['paths'])
    t = np.arange(emission.shape[1])[None]
    assert (got.numpy()[t >= lens[:, None]] == 0).all()
    np.testing.assert_array_equal(
        F.crf_decoding(e, w, length=lens,
                       label=torch.from_numpy(label)).numpy(), ref['mask'])
    np.testing.assert_array_equal(F.crf_decoding(e, w).numpy(),
                                  ref['paths_whole'])


def test_viterbi_path_is_the_best_scoring_one():
    """On 3 steps of 3 tags every path is scored by hand: the decoded one
    scores highest."""
    rs = np.random.RandomState(22)
    e = torch.from_numpy(rs.randn(1, 3, 3).astype(np.float32))
    w = torch.from_numpy(rs.randn(5, 3).astype(np.float32))
    path = F.crf_decoding(e, w)[0].tolist()

    def score(p):
        s = w[0, p[0]] + w[1, p[-1]] + sum(e[0, t, p[t]] for t in range(3))
        return float(s + sum(w[2 + p[t], p[t + 1]] for t in range(2)))
    best = max(((a, b, c) for a in range(3) for b in range(3)
                for c in range(3)), key=score)
    assert tuple(path) == best


# the text zoo's CRF half. SequenceTagging: vocab, tags, embedding, hidden;
# batch and steps
ST = (40, 7, 8, 6)
ST_B, ST_T = 4, 4
ST_LENS = np.array([4, 3, 1, 2], np.int64)


@pytest.fixture(scope='module')
def tagger():
    ref = jt.SequenceTagging(*ST, emb_learning_rate=1.0,
                             crf_learning_rate=1.0)
    port = tt.SequenceTagging(*ST, emb_learning_rate=1.0,
                              crf_learning_rate=1.0, device='cpu')
    share(ref, port, 26)
    rs = np.random.RandomState(27)
    words = rs.randint(1, ST[0], (ST_B, ST_T)).astype(np.int64)
    target = rs.randint(0, ST[1], (ST_B, ST_T)).astype(np.int64)
    return ref, port, words, target


def test_sequence_tagging_cost_paths_and_gradients_match_reference(tagger):
    ref, port, words, target = tagger

    def run(model, w, lens, tgt):
        cost, decoded = model(w, lens, tgt)
        return cost.mean(), [cost, decoded]
    inputs = [words, ST_LENS, target]
    got = port_run(port, run, inputs)
    assert_close(got, ref_run(ref, run, inputs), OUT_TOL, GRAD_TOL)
    with torch.no_grad():
        served = port(torch.from_numpy(words), ST_LENS)
    np.testing.assert_array_equal(served.numpy(), got[1][1])


def test_sequence_tagging_shares_one_transition(tagger):
    _, port, _, _ = tagger
    assert port.crf_decoding.transition is port.linear_chain_crf.transition
    assert sum(p is port.linear_chain_crf.transition
               for p in port.parameters()) == 1


def test_sequence_tagging_learning_rates_reference_ignores_them():
    """The reference's fault: ``emb_learning_rate`` and
    ``crf_learning_rate`` reach no parameter. The port's embedding and
    transition carry them."""
    ref = jt.SequenceTagging(*ST, emb_learning_rate=0.25,
                             crf_learning_rate=0.5)
    for p in (ref.word_embedding.weight, ref.linear_chain_crf.transition):
        assert getattr(p, 'optimize_attr', {}).get('learning_rate',
                                                   1.0) == 1.0
    port = tt.SequenceTagging(*ST, emb_learning_rate=0.25,
                              crf_learning_rate=0.5, device='cpu')
    assert port.word_embedding.weight.optimize_attr == {'learning_rate':
                                                        0.25}
    assert port.linear_chain_crf.transition.optimize_attr == \
        {'learning_rate': 0.5}
    assert port.fc.weight.optimize_attr == {'learning_rate': 1.0}


def test_gru_encoder_reverse_pass_starts_in_the_padding(tagger):
    """Followed from the reference (unverified against upstream): the
    tagger's encoder passes no lengths, so a row's backward GRU runs over
    its padding first, and a row's outputs change with the padding's ids
    (the reference's too)."""
    ref, port, _, _ = tagger
    rs = np.random.RandomState(31)
    words = rs.randint(1, ST[0], (1, ST_T)).astype(np.int64)
    other = words.copy()
    other[0, 3:] = (other[0, 3:] % (ST[0] - 2)) + 1
    ref_encode = jax.jit(lambda w: ref.gru_encoder(
        ref.word_embedding(JaxTensor(w)))._value)
    with torch.no_grad():
        for encode in (ref_encode, lambda w: port.gru_encoder(
                port.word_embedding(torch.from_numpy(w))).numpy()):
            emb = [np.asarray(encode(w)) for w in (words, other)]
            # the first 3 steps (inside a length-3 row) see the padding
            assert np.abs(emb[0][0, :3] - emb[1][0, :3]).max() > 1e-4


def test_crf_layers_match_reference():
    """``LinearChainCRF`` (the cost) and ``CRFDecoding`` (the paths and,
    with labels, the error mask) on their own transitions."""
    ref_cost, ref_dec = jt.LinearChainCRF(ST[1]), jt.CRFDecoding(ST[1])
    cost, dec = (tt.LinearChainCRF(ST[1], device='cpu'),
                 tt.CRFDecoding(ST[1], device='cpu'))
    share(ref_cost, cost, 34)
    share(ref_dec, dec, 35)
    rs = np.random.RandomState(36)
    em = rs.randn(ST_B, ST_T, ST[1]).astype(np.float32)
    label = rs.randint(0, ST[1], (ST_B, ST_T)).astype(np.int64)
    # the reference's cost and paths under one jax.jit (eagerly its
    # per-step loops take seconds)
    want, want_paths = jax.jit(lambda e: (
        ref_cost(JaxTensor(e), JaxTensor(label), JaxTensor(ST_LENS))._value,
        [ref_dec(JaxTensor(e), JaxTensor(ST_LENS),
                 None if lab is None else JaxTensor(lab))._value
         for lab in (None, label)]))(em)
    with torch.no_grad():
        got = cost(torch.from_numpy(em), torch.from_numpy(label),
                   ST_LENS).numpy()
    assert np.abs(got - want).max() <= OUT_TOL * np.abs(want).max()
    assert cost.weight is cost.transition
    for lab, want in zip((None, label), want_paths):
        got = dec(torch.from_numpy(em), ST_LENS,
                  None if lab is None else torch.from_numpy(lab))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
