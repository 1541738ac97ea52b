"""``nn/decode.py`` and ``gather_tree`` against the JAX package.

The same toy cells (logits ``W[token] + state @ U``, a ``tanh`` state
update), on the same numpy weights, run in the reference and in the port
on the CPU: ``BeamSearchDecoder`` + ``dynamic_decode`` (the ids after the
backtrace, the lengths, the final fp32 log-probabilities within 1e-5 of
their largest entry), with an early exit (the unwritten steps padded with
``end_token``), with the embedding and output functions; ``BasicDecoder``
with ``TrainingHelper`` and ``GreedyEmbeddingHelper``, also with
``impute_finished``; ``SampleEmbeddingHelper`` repeating under its seed;
the dense ``beam_search`` step and ``beam_search_decode``; ``gather_tree``
on random trees. Ids and lengths are compared exactly; the random logits
leave no ties.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import apply_op
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.nn.functional.extension import gather_tree as jax_gather_tree

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import decode as tdecode
from paddle_tpu_torch.nn import functional as TF

TOL = 1e-5


def _np(t):
    return np.asarray(t._value)


class _JaxCell:
    """The reference side of the toy cell."""

    def __init__(self, W, U):
        self.W, self.U = W, U

    def __call__(self, inputs, states):
        import jax.numpy as jnp
        W, U = self.W, self.U

        def fn(ids, st):
            logits = W[ids] + st @ U
            return logits, jnp.tanh(st + 0.1 * logits[:, :st.shape[-1]])
        return apply_op(fn, (inputs, states), n_outputs=2,
                        differentiable=False)


class _TorchCell:
    def __init__(self, W, U):
        self.W, self.U = torch.from_numpy(W), torch.from_numpy(U)

    def __call__(self, inputs, states):
        logits = self.W[inputs] + states @ self.U
        return logits, torch.tanh(states + 0.1 * logits[:, :states.shape[-1]])


def _toy(seed, V, H):
    rs = np.random.RandomState(seed)
    return (rs.randn(V, V).astype(np.float32),
            rs.randn(H, V).astype(np.float32))


def _beam_pair(W_m, U_m, beam, init, max_t, bos=0, eos=1):
    ref = jnn.BeamSearchDecoder(_JaxCell(W_m, U_m), start_token=bos,
                                end_token=eos, beam_size=beam)
    rout, rstates, rlen = jnn.dynamic_decode(
        ref, inits=paddle.to_tensor(init), max_step_num=max_t, is_test=True,
        return_length=True)
    port = tnn.BeamSearchDecoder(_TorchCell(W_m, U_m), start_token=bos,
                                 end_token=eos, beam_size=beam)
    out, states, length = tnn.dynamic_decode(
        port, inits=torch.from_numpy(init), max_step_num=max_t, is_test=True,
        return_length=True)
    return (rout, rstates, rlen), (out, states, length)


@pytest.mark.parametrize("beam,max_t", [(3, 12), (4, 20)])
def test_beam_search_decoder_matches_reference(beam, max_t):
    V, H, B = 11, 5, 3
    W_m, U_m = _toy(0, V, H)
    init = np.random.RandomState(1).randn(B, H).astype(np.float32)
    (rout, rstates, rlen), (out, states, length) = _beam_pair(
        W_m, U_m, beam, init, max_t)
    assert out.shape == (B, max_t, beam)
    np.testing.assert_array_equal(out.numpy(), _np(rout))
    np.testing.assert_array_equal(length.numpy(), _np(rlen))
    np.testing.assert_array_equal(states['finished'].numpy(),
                                  _np(rstates['finished']))
    want = _np(rstates['log_probs'])
    assert states['log_probs'].dtype == torch.float32
    assert np.abs(states['log_probs'].numpy() - want).max() <= \
        TOL * np.abs(want).max()


def test_early_exit_pads_with_end_token():
    V, H, B, beam = 5, 3, 1, 2
    W_m = np.full((V, V), -10.0, np.float32)
    W_m[0, 2], W_m[0, 3] = 5.0, 4.0          # from bos: 2, then 3
    W_m[2, 1] = W_m[3, 1] = 8.0              # then eos
    U_m = np.zeros((H, V), np.float32)
    init = np.zeros((B, H), np.float32)
    (rout, rstates, _), (out, states, _) = _beam_pair(W_m, U_m, beam, init,
                                                      10)
    ids = out.numpy()
    np.testing.assert_array_equal(ids, _np(rout))
    np.testing.assert_array_equal(ids[0, :2, 0], [2, 1])
    np.testing.assert_array_equal(ids[0, :2, 1], [3, 1])
    assert (ids[0, 2:] == 1).all()
    assert bool(states['finished'].all())


def test_early_exit_reads_finished_once_a_step(monkeypatch):
    """The loop's only host read: ``finished.all()`` once before each
    step after the probe, and once more to stop."""
    V, H, B, beam = 5, 3, 1, 2
    W_m = np.full((V, V), -10.0, np.float32)
    W_m[0, 2], W_m[0, 3] = 5.0, 4.0
    W_m[2, 4] = W_m[3, 4] = 6.0
    W_m[4, 1] = 8.0
    port = tnn.BeamSearchDecoder(_TorchCell(W_m, np.zeros((H, V),
                                                          np.float32)),
                                 0, 1, beam)
    reads = []
    real = torch.Tensor.__bool__

    def counted(self):
        reads.append(self.shape)
        return real(self)
    monkeypatch.setattr(torch.Tensor, '__bool__', counted)
    out, _ = tnn.dynamic_decode(port, inits=torch.zeros(B, H),
                                max_step_num=10, is_test=True)
    monkeypatch.undo()
    assert out.shape == (B, 10, beam)
    # steps 0, 1, 2 run (the third emits eos on every beam): reads before
    # steps 1 and 2 and the one that stops
    assert len(reads) == 3 and all(s == () for s in reads)


def test_embedding_and_output_functions():
    V, H, E, B, beam = 9, 4, 6, 2, 3
    rs = np.random.RandomState(5)
    emb = rs.randn(V, E).astype(np.float32)
    proj = rs.randn(H, V).astype(np.float32)
    A = rs.randn(E, H).astype(np.float32)
    init = rs.randn(B, H).astype(np.float32)

    def rcell(inputs, states):
        def fn(x, st):
            import jax.numpy as jnp
            new = jnp.tanh(x @ A + st)
            return new, new
        return apply_op(fn, (inputs, states), n_outputs=2)

    def tcell(inputs, states):
        new = torch.tanh(inputs @ torch.from_numpy(A) + states)
        return new, new
    ref = jnn.BeamSearchDecoder(
        rcell, 0, 1, beam,
        embedding_fn=lambda ids: apply_op(lambda i: emb[i], (ids,)),
        output_fn=lambda h: apply_op(lambda v: v @ proj, (h,)))
    rout, rst = jnn.dynamic_decode(ref, inits=paddle.to_tensor(init),
                                   max_step_num=8, is_test=True)
    port = tnn.BeamSearchDecoder(
        tcell, 0, 1, beam,
        embedding_fn=lambda ids: torch.from_numpy(emb)[ids],
        output_fn=lambda h: h @ torch.from_numpy(proj))
    out, st = tnn.dynamic_decode(port, inits=torch.from_numpy(init),
                                 max_step_num=8, is_test=True)
    np.testing.assert_array_equal(out.numpy(), _np(rout))
    want = _np(rst['log_probs'])
    assert np.abs(st['log_probs'].numpy() - want).max() <= \
        TOL * np.abs(want).max()


def test_tile_beam_merge_with_batch():
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    want = jnn.BeamSearchDecoder.tile_beam_merge_with_batch(
        paddle.to_tensor(x), 4)
    got = tnn.BeamSearchDecoder.tile_beam_merge_with_batch(
        torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def _rnn_pair(seed, E, H, V):
    rs = np.random.RandomState(seed)
    A, Bm, P = (rs.randn(E, H).astype(np.float32) * 0.5,
                rs.randn(H, H).astype(np.float32) * 0.5,
                rs.randn(H, V).astype(np.float32))

    def rcell(x, h):
        import jax.numpy as jnp
        out = apply_op(lambda xx, hh: jnp.tanh(xx @ A + hh @ Bm), (x, h))
        return out, out

    def tcell(x, h):
        out = torch.tanh(x @ torch.from_numpy(A) + h @ torch.from_numpy(Bm))
        return out, out
    return (rcell, lambda h: apply_op(lambda v: v @ P, (h,))), \
        (tcell, lambda h: h @ torch.from_numpy(P))


@pytest.mark.parametrize('impute', [False, True])
def test_training_helper_matches_reference(impute):
    B, T, E, H, V = 3, 6, 4, 5, 7
    rs = np.random.RandomState(7)
    inputs = rs.randn(B, T, E).astype(np.float32)
    seq_len = np.array([6, 3, 1], np.int64)
    (rcell, rproj), (tcell, tproj) = _rnn_pair(8, E, H, V)
    h0 = rs.randn(B, H).astype(np.float32)
    ref = jnn.BasicDecoder(rcell, jnn.TrainingHelper(
        paddle.to_tensor(inputs), paddle.to_tensor(seq_len)), rproj)
    rout, rst, rlen = jnn.dynamic_decode(
        ref, inits=paddle.to_tensor(h0), max_step_num=T, is_test=True,
        impute_finished=impute, return_length=True)
    port = tnn.BasicDecoder(tcell, tnn.TrainingHelper(
        torch.from_numpy(inputs), torch.from_numpy(seq_len)), tproj)
    out, st, length = tnn.dynamic_decode(
        port, inits=torch.from_numpy(h0), max_step_num=T, is_test=True,
        impute_finished=impute, return_length=True)
    np.testing.assert_array_equal(length.numpy(), _np(rlen))
    np.testing.assert_array_equal(length.numpy(), [6, 3, 1])
    for key in ('cell_outputs',):
        want = _np(rout[key])
        assert out[key].shape == want.shape
        assert np.abs(out[key].numpy() - want).max() <= \
            TOL * np.abs(want).max()
    np.testing.assert_array_equal(out['sample_ids'].numpy(),
                                  _np(rout['sample_ids']))
    want = _np(rst)
    assert np.abs(st.numpy() - want).max() <= TOL * np.abs(want).max()


def test_training_helper_time_major():
    B, T, E = 2, 4, 3
    x = torch.arange(B * T * E, dtype=torch.float32).reshape(T, B, E)
    helper = tnn.TrainingHelper(x, torch.tensor([4, 2]), time_major=True)
    first, fin = helper.initialize()
    assert torch.equal(first, x[0]) and not fin.any()
    fin, nxt, _ = helper.next_inputs(1, None, None, None)
    assert torch.equal(nxt, x[2]) and fin.tolist() == [False, True]


def test_greedy_embedding_helper_matches_reference():
    B, E, H, V = 3, 4, 5, 7
    rs = np.random.RandomState(9)
    emb = rs.randn(V, E).astype(np.float32)
    (rcell, rproj), (tcell, tproj) = _rnn_pair(10, E, H, V)
    h0 = rs.randn(B, H).astype(np.float32)
    start = np.zeros(B, np.int32)
    ref = jnn.BasicDecoder(rcell, jnn.GreedyEmbeddingHelper(
        lambda ids: apply_op(lambda i: emb[i], (ids,)), start, 1), rproj)
    rout, _, rlen = jnn.dynamic_decode(ref, inits=paddle.to_tensor(h0),
                                       max_step_num=9, is_test=True,
                                       return_length=True)
    port = tnn.BasicDecoder(tcell, tnn.GreedyEmbeddingHelper(
        lambda ids: torch.from_numpy(emb)[ids], torch.from_numpy(start), 1),
        tproj)
    out, _, length = tnn.dynamic_decode(port, inits=torch.from_numpy(h0),
                                        max_step_num=9, is_test=True,
                                        return_length=True)
    np.testing.assert_array_equal(out['sample_ids'].numpy(),
                                  _np(rout['sample_ids']))
    np.testing.assert_array_equal(length.numpy(), _np(rlen))
    np.testing.assert_array_equal(
        out['sample_ids'].numpy(), out['cell_outputs'].numpy().argmax(-1))


def test_sample_embedding_helper_repeats_under_its_seed():
    B, E, H, V = 4, 4, 5, 7
    emb = torch.randn(V, E, generator=torch.Generator().manual_seed(1))
    _, (tcell, tproj) = _rnn_pair(11, E, H, V)

    def run(seed):
        helper = tnn.SampleEmbeddingHelper(lambda ids: emb[ids],
                                           torch.zeros(B, dtype=torch.long),
                                           end_token=1,
                                           softmax_temperature=2.0,
                                           seed=seed)
        out, _ = tnn.dynamic_decode(tnn.BasicDecoder(tcell, helper, tproj),
                                    inits=torch.zeros(B, H), max_step_num=6,
                                    is_test=True)
        return out['sample_ids']
    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.min() >= 0 and a.max() < V


def test_decode_keeps_gradients_without_is_test():
    B, T, E, H, V = 2, 4, 3, 4, 5
    x = torch.randn(B, T, E, generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    _, (tcell, tproj) = _rnn_pair(12, E, H, V)
    dec = tnn.BasicDecoder(tcell, tnn.TrainingHelper(x, torch.tensor([4, 2])),
                           tproj)
    out, _ = tnn.dynamic_decode(dec, inits=torch.zeros(B, H), max_step_num=T)
    out['cell_outputs'].sum().backward()
    assert x.grad is not None and x.grad[0].abs().sum() > 0


@pytest.mark.parametrize('accumulated', [True, False])
def test_beam_search_op_matches_reference(accumulated):
    B, W, V = 3, 4, 9
    rs = np.random.RandomState(13)
    pre_ids = rs.randint(2, V, (B, W)).astype(np.int32)
    pre_ids[0, 1] = pre_ids[2, 0] = 1                  # finished beams
    pre_scores = -rs.rand(B, W).astype(np.float32)
    if accumulated:
        scores = rs.randn(B, W, V).astype(np.float32) - 2.0
    else:
        scores = rs.dirichlet(np.ones(V), (B, W)).astype(np.float32)
    want = jlayers.beam_search(
        paddle.to_tensor(pre_ids), paddle.to_tensor(pre_scores), None,
        paddle.to_tensor(scores), beam_size=W, end_id=1,
        is_accumulated=accumulated, return_parent_idx=True)
    got = tnn.beam_search(
        torch.from_numpy(pre_ids), torch.from_numpy(pre_scores), None,
        torch.from_numpy(scores), beam_size=W, end_id=1,
        is_accumulated=accumulated, return_parent_idx=True)
    for g, w in zip(got[::2], want[::2]):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    np.testing.assert_allclose(got[1].numpy(), _np(want[1]), rtol=TOL,
                               atol=TOL)
    two = tnn.beam_search(torch.from_numpy(pre_ids),
                          torch.from_numpy(pre_scores), None,
                          torch.from_numpy(scores), W, 1,
                          is_accumulated=accumulated)
    assert len(two) == 2 and torch.equal(two[0], got[0])


def _random_tree(seed, T, B, W, V=20):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, V, (T, B, W)).astype(np.int32),
            rs.randint(0, W, (T, B, W)).astype(np.int32))


@pytest.mark.parametrize('shape', [(1, 1, 1), (5, 2, 3), (9, 4, 4)])
def test_gather_tree_matches_reference(shape):
    ids, parents = _random_tree(14, *shape)
    want = jax_gather_tree(paddle.to_tensor(ids), paddle.to_tensor(parents))
    got = TF.gather_tree(torch.from_numpy(ids).long(),
                         torch.from_numpy(parents).long())
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert torch.equal(tnn.gather_tree(torch.from_numpy(ids),
                                       torch.from_numpy(parents)).long(),
                       got)


def test_beam_search_decode_matches_reference():
    ids, parents = _random_tree(15, 6, 2, 3)
    scores = np.random.RandomState(16).randn(6, 2, 3).astype(np.float32)
    rseq, rsc = jlayers.beam_search_decode(
        (paddle.to_tensor(ids), paddle.to_tensor(parents)),
        paddle.to_tensor(scores), beam_size=3, end_id=1)
    seq, sc = tnn.beam_search_decode(
        (torch.from_numpy(ids), torch.from_numpy(parents)),
        torch.from_numpy(scores), beam_size=3, end_id=1)
    np.testing.assert_array_equal(seq.numpy(), _np(rseq))
    np.testing.assert_array_equal(sc.numpy(), _np(rsc))


def test_max_step_num_defaults_to_the_fixed_bound():
    """The reference bounds the loop at 256 steps when ``max_step_num`` is
    None (a static bound for XLA), a documented divergence from upstream's
    unbounded loop; the port keeps it."""
    V, H = 6, 3
    W_m = np.zeros((V, V), np.float32)
    W_m[:, 2] = 10.0                          # never eos
    dec = tnn.BeamSearchDecoder(_TorchCell(W_m, np.zeros((H, V), np.float32)),
                                0, 1, 2)
    out, st = tnn.dynamic_decode(dec, inits=torch.zeros(1, H), is_test=True)
    assert out.shape == (1, 256, 2) and not st['finished'].any()
    assert tdecode._KINF == 1e9
