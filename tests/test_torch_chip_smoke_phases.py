"""``chip_smoke.py``'s phase table and the seq2seq phases' host-side
helpers, on the CPU.

``PHASES`` orders the run and says what each phase reads of earlier ones;
``selected_phases`` turns ``--phases`` into the phases to run. The beam
trace (``_traced_beams``) records each step's best ``beam + 1`` candidate
scores from the search's own candidate scores, which the near-tie rule
reads: here its first ``beam`` equal the scores the step selected, on a
small ``Seq2SeqTransformer`` (vocabularies 23 and 29, d_model 32, 2 + 2
layers). ``_s2s_loss_and_grads`` is the seq2seq parity's loss: the
target tokens' mean cross-entropy, within 1e-6 of torch's own.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs

from paddle_tpu_torch.text import Seq2SeqTransformer, seq2seq


def test_phase_table_is_ordered_and_each_read_has_an_earlier_giver():
    names = [p[0] for p in cs.PHASES]
    assert len(set(names)) == len(names)
    given = {}
    for name, reads, gives, run in cs.PHASES:
        assert callable(run)
        assert all(key in given for key in reads), (name, reads)
        assert not set(gives) & set(given), name
        given.update(dict.fromkeys(gives, name))
    assert names[-7:] == ['finetune_ernie', 'seq2seq_parity', 'seq2seq',
                          'rnn_parity', 'train_ptb_lm', 'train_lac',
                          'serve_lac']


def test_selected_phases_adds_what_a_phase_reads_in_run_order():
    assert cs.selected_phases(None) == cs.PHASES
    picked = [p[0] for p in cs.selected_phases(' routes, hapi_fit ')]
    assert picked == ['train', 'train_fp16_amp', 'hapi_fit', 'routes']
    assert [p[0] for p in cs.selected_phases('seq2seq_parity')] == \
        ['seq2seq_parity']
    assert [p[0] for p in cs.selected_phases('serve_fleet')] == \
        ['serve', 'serve_fleet']
    assert [p[0] for p in cs.selected_phases('serve_lac')] == \
        ['train_lac', 'serve_lac']
    for bad in ('nope', 'seq2seq,nope', ' , '):
        with pytest.raises(SystemExit):
            cs.selected_phases(bad)


def _tiny():
    return Seq2SeqTransformer(23, 29, d_model=32, nhead=4,
                              num_encoder_layers=2, num_decoder_layers=2,
                              dim_feedforward=64, dropout=0.0,
                              max_length=16, device='cpu').eval()


def test_traced_tops_start_with_the_selected_scores():
    model = _tiny()
    src = torch.from_numpy(np.random.RandomState(3).randint(2, 23, (3, 7)))
    base = seq2seq.BeamSearchDecoder
    with cs._traced_beams(tops=True) as trace:
        ids, _ = model.beam_decode(src, 0, 1, 3, 6)
    assert seq2seq.BeamSearchDecoder is base
    assert torch.equal(ids, model.beam_decode(src, 0, 1, 3, 6)[0])
    assert len(trace['tops']) == len(trace['outputs']) >= 1
    for top, out in zip(trace['tops'], trace['outputs']):
        assert top.shape == (3, 4)
        assert torch.equal(top[:, :3], out['scores'])
    ties = cs._near_ties(trace['tops'])
    assert len(ties) == 3


def test_near_ties_give_each_rows_first_close_step():
    tops = [torch.tensor([[0.0, -1.0, -2.0], [0.0, -5e-5, -1.0]]),
            torch.tensor([[0.0, -2e-5, -1.0], [0.0, -1.0, -1.0]])]
    assert cs._near_ties(tops) == [1, 0]
    assert cs._near_ties(tops[:1]) == [None, 0]


def test_s2s_loss_is_the_target_tokens_cross_entropy():
    model = _tiny().train()
    rs = np.random.RandomState(4)
    batch = (rs.randint(2, 23, (2, 7)), rs.randint(2, 29, (2, 5)),
             rs.randint(2, 29, (2, 5)))
    loss, grads = cs._s2s_loss_and_grads(model, batch, 'cpu')
    with torch.no_grad():
        logits = model(*(torch.from_numpy(a) for a in batch[:2]))
        want = torch.nn.functional.cross_entropy(
            logits.reshape(-1, 29), torch.from_numpy(batch[2]).reshape(-1))
    assert abs(loss - float(want)) <= 1e-6 * abs(float(want))
    assert sorted(grads) == sorted(n for n, _ in model.named_parameters())
    assert all(torch.isfinite(g).all() for g in grads.values())


def test_path_scores_are_the_crf_gold_scores():
    """``_path_scores`` (the near-tie rule's fp64 scores) is the CRF's gold
    score: the log-partition less the negative log-likelihood."""
    from paddle_tpu_torch.nn import functional as F
    rs = np.random.RandomState(5)
    em = torch.from_numpy(rs.randn(4, 6, 5))
    tr = torch.from_numpy(rs.randn(7, 5))
    lens = torch.tensor([6, 3, 1, 4])
    path = torch.from_numpy(rs.randint(0, 5, (4, 6)))
    nll = F.linear_chain_crf(em, path, tr, length=lens)[:, 0]
    log_z = nll + cs._path_scores(em, tr, path, lens)
    other = torch.from_numpy(rs.randint(0, 5, (4, 6)))
    torch.testing.assert_close(
        F.linear_chain_crf(em, other, tr, length=lens)[:, 0]
        + cs._path_scores(em, tr, other, lens), log_z)


def test_viterbi_held_counts_no_tie_and_refuses_a_worse_path():
    from paddle_tpu_torch.nn import functional as F
    rs = np.random.RandomState(6)
    em = torch.from_numpy(rs.randn(5, 7, 4).astype(np.float32))
    tr = torch.from_numpy(rs.randn(6, 4).astype(np.float32))
    lens = np.array([7, 2, 5, 1, 3])
    paths = F.crf_decoding(em, tr, length=torch.from_numpy(lens))
    assert cs._viterbi_held('t', em, tr, lens, paths) == 0
    worse = paths.clone()
    worse[0, 0] = (worse[0, 0] + 1) % 4
    with pytest.raises(AssertionError, match='beyond a near-tie'):
        cs._viterbi_held('t', em, tr, lens, worse)
