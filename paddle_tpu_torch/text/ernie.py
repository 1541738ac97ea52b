"""ERNIE 1.0. Counterpart of ``paddle_tpu/text/ernie.py``
(``ErnieModel``, ``ErnieForPretraining``, ``ErnieConfig``,
``ernie_knowledge_mask``, ``ernie_mask_batch``).

ERNIE's encoder is BERT's; what sets it apart is knowledge masking: whole
words and multi-word phrases or entities are masked as units, so the model
must recover them from their context rather than from their own wordpiece
fragments. The masking runs on the host in numpy and draws from a
``numpy.random.Generator``; it is the reference's code, so one seed gives
the same arrays in both packages. It emits fixed-width
``(masked_positions, masked_labels)`` of ``max_predictions`` a sample,
padded with label -1, which the MLM loss ignores.
"""
import numpy as np

from .bert import BertConfig, BertForPretraining, BertModel

__all__ = ['ErnieModel', 'ErnieForPretraining', 'ernie_knowledge_mask',
           'ernie_mask_batch', 'ErnieConfig']

ErnieConfig = BertConfig


class ErnieModel(BertModel):
    """The ERNIE encoder: BERT's architecture (ERNIE 2.0 large-en is
    ``bert_large(type_vocab_size=4)``). As in the reference, there is no
    task-type embedding."""


class ErnieForPretraining(BertForPretraining):
    """MLM + NSP pretraining on knowledge-masked batches: feed the
    ``(input_ids, masked_positions, masked_labels)`` of
    ``ernie_mask_batch`` as the BERT path's feeds; the heads and the loss
    are BERT's."""


def ernie_knowledge_mask(token_ids, word_boundaries, vocab_size,
                         max_predictions=20, mask_token_id=103,
                         masked_lm_prob=0.15, phrase_spans=None,
                         pad_token_id=0, rng=None):
    """Knowledge masking for one tokenized sequence.

    Args:
        token_ids: 1-D int array/list of wordpiece ids (already padded or not).
        word_boundaries: 1-D array, same length, giving the *word index* of
            every token (continuation wordpieces share their word's index;
            padding should carry -1). Masking decisions are made per word, and
            a selected word is masked in full — never a fragment.
        vocab_size: for the 10% random-replacement branch.
        max_predictions: static width K of the emitted position/label arrays.
        phrase_spans: optional list of ``(word_lo, word_hi)`` half-open word
            ranges marking entities/phrases; a selected phrase is masked as a
            single unit (ERNIE's phrase/entity-level masking).
        rng: ``numpy.random.Generator`` (defaults to a fresh one).

    Returns:
        ``(input_ids, masked_positions, masked_labels)`` numpy arrays; the
        last two have length ``max_predictions``, padded with position 0 and
        label -1 (the MLM loss ignore_index).
    """
    rng = rng or np.random.default_rng()
    if mask_token_id >= vocab_size:
        raise ValueError(
            "mask_token_id %d is outside vocab_size %d — pass the [MASK] id "
            "of your vocab" % (mask_token_id, vocab_size))
    ids = np.asarray(token_ids, dtype=np.int64).copy()
    words = np.asarray(word_boundaries, dtype=np.int64)
    if ids.shape != words.shape:
        raise ValueError("token_ids and word_boundaries length mismatch: "
                         "%s vs %s" % (ids.shape, words.shape))

    # group tokens into maskable units: phrases swallow their member words;
    # pad tokens are unmaskable whether marked by word index -1 or by id
    maskable = (words >= 0) & (ids != pad_token_id)
    valid_words = sorted(set(int(w) for w in words[maskable]))
    in_phrase = set()
    units = []   # each unit: list of word indices masked together
    for lo, hi in (phrase_spans or []):
        span = [w for w in valid_words if lo <= w < hi]
        if span:
            units.append(span)
            in_phrase.update(span)
    units.extend([[w] for w in valid_words if w not in in_phrase])

    target = max(1, int(round(masked_lm_prob * len(valid_words))))
    order = rng.permutation(len(units))
    positions, labels = [], []
    covered = 0
    for ui in order:
        if covered >= target or len(positions) >= max_predictions:
            break
        unit_words = units[ui]
        tok_pos = np.flatnonzero(np.isin(words, unit_words) & maskable)
        if len(positions) + len(tok_pos) > max_predictions:
            continue
        covered += len(unit_words)
        # 80/10/10 decided once per unit so a word is replaced coherently
        roll = rng.random()
        for p in tok_pos:
            positions.append(int(p))
            labels.append(int(ids[p]))
            if roll < 0.8:
                ids[p] = mask_token_id
            elif roll < 0.9:
                ids[p] = int(rng.integers(0, vocab_size))
            # else: keep original token

    k = max_predictions
    pos_out = np.zeros(k, dtype=np.int64)
    lab_out = np.full(k, -1, dtype=np.int64)
    pos_out[:len(positions)] = positions
    lab_out[:len(labels)] = labels
    return ids, pos_out, lab_out


def ernie_mask_batch(batch_token_ids, batch_word_boundaries, vocab_size,
                     max_predictions=20, phrase_spans=None, seed=None,
                     **kwargs):
    """Vectorized-batch convenience over :func:`ernie_knowledge_mask`;
    returns stacked ``(input_ids, masked_positions, masked_labels)``."""
    rng = np.random.default_rng(seed)
    outs = [ernie_knowledge_mask(
        t, b, vocab_size, max_predictions=max_predictions,
        phrase_spans=(phrase_spans[i] if phrase_spans else None),
        rng=rng, **kwargs)
        for i, (t, b) in enumerate(zip(batch_token_ids,
                                       batch_word_boundaries))]
    return tuple(np.stack(x) for x in zip(*outs))
