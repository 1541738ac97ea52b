"""The text tokenizer. Counterpart of the pure-Python path of
``paddle_tpu/_native/tokenizer.py`` (``Tokenizer``): a basic tokenizer
(Unicode words, each punctuation mark and ``_`` a token of its own, lower
case by default), optional wordpiece with a continuation prefix, and ids
from a vocabulary. The reference's ctypes half (the native hot loop for
ASCII lines, which gives the same ids) waits for the port of ``_native``
(ROADMAP Queue 1 item 3b), so ``native`` is always False here.
"""
import re

import numpy as np

__all__ = ['Tokenizer']

# word characters exclude '_', so an underscore splits as punctuation
_BASIC = re.compile(r"[^\W_]+|[^\s\w]|_", re.UNICODE)


class Tokenizer:
    """``vocab``: {token: id}."""

    def __init__(self, vocab, unk_token='[UNK]', lower=True,
                 wordpiece=False, cont_prefix='##', max_chars_per_word=100):
        self.vocab = dict(vocab)
        self.lower = lower
        self.wordpiece = wordpiece
        self.cont_prefix = cont_prefix
        self.max_chars = max_chars_per_word
        self.unk_id = self.vocab.get(unk_token, 0)

    @property
    def native(self):
        return False

    def encode(self, text, max_len=512):
        """text -> int32 ids, at most ``max_len``."""
        out = []
        for t in self._basic_tokens(text):
            if len(out) >= max_len:
                break
            if not self.wordpiece:
                out.append(self.vocab.get(t, self.unk_id))
            elif len(t) > self.max_chars:
                out.append(self.unk_id)
            else:
                out.extend(self._wordpieces(t))
        return np.asarray(out[:max_len], np.int32)

    def encode_batch(self, texts, max_len=512, pad_id=0):
        """list of str -> ((B, max_len) int32 ids padded with ``pad_id``,
        (B,) int32 lengths)."""
        ids = [self.encode(t, max_len) for t in texts]
        out = np.full((len(ids), max_len), pad_id, np.int32)
        lens = np.empty(len(ids), np.int32)
        for i, a in enumerate(ids):
            out[i, :len(a)] = a
            lens[i] = len(a)
        return out, lens

    def _basic_tokens(self, text):
        return _BASIC.findall(text.lower() if self.lower else text)

    def _wordpieces(self, token):
        """Greedy longest-match pieces of ``token``; [unk] when a part
        matches nothing."""
        start, pieces = 0, []
        while start < len(token):
            end = len(token)
            while end > start:
                sub = token[start:end]
                if start > 0:
                    sub = self.cont_prefix + sub
                if sub in self.vocab:
                    pieces.append(self.vocab[sub])
                    break
                end -= 1
            if end == start:
                return [self.unk_id]
            start = end
        return pieces
