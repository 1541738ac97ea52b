"""Slot-based KV cache for iteration-level (continuous) batch decoding.
Counterpart of ``paddle_tpu/serving/kv_cache.py`` (``create_cache``,
``write_prompt``, ``write_token``, ``attend``, ``attend_prompt``,
``GenerativeSpec``, ``TinyCausalLM``).

The cache stores every layer's keys/values at fixed ``[max_batch,
max_seq]`` slots: requests join by writing their prefill K/V into a free
slot and leave by freeing it, while the decode step always runs at
``[max_batch]``. The fixed-slot layout is the memory baseline;
``paged_kv.py`` replaces the slots with block-table pages (the serving
default) and ``GenerativeSpec`` carries both contracts.

The cache is a dict ``{'k', 'v'}`` of tensors on the spec's device. The
reference's functions return new arrays (``jax.jit`` threads the cache);
here the writes go into the cache in place and the functions return it,
so callers written ``cache = write_token(cache, ...)`` read the same.
The attends are plain torch ops (``einsum``, ``softmax``), as the
reference's are composed XLA with no Pallas kernel; the masks keep the
reference's -1e30.

``TinyCausalLM`` is the reference ``GenerativeSpec`` (one pre-LN attention
block + tied output head) with the same numpy draws for ``random(...)``,
so a seed gives the reference's weights. ``reference_decode`` is its
no-cache greedy oracle.
"""
import numpy as np
import torch

from ..device import resolve_device
from . import paged_kv
from .paged_kv import _index

__all__ = ['create_cache', 'write_prompt', 'write_token', 'attend',
           'attend_prompt', 'GenerativeSpec', 'TinyCausalLM']

_MASKED = -1e30


def create_cache(num_layers, max_batch, max_seq, num_heads, head_dim,
                 dtype=torch.float32, device=None):
    """Zeroed cache: ``{'k','v'}`` of ``[L, B, S, H, D]`` on ``device``
    (the CUDA device when None)."""
    shape = (int(num_layers), int(max_batch), int(max_seq),
             int(num_heads), int(head_dim))
    device = resolve_device(device)
    return {'k': torch.zeros(shape, dtype=dtype, device=device),
            'v': torch.zeros(shape, dtype=dtype, device=device)}


def write_prompt(cache, layer, slot, k, v):
    """Write one sequence's prefill K/V (``[Lp, H, D]``) into ``slot`` at
    positions ``0..Lp-1``. Rows beyond the real length hold padding that
    ``attend`` masks out by position."""
    layer, slot, lp = _index(layer), _index(slot), k.shape[0]
    cache['k'][layer, slot, :lp] = k
    cache['v'][layer, slot, :lp] = v
    return cache


def write_token(cache, layer, k, v, positions):
    """Write one decode step's K/V (``[B, H, D]``) at per-slot
    ``positions`` (``[B]`` int). Inactive slots write at position 0 —
    harmless garbage that the next prefill into that slot overwrites."""
    layer = _index(layer)
    b = torch.arange(cache['k'].shape[1], device=positions.device)
    positions = positions.to(torch.int64)
    cache['k'][layer, b, positions] = k
    cache['v'][layer, b, positions] = v
    return cache


def attend(cache, layer, q, lengths):
    """Masked attention read over the cache: ``q`` ``[B, H, D]``,
    ``lengths`` ``[B]`` = number of valid positions per slot (the current
    token's K/V already written). Returns ``[B, H, D]``."""
    layer = _index(layer)
    k = cache['k'][layer]              # [B, S, H, D]
    v = cache['v'][layer]
    d = q.shape[-1]
    scores = torch.einsum('bhd,bshd->bhs', q, k) / np.sqrt(float(d))
    s = torch.arange(k.shape[1], device=q.device)
    mask = s[None, None, :] < lengths[:, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, _MASKED))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum('bhs,bshd->bhd', w, v)


def attend_prompt(q, k, v):
    """Causal self-attention within one prompt (prefill): ``[Lp, H, D]``
    each. Padded rows beyond the real length produce outputs the caller
    never reads (only the last real row's logits matter)."""
    d = q.shape[-1]
    lp = q.shape[0]
    scores = torch.einsum('ihd,jhd->hij', q, k) / np.sqrt(float(d))
    causal = torch.ones((lp, lp), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(causal[None], scores,
                         torch.full_like(scores, _MASKED))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum('hij,jhd->ihd', w, v)


def _gather_rows(table, idx):
    """``table[idx]`` with ``jnp`` indexing's semantics: a negative index
    counts from the end and the rest are clamped into range (torch
    indexing would fault on the device instead)."""
    n = table.shape[0]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return table[idx]


class GenerativeSpec:
    """What a model must provide to decode under continuous batching.

    Tokens, lengths and positions arrive as tensors on the serving
    engine's device (a spec with a ``device`` attribute must live on that
    device); ``slot``, ``length`` and ``start`` may be host ints.

    **Slot contract** (``register(..., kv_cache='slot')``):

    - ``init_cache() -> cache`` of ``[.., max_batch, max_seq, ..]`` tensors
    - ``prefill(cache, tokens[Lp], length, slot) -> (cache, logits[V])``
      — one padded prompt into ``slot``; the next-token logits at the last
      real position. ``Lp`` is one of ``prompt_buckets``.
    - ``decode(cache, tokens[B], positions[B]) -> (cache, logits[B, V])``
      — one token step for every slot at once, ``B == max_batch``.

    **Paged contract** (the default serving path — ``paged_kv.py`` has the
    primitives, ``paged_runner.py`` the scheduler):

    - ``init_paged_cache(num_pages, page_size) -> cache`` of
      ``[.., P, page_size, ..]`` tensors
    - ``prefill_chunk(cache, block_row[MP], tokens[Cb], start, length)
      -> (cache, logits[Cb, V])`` — one chunk of one sequence's prompt at
      absolute offset ``start``; rows at or beyond ``length`` are padding.
    - ``decode_paged(cache, block_tables[B, MP], tokens[B],
      positions[B]) -> (cache, logits[B, V])`` — one token per row.
    - ``verify_tokens(cache, block_tables[B, MP], tokens[B, K],
      positions[B, K]) -> (cache, logits[B, K, V])`` — ``K`` tokens per
      row in one step (the speculative-decoding verify; ``decode_paged``
      is its ``K=1`` case).
    """

    max_batch = 1
    max_seq = 128
    eos_id = None                      # None: stop only on max_new_tokens
    prompt_buckets = (16, 32, 64)

    def init_cache(self):
        raise NotImplementedError

    def prefill(self, cache, tokens, length, slot):
        raise NotImplementedError

    def decode(self, cache, tokens, positions):
        raise NotImplementedError

    # -- paged contract (kv_cache='paged', the default) -----------------
    def init_paged_cache(self, num_pages, page_size):
        raise NotImplementedError

    def prefill_chunk(self, cache, block_row, tokens, start, length):
        raise NotImplementedError

    def decode_paged(self, cache, block_tables, tokens, positions):
        cache, logits = self.verify_tokens(
            cache, block_tables, tokens[:, None], positions[:, None])
        return cache, logits[:, 0]

    def verify_tokens(self, cache, block_tables, tokens, positions):
        raise NotImplementedError


class TinyCausalLM(GenerativeSpec):
    """Reference spec: embed + learned positions, one pre-LN causal
    attention block with residual, tied vocab head.

    ``params`` maps ``emb [V,E]``, ``pos [max_seq,E]``, ``wq/wk/wv/wo
    [E,E]`` in the reference's ``(in, out)`` layout (a raw dict of
    tensors, used as ``x @ w``); the output head reuses ``emb`` transposed.
    ``device=None`` puts them on the CUDA device.
    """

    def __init__(self, params, num_heads, max_batch=4, max_seq=128,
                 eos_id=None, prompt_buckets=(8, 16, 32), device=None):
        self.device = resolve_device(device)
        self.p = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                  for k, v in params.items()}
        vocab, embed = self.p['emb'].shape
        if embed % num_heads:
            raise ValueError("embed dim must divide num_heads")
        self.num_heads = int(num_heads)
        self.head_dim = embed // num_heads
        self.vocab = vocab
        self.max_batch = int(max_batch)
        self.max_seq = int(max_seq)
        self.eos_id = eos_id
        self.prompt_buckets = tuple(sorted(prompt_buckets))

    @classmethod
    def random(cls, vocab=64, embed=32, num_heads=4, max_seq=64, seed=0,
               **kw):
        """Random instance (numpy RNG, host-side, the reference's draws)."""
        r = np.random.RandomState(seed)

        def w(*s):
            return (r.randn(*s) * 0.1).astype(np.float32)
        params = {'emb': w(vocab, embed), 'pos': w(max_seq, embed),
                  'wq': w(embed, embed), 'wk': w(embed, embed),
                  'wv': w(embed, embed), 'wo': w(embed, embed)}
        return cls(params, num_heads, max_seq=max_seq, **kw)

    # -- shared block ---------------------------------------------------
    def _norm(self, x):
        m = x.mean(dim=-1, keepdim=True)
        v = x.var(dim=-1, keepdim=True, unbiased=False)
        return (x - m) / torch.sqrt(v + 1e-5)

    def _qkv(self, x):
        h, d = self.num_heads, self.head_dim
        n = self._norm(x)

        def split(w):
            y = n @ w
            return y.reshape(y.shape[:-1] + (h, d))
        return split(self.p['wq']), split(self.p['wk']), split(self.p['wv'])

    def _head(self, y):
        return y @ self.p['emb'].t()

    def _embed(self, tokens, positions):
        return _gather_rows(self.p['emb'], tokens) + \
            _gather_rows(self.p['pos'], positions)

    def init_cache(self):
        return create_cache(1, self.max_batch, self.max_seq,
                            self.num_heads, self.head_dim,
                            device=self.device)

    def prefill(self, cache, tokens, length, slot):
        lp = tokens.shape[0]
        x = self._embed(tokens, torch.arange(lp, device=tokens.device))
        q, k, v = self._qkv(x)                              # [Lp, H, D]
        out = attend_prompt(q, k, v)
        y = x + out.reshape(lp, -1) @ self.p['wo']
        cache = write_prompt(cache, 0, slot, k, v)
        logits = self._head(y)                              # [Lp, V]
        return cache, logits[_index(length) - 1]

    def decode(self, cache, tokens, positions):
        x = self._embed(tokens, positions)                    # [B, E]
        q, k, v = self._qkv(x)                                # [B, H, D]
        cache = write_token(cache, 0, k, v, positions)
        out = attend(cache, 0, q, lengths=positions + 1)
        y = x + out.reshape(x.shape[0], -1) @ self.p['wo']
        return cache, self._head(y)

    # -- paged contract (see paged_kv.py) -------------------------------
    def init_paged_cache(self, num_pages, page_size):
        return paged_kv.create_paged_cache(
            1, num_pages, page_size, self.num_heads, self.head_dim,
            device=self.device)

    def prefill_chunk(self, cache, block_row, tokens, start, length):
        cb = tokens.shape[0]
        pos = torch.clamp(_index(start) + torch.arange(cb,
                                                       device=tokens.device),
                          max=self.max_seq - 1)
        x = self._embed(tokens, pos)                          # [Cb, E]
        q, k, v = self._qkv(x)                                # [Cb, H, D]
        cache = paged_kv.write_chunk(cache, 0, block_row, k, v, start,
                                     length)
        out = paged_kv.attend_chunk(cache, 0, q, block_row, start)
        y = x + out.reshape(cb, -1) @ self.p['wo']
        return cache, self._head(y)                           # [Cb, V]

    def verify_tokens(self, cache, block_tables, tokens, positions):
        pos = torch.clamp(positions, max=self.max_seq - 1)
        x = self._embed(tokens, pos)                          # [B, K, E]
        q, k, v = self._qkv(x)                                # [B, K, H, D]
        cache = paged_kv.write_tokens(cache, 0, block_tables, k, v,
                                      positions)
        out = paged_kv.attend_tokens(cache, 0, q, block_tables, positions)
        y = x + out.reshape(out.shape[0], out.shape[1], -1) @ self.p['wo']
        return cache, self._head(y)                           # [B, K, V]

    def reference_logits(self, tokens):
        """The no-cache forward of ``reference_decode``: logits ``[L, V]``
        of a whole sequence, each row the next-token logits after that
        position."""
        toks = torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device)
        x = self._embed(toks, torch.arange(len(toks), device=self.device))
        q, k, v = self._qkv(x)
        out = attend_prompt(q, k, v)
        y = x + out.reshape(len(toks), -1) @ self.p['wo']
        return self._head(y)

    def reference_decode(self, prompt, max_new_tokens):
        """Greedy decode with NO cache (full forward each step): the
        independent oracle the KV-cache path is verified against."""
        toks = list(np.asarray(prompt, np.int32))
        for _ in range(int(max_new_tokens)):
            nxt = int(torch.argmax(self.reference_logits(toks)[-1]))
            toks.append(nxt)
            if self.eos_id is not None and nxt == self.eos_id:
                break
        return toks[len(np.asarray(prompt)):]
