"""Paged KV cache: block-table attention for continuous-batching decode.
Counterpart of ``paddle_tpu/serving/paged_kv.py``.

The paged cache stores K/V in fixed-size **pages** ``[L, P, page_size, H,
D]`` and gives every sequence a **block table**: a fixed-length
``[max_pages]`` row of page indices. Memory is allocated page by page as
a sequence grows, so the same device memory sustains several times the
slot cache's concurrency; the only waste is the tail of the last page.

Three cooperating pieces:

- **device math** (plain torch ops; the reference's is composed XLA with
  no Pallas kernel): ``write_chunk`` / ``write_tokens`` scatter K/V
  through a block table, in place; ``attend_chunk`` / ``attend_tokens``
  gather a sequence's pages into a virtual ``[S, H, D]`` view and run
  position-masked attention (-1e30) over it. JAX clips a gather index and
  drops an out-of-range scatter where torch indexing would fault on the
  device, so every ``clip`` of the reference is kept. The padding rows of
  a chunk all go to the null page, several to one offset: a torch
  ``index_put_`` of duplicates writes one of them, which is harmless
  there, as it is in the reference.
- **``PageAllocator``** (host): a free list with refcounts. Page 0 is the
  reserved **null page** — block-table padding and masked writes land
  there, so inactive rows never corrupt live data.
- **``PrefixCache``** (host): hash-consing of *full* pages by
  content-chain digest (``chain_hashes``, byte for byte the reference's
  SHA-256 chain), LRU-evicted under allocation pressure, never evicting
  a page another sequence still references.
"""
import collections
import hashlib

import numpy as np
import torch

from ..device import resolve_device

__all__ = ['NULL_PAGE', 'PagesExhaustedError', 'PageAllocator', 'PrefixCache',
           'chain_hashes', 'create_paged_cache', 'write_chunk',
           'write_tokens', 'gather_kv', 'attend_chunk', 'attend_tokens']

# Block-table padding and masked (invalid) writes are routed to page 0; it
# is never handed out by the allocator and never read under a live mask.
NULL_PAGE = 0
_MASKED = -1e30


def _index(i):
    """A host int from an int or a 0-dim tensor."""
    return int(i.item() if isinstance(i, torch.Tensor) else i)


# ---------------------------------------------------------------------------
# device math (plain torch ops)
# ---------------------------------------------------------------------------

def create_paged_cache(num_layers, num_pages, page_size, num_heads, head_dim,
                       dtype=torch.float32, device=None):
    """Zeroed paged cache: ``{'k','v'}`` of ``[L, P, ps, H, D]`` on
    ``device`` (the CUDA device when None)."""
    shape = (int(num_layers), int(num_pages), int(page_size),
             int(num_heads), int(head_dim))
    device = resolve_device(device)
    return {'k': torch.zeros(shape, dtype=dtype, device=device),
            'v': torch.zeros(shape, dtype=dtype, device=device)}


def write_chunk(cache, layer, block_row, k, v, start, nvalid):
    """Scatter one sequence's chunk K/V (``[Cb, H, D]``) into its pages.

    Row ``i`` lands at absolute position ``start + i``; rows at or beyond
    ``nvalid`` (bucket padding) are routed to the null page.
    """
    layer = _index(layer)
    ps = cache['k'].shape[2]
    cb = k.shape[0]
    block_row = block_row.to(torch.int64)
    idx = torch.arange(cb, device=k.device)
    pos = start + idx
    valid = idx < nvalid
    slot = torch.clamp(pos // ps, 0, block_row.shape[0] - 1)
    pages = torch.where(valid, block_row[slot],
                        torch.full_like(slot, NULL_PAGE))
    offs = pos % ps
    cache['k'][layer, pages, offs] = k
    cache['v'][layer, pages, offs] = v
    return cache


def write_tokens(cache, layer, block_tables, k, v, positions):
    """Scatter per-slot K/V (``[B, K, H, D]``) at absolute ``positions``
    (``[B, K]``) through each slot's block-table row. Inactive slots carry
    an all-null block row, so their writes land in the null page."""
    layer = _index(layer)
    ps = cache['k'].shape[2]
    positions = positions.to(torch.int64)
    slot = torch.clamp(positions // ps, 0, block_tables.shape[1] - 1)
    pages = torch.gather(block_tables.to(torch.int64), 1, slot)  # [B, K]
    offs = positions % ps
    cache['k'][layer, pages, offs] = k
    cache['v'][layer, pages, offs] = v
    return cache


def gather_kv(cache, layer, block_tables):
    """Gather every slot's pages into virtual ``[B, MP*ps, H, D]`` K/V
    views (a page-index gather of fixed shape)."""
    layer = _index(layer)
    bt = block_tables.to(torch.int64)
    k = cache['k'][layer][bt]                    # [B, MP, ps, H, D]
    v = cache['v'][layer][bt]
    b, mp, ps, h, d = k.shape
    return k.reshape(b, mp * ps, h, d), v.reshape(b, mp * ps, h, d)


def attend_tokens(cache, layer, q, block_tables, positions):
    """Position-masked attention of per-slot queries over paged K/V.

    ``q`` is ``[B, K, H, D]`` (``K`` query tokens per slot — 1 for plain
    decode, ``draft_k+1`` for a speculative verify), ``positions``
    ``[B, K]`` their absolute positions. A query at position ``p`` sees
    keys at positions ``<= p``. Returns ``[B, K, H, D]``.
    """
    k, v = gather_kv(cache, layer, block_tables)
    d = q.shape[-1]
    scores = torch.einsum('bkhd,bshd->bkhs', q, k) / np.sqrt(float(d))
    s = torch.arange(k.shape[1], device=q.device)
    mask = s[None, None, None, :] <= positions[:, :, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, _MASKED))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum('bkhs,bshd->bkhd', w, v)


def attend_chunk(cache, layer, q, block_row, start):
    """One sequence's chunk attention over its own pages: ``q`` ``[Cb, H,
    D]`` at positions ``start + i``. The ``key_pos <= start + i`` mask
    yields causal attention over cached prefix + intra-chunk in one shot.
    Padded rows produce outputs the caller never reads."""
    layer = _index(layer)
    br = block_row.to(torch.int64)
    k = cache['k'][layer][br]                    # [MP, ps, H, D]
    v = cache['v'][layer][br]
    mp, ps, h, d = k.shape
    k = k.reshape(mp * ps, h, d)
    v = v.reshape(mp * ps, h, d)
    scores = torch.einsum('ihd,jhd->hij', q, k) / np.sqrt(float(d))
    i = start + torch.arange(q.shape[0], device=q.device)
    mask = torch.arange(mp * ps, device=q.device)[None, None, :] <= \
        i[None, :, None]
    scores = torch.where(mask, scores, torch.full_like(scores, _MASKED))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum('hij,jhd->ihd', w, v)


# ---------------------------------------------------------------------------
# host-side bookkeeping
# ---------------------------------------------------------------------------

class PagesExhaustedError(RuntimeError):
    """The page pool is empty: memory, not traffic, is the limit."""

    def __init__(self, num_pages):
        super().__init__(
            f"paged KV cache: all {num_pages - 1} usable page(s) are "
            "allocated — grow num_pages, shrink page_size tail waste, or "
            "enable prefix_cache for shared prompts")
        self.num_pages = num_pages


class PageAllocator:
    """Free-list page allocator with refcounts (prefix sharing).

    Page 0 is reserved as the null page and never allocated. ``alloc``
    returns a page with refcount 1; ``incref``/``decref`` manage sharing,
    and a page returns to the free list when its count reaches zero.
    """

    def __init__(self, num_pages):
        self.num_pages = int(num_pages)
        if self.num_pages < 2:
            raise ValueError(
                f"PageAllocator: need >= 2 pages (page 0 is the reserved "
                f"null page), got {num_pages}")
        self._free = collections.deque(range(1, self.num_pages))
        self._refs = {}
        self.allocated_total = 0
        self.freed_total = 0

    @property
    def usable(self):
        return self.num_pages - 1

    def free_count(self):
        return len(self._free)

    def used_count(self):
        return self.usable - len(self._free)

    def utilization(self):
        return self.used_count() / self.usable if self.usable else 0.0

    def alloc(self):
        if not self._free:
            raise PagesExhaustedError(self.num_pages)
        page = self._free.popleft()
        self._refs[page] = 1
        self.allocated_total += 1
        return page

    def incref(self, page):
        if page not in self._refs:
            raise ValueError(f"PageAllocator: incref of free page {page}")
        self._refs[page] += 1

    def decref(self, page):
        r = self._refs.get(page)
        if r is None:
            raise ValueError(f"PageAllocator: decref of free page {page}")
        if r == 1:
            del self._refs[page]
            self._free.append(page)
            self.freed_total += 1
        else:
            self._refs[page] = r - 1

    def refcount(self, page):
        return self._refs.get(page, 0)


def chain_hashes(tokens, page_size):
    """Content-chain digests for every FULL page of ``tokens``: digest
    ``i`` is SHA-256 over digest ``i - 1`` and page ``i``'s int32 bytes, so
    a digest match implies the entire prefix matches. The trailing partial
    page gets no digest (it is never shared)."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32).ravel())
    out = []
    digest = b''
    for i in range(len(toks) // int(page_size)):
        page = toks[i * page_size:(i + 1) * page_size]
        digest = hashlib.sha256(digest + page.tobytes()).digest()
        out.append(digest)
    return out


class PrefixCache:
    """Hash-consed full pages: chain digest -> page id, LRU-evicted.

    Every entry pins its page with one cache-owned allocator reference, so
    a cached prefix survives its original sequence finishing. Under
    allocation pressure ``evict_one`` releases the least-recently-used
    entry whose page is pinned *only* by the cache.
    """

    def __init__(self, allocator):
        self._alloc = allocator
        self._entries = collections.OrderedDict()    # digest -> page
        self.hits = 0
        self.misses = 0

    def __len__(self):
        return len(self._entries)

    def lookup(self, digest):
        """-> page id (increfed for the caller) or None. Counts hit/miss."""
        page = self._entries.get(digest)
        if page is None:
            self.misses += 1
            return None
        self._entries.move_to_end(digest)
        self._alloc.incref(page)
        self.hits += 1
        return page

    def probe(self, digests):
        """Count how many leading digests are cached (no refs taken, no
        hit/miss counted)."""
        n = 0
        for d in digests:
            if d not in self._entries:
                break
            n += 1
        return n

    def insert(self, digest, page):
        """Hash-cons ``page`` under ``digest`` (takes one cache-owned
        reference). A digest already consed keeps its existing page."""
        if digest in self._entries:
            return
        self._alloc.incref(page)
        self._entries[digest] = page

    def evict_one(self):
        """Release the LRU entry whose page only the cache still pins.
        Returns True when a page was freed back to the allocator."""
        for digest, page in self._entries.items():
            if self._alloc.refcount(page) == 1:
                del self._entries[digest]
                self._alloc.decref(page)
                return True
        return False

    def hit_rate(self):
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
