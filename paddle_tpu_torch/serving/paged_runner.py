"""PagedGenerativeRunner: continuous batching over the paged KV cache.
Counterpart of ``paddle_tpu/serving/paged_runner.py``
(``PagedGenerativeRunner``, ``_Side``).

Sequences own **block tables** over a shared page pool instead of
max-length slots, so admission is gated on **free pages**, not free
slots. Three capabilities ride the page structure:

- **prefix caching** — full prompt pages are hash-consed by content-chain
  digest (``paged_kv.PrefixCache``); a request whose prompt prefix was
  served before adopts the cached pages (refcounted) and prefills only
  the tail. ``prefill_tokens`` counts *computed* tokens, so a prefix hit
  shows as a lower count.
- **chunked prefill** — a long prompt is processed one bucket-sized chunk
  per scheduler iteration, interleaved with the decode batch. Prompts are
  capped by ``max_seq`` and the page pool, not by the largest bucket.
- **speculative decoding** — a small draft spec proposes ``draft_k``
  tokens per round (``draft_k`` draft decodes, where the reference runs
  one ``lax.scan``), and the target verifies all of them in one batched
  ``verify_tokens`` step. Greedy acceptance keeps the output
  token-exact; rejected speculation is rolled back exactly (the K/V rows
  are dead, position-masked until overwritten, and the pages past the new
  frontier are freed).

Page exhaustion is a state of its own, distinct from overload: admission
blocks (``page_starved()``), decode rows stall, and when nothing can
progress the youngest sequence is **preempted** (pages freed, the request
re-admitted later through chunked prefill over prompt + generated —
greedy decode makes the recompute token-identical). A sequence that
stalls alone can never fit and fails instead of livelocking.

The port calls plain callables where the reference has
``compilecache.CachedJit``; ``warmup()`` still runs each program once.
Block tables live on the host (numpy) and go to the device per call; each
step reads its chosen tokens back (one sync per step). The telemetry is
the reference's, behind one flag check a site: the ``serving.kv.*``
gauges and stall counters, ``serving.spec.*``, ``serving.preemptions``,
the ``serving.page_exhausted`` / ``serving.preempt`` / ``serving.kv_stats``
events and the prefill, decode, propose and verify timers. The
``compilecache`` binding (``artifact_dir``) waits for ROADMAP.md, Queue 1
item 7.
"""
import collections

import numpy as np
import torch

from .. import observability as _obs
from .bucketing import pad_to_bucket, select_bucket
from .paged_kv import PageAllocator, PrefixCache, chain_hashes
from .runners import _count, _device_ints, _Stats, _to_host, finish_request
from .scheduler import STATUS_DEADLINE, STATUS_ERROR, STATUS_OK

__all__ = ['PagedGenerativeRunner']


class _PagedStats(_Stats):
    """Slot-runner tallies plus the paging/speculation surface."""

    def __init__(self):
        super().__init__()
        self.prefix_hit_pages = 0
        self.prefix_lookup_pages = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.preemptions = 0
        self.decode_stalls = 0
        self.prefill_stalls = 0

    def as_dict(self):
        d = super().as_dict()
        d.update({
            'prefix_hit_pages': self.prefix_hit_pages,
            'prefix_lookup_pages': self.prefix_lookup_pages,
            'spec_proposed': self.spec_proposed,
            'spec_accepted': self.spec_accepted,
            'draft_acceptance': (
                round(self.spec_accepted / self.spec_proposed, 4)
                if self.spec_proposed else 0.0),
            'preemptions': self.preemptions,
            'decode_stalls': self.decode_stalls,
            'prefill_stalls': self.prefill_stalls,
        })
        return d


class _Side:
    """One model's paged world: cache, allocator, block tables and
    (optionally) a prefix cache. The runner drives one of these for the
    target and — in speculative mode — a mirrored one for the draft."""

    def __init__(self, spec, rows, num_pages, page_size, max_seq,
                 prefix_cache):
        self.spec = spec
        self.page_size = int(page_size)
        self.rows = int(rows)
        self.max_pages = -(-int(max_seq) // self.page_size)      # ceil
        self.alloc = PageAllocator(num_pages)
        self.prefix = PrefixCache(self.alloc) if prefix_cache else None
        self.cache = spec.init_paged_cache(num_pages, page_size)
        self.blocks = np.zeros((self.rows, self.max_pages), np.int32)
        self.n_pages = [0] * self.rows
        self.peak_used = 0

    def _alloc_one(self):
        """One page, evicting unreferenced prefix-cache entries (LRU) under
        pressure. None when the pool is truly exhausted."""
        while True:
            if self.alloc.free_count():
                page = self.alloc.alloc()
                self.peak_used = max(self.peak_used,
                                     self.alloc.used_count())
                return page
            if self.prefix is None or not self.prefix.evict_one():
                return None

    def ensure(self, row, upto_pos):
        """Allocate block-table slots so position ``upto_pos`` is writable.
        False (with no damage beyond already-owned pages) when the pool is
        exhausted — the caller stalls, sheds, or preempts."""
        need = upto_pos // self.page_size + 1
        while self.n_pages[row] < need:
            page = self._alloc_one()
            if page is None:
                return False
            self.blocks[row, self.n_pages[row]] = page
            self.n_pages[row] += 1
        return True

    def evictable(self):
        if self.prefix is None:
            return 0
        return sum(1 for p in self.prefix._entries.values()
                   if self.alloc.refcount(p) == 1)

    def adopt_shared(self, row, pages):
        """Install prefix-hit pages (already increfed by ``lookup``) as the
        row's leading block-table entries."""
        for i, p in enumerate(pages):
            self.blocks[row, i] = p
        self.n_pages[row] = len(pages)

    def trim(self, row, keep_upto_pos):
        """Exact speculative rollback: free block-table slots beyond the
        one holding ``keep_upto_pos``. Shared prefix pages are never
        trimmed (the frontier never retreats into the prompt)."""
        keep = keep_upto_pos // self.page_size + 1
        while self.n_pages[row] > keep:
            n = self.n_pages[row] - 1
            self.alloc.decref(int(self.blocks[row, n]))
            self.blocks[row, n] = 0
            self.n_pages[row] = n

    def release(self, row):
        for i in range(self.n_pages[row]):
            self.alloc.decref(int(self.blocks[row, i]))
        self.blocks[row, :] = 0
        self.n_pages[row] = 0

    def register_prefix(self, row, digests, upto_pages):
        """Hash-cons the row's first ``upto_pages`` prompt pages, per
        completed chunk, so even admits later in the same iteration
        share them."""
        if self.prefix is None:
            return
        for i in range(min(upto_pages, len(digests))):
            self.prefix.insert(digests[i], int(self.blocks[row, i]))


def _argmax(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


class PagedGenerativeRunner:
    """Iteration-level continuous batching over ``paged_kv`` (see module
    docstring). The program set: one chunk prefill per prompt bucket (x2
    with a draft), one decode, and in speculative mode one draft decode,
    one propose (``draft_k`` draft decodes) and one verify — all run once
    by ``warmup()``."""

    kind = 'generative'

    def __init__(self, name, queue, spec, device, page_size=16,
                 num_pages=None, max_concurrency=None, draft=None,
                 draft_k=4, prefix_cache=True, default_max_new_tokens=32):
        self.name = name
        self.queue = queue
        self.spec = spec
        self.device = device
        self.page_size = int(page_size)
        if self.page_size < 1:
            raise ValueError(f"serving[{name}]: page_size must be >= 1, "
                             f"got {page_size}")
        self.rows = int(max_concurrency or spec.max_batch)
        self.buckets = tuple(sorted(spec.prompt_buckets))
        self.chunk = self.buckets[-1]
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.draft_k = int(draft_k)
        if draft is not None and self.draft_k < 1:
            raise ValueError(f"serving[{name}]: draft_k must be >= 1, "
                             f"got {draft_k}")
        if draft is not None and draft.max_seq < spec.max_seq:
            raise ValueError(
                f"serving[{name}]: draft max_seq {draft.max_seq} < target "
                f"max_seq {spec.max_seq} — the draft must cover every "
                "position it speculates at")
        max_pages = -(-int(spec.max_seq) // self.page_size)
        if num_pages is None:
            # worst case: every row at max_seq (+1 for the null page) —
            # no memory win by default; size it down to realize one
            num_pages = self.rows * max_pages + 1
        self.num_pages = int(num_pages)
        self.target = _Side(spec, self.rows, self.num_pages, self.page_size,
                            spec.max_seq, prefix_cache)
        self.draft = None
        if draft is not None:
            self.draft = _Side(draft, self.rows, self.num_pages,
                               self.page_size, spec.max_seq, prefix_cache)
        self.seqs = [None] * self.rows
        self.stats = _PagedStats()
        self.step_no = 0
        self.journal = collections.deque(maxlen=1024)
        self._preempted = collections.deque()
        self._page_starved = False
        self._stalled_this_pump = False
        self._digest_memo = {}

        def _prefill(cache, block_row, toks, start, length):
            cache, logits = spec.prefill_chunk(cache, block_row, toks,
                                               start, length)
            return cache, _argmax(logits)

        def _decode(cache, blocks, toks, pos):
            cache, logits = spec.decode_paged(cache, blocks, toks, pos)
            return cache, _argmax(logits)

        self._prefill = _prefill
        self._decode = _decode
        self._verify = self._propose = None
        self._draft_prefill = self._draft_decode = None
        if draft is not None:
            def _draft_prefill(cache, block_row, toks, start, length):
                cache, logits = draft.prefill_chunk(cache, block_row, toks,
                                                    start, length)
                return cache, _argmax(logits)

            def _draft_decode(cache, blocks, toks, pos):
                cache, logits = draft.decode_paged(cache, blocks, toks, pos)
                return cache, _argmax(logits)

            def _propose(cache, blocks, last, pos):
                # draft_k sequential greedy steps, the tokens kept on the
                # device (the reference's lax.scan)
                props = []
                cur = last
                for j in range(self.draft_k):
                    cache, logits = draft.decode_paged(cache, blocks, cur,
                                                       pos + j)
                    cur = _argmax(logits)
                    props.append(cur)
                return cache, torch.stack(props, dim=1)       # [B, k]

            def _verify(cache, blocks, toks, pos):
                cache, logits = spec.verify_tokens(cache, blocks, toks, pos)
                return cache, _argmax(logits)

            self._draft_prefill = _draft_prefill
            self._draft_decode = _draft_decode
            self._propose = _propose
            self._verify = _verify

    # -- helpers ---------------------------------------------------------
    def _tensor(self, a):
        return _device_ints(a, self.device)

    @staticmethod
    def _generated(s):
        """ALL tokens generated for this request: pre-preemption ('done',
        folded into the re-admitted prompt) + since (re-)admission."""
        return s['done'] + s['tokens']

    def _sides(self):
        return (self.target,) if self.draft is None else (self.target,
                                                          self.draft)

    @property
    def slots(self):
        """Slot-view compatibility: one entry per block-table row."""
        return list(self.seqs)

    def page_starved(self):
        """True when the last scheduler pass was blocked on free pages —
        the engine uses this to attribute sheds to memory pressure instead
        of traffic overload."""
        return self._page_starved or self._stalled_this_pump

    def kv_info(self):
        """Page, prefix and draft accounting of the target side."""
        t = self.target
        info = {
            'page_size': self.page_size,
            'num_pages': self.num_pages,
            'pages_used': t.alloc.used_count(),
            'pages_free': t.alloc.free_count(),
            'peak_pages_used': t.peak_used,
            'page_utilization': round(t.alloc.utilization(), 4),
            'max_concurrency': self.rows,
        }
        if t.prefix is not None:
            info.update({
                'prefix_pages_cached': len(t.prefix),
                'prefix_hits': t.prefix.hits,
                'prefix_misses': t.prefix.misses,
                'prefix_hit_rate': round(t.prefix.hit_rate(), 4),
            })
        if self.draft is not None:
            info['draft_k'] = self.draft_k
            info['draft_acceptance'] = (
                round(self.stats.spec_accepted / self.stats.spec_proposed, 4)
                if self.stats.spec_proposed else 0.0)
        return info

    def validate(self, req):
        toks = np.asarray(req.inputs.get('tokens', ()))
        if toks.size == 0:
            raise ValueError(
                f"serving[{self.name}]: generative request needs a "
                "non-empty 'tokens' input")
        n = toks.ravel().shape[0]
        if n + 1 > self.spec.max_seq:
            raise ValueError(
                f"serving[{self.name}]: prompt of {n} tokens leaves no "
                f"room to decode within max_seq {self.spec.max_seq} "
                "(chunked prefill lifts the per-bucket cap, not the "
                "sequence budget)")
        need = (n - 1) // self.page_size + 1
        if need > self.target.alloc.usable:
            raise ValueError(
                f"serving[{self.name}]: prompt needs {need} KV page(s) but "
                f"the pool holds {self.target.alloc.usable} — grow "
                "num_pages or page_size")

    def has_work(self):
        return (len(self.queue) > 0 or bool(self._preempted) or
                any(s is not None for s in self.seqs))

    def evict_in_flight(self):
        """Vacate every resident sequence AND the preempted backlog
        (engine shutdown): ``[(request, partial_outputs)]``."""
        out = []
        for row in range(self.rows):
            s = self.seqs[row]
            if s is None:
                continue
            self._release_row(row)
            self.stats.leaves += 1
            _count('serving.leaves')
            self.journal.append(('leave', s['req'].id, self.step_no))
            out.append((s['req'],
                        {'tokens': np.asarray(self._generated(s),
                                              np.int32)}))
        while self._preempted:
            item = self._preempted.popleft()
            out.append((item['req'],
                        {'tokens': np.asarray(item['tokens'], np.int32)}))
        return out

    def warmup(self):
        """Run the whole program set once against the null row/page (zero
        tokens, every write into the null page) -> programs run."""
        n = 0
        trow = self._tensor(np.zeros((self.target.max_pages,)))
        for cb in self.buckets:
            self.target.cache, t = self._prefill(
                self.target.cache, trow, self._tensor(np.zeros((cb,))), 0, 1)
            t.cpu()
            n += 1
        tblocks = self._tensor(np.zeros((self.rows, self.target.max_pages)))
        zb = self._tensor(np.zeros((self.rows,)))
        self.target.cache, t = self._decode(self.target.cache, tblocks, zb,
                                            zb)
        t.cpu()
        n += 1
        if self.draft is not None:
            drow = self._tensor(np.zeros((self.draft.max_pages,)))
            for cb in self.buckets:
                self.draft.cache, t = self._draft_prefill(
                    self.draft.cache, drow, self._tensor(np.zeros((cb,))),
                    0, 1)
                t.cpu()
                n += 1
            dblocks = self._tensor(np.zeros((self.rows,
                                             self.draft.max_pages)))
            self.draft.cache, t = self._draft_decode(self.draft.cache,
                                                     dblocks, zb, zb)
            t.cpu()
            self.draft.cache, t = self._propose(self.draft.cache, dblocks,
                                                zb, zb)
            t.cpu()
            zk = self._tensor(np.zeros((self.rows, self.draft_k + 1)))
            self.target.cache, t = self._verify(self.target.cache, tblocks,
                                                zk, zk)
            t.cpu()
            n += 3
        return n

    # -- one scheduler iteration -----------------------------------------
    def step(self):
        self.step_no += 1
        self._stalled_this_pump = False
        did = self._admit()
        did = self._prefill_pump() or did
        did = self._decode_pump() or did
        if not did and self._stalled_this_pump:
            did = self._relieve_pressure() or did
        if _obs.enabled():
            self._export_gauges()
        return did

    def _export_gauges(self):
        t = self.target
        _obs.gauge('serving.kv.page_utilization').set(
            round(t.alloc.utilization(), 4))
        _obs.gauge('serving.kv.pages_free').set(t.alloc.free_count())
        if t.prefix is not None:
            _obs.gauge('serving.kv.prefix_hit_rate').set(
                round(t.prefix.hit_rate(), 4))
            _obs.gauge('serving.kv.prefix_pages_cached').set(len(t.prefix))
        if self.draft is not None and self.stats.spec_proposed:
            _obs.gauge('serving.spec.acceptance_rate').set(round(
                self.stats.spec_accepted / self.stats.spec_proposed, 4))

    # -- admission (gated on free pages, not free slots) ------------------
    def _shared_probe(self, digests, n):
        """Side-effect-free count of prefix pages BOTH sides would hit.
        Capped at (n-1)//page_size: the last prompt token is always
        recomputed so its logits (-> first generated token) exist."""
        usable = min(len(digests), (n - 1) // self.page_size)
        common = usable
        for side in self._sides():
            if side.prefix is None:
                return 0
            common = min(common, side.prefix.probe(digests[:usable]))
        return common

    def _digests_for(self, prompt):
        return chain_hashes(prompt, self.page_size) \
            if any(s.prefix is not None for s in self._sides()) else []

    def _admittable(self, req):
        # only a PAGE shortfall raises the starvation flag; digests are
        # memoized for _start_seq (one SHA pass per admission attempt)
        prompt = np.asarray(req.inputs['tokens'], np.int32).ravel()
        digests = self._digests_for(prompt)
        self._digest_memo[req.id] = digests
        if self._feasible(prompt, digests):
            return True
        self._page_starved = True
        return False

    def _feasible(self, prompt, digests):
        """Do both sides have (free + LRU-evictable) pages for the whole
        prompt after prefix sharing?"""
        n = len(prompt)
        shared = self._shared_probe(digests, n)
        need = (n - 1) // self.page_size + 1 - shared
        return all(side.alloc.free_count() + side.evictable() >= need
                   for side in self._sides())

    def _admit(self):
        did = False
        free_rows = [i for i, s in enumerate(self.seqs) if s is None]
        self._page_starved = False
        self._digest_memo = {}
        if not free_rows:
            expired = self.queue.reap_expired()
            for r in expired:
                self._expire(r)
            return bool(expired)
        # re-admit preempted sequences first (they were admitted once)
        while free_rows and self._preempted:
            item = self._preempted[0]
            if 'digests' not in item:
                item['digests'] = self._digests_for(item['prompt'])
            if not self._feasible(item['prompt'], item['digests']):
                if all(side.alloc.free_count() + side.evictable() >=
                       side.alloc.usable for side in self._sides()):
                    # the pool is as empty as it can get and the sequence
                    # STILL does not fit: fail it, don't spin forever
                    self._preempted.popleft()
                    self.stats.errors += 1
                    finish_request(
                        item['req'], STATUS_ERROR,
                        {'tokens': np.asarray(item['tokens'], np.int32)},
                        error=RuntimeError(
                            f"serving[{self.name}]: preempted sequence "
                            "needs more KV pages than the pool holds "
                            f"({self.target.alloc.usable} usable) — grow "
                            "num_pages or lower max_new_tokens"))
                    did = True
                    continue
                self._page_starved = True
                break
            st = self._start_seq(free_rows[0], item['req'], item['prompt'],
                                 item['max_new'], item['tokens'],
                                 digests=item['digests'])
            if st == 'stall':
                self._page_starved = True
                break
            self._preempted.popleft()
            did = True
            if st == 'started':
                free_rows.pop(0)
        if not free_rows or self._page_starved:
            expired = self.queue.reap_expired()
            for r in expired:
                self._expire(r)
            return did or bool(expired)
        ready, expired = self.queue.pop_ready_while(self._admittable,
                                                    len(free_rows))
        for r in expired:
            self._expire(r)
        did = did or bool(expired)
        for n, r in enumerate(ready):
            did = True
            row = free_rows.pop(0)
            prompt = np.asarray(r.inputs['tokens'], np.int32).ravel()
            max_new = int(self.default_max_new_tokens
                          if r.max_new_tokens is None else r.max_new_tokens)
            st = self._start_seq(row, r, prompt, max_new, [],
                                 digests=self._digest_memo.get(r.id))
            if st == 'stall':
                # each feasibility check saw the pages before this pass's
                # admits took theirs: put this request and every one popped
                # behind it back at the head, in order (no shed — they were
                # admitted once). The reference puts back only this one and
                # drops the rest (ROADMAP.md, Queue 3)
                for later in reversed(ready[n:]):
                    self.queue.push_front(later)
                self._page_starved = True
                self.stats.prefill_stalls += 1
                _count('serving.kv.prefill_stalls')
                break
            if st != 'started':
                free_rows.insert(0, row)
        return did

    def _start_seq(self, row, req, prompt, max_new, tokens_done,
                   digests=None):
        """Admit one sequence into ``row``: adopt shared prefix pages,
        run the first prefill chunk. -> 'started' | 'stall' (nothing
        consumed) | 'failed' (request completed as error)."""
        n = len(prompt)
        if digests is None:
            digests = self._digests_for(prompt)
        usable = min(len(digests), (n - 1) // self.page_size) \
            if digests else 0
        adopted = []
        common = usable
        for side in self._sides():
            pages = []
            if side.prefix is not None:
                for d in digests[:common]:
                    page = side.prefix.lookup(d)
                    if page is None:
                        break
                    pages.append(page)
            common = min(common, len(pages))
            adopted.append((side, pages))
        for side, pages in adopted:
            while len(pages) > common:       # over-adopted vs the other side
                side.alloc.decref(pages.pop())
            side.adopt_shared(row, pages)
        c = common * self.page_size
        if common:
            self.stats.prefix_hit_pages += common
            _count('serving.kv.prefix_hit_pages', common)
        self.stats.prefix_lookup_pages += usable
        # 'done' holds tokens generated BEFORE a preemption; they are part
        # of the re-admitted prompt, so they must NOT also count into the
        # position invariant pos == len(prompt) + len(tokens) - 1 that the
        # decode/speculation paths keep. 'tokens' is generation since
        # (re-)admission only; outputs/limits use done + tokens.
        s = {'req': req, 'prompt': np.asarray(prompt, np.int32),
             'done': list(tokens_done), 'tokens': [], 'last': None,
             'pos': 0, 'max_new': int(max_new), 'fill_next': c,
             'shared': c, 'ready': False, 'joined': self.step_no,
             'digests': digests, 'draft_pos': None}
        self.seqs[row] = s
        st = self._fill_chunk(row)
        if st == 'stall':
            self._release_row(row)
            return 'stall'
        if st == 'failed':
            return 'failed'
        self.stats.joins += 1
        _count('serving.joins')
        self.journal.append(('join', req.id, self.step_no))
        if _obs.enabled():
            _obs.event('serving.join', model=self.name, request=req.id,
                       slot=row, prompt_len=n,
                       prefix_hit_pages=common,
                       chunked=bool(s['fill_next'] < n))
        if st == 'done':
            self._maybe_finish(row)
        return 'started'

    # -- chunked prefill --------------------------------------------------
    def _fill_chunk(self, row):
        """One prompt chunk for ``row`` on both sides. -> 'done' | 'more'
        | 'stall' | 'failed'."""
        s = self.seqs[row]
        n = len(s['prompt'])
        start = s['fill_next']
        remaining = n - start
        nvalid = min(remaining, self.chunk)
        cb = self.chunk if remaining > self.chunk \
            else select_bucket(remaining, self.buckets)
        for side in self._sides():
            if not side.ensure(row, start + nvalid - 1):
                self._page_stall('prefill')
                return 'stall'
        padded = self._tensor(pad_to_bucket(
            s['prompt'][start:start + nvalid], cb))
        try:
            with _obs.timer('serving.prefill', model=self.name,
                            bucket=cb) as t:
                self.target.cache, toks = self._prefill(
                    self.target.cache, self._tensor(self.target.blocks[row]),
                    padded, start, nvalid)
                if self.draft is not None:
                    self.draft.cache, _ = self._draft_prefill(
                        self.draft.cache,
                        self._tensor(self.draft.blocks[row]),
                        padded, start, nvalid)
                first = int(_to_host(toks[nvalid - 1])) \
                    if start + nvalid >= n else None
            s['req'].add_phase_ms('prefill', t.elapsed_ms)
            if _obs.enabled():
                _obs.async_instant('prefill_chunk', s['req'].id,
                                   cat='serving.request', start=start,
                                   bucket=cb, n=nvalid)
        except Exception as e:               # model bug: fail the request,
            self._fail_row(row, e)           # not the engine worker
            return 'failed'
        s['fill_next'] = start + nvalid
        self.stats.prefill_tokens += nvalid
        _count('serving.prefill_tokens', nvalid)
        # hash-cons every page this chunk completed, immediately: admits
        # later in the SAME iteration already share them
        for side in self._sides():
            side.register_prefix(row, s['digests'],
                                 s['fill_next'] // self.page_size)
        if s['fill_next'] < n:
            return 'more'
        s['tokens'].append(first)
        s['last'] = first
        s['pos'] = n
        s['ready'] = True
        if self.draft is not None:
            s['draft_pos'] = n
        return 'done'

    def _prefill_pump(self):
        """One chunk per still-filling row per iteration: long prompts
        admit in slices interleaved with the decode batch."""
        did = False
        for row in range(self.rows):
            s = self.seqs[row]
            if s is None or s['ready']:
                continue
            st = self._fill_chunk(row)
            if st == 'done':
                self._maybe_finish(row)
            if st in ('done', 'more', 'failed'):
                did = True
        return did

    # -- decode -----------------------------------------------------------
    def _decode_pump(self):
        ready = [i for i in range(self.rows)
                 if self.seqs[i] is not None and self.seqs[i]['ready']]
        if not ready:
            return False
        if self.draft is None:
            return self._plain_decode(ready)
        spec_rows, plain_rows = [], []
        for i in ready:
            s = self.seqs[i]
            # rows too close to max_seq (or whose draft fell >1 behind)
            # finish on the plain path
            if (s['pos'] + self.draft_k <= self.spec.max_seq - 1 and
                    s['pos'] - s['draft_pos'] <= 1):
                spec_rows.append(i)
            else:
                plain_rows.append(i)
        did = False
        if plain_rows:
            did = self._plain_decode(plain_rows) or did
        if spec_rows:
            did = self._spec_round(spec_rows) or did
        return did

    def _masked_blocks(self, side, rows):
        """Block tables (on the device) with non-participant rows nulled:
        their (ignored) writes land in the null page instead of live
        pages."""
        blocks = np.zeros_like(side.blocks)
        for i in rows:
            blocks[i] = side.blocks[i]
        return self._tensor(blocks)

    def _plain_decode(self, rows):
        run = []
        for i in rows:
            if self.target.ensure(i, self.seqs[i]['pos']):
                run.append(i)
            else:
                self._page_stall('decode')
        if not run:
            return False
        b = self.rows
        toks = np.zeros((b,), np.int32)
        pos = np.zeros((b,), np.int32)
        for i in run:
            toks[i] = self.seqs[i]['last']
            pos[i] = self.seqs[i]['pos']
        self.stats.batches += 1
        _count('serving.decode_steps')
        self.stats.occupancy(len(run) / b)
        try:
            with _obs.timer('serving.decode', model=self.name,
                            active=len(run)) as t:
                self.target.cache, nxt = self._decode(
                    self.target.cache, self._masked_blocks(self.target, run),
                    self._tensor(toks), self._tensor(pos))
                nxt = _to_host(nxt)
        except Exception as e:
            for i in run:
                self._fail_row(i, e)
            return True
        telemetry = _obs.enabled()
        for i in run:
            s = self.seqs[i]
            s['pos'] += 1
            tok = int(nxt[i])
            s['tokens'].append(tok)
            s['last'] = tok
            s['req'].add_phase_ms('decode', t.elapsed_ms)
            self.stats.decode_tokens += 1
            _count('serving.decode_tokens')
            if telemetry:
                _obs.async_instant('decode', s['req'].id,
                                   cat='serving.request',
                                   tokens=len(self._generated(s)))
            self._maybe_finish(i)
        return True

    def _spec_round(self, rows):
        """Draft proposes ``k`` tokens, target verifies all of them plus
        the pending token in ONE batched step; greedy accept keeps the
        stream token-exact and rejected pages are freed (exact
        rollback)."""
        k = self.draft_k
        run = []
        for i in rows:
            s = self.seqs[i]
            if (self.target.ensure(i, s['pos'] + k) and
                    self.draft.ensure(i, s['pos'] + k - 1)):
                run.append(i)
            else:
                self._page_stall('decode')
        if not run:
            return False
        b = self.rows
        # 1) catch-up: after a fully-accepted round the draft is one
        #    committed token behind — ingest it (one batched decode)
        behind = [i for i in run
                  if self.seqs[i]['pos'] - self.seqs[i]['draft_pos'] == 1]
        self.stats.batches += 1
        _count('serving.decode_steps')
        self.stats.occupancy(len(run) / b)
        try:
            if behind:
                ctoks = np.zeros((b,), np.int32)
                cpos = np.zeros((b,), np.int32)
                for i in behind:
                    s = self.seqs[i]
                    d = s['draft_pos']
                    ctoks[i] = s['tokens'][d - len(s['prompt'])]
                    cpos[i] = d
                self.draft.cache, _ = self._draft_decode(
                    self.draft.cache, self._masked_blocks(self.draft,
                                                          behind),
                    self._tensor(ctoks), self._tensor(cpos))
                for i in behind:
                    self.seqs[i]['draft_pos'] += 1
            # 2) propose
            last = np.zeros((b,), np.int32)
            pos = np.zeros((b,), np.int32)
            for i in run:
                last[i] = self.seqs[i]['last']
                pos[i] = self.seqs[i]['pos']
            sw = _obs.Stopwatch()
            with _obs.timer('serving.propose', model=self.name, k=k):
                self.draft.cache, props_t = self._propose(
                    self.draft.cache, self._masked_blocks(self.draft, run),
                    self._tensor(last), self._tensor(pos))
            # 3) verify: [last, t1..tk] at positions pos..pos+k — one
            #    step, fed the proposals on the device
            with _obs.timer('serving.verify', model=self.name, k=k):
                vtoks = torch.cat([self._tensor(last)[:, None], props_t],
                                  dim=1)
                vpos = self._tensor(pos[:, None] + np.arange(
                    k + 1, dtype=np.int32))
                self.target.cache, greedy = self._verify(
                    self.target.cache, self._masked_blocks(self.target, run),
                    vtoks, vpos)
                props = _to_host(props_t)                  # [B, k]
                greedy = _to_host(greedy)                  # [B, k+1]
            ms = sw.elapsed_ms()
        except Exception as e:
            for i in run:
                self._fail_row(i, e)
            return True
        for i in run:
            self.seqs[i]['draft_pos'] = self.seqs[i]['pos'] + k
        # 4) accept/commit + exact page rollback
        telemetry = _obs.enabled()
        for i in run:
            s = self.seqs[i]
            m = 0
            while m < k and props[i, m] == greedy[i, m]:
                m += 1
            s['req'].add_phase_ms('verify', ms)
            if telemetry:
                _obs.async_instant('verify', s['req'].id,
                                   cat='serving.request', proposed=k,
                                   accepted=m)
            self.stats.spec_proposed += k
            self.stats.spec_accepted += m
            _count('serving.spec.proposed', k)
            _count('serving.spec.accepted', m)
            eos = self.spec.eos_id
            commit = [int(t) for t in props[i, :m]] + [int(greedy[i, m])]
            for tok in commit:
                s['tokens'].append(tok)
                s['last'] = tok
                self.stats.decode_tokens += 1
                _count('serving.decode_tokens')
                if (len(self._generated(s)) >= s['max_new'] or
                        (eos is not None and tok == eos)):
                    break
            s['pos'] = len(s['prompt']) + len(s['tokens']) - 1
            s['draft_pos'] = min(s['draft_pos'], s['pos'])
            self.target.trim(i, s['pos'])
            self.draft.trim(i, s['draft_pos'])
            self._maybe_finish(i)
        return True

    # -- pressure ---------------------------------------------------------
    def _page_stall(self, where):
        self._stalled_this_pump = True
        if where == 'decode':
            self.stats.decode_stalls += 1
            _count('serving.kv.decode_stalls')
        else:
            self.stats.prefill_stalls += 1
            _count('serving.kv.prefill_stalls')
        if _obs.enabled():
            _obs.event('serving.page_exhausted', model=self.name,
                       where=where,
                       pages_free=self.target.alloc.free_count())

    def _relieve_pressure(self):
        """Nothing progressed and something stalled on pages: preempt the
        youngest sequence (pages freed; it re-admits later via chunked
        prefill over prompt+generated — token-identical under greedy).
        A sequence stalling *alone* can never fit: fail it instead."""
        active = [i for i in range(self.rows) if self.seqs[i] is not None]
        if not active:
            return False
        victim = max(active, key=lambda i: (self.seqs[i]['joined'], i))
        if len(active) == 1 and not self._preempted:
            self._fail_row(victim, RuntimeError(
                f"serving[{self.name}]: sequence needs more KV pages than "
                f"the pool holds ({self.target.alloc.usable} usable) — "
                "grow num_pages or lower max_new_tokens"))
            return True
        s = self.seqs[victim]
        self._release_row(victim)
        self._preempted.append({
            'req': s['req'],
            # tokens generated THIS residency fold into the prompt (they
            # will be re-prefilled); the full generated list rides along
            # so the eventual response still returns everything
            'prompt': np.concatenate(
                [s['prompt'], np.asarray(s['tokens'], np.int32)]),
            'max_new': s['max_new'],
            'tokens': self._generated(s),
        })
        self.stats.preemptions += 1
        _count('serving.preemptions')
        self.journal.append(('preempt', s['req'].id, self.step_no))
        if _obs.enabled():
            _obs.event('serving.preempt', model=self.name,
                       request=s['req'].id,
                       tokens_so_far=len(self._generated(s)))
            _obs.async_instant('preempt', s['req'].id,
                               cat='serving.request',
                               tokens=len(self._generated(s)))
        return True

    # -- row lifecycle -----------------------------------------------------
    def _release_row(self, row):
        for side in self._sides():
            side.release(row)
        self.seqs[row] = None

    def _fail_row(self, row, exc):
        s = self.seqs[row]
        self._release_row(row)
        self.stats.errors += 1
        self.stats.leaves += 1
        _count('serving.leaves')
        self.journal.append(('leave', s['req'].id, self.step_no))
        finish_request(s['req'], STATUS_ERROR,
                       {'tokens': np.asarray(self._generated(s), np.int32)},
                       error=exc)

    def _maybe_finish(self, row):
        s = self.seqs[row]
        r = s['req']
        eos = self.spec.eos_id
        done = (len(self._generated(s)) >= s['max_new'] or
                s['pos'] + 1 >= self.spec.max_seq or
                (eos is not None and s['last'] == eos))
        status = STATUS_OK
        if r.expired():
            done, status = True, STATUS_DEADLINE
            self.stats.expired += 1
            _count('serving.deadline_expired')
        if not done:
            return
        self._release_row(row)
        self.stats.leaves += 1
        self.stats.completed += 1
        _count('serving.leaves')
        self.journal.append(('leave', r.id, self.step_no))
        if _obs.enabled():
            _obs.event('serving.leave', model=self.name, request=r.id,
                       slot=row, tokens=len(self._generated(s)),
                       status=status)
            info = self.kv_info()
            _obs.event('serving.kv_stats', model=self.name,
                       page_utilization=info['page_utilization'],
                       prefix_hit_rate=info.get('prefix_hit_rate'),
                       draft_acceptance=info.get('draft_acceptance'),
                       preemptions=self.stats.preemptions,
                       decode_stalls=self.stats.decode_stalls)
        finish_request(r, status,
                       {'tokens': np.asarray(self._generated(s),
                                             np.int32)})

    def _expire(self, req):
        self.stats.expired += 1
        _count('serving.deadline_expired')
        finish_request(req, STATUS_DEADLINE)
