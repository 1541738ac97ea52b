"""Model runners: how one scheduler step turns queued requests into math.
Counterpart of ``paddle_tpu/serving/runners.py`` (``BatchRunner``,
``GenerativeRunner``).

- ``BatchRunner`` — one-shot models. Each engine step re-packs the queue
  into the smallest bucket that fits (dynamic batching), moves the numpy
  feeds to the engine's device, runs the batch callable eagerly and hands
  each request its slice of the numpy outputs.
- ``GenerativeRunner`` — iteration-level continuous batching over the
  fixed-slot KV cache (``kv_cache.py``): every step admits waiting
  requests into free slots (bucketed prefill), then runs one fixed-shape
  greedy decode step for all active slots; finished sequences leave their
  slot at once. This is the memory baseline (``register(...,
  kv_cache='slot')``); the default generative path is
  ``paged_runner.PagedGenerativeRunner``.

The reference wraps every program in ``compilecache.CachedJit``; the port
calls plain callables (PyTorch runs them eagerly), and ``warmup()`` still
runs each program once so that first-call set-up (the kernel build) is
not paid under traffic. Runners never block: ``step()`` does at most one
batch or one decode iteration and returns whether it did work.

Telemetry rides the reference's sites, each behind one flag check:
``serving.*`` counters (``_count``), the occupancy, latency and queue-wait
histograms, the ``serving.request`` async lane and event
(``finish_request``, which also judges each request against its model's
SLO and its tenant's ledger, always on), the ``serving.batch`` /
``serving.prefill`` / ``serving.decode`` timers, and
``record_host_transfer`` where outputs are copied back to the host.
"""
import collections

import numpy as np
import torch

from .. import observability as _obs
from .bucketing import BucketSpec, pad_to_bucket, select_bucket, \
    stack_examples
from .scheduler import STATUS_DEADLINE, STATUS_ERROR, STATUS_OK

__all__ = ['BatchRunner', 'GenerativeRunner', 'finish_request']


def _count(name, n=1):
    if _obs.enabled():
        _obs.counter(name).inc(n)


def _observe(name, v):
    if _obs.enabled():
        _obs.histogram(name).observe(v)


def finish_request(req, status, outputs=None, error=None):
    """Complete a request and mirror the outcome onto the telemetry spine
    (latency/queue-wait histograms, a per-request event carrying the
    phase breakdown, the SLO tracker's judgment, the tenant ledger, and
    the closing edge of the request's async trace lane)."""
    req.complete(status, outputs, error=error)
    resp = req.response
    _count('serving.completed')
    _count(f'serving.status.{status}')
    _obs.slo.record(req.model, status, resp.latency_ms)
    from .admission import record_completion
    record_completion(req, status, resp.latency_ms)
    if _obs.enabled():
        _obs.histogram('serving.latency_ms').observe(resp.latency_ms)
        _obs.histogram('serving.queue_wait_ms').observe(resp.queue_ms)
        _obs.event('serving.request', model=req.model, status=status,
                   tenant=getattr(req, 'tenant', None) or 'default',
                   latency_ms=round(resp.latency_ms, 3),
                   queue_ms=round(resp.queue_ms, 3),
                   **{f'{k}_ms': round(v, 3)
                      for k, v in resp.breakdown.items()})
        _obs.async_end('request', req.id, cat='serving.request',
                       status=status,
                       latency_ms=round(resp.latency_ms, 3))


def _to_host(t):
    """One device tensor -> numpy, counted as a host transfer."""
    a = t.detach().cpu().numpy()
    if _obs.enabled() and t.device.type != 'cpu':
        _obs.record_host_transfer(a.nbytes)
    return a


def _to_numpy(outs):
    """Device outputs -> numpy through dict/tuple/list structure."""
    if isinstance(outs, dict):
        return {k: _to_numpy(v) for k, v in outs.items()}
    if isinstance(outs, (list, tuple)):
        return type(outs)(_to_numpy(v) for v in outs)
    if isinstance(outs, torch.Tensor):
        return _to_host(outs)
    return np.asarray(outs)


def _slice_outputs(outs, i):
    """Per-request view of batched outputs: slice leading axis ``i``
    through dict/tuple/list structure."""
    if isinstance(outs, dict):
        return {k: _slice_outputs(v, i) for k, v in outs.items()}
    if isinstance(outs, (list, tuple)):
        return type(outs)(_slice_outputs(v, i) for v in outs)
    return np.asarray(outs)[i]


class _Stats:
    """Plain always-on tallies (``batches`` counts decode steps for the
    generative runners)."""

    def __init__(self):
        self.completed = 0
        self.expired = 0
        self.errors = 0
        self.batches = 0
        self.joins = 0
        self.leaves = 0
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self._occ_sum = 0.0

    def occupancy(self, frac):
        self._occ_sum += frac
        _observe('serving.batch_occupancy', frac)

    def as_dict(self):
        return {
            'completed': self.completed, 'expired': self.expired,
            'errors': self.errors, 'batches': self.batches,
            'joins': self.joins, 'leaves': self.leaves,
            'decode_tokens': self.decode_tokens,
            'prefill_tokens': self.prefill_tokens,
            'mean_batch_occupancy': (
                round(self._occ_sum / self.batches, 4)
                if self.batches else 0.0),
        }


def _device_ints(a, device):
    """A host int array as an int32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


class BatchRunner:
    """Dynamic batching over a one-shot batched callable.

    ``batch_fn(feeds)`` takes ``{name: tensor [B, ...]}`` on ``device`` and
    returns a tensor / tuple / dict with a leading batch axis. ``example``
    (one request's inputs, no batch axis) pins the shape/dtype spec:
    submits that disagree are rejected at admission and warmup knows what
    zeros to feed.

    With ``bucket_spec.length_buckets`` the inputs of one or more axes are
    sequences along their first axis: a request may send any length up to
    the example's (which must be the largest length bucket), and a batch
    pads them with zeros to the length bucket of its longest request, so
    the shapes stay a closed set of (batch bucket, length bucket) pairs.
    The outputs come back at that length; a client reads its own prefix.
    That holds only for a model whose outputs over a request's own length
    do not depend on how far it is padded (one given its lengths, say): a
    model that reads its padding is served with one length bucket, the
    length it was trained at.
    """

    kind = 'batch'

    def __init__(self, name, queue, batch_fn, example, device,
                 bucket_spec=None):
        self.name = name
        self.queue = queue
        self.spec = bucket_spec or BucketSpec()
        self.example = {k: np.asarray(v) for k, v in example.items()}
        self.device = device
        self._fn = batch_fn
        self.stats = _Stats()
        # the inputs padded to a length bucket (first axis)
        self._sequences = set()
        if self.spec.length_buckets is not None:
            self._sequences = {k for k, ex in self.example.items()
                               if ex.ndim >= 1}
            longest = self.spec.length_buckets[-1]
            bad = sorted(k for k in self._sequences
                         if self.example[k].shape[0] != longest)
            if bad:
                raise ValueError(
                    f"serving[{name}]: the examples of {bad} must be as long "
                    f"as the largest length bucket, {longest}")

    def validate(self, req):
        missing = sorted(set(self.example) - set(req.inputs))
        if missing:
            raise ValueError(
                f"serving[{self.name}]: request missing inputs {missing}")
        for k, ex in self.example.items():
            a = np.asarray(req.inputs[k])
            fits = a.shape == ex.shape or (
                k in self._sequences and a.ndim == ex.ndim and
                0 < a.shape[0] <= ex.shape[0] and a.shape[1:] == ex.shape[1:])
            if not fits or a.dtype != ex.dtype:
                raise ValueError(
                    f"serving[{self.name}]: input {k!r} has shape/dtype "
                    f"{a.shape}/{a.dtype}, registered example is "
                    f"{ex.shape}/{ex.dtype} — serving shapes are a closed "
                    "set (see serving.bucketing); pad client-side or "
                    "register a matching model")

    def has_work(self):
        return len(self.queue) > 0

    def evict_in_flight(self):
        """One-shot batches run inside ``step()``: nothing is resident."""
        return []

    def _feeds(self, batch):
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def warmup(self):
        """Run every bucket once with zero feeds (first-call set-up, such as
        the kernel build, happens here and not under traffic) -> the number
        of buckets run."""
        lengths = self.spec.length_buckets if self._sequences else (None,)
        for b in self.spec.batch_buckets:
            for n in lengths:
                _to_numpy(self._fn(self._feeds(
                    {k: np.zeros((b,) + self._shape(k, n), ex.dtype)
                     for k, ex in self.example.items()})))
        return len(self.spec.batch_buckets) * len(lengths)

    def _shape(self, k, length):
        shape = self.example[k].shape
        return shape if k not in self._sequences else (length,) + shape[1:]

    def _batch(self, ready, bucket):
        """The requests' inputs stacked into ``bucket`` rows, the sequences
        padded to the length bucket of the longest."""
        if not self._sequences:
            return {k: stack_examples([r.inputs[k] for r in ready], bucket)
                    for k in self.example}
        n = self.spec.length_bucket(max(np.shape(r.inputs[k])[0]
                                        for r in ready
                                        for k in self._sequences))
        return {k: stack_examples(
            [pad_to_bucket(r.inputs[k], n) if k in self._sequences
             else r.inputs[k] for r in ready], bucket)
            for k in self.example}

    def step(self):
        ready, expired = self.queue.pop_ready(self.spec.max_batch)
        for r in expired:
            self.stats.expired += 1
            _count('serving.deadline_expired')
            finish_request(r, STATUS_DEADLINE)
        if not ready:
            return bool(expired)
        bucket = self.spec.batch_bucket(len(ready))
        batch = self._batch(ready, bucket)
        self.stats.batches += 1
        _count('serving.batches')
        self.stats.occupancy(len(ready) / bucket)
        if _obs.enabled():
            for r in ready:
                _obs.async_instant('batch', r.id, cat='serving.request',
                                   bucket=bucket, n=len(ready))
        try:
            # 'run' is the batch's wall time, feeds to host outputs; the
            # serving.batch timer (the reference's) times the call, and on
            # its sampled occurrences waits for the device work behind it
            sw = _obs.Stopwatch()
            dev = None
            with _obs.timer('serving.batch', sync=lambda: dev,
                            model=self.name, batch=len(ready),
                            bucket=bucket):
                dev = self._fn(self._feeds(batch))
            outs = _to_numpy(dev)
            ms = sw.elapsed_ms()
            for r in ready:
                r.add_phase_ms('run', ms)
            # slice before completing anything: a malformed output (e.g. no
            # leading batch axis) must fail the whole batch, not the engine
            per_req = [_slice_outputs(outs, i) for i in range(len(ready))]
        except Exception as e:                       # model bug: fail the
            for r in ready:                          # batch, not the engine
                self.stats.errors += 1
                finish_request(r, STATUS_ERROR, error=e)
            return True
        for r, out in zip(ready, per_req):
            self.stats.completed += 1
            status = STATUS_DEADLINE if r.expired() else STATUS_OK
            if status == STATUS_DEADLINE:
                self.stats.expired += 1
                _count('serving.deadline_expired')
            finish_request(r, status, out)
        return True


class GenerativeRunner:
    """Continuous batching: per-iteration join/leave over KV-cache slots.

    ``spec`` is a ``kv_cache.GenerativeSpec``; ``device`` the engine's,
    where token tensors are made. The runner owns the cache and the slot
    table; requests are greedy-decoded. Its program set is one prefill per
    prompt bucket plus one decode, all fixed shapes, run once by
    ``warmup()``. Each step reads its chosen tokens back to the host (one
    sync per prefill and per decode step), as the reference's does.
    """

    kind = 'generative'

    def __init__(self, name, queue, spec, device, default_max_new_tokens=32):
        self.name = name
        self.queue = queue
        self.spec = spec
        self.device = device
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.cache = spec.init_cache()
        self.slots = [None] * spec.max_batch
        self.stats = _Stats()
        self.step_no = 0
        # join/leave journal for tests/debugging: (event, request_id, step)
        self.journal = collections.deque(maxlen=1024)

        def _prefill(cache, toks, length, slot):
            cache, logits = spec.prefill(cache, toks, length, slot)
            return cache, torch.argmax(logits)

        def _decode(cache, toks, pos):
            cache, logits = spec.decode(cache, toks, pos)
            return cache, torch.argmax(logits, dim=-1)

        self._prefill = _prefill
        self._decode = _decode

    def _tensor(self, a):
        return _device_ints(a, self.device)

    def validate(self, req):
        toks = np.asarray(req.inputs.get('tokens', ()))
        if toks.size == 0:
            raise ValueError(
                f"serving[{self.name}]: generative request needs a "
                "non-empty 'tokens' input")
        if toks.ravel().shape[0] > self.spec.prompt_buckets[-1]:
            raise ValueError(
                f"serving[{self.name}]: prompt of {toks.ravel().shape[0]} "
                f"tokens exceeds the largest prompt bucket "
                f"{self.spec.prompt_buckets[-1]}")

    def has_work(self):
        return len(self.queue) > 0 or any(s is not None for s in self.slots)

    def evict_in_flight(self):
        """Vacate every occupied KV slot (engine shutdown): returns
        ``[(request, partial_outputs)]`` so the engine can complete them
        with their tokens so far."""
        out = []
        for slot, s in enumerate(self.slots):
            if s is None:
                continue
            self.slots[slot] = None
            self.stats.leaves += 1
            _count('serving.leaves')
            self.journal.append(('leave', s['req'].id, self.step_no))
            out.append((s['req'],
                        {'tokens': np.asarray(s['tokens'], np.int32)}))
        return out

    def warmup(self):
        """Run every prefill bucket and the decode step once, on slot 0
        with zero tokens (a real join later overwrites the slot) -> the
        number of programs run."""
        n = 0
        for lb in self.spec.prompt_buckets:
            self.cache, nxt = self._prefill(
                self.cache, self._tensor(np.zeros((lb,))), 1, 0)
            int(nxt)
            n += 1
        z = self._tensor(np.zeros((self.spec.max_batch,)))
        self.cache, nxt = self._decode(self.cache, z, z)
        _to_host(nxt)
        return n + 1

    # -- one scheduler iteration ---------------------------------------
    def step(self):
        self.step_no += 1
        did = self._admit()
        did = self._decode_step() or did
        return did

    def _admit(self):
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free:
            # still reap already-dead requests so they don't rot in queue
            expired = self.queue.reap_expired()
            for r in expired:
                self._expire(r)
            return bool(expired)
        ready, expired = self.queue.pop_ready(len(free))
        for r in expired:
            self._expire(r)
        did = bool(expired)
        for r in ready:
            did = True
            slot = free.pop(0)
            prompt = np.asarray(r.inputs['tokens'], np.int32).ravel()
            lb = select_bucket(len(prompt), self.spec.prompt_buckets)
            padded = pad_to_bucket(prompt, lb)
            try:
                with _obs.timer('serving.prefill', model=self.name,
                                bucket=lb) as t:
                    self.cache, nxt = self._prefill(
                        self.cache, self._tensor(padded), len(prompt), slot)
                    first = int(_to_host(nxt))
                r.add_phase_ms('prefill', t.elapsed_ms)
            except Exception as e:                   # model bug: fail the
                self.stats.errors += 1               # request, not the
                free.insert(0, slot)                 # engine worker
                finish_request(r, STATUS_ERROR, error=e)
                continue
            self.stats.joins += 1
            self.stats.prefill_tokens += len(prompt)
            _count('serving.joins')
            _count('serving.prefill_tokens', len(prompt))
            self.journal.append(('join', r.id, self.step_no))
            if _obs.enabled():
                _obs.event('serving.join', model=self.name, request=r.id,
                           slot=slot, prompt_len=len(prompt))
                _obs.async_instant('prefill', r.id, cat='serving.request',
                                   slot=slot, bucket=lb,
                                   prompt_len=len(prompt))
            max_new = int(self.default_max_new_tokens
                          if r.max_new_tokens is None else r.max_new_tokens)
            self.slots[slot] = {'req': r, 'tokens': [first], 'last': first,
                                'pos': len(prompt), 'max_new': max_new}
            self._maybe_finish(slot)
        return did

    def _decode_step(self):
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return False
        b = self.spec.max_batch
        toks = np.zeros((b,), np.int32)
        pos = np.zeros((b,), np.int32)
        for i in active:
            toks[i] = self.slots[i]['last']
            pos[i] = self.slots[i]['pos']
        self.stats.batches += 1
        _count('serving.decode_steps')
        self.stats.occupancy(len(active) / b)
        try:
            with _obs.timer('serving.decode', model=self.name,
                            active=len(active)) as t:
                self.cache, nxt = self._decode(self.cache,
                                               self._tensor(toks),
                                               self._tensor(pos))
                nxt = _to_host(nxt)
        except Exception as e:                       # model bug: fail the
            for i in active:                         # co-batched requests,
                s = self.slots[i]                    # not the engine worker
                self.slots[i] = None
                self.stats.errors += 1
                self.stats.leaves += 1
                _count('serving.leaves')
                self.journal.append(('leave', s['req'].id, self.step_no))
                finish_request(
                    s['req'], STATUS_ERROR,
                    {'tokens': np.asarray(s['tokens'], np.int32)}, error=e)
            return True
        telemetry = _obs.enabled()
        for i in active:
            s = self.slots[i]
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
                                   tokens=len(s['tokens']))
            self._maybe_finish(i)
        return True

    # -- slot lifecycle -------------------------------------------------
    def _maybe_finish(self, slot):
        s = self.slots[slot]
        r = s['req']
        eos = self.spec.eos_id
        done = (len(s['tokens']) >= s['max_new'] or
                s['pos'] + 1 >= self.spec.max_seq or
                (eos is not None and s['last'] == eos))
        status = STATUS_OK
        if r.expired():
            done, status = True, STATUS_DEADLINE
            self.stats.expired += 1
            _count('serving.deadline_expired')
        if not done:
            return
        self.slots[slot] = None
        self.stats.leaves += 1
        self.stats.completed += 1
        _count('serving.leaves')
        self.journal.append(('leave', r.id, self.step_no))
        if _obs.enabled():
            _obs.event('serving.leave', model=self.name, request=r.id,
                       slot=slot, tokens=len(s['tokens']), status=status)
        finish_request(r, status,
                       {'tokens': np.asarray(s['tokens'], np.int32)})

    def _expire(self, req):
        self.stats.expired += 1
        _count('serving.deadline_expired')
        finish_request(req, STATUS_DEADLINE)
