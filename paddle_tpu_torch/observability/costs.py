"""Cost explorer: per-program cost attribution. The port's counterpart of
``paddle_tpu/observability/costs.py``.

Every program the runtime runs (the ``engine.build_train_step`` step, and
whatever else calls ``capture``) is captured ONCE into a process-wide
**cost ledger** keyed by program label:

- ``flops`` and ``bytes_accessed`` of one call;
- ``argument`` / ``output`` / ``temp`` bytes and their sum,
  ``peak_bytes``;
- an **analytic roofline**: arithmetic intensity (flops per byte
  accessed) against the device's peaks names whether the program is
  compute- or memory-bound and its floor time. The peaks are nominal
  (env-overridable): the estimate is a bound, not a measurement.

The reference lowers and compiles the jitted program once more and reads
XLA's ``cost_analysis()`` / ``memory_analysis()``. An eager PyTorch step
has no compiled program to ask, so ``capture(program, fn, *args)`` runs
the step's **first real dispatch** itself, counted, and returns its
result (no extra step runs on the card):

- aten FLOPs under ``torch.utils.flop_counter.FlopCounterMode`` (matrix
  products and convolutions; elementwise work counts 0, where XLA counts
  it);
- each hand-written kernel's FLOPs and bytes from its shapes, reported by
  its wrapper (``kernels._build.work``) with the formulas ``chip_smoke.py``
  uses for the kernel's bound. A ``ctypes`` launch never passes the
  dispatcher, and the ``paddle_tpu_torch::flash_attention`` op has no
  flop formula registered, so both would count 0; the wrapper's formula
  counts the kernel's own work (the flash backward recomputes the scores:
  6 and 8 operations a pair and head dim where the plain autograd does 4
  and 4). A plain version (CPU tensors) counts as its kernel does;
- ``bytes_accessed``: each aten op that is not a view reads its tensor
  inputs and writes its outputs once (eager PyTorch fuses nothing), plus
  the kernels' bytes;
- ``argument_bytes`` (the tensors in the arguments), ``output_bytes``
  (the result's tensors that are not arguments: the step's in-place state
  counts once), and on the card ``temp_bytes``: the rise of
  ``torch.cuda.max_memory_allocated`` over the allocation at the start
  (after ``reset_peak_memory_stats``), less the new outputs. On the CPU
  the peak is not measured: ``temp_bytes`` is 0 and the entry says so
  (``peak_measured: False``).

Surfaces: ``cost.flops{program=}`` / ``cost.bytes_accessed{program=}`` /
``cost.peak_bytes{program=}`` gauges, one ``cost.program`` event per
capture, the ``/costs`` endpoint, the per-rank flush head and the flight
dump. Everything is off until telemetry is enabled; a failed capture emits
``cost.capture_error`` and never fails the program it describes.

Env knobs:

- ``PADDLE_TPU_DEVICE_PEAK_FLOPS``     roofline peak FLOP/s override
- ``PADDLE_TPU_DEVICE_PEAK_BPS``       roofline peak memory bytes/s override
- ``PADDLE_TPU_HBM_BUDGET``            device memory budget in bytes (the
                                       doctor's ``memory_pressure`` detector
                                       compares ledger ``peak_bytes`` to it)

Stdlib-only at import (torch is imported inside the functions).
"""
import contextlib
import os
import threading

from . import events, registry, state

__all__ = ['capture', 'record_costs', 'mark_hit', 'ledger', 'entry',
           'summary', 'reset', 'device_peaks', 'roofline', 'hbm_budget']

_lock = threading.Lock()
_ledger = {}         # program label -> entry dict


# nominal peak (FLOP/s, bytes/s) per backend for the analytic roofline: a
# bound used to rank programs and name the binding resource, not a
# performance prediction
_DEFAULT_PEAKS = {
    # NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit: dense bf16/fp16
    # tensor-core peak and the HBM3 rate (the table chip_smoke.py's bounds
    # use; fp32 work runs at a fraction of it)
    'gpu': (989e12, 3.35e12),
    'cpu': (2e11, 5e10),         # a few AVX cores / dual-channel DRAM
}


def _env_float(name):
    raw = os.environ.get(name, '')
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def _backend():
    try:
        import torch
        return 'gpu' if torch.cuda.is_available() else 'cpu'
    except Exception:
        return 'cpu'


def device_peaks(backend=None):
    """(peak_flops_per_s, peak_bytes_per_s) for the roofline: the env
    overrides when set, else the nominal table entry for the backend
    (``'gpu'`` or ``'cpu'``; default: ``'gpu'`` where CUDA is
    available)."""
    if backend is None:
        backend = _backend()
    flops, bps = _DEFAULT_PEAKS.get(backend, _DEFAULT_PEAKS['cpu'])
    return (_env_float('PADDLE_TPU_DEVICE_PEAK_FLOPS') or flops,
            _env_float('PADDLE_TPU_DEVICE_PEAK_BPS') or bps)


def hbm_budget():
    """Device-memory budget in bytes for memory-pressure accounting:
    ``PADDLE_TPU_HBM_BUDGET`` when set, else the CUDA device's total
    memory (``torch.cuda.mem_get_info``), else None (the CPU reports
    none)."""
    raw = os.environ.get('PADDLE_TPU_HBM_BUDGET', '')
    if raw:
        try:
            return int(float(raw))
        except ValueError:
            pass
    try:
        import torch
        if not torch.cuda.is_available():
            return None
        return int(torch.cuda.mem_get_info()[1]) or None
    except Exception:
        return None


def roofline(flops, bytes_accessed, backend=None):
    """Analytic roofline for one program: arithmetic intensity vs the
    device ridge point -> binding resource + floor time estimate."""
    peak_flops, peak_bps = device_peaks(backend)
    ai = (flops / bytes_accessed) if bytes_accessed else 0.0
    ridge = peak_flops / peak_bps
    est_s = max(flops / peak_flops if peak_flops else 0.0,
                bytes_accessed / peak_bps if peak_bps else 0.0)
    return {
        'arithmetic_intensity': round(ai, 4),
        'ridge': round(ridge, 4),
        'bound': 'compute' if ai >= ridge else 'memory',
        'est_ms': round(est_s * 1e3, 6),
        'peak_flops': peak_flops,
        'peak_bytes_per_s': peak_bps,
    }


# -- the counted dispatch -----------------------------------------------------

def _tensors(value, out):
    """Every tensor in ``value`` (through dicts, lists and tuples) into the
    dict ``out``, keyed by identity."""
    import torch
    if isinstance(value, torch.Tensor):
        out[id(value)] = value
    elif isinstance(value, dict):
        for v in value.values():
            _tensors(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _tensors(v, out)
    elif hasattr(value, '__slots__') and not isinstance(value, type):
        for name in value.__slots__:
            _tensors(getattr(value, name, None), out)
    return out


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _traffic_mode():
    """A dispatch mode that adds up the bytes each aten op reads and
    writes: its tensor inputs and outputs, once each; views move none."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    def size(value):
        if isinstance(value, torch.Tensor):
            return value.numel() * value.element_size()
        if isinstance(value, (list, tuple)):
            return sum(size(v) for v in value)
        if isinstance(value, dict):
            return sum(size(v) for v in value.values())
        return 0

    def is_view(func):
        rets = getattr(func, '_schema', None)
        rets = rets.returns if rets is not None else ()
        return any(r.alias_info is not None and not r.alias_info.is_write
                   for r in rets)

    class Traffic(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not is_view(func):
                self.bytes += size(args) + size(kwargs) + size(out)
            return out
    return Traffic()


class _Count:
    """The counters around one dispatch: FLOPs of aten ops, their bytes,
    the kernels' reported work and, on the card, the memory peak."""

    def __init__(self, args):
        import torch
        from torch.utils.flop_counter import FlopCounterMode
        from ..kernels import _build
        self._build = _build
        self.args = _tensors(args, {})
        devices = {t.device for t in self.args.values()
                   if t.device.type == 'cuda'}
        self.device = next(iter(devices)) if devices else None
        self.kernel = {}          # kernel -> [calls, flops, bytes]
        self.flops = FlopCounterMode(display=False)
        self.traffic = _traffic_mode()
        if self.device is not None:
            # the caching allocator's statistics are the host's own: no
            # wait for the device here or after the dispatch
            torch.cuda.reset_peak_memory_stats(self.device)
            self.base = torch.cuda.memory_allocated(self.device)

    def _on_work(self, kernel, flops, nbytes):
        row = self.kernel.setdefault(kernel, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def __enter__(self):
        with contextlib.ExitStack() as stack:
            self._build.work_listeners.append(self._on_work)
            stack.callback(self._build.work_listeners.remove, self._on_work)
            stack.enter_context(self.flops)
            stack.enter_context(self.traffic)
            self._stack = stack.pop_all()
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)

    def numbers(self, out):
        """-> (flops, bytes_accessed, mem dict, meta dict) of the dispatch
        that produced ``out``."""
        import torch
        outs = _tensors(out, {})
        new = [t for k, t in outs.items() if k not in self.args]
        mem = {'argument_bytes': _nbytes(self.args.values()),
               'output_bytes': _nbytes(new), 'temp_bytes': 0,
               'alias_bytes': _nbytes(t for k, t in outs.items()
                                      if k in self.args),
               'generated_code_bytes': 0}
        meta = {'peak_measured': self.device is not None}
        if self.device is not None:
            peak = torch.cuda.max_memory_allocated(self.device)
            meta['max_memory_allocated_bytes'] = int(peak)
            mem['temp_bytes'] = max(
                0, int(peak - self.base) - mem['output_bytes'])
        kflops = sum(r[1] for r in self.kernel.values())
        kbytes = sum(r[2] for r in self.kernel.values())
        aten = float(self.flops.get_total_flops())
        meta['aten_flops'] = aten
        meta['aten_bytes'] = float(self.traffic.bytes)
        meta['kernels'] = {k: {'calls': r[0], 'flops': r[1], 'bytes': r[2]}
                           for k, r in sorted(self.kernel.items())}
        return aten + kflops, float(self.traffic.bytes) + kbytes, mem, meta


def capture(program, fn, *args, kind='jit', meta=None):
    """Run ``fn(*args)`` -- the program's first real dispatch --
    counted, ledger what it did under ``program`` and return ``fn``'s
    result (read the entry with ``entry(program)``). With telemetry off,
    or once ``program`` is in the ledger (a **hit**), ``fn`` just runs.
    A capture that fails to set up or to record emits
    ``cost.capture_error`` and never fails ``fn``; an exception of ``fn``
    itself propagates."""
    if not state.enabled():
        return fn(*args)
    with _lock:
        ent = _ledger.get(program)
    if ent is not None:
        mark_hit(program)
        return fn(*args)
    try:
        count = _Count(args)
        count.__enter__()
    except Exception as e:
        events.emit('cost.capture_error', program=str(program),
                    error=repr(e))
        return fn(*args)
    try:
        out = fn(*args)
    finally:
        count.__exit__(None, None, None)
    try:
        flops, nbytes, mem, extra = count.numbers(out)
        record_costs(program, flops, nbytes, mem, kind=kind,
                     meta=dict(meta or {}, **extra))
    except Exception as e:
        events.emit('cost.capture_error', program=str(program),
                    error=repr(e))
    return out


def record_costs(program, flops, bytes_accessed, mem=None, kind='jit',
                 meta=None):
    """Ledger raw numbers (the seam ``capture`` feeds; also lets tests and
    external analyzers inject entries)."""
    if not state.enabled():
        return None
    mem = dict(mem or {})
    peak = (mem.get('argument_bytes', 0) + mem.get('output_bytes', 0) +
            mem.get('temp_bytes', 0) + mem.get('generated_code_bytes', 0))
    entry = {
        'program': str(program),
        'kind': str(kind),
        'flops': float(flops),
        'bytes_accessed': float(bytes_accessed),
        'peak_bytes': int(peak),
        'captured_ts': round(events.wall_ts(), 6),
        'hits': 0,
    }
    entry.update(mem)
    entry['roofline'] = roofline(entry['flops'], entry['bytes_accessed'])
    if meta:
        entry['meta'] = dict(meta)
    with _lock:
        fresh = program not in _ledger
        _ledger[program] = entry
    lbl = {'program': str(program)}
    registry.gauge('cost.flops', labels=lbl).set(entry['flops'])
    registry.gauge('cost.bytes_accessed', labels=lbl).set(
        entry['bytes_accessed'])
    registry.gauge('cost.peak_bytes', labels=lbl).set(entry['peak_bytes'])
    registry.counter('cost.captures').inc()
    if fresh:
        registry.counter('cost.programs').inc()
    events.emit('cost.program', program=entry['program'],
                program_kind=entry['kind'],
                flops=entry['flops'], bytes_accessed=entry['bytes_accessed'],
                peak_bytes=entry['peak_bytes'],
                argument_bytes=entry.get('argument_bytes', 0),
                output_bytes=entry.get('output_bytes', 0),
                temp_bytes=entry.get('temp_bytes', 0),
                arithmetic_intensity=entry['roofline'][
                    'arithmetic_intensity'],
                bound=entry['roofline']['bound'],
                est_ms=entry['roofline']['est_ms'])
    return entry


def mark_hit(program):
    """Count one reuse of a ledgered program."""
    with _lock:
        ent = _ledger.get(program)
        if ent is not None:
            ent['hits'] += 1
    if state.enabled():
        registry.counter('cost.hits').inc()
    return ent


def entry(program):
    with _lock:
        ent = _ledger.get(program)
    return dict(ent) if ent is not None else None


def ledger():
    """Snapshot of every entry, sorted by descending flops."""
    with _lock:
        entries = [dict(e) for e in _ledger.values()]
    entries.sort(key=lambda e: (-e['flops'], e['program']))
    return entries


def summary():
    """Headline ledger aggregates (flight dumps, the flush head, the
    ``/costs`` endpoint)."""
    entries = ledger()
    peak_prog = max(entries, key=lambda e: e['peak_bytes'], default=None)
    by_kind = {}
    for e in entries:
        by_kind[e['kind']] = by_kind.get(e['kind'], 0) + 1
    out = {
        'programs': len(entries),
        'total_flops': round(sum(e['flops'] for e in entries), 1),
        'total_bytes_accessed': round(
            sum(e['bytes_accessed'] for e in entries), 1),
        'max_peak_bytes': peak_prog['peak_bytes'] if peak_prog else 0,
        'max_peak_program': peak_prog['program'] if peak_prog else None,
        'hits': sum(e['hits'] for e in entries),
        'by_kind': by_kind,
    }
    budget = hbm_budget()
    if budget:
        out['hbm_budget'] = budget
        out['peak_budget_ratio'] = round(
            out['max_peak_bytes'] / budget, 4)
    return out


def reset():
    with _lock:
        _ledger.clear()
