"""CRC-stamped, rotating, fallback-capable checkpoint store. Counterpart of
``paddle_tpu/resilience/checkpoint.py`` (``CheckpointManager``,
``capture_rng``, ``restore_rng``).

Two on-disk formats under one directory (both may coexist; ``steps()`` /
``load()`` / ``restore()`` see the union):

Format 1 — single-file::

    ckpt-00000012.ckpt            # pickled payload (tensors -> numpy)
    ckpt-00000012.manifest.json   # {"format":1,"step":12,"size":...,"crc32":...,
                                  #  "meta":{"epoch":3,"step_in_epoch":0,...}}

Format 2 — sharded (``async_checkpoint``)::

    ckpt_00000012/shard_rank<R>.npz   # per-rank leaf pieces
    ckpt_00000012/manifest.json       # merged CRC manifest, committed LAST

Commit protocol (both formats): payload/shards first, manifest second, all
through ``atomic_io.atomic_write``. A checkpoint EXISTS only once its
manifest does; a crash between the writes leaves invisible orphans that the
next save of that step overwrites. ``load()``/``restore()`` walk steps
newest first, verify size+CRC32 against the manifest, and fall back to the
newest non-corrupt checkpoint (warning on every skip) — a torn or
bit-flipped latest file costs one checkpoint interval, not the run.

``save(state, async_=True)`` snapshots on the calling thread
(``async_checkpoint.secure_for_async``: device-side clones, in stream
order) and serializes and commits on a background thread (ONE in flight;
the next save — or an explicit :meth:`fence` — waits for it).
``save(state, world=W, rank=R)`` writes the sharded format. ``sharding=``
and ``restore(sharding=)`` raise ``NotImplementedError``: they come with
``distributed/``.

Telemetry (while enabled), as the reference's: ``checkpoint.save_stall_ms``
(the training thread's time in ``save``: the whole commit for a sync save,
the snapshot for an async one), ``checkpoint.commit_ms`` and its older
name ``checkpoint.save_ms`` (at the manifest's commit, on the writer
thread for an async save), ``checkpoint.restore_ms``, the
``checkpoint.saves`` / ``restores`` / ``corrupt_skips`` counters and the
``checkpoint.save`` / ``restore`` / ``corrupt`` / ``abandoned`` events.

The RNG of a port run (``capture_rng`` / ``restore_rng``) has no global
generator to snapshot: it is every ``DropoutState`` of the network,
keyed by module path, numpy's global state, and the ``torch.Generator``s
an optimizer's slots hold (``Dpsgd``'s ``key``).
"""
import json
import os
import pickle
import warnings
import zlib

from .. import observability as _obs
from .atomic_io import atomic_open, atomic_write, crc32_file

__all__ = ['CheckpointManager', 'capture_rng', 'restore_rng']

_FMT = 1
_PREFIX = 'ckpt-'
_PAYLOAD_EXT = '.ckpt'
_MANIFEST_EXT = '.manifest.json'
_V2_PREFIX = 'ckpt_'


def _no_sharding(what):
    return NotImplementedError(
        f"CheckpointManager.{what}: sharding= is not ported yet: placing "
        f"state over a device mesh and the resharding restore come with the "
        f"distributed slice (distributed/)")


class CheckpointManager:
    """Keep-last-N rotating checkpoint directory with corruption fallback,
    async (background-thread) saves and per-rank sharded checkpoints."""

    def __init__(self, path, max_keep=3):
        self.path = os.fspath(path)
        self.max_keep = max_keep
        self._async = None   # lazy AsyncSaver (one in-flight save)

    # -- naming -------------------------------------------------------------
    def _payload(self, step):
        return os.path.join(self.path, '%s%08d%s' % (_PREFIX, step,
                                                     _PAYLOAD_EXT))

    def _manifest(self, step):
        return os.path.join(self.path, '%s%08d%s' % (_PREFIX, step,
                                                     _MANIFEST_EXT))

    def _v2_dir(self, step):
        return os.path.join(self.path, '%s%08d' % (_V2_PREFIX, int(step)))

    def _is_v2(self, step):
        from . import async_checkpoint as ac
        return os.path.isfile(os.path.join(self._v2_dir(step),
                                           ac.MANIFEST_NAME))

    def steps(self):
        """Committed (manifest present) steps, ascending — both formats."""
        if not os.path.isdir(self.path):
            return []
        out = set()
        for name in os.listdir(self.path):
            if name.startswith(_PREFIX) and name.endswith(_MANIFEST_EXT):
                digits = name[len(_PREFIX):-len(_MANIFEST_EXT)]
                if digits.isdigit():
                    out.add(int(digits))
            elif name.startswith(_V2_PREFIX):
                digits = name[len(_V2_PREFIX):]
                if digits.isdigit() and os.path.isfile(
                        os.path.join(self.path, name, 'manifest.json')):
                    out.add(int(digits))
        return sorted(out)

    def latest_step(self):
        s = self.steps()
        return s[-1] if s else None

    # -- async machinery ----------------------------------------------------
    def _saver(self):
        if self._async is None:
            from .async_checkpoint import AsyncSaver
            self._async = AsyncSaver()
        return self._async

    def in_flight(self):
        """True while a background save is still committing."""
        return self._async is not None and self._async.in_flight()

    def fence(self, timeout=None, abandon=False):
        """Block until the in-flight async save (if any) finishes; with
        ``abandon=True`` a save still running after ``timeout`` seconds is
        cooperatively abandoned (it removes its uncommitted artifacts) —
        the contract the preemption checkpoint relies on. Re-raises a
        background save's failure. Returns blocked milliseconds."""
        if self._async is None:
            return 0.0
        return self._async.fence(timeout=timeout, abandon=abandon)

    # -- write --------------------------------------------------------------
    def save(self, state, step=None, meta=None, *, async_=False,
             sharding=None, world=None, rank=None, tag=None, extra=None):
        """Atomically commit ``state`` (nested dicts/lists of tensors,
        numpy arrays and plain values) as checkpoint ``step`` (default:
        latest+1).

        - ``async_=True``: the leaves are cloned on the calling thread, in
          stream order; serialization and the commit run on a background
          thread, and this call returns after fencing any previous
          in-flight save (ONE save in flight).
        - ``world=``/``rank=``: the multi-process sharded split — each rank
          writes only its shard; rank 0 commits the manifest after the
          shard barrier.
        - ``extra=``: small pickled side payload (RNG streams, loop
          position) stored next to the shards and CRC'd in the manifest.
        """
        from ..framework import _to_saveable
        if sharding is not None:
            raise _no_sharding('save')
        sw = _obs.Stopwatch()
        # ordering fence FIRST: a save must never land after a LATER one —
        # and the default step number must see the in-flight commit, or
        # back-to-back async saves with step=None would both read the same
        # latest_step() and silently overwrite each other
        self.fence()
        if step is None:
            latest = self.latest_step()
            step = 0 if latest is None else latest + 1
        step = int(step)
        sharded = world is not None or rank is not None
        if extra is not None and not sharded:
            # the side payload (RNG streams, loop position) only exists in
            # the sharded manifest format — promote rather than drop it
            sharded, world = True, 1
        committer = rank is None or int(rank) == 0
        meta = dict(meta or {})
        from . import async_checkpoint as ac
        src = ac.secure_for_async(state) if async_ else state

        if sharded:
            def job(should_abort):
                jsw = _obs.Stopwatch()
                man = ac.save_sharded(self.path, src, step, meta=meta,
                                      world=world, rank=rank, tag=tag,
                                      extra=extra, should_abort=should_abort)
                if man is not None:
                    nbytes = sum(s['size'] for s in man['shards'].values())
                    self._finish_commit(step, jsw, meta, nbytes,
                                        async_=async_, sharded=True)
                if committer:
                    self._rotate()
        else:
            def job(should_abort):
                jsw = _obs.Stopwatch()
                tree = src.wait() if isinstance(src, ac.Snapshot) else src
                pay_path = self._payload(step)
                try:
                    with atomic_open(pay_path) as f:
                        if should_abort is not None:
                            f = ac._AbortCheckingStream(f, should_abort)
                        w = _Crc32Writer(f)
                        # streamed: no full blob in RAM; CRC/size accumulate
                        # while writing
                        pickle.dump(_to_saveable(tree), w, protocol=4)
                except ac.AbandonedSave:
                    if _obs.enabled():
                        _obs.event('checkpoint.abandoned', step=step)
                    return
                manifest = {'format': _FMT, 'step': step, 'size': w.size,
                            'crc32': w.crc, 'meta': meta}
                atomic_write(self._manifest(step),
                             json.dumps(manifest, sort_keys=True).encode())
                self._finish_commit(step, jsw, meta, w.size,
                                    async_=async_, sharded=False)
                self._rotate()

        if async_:
            self._saver().submit(job)
        else:
            job(lambda: False)
        if _obs.enabled():
            _obs.histogram('checkpoint.save_stall_ms').observe(
                sw.elapsed_ms())
        return step

    def _finish_commit(self, step, sw, meta, nbytes, async_, sharded):
        """Telemetry at the manifest's commit (on the writer thread for an
        async save)."""
        if not _obs.enabled():
            return
        ms = sw.elapsed_ms()
        _obs.histogram('checkpoint.commit_ms').observe(ms)
        # the older name: the save duration histogram before async saves
        _obs.histogram('checkpoint.save_ms').observe(ms)
        _obs.counter('checkpoint.saves').inc()
        _obs.event('checkpoint.save', step=step, bytes=nbytes,
                   duration_ms=round(ms, 3), async_=bool(async_),
                   sharded=bool(sharded), meta=meta)

    def _rotate(self):
        if not self.max_keep:
            return
        import shutil
        for s in self.steps()[:-self.max_keep]:
            for p in (self._payload(s), self._manifest(s)):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            shutil.rmtree(self._v2_dir(s), ignore_errors=True)

    # -- read ---------------------------------------------------------------
    def verify(self, step):
        """True iff checkpoint ``step``'s payload matches its manifest."""
        return self._check(step) is None

    def _check(self, step):
        """None when intact, else a human-readable defect description."""
        if self._is_v2(step):
            from . import async_checkpoint as ac
            return ac.check_sharded(self._v2_dir(step))
        man_path, pay_path = self._manifest(step), self._payload(step)
        try:
            with open(man_path, 'rb') as f:
                man = json.loads(f.read().decode())
        except (OSError, ValueError) as e:
            return 'unreadable manifest (%s)' % e
        if not os.path.isfile(pay_path):
            return 'payload missing'
        size = os.path.getsize(pay_path)
        if size != man.get('size'):
            return 'payload truncated/resized (%d bytes, manifest says %s)' \
                % (size, man.get('size'))
        crc = crc32_file(pay_path)
        if crc != man.get('crc32'):
            return 'payload CRC32 mismatch (0x%08x, manifest says 0x%08x)' \
                % (crc, man.get('crc32', 0))
        return None

    def _read_step(self, s, v1_numpy):
        """(state, meta, extra) of an intact step, or a defect string."""
        from ..framework import _from_saveable
        defect = self._check(s)
        if defect is not None:
            return defect
        if self._is_v2(s):
            from . import async_checkpoint as ac
            try:
                return ac.load_sharded(self._v2_dir(s), return_extra=True)
            except Exception as e:    # CRC passed but deserialize failed
                return 'unreadable sharded payload (%s)' % e
        try:
            with open(self._payload(s), 'rb') as f:
                state = pickle.load(f)
        except Exception as e:   # CRC passed but unpickle failed
            return 'unpicklable payload (%s)' % e
        with open(self._manifest(s), 'rb') as f:
            meta = json.loads(f.read().decode()).get('meta', {})
        return _from_saveable(state, v1_numpy), meta, None

    def _load_any(self, step, v1_numpy):
        """Newest intact checkpoint (or ``step``), with corrupt-skip
        fallback. Returns (state, meta, extra, step) or None."""
        candidates = [step] if step is not None else \
            list(reversed(self.steps()))
        sw = _obs.Stopwatch()
        for s in candidates:
            got = self._read_step(s, v1_numpy)
            if not isinstance(got, str):
                state, meta, extra = got
                if _obs.enabled():
                    ms = sw.elapsed_ms()
                    _obs.histogram('checkpoint.restore_ms').observe(ms)
                    _obs.counter('checkpoint.restores').inc()
                    _obs.event('checkpoint.restore', step=s,
                               duration_ms=round(ms, 3))
                return state, meta, extra, s
            if _obs.enabled():
                _obs.counter('checkpoint.corrupt_skips').inc()
                _obs.event('checkpoint.corrupt', step=s, defect=str(got))
            warnings.warn(
                "CheckpointManager: checkpoint step %d at %r is corrupt "
                "(%s) — falling back to the previous good checkpoint"
                % (s, self.path, got))
        return None

    def load(self, step=None, return_numpy=False):
        """Return ``(state, meta)`` of checkpoint ``step`` (default: the
        newest NON-CORRUPT one), or ``None`` when nothing loadable exists.
        Corrupt checkpoints are skipped with a warning, never deleted —
        an operator may still salvage them. Sharded (format-2) checkpoints
        come back as numpy leaves (bf16 ones as bf16 CPU tensors)."""
        got = self._load_any(step, return_numpy)
        if got is None:
            return None
        state, meta, _extra, _s = got
        return state, meta

    def restore(self, step=None, sharding=None, return_extra=False):
        """``load()`` for training state: numpy leaves on the host (bf16
        ones as bf16 CPU tensors). Returns ``(state, meta)`` (or ``(state,
        meta, extra)``), or None. ``sharding=`` raises."""
        if sharding is not None:
            raise _no_sharding('restore')
        got = self._load_any(step, True)
        if got is None:
            return None
        state, meta, extra, _s = got
        if return_extra:
            return state, meta, extra
        return state, meta

    def load_extra(self, step=None):
        """The pickled side payload (RNG streams, loop position) of a
        committed sharded checkpoint, WITHOUT reassembling the arrays;
        None when the step (default: newest) has no extra / is format 1."""
        steps = [step] if step is not None else \
            list(reversed(self.steps()))
        for s in steps:
            if not self._is_v2(s):
                continue
            from . import async_checkpoint as ac
            try:
                man = ac.read_manifest(self._v2_dir(s))
                if not man.get('extra'):
                    return None
                with open(os.path.join(self._v2_dir(s),
                                       man['extra']['file']), 'rb') as f:
                    return pickle.load(f)
            except Exception:
                return None
        return None

    def load_manifest(self, step):
        """The raw manifest dict of a committed step (either format)."""
        if self._is_v2(step):
            from . import async_checkpoint as ac
            return ac.read_manifest(self._v2_dir(step))
        with open(self._manifest(step), 'rb') as f:
            return json.loads(f.read().decode())


class _Crc32Writer:
    """File-like shim accumulating CRC32 + byte count as pickle streams."""

    def __init__(self, f):
        self._f = f
        self.crc = 0
        self.size = 0

    def write(self, data):
        self.crc = zlib.crc32(data, self.crc) & 0xFFFFFFFF
        self.size += len(data)
        return self._f.write(data)


# -- RNG capture for exact resume -------------------------------------------

def dropout_states(network):
    """``{module path: DropoutState}`` of every distinct ``DropoutState``
    that ``network``'s modules hold (the first path each is found under,
    in ``named_modules`` order; never keyed by ``id()``)."""
    from ..kernels.philox import DropoutState
    out, seen = {}, set()
    for path, m in network.named_modules():
        for attr, v in vars(m).items():
            if isinstance(v, DropoutState) and id(v) not in seen:
                seen.add(id(v))
                out[f'{path}.{attr}' if path else attr] = v
    return out


def _generators(opt_state):
    """``{'<param>.<slot>': torch.Generator}`` of an optimizer state."""
    import torch
    return {f'{name}.{slot}': g
            for name, slots in (opt_state or {}).items()
            for slot, g in slots.items() if isinstance(g, torch.Generator)}


def capture_rng(network=None, opt_state=None):
    """Snapshot every RNG stream a port run consumes, as plain pickleable
    python/numpy state: numpy's global state; with ``network``, each of its
    ``DropoutState``s' ``(seed, offset)`` by module path; with
    ``opt_state``, each ``torch.Generator`` its slots hold."""
    import numpy as np
    out = {'numpy': np.random.get_state()}
    if network is not None:
        out['dropout'] = {k: {'seed': s.seed, 'offset': s.offset}
                          for k, s in dropout_states(network).items()}
    gens = _generators(opt_state)
    if gens:
        out['generators'] = {k: g.get_state().numpy().copy()
                             for k, g in gens.items()}
    return out


def restore_rng(state, network=None, opt_state=None):
    """Set the streams ``capture_rng`` took back. A ``DropoutState`` or
    generator the snapshot names that ``network`` / ``opt_state`` lacks (or
    the reverse) raises ``ValueError``: the resumed run would draw other
    masks."""
    import numpy as np
    import torch
    if not state:
        return
    if state.get('numpy') is not None:
        np.random.set_state(state['numpy'])
    if network is not None and state.get('dropout') is not None:
        own = dropout_states(network)
        saved = state['dropout']
        if set(own) != set(saved):
            raise ValueError(
                f"restore_rng: the checkpoint's dropout states "
                f"{sorted(saved)} are not the network's {sorted(own)}")
        for k, s in own.items():
            s.seed = int(saved[k]['seed'])
            s.offset = int(saved[k]['offset'])
    gens = _generators(opt_state)
    saved = state.get('generators') or {}
    if opt_state is not None and (gens or saved):
        if set(gens) != set(saved):
            raise ValueError(
                f"restore_rng: the checkpoint's generators {sorted(saved)} "
                f"are not the optimizer state's {sorted(gens)}")
        for k, g in gens.items():
            g.set_state(torch.from_numpy(np.asarray(saved[k], np.uint8)))
