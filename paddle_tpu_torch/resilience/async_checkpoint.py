"""Async snapshots and per-rank sharded checkpoints. Counterpart of
``paddle_tpu/resilience/async_checkpoint.py`` (``save_sharded``,
``check_sharded``, ``load_sharded``, ``read_manifest``, ``AsyncSaver``,
``secure_for_async``, ``_plan_world``); the files are the reference's
format 2, byte for byte in every array member, so each package reads the
other's checkpoints.

Format 2 layout (format 1 is the single-file ``ckpt-<step>.ckpt`` pair in
``checkpoint.py``; ``CheckpointManager`` reads both)::

    <dir>/ckpt_<08d>/shard_rank<R>.npz    # leaf pieces owned by shard rank R
    <dir>/ckpt_<08d>/ready_<R>_<tag>      # zero-byte per-rank commit marker
    <dir>/ckpt_<08d>/extra.pkl            # optional pickled extras (RNG, ...)
    <dir>/ckpt_<08d>/manifest.json        # committed LAST, by rank 0 only

Commit protocol: every shard file and the manifest go through
``atomic_io``; a checkpoint EXISTS only once ``manifest.json`` does, so a
crash (or a full disk) partway through a shard write leaves an
*invisible* partial directory and the previous checkpoint untouched. In a
multi-process job each rank writes only its own shard plus a ready marker;
rank 0 waits for every marker (a file barrier with a deadline), CRC32-hashes
the shard files, and commits the manifest. The manifest records every
leaf's global shape and dtype and the index range of every piece.

Leaves are torch tensors (on any device) or numpy arrays; ``world`` ranks
split each leaf along its first dim divisible by ``world`` (small or
indivisible leaves go whole to rank 0). numpy has no bfloat16: a bf16 leaf
is written as the reference writes one, its 16-bit words under the
descriptor ``'<V2'`` with ``'bfloat16'`` as the plan's dtype, and is read
back, bit for bit, as a bf16 CPU tensor (the reference reads its own back
as ``|V2`` bytes, or fails to assemble it from pieces; ROADMAP.md, Queue 3).

Telemetry (while enabled), as the reference's: a ``checkpoint.abandoned``
event when a save is abandoned, ``checkpoint.async_errors`` and a
``checkpoint.async_error`` event when a background save fails, and a
``checkpoint.fence`` event (the milliseconds waited, whether it abandoned)
when a fence waited for one.

Not ported: ``config=`` (a ``ShardingConfig``: pieces from a device mesh)
and the resharding restore (``place_with_config``) raise
``NotImplementedError``; they come with ``distributed/``.
"""
import contextlib
import json
import os
import pickle
import shutil
import threading
import time
import zlib

import numpy as np
import torch

from .. import observability as _obs
from ..framework import BF16, numpy_to_tensor, tensor_to_numpy
from .atomic_io import atomic_open, atomic_write, crc32_file
from .watchdog import WatchdogTimeout, join_thread

__all__ = ['save_sharded', 'check_sharded', 'load_sharded', 'read_manifest',
           'step_dir', 'secure_for_async', 'Snapshot', 'AsyncSaver',
           'AbandonedSave', 'FORMAT', 'DIR_PREFIX', 'MANIFEST_NAME']

FORMAT = 2
DIR_PREFIX = 'ckpt_'
MANIFEST_NAME = 'manifest.json'
_EXTRA_NAME = 'extra.pkl'
# grace a fence(abandon=True) gives the writer to notice the flag and clean
# up before the fence gives up loudly
_ABANDON_GRACE_S = 5.0
# the descriptor the reference's npy members carry for a bf16 leaf
_BF16_DESCR = '<V2'
# bytes a member is written in (numpy's own write_array buffer)
_CHUNK = 1 << 24

_DISTRIBUTED = ("sharding over a device mesh (config=, a ShardingConfig) and "
                "the resharding restore come with the distributed slice "
                "(distributed/)")


def step_dir(root, step):
    return os.path.join(os.fspath(root), '%s%08d' % (DIR_PREFIX, int(step)))


def _shard_name(rank):
    return 'shard_rank%d.npz' % int(rank)


class AbandonedSave(Exception):
    """An in-flight save was cooperatively abandoned (preemption fence):
    its uncommitted artifacts were removed; no checkpoint was written."""


# ---------------------------------------------------------------------------
# pytree <-> manifest
# ---------------------------------------------------------------------------

def _is_scalar(node):
    return node is None or isinstance(node, (bool, int, float, str))


def _flatten(tree):
    """(json treedef, [leaf, ...]) over dict/list/tuple nesting. Array
    leaves become ``{'__leaf__': i}``; plain scalars/None inline."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            return {'__dict__': {str(k): walk(v) for k, v in node.items()}}
        if isinstance(node, (list, tuple)):
            key = '__list__' if isinstance(node, list) else '__tuple__'
            return {key: [walk(v) for v in node]}
        if _is_scalar(node):
            return {'__value__': node}
        leaves.append(node)
        return {'__leaf__': len(leaves) - 1}

    return walk(tree), leaves


def _unflatten(treedef, leaves):
    def walk(node):
        if '__dict__' in node:
            return {k: walk(v) for k, v in node['__dict__'].items()}
        if '__list__' in node:
            return [walk(v) for v in node['__list__']]
        if '__tuple__' in node:
            return tuple(walk(v) for v in node['__tuple__'])
        if '__value__' in node:
            return node['__value__']
        return leaves[node['__leaf__']]

    return walk(treedef)


def _map_leaves(tree, fn):
    """Structure-preserving map over the same nesting ``_flatten`` walks."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        t = type(tree)
        return t(_map_leaves(v, fn) for v in tree)
    return fn(tree)


def _leaf_paths(tree):
    """[(path tuple, leaf), ...] in ``_flatten``'s walk order."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
            return
        if isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
            return
        if _is_scalar(node):
            return
        out.append((path, node))

    walk(tree, ())
    return out


def _dtype_name(leaf):
    """The plan's dtype: numpy's name, or ``'bfloat16'``."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return BF16
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


# ---------------------------------------------------------------------------
# shard planning
# ---------------------------------------------------------------------------

def _split_dim(shape, world, min_size):
    """The FSDP first-divisible-dim policy (the reference's
    ``distributed.sharding.first_divisible_spec``) as a dim index: leaves
    of ``min_size`` elements or more split along their first dim that
    ``world`` divides; others stay whole."""
    size = int(np.prod(shape or (1,)))
    if world > 1 and size >= min_size:
        for d, s in enumerate(shape):
            if s % world == 0:
                return d
    return None


def _plan_world(state, world, min_size=1024):
    """Per-leaf piece plans for ``world`` process ranks: the FSDP
    first-divisible-dim split (indivisible or small leaves go whole to
    rank 0)."""
    world = max(int(world), 1)
    plans = []
    for n, (path, leaf) in enumerate(_leaf_paths(state)):
        shape = tuple(int(s) for s in leaf.shape)
        dim = _split_dim(shape, world, min_size) if world > 1 else None
        if dim is None:
            pieces = [{'rank': 0, 'index': [[0, d] for d in shape]}]
        else:
            chunk = shape[dim] // world
            pieces = []
            for r in range(world):
                index = [[0, d] for d in shape]
                index[dim] = [r * chunk, (r + 1) * chunk]
                pieces.append({'rank': r, 'index': index})
        plans.append({'path': list(path), 'key': 'L%05d' % n,
                      'shape': list(shape), 'dtype': _dtype_name(leaf),
                      'dim': dim, 'pieces': pieces})
    return plans


def _host_array(leaf, streams):
    """A leaf as a host numpy array (bf16: its ``uint16`` words). A CUDA
    tensor of a ``Snapshot`` (whose copy is known to have landed) is
    copied on the snapshot's side stream of its device (``streams``), so
    that a background save does not queue behind the training stream's
    work; a live tensor is copied on the current stream, after the work
    queued on it."""
    if isinstance(leaf, torch.Tensor):
        side = streams.get(leaf.device) if leaf.is_cuda else None
        with torch.cuda.stream(side) if side is not None \
                else contextlib.nullcontext():
            return tensor_to_numpy(leaf)[0]
    return np.asarray(leaf)


def _piece_arrays(leaf, plan, want_ranks, streams):
    """Host (numpy) arrays for this leaf's pieces owned by ``want_ranks``:
    ``{piece_i: ndarray}`` (one host copy, then slices)."""
    wanted = {i: p for i, p in enumerate(plan['pieces'])
              if p['rank'] in want_ranks}
    if not wanted:
        return {}
    arr = _host_array(leaf, streams)
    out = {}
    for i, p in wanted.items():
        sl = tuple(slice(s, e) for s, e in p['index'])
        out[i] = arr[sl] if sl else arr
    return out


# ---------------------------------------------------------------------------
# write / verify / read
# ---------------------------------------------------------------------------

class _AbortCheckingStream:
    """File proxy raising ``AbandonedSave`` between writes once the
    cooperative abandon flag flips — keeps a fence responsive even while a
    single large shard file is streaming."""

    def __init__(self, f, should_abort):
        self._f = f
        self._should_abort = should_abort

    def write(self, data):
        if self._should_abort():
            raise AbandonedSave('save abandoned mid-stream')
        return self._f.write(data)

    def __getattr__(self, name):
        return getattr(self._f, name)


class _ShardStream:
    """WRITE-ONLY stream for shard files: accumulates CRC32 + byte count
    as the zip streams (no read-back of a multi-GB shard after commit) and
    checks the cooperative abandon flag per write. Deliberately exposes no
    seek/tell: zipfile then treats the stream as unseekable and emits data
    descriptors instead of seeking back to patch headers — which is what
    makes a linear CRC correct (np.load reads both forms)."""

    def __init__(self, f, should_abort=None):
        self._f = f
        self._should_abort = should_abort
        self.crc = 0
        self.size = 0

    def write(self, data):
        if self._should_abort is not None and self._should_abort():
            raise AbandonedSave('save abandoned mid-stream')
        self.crc = zlib.crc32(data, self.crc) & 0xFFFFFFFF
        self.size += len(data)
        return self._f.write(data)

    def flush(self):
        self._f.flush()


def _write_member(zm, arr, dtype):
    """One ``.npy`` member: numpy's own writer, or for bf16 words the
    reference's header (descriptor ``'<V2'``) and the raw words."""
    if dtype != BF16:
        np.lib.format.write_array(zm, np.asarray(arr))
        return
    arr = np.asarray(arr, order='C')
    np.lib.format.write_array_header_1_0(
        zm, {'descr': _BF16_DESCR, 'fortran_order': False,
             'shape': tuple(arr.shape)})
    raw = arr.reshape(-1).view(np.uint8)
    for i in range(0, raw.size, _CHUNK):
        zm.write(raw[i:i + _CHUNK].tobytes())


def _write_shard(dirpath, rank, arrays, should_abort=None):
    """One shard file in the npz (zip of .npy members) format, written
    member by member so a failing stream is torn down deterministically.
    ``arrays``: ``{name: (array, dtype)}``. Returns ``(path, crc32,
    size)`` accumulated while streaming."""
    import zipfile
    path = os.path.join(dirpath, _shard_name(rank))
    with atomic_open(path) as f:
        w = _ShardStream(f, should_abort)
        zf = zipfile.ZipFile(w, 'w', zipfile.ZIP_STORED, allowZip64=True)
        try:
            for name, (arr, dtype) in arrays.items():
                with zf.open(name + '.npy', 'w', force_zip64=True) as zm:
                    _write_member(zm, arr, dtype)
        finally:
            try:
                zf.close()
            except Exception:
                pass   # the stream already failed; atomic_open cleans up
    return path, w.crc, w.size


def _marker(dirpath, rank, tag):
    return os.path.join(dirpath, 'ready_%d_%s' % (int(rank), tag))


def _wait_markers(dirpath, nranks, tag, timeout, tick=0.05):
    """Rank 0's commit barrier: every rank's ready marker for THIS tag
    (generation) must exist before the manifest hashes the shard files —
    a stale shard from a previous generation must never be committed.
    Raises ``WatchdogTimeout`` after ``timeout`` seconds."""
    deadline = time.monotonic() + float(timeout)
    missing = list(range(nranks))
    while True:
        missing = [r for r in missing
                   if not os.path.exists(_marker(dirpath, r, tag))]
        if not missing:
            return
        if time.monotonic() >= deadline:
            raise WatchdogTimeout(
                "sharded checkpoint barrier: ranks %s never committed "
                "their shard (tag %s) within %.1fs — dead or wedged peers; "
                "the manifest was NOT written and this step stays "
                "invisible" % (missing, tag, timeout),
                what='checkpoint shard barrier', waited=float(timeout))
        time.sleep(tick)


def _default_tag():
    return os.environ.get('PADDLE_TPU_ELASTIC_GENERATION', '0') or '0'


def save_sharded(root, state, step, meta=None, config=None, world=None,
                 rank=None, tag=None, extra=None, barrier_timeout=60.0,
                 should_abort=None, min_size=1024):
    """Commit ``state`` as sharded checkpoint ``step`` under ``root``.

    ``world``/``rank``: the multi-process split — with ``rank=None`` every
    shard is written by this process; with ``rank=R`` only R's shard
    (plus, on rank 0, the barrier wait of at most ``barrier_timeout``
    seconds and the manifest commit). ``state`` may be a ``Snapshot``
    (``secure_for_async``). Returns the manifest dict, or None for
    non-committing ranks / an abandoned save. ``config=`` raises
    ``NotImplementedError``.
    """
    if config is not None:
        raise NotImplementedError(f"save_sharded: {_DISTRIBUTED}")
    streams = {}
    if isinstance(state, Snapshot):
        streams = state.streams
        state = state.wait()
    d = step_dir(root, step)
    os.makedirs(d, exist_ok=True)
    tag = str(tag) if tag is not None else _default_tag()
    should_abort = should_abort or (lambda: False)
    nranks = max(int(world or 1), 1)
    plans = _plan_world(state, nranks, min_size=min_size)
    treedef, leaves = _flatten(state)
    my_ranks = list(range(nranks)) if rank is None else [int(rank)]
    try:
        per_rank = {r: {} for r in my_ranks}
        want = set(my_ranks)
        for plan, leaf in zip(plans, leaves):
            if should_abort():
                raise AbandonedSave('save abandoned before shard build')
            for i, arr in _piece_arrays(leaf, plan, want, streams).items():
                piece = plan['pieces'][i]
                per_rank[piece['rank']]['%s.p%d' % (plan['key'], i)] = \
                    (arr, plan['dtype'])
        streamed = {}
        for r in my_ranks:
            if should_abort():
                raise AbandonedSave('save abandoned between shards')
            _p, crc, size = _write_shard(d, r, per_rank[r], should_abort)
            streamed[r] = {'file': _shard_name(r), 'size': size,
                           'crc32': crc}
            with open(_marker(d, r, tag), 'w'):   # atomic-ok: 0-byte marker
                pass
        if rank is not None and int(rank) != 0:
            return None
        if rank is not None:
            _wait_markers(d, nranks, tag, barrier_timeout)
        if should_abort():
            raise AbandonedSave('save abandoned before manifest commit')
        shards = {}
        for r in range(nranks):
            if r in streamed:
                shards[str(r)] = streamed[r]
            else:
                # a peer's shard (rank-0 barrier commit): read-back is the
                # only way to stamp bytes this process never saw
                p = os.path.join(d, _shard_name(r))
                shards[str(r)] = {'file': _shard_name(r),
                                  'size': os.path.getsize(p),
                                  'crc32': crc32_file(p)}
        extra_entry = None
        if extra is not None:
            ep = os.path.join(d, _EXTRA_NAME)
            with atomic_open(ep) as f:
                w = _ShardStream(f, should_abort)
                pickle.dump(extra, w, protocol=4)
            extra_entry = {'file': _EXTRA_NAME,
                           'size': w.size, 'crc32': w.crc}
        manifest = {'format': FORMAT, 'step': int(step), 'world': nranks,
                    'mesh': None, 'tag': tag, 'meta': dict(meta or {}),
                    'shards': shards, 'extra': extra_entry,
                    'leaves': plans, 'treedef': treedef}
        atomic_write(os.path.join(d, MANIFEST_NAME),
                     json.dumps(manifest, sort_keys=True).encode())
        return manifest
    except AbandonedSave:
        _cleanup_uncommitted(d, my_ranks, tag, whole_dir=rank is None)
        if _obs.enabled():
            _obs.event('checkpoint.abandoned', step=int(step))
        return None
    except BaseException:
        # a failed save must leave nothing that LOOKS like a checkpoint;
        # multi-process ranks remove only their OWN artifacts
        _cleanup_uncommitted(d, my_ranks, tag, whole_dir=rank is None)
        raise


def _cleanup_uncommitted(d, ranks, tag, whole_dir):
    """Remove a failed/abandoned save's artifacts — but ONLY when the
    directory holds no committed manifest."""
    if os.path.exists(os.path.join(d, MANIFEST_NAME)):
        return
    if whole_dir:
        shutil.rmtree(d, ignore_errors=True)
        return
    for r in ranks:
        for p in (os.path.join(d, _shard_name(r)), _marker(d, r, tag)):
            try:
                os.unlink(p)
            except OSError:
                pass


def read_manifest(dirpath):
    with open(os.path.join(dirpath, MANIFEST_NAME), 'rb') as f:
        return json.loads(f.read().decode())


def check_sharded(dirpath):
    """None when the checkpoint dir is intact, else a defect description.
    Validates the manifest and every shard/extra file's size + CRC32
    BEFORE any array bytes are deserialized."""
    try:
        man = read_manifest(dirpath)
    except (OSError, ValueError) as e:
        return 'unreadable manifest (%s)' % e
    if man.get('format') != FORMAT:
        return 'unknown manifest format %r' % man.get('format')
    entries = list(man.get('shards', {}).values())
    if man.get('extra'):
        entries.append(man['extra'])
    for ent in entries:
        p = os.path.join(dirpath, ent['file'])
        if not os.path.isfile(p):
            return 'shard %s missing' % ent['file']
        size = os.path.getsize(p)
        if size != ent.get('size'):
            return 'shard %s truncated/resized (%d bytes, manifest says ' \
                '%s)' % (ent['file'], size, ent.get('size'))
        crc = crc32_file(p)
        if crc != ent.get('crc32'):
            return 'shard %s CRC32 mismatch (0x%08x, manifest says ' \
                '0x%08x)' % (ent['file'], crc, ent.get('crc32', 0))
    return None


def load_sharded(dirpath, return_extra=False):
    """Reassemble the host state of a committed sharded checkpoint: numpy
    leaves, and bf16 CPU tensors for ``'bfloat16'`` leaves.

    The caller is expected to have run :func:`check_sharded` first (the
    ``CheckpointManager`` does); this only reads. Returns ``(state, meta)``
    or ``(state, meta, extra)``."""
    man = read_manifest(dirpath)
    npz = {}

    def piece(r, name, bf16):
        if r not in npz:
            npz[r] = np.load(os.path.join(dirpath, _shard_name(r)),
                             allow_pickle=False)
        arr = npz[r][name]
        return arr.view(np.uint16) if bf16 else arr

    leaves = []
    for plan in man['leaves']:
        shape = tuple(plan['shape'])
        bf16 = plan['dtype'] == BF16
        pieces = plan['pieces']
        if len(pieces) == 1:
            out = np.asarray(piece(pieces[0]['rank'], '%s.p0' % plan['key'],
                                   bf16)).reshape(shape)
        else:
            out = np.empty(shape, dtype=np.uint16 if bf16
                           else np.dtype(plan['dtype']))
            for i, pc in enumerate(pieces):
                sl = tuple(slice(s, e) for s, e in pc['index'])
                out[sl] = piece(pc['rank'], '%s.p%d' % (plan['key'], i),
                                bf16)
        leaves.append(numpy_to_tensor(out, BF16) if bf16 else out)
    for f in npz.values():
        f.close()
    state = _unflatten(man['treedef'], leaves)
    meta = dict(man.get('meta') or {})
    if not return_extra:
        return state, meta
    extra = None
    if man.get('extra'):
        with open(os.path.join(dirpath, man['extra']['file']), 'rb') as f:
            extra = pickle.load(f)
    return state, meta, extra


# ---------------------------------------------------------------------------
# the async saver
# ---------------------------------------------------------------------------

class Snapshot:
    """A state captured for a background save (``secure_for_async``): the
    copied tree and, for CUDA leaves, one event per device recorded after
    the copies on the stream that made them, and a side stream per device
    for the writer's copies to the host."""

    __slots__ = ('tree', 'events', 'streams')

    def __init__(self, tree, events, streams):
        self.tree = tree
        self.events = events
        self.streams = streams

    def wait(self):
        """The tree, once every copy has landed (the writer's host waits on
        the events; the training stream does not)."""
        for ev in self.events:
            ev.synchronize()
        return self.tree


def secure_for_async(state):
    """Capture ``state`` for a background save, on the calling (training)
    thread and in stream order: every tensor leaf is cloned on its device
    (an enqueued copy, not a host transfer), numpy leaves are copied, and
    an event per CUDA device marks where the clones end. The port's step
    updates parameters and slots in place, so a copy made later by the
    writer thread could read a later step's values. -> a ``Snapshot``."""
    devices = set()

    def copy_leaf(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
            return x.detach().clone()
        if isinstance(x, np.ndarray):
            return x.copy()
        return x

    tree = _map_leaves(state, copy_leaf)
    events, streams = [], {}
    for dev in sorted(devices, key=str):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
        streams[dev] = torch.cuda.Stream(dev)
    return Snapshot(tree, events, streams)


class AsyncSaver:
    """ONE in-flight background save, with a fence on the next.

    ``submit(job)`` runs ``job(should_abort)`` on a daemon thread; the
    *caller* is expected to have fenced first (``CheckpointManager.save``
    does). ``fence()`` blocks (in bounded ticks) until the in-flight save
    finishes; ``fence(abandon=True, timeout=t)`` flips the cooperative
    abandon flag after ``t`` seconds so the writer stops at its next write
    boundary and removes its uncommitted artifacts — the preemption
    contract: an async save racing a SIGTERM either finishes or cleanly
    vanishes before the preemption checkpoint starts. A worker-thread
    failure is re-raised on the next ``submit``/``fence``.
    """

    def __init__(self, name='paddle-tpu-torch-async-ckpt'):
        self._name = name
        self._thread = None
        self._error = None
        self._abandon = False

    def in_flight(self):
        return self._thread is not None and self._thread.is_alive()

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, job):
        self.fence()
        self._abandon = False

        def run():
            try:
                job(lambda: self._abandon)
            except AbandonedSave:
                pass
            except BaseException as e:   # surfaced on the next save/fence
                self._error = e
                if _obs.enabled():
                    _obs.counter('checkpoint.async_errors').inc()
                    _obs.event('checkpoint.async_error', error=repr(e))

        self._thread = threading.Thread(target=run, name=self._name,
                                        daemon=True)
        self._thread.start()

    def fence(self, timeout=None, abandon=False):
        """Wait for the in-flight save. Returns the milliseconds this
        caller was blocked (0.0 when nothing was in flight)."""
        t = self._thread
        waited_ms = 0.0
        if t is not None and t.is_alive():
            t0 = time.perf_counter()
            done = join_thread(t, timeout=timeout)
            if not done and abandon:
                self._abandon = True
                done = join_thread(t, timeout=_ABANDON_GRACE_S)
            waited_ms = (time.perf_counter() - t0) * 1e3
            if not done:
                raise WatchdogTimeout(
                    "async checkpoint fence: the in-flight save did not "
                    "finish%s within %.1fs — wedged filesystem?"
                    % (' (or abandon)' if abandon else '',
                       (timeout or 0) + (_ABANDON_GRACE_S if abandon
                                         else 0)),
                    what='async checkpoint fence', waited=waited_ms / 1e3)
            if _obs.enabled():
                _obs.event('checkpoint.fence',
                           waited_ms=round(waited_ms, 3),
                           abandoned=bool(abandon and self._abandon))
        self._thread = None
        self._raise_pending()
        return waited_ms
