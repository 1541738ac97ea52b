"""Atomic file I/O: the single write path every checkpoint byte goes through.
The port's own copy of ``paddle_tpu/resilience/atomic_io.py`` (stdlib only;
the port imports nothing of the reference, so it keeps this copy).

Rule: checkpoint-shaped code never opens its final destination for
writing. It stages bytes in a same-directory temp file, fsyncs, and
commits with ``os.replace`` — so a reader observes
either the old complete file or the new complete file, never a torn one.
POSIX guarantees rename atomicity only within a filesystem, hence the
same-directory temp (cross-device rename would fall back to copy+delete).

Stdlib-only on purpose: ``framework.save`` and the checkpoint modules
write through it, and it must import without torch.
"""
import contextlib
import itertools
import os
import pickle
import shutil
import threading
import zlib

__all__ = ['atomic_open', 'atomic_write', 'atomic_pickle_dump', 'crc32_file',
           'crc32_bytes', 'AtomicWriteError']

# Fault-injection seam (tests set it): called as
# hook(stage, path) with stage in {'write', 'replace'}; raising here models a
# crash at that point of the commit protocol. None in production.
_fault_hook = None

# Stream-level fault seam: called as hook(path, bytes_so_far, chunk_len)
# BEFORE every staged write() once armed — raising models ENOSPC partway
# through a payload, sleeping models a slow filesystem. None in
# production: the wrapper below is only interposed while a hook is armed,
# so the hot path stays a bare file.
_stream_hook = None


class AtomicWriteError(OSError):
    """A staged write failed before commit; the destination is untouched."""


def _invoke_hook(stage, path):
    if _fault_hook is not None:
        _fault_hook(stage, path)


# per-call temp-name uniquifier: pid alone is not enough — two threads of one
# process writing the same destination (async checkpointer racing a shutdown
# save) must never share a staging file
_tmp_seq = itertools.count()


@contextlib.contextmanager
def atomic_open(path, fsync=True):
    """Context manager: a writable binary stream whose contents land on
    ``path`` atomically at clean exit.

    Stages into a ``.<name>.tmp.<pid>.<tid>.<seq>`` sibling in the
    destination directory, fsyncs the payload, then ``os.replace``s over the
    final name and fsyncs the directory entry so the rename itself survives
    power loss. On any failure the temp file is removed and the destination
    keeps its previous contents. Streaming writers (pickle.dump, large
    copies) use this directly so nothing is materialized in memory.
    """
    path = os.fspath(path)
    d = os.path.dirname(path) or '.'
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, '.%s.tmp.%d.%d.%d' % (
        os.path.basename(path), os.getpid(), threading.get_ident(),
        next(_tmp_seq)))
    try:
        _invoke_hook('write', path)
        f = open(tmp, 'wb')   # atomic-ok: staged temp, committed below
        try:
            yield (f if _stream_hook is None
                   else _HookedStream(f, path, _stream_hook))
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        finally:
            f.close()
        _invoke_hook('replace', path)
        os.replace(tmp, path)
    except BaseException as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        if isinstance(e, (OSError, IOError)) and \
                not isinstance(e, AtomicWriteError):
            raise AtomicWriteError(
                "atomic write to %r failed before commit (%s); the "
                "destination was left untouched" % (path, e)) from e
        raise
    if fsync:
        _fsync_dir(d)


class _HookedStream:
    """File proxy interposed only while a stream fault hook is armed:
    forwards everything (seek/tell/fileno — zipfile/np.savez need them) but
    routes ``write`` through the hook with a running byte count, so an
    injector can fail or delay a commit *partway through* the payload."""

    def __init__(self, f, path, hook):
        self._f = f
        self._path = path
        self._hook = hook
        self._written = 0

    def write(self, data):
        self._hook(self._path, self._written, len(data))
        n = self._f.write(data)
        self._written += len(data)
        return n

    def __getattr__(self, name):
        return getattr(self._f, name)


def atomic_write(path, data, fsync=True):
    """Write ``data`` (bytes, or a readable file-like streamed in 1 MiB
    chunks) to ``path`` through the :func:`atomic_open` commit protocol."""
    with atomic_open(path, fsync=fsync) as f:
        if hasattr(data, 'read'):
            shutil.copyfileobj(data, f, length=1 << 20)
        else:
            f.write(data)
    return path


def _fsync_dir(d):
    """Persist a directory entry (the rename) — best-effort on filesystems
    that reject directory fds."""
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_pickle_dump(obj, path, protocol=4, fsync=True):
    """Pickle ``obj`` to ``path`` through the atomic commit protocol.

    Streams via pickle.dump into the staged temp (same peak memory as the
    pre-resilience bare-open path — no full serialized blob in RAM)."""
    with atomic_open(path, fsync=fsync) as f:
        pickle.dump(obj, f, protocol=protocol)
    return path


def crc32_bytes(data):
    return zlib.crc32(data) & 0xFFFFFFFF


def crc32_file(path, chunk=1 << 20):
    crc = 0
    with open(path, 'rb') as f:
        for block in iter(lambda: f.read(chunk), b''):
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF
