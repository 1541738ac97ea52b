"""Build, load and call the port's CUDA kernels. No reference counterpart.

The JAX package's Pallas kernels are compiled by JAX itself; the port's
kernels are CUDA C++ sources in ``csrc/`` with a plain C interface. At
first use ``load()`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
``nvcc`` per source, all started together, then one link) into a shared
library under ``kernels/build/`` and opens it with ``ctypes``. The
library's name carries a digest of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused. A failed build or load
raises; there is no fallback.

Every C entry point takes ``void*`` pointers (``tensor.data_ptr()``) and
the CUDA stream, launches on that stream and returns
``cudaGetLastError()``; ``call`` raises on a non-zero code and otherwise
adds one to the launched kernel's count in ``launches``. Each kernel is
instantiated for fp32, bf16 and fp16 and reads and writes its tensors in
HBM in that dtype (statistics, ``lse``, ``delta`` and the key bias are always
fp32); the entry point takes the code ``dtype_code`` gives.

``work(kernel, formula)`` decorates each wrapper: while a listener is
registered in ``work_listeners`` (the cost ledger's capture,
``observability.costs``), a call tells it the operations and bytes its
kernel does on the call's shapes, with the formulas ``chip_smoke.py``
uses for the kernel's bound, and runs hidden from the dispatch modes that
count torch ops, so that a plain version on the CPU counts as its kernel
does on the card. Without a listener the wrapper runs as it is.

``use_kernels(tensor)`` is the one place that decides between a kernel and
its plain PyTorch version: CPU tensors take the plain version, CUDA
tensors the kernel. ``plain_versions()`` is a context manager for tests
and ``chip_smoke.py`` that sends CUDA tensors to the plain versions too,
so that a kernel path and its yardstick can run on the same card; no entry
point of the package uses it.
"""
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = ['BUILD_DIR', 'NVCC_FLAGS', 'KERNELS', 'DTYPES', 'launches', 'load',
           'call', 'require', 'dtype_code', 'stream', 'dropout_args',
           'use_kernels', 'plain_versions', 'work', 'work_listeners']

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent / 'build'
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = ARCH_FLAGS + ('-std=c++17', '-O3', '-Xcompiler', '-fPIC',
                           '-Xptxas=-v')

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64
U32 = ctypes.c_uint32
U64 = ctypes.c_uint64
F32 = ctypes.c_float
# what every entry point with dropout takes: seed, offset, threshold, scale
DROPOUT_ARGTYPES = (U64, U64, U32, F32)

KERNELS = ('flash_attention_fwd', 'flash_attention_dq', 'flash_attention_dkv',
           'layer_norm_fwd', 'rms_norm_fwd', 'add_layer_norm_fwd',
           'dropout_grad')
# the element types the kernels are built for -> the code the C entry
# points take (csrc/dtype.cuh, ElemType)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# kernel launches since the last reset, by kernel (kernels.launch_counts)
launches = dict.fromkeys(KERNELS, 0)
# called with the milliseconds of each build that ran nvcc
# (observability.interpose.install_build_hooks registers one)
build_listeners = []
# called with (kernel, operations, bytes) of each wrapper call while
# registered (observability.costs.capture registers one for a dispatch)
work_listeners = []
_force_plain = False

_lock = threading.Lock()
_lib = None
_fns = {}


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    candidates = [os.path.join(cuda_home, 'bin', 'nvcc') if cuda_home
                  else None, shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc']
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "paddle_tpu_torch: nvcc not found (set CUDA_HOME or put nvcc on "
        "PATH); the CUDA kernels are built from kernels/csrc/ at first use")


def _digest():
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in ('.cu', '.cuh'):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile ``csrc/*.cu`` into the shared library (reused when the
    sources are unchanged) -> its path. The compiler's output, with
    ``ptxas`` register and spill counts, is kept beside it as
    ``<library>.log``. Each build that runs nvcc calls every
    ``build_listeners`` entry with its milliseconds."""
    lib_path = BUILD_DIR / f'libpaddle_tpu_torch_kernels_{_digest()}.so'
    if lib_path.exists():
        return lib_path
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob('*.cu'))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + '.o')
            cmd = [nvcc, *NVCC_FLAGS, '-c', str(src), '-o', str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            log.append(f'== {src.name} (exit {proc.returncode})\n{out}')
            if proc.returncode != 0:
                failed.append(src.name)
        if not failed:
            tmp_lib = Path(tmp) / lib_path.name
            link = subprocess.run(
                [nvcc, *ARCH_FLAGS, '-shared', '-o', str(tmp_lib),
                 *(str(obj) for _, obj, _ in jobs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(f'== link (exit {link.returncode})\n{link.stdout}')
            if link.returncode != 0:
                failed.append('link')
        text = '\n'.join(log)
        Path(str(lib_path) + '.log').write_text(text)
        if failed:
            raise RuntimeError(
                f"paddle_tpu_torch: building the CUDA kernels failed "
                f"({', '.join(failed)}):\n{text}")
        os.replace(tmp_lib, lib_path)
    ms = 1e3 * (time.perf_counter() - t0)
    for listener in build_listeners:
        listener(ms)
    return lib_path


def load():
    """Build (at first use) and open the kernel library -> ``ctypes.CDLL``."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.ptt_error_string.argtypes = (I32,)
            lib.ptt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def call(kernel, name, argtypes, *args):
    """Call C entry point ``name``, which launches ``kernel`` once; raise
    if it reports a CUDA error, else count the launch."""
    fn = _fns.get(name)
    if fn is None:
        lib = load()
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = I32
        _fns[name] = fn
    code = fn(*args)
    if code != 0:
        msg = load().ptt_error_string(code).decode()
        raise RuntimeError(f"paddle_tpu_torch: {name} failed: CUDA error "
                           f"{code} ({msg})")
    launches[kernel] += 1


def dropout_args(p, seed, offset):
    """``(seed, offset, threshold, scale)`` as the entry points take them;
    ``p == 0`` gives scale 1, which turns dropout off in the kernel."""
    from .philox import threshold
    if p <= 0.0:
        return 0, 0, 0, 1.0
    return (int(seed) & 0xFFFFFFFFFFFFFFFF, int(offset) & 0xFFFFFFFFFFFFFFFF,
            threshold(p), 1.0 / (1.0 - p))


def work(kernel, formula):
    """Decorator of a kernel's wrapper: while ``work_listeners`` holds a
    listener, each call tells it ``(kernel, *formula(*args, **kwargs))``,
    the operations and bytes of the call, and runs with the dispatch modes
    set aside (the kernel path's allocations and a plain version's ops are
    counted by the formula instead)."""
    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            if not work_listeners:
                return fn(*args, **kwargs)
            flops, nbytes = formula(*args, **kwargs)
            if flops or nbytes:
                for listener in list(work_listeners):
                    listener(kernel, float(flops), float(nbytes))
            from torch.utils._python_dispatch import _disable_current_modes
            with _disable_current_modes():
                return fn(*args, **kwargs)
        return counted
    return wrap


def use_kernels(t):
    """False where ``t`` takes the plain versions: on the CPU, or on any
    device inside ``plain_versions()``."""
    return t.device.type != 'cpu' and not _force_plain


@contextlib.contextmanager
def plain_versions():
    """Send every tensor to the kernels' plain PyTorch versions, CUDA
    tensors included: for holding a kernel path against its yardstick on
    one device. Not a fallback; nothing in the package enters it."""
    global _force_plain
    before, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = before


def stream(device):
    """The current CUDA stream of ``device``, as the integer handle the C
    entry points take."""
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(t):
    """The element-type code of ``t``'s dtype for the C entry points."""
    return DTYPES[t.dtype]


def require(t, name, device, shape=None, contiguous=True, dtype=None):
    """Raise ``ValueError`` unless ``t`` is a contiguous CUDA tensor on
    ``device`` of a dtype the kernels take — ``dtype`` when given (the
    call's own dtype, or fp32 for statistics and the key bias), else fp32,
    bf16 or fp16 — and with ``shape``, when given. With
    ``contiguous=False`` the caller checks the layout itself. Nothing is
    converted: a tensor of another dtype is refused, never cast."""
    if t.dtype not in DTYPES:
        raise ValueError(f"{name}: the CUDA kernels take float32, bfloat16 "
                         f"or float16, got {t.dtype}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}: every "
                         f"tensor of one call has the call's dtype, and "
                         f"statistics, lse, delta and the key bias are "
                         f"float32")
    if t.device.type != 'cuda':
        raise ValueError(f"{name}: expected a CUDA tensor, got device "
                         f"{t.device}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
