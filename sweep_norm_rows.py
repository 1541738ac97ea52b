#!/usr/bin/env python3
"""Time the LayerNorm and RMSNorm register path at several occupancies.

    python3 sweep_norm_rows.py [--blocks 4 6 8 10 12 16]
                               [--checkout NAME=DIR ...]

The register path's kernels (``ln_rows_warp_kernel``,
``rms_rows_warp_kernel``, ``paddle_tpu_torch/kernels/csrc/fused_norm.cu``)
ask ptxas for room for ``kRowMinBlocks`` blocks an SM
(``csrc/norm_rows.cuh``). This script builds ``fused_norm.cu`` once for
each value given, in a copy of ``csrc/`` with that constant rewritten (one
``nvcc`` a value, all started together, under the git-ignored
``kernels/build/``), and prints each build's ptxas registers and spills.
Each ``--checkout NAME=DIR`` adds the ``fused_norm.cu`` of another
checkout (the parent commit, or an edited copy) as one more variant.
Each variant then runs in a fresh process of its own (the variants'
kernels share their names), in turn, forward then in reverse order: it
is held against the plain version (``layer_norm_stats``,
``rms_norm_stats``) at every case, at ``chip_smoke.py``'s gates, and
timed at every case with ``chip_smoke.time_ms`` (cold L2, the stream
held). One JSON line a build
and a case; the last line is ``{"ok": true, ...}`` with the card's name
and power limit. Needs one CUDA card and nvcc; exits non-zero without
them.
"""
import argparse
import ctypes
import multiprocessing
import re
import shutil
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import torch

# (kernel, dtype, rows, width, statistics out): the forwards chip_smoke.py
# times -- the bf16 train step's embeddings (4096 rows) and MLM head (608),
# the fp32 train step's, serving's fp32 bucket-16 embeddings without
# statistics -- and 768 columns (3 chunks a lane at bf16, 6 at fp32)
CASES = (('ln', 'bf16', 4096, 1024, True), ('ln', 'bf16', 608, 1024, True),
         ('ln', 'bf16', 16384, 1024, True), ('ln', 'fp32', 4096, 1024, True),
         ('ln', 'fp32', 8192, 1024, False), ('ln', 'bf16', 4096, 768, True),
         ('ln', 'fp32', 4096, 768, True), ('rms', 'bf16', 4096, 1024, True),
         ('rms', 'fp32', 4096, 1024, True))
# eps as BERT's LayerNorm and chip_smoke.py's nn.RMSNorm take it
EPS = {'ln': 1e-12, 'rms': 1e-6}
DTYPE_CODES = {'fp32': 0, 'bf16': 1}
MIN_BLOCKS = re.compile(r'constexpr int kRowMinBlocks = \d+;')


def build(name, csrc, out_dir, nvcc, flags):
    """Start nvcc on ``csrc/fused_norm.cu`` -> (name, library, process)."""
    lib = out_dir / f'lib_{name}.so'
    proc = subprocess.Popen(
        [nvcc, *flags, '-shared', '-I', str(csrc), '-o', str(lib),
         str(csrc / 'fused_norm.cu')],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return name, lib, proc


def variant_sources(blocks, out_dir, csrc):
    """A copy of ``csrc`` with kRowMinBlocks = ``blocks`` -> its path."""
    dst = out_dir / f'csrc_b{blocks}'
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    header = dst / 'norm_rows.cuh'
    text, n = MIN_BLOCKS.subn(f'constexpr int kRowMinBlocks = {blocks};',
                              header.read_text())
    if n != 1:
        raise RuntimeError('kRowMinBlocks not found once in norm_rows.cuh')
    header.write_text(text)
    return dst


def case_inputs(case, dev, gen):
    """-> (the C arguments before n, d, eps; the outputs; the plain
    version's outputs)."""
    from paddle_tpu_torch.kernels import fused_norm
    kind, dt, n, d, stats = case
    dtype = torch.bfloat16 if dt == 'bf16' else torch.float32
    x = torch.randn(n, d, device=dev, generator=gen).to(dtype)
    w = (1.0 + 0.1 * torch.randn(d, device=dev, generator=gen)).to(dtype)
    b = (0.1 * torch.randn(d, device=dev, generator=gen)).to(dtype)
    y = torch.empty_like(x)
    st = [torch.empty(n, device=dev) if stats else None
          for _ in range(2 if kind == 'ln' else 1)]
    ptr = [None if t is None else t.data_ptr() for t in st]
    if kind == 'ln':
        args = [x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), *ptr]
        want = fused_norm.layer_norm_stats(x, w, b, EPS[kind])
    else:
        args = [x.data_ptr(), w.data_ptr(), y.data_ptr(), *ptr]
        want = fused_norm.rms_norm_stats(x, w, EPS[kind])
    return args, [y] + st, want


def run_variant(lib_path, seed):
    """In a fresh process: load one variant's library, hold it against the
    plain version at every case and time it -> {case: {'ms', 'errors'}}.
    One library a process: the variants' kernels share their names, and
    the CUDA runtime that registers them is PyTorch's, one a process."""
    import chip_smoke
    from paddle_tpu_torch.kernels import _build, fused_norm
    lib = ctypes.CDLL(str(lib_path))
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    stream = _build.stream(dev)
    out = {}
    for case in CASES:
        kind, dt, n, d, _ = case
        c_args, outs, want = case_inputs(case, dev, gen)
        fn = getattr(lib, 'ptt_layer_norm_fwd' if kind == 'ln'
                     else 'ptt_rms_norm_fwd')
        fn.argtypes = (fused_norm._ARGTYPES if kind == 'ln'
                       else fused_norm._RMS_ARGTYPES)
        fn.restype = ctypes.c_int

        def call():
            if fn(*c_args, n, d, EPS[kind], DTYPE_CODES[dt], stream) != 0:
                raise RuntimeError(f'{lib_path.name} {case}: launch failed')
        for t in outs:
            if t is not None:
                t.fill_(float('nan'))
        call()
        torch.cuda.synchronize()
        what = f'{lib_path.name} {case}'
        if dt == 'bf16':
            e_y = chip_smoke.rel_err(outs[0], want[0])
            chip_smoke.check(f'{what}: y over its max', e_y,
                             chip_smoke.BF16_TOL)
        else:
            e_y = chip_smoke.max_err(outs[0], want[0])
            chip_smoke.check(f'{what}: y', e_y, chip_smoke.TOL)
        e_st = max([chip_smoke.max_err(t, r) for t, r
                    in zip(outs[1:], want[1:]) if t is not None],
                   default=0.0)
        chip_smoke.check(f'{what}: statistics', e_st, chip_smoke.STAT_TOL)
        out[str(case)] = {'ms': chip_smoke.time_ms(call, flush),
                          'errors': {'y': e_y, 'stats': e_st}}
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--blocks', type=int, nargs='+',
                        default=[4, 6, 8, 10, 12, 16])
    parser.add_argument('--checkout', action='append', default=[],
                        metavar='NAME=DIR',
                        help='a checkout whose fused_norm.cu is built too')
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("sweep_norm_rows: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from paddle_tpu_torch.kernels import _build
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    out_dir = _build.BUILD_DIR / 'variants'
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    jobs = [build(f'b{b}', variant_sources(b, out_dir, _build.CSRC),
                  out_dir, nvcc, _build.NVCC_FLAGS) for b in args.blocks]
    for spec in args.checkout:
        name, _, root = spec.partition('=')
        jobs.append(build(name, Path(root) / 'paddle_tpu_torch' / 'kernels' /
                          'csrc', out_dir, nvcc, _build.NVCC_FLAGS))
    libs = {}
    for name, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'{name}: nvcc failed\n{log}')
        chip_smoke.emit({'build': name,
                         'ptxas': chip_smoke._ptxas_table(log)})
        libs[name] = lib

    # each variant in a fresh process, in turn, forward then in reverse
    order = list(libs)
    runs = {name: [] for name in order}
    spawn = multiprocessing.get_context('spawn')
    with ProcessPoolExecutor(max_workers=1, mp_context=spawn,
                             max_tasks_per_child=1) as pool:
        for name in order + order[::-1]:
            runs[name].append(pool.submit(run_variant, libs[name],
                                          args.seed).result())
    for case in CASES:
        kind, dt, n, d, stats = case
        chip_smoke.emit({
            'case': {'kernel': kind, 'dtype': dt, 'rows': n, 'width': d,
                     'statistics': stats}, 'card': smi,
            'ms': {name: [r[str(case)]['ms'] for r in rs]
                   for name, rs in runs.items()},
            'errors': {name: rs[0][str(case)]['errors']
                       for name, rs in runs.items()}})
    chip_smoke.emit({'ok': True, 'card': smi,
                     'device': torch.cuda.get_device_name(0)})
    return 0


if __name__ == '__main__':
    sys.exit(main())
