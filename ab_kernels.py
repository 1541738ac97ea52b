#!/usr/bin/env python3
"""Time the port's kernels of this checkout against another's on one GPU,
in turns: ``chip_smoke.phase_kernels`` (the seven kernels at the train and
serve shapes, fp32, against their plain versions and library calls) in a
fresh process a turn, another checkout, this one, this one, the other.

    python3 ab_kernels.py --other DIR [--seed N]

Each turn builds its checkout's kernels (its own ``kernels/build``) and
prints, as one JSON line, its kernels' times (``ms``, ``ms_p0``,
``plain_ms``, ``library_ms``) and ptxas's registers and spills of the
attention kernels' instantiations; a last line ``{"ok": true}``. A
process a turn: two libraries whose kernels share names do not load into
one process. Needs one CUDA device; exits non-zero without one.
"""
import argparse
import json
import os
import subprocess
import sys

KEYS = ('ms', 'ms_p0', 'plain_ms', 'library_ms')

TURN = r'''
import json, sys
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.phase_card()
build = cs.phase_build()
flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device='cuda')
rows = cs.phase_kernels(int(sys.argv[1]), flush)
print('AB ' + json.dumps({'times': {k: {f: v.get(f) for f in %r}
                                    for k, v in rows.items()}}))
'''


def turn(checkout, seed):
    out = subprocess.run(
        [sys.executable, '-c', TURN % (KEYS,), str(seed)], cwd=checkout,
        env={**os.environ, 'PYTHONPATH': checkout}, capture_output=True,
        text=True, timeout=1200)
    if out.returncode:
        raise RuntimeError(f"ab_kernels: {checkout}: {out.stderr[-2000:]}")
    row = {}
    for line in out.stdout.splitlines():
        if line.startswith('AB '):
            row.update(json.loads(line[3:]))
        elif '"phase": "build"' in line:
            build = json.loads(line)
            row['ptxas'] = {k['kernel']: [k['registers'], k['spill_stores']]
                            for k in build.get('ptxas', [])
                            if k['kernel'].startswith('flash_')}
    return row


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--other', required=True)
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(args.other)
    for name, checkout in (('other', other), ('this', here),
                           ('this', here), ('other', other)):
        print(json.dumps({'turn': name, **turn(checkout, args.seed)}),
              flush=True)
    print(json.dumps({'ok': True}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
