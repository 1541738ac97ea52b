#!/usr/bin/env python3
"""Which collectives a gloo process group takes on CUDA tensors, two ranks
on one GPU (``distributed.spawn(nprocs=2, backend='gloo')``), and what the
port's all-reduce path for the others moves and costs.

    python3 probe_gloo_cuda.py [--mb MB]

Two fresh ranks a call try ``torch.distributed``'s own all_reduce,
broadcast, all_gather_into_tensor, reduce_scatter_tensor,
all_to_all_single, reduce and a send/recv pair (``batch_isend_irecv``) on
small CUDA tensors, and report ``ok``, a wrong result, the error's first
line, or the line of a rank's death (gloo aborts the process on some).
Then
it times, with the host clock after a synchronise, ``MB`` megabytes of
fp32: gloo's ``all_reduce`` of the tensor, and the port's ``ppermute`` of
it over a 2-rank axis (the all-reduce of a zero-padded 2 x buffer, the
path ``collective.gloo_cuda`` chooses), five each after a warm-up. Prints
the card's name and power limit, one JSON line a rank and a last line
``{"ok": true}``. Needs one CUDA device; exits non-zero without one.
"""
import argparse
import json
import sys
import time

import torch


def _op(name, r, dev):
    """Call ``torch.distributed``'s op ``name`` on small CUDA tensors ->
    'ok', 'wrong result' or the error's first line (a crash ends the
    process; the parent reports it)."""
    import torch.distributed as tdist
    t = lambda v: torch.full((4,), float(v), device=dev)   # noqa: E731
    if name == 'all_reduce':
        x = t(r + 1)
        tdist.all_reduce(x)
        ok = float(x[0]) == 3.0
    elif name == 'broadcast':
        x = t(r + 1)
        tdist.broadcast(x, 1)
        ok = float(x[0]) == 2.0
    elif name == 'all_gather_into_tensor':
        x = torch.empty(8, device=dev)
        tdist.all_gather_into_tensor(x, t(r))
        ok = x.tolist() == [0.0] * 4 + [1.0] * 4
    elif name == 'reduce_scatter_tensor':
        x = torch.empty(2, device=dev)
        tdist.reduce_scatter_tensor(x, t(1))
        ok = x.tolist() == [2.0, 2.0]
    elif name == 'all_to_all_single':
        x = torch.empty(4, device=dev)
        tdist.all_to_all_single(x, t(r))
        ok = x.tolist() == [0.0, 0.0, 1.0, 1.0]
    elif name == 'reduce':
        x = t(r + 1)
        tdist.reduce(x, 0)
        ok = r != 0 or float(x[0]) == 3.0
    else:                                   # send_recv
        x = torch.empty(4, device=dev)
        reqs = tdist.batch_isend_irecv([
            tdist.P2POp(tdist.isend, t(r), 1 - r),
            tdist.P2POp(tdist.irecv, x, 1 - r)])
        for q in reqs:
            q.wait()
        ok = float(x[0]) == 1 - r
    torch.cuda.synchronize()
    return 'ok' if ok else 'wrong result'


OPS = ('all_reduce', 'broadcast', 'all_gather_into_tensor',
       'reduce_scatter_tensor', 'all_to_all_single', 'reduce', 'send_recv')


def _one_op(name):
    from paddle_tpu_torch import distributed as dist
    dist.init_parallel_env()
    r = dist.get_rank()
    try:
        return _op(name, r, torch.device('cuda', 0))
    except Exception as e:   # the error is the finding
        return f'{type(e).__name__}: {str(e).splitlines()[0][:160]}'


def _timed(mb):
    import torch.distributed as tdist
    from paddle_tpu_torch import distributed as dist
    dist.init_parallel_env((2,), ('seq',))
    big = torch.ones(int(mb * 2 ** 20) // 4, device='cuda')
    times = {}
    for name, fn in (('all_reduce', lambda: tdist.all_reduce(big)),
                     ('ppermute', lambda: dist.ppermute(
                         big, [(0, 1), (1, 0)], axis='seq'))):
        fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        times[name] = ms
    return {'rank': dist.get_rank(), 'mb': mb, 'ms': times,
            'counts': dist.collective.collective_counts()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--mb', type=float, default=16.0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_gloo_cuda: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch import distributed as dist
    cs.phase_card()            # prints the card's name and power limit
    ops = {}
    for name in OPS:           # each in two fresh ranks: a crash is local
        try:
            got = dist.spawn(_one_op, args=(name,), nprocs=2,
                             backend='gloo', join=False).join(timeout=120)
            ops[name] = got[0] if got[0] == got[1] else got
        except Exception as e:   # a rank died: its log says why
            text = str(e)
            why = [ln for ln in text.splitlines() if 'what()' in ln
                   or 'Error' in ln]
            ops[name] = 'rank died: ' + (why[0].strip() if why else
                                         text.splitlines()[0])[:200]
    print(json.dumps({'gloo_cuda_ops': ops}, sort_keys=True))
    for r in dist.spawn(_timed, args=(args.mb,), nprocs=2, backend='gloo',
                        join=False).join(timeout=300):
        print(json.dumps(r, sort_keys=True))
    print(json.dumps({'ok': True}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
