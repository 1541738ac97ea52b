#!/usr/bin/env python3
"""Time ``hapi.Model``'s eager BERT-large step with each parameter's Adam
slots made alone against made together, in turns on one GPU.

    python3 ab_eager_pows.py [--seed N] [--rounds R]

The eager ``optimizer.step()`` makes the slots of the parameters it has
not seen yet. Made one at a time, every parameter holds its own pair of
0-dim ``beta*_pow`` tensors and a step advances and divides by each pair
(~2400 more launches on BERT-large's 398 parameters); made together
(``init_state_values``, what ``functional_update`` does), they share one.
This script seeds the optimizer with per-parameter slots to rebuild the
first case, then runs ``chip_smoke.py``'s ``hapi_fit`` recipe (fp32
AdamW, 2 epochs of 6 steps, eager) per-parameter, shared, shared,
per-parameter, ... and prints one JSON line a run: the number of
``beta1_pow`` tensors, the median step ms of the second epoch, and the
losses (equal between the two cases). Needs one CUDA device; exits
non-zero without one.
"""
import argparse
import json
import subprocess
import sys

import numpy as np
import torch


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--rounds', type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_eager_pows: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from paddle_tpu_torch.hapi.callbacks import LRScheduler
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    train, evals = cs._hapi_sets(args.seed + 6, cs.HAPI_TRAIN, cs.HAPI_EVAL,
                                 30522)
    for run in range(2 * args.rounds):
        per_parameter = run % 4 in (0, 3)
        model = cs._hapi_model(args.seed + 3, 24, 0.1, False)
        opt = model._optimizer
        if per_parameter:
            opt._accumulators.update({n: opt._init_state(p) for n, p in
                                      model.network.named_parameters()})
        clock = cs._step_clock()
        cs._hapi_fit(model, train, evals, [clock, LRScheduler()], args.seed)
        ends = [r[2] for r in clock.rows if r[0] == cs.HAPI_EPOCHS - 1]
        ms = [1e3 * (b - a) for a, b in zip(ends, ends[1:])]
        print(json.dumps({
            'run': run, 'per_parameter_slots': per_parameter,
            'beta1_pow_tensors': len({id(s['beta1_pow']) for s in
                                      opt._accumulators.values()}),
            'step_ms_median': float(np.median(ms)), 'step_ms': ms,
            'losses': [float(r[3]['loss']) for r in clock.rows]}),
            flush=True)
        del model, opt, clock
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
