#!/usr/bin/env python3
"""Count the device records a torch.profiler session drops at its start,
with one sleep kernel before the profiled call against ``chip_smoke.py``'s
pre-roll of ``PREROLL_SPINS`` sleeps, in turns on one GPU.

    python3 profile_preroll.py [--seed N] [--sessions S]

In some process states a session drops its first device records as
outside the profiler's window. Ten sessions and ``chip_smoke.py``'s
``phase_train_resume`` bring a process into that state. The script then
profiles 25 LayerNorm launches (4096 x 1024, fp32) S times each of
three ways, in turns: after one short sleep kernel, as ``chip_smoke.py``'s
sessions did before; after one ~20 ms sleep; and through
``phase_profile`` itself. It prints one JSON line a session (the
LayerNorm launches counted and caught, the sleeps caught, the takes) and
a summary line. Needs one CUDA device; exits
non-zero without one.
"""
import argparse
import sys

import torch

LAUNCHES = 25
ROUTE = 'ln_rows_warp_kernel'
LONG_SLEEP_CYCLES = 40_000_000      # ~20 ms at the H100's 1.98 GHz


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--sessions', type=int, default=12)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_preroll: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from paddle_tpu_torch.kernels.fused_norm import fused_layer_norm
    card = cs.phase_card()       # prints the card's name and power limit
    cs.phase_build()
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    x = torch.randn(4096, 1024, device=dev, generator=gen)
    w, b = torch.ones(1024, device=dev), torch.zeros(1024, device=dev)

    def run():
        for _ in range(LAUNCHES):
            fused_layer_norm(x, w, b)

    run()
    torch.cuda.synchronize()
    for _ in range(10):
        cs._profile_session(run, 1)
    cs.phase_train_resume(args.seed, card)
    torch.cuda.empty_cache()
    before = {'one sleep': {'sessions': 0, 'lost_some': 0},
              'one 20 ms sleep': {'sessions': 0, 'lost_some': 0}}
    pre = {'sessions': 0, 'failed': 0, 'takes': [], 'sleeps_caught': []}
    for _ in range(args.sessions):
        for what, cycles in (('one sleep', 1000),
                             ('one 20 ms sleep', LONG_SLEEP_CYCLES)):
            by_name, _, _, launched, slept, _ = cs._profile_session(
                run, 1, cycles)
            caught = sum(n for name, (_, n) in by_name.items()
                         if ROUTE in name)
            before[what]['sessions'] += 1
            before[what]['lost_some'] += caught < launched
            cs.emit({'session': what, 'launched': launched,
                     'caught': caught, 'sleeps_caught': slept})
        pre['sessions'] += 1
        try:
            row = cs.phase_profile('LayerNorm x 25', run, {ROUTE: LAUNCHES})
        except AssertionError:
            pre['failed'] += 1
            continue
        pre['takes'].append(row['takes'])
        pre['sleeps_caught'].append(row['preroll']['caught'])
    cs.emit({**before, 'preroll': pre,
             'preroll_spins': cs.PREROLL_SPINS, 'card': card})
    return 0 if pre['failed'] == 0 else 1


if __name__ == '__main__':
    sys.exit(main())
