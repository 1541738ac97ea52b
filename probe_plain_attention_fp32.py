#!/usr/bin/env python3
"""Where the fp32 gradients of the seq2seq parity model move away from
fp64: ``chip_smoke.py``'s ``seq2seq_parity`` model (``Seq2SeqTransformer``
at Transformer-base's widths, 2 + 2 layers, p = 0, 8 x 64 x 64, the same
seed) run through each mix of the kernels and their plain versions.

    python3 probe_plain_attention_fp32.py [--seed N]

Mixes, each one teacher-forced forward and backward: every kernel on the
card; every plain version on the card; the attention's plain version
alone; the two norms' plain versions alone; LayerNorm's alone;
add+LayerNorm's alone; the CPU at fp32; the CPU at fp64 (the yardstick).
For each it prints one JSON line: the loss's relative error against fp64
and the six gradients farthest from fp64 (max abs error over the
tensor's max, floored at 1e-3 of the model's largest gradient entry, as
``chip_smoke._grad_errs``). Then the card's name and power limit and a
last line ``{"ok": true}``. Needs one CUDA device; exits non-zero
without one. TF32 off.
"""
import argparse
import copy
import json
import subprocess
import sys
import types

import numpy as np
import torch


def _plain_in(modules, build):
    """Route ``modules``' wrappers to their plain versions, leaving the
    other kernels on the card."""
    fake = types.SimpleNamespace(**{k: getattr(build, k) for k in dir(build)
                                    if not k.startswith('__')})
    fake.use_kernels = lambda t: False
    for m in modules:
        m._build = fake


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seed', type=int, default=0)
    seed = parser.parse_args().seed
    if not torch.cuda.is_available():
        print("probe_plain_attention_fp32: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_dropout_norm as fdn
    from paddle_tpu_torch.kernels import fused_norm as fn
    from paddle_tpu_torch.text import Seq2SeqTransformer
    cs.phase_build()
    dev = torch.device('cuda', 0)
    rs = np.random.RandomState(seed + 79)        # as seq2seq_parity
    src = rs.randint(2, cs.S2S_VOCAB, (cs.S2S_PARITY_BATCH, 64))
    trg = rs.randint(2, cs.S2S_VOCAB, (cs.S2S_PARITY_BATCH, 65))
    trg[:, 0] = 0
    batch = (src, trg[:, :-1], trg[:, 1:])
    gen = torch.Generator(device=dev).manual_seed(seed + 80)
    model = Seq2SeqTransformer(
        cs.S2S_VOCAB, cs.S2S_VOCAB, num_encoder_layers=cs.S2S_PARITY_LAYERS,
        num_decoder_layers=cs.S2S_PARITY_LAYERS, dropout=0.0, device=dev,
        generator=gen).train()
    runs = {'kernels': cs._s2s_loss_and_grads(model, batch, dev)}
    with _build.plain_versions():
        runs['plain'] = cs._s2s_loss_and_grads(model, batch, dev)
    for name, modules in (('attention_plain', (fa,)),
                          ('norms_plain', (fn, fdn)),
                          ('layer_norm_plain', (fn,)),
                          ('add_layer_norm_plain', (fdn,))):
        _plain_in(modules, _build)
        try:
            runs[name] = cs._s2s_loss_and_grads(model, batch, dev)
        finally:
            for m in modules:
                m._build = _build
    cpu = copy.deepcopy(model).to('cpu')
    runs['cpu_fp32'] = cs._s2s_loss_and_grads(cpu, batch, 'cpu')
    truth_loss, truth = cs._s2s_loss_and_grads(cpu.double(), batch, 'cpu')
    for name, (loss, grads) in runs.items():
        errs = cs._grad_errs(grads, truth)
        print(json.dumps({'mix': name, 'against': 'CPU fp64',
                          'loss_rel_err': abs(loss - truth_loss)
                          / abs(truth_loss),
                          'gradients_worst': sorted(
                              errs.items(), key=lambda kv: -kv[1])[:6]}))
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=False).stdout.strip()
    print(json.dumps({'card': card}))
    print(json.dumps({'ok': True}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
