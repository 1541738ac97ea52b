#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:

1. card   — the GPU's name and power limit (nvidia-smi), versions;
2. build  — compile the port's CUDA kernels from ``paddle_tpu_torch/
   kernels/csrc`` with nvcc for sm_90a (set-up time);
3. kernels — each of the six kernels against its plain PyTorch version on
   the card at the shapes BERT-large serving and training give it (fp32)
   and at awkward ones, without and with dropout, with its time, the plain
   version's, one PyTorch library call's as a yardstick, and the bound;
   the Philox dropout mask bit for bit against ``kernels/philox.py``;
4. parity — a full-width, 2-layer BERT served through ``ServingEngine`` on
   the GPU against the same weights run on the CPU (plain path);
5. serve  — BERT-large (24 layers, hidden 1024, seq 512) served through
   ``ServingEngine`` in batches landing in buckets 1, 4 and 16, plus one
   request through the worker thread; the kernel launch counts of this
   run must be exactly 1 LayerNorm, 48 add+LayerNorm and 24 flash
   attention launches per batch;
6. profile — device time by kernel over one more bucket-16 batch;
7. train parity — a full-width, 2-layer ``BertForPretraining``, batch 2 x
   512: loss and every gradient, GPU against CPU at p = 0, and kernel
   path against plain path on the GPU at p = 0.1 with the same seeds; the
   same step twice from one (seed, offset) gives one loss;
8. train — BERT-large pretraining, batch 8 x 512, dropout 0.1, through
   ``engine.build_train_step`` with AdamW: 2 warm-up and 18 timed steps on
   one batch; per step exactly 24 flash forward, 24 dQ, 24 dK/dV, 48
   add+LayerNorm, 48 mask-gradient and 2 LayerNorm launches; every loss
   finite and the 20th below the 1st; then one profiled step.

Then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
...}``. Any failure raises and exits non-zero; without a CUDA device (or
without the package beside this file) it exits non-zero and prints no
result. Matrix products run in full fp32 (TF32 off).
"""
import argparse
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (dense): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# kernel vs plain version, max abs, fp32: the two sum in different orders,
# which moves values of order 1-10 by ~1e-6; 1e-4 leaves a wide margin
TOL = 1e-4
# GPU engine vs CPU plain path, whole model, fp32: cuBLAS and the CPU BLAS
# sum 1024- and 4096-term products in different orders, layer after layer
MODEL_TOL = 1e-3
# gradients, kernel vs plain version and GPU vs CPU: max abs error over the
# gradient's max abs value
GRAD_TOL = 1e-3
SEQ = 512
TRAIN_BATCH = 8
TIMED_RUNS = 25


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(flops, nbytes):
    t_ops, t_mem = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_mem), 'operations' if t_ops > t_mem else 'bytes'


def time_ms(fn, flush):
    """Median device time of ``fn`` over TIMED_RUNS launches, CUDA events
    around each; the L2 cache is overwritten before each launch, so every
    input comes from device memory."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_RUNS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b):
    """Max abs error of ``a`` against ``b`` over ``b``'s max abs value."""
    return max_err(a, b) / max(float(b.float().abs().max()), 1e-30)


def check(name, err, tol):
    if not err <= tol:      # also catches NaN
        raise AssertionError(f"{name}: max abs error {err} > {tol}")


def phase_card():
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({'phase': 'card', 'nvidia_smi': smi,
          'torch_device': torch.cuda.get_device_name(0),
          'device_count': torch.cuda.device_count(),
          'torch': torch.__version__, 'cuda': torch.version.cuda,
          'tf32_matmul': torch.backends.cuda.matmul.allow_tf32,
          'tf32_cudnn': torch.backends.cudnn.allow_tf32})
    return smi


def phase_build():
    from paddle_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.load()
    seconds = time.perf_counter() - t0
    log = _build.build().with_suffix('.so.log')
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if 'registers' in ln or 'spill' in ln] if log.exists() else []
    emit({'phase': 'build', 'seconds': seconds, 'library': lib._name,
          'flags': list(_build.NVCC_FLAGS), 'ptxas': ptxas})


def emit_kernel(name, rows, tolerance=TOL, **extra):
    """One kernel's phase line; ``phase_launches`` counts this phase's
    own launches (checks and timing), not the main path's."""
    from paddle_tpu_torch import kernels
    row = dict(rows[name])
    emit({'phase': 'kernel', 'name': name, 'tolerance': tolerance,
          'kernel_ms': row.pop('ms'),
          'phase_launches': kernels.launch_counts()[name], **row, **extra})


def phase_kernels(seed, flush):
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import (flash_attention, fused_dropout_norm,
                                          fused_norm)
    kernels.reset_launch_counts()
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = {}

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    # -- flash attention at BERT-large serving's bucket-16 shape ----------
    B, H, L, D = 16, 16, SEQ, 64
    q, k, v = randn(B, H, L, D), randn(B, H, L, D), randn(B, H, L, D)
    lengths = torch.randint(L // 8, L + 1, (B,), device=dev, generator=gen)
    bias = torch.where(torch.arange(L, device=dev)[None, :] < lengths[:, None],
                       0.0, -1e4).to(torch.float32)   # BERT's (1 - m) * -1e4
    scale = 1.0 / D ** 0.5
    o, lse = flash_attention.flash_attention_forward(q, k, v, kpad_bias=bias)
    ro, rlse = flash_attention._attn_reference(q, k, v, False, scale, bias)
    torch.cuda.synchronize()
    err = max(max_err(o, ro), max_err(lse, rlse))
    check('flash attention (kpad)', err, TOL)
    cases = []
    # extra shapes: causal at full size; ragged L with a head dim padded
    # to 64 and one batch row whose every key is -inf; head dim 128
    for causal, shape, neg_row in ((True, (B, H, L, D), False),
                                   (False, (2, 3, 300, 40), True),
                                   (True, (1, 2, 77, 128), False)):
        b_, h_, l_, d_ = shape
        qq, kk, vv = randn(*shape), randn(*shape), randn(*shape)
        kb = None
        if not causal or d_ == 128:
            kb = torch.where(torch.rand(b_, l_, device=dev, generator=gen)
                             < 0.2, -1e4, 0.0).to(torch.float32)
            if neg_row:
                kb[1] = float('-inf')
        oo, ll = flash_attention.flash_attention_forward(
            qq, kk, vv, causal=causal, kpad_bias=kb)
        ro2, rl2 = flash_attention._attn_reference(
            qq, kk, vv, causal, 1.0 / d_ ** 0.5, kb)
        torch.cuda.synchronize()
        e = max(max_err(oo, ro2), max_err(ll, rl2))
        check(f'flash attention {shape} causal={causal}', e, TOL)
        cases.append({'shape': list(shape), 'causal': causal,
                      'bias': kb is not None, 'empty_row': neg_row,
                      'max_abs_err': e})
    # the work this input needs: every query row against the unmasked keys
    # of its batch row (a -1e4 bias contributes exp(-1e4) == 0 in fp32);
    # q, bias and o whole, k and v at the unmasked rows
    keys = float(lengths.sum())
    flops = 4.0 * H * L * D * keys
    nbytes = 4.0 * (2 * B * H * L * D + 2 * H * D * keys + B * L)
    b_ms, b_by = bound(flops, nbytes)
    mask4 = bias[:, None, None, :]
    rows['flash_attention_fwd'] = {
        'max_abs_err': err,
        'ms': time_ms(lambda: flash_attention.flash_attention_bhld(
            q, k, v, kpad_bias=bias), flush),
        'plain_ms': time_ms(lambda: flash_attention._attn_reference(
            q, k, v, False, scale, bias), flush),
        'library_ms': time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask4), flush),
        'bound_ms': b_ms, 'bound_by': b_by,
        'shape': [B, H, L, D], 'unmasked_keys': keys, 'flops': flops,
        'bytes': nbytes, 'flops_all_keys': 4.0 * B * H * L * L * D,
        'extra_cases': cases}

    # -- LayerNorm (embedding norm) and add+LayerNorm (48 epilogues) -----
    N, E = 16 * SEQ, 1024
    x, res = randn(N, E), randn(N, E)
    w, b = 1.0 + 0.1 * randn(E), 0.1 * randn(E)
    y = fused_norm.fused_layer_norm(x, w, b, 1e-12)
    err = max_err(y, fused_norm.fused_layer_norm_plain(x, w, b, 1e-12))
    check('layer norm', err, TOL)
    b_ms, b_by = bound(8.0 * N * E, 4.0 * (2 * N * E + 2 * E))
    rows['layer_norm_fwd'] = {
        'max_abs_err': err,
        'ms': time_ms(lambda: fused_norm.fused_layer_norm(x, w, b, 1e-12),
                      flush),
        'plain_ms': time_ms(lambda: fused_norm.fused_layer_norm_plain(
            x, w, b, 1e-12), flush),
        'library_ms': time_ms(lambda: torch.nn.functional.layer_norm(
            x, (E,), w, b, 1e-12), flush),
        'bound_ms': b_ms, 'bound_by': b_by, 'shape': [N, E]}

    y = fused_dropout_norm.fused_dropout_add_layer_norm(x, res, w, b)
    err = max_err(y, fused_dropout_norm.fused_dropout_add_layer_norm_plain(
        x, res, w, b))
    check('add + layer norm', err, TOL)
    b_ms, b_by = bound(9.0 * N * E, 4.0 * (3 * N * E + 2 * E))
    rows['add_layer_norm_fwd'] = {
        'max_abs_err': err,
        'ms': time_ms(lambda: fused_dropout_norm.fused_dropout_add_layer_norm(
            x, res, w, b), flush),
        'plain_ms': time_ms(
            lambda: fused_dropout_norm.fused_dropout_add_layer_norm_plain(
                x, res, w, b), flush),
        'library_ms': None,        # no single PyTorch call adds and norms
        'bound_ms': b_ms, 'bound_by': b_by, 'shape': [N, E]}
    # the rows are printed once the train step's shapes are in them
    phase_train_kernels(randn, gen, flush, rows)
    return rows


def _key_bias(batch, length, dev, gen):
    """BERT's (1 - mask) * -1e4 for real lengths in [L/8, L]."""
    lengths = torch.randint(length // 8, length + 1, (batch,), device=dev,
                            generator=gen)
    bias = torch.where(
        torch.arange(length, device=dev)[None, :] < lengths[:, None], 0.0,
        -1e4).to(torch.float32)
    return bias, float(lengths.sum())


def _attention_case(fa, q, k, v, do, causal, kb, p, seed, offset):
    """Forward, dQ and dK/dV kernels against their plain versions on one
    input -> the errors (o and lse absolute, gradients relative)."""
    from paddle_tpu_torch import kernels
    scale = 1.0 / q.shape[-1] ** 0.5
    kw = dict(causal=causal, kpad_bias=kb, dropout_p=p, seed=seed,
              offset=offset)
    o, lse = fa.flash_attention_forward(q, k, v, **kw)
    delta = (do * o).sum(-1)
    rest = (lse, delta, causal, scale, kb, p, seed, offset)
    dq = fa.flash_attention_dq(q, k, v, do, *rest)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, *rest)
    torch.cuda.synchronize()
    with kernels.plain_versions():
        ro, rlse = fa.flash_attention_forward(q, k, v, **kw)
        # the plain backward starts from the kernel's own (lse, delta), as
        # the kernels do
        rdq = fa.flash_attention_dq(q, k, v, do, *rest)
        rdk, rdv = fa.flash_attention_dkv(q, k, v, do, *rest)
    errs = {'o': max(max_err(o, ro), max_err(lse, rlse)),
            'dq': rel_err(dq, rdq), 'dk': rel_err(dk, rdk),
            'dv': rel_err(dv, rdv)}
    for t in (o, dq, dk, dv):
        if not torch.isfinite(t).all():
            raise AssertionError("attention kernels: non-finite output")
    return errs


def _attention_ms(fa, q, k, v, do, bias, p, seed, flush):
    """Median ms of the forward (o and lse out, as training runs it), dQ
    and dK/dV on one non-causal input."""
    drop = (p, seed, 3) if p else ()
    o, lse = fa.flash_attention_forward(q, k, v, False, None, bias, *drop)
    rest = (lse, (do * o).sum(-1), False, 1.0 / q.shape[-1] ** 0.5, bias,
            *drop)
    return {'fwd': time_ms(lambda: fa.flash_attention_forward(
                q, k, v, False, None, bias, *drop), flush),
            'dq': time_ms(lambda: fa.flash_attention_dq(q, k, v, do, *rest),
                          flush),
            'dkv': time_ms(lambda: fa.flash_attention_dkv(q, k, v, do, *rest),
                           flush)}


def phase_train_kernels(randn, gen, flush, rows):
    """The kernels the train step adds (dQ, dK/dV, the dropout-mask
    gradient) and the dropout branches of the two forward kernels, at the
    train step's shapes and at the awkward ones."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_dropout_norm as fdn
    from paddle_tpu_torch.kernels import fused_norm, philox
    dev = torch.device('cuda', 0)
    F = torch.nn.functional
    P, SEED = 0.1, 0x1234567890ABCDEF

    # -- the Philox mask itself, bit for bit, and its keep rate ----------
    n = 4 * 2 ** 20 + 3           # not a multiple of 4: the tail path too
    mask = fdn.dropout_grad(torch.ones(n, device=dev), P, SEED, 7)
    want = philox.keep_scale((n,), P, SEED, 7, dev)
    torch.cuda.synchronize()
    keep_rate = float((mask > 0).double().mean())
    if not torch.equal(mask, want):
        raise AssertionError("dropout mask: the kernel's bits differ from "
                             "kernels/philox.py")
    if abs(keep_rate - (1 - P)) > 0.002:
        raise AssertionError(f"dropout mask: keep rate {keep_rate}")
    emit({'phase': 'philox', 'elements': n, 'p': P, 'bit_exact': True,
          'keep_rate': keep_rate, 'allowed': [1 - P - 0.002, 1 - P + 0.002]})

    # -- attention as the train step feeds it: no mask (every key counts),
    # q, k, v and dO seen through transpose(1, 2) of (B, L, H, D) tensors,
    # as the projections and the output's reshape leave them; the same
    # shape with a key bias, contiguous, is an extra case ----------------
    B, H, L, D = TRAIN_BATCH, 16, SEQ, 64
    shape = (B, H, L, D)
    q, k, v, do = (randn(B, L, H, D).transpose(1, 2) for _ in range(4))
    qb, kb_, vb, dob = (randn(*shape) for _ in range(4))
    bias, keys = _key_bias(B, L, dev, gen)
    errs = {p: _attention_case(fa, q, k, v, do, False, None, p, SEED, 3)
            for p in (0.0, P)}
    cases = [{'shape': list(shape), 'causal': False, 'bias': True,
              'empty_row': False, 'p': p,
              **_attention_case(fa, qb, kb_, vb, dob, False, bias, p, SEED, 3)}
             for p in (0.0, P)]
    # causal at full size; ragged L with the head dim padded to 64 and one
    # batch row whose every key is -inf; head dim 128
    for causal, shp, neg_row in ((True, shape, False),
                                 (False, (2, 3, 300, 40), True),
                                 (True, (1, 2, 77, 128), False)):
        b_, _, l_, d_ = shp
        qq, kk, vv, dd = (randn(*shp) for _ in range(4))
        kb = None
        if not causal or d_ == 128:
            kb = torch.where(torch.rand(b_, l_, device=dev, generator=gen)
                             < 0.2, -1e4, 0.0).to(torch.float32)
            if neg_row:
                kb[1] = float('-inf')
        for p in (0.0, P):
            e = _attention_case(fa, qq, kk, vv, dd, causal, kb, p, SEED, 11)
            cases.append({'shape': list(shp), 'causal': causal,
                          'bias': kb is not None, 'empty_row': neg_row,
                          'p': p, **e})
    for case in [dict(errs[0.0], p=0.0, shape=list(shape)),
                 dict(errs[P], p=P, shape=list(shape))] + cases:
        check(f"flash forward {case['shape']} p={case['p']}", case['o'], TOL)
        for g in ('dq', 'dk', 'dv'):
            check(f"flash {g} {case['shape']} p={case['p']}", case[g],
                  GRAD_TOL)

    ms = {p: _attention_ms(fa, q, k, v, do, None, p, SEED, flush)
          for p in (0.0, P)}
    ms_bias = _attention_ms(fa, qb, kb_, vb, dob, bias, P, SEED, flush)
    with kernels.plain_versions():
        plain = _attention_ms(fa, q, k, v, do, None, P, SEED, flush)
    # one library call for dQ, dK and dV together: the backward of SDPA
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        ol, (ql, kl, vl), do, retain_graph=True), flush)
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                       flush)
    del ol, ql, kl, vl
    # the work: without a mask every key of every row; each of q, k, v, dO
    # read once, each output written once, lse and delta (B, H, L) each.
    # With the bias only the unmasked keys count, as for the serving row:
    # k and v at the unmasked rows
    n_qd = 4.0 * B * H * L * D
    side = 4.0 * B * H * L
    all_keys = float(B * L)
    kv_bytes = 4.0 * 2 * H * D * keys

    def bounds(flops_per_key, whole, extra):
        """(bound of the unmasked input, bound of the biased one)."""
        return (bound(flops_per_key * H * L * D * all_keys,
                      (whole + 2) * n_qd + extra),
                bound(flops_per_key * H * L * D * keys,
                      whole * n_qd + kv_bytes + extra + 4.0 * B * L))
    (b_ms, b_by), biased = bounds(4.0, 2, side)         # q, o; lse
    rows['flash_attention_fwd'].update({
        'train': {'shape': list(shape), 'layout': '(B, L, H, D) seen '
                  'through transpose(1, 2)', 'bias': False,
                  'ms_p0': ms[0.0]['fwd'], 'ms_p0.1': ms[P]['fwd'],
                  'dropout_ratio': ms[P]['fwd'] / ms[0.0]['fwd'],
                  'plain_ms_p0.1': plain['fwd'], 'library_ms_p0': sdpa_fwd,
                  'bound_ms': b_ms, 'bound_by': b_by,
                  'max_abs_err_p0.1': errs[P]['o'],
                  'with_key_bias': {'unmasked_keys': keys,
                                    'ms_p0.1': ms_bias['fwd'],
                                    'bound_ms': biased[0],
                                    'bound_by': biased[1]},
                  'cases': cases}})
    library = ('SDPA backward (dQ, dK, dV together) through '
               'torch.autograd.grad, p = 0')
    for name, kind, grads, flops_per_key, whole in (
            ('flash_attention_dq', 'dq', ('dq',), 6.0, 3),     # q, dO, dq
            ('flash_attention_dkv', 'dkv', ('dk', 'dv'), 8.0, 4)):
        (b_ms, b_by), biased = bounds(flops_per_key, whole, 2 * side)
        rows[name] = {
            'max_abs_err': max(errs[p][g] for p in (0.0, P) for g in grads),
            'ms': ms[P][kind], 'ms_p0': ms[0.0][kind],
            'plain_ms': plain[kind], 'library_ms': sdpa_bwd,
            'library': library, 'bound_ms': b_ms, 'bound_by': b_by,
            'shape': list(shape), 'layout': '(B, L, H, D) seen through '
            'transpose(1, 2)', 'bias': False,
            'with_key_bias': {'unmasked_keys': keys, 'ms': ms_bias[kind],
                              'bound_ms': biased[0], 'bound_by': biased[1]}}
    emit_kernel('flash_attention_fwd', rows)
    emit_kernel('flash_attention_dq', rows, tolerance=GRAD_TOL,
                error_is='relative to the max abs gradient')
    emit_kernel('flash_attention_dkv', rows, tolerance=GRAD_TOL,
                error_is='relative to the max abs gradient')
    del q, k, v, do, qb, kb_, vb, dob

    # -- dropout + add + LayerNorm in training, and the mask gradient ----
    N, E = TRAIN_BATCH * SEQ, 1024
    x, res, g = randn(N, E), randn(N, E), randn(N, E)
    w, b = 1.0 + 0.1 * randn(E), 0.1 * randn(E)
    # LayerNorm as the train step launches it, twice a step: y, mean and
    # rstd out, eps 1e-12, on the embeddings and on the MLM head's rows
    ln_train = {}
    for lead in ((TRAIN_BATCH, SEQ), (TRAIN_BATCH, SEQ * 15 // 100)):
        xs = randn(*lead, E)
        out = fused_norm._forward(xs, w, b, 1e-12, True)
        with kernels.plain_versions():
            ref = fused_norm._forward(xs, w, b, 1e-12, True)
            ln_plain = time_ms(lambda: fused_norm._forward(
                xs, w, b, 1e-12, True), flush)
        torch.cuda.synchronize()
        err = max(max_err(a, c) for a, c in zip(out, ref))
        check(f'layer norm {(*lead, E)}: y, mean, rstd', err, TOL)
        n_ = lead[0] * lead[1]
        b_ms, b_by = bound(8.0 * n_ * E, 4.0 * (2 * n_ * E + 2 * E + 2 * n_))
        ln_train[str((*lead, E))] = {
            'max_abs_err': err, 'ms': time_ms(lambda: fused_norm._forward(
                xs, w, b, 1e-12, True), flush), 'plain_ms': ln_plain,
            'library_ms': time_ms(lambda: torch.native_layer_norm(
                xs, (E,), w, b, 1e-12), flush),
            'bound_ms': b_ms, 'bound_by': b_by}
    rows['layer_norm_fwd']['train'] = {'outputs': 'y, mean, rstd',
                                       **ln_train}
    rows['layer_norm_fwd']['max_abs_err'] = max(
        [rows['layer_norm_fwd']['max_abs_err']]
        + [r['max_abs_err'] for r in ln_train.values()])
    emit_kernel('layer_norm_fwd', rows)
    ln_errs = {}
    for n_, e_, p in ((N, E, P), (N, E, 0.0), (37, 1023, 0.25)):
        xs, rs_ = randn(n_, e_), randn(n_, e_)
        ws, bs = randn(e_), randn(e_)
        out = fdn._forward(xs, rs_, ws, bs, p, 1e-5, SEED, 5, True)
        with kernels.plain_versions():
            ref = fdn._forward(xs, rs_, ws, bs, p, 1e-5, SEED, 5, True)
        torch.cuda.synchronize()
        err = max(max_err(a, c) for a, c in zip(out, ref))
        check(f'dropout + add + layer norm ({n_}, {e_}) p={p}: y, yin, '
              f'mean, rstd', err, TOL)
        ln_errs[f'({n_}, {e_}) p={p}'] = err
    train_ms = {p: time_ms(lambda p=p: fdn._forward(
        x, res, w, b, p, 1e-5, SEED, 5, True), flush) for p in (0.0, P)}
    with kernels.plain_versions():
        train_plain = time_ms(lambda: fdn._forward(
            x, res, w, b, P, 1e-5, SEED, 5, True), flush)
    # training writes yin, mean and rstd too
    b_ms, b_by = bound(9.0 * N * E, 4.0 * (4 * N * E + 2 * E + 2 * N))
    rows['add_layer_norm_fwd'].update({
        'train': {'shape': [N, E], 'outputs': 'y, yin, mean, rstd',
                  'ms_p0': train_ms[0.0], 'ms_p0.1': train_ms[P],
                  'plain_ms_p0.1': train_plain, 'bound_ms': b_ms,
                  'bound_by': b_by, 'max_abs_err': ln_errs}})
    emit_kernel('add_layer_norm_fwd', rows)

    dx = fdn.dropout_grad(g, P, SEED, 5)
    with kernels.plain_versions():
        rdx = fdn.dropout_grad(g, P, SEED, 5)
    err = max_err(dx, rdx)
    check('dropout mask gradient', err, TOL)
    stored = philox.keep_scale(g.shape, P, SEED, 5, dev)
    with kernels.plain_versions():
        grad_plain = time_ms(lambda: fdn.dropout_grad(g, P, SEED, 5), flush)
    b_ms, b_by = bound(1.0 * N * E, 4.0 * 2 * N * E)
    rows['dropout_grad'] = {
        'max_abs_err': err,
        'ms': time_ms(lambda: fdn.dropout_grad(g, P, SEED, 5), flush),
        'plain_ms': grad_plain,
        'library_ms': time_ms(lambda: g * stored, flush),
        'library': 'multiply by a stored (N, D) fp32 mask',
        'bound_ms': b_ms, 'bound_by': b_by, 'shape': [N, E]}
    emit_kernel('dropout_grad', rows, mask_bit_exact=True,
                keep_rate=keep_rate)


def _requests(rs, n, vocab):
    """``n`` requests with real lengths in [32, SEQ], zero-padded to SEQ."""
    out = []
    for length in rs.randint(32, SEQ + 1, size=n):
        ids = np.zeros(SEQ, np.int32)
        ids[:length] = rs.randint(1, vocab, size=length)
        mask = np.zeros(SEQ, np.int32)
        mask[:length] = 1
        out.append({'input_ids': ids, 'attention_mask': mask})
    return out


def _example():
    return {'input_ids': np.zeros(SEQ, np.int32),
            'attention_mask': np.zeros(SEQ, np.int32)}


def phase_parity(seed):
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.text.bert import BertModel, bert_large
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cfg = bert_large()
    cfg.num_hidden_layers = 2
    model = BertModel(cfg, device=dev, generator=gen)
    cpu_model = copy.deepcopy(model).to('cpu').eval()
    eng = ServingEngine(device=dev)
    ep = eng.register('bert2', layer=model, example=_example())
    reqs = _requests(np.random.RandomState(seed), 4, cfg.vocab_size)
    futs = [ep.submit(r) for r in reqs]
    eng.run_until_idle()
    resps = [f.result(timeout=600) for f in futs]
    with torch.inference_mode():
        seq, pooled = cpu_model(
            torch.from_numpy(np.stack([r['input_ids'] for r in reqs])),
            attention_mask=torch.from_numpy(
                np.stack([r['attention_mask'] for r in reqs])))
    errs = []
    for i, resp in enumerate(resps):
        if not resp.ok:
            raise AssertionError(f"parity request {i}: {resp.status}")
        errs.append(max(float(np.abs(resp.outputs[0] - seq[i].numpy()).max()),
                        float(np.abs(resp.outputs[1] - pooled[i].numpy()
                                     ).max())))
    check('2-layer BERT-large, GPU engine vs CPU', max(errs), MODEL_TOL)
    emit({'phase': 'parity', 'layers': 2, 'hidden': cfg.hidden_size,
          'requests': len(reqs), 'tolerance': MODEL_TOL,
          'max_abs_err': max(errs), 'per_request_err': errs})


def phase_serve(seed, card):
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import (DEFAULT_BATCH_BUCKETS,
                                          ServingEngine, select_bucket)
    from paddle_tpu_torch.text.bert import BertModel, bert_large
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    cfg = bert_large()
    t0 = time.perf_counter()
    model = BertModel(cfg, device=dev, generator=gen)
    eng = ServingEngine(queue_capacity=64, device=dev)
    ep = eng.register('bert', layer=model, example=_example())
    warm = eng.warmup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # waves of 1, 3 (bucket 4, one padding row), 13 and 16 (bucket 16)
    waves = [1] * 10 + [3] * 6 + [13] * 2 + [16] * 2
    reqs = _requests(np.random.RandomState(seed), sum(waves), cfg.vocab_size)
    kernels.reset_launch_counts()              # the main path starts here
    batch_ms = {}
    served = []
    t_serve = time.perf_counter()
    at = 0
    for n in waves:
        futs = [ep.submit(r) for r in reqs[at:at + n]]
        at += n
        eng.run_until_idle()
        resps = [f.result(timeout=600) for f in futs]
        batch_ms.setdefault(select_bucket(n, DEFAULT_BATCH_BUCKETS),
                            []).append(resps[0].breakdown['run'])
        served += resps
    serve_s = time.perf_counter() - t_serve
    eng.start()
    try:
        threaded = ep.predict(reqs[-1], timeout=600)
    finally:
        eng.stop()
    counts = kernels.launch_counts()           # ... and ends here
    batches = eng.stats()['models']['bert']['batches']

    for i, resp in enumerate(served + [threaded]):
        if not resp.ok:
            raise AssertionError(f"request {i}: status {resp.status}")
        seq, pooled = resp.outputs
        if seq.shape != (SEQ, cfg.hidden_size) or \
                pooled.shape != (cfg.hidden_size,):
            raise AssertionError(f"request {i}: shapes {seq.shape} "
                                 f"{pooled.shape}")
        if not (np.isfinite(seq).all() and np.isfinite(pooled).all()):
            raise AssertionError(f"request {i}: non-finite output")
    # serving is forward only, without dropout: the backward kernels and
    # the mask gradient must not run
    want = {**dict.fromkeys(counts, 0), 'layer_norm_fwd': batches,
            'add_layer_norm_fwd': 48 * batches,
            'flash_attention_fwd': 24 * batches}
    if batches != len(waves) + 1 or counts != want:
        raise AssertionError(f"launches {counts} over {batches} batches, "
                             f"expected {want}")
    # the last request of a full bucket-16 batch, served again alone on
    # the worker thread: batch composition does not leak into a result
    drift = float(np.abs(threaded.outputs[0] - served[-1].outputs[0]).max())
    check('bucket-16 vs bucket-1 repeat', drift, MODEL_TOL)
    lat = {str(bk): {'batches': len(v), 'p50_ms': float(np.percentile(v, 50)),
                     'p99_ms': float(np.percentile(v, 99))}
           for bk, v in sorted(batch_ms.items())}
    emit({'phase': 'serve', 'model': 'bert_large', 'layers':
          cfg.num_hidden_layers, 'hidden': cfg.hidden_size, 'seq': SEQ,
          'dtype': 'float32', 'card': card, 'setup_s': setup_s,
          'warmup_buckets': warm['bert'], 'requests': len(served) + 1,
          'batches': batches, 'requests_per_s': sum(waves) / serve_s,
          'batch_latency_ms': lat, 'launches': counts,
          'repeat_drift': drift})
    futs = [ep.submit(r) for r in reqs[:16]]
    phase_profile('serve', eng.run_until_idle, bucket=16)
    for f in futs:
        f.result(timeout=600)
    return counts


def phase_profile(what, run, top_n=12, **extra):
    """Device time by kernel over one call of ``run`` — one bucket-16
    batch, one train step — (torch.profiler's device-side events: kernels
    and copies), and the device's idle share of that call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0_us, t1_us = e.time_range.start, e.time_range.end
        spans.append((t0_us, t1_us))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (t1_us - t0_us) / 1e3, n + 1)
    busy_us, reach = 0.0, None      # union of the device intervals
    for a, b in sorted(spans):
        if reach is None or a > reach:
            busy_us += b - a
            reach = b
        elif b > reach:
            busy_us += b - reach
            reach = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    emit({'phase': 'profile', 'of': what, **extra, 'wall_ms': wall_ms,
          'device_busy_ms': busy_us / 1e3,
          'device_idle_share': (1.0 - busy_us / 1e3 / wall_ms
                                if spans else None),
          'top': [{'ms': ms, 'calls': n, 'name': name[:90]}
                  for name, (ms, n) in top]})


def _pretraining_batch(rs, batch, vocab):
    """The feeds ``bench.py::bench_bert`` makes: ids, token types, 15 % of
    the positions masked, their labels, NSP labels."""
    n_masked = max(SEQ * 15 // 100, 1)
    x = {'input_ids': rs.randint(0, vocab, (batch, SEQ)).astype(np.int64),
         'token_type_ids': np.zeros((batch, SEQ), np.int64),
         'masked_positions': np.stack(
             [rs.choice(SEQ, n_masked, replace=False)
              for _ in range(batch)]).astype(np.int64)}
    y = (rs.randint(0, vocab, (batch, n_masked)).astype(np.int64),
         rs.randint(0, 2, (batch, 1)).astype(np.int64))
    return x, y


def _loss_and_grads(model, x, y, device):
    """One forward and backward of ``pretraining_loss`` -> (loss, {name:
    gradient}), with the model's dropout state rewound to offset 0."""
    model.dropout_state.offset = 0
    feeds = {k: torch.from_numpy(v).to(device) for k, v in x.items()}
    labels = [torch.from_numpy(v).to(device) for v in y]
    loss = model.pretraining_loss(*model(**feeds), *labels)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return (float(loss.detach()),
            {n: g.detach().cpu() for n, g in zip(names, grads)})


def _compare_grads(what, got, want):
    """Worst gradient error relative to its tensor's max abs value. A
    tensor whose true gradient is zero (the key bias: softmax ignores a
    shift of a row's scores) holds rounding noise on both sides, so the
    scale has a floor of 1e-3 of the model's largest gradient entry."""
    top = max(float(g.abs().max()) for g in want.values())
    worst, worst_name = 0.0, None
    for name, ref in want.items():
        scale = max(float(ref.abs().max()), 1e-3 * top)
        err = max_err(got[name], ref) / scale
        if not err <= worst:           # keeps a NaN
            worst, worst_name = err, name
    check(f'{what}: gradient of {worst_name}', worst, GRAD_TOL)
    return worst, worst_name


def phase_train_parity(seed):
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.text.bert import BertForPretraining, bert_large
    dev = torch.device('cuda', 0)
    x, y = _pretraining_batch(np.random.RandomState(seed), 2, 30522)
    out = {'phase': 'train_parity', 'layers': 2, 'batch': [2, SEQ],
           'tolerance': GRAD_TOL}
    for p in (0.0, 0.1):
        cfg = bert_large(hidden_dropout_prob=p,
                         attention_probs_dropout_prob=p)
        cfg.num_hidden_layers = 2
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 2)
        model = BertForPretraining(cfg, device=dev, generator=gen).train()
        kernels.reset_launch_counts()
        loss, grads = _loss_and_grads(model, x, y, dev)
        counts = kernels.launch_counts()
        if p == 0.0:
            # the card's kernel path against the CPU's plain path
            ref_model = copy.deepcopy(model).to('cpu')
            ref_loss, ref_grads = _loss_and_grads(ref_model, x, y, 'cpu')
            other = 'cpu'
        else:
            # same weights, same (seed, offset): kernels against their
            # plain versions, both on the card
            with kernels.plain_versions():
                ref_loss, ref_grads = _loss_and_grads(model, x, y, dev)
            other = 'plain versions on the GPU'
            again, _ = _loss_and_grads(model, x, y, dev)
            if again != loss:
                raise AssertionError(
                    f"train parity: the same step from the same seed and "
                    f"offset gave losses {loss} and {again}")
            out['repeat_loss_identical'] = True
        if kernels.launch_counts() != (counts if p == 0.0 else
                                       {k: 2 * v for k, v in counts.items()}):
            raise AssertionError("train parity: the plain path launched a "
                                 "kernel")
        loss_err = abs(loss - ref_loss) / abs(ref_loss)
        check(f'train parity p={p}: loss', loss_err, GRAD_TOL)
        worst, name = _compare_grads(f'train parity p={p}', grads, ref_grads)
        out[f'p={p}'] = {'against': other, 'loss': loss,
                         'reference_loss': ref_loss, 'loss_rel_err': loss_err,
                         'worst_grad_rel_err': worst, 'worst_grad': name,
                         'gradients': len(grads), 'launches': counts}
        del model
        torch.cuda.empty_cache()
    emit(out)


TRAIN_LAUNCHES = {'flash_attention_fwd': 24, 'flash_attention_dq': 24,
                  'flash_attention_dkv': 24, 'add_layer_norm_fwd': 48,
                  'dropout_grad': 48, 'layer_norm_fwd': 2}


def phase_train(seed, card):
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.engine import build_train_step
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.bert import BertForPretraining, bert_large
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    cfg = bert_large()
    t0 = time.perf_counter()
    model = BertForPretraining(cfg, device=dev, generator=gen).train()
    step = build_train_step(
        net=model, loss=model.pretraining_loss,
        optimizer=AdamW(learning_rate=1e-4, weight_decay=0.01))
    state = step.init_state()
    x, y = _pretraining_batch(np.random.RandomState(seed), TRAIN_BATCH,
                              cfg.vocab_size)
    batch = ({k: torch.from_numpy(v).to(dev) for k, v in x.items()},
             tuple(torch.from_numpy(v).to(dev) for v in y))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # 20 steps, because Adam at lr 1e-4 without a warm-up overshoots on
    # random weights: over seeds 0 to 4 (H100, fp32) the loss rose from 11
    # to 15-20 for 8 to 12 steps, then fell steadily, and was 1.4 to 2.0
    # below the first by step 20; at step 10 it was below it for two seeds
    warmup, timed = 2, 18
    losses, step_ms = [], []
    totals = dict.fromkeys(TRAIN_LAUNCHES, 0)
    torch.cuda.reset_peak_memory_stats()
    for i in range(warmup + timed):
        kernels.reset_launch_counts()          # the main path: one step
        t1 = time.perf_counter()
        state, result = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t1))
        counts = kernels.launch_counts()       # ... read right after it
        if counts != TRAIN_LAUNCHES:
            raise AssertionError(f"train step {i}: launches {counts}, "
                                 f"expected {TRAIN_LAUNCHES}")
        for name, n in counts.items():
            totals[name] += n
        losses.append(float(result.loss))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall: {losses}")
    ms = step_ms[warmup:]
    emit({'phase': 'train', 'model': 'bert_large pretraining', 'layers':
          cfg.num_hidden_layers, 'hidden': cfg.hidden_size,
          'batch': [TRAIN_BATCH, SEQ], 'dtype': 'float32',
          'dropout': cfg.hidden_dropout_prob, 'optimizer':
          'AdamW(lr=1e-4, weight_decay=0.01)', 'card': card,
          'setup_s': setup_s, 'warmup_steps': warmup, 'timed_steps': timed,
          'step_ms': {'median': float(np.median(ms)), 'min': min(ms),
                      'max': max(ms), 'warmup': step_ms[:warmup]},
          'samples_per_s': TRAIN_BATCH / (float(np.median(ms)) / 1e3),
          'max_memory_allocated_bytes': peak, 'losses': losses,
          'launches_per_step': TRAIN_LAUNCHES, 'launches': totals})
    phase_profile('train step', lambda: step(state, batch), top_n=16,
                  batch=[TRAIN_BATCH, SEQ])
    return totals


SOURCES = {
    'flash_attention_fwd': ('paddle_tpu_torch/kernels/csrc/flash_attention.cu',
                            'paddle_tpu/kernels/flash_attention.py:95'),
    'flash_attention_dq': (
        'paddle_tpu_torch/kernels/csrc/flash_attention_bwd.cu',
        'paddle_tpu/kernels/flash_attention.py:208'),
    'flash_attention_dkv': (
        'paddle_tpu_torch/kernels/csrc/flash_attention_bwd.cu',
        'paddle_tpu/kernels/flash_attention.py:265'),
    'dropout_grad': (
        'paddle_tpu_torch/kernels/csrc/fused_dropout_norm.cu',
        'paddle_tpu/kernels/fused_dropout_norm.py:74'),
    'layer_norm_fwd': ('paddle_tpu_torch/kernels/csrc/fused_norm.cu',
                       'paddle_tpu/kernels/fused_norm.py:26'),
    'add_layer_norm_fwd': (
        'paddle_tpu_torch/kernels/csrc/fused_dropout_norm.cu',
        'paddle_tpu/kernels/fused_dropout_norm.py:41'),
}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's GPU path cannot run "
              "here", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = phase_card()
    phase_build()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                        device='cuda')   # 256 MB, five times the L2
    rows = phase_kernels(args.seed, flush)
    del flush
    phase_parity(args.seed)
    served = phase_serve(args.seed, card)
    torch.cuda.empty_cache()
    phase_train_parity(args.seed)
    trained = phase_train(args.seed, card)
    # launches: the two main paths' counts, each zeroed just before its
    # path and read just after (serving: 21 batches; training: 20 steps)
    emit({'kernels': [
        {'name': name, 'route': 'cuda', 'source': SOURCES[name][0],
         'replaces': SOURCES[name][1],
         'launches': served[name] + trained[name],
         'launches_serve': served[name], 'launches_train': trained[name],
         'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
         'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
         'bound_by': r['bound_by'], 'library_ms': r['library_ms']}
        for name, r in rows.items()]})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
