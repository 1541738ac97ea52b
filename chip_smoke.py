#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:

1. card   — the GPU's name and power limit (nvidia-smi), versions;
2. build  — compile the port's CUDA kernels from ``paddle_tpu_torch/
   kernels/csrc`` with nvcc for sm_90a (set-up time);
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes BERT-large serving gives it (fp32), with its time, the plain
   version's, one PyTorch library call's as a yardstick, and the bound;
4. parity — a full-width, 2-layer BERT served through ``ServingEngine`` on
   the GPU against the same weights run on the CPU (plain path);
5. serve  — BERT-large (24 layers, hidden 1024, seq 512) served through
   ``ServingEngine`` in batches landing in buckets 1, 4 and 16, plus one
   request through the worker thread; the kernel launch counts of this
   run must be exactly 1 LayerNorm, 48 add+LayerNorm and 24 flash
   attention launches per batch;
6. profile — device time by kernel over one more bucket-16 batch.

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
SEQ = 512
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


def emit_kernel(name, rows, **extra):
    """One kernel's phase line; ``phase_launches`` counts this phase's
    own launches (checks and timing), not the main path's."""
    from paddle_tpu_torch import kernels
    row = dict(rows[name])
    emit({'phase': 'kernel', 'name': name, 'tolerance': TOL,
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
        'bytes': nbytes, 'flops_all_keys': 4.0 * B * H * L * L * D}
    emit_kernel('flash_attention_fwd', rows, extra_cases=cases)

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
    emit_kernel('layer_norm_fwd', rows)

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
    emit_kernel('add_layer_norm_fwd', rows)
    return rows


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
    want = {'layer_norm_fwd': batches, 'add_layer_norm_fwd': 48 * batches,
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
    phase_profile(eng, ep, reqs[:16])
    return counts


def phase_profile(eng, ep, reqs):
    """Device time by kernel over one bucket-16 batch (torch.profiler's
    device-side events: kernels and copies), and the device's idle share
    of that batch's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    futs = [ep.submit(r) for r in reqs]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    for f in futs:
        f.result(timeout=600)
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit({'phase': 'profile', 'bucket': len(reqs), 'wall_ms': wall_ms,
          'device_busy_ms': busy_us / 1e3,
          'device_idle_share': (1.0 - busy_us / 1e3 / wall_ms
                                if spans else None),
          'top': [{'ms': ms, 'calls': n, 'name': name[:90]}
                  for name, (ms, n) in top]})


SOURCES = {
    'flash_attention_fwd': ('paddle_tpu_torch/kernels/csrc/flash_attention.cu',
                            'paddle_tpu/kernels/flash_attention.py:95'),
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
    counts = phase_serve(args.seed, card)
    emit({'kernels': [
        {'name': name, 'route': 'cuda', 'source': SOURCES[name][0],
         'replaces': SOURCES[name][1], 'launches': counts[name],
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
