"""The port's generative serving engine against the JAX package's, on the
CPU: the same ``TinyCausalLM`` (the reference's numpy draws from one seed),
the same requests, the same ``register`` arguments, token for token.

The cases mirror ``tests/test_paged_serving.py``: interleaved traffic on
the paged and the slot cache, page reuse, chunked prefill, prefix hits,
drafts that accept all, reject all or diverge (and k = 1), speculation
across preemption, pressure preemption, the never-fits failure, the
oversize prompt rejected at submit, ``register``'s validation, ``stop``
and deadline partials, shed attribution and model-error containment.
Where the reference engine counts something the tokens depend on
(prefill tokens, prefix hits, proposals, acceptance, preemptions), the
port's count is held equal to it. Everything runs in manual-pump mode.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import serving as rserving
from paddle_tpu.serving import paged_kv as rpk

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.serving import paged_kv as tpk
from paddle_tpu_torch.serving.scheduler import (STATUS_DEADLINE,
                                                STATUS_ERROR)


@pytest.fixture(autouse=True, scope='module')
def _xla_compile_cache(tmp_path_factory):
    """In-module compile dedup for the JAX engines, as
    ``tests/test_paged_serving.py`` does: engines over the same seed-0
    model compile identical programs, so a module-local compilation cache
    turns each repeat into a load. The directory is a fresh tmp path."""
    d = str(tmp_path_factory.mktemp('xla_cache'))
    jax.config.update('jax_compilation_cache_dir', d)
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.0)
    yield
    jax.config.update('jax_compilation_cache_dir', None)


def _lm(side, seed=0, **kw):
    kw.setdefault('vocab', 32)
    kw.setdefault('embed', 16)
    kw.setdefault('num_heads', 2)
    kw.setdefault('max_batch', 4)
    kw.setdefault('max_seq', 32)
    kw.setdefault('prompt_buckets', (4, 8))
    if side is tserving:
        kw['device'] = 'cpu'
    return side.TinyCausalLM.random(seed=seed, **kw)


def _engine(side, **kw):
    if side is tserving:
        kw['device'] = 'cpu'
    return side.ServingEngine(**kw)


def _tokens(resp):
    return [int(t) for t in resp.outputs['tokens']]


class _JaxConstDraft(rserving.GenerativeSpec):
    """Draft proposing one constant token (the reference test's): a token
    the target never emits rejects every speculation."""

    def __init__(self, token, vocab, max_seq=32, max_batch=4,
                 prompt_buckets=(4, 8)):
        self.token, self.vocab = int(token), int(vocab)
        self.max_seq, self.max_batch = int(max_seq), int(max_batch)
        self.prompt_buckets = tuple(prompt_buckets)

    def init_paged_cache(self, num_pages, page_size):
        return rpk.create_paged_cache(1, num_pages, page_size, 1, 1)

    def _logits(self, prefix):
        return jnp.zeros(prefix + (self.vocab,)).at[..., self.token].set(1.0)

    def prefill_chunk(self, cache, block_row, tokens, start, length):
        return cache, self._logits((tokens.shape[0],))

    def verify_tokens(self, cache, block_tables, tokens, positions):
        return cache, self._logits(tuple(tokens.shape))


class _TorchConstDraft(tserving.GenerativeSpec):
    device = torch.device('cpu')

    def __init__(self, token, vocab, max_seq=32, max_batch=4,
                 prompt_buckets=(4, 8)):
        self.token, self.vocab = int(token), int(vocab)
        self.max_seq, self.max_batch = int(max_seq), int(max_batch)
        self.prompt_buckets = tuple(prompt_buckets)

    def init_paged_cache(self, num_pages, page_size):
        return tpk.create_paged_cache(1, num_pages, page_size, 1, 1,
                                      device='cpu')

    def _logits(self, prefix):
        z = torch.zeros(prefix + (self.vocab,))
        z[..., self.token] = 1.0
        return z

    def prefill_chunk(self, cache, block_row, tokens, start, length):
        return cache, self._logits((tokens.shape[0],))

    def verify_tokens(self, cache, block_tables, tokens, positions):
        return cache, self._logits(tuple(tokens.shape))


def _serve(side, prompts, lens, lm=None, eng_kw=None, draft=None, **reg):
    lm = lm(side) if callable(lm) else _lm(side)
    eng = _engine(side, **(eng_kw or {}))
    if draft is not None:
        reg['draft'] = draft(side)
    ep = eng.register('lm', generative=lm, **reg)
    futs = [ep.submit({'tokens': p}, max_new_tokens=n)
            for p, n in zip(prompts, lens)]
    eng.run_until_idle()
    return eng, [f.result(10) for f in futs], lm


SPEC_KEYS = ('prefill_tokens', 'decode_tokens', 'prefix_hit_pages',
             'spec_proposed', 'spec_accepted', 'preemptions', 'completed')


def _both(prompts, lens, **kw):
    """Serve on both engines -> the port's (engine, responses, lm), after
    holding its tokens and counts to the reference's."""
    jeng, jres, _ = _serve(rserving, prompts, lens, **kw)
    teng, tres, lm = _serve(tserving, prompts, lens, **kw)
    assert [_tokens(r) for r in tres] == [_tokens(r) for r in jres]
    assert [r.status for r in tres] == [r.status for r in jres]
    jst, tst = jeng.stats()['models']['lm'], teng.stats()['models']['lm']
    for k in SPEC_KEYS:
        if k in jst:
            assert tst[k] == jst[k], (k, tst[k], jst[k])
    return teng, tres, lm


def _ref(lm, prompt, n):
    return [int(t) for t in lm.reference_decode(prompt, n)]


PROMPTS = [np.array([1, 2, 3], np.int32), np.array([5, 6], np.int32),
           np.array([7, 8, 9, 10, 11], np.int32), np.array([4], np.int32)]


# ---------------------------------------------------------------------------
# token-exactness: paged, slot, page reuse, chunked prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reg", [dict(page_size=4), dict(kv_cache='slot')],
                         ids=['paged', 'slot'])
def test_interleaved_traffic_matches_reference_engine(reg):
    lens = (6, 3, 4, 8)                 # mixed: forces join/leave churn
    _, res, lm = _both(PROMPTS, lens, lm=lambda s: _lm(s, max_batch=2),
                       **reg)
    assert all(r.ok for r in res)
    for p, n, r in zip(PROMPTS, lens, res):
        assert _tokens(r) == _ref(lm, p, n)


def test_page_reuse_after_free_stays_exact():
    def waves(side):
        lm = _lm(side, max_batch=2, max_seq=16)
        eng = _engine(side)
        ep = eng.register('lm', generative=lm, page_size=4, num_pages=9,
                          prefix_cache=False)
        out = []
        for wave in range(3):
            futs = [ep.submit({'tokens': np.array(p, np.int32)},
                              max_new_tokens=4)
                    for p in ([1 + wave, 2, 3], [6 + wave, 7])]
            eng.run_until_idle()
            out += [_tokens(f.result(10)) for f in futs]
        return eng, out
    _, want = waves(rserving)
    eng, got = waves(tserving)
    assert got == want
    alloc = eng._models['lm'].target.alloc
    # pages actually cycled: more allocations than the pool holds
    assert alloc.allocated_total > alloc.usable and alloc.freed_total > 0


def test_chunked_prefill_long_prompt_exact_and_interleaved():
    long_p = np.arange(1, 25, dtype=np.int32)      # 24 > bucket 8
    short_p = np.array([3, 1], np.int32)
    lm_kw = dict(max_batch=2, max_seq=64)
    _both([long_p, short_p], (4, 2), lm=lambda s: _lm(s, **lm_kw),
          page_size=4)
    lm = _lm(tserving, **lm_kw)
    eng = _engine(tserving)
    ep = eng.register('lm', generative=lm, page_size=4)
    f_long = ep.submit({'tokens': long_p}, max_new_tokens=4)
    f_short = ep.submit({'tokens': short_p}, max_new_tokens=2)
    eng.pump()
    runner = eng._models['lm']
    # the short request decodes WHILE the long one is still prefilling
    assert any(s is not None and not s['ready'] for s in runner.slots)
    eng.run_until_idle()
    assert _tokens(f_long.result(10)) == _ref(lm, long_p, 4)
    steps = {(ev, rid): step for ev, rid, step in runner.journal}
    assert steps[('leave', f_short.request_id)] <= \
        steps[('leave', f_long.request_id)]


# ---------------------------------------------------------------------------
# prefix caching
# ---------------------------------------------------------------------------

def test_prefix_hits_skip_recompute_and_match_reference():
    sys_prompt = np.arange(1, 17, dtype=np.int32)  # 4 full pages @ ps=4
    prompts = [np.concatenate([sys_prompt, np.array([20 + i], np.int32)])
               for i in range(6)]
    lm_kw = dict(max_seq=64, prompt_buckets=(4, 8, 16))
    on, res_on, lm = _both(prompts, (3,) * 6, lm=lambda s: _lm(s, **lm_kw),
                           page_size=4, prefix_cache=True)
    off, res_off, _ = _serve(tserving, prompts, (3,) * 6,
                             lm=lambda s: _lm(s, **lm_kw), page_size=4,
                             prefix_cache=False)
    assert [_tokens(r) for r in res_on] == [_tokens(r) for r in res_off]
    st_on = on.stats()['models']['lm']
    st_off = off.stats()['models']['lm']
    assert st_on['prefill_tokens'] < st_off['prefill_tokens']
    assert st_on['prefix_hit_pages'] >= 4 * 5
    assert on.stats()['kv']['lm']['prefix_hit_rate'] > 0.5
    assert _tokens(res_on[5]) == _ref(lm, prompts[5], 3)


def test_cached_prefix_survives_owner_finishing():
    lm = _lm(tserving, max_batch=2, max_seq=64)
    eng = _engine(tserving)
    ep = eng.register('lm', generative=lm, page_size=4)
    shared = np.arange(1, 9, dtype=np.int32)       # 2 full pages
    eng.start()                    # the owner runs on the worker thread
    assert ep.predict({'tokens': shared}, max_new_tokens=2, timeout=10).ok
    eng.stop()
    before = eng.stats()['models']['lm']['prefill_tokens']
    f2 = ep.submit({'tokens': shared}, max_new_tokens=2)
    eng.run_until_idle()
    assert _tokens(f2.result(10)) == _ref(lm, shared, 2)
    # only the recomputed last page was prefilled, not the cached ones
    assert eng.stats()['models']['lm']['prefill_tokens'] - before <= 4


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------

def _const_draft(side):
    lm = _lm(tserving)               # the same weights on both sides
    ref = _ref(lm, PROMPTS[0], 8)
    bad = next(t for t in range(lm.vocab) if t not in ref)
    cls = _TorchConstDraft if side is tserving else _JaxConstDraft
    return cls(bad, lm.vocab)


@pytest.mark.parametrize("case", ['accept_all', 'reject_all', 'divergent',
                                  'k1'])
def test_speculative_decoding_matches_reference(case):
    prompts, lens, k = PROMPTS[:3], (8, 6, 9), 3
    if case == 'accept_all':
        draft = _lm
    elif case == 'k1':
        draft, k = _lm, 1
    elif case == 'divergent':
        draft = lambda s: _lm(s, seed=7)                  # noqa: E731
    else:
        draft, prompts, lens = _const_draft, PROMPTS[:1], (8,)
    eng, res, lm = _both(prompts, lens, page_size=4, draft=draft, draft_k=k)
    for p, n, r in zip(prompts, lens, res):
        assert _tokens(r) == _ref(lm, p, n)
    st = eng.stats()['models']['lm']
    assert st['spec_proposed'] > 0
    if case in ('accept_all', 'k1'):
        assert st['draft_acceptance'] == 1.0
    elif case == 'reject_all':
        # one target token per round (token 1 of 8 comes from prefill)
        assert st['draft_acceptance'] == 0.0 and st['decode_tokens'] == 7
    else:
        assert st['batches'] < st['decode_tokens']


def test_speculation_stays_exact_across_preemption():
    prompts = [np.array([1 + i, 2, 3, 4, 5, 6], np.int32) for i in range(4)]
    eng, res, lm = _both(prompts, (10,) * 4, eng_kw=dict(queue_capacity=8),
                         page_size=4, num_pages=9, max_concurrency=4,
                         prefix_cache=False, draft=lambda s: _lm(s, seed=7),
                         draft_k=3)
    st = eng.stats()['models']['lm']
    assert st['preemptions'] + st['decode_stalls'] > 0     # pressure real
    for p, r in zip(prompts, res):
        assert r.ok and _tokens(r) == _ref(lm, p, 10)


# ---------------------------------------------------------------------------
# page exhaustion
# ---------------------------------------------------------------------------

def test_pressure_preempts_and_completes_exactly():
    prompts = [np.array([1 + i, 2, 3, 4, 5], np.int32) for i in range(4)]
    eng, res, lm = _both(prompts, (8,) * 4, eng_kw=dict(queue_capacity=8),
                         page_size=4, num_pages=7, max_concurrency=4,
                         prefix_cache=False)
    assert all(r.ok for r in res)
    st = eng.stats()['models']['lm']
    assert st['decode_stalls'] + st['preemptions'] > 0
    assert eng.stats()['kv']['lm']['peak_pages_used'] == 6


@pytest.mark.parametrize("side", [rserving, tserving], ids=['jax', 'port'])
def test_sequence_that_can_never_fit_fails_not_livelocks(side):
    eng = _engine(side)
    ep = eng.register('lm', generative=_lm(side, max_batch=2), page_size=4,
                      num_pages=3, prefix_cache=False)   # 8 positions
    f = ep.submit({'tokens': np.array([1, 2, 3, 4, 5, 6], np.int32)},
                  max_new_tokens=16)                    # needs 22
    eng.run_until_idle(max_steps=200)
    assert f._req.response is not None, "livelocked instead of failing"
    assert f._req.response.status == STATUS_ERROR
    with pytest.raises(RuntimeError, match='more KV pages'):
        f.result(10)


@pytest.mark.parametrize("side", [rserving, tserving], ids=['jax', 'port'])
def test_oversize_prompt_rejected_at_submit(side):
    eng = _engine(side)
    ep = eng.register('lm', generative=_lm(side, max_batch=2), page_size=4,
                      num_pages=3)
    with pytest.raises(ValueError, match='grow'):
        ep.submit({'tokens': np.arange(1, 16, dtype=np.int32)})
    with pytest.raises(ValueError, match='no room to decode'):
        ep.submit({'tokens': np.arange(1, 33, dtype=np.int32)})
    slot = eng.register('slot', generative=_lm(side, max_batch=2),
                        kv_cache='slot')
    with pytest.raises(ValueError, match='largest prompt bucket'):
        slot.submit({'tokens': np.arange(1, 10, dtype=np.int32)})


def test_shed_attribution_distinguishes_pages_from_traffic():
    eng = _engine(tserving, queue_capacity=2)
    ep = eng.register('lm', generative=_lm(tserving, max_batch=2),
                      page_size=4, num_pages=3, max_concurrency=2,
                      prefix_cache=False)
    for i in range(2):
        ep.submit({'tokens': np.array([1 + i, 2, 3, 4, 5, 6, 7, 8],
                                      np.int32)}, max_new_tokens=4)
    eng.pump()
    assert eng.page_starved('lm')
    ep.submit({'tokens': np.array([9, 2, 3], np.int32)})
    with pytest.raises(tserving.QueueFullError) as ei:
        ep.submit({'tokens': np.array([9, 2, 3], np.int32)})
    assert ei.value.reason == 'page_exhaustion'
    ep2 = eng.register('fast', generative=_lm(tserving, seed=2),
                       page_size=4, queue_capacity=1)
    ep2.submit({'tokens': np.array([1], np.int32)})
    with pytest.raises(tserving.QueueFullError) as ei2:
        ep2.submit({'tokens': np.array([2], np.int32)})
    assert ei2.value.reason == 'queue_full'
    st = eng.stats()
    assert (st['shed_page_exhaustion'], st['shed_queue_full']) == (1, 1)


# ---------------------------------------------------------------------------
# registration, warmup, lifecycle
# ---------------------------------------------------------------------------

_BAD_REGISTERS = [
    dict(kv_cache='magnetic-tape'),
    dict(kv_cache='slot', draft=True),
    dict(kv_cache='slot', num_pages=8),
    dict(example={'x': np.zeros((4,), np.float32)}),
    dict(draft=True, draft_k=0),
    dict(draft='short'),
    dict(page_size=0),
]


@pytest.mark.parametrize("kw", _BAD_REGISTERS,
                         ids=lambda kw: '-'.join(sorted(kw)))
def test_register_validation_matches_reference(kw):
    def attempt(side):
        kw2 = dict(kw)
        if kw2.get('draft') is True:
            kw2['draft'] = _lm(side)
        elif kw2.get('draft') == 'short':
            kw2['draft'] = _lm(side, max_seq=16)
        with pytest.raises(Exception) as ei:
            _engine(side).register('m', generative=_lm(side), **kw2)
        return ei.value
    want, got = attempt(rserving), attempt(tserving)
    assert type(got) is type(want) is ValueError
    assert str(got) == str(want)


@pytest.mark.parametrize("side", [rserving, tserving], ids=['jax', 'port'])
def test_paged_knobs_apply_only_to_generative_models(side):
    with pytest.raises(ValueError, match='only to'):
        _engine(side).register('c', predict_fn=lambda f: f['x'],
                               example={'x': np.zeros((4,), np.float32)},
                               num_pages=8)


@pytest.mark.parametrize("kw", [dict(jit_compile=True),
                                dict(artifact_dir='/nonexistent'),
                                dict(program=object()),
                                dict(quantize='int8')],
                         ids=lambda kw: next(iter(kw)))
def test_later_slices_still_raise(kw):
    with pytest.raises(NotImplementedError,
                       match='not ported.*Queue 1 item 7'):
        _engine(tserving).register('m', generative=_lm(tserving), **kw)


def test_warmup_runs_the_whole_program_set():
    # the reference's count (tests/test_paged_serving.py): the per-bucket
    # prefills on both sides, decode, draft decode, propose and verify;
    # the slot runner's per-bucket prefills and decode
    eng = _engine(tserving)
    eng.register('lm', generative=_lm(tserving), page_size=4,
                 draft=_lm(tserving, seed=4), draft_k=2)
    eng.register('slot', generative=_lm(tserving), kv_cache='slot')
    assert eng.warmup() == {'lm': 2 * 2 + 4, 'slot': 2 + 1}
    assert eng._models['lm'].target.alloc.used_count() == 0


def test_stop_evicts_resident_with_partials_and_frees_pages():
    partial = []
    for side in (rserving, tserving):
        eng = _engine(side)
        ep = eng.register('lm', generative=_lm(side, max_batch=2,
                                               prompt_buckets=(4,)),
                          page_size=4)
        f = ep.submit({'tokens': np.array([1, 2], np.int32)},
                      max_new_tokens=64)
        eng.pump()                          # prefill + one decode step
        eng.stop()
        with pytest.raises(RuntimeError, match='mid-decode'):
            f.result(1)
        resp = f._req.response
        assert resp.status == STATUS_ERROR
        partial.append(_tokens(resp))
        assert eng._models['lm'].target.alloc.used_count() == 0
    assert partial[1] == partial[0] and len(partial[1]) >= 1


def test_slot_stop_and_deadline_return_partial_tokens():
    eng = _engine(tserving)
    ep = eng.register('lm', generative=_lm(tserving, max_batch=2),
                      kv_cache='slot')
    f = ep.submit({'tokens': np.array([1, 2], np.int32)}, max_new_tokens=20)
    eng.pump()
    eng.stop()
    assert f._req.response.status == STATUS_ERROR
    assert len(f._req.response.outputs['tokens']) == 2
    eng = _engine(tserving)
    ep = eng.register('lm', generative=_lm(tserving, max_batch=2,
                                           prompt_buckets=(4,)),
                      page_size=4)
    f = ep.submit({'tokens': np.array([1, 2], np.int32)},
                  max_new_tokens=64, deadline_ms=1)
    eng.pump()
    time.sleep(0.01)
    eng.run_until_idle()
    r = f.result(10)
    assert r.status == STATUS_DEADLINE
    assert r.outputs is not None and len(r.outputs['tokens']) >= 1


def test_model_error_containment():
    eng = _engine(tserving)
    ep = eng.register('lm', generative=_lm(tserving, max_batch=2,
                                           prompt_buckets=(4,)),
                      page_size=4)
    runner = eng._models['lm']
    orig_prefill, orig_decode = runner._prefill, runner._decode

    def boom(*a, **kw):
        raise RuntimeError('kaboom')

    runner._prefill = boom
    f = ep.submit({'tokens': np.array([1, 2], np.int32)})
    eng.pump()
    with pytest.raises(RuntimeError, match='kaboom'):
        f.result(5)
    assert runner.slots == [None] * 2
    assert runner.target.alloc.used_count() == 0
    runner._prefill = orig_prefill
    f2 = ep.submit({'tokens': np.array([1, 2], np.int32)}, max_new_tokens=8)
    eng.pump()
    runner._decode = boom
    eng.pump()
    with pytest.raises(RuntimeError, match='kaboom'):
        f2.result(5)
    assert runner.target.alloc.used_count() == 0
    runner._decode = orig_decode
    f3 = ep.submit({'tokens': np.array([1, 2], np.int32)}, max_new_tokens=2)
    eng.run_until_idle()
    assert f3.result(10).ok


def test_stalled_admission_keeps_every_popped_request():
    """A reference fault (ROADMAP.md, Queue 3): one admission pass pops
    every request whose prompt fits the pages free *before* the pass, so
    with 4 usable pages and four 2-page prompts on 4 rows, A and B start,
    C stalls and is put back, and the reference drops D (never
    completed). The port puts C and D back in order and serves all four."""
    prompts = [np.arange(1 + i, 9 + i, dtype=np.int32) for i in range(4)]
    done = {}
    for side in (rserving, tserving):
        eng = _engine(side)
        ep = eng.register('lm', generative=_lm(side), page_size=4,
                          num_pages=5, max_concurrency=4, prefix_cache=False)
        futs = [ep.submit({'tokens': p}, max_new_tokens=2) for p in prompts]
        eng.run_until_idle(max_steps=500)
        done[side] = [f._req.response for f in futs]
    assert [r is not None for r in done[rserving]] == [True] * 3 + [False]
    lm = _lm(tserving)
    for p, r in zip(prompts, done[tserving]):
        assert r is not None and r.ok and _tokens(r) == _ref(lm, p, 2)
    assert [_tokens(r) for r in done[rserving][:3]] == \
        [_tokens(r) for r in done[tserving][:3]]
