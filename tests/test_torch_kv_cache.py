"""The port's KV caches (``serving/kv_cache.py``, ``serving/paged_kv.py``)
against the JAX package's, on the CPU.

Every slot and paged function takes the same numpy inputs on both sides
and is held elementwise (fp32, 1e-6 absolute: einsum/softmax over at most
64 keys summed in different orders). The port writes its cache in place,
so each call gets a fresh copy. The padding rows of a chunk all land in
the null page, several at one offset, where either side may keep any of
them: the null page is left out of the comparison. ``TinyCausalLM.random``
draws the reference's weights from the same numpy seed, and its
``prefill``, ``decode``, ``prefill_chunk``, ``verify_tokens`` and
``reference_decode`` are held to the reference's (logits 1e-5: one block
and a 64-wide head; greedy tokens exactly). The host bookkeeping
(``PageAllocator``, ``PrefixCache``, ``chain_hashes``) is held to the
reference's behaviour, digests byte for byte.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving import kv_cache as rkv
from paddle_tpu.serving import paged_kv as rpk

from paddle_tpu_torch.serving import kv_cache as tkv
from paddle_tpu_torch.serving import paged_kv as tpk

TOL = 1e-6
LOGIT_TOL = 1e-5
L, B, S, H, D = 2, 3, 16, 2, 8          # slot cache
P, PS, MP = 9, 4, 4                     # paged: pages, page size, row pages


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _slot_cache(seed=0):
    return {'k': _rand(L, B, S, H, D, seed=seed),
            'v': _rand(L, B, S, H, D, seed=seed + 1)}


def _paged_cache(seed=0):
    return {'k': _rand(L, P, PS, H, D, seed=seed),
            'v': _rand(L, P, PS, H, D, seed=seed + 1)}


def _j(cache):
    return {k: jnp.asarray(v) for k, v in cache.items()}


def _t(cache):
    return {k: torch.from_numpy(v.copy()) for k, v in cache.items()}


def _same(tcache, jcache, skip_null=False):
    for k in ('k', 'v'):
        got, want = tcache[k].numpy(), np.asarray(jcache[k])
        if skip_null:
            got, want = got[:, 1:], want[:, 1:]
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=k)


def _ti(a):
    return torch.from_numpy(np.asarray(a, np.int32))


# ---------------------------------------------------------------------------
# slot cache
# ---------------------------------------------------------------------------

def test_create_cache_shapes():
    j = rkv.create_cache(L, B, S, H, D)
    t = tkv.create_cache(L, B, S, H, D, device='cpu')
    for k in ('k', 'v'):
        assert tuple(t[k].shape) == j[k].shape and t[k].dtype == \
            torch.float32 and not t[k].any()


def test_write_prompt_and_token():
    c = _slot_cache()
    k, v = _rand(5, H, D, seed=3), _rand(5, H, D, seed=4)
    _same(tkv.write_prompt(_t(c), 1, 2, torch.from_numpy(k),
                           torch.from_numpy(v)),
          rkv.write_prompt(_j(c), 1, 2, jnp.asarray(k), jnp.asarray(v)))
    kt, vt = _rand(B, H, D, seed=5), _rand(B, H, D, seed=6)
    pos = np.array([0, 7, 15], np.int32)
    _same(tkv.write_token(_t(c), 0, torch.from_numpy(kt),
                          torch.from_numpy(vt), _ti(pos)),
          rkv.write_token(_j(c), 0, jnp.asarray(kt), jnp.asarray(vt),
                          jnp.asarray(pos)))


def test_attend_and_attend_prompt():
    c = _slot_cache(2)
    q = _rand(B, H, D, seed=7)
    lengths = np.array([1, 9, 16], np.int32)
    np.testing.assert_allclose(
        tkv.attend(_t(c), 1, torch.from_numpy(q), _ti(lengths)).numpy(),
        np.asarray(rkv.attend(_j(c), 1, jnp.asarray(q),
                              jnp.asarray(lengths))), atol=TOL, rtol=0)
    q, k, v = (_rand(6, H, D, seed=s) for s in (8, 9, 10))
    np.testing.assert_allclose(
        tkv.attend_prompt(*(torch.from_numpy(a) for a in (q, k, v))).numpy(),
        np.asarray(rkv.attend_prompt(*(jnp.asarray(a) for a in (q, k, v)))),
        atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------

def test_create_paged_cache_shapes():
    j = rpk.create_paged_cache(L, P, PS, H, D)
    t = tpk.create_paged_cache(L, P, PS, H, D, device='cpu')
    assert tuple(t['k'].shape) == j['k'].shape and not t['v'].any()


@pytest.mark.parametrize("start,nvalid,cb", [(0, 3, 4), (5, 8, 8), (2, 5, 8),
                                             (14, 2, 8)])
def test_write_chunk(start, nvalid, cb):
    c = _paged_cache()
    row = np.array([3, 7, 1, 5], np.int32)
    k, v = _rand(cb, H, D, seed=11), _rand(cb, H, D, seed=12)
    _same(tpk.write_chunk(_t(c), 1, _ti(row), torch.from_numpy(k),
                          torch.from_numpy(v), start, nvalid),
          rpk.write_chunk(_j(c), 1, jnp.asarray(row), jnp.asarray(k),
                          jnp.asarray(v), start, nvalid), skip_null=True)


def test_write_tokens_and_gather_kv():
    c = _paged_cache(3)
    tables = np.array([[3, 7, 0, 0], [1, 5, 2, 0], [0, 0, 0, 0]], np.int32)
    positions = np.array([[5, 6], [9, 10], [0, 1]], np.int32)
    k, v = _rand(3, 2, H, D, seed=13), _rand(3, 2, H, D, seed=14)
    _same(tpk.write_tokens(_t(c), 0, _ti(tables), torch.from_numpy(k),
                           torch.from_numpy(v), _ti(positions)),
          rpk.write_tokens(_j(c), 0, jnp.asarray(tables), jnp.asarray(k),
                           jnp.asarray(v), jnp.asarray(positions)),
          skip_null=True)
    for got, want in zip(tpk.gather_kv(_t(c), 1, _ti(tables)),
                         rpk.gather_kv(_j(c), 1, jnp.asarray(tables))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_attend_tokens_and_chunk():
    c = _paged_cache(4)
    tables = np.array([[3, 7, 0, 0], [1, 5, 2, 8]], np.int32)
    positions = np.array([[2, 3, 4], [9, 10, 11]], np.int32)
    q = _rand(2, 3, H, D, seed=15)
    np.testing.assert_allclose(
        tpk.attend_tokens(_t(c), 1, torch.from_numpy(q), _ti(tables),
                          _ti(positions)).numpy(),
        np.asarray(rpk.attend_tokens(_j(c), 1, jnp.asarray(q),
                                     jnp.asarray(tables),
                                     jnp.asarray(positions))),
        atol=TOL, rtol=0)
    q = _rand(8, H, D, seed=16)
    np.testing.assert_allclose(
        tpk.attend_chunk(_t(c), 0, torch.from_numpy(q), _ti(tables[1]),
                         6).numpy(),
        np.asarray(rpk.attend_chunk(_j(c), 0, jnp.asarray(q),
                                    jnp.asarray(tables[1]), 6)),
        atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# host bookkeeping
# ---------------------------------------------------------------------------

def test_page_allocator_matches_reference():
    for mod in (rpk, tpk):
        a = mod.PageAllocator(5)
        assert a.usable == 4 and a.free_count() == 4
        pages = [a.alloc() for _ in range(4)]
        assert pages == [1, 2, 3, 4]             # page 0 is never handed out
        with pytest.raises(mod.PagesExhaustedError, match='grow num_pages'):
            a.alloc()
        a.incref(pages[0])
        a.decref(pages[0])
        assert a.free_count() == 0 and a.refcount(pages[0]) == 1
        a.decref(pages[0])
        assert a.alloc() == pages[0]             # freelist reuse
        a.decref(pages[1])
        with pytest.raises(ValueError, match='decref of free page'):
            a.decref(pages[1])
        with pytest.raises(ValueError, match='incref of free page'):
            a.incref(pages[1])
        assert (a.allocated_total, a.freed_total) == (5, 2)
        with pytest.raises(ValueError, match='>= 2 pages'):
            mod.PageAllocator(1)


def test_chain_hashes_byte_for_byte():
    rs = np.random.RandomState(0)
    for n, ps in ((16, 4), (7, 4), (33, 8), (3, 4), (0, 4)):
        toks = rs.randint(0, 50304, size=n).astype(np.int32)
        want = rpk.chain_hashes(toks, ps)
        assert tpk.chain_hashes(toks, ps) == want
        assert tpk.chain_hashes(list(toks), ps) == want
        assert len(want) == n // ps


def test_prefix_cache_lru_spares_referenced_pages():
    for mod in (rpk, tpk):
        a = mod.PageAllocator(4)
        pc = mod.PrefixCache(a)
        d1, d2 = b'digest-1', b'digest-2'
        p1, p2 = a.alloc(), a.alloc()
        pc.insert(d1, p1)
        pc.insert(d2, p2)
        pc.insert(d2, p1)                      # already consed: kept
        assert len(pc) == 2 and a.refcount(p1) == 2
        a.decref(p1)
        assert pc.probe([d1, d2, b'x']) == 2
        assert pc.lookup(d2) == p2
        free_before = a.free_count()
        assert pc.evict_one()                  # p1: LRU, pinned by cache only
        assert a.free_count() == free_before + 1
        assert pc.lookup(d1) is None
        a.decref(p2)
        assert not pc.evict_one()              # the lookup's ref remains
        a.decref(p2)
        assert pc.evict_one()
        assert (pc.hits, pc.misses, pc.hit_rate()) == (1, 1, 0.5)


# ---------------------------------------------------------------------------
# TinyCausalLM
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def lms():
    kw = dict(max_batch=3, prompt_buckets=(4, 8))
    return (rkv.TinyCausalLM.random(seed=3, **kw),
            tkv.TinyCausalLM.random(seed=3, device='cpu', **kw))


def test_tiny_lm_weights_are_the_reference_draws(lms):
    ref, port = lms
    assert set(port.p) == set(ref.p)
    for k in ref.p:
        np.testing.assert_array_equal(port.p[k].numpy(), np.asarray(ref.p[k]))
    assert (port.vocab, port.num_heads, port.head_dim, port.max_seq) == \
        (ref.vocab, ref.num_heads, ref.head_dim, ref.max_seq)


def test_tiny_lm_slot_prefill_and_decode(lms):
    ref, port = lms
    jc, tc = ref.init_cache(), port.init_cache()
    toks = np.array([5, 9, 2, 0, 0, 0, 0, 0], np.int32)
    # jitted, as the reference's runners call them (eager jnp dispatches
    # op by op)
    jc, jl = jax.jit(ref.prefill)(jc, jnp.asarray(toks), jnp.asarray(3),
                                  jnp.asarray(1))
    tc, tl = port.prefill(tc, _ti(toks), 3, 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    _same(tc, jc)
    step = np.array([7, 11, 0], np.int32)
    pos = np.array([4, 3, 0], np.int32)
    jc, jl = jax.jit(ref.decode)(jc, jnp.asarray(step), jnp.asarray(pos))
    tc, tl = port.decode(tc, _ti(step), _ti(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    _same(tc, jc)


def test_tiny_lm_paged_chunk_and_verify(lms):
    ref, port = lms
    jc, tc = ref.init_paged_cache(P, PS), port.init_paged_cache(P, PS)
    row = np.array([3, 7, 1, 5, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                   np.int32)
    for start, nvalid, cb in ((0, 8, 8), (8, 3, 4)):
        toks = np.random.RandomState(start).randint(0, 64, size=cb).astype(
            np.int32)
        jc, jl = jax.jit(ref.prefill_chunk)(jc, jnp.asarray(row),
                                            jnp.asarray(toks), start, nvalid)
        tc, tl = port.prefill_chunk(tc, _ti(row), _ti(toks), start, nvalid)
        np.testing.assert_allclose(tl[:nvalid].numpy(),
                                   np.asarray(jl)[:nvalid], atol=LOGIT_TOL,
                                   rtol=0)
        _same(tc, jc, skip_null=True)
    tables = np.zeros((2, 16), np.int32)
    tables[0] = row
    toks = np.array([[4, 8, 15], [1, 2, 3]], np.int32)
    positions = np.array([[11, 12, 13], [0, 1, 2]], np.int32)
    jc, jl = jax.jit(ref.verify_tokens)(jc, jnp.asarray(tables),
                                        jnp.asarray(toks),
                                        jnp.asarray(positions))
    tc, tl = port.verify_tokens(tc, _ti(tables), _ti(toks), _ti(positions))
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0],
                               atol=LOGIT_TOL, rtol=0)
    _same(tc, jc, skip_null=True)
    jc, jl = jax.jit(ref.decode_paged)(jc, jnp.asarray(tables),
                                       jnp.asarray(toks[:, 0]),
                                       jnp.asarray(positions[:, 0] + 3))
    tc, tl = port.decode_paged(tc, _ti(tables), _ti(toks[:, 0]),
                               _ti(positions[:, 0] + 3))
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0],
                               atol=LOGIT_TOL, rtol=0)


def test_tiny_lm_reference_decode(lms):
    ref, port = lms
    # the reference's oracle runs eagerly, op by op: one short prompt
    prompt = [60, 5, 7]
    assert port.reference_decode(prompt, 2) == \
        [int(t) for t in ref.reference_decode(prompt, 2)]
    logits = port.reference_logits([1, 2, 3, 4])
    assert tuple(logits.shape) == (4, port.vocab)
