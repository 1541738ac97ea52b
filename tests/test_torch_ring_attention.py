"""Ring attention (``distributed.ring_attention``), ``ppermute`` and GPT's
``use_ring_attention`` against the reference's.

Two spawns of gloo ranks on the CPU, side by side (``_torch_dist_ranks.
ring_cases``): two and four ranks on a ``'seq'`` axis, joined within 180 s.
The reference runs on ``('seq', n)`` meshes of the 8 host devices
(``tests/conftest.py``), as ``tests/test_distributed.py:444-480`` runs it;
the blocks on the port's side go through the flash kernels' plain versions
(CPU tensors) and merge by their ``lse``. q/k/v (2, 2, 32, 8) from a seed.
Tolerances, fp32: the reference's own (forward 2e-4 relative / 2e-5
absolute, gradients 2e-3 / 2e-4) against both the reference's ring and
``_attn_reference``; GPT (2 layers, hidden 64, 4 heads, L = 32) logits
within 1e-5 and parameter gradients within 1e-4 of the JAX GPT's ring.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.distributed import env as r_env
from paddle_tpu.distributed.ring_attention import ring_attention as r_ring
from paddle_tpu.kernels.flash_attention import _attn_reference
from paddle_tpu.nn.layer_base import functional_call, param_values
from paddle_tpu.text.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.text.gpt import GPTModel as JaxGPTModel

from paddle_tpu_torch import distributed as t_dist
from paddle_tpu_torch.interop import load_paddle_tpu_state
from paddle_tpu_torch.text.gpt import GPTConfig, GPTModel

import _torch_dist_ranks as R

JOIN_S = 180
GPT = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dropout=0.0)


@pytest.fixture(autouse=True)
def _clean():
    yield
    r_env.set_mesh(None)
    r_env._global['initialized'] = False


def _qkv():
    rs = np.random.RandomState(0)
    return tuple(rs.randn(2, 2, 32, 8).astype(np.float32) for _ in range(3))


def _reference(qkv, n):
    """The reference's ring on a ('seq', n) mesh, and ``_attn_reference``
    -> {causal: ((ring out, grads), (plain out, grads))}."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ('seq',))
    out = {}
    for causal in (True, False):
        def ring(q, k, v):
            return r_ring(q, k, v, mesh=mesh, axis='seq', causal=causal)

        def plain(q, k, v):
            return _attn_reference(q, k, v, causal, 1.0 / np.sqrt(8))
        res = []
        for fn in (ring, plain):
            args = [jnp.asarray(a) for a in qkv]
            grads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) ** 2),
                                     argnums=(0, 1, 2)))(*args)
            res.append((np.asarray(jax.jit(fn)(*args)),
                        [np.asarray(g) for g in grads]))
        out[causal] = res
    return out


def _gpt_reference(ids):
    """The JAX GPT with ``use_ring_attention`` on a ('seq', 2) mesh ->
    (port weights, logits, {name: gradient of mean(logits ** 2)})."""
    paddle.seed(11)
    ref = JaxGPTModel(JaxGPTConfig(use_ring_attention=True, **GPT))
    ref.eval()
    state = {k: np.asarray(v._value) for k, v in ref.state_dict().items()}
    port = GPTModel(GPTConfig(**GPT), device='cpu')
    load_paddle_tpu_state(port, state)
    weights = R.weights(port)
    r_env.set_mesh(Mesh(np.asarray(jax.devices()[:2]), ('seq',)))
    params = param_values(ref, trainable_only=False)

    def logits_of(p):
        out, _ = functional_call(ref, p, JaxTensor(ids))
        return out._value
    logits = np.asarray(jax.jit(logits_of)(params))
    grads = jax.jit(jax.grad(lambda p: jnp.mean(logits_of(p) ** 2)))(params)
    return weights, logits, {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope='module')
def runs():
    qkv = _qkv()
    ids = np.random.RandomState(1).randint(0, 97, (2, 32)).astype(np.int64)
    weights, logits, grads = _gpt_reference(ids)
    two = t_dist.spawn(R.ring_cases, args=(qkv, (GPT, weights, ids)),
                       nprocs=2, backend='gloo', join=False)
    four = t_dist.spawn(R.ring_cases, args=(qkv,), nprocs=4,
                        backend='gloo', join=False)
    ref = {n: _reference(qkv, n) for n in (2, 4)}
    return {2: two.join(timeout=JOIN_S), 4: four.join(timeout=JOIN_S),
            'ref': ref, 'gpt': (logits, grads, weights)}


def _close(got, want, grads=False):
    tol = (2e-3, 2e-4) if grads else (2e-4, 2e-5)
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize('n', [2, 4])
@pytest.mark.parametrize('causal', [True, False])
def test_ring_matches_reference_ring_and_full_attention(runs, n, causal):
    for ref_out, ref_grads in runs['ref'][n][causal]:
        for r in runs[n]:
            o, *grads = r[f'global_{causal}']
            _close(o, ref_out)
            for g, want in zip(grads, ref_grads):
                _close(g, want, grads=True)


@pytest.mark.parametrize('n', [2, 4])
@pytest.mark.parametrize('causal', [True, False])
def test_ring_local_blocks_form(runs, n, causal):
    """Each rank's blocks in, its block out (the reference inside
    ``shard_map``): the blocks joined are the global results."""
    ref_out, ref_grads = runs['ref'][n][causal][0]
    ranks = sorted(runs[n], key=lambda r: r['rank'])
    joined = [np.concatenate([r[f'local_{causal}'][i] for r in ranks],
                             axis=2) for i in range(4)]
    _close(joined[0], ref_out)
    for g, want in zip(joined[1:], ref_grads):
        _close(g, want, grads=True)


@pytest.mark.parametrize('n', [2, 4])
def test_ppermute_ring_shift_and_partial_permutation(runs, n):
    for r in runs[n]:
        shifted, grad, partial = r['ppermute']
        src = (r['rank'] - 1) % n
        np.testing.assert_array_equal(shifted, [src, 10.0 + src])
        # the gradient travels back: rank r's value went to r + 1, whose
        # loss weighs it by r + 2
        np.testing.assert_array_equal(grad, [(r['rank'] + 1) % n + 1] * 2)
        # [(0, n - 1), (1, 0)]: zeros on every rank no pair targets
        want = {n - 1: [0.0, 10.0], 0: [1.0, 11.0]}.get(r['rank'],
                                                        [0.0, 0.0])
        np.testing.assert_array_equal(partial, want)
        c = r['counts']
        assert c['seq.ppermute']['calls'] >= 2


def test_gpt_ring_attention_matches_reference(runs):
    from paddle_tpu_torch.interop import to_paddle_tpu_state
    logits, grads, _ = runs['gpt']
    for r in runs[2]:
        got, got_grads = r['gpt']
        np.testing.assert_allclose(got, logits, rtol=1e-5, atol=1e-5)
        # the port's gradients in the reference's layout and names: loaded
        # as a model's weights, then read back through interop
        holder = GPTModel(GPTConfig(**GPT), device='cpu')
        with torch.no_grad():
            for name, p in holder.named_parameters():
                p.copy_(torch.from_numpy(got_grads[name]))
        for name, g in to_paddle_tpu_state(holder).items():
            np.testing.assert_allclose(g, grads[name], rtol=1e-4, atol=1e-5,
                                       err_msg=name)
