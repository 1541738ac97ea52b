"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its kernel's plain PyTorch version; the
JAX side runs the Pallas kernel bodies in interpret mode, as the JAX
package's own kernel tests do. The same numpy inputs go to both.

Tolerances are fp32: the two sides sum rows and dot products in different
orders, which moves results by a few ulps of values of order 1-10, so
outputs agree to 2e-5 absolute/relative; the logsumexp (values up to
~10) to 5e-5.

The CUDA kernels themselves run only on the GPU, where ``chip_smoke.py``
holds each against its plain version; here the wrappers' refusals (no
dropout on CUDA, no non-CUDA tensors on the kernel path) are checked with
``meta`` tensors, which take the kernel branch without a device.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.kernels.fused_dropout_norm import \
    fused_dropout_add_layer_norm as jax_add_ln
from paddle_tpu.kernels.fused_norm import fused_layer_norm as jax_ln
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import fused_dropout_norm as tfdn
from paddle_tpu_torch.kernels import fused_norm as tfn
from paddle_tpu_torch.nn import functional as TF

RTOL = ATOL = 2e-5
LSE_TOL = 5e-5


def _np(x):
    return np.asarray(x)


def _rand(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# LayerNorm (kernels/fused_norm.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("shape", [(48, 256), (3, 16, 128), (13, 64)],
                         ids=["2d", "3d", "rows-not-multiple-of-8"])
def test_layer_norm_matches_pallas(affine, shape):
    x = _rand(0, *shape, scale=2.0, shift=0.5)
    d = shape[-1]
    w = _rand(1, d, scale=0.2, shift=1.0) if affine else None
    b = _rand(2, d) if affine else None
    ref = jax_ln(jnp.asarray(x), None if w is None else jnp.asarray(w),
                 None if b is None else jnp.asarray(b), eps=1e-5,
                 interpret=True)
    out = tfn.fused_layer_norm(
        torch.from_numpy(x), None if w is None else torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), 1e-5)
    assert out.shape == shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("normalized_shape", [(32,), (4, 8)])
def test_functional_layer_norm_matches_reference(normalized_shape):
    x = _rand(3, 2, 5, *normalized_shape, scale=3.0)
    w = _rand(4, *normalized_shape, shift=1.0)
    b = _rand(5, *normalized_shape)
    ref = JF.layer_norm(paddle.to_tensor(x), list(normalized_shape),
                        paddle.to_tensor(w), paddle.to_tensor(b), 1e-5)
    out = TF.layer_norm(torch.from_numpy(x), normalized_shape,
                        torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(out.numpy(), _np(ref._value), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# add + LayerNorm (kernels/fused_dropout_norm.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("affine", [True, False])
def test_add_layer_norm_matches_pallas(affine):
    x, res = _rand(6, 48, 256), _rand(7, 48, 256, scale=2.0)
    w = _rand(8, 256, scale=0.2, shift=1.0) if affine else None
    b = _rand(9, 256) if affine else None
    ref = jax_add_ln(jnp.asarray(x), jnp.asarray(res),
                     None if w is None else jnp.asarray(w),
                     None if b is None else jnp.asarray(b), dropout_p=0.0,
                     interpret=True)
    out = tfdn.fused_dropout_add_layer_norm(
        torch.from_numpy(x), torch.from_numpy(res),
        None if w is None else torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), dropout_p=0.0)
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


def test_functional_add_layer_norm_eval_matches_reference():
    x, res = _rand(10, 2, 7, 64), _rand(11, 2, 7, 64)
    w, b = _rand(12, 64, shift=1.0), _rand(13, 64)
    ref = JF.fused_dropout_add_layer_norm(
        paddle.to_tensor(x), paddle.to_tensor(res), paddle.to_tensor(w),
        paddle.to_tensor(b), dropout_p=0.1, epsilon=1e-5, training=False)
    out = TF.fused_dropout_add_layer_norm(
        torch.from_numpy(x), torch.from_numpy(res), torch.from_numpy(w),
        torch.from_numpy(b), dropout_p=0.1, epsilon=1e-5, training=False)
    np.testing.assert_allclose(out.numpy(), _np(ref._value), rtol=RTOL,
                               atol=ATOL)


def test_plain_add_layer_norm_dropout_keeps_scaled_or_zero():
    # residual 0 and x = 1: after dropout the pre-norm sum is 0 or
    # 1/(1-p), so after LayerNorm the kept elements are the positive ones
    torch.manual_seed(0)
    x = torch.ones(64, 128)
    y = tfdn.fused_dropout_add_layer_norm(x, torch.zeros_like(x),
                                          dropout_p=0.5)
    kept = y > 0
    assert 0.3 < kept.float().mean().item() < 0.7
    assert torch.isfinite(y).all()


# ---------------------------------------------------------------------------
# flash attention (kernels/flash_attention.py)
# ---------------------------------------------------------------------------

B, H, L, D = 2, 3, 128, 16
BQ = BK = 64


def _qkv(seed):
    return (_rand(seed, B, H, L, D), _rand(seed + 1, B, H, L, D),
            _rand(seed + 2, B, H, L, D))


def _kpad(seed, value=-1e9):
    lengths = np.random.RandomState(seed).randint(L // 2, L + 1, size=B)
    bias = np.zeros((B, L), np.float32)
    for i, n in enumerate(lengths):
        bias[i, n:] = value
    return bias


def _pallas_forward(q, k, v, bias, causal):
    return jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias),
        jnp.zeros((1, 1), jnp.int32), causal, 1.0 / np.sqrt(D), BQ, BK,
        0.0, True)


def _port_forward(q, k, v, bias, causal):
    t = torch.from_numpy
    return tfa.flash_attention_forward(
        t(q), t(k), t(v), causal=causal,
        kpad_bias=None if bias is None else t(bias))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_forward_o_and_lse_match_pallas(causal, with_bias):
    q, k, v = _qkv(20)
    bias = _kpad(23) if with_bias else None
    ro, rlse = _pallas_forward(q, k, v, bias, causal)
    o, lse = _port_forward(q, k, v, bias, causal)
    assert o.shape == (B, H, L, D) and lse.shape == (B, H, L)
    np.testing.assert_allclose(o.numpy(), _np(ro), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), _np(rlse), rtol=LSE_TOL,
                               atol=LSE_TOL)
    bhld = tfa.flash_attention_bhld(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        kpad_bias=None if bias is None else torch.from_numpy(bias))
    assert torch.equal(bhld, o)


@pytest.mark.parametrize("value", [-1e9, -np.inf], ids=["-1e9", "-inf"])
def test_flash_fully_masked_rows_match_pallas(value):
    # batch row 1 masks every key: a large finite bias leaves a uniform
    # softmax over the masked keys; -inf leaves no key, so o = 0 and
    # lse = LSE_EMPTY on both sides (never NaN)
    q, k, v = _qkv(30)
    bias = _kpad(33)
    bias[1, :] = value
    ro, rlse = _pallas_forward(q, k, v, bias, False)
    o, lse = _port_forward(q, k, v, bias, False)
    assert torch.isfinite(o).all()
    np.testing.assert_allclose(o.numpy(), _np(ro), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), _np(rlse), rtol=LSE_TOL,
                               atol=LSE_TOL)
    if value == -np.inf:
        assert (o[1] == 0).all() and (lse[1] == tfa.LSE_EMPTY).all()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_ragged_length_matches_reference(causal):
    # L = 100 does not tile into the Pallas blocks; the port's kernel has
    # no such rule, and its plain version agrees with the JAX reference
    rs = np.random.RandomState(40)
    q, k, v = (rs.randn(2, 2, 100, 24).astype(np.float32) for _ in range(3))
    bias = np.where(rs.rand(2, 100) < 0.3, -1e4, 0.0).astype(np.float32)
    ref = jfa._attn_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, 0.3, jnp.asarray(bias))
    o, _ = tfa._attn_reference(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal, 0.3,
                               torch.from_numpy(bias))
    np.testing.assert_allclose(o.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# scaled_dot_product_attention dispatch (nn/functional/transformer.py)
# ---------------------------------------------------------------------------

def _mask(kind, b, h, lq, seed):
    rs = np.random.RandomState(seed)
    if kind == 'kpad-additive':
        return np.where(rs.rand(b, 1, 1, lq) < 0.3, -1e4, 0.0).astype(
            np.float32)
    if kind == 'kpad-bool':
        m = rs.rand(b, 1, 1, lq) > 0.3
        m[..., 0] = True
        return m
    if kind == 'kpad-broadcast':
        return np.where(rs.rand(1, 1, 1, lq) < 0.3, -1e4, 0.0).astype(
            np.float32)
    if kind == 'dense':
        return rs.randn(b, h, lq, lq).astype(np.float32)
    return None


@pytest.mark.parametrize("kind,causal", [
    ('none', False), ('none', True), ('kpad-additive', False),
    ('kpad-bool', False), ('kpad-broadcast', False), ('dense', False)])
def test_sdpa_matches_reference(kind, causal, monkeypatch):
    b, lq, h, d = 2, 24, 4, 8
    q, k, v = (_rand(50 + i, b, lq, h, d) for i in range(3))
    mask = _mask(kind, b, h, lq, 60)
    calls = []
    monkeypatch.setattr(
        TF.transformer, 'flash_attention_bhld',
        lambda *a, **kw: calls.append(1) or tfa.flash_attention_bhld(*a, **kw))
    ref = JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        attn_mask=None if mask is None else paddle.to_tensor(mask),
        is_causal=causal, training=False)
    out = TF.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=None if mask is None else torch.from_numpy(mask),
        is_causal=causal, training=False)
    assert out.shape == (b, lq, h, d)
    np.testing.assert_allclose(out.numpy(), _np(ref._value), rtol=RTOL,
                               atol=ATOL)
    # key-padding masks and no mask take the flash path; others compose
    assert bool(calls) == (kind != 'dense')


# ---------------------------------------------------------------------------
# CUDA-path refusals, checked without a GPU
# ---------------------------------------------------------------------------

def _meta(*shape):
    return torch.empty(*shape, device='meta')


@pytest.mark.parametrize("call", [
    lambda: tfdn.fused_dropout_add_layer_norm(_meta(4, 8), _meta(4, 8),
                                              dropout_p=0.1),
    lambda: tfa.flash_attention_bhld(_meta(1, 2, 8, 4), _meta(1, 2, 8, 4),
                                     _meta(1, 2, 8, 4), dropout_p=0.1),
    lambda: tfa.flash_attention_forward(_meta(1, 2, 8, 4), _meta(1, 2, 8, 4),
                                        _meta(1, 2, 8, 4), dropout_p=0.1),
], ids=["add-ln", "flash-bhld", "flash-forward"])
def test_cuda_wrappers_refuse_dropout(call):
    with pytest.raises(NotImplementedError, match='Philox'):
        call()


@pytest.mark.parametrize("call", [
    lambda: tfn.fused_layer_norm(_meta(4, 8)),
    lambda: tfdn.fused_dropout_add_layer_norm(_meta(4, 8), _meta(4, 8)),
    lambda: tfa.flash_attention_bhld(_meta(1, 2, 8, 4), _meta(1, 2, 8, 4),
                                     _meta(1, 2, 8, 4)),
], ids=["ln", "add-ln", "flash"])
def test_kernel_path_refuses_non_cuda_tensors(call):
    with pytest.raises(ValueError, match='expected a CUDA tensor'):
        call()


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.text import BertConfig, BertModel
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BertModel(BertConfig(vocab_size=10, hidden_size=8,
                             num_hidden_layers=1, num_attention_heads=2,
                             intermediate_size=16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device('cuda')
    assert resolve_device('cpu') == torch.device('cpu')
    assert ServingEngine(device='cpu').device == torch.device('cpu')


# ---------------------------------------------------------------------------
# the kernel build (kernels/_build.py), driven by a stand-in nvcc
# ---------------------------------------------------------------------------

_FAKE_NVCC = '''#!{python}
import os, sys
args = sys.argv[1:]
with open(os.environ['FAKE_NVCC_LOG'], 'a') as f:
    f.write(' '.join(args) + '\\n')
broken = os.environ.get('FAKE_NVCC_FAIL')
if broken and '-c' in args and args[args.index('-c') + 1].endswith(broken):
    print('error: stand-in compile failure')
    sys.exit(1)
with open(args[args.index('-o') + 1], 'w') as f:
    f.write('object')
'''


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    import shutil
    import sys
    from paddle_tpu_torch.kernels import _build
    nvcc = tmp_path / 'cuda' / 'bin' / 'nvcc'
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    csrc = tmp_path / 'csrc'
    shutil.copytree(_build.CSRC, csrc)
    log = tmp_path / 'nvcc.log'
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'cuda'))
    monkeypatch.setenv('FAKE_NVCC_LOG', str(log))
    monkeypatch.setattr(_build, 'CSRC', csrc)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    return _build, csrc, log


def test_build_compiles_each_source_for_sm90a_then_reuses(fake_nvcc):
    _build, csrc, log = fake_nvcc
    lib = _build.build()
    assert lib.exists() and lib.parent == _build.BUILD_DIR
    assert _build._digest() in lib.name
    calls = log.read_text().splitlines()
    compiled = sorted(c.split(' -c ')[1].split()[0].rsplit('/', 1)[1]
                      for c in calls if ' -c ' in c)
    assert compiled == sorted(p.name for p in csrc.glob('*.cu'))
    assert sum('-shared' in c for c in calls) == 1
    assert all('arch=compute_90a,code=sm_90a' in c for c in calls)
    assert (lib.parent / (lib.name + '.log')).exists()
    # unchanged sources: the library is reused, nothing is compiled
    assert _build.build() == lib
    assert len(log.read_text().splitlines()) == len(calls)
    # an edited source gets a library of its own
    flash = csrc / 'flash_attention.cu'
    flash.write_text(flash.read_text() + '\n// edited\n')
    assert _build.build() != lib


def test_build_failure_raises_with_the_compiler_output(fake_nvcc,
                                                       monkeypatch):
    _build, _, _ = fake_nvcc
    monkeypatch.setenv('FAKE_NVCC_FAIL', 'fused_norm.cu')
    with pytest.raises(RuntimeError, match=r'fused_norm\.cu.*\n(.|\n)*'
                                           r'stand-in compile failure'):
        _build.build()
    assert not list(_build.BUILD_DIR.glob('*.so'))
