"""The attention dropout mask, read back bit for bit through the forward, dQ
and dK/dV (``chip_smoke.attention_mask_probe``).

On the card the probe runs the CUDA kernels and must recover
``philox.keep_mask`` exactly (``chip_smoke.py``'s ``attention_mask_probe``
phase). Here, on the CPU, the same function runs through the plain versions,
which share the mask with the kernels by construction: so these tests prove
the probe itself — it reads back every bit, windows past the first key tile
and a ragged last one included, and it notices a mask that is not
``philox.py``'s.
"""
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.kernels import flash_attention as tfa

SEED, OFFSET, P = 0x1234567890ABCDEF, 17, 0.1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [77, 300])
def test_probe_reads_back_the_philox_mask(dtype, length):
    res = chip_smoke.attention_mask_probe(dtype, torch.device('cpu'), length,
                                          P, SEED, OFFSET)
    assert set(res) == {'forward', 'dq', 'dkv'}
    for path, (read, want) in res.items():
        assert read.dtype == want.dtype == torch.bool, path
        # every (row, key) of the probed windows: B H L min(64, ...) bits
        assert read.numel() == 2 * length * length, path
        assert torch.equal(read, want), path
        assert 0 < int(want.sum()) < want.numel(), path


def test_probe_notices_another_mask(monkeypatch):
    keep_scale = tfa.keep_scale

    def next_call(shape, p, seed, offset, device=None, dtype=torch.float32):
        return keep_scale(shape, p, seed, offset + 1, device, dtype)

    monkeypatch.setattr(tfa, 'keep_scale', next_call)
    res = chip_smoke.attention_mask_probe(torch.float32, torch.device('cpu'),
                                          130, P, SEED, OFFSET)
    assert set(res) == {'forward', 'dq', 'dkv'}
    for path, (read, want) in res.items():
        assert not torch.equal(read, want), path
