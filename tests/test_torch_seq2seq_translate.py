"""``Seq2SeqTransformer.translate`` against the JAX package.

The model of ``test_torch_seq2seq.py`` (vocabularies 23 and 29, d_model
32, 4 heads, 2 + 2 layers, FFN 64, 40 positions, p = 0), its state
randomised on the reference and carried across with ``interop``:
``translate``'s ids (2 sources, beam 3, 6 steps, after the backtrace)
equal the reference's exactly, on every beam, and the final
log-probabilities are fp32. The reference's decode loop runs op by op and
compiles each step's new shapes, so the search is short.
"""
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.text.seq2seq import Seq2SeqTransformer as JaxSeq2Seq

from paddle_tpu_torch.interop import load_paddle_tpu_state
from paddle_tpu_torch.text import Seq2SeqTransformer

SV, TV, D, H, FF, MAXLEN = 23, 29, 32, 4, 64, 40


def _np(t):
    return np.asarray(t._value)


def test_translate_matches_reference():
    paddle.seed(5)
    kw = dict(d_model=D, nhead=H, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=FF, dropout=0.0,
              max_length=MAXLEN)
    ref = JaxSeq2Seq(SV, TV, **kw)
    ref.eval()
    rs = np.random.RandomState(6)
    state = {k: (0.3 * rs.randn(*v.shape)).astype(np.float32)
             for k, v in ref.state_dict().items()}
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    port = Seq2SeqTransformer(SV, TV, **kw, device='cpu').eval()
    load_paddle_tpu_state(port, state)
    src = np.random.RandomState(7).randint(2, SV, (2, 9)).astype(np.int64)
    want = _np(ref.translate(paddle.to_tensor(src), bos_id=0, eos_id=1,
                             beam_size=3, max_len=6))
    got, states = port.beam_decode(torch.from_numpy(src), 0, 1, 3, 6)
    assert got.shape == (2, 6, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert states['log_probs'].dtype == torch.float32
    again = port.translate(torch.from_numpy(src), 0, 1, 3, 6)
    assert torch.equal(again, got)
    assert not port.training


