"""The Transformer seq2seq for translation. Counterpart of
``paddle_tpu/text/seq2seq.py`` (``Seq2SeqTransformer``, ``translate``,
``_TransformerDecodeCell``), on ``nn.Transformer``.

Its default widths are Transformer-base (Vaswani et al. 2017): d_model
512, 8 heads, 6 + 6 layers, FFN 2048, dropout 0.1, 256 positions. The
encoder's self-attention has no mask, so it takes the flash kernel; the
decoder's carries the causal (L, L) mask and is composed.
``translate`` encodes once, projects the memory into each layer's
``StaticCache`` once, and beam-searches over the decoder's incremental
``Cache``; the positions are a device tensor carried in the decoding
state.
"""
import torch
from torch import nn

from ..device import resolve_device
from ..kernels.philox import DropoutState
from ..nn import Embedding, Linear, Transformer
from ..nn.decode import BeamSearchDecoder, dynamic_decode

__all__ = ['Seq2SeqTransformer']


class Seq2SeqTransformer(nn.Module):
    """Source and target embeddings plus a learned position table, the
    encoder-decoder ``Transformer`` and the output projection to the
    target vocabulary. ``forward(src_ids, trg_ids)`` -> (B, Lt, V)
    teacher-forced logits. Every weight is drawn from ``generator`` (one
    on the device seeded with 0 by default), then the seed of the model's
    ``dropout_state``."""

    def __init__(self, src_vocab_size, trg_vocab_size, d_model=512, nhead=8,
                 num_encoder_layers=6, num_decoder_layers=6,
                 dim_feedforward=2048, dropout=0.1, max_length=256, *,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.dropout_state = DropoutState(0)
        kw = dict(device=device, generator=generator)
        self.src_emb = Embedding(src_vocab_size, d_model, **kw)
        self.trg_emb = Embedding(trg_vocab_size, d_model, **kw)
        self.pos_emb = Embedding(max_length, d_model, **kw)
        self.transformer = Transformer(
            d_model, nhead, num_encoder_layers, num_decoder_layers,
            dim_feedforward, dropout, dropout_state=self.dropout_state, **kw)
        self.out_proj = Linear(d_model, trg_vocab_size, **kw)
        self.dropout_state.seed = DropoutState.from_generator(generator).seed

    def _embed(self, ids, emb):
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        return emb(ids) + self.pos_emb(pos)

    def forward(self, src_ids, trg_ids):
        src = self._embed(src_ids, self.src_emb)
        trg = self._embed(trg_ids, self.trg_emb)
        tgt_mask = Transformer.generate_square_subsequent_mask(
            trg_ids.shape[1], device=trg_ids.device)
        return self.out_proj(self.transformer(src, trg, tgt_mask=tgt_mask))

    def beam_decode(self, src_ids, bos_id=0, eos_id=1, beam_size=4,
                    max_len=64):
        """``translate``'s search -> ``(ids (B, max_len, beam), final
        states)``: the states hold each beam's fp32 ``log_probs``,
        ``finished`` and ``lengths``."""
        max_pos = self.pos_emb.weight.shape[0]
        if max_len > max_pos:
            raise ValueError(f"translate max_len {max_len} exceeds "
                             f"positional table size {max_pos}")
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                memory = self.transformer.encoder(
                    self._embed(src_ids, self.src_emb))
                cache = self.transformer.decoder.gen_cache(memory)
                decoder = BeamSearchDecoder(
                    _TransformerDecodeCell(self), start_token=bos_id,
                    end_token=eos_id, beam_size=beam_size)
                pos0 = torch.zeros(src_ids.shape[0], dtype=torch.int64,
                                   device=src_ids.device)
                return dynamic_decode(
                    decoder, inits={'cache': cache, 'pos': pos0},
                    max_step_num=max_len, is_test=True)
        finally:
            if was_training:
                self.train()

    def translate(self, src_ids, bos_id=0, eos_id=1, beam_size=4,
                  max_len=64):
        """Beam-search translation -> int ids (B, max_len, beam), the
        beams ranked best first; steps after every beam ended hold
        ``eos_id``. Raises ``ValueError`` when ``max_len`` exceeds the
        position table."""
        return self.beam_decode(src_ids, bos_id, eos_id, beam_size,
                                max_len)[0]


class _TransformerDecodeCell:
    """The decoder as a cell: state ``{'cache': each layer's (Cache,
    StaticCache), 'pos': (N,) absolute positions}``. The static cache holds
    the projected memory, so the decoder never reads the memory again."""

    def __init__(self, model):
        self.model = model

    def __call__(self, inputs, states):
        cache, pos = states['cache'], states['pos']
        ids = inputs.unsqueeze(1)                              # (N, 1)
        x = self.model.trg_emb(ids) + self.model.pos_emb(pos.unsqueeze(1))
        # the memory argument is unused: the static caches stand for it
        out, new_cache = self.model.transformer.decoder(x, x, None, None,
                                                        cache)
        logits = self.model.out_proj(out.squeeze(1))           # (N, V)
        return logits, {'cache': new_cache, 'pos': pos + 1}
