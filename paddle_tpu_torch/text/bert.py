"""BERT encoder and pretraining heads. Counterpart of
``paddle_tpu/text/bert.py`` (``BertConfig``, ``BertEmbeddings``,
``BertPooler``, ``BertModel``, ``BertPretrainingHeads``,
``BertForPretraining``, ``bert_base``, ``bert_large``).

The numbers follow the reference exactly: the embedding LayerNorm uses
``eps=1e-12`` while the encoder's use the LayerNorm default 1e-5, GELU is
the exact erf form, and a (B, L) padding mask becomes the additive
``(1 - mask) * -1e4`` — so padding rows of a serving bucket (all-zero
mask) attend uniformly and stay finite. The MLM decoder is tied to the
word embeddings: one (vocab, hidden) parameter, listed once in the state
dict under ``bert.embeddings.word_embeddings.weight`` as in the reference,
used untransposed (``h @ W^T``), outside ``amp.auto_cast``'s reach as the
reference's ``matmul`` is. In training every dropout site of a model
draws from the model's one ``DropoutState``, which the model creates,
seeds from the ``generator`` it was built with and hands to its layers.
"""
import torch
from torch import nn

from ..device import resolve_device
from ..kernels.philox import DropoutState
from ..nn import functional as F
from ..nn import (Dropout, Embedding, LayerNorm, Linear, TransformerEncoder,
                  TransformerEncoderLayer)

__all__ = ['BertConfig', 'BertEmbeddings', 'BertPooler', 'BertModel',
           'BertPretrainingHeads', 'BertForPretraining', 'bert_base',
           'bert_large']


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, pad_token_id=0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.pad_token_id = pad_token_id


class BertEmbeddings(nn.Module):
    def __init__(self, config, *, device=None, generator=None,
                 dropout_state=None):
        super().__init__()
        kw = dict(std=config.initializer_range, device=device,
                  generator=generator)
        self.word_embeddings = Embedding(config.vocab_size,
                                         config.hidden_size, **kw)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size, **kw)
        self.token_type_embeddings = Embedding(config.type_vocab_size,
                                               config.hidden_size, **kw)
        self.layer_norm = LayerNorm(config.hidden_size, epsilon=1e-12,
                                    device=device)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               dropout_state=dropout_state)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        B, L = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(L, device=input_ids.device
                                        ).unsqueeze(0).expand(B, L)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids) +
               self.position_embeddings(position_ids) +
               self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(nn.Module):
    def __init__(self, config, *, device=None, generator=None):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            device=device, generator=generator)

    def forward(self, hidden_states):
        return torch.tanh(self.dense(hidden_states[:, 0]))


class BertModel(nn.Module):
    """BERT encoder -> ``(sequence_output, pooled_output)``.

    ``device=None`` builds on the CUDA device (``device='cpu'`` for the
    plain path); every initial value, and after them the seed of the
    model's ``dropout_state``, is drawn from ``generator``, which defaults
    to a generator on that device seeded with 0.
    """

    def __init__(self, config=None, *, device=None, generator=None,
                 **kwargs):
        super().__init__()
        config = config or BertConfig(**kwargs)
        self.config = config
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        # every layer that drops shares this state; its seed is drawn
        # last, so the weights a seed gives do not depend on it
        self.dropout_state = DropoutState(0)
        kw = dict(device=device, generator=generator)
        self.embeddings = BertEmbeddings(config,
                                         dropout_state=self.dropout_state,
                                         **kw)
        enc_layer = TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size, dropout=config.hidden_dropout_prob,
            activation=config.hidden_act,
            attn_dropout=config.attention_probs_dropout_prob,
            act_dropout=0.0, dropout_state=self.dropout_state, **kw)
        self.encoder = TransformerEncoder(enc_layer,
                                          config.num_hidden_layers,
                                          generator=generator)
        self.pooler = BertPooler(config, **kw)
        self.dropout_state.seed = DropoutState.from_generator(generator).seed

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is not None and attention_mask.dim() == 2:
            # (B, L) padding mask -> (B, 1, 1, L) additive
            am = (1.0 - attention_mask.to(torch.float32)) * -1e4
            attention_mask = am[:, None, None, :]
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        seq = self.encoder(emb, attention_mask)
        return seq, self.pooler(seq)


class BertPretrainingHeads(nn.Module):
    """MLM head (transform, activation, LayerNorm, tied decoder + bias) and
    NSP head. ``word_embeddings`` is the model's word ``Embedding``; the
    head keeps a reference to it and reads its (vocab, hidden) ``weight`` at
    each call, not a parameter of its own, so the weight stays one tensor
    with one gradient, and ``torch.func.functional_call`` substituting that
    weight (a bf16 copy, say) substitutes the decoder's too."""

    def __init__(self, config, word_embeddings, *, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.transform = Linear(config.hidden_size, config.hidden_size, **kw)
        self.activation = getattr(F, config.hidden_act)
        self.layer_norm = LayerNorm(config.hidden_size, epsilon=1e-12,
                                    device=device)
        # a tuple hides the module from nn.Module's registry
        self._tied = (word_embeddings,)
        self.decoder_bias = nn.Parameter(torch.zeros(config.vocab_size,
                                                     device=device))
        self.seq_relationship = Linear(config.hidden_size, 2, **kw)

    @property
    def decoder_weight(self):
        return self._tied[0].weight

    def forward(self, sequence_output, pooled_output, masked_positions=None):
        if masked_positions is not None:
            # (B, K) positions -> (B, K, hidden) rows of the sequence
            batch_idx = torch.arange(sequence_output.shape[0],
                                     device=sequence_output.device)[:, None]
            sequence_output = sequence_output[
                batch_idx, masked_positions.to(torch.int64)]
        h = self.layer_norm(self.activation(self.transform(sequence_output)))
        # the reference's h.matmul(W, transpose_y=True) + bias: a matmul
        # that auto_cast leaves alone, so under O1 the fp16/bf16 h meets the
        # fp32 weight and bias, and the product promotes to fp32
        dt = torch.promote_types(h.dtype, self.decoder_weight.dtype)
        logits = torch.nn.functional.linear(
            h.to(dt), self.decoder_weight.to(dt), self.decoder_bias.to(dt))
        return logits, self.seq_relationship(pooled_output)


class BertForPretraining(nn.Module):
    """``BertModel`` with the pretraining heads -> ``(prediction_logits,
    nsp_logits)``; ``pretraining_loss`` is the MLM cross entropy (labels of
    -1 ignored) plus the NSP cross entropy."""

    def __init__(self, config=None, *, device=None, generator=None,
                 **kwargs):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        self.bert = BertModel(config, device=device, generator=generator,
                              **kwargs)
        self.cls = BertPretrainingHeads(
            self.bert.config, self.bert.embeddings.word_embeddings,
            device=device, generator=generator)

    @property
    def dropout_state(self):
        return self.bert.dropout_state

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_positions=None):
        seq, pooled = self.bert(input_ids, token_type_ids,
                                attention_mask=attention_mask)
        return self.cls(seq, pooled, masked_positions)

    def pretraining_loss(self, prediction_logits, nsp_logits, masked_labels,
                         next_sentence_labels):
        mlm = F.cross_entropy(
            prediction_logits.reshape(-1, prediction_logits.shape[-1]),
            masked_labels.reshape(-1), ignore_index=-1)
        nsp = F.cross_entropy(nsp_logits, next_sentence_labels.reshape(-1))
        return mlm + nsp


def bert_base(**kwargs):
    return BertConfig(hidden_size=768, num_hidden_layers=12,
                      num_attention_heads=12, intermediate_size=3072,
                      **kwargs)


def bert_large(**kwargs):
    return BertConfig(hidden_size=1024, num_hidden_layers=24,
                      num_attention_heads=16, intermediate_size=4096,
                      **kwargs)
