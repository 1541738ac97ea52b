"""Transformer encoder layers. Counterpart of
``paddle_tpu/nn/layer/transformer.py`` (``MultiHeadAttention``,
``TransformerEncoderLayer``, ``TransformerEncoder``).

Attribute names match the reference (``self_attn.q_proj``, ``linear1``,
``norm1``, ...), so state-dict keys map one to one. Attention goes through
``F.scaled_dot_product_attention`` (the flash kernel for key-padding
masks) and the post-norm epilogue ``norm(residual + dropout(x))`` through
``F.fused_dropout_add_layer_norm`` (the dropout+add+LayerNorm kernel).
Every dropout site of a layer, and of the encoder's copies of it, draws its
``(seed, offset)`` from the one ``DropoutState`` passed as
``dropout_state=``; a layer built without one raises when training asks it
to drop. The reference's pre-norm option, KV caches and decoder layers are
not ported yet.
"""
import copy
import math

import torch
from torch import nn

from .. import functional as F
from .common import Dropout, Linear
from .norm import LayerNorm

__all__ = ['MultiHeadAttention', 'TransformerEncoderLayer',
           'TransformerEncoder']


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0, *, device=None,
                 generator=None, dropout_state=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"MultiHeadAttention: embed_dim {embed_dim} is "
                             f"not a multiple of num_heads {num_heads}")
        self.dropout = dropout
        self.dropout_state = dropout_state
        kw = dict(device=device, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(embed_dim, embed_dim, **kw)
        self.v_proj = Linear(embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = key if value is None else value
        B = query.shape[0]
        heads = (B, -1, self.num_heads, self.head_dim)
        q = self.q_proj(query).reshape(heads)
        k = self.k_proj(key).reshape(heads)
        v = self.v_proj(value).reshape(heads)
        if attn_mask is not None and attn_mask.dtype != torch.bool:
            attn_mask = attn_mask.to(query.dtype)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout, training=self.training,
            dropout_state=self.dropout_state)
        return self.out_proj(out.reshape(B, -1, self.embed_dim))


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer: ``norm1(src + drop(attn(src)))`` then
    ``norm2(h + drop(ffn(h)))``, each epilogue one fused call."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation='relu', attn_dropout=None, act_dropout=None, *,
                 device=None, generator=None, dropout_state=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        state = self.dropout_state = dropout_state
        kw = dict(device=device, generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout,
                                            dropout_state=state, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout, dropout_state=state)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout, dropout_state=state)
        self.dropout2 = Dropout(dropout, dropout_state=state)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None):
        h = self._sublayer_out(self.self_attn(src, src, src, src_mask), src,
                               self.dropout1, self.norm1)
        ffn = self.linear2(self.dropout(self.activation(self.linear1(h))))
        return self._sublayer_out(ffn, h, self.dropout2, self.norm2)

    def _sublayer_out(self, src, residual, drop, norm):
        return F.fused_dropout_add_layer_norm(
            src, residual, norm.weight, norm.bias, dropout_p=drop.p,
            epsilon=norm.epsilon, training=self.training,
            dropout_state=drop.dropout_state)


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer``; each copy after the
    first re-draws its matrices Xavier-uniform from ``generator``, as the
    reference's ``_clone_layer`` does. The copies share the first layer's
    ``DropoutState``."""

    def __init__(self, encoder_layer, num_layers, *, generator=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [_clone_layer(encoder_layer, generator)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers

    def forward(self, src, src_mask=None):
        for layer in self.layers:
            src = layer(src, src_mask)
        return src


@torch.no_grad()
def _clone_layer(layer, generator):
    # the copy keeps drawing from the original's dropout state: a state of
    # its own would replay the original's (seed, offset) pairs
    shared = {id(m.dropout_state): m.dropout_state for m in layer.modules()
              if getattr(m, 'dropout_state', None) is not None}
    new = copy.deepcopy(layer, shared)
    for p in new.parameters():
        if p.dim() >= 2:
            limit = math.sqrt(6.0 / sum(p.shape))
            p.uniform_(-limit, limit, generator=generator)
    return new
