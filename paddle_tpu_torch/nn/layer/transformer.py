"""Transformer encoder layers. Counterpart of
``paddle_tpu/nn/layer/transformer.py`` (``MultiHeadAttention``,
``TransformerEncoderLayer``, ``TransformerEncoder``).

Attribute names match the reference (``self_attn.q_proj``, ``linear1``,
``norm1``, ...), so state-dict keys map one to one. Attention goes through
``F.scaled_dot_product_attention`` (the flash kernel for key-padding
masks). The post-norm epilogue ``norm(residual + dropout(x))`` is one
``F.fused_dropout_add_layer_norm`` call (the dropout+add+LayerNorm
kernel); with ``normalize_before=True`` (pre-norm) each sublayer reads
``norm(x)`` (the LayerNorm kernel) and its epilogue is the composed
``residual + dropout(out)`` (the Philox ``F.dropout``), as in the
reference. ``TransformerEncoder(norm=)`` normalises the last layer's
output. Every dropout site of a layer, and of the encoder's copies of it,
draws its ``(seed, offset)`` from the one ``DropoutState`` passed as
``dropout_state=``; a layer built without one raises when training asks it
to drop. Under ``nn.remat.scope`` (``build_train_step(remat=)``) the
encoder runs each layer under the scope's rematerialisation policy. KV
caches and decoder layers are not ported yet.
"""
import copy
import math

import torch
from torch import nn

from .. import functional as F
from .. import remat as _remat
from ..initializer import copy_param_attrs
from .common import Dropout, Linear
from .norm import LayerNorm

__all__ = ['MultiHeadAttention', 'TransformerEncoderLayer',
           'TransformerEncoder']


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0, weight_attr=None,
                 bias_attr=None, *, device=None, generator=None,
                 dropout_state=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"MultiHeadAttention: embed_dim {embed_dim} is "
                             f"not a multiple of num_heads {num_heads}")
        self.dropout = dropout
        self.dropout_state = dropout_state
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                  device=device, generator=generator)
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
    """Post-norm: ``norm1(src + drop(attn(src)))`` then ``norm2(h +
    drop(ffn(h)))``, each epilogue one fused call. Pre-norm
    (``normalize_before=True``): ``h = src + drop(attn(norm1(src)))`` then
    ``h + drop(ffn(norm2(h)))``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation='relu', attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *,
                 device=None, generator=None, dropout_state=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        state = self.dropout_state = dropout_state
        kw = dict(device=device, generator=generator)
        attrs = dict(weight_attr=weight_attr, bias_attr=bias_attr)
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout,
                                            dropout_state=state, **attrs,
                                            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **attrs, **kw)
        self.dropout = Dropout(act_dropout, dropout_state=state)
        self.linear2 = Linear(dim_feedforward, d_model, **attrs, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout, dropout_state=state)
        self.dropout2 = Dropout(dropout, dropout_state=state)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None):
        x = self.norm1(src) if self.normalize_before else src
        h = self._sublayer_out(self.self_attn(x, x, x, src_mask), src,
                               self.dropout1, self.norm1)
        x = self.norm2(h) if self.normalize_before else h
        ffn = self.linear2(self.dropout(self.activation(self.linear1(x))))
        return self._sublayer_out(ffn, h, self.dropout2, self.norm2)

    def _sublayer_out(self, src, residual, drop, norm):
        """Post-norm: ``norm(residual + drop(src))`` in one kernel;
        pre-norm: ``residual + drop(src)``, composed."""
        if self.normalize_before:
            return residual + drop(src)
        return F.fused_dropout_add_layer_norm(
            src, residual, norm.weight, norm.bias, dropout_p=drop.p,
            epsilon=norm.epsilon, training=self.training,
            dropout_state=drop.dropout_state)


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer``; each copy after the
    first re-draws its matrices Xavier-uniform from ``generator``, as the
    reference's ``_clone_layer`` does, and keeps the first one's
    ``ParamAttr`` settings. The copies share the first layer's
    ``DropoutState``. ``norm``: an optional final ``LayerNorm``."""

    def __init__(self, encoder_layer, num_layers, norm=None, *,
                 generator=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [_clone_layer(encoder_layer, generator)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        remat = _remat.current() if torch.is_grad_enabled() else None
        for layer in self.layers:
            src = layer(src, src_mask) if remat is None else \
                remat(layer, src, src_mask)
        if self.norm is not None:
            src = self.norm(src)
        return src


@torch.no_grad()
def _clone_layer(layer, generator):
    # the copy keeps drawing from the original's dropout state: a state of
    # its own would replay the original's (seed, offset) pairs
    shared = {id(m.dropout_state): m.dropout_state for m in layer.modules()
              if getattr(m, 'dropout_state', None) is not None}
    new = copy_param_attrs(layer, copy.deepcopy(layer, shared))
    for p in new.parameters():
        if p.dim() >= 2:
            limit = math.sqrt(6.0 / sum(p.shape))
            p.uniform_(-limit, limit, generator=generator)
    return new
