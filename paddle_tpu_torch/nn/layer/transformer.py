"""Transformer layers. Counterpart of
``paddle_tpu/nn/layer/transformer.py`` (``MultiHeadAttention`` with its
``Cache`` and ``StaticCache``, ``TransformerEncoderLayer``,
``TransformerEncoder``, ``TransformerDecoderLayer``,
``TransformerDecoder``, ``Transformer``).

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
encoder runs each layer under the scope's rematerialisation policy. Under
tensor parallelism (``distributed.sharding.apply_tensor_parallel``) the
attention runs on its rank's local heads (``local_heads``) and the FFN on
its block of ``dim_feedforward``, their masks the dense model's.

The decoder follows the reference: its sublayers end in ``residual +
dropout(out)`` and a plain ``LayerNorm`` (the LayerNorm kernel), not the
fused epilogue. Its self-attention carries the causal mask of
``Transformer.generate_square_subsequent_mask`` (an (L, L) additive mask,
so the composed path); its cross-attention takes the kernel only when the
source and target lengths are equal and there is no ``memory_mask``, and
a decoding step (one query against a cache) is composed unless the cache
holds only that step.
"""
import collections
import copy
import math

import torch
from torch import nn

from ...device import resolve_device
from ...kernels.philox import DropoutState
from .. import functional as F
from .. import remat as _remat
from ..initializer import copy_param_attrs
from .common import Dropout, Linear
from .norm import LayerNorm

__all__ = ['MultiHeadAttention', 'TransformerEncoderLayer',
           'TransformerEncoder', 'TransformerDecoderLayer',
           'TransformerDecoder', 'Transformer']


class MultiHeadAttention(nn.Module):
    """Attention over ``embed_dim`` split into ``num_heads`` heads; keys
    and values may have their own widths (``kdim``, ``vdim``).

    ``cache=``: a ``Cache`` (the keys and values of the earlier steps,
    (B, T, H, D) each, to which this call's are appended; the new cache is
    returned) or a ``StaticCache`` (keys and values projected once, read
    in place of ``key``/``value``: the cross-attention of a decoding
    step); ``gen_cache`` makes either. ``need_weights=True`` adds ``None``
    to the outputs where the weights would go, as in the reference: the
    weights are not materialised on the kernel's path."""

    Cache = collections.namedtuple('Cache', ['k', 'v'])
    StaticCache = collections.namedtuple('StaticCache', ['k', 'v'])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, generator=None,
                 dropout_state=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"MultiHeadAttention: embed_dim {embed_dim} is "
                             f"not a multiple of num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        self.dropout_state = dropout_state
        # (heads of the dense model, first head held), the model axis: see
        # local_heads
        self.head_map = self.tp_axis = None
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                  device=device, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def local_heads(self, n, r, axis):
        """Run on heads ``r H/n .. (r + 1) H/n`` of the ``H`` heads (rank
        ``r`` of the ``n`` of model ``axis``, whose q/k/v projections yield
        those heads' columns): the dropout masks stay the dense model's,
        and each distinct input's gradient is summed over the axis once
        (``distributed.sharding._CopyToModel``)."""
        self.head_map = (self.num_heads, r * (self.num_heads // n))
        self.num_heads //= n
        self.tp_axis = axis

    def _heads(self, x):
        # every dim named: projections whose width is not num_heads x
        # head_dim (column-parallel ones left on all heads) fail here
        # instead of folding their width into the length
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def _prepare_qkv(self, query, key, value, cache=None):
        """-> q, k, v as (B, L, H, D) and the cache to hand back."""
        q = self._heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value))
        if isinstance(cache, self.Cache):
            k = torch.cat([cache.k, k], dim=1)
            v = torch.cat([cache.v, v], dim=1)
            cache = self.Cache(k, v)
        return q, k, v, cache

    def gen_cache(self, key, value=None, type=None):
        """``type=MultiHeadAttention.StaticCache``: ``key``/``value``
        projected once; otherwise an empty ``Cache`` of (B, 0, H, D) on
        ``key``'s device and dtype."""
        if type == MultiHeadAttention.StaticCache:
            value = key if value is None else value
            return self.StaticCache(self._heads(self.k_proj(key)),
                                    self._heads(self.v_proj(value)))
        z = key.new_zeros(key.shape[0], 0, self.num_heads, self.head_dim)
        return self.Cache(z, z)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        if self.tp_axis is not None:
            query, key, value = _copy_to_model((query, key, value),
                                               self.tp_axis)
        q, k, v, cache = self._prepare_qkv(query, key, value, cache)
        if attn_mask is not None and attn_mask.dtype != torch.bool:
            attn_mask = attn_mask.to(query.dtype)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout, training=self.training,
            dropout_state=self.dropout_state, head_map=self.head_map)
        out = self.out_proj(out.reshape(query.shape[0], query.shape[1],
                                        self.num_heads * self.head_dim))
        outs = [out]
        if self.need_weights:
            outs.append(None)
        if cache is not None:
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


class TransformerEncoderLayer(nn.Module):
    """Post-norm: ``norm1(src + drop(attn(src)))`` then ``norm2(h +
    drop(ffn(h)))``, each epilogue one fused call. Pre-norm
    (``normalize_before=True``): ``h = src + drop(attn(norm1(src)))`` then
    ``h + drop(ffn(norm2(h)))``. With ``cache=`` (of ``gen_cache``) the
    self-attention appends to it and the layer returns ``(out, cache)``."""

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

    def forward(self, src, src_mask=None, cache=None):
        x = self.norm1(src) if self.normalize_before else src
        if cache is None:
            attn = self.self_attn(x, x, x, src_mask)
        else:
            attn, cache = self.self_attn(x, x, x, src_mask, cache)
        h = self._sublayer_out(attn, src, self.dropout1, self.norm1)
        x = self.norm2(h) if self.normalize_before else h
        ffn = self.linear2(self.dropout(self.activation(self.linear1(x))))
        out = self._sublayer_out(ffn, h, self.dropout2, self.norm2)
        return out if cache is None else (out, cache)

    def _sublayer_out(self, src, residual, drop, norm):
        """Post-norm: ``norm(residual + drop(src))`` in one kernel;
        pre-norm: ``residual + drop(src)``, composed."""
        if self.normalize_before:
            return residual + drop(src)
        return F.fused_dropout_add_layer_norm(
            src, residual, norm.weight, norm.bias, dropout_p=drop.p,
            epsilon=norm.epsilon, training=self.training,
            dropout_state=drop.dropout_state)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer``; each copy after the
    first re-draws its matrices Xavier-uniform from ``generator``, as the
    reference's ``_clone_layer`` does, and keeps the first one's
    ``ParamAttr`` settings. The copies share the first layer's
    ``DropoutState``. ``norm``: an optional final ``LayerNorm``. With
    ``cache=`` (a list of each layer's cache) it returns ``(out,
    new_caches)``."""

    def __init__(self, encoder_layer, num_layers, norm=None, *,
                 generator=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [_clone_layer(encoder_layer, generator)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            new_caches = []
            for layer, c in zip(self.layers, cache):
                src, c = layer(src, src_mask, c)
                new_caches.append(c)
        else:
            remat = _remat.current() if torch.is_grad_enabled() else None
            for layer in self.layers:
                src = layer(src, src_mask) if remat is None else \
                    remat(layer, src, src_mask)
        if self.norm is not None:
            src = self.norm(src)
        return src if cache is None else (src, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    """Self-attention, cross-attention over ``memory``, then the FFN, each
    with ``residual + drop(out)`` and a ``LayerNorm`` after it (post-norm,
    the LayerNorm kernel) or on its input (``normalize_before=True``), as
    in the reference: the decoder's epilogues are not fused.
    ``cache=(Cache, StaticCache)`` of ``gen_cache``: the self-attention
    appends to the first, the cross-attention reads the projected memory
    from the second, and the layer returns ``(out, (cache, static))``."""

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
        self.cross_attn = MultiHeadAttention(d_model, nhead,
                                             dropout=attn_dropout,
                                             dropout_state=state, **attrs,
                                             **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **attrs, **kw)
        self.dropout = Dropout(act_dropout, dropout_state=state)
        self.linear2 = Linear(dim_feedforward, d_model, **attrs, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout, dropout_state=state)
        self.dropout2 = Dropout(dropout, dropout_state=state)
        self.dropout3 = Dropout(dropout, dropout_state=state)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        incr, static = (None, None) if cache is None else cache
        x = self.norm1(tgt) if self.normalize_before else tgt
        if cache is None:
            x = self.self_attn(x, x, x, tgt_mask)
        else:
            x, incr = self.self_attn(x, x, x, tgt_mask, incr)
        tgt = self._residual(tgt, x, self.dropout1, self.norm1)
        x = self.norm2(tgt) if self.normalize_before else tgt
        if cache is None:
            x = self.cross_attn(x, memory, memory, memory_mask)
        else:
            x, static = self.cross_attn(x, memory, memory, memory_mask,
                                        static)
        tgt = self._residual(tgt, x, self.dropout2, self.norm2)
        x = self.norm3(tgt) if self.normalize_before else tgt
        x = self.linear2(self.dropout(self.activation(self.linear1(x))))
        tgt = self._residual(tgt, x, self.dropout3, self.norm3)
        return tgt if cache is None else (tgt, (incr, static))

    def _residual(self, residual, out, drop, norm):
        """``residual + drop(out)``, normalised after (post-norm)."""
        out = residual + drop(out)
        return out if self.normalize_before else norm(out)

    def gen_cache(self, memory):
        """-> (an empty ``Cache`` for the self-attention, a
        ``StaticCache`` of ``memory`` projected for the cross-attention)."""
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(memory, memory,
                                          MultiHeadAttention.StaticCache))


class TransformerDecoder(nn.Module):
    """``num_layers`` copies of ``decoder_layer`` (re-drawn as in
    ``TransformerEncoder``), an optional final ``norm``; with ``cache=``
    (``gen_cache``'s list) it returns ``(out, new_caches)``."""

    def __init__(self, decoder_layer, num_layers, norm=None, *,
                 generator=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [decoder_layer] + [_clone_layer(decoder_layer, generator)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                tgt = layer(tgt, memory, tgt_mask, memory_mask)
            else:
                tgt, c = layer(tgt, memory, tgt_mask, memory_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            tgt = self.norm(tgt)
        return tgt if cache is None else (tgt, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """Each layer's ``(Cache, StaticCache)``; ``do_zip=True`` zips
        them into ``[(caches...), (static caches...)]``, as upstream
        Paddle does (the reference ignores ``do_zip``)."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*cache)) if do_zip else cache


class Transformer(nn.Module):
    """Encoder-decoder: ``decoder(tgt, encoder(src, src_mask), tgt_mask,
    memory_mask)``. Pre-norm models get a final ``LayerNorm`` on each
    stack, as in the reference. Every dropout site draws from
    ``dropout_state``; without one the model makes its own, seeded from
    ``generator`` after the weights (``generator`` defaults to one on the
    device seeded with 0)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation='relu', attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 generator=None, dropout_state=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        own_state = dropout_state is None
        self.dropout_state = DropoutState(0) if own_state else dropout_state
        kw = dict(device=device, generator=generator)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            layer = TransformerEncoderLayer(
                *args, dropout_state=self.dropout_state, **kw)
            norm = LayerNorm(d_model, device=device) if normalize_before \
                else None
            self.encoder = TransformerEncoder(layer, num_encoder_layers, norm,
                                              generator=generator)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            layer = TransformerDecoderLayer(
                *args, dropout_state=self.dropout_state, **kw)
            norm = LayerNorm(d_model, device=device) if normalize_before \
                else None
            self.decoder = TransformerDecoder(layer, num_decoder_layers, norm,
                                              generator=generator)
        self.d_model = d_model
        self.nhead = nhead
        if own_state:
            self.dropout_state.seed = DropoutState.from_generator(
                generator).seed

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """(length, length) fp32 additive mask: 0 on and below the
        diagonal, -1e9 above it."""
        ones = torch.ones(length, length, device=resolve_device(device))
        return (ones.tril() - 1.0) * 1e9


def _copy_to_model(inputs, axis):
    """The attention's inputs, each distinct one through one
    ``_CopyToModel`` (its gradient summed over the model axis)."""
    from ...distributed.sharding import _CopyToModel
    done = {}
    for x in inputs:
        if id(x) not in done:
            done[id(x)] = _CopyToModel.apply(x, axis)
    return tuple(done[id(x)] for x in inputs)


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
