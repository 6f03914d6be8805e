"""Transformer layers and language model of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/nn/transformer.py``, with the same
structure, signatures, prefixes and parameter names
(``transformerlm0_enc_layers_transformerencodercell0_attn_qkv_weight``),
so weights and exported files carried across mean the same thing:

- the packed QKV projection ``(B, S, 3U)`` is read as ``(B, S, 3H, d)``:
  heads ``0..H-1`` are q, ``H..2H-1`` k, ``2H..3H-1`` v;
- attention runs through the registered ``_contrib_flash_attention``
  (:func:`~mxnet_tpu_torch.ops.attention.flash_attention`, the
  hand-written CUDA kernels on the card);
- layers are pre-LN; the token embedding is scaled by ``sqrt(units)``;
  positions are learned; the logits layer has no bias.

Each layer's ``hybrid_forward`` calls the registered ops through
:class:`~mxnet_tpu_torch.gluon.BoundOp`: on tensors the functions
themselves, on a Symbol the JAX package's nodes (``Reshape``,
``transpose``, ``slice_axis``, ``_contrib_flash_attention``,
``arange_like``, ``_mul_scalar``, ``elemwise_add``, ...), so
:meth:`~mxnet_tpu_torch.gluon.HybridBlock.export` writes the graph the
JAX package writes.
"""

from __future__ import annotations

import math

import torch

from ..block import BoundOp, HybridBlock
from .basic_layers import Dense, Dropout, Embedding, HybridSequential, LayerNorm

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell",
           "TransformerEncoder", "TransformerLM"]


class _Layer(HybridBlock):
    """A transformer layer of the port (``prefix`` and ``params`` as the
    JAX package's ``**kwargs``; ``device`` where its parameters are
    made)."""

    _port_native = True

    def __init__(self, prefix, params, device):
        super().__init__(prefix=prefix, params=params, device=device)


class MultiHeadAttention(_Layer):
    """Self-attention: one packed QKV projection, flash attention, output
    projection; dropout on the projected output."""

    def __init__(self, units, num_heads, dropout=0.0, causal=False,
                 use_bias=True, *, prefix=None, params=None, device=None):
        super().__init__(prefix, params, device)
        if units % num_heads:
            raise ValueError("units %d not divisible by num_heads %d"
                             % (units, num_heads))
        self._units = units
        self._num_heads = num_heads
        self._causal = causal
        h, d, dev = num_heads, units // num_heads, self.device
        self._split = BoundOp("Reshape", shape=(0, 0, 3 * h, d))
        self._swap = BoundOp("transpose", axes=(0, 2, 1, 3))
        self._heads = [BoundOp("slice_axis", axis=1, begin=i * h,
                               end=(i + 1) * h) for i in range(3)]
        self._attn = BoundOp("_contrib_flash_attention", causal=causal)
        self._merge = BoundOp("Reshape", shape=(0, 0, units))
        with self.name_scope():
            self.qkv = Dense(3 * units, flatten=False, use_bias=use_bias,
                             in_units=units, prefix="qkv_", device=dev)
            self.proj = Dense(units, flatten=False, use_bias=use_bias,
                              in_units=units, prefix="proj_", device=dev)
            self.drop = Dropout(dropout, device=dev) if dropout else None

    def hybrid_forward(self, F, x):
        qkv = self._swap(F, self._split(F, self.qkv(x)))   # (B, 3H, S, d)
        q, k, v = (head(F, qkv) for head in self._heads)
        o = self._swap(F, self._attn(F, q, k, v))          # (B, S, H, d)
        o = self.proj(self._merge(F, o))
        return self.drop(o) if self.drop is not None else o


class PositionwiseFFN(_Layer):
    """Two-layer MLP; ``activation`` "gelu" (the exact one, a
    ``LeakyReLU`` node) or any ``Activation`` type in between."""

    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 *, prefix=None, params=None, device=None):
        super().__init__(prefix, params, device)
        dev = self.device
        self.act = activation
        self._act = BoundOp("LeakyReLU", act_type="gelu") \
            if activation == "gelu" else BoundOp("Activation",
                                                 act_type=activation)
        with self.name_scope():
            self.ffn1 = Dense(hidden_size, flatten=False, in_units=units,
                              prefix="ffn1_", device=dev)
            self.ffn2 = Dense(units, flatten=False, in_units=hidden_size,
                              prefix="ffn2_", device=dev)
            self.drop = Dropout(dropout, device=dev) if dropout else None

    def hybrid_forward(self, F, x):
        out = self.ffn2(self._act(F, self.ffn1(x)))
        return self.drop(out) if self.drop is not None else out


class TransformerEncoderCell(_Layer):
    """Pre-LN transformer layer: x + MHA(LN(x)); x + FFN(LN(x))."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 causal=False, *, prefix=None, params=None, device=None):
        super().__init__(prefix, params, device)
        dev = self.device
        with self.name_scope():
            self.ln1 = LayerNorm(in_channels=units, prefix="ln1_",
                                 device=dev)
            self.attn = MultiHeadAttention(units, num_heads, dropout=dropout,
                                           causal=causal, prefix="attn_",
                                           device=dev)
            self.ln2 = LayerNorm(in_channels=units, prefix="ln2_",
                                 device=dev)
            self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout,
                                       prefix="ffn_", device=dev)

    def hybrid_forward(self, F, x):
        x = x + self.attn(self.ln1(x))
        return x + self.ffn(self.ln2(x))


class TransformerEncoder(_Layer):
    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, causal=False, *, prefix=None, params=None,
                 device=None):
        super().__init__(prefix, params, device)
        dev = self.device
        with self.name_scope():
            self.layers = HybridSequential(prefix="layers_", device=dev)
            with self.layers.name_scope():
                for _ in range(num_layers):
                    self.layers.add(TransformerEncoderCell(
                        units, hidden_size, num_heads, dropout=dropout,
                        causal=causal, device=dev))

    def hybrid_forward(self, F, x):
        return self.layers(x)


class TransformerLM(_Layer):
    """Decoder-only (causal) transformer language model.

    Input: (batch, seq) token ids of any numeric dtype (the server hands
    them over as float32, exact below 2**24) -> logits (batch, seq, vocab)
    float32."""

    def __init__(self, vocab_size, units=512, num_layers=4, num_heads=8,
                 hidden_size=None, max_length=2048, dropout=0.0, *,
                 prefix=None, params=None, device=None):
        super().__init__(prefix, params, device)
        hidden_size = hidden_size or 4 * units
        self._units = units
        self._max_length = max_length
        dev = self.device
        if dev.type == "cuda":
            # the logits are held to float32 tolerance: no TF32 products
            torch.backends.cuda.matmul.allow_tf32 = False
        self._first_row = BoundOp("slice_axis", axis=0, begin=0, end=1)
        self._positions = BoundOp("arange_like", axis=1)
        with self.name_scope():
            self.embed = Embedding(vocab_size, units, prefix="embed_",
                                   device=dev)
            self.pos_embed = Embedding(max_length, units, prefix="pos_",
                                       device=dev)
            self.drop = Dropout(dropout, device=dev) if dropout else None
            self.encoder = TransformerEncoder(
                num_layers, units, hidden_size, num_heads, dropout=dropout,
                causal=True, prefix="enc_", device=dev)
            self.ln_f = LayerNorm(in_channels=units, prefix="lnf_",
                                  device=dev)
            self.logits = Dense(vocab_size, flatten=False, in_units=units,
                                use_bias=False, prefix="logits_", device=dev)

    def hybrid_forward(self, F, x):
        # token and learned position embeddings
        emb = self.embed(x) * math.sqrt(self._units)
        pos = self._positions(F, self._first_row(F, x))
        emb = emb + self.pos_embed(pos)
        if self.drop is not None:
            emb = self.drop(emb)
        out = self.encoder(emb)
        return self.logits(self.ln_f(out))
