"""Transformer layers and language model of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/nn/transformer.py``, with the same
structure, parameter names and layouts, so weights carried across mean the
same thing:

- the packed QKV projection ``(B, S, 3U)`` is read as ``(B, S, 3H, d)``:
  heads ``0..H-1`` are q, ``H..2H-1`` k, ``2H..3H-1`` v;
- attention runs through :func:`~mxnet_tpu_torch.ops.attention.flash_attention`
  (the hand-written CUDA kernel on the card);
- layers are pre-LN; the token embedding is scaled by ``sqrt(units)``;
  positions are learned; the logits layer has no bias.
"""

from __future__ import annotations

import math

import torch

from ...ops import matrix as F
from ...ops import nn as _ops
from ...ops.attention import flash_attention
from ..block import HybridBlock
from .basic_layers import Dense, Dropout, Embedding, HybridSequential, LayerNorm

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell",
           "TransformerEncoder", "TransformerLM"]


class MultiHeadAttention(HybridBlock):
    """Self-attention: one packed QKV projection, flash attention, output
    projection; dropout on the projected output."""

    def __init__(self, units, num_heads, dropout=0.0, causal=False,
                 device=None):
        super().__init__(device=device)
        if units % num_heads:
            raise ValueError("units %d not divisible by num_heads %d"
                             % (units, num_heads))
        self._units = units
        self._num_heads = num_heads
        self._causal = causal
        dev = self.device
        self.qkv = Dense(3 * units, flatten=False, in_units=units, device=dev)
        self.proj = Dense(units, flatten=False, in_units=units, device=dev)
        self.drop = Dropout(dropout, device=dev) if dropout else None

    def forward(self, x):
        h, u = self._num_heads, self._units
        d = u // h
        qkv = self.qkv(x)                                   # (B, S, 3U)
        qkv = F.reshape(qkv, (0, 0, 3 * h, d))
        qkv = F.transpose(qkv, (0, 2, 1, 3))                # (B, 3H, S, d)
        q, k, v = (F.slice_axis(qkv, 1, i * h, (i + 1) * h).contiguous()
                   for i in range(3))
        o = flash_attention(q, k, v, causal=self._causal)
        o = F.transpose(o, (0, 2, 1, 3))                    # (B, S, H, d)
        o = self.proj(F.reshape(o, (0, 0, u)))
        return self.drop(o) if self.drop is not None else o


class PositionwiseFFN(HybridBlock):
    """Two-layer MLP with an exact gelu in between."""

    def __init__(self, units, hidden_size, dropout=0.0, device=None):
        super().__init__(device=device)
        dev = self.device
        self.ffn1 = Dense(hidden_size, flatten=False, in_units=units,
                          device=dev)
        self.ffn2 = Dense(units, flatten=False, in_units=hidden_size,
                          device=dev)
        self.drop = Dropout(dropout, device=dev) if dropout else None

    def forward(self, x):
        out = self.ffn2(_ops.leaky_relu(self.ffn1(x), act_type="gelu"))
        return self.drop(out) if self.drop is not None else out


class TransformerEncoderCell(HybridBlock):
    """Pre-LN transformer layer: x + MHA(LN(x)); x + FFN(LN(x))."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 causal=False, device=None):
        super().__init__(device=device)
        dev = self.device
        self.ln1 = LayerNorm(in_channels=units, device=dev)
        self.attn = MultiHeadAttention(units, num_heads, dropout=dropout,
                                       causal=causal, device=dev)
        self.ln2 = LayerNorm(in_channels=units, device=dev)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout,
                                   device=dev)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.ffn(self.ln2(x))


class TransformerEncoder(HybridBlock):
    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, causal=False, device=None):
        super().__init__(device=device)
        self.layers = HybridSequential(device=self.device)
        for _ in range(num_layers):
            self.layers.add(TransformerEncoderCell(
                units, hidden_size, num_heads, dropout=dropout,
                causal=causal, device=self.device))

    def forward(self, x):
        return self.layers(x)


class TransformerLM(HybridBlock):
    """Decoder-only (causal) transformer language model.

    Input: (batch, seq) token ids of any numeric dtype (the server hands
    them over as float32, exact below 2**24) -> logits (batch, seq, vocab)
    float32."""

    def __init__(self, vocab_size, units=512, num_layers=4, num_heads=8,
                 hidden_size=None, max_length=2048, dropout=0.0, device=None):
        super().__init__(device=device)
        hidden_size = hidden_size or 4 * units
        self._units = units
        dev = self.device
        if dev.type == "cuda":
            # the logits are held to float32 tolerance: no TF32 products
            torch.backends.cuda.matmul.allow_tf32 = False
        self.embed = Embedding(vocab_size, units, device=dev)
        self.pos_embed = Embedding(max_length, units, device=dev)
        self.drop = Dropout(dropout, device=dev) if dropout else None
        self.encoder = TransformerEncoder(
            num_layers, units, hidden_size, num_heads, dropout=dropout,
            causal=True, device=dev)
        self.ln_f = LayerNorm(in_channels=units, device=dev)
        self.logits = Dense(vocab_size, flatten=False, in_units=units,
                            use_bias=False, device=dev)

    def forward(self, x):
        emb = self.embed(x) * math.sqrt(self._units)
        pos = F.arange_like(F.slice_axis(x, 0, 0, 1), axis=1)
        emb = emb + self.pos_embed(pos)
        if self.drop is not None:
            emb = self.drop(emb)
        out = self.encoder(emb)
        return self.logits(self.ln_f(out))
