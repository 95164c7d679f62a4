"""BERT in PyTorch (counterpart of ``mxnet_tpu/models/bert.py``).

Same layers, same post-LN encoder, same two attention routes:

- unmasked, dropout-free attention goes through
  ``ops.contrib.flash_attention`` (the hand-written CUDA kernel on a GPU);
- a ``valid_mask`` or attention dropout takes the dense route, with an
  additive -1e30 on padded keys.

Under AMP the attention products and the masked-LM decoder's product take
the policy of the ops the JAX package calls there (``batch_dot``, ``dot``:
bf16) and the dense route's softmax that of ``softmax`` (fp32).

The route rule is the reference's (``blockwise_ok`` reads the dropout rate
set at construction, not the training mode), so both packages take the same
route for the same model.  The sequence-parallel route is not ported.
"""
from __future__ import annotations

import math

import torch

from ..context import as_device
from ..gluon import HybridBlock, nn
from ..ops import contrib
from ..ops import nn as ops
from ..ops.registry import amp_inputs

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell",
           "BERTEncoder", "BERTModel", "BERTClassifier", "get_bert_model"]


class MultiHeadAttention(HybridBlock):
    """Self-attention with a fused QKV projection, (B, H, T, D) heads."""

    def __init__(self, units, num_heads, dropout=0.0, device=None):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units={units} not divisible by "
                             f"num_heads={num_heads}")
        self._units = units
        self._num_heads = num_heads
        self.qkv = nn.Dense(units * 3, flatten=False, in_units=units,
                            device=device)
        self.proj = nn.Dense(units, flatten=False, in_units=units,
                             device=device)
        self.dropout = nn.Dropout(dropout)

    def _split_heads(self, x):
        # (B, T, C) -> (B, H, T, C/H), contiguous as the kernel takes it
        b, t, _ = x.shape
        return x.reshape(b, t, self._num_heads, -1).transpose(1, 2) \
            .contiguous()

    def forward(self, x, mask=None):
        b, t, _ = x.shape
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        q = self._split_heads(q) * (1.0 / math.sqrt(self._units //
                                                    self._num_heads))
        k = self._split_heads(k)
        v = self._split_heads(v)
        if mask is None and not self.dropout._rate:
            ctx = contrib.flash_attention(q, k, v, scale=1.0)
        else:
            qd, kd = amp_inputs("batch_dot", q, k)
            scores = torch.matmul(qd, kd.transpose(-1, -2))  # (B, H, T, T)
            if mask is not None:
                # mask: (B, T), 1 = valid -> additive -1e30 on padded keys,
                # in the mask's float type as the JAX package adds it
                neg = (1.0 - mask.float()) * -1e30
                scores = scores + neg[:, None, None, :]
            scores, = amp_inputs("softmax", scores)
            attn = self.dropout(ops.softmax(scores, axis=-1))
            attn, vd = amp_inputs("batch_dot", attn, v)
            ctx = torch.matmul(attn, vd)
        return self.proj(ctx.transpose(1, 2).reshape(b, t, self._units))


class PositionwiseFFN(HybridBlock):
    """Dense -> GELU -> Dense with residual + LayerNorm."""

    def __init__(self, units, hidden_size, dropout=0.0, device=None):
        super().__init__()
        self.ffn_1 = nn.Dense(hidden_size, flatten=False, in_units=units,
                              device=device)
        self.activation = nn.GELU()
        self.ffn_2 = nn.Dense(units, flatten=False, in_units=hidden_size,
                              device=device)
        self.dropout = nn.Dropout(dropout)
        self.layer_norm = nn.LayerNorm(in_channels=units, device=device)

    def forward(self, x):
        out = self.dropout(self.ffn_2(self.activation(self.ffn_1(x))))
        return self.layer_norm(out + x)


class TransformerEncoderCell(HybridBlock):
    """Post-LN transformer layer (BERT convention)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 device=None):
        super().__init__()
        self.attention = MultiHeadAttention(units, num_heads, dropout,
                                            device=device)
        self.attn_dropout = nn.Dropout(dropout)
        self.attn_norm = nn.LayerNorm(in_channels=units, device=device)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                   device=device)

    def forward(self, x, mask=None):
        out = self.attention(x, mask)
        x = self.attn_norm(self.attn_dropout(out) + x)
        return self.ffn(x)


class BERTEncoder(HybridBlock):
    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, dropout=0.1, device=None):
        super().__init__()
        self.layers = nn.HybridSequential()
        for _ in range(num_layers):
            self.layers.add(TransformerEncoderCell(
                units, hidden_size, num_heads, dropout, device=device))

    def forward(self, x, mask=None):
        for cell in self.layers:
            x = cell(x, mask)
        return x


class BERTModel(HybridBlock):
    """BERT backbone + pretraining heads.

    ``forward(token_ids, segment_ids, valid_mask, masked_positions)`` ->
    ``(sequence_output, pooled_output[, mlm_scores][, nsp_scores])``; the
    masked-LM decoder is weight-tied to the word embedding.  ``device=None``
    means the GPU (see ``context.default_device``).
    """

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 token_type_vocab_size=2, dropout=0.1, use_pooler=True,
                 use_decoder=True, use_classifier=True, device=None):
        super().__init__()
        device = as_device(device)
        self._units = units
        self.use_pooler = use_pooler
        self.use_decoder = use_decoder
        self.use_classifier = use_classifier
        self.word_embed = nn.Embedding(vocab_size, units, device=device)
        self.token_type_embed = nn.Embedding(token_type_vocab_size, units,
                                             device=device)
        self.position_embed = nn.Embedding(max_length, units, device=device)
        self.embed_norm = nn.LayerNorm(in_channels=units, device=device)
        self.embed_dropout = nn.Dropout(dropout)
        self.encoder = BERTEncoder(num_layers, units, hidden_size, num_heads,
                                   dropout, device=device)
        if use_pooler:
            self.pooler = nn.Dense(units, activation="tanh", flatten=False,
                                   in_units=units, device=device)
        if use_decoder:
            self.decoder_transform = nn.Dense(units, flatten=False,
                                              in_units=units, device=device)
            self.decoder_act = nn.GELU()
            self.decoder_norm = nn.LayerNorm(in_channels=units, device=device)
            self.decoder_bias = torch.nn.Parameter(
                torch.empty(vocab_size, device=device))
        if use_classifier:
            self.nsp_classifier = nn.Dense(2, flatten=False, in_units=units,
                                           device=device)

    def forward(self, inputs, token_types=None, valid_mask=None,
                masked_positions=None):
        t = inputs.shape[1]
        x = self.word_embed(inputs)
        positions = torch.arange(t, device=inputs.device)
        x = x + self.position_embed(positions)[None]
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = self.embed_dropout(self.embed_norm(x))
        seq_out = self.encoder(x, valid_mask)
        outputs = [seq_out]
        if self.use_pooler:
            outputs.append(self.pooler(seq_out[:, 0, :]))
        if self.use_decoder and masked_positions is not None:
            idx = masked_positions.long()[:, :, None].expand(
                -1, -1, seq_out.shape[-1])
            picked = torch.gather(seq_out, 1, idx)          # (B, M, C)
            h = self.decoder_norm(self.decoder_act(
                self.decoder_transform(picked)))
            hd, w = amp_inputs("dot", h, self.word_embed.weight)
            outputs.append(torch.matmul(hd, w.t()) + self.decoder_bias)
        if self.use_classifier and self.use_pooler:
            outputs.append(self.nsp_classifier(outputs[1]))
        return tuple(outputs) if len(outputs) > 1 else outputs[0]


class BERTClassifier(HybridBlock):
    """Sentence-pair classification head over the pooled output."""

    def __init__(self, bert, num_classes=2, dropout=0.1):
        super().__init__()
        self.bert = bert
        device = bert.word_embed.weight.device
        self.classifier = nn.HybridSequential()
        self.classifier.add(nn.Dropout(dropout))
        self.classifier.add(nn.Dense(num_classes, flatten=False,
                                     in_units=bert._units, device=device))

    def forward(self, inputs, token_types=None, valid_mask=None):
        _, pooled = self.bert(inputs, token_types, valid_mask)[:2]
        return self.classifier(pooled)


_BERT_CONFIGS = {
    "bert_tiny":  dict(units=128, hidden_size=512, num_layers=2, num_heads=2),
    "bert_mini":  dict(units=256, hidden_size=1024, num_layers=4, num_heads=4),
    "bert_small": dict(units=512, hidden_size=2048, num_layers=4, num_heads=8),
    "bert_base":  dict(units=768, hidden_size=3072, num_layers=12,
                       num_heads=12),
    "bert_large": dict(units=1024, hidden_size=4096, num_layers=24,
                       num_heads=16),
}


def get_bert_model(model_name="bert_base", vocab_size=30522, max_length=512,
                   dropout=0.1, device=None, **kwargs):
    """A :class:`BERTModel` of a named size, uninitialised (call
    ``initialize(generator=...)`` or load a state dict).  ``device=None``
    means the GPU; pass ``device="cpu"`` for the CPU."""
    cfg = dict(_BERT_CONFIGS[model_name])
    cfg.update(kwargs)
    return BERTModel(vocab_size=vocab_size, max_length=max_length,
                     dropout=dropout, device=device, **cfg)
