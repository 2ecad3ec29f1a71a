"""The encoder-decoder tutorial translator (port of musicgen_tpu/models/seq2seq.py;
reference models/transformer/simple_transformer.py, a TransformerTranslator
vendored from a tutorial that no reference path imports, but part of its
surface).

    model = registry.new_model("seq2seq", Seq2SeqConfig(), device)
    registry.init_model(model, "seq2seq", seed)
    memory = model.encode(src)           # (B, S, D), once
    logp = model.decode(memory, prefix)  # (B, 1, V) log-probs of the next token

No kernel: the JAX model is Dense / DenseGeneral / Embed, einsum and softmax,
all plain XLA, so the port is plain PyTorch ops on any device. The weights'
keys are the port's own (the JAX package has no torch layout for this
model): the flax module paths with `enc_{i}` / `dec_{i}` as
`enc_blocks.{i}` / `dec_blocks.{i}` and `TutorialLayerNorm_0` as `norm`;
`interop.seq2seq_state_dict` maps JAX's params onto them.

The reference's quirks define this model family and are kept (the JAX
docstring cites each line of simple_transformer.py):
  * attention is unmasked everywhere, scaled by 1/sqrt(Dh); causality comes
    only from the decoder querying the last position of the output prefix;
  * TutorialLayerNorm is scale * (x - mean) / ((std + eps) + shift), with
    the Bessel-corrected std: the learned shift lands in the divisor;
  * embeddings are scaled by sqrt(D), and the encoder adds the positional
    table twice (once with the embedding, once more in the encoder);
  * the table multiplies the position by 10000^(i/d) (not 10000^(-i/d));
  * the FFN applies ReLU twice (idempotent);
  * the decoder's one `dec_self` attention, with its norm, serves every
    block, and after the first block x is (B, 1, D);
  * the head returns log_softmax.
Dropout acts only in train() mode; a caller that passes `generator` gets
its masks from that generator (on the tensors' device).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Seq2SeqConfig  # defined beside the other configs; imported from here as in JAX


def sinusoid_table(max_len: int, d: int) -> torch.Tensor:
    """(max_len, d) f32 positional table on the CPU: sin(pos * 10000^(i/d)) in
    the even columns, cos(pos * 10000^(i/d)) in the odd ones (i the column).

    The arguments reach max_len * 10000^((d-1)/d), 4.6e7 at the defaults,
    where one ulp of the multiplier moves the argument by several radians.
    So each multiplier is the correctly rounded f32 of 10000^(i/d) (the power
    in f64, rounded once), as XLA's f32 power gives it at every column of
    d = 256; torch's f32 power is one ulp off at one of them. The products
    and sines are f32, as in the JAX function."""
    pos = torch.arange(max_len, dtype=torch.float32, device="cpu")[:, None]

    def multiplier(start: int) -> torch.Tensor:
        exponent = torch.arange(start, d, 2, dtype=torch.float32, device="cpu") / d
        return torch.pow(10000.0, exponent.double()).float()

    pe = torch.zeros(max_len, d, dtype=torch.float32, device="cpu")
    pe[:, 0::2] = torch.sin(pos * multiplier(0)[None, :])
    pe[:, 1::2] = torch.cos(pos * multiplier(1)[None, :])
    return pe


def _dropout(x: torch.Tensor, p: float, training: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1 - p and scale the kept values
    by 1 / (1 - p); the identity outside train() mode."""
    if not training or p == 0.0:
        return x
    if generator is None:
        return F.dropout(x, p, True)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class TutorialLayerNorm(nn.Module):
    """scale * (x - mean) / ((std + eps) + shift), std Bessel-corrected
    (torch's x.std(-1), as the reference computes it)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.features, self.eps = features, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.shift = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, correction=0, keepdim=True) * (self.features / (self.features - 1))
        return self.scale * (x - mean) / ((var.sqrt() + self.eps) + self.shift)


class MultiHeadAttention(nn.Module):
    """Unmasked scaled-dot attention over all heads at once, then dropout and
    the post-norm residual add: norm(attention + residual_x)."""

    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.query, self.key, self.value = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)
        self.norm = TutorialLayerNorm(d)

    def forward(self, query_in: torch.Tensor, key_in: torch.Tensor, value_in: torch.Tensor,
                residual_x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.cfg
        dh = c.embed_dim // c.num_heads

        def heads(proj: nn.Linear, x: torch.Tensor) -> torch.Tensor:
            return proj(x).view(*x.shape[:2], c.num_heads, dh)

        q, k, v = heads(self.query, query_in), heads(self.key, key_in), heads(self.value, value_in)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
        o = torch.einsum("bhqk,bkhd->bqhd", w.softmax(-1), v).reshape(*q.shape[:2], c.embed_dim)
        o = _dropout(o, c.dropout, self.training, generator)
        return self.norm(o + residual_x)


class FeedForward(nn.Module):
    """relu(relu(l1(x))) -> l2 -> dropout -> norm(. + residual_x)."""

    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.cfg = cfg
        self.l1, self.l2 = nn.Linear(cfg.embed_dim, cfg.embed_dim), nn.Linear(cfg.embed_dim, cfg.embed_dim)
        self.norm = TutorialLayerNorm(cfg.embed_dim)

    def forward(self, x: torch.Tensor, residual_x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.relu(F.relu(self.l1(x)))
        h = _dropout(self.l2(h), self.cfg.dropout, self.training, generator)
        return self.norm(h + residual_x)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.mha, self.ff = MultiHeadAttention(cfg), FeedForward(cfg)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, residual_x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        a = self.mha(query, key, value, residual_x, generator)
        return self.ff(a, a, generator)


class Seq2SeqTransformer(nn.Module):
    """encode(src) -> memory (B, S, D); decode(memory, out_prefix) -> (B, 1, V)
    log-probs of the token after the prefix; forward(src, out) both."""

    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.cfg = c = cfg
        self.src_embed = nn.Embedding(c.encoder_vocab_size, c.embed_dim)
        self.out_embed = nn.Embedding(c.output_vocab_size, c.embed_dim)
        self.register_buffer("pe", sinusoid_table(c.max_len, c.embed_dim), persistent=False)
        self.enc_blocks = nn.ModuleList(TransformerBlock(c) for _ in range(c.num_blocks))
        self.dec_self = MultiHeadAttention(c)
        self.dec_blocks = nn.ModuleList(TransformerBlock(c) for _ in range(c.num_blocks))
        self.vocab_logits = nn.Linear(c.embed_dim, c.output_vocab_size)

    def _embed(self, table: nn.Embedding, tokens: torch.Tensor) -> torch.Tensor:
        return table(tokens) * math.sqrt(self.cfg.embed_dim) + self.pe[None, :tokens.shape[1]]

    def encode(self, src: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self._embed(self.src_embed, src) + self.pe[None, :src.shape[1]]  # the table a second time
        for blk in self.enc_blocks:
            x = blk(x, x, x, x, generator)
        return x

    def decode(self, memory: torch.Tensor, out_prefix: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self._embed(self.out_embed, out_prefix)
        for blk in self.dec_blocks:
            q = x[:, -1:, :]
            a = self.dec_self(q, x, x, q, generator)  # the one shared module; x is (B, 1, D) after block 0
            x = blk(a, memory, memory, a, generator)
        return F.log_softmax(self.vocab_logits(x), dim=-1)

    def forward(self, src: torch.Tensor, out: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.decode(self.encode(src, generator), out, generator)


def empty_model(cfg: Seq2SeqConfig, device: torch.device | str,
                dtype: torch.dtype = torch.float32) -> Seq2SeqTransformer:
    """An uninitialised Seq2SeqTransformer on `device` (built on the meta
    device), its positional table filled. The model computes in f32 only,
    as the JAX model (which has no dtype)."""
    if dtype != torch.float32:
        raise ValueError(f"the seq2seq model computes in float32 only, not {dtype}")
    with torch.device("meta"):
        model = Seq2SeqTransformer(cfg)
    model = model.to_empty(device=device)
    model.pe.copy_(sinusoid_table(cfg.max_len, cfg.embed_dim))
    return model


@torch.no_grad()
def init_weights_(model: Seq2SeqTransformer, seed: int) -> Seq2SeqTransformer:
    """Random weights from `seed`, drawn on the CPU (the same numbers on any
    device), at the scales of the flax initializers: Linear weights
    N(0, 1/fan_in), embeddings N(0, 1/D) (nn.Embed's default), zero biases,
    unit norm scales and zero shifts."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith(".scale"):
            p.fill_(1.0)
        elif name.endswith((".shift", ".bias")):
            p.zero_()
        else:  # a Linear's (out, in) weight or an Embedding's (V, D) table
            p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p.shape[1]))
    return model
