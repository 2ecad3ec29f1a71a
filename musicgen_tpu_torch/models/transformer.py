"""Composer-conditioned decoder-only Transformer with relative-position
attention, in PyTorch.

Port of musicgen_tpu/models/transformer.py (reference
models/transformer/model_transformer.py:136-168): tokens -> embed; the 6
metadata tokens -> embed, PREPENDED along the sequence; n_layer pre-LN blocks
{multi-head rel-pos attention, 4x ReLU FFN}; final LayerNorm (eps 1e-6, flax's
default, as the JAX package); lm_head; logits sliced to the last T positions.
Quirks kept: the softmax scale n_embd**-0.5, the always-visible first 6
columns, per-head learnable rel_pos_emb of seq_len = block_len + 6 rows.

Parameters follow the reference's `state_dict` layout (per-head
`sa.heads.{h}.{query,key,value}.weight` and `sa.heads.{h}.rel_pos_emb`,
`sa.proj`, `ffwd.net.0`/`ffwd.net.2`, `token_embedding_table`,
`metadata_embedding_table`, `ln_f`, `lm_head`), so a reference `.pth` loads
with `load_state_dict(strict=True)` once its `.tril` buffers are dropped
(interop.load_checkpoint). The per-head weights are concatenated once per
call and run as one product.

Attention dispatch: with attention_impl 'flash', or 'auto' on CUDA, `prefill`
(and `forward` with grad mode off) runs kernel D (ops/attention_kernel), and
`forward` with grad mode on runs flash_relpos_attention_train (kernel D with
its LSE output forward, kernel E backward); 'xla' and 'torch_exact' (and
'auto' on the CPU) run the plain ops/attention.relpos_attention. The dense
projections stay `torch` matmuls, as the JAX package left them to XLA. `step`
is the plain ring-KV decode step; kernel F (ops/tdecode_kernel) is its fused
counterpart.

Training, as the JAX model: dropout at cfg.dropout on the attended values
(not the probabilities; the fusable form with the same expectation), after
the attention's out-projection and after the FFN's second linear, active in
`train()` only and never in `prefill` / `step`; cfg.remat recomputes each
block in the backward pass (torch.utils.checkpoint). Dropout modules hold no
state, so reference `.pth` files still load strictly.

`dtype` is the compute dtype (models/compute.py; f32 by default, bf16 for
cli.train --bf16), with the JAX model's casts: the embeddings, the q/k/v,
proj, fc and out products and the LayerNorms' outputs in the dtype, the rel
table cast to it; the plain attention's softmax in f32, cast back to v's
dtype; kernels D and E upcast their bf16 inputs to f32 and return the
input's dtype, as the TPU wrapper does; the lm_head stays f32.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import TransformerConfig
from ..ops.attention import relpos_attention, relpos_attention_step
from ..ops.attention_kernel import flash_relpos_attention, flash_relpos_attention_train
from .compute import dense, embed, layer_norm

Cache = Dict[str, torch.Tensor]
LN_EPS = 1e-6


class Head(nn.Module):
    """One attention head's parameters (reference `HeadRelPos`)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        hd = cfg.n_embd // cfg.n_heads
        self.query = nn.Linear(cfg.n_embd, hd, bias=False)
        self.key = nn.Linear(cfg.n_embd, hd, bias=False)
        self.value = nn.Linear(cfg.n_embd, hd, bias=False)
        self.rel_pos_emb = nn.Parameter(torch.zeros(cfg.seq_len, hd))


class RelPosSelfAttention(nn.Module):
    """Multi-head rel-pos self-attention (reference `MultiHeadAttention`)."""

    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.heads = nn.ModuleList(Head(cfg) for _ in range(cfg.n_heads))
        self.proj = nn.Linear(cfg.n_embd, cfg.n_embd)
        self.attn_drop = nn.Dropout(cfg.dropout)
        self.resid_drop = nn.Dropout(cfg.dropout)

    @property
    def head_dim(self) -> int:
        return self.cfg.n_embd // self.cfg.n_heads

    @property
    def scale(self) -> float:
        return float(self.cfg.n_embd) ** -0.5  # the model width, not head_dim

    def qkv_weight(self) -> torch.Tensor:
        """(3 * n_embd, n_embd): the heads' query, key and value rows, head-major
        within each (torch.cat([h(x) for h in heads]) order)."""
        return torch.cat([torch.cat([getattr(h, n).weight for h in self.heads]) for n in ("query", "key", "value")])

    def rel_emb(self) -> torch.Tensor:
        """(H, seq_len, hd), in the compute dtype."""
        return torch.stack([h.rel_pos_emb for h in self.heads]).to(self.dtype)

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        """[q | k | v] of x, one bias-free product in the compute dtype."""
        return F.linear(x.to(self.dtype), self.qkv_weight().to(self.dtype))

    def _qkv(self, x: torch.Tensor):
        """(B, T, n_embd) -> q, k, v (B, H, T, hd), head views of one product."""
        b, t, _ = x.shape
        zx = self._project(x).view(b, t, 3, self.cfg.n_heads, self.head_dim)
        return [zx[:, :, i].transpose(1, 2) for i in range(3)]

    def _attend(self, q, k, v, differentiable: bool = False) -> torch.Tensor:
        """Attention by cfg.attention_impl; `differentiable` takes kernel D
        with its LSE and kernel E where the kernels run."""
        impl = self.cfg.attention_impl
        if impl == "flash" or (impl == "auto" and q.is_cuda):
            fn = flash_relpos_attention_train if differentiable else flash_relpos_attention
            return fn(q, k, v, self.rel_emb(), self.scale)
        if impl not in ("auto", "xla", "torch_exact"):
            raise ValueError(f"unknown attention_impl {impl!r}")
        return relpos_attention(q, k, v, self.rel_emb(), self.scale, torch_exact_bd=impl == "torch_exact")

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        b, h, t, d = o.shape
        return dense(self.proj, o.transpose(1, 2).reshape(b, t, h * d), self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self._qkv(x)
        o = self.attn_drop(self._attend(q, k, v, differentiable=torch.is_grad_enabled()))
        return self.resid_drop(self._out(o))

    def prefill(self, x: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        q, k, v = self._qkv(x)
        return self._out(self._attend(q, k, v)), {"k": k.contiguous(), "v": v.contiguous()}

    def step(self, x: torch.Tensor, cache: Cache, slot, key_ages: torch.Tensor, rel_base) -> torch.Tensor:
        """x (B, n_embd), one position. Writes K/V at `slot` of the cache IN
        PLACE (a (B,) slot tensor gives each row its own slot, with (B, S)
        ages), then attends with the given per-slot ages."""
        c = self.cfg
        b = x.shape[0]
        q, k, v = self._project(x).view(b, 3, c.n_heads, self.head_dim).unbind(1)
        if torch.is_tensor(slot) and slot.dim() == 1:
            rows = torch.arange(b, device=x.device)
            cache["k"][rows, :, slot] = k
            cache["v"][rows, :, slot] = v
        else:
            cache["k"][:, :, slot] = k
            cache["v"][:, :, slot] = v
        out = relpos_attention_step(q, cache["k"], cache["v"], self.rel_emb(), self.scale, key_ages, rel_base)
        return dense(self.proj, out.reshape(b, c.n_embd), self.dtype)


class FeedForward(nn.Module):
    """4x ReLU MLP (reference `FeedFoward`: net = Linear, ReLU, Linear), with
    the training dropout after it."""

    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.net = nn.Sequential(nn.Linear(cfg.n_embd, 4 * cfg.n_embd), nn.ReLU(),
                                 nn.Linear(4 * cfg.n_embd, cfg.n_embd))
        self.drop = nn.Dropout(cfg.dropout)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        """`net` in the compute dtype, without the dropout."""
        return dense(self.net[2], F.relu(dense(self.net[0], x, self.dtype)), self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.mlp(x))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.sa = RelPosSelfAttention(cfg, dtype)
        self.ffwd = FeedForward(cfg, dtype)
        self.ln1 = nn.LayerNorm(cfg.n_embd, eps=LN_EPS)
        self.ln2 = nn.LayerNorm(cfg.n_embd, eps=LN_EPS)

    def _ln1(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(self.ln1, x, self.dtype)

    def _ln2(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(self.ln2, x, self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.sa(self._ln1(x))
        return x + self.ffwd(self._ln2(x))

    def prefill(self, x: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        a, cache = self.sa.prefill(self._ln1(x))
        x = x + a
        return x + self.ffwd.mlp(self._ln2(x)), cache

    def step(self, x, cache: Cache, slot, key_ages, rel_base) -> torch.Tensor:
        x = x + self.sa.step(self._ln1(x), cache, slot, key_ages, rel_base)
        return x + self.ffwd.mlp(self._ln2(x))


class TransformerLM(nn.Module):
    """Composer-conditioned decoder-only LM (reference Transformer)."""

    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.token_embedding_table = nn.Embedding(cfg.vocab_size, cfg.n_embd)
        self.metadata_embedding_table = nn.Embedding(cfg.metadata_vocab_size, cfg.n_embd)
        self.blocks = nn.ModuleList(Block(cfg, dtype) for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=LN_EPS)
        self.lm_head = nn.Linear(cfg.n_embd, cfg.vocab_size)

    def _embed(self, tokens: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
        return torch.cat([embed(self.metadata_embedding_table, meta, self.dtype),
                          embed(self.token_embedding_table, tokens, self.dtype)], dim=1)

    def hidden(self, tokens: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
        """Final-LN hidden states (B, meta+T, n_embd), the lm_head input."""
        x = self._embed(tokens, meta)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return layer_norm(self.ln_f, x, self.dtype)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """The f32 lm_head on the hidden states, whatever the compute dtype."""
        return self.lm_head(h.to(torch.float32))

    def forward(self, tokens: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
        """(B, T) tokens + (B, 6) meta -> (B, T, vocab) logits."""
        return self._logits(self.hidden(tokens, meta))[:, -tokens.shape[1]:]

    def prefill(self, tokens: torch.Tensor, meta: torch.Tensor):
        """Forward that also returns the per-layer KV caches
        {'k', 'v': (B, H, seq_len, hd)}, zero-padded from meta+T to seq_len
        slots (the sampler masks unfilled slots by age). Returns
        (logits (B, T, vocab), caches)."""
        t, s = tokens.shape[1], self.cfg.seq_len
        x = self._embed(tokens, meta)
        caches = []
        for block in self.blocks:
            x, cache = block.prefill(x)
            pad = s - cache["k"].shape[2]
            if pad:
                cache = {n: F.pad(c, (0, 0, 0, pad)) for n, c in cache.items()}
            caches.append(cache)
        return self._logits(layer_norm(self.ln_f, x, self.dtype))[:, -t:], tuple(caches)

    def step(self, token: torch.Tensor, caches, slot, key_ages: torch.Tensor, rel_base):
        """O(1)-per-token cached decode step: token (B,) -> (logits (B, vocab),
        caches). The caches are updated IN PLACE at `slot` and returned."""
        x = embed(self.token_embedding_table, token, self.dtype)
        for block, cache in zip(self.blocks, caches):
            x = block.step(x, cache, slot, key_ages, rel_base)
        return self._logits(layer_norm(self.ln_f, x, self.dtype)), caches


def empty_model(cfg: TransformerConfig, device: torch.device | str,
                dtype: torch.dtype = torch.float32) -> TransformerLM:
    """An uninitialised TransformerLM on `device` computing in `dtype` (its
    parameters f32; built on the meta device: the constructors draw no
    random numbers)."""
    with torch.device("meta"):
        model = TransformerLM(cfg, dtype)
    return model.to_empty(device=device)


@torch.no_grad()
def init_weights_(model: TransformerLM, seed: int) -> TransformerLM:
    """Random weights from `seed`, drawn on the CPU (the same numbers on any
    device): matrices N(0, 1/fan_in), embeddings and rel_pos_emb N(0, 1)
    (reference model_transformer.py:60), unit norms, zero biases."""
    gen = torch.Generator().manual_seed(seed)
    c = model.cfg

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=gen) * std)

    normal_(model.token_embedding_table.weight, 1.0)
    normal_(model.metadata_embedding_table.weight, 1.0)
    for block in model.blocks:
        for h in block.sa.heads:
            for lin in (h.query, h.key, h.value):
                normal_(lin.weight, 1.0 / math.sqrt(c.n_embd))
            normal_(h.rel_pos_emb, 1.0)
        normal_(block.sa.proj.weight, 1.0 / math.sqrt(c.n_embd))
        normal_(block.ffwd.net[0].weight, 1.0 / math.sqrt(c.n_embd))
        normal_(block.ffwd.net[2].weight, 1.0 / math.sqrt(4 * c.n_embd))
        for lin in (block.sa.proj, block.ffwd.net[0], block.ffwd.net[2]):
            lin.bias.zero_()
        for ln in (block.ln1, block.ln2):
            ln.weight.fill_(1.0)
            ln.bias.zero_()
    model.ln_f.weight.fill_(1.0)
    model.ln_f.bias.zero_()
    normal_(model.lm_head.weight, 1.0 / math.sqrt(c.n_embd))
    model.lm_head.bias.zero_()
    return model
