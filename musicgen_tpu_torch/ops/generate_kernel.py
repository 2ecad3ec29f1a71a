"""Kernel C: the resident whole-generation kernel (csrc/generate_resident.cu).

Replaces musicgen_tpu/ops/pallas_generate.py (`_generate_kernel` via
`fused_generate` and `generate_resident`): ONE launch generates N tokens of
the Mamba-2 stack with the 'combined' sampler. Per token, in order:
  1. pick from the top-3 candidates: greedy takes the first; otherwise CDF
     inversion of two uniforms, exactly as pallas_generate.py:159-183;
  2. push the token into the penalty window (sample/sampler.push_token);
  3. gather its f32 embedding row;
  4. the L mixers (in_proj + conv, SSM state update, RMSNorm + out_proj);
  5. LayerNorm + lm_head;
  6. the sampler tail (grammar, penalty, exact top-3) -> the next candidates.
The emitted token t is the pick after t model steps, the stream order of
sample/sampler.sample_tokens_fused_tail (seeded by the prefill top-3).

Random numbers come from outside, as in the TPU kernel: `uniforms` is
(num_tokens, B, 2) f32, lane 0 driving the k-choice and lane 1 the pick.
The k-choice and pick are the same distributions as the per-token sampler's
multinomial draws, but another stream.

`fused_generate_plain` is the same stage order in PyTorch. With
ops=PLAIN_OPS it is the plain version of the kernel; with ops=KERNEL_OPS it
is the per-token kernel chain with the resident kernel's pick, which the
resident kernel matches bit for bit on the card.

Both advance the conv and SSM states IN PLACE (the TPU kernel returned new
arrays); the penalty state passed in is not modified.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..config import VOCAB
from ..sample.sampler import (
    WINDOW_TICKS,
    PenaltyState,
    _iter_top_k,
    init_penalty_state,
    penalty_divisor,
    push_token,
)
from .build import check, load_library, stream_ptr
from .decode_kernel import (
    LAUNCHES,
    PLAIN_OPS,
    DecodeDims,
    StepOps,
    _kernel_dims,
    _need,
    _weights,
    check_pack,
    decode_logits,
)
from .grammar import field_bucket, filtered_logits


def pick_plain(vals: torch.Tensor, idxs: torch.Tensor, last: torch.Tensor, u: Optional[torch.Tensor],
               greedy: bool) -> torch.Tensor:
    """The kernel's pick of one token per row from (vals, idxs) (B, 3), given
    the previous token `last` (B,) and uniforms u (B, 2). All in f32:
    k = 1 + (u_k >= p1) + (u_k >= p1 + p2) with P(k=1), P(k=2) by the field
    of `last`; r = u_p * (v0 + v1 + v2) over the first k candidates;
    choice = (r >= v0) + (r >= v0 + v1)."""
    if greedy:
        return idxs[:, 0]
    bucket = field_bucket(last)
    f32 = torch.float32
    p1 = torch.where(bucket == 4, 0.6, torch.where(bucket <= 1, 0.5, 1.0)).to(f32)
    p2 = torch.where(bucket == 0, 0.5, torch.where(bucket == 4, 0.4, 0.0)).to(f32)
    u_k, u_p = u[:, 0], u[:, 1]
    k = 1 + (u_k >= p1).long() + (u_k >= p1 + p2).long()
    v0 = vals[:, 0]
    v1 = torch.where(k >= 2, vals[:, 1], 0.0)
    v2 = torch.where(k >= 3, vals[:, 2], 0.0)
    r = u_p * (v0 + v1 + v2)
    choice = (r >= v0).long() + (r >= v0 + v1).long()
    return torch.gather(idxs, 1, choice[:, None])[:, 0]


def fused_generate_plain(dp: dict, init_vals, init_idxs, init_last, conv, ssm, pen_state: PenaltyState,
                         uniforms: Optional[torch.Tensor], dims: DecodeDims, num_tokens: int,
                         greedy: bool = False, quant: str = "none",
                         ops: StepOps = PLAIN_OPS) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The resident loop token by token. Returns (tokens (B, n), conv, ssm)."""
    vals, idxs, last, pen = init_vals, init_idxs, init_last, pen_state
    out = []
    for t in range(num_tokens):
        tok = pick_plain(vals, idxs, last, None if greedy else uniforms[t], greedy)
        pen = push_token(pen, tok)
        logits = decode_logits(dp, tok, (conv, ssm), dims, ops=ops, quant=quant)
        if t + 1 < num_tokens:
            vals, idxs = ops[4](logits, dp["gram"], pen.hist, field_bucket(tok), dims)
        last = tok
        out.append(tok)
    return torch.stack(out, dim=1), conv, ssm


# Pointer and size order of csrc/generate_resident.cu ResidentArgs.
_WEIGHT_KEYS = ("w_in", "w_in_s", "w_out", "w_out_s", "conv_w", "conv_b", "dt_bias", "a_h", "d_h",
                "norm_w", "ln_w", "ln_b", "lm_w", "lm_s", "lm_b", "gram", "embed")
_N_PTRS, _N_INTS = 32, 19


def fused_generate(dp: dict, init_vals, init_idxs, init_last, conv, ssm, pen_state: PenaltyState,
                   uniforms: Optional[torch.Tensor], dims: DecodeDims, num_tokens: int,
                   greedy: bool = False, quant: str = "none") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Generate num_tokens tokens in one kernel launch (on CUDA tensors; the
    plain version on CPU tensors). Returns (tokens (B, n) int64, conv, ssm),
    the states advanced in place. `quant` must match the pack."""
    if not conv.is_cuda:
        return fused_generate_plain(dp, init_vals, init_idxs, init_last, conv, ssm, pen_state, uniforms,
                                    dims, num_tokens, greedy, quant)
    check_pack(dp, quant)
    b, dev, n = dims.batch, conv.device, num_tokens
    _kernel_dims(dims, b)
    if n < 1:
        raise ValueError(f"num_tokens must be >= 1, got {n}")
    L, f32, i32, i64 = dims.n_layers, torch.float32, torch.int32, torch.int64
    _weights(dp["w_in"][0], None if quant == "none" else dp["w_in_s"][0], quant, dims.d_in_proj,
             dims.d_model, dev)
    _weights(dp["w_out"][0], None if quant == "none" else dp["w_out_s"][0], quant, dims.d_model,
             dims.d_inner, dev)
    _weights(dp["lm_w"], dp.get("lm_s"), quant, dims.padded_vocab, dims.d_model, dev)
    for key, shape in (("conv_w", (L, 4, dims.conv_dim)), ("conv_b", (L, dims.conv_dim)),
                       ("dt_bias", (L, dims.nheads)), ("a_h", (L, dims.nheads)), ("d_h", (L, dims.nheads)),
                       ("norm_w", (L, dims.d_inner)), ("ln_w", (dims.d_model,)), ("ln_b", (dims.d_model,)),
                       ("lm_b", (dims.padded_vocab,)), ("gram", (5, dims.padded_vocab)),
                       ("embed", (dims.vocab_size, dims.d_model))):
        _need(dp[key], key, f32, shape, dev)
    _need(conv, "conv", f32, (L, b, 3, dims.conv_dim), dev)
    _need(ssm, "ssm", f32, (L, dims.d_inner, b * dims.d_state), dev)
    if greedy:
        uniforms = torch.zeros(n, b, 2, dtype=f32, device=dev)  # not read
    _need(uniforms, "uniforms", f32, (n, b, 2), dev)
    ring = pen_state.ring_tok.shape[1]
    # The kernel's own copies of the window and the candidates.
    state = {
        "hist": pen_state.hist.to(i32, copy=True).contiguous(),
        "ring_tok": pen_state.ring_tok.to(i32, copy=True).contiguous(),
        "ring_c": pen_state.ring_c.to(i32, copy=True).contiguous(),
        "meta": torch.stack([pen_state.start, pen_state.head, pen_state.wsum], dim=1).to(i32).contiguous(),
        "cand_v": init_vals.to(f32, copy=True).contiguous(),
        "cand_i": init_idxs.to(i64, copy=True).contiguous(),
        "last": init_last.to(i64, copy=True).contiguous(),
    }
    _need(state["hist"], "hist", i32, (b, dims.vocab_size), dev)
    _need(state["cand_i"], "init_idxs", i64, (b, 3), dev)
    _need(state["last"], "init_last", i64, (b,), dev)
    act = {
        "x": torch.empty(b, dims.d_model, dtype=f32, device=dev),
        "zx": torch.empty(b, dims.d_in_proj, dtype=f32, device=dev),
        "g": torch.empty(b, dims.d_inner, dtype=f32, device=dev),
        "logits": torch.empty(b, dims.padded_vocab, dtype=f32, device=dev),
    }
    tokens = torch.empty(b, n, dtype=i64, device=dev)
    tensors = [dp.get(k) for k in _WEIGHT_KEYS] + [uniforms, conv, ssm] + list(state.values()) \
        + list(act.values()) + [tokens]
    ptrs = [0 if t is None else t.data_ptr() for t in tensors]
    ints = [L, b, dims.d_model, dims.d_inner, dims.nheads, dims.headdim, dims.d_state, dims.conv_dim,
            dims.d_in_proj, dims.padded_vocab, dims.vocab_size, dims.dyn_start, dims.length_start,
            VOCAB.time_start, VOCAB.tempo_start, ring, WINDOW_TICKS, n, int(greedy)]
    assert len(ptrs) == _N_PTRS and len(ints) == _N_INTS
    name = f"generate_resident_{'bf16' if quant == 'none' else quant}"
    lib = load_library()
    grid = ctypes.c_int(0)
    err = getattr(lib, f"mg_{name}")((ctypes.c_void_p * _N_PTRS)(*ptrs), _N_PTRS,
                                    (ctypes.c_int * _N_INTS)(*ints), _N_INTS, ctypes.byref(grid),
                                    stream_ptr(conv))
    check(lib, err, name)
    LAUNCHES[name] += 1
    fused_generate.grid = grid.value
    return tokens, conv, ssm


fused_generate.grid = 0  # blocks of the last cooperative launch


@torch.no_grad()
def generate_resident(dp: dict, init_logits: torch.Tensor, carry, prompt: torch.Tensor, num_tokens: int,
                      dims: DecodeDims, generator: torch.Generator, greedy: bool = False,
                      quant: str = "none", ring: int = 2048) -> torch.Tensor:
    """Drop-in for sample_tokens_fused_tail that runs the whole loop in one
    launch. The first top-3 comes from the prefill logits through the plain
    tail; the uniforms are drawn once from `generator` on the prompt's
    device. Returns (B, P + num_tokens) streams (prompt prepended); `carry`
    advances in place."""
    last0 = prompt[:, -1]
    pen0 = init_penalty_state(prompt, ring)
    w0 = filtered_logits(last0, init_logits) / penalty_divisor(pen0.hist)
    vals0, idxs0 = _iter_top_k(w0, 3)
    u = None
    if not greedy:
        u = torch.rand((num_tokens, prompt.shape[0], 2), generator=generator, device=prompt.device)
    toks, _, _ = fused_generate(dp, vals0, idxs0, last0, carry[0], carry[1], pen0, u, dims, num_tokens,
                                greedy, quant)
    return torch.cat([prompt, toks], dim=1)
