"""Kernel D: flash rel-pos attention forward (csrc/flash_relpos.cu), the
Transformer prefill's attention.

Replaces musicgen_tpu/ops/pallas_attention.py `_flash_relpos_kernel` (via
`flash_relpos_attention`). Same contract as ops/attention.relpos_attention:
causal with the first n_meta key columns always visible, BD[t, s] =
q_t . rel[s - t + T - 1] below the diagonal and 0 above it, scale
n_embd**-0.5 given by the caller. The rel table is the first T rows of the
learned (seq_len) buffer.

`flash_relpos_attention` launches the kernel on CUDA tensors and runs
`flash_relpos_attention_plain` on CPU tensors. The plain version is the TPU
kernel's arithmetic: q, k, v and rel rounded to bf16, products summed in
f32, an online softmax over 128-column key tiles in order (the TPU kernel's
block_k), the probabilities rounded to bf16 before P.V with f32 sums.
Each launch adds one to LAUNCHES["flash_relpos"].
"""
from __future__ import annotations

import collections

import torch

from ..config import NUM_META
from .attention import rel_shift
from .build import check, load_library, stream_ptr

HEAD_DIM = 128  # the head width kernel D is written for
BLOCK_K = 128  # key tile of the online softmax (the TPU kernel's block_k)
NEG = -1e30  # finite mask value (pallas_attention.NEG_INF)

LAUNCHES: collections.Counter = collections.Counter()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def flash_relpos_attention_plain(q, k, v, rel_emb, scale: float, n_meta: int = NUM_META):
    """(B, H, T, D) attention with kernel D's arithmetic, in plain PyTorch."""
    b, h, t, d = q.shape
    qb, kb, vb = _bf16(q.float()), _bf16(k.float()), _bf16(v.float())
    rel = _bf16(rel_emb[:, :t, :].float())
    ti = torch.arange(t, device=q.device)
    below = ti[None, :] <= ti[:, None]
    bd = torch.where(below, rel_shift(torch.einsum("bhtd,hsd->bhts", qb, rel)), 0.0)
    visible = below | (ti[None, :] < n_meta)
    m = torch.full((b, h, t, 1), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, h, t, d, dtype=torch.float32, device=q.device)
    for k0 in range(0, t, BLOCK_K):
        k1 = min(k0 + BLOCK_K, t)
        s = (torch.einsum("bhtd,bhsd->bhts", qb, kb[:, :, k0:k1]) + bd[..., k0:k1]) * scale
        s = torch.where(visible[:, k0:k1], s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhts,bhsd->bhtd", _bf16(p), vb[:, :, k0:k1])
        m = m_new
    return (acc / l).to(q.dtype)


def flash_relpos_attention(q, k, v, rel_emb, scale: float, n_meta: int = NUM_META):
    """Kernel D on CUDA tensors, the plain version on CPU tensors.

    q, k, v: f32 (B, H, T, 128) with equal strides and a contiguous last
    dim (e.g. head views of one (B, T, 3*H*128) projection); rel_emb:
    (H, >= T, 128). Returns (B, H, T, 128) f32, a view of a contiguous
    (B, T, H, 128) tensor (the layout the out-projection reads)."""
    if not q.is_cuda:
        return flash_relpos_attention_plain(q, k, v, rel_emb, scale, n_meta)
    b, h, t, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32 or x.device != q.device or tuple(x.shape) != (b, h, t, d):
            raise ValueError(f"flash_relpos_attention: {name} must be f32 {tuple(q.shape)} on {q.device}")
        if x.stride() != q.stride() or x.stride(3) != 1 or x.data_ptr() % 16 or any(s % 4 for s in x.stride()[:3]):
            raise ValueError(f"flash_relpos_attention: {name} needs q's strides, a contiguous last dim "
                             "and 16-byte aligned rows")
    if d != HEAD_DIM:
        raise ValueError(f"kernel D is written for head_dim {HEAD_DIM}, got {d}")
    rel = rel_emb.to(torch.float32).contiguous()
    if rel.device != q.device or rel.shape[0] != h or rel.shape[1] < t or rel.shape[2] != d:
        raise ValueError(f"flash_relpos_attention: rel_emb must be ({h}, >= {t}, {d}) on {q.device}")
    out = torch.empty(b, t, h, d, dtype=torch.float32, device=q.device)
    lib = load_library()
    sb, sh, st = q.stride()[:3]
    err = lib.mg_flash_relpos(q.data_ptr(), k.data_ptr(), v.data_ptr(), sb, sh, st, rel.data_ptr(),
                              rel.stride(0), out.data_ptr(), b, h, t, d, n_meta, float(scale), stream_ptr(q))
    check(lib, err, "flash_relpos")
    LAUNCHES["flash_relpos"] += 1
    return out.permute(0, 2, 1, 3)
