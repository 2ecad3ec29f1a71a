"""Kernels D and E: flash rel-pos attention forward (csrc/flash_relpos.cu)
and backward (csrc/flash_relpos_bwd.cu), the Transformer's attention in the
prefill and in training.

Replaces musicgen_tpu/ops/pallas_attention.py `_flash_relpos_kernel` (via
`flash_relpos_attention`) and, for training, the custom-VJP pair of
`flash_relpos_attention_train` (`_flash_bwd_dq_kernel`,
`_flash_bwd_dkv_kernel`). Same contract as ops/attention.relpos_attention:
causal with the first n_meta key columns always visible, BD[t, s] =
q_t . rel[s - t + T - 1] below the diagonal and 0 above it, scale
n_embd**-0.5 given by the caller. The rel table is the first T rows of the
learned (seq_len) buffer; its gradient has the buffer's shape, zero in the
rows >= T.

Each wrapper launches its kernel on CUDA tensors and runs its plain version
on CPU tensors. The plain versions are the TPU kernels' arithmetic: q, k, v,
dO and rel rounded to bf16, products summed in f32; the forward's online
softmax walks 128-column key tiles in order (the TPU kernel's block_k) and
rounds the probabilities to bf16 before P.V; the backward rounds p and dS to
bf16 before their products. Launches are counted in LAUNCHES:
"flash_relpos" (the prefill's D), "flash_relpos_lse" (D with its LSE output,
the training forward), "flash_bwd_dq" and "flash_bwd_dkv" (E1 and E2).

`flash_relpos_attention_train` is the differentiable form (a
torch.autograd.Function: D with LSE forward, E backward). The other two
launch wrappers refuse to run where autograd would record them.
"""
from __future__ import annotations

import collections

import torch

from ..config import NUM_META
from .attention import rel_shift
from .build import check, load_library, refuse_grad, stream_ptr

HEAD_DIM = 128  # the head width kernels D and E are written for
BLOCK_K = 128  # key tile of the online softmax (the TPU kernel's block_k)
NEG = -1e30  # finite mask value (pallas_attention.NEG_INF)

LAUNCHES: collections.Counter = collections.Counter()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _masks(t: int, n_meta: int, device):
    ti = torch.arange(t, device=device)
    below = ti[None, :] <= ti[:, None]
    return below, below | (ti[None, :] < n_meta)


def flash_relpos_attention_plain(q, k, v, rel_emb, scale: float, n_meta: int = NUM_META, with_lse: bool = False):
    """(B, H, T, D) attention with kernel D's arithmetic, in plain PyTorch;
    with_lse also returns the rows' log-sum-exp, f32 (B*H, T)."""
    b, h, t, d = q.shape
    qb, kb, vb = _bf16(q.float()), _bf16(k.float()), _bf16(v.float())
    rel = _bf16(rel_emb[:, :t, :].float())
    below, visible = _masks(t, n_meta, q.device)
    bd = torch.where(below, rel_shift(torch.einsum("bhtd,hsd->bhts", qb, rel)), 0.0)
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
    out = (acc / l).to(q.dtype)
    if with_lse:
        return out, (m + torch.log(l)).reshape(b * h, t)
    return out


def _check_qkv(what: str, q, k, v) -> None:
    b, h, t, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32 or x.device != q.device or tuple(x.shape) != (b, h, t, d):
            raise ValueError(f"{what}: {name} must be f32 {tuple(q.shape)} on {q.device}")
        if x.stride() != q.stride() or x.stride(3) != 1 or x.data_ptr() % 16 or any(s % 4 for s in x.stride()[:3]):
            raise ValueError(f"{what}: {name} needs q's strides, a contiguous last dim and 16-byte aligned rows")
    if d != HEAD_DIM:
        raise ValueError(f"kernels D and E are written for head_dim {HEAD_DIM}, got {d}")


def _rel_table(what: str, rel_emb, q) -> torch.Tensor:
    _, h, t, d = q.shape
    rel = rel_emb.to(torch.float32).contiguous()
    if rel.device != q.device or rel.shape[0] != h or rel.shape[1] < t or rel.shape[2] != d:
        raise ValueError(f"{what}: rel_emb must be ({h}, >= {t}, {d}) on {q.device}")
    return rel


def _launch_forward(q, k, v, rel_emb, scale: float, n_meta: int, with_lse: bool):
    what = "flash_relpos_attention"
    _check_qkv(what, q, k, v)
    rel = _rel_table(what, rel_emb, q)
    b, h, t, d = q.shape
    out = torch.empty(b, t, h, d, dtype=torch.float32, device=q.device)
    lse = torch.empty(b * h, t, dtype=torch.float32, device=q.device) if with_lse else None
    lib = load_library()
    sb, sh, st = q.stride()[:3]
    err = lib.mg_flash_relpos(q.data_ptr(), k.data_ptr(), v.data_ptr(), sb, sh, st, rel.data_ptr(), rel.stride(0),
                              out.data_ptr(), None if lse is None else lse.data_ptr(), b, h, t, d, n_meta,
                              float(scale), stream_ptr(q))
    check(lib, err, "flash_relpos")
    LAUNCHES["flash_relpos_lse" if with_lse else "flash_relpos"] += 1
    return out.permute(0, 2, 1, 3), lse


def flash_relpos_attention(q, k, v, rel_emb, scale: float, n_meta: int = NUM_META):
    """Kernel D on CUDA tensors, the plain version on CPU tensors.

    q, k, v: f32 (B, H, T, 128) with equal strides and a contiguous last
    dim (e.g. head views of one (B, T, 3*H*128) projection); rel_emb:
    (H, >= T, 128). Returns (B, H, T, 128) f32, a view of a contiguous
    (B, T, H, 128) tensor (the layout the out-projection reads). On CUDA it
    raises under grad mode if an input requires grad: training goes through
    flash_relpos_attention_train."""
    if not q.is_cuda:
        return flash_relpos_attention_plain(q, k, v, rel_emb, scale, n_meta)
    refuse_grad("flash_relpos_attention (kernel D)", q, k, v, rel_emb)
    return _launch_forward(q, k, v, rel_emb, scale, n_meta, False)[0]


def flash_relpos_attention_lse(q, k, v, rel_emb, scale: float, n_meta: int = NUM_META):
    """(out, lse): kernel D with its log-sum-exp output (f32 (B*H, T)) on
    CUDA tensors, the plain version on CPU tensors; the training forward."""
    if not q.is_cuda:
        return flash_relpos_attention_plain(q, k, v, rel_emb, scale, n_meta, with_lse=True)
    refuse_grad("flash_relpos_attention_lse (kernel D)", q, k, v, rel_emb)
    return _launch_forward(q, k, v, rel_emb, scale, n_meta, True)


def flash_relpos_attention_bwd_plain(q, k, v, rel_emb, out, lse, dout, scale: float, n_meta: int = NUM_META):
    """(dq, dk, dv, drel) with kernel E's arithmetic, in plain PyTorch.

    drel has rel_emb's shape (H, R >= T, D), zero in rows >= T. The (t, s)
    pairs of BD are gathered into rel-index order with an index map (the
    inverse of rel_shift), where the TPU kernel rolls and permutes."""
    b, h, t, d = q.shape
    qb, kb, vb, dob = (_bf16(x.float()) for x in (q, k, v, dout))
    rel = _bf16(rel_emb[:, :t, :].float())
    below, visible = _masks(t, n_meta, q.device)
    bd = torch.where(below, rel_shift(torch.einsum("bhtd,hsd->bhts", qb, rel)), 0.0)
    s = (torch.einsum("bhtd,bhsd->bhts", qb, kb) + bd) * scale
    s = torch.where(visible, s, NEG)
    p = torch.exp(s - lse.reshape(b, h, t, 1))
    dp = torch.einsum("bhtd,bhsd->bhts", dob, vb)
    delta = (out.float() * dout.float()).sum(dim=-1, keepdim=True)
    ds = _bf16(p * (dp - delta) * scale)
    dv = torch.einsum("bhts,bhtd->bhsd", _bf16(p), dob)
    dk = torch.einsum("bhts,bhtd->bhsd", ds, qb)
    # band[t, i] = dS[t, s] at rel index i = s - t + T - 1, for s <= t.
    ti = torch.arange(t, device=q.device)
    src = ti[None, :] + ti[:, None] - (t - 1)  # [t, i] -> s
    band = torch.where(src >= 0, torch.gather(ds, -1, src.clamp(min=0).expand(b, h, t, t)), 0.0)
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kb) + torch.einsum("bhti,hid->bhtd", band, rel)
    drel = torch.zeros(rel_emb.shape, dtype=torch.float32, device=q.device)
    drel[:, :t] = torch.einsum("bhti,bhtd->hid", band, qb)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), drel.to(rel_emb.dtype)


def flash_relpos_attention_bwd(q, k, v, rel_emb, out, lse, dout, scale: float, n_meta: int = NUM_META):
    """(dq, dk, dv, drel): kernel E (E1 then E2) on CUDA tensors, the plain
    version on CPU tensors. q, k, v as for kernel D; out, dout: (B, H, T,
    128); lse: f32 (B*H, T) from flash_relpos_attention_lse. dq, dk, dv are
    contiguous (B, H, T, 128); drel has rel_emb's shape, zero in rows >= T."""
    if not q.is_cuda:
        return flash_relpos_attention_bwd_plain(q, k, v, rel_emb, out, lse, dout, scale, n_meta)
    launch = BackwardLaunch(q, k, v, rel_emb, out, lse, dout, scale, n_meta)
    launch.dq()
    launch.dkv()
    return launch.grads()


class BackwardLaunch:
    """Kernel E's two launches on one set of checked inputs and outputs:
    E1 (`dq`: dQ and dRel) and E2 (`dkv`: dK and dV), each on the current
    stream when it is called. delta = rowsum(out * dout) is computed here in
    plain PyTorch, as the JAX package left it to XLA."""

    def __init__(self, q, k, v, rel_emb, out, lse, dout, scale: float, n_meta: int = NUM_META):
        what = "flash_relpos_attention_bwd"
        _check_qkv(what, q, k, v)
        rel = _rel_table(what, rel_emb, q)
        b, h, t, d = q.shape
        if dout.shape != q.shape or out.shape != q.shape or lse.shape != (b * h, t):
            raise ValueError(f"{what}: out and dout must be {tuple(q.shape)}, lse ({b * h}, {t})")
        dout = dout.to(torch.float32).contiguous()
        lse = lse.to(torch.float32).contiguous()
        delta = (out.float() * dout).sum(dim=-1).reshape(b * h, t).contiguous()
        self.dq_, self.dk_, self.dv_ = (torch.empty(b, h, t, d, dtype=torch.float32, device=q.device)
                                        for _ in range(3))
        self.drel = torch.zeros(rel.shape, dtype=torch.float32, device=q.device)
        self.rel_dtype = rel_emb.dtype
        self.keep = (q, k, v, rel, dout, lse, delta)  # alive until the launches are queued
        sb, sh, st = q.stride()[:3]
        dsb, dsh, dst = dout.stride()[:3]
        self.common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), sb, sh, st, dout.data_ptr(), dsb, dsh, dst,
                       rel.data_ptr(), rel.stride(0), lse.data_ptr(), delta.data_ptr())
        self.shape = (b, h, t, d, n_meta, float(scale))
        self.lib = load_library()

    def dq(self) -> None:
        """E1: dQ, and dRel added into the zero-filled table."""
        err = self.lib.mg_flash_bwd_dq(*self.common, self.dq_.data_ptr(), self.drel.data_ptr(),
                                       self.drel.stride(0), *self.shape, stream_ptr(self.dq_))
        check(self.lib, err, "flash_bwd_dq")
        LAUNCHES["flash_bwd_dq"] += 1

    def dkv(self) -> None:
        """E2: dK and dV."""
        err = self.lib.mg_flash_bwd_dkv(*self.common, self.dk_.data_ptr(), self.dv_.data_ptr(), *self.shape,
                                        stream_ptr(self.dk_))
        check(self.lib, err, "flash_bwd_dkv")
        LAUNCHES["flash_bwd_dkv"] += 1

    def grads(self):
        return self.dq_, self.dk_, self.dv_, self.drel.to(self.rel_dtype)


class FlashRelposAttention(torch.autograd.Function):
    """Differentiable flash rel-pos attention: kernel D with its LSE output
    forward, kernel E backward (their plain versions on CPU tensors). It
    saves q, k, v, rel, the output and the LSE, as the TPU kernel's custom
    VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, rel_emb, scale: float, n_meta: int):
        out, lse = flash_relpos_attention_lse(q, k, v, rel_emb, scale, n_meta)
        ctx.save_for_backward(q, k, v, rel_emb, out, lse)
        ctx.scale, ctx.n_meta = scale, n_meta
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, rel_emb, out, lse = ctx.saved_tensors
        dq, dk, dv, drel = flash_relpos_attention_bwd(q, k, v, rel_emb, out, lse, dout, ctx.scale, ctx.n_meta)
        return dq, dk, dv, drel, None, None


def flash_relpos_attention_train(q, k, v, rel_emb, scale: float, n_meta: int = NUM_META):
    """The training form of flash_relpos_attention: differentiable in q, k, v
    and rel_emb (the whole learned buffer; rows >= T get zero gradient)."""
    return FlashRelposAttention.apply(q, k, v, rel_emb, scale, n_meta)
