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
the training forward), and E's five (BackwardLaunch): "flash_bwd_stage",
"flash_bwd_dq" (E1), "flash_bwd_dkv" (E2), "flash_bwd_drel" (E3) and
"flash_bwd_drel_combine". Each of E's launches has a plain version here:
bwd_stage_plain (bit for bit), flash_relpos_attention_bwd_plain (dq, dk,
dv), drel_slots_plain (the slots, in the kernel's order of tiles but with
einsum's order inside a tile, so within bf16 rounding) and
drel_combine_plain (bit for bit on the same slots). The kernel sums dRel in
a fixed order with no atomics, so its dRel has the same bits on every
call.

`flash_relpos_attention_train` is the differentiable form (a
torch.autograd.Function: D with LSE forward, E backward). The other two
launch wrappers refuse to run where autograd would record them.

`flash_relpos_attention` and `flash_relpos_attention_train` take q, k, v and
rel in any float dtype (a bf16 model's activations) as the TPU wrapper does:
upcast to f32 around the kernels, the output cast back to q's dtype, and
autograd carries the gradients back through the casts. The kernels stage to
bf16 themselves, so bf16 inputs reach them with the same bits.
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
DRL_TILE = 64  # kernel E's tile: the rows of a query tile, and of a dRel slot's half

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


def _f32(*xs):
    """The tensors in f32 (the same tensors where they are f32 already)."""
    return tuple(x.to(torch.float32) for x in xs)


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


def staging_views(stage: torch.Tensor, b: int, h: int, t: int):
    """(k, v, rel): kernel D's bf16 copies inside its staging buffer, which
    holds (2*B*H + H) * T * 128 values: k and v as (B*H, T, 128), then the
    first T rows of rel as (H, T, 128), each contiguous and starting on a
    16-byte boundary (the offsets csrc/flash_relpos.cu computes)."""
    kv = b * h * t * HEAD_DIM
    if (stage.dtype != torch.bfloat16 or stage.dim() != 1 or stage.numel() != 2 * kv + h * t * HEAD_DIM
            or not stage.is_contiguous()):
        raise ValueError(f"kernel D's staging buffer must be bf16 of {2 * kv + h * t * HEAD_DIM} values")
    return (stage[:kv].view(b * h, t, HEAD_DIM), stage[kv:2 * kv].view(b * h, t, HEAD_DIM),
            stage[2 * kv:].view(h, t, HEAD_DIM))


def _launch_forward(q, k, v, rel_emb, scale: float, n_meta: int, with_lse: bool, stage=None):
    """Kernel D's two launches (the bf16 staging pass, then the attention);
    `stage` is the staging buffer to use (a new one if None), so that a
    caller can read the staged copies through staging_views."""
    what = "flash_relpos_attention"
    _check_qkv(what, q, k, v)
    rel = _rel_table(what, rel_emb, q)
    b, h, t, d = q.shape
    out = torch.empty(b, t, h, d, dtype=torch.float32, device=q.device)
    lse = torch.empty(b * h, t, dtype=torch.float32, device=q.device) if with_lse else None
    if stage is None:
        stage = torch.empty((2 * b + 1) * h * t * d, dtype=torch.bfloat16, device=q.device)
    staging_views(stage, b, h, t)
    if stage.device != q.device or stage.data_ptr() % 16:
        raise ValueError(f"{what}: the staging buffer must lie on {q.device}, 16-byte aligned")
    lib = load_library()
    sb, sh, st = q.stride()[:3]
    err = lib.mg_flash_relpos(q.data_ptr(), k.data_ptr(), v.data_ptr(), sb, sh, st, rel.data_ptr(), rel.stride(0),
                              out.data_ptr(), None if lse is None else lse.data_ptr(), stage.data_ptr(), b, h, t, d,
                              n_meta, float(scale), stream_ptr(q))
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
    flash_relpos_attention_train. Inputs of another float dtype are upcast
    to f32 and the output returned in q's dtype."""
    out_dtype = q.dtype
    q, k, v, rel_emb = _f32(q, k, v, rel_emb)
    if not q.is_cuda:
        return flash_relpos_attention_plain(q, k, v, rel_emb, scale, n_meta).to(out_dtype)
    refuse_grad("flash_relpos_attention (kernel D)", q, k, v, rel_emb)
    return _launch_forward(q, k, v, rel_emb, scale, n_meta, False)[0].to(out_dtype)


def flash_relpos_attention_lse(q, k, v, rel_emb, scale: float, n_meta: int = NUM_META):
    """(out, lse): kernel D with its log-sum-exp output (f32 (B*H, T)) on
    CUDA tensors, the plain version on CPU tensors; the training forward."""
    if not q.is_cuda:
        return flash_relpos_attention_plain(q, k, v, rel_emb, scale, n_meta, with_lse=True)
    refuse_grad("flash_relpos_attention_lse (kernel D)", q, k, v, rel_emb)
    return _launch_forward(q, k, v, rel_emb, scale, n_meta, True)


def _bwd_scores_plain(q, k, v, rel_emb, lse, dout, delta, scale: float, n_meta: int):
    """(q, k, dO, rel in bf16 as f32, p, bf16(dS)): the probabilities and the
    score gradient that every launch of kernel E recomputes."""
    b, h, t, d = q.shape
    qb, kb, vb, dob = (_bf16(x.float()) for x in (q, k, v, dout))
    rel = _bf16(rel_emb[:, :t, :].float())
    below, visible = _masks(t, n_meta, q.device)
    bd = torch.where(below, rel_shift(torch.einsum("bhtd,hsd->bhts", qb, rel)), 0.0)
    s = (torch.einsum("bhtd,bhsd->bhts", qb, kb) + bd) * scale
    s = torch.where(visible, s, NEG)
    p = torch.exp(s - lse.reshape(b, h, t, 1))
    dp = torch.einsum("bhtd,bhsd->bhts", dob, vb)
    ds = _bf16(p * (dp - delta.reshape(b, h, t, 1)) * scale)
    return qb, kb, dob, rel, p, ds


def _delta_plain(out, dout) -> torch.Tensor:
    """delta = rowsum(out * dO), f32 (B*H, T)."""
    b, h, t, _ = out.shape
    return (out.float() * dout.float()).sum(dim=-1).reshape(b * h, t)


def flash_relpos_attention_bwd_plain(q, k, v, rel_emb, out, lse, dout, scale: float, n_meta: int = NUM_META):
    """(dq, dk, dv, drel) with kernel E's arithmetic, in plain PyTorch.

    drel has rel_emb's shape (H, R >= T, D), zero in rows >= T. The (t, s)
    pairs of BD are gathered into rel-index order with an index map (the
    inverse of rel_shift), where the TPU kernel rolls and permutes."""
    b, h, t, d = q.shape
    qb, kb, dob, rel, p, ds = _bwd_scores_plain(q, k, v, rel_emb, lse, dout, _delta_plain(out, dout), scale,
                                                n_meta)
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


def bwd_stage_plain(q, k, v, rel_emb, out, dout):
    """(stage, delta): the stage launch's outputs in plain PyTorch: its bf16
    buffer of (4*B*H + H) * T * 128 values, q, k, v and dO as (B*H, T, 128)
    and then the first T rows of rel as (H, T, 128), each contiguous (the
    offsets csrc/flash_relpos_bwd.cu computes); and delta = rowsum(out * dO)."""
    t = q.shape[2]
    parts = [x.float().to(torch.bfloat16).reshape(-1) for x in (q, k, v, dout)]
    parts.append(rel_emb[:, :t].float().to(torch.bfloat16).reshape(-1))
    return torch.cat(parts), _delta_plain(out, dout)


def n_diagonals(t: int) -> int:
    """Tile diagonals of kernel E3 at length t: one a 64-row query tile."""
    return -(-t // DRL_TILE)


def drel_slots_plain(q, k, v, rel_emb, lse, dout, delta, scale: float, n_meta: int = NUM_META):
    """Kernel E3's slots in plain PyTorch: f32 (H, n, 128, 128), n =
    n_diagonals(T). Slot (h, d) sums, over b and then the key tiles kt of
    diagonal d (query tile kt + d), in that order, dP_band^T . Q of the
    64 x 64 tile, with dP_band[r][c - r + 63] = bf16(dS)[r][c] for c <= t:
    window row w of slot d is rel row T - 64 - 64 d + w."""
    b, h, t, d = q.shape
    qb, _, _, _, _, ds = _bwd_scores_plain(q, k, v, rel_emb, lse, dout, delta, scale, n_meta)
    n, tile = n_diagonals(t), DRL_TILE
    tp = n * tile
    below, _ = _masks(t, n_meta, q.device)
    dsp = torch.zeros(b, h, tp, tp, dtype=torch.float32, device=q.device)
    dsp[..., :t, :t] = torch.where(below, ds, 0.0)
    qp = torch.zeros(b, h, tp, d, dtype=torch.float32, device=q.device)
    qp[:, :, :t] = qb
    r = torch.arange(tile, device=q.device)
    col = torch.arange(2 * tile, device=q.device)[None, :] + r[:, None] - (tile - 1)  # [r][w] -> c
    valid = (col >= 0) & (col < tile)
    slots = torch.zeros(h, n, 2 * tile, d, dtype=torch.float32, device=q.device)
    for dg in range(n):
        acc = slots[:, dg]
        for bi in range(b):
            for kt in range(n - dg):
                q0, k0 = (kt + dg) * tile, kt * tile
                blk = dsp[bi, :, q0:q0 + tile, k0:k0 + tile]  # (h, r, c)
                band = torch.where(valid, torch.gather(blk, -1, col.clamp(0, tile - 1).expand(h, -1, -1)), 0.0)
                acc += torch.einsum("hrw,hrd->hwd", band, qp[bi, :, q0:q0 + tile])
    return slots


def drel_combine_plain(slots: torch.Tensor, t: int, rows: int) -> torch.Tensor:
    """The combine in plain PyTorch: drel f32 (H, rows, 128) with rel row
    i < t = slot d1 at window row w1 plus, where it exists, slot d1 + 1 at w1
    + 64 (d1 = (t - 1 - i) // 64, w1 = i - t + 64 + 64 d1), in that order;
    rows >= t are zero."""
    h, n, _, d = slots.shape
    i = torch.arange(t, device=slots.device)
    d1 = (t - 1 - i) // DRL_TILE
    w1 = i - t + DRL_TILE + DRL_TILE * d1
    lo = slots[:, d1, w1]
    has_hi = (d1 + 1 < n)[None, :, None]
    hi = slots[:, (d1 + 1).clamp(max=n - 1), w1 + DRL_TILE]
    drel = torch.zeros(h, rows, d, dtype=torch.float32, device=slots.device)
    drel[:, :t] = torch.where(has_hi, lo + hi, lo)
    return drel


def flash_relpos_attention_bwd(q, k, v, rel_emb, out, lse, dout, scale: float, n_meta: int = NUM_META):
    """(dq, dk, dv, drel): kernel E's five launches on CUDA tensors, the plain
    version on CPU tensors. q, k, v as for kernel D; out, dout: (B, H, T,
    128); lse: f32 (B*H, T) from flash_relpos_attention_lse. dq, dk, dv are
    contiguous (B, H, T, 128); drel has rel_emb's shape, zero in rows >= T."""
    if not q.is_cuda:
        return flash_relpos_attention_bwd_plain(q, k, v, rel_emb, out, lse, dout, scale, n_meta)
    launch = BackwardLaunch(q, k, v, rel_emb, out, lse, dout, scale, n_meta)
    launch.run()
    return launch.grads()


def _rows_ok(x: torch.Tensor) -> bool:
    return x.stride(3) == 1 and x.data_ptr() % 16 == 0 and all(s % 4 == 0 for s in x.stride()[:3])


class BackwardLaunch:
    """Kernel E's five launches on one set of checked inputs, buffers and
    outputs, each on the current stream when it is called, in this order:
    `stage` ("flash_bwd_stage": bf16 q, k, v, dO, rel into `stage`, delta =
    rowsum(out * dO) into `delta`), `dq` ("flash_bwd_dq", E1), `dkv`
    ("flash_bwd_dkv", E2), `drel` ("flash_bwd_drel", E3: the tile diagonals'
    slots) and `combine` ("flash_bwd_drel_combine": the slots into drel);
    `run` makes all five. The staging buffer (38 MB at the training shape)
    and the slots (17 MB) are made here, once a backward call."""

    def __init__(self, q, k, v, rel_emb, out, lse, dout, scale: float, n_meta: int = NUM_META):
        what = "flash_relpos_attention_bwd"
        _check_qkv(what, q, k, v)
        rel = _rel_table(what, rel_emb, q)
        b, h, t, d = q.shape
        if dout.shape != q.shape or out.shape != q.shape or lse.shape != (b * h, t):
            raise ValueError(f"{what}: out and dout must be {tuple(q.shape)}, lse ({b * h}, {t})")
        dout, out = (x.to(torch.float32) for x in (dout, out))
        dout, out = (x if _rows_ok(x) else x.contiguous() for x in (dout, out))
        lse = lse.to(torch.float32).contiguous()
        dev = q.device
        self.stage_buf = torch.empty((4 * b + 1) * h * t * d, dtype=torch.bfloat16, device=dev)
        self.delta = torch.empty(b * h, t, dtype=torch.float32, device=dev)
        self.slots = torch.empty(h, n_diagonals(t), 2 * DRL_TILE, d, dtype=torch.float32, device=dev)
        self.dq_, self.dk_, self.dv_ = (torch.empty(b, h, t, d, dtype=torch.float32, device=dev) for _ in range(3))
        self.drel_ = torch.empty(rel.shape, dtype=torch.float32, device=dev)
        self.rel_dtype = rel_emb.dtype
        self.keep = (q, k, v, rel, out, dout, lse)  # alive until the launches are queued
        self.stage_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3], dout.data_ptr(),
                           *dout.stride()[:3], out.data_ptr(), *out.stride()[:3], rel.data_ptr(), rel.stride(0),
                           self.stage_buf.data_ptr(), self.delta.data_ptr(), b, h, t, d)
        self.common = (self.stage_buf.data_ptr(), lse.data_ptr(), self.delta.data_ptr())
        self.shape = (b, h, t, d, n_meta, float(scale))
        self.lib = load_library()

    def _done(self, err: int, name: str) -> None:
        check(self.lib, err, name)
        LAUNCHES[name] += 1

    def stage(self) -> None:
        """bf16 q, k, v, dO and rel into the staging buffer; delta."""
        self._done(self.lib.mg_flash_bwd_stage(*self.stage_args, stream_ptr(self.dq_)), "flash_bwd_stage")

    def dq(self) -> None:
        """E1: dQ."""
        self._done(self.lib.mg_flash_bwd_dq(*self.common, self.dq_.data_ptr(), *self.shape, stream_ptr(self.dq_)),
                   "flash_bwd_dq")

    def dkv(self) -> None:
        """E2: dK and dV."""
        self._done(self.lib.mg_flash_bwd_dkv(*self.common, self.dk_.data_ptr(), self.dv_.data_ptr(), *self.shape,
                                             stream_ptr(self.dq_)), "flash_bwd_dkv")

    def drel(self) -> None:
        """E3: each tile diagonal's dRel band into its slot."""
        self._done(self.lib.mg_flash_bwd_drel(*self.common, self.slots.data_ptr(), *self.shape,
                                              stream_ptr(self.dq_)), "flash_bwd_drel")

    def combine(self) -> None:
        """The slots into drel, rows >= T zero."""
        b, h, t = self.shape[:3]
        self._done(self.lib.mg_flash_bwd_drel_combine(self.slots.data_ptr(), self.drel_.data_ptr(),
                                                      self.drel_.stride(0), h, t, self.drel_.shape[1],
                                                      stream_ptr(self.dq_)), "flash_bwd_drel_combine")

    def run(self) -> None:
        self.stage()
        self.dq()
        self.dkv()
        self.drel()
        self.combine()

    def grads(self):
        return self.dq_, self.dk_, self.dv_, self.drel_.to(self.rel_dtype)


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
    and rel_emb (the whole learned buffer; rows >= T get zero gradient).
    Inputs of another float dtype are upcast to f32 around the kernels and
    the output is returned in q's dtype; their gradients come back through
    the casts in their own dtypes."""
    out_dtype = q.dtype
    return FlashRelposAttention.apply(*_f32(q, k, v, rel_emb), scale, n_meta).to(out_dtype)
