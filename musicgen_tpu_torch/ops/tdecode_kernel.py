"""Kernel F: the one-token decode step of the whole Transformer, with the
sampler tail, as hand-written CUDA kernels (csrc/tdecode_attn.cu and the
Transformer GEMVs of csrc/decode_gemv.cu).

Replaces musicgen_tpu/ops/pallas_transformer_decode.py (`_tdecode_kernel` via
`fused_transformer_logits_step` and `fused_transformer_sample_step`) in its
two weight formats, bf16 and W8A16 (`_w8dot`). Steady state only: the window
is full (prompt_len == block_len == the model's block_len) and rel_base is
fixed at block_len + 5, so every ring slot is visible and the BD term of
ring slot r reads rel_emb[6 + (r - c - 1) mod S], c = stream_idx mod S. The
TPU kernel ran the step as ONE pallas_call whose grid walked the layers; here
a step is a sequence of launches on one stream:

  for each of the L layers:
    t_qkv_ln              LN1 + QKV GEMV; the new K, V rows (bf16) go into
                          ring slot c                          (decode_gemv.cu)
    tdecode_attn_split    scores, partial softmax and V sums over S / 64
                          splits of the ring + the 6 meta slots (tdecode_attn.cu)
    tdecode_attn_combine  the splits' combine                   (tdecode_attn.cu)
    t_res                 x += attn . W_proj + b                (decode_gemv.cu)
    t_fc_relu             relu(LN2(x) . W_fc + b)               (decode_gemv.cu)
    t_res                 x += h . W_out + b                    (decode_gemv.cu)
  lm_head_ln              LN_f + lm_head + bias (kernel B's)    (decode_gemv.cu)
  sample_tail             grammar, penalty, exact top-3         (decode_tail.cu)

50 launches a token at L = 8 (49 without the tail). The plain twins below
follow the JAX math line for line (`_attn_math`, `_ffn_math`, `_head_math`,
`_tail_math`): activations f32, rounded to bf16 before each product, f32
sums, the probabilities rounded to bf16 before the V readout, and the TPU
kernel's stale-row fix in `attention_plain` (the kernel chain writes the new
K and V into the ring before the attention reads it, so it needs no fix;
both read the same bf16 numbers). The rings advance IN PLACE in both.

Every wrapper takes the plain version for CPU tensors; for CUDA tensors it
launches its kernel or raises. Each launch adds one to
ops.decode_kernel.LAUNCHES[name], the name carrying "_w8a16" for an int8
product.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from ..config import NUM_META, VOCAB, TransformerConfig
from . import decode_kernel as dk
from .build import check, load_library, stream_ptr
from .decode_kernel import LN_EPS, MAX_ROWS, _bf16, _count, _need, _product, _weights, quantize_cols
from .grammar import grammar_mask

HEAD_DIM = 128  # head width of the attention kernels
ATTN_SPLIT = 64  # ring slots one attention block takes
META_ROWS = 8  # metadata slots padded to 8 rows in the pack and caches
# The pack a --fused-decode quant builds -> how its products run.
QUANT_MODES = {"bf16": "none", "int8w": "w8a16"}
_FMT = {"none": 0, "w8a16": 1}

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]  # k_meta, v_meta, k_ring, v_ring


@dataclasses.dataclass(frozen=True)
class TDims:
    n_layers: int  # 8
    batch: int
    d_model: int  # 1024
    n_heads: int  # 8
    head_dim: int  # 128
    d_ff: int  # 4096
    ring: int  # block_len (2048): ring KV slots
    padded_vocab: int  # 17920: lm_head rows / logits width
    vocab_size: int  # 17914
    dyn_start: int
    length_start: int

    @classmethod
    def create(cls, cfg: TransformerConfig, batch: int) -> "TDims":
        if cfg.n_embd % cfg.n_heads:
            raise ValueError("n_embd must be a multiple of n_heads")
        if not 1 <= batch <= MAX_ROWS:
            raise ValueError(f"decode batch must be in 1..{MAX_ROWS}, got {batch}")
        return cls(
            n_layers=cfg.n_layer,
            batch=batch,
            d_model=cfg.n_embd,
            n_heads=cfg.n_heads,
            head_dim=cfg.n_embd // cfg.n_heads,
            d_ff=4 * cfg.n_embd,
            ring=cfg.block_len,
            padded_vocab=cfg.padded_vocab,
            vocab_size=cfg.vocab_size,
            dyn_start=VOCAB.dyn_start,
            length_start=VOCAB.length_start,
        )

    @property
    def scale(self) -> float:
        return float(self.d_model) ** -0.5  # the model width (reference :67)


# ---------------------------------------------------------------------------
# Pack and caches
# ---------------------------------------------------------------------------


@torch.no_grad()
def build_transformer_decode_params(model, batch: int, quant: str = "bf16") -> dict:
    """Pack a TransformerLM's weights for kernel F (pallas_transformer_decode
    :501). Matrices stay in torch's (out, in) layout, K-contiguous; w_qkv
    stacks the heads' query, key and value rows. rel_pos_emb (H, seq_len, hd)
    becomes the ring table rel_ring (S, d_model) of rows 6.. and the meta
    table rel_meta (8, d_model) of rows 0..5, lane = h * hd + d, in bf16.
    lm_head is padded from vocab to padded_vocab rows (zero weights and bias;
    the tail never selects pad ids). quant="int8w" (or "int8") stores w_qkv,
    w_proj, w_fc, w_out and lm_w as int8 with (K / 256, N) group scales
    qkv_s, proj_s, fc_s, out_s and lm_s (quantize_cols)."""
    if quant not in ("bf16", "int8", "int8w"):
        raise ValueError(f"quant must be 'bf16', 'int8' or 'int8w', got {quant!r}")
    cfg = model.cfg
    dims = TDims.create(cfg, batch)
    L, dm, v, vp, S = cfg.n_layer, cfg.n_embd, cfg.vocab_size, dims.padded_vocab, dims.ring
    f32, bf16 = torch.float32, torch.bfloat16
    blocks = model.blocks

    def stack(fn, dtype=f32):
        return torch.stack([fn(blk) for blk in blocks]).to(dtype).contiguous()

    def rel_table(blk):
        r = blk.sa.rel_emb().to(f32)  # (H, seq_len, hd)
        return r.transpose(0, 1).reshape(r.shape[1], dm)  # (seq_len, dm)

    dev = model.lm_head.weight.device
    lm_w = torch.zeros(vp, dm, dtype=f32, device=dev)
    lm_w[:v] = model.lm_head.weight
    lm_b = torch.zeros(vp, dtype=f32, device=dev)
    lm_b[:v] = model.lm_head.bias
    gram = torch.zeros(5, vp, dtype=f32, device=dev)
    gram[:, :v] = grammar_mask(device=dev)
    rel_meta = torch.zeros(L, META_ROWS, dm, dtype=f32, device=dev)
    rel_meta[:, :NUM_META] = stack(lambda b: rel_table(b)[:NUM_META])
    tp = {
        "w_qkv": stack(lambda b: b.sa.qkv_weight(), bf16),  # (L, 3dm, dm)
        "w_proj": stack(lambda b: b.sa.proj.weight, bf16),  # (L, dm, dm)
        "proj_b": stack(lambda b: b.sa.proj.bias),  # (L, dm)
        "w_fc": stack(lambda b: b.ffwd.net[0].weight, bf16),  # (L, 4dm, dm)
        "b_fc": stack(lambda b: b.ffwd.net[0].bias),  # (L, 4dm)
        "w_out": stack(lambda b: b.ffwd.net[2].weight, bf16),  # (L, dm, 4dm)
        "b_out": stack(lambda b: b.ffwd.net[2].bias),  # (L, dm)
        "ln1": stack(lambda b: torch.stack([b.ln1.weight, b.ln1.bias])),  # (L, 2, dm)
        "ln2": stack(lambda b: torch.stack([b.ln2.weight, b.ln2.bias])),
        "ln_f": torch.stack([model.ln_f.weight, model.ln_f.bias]).to(f32).contiguous(),  # (2, dm)
        "rel_ring": stack(lambda b: rel_table(b)[NUM_META:NUM_META + S], bf16),  # (L, S, dm)
        "rel_meta": rel_meta.to(bf16),  # (L, 8, dm)
        "lm_w": lm_w.to(bf16),  # (padded_vocab, dm)
        "lm_b": lm_b,  # (padded_vocab,)
        "embed": model.token_embedding_table.weight.detach().to(f32).contiguous(),  # (vocab, dm)
        "gram": gram,  # (5, padded_vocab)
    }
    if quant != "bf16":
        for name, fn in (("w_qkv", lambda b: b.sa.qkv_weight()), ("w_proj", lambda b: b.sa.proj.weight),
                         ("w_fc", lambda b: b.ffwd.net[0].weight), ("w_out", lambda b: b.ffwd.net[2].weight)):
            qs = [quantize_cols(fn(b).detach()) for b in blocks]
            tp[name] = torch.stack([q for q, _ in qs])
            tp[name[2:] + "_s"] = torch.stack([s for _, s in qs])  # (L, G, N)
        tp["lm_w"], tp["lm_s"] = quantize_cols(lm_w)
    return tp


def check_tpack(tp: dict, quant: str) -> None:
    """Raise unless the pack's weight format is the one `quant` runs."""
    if quant not in _FMT:
        raise ValueError(f"quant must be one of {sorted(_FMT)}, got {quant!r}")
    if ("qkv_s" in tp) != (quant != "none"):
        raise ValueError(f"quant {quant!r} does not match a {'int8' if 'qkv_s' in tp else 'bf16'} pack")


def stack_transformer_cache(caches, dims: TDims) -> Carry:
    """Per-layer {'k', 'v': (B, H, seq_len, hd)} from TransformerLM.prefill ->
    (k_meta, v_meta (L, B, 8, dm), k_ring, v_ring (L, B, S, dm)), bf16, slots
    0..5 the metadata and 6.. the token ring (sample/cache.py)."""
    n, S, dm = NUM_META, dims.ring, dims.d_model

    def repack(c, lo, hi):
        x = c[:, :, lo:hi]
        return x.permute(0, 2, 1, 3).reshape(x.shape[0], hi - lo, dm).to(torch.bfloat16)

    def meta(c):
        return F.pad(repack(c, 0, n), (0, 0, 0, META_ROWS - n))

    return (torch.stack([meta(c["k"]) for c in caches]).contiguous(),
            torch.stack([meta(c["v"]) for c in caches]).contiguous(),
            torch.stack([repack(c["k"], n, n + S) for c in caches]).contiguous(),
            torch.stack([repack(c["v"], n, n + S) for c in caches]).contiguous())


def unstack_transformer_cache(carry: Carry, dims: TDims):
    """Inverse of stack_transformer_cache, in f32 (TransformerLM.step's caches)."""
    k_meta, v_meta, k_ring, v_ring = carry
    L, B, S, dm = k_ring.shape
    H, hd = dims.n_heads, dims.head_dim

    def unpack(meta, ring):
        x = torch.cat([meta[:, :NUM_META], ring], dim=1).to(torch.float32)  # (B, seq_len, dm)
        return x.reshape(B, NUM_META + S, H, hd).permute(0, 2, 1, 3).contiguous()

    return tuple({"k": unpack(k_meta[i], k_ring[i]), "v": unpack(v_meta[i], v_ring[i])} for i in range(L))


# ---------------------------------------------------------------------------
# Plain twins (the TPU kernel's `_attn_math`, `_ffn_math`)
# ---------------------------------------------------------------------------


def _layernorm(x, ln):
    """flax LayerNorm (eps 1e-6), var = E[x^2] - mean^2 (`_layernorm` :136)."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(x * x, dim=-1, keepdim=True) - mean * mean
    return (x - mean) * torch.rsqrt(var + LN_EPS) * ln[0] + ln[1]


def qkv_ln_plain(x, ln1, w_qkv, k_ring, v_ring, c: int, dims: TDims, w_s=None, quant: str = "none"):
    """zx = LN1(x) . W_qkv^T (B, 3 dm); the new K and V rows, rounded to bf16,
    are written into ring slot c right after (in place)."""
    dm = dims.d_model
    zx = _product(_layernorm(x, ln1), w_qkv, w_s, quant)
    k_ring[:, c] = zx[:, dm:2 * dm].to(torch.bfloat16)
    v_ring[:, c] = zx[:, 2 * dm:].to(torch.bfloat16)
    return zx


def _heads(t: torch.Tensor, dims: TDims) -> torch.Tensor:
    return t.to(torch.float32).reshape(*t.shape[:-1], dims.n_heads, dims.head_dim)


def attention_plain(zx, k_ring, v_ring, rel_ring, k_meta, v_meta, rel_meta, c: int, dims: TDims):
    """One step's attention (B, dm) as `_attn_math` computes it: the ring read
    as the TPU kernel reads it, slot c's score and V term taken from the new
    K and V (the stale-row fix), the rolled BD term, one f32 softmax over the
    S ring and 6 meta slots, probabilities rounded to bf16 before the V sum."""
    b, dm, S = zx.shape[0], dims.d_model, dims.ring
    q = _heads(_bf16(zx[:, :dm]), dims)  # (B, H, hd)
    k_new = _heads(_bf16(zx[:, dm:2 * dm]), dims)
    v_new = _heads(_bf16(zx[:, 2 * dm:]), dims)
    ac = torch.einsum("bhd,bshd->bhs", q, _heads(k_ring, dims))
    ac[:, :, c] = torch.einsum("bhd,bhd->bh", q, k_new)  # fresh K at the stale slot
    y = torch.einsum("bhd,shd->bhs", q, _heads(rel_ring, dims))  # age-space BD
    bd = torch.roll(y, c + 1, dims=2)  # slot-space BD
    sr = (ac + bd) * dims.scale
    sm = (torch.einsum("bhd,bjhd->bhj", q, _heads(k_meta, dims))
          + torch.einsum("bhd,jhd->bhj", q, _heads(rel_meta, dims)))  # (B, H, 8)
    meta_valid = torch.arange(META_ROWS, device=zx.device) < NUM_META
    sm = torch.where(meta_valid, sm * dims.scale, -1e30)
    m = torch.maximum(sr.amax(dim=2, keepdim=True), sm.amax(dim=2, keepdim=True))
    er = torch.exp(sr - m)
    em = torch.where(meta_valid, torch.exp(sm - m), 0.0)
    denom = er.sum(dim=2, keepdim=True) + em.sum(dim=2, keepdim=True)
    pr = er / denom
    pm = _bf16(em / denom)
    p_c = _bf16(pr[:, :, c])
    pr0 = pr.clone()
    pr0[:, :, c] = 0.0
    mv = torch.einsum("bhs,bshd->bhd", _bf16(pr0), _heads(v_ring, dims))
    mv = mv + torch.einsum("bhj,bjhd->bhd", pm, _heads(v_meta, dims))
    mv = mv + p_c[:, :, None] * v_new  # fresh V at the stale slot
    return mv.reshape(b, dm)


def attn_splits(dims: TDims) -> int:
    return -(-dims.ring // ATTN_SPLIT)


def attn_split_plain(zx, k_ring, v_ring, rel_ring, k_meta, v_meta, rel_meta, c: int, dims: TDims):
    """The split kernel's partials: per (b*h, split) the max m, the sum
    l = sum exp(s - m) and the V sum of bf16(exp(s - m)) over the split's
    ring slots (split 0 also the 6 meta slots). Returns (part_m, part_l
    (B*H, n), part_acc (B*H, n, hd))."""
    b, dm, S, hd = zx.shape[0], dims.d_model, dims.ring, dims.head_dim
    q = _heads(_bf16(zx[:, :dm]), dims)
    u = torch.remainder(torch.arange(S, device=zx.device) - c - 1, S)
    rel = _heads(rel_ring, dims)[u]  # (S, H, hd), the rel row of each ring slot
    s_ring = (torch.einsum("bhd,bshd->bhs", q, _heads(k_ring, dims))
              + torch.einsum("bhd,shd->bhs", q, rel)) * dims.scale
    s_meta = (torch.einsum("bhd,bjhd->bhj", q, _heads(k_meta, dims))
              + torch.einsum("bhd,jhd->bhj", q, _heads(rel_meta, dims)))[:, :, :NUM_META] * dims.scale
    v_all = _heads(v_ring, dims)
    ms, ls, accs = [], [], []
    for r0 in range(0, S, ATTN_SPLIT):
        r1 = min(S, r0 + ATTN_SPLIT)
        s = s_ring[:, :, r0:r1]
        v = v_all[:, r0:r1]
        if r0 == 0:
            s = torch.cat([s, s_meta], dim=2)
            v = torch.cat([v, _heads(v_meta, dims)[:, :NUM_META]], dim=1)
        m = s.amax(dim=2, keepdim=True)
        p = torch.exp(s - m)
        ms.append(m[..., 0])
        ls.append(p.sum(dim=2))
        accs.append(torch.einsum("bhs,bshd->bhd", _bf16(p), v))
    return (torch.stack(ms, dim=2).reshape(b * dims.n_heads, -1),
            torch.stack(ls, dim=2).reshape(b * dims.n_heads, -1),
            torch.stack(accs, dim=2).reshape(b * dims.n_heads, -1, hd))


def attn_combine_plain(part_m, part_l, part_acc, dims: TDims):
    """The splits rescaled by exp(m_s - m) and divided by the total, (B, dm)."""
    m = part_m.amax(dim=1, keepdim=True)
    w = torch.exp(part_m - m)
    out = (part_acc * w[:, :, None]).sum(dim=1) / (part_l * w).sum(dim=1, keepdim=True)
    return out.reshape(-1, dims.d_model)


def res_plain(x, w, bias, resid, dims: TDims, w_s=None, quant: str = "none"):
    """resid += x . W^T + b, in place (`_attn_math`'s out_proj + residual and
    `_ffn_math`'s second product + residual)."""
    return resid.add_(_product(x, w, w_s, quant) + bias)


def fc_relu_plain(x, ln2, w_fc, b_fc, dims: TDims, w_s=None, quant: str = "none"):
    """relu(LN2(x) . W_fc^T + b_fc)."""
    return torch.relu(_product(_layernorm(x, ln2), w_fc, w_s, quant) + b_fc)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _fmt(quant: str) -> int:
    if quant not in _FMT:
        raise ValueError(f"the Transformer step runs bf16 or W8A16, got quant {quant!r}")
    return _FMT[quant]


def _x(x: torch.Tensor, k: int) -> torch.Tensor:
    x = x.to(torch.float32).contiguous()
    dk._rows(x.shape[0])
    _need(x, "x", torch.float32, (x.shape[0], k), x.device)
    return x


def _ln(ln: torch.Tensor, dm: int, dev) -> Tuple[int, int]:
    _need(ln, "ln", torch.float32, (2, dm), dev)
    return ln.data_ptr(), ln[1].data_ptr()


def qkv_ln(x, ln1, w_qkv, k_ring, v_ring, c: int, dims: TDims, w_s=None, quant: str = "none"):
    if not x.is_cuda:
        return qkv_ln_plain(x, ln1, w_qkv, k_ring, v_ring, c, dims, w_s, quant)
    dm, S = dims.d_model, dims.ring
    x = _x(x, dm)
    b, dev = x.shape[0], x.device
    ln_w, ln_b = _ln(ln1, dm, dev)
    fmt = _fmt(quant)
    s_ptr = _weights(w_qkv, w_s, quant, 3 * dm, dm, dev)
    _need(k_ring, "k_ring", torch.bfloat16, (b, S, dm), dev)
    _need(v_ring, "v_ring", torch.bfloat16, (b, S, dm), dev)
    zx = torch.empty(b, 3 * dm, dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.mg_t_qkv_ln(x.data_ptr(), ln_w, ln_b, w_qkv.data_ptr(), s_ptr, zx.data_ptr(), b, dm, 3 * dm,
                          LN_EPS, k_ring.data_ptr(), v_ring.data_ptr(), S, c, fmt, stream_ptr(x))
    check(lib, err, "t_qkv_ln")
    _count("t_qkv_ln", quant)
    return zx


def attn_split(zx, k_ring, v_ring, rel_ring, k_meta, v_meta, rel_meta, c: int, dims: TDims):
    if not zx.is_cuda:
        return attn_split_plain(zx, k_ring, v_ring, rel_ring, k_meta, v_meta, rel_meta, c, dims)
    b, dev = zx.shape[0], zx.device
    dm, S, H = dims.d_model, dims.ring, dims.n_heads
    if dims.head_dim != HEAD_DIM:
        raise ValueError(f"the attention kernel is written for head_dim {HEAD_DIM}, got {dims.head_dim}")
    dk._rows(b)
    _need(zx, "zx", torch.float32, (b, 3 * dm), dev)
    for name, t, shape in (("k_ring", k_ring, (b, S, dm)), ("v_ring", v_ring, (b, S, dm)),
                           ("rel_ring", rel_ring, (S, dm)), ("k_meta", k_meta, (b, META_ROWS, dm)),
                           ("v_meta", v_meta, (b, META_ROWS, dm)), ("rel_meta", rel_meta, (META_ROWS, dm))):
        _need(t, name, torch.bfloat16, shape, dev)
    n = attn_splits(dims)
    part_m = torch.empty(b * H, n, dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(b * H, n, HEAD_DIM, dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.mg_tdecode_attn_split(zx.data_ptr(), 3 * dm, k_ring.data_ptr(), v_ring.data_ptr(), rel_ring.data_ptr(),
                                    k_meta.data_ptr(), v_meta.data_ptr(), rel_meta.data_ptr(), b, H, S, dm, c,
                                    NUM_META, dims.scale, ATTN_SPLIT, part_m.data_ptr(), part_l.data_ptr(),
                                    part_acc.data_ptr(), stream_ptr(zx))
    check(lib, err, "tdecode_attn_split")
    _count("tdecode_attn_split")
    return part_m, part_l, part_acc


def attn_combine(part_m, part_l, part_acc, dims: TDims):
    if not part_m.is_cuda:
        return attn_combine_plain(part_m, part_l, part_acc, dims)
    bh, n = part_m.shape
    dev, H = part_m.device, dims.n_heads
    if bh % H:
        raise ValueError(f"partials of {bh} rows do not divide into {H} heads")
    _need(part_m, "part_m", torch.float32, (bh, n), dev)
    _need(part_l, "part_l", torch.float32, (bh, n), dev)
    _need(part_acc, "part_acc", torch.float32, (bh, n, HEAD_DIM), dev)
    out = torch.empty(bh // H, dims.d_model, dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.mg_tdecode_attn_combine(part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
                                      bh // H, H, dims.d_model, n, stream_ptr(part_m))
    check(lib, err, "tdecode_attn_combine")
    _count("tdecode_attn_combine")
    return out


def attention(zx, k_ring, v_ring, rel_ring, k_meta, v_meta, rel_meta, c: int, dims: TDims):
    """The kernel chain's attention: split, then combine (two launches)."""
    return attn_combine(*attn_split(zx, k_ring, v_ring, rel_ring, k_meta, v_meta, rel_meta, c, dims), dims)


def res(x, w, bias, resid, dims: TDims, w_s=None, quant: str = "none"):
    if not x.is_cuda:
        return res_plain(x, w, bias, resid, dims, w_s, quant)
    dm = dims.d_model
    x = _x(x, x.shape[1])
    b, k, dev = x.shape[0], x.shape[1], x.device
    fmt = _fmt(quant)
    s_ptr = _weights(w, w_s, quant, dm, k, dev)
    _need(bias, "bias", torch.float32, (dm,), dev)
    _need(resid, "resid", torch.float32, (b, dm), dev)
    lib = load_library()
    err = lib.mg_t_res(x.data_ptr(), w.data_ptr(), s_ptr, bias.data_ptr(), resid.data_ptr(), b, k, dm, fmt,
                       stream_ptr(x))
    check(lib, err, "t_res")
    _count("t_res", quant)
    return resid


def fc_relu(x, ln2, w_fc, b_fc, dims: TDims, w_s=None, quant: str = "none"):
    if not x.is_cuda:
        return fc_relu_plain(x, ln2, w_fc, b_fc, dims, w_s, quant)
    dm, dff = dims.d_model, dims.d_ff
    x = _x(x, dm)
    b, dev = x.shape[0], x.device
    ln_w, ln_b = _ln(ln2, dm, dev)
    fmt = _fmt(quant)
    s_ptr = _weights(w_fc, w_s, quant, dff, dm, dev)
    _need(b_fc, "b_fc", torch.float32, (dff,), dev)
    h = torch.empty(b, dff, dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.mg_t_fc_relu(x.data_ptr(), ln_w, ln_b, w_fc.data_ptr(), s_ptr, b_fc.data_ptr(), h.data_ptr(), b, dm,
                           dff, LN_EPS, fmt, stream_ptr(x))
    check(lib, err, "t_fc_relu")
    _count("t_fc_relu", quant)
    return h


TStepOps = Tuple[Callable, Callable, Callable, Callable, Callable, Callable]
# (qkv, attention, residual product, fc, head, tail): the kernels, or the
# chain of plain twins on any device that the kernels are held to.
KERNEL_OPS: TStepOps = (qkv_ln, attention, res, fc_relu, dk.lm_head_ln, dk.sample_tail)
PLAIN_OPS: TStepOps = (qkv_ln_plain, attention_plain, res_plain, fc_relu_plain, dk.lm_head_ln_plain,
                       dk.sample_tail_plain)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def transformer_decode_logits(tp: dict, token: torch.Tensor, carry: Carry, dims: TDims, stream_idx: int,
                              ops: TStepOps = KERNEL_OPS, quant: str = "none") -> torch.Tensor:
    """Embed `token` (B,) and run the model one step at stream position
    `stream_idx`: (B, padded_vocab) logits with bias. The rings advance in
    place (slot stream_idx mod S). `quant` must match the pack."""
    check_tpack(tp, quant)
    qkv, attn, res_fn, fc, head = ops[:5]
    k_meta, v_meta, k_ring, v_ring = carry
    c = int(stream_idx) % dims.ring

    def s(name, i):
        return tp[name][i] if name in tp else None

    x = F.embedding(token, tp["embed"])
    for i in range(dims.n_layers):
        zx = qkv(x, tp["ln1"][i], tp["w_qkv"][i], k_ring[i], v_ring[i], c, dims, s("qkv_s", i), quant)
        a = attn(zx, k_ring[i], v_ring[i], tp["rel_ring"][i], k_meta[i], v_meta[i], tp["rel_meta"][i], c, dims)
        x = res_fn(a, tp["w_proj"][i], tp["proj_b"][i], x, dims, s("proj_s", i), quant)
        h = fc(x, tp["ln2"][i], tp["w_fc"][i], tp["b_fc"][i], dims, s("fc_s", i), quant)
        x = res_fn(h, tp["w_out"][i], tp["b_out"][i], x, dims, s("out_s", i), quant)
    return head(x, tp["ln_f"][0], tp["ln_f"][1], tp["lm_w"], tp["lm_b"], dims, tp.get("lm_s"), quant)


def fused_transformer_logits_step(tp: dict, token: torch.Tensor, carry: Carry, dims: TDims, stream_idx: int,
                                  quant: str = "none", ops: TStepOps = KERNEL_OPS):
    """One decode step: (logits (B, vocab), carry). Matches
    TransformerLM.step in the full-window regime at bf16 tolerance (W8A16:
    at its quantisation noise)."""
    logits = transformer_decode_logits(tp, token, carry, dims, stream_idx, ops, quant)
    return logits[:, :dims.vocab_size], carry


def fused_transformer_sample_step(tp: dict, token: torch.Tensor, carry: Carry, hist: torch.Tensor,
                                  bucket: torch.Tensor, dims: TDims, stream_idx: int, quant: str = "none",
                                  ops: TStepOps = KERNEL_OPS):
    """One decode step with the sampler tail: (vals (B, 3), idxs (B, 3),
    carry); ties to the lowest index."""
    logits = transformer_decode_logits(tp, token, carry, dims, stream_idx, ops, quant)
    vals, idxs = ops[5](logits, tp["gram"], hist, bucket, dims)
    return vals, idxs, carry
