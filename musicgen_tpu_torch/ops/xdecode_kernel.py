"""Kernel G: the one-token decode step of the whole xLSTM stack, with the
sampler tail, as hand-written CUDA kernels: one persistent launch a token
(csrc/xlstm_step.cu) and kernel B's tail launch, or the same stages as a
chain of launches (csrc/xlstm_decode.cu).

Replaces musicgen_tpu/ops/pallas_xlstm_decode.py (`_xlstm_kernel` via
`fused_xlstm_logits_step` and `fused_xlstm_sample_step`) in its formats: bf16
or W8A16 (`_w8dot`) weights, the mLSTM matrix memory stored in f32 or bf16
(`-sb16`: `stack_xlstm_states(state_dtype=torch.bfloat16)`; the math stays
f32). The TPU kernel ran the step as ONE pallas_call whose grid walked the
blocks. Here, on CUDA tensors, `fused_xlstm_logits_step` and
`fused_xlstm_sample_step` run it as one cooperative launch (`xlstm_step`):
54 stages (the embedding, 4 a mLSTM block, 6 an sLSTM block, the head),
each cut into items that `xlstm_plan` deals over the SMs, separated by
counters instead of launches. With `ops=KERNEL_OPS` they run the same items
as a chain of launches on one stream, one a stage, which is the step's
per-stage oracle:

  for each mLSTM block:
    xm_up        LN + up-projection GEMV -> [x_m | z]           (xlstm_decode.cu)
    xm_prep      conv step, silu, blocksize-4 q, k, v
    xm_gates     f32 gate products, m / f' / i', n update, denominator
    xm_memory    S = f' S + i' k v^T and the readout q.S / denom
    xm_out       head norm, skip, silu(z) gate
    xm_down      down-projection GEMV + residual
  for each sLSTM block:
    xs_prep      LN, conv step, silu
    xs_in (x2)   W_if x_c, W_zo LN(x)
    xs_cell      bf16 h . bf16 R, exp-gated cell, group norm, residual
    xs_ffn_up    LN + GEMV + bias + tanh-GELU
    xs_ffn_down  GEMV + bias + residual
  lm_head_ln     LN_f + lm_head + bias (kernel B's)              (decode_gemv.cu)
  sample_tail    grammar, penalty, exact top-3 (kernel B's)      (decode_tail.cu)

A token is 2 launches on the one-launch path (`xlstm_step`, `sample_tail`)
and 68 on the chain at the reference size (7 mLSTM and 4 sLSTM blocks; 1 and
67 without the tail), XDims.launches_per_token. The step equals the chain
bit for bit: both run csrc/xlstm_ops.cuh's items in the same order. The
plain versions below follow the TPU kernel's math
line for line (`_mlstm_block_math`, `_slstm_block_math`, `_head_math`):
activations f32, rounded to bf16 before each big product with f32 sums, the
mLSTM gate products in f32, h rounded to bf16 against the bf16 recurrent
weights, LayerNorm variance as E[x^2] - mean^2, S rounded to its storage
dtype at the store only; `xm_gates_items_plain` and `xm_memory_items_plain`
mirror how the kernels split the gate products and the readout into items
(ITEM_OPS). What is TPU layout and not carried over: the rank-2
state S2[h*DK+kk, b*DV+vv], the eye(B) and one-hot contractions, m in nm's
pad lanes, the 8-row padding, the 7-band lane-shift form of the blocksize-4
products. The port's pack and stacked state are its own:

  carry = (conv_m (M, B, 3, di), s_m (M, B, H, DK, DV) f32 or bf16,
           n_m (M, B, H, DK), m_m (M, B, H), conv_s (S, B, 3, d),
           hcnm_s (S, 4, B, H, DH))

and stack_xlstm_states / unstack_xlstm_states round-trip XLSTMLM.prefill's
per-block states exactly (f32 storage). The residual stream x and every
state advance IN PLACE in both the kernels and their plain versions.

Every wrapper takes the plain version for CPU tensors; for CUDA tensors it
launches its kernel or raises. Each launch adds one to
ops.decode_kernel.LAUNCHES[name], the name carrying "_w8a16" for an int8
product and "_sb16" for the bf16-stored matrix memory ("xlstm_step",
"xlstm_step_w8a16_sb16", ...).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import VOCAB, XLSTMConfig
from . import decode_kernel as dk
from .build import check, load_library, stream_ptr
from .decode_kernel import LN_EPS, MAX_ROWS, QUANT_GROUP, _bf16, _count, _need, _product, quantize_cols
from .grammar import grammar_mask

GROUP_EPS = 1e-5  # the mLSTM head norm and the sLSTM group norm
TEAM = 256  # threads of a work item (csrc/decode_ops.cuh TEAM)
XM_CHUNK = 16  # channels of a gate chunk: one up-projection tile (csrc/xlstm_ops.cuh)
XM_NJ = 8  # rows of S a thread holds in flight (XM_NJ)
XS_UNITS = 16  # sLSTM units of a recurrence item (XS_UNITS)
XM_MAX_DK = 8 * TEAM  # the widest mLSTM head the items take (XM_MAX_DK)
XS_MAX_DH = 4 * TEAM  # the widest sLSTM head (XS_MAX_DH); past XS_TILE_DH = TEAM a cell item reads R from L2
XS_TILE_DH = TEAM
XS_PREP_COLS = 128  # columns of an sLSTM prep item (XS_PREP_COLS)
LANE = 128  # the FFN width is padded to a multiple of this, as in the TPU pack
# The pack a --fused-decode quant builds -> how its products run.
QUANT_MODES = {"bf16": "none", "int8w": "w8a16"}
_FMT = {"none": 0, "w8a16": 1}
_PRO = {"plain": 0, "ln": 2}  # csrc/decode_ops.cuh GEMV prologues
_EPI = {"store": 0, "bias_residual": 5, "residual": 6, "bias_gelu": 7}  # and epilogues

Carry = Tuple[torch.Tensor, ...]  # (conv_m, s_m, n_m, m_m, conv_s, hcnm_s)


def mem_rows_per_item(dv: int) -> int:
    """Rows of S a matrix-memory item updates: XM_NJ passes of TEAM threads
    with 4 columns each, one row a pass past DV = 4 TEAM (each thread then
    holds DV / (4 TEAM) column quads; csrc/xlstm_ops.cuh xm_rows_per_item)."""
    return XM_NJ * (TEAM // (dv // 4) if dv // 4 <= TEAM else 1)


def fusable(cfg: XLSTMConfig) -> bool:
    """Whether kernel G takes this configuration (as the TPU kernel, which
    asserts the blocksize and the conv width and stacks both block kinds)."""
    n_s = len(cfg.slstm_at)
    return cfg.qkv_proj_blocksize == 4 and cfg.conv1d_kernel_size == 4 and 0 < n_s < cfg.num_blocks


@dataclasses.dataclass(frozen=True)
class XDims:
    n_blocks: int  # 11
    slstm_at: Tuple[int, ...]  # (1, 4, 7, 10)
    batch: int
    d_model: int  # 1024
    heads: int  # 4
    m_inner: int  # 2 * d_model = 2048
    m_dh: int  # m_inner / heads = 512
    s_dh: int  # d_model / heads = 256
    ffn_inner: int  # int(1.3 * d_model) = 1331
    ffn_pad: int  # padded to a multiple of 128 = 1408
    padded_vocab: int  # 17920
    vocab_size: int  # 17914
    dyn_start: int
    length_start: int

    @classmethod
    def create(cls, cfg: XLSTMConfig, batch: int) -> "XDims":
        if not fusable(cfg):
            raise ValueError("the xLSTM decode kernels take qkv blocksize 4, conv kernel 4 and at least one "
                             "mLSTM and one sLSTM block")
        if not 1 <= batch <= MAX_ROWS:
            raise ValueError(f"decode batch must be in 1..{MAX_ROWS}, got {batch}")
        d, di = cfg.embedding_dim, cfg.mlstm_inner
        return cls(
            n_blocks=cfg.num_blocks,
            slstm_at=tuple(cfg.slstm_at),
            batch=batch,
            d_model=d,
            heads=cfg.num_heads,
            m_inner=di,
            m_dh=di // cfg.num_heads,
            s_dh=d // cfg.num_heads,
            ffn_inner=cfg.ffn_inner,
            ffn_pad=-(-cfg.ffn_inner // LANE) * LANE,
            padded_vocab=cfg.padded_vocab,
            vocab_size=cfg.vocab_size,
            dyn_start=VOCAB.dyn_start,
            length_start=VOCAB.length_start,
        )

    @property
    def n_mlstm(self) -> int:
        return self.n_blocks - len(self.slstm_at)

    @property
    def n_slstm(self) -> int:
        return len(self.slstm_at)

    def launches_per_token(self, tail: bool = True, step: bool = False) -> int:
        """Launches a token: the one-launch step's (step=True) or the
        chain's, with or without the sampler tail."""
        if step:
            return 1 + int(tail)
        return 6 * self.n_mlstm + 6 * self.n_slstm + 1 + int(tail)


# ---------------------------------------------------------------------------
# Pack and states
# ---------------------------------------------------------------------------

# The matrices a token streams, and their int8 scales' keys.
BIG = ("m_w_up", "m_w_down", "s_w_if", "s_w_zo", "s_ffn_up", "s_ffn_down", "lm_w")
# BIG's int8 matrices by the quantizer's site under 'stack/block_{b}/', as the JAX package names them.
_SITES = {"m_w_up": "mlstm/up_proj", "m_w_down": "mlstm/down_proj", "s_w_if": "slstm/w_i", "s_w_zo": "slstm/w_z",
          "s_ffn_up": "ffn/up", "s_ffn_down": "ffn/down"}


@torch.no_grad()
def build_xlstm_decode_params(model, batch: int, quant: str = "bf16", quantizer=None) -> dict:
    """Pack an XLSTMLM's weights for kernel G (build_xlstm_decode_params
    :682), stacked over the mLSTM blocks (m_*) and the sLSTM blocks (s_*).
    Matrices stay in torch's (out, in) layout, K-contiguous. The FFN is
    padded from ffn_inner to ffn_pad (zero rows of the up-projection and its
    bias, zero columns of the down-projection: gelu(0) = 0 keeps the pad
    lanes inert); lm_head is padded from vocab to padded_vocab rows (zero
    weights and bias; the tail never selects pad ids). The sLSTM recurrent
    kernel becomes per-head (H, DH, 4 DH) bf16 blocks, R_h[d, g*DH + e] =
    R[g, h, d, e]. quant="int8w" (or "int8") stores the seven big matrices
    as int8 with (K / 256, N) group scales `<name>_s` (quantize_cols; the
    FFN down-projection, K = ffn_pad not a multiple of 256, has one group).
    `quantizer`, a (site, w) -> (q, s) callable in quantize_cols' layout
    (e.g. ops/gptq.make_gptq_quantizer), replaces quantize_cols for each
    int8 matrix, its sites 'stack/block_{b}/<_SITES>' and 'lm_head' (a
    concatenated pair, w_i|w_f or w_z|w_o, under its first member's)."""
    if quant not in ("bf16", "int8", "int8w"):
        raise ValueError(f"quant must be 'bf16', 'int8' or 'int8w', got {quant!r}")
    cfg = model.cfg
    dims = XDims.create(cfg, batch)
    d, H, DH, v, vp = dims.d_model, dims.heads, dims.s_dh, cfg.vocab_size, dims.padded_vocab
    f32, bf16 = torch.float32, torch.bfloat16
    blocks = list(model.layers.blocks)
    m_layers = [blk for i, blk in enumerate(blocks) if i not in dims.slstm_at]
    s_layers = [blk for i, blk in enumerate(blocks) if i in dims.slstm_at]
    fpad = dims.ffn_pad - dims.ffn_inner

    def stack(layers, fn):
        return torch.stack([fn(blk).detach().to(f32) for blk in layers]).contiguous()

    def ln(norm):
        return torch.stack([norm.weight, norm.bias])

    dev = model.token_embedding.weight.device
    lm_w = torch.zeros(vp, d, dtype=f32, device=dev)
    lm_w[:v] = model.output_layer.weight
    lm_b = torch.zeros(vp, dtype=f32, device=dev)
    lm_b[:v] = model.output_layer.bias
    gram = torch.zeros(5, vp, dtype=f32, device=dev)
    gram[:, :v] = grammar_mask(device=dev)
    wp = {
        "m_ln": stack(m_layers, lambda b: ln(b.xlstm_norm)),  # (M, 2, d)
        "m_w_up": stack(m_layers, lambda b: b.xlstm.proj_up.weight),  # (M, 2 di, d)
        "m_conv_w": stack(m_layers, lambda b: b.xlstm.conv1d.taps),  # (M, 4, di)
        "m_conv_b": stack(m_layers, lambda b: b.xlstm.conv1d.conv.bias),  # (M, di)
        "m_qkv_w": stack(m_layers, lambda b: torch.stack([b.xlstm.q_proj.weight, b.xlstm.k_proj.weight,
                                                          b.xlstm.v_proj.weight])),  # (M, 3, di/4, 4, 4) (out, in)
        "m_w_gate": stack(m_layers, lambda b: torch.cat([b.xlstm.mlstm_cell.igate.weight,
                                                         b.xlstm.mlstm_cell.fgate.weight])),  # (M, 2H, 3 di)
        "m_gate_b": stack(m_layers, lambda b: torch.cat([b.xlstm.mlstm_cell.igate.bias,
                                                         b.xlstm.mlstm_cell.fgate.bias])),  # (M, 2H)
        "m_outnorm": stack(m_layers, lambda b: b.xlstm.mlstm_cell.outnorm.weight),  # (M, di)
        "m_skip": stack(m_layers, lambda b: b.xlstm.learnable_skip),  # (M, di)
        "m_w_down": stack(m_layers, lambda b: b.xlstm.proj_down.weight),  # (M, d, di)
        "s_ln": stack(s_layers, lambda b: ln(b.xlstm_norm)),  # (S, 2, d)
        "s_conv_w": stack(s_layers, lambda b: b.xlstm.conv1d.taps),  # (S, 4, d)
        "s_conv_b": stack(s_layers, lambda b: b.xlstm.conv1d.conv.bias),  # (S, d)
        "s_w_if": stack(s_layers, lambda b: torch.cat([b.xlstm.igate.weight, b.xlstm.fgate.weight])),  # (S, 2d, d)
        "s_w_zo": stack(s_layers, lambda b: torch.cat([b.xlstm.zgate.weight, b.xlstm.ogate.weight])),
        "s_r_w": stack(s_layers, lambda b: b.xlstm.slstm_cell.r().permute(1, 2, 0, 3).reshape(H, DH, 4 * DH)),
        "s_bias": stack(s_layers, lambda b: b.xlstm.slstm_cell.b().reshape(4, d)),  # (S, 4, d) [g][h*DH+e]
        "s_gn": stack(s_layers, lambda b: b.xlstm.group_norm.weight),  # (S, d)
        "s_ln_ffn": stack(s_layers, lambda b: ln(b.ffn_norm)),  # (S, 2, d)
        "s_ffn_up": stack(s_layers, lambda b: F.pad(b.ffn.proj_up.weight, (0, 0, 0, fpad))),  # (S, ffn_pad, d)
        "s_ffn_up_b": stack(s_layers, lambda b: F.pad(b.ffn.proj_up.bias, (0, fpad))),  # (S, ffn_pad)
        "s_ffn_down": stack(s_layers, lambda b: F.pad(b.ffn.proj_down.weight, (0, fpad))),  # (S, d, ffn_pad)
        "s_ffn_down_b": stack(s_layers, lambda b: b.ffn.proj_down.bias),  # (S, d)
        "ln_f": ln(model.layers.post_blocks_norm).detach().to(f32).contiguous(),  # (2, d)
        "lm_w": lm_w,  # (padded_vocab, d)
        "lm_b": lm_b,  # (padded_vocab,)
        "embed": model.token_embedding.weight.detach().to(f32).contiguous(),  # (vocab, d)
        "gram": gram,  # (5, padded_vocab)
    }
    wp["s_r_w"] = wp["s_r_w"].to(bf16)
    qfn = quantizer or (lambda _site, w: quantize_cols(w))
    block_of = {"m": [i for i in range(len(blocks)) if i not in dims.slstm_at],
                "s": [i for i in range(len(blocks)) if i in dims.slstm_at]}
    for name in BIG:
        w = wp[name]
        if quant == "bf16":
            wp[name] = w.to(bf16)
        elif name == "lm_w":
            wp[name], wp["lm_s"] = qfn("lm_head", w)
        else:
            qs = [qfn(f"stack/block_{b}/{_SITES[name]}", m) for b, m in zip(block_of[name[0]], w)]
            wp[name] = torch.stack([q for q, _ in qs])
            wp[name + "_s"] = torch.stack([s for _, s in qs])  # (n, G, N)
    return wp


def check_xpack(wp: dict, quant: str) -> None:
    """Raise unless the pack's weight format is the one `quant` runs."""
    if quant not in _FMT:
        raise ValueError(f"the xLSTM step runs bf16 or W8A16, got quant {quant!r}")
    if ("lm_s" in wp) != (quant != "none"):
        raise ValueError(f"quant {quant!r} does not match a {'int8' if 'lm_s' in wp else 'bf16'} pack")


def stack_xlstm_states(states, dims: XDims, state_dtype: torch.dtype = torch.float32) -> Carry:
    """XLSTMLM.prefill's per-block state dicts -> the stacked carry (module
    docstring). state_dtype sets the mLSTM matrix memory's STORAGE dtype
    only (bf16 halves its stream); every other state stays f32."""
    f32 = torch.float32
    m = [s for i, s in enumerate(states) if i not in dims.slstm_at]
    s = [st for i, st in enumerate(states) if i in dims.slstm_at]
    return (
        torch.stack([st["conv"].to(f32) for st in m]).contiguous(),
        torch.stack([st["mlstm"][0] for st in m]).to(state_dtype).contiguous(),
        torch.stack([st["mlstm"][1].to(f32) for st in m]).contiguous(),
        torch.stack([st["mlstm"][2].to(f32) for st in m]).contiguous(),
        torch.stack([st["conv"].to(f32) for st in s]).contiguous(),
        torch.stack([torch.stack([t.to(f32) for t in st["slstm"]]) for st in s]).contiguous(),
    )


def unstack_xlstm_states(carry: Carry, dims: XDims):
    """Inverse of stack_xlstm_states, in f32 (XLSTMLM.step's states)."""
    conv_m, s_m, n_m, m_m, conv_s, hcnm_s = carry
    out, mi, si = [], 0, 0
    for i in range(dims.n_blocks):
        if i in dims.slstm_at:
            out.append({"conv": conv_s[si], "slstm": tuple(hcnm_s[si, g] for g in range(4))})
            si += 1
        else:
            out.append({"conv": conv_m[mi], "mlstm": (s_m[mi].to(torch.float32), n_m[mi], m_m[mi])})
            mi += 1
    return tuple(out)


# ---------------------------------------------------------------------------
# Plain versions (the TPU kernel's `_mlstm_block_math`, `_slstm_block_math`)
# ---------------------------------------------------------------------------


def _layernorm(x, ln, eps: float = LN_EPS):
    """flax LayerNorm, var = E[x^2] - mean^2 (`_layernorm` :143)."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(x * x, dim=-1, keepdim=True) - mean * mean
    return (x - mean) * torch.rsqrt(var + eps) * ln[0] + ln[1]


def _headblock_norm(x, dh: int):
    """Per-head LayerNorm without scale over dh-wide blocks of the last axis
    (`_headblock_norm` :182)."""
    xh = x.reshape(*x.shape[:-1], -1, dh)
    mean = torch.mean(xh, dim=-1, keepdim=True)
    var = torch.mean(xh * xh, dim=-1, keepdim=True) - mean * mean
    return ((xh - mean) * torch.rsqrt(var + GROUP_EPS)).reshape(x.shape)


def _conv_step(cs, x_new, conv_w, conv_b):
    """4-tap causal conv step; cs (B, 3, C) oldest -> newest, advanced in place."""
    y = cs[:, 0] * conv_w[0] + cs[:, 1] * conv_w[1] + cs[:, 2] * conv_w[2] + x_new * conv_w[3] + conv_b
    cs.copy_(torch.stack([cs[:, 1], cs[:, 2], x_new], dim=1))
    return y


def up_ln_plain(x, ln, w, dims: XDims, w_s=None, quant: str = "none"):
    """up = W_up . LN(x) (B, 2 di) = [x_m | z]."""
    return _product(_layernorm(x, ln), w, w_s, quant)


def gemv_plain(x, w, dims: XDims, w_s=None, quant: str = "none"):
    """x . W^T (the sLSTM input gates W_if x_c and W_zo LN(x))."""
    return _product(x, w, w_s, quant)


def down_res_plain(y, w, x, dims: XDims, w_s=None, quant: str = "none"):
    """x += y . W_down^T, in place."""
    return x.add_(_product(y, w, w_s, quant))


def ffn_up_plain(x, ln, w, b, dims: XDims, w_s=None, quant: str = "none"):
    """gelu_tanh(W_up . LN(x) + b) (B, ffn_pad)."""
    return F.gelu(_product(_layernorm(x, ln), w, w_s, quant) + b, approximate="tanh")


def ffn_down_plain(u, w, b, x, dims: XDims, w_s=None, quant: str = "none"):
    """x += (u . W_down^T + b), in place."""
    return x.add_(_product(u, w, w_s, quant) + b)


def xm_prep_plain(up, conv_w, conv_b, conv_state, qkv_w, dims: XDims):
    """The conv step on x_m (state in place), x_c = silu, the blocksize-4
    q, k (from x_c) and v (from x_m). Returns buf (B, 4, di) =
    [q | k | v | x_c]."""
    b, di = up.shape[0], dims.m_inner
    x_m = up[:, :di]
    y = _conv_step(conv_state, x_m, conv_w, conv_b)
    x_c = y * torch.sigmoid(y)

    def blockwise(x, w):  # w (nb, out, in)
        return torch.einsum("bni,nji->bnj", x.reshape(b, -1, 4), w).reshape(b, di)

    return torch.stack([blockwise(x_c, qkv_w[0]), blockwise(x_c, qkv_w[1]), blockwise(x_m, qkv_w[2]), x_c], dim=1)


def _gates_finish(gates, buf, n_st, m_st, dims: XDims):
    """From the gate products (B, 2H): m, f', i', the normalizer and the
    denominator (xm_gates_plain)."""
    b, H, DK = buf.shape[0], dims.heads, dims.m_dh
    i_pre, f_pre = gates[:, :H], gates[:, H:2 * H]
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + m_st, i_pre)
    f_act = torch.exp(log_f + m_st - m_new)
    i_act = torch.exp(i_pre - m_new)
    q, k = buf[:, 0].reshape(b, H, DK), buf[:, 1].reshape(b, H, DK)
    n_new = f_act[..., None] * n_st + i_act[..., None] * (k * (1.0 / math.sqrt(DK)))
    denom = torch.maximum((q * n_new).sum(dim=-1).abs(), torch.exp(-m_new))
    n_st.copy_(n_new)
    m_st.copy_(m_new)
    return torch.stack([f_act, i_act, denom, torch.zeros_like(denom)], dim=-1)


def xm_gates_plain(buf, w_gate, gate_b, n_st, m_st, dims: XDims):
    """i, f = W_gate [q | k | v] + b in f32; m = max(logsigmoid(f) + m, i),
    f' and i'; n = f' n + i' k / sqrt(DK) and m advance in place. Returns
    sc (B, H, 4) = (f', i', max(|q.n|, exp(-m)), 0)."""
    b, di = buf.shape[0], dims.m_inner
    gates = buf[:, :3].reshape(b, 3 * di) @ w_gate.t() + gate_b
    return _gates_finish(gates, buf, n_st, m_st, dims)


def gate_partials_plain(buf, w_gate, dims: XDims):
    """The gate products as the kernels split them: (B, 2H, di / 16)
    partials, chunk c over channels [16 c, 16 c + 16) of q, k and v (the
    channels of up-projection tile c, whose epilogue computes them in the
    one-launch step)."""
    b, di, nch = buf.shape[0], dims.m_inner, dims.m_inner // XM_CHUNK
    g = buf[:, :3].reshape(b, 3, nch, XM_CHUNK)
    return torch.einsum("bpcj,gpcj->bgc", g, w_gate.reshape(-1, 3, nch, XM_CHUNK))


def xm_gates_items_plain(buf, w_gate, gate_b, n_st, m_st, dims: XDims):
    """xm_gates_plain on the kernels' items: the gate partials of every
    16-channel chunk, added in chunk order."""
    part = gate_partials_plain(buf, w_gate, dims)
    gates = part[..., 0]
    for c in range(1, part.shape[-1]):
        gates = gates + part[..., c]
    return _gates_finish(gates + gate_b, buf, n_st, m_st, dims)


def xm_memory_plain(buf, sc, s_st, dims: XDims):
    """S = f' S + (i' k / sqrt(DK)) v^T per (b, h), stored in s_st's dtype in
    place; the readout h = q . S (the f32 update) / denom. Returns h (B, di)."""
    b, H, DK, di = buf.shape[0], dims.heads, dims.m_dh, dims.m_inner
    q, k, v = (buf[:, i].reshape(b, H, DK) for i in range(3))
    ik = sc[..., 1:2] * (k * (1.0 / math.sqrt(DK)))
    s_new = s_st.to(torch.float32) * sc[..., 0, None, None] + ik[..., :, None] * v[..., None, :]
    h = torch.einsum("bhk,bhkv->bhv", q, s_new) / sc[..., 2:3]
    s_st.copy_(s_new.to(s_st.dtype))
    return h.reshape(b, di)


def readout_partials_plain(buf, s_new, dims: XDims):
    """The readout as the kernels split it: (B, H, nrc, DV) partials q.S
    over each item's mem_rows_per_item(DV) rows of the updated S."""
    b, H, DK = buf.shape[0], dims.heads, dims.m_dh
    rows = mem_rows_per_item(DK)
    q = buf[:, 0].reshape(b, H, DK // rows, rows)
    return torch.einsum("bhcr,bhcrv->bhcv", q, s_new.reshape(b, H, DK // rows, rows, DK))


def xm_memory_items_plain(buf, sc, s_st, dims: XDims):
    """xm_memory_plain on the kernels' items: the readout partials of each
    block of rows, added in row order, over the denominator."""
    b, H, DK, di = buf.shape[0], dims.heads, dims.m_dh, dims.m_inner
    k, v = buf[:, 1].reshape(b, H, DK), buf[:, 2].reshape(b, H, DK)
    ik = sc[..., 1:2] * (k * (1.0 / math.sqrt(DK)))
    s_new = s_st.to(torch.float32) * sc[..., 0, None, None] + ik[..., :, None] * v[..., None, :]
    part = readout_partials_plain(buf, s_new, dims)
    h = part[:, :, 0]
    for c in range(1, part.shape[2]):
        h = h + part[:, :, c]
    s_st.copy_(s_new.to(s_st.dtype))
    return (h / sc[..., 2:3]).reshape(b, di)


def xm_out_plain(h_att, buf, up, outnorm, skip, dims: XDims):
    """y = (headnorm(h) * outnorm + skip * x_c) * silu(z) (B, di)."""
    di = dims.m_inner
    h = _headblock_norm(h_att, dims.m_dh) * outnorm + skip * buf[:, 3]
    z = up[:, di:2 * di]
    return h * (z * torch.sigmoid(z))


def xs_prep_plain(x, ln, conv_w, conv_b, conv_state, dims: XDims):
    """xn = LN(x), the conv step on xn (state in place), x_c = silu. Returns
    xs (2, B, d) = [x_c; xn]."""
    xn = _layernorm(x, ln)
    y = _conv_step(conv_state, xn, conv_w, conv_b)
    return torch.stack([y * torch.sigmoid(y), xn])


def xs_cell_plain(wif, wzo, r_w, bias, gn, hcnm, x, dims: XDims):
    """The recurrent term bf16(h) . R_h (bf16 weights, f32 sums), the
    exp-gated cell (hcnm (4, B, H, DH) in place), the head-wise group norm and
    the residual x += gn(h) * gn_scale (in place). Returns x."""
    b, H, DH, d = x.shape[0], dims.heads, dims.s_dh, dims.d_model
    h_prev, c_prev, n_prev, m_prev = (hcnm[g].reshape(b, d) for g in range(4))
    rec = torch.einsum("bhd,hdj->bhj", _bf16(hcnm[0]), r_w.to(torch.float32))  # (B, H, 4 DH)
    rec = rec.reshape(b, H, 4, DH).permute(0, 2, 1, 3).reshape(b, 4, d)
    i_pre = wif[:, :d] + rec[:, 0] + bias[0]
    f_pre = wif[:, d:] + rec[:, 1] + bias[1]
    z_pre = wzo[:, :d] + rec[:, 2] + bias[2]
    o_pre = wzo[:, d:] + rec[:, 3] + bias[3]
    m_new = torch.maximum(f_pre + m_prev, i_pre)
    i_act = torch.exp(i_pre - m_new)
    f_act = torch.exp(f_pre + m_prev - m_new)
    c_new = f_act * c_prev + i_act * torch.tanh(z_pre)
    n_new = f_act * n_prev + i_act
    h_new = torch.sigmoid(o_pre) * c_new / n_new
    hcnm.copy_(torch.stack([h_new, c_new, n_new, m_new]).reshape(hcnm.shape))
    return x.add_(_headblock_norm(h_new, DH) * gn)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


# Zeroed int32 buffers the kernels leave zero (the chain's tickets, the
# step's counters), one per (use, size, device): a launch draws on them and
# resets them, so a later launch or a CUDA-graph replay starts clean. The
# launches on one device share them, so they run on one stream.
_ZEROS: Dict[tuple, torch.Tensor] = {}


def _zeros_i32(tag: str, n: int, device) -> torch.Tensor:
    key = (tag, n, str(device))
    if key not in _ZEROS:
        _ZEROS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return _ZEROS[key]


def _x(x: torch.Tensor, k: int) -> torch.Tensor:
    dk._rows(x.shape[0])
    _need(x, "x", torch.float32, (x.shape[0], k), x.device)
    return x


def _gemv(name: str, x, w, w_s, quant: str, out, pro: str, epi: str, ln=None, bias=None):
    """One mg_x_gemv launch: out (R, N) = epi(pro(x) . W^T)."""
    if quant not in _FMT:
        raise ValueError(f"the xLSTM step runs bf16 or W8A16, got quant {quant!r}")
    r, k = x.shape
    n, dev = out.shape[1], x.device
    _x(x, k)
    _need(out, "out", torch.float32, (r, n), dev)
    qgroup = QUANT_GROUP if k % QUANT_GROUP == 0 else k
    err = dk.gemv_shape_error(k, n, qgroup, quant, r)
    if err:
        raise ValueError(err)
    if quant == "none":
        _need(w, "w", torch.bfloat16, (n, k), dev)
        s_ptr = 0
    else:
        _need(w, "w", torch.int8, (n, k), dev)
        _need(w_s, "w_s", torch.float32, (k // qgroup, n), dev)
        s_ptr = w_s.data_ptr()
    pw = pb = 0
    if ln is not None:
        _need(ln, "ln", torch.float32, (2, k), dev)
        pw, pb = ln.data_ptr(), ln[1].data_ptr()
    b_ptr = 0
    if bias is not None:
        _need(bias, "bias", torch.float32, (n,), dev)
        b_ptr = bias.data_ptr()
    lib = load_library()
    err = lib.mg_x_gemv(x.data_ptr(), pw, pb, w.data_ptr(), s_ptr, b_ptr, out.data_ptr(), r, k, n, qgroup, LN_EPS,
                        _PRO[pro], _EPI[epi], _FMT[quant], stream_ptr(x))
    check(lib, err, name)
    _count(name, quant)
    return out


def up_ln(x, ln, w, dims: XDims, w_s=None, quant: str = "none"):
    if not x.is_cuda:
        return up_ln_plain(x, ln, w, dims, w_s, quant)
    out = torch.empty(x.shape[0], 2 * dims.m_inner, dtype=torch.float32, device=x.device)
    return _gemv("xm_up", x, w, w_s, quant, out, "ln", "store", ln=ln)


def gemv(x, w, dims: XDims, w_s=None, quant: str = "none"):
    if not x.is_cuda:
        return gemv_plain(x, w, dims, w_s, quant)
    out = torch.empty(x.shape[0], w.shape[0], dtype=torch.float32, device=x.device)
    return _gemv("xs_in", x, w, w_s, quant, out, "plain", "store")


def down_res(y, w, x, dims: XDims, w_s=None, quant: str = "none"):
    if not y.is_cuda:
        return down_res_plain(y, w, x, dims, w_s, quant)
    return _gemv("xm_down", y, w, w_s, quant, x, "plain", "residual")


def ffn_up(x, ln, w, b, dims: XDims, w_s=None, quant: str = "none"):
    if not x.is_cuda:
        return ffn_up_plain(x, ln, w, b, dims, w_s, quant)
    out = torch.empty(x.shape[0], dims.ffn_pad, dtype=torch.float32, device=x.device)
    return _gemv("xs_ffn_up", x, w, w_s, quant, out, "ln", "bias_gelu", ln=ln, bias=b)


def ffn_down(u, w, b, x, dims: XDims, w_s=None, quant: str = "none"):
    if not u.is_cuda:
        return ffn_down_plain(u, w, b, x, dims, w_s, quant)
    return _gemv("xs_ffn_down", u, w, w_s, quant, x, "plain", "bias_residual", bias=b)


def xm_prep(up, conv_w, conv_b, conv_state, qkv_w, dims: XDims):
    if not up.is_cuda:
        return xm_prep_plain(up, conv_w, conv_b, conv_state, qkv_w, dims)
    b, dev, di = up.shape[0], up.device, dims.m_inner
    _x(up, 2 * di)
    _need(conv_w, "conv_w", torch.float32, (4, di), dev)
    _need(conv_b, "conv_b", torch.float32, (di,), dev)
    _need(conv_state, "conv_state", torch.float32, (b, 3, di), dev)
    _need(qkv_w, "qkv_w", torch.float32, (3, di // 4, 4, 4), dev)
    buf = torch.empty(b, 4, di, dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.mg_xm_prep(up.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), conv_state.data_ptr(),
                         qkv_w.data_ptr(), buf.data_ptr(), b, di, stream_ptr(up))
    check(lib, err, "xm_prep")
    _count("xm_prep")
    return buf


def xm_gates(buf, w_gate, gate_b, n_st, m_st, dims: XDims):
    if not buf.is_cuda:
        return xm_gates_plain(buf, w_gate, gate_b, n_st, m_st, dims)
    b, dev, H, di = buf.shape[0], buf.device, dims.heads, dims.m_inner
    dk._rows(b)
    _need(buf, "buf", torch.float32, (b, 4, di), dev)
    _need(w_gate, "w_gate", torch.float32, (2 * H, 3 * di), dev)
    _need(gate_b, "gate_b", torch.float32, (2 * H,), dev)
    _need(n_st, "n_state", torch.float32, (b, H, dims.m_dh), dev)
    _need(m_st, "m_state", torch.float32, (b, H), dev)
    sc = torch.empty(b, H, 4, dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.mg_xm_gates(buf.data_ptr(), w_gate.data_ptr(), gate_b.data_ptr(), n_st.data_ptr(), m_st.data_ptr(),
                          sc.data_ptr(), b, H, di, stream_ptr(buf))
    check(lib, err, "xm_gates")
    _count("xm_gates")
    return sc


def xm_memory(buf, sc, s_st, dims: XDims):
    if not buf.is_cuda:
        return xm_memory_plain(buf, sc, s_st, dims)
    b, dev, H, DK, di = buf.shape[0], buf.device, dims.heads, dims.m_dh, dims.m_inner
    dk._rows(b)
    _need(buf, "buf", torch.float32, (b, 4, di), dev)
    _need(sc, "sc", torch.float32, (b, H, 4), dev)
    if s_st.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the matrix memory is stored in f32 or bf16, got {s_st.dtype}")
    _need(s_st, "s_state", s_st.dtype, (b, H, DK, DK), dev)
    h = torch.empty(b, di, dtype=torch.float32, device=dev)
    mpart = torch.empty(b, H, DK // mem_rows_per_item(DK), DK, dtype=torch.float32, device=dev)
    sb16 = s_st.dtype == torch.bfloat16
    lib = load_library()
    err = lib.mg_xm_memory(buf.data_ptr(), sc.data_ptr(), s_st.data_ptr(), mpart.data_ptr(),
                           _zeros_i32("xm_memory", b * H, dev).data_ptr(), h.data_ptr(), b, H, di, int(sb16),
                           stream_ptr(buf))
    check(lib, err, "xm_memory")
    _count("xm_memory_sb16" if sb16 else "xm_memory")
    return h


def xm_out(h_att, buf, up, outnorm, skip, dims: XDims):
    if not h_att.is_cuda:
        return xm_out_plain(h_att, buf, up, outnorm, skip, dims)
    b, dev, H, di = h_att.shape[0], h_att.device, dims.heads, dims.m_inner
    _x(h_att, di)
    _need(buf, "buf", torch.float32, (b, 4, di), dev)
    _need(up, "up", torch.float32, (b, 2 * di), dev)
    _need(outnorm, "outnorm", torch.float32, (di,), dev)
    _need(skip, "skip", torch.float32, (di,), dev)
    y = torch.empty(b, di, dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.mg_xm_out(h_att.data_ptr(), buf.data_ptr(), up.data_ptr(), outnorm.data_ptr(), skip.data_ptr(),
                        y.data_ptr(), b, H, di, GROUP_EPS, stream_ptr(h_att))
    check(lib, err, "xm_out")
    _count("xm_out")
    return y


def xs_prep(x, ln, conv_w, conv_b, conv_state, dims: XDims):
    if not x.is_cuda:
        return xs_prep_plain(x, ln, conv_w, conv_b, conv_state, dims)
    b, dev, d = x.shape[0], x.device, dims.d_model
    _x(x, d)
    _need(ln, "ln", torch.float32, (2, d), dev)
    _need(conv_w, "conv_w", torch.float32, (4, d), dev)
    _need(conv_b, "conv_b", torch.float32, (d,), dev)
    _need(conv_state, "conv_state", torch.float32, (b, 3, d), dev)
    xs = torch.empty(2, b, d, dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.mg_xs_prep(x.data_ptr(), ln.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), conv_state.data_ptr(),
                         xs.data_ptr(), b, d, LN_EPS, stream_ptr(x))
    check(lib, err, "xs_prep")
    _count("xs_prep")
    return xs


def xs_cell(wif, wzo, r_w, bias, gn, hcnm, x, dims: XDims):
    if not x.is_cuda:
        return xs_cell_plain(wif, wzo, r_w, bias, gn, hcnm, x, dims)
    b, dev, d, H, DH = x.shape[0], x.device, dims.d_model, dims.heads, dims.s_dh
    _x(x, d)
    _need(wif, "wif", torch.float32, (b, 2 * d), dev)
    _need(wzo, "wzo", torch.float32, (b, 2 * d), dev)
    _need(r_w, "r_w", torch.bfloat16, (H, DH, 4 * DH), dev)
    _need(bias, "bias", torch.float32, (4, d), dev)
    _need(gn, "gn", torch.float32, (d,), dev)
    _need(hcnm, "hcnm", torch.float32, (4, b, H, DH), dev)
    hnew = torch.empty(b, d, dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.mg_xs_cell(wif.data_ptr(), wzo.data_ptr(), r_w.data_ptr(), bias.data_ptr(), gn.data_ptr(),
                         hcnm.data_ptr(), hnew.data_ptr(), _zeros_i32("xs_cell", H, dev).data_ptr(), x.data_ptr(), b, H,
                         DH, GROUP_EPS, stream_ptr(x))
    check(lib, err, "xs_cell")
    _count("xs_cell")
    return x


@dataclasses.dataclass(frozen=True)
class XStepOps:
    """The launches of one step: the kernels, or the chain of plain versions
    on any device that the kernels are held to."""

    up_ln: Callable
    xm_prep: Callable
    xm_gates: Callable
    xm_memory: Callable
    xm_out: Callable
    down_res: Callable
    xs_prep: Callable
    gemv: Callable
    xs_cell: Callable
    ffn_up: Callable
    ffn_down: Callable
    head: Callable
    tail: Callable


KERNEL_OPS = XStepOps(up_ln, xm_prep, xm_gates, xm_memory, xm_out, down_res, xs_prep, gemv, xs_cell, ffn_up,
                      ffn_down, dk.lm_head_ln, dk.sample_tail)
PLAIN_OPS = XStepOps(up_ln_plain, xm_prep_plain, xm_gates_plain, xm_memory_plain, xm_out_plain, down_res_plain,
                     xs_prep_plain, gemv_plain, xs_cell_plain, ffn_up_plain, ffn_down_plain, dk.lm_head_ln_plain,
                     dk.sample_tail_plain)
# The plain chain with the gate products and the readout split as the
# kernels split them into items (the plain mirror of xlstm_ops.cuh's sums).
ITEM_OPS = dataclasses.replace(PLAIN_OPS, xm_gates=xm_gates_items_plain, xm_memory=xm_memory_items_plain)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def xlstm_decode_logits(wp: dict, token: torch.Tensor, carry: Carry, dims: XDims, ops: XStepOps = KERNEL_OPS,
                        quant: str = "none") -> torch.Tensor:
    """Embed `token` (B,) and run the stack one step: (B, padded_vocab)
    logits with bias. `carry` advances in place. `quant` must match the pack."""
    check_xpack(wp, quant)
    conv_m, s_m, n_m, m_m, conv_s, hcnm_s = carry

    def sc(name, i):
        return wp[name + "_s"][i] if name + "_s" in wp else None

    x = F.embedding(token, wp["embed"])
    mi = si = 0
    for i in range(dims.n_blocks):
        if i in dims.slstm_at:
            xs = ops.xs_prep(x, wp["s_ln"][si], wp["s_conv_w"][si], wp["s_conv_b"][si], conv_s[si], dims)
            wif = ops.gemv(xs[0], wp["s_w_if"][si], dims, sc("s_w_if", si), quant)
            wzo = ops.gemv(xs[1], wp["s_w_zo"][si], dims, sc("s_w_zo", si), quant)
            ops.xs_cell(wif, wzo, wp["s_r_w"][si], wp["s_bias"][si], wp["s_gn"][si], hcnm_s[si], x, dims)
            u = ops.ffn_up(x, wp["s_ln_ffn"][si], wp["s_ffn_up"][si], wp["s_ffn_up_b"][si], dims,
                           sc("s_ffn_up", si), quant)
            ops.ffn_down(u, wp["s_ffn_down"][si], wp["s_ffn_down_b"][si], x, dims, sc("s_ffn_down", si), quant)
            si += 1
        else:
            up = ops.up_ln(x, wp["m_ln"][mi], wp["m_w_up"][mi], dims, sc("m_w_up", mi), quant)
            buf = ops.xm_prep(up, wp["m_conv_w"][mi], wp["m_conv_b"][mi], conv_m[mi], wp["m_qkv_w"][mi], dims)
            g = ops.xm_gates(buf, wp["m_w_gate"][mi], wp["m_gate_b"][mi], n_m[mi], m_m[mi], dims)
            h = ops.xm_memory(buf, g, s_m[mi], dims)
            y = ops.xm_out(h, buf, up, wp["m_outnorm"][mi], wp["m_skip"][mi], dims)
            ops.down_res(y, wp["m_w_down"][mi], x, dims, sc("m_w_down", mi), quant)
            mi += 1
    return ops.head(x, wp["ln_f"][0], wp["ln_f"][1], wp["lm_w"], wp["lm_b"], dims, wp.get("lm_s"), quant)


# ---------------------------------------------------------------------------
# The one-launch step (csrc/xlstm_step.cu) and its plan
# ---------------------------------------------------------------------------

# The kernel's work kinds, in its enum order.
STEP_KINDS = ("embed", "m_up", "m_mem", "m_out", "m_down", "s_prep", "s_if", "s_zo", "s_cell", "s_gn", "s_up",
              "s_down", "head")
M_STAGES = (("m_up",), ("m_mem",), ("m_out",), ("m_down",))
S_STAGES = (("s_prep",), ("s_if", "s_zo"), ("s_cell",), ("s_gn",), ("s_up",), ("s_down",))
STEP_TEAMS = 2  # 256-thread teams of a 512-thread block
STEP_MAX_TEAM_ITEMS = 48  # items of all kinds a team may have: its plan is copied to shared memory
STEP_SMEM_PER_BLOCK = 232_448  # shared memory a block may have on an H100 (227 KB)
STEP_STATIC_SMEM = 8192  # the kernel's static shared memory (about 4 KB), rounded up
COUNTER_STRIDE = 32  # ints between two of the kernel's stage counters

def step_stages(dims: XDims) -> List[Tuple[Tuple[str, ...], int]]:
    """The kernel's stages in order, each (its kinds, its block; -1 for the
    embedding, n_blocks for the head). Each waits for the one before."""
    out = [(("embed",), -1)]
    for i in range(dims.n_blocks):
        out += [(kinds, i) for kinds in (S_STAGES if i in dims.slstm_at else M_STAGES)]
    return out + [(("head",), dims.n_blocks)]


def stage_items(dims: XDims) -> Dict[str, int]:
    """Items of each kind in one stage (csrc/xlstm_step.cu kind_items)."""
    B, H, d, DK, DH = dims.batch, dims.heads, dims.d_model, dims.m_dh, dims.s_dh
    tiles = lambda n: -(-n // 16)  # noqa: E731
    return {"embed": B, "m_up": tiles(2 * dims.m_inner), "m_mem": B * H * (DK // mem_rows_per_item(DK)),
            "m_out": B * H, "m_down": tiles(d), "s_prep": B * -(-d // XS_PREP_COLS), "s_if": tiles(2 * d),
            "s_zo": tiles(2 * d), "s_cell": H * (DH // XS_UNITS), "s_gn": B * H, "s_up": tiles(dims.ffn_pad),
            "s_down": tiles(d), "head": tiles(dims.padded_vocab)}


def step_shape_error(dims: XDims) -> Optional[str]:
    """Why the one-launch step cannot take these dims (None if it can)."""
    DK, DH = dims.m_dh, dims.s_dh
    if dims.n_blocks > 31:
        return f"the step takes at most 31 blocks, got {dims.n_blocks}"
    c4 = DK // 4
    if DK % 4 or DK > XM_MAX_DK or (TEAM % c4 if c4 <= TEAM else c4 % TEAM) or DK % mem_rows_per_item(DK):
        return (f"the matrix memory's items need DK / 4 to divide {TEAM} or be a multiple of it, DK <= {XM_MAX_DK}, "
                f"got DK = {DK}")
    if dims.m_inner % (4 * XM_CHUNK) or 2 * dims.heads * dims.batch > TEAM:
        return f"the gate chunks need di % {4 * XM_CHUNK} == 0 and 2 H B <= {TEAM}"
    if DH % XS_UNITS or DH > XS_MAX_DH:
        return f"the recurrence items need DH % {XS_UNITS} == 0 and DH <= {XS_MAX_DH}, got {DH}"
    return None


def _gemv_smem(rows: int, k: int, quant: str, qgroup: int) -> int:
    """csrc/decode_ops.cuh gemv_smem_bytes: a team's two buffers of group sums
    and its staged rows."""
    kpad = -(-k // 64) * 64
    groups = 1 if quant == "none" else k // qgroup
    stage_ld = 2 * (kpad + 32) if quant == "none" else 2 * (k + 8)
    return 2 * max(groups, 8) * 16 * rows * 4 + rows * stage_ld


def step_region_bytes(dims: XDims, quant: str) -> int:
    """Dynamic shared memory of one team (csrc/xlstm_step.cu team_region)."""
    B, d, di, ffn, DH = dims.batch, dims.d_model, dims.m_inner, dims.ffn_pad, dims.s_dh
    qg_ffn = QUANT_GROUP if ffn % QUANT_GROUP == 0 else ffn
    tile = DH * 4 * XS_UNITS * 2 if DH <= XS_TILE_DH else 0
    cell = tile + (B * DH + 9 * B * XS_UNITS + 4 * XS_UNITS) * 4  # xs_cell_smem_bytes
    r = max(_gemv_smem(B, d, quant, QUANT_GROUP), _gemv_smem(B, di, quant, QUANT_GROUP),
            _gemv_smem(B, ffn, quant, qg_ffn), cell, max(4 * TEAM, dims.m_dh) * 4)
    return -(-r // 128) * 128


@dataclasses.dataclass(frozen=True)
class XStepPlan:
    """What the wrapper hands the one-launch step besides the tensors: the
    grid (one block an SM), the dynamic shared memory a block, and for each
    team (block * STEP_TEAMS + team in the block) its items of each kind in
    STEP_KINDS order."""
    n_blocks: int
    region_bytes: int
    smem: int
    items: Tuple[Tuple[Tuple[int, ...], ...], ...]  # [team][kind] -> items

    def tensor(self, device) -> torch.Tensor:
        """The plan as the kernel reads it (int32): for each team, (start,
        count) of each kind's list, then the lists."""
        head: List[int] = []
        body: List[int] = []
        base = len(self.items) * 2 * len(STEP_KINDS)
        for lists in self.items:
            for lst in lists:
                head += [base + len(body), len(lst)]
                body += lst
        return torch.tensor(head + body, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def xlstm_plan(dims: XDims, n_sms: int, quant: str = "none") -> XStepPlan:
    """The one-launch step's schedule for a grid of n_sms blocks.

    The teams are interleaved across the blocks (team i in this order is
    team i // n_sms of block i % n_sms), and item i of a stage goes to team
    i mod their count: a stage with fewer items than blocks puts each on its
    own SM, a larger one at most ceil(items / teams) on a team. A stage of
    two kinds (the sLSTM's two input-gate products) deals them as one list."""
    err = step_shape_error(dims)
    if err:
        raise ValueError(err)
    if quant not in _FMT:
        raise ValueError(f"the xLSTM step runs bf16 or W8A16, got quant {quant!r}")
    region = step_region_bytes(dims, quant)
    smem = STEP_TEAMS * region
    if smem + STEP_STATIC_SMEM > STEP_SMEM_PER_BLOCK:
        raise ValueError(f"the step's teams need {smem} B of shared memory a block")
    order = [(i % n_sms) * STEP_TEAMS + i // n_sms for i in range(STEP_TEAMS * n_sms)]
    items = [[[] for _ in STEP_KINDS] for _ in range(STEP_TEAMS * n_sms)]
    counts = stage_items(dims)
    stages = {kinds for kinds, _ in step_stages(dims)}
    for kinds in sorted(stages, key=lambda ks: STEP_KINDS.index(ks[0])):
        i = 0
        for kind in kinds:
            for it in range(counts[kind]):
                items[order[i % len(order)]][STEP_KINDS.index(kind)].append(it)
                i += 1
    most = max(sum(len(lst) for lst in team) for team in items)
    if most > STEP_MAX_TEAM_ITEMS:
        raise ValueError(f"the step's plan gives a team {most} items, more than {STEP_MAX_TEAM_ITEMS}: "
                         f"{n_sms} blocks are too few")
    return XStepPlan(n_blocks=n_sms, region_bytes=region, smem=smem,
                     items=tuple(tuple(tuple(lst) for lst in team) for team in items))


@functools.lru_cache(maxsize=8)
def _plan_tensor(plan: XStepPlan, device) -> torch.Tensor:
    return plan.tensor(device)


# Pointer order of csrc/xlstm_step.cu StepArgs: the pack, the token, the
# carry, the activations (workspace), the plan, the counters and the stamps.
STEP_WEIGHTS = ("m_ln", "m_w_up", "m_w_up_s", "m_conv_w", "m_conv_b", "m_qkv_w", "m_w_gate", "m_gate_b", "m_outnorm",
                "m_skip", "m_w_down", "m_w_down_s", "s_ln", "s_conv_w", "s_conv_b", "s_w_if", "s_w_if_s", "s_w_zo",
                "s_w_zo_s", "s_r_w", "s_bias", "s_gn", "s_ln_ffn", "s_ffn_up", "s_ffn_up_s", "s_ffn_up_b",
                "s_ffn_down", "s_ffn_down_s", "s_ffn_down_b", "ln_f", "lm_w", "lm_s", "lm_b", "embed")
_N_STEP_PTRS, _N_STEP_INTS = 57, 9


def _step_shapes(dims: XDims, quant: str) -> Dict[str, tuple]:
    """Shape of each pack entry the step reads (the int8 scales only under
    W8A16)."""
    M, S, B = dims.n_mlstm, dims.n_slstm, dims.batch
    d, di, H, DH, ffn, vp = dims.d_model, dims.m_inner, dims.heads, dims.s_dh, dims.ffn_pad, dims.padded_vocab
    g, gf = d // QUANT_GROUP, (ffn // QUANT_GROUP if ffn % QUANT_GROUP == 0 else 1)
    shapes = {"m_ln": (M, 2, d), "m_w_up": (M, 2 * di, d), "m_conv_w": (M, 4, di), "m_conv_b": (M, di),
              "m_qkv_w": (M, 3, di // 4, 4, 4), "m_w_gate": (M, 2 * H, 3 * di), "m_gate_b": (M, 2 * H),
              "m_outnorm": (M, di), "m_skip": (M, di), "m_w_down": (M, d, di), "s_ln": (S, 2, d),
              "s_conv_w": (S, 4, d), "s_conv_b": (S, d), "s_w_if": (S, 2 * d, d), "s_w_zo": (S, 2 * d, d),
              "s_r_w": (S, H, DH, 4 * DH), "s_bias": (S, 4, d), "s_gn": (S, d), "s_ln_ffn": (S, 2, d),
              "s_ffn_up": (S, ffn, d), "s_ffn_up_b": (S, ffn), "s_ffn_down": (S, d, ffn), "s_ffn_down_b": (S, d),
              "ln_f": (2, d), "lm_w": (vp, d), "lm_b": (vp,), "embed": (dims.vocab_size, d)}
    if quant != "none":
        shapes.update({"m_w_up_s": (M, g, 2 * di), "m_w_down_s": (M, di // QUANT_GROUP, d), "s_w_if_s": (S, g, 2 * d),
                       "s_w_zo_s": (S, g, 2 * d), "s_ffn_up_s": (S, g, ffn), "s_ffn_down_s": (S, gf, d),
                       "lm_s": (g, vp)})
    return shapes


def step_name(quant: str, sb16: bool) -> str:
    """The launch counter's name of the one-launch step in a format."""
    return "xlstm_step" + ("_w8a16" if quant != "none" else "") + ("_sb16" if sb16 else "")


def xlstm_step(wp: dict, token: torch.Tensor, carry: Carry, dims: XDims, quant: str = "none",
               stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step in one launch (csrc/xlstm_step.cu): the embedding of
    `token` (B,), the stack and LN_f + lm_head. Returns (B, padded_vocab)
    logits with bias; `carry` advances in place. The plain chain on CPU
    tensors; on CUDA tensors the kernel, or an error. `stamps`, an int64
    (len(step_stages(dims)), 2 x SMs, 2) tensor, receives each team's
    %globaltimer (ns) when it passes a stage's wait and when it signals the
    stage (0 where it has no item): stage_times reads them."""
    if not token.is_cuda:
        return xlstm_decode_logits(wp, token, carry, dims, PLAIN_OPS, quant)
    check_xpack(wp, quant)
    dev, B, f32 = token.device, dims.batch, torch.float32
    if token.shape != (B,):
        raise ValueError(f"token: need ({B},), got {tuple(token.shape)}")
    token = token.to(torch.int64).contiguous()
    wdt = torch.bfloat16 if quant == "none" else torch.int8
    for key, shape in _step_shapes(dims, quant).items():
        dt = torch.bfloat16 if key == "s_r_w" else wdt if key in BIG else f32
        _need(wp[key], key, dt, shape, dev)
    conv_m, s_m, n_m, m_m, conv_s, hcnm_s = carry
    M, S, H, DK, d, di = dims.n_mlstm, dims.n_slstm, dims.heads, dims.m_dh, dims.d_model, dims.m_inner
    if s_m.dtype not in (f32, torch.bfloat16):
        raise ValueError(f"the matrix memory is stored in f32 or bf16, got {s_m.dtype}")
    for t, name, dt, shape in ((conv_m, "conv_m", f32, (M, B, 3, di)), (s_m, "s_m", s_m.dtype, (M, B, H, DK, DK)),
                               (n_m, "n_m", f32, (M, B, H, DK)), (m_m, "m_m", f32, (M, B, H)),
                               (conv_s, "conv_s", f32, (S, B, 3, d)), (hcnm_s, "hcnm_s", f32, (S, 4, B, H, dims.s_dh))):
        _need(t, name, dt, shape, dev)
    sb16 = s_m.dtype == torch.bfloat16
    nrc = DK // mem_rows_per_item(DK)
    acts = [("x", (B, d)), ("up", (B, 2 * di)), ("buf", (B, 4, di)), ("gpart", (B, 2 * H, di // XM_CHUNK)),
            ("mpart", (B, H, nrc, DK)), ("h_att", (B, di)), ("y", (B, di)), ("xs", (2, B, d)), ("wif", (B, 2 * d)),
            ("wzo", (B, 2 * d)), ("hnew", (B, d)), ("u", (B, dims.ffn_pad)), ("logits", (B, dims.padded_vocab))]
    sizes = [math.prod(shape) for _, shape in acts]
    ws = torch.empty(sum(-(-n // 32) * 32 for n in sizes), dtype=f32, device=dev)  # 128-byte aligned views
    views, off = {}, 0
    for (name, shape), n in zip(acts, sizes):
        views[name] = ws[off:off + n].view(shape)
        off += -(-n // 32) * 32
    plan = xlstm_plan(dims, torch.cuda.get_device_properties(dev).multi_processor_count, quant)
    n_stages = len(step_stages(dims))
    counters = _zeros_i32("xlstm_step", (n_stages + 1) * COUNTER_STRIDE, dev)
    if stamps is not None:
        _need(stamps, "stamps", torch.int64, (n_stages, STEP_TEAMS * plan.n_blocks, 2), dev)
    tensors = [wp.get(k) for k in STEP_WEIGHTS] + [token, *carry] + [views[n] for n, _ in acts] \
        + [_plan_tensor(plan, dev), counters, stamps]
    ptrs = [0 if t is None else t.data_ptr() for t in tensors]
    ints = [dims.n_blocks, sum(1 << i for i in dims.slstm_at), B, d, H, di, dims.ffn_pad, dims.padded_vocab,
            plan.n_blocks]
    assert len(ptrs) == _N_STEP_PTRS and len(ints) == _N_STEP_INTS
    name = step_name(quant, sb16)
    lib = load_library()
    info = (ctypes.c_int * 4)()
    err = lib.mg_xlstm_step((ctypes.c_void_p * _N_STEP_PTRS)(*ptrs), _N_STEP_PTRS,
                            (ctypes.c_int * _N_STEP_INTS)(*ints), _N_STEP_INTS, _FMT[quant], int(sb16), info,
                            stream_ptr(token))
    check(lib, err, name)
    dk.LAUNCHES[name] += 1
    xlstm_step.launch = dict(zip(("grid", "threads", "dynamic_smem", "static_smem"), info))
    return views["logits"]


# The last launch of the step: blocks, threads a block, dynamic and static
# shared memory a block (bytes).
xlstm_step.launch = {}


def stage_times(stamps: torch.Tensor, dims: XDims) -> List[Tuple[str, float, float]]:
    """From xlstm_step's stamps: for each stage in order, (its kinds, the
    µs from the previous stage's last signal to the first team passing
    this stage's wait, the µs from there to this stage's last signal). The
    first stage counts from the first team passing its wait."""
    st = stamps.double()
    out, prev_end = [], None
    for s, (kinds, _) in enumerate(step_stages(dims)):
        passed, signalled = st[s, :, 0], st[s, :, 1]
        first = float(passed[passed > 0].min())
        end = float(signalled[signalled > 0].max())
        out.append(("+".join(kinds), 1e-3 * (first - (first if prev_end is None else prev_end)), 1e-3 * (end - first)))
        prev_end = end
    return out


def _logits(wp, token, carry, dims, quant, ops):
    if ops is None:
        return xlstm_step(wp, token, carry, dims, quant)
    return xlstm_decode_logits(wp, token, carry, dims, ops, quant)


def fused_xlstm_logits_step(wp: dict, token: torch.Tensor, carry: Carry, dims: XDims, quant: str = "none",
                            ops: Optional[XStepOps] = None):
    """One decode step: (logits (B, vocab), carry). Matches XLSTMLM.step at
    bf16 tolerance (W8A16: at its quantisation noise). ops=None runs the
    one-launch step (the plain chain on CPU tensors); KERNEL_OPS the chain
    of launches, PLAIN_OPS the plain chain."""
    logits = _logits(wp, token, carry, dims, quant, ops)
    return logits[:, :dims.vocab_size], carry


def fused_xlstm_sample_step(wp: dict, token: torch.Tensor, carry: Carry, hist: torch.Tensor, bucket: torch.Tensor,
                            dims: XDims, quant: str = "none", ops: Optional[XStepOps] = None):
    """One decode step with the sampler tail: (vals (B, 3), idxs (B, 3),
    carry); ties to the lowest index. ops as fused_xlstm_logits_step; the
    tail is kernel B's sample_tail unless ops names another."""
    logits = _logits(wp, token, carry, dims, quant, ops)
    vals, idxs = (dk.sample_tail if ops is None else ops.tail)(logits, wp["gram"], hist, bucket, dims)
    return vals, idxs, carry
