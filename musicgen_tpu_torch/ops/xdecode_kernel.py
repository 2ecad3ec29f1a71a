"""Kernel G: the one-token decode step of the whole xLSTM stack, with the
sampler tail, as hand-written CUDA kernels (csrc/xlstm_decode.cu, and kernel
B's head and tail launches).

Replaces musicgen_tpu/ops/pallas_xlstm_decode.py (`_xlstm_kernel` via
`fused_xlstm_logits_step` and `fused_xlstm_sample_step`) in its formats: bf16
or W8A16 (`_w8dot`) weights, the mLSTM matrix memory stored in f32 or bf16
(`-sb16`: `stack_xlstm_states(state_dtype=torch.bfloat16)`; the math stays
f32). The TPU kernel ran the step as ONE pallas_call whose grid walked the
blocks; here a step is a sequence of launches on one stream:

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

68 launches a token at the reference size (7 mLSTM and 4 sLSTM blocks; 67
without the tail). The plain versions below follow the TPU kernel's math
line for line (`_mlstm_block_math`, `_slstm_block_math`, `_head_math`):
activations f32, rounded to bf16 before each big product with f32 sums, the
mLSTM gate products in f32, h rounded to bf16 against the bf16 recurrent
weights, LayerNorm variance as E[x^2] - mean^2, S rounded to its storage
dtype at the store only. What is TPU layout and not carried over: the rank-2
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
product and "_sb16" for the bf16-stored matrix memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from ..config import VOCAB, XLSTMConfig
from . import decode_kernel as dk
from .build import check, load_library, stream_ptr
from .decode_kernel import LN_EPS, MAX_ROWS, QUANT_GROUP, _bf16, _count, _need, _product, quantize_cols
from .grammar import grammar_mask

GROUP_EPS = 1e-5  # the mLSTM head norm and the sLSTM group norm
LANE = 128  # the FFN width is padded to a multiple of this, as in the TPU pack
# The pack a --fused-decode quant builds -> how its products run.
QUANT_MODES = {"bf16": "none", "int8w": "w8a16"}
_FMT = {"none": 0, "w8a16": 1}
_PRO = {"plain": 0, "ln": 2}  # csrc/decode_ops.cuh GEMV prologues
_EPI = {"store": 0, "bias_residual": 5, "residual": 6, "bias_gelu": 7}  # and epilogues

Carry = Tuple[torch.Tensor, ...]  # (conv_m, s_m, n_m, m_m, conv_s, hcnm_s)


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

    def launches_per_token(self, tail: bool = True) -> int:
        return 6 * self.n_mlstm + 6 * self.n_slstm + 1 + int(tail)


# ---------------------------------------------------------------------------
# Pack and states
# ---------------------------------------------------------------------------

# The matrices a token streams, and their int8 scales' keys.
BIG = ("m_w_up", "m_w_down", "s_w_if", "s_w_zo", "s_ffn_up", "s_ffn_down", "lm_w")


@torch.no_grad()
def build_xlstm_decode_params(model, batch: int, quant: str = "bf16") -> dict:
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
    FFN down-projection, K = ffn_pad not a multiple of 256, has one group)."""
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
    for name in BIG:
        w = wp[name]
        if quant == "bf16":
            wp[name] = w.to(bf16)
        elif name == "lm_w":
            wp[name], wp["lm_s"] = quantize_cols(w)
        else:
            qs = [quantize_cols(m) for m in w]
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


def xm_gates_plain(buf, w_gate, gate_b, n_st, m_st, dims: XDims):
    """i, f = W_gate [q | k | v] + b in f32; m = max(logsigmoid(f) + m, i),
    f' and i'; n = f' n + i' k / sqrt(DK) and m advance in place. Returns
    sc (B, H, 4) = (f', i', max(|q.n|, exp(-m)), 0)."""
    b, H, DK, di = buf.shape[0], dims.heads, dims.m_dh, dims.m_inner
    gates = buf[:, :3].reshape(b, 3 * di) @ w_gate.t() + gate_b
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
    if quant == "none":
        _need(w, "w", torch.bfloat16, (n, k), dev)
        s_ptr = 0
    else:
        if qgroup == QUANT_GROUP and k % (2 * QUANT_GROUP):
            raise ValueError(f"W8A16 GEMV needs K % {2 * QUANT_GROUP} == 0 or one group, got K = {k}")
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
    sb16 = s_st.dtype == torch.bfloat16
    lib = load_library()
    err = lib.mg_xm_memory(buf.data_ptr(), sc.data_ptr(), s_st.data_ptr(), h.data_ptr(), b, H, di, int(sb16),
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
    lib = load_library()
    err = lib.mg_xs_cell(wif.data_ptr(), wzo.data_ptr(), r_w.data_ptr(), bias.data_ptr(), gn.data_ptr(),
                         hcnm.data_ptr(), x.data_ptr(), b, H, DH, GROUP_EPS, stream_ptr(x))
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


def fused_xlstm_logits_step(wp: dict, token: torch.Tensor, carry: Carry, dims: XDims, quant: str = "none",
                            ops: XStepOps = KERNEL_OPS):
    """One decode step: (logits (B, vocab), carry). Matches XLSTMLM.step at
    bf16 tolerance (W8A16: at its quantisation noise)."""
    logits = xlstm_decode_logits(wp, token, carry, dims, ops, quant)
    return logits[:, :dims.vocab_size], carry


def fused_xlstm_sample_step(wp: dict, token: torch.Tensor, carry: Carry, hist: torch.Tensor, bucket: torch.Tensor,
                            dims: XDims, quant: str = "none", ops: XStepOps = KERNEL_OPS):
    """One decode step with the sampler tail: (vals (B, 3), idxs (B, 3),
    carry); ties to the lowest index."""
    logits = xlstm_decode_logits(wp, token, carry, dims, ops, quant)
    vals, idxs = ops.tail(logits, wp["gram"], hist, bucket, dims)
    return vals, idxs, carry
