"""Kernels B and B': the one-token decode step of the whole Mamba stack, with
the sampler tail, as hand-written CUDA kernels (csrc/decode_*.cu).

Replaces musicgen_tpu/ops/pallas_decode.py (`_decode_kernel` via
`fused_decode_step`, `fused_logits_step` and `fused_sample_step`) in its
three weight formats: bf16, W8A8 (`_qdot`) and W8A16 (`_w8dot`). The TPU
kernel ran the step as ONE pallas_call whose grid walked the layers. Here a
step is a sequence of launches on one stream:

  for each of the L layers:
    in_proj_conv   GEMV + conv step + silu + softplus       (decode_gemv.cu)
    mixer_state    SSM state update + readout + gate        (decode_mixer.cu)
    out_proj_rms   gated RMSNorm + GEMV                     (decode_gemv.cu)
  lm_head_ln       LayerNorm + GEMV + bias                  (decode_gemv.cu)
  sample_tail      grammar, penalty, exact top-3            (decode_tail.cu)

The whole-generation kernel (ops/generate_kernel.py) runs the same device
code for every token of a generation in one launch.

`quant` names how a product runs, as in the TPU kernel: "none" (bf16 pack),
"w8a8" or "w8a16" (int8 pack with K-grouped scales; see QUANT_MODES).

The conv state (L, B, 3, conv_dim) and the SSM state (L, d_inner, B*N), laid
out S[h*P+p, b*N+n] as in the TPU kernel, are updated IN PLACE by both the
kernels and their plain versions. Weights are bf16; activations are f32 and
rounded to bf16 right before each product, with f32 accumulation, at the
same points as the TPU kernel (`_mixer_math`, `_head_math`), so the plain
versions below agree with the JAX bodies.

Every wrapper takes the plain version for CPU tensors; for CUDA tensors it
launches its kernel or raises. Each launch adds one to LAUNCHES[name], where
the name carries the format of an int8 launch (e.g. "in_proj_conv_w8a16").
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from ..config import VOCAB, MambaConfig
from .build import check, load_library, stream_ptr
from .grammar import grammar_mask

MAX_ROWS = 8  # batch rows one GEMV launch carries (csrc/decode_gemv.cu MAXR)
KERNEL_DIM = 64  # headdim and d_state the mixer kernel is written for
RMS_EPS = 1e-5
LN_EPS = 1e-6  # flax LayerNorm's default, kept by the reference port
_LN_101 = 0.00995033085316808  # ln 1.01: pitch penalty base
_LN_102 = 0.019802627296179712  # ln 1.02: dynamic penalty base
QUANT_GROUP = 256  # int8 K-group: rows of W^T under one scale
# The pack a --fused-decode quant builds -> how its products run.
QUANT_MODES = {"bf16": "none", "int8": "w8a8", "int8w": "w8a16"}
_FMT = {"none": 0, "w8a16": 1, "w8a8": 2}  # csrc/decode_ops.cuh weight formats

LAUNCHES: collections.Counter = collections.Counter()

Carry = Tuple[torch.Tensor, torch.Tensor]  # (conv (L,B,3,dc), ssm (L,di,B*N))


@dataclasses.dataclass(frozen=True)
class DecodeDims:
    n_layers: int
    batch: int
    d_model: int  # 1024
    d_inner: int  # 2048 = nheads * headdim
    nheads: int  # 32
    headdim: int  # 64
    d_state: int  # 64
    conv_dim: int  # d_inner + 2 * d_state = 2176
    d_in_proj: int  # 2 * d_inner + 2 * d_state + nheads = 4256 (no lane padding)
    padded_vocab: int  # 17920: lm_head rows / logits width
    vocab_size: int  # 17914: the tail's softmax excludes the pad ids
    dyn_start: int  # field boundaries for the penalty bases
    length_start: int

    @classmethod
    def create(cls, cfg: MambaConfig, batch: int) -> "DecodeDims":
        if cfg.ngroups != 1:
            raise ValueError("the decode kernels assume ngroups = 1")
        # x is OVERWRITTEN per layer (reference no-residual quirk).
        if cfg.residual:
            raise ValueError("the decode kernels implement residual=False only")
        if not 1 <= batch <= MAX_ROWS:
            raise ValueError(f"decode batch must be in 1..{MAX_ROWS}, got {batch}")
        return cls(
            n_layers=cfg.n_layers,
            batch=batch,
            d_model=cfg.d_model,
            d_inner=cfg.d_inner,
            nheads=cfg.nheads,
            headdim=cfg.headdim,
            d_state=cfg.d_state,
            conv_dim=cfg.conv_dim,
            d_in_proj=2 * cfg.d_inner + 2 * cfg.d_state + cfg.nheads,
            padded_vocab=cfg.padded_vocab,
            vocab_size=cfg.vocab_size,
            dyn_start=VOCAB.dyn_start,
            length_start=VOCAB.length_start,
        )


# ---------------------------------------------------------------------------
# Pack and states
# ---------------------------------------------------------------------------


def quantize_cols(w: torch.Tensor, group: int = QUANT_GROUP) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-grouped per-output-column symmetric int8 (pallas_decode._quantize_cols).

    w (N, K) in torch's (out, in) layout. Returns (q (N, K) int8,
    s (G, N) f32) with G = K / group: each scale covers `group` consecutive
    k of one column, s = max|w| / 127 (floor 1e-20), q = clip(round(w / s),
    -127, 127), rounded half to even. K not a multiple of `group` takes one
    group."""
    n, k = w.shape
    if k % group:
        group = k
    wg = w.to(torch.float32).reshape(n, k // group, group)
    s = torch.clamp(wg.abs().amax(dim=2) / 127.0, min=1e-20)  # (N, G)
    q = torch.clamp(torch.round(wg / s[:, :, None]), -127.0, 127.0)
    return q.to(torch.int8).reshape(n, k).contiguous(), s.t().contiguous()


@torch.no_grad()
def build_decode_params(model, batch: int, quant: str = "bf16") -> dict:
    """Pack a MambaLM's weights for the decode kernels.

    Matrices stay in torch's (out, in) layout, which is K-contiguous: a warp
    streams one output column. lm_head is padded from vocab to padded_vocab
    rows (zero weights, zero bias; the tail never selects pad ids). Per-head
    vectors stay per head. Built once per generation, on the model's device.

    quant="bf16" stores bf16 matrices; "int8" and "int8w" store in_proj,
    out_proj and lm_head as int8 with (K / 256, N) group scales `w_in_s`,
    `w_out_s` and `lm_s` (quantize_cols). The int8 pack is the same for
    both; W8A8 and W8A16 differ only in how the products run."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {sorted(QUANT_MODES)}, got {quant!r}")
    cfg = model.cfg
    dims = DecodeDims.create(cfg, batch)
    L, v, vp = cfg.n_layers, cfg.vocab_size, dims.padded_vocab
    layers = model.layers
    f32, bf16 = torch.float32, torch.bfloat16

    def stack(fn, dtype=f32):
        return torch.stack([fn(layers[i]) for i in range(L)]).to(dtype).contiguous()

    dev = model.token_embedding.weight.device
    lm_w = torch.zeros(vp, cfg.d_model, dtype=f32, device=dev)
    lm_w[:v] = model.output_layer.weight
    lm_b = torch.zeros(vp, dtype=f32, device=dev)
    lm_b[:v] = model.output_layer.bias
    gram = torch.zeros(5, vp, dtype=f32, device=dev)
    gram[:, :v] = grammar_mask(device=dev)
    dp = {
        "w_in": stack(lambda m: m.in_proj.weight, bf16),  # (L, d_in_proj, d_model)
        "w_out": stack(lambda m: m.out_proj.weight, bf16),  # (L, d_model, d_inner)
        "conv_w": stack(lambda m: m.conv_w),  # (L, 4, conv_dim)
        "conv_b": stack(lambda m: m.conv1d.bias),  # (L, conv_dim)
        "dt_bias": stack(lambda m: m.dt_bias),  # (L, nheads)
        "a_h": stack(lambda m: -torch.exp(m.A_log)),  # (L, nheads)
        "d_h": stack(lambda m: m.D),  # (L, nheads)
        "norm_w": stack(lambda m: m.norm.weight),  # (L, d_inner)
        "ln_w": model.norm.weight.detach().to(f32).contiguous(),
        "ln_b": model.norm.bias.detach().to(f32).contiguous(),
        "lm_w": lm_w.to(bf16),  # (padded_vocab, d_model)
        "lm_b": lm_b,  # (padded_vocab,)
        "embed": model.token_embedding.weight.detach().to(f32).contiguous(),  # (vocab, d_model)
        "gram": gram,  # (5, padded_vocab) grammar rows by previous-token field
    }
    if quant != "bf16":
        def pack(mats):
            qs = [quantize_cols(w.detach()) for w in mats]
            return torch.stack([q for q, _ in qs]), torch.stack([sc for _, sc in qs])

        dp["w_in"], dp["w_in_s"] = pack([m.in_proj.weight for m in layers])  # (L, G, d_in_proj)
        dp["w_out"], dp["w_out_s"] = pack([m.out_proj.weight for m in layers])  # (L, G, d_model)
        dp["lm_w"], dp["lm_s"] = quantize_cols(lm_w)  # (G, padded_vocab)
    return dp


def check_pack(dp: dict, quant: str) -> None:
    """Raise unless the pack's weight format is the one `quant` runs."""
    if quant not in _FMT:
        raise ValueError(f"quant must be one of {sorted(_FMT)}, got {quant!r}")
    if ("w_in_s" in dp) != (quant != "none"):
        raise ValueError(f"quant {quant!r} does not match a {'int8' if 'w_in_s' in dp else 'bf16'} pack")


def stack_states(states) -> Carry:
    """Per-layer prefill states -> (conv (L,B,3,conv_dim), ssm (L,d_inner,B*N)),
    the SSM state as S[h*P+p, b*N+n]."""
    conv = torch.stack([s["conv"].to(torch.float32) for s in states]).contiguous()

    def to2d(ssm):
        b, h, p, n = ssm.shape
        return ssm.to(torch.float32).permute(1, 2, 0, 3).reshape(h * p, b * n)

    ssm = torch.stack([to2d(s["ssm"]) for s in states]).contiguous()
    return conv, ssm


def unstack_states(conv: torch.Tensor, ssm: torch.Tensor, dims: DecodeDims):
    """Inverse of stack_states (back to MambaLM.step's per-layer states)."""
    out = []
    for i in range(conv.shape[0]):
        s = ssm[i].reshape(dims.nheads, dims.headdim, dims.batch, dims.d_state)
        out.append({"conv": conv[i], "ssm": s.permute(2, 0, 1, 3)})
    return tuple(out)


# ---------------------------------------------------------------------------
# Plain versions (the TPU kernel's `_mixer_math`, `_head_math`, `_tail_math`)
# ---------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def qdot(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """W8A8 product (pallas_decode._qdot): x (M, K) f32, wq (N, K) int8,
    s (G, N) group scales -> (M, N) f32. Each (row, K-group) of x is
    quantised with its own scale s_x = max(max|x|, 1e-20) / 127, rounded half
    to even and clipped to +-127; the group's integer sum is exact, then
    acc += part * s_x * s[g] group by group."""
    g_n, k = s.shape[0], wq.shape[1]
    gsz = k // g_n
    acc = torch.zeros(x.shape[0], wq.shape[0], dtype=torch.float32, device=x.device)
    for g in range(g_n):
        xg = x[:, g * gsz:(g + 1) * gsz]
        s_x = torch.clamp(xg.abs().amax(dim=1, keepdim=True), min=1e-20) * (1.0 / 127.0)
        xq = torch.clamp(torch.round(xg / s_x), -127.0, 127.0)
        # Integer products summed in f64 are exact (|sum| < 2^53).
        part = xq.double() @ wq[:, g * gsz:(g + 1) * gsz].double().t()
        acc = acc + part.to(torch.float32) * s_x * s[g]
    return acc


def w8dot(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """W8A16 product (pallas_decode._w8dot): int8 weights promoted to bf16
    (exactly), activations rounded to bf16, f32 sums per K-group, each
    multiplied by its (G, N) scale and added group by group."""
    g_n, k = s.shape[0], wq.shape[1]
    gsz = k // g_n
    acc = torch.zeros(x.shape[0], wq.shape[0], dtype=torch.float32, device=x.device)
    for g in range(g_n):
        part = F.linear(_bf16(x[:, g * gsz:(g + 1) * gsz]), wq[:, g * gsz:(g + 1) * gsz].to(torch.float32))
        acc = acc + part * s[g]
    return acc


def _product(h: torch.Tensor, w: torch.Tensor, w_s, quant: str) -> torch.Tensor:
    """h @ W^T in the pack's format, at the points the TPU kernel rounds."""
    if quant == "w8a8":
        return qdot(h, w, w_s)
    if quant == "w8a16":
        return w8dot(h, w, w_s)
    return F.linear(_bf16(h), w.to(torch.float32))


def in_proj_conv_plain(x, w_in, conv_w, conv_b, dt_bias, conv_state, dims: DecodeDims,
                       w_s=None, quant: str = "none"):
    """zx = [z | silu(conv step) | softplus(dt + dt_bias)] from in_proj(x);
    conv_state (B, 3, conv_dim) advances in place."""
    di, dc, nh = dims.d_inner, dims.conv_dim, dims.nheads
    zx = _product(x, w_in, w_s, quant)
    xbc_new = zx[:, di:di + dc]
    cs = conv_state
    y = cs[:, 0] * conv_w[0] + cs[:, 1] * conv_w[1] + cs[:, 2] * conv_w[2] + xbc_new * conv_w[3] + conv_b
    conv_state.copy_(torch.stack([cs[:, 1], cs[:, 2], xbc_new], dim=1))
    dt = F.softplus(zx[:, di + dc:di + dc + nh] + dt_bias)
    return torch.cat([zx[:, :di], y * torch.sigmoid(y), dt, zx[:, di + dc + nh:]], dim=1)


def mixer_state_plain(zx, a_h, d_h, ssm_state, dims: DecodeDims):
    """g = (C.h + D x) * silu(z) after h = exp(dt A) h + dt x B^T;
    ssm_state (d_inner, B*N) advances in place."""
    b = zx.shape[0]
    di, nh, p, n = dims.d_inner, dims.nheads, dims.headdim, dims.d_state
    dc = dims.conv_dim
    z, x = zx[:, :di], zx[:, di:2 * di]
    bv, cv = zx[:, 2 * di:2 * di + n], zx[:, 2 * di + n:2 * di + 2 * n]
    dt = zx[:, di + dc:di + dc + nh]  # (B, H)
    s = ssm_state.view(nh, p, b, n)
    decay = torch.exp(dt * a_h).t()[:, None, :, None]  # (H, 1, B, 1)
    dtx = (x.reshape(b, nh, p) * dt[:, :, None]).permute(1, 2, 0)[..., None]  # (H, P, B, 1)
    s_new = s * decay + dtx * bv[None, None]
    y = (s_new * cv[None, None]).sum(-1).permute(2, 0, 1).reshape(b, di)
    y = y + x * d_h.repeat_interleave(p)
    ssm_state.copy_(s_new.reshape(di, b * n))
    return (y * (z * torch.sigmoid(z))).contiguous()


def out_proj_rms_plain(g, norm_w, w_out, dims: DecodeDims, w_s=None, quant: str = "none"):
    """out_proj(g * rsqrt(mean(g^2) + 1e-5) * norm_w)."""
    var = torch.mean(g * g, dim=-1, keepdim=True)
    return _product(g * torch.rsqrt(var + RMS_EPS) * norm_w, w_out, w_s, quant)


def lm_head_ln_plain(x, ln_w, ln_b, lm_w, lm_b, dims: DecodeDims, w_s=None, quant: str = "none"):
    """lm_head(LayerNorm(x)) + bias, var = E[x^2] - mean^2 as in `_head_math`."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(x * x, dim=-1, keepdim=True) - mean * mean
    h = (x - mean) * torch.rsqrt(var + LN_EPS)
    h = h * ln_w + ln_b
    return _product(h, lm_w, w_s, quant) + lm_b


def sample_tail_plain(logits, gram, hist, bucket, dims: DecodeDims):
    """Grammar-filtered, penalty-divided weights and their exact top-3
    (ties to the lowest index). logits (B, Vp) with bias; gram (5, Vp);
    hist (B, V) int32 window counts; bucket (B,) field of the previous token.
    Returns (vals (B, 3) f32, idxs (B, 3) int64)."""
    vp, v = logits.shape[1], dims.vocab_size
    ids = torch.arange(vp, device=logits.device)
    real = ids < v
    xm = torch.where(real, logits, -1e30)
    m = xm.max(dim=-1, keepdim=True).values
    lse = torch.log(torch.exp(xm - m).sum(dim=-1, keepdim=True)) + m
    mask = gram[bucket]
    w = torch.where(real & (mask > 0.0), (lse - xm) * mask, 0.0)
    log_base = torch.where(
        ids < dims.dyn_start, _LN_101, torch.where(ids < dims.length_start, _LN_102, 0.0)
    ).to(torch.float32)
    counts = F.pad(hist.to(torch.float32), (0, vp - v))
    w = w / torch.clamp(torch.exp(counts * log_base), max=1.2)
    vals, idxs = [], []
    for _ in range(3):
        mk = w.max(dim=-1, keepdim=True).values
        ik = torch.where(w == mk, ids, vp).min(dim=-1, keepdim=True).values
        vals.append(mk)
        idxs.append(ik)
        w = torch.where(ids == ik, -1e30, w)
    return torch.cat(vals, dim=1), torch.cat(idxs, dim=1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _need(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {dtype} {tuple(shape)} tensor on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
        )


def _rows(b: int) -> None:
    if not 1 <= b <= MAX_ROWS:
        raise ValueError(f"decode kernels take 1..{MAX_ROWS} rows, got {b}")


def _kernel_dims(dims: DecodeDims, b: int) -> None:
    if dims.headdim != KERNEL_DIM or dims.d_state != KERNEL_DIM:
        raise ValueError(f"decode kernels need headdim = d_state = {KERNEL_DIM}")
    _rows(b)


def _weights(w, w_s, quant: str, n: int, k: int, dev) -> int:
    """Check a GEMV's packed weights; returns the scales' pointer (0 for
    bf16)."""
    if quant not in _FMT:
        raise ValueError(f"quant must be one of {sorted(_FMT)}, got {quant!r}")
    if quant == "none":
        _need(w, "w", torch.bfloat16, (n, k), dev)
        return 0
    if k % (2 * QUANT_GROUP):
        raise ValueError(f"int8 GEMV kernels need K % {2 * QUANT_GROUP} == 0, got K = {k}")
    _need(w, "w", torch.int8, (n, k), dev)
    _need(w_s, "w_s", torch.float32, (k // QUANT_GROUP, n), dev)
    return w_s.data_ptr()


def _count(base: str, quant: str = "none") -> None:
    LAUNCHES[base if quant == "none" else f"{base}_{quant}"] += 1


def in_proj_conv(x, w_in, conv_w, conv_b, dt_bias, conv_state, dims: DecodeDims,
                 w_s=None, quant: str = "none"):
    if not x.is_cuda:
        return in_proj_conv_plain(x, w_in, conv_w, conv_b, dt_bias, conv_state, dims, w_s, quant)
    b, dev = x.shape[0], x.device
    _kernel_dims(dims, b)
    x = x.to(torch.float32).contiguous()
    _need(x, "x", torch.float32, (b, dims.d_model), dev)
    s_ptr = _weights(w_in, w_s, quant, dims.d_in_proj, dims.d_model, dev)
    _need(conv_w, "conv_w", torch.float32, (4, dims.conv_dim), dev)
    _need(conv_b, "conv_b", torch.float32, (dims.conv_dim,), dev)
    _need(dt_bias, "dt_bias", torch.float32, (dims.nheads,), dev)
    _need(conv_state, "conv_state", torch.float32, (b, 3, dims.conv_dim), dev)
    zx = torch.empty(b, dims.d_in_proj, dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.mg_in_proj_conv(
        x.data_ptr(), w_in.data_ptr(), s_ptr, zx.data_ptr(), b, dims.d_model, dims.d_in_proj,
        dims.d_inner, dims.conv_dim, dims.nheads, conv_w.data_ptr(), conv_b.data_ptr(),
        dt_bias.data_ptr(), conv_state.data_ptr(), _FMT[quant], stream_ptr(x),
    )
    check(lib, err, "in_proj_conv")
    _count("in_proj_conv", quant)
    return zx


def mixer_state(zx, a_h, d_h, ssm_state, dims: DecodeDims):
    if not zx.is_cuda:
        return mixer_state_plain(zx, a_h, d_h, ssm_state, dims)
    b, dev = zx.shape[0], zx.device
    _kernel_dims(dims, b)
    zx = zx.contiguous()
    _need(zx, "zx", torch.float32, (b, dims.d_in_proj), dev)
    _need(a_h, "a_h", torch.float32, (dims.nheads,), dev)
    _need(d_h, "d_h", torch.float32, (dims.nheads,), dev)
    _need(ssm_state, "ssm_state", torch.float32, (dims.d_inner, b * dims.d_state), dev)
    g = torch.empty(b, dims.d_inner, dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.mg_mixer_state(
        zx.data_ptr(), dims.d_in_proj, dims.d_inner, dims.nheads, dims.headdim, dims.d_state,
        a_h.data_ptr(), d_h.data_ptr(), ssm_state.data_ptr(), g.data_ptr(), b, stream_ptr(zx),
    )
    check(lib, err, "mixer_state")
    _count("mixer_state")
    return g


def out_proj_rms(g, norm_w, w_out, dims: DecodeDims, w_s=None, quant: str = "none"):
    if not g.is_cuda:
        return out_proj_rms_plain(g, norm_w, w_out, dims, w_s, quant)
    b, dev = g.shape[0], g.device
    _kernel_dims(dims, b)
    g = g.contiguous()
    _need(g, "g", torch.float32, (b, dims.d_inner), dev)
    _need(norm_w, "norm_w", torch.float32, (dims.d_inner,), dev)
    s_ptr = _weights(w_out, w_s, quant, dims.d_model, dims.d_inner, dev)
    out = torch.empty(b, dims.d_model, dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.mg_out_proj_rms(
        g.data_ptr(), norm_w.data_ptr(), w_out.data_ptr(), s_ptr, out.data_ptr(), b, dims.d_inner,
        dims.d_model, RMS_EPS, _FMT[quant], stream_ptr(g),
    )
    check(lib, err, "out_proj_rms")
    _count("out_proj_rms", quant)
    return out


def lm_head_ln(x, ln_w, ln_b, lm_w, lm_b, dims: DecodeDims, w_s=None, quant: str = "none"):
    if not x.is_cuda:
        return lm_head_ln_plain(x, ln_w, ln_b, lm_w, lm_b, dims, w_s, quant)
    b, dev, vp = x.shape[0], x.device, dims.padded_vocab
    _rows(b)  # also the Transformer step's head (ops/tdecode_kernel)
    x = x.contiguous()
    _need(x, "x", torch.float32, (b, dims.d_model), dev)
    _need(ln_w, "ln_w", torch.float32, (dims.d_model,), dev)
    _need(ln_b, "ln_b", torch.float32, (dims.d_model,), dev)
    s_ptr = _weights(lm_w, w_s, quant, vp, dims.d_model, dev)
    _need(lm_b, "lm_b", torch.float32, (vp,), dev)
    logits = torch.empty(b, vp, dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.mg_lm_head_ln(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), lm_w.data_ptr(), s_ptr, lm_b.data_ptr(),
        logits.data_ptr(), b, dims.d_model, vp, LN_EPS, _FMT[quant], stream_ptr(x),
    )
    check(lib, err, "lm_head_ln")
    _count("lm_head_ln", quant)
    return logits


def sample_tail(logits, gram, hist, bucket, dims: DecodeDims):
    if not logits.is_cuda:
        return sample_tail_plain(logits, gram, hist, bucket, dims)
    b, dev, vp, v = logits.shape[0], logits.device, dims.padded_vocab, dims.vocab_size
    logits = logits.contiguous()
    _need(logits, "logits", torch.float32, (b, vp), dev)
    _need(gram, "gram", torch.float32, (5, vp), dev)
    _need(hist, "hist", torch.int32, (b, v), dev)
    _need(bucket, "bucket", torch.int64, (b,), dev)
    vals = torch.empty(b, 3, dtype=torch.float32, device=dev)
    idxs = torch.empty(b, 3, dtype=torch.int64, device=dev)
    lib = load_library()
    err = lib.mg_sample_tail(
        logits.data_ptr(), b, vp, v, gram.data_ptr(), hist.data_ptr(), bucket.data_ptr(),
        dims.dyn_start, dims.length_start, vals.data_ptr(), idxs.data_ptr(), stream_ptr(logits),
    )
    check(lib, err, "sample_tail")
    _count("sample_tail")
    return vals, idxs


StepOps = Tuple[Callable, Callable, Callable, Callable, Callable]
# (in_proj, mixer, out_proj, head, tail): the kernels, or the chain of plain
# versions on any device that the kernels are held to.
KERNEL_OPS: StepOps = (in_proj_conv, mixer_state, out_proj_rms, lm_head_ln, sample_tail)
PLAIN_OPS: StepOps = (in_proj_conv_plain, mixer_state_plain, out_proj_rms_plain, lm_head_ln_plain,
                      sample_tail_plain)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def decode_logits(dp: dict, token: torch.Tensor, carry: Carry, dims: DecodeDims,
                  ops: StepOps = KERNEL_OPS, quant: str = "none") -> torch.Tensor:
    """Embed `token` (B,) and run the stack one step: (B, padded_vocab)
    logits with bias. `carry` advances in place. `quant` must match the
    pack (check_pack)."""
    check_pack(dp, quant)
    in_proj, mixer, out_proj, head = ops[:4]
    conv, ssm = carry
    s_in, s_out = dp.get("w_in_s"), dp.get("w_out_s")
    x = F.embedding(token, dp["embed"])
    for i in range(dims.n_layers):
        zx = in_proj(x, dp["w_in"][i], dp["conv_w"][i], dp["conv_b"][i], dp["dt_bias"][i], conv[i], dims,
                     None if s_in is None else s_in[i], quant)
        g = mixer(zx, dp["a_h"][i], dp["d_h"][i], ssm[i], dims)
        x = out_proj(g, dp["norm_w"][i], dp["w_out"][i], dims, None if s_out is None else s_out[i], quant)
    return head(x, dp["ln_w"], dp["ln_b"], dp["lm_w"], dp["lm_b"], dims, dp.get("lm_s"), quant)


def fused_logits_step(dp: dict, token: torch.Tensor, carry: Carry, dims: DecodeDims,
                      quant: str = "none"):
    """One decode step: (logits (B, vocab), carry). Matches MambaLM.step at
    bf16 tolerance (int8 packs: at their quantisation noise)."""
    logits = decode_logits(dp, token, carry, dims, quant=quant)
    return logits[:, :dims.vocab_size], carry


def fused_sample_step(dp: dict, token: torch.Tensor, carry: Carry, hist: torch.Tensor,
                      bucket: torch.Tensor, dims: DecodeDims, quant: str = "none"):
    """One decode step with the sampler tail: (vals (B,3), idxs (B,3), carry);
    ties to the lowest index, as sample/sampler._iter_top_k."""
    logits = decode_logits(dp, token, carry, dims, quant=quant)
    vals, idxs = sample_tail(logits, dp["gram"], hist, bucket, dims)
    return vals, idxs, carry
