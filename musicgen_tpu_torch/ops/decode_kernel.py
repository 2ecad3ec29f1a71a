"""Kernel B: the one-token decode step of the whole Mamba stack, with the
sampler tail, as hand-written CUDA kernels (csrc/decode_*.cu).

Replaces musicgen_tpu/ops/pallas_decode.py (`_decode_kernel` via
`fused_decode_step`, `fused_logits_step` and `fused_sample_step`, bf16 pack).
The TPU kernel ran the step as ONE pallas_call whose grid walked the layers.
Here a step is a sequence of launches on one stream:

  for each of the L layers:
    in_proj_conv   bf16 GEMV + conv step + silu + softplus  (decode_gemv.cu)
    mixer_state    SSM state update + readout + gate        (decode_mixer.cu)
    out_proj_rms   gated RMSNorm + bf16 GEMV                (decode_gemv.cu)
  lm_head_ln       LayerNorm + bf16 GEMV + bias             (decode_gemv.cu)
  sample_tail      grammar, penalty, exact top-3            (decode_tail.cu)

Fusing the layers into one persistent launch is the business of the
whole-generation kernel (the port of ops/pallas_generate), still to come.

The conv state (L, B, 3, conv_dim) and the SSM state (L, d_inner, B*N), laid
out S[h*P+p, b*N+n] as in the TPU kernel, are updated IN PLACE by both the
kernels and their plain versions. Weights are bf16; activations are f32 and
rounded to bf16 right before each product, with f32 accumulation, at the
same points as the TPU kernel (`_mixer_math`, `_head_math`), so the plain
versions below agree with the JAX bodies.

Every wrapper takes the plain version for CPU tensors; for CUDA tensors it
launches its kernel or raises. Each counts its launches in `.launches`.
"""
from __future__ import annotations

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


@torch.no_grad()
def build_decode_params(model, batch: int) -> dict:
    """Pack a MambaLM's weights for the decode kernels (bf16 pack).

    Matrices stay in torch's (out, in) layout, which is K-contiguous: a warp
    streams one output column. lm_head is padded from vocab to padded_vocab
    rows (zero weights, zero bias; the tail never selects pad ids). Per-head
    vectors stay per head. Built once per generation, on the model's device."""
    cfg = model.cfg
    dims = DecodeDims.create(cfg, batch)
    L, v, vp = cfg.n_layers, cfg.vocab_size, dims.padded_vocab
    layers = model.layers
    f32, bf16 = torch.float32, torch.bfloat16

    def stack(fn, dtype=f32):
        return torch.stack([fn(layers[i]) for i in range(L)]).to(dtype).contiguous()

    dev = model.token_embedding.weight.device
    lm_w = torch.zeros(vp, cfg.d_model, dtype=bf16, device=dev)
    lm_w[:v] = model.output_layer.weight.to(bf16)
    lm_b = torch.zeros(vp, dtype=f32, device=dev)
    lm_b[:v] = model.output_layer.bias
    gram = torch.zeros(5, vp, dtype=f32, device=dev)
    gram[:, :v] = grammar_mask(device=dev)
    return {
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
        "lm_w": lm_w,  # (padded_vocab, d_model)
        "lm_b": lm_b,  # (padded_vocab,)
        "embed": model.token_embedding.weight.detach().to(f32).contiguous(),  # (vocab, d_model)
        "gram": gram,  # (5, padded_vocab) grammar rows by previous-token field
    }


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


def in_proj_conv_plain(x, w_in, conv_w, conv_b, dt_bias, conv_state, dims: DecodeDims):
    """zx = [z | silu(conv step) | softplus(dt + dt_bias)] from in_proj(x);
    conv_state (B, 3, conv_dim) advances in place."""
    di, dc, nh = dims.d_inner, dims.conv_dim, dims.nheads
    zx = F.linear(_bf16(x), w_in.to(torch.float32))
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


def out_proj_rms_plain(g, norm_w, w_out, dims: DecodeDims):
    """out_proj(g * rsqrt(mean(g^2) + 1e-5) * norm_w)."""
    var = torch.mean(g * g, dim=-1, keepdim=True)
    return F.linear(_bf16(g * torch.rsqrt(var + RMS_EPS) * norm_w), w_out.to(torch.float32))


def lm_head_ln_plain(x, ln_w, ln_b, lm_w, lm_b, dims: DecodeDims):
    """lm_head(LayerNorm(x)) + bias, var = E[x^2] - mean^2 as in `_head_math`."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(x * x, dim=-1, keepdim=True) - mean * mean
    h = (x - mean) * torch.rsqrt(var + LN_EPS)
    h = h * ln_w + ln_b
    return F.linear(_bf16(h), lm_w.to(torch.float32), lm_b)


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


def _kernel_dims(dims: DecodeDims, b: int) -> None:
    if dims.headdim != KERNEL_DIM or dims.d_state != KERNEL_DIM:
        raise ValueError(f"decode kernels need headdim = d_state = {KERNEL_DIM}")
    if not 1 <= b <= MAX_ROWS:
        raise ValueError(f"decode kernels take 1..{MAX_ROWS} rows, got {b}")


def in_proj_conv(x, w_in, conv_w, conv_b, dt_bias, conv_state, dims: DecodeDims):
    if not x.is_cuda:
        return in_proj_conv_plain(x, w_in, conv_w, conv_b, dt_bias, conv_state, dims)
    b, dev = x.shape[0], x.device
    _kernel_dims(dims, b)
    x = x.to(torch.float32).contiguous()
    _need(x, "x", torch.float32, (b, dims.d_model), dev)
    _need(w_in, "w_in", torch.bfloat16, (dims.d_in_proj, dims.d_model), dev)
    _need(conv_w, "conv_w", torch.float32, (4, dims.conv_dim), dev)
    _need(conv_b, "conv_b", torch.float32, (dims.conv_dim,), dev)
    _need(dt_bias, "dt_bias", torch.float32, (dims.nheads,), dev)
    _need(conv_state, "conv_state", torch.float32, (b, 3, dims.conv_dim), dev)
    zx = torch.empty(b, dims.d_in_proj, dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.mg_in_proj_conv(
        x.data_ptr(), w_in.data_ptr(), zx.data_ptr(), b, dims.d_model, dims.d_in_proj,
        dims.d_inner, dims.conv_dim, dims.nheads, conv_w.data_ptr(), conv_b.data_ptr(),
        dt_bias.data_ptr(), conv_state.data_ptr(), stream_ptr(x),
    )
    check(lib, err, "in_proj_conv")
    in_proj_conv.launches += 1
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
    mixer_state.launches += 1
    return g


def out_proj_rms(g, norm_w, w_out, dims: DecodeDims):
    if not g.is_cuda:
        return out_proj_rms_plain(g, norm_w, w_out, dims)
    b, dev = g.shape[0], g.device
    _kernel_dims(dims, b)
    g = g.contiguous()
    _need(g, "g", torch.float32, (b, dims.d_inner), dev)
    _need(norm_w, "norm_w", torch.float32, (dims.d_inner,), dev)
    _need(w_out, "w_out", torch.bfloat16, (dims.d_model, dims.d_inner), dev)
    out = torch.empty(b, dims.d_model, dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.mg_out_proj_rms(
        g.data_ptr(), norm_w.data_ptr(), w_out.data_ptr(), out.data_ptr(), b, dims.d_inner,
        dims.d_model, RMS_EPS, stream_ptr(g),
    )
    check(lib, err, "out_proj_rms")
    out_proj_rms.launches += 1
    return out


def lm_head_ln(x, ln_w, ln_b, lm_w, lm_b, dims: DecodeDims):
    if not x.is_cuda:
        return lm_head_ln_plain(x, ln_w, ln_b, lm_w, lm_b, dims)
    b, dev, vp = x.shape[0], x.device, dims.padded_vocab
    _kernel_dims(dims, b)
    x = x.contiguous()
    _need(x, "x", torch.float32, (b, dims.d_model), dev)
    _need(ln_w, "ln_w", torch.float32, (dims.d_model,), dev)
    _need(ln_b, "ln_b", torch.float32, (dims.d_model,), dev)
    _need(lm_w, "lm_w", torch.bfloat16, (vp, dims.d_model), dev)
    _need(lm_b, "lm_b", torch.float32, (vp,), dev)
    logits = torch.empty(b, vp, dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.mg_lm_head_ln(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), lm_w.data_ptr(), lm_b.data_ptr(),
        logits.data_ptr(), b, dims.d_model, vp, LN_EPS, stream_ptr(x),
    )
    check(lib, err, "lm_head_ln")
    lm_head_ln.launches += 1
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
    sample_tail.launches += 1
    return vals, idxs


KERNELS = (in_proj_conv, mixer_state, out_proj_rms, lm_head_ln, sample_tail)
for _k in KERNELS:
    _k.launches = 0

StepOps = Tuple[Callable, Callable, Callable, Callable]
KERNEL_OPS: StepOps = (in_proj_conv, mixer_state, out_proj_rms, lm_head_ln)
# The chain of plain versions on any device: what the kernels are held to.
PLAIN_OPS: StepOps = (in_proj_conv_plain, mixer_state_plain, out_proj_rms_plain, lm_head_ln_plain)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def decode_logits(dp: dict, token: torch.Tensor, carry: Carry, dims: DecodeDims,
                  ops: StepOps = KERNEL_OPS) -> torch.Tensor:
    """Embed `token` (B,) and run the stack one step: (B, padded_vocab)
    logits with bias. `carry` advances in place."""
    in_proj, mixer, out_proj, head = ops
    conv, ssm = carry
    x = F.embedding(token, dp["embed"])
    for i in range(dims.n_layers):
        zx = in_proj(x, dp["w_in"][i], dp["conv_w"][i], dp["conv_b"][i], dp["dt_bias"][i], conv[i], dims)
        g = mixer(zx, dp["a_h"][i], dp["d_h"][i], ssm[i], dims)
        x = out_proj(g, dp["norm_w"][i], dp["w_out"][i], dims)
    return head(x, dp["ln_w"], dp["ln_b"], dp["lm_w"], dp["lm_b"], dims)


def fused_logits_step(dp: dict, token: torch.Tensor, carry: Carry, dims: DecodeDims):
    """One decode step: (logits (B, vocab), carry). Matches MambaLM.step at
    bf16 tolerance."""
    logits = decode_logits(dp, token, carry, dims)
    return logits[:, :dims.vocab_size], carry


def fused_sample_step(dp: dict, token: torch.Tensor, carry: Carry, hist: torch.Tensor,
                      bucket: torch.Tensor, dims: DecodeDims):
    """One decode step with the sampler tail: (vals (B,3), idxs (B,3), carry);
    ties to the lowest index, as sample/sampler._iter_top_k."""
    vals, idxs = sample_tail(decode_logits(dp, token, carry, dims), dp["gram"], hist, bucket, dims)
    return vals, idxs, carry
