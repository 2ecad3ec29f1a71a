"""Kernel J: the ablation of kernel B's decode step (csrc/decode_ablate.cu).

Replaces experiments/kernel_ablate.py `make_variant` (via `call_variant`):
variants of the Mamba decode step that each drop a part of it, so that the
differences of their times split a step's device time. Each variant is a
`decode_kernel.StepOps` run by `decode_kernel.decode_logits`, so two
variants differ in exactly the work one of them removes:

  "dma"    one mg_ablate_stream a layer: reads every byte of the layer's w_in
           and w_out, reads and writes its states in place, and sets
           x = x + 1e-6 W_in[:B, :d] + 1e-6 W_out[:B, :d] (JAX's (K, N)
           layout); its in_proj and mixer slots only gather their operands.
           11 launches a step.
  "mm"     zx = bf16(x) . W_in^T, then x = bf16(zx[:, :d_inner]) . W_out^T
           (two launches of kernel B's plain GEMV a layer); the states are
           left as they are. 21 launches.
  "nossd"  kernel B's in_proj_conv (conv step, silu), mg_ablate_nossd (no
           SSD: y = x_ssd * D, g = y * silu(z), ssm_state *= 0.999 in place),
           kernel B's out_proj_rms (gated RMSNorm, out_proj). 31 launches.
  "full"   kernel B without the sampler tail (decode_kernel.KERNEL_OPS).
           31 launches.

The three ablated variants end in the head bf16(x) . lm_w^T over the
padded vocabulary, without the final LayerNorm and the bias, as the TPU
variants do; "full" keeps both. VARIANTS holds the kernels' StepOps,
PLAIN_VARIANTS the chains of plain versions they are held to.

Every wrapper takes the plain version for CPU tensors; for CUDA tensors it
launches its kernel or raises. Each launch adds one to LAUNCHES[name].
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from . import decode_kernel as dk
from .build import check, load_library, stream_ptr

NOSSD_DECAY = 0.999  # the TPU variant's stand-in for the SSD state update
LAUNCHES: collections.Counter = collections.Counter()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def gemv_plain(x, w, split=None):
    """bf16(x) . W^T (f32 sums): x (R, K), w (N, K) bf16 -> (R, N), or the
    pair (out[:, :split], out[:, split:]) contiguous."""
    out = F.linear(_bf16(x), w.to(torch.float32))
    if split is None:
        return out
    return out[:, :split].contiguous(), out[:, split:].contiguous()


def stream_layer_plain(x, w_in, w_out, conv_state, ssm_state, sink=None):
    """V_dma's layer: x + 1e-6 W_in[:B, :d] + 1e-6 W_out[:B, :d] in JAX's
    (K, N) layout (w_in[c, r], w_out[c, r] here). The states pass through
    (the kernel reads and writes them). `sink` (a 1-element int32 tensor) is
    XORed with the XOR of every 32-bit word of w_in and w_out."""
    b, d = x.shape
    t1 = w_in[:d, :b].t().to(torch.float32)
    t2 = w_out[:d, :b].t().to(torch.float32)
    if sink is not None:
        sink.bitwise_xor_(xor_words(w_in) ^ xor_words(w_out))
    return x + t1 * 1e-6 + t2 * 1e-6


def nossd_plain(zx, d_h, ssm_state, dims: dk.DecodeDims):
    """V_nossd's mixer: g = zx[:, d:2d] * D[head] * silu(zx[:, :d]) with
    d = d_inner; ssm_state *= NOSSD_DECAY in place."""
    di = dims.d_inner
    z, xs = zx[:, :di], zx[:, di:2 * di]
    ssm_state.mul_(NOSSD_DECAY)
    y = xs * d_h.repeat_interleave(dims.headdim)
    return y * (z * torch.sigmoid(z))


def xor_words(t: torch.Tensor) -> torch.Tensor:
    """XOR of every 32-bit word of a contiguous tensor (an even count of
    bf16 values), as a 1-element int32 tensor."""
    v = t.contiguous().view(-1).view(torch.int32)
    while v.numel() > 1:
        half = v.numel() // 2
        folded = v[:half] ^ v[half:2 * half]
        v = torch.cat([folded, v[2 * half:]]) if v.numel() % 2 else folded
    return v.clone()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def gemv(x, w, split=None):
    if not x.is_cuda:
        return gemv_plain(x, w, split)
    r, k = x.shape
    n, dev = w.shape[0], x.device
    dk._rows(r)
    dk._need(x, "x", torch.float32, (r, k), dev)
    dk._need(w, "w", torch.bfloat16, (n, k), dev)
    err = dk.gemv_shape_error(k, n, k, "none", r)
    if err:
        raise ValueError(err)
    cut = n if split is None else split
    if not 1 <= cut <= n:
        raise ValueError(f"split must be in 1..{n}, got {split}")
    out0 = torch.empty(r, cut, dtype=torch.float32, device=dev)
    out1 = torch.empty(r, n - cut, dtype=torch.float32, device=dev) if cut < n else None
    lib = load_library()
    err = lib.mg_ablate_gemv(x.data_ptr(), w.data_ptr(), out0.data_ptr(), 0 if out1 is None else out1.data_ptr(),
                             r, k, n, cut, stream_ptr(x))
    check(lib, err, "ablate_gemv")
    LAUNCHES["ablate_gemv"] += 1
    return out0 if split is None else (out0, out1)


def stream_layer(x, w_in, w_out, conv_state, ssm_state, sink=None):
    if not x.is_cuda:
        return stream_layer_plain(x, w_in, w_out, conv_state, ssm_state, sink)
    b, d = x.shape
    dev = x.device
    dk._need(x, "x", torch.float32, (b, d), dev)
    dk._need(w_in, "w_in", torch.bfloat16, (w_in.shape[0], d), dev)
    dk._need(w_out, "w_out", torch.bfloat16, (d, w_out.shape[1]), dev)
    dk._need(conv_state, "conv_state", torch.float32, tuple(conv_state.shape), dev)
    dk._need(ssm_state, "ssm_state", torch.float32, tuple(ssm_state.shape), dev)
    if sink is not None:
        dk._need(sink, "sink", torch.int32, (1,), dev)
    out = torch.empty_like(x)
    lib = load_library()
    err = lib.mg_ablate_stream(
        x.data_ptr(), w_in.data_ptr(), w_out.data_ptr(), conv_state.data_ptr(), ssm_state.data_ptr(), out.data_ptr(),
        b, d, w_in.shape[0], w_out.shape[1], conv_state.numel(), ssm_state.numel(), 1.0,  # keep: pass through
        0 if sink is None else sink.data_ptr(), stream_ptr(x),
    )
    check(lib, err, "ablate_stream")
    LAUNCHES["ablate_stream"] += 1
    return out


def nossd(zx, d_h, ssm_state, dims: dk.DecodeDims):
    if not zx.is_cuda:
        return nossd_plain(zx, d_h, ssm_state, dims)
    b, dev, di = zx.shape[0], zx.device, dims.d_inner
    dk._rows(b)
    dk._need(zx, "zx", torch.float32, (b, dims.d_in_proj), dev)
    dk._need(d_h, "d_h", torch.float32, (dims.nheads,), dev)
    dk._need(ssm_state, "ssm_state", torch.float32, (di, b * dims.d_state), dev)
    g = torch.empty(b, di, dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.mg_ablate_nossd(zx.data_ptr(), d_h.data_ptr(), ssm_state.data_ptr(), g.data_ptr(), b, dims.d_in_proj,
                              di, dims.headdim, ssm_state.numel(), NOSSD_DECAY, stream_ptr(zx))
    check(lib, err, "ablate_nossd")
    LAUNCHES["ablate_nossd"] += 1
    return g


# ---------------------------------------------------------------------------
# The variants as StepOps (in_proj, mixer, out_proj, head, tail) slots;
# none has a tail.
# ---------------------------------------------------------------------------


def _variants(gemv_fn, stream_fn, nossd_fn, in_proj_conv, out_proj_rms) -> dict:
    def head(x, ln_w, ln_b, lm_w, lm_b, dims, w_s=None, quant="none"):
        return gemv_fn(x, lm_w)

    def dma_in(x, w_in, conv_w, conv_b, dt_bias, conv_state, dims, w_s=None, quant="none"):
        return x, w_in, conv_state

    def dma_mixer(zx, a_h, d_h, ssm_state, dims):
        return (*zx, ssm_state)

    def dma_out(g, norm_w, w_out, dims, w_s=None, quant="none"):
        x, w_in, conv_state, ssm_state = g
        return stream_fn(x, w_in, w_out, conv_state, ssm_state)

    def mm_in(x, w_in, conv_w, conv_b, dt_bias, conv_state, dims, w_s=None, quant="none"):
        return gemv_fn(x, w_in, dims.d_inner)[0]  # the z columns; the rest are computed and dropped

    def mm_mixer(zx, a_h, d_h, ssm_state, dims):
        return zx

    def mm_out(g, norm_w, w_out, dims, w_s=None, quant="none"):
        return gemv_fn(g, w_out)

    def nossd_mixer(zx, a_h, d_h, ssm_state, dims):
        return nossd_fn(zx, d_h, ssm_state, dims)

    return {
        "dma": (dma_in, dma_mixer, dma_out, head, None),
        "mm": (mm_in, mm_mixer, mm_out, head, None),
        "nossd": (in_proj_conv, nossd_mixer, out_proj_rms, head, None),
    }


VARIANTS = {**_variants(gemv, stream_layer, nossd, dk.in_proj_conv, dk.out_proj_rms),
            "full": dk.KERNEL_OPS[:4] + (None,)}
PLAIN_VARIANTS = {**_variants(gemv_plain, stream_layer_plain, nossd_plain, dk.in_proj_conv_plain,
                              dk.out_proj_rms_plain),
                  "full": dk.PLAIN_OPS[:4] + (None,)}


def step_launches(mode: str, n_layers: int) -> dict:
    """The launches of one step of variant `mode`, by counter name
    (LAUNCHES here and decode_kernel.LAUNCHES), for a stack of n_layers."""
    return {
        "dma": {"ablate_stream": n_layers, "ablate_gemv": 1},
        "mm": {"ablate_gemv": 2 * n_layers + 1},
        "nossd": {"in_proj_conv": n_layers, "ablate_nossd": n_layers, "out_proj_rms": n_layers, "ablate_gemv": 1},
        "full": {"in_proj_conv": n_layers, "mixer_state": n_layers, "out_proj_rms": n_layers, "lm_head_ln": 1},
    }[mode]
