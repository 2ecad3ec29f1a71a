"""GPTQ-calibrated int8 weights for the decode kernels (port of
musicgen_tpu/ops/gptq.py).

GPTQ (Frantar et al. 2022, arXiv:2210.17323) quantizes a weight matrix's
input rows in order and spreads each row's rounding error over the rows not
yet quantized, through the Cholesky factor of the inverse calibration moment
H = E[x x^T]. It minimizes the functional error ||X W - X Q|| where
round to nearest (RTN, `decode_kernel.quantize_cols`) minimizes ||W - Q||.

The packs keep `quantize_cols`' layout, (q (N, K) int8, s (K / 256, N) f32),
so kernel B' (W8A16, csrc/decode_gemv.cu) for Mamba and kernel G (W8A16,
csrc/xlstm_step.cu) for the xLSTM run them unchanged: pass
`make_gptq_quantizer(collect_hessians(...))` as `quantizer=` to
`decode_kernel.build_decode_params` or `xdecode_kernel.build_xlstm_decode_params`.
The solver is host numpy, as in the JAX package, once a checkpoint; the
calibration forwards run on the model's device.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .decode_kernel import QUANT_GROUP, quantize_cols

QuantFn = Callable[[str, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

#: Calibrated Mamba sites: the three matrices kernel B' streams in int8.
CALIB_SITES = ("in_proj", "out_proj", "lm_head")

#: Calibrated xLSTM sites (the packs' int8 matrices). The pack concatenates
#: w_i|w_f and w_z|w_o, whose halves share one input each, so only the first
#: member of each pair needs a moment.
XLSTM_CALIB_SITES = ("w_i", "w_z", "up_proj", "down_proj", "up", "down", "lm_head")


def site_modules(model) -> Dict[str, Tuple[str, nn.Linear]]:
    """{site key: (site name, the nn.Linear whose input it reads)}, keyed as
    the JAX package's flax paths, which the pack builders pass to the
    quantizer: 'layer_{i}/in_proj', 'layer_{i}/out_proj' and 'lm_head' for a
    MambaLM; 'stack/block_{b}/slstm/w_i', '.../slstm/w_z', '.../ffn/up',
    '.../ffn/down', 'stack/block_{b}/mlstm/up_proj', '.../mlstm/down_proj'
    and 'lm_head' for an XLSTMLM."""
    out = {"lm_head": ("lm_head", model.output_layer)}
    if hasattr(model.layers, "blocks"):
        slstm_at = set(model.cfg.slstm_at)
        for b, blk in enumerate(model.layers.blocks):
            base = f"stack/block_{b}"
            if b in slstm_at:
                for name, mod in (("w_i", blk.xlstm.igate), ("w_z", blk.xlstm.zgate),
                                  ("up", blk.ffn.proj_up), ("down", blk.ffn.proj_down)):
                    out[f"{base}/{'ffn' if name in ('up', 'down') else 'slstm'}/{name}"] = (name, mod)
            else:
                out[f"{base}/mlstm/up_proj"] = ("up_proj", blk.xlstm.proj_up)
                out[f"{base}/mlstm/down_proj"] = ("down_proj", blk.xlstm.proj_down)
        return out
    for i, layer in enumerate(model.layers):
        out[f"layer_{i}/in_proj"] = ("in_proj", layer.in_proj)
        out[f"layer_{i}/out_proj"] = ("out_proj", layer.out_proj)
    return out


@torch.no_grad()
def collect_hessians(model, batches: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                     sites: Sequence[str] = CALIB_SITES) -> Dict[str, np.ndarray]:
    """Per-site input second moments H = E[x x^T] (K, K) float64 from the
    model's full-sequence forward on each (tokens (B, T), meta (B, M))
    batch: each input of a site's nn.Linear, flattened to (rows, K), gives
    x^T x in f32, summed in float64 and divided by the rows (JAX gptq.py
    :72-86). The xLSTM runs its forward, whose sLSTM scan is kernel H on the
    card; a MambaLM runs its prefill, the forward's function with the SSD
    scan through kernel A on the card (the same bits as the forward on the
    CPU). Every position reaches every site, lm_head included."""
    run = model if hasattr(model.layers, "blocks") else model.prefill
    moments: Dict[str, np.ndarray] = {}
    counts: Dict[str, int] = {}

    def hook(key):
        def pre(_mod, args):
            x = args[0].detach().to(torch.float32)
            x = x.reshape(-1, x.shape[-1])
            h = (x.t() @ x).cpu().numpy().astype(np.float64)
            moments[key] = moments[key] + h if key in moments else h
            counts[key] = counts.get(key, 0) + x.shape[0]
        return pre

    handles = [mod.register_forward_pre_hook(hook(key))
               for key, (name, mod) in site_modules(model).items() if name in sites]
    try:
        for tokens, meta in batches:
            run(tokens, meta)
    finally:
        for handle in handles:
            handle.remove()
    return {k: v / max(counts[k], 1) for k, v in moments.items()}


def gptq_quantize(w: np.ndarray, hessian: np.ndarray, group: int = QUANT_GROUP, percdamp: float = 0.01,
                  blocksize: int = 128, maxq: float = 127.0) -> Tuple[np.ndarray, np.ndarray]:
    """GPTQ int8 of w (K, N) under the calibration moment `hessian` (K, K):
    (q (K, N) int8, s (G, N) f32), the JAX package's layout and bits (JAX
    gptq.py :90-152). Rows in index order (no act-order: the kernels need
    contiguous K-groups); each group's column scales are set on entry from
    the error-compensated values by RTN's max / 127 rule; dead inputs
    (zero moment) are zeroed."""
    w = np.array(w, dtype=np.float64)
    k, n = w.shape
    if k % group:
        group = k  # one group (small matrices)
    h = np.array(hessian, dtype=np.float64)
    if h.shape != (k, k):
        raise ValueError(f"gptq_quantize: moment {h.shape} does not match w {w.shape}")

    dead = np.diag(h) <= 0
    h[dead, dead] = 1.0
    w[dead, :] = 0.0
    damp = percdamp * float(np.mean(np.diag(h)))
    h[np.diag_indices(k)] += max(damp, 1e-12)

    # The upper Cholesky factor U of H^-1 (U^T U = H^-1): row i's self
    # coupling is U[i, i], its forward coupling U[i, i + 1:].
    hinv_u = np.linalg.cholesky(np.linalg.inv(h)).T

    q_out = np.zeros((k, n), dtype=np.int8)
    s_out = np.zeros((k // group, n), dtype=np.float32)
    for b0 in range(0, k, blocksize):
        b1 = min(b0 + blocksize, k)
        wb = w[b0:b1, :]
        err = np.zeros((b1 - b0, n), dtype=np.float64)
        for i in range(b0, b1):
            j = i - b0
            if i % group == 0:
                scale = np.max(np.abs(w[i:min(i + group, k), :]), axis=0) / maxq
                s_out[i // group, :] = np.maximum(scale, 1e-20).astype(np.float32)
            scale64 = s_out[i // group, :].astype(np.float64)
            row = wb[j, :]
            q = np.clip(np.round(row / scale64), -maxq, maxq)
            q_out[i, :] = q.astype(np.int8)
            e = (row - q * scale64) / hinv_u[i, i]
            wb[j + 1:, :] -= np.outer(hinv_u[i, j + 1 + b0:b1], e)  # within the block, rank 1
            err[j, :] = e
        if b1 < k:
            w[b1:, :] -= hinv_u[b0:b1, b1:].T @ err  # the rows after the block, at once
    return q_out, s_out


def make_gptq_quantizer(hessians: Dict[str, np.ndarray], group: int = QUANT_GROUP,
                        percdamp: float = 0.01) -> QuantFn:
    """The pack builders' `quantizer`: (site, w (N, K)) -> (q (N, K) int8,
    s (G, N) f32) on w's device. A site with a moment gets GPTQ, memoized
    (a pack for another batch size reuses the solve); a site without one
    gets RTN `quantize_cols`, the uncalibrated pack's bits. A weight padded
    along K keeps the unpadded moment, zero-padded (its pad inputs are dead)."""
    cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def quantize(name: str, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if name in cache:
            return cache[name]
        h = hessians.get(name)
        if h is None:
            return quantize_cols(w, group)
        kw = int(w.shape[1])
        if h.shape[0] != kw:
            hp = np.zeros((kw, kw), dtype=np.float64)
            hp[:h.shape[0], :h.shape[0]] = h
            h = hp
        q, s = gptq_quantize(w.detach().to(torch.float64).cpu().numpy().T, h, group, percdamp)
        cache[name] = (torch.from_numpy(np.ascontiguousarray(q.T)).to(w.device), torch.from_numpy(s).to(w.device))
        return cache[name]

    return quantize
