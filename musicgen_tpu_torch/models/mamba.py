"""Composer-conditioned Mamba-2 LM in PyTorch.

Port of musicgen_tpu/models/mamba.py (reference models/mamba/mamba.py): token
embedding + metadata embedding, meta PREPENDED; 10 Mamba-2 mixers stacked
WITHOUT residuals between them (a quirk of the reference model, kept on
purpose); final LayerNorm (eps 1e-6, flax's default); lm_head; logits sliced
[:, 6:]. 101,972,666 parameters at the reference size.

Module and parameter names follow the reference's mamba_ssm `state_dict`
layout (`layers.{i}.in_proj.weight`, `layers.{i}.conv1d.weight`, ...), the
layout musicgen_tpu/interop/torch_import.py maps, so a reference `.pth` and
an exported JAX checkpoint load unchanged.

`prefill` runs the SSD scan through kernel A (ops/ssd_kernel.ssd_scan) on
CUDA tensors; `forward` and `step` are plain PyTorch. The in/out projections
stay `torch` matmuls, as the JAX package left them to XLA.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import MambaConfig
from ..ops.ssd_kernel import ssd_scan
from ..ops.ssm import causal_conv1d, causal_conv1d_step, ssd_chunked, ssd_step

LayerState = Dict[str, torch.Tensor]


def _rms_norm_gated(y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """RMSNorm(y * silu(z)) * weight, Mamba-2's gated output norm."""
    y = y * F.silu(z)
    var = torch.mean(y * y, dim=-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * weight


class GatedRMSNorm(nn.Module):
    """Holds the `norm.weight` of a mixer (mamba_ssm's RMSNormGated)."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))

    def forward(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return _rms_norm_gated(y, z, self.weight)


class Mamba2Mixer(nn.Module):
    def __init__(self, cfg: MambaConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        d_in_proj = 2 * c.d_inner + 2 * c.ngroups * c.d_state + c.nheads
        self.in_proj = nn.Linear(c.d_model, d_in_proj, bias=False)
        # Only the parameters are used: the conv runs as ops/ssm.causal_conv1d.
        self.conv1d = nn.Conv1d(c.conv_dim, c.conv_dim, c.d_conv, groups=c.conv_dim, bias=True)
        self.dt_bias = nn.Parameter(torch.zeros(c.nheads))
        self.A_log = nn.Parameter(torch.zeros(c.nheads))
        self.D = nn.Parameter(torch.ones(c.nheads))
        self.norm = GatedRMSNorm(c.d_inner)
        self.out_proj = nn.Linear(c.d_inner, c.d_model, bias=False)

    @property
    def conv_w(self) -> torch.Tensor:
        """(K, conv_dim) taps, tap K-1 on the newest input."""
        return self.conv1d.weight[:, 0, :].t()

    def _split_in_proj(self, zxbcdt: torch.Tensor):
        c = self.cfg
        gn = c.ngroups * c.d_state
        return torch.split(zxbcdt, [c.d_inner, c.d_inner, gn, gn, c.nheads], dim=-1)

    def _split_xbc(self, xbc: torch.Tensor):
        c = self.cfg
        gn = c.ngroups * c.d_state
        return torch.split(xbc, [c.d_inner, gn, gn], dim=-1)

    def _scan(self, u: torch.Tensor, use_kernel: bool):
        """Shared body of forward/prefill. Returns (out, raw xbc, ssm state)."""
        c = self.cfg
        b, t, _ = u.shape
        z, x, Bm, Cm, dt = self._split_in_proj(self.in_proj(u))
        xbc_raw = torch.cat([x, Bm, Cm], dim=-1)
        xbc = F.silu(causal_conv1d(xbc_raw, self.conv_w, self.conv1d.bias))
        x, Bm, Cm = self._split_xbc(xbc)
        dt = F.softplus(dt.to(torch.float32) + self.dt_bias)
        A = -torch.exp(self.A_log)

        # Pad T to a chunk multiple for the chunked scan; pad steps have
        # dt = 0 (decay 1, no update), so the final state stays exact.
        chunk = min(c.chunk_size, max(16, t))
        pad = (-t) % chunk

        def padded(v):
            return F.pad(v, (0, 0, 0, pad)) if pad else v

        tp = t + pad
        xh = padded(x).reshape(b, tp, c.nheads, c.headdim)
        dth = padded(dt).reshape(b, tp, c.nheads)
        Bh = padded(Bm).reshape(b, tp, c.ngroups, c.d_state)
        Ch = padded(Cm).reshape(b, tp, c.ngroups, c.d_state)
        scan = ssd_scan if use_kernel else ssd_chunked
        y, ssm_state = scan(xh, dth, A, Bh, Ch, chunk=chunk)
        y = y[:, :t]
        y = y + x.reshape(b, t, c.nheads, c.headdim) * self.D[None, None, :, None]
        y = y.reshape(b, t, c.d_inner).to(u.dtype)
        y = self.norm(y, z)
        return self.out_proj(y), xbc_raw, ssm_state

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        """u: (B, T, d_model) -> (B, T, d_model), plain PyTorch throughout."""
        return self._scan(u, use_kernel=False)[0]

    def prefill(self, u: torch.Tensor) -> Tuple[torch.Tensor, LayerState]:
        """Like forward, but also returns the decode state (conv tail + SSM
        state). The scan goes through kernel A."""
        c = self.cfg
        out, xbc_raw, ssm_state = self._scan(u, use_kernel=True)
        tail = xbc_raw[:, -(c.d_conv - 1):, :]
        pad_t = c.d_conv - 1 - tail.shape[1]
        if pad_t > 0:
            tail = F.pad(tail, (0, 0, pad_t, 0))
        return out, {"conv": tail, "ssm": ssm_state}

    def step(self, u: torch.Tensor, state: LayerState) -> Tuple[torch.Tensor, LayerState]:
        """u: (B, d_model) -> (B, d_model), O(1) state update."""
        c = self.cfg
        b = u.shape[0]
        z, x, Bm, Cm, dt = self._split_in_proj(self.in_proj(u))
        xbc = torch.cat([x, Bm, Cm], dim=-1)
        conv_out, conv_state = causal_conv1d_step(xbc, state["conv"], self.conv_w, self.conv1d.bias)
        x, Bm, Cm = self._split_xbc(F.silu(conv_out))
        dt = F.softplus(dt.to(torch.float32) + self.dt_bias)
        A = -torch.exp(self.A_log)
        xh = x.reshape(b, c.nheads, c.headdim)
        y, ssm_state = ssd_step(
            xh, dt, A, Bm.reshape(b, c.ngroups, c.d_state),
            Cm.reshape(b, c.ngroups, c.d_state), state["ssm"],
        )
        y = y + xh.to(torch.float32) * self.D[None, :, None]
        y = self.norm(y.reshape(b, c.d_inner).to(u.dtype), z)
        return self.out_proj(y), {"conv": conv_state, "ssm": ssm_state}


class MambaLM(nn.Module):
    """Composer-conditioned Mamba-2 LM (reference models/mamba/mamba.py)."""

    def __init__(self, cfg: MambaConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.token_embedding = nn.Embedding(c.vocab_size, c.d_model)
        self.metadata_embedding = nn.Embedding(c.metadata_vocab_size, c.d_model)
        self.layers = nn.ModuleList(Mamba2Mixer(c) for _ in range(c.n_layers))
        self.norm = nn.LayerNorm(c.d_model, eps=1e-6)
        self.output_layer = nn.Linear(c.d_model, c.vocab_size)

    def _embed(self, tokens: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.metadata_embedding(meta), self.token_embedding(tokens)], dim=1)

    def _stack(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        # Reference quirk: NO residual between layers (mamba.py:32-33).
        return x + y if self.cfg.residual else y

    def hidden(self, tokens: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
        """Final-norm hidden states (B, meta+T, d_model)."""
        x = self._embed(tokens, meta)
        for layer in self.layers:
            x = self._stack(x, layer(x))
        return self.norm(x)

    def forward(self, tokens: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
        """(B, T) tokens + (B, 6) meta -> (B, T, vocab) logits."""
        return self.output_layer(self.hidden(tokens, meta))[:, meta.shape[1]:]

    def prefill(self, tokens: torch.Tensor, meta: torch.Tensor):
        """Returns (logits (B, T, vocab), per-layer decode states)."""
        x = self._embed(tokens, meta)
        states = []
        for layer in self.layers:
            y, st = layer.prefill(x)
            x = self._stack(x, y)
            states.append(st)
        logits = self.output_layer(self.norm(x))
        return logits[:, meta.shape[1]:], tuple(states)

    def step(self, token: torch.Tensor, states: Tuple[LayerState, ...]):
        """token (B,) -> (logits (B, vocab), new states)."""
        x = self.token_embedding(token)
        new_states = []
        for layer, st in zip(self.layers, states):
            y, st = layer.step(x, st)
            x = self._stack(x, y)
            new_states.append(st)
        return self.output_layer(self.norm(x)), tuple(new_states)


def empty_model(cfg: MambaConfig, device: torch.device | str) -> MambaLM:
    """An uninitialised MambaLM on `device`: built on the meta device, so the
    constructors draw no random numbers and fill nothing that the caller's
    `load_state_dict` or `init_weights_` overwrites anyway."""
    with torch.device("meta"):
        model = MambaLM(cfg)
    return model.to_empty(device=device)


@torch.no_grad()
def init_weights_(model: MambaLM, seed: int) -> MambaLM:
    """Random weights from `seed`, drawn on the CPU (the same numbers on any
    device): matrices N(0, 1/fan_in), embeddings N(0, 1), the Mamba-2
    dt_bias / A_log / D init of the JAX package, unit norms, zero biases."""
    gen = torch.Generator().manual_seed(seed)
    c = model.cfg

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=gen) * std)

    def uniform(n: int, lo: float, hi: float) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(n, generator=gen)

    normal_(model.token_embedding.weight, 1.0)
    normal_(model.metadata_embedding.weight, 1.0)
    for layer in model.layers:
        normal_(layer.in_proj.weight, 1.0 / math.sqrt(c.d_model))
        normal_(layer.conv1d.weight, 1.0 / math.sqrt(c.d_conv))
        layer.conv1d.bias.zero_()
        dt = torch.exp(uniform(c.nheads, math.log(1e-3), math.log(1e-1))).clamp(min=1e-4)
        layer.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))  # softplus^-1(dt)
        layer.A_log.copy_(torch.log(uniform(c.nheads, 1.0, 16.0)))
        layer.D.fill_(1.0)
        layer.norm.weight.fill_(1.0)
        normal_(layer.out_proj.weight, 1.0 / math.sqrt(c.d_inner))
    model.norm.weight.fill_(1.0)
    model.norm.bias.zero_()
    normal_(model.output_layer.weight, 1.0 / math.sqrt(c.d_model))
    model.output_layer.bias.zero_()
    return model
