"""Composer-conditioned xLSTM LM in PyTorch.

Port of musicgen_tpu/models/xlstm.py (reference models/xlstm/xlstm_model.py,
NX-AI xLSTMBlockStack: 11 blocks of width 1024, sLSTM at (1, 4, 7, 10) with
conv k = 4, 4 heads, the powerlaw forget-gate bias and a 1.3x tanh-GELU FFN;
mLSTM elsewhere with conv k = 4, qkv blocksize 4 and 4 heads).

  mLSTM block:  x += down(h * silu(z)), with [x_m | z] = up(LN(x)),
                x_c = silu(conv(x_m)), q, k blockwise from x_c, v from x_m,
                h = headnorm(mlstm(q, k, v, i, f)) + skip * x_c,
                gates i, f from [q | k | v] in f32 (f through logsigmoid)
  sLSTM block:  x += groupnorm(slstm(W [x_c | LN(x)] + R h + b)), with
                x_c = silu(conv(LN(x))); then x += FFN(LN(x))

The LayerNorms are flax's (eps 1e-6, with bias); the head norm and group
norm use eps 1e-5; the FFN's GELU is the tanh approximation, as flax's
`nn.gelu` default. Parameter names follow the NX-AI `state_dict` layout
(`layers.blocks.{i}.xlstm.proj_up.weight`, `...mlstm_cell.igate.weight`,
`...slstm_cell._recurrent_kernel_`, ...), as musicgen_tpu/interop/
torch_import.py maps it, except that the four sLSTM input gates are full
(d, d) Linears, as the JAX model has them (interop.py expands the NX-AI
head-wise form at load).

`forward` and `prefill` run the sLSTM recurrence through kernel H
(ops/slstm_kernel) where `runs_kernel_h` picks it: a CUDA tensor outside grad
mode (kernel H has no backward) at a shape the kernel takes (every head
width up to 1,024); training, the CPU and wider heads run the plain scan, as
the JAX package does.
`step` is plain PyTorch, and the one-token decode step of the whole stack
has its kernel G in ops/xdecode_kernel. The projections stay `torch`
matmuls, as the JAX package left them to XLA.

`XLSTMClassifier` is the composer classifier (musicgen_tpu/models/xlstm.py
XLSTMClassifier): the same stack at width 512 on the tokens alone, its last
hidden state mapped by `fc` to meta logits.

`dtype` is the compute dtype (models/compute.py; f32 by default, bf16 for
cli.train --bf16), with the JAX model's casts: the embeddings, the
projections (up/down, the blockwise q/k/v, the sLSTM input gates, the FFN)
and the LayerNorms' outputs in the dtype; the conv promotes to f32, the
mLSTM gates and the mLSTM/sLSTM recurrences run in f32 (the sLSTM input
upcast before the scan, so that kernel H takes it), the head and group
norms are cast back to the dtype, and the lm_head (the classifier's fc)
stays f32.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ClassifierConfig, XLSTMConfig
from ..ops import slstm_kernel
from ..ops.mlstm import mlstm_chunkwise, mlstm_parallel, mlstm_step
from ..ops.slstm import powerlaw_blockdependent_bias, slstm_sequential, slstm_step
from ..ops.slstm_kernel import slstm_scan
from ..ops.ssm import causal_conv1d, causal_conv1d_step
from .compute import dense, embed, layer_norm

BlockState = Dict[str, object]
LN_EPS = 1e-6  # flax nn.LayerNorm's default
GROUP_EPS = 1e-5  # the head norm and the group norm


class Scale(nn.Module):
    """A per-channel scale (NX-AI's bias-free norms keep only `.weight`)."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))


class CausalConv(nn.Module):
    """Depthwise causal conv holding NX-AI's `conv1d.conv`; runs as
    ops/ssm.causal_conv1d (no cuDNN, so no TF32)."""

    def __init__(self, channels: int, k: int):
        super().__init__()
        self.conv = nn.Conv1d(channels, channels, k, groups=channels, bias=True)

    @property
    def taps(self) -> torch.Tensor:
        """(K, C) taps, tap K-1 on the newest input."""
        return self.conv.weight[:, 0, :].t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return causal_conv1d(x, self.taps, self.conv.bias)

    def step(self, x: torch.Tensor, state: torch.Tensor):
        return causal_conv1d_step(x, state, self.taps, self.conv.bias)


def conv_tail(x: torch.Tensor, k: int) -> torch.Tensor:
    """The last k-1 inputs (B, k-1, C), left-padded with zeros."""
    tail = x[:, -(k - 1):, :]
    return F.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))


class BlockwiseDense(nn.Module):
    """Block-diagonal projection (NX-AI LinearHeadwiseExpand with
    qkv_proj_blocksize): `weight` (nb, out, in) maps each block of bs
    features on its own."""

    def __init__(self, d: int, block_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(d // block_size, block_size, block_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nb, bs, _ = self.weight.shape
        xb = x.reshape(*x.shape[:-1], nb, bs).to(self.dtype)
        return torch.einsum("...ni,nji->...nj", xb, self.weight.to(self.dtype)).reshape(x.shape)


def _headnorm(h: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head LayerNorm without bias over the last axis (B, [T,] H, DH),
    then the heads flattened and scaled."""
    mean = h.mean(dim=-1, keepdim=True)
    var = h.var(dim=-1, unbiased=False, keepdim=True)
    hn = (h - mean) * torch.rsqrt(var + GROUP_EPS)
    return hn.reshape(*h.shape[:-2], -1) * scale


class MLSTMCell(nn.Module):
    def __init__(self, d_inner: int, num_heads: int):
        super().__init__()
        self.igate = nn.Linear(3 * d_inner, num_heads)
        self.fgate = nn.Linear(3 * d_inner, num_heads)
        self.outnorm = Scale(d_inner)


class MLSTMLayer(nn.Module):
    """The inner mLSTM layer (on the up-projected width)."""

    def __init__(self, cfg: XLSTMConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        d, di = cfg.embedding_dim, cfg.mlstm_inner
        self.dtype = dtype
        self.num_heads, self.d_inner, self.k = cfg.num_heads, di, cfg.conv1d_kernel_size
        self.dh = di // cfg.num_heads
        self.proj_up = nn.Linear(d, 2 * di, bias=False)
        self.conv1d = CausalConv(di, cfg.conv1d_kernel_size)
        self.q_proj = BlockwiseDense(di, cfg.qkv_proj_blocksize, dtype)
        self.k_proj = BlockwiseDense(di, cfg.qkv_proj_blocksize, dtype)
        self.v_proj = BlockwiseDense(di, cfg.qkv_proj_blocksize, dtype)
        self.mlstm_cell = MLSTMCell(di, cfg.num_heads)
        self.learnable_skip = nn.Parameter(torch.ones(di))
        self.proj_down = nn.Linear(di, d, bias=False)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(*t.shape[:-1], self.num_heads, self.dh)

    def _gates_qkv(self, x_c, x_m):
        q, k, v = self.q_proj(x_c), self.k_proj(x_c), self.v_proj(x_m)
        gate_in = torch.cat([q, k, v], dim=-1).to(torch.float32)
        cell = self.mlstm_cell
        return q, k, v, cell.igate(gate_in), cell.fgate(gate_in)

    def _out(self, h, x_c, z):
        h = _headnorm(h, self.mlstm_cell.outnorm.weight).to(self.dtype) + self.learnable_skip * x_c
        return dense(self.proj_down, h * F.silu(z), self.dtype)

    def _inputs(self, x):
        x_m, z = torch.chunk(dense(self.proj_up, x, self.dtype), 2, dim=-1)
        x_c = F.silu(self.conv1d(x_m))
        return x_m, z, x_c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_m, z, x_c = self._inputs(x)
        q, k, v, ig, fg = self._gates_qkv(x_c, x_m)
        return self._out(mlstm_parallel(self._heads(q), self._heads(k), self._heads(v), ig, fg), x_c, z)

    def prefill(self, x: torch.Tensor) -> Tuple[torch.Tensor, BlockState]:
        t = x.shape[1]
        x_m, z, x_c = self._inputs(x)
        q, k, v, ig, fg = self._gates_qkv(x_c, x_m)
        qh, kh, vh = self._heads(q), self._heads(k), self._heads(v)
        # Chunkwise form, T padded to the chunk; pad steps are inert (i = -1e30
        # writes nothing, f = 30 decays by logsigmoid(30) ~ 1e-13), as in JAX.
        chunk = min(256, max(16, t))
        pad = (-t) % chunk
        if pad:
            qh, kh, vh = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (qh, kh, vh))
            ig = F.pad(ig, (0, 0, 0, pad), value=-1e30)
            fg = F.pad(fg, (0, 0, 0, pad), value=30.0)
        h, mstate = mlstm_chunkwise(qh, kh, vh, ig, fg, chunk=chunk)
        return self._out(h[:, :t], x_c, z), {"conv": conv_tail(x_m, self.k), "mlstm": mstate}

    def step(self, x: torch.Tensor, state: BlockState) -> Tuple[torch.Tensor, BlockState]:
        x_m, z = torch.chunk(dense(self.proj_up, x, self.dtype), 2, dim=-1)
        conv_out, conv_state = self.conv1d.step(x_m, state["conv"])
        x_c = F.silu(conv_out)
        q, k, v, ig, fg = self._gates_qkv(x_c, x_m)
        h, mstate = mlstm_step(self._heads(q), self._heads(k), self._heads(v), ig, fg, state["mlstm"])
        return self._out(h, x_c, z), {"conv": conv_state, "mlstm": mstate}


def runs_kernel_h(wx: torch.Tensor) -> bool:
    """Whether the sLSTM scan on `wx` (B, T, 4, H, DH) runs kernel H,
    decided before any launch: on a CUDA tensor outside grad mode at a shape
    the kernel takes (slstm_kernel.refusal: any DH up to 1,024). Under grad
    (it has no backward), on the CPU and at a shape it refuses (DH > 1,024)
    the plain scan runs, as the JAX package's default does."""
    bsz, t, _, heads, dh = wx.shape
    return wx.is_cuda and not torch.is_grad_enabled() and slstm_kernel.refusal(bsz, t, heads, dh) is None


def scan(wx: torch.Tensor, r: torch.Tensor, b: torch.Tensor):
    """The sLSTM over the sequence from the zero state: the module-level
    `slstm_scan` (kernel H) where `runs_kernel_h`, else `slstm_sequential`."""
    return (slstm_scan if runs_kernel_h(wx) else slstm_sequential)(wx, r, b)


class SLSTMCell(nn.Module):
    """Holds NX-AI's `_recurrent_kernel_` (H, dh_in, 4, dh_out), gate order
    i, f, z, o, and `_bias_` (H, 4, dh)."""

    def __init__(self, num_heads: int, dh: int):
        super().__init__()
        self._recurrent_kernel_ = nn.Parameter(torch.empty(num_heads, dh, 4, dh))
        self._bias_ = nn.Parameter(torch.zeros(num_heads, 4, dh))

    def r(self) -> torch.Tensor:
        """(4, H, DH, DH): R[g, h, d_in, e_out] (ops/slstm)."""
        return self._recurrent_kernel_.permute(2, 0, 1, 3)

    def b(self) -> torch.Tensor:
        """(4, H, DH)."""
        return self._bias_.permute(1, 0, 2)


class SLSTMLayer(nn.Module):
    """The inner sLSTM layer with its block-diagonal recurrence."""

    def __init__(self, cfg: XLSTMConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = cfg.embedding_dim
        self.dtype = dtype
        self.num_heads, self.k = cfg.num_heads, cfg.conv1d_kernel_size
        self.dh = d // cfg.num_heads
        self.conv1d = CausalConv(d, cfg.conv1d_kernel_size)
        # i, f from the conv path; z, o from the layer's input.
        self.igate = nn.Linear(d, d, bias=False)
        self.fgate = nn.Linear(d, d, bias=False)
        self.zgate = nn.Linear(d, d, bias=False)
        self.ogate = nn.Linear(d, d, bias=False)
        self.slstm_cell = SLSTMCell(cfg.num_heads, self.dh)
        self.group_norm = Scale(d)

    def _wx(self, x, x_c) -> torch.Tensor:
        """(B, [T,] 4, H, DH) gate input preactivations in order i, f, z, o,
        computed in the compute dtype and upcast to f32 for the recurrence
        (slstm_sequential's upcast in JAX; kernel H takes f32 only)."""
        g = torch.stack([dense(self.igate, x_c, self.dtype), dense(self.fgate, x_c, self.dtype),
                         dense(self.zgate, x, self.dtype), dense(self.ogate, x, self.dtype)], dim=-2)
        return g.reshape(*g.shape[:-1], self.num_heads, self.dh).to(torch.float32)

    def _norm(self, h: torch.Tensor) -> torch.Tensor:
        return _headnorm(h, self.group_norm.weight).to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_c = F.silu(self.conv1d(x))
        h, _ = scan(self._wx(x, x_c), self.slstm_cell.r(), self.slstm_cell.b())
        return self._norm(h)

    def prefill(self, x: torch.Tensor) -> Tuple[torch.Tensor, BlockState]:
        x_c = F.silu(self.conv1d(x))
        h, sstate = scan(self._wx(x, x_c), self.slstm_cell.r(), self.slstm_cell.b())
        return self._norm(h), {"conv": conv_tail(x, self.k), "slstm": sstate}

    def step(self, x: torch.Tensor, state: BlockState) -> Tuple[torch.Tensor, BlockState]:
        conv_out, conv_state = self.conv1d.step(x, state["conv"])
        x_c = F.silu(conv_out)
        h, sstate = slstm_step(self._wx(x, x_c), self.slstm_cell.r(), self.slstm_cell.b(), state["slstm"])
        return self._norm(h), {"conv": conv_state, "slstm": sstate}


class FFN(nn.Module):
    def __init__(self, d: int, inner: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj_up = nn.Linear(d, inner)
        self.proj_down = nn.Linear(inner, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.proj_down, F.gelu(dense(self.proj_up, x, self.dtype), approximate="tanh"), self.dtype)


class XLSTMBlock(nn.Module):
    """Pre-LN residual mLSTM, or sLSTM followed by the FFN sub-block."""

    def __init__(self, cfg: XLSTMConfig, is_slstm: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = cfg.embedding_dim
        self.is_slstm = is_slstm
        self.dtype = dtype
        self.xlstm_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.xlstm = SLSTMLayer(cfg, dtype) if is_slstm else MLSTMLayer(cfg, dtype)
        if is_slstm:
            self.ffn_norm = nn.LayerNorm(d, eps=LN_EPS)
            self.ffn = FFN(d, cfg.ffn_inner, dtype)

    def _ffn(self, x):
        return x + self.ffn(layer_norm(self.ffn_norm, x, self.dtype)) if self.is_slstm else x

    def _norm(self, x):
        return layer_norm(self.xlstm_norm, x, self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._ffn(x + self.xlstm(self._norm(x)))

    def prefill(self, x: torch.Tensor):
        y, state = self.xlstm.prefill(self._norm(x))
        return self._ffn(x + y), state

    def step(self, x: torch.Tensor, state: BlockState):
        y, state = self.xlstm.step(self._norm(x), state)
        return self._ffn(x + y), state


class XLSTMStack(nn.Module):
    def __init__(self, cfg: XLSTMConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.blocks = nn.ModuleList(XLSTMBlock(cfg, i in cfg.slstm_at, dtype) for i in range(cfg.num_blocks))
        self.post_blocks_norm = nn.LayerNorm(cfg.embedding_dim, eps=LN_EPS)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(self.post_blocks_norm, x, self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        remat = self.cfg.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return self._norm(x)

    def prefill(self, x: torch.Tensor):
        states = []
        for block in self.blocks:
            x, st = block.prefill(x)
            states.append(st)
        return self._norm(x), tuple(states)

    def step(self, x: torch.Tensor, states):
        new_states = []
        for block, st in zip(self.blocks, states):
            x, st = block.step(x, st)
            new_states.append(st)
        return self._norm(x), tuple(new_states)


class XLSTMLM(nn.Module):
    """Composer-conditioned xLSTM generator (reference xlstm_model.py)."""

    def __init__(self, cfg: XLSTMConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.embedding_dim
        self.token_embedding = nn.Embedding(cfg.vocab_size, d)
        self.metadata_embedding = nn.Embedding(cfg.metadata_vocab_size, d)
        self.layers = XLSTMStack(cfg, dtype)
        self.output_layer = nn.Linear(d, cfg.vocab_size)

    def _embed(self, tokens: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
        return torch.cat([embed(self.metadata_embedding, meta, self.dtype),
                          embed(self.token_embedding, tokens, self.dtype)], dim=1)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """The f32 lm_head on the hidden states, whatever the compute dtype."""
        return self.output_layer(h.to(torch.float32))

    def hidden(self, tokens: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
        """Post-norm hidden states (B, meta+T, d): the lm_head input."""
        return self.layers(self._embed(tokens, meta))

    def forward(self, tokens: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
        """(B, T) tokens + (B, 6) meta -> (B, T, vocab) logits."""
        return self._logits(self.hidden(tokens, meta))[:, meta.shape[1]:]

    def prefill(self, tokens: torch.Tensor, meta: torch.Tensor):
        """Returns (logits (B, T, vocab), per-block decode states)."""
        x, states = self.layers.prefill(self._embed(tokens, meta))
        return self._logits(x)[:, meta.shape[1]:], states

    def step(self, token: torch.Tensor, states):
        """token (B,) -> (logits (B, vocab), new states)."""
        x, states = self.layers.step(embed(self.token_embedding, token, self.dtype), states)
        return self._logits(x), states


class DeadHead(nn.Module):
    """The reference Classifier's `output_layer` Linear, which it never
    calls (models/classifier/model.py:50, 53-58): zero buffers, so that the
    port's `.pth` holds its keys and a reference Classifier loads it with
    strict=True. Never read, never trained."""

    def __init__(self, d: int, vocab_size: int):
        super().__init__()
        self.register_buffer("weight", torch.zeros(vocab_size, d))
        self.register_buffer("bias", torch.zeros(vocab_size))


class XLSTMClassifier(nn.Module):
    """Composer classifier: tokens (B, T) -> meta logits (B, meta vocab)
    from the last position's post-norm hidden state."""

    def __init__(self, cfg: ClassifierConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.embedding_dim
        self.token_embedding = nn.Embedding(cfg.vocab_size, d)
        self.layers = XLSTMStack(cfg.stack, dtype)
        self.fc = nn.Linear(d, cfg.metadata_vocab_size)
        self.output_layer = DeadHead(d, cfg.vocab_size)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.layers(embed(self.token_embedding, tokens, self.dtype))
        return self.fc(x[:, -1, :].to(torch.float32))


def empty_model(cfg: XLSTMConfig | ClassifierConfig, device: torch.device | str,
                dtype: torch.dtype = torch.float32) -> XLSTMLM | XLSTMClassifier:
    """An uninitialised XLSTMLM (or XLSTMClassifier, for a ClassifierConfig)
    on `device` computing in `dtype`, its parameters f32 (built on the meta
    device)."""
    with torch.device("meta"):
        model = XLSTMClassifier(cfg, dtype) if isinstance(cfg, ClassifierConfig) else XLSTMLM(cfg, dtype)
    return model.to_empty(device=device)


@torch.no_grad()
def init_weights_(model: XLSTMLM | XLSTMClassifier, seed: int) -> XLSTMLM | XLSTMClassifier:
    """Random weights from `seed`, drawn on the CPU, at the scales of the JAX
    initializers: lecun-normal matrices, conv taps and blockwise kernels
    (std 1/sqrt(fan_in)), sLSTM recurrent kernels N(0, 1/dh), mLSTM
    forget-gate bias 3, the powerlaw sLSTM forget bias, ones for the norms,
    outnorm and learnable_skip, zeros elsewhere. The LM's embeddings are
    N(0, 1); the classifier's token embedding is flax nn.Embed's default,
    N(0, 1/d), and its dead `output_layer` zeros. The exp gates of a random
    full-size model then run where a trained model's do."""
    gen = torch.Generator().manual_seed(seed)
    c = model.layers.cfg

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=gen) * std)

    def lecun_(p: torch.Tensor, fan_in: int) -> None:
        normal_(p, 1.0 / math.sqrt(fan_in))

    classifier = isinstance(model, XLSTMClassifier)
    normal_(model.token_embedding.weight, 1.0 / math.sqrt(c.embedding_dim) if classifier else 1.0)
    if not classifier:
        normal_(model.metadata_embedding.weight, 1.0)
    for i, block in enumerate(model.layers.blocks):
        block.xlstm_norm.weight.fill_(1.0)
        block.xlstm_norm.bias.zero_()
        lyr = block.xlstm
        lecun_(lyr.conv1d.conv.weight, c.conv1d_kernel_size)
        lyr.conv1d.conv.bias.zero_()
        if block.is_slstm:
            d = c.embedding_dim
            for g in (lyr.igate, lyr.fgate, lyr.zgate, lyr.ogate):
                lecun_(g.weight, d)
            normal_(lyr.slstm_cell._recurrent_kernel_, 1.0 / math.sqrt(lyr.dh))
            lyr.slstm_cell._bias_.zero_()
            lyr.slstm_cell._bias_[:, 1] = powerlaw_blockdependent_bias(c.num_heads, lyr.dh, i, c.num_blocks)
            lyr.group_norm.weight.fill_(1.0)
            block.ffn_norm.weight.fill_(1.0)
            block.ffn_norm.bias.zero_()
            lecun_(block.ffn.proj_up.weight, d)
            block.ffn.proj_up.bias.zero_()
            lecun_(block.ffn.proj_down.weight, c.ffn_inner)
            block.ffn.proj_down.bias.zero_()
        else:
            di = c.mlstm_inner
            lecun_(lyr.proj_up.weight, c.embedding_dim)
            for proj in (lyr.q_proj, lyr.k_proj, lyr.v_proj):
                lecun_(proj.weight, c.qkv_proj_blocksize)
            for gate in (lyr.mlstm_cell.igate, lyr.mlstm_cell.fgate):
                lecun_(gate.weight, 3 * di)
            lyr.mlstm_cell.igate.bias.zero_()
            lyr.mlstm_cell.fgate.bias.fill_(3.0)
            lyr.mlstm_cell.outnorm.weight.fill_(1.0)
            lyr.learnable_skip.fill_(1.0)
            lecun_(lyr.proj_down.weight, di)
    model.layers.post_blocks_norm.weight.fill_(1.0)
    model.layers.post_blocks_norm.bias.zero_()
    head = model.fc if classifier else model.output_layer
    lecun_(head.weight, c.embedding_dim)
    head.bias.zero_()
    if classifier:
        model.output_layer.weight.zero_()
        model.output_layer.bias.zero_()
    return model
