"""Guided-diffusion UNet in PyTorch, NCHW.

Port of musicgen_tpu/diffusion/unet.py (the reference's diffusion/unet.py:
ResBlock with FiLM scale-shift norm :159-274, AttentionBlock :277-399,
Up/Downsample :96-156, UNetModel :402-678, SuperResModel :681-696,
EncoderUNetModel :699-912; timestep_embedding diffusion/nn.py:119-137).
The JAX modules transpose to NHWC inside; these run in torch's native NCHW.

Parameters are f32; `dtype` is the compute dtype (models/compute.py: flax's
`nn.Conv(dtype=)` and `nn.Dense(dtype=)` casts), bf16 in the CLIs as in the
JAX package. Group norms run in f32 with min(32, C) groups and eps 1e-5,
their affine applied before the cast back; attention is two matmuls with an
f32 softmax cast to v's dtype, as JAX writes it.

Module and parameter names mirror the flax tree (`down_{level}_{i}`,
`down_attn_{level}_{i}`, `down_{level}_ds.op`, `mid_1`, `mid_attn`,
`up_{level}_{i}`, `up_{level}_us.conv`, ...; interop.diffusion_state_dict
maps flax params onto them). Where flax and torch differ:
  * a 3x3 stride-2 conv with padding "SAME" pads (ceil(n/2) - 1) * 2 + 3 - n
    rows, the odd one after: 0 before and 1 after on an even size, so
    Downsample pads explicitly (`same_pad`) and convolves unpadded;
  * a conv kernel (kh, kw, in, out) is torch's (out, in, kh, kw), a Dense
    kernel (in, out) torch's (out, in) weight;
  * the skip concat is [h, skip] on channels, qkv's channels split as
    (3, heads, dh).
`use_checkpoint` recomputes each ResBlock in the backward pass
(torch.utils.checkpoint, non-reentrant: flax nn.remat). Dropout runs only
with `deterministic=False`, which no caller passes, as in JAX.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..models.compute import conv, dense


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embeddings (reference nn.py:119-137)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(nn.GroupNorm):
    """GroupNorm in f32 whatever the compute dtype (flax params `scale`,
    `bias` as `weight`, `bias`)."""

    def __init__(self, channels: int):
        super().__init__(min(32, channels), channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.to(torch.float32), self.num_groups, self.weight, self.bias, self.eps).to(x.dtype)


def zero_init_conv(in_channels: int, out_channels: int, kernel: int) -> nn.Conv2d:
    """zero_module equivalent (reference nn.py): init_weights_ zeroes it."""
    layer = nn.Conv2d(in_channels, out_channels, kernel, padding=kernel // 2)
    layer.zero_init = True
    return layer


def same_pad(size: Tuple[int, int], kernel: int = 3, stride: int = 2) -> Tuple[int, int, int, int]:
    """F.pad's (left, right, top, bottom) for XLA's padding "SAME" on an
    (H, W) input: the odd row or column goes after."""
    pads = []
    for n in reversed(size):
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return tuple(pads)


class ResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, emb_channels: int, dropout: float,
                 use_scale_shift_norm: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout, self.use_scale_shift_norm, self.dtype = dropout, use_scale_shift_norm, dtype
        self.norm_in = GroupNorm32(in_channels)
        self.conv_in = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.emb = nn.Linear(emb_channels, 2 * out_channels if use_scale_shift_norm else out_channels)
        self.norm_out = GroupNorm32(out_channels)
        self.conv_out = zero_init_conv(out_channels, out_channels, 3)
        self.skip = nn.Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        h = conv(self.conv_in, F.silu(self.norm_in(x)), self.dtype)
        emb_out = dense(self.emb, F.silu(emb), self.dtype)[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = F.silu(self.norm_out(h) * (1 + scale) + shift)
        else:
            h = F.silu(self.norm_out(h + emb_out))
        h = F.dropout(h, self.dropout, training=not deterministic)
        h = conv(self.conv_out, h, self.dtype)
        if self.skip is not None:
            x = conv(self.skip, x, self.dtype)
        return x + h


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dh: int) -> torch.Tensor:
    """(B, T, heads, dh) each: softmax(q k^T / sqrt(dh)) v, the softmax in
    f32 cast to v's dtype."""
    attn = torch.einsum("bthd,bshd->bhts", q, k) * dh ** -0.5
    attn = torch.softmax(attn.to(torch.float32), dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", attn, v)


class AttentionBlock(nn.Module):
    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = channels // num_head_channels if num_head_channels != -1 else num_heads
        self.dtype = dtype
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv2d(channels, 3 * channels, 1)
        self.proj = zero_init_conv(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        dh = c // self.heads
        qkv = conv(self.qkv, self.norm(x), self.dtype).reshape(b, 3, self.heads, dh, h * w).permute(1, 0, 4, 2, 3)
        out = _attention(qkv[0], qkv[1], qkv[2], dh)  # (b, hw, heads, dh)
        out = out.permute(0, 2, 3, 1).reshape(b, c, h, w)
        return x + conv(self.proj, out, self.dtype)


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling (reference unet.py:37-66): prepend the
    spatial mean as a query token, add a learned positional embedding of
    (H * W + 1, C), one multi-head attention round, project, return the
    pooled (first) token. The spatial size is fixed at construction (flax
    reads it off the first input)."""

    def __init__(self, channels: int, spatial: int, num_head_channels: int, output_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dtype = channels // num_head_channels, dtype
        self.positional_embedding = nn.Parameter(torch.empty(spatial + 1, channels))
        self.qkv_proj = nn.Linear(channels, 3 * channels)
        self.c_proj = nn.Linear(channels, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        seq = x.flatten(2).transpose(1, 2)
        seq = torch.cat([seq.mean(dim=1, keepdim=True), seq], dim=1)
        seq = seq + self.positional_embedding[None].to(seq.dtype)
        t, dh = seq.shape[1], c // self.heads
        qkv = dense(self.qkv_proj, seq, self.dtype).reshape(b, t, 3, self.heads, dh)
        out = _attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dh).reshape(b, t, c)
        return dense(self.c_proj, out, self.dtype)[:, 0]


class Downsample(nn.Module):
    def __init__(self, channels: int, use_conv: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.op = nn.Conv2d(channels, channels, 3, stride=2) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.op is not None:
            return conv(self.op, F.pad(x, same_pad(x.shape[2:])), self.dtype)
        return F.avg_pool2d(x, 2)


class Upsample(nn.Module):
    def __init__(self, channels: int, use_conv: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(channels, channels, 3, padding=1) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return x if self.conv is None else conv(self.conv, x, self.dtype)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4  # piano-roll canvas planes
    model_channels: int = 128
    out_channels: int = 8  # 2x in_channels for LEARNED_RANGE
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (8, 16)  # downsample factors
    dropout: float = 0.0
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    num_heads: int = 4
    # heads = channels // num_head_channels when != -1 (reference unet.py:721)
    num_head_channels: int = -1
    # learned up/downsampling convs vs pooling/nearest (reference :717)
    conv_resample: bool = True
    # recompute ResBlocks in the backward pass (reference nn.py:140-186
    # CheckpointFunction): trade FLOPs for memory
    use_checkpoint: bool = False


class _Trunk(nn.Module):
    """The time embedding, input conv and encoder that UNetModel and
    EncoderUNetModel share; `chans` records each skip's channels."""

    def _build_encoder(self, c: UNetConfig, dtype: torch.dtype) -> int:
        mc, ed = c.model_channels, 4 * c.model_channels
        self.time1 = nn.Linear(mc, ed)
        self.time2 = nn.Linear(ed, ed)
        self.conv_in = nn.Conv2d(c.in_channels, mc, 3, padding=1)
        self.chans, ch, ds = [mc], mc, 1
        for level, mult in enumerate(c.channel_mult):
            for i in range(c.num_res_blocks):
                out = int(mult * mc)
                self.add_module(f"down_{level}_{i}", ResBlock(ch, out, ed, c.dropout, dtype=dtype))
                ch = out
                if ds in c.attention_resolutions:
                    self.add_module(f"down_attn_{level}_{i}",
                                    AttentionBlock(ch, c.num_heads, c.num_head_channels, dtype))
                self.chans.append(ch)
            if level != len(c.channel_mult) - 1:
                self.add_module(f"down_{level}_ds", Downsample(ch, c.conv_resample, dtype))
                self.chans.append(ch)
                ds *= 2
        self.mid_1 = ResBlock(ch, ch, ed, c.dropout, dtype=dtype)
        self.mid_attn = AttentionBlock(ch, c.num_heads, c.num_head_channels, dtype)
        self.mid_2 = ResBlock(ch, ch, ed, c.dropout, dtype=dtype)
        return ch

    def _res(self, name: str, h, emb, deterministic: bool):
        block = getattr(self, name)
        if self.cfg.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(block, h, emb, deterministic, use_reentrant=False)
        return block(h, emb, deterministic)

    def _time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        emb = dense(self.time1, timestep_embedding(t, self.cfg.model_channels), self.dtype)
        return dense(self.time2, F.silu(emb), self.dtype)

    def _encode(self, x: torch.Tensor, emb: torch.Tensor, deterministic: bool, hs: list):
        """Runs conv_in, the encoder and the middle; appends every skip (and,
        for the spatial pools, each stage's output) to `hs`."""
        c = self.cfg
        h = conv(self.conv_in, x.to(self.dtype), self.dtype)
        hs.append(h)
        ds = 1
        for level in range(len(c.channel_mult)):
            for i in range(c.num_res_blocks):
                h = self._res(f"down_{level}_{i}", h, emb, deterministic)
                if ds in c.attention_resolutions:
                    h = getattr(self, f"down_attn_{level}_{i}")(h)
                hs.append(h)
            if level != len(c.channel_mult) - 1:
                h = getattr(self, f"down_{level}_ds")(h)
                hs.append(h)
                ds *= 2
        h = self._res("mid_1", h, emb, deterministic)
        h = self.mid_attn(h)
        return self._res("mid_2", h, emb, deterministic), ds


class UNetModel(_Trunk):
    """Encoder-middle-decoder with skip concats (reference unet.py:402-678)."""

    def __init__(self, cfg: UNetConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        c, mc, ed = cfg, cfg.model_channels, 4 * cfg.model_channels
        ch = self._build_encoder(cfg, dtype)
        chans, ds = list(self.chans), 2 ** (len(c.channel_mult) - 1)
        for level, mult in reversed(list(enumerate(c.channel_mult))):
            for i in range(c.num_res_blocks + 1):
                out = int(mult * mc)
                self.add_module(f"up_{level}_{i}", ResBlock(ch + chans.pop(), out, ed, c.dropout, dtype=dtype))
                ch = out
                if ds in c.attention_resolutions:
                    self.add_module(f"up_attn_{level}_{i}", AttentionBlock(ch, c.num_heads, c.num_head_channels, dtype))
            if level != 0:
                self.add_module(f"up_{level}_us", Upsample(ch, c.conv_resample, dtype))
                ds //= 2
        self.norm_out = GroupNorm32(ch)
        self.conv_out = zero_init_conv(ch, c.out_channels, 3)

    def forward(self, x: torch.Tensor, t: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        """x: (B, C, H, W); t: (B,) integer timesteps. The output is in the
        compute dtype."""
        c = self.cfg
        emb = self._time_embedding(t)
        hs: list = []
        h, ds = self._encode(x, emb, deterministic, hs)
        for level in reversed(range(len(c.channel_mult))):
            for i in range(c.num_res_blocks + 1):
                h = self._res(f"up_{level}_{i}", torch.cat([h, hs.pop()], dim=1), emb, deterministic)
                if ds in c.attention_resolutions:
                    h = getattr(self, f"up_attn_{level}_{i}")(h)
            if level != 0:
                h = getattr(self, f"up_{level}_us")(h)
                ds //= 2
        return conv(self.conv_out, F.silu(self.norm_out(h)), self.dtype)


class SuperResModel(nn.Module):
    """Low-res conditioned UNet (reference unet.py:681-696): the low-res
    input, upsampled bilinearly to x's size, is concatenated on the channel
    axis. `low_res_channels` defaults to cfg.in_channels, as the
    reference's doubled in_channels."""

    def __init__(self, cfg: UNetConfig, dtype: torch.dtype = torch.float32, low_res_channels: int | None = None):
        super().__init__()
        low = cfg.in_channels if low_res_channels is None else low_res_channels
        self.unet = UNetModel(dataclasses.replace(cfg, in_channels=cfg.in_channels + low), dtype)

    def forward(self, x, t, low_res, deterministic: bool = True):
        up = F.interpolate(low_res, size=tuple(x.shape[2:]), mode="bilinear", align_corners=False)
        return self.unet(torch.cat([x, up], dim=1), t, deterministic)


class EncoderUNetModel(_Trunk):
    """Encoder-half classifier trunk with pooling (reference unet.py:699-912).

    pool variants (reference :841-871):
      'adaptive'   — norm, silu, global avg pool, zero-init projection
      'attention'  — norm, silu, AttentionPool2d (requires num_head_channels
                     and the input's (H, W) as `input_size`)
      'spatial'    — concat per-stage spatial means -> Linear 2048 -> ReLU
      'spatial_v2' — same but with GroupNorm + SiLU between the Linears
    """

    def __init__(self, cfg: UNetConfig, num_classes: int = 1000, pool: str = "adaptive",
                 dtype: torch.dtype = torch.float32, input_size: Tuple[int, int] | None = None):
        super().__init__()
        self.cfg, self.pool, self.dtype = cfg, pool, dtype
        ch = self._build_encoder(cfg, dtype)
        if pool == "adaptive":
            self.norm_out = GroupNorm32(ch)
            self.out = nn.Linear(ch, num_classes)
            self.out.zero_init = True
        elif pool == "attention":
            assert cfg.num_head_channels != -1, "attention pool needs num_head_channels"
            assert input_size is not None, "attention pool needs the input's (H, W)"
            self.norm_out = GroupNorm32(ch)
            h, w = input_size
            for _ in range(len(cfg.channel_mult) - 1):
                h, w = (-(-h // 2), -(-w // 2)) if cfg.conv_resample else (h // 2, w // 2)
            self.attn_pool = AttentionPool2d(ch, h * w, cfg.num_head_channels, num_classes, dtype)
        elif pool in ("spatial", "spatial_v2"):
            self.out1 = nn.Linear(sum(self.chans) + ch, 2048)
            if pool == "spatial_v2":
                self.out_norm_scale = nn.Parameter(torch.empty(2048))
                self.out_norm_bias = nn.Parameter(torch.empty(2048))
            self.out2 = nn.Linear(2048, num_classes)
        else:
            raise NotImplementedError(f"Unexpected {pool} pooling")

    def forward(self, x: torch.Tensor, t: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        emb = self._time_embedding(t)
        stages: list = []
        h, _ = self._encode(x, emb, deterministic, stages)
        if self.pool == "adaptive":
            pooled = torch.mean(F.silu(self.norm_out(h)), dim=(2, 3))
            return dense(self.out, pooled, torch.float32)
        if self.pool == "attention":
            return self.attn_pool(F.silu(self.norm_out(h))).to(torch.float32)
        feats = torch.cat([s.to(torch.float32).mean(dim=(2, 3)) for s in stages + [h]], dim=-1)
        z = dense(self.out1, feats, torch.float32)
        if self.pool == "spatial_v2":
            z = F.silu(F.group_norm(z, 32, self.out_norm_scale, self.out_norm_bias, 1e-5))
        else:
            z = F.relu(z)
        return dense(self.out2, z, torch.float32)


def channel_mult_for_size(image_size: int) -> Tuple[float, ...]:
    """Reference script_util.py:169-184 table."""
    if image_size == 512:
        return (0.5, 1, 1, 2, 2, 4, 4)
    if image_size == 256:
        return (1, 1, 2, 2, 4, 4)
    if image_size == 128:
        return (1, 1, 2, 3, 4)
    if image_size == 64:
        return (1, 2, 3, 4)
    raise ValueError(f"unsupported image size: {image_size}")


def empty_model(module: type, device: torch.device | str, *args, **kwargs) -> nn.Module:
    """An uninitialised `module(*args, **kwargs)` (UNetModel, SuperResModel
    or EncoderUNetModel) on `device`, built on the meta device."""
    with torch.device("meta"):
        model = module(*args, **kwargs)
    return model.to_empty(device=device)


@torch.no_grad()
def init_weights_(model: nn.Module, seed: int) -> nn.Module:
    """Random weights from `seed`, drawn on the CPU, at flax's initializers:
    lecun-normal conv and dense kernels (a normal truncated at two standard
    deviations, of variance 1/fan_in), zero biases, the zero-initialised
    output convs (and the adaptive pool's projection) zero, unit norm
    scales, the attention pool's positional embedding N(0, 1/C). At these
    weights the UNet's output is exactly 0, as at flax's init."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            if getattr(m, "zero_init", False):
                m.weight.zero_()
            else:
                fan_in = m.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
                m.weight.copy_(w)
            m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, AttentionPool2d):
            c = m.positional_embedding.shape[1]
            m.positional_embedding.copy_(torch.randn(m.positional_embedding.shape, generator=gen) * c ** -0.5)
        elif isinstance(m, EncoderUNetModel) and m.pool == "spatial_v2":
            m.out_norm_scale.fill_(1.0)
            m.out_norm_bias.zero_()
    return model
