"""The compute dtype of the port's models: flax's `dtype=` contract with f32
parameters, written out where flax makes its casts.

A model built with `dtype=torch.bfloat16` (cli.train --bf16) keeps f32
parameters and computes, as the JAX package's models built with
`dtype=jnp.bfloat16` do:

  * `dense`: nn.Dense(dtype=): input, weight and bias cast to the dtype, the
    output in the dtype;
  * `embed`: nn.Embed(dtype=): the looked-up rows cast to the dtype;
  * `layer_norm`: nn.LayerNorm(dtype=): statistics and affine in f32, the
    output cast to the dtype;
  * `conv`: nn.Conv(dtype=) (the diffusion UNet's): input, kernel and bias
    cast to the dtype, the output in the dtype;
  * everywhere else torch's promotion, which is jnp's for these operands: a
    bf16 tensor times an f32 tensor gives f32.

`torch.autocast` is not this contract: its LayerNorm returns f32 and it would
run the f32 lm_head in bf16. With the default f32 every helper calls the
module itself, so the f32 path keeps its bits (and forward hooks on the
nn.Linear, which ops/gptq's calibration uses, still fire).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Dense(dtype=dtype) on the nn.Linear's f32 parameters."""
    if layer.weight.dtype == dtype:
        return layer(x.to(dtype))
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Conv(dtype=dtype) on the nn.Conv2d's f32 parameters.

    On the CPU a bf16 convolution is computed from the bf16 operands in f32
    and rounded once, which is what torch's bf16 convolution computes (the
    same bits but for rare one-rounding differences): its CPU kernel returns
    non-finite values at random for a stride-2 3x3 convolution one output
    column wide (torch 2.13), a shape the diffusion UNet's Downsample
    reaches on narrow canvases."""
    if layer.weight.dtype == dtype:
        return layer(x.to(dtype))
    bias = None if layer.bias is None else layer.bias.to(dtype)
    if x.device.type == "cpu" and dtype == torch.bfloat16:
        f32 = torch.float32
        return layer._conv_forward(x.to(dtype).to(f32), layer.weight.to(dtype).to(f32),
                                   None if bias is None else bias.to(f32)).to(dtype)
    return layer._conv_forward(x.to(dtype), layer.weight.to(dtype), bias)


def embed(table: nn.Embedding, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Embed(dtype=dtype): the rows of the f32 table in `dtype`."""
    return table(ids).to(dtype)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax nn.LayerNorm(dtype=dtype): normalised in f32, returned in `dtype`."""
    return norm(x.to(torch.float32)).to(dtype)
