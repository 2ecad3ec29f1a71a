"""Weight bridge: reference-layout `.pth` files and JAX params -> the port.

The port's MambaLM uses the reference's mamba_ssm `state_dict` layout, which
musicgen_tpu/interop/torch_import.py (numpy only) already maps to and from
the JAX package's flax params. So:
  * `from_jax_params` turns JAX variables (as numpy) into the port's weights
    through `export_state_dict("mamba", ...)`;
  * `load_checkpoint` reads a `.pth` in that layout (the reference's own
    files, or one saved from the port);
  * `config_from_state_dict` reads the model's shape off the weights, so a
    checkpoint of any width loads without a config file.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from musicgen_tpu.interop.torch_import import export_state_dict

from .config import MambaConfig
from .models.mamba import MambaLM, empty_model

StateDict = Dict[str, torch.Tensor]


def from_jax_params(variables: Any, cfg: MambaConfig) -> StateDict:
    """JAX MambaLM variables ({'params': ...}, numpy leaves) -> port state dict."""
    sd = export_state_dict("mamba", variables, cfg)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def load_checkpoint(path: str) -> StateDict:
    """A `.pth` state dict in reference layout (DDP's 'module.' prefix dropped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k.removeprefix("module."): v for k, v in sd.items()}


def config_from_state_dict(sd: StateDict, base: MambaConfig = MambaConfig()) -> MambaConfig:
    """The MambaConfig whose shapes the weights have (ngroups = 1)."""
    vocab, d_model = sd["token_embedding.weight"].shape
    n_layers = len({k.split(".")[1] for k in sd if k.startswith("layers.")})
    nheads = sd["layers.0.A_log"].shape[0]
    d_inner = sd["layers.0.norm.weight"].shape[0]
    conv_dim, _, d_conv = sd["layers.0.conv1d.weight"].shape
    return dataclasses.replace(
        base,
        d_model=d_model,
        n_layers=n_layers,
        d_state=(conv_dim - d_inner) // 2,
        d_conv=d_conv,
        expand=d_inner // d_model,
        headdim=d_inner // nheads,
        ngroups=1,
        vocab_size=vocab,
        metadata_vocab_size=sd["metadata_embedding.weight"].shape[0],
    )


def load_model(sd: StateDict, device: torch.device | str) -> MambaLM:
    """A MambaLM on `device` holding `sd` (every key and shape checked)."""
    model = empty_model(config_from_state_dict(sd), device)
    model.load_state_dict(sd, strict=True)
    return model.eval()
