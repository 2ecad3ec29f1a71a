"""Weight bridge: reference-layout `.pth` files and JAX params -> the port.

The port's models use the reference's torch `state_dict` layouts: mamba_ssm's
for MambaLM, and models/transformer/model_transformer.py's (per-head
`sa.heads.{h}.{query,key,value}` Linears and `rel_pos_emb`) for
TransformerLM. This module holds the port's own copy of the mapping from the
JAX package's flax params to those layouts (the bodies of `export_mamba` and
`export_transformer` in musicgen_tpu/interop/torch_import.py); the port
imports nothing of the JAX package. So:
  * `from_jax_params(variables, cfg)` turns JAX variables (numpy leaves) into
    the port's weights, dispatching on the config's type;
  * `load_checkpoint` reads a `.pth` in either layout (the reference's own
    files, or one saved from the port);
  * `config_from_state_dict` reads the model's family and shape off the
    weights, so a checkpoint of any width loads without a config file.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .config import NUM_META, MambaConfig, TransformerConfig

StateDict = Dict[str, torch.Tensor]


def _mamba_state_dict(p: Dict[str, Any], cfg: MambaConfig) -> Dict[str, np.ndarray]:
    """flax MambaLM params -> mamba_ssm layout (torch_import.export_mamba)."""
    v = cfg.vocab_size
    sd = {
        "token_embedding.weight": np.asarray(p["token_embedding"]["embedding"])[:v],
        "metadata_embedding.weight": np.asarray(p["metadata_embedding"]["embedding"]),
        "norm.weight": np.asarray(p["norm"]["scale"]),
        "norm.bias": np.asarray(p["norm"]["bias"]),
        "output_layer.weight": np.asarray(p["lm_head"]["kernel"]).T[:v],
        "output_layer.bias": np.asarray(p["lm_head"]["bias"])[:v],
    }
    for i in range(cfg.n_layers):
        lyr, tb = p[f"layer_{i}"], f"layers.{i}."
        sd[tb + "in_proj.weight"] = np.asarray(lyr["in_proj"]["kernel"]).T
        sd[tb + "conv1d.weight"] = np.asarray(lyr["conv_w"]).T[:, None, :]
        sd[tb + "conv1d.bias"] = np.asarray(lyr["conv_b"])
        sd[tb + "dt_bias"] = np.asarray(lyr["dt_bias"])
        sd[tb + "A_log"] = np.asarray(lyr["A_log"])
        sd[tb + "D"] = np.asarray(lyr["D"])
        sd[tb + "norm.weight"] = np.asarray(lyr["norm_weight"])
        sd[tb + "out_proj.weight"] = np.asarray(lyr["out_proj"]["kernel"]).T
    return sd


def _transformer_state_dict(p: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    """flax TransformerLM params -> the reference Transformer's layout
    (torch_import.export_transformer): the fused q/k/v kernels split into
    per-head (hd, d) Linears, rel_pos_emb per head, vocab padding dropped,
    no `.tril` buffers."""
    d, hd, v = cfg.n_embd, cfg.n_embd // cfg.n_heads, cfg.vocab_size
    sd = {
        "token_embedding_table.weight": np.asarray(p["token_embedding"]["embedding"])[:v],
        "metadata_embedding_table.weight": np.asarray(p["metadata_embedding"]["embedding"]),
        "ln_f.weight": np.asarray(p["ln_f"]["scale"]),
        "ln_f.bias": np.asarray(p["ln_f"]["bias"]),
        "lm_head.weight": np.asarray(p["lm_head"]["kernel"]).T[:v],
        "lm_head.bias": np.asarray(p["lm_head"]["bias"])[:v],
    }
    for i in range(cfg.n_layer):
        blk, tb = p[f"block_{i}"], f"blocks.{i}."
        for ln in ("ln1", "ln2"):
            sd[tb + f"{ln}.weight"] = np.asarray(blk[ln]["scale"])
            sd[tb + f"{ln}.bias"] = np.asarray(blk[ln]["bias"])
        for proj, tname in (("q", "query"), ("k", "key"), ("v", "value")):
            kern = np.asarray(blk["attn"][proj]["kernel"])  # (d, d)
            for h in range(cfg.n_heads):
                sd[tb + f"sa.heads.{h}.{tname}.weight"] = kern[:, h * hd:(h + 1) * hd].T
        rel = np.asarray(blk["attn"]["rel_pos_emb"])
        for h in range(cfg.n_heads):
            sd[tb + f"sa.heads.{h}.rel_pos_emb"] = rel[h]
        sd[tb + "sa.proj.weight"] = np.asarray(blk["attn"]["proj"]["kernel"]).T
        sd[tb + "sa.proj.bias"] = np.asarray(blk["attn"]["proj"]["bias"])
        sd[tb + "ffwd.net.0.weight"] = np.asarray(blk["mlp"]["fc"]["kernel"]).T
        sd[tb + "ffwd.net.0.bias"] = np.asarray(blk["mlp"]["fc"]["bias"])
        sd[tb + "ffwd.net.2.weight"] = np.asarray(blk["mlp"]["out"]["kernel"]).T
        sd[tb + "ffwd.net.2.bias"] = np.asarray(blk["mlp"]["out"]["bias"])
    return sd


def from_jax_params(variables: Any, cfg: MambaConfig | TransformerConfig) -> StateDict:
    """JAX model variables ({'params': ...}, numpy leaves) -> port state dict,
    by the family of `cfg` (the port's MambaConfig or TransformerConfig)."""
    if isinstance(cfg, MambaConfig):
        sd = _mamba_state_dict(variables["params"], cfg)
    elif isinstance(cfg, TransformerConfig):
        sd = _transformer_state_dict(variables["params"], cfg)
    else:
        raise TypeError(f"from_jax_params takes the port's MambaConfig or TransformerConfig, got {type(cfg)}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def load_checkpoint(path: str) -> StateDict:
    """A `.pth` state dict in reference layout (DDP's 'module.' prefix
    dropped, and the reference Transformer's `.tril` mask buffers, which are
    derived data, as musicgen_tpu/interop/torch_import.py:139 drops them)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k.removeprefix("module."): v for k, v in sd.items() if not k.endswith(".tril")}


def _indices(sd: StateDict, prefix: str, pos: int) -> int:
    return len({k.split(".")[pos] for k in sd if k.startswith(prefix)})


def config_from_state_dict(sd: StateDict) -> MambaConfig | TransformerConfig:
    """The config whose shapes the weights have: a TransformerConfig for the
    reference Transformer's layout (n_layer from `blocks.*`, n_heads from
    `sa.heads.*`, block_len = rel_pos_emb rows - 6), else a MambaConfig
    (ngroups = 1)."""
    if "token_embedding_table.weight" in sd:
        vocab, d = sd["token_embedding_table.weight"].shape
        return TransformerConfig(
            n_embd=d,
            n_heads=_indices(sd, "blocks.0.sa.heads.", 4),
            n_layer=_indices(sd, "blocks.", 1),
            block_len=sd["blocks.0.sa.heads.0.rel_pos_emb"].shape[0] - NUM_META,
            vocab_size=vocab,
            metadata_vocab_size=sd["metadata_embedding_table.weight"].shape[0],
        )
    vocab, d_model = sd["token_embedding.weight"].shape
    nheads = sd["layers.0.A_log"].shape[0]
    d_inner = sd["layers.0.norm.weight"].shape[0]
    conv_dim, _, d_conv = sd["layers.0.conv1d.weight"].shape
    return MambaConfig(
        d_model=d_model,
        n_layers=_indices(sd, "layers.", 1),
        d_state=(conv_dim - d_inner) // 2,
        d_conv=d_conv,
        expand=d_inner // d_model,
        headdim=d_inner // nheads,
        ngroups=1,
        vocab_size=vocab,
        metadata_vocab_size=sd["metadata_embedding.weight"].shape[0],
    )


def load_model(sd: StateDict, device: torch.device | str):
    """The MambaLM or TransformerLM on `device` holding `sd` (every key and
    shape checked)."""
    cfg = config_from_state_dict(sd)
    if isinstance(cfg, TransformerConfig):
        from .models.transformer import empty_model
    else:
        from .models.mamba import empty_model
    model = empty_model(cfg, device)
    model.load_state_dict(sd, strict=True)
    return model.eval()
