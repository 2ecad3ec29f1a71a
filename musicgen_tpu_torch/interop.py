"""Weight bridge: reference-layout `.pth` files and JAX params -> the port.

The port's models use the reference's torch `state_dict` layouts: mamba_ssm's
for MambaLM, models/transformer/model_transformer.py's (per-head
`sa.heads.{h}.{query,key,value}` Linears and `rel_pos_emb`) for
TransformerLM, and NX-AI xLSTMBlockStack's for XLSTMLM. This module holds the
port's own copy of the mapping from the JAX package's flax params to those
layouts (the bodies of `export_mamba` and `export_transformer` in
musicgen_tpu/interop/torch_import.py, and the transpose of its
`_import_mlstm_block` / `_import_slstm_block`); the port imports nothing of
the JAX package.

xLSTM shapes. The port saves the NX-AI key names and shapes
(`layers.blocks.{i}.xlstm.proj_up.weight` (2 di, d), `q_proj.weight`
(nb, bs, bs) as (out, in) blocks, `mlstm_cell.igate.weight` (H, 3 di),
`slstm_cell._recurrent_kernel_` (H, dh, 4, dh), `slstm_cell._bias_`
(H, 4, dh), ...) with two differences, both of which the loader also reads
in NX-AI's form: the four sLSTM input gates `{i,f,z,o}gate.weight` are full
(d, d) Linears, as the JAX model trains them (an NX-AI head-wise (H, dh, dh)
weight is expanded block-diagonally at load), and the LayerNorms keep their
bias (`xlstm_norm.bias`, `ffn_norm.bias`, `post_blocks_norm.bias`; NX-AI's
have none, which loads as zeros, as do absent FFN biases). So:
  * `from_jax_params(variables, cfg)` turns JAX variables (numpy leaves) into
    the port's weights, dispatching on the config's type;
  * `load_checkpoint` reads a `.pth` in either layout (the reference's own
    files, or one saved from the port);
  * `config_from_state_dict` reads the model's family and shape off the
    weights, so a checkpoint of any width loads without a config file.

The composer classifier's `.pth` (reference models/classifier/model.py;
musicgen_tpu/interop/torch_import.py import_classifier / export_classifier)
holds `token_embedding`, the stack under `layers.`, `fc` and no
`metadata_embedding`, plus the reference's dead `output_layer` Linear,
which the loader discards (zeros in its place) and the port writes as
zeros, so that a reference Classifier loads the port's file strict=True.

The diffusion UNets (`diffusion/unet.py` UNetModel, SuperResModel,
EncoderUNetModel) keep the flax tree's own layout: each module path of the
flax params, joined by dots, is the port's (`down_{level}_{i}.conv_in`,
`down_attn_{level}_{i}.qkv`, `down_{level}_ds.op`, `mid_1`, `mid_attn`,
`up_{level}_{i}.skip`, `up_{level}_us.conv`, `norm_out`, `conv_out`;
SuperResModel's under `unet.`; the encoder's `out`, `out1`, `out2`,
`out_norm_scale`, `attn_pool.positional_embedding`), and
`diffusion_state_dict` renames only the leaves: a conv `kernel` (kh, kw,
in, out) becomes `weight` (out, in, kh, kw), a Dense `kernel` (in, out)
`weight` (out, in), a GroupNorm `scale` `weight`; biases and the other
parameters keep their names and shapes. The reference's guided-diffusion
layout is not read: the reference never trained this UNet (its
`training_losses` is missing), so no checkpoint exists in it.
`cli.train_diffusion` writes `{"params": state_dict, "ema": state_dict}`
as `<ckpt>/diffusion.pth` (DIFFUSION_FILE), which `cli.inpaint` reads; it
is not a `model.pth`, so `load_checkpoint` never takes it for an LM.

The seq2seq translator (`models/seq2seq.py`) has no torch layout in the JAX
package and no reference checkpoint, so its keys are the port's own and no
`.pth` loader reads it: `seq2seq_state_dict` maps the flax tree, `enc_{i}`
/ `dec_{i}` as `enc_blocks.{i}` / `dec_blocks.{i}`, `TutorialLayerNorm_0`
as `norm`, a Dense `kernel` (in, out) as `weight` (out, in), a
DenseGeneral's (D, H, Dh) kernel as a (H*Dh, D) `weight` and its (H, Dh)
bias flat, an Embed's `embedding` as `weight`; `scale` and `shift` keep
their names.
"""
from __future__ import annotations

from typing import Any, Dict

import os
import re

import numpy as np
import torch

from .config import NUM_META, ClassifierConfig, MambaConfig, TransformerConfig, XLSTMConfig

StateDict = Dict[str, torch.Tensor]
MODEL_FILE = "model.pth"  # a checkpoint directory's weights (train/trainer.save_checkpoint)
DIFFUSION_FILE = "diffusion.pth"  # a diffusion checkpoint directory's {params, ema} (cli.train_diffusion)


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


def _ln(tb: str, lnp: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {tb + "weight": np.asarray(lnp["scale"]), tb + "bias": np.asarray(lnp["bias"])}


def _stack_state_dict(stack: Dict[str, Any], cfg: XLSTMConfig) -> Dict[str, np.ndarray]:
    """flax XLSTMStack params -> the port's `layers.` keys (the module
    docstring): torch (out, in) matrices, conv taps (C, 1, K), blockwise
    kernels (nb, out, in), full (d, d) sLSTM input gates."""
    sd = _ln("layers.post_blocks_norm.", stack["post_norm"])
    for i in range(cfg.num_blocks):
        blk, tb = stack[f"block_{i}"], f"layers.blocks.{i}."
        x = tb + "xlstm."
        sd.update(_ln(tb + "xlstm_norm.", blk["ln"]))
        lyr = blk["slstm"] if i in cfg.slstm_at else blk["mlstm"]
        sd[x + "conv1d.conv.weight"] = np.asarray(lyr["conv_w"]).T[:, None, :]
        sd[x + "conv1d.conv.bias"] = np.asarray(lyr["conv_b"])
        if i in cfg.slstm_at:
            for gate, name in (("w_i", "igate"), ("w_f", "fgate"), ("w_z", "zgate"), ("w_o", "ogate")):
                sd[x + name + ".weight"] = np.asarray(lyr[gate]["kernel"]).T
            sd[x + "slstm_cell._recurrent_kernel_"] = np.transpose(np.asarray(lyr["r_kernel"]), (1, 2, 0, 3))
            sd[x + "slstm_cell._bias_"] = np.transpose(np.asarray(lyr["bias"]), (1, 0, 2))
            sd[x + "group_norm.weight"] = np.asarray(lyr["gn_scale"])
            sd.update(_ln(tb + "ffn_norm.", blk["ln_ffn"]))
            for proj in ("up", "down"):
                sd[tb + f"ffn.proj_{proj}.weight"] = np.asarray(blk["ffn"][proj]["kernel"]).T
                sd[tb + f"ffn.proj_{proj}.bias"] = np.asarray(blk["ffn"][proj]["bias"])
        else:
            sd[x + "proj_up.weight"] = np.asarray(lyr["up_proj"]["kernel"]).T
            for proj in ("q", "k", "v"):
                sd[x + f"{proj}_proj.weight"] = np.transpose(np.asarray(lyr[proj]["kernel"]), (0, 2, 1))
            for gate in ("igate", "fgate"):
                sd[x + f"mlstm_cell.{gate}.weight"] = np.asarray(lyr[gate]["kernel"]).T
                sd[x + f"mlstm_cell.{gate}.bias"] = np.asarray(lyr[gate]["bias"])
            sd[x + "mlstm_cell.outnorm.weight"] = np.asarray(lyr["outnorm_scale"])
            sd[x + "learnable_skip"] = np.asarray(lyr["learnable_skip"])
            sd[x + "proj_down.weight"] = np.asarray(lyr["down_proj"]["kernel"]).T
    return sd


def _xlstm_state_dict(p: Dict[str, Any], cfg: XLSTMConfig) -> Dict[str, np.ndarray]:
    """flax XLSTMLM params -> the port's xLSTM layout, vocab padding dropped."""
    v = cfg.vocab_size
    return {
        "token_embedding.weight": np.asarray(p["token_embedding"]["embedding"])[:v],
        "metadata_embedding.weight": np.asarray(p["metadata_embedding"]["embedding"]),
        "output_layer.weight": np.asarray(p["lm_head"]["kernel"]).T[:v],
        "output_layer.bias": np.asarray(p["lm_head"]["bias"])[:v],
        **_stack_state_dict(p["stack"], cfg),
    }


def _classifier_state_dict(p: Dict[str, Any], cfg: ClassifierConfig) -> Dict[str, np.ndarray]:
    """flax XLSTMClassifier params -> the port's classifier layout: the
    stack as the LM's, `fc`, vocab padding dropped, and a zero
    `output_layer` (torch_import.export_classifier's, with the port's full
    sLSTM gates and LayerNorm biases)."""
    v, d = cfg.vocab_size, cfg.embedding_dim
    return {
        "token_embedding.weight": np.asarray(p["token_embedding"]["embedding"])[:v],
        "fc.weight": np.asarray(p["fc"]["kernel"]).T,
        "fc.bias": np.asarray(p["fc"]["bias"]),
        "output_layer.weight": np.zeros((v, d), np.float32),
        "output_layer.bias": np.zeros((v,), np.float32),
        **_stack_state_dict(p["stack"], cfg.stack),
    }


AnyConfig = MambaConfig | TransformerConfig | XLSTMConfig | ClassifierConfig


def from_jax_params(variables: Any, cfg: AnyConfig) -> StateDict:
    """JAX model variables ({'params': ...}, numpy leaves) -> port state dict,
    by the family of `cfg` (the port's MambaConfig, TransformerConfig,
    XLSTMConfig or ClassifierConfig)."""
    if isinstance(cfg, MambaConfig):
        sd = _mamba_state_dict(variables["params"], cfg)
    elif isinstance(cfg, TransformerConfig):
        sd = _transformer_state_dict(variables["params"], cfg)
    elif isinstance(cfg, XLSTMConfig):
        sd = _xlstm_state_dict(variables["params"], cfg)
    elif isinstance(cfg, ClassifierConfig):
        sd = _classifier_state_dict(variables["params"], cfg)
    else:
        raise TypeError(f"from_jax_params takes the port's MambaConfig, TransformerConfig, XLSTMConfig or "
                        f"ClassifierConfig, got {type(cfg)}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def diffusion_state_dict(variables: Any) -> StateDict:
    """Flax params of a diffusion UNet ({'params': ...} or the params tree,
    numpy leaves) -> the port's state dict of the same module (the layout in
    the module docstring)."""
    sd: StateDict = {}

    def walk(tree: Any, prefix: str) -> None:
        for name, leaf in tree.items():
            if hasattr(leaf, "items"):
                walk(leaf, f"{prefix}{name}.")
                continue
            a = np.asarray(leaf)
            if name == "kernel":
                name, a = "weight", a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            elif name == "scale":
                name = "weight"
            sd[prefix + name] = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))

    walk(variables["params"] if "params" in variables else variables, "")
    return sd


def seq2seq_state_dict(variables: Any) -> StateDict:
    """Flax Seq2SeqTransformer params ({'params': ...} or the params tree,
    numpy leaves) -> the port's models/seq2seq state dict (the layout in the
    module docstring)."""
    sd: StateDict = {}

    def walk(tree: Any, prefix: str) -> None:
        for name, leaf in tree.items():
            if hasattr(leaf, "items"):
                block = re.fullmatch(r"(enc|dec)_(\d+)", name)
                name = f"{block[1]}_blocks.{block[2]}" if block else "norm" if name == "TutorialLayerNorm_0" else name
                walk(leaf, f"{prefix}{name}.")
                continue
            a = np.asarray(leaf)
            if name == "kernel":
                name, a = "weight", a.reshape(a.shape[0], -1).T
            elif name == "bias":
                a = a.reshape(-1)
            elif name == "embedding":
                name = "weight"
            sd[prefix + name] = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))

    walk(variables["params"] if "params" in variables else variables, "")
    return sd


def load_checkpoint(path: str) -> StateDict:
    """A `.pth` state dict in reference layout, or a checkpoint directory's
    `model.pth` (DDP's 'module.' prefix dropped, and the reference
    Transformer's `.tril` mask buffers, which are derived data, as
    musicgen_tpu/interop/torch_import.py:139 drops them)."""
    if os.path.isdir(path):
        path = os.path.join(path, MODEL_FILE)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k.removeprefix("module."): v for k, v in sd.items() if not k.endswith(".tril")}


def _indices(sd: StateDict, prefix: str, pos: int) -> int:
    return len({k.split(".")[pos] for k in sd if k.startswith(prefix)})


def _is_xlstm(sd: StateDict) -> bool:
    return "layers.post_blocks_norm.weight" in sd or any(k.startswith("layers.blocks.") for k in sd)


def _is_classifier(sd: StateDict) -> bool:
    return "fc.weight" in sd and "metadata_embedding.weight" not in sd


def _xlstm_config(sd: StateDict) -> XLSTMConfig | ClassifierConfig:
    """XLSTMConfig (ClassifierConfig for a classifier's `fc`) from
    NX-AI-layout shapes: slstm_at from the blocks that hold an
    `slstm_cell`, num_heads from `_recurrent_kernel_` (or
    `mlstm_cell.igate.weight`), the qkv blocksize from `q_proj.weight`."""
    vocab, d = sd["token_embedding.weight"].shape
    n_blocks = _indices(sd, "layers.blocks.", 2)
    slstm_at = tuple(i for i in range(n_blocks) if f"layers.blocks.{i}.xlstm.slstm_cell._recurrent_kernel_" in sd)
    mlstm = [i for i in range(n_blocks) if i not in slstm_at]
    default = XLSTMConfig()
    kw: Dict[str, Any] = {}
    if slstm_at:
        x = f"layers.blocks.{slstm_at[0]}."
        kw["num_heads"] = sd[x + "xlstm.slstm_cell._recurrent_kernel_"].shape[0]
        ff = sd[x + "ffn.proj_up.weight"].shape[0]
        if ff != int(default.slstm_ff_proj_factor * d):
            kw["slstm_ff_proj_factor"] = ff / d
    if mlstm:
        x = f"layers.blocks.{mlstm[0]}.xlstm."
        kw.setdefault("num_heads", sd[x + "mlstm_cell.igate.weight"].shape[0])
        kw["qkv_proj_blocksize"] = sd[x + "q_proj.weight"].shape[1]
        kw["mlstm_proj_factor"] = sd[x + "proj_up.weight"].shape[0] / 2 / d
    classifier = _is_classifier(sd)
    return (ClassifierConfig if classifier else XLSTMConfig)(
        embedding_dim=d,
        num_blocks=n_blocks,
        slstm_at=slstm_at,
        conv1d_kernel_size=sd["layers.blocks.0.xlstm.conv1d.conv.weight"].shape[2],
        vocab_size=vocab,
        metadata_vocab_size=sd["fc.weight" if classifier else "metadata_embedding.weight"].shape[0],
        **kw,
    )


def xlstm_state_dict(sd: StateDict, cfg: XLSTMConfig | ClassifierConfig) -> StateDict:
    """An xLSTM (or classifier) state dict in the port's form: NX-AI
    head-wise (H, dh, dh) sLSTM input gates expanded block-diagonally to
    (d, d) (the head-wise map is x.reshape(H, dh) @ W_h^T per head), absent
    LayerNorm and FFN biases filled with zeros, and a classifier's dead
    `output_layer` discarded (zeros in its place)."""
    out = dict(sd)
    d, nh = cfg.embedding_dim, cfg.num_heads
    if isinstance(cfg, ClassifierConfig):
        out["output_layer.weight"] = torch.zeros(cfg.vocab_size, d)
        out["output_layer.bias"] = torch.zeros(cfg.vocab_size)
        cfg = cfg.stack

    def zeros_if_absent(key: str, n: int) -> None:
        if key not in out:
            out[key] = torch.zeros(n)

    zeros_if_absent("layers.post_blocks_norm.bias", d)
    for i in range(cfg.num_blocks):
        tb = f"layers.blocks.{i}."
        zeros_if_absent(tb + "xlstm_norm.bias", d)
        if i not in cfg.slstm_at:
            continue
        for gate in ("igate", "fgate", "zgate", "ogate"):
            key = tb + f"xlstm.{gate}.weight"
            w = out[key]
            if w.dim() == 3 and tuple(w.shape) == (nh, d // nh, d // nh):
                out[key] = torch.block_diag(*w)
        zeros_if_absent(tb + "ffn_norm.bias", d)
        zeros_if_absent(tb + "ffn.proj_up.bias", cfg.ffn_inner)
        zeros_if_absent(tb + "ffn.proj_down.bias", d)
    return out


def config_from_state_dict(sd: StateDict) -> AnyConfig:
    """The config whose shapes the weights have: a TransformerConfig for the
    reference Transformer's layout (n_layer from `blocks.*`, n_heads from
    `sa.heads.*`, block_len = rel_pos_emb rows - 6), an XLSTMConfig for the
    NX-AI layout (`layers.blocks.*`) or a ClassifierConfig where it has
    `fc` and no `metadata_embedding`, else a MambaConfig (ngroups = 1). An
    xLSTM `.pth` shares `token_embedding.weight` with Mamba, so it is told
    apart before the Mamba fallback."""
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
    if _is_xlstm(sd):
        return _xlstm_config(sd)
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


def family(cfg) -> str:
    """'mamba', 'transformer', 'xlstm' or 'classifier', by the config's type."""
    if isinstance(cfg, TransformerConfig):
        return "transformer"
    if isinstance(cfg, ClassifierConfig):
        return "classifier"
    return "xlstm" if isinstance(cfg, XLSTMConfig) else "mamba"


def load_model(sd: StateDict, device: torch.device | str):
    """The MambaLM, TransformerLM, XLSTMLM or XLSTMClassifier on `device`
    holding `sd` (every key and shape checked)."""
    from .models.registry import new_model

    cfg = config_from_state_dict(sd)
    if isinstance(cfg, (XLSTMConfig, ClassifierConfig)):
        sd = xlstm_state_dict(sd, cfg)
    model = new_model(family(cfg), cfg, device)
    model.load_state_dict(sd, strict=True)
    return model.eval()
