"""Model factory (port of musicgen_tpu/models/registry.py; reference
train.py:52-67 new_model/load_model): the port's one map from a model kind
to the module that builds and seeds it. The CLIs and `interop.load_model`
build every model through it.

    model = new_model("xlstm", DEFAULT_CONFIG, "cuda")  # empty, on the card
    init_model(model, "xlstm", seed=0)                  # random weights from the seed
"""
from __future__ import annotations

from types import ModuleType
from typing import Any

import torch

from ..config import (DEFAULT_CONFIG, ClassifierConfig, Config, MambaConfig, Seq2SeqConfig, TransformerConfig,
                      XLSTMConfig)
from . import mamba, seq2seq, transformer, xlstm

KINDS = ("mamba", "xlstm", "transformer")
# Each kind's module (its empty_model and init_weights_) and config type. The
# classifier is the xLSTM module's; seq2seq is the port's addition (the JAX
# registry builds no translator).
MODULES = {"mamba": mamba, "xlstm": xlstm, "transformer": transformer, "classifier": xlstm, "seq2seq": seq2seq}
CONFIGS = {"mamba": MambaConfig, "xlstm": XLSTMConfig, "transformer": TransformerConfig,
           "classifier": ClassifierConfig, "seq2seq": Seq2SeqConfig}


def _module(kind: str) -> ModuleType:
    if kind not in MODULES:
        raise ValueError(f"unknown model kind {kind!r}; choose from {KINDS + ('classifier', 'seq2seq')}")
    return MODULES[kind]


def new_model(kind: str, config: Any = DEFAULT_CONFIG, device: torch.device | str = "cuda",
              dtype: torch.dtype = torch.float32):
    """The uninitialised model of `kind` on `device`, computing in `dtype`
    (its parameters f32). `config` is a Config (its field named `kind` is
    taken) or the kind's own config."""
    module = _module(kind)
    cfg = getattr(config, kind) if isinstance(config, Config) else config
    if not isinstance(cfg, CONFIGS[kind]):
        raise TypeError(f"a {kind} model takes a {CONFIGS[kind].__name__}, not a {type(cfg).__name__}")
    return module.empty_model(cfg, device, dtype)


def init_model(model: torch.nn.Module, kind: str, seed: int = 0):
    """Fills `model` (of `kind`) with the family's random weights from
    `seed` (its init_weights_) and returns it: the counterpart of the JAX
    registry's init_params."""
    return _module(kind).init_weights_(model, seed)
