"""bf16 training of the port's Transformer through kernels D and E
(attention_impl 'flash'; their plain versions on CPU tensors) against the
JAX package's TransformerLM built with dtype=jnp.bfloat16 through its flash
kernels with their custom VJP, in interpret mode as the JAX package's own
tests run them. The f32 reference of the tolerance (tests/
torch_bf16_common.py) is the port's f32 model with the plain attention,
the exact f32 arithmetic both kernels approximate."""
import dataclasses
import functools

import jax.numpy as jnp
import torch

from tests import torch_bf16_common as C
from musicgen_tpu.config import TransformerConfig as JaxTransformerConfig
from musicgen_tpu.models.transformer import TransformerLM as JaxTransformerLM
from musicgen_tpu.ops import pallas_attention
from musicgen_tpu_torch.config import TransformerConfig
from musicgen_tpu_torch.models import transformer

KW = dict(n_embd=64, n_heads=2, n_layer=2, block_len=C.L, dropout=0.0, metadata_vocab_size=C.META,
          attention_impl="flash")


def test_transformer_flash_bf16_matches_jax(monkeypatch):
    monkeypatch.setattr(pallas_attention, "flash_relpos_attention_train",
                        functools.partial(pallas_attention.flash_relpos_attention_train, interpret=True))
    jm, cfg = JaxTransformerLM(JaxTransformerConfig(**KW), dtype=jnp.bfloat16), TransformerConfig(**KW)
    params = C.random_params(jm)
    C.check(C.jax_run(jm, params, cfg), C.port_run(transformer, cfg, params, torch.bfloat16),
            C.port_run(transformer, dataclasses.replace(cfg, attention_impl="xla"), params, torch.float32))
