"""bf16 training of the port's Transformer with the plain attention
(attention_impl 'xla') against the JAX package's TransformerLM built with
dtype=jnp.bfloat16 (tests/torch_bf16_common.py has the checks and their
tolerance, set from JAX's own bf16-against-f32 gap)."""
import jax.numpy as jnp
import torch

from tests import torch_bf16_common as C
from musicgen_tpu.config import TransformerConfig as JaxTransformerConfig
from musicgen_tpu.models.transformer import TransformerLM as JaxTransformerLM
from musicgen_tpu_torch.config import TransformerConfig
from musicgen_tpu_torch.models import transformer

KW = dict(n_embd=64, n_heads=2, n_layer=2, block_len=C.L, dropout=0.0, metadata_vocab_size=C.META,
          attention_impl="xla")


def test_transformer_bf16_matches_jax():
    jcfg, cfg = JaxTransformerConfig(**KW), TransformerConfig(**KW)
    params = C.random_params(JaxTransformerLM(jcfg))
    jax16 = C.jax_run(JaxTransformerLM(jcfg, dtype=jnp.bfloat16), params, cfg)
    C.check(jax16, C.port_run(transformer, cfg, params, torch.bfloat16),
            C.port_run(transformer, cfg, params, torch.float32))
