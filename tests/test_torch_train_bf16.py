"""bf16 training of the port's Mamba model against the JAX package's Mamba
built with dtype=jnp.bfloat16 (tests/torch_bf16_common.py has the checks
and their tolerance, set from JAX's own bf16-against-f32 gap)."""
import jax.numpy as jnp
import torch

from tests import torch_bf16_common as C
from musicgen_tpu.config import MambaConfig as JaxMambaConfig
from musicgen_tpu.models.mamba import MambaLM as JaxMambaLM
from musicgen_tpu_torch.config import MambaConfig
from musicgen_tpu_torch.models import mamba

KW = dict(d_model=64, n_layers=2, d_state=16, headdim=16, chunk_size=16, metadata_vocab_size=C.META)


def test_mamba_bf16_matches_jax():
    jcfg, cfg = JaxMambaConfig(**KW), MambaConfig(**KW)
    params = C.random_params(JaxMambaLM(jcfg))
    jax16 = C.jax_run(JaxMambaLM(jcfg, dtype=jnp.bfloat16), params, cfg)
    C.check(jax16, C.port_run(mamba, cfg, params, torch.bfloat16), C.port_run(mamba, cfg, params, torch.float32))
