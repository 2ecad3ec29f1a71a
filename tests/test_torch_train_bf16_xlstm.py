"""bf16 training of the port's xLSTM (an mLSTM block and an sLSTM block,
the plain scans in both frameworks) against the JAX package's XLSTMLM built
with dtype=jnp.bfloat16 (tests/torch_bf16_common.py has the checks and
their tolerance, set from JAX's own bf16-against-f32 gap)."""
import jax.numpy as jnp
import torch

from tests import torch_bf16_common as C
from musicgen_tpu.config import XLSTMConfig as JaxXLSTMConfig
from musicgen_tpu.models.xlstm import XLSTMLM as JaxXLSTMLM
from musicgen_tpu_torch.config import XLSTMConfig
from musicgen_tpu_torch.models import xlstm

KW = dict(embedding_dim=64, num_blocks=2, slstm_at=(1,), num_heads=2, metadata_vocab_size=C.META)


def test_xlstm_bf16_matches_jax():
    jcfg, cfg = JaxXLSTMConfig(**KW), XLSTMConfig(**KW)
    params = C.random_params(JaxXLSTMLM(jcfg))
    jax16 = C.jax_run(JaxXLSTMLM(jcfg, dtype=jnp.bfloat16), params, cfg)
    C.check(jax16, C.port_run(xlstm, cfg, params, torch.bfloat16), C.port_run(xlstm, cfg, params, torch.float32))
