"""Small seeded models of the three families on both sides, for the port's
sampler-mode, windowed and serving tests: the JAX package's model with
seeded numpy weights (tests/test_torch_xdecode.random_params, which compiles
nothing) and the port's model carrying the same weights through `interop`.
Not a test module: the test files import it."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from musicgen_tpu.config import NUM_META, VOCAB, MambaConfig
from musicgen_tpu.config import TransformerConfig as JaxTransformerConfig
from musicgen_tpu.config import XLSTMConfig as JaxXLSTMConfig
from musicgen_tpu.models.mamba import MambaLM as JaxMambaLM
from musicgen_tpu.models.transformer import TransformerLM as JaxTransformerLM
from musicgen_tpu.models.xlstm import XLSTMLM as JaxXLSTMLM
from musicgen_tpu_torch import config as port_config
from musicgen_tpu_torch.interop import from_jax_params, load_model
from musicgen_tpu_torch.ops.grammar import field_bucket, grammar_mask
from tests.test_torch_xdecode import random_params

# The gate runs the suite in several pytest-xdist workers on one host. torch's
# default of one intra-op thread per core in every worker oversubscribes the
# cores, and its OpenMP threads spin while they wait: a CLI case that takes
# 0.5 s alone took 28-71 s there. Every worker imports this module when it
# collects the suite, so its torch ops run on one thread.
torch.set_num_threads(1)

BLOCK = 32  # the Transformer's block_len, and the window of every test here
KINDS = ("mamba", "transformer", "xlstm")


def prompts(n: int, length: int, seed: int = 0) -> np.ndarray:
    """(n, length) grammar-plausible streams: pitch, dyn, length, a short
    time step and tempo tokens in turn (tests/test_serve.py `_prompt`)."""
    rng = np.random.default_rng(seed)
    lo = [0, VOCAB.dyn_start, VOCAB.length_start, VOCAB.time_start, VOCAB.tempo_start]
    hi = [VOCAB.dyn_start, VOCAB.length_start, VOCAB.time_start, VOCAB.time_start + 16, VOCAB.vocab_size]
    cols = [rng.integers(lo[j % 5], hi[j % 5], n) for j in range(length)]
    return np.stack(cols, axis=1).astype(np.int32)


def metas(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + 1).integers(0, 16, (n, NUM_META)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def family(kind: str):
    """(jax_model, jax_params, port_model) of a small `kind` model."""
    if kind == "mamba":
        jcfg, jm_cls, cfg_cls = MambaConfig(d_model=128, n_layers=2, metadata_vocab_size=16), JaxMambaLM, \
            port_config.MambaConfig
    elif kind == "transformer":
        jcfg = JaxTransformerConfig(n_embd=64, n_heads=2, n_layer=2, block_len=BLOCK, metadata_vocab_size=16,
                                    attention_impl="xla")
        jm_cls, cfg_cls = JaxTransformerLM, port_config.TransformerConfig
    else:
        jcfg = JaxXLSTMConfig(embedding_dim=64, num_blocks=3, slstm_at=(1,), metadata_vocab_size=16)
        jm_cls, cfg_cls = JaxXLSTMLM, port_config.XLSTMConfig
    jm = jm_cls(jcfg)
    params = random_params(jm, prompts(1, 8), metas(1))
    port = load_model(from_jax_params(params, cfg_cls(**dataclasses.asdict(jcfg))), "cpu").eval()
    return jm, params, port


def jax_generate(kind: str, prompt: np.ndarray, meta: np.ndarray, n: int, **opts) -> np.ndarray:
    """The JAX package's sample.sampler.generate on the small `kind` model."""
    from musicgen_tpu.sample import sampler as js

    jm, params, _ = family(kind)
    out = js.generate(jm, params, kind, jnp.asarray(prompt), jnp.asarray(meta), n, BLOCK,
                      jax.random.PRNGKey(0), **opts)
    return np.asarray(out)


def port_generate(kind: str, prompt: np.ndarray, meta: np.ndarray, n: int, seed: int = 0, **opts) -> torch.Tensor:
    """The port's sample.sampler.generate on the small `kind` model (CPU)."""
    from musicgen_tpu_torch.sample import sampler as ts

    return ts.generate(family(kind)[2], kind, torch.from_numpy(prompt).long(), torch.from_numpy(meta).long(), n,
                       BLOCK, torch.Generator().manual_seed(seed), **opts)


def grammatical(streams, prompt_len: int) -> bool:
    streams = torch.as_tensor(np.asarray(streams)).long()
    return bool((grammar_mask()[field_bucket(streams[:, prompt_len - 1:-1]), streams[:, prompt_len:]] > 0).all())
