"""Greedy Transformer generation end to end: the port's kernel-F path
(generate(kind="transformer", fused=True), its plain twins on the CPU) gives
the same 12-token streams as the port's plain ring-KV step (fused=False) and
as the JAX package's generate(fused=True) (the TPU kernel in interpret mode)
on the same weights. Stochastic streams come from different generators in
the two frameworks, so only their grammar is checked (tests/test_torch_cli.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.config import NUM_META
from musicgen_tpu.config import TransformerConfig as JaxTransformerConfig
from musicgen_tpu.models.transformer import TransformerLM as JaxTransformerLM
from musicgen_tpu.sample import sampler as js
from musicgen_tpu_torch.config import TransformerConfig
from musicgen_tpu_torch.interop import from_jax_params, load_model
from musicgen_tpu_torch.sample import sampler as ts

B, N = 2, 12


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxTransformerConfig(n_embd=256, n_heads=4, n_layer=2, block_len=32, attention_impl="xla")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, jcfg.vocab_size, (B, jcfg.block_len)).astype(np.int32)
    meta = rng.integers(0, jcfg.metadata_vocab_size, (B, NUM_META)).astype(np.int32)
    jm = JaxTransformerLM(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(prompt[:, :8]),
                                                         jnp.asarray(meta)))
    port = load_model(from_jax_params(params, TransformerConfig(**dataclasses.asdict(jcfg))), "cpu")
    return jm, params, port, prompt, meta


def test_greedy_streams_fused_plain_and_jax_agree(setup):
    jm, params, port, prompt, meta = setup
    args = (port, "transformer", torch.from_numpy(prompt).long(), torch.from_numpy(meta).long(), N, 32)
    fused = ts.generate(*args, torch.Generator().manual_seed(0), greedy=True, fused=True)
    plain = ts.generate(*args, torch.Generator().manual_seed(0), greedy=True, fused=False)
    want = js.generate(jm, params, "transformer", jnp.asarray(prompt), jnp.asarray(meta), N, block_len=32,
                       rng=jax.random.PRNGKey(7), greedy=True, fused=True)
    assert fused.shape == (B, 32 + N)
    np.testing.assert_array_equal(fused.numpy(), plain.numpy())
    np.testing.assert_array_equal(fused.numpy(), np.asarray(want))


def test_short_prompt_takes_the_plain_step(setup):
    """fused=True with a prompt shorter than the window runs the plain step,
    as the JAX package gates kernel F on prompt_len == block_len."""
    jm, params, port, prompt, meta = setup
    short = torch.from_numpy(prompt[:, 8:]).long()
    args = (port, "transformer", short, torch.from_numpy(meta).long(), N, 32)
    fused = ts.generate(*args, torch.Generator().manual_seed(1), fused=True)
    plain = ts.generate(*args, torch.Generator().manual_seed(1), fused=False)
    assert torch.equal(fused, plain)
