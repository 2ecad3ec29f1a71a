"""xLSTM generation end to end on the CPU: the port's plain path
(generate(kind="xlstm", fused=False), XLSTMLM.step) gives the JAX package's
greedy streams (generate(kind="xlstm", fused=False)) on the same weights;
the kernel-G path (fused=True, its plain versions on the CPU) is grammatical
and picks among the plain step's top-3 over the first tokens; the -sb16
formats run for an xLSTM and are refused for the other kinds. Stochastic
streams come from different generators in the two frameworks, so only their
grammar is checked."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.config import NUM_META
from musicgen_tpu.config import XLSTMConfig as JaxXLSTMConfig
from musicgen_tpu.models.xlstm import XLSTMLM as JaxXLSTMLM
from musicgen_tpu.sample import sampler as js
from musicgen_tpu_torch.config import MambaConfig, XLSTMConfig
from musicgen_tpu_torch.interop import from_jax_params, load_model
from musicgen_tpu_torch.models import mamba
from musicgen_tpu_torch.ops.grammar import field_bucket, filtered_logits, grammar_mask
from musicgen_tpu_torch.sample import sampler as ts
from tests.test_torch_xdecode import random_params

B, P, N, BLOCK = 2, 24, 12, 32
TOP3_TOKENS = 6


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxXLSTMConfig(embedding_dim=64, num_blocks=3, slstm_at=(1,), metadata_vocab_size=16)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, jcfg.vocab_size, (B, P)).astype(np.int32)
    meta = rng.integers(0, jcfg.metadata_vocab_size, (B, NUM_META)).astype(np.int32)
    jm = JaxXLSTMLM(jcfg)
    params = random_params(jm, prompt, meta)
    port = load_model(from_jax_params(params, XLSTMConfig(**dataclasses.asdict(jcfg))), "cpu")
    return jm, params, port, torch.from_numpy(prompt).long(), torch.from_numpy(meta).long()


def _grammatical(streams: torch.Tensor) -> bool:
    return bool((grammar_mask()[field_bucket(streams[:, P - 1:-1]), streams[:, P:]] > 0).all())


def test_greedy_plain_streams_match_jax(setup):
    jm, params, port, prompt, meta = setup
    plain = ts.generate(port, "xlstm", prompt, meta, N, BLOCK, torch.Generator().manual_seed(0), greedy=True,
                        fused=False)
    want = js.generate(jm, params, "xlstm", jnp.asarray(prompt.numpy(), jnp.int32),
                       jnp.asarray(meta.numpy(), jnp.int32), N, block_len=BLOCK, rng=jax.random.PRNGKey(7),
                       greedy=True, fused=False)
    assert plain.shape == (B, P + N)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(want))


@pytest.mark.parametrize("greedy", [True, False])
def test_fused_path_is_grammatical_and_within_the_plain_top3(setup, greedy):
    """The fused stream, stepped through XLSTMLM.step: each of its first
    TOP3_TOKENS tokens is among the plain step's top-3 sampling weights."""
    _, _, port, prompt, meta = setup
    fused = ts.generate(port, "xlstm", prompt, meta, N, BLOCK, torch.Generator().manual_seed(3), greedy=greedy,
                        fused=True)
    assert fused.shape == (B, P + N) and _grammatical(fused)
    pen = ts.init_penalty_state(prompt, 2048)
    with torch.no_grad():
        logits, states = port.prefill(prompt, meta)
        logits, last = logits[:, -1], prompt[:, -1]
        for i in range(TOP3_TOKENS):
            w = filtered_logits(last, logits) / ts.penalty_divisor(pen.hist)
            _, top3 = ts._iter_top_k(w, 3)
            tok = fused[:, P + i]
            assert bool((top3 == tok[:, None]).any(dim=1).all()), f"token {i}"
            pen = ts.push_token(pen, tok)
            logits, states = port.step(tok, states)
            last = tok


@pytest.mark.parametrize("quant", ["bf16-sb16", "int8w-sb16", "int8"])
def test_xlstm_formats_run_on_the_cpu(setup, quant):
    _, _, port, prompt, meta = setup
    out = ts.generate(port, "xlstm", prompt, meta, 4, BLOCK, torch.Generator().manual_seed(1), fused=True,
                      quant=quant)
    assert out.shape == (B, P + 4) and _grammatical(out)


def test_sb16_is_refused_for_the_other_kinds(setup):
    _, _, _, prompt, meta = setup
    model = mamba.init_weights_(mamba.empty_model(MambaConfig(d_model=64, n_layers=1, metadata_vocab_size=16),
                                                  "cpu"), 0)
    with pytest.raises(ValueError, match="xLSTM option"):
        ts.generate(model, "mamba", prompt, meta, 2, BLOCK, torch.Generator(), quant="bf16-sb16")
    with pytest.raises(ValueError, match="quant must be one of"):
        ts.generate(model, "xlstm", prompt, meta, 2, BLOCK, torch.Generator(), quant="int4-sb16")


def test_auto_fused_takes_kernel_g_on_the_card_only():
    """fused=None: kernel G for every xLSTM format on CUDA (the port's rule,
    not the JAX package's int8-or-sb16 one), the plain step on the CPU, and
    the plain step for a configuration kernel G does not take."""
    cfg = XLSTMConfig()
    assert ts._auto_fused("xlstm", cfg, torch.device("cuda"), 2048, 2048)
    assert not ts._auto_fused("xlstm", cfg, torch.device("cpu"), 2048, 2048)
    assert not ts._auto_fused("xlstm", dataclasses.replace(cfg, slstm_at=()), torch.device("cuda"), 2048, 2048)
