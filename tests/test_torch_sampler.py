"""Port sampler (musicgen_tpu_torch.sample.sampler) vs the JAX sampler.

The penalty window is integer bookkeeping and must match exactly. Greedy
streams must be identical on the same weights. Torch and JAX draw different
random numbers, so the stochastic picks are checked as distributions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.config import NUM_META, VOCAB, MambaConfig
from musicgen_tpu.models.mamba import MambaLM as JaxMambaLM
from musicgen_tpu.sample import sampler as js
from musicgen_tpu_torch.config import MambaConfig as PortMambaConfig
from musicgen_tpu_torch.interop import from_jax_params, load_model
from musicgen_tpu_torch.ops.grammar import field_bucket, grammar_mask
from musicgen_tpu_torch.sample import sampler as ts


def port_cfg(cfg):
    """The port's MambaConfig with the fields of a JAX one."""
    return PortMambaConfig(**dataclasses.asdict(cfg))


def _stream(rng, b, n):
    """Token streams rich in time tokens, so the tick window moves."""
    fields = rng.integers(0, 5, (b, n))
    lo = np.array([0, VOCAB.dyn_start, VOCAB.length_start, VOCAB.time_start, VOCAB.tempo_start])
    hi = np.array([VOCAB.dyn_start, VOCAB.length_start, VOCAB.time_start, VOCAB.tempo_start, VOCAB.vocab_size])
    return (lo[fields] + rng.integers(0, 1 << 30, (b, n)) % (hi - lo)[fields]).astype(np.int64)


def _assert_state_equal(t_state, j_state):
    for name in js.PenaltyState._fields:
        np.testing.assert_array_equal(getattr(t_state, name).numpy(), np.asarray(getattr(j_state, name)),
                                      err_msg=name)


@pytest.mark.parametrize("p,ring", [(300, 2048), (300, 64)])
def test_penalty_window_matches_jax_exactly(p, ring):
    rng = np.random.default_rng(p + ring)
    prompt = _stream(rng, 3, p)
    t_state = ts.init_penalty_state(torch.from_numpy(prompt), ring)
    j_state = js.init_penalty_state(jnp.asarray(prompt, jnp.int32), ring)
    _assert_state_equal(t_state, j_state)
    j_push = jax.jit(js.push_token)
    for tok in _stream(rng, 3, 80).T:
        t_state = ts.push_token(t_state, torch.from_numpy(tok))
        j_state = j_push(j_state, jnp.asarray(tok, jnp.int32))
        _assert_state_equal(t_state, j_state)
    np.testing.assert_allclose(ts.penalty_divisor(t_state.hist).numpy(),
                               np.asarray(js.penalty_divisor(j_state.hist)), rtol=1e-6)


def test_iter_top_k_matches_jax_with_ties():
    rng = np.random.default_rng(0)
    w = rng.integers(0, 5, (4, 50)).astype(np.float32)  # many ties
    tv, ti = ts._iter_top_k(torch.from_numpy(w), 3)
    jv, ji = js._iter_top_k(jnp.asarray(w), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_sample_k_distribution():
    """20,000 draws per field; the frequencies of k in {1,2,3} lie within
    0.02 of the reference's tables (about 5 standard errors)."""
    n = 20_000
    gen = torch.Generator().manual_seed(0)
    prev = {0: 5, 1: VOCAB.dyn_start + 1, 2: VOCAB.length_start + 1, 3: VOCAB.time_start + 1,
            4: VOCAB.tempo_start + 1}
    for field, tok in prev.items():
        k = ts._sample_k(torch.full((n,), tok), gen)
        freq = np.bincount(k.numpy(), minlength=4)[1:] / n
        np.testing.assert_allclose(freq, ts._K_TABLE[field], atol=0.02)


def test_pick_next_distribution():
    """k = 3 over weights (6, 3, 1, ...) picks the top three in proportion
    6:3:1, within 0.02 over 20,000 draws; k = 1 always takes the top."""
    n = 20_000
    gen = torch.Generator().manual_seed(1)
    w = torch.zeros(n, 40)
    w[:, 7], w[:, 3], w[:, 30] = 6.0, 3.0, 1.0
    w[:, 12] = 0.5
    picks = ts._pick_next(w, torch.full((n,), 3), gen, 3, greedy=False)
    freq = np.array([(picks == i).float().mean().item() for i in (7, 3, 30)])
    np.testing.assert_allclose(freq, [0.6, 0.3, 0.1], atol=0.02)
    assert bool(torch.isin(picks, torch.tensor([7, 3, 30])).all())
    picks = ts._pick_next(w, torch.ones(n, dtype=torch.int64), gen, 3, greedy=False)
    assert bool((picks == 7).all())


@pytest.fixture(scope="module")
def models():
    cfg = MambaConfig(d_model=128, n_layers=2)
    rng = np.random.default_rng(0)
    prompt = _stream(rng, 2, 48)
    meta = rng.integers(0, cfg.metadata_vocab_size, (2, NUM_META))
    jm = JaxMambaLM(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(prompt[:, :8], jnp.int32), jnp.asarray(meta))
    port = load_model(from_jax_params(jax.tree.map(np.asarray, params), port_cfg(cfg)), "cpu")
    return jm, params, port, prompt, meta


def test_greedy_stream_matches_jax(models):
    jm, params, port, prompt, meta = models
    n = 32
    want = js.generate(jm, params, "mamba", jnp.asarray(prompt, jnp.int32), jnp.asarray(meta, jnp.int32), n,
                       block_len=48, rng=jax.random.PRNGKey(0), greedy=True, fused=False)
    got = ts.generate(port, "mamba", torch.from_numpy(prompt), torch.from_numpy(meta), n, 48,
                      torch.Generator().manual_seed(0), greedy=True, fused=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_none_on_cpu_is_the_plain_path_and_streams_are_grammatical(models):
    jm, params, port, prompt, meta = models
    args = (port, "mamba", torch.from_numpy(prompt), torch.from_numpy(meta), 24, 48)
    auto = ts.generate(*args, torch.Generator().manual_seed(3), fused=None)
    plain = ts.generate(*args, torch.Generator().manual_seed(3), fused=False)
    assert torch.equal(auto, plain)
    fused = ts.generate(*args, torch.Generator().manual_seed(3), fused=True)
    mask = grammar_mask()
    for streams in (plain, fused):
        assert streams.shape == (2, 48 + 24)
        assert torch.equal(streams[:, :48], torch.from_numpy(prompt))
        prev, new = streams[:, 47:-1], streams[:, 48:]
        assert bool((mask[field_bucket(prev), new] > 0).all())


def test_unported_options_raise(models):
    jm, params, port, prompt, meta = models
    args = (torch.from_numpy(prompt), torch.from_numpy(meta), 4, 48, torch.Generator())
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ts.generate(port, "classifier", *args)
    # bf16 storage of the mLSTM matrix memory is ported, for an xLSTM only.
    with pytest.raises(ValueError, match="xLSTM option"):
        ts.generate(port, "mamba", *args, quant="bf16-sb16")


def test_auto_fused_follows_the_jax_rule():
    """fused=None takes the decode kernels on an accelerator for a Mamba
    model without residuals and for a Transformer whose prompt fills its
    window (musicgen_tpu/sample/sampler.py generate, less the TPU VMEM
    admission); a residual=True model, a short prompt or another window on
    CUDA takes the plain step. An xLSTM takes kernel G on CUDA in every
    format, the port's own rule where the JAX package fuses only int8 or
    -sb16 (sampler._auto_fused). Decided without a card: the choice reads
    only the device type."""
    from musicgen_tpu_torch.config import TransformerConfig, XLSTMConfig

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert ts._auto_fused("mamba", PortMambaConfig(), cuda, 64, 64)
    assert not ts._auto_fused("mamba", PortMambaConfig(residual=True), cuda, 64, 64)
    assert not ts._auto_fused("mamba", PortMambaConfig(), cpu, 64, 64)
    tcfg = TransformerConfig(block_len=64)
    assert ts._auto_fused("transformer", tcfg, cuda, prompt_len=64, block_len=64)
    assert not ts._auto_fused("transformer", tcfg, cuda, prompt_len=40, block_len=64)  # short prompt
    assert not ts._auto_fused("transformer", tcfg, cuda, prompt_len=32, block_len=32)  # another window
    assert not ts._auto_fused("transformer", tcfg, cpu, prompt_len=64, block_len=64)
    assert ts._auto_fused("xlstm", XLSTMConfig(), cuda, prompt_len=64, block_len=64)
    assert not ts._auto_fused("xlstm", XLSTMConfig(), cpu, prompt_len=64, block_len=64)


@pytest.mark.parametrize("opts", [dict(resident=True), dict(resident=True, quant="int8w", greedy=True),
                                  dict(quant="int8w", fused=True), dict(quant="int8", fused=True)],
                         ids=["resident", "resident_int8w_greedy", "int8w", "int8"])
def test_resident_and_int8_streams_are_grammatical(models, opts):
    """On CPU the resident loop and the int8 decode steps run their plain
    versions; every new token is allowed by the grammar."""
    jm, params, port, prompt, meta = models
    streams = ts.generate(port, "mamba", torch.from_numpy(prompt), torch.from_numpy(meta), 16, 48,
                          torch.Generator().manual_seed(4), **opts)
    assert streams.shape == (2, 48 + 16)
    assert torch.equal(streams[:, :48], torch.from_numpy(prompt))
    mask = grammar_mask()
    assert bool((mask[field_bucket(streams[:, 47:-1]), streams[:, 48:]] > 0).all())
