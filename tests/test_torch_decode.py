"""Kernel B's plain versions (musicgen_tpu_torch.ops.decode_kernel) vs the
TPU kernel's own body math, musicgen_tpu/ops/pallas_decode.py `_mixer_math`,
`_head_math` and `_tail_math`, called directly as jnp functions (the
interpret-mode kernel tests are all in the slow manifest).

Both sides round activations to bf16 before each product and accumulate in
f32 at the same points; they differ only in the order of f32 sums, except
where that order flips a bf16 rounding (2^-8 relative of one element). The
tolerances below are set for that."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.config import NUM_META, VOCAB, MambaConfig
from musicgen_tpu.models.mamba import MambaLM as JaxMambaLM
from musicgen_tpu.ops import pallas_decode as jd
from musicgen_tpu_torch.interop import from_jax_params, load_model
from musicgen_tpu_torch.ops import decode_kernel as dk

B, P = 2, 32


@pytest.fixture(scope="module")
def setup():
    cfg = MambaConfig(d_model=256, n_layers=2)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (B, P))
    meta = rng.integers(0, cfg.metadata_vocab_size, (B, NUM_META))
    jm = JaxMambaLM(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(prompt[:, :8]), jnp.asarray(meta))
    port = load_model(from_jax_params(jax.tree.map(np.asarray, params), cfg), "cpu")
    with torch.no_grad():
        _, states = port.prefill(torch.from_numpy(prompt), torch.from_numpy(meta))
    return cfg, params, port, states, rng


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
                 / np.abs(np.asarray(b, np.float64)).max())


def test_decode_dims_at_reference_size():
    d = dk.DecodeDims.create(MambaConfig(), 2)
    assert (d.d_model, d.d_inner, d.nheads, d.headdim, d.d_state) == (1024, 2048, 32, 64, 64)
    assert (d.conv_dim, d.d_in_proj, d.padded_vocab, d.vocab_size) == (2176, 4256, 17920, 17914)
    with pytest.raises(ValueError, match="residual"):
        dk.DecodeDims.create(MambaConfig(residual=True), 2)
    with pytest.raises(ValueError, match="batch"):
        dk.DecodeDims.create(MambaConfig(), dk.MAX_ROWS + 1)


def test_mixer_math_matches_pallas_body(setup):
    cfg, params, port, states, rng = setup
    jdims = jd.DecodeDims.create(cfg, B)
    jdp = jd.build_decode_params(params, cfg, B)
    dims = dk.DecodeDims.create(cfg, B)
    dp = dk.build_decode_params(port, B)
    conv, ssm = dk.stack_states(states)
    x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    for i in range(cfg.n_layers):
        x_rows = np.zeros((jdims.rows, cfg.d_model), np.float32)
        x_rows[:B] = x
        jx, jcs, js = jd._mixer_math(
            jnp.asarray(x_rows), jdp["w_in"][i], None, jdp["w_out"][i], None, jdp["conv_w"][i],
            jdp["conv_b"][i], jdp["dt_bias"][i], jdp["a_e"][i], jdp["d_e"][i], jdp["e_mat"],
            jdp["norm_w"][i], jnp.asarray(conv[i].numpy()), jnp.asarray(ssm[i].numpy()), jdims, "none",
        )
        zx = dk.in_proj_conv_plain(torch.from_numpy(x), dp["w_in"][i], dp["conv_w"][i], dp["conv_b"][i],
                                   dp["dt_bias"][i], conv[i], dims)
        g = dk.mixer_state_plain(zx, dp["a_h"][i], dp["d_h"][i], ssm[i], dims)
        out = dk.out_proj_rms_plain(g, dp["norm_w"][i], dp["w_out"][i], dims)
        # The states advanced in place, to f32 agreement.
        np.testing.assert_allclose(conv[i].numpy(), np.asarray(jcs), rtol=1e-5, atol=1e-5)
        assert _rel(ssm[i], js) < 1e-5
        assert _rel(out, np.asarray(jx)[:B]) < 1e-2
        x = out.numpy()


def test_head_and_tail_match_pallas_body(setup):
    cfg, params, port, states, rng = setup
    jdims = jd.DecodeDims.create(cfg, B)
    jdp = jd.build_decode_params(params, cfg, B)
    dims = dk.DecodeDims.create(cfg, B)
    dp = dk.build_decode_params(port, B)
    vp, v = dims.padded_vocab, dims.vocab_size
    x = 2.0 * rng.standard_normal((jdims.rows, cfg.d_model)).astype(np.float32)
    jl = jd._head_math(jnp.asarray(x), jdp["ln"], jdp["lm_w"], None, "none") + jdp["lm_b"][None, :]
    logits = dk.lm_head_ln_plain(torch.from_numpy(x[:B]), dp["ln_w"], dp["ln_b"], dp["lm_w"], dp["lm_b"], dims)
    assert logits.shape == (B, vp)
    # The JAX model keeps (random) weights in its pad columns; the reference
    # layout has none, and the port's pack pads with zeros.
    assert _rel(logits[:, :v], np.asarray(jl)[:B, :v]) < 1e-2
    assert not bool(logits[:, v:].any())

    # The tail on one set of logits: penalty counts on pitch and dyn ids,
    # previous tokens in different fields.
    hist = np.zeros((B, v), np.int32)
    hist[:, rng.integers(0, VOCAB.length_start, 400)] = rng.integers(1, 30, 400)
    prev = np.array([5, VOCAB.dyn_start + 3])
    bucket = np.searchsorted(np.asarray(VOCAB.field_boundaries), prev, side="left")
    hist_oh = np.zeros((jdims.rows, vp), np.float32)
    hist_oh[:B, :v] = hist
    bucket_oh = np.zeros((jdims.rows, 8), np.float32)
    bucket_oh[np.arange(B), bucket] = 1.0
    lg = logits.numpy()
    lg[:, v:] = np.asarray(jl)[:B, v:]  # pad lanes are masked: any value
    lg_rows = np.zeros((jdims.rows, vp), np.float32)
    lg_rows[:B] = lg
    jv, ji = jd._tail_math(jnp.asarray(lg_rows), jdp["gram8"], jnp.asarray(hist_oh), jnp.asarray(bucket_oh), jdims)
    vals, idxs = dk.sample_tail_plain(torch.from_numpy(lg), dp["gram"], torch.from_numpy(hist),
                                      torch.from_numpy(bucket), dims)
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(ji)[:B, :3])
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv)[:B, :3], rtol=1e-5)


def test_fused_steps_match_model_step(setup):
    """The decode chain (plain versions on CPU) vs MambaLM.step in f32, at the
    tolerance the JAX package holds its kernel to (tests/test_pallas_decode)."""
    cfg, params, port, states, rng = setup
    dims = dk.DecodeDims.create(cfg, B)
    dp = dk.build_decode_params(port, B)
    carry = dk.stack_states(states)
    launches = dict(dk.LAUNCHES)
    tok = torch.tensor([7, VOCAB.time_start + 9])
    ref_states = states
    for _ in range(6):
        with torch.no_grad():
            ref, ref_states = port.step(tok, ref_states)
        logits, carry = dk.fused_logits_step(dp, tok, carry, dims)
        np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=0.05, atol=0.05 * float(ref.abs().max()))
        assert torch.equal(logits.argmax(-1), ref.argmax(-1))
        tok = ref.argmax(-1)
    for st, ref_st in zip(dk.unstack_states(*carry, dims), ref_states):
        np.testing.assert_allclose(st["ssm"].numpy(), ref_st["ssm"].numpy(), rtol=0.05, atol=0.05)
        np.testing.assert_allclose(st["conv"].numpy(), ref_st["conv"].numpy(), rtol=0.05, atol=0.05)
    # On CPU tensors every wrapper ran its plain version: no launches.
    assert dict(dk.LAUNCHES) == launches


def test_stack_states_roundtrip(setup):
    cfg, params, port, states, rng = setup
    dims = dk.DecodeDims.create(cfg, B)
    conv, ssm = dk.stack_states(states)
    assert conv.shape == (cfg.n_layers, B, 3, cfg.conv_dim)
    assert ssm.shape == (cfg.n_layers, cfg.d_inner, B * cfg.d_state)
    # S[h*P+p, b*N+n] == state[b, h, p, n]
    s0 = states[0]["ssm"]
    assert torch.equal(ssm[0][3 * cfg.headdim + 5, 1 * cfg.d_state + 7], s0[1, 3, 5, 7])
    for st, back in zip(states, dk.unstack_states(conv, ssm, dims)):
        assert torch.equal(st["conv"], back["conv"]) and torch.equal(st["ssm"], back["ssm"])


def test_fused_sample_step_top3_is_the_tail_of_the_logits(setup):
    cfg, params, port, states, rng = setup
    dims = dk.DecodeDims.create(cfg, B)
    dp = dk.build_decode_params(port, B)
    carry = dk.stack_states(states)
    carry2 = (carry[0].clone(), carry[1].clone())
    tok = torch.tensor([VOCAB.tempo_start + 1, VOCAB.length_start + 2])
    hist = torch.zeros(B, cfg.vocab_size, dtype=torch.int32)
    from musicgen_tpu_torch.ops.grammar import field_bucket

    vals, idxs, _ = dk.fused_sample_step(dp, tok, carry, hist, field_bucket(tok), dims)
    logits = dk.decode_logits(dp, tok, carry2, dims)
    v2, i2 = dk.sample_tail_plain(logits, dp["gram"], hist, field_bucket(tok), dims)
    assert torch.equal(vals, v2) and torch.equal(idxs, i2)
    assert bool((idxs < cfg.vocab_size).all())
    # prev tempo -> pitch ids only; prev length -> time or tempo ids only.
    assert bool((idxs[0] < VOCAB.dyn_start).all())
    assert bool((idxs[1] >= VOCAB.time_start).all())
