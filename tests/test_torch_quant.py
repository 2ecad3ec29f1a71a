"""Kernel B's int8 plain versions (musicgen_tpu_torch.ops.decode_kernel:
quantize_cols, qdot, w8dot and the W8A8 / W8A16 mixer and head) vs the TPU
kernel's own math in musicgen_tpu/ops/pallas_decode.py (`_quantize_cols`,
`_qdot`, `_w8dot`, `_mixer_math`, `_head_math`), called as jnp functions.

The port keeps matrices in torch's (out, in) layout, so its int8 pack is the
JAX pack transposed. The pack and the integer parts of W8A8 are exact; f32
sums differ only in order. Where a normalisation precedes a W8A8 product,
one f32 rounding of an activation can move it by one int8 level, 1/127 of
its group's largest value: the tolerances below allow for that."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.config import NUM_META, MambaConfig
from musicgen_tpu.models.mamba import MambaLM as JaxMambaLM
from musicgen_tpu.ops import pallas_decode as jd
from musicgen_tpu_torch.config import MambaConfig as PortMambaConfig
from musicgen_tpu_torch.interop import from_jax_params, load_model
from musicgen_tpu_torch.ops import decode_kernel as dk

B, P = 2, 32
# The TPU kernel's bodies, jitted as they run inside it (and faster here).
_mixer_math = jax.jit(jd._mixer_math, static_argnums=(14, 15))
_head_math = jax.jit(jd._head_math, static_argnums=(4,))


def port_cfg(cfg):
    """The port's MambaConfig with the fields of a JAX one."""
    return PortMambaConfig(**dataclasses.asdict(cfg))


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
                 / np.abs(np.asarray(b, np.float64)).max())


@pytest.fixture(scope="module")
def setup():
    cfg = MambaConfig(d_model=256, n_layers=2)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (B, P))
    meta = rng.integers(0, cfg.metadata_vocab_size, (B, NUM_META))
    params = jax.jit(JaxMambaLM(cfg).init)(jax.random.PRNGKey(0), jnp.asarray(prompt[:, :8]), jnp.asarray(meta))
    port = load_model(from_jax_params(jax.tree.map(np.asarray, params), port_cfg(cfg)), "cpu")
    with torch.no_grad():
        _, states = port.prefill(torch.from_numpy(prompt), torch.from_numpy(meta))
    # Eager, as the scales are compared exactly: under jit XLA may turn the
    # division by 127 into a product with its reciprocal (one ulp apart).
    jdp = jd.build_decode_params(params, cfg, B, quant="int8")
    dp = dk.build_decode_params(port, B, quant="int8")
    return cfg, params, port, states, rng, jdp, dp


@pytest.mark.parametrize("k,n", [(512, 96), (200, 40)], ids=["grouped", "one_group"])
def test_quantize_cols_matches_jax_exactly(k, n):
    w = np.random.default_rng(k).standard_normal((k, n)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column takes the 1e-20 floor
    jq, js = jd._quantize_cols(jnp.asarray(w))
    q, s = dk.quantize_cols(torch.from_numpy(w.T.copy()))
    assert q.dtype == torch.int8 and s.shape == (max(1, k // 256) if k % 256 == 0 else 1, n)
    np.testing.assert_array_equal(q.numpy().T, np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("quant", ["w8a8", "w8a16"])
def test_int8_products_match_jax(quant):
    rng = np.random.default_rng(1)
    k, n = 768, 80
    x = (3.0 * rng.standard_normal((B, k))).astype(np.float32)
    x[1, 256:512] *= 1e-3  # a group far below the others keeps its own scale
    jq, js = jd._quantize_cols(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32)))
    q, s = torch.from_numpy(np.asarray(jq).T.copy()), torch.from_numpy(np.array(js))
    jfn, fn = (jd._qdot, dk.qdot) if quant == "w8a8" else (jd._w8dot, dk.w8dot)
    want = np.asarray(jfn(jnp.asarray(x), jq, js))
    got = fn(torch.from_numpy(x), q, s).numpy()
    assert _rel(got, want) < 1e-6


def test_build_decode_params_int8_matches_jax(setup):
    cfg, params, port, states, rng, jdp, dp = setup
    v, dip = cfg.vocab_size, dp["w_in"].shape[1]
    for key in ("w_in", "w_out"):
        assert dp[key].dtype == torch.int8
        np.testing.assert_array_equal(dp[key].numpy(), np.asarray(jdp[key]).transpose(0, 2, 1)[:, :dp[key].shape[1]])
        np.testing.assert_array_equal(dp[key + "_s"].numpy(), np.asarray(jdp[key + "_s"])[..., :dp[key].shape[1]])
    assert dp["w_in_s"].shape == (cfg.n_layers, 1, dip) and dp["w_out_s"].shape == (cfg.n_layers, 2, cfg.d_model)
    np.testing.assert_array_equal(dp["lm_w"][:v].numpy(), np.asarray(jdp["lm_w"]).T[:v])
    np.testing.assert_array_equal(dp["lm_s"][:, :v].numpy(), np.asarray(jdp["lm_s"])[:, :v])
    # The port's pad rows are zero (q 0, scale at the floor).
    assert not bool(dp["lm_w"][v:].any()) and bool((dp["lm_s"][:, v:] == 1e-20).all())


@pytest.mark.parametrize("quant", ["w8a8", "w8a16"])
def test_int8_mixer_math_matches_pallas_body(setup, quant):
    cfg, params, port, states, rng, jdp, dp = setup
    jdims = jd.DecodeDims.create(cfg, B)
    dims = dk.DecodeDims.create(port_cfg(cfg), B)
    conv, ssm = dk.stack_states(states)
    x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    for i in range(cfg.n_layers):
        x_rows = np.zeros((jdims.rows, cfg.d_model), np.float32)
        x_rows[:B] = x
        jx, jcs, js = _mixer_math(
            jnp.asarray(x_rows), jdp["w_in"][i], jdp["w_in_s"][i], jdp["w_out"][i], jdp["w_out_s"][i],
            jdp["conv_w"][i], jdp["conv_b"][i], jdp["dt_bias"][i], jdp["a_e"][i], jdp["d_e"][i], jdp["e_mat"],
            jdp["norm_w"][i], jnp.array(conv[i].numpy()), jnp.array(ssm[i].numpy()), jdims, quant,
        )
        jx, jcs, js = (np.asarray(a) for a in (jx, jcs, js))  # before the port advances the states in place
        zx = dk.in_proj_conv_plain(torch.from_numpy(x), dp["w_in"][i], dp["conv_w"][i], dp["conv_b"][i],
                                   dp["dt_bias"][i], conv[i], dims, dp["w_in_s"][i], quant)
        g = dk.mixer_state_plain(zx, dp["a_h"][i], dp["d_h"][i], ssm[i], dims)
        out = dk.out_proj_rms_plain(g, dp["norm_w"][i], dp["w_out"][i], dims, dp["w_out_s"][i], quant)
        np.testing.assert_allclose(conv[i].numpy(), np.asarray(jcs), rtol=1e-5, atol=1e-5)
        assert _rel(ssm[i], js) < 1e-5
        assert _rel(out, np.asarray(jx)[:B]) < 1e-2
        x = out.numpy()


@pytest.mark.parametrize("quant", ["w8a8", "w8a16"])
def test_int8_head_matches_pallas_body(setup, quant):
    cfg, params, port, states, rng, jdp, dp = setup
    dims = dk.DecodeDims.create(port_cfg(cfg), B)
    v = cfg.vocab_size
    x = 2.0 * rng.standard_normal((8, cfg.d_model)).astype(np.float32)
    jl = _head_math(jnp.asarray(x), jdp["ln"], jdp["lm_w"], jdp["lm_s"], quant) + jdp["lm_b"][None, :]
    logits = dk.lm_head_ln_plain(torch.from_numpy(x[:B]), dp["ln_w"], dp["ln_b"], dp["lm_w"], dp["lm_b"], dims,
                                 dp["lm_s"], quant)
    assert logits.shape == (B, dims.padded_vocab)
    assert _rel(logits[:, :v], np.asarray(jl)[:B, :v]) < 1e-2
    assert not bool(logits[:, v:].any())


def test_int8_steps_follow_the_bf16_steps(setup):
    """Through decode_logits, the W8A16 and W8A8 steps stay within int8
    noise of the bf16 step on the same state and agree on its top token."""
    cfg, params, port, states, rng, jdp, dp = setup
    dims = dk.DecodeDims.create(port_cfg(cfg), B)
    dp16 = dk.build_decode_params(port, B)
    tok = torch.tensor([5, 300])
    ref = dk.decode_logits(dp16, tok, dk.stack_states(states), dims)
    for quant in ("w8a16", "w8a8"):
        got = dk.decode_logits(dp, tok, dk.stack_states(states), dims, quant=quant)
        assert _rel(got[:, :cfg.vocab_size], ref[:, :cfg.vocab_size]) < 0.1
    with pytest.raises(ValueError, match="does not match"):
        dk.decode_logits(dp, tok, dk.stack_states(states), dims)
