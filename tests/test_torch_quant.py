"""Kernel B's plain GEMV versions (musicgen_tpu_torch.ops.decode_kernel:
quantize_cols, qdot, w8dot, the bf16 _product, out_proj_rms_plain and
lm_head_ln_plain, and the W8A8 / W8A16 mixer and head) vs the TPU kernel's
own math in musicgen_tpu/ops/pallas_decode.py (`_quantize_cols`, `_qdot`,
`_w8dot`, `_dot`, `_mixer_math`, `_head_math`), called as jnp functions,
and the GEMV kernels' shape rule, held by the wrappers before any launch.

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


# (quant, rows, K, N, what the case holds): the yardstick of the GEMV
# kernels at the shapes they take. int8: "low" scales one group by 1e-3,
# "zero" zeroes one row's group (its scale takes the 1e-20 floor); K = 1408
# is the xLSTM FFN down-projection's one-group pack. bf16 ("none"): the
# product alone ("dot", `_dot` on bf16 activations), after the gated RMSNorm
# ("rms", `_mixer_math`'s expression) and after the LayerNorm with the bias
# ("head", `_head_math`), at the main paths' widths and at a ragged N and K
# (1000, 1016) that the kernels take with zeros past the end. The plain
# versions round the same f32 activations to bf16 as the JAX ones do, so
# only the order of the f32 sums differs.
_PRODUCT_CASES = [
    pytest.param(q, rows, k, n, kind, id=f"{q}{sfx}")
    for q in ("w8a8", "w8a16")
    for rows, k, n, kind, sfx in ((B, 768, 80, "low", ""), (1, 512, 48, "low", "-r1"), (8, 1024, 64, "low", "-r8"),
                                  (2, 1408, 32, "low", "-one_group_k1408"), (B, 768, 80, "zero", "-zero_group"))
] + [
    pytest.param("none", rows, k, n, kind, id=f"bf16-{kind}-r{rows}-k{k}-n{n}")
    for kind in ("dot", "rms", "head")
    for rows, k, n in ((1, 512, 48), (2, 1024, 80), (8, 1000, 1000), (3, 4096, 1016))
]


def _bf16_pair(kind, x, w, rng):
    """The JAX expression and the port's plain version of one bf16 GEMV
    (x (R, K) f32, w (K, N) f32 in JAX's layout): (want, got)."""
    k, n = w.shape
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    tw = torch.from_numpy(w.T.copy()).to(torch.bfloat16)
    tx = torch.from_numpy(x)
    if kind == "dot":
        return jd._dot(jnp.asarray(x).astype(jnp.bfloat16), jw), dk._product(tx, tw, None, "none")
    dims = dk.DecodeDims.create(port_cfg(MambaConfig()), x.shape[0])
    if kind == "rms":
        norm_w = (1.0 + 0.1 * rng.standard_normal(k)).astype(np.float32)
        g = jnp.asarray(x)
        var = jnp.mean(g * g, axis=-1, keepdims=True)
        g = g * jax.lax.rsqrt(var + 1e-5) * jnp.asarray(norm_w)
        return jd._dot(g.astype(jnp.bfloat16), jw), dk.out_proj_rms_plain(tx, torch.from_numpy(norm_w), tw, dims)
    ln = np.stack([1.0 + 0.1 * rng.standard_normal(k), 0.1 * rng.standard_normal(k)]).astype(np.float32)
    lm_b = rng.standard_normal(n).astype(np.float32)
    want = jd._head_math(jnp.asarray(x), jnp.asarray(ln), jw, None, "none") + jnp.asarray(lm_b)[None, :]
    got = dk.lm_head_ln_plain(tx, torch.from_numpy(ln[0]), torch.from_numpy(ln[1]), tw, torch.from_numpy(lm_b), dims)
    return want, got


@pytest.mark.parametrize("quant,rows,k,n,kind", _PRODUCT_CASES)
def test_int8_products_match_jax(quant, rows, k, n, kind):
    rng = np.random.default_rng(1)
    x = (3.0 * rng.standard_normal((rows, k))).astype(np.float32)
    if quant == "none":
        want, got = _bf16_pair(kind, x, (0.03 * rng.standard_normal((k, n))).astype(np.float32), rng)
        assert got.shape == (rows, n) and bool(torch.isfinite(got).all())
        assert _rel(got, want) < 1e-6
        return
    if kind == "low":
        x[rows - 1, 256:512] *= 1e-3  # a group far below the others keeps its own scale
    else:
        x[1, 256:512] = 0.0
    jq, js = jd._quantize_cols(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32)))
    assert js.shape[0] == (1 if k % 256 else k // 256)
    q, s = torch.from_numpy(np.asarray(jq).T.copy()), torch.from_numpy(np.array(js))
    jfn, fn = (jd._qdot, dk.qdot) if quant == "w8a8" else (jd._w8dot, dk.w8dot)
    want = np.asarray(jfn(jnp.asarray(x), jq, js))
    got = fn(torch.from_numpy(x), q, s).numpy()
    assert got.shape == (rows, n) and np.isfinite(got).all()
    assert _rel(got, want) < 1e-6


# (quant, K, N, K-group, refused): the GEMV kernels' shape rule
# (csrc/decode_ops.cuh gemv_shape_ok_grouped), held by the wrappers' guard
# before any launch. Every shape the main paths launch is taken; bf16
# ("none") takes any N and K % 8 == 0 up to 8192, whatever its group says;
# no format takes more than 8 rows.
_SHAPE_CASES = [
    ("w8a8", 1024, 4256, 256, False),    # Mamba in_proj
    ("w8a8", 2048, 1024, 256, False),    # out_proj
    ("w8a8", 1024, 17920, 256, False),   # lm_head
    ("w8a16", 1024, 3072, 256, False),   # Transformer qkv
    ("w8a16", 4096, 1024, 256, False),   # Transformer FFN down
    ("w8a16", 1024, 2816, 256, False),   # xLSTM FFN up
    ("w8a16", 1408, 1024, 1408, False),  # xLSTM FFN down, one group
    ("w8a16", 768, 1024, 256, False),    # three groups
    ("w8a8", 1024, 4248, 256, True),     # N not in tiles of 16
    ("w8a8", 1408, 1024, 1408, True),    # one group: W8A16 only
    ("w8a16", 1400, 1024, 1400, True),   # one group not in 64-k steps
    ("w8a16", 1024, 1024, 512, True),    # another group size
    ("w8a16", 8192, 1024, 256, True),    # K past the staged 4096
    ("none", 1024, 4256, 1024, False),   # Mamba in_proj (kernels B, C; J splits it at 2048)
    ("none", 2048, 1024, 2048, False),   # out_proj, the xLSTM mLSTM down
    ("none", 1024, 17920, 1024, False),  # lm_head
    ("none", 1024, 3072, 1024, False),   # Transformer qkv
    ("none", 1024, 1024, 1024, False),   # Transformer attention out
    ("none", 1024, 4096, 1024, False),   # Transformer FFN up, xLSTM mLSTM up
    ("none", 4096, 1024, 4096, False),   # Transformer FFN down
    ("none", 1024, 2048, 1024, False),   # xLSTM sLSTM gates
    ("none", 1024, 1408, 1024, False),   # xLSTM FFN up
    ("none", 1408, 1024, 1408, False),   # xLSTM FFN down
    ("none", 1024, 4352, 1024, False),   # kernels I and J's probe width
    ("none", 1000, 1000, 1000, False),   # ragged N and K
    ("none", 4096, 1016, 4096, False),   # ragged N
    ("none", 8, 1, 8, False),            # one step, one column
    ("none", 1004, 1024, 1004, True),    # K % 8 != 0
    ("none", 8200, 1024, 8200, True),    # K past the staged 8192
]


@pytest.mark.parametrize("quant,k,n,qgroup,refused", _SHAPE_CASES)
def test_int8_gemv_shape_guard(quant, k, n, qgroup, refused):
    err = dk.gemv_shape_error(k, n, qgroup, quant)
    assert (err is not None) == refused, err
    assert dk.gemv_shape_error(k, n, qgroup, quant, rows=dk.MAX_ROWS + 1) is not None
    assert (dk.gemv_shape_error(k, n, qgroup, quant, rows=dk.MAX_ROWS) is not None) == refused
    if quant == "none":  # every wrapper's check of a bf16 pack, on the CPU, before any launch
        w = torch.zeros(n, k, dtype=torch.bfloat16)
        if refused:
            with pytest.raises(ValueError, match="GEMV kernels"):
                dk._weights(w, None, quant, n, k, w.device)
        else:
            assert dk._weights(w, None, quant, n, k, w.device) == 0
    elif qgroup == 256:  # the Mamba / Transformer wrappers' check, on the CPU, before any launch
        w = torch.zeros(n, k, dtype=torch.int8)
        s = torch.zeros(k // 256, n)
        if refused:
            with pytest.raises(ValueError, match="int8 GEMV kernels"):
                dk._weights(w, s, quant, n, k, w.device)
        else:
            assert dk._weights(w, s, quant, n, k, w.device) == s.data_ptr()


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
