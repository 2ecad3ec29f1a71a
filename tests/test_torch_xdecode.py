"""Kernel G's plain versions (musicgen_tpu_torch.ops.xdecode_kernel) vs the
TPU kernel (musicgen_tpu/ops/pallas_xlstm_decode.py, interpret mode), with
bf16 weights and an f32 matrix memory; tests/test_torch_xdecode_w8a16.py
and tests/test_torch_xdecode_sb16.py run the same checks on the W8A16 pack
and on the bf16-stored matrix memory.

The pack is exact where the layouts share a form (after the transpose to
torch's (out, in); the real vocab rows of the padded lm_head). One step of
the plain chain from the JAX kernel's state agrees with it to 1e-3 of the
largest logit, and its states to 1e-3 of their largest entry: both round
activations to bf16 before each product and sum in f32, in another order.
Teacher-forced, the chain agrees with the plain f32 XLSTMLM.step at the JAX
test's tolerances (0.05 of the largest logit in bf16, 0.12 in W8A16,
tests/test_pallas_xlstm_decode.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.config import NUM_META
from musicgen_tpu.config import XLSTMConfig as JaxXLSTMConfig
from musicgen_tpu.models.xlstm import XLSTMLM as JaxXLSTMLM
from musicgen_tpu.ops import pallas_xlstm_decode as jxd
from musicgen_tpu.sample.sampler import field_bucket as jax_field_bucket
from musicgen_tpu_torch.config import XLSTMConfig
from musicgen_tpu_torch.interop import from_jax_params, load_model
from musicgen_tpu_torch.ops import xdecode_kernel as xk
from musicgen_tpu_torch.ops.grammar import field_bucket

B, P = 2, 24
STEP_REL = 1e-3
F32_TOL = {"bf16": 0.05, "int8w": 0.12}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


_unstack = jax.jit(jxd.unstack_xlstm_states, static_argnums=(1, 2))


def _torch_states(jstates):
    """JAX per-block states -> the port's (f32 torch tensors)."""
    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    out = []
    for st in jstates:
        kind = "slstm" if "slstm" in st else "mlstm"
        out.append({"conv": t(st["conv"]), kind: tuple(t(x) for x in st[kind])})
    return tuple(out)


def random_params(jm, prompt, meta, seed: int = 0):
    """Seeded numpy weights in the flax tree of `jm` (shapes from eval_shape,
    which compiles nothing): lecun-normal matrices (std 1/sqrt(fan_in)),
    N(0, 1) embeddings, unit scales, biases of std 0.1 and the mLSTM
    forget-gate bias 3.0 of the JAX initializers."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(prompt[:, :8]), jnp.asarray(meta))

    def fill(path, leaf):
        name, parent = path[-1].key, path[-2].key if len(path) > 1 else ""
        if name in ("scale", "outnorm_scale", "learnable_skip", "gn_scale"):
            return np.ones(leaf.shape, np.float32)
        if parent == "fgate" and name == "bias":
            return np.full(leaf.shape, 3.0, np.float32)
        std = 1.0 if name == "embedding" else 0.1 if name == "bias" or leaf.ndim < 2 else leaf.shape[-2] ** -0.5
        return (std * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def make_setup(quant: str, sb16: bool = False, embedding_dim: int = 64):
    """A small model on both sides (3 blocks of width 64, sLSTM at 1), one
    JAX prefill, both packs in `quant` and both stacked states."""
    jcfg = JaxXLSTMConfig(embedding_dim=embedding_dim, num_blocks=3, slstm_at=(1,), metadata_vocab_size=16)
    cfg = XLSTMConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (B, P))
    meta = rng.integers(0, cfg.metadata_vocab_size, (B, NUM_META))
    jm = JaxXLSTMLM(jcfg)
    params = random_params(jm, prompt, meta)
    logits0, jstates = jax.jit(lambda p, t, m: jm.apply(p, t, m, method=JaxXLSTMLM.prefill))(
        params, jnp.asarray(prompt), jnp.asarray(meta))
    port = load_model(from_jax_params(params, cfg), "cpu")
    sdt = torch.bfloat16 if sb16 else torch.float32
    jdims, dims = jxd.XDims.create(jcfg, B), xk.XDims.create(cfg, B)
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, params=params, port=port, logits0=np.asarray(logits0), jdims=jdims,
                dims=dims, jstates=jstates, sdt=sdt, quant=quant, rng=rng,
                jcarry=jax.jit(jxd.stack_xlstm_states, static_argnums=(1, 2, 3))(
                    jstates, jcfg, B, jnp.bfloat16 if sb16 else jnp.float32),
                jwp=jax.jit(jxd.build_xlstm_decode_params, static_argnums=(1, 2, 3))(params, jcfg, B, quant),
                wp=xk.build_xlstm_decode_params(port, B, quant))


def _port_carry(s, jcarry):
    """The port's stacked carry holding the JAX kernel's carry."""
    states = _torch_states(_unstack(jcarry, s["jcfg"], B))
    return xk.stack_xlstm_states(states, s["dims"], s["sdt"])


def check_pack(s):
    """The int8 values exactly; their scales to one f32 ulp (the jitted JAX
    pack divides by 127 as a product with its reciprocal)."""
    jwp, wp, v = s["jwp"], s["wp"], s["cfg"].vocab_size
    int8 = s["quant"] != "bf16"
    H = s["dims"].heads
    for name in ("m_w_up", "m_w_down", "s_w_if", "s_w_zo", "s_ffn_up", "s_ffn_down"):
        np.testing.assert_array_equal(wp[name].float().transpose(1, 2).numpy(), np.asarray(jwp[name], np.float32),
                                      err_msg=name)
        if int8:
            np.testing.assert_allclose(wp[name + "_s"].numpy(), np.asarray(jwp[name + "_s"]), rtol=2.4e-7,
                                       err_msg=name)
    lm = np.asarray(jwp["lm_w"], np.float32)[:, :v]
    np.testing.assert_array_equal(wp["lm_w"][:v].float().numpy().T, lm)
    if int8:
        np.testing.assert_allclose(wp["lm_s"][:, :v].numpy(), np.asarray(jwp["lm_s"])[:, :v], rtol=2.4e-7)
    for name in ("s_r_w", "m_w_gate", "s_bias", "m_ln", "s_ln", "s_ln_ffn", "m_conv_w", "s_conv_w", "ln_f"):
        np.testing.assert_array_equal(wp[name].float().numpy(), np.asarray(jwp[name], np.float32), err_msg=name)
    np.testing.assert_array_equal(wp["m_gate_b"].numpy(), np.asarray(jwp["m_gate_b"])[:, 0, :2 * H])
    for name, jname in (("m_conv_b",) * 2, ("s_conv_b",) * 2, ("m_outnorm",) * 2, ("m_skip",) * 2,
                        ("s_gn", "s_gn_scale"), ("s_ffn_up_b",) * 2, ("s_ffn_down_b",) * 2):
        np.testing.assert_array_equal(wp[name].numpy(), np.asarray(jwp[jname])[:, 0], err_msg=name)


def check_state_roundtrip(s):
    """stack -> unstack returns XLSTMLM.prefill's states exactly (f32
    storage), or rounded to bf16 once (the matrix memory under -sb16)."""
    with torch.no_grad():
        _, states = s["port"].prefill(torch.from_numpy(s["rng"].integers(0, 100, (B, P))),
                                      torch.zeros(B, NUM_META, dtype=torch.int64))
    back = xk.unstack_xlstm_states(xk.stack_xlstm_states(states, s["dims"], s["sdt"]), s["dims"])
    for st, bk in zip(states, back):
        kind = "slstm" if "slstm" in st else "mlstm"
        assert torch.equal(st["conv"], bk["conv"])
        for i, (a, b) in enumerate(zip(st[kind], bk[kind])):
            want = a.to(s["sdt"]).float() if (kind, i) == ("mlstm", 0) else a
            assert torch.equal(b, want), (kind, i)


def check_logits_steps(s, n_steps=2, ops=xk.PLAIN_OPS):
    """Each step from the JAX kernel's carry: the plain chain's logits and
    new carry against fused_xlstm_logits_step(interpret=True)'s."""
    jstep = jax.jit(lambda wp, tok, carry: jxd.fused_xlstm_logits_step(wp, tok, carry, s["jcfg"], s["jdims"],
                                                                        interpret=True))
    q = xk.QUANT_MODES[s["quant"]]
    jcarry = s["jcarry"]
    tok = np.argmax(s["logits0"][:, -1], -1)
    for _ in range(n_steps):
        carry = _port_carry(s, jcarry)
        want, jcarry = jstep(s["jwp"], jnp.asarray(tok, jnp.int32), jcarry)
        with torch.no_grad():
            got, carry = xk.fused_xlstm_logits_step(s["wp"], torch.from_numpy(tok), carry, s["dims"], q, ops=ops)
        assert got.shape == (B, s["cfg"].vocab_size)
        assert _rel(got, want) < STEP_REL
        for a, b in zip(carry, _port_carry(s, jcarry)):
            assert a.dtype == b.dtype
            assert _rel(a.float(), b.float()) < STEP_REL
        tok = np.asarray(np.argmax(np.asarray(want), -1))


def check_sample_step(s):
    """The step with the tail (grammar, penalty, top-3) against
    fused_xlstm_sample_step(interpret=True) from the same carry and window."""
    v = s["cfg"].vocab_size
    rng = s["rng"]
    tok = rng.integers(0, v, (B,))
    hist = rng.integers(0, 3, (B, v)).astype(np.int32)
    bucket = np.asarray(jax_field_bucket(jnp.asarray(tok)))
    bucket_oh = np.eye(8, dtype=np.float32)[bucket]
    jv, ji, _ = jxd.fused_xlstm_sample_step(s["jwp"], jnp.asarray(tok, jnp.int32), s["jcarry"], jnp.asarray(hist),
                                            jnp.asarray(bucket_oh), s["jcfg"], s["jdims"], interpret=True)
    tt = torch.from_numpy(tok)
    np.testing.assert_array_equal(field_bucket(tt).numpy(), bucket)
    with torch.no_grad():
        vals, idxs, _ = xk.fused_xlstm_sample_step(s["wp"], tt, _port_carry(s, s["jcarry"]), torch.from_numpy(hist),
                                                   field_bucket(tt), s["dims"], xk.QUANT_MODES[s["quant"]],
                                                   ops=xk.PLAIN_OPS)
    assert _rel(vals, jv) < STEP_REL
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(ji))


def check_steps_match_f32_step(s, n_steps=6):
    """Teacher-forced from one prefill: the plain chain on its own carry
    against XLSTMLM.step on its own states, fed the same tokens."""
    port, q = s["port"], xk.QUANT_MODES[s["quant"]]
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, s["cfg"].vocab_size, (B, P)))
    meta = torch.from_numpy(rng.integers(0, s["cfg"].metadata_vocab_size, (B, NUM_META)))
    with torch.no_grad():
        logits, states = port.prefill(prompt, meta)
        carry = xk.stack_xlstm_states(states, s["dims"], s["sdt"])
        tok = logits[:, -1].argmax(-1)
        tol = F32_TOL[s["quant"]]
        for _ in range(n_steps):
            ref, states = port.step(tok, states)
            got, carry = xk.fused_xlstm_logits_step(s["wp"], tok, carry, s["dims"], q, ops=xk.PLAIN_OPS)
            assert _rel(got, ref) < tol
            tok = ref.argmax(-1)


@pytest.fixture(scope="module")
def setup():
    return make_setup("bf16")


def test_pack_matches_jax(setup):
    check_pack(setup)


def test_state_stack_roundtrip(setup):
    check_state_roundtrip(setup)


def test_logits_steps_match_pallas_kernel(setup):
    check_logits_steps(setup)


def test_sample_step_matches_pallas_kernel(setup):
    check_sample_step(setup)


def test_steps_match_f32_step(setup):
    check_steps_match_f32_step(setup)


def test_kernel_launch_count_at_the_reference_size():
    """68 launches a token at 7 mLSTM + 4 sLSTM blocks with the tail on the
    chain; 2 on the one-launch path (the step and the tail)."""
    dims = xk.XDims.create(XLSTMConfig(), B)
    assert (dims.n_mlstm, dims.n_slstm, dims.ffn_pad, dims.m_dh, dims.s_dh) == (7, 4, 1408, 512, 256)
    assert dims.launches_per_token() == 68 and dims.launches_per_token(tail=False) == 67
    assert dims.launches_per_token(step=True) == 2 and dims.launches_per_token(tail=False, step=True) == 1
