"""Kernel F's plain twins (musicgen_tpu_torch.ops.tdecode_kernel) vs the TPU
kernel (musicgen_tpu/ops/pallas_transformer_decode.py, interpret mode), in
bf16; tests/test_torch_tdecode_w8a16.py runs the same checks on the W8A16
pack.

The pack is exact (after the layout transpose; the real vocab rows of the
padded lm_head). One step of the plain twin chain from the JAX kernel's
state agrees with it to 1e-3 of the largest logit: both round activations to
bf16 before each product and sum in f32, in another order. Over a ring wrap the chain agrees
with the plain f32 TransformerLM.step at the JAX test's tolerances (0.05 of
the largest logit in bf16, 0.12 in W8A16,
tests/test_pallas_transformer_decode.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.config import NUM_META
from musicgen_tpu.config import TransformerConfig as JaxTransformerConfig
from musicgen_tpu.models.transformer import TransformerLM as JaxTransformerLM
from musicgen_tpu.ops import pallas_transformer_decode as jtd
from musicgen_tpu.sample.sampler import field_bucket as jax_field_bucket
from musicgen_tpu_torch.config import TransformerConfig
from musicgen_tpu_torch.interop import from_jax_params, load_model
from musicgen_tpu_torch.models.transformer import empty_model, init_weights_
from musicgen_tpu_torch.ops import tdecode_kernel as tk
from musicgen_tpu_torch.ops.grammar import field_bucket
from musicgen_tpu_torch.sample.cache import step_geometry, token_slot

B = 2
STEP_REL = 1e-3
WRAP_TOL = {"bf16": 0.05, "int8w": 0.12}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def make_setup(quant: str):
    """A small model on both sides (prompt = block_len, the kernel's steady
    state), both prefills and both packs in `quant`."""
    jcfg = JaxTransformerConfig(n_embd=256, n_heads=4, n_layer=2, block_len=32, attention_impl="xla")
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (B, cfg.block_len))
    meta = rng.integers(0, cfg.metadata_vocab_size, (B, NUM_META))
    jm = JaxTransformerLM(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(prompt[:, :8]),
                                                         jnp.asarray(meta)))
    logits0, jcaches = jax.jit(lambda p, t, m: jm.apply(p, t, m, method=JaxTransformerLM.prefill))(
        params, jnp.asarray(prompt), jnp.asarray(meta))
    port = load_model(from_jax_params(params, cfg), "cpu")
    with torch.no_grad():
        _, caches = port.prefill(torch.from_numpy(prompt), torch.from_numpy(meta))
    jdims, dims = jtd.TDims.create(jcfg, B), tk.TDims.create(cfg, B)
    jcarry = jtd.stack_transformer_cache(jcaches, jdims)
    # Eager, as the int8 scales are compared exactly.
    return dict(jcfg=jcfg, cfg=cfg, params=params, port=port, logits0=np.asarray(logits0), jdims=jdims, dims=dims,
                jcarry=jcarry, port_carry=tk.stack_transformer_cache(caches, dims),
                jtp=jtd.build_transformer_decode_params(params, jcfg, B, quant=quant),
                tp=tk.build_transformer_decode_params(port, B, quant), quant=quant, rng=rng)


def check_pack(s):
    jtp, tp, v = s["jtp"], s["tp"], s["cfg"].vocab_size
    int8 = s["quant"] != "bf16"
    for name in ("w_qkv", "w_proj", "w_fc", "w_out"):
        np.testing.assert_array_equal(tp[name].float().transpose(1, 2).numpy(), np.asarray(jtp[name], np.float32),
                                      err_msg=name)
        if int8:
            scales = name[2:] + "_s"
            np.testing.assert_array_equal(tp[scales].numpy(), np.asarray(jtp[scales]), err_msg=scales)
    for name in ("rel_ring", "rel_meta", "ln1", "ln2", "ln_f"):
        np.testing.assert_array_equal(tp[name].float().numpy(), np.asarray(jtp[name], np.float32), err_msg=name)
    for name in ("proj_b", "b_fc", "b_out"):
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jtp[name])[:, 0], err_msg=name)
    np.testing.assert_array_equal(tp["lm_w"].float().t().numpy()[:, :v], np.asarray(jtp["lm_w"], np.float32)[:, :v])
    if int8:
        np.testing.assert_array_equal(tp["lm_s"].numpy()[:, :v], np.asarray(jtp["lm_s"])[:, :v])
    np.testing.assert_array_equal(tp["lm_b"].numpy()[:v], np.asarray(jtp["lm_b"])[:v])
    np.testing.assert_array_equal(tp["embed"].numpy(), np.asarray(jtp["embed"])[:v])
    np.testing.assert_array_equal(tp["gram"].numpy(), np.asarray(jtp["gram8"])[:5])
    for got, want in zip(s["port_carry"], s["jcarry"]):  # the port's prefill, stacked
        assert got.dtype == torch.bfloat16 and _rel(got.float(), np.asarray(want, np.float32)) < 1e-2


def _torch_carry(jcarry):
    return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16) for a in jcarry)


def check_logits_steps(s, n_steps: int = 4):
    """n_steps of the plain twin chain vs JAX's kernel, each from JAX's rings
    of that step and fed JAX's argmax (from a shared state a bf16 rounding
    of the new K/V row that the f32 order flips would otherwise carry into
    every later step)."""
    q = tk.QUANT_MODES[s["quant"]]
    jcarry = s["jcarry"]
    tok = s["logits0"][:, -1].argmax(-1).astype(np.int32)
    p = s["cfg"].block_len
    for i in range(n_steps):
        carry = _torch_carry(jcarry)
        jl, jcarry = jtd.fused_transformer_logits_step(s["jtp"], jnp.asarray(tok), jcarry, s["jcfg"], s["jdims"],
                                                       jnp.int32(p + i), interpret=True, quant=s["quant"])
        with torch.no_grad():
            got, carry = tk.fused_transformer_logits_step(s["tp"], torch.from_numpy(tok).long(), carry, s["dims"],
                                                          p + i, q, ops=tk.PLAIN_OPS)
        assert _rel(got, jl) < STEP_REL, f"step {i}"
        for a, b in zip(carry, jcarry):  # the new K/V rows, written into the ring as JAX scatters them
            assert _rel(a.float(), np.asarray(b, np.float32)) < 1e-2
        tok = np.asarray(jl).argmax(-1).astype(np.int32)


def check_sample_step(s):
    q = tk.QUANT_MODES[s["quant"]]
    hist = np.zeros((B, s["cfg"].vocab_size), np.int32)
    np.add.at(hist, (np.arange(B)[:, None], s["rng"].integers(0, s["cfg"].vocab_size, (B, 40))), 1)
    tok = s["logits0"][:, -1].argmax(-1).astype(np.int32)
    p = s["cfg"].block_len
    bucket_oh = jax.nn.one_hot(jax_field_bucket(jnp.asarray(tok)), 8)
    jv, ji, _ = jtd.fused_transformer_sample_step(s["jtp"], jnp.asarray(tok), s["jcarry"], jnp.asarray(hist), bucket_oh,
                                                  s["jcfg"], s["jdims"], jnp.int32(p), interpret=True,
                                                  quant=s["quant"])
    carry = _torch_carry(s["jcarry"])
    t_tok = torch.from_numpy(tok).long()
    with torch.no_grad():
        vals, idxs, _ = tk.fused_transformer_sample_step(s["tp"], t_tok, carry, torch.from_numpy(hist),
                                                         field_bucket(t_tok), s["dims"], p, q, ops=tk.PLAIN_OPS)
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(ji))
    assert _rel(vals, jv) < STEP_REL


def check_ring_wrap(quant: str):
    """At a block of 8, 10 steps wrap the ring: the plain twin chain vs the
    plain f32 TransformerLM.step, each on its own state, fed the step's
    argmax."""
    cfg = TransformerConfig(n_embd=256, n_heads=4, n_layer=2, block_len=8, metadata_vocab_size=16)
    model = init_weights_(empty_model(cfg, "cpu"), seed=1).eval()
    gen = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (B, cfg.block_len), generator=gen)
    meta = torch.randint(0, cfg.metadata_vocab_size, (B, NUM_META), generator=gen)
    dims, tol = tk.TDims.create(cfg, B), WRAP_TOL[quant]
    tp = tk.build_transformer_decode_params(model, B, quant)
    with torch.no_grad():
        logits0, caches = model.prefill(prompt, meta)
        carry = tk.stack_transformer_cache(caches, dims)
        tok = logits0[:, -1].argmax(-1)
        for i in range(10):
            idx = cfg.block_len + i
            ages, base = step_geometry(idx + 1, cfg.block_len)
            ref, caches = model.step(tok, caches, token_slot(idx, cfg.block_len), ages, base)
            got, carry = tk.fused_transformer_logits_step(tp, tok, carry, dims, idx, tk.QUANT_MODES[quant],
                                                          ops=tk.PLAIN_OPS)
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=tol, atol=tol * float(ref.abs().max()),
                                       err_msg=f"step {i} ({quant})")
            tok = ref.argmax(-1)


@pytest.fixture(scope="module")
def setup():
    return make_setup("bf16")


def test_pack_matches_jax(setup):
    check_pack(setup)


def test_logits_steps_match_pallas_kernel(setup):
    check_logits_steps(setup)


def test_sample_step_matches_pallas_kernel(setup):
    check_sample_step(setup)


def test_ring_wrap_matches_plain_step():
    check_ring_wrap("bf16")


def test_tdims_and_quant_checks():
    d = tk.TDims.create(TransformerConfig(), 2)
    assert (d.d_model, d.n_heads, d.head_dim, d.d_ff, d.ring, d.padded_vocab) == (1024, 8, 128, 4096, 2048, 17920)
    with pytest.raises(ValueError, match="batch"):
        tk.TDims.create(TransformerConfig(), 9)
    with pytest.raises(ValueError, match="does not match"):
        tk.check_tpack({"qkv_s": None}, "none")
