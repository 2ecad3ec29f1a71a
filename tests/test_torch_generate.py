"""Kernel C's plain version (musicgen_tpu_torch.ops.generate_kernel
fused_generate_plain: the resident loop token by token) vs the TPU kernel
itself, musicgen_tpu/ops/pallas_generate.py `fused_generate`, run in
interpret mode on the same weights, prefill states and penalty window.

Greedy streams must be identical. The stochastic picks invert the CDF of
streamed uniforms: fed JAX's own `jax.random.uniform(rng, (n, B, 2))`, the
port must emit the same stream. Both sides round activations to bf16 before
each product with f32 sums in another order; the final states agree within
rel 1e-4 (about 1e-7 at this size, where no bf16 rounding flips).
The W8A16 run is in test_torch_generate_w8a16.py (one interpret compile per
file keeps each file short)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.config import NUM_META, MambaConfig
from musicgen_tpu.models.mamba import MambaLM as JaxMambaLM
from musicgen_tpu.ops import pallas_decode as jd
from musicgen_tpu.ops import pallas_generate as jg
from musicgen_tpu.sample import sampler as js
from musicgen_tpu_torch.config import MambaConfig as PortMambaConfig
from musicgen_tpu_torch.interop import from_jax_params, load_model
from musicgen_tpu_torch.ops import decode_kernel as dk
from musicgen_tpu_torch.ops import generate_kernel as gk
from musicgen_tpu_torch.sample import sampler as ts

B, P, N = 2, 64, 6
STATE_RTOL = 1e-4


def port_cfg(cfg):
    """The port's MambaConfig with the fields of a JAX one."""
    return PortMambaConfig(**dataclasses.asdict(cfg))


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
                 / np.abs(np.asarray(b, np.float64)).max())


def make_setup(jax_quant: str):
    """A small model on both sides, its prefill from JAX, and the prefill
    top-3 (sample/sampler's plain tail) that seeds the loop."""
    cfg = MambaConfig(d_model=128, n_layers=2)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    meta = rng.integers(0, cfg.metadata_vocab_size, (B, NUM_META)).astype(np.int32)
    jm = JaxMambaLM(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(prompt[:, :8]), jnp.asarray(meta))
    logits, states = jax.jit(lambda p, t, m: jm.apply(p, t, m, method=JaxMambaLM.prefill))(
        params, jnp.asarray(prompt), jnp.asarray(meta))
    conv, ssm = (np.asarray(a) for a in jd.stack_states(states))
    pen = js.init_penalty_state(jnp.asarray(prompt), 2048)
    w0 = js.filtered_logits(jnp.asarray(prompt[:, -1]), logits[:, -1, :]) / js.penalty_divisor(pen.hist)
    vals0, idxs0 = (np.array(a) for a in js._iter_top_k(w0, 3))
    port = load_model(from_jax_params(jax.tree.map(np.asarray, params), port_cfg(cfg)), "cpu")
    return dict(cfg=cfg, prompt=prompt, params=params, conv=conv, ssm=ssm, pen=pen, vals0=vals0, idxs0=idxs0,
                port=port, jdp=jd.build_decode_params(params, cfg, B, quant=jax_quant))


def compare_with_jax(s, greedy: bool, quant: str, seed: int):
    """Run JAX's fused_generate(interpret=True) and the port's plain loop
    from the same inputs; returns (jax (toks, conv, ssm), port (...))."""
    cfg, prompt, pen = s["cfg"], s["prompt"], s["pen"]
    key = jax.random.PRNGKey(seed)
    jt, jc, jsm = jg.fused_generate(
        s["jdp"], jnp.asarray(s["vals0"]), jnp.asarray(s["idxs0"]), jnp.asarray(prompt[:, -1]),
        jnp.asarray(s["conv"]), jnp.asarray(s["ssm"]), pen.hist, pen.ring_tok, pen.ring_c, pen.start, pen.head,
        pen.wsum, key, jd.DecodeDims.create(cfg, B), N, greedy=greedy, interpret=True,
        quant_mode="w8a8" if quant == "none" else quant,
    )
    u = None if greedy else torch.from_numpy(np.array(jax.random.uniform(key, (N, B, 2), jnp.float32)))
    dims = dk.DecodeDims.create(s["port"].cfg, B)
    dp = dk.build_decode_params(s["port"], B, "bf16" if quant == "none" else "int8")
    tp = torch.from_numpy(prompt.astype(np.int64))
    toks, conv, ssm = gk.fused_generate(
        dp, torch.from_numpy(s["vals0"]), torch.from_numpy(s["idxs0"].astype(np.int64)), tp[:, -1],
        torch.from_numpy(s["conv"].copy()), torch.from_numpy(s["ssm"].copy()), ts.init_penalty_state(tp, 2048),
        u, dims, N, greedy, quant,
    )
    return (np.asarray(jt), np.asarray(jc), np.asarray(jsm)), (toks.numpy(), conv.numpy(), ssm.numpy())


@pytest.fixture(scope="module")
def setup():
    return make_setup("bf16")


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "stochastic"])
def test_resident_plain_matches_pallas_generate(setup, greedy):
    (jt, jc, jsm), (toks, conv, ssm) = compare_with_jax(setup, greedy, "none", seed=7)
    np.testing.assert_array_equal(toks, jt)
    assert _rel(conv, jc) < STATE_RTOL and _rel(ssm, jsm) < STATE_RTOL


def test_pick_plain_inverts_the_cdf():
    """k from u_k against the field's P(k=1), P(k=2); the pick from u_p
    against the cumulative candidate weights (pallas_generate.py:159-183)."""
    vals = torch.tensor([[6.0, 3.0, 1.0]] * 4)
    idxs = torch.tensor([[10, 20, 30]] * 4)
    last = torch.tensor([5, 5, 5, 5])  # a pitch: k in {1, 2} with 0.5 each
    u = torch.tensor([[0.4, 0.99], [0.6, 0.5], [0.6, 0.7], [0.99, 0.99]])
    # k=1 -> always the top; k=2: r = u_p * 9 against 6.
    assert gk.pick_plain(vals, idxs, last, u, greedy=False).tolist() == [10, 10, 20, 20]
    assert gk.pick_plain(vals, idxs, last, u, greedy=True).tolist() == [10] * 4


def test_resident_plain_greedy_matches_fused_tail(setup):
    """The port's copy of tests/test_pallas_generate.py
    test_resident_greedy_matches_fused_tail: the resident loop and the
    per-token fused-tail sampler emit the same greedy stream."""
    port, prompt = setup["port"], torch.from_numpy(setup["prompt"].astype(np.int64))
    meta = torch.zeros(B, NUM_META, dtype=torch.int64)
    dims = dk.DecodeDims.create(port.cfg, B)
    dp = dk.build_decode_params(port, B)
    prefill, _ = ts.make_sampler(port, "mamba", dp)
    with torch.no_grad():
        logits, carry = prefill(prompt, meta)
        cfg = ts.SamplerConfig(num_tokens=16, greedy=True, ring_size=2048)
        ref = ts.sample_tokens_fused_tail(dp, logits, (carry[0].clone(), carry[1].clone()), prompt, cfg,
                                          torch.Generator(), ts.fused_tail_step(port, "mamba", B, "bf16"))
        out = gk.generate_resident(dp, logits, carry, prompt, 16, dims, None, greedy=True)
    assert torch.equal(out[:, :P], prompt)
    assert torch.equal(out[:, P:], ref)
