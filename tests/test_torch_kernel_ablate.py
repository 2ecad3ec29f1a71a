"""Kernel J's variants (musicgen_tpu_torch.ops.ablate_kernel) and the
ablation's entry point (musicgen_tpu_torch.experiments.kernel_ablate)
against experiments/kernel_ablate.py's `call_variant(make_variant(mode))` in
interpret mode.

The JAX script builds a full-size model at import, so `make_variant` and
`call_variant` are taken out of the file with `ast` and run in a namespace
that holds this test's small pack (`dp`, `dims`) and a `pl` whose
pallas_call runs in interpret mode; nothing under experiments/ is imported or
edited. Both sides start from the same weights (JAX params ->
interop.from_jax_params -> load_model -> build_decode_params) and the same
states. The port's pack zero-pads the lm_head to the padded vocabulary; the
JAX pack's pad columns are zeroed to match, so the logits compare over the
padded vocabulary. Tolerances: logits to 1e-4 of the largest (f32 sums in
another order, which can flip one bf16 rounding of an activation), states
to 1e-6 of the largest."""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from musicgen_tpu.config import NUM_META, MambaConfig
from musicgen_tpu.models.mamba import MambaLM as JaxMambaLM
from musicgen_tpu.ops import pallas_decode as jd
from musicgen_tpu_torch.config import MambaConfig as PortMambaConfig
from musicgen_tpu_torch.experiments import kernel_ablate as ka
from musicgen_tpu_torch.interop import from_jax_params, load_model
from musicgen_tpu_torch.ops import ablate_kernel as ak
from musicgen_tpu_torch.ops import decode_kernel as dk
from tests.test_torch_probe_mm import extract, interpret_pl

REPO = Path(__file__).resolve().parents[1]
B, P = 2, 16
TOL_LOGITS, TOL_STATES = 1e-4, 1e-6


@pytest.fixture(scope="module")
def setup():
    cfg = MambaConfig(d_model=256, n_layers=2)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (B, P))
    meta = rng.integers(0, cfg.metadata_vocab_size, (B, NUM_META))
    params = jax.jit(JaxMambaLM(cfg).init)(jax.random.PRNGKey(0), jnp.asarray(prompt[:, :8]), jnp.asarray(meta))
    port = load_model(from_jax_params(jax.tree.map(np.asarray, params), PortMambaConfig(**dataclasses.asdict(cfg))),
                      "cpu")
    with torch.no_grad():
        _, states = port.prefill(torch.from_numpy(prompt), torch.from_numpy(meta))
    jdims = jd.DecodeDims.create(cfg, B)
    jdp = jd.build_decode_params(params, cfg, B)
    jdp["lm_w"] = jdp["lm_w"].at[:, cfg.vocab_size:].set(0)
    ns = {"jax": jax, "jnp": jnp, "pl": interpret_pl(), "pltpu": pltpu, "dims": jdims, "dp": jdp,
          "_ROWS": jd._ROWS, "_HEAD_CHUNKS": jd._HEAD_CHUNKS, "_dot": jd._dot}
    make_variant, call_variant = extract(REPO / "experiments" / "kernel_ablate.py", ["make_variant", "call_variant"],
                                         ns)
    dims = dk.DecodeDims.create(port.cfg, B)
    dp = dk.build_decode_params(port, B)
    return {"dims": dims, "dp": dp, "carry": dk.stack_states(states), "make_variant": make_variant,
            "call_variant": call_variant}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("mode", ["dma", "mm", "nossd"])
@pytest.mark.parametrize("ops", ["plain", "wrappers"])
def test_variant_step_matches_call_variant(setup, mode, ops):
    dims, dp = setup["dims"], setup["dp"]
    token = torch.tensor([5, 7])
    x0 = torch.nn.functional.embedding(token, dp["embed"])
    conv, ssm = setup["carry"]
    logits_j, conv_j, ssm_j = setup["call_variant"](setup["make_variant"](mode), jnp.asarray(x0.numpy()),
                                                    (jnp.asarray(conv.numpy()), jnp.asarray(ssm.numpy())))
    carry = (conv.clone(), ssm.clone())
    variants = ak.PLAIN_VARIANTS if ops == "plain" else ak.VARIANTS  # CPU tensors: the wrappers' plain versions
    with torch.no_grad():
        logits = dk.decode_logits(dp, token, carry, dims, ops=variants[mode])
    assert logits.shape == (B, dims.padded_vocab)
    assert _rel(logits, np.asarray(logits_j)[:B]) <= TOL_LOGITS
    assert _rel(carry[0], conv_j) <= TOL_STATES and _rel(carry[1], ssm_j) <= TOL_STATES
    if mode != "nossd":  # the states pass through
        assert torch.equal(carry[0], conv) and torch.equal(carry[1], ssm)
    else:
        assert torch.allclose(carry[1], ssm * ak.NOSSD_DECAY, rtol=0, atol=0)


def test_stream_layer_plain_reads_every_weight_word():
    """The checksum V_dma's kernel can write: the XOR of every 32-bit word
    of w_in and w_out, here against numpy's."""
    rng = np.random.default_rng(3)
    w_in = torch.from_numpy(rng.standard_normal((20, 8)).astype(np.float32)).to(torch.bfloat16)
    w_out = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    conv, ssm = torch.ones(2, 3, 4), torch.full((6, 8), 2.0)
    sink = torch.zeros(1, dtype=torch.int32)
    out = ak.stream_layer(x, w_in, w_out, conv, ssm, sink=sink)
    words = np.concatenate([w.view(torch.int32).numpy().ravel() for w in (w_in, w_out)])
    assert int(sink) == int(np.bitwise_xor.reduce(words))
    want = x + w_in[:8, :2].t().float() * 1e-6 + w_out[:8, :2].t().float() * 1e-6
    assert torch.equal(out, want)
    assert torch.equal(conv, torch.ones(2, 3, 4)) and torch.equal(ssm, torch.full((6, 8), 2.0))


def test_variants_have_the_same_slots():
    assert sorted(ak.VARIANTS) == sorted(ak.PLAIN_VARIANTS) == sorted(ka.MODES)
    for mode in ka.MODES:
        assert len(ak.VARIANTS[mode]) == len(ak.PLAIN_VARIANTS[mode]) == 5 and ak.VARIANTS[mode][4] is None
    assert {m: sum(ak.step_launches(m, 10).values()) for m in ka.MODES} == {"dma": 11, "mm": 21, "nossd": 31,
                                                                            "full": 31}


def test_kernel_ablate_run_on_cpu(capsys):
    out = ka.run("cpu", cfg=PortMambaConfig(d_model=256, n_layers=2), steps=2)
    printed = capsys.readouterr().out
    assert all(f"V_{m}" in printed for m in ka.MODES)
    assert out["device"] == "cpu" and out["split"] is None
    for mode in ka.MODES:
        r = out[mode]
        assert r["us_step"] > 0 and r["plain_us_step"] > 0 and r["graph_us_step"] is None
        assert r["bytes_step"] == out["bytes_weights"] + (0 if mode == "mm" else out["bytes_states"])


def test_kernel_ablate_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        ka.main(["--device", "cuda"])
