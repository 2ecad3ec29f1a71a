"""GPTQ packs of the port (musicgen_tpu_torch.ops.gptq) against the JAX
package's (musicgen_tpu/ops/gptq.py) on the same numpy inputs, at a small
size on the CPU: the solver bit for bit, the calibration moments at 1e-5
relative (f32 products summed in float64 in another order), the Mamba and
xLSTM packs bit for bit given the same moments, and greedy generation on
those packs equal to the JAX package's up to a near-tie, for the Mamba
model here and the xLSTM in tests/test_torch_gptq_xlstm.py. The CLI's
int8w-gptq drive is in tests/test_torch_cli.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.ops import gptq as jg
from musicgen_tpu.ops.pallas_decode import build_decode_params as jax_build_decode_params
from musicgen_tpu.ops.pallas_xlstm_decode import build_xlstm_decode_params as jax_build_xlstm_decode_params
from musicgen_tpu_torch.ops import gptq as tg
from musicgen_tpu_torch.ops.decode_kernel import build_decode_params, quantize_cols
from musicgen_tpu_torch.ops.grammar import filtered_logits
from musicgen_tpu_torch.ops.xdecode_kernel import BIG, build_xlstm_decode_params
from musicgen_tpu_torch.sample import sampler as ts
from tests.torch_families import BLOCK, family, grammatical, jax_generate, metas, port_generate, prompts

N = 6  # new tokens of a generation
SEPARATED = 1e-3  # a top-1 this far ahead of the second (relative) is every route's pick
HESS_RTOL = 1e-5


def _moment(rng, k, dead=()):
    x = rng.standard_normal((4 * k, k)) * rng.uniform(0.2, 3.0, k)
    x[:, list(dead)] = 0.0
    return x.T @ x / x.shape[0]


@pytest.mark.parametrize("k,n,dead", [(512, 48, ()), (300, 40, ()), (256, 32, (3, 17, 200))],
                         ids=["k512", "k300_one_group", "dead_inputs"])
def test_gptq_quantize_is_jax_bit_for_bit(k, n, dead):
    """The same float64 (w, H) give the same (q, s) bits: K-groups of 256,
    one group at K = 300, and dead inputs (zero moment) zeroed."""
    rng = np.random.default_rng(k)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32).astype(np.float64)
    h = _moment(rng, k, dead)
    q, s = tg.gptq_quantize(w, h)
    jq, js = jg.gptq_quantize(w, h)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    if dead:
        assert not q[list(dead)].any()


def _batches(kind, n=2, t=24):
    return [(prompts(2, t, seed=10 + i), metas(2, seed=10 + i)) for i in range(n)]


def calibrate(kind):
    """The small `kind` model's calibration, shared by a module's tests:
    the JAX package's moments and the port's, and the port's and JAX's
    GPTQ packs solved against JAX's moments."""
    jm, params, port = family(kind)
    sites = jg.CALIB_SITES if kind == "mamba" else jg.XLSTM_CALIB_SITES
    batches = _batches(kind)
    jh = jg.collect_hessians(jm, params, [(jnp.asarray(t), jnp.asarray(m)) for t, m in batches], sites=sites)
    th = tg.collect_hessians(port, [(torch.from_numpy(t).long(), torch.from_numpy(m).long()) for t, m in batches],
                             tg.CALIB_SITES if kind == "mamba" else tg.XLSTM_CALIB_SITES)
    return {"kind": kind, "jh": jh, "th": th, "port_pack": _port_pack(kind, tg.make_gptq_quantizer(jh)),
            "jax_pack": _jax_pack(kind, jg.make_gptq_quantizer(jh))}


@pytest.fixture(scope="module")
def calibrated():
    """The Mamba model's moments (tests/test_torch_gptq_xlstm.py runs the
    tests below on the xLSTM's)."""
    return calibrate("mamba")


def test_collect_hessians_matches_jax(calibrated):
    """The port's forward pre-hooks read the inputs JAX's interceptor reads,
    under the same site keys; their moments agree at 1e-5 relative."""
    kind, jh, th = calibrated["kind"], calibrated["jh"], calibrated["th"]
    assert sorted(th) == sorted(jh)
    assert "lm_head" in th and len(th) == (5 if kind == "mamba" else 9)  # 2 layers; 2 mLSTM + 1 sLSTM blocks
    for key, want in jh.items():
        got = th[key]
        assert got.dtype == np.float64 and got.shape == want.shape
        assert np.abs(got - want).max() <= HESS_RTOL * np.abs(want).max(), key


def _port_pack(kind, quantizer=None):
    port = family(kind)[2]
    build = build_decode_params if kind == "mamba" else build_xlstm_decode_params
    return build(port, 2, "int8w", quantizer)


def _jax_pack(kind, quantizer):
    jm, params, _ = family(kind)
    build = jax_build_decode_params if kind == "mamba" else jax_build_xlstm_decode_params
    return build(params, jm.cfg, 2, quant="int8w", quantizer=quantizer)


# port pack key -> JAX pack key; the port's matrices are (out, in), JAX's (in, out)
_MAMBA_KEYS = {"w_in": "w_in", "w_out": "w_out", "lm_w": "lm_w", "w_in_s": "w_in_s", "w_out_s": "w_out_s",
               "lm_s": "lm_s"}
_XLSTM_KEYS = {k: k for k in BIG + tuple(f"{k}_s" for k in BIG if k != "lm_w") + ("lm_s",)}


def test_gptq_packs_match_jax(calibrated):
    """Given the JAX package's moments, the port's Mamba and xLSTM packs
    hold JAX's q and s bit for bit: q transposed to (out, in), over the
    columns both packs hold (JAX pads in_proj's columns and holds lm_head's
    padded vocabulary columns from the model; the port pads with zeros)."""
    kind, got, want = calibrated["kind"], calibrated["port_pack"], calibrated["jax_pack"]
    keys = _MAMBA_KEYS if kind == "mamba" else _XLSTM_KEYS
    v = family(kind)[2].cfg.vocab_size
    for pk, jk in keys.items():
        g, w = got[pk], np.asarray(want[jk])
        if g.dtype == torch.int8:
            g = g.transpose(-1, -2)
        g = g.numpy()
        n = v if pk in ("lm_w", "lm_s") else g.shape[-1]
        np.testing.assert_array_equal(g[..., :n], w[..., :n], err_msg=pk)


def test_quantizer_without_moments_is_the_rtn_pack(calibrated):
    """quantizer=None keeps the RTN pack; a quantizer whose sites have no
    moment falls back to quantize_cols, bit for bit the same pack; a GPTQ
    pack differs from RTN but keeps its layout."""
    kind, th = calibrated["kind"], calibrated["th"]
    rtn = _port_pack(kind)
    empty = _port_pack(kind, tg.make_gptq_quantizer({}))
    gptq = _port_pack(kind, tg.make_gptq_quantizer(th))
    assert sorted(rtn) == sorted(empty) == sorted(gptq)
    for k in rtn:
        assert torch.equal(rtn[k], empty[k]), k
        assert gptq[k].shape == rtn[k].shape and gptq[k].dtype == rtn[k].dtype, k
    assert not torch.equal(rtn["lm_w"], gptq["lm_w"])
    w = family(kind)[2].output_layer.weight.detach()
    assert torch.equal(quantize_cols(w)[0], tg.make_gptq_quantizer({})("lm_head", w)[0])


def test_gptq_quantizer_pads_the_moment_and_memoizes():
    """A weight padded along K takes the unpadded moment zero-padded (its
    pad inputs dead), and a second call of a site returns the first solve."""
    rng = np.random.default_rng(3)
    k, kp, n = 200, 256, 24
    h = _moment(rng, k)
    w = torch.zeros(n, kp)
    w[:, :k] = torch.from_numpy((rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32))
    quantize = tg.make_gptq_quantizer({"site": h})
    q, s = quantize("site", w)
    hp = np.zeros((kp, kp))
    hp[:k, :k] = h
    jq, js = jg.gptq_quantize(w.double().numpy().T, hp)
    np.testing.assert_array_equal(q.numpy(), jq.T)
    np.testing.assert_array_equal(s.numpy(), js)
    assert quantize("site", torch.zeros(n, kp))[0] is q


@torch.no_grad()
def _assert_equal_up_to_a_near_tie(kind, pack, got, want, prompt, meta):
    """`got` equals `want` row by row, or first differs where the port's
    W8A16 step on `pack`, teacher-forced over `want`, has no top-1 ahead of
    its second by SEPARATED; wherever it has one, `want` takes it."""
    port = family(kind)[2]
    prefill, step = ts.make_sampler(port, kind, pack, "int8w", BLOCK)
    prompt_t = torch.from_numpy(prompt).long()
    logits, state = prefill(prompt_t, torch.from_numpy(meta).long())
    pen, last, p = ts.init_penalty_state(prompt_t, 2048), prompt_t[:, -1], prompt.shape[1]
    want, near = torch.from_numpy(np.array(want)).long(), []
    for i in range(N):
        vals, top = ts._iter_top_k(filtered_logits(last, logits) / ts.penalty_divisor(pen.hist), 2)
        tok = want[:, p + i]
        lead = (vals[:, 0] - vals[:, 1]) > SEPARATED * vals[:, 0].abs()
        assert bool((tok == top[:, 0])[lead].all()), f"JAX's token {i} is not the port's top-1 at a separated step"
        near.append(~lead)
        pen = ts.push_token(pen, tok)
        logits, state = step(tok, state, p + i)
        last = tok
    near = torch.stack(near, dim=1)
    differ = got[:, p:] != want[:, p:]
    for row in differ.any(dim=1).nonzero().flatten().tolist():
        first = int(differ[row].nonzero()[0])
        assert bool(near[row, first]), f"row {row} differs at token {first}, where the top-1 leads"


def test_generate_on_a_gptq_pack_matches_jax(calibrated):
    """generate(decode_pack=) runs the family's W8A16 step on the given pack
    (its plain versions on the CPU): greedy, JAX's generate(decode_pack=)
    stream up to a near-tie, grammatical; the pack requires the kernel path."""
    kind, pack = calibrated["kind"], calibrated["port_pack"]
    prompt, meta = prompts(2, BLOCK, seed=3), metas(2, seed=3)
    got = port_generate(kind, prompt, meta, N, fused=True, quant="int8w", greedy=True, decode_pack=pack)
    want = jax_generate(kind, prompt, meta, N, fused=True, quant="int8w", greedy=True,
                        decode_pack=calibrated["jax_pack"])
    assert grammatical(got, BLOCK)
    _assert_equal_up_to_a_near_tie(kind, pack, got, want, prompt, meta)
    with pytest.raises(ValueError, match="requires the fused"):
        port_generate(kind, prompt, meta, N, fused=False, quant="int8w", decode_pack=pack)
