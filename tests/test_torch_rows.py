"""Generation at more batch rows than one decode launch carries, and the
mixer kernels' item partition.

Rows. A decode launch carries at most MAX_ROWS = 8 rows (csrc/decode_ops.cuh
MAXR), where the JAX package's decode kernels pad any batch. So
sample/sampler.generate runs a kernel path of more rows in groups of 8, each
group's whole generation in turn. Held here on the CPU (the wrappers' plain
twins), greedy, at 9 and 16 rows:
  * the streams equal each row's own batch-1 run from its group's prefill
    bit for bit (a row's GEMV, mixer and tail arithmetic does not depend on
    the other rows; the prefill itself may round a row otherwise at another
    batch size, so the batch-1 run takes the row's slice of its group's);
  * against the plain step (fused=False, the model's f32 step, which rounds
    nothing to bf16): stepped over the kernel path's stream, every picked
    token is among the plain top-3, and is the plain top-1 wherever that one
    leads the second by more than SEPARATED (relative). The streams
    themselves need not be equal: the bf16 products flip near-ties, at any
    batch;
  * a Mamba or Transformer stream equals the JAX package's generate(fused=
    True) at the same batch (its kernel in interpret mode, 9 rows padded to
    16; the same rounding points, the f32 sums in another order) up to a
    near-tie: a row's first token that differs, if any, is one where the
    plain step's two best are within SEPARATED. The JAX xLSTM kernel path
    refuses 9 rows ("Incompatible shapes for broadcasting"), so the xLSTM is
    held to the JAX plain path instead.
Stochastic runs at 9 rows give the right shape and grammatical tokens. On a
tree whose generate does not group the rows every case here raises
("decode batch must be in 1..8").

Items. Kernel B's mixer launches a block, and kernel C deals a team, per
item (batch row, head, quarter of the head's state rows):
decode_kernel.mixer_state_items runs mixer_state_plain item by item and must
equal it bit for bit; the items cover every state row once; a layer through
the items matches the TPU kernel's `_mixer_math`.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.config import NUM_META, MambaConfig
from musicgen_tpu.config import TransformerConfig as JaxTransformerConfig
from musicgen_tpu.config import XLSTMConfig as JaxXLSTMConfig
from musicgen_tpu.models.mamba import MambaLM as JaxMambaLM
from musicgen_tpu.models.transformer import TransformerLM as JaxTransformerLM
from musicgen_tpu.models.xlstm import XLSTMLM as JaxXLSTMLM
from musicgen_tpu.ops import pallas_decode as jd
from musicgen_tpu.sample import sampler as js
from musicgen_tpu_torch.config import MambaConfig as PortMambaConfig
from musicgen_tpu_torch.config import TransformerConfig, XLSTMConfig
from musicgen_tpu_torch.interop import from_jax_params, load_model
from musicgen_tpu_torch.ops import decode_kernel as dk
from musicgen_tpu_torch.ops.grammar import field_bucket, filtered_logits, grammar_mask
from musicgen_tpu_torch.sample import sampler as ts
from tests.test_torch_xdecode import random_params

N = 12  # new tokens of a run
SEPARATED = 1e-3  # a plain top-1 this far ahead of the second (relative) is the kernel path's pick too
BLOCK = 32  # the prompt's window: a Transformer's block_len, so kernel F's path runs


def _inputs(cfg, batch, prompt_len, seed=0):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    meta = rng.integers(0, cfg.metadata_vocab_size, (batch, NUM_META)).astype(np.int32)
    return prompt, meta


@pytest.fixture(scope="module")
def mamba():
    cfg = MambaConfig(d_model=128, n_layers=2)
    prompt, meta = _inputs(cfg, 16, BLOCK)
    jm = JaxMambaLM(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(prompt[:, :8]), jnp.asarray(meta))
    port = load_model(from_jax_params(jax.tree.map(np.asarray, params),
                                      PortMambaConfig(**dataclasses.asdict(cfg))), "cpu")
    return cfg, jm, params, port


@pytest.fixture(scope="module")
def transformer():
    jcfg = JaxTransformerConfig(n_embd=256, n_heads=4, n_layer=2, block_len=BLOCK, attention_impl="xla")
    prompt, meta = _inputs(jcfg, 9, BLOCK)
    jm = JaxTransformerLM(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(prompt[:, :8]),
                                                         jnp.asarray(meta)))
    port = load_model(from_jax_params(params, TransformerConfig(**dataclasses.asdict(jcfg))), "cpu")
    return jcfg, jm, params, port


@pytest.fixture(scope="module")
def xlstm():
    jcfg = JaxXLSTMConfig(embedding_dim=64, num_blocks=3, slstm_at=(1,), metadata_vocab_size=16)
    prompt, meta = _inputs(jcfg, 9, 24)
    jm = JaxXLSTMLM(jcfg)
    params = random_params(jm, prompt, meta)
    port = load_model(from_jax_params(params, XLSTMConfig(**dataclasses.asdict(jcfg))), "cpu")
    return jcfg, jm, params, port


def _generate(port, kind, prompt, meta, seed=0, **opts):
    return ts.generate(port, kind, torch.from_numpy(prompt).long(), torch.from_numpy(meta).long(), N, BLOCK,
                       torch.Generator().manual_seed(seed), **opts)


def _batch_slice(tree, j):
    if isinstance(tree, torch.Tensor):
        return tree[j:j + 1].clone()
    if isinstance(tree, dict):
        return {k: _batch_slice(v, j) for k, v in tree.items()}
    return type(tree)(_batch_slice(v, j) for v in tree)


def _rows_alone(port, kind, prompt, meta, **opts):
    """Each row generated alone at batch 1, from its slice of its group's
    prefill (logits and state)."""
    out = []
    for g0 in range(0, len(prompt), dk.MAX_ROWS):
        with torch.no_grad():
            logits, state = port.prefill(torch.from_numpy(prompt[g0:g0 + dk.MAX_ROWS]).long(),
                                         torch.from_numpy(meta[g0:g0 + dk.MAX_ROWS]).long())
        for j in range(min(dk.MAX_ROWS, len(prompt) - g0)):
            port.prefill = lambda tokens, m, j=j: (logits[j:j + 1], _batch_slice(state, j))
            try:
                out.append(_generate(port, kind, prompt[g0 + j:g0 + j + 1], meta[g0 + j:g0 + j + 1], **opts))
            finally:
                del port.prefill
    return torch.cat(out)


@torch.no_grad()
def _assert_plain_step_agrees(port, kind, prompt, meta, streams):
    """The plain step (generate's fused=False step) over `streams`: each new
    token is among its top-3 sampling weights, and is its top-1 wherever
    that leads the second by more than SEPARATED. Returns the (B, N) steps
    where it does not (the near-ties)."""
    prompt, meta = torch.from_numpy(prompt).long(), torch.from_numpy(meta).long()
    prefill, step = ts.make_sampler(port, kind, block_len=BLOCK)
    logits, state = prefill(prompt, meta)
    pen, last, p = ts.init_penalty_state(prompt, 2048), prompt[:, -1], prompt.shape[1]
    near = []
    for i in range(N):
        w = filtered_logits(last, logits) / ts.penalty_divisor(pen.hist)
        vals, top3 = ts._iter_top_k(w, 3)
        tok = streams[:, p + i]
        assert bool((top3 == tok[:, None]).any(dim=1).all()), f"token {i} outside the plain top-3"
        lead = (vals[:, 0] - vals[:, 1]) > SEPARATED * vals[:, 0].abs()
        assert bool((tok == top3[:, 0])[lead].all()), f"token {i} is not the plain top-1 at a separated step"
        near.append(~lead)
        pen = ts.push_token(pen, tok)
        logits, state = step(tok, state, p + i)
        last = tok
    return torch.stack(near, dim=1)


def _assert_equal_up_to_near_ties(got, want, near, prompt_len):
    """Each row of `got` equals `want`'s, or first differs at a near-tie."""
    differ = torch.from_numpy(np.asarray(got)[:, prompt_len:] != np.asarray(want)[:, prompt_len:])
    for row in differ.any(dim=1).nonzero().flatten().tolist():
        first = int(differ[row].nonzero()[0])
        assert bool(near[row, first]), f"row {row} differs at token {first}, where the plain top-1 leads"


def _grammatical(streams, prompt_len):
    return bool((grammar_mask()[field_bucket(streams[:, prompt_len - 1:-1]), streams[:, prompt_len:]] > 0).all())


@pytest.mark.parametrize("batch", [9, 16])
def test_mamba_rows_in_groups_match_jax_and_each_row_alone(mamba, batch):
    cfg, jm, params, port = mamba
    prompt, meta = _inputs(cfg, batch, BLOCK, seed=batch)
    fused = _generate(port, "mamba", prompt, meta, greedy=True, fused=True)
    assert fused.shape == (batch, BLOCK + N)
    assert torch.equal(fused, _rows_alone(port, "mamba", prompt, meta, greedy=True, fused=True))
    near = _assert_plain_step_agrees(port, "mamba", prompt, meta, fused)
    want = js.generate(jm, params, "mamba", jnp.asarray(prompt), jnp.asarray(meta), N, block_len=BLOCK,
                       rng=jax.random.PRNGKey(0), greedy=True, fused=True)
    _assert_equal_up_to_near_ties(fused, want, near, BLOCK)


def test_mamba_resident_rows_in_groups_match_the_per_token_kernels(mamba):
    cfg, _, _, port = mamba
    prompt, meta = _inputs(cfg, 9, BLOCK, seed=9)
    resident = _generate(port, "mamba", prompt, meta, greedy=True, resident=True)
    assert torch.equal(resident, _generate(port, "mamba", prompt, meta, greedy=True, fused=True))
    assert torch.equal(resident, _rows_alone(port, "mamba", prompt, meta, greedy=True, resident=True))


def test_transformer_rows_in_groups_match_jax_and_each_row_alone(transformer):
    jcfg, jm, params, port = transformer
    prompt, meta = _inputs(jcfg, 9, BLOCK, seed=9)
    fused = _generate(port, "transformer", prompt, meta, greedy=True, fused=True)
    assert fused.shape == (9, BLOCK + N)
    assert torch.equal(fused, _rows_alone(port, "transformer", prompt, meta, greedy=True, fused=True))
    near = _assert_plain_step_agrees(port, "transformer", prompt, meta, fused)
    want = js.generate(jm, params, "transformer", jnp.asarray(prompt), jnp.asarray(meta), N, block_len=BLOCK,
                       rng=jax.random.PRNGKey(7), greedy=True, fused=True)
    _assert_equal_up_to_near_ties(fused, want, near, BLOCK)


def test_xlstm_rows_in_groups_match_each_row_alone_and_the_plain_step(xlstm):
    jcfg, jm, params, port = xlstm
    prompt, meta = _inputs(jcfg, 9, 24, seed=9)
    fused = _generate(port, "xlstm", prompt, meta, greedy=True, fused=True)
    assert fused.shape == (9, 24 + N)
    assert torch.equal(fused, _rows_alone(port, "xlstm", prompt, meta, greedy=True, fused=True))
    _assert_plain_step_agrees(port, "xlstm", prompt, meta, fused)
    # The plain path takes any batch on both sides: the same streams, up to
    # a near-tie of the two f32 steps.
    plain = _generate(port, "xlstm", prompt, meta, greedy=True, fused=False)
    near = _assert_plain_step_agrees(port, "xlstm", prompt, meta, plain)
    want = js.generate(jm, params, "xlstm", jnp.asarray(prompt), jnp.asarray(meta), N, block_len=BLOCK,
                       rng=jax.random.PRNGKey(7), greedy=True, fused=False)
    _assert_equal_up_to_near_ties(plain, want, near, 24)


@pytest.mark.parametrize("kind,opts", [("mamba", dict(fused=True)), ("mamba", dict(resident=True)),
                                       ("transformer", dict(fused=True)), ("xlstm", dict(fused=True))],
                         ids=["mamba", "mamba-resident", "transformer", "xlstm"])
def test_stochastic_rows_in_groups_are_grammatical(mamba, transformer, xlstm, kind, opts):
    cfg, _, _, port = {"mamba": mamba, "transformer": transformer, "xlstm": xlstm}[kind]
    prompt, meta = _inputs(cfg, 9, BLOCK, seed=3)
    streams = _generate(port, kind, prompt, meta, seed=3, **opts)
    assert streams.shape == (9, BLOCK + N)
    assert torch.equal(streams[:, :BLOCK], torch.from_numpy(prompt).long())
    assert _grammatical(streams, BLOCK)


# ---------------------------------------------------------------------------
# The mixer's items
# ---------------------------------------------------------------------------


def _mixer_inputs(cfg, batch, seed=0):
    dims = dk.DecodeDims.create(cfg, batch)
    g = torch.Generator().manual_seed(seed)
    zx = torch.randn(batch, dims.d_in_proj, generator=g)
    zx[:, dims.d_inner + dims.conv_dim:] = torch.nn.functional.softplus(zx[:, dims.d_inner + dims.conv_dim:])
    a_h = -torch.rand(dims.nheads, generator=g) * 4 - 0.1
    d_h = torch.randn(dims.nheads, generator=g)
    ssm = torch.randn(dims.d_inner, batch * dims.d_state, generator=g)
    return dims, zx, a_h, d_h, ssm


@pytest.mark.parametrize("cfg,batch", [(PortMambaConfig(), 2), (PortMambaConfig(), 8),
                                       (PortMambaConfig(d_model=128, n_layers=2), 1)],
                         ids=["full-b2", "full-b8", "small-b1"])
def test_mixer_items_equal_the_plain_mixer_bit_for_bit(cfg, batch):
    dims, zx, a_h, d_h, ssm = _mixer_inputs(cfg, batch)
    s_plain, s_items = ssm.clone(), ssm.clone()
    g_plain = dk.mixer_state_plain(zx, a_h, d_h, s_plain, dims)
    g_items = dk.mixer_state_items(zx, a_h, d_h, s_items, dims)
    assert torch.equal(g_items, g_plain)
    assert torch.equal(s_items, s_plain)
    assert not torch.equal(s_plain, ssm)


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_mixer_items_cover_every_state_row_once(batch):
    dims = dk.DecodeDims.create(PortMambaConfig(), batch)
    seen = []
    for item in range(batch * dims.nheads * dk.MIXER_SPLIT):
        b, h, rows = dk.mixer_item(item, dims)
        assert rows.stop - rows.start == dims.headdim // dk.MIXER_SPLIT == 16
        seen += [(b, h * dims.headdim + p) for p in range(rows.start, rows.stop)]
    assert sorted(seen) == [(b, c) for b in range(batch) for c in range(dims.d_inner)]


def test_mixer_items_through_a_layer_match_pallas_body(mamba):
    """in_proj, the items and out_proj over the JAX package's mixer layer
    (`_mixer_math`, called as jnp), at the tolerances of
    tests/test_torch_decode.py."""
    cfg, _, params, port = mamba
    b = 2
    prompt, meta = _inputs(cfg, b, BLOCK)
    with torch.no_grad():
        _, states = port.prefill(torch.from_numpy(prompt).long(), torch.from_numpy(meta).long())
    jdims = jd.DecodeDims.create(cfg, b)
    jdp = jd.build_decode_params(params, cfg, b)
    dims = dk.DecodeDims.create(port.cfg, b)
    dp = dk.build_decode_params(port, b)
    conv, ssm = dk.stack_states(states)
    x = np.random.default_rng(1).standard_normal((b, cfg.d_model)).astype(np.float32)
    x_rows = np.zeros((jdims.rows, cfg.d_model), np.float32)
    x_rows[:b] = x
    jx, _, js_new = jd._mixer_math(
        jnp.asarray(x_rows), jdp["w_in"][0], None, jdp["w_out"][0], None, jdp["conv_w"][0], jdp["conv_b"][0],
        jdp["dt_bias"][0], jdp["a_e"][0], jdp["d_e"][0], jdp["e_mat"], jdp["norm_w"][0],
        jnp.asarray(conv[0].numpy()), jnp.asarray(ssm[0].numpy()), jdims, "none")
    zx = dk.in_proj_conv_plain(torch.from_numpy(x), dp["w_in"][0], dp["conv_w"][0], dp["conv_b"][0],
                               dp["dt_bias"][0], conv[0], dims)
    g = dk.mixer_state_items(zx, dp["a_h"][0], dp["d_h"][0], ssm[0], dims)
    out = dk.out_proj_rms_plain(g, dp["norm_w"][0], dp["w_out"][0], dims)
    rel = lambda a, w: float(np.abs(np.asarray(a) - np.asarray(w)).max() / np.abs(np.asarray(w)).max())  # noqa: E731
    assert rel(ssm[0], js_new) < 1e-5
    assert rel(out, np.asarray(jx)[:b]) < 1e-2


def test_only_the_chain_launches_dependents():
    """Kernel B's chain (KERNEL_OPS) launches the mixer and out_proj as
    programmatic dependents of the launch ahead; their wrappers launch
    plainly unless asked, and SERIAL_OPS are the chain without the edges."""
    assert [getattr(op, "keywords", {}) for op in dk.KERNEL_OPS] == [{}, {"dependent": True}, {"dependent": True},
                                                                      {}, {}]
    assert [getattr(op, "func", op) for op in dk.KERNEL_OPS] == list(dk.SERIAL_OPS)
    for fn in (dk.mixer_state, dk.out_proj_rms):
        assert inspect.signature(fn).parameters["dependent"].default is False
