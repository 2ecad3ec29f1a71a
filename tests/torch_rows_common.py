"""Shared pieces of the port's row-group tests (tests/test_torch_rows*.py):
small seeded models of the three families on both sides, generation at
more rows than one decode launch carries, and the checks that hold it to
each row run alone, to the plain step and to the JAX package. Not a test
module: the test files import it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from musicgen_tpu.config import NUM_META, MambaConfig
from musicgen_tpu.config import TransformerConfig as JaxTransformerConfig
from musicgen_tpu.config import XLSTMConfig as JaxXLSTMConfig
from musicgen_tpu.models.mamba import MambaLM as JaxMambaLM
from musicgen_tpu.models.transformer import TransformerLM as JaxTransformerLM
from musicgen_tpu.models.xlstm import XLSTMLM as JaxXLSTMLM
from musicgen_tpu_torch.config import MambaConfig as PortMambaConfig
from musicgen_tpu_torch.config import TransformerConfig, XLSTMConfig
from musicgen_tpu_torch.interop import from_jax_params, load_model
from musicgen_tpu_torch.ops import decode_kernel as dk
from musicgen_tpu_torch.ops.grammar import field_bucket, filtered_logits, grammar_mask
from musicgen_tpu_torch.sample import sampler as ts
from tests.test_torch_xdecode import random_params

# The gate runs the suite in several pytest-xdist workers on one host. torch's
# default of one intra-op thread per core in every worker oversubscribes the
# cores, and its OpenMP threads spin while they wait: a CLI case that takes
# 0.5 s alone took 28-71 s there. Every worker imports this module when it
# collects the suite, so its torch ops run on one thread.
torch.set_num_threads(1)

N = 12  # new tokens of a run
SEPARATED = 1e-3  # a plain top-1 this far ahead of the second (relative) is the kernel path's pick too
BLOCK = 32  # the prompt's window: a Transformer's block_len, so kernel F's path runs


def _inputs(cfg, batch, prompt_len, seed=0):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    meta = rng.integers(0, cfg.metadata_vocab_size, (batch, NUM_META)).astype(np.int32)
    return prompt, meta


def make_mamba():
    cfg = MambaConfig(d_model=128, n_layers=2)
    prompt, meta = _inputs(cfg, 16, BLOCK)
    jm = JaxMambaLM(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(prompt[:, :8]), jnp.asarray(meta))
    port = load_model(from_jax_params(jax.tree.map(np.asarray, params),
                                      PortMambaConfig(**dataclasses.asdict(cfg))), "cpu")
    return cfg, jm, params, port


def make_transformer():
    jcfg = JaxTransformerConfig(n_embd=256, n_heads=4, n_layer=2, block_len=BLOCK, attention_impl="xla")
    prompt, meta = _inputs(jcfg, 9, BLOCK)
    jm = JaxTransformerLM(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(prompt[:, :8]),
                                                         jnp.asarray(meta)))
    port = load_model(from_jax_params(params, TransformerConfig(**dataclasses.asdict(jcfg))), "cpu")
    return jcfg, jm, params, port


def make_xlstm():
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
