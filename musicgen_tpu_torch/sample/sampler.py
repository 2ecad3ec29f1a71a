"""Grammar-constrained, repetition-penalised autoregressive sampler ('combined').

Port of musicgen_tpu/sample/sampler.py, 'combined' mode (reference
scripts/generate.py:14-95). Per generated token:
  1. w = filtered_logits(prev, logits): the grammar weighting;
  2. w /= min(base^count, 1.2) over the tick window (the token suffix after
     the last position where time-delta ticks reach 64*16 = 1024), base 1.01
     for pitch tokens and 1.02 for dynamics;
  3. a random k per field of the previous token: tempo -> {1,1,1,2,2},
     dyn -> {1,3}, pitch -> {1,2}, length/time -> 1;
  4. pick among the top-k of w in proportion to w; greedy takes the top 1.

The token loop is a Python loop over eager PyTorch (the JAX package's
lax.scan). On CUDA it runs the decode kernels and fuses step 1-2 and the
top-3 into the step (ops/decode_kernel.fused_sample_step for Mamba,
ops/tdecode_kernel.fused_transformer_sample_step for the Transformer,
ops/xdecode_kernel.fused_xlstm_sample_step for the xLSTM); on CPU it runs
the plain versions. `generate(resident=True)` runs a Mamba
model's whole loop in one kernel launch instead (ops/generate_kernel). Every
random draw comes from the caller's torch.Generator, which lives on the
device of the tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..config import VOCAB, VocabLayout
from ..ops.grammar import field_bucket, filtered_logits

WINDOW_TICKS = 64 * 16  # reference generate.py:42


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_tokens: int = 1000
    ring_size: int = 2048
    greedy: bool = False
    max_topk: int = 3
    mode: str = "combined"


class PenaltyState(NamedTuple):
    """Ring-buffered repetition-penalty window (per batch element)."""

    hist: torch.Tensor  # (B, V) int32 counts over the current window
    ring_tok: torch.Tensor  # (B, W) stream tokens by stream_idx % W
    ring_c: torch.Tensor  # (B, W) time-tick contribution of each token
    start: torch.Tensor  # (B,) stream index of the window start
    head: torch.Tensor  # (B,) stream index AFTER the newest token
    wsum: torch.Tensor  # (B,) sum of contributions in [start, head)


def _contribution(tokens: torch.Tensor, layout: VocabLayout = VOCAB) -> torch.Tensor:
    """Time-delta tick value of a token (0 for non-time tokens)."""
    is_time = (tokens >= layout.time_start) & (tokens < layout.tempo_start)
    return torch.where(is_time, tokens - layout.time_start, 0)


def init_penalty_state(
    prompt: torch.Tensor, ring_size: int, layout: VocabLayout = VOCAB
) -> PenaltyState:
    """The window over the prompt: it starts after the LAST index whose
    suffix tick-sum reaches 1024; the first token is always excluded."""
    b, p = prompt.shape
    dev = prompt.device
    c = _contribution(prompt, layout)
    suffix = torch.flip(torch.cumsum(torch.flip(c, [1]), dim=1), [1])
    idx = torch.arange(p, device=dev)
    t_star = torch.where(suffix >= WINDOW_TICKS, idx, -1).max(dim=1).values
    start = torch.clamp(t_star + 1, min=1)  # the reference always drops token 0
    start = torch.clamp(start, min=p - ring_size + 1)  # ring capacity guard

    in_window = idx[None, :] >= start[:, None]
    hist = torch.zeros(b, layout.vocab_size, dtype=torch.int32, device=dev)
    hist.scatter_add_(1, prompt, in_window.to(torch.int32))

    w = ring_size
    n_keep = min(p, w)
    slots = torch.arange(p - n_keep, p, device=dev) % w
    ring_tok = torch.zeros(b, w, dtype=prompt.dtype, device=dev)
    ring_c = torch.zeros(b, w, dtype=c.dtype, device=dev)
    ring_tok[:, slots] = prompt[:, -n_keep:]
    ring_c[:, slots] = c[:, -n_keep:]

    wsum = torch.where(in_window, c, 0).sum(dim=1)
    head = torch.full((b,), p, dtype=torch.int64, device=dev)
    return PenaltyState(hist, ring_tok, ring_c, start, head, wsum)


def push_token(state: PenaltyState, token: torch.Tensor, layout: VocabLayout = VOCAB) -> PenaltyState:
    """Append `token` (B,) to the window and advance its start."""
    w = state.ring_tok.shape[1]
    rows = torch.arange(token.shape[0], device=token.device)
    c_new = _contribution(token, layout)
    slot = state.head % w
    ring_tok = state.ring_tok.clone()
    ring_c = state.ring_c.clone()
    ring_tok[rows, slot] = token
    ring_c[rows, slot] = c_new
    hist = state.hist.clone()
    hist[rows, token] += 1
    wsum = state.wsum + c_new
    start = state.start
    while True:
        advance = wsum >= WINDOW_TICKS
        if not bool(advance.any()):
            break
        sslot = start % w
        hist[rows, ring_tok[rows, sslot]] -= advance.to(hist.dtype)
        wsum = torch.where(advance, wsum - ring_c[rows, sslot], wsum)
        start = torch.where(advance, start + 1, start)
    return PenaltyState(hist, ring_tok, ring_c, start, state.head + 1, wsum)


def penalty_divisor(hist: torch.Tensor, layout: VocabLayout = VOCAB) -> torch.Tensor:
    """(B, V) divisors from window counts (generate.py:59-71)."""
    ids = torch.arange(layout.vocab_size, device=hist.device)
    base = torch.where(
        ids < layout.dyn_start, 1.01, torch.where(ids < layout.length_start, 1.02, 1.0)
    ).to(torch.float32)
    pen = torch.clamp(base[None, :] ** hist.to(torch.float32), max=1.2)
    return torch.where(base[None, :] > 1.0, pen, 1.0)


# k-choice tables as probabilities over k in {1, 2, 3}, by previous field.
_K_TABLE = (
    (0.5, 0.5, 0.0),  # prev pitch: {1,2}
    (0.5, 0.0, 0.5),  # prev dyn: {1,3}
    (1.0, 0.0, 0.0),  # prev length: 1
    (1.0, 0.0, 0.0),  # prev time: 1
    (0.6, 0.4, 0.0),  # prev tempo: {1,1,1,2,2}
)


def _sample_k(prev: torch.Tensor, generator: torch.Generator, layout: VocabLayout = VOCAB):
    """Per-field random top-k (generate.py:47-56). Returns (B,) in 1..3."""
    table = torch.tensor(_K_TABLE, dtype=torch.float32, device=prev.device)
    probs = table[field_bucket(prev, layout)]
    return torch.multinomial(probs, 1, generator=generator)[:, 0] + 1


def _pick_from_topk(vals, idxs, k, generator: torch.Generator, greedy: bool) -> torch.Tensor:
    """Pick among the first k of (vals, idxs) in proportion to vals."""
    if greedy:
        return idxs[:, 0]
    mask = torch.arange(vals.shape[1], device=vals.device)[None, :] < k[:, None]
    probs = torch.where(mask, vals.clamp(min=0.0) + 1e-30, 0.0)
    choice = torch.multinomial(probs, 1, generator=generator)
    return torch.gather(idxs, 1, choice)[:, 0]


def _iter_top_k(w: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by k argmax passes; ties go to the lowest index."""
    ids = torch.arange(w.shape[-1], device=w.device)
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(w, dim=-1)  # first maximum on ties
        vals.append(torch.gather(w, 1, i[:, None])[:, 0])
        idxs.append(i)
        w = torch.where(ids[None, :] == i[:, None], float("-inf"), w)
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


def _pick_next(w, k, generator: torch.Generator, max_topk: int, greedy: bool) -> torch.Tensor:
    if greedy:
        return torch.argmax(w, dim=-1)
    vals, idxs = _iter_top_k(w, max_topk)
    return _pick_from_topk(vals, idxs, k, generator, greedy=False)


# ---------------------------------------------------------------------------
# Token loops
# ---------------------------------------------------------------------------

StepFn = Callable[[torch.Tensor, Any, int], Tuple[torch.Tensor, Any]]
# step_fn(token (B,), model_state, stream_idx) -> (logits (B, V), model_state)


def _require_combined(cfg: SamplerConfig) -> None:
    if cfg.mode != "combined":
        raise NotImplementedError(
            f"sampler mode '{cfg.mode}' is not yet ported to musicgen_tpu_torch "
            "(only 'combined')"
        )


@torch.no_grad()
def sample_tokens(
    step_fn: StepFn,
    init_logits: torch.Tensor,  # (B, V) logits predicting the first new token
    init_model_state: Any,
    prompt: torch.Tensor,  # (B, P) int64
    cfg: SamplerConfig,
    generator: torch.Generator,
    layout: VocabLayout = VOCAB,
) -> torch.Tensor:
    """Generate cfg.num_tokens tokens with the plain sampler. (B, num_tokens)."""
    _require_combined(cfg)
    p = prompt.shape[1]
    last = prompt[:, -1]
    pen = init_penalty_state(prompt, cfg.ring_size, layout)
    logits, state = init_logits, init_model_state
    out = []
    for i in range(cfg.num_tokens):
        k = None if cfg.greedy else _sample_k(last, generator, layout)
        w = filtered_logits(last, logits, layout) / penalty_divisor(pen.hist, layout)
        tok = _pick_next(w, k, generator, cfg.max_topk, cfg.greedy)
        pen = push_token(pen, tok, layout)
        logits, state = step_fn(tok, state, p + i)
        last = tok
        out.append(tok)
    return torch.stack(out, dim=1)


@torch.no_grad()
def sample_tokens_fused_tail(
    dp: dict,  # pack from ops.decode_kernel.build_decode_params (or fused_step's)
    init_logits: torch.Tensor,  # (B, V) logits at the last prompt position
    init_model_state,  # the step's carry, advanced in place
    prompt: torch.Tensor,  # (B, P) int64
    cfg: SamplerConfig,
    generator: torch.Generator,
    dims,
    layout: VocabLayout = VOCAB,
    quant: str = "bf16",
    fused_step=None,
) -> torch.Tensor:
    """'combined' sampling with the grammar/penalty/top-3 tail inside the
    decode step: only the (B, 3) candidates leave it. Same semantics as
    `sample_tokens`. The step is ops/decode_kernel.fused_sample_step on the
    Mamba pack `dp` (`quant` the pack's: "bf16", "int8" runs W8A8, "int8w"
    W8A16), or `fused_step(pack, token, state, hist, bucket, stream_idx) ->
    (vals, idxs, state)` for another model family (ops/tdecode_kernel)."""
    if fused_step is None:
        from ..ops.decode_kernel import QUANT_MODES, fused_sample_step

        def fused_step(pack, token, state, hist, bucket, stream_idx):
            return fused_sample_step(pack, token, state, hist, bucket, dims, QUANT_MODES[quant])

    _require_combined(cfg)
    # The tail computes exactly 3 candidates.
    if cfg.max_topk > 3:
        raise ValueError(f"the fused tail computes top-3; got max_topk={cfg.max_topk}")
    last = prompt[:, -1]
    pen = init_penalty_state(prompt, cfg.ring_size, layout)
    # The first pick comes from the prefill logits through the plain tail.
    w0 = filtered_logits(last, init_logits, layout) / penalty_divisor(pen.hist, layout)
    vals, idxs = _iter_top_k(w0, 3)
    carry = init_model_state
    p = prompt.shape[1]
    out = []
    for i in range(cfg.num_tokens):
        k = None if cfg.greedy else _sample_k(last, generator, layout)
        tok = _pick_from_topk(vals, idxs, k, generator, cfg.greedy)
        pen = push_token(pen, tok, layout)
        vals, idxs, carry = fused_step(dp, tok, carry, pen.hist, field_bucket(tok, layout), p + i)
        last = tok
        out.append(tok)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# Model adapter and the end-to-end entry point
# ---------------------------------------------------------------------------


_KINDS = ("mamba", "transformer", "xlstm")


def _require_ported(kind: str) -> None:
    if kind not in _KINDS:
        raise NotImplementedError(
            f"model kind '{kind}' is not yet ported to musicgen_tpu_torch (mamba, transformer and xlstm)"
        )


def make_sampler(model, kind: str, dp: dict | None = None, quant: str = "bf16", block_len: int | None = None):
    """Returns (prefill_fn, step_fn) for `sample_tokens`.

    prefill_fn(tokens, meta) -> (last-position logits (B, V), state);
    step_fn(token, state, stream_idx) -> (logits (B, V), state).
    Mamba: the state is the per-layer (conv, ssm) states and the step
    MambaLM.step; given a pack `dp` from build_decode_params (built with
    `quant`), the stacked carry and the decode-kernel step.
    Transformer: the state is the ring-KV caches and the step
    TransformerLM.step with the ring geometry of sample/cache over a
    `block_len` window (physical slots past block_len + 6 masked with age
    -1); given a pack `dp` from build_transformer_decode_params, the stacked
    bf16 rings and kernel F's step (steady state: prompt_len == block_len ==
    the model's block_len).
    xLSTM: the state is the per-block states and the step XLSTMLM.step;
    given a pack `dp` from build_xlstm_decode_params, the stacked carry
    (the matrix memory stored in bf16 when `quant` ends in "-sb16") and
    kernel G's step."""
    _require_ported(kind)
    if kind == "transformer":
        return _transformer_sampler(model, dp, quant, block_len or model.cfg.block_len)
    if dp is None:
        return _plain_sampler(model)
    if kind == "xlstm":
        return _xlstm_sampler(model, dp, quant)

    from ..ops.decode_kernel import QUANT_MODES, DecodeDims, fused_logits_step, stack_states

    def prefill(tokens, meta):
        logits, states = model.prefill(tokens, meta)
        return logits[:, -1, :], stack_states(states)

    def step(token, carry, stream_idx):
        return fused_logits_step(dp, token, carry, DecodeDims.create(model.cfg, token.shape[0]),
                                 QUANT_MODES[quant])

    return prefill, step


def _transformer_sampler(model, tp: dict | None, quant: str, block_len: int):
    from .cache import step_geometry, token_slot

    if tp is None:
        def prefill(tokens, meta):
            logits, caches = model.prefill(tokens, meta)
            return logits[:, -1, :], caches

        phys_slots = model.cfg.seq_len

        def step(token, caches, stream_idx):
            ages, rel_base = step_geometry(stream_idx + 1, block_len, device=token.device)
            ages = torch.nn.functional.pad(ages, (0, phys_slots - ages.shape[0]), value=-1)
            return model.step(token, caches, token_slot(stream_idx, block_len), ages, rel_base)

        return prefill, step

    from ..ops.tdecode_kernel import QUANT_MODES, TDims, fused_transformer_logits_step, stack_transformer_cache

    def prefill(tokens, meta):
        logits, caches = model.prefill(tokens, meta)
        return logits[:, -1, :], stack_transformer_cache(caches, TDims.create(model.cfg, tokens.shape[0]))

    def step(token, carry, stream_idx):
        return fused_transformer_logits_step(tp, token, carry, TDims.create(model.cfg, token.shape[0]),
                                             stream_idx, QUANT_MODES[quant])

    return prefill, step


def _plain_sampler(model):
    """A recurrent model's own prefill and step (Mamba, xLSTM)."""
    def prefill(tokens, meta):
        logits, states = model.prefill(tokens, meta)
        return logits[:, -1, :], states

    def step(token, states, stream_idx):
        return model.step(token, states)

    return prefill, step


def _xlstm_sampler(model, wp: dict, quant: str):
    from ..ops.xdecode_kernel import QUANT_MODES, XDims, fused_xlstm_logits_step, stack_xlstm_states

    state_dtype = torch.bfloat16 if quant.endswith("-sb16") else torch.float32
    q = QUANT_MODES[quant.removesuffix("-sb16")]

    def prefill(tokens, meta):
        logits, states = model.prefill(tokens, meta)
        return logits[:, -1, :], stack_xlstm_states(states, XDims.create(model.cfg, tokens.shape[0]), state_dtype)

    def step(token, carry, stream_idx):
        return fused_xlstm_logits_step(wp, token, carry, XDims.create(model.cfg, token.shape[0]), q)

    return prefill, step


def _transformer_fusable(cfg, prompt_len: int, block_len: int) -> bool:
    """Kernel F is the steady-state (window always full) step: it needs a
    full-window prompt and the model's trained ring size (JAX sampler.py
    :684-692)."""
    return prompt_len == block_len == cfg.block_len


def _auto_fused(kind: str, cfg, device: torch.device, prompt_len: int, block_len: int) -> bool:
    """fused=None's choice. On the card: the decode kernels for a Mamba model
    without residuals (the kernels bake in the reference's no-residual
    stack), for a Transformer whose prompt fills its window, and for every
    xLSTM format kernel G takes (bf16, int8w, -sb16); the plain step
    otherwise, and always on the CPU.

    The Mamba and Transformer rules are the JAX package's, less its TPU VMEM
    admission. The xLSTM rule is the port's own: the JAX package fuses an
    xLSTM only for int8 weights or bf16 state storage, on a TPU measurement
    (its XLA step loop ran near the v5e's HBM roofline in bf16). The port
    takes the kernel whenever CUDA is present (ROADMAP, "Do not port":
    ops/dispatch.py), and chip_smoke.py's [9 loop] times both arms in one
    call so that the rule can change on the card's evidence."""
    if device.type != "cuda":
        return False
    if kind == "mamba":
        return not cfg.residual
    if kind == "xlstm":
        from ..ops.xdecode_kernel import fusable

        return fusable(cfg)
    return kind == "transformer" and _transformer_fusable(cfg, prompt_len, block_len)


@torch.no_grad()
def generate(
    model,
    kind: str,
    prompt: torch.Tensor,  # (B, P) int64 on the model's device
    meta: torch.Tensor,  # (B, 6) int64
    num_tokens: int,
    block_len: int,
    generator: torch.Generator,
    greedy: bool = False,
    mode: str = "combined",
    fused: bool | None = None,
    quant: str = "bf16",
    resident: bool = False,
) -> torch.Tensor:
    """Conditioned generation (reference scripts/generate.py `generate`).
    Returns (B, P + num_tokens) streams. kind: "mamba", "transformer" or
    "xlstm".

    fused=None takes the decode kernels on CUDA for a Mamba model without
    residuals, for a Transformer whose prompt fills its window and for an
    xLSTM (_auto_fused); fused=True takes them on any device (their wrappers
    run the plain versions on CPU tensors); fused=False takes the model's
    plain step. A Transformer runs kernel F only when prompt_len == block_len
    == its block_len, whatever `fused` says (JAX sampler.py:684-692). quant
    applies to the decode kernels: "bf16", "int8" (W8A8; a Transformer and an
    xLSTM run "int8w" for it, the one int8 format of their kernels) or
    "int8w" (W8A16); for an xLSTM also "bf16-sb16" and "int8w-sb16", the
    mLSTM matrix memory stored in bf16 (f32 math), which no other kind takes.
    resident=True (Mamba, 'combined' mode) runs the whole token loop in one
    kernel launch (ops/generate_kernel) and implies fused; its stochastic
    picks invert the CDF of uniforms drawn from `generator` (same
    distributions, another stream than the per-token sampler's). A
    Transformer ignores resident and runs the per-token path, as the JAX
    package does."""
    _require_ported(kind)
    sb16 = quant.endswith("-sb16")
    if sb16 and kind != "xlstm":
        raise ValueError(f"quant '{quant}': '-sb16' (bf16 storage of the mLSTM matrix memory) is an xLSTM option")
    from ..ops.decode_kernel import QUANT_MODES

    if quant.removesuffix("-sb16") not in QUANT_MODES:
        raise ValueError(f"quant must be one of {sorted(QUANT_MODES)} (an xLSTM also takes '-sb16' after "
                         f"'bf16', 'int8' or 'int8w'), got {quant!r}")
    cfg = SamplerConfig(num_tokens=num_tokens, ring_size=max(block_len, 2048), greedy=greedy, mode=mode)
    _require_combined(cfg)
    batch, prompt_len = prompt.shape
    if fused is None:
        fused = _auto_fused(kind, model.cfg, prompt.device, prompt_len, block_len)
    if kind == "transformer":
        return _generate_transformer(model, prompt, meta, block_len, generator, cfg,
                                     fused and _transformer_fusable(model.cfg, prompt_len, block_len),
                                     "int8w" if quant == "int8" else quant)
    if kind == "xlstm":
        base = quant.removesuffix("-sb16")
        xquant = ("int8w" if base == "int8" else base) + ("-sb16" if sb16 else "")
        return _generate_xlstm(model, prompt, meta, generator, cfg, fused, xquant)
    if resident:
        fused = True
    dp = None
    if fused:
        from ..ops.decode_kernel import DecodeDims, build_decode_params

        dims = DecodeDims.create(model.cfg, batch)
        dp = build_decode_params(model, batch, quant)
    prefill, step = make_sampler(model, kind, dp, quant)
    init_logits, state = prefill(prompt, meta)
    if resident:
        from ..ops.generate_kernel import generate_resident

        return generate_resident(dp, init_logits, state, prompt, num_tokens, dims, generator, greedy,
                                 QUANT_MODES[quant], cfg.ring_size)
    if fused:
        toks = sample_tokens_fused_tail(dp, init_logits, state, prompt, cfg, generator, dims, quant=quant)
    else:
        toks = sample_tokens(step, init_logits, state, prompt, cfg, generator)
    return torch.cat([prompt, toks], dim=1)


def _generate_transformer(model, prompt, meta, block_len: int, generator: torch.Generator, cfg: SamplerConfig,
                          fused: bool, quant: str) -> torch.Tensor:
    """The Transformer's token loop: kernel F's step with the sampler tail
    (fused), or TransformerLM.step's ring-KV loop."""
    tp = None
    if fused:
        from ..ops.tdecode_kernel import QUANT_MODES, TDims, build_transformer_decode_params, \
            fused_transformer_sample_step

        tp = build_transformer_decode_params(model, prompt.shape[0], quant)
        dims = TDims.create(model.cfg, prompt.shape[0])

        def fused_step(pack, token, carry, hist, bucket, stream_idx):
            return fused_transformer_sample_step(pack, token, carry, hist, bucket, dims, stream_idx,
                                                 QUANT_MODES[quant])

    prefill, step = make_sampler(model, "transformer", tp, quant, block_len)
    init_logits, state = prefill(prompt, meta)
    if fused:
        toks = sample_tokens_fused_tail(tp, init_logits, state, prompt, cfg, generator, dims,
                                        fused_step=fused_step)
    else:
        toks = sample_tokens(step, init_logits, state, prompt, cfg, generator)
    return torch.cat([prompt, toks], dim=1)


def _generate_xlstm(model, prompt, meta, generator: torch.Generator, cfg: SamplerConfig, fused: bool,
                    quant: str) -> torch.Tensor:
    """The xLSTM's token loop: kernel G's step with the sampler tail (fused;
    `quant` "bf16" or "int8w", with "-sb16" for the bf16-stored matrix
    memory), or XLSTMLM.step's loop."""
    wp = None
    if fused:
        from ..ops.xdecode_kernel import QUANT_MODES, XDims, build_xlstm_decode_params, fused_xlstm_sample_step

        wp = build_xlstm_decode_params(model, prompt.shape[0], quant.removesuffix("-sb16"))
        dims = XDims.create(model.cfg, prompt.shape[0])
        q = QUANT_MODES[quant.removesuffix("-sb16")]

        def fused_step(pack, token, carry, hist, bucket, stream_idx):
            return fused_xlstm_sample_step(pack, token, carry, hist, bucket, dims, q)

    prefill, step = make_sampler(model, "xlstm", wp, quant)
    init_logits, state = prefill(prompt, meta)
    if fused:
        toks = sample_tokens_fused_tail(wp, init_logits, state, prompt, cfg, generator, dims, fused_step=fused_step)
    else:
        toks = sample_tokens(step, init_logits, state, prompt, cfg, generator)
    return torch.cat([prompt, toks], dim=1)
