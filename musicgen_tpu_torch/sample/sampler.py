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
top-3 into the step (ops/decode_kernel.fused_sample_step); on CPU it runs
the plain versions. `generate(resident=True)` runs the whole loop in one
kernel launch instead (ops/generate_kernel). Every random draw comes from
the caller's torch.Generator, which lives on the device of the tensors.
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
    dp: dict,  # pack from ops.decode_kernel.build_decode_params
    init_logits: torch.Tensor,  # (B, V) logits at the last prompt position
    init_model_state,  # stacked (conv, ssm) states, advanced in place
    prompt: torch.Tensor,  # (B, P) int64
    cfg: SamplerConfig,
    generator: torch.Generator,
    dims,
    layout: VocabLayout = VOCAB,
    quant: str = "bf16",
) -> torch.Tensor:
    """'combined' sampling with the grammar/penalty/top-3 tail inside the
    decode step (ops/decode_kernel.fused_sample_step): only the (B, 3)
    candidates leave it. Same semantics as `sample_tokens`. `quant` is the
    pack's ("bf16", "int8" runs W8A8, "int8w" W8A16)."""
    from ..ops.decode_kernel import QUANT_MODES, fused_sample_step

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
    out = []
    for _ in range(cfg.num_tokens):
        k = None if cfg.greedy else _sample_k(last, generator, layout)
        tok = _pick_from_topk(vals, idxs, k, generator, cfg.greedy)
        pen = push_token(pen, tok, layout)
        vals, idxs, carry = fused_sample_step(
            dp, tok, carry, pen.hist, field_bucket(tok, layout), dims, QUANT_MODES[quant]
        )
        last = tok
        out.append(tok)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# Model adapter and the end-to-end entry point
# ---------------------------------------------------------------------------


def _require_mamba(kind: str) -> None:
    if kind != "mamba":
        raise NotImplementedError(
            f"model kind '{kind}' is not yet ported to musicgen_tpu_torch (mamba only)"
        )


def make_sampler(model, kind: str, dp: dict | None = None, quant: str = "bf16"):
    """Returns (prefill_fn, step_fn) for `sample_tokens` (mamba only).

    prefill_fn(tokens, meta) -> (last-position logits (B, V), state);
    step_fn(token, state, stream_idx) -> (logits (B, V), state). Given a
    pack `dp` from build_decode_params (built with `quant`), the state is
    the stacked (conv, ssm) carry and the step is the decode-kernel step
    (fused_logits_step)."""
    _require_mamba(kind)
    if dp is None:
        def prefill(tokens, meta):
            logits, states = model.prefill(tokens, meta)
            return logits[:, -1, :], states

        def step(token, states, stream_idx):
            return model.step(token, states)

        return prefill, step

    from ..ops.decode_kernel import QUANT_MODES, DecodeDims, fused_logits_step, stack_states

    def prefill(tokens, meta):
        logits, states = model.prefill(tokens, meta)
        return logits[:, -1, :], stack_states(states)

    def step(token, carry, stream_idx):
        return fused_logits_step(dp, token, carry, DecodeDims.create(model.cfg, token.shape[0]),
                                 QUANT_MODES[quant])

    return prefill, step


def _auto_fused(kind: str, cfg, device: torch.device) -> bool:
    """fused=None's choice, as the JAX package makes it: the decode kernels
    on an accelerator for a Mamba model without residuals (the kernels bake
    in the reference's no-residual stack); the plain step otherwise."""
    return device.type == "cuda" and kind == "mamba" and not cfg.residual


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
    Returns (B, P + num_tokens) streams.

    fused=None takes the decode kernels on CUDA for a Mamba model without
    residuals (_auto_fused); fused=True takes them on any device (their
    wrappers run the plain versions on CPU tensors); fused=False takes
    MambaLM.step. quant applies to the decode kernels: "bf16", "int8"
    (W8A8) or "int8w" (W8A16, weight-only). resident=True ('combined' mode)
    runs the whole token loop in one kernel launch (ops/generate_kernel) and
    implies fused; its stochastic picks invert the CDF of uniforms drawn
    from `generator` (same distributions, another stream than the per-token
    sampler's)."""
    _require_mamba(kind)
    if quant.endswith("-sb16"):
        raise NotImplementedError(
            f"quant '{quant}' (bf16 storage of the mLSTM matrix memory, an xLSTM option) "
            "is not yet ported to musicgen_tpu_torch"
        )
    from ..ops.decode_kernel import QUANT_MODES

    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {sorted(QUANT_MODES)}, got {quant!r}")
    cfg = SamplerConfig(num_tokens=num_tokens, ring_size=max(block_len, 2048), greedy=greedy, mode=mode)
    _require_combined(cfg)
    if fused is None:
        fused = _auto_fused(kind, model.cfg, prompt.device)
    if resident:
        fused = True
    batch = prompt.shape[0]
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
