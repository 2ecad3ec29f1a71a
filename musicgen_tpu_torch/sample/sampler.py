"""Grammar-constrained, repetition-penalised autoregressive sampler.

Port of musicgen_tpu/sample/sampler.py. Three modes (SamplerConfig.mode):

'combined' (reference scripts/generate.py:14-95), per generated token:
  1. w = filtered_logits(prev, logits): the grammar weighting;
  2. w /= min(base^count, 1.2) over the tick window (the token suffix after
     the last position where time-delta ticks reach 64*16 = 1024), base 1.01
     for pitch tokens and 1.02 for dynamics;
  3. a random k per field of the previous token: tempo -> {1,1,1,2,2},
     dyn -> {1,3}, pitch -> {1,2}, length/time -> 1;
  4. pick among the top-k of w in proportion to w; greedy takes the top 1.
'many' (scripts/generate_midi_many.py:13-56): w divided by a count penalty
  over the last 100 stream tokens (count_penalty_divisor), then the argmax,
  whatever `greedy` says.
'top5' (scripts/generate_midi.py:34-62): a draw among the top 5 of w in
  proportion to w, with no penalty; greedy takes the top 1.

The token loop is a Python loop over eager PyTorch (the JAX package's
lax.scan). On CUDA it runs the decode kernels. In 'combined' mode the step
fuses steps 1-2 and the top-3 (ops/decode_kernel.fused_sample_step for
Mamba, ops/tdecode_kernel.fused_transformer_sample_step for the Transformer,
ops/xdecode_kernel.fused_xlstm_sample_step for the xLSTM); the other modes
run the family's logits step (fused_logits_step, fused_transformer_logits_
step, fused_xlstm_logits_step) under `sample_tokens`, as the JAX package
does. On CPU the kernels' plain versions run. `generate(resident=True)` runs
a Mamba model's whole 'combined' loop in one kernel launch instead
(ops/generate_kernel). `reference_windowed_generate` re-forwards the slid
window for every token (validation only). Every random draw comes from the
caller's torch.Generator, which lives on the device of the tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..config import VOCAB, VocabLayout
from ..ops.grammar import field_bucket, filtered_logits

WINDOW_TICKS = 64 * 16  # reference generate.py:42
COUNT_WINDOW = 100  # generate_midi_many.py:26 (`generated[-100:]`)
MODES = ("combined", "many", "top5")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_tokens: int = 1000
    ring_size: int = 2048
    greedy: bool = False
    max_topk: int = 3
    mode: str = "combined"


class CountWindowState(NamedTuple):
    """The 'many' mode's fixed 100-token repetition window."""

    hist: torch.Tensor  # (B, V) int32 counts over the last <= 100 stream tokens
    ring: torch.Tensor  # (B, 100) stream tokens by stream_idx % 100
    head: int  # stream length so far (shared across the batch)


def init_count_window(prompt: torch.Tensor, layout: VocabLayout = VOCAB) -> CountWindowState:
    """Counts over the last <= 100 prompt tokens (the reference seeds its
    history with the whole prompt, so the first window is the prompt's tail)."""
    b, p = prompt.shape
    n_keep = min(p, COUNT_WINDOW)
    tail = prompt[:, -n_keep:]
    hist = torch.zeros(b, layout.vocab_size, dtype=torch.int32, device=prompt.device)
    hist.scatter_add_(1, tail, torch.ones_like(tail, dtype=torch.int32))
    ring = torch.zeros(b, COUNT_WINDOW, dtype=prompt.dtype, device=prompt.device)
    ring[:, torch.arange(p - n_keep, p, device=prompt.device) % COUNT_WINDOW] = tail
    return CountWindowState(hist, ring, p)


def push_count_window(state: CountWindowState, token: torch.Tensor) -> CountWindowState:
    """Append `token` (B,); evict the token that falls out of the window."""
    rows = torch.arange(token.shape[0], device=token.device)
    slot = state.head % COUNT_WINDOW
    hist = state.hist.clone()
    if state.head >= COUNT_WINDOW:
        hist[rows, state.ring[:, slot]] -= 1
    hist[rows, token] += 1
    ring = state.ring.clone()
    ring[:, slot] = token
    return CountWindowState(hist, ring, state.head + 1)


def count_penalty_divisor(hist: torch.Tensor, layout: VocabLayout = VOCAB) -> torch.Tensor:
    """(B, V) divisors from 100-window counts c (generate_midi_many.py:28-48):
    pitch min(1.04^c, 1.25), length min(1.015^c, 1.08), time 1.1 c where
    c >= 10, dynamics and tempo 1."""
    ids = torch.arange(layout.vocab_size, device=hist.device)
    c = hist.to(torch.float32)
    pitch = torch.clamp(torch.pow(torch.tensor(1.04, dtype=torch.float32), c), max=1.25)
    length = torch.clamp(torch.pow(torch.tensor(1.015, dtype=torch.float32), c), max=1.08)
    time = torch.where(c >= 10, 1.1 * c, 1.0)
    is_length = (ids >= layout.length_start) & (ids < layout.time_start)
    is_time = (ids >= layout.time_start) & (ids < layout.tempo_start)
    div = torch.where((ids < layout.dyn_start)[None, :], pitch, 1.0)
    div = torch.where(is_length[None, :], length, div)
    return torch.where(is_time[None, :], time, div)


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


def _require_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"sampler mode must be one of {MODES}, got {mode!r}")


def _require_combined(cfg: SamplerConfig) -> None:
    if cfg.mode != "combined":
        raise ValueError(f"the fused sampler tail computes the 'combined' pick only, got mode {cfg.mode!r}")


def init_window(prompt: torch.Tensor, cfg: SamplerConfig, layout: VocabLayout = VOCAB):
    """The mode's penalty window over the prompt: the count window for
    'many', the tick window otherwise ('top5' carries it unused)."""
    if cfg.mode == "many":
        return init_count_window(prompt, layout)
    return init_penalty_state(prompt, cfg.ring_size, layout)


def pick_token(logits: torch.Tensor, last: torch.Tensor, pen, cfg: SamplerConfig, generator: torch.Generator,
               layout: VocabLayout = VOCAB, uniforms: torch.Tensor | None = None):
    """One token (B,) of the mode from the step's logits and the previous
    token, and the window after it (JAX sample_tokens' body, :345-360).
    uniforms (B, 2), 'combined' mode only: a stochastic pick inverts their
    CDF among the top 3 as kernel C does (ops/generate_kernel.pick_plain)
    instead of drawing from `generator`."""
    w = filtered_logits(last, logits, layout)
    if cfg.mode == "many":
        tok = torch.argmax(w / count_penalty_divisor(pen.hist, layout), dim=-1)
        return tok, push_count_window(pen, tok)
    if cfg.mode == "top5":
        k = torch.full_like(last, 5)
        return _pick_next(w, k, generator, 5, cfg.greedy), pen
    w = w / penalty_divisor(pen.hist, layout)
    if uniforms is not None and not cfg.greedy:
        from ..ops.generate_kernel import pick_plain

        vals, idxs = _iter_top_k(w, 3)
        tok = pick_plain(vals, idxs, last, uniforms, False)
    else:
        k = None if cfg.greedy else _sample_k(last, generator, layout)
        tok = _pick_next(w, k, generator, cfg.max_topk, cfg.greedy)
    return tok, push_token(pen, tok, layout)


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
    """Generate cfg.num_tokens tokens of cfg.mode with the plain sampler
    around `step_fn`. (B, num_tokens)."""
    _require_mode(cfg.mode)
    p = prompt.shape[1]
    last = prompt[:, -1]
    pen = init_window(prompt, cfg, layout)
    logits, state = init_logits, init_model_state
    out = []
    for i in range(cfg.num_tokens):
        tok, pen = pick_token(logits, last, pen, cfg, generator, layout)
        logits, state = step_fn(tok, state, p + i)
        last = tok
        out.append(tok)
    return torch.stack(out, dim=1)


@torch.no_grad()
def sample_tokens_fused_tail(
    dp: dict,  # the family's decode-kernel pack (build_pack)
    init_logits: torch.Tensor,  # (B, V) logits at the last prompt position
    init_model_state,  # the step's carry, advanced in place
    prompt: torch.Tensor,  # (B, P) int64
    cfg: SamplerConfig,
    generator: torch.Generator,
    fused_step: Callable,
    layout: VocabLayout = VOCAB,
) -> torch.Tensor:
    """'combined' sampling with the grammar/penalty/top-3 tail inside the
    decode step: only the (B, 3) candidates leave it. Same semantics as
    `sample_tokens`. The step is `fused_step(pack, token, state, hist,
    bucket, stream_idx) -> (vals, idxs, state)`, the family's kernel step
    with the tail (fused_tail_step)."""
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

    from ..ops.decode_kernel import QUANT_MODES, DecodeDims, fused_logits_step

    def prefill(tokens, meta):
        logits, states = model.prefill(tokens, meta)
        return logits[:, -1, :], kernel_carry(model, kind, quant, tokens.shape[0])[0](states)

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
    from ..ops.xdecode_kernel import QUANT_MODES, XDims, fused_xlstm_logits_step

    q = QUANT_MODES[quant.removesuffix("-sb16")]

    def prefill(tokens, meta):
        logits, states = model.prefill(tokens, meta)
        return logits[:, -1, :], kernel_carry(model, "xlstm", quant, tokens.shape[0])[0](states)

    def step(token, carry, stream_idx):
        return fused_xlstm_logits_step(wp, token, carry, XDims.create(model.cfg, token.shape[0]), q)

    return prefill, step


def kernel_carry(model, kind: str, quant: str, batch: int):
    """(stack, unstack) between a recurrent model's per-layer states at
    `batch` rows and the carry of its kernel step (Mamba: kernel B's; xLSTM:
    kernel G's, the mLSTM matrix memory stored in bf16 when `quant` ends in
    "-sb16")."""
    if kind == "mamba":
        from ..ops.decode_kernel import DecodeDims, stack_states, unstack_states

        return stack_states, lambda carry: unstack_states(*carry, DecodeDims.create(model.cfg, batch))
    from ..ops.xdecode_kernel import XDims, stack_xlstm_states, unstack_xlstm_states

    dims = XDims.create(model.cfg, batch)
    state_dtype = torch.bfloat16 if quant.endswith("-sb16") else torch.float32
    return (lambda states: stack_xlstm_states(states, dims, state_dtype),
            lambda carry: unstack_xlstm_states(carry, dims))


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
    "xlstm"; mode: "combined", "many" or "top5" (module docstring).

    fused=None takes the decode kernels on CUDA for a Mamba model without
    residuals, for a Transformer whose prompt fills its window and for an
    xLSTM (_auto_fused); fused=True takes them on any device (their wrappers
    run the plain versions on CPU tensors); fused=False takes the model's
    plain step. A Transformer runs kernel F only when prompt_len == block_len
    == its block_len, whatever `fused` says (JAX sampler.py:684-692). In
    'combined' mode the kernels' step carries the sampler tail; in the other
    modes it is the family's logits step under `sample_tokens` (JAX
    sampler.py:783). quant applies to the decode kernels: "bf16", "int8"
    (W8A8; a Transformer and an xLSTM run "int8w" for it, the one int8 format
    of their kernels) or "int8w" (W8A16); for an xLSTM also "bf16-sb16" and
    "int8w-sb16", the mLSTM matrix memory stored in bf16 (f32 math), which no
    other kind takes. resident=True (Mamba, 'combined' mode) runs the whole
    token loop in one kernel launch (ops/generate_kernel) and implies fused;
    its stochastic picks invert the CDF of uniforms drawn from `generator`
    (same distributions, another stream than the per-token sampler's). In
    another mode, and for another family, resident is ignored and the
    per-token path runs, as in the JAX package (sampler.py:720).

    Any batch >= 1 is taken. Where the kernels run and the batch has more
    than MAX_ROWS (8) rows, the most one decode launch carries, the rows are
    generated in groups of MAX_ROWS, each whole (prefill, pack, token loop)
    and in turn, their draws from `generator` in that order; each group
    streams the weights once a token, so 16 rows read them twice."""
    _require_ported(kind)
    _require_mode(mode)
    sb16 = quant.endswith("-sb16")
    if sb16 and kind != "xlstm":
        raise ValueError(f"quant '{quant}': '-sb16' (bf16 storage of the mLSTM matrix memory) is an xLSTM option")
    from ..ops.decode_kernel import MAX_ROWS, QUANT_MODES

    if quant.removesuffix("-sb16") not in QUANT_MODES:
        raise ValueError(f"quant must be one of {sorted(QUANT_MODES)} (an xLSTM also takes '-sb16' after "
                         f"'bf16', 'int8' or 'int8w'), got {quant!r}")
    cfg = SamplerConfig(num_tokens=num_tokens, ring_size=max(block_len, 2048), greedy=greedy, mode=mode)
    resident = resident and kind == "mamba" and mode == "combined"
    batch, prompt_len = prompt.shape
    if fused is None:
        fused = _auto_fused(kind, model.cfg, prompt.device, prompt_len, block_len)
    if kind == "transformer":
        fused = fused and _transformer_fusable(model.cfg, prompt_len, block_len)
    fused = fused or resident
    if fused and batch > MAX_ROWS:
        return torch.cat([generate(model, kind, prompt[i:i + MAX_ROWS], meta[i:i + MAX_ROWS], num_tokens, block_len,
                                   generator, greedy, mode, fused, quant, resident)
                          for i in range(0, batch, MAX_ROWS)])
    pack, quant = None, kernel_quant(kind, quant)
    if fused:
        pack = build_pack(model, kind, batch, quant)
    prefill, step = make_sampler(model, kind, pack, quant, block_len)
    init_logits, state = prefill(prompt, meta)
    if resident:
        from ..ops.decode_kernel import DecodeDims
        from ..ops.generate_kernel import generate_resident

        return generate_resident(pack, init_logits, state, prompt, num_tokens, DecodeDims.create(model.cfg, batch),
                                 generator, greedy, QUANT_MODES[quant], cfg.ring_size)
    if fused and mode == "combined":
        toks = sample_tokens_fused_tail(pack, init_logits, state, prompt, cfg, generator,
                                        fused_tail_step(model, kind, batch, quant))
    else:
        toks = sample_tokens(step, init_logits, state, prompt, cfg, generator)
    return torch.cat([prompt, toks], dim=1)


def kernel_quant(kind: str, quant: str) -> str:
    """The pack format of `quant` for the family's kernels: a Transformer's
    and an xLSTM's int8 is W8A16 ("int8w"), the one int8 format of F and G."""
    base = quant.removesuffix("-sb16")
    if kind != "mamba" and base == "int8":
        return "int8w" + quant[len(base):]
    return quant


def build_pack(model, kind: str, batch: int, quant: str) -> dict:
    """The family's decode-kernel pack for `batch` rows (<= MAX_ROWS), in
    the format of kernel_quant(kind, quant)."""
    if kind == "mamba":
        from ..ops.decode_kernel import build_decode_params

        return build_decode_params(model, batch, quant)
    if kind == "transformer":
        from ..ops.tdecode_kernel import build_transformer_decode_params

        return build_transformer_decode_params(model, batch, quant)
    from ..ops.xdecode_kernel import build_xlstm_decode_params

    return build_xlstm_decode_params(model, batch, quant.removesuffix("-sb16"))


def fused_tail_step(model, kind: str, batch: int, quant: str):
    """The family's kernel step with the sampler tail at `batch` rows, on a
    pack of build_pack(model, kind, batch, quant), as
    sample_tokens_fused_tail takes it: (pack, token, carry, hist, bucket,
    stream_idx) -> (vals, idxs, carry)."""
    if kind == "mamba":
        from ..ops.decode_kernel import QUANT_MODES, DecodeDims, fused_sample_step

        dims = DecodeDims.create(model.cfg, batch)
        return lambda pack, token, carry, hist, bucket, stream_idx: fused_sample_step(
            pack, token, carry, hist, bucket, dims, QUANT_MODES[quant])
    if kind == "transformer":
        from ..ops.tdecode_kernel import QUANT_MODES, TDims, fused_transformer_sample_step

        dims = TDims.create(model.cfg, batch)
        return lambda pack, token, carry, hist, bucket, stream_idx: fused_transformer_sample_step(
            pack, token, carry, hist, bucket, dims, stream_idx, QUANT_MODES[quant])
    from ..ops.xdecode_kernel import QUANT_MODES, XDims, fused_xlstm_sample_step

    dims, q = XDims.create(model.cfg, batch), QUANT_MODES[quant.removesuffix("-sb16")]
    return lambda pack, token, carry, hist, bucket, stream_idx: fused_xlstm_sample_step(
        pack, token, carry, hist, bucket, dims, q)


@torch.no_grad()
def reference_windowed_generate(
    model,
    prompt: torch.Tensor,  # (B, P) int64 on the model's device
    meta: torch.Tensor,  # (B, 6) int64
    num_tokens: int,
    block_len: int,
    generator: torch.Generator,
    greedy: bool = True,
    layout: VocabLayout = VOCAB,
    mode: str = "combined",
) -> torch.Tensor:
    """Validation sampler (JAX sampler.py:873-943): a full forward of the
    slid window for every token, the reference's semantics token for token
    (scripts/generate.py:26-89; 'many' generate_midi_many.py:13-56, 'top5'
    generate_midi.py:34-62), window truncation included. O(window) a token:
    for parity checks, not production. Returns (B, P + num_tokens).

    The window lives in one fixed (B, block_len) right-padded buffer, so
    every forward has one shape: a causal model cannot see positions >= n,
    so its logits at column n - 1 are the short window's. A token is written
    at column n while the window fills; once full, the window slides left by
    one and the token takes the last column. The forward is the model's own:
    on the card a Transformer's runs kernel D and an xLSTM's kernel H
    (models/xlstm.runs_kernel_h); a Mamba model's stays plain, as JAX's
    MambaLM.__call__ does."""
    _require_mode(mode)
    b, p = prompt.shape
    cfg = SamplerConfig(num_tokens=num_tokens, ring_size=max(block_len, 2048), greedy=greedy, mode=mode)
    pen = init_window(prompt, cfg, layout)
    if p >= block_len:
        buf, n = prompt[:, -block_len:].clone(), block_len
    else:
        buf, n = torch.nn.functional.pad(prompt, (0, block_len - p)), p
    last, out = prompt[:, -1], []
    for _ in range(num_tokens):
        logits = model(buf, meta)[:, n - 1, :]
        tok, pen = pick_token(logits, last, pen, cfg, generator, layout)
        if n >= block_len:
            buf = torch.cat([buf[:, 1:], tok[:, None]], dim=1)
        else:
            buf[:, n] = tok
            n += 1
        last = tok
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
