"""Continuous-batching serving scheduler (port of musicgen_tpu/serve/scheduler.py).

A fixed pool of S decode slots streams requests through continuously: when a
request finishes, its slot is refilled from the queue while the other slots
keep decoding, so a short request never waits for the longest one.

Block-synchronous continuous batching, as in the JAX package:
  * Every chunk advances every slot `chunk` tokens with the 'combined'
    sampler body of sample/sampler.pick_token (grammar filter, tick-window
    penalty, top-k pick) around the family's logits step, the step of
    sample/sampler.make_sampler. Between chunks the host retires finished
    requests and admits queued ones.
  * Admission prefills the request at batch 1 (kernel A, D or H on the card)
    and writes its state, penalty window, last token and logits into its
    slot's row. Slot state stays in the model's own format, batch first; the
    kernel routes convert it to their stacked carry at the chunk's edges.
  * The step is sample/sampler._auto_fused's choice, as for `generate`: on
    the card kernel B's logits step for a Mamba model without residuals (B'
    on an int8 pack) and kernel G's one-launch step for an xLSTM; the plain
    step otherwise. The Transformer serves through TransformerLM.step with a
    (B,) write slot and (B, S) key ages from each slot's own step count, so
    slots at different stream offsets share one step (kernel F takes one
    offset for all rows; the JAX package serves the Transformer with no
    kernel either).
  * A decode launch carries at most MAX_ROWS (8) rows, so the pool is split
    into groups of MAX_ROWS slots, each stepped in turn (a group with no
    request in it is skipped). A row's arithmetic does not depend on the
    other rows.
  * Per-request RNG: each request owns a torch.Generator seeded with its
    seed, from which every chunk draws (chunk, 2) uniforms; pick_token
    inverts their CDF as kernel C does (ops/generate_kernel.pick_plain). A
    request's stream is thus a function of (weights, prompt, seed) alone,
    whatever its slot and whatever shares the pool. It is another stream
    than the JAX package's fold_in draws, with the same distributions.
    Greedy streams equal sample/sampler.generate's.

Not ported: the `mesh=` path (ROADMAP queue 1 item 9) and the TPU VMEM
estimator and its fallback to the XLA step (ROADMAP "Do not port"): on the
card a kernel that fails to build or launch fails the call.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import NUM_META
from ..ops.decode_kernel import MAX_ROWS
from ..sample.sampler import (
    SamplerConfig,
    _auto_fused,
    _require_ported,
    build_pack,
    init_penalty_state,
    kernel_carry,
    kernel_quant,
    make_sampler,
    pick_token,
)


@dataclass
class Request:
    """One generation request: a prompt of the scheduler's fixed length and
    a token budget."""

    prompt: np.ndarray  # (prompt_len,) int64
    meta: np.ndarray  # (NUM_META,) int64
    num_tokens: int
    seed: int = 0
    rid: int = -1
    tokens: List[int] = field(default_factory=list)
    # Serving latency accounting (host wall clock; filled by the scheduler).
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0  # the end of the first chunk holding this request's tokens
    t_done: float = 0.0


def _rows(tree, fn):
    """Apply fn to every tensor of a state tree (tensors batch first, in
    dicts, tuples and NamedTuples)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _rows(v, fn) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rows(v, fn) for v in tree))
    return type(tree)(_rows(v, fn) for v in tree)


def _write_row(full, row, j: int) -> None:
    """Copy the batch-1 tree `row` into row j of the batch-first tree `full`."""
    if isinstance(full, torch.Tensor):
        full[j] = row[0]
    elif isinstance(full, dict):
        for k in full:
            _write_row(full[k], row[k], j)
    else:
        for f, r in zip(full, row):
            _write_row(f, r, j)


def ring_geometry(total: torch.Tensor, block_len: int, phys_slots: int):
    """Per-row (slot (B,), key ages (B, phys_slots), rel_base) of a
    Transformer step, row b stepping the total[b]-th stream token (the one
    being stepped included): sample/cache.step_geometry and token_slot over
    a batch of stream offsets, unfilled and spare physical slots at age -1."""
    rel_base = NUM_META - 1 + block_len
    r = torch.arange(block_len, device=total.device)
    tok = torch.remainder(total[:, None] - 1 - r, block_len)
    tok = torch.where(r < torch.clamp(total, max=block_len)[:, None], tok, -1)
    meta = (rel_base - torch.arange(NUM_META, device=total.device)).expand(total.shape[0], -1)
    ages = torch.nn.functional.pad(torch.cat([meta, tok], dim=1), (0, phys_slots - NUM_META - block_len), value=-1)
    return NUM_META + (total - 1) % block_len, ages, rel_base


class BatchScheduler:
    """Slot-based continuous batching over a model's decode state.

    Usage:
        sched = BatchScheduler(model, "mamba", slots=8)
        ids = [sched.submit(prompt, meta, n, seed) for ...]
        results = sched.run()        # {rid: np.ndarray of tokens}

    fused=None takes the kernels where `generate` does (_auto_fused; never
    for a Transformer), fused=True takes them on any device (their plain
    versions on CPU tensors), fused=False the plain step. quant as for
    `generate`: "bf16", "int8" (W8A8 for Mamba, W8A16 for an xLSTM),
    "int8w", and for an xLSTM "bf16-sb16" and "int8w-sb16" (its matrix
    memory stored in bf16 through the chunk)."""

    def __init__(self, model, kind: str, prompt_len: int = 2048, slots: int = 8, chunk: int = 32,
                 block_len: int = 2048, greedy: bool = False, fused: Optional[bool] = None, quant: str = "bf16",
                 mesh=None):
        _require_ported(kind)
        if mesh is not None:
            raise NotImplementedError("serving over a device mesh is not yet ported to musicgen_tpu_torch "
                                      "(ROADMAP queue 1 item 9): pass mesh=None")
        if quant.endswith("-sb16") and kind != "xlstm":
            raise ValueError("'-sb16' state storage is an xLSTM option")
        if kind == "transformer" and not prompt_len <= block_len <= model.cfg.block_len:
            raise ValueError(f"a Transformer serves a prompt within its window: prompt_len {prompt_len} <= "
                             f"block_len {block_len} <= the model's block_len {model.cfg.block_len}")
        if slots < 1 or chunk < 1:
            raise ValueError(f"slots and chunk must be >= 1, got {slots} and {chunk}")
        self.model, self.kind = model, kind
        self.prompt_len, self.slots, self.chunk, self.greedy = prompt_len, slots, chunk, greedy
        self.block_len = block_len
        self.ring_size = max(block_len, 2048)
        self.device = next(model.parameters()).device
        if fused is None:
            fused = _auto_fused(kind, model.cfg, self.device, prompt_len, block_len)
        self.fused = bool(fused) and kind != "transformer"
        self.quant = kernel_quant(kind, quant)
        self.pack = build_pack(model, kind, min(slots, MAX_ROWS), self.quant) if self.fused else None
        self.cfg = SamplerConfig(ring_size=self.ring_size, greedy=greedy)
        if kind == "transformer":
            self._step = self._transformer_step
        else:
            _, self._step = make_sampler(model, kind, self.pack, self.quant)
        self.group_chunks = 0  # chunks run, a group of slots each: the decode launches' count
        self._queue: deque[Request] = deque()
        self._active: Dict[int, Request] = {}  # slot -> request
        self._requests: Dict[int, Request] = {}  # rid -> request (all)
        self._gens: Dict[int, torch.Generator] = {}  # slot -> its request's generator
        self._groups: List[Optional[dict]] = [None] * (-(-slots // MAX_ROWS))
        self._next_rid = 0

    # -- public API ---------------------------------------------------------

    def submit(self, prompt, meta, num_tokens: int, seed: int = 0) -> int:
        prompt = np.asarray(prompt, np.int64)
        if prompt.shape != (self.prompt_len,):
            raise ValueError(f"prompt must be the scheduler's fixed ({self.prompt_len},) window "
                             f"(the reference crops to the model window too); got {prompt.shape}")
        req = Request(prompt, np.asarray(meta, np.int64), int(num_tokens), seed=int(seed), rid=self._next_rid)
        req.t_submit = time.perf_counter()
        self._next_rid += 1
        self._queue.append(req)
        self._requests[req.rid] = req
        return req.rid

    def run(self) -> Dict[int, np.ndarray]:
        """Drive chunks until the queue and the slots drain; returns rid ->
        its tokens."""
        done: Dict[int, np.ndarray] = {}
        self._admit_all()
        while self._active:
            tokens = self._run_chunk()  # (S, chunk), host
            now = time.perf_counter()
            for s, req in list(self._active.items()):
                if not req.tokens:
                    req.t_first = now
                take = min(self.chunk, req.num_tokens - len(req.tokens))
                req.tokens.extend(int(t) for t in tokens[s, :take])
                if len(req.tokens) >= req.num_tokens:
                    req.t_done = now
                    done[req.rid] = np.asarray(req.tokens, np.int64)
                    del self._active[s], self._gens[s]
            self._admit_all()
        return done

    def stats(self) -> Dict[int, Dict[str, float]]:
        """Per-request serving latency of the completed requests: queue wait,
        time to first chunk, total wall and tok/s from admission."""
        out = {}
        for rid, r in self._requests.items():
            if not r.t_done:
                continue
            out[rid] = {
                "queue_wait_s": r.t_admit - r.t_submit,
                "ttfc_s": r.t_first - r.t_submit,
                "wall_s": r.t_done - r.t_submit,
                "tokens": float(r.num_tokens),
                "tok_per_s": r.num_tokens / max(r.t_done - r.t_admit, 1e-9),
            }
        return out

    @property
    def requests(self) -> Dict[int, Request]:
        """Every submitted request by rid, with its prompt, seed and tokens."""
        return self._requests

    # -- internals ----------------------------------------------------------

    def _group_rows(self, g: int) -> int:
        return min(MAX_ROWS, self.slots - g * MAX_ROWS)

    @torch.no_grad()
    def _admit_all(self) -> None:
        for s in range(self.slots):
            if not self._queue:
                return
            if s in self._active:
                continue
            req = self._queue.popleft()
            req.t_admit = time.perf_counter()
            prompt = torch.from_numpy(req.prompt)[None].to(self.device)
            meta = torch.from_numpy(req.meta)[None].to(self.device)
            logits, state = self.model.prefill(prompt, meta)
            row = {"logits": logits[:, -1, :].float(), "model": state,
                   "pen": init_penalty_state(prompt, self.ring_size), "last": prompt[:, -1],
                   "lstep": torch.zeros(1, dtype=torch.int64, device=self.device)}
            g, j = divmod(s, MAX_ROWS)
            if self._groups[g] is None:  # the group's rows start as copies of its first request's
                n = self._group_rows(g)
                self._groups[g] = _rows(row, lambda t: t.expand(n, *t.shape[1:]).clone())
            _write_row(self._groups[g], row, j)
            self._gens[s] = torch.Generator(device=self.device).manual_seed(req.seed)
            self._active[s] = req

    def _transformer_step(self, tok, caches, lstep):
        """TransformerLM.step with each row at its own stream offset."""
        slot, ages, rel_base = ring_geometry(self.prompt_len + lstep + 1, self.block_len, self.model.cfg.seq_len)
        return self.model.step(tok, caches, slot, ages, rel_base)

    @torch.no_grad()
    def _run_chunk(self) -> np.ndarray:
        """Advance every group holding a request `chunk` tokens; (S, chunk)
        tokens on the host (rows of idle slots are garbage)."""
        out = np.zeros((self.slots, self.chunk), np.int64)
        for g, st in enumerate(self._groups):
            slots = range(g * MAX_ROWS, g * MAX_ROWS + self._group_rows(g))
            if not any(s in self._active for s in slots):
                continue
            to_carry = from_carry = lambda state: state  # noqa: E731
            if self.fused:  # the kernel step's carry, stacked for the chunk
                to_carry, from_carry = kernel_carry(self.model, self.kind, self.quant, len(slots))
            u = torch.zeros(len(slots), self.chunk, 2, device=self.device)
            if not self.greedy:
                for j, s in enumerate(slots):
                    if s in self._gens:
                        u[j] = torch.rand(self.chunk, 2, generator=self._gens[s], device=self.device)
            logits, carry, pen, last, lstep = st["logits"], to_carry(st["model"]), st["pen"], st["last"], st["lstep"]
            toks = []
            for t in range(self.chunk):
                tok, pen = pick_token(logits, last, pen, self.cfg, None, uniforms=u[:, t])
                logits, carry = self._step(tok, carry, lstep)
                last, lstep = tok, lstep + 1
                toks.append(tok)
            self._groups[g] = {"logits": logits, "model": from_carry(carry), "pen": pen, "last": last,
                               "lstep": lstep}
            self.group_chunks += 1
            out[slots.start:slots.stop] = torch.stack(toks, dim=1).cpu().numpy()
        return out
