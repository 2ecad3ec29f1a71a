"""Kernel C: the resident whole-generation kernel (csrc/generate_resident.cu).

Replaces musicgen_tpu/ops/pallas_generate.py (`_generate_kernel` via
`fused_generate` and `generate_resident`): ONE launch generates N tokens of
the Mamba-2 stack with the 'combined' sampler. Per token, in order:
  1. pick from the top-3 candidates: greedy takes the first; otherwise CDF
     inversion of two uniforms, exactly as pallas_generate.py:159-183;
  2. push the token into the penalty window (sample/sampler.push_token);
  3. gather its f32 embedding row;
  4. the L mixers (in_proj + conv, SSM state update, RMSNorm + out_proj);
  5. LayerNorm + lm_head;
  6. the sampler tail (grammar, penalty, exact top-3) -> the next candidates.
The emitted token t is the pick after t model steps, the stream order of
sample/sampler.sample_tokens_fused_tail (seeded by the prefill top-3).

Random numbers come from outside, as in the TPU kernel: `uniforms` is
(num_tokens, B, 2) f32, lane 0 driving the k-choice and lane 1 the pick.
The per-token routes of sample/sampler.py invert the same uniforms with the
same rule (`pick_plain`), so kernel C's stream equals theirs on one tensor
of uniforms (the sampler's draw rule).

`fused_generate_plain` is the same stage order in PyTorch. With
ops=PLAIN_OPS it is the plain version of the kernel; with ops=KERNEL_OPS it
is the per-token kernel chain with the resident kernel's pick, which the
resident kernel matches bit for bit on the card.

The kernel is a persistent cooperative grid of one 512-thread block an SM,
two 256-thread teams a block. `resident_plan` is the schedule the wrapper
hands it: which team computes each in_proj, out_proj and lm_head tile and
each mixer item, and the ring of shared-memory slots through which TMA bulk
copies stream each team's weights ahead of the stages that read them
(csrc/generate_resident.cu). `plan_stream` is the plain version of a team's
weight stream, in the order the kernel consumes it. Stages wait on counters
of the items they read, which the wrapper zeroes for every launch. The
tail's 64 slices a row run one warp each across the SMs and exchange their
pairs and lists through the scratch after the counters (`counter_words`).

Both advance the conv and SSM states IN PLACE (the TPU kernel returned new
arrays); the penalty state passed in is not modified.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from ..config import VOCAB
from ..sample.sampler import (
    WINDOW_TICKS,
    PenaltyState,
    _iter_top_k,
    init_penalty_state,
    penalty_divisor,
    push_token,
)
from .build import check, load_library, stream_ptr
from .decode_kernel import (
    INT8_KSTEP,
    INT8_TILE,
    LAUNCHES,
    MIXER_SPLIT,
    PLAIN_OPS,
    QUANT_GROUP,
    TAIL_SLICES,
    DecodeDims,
    StepOps,
    _kernel_dims,
    _need,
    _weights,
    check_pack,
    decode_logits,
)
from .grammar import field_bucket, filtered_logits


def pick_plain(vals: torch.Tensor, idxs: torch.Tensor, last: torch.Tensor, u: Optional[torch.Tensor],
               greedy: bool) -> torch.Tensor:
    """The kernel's pick of one token per row from (vals, idxs) (B, 3), given
    the previous token `last` (B,) and uniforms u (B, 2). All in f32:
    k = 1 + (u_k >= p1) + (u_k >= p1 + p2) with P(k=1), P(k=2) by the field
    of `last`; r = u_p * (v0 + v1 + v2) over the first k candidates;
    choice = (r >= v0) + (r >= v0 + v1)."""
    if greedy:
        return idxs[:, 0]
    bucket = field_bucket(last)
    f32 = torch.float32
    p1 = torch.where(bucket == 4, 0.6, torch.where(bucket <= 1, 0.5, 1.0)).to(f32)
    p2 = torch.where(bucket == 0, 0.5, torch.where(bucket == 4, 0.4, 0.0)).to(f32)
    u_k, u_p = u[:, 0], u[:, 1]
    k = 1 + (u_k >= p1).long() + (u_k >= p1 + p2).long()
    v0 = vals[:, 0]
    v1 = torch.where(k >= 2, vals[:, 1], 0.0)
    v2 = torch.where(k >= 3, vals[:, 2], 0.0)
    r = u_p * (v0 + v1 + v2)
    choice = (r >= v0).long() + (r >= v0 + v1).long()
    return torch.gather(idxs, 1, choice[:, None])[:, 0]


def fused_generate_plain(dp: dict, init_vals, init_idxs, init_last, conv, ssm, pen_state: PenaltyState,
                         uniforms: Optional[torch.Tensor], dims: DecodeDims, num_tokens: int,
                         greedy: bool = False, quant: str = "none",
                         ops: StepOps = PLAIN_OPS) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The resident loop token by token. Returns (tokens (B, n), conv, ssm)."""
    vals, idxs, last, pen = init_vals, init_idxs, init_last, pen_state
    out = []
    for t in range(num_tokens):
        tok = pick_plain(vals, idxs, last, None if greedy else uniforms[t], greedy)
        pen = push_token(pen, tok)
        logits = decode_logits(dp, tok, (conv, ssm), dims, ops=ops, quant=quant)
        if t + 1 < num_tokens:
            vals, idxs = ops[4](logits, dp["gram"], pen.hist, field_bucket(tok), dims)
        last = tok
        out.append(tok)
    return torch.stack(out, dim=1), conv, ssm


# ---------------------------------------------------------------------------
# The kernel's schedule: which team computes what, and its ring of weights
# ---------------------------------------------------------------------------

TEAMS = 2  # 256-thread teams of a 512-thread block (csrc/generate_resident.cu), each with its own ring
MAX_SLOTS = 8  # ring slots a team may have (MAX_SLOTS)
MAX_TEAM_ITEMS = 32  # items of all kinds a team may have: its plan is copied to shared memory
KCH = 1024  # k of a ring chunk at most
SLOT_PAD = 64  # bytes after each weight row of a slot (SLOT_PAD)
SMEM_PER_BLOCK = 232_448  # shared memory a block may have on an H100 (227 KB)
STATIC_SMEM = 8192  # the kernel's static shared memory (3,712 B), rounded up
KINDS = ("in", "mix", "out", "head")  # the plan's work kinds, in the kernel's enum order
COUNTER_STRIDE = 32  # ints between two of the kernel's stage counters
WARPS = 16  # warps of a block (NT / 32); the tail runs one of its slices on each


def counter_words(dims: DecodeDims) -> int:
    """int32 words of kernel C's counters buffer (ResidentArgs.counters):
    3L + 2 stage counters, a 128-byte line each, then the tail's exchange:
    (B, 64) slices' pairs of 2 and lists of 3 tagged 64-bit words."""
    return (3 * dims.n_layers + 2) * COUNTER_STRIDE + dims.batch * TAIL_SLICES * 2 * (2 + 3)


def gemv_smem_bytes(rows: int, k: int, quant: str) -> int:
    """csrc/decode_ops.cuh gemv_smem_bytes: one GEMV team's two buffers of
    group sums and its staged rows of activations."""
    kpad = -(-k // INT8_KSTEP) * INT8_KSTEP
    groups = 1 if quant == "none" else k // QUANT_GROUP
    slots = max(groups, 8)
    stage_ld = {"none": 2 * (kpad + 32), "w8a16": 2 * (k + 8), "w8a8": k + 64}[quant]
    return 2 * slots * INT8_TILE * rows * 4 + rows * stage_ld


@dataclasses.dataclass(frozen=True)
class ResidentPlan:
    """What the wrapper hands kernel C besides the tensors: the grid, the
    ring's chunk (kch k of 16 weight rows) and slots a team, the dynamic
    shared memory a block, and for each team (block * TEAMS + team in the
    block) its items of each kind, in KINDS order: in_proj tiles, mixer
    items (b * nheads + h) * MIXER_SPLIT + q (mixer_item), out_proj tiles,
    lm_head tiles."""
    n_blocks: int
    kch: int
    slots: int
    slot_bytes: int
    region_bytes: int
    smem: int
    items: Tuple[Tuple[Tuple[int, ...], ...], ...]  # [team][kind] -> items

    def chunks(self, k: int) -> int:
        return -(-k // self.kch)

    def tensor(self, device) -> torch.Tensor:
        """The plan as the kernel reads it (int32): for each team, (start,
        count) of each kind's list, then the lists."""
        head: List[int] = []
        body: List[int] = []
        base = len(self.items) * 2 * len(KINDS)
        for lists in self.items:
            for lst in lists:
                head += [base + len(body), len(lst)]
                body += lst
        return torch.tensor(head + body, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def resident_plan(dims: DecodeDims, n_blocks: int, quant: str = "none") -> ResidentPlan:
    """Kernel C's schedule for a grid of n_blocks (one block an SM).

    The teams are interleaved across the blocks (team i in this order is
    team i // n_blocks of block i % n_blocks), so that a stage with fewer
    items than teams puts one on each of that many SMs: in_proj and lm_head
    tile i and mixer item i (mixer_item) go to team i mod their count,
    out_proj tile j to team -1 - j (with the fewest in_proj tiles and no
    mixer item). The ring: a chunk is kch k of a tile's 16 rows (1024 at
    most, whole 64-k steps in bf16 and 256-k groups in int8); each team has
    as many slots as fit beside the two teams' GEMV regions (MAX_SLOTS at
    most), and at least a tile's chunks. The first picks need a block a
    batch row, the tail a warp for each of the batch's 64 slices a row."""
    if n_blocks < dims.batch:
        raise ValueError(f"the resident grid needs a block per batch row: {n_blocks} < {dims.batch}")
    if n_blocks * WARPS < dims.batch * TAIL_SLICES:
        raise ValueError(f"the resident grid needs a warp per tail slice: {n_blocks} blocks of {WARPS} warps "
                         f"< {dims.batch} x {TAIL_SLICES}")
    esz, unit = (2, INT8_KSTEP) if quant == "none" else (1, QUANT_GROUP)
    kch = min(KCH, -(-max(dims.d_model, dims.d_inner) // unit) * unit)
    slot_bytes = INT8_TILE * (kch * esz + SLOT_PAD)
    team_bytes = max(gemv_smem_bytes(dims.batch, dims.d_model, quant), gemv_smem_bytes(dims.batch, dims.d_inner, quant))
    region = -(-TEAMS * team_bytes // 128) * 128
    slots = min(MAX_SLOTS, (SMEM_PER_BLOCK - STATIC_SMEM - region) // (TEAMS * slot_bytes))
    most = max(-(-dims.d_model // kch), -(-dims.d_inner // kch))
    if slots < most:
        raise ValueError(f"kernel C's ring does not fit: {slots} slots of {slot_bytes} B a team beside {region} B, "
                         f"a tile needs {most}")
    order = [(i % n_blocks) * TEAMS + i // n_blocks for i in range(TEAMS * n_blocks)]
    items = [[[] for _ in KINDS] for _ in range(TEAMS * n_blocks)]
    tiles = lambda n: -(-n // INT8_TILE)  # noqa: E731
    for i in range(tiles(dims.d_in_proj)):
        items[order[i % len(order)]][0].append(i)
    for i in range(dims.batch * dims.nheads * MIXER_SPLIT):
        items[order[i % len(order)]][1].append(i)
    for j in range(tiles(dims.d_model)):
        items[order[(-1 - j) % len(order)]][2].append(j)
    for i in range(tiles(dims.padded_vocab)):
        items[order[i % len(order)]][3].append(i)
    most_items = max(sum(len(lst) for lst in team) for team in items)
    if most_items > MAX_TEAM_ITEMS:
        raise ValueError(f"kernel C's plan gives a team {most_items} items, more than {MAX_TEAM_ITEMS}: "
                         f"{n_blocks} blocks are too few")
    return ResidentPlan(n_blocks=n_blocks, kch=kch, slots=slots, slot_bytes=slot_bytes, region_bytes=region,
                        smem=region + TEAMS * slots * slot_bytes,
                        items=tuple(tuple(tuple(lst) for lst in team) for team in items))


def plan_stream(plan: ResidentPlan, dims: DecodeDims, team: int) -> List[Tuple[int, str, int, int]]:
    """The chunks a team's ring copies for one token, in the order the kernel
    consumes them: (layer, kind, tile, chunk), each layer's in_proj
    tiles, then its out_proj tiles, then the lm_head tiles."""
    lists = dict(zip(KINDS, plan.items[team]))
    out = []
    for layer in range(dims.n_layers):
        for kind, k in (("in", dims.d_model), ("out", dims.d_inner)):
            out += [(layer, kind, tile, c) for tile in lists[kind] for c in range(plan.chunks(k))]
    out += [(dims.n_layers, "head", tile, c) for tile in lists["head"] for c in range(plan.chunks(dims.d_model))]
    return out


@functools.lru_cache(maxsize=8)
def _plan_tensor(plan: ResidentPlan, device) -> torch.Tensor:
    return plan.tensor(device)


# Pointer and size order of csrc/generate_resident.cu ResidentArgs.
_WEIGHT_KEYS = ("w_in", "w_in_s", "w_out", "w_out_s", "conv_w", "conv_b", "dt_bias", "a_h", "d_h",
                "norm_w", "ln_w", "ln_b", "lm_w", "lm_s", "lm_b", "gram", "embed")
_N_PTRS, _N_INTS = 34, 22


def fused_generate(dp: dict, init_vals, init_idxs, init_last, conv, ssm, pen_state: PenaltyState,
                   uniforms: Optional[torch.Tensor], dims: DecodeDims, num_tokens: int,
                   greedy: bool = False, quant: str = "none") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Generate num_tokens tokens in one kernel launch (on CUDA tensors; the
    plain version on CPU tensors). Returns (tokens (B, n) int64, conv, ssm),
    the states advanced in place. `quant` must match the pack."""
    if not conv.is_cuda:
        return fused_generate_plain(dp, init_vals, init_idxs, init_last, conv, ssm, pen_state, uniforms,
                                    dims, num_tokens, greedy, quant)
    check_pack(dp, quant)
    b, dev, n = dims.batch, conv.device, num_tokens
    _kernel_dims(dims, b)
    if n < 1:
        raise ValueError(f"num_tokens must be >= 1, got {n}")
    L, f32, i32, i64 = dims.n_layers, torch.float32, torch.int32, torch.int64
    _weights(dp["w_in"][0], None if quant == "none" else dp["w_in_s"][0], quant, dims.d_in_proj,
             dims.d_model, dev)
    _weights(dp["w_out"][0], None if quant == "none" else dp["w_out_s"][0], quant, dims.d_model,
             dims.d_inner, dev)
    _weights(dp["lm_w"], dp.get("lm_s"), quant, dims.padded_vocab, dims.d_model, dev)
    for key, shape in (("conv_w", (L, 4, dims.conv_dim)), ("conv_b", (L, dims.conv_dim)),
                       ("dt_bias", (L, dims.nheads)), ("a_h", (L, dims.nheads)), ("d_h", (L, dims.nheads)),
                       ("norm_w", (L, dims.d_inner)), ("ln_w", (dims.d_model,)), ("ln_b", (dims.d_model,)),
                       ("lm_b", (dims.padded_vocab,)), ("gram", (5, dims.padded_vocab)),
                       ("embed", (dims.vocab_size, dims.d_model))):
        _need(dp[key], key, f32, shape, dev)
    _need(conv, "conv", f32, (L, b, 3, dims.conv_dim), dev)
    _need(ssm, "ssm", f32, (L, dims.d_inner, b * dims.d_state), dev)
    if greedy:
        uniforms = torch.zeros(n, b, 2, dtype=f32, device=dev)  # not read
    _need(uniforms, "uniforms", f32, (n, b, 2), dev)
    ring = pen_state.ring_tok.shape[1]
    # The kernel's own copies of the window and the candidates.
    state = {
        "hist": pen_state.hist.to(i32, copy=True).contiguous(),
        "ring_tok": pen_state.ring_tok.to(i32, copy=True).contiguous(),
        "ring_c": pen_state.ring_c.to(i32, copy=True).contiguous(),
        "meta": torch.stack([pen_state.start, pen_state.head, pen_state.wsum], dim=1).to(i32).contiguous(),
        "cand_v": init_vals.to(f32, copy=True).contiguous(),
        "cand_i": init_idxs.to(i64, copy=True).contiguous(),
        "last": init_last.to(i64, copy=True).contiguous(),
    }
    _need(state["hist"], "hist", i32, (b, dims.vocab_size), dev)
    _need(state["cand_i"], "init_idxs", i64, (b, 3), dev)
    _need(state["last"], "init_last", i64, (b,), dev)
    act = {
        "x": torch.empty(b, dims.d_model, dtype=f32, device=dev),
        "zx": torch.empty(b, dims.d_in_proj, dtype=f32, device=dev),
        "g": torch.empty(b, dims.d_inner, dtype=f32, device=dev),
        "logits": torch.empty(b, dims.padded_vocab, dtype=f32, device=dev),
    }
    tokens = torch.empty(b, n, dtype=i64, device=dev)
    plan = resident_plan(dims, torch.cuda.get_device_properties(dev).multi_processor_count, quant)
    counters = torch.zeros(counter_words(dims), dtype=torch.int32, device=dev)
    tensors = [dp.get(k) for k in _WEIGHT_KEYS] + [uniforms, conv, ssm] + list(state.values()) \
        + list(act.values()) + [tokens, _plan_tensor(plan, dev), counters]
    ptrs = [0 if t is None else t.data_ptr() for t in tensors]
    ints = [L, b, dims.d_model, dims.d_inner, dims.nheads, dims.headdim, dims.d_state, dims.conv_dim,
            dims.d_in_proj, dims.padded_vocab, dims.vocab_size, dims.dyn_start, dims.length_start,
            VOCAB.time_start, VOCAB.tempo_start, ring, WINDOW_TICKS, n, int(greedy), plan.kch, plan.slots,
            plan.n_blocks]
    assert len(ptrs) == _N_PTRS and len(ints) == _N_INTS
    name = f"generate_resident_{'bf16' if quant == 'none' else quant}"
    lib = load_library()
    info = (ctypes.c_int * 4)()
    err = getattr(lib, f"mg_{name}")((ctypes.c_void_p * _N_PTRS)(*ptrs), _N_PTRS,
                                    (ctypes.c_int * _N_INTS)(*ints), _N_INTS, info, stream_ptr(conv))
    check(lib, err, name)
    LAUNCHES[name] += 1
    fused_generate.launch = dict(zip(("grid", "threads", "dynamic_smem", "static_smem"), info))
    return tokens, conv, ssm


# The last cooperative launch: blocks, threads a block, dynamic and static
# shared memory a block (bytes).
fused_generate.launch = {}


@torch.no_grad()
def generate_resident(dp: dict, init_logits: torch.Tensor, carry, prompt: torch.Tensor, num_tokens: int,
                      dims: DecodeDims, uniforms: Optional[torch.Tensor], greedy: bool = False,
                      quant: str = "none", ring: int = 2048) -> torch.Tensor:
    """Drop-in for sample_tokens_fused_tail that runs the whole loop in one
    launch. The first top-3 comes from the prefill logits through the plain
    tail; token t of row i inverts uniforms[t, i] ((num_tokens, B, 2) on the
    prompt's device, the sampler's draw_uniforms; None when greedy), any
    layout: a group's or a rank's columns of the batch's tensor are copied
    to the contiguous block the kernel reads. Returns (B, P + num_tokens)
    streams (prompt prepended); `carry` advances in place."""
    if uniforms is not None:
        uniforms = uniforms.contiguous()
    last0 = prompt[:, -1]
    pen0 = init_penalty_state(prompt, ring)
    w0 = filtered_logits(last0, init_logits) / penalty_divisor(pen0.hist)
    vals0, idxs0 = _iter_top_k(w0, 3)
    toks, _, _ = fused_generate(dp, vals0, idxs0, last0, carry[0], carry[1], pen0, uniforms, dims, num_tokens,
                                greedy, quant)
    return torch.cat([prompt, toks], dim=1)
