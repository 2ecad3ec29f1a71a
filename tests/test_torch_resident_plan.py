"""Kernel C's schedule (musicgen_tpu_torch.ops.generate_kernel
resident_plan), the host-side plan the wrapper hands to
csrc/generate_resident.cu: which team computes each GEMV tile and mixer
item, the ring's chunks and slots, and the shared memory a block takes.

Checked at the main path's dims (the reference Mamba-2, batch 2, and batch
8, the most rows a GEMV carries) on an H100 SXM (132 SMs) and PCIe (114),
and at a small config of 2 layers, in every weight format:
  * every (stage, tile) and mixer item of a token is assigned exactly once,
    a mixer item being a quarter of a (batch row, head): its 16 state rows;
  * each GEMV team's ring stream keeps the kernel's stage order;
  * each block's ring and regions fit its shared memory, with room for a
    whole tile's chunks;
  * the grid has a block a batch row and a warp a tail slice, and the
    counters buffer holds the tail's exchange;
  * the plan tensor decodes to the same lists.
"""
import pytest
import torch

from musicgen_tpu_torch.config import MambaConfig
from musicgen_tpu_torch.ops import generate_kernel as gk
from musicgen_tpu_torch.ops.decode_kernel import MIXER_SPLIT, DecodeDims, mixer_item

FULL = MambaConfig()
SMALL = MambaConfig(d_model=128, n_layers=2)
CASES = [(FULL, 2, 132), (FULL, 2, 114), (FULL, 8, 132), (SMALL, 2, 132), (SMALL, 1, 114)]
IDS = ["full-b2-sxm", "full-b2-pcie", "full-b8-sxm", "small-b2-sxm", "small-b1-pcie"]
QUANTS = ["none", "w8a16", "w8a8"]


def tiles(n):
    return -(-n // 16)


def plan_for(cfg, batch, n_sm, quant):
    dims = DecodeDims.create(cfg, batch)
    return dims, gk.resident_plan(dims, n_sm, quant)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("cfg,batch,n_sm", CASES, ids=IDS)
def test_every_item_is_assigned_exactly_once(cfg, batch, n_sm, quant):
    dims, plan = plan_for(cfg, batch, n_sm, quant)
    assert plan.n_blocks == n_sm and len(plan.items) == gk.TEAMS * n_sm
    want = {"in": tiles(dims.d_in_proj), "mix": dims.batch * dims.nheads * MIXER_SPLIT, "out": tiles(dims.d_model),
            "head": tiles(dims.padded_vocab)}
    for k, kind in enumerate(gk.KINDS):
        got = sorted(i for team in plan.items for i in team[k])
        assert got == list(range(want[kind])), kind
    assert max(sum(len(lst) for lst in team) for team in plan.items) <= gk.MAX_TEAM_ITEMS


@pytest.mark.parametrize("cfg,batch,n_sm", CASES, ids=IDS)
def test_mixer_items_are_each_quarter_head_once(cfg, batch, n_sm):
    """The mixer items the teams hold decode (decode_kernel.mixer_item, the
    kernels' mixer_load) to every (batch row, head, quarter) exactly once."""
    dims, plan = plan_for(cfg, batch, n_sm, "none")
    got = []
    for team in plan.items:
        for item in team[1]:
            b, h, rows = mixer_item(item, dims)
            got.append((b, h, rows.start // (dims.headdim // MIXER_SPLIT)))
    assert sorted(got) == [(b, h, q) for b in range(batch) for h in range(dims.nheads) for q in range(MIXER_SPLIT)]


@pytest.mark.parametrize("cfg,batch,n_sm", CASES, ids=IDS)
def test_each_stage_spreads_over_the_blocks(cfg, batch, n_sm):
    """A stage with fewer items than blocks puts at most one on a block; no
    block holds more than its share (rounded up) of any stage."""
    dims, plan = plan_for(cfg, batch, n_sm, "none")
    for k, kind in enumerate(gk.KINDS):
        per_block = [sum(len(plan.items[b * gk.TEAMS + t][k]) for t in range(gk.TEAMS)) for b in range(n_sm)]
        total = sum(per_block)
        assert max(per_block) == -(-total // n_sm), kind


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("cfg,batch,n_sm", CASES, ids=IDS)
def test_streams_keep_the_kernel_order(cfg, batch, n_sm, quant):
    """Each GEMV team's chunks come in the kernel's stage order (in_proj(l),
    out_proj(l), ..., lm_head), each tile's chunks together; over all teams
    every (layer, kind, tile, chunk) of a token is streamed exactly once."""
    dims, plan = plan_for(cfg, batch, n_sm, quant)
    order = {"in": 0, "out": 1, "head": 2}
    k_of = {"in": dims.d_model, "out": dims.d_inner, "head": dims.d_model}
    seen = []
    for team in range(len(plan.items)):
        stream = gk.plan_stream(plan, dims, team)
        keys = [(layer, order[kind]) for layer, kind, _, _ in stream]
        assert keys == sorted(keys)
        for (l0, k0, t0, c0), (l1, k1, t1, c1) in zip(stream, stream[1:]):
            if (l0, k0, t0) == (l1, k1, t1):
                assert c1 == c0 + 1
            else:
                assert c0 == plan.chunks(k_of[k0]) - 1 and c1 == 0
        seen += stream
    want = [(layer, kind, tile, c) for layer in range(dims.n_layers)
            for kind, n in (("in", tiles(dims.d_in_proj)), ("out", tiles(dims.d_model)))
            for tile in range(n) for c in range(plan.chunks(k_of[kind]))]
    want += [(dims.n_layers, "head", tile, c) for tile in range(tiles(dims.padded_vocab))
             for c in range(plan.chunks(dims.d_model))]
    assert sorted(seen) == sorted(want) and len(seen) == len(want)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("cfg,batch,n_sm", CASES, ids=IDS)
def test_ring_fits_shared_memory(cfg, batch, n_sm, quant):
    dims, plan = plan_for(cfg, batch, n_sm, quant)
    esz, unit = (2, 64) if quant == "none" else (1, 256)
    assert plan.kch % unit == 0 and plan.kch <= gk.KCH
    assert plan.slot_bytes == 16 * (plan.kch * esz + gk.SLOT_PAD)
    assert (plan.kch * esz + gk.SLOT_PAD) % 128 == 64  # a quarter-warp's two rows on distinct banks
    most = max(plan.chunks(dims.d_model), plan.chunks(dims.d_inner))
    assert most <= plan.slots <= gk.MAX_SLOTS
    region = gk.TEAMS * max(gk.gemv_smem_bytes(batch, dims.d_model, quant),
                            gk.gemv_smem_bytes(batch, dims.d_inner, quant))
    assert plan.region_bytes >= region and plan.region_bytes % 128 == 0
    assert plan.smem == plan.region_bytes + gk.TEAMS * plan.slots * plan.slot_bytes
    assert plan.smem + gk.STATIC_SMEM <= gk.SMEM_PER_BLOCK


def test_main_path_budget():
    """The budget the kernel's header states: 3 slots of 33,792 B a team in
    bf16, 5 and 6 of 17,408 in W8A16 and W8A8, beside the GEMV regions (the
    tail keeps no row in shared memory)."""
    dims = DecodeDims.create(FULL, 2)
    bf16, int8 = gk.resident_plan(dims, 132, "none"), gk.resident_plan(dims, 132, "w8a8")
    int8w = gk.resident_plan(dims, 132, "w8a16")
    assert (bf16.kch, bf16.slots, bf16.slot_bytes, bf16.region_bytes, bf16.smem) == (1024, 3, 33_792, 20_736, 223_488)
    assert (int8w.slots, int8w.slot_bytes, int8w.region_bytes, int8w.smem) == (5, 17_408, 20_608, 194_688)
    assert (int8.slots, int8.slot_bytes, int8.region_bytes, int8.smem) == (6, 17_408, 12_544, 221_440)
    # The mixer's 256 items (2 rows x 32 heads x 4 quarters) one a team on
    # all 132 blocks; out_proj's 64 tiles on 64 blocks, one a block, on teams
    # with one in_proj tile.
    assert sorted(len(lists[1]) for lists in bf16.items) == [0] * 8 + [1] * 256
    assert len({t // gk.TEAMS for t, lists in enumerate(bf16.items) if lists[1]}) == 132
    assert len({t // gk.TEAMS for t, lists in enumerate(bf16.items) if lists[2]}) == 64
    assert all(len(bf16.items[t][0]) == 1 for t, lists in enumerate(bf16.items) if lists[2])


def test_plan_tensor_decodes_to_the_lists():
    dims, plan = plan_for(SMALL, 2, 132, "w8a8")
    flat = plan.tensor("cpu")
    assert flat.dtype == torch.int32
    for team, lists in enumerate(plan.items):
        for k, lst in enumerate(lists):
            start, count = (int(v) for v in flat[team * 8 + 2 * k: team * 8 + 2 * k + 2])
            assert flat[start:start + count].tolist() == list(lst)


def test_plan_refuses_a_grid_without_a_block_per_row():
    with pytest.raises(ValueError, match="block per batch row"):
        gk.resident_plan(DecodeDims.create(SMALL, 4), 2, "none")


def test_plan_refuses_a_grid_without_a_warp_per_tail_slice():
    """The tail runs each of a row's 64 slices on a warp of its own: 8 rows
    need 512 warps, 32 blocks of 16."""
    dims = DecodeDims.create(SMALL, 8)
    with pytest.raises(ValueError, match="warp per tail slice"):
        gk.resident_plan(dims, 31, "none")
    assert gk.resident_plan(dims, 32, "none").n_blocks == 32


@pytest.mark.parametrize("cfg,batch", [(FULL, 2), (FULL, 8), (SMALL, 1)], ids=["full-b2", "full-b8", "small-b1"])
def test_counter_words_hold_the_tail_exchange(cfg, batch):
    """3L + 2 stage counters, a 128-byte line each, then B x 64 slices'
    pairs (2 words of 64 bits) and lists (3 words of 64 bits), 8-byte
    aligned."""
    dims = DecodeDims.create(cfg, batch)
    lines = 3 * dims.n_layers + 2
    assert gk.counter_words(dims) == lines * gk.COUNTER_STRIDE + batch * 64 * 5 * 2
    assert lines * gk.COUNTER_STRIDE * 4 % 8 == 0


def test_plan_refuses_a_grid_too_small_for_the_team_lists():
    """A team's lists are copied into shared memory of MAX_TEAM_ITEMS ints:
    on 8 SMs lm_head alone gives a team 70 tiles."""
    with pytest.raises(ValueError, match="too few"):
        gk.resident_plan(DecodeDims.create(SMALL, 2), 8, "none")
