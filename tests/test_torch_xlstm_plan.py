"""Kernel G's one-launch schedule (musicgen_tpu_torch.ops.xdecode_kernel
xlstm_plan), the host-side plan the wrapper hands to csrc/xlstm_step.cu:
which of the persistent grid's teams runs each item of each stage.

Checked at the main path's dims (the reference xLSTM at batch 2, and batch
8, the most rows a GEMV carries) on an H100 SXM (132 SMs) and PCIe (114),
at a small config of 2 blocks (one mLSTM, one sLSTM), and at the wide heads
of width 1024 (2 heads: DK 1024, DH 512; 1 head: DK 2048, DH 1024), in both
weight formats:
  * every item of every kind is assigned exactly once, and no team holds
    more than the kernel's plan buffer takes;
  * the stages come in dependency order: each stage reads only the
    residual stream, the states, or intermediates an earlier stage of its
    block wrote (and a wrong order is caught);
  * no stage's items sit on fewer SMs than the stage has items, up to the
    SM count;
  * the shared memory of a block fits, and the plan tensor decodes to the
    same lists.
"""
import pytest
import torch

from musicgen_tpu_torch.config import XLSTMConfig
from musicgen_tpu_torch.ops import xdecode_kernel as xk

FULL = XLSTMConfig()
SMALL = XLSTMConfig(embedding_dim=256, num_blocks=2, slstm_at=(1,))
WIDE2, WIDE1 = XLSTMConfig(num_heads=2), XLSTMConfig(num_heads=1)
CASES = [(FULL, 2, 132), (FULL, 2, 114), (FULL, 8, 132), (SMALL, 2, 132), (SMALL, 1, 114), (WIDE2, 2, 132),
         (WIDE2, 8, 114), (WIDE1, 2, 132), (WIDE1, 8, 114)]
IDS = ["full-b2-sxm", "full-b2-pcie", "full-b8-sxm", "small-b2-sxm", "small-b1-pcie", "wide2-b2-sxm", "wide2-b8-pcie",
       "wide1-b2-sxm", "wide1-b8-pcie"]
QUANTS = ["none", "w8a16"]
# What each kind of csrc/xlstm_step.cu reads and writes: the per-block
# intermediates ("up", "buf", ...), the residual stream "x" and the states.
STEP_IO = {
    "embed": ((), ("x",)),
    "m_up": (("x", "conv"), ("up", "buf", "gpart", "conv")),
    "m_mem": (("buf", "gpart", "m", "S"), ("S", "mpart")),
    "m_out": (("buf", "gpart", "m", "n", "mpart", "up"), ("m", "n", "y")),
    "m_down": (("y", "x"), ("x",)),
    "s_prep": (("x", "conv"), ("xs", "conv")),
    "s_if": (("xs",), ("wif",)),
    "s_zo": (("xs",), ("wzo",)),
    "s_cell": (("wif", "wzo", "hcnm"), ("hcnm_cnm", "hnew")),
    "s_gn": (("hnew", "x"), ("x", "hcnm")),
    "s_up": (("x",), ("u",)),
    "s_down": (("u", "x"), ("x",)),
    "head": (("x",), ("logits",)),
}
# Buffers that live across blocks and tokens: readable by any stage after
# the embedding (the residual stream) or from the start (the states).
PERSISTENT = {"conv", "S", "m", "n", "hcnm", "hcnm_cnm"}


def plan_for(cfg, batch, n_sm, quant="none"):
    dims = xk.XDims.create(cfg, batch)
    return dims, xk.xlstm_plan(dims, n_sm, quant)


def blocks_of(plan, kinds):
    """The block of each item of a stage's kinds, in item order."""
    out = []
    for kind in kinds:
        k = xk.STEP_KINDS.index(kind)
        pos = {it: t // xk.STEP_TEAMS for t, team in enumerate(plan.items) for it in team[k]}
        out += [pos[i] for i in sorted(pos)]
    return out


def dependency_error(stages):
    """The first stage that reads a buffer no earlier stage of its block
    (nor the embedding, for x) has written, or None."""
    fresh, block = set(PERSISTENT), None
    for kinds, blk in stages:
        if blk != block:  # a new block: its intermediates are not written yet
            fresh = {b for b in fresh if b in PERSISTENT or b == "x"}
            block = blk
        for kind in kinds:
            reads, _ = STEP_IO[kind]
            missing = [r for r in reads if r not in fresh]
            if missing:
                return f"{kind} (block {blk}) reads {missing} before they are written"
        for kind in kinds:
            fresh |= set(STEP_IO[kind][1])
    return None


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("cfg,batch,n_sm", CASES, ids=IDS)
def test_every_item_is_assigned_exactly_once(cfg, batch, n_sm, quant):
    dims, plan = plan_for(cfg, batch, n_sm, quant)
    assert plan.n_blocks == n_sm and len(plan.items) == xk.STEP_TEAMS * n_sm
    want = xk.stage_items(dims)
    for k, kind in enumerate(xk.STEP_KINDS):
        got = sorted(i for team in plan.items for i in team[k])
        assert got == list(range(want[kind])), kind
    assert max(sum(len(lst) for lst in team) for team in plan.items) <= xk.STEP_MAX_TEAM_ITEMS


def test_every_kind_has_its_reads_and_writes():
    assert set(STEP_IO) == set(xk.STEP_KINDS)


def test_reference_stage_items():
    """The items of each stage at the reference size, batch 2 (the counts
    csrc/xlstm_step.cu kind_items computes), and the stage sequence: the
    embedding, 4 stages a mLSTM block, 6 an sLSTM block, the head."""
    dims = xk.XDims.create(FULL, 2)
    assert xk.stage_items(dims) == {"embed": 2, "m_up": 256, "m_mem": 256, "m_out": 8, "m_down": 64, "s_prep": 16,
                                    "s_if": 128, "s_zo": 128, "s_cell": 64, "s_gn": 8, "s_up": 88, "s_down": 64,
                                    "head": 1120}
    stages = xk.step_stages(dims)
    assert len(stages) == 1 + 4 * 7 + 6 * 4 + 1 == 54
    assert stages[0] == (("embed",), -1) and stages[-1] == (("head",), 11)
    assert [kinds for kinds, blk in stages if blk == 1] == list(xk.S_STAGES)
    assert [kinds for kinds, blk in stages if blk == 0] == list(xk.M_STAGES)


@pytest.mark.parametrize("cfg,batch,n_sm", CASES, ids=IDS)
def test_stages_come_in_dependency_order(cfg, batch, n_sm):
    dims, _ = plan_for(cfg, batch, n_sm)
    stages = xk.step_stages(dims)
    assert dependency_error(stages) is None
    # The checker has teeth: the head items (m_out) before the matrix memory,
    # the group norm before the recurrence, or no embedding, is caught.
    i = next(j for j, (kinds, _) in enumerate(stages) if kinds == ("m_mem",))
    swapped = stages[:i] + [stages[i + 1], stages[i]] + stages[i + 2:]
    assert "m_out" in (dependency_error(swapped) or "")
    i = next(j for j, (kinds, _) in enumerate(stages) if kinds == ("s_cell",))
    swapped = stages[:i] + [stages[i + 1], stages[i]] + stages[i + 2:]
    assert "s_gn" in (dependency_error(swapped) or "")
    headless = [st for st in stages if st[0] != ("embed",)]
    assert "x" in (dependency_error(headless) or "")


@pytest.mark.parametrize("cfg,batch,n_sm", CASES, ids=IDS)
def test_each_stage_spreads_over_the_sms(cfg, batch, n_sm):
    """A stage's items sit on min(items, SMs) distinct blocks, and no block
    holds more than its share (rounded up) of any stage."""
    dims, plan = plan_for(cfg, batch, n_sm)
    for kinds in {kinds for kinds, _ in xk.step_stages(dims)}:
        blocks = blocks_of(plan, kinds)
        assert len(set(blocks)) == min(len(blocks), n_sm), kinds
        assert max(blocks.count(b) for b in set(blocks)) == -(-len(blocks) // n_sm), kinds


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("cfg,batch,n_sm", CASES, ids=IDS)
def test_shared_memory_fits_and_the_tensor_decodes(cfg, batch, n_sm, quant):
    dims, plan = plan_for(cfg, batch, n_sm, quant)
    assert plan.smem == xk.STEP_TEAMS * plan.region_bytes
    assert plan.smem + xk.STEP_STATIC_SMEM <= xk.STEP_SMEM_PER_BLOCK
    t = plan.tensor("cpu")
    assert t.dtype == torch.int32
    nk = len(xk.STEP_KINDS)
    for team, lists in enumerate(plan.items):
        for k, lst in enumerate(lists):
            start, count = t[(team * nk + k) * 2].item(), t[(team * nk + k) * 2 + 1].item()
            assert t[start:start + count].tolist() == list(lst)


def test_the_plan_refuses_what_the_kernel_cannot_take():
    """The matrix memory's items need DK / 4 to divide a team's 256 threads
    or be a multiple of them, up to DK 2048; the recurrence items take DH up
    to 1024; the plan needs enough SMs for its team buffers."""
    with pytest.raises(ValueError, match="matrix memory"):
        plan_for(XLSTMConfig(embedding_dim=96, num_blocks=2, slstm_at=(1,), num_heads=1), 2, 132)
    with pytest.raises(ValueError, match="matrix memory"):  # DK 4096
        plan_for(XLSTMConfig(embedding_dim=2048, num_blocks=2, slstm_at=(1,), num_heads=1), 2, 132)
    with pytest.raises(ValueError, match="recurrence"):  # DH 2048
        plan_for(XLSTMConfig(embedding_dim=2048, num_blocks=2, slstm_at=(1,), num_heads=1, mlstm_proj_factor=1.0),
                 2, 132)
    with pytest.raises(ValueError, match="too few"):
        plan_for(FULL, 2, 8)


def test_launches_per_token():
    """2 a token on the one-launch path (the step and kernel B's tail), 68
    on the chain at the reference size."""
    dims = xk.XDims.create(FULL, 2)
    assert dims.launches_per_token(step=True) == 2 and dims.launches_per_token(tail=False, step=True) == 1
    assert dims.launches_per_token() == 68


def test_stage_times_read_the_stamps():
    """stage_times: a stage's wait is its first team's pass less the previous
    stage's last signal; its work runs from there to its own last signal;
    teams without an item (zeros) are ignored."""
    dims = xk.XDims.create(SMALL, 2)
    n = len(xk.step_stages(dims))
    stamps = torch.zeros(n, 4, 2, dtype=torch.int64)
    t = 1_000_000
    for s in range(n):
        stamps[s, 0] = torch.tensor([t + 500, t + 2_000])  # team 0: passes 0.5 us late, signals 2 us in
        stamps[s, 2] = torch.tensor([t + 700, t + 3_000])  # team 2: the last signal, 3 us in
        t += 3_000
    times = xk.stage_times(stamps, dims)
    assert [k for k, _, _ in times] == ["+".join(kinds) for kinds, _ in xk.step_stages(dims)]
    assert times[0] == ("embed", 0.0, 2.5)
    for _, wait_us, work_us in times[1:]:
        assert (wait_us, work_us) == (0.5, 2.5)
