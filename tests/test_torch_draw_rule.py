"""The sampler's draw rule (musicgen_tpu_torch/sample/sampler.py): a
stochastic generation draws one (num_tokens, B, 2) tensor of uniforms, and
row i's tokens invert the CDF of u[:, i] on every route. So a row's stream
does not depend on the rows that share its call: at batch 16 the kernel
routes (their plain versions on the CPU) run two groups of 8, and each group
equals the same 8 rows generated alone on their slice of the uniforms, in
'combined' and 'top5', for Mamba per token and resident, the Transformer and
the xLSTM. The inversions follow the distributions of the generator-drawn
picks they replace (`_sample_k`, `_pick_next`): chi-square tests of
homogeneity over 20,000 draws each, p > 1e-3."""
import numpy as np
import pytest
import torch
from scipy.stats import chi2_contingency

from musicgen_tpu_torch.config import VOCAB
from musicgen_tpu_torch.ops import generate_kernel as gk
from musicgen_tpu_torch.sample import sampler as ts
from tests.torch_families import BLOCK, family, grammatical, metas, port_generate, prompts

N, B = 8, 16
SEED = 11
P_MIN = 1e-3
DRAWS = 20_000

CASES = [("mamba", "combined", {}), ("mamba", "top5", {}), ("mamba", "combined", {"resident": True}),
         ("transformer", "combined", {}), ("transformer", "top5", {}), ("xlstm", "combined", {}),
         ("xlstm", "top5", {})]


@pytest.mark.parametrize("kind,mode,opts", CASES,
                         ids=[f"{k}-{m}{'-resident' if o else ''}" for k, m, o in CASES])
def test_a_group_of_rows_streams_alone_on_its_uniforms(kind, mode, opts):
    prompt, meta = prompts(B, BLOCK, seed=7), metas(B, seed=7)
    full = port_generate(kind, prompt, meta, N, seed=SEED, mode=mode, fused=True, **opts)
    assert full.shape == (B, BLOCK + N) and grammatical(full, BLOCK)
    u = torch.rand((N, B, 2), generator=torch.Generator().manual_seed(SEED))
    port = family(kind)[2]
    for lo in (0, 8):
        alone = ts.generate(port, kind, torch.from_numpy(prompt[lo:lo + 8]).long(),
                            torch.from_numpy(meta[lo:lo + 8]).long(), N, BLOCK, torch.Generator().manual_seed(99),
                            mode=mode, fused=True, uniforms=u[:, lo:lo + 8], **opts)
        assert torch.equal(alone, full[lo:lo + 8]), f"rows {lo}-{lo + 7}"


def test_resident_and_per_token_routes_draw_alike():
    """Kernel C's loop (its plain version) and the per-token fused tail take
    the same uniforms from one generator: equal stochastic streams."""
    prompt, meta = prompts(4, BLOCK, seed=3), metas(4, seed=3)
    resident = port_generate("mamba", prompt, meta, N, seed=5, resident=True)
    per_token = port_generate("mamba", prompt, meta, N, seed=5, fused=True)
    assert torch.equal(resident, per_token)


def test_kernel_c_gets_contiguous_uniforms(monkeypatch):
    """A group of 8 of a stochastic resident run at batch 16 takes a column
    slice of the batch's uniforms, which is not contiguous; kernel C's
    wrapper refuses such a tensor on the card, so generate_resident hands
    it a contiguous copy with the same values."""
    seen = []
    launch = gk.fused_generate

    def spy(dp, vals, idxs, last, conv, ssm, pen, uniforms, *args, **kwargs):
        seen.append((uniforms.is_contiguous(), uniforms.clone()))
        return launch(dp, vals, idxs, last, conv, ssm, pen, uniforms, *args, **kwargs)

    monkeypatch.setattr(gk, "fused_generate", spy)
    prompt, meta = prompts(B, BLOCK, seed=7), metas(B, seed=7)
    port_generate("mamba", prompt, meta, N, seed=SEED, resident=True)
    u = torch.rand((N, B, 2), generator=torch.Generator().manual_seed(SEED))
    assert [c for c, _ in seen] == [True, True]
    for g, (_, got) in enumerate(seen):
        assert torch.equal(got, u[:, 8 * g:8 * g + 8])


def test_greedy_and_many_draw_nothing():
    cfg = ts.SamplerConfig(num_tokens=4)
    gen = torch.Generator().manual_seed(0)
    assert ts.draw_uniforms(ts.SamplerConfig(num_tokens=4, greedy=True), 2, gen, "cpu") is None
    assert ts.draw_uniforms(ts.SamplerConfig(num_tokens=4, mode="many"), 2, gen, "cpu") is None
    assert ts.draw_uniforms(cfg, 2, gen, "cpu").shape == (4, 2, 2)


def test_generate_refuses_uniforms_of_another_shape():
    prompt, meta = prompts(2, BLOCK), metas(2)
    with pytest.raises(ValueError, match="uniforms must be"):
        port_generate("mamba", prompt, meta, N, fused=True, uniforms=torch.rand(N, 3, 2))


def _homogeneous(a: torch.Tensor, b: torch.Tensor, ids) -> float:
    """The chi-square test's p of two samples of picks over `ids`."""
    table = np.array([[int((x == i).sum()) for i in ids] for x in (a, b)])
    table = table[:, table.sum(axis=0) > 0]
    return chi2_contingency(table)[1]


def test_top5_inversion_follows_pick_next():
    """'top5': invert_pick over the top five against _pick_next's draw, on
    weights (5, 2, 1, 1, 1, 0.5, ...) and on weights with only three nonzero
    candidates (a zero weight is never picked)."""
    gen = torch.Generator().manual_seed(4)
    for weights in ([5.0, 2.0, 1.0, 1.0, 1.0], [3.0, 0.0, 1.0, 2.0, 0.0]):
        w = torch.zeros(DRAWS, 60)
        ids = [9, 4, 40, 41, 2]
        w[:, ids] = torch.tensor(weights)
        w[:, 30] = 0.5 if weights[-1] else 0.0
        vals, idxs = ts._iter_top_k(w, 5)
        inv = ts.invert_pick(vals, idxs, torch.rand(DRAWS, generator=gen))
        drawn = ts._pick_next(w, torch.full((DRAWS,), 5), gen, 5, greedy=False)
        allowed = [i for i, x in zip(ids, weights) if x > 0]
        assert bool(torch.isin(inv, torch.tensor(allowed)).all())
        assert _homogeneous(inv, drawn, allowed) > P_MIN


def test_combined_inversion_follows_sample_k_and_pick_next():
    """'combined': pick_plain's k-choice and pick from two uniforms against
    _sample_k's and _pick_next's draws, after a token of each field, on
    weights (6, 3, 1)."""
    gen = torch.Generator().manual_seed(6)
    vals = torch.tensor([[6.0, 3.0, 1.0]]).expand(DRAWS, 3)
    idxs = torch.tensor([[7, 3, 30]]).expand(DRAWS, 3)
    w = torch.zeros(DRAWS, 40)
    w[:, 7], w[:, 3], w[:, 30] = 6.0, 3.0, 1.0
    for tok in (5, VOCAB.dyn_start + 1, VOCAB.length_start + 1, VOCAB.time_start + 1, VOCAB.tempo_start + 1):
        last = torch.full((DRAWS,), tok)
        inv = gk.pick_plain(vals, idxs, last, torch.rand(DRAWS, 2, generator=gen), greedy=False)
        drawn = ts._pick_next(w, ts._sample_k(last, gen), gen, 3, greedy=False)
        assert _homogeneous(inv, drawn, [7, 3, 30]) > P_MIN, f"after token {tok}"
