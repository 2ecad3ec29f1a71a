"""The sampler tail's slice partition (csrc/decode_ops.cuh, kernel B's
cluster tail and kernel C's tail spread over its SMs), written in PyTorch as
`decode_kernel.sample_tail_sliced`, against the plain tail
(`sample_tail_plain`) and the TPU kernel's tail math
(musicgen_tpu/ops/pallas_decode.py `_tail_math`, called as a jnp function as
tests/test_torch_decode.py calls it), and the launch geometry
(`tail_geometry`) with its refusals.

The three compute lse with f32 sums in different orders (the partition
adds each slice's exp(x - m_s) and rescales the slices' sums by exp(m_s -
m)), so their weights differ by a few f32 ulps of lse: values are held to
1e-6 (plain) and 1e-5 (JAX) of the row's largest weight; the top-3 indices,
a selection under (value descending, index ascending), must be equal."""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.ops import pallas_decode as jd
from musicgen_tpu_torch.config import MambaConfig
from musicgen_tpu_torch.ops import decode_kernel as dk
from musicgen_tpu_torch.ops.grammar import grammar_mask

MAIN = dk.DecodeDims.create(MambaConfig(), 2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _dims(v, vp, dyn_start=None, length_start=None):
    if v == MAIN.vocab_size and vp == MAIN.padded_vocab:
        return MAIN
    return dataclasses.replace(MAIN, vocab_size=v, padded_vocab=vp, dyn_start=dyn_start or v // 3,
                               length_start=length_start or 2 * v // 3)


def _inputs(case: str, rows: int, v: int, vp: int, seed: int = 0):
    """(logits (R, Vp), gram (5, Vp), hist (R, V) int32, bucket (R,)) for
    one case; the pad logits are random (the tail must ignore them)."""
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((rows, vp))).astype(np.float32)
    if v == MAIN.vocab_size:
        gram = np.zeros((5, vp), np.float32)
        gram[:, :v] = grammar_mask().numpy()
    else:
        gram = ((rng.random((5, vp)) < 0.6) * rng.integers(1, 4, (5, vp))).astype(np.float32)
        gram[:, v:] = 0.0
    hist = np.zeros((rows, v), np.int32)
    for r in range(rows):
        hit = rng.integers(0, v, v // 10)
        hist[r, hit] = rng.integers(1, 30, len(hit))
    bucket = rng.integers(0, 5, rows)
    if case == "ties":
        logits = (0.5 * rng.integers(0, 4, (rows, vp))).astype(np.float32)
        hist[:] = 0
    elif case == "few_allowed":
        # Bucket 0 allows two ids, bucket 1 one: the rest of the top-3 are
        # zero weights, the lowest indices first.
        gram[0] = 0.0
        gram[0, [v // 2, v - 1]] = 1.0
        gram[1] = 0.0
        gram[1, v // 3] = 2.0
        bucket = np.arange(rows) % 2
    elif case == "window_cap":
        # Counts whose penalty exp(count ln base) passes the 1.2 cap, and some
        # just under it.
        hist[:] = rng.integers(0, 60, (rows, v))
    return (torch.from_numpy(logits), torch.from_numpy(gram), torch.from_numpy(hist),
            torch.from_numpy(bucket.astype(np.int64)))


def _jax_tail(logits, gram, hist, bucket, dims):
    rows, vp = logits.shape
    gram8 = np.zeros((8, vp), np.float32)
    gram8[:5] = gram.numpy()
    hist_rows = np.zeros((rows, vp), np.float32)
    hist_rows[:, :dims.vocab_size] = hist.numpy()
    bucket_oh = np.zeros((rows, 8), np.float32)
    bucket_oh[np.arange(rows), bucket.numpy()] = 1.0
    jdims = types.SimpleNamespace(padded_vocab=vp, vocab_size=dims.vocab_size, dyn_start=dims.dyn_start,
                                  length_start=dims.length_start)
    jv, ji = jd._tail_math(jnp.asarray(logits.numpy()), jnp.asarray(gram8), jnp.asarray(hist_rows),
                           jnp.asarray(bucket_oh), jdims)
    return np.asarray(jv)[:, :3], np.asarray(ji)[:, :3]


CASES = {
    # case: (inputs, rows, V, Vp)
    "main": ("random", 2, MAIN.vocab_size, MAIN.padded_vocab),
    "one_row": ("random", 1, MAIN.vocab_size, MAIN.padded_vocab),
    "eight_rows": ("random", 8, MAIN.vocab_size, MAIN.padded_vocab),
    "ties": ("ties", 2, MAIN.vocab_size, MAIN.padded_vocab),
    "few_allowed": ("few_allowed", 2, MAIN.vocab_size, MAIN.padded_vocab),
    "window_cap": ("window_cap", 2, MAIN.vocab_size, MAIN.padded_vocab),
    "pad_ids_few_allowed": ("few_allowed", 2, 17_000, MAIN.padded_vocab),
    "ragged_1000": ("random", 3, 1000, 1000),
    "ragged_1000_of_1024": ("few_allowed", 2, 1000, 1024),
    "ragged_ties_1001": ("ties", 2, 1001, 1001),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sliced_tail_matches_plain_and_jax(name):
    kind, rows, v, vp = CASES[name]
    dims = _dims(v, vp)
    args = _inputs(kind, rows, v, vp)
    vals, idxs = dk.sample_tail_sliced(*args, dims)
    pv, pi = dk.sample_tail_plain(*args, dims)
    jv, ji = _jax_tail(*args, dims)
    assert vals.shape == (rows, 3) and vals.dtype == torch.float32
    assert idxs.shape == (rows, 3) and idxs.dtype == torch.int64
    np.testing.assert_array_equal(idxs.numpy(), pi.numpy())
    np.testing.assert_array_equal(idxs.numpy(), ji)
    assert _rel(vals, pv) <= 1e-6
    assert _rel(vals, jv) <= 1e-5
    assert bool((idxs < v).all()), "a pad id was preferred over a real id"
    if kind == "few_allowed":
        # The allowed ids first, then the zero weights from id 0 up.
        allowed = {0: sorted([v // 2, v - 1]), 1: [v // 3]}
        for r in range(rows):
            want_ids = allowed[int(args[3][r])]
            got = idxs[r].tolist()
            assert sorted(got[:len(want_ids)]) == want_ids
            assert got[len(want_ids):] == [i for i in range(3) if i not in want_ids][:3 - len(want_ids)]
            assert bool((vals[r, len(want_ids):] == 0).all())


def test_sliced_tail_ties_go_to_the_lowest_index():
    """Equal logits and no penalty: every allowed id has the same weight, so
    the top-3 are the three lowest allowed ids, in order."""
    dims = _dims(1000, 1024)
    logits = torch.full((2, 1024), 0.25)
    gram = torch.zeros(5, 1024)
    gram[:, 100:900:7] = 1.0
    hist = torch.zeros(2, 1000, dtype=torch.int32)
    vals, idxs = dk.sample_tail_sliced(logits, gram, hist, torch.tensor([0, 3]), dims)
    assert idxs.tolist() == [[100, 107, 114]] * 2
    assert bool((vals == vals[0, 0]).all())


def test_sliced_lse_rescales_the_slices():
    """Each slice's sum is taken against its own maximum and rescaled by
    exp(m_s - m): with one logit of 10 in slice 3 and the rest at -40, the
    other slices' sums (16 terms of exp(0) each) shrink by exp(-50), and the
    weights equal those of the closed form lse = 10 + log(1 + 999 exp(-50))."""
    dims = _dims(1000, 1000)
    assert dk.tail_geometry(1000, 1000, 1).slice_ids == 16
    logits = torch.full((1, 1000), -40.0)
    logits[0, 3 * 16 + 5] = 10.0
    gram = torch.ones(5, 1000)
    hist = torch.zeros(1, 1000, dtype=torch.int32)
    vals, idxs = dk.sample_tail_sliced(logits, gram, hist, torch.tensor([2]), dims)
    lse = 10.0 + np.log1p(999 * np.exp(-50.0))
    np.testing.assert_allclose(vals.numpy(), [[lse + 40.0] * 3], rtol=1e-6)
    assert idxs.tolist() == [[0, 1, 2]]


@pytest.mark.parametrize("rows", [1, 2, 8])
def test_tail_geometry_main_path(rows):
    g = dk.tail_geometry(MAIN.padded_vocab, MAIN.vocab_size, rows)
    assert (g.cluster, g.slice_ids, g.per_lane, g.threads, g.blocks) == (16, 280, 9, 128, 16 * rows)
    assert g.threads * g.cluster == dk.TAIL_SLICES * dk.TAIL_LANES


@pytest.mark.parametrize("vp, per_lane", [(1000, 1), (1001, 1), (17920, 9), (18432, 9), (3, 1)])
def test_tail_geometry_covers_the_row(vp, per_lane):
    g = dk.tail_geometry(vp, min(vp, 1000), 1)
    assert g.per_lane == per_lane
    assert g.slice_ids == -(-vp // dk.TAIL_SLICES)
    assert g.per_lane * dk.TAIL_LANES >= g.slice_ids


@pytest.mark.parametrize("vp, v, rows, match", [
    (18433, 17914, 2, "at most 18432 ids"),
    (20000, 17914, 1, "at most 18432 ids"),
    (17920, 17914, 0, "rows"),
    (17920, 17914, dk.MAX_ROWS + 1, "rows"),
    (17920, 2, 2, "3 <= V <= Vp"),
    (1000, 1001, 2, "3 <= V <= Vp"),
])
def test_tail_geometry_refusals(vp, v, rows, match):
    with pytest.raises(ValueError, match=match):
        dk.tail_geometry(vp, v, rows)


def test_sliced_tail_refuses_a_row_the_slices_do_not_cover():
    dims = _dims(18_000, 18_440)
    args = _inputs("random", 1, 18_000, 18_440)
    with pytest.raises(ValueError, match="at most 18432 ids"):
        dk.sample_tail_sliced(*args, dims)


@pytest.mark.parametrize("rows", [1, 2])
def test_sample_tail_wrapper_on_cpu_takes_the_plain_version(rows):
    args = _inputs("random", rows, MAIN.vocab_size, MAIN.padded_vocab, seed=3)
    vals, idxs = dk.sample_tail(*args, MAIN)
    pv, pi = dk.sample_tail_plain(*args, MAIN)
    assert torch.equal(vals, pv) and torch.equal(idxs, pi)
    assert dk.LAUNCHES["sample_tail"] == 0
