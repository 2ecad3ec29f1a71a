"""Kernel H's plan on the CPU (musicgen_tpu_torch.ops.slstm_kernel): the
slab layout of R, the rank partition written out in plain PyTorch, and the
launch geometry, held to the plain scan (ops/slstm.slstm_sequential) and to
the TPU kernel `slstm_pallas(interpret=True)` on the same numpy inputs.

The partition sums each gate as CS K slices added in order, where the plain
scan takes one product: f32 rounding only, 1e-6 relative. Against the TPU
kernel: the 2e-4 of tests/test_pallas_slstm.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.ops.pallas_slstm import slstm_pallas
from musicgen_tpu_torch.ops import slstm_kernel as sk
from musicgen_tpu_torch.ops.slstm import slstm_sequential


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _inputs(seed, b, t, h, dh):
    rng = np.random.default_rng(seed)
    wx = rng.standard_normal((b, t, 4, h, dh)).astype(np.float32)
    r = (rng.standard_normal((4, h, dh, dh)) / np.sqrt(dh)).astype(np.float32)
    bias = rng.standard_normal((4, h, dh)).astype(np.float32)
    return wx, r, bias


class _OnCard(torch.Tensor):
    """A CPU tensor that answers is_cuda = True: it sends the wrapper down
    its kernel path without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("cs", [1, 2, 8, 16])
def test_pack_r_slabs_is_an_exact_permutation(cs):
    _, r, _ = _inputs(1, 1, 1, 3, 32)
    rt = torch.from_numpy(r)
    slabs = sk.pack_r_slabs(rt, cs)
    u = 32 // cs
    assert slabs.shape == (3, cs, 32, 4 * u) and slabs.is_contiguous()
    # slab[h, k, d, g U + e] = R[g, h, d, k U + e]
    for g, h, d, e in ((0, 0, 0, 0), (3, 2, 31, 31), (1, 1, 7, 17), (2, 0, 19, 5)):
        k, j = divmod(e, u)
        assert slabs[h, k, d, g * u + j] == rt[g, h, d, e]
    back = slabs.reshape(3, cs, 32, 4, u).permute(3, 0, 2, 1, 4).reshape(4, 3, 32, 32)
    assert torch.equal(back, rt)
    assert sorted(slabs.flatten().tolist()) == sorted(rt.flatten().tolist())


@pytest.mark.parametrize("cs,shape", [(8, (2, 24, 2, 64)), (16, (3, 17, 2, 32)), (8, (1, 9, 1, 8)),
                                      (8, (2, 11, 3, 24))])
def test_rank_partition_matches_the_plain_scan(cs, shape):
    """Each rank's units from its slab alone, h gathered between steps:
    the plain scan to 1e-6 relative, final state included."""
    wx, r, bias = (torch.from_numpy(a) for a in _inputs(2, *shape))
    want_h, want_s = slstm_sequential(wx, r, bias)
    got_h, got_s = sk.scan_partitioned(wx, r, bias, cs)
    assert got_h.shape == want_h.shape
    assert _rel(got_h, want_h) < 1e-6
    for a, b in zip(got_s, want_s):
        assert _rel(a, b) < 1e-6


def test_rank_partition_matches_the_tpu_kernel_at_a_ragged_t():
    """T = 38 is no multiple of the TPU kernel's 16-step chunks; B = 3 is no
    multiple of anything."""
    wx, r, bias = _inputs(3, 3, 38, 2, 32)
    want_h, want_s = slstm_pallas(jnp.asarray(wx), jnp.asarray(r), jnp.asarray(bias), chunk=16, interpret=True)
    got_h, got_s = sk.scan_partitioned(*(torch.from_numpy(a) for a in (wx, r, bias)), cs=16)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=2e-4, atol=2e-4)
    for a, b in zip(got_s, want_s):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4)


def test_scan_geometry_at_the_prefill_shape():
    """(2, 2054, 4, 256): 4 clusters of 16 ranks (64 KB of R a rank), or of 8
    (128 KB), beside two buffers of partial sums and two of h, within 227 KB."""
    geo = sk.scan_geometry(2, 2054, 4, 256)
    assert (geo.cs, geo.rows, geo.groups, geo.grid, geo.blocks) == (16, 2, 1, (16, 4, 1), 64)
    assert geo.threads == 256 and geo.slab == 64 * 1024
    portable = sk.scan_geometry(2, 2054, 4, 256, cs=8)
    assert (portable.grid, portable.blocks, portable.slab) == ((8, 4, 1), 32, 128 * 1024)
    for g in (geo, portable):
        u = 256 // g.cs
        partials, hbuf = 2 * 4 * g.cs * 2 * 4 * u, 4 * 2 * 2 * 256
        assert g.smem == g.slab + partials + hbuf <= sk.SMEM_LIMIT


def test_scan_geometry_splits_the_batch_into_row_groups():
    geo = sk.scan_geometry(9, 200, 4, 256)
    assert (geo.rows, geo.groups, geo.grid) == (8, 2, (16, 4, 2))
    assert geo.smem + 16 * geo.cs <= sk.SMEM_LIMIT
    assert sk.scan_geometry(9, 200, 4, 256, cs=8).grid == (8, 4, 2)
    assert sk.scan_geometry(8, 200, 4, 256).groups == 1
    # 16 ranks where they split DH, else 8
    assert sk.scan_geometry(1, 1, 1, 8).grid == (8, 1, 1)
    assert sk.scan_geometry(3, 37, 2, 24).cs == 8 and sk.scan_geometry(3, 37, 2, 64).cs == 16


@pytest.mark.parametrize("args", [(0, 10, 4, 64), (2, 0, 4, 64), (2, 10, 4, 24, 16), (2, 10, 4, 64, 4),
                                  (2, 10, 1, sk.WIDE_DH + 8)])
def test_scan_geometry_refuses_what_the_kernel_does_not_take(args):
    """An empty shape, a cluster that does not split DH, and a head past
    the wide kernel's 1,024 threads."""
    with pytest.raises(ValueError):
        sk.scan_geometry(*args)


@pytest.mark.parametrize("shape,dp,cs,threads,resident", [
    ((2, 10, 4, 264), 264, 8, 288, 33), ((2, 10, 4, 12), 16, 16, 256, 1), ((2, 2054, 2, 512), 512, 16, 512, 25),
    ((2, 2054, 1, 1024), 1024, 16, 1024, 11), ((2, 2054, 2, 300), 304, 16, 320, 19),
    ((9, 200, 1, 1024), 1024, 16, 1024, 2)])
def test_scan_geometry_takes_wide_and_padded_heads(shape, dp, cs, threads, resident):
    """Heads past 256 (the wide kernel: DH threads rounded up to a warp,
    `resident` rows of each K slice in shared memory, the rest read from
    L2) and head widths that are no multiple of 8 (padded with zero units),
    once refused, are taken; the whole slab stays resident up to DH = 256."""
    geo = sk.scan_geometry(*shape)
    u = dp // cs
    assert (geo.dh, geo.cs, geo.threads, geo.resident) == (dp, cs, threads, resident)
    assert geo.slab == 4 * cs * resident * 4 * u and geo.smem + 16 * cs <= sk.SMEM_LIMIT
    if dp > sk.MAX_DH:
        assert geo.smem == sk.wide_smem_bytes(dp, cs, geo.rows, resident)  # as many rows as fit
        assert resident == u or sk.wide_smem_bytes(dp, cs, geo.rows, resident + 1) + 16 * cs > sk.SMEM_LIMIT
    else:
        assert geo.smem == sk.smem_bytes(dp, cs, geo.rows) and resident == u


@pytest.mark.parametrize("shape,cs", [((2, 5, 2, 264), 8), ((1, 5, 2, 300), 16), ((2, 4, 1, 512), 16),
                                      ((1, 3, 1, 1024), 16)])
def test_wide_and_padded_partition_matches_the_plain_scan_and_the_tpu_kernel(shape, cs):
    """The partition at DH 264 (clusters of 8), 300 (padded to 304), 512
    and 1024: the plain scan and the TPU kernel (interpret) to 1e-5."""
    wx, r, bias = _inputs(5, *shape)
    got_h, got_s = sk.scan_partitioned(*(torch.from_numpy(a) for a in (wx, r, bias)), cs=cs)
    want_h, want_s = slstm_sequential(*(torch.from_numpy(a) for a in (wx, r, bias)))
    tpu_h, tpu_s = slstm_pallas(jnp.asarray(wx), jnp.asarray(r), jnp.asarray(bias), chunk=8, interpret=True)
    assert got_h.shape == want_h.shape == shape[:2] + shape[2:]
    for got, want, tpu in zip((got_h, *got_s), (want_h, *want_s), (tpu_h, *tpu_s)):
        assert _rel(got, want) < 1e-5
        assert _rel(got, tpu) < 1e-5


def test_kernel_path_raises_for_inconsistent_or_untaken_shapes():
    """On the kernel path (a tensor that says it is on the card) a shape
    the kernel does not take raises before any build or launch; nothing
    falls back to the plain scan."""
    wx, r, bias = (torch.from_numpy(a) for a in _inputs(4, 2, 5, 2, 16))
    with pytest.raises(ValueError, match="inconsistent"):
        sk.launch_geometry(wx, r[:, :1], bias)
    with pytest.raises(ValueError, match="inconsistent"):
        sk.slstm_scan(wx.as_subclass(_OnCard), r, bias[:, :, :8])
    wide = sk.WIDE_DH + 8  # past the wide kernel (DH 12 and 264, refused here once, are taken now)
    wxw, rw, bw = torch.zeros(1, 2, 4, 1, wide), torch.zeros(4, 1, wide, wide), torch.zeros(4, 1, wide)
    sk.slstm_scan.launches = 0
    with pytest.raises(ValueError, match="DH"):
        sk.slstm_scan(wxw.as_subclass(_OnCard), rw, bw)
    assert sk.slstm_scan.launches == 0
