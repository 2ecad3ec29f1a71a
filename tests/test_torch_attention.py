"""The port's attention ops (musicgen_tpu_torch.ops.attention), kernel D's
plain version (ops.attention_kernel) and the ring-cache geometry
(sample.cache) vs the JAX package.

The f32 ops agree to 1e-5 relative (max |diff| / max |value|): the two
frameworks sum in different orders. Kernel D's plain version rounds q, k, v,
rel and the probabilities to bf16 at the points the TPU kernel does and
walks the same 128-column key tiles, so it agrees with the JAX kernel in
interpret mode to 1e-3 relative (f32 order, and a rare flipped bf16
rounding of one probability)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.ops import attention as ja
from musicgen_tpu.ops.pallas_attention import flash_relpos_attention as jax_flash
from musicgen_tpu.sample import cache as jc
from musicgen_tpu_torch.ops import attention as ta
from musicgen_tpu_torch.ops.attention_kernel import (
    flash_relpos_attention,
    flash_relpos_attention_plain,
    staging_views,
)
from musicgen_tpu_torch.sample import cache as tc

REL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _inputs(seed, b=2, h=2, t=40, d=16, rel_rows=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    rel = rng.standard_normal((h, rel_rows or t, d)).astype(np.float32)
    return q, k, v, rel


def test_rel_shift_and_mask_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 9, 9)).astype(np.float32)
    np.testing.assert_array_equal(ta.rel_shift(torch.from_numpy(x)).numpy(), np.asarray(ja.rel_shift(jnp.asarray(x))))
    for t in (4, 6, 11):
        np.testing.assert_array_equal(ta.meta_causal_mask(t).numpy(), np.asarray(ja.meta_causal_mask(t)))


@pytest.mark.parametrize("torch_exact_bd", [False, True], ids=["zero_bd", "torch_exact_bd"])
def test_relpos_attention_matches_jax(torch_exact_bd):
    q, k, v, rel = _inputs(1, rel_rows=46)
    want = ja.relpos_attention(*(jnp.asarray(a) for a in (q, k, v, rel)), 0.1, torch_exact_bd=torch_exact_bd)
    got = ta.relpos_attention(*(torch.from_numpy(a) for a in (q, k, v, rel)), 0.1, torch_exact_bd=torch_exact_bd)
    assert _rel(got, want) < REL


@pytest.mark.parametrize("per_row", [False, True], ids=["ages_S", "ages_BS"])
def test_relpos_attention_step_matches_jax(per_row):
    rng = np.random.default_rng(2)
    b, h, s, d = 2, 2, 30, 16
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(2))
    rel = rng.standard_normal((h, s, d)).astype(np.float32)
    ages = rng.integers(-1, s, (b, s) if per_row else (s,)).astype(np.int32)
    want = ja.relpos_attention_step(*(jnp.asarray(a) for a in (q, kc, vc, rel)), 0.2, jnp.asarray(ages), jnp.int32(25))
    got = ta.relpos_attention_step(*(torch.from_numpy(a) for a in (q, kc, vc, rel)), 0.2,
                                   torch.from_numpy(ages).long(), 25)
    assert _rel(got, want) < REL


# (T, tolerance): the ragged lengths hold rows of few visible columns, where
# one probability near 1 whose bf16 rounding flips between the two f32 sum
# orders moves the output by up to one bf16 step, 2**-8 relative (T = 129
# shows 1.6e-3 at row 34, and both versions sit 2.7e-3 from the f32 oracle).
@pytest.mark.parametrize("t, tol", [(256, 1e-3), (200, 1e-3), (6, 2**-8), (129, 2**-8)],
                         ids=["aligned", "unaligned", "meta_only", "one_past_a_tile"])
def test_flash_plain_matches_jax_kernel(t, tol):
    """Kernel D's plain version vs the TPU kernel in interpret mode; on CPU
    tensors the wrapper is the plain version."""
    q, k, v, rel = _inputs(3, b=1, h=2, t=t, d=128, rel_rows=t + 6)
    scale = 0.05
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v, rel)), scale, interpret=True)
    args = [torch.from_numpy(a) for a in (q, k, v, rel)]
    got = flash_relpos_attention_plain(*args, scale)
    assert _rel(got, want) < tol
    assert torch.equal(flash_relpos_attention(*args, scale), got)
    # and, at bf16 rounding, the f32 oracle
    assert _rel(got, ta.relpos_attention(*args, scale)) < 2e-2


@pytest.mark.parametrize("b, h, t", [(2, 8, 2054), (1, 2, 6), (3, 1, 129)])
def test_flash_staging_views_partition_the_buffer(b, h, t):
    """Kernel D's bf16 staging buffer: k, v as (B*H, T, 128), then rel's
    first T rows as (H, T, 128), contiguous, back to back, each on a 16-byte
    boundary (the offsets csrc/flash_relpos.cu computes)."""
    stage = torch.empty((2 * b + 1) * h * t * 128, dtype=torch.bfloat16)
    k, v, rel = staging_views(stage, b, h, t)
    assert (k.shape, v.shape, rel.shape) == ((b * h, t, 128), (b * h, t, 128), (h, t, 128))
    assert all(x.is_contiguous() for x in (k, v, rel))
    base = stage.data_ptr()
    kv_bytes = b * h * t * 128 * 2
    assert (k.data_ptr() - base, v.data_ptr() - base, rel.data_ptr() - base) == (0, kv_bytes, 2 * kv_bytes)
    assert all((x.data_ptr() - base) % 16 == 0 for x in (k, v, rel))
    assert rel.data_ptr() + rel.numel() * 2 == base + stage.numel() * 2
    for bad in (stage[:-1], stage.float(), stage.view(-1, 128), torch.empty(stage.numel() * 2,
                                                                              dtype=torch.bfloat16)[::2]):
        with pytest.raises(ValueError):
            staging_views(bad, b, h, t)


def test_cache_geometry_matches_jax():
    for block_len in (8, 32):
        for total in (1, 5, block_len, block_len + 3, 3 * block_len + 1):
            for streaming in (True, False):
                ages, base = tc.step_geometry(total, block_len, streaming)
                jages, jbase = jc.step_geometry(jnp.int32(total), block_len, streaming)
                np.testing.assert_array_equal(ages.numpy(), np.asarray(jages))
                assert base == int(jbase)
            assert tc.token_slot(total, block_len) == int(jc.token_slot(jnp.int32(total), block_len))
