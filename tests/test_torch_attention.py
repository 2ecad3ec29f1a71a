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
from musicgen_tpu_torch.ops.attention_kernel import flash_relpos_attention, flash_relpos_attention_plain
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


@pytest.mark.parametrize("t", [256, 200], ids=["aligned", "unaligned"])
def test_flash_plain_matches_jax_kernel(t):
    """Kernel D's plain version vs the TPU kernel in interpret mode; on CPU
    tensors the wrapper is the plain version."""
    q, k, v, rel = _inputs(3, b=1, h=2, t=t, d=128, rel_rows=t + 6)
    scale = 0.05
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v, rel)), scale, interpret=True)
    args = [torch.from_numpy(a) for a in (q, k, v, rel)]
    got = flash_relpos_attention_plain(*args, scale)
    assert _rel(got, want) < 1e-3
    assert torch.equal(flash_relpos_attention(*args, scale), got)
    # and, at bf16 rounding, the f32 oracle
    assert _rel(got, ta.relpos_attention(*args, scale)) < 2e-2


def test_cache_geometry_matches_jax():
    for block_len in (8, 32):
        for total in (1, 5, block_len, block_len + 3, 3 * block_len + 1):
            for streaming in (True, False):
                ages, base = tc.step_geometry(total, block_len, streaming)
                jages, jbase = jc.step_geometry(jnp.int32(total), block_len, streaming)
                np.testing.assert_array_equal(ages.numpy(), np.asarray(jages))
                assert base == int(jbase)
            assert tc.token_slot(total, block_len) == int(jc.token_slot(jnp.int32(total), block_len))
