"""Kernel F's one-launch attention (musicgen_tpu_torch/csrc/tdecode_attn.cu)
through its wrapper on CPU tensors, where it runs its plain version: the
splits of ATTN_SPLIT ring slots and their combine
(attn_combine_plain(attn_split_plain(...))).

Against the TPU kernel's math (attention_plain: one softmax over the ring and
the 6 metadata slots, the probabilities rounded to bf16 after normalising,
the stale-row fix) at TOL_T_STEP of the largest output, as chip_smoke.py
holds the kernel: the two differ by bf16 rounding of the probabilities
relative to each split's maximum (2^-9 relative each) and f32 order. Rings of
one, two and three splits (the last ragged), the newest slot at either end
and between, batch 1, 2 and 8. And the whole step through the kernel chain's
wrappers against the JAX kernel in interpret mode at a block of 160 (three
splits), at TOL_T_STEP of the largest logit: the splits' rounding moves
this model's logits by several 1e-3 from the TPU kernel's (at one split as
at three), where the plain twin, which rounds where the TPU kernel does, holds
tests/test_torch_tdecode.py's STEP_REL of 1e-3 at that file's block of 32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_tdecode as ttd
from musicgen_tpu.config import TransformerConfig as JaxTransformerConfig
from musicgen_tpu.ops import pallas_transformer_decode as jtd
from musicgen_tpu_torch.config import VOCAB
from musicgen_tpu_torch.ops import decode_kernel as dk
from musicgen_tpu_torch.ops import tdecode_kernel as tk

TOL_T_STEP = 1e-2  # chip_smoke.py's tolerance for a Transformer step and its attention
H, HD = 2, 16
LONG_BLOCK = 160  # three splits of ATTN_SPLIT = 64, the last of 32


def _dims(b: int, s: int) -> tk.TDims:
    dm = H * HD
    return tk.TDims(n_layers=1, batch=b, d_model=dm, n_heads=H, head_dim=HD, d_ff=4 * dm, ring=s, padded_vocab=64,
                    vocab_size=60, dyn_start=VOCAB.dyn_start, length_start=VOCAB.length_start)


def _inputs(b: int, s: int, c: int, seed: int):
    """Seeded attention inputs as the chain holds them: ring slot c already
    holds the new K and V rows (bf16 of zx's), meta rows 6 and 7 hold
    padding that must not count."""
    rng = np.random.default_rng(seed)
    dm = H * HD

    def bf16(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)

    zx = torch.from_numpy(rng.standard_normal((b, 3 * dm), dtype=np.float32))
    zx[:, :dm] *= 3.0  # sharp enough that one split's maximum is far above another's
    k_ring, v_ring, rel_ring = bf16(b, s, dm), bf16(b, s, dm), bf16(s, dm, scale=0.5)
    k_ring[:, c], v_ring[:, c] = zx[:, dm:2 * dm].to(torch.bfloat16), zx[:, 2 * dm:].to(torch.bfloat16)
    return zx, k_ring, v_ring, rel_ring, bf16(b, tk.META_ROWS, dm), bf16(b, tk.META_ROWS, dm), \
        bf16(tk.META_ROWS, dm, scale=0.5)


@pytest.mark.parametrize("batch", [1, 2, 8])
@pytest.mark.parametrize("ring", [50, 128, 150])
@pytest.mark.parametrize("where", ["first", "mid", "last"])
def test_attention_matches_tpu_math(batch, ring, where):
    c = {"first": 0, "mid": ring // 2 + 3, "last": ring - 1}[where]
    dims = _dims(batch, ring)
    args = (*_inputs(batch, ring, c, seed=batch * 1000 + ring + c), c, dims)
    before = sum(dk.LAUNCHES.values())
    with torch.no_grad():
        out, (part_m, part_l, part_acc) = tk.attention(*args, partials=True)
        ref = tk.attention_plain(*args)
    assert sum(dk.LAUNCHES.values()) == before  # CPU tensors launch nothing
    n = tk.attn_splits(dims)
    assert n == -(-ring // tk.ATTN_SPLIT) and part_acc.shape == (batch * H, n, HD)
    assert out.shape == (batch, H * HD) and bool(torch.isfinite(out).all())
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err < TOL_T_STEP, f"rel {err:.3e}"
    # The combine is a weighted mean of the splits: the partials' sums are positive.
    assert bool((part_l > 0).all()) and bool(torch.isfinite(part_m).all())


@pytest.fixture(scope="module")
def long_setup():
    """make_setup of tests/test_torch_tdecode.py at a block of LONG_BLOCK."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttd, "JaxTransformerConfig",
                   lambda **kw: JaxTransformerConfig(**{**kw, "block_len": LONG_BLOCK}))
        return ttd.make_setup("bf16")


def test_kernel_chain_matches_pallas_kernel_over_splits(long_setup):
    """Three steps of the kernel chain's wrappers on CPU tensors (the
    attention as splits and their combine) vs the JAX kernel, each from
    JAX's rings of that step."""
    s = long_setup
    assert s["dims"].ring == LONG_BLOCK and tk.attn_splits(s["dims"]) == 3
    jcarry = s["jcarry"]
    tok = s["logits0"][:, -1].argmax(-1).astype(np.int32)
    for i in range(3):
        carry = ttd._torch_carry(jcarry)
        jl, jcarry = jtd.fused_transformer_logits_step(s["jtp"], jnp.asarray(tok), jcarry, s["jcfg"], s["jdims"],
                                                       jnp.int32(LONG_BLOCK + i), interpret=True, quant="bf16")
        with torch.no_grad():
            got, _ = tk.fused_transformer_logits_step(s["tp"], torch.from_numpy(tok).long(), carry, s["dims"],
                                                      LONG_BLOCK + i, "none", ops=tk.KERNEL_OPS)
        assert ttd._rel(got, jl) < TOL_T_STEP, f"step {i}"
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
