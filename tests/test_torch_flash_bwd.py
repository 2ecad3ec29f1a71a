"""Kernel E's plain version (musicgen_tpu_torch.ops.attention_kernel) vs the
TPU kernels' custom VJP in interpret mode, the port's autograd Function, the
guard that keeps kernels without a backward out of the graph, and the
Transformer's training dispatch and dropout.

The plain backward rounds q, k, v, dO, rel, p and dS to bf16 at the points
the TPU kernels do, so it agrees with `jax.vjp` of
flash_relpos_attention_train(interpret=True) to 1e-3 of each gradient's
largest value (f32 sums in another order, and a rare flipped bf16 rounding).
Against torch.autograd through the f32 attention the bf16 operands allow
3e-2, the tolerance of tests/test_pallas_attention.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.ops.pallas_attention import flash_relpos_attention_train as jax_flash_train
from musicgen_tpu_torch.config import NUM_META, TransformerConfig
from musicgen_tpu_torch.models import transformer
from musicgen_tpu_torch.ops import attention_kernel as ak
from musicgen_tpu_torch.ops.attention import relpos_attention
from musicgen_tpu_torch.ops.build import refuse_grad


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _inputs(seed, b=1, h=2, t=200, d=128):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(4))
    rel = rng.standard_normal((h, t + NUM_META, d)).astype(np.float32)
    return q, k, v, rel, do


def test_plain_backward_matches_jax_kernel():
    """B 1, H 2, T 200 (no tile multiple), D 128, rel rows T + 6."""
    q, k, v, rel, do = _inputs(0)
    scale = 0.05
    out, vjp = jax.vjp(lambda *a: jax_flash_train(*a, scale, interpret=True), *(jnp.asarray(x) for x in (q, k, v, rel)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, trel = (torch.from_numpy(x) for x in (q, k, v, rel))
    o, lse = ak.flash_relpos_attention_plain(tq, tk, tv, trel, scale, with_lse=True)
    assert _rel(o, out) < 1e-3
    got = ak.flash_relpos_attention_bwd_plain(tq, tk, tv, trel, o, lse, torch.from_numpy(do), scale)
    for name, g, w in zip(("dq", "dk", "dv", "drel"), got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) < 1e-3, name
    assert float(got[3][:, 200:].abs().max()) == 0.0
    # on CPU tensors the wrapper is the plain version
    for g, w in zip(ak.flash_relpos_attention_bwd(tq, tk, tv, trel, o, lse, torch.from_numpy(do), scale), got):
        assert torch.equal(g, w)


def test_plain_lse_is_the_rows_logsumexp():
    q, k, v, rel, _ = _inputs(1, t=70)
    tq, tk, tv, trel = (torch.from_numpy(x) for x in (q, k, v, rel))
    _, lse = ak.flash_relpos_attention_plain(tq, tk, tv, trel, 0.05, with_lse=True)
    qb, kb, rb = (x.to(torch.bfloat16).float() for x in (tq, tk, trel))
    ti = torch.arange(70)
    below = ti[None, :] <= ti[:, None]
    from musicgen_tpu_torch.ops.attention import rel_shift

    bd = torch.where(below, rel_shift(torch.einsum("bhtd,hsd->bhts", qb, rb[:, :70])), 0.0)
    s = (torch.einsum("bhtd,bhsd->bhts", qb, kb) + bd) * 0.05
    s = s.masked_fill(~(below | (ti[None, :] < NUM_META)), float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).reshape(2, 70).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [40, 133], ids=["short", "unaligned"])
def test_autograd_function_matches_f32_autograd(t):
    q, k, v, rel, do = _inputs(2, b=2, t=t)
    scale = 0.05
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, rel)]
    got = torch.autograd.grad(ak.flash_relpos_attention_train(*args, scale), args, torch.from_numpy(do))
    want = torch.autograd.grad(relpos_attention(*args, scale), args, torch.from_numpy(do))
    for g, w in zip(got, want):
        assert _rel(g, w) < 3e-2


def test_refuse_grad_rule():
    """The rule the CUDA wrappers of kernels A and D (prefill form) apply
    before a launch: under grad mode, any input that requires grad raises;
    under no_grad, or with no such input, nothing happens."""
    x, w = torch.zeros(3), torch.zeros(3, requires_grad=True)
    refuse_grad("k", x, x)
    with pytest.raises(RuntimeError, match="has no backward"):
        refuse_grad("k", x, w)
    with torch.no_grad():
        refuse_grad("k", x, w)


def _tiny(impl, dropout=0.0):
    cfg = TransformerConfig(n_embd=64, n_heads=2, n_layer=2, block_len=16, metadata_vocab_size=9,
                            attention_impl=impl, dropout=dropout)
    return transformer.init_weights_(transformer.empty_model(cfg, "cpu"), 0)


@pytest.mark.parametrize("impl", ["flash", "auto", "xla"])
def test_training_dispatch(monkeypatch, impl):
    """With grad mode on, `forward` reaches flash_relpos_attention_train for
    'flash' (and 'auto' on CUDA; on the CPU 'auto' is the plain attention);
    `prefill` never does, and `forward` under no_grad takes the prefill
    form."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(transformer, "flash_relpos_attention_train",
                        spy("train", ak.flash_relpos_attention_train))
    monkeypatch.setattr(transformer, "flash_relpos_attention", spy("prefill", ak.flash_relpos_attention))
    model = _tiny(impl)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 17914, (2, 16)))
    meta = torch.from_numpy(rng.integers(0, 9, (2, NUM_META)))
    flash = impl == "flash"
    model(tokens, meta).sum().backward()
    assert calls == ["train"] * 2 * flash
    calls.clear()
    model.prefill(tokens, meta)
    assert calls == ["prefill"] * 2 * flash
    calls.clear()
    with torch.no_grad():
        model(tokens, meta)
    assert calls == ["prefill"] * 2 * flash
    assert all(p.grad is not None for p in model.parameters())


def test_dropout_only_in_train_mode():
    model = _tiny("xla", dropout=0.5)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, 17914, (2, 16)))
    meta = torch.from_numpy(rng.integers(0, 9, (2, NUM_META)))
    with torch.no_grad():
        model.eval()
        assert torch.equal(model(tokens, meta), model(tokens, meta))
        model.train()
        assert not torch.equal(model(tokens, meta), model(tokens, meta))
        # prefill and step never drop, in either mode
        assert torch.equal(model.prefill(tokens, meta)[0], model.prefill(tokens, meta)[0])
        model.eval()
        a = model.prefill(tokens, meta)[0]
        model.train()
        assert torch.equal(a, model.prefill(tokens, meta)[0])
    # the dropout modules add no state: a state dict without them loads strictly
    fresh = transformer.empty_model(dataclasses.replace(model.cfg, dropout=0.0), "cpu")
    fresh.load_state_dict(model.state_dict(), strict=True)
