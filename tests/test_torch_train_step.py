"""One and two Adam steps of each family (Mamba, Transformer, xLSTM) through the port's
make_lm_train_step against JAX's make_lm_train_step, from the same
JAX-initialised weights (moved across by interop.from_jax_params; JAX's
gradient tree maps through the same function, which is linear), on the same
numpy-seeded batches.

A small size, dropout 0, the plain attention. The loss agrees to 1e-5
relative, every gradient to 1e-4 of its tensor's largest value (f32 sums in
another order), and the parameters after each step to 1e-6 absolute.
Elements whose gradient is below 1e-6 in either step are left out of the
parameter check: Adam's g / (|g| + eps) turns f32 order noise in such a g
into a change of up to lr, whatever the framework."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.config import MambaConfig as JaxMambaConfig
from musicgen_tpu.config import TrainValues as JaxTrainValues
from musicgen_tpu.config import TransformerConfig as JaxTransformerConfig
from musicgen_tpu.config import XLSTMConfig as JaxXLSTMConfig
from musicgen_tpu.models.mamba import MambaLM as JaxMambaLM
from musicgen_tpu.models.transformer import TransformerLM as JaxTransformerLM
from musicgen_tpu.models.xlstm import XLSTMLM as JaxXLSTMLM
from musicgen_tpu.train import trainer as jtrainer
from musicgen_tpu_torch.config import VOCAB, MambaConfig, TrainValues, TransformerConfig, XLSTMConfig
from musicgen_tpu_torch.interop import from_jax_params
from musicgen_tpu_torch.train import trainer as T

B, L = 2, 16


def _batch(seed, meta_vocab=9):
    rng = np.random.default_rng(seed)
    v = VOCAB.vocab_size
    return rng.integers(0, v, (B, L)), rng.integers(0, v, (B, L)), rng.integers(0, meta_vocab, (B, 6))


def _jax_pair(kind):
    if kind == "mamba":
        kw = dict(d_model=32, n_layers=2, d_state=8, headdim=8, chunk_size=8, metadata_vocab_size=9)
        return JaxMambaLM(JaxMambaConfig(**kw)), MambaConfig(**kw)
    if kind == "xlstm":  # an mLSTM block and an sLSTM block (the plain scans in both frameworks)
        kw = dict(embedding_dim=32, num_blocks=2, slstm_at=(1,), num_heads=2, metadata_vocab_size=9)
        return JaxXLSTMLM(JaxXLSTMConfig(**kw)), XLSTMConfig(**kw)
    kw = dict(n_embd=32, n_heads=4, n_layer=2, block_len=L, dropout=0.0, metadata_vocab_size=9, attention_impl="xla")
    return JaxTransformerLM(JaxTransformerConfig(**kw)), TransformerConfig(**kw)


@pytest.mark.parametrize("kind", ["mamba", "transformer", "xlstm"])
def test_train_steps_match_jax(kind):
    """JAX's make_lm_train_step against the port's, from the same weights.
    JAX's gradients are read off its Adam state (mu_t = b1 mu_{t-1} +
    (1 - b1) g_t), so the JAX step is compiled once."""
    jm, cfg = _jax_pair(kind)
    batches = [_batch(10 + i) for i in range(2)]
    src0, _, meta0 = batches[0]
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(src0), jnp.asarray(meta0))
    opt = jtrainer.make_optimizer(JaxTrainValues())
    opt_state = opt.init(params)
    jstep = jtrainer.make_lm_train_step(jm, opt, donate=False)

    mod = __import__(f"musicgen_tpu_torch.models.{kind}", fromlist=["x"])
    model = mod.empty_model(cfg, "cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), cfg), strict=True)
    optimizer = T.make_optimizer(model, TrainValues())
    step = T.make_lm_train_step(model, optimizer)
    small_g = {n: torch.zeros_like(p, dtype=torch.bool) for n, p in model.named_parameters()}
    mu_prev = jax.tree.map(np.zeros_like, opt_state[0].mu)
    for i, (src, trg, meta) in enumerate(batches):
        jargs = [jnp.asarray(x, jnp.int32) for x in (src, trg, meta)]
        params, opt_state, jl = jstep(params, opt_state, *jargs, jax.random.PRNGKey(i))
        mu = jax.tree.map(np.asarray, opt_state[0].mu)
        jg = jax.tree.map(lambda m, m0: (m - 0.9 * m0) / 0.1, mu, mu_prev)
        mu_prev = mu
        loss = step(*(torch.from_numpy(x) for x in (src, trg, meta)))
        assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl)), f"step {i} loss"
        want_g = from_jax_params(jg, cfg)
        want_p = from_jax_params(jax.tree.map(np.asarray, params), cfg)
        for name, p in model.named_parameters():
            g = want_g[name]
            assert float((p.grad - g).abs().max()) <= 1e-4 * max(float(g.abs().max()), 1e-30), f"step {i} grad {name}"
            small_g[name] |= g.abs() < 1e-6
            keep = ~small_g[name]
            err = float((p.detach() - want_p[name])[keep].abs().max()) if bool(keep.any()) else 0.0
            assert err <= 1e-6, f"step {i} param {name}: {err}"
