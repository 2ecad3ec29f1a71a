"""Port TransformerLM (musicgen_tpu_torch.models.transformer) vs the JAX
TransformerLM on the same weights, moved across by interop.from_jax_params,
and the weight bridge for the reference Transformer's layout.

Logits and caches agree to 1e-4 relative (max |diff| / max |value|) in f32:
the two frameworks sum in different orders, nothing more."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.config import NUM_META
from musicgen_tpu.config import TransformerConfig as JaxTransformerConfig
from musicgen_tpu.interop.torch_import import export_state_dict
from musicgen_tpu.models.transformer import TransformerLM as JaxTransformerLM
from musicgen_tpu.sample.cache import step_geometry, token_slot
from musicgen_tpu_torch.config import TransformerConfig
from musicgen_tpu_torch.interop import config_from_state_dict, from_jax_params, load_checkpoint, load_model
from musicgen_tpu_torch.models.transformer import TransformerLM, empty_model, init_weights_
from musicgen_tpu_torch.sample import cache as tc

REL = 1e-4
B, P = 2, 24


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def pair():
    jcfg = JaxTransformerConfig(n_embd=128, n_heads=4, n_layer=2, block_len=32, metadata_vocab_size=20,
                                attention_impl="xla")
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (B, P))
    meta = rng.integers(0, cfg.metadata_vocab_size, (B, NUM_META))
    jm = JaxTransformerLM(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(prompt[:, :8]), jnp.asarray(meta))
    params = jax.tree.map(np.asarray, params)
    port = load_model(from_jax_params(params, cfg), "cpu")
    return jcfg, cfg, jm, params, port, prompt, meta


def test_forward_matches_jax(pair):
    jcfg, cfg, jm, params, port, prompt, meta = pair
    want = jax.jit(jm.apply)(params, jnp.asarray(prompt), jnp.asarray(meta))
    with torch.no_grad():
        got = port(torch.from_numpy(prompt), torch.from_numpy(meta))
    assert got.shape == (B, P, cfg.vocab_size)
    assert _rel(got, want) < REL


def test_prefill_then_steps_match_jax(pair):
    """Prefill logits and padded caches, then 8 ring-KV steps (a 24-token
    prompt in a 32-slot window: the window fills and starts to wrap)."""
    jcfg, cfg, jm, params, port, prompt, meta = pair
    prefill = jax.jit(lambda p, t, m: jm.apply(p, t, m, method=JaxTransformerLM.prefill))
    want, jcaches = prefill(params, jnp.asarray(prompt), jnp.asarray(meta))
    with torch.no_grad():
        got, caches = port.prefill(torch.from_numpy(prompt), torch.from_numpy(meta))
    assert _rel(got, want) < REL
    for c, jcache in zip(caches, jcaches):
        for name in ("k", "v"):
            assert c[name].shape == (B, cfg.n_heads, cfg.seq_len, cfg.n_embd // cfg.n_heads)
            assert _rel(c[name], jcache[name]) < REL
    step = jax.jit(lambda p, t, c, s, a, r: jm.apply(p, t, c, s, a, r, method=JaxTransformerLM.step))
    block = 16  # a sampling window shorter than the model's, as --block-len allows
    for i, tok in enumerate(prompt[:, :8].T):
        idx = P + i
        ages, base = step_geometry(jnp.int32(idx + 1), block)
        ages = jnp.pad(ages, (0, cfg.seq_len - ages.shape[0]), constant_values=-1)
        jlogits, jcaches = step(params, jnp.asarray(tok, jnp.int32), jcaches,
                                token_slot(jnp.int32(idx), block), ages, base)
        tages, tbase = tc.step_geometry(idx + 1, block)
        tages = torch.nn.functional.pad(tages, (0, cfg.seq_len - tages.shape[0]), value=-1)
        with torch.no_grad():
            logits, caches = port.step(torch.from_numpy(tok), caches, tc.token_slot(idx, block), tages, tbase)
        assert _rel(logits, jlogits) < REL
    assert _rel(caches[1]["k"], jcaches[1]["k"]) < REL


def test_from_jax_params_matches_jax_export(pair):
    jcfg, cfg, jm, params, port, prompt, meta = pair
    want = export_state_dict("transformer", params, jcfg)
    got = from_jax_params(params, cfg)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value, np.float32), err_msg=key)
    assert sorted(port.state_dict()) == sorted(want)


def test_checkpoint_roundtrip_ignores_tril(tmp_path):
    cfg = TransformerConfig(n_embd=64, n_heads=2, n_layer=3, block_len=16, metadata_vocab_size=12)
    model = init_weights_(empty_model(cfg, "cpu"), seed=5).eval()
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    for i in range(cfg.n_layer):  # the reference saves its causal-mask buffers
        sd[f"module.blocks.{i}.sa.heads.0.tril"] = torch.tril(torch.ones(cfg.seq_len, cfg.seq_len))
    path = tmp_path / "transformer.pth"
    torch.save(sd, path)
    loaded = load_checkpoint(str(path))
    assert not any(k.endswith(".tril") for k in loaded)
    assert config_from_state_dict(loaded) == cfg
    again = load_model(loaded, "cpu")
    assert isinstance(again, TransformerLM)
    tokens = torch.randint(0, cfg.vocab_size, (2, 10), generator=torch.Generator().manual_seed(0))
    meta = torch.zeros(2, NUM_META, dtype=torch.int64)
    with torch.no_grad():
        assert torch.equal(model(tokens, meta), again(tokens, meta))


def test_reference_size_layout():
    with torch.device("meta"):
        model = TransformerLM(TransformerConfig())
    sd = model.state_dict()
    assert sd["blocks.7.sa.heads.7.query.weight"].shape == (128, 1024)
    assert sd["blocks.0.sa.heads.0.rel_pos_emb"].shape == (2054, 128)
    assert sd["lm_head.weight"].shape == (17914, 1024) and sd["lm_head.bias"].shape == (17914,)
    assert sd["blocks.0.ffwd.net.0.weight"].shape == (4096, 1024)
    assert config_from_state_dict(sd) == TransformerConfig()
