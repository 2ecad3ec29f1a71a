"""Port MambaLM (musicgen_tpu_torch.models.mamba) vs the JAX MambaLM on the
same weights, moved across by interop.from_jax_params.

Logits agree to 1e-4 relative (max |diff| / max |logit|) in f32: the two
frameworks sum in different orders, nothing more."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.config import NUM_META, MambaConfig
from musicgen_tpu.models.mamba import MambaLM as JaxMambaLM
from musicgen_tpu_torch.interop import config_from_state_dict, from_jax_params, load_checkpoint, load_model
from musicgen_tpu_torch.models.mamba import MambaLM, empty_model, init_weights_

REL = 1e-4
B, P = 2, 40


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module", params=[False, True], ids=["no_residual", "residual"])
def pair(request):
    cfg = MambaConfig(d_model=256, n_layers=3, residual=request.param)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (B, P))
    meta = rng.integers(0, cfg.metadata_vocab_size, (B, NUM_META))
    jm = JaxMambaLM(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(prompt[:, :8]), jnp.asarray(meta))
    port = load_model(from_jax_params(jax.tree.map(np.asarray, params), cfg), "cpu")
    port.cfg = dataclasses.replace(port.cfg, residual=request.param)
    return cfg, jm, params, port, prompt, meta


def test_forward_matches_jax(pair):
    cfg, jm, params, port, prompt, meta = pair
    want = jax.jit(jm.apply)(params, jnp.asarray(prompt), jnp.asarray(meta))
    with torch.no_grad():
        got = port(torch.from_numpy(prompt), torch.from_numpy(meta))
    assert got.shape == (B, P, cfg.vocab_size)
    assert _rel(got, want) < REL


def test_prefill_then_steps_match_jax(pair):
    cfg, jm, params, port, prompt, meta = pair
    prefill = jax.jit(lambda p, t, m: jm.apply(p, t, m, method=JaxMambaLM.prefill))
    want, jstates = prefill(params, jnp.asarray(prompt), jnp.asarray(meta))
    with torch.no_grad():
        got, states = port.prefill(torch.from_numpy(prompt), torch.from_numpy(meta))
    assert _rel(got, want) < REL
    for st, jst in zip(states, jstates):
        assert st["conv"].shape == (B, cfg.d_conv - 1, cfg.conv_dim)
        np.testing.assert_allclose(st["conv"].numpy(), np.asarray(jst["conv"]), rtol=1e-5, atol=1e-5)
        assert _rel(st["ssm"], jst["ssm"]) < REL
    step = jax.jit(lambda p, t, s: jm.apply(p, t, s, method=JaxMambaLM.step))
    for tok in prompt[:, :4].T:
        jlogits, jstates = step(params, jnp.asarray(tok, jnp.int32), jstates)
        with torch.no_grad():
            logits, states = port.step(torch.from_numpy(tok), states)
        assert _rel(logits, jlogits) < REL


def test_reference_size_has_the_reference_parameter_count():
    with torch.device("meta"):
        model = MambaLM(MambaConfig())
    assert sum(p.numel() for p in model.parameters()) == 101_972_666
    sd = model.state_dict()
    assert sd["layers.0.conv1d.weight"].shape == (2176, 1, 4)
    assert sd["layers.9.in_proj.weight"].shape == (4256, 1024)
    assert sd["output_layer.weight"].shape == (17914, 1024)
    assert config_from_state_dict(sd) == MambaConfig()


def test_checkpoint_roundtrip(tmp_path):
    cfg = MambaConfig(d_model=128, n_layers=2, metadata_vocab_size=16)
    model = init_weights_(empty_model(cfg, "cpu"), seed=3).eval()
    path = tmp_path / "model.pth"
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, path)  # as DDP saves
    sd = load_checkpoint(str(path))
    assert config_from_state_dict(sd) == cfg
    again = load_model(sd, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(0))
    meta = torch.zeros(2, NUM_META, dtype=torch.int64)
    with torch.no_grad():
        assert torch.equal(model(tokens, meta), again(tokens, meta))


def test_init_weights_is_seeded():
    cfg = MambaConfig(d_model=64, n_layers=1)
    a = init_weights_(empty_model(cfg, "cpu"), seed=7).state_dict()
    b = init_weights_(empty_model(cfg, "cpu"), seed=7).state_dict()
    c = init_weights_(empty_model(cfg, "cpu"), seed=8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.0.in_proj.weight"], c["layers.0.in_proj.weight"])
    a_log = a["layers.0.A_log"]  # log U[1, 16], as the JAX package's init
    assert bool((a_log >= 0).all()) and bool((a_log <= np.log(16.0) + 1e-6).all())
