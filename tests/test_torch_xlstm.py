"""Port XLSTMLM (musicgen_tpu_torch.models.xlstm) vs the JAX XLSTMLM on the
same weights, moved across by interop.from_jax_params with the JAX model's
full-Dense sLSTM input gates; the NX-AI layout (head-wise gates, no
LayerNorm biases) through the port's loader; the family detection of
config_from_state_dict; and the sLSTM scan's route: kernel H's grad refusal,
the shapes it takes.

Logits agree to 1e-4 relative (max |diff| / max |logit|) in f32: the two
frameworks sum in different orders, nothing more."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.config import NUM_META, MambaConfig, TransformerConfig, XLSTMConfig
from musicgen_tpu.interop.torch_import import export_state_dict
from musicgen_tpu.models.xlstm import XLSTMLM as JaxXLSTMLM
from musicgen_tpu_torch import config as pconfig
from musicgen_tpu_torch.interop import config_from_state_dict, from_jax_params, load_checkpoint, load_model
from musicgen_tpu_torch.models import mamba, transformer
from musicgen_tpu_torch.models.xlstm import SLSTMLayer, XLSTMLM, empty_model, init_weights_, runs_kernel_h
from musicgen_tpu_torch.ops import slstm_kernel
from musicgen_tpu_torch.ops.slstm_kernel import slstm_scan

REL = 1e-4
B, P = 2, 40
CFG = XLSTMConfig(embedding_dim=64, num_blocks=3, slstm_at=(1,), metadata_vocab_size=16)


def port_cfg(cfg):
    return pconfig.XLSTMConfig(**dataclasses.asdict(cfg))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, CFG.vocab_size, (B, P))
    meta = rng.integers(0, CFG.metadata_vocab_size, (B, NUM_META))
    jm = JaxXLSTMLM(CFG)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(prompt[:, :8]),
                                                       jnp.asarray(meta)))
    port = load_model(from_jax_params(params, port_cfg(CFG)), "cpu")
    prefill = jax.jit(lambda p, t, m: jm.apply(p, t, m, method=JaxXLSTMLM.prefill))
    want, jstates = prefill(params, jnp.asarray(prompt), jnp.asarray(meta))
    return jm, params, port, prompt, meta, want, jstates


def test_config_fields_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(XLSTMConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(pconfig.XLSTMConfig)}
    assert pf == jf


def test_forward_matches_jax(pair):
    jm, params, port, prompt, meta, *_ = pair
    want = jax.jit(jm.apply)(params, jnp.asarray(prompt), jnp.asarray(meta))
    with torch.no_grad():
        got = port(torch.from_numpy(prompt), torch.from_numpy(meta))
    assert got.shape == (B, P, CFG.vocab_size)
    assert _rel(got, want) < REL


def test_prefill_then_steps_match_jax(pair):
    jm, params, port, prompt, meta, want, jstates = pair
    with torch.no_grad():
        got, states = port.prefill(torch.from_numpy(prompt), torch.from_numpy(meta))
    assert _rel(got, want) < REL
    for st, jst in zip(states, jstates):
        kind = "slstm" if "slstm" in st else "mlstm"
        assert _rel(st["conv"], jst["conv"]) < REL
        for a, b in zip(st[kind], jst[kind]):
            assert _rel(a, b) < REL
    step = jax.jit(lambda p, t, s: jm.apply(p, t, s, method=JaxXLSTMLM.step))
    tok = np.array(jnp.argmax(want[:, -1], -1))
    for _ in range(3):
        want_l, jstates = step(params, jnp.asarray(tok), jstates)
        with torch.no_grad():
            got_l, states = port.step(torch.from_numpy(tok), states)
        assert got_l.shape == (B, CFG.vocab_size)
        assert _rel(got_l, want_l) < REL
        tok = np.array(jnp.argmax(want_l, -1))


def test_nxai_layout_loads_with_the_same_logits(pair, tmp_path):
    """A head-wise NX-AI dict (export_state_dict after making the sLSTM input
    gates block-diagonal, as tests/test_torch_import.py does) loads into the
    port, gates expanded and the absent LayerNorm biases zero, and gives the
    JAX model's logits on the same (masked) weights."""
    jm, params, _, prompt, meta, *_ = pair
    params = jax.tree.map(np.array, params)
    dh = CFG.embedding_dim // CFG.num_heads
    mask = np.zeros((CFG.embedding_dim, CFG.embedding_dim), bool)
    for h in range(CFG.num_heads):
        mask[h * dh:(h + 1) * dh, h * dh:(h + 1) * dh] = True
    for i in CFG.slstm_at:
        lp = params["params"]["stack"][f"block_{i}"]["slstm"]
        for gate in ("w_i", "w_f", "w_z", "w_o"):
            lp[gate]["kernel"] = np.where(mask, lp[gate]["kernel"], 0.0).astype(np.float32)
    sd = export_state_dict("xlstm", params, CFG)
    assert sd["layers.blocks.1.xlstm.igate.weight"].shape == (CFG.num_heads, dh, dh)
    assert "layers.blocks.0.xlstm_norm.bias" not in sd
    path = tmp_path / "nxai.pth"
    torch.save({k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}, path)
    sd_t = load_checkpoint(str(path))
    assert config_from_state_dict(sd_t) == port_cfg(CFG)
    port = load_model(sd_t, "cpu")
    assert port.layers.blocks[1].xlstm.igate.weight.shape == (CFG.embedding_dim, CFG.embedding_dim)
    want = jax.jit(jm.apply)(params, jnp.asarray(prompt), jnp.asarray(meta))
    with torch.no_grad():
        got = port(torch.from_numpy(prompt), torch.from_numpy(meta))
    assert _rel(got, want) < REL


def test_config_from_state_dict_tells_the_three_families_apart(tmp_path):
    cfgs = {
        "xlstm": pconfig.XLSTMConfig(embedding_dim=32, num_blocks=4, slstm_at=(0, 3), num_heads=2,
                                     metadata_vocab_size=9),
        "mamba": pconfig.MambaConfig(d_model=64, n_layers=2, metadata_vocab_size=9),
        "transformer": pconfig.TransformerConfig(n_embd=32, n_heads=2, n_layer=2, block_len=16,
                                                 metadata_vocab_size=9),
    }
    mods = {"xlstm": init_weights_(empty_model(cfgs["xlstm"], "cpu"), 0),
            "mamba": mamba.init_weights_(mamba.empty_model(cfgs["mamba"], "cpu"), 0),
            "transformer": transformer.init_weights_(transformer.empty_model(cfgs["transformer"], "cpu"), 0)}
    for name, model in mods.items():
        path = tmp_path / f"{name}.pth"
        torch.save(model.state_dict(), path)
        sd = load_checkpoint(str(path))
        assert config_from_state_dict(sd) == cfgs[name], name
        loaded = load_model(sd, "cpu")
        assert type(loaded) is type(model)
    assert isinstance(mods["xlstm"], XLSTMLM)
    # The JAX configs' defaults agree with the port's for the other two families.
    assert dataclasses.asdict(pconfig.MambaConfig()) == dataclasses.asdict(MambaConfig())
    assert dataclasses.asdict(pconfig.TransformerConfig()) == dataclasses.asdict(TransformerConfig())


class _OnCard(torch.Tensor):
    """A CPU tensor that answers is_cuda = True: it sends a wrapper down its
    kernel path without a card."""

    @property
    def is_cuda(self):
        return True


def test_slstm_prefill_refuses_grad_on_the_kernel_path():
    """Kernel H (ops/slstm_kernel.slstm_scan) has no backward: on a CUDA
    tensor under grad mode, with weights that require grad, the wrapper
    raises rather than cut the graph. So SLSTMLayer picks its scan by grad
    mode before any launch (models/xlstm.runs_kernel_h): under grad a CUDA
    tensor takes the plain scan and stays differentiable, outside grad
    kernel H. On the CPU the plain scan runs and is differentiable."""
    cfg = pconfig.XLSTMConfig(embedding_dim=32, num_blocks=2, slstm_at=(1,), num_heads=2, metadata_vocab_size=9)
    model = init_weights_(empty_model(cfg, "cpu"), 0)
    layer = model.layers.blocks[1].xlstm
    assert isinstance(layer, SLSTMLayer)
    cell = layer.slstm_cell
    wx = torch.randn(2, 8, 4, 2, 16).as_subclass(_OnCard)
    with pytest.raises(RuntimeError, match="has no backward"):
        slstm_scan(wx, cell.r(), cell.b())
    assert not runs_kernel_h(wx)
    with torch.no_grad():
        assert runs_kernel_h(wx)
    x = torch.randn(2, 8, 32)
    y, _ = layer.prefill(x.as_subclass(_OnCard))
    assert y.grad_fn is not None
    y, _ = layer.prefill(x)
    assert y.grad_fn is not None
    y.sum().backward()
    assert layer.slstm_cell._recurrent_kernel_.grad is not None


@pytest.mark.parametrize("heads, dh, kernel", [(4, 256, True), (4, 128, True), (2, 512, False), (4, 264, False),
                                               (4, 12, False)])
def test_slstm_route_by_head_width(heads, dh, kernel):
    """Outside grad mode a CUDA tensor runs kernel H exactly at the shapes
    slstm_kernel.refusal lets through (DH <= 256, 4 DH a multiple of 32);
    a wider head takes the plain scan, decided before any launch. A CPU
    tensor always takes the plain scan."""
    wx = torch.zeros(2, 8, 4, heads, dh)
    with torch.no_grad():
        assert runs_kernel_h(wx.as_subclass(_OnCard)) is kernel
        assert (slstm_kernel.refusal(2, 8, heads, dh) is None) is kernel
        assert not runs_kernel_h(wx)
    if not kernel:
        cfg = pconfig.XLSTMConfig(embedding_dim=heads * dh, num_blocks=1, slstm_at=(0,), num_heads=heads,
                                  metadata_vocab_size=9)
        layer = init_weights_(empty_model(cfg, "cpu"), 0).layers.blocks[0].xlstm
        x = torch.randn(1, 4, heads * dh)
        with torch.no_grad():
            y, _ = layer.prefill(x.as_subclass(_OnCard))
            assert torch.equal(y, layer.prefill(x)[0])
