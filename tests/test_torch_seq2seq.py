"""The port's seq2seq translator (musicgen_tpu_torch/models/seq2seq.py) held to
the JAX package's (musicgen_tpu/models/seq2seq.py) at the JAX test's size
(embed 64, 2 blocks, 4 heads, vocabularies 100 / 120, max_len 64), JAX's
params carried across by interop.seq2seq_state_dict: forward, encode and
decode within 1e-5, an 8-token greedy loop token for token, the gradients of
JAX's test_grad_flows loss per tensor within 1e-4 of the tensor's largest
value, TutorialLayerNorm and the positional table; the full-size table
(5000 x 256), whose arguments reach 4.6e7, within a few f32 ulps of JAX's at
every position."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.models import seq2seq as jseq
from musicgen_tpu_torch.config import Config
from musicgen_tpu_torch.interop import seq2seq_state_dict
from musicgen_tpu_torch.models import registry, seq2seq

CFG = seq2seq.Seq2SeqConfig(embed_dim=64, num_blocks=2, num_heads=4, encoder_vocab_size=100,
                            output_vocab_size=120, max_len=64)
TOL = 1e-5
GRAD_TOL = 1e-4
ZERO_GRAD = 1e-6
# The full table against JAX's: the products pos * 10000^(i/d) are the same
# f32 values on both sides (the multipliers bit for bit), so what is left is
# each library's f32 sin / cos of the same argument: 1 ulp of 1.0 apart here.
TABLE_TOL = 2.4e-7


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _run(fn, *args):
    """fn(*args) through jax.jit, compiled at XLA's backend optimization
    level 0 (a third of the compile time on the CPU)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def _random_params(jm, src, out):
    """Seeded numpy weights in the init's tree (jax.eval_shape compiles
    nothing): kernels and embeddings N(0, 1/fan_in), biases N(0, 0.1), norm
    scales 1 + N(0, 0.1) and shifts U(0, 0.5) (the shift sits in the
    divisor)."""
    rng = np.random.default_rng(2)

    def leaf(path, shape):
        name = path[-1].key
        if name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape.shape)
        elif name == "shift":
            v = rng.uniform(0.0, 0.5, shape.shape)
        elif name == "bias":
            v = 0.1 * rng.standard_normal(shape.shape)
        else:
            fan_in = shape.shape[-1] if name == "embedding" else shape.shape[0]
            v = rng.standard_normal(shape.shape) / np.sqrt(fan_in)
        return v.astype(np.float32)

    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(out))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    src = rng.integers(0, CFG.encoder_vocab_size, (2, 12)).astype(np.int32)
    out = rng.integers(0, CFG.output_vocab_size, (2, 5)).astype(np.int32)
    jm = jseq.Seq2SeqTransformer(jseq.Seq2SeqConfig(**dataclasses.asdict(CFG)))
    params = _random_params(jm, src, out)
    port = registry.new_model("seq2seq", CFG, "cpu")
    port.load_state_dict(seq2seq_state_dict(params), strict=True)
    return jm, params, port.eval(), src, out


def test_forward_encode_decode_equal_jax(pair):
    jm, params, port, src, out = pair
    s, o = torch.from_numpy(src).long(), torch.from_numpy(out).long()
    with torch.no_grad():
        lp, memory = port(s, o), port.encode(s)
        lp_split = port.decode(memory, o)
    want_memory = _run(lambda p, s: jm.apply(p, s, method=jseq.Seq2SeqTransformer.encode), params, src)
    want = _run(jm.apply, params, src, out)
    assert lp.shape == (2, 1, CFG.output_vocab_size) and memory.shape == (2, 12, CFG.embed_dim)
    np.testing.assert_allclose(_np(memory), _np(want_memory), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(lp), _np(want), rtol=0, atol=TOL)
    np.testing.assert_array_equal(_np(lp_split), _np(lp))
    np.testing.assert_allclose(np.exp(_np(lp)).sum(-1), 1.0, rtol=1e-5)


def test_greedy_loop_equal_jax(pair):
    """The reference usage: encode once, decode the growing prefix and append
    the argmax, 8 tokens, on both sides from the same first token."""
    jm, params, port, src, out = pair

    def greedy(p, s, o):
        memory = jm.apply(p, s, method=jseq.Seq2SeqTransformer.encode)
        seq = o[:, :1]
        for _ in range(8):
            lp = jm.apply(p, memory, seq, method=jseq.Seq2SeqTransformer.decode)
            seq = jnp.concatenate([seq, jnp.argmax(lp[:, -1, :], -1).astype(jnp.int32)[:, None]], axis=1)
        return seq

    want = _run(greedy, params, src, out)
    with torch.no_grad():
        pm = port.encode(torch.from_numpy(src).long())
        got = torch.from_numpy(out[:, :1]).long()
        for _ in range(8):
            got = torch.cat([got, port.decode(pm, got)[:, -1, :].argmax(-1, keepdim=True)], dim=1)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_grads_equal_jax(pair):
    """The loss of the JAX test_grad_flows, -lp[:, 0, 0].mean(): every
    parameter's gradient within GRAD_TOL of its tensor's largest value. The
    key biases' gradients are zero in exact arithmetic (a key bias adds the
    same q.b to every score of a query, which the softmax cancels): on both
    sides they are rounding noise, held below ZERO_GRAD of the model's
    largest gradient."""
    jm, params, port, src, out = pair
    grads = _run(jax.grad(lambda p: -jm.apply(p, src, out)[:, 0, 0].mean()), params)
    want = seq2seq_state_dict(jax.tree.map(np.asarray, grads))
    port.zero_grad()
    (-port(torch.from_numpy(src).long(), torch.from_numpy(out).long())[:, 0, 0].mean()).backward()
    got = {name: p.grad for name, p in port.named_parameters()}
    assert sorted(got) == sorted(want)
    largest = max(float(g.abs().max()) for g in want.values())
    assert largest > 0
    for name, g in want.items():
        if name.endswith("key.bias"):
            assert max(float(g.abs().max()), float(got[name].abs().max())) <= ZERO_GRAD * largest, name
            continue
        assert float((got[name] - g).abs().max()) <= GRAD_TOL * float(g.abs().max()), name


def test_dropout_draws_from_the_generator(pair):
    """In train() mode the masks come from the caller's generator: the same
    seed gives the same log-probs, another seed others; eval() ignores it."""
    _, _, port, src, out = pair
    s, o = torch.from_numpy(src).long(), torch.from_numpy(out).long()
    with torch.no_grad():
        plain = port(s, o)
        port.train()
        try:
            a, b = (port(s, o, torch.Generator().manual_seed(7)) for _ in range(2))
            c = port(s, o, torch.Generator().manual_seed(8))
        finally:
            port.eval()
        assert torch.equal(port(s, o, torch.Generator().manual_seed(7)), plain)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, plain)


def test_tutorial_layernorm_equal_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 8)).astype(np.float32)
    scale, shift = rng.normal(size=8).astype(np.float32), rng.uniform(0.5, 1.5, 8).astype(np.float32)
    want = jseq.TutorialLayerNorm(8).apply({"params": {"scale": scale, "shift": shift}}, jnp.asarray(x))
    ln = seq2seq.TutorialLayerNorm(8)
    ln.load_state_dict({"scale": torch.from_numpy(scale), "shift": torch.from_numpy(shift)})
    with torch.no_grad():
        np.testing.assert_allclose(_np(ln(torch.from_numpy(x))), np.asarray(want), rtol=0, atol=TOL)


def test_sinusoid_table_equal_jax():
    """The test size's table, and the full-size one (max_len 5000, d 256),
    whose gap by position is printed: the multipliers are bit for bit JAX's,
    so the products are the same f32 arguments up to 4.6e7 and only the
    libraries' sin / cos of them differ."""
    np.testing.assert_allclose(_np(seq2seq.sinusoid_table(64, 64)), np.asarray(jseq._sinusoid_table(64, 64)),
                               rtol=0, atol=TABLE_TOL)
    full = Config().seq2seq
    got = _np(seq2seq.sinusoid_table(full.max_len, full.embed_dim))
    want = np.asarray(jseq._sinusoid_table(full.max_len, full.embed_dim))
    gap = np.abs(got - want).max(axis=1)
    print("full table max |port - JAX| by positions: "
          + ", ".join(f"[{lo}, {hi}) {gap[lo:hi].max():.3e}" for lo, hi in
                      ((0, 64), (64, 512), (512, 2048), (2048, full.max_len))))
    assert float(gap.max()) <= TABLE_TOL


def test_registry_builds_and_seeds_seq2seq():
    """new_model('seq2seq') takes the Config's field or a Seq2SeqConfig;
    init_model from one seed gives the same bits twice, another seed others;
    a dtype other than f32 and a config of another kind raise."""
    small = dataclasses.replace(Config(), seq2seq=CFG)
    a = registry.init_model(registry.new_model("seq2seq", small, "cpu"), "seq2seq", 3)
    b = registry.init_model(registry.new_model("seq2seq", CFG, "cpu"), "seq2seq", 3)
    c = registry.init_model(registry.new_model("seq2seq", CFG, "cpu"), "seq2seq", 4)
    for name, t in a.state_dict().items():
        assert torch.equal(t, b.state_dict()[name]), name
    assert not torch.equal(a.src_embed.weight, c.src_embed.weight)
    assert torch.equal(a.pe, seq2seq.sinusoid_table(CFG.max_len, CFG.embed_dim))
    with pytest.raises(ValueError, match="float32"):
        registry.new_model("seq2seq", CFG, "cpu", torch.bfloat16)
    with pytest.raises(TypeError, match="Seq2SeqConfig"):
        registry.new_model("seq2seq", Config().mamba, "cpu")
