"""The port's validation sampler, sample.sampler.reference_windowed_generate
(a full forward of the slid window for every token), against the JAX
package's, for the three families in its three modes: greedy streams
identical token for token, in a window that fills without sliding and in
one that slides. Before the window slides, a recurrent model's cached path
(prefill and steps) sees the same tokens, so its greedy stream is the same
too.

The Transformer's is not, in either package: its forward indexes the
rel-pos table from the end of the sequence it is given (ops/attention.py
rel_shift), so the right-padded buffer's forward puts the query at the
geometry of the full window (the cached step's streaming geometry), where
the prefill of a shorter prompt puts it at the prompt's own length. Only a
prompt that fills the window gives the cached path's first token."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.sample import sampler as js
from musicgen_tpu_torch.sample import sampler as ts
from tests.torch_families import BLOCK, KINDS, family, metas, port_generate, prompts

N = 10


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["combined", "many", "top5"])
@pytest.mark.parametrize("p", [16, 28], ids=["fills", "slides"])
def test_windowed_greedy_matches_jax_and_the_cached_path(kind, mode, p):
    """p = 16: 10 tokens fill the 32-token window to 26, no slide; p = 28:
    the window is full after 4 tokens and slides for the other 6. A
    recurrent model's cached path agrees on the tokens picked before the
    first slide (BLOCK - p + 1 of them)."""
    jm, params, port = family(kind)
    prompt, meta = prompts(2, p, seed=p), metas(2, seed=p)
    got = ts.reference_windowed_generate(port, torch.from_numpy(prompt).long(), torch.from_numpy(meta).long(), N,
                                         BLOCK, torch.Generator().manual_seed(0), greedy=True, mode=mode)
    want = js.reference_windowed_generate(jm, params, jnp.asarray(prompt), jnp.asarray(meta), N, BLOCK,
                                          jax.random.PRNGKey(0), greedy=True, mode=mode)
    assert got.shape == (2, p + N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if kind != "transformer":
        cached = port_generate(kind, prompt, meta, N, greedy=True, mode=mode, fused=False)
        before = min(N, BLOCK - p + 1)
        assert torch.equal(got[:, :p + before], cached[:, :p + before])


@pytest.mark.parametrize("mode", ["combined", "many", "top5"])
def test_windowed_transformer_full_window_starts_as_the_cached_path(mode):
    """A prompt that fills the Transformer's window: its first token is the
    cached path's (the prefill's geometry is the full window's); the whole
    stream is JAX's."""
    jm, params, port = family("transformer")
    prompt, meta = prompts(2, BLOCK, seed=5), metas(2, seed=5)
    got = ts.reference_windowed_generate(port, torch.from_numpy(prompt).long(), torch.from_numpy(meta).long(), 4,
                                         BLOCK, torch.Generator(), greedy=True, mode=mode)
    want = js.reference_windowed_generate(jm, params, jnp.asarray(prompt), jnp.asarray(meta), 4, BLOCK,
                                          jax.random.PRNGKey(0), greedy=True, mode=mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cached = port_generate("transformer", prompt, meta, 4, greedy=True, mode=mode, fused=False)
    assert torch.equal(got[:, :BLOCK + 1], cached[:, :BLOCK + 1])


def test_windowed_keeps_one_shape_and_slides_the_buffer(monkeypatch):
    """Every forward takes the fixed (B, BLOCK) buffer; while it fills, the
    new token is written at column n (after n real tokens), and once full
    the buffer slides left by one with the token in the last column."""
    port = family("mamba")[2]
    seen = []
    real = type(port).forward

    def spy(self, tokens, meta):
        seen.append(tokens.clone())
        return real(self, tokens, meta)

    monkeypatch.setattr(type(port), "forward", spy)
    p = 30
    prompt, meta = prompts(1, p, seed=1), metas(1, seed=1)
    out = ts.reference_windowed_generate(port, torch.from_numpy(prompt).long(), torch.from_numpy(meta).long(), 5,
                                         BLOCK, torch.Generator(), greedy=True)
    assert [tuple(t.shape) for t in seen] == [(1, BLOCK)] * 5
    stream = out[0]
    assert torch.equal(seen[0][0], torch.cat([stream[:p], torch.zeros(BLOCK - p, dtype=torch.int64)]))
    assert torch.equal(seen[1][0, :p + 1], stream[:p + 1])  # written at column 30
    assert torch.equal(seen[2][0], stream[:BLOCK])  # full: 32 real tokens
    assert torch.equal(seen[3][0], stream[1:BLOCK + 1])  # slid by one
    assert torch.equal(seen[4][0], stream[2:BLOCK + 2])


@pytest.mark.parametrize("mode", ["combined", "top5"])
def test_windowed_stochastic_streams_are_grammatical(mode):
    from tests.torch_families import grammatical

    port = family("xlstm")[2]
    prompt, meta = prompts(2, 28, seed=3), metas(2, seed=3)
    out = ts.reference_windowed_generate(port, torch.from_numpy(prompt).long(), torch.from_numpy(meta).long(), N,
                                         BLOCK, torch.Generator().manual_seed(3), greedy=False, mode=mode)
    assert out.shape == (2, 28 + N) and grammatical(out, 28)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from tests.torch_cli_common import make_workdir

    return make_workdir(tmp_path_factory.mktemp("cli"))


@pytest.mark.parametrize("model", ["mamba", "transformer", "xlstm"])
def test_cli_reference_windowing_equals_the_cached_path(workdir, tmp_path, model):
    """cli.generate --reference-windowing --greedy, 8 tokens: a recurrent
    model's 40-token prompts in a 64-token window (nothing slides) give the
    cached path's greedy streams; a Transformer's 64-token prompts give its
    first token (module docstring)."""
    from musicgen_tpu_torch.cli import generate as cli
    from tests.torch_cli_common import argv, check_streams

    p = 64 if model == "transformer" else 40
    extra = ["--greedy", "--prompt-len", str(p), "--length", "8"]
    windowed = cli.main(argv(workdir, tmp_path / "w", "--reference-windowing", *extra, model=model))
    check_streams(windowed, tmp_path / "w", model, prompt_len=p, length=8)
    cached = cli.main(argv(workdir, tmp_path / "c", *extra, model=model))
    for band in windowed:
        n = p + 1 if model == "transformer" else p + 8
        np.testing.assert_array_equal(windowed[band][:, :n], cached[band][:, :n])
