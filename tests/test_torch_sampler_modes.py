"""The 'many' and 'top5' sampler modes of the port
(musicgen_tpu_torch.sample.sampler) against the JAX package's.

The 100-token count window is integer bookkeeping and must match exactly,
across its wrap-around; its divisor within 1e-6. 'many' is deterministic: its
streams on the plain step must equal JAX's for every family. 'top5' draws
from torch's generator, which cannot reproduce JAX's: at each step of a
teacher-forced stream, the five candidates must be JAX's and their
renormalised weights within 1e-5, and the draw follows the weights. The
kernel route (fused=True: the families' logits steps, here their plain
versions) runs under the same sampler body, with no sampler tail."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.sample import sampler as js
from musicgen_tpu_torch.ops.grammar import filtered_logits
from musicgen_tpu_torch.sample import sampler as ts
from tests.torch_families import BLOCK, KINDS, family, grammatical, jax_generate, metas, port_generate, prompts

N = 12
SEPARATED = 1e-3  # a plain top-1 this far ahead of the second (relative) is the kernel route's pick too


@pytest.mark.parametrize("p", [130, 40])
def test_count_window_matches_jax_exactly(p):
    """Counts, ring and head after the prompt and after each of 150 pushes:
    a prompt longer than the window and one shorter (the window fills, then
    wraps)."""
    rng = np.random.default_rng(p)
    prompt = rng.integers(0, 300, (3, p))  # a small id range: many repeats
    t_state = ts.init_count_window(torch.from_numpy(prompt))
    j_state = js.init_count_window(jnp.asarray(prompt, jnp.int32))
    push = jax.jit(js.push_count_window)

    def same():
        np.testing.assert_array_equal(t_state.hist.numpy(), np.asarray(j_state.hist))
        np.testing.assert_array_equal(t_state.ring.numpy(), np.asarray(j_state.ring))
        assert t_state.head == int(j_state.head)

    same()
    for tok in rng.integers(0, 300, (150, 3)):
        t_state = ts.push_count_window(t_state, torch.from_numpy(tok))
        j_state = push(j_state, jnp.asarray(tok, jnp.int32))
        same()
    assert int(t_state.hist.sum()) == 3 * ts.COUNT_WINDOW


def test_count_penalty_divisor_matches_jax():
    rng = np.random.default_rng(0)
    hist = rng.integers(0, 30, (4, ts.VOCAB.vocab_size)).astype(np.int32)
    got = ts.count_penalty_divisor(torch.from_numpy(hist)).numpy()
    want = np.asarray(js.count_penalty_divisor(jnp.asarray(hist)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_many_streams_match_jax(kind):
    """'many' on the plain step: the JAX package's stream token for token
    (greedy or not: the mode takes the argmax). The recurrent models take a
    prompt longer than the 100-token window, so that it evicts; the
    Transformer's fills its window."""
    prompt, meta = prompts(2, BLOCK if kind == "transformer" else 130, seed=3), metas(2, seed=3)
    want = jax_generate(kind, prompt, meta, N, mode="many", fused=False)
    got = port_generate(kind, prompt, meta, N, mode="many", fused=False)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(port_generate(kind, prompt, meta, N, seed=9, mode="many", fused=False, greedy=True), got)


@torch.no_grad()
def _top5_steps(kind, streams, prompt, meta):
    """Teacher-forced over `streams`: each step's renormalised top-5 of the
    filtered weights, from the port's plain step and from JAX's."""
    jm, params, port = family(kind)
    p = prompt.shape[1]
    t_prefill, t_step = ts.make_sampler(port, kind, block_len=BLOCK)
    j_prefill, j_step = js.make_sampler(jm, kind, BLOCK)
    j_step = jax.jit(j_step)
    t_logits, t_state = t_prefill(torch.from_numpy(prompt).long(), torch.from_numpy(meta).long())
    j_logits, j_state = j_prefill(params, jnp.asarray(prompt), jnp.asarray(meta))
    last = prompt[:, -1]
    out = []
    for i in range(N):
        tv, ti = ts._iter_top_k(filtered_logits(torch.from_numpy(last).long(), t_logits), 5)
        jv, ji = js._iter_top_k(js.filtered_logits(jnp.asarray(last), j_logits), 5)
        out.append((tv / tv.sum(1, keepdim=True), ti, np.asarray(jv) / np.asarray(jv).sum(1, keepdims=True),
                    np.asarray(ji)))
        tok = streams[:, p + i]
        t_logits, t_state = t_step(torch.from_numpy(tok).long(), t_state, p + i)
        j_logits, j_state = j_step(params, jnp.asarray(tok, jnp.int32), j_state, jnp.int32(p + i))
        last = tok
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_top5_candidates_and_weights_match_jax(kind):
    """A stochastic 'top5' stream of the port: every token among its step's
    five candidates; at each teacher-forced step the candidates equal JAX's
    and the renormalised weights agree within 1e-5."""
    prompt, meta = prompts(2, BLOCK, seed=4), metas(2, seed=4)
    streams = port_generate(kind, prompt, meta, N, seed=5, mode="top5", fused=False).numpy()
    assert grammatical(streams, BLOCK)
    for i, (tw, ti, jw, ji) in enumerate(_top5_steps(kind, streams, prompt, meta)):
        np.testing.assert_array_equal(ti.numpy(), ji, err_msg=f"step {i}")
        np.testing.assert_allclose(tw.numpy(), jw, atol=1e-5, err_msg=f"step {i}")
        assert bool((ti == torch.from_numpy(streams[:, BLOCK + i])[:, None].long()).any(dim=1).all())


def test_top5_draw_follows_the_weights():
    """20,000 draws over weights (5, 2, 1, 1, 1, 0.5, ...): the top five in
    proportion 5:2:1:1:1, within 0.02; never the sixth."""
    n = 20_000
    w = torch.zeros(n, 60)
    w[:, [9, 4, 40, 41, 2]] = torch.tensor([5.0, 2.0, 1.0, 1.0, 1.0])
    w[:, 30] = 0.5
    picks = ts._pick_next(w, torch.full((n,), 5), torch.Generator().manual_seed(2), 5, greedy=False)
    freq = np.array([(picks == i).float().mean().item() for i in (9, 4, 40, 41, 2)])
    np.testing.assert_allclose(freq, [0.5, 0.2, 0.1, 0.1, 0.1], atol=0.02)
    assert bool(torch.isin(picks, torch.tensor([9, 4, 40, 41, 2])).all())


@torch.no_grad()
def _plain_near_ties(kind, streams, prompt, meta, mode):
    """Over `streams`, the plain step's weights of `mode` (the count
    penalty for 'many', none for 'top5'): each step's kernel-route token is
    the plain top-1 wherever that leads the second by more than SEPARATED.
    Returns the (B, N) steps where it does not lead (near-ties)."""
    port, streams = family(kind)[2], torch.from_numpy(streams).long()
    prompt_t = torch.from_numpy(prompt).long()
    prefill, step = ts.make_sampler(port, kind, block_len=BLOCK)
    logits, state = prefill(prompt_t, torch.from_numpy(meta).long())
    pen = ts.init_count_window(prompt_t)
    last, p, near = prompt_t[:, -1], prompt.shape[1], []
    for i in range(N):
        w = filtered_logits(last, logits)
        if mode == "many":
            w = w / ts.count_penalty_divisor(pen.hist)
        vals, top = ts._iter_top_k(w, 2)
        tok = streams[:, p + i]
        lead = (vals[:, 0] - vals[:, 1]) > SEPARATED * vals[:, 0].abs()
        assert bool((tok == top[:, 0])[lead].all()), f"token {i} is not the plain top-1 at a separated step"
        near.append(~lead)
        pen = ts.push_count_window(pen, tok)
        logits, state = step(tok, state, p + i)
        last = tok
    return torch.stack(near, dim=1)


@pytest.mark.parametrize("kind,quant", [("mamba", "bf16"), ("mamba", "int8w"), ("transformer", "bf16"),
                                        ("xlstm", "bf16")])
@pytest.mark.parametrize("mode", ["many", "top5"])
def test_kernel_route_runs_the_logits_step(kind, quant, mode, monkeypatch):
    """fused=True in 'many' and greedy 'top5': the family's logits step (B,
    B' on an int8 pack, F with the prompt filling the window, G), never the
    sampler tail; the stream is the plain step's top-1 wherever that one
    leads (the bf16 products flip near-ties)."""
    from musicgen_tpu_torch.ops import decode_kernel, tdecode_kernel, xdecode_kernel

    steps, tails = [], []
    for mod, name in ((decode_kernel, "fused_logits_step"), (tdecode_kernel, "fused_transformer_logits_step"),
                      (xdecode_kernel, "fused_xlstm_logits_step")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, **k: steps.append(1) or _r(*a, **k))
    for mod, name in ((decode_kernel, "fused_sample_step"), (tdecode_kernel, "fused_transformer_sample_step"),
                      (xdecode_kernel, "fused_xlstm_sample_step")):
        monkeypatch.setattr(mod, name, lambda *a, **k: tails.append(1))
    prompt, meta = prompts(2, BLOCK, seed=6), metas(2, seed=6)
    streams = port_generate(kind, prompt, meta, N, mode=mode, fused=True, quant=quant, greedy=True).numpy()
    assert len(steps) == N and not tails
    assert grammatical(streams, BLOCK)
    _plain_near_ties(kind, streams, prompt, meta, mode)


def test_resident_in_another_mode_runs_the_per_token_kernels(monkeypatch):
    """resident applies to 'combined' only (JAX sampler.py:720): a Mamba
    resident call in 'many' runs B's per-token logits step, no loop kernel."""
    from musicgen_tpu_torch.ops import generate_kernel

    monkeypatch.setattr(generate_kernel, "generate_resident", lambda *a, **k: pytest.fail("the resident loop ran"))
    prompt, meta = prompts(2, BLOCK, seed=7), metas(2, seed=7)
    got = port_generate("mamba", prompt, meta, N, mode="many", resident=True)
    assert torch.equal(got, port_generate("mamba", prompt, meta, N, mode="many", fused=True))


def test_modes_are_checked():
    prompt, meta = prompts(1, BLOCK), metas(1)
    with pytest.raises(ValueError, match="sampler mode"):
        port_generate("mamba", prompt, meta, 2, mode="top3")
    cfg = ts.SamplerConfig(num_tokens=2, mode="many")
    with pytest.raises(ValueError, match="'combined' pick only"):
        ts.sample_tokens_fused_tail({}, None, None, torch.from_numpy(prompt).long(), cfg, torch.Generator(),
                                    fused_step=lambda *a: None)


def test_pick_token_with_uniforms_inverts_the_cdf():
    """pick_token's uniforms route, which the serving scheduler takes: the
    'combined' pick of ops/generate_kernel.pick_plain among the top 3 of the
    penalised weights, the window pushed with it; greedy ignores them."""
    import dataclasses

    from musicgen_tpu_torch.config import VOCAB
    from musicgen_tpu_torch.ops.generate_kernel import pick_plain

    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(prompts(64, BLOCK, seed=3)).long()
    logits = torch.from_numpy(rng.standard_normal((64, VOCAB.vocab_size)).astype(np.float32))
    u = torch.from_numpy(rng.random((64, 2)).astype(np.float32))
    cfg = ts.SamplerConfig(ring_size=2048)
    pen, last = ts.init_penalty_state(prompt, 2048), prompt[:, -1]
    tok, after = ts.pick_token(logits, last, pen, cfg, None, uniforms=u)
    w = filtered_logits(last, logits) / ts.penalty_divisor(pen.hist)
    vals, idxs = ts._iter_top_k(w, 3)
    assert torch.equal(tok, pick_plain(vals, idxs, last, u, False))
    assert not torch.equal(tok, idxs[:, 0])  # some rows pick past the top 1
    assert torch.equal(after.hist, ts.push_token(pen, tok).hist)
    top, _ = ts.pick_token(logits, last, pen, dataclasses.replace(cfg, greedy=True), None, uniforms=u)
    assert torch.equal(top, torch.argmax(w, dim=-1))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from tests.torch_cli_common import make_workdir

    return make_workdir(tmp_path_factory.mktemp("cli"))


@pytest.mark.parametrize("model,extra", [("mamba", ["--sampler", "many"]),
                                         ("mamba", ["--sampler", "top5", "--fused-decode", "on"]),
                                         ("transformer", ["--sampler", "top5"]),
                                         ("xlstm", ["--sampler", "many", "--fused-decode", "int8w"])],
                         ids=["mamba-many", "mamba-top5-on", "transformer-top5", "xlstm-many-int8w"])
def test_cli_sampler_modes_write_grammatical_midi(workdir, tmp_path, model, extra):
    from musicgen_tpu_torch.cli import generate as cli
    from tests.torch_cli_common import argv, check_streams

    check_streams(cli.main(argv(workdir, tmp_path, *extra, model=model)), tmp_path, model)


def test_cli_prompt_len_crops_the_prompt_and_keeps_the_window(workdir, tmp_path, monkeypatch):
    """--prompt-len 40 --block-len 64: 40-token prompts in a 64-token
    window. A Transformer whose prompt does not fill its window takes the
    plain step, whatever --fused-decode says (kernel F never runs)."""
    from musicgen_tpu_torch.cli import generate as cli
    from musicgen_tpu_torch.ops import tdecode_kernel
    from tests.torch_cli_common import argv, check_streams

    check_streams(cli.main(argv(workdir, tmp_path / "m", "--prompt-len", "40", "--sampler", "many")), tmp_path / "m",
                  "mamba", prompt_len=40)
    for name in ("fused_transformer_sample_step", "fused_transformer_logits_step", "build_transformer_decode_params"):
        monkeypatch.setattr(tdecode_kernel, name, lambda *a, **k: pytest.fail("kernel F's path ran"))
    for sampler in ("combined", "top5"):
        out = tmp_path / sampler
        streams = cli.main(argv(workdir, out, "--prompt-len", "40", "--fused-decode", "on", "--sampler", sampler,
                                model="transformer"))
        check_streams(streams, out, "transformer", prompt_len=40)
