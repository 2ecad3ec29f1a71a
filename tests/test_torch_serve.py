"""The port's continuous-batching scheduler (musicgen_tpu_torch.serve) and
its CLI on the CPU, mirroring the single-device cases of the JAX package's
tests/test_serve.py: greedy streams equal the one-shot sampler's exactly,
whatever the slot, the pool and the admission order; a stochastic stream is
a function of (weights, prompt, seed) alone; the kernel route (the logits
steps' plain versions here) equals the one-shot stream; a pool of 16 slots
runs in groups of 8 rows; a greedy pool equals the JAX BatchScheduler's."""
import json

import numpy as np
import pytest
import torch

from musicgen_tpu_torch.config import NUM_META
from musicgen_tpu_torch.sample.cache import step_geometry, token_slot
from musicgen_tpu_torch.serve import BatchScheduler
from musicgen_tpu_torch.serve.scheduler import ring_geometry
from tests.torch_families import BLOCK, family, grammatical, metas, port_generate, prompts

P = 16  # the recurrent models' prompt length; the Transformer's fills its window (BLOCK)


def _plen(kind):
    return BLOCK if kind == "transformer" else P


def _serve(kind, lengths, slots, seeds=None, order=None, **opts):
    """Submit requests 0..n-1 (in `order`) with `lengths`; returns
    ({request: tokens}, scheduler)."""
    plen = _plen(kind)
    prompt, meta = prompts(len(lengths), plen, seed=1), metas(len(lengths), seed=1)
    sched = BatchScheduler(family(kind)[2], kind, prompt_len=plen, slots=slots, chunk=4, block_len=BLOCK, **opts)
    order = range(len(lengths)) if order is None else order
    rids = {i: sched.submit(prompt[i], meta[i], lengths[i], seed=0 if seeds is None else seeds[i]) for i in order}
    res = sched.run()
    return {i: res[rid] for i, rid in rids.items()}, sched


def _oneshot(kind, lengths, i, **opts):
    """Request i of _serve(kind, lengths, ...) through the one-shot
    generate, greedy."""
    plen = _plen(kind)
    prompt, meta = prompts(len(lengths), plen, seed=1)[i:i + 1], metas(len(lengths), seed=1)[i:i + 1]
    return port_generate(kind, prompt, meta, lengths[i], greedy=True, **opts)[0, plen:].numpy()


@pytest.mark.parametrize("kind", ["mamba", "transformer", "xlstm"])
def test_greedy_matches_oneshot_mixed_lengths(kind):
    """Four requests of mixed lengths over 2 slots (admission mid-run); the
    Transformer's prompt fills its ring of 32, so every new token wraps it,
    at per-slot offsets."""
    lengths = [6, 11, 3, 9]
    got, _ = _serve(kind, lengths, slots=2, greedy=True, fused=False)
    for i in range(len(lengths)):
        np.testing.assert_array_equal(got[i], _oneshot(kind, lengths, i, fused=False), err_msg=f"request {i}")


def test_admission_after_retirement():
    """One slot, three requests: each is admitted only when the slot frees,
    and still equals the one-shot stream."""
    got, sched = _serve("mamba", [5, 5, 5], slots=1, greedy=True, fused=False)
    for i in range(3):
        np.testing.assert_array_equal(got[i], _oneshot("mamba", [5, 5, 5], i, fused=False))
    assert sched.group_chunks == 6  # two chunks of 4 a request


@pytest.mark.parametrize("kind", ["mamba", "transformer", "xlstm"])
def test_stochastic_stream_is_composition_independent(kind):
    """The same (prompt, seed) gives the same tokens alone in a 1-slot pool
    and beside others in a 3-slot pool submitted in reverse order."""
    lengths, seeds = [8, 6, 9], [100, 101, 102]
    solo, _ = _serve(kind, lengths, slots=1, seeds=seeds, order=[2])
    crowd, _ = _serve(kind, lengths, slots=3, seeds=seeds, order=[2, 1, 0])
    np.testing.assert_array_equal(solo[2], crowd[2])
    assert grammatical(np.concatenate([prompts(3, _plen(kind), seed=1)[2], crowd[2]])[None], _plen(kind))
    other, _ = _serve(kind, lengths, slots=1, seeds=[100, 101, 103], order=[2])
    assert not np.array_equal(other[2], solo[2])  # another seed, another stream


@pytest.mark.parametrize("kind,quant", [("mamba", "bf16"), ("mamba", "int8w"), ("xlstm", "bf16"),
                                        ("xlstm", "bf16-sb16")])
def test_kernel_route_matches_oneshot(kind, quant):
    """fused=True: the pool runs the family's logits step (B, B' on an int8
    pack, G with its matrix memory stored in bf16 for -sb16), converting the
    slot state to the kernels' carry at each chunk's edges; greedy streams
    equal the one-shot kernel path's."""
    lengths = [6, 9, 3]
    got, sched = _serve(kind, lengths, slots=2, greedy=True, fused=True, quant=quant)
    assert sched.fused and sched.pack is not None
    for i in range(len(lengths)):
        np.testing.assert_array_equal(got[i], _oneshot(kind, lengths, i, fused=True, quant=quant),
                                      err_msg=f"request {i}")


def test_sixteen_slots_run_in_groups_of_eight(monkeypatch):
    """16 slots are two groups of 8 rows: each step of the kernel route
    takes at most 8 rows (MAX_ROWS), an idle group is skipped, and every
    stream equals the same request's in a pool of 4."""
    from musicgen_tpu_torch.ops import decode_kernel

    rows = []
    real = decode_kernel.fused_logits_step
    monkeypatch.setattr(decode_kernel, "fused_logits_step",
                        lambda dp, tok, *a, **k: rows.append(tok.shape[0]) or real(dp, tok, *a, **k))
    lengths, seeds = [4] * 9 + [8], list(range(10))
    wide, sched = _serve("mamba", lengths, slots=16, seeds=seeds, fused=True)
    assert sched.group_chunks == 3  # both groups for the first chunk, then the second group's last request
    assert rows == [8] * (3 * 4)
    narrow, _ = _serve("mamba", lengths, slots=4, seeds=seeds, order=list(range(9, -1, -1)), fused=True)
    for i in range(10):
        np.testing.assert_array_equal(wide[i], narrow[i], err_msg=f"request {i}")


def test_latency_stats_accounting():
    """stats() reports every completed request with sane orderings:
    submit <= admit <= first chunk <= done."""
    got, sched = _serve("mamba", [5, 5], slots=1, greedy=True, fused=False)
    st = sched.stats()
    assert sorted(st) == [0, 1]
    for s in st.values():
        assert 0.0 <= s["queue_wait_s"] <= s["ttfc_s"] <= s["wall_s"]
        assert s["tokens"] == 5.0 and s["tok_per_s"] > 0


def test_greedy_pool_matches_the_jax_scheduler():
    """The JAX package's BatchScheduler on the same small Mamba and
    requests (its XLA step on the CPU): the same greedy streams."""
    import jax.numpy as jnp

    from musicgen_tpu.serve import BatchScheduler as JaxBatchScheduler

    jm, params, _ = family("mamba")
    lengths = [6, 11, 3]
    prompt, meta = prompts(3, P, seed=1), metas(3, seed=1)
    jsched = JaxBatchScheduler(jm, params, "mamba", prompt_len=P, slots=2, chunk=4, greedy=True, block_len=BLOCK)
    ids = [jsched.submit(jnp.asarray(prompt[i]), meta[i], lengths[i]) for i in range(3)]
    want = jsched.run()
    got, _ = _serve("mamba", lengths, slots=2, greedy=True, fused=False)
    for i, rid in enumerate(ids):
        np.testing.assert_array_equal(got[i], np.asarray(want[rid]), err_msg=f"request {i}")


def test_ring_geometry_is_step_geometry_by_row():
    total = torch.tensor([1, 5, 31, 32, 33, 70])
    slot, ages, rel_base = ring_geometry(total, BLOCK, BLOCK + NUM_META + 4)
    for b, t in enumerate(total.tolist()):
        want, base = step_geometry(t, BLOCK)
        assert base == rel_base and int(slot[b]) == token_slot(t - 1, BLOCK)
        assert torch.equal(ages[b], torch.nn.functional.pad(want, (0, 4), value=-1))


def test_refusals():
    port = family("mamba")[2]
    with pytest.raises(NotImplementedError, match="item 9"):
        BatchScheduler(port, "mamba", prompt_len=P, mesh="data")
    with pytest.raises(ValueError, match="xLSTM option"):
        BatchScheduler(port, "mamba", prompt_len=P, quant="bf16-sb16")
    with pytest.raises(ValueError, match="within its window"):
        BatchScheduler(family("transformer")[2], "transformer", prompt_len=BLOCK + 1, block_len=BLOCK)
    sched = BatchScheduler(port, "mamba", prompt_len=P, fused=False)
    with pytest.raises(ValueError, match="fixed"):
        sched.submit(np.zeros(P + 1, np.int64), np.zeros(NUM_META, np.int64), 4)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from tests.torch_cli_common import make_workdir

    return make_workdir(tmp_path_factory.mktemp("serve"))


def _serve_argv(root, out, *extra, model="mamba", device="cpu"):
    ckpt = "model.pth" if model == "mamba" else f"{model}.pth"
    reqs = [{"composer": "Bach", "length": 10}, {"composer": "Mozart", "length": 12, "seed": 3},
            {"composer": "Bach", "length": 8}]
    return ["--model", model, "--ckpt", str(root / ckpt), "--data", str(root / "np"), "--metadata",
            str(root / "metadata.json"), "--requests", json.dumps(reqs), "--output", str(out), "--slots", "2",
            "--chunk", "4", "--prompt-len", "48", "--block-len", "64", "--device", device, *extra]


@pytest.mark.parametrize("model", ["mamba", "xlstm"])
def test_cli_serve_writes_midi_and_stats(workdir, tmp_path, model):
    from musicgen_tpu_torch.midi import extract_midi
    from musicgen_tpu_torch.cli import serve

    stats_path = tmp_path / "stats.json"
    out = serve.main(_serve_argv(workdir, tmp_path / "served", "--stats", str(stats_path), model=model))
    stats = json.loads(stats_path.read_text())
    assert sorted(stats) == ["aggregate_tok_per_s", "per_request", "requests", "total_tokens", "wall_s"]
    assert stats["requests"] == 3 and stats["total_tokens"] == 30 and stats["aggregate_tok_per_s"] > 0
    assert sorted(stats["per_request"]) == ["0", "1", "2"]
    assert [len(out["tokens"][r]) for r in range(3)] == [10, 12, 8]
    for rid, band in out["bands"].items():
        path = tmp_path / "served" / f"served_{band}_{model}_{rid}.mid"
        assert path.exists() and len(extract_midi(str(path))) > 0


def test_cli_serve_device_cuda_without_a_card_raises(workdir, tmp_path):
    from musicgen_tpu_torch.cli import serve

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(_serve_argv(workdir, tmp_path, device="cuda"))
    argv = _serve_argv(workdir, tmp_path, model="transformer")
    argv[argv.index("--ckpt") + 1] = str(workdir / "model.pth")
    with pytest.raises(ValueError, match="not a --model transformer"):
        serve.main(argv)
