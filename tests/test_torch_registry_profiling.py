"""The port's model registry (musicgen_tpu_torch/models/registry.py) and
profiling helpers (musicgen_tpu_torch/utils/profiling.py) against the JAX
package's: new_model(kind) for every kind, holding from_jax_params of JAX's
init_params(new_model(kind), kind), gives JAX's logits; an unknown kind
raises JAX's message; the four call sites that build models through the
registry (interop.load_model, cli.train's build_model, cli.train_classifier
and cli.evaluate timing) build bit for bit what each family's own
empty_model + init_weights_ built before; StepTimer's stats have JAX's keys
and arithmetic; trace() writes a trace file on the CPU; device_memory() is
empty without a card."""
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu import config as jconfig
from musicgen_tpu.models import registry as jregistry
from musicgen_tpu.utils import profiling as jprofiling
from musicgen_tpu_torch import config
from musicgen_tpu_torch.cli import evaluate as eval_cli
from musicgen_tpu_torch.cli import train as train_cli
from musicgen_tpu_torch.cli import train_classifier as cls_cli
from musicgen_tpu_torch.interop import config_from_state_dict, from_jax_params, load_model, xlstm_state_dict
from musicgen_tpu_torch.models import mamba, registry, transformer, xlstm
from musicgen_tpu_torch.utils import profiling

BLOCK, META_VOCAB = 16, 24
REL = 1e-4
SMALL = {
    "mamba": dict(d_model=32, n_layers=1, d_state=8, headdim=8, metadata_vocab_size=META_VOCAB),
    "xlstm": dict(embedding_dim=32, num_blocks=2, slstm_at=(1,), num_heads=2, metadata_vocab_size=META_VOCAB,
                  context_length=BLOCK),
    "transformer": dict(n_embd=32, n_heads=2, n_layer=1, block_len=BLOCK, metadata_vocab_size=META_VOCAB,
                        attention_impl="xla"),
    "classifier": dict(embedding_dim=32, num_blocks=2, slstm_at=(1,), num_heads=2, metadata_vocab_size=META_VOCAB,
                       context_length=BLOCK),
}
JAX_CONFIGS = {"mamba": jconfig.MambaConfig, "xlstm": jconfig.XLSTMConfig, "transformer": jconfig.TransformerConfig,
               "classifier": jconfig.ClassifierConfig}
PORT_CONFIG = config.Config(**{kind: registry.CONFIGS[kind](**kw) for kind, kw in SMALL.items()})
JAX_CONFIG = jconfig.Config(**{kind: JAX_CONFIGS[kind](**kw) for kind, kw in SMALL.items()})
MODULES = {"mamba": mamba, "xlstm": xlstm, "transformer": transformer, "classifier": xlstm}


def _run(fn, *args):
    """fn(*args) through jax.jit at XLA's backend optimization level 0."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def _parent_build(kind, cfg, seed, dtype=torch.float32):
    """What the call sites built before the registry: the family module's own
    empty_model and init_weights_."""
    module = MODULES[kind]
    return module.init_weights_(module.empty_model(cfg, "cpu", dtype), seed)


def _same(a, b):
    assert type(a) is type(b) and a.cfg == b.cfg
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for name in sa:
        assert sa[name].dtype == sb[name].dtype and torch.equal(sa[name], sb[name]), name


@pytest.mark.parametrize("kind", ["mamba", "xlstm", "transformer", "classifier"])
def test_new_model_holds_jax_init_params(kind):
    jm, cfg = jregistry.new_model(kind, JAX_CONFIG), getattr(PORT_CONFIG, kind)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, BLOCK)).astype(np.int32)
    meta = rng.integers(0, META_VOCAB, (2, config.NUM_META)).astype(np.int32)
    args = (tokens,) if kind == "classifier" else (tokens, meta)

    def init_and_apply(*args):
        params = jregistry.init_params(jm, kind, seed=0, block_len=BLOCK)
        return params, jm.apply(params, *args)

    params, want = jax.tree.map(np.asarray, _run(init_and_apply, *args))
    port = registry.new_model(kind, PORT_CONFIG, "cpu")
    port.load_state_dict(from_jax_params(params, cfg), strict=True)
    want = want.astype(np.float64)
    with torch.no_grad():
        got = port.eval()(*(torch.from_numpy(a).long() for a in args)).numpy().astype(np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def test_unknown_kind_raises_jax_message():
    with pytest.raises(ValueError) as jerr:
        jregistry.new_model("bogus")
    with pytest.raises(ValueError) as err:
        registry.new_model("bogus", device="cpu")
    assert str(err.value) == str(jerr.value)[:-1] + ", 'seq2seq')"
    with pytest.raises(ValueError, match="unknown model kind"):
        registry.init_model(torch.nn.Linear(1, 1), "bogus")
    with pytest.raises(TypeError, match="MambaConfig"):
        registry.new_model("mamba", PORT_CONFIG.xlstm, "cpu")
    assert registry.KINDS == jregistry.KINDS


@pytest.mark.parametrize("kind", ["mamba", "xlstm", "transformer", "classifier"])
def test_load_model_bit_for_bit(kind):
    """interop.load_model builds the family through the registry: the model
    its former body built (the config read off the weights, the family's
    own empty_model, the NX-AI expansion for an xLSTM), in eval() mode."""
    sd = _parent_build(kind, getattr(PORT_CONFIG, kind), 5).state_dict()
    cfg = config_from_state_dict(sd)
    want = MODULES[kind].empty_model(cfg, "cpu")
    want.load_state_dict(xlstm_state_dict(sd, cfg) if kind in ("xlstm", "classifier") else sd, strict=True)
    got = load_model(sd, "cpu")
    _same(got, want)
    assert not got.training


@pytest.mark.parametrize("kind,bf16", [("mamba", False), ("xlstm", True), ("transformer", False)])
def test_cli_train_build_model_bit_for_bit(kind, bf16, monkeypatch):
    """cli.train's build_model from --seed: the family's default config (here
    patched small) with --attention and --remat, in --bf16's dtype."""
    monkeypatch.setitem(train_cli.DEFAULT_CONFIGS, kind, lambda: getattr(PORT_CONFIG, kind))
    args = train_cli.parse_args(["--model", kind, "--data", "np", "--metadata", "m.json", "--seed", "7",
                                 "--device", "cpu", "--remat"] + (["--bf16"] if bf16 else []))
    cfg = dataclasses.replace(getattr(PORT_CONFIG, kind), remat=True)
    if kind == "transformer":
        cfg = dataclasses.replace(cfg, attention_impl=args.attention)
    want = _parent_build(kind, cfg, 7, torch.bfloat16 if bf16 else torch.float32)
    got = train_cli.build_model(args, torch.device("cpu"))
    _same(got, want)
    assert got.dtype == want.dtype


class _Built(Exception):
    pass


def test_cli_train_classifier_model_bit_for_bit(monkeypatch):
    """cli.train_classifier builds ClassifierConfig() (patched small) from
    --seed through the registry; its model stops the run once built."""
    built = {}

    def capture(model, kind, seed):
        built["model"] = registry.init_model(model, kind, seed)
        raise _Built

    monkeypatch.setattr(cls_cli, "ClassifierConfig", lambda: PORT_CONFIG.classifier)
    monkeypatch.setattr(cls_cli, "init_model", capture)
    with pytest.raises(_Built):
        cls_cli.main(["--data", "np", "--metadata", "m.json", "--seed", "3", "--device", "cpu"])
    _same(built["model"], _parent_build("classifier", PORT_CONFIG.classifier, 3))


@pytest.mark.parametrize("kind", ["mamba", "xlstm", "transformer"])
def test_cli_evaluate_timing_model_bit_for_bit(kind, monkeypatch):
    """cli.evaluate timing without --ckpt times the family's default model
    (patched small) from seed 0."""
    timed = {}

    def capture(model, *args, iters):
        timed["model"] = model
        return {"ms_per_forward": 0.0}

    monkeypatch.setitem(train_cli.DEFAULT_CONFIGS, kind, lambda: getattr(PORT_CONFIG, kind))
    monkeypatch.setattr(eval_cli, "TIMING_SHAPE", (1, BLOCK))
    monkeypatch.setattr(eval_cli, "time_forward", capture)
    eval_cli.main(["timing", "--model", kind, "--device", "cpu", "--iters", "1"])
    _same(timed["model"], _parent_build(kind, getattr(PORT_CONFIG, kind), 0))
    assert not timed["model"].training


def test_step_timer_equal_jax(monkeypatch):
    """The same ticks on a fake clock: the same intervals, window and stats
    (keys and values) as the JAX StepTimer."""
    clock = iter(np.cumsum(np.random.default_rng(3).uniform(0.01, 0.2, 40)).tolist() * 2)
    ticks = [next(clock) for _ in range(40)]
    for window, tokens in ((50, 2 * 2048), (7, 0)):
        timers = profiling.StepTimer(tokens, window), jprofiling.StepTimer(tokens, window)
        assert timers[0].stats() == timers[1].stats()
        for timer in timers:
            it = iter(ticks)
            monkeypatch.setattr(time, "perf_counter", lambda: next(it))
            for _ in ticks:
                timer.tick()
        monkeypatch.undo()
        assert timers[0].times == timers[1].times and len(timers[0].times) == min(window, len(ticks) - 1)
        got, want = timers[0].stats(), timers[1].stats()
        assert list(got) == list(want) == ["steps_per_sec", "tokens_per_sec", "mean_step_ms"]
        assert got == want and got["steps_per_sec"] > 0


def test_trace_writes_a_trace_file(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "trace").glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_device_memory_without_a_card():
    assert not torch.cuda.is_available() and profiling.device_memory() == {}
