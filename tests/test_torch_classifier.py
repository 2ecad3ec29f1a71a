"""The port's composer classifier (models/xlstm.XLSTMClassifier,
train/loss.classifier_bce, train/trainer.make_classifier_train_step, the
classifier layout of interop.py) against the JAX package's, on the same
seeded weights and batches at a small size (width 32, 2 blocks, sLSTM at 1).

Logits agree to 1e-4 relative (max |diff| / max |logit|, f32 sums in
another order); the BCE and the multi-hot targets to 1e-6; one and two Adam
steps to the tolerances of tests/test_torch_train_step.py (loss 1e-5
relative, gradients 1e-4 of the largest, parameters 1e-6 absolute outside
elements whose gradient is below 1e-6). One gradient vanishes: the mLSTM
input-gate bias shifts every i_t alike, which the stabiliser m absorbs
wherever |n^T q| exceeds its exp(-m) floor, and a classifier reads the last
position alone, where it does. Its exact value is ~0 and the f32 sums leave
a few 1e-8 of cancellation noise (8e-6 against the model's largest gradient
of 0.14, 4e-3 apart between the frameworks), so each tensor's largest
gradient is floored at 1e-3 of the model's largest before the 1e-4 applies;
every other tensor agrees to 4e-6 of its own largest."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.config import ClassifierConfig as JaxClassifierConfig
from musicgen_tpu.config import TrainValues as JaxTrainValues
from musicgen_tpu.interop.torch_import import export_classifier
from musicgen_tpu.models.xlstm import XLSTMClassifier as JaxXLSTMClassifier
from musicgen_tpu.train import loss as jloss
from musicgen_tpu.train import trainer as jtrainer
from musicgen_tpu_torch.config import ClassifierConfig, Config, TrainValues
from musicgen_tpu_torch.interop import config_from_state_dict, family, from_jax_params, load_checkpoint, load_model
from musicgen_tpu_torch.models.xlstm import XLSTMClassifier, empty_model, init_weights_
from musicgen_tpu_torch.train import trainer as T
from musicgen_tpu_torch.train.loss import classifier_bce, make_meta_multihot

B, L, META_VOCAB = 2, 16, 12
KW = dict(embedding_dim=32, num_blocks=2, slstm_at=(1,), num_heads=2, metadata_vocab_size=META_VOCAB)
JCFG, CFG = JaxClassifierConfig(**KW), ClassifierConfig(**KW)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _batch(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG.vocab_size, (B, L)), rng.integers(0, META_VOCAB, (B, 6))


def random_params(jm, seed: int = 0, reference_layout: bool = False):
    """Seeded numpy weights in the flax tree of `jm` (shapes from eval_shape,
    which compiles nothing): lecun-normal matrices, embeddings of std 1/sqrt(d),
    unit scales, biases of std 0.1, the mLSTM forget-gate bias 3.0. With
    reference_layout, weights the reference's layout can hold: the sLSTM
    input gates keep only their head blocks and the LayerNorms have no bias."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    d, heads = CFG.embedding_dim, CFG.num_heads
    blocks = np.kron(np.eye(heads), np.ones((d // heads, d // heads))).astype(np.float32)

    def fill(path, leaf):
        name, parent = path[-1].key, path[-2].key if len(path) > 1 else ""
        if name in ("scale", "outnorm_scale", "learnable_skip", "gn_scale"):
            return np.ones(leaf.shape, np.float32)
        if parent == "fgate" and name == "bias":
            return np.full(leaf.shape, 3.0, np.float32)
        if reference_layout and name == "bias" and parent in ("ln", "ln_ffn", "post_norm"):
            return np.zeros(leaf.shape, np.float32)
        std = d ** -0.5 if name == "embedding" else 0.1 if name == "bias" or leaf.ndim < 2 else leaf.shape[-2] ** -0.5
        w = (std * rng.standard_normal(leaf.shape)).astype(np.float32)
        return w * blocks if reference_layout and parent in ("w_i", "w_f", "w_z", "w_o") else w

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_config_matches_jax():
    assert dataclasses.asdict(ClassifierConfig()) == dataclasses.asdict(JaxClassifierConfig())
    assert Config().classifier == ClassifierConfig()
    stack = CFG.stack
    assert (stack.embedding_dim, stack.num_blocks, stack.slstm_at, stack.num_heads) == (32, 2, (1,), 2)


def test_logits_match_jax():
    jm = JaxXLSTMClassifier(JCFG)
    params = random_params(jm)
    src, _ = _batch(1)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(src)))
    model = load_model(from_jax_params(params, CFG), "cpu")
    assert isinstance(model, XLSTMClassifier)
    with torch.no_grad():
        got = model(torch.from_numpy(src)).numpy()
    assert got.shape == (B, META_VOCAB)
    assert _rel(got, want) <= 1e-4


def test_bce_and_multihot_match_jax():
    """Random logits against meta rows with repeated ids (a padded genre
    slot), an id at the vocab's edge and ids past it, which set nothing."""
    rng = np.random.default_rng(3)
    logits = (3.0 * rng.standard_normal((4, META_VOCAB))).astype(np.float32)
    meta = rng.integers(0, META_VOCAB, (4, 6))
    meta[0, 1:5] = 2
    meta[1, 5] = META_VOCAB - 1
    meta[2, 0], meta[3, 3] = META_VOCAB, META_VOCAB + 7
    hot = make_meta_multihot(torch.from_numpy(meta), META_VOCAB).numpy()
    np.testing.assert_allclose(hot, np.asarray(jloss.make_meta_multihot(jnp.asarray(meta), META_VOCAB)), atol=1e-6)
    assert hot[2].sum() == len(set(meta[2]) - {META_VOCAB})
    got = float(classifier_bce(torch.from_numpy(logits), torch.from_numpy(meta)))
    want = float(jloss.classifier_bce(jnp.asarray(logits), jnp.asarray(meta)))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_adam_steps_match_jax():
    """JAX's make_classifier_train_step against the port's from the same
    weights; JAX's gradients are read off its Adam state (mu_t = b1 mu_{t-1}
    + (1 - b1) g_t), as tests/test_torch_train_step.py does."""
    jm = JaxXLSTMClassifier(JCFG)
    params = random_params(jm)
    opt = jtrainer.make_optimizer(JaxTrainValues())
    opt_state = opt.init(params)
    jstep = jtrainer.make_classifier_train_step(jm, opt, donate=False)
    model = load_model(from_jax_params(params, CFG), "cpu")
    step = T.make_classifier_train_step(model, T.make_optimizer(model, TrainValues()))
    small_g = {n: torch.zeros_like(p, dtype=torch.bool) for n, p in model.named_parameters()}
    mu_prev = jax.tree.map(np.zeros_like, opt_state[0].mu)
    for i in range(2):
        src, meta = _batch(10 + i)
        params, opt_state, jl = jstep(params, opt_state, jnp.asarray(src, jnp.int32), jnp.asarray(meta, jnp.int32))
        mu = jax.tree.map(np.asarray, opt_state[0].mu)
        jg = jax.tree.map(lambda m, m0: (m - 0.9 * m0) / 0.1, mu, mu_prev)
        mu_prev = mu
        loss = step(torch.from_numpy(src), torch.from_numpy(meta))
        assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl)), f"step {i} loss"
        want_g = from_jax_params(jg, CFG)
        want_p = from_jax_params(jax.tree.map(np.asarray, params), CFG)
        floor = 1e-3 * max(float(g.abs().max()) for g in want_g.values())
        for name, p in model.named_parameters():
            g = want_g[name]
            assert float((p.grad - g).abs().max()) <= 1e-4 * max(float(g.abs().max()), floor), f"step {i} grad {name}"
            small_g[name] |= g.abs() < 1e-6
            keep = ~small_g[name]
            err = float((p.detach() - want_p[name])[keep].abs().max()) if bool(keep.any()) else 0.0
            assert err <= 1e-6, f"step {i} param {name}: {err}"


def test_layouts_against_export_classifier(tmp_path):
    """export_classifier writes the reference layout (head-wise sLSTM gates,
    no LayerNorm biases, a zero dead output_layer); from_jax_params writes
    the port's: the same keys plus the LayerNorm biases, the same shapes but
    the full (d, d) gates. load_model reads both strict=True as the same
    classifier, and a saved port .pth back again."""
    jm = JaxXLSTMClassifier(JCFG)
    params = random_params(jm, reference_layout=True)
    ref = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in export_classifier(params, JCFG).items()}
    port = from_jax_params(params, CFG)
    assert set(ref) <= set(port)
    assert sorted(set(port) - set(ref)) == sorted(k for k in port if k.endswith("norm.bias"))
    d, heads = CFG.embedding_dim, CFG.num_heads
    for k, v in ref.items():
        if k.endswith(("igate.weight", "fgate.weight", "zgate.weight", "ogate.weight")) and "mlstm" not in k:
            assert tuple(v.shape) == (heads, d // heads, d // heads) and tuple(port[k].shape) == (d, d), k
        else:
            assert v.shape == port[k].shape, k
    assert not port["output_layer.weight"].any() and not ref["output_layer.weight"].any()
    assert config_from_state_dict(ref) == config_from_state_dict(port) == dataclasses.replace(CFG)
    assert family(config_from_state_dict(ref)) == "classifier"
    src, _ = _batch(5)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(src)))
    from_ref, from_port = load_model(ref, "cpu"), load_model(port, "cpu")
    path = tmp_path / "classifier.pth"
    torch.save(from_port.state_dict(), path)
    again = load_model(load_checkpoint(str(path)), "cpu")
    with torch.no_grad():
        for m in (from_ref, from_port, again):
            assert _rel(m(torch.from_numpy(src)).numpy(), want) <= 1e-4


def test_init_weights_and_family():
    """A seeded classifier: the JAX initializers' scales (token embedding
    N(0, 1/d), fc lecun-normal), a zero dead head, finite logits; its
    state dict is told apart from the LM's."""
    model = init_weights_(empty_model(CFG, "cpu"), 0)
    assert isinstance(model, XLSTMClassifier)
    std = float(model.token_embedding.weight.detach().std())
    assert abs(std - CFG.embedding_dim ** -0.5) < 0.02
    assert not model.output_layer.weight.any() and not model.output_layer.bias.any()
    assert "output_layer.weight" not in dict(model.named_parameters())
    src, _ = _batch(2)
    with torch.no_grad():
        assert bool(torch.isfinite(model(torch.from_numpy(src))).all())
    again = init_weights_(empty_model(CFG, "cpu"), 0)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), again.state_dict().values()))
    assert family(config_from_state_dict(model.state_dict())) == "classifier"


def test_family_detection_needs_fc_without_metadata():
    """An LM's state dict (metadata_embedding, no fc) stays an xLSTM; a
    classifier's without its fc is no classifier and does not load."""
    from musicgen_tpu_torch.config import XLSTMConfig

    sd = init_weights_(empty_model(XLSTMConfig(**{**KW, "metadata_vocab_size": 9}), "cpu"), 0).state_dict()
    assert family(config_from_state_dict(sd)) == "xlstm"
    sd = {k: v for k, v in init_weights_(empty_model(CFG, "cpu"), 0).state_dict().items() if not k.startswith("fc.")}
    with pytest.raises(KeyError):
        load_model(sd, "cpu")
