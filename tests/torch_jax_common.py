"""JAX-side pieces of the port's bf16 and data-parallel tests: seeded
random weights for the JAX package's models without compiling their init,
and JAX's make_distributed_train_step on a 2-device 'data' mesh of the
suite's virtual CPU devices, with the comparison the data-parallel tests
make. Not a test module: the test files import it."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from musicgen_tpu.config import MeshConfig
from musicgen_tpu.config import TrainValues as JaxTrainValues
from musicgen_tpu.config import TransformerConfig as JaxTransformerConfig
from musicgen_tpu.models.transformer import TransformerLM as JaxTransformerLM
from musicgen_tpu.parallel.mesh import make_mesh
from musicgen_tpu.train import trainer as jtrainer
from musicgen_tpu.train.distributed import make_distributed_train_step
from musicgen_tpu_torch.config import TransformerConfig
from musicgen_tpu_torch.interop import from_jax_params
from tests import torch_ddp_common as ddp

LM_META = 9
# The data-parallel tests' LM: dropout 0.1, which every deterministic step leaves off.
LM_KW = dict(n_embd=32, n_heads=4, n_layer=2, block_len=ddp.L, dropout=0.1, metadata_vocab_size=LM_META,
             attention_impl="xla")


def random_params(jm, *init_args, seed: int = 0):
    """Seeded numpy weights in the flax tree of `jm`, whose init takes
    `init_args` (shapes from eval_shape, which compiles nothing): matrices of
    std 1/sqrt(fan_in), N(0, 1) embeddings and rel tables, unit scales, other
    vectors of std 0.1 and the mLSTM forget-gate bias 3.0."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *(jnp.asarray(a) for a in init_args))

    def fill(path, leaf):
        name, parent = path[-1].key, path[-2].key if len(path) > 1 else ""
        if name in ("scale", "outnorm_scale", "learnable_skip", "gn_scale"):
            return np.ones(leaf.shape, np.float32)
        if parent == "fgate" and name == "bias":
            return np.full(leaf.shape, 3.0, np.float32)
        std = 1.0 if name in ("embedding", "rel_pos_emb") else 0.1 if leaf.ndim < 2 else leaf.shape[-2] ** -0.5
        return (std * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_distributed_steps(jm, params, kind, loss_chunk, cfg, meta_vocab, model: int = 1):
    """ddp.STEPS of JAX's distributed step on a (2, model) ('data', 'model')
    mesh on the global batches of ddp.batch: run_jax_steps' (losses, grads
    a step, params)."""
    mesh = make_mesh(MeshConfig(model=model), devices=jax.devices()[:2 * model])
    opt = jtrainer.make_optimizer(JaxTrainValues())
    step = make_distributed_train_step(jm, opt, mesh, params, kind=kind, loss_chunk=loss_chunk)
    batches = [ddp.batch(10 + i, kind, cfg.vocab_size, meta_vocab) for i in range(ddp.STEPS)]
    return run_jax_steps(step, params, opt.init(params), batches, cfg)


def run_jax_steps(step, params, opt_state, batches, cfg):
    """step(params, opt_state, src, trg, meta) -> (params, opt_state, loss)
    on each numpy batch: (losses, grads a step, params) as port tensors, the
    grads read off Adam's first moment (mu_t = b1 mu_{t-1} + (1 - b1) g_t)."""
    p, mu_prev, losses, grads = params, jax.tree.map(np.zeros_like, opt_state[0].mu), [], []
    for batch in batches:
        p, opt_state, loss = step(p, opt_state, *(jnp.asarray(x, jnp.int32) for x in batch))
        mu = jax.tree.map(np.asarray, opt_state[0].mu)
        grads.append(from_jax_params(jax.tree.map(lambda m, m0: (m - 0.9 * m0) / 0.1, mu, mu_prev), cfg))
        mu_prev = mu
        losses.append(float(loss))
    return losses, grads, from_jax_params(jax.tree.map(np.asarray, p), cfg)


def assert_grads_close(got, want, grad_rtol, tag=""):
    """Every gradient of got (name -> tensor) within grad_rtol of its
    tensor's largest value in want (at least 1e-3 of the largest gradient)."""
    floor = 1e-3 * max(float(want[name].abs().max()) for name in got)
    for name in got:
        g = want[name]
        err = float((got[name] - g).abs().max())
        assert err <= grad_rtol * max(float(g.abs().max()), floor), f"{tag} grad {name}: {err}"


def assert_steps_close(got, want, loss_rtol, grad_rtol):
    """got, want: (losses, grads a step, final params). The losses to
    loss_rtol relative; every gradient of got's parameters (a classifier's
    dead head is buffers) to grad_rtol of its tensor's largest value (at
    least 1e-3 of the step's largest gradient); the parameters to 1e-6
    absolute, leaving out elements whose gradient is below 1e-6 in either
    run at any step: Adam's g / (|g| + eps) turns f32 order noise in such a
    g into a change of up to lr, whatever the framework."""
    (gl, gg, gp), (wl, wg, wp) = got, want
    for i in range(len(gl)):
        assert abs(gl[i] - wl[i]) <= loss_rtol * abs(wl[i]), f"step {i} loss {gl[i]} vs {wl[i]}"
        assert_grads_close(gg[i], wg[i], grad_rtol, f"step {i}")
    for name in gp:
        keep = torch.ones_like(gp[name], dtype=torch.bool)
        for i in range(len(gl)):
            keep &= (wg[i][name].abs() >= 1e-6) & (gg[i][name].abs() >= 1e-6)
        err = float((gp[name] - wp[name])[keep].abs().max()) if bool(keep.any()) else 0.0
        assert err <= 1e-6, f"param {name}: {err}"


def ddp_runs(cases, tmp):
    """For each case (name, jax model, params, port config, kind, loss_chunk,
    meta_vocab): (two gloo ranks, one rank on the whole batch, JAX's mesh
    step), each (losses, grads, params). The JAX steps compile while the
    ranks run."""
    rank_cases = []
    for name, jm, params, cfg, kind, chunk, meta_vocab in cases:
        torch.save(from_jax_params(params, cfg), tmp / f"{name}.pth")
        rank_cases.append((name, str(tmp / f"{name}.pth"), kind, chunk, meta_vocab))
    ranks = ddp.start_ranks(ddp.ddp_rank, 2, rank_cases, str(tmp / "ddp.pth"))
    jax_runs = {name: jax_distributed_steps(jm, params, kind, chunk, cfg, meta_vocab)
                for name, jm, params, cfg, kind, chunk, meta_vocab in cases}
    one = ddp.one_rank(rank_cases)
    ddp.wait_ranks(ranks, timeout=90)
    two = torch.load(tmp / "ddp.pth", weights_only=True)
    return {name: (two[name], one[name], jax_runs[name]) for name in jax_runs}


def lm_ddp_runs(name, loss_chunk, tmp):
    """ddp_runs of the data-parallel tests' Transformer for kind='lm'."""
    jm, cfg = JaxTransformerLM(JaxTransformerConfig(**LM_KW)), TransformerConfig(**LM_KW)
    src, _, meta = ddp.batch(0, "lm", cfg.vocab_size, LM_META)
    params = random_params(jm, src[:, :8], meta)
    return ddp_runs([(name, jm, params, cfg, "lm", loss_chunk, LM_META)], tmp)[name]
