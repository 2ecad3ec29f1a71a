"""Shared pieces of the port's bf16 training tests (tests/test_torch_train_
bf16*.py): one family's JAX model built with dtype=jnp.bfloat16 and the
port's built with the bf16 compute dtype, on the same weights (moved across
by interop.from_jax_params), through the logits, one train step's loss and
gradients, and the parameters after 2 Adam steps.

The tolerance is set from a measurement on the same inputs: the gap between
JAX's bf16 model and the f32 model (`ref`). The f32 model is the port's,
which tests/test_torch_train_step.py holds to JAX's f32 model to 1e-5 of
the loss and 1e-4 of each gradient, far inside these gaps; that saves the
suite a second JAX compile a family. The port's gap to JAX's bf16 model
(`port`) may be at most K = 2 times `ref` for the logits (largest
absolute difference), the step's per-position losses (mean absolute
difference; it bounds the gap of the loss, their mean, whose two values
may agree by a chance cancellation), all the gradients together and all the
parameters after 2 steps together (Frobenius norms), and at most 3 times it
(or 1% of the tensor's norm, where `ref` is smaller) for each gradient
alone. Measured on this suite's CPU with the weights of seeds 0, 1 and 2
(the tests use seed 0): port / ref 0.43-1.18 for the logits, 0.84-1.48 for
the position losses, 0.01-0.39 for the loss, 0.42-1.95 for the gradients
together, up to 2.56 for one gradient alone, and 0.80-1.04 for the
parameters; at seed 0 at most 1.32 together and 1.54 alone.

The port's gap is not a small fraction of `ref` because XLA's CPU backend
keeps excess precision by default (its pass that simplifies float
conversions drops the bf16 rounding between fused ops, and between a dot
and the ops that read it in f32): the JAX bf16 model on the CPU rounds in
fewer places than flax's dtype contract names, which the port follows op by
op (bf16 products, activations and norms rounded where their dtype says).
Each check also holds the port's bf16 model apart from its f32 model by at
least half of `ref`, so that a bf16 path which computed in f32 would fail."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from musicgen_tpu.train.loss import filtered_cross_entropy as jax_filtered_ce
from musicgen_tpu_torch.config import VOCAB, TrainValues
from musicgen_tpu_torch.interop import from_jax_params
from musicgen_tpu_torch.ops.grammar import filtered_logits
from musicgen_tpu_torch.train import trainer as T
from tests import torch_jax_common as jax_common

torch.set_num_threads(1)  # several xdist workers share the host's cores

B, L, META = 2, 32, 9
K, K_TENSOR, STEPS = 2.0, 3.0, 2


def batch(seed):
    rng = np.random.default_rng(seed)
    v = VOCAB.vocab_size
    return rng.integers(0, v, (B, L)), rng.integers(0, v, (B, L)), rng.integers(0, META, (B, 6))


def random_params(jm, seed: int = 0):
    """Seeded weights for the LM `jm` (tests/torch_jax_common.py)."""
    src, _, meta = batch(0)
    return jax_common.random_params(jm, src[:, :8], meta, seed=seed)


def jax_run(jm, params, cfg):
    """STEPS of value_and_grad + optax.adam (the JAX trainer's optimizer),
    one jitted step: (logits of step 0, losses, gradients of step 0, final
    parameters) as port tensors and numbers."""
    opt = optax.adam(TrainValues().learning_rate, b1=0.9, b2=0.999, eps=1e-8)

    def loss(p, s, t, m):
        logits = jm.apply(p, s, m)
        return jax_filtered_ce(s, logits, t), logits

    @jax.jit
    def step(p, state, s, t, m):
        (value, logits), g = jax.value_and_grad(loss, has_aux=True)(p, s, t, m)
        updates, state = opt.update(g, state, p)
        return optax.apply_updates(p, updates), state, value, logits, g

    p, state, losses = params, opt.init(params), []
    for i in range(STEPS):
        p, state, value, logits, g = step(p, state, *(jnp.asarray(x, jnp.int32) for x in batch(10 + i)))
        losses.append(float(value))
        if i == 0:
            logits0, grads0 = torch.from_numpy(np.array(logits)), from_jax_params(jax.tree.map(np.asarray, g), cfg)
    return logits0, losses, grads0, from_jax_params(jax.tree.map(np.asarray, p), cfg)


def port_run(module, cfg, params, dtype):
    """The same on the port: (logits, losses, gradients of step 0, final
    parameters, the model, its optimizer) through trainer.make_lm_train_step."""
    model = module.empty_model(cfg, "cpu", dtype)
    model.load_state_dict(from_jax_params(params, cfg), strict=True)
    src, _, meta = batch(10)
    with torch.no_grad():
        logits = model(torch.from_numpy(src), torch.from_numpy(meta))
    optimizer = T.make_optimizer(model, TrainValues())
    step = T.make_lm_train_step(model, optimizer)
    losses = []
    for i in range(STEPS):
        losses.append(float(step(*(torch.from_numpy(x) for x in batch(10 + i)))))
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return logits, losses, grads, {n: p.detach().clone() for n, p in model.named_parameters()}, model, optimizer


def position_losses(logits):
    """The grammar-filtered CE of step 0 at each (row, position), whose mean
    is the step's loss."""
    src, trg, _ = (torch.from_numpy(x) for x in batch(10))
    lp = torch.log_softmax(filtered_logits(src, logits.to(torch.float32)), dim=-1)
    return -torch.gather(lp, -1, trg[..., None])[..., 0]


def _norm(tensors):
    return float(torch.sqrt(sum((t.double() ** 2).sum() for t in tensors)))


def check(jax16, port16, port32):
    """The checks of the module docstring; jax16 from jax_run, port16 and
    port32 (the f32 reference) from port_run."""
    l16, v16, g16, p16 = jax16
    pl, pv, pg, pp, model, optimizer = port16
    l32, v32, g32, p32 = port32[:4]
    ratios = {}

    def within(name, port, ref, k=K):
        ratios[name] = port / ref
        assert port <= k * ref, f"{name}: port {port:.4g} > {k} x ref {ref:.4g}"

    within("logits", float((pl - l16).abs().max()), float((l16 - l32).abs().max()))
    assert float((pl - l32).abs().max()) >= 0.5 * float((l16 - l32).abs().max()), "the bf16 logits are the f32 ones"
    n16, n32, pn = (position_losses(x) for x in (l16, l32, pl))
    ref = float((n16 - n32).abs().mean())
    within("position losses", float((pn - n16).abs().mean()), ref)
    within("loss", abs(pv[0] - v16[0]), ref)
    names = [n for n, _ in model.named_parameters()]
    ref = _norm(g16[n] - g32[n] for n in names)
    within("gradients", _norm(pg[n] - g16[n] for n in names), ref)
    assert _norm(g32[n] - pg[n] for n in names) >= 0.5 * ref, "the bf16 gradients are the f32 ones"
    for n in names:
        floor = 1e-2 * float(g16[n].norm())
        within(n, float((pg[n] - g16[n]).norm()), max(float((g16[n] - g32[n]).norm()), floor), K_TENSOR)
    within("parameters", _norm(pp[n] - p16[n] for n in names), _norm(p16[n] - p32[n] for n in names))
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
    assert len(optimizer.state) == len(names)
    for st in optimizer.state.values():  # Adam's moments (and its step count) stay f32
        assert all(v.dtype == torch.float32 for v in st.values())
    return ratios
