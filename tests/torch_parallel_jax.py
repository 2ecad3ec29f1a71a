"""JAX-side pieces of the port's multi-rank strategy tests: the small Mamba
and Transformer of tests/test_torch_parallel_*.py with seeded weights, and
the JAX package's mesh functions (ssd_sequence_parallel, sp_loss,
make_sp_train_step, pp_loss) on the suite's virtual CPU devices, each
returned as port tensors. Not a test module."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh

from musicgen_tpu.config import MambaConfig as JaxMambaConfig
from musicgen_tpu.config import TrainValues as JaxTrainValues
from musicgen_tpu.config import TransformerConfig as JaxTransformerConfig
from musicgen_tpu.models.mamba import MambaLM as JaxMambaLM
from musicgen_tpu.models.transformer import TransformerLM as JaxTransformerLM
from musicgen_tpu.parallel.pipeline import pp_loss
from musicgen_tpu.parallel.sequence import ssd_sequence_parallel
from musicgen_tpu.parallel.sp_train import make_sp_train_step, sp_loss
from musicgen_tpu.train import trainer as jtrainer
from musicgen_tpu_torch.config import MambaConfig, TransformerConfig
from musicgen_tpu_torch.interop import from_jax_params
from tests import torch_ddp_common as ddp
from tests import torch_jax_common as J
from tests import torch_parallel_common as P

META = 9


def mamba_kw(n_layers: int) -> dict:
    return dict(d_model=32, n_layers=n_layers, d_state=8, d_conv=4, expand=2, headdim=8, chunk_size=8,
                metadata_vocab_size=META)


TRANSFORMER_KW = dict(n_embd=32, n_heads=4, n_layer=4, block_len=P.T, dropout=0.0, metadata_vocab_size=META,
                      attention_impl="xla")


def family(name: str, n_layers: int = 4):
    """(JAX model, port config, seeded JAX params) of the tests' small
    Mamba ('mamba') or Transformer ('transformer')."""
    if name == "mamba":
        jm, cfg = JaxMambaLM(JaxMambaConfig(**mamba_kw(n_layers))), MambaConfig(**mamba_kw(n_layers))
    else:
        jm, cfg = JaxTransformerLM(JaxTransformerConfig(**TRANSFORMER_KW)), TransformerConfig(**TRANSFORMER_KW)
    src, _, meta = P.lm_batch(0, 2, META)
    return jm, cfg, J.random_params(jm, src[:, :8], meta)


def save_port(params, cfg, path) -> str:
    torch.save(from_jax_params(params, cfg), path)
    return str(path)


def mesh(n: int, axis: str) -> Mesh:
    return Mesh(np.asarray(jax.devices()[:n]), (axis,))


def scan_inputs(seed: int, t: int) -> dict:
    """Seeded numpy inputs of the SSD scan tests (JAX's
    tests/test_sequence_parallel.py shapes at t steps) with the cotangent
    weights wy, ws."""
    rng = np.random.default_rng(seed)
    b, h, p, g, n = 2, 4, 16, 1, 16
    f = np.float32
    return {"x": rng.standard_normal((b, t, h, p)).astype(f), "dt": rng.uniform(0.001, 0.4, (b, t, h)).astype(f),
            "A": (-rng.uniform(0.5, 3.0, (h,))).astype(f), "B": rng.standard_normal((b, t, g, n)).astype(f),
            "C": rng.standard_normal((b, t, g, n)).astype(f), "wy": rng.standard_normal((b, t, h, p)).astype(f),
            "ws": rng.standard_normal((b, h, p, n)).astype(f)}


def jax_scan(inputs: dict, n: int, chunk: int) -> dict:
    """JAX's ssd_sequence_parallel on an n-device 'data' mesh: y, the final
    state and the gradients of sum(y * wy) + sum(state * ws)."""
    m = mesh(n, "data")
    args = tuple(jnp.asarray(inputs[k]) for k in ("x", "dt", "A", "B", "C"))

    def loss(*a):
        y, s = ssd_sequence_parallel(*a, mesh=m, axis="data", chunk=chunk)
        return jnp.sum(y * inputs["wy"]) + jnp.sum(s * inputs["ws"]), (y, s)

    (_, (y, s)), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*args)
    return {"y": np.asarray(y), "state": np.asarray(s),
            **{k: np.asarray(g) for k, g in zip(("x", "dt", "A", "B", "C"), grads)}}


def jax_sp(jm, params, cfg, n: int, steps: int):
    """JAX's sp_loss and its gradients on lm_batch(0, 2) over an n-device
    'sp' mesh, and `steps` steps of make_sp_train_step on lm_batch(1 + i,
    2): (loss, grads, run_jax_steps' (losses, grads, params))."""
    m = mesh(n, "sp")
    src, trg, meta = (jnp.asarray(a, jnp.int32) for a in P.lm_batch(0, 2, META))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: sp_loss(p, src, trg, meta, jm.cfg, m, chunk=P.SP_CHUNK)))(
        params)
    opt = jtrainer.make_optimizer(JaxTrainValues())
    step = make_sp_train_step(jm, opt, m, chunk=P.SP_CHUNK)
    batches = [P.lm_batch(1 + i, 2, META) for i in range(steps)]
    run = J.run_jax_steps(step, params, opt.init(params), batches, cfg)
    return float(loss), from_jax_params(jax.tree.map(np.asarray, grads), cfg), run


def jax_pp(jm, params, cfg, stages: int, data: int, batch: int, micro) -> dict:
    """JAX's pp_loss and its gradients on lm_batch(0, batch) over a
    (data, stages) ('data', 'pipe') mesh for each microbatch count:
    {M: (loss, grads)}."""
    src, trg, meta = (jnp.asarray(a, jnp.int32) for a in P.lm_batch(0, batch, META))
    if data > 1:
        m = Mesh(np.asarray(jax.devices()[:data * stages]).reshape(data, stages), ("data", "pipe"))
    else:
        m = mesh(stages, "pipe")
    out = {}
    for k in micro:
        fn = jax.jit(jax.value_and_grad(lambda p, k=k: pp_loss(p, src, trg, meta, jm.cfg, m, microbatches=k,
                                                                data_axis="data" if data > 1 else None)))
        loss, grads = fn(params)
        out[k] = (float(loss), from_jax_params(jax.tree.map(np.asarray, grads), cfg))
    return out


def merged_grads(ranks: list, m: int) -> dict:
    """The gradients of pp_rank's ranks for microbatch count m, each stage's
    under the whole model's names (the data replicas' are equal)."""
    out = {}
    for r in ranks:
        out.update(r["results"][m][1])
    return out


def tp_runs(tmp, jm, params, cfg, kind: str, loss_chunk: int, meta_vocab: int):
    """(the 4 gloo ranks' tp_rank results on a (data 2, model 2) grid, JAX's
    make_distributed_train_step on a (2, 2) ('data', 'model') mesh), each
    (losses, grads a step, params) as port tensors."""
    path = save_port(params, cfg, tmp / "m.pth")
    ranks = ddp.start_ranks(P.tp_rank, 4, path, 2, kind, loss_chunk, meta_vocab, str(tmp / "tp"))
    want = J.jax_distributed_steps(jm, params, kind, loss_chunk, cfg, meta_vocab, model=2)
    ddp.wait_ranks(ranks, timeout=60)
    return P.read_ranks(str(tmp / "tp"), 4), want
