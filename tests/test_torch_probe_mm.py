"""Kernel I's plain version and wrapper (musicgen_tpu_torch.ops.probe_kernel)
and the probe's entry point (musicgen_tpu_torch.experiments.hw_characterize)
against experiments/hw_characterize.py's `pallas_mm` in interpret mode.

The JAX script does all its work at import, so its two functions are taken
out of the file with `ast` and run in a namespace that holds the sizes and a
`pl` whose pallas_call runs in interpret mode; nothing under experiments/ is
imported or edited. Both sides take bf16(x) @ W with f32 sums, in another
order: the tolerance is 1e-5 of max|y|. The JAX script's W is (K, N); the
port's kernel takes it transposed, (N, K)."""
import ast
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from musicgen_tpu_torch.experiments import hw_characterize as hw
from musicgen_tpu_torch.ops import probe_kernel as pk

REPO = Path(__file__).resolve().parents[1]
M, K, N, BN = 8, 128, 512, 256
TOL = 1e-5


def extract(path: Path, names, namespace: dict) -> list:
    """Exec only the top-level functions `names` of `path` in `namespace`."""
    tree = ast.parse(path.read_text())
    body = [node for node in tree.body if isinstance(node, ast.FunctionDef) and node.name in names]
    assert sorted(node.name for node in body) == sorted(names)
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), namespace)
    return [namespace[n] for n in names]


def interpret_pl():
    """jax.experimental.pallas with pallas_call in interpret mode."""
    ns = {k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")}
    ns["pallas_call"] = functools.partial(pl.pallas_call, interpret=True)
    return types.SimpleNamespace(**ns)


@pytest.fixture(scope="module")
def pallas_mm():
    ns = {"jax": jax, "jnp": jnp, "pl": interpret_pl(), "pltpu": pltpu, "M": M, "K": K, "N": N, "BN": BN}
    _, fn = extract(REPO / "experiments" / "hw_characterize.py", ["mm_kernel", "pallas_mm"], ns)
    return fn


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_probe_mm_matches_pallas_mm(pallas_mm):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = hw.make_weights(1, K, N, seed=1)[0]
    want = np.asarray(pallas_mm(jnp.asarray(x), jnp.asarray(w).astype(jnp.bfloat16)))
    wt = torch.from_numpy(w).to(torch.bfloat16).t().contiguous()  # the port's (N, K)
    plain = pk.probe_mm_plain(torch.from_numpy(x), wt)
    wrapped = pk.probe_mm(torch.from_numpy(x), wt)  # a CPU tensor: the plain version
    assert plain.shape == (M, N) and plain.dtype == torch.float32
    assert _rel(plain, want) <= TOL
    assert torch.equal(wrapped, plain)


def test_tanh_chain_matches_pallas_chain(pallas_mm):
    """Three steps of three chained products with x = tanh(y[:, :K])."""
    ws = hw.make_weights(3, K, N, seed=2)
    x = np.ones((M, K), np.float32)
    jw = jnp.asarray(ws).astype(jnp.bfloat16)
    jx = jnp.asarray(x)
    for _ in range(3):
        for i in range(3):
            jx = jnp.tanh(pallas_mm(jx, jw[i])[:, :K])
    tw = torch.from_numpy(ws).to(torch.bfloat16).transpose(1, 2).contiguous()
    tx = torch.from_numpy(x)
    for _ in range(3):
        tx = hw.chain(tx, tw, pk.probe_mm)
    assert _rel(tx, np.asarray(jx)) <= TOL


def test_probe_mm_rows_are_independent():
    """The batch lives in rows 0-1 of the probe's 8: its two rows alone give
    the same sums."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy(hw.make_weights(1, K, N, seed=5)[0]).to(torch.bfloat16).t().contiguous()
    assert _rel(pk.probe_mm(x[:2].contiguous(), w), pk.probe_mm(x, w)[:2]) <= TOL


def test_hw_characterize_run_on_cpu(capsys):
    out = hw.run("cpu", m=M, k=K, n=N, n_mats=3, steps=2)
    printed = capsys.readouterr().out
    assert "probe_mm" in printed and "decode_gemv" in printed and "f32_matmul" in printed
    assert out["device"] == "cpu" and out["bytes_step"] == 3 * K * N * 2
    assert out["chain_max_abs_err"] == 0.0  # the wrapper took the plain version
    for name in ("probe_mm", "decode_gemv", "f32_matmul", "library_bf16"):
        assert out[name]["us_step"] > 0 and out[name]["graph_us_step"] is None and out[name]["gbs"] is None


def test_hw_characterize_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        hw.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        hw.main([])
