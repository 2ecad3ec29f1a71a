"""The guards that no module of musicgen_tpu_torch imports jax (the GPU
machine has none) or anything of the JAX package, nor do chip_smoke.py and
multirank_smoke.py."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import musicgen_tpu_torch

REPO = Path(__file__).resolve().parents[1]


def test_package_never_imports_jax():
    """Import every module of the port (and run nothing) in a fresh
    interpreter: no jax, flax, optax or orbax may be loaded."""
    modules = [m.name for m in pkgutil.walk_packages(musicgen_tpu_torch.__path__, "musicgen_tpu_torch.")]
    assert "musicgen_tpu_torch.ops.decode_kernel" in modules and "musicgen_tpu_torch.cli.generate" in modules
    assert "musicgen_tpu_torch.train.trainer" in modules and "musicgen_tpu_torch.cli.train" in modules
    assert "musicgen_tpu_torch.ops.xdecode_kernel" in modules and "musicgen_tpu_torch.ops.slstm_kernel" in modules
    assert "musicgen_tpu_torch.experiments.hw_characterize" in modules and "musicgen_tpu_torch.ops.probe_kernel" in modules
    assert "musicgen_tpu_torch.cli.evaluate" in modules and "musicgen_tpu_torch.cli.train_classifier" in modules
    assert "musicgen_tpu_torch.cli.preprocess" in modules and "musicgen_tpu_torch.eval.timing" in modules
    assert "musicgen_tpu_torch.serve.scheduler" in modules and "musicgen_tpu_torch.cli.serve" in modules
    assert "musicgen_tpu_torch.diffusion.unet" in modules and "musicgen_tpu_torch.diffusion.gaussian" in modules
    assert "musicgen_tpu_torch.cli.inpaint" in modules and "musicgen_tpu_torch.cli.train_diffusion" in modules
    assert "musicgen_tpu_torch.parallel.pipeline" in modules and "musicgen_tpu_torch.parallel.sp_train" in modules
    assert "musicgen_tpu_torch.models.seq2seq" in modules and "musicgen_tpu_torch.models.registry" in modules
    assert "musicgen_tpu_torch.utils.ckpt_sanity" in modules and "musicgen_tpu_torch.utils.profiling" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


def test_package_never_imports_the_jax_package():
    """Import every module of the port, chip_smoke.py and multirank_smoke.py
    in a fresh interpreter: no module named musicgen_tpu or musicgen_tpu.* may be
    loaded (the port keeps its own copies of config, midi and interop), nor
    the JAX package's probe scripts under experiments/."""
    modules = [m.name for m in pkgutil.walk_packages(musicgen_tpu_torch.__path__, "musicgen_tpu_torch.")]
    assert "musicgen_tpu_torch.midi.codec" in modules and "musicgen_tpu_torch.ops.tdecode_kernel" in modules
    assert "musicgen_tpu_torch.data.augment" in modules and "musicgen_tpu_torch.train.loss" in modules
    assert "musicgen_tpu_torch.models.xlstm" in modules and "musicgen_tpu_torch.ops.mlstm" in modules
    assert "musicgen_tpu_torch.experiments.kernel_ablate" in modules and "musicgen_tpu_torch.ops.ablate_kernel" in modules
    assert "musicgen_tpu_torch.eval.accuracy" in modules and "musicgen_tpu_torch.eval.classifier_eval" in modules
    assert "musicgen_tpu_torch.data.preprocess" in modules and "musicgen_tpu_torch.serve" in modules
    assert "musicgen_tpu_torch.diffusion.unet" in modules and "musicgen_tpu_torch.diffusion.gaussian" in modules
    assert "musicgen_tpu_torch.cli.inpaint" in modules and "musicgen_tpu_torch.cli.train_diffusion" in modules
    assert "musicgen_tpu_torch.models.seq2seq" in modules and "musicgen_tpu_torch.models.registry" in modules
    assert "musicgen_tpu_torch.utils.ckpt_sanity" in modules and "musicgen_tpu_torch.utils.profiling" in modules
    code = (
        "import importlib, runpy, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "runpy.run_path('multirank_smoke.py', run_name='multirank_smoke')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('musicgen_tpu', 'experiments'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)
