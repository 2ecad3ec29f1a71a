"""musicgen_tpu_torch: the PyTorch/CUDA port of musicgen_tpu for NVIDIA Hopper.

The port's first slice is the main generation path: composer-conditioned
Mamba-2 generation with the 'combined' sampler
(`python -m musicgen_tpu_torch.cli.generate --model mamba`). Plain tensor code
is PyTorch; the TPU kernels on that path are hand-written CUDA kernels for
sm_90a under `csrc/`, built with nvcc at first use (ops/build.py). On CPU
tensors every kernel wrapper runs its plain PyTorch version.

The package never imports jax: the machine with the GPU has none. It reuses
the numpy-only modules of the JAX package (config, midi, interop).
"""
