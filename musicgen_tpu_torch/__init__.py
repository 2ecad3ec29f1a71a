"""musicgen_tpu_torch: the PyTorch/CUDA port of musicgen_tpu for NVIDIA Hopper.

The port covers the generation paths: composer-conditioned Mamba-2 and
Transformer generation with the 'combined' sampler
(`python -m musicgen_tpu_torch.cli.generate --model mamba|transformer`).
Plain tensor code is PyTorch; the TPU kernels on those paths are hand-written
CUDA kernels for sm_90a under `csrc/`, built with nvcc at first use
(ops/build.py). On CPU tensors every kernel wrapper runs its plain PyTorch
version.

The package never imports jax (the machine with the GPU has none) nor
anything of the JAX package: it keeps its own copies of what it needs
(config, midi, the weight bridge in interop).
"""
