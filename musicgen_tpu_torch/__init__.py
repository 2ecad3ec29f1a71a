"""musicgen_tpu_torch: the PyTorch/CUDA port of musicgen_tpu for NVIDIA Hopper.

The port covers composer-conditioned generation and serving of the Mamba-2,
Transformer and xLSTM families (`cli.generate`, `cli.serve`), their training
(`cli.train`), the research path (`cli.preprocess`, `cli.train_classifier`,
`cli.evaluate`) and the diffusion workload (`cli.train_diffusion`,
`cli.inpaint`). Plain tensor code is PyTorch; the TPU kernels on those paths are hand-written
CUDA kernels for sm_90a under `csrc/`, built with nvcc at first use
(ops/build.py). On CPU tensors every kernel wrapper runs its plain PyTorch
version.

The package never imports jax (the machine with the GPU has none) nor
anything of the JAX package: it keeps its own copies of what it needs
(config, midi, the weight bridge in interop).
"""
