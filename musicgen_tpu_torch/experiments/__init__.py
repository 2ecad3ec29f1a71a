"""The port's counterparts of the JAX package's hardware probes in
`experiments/`: `hw_characterize` (kernel I, the bf16 weight-streaming
product) and `kernel_ablate` (kernel J, the ablated Mamba decode step). Each
runs as `python -m musicgen_tpu_torch.experiments.<name>` on the card, or
through its `run(...)` at any size and on any device."""
