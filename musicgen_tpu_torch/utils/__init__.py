"""Checkpoint-sanity gating and profiling helpers (port of musicgen_tpu/utils/)."""
