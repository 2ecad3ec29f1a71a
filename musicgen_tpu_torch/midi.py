"""MIDI codec, shared with the JAX package.

`musicgen_tpu.midi` is numpy-only (its package init does not import the
jax-based `vectorized` module), so the port uses it as it is."""
from musicgen_tpu.midi import (  # noqa: F401
    MidiNote,
    decode,
    encode,
    extract_midi,
    note_to_midi,
)
