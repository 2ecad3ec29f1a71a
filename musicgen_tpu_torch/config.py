"""Configuration and vocabulary layout, shared with the JAX package.

`musicgen_tpu.config` imports only the standard library, so the port uses it
as it is (frozen dataclasses; nothing is copied)."""
from musicgen_tpu.config import (  # noqa: F401
    DEFAULT_CONFIG,
    NUM_META,
    VOCAB,
    MambaConfig,
    VocabLayout,
)
