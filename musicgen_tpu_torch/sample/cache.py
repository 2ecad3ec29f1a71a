"""Decode-cache bookkeeping of the Transformer's ring-buffered KV cache.

Port of musicgen_tpu/sample/cache.py. The cache spans seq_len = block_len + 6
slots:

  slot 0..5           : metadata prefix (written once at prefill)
  slot 6 + (i mod L)  : the i-th stream token (prompt tokens fill i=0..P-1,
                        generated tokens continue the stream index)

The rel-position embedding applies on the query side as a function of key
AGE (ops/attention.relpos_attention_step), so a slot's cached K/V stay valid
as the window slides; each step only recomputes ages.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import NUM_META


def token_slot(stream_index, block_len: int):
    """Cache slot of stream token `stream_index` (prompt tokens included)."""
    return NUM_META + stream_index % block_len


def step_geometry(
    total: int, block_len: int, streaming: bool = True, device=None
) -> Tuple[torch.Tensor, int]:
    """(key_ages (seq_len,) int64, rel_base) of a decode step.

    `total`: stream tokens INCLUDING the one being stepped (prompt_len +
    generated so far + 1). Unfilled slots get age -1 (masked).
    streaming=True (production): rel_base is fixed at seq_len - 1, the
    geometry of training, where the query sits on the last row.
    streaming=False: rel_base tracks the window length, the reference's
    growing re-forward geometry (plumbing checks on one-layer models)."""
    window = min(total, block_len)
    rel_base = NUM_META - 1 + (block_len if streaming else window)
    meta_ages = rel_base - torch.arange(NUM_META, device=device)
    r = torch.arange(block_len, device=device)
    tok_ages = torch.remainder(total - 1 - r, block_len)
    tok_ages = torch.where(r < window, tok_ages, -1)
    return torch.cat([meta_ages, tok_ages]), rel_base
