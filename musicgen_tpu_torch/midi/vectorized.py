"""Vectorized token codec over integer tensors, on any device.

Port of musicgen_tpu/midi/vectorized.py. The reference tokenizer is a
per-note Python loop (processing.py:129-214); these encode and decode a
whole stream with tensor ops, so that token streams can be packed and
unpacked on the card without a host round trip. The JAX version is jitted;
here the same arithmetic runs eagerly on the tensors' device, with the same
fixed-size padding and `valid` mask:

  encode_notes_grid: grid-quantized note fields -> token stream
                     (delta time run-length encoded, padded to 5 N)
  decode_tokens:     token stream -> per-note field tensors (a note closes
                     at each tempo token, per the field grammar)

Seconds <-> grid conversion stays on the host in float64 (midi/codec),
exactly like the reference's stateful tempo math. Tokens and fields are
int64, the port's token dtype.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import VOCAB, VocabLayout

PAD_TOKEN = -1


class GridNotes(NamedTuple):
    """Grid-quantized note fields, padded, with a `valid` mask."""

    pitch: torch.Tensor  # (N,) int 0..127
    channel: torch.Tensor  # (N,) int 0..128
    dynamic: torch.Tensor  # (N,) int
    start: torch.Tensor  # (N,) int, beat-grid units (absolute)
    end: torch.Tensor  # (N,) int
    tempo: torch.Tensor  # (N,) int
    valid: torch.Tensor  # (N,) bool


def encode_notes_grid(notes: GridNotes, layout: VocabLayout = VOCAB) -> Tuple[torch.Tensor, torch.Tensor]:
    """Notes -> (tokens (5 N,) int64, count): the tokens past `count` are
    PAD_TOKEN. The reference's encode (processing.py:129-152): per note
    [pitch + 128 channel, dyn, length, (delta time where it changed),
    tempo]; the first note's delta-time token is always emitted."""
    d = layout.disc
    n = notes.pitch.shape[0]
    i64 = torch.int64
    pitch, channel, start, end = (x.to(i64) for x in (notes.pitch, notes.channel, notes.start, notes.end))
    pitch_tok = layout.pitch_start + torch.clamp(pitch + channel * d.pitch, max=d.pitch * d.channel - 1)
    dyn_tok = layout.dyn_start + torch.clamp(notes.dynamic.to(i64), max=d.dyn - 1)
    length_tok = layout.length_start + torch.clamp(end - start, max=d.length - 1)
    prev_start = torch.cat([start.new_zeros(1), start[:-1]])
    dt_tok = layout.time_start + torch.clamp(start - prev_start, max=d.time - 1)
    tempo_tok = layout.tempo_start + torch.clamp(notes.tempo.to(i64), max=d.tempo - 1)

    prev_dt = torch.cat([dt_tok.new_full((1,), -1), dt_tok[:-1]])
    emit_dt = (dt_tok != prev_dt) & notes.valid

    # Five slots a note; the unused delta-time slots are masked, then the
    # valid slots are compacted to the front in order.
    flat = torch.stack([pitch_tok, dyn_tok, length_tok, dt_tok, tempo_tok], dim=1).reshape(-1)
    flat_valid = torch.stack([notes.valid, notes.valid, notes.valid, emit_dt, notes.valid], dim=1).reshape(-1)
    count = flat_valid.sum()
    # Each valid slot goes to its position; the others to a spare last slot, dropped.
    idx = torch.where(flat_valid, torch.cumsum(flat_valid, 0) - 1, 5 * n)
    out = torch.full((5 * n + 1,), PAD_TOKEN, dtype=i64, device=flat.device)
    out[idx] = flat
    return out[:5 * n], count


def _latest(value: torch.Tensor, present: torch.Tensor, init: int) -> torch.Tensor:
    """The most recent `value` where `present`, at or before each position
    (`init` before the first)."""
    pos = torch.arange(value.shape[0], device=value.device)
    last = torch.cummax(torch.where(present, pos, -1), dim=0).values
    return torch.where(last >= 0, value[last.clamp(min=0)], init)


def decode_tokens(tokens: torch.Tensor, layout: VocabLayout = VOCAB) -> GridNotes:
    """Token stream (padded with PAD_TOKEN or any negative) -> GridNotes,
    the notes first and `valid` marking them. A note is emitted at each
    tempo token; its other fields are the most recent values seen (the delta
    time persists across notes, reference processing.py:171-214)."""
    d = layout.disc
    t = tokens.shape[0]
    valid = tokens >= 0
    tok = torch.where(valid, tokens, 0).to(torch.int64)

    is_pitch = valid & (tok < layout.dyn_start)
    is_dyn = valid & (tok >= layout.dyn_start) & (tok < layout.length_start)
    is_len = valid & (tok >= layout.length_start) & (tok < layout.time_start)
    is_time = valid & (tok >= layout.time_start) & (tok < layout.tempo_start)
    is_tempo = valid & (tok >= layout.tempo_start)

    pitch_val = _latest(torch.remainder(tok, d.pitch), is_pitch, 0)
    chan_val = _latest(tok // d.pitch, is_pitch, 0)
    dyn_val = _latest(tok - layout.dyn_start, is_dyn, 0)
    len_val = _latest(tok - layout.length_start, is_len, 0)
    dt_val = _latest(tok - layout.time_start, is_time, 0)
    tempo_val = torch.where(is_tempo, tok - layout.tempo_start, 0)

    # Note boundaries at tempo tokens; a note starts at the running sum of
    # the delta times in effect at the boundaries.
    start_at = torch.cumsum(torch.where(is_tempo, dt_val, 0), 0)
    n_notes = is_tempo.sum()
    order = torch.sort((~is_tempo).to(torch.int8), stable=True).indices  # the tempo positions first
    return GridNotes(pitch=pitch_val[order], channel=chan_val[order], dynamic=dyn_val[order],
                     start=start_at[order], end=(start_at + len_val)[order], tempo=tempo_val[order],
                     valid=torch.arange(t, device=tokens.device) < n_notes)
