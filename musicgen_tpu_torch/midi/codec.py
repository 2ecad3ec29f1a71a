"""MIDI <-> event-token codec (host tier).

Semantics mirror the reference tokenizer exactly (reference:
processing/processing.py:57-225): notes are quantized onto a 64-ticks-per-beat
grid using each note's local tempo, then emitted as
[pitch+128*channel, dynamic, length, (delta-time if changed), tempo] token
groups over the 17,914-entry vocabulary. Decoding is the stateful inverse.

This module is pure host-side Python over int/float64 scalars: the port's
own copy of musicgen_tpu/midi/codec.py (numpy only).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from ..config import Discretization, Resolution, VOCAB, VocabLayout
from . import smf
from .events import MidiNote

# Beat positions within this fraction of a grid unit below an integer are
# snapped up. MIDI tempo events quantize to integer microseconds-per-quarter,
# so exactly-on-grid notes come back from a file up to ~1.5 ticks (~0.006
# units at 256 ticks/unit) early; bare int() as in the reference
# (processing.py:122-126) would misquantize them. Real-world (off-grid) MIDI
# only differs from reference behavior inside this 1% band.
_EPS = 1e-2


def _floor_snap(x: float) -> int:
    """int(x) with protection against float/tick noise just below an integer."""
    f = math.floor(x)
    if x - f > 1.0 - _EPS:
        return f + 1
    return f


def extract_midi(path: str, disc: Discretization = Discretization()) -> List[MidiNote]:
    """Parse a MIDI file into deduplicated, onset-sorted MidiNotes.

    Mirrors reference processing.py:57-83: drums are dropped, each note's
    tempo is the bpm active at its onset (rounded), duplicates (ignoring
    tempo) are removed, and notes are sorted by onset.
    """
    mid = smf.load(path)
    tempo_times, tempo_bpm = mid.get_tempo_changes()
    end_time = mid.get_end_time()
    bounds = list(tempo_times) + [max(end_time, tempo_times[-1]) + 1.0]

    notes: List[MidiNote] = []
    for inst in mid.instruments:
        if inst.is_drum:
            continue
        channel = int(inst.program)
        for n in inst.notes:
            idx = 0
            for i in range(len(tempo_bpm)):
                if bounds[i] <= n.start < bounds[i + 1]:
                    idx = i
                    break
            notes.append(
                MidiNote(
                    pitch=abs(n.pitch),
                    time_start=abs(n.start),
                    time_end=abs(n.end),
                    dynamic=abs(n.velocity),
                    channel=abs(channel),
                    tempo=round(tempo_bpm[idx]),
                )
            )

    # Dedup on (pitch, start, end, dynamic, channel), deterministic order.
    seen = set()
    unique: List[MidiNote] = []
    for note in notes:
        key = (note.pitch, note.time_start, note.time_end, note.dynamic, note.channel)
        if key in seen:
            continue
        seen.add(key)
        unique.append(note)
    # The reference sorts by onset only (processing.py:81), leaving equal-onset
    # order to Python set() iteration — effectively arbitrary. We canonicalize
    # the tie-break so encode(extract(file)) is deterministic and MIDI
    # round-trips are bit-exact fixpoints.
    unique.sort(
        key=lambda n: (n.time_start, n.channel, n.pitch, n.dynamic, n.time_end)
    )
    return unique


def adjust_note_time(
    notes: Sequence[MidiNote], resolution: Resolution = Resolution()
) -> None:
    """Quantize note times (seconds) onto the integer beat grid, in place.

    Mirrors reference processing.py:111-126: beats accumulate using the
    PREVIOUS note's tempo; zero-length quantized notes get length 1.
    """
    if not notes:
        return
    res_per_beat = resolution.bar_res
    current_beats = 0.0
    prev_time = 0.0
    prev_tempo = notes[0].tempo
    for n in notes:
        res = 60.0 / max(prev_tempo, 1.0) / res_per_beat  # 0-bpm guard
        current_beats += (n.time_start - prev_time) / res
        future_beats = current_beats + (n.time_end - n.time_start) / res
        prev_time = n.time_start
        prev_tempo = n.tempo
        start_i = _floor_snap(current_beats)
        end_i = _floor_snap(future_beats)
        n.time_start = start_i
        n.time_end = start_i + 1 if end_i == start_i else end_i


def encode(
    notes: Sequence[MidiNote],
    layout: VocabLayout = VOCAB,
    resolution: Resolution = Resolution(),
) -> List[int]:
    """Notes -> token stream (reference processing.py:129-152).

    Per note: pitch+channel token, dynamic, length, delta-time (only emitted
    when it differs from the previously *emitted* delta), tempo.
    """
    notes = list(notes)
    adjust_note_time(notes, resolution)
    d = layout.disc
    tokens: List[int] = []
    time_prev = 0
    time_delta_prev = 0
    for m in notes:
        pitch = layout.pitch_start + min(
            m.pitch + m.channel * d.pitch, d.pitch * d.channel - 1
        )
        dynamic = layout.dyn_start + min(m.dynamic, d.dyn - 1)
        length = layout.length_start + min(m.time_end - m.time_start, d.length - 1)
        time_delta = layout.time_start + min(m.time_start - time_prev, d.time - 1)
        tempo = layout.tempo_start + min(int(m.tempo), d.tempo - 1)

        tokens.append(int(pitch))
        tokens.append(int(dynamic))
        tokens.append(int(length))
        if time_delta_prev != time_delta:
            tokens.append(int(time_delta))
        tokens.append(int(tempo))
        time_prev = m.time_start
        time_delta_prev = time_delta
    return tokens


def decode(
    token_seq: Sequence[int],
    layout: VocabLayout = VOCAB,
    resolution: Resolution = Resolution(),
) -> List[MidiNote]:
    """Token stream -> notes with real (seconds) times.

    Mirrors reference processing.py:171-214: ranged dispatch on the field
    buckets; a note is emitted once all fields have been seen since the last
    emission (delta-time persists across notes); then beat-grid times are
    converted back to seconds via `revert_note_time`.
    """
    d = layout.disc
    notes: List[MidiNote] = []
    prev_time = 0

    dynamic = None
    pitch = None
    length = None
    time_delta = 0
    channel = None
    tempo = None

    for token in token_seq:
        token = int(token)
        if token < layout.dyn_start:
            channel, pitch = divmod(token, d.pitch)
        elif token < layout.length_start:
            dynamic = token - layout.dyn_start
        elif token < layout.time_start:
            length = token - layout.length_start
        elif token < layout.tempo_start:
            time_delta = token - layout.time_start
        else:
            tempo = token - layout.tempo_start

        if all(x is not None for x in (dynamic, pitch, length, time_delta, channel, tempo)):
            notes.append(
                MidiNote(
                    pitch=int(pitch),
                    time_start=float(prev_time + time_delta),
                    time_end=float(prev_time + time_delta + length),
                    dynamic=int(dynamic),
                    channel=int(channel),
                    tempo=float(tempo),
                )
            )
            dynamic = pitch = length = channel = tempo = None
            prev_time = prev_time + time_delta

    revert_note_time(notes, resolution)
    return notes


def revert_note_time(
    notes: Sequence[MidiNote], resolution: Resolution = Resolution()
) -> None:
    """Beat-grid integer times -> seconds, in place (reference
    processing.py:154-169). Uses the PREVIOUS note's tempo for each gap."""
    if not notes:
        return
    res_per_beat = resolution.bar_res
    prev_time = 0.0
    prev_beat = 0.0
    prev_tempo = notes[0].tempo
    for n in notes:
        # Robustness beyond the reference: a sampled tempo token of 0 bpm
        # (vocabulary id tempo_start) would divide by zero here and produce
        # infinite times downstream; clamp the RESOLUTION only.
        res = 60.0 / max(prev_tempo, 1.0) / res_per_beat
        time_start = prev_time + (n.time_start - prev_beat) * res
        time_end = time_start + (n.time_end - n.time_start) * res
        prev_time = time_start
        prev_beat = n.time_start
        prev_tempo = n.tempo
        n.time_start = time_start
        n.time_end = time_end


def note_to_midi(notes: Sequence[MidiNote], output_path: str) -> None:
    """Write decoded notes (seconds times) to a MIDI file.

    Mirrors reference processing.py:85-109 + update_tempo (:216-225):
    one instrument per channel value (>=128 maps to a drum kit), and a tempo
    event wherever a note's tempo differs from the previous note's.
    """
    by_channel: dict = {}
    for note in notes:
        by_channel.setdefault(note.channel, []).append(note)

    instruments = []
    for channel, chan_notes in by_channel.items():
        if channel >= 128:
            inst = smf.Instrument(program=channel - 128, is_drum=True)
        else:
            inst = smf.Instrument(program=channel, is_drum=False)
        for note in chan_notes:
            inst.notes.append(
                smf.SmfNote(
                    pitch=int(note.pitch),
                    velocity=int(note.dynamic),
                    start=float(note.time_start),
                    end=float(note.time_end),
                )
            )
        instruments.append(inst)

    tempo_events: List[Tuple[float, float]] = []
    prev_tempo = 0.0
    for note in notes:  # iteration order = decode order, as in the reference
        if note.tempo != prev_tempo:
            tempo_events.append((float(note.time_start), float(note.tempo)))
            prev_tempo = note.tempo
    tempo_events.sort(key=lambda e: e[0])

    smf.save(output_path, instruments, tempo_events)


def encode_file(path: str) -> np.ndarray:
    """Convenience: MIDI file -> int64 token array (reference
    preprocess_midi_files body, processing.py:48-53)."""
    notes = extract_midi(path)
    return np.asarray(encode(notes), dtype=np.int64)
