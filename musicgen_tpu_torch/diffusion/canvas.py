"""Piano-roll "canvas" codec of the diffusion workload.

A numpy copy of musicgen_tpu/diffusion/canvas.py (the reference notebook
diffusion/diffusion_model_testing.ipynb cell 0: `create_canvas`,
`midi2canvas`, `encode_midi_diffusion`, `RandomSnippet`) on the port's own
MIDI codec, kept in step with it; tests/test_torch_diffusion_numpy.py holds
the two equal. Notes are rendered onto a float array of shape (4, 128, T)
with planes

  0: channel + 1 (instrument program, 0 = empty)
  1: velocity
  2: onset flag (1.0 at note starts)
  3: tempo

over the quantized beat grid, plus the inverse (canvas -> notes) so that
inpainted canvases can be written back to MIDI.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..midi import MidiNote, adjust_note_time, revert_note_time

NUM_PLANES = 4
PITCHES = 128


def create_canvas(notes: Sequence[MidiNote], length: int | None = None) -> np.ndarray:
    """Beat-grid-quantized notes -> (4, 128, T) float32 canvas."""
    notes = [MidiNote(**vars(n)) for n in notes]
    adjust_note_time(notes)
    if length is None:
        length = int(max((n.time_end for n in notes), default=0)) + 1
    canvas = np.zeros((NUM_PLANES, PITCHES, length), dtype=np.float32)
    for n in notes:
        p = int(n.pitch)
        if not 0 <= p < PITCHES:
            continue
        s, e = int(n.time_start), min(int(n.time_end), length)
        if s >= length:
            continue
        canvas[0, p, s:e] = float(n.channel) + 1.0
        canvas[1, p, s:e] = float(n.dynamic)
        canvas[2, p, s] = 1.0
        canvas[3, p, s:e] = float(n.tempo)
    return canvas


def canvas_to_notes(canvas: np.ndarray, default_tempo: float = 120.0) -> List[MidiNote]:
    """Inverse codec: segment contiguous runs per pitch into notes, split at
    onset flags; returns notes with SECONDS times (via revert_note_time)."""
    _, pitches, length = canvas.shape
    notes: List[MidiNote] = []
    for p in range(pitches):
        chan_row = canvas[0, p]
        onset_row = canvas[2, p]
        t = 0
        while t < length:
            if chan_row[t] <= 0.5:
                t += 1
                continue
            start = t
            t += 1
            while t < length and chan_row[t] > 0.5 and onset_row[t] < 0.5:
                t += 1
            end = t
            # Diffusion output is unbounded (denormalize maps [-1,1] to the
            # plane range but samples can overshoot): clamp to valid MIDI —
            # velocity byte [1,127], bpm >= 1 (non-positive tempo would run
            # the tempo map backwards -> negative SMF delta times).
            velocity = float(np.max(canvas[1, p, start:end]))
            velocity = min(max(int(round(velocity)), 1), 127)
            tempo = float(np.max(canvas[3, p, start:end]))
            tempo = round(tempo) if tempo >= 1.0 else default_tempo
            channel = int(round(float(np.max(chan_row[start:end])))) - 1
            notes.append(
                MidiNote(
                    pitch=p,
                    time_start=start,
                    time_end=end,
                    dynamic=velocity,
                    channel=min(max(channel, 0), 255),
                    tempo=tempo,
                )
            )
    notes.sort(key=lambda n: (n.time_start, n.pitch))
    revert_note_time(notes)
    return notes


def normalize_canvas(canvas: np.ndarray) -> np.ndarray:
    """Scale planes into [-1, 1] for diffusion training."""
    out = canvas.astype(np.float32).copy()
    out[0] = out[0] / 64.5 - 1.0  # channel+1 in [0, 129]
    out[1] = out[1] / 63.5 - 1.0  # velocity in [0, 127]
    out[2] = out[2] * 2.0 - 1.0  # onset flag
    out[3] = out[3] / 124.5 - 1.0  # tempo in [0, 249]
    return out


def denormalize_canvas(canvas: np.ndarray) -> np.ndarray:
    out = np.asarray(canvas, dtype=np.float32).copy()
    out[0] = np.clip((out[0] + 1.0) * 64.5, 0, 129)
    out[1] = np.clip((out[1] + 1.0) * 63.5, 0, 127)
    out[2] = (out[2] + 1.0) / 2.0
    out[3] = np.clip((out[3] + 1.0) * 124.5, 0, 249)
    # Snap near-empty cells to empty.
    out[0][out[0] < 0.5] = 0.0
    return out


class RandomSnippet:
    """Random fixed-width crops of canvases (reference RandomSnippet)."""

    def __init__(self, canvases: Sequence[np.ndarray], width: int, seed: int = 0):
        self.canvases = list(canvases)
        self.width = width
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.canvases)

    def sample(self, batch: int) -> np.ndarray:
        out = np.zeros((batch, NUM_PLANES, PITCHES, self.width), np.float32)
        for i in range(batch):
            c = self.canvases[self.rng.integers(len(self.canvases))]
            t = c.shape[-1]
            if t <= self.width:
                out[i, :, :, :t] = c
            else:
                s = int(self.rng.integers(0, t - self.width))
                out[i] = c[:, :, s : s + self.width]
        return out
