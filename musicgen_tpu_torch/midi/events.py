"""Note value objects for the MIDI event codec.

The port's copy of musicgen_tpu/midi/events.py (reference note.py:1-27).
Identity/dedup semantics match: equality and hashing ignore `tempo`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class MidiNote:
    """One note event.

    `channel` is the General-MIDI program number (0-127) for pitched
    instruments; 128+ marks drum-kit notes (reference: processing.py:92-96).
    During tokenization, `time_start`/`time_end` are rewritten in place from
    seconds to integer beat-grid units and back (reference:
    processing.py:111-126, 154-169), so they are deliberately untyped floats/ints.
    """

    pitch: int
    time_start: float
    time_end: float
    dynamic: int
    channel: int
    tempo: float

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, MidiNote):
            return NotImplemented
        return (
            self.pitch == other.pitch
            and self.time_start == other.time_start
            and self.time_end == other.time_end
            and self.dynamic == other.dynamic
            and self.channel == other.channel
        )

    def __hash__(self) -> int:
        return hash(
            (self.pitch, self.time_start, self.time_end, self.dynamic, self.channel)
        )
