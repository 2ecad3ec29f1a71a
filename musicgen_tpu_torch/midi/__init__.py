"""MIDI codec of the port: copies of musicgen_tpu/midi/{events,smf,codec}.py
(numpy and the standard library only). The port imports nothing of the JAX
package."""
from . import smf
from .codec import (
    adjust_note_time,
    decode,
    encode,
    encode_file,
    extract_midi,
    note_to_midi,
    revert_note_time,
)
from .events import MidiNote

__all__ = [
    "MidiNote",
    "adjust_note_time",
    "decode",
    "encode",
    "encode_file",
    "extract_midi",
    "note_to_midi",
    "revert_note_time",
    "smf",
]
