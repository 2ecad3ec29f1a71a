"""Standard MIDI File (SMF) reader/writer, implemented from scratch (the
port's copy of musicgen_tpu/midi/smf.py).

The reference relies on `pretty_midi` for all MIDI file I/O
(reference: processing/processing.py:3,58,86); that package is not part of
this framework's dependency set, so this module provides the small slice of
functionality the codec needs:

  * `load(path)` -> `ParsedMidi` with per-instrument note lists (times in
    seconds), a tempo map, and the end time — mirroring
    `pretty_midi.PrettyMIDI.{instruments,get_tempo_changes,get_end_time}`.
  * `save(path, instruments, tempo_events)` — writes a format-1 SMF with a
    dedicated tempo track, mirroring `PrettyMIDI.write` plus the reference's
    `update_tempo` tick-scale surgery (reference: processing.py:216-225).

All time math is host-side float64; token math happens on device elsewhere.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Iterable, List, Sequence, Tuple

# Ticks per quarter note. 16384 = 256 ticks per 64th-of-a-beat grid unit, so
# tick rounding error is <=1/512 of a grid unit (the reference writes through
# pretty_midi at 220 PPQ = 3.4 ticks/unit, ~75x coarser).
DEFAULT_PPQ = 16384
DEFAULT_US_PER_QN = 500_000  # 120 bpm
DRUM_CHANNEL = 9
# Re-anchor the tempo map at least this often (in seconds of active tempo) so
# the 3-byte us-per-quarter quantization error (~2e-6 relative) cannot
# accumulate across a long piece. See save() below.
_REANCHOR_SECONDS = 10.0


@dataclasses.dataclass
class SmfNote:
    pitch: int
    velocity: int
    start: float  # seconds
    end: float  # seconds


@dataclasses.dataclass
class Instrument:
    program: int
    is_drum: bool
    notes: List[SmfNote] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ParsedMidi:
    instruments: List[Instrument]
    tempo_times: List[float]  # seconds at which each tempo becomes active
    tempo_bpm: List[float]
    end_time: float

    def get_tempo_changes(self) -> Tuple[List[float], List[float]]:
        return self.tempo_times, self.tempo_bpm

    def get_end_time(self) -> float:
        return self.end_time


# ---------------------------------------------------------------------------
# Variable-length quantities
# ---------------------------------------------------------------------------

def _read_vlq(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos


def _write_vlq(value: int) -> bytes:
    if value < 0:
        raise ValueError("negative delta time")
    chunks = [value & 0x7F]
    value >>= 7
    while value:
        chunks.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(chunks))


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def _parse_track_events(data: bytes):
    """Yield (tick, status, payload_bytes) for one track chunk body."""
    pos = 0
    tick = 0
    running = None
    n = len(data)
    while pos < n:
        delta, pos = _read_vlq(data, pos)
        tick += delta
        status = data[pos]
        if status & 0x80:
            pos += 1
            if status < 0xF0:
                running = status
        else:
            if running is None:
                raise ValueError("running status without prior status byte")
            status = running
        if status == 0xFF:  # meta event
            meta_type = data[pos]
            pos += 1
            length, pos = _read_vlq(data, pos)
            payload = data[pos : pos + length]
            pos += length
            yield tick, status, bytes([meta_type]) + payload
            if meta_type == 0x2F:  # end of track
                return
        elif status in (0xF0, 0xF7):  # sysex
            length, pos = _read_vlq(data, pos)
            pos += length
        else:
            kind = status & 0xF0
            if kind in (0xC0, 0xD0):  # program change / channel pressure
                payload = data[pos : pos + 1]
                pos += 1
            else:
                payload = data[pos : pos + 2]
                pos += 2
            yield tick, status, payload


def _build_tick_to_seconds(tempo_events: Sequence[Tuple[int, int]], ppq: int):
    """tempo_events: sorted (tick, us_per_qn). Returns tick->seconds fn and
    the seconds at which each tempo becomes active."""
    ticks = [t for t, _ in tempo_events]
    us = [u for _, u in tempo_events]
    secs = [0.0] * len(ticks)
    for i in range(1, len(ticks)):
        secs[i] = secs[i - 1] + (ticks[i] - ticks[i - 1]) * us[i - 1] / (1e6 * ppq)

    def tick_to_sec(tick: int) -> float:
        # Linear scan is fine: tempo maps are tiny relative to note counts,
        # and callers convert in sorted order via an index hint.
        i = 0
        while i + 1 < len(ticks) and ticks[i + 1] <= tick:
            i += 1
        return secs[i] + (tick - ticks[i]) * us[i] / (1e6 * ppq)

    return tick_to_sec, secs, us


def load(path: str) -> ParsedMidi:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"MThd":
        raise ValueError(f"{path}: not a MIDI file")
    header_len = struct.unpack(">I", data[4:8])[0]
    fmt, ntracks, division = struct.unpack(">HHH", data[8:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division is not supported")
    ppq = division
    pos = 8 + header_len

    tracks = []
    for _ in range(ntracks):
        if data[pos : pos + 4] != b"MTrk":
            # Skip unknown chunk
            chunk_len = struct.unpack(">I", data[pos + 4 : pos + 8])[0]
            pos += 8 + chunk_len
            continue
        chunk_len = struct.unpack(">I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + chunk_len]
        pos += 8 + chunk_len
        tracks.append(list(_parse_track_events(body)))

    # Tempo map (merged across tracks).
    tempo_events: List[Tuple[int, int]] = []
    for track in tracks:
        for tick, status, payload in track:
            if status == 0xFF and payload[:1] == b"\x51":
                us_per_qn = int.from_bytes(payload[1:4], "big")
                tempo_events.append((tick, us_per_qn))
    tempo_events.sort(key=lambda e: e[0])
    if not tempo_events or tempo_events[0][0] != 0:
        tempo_events.insert(0, (0, DEFAULT_US_PER_QN))
    # Collapse duplicate ticks (last event at a tick wins, as players do).
    collapsed: List[Tuple[int, int]] = []
    for tick, us in tempo_events:
        if collapsed and collapsed[-1][0] == tick:
            collapsed[-1] = (tick, us)
        else:
            collapsed.append((tick, us))
    tempo_events = collapsed

    tick_to_sec, tempo_secs, tempo_us = _build_tick_to_seconds(tempo_events, ppq)

    # Note extraction. Instruments are grouped per (track, channel, program)
    # the way pretty_midi builds them, then notes carry seconds.
    instruments: dict = {}
    end_time = 0.0
    for tindex, track in enumerate(tracks):
        program = [0] * 16
        open_notes: dict = {}  # (channel, pitch) -> list[(start_tick, velocity, program)]
        for tick, status, payload in track:
            kind = status & 0xF0
            channel = status & 0x0F
            if kind == 0xC0:
                program[channel] = payload[0]
            elif kind == 0x90 and payload[1] > 0:
                open_notes.setdefault((channel, payload[0]), []).append(
                    (tick, payload[1], program[channel])
                )
            elif kind == 0x80 or (kind == 0x90 and payload[1] == 0):
                key = (channel, payload[0])
                stack = open_notes.get(key)
                if not stack:
                    continue
                # FIFO matching: one note-off closes the OLDEST open note at
                # this pitch. (pretty_midi closes all open notes at once;
                # FIFO deviates only for overlapping same-pitch notes, where
                # it preserves note identities and makes file round-trips
                # exact fixpoints even when tempo changes reorder off-ticks.)
                idx = 0
                while idx < len(stack) and stack[idx][0] == tick:
                    idx += 1  # same-tick starts stay open
                if idx == len(stack):
                    continue
                start_tick, velocity, prog = stack.pop(idx)
                ikey = (tindex, channel, prog)
                inst = instruments.get(ikey)
                if inst is None:
                    inst = Instrument(program=prog, is_drum=(channel == DRUM_CHANNEL))
                    instruments[ikey] = inst
                start_s = tick_to_sec(start_tick)
                end_s = tick_to_sec(tick)
                inst.notes.append(
                    SmfNote(pitch=payload[0], velocity=velocity, start=start_s, end=end_s)
                )
                end_time = max(end_time, end_s)

    insts = [inst for _, inst in sorted(instruments.items()) if inst.notes]
    for inst in insts:
        inst.notes.sort(key=lambda n: (n.start, n.pitch))
    tempo_bpm = [60e6 / u for u in tempo_us]
    return ParsedMidi(
        instruments=insts,
        tempo_times=list(tempo_secs),
        tempo_bpm=tempo_bpm,
        end_time=end_time,
    )


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _build_write_tempo_map(
    tempo_events: Sequence[Tuple[float, float]], end_time: float, ppq: int
):
    """Build the tempo track the file will contain, simulating the reader.

    A MIDI tempo event stores integer microseconds-per-quarter-note, so an
    integer bpm is generally NOT exactly representable; a reader reconstructs
    seconds from the quantized value, which drifts ~2e-6 relative vs the
    intended bpm. To keep decoded beat positions exact over arbitrarily long
    pieces, we (a) compute every tick with the READER's own slope (us-based),
    so writer and reader agree exactly, and (b) re-emit the current tempo
    every _REANCHOR_SECONDS with a dithered us value whose anchor tick is
    re-derived from the INTENDED (bpm-exact) seconds, so drift resets instead
    of accumulating.

    Returns (segments, tempo_track_events) where segments is a list of
    (reader_sec, tick, us) and tempo_track_events is [(tick, us)].
    """
    segs: List[Tuple[float, int, int]] = []  # (reader_sec at anchor, tick, us)
    track: List[Tuple[int, int]] = []

    # Expand input (intended_sec, bpm) into anchored segments.
    expanded: List[Tuple[float, float]] = []
    for i, (sec, bpm) in enumerate(tempo_events):
        seg_end = tempo_events[i + 1][0] if i + 1 < len(tempo_events) else max(end_time, sec)
        expanded.append((sec, bpm))
        t = sec + _REANCHOR_SECONDS
        while t < seg_end:
            expanded.append((t, bpm))
            t += _REANCHOR_SECONDS

    reader_sec = 0.0
    tick = 0
    prev_intended = 0.0
    prev_slope = None  # seconds per tick
    for intended_sec, bpm in expanded:
        # Clamp into the 3-byte MIDI tempo field (and guard bpm <= 0, which
        # a raw sampled tempo token can produce).
        us = min(max(int(round(60e6 / max(bpm, 3.6))), 1), 0xFFFFFF)
        if prev_slope is None:
            tick, reader_sec = 0, 0.0
        else:
            # Anchor tick derived from the INTENDED seconds so error resets.
            # Clamped non-negative: when consecutive tempo events sit closer
            # than one tick (generated content emits per-note tempi at
            # near-identical times), the previous anchor's rounding can
            # overshoot and round this dtick to -1 — a negative SMF delta.
            dtick = max(0, int(round((intended_sec - reader_sec) / prev_slope)))
            tick += dtick
            reader_sec += dtick * prev_slope
        prev_slope = us / (1e6 * ppq)
        segs.append((reader_sec, tick, us))
        track.append((tick, us))
    return segs, track


def _sec_to_tick_fn(segs: Sequence[Tuple[float, int, int]], ppq: int):
    """segs: (reader_sec, tick, us) anchors. Returns intended-sec -> tick."""

    def sec_to_tick(t: float) -> int:
        i = 0
        while i + 1 < len(segs) and segs[i + 1][0] <= t:
            i += 1
        sec0, tick0, us = segs[i]
        return tick0 + int(round((t - sec0) * (1e6 * ppq) / us))

    return sec_to_tick


def _track_chunk(events: Iterable[Tuple[int, bytes]]) -> bytes:
    """events: sorted (tick, raw_event_bytes). Returns an MTrk chunk."""
    body = bytearray()
    prev_tick = 0
    for tick, raw in events:
        body += _write_vlq(tick - prev_tick)
        body += raw
        prev_tick = tick
    body += _write_vlq(0) + b"\xff\x2f\x00"  # end of track
    return b"MTrk" + struct.pack(">I", len(body)) + bytes(body)


def save(
    path: str,
    instruments: Sequence[Instrument],
    tempo_events: Sequence[Tuple[float, float]],
    ppq: int = DEFAULT_PPQ,
) -> None:
    """Write a format-1 SMF.

    tempo_events: (seconds, bpm) pairs sorted by time; if empty or not
    starting at 0, a 120 bpm default is prepended (pretty_midi default).
    """
    # Generated content can carry out-of-range tempi; a bpm <= 0 would make
    # the tick slope negative and the tempo track non-monotonic. Clamp and
    # sort defensively (pretty_midi silently tolerates the same inputs).
    tempos = sorted(
        [(max(t, 0.0), bpm if bpm >= 1.0 else 120.0) for t, bpm in tempo_events]
    )
    if not tempos or tempos[0][0] > 0.0:
        tempos.insert(0, (0.0, 120.0))
    end_time = max(
        [n.end for inst in instruments for n in inst.notes] + [tempos[-1][0]],
        default=0.0,
    )
    segs, tempo_track_raw = _build_write_tempo_map(tempos, end_time, ppq)
    sec_to_tick = _sec_to_tick_fn(segs, ppq)

    tempo_track = [
        (tick, b"\xff\x51\x03" + us.to_bytes(3, "big"))
        for tick, us in tempo_track_raw
    ]

    # Channel assignment: drums on channel 9, melodic instruments cycle
    # through the remaining channels (pretty_midi.write does the same).
    melodic_channels = [c for c in range(16) if c != DRUM_CHANNEL]
    chunks = [_track_chunk(tempo_track)]
    next_mel = 0
    for inst in instruments:
        if inst.is_drum:
            channel = DRUM_CHANNEL
        else:
            channel = melodic_channels[next_mel % len(melodic_channels)]
            next_mel += 1
        events: List[Tuple[int, int, bytes]] = []  # (tick, order, raw)
        events.append((0, 0, bytes([0xC0 | channel, inst.program & 0x7F])))
        for note in inst.notes:
            on_tick = sec_to_tick(note.start)
            off_tick = sec_to_tick(note.end)
            if off_tick <= on_tick:
                off_tick = on_tick + 1
            events.append(
                (on_tick, 2, bytes([0x90 | channel, note.pitch & 0x7F, note.velocity & 0x7F]))
            )
            events.append((off_tick, 1, bytes([0x80 | channel, note.pitch & 0x7F, 0x40])))
        events.sort(key=lambda e: (e[0], e[1]))
        chunks.append(_track_chunk((t, raw) for t, _, raw in events))

    header = b"MThd" + struct.pack(">IHHH", 6, 1, len(chunks), ppq)
    with open(path, "wb") as f:
        f.write(header)
        for chunk in chunks:
            f.write(chunk)
