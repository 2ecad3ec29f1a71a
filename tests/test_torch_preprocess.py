"""The port's corpus preprocessing (data/preprocess.py, cli/preprocess.py)
against the JAX package's on MIDI files synthesised from a seed: the same
<model>/<band>/<song>.npy tree with identical token arrays, the same files
skipped (too few notes, a numeric suffix, one that is not MIDI), and
remove_short_npy_files removing the same files."""
import shutil
from pathlib import Path

import numpy as np
import pytest

from musicgen_tpu.data import preprocess as jpre
from musicgen_tpu_torch.cli import preprocess as cli
from musicgen_tpu_torch.data import preprocess as pre
from musicgen_tpu_torch.midi import MidiNote, encode, extract_midi, note_to_midi

MIN_NOTES = 30


def _notes(rng, n):
    notes, cursor, tempo = [], 0.0, 120
    for j in range(n):
        if j % 13 == 12:
            tempo = int(rng.choice([90, 120, 150]))
        res = 60.0 / tempo / 64
        cursor += int(rng.choice([0, 1, 2, 4, 8, 16])) * res
        notes.append(MidiNote(pitch=int(rng.integers(21, 108)), time_start=cursor,
                              time_end=cursor + int(rng.choice([4, 8, 16, 64])) * res,
                              dynamic=int(rng.integers(1, 127)), channel=int(rng.choice([0, 5, 128])), tempo=tempo))
    return notes


@pytest.fixture(scope="module")
def midi_tree(tmp_path_factory):
    """midi/<band>/<song>.mid from seed 0: three pieces a band (one .MIDI),
    one piece too short, one with a numeric suffix and one file of noise."""
    root = tmp_path_factory.mktemp("pre") / "midi"
    rng = np.random.default_rng(0)
    for band in ("Mozart", "Bach"):
        (root / band).mkdir(parents=True)
        for i, ext in enumerate((".mid", ".mid", ".MIDI")):
            note_to_midi(_notes(rng, 80 + 20 * i), str(root / band / f"{band}_{i}{ext}"))
    note_to_midi(_notes(rng, MIN_NOTES // 3), str(root / "Bach" / "short.mid"))
    note_to_midi(_notes(rng, 100), str(root / "Mozart" / "take.1.mid"))
    (root / "Mozart" / "broken.mid").write_bytes(rng.integers(0, 256, 64, dtype=np.uint8).tobytes())
    return root


def _tree(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_preprocess_matches_jax(midi_tree, tmp_path):
    n = pre.preprocess_midi_files(str(midi_tree), str(tmp_path / "port"), MIN_NOTES, verbose=False)
    jn = jpre.preprocess_midi_files(str(midi_tree), str(tmp_path / "jax"), MIN_NOTES, verbose=False, use_native=False)
    assert n == jn == 6
    tree = _tree(tmp_path / "port")
    assert tree == _tree(tmp_path / "jax")
    assert tree == sorted(f"midi/{b}/{b}_{i}.npy" for b in ("Mozart", "Bach") for i in range(3))
    for rel in tree:
        got, want = np.load(tmp_path / "port" / rel), np.load(tmp_path / "jax" / rel)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        src = next((midi_tree / Path(rel).parent.name).glob(Path(rel).stem + ".*"))
        np.testing.assert_array_equal(got, np.asarray(encode(extract_midi(str(src))), np.int64))
    # A second pass finds every output there and writes nothing.
    assert pre.preprocess_midi_files(str(midi_tree), str(tmp_path / "port"), MIN_NOTES, verbose=False) == 0


@pytest.mark.parametrize("dry_run", [False, True])
def test_remove_short_npy_files_matches_jax(midi_tree, tmp_path, dry_run):
    pre.preprocess_midi_files(str(midi_tree), str(tmp_path / "np"), MIN_NOTES, verbose=False)
    shutil.copytree(tmp_path / "np", tmp_path / "jax")
    lengths = sorted(len(np.load(p)) for p in (tmp_path / "np").rglob("*.npy"))
    cut = lengths[2] + 1  # the three shortest go
    removed = pre.remove_short_npy_files(str(tmp_path / "np"), cut, dry_run=dry_run)
    jremoved = jpre.remove_short_npy_files(str(tmp_path / "jax"), cut, dry_run=dry_run)
    assert removed == jremoved == 3
    assert _tree(tmp_path / "np") == _tree(tmp_path / "jax")
    assert len(_tree(tmp_path / "np")) == (6 if dry_run else 3)


def test_find_files_by_extensions_matches_jax(midi_tree):
    for exts in ([".mid", ".midi"], [".npy"], [".MID"]):
        assert pre.find_files_by_extensions(str(midi_tree), exts) == jpre.find_files_by_extensions(str(midi_tree), exts)


def test_cli_preprocess(midi_tree, tmp_path, capsys):
    out = tmp_path / "np"
    assert cli.main(["--midi", str(midi_tree), "--out", str(out), "--min-notes", str(MIN_NOTES)]) == 6
    assert "tokenized 6 files" in capsys.readouterr().out
    assert len(list((out / "midi").rglob("*.npy"))) == 6
