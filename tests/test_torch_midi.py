"""The port's own copies of the JAX package's config and MIDI codec
(musicgen_tpu_torch.config, musicgen_tpu_torch.midi) against the originals:
the same vocabulary layout and defaults, and the same tokens from the same
notes and files."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from musicgen_tpu import config as jcfg
from musicgen_tpu import midi as jmidi
from musicgen_tpu_torch import config as tcfg
from musicgen_tpu_torch import midi as tmidi

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures_reference_midi.json"
_LAYOUT = ("pitch_start", "dyn_start", "length_start", "time_start", "tempo_start", "vocab_size", "start_idx",
           "field_boundaries")


def test_vocab_layout_and_defaults_match():
    for name in _LAYOUT:
        assert getattr(tcfg.VOCAB, name) == getattr(jcfg.VOCAB, name), name
    assert tcfg.VOCAB.padded_vocab_size() == jcfg.VOCAB.padded_vocab_size() == 17920
    assert (tcfg.NUM_META, tcfg.VOCAB_SIZE, tcfg.DEFAULT_METADATA_VOCAB_SIZE) == (
        jcfg.NUM_META, jcfg.VOCAB_SIZE, jcfg.DEFAULT_METADATA_VOCAB_SIZE)
    for cls in ("Discretization", "Resolution", "MambaConfig", "TransformerConfig"):
        assert dataclasses.asdict(getattr(tcfg, cls)()) == dataclasses.asdict(getattr(jcfg, cls)()), cls
    for cls in ("MambaConfig", "TransformerConfig"):
        a, b = getattr(tcfg, cls)(), getattr(jcfg, cls)()
        assert a.padded_vocab == b.padded_vocab
    assert tcfg.TransformerConfig().seq_len == jcfg.TransformerConfig().seq_len == 2054
    assert tcfg.DEFAULT_CONFIG.values.block_len == jcfg.DEFAULT_CONFIG.values.block_len
    assert tcfg.padded_vocab(17914) == jcfg.padded_vocab(17914)


def test_codec_decodes_and_encodes_the_pinned_streams_alike():
    """The head and tail token groups pinned in fixtures_reference_midi.json
    decode to the same notes in both codecs, and those notes encode to the
    same tokens."""
    fixtures = json.loads(FIXTURES.read_text())
    assert len(fixtures) == 27
    for name, pin in fixtures.items():
        for toks in (pin["head"], pin["tail"]):
            notes_t, notes_j = tmidi.decode(list(toks)), jmidi.decode(list(toks))
            assert [dataclasses.astuple(n) for n in notes_t] == [dataclasses.astuple(n) for n in notes_j], name
            assert tmidi.encode(notes_t) == jmidi.encode(notes_j), name


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in (REPO / "samples").rglob("*.mid")))
def test_codec_reads_the_sample_files_alike(path, tmp_path):
    """Each MIDI file under samples/ tokenizes the same in both codecs, and
    the port's decode -> SMF write -> read gives the same notes as JAX's."""
    toks = tmidi.encode_file(str(REPO / path))
    assert len(toks) > 0
    np.testing.assert_array_equal(np.asarray(toks), np.asarray(jmidi.encode_file(str(REPO / path))))
    tmidi.note_to_midi(tmidi.decode(toks), str(tmp_path / "t.mid"))
    jmidi.note_to_midi(jmidi.decode(toks), str(tmp_path / "j.mid"))
    assert (tmp_path / "t.mid").read_bytes() == (tmp_path / "j.mid").read_bytes()
