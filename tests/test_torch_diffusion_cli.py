"""The port's diffusion CLIs on the CPU (--device cpu), with a tiny UNet
patched into their module-level DEFAULTS (the CLIs take no size flag):
cli.train_diffusion builds canvases from a token corpus, trains and writes
<ckpt>/diffusion.pth ({"params", "ema"} state dicts, not the LMs'
model.pth); cli.inpaint reads it back, with and without --ema and --jumps,
and writes a .mid that parses. Both raise without a card on --device cuda
(the default), and nothing falls back to the CPU."""
import numpy as np
import pytest
import torch

from musicgen_tpu_torch.cli import inpaint, train_diffusion
from musicgen_tpu_torch.diffusion import DiffusionDefaults, create_model_and_diffusion
from musicgen_tpu_torch.interop import DIFFUSION_FILE
from musicgen_tpu_torch.midi import MidiNote, encode, extract_midi, note_to_midi
from tests import torch_diffusion_common  # noqa: F401  (torch on one thread)

# Group norms of min(32, C) groups need every width a multiple of 32; 100
# steps respaced to ddim12 keep the --jumps ladder (jump length 10, 10
# samples) at 102 denoising steps.
TINY = DiffusionDefaults(image_size=64, num_channels=32, num_res_blocks=1, num_heads=2, diffusion_steps=100)
WIDTH = "8"
CLI_DEFAULTS = (train_diffusion.DEFAULTS, inpaint.DEFAULTS)  # before the fixture patches them


def _notes(seed: int, n: int = 120):
    rng = np.random.default_rng(seed)
    notes, cursor = [], 0.0
    res = 60.0 / 120 / 64
    for _ in range(n):
        cursor += int(rng.choice([0, 4, 8, 16])) * res
        notes.append(MidiNote(pitch=int(rng.integers(40, 90)), time_start=cursor, time_end=cursor + 16 * res,
                              dynamic=int(rng.integers(30, 110)), channel=int(rng.integers(0, 2)), tempo=120))
    return notes


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("diffusion")
    for band, seed in (("A", 0), ("B", 1)):
        (root / "np" / band).mkdir(parents=True)
        np.save(root / "np" / band / f"{band}.npy", np.asarray(encode(_notes(seed)), np.int64))
    note_to_midi(_notes(2), str(root / "in.mid"))
    patch = pytest.MonkeyPatch()
    patch.setattr(train_diffusion, "DEFAULTS", TINY)
    patch.setattr(inpaint, "DEFAULTS", TINY)
    params, ema = train_diffusion.main(["--data", str(root / "np"), "--steps", "3", "--batch", "2", "--width", WIDTH,
                                        "--ckpt", str(root / "ckpt"), "--ema-rate", "0.5", "--device", "cpu"])
    yield root, params, ema
    patch.undo()


def test_train_diffusion_writes_checkpoint(trained):
    root, params, ema = trained
    saved = torch.load(root / "ckpt" / DIFFUSION_FILE, weights_only=True)
    assert set(saved) == {"params", "ema"}
    model, _ = create_model_and_diffusion(TINY, torch.bfloat16, "cpu")
    assert saved["params"].keys() == model.state_dict().keys() == saved["ema"].keys()
    for name, p in saved["params"].items():
        assert p.dtype == torch.float32 and torch.equal(p, params[name].cpu()), name
        assert torch.isfinite(p).all() and torch.equal(saved["ema"][name], ema[name].cpu()), name
    assert any(not torch.equal(saved["params"][n], saved["ema"][n]) for n in saved["params"])
    model.load_state_dict(saved["ema"], strict=True)
    assert not (root / "ckpt" / "model.pth").exists()


@pytest.mark.parametrize("extra", [(), ("--jumps", "--ema")])
def test_inpaint_reads_checkpoint_and_writes_midi(trained, extra):
    root, _, _ = trained
    out = root / f"out{len(extra)}.mid"
    notes = inpaint.main(["--ckpt", str(root / "ckpt"), "--midi", str(root / "in.mid"), "--out", str(out),
                          "--width", WIDTH, "--respacing", "ddim12", "--device", "cpu", *extra])
    assert notes and out.exists()
    assert len(extract_midi(str(out))) > 0


def test_cli_default_device_raises_without_a_card(trained, monkeypatch):
    root, _, _ = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_diffusion.main(["--data", str(root / "np"), "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inpaint.main(["--ckpt", str(root / "ckpt"), "--midi", str(root / "in.mid"), "--out", str(root / "x.mid"),
                      "--device", "cuda"])


def test_cli_defaults_are_the_jax_clis():
    """The CLIs' UNet is DiffusionDefaults(image_size=128), cli.inpaint's
    chain ddim25, --device cuda the default, and --bf16 always on."""
    assert CLI_DEFAULTS == (DiffusionDefaults(image_size=128),) * 2
    args = train_diffusion.parse_args(["--data", "d"])
    assert args.bf16 and args.device == "cuda" and (args.steps, args.batch, args.width) == (1000, 8, 128)
    args = inpaint.parse_args(["--ckpt", "c", "--midi", "m", "--out", "o"])
    assert args.respacing == "ddim25" and args.device == "cuda" and not args.jumps and not args.ema
