"""The port's numpy copies of the diffusion workload (diffusion/schedule.py,
canvas.py and respace.py's spacing) held bit for bit to the JAX package's."""
import numpy as np
import pytest

from musicgen_tpu import diffusion as jd
from musicgen_tpu_torch import diffusion as pd
from musicgen_tpu_torch.midi import MidiNote, decode, encode
from tests import torch_diffusion_common  # noqa: F401  (torch on one thread)


@pytest.mark.parametrize("name,steps", [("linear", 1000), ("linear", 100), ("linear", 4), ("cosine", 1000),
                                        ("cosine", 50)])
def test_named_betas_equal(name, steps):
    assert np.array_equal(pd.named_betas(name, steps), jd.named_betas(name, steps))


# The CLI's ladder (t_T 25 of ddim25, jump 10 x 10) and the JAX tests'.
@pytest.mark.parametrize("params", [
    dict(t_T=25, n_sample=1, jump_length=10, jump_n_sample=10),
    dict(t_T=50, n_sample=1, jump_length=10, jump_n_sample=3),
    dict(t_T=25, n_sample=1, jump_length=3, jump_n_sample=2),
    dict(t_T=40, n_sample=2, jump_length=5, jump_n_sample=3, jump2_length=2, jump2_n_sample=2),
    dict(t_T=250, n_sample=1, jump_length=10, jump_n_sample=10, start_resampling=120),
])
def test_schedule_jump_equal(params):
    got = pd.get_schedule_jump(**params)
    assert got == jd.get_schedule_jump(**params)
    if params["t_T"] == 25 and params["jump_length"] == 10:
        pairs = list(zip(got[:-1], got[1:]))
        assert len(pairs) == 385 and sum(b < a for a, b in pairs) == 205


@pytest.mark.parametrize("steps,spacing", [(1000, "ddim25"), (1000, "10,20"), (100, "ddim25"), (100, [10])])
def test_space_timesteps_and_spaced_diffusion_equal(steps, spacing):
    assert pd.space_timesteps(steps, spacing) == jd.space_timesteps(steps, spacing)
    got = pd.SpacedDiffusion.create(num_timesteps=steps, timestep_respacing=spacing)
    want = jd.SpacedDiffusion.create(num_timesteps=steps, timestep_respacing=spacing)
    assert np.array_equal(got.base.schedule.betas, want.base.schedule.betas)
    assert np.array_equal(got.timestep_map, want.timestep_map) and got.timestep_map.dtype == np.int32
    assert got.use_timesteps == want.use_timesteps and got.num_timesteps == want.num_timesteps
    for prop in ("alphas_cumprod", "posterior_variance", "posterior_log_variance_clipped",
                 "posterior_mean_coef1", "posterior_mean_coef2"):
        assert np.array_equal(getattr(got.base.schedule, prop), getattr(want.base.schedule, prop)), prop


def _codec_notes(seed: int):
    """Notes through the port's codec: random grid-aligned notes encoded and
    decoded, so their times are what a corpus's tokens give."""
    rng = np.random.default_rng(seed)
    notes, cursor, tempo = [], 0.0, 120
    for j in range(150):
        if j % 37 == 36:
            tempo = int(rng.choice([90, 120, 150, 200]))
        res = 60.0 / tempo / 64
        cursor += int(rng.choice([0, 0, 1, 2, 4, 8, 16])) * res
        notes.append(MidiNote(pitch=int(rng.integers(21, 108)), time_start=cursor,
                              time_end=cursor + int(rng.choice([4, 8, 16, 32, 64])) * res,
                              dynamic=int(rng.integers(1, 127)), channel=int(rng.integers(0, 3)), tempo=tempo))
    return decode(encode(notes))


@pytest.mark.parametrize("seed", [0, 1])
def test_canvas_codec_equal(seed):
    notes = _codec_notes(seed)
    for length in (None, 64):
        got, want = pd.create_canvas(notes, length), jd.create_canvas(notes, length)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert got.shape == (4, 128, 64) and got[0].any()
    norm = pd.normalize_canvas(got)
    assert np.array_equal(norm, jd.normalize_canvas(got))
    noisy = norm + 0.3 * np.random.default_rng(seed).standard_normal(norm.shape).astype(np.float32)
    back = pd.denormalize_canvas(noisy)
    assert np.array_equal(back, jd.denormalize_canvas(noisy))
    got_notes, want_notes = pd.canvas_to_notes(back), jd.canvas_to_notes(back)
    assert got_notes and [vars(n) for n in got_notes] == [vars(n) for n in want_notes]
    full = pd.create_canvas(notes)
    assert [vars(n) for n in pd.canvas_to_notes(full)] == [vars(n) for n in jd.canvas_to_notes(full)]


def test_random_snippet_equal():
    rng = np.random.default_rng(0)
    canvases = [rng.standard_normal((4, 128, t)).astype(np.float32) for t in (50, 12, 200)]
    got, want = pd.RandomSnippet(canvases, width=16, seed=3), jd.RandomSnippet(canvases, width=16, seed=3)
    for batch in (3, 5):
        a, b = got.sample(batch), want.sample(batch)
        assert a.shape == (batch, 4, 128, 16) and np.array_equal(a, b)
    assert len(got) == len(want) == 3
