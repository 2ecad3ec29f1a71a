#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (musicgen_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints one line of numbers; any failure exits non-zero):
  1. device: a CUDA card is required; its name and power limit are printed
     as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` says.
  2. build: the kernels of csrc/ are compiled with nvcc for sm_90a.
  3. kernel A (ssd_scan) against its plain version at the main-path shape.
  4. kernel B at full width: each decode kernel against its plain version on
     the same inputs, then 64 teacher-forced decode steps of the kernel chain
     against the plain chain from one shared prefill state.
  5. the main path through the CLI: a seeded random full-size MambaLM saved
     as a .pth, a synthesized two-band corpus, `cli.generate.main` at batch 2
     with a 2,048-token prompt and --length 2000, once greedy and once
     stochastic; every new token must be allowed by the grammar, the .mid
     files must re-extract with notes, and every kernel's launch counter must
     have risen by exactly what that path launches. Then the generation loop
     alone is timed with the kernels and with the plain step.
  4q. kernels B' (int8 GEMVs, W8A16 and W8A8) against their plain versions on
     the inputs of phase 4, then 16 teacher-forced steps per format.
  6. kernel C, the resident whole-generation kernel, in bf16, W8A16 and W8A8:
     [6 resident] 64 greedy tokens against the plain chain stepped over the
     emitted stream; [6 chain] 2,000 tokens, greedy and stochastic, against
     the per-token kernel chain with the same pick and uniforms (identical
     streams, bitwise-equal final states); [6 cli] the CLI with --fused-decode
     resident, resident-int8w, int8 and int8w (grammar, MIDI, launch
     counters); [6 loop] tok/s/seq of the resident loop beside the per-token
     chain's, with weight bytes per token and the share of the HBM roofline.
The last lines are one JSON object per kernel ({"kernels": [...]}) and
{"ok": true, "device": {...}}.

TF32 is off for every matmul and convolution: the plain versions are the
reference the kernels are held to.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"

SEED = 0
BATCH = 2
PROMPT = 2048
LENGTH = 2000
TEACHER_STEPS = 64
QUANT_STEPS = 16
RESIDENT_CHECK_TOKENS = 64
# [6 resident] steps the plain chain over the kernel's emitted stream from
# the shared prefill state, so the two chains drift apart as the chain does
# from itself (phase 4's [4 drift]: 7.7e-2 of the logits after 64 steps
# from a 1e-6 perturbation). Emitted tokens must be among the plain top-3
# over the first TOP3_STRICT_TOKENS; the final states are held to
# max(TOL_STEPS, 2x the drift of the plain chain from a 1e-6-perturbed start).
TOP3_STRICT_TOKENS = 16
PLAIN_LOOP_TOKENS = 200
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak (at 700 W)
# Tolerances, as max|kernel - plain| / max|plain|. f32 kernels differ from
# their plain versions only in the order of f32 sums; the bf16 GEMVs also
# round their activations to bf16 after an f32 normalisation computed in
# another order, which can flip one bf16 rounding (2^-8 relative).
TOL_F32 = 1e-4
TOL_BF16 = 1e-2
# One decode step of the randomly initialised full-size stack amplifies a
# 1e-6 perturbation of its state to about 1e-2 in the logits (ten layers
# without residuals, each rounding its activations to bf16); phase 4 prints
# that noise floor beside the kernel's error.
TOL_STEPS = 5e-2
# W8A8 quantises each activation to int8 per (row, 256-group) after an f32
# normalisation computed in another order than the plain version's: one
# f32 ulp can move an activation by one int8 level, 1/127 of its group's
# largest value, and a few such moves per row shift an output by up to a few
# parts in 1e3 of the largest output.
TOL_W8A8 = 2e-2

QUANTS = {"bf16": "none", "int8w": "w8a16", "int8": "w8a8"}  # pack -> how it runs

KERNEL_INFO = {
    "ssd_scan": ("musicgen_tpu_torch/csrc/ssd_scan.cu", "musicgen_tpu/ops/pallas_ssd.py:27"),
    "in_proj_conv": ("musicgen_tpu_torch/csrc/decode_gemv.cu", "musicgen_tpu/ops/pallas_decode.py:181"),
    "mixer_state": ("musicgen_tpu_torch/csrc/decode_mixer.cu", "musicgen_tpu/ops/pallas_decode.py:181"),
    "out_proj_rms": ("musicgen_tpu_torch/csrc/decode_gemv.cu", "musicgen_tpu/ops/pallas_decode.py:181"),
    "lm_head_ln": ("musicgen_tpu_torch/csrc/decode_gemv.cu", "musicgen_tpu/ops/pallas_decode.py:279"),
    "sample_tail": ("musicgen_tpu_torch/csrc/decode_tail.cu", "musicgen_tpu/ops/pallas_decode.py:293"),
    **{f"{name}_{q}": ("musicgen_tpu_torch/csrc/decode_gemv.cu", f"musicgen_tpu/ops/pallas_decode.py:{line}")
       for q, line in (("w8a16", 163), ("w8a8", 138)) for name in ("in_proj_conv", "out_proj_rms", "lm_head_ln")},
    **{f"generate_resident_{q}": ("musicgen_tpu_torch/csrc/generate_resident.cu",
                                  "musicgen_tpu/ops/pallas_generate.py:63") for q in ("bf16", "w8a16", "w8a8")},
}


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a, b) -> tuple[float, float]:
    """(max abs error, that error over max |b|)."""
    err = float((a.double() - b.double()).abs().max())
    return err, err / max(float(b.double().abs().max()), 1e-30)


def clone(c):
    return (c[0].clone(), c[1].clone())


def top3_agreement(torch, vk, ik, vp, ip) -> tuple[int, int]:
    """(checked, equal): the kernel's top-3 indices must equal the plain
    ones wherever the plain candidates are separated by more than
    TOL_STEPS (relative to the row's largest) from their neighbours."""
    gaps = (vp[:, :-1] - vp[:, 1:]) > TOL_STEPS * vp.abs().amax(dim=1, keepdim=True)
    gap_ok = torch.stack([gaps[:, 0], gaps[:, 0] & gaps[:, 1], gaps[:, 1]], dim=1)
    return int(gap_ok.sum()), int(((ik == ip) & gap_ok).sum())


def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------


def phase_device(torch) -> str:
    need(torch.cuda.is_available(), "no CUDA device (this script runs on the GPU only)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; {card}")
    return card


def phase_build() -> float:
    from musicgen_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.load_library()
    secs = time.perf_counter() - t0
    log = (build.library_path().parent / "build.log")
    usage = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln] if log.exists() else []
    say(f"[2 build] {secs:.2f} s -> {build.library_path()}")
    for ln in usage:
        say(f"    ptxas {ln}")
    return secs


def phase_ssd(torch, report: dict) -> None:
    from musicgen_tpu_torch.ops.ssd_kernel import ssd_scan
    from musicgen_tpu_torch.ops.ssm import ssd_chunked

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    b, t_real, t, h, p = BATCH, PROMPT + 6, 2304, 32, 64
    x = torch.randn(b, t, h, p, device=DEVICE, generator=gen)
    dt = 0.001 + 0.2 * torch.rand(b, t, h, device=DEVICE, generator=gen)
    A = -(1.0 + 15.0 * torch.rand(h, device=DEVICE, generator=gen))
    Bm = torch.randn(b, t, 1, p, device=DEVICE, generator=gen)
    Cm = torch.randn(b, t, 1, p, device=DEVICE, generator=gen)
    for v in (x, dt, Bm, Cm):  # the prefill's trailing pad steps
        v[:, t_real:] = 0
    y_k, s_k = ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    y_p, s_p = ssd_chunked(x, dt, A, Bm, Cm, chunk=256)
    torch.cuda.synchronize()
    ey, ry = rel_err(y_k, y_p)
    es, rs = rel_err(s_k, s_p)
    need(bool(torch.isfinite(y_k).all()) and bool(torch.isfinite(s_k).all()), "ssd_scan: non-finite output")
    ms = cuda_ms(torch, lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=256), iters=20)
    plain_ms = cuda_ms(torch, lambda: ssd_chunked(x, dt, A, Bm, Cm, chunk=256), iters=20)
    say(f"[3 ssd_scan] (B,T,H,P,N)=({b},{t},{h},{p},{p}): y max_abs {ey:.3e} rel {ry:.3e}; "
        f"state max_abs {es:.3e} rel {rs:.3e} (tol rel {TOL_F32}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    need(ry <= TOL_F32 and rs <= TOL_F32, "ssd_scan disagrees with ssd_chunked")
    report["ssd_scan"] = {"max_abs_err": max(ey, es), "ms": ms, "plain_ms": plain_ms}


def synth_corpus(root: Path) -> tuple[Path, Path]:
    """Two band dirs of seeded random token files (>= 3,000 tokens each) and
    a metadata.json, made with the codec on random grid-aligned notes."""
    import numpy as np

    from musicgen_tpu_torch.midi import MidiNote, encode

    rng = np.random.default_rng(SEED)
    corpus = root / "np"
    bands = ["Mozart", "Bach"]
    for band in bands:
        (corpus / band).mkdir(parents=True)
        for i in range(3):
            notes, cursor, tempo = [], 0.0, 120
            for j in range(800):
                if j % 37 == 36:
                    tempo = int(rng.choice([90, 120, 150, 200]))
                res = 60.0 / tempo / 64
                cursor += int(rng.choice([0, 0, 1, 2, 4, 8, 16, 32])) * res
                length = int(rng.choice([4, 8, 16, 32, 64, 128])) * res
                notes.append(MidiNote(pitch=int(rng.integers(21, 108)), time_start=cursor,
                                      time_end=cursor + length, dynamic=int(rng.integers(1, 127)),
                                      channel=int(rng.integers(0, 2)), tempo=tempo))
            toks = np.asarray(encode(notes), dtype=np.int64)
            need(len(toks) > PROMPT + 1, f"synthesized file too short ({len(toks)} tokens)")
            np.save(corpus / band / f"{band}_{i}.npy", toks)
    meta = root / "metadata.json"
    meta.write_text(json.dumps({"artists": [
        {"name": b, "year_started": 1700 + 40 * i, "genres": ["classical"]} for i, b in enumerate(bands)
    ]}))
    return corpus, meta


def phase_decode(torch, model, corpus: Path, meta_path: Path, report: dict) -> None:
    import numpy as np

    from musicgen_tpu_torch.data.dataset import TokenDataset
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops.grammar import field_bucket
    from musicgen_tpu_torch.sample.sampler import init_penalty_state, push_token

    ds = TokenDataset.from_directory(corpus / "Mozart", meta_path, block_len=PROMPT, seed=SEED)
    items = [ds[i] for i in range(BATCH)]
    prompt = torch.from_numpy(np.stack([s for s, _, _ in items]).astype(np.int64)).to(DEVICE)
    meta = torch.from_numpy(np.stack([m for _, _, m in items]).astype(np.int64)).to(DEVICE)
    dims = dk.DecodeDims.create(model.cfg, BATCH)
    dp = dk.build_decode_params(model, BATCH)
    with torch.no_grad():
        logits0, states = model.prefill(prompt, meta)
        torch.cuda.synchronize()
        prefill_ms = cuda_ms(torch, lambda: model.prefill(prompt, meta), iters=3, warmup=1)
        forward_ms = cuda_ms(torch, lambda: model(prompt, meta), iters=3, warmup=1)
    need(bool(torch.isfinite(logits0).all()), "prefill logits are not finite")
    say(f"[4 prefill] (B,T)=({BATCH},{PROMPT}+6): prefill with ssd_scan {prefill_ms:.3f} ms, "
        f"plain forward {forward_ms:.3f} ms")
    carry = dk.stack_states(states)
    pen = init_penalty_state(prompt, max(PROMPT, 2048))
    tok = prompt[:, -1]

    # Each kernel against its plain version on the same inputs.
    conv0, ssm0 = carry[0][0], carry[1][0]
    x = torch.nn.functional.embedding(tok, dp["embed"])
    layer0 = (dp["w_in"][0], dp["conv_w"][0], dp["conv_b"][0], dp["dt_bias"][0])
    cs_k, cs_p = conv0.clone(), conv0.clone()
    zx_k = dk.in_proj_conv(x, *layer0, cs_k, dims)
    zx = dk.in_proj_conv_plain(x, *layer0, cs_p, dims)
    ss_k, ss_p = ssm0.clone(), ssm0.clone()
    g_k = dk.mixer_state(zx, dp["a_h"][0], dp["d_h"][0], ss_k, dims)
    g = dk.mixer_state_plain(zx, dp["a_h"][0], dp["d_h"][0], ss_p, dims)
    o_k = dk.out_proj_rms(g, dp["norm_w"][0], dp["w_out"][0], dims)
    o = dk.out_proj_rms_plain(g, dp["norm_w"][0], dp["w_out"][0], dims)
    head = (dp["ln_w"], dp["ln_b"], dp["lm_w"], dp["lm_b"])
    l_k = dk.lm_head_ln(o, *head, dims)
    lg = dk.lm_head_ln_plain(o, *head, dims)
    bucket = field_bucket(tok)
    v_k, i_k = dk.sample_tail(lg, dp["gram"], pen.hist, bucket, dims)
    v_p, i_p = dk.sample_tail_plain(lg, dp["gram"], pen.hist, bucket, dims)
    torch.cuda.synchronize()
    checks = {
        "in_proj_conv": ([zx_k, cs_k], [zx, cs_p], TOL_F32),
        "mixer_state": ([g_k, ss_k], [g, ss_p], TOL_F32),
        "out_proj_rms": ([o_k], [o], TOL_BF16),
        "lm_head_ln": ([l_k], [lg], TOL_BF16),
        "sample_tail": ([v_k], [v_p], TOL_F32),
    }
    timers = {
        "in_proj_conv": (lambda: dk.in_proj_conv(x, *layer0, cs_k, dims),
                         lambda: dk.in_proj_conv_plain(x, *layer0, cs_p, dims)),
        "mixer_state": (lambda: dk.mixer_state(zx, dp["a_h"][0], dp["d_h"][0], ss_k, dims),
                        lambda: dk.mixer_state_plain(zx, dp["a_h"][0], dp["d_h"][0], ss_p, dims)),
        "out_proj_rms": (lambda: dk.out_proj_rms(g, dp["norm_w"][0], dp["w_out"][0], dims),
                         lambda: dk.out_proj_rms_plain(g, dp["norm_w"][0], dp["w_out"][0], dims)),
        "lm_head_ln": (lambda: dk.lm_head_ln(o, *head, dims),
                       lambda: dk.lm_head_ln_plain(o, *head, dims)),
        "sample_tail": (lambda: dk.sample_tail(lg, dp["gram"], pen.hist, bucket, dims),
                        lambda: dk.sample_tail_plain(lg, dp["gram"], pen.hist, bucket, dims)),
    }
    for name, (outs, refs, tol) in checks.items():
        errs = [rel_err(a, b) for a, b in zip(outs, refs)]
        worst_abs, worst_rel = max(e[0] for e in errs), max(e[1] for e in errs)
        ms = cuda_ms(torch, timers[name][0])
        plain_ms = cuda_ms(torch, timers[name][1])
        say(f"[4 {name}] max_abs {worst_abs:.3e} rel {worst_rel:.3e} (tol rel {tol}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        need(all(bool(torch.isfinite(a).all()) for a in outs), f"{name}: non-finite output")
        need(worst_rel <= tol, f"{name} disagrees with its plain version")
        report[name] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms}
    need(bool((i_k == i_p).all()), f"sample_tail top-3 indices differ: {i_k.tolist()} vs {i_p.tolist()}")

    # 64 teacher-forced steps from the prefill state. Each step runs the
    # plain chain from the kernel chain's state, and once more from that
    # state perturbed by 1e-6 (the plain chain's own noise floor). The
    # free-running chains show how far the same noise carries over 64 steps.
    noise = torch.Generator(device=DEVICE).manual_seed(SEED)

    def perturbed(c):
        c = clone(c)
        c[1].mul_(1.0 + 1e-6 * torch.randn(c[1].shape, device=DEVICE, generator=noise))
        return c

    carry_k, free_p, free_q = clone(carry), clone(carry), perturbed(carry)
    teacher = torch.from_numpy(np.stack([ds[i][0][:TEACHER_STEPS] for i in range(BATCH)]).astype(np.int64)).to(DEVICE)
    worst_logit, worst_state, worst_val, worst_noise, idx_checked, idx_equal = 0.0, 0.0, 0.0, 0.0, 0, 0
    for s in range(TEACHER_STEPS):
        tok = teacher[:, s]
        pen = push_token(pen, tok)
        bucket = field_bucket(tok)
        carry_p, carry_n = clone(carry_k), perturbed(carry_k)
        lk = dk.decode_logits(dp, tok, carry_k, dims)
        lp = dk.decode_logits(dp, tok, carry_p, dims, ops=dk.PLAIN_OPS)
        ln = dk.decode_logits(dp, tok, carry_n, dims, ops=dk.PLAIN_OPS)
        worst_noise = max(worst_noise, rel_err(ln, lp)[1])
        vk, ik = dk.sample_tail(lk, dp["gram"], pen.hist, bucket, dims)
        vp, ip = dk.sample_tail_plain(lp, dp["gram"], pen.hist, bucket, dims)
        worst_logit = max(worst_logit, rel_err(lk[:, :dims.vocab_size], lp[:, :dims.vocab_size])[1])
        worst_state = max(worst_state, rel_err(carry_k[1], carry_p[1])[1], rel_err(carry_k[0], carry_p[0])[1])
        worst_val = max(worst_val, rel_err(vk, vp)[1])
        checked, equal = top3_agreement(torch, vk, ik, vp, ip)
        idx_checked, idx_equal = idx_checked + checked, idx_equal + equal
        free_k = dk.decode_logits(dp, tok, free_p, dims, ops=dk.PLAIN_OPS)
        free_n = dk.decode_logits(dp, tok, free_q, dims, ops=dk.PLAIN_OPS)
    torch.cuda.synchronize()
    drift_kernel = rel_err(lk, free_k)[1]
    drift_noise = rel_err(free_n, free_k)[1]
    step_ms = cuda_ms(torch, lambda: dk.fused_sample_step(dp, tok, carry_k, pen.hist, bucket, dims), iters=30)
    plain_step_ms = cuda_ms(torch, lambda: dk.sample_tail_plain(
        dk.decode_logits(dp, tok, carry_p, dims, ops=dk.PLAIN_OPS), dp["gram"], pen.hist, bucket, dims), iters=30)
    say(f"[4 steps] {TEACHER_STEPS} teacher-forced steps, each from a shared state: logits rel {worst_logit:.3e}, "
        f"states rel {worst_state:.3e}, top-3 values rel {worst_val:.3e} (tol {TOL_STEPS}); top-3 indices equal "
        f"at {idx_equal}/{idx_checked} separated candidates; plain chain from a state perturbed by 1e-6: "
        f"logits rel {worst_noise:.3e}; decode step kernel {step_ms:.4f} ms, "
        f"plain {plain_step_ms:.4f} ms")
    say(f"[4 drift] after {TEACHER_STEPS} free-running steps: kernel vs plain chain logits rel {drift_kernel:.3e}; "
        f"plain chain vs itself from a state perturbed by 1e-6: {drift_noise:.3e}")
    need(worst_logit <= TOL_STEPS and worst_val <= TOL_STEPS and worst_state <= TOL_STEPS,
         "decode steps disagree with the plain chain")
    need(idx_equal == idx_checked, "decode steps picked other top-3 candidates")
    return {"prompt": prompt, "meta": meta, "teacher": teacher, "logits": logits0[:, -1, :], "carry": carry,
            "x": x, "g": g, "o": o, "dims": dims}


def phase_cli(torch, model, corpus: Path, meta_path: Path, root: Path, report: dict) -> None:
    import numpy as np

    from musicgen_tpu_torch.cli import generate as cli
    from musicgen_tpu_torch.midi import extract_midi
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops.grammar import field_bucket, grammar_mask
    from musicgen_tpu_torch.ops.ssd_kernel import ssd_scan
    from musicgen_tpu_torch.sample import sampler

    ckpt = root / "mamba_random.pth"
    torch.save(model.state_dict(), ckpt)
    ssd_scan.launches = 0
    dk.LAUNCHES.clear()
    runs = []
    t0 = time.perf_counter()
    for greedy in (True, False):
        out = root / ("gen_greedy" if greedy else "gen_sampled")
        argv = ["--model", "mamba", "--ckpt", str(ckpt), "--data", str(corpus), "--metadata", str(meta_path),
                "--composers", "Mozart, Bach", "--batch", str(BATCH), "--block-len", str(PROMPT),
                "--length", str(LENGTH),
                "--output", str(out), "--seed", str(SEED)] + (["--greedy"] if greedy else [])
        runs.append((out, cli.main(argv)))
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {"ssd_scan": ssd_scan.launches, **dk.LAUNCHES}

    mask = grammar_mask()
    n_gen = 0
    for out, streams in runs:
        need(sorted(streams) == ["Bach", "Mozart"], f"CLI generated for {sorted(streams)}")
        for band, s in streams.items():
            need(s.shape == (BATCH, PROMPT + LENGTH), f"{band}: stream shape {s.shape}")
            s = torch.from_numpy(s)
            prev, new = s[:, PROMPT - 1:-1], s[:, PROMPT:]
            need(bool((mask[field_bucket(prev), new] > 0).all()), f"{band}: a generated token breaks the grammar")
            n_gen += 1
        mids = sorted(out.rglob("generated_*_mamba_*.mid"))
        need(len(mids) == 2 * BATCH, f"expected {2 * BATCH} .mid files in {out}, found {len(mids)}")
        for mid in mids:
            notes = extract_midi(str(mid))
            need(len(notes) > 0, f"{mid.name} re-extracts with no notes")
    L = model.cfg.n_layers
    want = {"ssd_scan": L * n_gen, "in_proj_conv": L * LENGTH * n_gen, "mixer_state": L * LENGTH * n_gen,
            "out_proj_rms": L * LENGTH * n_gen, "lm_head_ln": LENGTH * n_gen, "sample_tail": LENGTH * n_gen}
    say(f"[5 cli] {n_gen} generations of {LENGTH} tokens at batch {BATCH} after a {PROMPT}-token prompt "
        f"in {cli_s:.1f} s; grammatical; .mid files re-extract; launches {launches}")
    need(launches == want, f"launches in the CLI run {launches}, expected {want}")
    for name, n in want.items():
        report[name]["launches"] = n

    # The generation loop alone, kernels vs plain step, from one prefill.
    ds_items = [np.load(p) for p in sorted((corpus / "Bach").glob("*.npy"))[:BATCH]]
    prompt = torch.from_numpy(np.stack([t[:PROMPT] for t in ds_items])).to(DEVICE)
    meta = torch.zeros(BATCH, 6, dtype=torch.int64, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cfg = sampler.SamplerConfig(num_tokens=LENGTH, ring_size=max(PROMPT, 2048))
    dims = dk.DecodeDims.create(model.cfg, BATCH)
    dp = dk.build_decode_params(model, BATCH)
    with torch.no_grad():
        prefill, _ = sampler.make_sampler(model, "mamba", dp)
        logits, carry = prefill(prompt, meta)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.sample_tokens_fused_tail(dp, logits, carry, prompt, cfg, gen, dims)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        prefill, step = sampler.make_sampler(model, "mamba")
        logits, states = prefill(prompt, meta)
        plain_cfg = sampler.SamplerConfig(num_tokens=PLAIN_LOOP_TOKENS, ring_size=max(PROMPT, 2048))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.sample_tokens(step, logits, states, prompt, plain_cfg, gen)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    say(f"[5 loop] kernels: {LENGTH} tokens in {kernel_s:.3f} s = {LENGTH / kernel_s:.1f} tok/s/seq "
        f"({1e3 * kernel_s / LENGTH:.3f} ms/token); plain MambaLM.step: {PLAIN_LOOP_TOKENS} tokens in "
        f"{plain_s:.3f} s = {PLAIN_LOOP_TOKENS / plain_s:.1f} tok/s/seq ({1e3 * plain_s / PLAIN_LOOP_TOKENS:.3f} "
        f"ms/token); batch {BATCH}")


def phase_int8(torch, model, ctx: dict, report: dict) -> None:
    """[4q] kernels B' (W8A16, W8A8) against their plain versions on the
    inputs of phase 4, then QUANT_STEPS teacher-forced steps per format."""
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops.grammar import field_bucket
    from musicgen_tpu_torch.sample.sampler import init_penalty_state, push_token

    dims, x, g, o = ctx["dims"], ctx["x"], ctx["g"], ctx["o"]
    dp = dk.build_decode_params(model, BATCH, "int8")
    for q, tol in (("w8a16", TOL_BF16), ("w8a8", TOL_W8A8)):
        conv0 = ctx["carry"][0][0]
        cs_k, cs_p = conv0.clone(), conv0.clone()
        layer0 = (dp["w_in"][0], dp["conv_w"][0], dp["conv_b"][0], dp["dt_bias"][0])
        head = (dp["ln_w"], dp["ln_b"], dp["lm_w"], dp["lm_b"])
        runs = {
            "in_proj_conv": (lambda cs: dk.in_proj_conv(x, *layer0, cs, dims, dp["w_in_s"][0], q),
                             lambda cs: dk.in_proj_conv_plain(x, *layer0, cs, dims, dp["w_in_s"][0], q)),
            "out_proj_rms": (lambda cs: dk.out_proj_rms(g, dp["norm_w"][0], dp["w_out"][0], dims, dp["w_out_s"][0], q),
                             lambda cs: dk.out_proj_rms_plain(g, dp["norm_w"][0], dp["w_out"][0], dims,
                                                              dp["w_out_s"][0], q)),
            "lm_head_ln": (lambda cs: dk.lm_head_ln(o, *head, dims, dp["lm_s"], q),
                           lambda cs: dk.lm_head_ln_plain(o, *head, dims, dp["lm_s"], q)),
        }
        for name, (kern, plain) in runs.items():
            out_k, out_p = kern(cs_k), plain(cs_p)
            torch.cuda.synchronize()
            errs = [rel_err(out_k, out_p)] + ([rel_err(cs_k, cs_p)] if name == "in_proj_conv" else [])
            worst_abs, worst_rel = max(e[0] for e in errs), max(e[1] for e in errs)
            ms = cuda_ms(torch, lambda: kern(cs_k))
            plain_ms = cuda_ms(torch, lambda: plain(cs_p))
            say(f"[4q {name}_{q}] max_abs {worst_abs:.3e} rel {worst_rel:.3e} (tol rel {tol}); "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            need(bool(torch.isfinite(out_k).all()), f"{name}_{q}: non-finite output")
            need(worst_rel <= tol, f"{name}_{q} disagrees with its plain version")
            report[f"{name}_{q}"] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms}

        pen = init_penalty_state(ctx["prompt"], max(PROMPT, 2048))
        carry_k = clone(ctx["carry"])
        worst_logit, worst_state, idx_checked, idx_equal = 0.0, 0.0, 0, 0
        for step in range(QUANT_STEPS):
            tok = ctx["teacher"][:, step]
            pen = push_token(pen, tok)
            bucket = field_bucket(tok)
            carry_p = clone(carry_k)
            lk = dk.decode_logits(dp, tok, carry_k, dims, quant=q)
            lp = dk.decode_logits(dp, tok, carry_p, dims, ops=dk.PLAIN_OPS, quant=q)
            vk, ik = dk.sample_tail(lk, dp["gram"], pen.hist, bucket, dims)
            vp, ip = dk.sample_tail_plain(lp, dp["gram"], pen.hist, bucket, dims)
            worst_logit = max(worst_logit, rel_err(lk[:, :dims.vocab_size], lp[:, :dims.vocab_size])[1])
            worst_state = max(worst_state, rel_err(carry_k[0], carry_p[0])[1], rel_err(carry_k[1], carry_p[1])[1])
            checked, equal = top3_agreement(torch, vk, ik, vp, ip)
            idx_checked, idx_equal = idx_checked + checked, idx_equal + equal
        torch.cuda.synchronize()
        say(f"[4q steps_{q}] {QUANT_STEPS} teacher-forced steps from a shared state: logits rel {worst_logit:.3e}, "
            f"states rel {worst_state:.3e} (tol {TOL_STEPS}); top-3 indices equal at {idx_equal}/{idx_checked} "
            f"separated candidates")
        need(worst_logit <= TOL_STEPS and worst_state <= TOL_STEPS, f"{q} decode steps disagree with the plain chain")
        need(idx_equal == idx_checked, f"{q} decode steps picked other top-3 candidates")


def resident_start(torch, ctx: dict):
    """The resident loop's inputs after the prefill: the prefill top-3 from
    the plain tail, the last prompt token and the penalty window."""
    from musicgen_tpu_torch.ops.grammar import filtered_logits
    from musicgen_tpu_torch.sample.sampler import _iter_top_k, init_penalty_state, penalty_divisor

    prompt = ctx["prompt"]
    pen = init_penalty_state(prompt, max(PROMPT, 2048))
    w0 = filtered_logits(prompt[:, -1], ctx["logits"]) / penalty_divisor(pen.hist)
    vals, idxs = _iter_top_k(w0, 3)
    return vals, idxs, prompt[:, -1], pen


def phase_resident(torch, model, ctx: dict, report: dict) -> dict:
    """[6 resident] and [6 chain]: kernel C against its plain version and
    against the per-token kernel chain. Returns the packs by quant."""
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops import generate_kernel as gk
    from musicgen_tpu_torch.ops.grammar import field_bucket
    from musicgen_tpu_torch.sample.sampler import push_token

    dims = ctx["dims"]
    packs = {quant: dk.build_decode_params(model, BATCH, quant) for quant in QUANTS}
    vals0, idxs0, last0, pen0 = resident_start(torch, ctx)
    n = RESIDENT_CHECK_TOKENS
    for quant, q in QUANTS.items():
        dp, name = packs[quant], f"generate_resident_{'bf16' if q == 'none' else q}"
        carry_r, carry_p = clone(ctx["carry"]), clone(ctx["carry"])
        toks, _, _ = gk.fused_generate(dp, vals0, idxs0, last0, *carry_r, pen0, None, dims, n, True, q)
        torch.cuda.synchronize()
        grid = gk.fused_generate.grid
        # The plain chain stepped over the emitted stream, and once more from
        # the prefill state perturbed by 1e-6 (its own noise floor).
        noise = torch.Generator(device=DEVICE).manual_seed(SEED)
        carry_n = clone(ctx["carry"])
        carry_n[1].mul_(1.0 + 1e-6 * torch.randn(carry_n[1].shape, device=DEVICE, generator=noise))
        pen, vals, idxs = pen0, vals0, idxs0
        top1_checked = top1_equal = 0
        misses = []
        for t in range(n):
            tok = toks[:, t]
            sep = (vals[:, 0] - vals[:, 1]) > TOL_STEPS * vals.abs().amax(dim=1)
            top1_checked += int(sep.sum())
            top1_equal += int((sep & (tok == idxs[:, 0])).sum())
            misses += [t] * int((~(tok[:, None] == idxs).any(dim=1)).sum())
            pen = push_token(pen, tok)
            lp = dk.decode_logits(dp, tok, carry_p, dims, ops=dk.PLAIN_OPS, quant=q)
            vals, idxs = dk.sample_tail_plain(lp, dp["gram"], pen.hist, field_bucket(tok), dims)
            dk.decode_logits(dp, tok, carry_n, dims, ops=dk.PLAIN_OPS, quant=q)
        carry_t = clone(carry_p)
        plain_ms = cuda_ms(torch, lambda: dk.sample_tail_plain(
            dk.decode_logits(dp, tok, carry_t, dims, ops=dk.PLAIN_OPS, quant=q), dp["gram"], pen.hist,
            field_bucket(tok), dims), iters=10, warmup=2)
        e_conv, r_conv = rel_err(carry_r[0], carry_p[0])
        e_ssm, r_ssm = rel_err(carry_r[1], carry_p[1])
        r_noise = max(rel_err(carry_n[0], carry_p[0])[1], rel_err(carry_n[1], carry_p[1])[1])
        tol = max(TOL_STEPS, 2 * r_noise)
        say(f"[6 resident {quant}] grid {grid} x 1024 threads; {n} greedy tokens: top-1 equal at "
            f"{top1_equal}/{top1_checked} separated steps; outside the plain top-3 at steps {misses} "
            f"(none allowed before {TOP3_STRICT_TOKENS}); final states vs the plain chain over the emitted "
            f"stream: conv rel {r_conv:.3e}, ssm rel {r_ssm:.3e} (tol {tol:.3e}; plain chain from a state "
            f"perturbed by 1e-6: {r_noise:.3e}); plain step {plain_ms:.3f} ms")
        need(top1_equal == top1_checked, f"{name} emitted another top-1 at a separated step")
        need(all(t >= TOP3_STRICT_TOKENS for t in misses), f"{name} emitted a token outside the plain top-3")
        need(r_conv <= tol and r_ssm <= tol, f"{name}: final states disagree with the plain chain")
        report[name] = {"max_abs_err": max(e_conv, e_ssm), "plain_ms": plain_ms}

    # The per-token kernel chain with the same pick: identical, bit for bit.
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for quant, q in QUANTS.items():
        dp = packs[quant]
        for greedy in (True, False):
            u = None if greedy else torch.rand((LENGTH, BATCH, 2), generator=gen, device=DEVICE)
            carry_r, carry_c = clone(ctx["carry"]), clone(ctx["carry"])
            t0 = time.perf_counter()
            tr, _, _ = gk.fused_generate(dp, vals0, idxs0, last0, *carry_r, pen0, u, dims, LENGTH, greedy, q)
            torch.cuda.synchronize()
            res_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            tc, _, _ = gk.fused_generate_plain(dp, vals0, idxs0, last0, *carry_c, pen0, u, dims, LENGTH, greedy, q,
                                               ops=dk.KERNEL_OPS)
            torch.cuda.synchronize()
            chain_s = time.perf_counter() - t0
            differ = (tr != tc).any(dim=0).nonzero()
            first = int(differ[0]) if len(differ) else -1
            same_states = torch.equal(carry_r[0], carry_c[0]) and torch.equal(carry_r[1], carry_c[1])
            say(f"[6 chain {quant} {'greedy' if greedy else 'sampled'}] {LENGTH} tokens: streams "
                f"{'identical' if first < 0 else f'differ first at token {first}'}; final states "
                f"{'bitwise equal' if same_states else 'differ'} (ssm max_abs {rel_err(carry_r[1], carry_c[1])[0]:.3e}); "
                f"resident {res_s:.3f} s, per-token chain {chain_s:.3f} s")
            need(first < 0 and same_states, f"resident {quant} kernel differs from the per-token kernel chain")
    return packs


def phase_loop(torch, ctx: dict, packs: dict, report: dict) -> None:
    """[6 loop] tok/s/seq of the resident loop (one launch per generation)
    beside the per-token kernel chain's (sample_tokens_fused_tail), from one
    prefill, stochastic, LENGTH tokens; the weight bytes each token streams
    and the share of the HBM roofline they reach."""
    from musicgen_tpu_torch.ops import generate_kernel as gk
    from musicgen_tpu_torch.sample import sampler

    dims = ctx["dims"]
    vals0, idxs0, last0, pen0 = resident_start(torch, ctx)
    cfg = sampler.SamplerConfig(num_tokens=LENGTH, ring_size=max(PROMPT, 2048))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for quant, q in QUANTS.items():
        dp = packs[quant]
        weight_bytes = sum(dp[k].numel() * dp[k].element_size()
                           for k in ("w_in", "w_out", "lm_w", "w_in_s", "w_out_s", "lm_s") if k in dp)
        u = torch.rand((LENGTH, BATCH, 2), generator=gen, device=DEVICE)
        carry = clone(ctx["carry"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        gk.fused_generate(dp, vals0, idxs0, last0, *carry, pen0, u, dims, LENGTH, False, q)
        end.record()
        torch.cuda.synchronize()
        res_s = time.perf_counter() - t0
        dev_s = start.elapsed_time(end) / 1e3
        carry = clone(ctx["carry"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.sample_tokens_fused_tail(dp, ctx["logits"], carry, ctx["prompt"], cfg, gen, dims, quant=quant)
        torch.cuda.synchronize()
        chain_s = time.perf_counter() - t0
        share = weight_bytes / HBM_BYTES_PER_S / (res_s / LENGTH)
        name = f"generate_resident_{'bf16' if q == 'none' else q}"
        say(f"[6 loop {quant}] resident: {LENGTH} tokens in {res_s:.3f} s = {LENGTH / res_s:.1f} tok/s/seq "
            f"({1e3 * res_s / LENGTH:.4f} ms/token; device {dev_s:.3f} s between events, idle share "
            f"{max(0.0, 1 - dev_s / res_s):.4f}); per-token kernel chain: {LENGTH / chain_s:.1f} tok/s/seq "
            f"({1e3 * chain_s / LENGTH:.4f} ms/token); weights {weight_bytes} B/token = "
            f"{weight_bytes / (res_s / LENGTH) / 1e9:.1f} GB/s, {100 * share:.2f}% of the 3.35 TB/s roofline; "
            f"batch {BATCH}")
        report[name]["ms"] = 1e3 * res_s / LENGTH


def phase_cli_resident(torch, model, corpus: Path, meta_path: Path, root: Path, report: dict) -> None:
    """[6 cli] the CLI with --fused-decode resident (greedy and sampled, two
    bands), resident-int8w, int8 and int8w (one band each), and
    sampler.generate(resident=True, quant="int8"), the one resident format
    no CLI value takes: grammar, MIDI and exact launch counts, each run
    counted from zero."""
    import numpy as np

    from musicgen_tpu_torch.cli import generate as cli
    from musicgen_tpu_torch.midi import extract_midi
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops.grammar import field_bucket, grammar_mask
    from musicgen_tpu_torch.ops.ssd_kernel import ssd_scan
    from musicgen_tpu_torch.sample.sampler import generate

    ckpt = root / "mamba_random.pth"
    L, mask = model.cfg.n_layers, grammar_mask()

    def per_token(q):
        return {f"in_proj_conv_{q}": L * LENGTH, "mixer_state": L * LENGTH, f"out_proj_rms_{q}": L * LENGTH,
                f"lm_head_ln_{q}": LENGTH, "sample_tail": LENGTH}

    runs = [("resident", True, ["Mozart", "Bach"], {"generate_resident_bf16": 2}),
            ("resident", False, ["Mozart", "Bach"], {"generate_resident_bf16": 2}),
            ("resident-int8w", False, ["Bach"], {"generate_resident_w8a16": 1}),
            ("int8", False, ["Mozart"], per_token("w8a8")),
            ("int8w", False, ["Mozart"], per_token("w8a16"))]
    totals: dict = {}
    for i, (mode, greedy, bands, want) in enumerate(runs):
        out = root / f"gen6_{i}"
        argv = ["--model", "mamba", "--ckpt", str(ckpt), "--data", str(corpus), "--metadata", str(meta_path),
                "--composers", ", ".join(bands), "--batch", str(BATCH), "--block-len", str(PROMPT),
                "--length", str(LENGTH), "--output", str(out), "--seed", str(SEED + i),
                "--fused-decode", mode] + (["--greedy"] if greedy else [])
        ssd_scan.launches = 0
        dk.LAUNCHES.clear()
        t0 = time.perf_counter()
        streams = cli.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(dk.LAUNCHES)
        need(sorted(streams) == sorted(bands), f"CLI generated for {sorted(streams)}")
        for band, st in streams.items():
            need(st.shape == (BATCH, PROMPT + LENGTH), f"{band}: stream shape {st.shape}")
            st = torch.from_numpy(st)
            need(bool((mask[field_bucket(st[:, PROMPT - 1:-1]), st[:, PROMPT:]] > 0).all()),
                 f"--fused-decode {mode}, {band}: a generated token breaks the grammar")
        mids = sorted(out.rglob("generated_*_mamba_*.mid"))
        need(len(mids) == len(bands) * BATCH, f"expected {len(bands) * BATCH} .mid files in {out}")
        for mid in mids:
            need(len(extract_midi(str(mid))) > 0, f"{mid.name} re-extracts with no notes")
        say(f"[6 cli {mode}{' greedy' if greedy else ''}] {len(bands)} band(s) x {LENGTH} tokens at batch {BATCH} in "
            f"{secs:.1f} s; grammatical; .mid files re-extract; launches {launches}, ssd_scan {ssd_scan.launches}")
        need(launches == want, f"--fused-decode {mode}: launches {launches}, expected {want}")
        need(ssd_scan.launches == L * len(bands), f"--fused-decode {mode}: ssd_scan launched {ssd_scan.launches}")
        for name, n in want.items():
            if name.startswith(("generate_resident", "in_proj_conv_", "out_proj_rms_", "lm_head_ln_")):
                totals[name] = totals.get(name, 0) + n
    files = sorted((corpus / "Bach").glob("*.npy"))[:BATCH]
    prompt = torch.from_numpy(np.stack([np.load(f)[:PROMPT] for f in files])).to(DEVICE)
    meta = torch.zeros(BATCH, 6, dtype=torch.int64, device=DEVICE)
    ssd_scan.launches = 0
    dk.LAUNCHES.clear()
    t0 = time.perf_counter()
    st = generate(model, "mamba", prompt, meta, LENGTH, PROMPT, torch.Generator(device=DEVICE).manual_seed(SEED),
                  quant="int8", resident=True).cpu()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(dk.LAUNCHES)
    say(f"[6 api resident int8] sampler.generate(resident=True, quant='int8'): {LENGTH} tokens at batch {BATCH} in "
        f"{secs:.1f} s; launches {launches}, ssd_scan {ssd_scan.launches}")
    need(st.shape == (BATCH, PROMPT + LENGTH), f"resident int8: stream shape {tuple(st.shape)}")
    need(bool((mask[field_bucket(st[:, PROMPT - 1:-1]), st[:, PROMPT:]] > 0).all()),
         "resident int8: a generated token breaks the grammar")
    need(launches == {"generate_resident_w8a8": 1} and ssd_scan.launches == L,
         f"resident int8: launches {launches}, ssd_scan {ssd_scan.launches}")
    totals["generate_resident_w8a8"] = 1
    for name, n in totals.items():
        report[name]["launches"] = n


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    need((REPO / "musicgen_tpu_torch").is_dir(), f"run from a checkout of the repo ({REPO} has no musicgen_tpu_torch)")
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_device(torch)
    phase_build()
    report: dict = {}
    torch.set_grad_enabled(False)
    phase_ssd(torch, report)

    from musicgen_tpu_torch.config import MambaConfig
    from musicgen_tpu_torch.models.mamba import empty_model, init_weights_

    model = init_weights_(empty_model(MambaConfig(), DEVICE), SEED).eval()
    n_params = sum(p.numel() for p in model.parameters())
    need(n_params == 101_972_666, f"full-size MambaLM has {n_params} parameters")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        corpus, meta_path = synth_corpus(root)
        ctx = phase_decode(torch, model, corpus, meta_path, report)
        phase_int8(torch, model, ctx, report)
        phase_cli(torch, model, corpus, meta_path, root, report)
        packs = phase_resident(torch, model, ctx, report)
        phase_loop(torch, ctx, packs, report)
        phase_cli_resident(torch, model, corpus, meta_path, root, report)

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = report[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"]})
    say(f"[done] {time.perf_counter() - t_start:.1f} s on {card}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
