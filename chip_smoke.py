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
  7. the Transformer at the reference size (8 blocks, d_model 1024, 8 heads
     of 128, block 2048; seeded random weights), kernels D and F:
     [7 flash] kernel D against its plain version at (2*8, 2054, 128) and
     the SDPA call with the BD term in a float mask; [7 prefill] the full
     prefill's last logits with D against the f32 plain attention;
     [7 tdecode] each kernel F launch against its plain twin on the same
     inputs in bf16 and W8A16, then 64 teacher-forced steps from a shared
     state against the plain twin chain and the f32 TransformerLM.step;
     [7 wrap] 40 steps at a block of 32 (the ring wraps) against the f32
     step; [7 cli] `--model transformer` with --fused-decode auto (greedy and
     stochastic) and int8w: grammar, MIDI, 8 launches of D per prefill and
     50 of F per token; [7 loop] tok/s/seq of the kernel F chain beside the
     plain step's, bytes per token and the share of the HBM roofline.
  8. training at full width, kernel D with its LSE output and kernel E (E1
     dQ + dRel, E2 dK + dV): [8 flash-bwd] D's LSE and E's four gradients
     against their plain versions at (2*8, 2054, 128), D's output unchanged
     by the LSE, the autograd round trip against the f32 attention, E's times
     host-paced and from a CUDA graph beside its bound, the plain version and
     the SDPA backward; [8 grad] the Transformer's loss and every gradient
     through D and E against the same model with their plain versions on the
     card (and, as information, the f32 attention), with exact launch counts;
     [8 steps] five Adam steps of each family on one batch (the loss falls at
     every step), ms/step, train tokens/s and peak memory; [8 cli]
     `cli.train` for each family (2 epochs, batch 2, block 2048) writing a
     checkpoint directory that `cli.generate --ckpt <dir>/model.pth` reads,
     with exact launch counts (a Mamba model trains through no kernel).
  9. the xLSTM at the reference size (11 blocks, d_model 1024, sLSTM at
     (1, 4, 7, 10); seeded random weights), kernels H and G: [9 slstm] kernel
     H against its plain scan at (2, 2054, 4, 256), with the scan's own noise
     floor; [9 prefill] the full prefill's last logits with H against the
     plain scan, 4 launches of H; [9 xdecode ...] each kernel G launch against
     its plain version in bf16, W8A16 and with the matrix memory stored in
     bf16 (sb16), then 64 teacher-forced steps from a shared state against the
     plain chain and the f32 XLSTMLM.step, with the plain chain's noise floor
     ([9 drift]); [9 cli] `--model xlstm` with --fused-decode auto (greedy and
     stochastic, 2,000 tokens), int8w, sb16 and int8w-sb16 (shorter), on,
     int8 and off (shorter still): grammar, MIDI, 4 launches of H a prefill
     and G's 68 a token (none with off); [9 loop]
     tok/s/seq of the G chain in each format beside the plain step's, the
     device time of one step in a CUDA graph, bytes per token and the share of
     the HBM roofline.
 10. the two Hopper probes: [10 probe_mm] kernel I (the bf16 weight-streaming
     product) against its plain version at (8, 1024) x (1024, 4352), one
     chain step's exact launches, and [10 hw] the entry point
     `experiments.hw_characterize.run` (ten products a step through kernel
     I, the port's decode GEMV mg_x_gemv, the f32 matmul and the bf16
     library call; GB/s of weights); [10 ablate_stream], [10 ablate_gemv],
     [10 ablate_nossd] kernel J's launches against their plain versions at
     full width (ablate_stream's XOR of every weight word against the
     host's), [10 variant <mode>] one step of V_dma, V_mm, V_nossd and V_full
     against its plain chain with exact launch counts (11 / 21 / 31 / 31),
     and [10 ablate] the entry point `experiments.kernel_ablate.run` and the
     split of kernel B's device step.
`python3 chip_smoke.py --only 9` runs phases 1, 2 and 9 alone, `--only 10`
phases 1, 2 and 10 (bring-up of a slice; the full run takes no arguments).
The last lines are one JSON object with every kernel ({"kernels": [...]}: its
launches on the main path, error, time, plain time, bound and library time)
and {"ok": true, "device": {...}}.

TF32 is off for every matmul and convolution: the plain versions are the
reference the kernels are held to.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
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
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak (H100 SXM data sheet)
F32_FLOPS = 67e12  # f32 outside the tensor cores (H100 SXM data sheet)
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

# The Transformer (phase 7): the reference size (8 pre-LN blocks, d_model 1024,
# 8 heads of 128, block 2048), seeded random weights.
TQUANTS = {"bf16": "none", "int8w": "w8a16"}  # kernel F's packs -> how they run
T_TEACHER_STEPS = 64
WRAP_BLOCK, WRAP_STEPS = 32, 40
T_PLAIN_LOOP_TOKENS = 100
# Kernel D rounds q, k, v, rel and the probabilities to bf16; through 8
# blocks the prefill's last logits stay within a few 1e-3 of the f32 plain
# attention's (PERF.md).
TOL_PREFILL = 5e-2
# Kernel F's split softmax rounds its probabilities to bf16 relative to each
# split's maximum, the plain twin relative to the normalised total (the TPU
# kernel's rounding point): 2^-9 relative per probability, a few 1e-3 of the
# logits per step from a shared state.
TOL_T_STEP = 1e-2
# The bf16 / W8A16 chain against the f32 TransformerLM.step: the JAX test's
# tolerances (tests/test_pallas_transformer_decode.py), as a share of the
# largest logit.
TOL_T_F32 = {"bf16": 0.05, "int8w": 0.12}

# Phase 8, training. Kernel E against its plain version: bf16 operands, and
# dRel summed with f32 atomics in no fixed order (TOL_BF16). The training
# attention against torch.autograd through the f32 attention: the tolerance
# of tests/test_pallas_attention.py for the TPU kernel. The full model's loss
# and gradients through D and E against the same model with their plain
# versions on the card: the two round p and dS to bf16 after f32 sums in
# another order, so single roundings flip (2^-8 relative) and the flips add up
# through 8 blocks. The worst tensor is a rel_pos_emb: each of its rows sums
# bf16-rounded dS along a diagonal, terms that largely cancel, so the
# rounding noise stands out against its largest entry (1.3e-2 of it on the
# H100; the other tensors stay near 1e-3). 2e-2 holds that, where a missing
# or wrong term moves a gradient by O(1).
TOL_TRAIN_F32 = 3e-2
TOL_LOSS = 1e-4
TOL_GRAD = 2e-2
TRAIN_STEPS = 5
TRAIN_EPOCHS = 2
GEN_AFTER_TRAIN = 32

# Phase 9, the xLSTM. Kernel H against its plain scan: f32 sums in another
# order over 2,054 dependent steps; held to the 2e-4 of
# tests/test_pallas_slstm.py, or to twice the scan's own drift from a 1e-6
# perturbation of its input, whichever is larger (both printed).
TOL_H = 2e-4
# The full prefill's last logits with kernel H against the plain scan: the same
# f32 noise through 11 blocks.
TOL_X_PREFILL = 1e-3
XQUANTS = {"bf16": "none", "int8w": "w8a16", "bf16-sb16": "none"}  # kernel G's formats -> how the products run
TOL_W8A16 = 2e-2  # a W8A16 GEMV against its plain version (bf16 activations, int8 weights, f32 sums)
# The kernel chain against the plain chain from a shared state, each step: the
# plain chain's own response to a 1e-6 perturbation of the state sets the
# floor (printed); the tolerance is the larger of TOL_T_STEP and twice it.
# Against the f32 XLSTMLM.step: the JAX test's tolerances
# (tests/test_pallas_xlstm_decode.py), as a share of the largest logit.
TOL_X_F32 = {"bf16": 0.05, "int8w": 0.12, "bf16-sb16": 0.05}
X_CLI_SHORT = 200  # tokens of the int8w / sb16 / int8w-sb16 CLI runs
X_CLI_TINY = 64  # tokens of the on / int8 / off CLI runs
X_LOOP_TOKENS = 500
X_PLAIN_LOOP_TOKENS = 100

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
    "flash_relpos": ("musicgen_tpu_torch/csrc/flash_relpos.cu", "musicgen_tpu/ops/pallas_attention.py:44"),
    **{f"{name}{sfx}": ("musicgen_tpu_torch/csrc/decode_gemv.cu", "musicgen_tpu/ops/pallas_transformer_decode.py:254")
       for name in ("t_qkv_ln", "t_res", "t_fc_relu") for sfx in ("", "_w8a16")},
    **{name: ("musicgen_tpu_torch/csrc/tdecode_attn.cu", "musicgen_tpu/ops/pallas_transformer_decode.py:254")
       for name in ("tdecode_attn_split", "tdecode_attn_combine")},
    "flash_relpos_lse": ("musicgen_tpu_torch/csrc/flash_relpos.cu", "musicgen_tpu/ops/pallas_attention.py:44"),
    "flash_bwd_dq": ("musicgen_tpu_torch/csrc/flash_relpos_bwd.cu", "musicgen_tpu/ops/pallas_attention.py:310"),
    "flash_bwd_dkv": ("musicgen_tpu_torch/csrc/flash_relpos_bwd.cu", "musicgen_tpu/ops/pallas_attention.py:365"),
    "slstm_scan": ("musicgen_tpu_torch/csrc/slstm_scan.cu", "musicgen_tpu/ops/pallas_slstm.py:42"),
    **{name: ("musicgen_tpu_torch/csrc/xlstm_decode.cu", "musicgen_tpu/ops/pallas_xlstm_decode.py:410")
       for name in ("xm_up", "xm_prep", "xm_gates", "xm_memory", "xm_out", "xm_down", "xs_prep", "xs_in", "xs_cell",
                    "xs_ffn_up", "xs_ffn_down", "xm_memory_sb16", "xm_up_w8a16", "xm_down_w8a16", "xs_in_w8a16",
                    "xs_ffn_up_w8a16", "xs_ffn_down_w8a16")},
    "probe_mm": ("musicgen_tpu_torch/csrc/probe_mm.cu", "experiments/hw_characterize.py:33"),
    **{name: ("musicgen_tpu_torch/csrc/decode_ablate.cu", "experiments/kernel_ablate.py:54")
       for name in ("ablate_stream", "ablate_gemv", "ablate_nossd")},
}
# The phases of --only 9 and --only 10: the kernels a report of that phase holds.
X_KERNELS = [name for name, (src, _) in KERNEL_INFO.items() if src.endswith(("slstm_scan.cu", "xlstm_decode.cu"))]
PROBE_KERNELS = [name for name, (src, _) in KERNEL_INFO.items() if src.endswith(("probe_mm.cu", "decode_ablate.cu"))]


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
    return tuple(t.clone() for t in c)


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


def graph_ms(torch, fn, calls: int = 20, replays: int = 5):
    """Device time of fn() in ms without the host's launch overhead: `calls`
    calls captured in one CUDA graph, replayed, timed with CUDA events.
    Returns None, and says why, if fn cannot be captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize()
    except RuntimeError as e:
        say(f"    (CUDA graph capture failed, device time not measured: {str(e)[:200]})")
        return None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float, peak: float) -> dict:
    """The least time the card could take: the larger of n_bytes at the HBM
    rate and flops at `peak`, in ms, and which of the two it is."""
    tb, to = n_bytes / HBM_BYTES_PER_S, flops / peak
    return {"bound_ms": 1e3 * max(tb, to), "bound_by": "bytes" if tb >= to else "operations"}


def gemv_cost(x_rows: int, w, w_s=None, extra_bytes: int = 0) -> dict:
    """Bound of a GEMV: the weights (and scales) and the activations read
    once, the outputs written once; 2 flops per row and weight at the bf16
    peak."""
    n, k = w.shape
    n_bytes = nbytes(w) + (nbytes(w_s) if w_s is not None else 0) + 4 * x_rows * (k + n) + extra_bytes
    return bound(n_bytes, 2.0 * x_rows * n * k, BF16_FLOPS)


def bf16_weights(torch, w, w_s=None):
    """The bf16 weights F.linear takes as the library yardstick of a GEMV
    (an int8 pack dequantised once, outside the timing)."""
    if w_s is None:
        return w
    return (w.float() * w_s.repeat_interleave(w.shape[1] // w_s.shape[0], dim=0).t()).to(torch.bfloat16)


def linear_ms(torch, x, w_bf16) -> float:
    """Time of one F.linear on bf16 activations and weights (the library
    call computing a GEMV's product)."""
    xb = x.to(torch.bfloat16)
    return cuda_ms(torch, lambda: torch.nn.functional.linear(xb, w_bf16))


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
    dev_ms = graph_ms(torch, lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=256), calls=10)
    plain_ms = cuda_ms(torch, lambda: ssd_chunked(x, dt, A, Bm, Cm, chunk=256), iters=20)
    say(f"[3 ssd_scan] (B,T,H,P,N)=({b},{t},{h},{p},{p}): y max_abs {ey:.3e} rel {ry:.3e}; "
        f"state max_abs {es:.3e} rel {rs:.3e} (tol rel {TOL_F32}); "
        f"kernel {ms:.4f} ms (device, CUDA graph: {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms")
    need(ry <= TOL_F32 and rs <= TOL_F32, "ssd_scan disagrees with ssd_chunked")
    # Bound: x, dt, A, B, C read and y and the state written once; the
    # recurrence's 4 * P * N f32 flops per (b, t, h) (update and readout).
    cost = bound(nbytes(x, dt, A, Bm, Cm, y_k, s_k), 4.0 * b * t * h * p * p, F32_FLOPS)
    report["ssd_scan"] = {"max_abs_err": max(ey, es), "ms": ms, "plain_ms": plain_ms, "library_ms": None, **cost}


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
    b = BATCH
    costs = {
        "in_proj_conv": gemv_cost(b, dp["w_in"][0], extra_bytes=2 * nbytes(cs_k) + nbytes(*layer0[1:])),
        "mixer_state": bound(nbytes(zx, g_k) + 2 * nbytes(ss_k), 6.0 * ss_k.numel(), F32_FLOPS),
        "out_proj_rms": gemv_cost(b, dp["w_out"][0]),
        "lm_head_ln": gemv_cost(b, dp["lm_w"]),
        "sample_tail": bound(nbytes(lg, pen.hist, v_k, i_k) + 4 * b * dims.padded_vocab, 10.0 * lg.numel(), F32_FLOPS),
    }
    library = {"in_proj_conv": (x, dp["w_in"][0]), "out_proj_rms": (g, dp["w_out"][0]), "lm_head_ln": (o, dp["lm_w"])}
    for name, (outs, refs, tol) in checks.items():
        errs = [rel_err(a, b) for a, b in zip(outs, refs)]
        worst_abs, worst_rel = max(e[0] for e in errs), max(e[1] for e in errs)
        ms = cuda_ms(torch, timers[name][0])
        dev_ms = graph_ms(torch, timers[name][0])
        plain_ms = cuda_ms(torch, timers[name][1])
        lib_ms = linear_ms(torch, *library[name]) if name in library else None
        say(f"[4 {name}] max_abs {worst_abs:.3e} rel {worst_rel:.3e} (tol rel {tol}); "
            f"kernel {ms:.4f} ms (device, CUDA graph: {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, "
            f"bound {costs[name]['bound_ms']:.4f} ms "
            f"({costs[name]['bound_by']}), F.linear {lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms")
        need(all(bool(torch.isfinite(a).all()) for a in outs), f"{name}: non-finite output")
        need(worst_rel <= tol, f"{name} disagrees with its plain version")
        report[name] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, **costs[name]}
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
    step_dev_ms = graph_ms(torch, lambda: dk.fused_sample_step(dp, tok, carry_k, pen.hist, bucket, dims), calls=4)
    plain_step_ms = cuda_ms(torch, lambda: dk.sample_tail_plain(
        dk.decode_logits(dp, tok, carry_p, dims, ops=dk.PLAIN_OPS), dp["gram"], pen.hist, bucket, dims), iters=30)
    say(f"[4 steps] {TEACHER_STEPS} teacher-forced steps, each from a shared state: logits rel {worst_logit:.3e}, "
        f"states rel {worst_state:.3e}, top-3 values rel {worst_val:.3e} (tol {TOL_STEPS}); top-3 indices equal "
        f"at {idx_equal}/{idx_checked} separated candidates; plain chain from a state perturbed by 1e-6: "
        f"logits rel {worst_noise:.3e}; decode step kernel {step_ms:.4f} ms (device, CUDA graph of its 32 "
        f"launches: {fmt_ms(step_dev_ms)}), "
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
        costs = {"in_proj_conv": (x, dp["w_in"][0], dp["w_in_s"][0]),
                 "out_proj_rms": (g, dp["w_out"][0], dp["w_out_s"][0]),
                 "lm_head_ln": (o, dp["lm_w"], dp["lm_s"])}
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
            dev_ms = graph_ms(torch, lambda: kern(cs_k))
            plain_ms = cuda_ms(torch, lambda: plain(cs_p))
            xin, w, w_s = costs[name]
            cost = gemv_cost(BATCH, w, w_s, extra_bytes=2 * nbytes(cs_k) if name == "in_proj_conv" else 0)
            lib_ms = linear_ms(torch, xin, bf16_weights(torch, w, w_s))
            say(f"[4q {name}_{q}] max_abs {worst_abs:.3e} rel {worst_rel:.3e} (tol rel {tol}); "
                f"kernel {ms:.4f} ms (device, CUDA graph: {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, bound "
                f"{cost['bound_ms']:.4f} ms, F.linear (bf16 weights) {lib_ms:.4f} ms")
            need(bool(torch.isfinite(out_k).all()), f"{name}_{q}: non-finite output")
            need(worst_rel <= tol, f"{name}_{q} disagrees with its plain version")
            report[f"{name}_{q}"] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                     **cost}

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
        report[name] = {"max_abs_err": max(e_conv, e_ssm), "plain_ms": plain_ms, "library_ms": None}

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
        # Per token: the pack's weights stream once (166 MB in bf16 cannot
        # stay in the 50 MB L2 between tokens); the states are not counted.
        n_weights = sum(dp[k].numel() for k in ("w_in", "w_out", "lm_w"))
        report[name].update(ms=1e3 * res_s / LENGTH, **bound(weight_bytes, 2.0 * BATCH * n_weights, BF16_FLOPS))


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


# ---------------------------------------------------------------------------
# Phase 7: the Transformer (kernels D and F)
# ---------------------------------------------------------------------------


def set_attention(model, impl: str) -> None:
    """Point every block of a TransformerLM at attention_impl `impl`."""
    import dataclasses

    model.cfg = dataclasses.replace(model.cfg, attention_impl=impl)
    for blk in model.blocks:
        blk.sa.cfg = model.cfg


def relpos_mask(torch, q, rel, scale: float):
    """SDPA's float attn_mask for rel-pos attention: BD * scale where visible
    (BD 0 above the diagonal), -inf elsewhere, in q's dtype."""
    from musicgen_tpu_torch.ops.attention import rel_shift

    t = q.shape[-2]
    ti = torch.arange(t, device=q.device)
    below = ti[None, :] <= ti[:, None]
    bd = torch.where(below, rel_shift(torch.einsum("bhtd,hsd->bhts", q.float(), rel[:, :t].float())), 0.0)
    return (bd * scale).masked_fill(~(below | (ti[None, :] < 6)), float("-inf")).to(q.dtype)


def phase_t_flash(torch, report: dict) -> None:
    """[7 flash] kernel D against its plain version at the prefill's shape."""
    from musicgen_tpu_torch.ops import attention_kernel as ak

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    b, h, t, d = BATCH, 8, PROMPT + 6, 128
    qkv = torch.randn(b, t, 3, h, d, device=DEVICE, generator=gen)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # head views of one projection
    rel = torch.randn(h, t, d, device=DEVICE, generator=gen)
    scale = (h * d) ** -0.5
    out_k = ak.flash_relpos_attention(q, k, v, rel, scale)
    out_p = ak.flash_relpos_attention_plain(q, k, v, rel, scale)
    torch.cuda.synchronize()
    err, rel_e = rel_err(out_k, out_p)
    need(bool(torch.isfinite(out_k).all()), "flash_relpos: non-finite output")
    ms = cuda_ms(torch, lambda: ak.flash_relpos_attention(q, k, v, rel, scale), iters=20)
    dev_ms = graph_ms(torch, lambda: ak.flash_relpos_attention(q, k, v, rel, scale), calls=8)
    plain_ms = cuda_ms(torch, lambda: ak.flash_relpos_attention_plain(q, k, v, rel, scale), iters=3, warmup=1)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    mask = relpos_mask(torch, qb, rel, scale)  # built outside the timing
    lib_ms = cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=mask, scale=scale), iters=10)
    del mask
    pairs = t * (t + 1) // 2 + sum(max(0, 6 - r - 1) for r in range(min(t, 6)))  # visible (row, column) pairs
    cost = bound(nbytes(q, k, v, rel, out_k), 3 * 2.0 * d * pairs * b * h, BF16_FLOPS)
    say(f"[7 flash] (B*H, T, D) = ({b * h}, {t}, {d}): max_abs {err:.3e} rel {rel_e:.3e} (tol rel {TOL_BF16}); "
        f"kernel {ms:.4f} ms (device, CUDA graph: {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, SDPA (bf16, float "
        f"mask, mask build not timed) "
        f"{lib_ms:.4f} ms, bound {cost['bound_ms']:.4f} ms ({cost['bound_by']}, {pairs} visible pairs a head)")
    need(rel_e <= TOL_BF16, "flash_relpos disagrees with its plain version")
    report["flash_relpos"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, **cost}


def phase_t_prefill(torch, corpus: Path, meta_path: Path) -> dict:
    """[7 prefill] the full-size TransformerLM's prefill with kernel D
    against the f32 plain attention; returns the model, the prompt and the
    prefill state."""
    import numpy as np

    from musicgen_tpu_torch.config import TransformerConfig
    from musicgen_tpu_torch.data.dataset import TokenDataset
    from musicgen_tpu_torch.models.transformer import empty_model, init_weights_
    from musicgen_tpu_torch.ops import attention_kernel as ak

    model = init_weights_(empty_model(TransformerConfig(), DEVICE), SEED).eval()
    n_params = sum(p.numel() for p in model.parameters())
    ds = TokenDataset.from_directory(corpus / "Mozart", meta_path, block_len=PROMPT, seed=SEED)
    items = [ds[i] for i in range(BATCH)]
    prompt = torch.from_numpy(np.stack([s for s, _, _ in items]).astype(np.int64)).to(DEVICE)
    meta = torch.from_numpy(np.stack([m for _, _, m in items]).astype(np.int64)).to(DEVICE)
    teacher = torch.from_numpy(np.stack([ds[i][0][:T_TEACHER_STEPS] for i in range(BATCH)]).astype(np.int64)).to(DEVICE)
    ak.LAUNCHES.clear()
    logits_k, caches = model.prefill(prompt, meta)
    torch.cuda.synchronize()
    launches = ak.LAUNCHES["flash_relpos"]
    set_attention(model, "xla")
    logits_p, _ = model.prefill(prompt, meta)
    plain_ms = cuda_ms(torch, lambda: model.prefill(prompt, meta), iters=3, warmup=1)
    set_attention(model, "auto")
    ms = cuda_ms(torch, lambda: model.prefill(prompt, meta), iters=3, warmup=1)
    err, rel_e = rel_err(logits_k[:, -1], logits_p[:, -1])
    need(bool(torch.isfinite(logits_k).all()), "transformer prefill logits are not finite")
    say(f"[7 prefill] TransformerLM {n_params} parameters, (B, T) = ({BATCH}, {PROMPT}+6): {launches} kernel D "
        f"launches; last logits vs the f32 plain attention max_abs {err:.3e} rel {rel_e:.3e} (tol {TOL_PREFILL}); "
        f"prefill with kernel D {ms:.3f} ms, with the plain attention {plain_ms:.3f} ms")
    need(launches == model.cfg.n_layer, f"prefill launched kernel D {launches} times")
    need(rel_e <= TOL_PREFILL, "prefill with kernel D disagrees with the plain attention")
    return {"model": model, "prompt": prompt, "meta": meta, "teacher": teacher, "logits": logits_k[:, -1],
            "caches": caches, "prefill_ms": ms}


def phase_t_decode(torch, tctx: dict, report: dict) -> dict:
    """[7 tdecode] each kernel F launch against its plain twin on the same
    inputs, in bf16 and W8A16, then T_TEACHER_STEPS teacher-forced steps from
    a shared state against the plain twin chain and the f32
    TransformerLM.step. Returns the packs by quant."""
    import torch.nn.functional as F

    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops import tdecode_kernel as tk
    from musicgen_tpu_torch.ops.grammar import field_bucket
    from musicgen_tpu_torch.sample.cache import step_geometry, token_slot
    from musicgen_tpu_torch.sample.sampler import init_penalty_state, push_token

    model, prompt = tctx["model"], tctx["prompt"]
    dims = tk.TDims.create(model.cfg, BATCH)
    S, dm, H, hd = dims.ring, dims.d_model, dims.n_heads, dims.head_dim
    carry0 = tk.stack_transformer_cache(tctx["caches"], dims)
    packs = {quant: tk.build_transformer_decode_params(model, BATCH, quant) for quant in TQUANTS}
    c = PROMPT % S
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    x = F.embedding(prompt[:, -1], packs["bf16"]["embed"]) + 0.1 * torch.randn(BATCH, dm, device=DEVICE, generator=gen)
    for quant, q in TQUANTS.items():
        tp = packs[quant]
        sfx = "" if q == "none" else "_w8a16"

        def sc(name):
            return tp[name][0] if name in tp else None

        ck, cp = clone(carry0), clone(carry0)
        zx_k = tk.qkv_ln(x, tp["ln1"][0], tp["w_qkv"][0], ck[2][0], ck[3][0], c, dims, sc("qkv_s"), q)
        zx = tk.qkv_ln_plain(x, tp["ln1"][0], tp["w_qkv"][0], cp[2][0], cp[3][0], c, dims, sc("qkv_s"), q)
        attn_in = (zx, cp[2][0], cp[3][0], tp["rel_ring"][0], cp[0][0], cp[1][0], tp["rel_meta"][0], c, dims)
        parts_k, parts = tk.attn_split(*attn_in), tk.attn_split_plain(*attn_in)
        a_k, a = tk.attn_combine(*parts, dims), tk.attn_combine_plain(*parts, dims)
        pair_k, twin = tk.attention(*attn_in), tk.attention_plain(*attn_in)
        r_k = tk.res(a, tp["w_proj"][0], tp["proj_b"][0], x.clone(), dims, sc("proj_s"), q)
        r = tk.res_plain(a, tp["w_proj"][0], tp["proj_b"][0], x.clone(), dims, sc("proj_s"), q)
        h_k = tk.fc_relu(r, tp["ln2"][0], tp["w_fc"][0], tp["b_fc"][0], dims, sc("fc_s"), q)
        h = tk.fc_relu_plain(r, tp["ln2"][0], tp["w_fc"][0], tp["b_fc"][0], dims, sc("fc_s"), q)
        o_k = tk.res(h, tp["w_out"][0], tp["b_out"][0], r.clone(), dims, sc("out_s"), q)
        o = tk.res_plain(h, tp["w_out"][0], tp["b_out"][0], r.clone(), dims, sc("out_s"), q)
        torch.cuda.synchronize()
        checks = {
            f"t_qkv_ln{sfx}": ([zx_k, ck[2][0].float(), ck[3][0].float()], [zx, cp[2][0].float(), cp[3][0].float()],
                               TOL_BF16),
            f"t_res{sfx}": ([o_k, r_k], [o, r], TOL_BF16),
            f"t_fc_relu{sfx}": ([h_k], [h], TOL_BF16),
        }
        timers = {
            f"t_qkv_ln{sfx}": (lambda: tk.qkv_ln(x, tp["ln1"][0], tp["w_qkv"][0], ck[2][0], ck[3][0], c, dims,
                                                 sc("qkv_s"), q),
                               lambda: tk.qkv_ln_plain(x, tp["ln1"][0], tp["w_qkv"][0], cp[2][0], cp[3][0], c, dims,
                                                       sc("qkv_s"), q)),
            f"t_res{sfx}": (lambda: tk.res(h, tp["w_out"][0], tp["b_out"][0], r.clone(), dims, sc("out_s"), q),
                            lambda: tk.res_plain(h, tp["w_out"][0], tp["b_out"][0], r.clone(), dims, sc("out_s"), q)),
            f"t_fc_relu{sfx}": (lambda: tk.fc_relu(r, tp["ln2"][0], tp["w_fc"][0], tp["b_fc"][0], dims, sc("fc_s"), q),
                                lambda: tk.fc_relu_plain(r, tp["ln2"][0], tp["w_fc"][0], tp["b_fc"][0], dims,
                                                         sc("fc_s"), q)),
        }
        ring_row = 2 * 2 * BATCH * dm  # the new K and V rows written as bf16
        costs = {
            f"t_qkv_ln{sfx}": (x, gemv_cost(BATCH, tp["w_qkv"][0], sc("qkv_s"), ring_row + nbytes(tp["ln1"][0])),
                               bf16_weights(torch, tp["w_qkv"][0], sc("qkv_s"))),
            # t_res runs twice a layer; it is timed at the FFN's (d_model, 4 d_model) shape
            f"t_res{sfx}": (h, gemv_cost(BATCH, tp["w_out"][0], sc("out_s"), 4 * BATCH * dm + nbytes(tp["b_out"][0])),
                            bf16_weights(torch, tp["w_out"][0], sc("out_s"))),
            f"t_fc_relu{sfx}": (r, gemv_cost(BATCH, tp["w_fc"][0], sc("fc_s"), nbytes(tp["ln2"][0], tp["b_fc"][0])),
                                bf16_weights(torch, tp["w_fc"][0], sc("fc_s"))),
        }
        if q == "none":
            checks["tdecode_attn_split"] = (list(parts_k), list(parts), TOL_BF16)
            checks["tdecode_attn_combine"] = ([a_k], [a], TOL_F32)
            timers["tdecode_attn_split"] = (lambda: tk.attn_split(*attn_in), lambda: tk.attn_split_plain(*attn_in))
            timers["tdecode_attn_combine"] = (lambda: tk.attn_combine(*parts, dims),
                                              lambda: tk.attn_combine_plain(*parts, dims))
        for name, (outs, refs, tol) in checks.items():
            errs = [rel_err(a_, b_) for a_, b_ in zip(outs, refs)]
            worst_abs, worst_rel = max(e[0] for e in errs), max(e[1] for e in errs)
            ms = cuda_ms(torch, timers[name][0])
            dev_ms = graph_ms(torch, timers[name][0])
            plain_ms = cuda_ms(torch, timers[name][1], iters=10, warmup=2)
            if name in costs:
                xin, cost, w16 = costs[name]
                lib_ms = linear_ms(torch, xin, w16)
            elif name == "tdecode_attn_split":
                # SDPA over the 2054 slots of each (b, h), the rolled BD term
                # in a float mask; the keys, values and mask are built
                # outside the timing.
                u = torch.remainder(torch.arange(S, device=DEVICE) - c - 1, S)
                qh = zx[:, :dm].reshape(BATCH, H, 1, hd).to(torch.bfloat16)
                keys = torch.cat([cp[0][0][:, :6], cp[2][0]], dim=1).reshape(BATCH, 6 + S, H, hd).transpose(1, 2)
                vals = torch.cat([cp[1][0][:, :6], cp[3][0]], dim=1).reshape(BATCH, 6 + S, H, hd).transpose(1, 2)
                rel_rows = torch.cat([tp["rel_meta"][0][:6], tp["rel_ring"][0][u]]).reshape(6 + S, H, hd)
                mask = (torch.einsum("bhd,shd->bhs", qh[:, :, 0].float(), rel_rows.float()) * dims.scale)[:, :, None]
                mask = mask.to(torch.bfloat16)
                lib_ms = cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    qh, keys, vals, attn_mask=mask, scale=dims.scale))
                cost = bound(nbytes(cp[2][0], cp[3][0], tp["rel_ring"][0], cp[0][0], cp[1][0], tp["rel_meta"][0],
                                    *parts_k) + 4 * BATCH * dm, 3 * 2.0 * hd * (S + 6) * BATCH * H, F32_FLOPS)
            else:
                lib_ms = None
                cost = bound(nbytes(*parts_k, a_k), 3.0 * parts_k[2].numel(), F32_FLOPS)
            say(f"[7 tdecode {name}] max_abs {worst_abs:.3e} rel {worst_rel:.3e} (tol rel {tol}); kernel {ms:.4f} ms "
                f"(device, CUDA graph: {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, bound {cost['bound_ms']:.4f} ms "
                f"({cost['bound_by']}), library "
                f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms")
            need(all(bool(torch.isfinite(t_).all()) for t_ in outs), f"{name}: non-finite output")
            need(worst_rel <= tol, f"{name} disagrees with its plain version")
            report[name] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, **cost}
        e_pair = rel_err(pair_k, twin)[1]
        say(f"[7 tdecode attention {quant}] split + combine vs the TPU kernel's math (stale-row fix, one softmax): "
            f"rel {e_pair:.3e} (tol {TOL_T_STEP})")
        need(e_pair <= TOL_T_STEP, "kernel F's attention disagrees with the plain twin")

        # Teacher-forced steps from a shared state: the kernel chain, the
        # plain twin chain and the f32 TransformerLM.step, each step from the
        # kernel chain's rings.
        pen = init_penalty_state(prompt, max(PROMPT, 2048))
        ck = clone(carry0)
        worst_twin = worst_f32 = worst_ring = worst_val = 0.0
        idx_checked = idx_equal = 0
        for step in range(T_TEACHER_STEPS):
            tok, stream_idx = tctx["teacher"][:, step], PROMPT + step
            pen = push_token(pen, tok)
            bucket = field_bucket(tok)
            cp = clone(ck)
            caches = tk.unstack_transformer_cache(ck, dims)
            lk = tk.transformer_decode_logits(tp, tok, ck, dims, stream_idx, quant=q)
            lp = tk.transformer_decode_logits(tp, tok, cp, dims, stream_idx, ops=tk.PLAIN_OPS, quant=q)
            ages, base = step_geometry(stream_idx + 1, S, device=DEVICE)
            lf, _ = model.step(tok, caches, token_slot(stream_idx, S), ages, base)
            v = dims.vocab_size
            worst_twin = max(worst_twin, rel_err(lk[:, :v], lp[:, :v])[1])
            worst_f32 = max(worst_f32, rel_err(lk[:, :v], lf)[1])
            worst_ring = max(worst_ring, *(rel_err(ck[i].float(), cp[i].float())[1] for i in (2, 3)))
            vk, ik = dk.sample_tail(lk, tp["gram"], pen.hist, bucket, dims)
            vp, ip = dk.sample_tail_plain(lp, tp["gram"], pen.hist, bucket, dims)
            worst_val = max(worst_val, rel_err(vk, vp)[1])
            checked, equal = top3_agreement(torch, vk, ik, vp, ip)
            idx_checked, idx_equal = idx_checked + checked, idx_equal + equal
        torch.cuda.synchronize()
        step_ms = cuda_ms(torch, lambda: tk.fused_transformer_sample_step(tp, tok, ck, pen.hist, bucket, dims,
                                                                          PROMPT + T_TEACHER_STEPS, q), iters=30)
        step_dev_ms = graph_ms(torch, lambda: tk.fused_transformer_sample_step(
            tp, tok, ck, pen.hist, bucket, dims, PROMPT + T_TEACHER_STEPS, q), calls=4)
        plain_step_ms = cuda_ms(torch, lambda: tk.fused_transformer_sample_step(
            tp, tok, cp, pen.hist, bucket, dims, PROMPT + T_TEACHER_STEPS, q, ops=tk.PLAIN_OPS), iters=5, warmup=1)
        say(f"[7 tdecode steps {quant}] {T_TEACHER_STEPS} teacher-forced steps from a shared state: vs the plain "
            f"twin chain logits rel {worst_twin:.3e}, rings rel {worst_ring:.3e}, top-3 values rel {worst_val:.3e} (tol "
            f"{TOL_T_STEP}); top-3 indices equal at {idx_equal}/{idx_checked} separated candidates; vs the f32 "
            f"TransformerLM.step logits rel {worst_f32:.3e} (tol {TOL_T_F32[quant]}); step with the kernels "
            f"{step_ms:.4f} ms (device, CUDA graph of the step's 50 launches: {fmt_ms(step_dev_ms)}), plain twins "
            f"{plain_step_ms:.4f} ms")
        need(max(worst_twin, worst_ring, worst_val) <= TOL_T_STEP,
             f"{quant} kernel F steps disagree with the plain twin")
        need(idx_equal == idx_checked, f"{quant} kernel F steps picked other top-3 candidates")
        need(worst_f32 <= TOL_T_F32[quant], f"{quant} kernel F steps disagree with TransformerLM.step")
    return packs


def phase_t_wrap(torch, corpus: Path) -> None:
    """[7 wrap] a full-width model at a block of 32: WRAP_STEPS steps wrap
    the ring; the kernel chain and the f32 TransformerLM.step each carry
    their own state, fed the f32 step's argmax, and the kernel chain is held
    to its plain twin from a shared state at every step."""
    import numpy as np

    from musicgen_tpu_torch.config import TransformerConfig
    from musicgen_tpu_torch.models.transformer import empty_model, init_weights_
    from musicgen_tpu_torch.ops import tdecode_kernel as tk
    from musicgen_tpu_torch.sample.cache import step_geometry, token_slot

    model = init_weights_(empty_model(TransformerConfig(block_len=WRAP_BLOCK), DEVICE), SEED + 1).eval()
    files = sorted((corpus / "Bach").glob("*.npy"))[:BATCH]
    prompt = torch.from_numpy(np.stack([np.load(f)[:WRAP_BLOCK] for f in files])).to(DEVICE)
    meta = torch.zeros(BATCH, 6, dtype=torch.int64, device=DEVICE)
    dims = tk.TDims.create(model.cfg, BATCH)
    logits0, caches0 = model.prefill(prompt, meta)
    for quant, q in TQUANTS.items():
        tp = tk.build_transformer_decode_params(model, BATCH, quant)
        ck = tk.stack_transformer_cache(caches0, dims)
        caches = [{n: t.clone() for n, t in c.items()} for c in caches0]
        tok = logits0[:, -1].argmax(-1)
        worst_f32 = worst_twin = 0.0
        for step in range(WRAP_STEPS):
            stream_idx = WRAP_BLOCK + step
            ages, base = step_geometry(stream_idx + 1, WRAP_BLOCK, device=DEVICE)
            lf, caches = model.step(tok, caches, token_slot(stream_idx, WRAP_BLOCK), ages, base)
            cp = clone(ck)
            lk, ck = tk.fused_transformer_logits_step(tp, tok, ck, dims, stream_idx, q)
            lp, _ = tk.fused_transformer_logits_step(tp, tok, cp, dims, stream_idx, q, ops=tk.PLAIN_OPS)
            worst_f32 = max(worst_f32, rel_err(lk, lf)[1])
            worst_twin = max(worst_twin, rel_err(lk, lp)[1])
            tok = lf.argmax(-1)
        torch.cuda.synchronize()
        say(f"[7 wrap {quant}] block {WRAP_BLOCK}, {WRAP_STEPS} steps (the ring wraps at step {WRAP_BLOCK}): kernel "
            f"chain vs the f32 step on its own state logits rel {worst_f32:.3e} (tol {TOL_T_F32[quant]}); vs the plain "
            f"twin from a shared state {worst_twin:.3e} (tol {TOL_T_STEP})")
        need(worst_f32 <= TOL_T_F32[quant] and worst_twin <= TOL_T_STEP, f"{quant} ring wrap disagrees")


def phase_t_cli(torch, tctx: dict, corpus: Path, meta_path: Path, root: Path, report: dict) -> None:
    """[7 cli] `--model transformer` through the CLI: --fused-decode auto,
    greedy and stochastic (two bands each), and int8w (one band); every new
    token grammatical, the .mid files re-extract, and each run, counted from
    zero, launches kernel D 8 times a prefill and kernel F's 50 launches a
    token."""
    from musicgen_tpu_torch.cli import generate as cli
    from musicgen_tpu_torch.midi import extract_midi
    from musicgen_tpu_torch.ops import attention_kernel as ak
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops.grammar import field_bucket, grammar_mask
    from musicgen_tpu_torch.ops.ssd_kernel import ssd_scan

    model = tctx["model"]
    ckpt = root / "transformer_random.pth"
    torch.save(model.state_dict(), ckpt)
    L, mask = model.cfg.n_layer, grammar_mask()
    runs = [("auto", True, ["Mozart", "Bach"]), ("auto", False, ["Mozart", "Bach"]), ("int8w", False, ["Bach"])]
    totals: dict = {}
    for i, (mode, greedy, bands) in enumerate(runs):
        out = root / f"gen7_{i}"
        argv = ["--model", "transformer", "--ckpt", str(ckpt), "--data", str(corpus), "--metadata", str(meta_path),
                "--composers", ", ".join(bands), "--batch", str(BATCH), "--block-len", str(PROMPT),
                "--length", str(LENGTH), "--output", str(out), "--seed", str(SEED + i),
                "--fused-decode", mode] + (["--greedy"] if greedy else [])
        n = len(bands)
        sfx = "_w8a16" if mode == "int8w" else ""
        want = {f"t_qkv_ln{sfx}": L * LENGTH * n, "tdecode_attn_split": L * LENGTH * n,
                "tdecode_attn_combine": L * LENGTH * n, f"t_res{sfx}": 2 * L * LENGTH * n,
                f"t_fc_relu{sfx}": L * LENGTH * n, f"lm_head_ln{sfx}": LENGTH * n, "sample_tail": LENGTH * n}
        ssd_scan.launches = 0
        ak.LAUNCHES.clear()
        dk.LAUNCHES.clear()
        t0 = time.perf_counter()
        streams = cli.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, flash = dict(dk.LAUNCHES), ak.LAUNCHES["flash_relpos"]
        need(sorted(streams) == sorted(bands), f"CLI generated for {sorted(streams)}")
        for band, st in streams.items():
            need(st.shape == (BATCH, PROMPT + LENGTH), f"{band}: stream shape {st.shape}")
            st = torch.from_numpy(st)
            need(bool((mask[field_bucket(st[:, PROMPT - 1:-1]), st[:, PROMPT:]] > 0).all()),
                 f"--model transformer --fused-decode {mode}, {band}: a generated token breaks the grammar")
        mids = sorted(out.rglob("generated_*_transformer_*.mid"))
        need(len(mids) == n * BATCH, f"expected {n * BATCH} .mid files in {out}")
        for mid in mids:
            need(len(extract_midi(str(mid))) > 0, f"{mid.name} re-extracts with no notes")
        per_token = sum(launches.values()) / (LENGTH * n)
        say(f"[7 cli {mode}{' greedy' if greedy else ''}] {n} band(s) x {LENGTH} tokens at batch {BATCH} after a "
            f"{PROMPT}-token prompt in {secs:.1f} s; grammatical; .mid files re-extract; kernel D {flash} launches "
            f"({L} a prefill); kernel F {per_token:g} launches a token: {launches}")
        need(launches == want, f"--model transformer --fused-decode {mode}: launches {launches}, expected {want}")
        need(flash == L * n and ssd_scan.launches == 0, f"--fused-decode {mode}: kernel D launched {flash} times")
        for name, cnt in {**want, "flash_relpos": flash}.items():
            if name in report and not name.startswith(("lm_head_ln", "sample_tail")):
                totals[name] = totals.get(name, 0) + cnt
    for name, cnt in totals.items():
        report[name]["launches"] = cnt


def phase_t_loop(torch, tctx: dict, packs: dict) -> None:
    """[7 loop] tok/s/seq of the kernel F chain (bf16, W8A16) with the
    sampler tail, LENGTH stochastic tokens from one prefill, beside the plain
    TransformerLM.step's; the bytes each token reads and their share of the
    HBM roofline."""
    from musicgen_tpu_torch.ops import tdecode_kernel as tk
    from musicgen_tpu_torch.sample import sampler

    model, prompt, meta = tctx["model"], tctx["prompt"], tctx["meta"]
    dims = tk.TDims.create(model.cfg, BATCH)
    cfg = sampler.SamplerConfig(num_tokens=LENGTH, ring_size=max(PROMPT, 2048))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for quant, q in TQUANTS.items():
        tp = packs[quant]
        prefill, _ = sampler.make_sampler(model, "transformer", tp, quant, PROMPT)
        logits, carry = prefill(prompt, meta)
        per_token = nbytes(*(tp[k] for k in ("w_qkv", "w_proj", "w_fc", "w_out", "lm_w", "rel_ring", "rel_meta",
                                             "qkv_s", "proj_s", "fc_s", "out_s", "lm_s") if k in tp), *carry)

        def step(pack, token, state, hist, bucket, stream_idx):
            return tk.fused_transformer_sample_step(pack, token, state, hist, bucket, dims, stream_idx, q)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        sampler.sample_tokens_fused_tail(tp, logits, carry, prompt, cfg, gen, dims, fused_step=step)
        end.record()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        dev_s = start.elapsed_time(end) / 1e3
        share = per_token / HBM_BYTES_PER_S / (secs / LENGTH)
        say(f"[7 loop {quant}] kernel F chain: {LENGTH} tokens in {secs:.3f} s = {LENGTH / secs:.1f} tok/s/seq "
            f"({1e3 * secs / LENGTH:.4f} ms/token; events {dev_s:.3f} s); {per_token} B/token (weights, rel tables, "
            f"KV rings) = {per_token / (secs / LENGTH) / 1e9:.1f} GB/s, {100 * share:.2f}% of the 3.35 TB/s roofline "
            f"({1e3 * per_token / HBM_BYTES_PER_S:.4f} ms/token bound); batch {BATCH}; prefill with kernel D "
            f"{tctx['prefill_ms']:.3f} ms")
    prefill, step = sampler.make_sampler(model, "transformer", block_len=PROMPT)
    logits, caches = prefill(prompt, meta)
    plain_cfg = sampler.SamplerConfig(num_tokens=T_PLAIN_LOOP_TOKENS, ring_size=max(PROMPT, 2048))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler.sample_tokens(step, logits, caches, prompt, plain_cfg, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    say(f"[7 loop plain] TransformerLM.step (f32): {T_PLAIN_LOOP_TOKENS} tokens in {secs:.3f} s = "
        f"{T_PLAIN_LOOP_TOKENS / secs:.1f} tok/s/seq ({1e3 * secs / T_PLAIN_LOOP_TOKENS:.3f} ms/token)")

# ---------------------------------------------------------------------------
# Phase 8: training (kernel D with its LSE output, kernel E)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_attention_kernels(ak):
    """FlashRelposAttention with the plain versions of kernel D-with-LSE and
    kernel E, on the card: the reference the kernels' gradients are held to."""
    saved = ak.flash_relpos_attention_lse, ak.flash_relpos_attention_bwd
    ak.flash_relpos_attention_lse = lambda *a: ak.flash_relpos_attention_plain(*a, with_lse=True)
    ak.flash_relpos_attention_bwd = ak.flash_relpos_attention_bwd_plain
    try:
        yield
    finally:
        ak.flash_relpos_attention_lse, ak.flash_relpos_attention_bwd = saved


def phase_flash_bwd(torch, report: dict) -> None:
    """[8 flash-bwd] kernel D's LSE output and kernel E against their plain
    versions at the training shape; the autograd round trip against the f32
    attention; E1, E2 and E's times beside the bound, the plain version and
    the SDPA backward."""
    import torch.nn.functional as F

    from musicgen_tpu_torch.ops import attention_kernel as ak
    from musicgen_tpu_torch.ops.attention import relpos_attention

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    b, h, t, d = BATCH, 8, PROMPT + 6, 128
    qkv = torch.randn(b, t, 3, h, d, device=DEVICE, generator=gen)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # head views of one projection
    rel = torch.randn(h, t, d, device=DEVICE, generator=gen)
    dout = torch.randn(b, h, t, d, device=DEVICE, generator=gen)
    scale = (h * d) ** -0.5
    out0 = ak.flash_relpos_attention(q, k, v, rel, scale)
    out, lse = ak.flash_relpos_attention_lse(q, k, v, rel, scale)
    out_p, lse_p = ak.flash_relpos_attention_plain(q, k, v, rel, scale, with_lse=True)
    grads = ak.flash_relpos_attention_bwd(q, k, v, rel, out, lse, dout, scale)
    grads_p = ak.flash_relpos_attention_bwd_plain(q, k, v, rel, out_p, lse_p, dout, scale)
    torch.cuda.synchronize()
    same = torch.equal(out0, out)
    e_out, r_out = rel_err(out, out_p)
    e_lse, r_lse = rel_err(lse, lse_p)
    errs = {n: rel_err(g, gp) for n, g, gp in zip(("dq", "dk", "dv", "drel"), grads, grads_p)}
    need(all(bool(torch.isfinite(x).all()) for x in (lse, *grads)), "kernel E: non-finite output")
    with torch.enable_grad():
        args = [x.detach().clone().requires_grad_() for x in (q, k, v, rel)]
        g_train = torch.autograd.grad(ak.flash_relpos_attention_train(*args, scale), args, dout)
        g_f32 = torch.autograd.grad(relpos_attention(*args, scale), args, dout)
    r_train = max(rel_err(a, b_)[1] for a, b_ in zip(g_train, g_f32))
    del g_train, g_f32, args, grads_p

    launch = ak.BackwardLaunch(q, k, v, rel, out, lse, dout, scale)
    runs = {"flash_bwd_dq": launch.dq, "flash_bwd_dkv": launch.dkv,
            "E": lambda: ak.flash_relpos_attention_bwd(q, k, v, rel, out, lse, dout, scale),
            "flash_relpos_lse": lambda: ak.flash_relpos_attention_lse(q, k, v, rel, scale)}
    ms = {n: cuda_ms(torch, fn, iters=10, warmup=2) for n, fn in runs.items()}
    dev_ms = {n: graph_ms(torch, fn, calls=5) for n, fn in runs.items()}
    plain_ms = cuda_ms(torch, lambda: ak.flash_relpos_attention_bwd_plain(q, k, v, rel, out_p, lse_p, dout, scale),
                       iters=2, warmup=1)
    plain_lse_ms = cuda_ms(torch, lambda: ak.flash_relpos_attention_plain(q, k, v, rel, scale, with_lse=True),
                           iters=3, warmup=1)
    # SDPA in bf16 with the BD term in a float mask that requires grad; the
    # mask is built, and the forward run, outside the timing.
    qb, kb, vb = (x.to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    mask = relpos_mask(torch, qb.detach(), rel, scale).requires_grad_()
    lib_fwd_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask, scale=scale),
                         iters=10)
    with torch.enable_grad():
        o_lib = F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask, scale=scale)
    do_lib = dout.to(torch.bfloat16)
    lib_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(o_lib, (qb, kb, vb, mask), do_lib, retain_graph=True),
                         iters=5, warmup=2)
    del o_lib, mask, qb, kb, vb, do_lib

    pairs = t * (t + 1) // 2 + sum(max(0, 6 - r - 1) for r in range(min(t, 6)))  # visible pairs a head
    per_product = 2.0 * d * pairs * b * h
    in_bytes = nbytes(q, k, v, rel, out, dout, lse)
    cost = {
        "E": bound(in_bytes + nbytes(*grads), 8 * per_product, BF16_FLOPS),  # AC BD dp dV dK dQ.K dQ.band dRel
        "flash_bwd_dq": bound(in_bytes + nbytes(grads[0], grads[3]), 6 * per_product, BF16_FLOPS),
        "flash_bwd_dkv": bound(in_bytes + nbytes(grads[1], grads[2]), 5 * per_product, BF16_FLOPS),
        "flash_relpos_lse": bound(nbytes(q, k, v, rel, out, lse), 3 * per_product, BF16_FLOPS),
    }
    say(f"[8 flash-bwd] (B*H, T, D) = ({b * h}, {t}, {d}): D with LSE bit-identical to D without it: {same}; out "
        f"rel {r_out:.3e}, lse max_abs {e_lse:.3e} rel {r_lse:.3e} vs the plain version (tol {TOL_BF16}, {TOL_F32}); "
        f"E vs its plain version: " + ", ".join(f"{n} max_abs {e:.3e} rel {r:.3e}" for n, (e, r) in errs.items())
        + f" (tol rel {TOL_BF16}); train round trip vs torch.autograd through the f32 attention rel {r_train:.3e} "
        f"(tol {TOL_TRAIN_F32})")
    for n, label in (("flash_bwd_dq", "E1 dQ+dRel"), ("flash_bwd_dkv", "E2 dK+dV"), ("E", "E1+E2"),
                     ("flash_relpos_lse", "D with LSE")):
        plain = plain_lse_ms if n == "flash_relpos_lse" else plain_ms
        lib = lib_fwd_ms if n == "flash_relpos_lse" else lib_bwd_ms
        say(f"[8 flash-bwd {label}] kernel {ms[n]:.4f} ms (device, CUDA graph: {fmt_ms(dev_ms[n])}), bound "
            f"{cost[n]['bound_ms']:.4f} ms ({cost[n]['bound_by']}), plain {plain:.4f} ms, SDPA "
            f"{'forward' if n == 'flash_relpos_lse' else 'backward (dq, dk, dv, dmask)'} (bf16, float mask) "
            f"{lib:.4f} ms")
    need(same, "kernel D's output changes when it writes the LSE")
    need(r_out <= TOL_BF16 and r_lse <= TOL_F32, "kernel D with LSE disagrees with its plain version")
    need(all(r <= TOL_BF16 for _, r in errs.values()), "kernel E disagrees with its plain version")
    need(r_train <= TOL_TRAIN_F32, "flash_relpos_attention_train disagrees with the f32 attention's gradients")
    report["flash_relpos_lse"] = {"max_abs_err": max(e_out, e_lse), "ms": ms["flash_relpos_lse"],
                                  "plain_ms": plain_lse_ms, "library_ms": lib_fwd_ms, **cost["flash_relpos_lse"]}
    report["flash_bwd_dq"] = {"max_abs_err": max(errs["dq"][0], errs["drel"][0]), "ms": ms["flash_bwd_dq"],
                              "plain_ms": plain_ms, "library_ms": lib_bwd_ms, **cost["flash_bwd_dq"]}
    report["flash_bwd_dkv"] = {"max_abs_err": max(errs["dk"][0], errs["dv"][0]), "ms": ms["flash_bwd_dkv"],
                               "plain_ms": plain_ms, "library_ms": lib_bwd_ms, **cost["flash_bwd_dkv"]}


def train_batch(torch, corpus: Path, meta_path: Path):
    """One (BATCH, PROMPT) training batch (src, trg, meta) from the corpus."""
    import numpy as np

    from musicgen_tpu_torch.data.dataset import TokenDataset

    ds = TokenDataset.from_directory(corpus, meta_path, block_len=PROMPT, crop="start", seed=SEED)
    items = [ds[i] for i in range(BATCH)]
    return tuple(torch.from_numpy(np.stack(x).astype(np.int64)).to(DEVICE) for x in zip(*items))


def phase_grad(torch, corpus: Path, meta_path: Path) -> None:
    """[8 grad] the full-width Transformer's loss and every parameter's
    gradient through kernels D and E against the same model with their plain
    versions on the card; the f32 attention's beside it."""
    from musicgen_tpu_torch.config import TransformerConfig
    from musicgen_tpu_torch.models.transformer import empty_model, init_weights_
    from musicgen_tpu_torch.ops import attention_kernel as ak
    from musicgen_tpu_torch.train.loss import filtered_cross_entropy

    model = init_weights_(empty_model(TransformerConfig(dropout=0.0), DEVICE), SEED)
    src, trg, meta = train_batch(torch, corpus, meta_path)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = filtered_cross_entropy(src, model(src, meta), trg)
            loss.backward()
        torch.cuda.synchronize()
        return float(loss), {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    ak.LAUNCHES.clear()
    loss_k, g_k = loss_and_grads()
    launches = dict(ak.LAUNCHES)
    with plain_attention_kernels(ak):
        loss_p, g_p = loss_and_grads()
    set_attention(model, "xla")
    loss_x, g_x = loss_and_grads()
    L = model.cfg.n_layer
    del model

    def worst(ref, skip=""):
        return max((rel_err(g_k[n], ref[n])[1], n) for n in g_k if not (skip and skip in n))

    w_plain, w_f32 = worst(g_p), worst(g_x)
    w_plain_rest = worst(g_p, "rel_pos_emb")
    want = {"flash_relpos_lse": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    say(f"[8 grad] TransformerLM full width, dropout 0, (B, T) = ({BATCH}, {PROMPT}): loss {loss_k:.6f} through D+E, "
        f"{loss_p:.6f} through their plain versions (rel {abs(loss_k - loss_p) / abs(loss_p):.3e}, tol {TOL_LOSS}); "
        f"worst gradient vs the plain versions rel {w_plain[0]:.3e} at {w_plain[1]} (tol {TOL_GRAD}; outside "
        f"rel_pos_emb {w_plain_rest[0]:.3e} at {w_plain_rest[1]}); as information, "
        f"vs the f32 attention: loss {loss_x:.6f}, worst gradient rel {w_f32[0]:.3e} at {w_f32[1]}; "
        f"launches a step {launches}")
    need(abs(loss_k - loss_p) <= TOL_LOSS * abs(loss_p), "the loss through D+E disagrees with the plain versions'")
    need(w_plain[0] <= TOL_GRAD, "a gradient through D+E disagrees with the plain versions'")
    need(launches == want, f"a training step launched {launches}, expected {want}")


def phase_train_steps(torch, corpus: Path, meta_path: Path) -> dict:
    """[8 steps] TRAIN_STEPS Adam steps of each family at full width on one
    batch: the loss falls at every step. Returns ms/step by family."""
    from musicgen_tpu_torch.config import MambaConfig, TransformerConfig
    from musicgen_tpu_torch.models import mamba, transformer
    from musicgen_tpu_torch.ops import attention_kernel as ak
    from musicgen_tpu_torch.ops.ssd_kernel import ssd_scan
    from musicgen_tpu_torch.train import trainer as T

    batch = train_batch(torch, corpus, meta_path)
    out = {}
    for family, module, cfg in (("transformer", transformer, TransformerConfig(dropout=0.0)),
                                ("mamba", mamba, MambaConfig())):
        model = module.init_weights_(module.empty_model(cfg, DEVICE), SEED)
        step = T.make_lm_train_step(model, T.make_optimizer(model))
        ak.LAUNCHES.clear()
        ssd_scan.launches = 0
        torch.cuda.reset_peak_memory_stats()
        losses, secs = [], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(*batch)))
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        launches = {**ak.LAUNCHES, **({"ssd_scan": ssd_scan.launches} if ssd_scan.launches else {})}
        ms = 1e3 * statistics.median(secs[1:])
        tokens = batch[0].numel()
        plain = ""
        if family == "transformer":  # the same steps with the plain f32 attention, for comparison
            set_attention(model, "xla")
            plain_secs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(*batch)
                torch.cuda.synchronize()
                plain_secs.append(time.perf_counter() - t0)
            plain = (f"; with the plain f32 attention {1e3 * statistics.median(plain_secs[1:]):.2f} ms/step "
                     f"(steps {TRAIN_STEPS + 2}-{TRAIN_STEPS + 3})")
        say(f"[8 steps {family}] {TRAIN_STEPS} Adam steps on one ({BATCH}, {PROMPT}) batch: losses "
            f"{[round(x, 5) for x in losses]}; {ms:.2f} ms/step (median of steps 2-{TRAIN_STEPS}, host clock around a "
            f"synchronised step), {tokens / (ms / 1e3):.1f} train tokens/s; peak memory {peak / 2**30:.2f} GiB; "
            f"launches {launches}{plain}")
        need(all(math.isfinite(x) for x in losses), f"{family}: a loss is not finite")
        need(all(b_ < a for a, b_ in zip(losses, losses[1:])), f"{family}: the loss did not fall at every step")
        L = getattr(cfg, "n_layer", 0)
        want = {"flash_relpos_lse": L * TRAIN_STEPS, "flash_bwd_dq": L * TRAIN_STEPS,
                "flash_bwd_dkv": L * TRAIN_STEPS} if family == "transformer" else {}
        need(launches == want, f"{family}: {TRAIN_STEPS} steps launched {launches}, expected {want}")
        out[family] = {"ms": ms, "tokens_per_s": tokens / (ms / 1e3), "peak_bytes": peak}
        del model, step
        torch.cuda.empty_cache()
    return out


def phase_train_cli(torch, corpus: Path, meta_path: Path, root: Path, report: dict) -> None:
    """[8 cli] `cli.train` for each family at full width (TRAIN_EPOCHS
    epochs, batch 2, block 2048) on the synthesized corpus, each run counted
    from zero: a checkpoint directory, exact launch counts (D with LSE and E
    8 times a train step and D 8 times a validation step for the
    Transformer; nothing for Mamba), then `cli.generate --ckpt
    <dir>/model.pth` from it. Each train step is timed with a synchronise
    around it."""
    from musicgen_tpu_torch.cli import generate as gen_cli
    from musicgen_tpu_torch.cli import train as train_cli
    from musicgen_tpu_torch.ops import attention_kernel as ak
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops.grammar import field_bucket, grammar_mask
    from musicgen_tpu_torch.ops.ssd_kernel import ssd_scan
    from musicgen_tpu_torch.train import trainer as T

    step_secs: list = []
    make_step = T.make_lm_train_step

    def timed_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(*args)
            torch.cuda.synchronize()
            step_secs.append(time.perf_counter() - t0)
            return loss
        return run

    mask = grammar_mask()
    T.make_lm_train_step = timed_step
    try:
        for family in ("transformer", "mamba"):
            ckpt_dir = root / f"train8_{family}"
            argv = ["--model", family, "--data", str(corpus), "--metadata", str(meta_path), "--ckpt-dir",
                    str(ckpt_dir), "--log", str(root / f"train8_{family}.json"), "--epochs", str(TRAIN_EPOCHS),
                    "--batch-size", str(BATCH), "--block-len", str(PROMPT), "--seed", str(SEED), "--device", DEVICE]
            step_secs.clear()
            ak.LAUNCHES.clear()
            dk.LAUNCHES.clear()
            ssd_scan.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state = train_cli.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            launches = {**ak.LAUNCHES, **dk.LAUNCHES, **({"ssd_scan": ssd_scan.launches} if ssd_scan.launches else {})}
            n_steps, L = state.step, getattr(state.model.cfg, "n_layer", 0)
            del state
            torch.cuda.empty_cache()
            saved = sorted(ckpt_dir.iterdir())
            need(len(saved) == 1 and sorted(p.name for p in saved[0].iterdir()) == ["model.pth", "optimizer.pth"],
                 f"{family}: checkpoint directory {[p.name for p in saved]}")
            want = {}
            if family == "transformer":
                want = {"flash_relpos_lse": L * n_steps, "flash_bwd_dq": L * n_steps, "flash_bwd_dkv": L * n_steps,
                        "flash_relpos": L * TRAIN_EPOCHS}  # one validation batch an epoch, under no_grad
            ms = 1e3 * statistics.median(step_secs[1:] or step_secs)
            say(f"[8 cli {family}] cli.train: {n_steps} steps in {TRAIN_EPOCHS} epochs in {secs:.1f} s (with "
                f"validation and the checkpoint); {ms:.2f} ms/step (median after the first), "
                f"{BATCH * PROMPT / (ms / 1e3):.1f} train tokens/s; peak memory {peak / 2**30:.2f} GiB; launches "
                f"{launches}; checkpoint {saved[0].name}")
            need(n_steps == 2 * TRAIN_EPOCHS and len(step_secs) == n_steps, f"{family}: {n_steps} train steps")
            need(launches == want, f"{family} training launched {launches}, expected {want}")
            for name in ("flash_relpos_lse", "flash_bwd_dq", "flash_bwd_dkv"):
                if family == "transformer":
                    report[name]["launches"] = want[name]

            streams = gen_cli.main(["--model", family, "--ckpt", str(saved[0] / "model.pth"), "--data", str(corpus),
                                    "--metadata", str(meta_path), "--composers", "Mozart", "--batch", str(BATCH),
                                    "--block-len", str(PROMPT), "--length", str(GEN_AFTER_TRAIN), "--output",
                                    str(root / f"gen8_{family}"), "--seed", str(SEED), "--device", DEVICE])
            st = torch.from_numpy(streams["Mozart"])
            need(tuple(st.shape) == (BATCH, PROMPT + GEN_AFTER_TRAIN), f"{family}: stream shape {tuple(st.shape)}")
            need(bool((mask[field_bucket(st[:, PROMPT - 1:-1]), st[:, PROMPT:]] > 0).all()),
                 f"{family}: a token generated from the trained checkpoint breaks the grammar")
            say(f"[8 cli {family} generate] cli.generate --ckpt {saved[0].name}/model.pth: {GEN_AFTER_TRAIN} "
                f"grammatical tokens at batch {BATCH}")
    finally:
        T.make_lm_train_step = make_step


# ---------------------------------------------------------------------------
# Phase 9: the xLSTM (kernel H, the sLSTM prefill recurrence; kernel G, the
# one-token decode step)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_slstm_scan():
    """XLSTMLM.prefill with kernel H's plain version, on the card: the
    reference the kernel's prefill is held to."""
    from musicgen_tpu_torch.models import xlstm
    from musicgen_tpu_torch.ops.slstm import slstm_sequential

    saved = xlstm.slstm_scan
    xlstm.slstm_scan = slstm_sequential
    try:
        yield
    finally:
        xlstm.slstm_scan = saved


def phase_x_slstm(torch, report: dict) -> None:
    """[9 slstm] kernel H against its plain scan at the prefill's shape
    (B, T, H, DH) = (2, 2054, 4, 256), with the scan's own noise floor."""
    from musicgen_tpu_torch.ops.slstm import powerlaw_blockdependent_bias, slstm_sequential
    from musicgen_tpu_torch.ops.slstm_kernel import slstm_scan

    b, t, h, dh = BATCH, PROMPT + 6, 4, 256
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    wx = torch.randn(b, t, 4, h, dh, device=DEVICE, generator=gen)
    r = torch.randn(4, h, dh, dh, device=DEVICE, generator=gen) / math.sqrt(dh)
    bias = torch.zeros(4, h, dh, device=DEVICE)
    bias[1] = powerlaw_blockdependent_bias(h, dh, 1, 11).to(DEVICE)
    h_k, s_k = slstm_scan(wx, r, bias)
    h_p, s_p = slstm_sequential(wx, r, bias)
    h_n, s_n = slstm_sequential(wx * (1.0 + 1e-6 * torch.randn(wx.shape, device=DEVICE, generator=gen)), r, bias)
    torch.cuda.synchronize()
    errs = [rel_err(h_k, h_p)] + [rel_err(a, b_) for a, b_ in zip(s_k, s_p)]
    floor = max([rel_err(h_n, h_p)[1]] + [rel_err(a, b_)[1] for a, b_ in zip(s_n, s_p)])
    worst_abs, worst_rel = max(e[0] for e in errs), max(e[1] for e in errs)
    tol = max(TOL_H, 2.0 * floor)
    need(all(bool(torch.isfinite(a).all()) for a in (h_k, *s_k)), "slstm_scan: non-finite output")
    ms = cuda_ms(torch, lambda: slstm_scan(wx, r, bias), iters=5, warmup=1)
    dev_ms = graph_ms(torch, lambda: slstm_scan(wx, r, bias), calls=2, replays=3)
    plain_ms = cuda_ms(torch, lambda: slstm_sequential(wx, r, bias), iters=2, warmup=1)
    # Bound: wx, R and the bias read once, h and the final state written once;
    # 2 flops per recurrent weight, step and batch row, at the f32 peak.
    cost = bound(nbytes(wx, r, bias, h_k, *s_k), 2.0 * b * t * 4 * h * dh * dh, F32_FLOPS)
    say(f"[9 slstm] (B,T,H,DH)=({b},{t},{h},{dh}): h and final state max_abs {worst_abs:.3e} rel {worst_rel:.3e} "
        f"(tol {tol:.3e} = max({TOL_H}, 2x the plain scan's drift from a 1e-6 perturbation of wx, {floor:.3e})); "
        f"kernel {ms:.4f} ms = {1e3 * ms / t:.3f} us/step (device, CUDA graph: {fmt_ms(dev_ms)}), plain scan "
        f"{plain_ms:.4f} ms, bound {cost['bound_ms']:.4f} ms ({cost['bound_by']}), library none")
    need(worst_rel <= tol, "slstm_scan (kernel H) disagrees with slstm_sequential")
    report["slstm_scan"] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms, "library_ms": None, **cost}


def phase_x_prefill(torch, corpus: Path, meta_path: Path) -> dict:
    """[9 prefill] the full-size XLSTMLM's prefill with kernel H against the
    plain scan on the card; returns the model, the prompt and the prefill
    states."""
    import numpy as np

    from musicgen_tpu_torch.config import XLSTMConfig
    from musicgen_tpu_torch.data.dataset import TokenDataset
    from musicgen_tpu_torch.models.xlstm import empty_model, init_weights_
    from musicgen_tpu_torch.ops.slstm_kernel import slstm_scan

    model = init_weights_(empty_model(XLSTMConfig(), DEVICE), SEED).eval()
    n_params = sum(p.numel() for p in model.parameters())
    ds = TokenDataset.from_directory(corpus / "Mozart", meta_path, block_len=PROMPT, seed=SEED)
    items = [ds[i] for i in range(BATCH)]
    prompt = torch.from_numpy(np.stack([s for s, _, _ in items]).astype(np.int64)).to(DEVICE)
    meta = torch.from_numpy(np.stack([m for _, _, m in items]).astype(np.int64)).to(DEVICE)
    teacher = torch.from_numpy(np.stack([ds[i][0][:TEACHER_STEPS] for i in range(BATCH)]).astype(np.int64)).to(DEVICE)
    slstm_scan.launches = 0
    logits_k, states = model.prefill(prompt, meta)
    torch.cuda.synchronize()
    launches = slstm_scan.launches
    ms = cuda_ms(torch, lambda: model.prefill(prompt, meta), iters=3, warmup=1)
    with plain_slstm_scan():
        logits_p, _ = model.prefill(prompt, meta)
        plain_ms = cuda_ms(torch, lambda: model.prefill(prompt, meta), iters=2, warmup=1)
    err, rel_e = rel_err(logits_k[:, -1], logits_p[:, -1])
    need(bool(torch.isfinite(logits_k).all()), "xlstm prefill logits are not finite")
    say(f"[9 prefill] XLSTMLM {n_params} parameters, (B, T) = ({BATCH}, {PROMPT}+6): {launches} kernel H launches; "
        f"last logits vs the plain scan max_abs {err:.3e} rel {rel_e:.3e} (tol {TOL_X_PREFILL}); prefill with "
        f"kernel H {ms:.3f} ms, with the plain scan {plain_ms:.3f} ms")
    need(launches == len(model.cfg.slstm_at), f"prefill launched kernel H {launches} times")
    need(rel_e <= TOL_X_PREFILL, "prefill with kernel H disagrees with the plain scan")
    return {"model": model, "prompt": prompt, "meta": meta, "teacher": teacher, "states": states,
            "prefill_ms": ms, "plain_prefill_ms": plain_ms}


def phase_x_decode(torch, xctx: dict, report: dict) -> dict:
    """[9 xdecode] each kernel G launch against its plain version on the same
    inputs (the first mLSTM and sLSTM block): every launch in bf16, the
    GEMVs in W8A16, the matrix memory stored in bf16. Then TEACHER_STEPS
    teacher-forced steps per format from the prefill state: each step's
    kernel chain against the plain chain from the same state (and from that
    state perturbed by 1e-6, the noise floor) and against the f32
    XLSTMLM.step; [9 drift] the free-running plain chains. Returns the packs
    by format."""
    import torch.nn.functional as F

    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops import xdecode_kernel as xk
    from musicgen_tpu_torch.ops.grammar import field_bucket
    from musicgen_tpu_torch.sample.sampler import init_penalty_state, push_token

    model, prompt = xctx["model"], xctx["prompt"]
    dims = xk.XDims.create(model.cfg, BATCH)
    di, d, v = dims.m_inner, dims.d_model, dims.vocab_size
    packs = {"bf16": xk.build_xlstm_decode_params(model, BATCH, "bf16"),
             "int8w": xk.build_xlstm_decode_params(model, BATCH, "int8w")}
    packs["bf16-sb16"] = packs["bf16"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    x = F.embedding(prompt[:, -1], packs["bf16"]["embed"]) + 0.1 * torch.randn(BATCH, d, device=DEVICE, generator=gen)
    for quant, q in XQUANTS.items():
        wp = packs[quant]
        sdt = torch.bfloat16 if quant.endswith("-sb16") else torch.float32
        carry0 = xk.stack_xlstm_states(xctx["states"], dims, sdt)
        sfx = "" if q == "none" else "_w8a16"
        gtol = TOL_BF16 if q == "none" else TOL_W8A16

        def sc(name):
            return wp[name + "_s"][0] if name + "_s" in wp else None

        conv_m, s_m, n_m, m_m, conv_s, hcnm_s = (t[0] for t in carry0)
        args = {
            "xm_up": (x, wp["m_ln"][0], wp["m_w_up"][0], dims, sc("m_w_up"), q),
        }
        up = xk.up_ln_plain(*args["xm_up"])
        args["xm_prep"] = (up, wp["m_conv_w"][0], wp["m_conv_b"][0], conv_m, wp["m_qkv_w"][0], dims)
        buf = xk.xm_prep_plain(*(a.clone() if a is conv_m else a for a in args["xm_prep"]))
        args["xm_gates"] = (buf, wp["m_w_gate"][0], wp["m_gate_b"][0], n_m, m_m, dims)
        g = xk.xm_gates_plain(*(a.clone() if a is n_m or a is m_m else a for a in args["xm_gates"]))
        args["xm_memory"] = (buf, g, s_m, dims)
        h = xk.xm_memory_plain(buf, g, s_m.clone(), dims)
        args["xm_out"] = (h, buf, up, wp["m_outnorm"][0], wp["m_skip"][0], dims)
        y = xk.xm_out_plain(*args["xm_out"])
        args["xm_down"] = (y, wp["m_w_down"][0], x, dims, sc("m_w_down"), q)
        args["xs_prep"] = (x, wp["s_ln"][0], wp["s_conv_w"][0], wp["s_conv_b"][0], conv_s, dims)
        xs = xk.xs_prep_plain(*(a.clone() if a is conv_s else a for a in args["xs_prep"]))
        args["xs_in"] = (xs[0], wp["s_w_if"][0], dims, sc("s_w_if"), q)
        wif = xk.gemv_plain(*args["xs_in"])
        wzo = xk.gemv_plain(xs[1], wp["s_w_zo"][0], dims, sc("s_w_zo"), q)
        args["xs_cell"] = (wif, wzo, wp["s_r_w"][0], wp["s_bias"][0], wp["s_gn"][0], hcnm_s, x, dims)
        c = xk.xs_cell_plain(*(a.clone() if a is hcnm_s or a is x else a for a in args["xs_cell"]))
        args["xs_ffn_up"] = (c, wp["s_ln_ffn"][0], wp["s_ffn_up"][0], wp["s_ffn_up_b"][0], dims, sc("s_ffn_up"), q)
        u = xk.ffn_up_plain(*args["xs_ffn_up"])
        args["xs_ffn_down"] = (u, wp["s_ffn_down"][0], wp["s_ffn_down_b"][0], c, dims, sc("s_ffn_down"), q)
        kernels = {"xm_up": xk.up_ln, "xm_prep": xk.xm_prep, "xm_gates": xk.xm_gates, "xm_memory": xk.xm_memory,
                   "xm_out": xk.xm_out, "xm_down": xk.down_res, "xs_prep": xk.xs_prep, "xs_in": xk.gemv,
                   "xs_cell": xk.xs_cell, "xs_ffn_up": xk.ffn_up, "xs_ffn_down": xk.ffn_down}
        plains = {"xm_up": xk.up_ln_plain, "xm_prep": xk.xm_prep_plain, "xm_gates": xk.xm_gates_plain,
                  "xm_memory": xk.xm_memory_plain, "xm_out": xk.xm_out_plain, "xm_down": xk.down_res_plain,
                  "xs_prep": xk.xs_prep_plain, "xs_in": xk.gemv_plain, "xs_cell": xk.xs_cell_plain,
                  "xs_ffn_up": xk.ffn_up_plain, "xs_ffn_down": xk.ffn_down_plain}
        # Arguments a launch advances in place: each run gets its own copy.
        inplace = {"xm_prep": (3,), "xm_gates": (3, 4), "xm_memory": (2,), "xm_down": (2,), "xs_prep": (4,),
                   "xs_cell": (5, 6), "xs_ffn_down": (3,)}
        gemvs = {"xm_up": (x, "m_w_up", nbytes(wp["m_ln"][0])),
                 "xm_down": (y, "m_w_down", 4 * BATCH * d),
                 "xs_in": (xs[0], "s_w_if", 0),
                 "xs_ffn_up": (c, "s_ffn_up", nbytes(wp["s_ln_ffn"][0], wp["s_ffn_up_b"][0])),
                 "xs_ffn_down": (u, "s_ffn_down", nbytes(wp["s_ffn_down_b"][0]) + 4 * BATCH * d)}
        if quant == "bf16":
            names = list(kernels)
        elif quant == "int8w":
            names = list(gemvs)
        else:
            names = ["xm_memory"]

        def fresh(name):
            a = args[name]
            return tuple(t.clone() if i in inplace.get(name, ()) else t for i, t in enumerate(a))

        for name in names:
            a_k, a_p = fresh(name), fresh(name)
            out_k, out_p = kernels[name](*a_k), plains[name](*a_p)
            torch.cuda.synchronize()
            outs = [out_k] + [a_k[i] for i in inplace.get(name, ())]
            refs = [out_p] + [a_p[i] for i in inplace.get(name, ())]
            errs = [rel_err(o.float(), r_.float()) for o, r_ in zip(outs, refs)]
            worst_abs, worst_rel = max(e[0] for e in errs), max(e[1] for e in errs)
            tol = gtol if name in gemvs else TOL_F32
            a_t, a_q = fresh(name), fresh(name)
            ms = cuda_ms(torch, lambda: kernels[name](*a_t))
            dev_ms = graph_ms(torch, lambda: kernels[name](*a_t))
            plain_ms = cuda_ms(torch, lambda: plains[name](*a_q), iters=10, warmup=2)
            lib_ms = None
            if name in gemvs:
                xin, wname, extra = gemvs[name]
                cost = gemv_cost(BATCH, wp[wname][0], sc(wname), extra)
                lib_ms = linear_ms(torch, xin, bf16_weights(torch, wp[wname][0], sc(wname)))
            elif name == "xm_prep":
                cost = bound(nbytes(up) // 2 + 2 * nbytes(conv_m) + nbytes(*args[name][1:3], args[name][4], out_k),
                             2.0 * BATCH * di * 16, F32_FLOPS)
            elif name == "xm_gates":
                cost = bound(nbytes(wp["m_w_gate"][0], wp["m_gate_b"][0], out_k) + 4 * BATCH * 3 * di
                             + 2 * nbytes(n_m, m_m), 2.0 * BATCH * (2 * dims.heads * 3 * di + 2 * di), F32_FLOPS)
            elif name == "xm_memory":
                cost = bound(2 * nbytes(s_m) + 4 * BATCH * 3 * di + nbytes(g, out_k), 5.0 * s_m.numel(), F32_FLOPS)
            elif name == "xm_out":
                cost = bound(nbytes(h, out_k, wp["m_outnorm"][0], wp["m_skip"][0]) + 8 * BATCH * di,
                             12.0 * BATCH * di, F32_FLOPS)
            elif name == "xs_prep":
                cost = bound(nbytes(x, out_k, *args[name][1:4]) + 2 * nbytes(conv_s), 16.0 * BATCH * d, F32_FLOPS)
            else:  # xs_cell
                cost = bound(nbytes(wif, wzo, *args[name][2:5]) + 2 * nbytes(hcnm_s, x),
                             2.0 * BATCH * 4 * d * dims.s_dh, F32_FLOPS)
            key = name + ("_sb16" if quant.endswith("-sb16") else sfx)
            say(f"[9 xdecode {key}] max_abs {worst_abs:.3e} rel {worst_rel:.3e} (tol rel {tol}); kernel {ms:.4f} ms "
                f"(device, CUDA graph: {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, bound {cost['bound_ms']:.4f} ms "
                f"({cost['bound_by']}), library {lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms")
            need(all(bool(torch.isfinite(o.float()).all()) for o in outs), f"{key}: non-finite output")
            need(worst_rel <= tol, f"{key} disagrees with its plain version")
            report[key] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, **cost}

        # Teacher-forced steps from the prefill state. Each step runs the
        # plain chain from the kernel chain's state, once more from that state
        # perturbed by 1e-6 (the noise floor), and the f32 XLSTMLM.step.
        noise = torch.Generator(device=DEVICE).manual_seed(SEED)

        def perturbed(cr):
            cr = clone(cr)
            for i in (2, 5):  # the f32 normalizers and the sLSTM states
                cr[i].mul_(1.0 + 1e-6 * torch.randn(cr[i].shape, device=DEVICE, generator=noise))
            return cr

        pen = init_penalty_state(prompt, max(PROMPT, 2048))
        ck, free_p, free_q = clone(carry0), clone(carry0), perturbed(carry0)
        worst_plain = worst_noise = worst_state = worst_val = worst_f32 = 0.0
        idx_checked = idx_equal = 0
        for step in range(TEACHER_STEPS):
            tok = xctx["teacher"][:, step]
            pen = push_token(pen, tok)
            bucket = field_bucket(tok)
            cp, cn = clone(ck), perturbed(ck)
            lf, _ = model.step(tok, xk.unstack_xlstm_states(cp, dims))
            lk = xk.xlstm_decode_logits(wp, tok, ck, dims, quant=q)
            lp = xk.xlstm_decode_logits(wp, tok, cp, dims, ops=xk.PLAIN_OPS, quant=q)
            ln = xk.xlstm_decode_logits(wp, tok, cn, dims, ops=xk.PLAIN_OPS, quant=q)
            worst_plain = max(worst_plain, rel_err(lk[:, :v], lp[:, :v])[1])
            worst_noise = max(worst_noise, rel_err(ln[:, :v], lp[:, :v])[1])
            worst_state = max(worst_state, *(rel_err(a.float(), b_.float())[1] for a, b_ in zip(ck, cp)))
            worst_f32 = max(worst_f32, rel_err(lk[:, :v], lf)[1])
            vk, ik = dk.sample_tail(lk, wp["gram"], pen.hist, bucket, dims)
            vp, ip = dk.sample_tail_plain(lp, wp["gram"], pen.hist, bucket, dims)
            worst_val = max(worst_val, rel_err(vk, vp)[1])
            checked, equal = top3_agreement(torch, vk, ik, vp, ip)
            idx_checked, idx_equal = idx_checked + checked, idx_equal + equal
            free_k = xk.xlstm_decode_logits(wp, tok, free_p, dims, ops=xk.PLAIN_OPS, quant=q)
            free_n = xk.xlstm_decode_logits(wp, tok, free_q, dims, ops=xk.PLAIN_OPS, quant=q)
        torch.cuda.synchronize()
        drift_kernel, drift_noise = rel_err(lk[:, :v], free_k[:, :v])[1], rel_err(free_n[:, :v], free_k[:, :v])[1]
        tol = max(TOL_T_STEP, 2.0 * worst_noise)
        step_ms = cuda_ms(torch, lambda: xk.fused_xlstm_sample_step(wp, tok, ck, pen.hist, bucket, dims, q), iters=20)
        step_dev_ms = graph_ms(torch, lambda: xk.fused_xlstm_sample_step(wp, tok, ck, pen.hist, bucket, dims, q),
                               calls=2)
        plain_step_ms = cuda_ms(torch, lambda: xk.fused_xlstm_sample_step(wp, tok, cp, pen.hist, bucket, dims, q,
                                                                          ops=xk.PLAIN_OPS), iters=5, warmup=1)
        say(f"[9 xdecode steps {quant}] {TEACHER_STEPS} teacher-forced steps, each from a shared state: vs the plain "
            f"chain logits rel {worst_plain:.3e}, states rel {worst_state:.3e}, top-3 values rel {worst_val:.3e} "
            f"(tol {tol:.3e} = max({TOL_T_STEP}, 2x the plain chain's response to a 1e-6 perturbation, "
            f"{worst_noise:.3e})); top-3 indices equal at {idx_equal}/{idx_checked} separated candidates; vs the f32 "
            f"XLSTMLM.step logits rel {worst_f32:.3e} (tol {TOL_X_F32[quant]}); step with the kernels {step_ms:.4f} "
            f"ms (device, CUDA graph of the step's {dims.launches_per_token()} launches: {fmt_ms(step_dev_ms)}), "
            f"plain chain {plain_step_ms:.4f} ms")
        say(f"[9 drift {quant}] after {TEACHER_STEPS} free-running steps from the prefill state: kernel chain vs "
            f"plain chain logits rel {drift_kernel:.3e}; plain chain vs itself from a state perturbed by 1e-6: "
            f"{drift_noise:.3e}")
        need(max(worst_plain, worst_val, worst_state) <= tol, f"{quant} kernel G steps disagree with the plain chain")
        need(idx_equal == idx_checked, f"{quant} kernel G steps picked other top-3 candidates")
        need(worst_f32 <= TOL_X_F32[quant], f"{quant} kernel G steps disagree with XLSTMLM.step")
    return packs


def x_launches(dims, length: int, n: int, quant: str) -> dict:
    """Kernel G's launches (and kernel B's head and tail) in `n` generations
    of `length` tokens with the sampler tail, by --fused-decode mode."""
    if quant == "off":
        return {}
    sfx = "_w8a16" if quant.startswith("int8") else ""
    mem = "xm_memory_sb16" if quant.endswith("sb16") else "xm_memory"
    m, s_, k = dims.n_mlstm, dims.n_slstm, length * n
    return {f"xm_up{sfx}": m * k, "xm_prep": m * k, "xm_gates": m * k, mem: m * k, "xm_out": m * k,
            f"xm_down{sfx}": m * k, "xs_prep": s_ * k, f"xs_in{sfx}": 2 * s_ * k, "xs_cell": s_ * k,
            f"xs_ffn_up{sfx}": s_ * k, f"xs_ffn_down{sfx}": s_ * k, f"lm_head_ln{sfx}": k, "sample_tail": k}


def phase_x_cli(torch, xctx: dict, corpus: Path, meta_path: Path, root: Path, report: dict) -> None:
    """[9 cli] `--model xlstm` through the CLI: --fused-decode auto, greedy
    (two bands) and stochastic (one band), LENGTH tokens; int8w, sb16 and
    int8w-sb16 for X_CLI_SHORT tokens; on, int8 and off (the plain step) for
    X_CLI_TINY: every new token grammatical, the .mid files re-extract, and
    each run, counted from zero, launches kernel H 4 times a prefill and
    kernel G's launches a token (none with off)."""
    from musicgen_tpu_torch.cli import generate as cli
    from musicgen_tpu_torch.midi import extract_midi
    from musicgen_tpu_torch.ops import attention_kernel as ak
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops import xdecode_kernel as xk
    from musicgen_tpu_torch.ops.grammar import field_bucket, grammar_mask
    from musicgen_tpu_torch.ops.slstm_kernel import slstm_scan
    from musicgen_tpu_torch.ops.ssd_kernel import ssd_scan

    model = xctx["model"]
    ckpt = root / "xlstm_random.pth"
    torch.save(model.state_dict(), ckpt)
    dims = xk.XDims.create(model.cfg, BATCH)
    mask = grammar_mask()
    runs = [("auto", True, ["Mozart", "Bach"], LENGTH), ("auto", False, ["Mozart"], LENGTH),
            ("int8w", False, ["Bach"], X_CLI_SHORT), ("sb16", False, ["Bach"], X_CLI_SHORT),
            ("int8w-sb16", True, ["Mozart"], X_CLI_SHORT), ("on", False, ["Bach"], X_CLI_TINY),
            ("int8", True, ["Bach"], X_CLI_TINY), ("off", True, ["Mozart"], X_CLI_TINY)]
    totals: dict = {}
    for i, (mode, greedy, bands, length) in enumerate(runs):
        out = root / f"gen9_{i}"
        argv = ["--model", "xlstm", "--ckpt", str(ckpt), "--data", str(corpus), "--metadata", str(meta_path),
                "--composers", ", ".join(bands), "--batch", str(BATCH), "--block-len", str(PROMPT),
                "--length", str(length), "--output", str(out), "--seed", str(SEED + i),
                "--fused-decode", mode] + (["--greedy"] if greedy else [])
        n = len(bands)
        want = x_launches(dims, length, n, mode)
        ssd_scan.launches = slstm_scan.launches = 0
        ak.LAUNCHES.clear()
        dk.LAUNCHES.clear()
        t0 = time.perf_counter()
        streams = cli.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, h_launches = dict(dk.LAUNCHES), slstm_scan.launches
        need(sorted(streams) == sorted(bands), f"CLI generated for {sorted(streams)}")
        for band, st in streams.items():
            need(st.shape == (BATCH, PROMPT + length), f"{band}: stream shape {st.shape}")
            st = torch.from_numpy(st)
            need(bool((mask[field_bucket(st[:, PROMPT - 1:-1]), st[:, PROMPT:]] > 0).all()),
                 f"--model xlstm --fused-decode {mode}, {band}: a generated token breaks the grammar")
        mids = sorted(out.rglob("generated_*_xlstm_*.mid"))
        need(len(mids) == n * BATCH, f"expected {n * BATCH} .mid files in {out}")
        for mid in mids:
            need(len(extract_midi(str(mid))) > 0, f"{mid.name} re-extracts with no notes")
        per_token = sum(launches.values()) / (length * n)
        say(f"[9 cli {mode}{' greedy' if greedy else ''}] {n} band(s) x {length} tokens at batch {BATCH} after a "
            f"{PROMPT}-token prompt in {secs:.1f} s; grammatical; .mid files re-extract; kernel H {h_launches} "
            f"launches ({dims.n_slstm} a prefill); kernel G {per_token:g} launches a token: {launches}")
        need(launches == want, f"--model xlstm --fused-decode {mode}: launches {launches}, expected {want}")
        need(h_launches == dims.n_slstm * n and ssd_scan.launches == 0 and not ak.LAUNCHES,
             f"--fused-decode {mode}: kernel H launched {h_launches} times")
        for name, cnt in {**want, "slstm_scan": h_launches}.items():
            if name in report and not name.startswith(("lm_head_ln", "sample_tail")):
                totals[name] = totals.get(name, 0) + cnt
    for name, cnt in totals.items():
        report[name]["launches"] = cnt


def phase_x_loop(torch, xctx: dict, packs: dict) -> None:
    """[9 loop] tok/s/seq of the kernel G chain with the sampler tail in each
    format (X_LOOP_TOKENS stochastic tokens from one prefill) beside the
    plain XLSTMLM.step's, in the same call; the device time of one step from
    a CUDA graph; the bytes a token moves (the pack's weights and scales
    read once, the recurrent states read and written) and their share of the
    HBM roofline."""
    from musicgen_tpu_torch.ops import xdecode_kernel as xk
    from musicgen_tpu_torch.ops.grammar import field_bucket
    from musicgen_tpu_torch.sample import sampler

    model, prompt, meta = xctx["model"], xctx["prompt"], xctx["meta"]
    dims = xk.XDims.create(model.cfg, BATCH)
    cfg = sampler.SamplerConfig(num_tokens=X_LOOP_TOKENS, ring_size=max(PROMPT, 2048))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for quant, q in XQUANTS.items():
        wp = packs[quant]
        prefill, _ = sampler.make_sampler(model, "xlstm", wp, quant)
        logits, carry = prefill(prompt, meta)
        weights = nbytes(*(t for k, t in wp.items() if k not in ("embed", "gram")))
        state = 2 * nbytes(*carry)
        per_token = weights + state

        def step(pack, token, st, hist, bucket, stream_idx):
            return xk.fused_xlstm_sample_step(pack, token, st, hist, bucket, dims, q)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = sampler.sample_tokens_fused_tail(wp, logits, carry, prompt, cfg, gen, dims, fused_step=step)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        tok = toks[:, -1]
        pen = sampler.init_penalty_state(torch.cat([prompt, toks], dim=1), max(PROMPT, 2048))
        bucket = field_bucket(tok)  # outside the capture: it copies its boundaries to the card
        dev_ms = graph_ms(torch, lambda: step(wp, tok, carry, pen.hist, bucket, 0), calls=2)
        bound_ms = 1e3 * per_token / HBM_BYTES_PER_S
        share = bound_ms / (1e3 * secs / X_LOOP_TOKENS)
        dev_share = "not measured" if dev_ms is None else f"{100 * bound_ms / dev_ms:.2f}%"
        say(f"[9 loop {quant}] kernel G chain: {X_LOOP_TOKENS} tokens in {secs:.3f} s = "
            f"{X_LOOP_TOKENS / secs:.1f} tok/s/seq ({1e3 * secs / X_LOOP_TOKENS:.4f} ms/token, {100 * share:.2f}% of "
            f"the 3.35 TB/s roofline); one step in a CUDA graph {fmt_ms(dev_ms)} ({dev_share} of the roofline); "
            f"{per_token} B/token = {weights} B of weights + {state} B of recurrent state read and written "
            f"({bound_ms:.4f} ms/token bound); batch {BATCH}; prefill with kernel H {xctx['prefill_ms']:.3f} ms, "
            f"with the plain scan {xctx['plain_prefill_ms']:.3f} ms")
    prefill, step = sampler.make_sampler(model, "xlstm")
    logits, states = prefill(prompt, meta)
    plain_cfg = sampler.SamplerConfig(num_tokens=X_PLAIN_LOOP_TOKENS, ring_size=max(PROMPT, 2048))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler.sample_tokens(step, logits, states, prompt, plain_cfg, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    say(f"[9 loop plain] XLSTMLM.step (f32): {X_PLAIN_LOOP_TOKENS} tokens in {secs:.3f} s = "
        f"{X_PLAIN_LOOP_TOKENS / secs:.1f} tok/s/seq ({1e3 * secs / X_PLAIN_LOOP_TOKENS:.3f} ms/token)")


def phase_xlstm(torch, corpus: Path, meta_path: Path, root: Path, report: dict) -> None:
    phase_x_slstm(torch, report)
    xctx = phase_x_prefill(torch, corpus, meta_path)
    packs = phase_x_decode(torch, xctx, report)
    phase_x_cli(torch, xctx, corpus, meta_path, root, report)
    phase_x_loop(torch, xctx, packs)


# ---------------------------------------------------------------------------
# Phase 10: the two Hopper probes (kernel I, the bf16 weight-streaming
# product; kernel J, the ablated Mamba decode step)
# ---------------------------------------------------------------------------


def kernel_check(torch, tag: str, name: str, outs, refs, tol: float, kernel, plain, cost: dict, report: dict,
                 library=None, note: str = "") -> None:
    """A kernel against its plain version on the same inputs, with its
    times (host-paced, from a CUDA graph), its bound and the library call's
    time; the numbers go into report[name]."""
    errs = [rel_err(a, b) for a, b in zip(outs, refs)]
    worst_abs, worst_rel = max(e[0] for e in errs), max(e[1] for e in errs)
    ms, dev_ms, plain_ms = cuda_ms(torch, kernel), graph_ms(torch, kernel), cuda_ms(torch, plain)
    lib_ms = None if library is None else cuda_ms(torch, library)
    say(f"[{tag} {name}] max_abs {worst_abs:.3e} rel {worst_rel:.3e} (tol rel {tol}); kernel {ms:.4f} ms (device, "
        f"CUDA graph{note}: {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, bound {cost['bound_ms']:.4f} ms "
        f"({cost['bound_by']}), library {fmt_ms(lib_ms)}")
    need(all(bool(torch.isfinite(a).all()) for a in outs), f"{name}: non-finite output")
    need(worst_rel <= tol, f"{name} disagrees with its plain version")
    report[name] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, **cost}


def phase_probe_mm(torch, report: dict) -> None:
    """[10 probe_mm] kernel I against its plain version at the probe's shape
    (one W, whose 8.9 MB then sit in L2 when timed alone), one chain step's
    exact launches; [10 hw] the entry point hw_characterize.run at the JAX
    script's size: the ten-product chain through kernel I, the port's decode
    GEMV (mg_x_gemv), the f32 matmul and the bf16 library call, host-paced
    and from a CUDA graph, in GB/s of weights."""
    from musicgen_tpu_torch.experiments import hw_characterize as hw
    from musicgen_tpu_torch.ops import probe_kernel as pk

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    w = torch.from_numpy(hw.make_weights(1, hw.K, hw.N, SEED)[0]).to(DEVICE).t().contiguous().to(torch.bfloat16)
    x = torch.randn(hw.M, hw.K, device=DEVICE, generator=gen)
    y, yp = pk.probe_mm(x, w), pk.probe_mm_plain(x, w)
    torch.cuda.synchronize()
    cost = bound(nbytes(w, x, y), 2.0 * hw.M * hw.K * hw.N, BF16_FLOPS)
    kernel_check(torch, "10", "probe_mm", [y], [yp], TOL_F32, lambda: pk.probe_mm(x, w),
                 lambda: pk.probe_mm_plain(x, w), cost, report,
                 library=lambda: torch.nn.functional.linear(x.to(torch.bfloat16), w), note=", W in L2")
    ws = torch.from_numpy(hw.make_weights(hw.N_MATS, hw.K, hw.N, SEED)).to(DEVICE).to(torch.bfloat16)
    ws = ws.transpose(1, 2).contiguous()
    pk.LAUNCHES.clear()
    hw.chain(torch.ones(hw.M, hw.K, device=DEVICE), ws, pk.probe_mm)
    torch.cuda.synchronize()
    need(pk.LAUNCHES["probe_mm"] == hw.N_MATS, f"one chain step launched kernel I {pk.LAUNCHES['probe_mm']} times")
    del ws

    pk.LAUNCHES.clear()
    out = hw.run(DEVICE)
    report["probe_mm"]["launches"] = pk.LAUNCHES["probe_mm"]
    need(out["chain_max_abs_err"] <= TOL_F32, "kernel I's chain disagrees with its plain version's")
    need(all(out[c]["graph_us_step"] is not None for c in ("probe_mm", "decode_gemv")), "no device time of a chain")
    r, g = out["probe_mm"], out["decode_gemv"]
    say(f"[10 hw] {out['n_mats']} products a step, {out['bytes_step']:,} B of bf16 weights (bound "
        f"{out['bound_us_step']:.2f} us): kernel I {r['graph_us_step']:.2f} us a step in a CUDA graph = "
        f"{r['gbs']:.1f} GB/s, the decode GEMV (mg_x_gemv) {g['graph_us_step']:.2f} us = {g['gbs']:.1f} GB/s, "
        f"f32 matmul {out['f32_matmul']['gbs']:.1f} GB/s of 2x the bytes, bf16 library "
        f"{out['library_bf16']['gbs']:.1f} GB/s; one launch on one W (L2), us at M = 1 / 2 / {out['m']}: kernel I "
        f"{' / '.join(f'{t:.2f}' for t in r['launch_l2_us'].values())}, decode GEMV "
        f"{' / '.join(f'{t:.2f}' for t in g['launch_l2_us'].values())}; kernel I launches {pk.LAUNCHES['probe_mm']}")


def phase_ablate(torch, report: dict) -> None:
    """[10 <kernel>] each new kernel of J against its plain version on the
    first layer's inputs at full width, V_dma's weight checksum against the
    host's XOR of the same words; [10 variant <mode>] one step of each
    variant against its chain of plain versions from the prefill state, with
    exact launch counts; [10 ablate] the entry point kernel_ablate.run at the
    JAX script's size (500 steps a variant, host-paced and from a CUDA graph)
    and the split of kernel B's device step."""
    import numpy as np

    from musicgen_tpu_torch.config import MambaConfig
    from musicgen_tpu_torch.experiments import kernel_ablate as ka
    from musicgen_tpu_torch.ops import ablate_kernel as ak
    from musicgen_tpu_torch.ops import decode_kernel as dk

    ctx = ka.setup(torch.device(DEVICE), MambaConfig(), BATCH, ka.PROMPT, SEED)
    dp, dims, token, carry0 = ctx["dp"], ctx["dims"], ctx["token"], ctx["carry"]
    b, di = BATCH, dims.d_inner
    x = torch.nn.functional.embedding(token, dp["embed"])
    w_in, w_out = dp["w_in"][0], dp["w_out"][0]
    conv0, ssm0 = carry0[0][0], carry0[1][0]

    sink = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    cs_k, ss_k, cs_p, ss_p = conv0.clone(), ssm0.clone(), conv0.clone(), ssm0.clone()
    xs_k = ak.stream_layer(x, w_in, w_out, cs_k, ss_k, sink=sink)
    xs_p = ak.stream_layer_plain(x, w_in, w_out, cs_p, ss_p)
    torch.cuda.synchronize()
    words = np.concatenate([t.view(torch.int32).cpu().numpy().ravel() for t in (w_in, w_out)])
    want = int(np.bitwise_xor.reduce(words))
    say(f"[10 ablate_stream] XOR of the {words.size * 4:,} B of weights the kernel read "
        f"{int(sink) & 0xffffffff:#010x}, on the host {want & 0xffffffff:#010x}")
    need(int(sink) == want, "ablate_stream did not read every weight byte")
    need(torch.equal(cs_k, conv0) and torch.equal(ss_k, ssm0), "ablate_stream changed the states it passes through")
    kernel_check(torch, "10", "ablate_stream", [xs_k, cs_k, ss_k], [xs_p, cs_p, ss_p], TOL_F32,
                 lambda: ak.stream_layer(x, w_in, w_out, cs_k, ss_k),
                 lambda: ak.stream_layer_plain(x, w_in, w_out, cs_p, ss_p),
                 bound(nbytes(w_in, w_out, x, xs_k) + 2 * nbytes(cs_k, ss_k), 0.0, F32_FLOPS), report)

    z_k, r_k = ak.gemv(x, w_in, di)
    z_p, r_p = ak.gemv_plain(x, w_in, di)
    torch.cuda.synchronize()
    kernel_check(torch, "10", "ablate_gemv", [z_k, r_k], [z_p, r_p], TOL_F32, lambda: ak.gemv(x, w_in, di),
                 lambda: ak.gemv_plain(x, w_in, di), gemv_cost(b, w_in), report,
                 library=lambda: torch.nn.functional.linear(x.to(torch.bfloat16), w_in), note=", W in L2")
    head_k, head_p = ak.gemv(x, dp["lm_w"]), ak.gemv_plain(x, dp["lm_w"])
    torch.cuda.synchronize()
    err = rel_err(head_k, head_p)[1]
    say(f"[10 ablate_gemv head] (B, {dims.padded_vocab}) rel {err:.3e} (tol rel {TOL_F32})")
    need(err <= TOL_F32, "ablate_gemv (the head) disagrees with its plain version")

    zx = dk.in_proj_conv_plain(x, w_in, dp["conv_w"][0], dp["conv_b"][0], dp["dt_bias"][0], conv0.clone(), dims)
    ss_k, ss_p = ssm0.clone(), ssm0.clone()
    g_k, g_p = ak.nossd(zx, dp["d_h"][0], ss_k, dims), ak.nossd_plain(zx, dp["d_h"][0], ss_p, dims)
    torch.cuda.synchronize()
    kernel_check(torch, "10", "ablate_nossd", [g_k, ss_k], [g_p, ss_p], TOL_F32,
                 lambda: ak.nossd(zx, dp["d_h"][0], ss_k, dims), lambda: ak.nossd_plain(zx, dp["d_h"][0], ss_p, dims),
                 bound(nbytes(zx, g_k) + 2 * nbytes(ss_k), 6.0 * g_k.numel() + ss_k.numel(), F32_FLOPS), report)

    for mode in ka.MODES:
        ck, cp = clone(carry0), clone(carry0)
        before = ka.counts()
        lk = dk.decode_logits(dp, token, ck, dims, ops=ak.VARIANTS[mode])
        torch.cuda.synchronize()
        launches = dict(ka.counts() - before)
        lp = dk.decode_logits(dp, token, cp, dims, ops=ak.PLAIN_VARIANTS[mode])
        e_l, e_s = rel_err(lk, lp)[1], max(rel_err(ck[0], cp[0])[1], rel_err(ck[1], cp[1])[1])
        say(f"[10 variant {mode}] one step from the prefill state against its plain chain: logits rel {e_l:.3e}, "
            f"states rel {e_s:.3e} (tol {TOL_STEPS}); {sum(launches.values())} launches {launches}")
        need(bool(torch.isfinite(lk).all()), f"V_{mode}: non-finite logits")
        need(e_l <= TOL_STEPS and e_s <= TOL_STEPS, f"V_{mode} disagrees with its plain chain")
        need(launches == ak.step_launches(mode, dims.n_layers), f"V_{mode}: launches {launches}")

    ak.LAUNCHES.clear()
    dk.LAUNCHES.clear()
    out = ka.run(DEVICE)
    for name in ("ablate_stream", "ablate_gemv", "ablate_nossd"):
        report[name]["launches"] = ak.LAUNCHES[name]
    s = out["split"]
    need(s is not None, "no device time of the variants")
    say(f"[10 ablate] device step (CUDA graph): V_dma {out['dma']['graph_us_step']:.2f}, V_mm "
        f"{out['mm']['graph_us_step']:.2f}, V_nossd {out['nossd']['graph_us_step']:.2f}, V_full "
        f"{out['full']['graph_us_step']:.2f} us (bound {out['full']['bound_us_step']:.2f} us); split: streaming "
        f"{s['streaming']:.2f}, products {s['products']:.2f}, epilogues and conv {s['epilogues_conv']:.2f}, SSD "
        f"{s['ssd']:.2f} us; launches {dict(ak.LAUNCHES)}")


def phase_probes(torch, report: dict) -> None:
    phase_probe_mm(torch, report)
    torch.cuda.empty_cache()
    phase_ablate(torch, report)


def main() -> int:
    t_start = time.perf_counter()
    only = sys.argv[2] if sys.argv[1:2] == ["--only"] and len(sys.argv) == 3 else None
    if sys.argv[1:] and only not in ("9", "10"):
        print("usage: python3 chip_smoke.py [--only 9|10]", file=sys.stderr)
        return 2
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
    if only == "9":
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            phase_xlstm(torch, *synth_corpus(root), root, report)
        return finish(torch, card, report, X_KERNELS, t_start)
    if only == "10":
        phase_probes(torch, report)
        return finish(torch, card, report, PROBE_KERNELS, t_start)
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
        del model, ctx, packs
        torch.cuda.empty_cache()

        phase_t_flash(torch, report)
        tctx = phase_t_prefill(torch, corpus, meta_path)
        tpacks = phase_t_decode(torch, tctx, report)
        phase_t_wrap(torch, corpus)
        phase_t_cli(torch, tctx, corpus, meta_path, root, report)
        phase_t_loop(torch, tctx, tpacks)
        del tctx, tpacks
        torch.cuda.empty_cache()

        phase_flash_bwd(torch, report)
        torch.cuda.empty_cache()
        phase_grad(torch, corpus, meta_path)
        torch.cuda.empty_cache()
        phase_train_steps(torch, corpus, meta_path)
        phase_train_cli(torch, corpus, meta_path, root, report)
        torch.cuda.empty_cache()

        phase_xlstm(torch, corpus, meta_path, root, report)
    torch.cuda.empty_cache()
    phase_probes(torch, report)
    return finish(torch, card, report, list(KERNEL_INFO), t_start)


def finish(torch, card: str, report: dict, names: list, t_start: float) -> int:
    """The kernels line and the last line, after checking that every kernel
    of `names` has its numbers and was launched on its path."""
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name in names:
        source, replaces = KERNEL_INFO[name]
        r = report[name]
        need(all(k in r for k in keys), f"{name}: the report lacks {[k for k in keys if k not in r]}")
        need(r["launches"] > 0, f"{name} was not launched on the main path")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        **{k: r[k] for k in keys}})
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
