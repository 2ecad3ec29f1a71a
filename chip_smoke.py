#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (musicgen_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints one line of numbers; any failure exits non-zero):
  1. device: a CUDA card is required; its name and power limit are printed
     as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` says.
  2. build: the kernels of csrc/ are compiled with nvcc for sm_90a.
  3. kernel A (ssd_scan): [3 ssd_scan] against its plain version
     (ssd_chunked) and its decomposition in plain PyTorch
     (ssd_kernel.scan_partitioned) at the prefill's shape, its two launches
     (grids, shared memory, device time of each by torch.profiler), its time
     host-paced and in a CUDA graph beside the bound's two terms (bytes;
     operations as three TF32 passes) and the plain version (with --parent
     DIR the parent tree's A in 5 rounds of turns); [3 ssd_scan shapes]
     against the sequential ssd_reference at T = 38, 129, 200 and 2,054 at
     batch 1 and 3 and with G = 2, and the refusals (P or N other than 64,
     G not dividing H, a float64 input); [3 ssd_scan repeat] a second call
     and three CUDA-graph replays bit for bit; [3 ssd_scan rows] each row of
     a batch-3 call bit for bit with that row run alone.
  4. [4 prefill] the full Mamba prefill (10 launches of A) against the same
     prefill with the plain ssd_chunked (last logits and the ten final SSM
     states), within the larger of TOL_A_PREFILL and twice the plain
     prefill's response to a 1e-6 perturbation of the scan's input; its ms
     host-paced and in a graph (with --parent DIR the prefill with the
     parent tree's A in turns). Kernel B at full width: each decode kernel against its plain version on
     the same inputs, then 64 teacher-forced decode steps of the kernel chain
     against the plain chain from one shared prefill state; [4 sample_tail
     <case>] the tail on the cases of TAIL_CASES (one and eight rows, a
     ragged vocabulary, ties, few allowed ids, the window cap), [4
     sample_tail repeat] its bits over 10 launches and CUDA-graph replays,
     [4 sample_tail time] (with --parent DIR the parent tree's tail in
     turns); [4 mixer_state parent] (with --parent DIR) the mixer's quarter-
     head items bit for bit with the parent tree's mixer and both timed in
     turns; [4 edges] the chain with its programmatic dependent launches (the
     mixer behind in_proj, out_proj behind the mixer) bit for bit with the
     same launches without them over 64 steps and 3 CUDA-graph replays, and
     the step in a graph with and without them; [4 gemv ragged]
     the bf16 GEMV against _product at two shapes no main path takes (a
     ragged last tile and a K tail; 8 rows at K = 4096).
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
     [6 resident] the launch's grid, block and shared memory, and 64 greedy
     tokens against the plain chain stepped over the emitted stream; [6
     chain] CHAIN_TOKENS tokens, greedy and stochastic, against the per-token
     kernel chain with the same pick and uniforms (identical streams,
     bitwise-equal final states); [6 loop] C's ms a token (tok/s/seq) and
     its share of the HBM roofline beside its yardstick, kernel B's chain
     step in a CUDA graph, and (with --parent DIR) the parent tree's C timed
     in 10 pairs of turns, each tree's median and mean; [6 cli] the CLI with --fused-decode resident, resident-int8w,
     int8 and int8w (grammar, MIDI, launch counters); [rows mamba auto|
     resident] the CLI at --batch 16, greedy, 64 tokens: two groups of 8
     rows, each kernel's launches, the grammar, and every row bit for bit
     with that row run alone at batch 1 (also [rows transformer auto] in
     phase 7 and [rows xlstm auto] in phase 9, at --batch 9).
  7. the Transformer at the reference size (8 blocks, d_model 1024, 8 heads
     of 128, block 2048; seeded random weights), kernels D and F:
     [7 flash] kernel D against its plain version at (2*8, 2054, 128) (its
     bf16 staging pass bit for bit against torch's rounding) and the SDPA
     call with the BD term in a float mask, host-paced and in a CUDA graph,
     then at T = 38, 129 and 200 (D with LSE bit-identical to D there);
     [7 prefill] the full
     prefill's last logits with D against the f32 plain attention;
     [7 tdecode] each kernel F launch against its plain twin on the same
     inputs in bf16 and W8A16 (the attention's partials and output against
     the plain splits and combine, and against the TPU kernel's math), [7
     tdecode_attn repeat] two launches and CUDA-graph replays of one bit for
     bit, [7 tdecode_attn ragged] batch 1, 5 and 8 at a ring of 200 with the
     newest slot at 0, 137 and 199, and the wrapper's refusals, then 64
     teacher-forced steps from a shared state against the plain twin chain
     and the f32 TransformerLM.step;
     [7 wrap] 40 steps at a block of 32 (the ring wraps) against the f32
     step; [7 cli] `--model transformer` with --fused-decode auto (greedy and
     stochastic) and int8w: grammar, MIDI, 8 launches of D per prefill and
     42 of F per token; [7 loop] tok/s/seq of the kernel F chain beside the
     plain step's, bytes per token and the share of the HBM roofline.
  8. training at full width, kernel D with its LSE output and kernel E (five
     launches: stage, E1 dQ, E2 dK + dV, E3 dRel's diagonal slots, combine):
     [8 flash-bwd] D's LSE and E's four gradients against their plain
     versions at (2*8, 2054, 128), each of E's launches against its own plain
     version on the same inputs (the staging and the combine bit for bit),
     D's output unchanged by the LSE, the autograd round trip against the f32
     attention; [8 flash-bwd repeat] the four gradients bit for bit on a
     second call and on CUDA-graph replays; D's and each E launch's times
     host-paced and from a CUDA graph beside the bound, the plain version,
     SDPA's forward or backward (each also in a CUDA graph) and, for E, the
     whole library path (SDPA's backward with dmask turned into dQ's band
     term and dRel); [8 flash-bwd T=.. B=..] the ragged lengths 38, 129 and
     200 at batch 1 and 3, every gradient and launch against its plain
     version; [8 grad] the Transformer's loss and every gradient
     through D and E against the same model with their plain versions on the
     card (and, as information, the f32 attention), with exact launch counts;
     [8 grad bf16] the same in the bf16 compute dtype (cli.train --bf16: D
     and E on bf16 activations, upcast around the kernels);
     [8 steps <family>] and [8 steps <family> bf16] five Adam steps of the
     Transformer, of Mamba and of the xLSTM (cut to X_TRAIN_DEPTH: 3 blocks,
     sLSTM at 1) on one batch in f32 and in bf16 (the loss falls at every
     step), ms/step, train tokens/s and peak memory; [8 split <family>
     <f32|bf16>] a step's forward, loss, backward and Adam by CUDA events,
     its device time by kernel group (GEMMs, D/E, Adam, the rest) from
     torch.profiler with the device's idle share, and the loss and grammar
     filter alone; [8 cli <family>] and [8 cli <family> bf16] `cli.train`
     (the second with --bf16) for each family (2 epochs, batch 2, block
     2048; the xLSTM's X_TRAIN_CLI_BLOCK at X_TRAIN_DEPTH) writing a
     checkpoint directory of f32 weights that `cli.generate --ckpt
     <dir>/model.pth` reads, with exact launch counts (a Mamba model and an
     xLSTM train through no kernel; the xLSTM's validation forwards launch
     H, in bf16 too, and its trained checkpoint generates through H and G);
     [8 ddp] train/distributed.py in a one-rank NCCL group: six DDP steps
     of the bf16 Transformer bit for bit with the unwrapped deterministic
     step, exact launches; [8 cli parallel] `python -m torch.distributed.run
     --standalone --nproc_per_node 1 -m musicgen_tpu_torch.cli.train
     --parallel --bf16` for the Transformer, rc 0, its checkpoint read back.
  9. the xLSTM at the reference size (11 blocks, d_model 1024, sLSTM at
     (1, 4, 7, 10); seeded random weights), kernels H and G: [9 slstm] kernel
     H against its plain scan at (2, 2054, 4, 256), with the scan's own noise
     floor, its launch (cluster size CS, rows a cluster BR, blocks, threads,
     shared memory, cudaOccupancyMaxActiveClusters, ptxas registers and
     spills), its ms host-paced and in a CUDA graph and us a step, the
     cluster of 16 beside the cluster of 8 in turns, and timer stamps of a
     step's product, cell and barrier (with --parent DIR, the parent tree's
     H in turns too, and H's outputs there and in [9 slstm shapes] bit for
     bit with the parent's); [9 slstm shapes] H against the plain scan at
     four other shapes, one of them two row groups, and its refusals (DH
     past 1,024, a cluster that does not split DH); [9 slstm
     repeat] two launches and three CUDA-graph replays bit for bit; [9
     prefill] the full prefill's last logits with H against the plain scan,
     4 launches of H (with --parent DIR, the prefill with the parent tree's H
     timed in turns); [9 slstm wide] H's wide path (DH 512 and 1,024, part
     of R read from L2 every step) and a padded head (DH 300) against the
     plain scan at the prefill's length, host-paced and in a CUDA graph
     beside the bound; [9 slstm wide prefill] the 2-head and 1-head xLSTMs
     of width 1024, 4 launches of H each, against the plain scan, both
     timed; [9 slstm wide step] kernel G at those heads (DK 1,024 and
     2,048, DH 512 and 1,024): the chain's xm_gates, xm_memory, xm_out and
     xs_cell against their plain versions, then 16 teacher-forced steps in
     bf16 and W8A16, the one-launch step bit for bit with the chain and the
     chain against the plain chain; [9 slstm wide generate] 32 greedy tokens
     of each, grammatical, through G's step (one launch of the step and of
     the tail a token); [9 xdecode
     ...] each launch of kernel G's
     chain against its plain version in bf16, W8A16 and with the matrix
     memory stored in bf16 (sb16), then in bf16, W8A16, sb16 and
     W8A16-sb16 64 teacher-forced steps from a shared state against the
     plain chain and the f32 XLSTMLM.step, with the plain chain's noise floor
     ([9 drift]); [9 xstep] G's one-launch step over the same 64 steps, bit
     for bit with the chain (logits, top-3, the six carry tensors) and on
     two CUDA-graph replays, its ms host-paced and in a graph beside the
     chain's and the bound; [9 cli] `--model xlstm` with --fused-decode auto
     (greedy and stochastic, 2,000 tokens), int8w, sb16 and int8w-sb16
     (shorter), on, int8 and off (shorter still): grammar, MIDI, 4 launches
     of H a prefill and 2 a token (G's step and B's tail; none with off);
     [9 loop] tok/s/seq of G's one-launch step and of its chain in each
     format, in turns (with --parent DIR, the parent tree's G before and
     after), beside the plain step's, the device time of one step in a CUDA
     graph, bytes per token and the share of the HBM roofline.
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
 11. the research path: [11 classifier] the full-size composer classifier
     (512 wide, 11 blocks, 4 heads of 128) at (2, 2048), its no-grad
     forward through kernel H (exactly 4 launches) against the plain scan;
     [11 classifier train] `cli.train_classifier` for one epoch, 2 steps at
     its context length (BCE, ms a
     step, peak memory); [11 evaluate] `cli.evaluate accuracy --batches 2`
     for each family with exact launches (D for the Transformer, H for the
     xLSTM, none for Mamba's plain forward), `classifier` on the trained
     checkpoint and `timing` for each family (ms a forward, peak memory);
     [11 preprocess] `cli.preprocess` over MIDI written from the corpus, each
     .npy equal to codec.encode of its file. H's launches there are added to
     its count on the main paths ([slstm_scan launches]).
 12. the generation CLI's other options and serving, on the reference models
     of phases 5, 7 and 9 at the depth of P12_DEPTH (Mamba 4 layers, the
     Transformer 4 blocks, the xLSTM 5 blocks with sLSTM at 1 and 4):
     [12 sampler <family> many|top5] `cli.generate
     --sampler many|top5` (the family's logits step, B, F or G, and no
     sampler tail; 'many' against the plain f32 path up to the first
     near-tie; tok/s/seq), [12 sampler mamba many resident] (the per-token
     kernels, no launch of C), [12 prompt-len] (--prompt-len 1024: Mamba
     through its kernels, a Transformer through D's prefill and its plain
     step), [12 windowed <family>] (--reference-windowing after a 2,016-token
     prompt: D 8 launches a token, H 4, none for Mamba; the stream against
     the cached kernel path, the Transformer's against its plain-attention
     twin, up to the first near-tie; ms a token), and [12 serve <family>
     <quant>] (`cli.serve --slots 8 --chunk 32`, 12 stochastic requests of
     32-208 tokens: exact launches against the schedule's group-chunks,
     grammar, MIDI, every request's stream bit for bit through
     serve.BatchScheduler at 4 slots in reverse order and at 16; aggregate
     tok/s, time to first chunk, per-request tok/s, the card). Their
     launches go to the kernels line through PATH_LAUNCHES.
 13. GPTQ: [13 gptq mamba] and [13 gptq xlstm] `cli.generate --fused-decode
     int8w-gptq` on the reference widths at GPTQ_DEPTH (Mamba 1 layer, the
     xLSTM 2 blocks with sLSTM at 1), 256 greedy tokens: the
     calibration forwards, the solve and the generation timed (tok/s/seq),
     the grammar, exact launches (B' W8A16 with B's mixer and tail; G's
     W8A16 step and the tail; A or H in the 4 calibration forwards);
     GPTQ's functional error over RTN's at every site (below 1, the median
     at most 0.95, no int8 matrix RTN's); the
     W8A16 kernels on the GPTQ pack against their plain chain over 16
     teacher-forced steps. Their launches go to the kernels line.
 14. diffusion (no kernel: the UNet is convolutions, group norms and
     matmuls, plain PyTorch as the JAX package leaves it to XLA), at the
     CLIs' full width (DiffusionDefaults(image_size=128): 95,004,680
     parameters, a (4, 128, 128) canvas), seeded random weights on every
     tensor: [14 unet] the card's f32 forward at batch 1 against the CPU's
     on the same weights and input (TOL_UNET_F32), bf16 against f32 on the
     card (TOL_UNET_BF16), ms host-paced and in a CUDA graph at batch 1 and
     8 in bf16 and f32 beside the bound (the forward's operations, counted
     by torch's FlopCounterMode, at the dtype's peak), peak memory; [14
     sample] one p_sample step with ground-truth injection, card against CPU
     on the same draws; [14 repaint] cli.inpaint's jump schedule (ddim25,
     jump length 10, 10 samples: 385 steps) through the API on the card, 205
     UNet forwards by a counter on the model, their device ms from CUDA
     events; [14 train] ten bf16 Adam steps at batch 8 on one batch of
     corpus canvases (the loss falls), ms/step, peak memory; [14 cli train]
     cli.train_diffusion --steps 20 --batch 8 --ckpt on the synthesized
     corpus, the checkpoint read back equal; [14 cli inpaint] cli.inpaint on
     a .mid written from the corpus, plain and with --jumps --ema: the .mid
     parses, its notes and the UNet forwards counted. No kernel's launch
     counter moves in phase 14.
 15. the multi-rank training strategies (musicgen_tpu_torch/parallel/), each
     in a one-rank NCCL group of this process (one card checks a group of
     one; groups of 2 and 4 ranks are held by the CPU tests), on one (BATCH,
     PROMPT) batch at full width in f32: [15 pp transformer] (8 blocks) and
     [15 pp mamba] (10 mixers) a GPipe pipe of one stage at P15_M
     microbatches, its loss within TOL_P15_LOSS of the unsharded step's and
     each gradient within TOL_P15_GRAD of its tensor's largest value, or,
     for the Transformer, within D and E's own distance from the plain f32
     attention's gradient (they round p and dS to bf16, so another split of
     the batch over their launches moves dRel by a few 1e-3); D with LSE and
     each E launch exactly blocks x M a step; ms/step beside the unsharded
     step's; [15 tp] the vocabulary-parallel token table and head over a
     model group of one, swapped into the Transformer, bit for bit with the
     unsharded model (loss and every gradient); [15 sp mamba] the
     time-sharded step in a group of one against the unsharded step, no
     kernel launched.
 16. data-parallel generation, serving and classification
     (parallel/serving.py, serve.BatchScheduler(mesh=)) in a one-rank NCCL
     group of this process, on phase 12's models (the full run runs it right
     after phase 12): [16 dp generate <family>] generate_data_parallel at
     batch 2, DP_TOKENS stochastic tokens, bit for bit with sampler.generate
     and exact launches (A and B, A and C for Mamba resident, D and F, H and
     G); [16 dp shares] the shares of 2 and 4 ranks of a batch of 8 (Mamba),
     each generated in turn on its columns of the batch's uniforms, against
     the batch at once, greedy and stochastic: the rows bit for bit counted,
     and each greedy row that differs held at its first difference to a
     near-tie (phase 12's position_check); [16 dp shares resident] kernel
     C on column slices of one tensor of uniforms, stochastic: a batch of
     16 in two groups of 8 bit for bit with each group alone, and the
     shares of 2 and 4 ranks counted against the batch of 8; [16 dp serve <family>] the
     scheduler over the group against no mesh, greedy and seeded, bit for
     bit, exact launches; [16 tp serve] the Transformer's vocabulary table
     and head split over a model group of one, served bit for bit with the
     unsplit model; [16 dp classify] the full-size classifier's forward
     over the group through H; [16 leftovers] midi/vectorized on CUDA
     tensors against the CPU and midi/native (the C++ tokenizer built with
     g++ into build/) against the Python codec; with --parent DIR, [16 cli
     draws] cli.generate per token in this tree (the draw rule) and the
     parent tree, in turns. Its launches go to the kernels line.
 17. the seq2seq translator (models/seq2seq.py; no kernel, plain PyTorch as
     the JAX package leaves it to XLA) at its default width, built and
     seeded through models.registry: [17 seq2seq] a (2, 512) source encoded
     once and 64 greedy tokens on the card, timed by utils.profiling's
     StepTimer, each step's log-probs within TOL_S2S of the same model's on
     the CPU over the card's prefix (f32, TF32 off), the greedy picks equal
     but at a near-tie, profiling.device_memory(), no launch counter moved.
Each phase's seconds print as [seconds <phase>].
`--only seq2seq` runs phases 1, 2 and 17 (its kernels line is empty).
`--only dp` runs phases 1, 2 and 16 (its kernels line is empty; the
launches print as [<kernel> launches]).
`--only parallel` runs phases 1, 2 and 15 (its kernels line is empty; D
with LSE's and E's launches print as [<kernel> launches]).
`--only diffusion` runs phases 1, 2 and 14 (its kernels line is empty).
`--only 12` runs phases 1, 2 and 12 (its kernels line is empty; the new
paths' launches print as [<kernel> launches]); `--only gptq` phases 1, 2
and 13, the same way.
`--only 11` runs phases 1 and 2, [9 slstm] (H's numbers for the kernels
line) and phase 11; its kernels line holds slstm_scan with the launches of
phase 11.
`--only ssd` runs phases 1 to 3 and every row that launches kernel A: [4
prefill], [5 cli], the resident [6 cli] runs with [6 api resident int8] and
[rows mamba auto|resident]; its kernels line holds ssd_scan with the
launches of [5 cli], counted from zero.
`python3 chip_smoke.py --only 7` runs phases 1, 2 and 7 alone, `--only 9`
phases 1, 2 and 9, `--only 10` phases 1, 2 and 10 (bring-up of a slice; the
full run takes no arguments, and runs phases 11, 12 and 13 after phase 9,
then 10).
`--only int8` runs phases 1 and 2 and every row that launches the int8
GEMVs (decode_ops.cuh gemv_team in W8A16 or W8A8): [4q] and [4q steps_*], [6 resident],
[6 chain], [6 loop] and the [6 cli] runs in W8A16 and W8A8, [7 prefill],
[7 tdecode] and [7 cli int8w] in W8A16, [9 prefill], [9 xdecode], [9
xstep], the [9 cli] runs and [9 loop] in W8A16 and W8A16-sb16; its kernels
line holds the launches of those CLI runs (G's chain: of its [9 loop] runs),
each counted from zero, as the full run does. `--only bf16` runs
phases 1 and 2 and every row that launches the bf16 GEMV (gemv_team in
bf16): [4] and [4 steps], [4 gemv ragged], [5 cli] and [5 loop], [6
resident], [6 chain], [6 loop] and the [6 cli] runs in bf16, [7 prefill],
[7 tdecode], the bf16 [7 cli] runs and [7 loop] in bf16, [9 prefill], [9
xdecode], the bf16 [9 cli] runs and [9 loop] in bf16 and sb16, and phase
10; its kernels line holds the launches of those CLI runs (and of
kernel_ablate.run), each counted from zero, as the full run does.
`--only mixer` runs phases 1 and 2, phase 4, [5 cli], [6 resident], [6
chain], [6 loop], the resident [6 cli] runs, the three families' [rows ...]
runs and last [4 mixer_state parent] and [4 edges]; its kernels line holds
kernel B's and C's launches.
`--only resident` runs phases 1 and 2 and every row that launches kernel C
([6 resident], [6 chain], [6 loop] and the resident [6 cli] runs); its
kernels line holds C's three forms from those CLI runs, each counted from
zero. `--parent DIR` (with any of the above, or none) names another
checkout of the port, such as an unpacked `git archive` of the parent
commit: [3 ssd_scan], [4 prefill], [4 sample_tail time], [6 loop], [9
slstm], [9 prefill] and [9 loop] build its kernels into DIR/build and time
its A, its tail, its C, its H and its G beside this tree's.
`--only tail` runs phases 1 and 2 and every row that holds the sampler tail
(kernel B's sample_tail and C's spread tail): phase 4 with its [4 sample_tail
...] rows, [5 cli], [6 resident], [6 chain], [6 loop], [7 tdecode] with its
steps and [9 xdecode] with [9 xstep]; its kernels line holds sample_tail
with the launches of [5 cli] (the full run's adds F's and G's CLI runs).
`--only flash` runs
phases 1 and 2 and every row that launches kernel D or E: [7 flash],
[7 prefill], [7 wrap], the bf16 [7 cli] runs, [8 flash-bwd] with its repeat
and ragged rows, [8 grad] and [8 grad bf16], [8 steps], [8 split] and [8
cli] for the Transformer in f32 and bf16, [8 ddp] and [8 cli parallel];
its kernels line holds D's, D with LSE's and E's five launches from those
CLI runs and [8 ddp], each counted from zero. `--only 8` runs phases 1 and
2 and every row of phase 8, for every family.
The last lines are one JSON object with every kernel ({"kernels": [...]}: its
launches on the main path, error, time, plain time, bound and library time)
and {"ok": true, "device": {...}}.

TF32 is off for every matmul and convolution: the plain versions are the
reference the kernels are held to.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"

SEED = 0
BATCH = 2
PROMPT = 2048
LENGTH = 2000
TEACHER_STEPS = 64
QUANT_STEPS = 16
RESIDENT_CHECK_TOKENS = 64
CHAIN_TOKENS = 1000  # [6 chain]: C held bit for bit to the per-token chain (host-paced, 3-5 ms a token)
CLI_SHORT = 200  # tokens of the per-token int8 CLI runs of [6 cli] and [7 cli]
MIXER_REPEATS = 10  # steps of the state over which [4 mixer_state parent] holds the mixer to the parent's
# [6 resident] steps the plain chain over the kernel's emitted stream from
# the shared prefill state, so the two chains drift apart as the chain does
# from itself (phase 4's [4 drift]: 7.7e-2 of the logits after 64 steps
# from a 1e-6 perturbation). Emitted tokens must be among the plain top-3
# over the first TOP3_STRICT_TOKENS; the final states are held to
# max(TOL_STEPS, 2x the drift of the plain chain from a 1e-6-perturbed start).
TOP3_STRICT_TOKENS = 16
# [6 loop] with --parent DIR: rounds of (parent, this, this, parent), kernel C
# a token as the median and the mean of each tree's runs (2 x LOOP_TURNS
# each: 10 parent/this pairs).
LOOP_TURNS = 5
PLAIN_LOOP_TOKENS = 100  # [5 loop]'s plain MambaLM.step, host-paced (10 ms a token)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak (at 700 W)
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak (H100 SXM data sheet)
F32_FLOPS = 67e12  # f32 outside the tensor cores (H100 SXM data sheet)
TF32_FLOPS = 495e12  # dense TF32 tensor-core peak (H100 SXM data sheet)
# Tolerances, as max|kernel - plain| / max|plain|. f32 kernels differ from
# their plain versions only in the order of f32 sums. The bf16 GEMVs take
# their normalisation's statistics in the plain versions' formula (f64 sums
# rounded once, rsqrtf), so their bf16 activations equal the plain
# version's wherever torch's f32 mean is the correctly rounded one; where it
# is not, one bf16 rounding can flip (2^-8 relative). The other bf16 kernels
# (D, E, F's attention) round their operands at other points.
TOL_F32 = 1e-4
TOL_BF16 = 1e-2
# The full Mamba prefill's last logits and final SSM states with kernel A
# against the plain ssd_chunked: the two differ by f32 rounding in the
# scans, carried through ten layers without residuals. Held to the larger
# of this and twice the plain prefill's own response to a 1e-6 relative
# perturbation of the scan's input (both printed; the response was 5e-5 of
# the last logits on the H100, PERF.md).
TOL_A_PREFILL = 1e-3
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
# [7 flash]'s ragged lengths: one partial tile (the metadata columns only in
# key tile 0), one row past a key tile, and a length between.
FLASH_RAGGED_T = (38, 129, 200)
T_PLAIN_LOOP_TOKENS = 50  # [7 loop plain], host-paced (13 ms a token)
# [7 tdecode_attn ragged]: a ring of four splits, the last of 8 slots, at
# batch 1, 5 (batch groups of 3 and 2) and 8 (two of 4), the newest slot at
# both ends and at a run whose rel rows wrap.
ATTN_RAGGED_S, ATTN_RAGGED_B, ATTN_RAGGED_C = 200, (1, 5, 8), (0, 137, 199)
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

# Phase 8, training. Kernel E against its plain version: bf16 operands, f32
# sums in another order (TOL_BF16); its combine against its plain version
# on the same slots, bit for bit; every gradient, dRel included, bit for bit
# on a second call and on graph replays (no atomics). The training
# attention against torch.autograd through the f32 attention: the tolerance
# of tests/test_pallas_attention.py for the TPU kernel. The full model's loss
# and gradients through D and E against the same model with their plain
# versions on the card: the two round p and dS to bf16 after f32 sums in
# another order, so single roundings flip (2^-8 relative) and the flips add up
# through 8 blocks. The worst tensor is a rel_pos_emb: each of its rows sums
# bf16-rounded dS along a diagonal, terms that largely cancel, so the
# rounding noise stands out against its largest entry (1.3e-2 to 1.6e-2 of it
# on the H100; the other tensors stay near 1e-3). 2e-2 holds that, where a missing
# or wrong term moves a gradient by O(1).
TOL_TRAIN_F32 = 3e-2
# Kernel E's launches, in the order a backward makes them (each L times a
# training step).
E_LAUNCHES = ("flash_bwd_stage", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_drel", "flash_bwd_drel_combine")
# [8 flash-bwd]'s ragged lengths (as [7 flash]'s) and batches.
FLASH_BWD_RAGGED_B = (1, 3)
TOL_LOSS = 1e-4
TOL_GRAD = 2e-2
# [8 grad bf16]: the same comparison in the bf16 compute dtype. D's output and
# E's gradients are rounded to bf16 on the way out (the TPU wrapper's casts),
# so an f32 order difference inside the kernel flips whole bf16 roundings
# (2^-8 relative) and the bf16 activations of 8 blocks carry the flips on: 5x
# the f32 tolerances, still far below the O(1) a wrong or missing term makes.
TOL_LOSS_BF16 = 5e-4
TOL_GRAD_BF16 = 1e-1
# The compute dtypes of phase 8's rows: f32 and cli.train --bf16's.
DTYPES = {"f32": lambda torch: torch.float32, "bf16": lambda torch: torch.bfloat16}
TRAIN_STEPS = 5
X_TRAIN_STEPS = 3  # [8 steps xlstm]: its steps run the Python sLSTM scan, 4-6 s each
TRAIN_EPOCHS = 2
GEN_AFTER_TRAIN = 32
# The --block-len of [8 cli xlstm]: it trains through the plain sLSTM scan
# (kernel H has no backward), a Python loop over the block in each of 4 sLSTM
# blocks, forward and backward, 10.6-10.7 s a step at 2,048 on the H100
# (PERF.md). A quarter of the block keeps the run near its time; [8 steps
# xlstm] times the full 2,048. [11 classifier train] trains at the
# classifier's context length, 2 steps.
X_TRAIN_CLI_BLOCK = 512
# The xLSTM of [8 steps xlstm] and [8 cli xlstm]: the reference width at a cut
# depth, one sLSTM block between two mLSTM blocks (the plain sLSTM scan, a
# Python loop over the block forward and backward, is most of a step).
X_TRAIN_DEPTH = {"num_blocks": 3, "slstm_at": (1,)}

# Phase 9, the xLSTM. Kernel H against its plain scan: f32 sums in another
# order over 2,054 dependent steps; held to the 2e-4 of
# tests/test_pallas_slstm.py, or to twice the scan's own drift from a 1e-6
# perturbation of its input, whichever is larger (both printed).
TOL_H = 2e-4
# The full prefill's last logits with kernel H against the plain scan: the same
# f32 noise through 11 blocks.
TOL_X_PREFILL = 1e-3
XQUANTS = {"bf16": "none", "int8w": "w8a16", "bf16-sb16": "none", "int8w-sb16": "w8a16"}  # kernel G's formats
TOL_W8A16 = 2e-2  # a W8A16 GEMV against its plain version (bf16 activations, int8 weights, f32 sums)
# The kernel chain against the plain chain from a shared state, each step: the
# plain chain's own response to a 1e-6 perturbation of the state sets the
# floor (printed); the tolerance is the larger of TOL_T_STEP and twice it.
# Against the f32 XLSTMLM.step: the JAX test's tolerances
# (tests/test_pallas_xlstm_decode.py), as a share of the largest logit.
TOL_X_F32 = {"bf16": 0.05, "int8w": 0.12, "bf16-sb16": 0.05, "int8w-sb16": 0.12}
X_CLI_SHORT = 200  # tokens of the int8w / sb16 / int8w-sb16 CLI runs
X_TEACHER_STEPS = 16  # [9 xdecode steps] and [9 xstep]: four plain xLSTM chains a step (15-33 ms each)
X_CLI_TINY = 64  # tokens of the on / int8 / off CLI runs
# [9 loop]'s host-paced runs (4 formats x 4 runs at 3-6 ms a token) and the
# plain f32 step's (25 ms a token), at counts that keep the full run inside
# its time.
X_LOOP_TOKENS = 250
X_PLAIN_LOOP_TOKENS = 50

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
    "tdecode_attn": ("musicgen_tpu_torch/csrc/tdecode_attn.cu", "musicgen_tpu/ops/pallas_transformer_decode.py:254"),
    "flash_relpos_lse": ("musicgen_tpu_torch/csrc/flash_relpos.cu", "musicgen_tpu/ops/pallas_attention.py:44"),
    **{name: ("musicgen_tpu_torch/csrc/flash_relpos_bwd.cu", f"musicgen_tpu/ops/pallas_attention.py:{line}")
       for name, line in (("flash_bwd_stage", 310), ("flash_bwd_dq", 310), ("flash_bwd_dkv", 365),
                          ("flash_bwd_drel", 310), ("flash_bwd_drel_combine", 310))},
    "slstm_scan": ("musicgen_tpu_torch/csrc/slstm_scan.cu", "musicgen_tpu/ops/pallas_slstm.py:42"),
    **{name: ("musicgen_tpu_torch/csrc/xlstm_decode.cu", "musicgen_tpu/ops/pallas_xlstm_decode.py:410")
       for name in ("xm_up", "xm_prep", "xm_gates", "xm_memory", "xm_out", "xm_down", "xs_prep", "xs_in", "xs_cell",
                    "xs_ffn_up", "xs_ffn_down", "xm_memory_sb16", "xm_up_w8a16", "xm_down_w8a16", "xs_in_w8a16",
                    "xs_ffn_up_w8a16", "xs_ffn_down_w8a16")},
    **{name: ("musicgen_tpu_torch/csrc/xlstm_step.cu", "musicgen_tpu/ops/pallas_xlstm_decode.py:410")
       for name in ("xlstm_step", "xlstm_step_w8a16", "xlstm_step_sb16", "xlstm_step_w8a16_sb16")},
    "probe_mm": ("musicgen_tpu_torch/csrc/probe_mm.cu", "experiments/hw_characterize.py:33"),
    **{name: ("musicgen_tpu_torch/csrc/decode_ablate.cu", "experiments/kernel_ablate.py:54")
       for name in ("ablate_stream", "ablate_gemv", "ablate_nossd")},
}
# The phases of --only 9 and --only 10: the kernels a report of that phase holds.
X_KERNELS = [name for name, (src, _) in KERNEL_INFO.items()
             if src.endswith(("slstm_scan.cu", "xlstm_decode.cu", "xlstm_step.cu"))]
T_KERNELS = ["flash_relpos", *(name for name, (_, replaces) in KERNEL_INFO.items()
                               if "transformer_decode" in replaces)]
PROBE_KERNELS = [name for name, (src, _) in KERNEL_INFO.items() if src.endswith(("probe_mm.cu", "decode_ablate.cu"))]
INT8_KERNELS = [name for name in KERNEL_INFO if name.endswith(("_w8a16", "_w8a8")) or "_w8a16_" in name]
# The kernels that run the bf16 GEMV (decode_ops.cuh gemv_team in bf16): the --only bf16 report.
BF16_KERNELS = ["in_proj_conv", "out_proj_rms", "lm_head_ln", "generate_resident_bf16", "t_qkv_ln", "t_res",
                "t_fc_relu", "xm_up", "xm_down", "xs_in", "xs_ffn_up", "xs_ffn_down", "xlstm_step", "xlstm_step_sb16",
                "ablate_gemv"]
FLASH_KERNELS = [name for name, (src, _) in KERNEL_INFO.items() if src.endswith(("flash_relpos.cu",
                                                                                 "flash_relpos_bwd.cu"))]
RESIDENT_KERNELS = [name for name, (src, _) in KERNEL_INFO.items() if src.endswith("generate_resident.cu")]
MIXER_KERNELS = ["in_proj_conv", "mixer_state", "out_proj_rms", "lm_head_ln", "sample_tail", *RESIDENT_KERNELS]


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


def median_ms(torch, fn, iters: int = 5, warmup: int = 1) -> float:
    """Median device time of fn() in ms over `iters` calls, each between
    its own CUDA events and synchronised (a host-paced call: the host's
    pauses count, but one slow call does not move the median)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


class LibTime(NamedTuple):
    """The library call computing a kernel's function on its inputs: its
    name, host-paced ms and device ms from a CUDA graph (as the kernels'
    graph times); ms is None where there is no such call."""
    name: str
    ms: float | None
    graph: float | None

    def text(self) -> str:
        return "library none" if self.ms is None else f"{self.name} {self.ms:.4f} ms (CUDA graph: {fmt_ms(self.graph)})"


NO_LIBRARY = LibTime("none", None, None)


def library_time(torch, name: str, fn) -> LibTime:
    return LibTime(name, cuda_ms(torch, fn), graph_ms(torch, fn))


def linear_time(torch, x, w_bf16) -> LibTime:
    """F.linear on bf16 activations and weights, the library call computing
    a GEMV's product."""
    xb = x.to(torch.bfloat16)
    return library_time(torch, "F.linear", lambda: torch.nn.functional.linear(xb, w_bf16))


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


def ptxas_usage(text: str) -> list[tuple[str, str, str]]:
    """(kernel, registers and barriers, stack frame and spills) of each entry
    function in the output of `nvcc -Xptxas -v`, the names demangled where
    c++filt is on the path."""
    rows, fn, frame = [], None, ""
    for ln in text.splitlines():
        if "Function properties for " in ln:
            fn, frame = ln.split("Function properties for ", 1)[1].strip(), ""
        elif fn and "spill stores" in ln:
            frame = ln.strip()
        elif fn and "Used " in ln and " registers" in ln:
            rows.append((fn, ln.split("Used ", 1)[1].strip(), frame))
            fn = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows), capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        names = []
    if len(names) == len(rows):
        names = [n.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ") for n in names]
        rows = [(n, u, f) for n, (_, u, f) in zip(names, rows)]
    return rows


def phase_build() -> float:
    from musicgen_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.load_library()
    secs = time.perf_counter() - t0
    log = (build.library_path().parent / "build.log")
    usage = ptxas_usage(log.read_text()) if log.exists() else []
    spills = [name for name, _, frame in usage if not frame.endswith("0 bytes spill stores, 0 bytes spill loads")]
    say(f"[2 build] {secs:.2f} s -> {build.library_path()}; {len(spills)} of {len(usage)} kernels spill registers")
    for name, regs, frame in usage:
        say(f"    ptxas {name}: {regs}; {frame}")
    for label, key in (("kernel C", "generate_kernel"), ("kernel G's step", "xstep_kernel")):
        rows = sorted((name, regs, frame) for name, regs, frame in usage if key in name)
        say(f"[2 build] {label}: " + "; ".join(f"{name} {regs}, {frame}" for name, regs, frame in rows))
    return secs


def profiled_ms(torch, fn, names, calls: int = 10) -> dict:
    """Device ms a call of each kernel whose name holds one of `names`, from
    torch.profiler over `calls` calls of fn(); None where the trace holds no
    device time for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names)
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        for name in names:
            if name in ev.key and us:
                out[name] = (out[name] or 0.0) + us / 1e3 / calls
    return out


def ssd_inputs(torch, b: int, t: int, h: int, g: int = 1, t_real: int | None = None, seed: int = SEED):
    """Seeded inputs of kernel A at (B, T, H, G), P = N = 64, the steps from
    t_real on zero (as the prefill's trailing pad steps)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(b, t, h, 64, device=DEVICE, generator=gen)
    dt = 0.001 + 0.2 * torch.rand(b, t, h, device=DEVICE, generator=gen)
    A = -(1.0 + 15.0 * torch.rand(h, device=DEVICE, generator=gen))
    Bm = torch.randn(b, t, g, 64, device=DEVICE, generator=gen)
    Cm = torch.randn(b, t, g, 64, device=DEVICE, generator=gen)
    if t_real is not None:
        for v in (x, dt, Bm, Cm):
            v[:, t_real:] = 0
    return x, dt, A, Bm, Cm


def phase_ssd(torch, report: dict, parent: Path | None = None) -> None:
    """[3 ssd_scan] kernel A at the prefill's shape against ssd_chunked and
    against its decomposition in plain PyTorch (`scan_partitioned`), its two
    launches, times host-paced and in a CUDA graph beside the bound's two
    terms and the plain version (with --parent DIR the parent tree's A in
    turns); [3 ssd_scan shapes] against the sequential ssd_reference at
    ragged T, batch 1 and 3, and G = 2; the refusals; [3 ssd_scan repeat]
    two calls and three graph replays bit for bit; [3 ssd_scan rows] each
    row of a batch-3 call bit for bit with that row alone."""
    from musicgen_tpu_torch.ops import ssd_kernel as sk
    from musicgen_tpu_torch.ops.ssm import ssd_chunked

    ssd_scan = sk.ssd_scan
    b, t_real, t, h, p = BATCH, PROMPT + 6, 2304, 32, 64
    args = ssd_inputs(torch, b, t, h, t_real=t_real)
    geo = sk.scan_geometry(b, t, h, 1)
    mirror, kgeo = (sk.CHUNK, sk.THREADS, sk.CHUNK_SMEM, sk.PASS_SMEM, sk.PASS_ROWS, sk.STAGES), sk.kernel_geometry()
    need(kgeo == mirror, f"ssd_scan: the kernel's constants {kgeo} are not ops/ssd_kernel's {mirror}")
    y_k, s_k = ssd_scan(*args)
    y_p, s_p = ssd_chunked(*args, chunk=256)
    y_q, s_q = sk.scan_partitioned(*args)
    torch.cuda.synchronize()
    ey, ry = rel_err(y_k, y_p)
    es, rs = rel_err(s_k, s_p)
    pq = max(rel_err(y_k, y_q)[1], rel_err(s_k, s_q)[1])
    need(bool(torch.isfinite(y_k).all()) and bool(torch.isfinite(s_k).all()), "ssd_scan: non-finite output")
    ms = cuda_ms(torch, lambda: ssd_scan(*args), iters=20)
    dev_ms = graph_ms(torch, lambda: ssd_scan(*args), calls=10)
    plain_ms = cuda_ms(torch, lambda: ssd_chunked(*args, chunk=256), iters=20)
    split = profiled_ms(torch, lambda: ssd_scan(*args), ("ssd_chunk_kernel", "ssd_pass_kernel"))
    # Bound: x, dt, A, B, C read and y and the state written once; the
    # recurrence's 4 * P * N flops per (b, t, h) (update and readout), f32-
    # accurate on the tensor cores as three TF32 passes.
    n_bytes, flops = nbytes(*args, y_k, s_k), 4.0 * b * t * h * p * p
    cost = bound(n_bytes, flops, TF32_FLOPS / 3)
    parent_txt = "the parent tree's A not measured (no --parent)"
    if parent is not None:
        psk = parent_module(parent, "ssd_kernel", "[3 ssd_scan]")
        y_par, s_par = psk.ssd_scan(*args)
        turns: dict = {"parent": [], "this": []}
        for _ in range(SSD_TURNS):
            for who in ("parent", "this", "this", "parent"):
                fn = psk.ssd_scan if who == "parent" else ssd_scan
                turns[who].append((median_ms(torch, lambda: fn(*args), iters=10), graph_ms(torch, lambda: fn(*args),
                                                                                         calls=10)))

        def med(who, i):
            vals = [r[i] for r in turns[who] if r[i] is not None]
            return statistics.median(vals) if vals else None

        parent_txt = (f"in {SSD_TURNS} rounds of turns (parent, this, this, parent): this tree median "
                      f"{med('this', 0):.4f} ms host-paced, {fmt_ms(med('this', 1))} in a graph; the parent tree's A "
                      f"median {med('parent', 0):.4f} ms host-paced, {fmt_ms(med('parent', 1))} in a graph (graph: "
                      + " / ".join(fmt_ms(r[1]) for r in turns["parent"]) + f"); the parent's y rel "
                      f"{rel_err(y_par, y_p)[1]:.3e}")
    say(f"[3 ssd_scan] (B,T,H,G,P,N)=({b},{t},{h},1,{p},{p}), the last {t - t_real} steps zero: y max_abs {ey:.3e} "
        f"rel {ry:.3e}; state max_abs {es:.3e} rel {rs:.3e} against ssd_chunked (tol rel {TOL_F32}); against "
        f"scan_partitioned rel {pq:.3e}; launch 1: {geo.chunk_grid} x {geo.threads} threads, {geo.chunk_smem} B "
        f"shared, {fmt_ms(split['ssd_chunk_kernel'])}; launch 2: {geo.pass_grid} x {geo.threads}, "
        f"{geo.pass_smem} B, {fmt_ms(split['ssd_pass_kernel'])} "
        f"(torch.profiler, a mean of 10 calls); scratch {geo.scratch_bytes} B; kernel "
        f"{ms:.4f} ms host-paced (CUDA graph: {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms; bound "
        f"{cost['bound_ms']:.4f} ms ({cost['bound_by']}: bytes {1e3 * n_bytes / HBM_BYTES_PER_S:.4f} ms, "
        f"3xTF32 operations {1e3 * flops / (TF32_FLOPS / 3):.4f} ms; f32 FMA would be "
        f"{1e3 * flops / F32_FLOPS:.4f}); {parent_txt}")
    need(ry <= TOL_F32 and rs <= TOL_F32, "ssd_scan disagrees with ssd_chunked")
    report["ssd_scan"] = {"max_abs_err": max(ey, es), "ms": ms, "plain_ms": plain_ms, "library_ms": None, **cost}
    del y_p, s_p, y_q, s_q
    phase_ssd_shapes(torch, sk)
    phase_ssd_repeat(torch, sk, args, y_k, s_k)
    phase_ssd_rows(torch, sk)


# [3 ssd_scan shapes]: (B, T, G) at H = 32 against the sequential oracle.
SSD_SHAPES = tuple((bb, tt, 1) for tt in (38, 129, 200, 2054) for bb in (1, 3)) + ((3, 200, 2),)
# [3 ssd_scan] with --parent DIR: rounds of (parent, this, this, parent), 10 pairs.
SSD_TURNS = 5
SSD_REPLAYS = 3


def phase_ssd_shapes(torch, sk) -> None:
    from musicgen_tpu_torch.ops.ssm import ssd_reference

    worst, cases = 0.0, []
    for i, (bb, tt, g) in enumerate(SSD_SHAPES):
        args = ssd_inputs(torch, bb, tt, 32, g, seed=SEED + 1 + i)
        y_k, s_k = sk.ssd_scan(*args)
        y_r, s_r = ssd_reference(*args)
        r = max(rel_err(y_k, y_r)[1], rel_err(s_k, s_r)[1])
        need(y_k.shape == y_r.shape and bool(torch.isfinite(y_k).all()), f"ssd_scan at {(bb, tt, g)}: bad output")
        cases.append(f"({bb}, {tt}, G {g}) {r:.2e}")
        worst = max(worst, r)
        need(r <= TOL_F32, f"ssd_scan at (B, T, G) = {(bb, tt, g)} disagrees with ssd_reference (rel {r:.3e})")
    x, dt, A, Bm, Cm = ssd_inputs(torch, 1, 40, 4, 2)
    refused, before = [], sk.ssd_scan.launches
    for what, call in (("P 32", lambda: sk.ssd_scan(x[..., :32].contiguous(), dt, A, Bm, Cm)),
                       ("N 32", lambda: sk.ssd_scan(x, dt, A, Bm[..., :32].contiguous(), Cm[..., :32].contiguous())),
                       ("H 4, G 3", lambda: sk.ssd_scan(x, dt, A, *ssd_inputs(torch, 1, 40, 4, 3)[3:])),
                       ("f64 x", lambda: sk.ssd_scan(x.double(), dt, A, Bm, Cm))):
        try:
            call()
        except ValueError:
            refused.append(what)
    say(f"[3 ssd_scan shapes] H 32 against the sequential ssd_reference, rel (B, T, G): {'; '.join(cases)} "
        f"(worst {worst:.3e}, tol {TOL_F32}); refused: {', '.join(refused)}")
    need(len(refused) == 4 and sk.ssd_scan.launches == before, f"ssd_scan refused only {refused}")


def phase_ssd_repeat(torch, sk, args, y0, s0) -> None:
    y1, s1 = sk.ssd_scan(*args)
    torch.cuda.synchronize()
    same = [torch.equal(y1, y0) and torch.equal(s1, s0)]
    static: dict = {}

    def capture():
        static["y"], static["s"] = sk.ssd_scan(*args)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        capture()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        capture()
    for _ in range(SSD_REPLAYS):
        static["y"].zero_()
        graph.replay()
        torch.cuda.synchronize()
        same.append(torch.equal(static["y"], y0) and torch.equal(static["s"], s0))
    say(f"[3 ssd_scan repeat] a second call and {SSD_REPLAYS} CUDA-graph replays bit for bit with the first: "
        f"{sum(same)}/{len(same)}")
    need(all(same), "ssd_scan gives other bits on a repeat or a graph replay")


def phase_ssd_rows(torch, sk) -> None:
    args = ssd_inputs(torch, 3, PROMPT + 6, 32, seed=SEED + 99)
    y, s = sk.ssd_scan(*args)
    equal = []
    for j in range(3):
        yj, sj = sk.ssd_scan(*(a[j:j + 1].contiguous() if a.dim() > 1 else a for a in args))
        equal.append(torch.equal(yj, y[j:j + 1]) and torch.equal(sj, s[j:j + 1]))
    say(f"[3 ssd_scan rows] (3, {PROMPT + 6}, 32): each row bit for bit with the row run alone: {sum(equal)}/3")
    need(all(equal), "ssd_scan: a row's output depends on the other rows of the batch")


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


def decode_context(torch, model, corpus: Path, meta_path: Path) -> dict:
    """Phase 4's inputs: a batch of prompts from the synthesized corpus, the
    prefill state, the teacher tokens, and the first layer's activations
    through the plain versions (x, g, o: what in_proj, out_proj and the head
    take)."""
    import numpy as np

    from musicgen_tpu_torch.data.dataset import TokenDataset
    from musicgen_tpu_torch.ops import decode_kernel as dk

    ds = TokenDataset.from_directory(corpus / "Mozart", meta_path, block_len=PROMPT, seed=SEED)
    items = [ds[i] for i in range(BATCH)]
    prompt = torch.from_numpy(np.stack([s for s, _, _ in items]).astype(np.int64)).to(DEVICE)
    meta = torch.from_numpy(np.stack([m for _, _, m in items]).astype(np.int64)).to(DEVICE)
    dims = dk.DecodeDims.create(model.cfg, BATCH)
    dp = dk.build_decode_params(model, BATCH)
    with torch.no_grad():
        logits0, states = model.prefill(prompt, meta)
    need(bool(torch.isfinite(logits0).all()), "prefill logits are not finite")
    carry = dk.stack_states(states)
    x = torch.nn.functional.embedding(prompt[:, -1], dp["embed"])
    zx = dk.in_proj_conv_plain(x, dp["w_in"][0], dp["conv_w"][0], dp["conv_b"][0], dp["dt_bias"][0],
                               carry[0][0].clone(), dims)
    g = dk.mixer_state_plain(zx, dp["a_h"][0], dp["d_h"][0], carry[1][0].clone(), dims)
    o = dk.out_proj_rms_plain(g, dp["norm_w"][0], dp["w_out"][0], dims)
    teacher = torch.from_numpy(np.stack([ds[i][0][:TEACHER_STEPS] for i in range(BATCH)]).astype(np.int64)).to(DEVICE)
    return {"prompt": prompt, "meta": meta, "teacher": teacher, "logits": logits0[:, -1, :], "carry": carry,
            "x": x, "g": g, "o": o, "dims": dims, "dp": dp, "model": model}


@contextlib.contextmanager
def ssd_scan_as(fn):
    """MambaLM.prefill with `fn` in kernel A's place (its plain version, or
    the parent tree's A), on the card."""
    from musicgen_tpu_torch.models import mamba

    saved = mamba.ssd_scan
    mamba.ssd_scan = fn
    try:
        yield
    finally:
        mamba.ssd_scan = saved


def phase_prefill(torch, model, ctx: dict, parent: Path | None = None) -> None:
    """[4 prefill] the full-size MambaLM's prefill with kernel A against the
    same prefill with the plain ssd_chunked: the last logits and the ten
    layers' final SSM states, held to the larger of TOL_A_PREFILL and twice
    the plain prefill's own response to a 1e-6 relative perturbation of the
    scan's input x in every layer (printed). Its ms host-paced (the median
    of 5 calls) and in a CUDA graph, the plain forward's; with --parent DIR
    the prefill with the parent tree's A in turns (SSD_TURNS rounds of
    parent, this, this, parent)."""
    from musicgen_tpu_torch.ops.ssd_kernel import ssd_scan
    from musicgen_tpu_torch.ops.ssm import ssd_chunked

    prompt, meta = ctx["prompt"], ctx["meta"]
    ssd_scan.launches = 0
    logits_k, states_k = model.prefill(prompt, meta)
    torch.cuda.synchronize()
    launches = ssd_scan.launches
    noise = torch.Generator(device=DEVICE).manual_seed(SEED)

    def perturbed(x, dt, A, Bm, C, chunk):
        return ssd_chunked(x * (1.0 + 1e-6 * torch.randn(x.shape, device=DEVICE, generator=noise)), dt, A, Bm, C,
                           chunk=chunk)

    with ssd_scan_as(ssd_chunked):
        logits_p, states_p = model.prefill(prompt, meta)
        plain_ms = cuda_ms(torch, lambda: model.prefill(prompt, meta), iters=3, warmup=1)
    with ssd_scan_as(perturbed):
        logits_n, states_n = model.prefill(prompt, meta)

    def errs(logits, states):
        e_abs, e_rel = rel_err(logits[:, -1], logits_p[:, -1])
        return e_abs, e_rel, max(rel_err(a["ssm"], b["ssm"])[1] for a, b in zip(states, states_p))

    abs_l, rel_l, rel_s = errs(logits_k, states_k)
    _, floor_l, floor_s = errs(logits_n, states_n)
    tol_l, tol_s = max(TOL_A_PREFILL, 2 * floor_l), max(TOL_A_PREFILL, 2 * floor_s)
    ms = median_ms(torch, lambda: model.prefill(prompt, meta))
    dev_ms = graph_ms(torch, lambda: model.prefill(prompt, meta), calls=1, replays=3)
    forward_ms = cuda_ms(torch, lambda: model(prompt, meta), iters=3, warmup=1)
    parent_txt = "the parent tree's A not measured (no --parent)"
    if parent is not None:
        psk = parent_module(parent, "ssd_kernel", "[4 prefill]")
        turns: dict = {"parent": [], "this": []}
        for _ in range(SSD_TURNS):
            for who in ("parent", "this", "this", "parent"):
                with ssd_scan_as(psk.ssd_scan if who == "parent" else ssd_scan):
                    turns[who].append((median_ms(torch, lambda: model.prefill(prompt, meta)),
                                       graph_ms(torch, lambda: model.prefill(prompt, meta), calls=1, replays=3)))

        def med(who, i):
            vals = [r[i] for r in turns[who] if r[i] is not None]
            return statistics.median(vals) if vals else None

        parent_txt = (f"in {SSD_TURNS} rounds of turns (parent, this, this, parent), medians of the host-paced "
                      f"medians: this tree {med('this', 0):.3f} ms (graph {fmt_ms(med('this', 1))}), the parent "
                      f"tree's A {med('parent', 0):.3f} ms (graph {fmt_ms(med('parent', 1))}); this / parent each "
                      "turn: " + ", ".join(f"{a[0]:.3f} / {b[0]:.3f}" for a, b in zip(turns["this"], turns["parent"])))
    say(f"[4 prefill] (B,T)=({BATCH},{PROMPT}+6): {launches} kernel A launches; against the prefill with the plain "
        f"ssd_chunked: last logits max_abs {abs_l:.3e} rel {rel_l:.3e} (tol {tol_l:.3e}), the {len(states_k)} "
        f"layers' final SSM states rel {rel_s:.3e} (tol {tol_s:.3e}); the plain prefill from x perturbed by 1e-6: "
        f"logits rel {floor_l:.3e}, states rel {floor_s:.3e} (tol = max({TOL_A_PREFILL}, twice these)); prefill "
        f"with kernel A {ms:.3f} ms (median of 5; in a CUDA graph {fmt_ms(dev_ms)}), {parent_txt}; with the plain "
        f"ssd_chunked {plain_ms:.3f} ms, plain forward {forward_ms:.3f} ms")
    need(bool(torch.isfinite(logits_k).all()), "mamba prefill logits are not finite")
    need(launches == model.cfg.n_layers, f"prefill launched kernel A {launches} times")
    need(rel_l <= tol_l and rel_s <= tol_s, "prefill with kernel A disagrees with the plain ssd_chunked")


def phase_decode(torch, model, ctx: dict, report: dict, parent: Path | None = None) -> None:
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops.grammar import field_bucket
    from musicgen_tpu_torch.sample.sampler import init_penalty_state, push_token

    prompt, meta, dims, dp, carry = ctx["prompt"], ctx["meta"], ctx["dims"], ctx["dp"], ctx["carry"]
    phase_prefill(torch, model, ctx, parent)
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
        lib = linear_time(torch, *library[name]) if name in library else NO_LIBRARY
        say(f"[4 {name}] max_abs {worst_abs:.3e} rel {worst_rel:.3e} (tol rel {tol}); "
            f"kernel {ms:.4f} ms (device, CUDA graph: {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, "
            f"bound {costs[name]['bound_ms']:.4f} ms "
            f"({costs[name]['bound_by']}), {lib.text()}")
        need(all(bool(torch.isfinite(a).all()) for a in outs), f"{name}: non-finite output")
        need(worst_rel <= tol, f"{name} disagrees with its plain version")
        report[name] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms, "library_ms": lib.ms, **costs[name]}
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
    teacher = ctx["teacher"]
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


def phase_mixer(torch, ctx: dict, parent: Path | None = None) -> None:
    """[4 mixer_state parent] kernel B's mixer (one block a quarter of a
    (row, head)) against the parent tree's mixer on the same inputs, bit for
    bit over MIXER_REPEATS steps of the state, and both alone, launched
    plainly, host-paced and in a CUDA graph, in turns (parent, this, this,
    parent); [4 edges] kernel B's chain with its programmatic dependent
    launches (KERNEL_OPS: the mixer behind in_proj, out_proj behind the mixer)
    against the same launches without them (SERIAL_OPS): TEACHER_STEPS
    teacher-forced steps and 3 CUDA-graph replays bit for bit (logits and
    both states), and the step in a CUDA graph with and without the edges,
    in turns."""
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops.grammar import field_bucket
    from musicgen_tpu_torch.sample.sampler import init_penalty_state

    dims, dp, carry = ctx["dims"], ctx["dp"], ctx["carry"]
    a_h, d_h = dp["a_h"][0], dp["d_h"][0]
    zx = dk.in_proj_conv_plain(ctx["x"], dp["w_in"][0], dp["conv_w"][0], dp["conv_b"][0], dp["dt_bias"][0],
                               carry[0][0].clone(), dims)
    if parent is None:
        say("[4 mixer_state parent] not measured (no --parent)")
    else:
        pdk = parent_module(parent, "decode_kernel", "[4 mixer_state parent]")
        ss_t, ss_p = carry[1][0].clone(), carry[1][0].clone()
        same = []
        for _ in range(MIXER_REPEATS):
            g_t = dk.mixer_state(zx, a_h, d_h, ss_t, dims)
            g_p = pdk.mixer_state(zx, a_h, d_h, ss_p, dims)
            torch.cuda.synchronize()
            same.append(torch.equal(g_t, g_p) and torch.equal(ss_t, ss_p))
        calls = {"parent": lambda: pdk.mixer_state(zx, a_h, d_h, ss_p, dims),
                 "this tree": lambda: dk.mixer_state(zx, a_h, d_h, ss_t, dims)}
        turns: dict = {}
        for key in ("parent", "this tree", "this tree", "parent"):
            turns.setdefault(key, []).append((cuda_ms(torch, calls[key]), graph_ms(torch, calls[key])))
        blocks = dims.batch * dims.nheads * dk.MIXER_SPLIT
        say(f"[4 mixer_state parent] (R, heads) = ({dims.batch}, {dims.nheads}): {blocks} blocks of a quarter head "
            f"against the parent's; g and the state "
            f"{'bit for bit' if all(same) else 'DIFFER'} over {MIXER_REPEATS} steps ({same}); ms host-paced (CUDA "
            f"graph) in turns: " + "; ".join(f"{k} " + " / ".join(f"{a:.4f} ({fmt_ms(b)})" for a, b in v)
                                            for k, v in turns.items()))
        need(all(same), "mixer_state differs from the parent tree's mixer")

    teacher = ctx["teacher"]
    carry_e, carry_s = clone(carry), clone(carry)
    steps_same = []
    for s in range(TEACHER_STEPS):
        tok = teacher[:, s]
        le = dk.decode_logits(dp, tok, carry_e, dims)
        ls = dk.decode_logits(dp, tok, carry_s, dims, ops=dk.SERIAL_OPS)
        steps_same.append(torch.equal(le, ls) and all(torch.equal(a, b) for a, b in zip(carry_e, carry_s)))
    torch.cuda.synchronize()
    bad = [i for i, ok in enumerate(steps_same) if not ok]
    tok = teacher[:, -1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm = clone(carry_e)
        for _ in range(2):
            dk.decode_logits(dp, tok, warm, dims)
    torch.cuda.current_stream().wait_stream(side)
    carry_h = clone(carry_e)
    graph = torch.cuda.CUDAGraph()
    replays, capture_error = [], None
    try:
        with torch.cuda.graph(graph):
            out = dk.decode_logits(dp, tok, carry_e, dims)
    except RuntimeError as e:
        capture_error = str(e)[:300]
    if capture_error is None:
        for _ in range(3):
            graph.replay()
            ref = dk.decode_logits(dp, tok, carry_h, dims, ops=dk.SERIAL_OPS)
            torch.cuda.synchronize()
            replays.append(torch.equal(out, ref) and all(torch.equal(a, b) for a, b in zip(carry_e, carry_h)))
    pen = init_penalty_state(ctx["prompt"], max(PROMPT, 2048))
    bucket = field_bucket(tok)
    ops = {"edges": dk.KERNEL_OPS, "serial": dk.SERIAL_OPS}
    c_t = clone(carry)
    turns = {}
    for key in ("edges", "serial", "serial", "edges"):
        turns.setdefault(key, []).append(graph_ms(torch, lambda: dk.sample_tail(
            dk.decode_logits(dp, tok, c_t, dims, ops=ops[key]), dp["gram"], pen.hist, bucket, dims), calls=4))
    say(f"[4 edges] kernel B's chain with programmatic dependent launches (the mixer behind in_proj, out_proj behind "
        f"the mixer) against the same launches without them: {TEACHER_STEPS} teacher-forced steps "
        f"{'bit for bit' if not bad else f'DIFFER at steps {bad}'}; CUDA graph of the chain with the edges: "
        + (f"capture failed: {capture_error}" if capture_error else
           f"{len(replays)} replays {'bit for bit' if all(replays) else 'DIFFER'} ({replays})")
        + "; the step with the tail in a CUDA graph in turns: "
        + "; ".join(f"{k} " + " / ".join(fmt_ms(v) for v in vs) for k, vs in turns.items()))
    need(not bad and capture_error is None and len(replays) == 3 and all(replays),
         "kernel B's chain with the dependent launches differs from the chain without them")


def phase_gemv_ragged(torch) -> None:
    """[4 gemv ragged] the bf16 GEMV (decode_ops.cuh gemv_team) against
    _product at shapes no main path takes: a ragged last tile and a K tail
    at (R, K, N) = (3, 1000, 1000) with the plain prologue and a store
    (mg_x_gemv), and 8 rows at (8, 4096, 1016) with the LayerNorm prologue
    and the bias (mg_lm_head_ln), its staged rows past 48 KB of shared
    memory."""
    import dataclasses

    from musicgen_tpu_torch.config import MambaConfig
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops import xdecode_kernel as xk

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    base = dk.DecodeDims.create(MambaConfig(), BATCH)
    for r, k, n in ((3, 1000, 1000), (8, 4096, 1016)):
        x = 2.0 * torch.randn(r, k, device=DEVICE, generator=gen)
        w = (0.03 * torch.randn(n, k, device=DEVICE, generator=gen)).to(torch.bfloat16)
        if r == 3:
            what = "plain prologue, store"
            head = None
        else:
            what = "LayerNorm prologue, bias"
            head = (1.0 + 0.1 * torch.randn(k, device=DEVICE, generator=gen),
                    0.1 * torch.randn(k, device=DEVICE, generator=gen), w,
                    torch.randn(n, device=DEVICE, generator=gen), dataclasses.replace(base, batch=r, d_model=k,
                                                                                     padded_vocab=n))

        def kernel():
            return xk.gemv(x, w, None) if head is None else dk.lm_head_ln(x, *head)

        def plain():
            return dk._product(x, w, None, "none") if head is None else dk.lm_head_ln_plain(x, *head)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        say(f"[4 gemv ragged] (R, K, N) = ({r}, {k}, {n}), {what}: max_abs {err:.3e} rel {rel:.3e} (tol rel "
            f"{TOL_BF16}); kernel (device, CUDA graph) {fmt_ms(graph_ms(torch, kernel))}, "
            f"{linear_time(torch, x, w).text()}")
        need(tuple(out.shape) == (r, n) and bool(torch.isfinite(out).all()), f"ragged GEMV ({r}, {k}, {n}): bad output")
        need(rel <= TOL_BF16, f"the bf16 GEMV at ({r}, {k}, {n}) disagrees with _product")


# [4 sample_tail ...]: the cases the tail is held to beside the main shape,
# as (inputs, rows, V, Vp): one and eight rows, a vocabulary the slices
# cover raggedly (V = Vp = 1,000: slices of 16 ids, slice 62 of 8 and slice
# 63 empty), tied logits, a grammar row that allows fewer than three ids
# (the rest of the top-3 are zero weights, lowest index first; with V < Vp,
# pad ids never beat a real id of equal weight), and window counts past the
# 1.2 cap.
TAIL_CASES = {
    "R=1": ("random", 1, 17914, 17920),
    "R=8": ("random", 8, 17914, 17920),
    "V=1000": ("random", 3, 1000, 1000),
    "V=1001 ties": ("ties", 2, 1001, 1001),
    "ties": ("ties", 2, 17914, 17920),
    "few allowed": ("few_allowed", 2, 17914, 17920),
    "few allowed V<Vp": ("few_allowed", 2, 1000, 1024),
    "window cap": ("window_cap", 2, 17914, 17920),
}
TAIL_REPEATS = 10


def tail_inputs(torch, kind: str, rows: int, v: int, vp: int, seed: int = SEED):
    """(logits (R, Vp), gram (5, Vp), hist (R, V) int32, bucket (R,)) on the
    card for one TAIL_CASES case, seeded numpy as tests/test_torch_tail_plan.py
    makes them; the pad logits are random (the tail must ignore them)."""
    import numpy as np

    from musicgen_tpu_torch.ops.grammar import grammar_mask

    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((rows, vp))).astype(np.float32)
    if v == 17914:
        gram = np.zeros((5, vp), np.float32)
        gram[:, :v] = grammar_mask().numpy()
    else:
        gram = ((rng.random((5, vp)) < 0.6) * rng.integers(1, 4, (5, vp))).astype(np.float32)
        gram[:, v:] = 0.0
    hist = np.zeros((rows, v), np.int32)
    for r in range(rows):
        hit = rng.integers(0, v, v // 10)
        hist[r, hit] = rng.integers(1, 30, len(hit))
    bucket = rng.integers(0, 5, rows)
    if kind == "ties":
        logits = (0.5 * rng.integers(0, 4, (rows, vp))).astype(np.float32)
        hist[:] = 0
    elif kind == "few_allowed":
        gram[0] = 0.0
        gram[0, [v // 2, v - 1]] = 1.0
        gram[1] = 0.0
        gram[1, v // 3] = 2.0
        bucket = np.arange(rows) % 2
    elif kind == "window_cap":
        hist[:] = rng.integers(0, 60, (rows, v))
    return tuple(torch.from_numpy(a).to(DEVICE) for a in (logits, gram, hist, bucket.astype(np.int64)))


def tail_dims(dims, v: int, vp: int):
    """The decode dims of a TAIL_CASES vocabulary (field boundaries at a
    third and two thirds of a small one)."""
    import dataclasses

    if (v, vp) == (dims.vocab_size, dims.padded_vocab):
        return dims
    return dataclasses.replace(dims, vocab_size=v, padded_vocab=vp, dyn_start=v // 3, length_start=2 * v // 3)


def tail_check(torch, dk, tag: str, args, dims) -> tuple:
    """One launch of the tail against its plain version (indices equal,
    values within TOL_F32 of the row's largest) and against the plain
    partition sample_tail_sliced (printed). Returns the kernel's outputs."""
    v_k, i_k = dk.sample_tail(*args, dims)
    v_p, i_p = dk.sample_tail_plain(*args, dims)
    v_s, _ = dk.sample_tail_sliced(*args, dims)
    torch.cuda.synchronize()
    err, rel = rel_err(v_k, v_p)
    same = bool(torch.equal(i_k, i_p))
    say(f"[4 sample_tail {tag}] indices {'equal' if same else 'DIFFER'} to the plain version; "
        f"values max_abs {err:.3e} rel {rel:.3e} (tol rel {TOL_F32}); vs the plain partition max_abs "
        f"{rel_err(v_k, v_s)[0]:.3e}")
    need(same, f"sample_tail {tag}: top-3 indices {i_k.tolist()} vs the plain {i_p.tolist()}")
    need(rel <= TOL_F32 and bool(torch.isfinite(v_k).all()), f"sample_tail {tag} disagrees with its plain version")
    return v_k, i_k


def phase_tail(torch, ctx: dict, parent: Path | None = None) -> None:
    """[4 sample_tail ...] kernel B's tail beyond the main shape of [4
    sample_tail]: fresh inputs at the main shape and each of TAIL_CASES
    against its plain version (kernel C's tail, the same per-slice functions
    spread over its SMs, is held to this one bit for bit by [6 chain]); [4
    sample_tail repeat] the same bits over TAIL_REPEATS launches and over
    CUDA-graph replays; [4 sample_tail time] ms host-paced and in a CUDA
    graph, and with --parent DIR the parent tree's tail in turns, on the same
    inputs."""
    from musicgen_tpu_torch.ops import decode_kernel as dk

    dims = ctx["dims"]
    main = tail_inputs(torch, "random", BATCH, dims.vocab_size, dims.padded_vocab)
    cases = {f"main R={BATCH}": (main, dims), **{tag: (tail_inputs(torch, kind, rows, v, vp), tail_dims(dims, v, vp))
                                                for tag, (kind, rows, v, vp) in TAIL_CASES.items()}}
    for tag, (args, d) in cases.items():
        tail_check(torch, dk, tag, args, d)

    ref = dk.sample_tail(*main, dims)
    same = all(all(torch.equal(a, b) for a, b in zip(dk.sample_tail(*main, dims), ref)) for _ in range(TAIL_REPEATS))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dk.sample_tail(*main, dims)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dk.sample_tail(*main, dims)
    replays = []
    for _ in range(3):
        for t in out:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        replays.append(all(torch.equal(a, b) for a, b in zip(out, ref)))
    say(f"[4 sample_tail repeat] {TAIL_REPEATS} launches {'bit for bit' if same else 'DIFFER'}; CUDA-graph replays "
        f"{'bit for bit' if all(replays) else 'DIFFER'} ({replays})")
    need(same and all(replays), "sample_tail: repeat launches or graph replays differ")

    pdk = parent_module(parent, "decode_kernel", "[4 sample_tail time]") if parent is not None else None
    calls = {"this tree": lambda: dk.sample_tail(*main, dims)}
    order = ["this tree"]
    if pdk is not None:
        calls["parent"] = lambda: pdk.sample_tail(*main, dims)
        order = ["parent", *order]
    turns = {}
    for key in order + order[::-1]:  # parent, this, this, parent
        turns.setdefault(key, []).append((cuda_ms(torch, calls[key]), graph_ms(torch, calls[key])))
    say(f"[4 sample_tail time] (R, Vp) = ({BATCH}, {dims.padded_vocab}), ms host-paced (CUDA graph) in turns: "
        + "; ".join(f"{k} " + " / ".join(f"{a:.4f} ({fmt_ms(b)})" for a, b in v) for k, v in turns.items())
        + ("" if pdk is not None else "; the parent tree's tail not measured (no --parent)"))


# Launches of a kernel on the paths outside its own phase, by kernel and row
# (the sampler tail's on B's, F's and G's CLI runs; H's and G's on [8 cli
# xlstm] and phase 11), each run counted from zero: finish() adds them to the
# count of the kernel's own phase and prints them.
PATH_LAUNCHES: dict = {}


def count_path(name: str, row: str, n: int) -> None:
    rows = PATH_LAUNCHES.setdefault(name, {})
    rows[row] = rows.get(row, 0) + n


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
        if name != "sample_tail":
            report.setdefault(name, {})["launches"] = n
    count_path("sample_tail", "[5 cli] (B)", want["sample_tail"])

    # The generation loop alone, kernels vs plain step, from one prefill.
    ds_items = [np.load(p) for p in sorted((corpus / "Bach").glob("*.npy"))[:BATCH]]
    prompt = torch.from_numpy(np.stack([t[:PROMPT] for t in ds_items])).to(DEVICE)
    meta = torch.zeros(BATCH, 6, dtype=torch.int64, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cfg = sampler.SamplerConfig(num_tokens=LENGTH, ring_size=max(PROMPT, 2048))
    dp = dk.build_decode_params(model, BATCH)
    with torch.no_grad():
        prefill, _ = sampler.make_sampler(model, "mamba", dp)
        logits, carry = prefill(prompt, meta)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.sample_tokens_fused_tail(dp, logits, carry, prompt, cfg, gen,
                                         sampler.fused_tail_step(model, "mamba", BATCH, "bf16"))
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
    inputs of phase 4, then QUANT_STEPS teacher-forced steps per format, with
    the plain chain's own response to a 1e-6 perturbation of the state
    beside them (printed, as in [4 steps]: one activation one int8 level
    apart grows through the ten layers)."""
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
            lib = linear_time(torch, xin, bf16_weights(torch, w, w_s))
            say(f"[4q {name}_{q}] max_abs {worst_abs:.3e} rel {worst_rel:.3e} (tol rel {tol}); "
                f"kernel {ms:.4f} ms (device, CUDA graph: {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, bound "
                f"{cost['bound_ms']:.4f} ms, {lib.text()} on bf16 weights")
            need(bool(torch.isfinite(out_k).all()), f"{name}_{q}: non-finite output")
            need(worst_rel <= tol, f"{name}_{q} disagrees with its plain version")
            report[f"{name}_{q}"] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms, "library_ms": lib.ms,
                                     **cost}

        pen = init_penalty_state(ctx["prompt"], max(PROMPT, 2048))
        carry_k = clone(ctx["carry"])
        noise = torch.Generator(device=DEVICE).manual_seed(SEED)
        worst_logit, worst_state, worst_noise, idx_checked, idx_equal = 0.0, 0.0, 0.0, 0, 0
        for step in range(QUANT_STEPS):
            tok = ctx["teacher"][:, step]
            pen = push_token(pen, tok)
            bucket = field_bucket(tok)
            carry_p, carry_n = clone(carry_k), clone(carry_k)
            carry_n[1].mul_(1.0 + 1e-6 * torch.randn(carry_n[1].shape, device=DEVICE, generator=noise))
            lk = dk.decode_logits(dp, tok, carry_k, dims, quant=q)
            lp = dk.decode_logits(dp, tok, carry_p, dims, ops=dk.PLAIN_OPS, quant=q)
            ln = dk.decode_logits(dp, tok, carry_n, dims, ops=dk.PLAIN_OPS, quant=q)
            worst_noise = max(worst_noise, rel_err(ln[:, :dims.vocab_size], lp[:, :dims.vocab_size])[1])
            vk, ik = dk.sample_tail(lk, dp["gram"], pen.hist, bucket, dims)
            vp, ip = dk.sample_tail_plain(lp, dp["gram"], pen.hist, bucket, dims)
            worst_logit = max(worst_logit, rel_err(lk[:, :dims.vocab_size], lp[:, :dims.vocab_size])[1])
            worst_state = max(worst_state, rel_err(carry_k[0], carry_p[0])[1], rel_err(carry_k[1], carry_p[1])[1])
            checked, equal = top3_agreement(torch, vk, ik, vp, ip)
            idx_checked, idx_equal = idx_checked + checked, idx_equal + equal
        torch.cuda.synchronize()
        say(f"[4q steps_{q}] {QUANT_STEPS} teacher-forced steps from a shared state: logits rel {worst_logit:.3e}, "
            f"states rel {worst_state:.3e} (tol {TOL_STEPS}); top-3 indices equal at {idx_equal}/{idx_checked} "
            f"separated candidates; plain chain from a state perturbed by 1e-6: logits rel {worst_noise:.3e}")
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


def phase_resident(torch, model, ctx: dict, report: dict, quants: dict = QUANTS) -> dict:
    """[6 resident] and [6 chain]: kernel C against its plain version and
    against the per-token kernel chain, in each of `quants`. Returns the
    packs by quant."""
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops import generate_kernel as gk
    from musicgen_tpu_torch.ops.grammar import field_bucket
    from musicgen_tpu_torch.sample.sampler import push_token

    dims = ctx["dims"]
    packs = {quant: dk.build_decode_params(model, BATCH, quant) for quant in quants}
    vals0, idxs0, last0, pen0 = resident_start(torch, ctx)
    n = RESIDENT_CHECK_TOKENS
    for quant, q in quants.items():
        dp, name = packs[quant], f"generate_resident_{'bf16' if q == 'none' else q}"
        carry_r, carry_p = clone(ctx["carry"]), clone(ctx["carry"])
        toks, _, _ = gk.fused_generate(dp, vals0, idxs0, last0, *carry_r, pen0, None, dims, n, True, q)
        torch.cuda.synchronize()
        launch = gk.fused_generate.launch
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
        say(f"[6 resident {quant}] grid {launch['grid']} x {launch['threads']} threads, shared memory "
            f"{launch['dynamic_smem']} + {launch['static_smem']} B a block; {n} greedy tokens: top-1 equal at "
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
    for quant, q in quants.items():
        dp = packs[quant]
        for greedy in (True, False):
            u = None if greedy else torch.rand((CHAIN_TOKENS, BATCH, 2), generator=gen, device=DEVICE)
            carry_r, carry_c = clone(ctx["carry"]), clone(ctx["carry"])
            t0 = time.perf_counter()
            tr, _, _ = gk.fused_generate(dp, vals0, idxs0, last0, *carry_r, pen0, u, dims, CHAIN_TOKENS, greedy, q)
            torch.cuda.synchronize()
            res_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            tc, _, _ = gk.fused_generate_plain(dp, vals0, idxs0, last0, *carry_c, pen0, u, dims, CHAIN_TOKENS, greedy,
                                               q, ops=dk.KERNEL_OPS)
            torch.cuda.synchronize()
            chain_s = time.perf_counter() - t0
            differ = (tr != tc).any(dim=0).nonzero()
            first = int(differ[0]) if len(differ) else -1
            same_states = torch.equal(carry_r[0], carry_c[0]) and torch.equal(carry_r[1], carry_c[1])
            say(f"[6 chain {quant} {'greedy' if greedy else 'sampled'}] {CHAIN_TOKENS} tokens: streams "
                f"{'identical' if first < 0 else f'differ first at token {first}'}; final states "
                f"{'bitwise equal' if same_states else 'differ'} (ssm max_abs {rel_err(carry_r[1], carry_c[1])[0]:.3e}); "
                f"resident {res_s:.3f} s, per-token chain {chain_s:.3f} s")
            need(first < 0 and same_states, f"resident {quant} kernel differs from the per-token kernel chain")
    return packs


def parent_module(parent: Path, name: str, tag: str):
    """ops.<name> of another checkout of the port (`--parent DIR`: a tree
    such as the parent commit's `git archive`, unpacked), imported as the
    package `parent_mtt`: its own build (into DIR/build), launch counters
    and kernels, timed beside this tree's."""
    import importlib
    import importlib.util

    init = parent / "musicgen_tpu_torch" / "__init__.py"
    need(init.exists(), f"--parent {parent}: no musicgen_tpu_torch package there")
    if "parent_mtt" not in sys.modules:
        spec = importlib.util.spec_from_file_location("parent_mtt", init, submodule_search_locations=[str(init.parent)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules["parent_mtt"] = mod
        spec.loader.exec_module(mod)
    module = importlib.import_module(f"parent_mtt.ops.{name}")
    t0 = time.perf_counter()
    importlib.import_module("parent_mtt.ops.build").load_library()
    say(f"{tag} the parent tree's kernels built (or loaded) in {time.perf_counter() - t0:.1f} s from {parent}")
    return module


def phase_loop(torch, ctx: dict, packs: dict, report: dict, parent: Path | None = None) -> None:
    """[6 loop] kernel C in ms a token (host clock around one launch of
    LENGTH stochastic tokens) and its share of the HBM roofline, beside its
    yardstick, kernel B's chain step (32 launches, no pick) in a CUDA graph,
    and, with `--parent DIR`, the parent tree's C on the same inputs, timed
    in LOOP_TURNS rounds of (parent, this, this, parent), each tree's median
    and mean reported; this tree's ms is the median of its runs and its
    device time and idle share come from the same runs. Then tok/s/seq of
    the host-paced per-token kernel chain (sample_tokens_fused_tail) from one
    prefill."""
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops import generate_kernel as gk
    from musicgen_tpu_torch.ops.grammar import field_bucket
    from musicgen_tpu_torch.sample import sampler

    dims = ctx["dims"]
    vals0, idxs0, last0, pen0 = resident_start(torch, ctx)
    pgk = parent_module(parent, "generate_kernel", "[6 loop]") if parent is not None else None
    pdk = parent_module(parent, "decode_kernel", "[6 loop]") if parent is not None else None
    cfg = sampler.SamplerConfig(num_tokens=LENGTH, ring_size=max(PROMPT, 2048))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    bucket = field_bucket(last0)
    for quant, dp in packs.items():
        q = QUANTS[quant]
        weight_bytes = sum(dp[k].numel() * dp[k].element_size()
                           for k in ("w_in", "w_out", "lm_w", "w_in_s", "w_out_s", "lm_s") if k in dp)
        u = torch.rand((LENGTH, BATCH, 2), generator=gen, device=DEVICE)

        def one(mod):
            carry = clone(ctx["carry"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            mod.fused_generate(dp, vals0, idxs0, last0, *carry, pen0, u, dims, LENGTH, False, q)
            end.record()
            torch.cuda.synchronize()
            return time.perf_counter() - t0, start.elapsed_time(end) / 1e3

        if pgk is None:
            this_runs, parent_s = [one(gk)], []
        else:  # LOOP_TURNS rounds of parent, this, this, parent
            this_runs, parent_s = [], []
            for _ in range(LOOP_TURNS):
                p1, t1, t2, p2 = one(pgk), one(gk), one(gk), one(pgk)
                this_runs += [t1, t2]
                parent_s += [p1[0], p2[0]]
        this_s = [r[0] for r in this_runs]
        ms = 1e3 * statistics.median(this_s) / LENGTH
        dev_s = statistics.median(r[1] for r in this_runs)
        idle = max(0.0, 1 - sum(r[1] for r in this_runs) / sum(this_s))
        carry_g = clone(ctx["carry"])

        def step_ms(mod):
            return graph_ms(torch, lambda: mod.fused_sample_step(dp, last0, carry_g, pen0.hist, bucket, dims, quant=q),
                            calls=4)

        if pdk is None:
            step_graph, step_txt = step_ms(dk), ""
        else:  # parent, this, this, parent
            p1, t1, t2, p2 = step_ms(pdk), step_ms(dk), step_ms(dk), step_ms(pdk)
            step_graph = t1
            step_txt = (f" (in turns with the parent tree's: this {fmt_ms(t1)} / {fmt_ms(t2)}, parent "
                        f"{fmt_ms(p1)} / {fmt_ms(p2)})")
        carry = clone(ctx["carry"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.sample_tokens_fused_tail(dp, ctx["logits"], carry, ctx["prompt"], cfg, gen,
                                         sampler.fused_tail_step(ctx["model"], "mamba", BATCH, quant))
        torch.cuda.synchronize()
        chain_s = time.perf_counter() - t0
        share = weight_bytes / HBM_BYTES_PER_S / (ms / 1e3)
        name = f"generate_resident_{'bf16' if q == 'none' else q}"
        per_tok = lambda xs: 1e3 * statistics.fmean(xs) / LENGTH  # noqa: E731
        parent_txt = ("the parent tree's C not measured (no --parent)" if pgk is None else
                      f"the parent tree's C median {1e3 * statistics.median(parent_s) / LENGTH:.4f} ms/token, "
                      f"mean {per_tok(parent_s):.4f} ({' / '.join(f'{1e3 * x / LENGTH:.4f}' for x in parent_s)}); "
                      f"this tree's median {ms:.4f}, mean {per_tok(this_s):.4f} "
                      f"({' / '.join(f'{1e3 * x / LENGTH:.4f}' for x in this_s)}); in {LOOP_TURNS} rounds of "
                      f"parent, this, this, parent")
        say(f"[6 loop {quant}] kernel C: {ms:.4f} ms/token = {1e3 / ms:.1f} tok/s/seq at batch {BATCH} "
            f"(device {dev_s:.3f} s between events for {LENGTH} tokens, median of this tree's {len(this_runs)} runs; "
            f"idle share {idle:.4f} over them); "
            f"weights {weight_bytes} B/token = {weight_bytes / ms / 1e6:.1f} GB/s, {100 * share:.2f}% of the 3.35 TB/s "
            f"roofline (bound {1e3 * weight_bytes / HBM_BYTES_PER_S:.4f} ms); yardstick: kernel B's chain step "
            f"(32 launches, no pick) in a CUDA graph {fmt_ms(step_graph)}{step_txt}; {parent_txt}; per-token kernel chain "
            f"host-paced {LENGTH / chain_s:.1f} tok/s/seq ({1e3 * chain_s / LENGTH:.4f} ms/token)")
        # Per token: the pack's weights stream once (166 MB in bf16 cannot
        # stay in the 50 MB L2 between tokens); the states are not counted.
        n_weights = sum(dp[k].numel() for k in ("w_in", "w_out", "lm_w"))
        report[name].update(ms=ms, **bound(weight_bytes, 2.0 * BATCH * n_weights, BF16_FLOPS))


def phase_cli_resident(torch, model, corpus: Path, meta_path: Path, root: Path, report: dict,
                       int8_only: bool = False, bf16_only: bool = False, resident_only: bool = False) -> None:
    """[6 cli] the CLI with --fused-decode resident (greedy and sampled, two
    bands), resident-int8w, int8 and int8w (one band each; the per-token
    int8 and int8w runs CLI_SHORT tokens, the others LENGTH), and
    sampler.generate(resident=True, quant="int8"), the one resident format
    no CLI value takes: grammar, MIDI and exact launch counts, each run
    counted from zero. int8_only leaves out the bf16 runs, bf16_only the
    int8 ones, resident_only the per-token ones (int8, int8w)."""
    import numpy as np

    from musicgen_tpu_torch.cli import generate as cli
    from musicgen_tpu_torch.midi import extract_midi
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops.grammar import field_bucket, grammar_mask
    from musicgen_tpu_torch.ops.ssd_kernel import ssd_scan
    from musicgen_tpu_torch.sample.sampler import generate

    ckpt = root / "mamba_random.pth"
    if not ckpt.exists():  # saved by [5 cli], which --only int8 does not run
        torch.save(model.state_dict(), ckpt)
    L, mask = model.cfg.n_layers, grammar_mask()

    def per_token(q, n):
        return {f"in_proj_conv_{q}": L * n, "mixer_state": L * n, f"out_proj_rms_{q}": L * n, f"lm_head_ln_{q}": n,
                "sample_tail": n}

    runs = [("resident", True, ["Mozart", "Bach"], LENGTH, {"generate_resident_bf16": 2}),
            ("resident", False, ["Mozart", "Bach"], LENGTH, {"generate_resident_bf16": 2}),
            ("resident-int8w", False, ["Bach"], LENGTH, {"generate_resident_w8a16": 1}),
            ("int8", False, ["Mozart"], CLI_SHORT, per_token("w8a8", CLI_SHORT)),
            ("int8w", False, ["Mozart"], CLI_SHORT, per_token("w8a16", CLI_SHORT))]
    runs = [r for r in runs if ("int8" in r[0] or not int8_only) and ("int8" not in r[0] or not bf16_only)
            and (r[0].startswith("resident") or not resident_only)]
    totals: dict = {}
    for i, (mode, greedy, bands, n_tok, want) in enumerate(runs):
        out = root / f"gen6_{i}"
        argv = ["--model", "mamba", "--ckpt", str(ckpt), "--data", str(corpus), "--metadata", str(meta_path),
                "--composers", ", ".join(bands), "--batch", str(BATCH), "--block-len", str(PROMPT),
                "--length", str(n_tok), "--output", str(out), "--seed", str(SEED + i),
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
            need(st.shape == (BATCH, PROMPT + n_tok), f"{band}: stream shape {st.shape}")
            st = torch.from_numpy(st)
            need(bool((mask[field_bucket(st[:, PROMPT - 1:-1]), st[:, PROMPT:]] > 0).all()),
                 f"--fused-decode {mode}, {band}: a generated token breaks the grammar")
        mids = sorted(out.rglob("generated_*_mamba_*.mid"))
        need(len(mids) == len(bands) * BATCH, f"expected {len(bands) * BATCH} .mid files in {out}")
        for mid in mids:
            need(len(extract_midi(str(mid))) > 0, f"{mid.name} re-extracts with no notes")
        say(f"[6 cli {mode}{' greedy' if greedy else ''}] {len(bands)} band(s) x {n_tok} tokens at batch {BATCH} in "
            f"{secs:.1f} s; grammatical; .mid files re-extract; launches {launches}, ssd_scan {ssd_scan.launches}")
        need(launches == want, f"--fused-decode {mode}: launches {launches}, expected {want}")
        need(ssd_scan.launches == L * len(bands), f"--fused-decode {mode}: ssd_scan launched {ssd_scan.launches}")
        for name, n in want.items():
            if name.startswith(("generate_resident", "in_proj_conv_", "out_proj_rms_", "lm_head_ln_")):
                totals[name] = totals.get(name, 0) + n
        count_path("sample_tail", "[6 cli] (B)", want.get("sample_tail", 0))
    if bf16_only:
        for name, n in totals.items():
            report[name]["launches"] = n
        return
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
        report.setdefault(name, {})["launches"] = n


# [rows]: more batch rows than one decode launch carries (MAX_ROWS = 8): the
# batch and the --fused-decode values of each family's CLI run.
ROWS = {"mamba": (16, ("auto", "resident")), "transformer": (9, ("auto",)), "xlstm": (9, ("auto",))}
ROWS_TOKENS = 64


def batch_slice(torch, tree, j: int):
    """Row j of a model's prefill state (tensors batch first, in dicts,
    lists and tuples), as batch-1 copies."""
    if isinstance(tree, torch.Tensor):
        return tree[j:j + 1].clone()
    if isinstance(tree, dict):
        return {k: batch_slice(torch, v, j) for k, v in tree.items()}
    return type(tree)(batch_slice(torch, v, j) for v in tree)


def rows_launches(model, kind: str, mode: str, groups: int, tokens: int = ROWS_TOKENS) -> tuple[dict, dict]:
    """The launches of one generation of `tokens` tokens in `groups` groups
    of at most 8 rows (or `groups` generations): (the prefill's kernel, its
    count), and the decode kernels' counts by name."""
    t = tokens * groups
    if kind == "mamba":
        L = model.cfg.n_layers
        if mode == "resident":
            return {"ssd_scan": L * groups}, {"generate_resident_bf16": groups}
        return {"ssd_scan": L * groups}, {"in_proj_conv": L * t, "mixer_state": L * t, "out_proj_rms": L * t,
                                          "lm_head_ln": t, "sample_tail": t}
    if kind == "transformer":
        L = model.cfg.n_layer
        return {"flash_relpos": L * groups}, {"t_qkv_ln": L * t, "tdecode_attn": L * t, "t_res": 2 * L * t,
                                              "t_fc_relu": L * t, "lm_head_ln": t, "sample_tail": t}
    n_slstm = len(model.cfg.slstm_at)
    return {"slstm_scan": n_slstm * groups}, {"xlstm_step": t, "sample_tail": t}


def phase_rows(torch, kind: str, model, corpus: Path, meta_path: Path, root: Path) -> None:
    """[rows <kind> <mode>] `cli.generate --model <kind> --batch N --greedy
    --length ROWS_TOKENS` on the card at N = ROWS[kind] (16 or 9): more rows
    than one decode launch carries, so the sampler runs them in groups of
    8. Checks the family's kernels' launches (each group's prefill and
    tokens, none of the plain step), every new token grammatical, and each
    row equal bit for bit to the same row run alone (sampler.generate at
    batch 1, the same prompt, metadata and --fused-decode value) from its
    group's prefill: the decode kernels' arithmetic of a row does not depend
    on the other rows. The prefill itself (cuBLAS products, cuDNN's conv,
    torch's reductions) may round a row otherwise at another batch size, and
    the stack turns one rounding into other greedy tokens within a few steps:
    its last logits at the group's rows against each row prefilled alone are
    printed. Prints the tok/s/seq of sampler.generate at N rows (prefill
    included)."""
    import numpy as np

    from musicgen_tpu_torch.cli import generate as cli
    from musicgen_tpu_torch.data.dataset import TokenDataset
    from musicgen_tpu_torch.ops import attention_kernel as ak
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops.grammar import field_bucket, grammar_mask
    from musicgen_tpu_torch.ops.slstm_kernel import slstm_scan
    from musicgen_tpu_torch.ops.ssd_kernel import ssd_scan
    from musicgen_tpu_torch.sample.sampler import generate

    batch, modes = ROWS[kind]
    groups = -(-batch // dk.MAX_ROWS)
    ckpt = root / f"{kind}_random.pth"
    if not ckpt.exists():
        torch.save(model.state_dict(), ckpt)
    ds = TokenDataset.from_directory(corpus / "Mozart", meta_path, block_len=PROMPT, seed=SEED)
    items = [ds[i % len(ds)] for i in range(batch)]  # the CLI's rows
    src = torch.from_numpy(np.stack([x for x, _, _ in items]).astype(np.int64)).to(DEVICE)
    meta = torch.from_numpy(np.stack([m for _, _, m in items]).astype(np.int64)).to(DEVICE)
    if kind == "transformer":
        src = src[:, -PROMPT:]
    p, mask = src.shape[1], grammar_mask()
    for mode in modes:
        fused, quant, resident = cli._FUSED[mode]
        argv = ["--model", kind, "--ckpt", str(ckpt), "--data", str(corpus), "--metadata", str(meta_path),
                "--composers", "Mozart", "--batch", str(batch), "--block-len", str(PROMPT),
                "--length", str(ROWS_TOKENS), "--output", str(root / f"rows_{kind}_{mode}"), "--seed", str(SEED),
                "--fused-decode", mode, "--greedy"]
        ssd_scan.launches = slstm_scan.launches = 0
        ak.LAUNCHES.clear()
        dk.LAUNCHES.clear()
        streams = torch.from_numpy(cli.main(argv)["Mozart"])
        torch.cuda.synchronize()
        counted = {"ssd_scan": ssd_scan.launches, "slstm_scan": slstm_scan.launches, **ak.LAUNCHES}
        prefill = {k: v for k, v in counted.items() if v}
        launches = dict(dk.LAUNCHES)
        want_prefill, want = rows_launches(model, kind, mode, groups)
        need(streams.shape == (batch, p + ROWS_TOKENS), f"[rows {kind} {mode}] stream shape {tuple(streams.shape)}")
        need(torch.equal(streams[:, :p], src.cpu()), f"[rows {kind} {mode}] the streams do not start with the prompts")
        grammatical = bool((mask[field_bucket(streams[:, p - 1:-1]), streams[:, p:]] > 0).all())

        def one(rows):
            return generate(model, kind, src[rows], meta[rows], ROWS_TOKENS, PROMPT,
                            torch.Generator(device=DEVICE).manual_seed(SEED), greedy=True, fused=fused, quant=quant,
                            resident=resident)

        alone, prefill_rows, prefill_err = [], 0, 0.0
        for g0 in range(0, batch, dk.MAX_ROWS):
            rows = range(g0, min(g0 + dk.MAX_ROWS, batch))
            logits_g, state_g = model.prefill(src[rows.start:rows.stop], meta[rows.start:rows.stop])
            for i in rows:
                own = model.prefill(src[i:i + 1], meta[i:i + 1])[0][:, -1]
                prefill_rows += int(torch.equal(own, logits_g[i - g0:i - g0 + 1, -1]))
                prefill_err = max(prefill_err, float((own - logits_g[i - g0:i - g0 + 1, -1]).abs().max()))
                # The row alone, from its slice of the group's prefill.
                model.prefill = lambda tokens, m, j=i - g0: (logits_g[j:j + 1], batch_slice(torch, state_g, j))
                try:
                    alone.append(one(slice(i, i + 1)).cpu())
                finally:
                    del model.prefill
        differ = (torch.cat(alone) != streams).any(dim=1).nonzero().flatten().tolist()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one(slice(0, batch))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        say(f"[rows {kind} {mode}] cli.generate --batch {batch} --greedy, {ROWS_TOKENS} tokens after a {p}-token "
            f"prompt in {groups} groups: launches {launches}, prefill {prefill}; "
            f"{'grammatical' if grammatical else 'UNGRAMMATICAL'}; rows equal to each row run alone at batch 1 from "
            f"its group's prefill: {batch - len(differ)}/{batch}" + (f" (differ: {differ})" if differ else "")
            + f"; the prefill's last logits at the group's rows against each row prefilled alone: bitwise equal "
            f"{prefill_rows}/{batch}, max_abs {prefill_err:.3e}"
            + f"; sampler.generate at {batch} rows {secs:.3f} s = {ROWS_TOKENS / secs:.1f} tok/s/seq (prefill "
            f"included)")
        need(launches == want and prefill == want_prefill,
             f"[rows {kind} {mode}] launches {launches}, prefill {prefill}; expected {want}, {want_prefill}")
        need(grammatical, f"[rows {kind} {mode}] a generated token breaks the grammar")
        need(not differ, f"[rows {kind} {mode}] rows {differ} differ from the same rows run alone")


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


def flash_inputs(torch, t: int, seed: int):
    """(q, k, v, rel, scale) at the prefill's widths and length t: q, k, v
    head views of one (B, t, 3, 8, 128) projection."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    b, h, d = BATCH, 8, 128
    qkv = torch.randn(b, t, 3, h, d, device=DEVICE, generator=gen)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    rel = torch.randn(h, t, d, device=DEVICE, generator=gen)
    return q, k, v, rel, (h * d) ** -0.5


def phase_t_flash(torch, report: dict) -> None:
    """[7 flash] kernel D against its plain version at the prefill's shape
    (its bf16 staging pass against torch's rounding, bit for bit), timed
    beside SDPA; then at the ragged lengths FLASH_RAGGED_T, where D with its
    LSE output must also give D's output bit for bit."""
    from musicgen_tpu_torch.config import NUM_META
    from musicgen_tpu_torch.ops import attention_kernel as ak

    b, h, t, d = BATCH, 8, PROMPT + 6, 128
    q, k, v, rel, scale = flash_inputs(torch, t, SEED)
    stage = torch.empty((2 * b + 1) * h * t * d, dtype=torch.bfloat16, device=DEVICE)
    out_k = ak._launch_forward(q, k, v, rel, scale, NUM_META, False, stage)[0]
    out_p = ak.flash_relpos_attention_plain(q, k, v, rel, scale)
    torch.cuda.synchronize()
    staged = ak.staging_views(stage, b, h, t)
    want = [x.to(torch.bfloat16).reshape(b * h, t, d) for x in (k, v)] + [rel[:, :t].to(torch.bfloat16)]
    staged_ok = all(torch.equal(x, y) for x, y in zip(staged, want))
    del stage, staged, want
    err, rel_e = rel_err(out_k, out_p)
    need(bool(torch.isfinite(out_k).all()), "flash_relpos: non-finite output")
    ms = cuda_ms(torch, lambda: ak.flash_relpos_attention(q, k, v, rel, scale), iters=20)
    dev_ms = graph_ms(torch, lambda: ak.flash_relpos_attention(q, k, v, rel, scale), calls=8)
    plain_ms = cuda_ms(torch, lambda: ak.flash_relpos_attention_plain(q, k, v, rel, scale), iters=3, warmup=1)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    mask = relpos_mask(torch, qb, rel, scale)  # built outside the timing
    lib = library_time(torch, "SDPA", lambda: torch.nn.functional.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=mask, scale=scale))
    del mask
    pairs = t * (t + 1) // 2 + sum(max(0, 6 - r - 1) for r in range(min(t, 6)))  # visible (row, column) pairs
    cost = bound(nbytes(q, k, v, rel, out_k), 3 * 2.0 * d * pairs * b * h, BF16_FLOPS)
    say(f"[7 flash] (B*H, T, D) = ({b * h}, {t}, {d}): max_abs {err:.3e} rel {rel_e:.3e} (tol rel {TOL_BF16}); "
        f"staged bf16 k, v, rel equal to torch's rounding: {staged_ok}; "
        f"kernel {ms:.4f} ms (device, CUDA graph: {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, "
        f"{lib.text()} (bf16, float mask, mask build not timed), "
        f"bound {cost['bound_ms']:.4f} ms ({cost['bound_by']}, {pairs} visible pairs a head)")
    need(staged_ok, "kernel D's staging pass differs from torch's bf16 rounding")
    need(rel_e <= TOL_BF16, "flash_relpos disagrees with its plain version")
    report["flash_relpos"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib.ms, **cost}
    del q, k, v, rel, qb, kb, vb, out_k, out_p
    for rt in FLASH_RAGGED_T:
        q, k, v, rel, scale = flash_inputs(torch, rt, SEED + rt)
        out0 = ak.flash_relpos_attention(q, k, v, rel, scale)
        out, lse = ak.flash_relpos_attention_lse(q, k, v, rel, scale)
        out_p, lse_p = ak.flash_relpos_attention_plain(q, k, v, rel, scale, with_lse=True)
        torch.cuda.synchronize()
        same = torch.equal(out0, out)
        err, rel_e = rel_err(out, out_p)
        e_lse, r_lse = rel_err(lse, lse_p)
        say(f"[7 flash T={rt}] (B*H, T, D) = ({b * h}, {rt}, {d}): max_abs {err:.3e} rel {rel_e:.3e} (tol rel "
            f"{TOL_BF16}); lse max_abs {e_lse:.3e} rel {r_lse:.3e} (tol {TOL_F32}); D with LSE bit-identical to D "
            f"without it: {same}")
        need(bool(torch.isfinite(out).all()), f"flash_relpos at T={rt}: non-finite output")
        need(same, f"kernel D's output at T={rt} changes when it writes the LSE")
        need(rel_e <= TOL_BF16 and r_lse <= TOL_F32, f"flash_relpos at T={rt} disagrees with its plain version")


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


def phase_t_decode(torch, tctx: dict, report: dict, quants: dict = TQUANTS) -> dict:
    """[7 tdecode] each kernel F launch against its plain twin on the same
    inputs, in each of `quants` (bf16, W8A16), then T_TEACHER_STEPS
    teacher-forced steps from a shared state against the plain twin chain and
    the f32 TransformerLM.step. Returns the packs by quant."""
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
    packs = {quant: tk.build_transformer_decode_params(model, BATCH, quant) for quant in quants}
    c = PROMPT % S
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    embed = next(iter(packs.values()))["embed"]
    x = F.embedding(prompt[:, -1], embed) + 0.1 * torch.randn(BATCH, dm, device=DEVICE, generator=gen)
    for quant, q in quants.items():
        tp = packs[quant]
        sfx = "" if q == "none" else "_w8a16"

        def sc(name):
            return tp[name][0] if name in tp else None

        ck, cp = clone(carry0), clone(carry0)
        zx_k = tk.qkv_ln(x, tp["ln1"][0], tp["w_qkv"][0], ck[2][0], ck[3][0], c, dims, sc("qkv_s"), q)
        zx = tk.qkv_ln_plain(x, tp["ln1"][0], tp["w_qkv"][0], cp[2][0], cp[3][0], c, dims, sc("qkv_s"), q)
        attn_in = (zx, cp[2][0], cp[3][0], tp["rel_ring"][0], cp[0][0], cp[1][0], tp["rel_meta"][0], c, dims)
        a_k, parts_k = tk.attention(*attn_in, partials=True)
        parts = tk.attn_split_plain(*attn_in)
        a, twin = tk.attn_combine_plain(*parts, dims), tk.attention_plain(*attn_in)
        r_k = tk.res(a, tp["w_proj"][0], tp["proj_b"][0], x.clone(), dims, sc("proj_s"), q)
        r = tk.res_plain(a, tp["w_proj"][0], tp["proj_b"][0], x.clone(), dims, sc("proj_s"), q)
        h_k = tk.fc_relu(r, tp["ln2"][0], tp["w_fc"][0], tp["b_fc"][0], dims, sc("fc_s"), q)
        h = tk.fc_relu_plain(r, tp["ln2"][0], tp["w_fc"][0], tp["b_fc"][0], dims, sc("fc_s"), q)
        o_k = tk.res(h, tp["w_out"][0], tp["b_out"][0], r.clone(), dims, sc("out_s"), q)
        o = tk.res_plain(h, tp["w_out"][0], tp["b_out"][0], r.clone(), dims, sc("out_s"), q)
        r_timed, r_timed_plain = r.clone(), r.clone()  # the residuals the timed launches add into
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
            f"t_res{sfx}": (lambda: tk.res(h, tp["w_out"][0], tp["b_out"][0], r_timed, dims, sc("out_s"), q),
                            lambda: tk.res_plain(h, tp["w_out"][0], tp["b_out"][0], r_timed_plain, dims, sc("out_s"),
                                                 q)),
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
            # The partials against the plain splits, the output against the
            # plain combine of the plain partials.
            checks["tdecode_attn"] = ([*parts_k, a_k], [*parts, a], TOL_BF16)
            timers["tdecode_attn"] = (lambda: tk.attention(*attn_in),
                                      lambda: tk.attn_combine_plain(*tk.attn_split_plain(*attn_in), dims))
        for name, (outs, refs, tol) in checks.items():
            errs = [rel_err(a_, b_) for a_, b_ in zip(outs, refs)]
            worst_abs, worst_rel = max(e[0] for e in errs), max(e[1] for e in errs)
            ms = cuda_ms(torch, timers[name][0])
            dev_ms = graph_ms(torch, timers[name][0])
            plain_ms = cuda_ms(torch, timers[name][1], iters=10, warmup=2)
            lib = NO_LIBRARY
            if name in costs:
                xin, cost, w16 = costs[name]
                lib = linear_time(torch, xin, w16)
            else:
                # tdecode_attn. SDPA over the 2054 slots of each (b, h), the
                # rolled BD term in a float mask; the keys, values and mask
                # are built outside the timing.
                u = torch.remainder(torch.arange(S, device=DEVICE) - c - 1, S)
                qh = zx[:, :dm].reshape(BATCH, H, 1, hd).to(torch.bfloat16)
                keys = torch.cat([cp[0][0][:, :6], cp[2][0]], dim=1).reshape(BATCH, 6 + S, H, hd).transpose(1, 2)
                vals = torch.cat([cp[1][0][:, :6], cp[3][0]], dim=1).reshape(BATCH, 6 + S, H, hd).transpose(1, 2)
                rel_rows = torch.cat([tp["rel_meta"][0][:6], tp["rel_ring"][0][u]]).reshape(6 + S, H, hd)
                mask = (torch.einsum("bhd,shd->bhs", qh[:, :, 0].float(), rel_rows.float()) * dims.scale)[:, :, None]
                mask = mask.to(torch.bfloat16)
                lib = library_time(torch, "SDPA", lambda: torch.nn.functional.scaled_dot_product_attention(
                    qh, keys, vals, attn_mask=mask, scale=dims.scale))
                # The rings, rel tables and q read once; the workspace
                # partials and the output written once.
                cost = bound(nbytes(cp[2][0], cp[3][0], tp["rel_ring"][0], cp[0][0], cp[1][0], tp["rel_meta"][0],
                                    *parts_k, a_k) + 4 * BATCH * dm, 3 * 2.0 * hd * (S + 6) * BATCH * H, F32_FLOPS)
            say(f"[7 tdecode {name}] max_abs {worst_abs:.3e} rel {worst_rel:.3e} (tol rel {tol}); kernel {ms:.4f} ms "
                f"(device, CUDA graph: {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, bound {cost['bound_ms']:.4f} ms "
                f"({cost['bound_by']}), {lib.text()}")
            need(all(bool(torch.isfinite(t_).all()) for t_ in outs), f"{name}: non-finite output")
            need(worst_rel <= tol, f"{name} disagrees with its plain version")
            report[name] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms, "library_ms": lib.ms, **cost}
        e_pair = rel_err(a_k, twin)[1]
        say(f"[7 tdecode attention {quant}] tdecode_attn vs the TPU kernel's math (stale-row fix, one softmax): "
            f"rel {e_pair:.3e} (tol {TOL_T_STEP})")
        need(e_pair <= TOL_T_STEP, "kernel F's attention disagrees with the plain twin")
        if q == "none":
            attn_repeat(torch, attn_in)
            attn_ragged(torch, dims)

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
            f"{step_ms:.4f} ms (device, CUDA graph of the step's 42 launches: {fmt_ms(step_dev_ms)}), plain twins "
            f"{plain_step_ms:.4f} ms")
        need(max(worst_twin, worst_ring, worst_val) <= TOL_T_STEP,
             f"{quant} kernel F steps disagree with the plain twin")
        need(idx_equal == idx_checked, f"{quant} kernel F steps picked other top-3 candidates")
        need(worst_f32 <= TOL_T_F32[quant], f"{quant} kernel F steps disagree with TransformerLM.step")
    return packs


def attn_repeat(torch, attn_in) -> None:
    """[7 tdecode_attn repeat] two launches back to back, replays of one
    launch captured in a CUDA graph, and a launch after them give the same
    bits: the block that combines a (batch group, head) resets its ticket."""
    from musicgen_tpu_torch.ops import tdecode_kernel as tk

    first, second = tk.attention(*attn_in), tk.attention(*attn_in)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tk.attention(*attn_in)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tk.attention(*attn_in)
    replays = []
    for _ in range(3):
        graph.replay()
        replays.append(captured.clone())
    after = tk.attention(*attn_in)
    torch.cuda.synchronize()
    same = [torch.equal(first, t) for t in (second, *replays, after)]
    say(f"[7 tdecode_attn repeat] a second launch, 3 CUDA-graph replays and a launch after them bit-identical to "
        f"the first: {same}")
    need(all(same), "tdecode_attn gives other bits on a repeated launch (a ticket was not reset)")


def attn_ragged(torch, dims) -> None:
    """[7 tdecode_attn ragged] the attention at batch 1, 5 and 8 on a ring of
    ATTN_RAGGED_S slots (a ragged last split), the newest slot at each of
    ATTN_RAGGED_C, seeded inputs with ring slot c holding the new K and V as
    the chain leaves it: the partials and output against the plain splits
    and combine (TOL_BF16), the output against the TPU kernel's math
    (TOL_T_STEP); then the wrapper refuses a batch of 9, a head width of 64
    and an f32 ring."""
    import dataclasses

    from musicgen_tpu_torch.ops import tdecode_kernel as tk

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    S, dm = ATTN_RAGGED_S, dims.d_model

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=DEVICE, generator=gen)).to(torch.bfloat16)

    worst_pair = worst_tpu = 0.0
    for b in ATTN_RAGGED_B:
        d = dataclasses.replace(dims, batch=b, ring=S)
        zx = torch.randn(b, 3 * dm, device=DEVICE, generator=gen)
        zx[:, :dm] *= 3.0  # sharp enough that the splits' maxima differ
        ins = [rnd(b, S, dm), rnd(b, S, dm), rnd(S, dm, scale=0.5), rnd(b, tk.META_ROWS, dm),
               rnd(b, tk.META_ROWS, dm), rnd(tk.META_ROWS, dm, scale=0.5)]
        for c in ATTN_RAGGED_C:
            ins[0][:, c], ins[1][:, c] = zx[:, dm:2 * dm].to(torch.bfloat16), zx[:, 2 * dm:].to(torch.bfloat16)
            args = (zx, *ins, c, d)
            out, parts = tk.attention(*args, partials=True)
            parts_p = tk.attn_split_plain(*args)
            out_p, twin = tk.attn_combine_plain(*parts_p, d), tk.attention_plain(*args)
            worst_pair = max(worst_pair, *(rel_err(x, y)[1] for x, y in zip((*parts, out), (*parts_p, out_p))))
            worst_tpu = max(worst_tpu, rel_err(out, twin)[1])
            need(bool(torch.isfinite(out).all()), f"tdecode_attn at batch {b}, c {c}: non-finite output")
    refused = []
    zx9 = torch.zeros(9, 3 * dm, device=DEVICE)
    ring9 = torch.zeros(9, S, dm, dtype=torch.bfloat16, device=DEVICE)
    meta9 = torch.zeros(9, tk.META_ROWS, dm, dtype=torch.bfloat16, device=DEVICE)
    zx1, ring1, rel1, meta1, rel_meta = zx[:1], ins[0][:1], ins[2], ins[3][:1], ins[5]
    d1 = dataclasses.replace(dims, batch=1, ring=S)
    for what, call in (
            ("a batch of 9", lambda: tk.attention(zx9, ring9, ring9, rel1, meta9, meta9, rel_meta, 0,
                                                  dataclasses.replace(d1, batch=9))),
            ("a head width of 64", lambda: tk.attention(zx1, ring1, ring1, rel1, meta1, meta1, rel_meta, 0,
                                                        dataclasses.replace(d1, n_heads=2 * d1.n_heads,
                                                                            head_dim=d1.head_dim // 2))),
            ("an f32 ring", lambda: tk.attention(zx1, ring1.float(), ring1, rel1, meta1, meta1, rel_meta, 0, d1))):
        try:
            call()
        except ValueError:
            refused.append(what)
    torch.cuda.synchronize()
    say(f"[7 tdecode_attn ragged] batch {ATTN_RAGGED_B}, ring {S} (4 splits, the last of {S % tk.ATTN_SPLIT}), "
        f"newest slot {ATTN_RAGGED_C}: vs the plain splits and combine rel {worst_pair:.3e} (tol {TOL_BF16}); vs "
        f"the TPU kernel's math rel {worst_tpu:.3e} (tol {TOL_T_STEP}); refuses {refused}")
    need(worst_pair <= TOL_BF16 and worst_tpu <= TOL_T_STEP, "tdecode_attn disagrees at a ragged shape")
    need(len(refused) == 3, f"tdecode_attn refused only {refused}")


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


def phase_t_cli(torch, tctx: dict, corpus: Path, meta_path: Path, root: Path, report: dict,
                int8_only: bool = False, bf16_only: bool = False) -> None:
    """[7 cli] `--model transformer` through the CLI: --fused-decode auto,
    greedy, stochastic (LENGTH tokens) and int8w (CLI_SHORT), one band each; every new
    token grammatical, the .mid files re-extract, and each run, counted from
    zero, launches kernel D 8 times a prefill and kernel F's 42 launches a
    token. int8_only runs int8w alone, bf16_only the two auto runs."""
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
    runs = [("auto", True, ["Mozart"], LENGTH), ("auto", False, ["Bach"], LENGTH), ("int8w", False, ["Bach"], CLI_SHORT)]
    runs = [r for r in runs if ("int8" in r[0] or not int8_only) and ("int8" not in r[0] or not bf16_only)]
    totals: dict = {}
    for i, (mode, greedy, bands, n_tok) in enumerate(runs):
        out = root / f"gen7_{i}"
        argv = ["--model", "transformer", "--ckpt", str(ckpt), "--data", str(corpus), "--metadata", str(meta_path),
                "--composers", ", ".join(bands), "--batch", str(BATCH), "--block-len", str(PROMPT),
                "--length", str(n_tok), "--output", str(out), "--seed", str(SEED + i),
                "--fused-decode", mode] + (["--greedy"] if greedy else [])
        n = len(bands)
        sfx = "_w8a16" if mode == "int8w" else ""
        want = {f"t_qkv_ln{sfx}": L * n_tok * n, "tdecode_attn": L * n_tok * n, f"t_res{sfx}": 2 * L * n_tok * n,
                f"t_fc_relu{sfx}": L * n_tok * n, f"lm_head_ln{sfx}": n_tok * n, "sample_tail": n_tok * n}
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
            need(st.shape == (BATCH, PROMPT + n_tok), f"{band}: stream shape {st.shape}")
            st = torch.from_numpy(st)
            need(bool((mask[field_bucket(st[:, PROMPT - 1:-1]), st[:, PROMPT:]] > 0).all()),
                 f"--model transformer --fused-decode {mode}, {band}: a generated token breaks the grammar")
        mids = sorted(out.rglob("generated_*_transformer_*.mid"))
        need(len(mids) == n * BATCH, f"expected {n * BATCH} .mid files in {out}")
        for mid in mids:
            need(len(extract_midi(str(mid))) > 0, f"{mid.name} re-extracts with no notes")
        per_token = sum(launches.values()) / (n_tok * n)
        say(f"[7 cli {mode}{' greedy' if greedy else ''}] {n} band(s) x {n_tok} tokens at batch {BATCH} after a "
            f"{PROMPT}-token prompt in {secs:.1f} s; grammatical; .mid files re-extract; kernel D {flash} launches "
            f"({L} a prefill); kernel F {per_token:g} launches a token: {launches}")
        need(launches == want, f"--model transformer --fused-decode {mode}: launches {launches}, expected {want}")
        need(flash == L * n and ssd_scan.launches == 0, f"--fused-decode {mode}: kernel D launched {flash} times")
        for name, cnt in {**want, "flash_relpos": flash}.items():
            if name in report and not name.startswith(("lm_head_ln", "sample_tail")):
                totals[name] = totals.get(name, 0) + cnt
        count_path("sample_tail", "[7 cli] (F)", want["sample_tail"])
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
    for quant, tp in packs.items():
        q = TQUANTS[quant]
        prefill, _ = sampler.make_sampler(model, "transformer", tp, quant, PROMPT)
        logits, carry = prefill(prompt, meta)
        per_token = nbytes(*(tp[k] for k in ("w_qkv", "w_proj", "w_fc", "w_out", "lm_w", "rel_ring", "rel_meta",
                                             "qkv_s", "proj_s", "fc_s", "out_s", "lm_s") if k in tp), *carry)

        def step(pack, token, state, hist, bucket, stream_idx):
            return tk.fused_transformer_sample_step(pack, token, state, hist, bucket, dims, stream_idx, q)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        sampler.sample_tokens_fused_tail(tp, logits, carry, prompt, cfg, gen, step)
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


def flash_bwd_inputs(torch, b: int, t: int, seed: int):
    """(q, k, v, rel, dout, scale) at the training widths (8 heads of 128),
    q, k, v head views of one (b, t, 3, 8, 128) projection."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    h, d = 8, 128
    qkv = torch.randn(b, t, 3, h, d, device=DEVICE, generator=gen)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    rel = torch.randn(h, t, d, device=DEVICE, generator=gen)
    dout = torch.randn(b, h, t, d, device=DEVICE, generator=gen)
    return q, k, v, rel, dout, (h * d) ** -0.5


def e_launch_checks(torch, ak, args, out, lse, grads_p) -> dict:
    """Each of kernel E's launches against its plain version on the same
    inputs: the staging buffer bit for bit against torch's bf16 rounding and
    delta within TOL_F32; dQ, dK, dV; E3's slots (from the launch's own
    delta); the combine bit for bit against its plain version on the
    launch's slots, and drel. Returns {launch: (max_abs, rel)}."""
    q, k, v, rel, dout, scale = args
    b, h, t, _ = q.shape
    launch = ak.BackwardLaunch(q, k, v, rel, out, lse, dout, scale)
    launch.run()
    stage_p, delta_p = ak.bwd_stage_plain(q, k, v, rel, out, dout)
    slots_p = ak.drel_slots_plain(q, k, v, rel, lse, dout, launch.delta, scale)
    torch.cuda.synchronize()
    staged = torch.equal(launch.stage_buf, stage_p)
    comb_same = torch.equal(launch.drel_, ak.drel_combine_plain(launch.slots, t, rel.shape[1]))
    dkv = max(rel_err(launch.dk_, grads_p[1]), rel_err(launch.dv_, grads_p[2]), key=lambda e: e[1])
    errs = {"flash_bwd_stage": rel_err(launch.delta, delta_p), "flash_bwd_dq": rel_err(launch.dq_, grads_p[0]),
            "flash_bwd_dkv": dkv, "flash_bwd_drel": rel_err(launch.slots, slots_p),
            "flash_bwd_drel_combine": rel_err(launch.drel_, grads_p[3])}
    say(f"    launches at (B, H, T) = ({b}, {h}, {t}): staged bf16 q, k, v, dO, rel equal to torch's rounding: "
        f"{staged}; combine equal to its plain version on the same slots: {comb_same}; "
        + ", ".join(f"{n.removeprefix('flash_bwd_')} max_abs {e:.3e} rel {r:.3e}" for n, (e, r) in errs.items())
        + f" (tol rel: delta {TOL_F32}, the rest {TOL_BF16})")
    need(staged, f"kernel E's stage launch differs from torch's bf16 rounding at T={t}")
    need(comb_same, f"kernel E's combine differs from its plain version at T={t}")
    need(errs["flash_bwd_stage"][1] <= TOL_F32, f"kernel E's delta disagrees with the plain version at T={t}")
    need(all(r <= TOL_BF16 for n, (_, r) in errs.items() if n != "flash_bwd_stage"),
         f"a launch of kernel E disagrees with its plain version at T={t}")
    return errs


def phase_flash_bwd_ragged(torch) -> None:
    """[8 flash-bwd T=..] kernel E at the ragged lengths FLASH_RAGGED_T and
    batches FLASH_BWD_RAGGED_B, H = 8: every gradient and every launch
    against its plain version."""
    from musicgen_tpu_torch.ops import attention_kernel as ak

    for rt in FLASH_RAGGED_T:
        for rb in FLASH_BWD_RAGGED_B:
            args = flash_bwd_inputs(torch, rb, rt, SEED + 100 * rb + rt)
            q, k, v, rel, dout, scale = args
            out, lse = ak.flash_relpos_attention_lse(q, k, v, rel, scale)
            grads = ak.flash_relpos_attention_bwd(q, k, v, rel, out, lse, dout, scale)
            grads_p = ak.flash_relpos_attention_bwd_plain(q, k, v, rel, out, lse, dout, scale)
            torch.cuda.synchronize()
            errs = {n: rel_err(g, gp) for n, g, gp in zip(("dq", "dk", "dv", "drel"), grads, grads_p)}
            say(f"[8 flash-bwd T={rt} B={rb}] (B*H, T, D) = ({rb * 8}, {rt}, 128): "
                + ", ".join(f"{n} max_abs {e:.3e} rel {r:.3e}" for n, (e, r) in errs.items())
                + f" (tol rel {TOL_BF16})")
            need(all(bool(torch.isfinite(g).all()) for g in grads), f"kernel E at T={rt} B={rb}: non-finite output")
            need(all(r <= TOL_BF16 for _, r in errs.values()), f"kernel E at T={rt} B={rb} disagrees with its plain "
                 "version")
            e_launch_checks(torch, ak, args, out, lse, grads_p)


def phase_flash_bwd_repeat(torch, ak, args, out, lse) -> None:
    """[8 flash-bwd repeat] kernel E's four gradients bit for bit on a
    second call and on two replays of a CUDA graph of one call."""
    q, k, v, rel, dout, scale = args
    first = [g.clone() for g in ak.flash_relpos_attention_bwd(q, k, v, rel, out, lse, dout, scale)]
    second = ak.flash_relpos_attention_bwd(q, k, v, rel, out, lse, dout, scale)
    launch = ak.BackwardLaunch(q, k, v, rel, out, lse, dout, scale)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch.run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch.run()
    replays = []
    for _ in range(2):
        for x in (launch.dq_, launch.dk_, launch.dv_, launch.drel_, launch.slots):
            x.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        replays.append([g.clone() for g in launch.grads()])
    same_call = all(torch.equal(a, b_) for a, b_ in zip(first, second))
    same_graph = all(torch.equal(a, b_) for r in replays for a, b_ in zip(first, r))
    say(f"[8 flash-bwd repeat] dq, dk, dv, drel bit for bit on a second call: {same_call}; on two CUDA-graph "
        f"replays (outputs set to NaN before each): {same_graph}")
    need(same_call and same_graph, "kernel E's gradients change between calls or graph replays")
    del graph, launch


def phase_flash_bwd(torch, report: dict) -> None:
    """[8 flash-bwd] kernel D's LSE output and kernel E against their plain
    versions at the training shape, each of E's launches on the same inputs
    as its plain version; the autograd round trip against the f32 attention;
    [8 flash-bwd repeat]; D with LSE's, each E launch's and E's times beside
    the bound, the plain versions, SDPA's forward or backward and the whole
    library path of E's function; then the ragged lengths."""
    import torch.nn.functional as F

    from musicgen_tpu_torch.ops import attention_kernel as ak
    from musicgen_tpu_torch.ops.attention import relpos_attention

    b, h, t, d = BATCH, 8, PROMPT + 6, 128
    args = flash_bwd_inputs(torch, b, t, SEED + 8)
    q, k, v, rel, dout, scale = args
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
        targs = [x.detach().clone().requires_grad_() for x in (q, k, v, rel)]
        g_train = torch.autograd.grad(ak.flash_relpos_attention_train(*targs, scale), targs, dout)
        g_f32 = torch.autograd.grad(relpos_attention(*targs, scale), targs, dout)
    r_train = max(rel_err(a, b_)[1] for a, b_ in zip(g_train, g_f32))
    del g_train, g_f32, targs
    say(f"[8 flash-bwd] (B*H, T, D) = ({b * h}, {t}, {d}): D with LSE bit-identical to D without it: {same}; out "
        f"rel {r_out:.3e}, lse max_abs {e_lse:.3e} rel {r_lse:.3e} vs the plain version (tol {TOL_BF16}, {TOL_F32}); "
        f"E vs its plain version: " + ", ".join(f"{n} max_abs {e:.3e} rel {r:.3e}" for n, (e, r) in errs.items())
        + f" (tol rel {TOL_BF16}); train round trip vs torch.autograd through the f32 attention rel {r_train:.3e} "
        f"(tol {TOL_TRAIN_F32})")
    need(same, "kernel D's output changes when it writes the LSE")
    need(r_out <= TOL_BF16 and r_lse <= TOL_F32, "kernel D with LSE disagrees with its plain version")
    launch_errs = e_launch_checks(torch, ak, args, out, lse, grads_p)  # says which launch is off, if one is
    need(all(r <= TOL_BF16 for _, r in errs.values()), "kernel E disagrees with its plain version")
    need(r_train <= TOL_TRAIN_F32, "flash_relpos_attention_train disagrees with the f32 attention's gradients")
    del grads_p
    phase_flash_bwd_repeat(torch, ak, args, out, lse)

    launch = ak.BackwardLaunch(q, k, v, rel, out, lse, dout, scale)
    runs = {"flash_bwd_stage": launch.stage, "flash_bwd_dq": launch.dq, "flash_bwd_dkv": launch.dkv,
            "flash_bwd_drel": launch.drel, "flash_bwd_drel_combine": launch.combine,
            "E": lambda: ak.flash_relpos_attention_bwd(q, k, v, rel, out, lse, dout, scale),
            "flash_relpos_lse": lambda: ak.flash_relpos_attention_lse(q, k, v, rel, scale)}
    launch.run()
    ms = {n: cuda_ms(torch, fn, iters=10, warmup=2) for n, fn in runs.items()}
    dev_ms = {n: graph_ms(torch, fn, calls=5) for n, fn in runs.items()}
    plain_bwd_ms = cuda_ms(torch, lambda: ak.flash_relpos_attention_bwd_plain(q, k, v, rel, out_p, lse_p, dout,
                                                                              scale), iters=2, warmup=1)
    plain_ms = {
        "flash_bwd_stage": cuda_ms(torch, lambda: ak.bwd_stage_plain(q, k, v, rel, out, dout), iters=5, warmup=1),
        "flash_bwd_dq": plain_bwd_ms, "flash_bwd_dkv": plain_bwd_ms, "E": plain_bwd_ms,
        "flash_bwd_drel": cuda_ms(torch, lambda: ak.drel_slots_plain(q, k, v, rel, lse, dout, launch.delta, scale),
                                  iters=1, warmup=1),
        "flash_bwd_drel_combine": cuda_ms(torch, lambda: ak.drel_combine_plain(launch.slots, t, rel.shape[1]),
                                          iters=5, warmup=1),
        "flash_relpos_lse": cuda_ms(torch, lambda: ak.flash_relpos_attention_plain(q, k, v, rel, scale,
                                                                                   with_lse=True), iters=3, warmup=1)}
    # SDPA in bf16 with the BD term in a float mask that requires grad; the
    # mask is built, and (host-paced) the forward run, outside the timing.
    # The backward's graph time is that of a graph of forward and backward
    # less the forward's: a captured backward needs its forward captured too.
    # The whole library path of E's function adds to that backward dmask
    # turned into dQ's band term and dRel: dBD = dmask * scale unsheared to
    # (B, H, T, T) in bf16, then two einsums.
    qb, kb, vb = (x.to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    mask = relpos_mask(torch, qb.detach(), rel, scale).requires_grad_()
    lib_fwd = library_time(torch, "SDPA forward",
                           lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask, scale=scale))
    with torch.enable_grad():
        o_lib = F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask, scale=scale)
    do_lib = dout.to(torch.bfloat16)
    lib_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(o_lib, (qb, kb, vb, mask), do_lib, retain_graph=True),
                         iters=5, warmup=2)
    del o_lib
    ti = torch.arange(t, device=DEVICE)
    src = (ti[None, :] + ti[:, None] - (t - 1)).expand(b, h, t, t)  # [t, i] -> s, as the plain backward
    keep = src >= 0
    src = src.clamp(min=0)
    rel_b, q_b = rel[:, :t].to(torch.bfloat16), q.to(torch.bfloat16)

    def band_terms(dmask):
        band = torch.where(keep, torch.gather(dmask * scale, -1, src), 0.0)
        return torch.einsum("bhti,hid->bhtd", band, rel_b), torch.einsum("bhti,bhtd->hid", band, q_b)

    def lib_fwd_bwd(full: bool):
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask, scale=scale)
            g = torch.autograd.grad(o, (qb, kb, vb, mask), do_lib)
        return band_terms(g[3]) if full else g

    fb_graph = graph_ms(torch, lambda: lib_fwd_bwd(False), calls=3)
    full_graph = graph_ms(torch, lambda: lib_fwd_bwd(True), calls=3)
    g_lib = lib_fwd_bwd(False)
    full_ms = lib_bwd_ms + cuda_ms(torch, lambda: band_terms(g_lib[3]), iters=3, warmup=1)
    del g_lib
    minus_fwd = (lambda x: None if x is None or lib_fwd.graph is None else x - lib_fwd.graph)
    lib_bwd = LibTime("SDPA backward (dq, dk, dv, dmask)", lib_bwd_ms, minus_fwd(fb_graph))
    lib_full = LibTime("library path (SDPA backward + dmask to dQ's band term and dRel)", full_ms,
                       minus_fwd(full_graph))
    del mask, qb, kb, vb, do_lib, src, keep

    pairs = t * (t + 1) // 2 + sum(max(0, 6 - r - 1) for r in range(min(t, 6)))  # visible pairs a head
    per_product = 2.0 * d * pairs * b * h
    staged_in = nbytes(launch.stage_buf, lse, launch.delta)
    # Products a visible pair: E1 AC BD dp dS.K dP_band.Band, E2 AC BD dp dV dK, E3 AC BD dp dRel; E at least 8.
    cost = {
        "E": bound(nbytes(q, k, v, rel, out, dout, lse, *grads), 8 * per_product, BF16_FLOPS),
        "flash_bwd_stage": bound(nbytes(q, k, v, dout, out, rel, launch.stage_buf, launch.delta), 0, BF16_FLOPS),
        "flash_bwd_dq": bound(staged_in + nbytes(launch.dq_), 5 * per_product, BF16_FLOPS),
        "flash_bwd_dkv": bound(staged_in + nbytes(launch.dk_, launch.dv_), 5 * per_product, BF16_FLOPS),
        "flash_bwd_drel": bound(staged_in + nbytes(launch.slots), 4 * per_product, BF16_FLOPS),
        "flash_bwd_drel_combine": bound(nbytes(launch.slots, launch.drel_), 0, BF16_FLOPS),
        "flash_relpos_lse": bound(nbytes(q, k, v, rel, out, lse), 3 * per_product, BF16_FLOPS),
    }
    labels = {"flash_bwd_stage": "E stage", "flash_bwd_dq": "E1 dQ", "flash_bwd_dkv": "E2 dK+dV",
              "flash_bwd_drel": "E3 dRel slots", "flash_bwd_drel_combine": "E combine", "E": "E, all five",
              "flash_relpos_lse": "D with LSE"}
    # No single library call computes one of E's launches alone: only D with
    # LSE and E as a whole are set beside SDPA.
    for n, label in labels.items():
        lib = {"flash_relpos_lse": f", {lib_fwd.text()} (bf16, float mask)",
               "E": f", {lib_bwd.text()} (bf16, float mask), {lib_full.text()}"}.get(n, f", {NO_LIBRARY.text()}")
        say(f"[8 flash-bwd {label}] kernel {ms[n]:.4f} ms (device, CUDA graph: {fmt_ms(dev_ms[n])}), bound "
            f"{cost[n]['bound_ms']:.4f} ms ({cost[n]['bound_by']}), plain {plain_ms[n]:.4f} ms{lib}")
    report["flash_relpos_lse"] = {"max_abs_err": max(e_out, e_lse), "ms": ms["flash_relpos_lse"],
                                  "plain_ms": plain_ms["flash_relpos_lse"], "library_ms": lib_fwd.ms,
                                  **cost["flash_relpos_lse"]}
    for n in E_LAUNCHES:
        report[n] = {"max_abs_err": launch_errs[n][0], "ms": ms[n], "plain_ms": plain_ms[n], "library_ms": None,
                     **cost[n]}
    del launch, grads, out_p, lse_p
    torch.cuda.empty_cache()
    phase_flash_bwd_ragged(torch)


def train_batch(torch, corpus: Path, meta_path: Path):
    """One (BATCH, PROMPT) training batch (src, trg, meta) from the corpus."""
    import numpy as np

    from musicgen_tpu_torch.data.dataset import TokenDataset

    ds = TokenDataset.from_directory(corpus, meta_path, block_len=PROMPT, crop="start", seed=SEED)
    items = [ds[i] for i in range(BATCH)]
    return tuple(torch.from_numpy(np.stack(x).astype(np.int64)).to(DEVICE) for x in zip(*items))


def phase_grad(torch, corpus: Path, meta_path: Path, dtype: str = "f32") -> None:
    """[8 grad] (f32) and [8 grad bf16] (the bf16 compute dtype of cli.train
    --bf16, D and E on bf16 activations upcast around them): the full-width
    Transformer's loss and every parameter's gradient through kernels D and
    E against the same model with their plain versions on the card; the
    plain attention's (f32, or bf16 with its softmax in f32) beside it."""
    from musicgen_tpu_torch.config import TransformerConfig
    from musicgen_tpu_torch.models.transformer import empty_model, init_weights_
    from musicgen_tpu_torch.ops import attention_kernel as ak
    from musicgen_tpu_torch.train.loss import filtered_cross_entropy

    model = init_weights_(empty_model(TransformerConfig(dropout=0.0), DEVICE, DTYPES[dtype](torch)), SEED)
    src, trg, meta = train_batch(torch, corpus, meta_path)
    row, tol_loss, tol_grad = ("8 grad", TOL_LOSS, TOL_GRAD) if dtype == "f32" else \
        (f"8 grad {dtype}", TOL_LOSS_BF16, TOL_GRAD_BF16)

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
    want = {"flash_relpos_lse": L, **dict.fromkeys(E_LAUNCHES, L)}
    say(f"[{row}] TransformerLM full width, {dtype} compute, dropout 0, (B, T) = ({BATCH}, {PROMPT}): loss "
        f"{loss_k:.6f} through D+E, {loss_p:.6f} through their plain versions (rel "
        f"{abs(loss_k - loss_p) / abs(loss_p):.3e}, tol {tol_loss}); worst gradient vs the plain versions rel "
        f"{w_plain[0]:.3e} at {w_plain[1]} (tol {tol_grad}; outside rel_pos_emb {w_plain_rest[0]:.3e} at "
        f"{w_plain_rest[1]}); as information, vs the plain {dtype} attention: loss {loss_x:.6f}, worst gradient "
        f"rel {w_f32[0]:.3e} at {w_f32[1]}; launches a step {launches}")
    need(abs(loss_k - loss_p) <= tol_loss * abs(loss_p), f"{row}: the loss through D+E disagrees with the plain "
                                                         f"versions'")
    need(w_plain[0] <= tol_grad, f"{row}: a gradient through D+E disagrees with the plain versions'")
    need(all(g.dtype == torch.float32 for g in g_k.values()), f"{row}: a gradient is not f32")
    need(launches == want, f"{row}: a training step launched {launches}, expected {want}")


def phase_train_steps(torch, corpus: Path, meta_path: Path, families=("transformer", "mamba", "xlstm"),
                      dtypes=("f32", "bf16")) -> dict:
    """[8 steps <family>] and [8 steps <family> bf16]: TRAIN_STEPS Adam steps
    (X_TRAIN_STEPS for the xLSTM)
    of each of `families` at full width on one batch, in each compute dtype
    of `dtypes` (bf16: cli.train --bf16, f32 parameters and Adam state): the
    loss falls at every step. Returns ms/step by (family, dtype). An xLSTM
    trains through its plain scans (kernel H has no backward), so its steps
    launch nothing."""
    from musicgen_tpu_torch.config import MambaConfig, TransformerConfig, XLSTMConfig
    from musicgen_tpu_torch.models import mamba, transformer, xlstm
    from musicgen_tpu_torch.ops import attention_kernel as ak
    from musicgen_tpu_torch.ops.slstm_kernel import slstm_scan
    from musicgen_tpu_torch.ops.ssd_kernel import ssd_scan
    from musicgen_tpu_torch.train import trainer as T

    batch = train_batch(torch, corpus, meta_path)
    out = {}
    for (family, module, cfg), dtype in itertools.product(
            (("transformer", transformer, TransformerConfig(dropout=0.0)), ("mamba", mamba, MambaConfig()),
             ("xlstm", xlstm, XLSTMConfig(**X_TRAIN_DEPTH))), dtypes):
        if family not in families:
            continue
        row = family if dtype == "f32" else f"{family} {dtype}"
        n_steps = X_TRAIN_STEPS if family == "xlstm" else TRAIN_STEPS
        model = module.init_weights_(module.empty_model(cfg, DEVICE, DTYPES[dtype](torch)), SEED)
        step = T.make_lm_train_step(model, T.make_optimizer(model))
        ak.LAUNCHES.clear()
        ssd_scan.launches = slstm_scan.launches = 0
        torch.cuda.reset_peak_memory_stats()
        losses, secs = [], []
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(*batch)))
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        launches = {**ak.LAUNCHES, **({"ssd_scan": ssd_scan.launches} if ssd_scan.launches else {}),
                    **({"slstm_scan": slstm_scan.launches} if slstm_scan.launches else {})}
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
            plain = (f"; with the plain {dtype} attention {1e3 * statistics.median(plain_secs[1:]):.2f} ms/step "
                     f"(steps {n_steps + 2}-{n_steps + 3})")
        say(f"[8 steps {row}] {n_steps} Adam steps on one ({BATCH}, {PROMPT}) batch: losses "
            f"{[round(x, 5) for x in losses]}; {ms:.2f} ms/step (median of steps 2-{n_steps}, host clock around a "
            f"synchronised step), {tokens / (ms / 1e3):.1f} train tokens/s; peak memory {peak / 2**30:.2f} GiB; "
            f"launches {launches}{plain}")
        need(all(math.isfinite(x) for x in losses), f"{row}: a loss is not finite")
        need(all(b_ < a for a, b_ in zip(losses, losses[1:])), f"{row}: the loss did not fall at every step")
        need(all(p.dtype == torch.float32 for p in model.parameters()), f"{row}: a parameter is not f32")
        L = getattr(cfg, "n_layer", 0)
        want = {"flash_relpos_lse": L * n_steps, **dict.fromkeys(E_LAUNCHES, L * n_steps)} \
            if family == "transformer" else {}
        need(launches == want, f"{row}: {n_steps} steps launched {launches}, expected {want}")
        out[family, dtype] = {"ms": ms, "tokens_per_s": tokens / (ms / 1e3), "peak_bytes": peak}
        del model, step
        torch.cuda.empty_cache()
    return out


def phase_train_cli(torch, corpus: Path, meta_path: Path, root: Path, report: dict,
                    families=("transformer", "mamba", "xlstm"), dtypes=("f32", "bf16")) -> None:
    """[8 cli <family>] and [8 cli <family> bf16]: `cli.train` (with --bf16
    for the second) for each of `families` at full width (TRAIN_EPOCHS
    epochs, batch 2, block 2048; the xLSTM's block X_TRAIN_CLI_BLOCK) on the
    synthesized corpus, each run counted from zero: a checkpoint directory of
    f32 weights,
    exact launch counts (D with LSE and E 8 times a train step and D 8 times
    a validation step for the Transformer; H 4 times a validation step for
    the xLSTM, whose train steps run the plain scan; nothing for Mamba), then
    `cli.generate --ckpt <dir>/model.pth` from it (the xLSTM's through H's 4
    prefill launches and G's step and B's tail once a token). Each train
    step is timed with a synchronise around it."""
    from musicgen_tpu_torch.cli import generate as gen_cli
    from musicgen_tpu_torch.cli import train as train_cli
    from musicgen_tpu_torch.ops import attention_kernel as ak
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops import xdecode_kernel as xk
    from musicgen_tpu_torch.ops.grammar import field_bucket, grammar_mask
    from musicgen_tpu_torch.ops.slstm_kernel import slstm_scan
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
    full_xlstm = train_cli.DEFAULT_CONFIGS["xlstm"]
    train_cli.DEFAULT_CONFIGS["xlstm"] = lambda: full_xlstm(**X_TRAIN_DEPTH)
    try:
        for family, dtype in itertools.product(families, dtypes):
            row = family if dtype == "f32" else f"{family} {dtype}"
            tag = row.replace(" ", "_")
            ckpt_dir = root / f"train8_{tag}"
            block = X_TRAIN_CLI_BLOCK if family == "xlstm" else PROMPT
            argv = ["--model", family, "--data", str(corpus), "--metadata", str(meta_path), "--ckpt-dir",
                    str(ckpt_dir), "--log", str(root / f"train8_{tag}.json"), "--epochs", str(TRAIN_EPOCHS),
                    "--batch-size", str(BATCH), "--block-len", str(block), "--seed", str(SEED), "--device", DEVICE,
                    *(["--bf16"] if dtype == "bf16" else [])]
            step_secs.clear()
            ak.LAUNCHES.clear()
            dk.LAUNCHES.clear()
            ssd_scan.launches = slstm_scan.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state = train_cli.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            launches = {**ak.LAUNCHES, **dk.LAUNCHES, **({"ssd_scan": ssd_scan.launches} if ssd_scan.launches else {}),
                        **({"slstm_scan": slstm_scan.launches} if slstm_scan.launches else {})}
            n_steps, L = state.step, getattr(state.model.cfg, "n_layer", 0)
            trained_cfg = state.model.cfg
            need(state.model.dtype == DTYPES[dtype](torch), f"{row}: the model computes in {state.model.dtype}")
            n_slstm = len(getattr(trained_cfg, "slstm_at", ()))
            del state
            torch.cuda.empty_cache()
            saved = sorted(ckpt_dir.iterdir())
            need(len(saved) == 1 and sorted(p.name for p in saved[0].iterdir()) == ["model.pth", "optimizer.pth"],
                 f"{row}: checkpoint directory {[p.name for p in saved]}")
            sd = torch.load(saved[0] / "model.pth", map_location="cpu", weights_only=True)
            need(all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point()),
                 f"{row}: the checkpoint holds a tensor that is not f32")
            del sd
            want = {}
            if family == "transformer":
                want = {"flash_relpos_lse": L * n_steps, **dict.fromkeys(E_LAUNCHES, L * n_steps),
                        "flash_relpos": L * TRAIN_EPOCHS}  # one validation batch an epoch, under no_grad
                if dtype != "f32":  # the f32 run's launches are D's and E's own phase count
                    for name, n in want.items():
                        count_path(name, f"[8 cli {row}]", n)
            elif family == "xlstm":
                want = {"slstm_scan": n_slstm * TRAIN_EPOCHS}  # the validation forwards, under no_grad
                count_path("slstm_scan", f"[8 cli {row}]", want["slstm_scan"])
            ms = 1e3 * statistics.median(step_secs[1:] or step_secs)
            say(f"[8 cli {row}] cli.train --block-len {block}{' --bf16' if dtype == 'bf16' else ''}: {n_steps} "
                f"steps in {TRAIN_EPOCHS} epochs in "
                f"{secs:.1f} s (with validation and the checkpoint); {ms:.2f} ms/step (median after the first), "
                f"{BATCH * block / (ms / 1e3):.1f} train tokens/s; peak memory {peak / 2**30:.2f} GiB; launches "
                f"{launches}; checkpoint {saved[0].name}")
            need(n_steps == 2 * TRAIN_EPOCHS and len(step_secs) == n_steps, f"{row}: {n_steps} train steps")
            need(launches == want, f"{row} training launched {launches}, expected {want}")
            for name in ("flash_relpos_lse", *E_LAUNCHES):
                if family == "transformer" and dtype == "f32":
                    report[name]["launches"] = want[name]

            dk.LAUNCHES.clear()
            slstm_scan.launches = 0
            streams = gen_cli.main(["--model", family, "--ckpt", str(saved[0] / "model.pth"), "--data", str(corpus),
                                    "--metadata", str(meta_path), "--composers", "Mozart", "--batch", str(BATCH),
                                    "--block-len", str(PROMPT), "--length", str(GEN_AFTER_TRAIN), "--output",
                                    str(root / f"gen8_{tag}"), "--seed", str(SEED), "--device", DEVICE])
            torch.cuda.synchronize()
            st = torch.from_numpy(streams["Mozart"])
            need(tuple(st.shape) == (BATCH, PROMPT + GEN_AFTER_TRAIN), f"{row}: stream shape {tuple(st.shape)}")
            need(bool((mask[field_bucket(st[:, PROMPT - 1:-1]), st[:, PROMPT:]] > 0).all()),
                 f"{row}: a token generated from the trained checkpoint breaks the grammar")
            gen_txt = ""
            if family == "xlstm":  # the trained, dense-gated checkpoint through H and G
                gen = {**dk.LAUNCHES, "slstm_scan": slstm_scan.launches}
                want = {**x_launches(xk.XDims.create(trained_cfg, BATCH), GEN_AFTER_TRAIN, 1, "auto"),
                        "slstm_scan": n_slstm}
                need(gen == want, f"{row}: generation from the trained checkpoint launched {gen}, expected {want}")
                count_path("slstm_scan", f"[8 cli {row} generate]", n_slstm)
                count_path("xlstm_step", f"[8 cli {row} generate]", GEN_AFTER_TRAIN)
                count_path("sample_tail", f"[8 cli {row} generate] (G)", GEN_AFTER_TRAIN)
                gen_txt = f"; launches {gen}"
            say(f"[8 cli {row} generate] cli.generate --ckpt {saved[0].name}/model.pth: {GEN_AFTER_TRAIN} "
                f"grammatical tokens at batch {BATCH} after a {PROMPT}-token prompt{gen_txt}")
    finally:
        T.make_lm_train_step = make_step
        train_cli.DEFAULT_CONFIGS["xlstm"] = full_xlstm


# [8 split]: the kernels of kernel D and E (csrc/flash_relpos*.cu, in an
# anonymous namespace) and the name fragments of the library's GEMM and Adam
# kernels, by which a training step's device time is grouped.
DE_KERNELS = ("stage_bf16_kernel", "flash_relpos_kernel", "stage_kernel", "dq_kernel", "dkv_kernel", "drel_kernel",
              "combine_kernel")
GEMM_NAMES = ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitKreduce")
ADAM_NAMES = ("multi_tensor_apply",)
SPLIT_STEPS = {"transformer": 3, "mamba": 3, "xlstm": 1}  # CUDA-event steps a row (an xLSTM step is 3-4 s)


def kernel_group(name: str) -> str:
    """[8 split]'s group of a device kernel by its name."""
    if "anonymous namespace" in name and any(f"::{k}" in name for k in DE_KERNELS):
        return "D/E"
    if any(k in name for k in GEMM_NAMES):
        return "GEMMs"
    if any(k in name for k in ADAM_NAMES):
        return "Adam"
    return "other"


def device_groups(torch, fn) -> tuple[dict, float] | None:
    """(device ms by kernel_group, host ms) of one fn() under torch.profiler
    (device activity only: recording every CPU op of the xLSTM's Python
    scan took minutes); None where the trace holds no device kernel. The
    kernels are read from the profiler's raw (kineto) events: building its
    Python event list took tens of seconds for the xLSTM's step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, supported_activities

    if ProfilerActivity.CUDA not in supported_activities():
        return None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = 1e3 * (time.perf_counter() - t0)
    groups: dict = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA and ev.duration_ns() > 0:
            g = kernel_group(ev.name())
            groups[g] = groups.get(g, 0.0) + ev.duration_ns() / 1e6
    return (groups, host) if groups else None


def phase_train_split(torch, corpus: Path, meta_path: Path, families=("transformer", "mamba", "xlstm"),
                      dtypes=("f32", "bf16")) -> dict:
    """[8 split <family> <dtype>]: where a full-width training step's time
    goes (the [8 steps] model, batch and Adam). CUDA events around the
    forward to the logits, the loss (the grammar filter and the CE), the
    backward and Adam's step (medians of SPLIT_STEPS steps after one to warm
    up); the device time of one more step by kernel group from
    torch.profiler (GEMMs, kernels D and E, Adam's multi-tensor kernels,
    and the rest: elementwise ops, reductions, softmax, copies), its host
    time and the device's idle share; and, alone, the loss and the grammar
    filter forward and backward on detached logits (CUDA events, 3 calls).
    Returns {(family, dtype): {"forward", "loss", "backward", "adam",
    "step", "groups", "idle", "loss_alone"}} in ms."""
    from musicgen_tpu_torch.config import MambaConfig, TransformerConfig, XLSTMConfig
    from musicgen_tpu_torch.models import mamba, transformer, xlstm
    from musicgen_tpu_torch.train import trainer as T
    from musicgen_tpu_torch.train.loss import filtered_cross_entropy

    src, trg, meta = train_batch(torch, corpus, meta_path)
    out = {}
    for (family, module, cfg), dtype in itertools.product(
            (("transformer", transformer, TransformerConfig(dropout=0.0)), ("mamba", mamba, MambaConfig()),
             ("xlstm", xlstm, XLSTMConfig(**X_TRAIN_DEPTH))), dtypes):
        if family not in families:
            continue
        model = module.init_weights_(module.empty_model(cfg, DEVICE, DTYPES[dtype](torch)), SEED).train()
        opt = T.make_optimizer(model)
        marks = []

        def step():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            opt.zero_grad(set_to_none=True)
            with torch.enable_grad():
                ev[0].record()
                logits = model(src, meta)
                ev[1].record()
                loss = filtered_cross_entropy(src, logits, trg)
                ev[2].record()
                loss.backward()
                ev[3].record()
            opt.step()
            ev[4].record()
            marks.append(ev)

        step()  # warm-up: Adam's state, the first launches
        marks.clear()
        for _ in range(SPLIT_STEPS[family]):
            step()
        torch.cuda.synchronize()
        parts = {k: statistics.median(m[i].elapsed_time(m[i + 1]) for m in marks)
                 for i, k in enumerate(("forward", "loss", "backward", "adam"))}
        parts["step"] = statistics.median(m[0].elapsed_time(m[4]) for m in marks)
        prof = device_groups(torch, step)
        with torch.no_grad():
            logits = model(src, meta).detach()
        alone = []
        for _ in range(3):
            lg = logits.clone().requires_grad_()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            with torch.enable_grad():
                filtered_cross_entropy(src, lg, trg).backward()
            e1.record()
            torch.cuda.synchronize()
            alone.append(e0.elapsed_time(e1))
        parts["loss_alone"] = statistics.median(alone)
        if prof is None:
            parts["groups"], parts["idle"] = None, None
            groups = "device time by kernel group not measured (the trace held no device kernel)"
        else:
            parts["groups"], host = prof
            busy = sum(parts["groups"].values())
            parts["idle"] = max(0.0, 1.0 - busy / parts["step"])
            groups = (f"device ms of one step by kernel group (torch.profiler): "
                      + ", ".join(f"{k} {v:.2f}" for k, v in sorted(parts["groups"].items(), key=lambda kv: -kv[1]))
                      + f" (sum {busy:.2f}: the device idle {100 * parts['idle']:.1f}% of the unprofiled step's "
                      f"{parts['step']:.2f} ms; the profiled step {host:.2f} ms of host time)")
        say(f"[8 split {family} {dtype}] ({BATCH}, {PROMPT}), CUDA events, median of {SPLIT_STEPS[family]} steps: "
            f"forward {parts['forward']:.2f} ms, loss (grammar filter + CE) {parts['loss']:.2f}, backward "
            f"{parts['backward']:.2f}, Adam {parts['adam']:.2f}; step {parts['step']:.2f}; {groups}; the loss and "
            f"grammar filter alone, forward and backward on detached logits: {parts['loss_alone']:.2f} ms")
        out[family, dtype] = parts
        del model, opt, logits, lg
        marks.clear()
        torch.cuda.empty_cache()
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


DDP_STEPS = 6  # [8 ddp]: the steps held bit for bit; ms/step is the median of steps 3-6 (DDP rebuilds its buckets
# after the first)


@contextlib.contextmanager
def one_rank_group(torch, row: str):
    """A one-rank NCCL group of this process ([8 ddp], phase 15), joined as
    cli.train joins a launcher's (train/distributed.init_from_env), left and
    its environment restored after."""
    import torch.distributed as dist

    from musicgen_tpu_torch.train import distributed

    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        rank, world, _ = distributed.init_from_env(DEVICE)
        need((rank, world) == (0, 1) and dist.get_backend() == "nccl", f"[{row}] group {rank}/{world}")
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        torch.cuda.empty_cache()


def unsharded_step(torch, model, optimizer):
    """The one-process deterministic step that [8 ddp] and phase 15 hold the
    multi-rank steps to: eval-mode forward (no dropout), the grammar-filtered
    CE, Adam."""
    from musicgen_tpu_torch.train.loss import filtered_cross_entropy

    @torch.enable_grad()
    def step(src, trg, meta):
        model.eval()
        optimizer.zero_grad(set_to_none=True)
        loss = filtered_cross_entropy(src, model(src, meta), trg)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def phase_ddp(torch, corpus: Path, meta_path: Path) -> None:
    """[8 ddp]: train/distributed.py on the card in a one-rank NCCL group of
    this process (a launcher's environment set here): DDP_STEPS steps of the
    bf16 Transformer at full width through make_distributed_train_step
    against the same steps of the unwrapped deterministic step (eval-mode
    dropout, the same loss, Adam) on a copy of the model; the losses and
    every parameter bit for bit (a difference is printed with its size),
    exact launches of D and E in both, the ms/step of each."""
    from musicgen_tpu_torch.config import TransformerConfig
    from musicgen_tpu_torch.models.transformer import empty_model, init_weights_
    from musicgen_tpu_torch.ops import attention_kernel as ak
    from musicgen_tpu_torch.train import distributed
    from musicgen_tpu_torch.train import trainer as T

    batch = train_batch(torch, corpus, meta_path)
    with one_rank_group(torch, "8 ddp"):
        ddp_model, ref = (init_weights_(empty_model(TransformerConfig(), DEVICE, torch.bfloat16), SEED)
                          for _ in range(2))
        _, ddp_step = distributed.build_distributed_training(ddp_model)
        ref_step = unsharded_step(torch, ref, T.make_optimizer(ref))

        runs = {}
        for name, fn in (("ddp", ddp_step), ("unwrapped", ref_step)):
            ak.LAUNCHES.clear()
            losses, secs = [], []
            for _ in range(DDP_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(fn(*batch)))
                secs.append(time.perf_counter() - t0)
            runs[name] = (losses, dict(ak.LAUNCHES), 1e3 * statistics.median(secs[2:]))
        L = ref.cfg.n_layer
        want = {"flash_relpos_lse": L * DDP_STEPS, **dict.fromkeys(E_LAUNCHES, L * DDP_STEPS)}
        diffs = [(float((a.detach() - b.detach()).abs().max()), int((a != b).sum()), n)
                 for (n, a), b in zip(ddp_model.named_parameters(), ref.parameters())]
        worst = max(diffs)
        differing = sum(d[1] for d in diffs)
        say(f"[8 ddp] a one-rank NCCL group, the bf16 Transformer at full width, {DDP_STEPS} steps on one "
            f"({BATCH}, {PROMPT}) batch: losses {runs['ddp'][0]} through DDP, {runs['unwrapped'][0]} unwrapped; "
            f"parameters after the steps: {differing} elements differ (largest {worst[0]:.3e} at {worst[2]}); "
            f"{runs['ddp'][2]:.2f} ms/step through DDP, {runs['unwrapped'][2]:.2f} unwrapped (median of steps "
            f"3-{DDP_STEPS}, host clock around a synchronised step); launches {runs['ddp'][1]} / "
            f"{runs['unwrapped'][1]}")
        need(runs["ddp"][0] == runs["unwrapped"][0], "[8 ddp]: the losses through DDP differ from the unwrapped step's")
        need(differing == 0, "[8 ddp]: a parameter after the DDP steps differs from the unwrapped steps'")
        for name in ("ddp", "unwrapped"):
            need(runs[name][1] == want, f"[8 ddp] {name}: launched {runs[name][1]}, expected {want}")
        for name, n in want.items():
            count_path(name, "[8 ddp]", n)
        del ddp_model, ref, ddp_step, ref_step


CLI_PARALLEL_TIMEOUT = 300


def phase_cli_parallel(torch, corpus: Path, meta_path: Path, root: Path) -> None:
    """[8 cli parallel]: `python -m torch.distributed.run --standalone
    --nproc_per_node 1 -m musicgen_tpu_torch.cli.train --parallel --bf16`
    for the Transformer at full width (one epoch, batch 2, block 2048) in a
    process group of its own (NCCL): rc 0, rank 0's log line with the mesh,
    one checkpoint directory whose model.pth (no DDP 'module.' prefix, f32)
    loads into a TransformerLM whose no-grad forward (through kernel D) is
    finite. The launcher runs in a process group of its own and is killed with its
    workers if it outlives CLI_PARALLEL_TIMEOUT seconds."""
    import signal

    from musicgen_tpu_torch.interop import load_model

    ckpt_dir, log = root / "train8_parallel", root / "train8_parallel.json"
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1", "-m",
            "musicgen_tpu_torch.cli.train", "--model", "transformer", "--parallel", "--bf16", "--data", str(corpus),
            "--metadata", str(meta_path), "--ckpt-dir", str(ckpt_dir), "--log-json", str(log), "--epochs", "1",
            "--batch-size", str(BATCH), "--block-len", str(PROMPT), "--seed", str(SEED), "--device", DEVICE]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=CLI_PARALLEL_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SmokeFailure(f"[8 cli parallel] did not finish within {CLI_PARALLEL_TIMEOUT} s")
    secs = time.perf_counter() - t0
    tail = "\n".join(text.splitlines()[-20:])
    need(proc.returncode == 0, f"[8 cli parallel] rc {proc.returncode}:\n{tail}")
    need("Training started! mesh={'data': 1, 'model': 1}" in text, f"[8 cli parallel] no mesh line:\n{tail}")
    need(log.exists(), "[8 cli parallel] rank 0 wrote no --log-json file")
    saved = sorted(ckpt_dir.iterdir())
    need(len(saved) == 1, f"[8 cli parallel] checkpoint directories {[p.name for p in saved]}")
    sd = torch.load(saved[0] / "model.pth", map_location="cpu", weights_only=True)
    need(not any(k.startswith("module.") for k in sd), "[8 cli parallel] the checkpoint's keys carry 'module.'")
    need(all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point()),
         "[8 cli parallel] the checkpoint holds a tensor that is not f32")
    model = load_model(sd, DEVICE).eval()
    src, _, meta = train_batch(torch, corpus, meta_path)
    with torch.no_grad():
        logits = model(src, meta)
    need(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (BATCH, PROMPT, model.cfg.vocab_size),
         f"[8 cli parallel] the read-back model's logits {tuple(logits.shape)} are not finite")
    steps = [ln for ln in text.splitlines() if ln.startswith("Epoch [1/1]")]
    say(f"[8 cli parallel] torch.distributed.run --nproc_per_node 1 ... cli.train --parallel --bf16: rc 0 in "
        f"{secs:.1f} s (the launcher, a fresh process and its CUDA context included); {steps}; checkpoint "
        f"{saved[0].name}, {len(sd)} f32 tensors without a 'module.' prefix, read back into a TransformerLM whose "
        f"forward is finite")
    del model, sd, logits
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 9: the xLSTM (kernel H, the sLSTM prefill recurrence; kernel G, the
# one-token decode step)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def slstm_scan_as(fn):
    """XLSTMLM.prefill with `fn` in kernel H's place (its plain version, or
    the parent tree's H), on the card."""
    from musicgen_tpu_torch.models import xlstm

    saved = xlstm.slstm_scan
    xlstm.slstm_scan = fn
    try:
        yield
    finally:
        xlstm.slstm_scan = saved


def plain_slstm_scan():
    """XLSTMLM.prefill with kernel H's plain version: the reference the
    kernel's prefill is held to."""
    from musicgen_tpu_torch.ops.slstm import slstm_sequential

    return slstm_scan_as(slstm_sequential)


# [9 slstm shapes]: the (B, T, H, DH) at which H is held to the plain scan
# besides the prefill's; the last spans two row groups of BR = 8.
H_SHAPES = ((1, 1, 1, 8), (3, 37, 2, 64), (5, 129, 4, 128), (9, 200, 4, 256))
H_STAMP_STEPS = 256
# [9 slstm wide]: H past DH 256 (the 2-head and 1-head xLSTMs of width 1024)
# and at a DH that is no multiple of 8 (run padded to 304), at the prefill's
# length; the head counts of the width-1024 xLSTMs prefilled through it.
H_WIDE_SHAPES = ((BATCH, PROMPT + 6, 2, 512), (BATCH, PROMPT + 6, 1, 1024), (BATCH, PROMPT + 6, 2, 300))
H_WIDE_HEADS = (2, 1)
WIDE_GEN_TOKENS = 32
WIDE_STEPS = 16  # teacher-forced steps of [9 slstm wide step], each format


def slstm_inputs(torch, b: int, t: int, h: int, dh: int, seed: int = SEED):
    """Kernel H's inputs at (B, T, H, DH): standard normal wx, R scaled by
    1/sqrt(DH), the forget bias of block 1 of 11, the rest zero."""
    from musicgen_tpu_torch.ops.slstm import powerlaw_blockdependent_bias

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    wx = torch.randn(b, t, 4, h, dh, device=DEVICE, generator=gen)
    r = torch.randn(4, h, dh, dh, device=DEVICE, generator=gen) / math.sqrt(dh)
    bias = torch.zeros(4, h, dh, device=DEVICE)
    bias[1] = powerlaw_blockdependent_bias(h, dh, 1, 11).to(DEVICE)
    return wx, r, bias, gen


def slstm_check(outs, refs, noisy):
    """(worst abs, worst rel, floor): the kernel's outputs against the plain
    scan's, and the plain scan's own drift from a 1e-6 perturbation of wx."""
    errs = [rel_err(a, b_) for a, b_ in zip(outs, refs)]
    floor = max(rel_err(a, b_)[1] for a, b_ in zip(noisy, refs))
    return max(e[0] for e in errs), max(e[1] for e in errs), floor


def slstm_stamps(torch, sk, wx, r, bias, cs: int) -> str:
    """One launch of H with timer stamps of the first cluster's rank 0,
    thread 0, over H_STAMP_STEPS steps: the median us a step spends in its
    product (from the step's start through the waits for the slices of h
    and the block barrier after the product), its cell (the slices' sums,
    the update, the pushes into every rank) and its end (the end-of-step
    block barrier to the next step's start); clock64 cycles scaled by the
    launch's %globaltimer span."""
    n = min(H_STAMP_STEPS, wx.shape[1])
    st = torch.zeros(4 + 3 * n, dtype=torch.int64, device=DEVICE)
    sk.slstm_scan(wx, r, bias, cs=cs, stamps=st)
    torch.cuda.synchronize()
    v = st.cpu().tolist()
    ns_per_cycle = (v[2] - v[0]) / max(v[3] - v[1], 1)
    step = [v[4 + 3 * i:7 + 3 * i] for i in range(n)]
    parts = {"product": [b_ - a for a, b_, _ in step[1:-1]], "cell": [c - b_ for _, b_, c in step[1:-1]],
             "end": [step[i + 1][0] - step[i][2] for i in range(1, n - 1)]}
    txt = ", ".join(f"{k} {1e-3 * ns_per_cycle * statistics.median(x):.3f}" for k, x in parts.items())
    return (f"stamps (cs {cs}, median us a step over {n - 2} steps): {txt}; the whole launch "
            f"{1e-3 * (v[2] - v[0]) / wx.shape[1]:.3f} us a step ({ns_per_cycle:.4f} ns a cycle)")


def phase_x_slstm(torch, report: dict, psk=None) -> None:
    """[9 slstm] kernel H against its plain scan at the prefill's shape
    (B, T, H, DH) = (2, 2054, 4, 256), with the scan's own noise floor, its
    launch geometry, its times (host-paced, in a CUDA graph, us a step),
    the cluster of 16 beside the cluster of 8 in turns, its stamps and, with
    the parent tree's slstm_kernel `psk`, the parent's H in turns."""
    from musicgen_tpu_torch.ops import build
    from musicgen_tpu_torch.ops import slstm_kernel as sk
    from musicgen_tpu_torch.ops.slstm import slstm_sequential

    b, t, h, dh = BATCH, PROMPT + 6, 4, 256
    wx, r, bias, gen = slstm_inputs(torch, b, t, h, dh)
    h_k, s_k = sk.slstm_scan(wx, r, bias)
    h_p, s_p = slstm_sequential(wx, r, bias)
    h_n, s_n = slstm_sequential(wx * (1.0 + 1e-6 * torch.randn(wx.shape, device=DEVICE, generator=gen)), r, bias)
    torch.cuda.synchronize()
    worst_abs, worst_rel, floor = slstm_check((h_k, *s_k), (h_p, *s_p), (h_n, *s_n))
    tol = max(TOL_H, 2.0 * floor)
    need(all(bool(torch.isfinite(a).all()) for a in (h_k, *s_k)), "slstm_scan: non-finite output")
    need(worst_rel <= tol, f"slstm_scan (kernel H) disagrees with slstm_sequential: rel {worst_rel:.3e}")
    main_cs = sk.scan_geometry(b, t, h, dh).cs
    alt = sk.PORTABLE_CLUSTER if main_cs == sk.CLUSTER else sk.CLUSTER
    h_a, s_a = sk.slstm_scan(wx, r, bias, cs=alt)
    alt_abs, alt_rel, _ = slstm_check((h_a, *s_a), (h_p, *s_p), (h_n, *s_n))
    need(alt_rel <= tol, f"slstm_scan with clusters of {alt} disagrees with slstm_sequential: rel {alt_rel:.3e}")
    bits = parent_bits(torch, psk, wx, r, bias, (h_k, *s_k))

    log = build.library_path().parent / "build.log"
    launched = tuple(f"slstm_cluster_kernel<{min(b, sk.ROWS)}, {cs}>" for cs in (main_cs, alt))
    usage = [f"{name} {regs}, {frame}" for name, regs, frame in (ptxas_usage(log.read_text()) if log.exists() else [])
             if name.startswith(launched)]
    for cs in (main_cs, alt):
        geo = sk.scan_geometry(b, t, h, dh, cs)
        say(f"[9 slstm launch] cs {geo.cs} x br {geo.rows}: {geo.groups} row group(s), grid {geo.grid} = "
            f"{geo.blocks} blocks of {geo.threads} threads, {geo.smem} B of dynamic shared memory a block "
            f"({geo.slab} B of R); cudaOccupancyMaxActiveClusters "
            f"{sk.max_active_clusters(geo, b, t, h)}")
    say(f"[9 slstm launch] ptxas: " + ("; ".join(usage) if usage else "not in the build log"))

    def run(cs):
        return lambda: sk.slstm_scan(wx, r, bias, cs=cs)

    ms = cuda_ms(torch, run(main_cs), iters=5, warmup=1)
    pack_ms = graph_ms(torch, lambda: sk.pack_r_slabs(r, main_cs), calls=10, replays=3)
    turns = {}
    for cs in (main_cs, alt, alt, main_cs):
        turns.setdefault(cs, []).append(graph_ms(torch, run(cs), calls=2, replays=3))
    if psk is not None:
        for who in ("parent", "this", "this", "parent"):
            fn = (lambda: psk.slstm_scan(wx, r, bias)) if who == "parent" else run(main_cs)
            turns.setdefault(who, []).append(graph_ms(torch, fn, calls=2, replays=3))
    plain_ms = cuda_ms(torch, lambda: slstm_sequential(wx, r, bias), iters=2, warmup=1)
    # Bound: wx, R and the bias read once, h and the final state written once;
    # 2 flops per recurrent weight, step and batch row, at the f32 peak.
    cost = bound(nbytes(wx, r, bias, h_k, *s_k), 2.0 * b * t * 4 * h * dh * dh, F32_FLOPS)

    def graph_txt(key):
        vals = turns[key]
        if any(v is None for v in vals):
            return "not measured"
        mean = statistics.mean(vals)
        return f"{' / '.join(f'{v:.4f}' for v in vals)} ms ({1e3 * mean / t:.3f} us/step)"

    parent_txt = ("the parent tree's H not measured (no --parent)" if psk is None else
                  f"the parent tree's H in a graph {graph_txt('parent')} (this tree {graph_txt('this')}; in "
                  f"turns parent, this, this, parent)")
    say(f"[9 slstm] (B,T,H,DH)=({b},{t},{h},{dh}): h and final state max_abs {worst_abs:.3e} rel {worst_rel:.3e} "
        f"(tol {tol:.3e} = max({TOL_H}, 2x the plain scan's drift from a 1e-6 perturbation of wx, {floor:.3e})); "
        f"clusters of {alt}: max_abs {alt_abs:.3e} rel {alt_rel:.3e}; kernel (cs {main_cs}) {ms:.4f} ms = "
        f"{1e3 * ms / t:.3f} us/step host-paced, in a CUDA graph cs {main_cs} {graph_txt(main_cs)}, cs {alt} "
        f"{graph_txt(alt)} (in turns {main_cs}, {alt}, {alt}, {main_cs}; each call includes pack_r_slabs, "
        f"{fmt_ms(pack_ms)} alone in a graph); {parent_txt}; {bits}; plain scan {plain_ms:.4f} ms, bound "
        f"{cost['bound_ms']:.4f} ms ({cost['bound_by']}), library none")
    for cs in (main_cs, alt):
        say(f"[9 slstm stamps] {slstm_stamps(torch, sk, wx, r, bias, cs)}")
    if psk is not None:
        say(f"[9 slstm stamps parent] {slstm_stamps(torch, psk, wx, r, bias, main_cs)}")
    report["slstm_scan"] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms, "library_ms": None, **cost}
    phase_x_slstm_shapes(torch, sk, psk)
    phase_x_slstm_repeat(torch, sk, wx, r, bias)


def parent_bits(torch, psk, wx, r, bias, outs) -> str:
    """With the parent tree's slstm_kernel `psk`: whether its H gives `outs`
    (this tree's h and final state) bit for bit on the same inputs."""
    if psk is None:
        return "the parent tree's H not compared (no --parent)"
    h_q, s_q = psk.slstm_scan(wx, r, bias)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b_) for a, b_ in zip(outs, (h_q, *s_q)))
    need(same, f"kernel H at DH {wx.shape[-1]} differs from the parent tree's")
    return "bit for bit with the parent tree's H"


def phase_x_slstm_shapes(torch, sk, psk=None) -> None:
    """[9 slstm shapes] H against the plain scan at H_SHAPES, held as [9
    slstm] (and, with the parent tree's slstm_kernel `psk`, bit for bit with
    the parent's H); then the refusals: shapes the kernel does not take
    raise (a head past WIDE_DH, a cluster that does not split DH)."""
    from musicgen_tpu_torch.ops.slstm import slstm_sequential

    for b, t, h, dh in H_SHAPES:
        wx, r, bias, gen = slstm_inputs(torch, b, t, h, dh, seed=SEED + t)
        sk.slstm_scan.launches = 0
        h_k, s_k = sk.slstm_scan(wx, r, bias)
        need(sk.slstm_scan.launches == 1, "slstm_scan did not launch its kernel")
        bits = parent_bits(torch, psk, wx, r, bias, (h_k, *s_k))
        h_p, s_p = slstm_sequential(wx, r, bias)
        h_n, s_n = slstm_sequential(wx * (1.0 + 1e-6 * torch.randn(wx.shape, device=DEVICE, generator=gen)), r,
                                    bias)
        torch.cuda.synchronize()
        need(all(bool(torch.isfinite(a).all()) for a in (h_k, *s_k)), f"slstm_scan {(b, t, h, dh)}: non-finite")
        worst_abs, worst_rel, floor = slstm_check((h_k, *s_k), (h_p, *s_p), (h_n, *s_n))
        tol = max(TOL_H, 2.0 * floor)
        geo = sk.scan_geometry(b, t, h, dh)
        say(f"[9 slstm shapes] (B,T,H,DH)=({b},{t},{h},{dh}): {geo.groups} row group(s) of {geo.rows}, grid "
            f"{geo.grid}, {geo.smem} B shared a block; max_abs {worst_abs:.3e} rel {worst_rel:.3e} (tol {tol:.3e}); "
            f"{bits}")
        need(worst_rel <= tol, f"slstm_scan {(b, t, h, dh)} disagrees with slstm_sequential")
    refused = []
    for dh, cs in ((sk.WIDE_DH + 8, None), (24, sk.CLUSTER)):
        wx, r, bias, _ = slstm_inputs(torch, 1, 4, 1, dh)
        try:
            sk.slstm_scan(wx, r, bias, cs=cs)
        except ValueError as e:
            refused.append(f"DH = {dh}{'' if cs is None else f' in clusters of {cs}'}: {str(e)[:80]}")
    say(f"[9 slstm shapes] refused: {'; '.join(refused)}")
    need(len(refused) == 2, "slstm_scan took a shape its kernel does not take")


def phase_x_slstm_repeat(torch, sk, wx, r, bias) -> None:
    """[9 slstm repeat] two launches and three replays of a CUDA graph of
    one launch give the same bits (no atomics, nothing left over between
    launches)."""
    first = sk.slstm_scan(wx, r, bias)
    second = sk.slstm_scan(wx, r, bias)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sk.slstm_scan(wx, r, bias)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_h, g_s = sk.slstm_scan(wx, r, bias)
    same = []
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        same.append(all(torch.equal(a, b_) for a, b_ in zip((g_h, *g_s), (first[0], *first[1]))))
    twice = all(torch.equal(a, b_) for a, b_ in zip((second[0], *second[1]), (first[0], *first[1])))
    say(f"[9 slstm repeat] second launch {'bit for bit' if twice else 'differs'}; graph replays "
        f"{', '.join('bit for bit' if x else 'differ' for x in same)}")
    need(twice and all(same), "kernel H is not deterministic across launches and graph replays")


def phase_x_prefill(torch, corpus: Path, meta_path: Path, psk=None) -> dict:
    """[9 prefill] the full-size XLSTMLM's prefill with kernel H against the
    plain scan on the card (and, with the parent tree's slstm_kernel `psk`,
    timed in turns with the parent's H); returns the model, the prompt and
    the prefill states."""
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
    ms = median_ms(torch, lambda: model.prefill(prompt, meta))
    dev_ms = graph_ms(torch, lambda: model.prefill(prompt, meta), calls=1, replays=3)
    parent_txt = "the parent tree's H not measured (no --parent)"
    if psk is not None:
        turns: dict = {}
        for who in ("parent", "this", "this", "parent"):
            with slstm_scan_as(psk.slstm_scan if who == "parent" else slstm_scan):
                turns.setdefault(who, []).append((median_ms(torch, lambda: model.prefill(prompt, meta)),
                                                  graph_ms(torch, lambda: model.prefill(prompt, meta), calls=1,
                                                           replays=3)))

        def txt(who):
            return " / ".join(f"{h_:.3f} ({fmt_ms(d_)})" for h_, d_ in turns[who])

        parent_txt = (f"with the parent tree's H {txt('parent')} (this tree {txt('this')}; in turns parent, this, "
                      f"this, parent; host-paced, the median of 5 calls, and in a CUDA graph)")
    with plain_slstm_scan():
        logits_p, _ = model.prefill(prompt, meta)
        plain_ms = cuda_ms(torch, lambda: model.prefill(prompt, meta), iters=2, warmup=1)
    err, rel_e = rel_err(logits_k[:, -1], logits_p[:, -1])
    need(bool(torch.isfinite(logits_k).all()), "xlstm prefill logits are not finite")
    say(f"[9 prefill] XLSTMLM {n_params} parameters, (B, T) = ({BATCH}, {PROMPT}+6): {launches} kernel H launches; "
        f"last logits vs the plain scan max_abs {err:.3e} rel {rel_e:.3e} (tol {TOL_X_PREFILL}); prefill with "
        f"kernel H {ms:.3f} ms (median of 5; in a CUDA graph {fmt_ms(dev_ms)}), {parent_txt}, with the plain scan "
        f"{plain_ms:.3f} ms")
    need(launches == len(model.cfg.slstm_at), f"prefill launched kernel H {launches} times")
    need(rel_e <= TOL_X_PREFILL, "prefill with kernel H disagrees with the plain scan")
    return {"model": model, "prompt": prompt, "meta": meta, "teacher": teacher, "states": states,
            "prefill_ms": ms, "plain_prefill_ms": plain_ms}


def phase_x_slstm_wide(torch, xctx: dict) -> None:
    """[9 slstm wide] kernel H past DH 256 and at a padded DH: H against the
    plain scan at H_WIDE_SHAPES within TOL_X_PREFILL, its ms a launch
    host-paced and in a CUDA graph beside its bound and the plain scan's;
    then the xLSTMs of width 1024 with 2 heads (DH 512) and 1 head (DH
    1024): each prefill launches H 4 times, its last logits against the
    same prefill with the plain scan, both timed; kernel G at those heads
    (phase_x_wide_step); last a short greedy generation of each, grammatical,
    through G's step (phase_x_wide_generate)."""
    from musicgen_tpu_torch.config import XLSTMConfig
    from musicgen_tpu_torch.models.xlstm import empty_model, init_weights_
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops import slstm_kernel as sk
    from musicgen_tpu_torch.ops import xdecode_kernel as xk
    from musicgen_tpu_torch.ops.slstm import slstm_sequential
    from musicgen_tpu_torch.sample import sampler

    for b, t, h, dh in H_WIDE_SHAPES:
        wx, r, bias, _ = slstm_inputs(torch, b, t, h, dh, seed=SEED + dh)
        sk.slstm_scan.launches = 0
        h_k, s_k = sk.slstm_scan(wx, r, bias)
        need(sk.slstm_scan.launches == 1, f"slstm_scan at DH {dh} did not launch its kernel")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h_p, s_p = slstm_sequential(wx, r, bias)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        errs = [rel_err(a, b_) for a, b_ in zip((h_k, *s_k), (h_p, *s_p))]
        worst_abs, worst_rel = max(e[0] for e in errs), max(e[1] for e in errs)
        need(all(bool(torch.isfinite(a).all()) for a in (h_k, *s_k)), f"slstm_scan at DH {dh}: non-finite output")
        ms = cuda_ms(torch, lambda: sk.slstm_scan(wx, r, bias), iters=5, warmup=1)
        dev_ms = graph_ms(torch, lambda: sk.slstm_scan(wx, r, bias), calls=2, replays=3)
        cost = bound(nbytes(wx, r, bias, h_k, *s_k), 2.0 * b * t * 4 * h * dh * dh, F32_FLOPS)
        geo = sk.scan_geometry(b, t, h, dh)
        say(f"[9 slstm wide] (B,T,H,DH)=({b},{t},{h},{dh}): run at DH {geo.dh}, grid {geo.grid} of {geo.threads} "
            f"threads, {geo.smem} B shared a block ({geo.resident} of {geo.dh // geo.cs} rows of each K slice of R "
            f"resident, the rest read from L2 every step); h and final state max_abs {worst_abs:.3e} rel "
            f"{worst_rel:.3e} (tol {TOL_X_PREFILL}); kernel {ms:.4f} ms host-paced ({1e3 * ms / t:.3f} us/step), "
            f"{fmt_ms(dev_ms)} in a CUDA graph; plain scan {plain_ms:.1f} ms; bound {cost['bound_ms']:.4f} ms "
            f"({cost['bound_by']})")
        need(worst_rel <= TOL_X_PREFILL, f"slstm_scan at DH {dh} disagrees with slstm_sequential")
        del wx, r, bias, h_k, s_k, h_p, s_p

    prompt, meta = xctx["prompt"], xctx["meta"]
    for heads in H_WIDE_HEADS:
        model = init_weights_(empty_model(XLSTMConfig(num_heads=heads), DEVICE), SEED).eval()
        dh = model.cfg.embedding_dim // heads
        sk.slstm_scan.launches = 0
        logits_k, states = model.prefill(prompt, meta)
        torch.cuda.synchronize()
        launches = sk.slstm_scan.launches
        ms = median_ms(torch, lambda: model.prefill(prompt, meta))
        dev_ms = graph_ms(torch, lambda: model.prefill(prompt, meta), calls=1, replays=3)
        with plain_slstm_scan():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits_p, _ = model.prefill(prompt, meta)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
        err, rel_e = rel_err(logits_k[:, -1], logits_p[:, -1])
        say(f"[9 slstm wide prefill] XLSTMLM of width {model.cfg.embedding_dim}, {heads} head(s) of DH {dh}, (B, T) = "
            f"({BATCH}, {PROMPT}+6): {launches} launches of H; last logits vs the plain scan max_abs {err:.3e} rel "
            f"{rel_e:.3e} (tol {TOL_X_PREFILL}); prefill with H {ms:.3f} ms (median of 5; in a CUDA graph "
            f"{fmt_ms(dev_ms)}), with the plain scan {plain_ms:.1f} ms")
        need(bool(torch.isfinite(logits_k).all()), f"the {heads}-head prefill's logits are not finite")
        need(launches == len(model.cfg.slstm_at), f"the {heads}-head prefill launched H {launches} times")
        need(rel_e <= TOL_X_PREFILL, f"the {heads}-head prefill with H disagrees with the plain scan")
        count_path("slstm_scan", "[9 slstm wide prefill]", launches)
        phase_x_wide_step(torch, xk, model, states, xctx["teacher"])
        phase_x_wide_generate(torch, sampler, sk, dk, xk, model, prompt, meta)
        del model, logits_k, logits_p, states
        torch.cuda.empty_cache()


def phase_x_wide_step(torch, xk, model, states, teacher) -> None:
    """[9 slstm wide step] kernel G at a wide-head xLSTM (DK past 512, DH
    past 256: the items xm_memory_rows_cq, xm_head_out_wide, the cell reading
    R from L2, the looped group norm): the chain's xm_gates, xm_memory,
    xm_out and xs_cell launches of the first blocks against their plain
    versions at TOL_F32; then in bf16 and int8w, WIDE_STEPS teacher-forced
    steps from the prefill state, each from a shared state: the one-launch
    step bit for bit with the chain (logits and all six carry tensors), the
    chain's logits against the plain chain within max(TOL_T_STEP, 2x the
    plain chain's response to a 1e-6 perturbation), and the step's ms."""
    import torch.nn.functional as F

    dims = xk.XDims.create(model.cfg, BATCH)
    v, heads = dims.vocab_size, dims.heads
    noise = torch.Generator(device=DEVICE).manual_seed(SEED)

    def perturbed(cr):
        cr = clone(cr)
        for i in (2, 5):  # the f32 normalizers and the sLSTM states
            cr[i].mul_(1.0 + 1e-6 * torch.randn(cr[i].shape, device=DEVICE, generator=noise))
        return cr

    for quant in ("bf16", "int8w"):
        q = XQUANTS[quant]
        wp = xk.build_xlstm_decode_params(model, BATCH, quant)
        carry0 = xk.stack_xlstm_states(states, dims)
        if quant == "bf16":
            conv_m, s_m, n_m, m_m, conv_s, hcnm_s = (t[0] for t in carry0)
            x = F.embedding(teacher[:, 0], wp["embed"])
            up = xk.up_ln_plain(x, wp["m_ln"][0], wp["m_w_up"][0], dims)
            buf = xk.xm_prep_plain(up, wp["m_conv_w"][0], wp["m_conv_b"][0], conv_m.clone(), wp["m_qkv_w"][0], dims)
            sc = xk.xm_gates_plain(buf, wp["m_w_gate"][0], wp["m_gate_b"][0], n_m.clone(), m_m.clone(), dims)
            h = xk.xm_memory_plain(buf, sc, s_m.clone(), dims)
            xs = xk.xs_prep_plain(x, wp["s_ln"][0], wp["s_conv_w"][0], wp["s_conv_b"][0], conv_s.clone(), dims)
            wif, wzo = xk.gemv_plain(xs[0], wp["s_w_if"][0], dims), xk.gemv_plain(xs[1], wp["s_w_zo"][0], dims)
            checks = (
                ("xm_gates", xk.xm_gates, xk.xm_gates_plain,
                 (buf, wp["m_w_gate"][0], wp["m_gate_b"][0], n_m, m_m, dims), (3, 4)),
                ("xm_memory", xk.xm_memory, xk.xm_memory_plain, (buf, sc, s_m, dims), (2,)),
                ("xm_out", xk.xm_out, xk.xm_out_plain, (h, buf, up, wp["m_outnorm"][0], wp["m_skip"][0], dims), ()),
                ("xs_cell", xk.xs_cell, xk.xs_cell_plain,
                 (wif, wzo, wp["s_r_w"][0], wp["s_bias"][0], wp["s_gn"][0], hcnm_s, x, dims), (5, 6)))
            cells = []
            for name, kern, plain, args, inplace in checks:
                a_k, a_p, a_t = ([a.clone() if i in inplace else a for i, a in enumerate(args)] for _ in range(3))
                out_k, out_p = kern(*a_k), plain(*a_p)
                torch.cuda.synchronize()
                outs, refs = [out_k] + [a_k[i] for i in inplace], [out_p] + [a_p[i] for i in inplace]
                need(all(bool(torch.isfinite(o.float()).all()) for o in outs), f"{name} at {heads} heads: non-finite")
                rel = max(rel_err(o.float(), r_.float())[1] for o, r_ in zip(outs, refs))
                ms = cuda_ms(torch, lambda: kern(*a_t), iters=10, warmup=2)
                cells.append(f"{name} rel {rel:.3e} in {ms:.4f} ms")
                need(rel <= TOL_F32, f"{name} at {heads} heads (DK {dims.m_dh}, DH {dims.s_dh}) disagrees with its "
                                     f"plain version (rel {rel:.3e})")
            say(f"[9 slstm wide step] {heads} heads (DK {dims.m_dh}, DH {dims.s_dh}), the chain's launches of the "
                f"first blocks against their plain versions (tol rel {TOL_F32}): " + "; ".join(cells))
        ck, cs = clone(carry0), clone(carry0)
        worst = worst_noise = 0.0
        bits = True
        for step in range(WIDE_STEPS):
            tok = teacher[:, step]
            cp, cn = clone(ck), perturbed(ck)
            lk = xk.xlstm_decode_logits(wp, tok, ck, dims, quant=q)
            ls = xk.xlstm_step(wp, tok, cs, dims, q)
            lp = xk.xlstm_decode_logits(wp, tok, cp, dims, ops=xk.PLAIN_OPS, quant=q)
            ln = xk.xlstm_decode_logits(wp, tok, cn, dims, ops=xk.PLAIN_OPS, quant=q)
            worst = max(worst, rel_err(lk[:, :v], lp[:, :v])[1])
            worst_noise = max(worst_noise, rel_err(ln[:, :v], lp[:, :v])[1])
            bits &= torch.equal(ls, lk) and all(torch.equal(a, b_) for a, b_ in zip(cs, ck))
        torch.cuda.synchronize()
        tol = max(TOL_T_STEP, 2.0 * worst_noise)
        ms = cuda_ms(torch, lambda: xk.xlstm_step(wp, tok, cs, dims, q), iters=20)
        dev_ms = graph_ms(torch, lambda: xk.xlstm_step(wp, tok, cs, dims, q), calls=8)
        launch = dict(xk.xlstm_step.launch)
        say(f"[9 slstm wide step {quant}] {heads} heads: {WIDE_STEPS} teacher-forced steps, the one-launch step "
            f"({launch['grid']} blocks, {launch['dynamic_smem']} B dynamic shared memory) bit for bit with the chain "
            f"(logits and all six carry tensors): {bits}; the chain vs the plain chain logits rel {worst:.3e} (tol "
            f"{tol:.3e}); the step {ms:.4f} ms host-paced, {fmt_ms(dev_ms)} in a CUDA graph; bound "
            f"{x_step_bound(wp, cs)['bound_ms']:.4f} ms")
        need(bits, f"{quant}: the one-launch step at {heads} heads differs from the kernel chain")
        need(worst <= tol, f"{quant}: kernel G at {heads} heads disagrees with the plain chain")
        del wp, carry0, ck, cs


def phase_x_wide_generate(torch, sampler, sk, dk, xk, model, prompt, meta) -> None:
    """[9 slstm wide generate] sampler.generate (fused=None, as the CLI's
    auto) of WIDE_GEN_TOKENS greedy tokens on a wide-head xLSTM: H's 4
    launches in the prefill, every token grammatical, G's step and kernel
    B's tail once a token."""
    dims = xk.XDims.create(model.cfg, BATCH)
    refusal = xk.step_shape_error(dims)
    need(refusal is None, f"kernel G's step refuses {model.cfg.num_heads} heads: {refusal}")
    sk.slstm_scan.launches = 0
    dk.LAUNCHES.clear()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    t0 = time.perf_counter()
    streams = sampler.generate(model, "xlstm", prompt, meta, WIDE_GEN_TOKENS, PROMPT, gen, greedy=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    h_n, g_n = sk.slstm_scan.launches, {k: v for k, v in dk.LAUNCHES.items() if v}
    want = x_launches(dims, WIDE_GEN_TOKENS, 1, "auto")
    say(f"[9 slstm wide generate] {model.cfg.num_heads} heads: {WIDE_GEN_TOKENS} greedy tokens in {secs:.1f} s; "
        f"{'grammatical' if grammatical(torch, streams, prompt.shape[1]) else 'NOT grammatical'}; H {h_n} launches; "
        f"decode launches {g_n}")
    need(grammatical(torch, streams, prompt.shape[1]), "the wide-head generation broke the grammar")
    need(h_n == dims.n_slstm and g_n == want, f"the wide-head generation launched H {h_n} and {g_n}, expected {want}")
    count_path("slstm_scan", "[9 slstm wide generate]", h_n)
    for name, n in want.items():
        count_path(name, "[9 slstm wide generate]", n)


def phase_x_decode(torch, xctx: dict, report: dict, quants: dict = XQUANTS) -> dict:
    """[9 xdecode] each kernel G launch against its plain version on the same
    inputs (the first mLSTM and sLSTM block): every launch in bf16, the
    GEMVs in W8A16, the matrix memory stored in bf16. Then X_TEACHER_STEPS
    teacher-forced steps per format from the prefill state: each step's
    kernel chain against the plain chain from the same state (and from that
    state perturbed by 1e-6, the noise floor) and against the f32
    XLSTMLM.step; [9 drift] the free-running plain chains; [9 xstep] the
    one-launch step over the same steps from its own carry (x_step_check);
    in each format of `quants`. Returns the packs of `quants` by format."""
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
    packs["bf16-sb16"], packs["int8w-sb16"] = packs["bf16"], packs["int8w"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    x = F.embedding(prompt[:, -1], packs["bf16"]["embed"]) + 0.1 * torch.randn(BATCH, d, device=DEVICE, generator=gen)
    for quant, q in quants.items():
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
        # Each launch once: every launch in bf16, the GEMVs in W8A16, the
        # matrix memory stored in bf16.
        names = {"bf16": list(kernels), "int8w": list(gemvs), "bf16-sb16": ["xm_memory"]}.get(quant, [])

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
            lib = NO_LIBRARY
            if name in gemvs:
                xin, wname, extra = gemvs[name]
                cost = gemv_cost(BATCH, wp[wname][0], sc(wname), extra)
                lib = linear_time(torch, xin, bf16_weights(torch, wp[wname][0], sc(wname)))
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
                f"({cost['bound_by']}), {lib.text()}")
            need(all(bool(torch.isfinite(o.float()).all()) for o in outs), f"{key}: non-finite output")
            need(worst_rel <= tol, f"{key} disagrees with its plain version")
            report[key] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms, "library_ms": lib.ms, **cost}

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
        ck, cs, free_p, free_q = clone(carry0), clone(carry0), clone(carry0), perturbed(carry0)
        worst_plain = worst_noise = worst_state = worst_val = worst_f32 = worst_step = 0.0
        idx_checked = idx_equal = 0
        step_bits = True
        for step in range(X_TEACHER_STEPS):
            tok = xctx["teacher"][:, step]
            pen = push_token(pen, tok)
            bucket = field_bucket(tok)
            cp, cn = clone(ck), perturbed(ck)
            lf, _ = model.step(tok, xk.unstack_xlstm_states(cp, dims))
            lk = xk.xlstm_decode_logits(wp, tok, ck, dims, quant=q)
            ls = xk.xlstm_step(wp, tok, cs, dims, q)
            lp = xk.xlstm_decode_logits(wp, tok, cp, dims, ops=xk.PLAIN_OPS, quant=q)
            ln = xk.xlstm_decode_logits(wp, tok, cn, dims, ops=xk.PLAIN_OPS, quant=q)
            worst_plain = max(worst_plain, rel_err(lk[:, :v], lp[:, :v])[1])
            worst_step = max(worst_step, rel_err(ls[:, :v], lp[:, :v])[0])
            worst_noise = max(worst_noise, rel_err(ln[:, :v], lp[:, :v])[1])
            worst_state = max(worst_state, *(rel_err(a.float(), b_.float())[1] for a, b_ in zip(ck, cp)))
            worst_f32 = max(worst_f32, rel_err(lk[:, :v], lf)[1])
            vk, ik = dk.sample_tail(lk, wp["gram"], pen.hist, bucket, dims)
            vs, is_ = dk.sample_tail(ls, wp["gram"], pen.hist, bucket, dims)
            vp, ip = dk.sample_tail_plain(lp, wp["gram"], pen.hist, bucket, dims)
            worst_val = max(worst_val, rel_err(vk, vp)[1])
            checked, equal = top3_agreement(torch, vk, ik, vp, ip)
            idx_checked, idx_equal = idx_checked + checked, idx_equal + equal
            # [9 xstep]: the one-launch step from its own carry, bit for bit.
            step_bits &= (torch.equal(ls, lk) and torch.equal(vs, vk) and torch.equal(is_, ik)
                          and all(torch.equal(a, b_) for a, b_ in zip(cs, ck)))
            free_k = xk.xlstm_decode_logits(wp, tok, free_p, dims, ops=xk.PLAIN_OPS, quant=q)
            free_n = xk.xlstm_decode_logits(wp, tok, free_q, dims, ops=xk.PLAIN_OPS, quant=q)
        torch.cuda.synchronize()
        drift_kernel, drift_noise = rel_err(lk[:, :v], free_k[:, :v])[1], rel_err(free_n[:, :v], free_k[:, :v])[1]
        tol = max(TOL_T_STEP, 2.0 * worst_noise)
        chain = xk.KERNEL_OPS
        step_ms = cuda_ms(torch, lambda: xk.fused_xlstm_sample_step(wp, tok, ck, pen.hist, bucket, dims, q, ops=chain),
                          iters=20)
        step_dev_ms = graph_ms(torch, lambda: xk.fused_xlstm_sample_step(wp, tok, ck, pen.hist, bucket, dims, q,
                                                                         ops=chain), calls=2)
        plain_step_ms = cuda_ms(torch, lambda: xk.fused_xlstm_sample_step(wp, tok, cp, pen.hist, bucket, dims, q,
                                                                          ops=xk.PLAIN_OPS), iters=5, warmup=1)
        say(f"[9 xdecode steps {quant}] {X_TEACHER_STEPS} teacher-forced steps, each from a shared state: vs the plain "
            f"chain logits rel {worst_plain:.3e}, states rel {worst_state:.3e}, top-3 values rel {worst_val:.3e} "
            f"(tol {tol:.3e} = max({TOL_T_STEP}, 2x the plain chain's response to a 1e-6 perturbation, "
            f"{worst_noise:.3e})); top-3 indices equal at {idx_equal}/{idx_checked} separated candidates; vs the f32 "
            f"XLSTMLM.step logits rel {worst_f32:.3e} (tol {TOL_X_F32[quant]}); step with the kernel chain "
            f"{step_ms:.4f} ms (device, CUDA graph of the step's {dims.launches_per_token()} launches: "
            f"{fmt_ms(step_dev_ms)}), plain chain {plain_step_ms:.4f} ms")
        say(f"[9 drift {quant}] after {X_TEACHER_STEPS} free-running steps from the prefill state: kernel chain vs "
            f"plain chain logits rel {drift_kernel:.3e}; plain chain vs itself from a state perturbed by 1e-6: "
            f"{drift_noise:.3e}")
        need(max(worst_plain, worst_val, worst_state) <= tol, f"{quant} kernel G steps disagree with the plain chain")
        need(idx_equal == idx_checked, f"{quant} kernel G steps picked other top-3 candidates")
        need(worst_f32 <= TOL_X_F32[quant], f"{quant} kernel G steps disagree with XLSTMLM.step")
        x_step_check(torch, xk, wp, tok, cs, ck, pen, bucket, dims, q, quant, step_bits, worst_step, step_ms,
                     step_dev_ms, plain_step_ms, report)
    return {k: packs[k] for k in quants}


def x_step_bound(wp, carry) -> dict:
    """Bound of one xLSTM step: the pack's weights and scales read once (the
    embedding row and the grammar table are not the step's), the recurrent
    states read and written once; 2 flops per weight and row at the bf16
    peak."""
    big = [t for k, t in wp.items() if k not in ("embed", "gram")]
    return bound(nbytes(*big) + 2 * nbytes(*carry), 2.0 * BATCH * sum(t.numel() for t in big), BF16_FLOPS)


def x_step_check(torch, xk, wp, tok, cs, ck, pen, bucket, dims, q, quant, step_bits, worst_step, chain_ms,
                 chain_dev_ms, plain_ms, report) -> None:
    """[9 xstep] the one-launch step: bit for bit with the chain over the
    teacher-forced steps (logits, top-3 values and indices, the six carry
    tensors), within [9 xdecode steps]' tolerances of the plain chain and
    the f32 step (the same logits), a CUDA-graph replay bit for bit with a
    direct launch, and its ms host-paced and in a CUDA graph beside the
    chain's and the bound."""
    launch = dict(xk.xlstm_step.launch)
    start, c1, c2 = clone(cs), clone(cs), clone(cs)
    direct = xk.xlstm_step(wp, tok, c1, dims, q).clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        xk.xlstm_step(wp, tok, clone(cs), dims, q)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):  # captured, not run: c2 still holds the start
        replayed = xk.xlstm_step(wp, tok, c2, dims, q)
    replay_bits = True
    for _ in range(2):  # twice from the same carry: the counters reset between replays
        for a, b_ in zip(c2, start):
            a.copy_(b_)
        graph.replay()
        torch.cuda.synchronize()
        replay_bits &= torch.equal(replayed, direct) and all(torch.equal(a, b_) for a, b_ in zip(c1, c2))
    ms = cuda_ms(torch, lambda: xk.fused_xlstm_sample_step(wp, tok, cs, pen.hist, bucket, dims, q), iters=50)
    dev_ms = graph_ms(torch, lambda: xk.fused_xlstm_sample_step(wp, tok, cs, pen.hist, bucket, dims, q), calls=8)
    one_ms = graph_ms(torch, lambda: xk.xlstm_step(wp, tok, cs, dims, q), calls=8)
    cost = x_step_bound(wp, cs)
    name = xk.step_name(q, quant.endswith("-sb16"))
    say(f"[9 xstep {quant}] one launch a token ({launch['grid']} blocks x {launch['threads']} threads, "
        f"{launch['dynamic_smem']} B dynamic + {launch['static_smem']} B static shared memory): {X_TEACHER_STEPS} "
        f"teacher-forced steps bit for bit with the chain (logits, top-3 values and indices, all six carry tensors): "
        f"{step_bits}; a CUDA-graph replay bit for bit with a direct launch: {replay_bits}; logits max_abs vs the "
        f"plain chain {worst_step:.3e}; step with the tail {ms:.4f} ms host-paced, {fmt_ms(dev_ms)} in a CUDA graph "
        f"(the launch alone {fmt_ms(one_ms)}); the chain {chain_ms:.4f} / {fmt_ms(chain_dev_ms)}; plain chain "
        f"{plain_ms:.4f} ms; bound {cost['bound_ms']:.4f} ms ({cost['bound_by']})")
    # Where the step's time goes: %globaltimer stamps of each team's wait
    # and signal over 5 launches, by stage kind (xdecode_kernel.stage_times).
    n_teams = xk.STEP_TEAMS * launch["grid"]
    split: dict = {}
    for _ in range(5):
        stamps = torch.zeros(len(xk.step_stages(dims)), n_teams, 2, dtype=torch.int64, device=DEVICE)
        xk.xlstm_step(wp, tok, cs, dims, q, stamps=stamps)
        for kind, wait_us, work_us in xk.stage_times(stamps.cpu(), dims):
            row = split.setdefault(kind, [0.0, 0.0, 0])
            row[0], row[1], row[2] = row[0] + wait_us, row[1] + work_us, row[2] + 1
    say(f"[9 xstep {quant} stages] us a stage (the first team past its wait after the previous stage's last signal; "
        f"from there to the stage's last signal) x stages a token: " + "; ".join(
            f"{kind} {w / n:.2f} + {t / n:.2f} x{n // 5}" for kind, (w, t, n) in split.items()))
    need(step_bits, f"{quant}: the one-launch step differs from the kernel chain")
    need(replay_bits, f"{quant}: a CUDA-graph replay of the step differs from a direct launch")
    report[name] = {"max_abs_err": worst_step, "ms": ms, "plain_ms": plain_ms, "library_ms": None, **cost}


def x_launches(dims, length: int, n: int, quant: str) -> dict:
    """Kernel G's launches (and kernel B's tail) in `n` generations of
    `length` tokens, by --fused-decode mode: one launch of the step and one
    of the tail a token (none with off)."""
    if quant == "off":
        return {}
    k = length * n
    step = "xlstm_step" + ("_w8a16" if quant.startswith("int8") else "") + ("_sb16" if quant.endswith("sb16") else "")
    assert dims.launches_per_token(step=True) == 2
    return {step: k, "sample_tail": k}


def chain_launches(dims, n: int, quant: str) -> dict:
    """The kernel chain's launches in n tokens of [9 loop] in a format of
    XQUANTS (kernel B's head and tail included)."""
    sfx = "_w8a16" if quant.startswith("int8") else ""
    mem = "xm_memory_sb16" if quant.endswith("sb16") else "xm_memory"
    m, s_ = dims.n_mlstm * n, dims.n_slstm * n
    return {f"xm_up{sfx}": m, "xm_prep": m, "xm_gates": m, mem: m, "xm_out": m, f"xm_down{sfx}": m, "xs_prep": s_,
            f"xs_in{sfx}": 2 * s_, "xs_cell": s_, f"xs_ffn_up{sfx}": s_, f"xs_ffn_down{sfx}": s_,
            f"lm_head_ln{sfx}": n, "sample_tail": n}


def phase_x_cli(torch, xctx: dict, corpus: Path, meta_path: Path, root: Path, report: dict,
                int8_only: bool = False, bf16_only: bool = False) -> None:
    """[9 cli] `--model xlstm` through the CLI: --fused-decode auto, greedy
    and stochastic (one band each), LENGTH tokens; int8w, sb16 and
    int8w-sb16 for X_CLI_SHORT tokens; on, int8 and off (the plain step) for
    X_CLI_TINY: every new token grammatical, the .mid files re-extract, and
    each run, counted from zero, launches kernel H 4 times a prefill and
    kernel G's one-launch step and kernel B's tail once a token (none with
    off). int8_only runs the W8A16 values alone (int8w, int8w-sb16, int8),
    bf16_only the others."""
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
    runs = [("auto", True, ["Bach"], LENGTH), ("auto", False, ["Mozart"], LENGTH),
            ("int8w", False, ["Bach"], X_CLI_SHORT), ("sb16", False, ["Bach"], X_CLI_SHORT),
            ("int8w-sb16", True, ["Mozart"], X_CLI_SHORT), ("on", False, ["Bach"], X_CLI_TINY),
            ("int8", True, ["Bach"], X_CLI_TINY), ("off", True, ["Mozart"], X_CLI_TINY)]
    runs = [r for r in runs if ("int8" in r[0] or not int8_only) and ("int8" not in r[0] or not bf16_only)]
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
        count_path("sample_tail", "[9 cli] (G)", want.get("sample_tail", 0))
    for name, cnt in totals.items():
        report[name]["launches"] = cnt


def phase_x_loop(torch, xctx: dict, packs: dict, report: dict, parent: Path | None = None) -> None:
    """[9 loop] tok/s/seq of kernel G in each format of `packs`
    (X_LOOP_TOKENS stochastic tokens from one prefill, through
    sample_tokens_fused_tail): the one-launch step and the kernel chain, in
    turns (step, chain, chain, step), and with `--parent DIR` the parent
    tree's G (its chain) before and after them; beside the plain
    XLSTMLM.step's, in the same call. Also the device time of one step with
    the tail from a CUDA graph (each path), the bytes a token moves (the
    pack's weights and scales read once, the recurrent states read and
    written) and their share of the HBM roofline. The first chain run of
    each format, counted from zero, launches exactly its 68 a token, and
    sets the chain kernels' launches in the report; each step run 2."""
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops import xdecode_kernel as xk
    from musicgen_tpu_torch.ops.grammar import field_bucket
    from musicgen_tpu_torch.sample import sampler

    model, prompt, meta = xctx["model"], xctx["prompt"], xctx["meta"]
    dims = xk.XDims.create(model.cfg, BATCH)
    pxk = parent_module(parent, "xdecode_kernel", "[9 loop]") if parent is not None else None
    cfg = sampler.SamplerConfig(num_tokens=X_LOOP_TOKENS, ring_size=max(PROMPT, 2048))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    totals: dict = {}
    for quant, wp in packs.items():
        q = XQUANTS[quant]
        prefill, _ = sampler.make_sampler(model, "xlstm", wp, quant)
        logits0, carry0 = prefill(prompt, meta)
        weights = nbytes(*(t for k, t in wp.items() if k not in ("embed", "gram")))
        state = 2 * nbytes(*carry0)
        per_token = weights + state
        steps = {"step": lambda pack, token, st, hist, bucket, i: xk.fused_xlstm_sample_step(
                     pack, token, st, hist, bucket, dims, q),
                 "chain": lambda pack, token, st, hist, bucket, i: xk.fused_xlstm_sample_step(
                     pack, token, st, hist, bucket, dims, q, ops=xk.KERNEL_OPS)}
        parent_bits = None
        if pxk is not None:
            pdims = pxk.XDims.create(model.cfg, BATCH)
            steps["parent"] = lambda pack, token, st, hist, bucket, i: pxk.fused_xlstm_sample_step(
                pack, token, st, hist, bucket, pdims, q)
            # The one-launch step from the prefill state, this tree's and the parent's.
            c_this, c_par = clone(carry0), clone(carry0)
            l_this = xk.xlstm_step(wp, prompt[:, -1], c_this, dims, q).clone()
            l_par = pxk.xlstm_step(wp, prompt[:, -1], c_par, pdims, q)
            parent_bits = torch.equal(l_this, l_par) and all(torch.equal(a, b_) for a, b_ in zip(c_this, c_par))
        order = (["parent"] if pxk else []) + ["step", "chain", "chain", "step"] + (["parent"] if pxk else [])
        secs: dict = {}
        for path in order:
            carry = clone(carry0)
            dk.LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = sampler.sample_tokens_fused_tail(wp, logits0, carry, prompt, cfg, gen, steps[path])
            torch.cuda.synchronize()
            secs.setdefault(path, []).append(time.perf_counter() - t0)
            if path == "parent":
                continue
            want = (x_launches(dims, X_LOOP_TOKENS, 1, {"int8w": "int8w", "bf16-sb16": "sb16"}.get(quant, quant))
                    if path == "step" else chain_launches(dims, X_LOOP_TOKENS, quant))
            need(dict(dk.LAUNCHES) == want,
                 f"[9 loop {quant}] the {path} launched {dict(dk.LAUNCHES)}, expected {want}")
            if path == "chain" and len(secs[path]) == 1:
                for name, cnt in want.items():
                    if name in report and not name.startswith(("lm_head_ln", "sample_tail")):
                        totals[name] = totals.get(name, 0) + cnt
        tok = toks[:, -1]
        pen = sampler.init_penalty_state(torch.cat([prompt, toks], dim=1), max(PROMPT, 2048))
        bucket = field_bucket(tok)  # outside the capture: it copies its boundaries to the card
        dev = {path: graph_ms(torch, lambda f=steps[path]: f(wp, tok, carry, pen.hist, bucket, 0), calls=2)
               for path in secs}
        bound_ms = 1e3 * per_token / HBM_BYTES_PER_S

        def rate(path):
            ms = 1e3 * statistics.mean(secs[path]) / X_LOOP_TOKENS
            runs = " / ".join(f"{1e3 * x / X_LOOP_TOKENS:.4f}" for x in secs[path])
            dev_share = "not measured" if dev[path] is None else f"{100 * bound_ms / dev[path]:.2f}%"
            return (f"{1e3 / ms:.1f} tok/s/seq ({runs} ms/token, {100 * bound_ms / ms:.2f}% of the 3.35 TB/s "
                    f"roofline; one step in a CUDA graph {fmt_ms(dev[path])}, {dev_share})")

        parent_txt = ("the parent tree's G not measured (no --parent)" if pxk is None else
                      f"the parent tree's G {rate('parent')} (one step from the prefill state bit for bit with "
                      f"this tree's, logits and carry: {parent_bits})")
        say(f"[9 loop {quant}] {X_LOOP_TOKENS} tokens a run, in turns ({', '.join(order)}): kernel G one-launch step "
            f"{rate('step')}; kernel chain {rate('chain')}; {parent_txt}; {per_token} B/token = {weights} B of "
            f"weights + {state} B of recurrent state read and written ({bound_ms:.4f} ms/token bound); batch "
            f"{BATCH}; prefill with kernel H {xctx['prefill_ms']:.3f} ms, with the plain scan "
            f"{xctx['plain_prefill_ms']:.3f} ms")
        need(parent_bits is not False, f"[9 loop {quant}] the one-launch step differs from the parent tree's")
    for name, cnt in totals.items():
        report[name]["launches"] = cnt
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


def phase_xlstm(torch, corpus: Path, meta_path: Path, root: Path, report: dict, parent: Path | None = None) -> None:
    psk = parent_module(parent, "slstm_kernel", "[9 slstm]") if parent is not None else None
    phase_x_slstm(torch, report, psk)
    xctx = phase_x_prefill(torch, corpus, meta_path, psk)
    with clock("9 slstm wide"):
        phase_x_slstm_wide(torch, xctx)
    packs = phase_x_decode(torch, xctx, report)
    phase_x_cli(torch, xctx, corpus, meta_path, root, report)
    phase_rows(torch, "xlstm", xctx["model"], corpus, meta_path, root)
    phase_x_loop(torch, xctx, packs, report, parent)


# ---------------------------------------------------------------------------
# Phase 11: the research path (the composer classifier, cli.train_classifier,
# cli.evaluate, cli.preprocess), kernel H on the no-grad forwards, D on the
# Transformer's
# ---------------------------------------------------------------------------


def phase_classifier(torch, corpus: Path, meta_path: Path) -> None:
    """[11 classifier] the full-size composer classifier (512 wide, 11
    blocks, 4 heads of 128) at (2, 2048): its no-grad forward through
    kernel H (exactly 4 launches) against the same forward with the plain
    scan, within TOL_X_PREFILL of its logits, and the ms of each."""
    from musicgen_tpu_torch.config import ClassifierConfig
    from musicgen_tpu_torch.models.xlstm import empty_model, init_weights_, runs_kernel_h
    from musicgen_tpu_torch.ops.slstm_kernel import slstm_scan

    model = init_weights_(empty_model(ClassifierConfig(), DEVICE), SEED).eval()
    src = train_batch(torch, corpus, meta_path)[0]
    layer = model.layers.blocks[model.cfg.slstm_at[0]].xlstm
    wx = torch.empty(*src.shape, 4, layer.num_heads, layer.dh, device=DEVICE)
    route = "kernel H" if runs_kernel_h(wx) else "plain"
    slstm_scan.launches = 0
    logits_k = model(src)
    torch.cuda.synchronize()
    launches = slstm_scan.launches
    count_path("slstm_scan", "[11 classifier]", launches)
    ms = median_ms(torch, lambda: model(src))
    dev_ms = graph_ms(torch, lambda: model(src), calls=1, replays=3)
    with plain_slstm_scan():
        logits_p = model(src)
        plain_ms = median_ms(torch, lambda: model(src), iters=2)
    err, rel_e = rel_err(logits_k, logits_p)
    say(f"[11 classifier] XLSTMClassifier {sum(p.numel() for p in model.parameters())} parameters, (B, T) = "
        f"({BATCH}, {PROMPT}), (H, DH) = ({layer.num_heads}, {layer.dh}): route {route}, {launches} kernel H "
        f"launches a forward; meta logits vs the plain scan max_abs {err:.3e} rel {rel_e:.3e} (tol {TOL_X_PREFILL}); "
        f"forward with H {ms:.3f} ms (median of 5; in a CUDA graph {fmt_ms(dev_ms)}), with the plain scan "
        f"{plain_ms:.3f} ms")
    need(bool(torch.isfinite(logits_k).all()), "classifier logits are not finite")
    need(launches == len(model.cfg.slstm_at) == 4, f"the classifier's forward launched kernel H {launches} times")
    need(rel_e <= TOL_X_PREFILL, "the classifier's forward with kernel H disagrees with the plain scan")


def phase_classifier_train(torch, corpus: Path, meta_path: Path, root: Path) -> Path:
    """[11 classifier train] `cli.train_classifier` at full width and depth
    for one epoch (2 steps of batch 2 at its context length, then one
    validation batch through H): the BCE finite, ms/step with a synchronise
    around each step, peak memory. Returns the checkpoint directory."""
    from musicgen_tpu_torch.cli import train_classifier as cls_cli
    from musicgen_tpu_torch.ops.slstm_kernel import slstm_scan
    from musicgen_tpu_torch.train import trainer as T

    step_secs: list = []
    make_step = T.make_classifier_train_step

    def timed_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(*args)
            torch.cuda.synchronize()
            step_secs.append((time.perf_counter() - t0, float(loss)))
            return loss
        return run

    ckpt_dir = root / "train11_classifier"
    log = root / "train11_classifier.json"
    slstm_scan.launches = 0
    torch.cuda.reset_peak_memory_stats()
    T.make_classifier_train_step = timed_step
    try:
        t0 = time.perf_counter()
        state = cls_cli.main(["--data", str(corpus), "--metadata", str(meta_path), "--ckpt-dir", str(ckpt_dir),
                              "--log", str(log), "--epochs", "1", "--batch-size", str(BATCH), "--seed", str(SEED),
                              "--device", DEVICE])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        T.make_classifier_train_step = make_step
    peak, launches, n_steps = torch.cuda.max_memory_allocated(), slstm_scan.launches, state.step
    block = state.model.cfg.context_length
    del state
    torch.cuda.empty_cache()
    count_path("slstm_scan", "[11 classifier train]", launches)
    val = [e["message"] for e in json.loads(log.read_text()) if "Validation" in e.get("message", "")]
    (saved,) = sorted(ckpt_dir.iterdir())
    bces = [round(loss, 5) for _, loss in step_secs]
    ms = 1e3 * statistics.median(sec for sec, _ in (step_secs[1:] or step_secs))
    say(f"[11 classifier train] cli.train_classifier at ({BATCH}, {block}): {n_steps} steps in {secs:.1f} s "
        f"(with validation and the checkpoint); BCE {bces}; {val[-1] if val else 'no validation'}; {ms:.2f} ms/step "
        f"(median after the first); peak memory {peak / 2**30:.2f} GiB; kernel H {launches} launches (the "
        f"validation forward); checkpoint {saved.name}")
    need(n_steps == 2 and all(math.isfinite(b) for b in bces), f"classifier training: {n_steps} steps, BCE {bces}")
    need(launches == 4, f"the classifier's validation launched kernel H {launches} times")
    return saved


def phase_evaluate(torch, corpus: Path, meta_path: Path, root: Path, classifier: Path) -> None:
    """[11 evaluate] `cli.evaluate` on the card: `accuracy --batches 2` for
    each family at the reference size (seeded random weights saved as a
    .pth), with exact launches (D 8 times a Transformer forward, H 4 times an
    xLSTM's, nothing for Mamba's plain forward); `classifier --batches 2` on
    [11 classifier train]'s checkpoint; `timing` for each family (ms a
    forward of (2, 2048) and the peak memory)."""
    from musicgen_tpu_torch.cli import evaluate as eval_cli
    from musicgen_tpu_torch.config import MambaConfig, TransformerConfig, XLSTMConfig
    from musicgen_tpu_torch.data.metadata import load_band_vectors
    from musicgen_tpu_torch.models import mamba, transformer, xlstm
    from musicgen_tpu_torch.ops import attention_kernel as ak
    from musicgen_tpu_torch.ops.slstm_kernel import slstm_scan
    from musicgen_tpu_torch.ops.ssd_kernel import ssd_scan

    data = ["--data", str(corpus), "--metadata", str(meta_path), "--device", DEVICE]

    def launched(run):
        ak.LAUNCHES.clear()
        ssd_scan.launches = slstm_scan.launches = 0
        out = run()
        torch.cuda.synchronize()
        return out, {**{k: v for k, v in ak.LAUNCHES.items() if v}, **(
            {"ssd_scan": ssd_scan.launches} if ssd_scan.launches else {}), **(
            {"slstm_scan": slstm_scan.launches} if slstm_scan.launches else {})}

    for family, module, cfg in (("mamba", mamba, MambaConfig()), ("transformer", transformer, TransformerConfig()),
                                ("xlstm", xlstm, XLSTMConfig())):
        ckpt = root / f"eval11_{family}.pth"
        model = module.init_weights_(module.empty_model(cfg, DEVICE), SEED)
        torch.save(model.state_dict(), ckpt)
        del model
        per_forward = {"mamba": {}, "transformer": {"flash_relpos": getattr(cfg, "n_layer", 0)},
                       "xlstm": {"slstm_scan": len(getattr(cfg, "slstm_at", ()))}}[family]
        acc, launches = launched(lambda: eval_cli.main(["accuracy", "--model", family, "--ckpt", str(ckpt),
                                                        "--batches", "2", "--block-len", str(PROMPT), *data]))
        want = {k: 2 * v for k, v in per_forward.items()}
        count_path("slstm_scan", "[11 evaluate accuracy xlstm]", launches.get("slstm_scan", 0))
        say(f"[11 evaluate accuracy {family}] --batches 2 at ({BATCH}, {PROMPT}): {json.dumps(acc)}; launches "
            f"{launches}")
        need(launches == want, f"evaluate accuracy --model {family} launched {launches}, expected {want}")
        iters = 10
        torch.cuda.empty_cache()
        t, launches = launched(lambda: eval_cli.main(["timing", "--model", family, "--ckpt", str(ckpt), "--iters",
                                                      str(iters), "--device", DEVICE]))
        count_path("slstm_scan", "[11 evaluate timing xlstm]", launches.get("slstm_scan", 0))
        mem = t["memory"] or {}
        peak = f"{mem['peak_bytes_in_use'] / 2**30:.2f} GiB" if mem else "not measured"
        say(f"[11 evaluate timing {family}] {t['ms_per_forward']:.3f} ms a forward of {eval_cli.TIMING_SHAPE} (CUDA "
            f"events over {iters} forwards), {t['tokens_per_sec']:.0f} tokens/s, peak memory {peak} on "
            f"{t['device']}; launches {launches}")
        need(t["device"] == torch.cuda.get_device_name(0) and t["ms_per_forward"] > 0, f"timing {family}")
        need(launches == {k: v * (iters + 1) for k, v in per_forward.items()},
             f"evaluate timing --model {family} launched {launches}")
        ckpt.unlink()
        torch.cuda.empty_cache()
    _, bands = load_band_vectors(meta_path)
    band_start = min(int(v[0]) for v in bands.values())
    rates, launches = launched(lambda: eval_cli.main(["classifier", "--ckpt", str(classifier), "--band-start",
                                                      str(band_start), "--batches", "2", *data]))
    count_path("slstm_scan", "[11 evaluate classifier]", launches.get("slstm_scan", 0))
    say(f"[11 evaluate classifier] --batches 2 at ({BATCH}, {PROMPT}) on {classifier.name}: {json.dumps(rates)}; "
        f"launches {launches}")
    need(launches == {"slstm_scan": 8}, f"evaluate classifier launched {launches}")
    need(all(0.0 <= r <= 1.0 for r in rates["per_band"].values()), "a success rate outside [0, 1]")


def phase_preprocess(torch, corpus: Path, root: Path) -> None:
    """[11 preprocess] `cli.preprocess` over MIDI files written from the
    synthesized corpus (codec.decode, note_to_midi): one .npy a file in
    <out>/midi/<band>/, each equal to codec.encode of its file's notes."""
    import numpy as np

    from musicgen_tpu_torch.cli import preprocess as pre_cli
    from musicgen_tpu_torch.midi import decode, encode, extract_midi, note_to_midi

    midi = root / "midi"
    sources = sorted(corpus.rglob("*.npy"))
    for path in sources:
        (midi / path.parent.name).mkdir(parents=True, exist_ok=True)
        note_to_midi(decode(np.load(path).tolist()), str(midi / path.parent.name / f"{path.stem}.mid"))
    t0 = time.perf_counter()
    n = pre_cli.main(["--midi", str(midi), "--out", str(root / "np11")])
    secs = time.perf_counter() - t0
    outs = sorted((root / "np11" / "midi").rglob("*.npy"))
    same = sum(np.array_equal(np.load(out), np.asarray(encode(extract_midi(str(midi / out.parent.name /
                                                                              f"{out.stem}.mid"))), np.int64))
               for out in outs)
    tokens = sum(len(np.load(out)) for out in outs)
    say(f"[11 preprocess] cli.preprocess: {n} of {len(sources)} MIDI files tokenized in {secs:.2f} s on the host "
        f"({tokens} tokens); {same} of {len(outs)} .npy files equal codec.encode of their file")
    need(n == len(sources) == len(outs) == same, "cli.preprocess missed or changed a file")


def phase_research(torch, corpus: Path, meta_path: Path, root: Path) -> None:
    """Phase 11: [11 classifier], [11 classifier train], [11 evaluate] and
    [11 preprocess]. Kernel H's launches on these paths go to PATH_LAUNCHES."""
    phase_classifier(torch, corpus, meta_path)
    torch.cuda.empty_cache()
    ckpt = phase_classifier_train(torch, corpus, meta_path, root)
    phase_evaluate(torch, corpus, meta_path, root, ckpt)
    phase_preprocess(torch, corpus, root)


# ---------------------------------------------------------------------------
# Phase 12: the generation CLI's other sampler modes and options, and
# continuous-batching serving (serve.BatchScheduler, cli.serve), on the
# families' logits steps (B, B', F, G) and prefills (A, D, H)
# ---------------------------------------------------------------------------

P12_LENGTH = 256  # tokens of a [12 sampler ...] run
P12_CHECK = 64  # leading 'many' tokens held to the plain f32 path
P12_PROMPT_LEN = 1024  # [12 prompt-len]: prompts of half the window
P12_PROMPT_TOKENS = 64
# Phase 12's models: the reference widths at a cut depth (the full run's
# time makes room for [9 slstm wide] and phase 13). Every launch count there
# follows the model's own depth; the xLSTM keeps its mLSTM and sLSTM kinds.
P12_DEPTH = {"mamba": {"n_layers": 4}, "transformer": {"n_layer": 4}, "xlstm": {"num_blocks": 5, "slstm_at": (1, 4)}}
WIN_PROMPT = 2016  # [12 windowed ...]: 32 tokens fill the 2,048 window, nothing slides
WIN_TOKENS = 32
SERVE_SLOTS = 8
SERVE_CHUNK = 32
SERVE_LENGTHS = tuple(range(32, 209, 16))  # 12 requests, 1,440 tokens
SERVE_GREEDY_LENGTHS = (40, 104, 72)  # greedy requests held to sampler.generate at batch 1
# Two routes' greedy picks are compared position by position, each position
# from the same prefix and state, so that no drift carries over (the random
# Mamba stack turns a 1e-6 state perturbation into 2.4e-2 of the logits in
# one step, [4 steps]). Their picks may differ only at a near-tie: where the
# two best sampling weights lie within what the logit error measured at that
# position can close. A weight is m (lse - x) / d (m the grammar weight, d
# the penalty divisor), which a largest logit error of e moves by up to
# 2 e m / d. The measured error must itself stay within the stated
# tolerance, a share of the row's largest logit: TOL_STEPS for B, TOL_T_F32
# and TOL_X_F32 for F and G, TOL_PREFILL for D's forward.
STEP_TOL = {"mamba": TOL_STEPS, "transformer": TOL_T_F32["bf16"], "xlstm": TOL_X_F32["bf16"]}


def tie_ratio(torch, last, logits, div, err):
    """Per row (B,): the gap of the two best weights of filtered_logits(last,
    logits) / div over 2 err (m1 / d1 + m2 / d2), the most a largest logit
    error of err (B,) can close. A near-tie is <= 1."""
    from musicgen_tpu_torch.ops.grammar import filtered_logits, pick_weights_by_prev_token
    from musicgen_tpu_torch.sample import sampler as sm

    v, i = sm._iter_top_k(filtered_logits(last, logits) / div, 2)
    m = torch.gather(pick_weights_by_prev_token(last) / div, 1, i).sum(1)
    return (v[:, 0] - v[:, 1]) / (2 * err * m)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def p12_models(torch, root: Path) -> dict:
    """The reference models of phases 5, 7 and 9 at the depth of P12_DEPTH
    (seeded weights), each saved as a .pth beside the corpus for the CLIs."""
    from musicgen_tpu_torch.config import MambaConfig, TransformerConfig, XLSTMConfig
    from musicgen_tpu_torch.models import mamba, transformer, xlstm

    models = {kind: module.init_weights_(module.empty_model(cfg(**P12_DEPTH[kind]), DEVICE), SEED).eval()
              for kind, module, cfg in (("mamba", mamba, MambaConfig), ("transformer", transformer, TransformerConfig),
                                        ("xlstm", xlstm, XLSTMConfig))}
    for kind, model in models.items():
        torch.save(model.state_dict(), root / f"{kind}_random.pth")
    return models


def reset_launches() -> None:
    from musicgen_tpu_torch.ops import attention_kernel as ak
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops.slstm_kernel import slstm_scan
    from musicgen_tpu_torch.ops.ssd_kernel import ssd_scan

    ssd_scan.launches = slstm_scan.launches = 0
    ak.LAUNCHES.clear()
    dk.LAUNCHES.clear()


def read_launches() -> tuple[dict, dict]:
    """(the prefill and forward kernels' launches: A, D, H; the decode
    kernels'), each without zeros, since reset_launches."""
    from musicgen_tpu_torch.ops import attention_kernel as ak
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops.slstm_kernel import slstm_scan
    from musicgen_tpu_torch.ops.ssd_kernel import ssd_scan

    pre = {"ssd_scan": ssd_scan.launches, "slstm_scan": slstm_scan.launches, **ak.LAUNCHES}
    return {k: v for k, v in pre.items() if v}, {k: v for k, v in dk.LAUNCHES.items() if v}


def logits_step_launches(model, kind: str, tokens: int, quant: str = "bf16") -> dict:
    """The launches of `tokens` steps of the family's logits step (no
    sampler tail)."""
    if kind == "mamba":
        L, sfx = model.cfg.n_layers, {"bf16": "", "int8w": "_w8a16", "int8": "_w8a8"}[quant]
        return {f"in_proj_conv{sfx}": L * tokens, "mixer_state": L * tokens, f"out_proj_rms{sfx}": L * tokens,
                f"lm_head_ln{sfx}": tokens}
    if kind == "transformer":
        L = model.cfg.n_layer
        return {"t_qkv_ln": L * tokens, "tdecode_attn": L * tokens, "t_res": 2 * L * tokens,
                "t_fc_relu": L * tokens, "lm_head_ln": tokens}
    return {"xlstm_step" + ("_w8a16" if quant.startswith("int8") else ""): tokens}


def prefill_launches(model, kind: str, n: int) -> dict:
    """The launches of n prefills (or no-grad forwards): A, D or H a layer."""
    if kind == "mamba":
        return {"ssd_scan": model.cfg.n_layers * n}
    if kind == "transformer":
        return {"flash_relpos": model.cfg.n_layer * n}
    return {"slstm_scan": len(model.cfg.slstm_at) * n}


def count_row(row: str, *launches: dict) -> None:
    """Add a phase-12 run's launches to the kernels line (PATH_LAUNCHES)."""
    for counts in launches:
        for name, n in counts.items():
            if name in KERNEL_INFO:
                count_path(name, row, n)


def grammatical(torch, streams, prompt_len: int) -> bool:
    from musicgen_tpu_torch.ops.grammar import field_bucket, grammar_mask

    s = torch.as_tensor(streams).long().cpu()
    return bool((grammar_mask()[field_bucket(s[:, prompt_len - 1:-1]), s[:, prompt_len:]] > 0).all())


def check_mids(out: Path, pattern: str, n: int) -> None:
    from musicgen_tpu_torch.midi import extract_midi

    mids = sorted(out.rglob(pattern))
    need(len(mids) == n, f"expected {n} .mid files in {out}, found {len(mids)}")
    for mid in mids:
        need(len(extract_midi(str(mid))) > 0, f"{mid.name} re-extracts with no notes")


def cli_prompts(torch, corpus: Path, meta_path: Path, prompt_len: int, rows: int = BATCH):
    """The (prompt, meta) batch cli.generate draws for band Mozart (its
    first BATCH rows; `rows` of them)."""
    import numpy as np

    from musicgen_tpu_torch.data.dataset import TokenDataset

    ds = TokenDataset.from_directory(corpus / "Mozart", meta_path, block_len=prompt_len, seed=SEED)
    items = [ds[i % len(ds)] for i in range(rows)]
    src = torch.from_numpy(np.stack([x for x, _, _ in items]).astype(np.int64)).to(DEVICE)
    meta = torch.from_numpy(np.stack([m for _, _, m in items]).astype(np.int64)).to(DEVICE)
    return src, meta


def run_generate_cli(torch, kind: str, root: Path, corpus: Path, meta_path: Path, tag: str, *extra) -> tuple:
    """cli.generate --model kind on band Mozart at batch BATCH, counted from
    zero: (streams, seconds, prefill launches, decode launches)."""
    from musicgen_tpu_torch.cli import generate as cli

    out = root / f"gen12_{tag.replace(' ', '_')}"
    argv = ["--model", kind, "--ckpt", str(root / f"{kind}_random.pth"), "--data", str(corpus), "--metadata",
            str(meta_path), "--composers", "Mozart", "--batch", str(BATCH), "--output", str(out), "--seed",
            str(SEED), *extra]
    reset_launches()
    t0 = time.perf_counter()
    streams = cli.main(argv)["Mozart"]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    pre, dec = read_launches()
    check_mids(out, f"generated_Mozart_{kind}_*.mid", BATCH)
    return streams, secs, pre, dec



def kernel_route(model, kind: str, batch: int, quant: str = "bf16"):
    """(prefill, step) of the family's kernel logits step: B (B' for an
    int8 quant), F or G."""
    from musicgen_tpu_torch.sample import sampler as sm

    return sm.make_sampler(model, kind, sm.build_pack(model, kind, batch, quant), quant, PROMPT)


def position_check(torch, last, pen, cfg, got, ref) -> tuple:
    """One position of two routes from the same prefix: (the greedy pick of
    cfg.mode from `got`'s logits, the one from `ref`'s, tie_ratio of ref's
    weights at the measured largest error |got - ref|, that error as a share
    of ref's row's largest logit), each (B,)."""
    from musicgen_tpu_torch.sample import sampler as sm

    div = sm.count_penalty_divisor(pen.hist) if cfg.mode == "many" else sm.penalty_divisor(pen.hist)
    err = (got - ref).abs().amax(dim=1)
    return (sm.pick_token(got, last, pen, cfg, None)[0], sm.pick_token(ref, last, pen, cfg, None)[0],
            tie_ratio(torch, last, ref, div, err), err / ref.abs().amax(dim=1))


def many_along(torch, model, kind: str, src, meta, stream, n: int, route=None) -> list:
    """Along the first n new tokens of a greedy 'many' `stream`, at each
    position: the kernel route's logits (kernel_route, or `route`'s
    (prefill, step)), teacher-forced along the stream, against the plain f32
    step's from the same state (a recurrent model's: the kernel route's
    state, so no drift carries from one position to the next; a
    Transformer's: its plain caches over the same tokens). [kernel picks,
    plain picks, ratios, error shares], each (B, n) (position_check)."""
    from musicgen_tpu_torch.sample import sampler as sm

    b, p = src.shape
    kprefill, kstep = route or kernel_route(model, kind, b)
    cfg = sm.SamplerConfig(num_tokens=n, ring_size=max(PROMPT, 2048), greedy=True, mode="many")
    cols = []
    with torch.no_grad():
        klogits, carry = kprefill(src, meta)
        if kind == "transformer":
            pprefill, pstep = sm.make_sampler(model, kind, None, "bf16", PROMPT)
            plogits, pstate = pprefill(src, meta)
        else:
            plogits, unstack = klogits, sm.kernel_carry(model, kind, "bf16", b)[1]  # the same prefill
        pen, last = sm.init_window(src, cfg), src[:, -1]
        for i in range(n):
            cols.append(position_check(torch, last, pen, cfg, klogits.float(), plogits.float()))
            tok = stream[:, p + i]
            pen = sm.push_count_window(pen, tok)
            if kind == "transformer":
                plogits, pstate = pstep(tok, pstate, p + i)
            else:
                plogits, _ = model.step(tok, unstack(tuple(c.clone() for c in carry)))
            klogits, carry = kstep(tok, carry, p + i)
            last = tok
    return [torch.stack(c, 1) for c in zip(*cols)]


def windowed_logits_at(torch, model, src, meta, stream, d: int):
    """The windowed forward's logits predicting new token d of `stream`
    (greedy, no slide yet): what the reference-windowed sampler weighed."""
    p = src.shape[1]
    buf = torch.nn.functional.pad(stream[:, :p + d], (0, PROMPT - p - d))
    with torch.no_grad():
        return model(buf, meta)[:, p + d - 1].float()


def windowed_along(torch, model, kind: str, src, meta, stream, n: int) -> list:
    """Along the first n new tokens of a greedy windowed 'combined' `stream`
    (no slide), at each position: the windowed forward's logits against the
    cached route's from the same prefix (a recurrent model's kernel step
    after the prefill of the prefix: A or H, then B or G in bf16; a
    Transformer's same forward with the f32 plain attention). [windowed
    picks, the other route's picks, ratios, error shares], each (B, n)
    (position_check)."""
    from musicgen_tpu_torch.sample import sampler as sm

    b, p = src.shape
    cfg = sm.SamplerConfig(num_tokens=n, ring_size=max(PROMPT, 2048), greedy=True)
    kprefill, kstep = kernel_route(model, kind, b) if kind != "transformer" else (None, None)
    pen, last, cols = sm.init_penalty_state(src, cfg.ring_size), src[:, -1], []
    with torch.no_grad():
        for i in range(n):
            got = windowed_logits_at(torch, model, src, meta, stream, i)
            if kind == "transformer":
                set_attention(model, "xla")
                try:
                    ref = windowed_logits_at(torch, model, src, meta, stream, i)
                finally:
                    set_attention(model, "auto")
            elif i == 0:
                ref = kprefill(src, meta)[0].float()
            else:
                _, carry = kprefill(stream[:, :p + i - 1], meta)
                ref = kstep(stream[:, p + i - 1], carry, p + i - 1)[0].float()
            cols.append(position_check(torch, last, pen, cfg, got, ref))
            last = stream[:, p + i]
            pen = sm.push_token(pen, last)
    return [torch.stack(c, 1) for c in zip(*cols)]


def agreement(torch, tag: str, stream, p: int, along: list, tol: float) -> str:
    """Hold a stream to a per-position comparison (many_along,
    windowed_along): the stream's tokens are the first route's picks bit for
    bit; its logit error against the second route stays within `tol` of the
    row's largest logit; where the two routes' picks differ, the second's
    two best weights lie within what that error can close (a near-tie,
    tie_ratio <= 1). Returns the text."""
    picks, other, ratios, shares = along
    n = picks.shape[1]
    toks = stream[:, p:p + n].to(picks.device)
    differ = (picks != other).nonzero().tolist()
    near = [round(float(ratios[r, i]), 4) for r, i in differ]
    worst = float(shares.max())
    need(torch.equal(toks, picks), f"{tag} the stream is not its route's picks: first differences at "
         f"{first_diffs(torch, toks, picks, 0)}")
    need(worst <= tol, f"{tag} the logit error {worst:.3e} of the row's largest logit is over {tol}")
    need(all(x <= 1.0 for x in near), f"{tag} the routes' picks differ where the top-1 leads: (row, token) "
         f"{differ}, gaps {near}")
    return (f"the stream is its route's picks at {n} tokens; the picks differ at (row, token) {differ}, the gap "
            f"there {near} of what the measured logit error can close (a near-tie at <= 1); that error at most "
            f"{worst:.3e} of the row's largest logit (tolerance {tol}); {float((ratios <= 1.0).float().mean()):.4f} "
            f"of the {ratios.numel()} positions near-ties at it")


def first_diffs(torch, got, want, p: int) -> list:
    """Per row, the first new-token index where two streams differ, or None."""
    differ = (got[:, p:].cpu() != want[:, p:].cpu())
    return [int(r.nonzero()[0]) if bool(r.any()) else None for r in differ]


def tie_controls(torch, model, src, meta, stream) -> str:
    """The 'many' comparison (many_along, agreement) on two wrong routes in
    place of Mamba's bf16 kernel step: the kernel step fed the previous
    token (a stale-token fault), which must fail it, and the W8A8 pack
    (printed). Returns the text."""
    parts = {}
    for fault, quant in (("stale token", "bf16"), ("W8A8 pack", "int8")):
        prefill, step = kernel_route(model, "mamba", src.shape[0], quant)
        if fault == "stale token":
            prev = [src[:, -1]]

            def step(tok, carry, i, inner=step):
                out = inner(prev[0], carry, i)
                prev[0] = tok
                return out

        picks, other, ratios, shares = many_along(torch, model, "mamba", src, meta, stream, P12_CHECK,
                                                  (prefill, step))
        differ = (picks != other).nonzero().tolist()
        near = [round(float(ratios[r, i]), 4) for r, i in differ]
        worst = float(shares.max())
        fails = worst > STEP_TOL["mamba"] or any(x > 1.0 for x in near)
        parts[fault] = (f"{fault}: the picks differ at {len(differ)} of {picks.numel()} (row, token), the gap there "
                        f"at most {max(near, default=None)}; the logit error at most {worst:.3e}; fails {fails}")
        if fault == "stale token":
            need(fails, f"[12 sampler mamba many] the comparison let a stale-token step pass: {parts[fault]}")
    return "; controls: " + "; ".join(parts.values())


def phase_p12_sampler(torch, models: dict, root: Path, corpus: Path, meta_path: Path) -> None:
    """[12 sampler <family> many|top5] cli.generate --sampler many|top5 at
    the reference width, batch 2, a 2,048-token prompt (the Transformer's
    fills its window, so F runs), P12_LENGTH tokens: the family's logits
    step and no sampler tail, each run counted from zero; every new token
    grammatical and the .mid files re-extract; the first P12_CHECK tokens of
    'many' equal the plain f32 path's (generate(fused=False) on the card)
    up to the first near-tie; tok/s/seq of sampler.generate host-paced
    (prefill included). Then --fused-decode resident --sampler many for
    Mamba: the per-token kernels, no launch of C, the auto run's stream
    bit for bit."""
    from musicgen_tpu_torch.sample.sampler import generate

    many_mamba = None
    for kind, model in models.items():
        src, meta = cli_prompts(torch, corpus, meta_path, PROMPT)
        for mode in ("many", "top5"):
            tag = f"{kind} {mode}"
            streams, secs, pre, dec = run_generate_cli(torch, kind, root, corpus, meta_path, tag, "--block-len",
                                                       str(PROMPT), "--length", str(P12_LENGTH), "--sampler", mode)
            want = logits_step_launches(model, kind, P12_LENGTH)
            want_pre = prefill_launches(model, kind, 1)
            streams = torch.from_numpy(streams)
            need(torch.equal(streams[:, :PROMPT], src.cpu()), f"[12 sampler {tag}] the streams do not start with "
                 "the prompts")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate(model, kind, src, meta, P12_LENGTH, PROMPT, torch.Generator(device=DEVICE).manual_seed(SEED),
                     mode=mode)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            line = (f"[12 sampler {tag}] cli.generate --sampler {mode}: {P12_LENGTH} tokens at batch {BATCH} after a "
                    f"{PROMPT}-token prompt in {secs:.1f} s; grammatical; .mid files re-extract; launches {dec}, "
                    f"prefill {pre}; sampler.generate {gen_s:.3f} s = {P12_LENGTH / gen_s:.1f} tok/s/seq (prefill "
                    f"included)")
            if mode == "many":
                stream = streams.to(DEVICE)
                along = many_along(torch, model, kind, src, meta, stream, P12_CHECK)
                line += (f"; the first {P12_CHECK} tokens against the plain f32 step from the same state: "
                         + agreement(torch, f"[12 sampler {tag}]", stream, PROMPT, along, STEP_TOL[kind]))
                if kind == "mamba":
                    many_mamba = streams
                    line += tie_controls(torch, model, src, meta, stream)
            say(line)
            need(grammatical(torch, streams, PROMPT), f"[12 sampler {tag}] a generated token breaks the grammar")
            need(dec == want and pre == want_pre, f"[12 sampler {tag}] launches {dec}, prefill {pre}; expected "
                 f"{want}, {want_pre}")
            count_row(f"[12 sampler {tag}]", dec, pre)
    model = models["mamba"]
    streams, secs, pre, dec = run_generate_cli(torch, "mamba", root, corpus, meta_path, "resident many",
                                               "--block-len", str(PROMPT), "--length", str(P12_LENGTH),
                                               "--sampler", "many", "--fused-decode", "resident")
    want = logits_step_launches(model, "mamba", P12_LENGTH)
    same = torch.equal(torch.from_numpy(streams), many_mamba)
    say(f"[12 sampler mamba many resident] --fused-decode resident --sampler many: {P12_LENGTH} tokens in "
        f"{secs:.1f} s; launches {dec} (no launch of C), prefill {pre}; the stream bit for bit with the auto "
        f"run's: {same}")
    need(dec == want and pre == prefill_launches(model, "mamba", 1), f"[12 sampler mamba many resident] launches "
         f"{dec}, prefill {pre}")
    need(same, "[12 sampler mamba many resident] differs from --fused-decode auto --sampler many")
    count_row("[12 sampler mamba many resident]", dec, pre)


def phase_p12_prompt_len(torch, models: dict, root: Path, corpus: Path, meta_path: Path) -> None:
    """[12 prompt-len] --prompt-len 1024 in a 2,048 window: Mamba through
    its kernels (A's prefill, B's steps and tail); a Transformer, whose
    prompt does not fill its window, through D's prefill and its plain step
    (no launch of F nor of the tail)."""
    parts = []
    for kind in ("mamba", "transformer"):
        model = models[kind]
        streams, secs, pre, dec = run_generate_cli(torch, kind, root, corpus, meta_path, f"prompt-len {kind}",
                                                   "--prompt-len", str(P12_PROMPT_LEN), "--block-len", str(PROMPT),
                                                   "--length", str(P12_PROMPT_TOKENS))
        want = {}
        if kind == "mamba":
            want = {**logits_step_launches(model, kind, P12_PROMPT_TOKENS), "sample_tail": P12_PROMPT_TOKENS}
        need(streams.shape == (BATCH, P12_PROMPT_LEN + P12_PROMPT_TOKENS), f"[12 prompt-len] {kind}: stream shape "
             f"{streams.shape}")
        need(grammatical(torch, streams, P12_PROMPT_LEN), f"[12 prompt-len] {kind}: a token breaks the grammar")
        need(dec == want and pre == prefill_launches(model, kind, 1), f"[12 prompt-len] {kind}: launches {dec}, "
             f"prefill {pre}; expected {want}, {prefill_launches(model, kind, 1)}")
        parts.append(f"{kind} {secs:.1f} s, launches {dec or 'none (plain step)'}, prefill {pre}")
        count_row("[12 prompt-len]", dec, pre)
    say(f"[12 prompt-len] --prompt-len {P12_PROMPT_LEN} --block-len {PROMPT}, {P12_PROMPT_TOKENS} tokens at batch "
        f"{BATCH}: " + "; ".join(parts) + "; grammatical; .mid files re-extract")


def phase_p12_windowed(torch, models: dict, root: Path, corpus: Path, meta_path: Path) -> None:
    """[12 windowed <family>] cli.generate --reference-windowing --greedy,
    WIN_TOKENS tokens after a WIN_PROMPT-token prompt in the 2,048 window
    (nothing slides): one forward of the (2, 2048) buffer a token, D 8
    launches a token, H 4, none for Mamba (its forward is plain). At each
    position the stream is the windowed forward's pick, held to the cached
    route's from the same prefix (windowed_along, agreement): a recurrent
    model's kernel step after the prefill of the prefix; for a Transformer,
    whose windowed forward places the query at the full window's rel-pos
    geometry where a prefill of a shorter prompt does not (PERF.md §7), the
    same forward with the f32 plain attention. Where the stream first
    leaves the cached kernel path's (sampler.generate) is printed. ms a
    token."""
    from musicgen_tpu_torch.sample.sampler import generate, reference_windowed_generate

    for kind, model in models.items():
        src, meta = cli_prompts(torch, corpus, meta_path, WIN_PROMPT)
        streams, secs, pre, dec = run_generate_cli(torch, kind, root, corpus, meta_path, f"windowed {kind}",
                                                   "--reference-windowing", "--greedy", "--prompt-len",
                                                   str(WIN_PROMPT), "--block-len", str(PROMPT), "--length",
                                                   str(WIN_TOKENS))
        streams = torch.from_numpy(streams).to(DEVICE)
        want_pre = {} if kind == "mamba" else prefill_launches(model, kind, WIN_TOKENS)
        need(torch.equal(streams[:, :WIN_PROMPT], src), f"[12 windowed {kind}] the streams do not start with the "
             "prompts")
        need(grammatical(torch, streams, WIN_PROMPT), f"[12 windowed {kind}] a token breaks the grammar")
        need(dec == {} and pre == want_pre, f"[12 windowed {kind}] launches {dec}, forward {pre}; expected none, "
             f"{want_pre}")
        count_row(f"[12 windowed {kind}]", pre)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        cached = generate(model, kind, src, meta, WIN_TOKENS, PROMPT, gen, greedy=True)
        shared = first_diffs(torch, streams, cached, WIN_PROMPT)
        tol, against = ((TOL_PREFILL, "the same forward with the f32 plain attention") if kind == "transformer" else
                        (STEP_TOL[kind], "the cached route (the kernel step after the prefill of the prefix)"))
        along = windowed_along(torch, model, kind, src, meta, streams, WIN_TOKENS)
        text = agreement(torch, f"[12 windowed {kind}]", streams, WIN_PROMPT, along, tol)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reference_windowed_generate(model, src, meta, 4, PROMPT, gen, greedy=True)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / 4
        say(f"[12 windowed {kind}] --reference-windowing --greedy: {WIN_TOKENS} tokens after a {WIN_PROMPT}-token "
            f"prompt in the {PROMPT} window at batch {BATCH} in {secs:.1f} s; forward launches {pre or 'none'} "
            f"({sum(pre.values()) // WIN_TOKENS} a token), decode launches {dec or 'none'}; against {against} at "
            f"each position: {text}; first differences from the cached kernel path's stream at {shared}; "
            f"{ms:.2f} ms a token (4 tokens, host-paced)")


def serve_group_chunks(lengths, slots: int, chunk: int) -> int:
    """The group-chunks serve.BatchScheduler runs for requests of `lengths`
    submitted in this order: first-in first-out into the lowest free slot,
    every group of 8 slots holding a request advancing `chunk` tokens a
    chunk, retirement between chunks."""
    queue, active, n = list(lengths), {}, 0

    def admit():
        for s in range(slots):
            if queue and s not in active:
                active[s] = queue.pop(0)

    admit()
    while active:
        n += len({s // 8 for s in active})
        for s in list(active):
            active[s] -= chunk
            if active[s] <= 0:
                del active[s]
        admit()
    return n


def phase_p12_serve(torch, models: dict, root: Path, corpus: Path, meta_path: Path, card: str) -> None:
    """[12 serve <family> <quant>] cli.serve --slots 8 --chunk 32, 12
    stochastic requests of SERVE_LENGTHS tokens on the corpus's two bands:
    Mamba in bf16 (kernel B's logits step) and --quant int8w (B'), the xLSTM
    in bf16 (G's one-launch step), the Transformer (its plain step with
    per-slot offsets). Each request prefilled at batch 1 (A, D or H): exact
    launches, against the group-chunks the schedule predicts; every
    request's tokens grammatical; the same requests through
    serve.BatchScheduler at --slots 4 submitted in reverse order, and at 16
    slots (two groups of 8), give every request the same stream bit for bit.
    Greedy requests of SERVE_GREEDY_LENGTHS tokens on three of the prompts,
    served at 8 slots, equal sampler.generate at batch 1 on the same route
    (the kernels with the fused tail; the Transformer's plain step) bit for
    bit. Aggregate tok/s, the median and largest time to first chunk,
    per-request tok/s, the card's name and power limit."""
    import numpy as np

    from musicgen_tpu_torch.cli import serve as cli_serve
    from musicgen_tpu_torch.sample.sampler import generate
    from musicgen_tpu_torch.serve import BatchScheduler

    bands = ["Mozart", "Bach"]
    reqs = [{"composer": bands[i % 2], "length": n} for i, n in enumerate(SERVE_LENGTHS)]
    total = sum(SERVE_LENGTHS)
    for kind, quant in (("mamba", "bf16"), ("mamba", "int8w"), ("xlstm", "bf16"), ("transformer", "bf16")):
        model, tag = models[kind], f"{kind} {quant}"
        out = root / f"serve12_{kind}_{quant}"
        argv = ["--model", kind, "--ckpt", str(root / f"{kind}_random.pth"), "--data", str(corpus), "--metadata",
                str(meta_path), "--requests", json.dumps(reqs), "--output", str(out), "--stats",
                str(root / f"serve12_{kind}_{quant}.json"), "--slots", str(SERVE_SLOTS), "--chunk",
                str(SERVE_CHUNK), "--block-len", str(PROMPT), "--quant", quant, "--seed", str(SEED)]
        reset_launches()
        res = cli_serve.main(argv)
        torch.cuda.synchronize()
        pre, dec = read_launches()
        sched = res["scheduler"]
        chunks = serve_group_chunks(SERVE_LENGTHS, SERVE_SLOTS, SERVE_CHUNK)
        want = {} if kind == "transformer" else logits_step_launches(model, kind, chunks * SERVE_CHUNK, quant)
        want_pre = prefill_launches(model, kind, len(reqs))
        need(dec == want and pre == want_pre and sched.group_chunks == chunks,
             f"[12 serve {tag}] launches {dec}, prefill {pre}, {sched.group_chunks} group-chunks; expected {want}, "
             f"{want_pre}, {chunks}")
        count_row(f"[12 serve {tag}]", dec, pre)
        check_mids(out, f"served_*_{kind}_*.mid", len(reqs))
        stats = json.loads((root / f"serve12_{kind}_{quant}.json").read_text())
        need(sorted(stats) == ["aggregate_tok_per_s", "per_request", "requests", "total_tokens", "wall_s"]
             and stats["total_tokens"] == total, f"[12 serve {tag}] --stats {sorted(stats)}")
        requests = {rid: sched.requests[rid] for rid in res["tokens"]}
        for rid, r in requests.items():
            toks = torch.from_numpy(res["tokens"][rid])
            need(len(toks) == r.num_tokens, f"[12 serve {tag}] request {rid}: {len(toks)} tokens")
            need(grammatical(torch, torch.cat([torch.from_numpy(r.prompt[-1:]), toks])[None], 1),
                 f"[12 serve {tag}] request {rid}: a token breaks the grammar")
        same = {}
        for slots, order in ((4, sorted(requests, reverse=True)), (16, sorted(requests))):
            again = BatchScheduler(sched.model, kind, prompt_len=sched.prompt_len, slots=slots, chunk=SERVE_CHUNK,
                                   block_len=PROMPT, quant=quant)
            reset_launches()
            rids = {rid: again.submit(requests[rid].prompt, requests[rid].meta, requests[rid].num_tokens,
                                      requests[rid].seed) for rid in order}
            got = again.run()
            torch.cuda.synchronize()
            pre2, dec2 = read_launches()
            chunks2 = serve_group_chunks([requests[rid].num_tokens for rid in order], slots, SERVE_CHUNK)
            want2 = {} if kind == "transformer" else logits_step_launches(model, kind, chunks2 * SERVE_CHUNK, quant)
            need(dec2 == want2 and pre2 == want_pre and again.group_chunks == chunks2,
                 f"[12 serve {tag}] at {slots} slots: launches {dec2}, prefill {pre2}; expected {want2}, {want_pre}")
            count_row(f"[12 serve {tag}] ({slots} slots)", dec2, pre2)
            same[slots] = sum(bool((got[rids[rid]] == res["tokens"][rid]).all()) for rid in requests)
            del again
        greedy = BatchScheduler(sched.model, kind, prompt_len=sched.prompt_len, slots=SERVE_SLOTS, chunk=SERVE_CHUNK,
                                block_len=PROMPT, greedy=True, quant=quant)
        picks = [requests[rid] for rid in sorted(requests)[:len(SERVE_GREEDY_LENGTHS)]]
        gids = [greedy.submit(r.prompt, r.meta, n, r.seed) for r, n in zip(picks, SERVE_GREEDY_LENGTHS)]
        served = greedy.run()
        one_shot = []
        for r, gid, n in zip(picks, gids, SERVE_GREEDY_LENGTHS):
            ref = generate(sched.model, kind, torch.from_numpy(r.prompt)[None].to(DEVICE),
                           torch.from_numpy(r.meta)[None].to(DEVICE), n, PROMPT,
                           torch.Generator(device=DEVICE).manual_seed(r.seed), greedy=True, fused=greedy.fused,
                           quant=quant)
            got = torch.from_numpy(np.concatenate([r.prompt, served[gid]]))[None]
            one_shot.append(first_diffs(torch, got, ref, sched.prompt_len)[0])
        del greedy
        per = stats["per_request"].values()
        ttfc = sorted(p["ttfc_s"] for p in per)
        rate = sorted(p["tok_per_s"] for p in per)
        say(f"[12 serve {tag}] cli.serve --slots {SERVE_SLOTS} --chunk {SERVE_CHUNK}: {len(reqs)} stochastic "
            f"requests, {total} tokens, after {sched.prompt_len}-token prompts, in {stats['wall_s']:.2f} s = "
            f"{stats['aggregate_tok_per_s']:.1f} tok/s aggregate; time to first chunk median "
            f"{statistics.median(ttfc):.3f} s, largest {ttfc[-1]:.3f} s; per-request tok/s median "
            f"{statistics.median(rate):.1f} (min {rate[0]:.1f}, max {rate[-1]:.1f}); {chunks} group-chunks, "
            f"launches {dec or 'none (plain step)'}, prefill {pre}; grammatical; .mid files re-extract; streams bit "
            f"for bit with --slots 4 in reverse order {same[4]}/{len(reqs)}, with 16 slots (groups of 8) "
            f"{same[16]}/{len(reqs)}; greedy requests of {SERVE_GREEDY_LENGTHS} tokens against sampler.generate "
            f"at batch 1 (fused={sched.fused}): first differences {one_shot} (None: bit for bit); {card}")
        need(same[4] == same[16] == len(reqs), f"[12 serve {tag}] a request's stream depends on its pool")
        need(one_shot == [None] * len(one_shot), f"[12 serve {tag}] a greedy served stream differs from "
             f"sampler.generate at batch 1: {one_shot}")
        del res, sched
        torch.cuda.empty_cache()


def phase_serving(torch, root: Path, corpus: Path, meta_path: Path) -> dict:
    """Phase 12: [12 sampler ...], [12 prompt-len], [12 windowed ...] and
    [12 serve ...] on the reference models of phases 5, 7 and 9. Their
    kernels' launches go to PATH_LAUNCHES. Returns the models (phase 16
    runs on them)."""
    t0 = time.perf_counter()
    card = card_line()
    models = p12_models(torch, root)
    phase_p12_sampler(torch, models, root, corpus, meta_path)
    phase_p12_prompt_len(torch, models, root, corpus, meta_path)
    phase_p12_windowed(torch, models, root, corpus, meta_path)
    phase_p12_serve(torch, models, root, corpus, meta_path, card)
    say(f"[12 done] phase 12 in {time.perf_counter() - t0:.1f} s on {card}")
    return models


# ---------------------------------------------------------------------------
# Phase 13: GPTQ packs (--fused-decode int8w-gptq) on kernels B' and G
# ---------------------------------------------------------------------------

GPTQ_TOKENS = 256  # tokens of each [13 gptq <family>] CLI run
# Phase 13's models: the reference widths at a cut depth that keeps every
# kind of calibrated site (the host solve took 118-122 s a family at full
# depth, 21 and 31 sites).
GPTQ_DEPTH = {"mamba": {"n_layers": 1}, "xlstm": {"num_blocks": 2, "slstm_at": (1,)}}
# GPTQ's functional error over RTN's: below 1 at every site, and its median
# at most this (0.51-0.73 measured on an H100 at random weights), so that a pack that fell
# back to RTN at some sites (ratio 1) does not pass.
GPTQ_MAX_MEDIAN = 0.95


@contextlib.contextmanager
def gptq_capture(torch, cli, gptq, seen: dict):
    """While cli.generate --fused-decode int8w-gptq runs: the moments it
    collects, each (w, q, s) its quantizer hands the pack builder by site,
    and the seconds of its calibration forwards, of its pack's build (the
    GPTQ solves) and of its generation, with the pack it generated on."""
    real = {"collect": gptq.collect_hessians, "make": gptq.make_gptq_quantizer, "build": cli.build_pack,
            "generate": cli.generate}

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            seen[key + "_s"] = seen.get(key + "_s", 0.0) + time.perf_counter() - t0
            return out
        return run

    def make(hessians, *a, **k):
        quantize = real["make"](hessians, *a, **k)
        seen["hessians"], seen["sites"] = hessians, {}

        def recording(site, w):
            q, sc = quantize(site, w)
            seen["sites"][site] = (w, q, sc)
            return q, sc
        return recording

    def generate(*a, **k):
        seen["pack"] = k["decode_pack"]
        return timed("generate", real["generate"])(*a, **k)

    gptq.collect_hessians, gptq.make_gptq_quantizer = timed("calibrate", real["collect"]), make
    cli.build_pack, cli.generate = timed("solve", real["build"]), generate
    try:
        yield
    finally:
        gptq.collect_hessians, gptq.make_gptq_quantizer = real["collect"], real["make"]
        cli.build_pack, cli.generate = real["build"], real["generate"]


def gptq_site_ratios(torch, dk, kind: str, seen: dict) -> dict:
    """{site: GPTQ's functional error over RTN's} on the calibration inputs:
    ||X (W - Q)|| = sqrt(rows tr((W - Q) H (W - Q)^T)) with H = X^T X / rows,
    for W as the CLI's pack builder handed it to the quantizer (the moment
    zero-padded to a padded K, as the quantizer takes it) and the (q, s) the
    pack holds; also checks that every int8 matrix of the pack is a
    calibrated site and that its q is not RTN's."""
    sites = seen["sites"]
    need(sorted(sites) == sorted(seen["hessians"]), f"{kind}: the pack's sites {sorted(sites)} are not the "
         f"calibrated {sorted(seen['hessians'])}")
    same = [site for site, (w, q, _) in sites.items() if torch.equal(q, dk.quantize_cols(w)[0])]
    need(not same, f"{kind}: the GPTQ pack holds RTN's int8 matrices at {same}")

    def ferr(w, h, q, sc):
        deq = q.double() * sc.double().t().repeat_interleave(w.shape[1] // sc.shape[0], dim=1)
        d = w.double() - deq
        return float(((d @ h) * d).sum())

    ratios = {}
    for site, h in seen["hessians"].items():
        w, q, sc = sites[site]
        hp = torch.zeros(w.shape[1], w.shape[1], dtype=torch.float64, device=DEVICE)
        hp[:h.shape[0], :h.shape[0]] = torch.from_numpy(h)
        ratios[site] = math.sqrt(ferr(w, hp, q, sc) / ferr(w, hp, *dk.quantize_cols(w)))
    return ratios


def gptq_steps(torch, dk, xk, sampler, model, kind: str, pack, src, meta) -> str:
    """QUANT_STEPS teacher-forced steps (the prompt's first tokens) from the
    prefill state, each from a shared state: the W8A16 kernel path on the
    GPTQ pack (Mamba: B's chain with B' W8A16; xLSTM: G's one-launch step)
    against the plain chain on the same pack, logits and states, within
    the tolerance of [4q steps] (TOL_STEPS) or of [9 xdecode steps]
    (max(TOL_T_STEP, twice the plain chain's response to a 1e-6 perturbation
    of the state)). Returns the row's text."""
    _, states = model.prefill(src, meta)
    carry = sampler.kernel_carry(model, kind, "int8w", BATCH)[0](states)
    noise = torch.Generator(device=DEVICE).manual_seed(SEED)
    if kind == "mamba":
        dims = dk.DecodeDims.create(model.cfg, BATCH)
        v, perturb = dims.vocab_size, (1,)
        kern = lambda tok, c: dk.decode_logits(pack, tok, c, dims, quant="w8a16")  # noqa: E731
        plain = lambda tok, c: dk.decode_logits(pack, tok, c, dims, ops=dk.PLAIN_OPS, quant="w8a16")  # noqa: E731
    else:
        dims = xk.XDims.create(model.cfg, BATCH)
        v, perturb = dims.vocab_size, (2, 5)
        kern = lambda tok, c: xk.xlstm_step(pack, tok, c, dims, "w8a16")  # noqa: E731
        plain = lambda tok, c: xk.xlstm_decode_logits(pack, tok, c, dims, ops=xk.PLAIN_OPS, quant="w8a16")  # noqa: E731
    worst_logit = worst_state = worst_noise = 0.0
    for i in range(QUANT_STEPS):
        tok = src[:, i]
        cp, cn = clone(carry), clone(carry)
        for j in perturb:
            cn[j].mul_(1.0 + 1e-6 * torch.randn(cn[j].shape, device=DEVICE, generator=noise))
        lk, lp, ln = kern(tok, carry), plain(tok, cp), plain(tok, cn)
        worst_logit = max(worst_logit, rel_err(lk[:, :v], lp[:, :v])[1])
        worst_noise = max(worst_noise, rel_err(ln[:, :v], lp[:, :v])[1])
        worst_state = max(worst_state, *(rel_err(a.float(), b_.float())[1] for a, b_ in zip(carry, cp)))
    torch.cuda.synchronize()
    tol = TOL_STEPS if kind == "mamba" else max(TOL_T_STEP, 2.0 * worst_noise)
    need(worst_logit <= tol and worst_state <= tol, f"{kind}: the W8A16 kernels on the GPTQ pack disagree with "
         f"the plain chain: logits rel {worst_logit:.3e}, states rel {worst_state:.3e}, tol {tol:.3e}")
    route = "B's chain with B' W8A16" if kind == "mamba" else "G's one-launch step in W8A16"
    return (f"{QUANT_STEPS} teacher-forced steps of {route} on the GPTQ pack vs the plain chain: logits rel "
            f"{worst_logit:.3e}, states rel {worst_state:.3e} (tol {tol:.3e}; the plain chain's response to a 1e-6 "
            f"perturbation {worst_noise:.3e})")


def phase_gptq(torch, root: Path, corpus: Path, meta_path: Path) -> None:
    """Phase 13, [13 gptq mamba] and [13 gptq xlstm]: `cli.generate
    --fused-decode int8w-gptq` at the reference width and the depth of
    GPTQ_DEPTH (seeded random weights) for GPTQ_TOKENS greedy tokens: the
    calibration on the
    synthesized corpus and the solve timed, every token grammatical, exact
    launches (Mamba: A a layer a calibration forward and a prefill, B'
    W8A16 and B's mixer a layer and the tail a token; xLSTM: H an sLSTM
    block a calibration forward and a prefill, G's W8A16 step and the tail
    a token), tok/s/seq of the generation (prefill included);
    then, on what the CLI calibrated and solved: GPTQ's functional error
    below RTN's at every site, its median at most GPTQ_MAX_MEDIAN, no int8
    matrix RTN's (gptq_site_ratios), and the W8A16 kernels on the GPTQ pack
    against their plain versions (gptq_steps)."""
    from musicgen_tpu_torch.cli import generate as cli
    from musicgen_tpu_torch.config import MambaConfig, XLSTMConfig
    from musicgen_tpu_torch.models import mamba, xlstm
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops import gptq
    from musicgen_tpu_torch.ops import xdecode_kernel as xk
    from musicgen_tpu_torch.sample import sampler

    for kind, module, cfg in (("mamba", mamba, MambaConfig), ("xlstm", xlstm, XLSTMConfig)):
        model = module.init_weights_(module.empty_model(cfg(**GPTQ_DEPTH[kind]), DEVICE), SEED).eval()
        torch.save(model.state_dict(), root / f"{kind}_random.pth")
        seen: dict = {}
        with gptq_capture(torch, cli, gptq, seen):
            streams, secs, pre, dec = run_generate_cli(torch, kind, root, corpus, meta_path, f"gptq {kind}",
                                                       "--fused-decode", "int8w-gptq", "--greedy", "--length",
                                                       str(GPTQ_TOKENS))
        want_pre = prefill_launches(model, kind, 4 + 1)  # the 4 calibration forwards and the prefill
        want_dec = {**logits_step_launches(model, kind, GPTQ_TOKENS, "int8w"), "sample_tail": GPTQ_TOKENS}
        ratios = gptq_site_ratios(torch, dk, kind, seen)
        worst = max(ratios, key=ratios.get)
        src, meta = cli_prompts(torch, corpus, meta_path, PROMPT)
        steps = gptq_steps(torch, dk, xk, sampler, model, kind, seen["pack"], src, meta)
        say(f"[13 gptq {kind}] cli.generate --fused-decode int8w-gptq, {GPTQ_TOKENS} greedy tokens at batch {BATCH} "
            f"after a {PROMPT}-token prompt in {secs:.1f} s: calibration forwards {seen['calibrate_s']:.2f} s, "
            f"GPTQ solve of {len(seen['hessians'])} sites {seen['solve_s']:.2f} s (host numpy), generation "
            f"{seen['generate_s']:.2f} s = {GPTQ_TOKENS / seen['generate_s']:.1f} tok/s/seq (prefill included); "
            f"{'grammatical' if grammatical(torch, streams, PROMPT) else 'NOT grammatical'}; launches {pre} and "
            f"{dec}; GPTQ's functional error over RTN's at every site: worst {ratios[worst]:.4f} ({worst}), best "
            f"{min(ratios.values()):.4f}, median {statistics.median(ratios.values()):.4f}; {steps}")
        need(grammatical(torch, streams, PROMPT), f"[13 gptq {kind}]: a generated token breaks the grammar")
        need(pre == want_pre and dec == want_dec, f"[13 gptq {kind}]: launches {pre}, {dec}; expected {want_pre}, "
             f"{want_dec}")
        need(ratios[worst] < 1.0, f"[13 gptq {kind}]: GPTQ's functional error is not below RTN's at {worst}")
        need(statistics.median(ratios.values()) <= GPTQ_MAX_MEDIAN,
             f"[13 gptq {kind}]: GPTQ's median functional error over RTN's exceeds {GPTQ_MAX_MEDIAN}")
        count_row(f"[13 gptq {kind}]", pre, dec)
        del model, seen
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 10: the two Hopper probes (kernel I, the bf16 weight-streaming
# product; kernel J, the ablated Mamba decode step)
# ---------------------------------------------------------------------------


def kernel_check(torch, tag: str, name: str, outs, refs, tol: float, kernel, plain, cost: dict, report: dict,
                 library=None, note: str = "") -> None:
    """A kernel against its plain version on the same inputs, with its
    times (host-paced, from a CUDA graph), its bound and the library call's
    (`library`, F.linear where given: host-paced and from a CUDA graph);
    the numbers go into report[name]."""
    errs = [rel_err(a, b) for a, b in zip(outs, refs)]
    worst_abs, worst_rel = max(e[0] for e in errs), max(e[1] for e in errs)
    ms, dev_ms, plain_ms = cuda_ms(torch, kernel), graph_ms(torch, kernel), cuda_ms(torch, plain)
    lib = NO_LIBRARY if library is None else library_time(torch, "F.linear", library)
    say(f"[{tag} {name}] max_abs {worst_abs:.3e} rel {worst_rel:.3e} (tol rel {tol}); kernel {ms:.4f} ms (device, "
        f"CUDA graph{note}: {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, bound {cost['bound_ms']:.4f} ms "
        f"({cost['bound_by']}), {lib.text()}")
    need(all(bool(torch.isfinite(a).all()) for a in outs), f"{name}: non-finite output")
    need(worst_rel <= tol, f"{name} disagrees with its plain version")
    report[name] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms, "library_ms": lib.ms, **cost}


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


def mamba_model(torch):
    """The full-size MambaLM with seeded random weights, on the card."""
    from musicgen_tpu_torch.config import MambaConfig
    from musicgen_tpu_torch.models.mamba import empty_model, init_weights_

    model = init_weights_(empty_model(MambaConfig(), DEVICE), SEED).eval()
    n_params = sum(p.numel() for p in model.parameters())
    need(n_params == 101_972_666, f"full-size MambaLM has {n_params} parameters")
    return model


def phase_int8_paths(torch, report: dict) -> None:
    """--only int8: every row of phases 4q, 6, 7 and 9 that launches the
    int8 GEMVs, with the checks and timings of the full run. Each int8
    kernel's launches are those of the CLI runs of phases 6, 7 and 9 that
    take an int8 format, each counted from zero, as in the full run."""
    model = mamba_model(torch)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        corpus, meta_path = synth_corpus(root)
        ctx = decode_context(torch, model, corpus, meta_path)
        phase_int8(torch, model, ctx, report)
        packs = phase_resident(torch, model, ctx, report, {k: q for k, q in QUANTS.items() if q != "none"})
        phase_loop(torch, ctx, packs, report)
        phase_cli_resident(torch, model, corpus, meta_path, root, report, int8_only=True)
        del model, ctx, packs
        torch.cuda.empty_cache()
        tctx = phase_t_prefill(torch, corpus, meta_path)
        phase_t_decode(torch, tctx, report, {"int8w": TQUANTS["int8w"]})
        phase_t_cli(torch, tctx, corpus, meta_path, root, report, int8_only=True)
        del tctx
        torch.cuda.empty_cache()
        xctx = phase_x_prefill(torch, corpus, meta_path)
        xpacks = phase_x_decode(torch, xctx, report, {q: XQUANTS[q] for q in ("int8w", "int8w-sb16")})
        phase_x_cli(torch, xctx, corpus, meta_path, root, report, int8_only=True)
        phase_x_loop(torch, xctx, xpacks, report)


def phase_bf16_paths(torch, report: dict) -> None:
    """--only bf16: every row that launches the bf16 GEMV (decode_ops.cuh
    gemv_team in bf16), with the checks and timings of the full run: [4] and
    [4 steps], [4 gemv ragged], [5 cli] and [5 loop], [6 resident], [6
    chain], [6 loop] and the [6 cli] runs in bf16, [7 tdecode], the bf16 [7
    cli] runs and [7 loop] in bf16, [9 xdecode], the bf16 [9 cli] runs and
    [9 loop] in bf16 and sb16, and phase 10. Each kernel's launches are
    those of the CLI runs (ablate_gemv's those of kernel_ablate.run), each
    counted from zero, as in the full run."""
    model = mamba_model(torch)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        corpus, meta_path = synth_corpus(root)
        ctx = decode_context(torch, model, corpus, meta_path)
        phase_decode(torch, model, ctx, report)
        phase_gemv_ragged(torch)
        phase_cli(torch, model, corpus, meta_path, root, report)
        packs = phase_resident(torch, model, ctx, report, {"bf16": QUANTS["bf16"]})
        phase_loop(torch, ctx, packs, report)
        phase_cli_resident(torch, model, corpus, meta_path, root, report, bf16_only=True)
        del model, ctx, packs
        torch.cuda.empty_cache()
        tctx = phase_t_prefill(torch, corpus, meta_path)
        tpacks = phase_t_decode(torch, tctx, report, {"bf16": TQUANTS["bf16"]})
        phase_t_cli(torch, tctx, corpus, meta_path, root, report, bf16_only=True)
        phase_t_loop(torch, tctx, tpacks)
        del tctx, tpacks
        torch.cuda.empty_cache()
        xctx = phase_x_prefill(torch, corpus, meta_path)
        xpacks = phase_x_decode(torch, xctx, report, {q: XQUANTS[q] for q in ("bf16", "bf16-sb16")})
        phase_x_cli(torch, xctx, corpus, meta_path, root, report, bf16_only=True)
        phase_x_loop(torch, xctx, xpacks, report)
        del xctx, xpacks
    torch.cuda.empty_cache()
    phase_probes(torch, report)


def phase_transformer(torch, corpus: Path, meta_path: Path, root: Path, report: dict) -> None:
    """Phase 7: the Transformer's generation, kernels D and F."""
    phase_t_flash(torch, report)
    tctx = phase_t_prefill(torch, corpus, meta_path)
    tpacks = phase_t_decode(torch, tctx, report)
    phase_t_wrap(torch, corpus)
    phase_t_cli(torch, tctx, corpus, meta_path, root, report)
    phase_rows(torch, "transformer", tctx["model"], corpus, meta_path, root)
    phase_t_loop(torch, tctx, tpacks)


def phase_flash_paths(torch, report: dict) -> None:
    """--only flash: every row of phases 7 and 8 that launches kernel D or E,
    with the checks and timings of the full run: [7 flash], [7 prefill],
    [7 wrap], the bf16 [7 cli] runs, [8 flash-bwd], [8 grad], and [8 steps]
    and [8 cli] for the Transformer. The kernels' launches are those of the
    CLI runs, each counted from zero, as in the full run."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        corpus, meta_path = synth_corpus(root)
        phase_t_flash(torch, report)
        tctx = phase_t_prefill(torch, corpus, meta_path)
        phase_t_wrap(torch, corpus)
        phase_t_cli(torch, tctx, corpus, meta_path, root, report, bf16_only=True)
        del tctx
        torch.cuda.empty_cache()
        phase_flash_bwd(torch, report)
        torch.cuda.empty_cache()
        phase_grad(torch, corpus, meta_path)
        torch.cuda.empty_cache()
        phase_grad(torch, corpus, meta_path, "bf16")
        torch.cuda.empty_cache()
        phase_train_steps(torch, corpus, meta_path, ("transformer",))
        phase_train_split(torch, corpus, meta_path, ("transformer",))
        phase_train_cli(torch, corpus, meta_path, root, report, ("transformer",))
        phase_ddp(torch, corpus, meta_path)
        phase_cli_parallel(torch, corpus, meta_path, root)


def phase_training(torch, report: dict) -> None:
    """--only 8: phases 1 and 2 and every row of phase 8 (training): [8
    flash-bwd] with its repeat and ragged rows, [8 grad] and [8 grad bf16],
    [8 steps] and [8 split] of each family in f32 and bf16, [8 cli] of each
    family in f32 and bf16, [8 ddp] and [8 cli parallel]. Its kernels line
    holds D with LSE's and E's five launches, those of the f32 Transformer's
    [8 cli] run plus those of the bf16 run and [8 ddp]."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        corpus, meta_path = synth_corpus(root)
        with clock("8 flash-bwd"):
            phase_flash_bwd(torch, report)
        torch.cuda.empty_cache()
        with clock("8 grad"):
            phase_grad(torch, corpus, meta_path)
            torch.cuda.empty_cache()
            phase_grad(torch, corpus, meta_path, "bf16")
        torch.cuda.empty_cache()
        with clock("8 steps"):
            phase_train_steps(torch, corpus, meta_path)
        with clock("8 split"):
            phase_train_split(torch, corpus, meta_path)
        with clock("8 cli"):
            phase_train_cli(torch, corpus, meta_path, root, report)
        torch.cuda.empty_cache()
        with clock("8 ddp"):
            phase_ddp(torch, corpus, meta_path)
            phase_cli_parallel(torch, corpus, meta_path, root)


def phase_tail_paths(torch, report: dict, parent: Path | None) -> None:
    """--only tail: every row that holds the sampler tail (kernel B's
    sample_tail and kernel C's spread tail), with the checks and timings of the
    full run: phase 4 with [4 sample_tail ...] (with --parent DIR the parent
    tree's tail in turns), [5 cli] (the tail's launches on the Mamba CLI
    path, counted from zero), [6 resident], [6 chain] (C bit for bit with
    B's chain and its tail), [6 loop] (with --parent DIR the parent tree's C
    in turns), [7 tdecode] with its steps (kernel F's chain with the tail)
    and [9 xdecode] with [9 xstep] (kernel G's step with the tail, bit for bit
    with the chain) in every format."""
    model = mamba_model(torch)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        corpus, meta_path = synth_corpus(root)
        ctx = decode_context(torch, model, corpus, meta_path)
        phase_decode(torch, model, ctx, report)
        phase_tail(torch, ctx, parent)
        phase_cli(torch, model, corpus, meta_path, root, report)
        packs = phase_resident(torch, model, ctx, report)
        phase_loop(torch, ctx, packs, report, parent)
        del model, ctx, packs
        torch.cuda.empty_cache()
        tctx = phase_t_prefill(torch, corpus, meta_path)
        phase_t_decode(torch, tctx, report)
        del tctx
        torch.cuda.empty_cache()
        xctx = phase_x_prefill(torch, corpus, meta_path)
        phase_x_decode(torch, xctx, report)


# ---------------------------------------------------------------------------
# Phase 14: diffusion, the canvas UNet, the Gaussian/RePaint sampler and the
# two diffusion CLIs (no kernel of the port: convs, group norms and matmuls)
# ---------------------------------------------------------------------------

TOL_UNET_F32 = 1e-4  # card against CPU, f32 (TF32 off), of the output's largest value
TOL_UNET_BF16 = 1e-1  # bf16 against f32 on the card: bf16's rounding over about 100 convs and norms
TOL_SAMPLE = 1e-4  # [14 sample]'s step, card against CPU, of the largest value
UNET_BATCHES = (1, 8)
UNET_GRAPH = dict(calls=5, replays=3)  # a batch-8 f32 forward takes tens of ms
D_TRAIN_STEPS = 10
D_TRAIN_LR = 1e-4  # cli.train_diffusion's --lr (at 1e-3 the full-size loss oscillated: 1.003 -> 0.780 -> 1.004)
D_BATCH = 8
D_CLI_STEPS = 20
D_MASK = (32, 96)  # cli.inpaint's default masked columns at width 128


def all_launches() -> dict:
    """Every kernel's launch counter, by name (A and H by their wrapper's
    attribute, the rest from their modules' LAUNCHES)."""
    from musicgen_tpu_torch.ops import ablate_kernel, probe_kernel
    from musicgen_tpu_torch.ops import attention_kernel as ak
    from musicgen_tpu_torch.ops import decode_kernel as dk
    from musicgen_tpu_torch.ops.slstm_kernel import slstm_scan
    from musicgen_tpu_torch.ops.ssd_kernel import ssd_scan

    return {"ssd_scan": ssd_scan.launches, "slstm_scan": slstm_scan.launches, **ak.LAUNCHES, **dk.LAUNCHES,
            **probe_kernel.LAUNCHES, **ablate_kernel.LAUNCHES}


def diffusion_random_(torch, model, seed: int = SEED):
    """Seeded random values on every tensor of a diffusion model (none zero,
    the zero-initialised output convs included): kernels N(0, 1/fan_in),
    norm scales 1 + N(0, 0.01), biases N(0, 0.01); drawn on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            for name, p in m.named_parameters(recurse=False):
                r = torch.randn(p.shape, generator=gen)
                if p.ndim > 1:
                    p.copy_(r * p[0].numel() ** -0.5)
                elif isinstance(m, torch.nn.GroupNorm) and name == "weight":
                    p.copy_(1.0 + 0.1 * r)
                else:
                    p.copy_(0.1 * r)
    return model


def corpus_canvas(corpus: Path):
    """The normalised canvas of the corpus's first token file (its first
    4,000 tokens, as cli.train_diffusion reads them), padded with -1 and
    cropped to 128 columns, as (1, 4, 128, 128); and its notes."""
    import numpy as np

    from musicgen_tpu_torch.cli.train_diffusion import build_canvases
    from musicgen_tpu_torch.data.dataset import find_token_files
    from musicgen_tpu_torch.midi import decode

    path = find_token_files(corpus)[0]
    canvas = build_canvases(str(Path(path).parent), 1)[0]
    if canvas.shape[-1] < 128:
        canvas = np.pad(canvas, ((0, 0), (0, 0), (0, 128 - canvas.shape[-1])), constant_values=-1.0)
    return canvas[None, :, :, :128].astype(np.float32), decode([int(t) for t in np.load(path)[:4000]])


def unet_flops(torch, model, x, t) -> float:
    """The operations of model(x, t) by torch's FlopCounterMode (products
    and convolutions)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        model(x, t)
    return float(fc.get_total_flops())


def phase_diffusion(torch, corpus: Path, root: Path, card: str) -> None:
    """Phase 14 (the module docstring lists its rows)."""
    before = all_launches()
    phase_repaint(torch, *phase_unet_and_sample(torch, corpus, card))
    torch.cuda.empty_cache()
    phase_diffusion_train(torch, corpus, card)
    torch.cuda.empty_cache()
    phase_diffusion_cli(torch, corpus, root)
    after = all_launches()
    names = set(KERNEL_INFO) | set(before) | set(after)
    moved = {k: after.get(k, 0) - before.get(k, 0) for k in names if after.get(k, 0) != before.get(k, 0)}
    need(not moved, f"[14] kernels launched on the diffusion paths: {moved}")
    say(f"[14 launches] no kernel launched in phase 14: {len(names)} launch counters unchanged "
        f"({sum(before.values())} launches before it, {sum(after.values())} after)")


def phase_unet_and_sample(torch, corpus: Path, card: str) -> tuple:
    """[14 unet] and [14 sample]; returns the UNet's config, its random
    weights and the corpus canvas, for [14 repaint]."""
    import numpy as np

    from musicgen_tpu_torch.diffusion import DiffusionDefaults, create_gaussian_diffusion
    from musicgen_tpu_torch.diffusion import unet
    from musicgen_tpu_torch.diffusion.factories import unet_config

    d = dataclasses.replace(DiffusionDefaults(image_size=128), timestep_respacing="ddim25")
    cfg = unet_config(d)
    m32 = diffusion_random_(torch, unet.empty_model(unet.UNetModel, DEVICE, cfg, torch.float32)).eval()
    m16 = unet.empty_model(unet.UNetModel, DEVICE, cfg, torch.bfloat16).eval()
    m16.load_state_dict(m32.state_dict())
    cpu = unet.empty_model(unet.UNetModel, "cpu", cfg, torch.float32).eval()
    cpu.load_state_dict(m32.state_dict())
    n_params = sum(p.numel() for p in m32.parameters())
    sd = create_gaussian_diffusion(d)

    # [14 sample]: one p_sample step with ground-truth injection at spaced t
    # 12, on the card and on the CPU, with the same draws (from the CPU).
    gt, _ = corpus_canvas(corpus)
    gen = torch.Generator().manual_seed(SEED)
    shape = gt.shape
    x, noise, gt_noise = (torch.randn(shape, generator=gen) for _ in range(3))
    keep = torch.ones(shape)
    keep[..., D_MASK[0]:D_MASK[1]] = 0.0
    t = torch.full((1,), 12, dtype=torch.long)
    outs = {}

    def step(model, dev):
        seen = []

        def fn(xx, tt):
            out = model(xx, tt)
            seen.append((xx, tt, out))
            return out

        t0 = time.perf_counter()
        res = sd.base.p_sample(sd.wrap_model(fn), x.to(dev), t.to(dev), noise.to(dev), torch.from_numpy(gt).to(dev),
                               keep.to(dev), gt_noise.to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
        return [r.cpu() for r in res], [a.cpu() for a in seen[0]], time.perf_counter() - t0

    (card_s, card_x0), card_seen, _ = step(m32, DEVICE)
    (cpu_s, cpu_x0), cpu_seen, cpu_secs = step(cpu, "cpu")
    need(torch.equal(card_seen[1], cpu_seen[1]) and int(cpu_seen[1][0]) == int(sd.timestep_map[12]),
         "[14 sample] the model saw another timestep")
    f32_err = rel_err(card_seen[2], cpu_seen[2])
    need(bool(torch.isfinite(card_seen[2]).all()) and f32_err[1] <= TOL_UNET_F32,
         f"[14 unet] card f32 forward vs CPU: {f32_err} (tolerance {TOL_UNET_F32} of max |out|)")
    xin = card_seen[0].to(DEVICE)
    tin = card_seen[1].to(DEVICE)
    out16 = m16(xin, tin)
    need(out16.dtype == torch.bfloat16, "[14 unet] the bf16 model's output is not bf16")
    bf_err = rel_err(out16.float().cpu(), card_seen[2])
    need(0 < bf_err[1] <= TOL_UNET_BF16, f"[14 unet] bf16 vs f32 on the card: {bf_err} (tolerance {TOL_UNET_BF16})")
    flops = unet_flops(torch, m32, xin, tin)
    say(f"[14 unet] UNetModel DiffusionDefaults(image_size=128): {n_params:,} parameters, canvas {tuple(shape[1:])}; "
        f"card f32 forward (TF32 off) vs CPU f32 at batch 1: max_abs {f32_err[0]:.3e} ({f32_err[1]:.3e} of max |out| "
        f"{float(cpu_seen[2].abs().max()):.3f}, tolerance {TOL_UNET_F32}; the CPU forward {cpu_secs:.2f} s); bf16 vs "
        f"f32 on the card {bf_err[0]:.3e} ({bf_err[1]:.3e}, tolerance {TOL_UNET_BF16}); {flops / 1e9:.3f} GFLOP a "
        f"forward at batch 1 (FlopCounterMode); {card}")
    for b in UNET_BATCHES:
        xb = torch.randn((b,) + tuple(shape[1:]), generator=gen).to(DEVICE)
        tb = torch.randint(0, 1000, (b,), generator=gen).to(DEVICE)
        for name, model, peak in (("bf16", m16, BF16_FLOPS), ("f32", m32, F32_FLOPS)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            host = median_ms(torch, lambda: model(xb, tb))
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            graph = graph_ms(torch, lambda: model(xb, tb), **UNET_GRAPH)
            bnd = bound(nbytes(*model.parameters()) + xb.numel() * 4 + 2 * xb.numel() * (2 if name == "bf16" else 4),
                        b * flops, peak)
            say(f"[14 unet {name} batch {b}] {host:.3f} ms host-paced (median of 5), {fmt_ms(graph)} in a CUDA graph; "
                f"bound {bnd['bound_ms']:.3f} ms ({bnd['bound_by']}: {b * flops / 1e9:.1f} GFLOP at the "
                f"{name} peak); peak memory {mem:.2f} GiB")
    samp_err, x0_err = rel_err(card_s, cpu_s), rel_err(card_x0, cpu_x0)
    need(samp_err[1] <= TOL_SAMPLE and x0_err[1] <= TOL_SAMPLE and bool(torch.isfinite(card_s).all()),
         f"[14 sample] card vs CPU: sample {samp_err}, pred_xstart {x0_err} (tolerance {TOL_SAMPLE})")
    kept = float((card_s - torch.from_numpy(gt)).abs()[keep.bool()].mean())
    say(f"[14 sample] p_sample at spaced t 12 (timestep {int(sd.timestep_map[12])}) with ground truth and keep "
        f"mask, f32, card vs CPU on the same draws: sample max_abs {samp_err[0]:.3e} ({samp_err[1]:.3e}), "
        f"pred_xstart {x0_err[0]:.3e} ({x0_err[1]:.3e}), tolerance {TOL_SAMPLE}; mean |sample - gt| on the kept "
        f"columns {kept:.4f}")
    state = m16.state_dict()
    del m32, m16, cpu
    torch.cuda.empty_cache()
    return cfg, state, gt


def phase_repaint(torch, cfg, state: dict, gt) -> None:
    """[14 repaint]: cli.inpaint's jump schedule through the API, in bf16, on
    the UNet `cfg` with weights `state` and the ground truth `gt`."""
    from musicgen_tpu_torch.diffusion import DiffusionDefaults, RePaintConf, create_gaussian_diffusion
    from musicgen_tpu_torch.diffusion import unet

    model = unet.empty_model(unet.UNetModel, DEVICE, cfg, torch.bfloat16).eval()
    model.load_state_dict(state)
    sd = create_gaussian_diffusion(dataclasses.replace(DiffusionDefaults(), timestep_respacing="ddim25"))
    times = RePaintConf(schedule_jump_params=dict(t_T=sd.num_timesteps, n_sample=1, jump_length=10,
                                                  jump_n_sample=10)).jump_times()
    pairs = list(zip(times[:-1], times[1:]))
    downs = sum(b < a for a, b in pairs)
    need(len(pairs) == 385 and downs == 205, f"[14 repaint] the ladder has {len(pairs)} steps, {downs} denoising")
    events, outs = [], []

    def fn(x, t):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = model(x, t)
        ev[1].record()
        events.append(ev)
        outs.append(out)
        return out

    keep = torch.ones(gt.shape, device=DEVICE)
    keep[..., D_MASK[0]:D_MASK[1]] = 0.0
    gtd = torch.from_numpy(gt).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sd.p_sample_loop_scan(fn, gt.shape, gen, gt=gtd, gt_keep_mask=keep, times=times)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    need(len(events) == 205, f"[14 repaint] {len(events)} UNet forwards, not 205")
    finite = all(bool(torch.isfinite(o).all()) for o in outs) and bool(torch.isfinite(out).all())
    need(finite, "[14 repaint] a UNet output or the sample is not finite")
    dev_ms = [a.elapsed_time(b) for a, b in events]
    say(f"[14 repaint] ddim25, jump length 10 x 10 samples: {len(pairs)} steps, {len(events)} UNet forwards "
        f"(bf16, batch 1), every output finite; {secs:.3f} s, {1e3 * secs / len(events):.3f} ms a denoising step "
        f"(host clock), the UNet forward {statistics.median(dev_ms):.3f} ms median ({sum(dev_ms) / 1e3:.3f} s in "
        f"all; CUDA events); mean |out - gt| on the kept columns "
        f"{float((out - gtd).abs()[keep.bool()].mean()):.4f}")
    del model, outs
    torch.cuda.empty_cache()


def phase_diffusion_train(torch, corpus: Path, card: str) -> None:
    """[14 train]: D_TRAIN_STEPS bf16 Adam steps at batch D_BATCH on one
    batch of corpus canvases and one draw of t and noise, from the
    factories' init."""
    from musicgen_tpu_torch.cli.train_diffusion import build_canvases
    from musicgen_tpu_torch.diffusion import DiffusionDefaults, RandomSnippet, create_model_and_diffusion
    from musicgen_tpu_torch.diffusion.trainer import draw_step, make_diffusion_train_step

    canvases = build_canvases(str(corpus), 200)
    batch = torch.from_numpy(RandomSnippet(canvases, width=128, seed=SEED).sample(D_BATCH)).to(DEVICE)
    with torch.enable_grad():
        model, sd = create_model_and_diffusion(DiffusionDefaults(image_size=128), torch.bfloat16, DEVICE, SEED)
        t, noise = draw_step(batch, sd.num_timesteps, torch.Generator(device=DEVICE).manual_seed(SEED))
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
        step = make_diffusion_train_step(model, sd, torch.optim.Adam(model.parameters(), lr=D_TRAIN_LR))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, secs = [], []
        for _ in range(D_TRAIN_STEPS):
            t0 = time.perf_counter()
            loss, terms = step(ema, batch, t, noise)
            losses.append(float(loss))  # synchronises
            secs.append(time.perf_counter() - t0)
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    need(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0], f"[14 train] losses {losses}")
    say(f"[14 train] {D_TRAIN_STEPS} bf16 Adam steps (lr {D_TRAIN_LR}, EMA) at batch {D_BATCH} x (4, 128, 128), "
        f"{len(canvases)} corpus canvases: loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
        f"{1e3 * statistics.median(secs[1:]):.2f} ms/step median of steps 2-{D_TRAIN_STEPS} (host clock, "
        f"synchronised; the first {1e3 * secs[0]:.1f}); peak memory {mem:.2f} GiB; {card}")
    del model, ema, step
    torch.cuda.empty_cache()


def phase_diffusion_cli(torch, corpus: Path, root: Path) -> None:
    """[14 cli train] and [14 cli inpaint], the CLIs' main() in this
    process (so that the launch counters see them)."""
    from musicgen_tpu_torch.cli import inpaint as inpaint_cli
    from musicgen_tpu_torch.cli import train_diffusion as train_cli
    from musicgen_tpu_torch.diffusion import create_model
    from musicgen_tpu_torch.diffusion.unet import UNetModel
    from musicgen_tpu_torch.interop import DIFFUSION_FILE
    from musicgen_tpu_torch.midi import extract_midi, note_to_midi

    ckpt = root / "diffusion14"
    t0 = time.perf_counter()
    with torch.enable_grad():
        params, ema = train_cli.main(["--data", str(corpus), "--steps", str(D_CLI_STEPS), "--batch", str(D_BATCH),
                                      "--ckpt", str(ckpt), "--seed", str(SEED), "--device", DEVICE])
    secs = time.perf_counter() - t0
    saved = torch.load(ckpt / DIFFUSION_FILE, map_location="cpu", weights_only=True)
    model = create_model(train_cli.DEFAULTS, torch.bfloat16, DEVICE)
    for key, want in (("params", params), ("ema", ema)):
        model.load_state_dict(saved[key], strict=True)
        got = model.state_dict()
        need(all(torch.equal(got[k], want[k]) for k in want), f"[14 cli train] the checkpoint's {key} reload unequal")
    moved = sum(float((saved["params"][k] - saved["ema"][k]).abs().sum()) for k in saved["params"])
    say(f"[14 cli train] cli.train_diffusion --steps {D_CLI_STEPS} --batch {D_BATCH} --ckpt: returned in "
        f"{secs:.1f} s (canvases, init and the steps); {DIFFUSION_FILE} of {len(saved['params'])} f32 tensors, params "
        f"and EMA read back equal (|params - ema| summed {moved:.4f})")
    del model, params, ema, saved
    torch.cuda.empty_cache()

    _, notes = corpus_canvas(corpus)
    mid = root / "inpaint14_in.mid"
    note_to_midi(notes, str(mid))
    forwards = []
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda m, args: forwards.append(1) if isinstance(m, UNetModel) else None)
    try:
        for tag, extra, n in (("plain", [], 25), ("jumps ema", ["--jumps", "--ema"], 205)):
            out = root / f"inpaint14_{tag.replace(' ', '_')}.mid"
            forwards.clear()
            t0 = time.perf_counter()
            got = inpaint_cli.main(["--ckpt", str(ckpt), "--midi", str(mid), "--out", str(out), "--device", DEVICE,
                                    *extra])
            secs = time.perf_counter() - t0
            back = extract_midi(str(out))
            need(len(forwards) == n, f"[14 cli inpaint {tag}] {len(forwards)} UNet forwards, not {n}")
            need(len(back) > 0, f"[14 cli inpaint {tag}] {out.name} re-extracts with no notes")
            say(f"[14 cli inpaint {tag}] cli.inpaint --respacing ddim25{''.join(' ' + a for a in extra)}: returned in {secs:.2f} s "
                f"({len(forwards)} UNet forwards, {1e3 * secs / n:.2f} ms each with the step, init and I/O "
                f"included); {len(got)} notes written, {len(back)} re-extracted from {out.name}")
    finally:
        hook.remove()


# ---------------------------------------------------------------------------
# Phase 15: the multi-rank training strategies (parallel/), each in a one-rank
# NCCL group of this process
# ---------------------------------------------------------------------------

P15_M = 2  # GPipe microbatches of [15 pp ...]: one row each at batch 2
P15_STEPS = 3  # timed Adam steps of each strategy and of the unsharded step, in turns, after the held step
TOL_P15_LOSS = 1e-5  # relative, against the unsharded step's loss
TOL_P15_GRAD = 1e-3  # of each gradient tensor's largest value; the rows print the worst


def moved_since(before: dict) -> dict:
    """Every kernel launch counter's rise since the all_launches() snapshot
    `before`, where it rose."""
    now = all_launches()
    return {n: c - before.get(n, 0) for n, c in now.items() if c != before.get(n, 0)}


def held(torch, model, fn) -> tuple:
    """(loss, {name: gradient}) of fn() (a forward and backward of the
    model's parameters, under grad mode), from zeroed gradients."""
    model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss = fn()
    torch.cuda.synchronize()
    return float(loss.detach()), {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def unsharded_loss(model, src, trg, meta):
    """The unsharded forward's filtered CE, backpropagated."""
    from musicgen_tpu_torch.train.loss import filtered_cross_entropy

    loss = filtered_cross_entropy(src, model(src, meta), trg)
    loss.backward()
    return loss


def p15_check(row: str, got: tuple, want: tuple, own: dict | None = None) -> str:
    """Holds a strategy's (loss, gradients) to the unsharded step's: the loss
    at TOL_P15_LOSS relative, each gradient at TOL_P15_GRAD of its tensor's
    largest value, or, where `own` gives it ({name: the unsharded kernel
    step's distance from the plain f32 attention's gradient}), within the
    larger of that and the kernels' own distance; returns the numbers for
    the row's line."""
    (loss, grads), (ref_loss, ref) = got, want
    need(sorted(grads) == sorted(ref), f"[{row}] gradients of other tensors than the unsharded step's")
    rel = abs(loss - ref_loss) / abs(ref_loss)
    need(rel <= TOL_P15_LOSS, f"[{row}] loss {loss} against the unsharded step's {ref_loss} (rel {rel:.3e})")
    errs = {n: rel_err(grads[n], ref[n]) for n in ref}
    worst = max((e[1], n) for n, e in errs.items())
    over = {n for n, e in errs.items() if e[1] > TOL_P15_GRAD}
    for n in over:
        need(own is not None and errs[n][0] <= own[n],
             f"[{row}] gradient {n} off by {errs[n][1]:.3e} of its largest value"
             + ("" if own is None else f", {errs[n][0]:.3e} against the kernels' own {own[n]:.3e} from f32"))
    text = (f"loss {loss:.6f} against {ref_loss:.6f} unsharded (rel {rel:.3e}, tol {TOL_P15_LOSS}); worst gradient "
            f"{worst[0]:.3e} of its tensor's largest at {worst[1]} (tol {TOL_P15_GRAD}"
            f"{'; within 1e-4' if worst[0] <= 1e-4 else ''})")
    if own is not None:
        rest = max((e[1], n) for n, e in errs.items() if n not in over) if len(over) < len(errs) else (0.0, "-")
        text += (f"; {len(over)} tensors past {TOL_P15_GRAD} ({', '.join(sorted(over)[:4])}{' ...' if len(over) > 4 else ''}), "
                 f"each within D and E's own distance from the plain f32 attention's gradient (largest ratio "
                 f"{max((errs[n][0] / own[n] for n in over), default=0.0):.3f}); the rest within {rest[0]:.3e} at "
                 f"{rest[1]}")
    return text


def p15_times(torch, steps: dict, batch) -> dict:
    """Median ms/step of each Adam step of `steps` ({name: step(src, trg,
    meta)}), P15_STEPS of each in turns after a warm-up step each (host
    clock around a synchronised step)."""
    secs = {name: [] for name in steps}
    for i in range(P15_STEPS + 1):
        for name, step in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(step(*batch))
            if i:
                secs[name].append(time.perf_counter() - t0)
    return {name: 1e3 * statistics.median(v) for name, v in secs.items()}


def phase_pp(torch, kind: str, model, batch) -> None:
    """[15 pp transformer|mamba]: parallel/pipeline.py over a pipe of one
    stage (the whole model) at P15_M microbatches: pp_loss's loss and
    gradients against the unsharded step's on one batch, the Transformer's D
    with LSE and E launched exactly blocks x M times a step (blocks once a
    step unsharded; Mamba's plain scan launches no kernel), and the ms of
    each Adam step in turns."""
    from musicgen_tpu_torch.parallel import pipeline
    from musicgen_tpu_torch.train import trainer as T

    row = f"15 pp {kind}"
    src, trg, meta = batch
    grid = pipeline.make_pipe_grid(1)
    stage = pipeline.PipelineStage(model, 1, 0)
    model.eval()
    L = pipeline.n_layers(model.cfg)
    before = all_launches()
    want = held(torch, model, lambda: unsharded_loss(model, src, trg, meta))
    plain_launches = moved_since(before)
    before = all_launches()
    got = held(torch, model, lambda: pipeline.pp_loss(stage, src, trg, meta, grid, P15_M, backward=True))
    pp_launches = moved_since(before)
    own = None
    if kind == "transformer":
        # D and E round p and dS to bf16: how far the unsharded kernel step's
        # gradients are from the plain f32 attention's bounds how far another
        # split of the batch over their launches may move them.
        impl = model.cfg.attention_impl
        set_attention(model, "xla")
        exact = held(torch, model, lambda: unsharded_loss(model, src, trg, meta))
        set_attention(model, impl)
        own = {n: rel_err(g, exact[1][n])[0] for n, g in want[1].items()}
    numbers = p15_check(row, got, want, own)
    per = {"flash_relpos_lse": L, **dict.fromkeys(E_LAUNCHES, L)} if kind == "transformer" else {}
    need(plain_launches == per, f"[{row}] the unsharded step launched {plain_launches}, expected {per}")
    need(pp_launches == {n: P15_M * c for n, c in per.items()},
         f"[{row}] the pipeline step launched {pp_launches}, expected blocks x M of D with LSE and E")
    optimizer = T.make_optimizer(model)
    before = all_launches()
    ms = p15_times(torch, {"pp": pipeline.make_pp_train_step(stage, optimizer, grid, P15_M),
                           "unsharded": unsharded_step(torch, model, optimizer)}, batch)
    timed = moved_since(before)
    steps = P15_STEPS + 1
    need(timed == {n: (P15_M + 1) * c * steps for n, c in per.items()}, f"[{row}] the timed steps launched {timed}")
    for name, c in per.items():
        count_path(name, f"[{row}]", P15_M * c * (steps + 1))
    say(f"[{row}] a pipe of one stage ({L} {'blocks' if kind == 'transformer' else 'mixers'} at full width, f32), "
        f"M = {P15_M} microbatches of ({BATCH // P15_M}, {PROMPT}): {numbers}; launches a step {pp_launches} "
        f"(the unsharded step {plain_launches}); {ms['pp']:.2f} ms/step through the GPipe schedule, "
        f"{ms['unsharded']:.2f} unsharded (median of {P15_STEPS} Adam steps in turns, host clock around a "
        f"synchronised step)")


def phase_sp(torch, model, batch) -> None:
    """[15 sp mamba]: parallel/sp_train.py in a group of one (the whole
    stream on its rank, SSD chunks of the largest divisor of 2,054 up to
    64): sp_loss's loss and gradients (summed over the group) against the
    unsharded step's, and the ms of each Adam step in turns."""
    from musicgen_tpu_torch.parallel import mesh, sp_train
    from musicgen_tpu_torch.train import trainer as T

    row = "15 sp mamba"
    src, trg, meta = batch
    model.eval()
    want = held(torch, model, lambda: unsharded_loss(model, src, trg, meta))

    def sp():
        share = sp_train.sp_loss(model, src, trg, meta)
        share.backward()
        mesh.sum_gradients(model.parameters())
        return share

    before = all_launches()
    got = held(torch, model, sp)
    numbers = p15_check(row, got, want)
    optimizer = T.make_optimizer(model)
    ms = p15_times(torch, {"sp": sp_train.make_sp_train_step(model, optimizer),
                           "unsharded": unsharded_step(torch, model, optimizer)}, batch)
    moved = moved_since(before)
    need(not moved, f"[{row}] a kernel was launched on the plain scan's path: {moved}")
    say(f"[{row}] a group of one, {model.cfg.n_layers} mixers at full width (f32), ({BATCH}, {PROMPT}): {numbers}; "
        f"{ms['sp']:.2f} ms/step time-sharded, {ms['unsharded']:.2f} unsharded (median of {P15_STEPS} Adam steps "
        f"in turns, host clock); no kernel launched (the plain scan, as JAX's sequence-parallel step)")


def phase_tp(torch, model, batch) -> None:
    """[15 tp]: parallel/mesh.py's vocabulary-parallel token table and head
    over a model group of one, swapped into the Transformer in place: the
    loss and every gradient bit for bit with the unsharded model's on one
    batch, and D with LSE and E launched once a block each."""
    from musicgen_tpu_torch.parallel import mesh

    row = "15 tp"
    src, trg, meta = batch
    model.eval()
    L = model.cfg.n_layer

    def fn():
        return unsharded_loss(model, src, trg, meta)

    before = all_launches()
    want = held(torch, model, fn)
    mesh.shard_vocab_(model, None, 1, 0)
    need(isinstance(model.token_embedding_table, mesh.VocabParallelEmbedding)
         and isinstance(model.lm_head, mesh.VocabParallelHead), f"[{row}] the vocabulary tensors were not swapped")
    got = held(torch, model, fn)
    launches = moved_since(before)
    differing = sum(int((got[1][n] != g).sum()) for n, g in want[1].items())
    say(f"[{row}] the Transformer at full width (f32) with its token table and head split over a model group of "
        f"one: loss {got[0]!r} against {want[0]!r} unsharded; {differing} gradient elements differ; launches "
        f"{launches} over both steps")
    need(got[0] == want[0] and differing == 0, f"[{row}] not bit for bit with the unsharded step")
    per = {"flash_relpos_lse": 2 * L, **dict.fromkeys(E_LAUNCHES, 2 * L)}
    need(launches == per, f"[{row}] launched {launches}, expected {per}")
    for name, c in per.items():
        count_path(name, f"[{row}]", c)


def phase_parallel(torch, corpus: Path, meta_path: Path) -> None:
    """Phase 15: [15 pp transformer], [15 tp] (the f32 Transformer at full
    width), [15 pp mamba] and [15 sp mamba] (the f32 Mamba at full width),
    each in a one-rank NCCL group of this process, on one (BATCH, PROMPT)
    batch of the corpus."""
    from musicgen_tpu_torch.config import MambaConfig, TransformerConfig
    from musicgen_tpu_torch.models import mamba, transformer

    batch = train_batch(torch, corpus, meta_path)
    with one_rank_group(torch, "15"):
        model = transformer.init_weights_(transformer.empty_model(TransformerConfig(dropout=0.0), DEVICE), SEED)
        phase_pp(torch, "transformer", model, batch)
        phase_tp(torch, model, batch)
        del model
        torch.cuda.empty_cache()
        model = mamba.init_weights_(mamba.empty_model(MambaConfig(), DEVICE), SEED)
        phase_pp(torch, "mamba", model, batch)
        phase_sp(torch, model, batch)
        del model


# ---------------------------------------------------------------------------
# Phase 16: data-parallel generation, serving and classification
# (parallel/serving.py, serve.BatchScheduler(mesh=)), and the leftovers
# ---------------------------------------------------------------------------

DP_TOKENS = 64  # tokens of each [16 dp generate] and [16 dp shares] run
DP_ROWS = 8  # [16 dp shares]: the batch of 8 that 2 and 4 ranks share
DP_SERVE_LENGTHS = (64, 40, 96)  # [16 dp serve]: requests over SERVE_SLOTS slots in chunks of SERVE_CHUNK
TOL_DP_CLASSIFY = 1e-6  # [16 dp classify], of the largest logit


def one_group_grid():
    """The data grid of the one-rank group (parallel/mesh.make_grid)."""
    from musicgen_tpu_torch.parallel import mesh

    grid = mesh.make_grid()
    need((grid.data, grid.model, grid.data_index) == (1, 1, 0), f"[16] grid {grid}")
    return grid


def phase_dp_generate(torch, models: dict, src, meta) -> None:
    """[16 dp generate <family>]: parallel/serving.generate_data_parallel
    over the one-rank NCCL group against sampler.generate on the same
    batch, stochastic 'combined' (a CUDA generator seeded alike; Mamba also
    resident), bit for bit, with exact launches of the kernels of the
    family's path (A and B, C; D and F; H and G)."""
    from musicgen_tpu_torch.parallel.serving import generate_data_parallel
    from musicgen_tpu_torch.sample.sampler import generate

    grid = one_group_grid()
    runs = [("mamba", "auto"), ("mamba", "resident"), ("transformer", "auto"), ("xlstm", "auto")]
    for kind, mode in runs:
        model, row = models[kind], f"16 dp generate {kind}" + (" resident" if mode == "resident" else "")
        opts = {"resident": True} if mode == "resident" else {}
        gen = lambda: torch.Generator(device=DEVICE).manual_seed(SEED)  # noqa: E731
        reset_launches()
        t0 = time.perf_counter()
        got = generate_data_parallel(model, kind, src, meta, DP_TOKENS, PROMPT, gen(), grid, **opts)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        pre, dec = read_launches()
        want = generate(model, kind, src, meta, DP_TOKENS, PROMPT, gen(), **opts)
        want_pre, want_dec = rows_launches(model, kind, mode, 1, DP_TOKENS)
        differ = int((got != want).sum())
        say(f"[{row}] generate_data_parallel over a one-rank NCCL group, batch {src.shape[0]}, {DP_TOKENS} "
            f"stochastic tokens after {PROMPT}: {differ} tokens differ from sampler.generate; launches {dec}, "
            f"prefill {pre}; {secs:.2f} s")
        need(differ == 0, f"[{row}] the data-parallel streams differ from sampler.generate's")
        need(grammatical(torch, got, PROMPT), f"[{row}] a token breaks the grammar")
        need(pre == want_pre and dec == want_dec, f"[{row}] launches {dec}, prefill {pre}; expected {want_dec}, "
             f"{want_pre}")
        count_row(f"[{row}]", dec, pre)


def forced_logits(torch, model, src, meta, stream, n: int) -> list:
    """Kernel B's logits route at src's batch, teacher-forced along the
    first n new tokens of `stream`: the logits predicting new tokens 0..n."""
    prefill, step = kernel_route(model, "mamba", src.shape[0])
    p = src.shape[1]
    with torch.no_grad():
        logits, carry = prefill(src, meta)
        out = [logits.float()]
        for i in range(n):
            logits, carry = step(stream[:, p + i], carry, p + i)
            out.append(logits.float())
    return out


def share_holds(torch, model, src, meta, full, got, world: int) -> tuple:
    """[16 dp shares]' hold of greedy rows: (rows equal, [(row, first
    difference, tie ratio, error share, whether the teacher-forced picks
    are the two streams' tokens)]). Each row that differs is teacher-forced
    along the batch's stream at the batch and at its share's rows: at its
    first difference the two routes' weights must lie at a near-tie of the
    batch's (tie_ratio <= 1) at the logit error measured there, within
    STEP_TOL['mamba'] of the row's largest logit (phase 12's test; the
    picks are the host's argmax of the logits, the streams' the kernel
    tail's, which may part at an exact tie)."""
    from musicgen_tpu_torch.sample import sampler as sm

    diffs = first_diffs(torch, got, full, PROMPT)
    bad = [r for r, d in enumerate(diffs) if d is not None]
    if not bad:
        return len(diffs), []
    n = max(diffs[r] for r in bad)
    ref = forced_logits(torch, model, src, meta, full, n)
    rows = src.shape[0] // world
    held = []
    for share in sorted({r // rows for r in bad}):
        lo = share * rows
        mine = forced_logits(torch, model, src[lo:lo + rows], meta[lo:lo + rows], full[lo:lo + rows], n)
        for r in (r for r in bad if r // rows == share):
            d = diffs[r]
            cfg = sm.SamplerConfig(num_tokens=DP_TOKENS, ring_size=max(PROMPT, 2048), greedy=True)
            pen = sm.init_penalty_state(full[r:r + 1, :PROMPT], cfg.ring_size)
            for i in range(d):
                pen = sm.push_token(pen, full[r:r + 1, PROMPT + i])
            last = full[r:r + 1, PROMPT + d - 1]
            pick, ref_pick, ratio, share_err = position_check(torch, last, pen, cfg, mine[d][r - lo:r - lo + 1],
                                                              ref[d][r:r + 1])
            same = int(pick) == int(got[r, PROMPT + d]) and int(ref_pick) == int(full[r, PROMPT + d])
            held.append((r, d, float(ratio), float(share_err), same))
    for r, d, ratio, share_err, _ in held:
        need(ratio <= 1.0 and share_err <= STEP_TOL["mamba"],
             f"[16 dp shares] row {r} differs at token {d} past a near-tie: tie ratio {ratio:.4f}, logit error "
             f"{share_err:.3e} of the largest")
    return len(diffs) - len(bad), held


def phase_dp_shares(torch, model, src, meta) -> None:
    """[16 dp shares]: on one card, the shares of 2 and 4 ranks of a batch
    of DP_ROWS (train/distributed.rank_share's rows, each generated alone
    with its columns of the batch's uniforms, no group) against the batch
    generated at once, greedy and stochastic, through kernels A and B: the
    rows equal bit for bit, and each greedy row that differs held at its
    first difference to a near-tie (share_holds): the prefill and the
    decode steps are not batch-invariant in their bits on the card."""
    from musicgen_tpu_torch.sample import sampler as sm

    b = src.shape[0]
    for greedy in (True, False):
        cfg = sm.SamplerConfig(num_tokens=DP_TOKENS, greedy=greedy)
        u = sm.draw_uniforms(cfg, b, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
        run = lambda rows: sm.generate(model, "mamba", src[rows], meta[rows], DP_TOKENS, PROMPT,  # noqa: E731
                                       None, greedy=greedy, uniforms=None if u is None else u[:, rows])
        reset_launches()
        full = run(slice(0, b))
        parts = {}
        for world in (2, 4):
            n = b // world
            parts[world] = torch.cat([run(slice(i * n, (i + 1) * n)) for i in range(world)])
        torch.cuda.synchronize()
        pre, dec = read_launches()
        want_pre, want_dec = rows_launches(model, "mamba", "auto", 1 + 2 + 4, DP_TOKENS)
        need(pre == want_pre and dec == want_dec, f"[16 dp shares] launches {dec}, prefill {pre}; expected "
             f"{want_dec}, {want_pre}")
        count_row("[16 dp shares]", dec, pre)
        for world, got in parts.items():
            need(grammatical(torch, got, PROMPT), f"[16 dp shares] a token of the {world}-rank shares breaks the "
                 "grammar")
            if greedy:
                equal, held = share_holds(torch, model, src, meta, full, got, world)
                text = (f"; each other row at a near-tie at its first difference (row, token, tie ratio, logit "
                        f"error share, the teacher-forced picks the streams' tokens): "
                        f"{[(r, d, round(x, 4), f'{e:.3e}', same) for r, d, x, e, same in held]}" if held else "")
            else:
                equal = sum(d is None for d in first_diffs(torch, got, full, PROMPT))
                text = ("; stochastic rows that differ are not held: the prefill's rounding at another batch moves "
                        "a pick past an inversion boundary" if equal < b else "")
            say(f"[16 dp shares] Mamba ({model.cfg.n_layers} layers), {b} rows of {PROMPT} + {DP_TOKENS} "
                f"{'greedy' if greedy else 'stochastic'} tokens: the shares of {world} ranks generated in turn "
                f"against the batch at once: {equal}/{b} rows bit for bit{text}")


def phase_dp_shares_resident(torch, model, src, meta) -> None:
    """[16 dp shares resident]: kernel C on column slices of one tensor of
    uniforms, stochastic, as the groups of 8 of a wider batch and the
    ranks' shares take them. The rows of src twice (2 x DP_ROWS) run at
    once in two groups of 8, each group bit for bit with its rows run alone
    on a copy of their columns; the shares of 2 and 4 ranks of the first
    DP_ROWS rows, each generated in turn on its columns, against those rows
    at once: the rows equal counted (stochastic rows that differ are not
    held, as in [16 dp shares])."""
    from musicgen_tpu_torch.sample import sampler as sm

    b = src.shape[0]
    src2, meta2 = torch.cat([src, src]), torch.cat([meta, meta])
    u = sm.draw_uniforms(sm.SamplerConfig(num_tokens=DP_TOKENS), 2 * b,
                         torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)

    def run(rows, uniforms):
        return sm.generate(model, "mamba", src2[rows], meta2[rows], DP_TOKENS, PROMPT, None, resident=True,
                           uniforms=uniforms)

    reset_launches()
    wide = run(slice(0, 2 * b), u)
    alone = torch.cat([run(slice(g * b, (g + 1) * b), u[:, g * b:(g + 1) * b].clone()) for g in (0, 1)])
    shares = {world: torch.cat([run(slice(i * (b // world), (i + 1) * (b // world)),
                                    u[:, i * (b // world):(i + 1) * (b // world)]) for i in range(world)])
              for world in (2, 4)}
    torch.cuda.synchronize()
    pre, dec = read_launches()
    want_pre, want_dec = rows_launches(model, "mamba", "resident", 2 + 2 + 2 + 4, DP_TOKENS)
    need(pre == want_pre and dec == want_dec, f"[16 dp shares resident] launches {dec}, prefill {pre}; expected "
         f"{want_dec}, {want_pre}")
    count_row("[16 dp shares resident]", dec, pre)
    differ = int((wide != alone).sum())
    need(differ == 0, f"[16 dp shares resident] the batch of {2 * b} differs from its groups run alone at {differ} "
         "tokens")
    equal = {}
    for world, got in shares.items():
        need(grammatical(torch, got, PROMPT), f"[16 dp shares resident] a token of the {world}-rank shares breaks "
             "the grammar")
        equal[world] = sum(d is None for d in first_diffs(torch, got, wide[:b], PROMPT))
    say(f"[16 dp shares resident] kernel C, {DP_TOKENS} stochastic tokens after {PROMPT}: a batch of {2 * b} rows "
        f"(two groups of 8 on column slices of the uniforms) bit for bit with each group run alone ({differ} tokens "
        f"differ); the shares of 2 and 4 ranks of its first {b} rows, generated in turn on their columns, against "
        f"those rows at once: {equal[2]}/{b} and {equal[4]}/{b} rows bit for bit; launches {dec}, prefill {pre}")


def serve_once(model, kind: str, reqs, greedy: bool, mesh=None, **opts) -> tuple:
    """BatchScheduler over SERVE_SLOTS slots in chunks of SERVE_CHUNK:
    ([tokens of each request], the scheduler)."""
    from musicgen_tpu_torch.serve import BatchScheduler

    sched = BatchScheduler(model, kind, prompt_len=PROMPT, slots=SERVE_SLOTS, chunk=SERVE_CHUNK, block_len=PROMPT,
                           greedy=greedy, mesh=mesh, **opts)
    rids = [sched.submit(p, m, n, s) for p, m, n, s in reqs]
    got = sched.run()
    return [got[rid] for rid in rids], sched


def phase_dp_serve(torch, models: dict, src, meta) -> None:
    """[16 dp serve <family>]: serve.BatchScheduler(mesh=) over the one-rank
    group against no mesh, greedy and seeded, bit for bit, with exact
    launches (A, D or H a prefill; B's or G's logits step a token of each
    group-chunk; the Transformer's plain step). [16 tp serve]: the
    Transformer's vocabulary table and head split over a model group of one
    (parallel/mesh.vocab_sharded, a copy), served through the
    vocabulary-parallel plain step, bit for bit with the unsplit model."""
    import numpy as np

    from musicgen_tpu_torch.parallel import mesh

    grid = one_group_grid()
    reqs = [(src[i].cpu().numpy(), meta[i].cpu().numpy(), n, SEED + i) for i, n in enumerate(DP_SERVE_LENGTHS)]
    chunks = serve_group_chunks(DP_SERVE_LENGTHS, SERVE_SLOTS, SERVE_CHUNK)
    for kind in ("mamba", "xlstm", "transformer"):
        model, row = models[kind], f"16 dp serve {kind}"
        parts = []
        for greedy in (True, False):
            reset_launches()
            t0 = time.perf_counter()
            got, sched = serve_once(model, kind, reqs, greedy, grid)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            pre, dec = read_launches()
            want, _ = serve_once(model, kind, reqs, greedy)
            same = sum(bool(np.array_equal(a, b)) for a, b in zip(got, want))
            want_dec = {} if kind == "transformer" else logits_step_launches(model, kind, chunks * SERVE_CHUNK)
            want_pre = prefill_launches(model, kind, len(reqs))
            need(dec == want_dec and pre == want_pre and sched.group_chunks == chunks,
                 f"[{row}] launches {dec}, prefill {pre}, {sched.group_chunks} group-chunks; expected {want_dec}, "
                 f"{want_pre}, {chunks}")
            count_row(f"[{row}]", dec, pre)
            need(same == len(reqs), f"[{row}] {'greedy' if greedy else 'seeded'}: {same}/{len(reqs)} requests bit "
                 f"for bit with no mesh")
            parts.append(f"{'greedy' if greedy else 'seeded'} {same}/{len(reqs)} bit for bit in {secs:.2f} s")
        say(f"[{row}] BatchScheduler(mesh=) over a one-rank NCCL group, {SERVE_SLOTS} slots, chunks of "
            f"{SERVE_CHUNK}, requests of {DP_SERVE_LENGTHS} tokens after {PROMPT}, against no mesh: "
            f"{'; '.join(parts)}; launches {dec or 'none (plain step)'}, prefill {pre}")
    model = models["transformer"]
    want, _ = serve_once(model, "transformer", reqs, False)
    split_model = mesh.vocab_sharded(model, None, 1, 0)
    reset_launches()
    got, _ = serve_once(split_model, "transformer", reqs, False, mesh.Grid(1, 1, 0), fused=False)
    pre, dec = read_launches()
    split = sorted(n for n, m in split_model.named_modules() if isinstance(m, mesh.VocabParallelHead))
    del split_model
    same = sum(bool(np.array_equal(a, b)) for a, b in zip(got, want))
    count_row("[16 tp serve]", dec, pre)
    say(f"[16 tp serve] the Transformer with its token table and head split over a model group of one ({split}): "
        f"{same}/{len(reqs)} seeded requests bit for bit with the unsplit model; launches {dec or 'none'}, prefill "
        f"{pre}")
    need(split == ["lm_head"] and same == len(reqs) and dec == {}, "[16 tp serve] not bit for bit with the "
         "unsplit model's plain step")


def phase_dp_classify(torch, corpus: Path, meta_path: Path) -> None:
    """[16 dp classify]: classify_data_parallel of the full-size classifier
    over the one-rank group against its own forward, (BATCH, PROMPT),
    within TOL_DP_CLASSIFY of the largest logit, both through kernel H (4
    launches a forward)."""
    from musicgen_tpu_torch.config import ClassifierConfig
    from musicgen_tpu_torch.models.xlstm import empty_model, init_weights_
    from musicgen_tpu_torch.parallel.serving import classify_data_parallel

    model = init_weights_(empty_model(ClassifierConfig(), DEVICE), SEED).eval()
    src = train_batch(torch, corpus, meta_path)[0]
    reset_launches()
    got = classify_data_parallel(model, src, one_group_grid())
    torch.cuda.synchronize()
    pre, _ = read_launches()
    want = model(src)
    err, rel = rel_err(got, want)
    count_row("[16 dp classify]", pre)
    say(f"[16 dp classify] the classifier's forward over a one-rank NCCL group, ({BATCH}, {PROMPT}): max_abs "
        f"{err:.3e}, {rel:.3e} of the largest logit (tol {TOL_DP_CLASSIFY}); launches {pre}")
    need(rel <= TOL_DP_CLASSIFY and pre == {"slstm_scan": len(model.cfg.slstm_at)},
         "[16 dp classify] the data-parallel forward disagrees with the model's, or H did not run")


def phase_leftovers(torch, corpus: Path, root: Path) -> None:
    """[16 leftovers]: midi/vectorized's encode and decode on CUDA tensors
    equal the CPU's on a corpus file's notes (and the host codec's tokens);
    midi/native builds the C++ tokenizer from native/midi_tokenizer.cc and
    its tokens of MIDI written from the corpus equal the Python codec's."""
    import numpy as np

    from musicgen_tpu_torch.midi import (MidiNote, adjust_note_time, decode, encode, extract_midi, native,
                                         note_to_midi)
    from musicgen_tpu_torch.midi import vectorized as vec

    t0 = time.perf_counter()
    files = sorted(corpus.rglob("*.npy"))
    notes = decode(np.load(files[0]).tolist())
    grid_notes = [MidiNote(**vars(n)) for n in notes]
    adjust_note_time(grid_notes)
    cols = [[getattr(g, f) for g in grid_notes] for f in ("pitch", "channel", "dynamic", "time_start", "time_end")]
    cols.append([int(g.tempo) for g in grid_notes])
    cpu = vec.GridNotes(*(torch.tensor(c) for c in cols), valid=torch.ones(len(grid_notes), dtype=torch.bool))
    cuda = vec.GridNotes(*(t.to(DEVICE) for t in cpu))
    tok_c, n_c = vec.encode_notes_grid(cpu)
    tok_g, n_g = vec.encode_notes_grid(cuda)
    dec_c, dec_g = vec.decode_tokens(tok_c), vec.decode_tokens(tok_g)
    same_dec = all(torch.equal(a, b.cpu()) for a, b in zip(dec_c, dec_g))
    need(torch.equal(tok_c, tok_g.cpu()) and int(n_c) == int(n_g) and same_dec,
         "[16 leftovers] the vectorized codec on CUDA tensors differs from the CPU's")
    need(tok_c[:int(n_c)].tolist() == encode(notes), "[16 leftovers] the vectorized codec differs from the codec")
    need(native.available(), f"[16 leftovers] the native tokenizer did not build: {native.build_error()}")
    mids = root / "leftovers_mid"
    mids.mkdir()
    same = 0
    for f in files:
        path = str(mids / f"{f.stem}.mid")
        note_to_midi(decode(np.load(f).tolist()), path)
        same += bool(np.array_equal(native.tokenize_file(path), np.asarray(encode(extract_midi(path)), np.int64)))
    say(f"[16 leftovers] vectorized codec: {len(grid_notes)} notes, {int(n_c)} tokens, CUDA equal to CPU (encode "
        f"and decode) and to the host codec; native tokenizer built at {native.library_path().relative_to(REPO)}: "
        f"{same}/{len(files)} MIDI files token for token with the Python codec; {time.perf_counter() - t0:.1f} s")
    need(same == len(files), "[16 leftovers] the native tokenizer differs from the Python codec")


DRAW_TURNS = 2  # [16 cli draws]: rounds of (parent, this, this, parent)


def phase_cli_draws(torch, root: Path, corpus: Path, meta_path: Path, parent: Path) -> None:
    """[16 cli draws] (with --parent DIR): `cli.generate --model mamba` of
    this tree and of the parent tree (its package imported as parent_mtt,
    its kernels built into DIR/build) on phase 12's Mamba, per token
    ('combined', stochastic: the draw rule against two torch.multinomial
    draws a token), BATCH rows of LENGTH tokens after PROMPT on band
    Mozart, in DRAW_TURNS rounds of parent, this, this, parent: tok/s/seq
    of each run (the prefill included), and each tree's median."""
    import importlib

    from musicgen_tpu_torch.cli import generate as cli

    parent_module(parent, "decode_kernel", "[16 cli draws]")
    pcli = importlib.import_module("parent_mtt.cli.generate")
    rates = {"parent": [], "this": []}
    for turn in range(DRAW_TURNS):
        for tree in ("parent", "this", "this", "parent"):
            out = root / f"draws_{tree}_{turn}_{len(rates[tree])}"
            argv = ["--model", "mamba", "--ckpt", str(root / "mamba_random.pth"), "--data", str(corpus),
                    "--metadata", str(meta_path), "--composers", "Mozart", "--batch", str(BATCH), "--block-len",
                    str(PROMPT), "--length", str(LENGTH), "--output", str(out), "--seed", str(SEED), "--device",
                    DEVICE]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            streams = (pcli if tree == "parent" else cli).main(argv)["Mozart"]
            torch.cuda.synchronize()
            rates[tree].append(LENGTH / (time.perf_counter() - t0))
            need(grammatical(torch, streams, PROMPT), f"[16 cli draws] a {tree} token breaks the grammar")
    say(f"[16 cli draws] cli.generate --model mamba per token (stochastic 'combined', {LENGTH} tokens at batch "
        f"{BATCH} after {PROMPT}, prefill included; phase 12's Mamba at {P12_DEPTH['mamba']}): this tree's draw "
        f"rule {statistics.median(rates['this']):.1f} tok/s/seq (runs {[round(r, 1) for r in rates['this']]}), "
        f"the parent tree's multinomial draws {statistics.median(rates['parent']):.1f} "
        f"({[round(r, 1) for r in rates['parent']]}); medians of {2 * DRAW_TURNS} runs each in rounds of parent, "
        f"this, this, parent")


def phase_dp(torch, corpus: Path, meta_path: Path, root: Path, models: dict | None = None,
             parent: Path | None = None) -> None:
    """Phase 16, in a one-rank NCCL group of this process, on phase 12's
    models (built here when none are given): [16 dp generate ...], [16 dp
    shares], [16 dp shares resident], [16 dp serve ...], [16 tp serve],
    [16 dp classify] and [16 leftovers]; with --parent DIR also [16 cli
    draws]. Its launches go to
    the kernels line through PATH_LAUNCHES."""
    t0 = time.perf_counter()
    card = card_line()
    models = models or p12_models(torch, root)
    src, meta = cli_prompts(torch, corpus, meta_path, PROMPT, DP_ROWS)
    with one_rank_group(torch, "16"):
        phase_dp_generate(torch, models, src[:BATCH], meta[:BATCH])
        phase_dp_shares(torch, models["mamba"], src, meta)
        phase_dp_shares_resident(torch, models["mamba"], src, meta)
        phase_dp_serve(torch, models, src, meta)
        phase_dp_classify(torch, corpus, meta_path)
    phase_leftovers(torch, corpus, root)
    rows_s = time.perf_counter() - t0
    if parent is not None:
        phase_cli_draws(torch, root, corpus, meta_path, parent)
    say(f"[16 done] phase 16 in {time.perf_counter() - t0:.1f} s ({rows_s:.1f} s before [16 cli draws]) on {card}")


# Phase 17, the seq2seq translator (models/seq2seq.py; no kernel: the JAX
# model is plain XLA) at its default width: a (BATCH, S2S_SRC) source encoded
# once, S2S_TOKENS greedy tokens decoded on the card, each step's log-probs
# held to the same seeded model on the CPU over the card's prefix. Both sides
# are f32 with TF32 off and differ only in the order of f32 sums; the
# log-probs lie near -log(1,024) = -6.93, so 1e-4 is some 100 f32 ulps of
# them, where a wrong term (a missing table, the wrong norm) moves them by O(1).
S2S_SRC = 512
S2S_TOKENS = 64
TOL_S2S = 1e-4


def phase_seq2seq(torch) -> None:
    """[17 seq2seq]: the default Seq2SeqTransformer (embed 256, 2 blocks, 4
    heads, vocabularies of 1,024, max_len 5,000) built and seeded through
    models.registry on the card and on the CPU (bit for bit the same
    weights and positional table), a (2, 512) source encoded once, 64 greedy
    tokens on the card timed by utils.profiling.StepTimer (a synchronised
    step a tick), each step's log-probs and greedy pick held to the CPU
    model's over the card's prefix, profiling.device_memory() printed; no
    kernel's launch counter moves."""
    from musicgen_tpu_torch.config import Seq2SeqConfig
    from musicgen_tpu_torch.models import registry
    from musicgen_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    before = all_launches()
    cfg = Seq2SeqConfig()
    model = registry.init_model(registry.new_model("seq2seq", cfg, DEVICE), "seq2seq", SEED).eval()
    cpu = registry.init_model(registry.new_model("seq2seq", cfg, "cpu"), "seq2seq", SEED).eval()
    on_card = [t for t in (*model.parameters(), *model.buffers()) if t.device.type != "cuda"]
    need(not on_card, f"[17 seq2seq] {len(on_card)} tensors of the model are not on the card")
    cpu_sd = cpu.state_dict()
    need(all(torch.equal(t.cpu(), cpu_sd[k]) for k, t in model.state_dict().items())
         and torch.equal(model.pe.cpu(), cpu.pe), "[17 seq2seq] the card's seeded model differs from the CPU's")
    gen = torch.Generator().manual_seed(SEED)
    src = torch.randint(0, cfg.encoder_vocab_size, (BATCH, S2S_SRC), generator=gen)
    first = torch.randint(0, cfg.output_vocab_size, (BATCH, 1), generator=gen)
    torch.cuda.reset_peak_memory_stats()
    timer = profiling.StepTimer(tokens_per_step=BATCH, window=S2S_TOKENS)
    with torch.no_grad():
        torch.cuda.synchronize()
        t_enc = time.perf_counter()
        memory = model.encode(src.to(DEVICE))
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t_enc) * 1e3
        seq, steps = first.to(DEVICE), []
        timer.tick()
        for _ in range(S2S_TOKENS):
            lp = model.decode(memory, seq)
            seq = torch.cat([seq, lp[:, -1].argmax(-1, keepdim=True)], dim=1)
            steps.append(lp)
            torch.cuda.synchronize()
            timer.tick()
        memory_stats = profiling.device_memory()
        seq = seq.cpu()
        want_memory = cpu.encode(src)
        mem_err = float((memory.cpu() - want_memory).abs().max())
        err, differ, worst_gap = 0.0, 0, float("inf")
        for i, lp in enumerate(steps):
            want = cpu.decode(want_memory, seq[:, :i + 1])
            err = max(err, float((lp.cpu() - want).abs().max()))
            top2 = want[:, -1].topk(2, dim=-1).values
            picks_differ = want[:, -1].argmax(-1) != seq[:, i + 1]
            differ += int(picks_differ.sum())
            if picks_differ.any():
                worst_gap = min(worst_gap, float((top2[:, 0] - top2[:, 1])[picks_differ].min()))
    stats = timer.stats()
    moved = moved_since(before)
    say(f"[17 seq2seq] default width ({cfg.embed_dim} wide, {cfg.num_blocks} blocks, {cfg.num_heads} heads, "
        f"vocabularies {cfg.encoder_vocab_size}/{cfg.output_vocab_size}, max_len {cfg.max_len}), source "
        f"({BATCH}, {S2S_SRC}), {S2S_TOKENS} greedy tokens on the card: encode {enc_ms:.3f} ms; decode "
        f"{stats['mean_step_ms']:.4f} ms a step ({stats['steps_per_sec']:.1f} steps/s, "
        f"{stats['tokens_per_sec']:.1f} tok/s at batch {BATCH}; StepTimer, a synchronised step a tick); "
        f"against the CPU's model: memory max_abs {mem_err:.3e}, log-probs max_abs {err:.3e} over the "
        f"{S2S_TOKENS} steps (tol {TOL_S2S}), greedy picks differing {differ}/{BATCH * S2S_TOKENS}"
        + (f" (smallest CPU top-2 gap there {worst_gap:.3e})" if differ else "")
        + f"; device_memory {json.dumps(memory_stats)}; launches moved {moved}; "
        f"{time.perf_counter() - t0:.1f} s")
    need(err <= TOL_S2S and mem_err <= TOL_S2S, "[17 seq2seq] the card's log-probs disagree with the CPU's")
    need(differ == 0 or worst_gap <= 2 * TOL_S2S, "[17 seq2seq] a greedy pick differs from the CPU's off a near-tie")
    need(not moved, f"[17 seq2seq] kernels launched on the seq2seq path: {moved}")
    need(all(v["bytes_in_use"] > 0 and v["bytes_limit"] > 0 for v in memory_stats.values()) and memory_stats,
         "[17 seq2seq] profiling.device_memory() read nothing")


def parse_args(argv: list) -> tuple:
    """(only, parent) from [--only 7|8|9|10|11|12|gptq|int8|bf16|flash|resident|tail|mixer|ssd|diffusion|parallel|dp|
    seq2seq]
    [--parent DIR];
    None where absent or wrong."""
    opts, rest = {}, list(argv)
    while len(rest) >= 2 and rest[0] in ("--only", "--parent") and rest[0] not in opts:
        opts[rest[0]] = rest[1]
        rest = rest[2:]
    only = opts.get("--only")
    if rest or only not in (None, "7", "8", "9", "10", "11", "12", "gptq", "int8", "bf16", "flash", "resident",
                            "tail", "mixer", "ssd", "diffusion", "parallel", "dp", "seq2seq"):
        return None
    return only, (Path(opts["--parent"]).resolve() if "--parent" in opts else None)


def phase_mixer_paths(torch, report: dict, parent: Path | None) -> None:
    """--only mixer: every row that holds kernel B's mixer or the groups of
    rows, with the checks and timings of the full run: phase 4 ([4
    mixer_state] and B's other launches, [4 steps]), [5 cli] (B's launches),
    [6 resident], [6 chain] (C, which runs the same mixer items, bit for bit
    with B's chain), [6 loop] (with --parent DIR the parent tree's C and B's
    step in turns), the resident [6 cli] runs, the [rows ...] CLI runs of
    all three families, and last [4 mixer_state parent] and [4 edges]."""
    from musicgen_tpu_torch.config import TransformerConfig, XLSTMConfig
    from musicgen_tpu_torch.models import transformer, xlstm

    model = mamba_model(torch)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        corpus, meta_path = synth_corpus(root)
        ctx = decode_context(torch, model, corpus, meta_path)
        phase_decode(torch, model, ctx, report)
        phase_cli(torch, model, corpus, meta_path, root, report)
        packs = phase_resident(torch, model, ctx, report)
        phase_loop(torch, ctx, packs, report, parent)
        phase_cli_resident(torch, model, corpus, meta_path, root, report, resident_only=True)
        phase_rows(torch, "mamba", model, corpus, meta_path, root)
        del packs
        for kind, mod, cfg in (("transformer", transformer, TransformerConfig()), ("xlstm", xlstm, XLSTMConfig())):
            other = mod.init_weights_(mod.empty_model(cfg, DEVICE), SEED).eval()
            phase_rows(torch, kind, other, corpus, meta_path, root)
            del other
            torch.cuda.empty_cache()
        phase_mixer(torch, ctx, parent)


def phase_ssd_paths(torch, report: dict, parent: Path | None) -> None:
    """--only ssd: every row that launches kernel A, with the checks and
    timings of the full run: phase 3, [4 prefill] (with --parent DIR the
    parent tree's A in turns there and in [3 ssd_scan]), [5 cli], the
    resident [6 cli] runs with [6 api resident int8], and [rows mamba
    auto|resident]. A's launches are those of [5 cli], counted from zero."""
    phase_ssd(torch, report, parent)
    model = mamba_model(torch)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        corpus, meta_path = synth_corpus(root)
        ctx = decode_context(torch, model, corpus, meta_path)
        phase_prefill(torch, model, ctx, parent)
        phase_cli(torch, model, corpus, meta_path, root, report)
        phase_cli_resident(torch, model, corpus, meta_path, root, report, resident_only=True)
        phase_rows(torch, "mamba", model, corpus, meta_path, root)


def phase_resident_paths(torch, report: dict, parent: Path | None) -> None:
    """--only resident: every row that launches kernel C, with the checks
    and timings of the full run: [6 resident], [6 chain], [6 loop] and the
    resident [6 cli] runs with [6 api resident int8]. C's launches are those
    of the CLI runs, each counted from zero, as in the full run."""
    model = mamba_model(torch)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        corpus, meta_path = synth_corpus(root)
        ctx = decode_context(torch, model, corpus, meta_path)
        packs = phase_resident(torch, model, ctx, report)
        phase_loop(torch, ctx, packs, report, parent)
        phase_cli_resident(torch, model, corpus, meta_path, root, report, resident_only=True)


@contextlib.contextmanager
def clock(name: str):
    """Prints the seconds the block took on a line of its own, [seconds <name>]."""
    t0 = time.perf_counter()
    yield
    say(f"[seconds {name}] {time.perf_counter() - t0:.1f}")


def main() -> int:
    t_start = time.perf_counter()
    args = parse_args(sys.argv[1:])
    if args is None:
        print("usage: python3 chip_smoke.py [--only 7|8|9|10|11|12|gptq|int8|bf16|flash|resident|tail|mixer|ssd|"
              "diffusion|parallel|dp|seq2seq] "
              "[--parent DIR]",
              file=sys.stderr)
        return 2
    only, parent = args
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    need((REPO / "musicgen_tpu_torch").is_dir(), f"run from a checkout of the repo ({REPO} has no musicgen_tpu_torch)")
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_device(torch)
    with clock("2 build"):
        phase_build()
    report: dict = {}
    torch.set_grad_enabled(False)
    if only == "7":
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            phase_transformer(torch, *synth_corpus(root), root, report)
        return finish(torch, card, report, T_KERNELS, t_start)
    if only == "9":
        with tempfile.TemporaryDirectory() as tmp, clock("9 xlstm"):
            root = Path(tmp)
            phase_xlstm(torch, *synth_corpus(root), root, report, parent)
        return finish(torch, card, report, X_KERNELS, t_start)
    if only == "gptq":
        with tempfile.TemporaryDirectory() as tmp, clock("13 gptq"):
            root = Path(tmp)
            phase_gptq(torch, root, *synth_corpus(root))
        for name, rows in PATH_LAUNCHES.items():
            say(f"[{name} launches] on phase 13's paths: " + " + ".join(f"{n} {row}" for row, n in rows.items()))
        return finish(torch, card, report, [], t_start)
    if only == "diffusion":
        with tempfile.TemporaryDirectory() as tmp, clock("14"):
            root = Path(tmp)
            phase_diffusion(torch, synth_corpus(root)[0], root, card)
        return finish(torch, card, report, [], t_start)
    if only == "parallel":
        with tempfile.TemporaryDirectory() as tmp, clock("15"):
            phase_parallel(torch, *synth_corpus(Path(tmp)))
        for name, rows in PATH_LAUNCHES.items():
            say(f"[{name} launches] on phase 15's paths: " + " + ".join(f"{n} {row}" for row, n in rows.items()))
        return finish(torch, card, report, [], t_start)
    if only == "dp":
        with tempfile.TemporaryDirectory() as tmp, clock("16 dp"):
            root = Path(tmp)
            phase_dp(torch, *synth_corpus(root), root, parent=parent)
        for name, rows in PATH_LAUNCHES.items():
            say(f"[{name} launches] on phase 16's paths: " + " + ".join(f"{n} {row}" for row, n in rows.items()))
        return finish(torch, card, report, [], t_start)
    if only == "seq2seq":
        with clock("17 seq2seq"):
            phase_seq2seq(torch)
        return finish(torch, card, report, [], t_start)
    if only == "10":
        phase_probes(torch, report)
        return finish(torch, card, report, PROBE_KERNELS, t_start)
    if only == "11":
        phase_x_slstm(torch, report)
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            phase_research(torch, *synth_corpus(root), root)
        return finish(torch, card, report, ["slstm_scan"], t_start)
    if only == "12":
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            phase_serving(torch, root, *synth_corpus(root))
        for name, rows in PATH_LAUNCHES.items():
            say(f"[{name} launches] on phase 12's paths: " + " + ".join(f"{n} {row}" for row, n in rows.items()))
        return finish(torch, card, report, [], t_start)
    if only == "int8":
        phase_int8_paths(torch, report)
        return finish(torch, card, report, INT8_KERNELS, t_start)
    if only == "bf16":
        phase_bf16_paths(torch, report)
        return finish(torch, card, report, BF16_KERNELS, t_start)
    if only == "flash":
        phase_flash_paths(torch, report)
        return finish(torch, card, report, FLASH_KERNELS, t_start)
    if only == "8":
        phase_training(torch, report)
        return finish(torch, card, report, ["flash_relpos_lse", *E_LAUNCHES], t_start)
    if only == "resident":
        phase_resident_paths(torch, report, parent)
        return finish(torch, card, report, RESIDENT_KERNELS, t_start)
    if only == "tail":
        phase_tail_paths(torch, report, parent)
        return finish(torch, card, report, ["sample_tail"], t_start)
    if only == "mixer":
        phase_mixer_paths(torch, report, parent)
        return finish(torch, card, report, MIXER_KERNELS, t_start)
    if only == "ssd":
        phase_ssd_paths(torch, report, parent)
        return finish(torch, card, report, ["ssd_scan"], t_start)
    with clock("3 ssd_scan"):
        phase_ssd(torch, report, parent)

    model = mamba_model(torch)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        corpus, meta_path = synth_corpus(root)
        with clock("4 decode"):
            ctx = decode_context(torch, model, corpus, meta_path)
            phase_decode(torch, model, ctx, report, parent)
            phase_mixer(torch, ctx, parent)
            phase_tail(torch, ctx, parent)
            phase_gemv_ragged(torch)
        with clock("4q int8"):
            phase_int8(torch, model, ctx, report)
        with clock("5 cli"):
            phase_cli(torch, model, corpus, meta_path, root, report)
        with clock("6 resident"):
            packs = phase_resident(torch, model, ctx, report)
            phase_loop(torch, ctx, packs, report, parent)
            phase_cli_resident(torch, model, corpus, meta_path, root, report)
        with clock("rows mamba"):
            phase_rows(torch, "mamba", model, corpus, meta_path, root)
        del model, ctx, packs
        torch.cuda.empty_cache()

        with clock("7 transformer"):
            phase_transformer(torch, corpus, meta_path, root, report)
        torch.cuda.empty_cache()

        with clock("8 flash-bwd"):
            phase_flash_bwd(torch, report)
        torch.cuda.empty_cache()
        with clock("8 grad"):
            phase_grad(torch, corpus, meta_path)
            torch.cuda.empty_cache()
            phase_grad(torch, corpus, meta_path, "bf16")
        torch.cuda.empty_cache()
        with clock("8 steps"):
            phase_train_steps(torch, corpus, meta_path)
        with clock("8 split"):
            phase_train_split(torch, corpus, meta_path)
        with clock("8 cli"):
            phase_train_cli(torch, corpus, meta_path, root, report)
        torch.cuda.empty_cache()
        with clock("8 ddp"):
            phase_ddp(torch, corpus, meta_path)
            phase_cli_parallel(torch, corpus, meta_path, root)
        torch.cuda.empty_cache()

        with clock("9 xlstm"):
            phase_xlstm(torch, corpus, meta_path, root, report, parent)
        torch.cuda.empty_cache()
        with clock("11 research"):
            phase_research(torch, corpus, meta_path, root)
        torch.cuda.empty_cache()
        with clock("12 serving"):
            models = phase_serving(torch, root, corpus, meta_path)
        with clock("16 dp"):
            phase_dp(torch, corpus, meta_path, root, models, parent)
        del models
        torch.cuda.empty_cache()
        with clock("13 gptq"):
            phase_gptq(torch, root, corpus, meta_path)
        torch.cuda.empty_cache()
        with clock("14"):
            phase_diffusion(torch, corpus, root, card)
        torch.cuda.empty_cache()
        with clock("15"):
            phase_parallel(torch, corpus, meta_path)
    torch.cuda.empty_cache()
    with clock("17 seq2seq"):
        phase_seq2seq(torch)
    torch.cuda.empty_cache()
    with clock("10 probes"):
        phase_probes(torch, report)
    return finish(torch, card, report, list(KERNEL_INFO), t_start)


def finish(torch, card: str, report: dict, names: list, t_start: float) -> int:
    """The kernels line and the last line, after checking that every kernel
    of `names` has its numbers and was launched on its path."""
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, rows in PATH_LAUNCHES.items():
        if name in names:
            own = report.setdefault(name, {}).get("launches", 0)
            report[name]["launches"] = own + sum(rows.values())
            say(f"[{name} launches] on the main paths: {report[name]['launches']} = {own} (its own phase) + "
                + " + ".join(f"{n} {row}" for row, n in rows.items()))
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
