#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card
and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printed as it runs:

1. build   — compile ``src/repro_torch/kernels/csrc/*.cu`` (seven
             sources: the five kernels, flash attention having a
             CUDA-core and a tensor-core source, and an empty kernel
             that times the launch floor; one nvcc each, all started
             together) for sm_90a; print the build time,
             ptxas' registers and shared memory per kernel, the count of
             HGMMA (wgmma) instructions in the tensor-core flash
             kernel's SASS (``cuobjdump -sass``; 0 fails), the SASS
             instructions per pair-sample in the inner loop of each
             encounter-screen kernel (its design floor's count), and the
             card's name and power limit.
2. kernels — hold each CUDA kernel against its plain PyTorch version on
             the card at the process phase's shapes (B = 1024 rows,
             N = 128 knots, M in {128, 256, 512, 1024}; track_interp and
             dynamic_rates bitwise, headings included, with the split
             ``plan`` chose, the earlier design's time and the launch
             floor: an empty kernel on the same grid; dynamic_rates also
             at a dt that is not a power of two; the AGL gather
             on the 30-arc-second GLOBE-resolution DEM, 3121 x 7081 f32)
             and the encounter screen at (C, K, T) cell batches up to
             K = 240 rows and T = 4608 samples and at the screen
             workflow's own one-cell K = 8 launches (bitwise, with the
             regime and strips ``plan`` chose, the design floor and the
             earlier design's time), and time kernel, plain version
             and, where one exists, the single PyTorch call computing
             the same function.
3. workflow— the port's TrackWorkflow end to end on the card (threads,
             8 workers, 4 tasks per message, 8 raw files at scale 500),
             with every kernel's launch counter zeroed just before and
             read just after, and track_interp's and dynamic_rates'
             launches by shape and track_interp's by route.
4. globe   — one process_batch over every archive the workflow wrote,
             on the GLOBE-resolution DEM, on the card and on the CPU
             (plain versions), compared within 1e-4 (both sides run the
             same f32 operations), with the host parse timed apart from
             the pipeline.
5. screen  — the port's TrackWorkflow(input="store", screen=True) on the
             card (threads, 8 workers, 4 tasks per message, 8192 points
             per shard, the same 8 raw files), with all four launch
             counters zeroed just before and read just after; the
             candidates held against the brute-force screen over the
             same store-derived rows and against the screen tasks re-run
             on the CPU, and the store path's process phase held
             against the zip path's, bitwise; the screen launches by
             padded (K, T) shape, track_interp's and dynamic_rates' by
             shape; 200 screen tasks profiled (host split, device busy
             time, the screen kernels' own device time).
5b. dag    — the same workflow as one streaming DAG (mode="dag"): phase
             5's data and settings, at phase 5's root (moved aside),
             traced (``repro_torch.obs.Tracer``), with the four launch
             counters zeroed just before and read just after; its
             store/ tree and candidates.json held byte for byte against
             phase 5's untraced barrier run, its job_seconds printed
             beside the barrier run's phase seconds, its launches by
             shape (the cell-bin emitter's re-derivation in the manager
             thread included, then replayed alone) and its screen stats.
             The trace: no event dropped, the span-ledger invariants of
             tests/test_obs.py against the DAG's completed ids, written
             outside the root with ``write_trace_files``, read back
             through ``from_chrome_trace`` to the same event count, and
             reported by ``repro_torch.obs.report``; printed are its
             event count, makespan and critical path beside job_seconds,
             and per DAG node its tasks, busy time, critical path, exec
             p50/p99 and stragglers.  Then a small DAG (1 raw file at
             scale 1/1000, 2048 points a shard, 4 processes workers, 2
             manager shards) held byte for byte against a barrier run of
             the same data on the card.
5c. trace  — the tracer's host cost: 10^6 ``emit`` calls and 10^6 raw
             appends timed on a fresh Tracer, and phase 5b's event count
             times the emit cost beside its job_seconds (printed, not
             gated); then ``python -m repro_torch.tracks.workflow
             --files 1 --scale 1000 --trace DIR`` in a fresh interpreter
             on the card, which must exit 0, print its ``trace:`` line
             and write both files.
6. flash   — the flash-attention kernels against their plain version at
             the six shapes of tests/test_flash_attention.py in f32
             (rtol/atol 2e-5), its bf16 case, stablelm-12b's heads (B =
             1, H = 32, KV = 8, hd = 160, T = S in {512, 2048, 4096}) in
             bf16 and f32, phase 7's own shape (B = 2, T = S = 2048,
             bf16) and phase 7b's forwards' shapes in bf16 (qwen3-moe
             B = 1, H = 32, KV = 4, hd = 128; jamba KV = 8, hd = 128;
             musicgen B = 2, H = KV = 24, hd = 64; T = S = 2048); a bf16
             output within one bf16 rounding of the plain
             f32 one (rtol 2^-8, atol 1e-5).  Every bf16 shape must go
             through the tensor-core kernel (route "sm90") and every f32
             one through the CUDA-core kernel (route counters); each is
             timed beside the plain version and, at T = S,
             F.scaled_dot_product_attention (the yardstick only), and a
             bf16 shape also beside the CUDA-core kernel's bf16 entry,
             called directly on the same inputs.
7. lm      — stablelm-12b at full width and depth (40 layers, 12.1 B
             parameters in bf16, random from a seed) on the card: forward
             on 2 x 2048 tokens with attention_impl "flash" (the flash
             counters zeroed just before, 40 launches, all on the sm90
             route, read just after; the kernel's share of the profiled
             forward's device time) and
             "xla", logits compared; prefill + decode_step against
             forward; BatchedServer (4 slots, prompt 64, cache 256): one
             warm-up request, then 3 rounds of 8 seeded requests of 16
             new tokens each, every round gated and timed on its own.
7b. arms   — the LM's other arms at full width, random bf16 weights from
             a seed, one model at a time (the previous one freed):
             qwen3-moe-30b-a3b (48 MoE layers, 128 experts, top 8; 61.1
             GB), rwkv6-3b (32 RWKV-6 layers), jamba-v0.1-52b cut to 16
             of its 32 layers (Mamba + attention + MoE; 52.1 GB: the
             whole model's 103.1 GB do not fit) and musicgen-medium on
             seeded embeds.  Each: forward on B x 2048 with "flash" (the
             counters zeroed just before and read just after: one sm90
             launch per attention layer) and "xla"; each attention layer
             fed the xla forward's input, flash against xla within 0.03;
             each MoE, Mamba and RWKV-6 sublayer fed the bf16 forward's
             input, bf16 against f32 on the same weights within 0.03;
             prefill(64) + decode_step against forward(65) in f32 at
             full width (depth cut to 8 layers for qwen3-moe and jamba,
             whose f32 weights would not fit) within 0.05; the
             whole-model bf16 comparisons gated for the dense musicgen
             and printed for the rest (rounding flips MoE routes, and
             compounds through RWKV-6's 32 layers, where each bf16 path
             is also printed against its f32 twin);
             BatchedServer (one warm-up request, 2 rounds of 4 requests
             of 16 new tokens) for the token-input models, timed decode
             steps for musicgen; parameters and GB on the card, tokens/s,
             peak memory, decode step ms, device time by kernel and kind
             of kernel, and for the MoE models by stage of the layer
             (route, dispatch, experts, combine).
8. bench   — the bench matrices of ``repro_torch.bench``: the campaign's
             quick tier (Tables I/II on the sim, in virtual seconds of the
             cost model, and the threads smoke), the kernels, storage and
             encounters matrices at their full tier on the card, each with
             the four launch counters zeroed just before and read just
             after (launches by kernel and shape printed; a matrix that
             bypasses its kernels fails), and the scheduling quick tier
             (host work).  Every artifact validates and is written under
             ``experiments/chip_smoke/bench``; every check of a
             deterministic metric passes (candidate exactness, fused vs
             unfused within 1e-5, no intermediate transfer, bitwise feeds,
             identical rebuilds, every task completed); the speed checks
             (``speedup_x``, ``feed_speedup_x``, ``kernel_speedup_x``, the
             prefetch-wait cut) are printed with their outcome, and the
             card's fused-vs-unfused differences; the kernels matrix's
             quick cell is timed fused and unfused without a profiler
             (alternating windows, medians), then under torch.profiler
             (device busy; the idle share is taken against the
             unprofiled time) and under cProfile (the host split, as
             shares).  The segment outputs of every
             kernels cell (fused and unfused) and of the storage
             matrix's pipeline calls are held against the CPU's plain
             versions on the same items (1e-4 + 1e-6 |CPU|, headings
             wrapped).  The quick cells of kernels and encounters run
             again on the CPU and their metrics equal the card run's.
             Last (after phase 9), track_interp and dynamic_rates at
             the most frequent launch shape of phases 3, 5, 5b and 9
             and of the kernels and storage matrices, bitwise, timed
             beside their plain versions, bounds and launch floors.
9. serving — the continuous-ingest serving mode (host work): the
             serving matrix not cut (``run_serving_campaign()``: three
             cells, every deterministic check passing, the inline
             cells' tiny-query p99 ratio gate printed pass or fail);
             ``run_serve`` at 2048 files x 256 observations (threads, 8
             workers, 2048 points a shard), its summary equal to the reference's on the same
             seed and its sealed live store byte for byte a batch
             ``build_store`` of the same feed; a 64-file serve on 2
             processes workers (spawned: CUDA is live) equal to the
             threads serve.  Then the live store processed on the card
             on the GLOBE-resolution DEM, the process kernels' counters
             zeroed just before and read just after (launches and top
             shapes printed), bitwise against the batch store's outputs
             and within 1e-4 + 1e-6 |CPU| of the CPU's plain versions;
             its wall time and, under torch.profiler, the device's idle
             share.  Every number is printed beside the card's name and
             power limit.  The last check (interp and rates at each
             workflow's top launch shape) includes this phase's.
10. train  — training (``repro_torch.data``, ``repro_torch.train``,
             ``repro_torch.launch.steps``): minicpm-2b at full width
             (2.72 B bf16 parameters, AdamW with f32 moments, remat
             "nothing", cosine lr with 2 warm-up steps) on 8 x 1024
             Zipf-skewed tokens a step from a SelfScheduledLoader
             (threads), 6 steps through ``Trainer``, the last under
             torch.profiler, with every kernel counter zeroed just
             before and read just after (none launches: training takes
             the xla attention, as in the reference, whose Pallas kernel
             has no gradient); fails on a non-finite loss or grad norm,
             a last loss not below the first, or allocated memory that
             grows from step to step; prints step ms, tokens/s, peak
             memory and the profiled step's device time by kind of
             kernel.  Then one step's peak memory without remat and
             under each policy at 1 x 1024 tokens; three f32 steps of
             reduced minicpm-2b on the card against the CPU from the
             same weights (losses and ||dparams|| / ||params|| within
             1e-4); and a bf16 run checkpointed at step 2 and resumed by
             a fresh Trainer against the uninterrupted run (1e-3).
11. mesh   — the mesh tools, with every kernel counter zeroed just
             before and read just after (all read 0).  (a) The dry run
             (``python -m repro_torch.launch.dryrun --all --multi-pod
             both``, processes backend, one job a core) in a subprocess
             that sees no card: every (arch x shape x mesh) cell of the
             ten configs traced on the fake 512-rank process group must
             be ``ok``, with compute and memory terms above 0 and a
             collective term at 0 or above at the H100's datasheet
             constants; a line a cell (planning estimates from traced
             graphs, not measurements).  (b) On the card, while (a)
             runs: a one-GPU ``DeviceMesh`` (NCCL, world 1) from
             ``mesh_from_triples``; ``Trainer(mesh=...)`` trains
             minicpm-2b at full width on phase 10's batches and lr, its
             losses against phase 10's (1e-3; bitwise expected) with
             allocated memory flat step to step, and its build's peak
             above the placed leaves within twice the larger of the
             largest top-level leaf and one superblock in f32 (leaves
             are placed one at a time);
             a bf16 reduced run
             re-meshed onto a fresh one-GPU mesh at step 3 against phase
             10's uninterrupted run (1e-3); and
             ``make_compressed_allreduce`` over a one-pod mesh bitwise
             ``compressed_psum_leaf`` of one pod.

The line before the last is the card's name and power limit; before it
one JSON object lists every kernel with its timings.  The last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero before that line is printed.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
WORK = os.path.join(HERE, "experiments", "chip_smoke")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM memory rate
F32_OPS_PER_S = 67e12            # H100 SXM f32 rate outside tensor cores
B_ROWS, N_KNOTS = 1024, 128
WIDTHS = (128, 256, 512, 1024)
TIMED_RUNS = 30
# Tolerances of the parity tests (tests/test_kernels.py and
# tests/test_segment_pipeline.py); headings compare as wrapped angles.
TOL = {"track_interp": (1e-5, 1e-4), "agl_lookup": (1e-4, 1e-2),
       "dynamic_rates": (1e-4, 1e-3), "encounter_screen": (1e-5, 1e-2)}
# The earlier track_interp and dynamic_rates kernels' times (one block per
# row and 256-query tile, one query a thread) at B = 1024, N = 128 and
# each width, on an H100 80GB HBM3 at 700 W, as PERF.md records them,
# printed beside this run's.
INTERP_EARLIER_MS = {128: 0.0080, 256: 0.0095, 512: 0.0128, 1024: 0.0193}
RATES_EARLIER_MS = {128: 0.0082, 256: 0.0097, 512: 0.0133, 1024: 0.0201}
# A grid spacing that is not a power of two: dynamic_rates then takes its
# IEEE divisions (a power of two divides by exact reciprocals).
RATES_IEEE_DT = 0.3
# Encounter-screen cell batches (C cells, K rows, T samples): many small
# cells, mid-size, the densest cell the aerodrome_dense manifest gives
# (237 rows, 240 padded), and that at an hour-long union grid; then the
# screen workflow's own launches, one cell of at most 4 rows (K = 8) at
# three union-grid widths.
SCREEN_SHAPES = ((256, 8, 1024), (32, 64, 1024), (8, 240, 1024),
                 (4, 240, 4608), (1, 8, 128), (1, 8, 1024), (1, 8, 4608))
# The shape of the kernels line's screen row (the kernel table's).
SCREEN_TOP_SHAPE = (4, 240, 4608)
# The earlier screen kernel's times (one block per cell and pair tile,
# each walking the whole time axis) on an H100 80GB HBM3 at 700 W, as
# PERF.md records them, printed beside this run's.
SCREEN_EARLIER_MS = {(256, 8, 1024): 0.4015, (32, 64, 1024): 0.7221,
                  (8, 240, 1024): 1.1674, (4, 240, 4608): 3.6918}
# SIMT lanes an SM issues per clock (4 schedulers x 32), for the screen
# kernels' design floor.
LANES_PER_SM_CLOCK = 128
SCREEN_H_M, SCREEN_V_M = 926.0, 152.4
# f32 operations per jointly valid pair-sample (i < j), from
# csrc/encounter_screen.cu: val product and its test (2), dn (2), mean
# latitude and radians (3), cosf (1), de (3), dn^2 + de^2 (3), sqrtf (1),
# dv (2), both thresholds (2), the strict-< minimum test (1), the dv
# minimum (1).  cosf and sqrtf count as one operation each, and a pair-
# sample that is not jointly valid needs none of them, so the bound
# counts this run's jointly valid pair-samples only: a floor.
SCREEN_OPS_PER_PAIR_SAMPLE = 22
# Phase 5: the thresholds tests/test_workflow_screen.py calibrated so
# the synthetic traffic co-bins, and the distance tolerance of its
# brute-force comparison.
SCREEN_WF = dict(screen_h_m=50_000.0, screen_v_m=1000.0,
                 screen_cell_deg=1.0)
CAND_ATOL_M = 1e-2
# Phase 6: the flash kernel's shapes (B, H, KV, T, S, hd, causal).  The
# six of tests/test_flash_attention.py in f32, its bf16 case, and
# stablelm-12b's heads at three sequence lengths in both dtypes.
FLASH_TEST_SHAPES = ((1, 4, 2, 256, 256, 64, True), (2, 8, 2, 128, 384, 64, True),
                     (1, 2, 2, 256, 256, 128, False),
                     (1, 12, 4, 384, 384, 192, True),
                     (2, 4, 1, 256, 512, 64, True), (1, 4, 4, 200, 300, 64, True))
FLASH_BF16_SHAPE = (1, 4, 2, 128, 128, 64, True)
FLASH_LM_T = (512, 2048, 4096)
FLASH_F32_TOL = 2e-5             # rtol and atol, tests/test_flash_attention.py
# A bf16 output against the plain version's f32 output: one bf16 rounding
# (unit roundoff 2^-8) of an f32 result.  At the JAX test's bf16 case,
# whose outputs stay below 4, this is tighter than its max error 0.05.
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2.0 ** -8, 1e-5
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core rate
# Phase 7: stablelm-12b at full width and depth.
LM_ARCH = "stablelm-12b"
LM_B, LM_T = 2, 2048
# Phase 6 also holds the kernel at the shape phase 7's forward gives it.
FLASH_MAIN_PATH_SHAPE = (LM_B, 32, 8, LM_T, LM_T, 160, True)
LM_REL_GATE = 0.03               # flash vs xla logits, tests/test_flash_attention.py
LM_DECODE_T, LM_DECODE_GATE = 64, 0.05   # tests/test_models.py's gate
SERVE = dict(slots=4, prompt_len=64, cache_len=256)
SERVE_REQUESTS, SERVE_NEW, SERVE_ROUNDS = 8, 16, 3
# Phase 7b: the LM's other arms at full width, one model at a time: MoE
# layers (qwen3-moe), RWKV-6 blocks (rwkv6-3b), Mamba blocks with MoE
# (jamba, cut to 16 of its 32 layers: its 103.1 GB of bf16 weights do
# not fit the card's 80 GB) and a stubbed frontend's embeds input
# (musicgen-medium).  Each model runs in its own bf16 dtypes at full
# width; ``cut`` overrides its config, ``B`` is the forward's batch,
# ``cf`` the capacity factor of prefill + decode vs forward (large
# enough that no token drops, as tests/test_models.py runs it; None: the
# config's), ``serve`` whether BatchedServer serves it (the reference
# refuses frontends).
#
# Phase 7's whole-model gates (flash vs xla logits, prefill + decode vs
# forward) hold in bf16 only where rounding does not compound past them:
# a dense attention stack (``bf16_gates``).  With random weights, a
# one-ulp difference flips a router's choice in the next MoE layer and,
# through capacity ranks, other tokens' drops (qwen3-moe, jamba); over
# RWKV-6's 32 layers the ulps compound that its two chunkings (32 tokens
# in prefill(64), 13 in forward(65)) round apart.  The port's bf16
# arithmetic is the reference's as written: at the reduced configs on
# the CPU, RWKV-6's ddlerp steps are bitwise the reference's run op by
# op, its mixers differ from it in under 1 % of their elements by under
# one ulp, and the port's prefill + decode drifts from its forward no
# further than the reference's run op by op does
# (tests/test_torch_models.py::test_bf16_rwkv6_mixers_round_as_reference
# and ::test_bf16_decode_drift_matches_reference).  The reference's
# compiled form keeps bf16 intermediates in f32 inside XLA's fusions, so
# its own drift is no witness: 1.4e-07 at one seed, 0.01 at another.
# So these models hold each MoE, Mamba and RWKV-6 sublayer in bf16
# against the same sublayer in f32 on the same input and weights,
# flash against xla layer by layer, and prefill + decode against
# forward in f32 at full width, with depth cut to ``f32_layers`` where
# f32 weights would not fit.  The bf16 whole-model figures are printed;
# where the f32 run keeps the full depth, its weights are the bf16
# ones widened, and each bf16 path is printed against its f32 twin.
LM_ARMS = (
    dict(arch="qwen3-moe-30b-a3b", cut={}, B=1, cf=16.0, serve=True,
         f32_layers=8, bf16_gates=False),
    dict(arch="rwkv6-3b", cut={}, B=2, cf=None, serve=True,
         f32_layers=None, bf16_gates=False),
    dict(arch="jamba-v0.1-52b", cut={"n_layers": 16}, B=1, cf=8.0,
         serve=True, f32_layers=8, bf16_gates=False),
    dict(arch="musicgen-medium", cut={}, B=2, cf=None, serve=False,
         f32_layers=None, bf16_gates=True),
)
ARMS_SERVE_REQUESTS, ARMS_SERVE_ROUNDS = 4, 2
ARMS_DECODE_STEPS = 5            # timed decode steps where no server runs
MOE_STAGES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
# A bf16 MoE, Mamba or RWKV-6 sublayer against the same sublayer in f32
# on the same input and the same (widened) weights: the repo's bf16 gate,
# but for RWKV-6's time mix, which reads 0.0302 at rwkv6-3b's width on an
# H100 80GB HBM3 at 700 W.  Its decay (the exp of a cumulative sum) and
# per-head group norm amplify the bf16 rounding of their inputs, in the
# reference too: at the reduced config the reference's time mix run op
# by op sits as far from its f32 twin as the port's does (0.0239 both;
# tests/test_torch_models.py::test_bf16_rwkv6_mixers_round_as_reference).
SUBLAYER_BF16_GATE = {"moe": LM_REL_GATE, "mamba": LM_REL_GATE,
                      "rwkv6 channel mix": LM_REL_GATE,
                      "rwkv6 time mix": 0.05}
# Phase 6 also holds the kernel at phase 7b's forwards' own shapes:
# qwen3-moe, jamba and musicgen heads at T = S = 2048.
FLASH_ARMS_SHAPES = ((1, 32, 4, LM_T, LM_T, 128, True),
                     (1, 32, 8, LM_T, LM_T, 128, True),
                     (2, 24, 24, LM_T, LM_T, 64, True))
# Phase 10: training.  (a) minicpm-2b at full width (bf16 weights, AdamW
# with f32 moments, remat "nothing", cosine lr with 2 warm-up steps),
# TRAIN_B x TRAIN_T tokens a step from a SelfScheduledLoader over
# Zipf-skewed shards, TRAIN_STEPS steps, the last one profiled.  (b) one
# step each without remat and under the three policies, at TRAIN_MEM_B
# sequences (without remat the attention's f32 logits and
# probabilities of all 40 layers stay alive: about 3.6 GB a layer at B
# = 8, which does not fit beside the 32.6 GB of weights, gradients and
# moments).  (c) the f32 variant of reduced minicpm-2b, TRAIN_CMP_STEPS
# steps on the card and on the CPU from the same weights.  (d) reduced
# minicpm-2b in bf16: TRAIN_RESUME_STEPS steps straight against a run
# checkpointed at step 2 and resumed by a fresh Trainer.  (e) the
# full-width witness (below).
TRAIN_ARCH = "minicpm-2b"
TRAIN_B, TRAIN_T, TRAIN_STEPS = 8, 1024, 6
# The reference's default peak lr (3e-4) diverges at full width within 6
# steps (losses 11.78, 11.88, 11.78, 23.09, 8.01, 13.65 on an H100 80GB
# HBM3 at 700 W); at 3e-5 they fall.  (e) below is the witness that the
# gradient at full width is right and that the cause is the step size:
# Adam's first steps move every weight by about lr, coherently.
TRAIN_PEAK_LR = 3e-5
# (e) At full width, on the step-0 weights and (a)'s first batch: the
# f32 twin's gradient (the bf16 weights widened) checked leaf by leaf by
# central differences along itself, (L(w + e g) - L(w - e g)) / 2e
# against ||g||^2, with e set so that e ||g||^2 = TRAIN_FD_DL; the bf16
# gradient against the f32 twin's, leaf by leaf; and the loss after one
# sign step w - eta sign(g) (Adam's first step is about lr per element)
# at each TRAIN_WIT_ETAS, in f32 and in bf16, with the share of bf16
# elements the step changes.
TRAIN_FD_DL = 1e-2
TRAIN_FD_RTOL = 2e-2
TRAIN_BF16_GRAD_TOL = 0.05       # ||g_bf16 - g_f32|| / ||g_f32||, a leaf
# The tied embedding's rows that the batch looks up gather every repeat
# of their token in bf16, one rounding per repeat, in the reference as in
# the port: at reduced width on the CPU those rows' bf16 gradient is
# 0.128 (4 x 512 Zipf tokens) and 0.322 (8 x 1024) off the f32 twin's in
# both packages (tests/test_torch_train.py::
# test_bf16_embedding_gradient_rounds_as_reference); its other rows are
# held at TRAIN_BF16_GRAD_TOL.
TRAIN_BF16_EMBED_TOL = 0.5
TRAIN_BF16_LOSS_RTOL = LM_REL_GATE   # the bf16 loss against its f32 twin
TRAIN_WIT_ETAS = (1.5e-5, 3e-5, 1.5e-4, 3e-4)
TRAIN_MEM_B = 1
TRAIN_CMP_STEPS = 3
TRAIN_CMP_LOSS_RTOL = 1e-4       # card vs CPU loss, f32
TRAIN_CMP_PARAM_RTOL = 1e-4      # ||card - CPU|| / ||CPU|| over params
TRAIN_RESUME_STEPS = 6
# Resumed vs uninterrupted losses, bf16.  torch.use_deterministic_algorithms
# is not set: the runs use the same kernels on the same shapes, and any
# reordered sum moves a bf16 loss by far less than one bf16 rounding
# (2^-8); 1e-3 relative sits under it.
TRAIN_RESUME_RTOL = 1e-3
# Screen tasks timed one after another, profiled, after the workflow.
SCREEN_PROFILE_TASKS = 200
# Card against CPU on the GLOBE batch: both run the same f32 operations
# without FMA, so only cosf/atan2f ulps differ.  |card - CPU| must stay
# within CARD_ATOL + CARD_RTOL * |CPU| on every plane (headings wrapped).
CARD_ATOL, CARD_RTOL = 1e-4, 1e-6


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def device_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each of
    ``runs`` back-to-back calls.  A spin kernel first holds the stream
    while the host queues every call, so host overhead between calls
    does not show as device time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    torch.cuda._sleep(200_000_000)
    ev[0].record()
    for i in range(runs):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1])
                             for i in range(runs))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wrapped(a, b):
    """|a - b| as angles, in (-pi, pi]."""
    d = (a.double() - b.double() + math.pi) % (2 * math.pi) - math.pi
    return d.abs()


def bucket_inputs(rng, W: int, B: int = B_ROWS, N: int = N_KNOTS):
    """One (B, W) bucket shaped like the process phase's: 10-120
    irregular knots about 10 s apart (dataset #1's update period; N >=
    128 slots), covering half to all of the bucket's 1 Hz grid, over
    CONUS."""
    import numpy as np
    t_in = np.zeros((B, N), np.float32)
    v_in = np.zeros((B, 3, N), np.float32)
    count_in = np.zeros(B, np.int32)
    t_out = np.zeros((B, W), np.float32)
    count_out = np.zeros(B, np.int32)
    for b in range(B):
        m = int(rng.integers(W // 2 + 1, W + 1))
        n = int(min(max(m // 10, 10), 120))
        t = np.sort(rng.uniform(0, m - 1, n))
        t[0], t[-1] = 0.0, m - 1
        t_in[b, :n] = t
        t_in[b, n:] = t[-1] + np.arange(1, N - n + 1)
        hdg = rng.uniform(0, 2 * np.pi) + np.cumsum(rng.normal(0, 0.05, n))
        step = rng.uniform(30, 220) * np.diff(t, prepend=0.0) / 111_111.0
        lat0 = rng.uniform(26, 48)
        v_in[b, 0, :n] = lat0 + np.cumsum(step * np.cos(hdg))
        v_in[b, 1, :n] = rng.uniform(-122, -69) + np.cumsum(
            step * np.sin(hdg) / np.cos(np.deg2rad(lat0)))
        v_in[b, 2, :n] = np.maximum(
            rng.uniform(300, 3000) + np.cumsum(rng.normal(0, 20, n)), 10)
        v_in[b, :, n:] = v_in[b, :, n - 1:n]
        count_in[b] = n
        t_out[b, :m] = np.arange(m)
        t_out[b, m:] = m - 1
        count_out[b] = m
    return t_in, v_in, count_in, t_out, count_out


def phase_build() -> tuple[str, dict]:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.lib()
    say("build", f"libkernels built in {_build.build_seconds:.2f}s "
                 f"(load {time.perf_counter() - t0:.2f}s) for sm_90a")
    source, kernel, found = "?", "", []
    log = _build.build_log()
    for line in log.splitlines():
        if line.startswith("== "):
            source, kernel = line[3:], ""
        elif "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif ("registers" in line or "spill" in line.lower()
              or "Performance Loss" in line):
            text, name = line.split("ptxas", 1)[-1], kernel
            if "Performance Loss" in line:     # printed before its kernel
                text, _, rest = text.partition("for the function")
                name = rest.split("'")[1] if "'" in rest else name
            found.append((source, name, text))
    names = demangle({name for _, name, _ in found if name})
    for source, name, text in found:
        say("build", f"{source} {names.get(name, name)}: ptxas{text}")
    n = len(_build._sources())
    if n != 7 or "flash_attention_sm90.cu" not in log:
        raise AssertionError(f"expected seven kernel sources, built {n}")
    hgmma = hgmma_count(_build.library_path())
    say("build", f"flash_attention_sm90.cu: {hgmma} HGMMA instructions in "
                 f"its kernels' SASS (cuobjdump -sass)")
    if hgmma == 0:
        raise AssertionError("the sm90 flash kernel has no HGMMA: it does "
                             "not run on the tensor cores")
    floor = screen_sass_per_pair_sample(_build.library_path())
    for regime, f in sorted(floor.items()):
        say("build", f"encounter_screen.cu {regime}-K kernel: "
                     f"{f['instructions']} SASS instructions in its inner "
                     f"loop for {f['pair_samples']} pair-samples = "
                     f"{f['per_pair_sample']:.2f} per pair-sample "
                     f"(cuobjdump -sass)")
    card = card_line()
    say("build", f"card: {card}")
    return card, floor


def demangle(mangled) -> dict:
    """Each mangled kernel name's function name and template arguments,
    from the CUDA toolkit's cu++filt."""
    mangled = sorted(mangled)
    if not mangled:
        return {}
    cufilt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    out = subprocess.run([cufilt, "-p", *mangled], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return dict(zip(mangled, out.splitlines()))


def hgmma_count(library) -> int:
    """HGMMA instructions in the SASS of the sm90 flash kernels."""
    cuobjdump = (shutil.which("cuobjdump")
                 or "/usr/local/cuda/bin/cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return sum(fn.count("HGMMA") for fn in sass.split("Function : ")
               if fn.startswith("_") and "flash_attention_sm90" in
               fn.split("\n", 1)[0])


def screen_sass_per_pair_sample(library) -> dict:
    """SASS instructions per pair-sample of each encounter-screen kernel's
    inner loop, from ``cuobjdump -sass``: the smallest loop (a backward
    branch and its target) that holds a MUFU.RSQ, one of which each
    pair-sample's sqrtf issues, counted without NOPs and divided by its
    MUFU.RSQs.  The slow paths of cosf and sqrtf lie outside it (a
    call), so this is the fast path's count: a floor per pair-sample."""
    cuobjdump = (shutil.which("cuobjdump")
                 or "/usr/local/cuda/bin/cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0]
        regime = ("small" if "screen_small_kernel" in name else
                  "large" if "screen_tile_kernel" in name else None)
        if regime is None:
            continue
        ins = [(int(a, 16), text.strip()) for a, text in
               re.findall(r"/\*([0-9a-f]+)\*/\s+([^;]*);", fn)]
        best = None
        for addr, text in ins:
            m = re.search(r"\bBRA\b.*?\b0x([0-9a-f]+)", text)
            if not m or int(m.group(1), 16) > addr:
                continue
            body = [t for a, t in ins
                    if int(m.group(1), 16) <= a <= addr and t != "NOP"]
            rsq = sum("MUFU.RSQ" in t for t in body)
            if rsq and (best is None or len(body) < best[0]):
                best = (len(body), rsq)
        if best is None:
            raise AssertionError(f"no inner loop with a MUFU.RSQ in {name}")
        out[regime] = {"instructions": best[0], "pair_samples": best[1],
                       "per_pair_sample": best[0] / best[1]}
    if set(out) != {"small", "large"}:
        raise AssertionError(f"screen kernels' SASS not found: {out}")
    return out


def sm_clock_hz() -> float:
    """The card's highest SM clock, from nvidia-smi, in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return float(out.splitlines()[0]) * 1e6


def phase_kernels(globe_dem) -> dict:
    """Each kernel against its plain version, timed, at every width."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.agl_lookup import agl_lookup

    dev = torch.device("cuda")
    dem = torch.from_numpy(
        globe_dem.elevation_m.astype(np.float32)).to(dev)
    H, W_dem = dem.shape
    grid = (globe_dem.lat_min, globe_dem.lat_max, globe_dem.lon_min,
            globe_dem.lon_max, float(globe_dem.cells_per_deg))
    say("kernels", f"DEM {H} x {W_dem} f32, "
                   f"{dem.numel() * 4 / 1e6:.1f} MB on the card")
    rng = np.random.default_rng(11)
    results = {name: {"per_width": {}, "max_abs_err": 0.0}
               for name in ("track_interp", "agl_lookup", "dynamic_rates")}
    for W in WIDTHS:
        t_in, v_in, count_in, t_out, count_out = (
            torch.from_numpy(x).to(dev) for x in bucket_inputs(rng, W))
        B = v_in.shape[0]

        # track_interp
        got, interp_row = interp_check(t_in, v_in, count_in, t_out)

        # agl_lookup on the interpolated grid, indices as the pipeline
        # computes them
        v_grid = got.permute(0, 2, 1).contiguous()
        lat, lon, alt = v_grid[:, 0], v_grid[:, 1], v_grid[:, 2]
        fi = torch.clamp((torch.clamp(lat, grid[0], grid[1]) - grid[0])
                         * grid[4], 0.0, H - 1.001).contiguous()
        fj = torch.clamp((torch.clamp(lon, grid[2], grid[3]) - grid[2])
                         * grid[4], 0.0, W_dem - 1.001).contiguous()
        alt = alt.contiguous()
        got_a = agl_lookup(dem, fi, fj, alt)
        want_a = ref.agl_lookup_ref(dem, fi, fj, alt)
        err_a = (got_a - want_a).abs().max().item()
        ok_a = torch.allclose(got_a, want_a, rtol=TOL["agl_lookup"][0],
                              atol=TOL["agl_lookup"][1])
        # grid_sample's bilinear, align_corners=True, is the same gather.
        gs_grid = torch.stack([fj / (W_dem - 1) * 2 - 1,
                               fi / (H - 1) * 2 - 1], dim=-1)[None]
        dem4 = dem[None, None]
        lib_a = F.grid_sample(dem4, gs_grid, mode="bilinear",
                              align_corners=True)[0, 0]
        lib_err = (alt - lib_a - want_a).abs().max().item()
        i0 = torch.floor(fi).long()
        j0 = torch.floor(fj).long()
        cells = torch.cat([((i0 + di).clamp(max=H - 1) * W_dem
                            + (j0 + dj).clamp(max=W_dem - 1)).flatten()
                           for di in (0, 1) for dj in (0, 1)])
        n_cells = torch.unique(cells).numel()
        b_ms, b_by = bound(fi.numel() * 16 + n_cells * 4, fi.numel() * 20)
        agl_row = {
            "ms": device_ms(lambda: agl_lookup(dem, fi, fj, alt)),
            "plain_ms": device_ms(lambda: ref.agl_lookup_ref(
                dem, fi, fj, alt)),
            "library_ms": device_ms(lambda: F.grid_sample(
                dem4, gs_grid, mode="bilinear", align_corners=True)),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err_a,
            "dem_cells_touched": n_cells, "library_max_abs_err": lib_err}

        # dynamic_rates on the same grid
        rates_row = rates_check(v_grid, count_out, 1.0)

        for name, row, earlier in (
                ("track_interp", interp_row, INTERP_EARLIER_MS[W]),
                ("agl_lookup", agl_row, None),
                ("dynamic_rates", rates_row, RATES_EARLIER_MS[W])):
            say_kernel(name, f"B={B} M={W:4d}", row, earlier)
            if name == "agl_lookup" and not ok_a:
                raise AssertionError(
                    f"{name} at M={W} disagrees with its plain version: "
                    f"max |diff| {row['max_abs_err']}")
            results[name]["per_width"][W] = row
            results[name]["max_abs_err"] = max(
                results[name]["max_abs_err"], row["max_abs_err"])
        if W == WIDTHS[-1]:
            # A dt that is not a power of two takes the IEEE divisions.
            row = rates_check(v_grid, count_out, RATES_IEEE_DT)
            say_kernel("dynamic_rates", f"B={B} M={W:4d} dt={RATES_IEEE_DT} "
                                        f"(IEEE divisions)", row)
            results["dynamic_rates"]["ieee_dt"] = row
    return results


def launch_floor_ms(blocks: int, threads: int, smem: int, like) -> float:
    """device_ms of a kernel that does nothing, on the given grid: the
    part of a launch's time that no kernel design can remove."""
    from repro_torch.kernels import _build
    lib, stream = _build.lib(), _build.stream_of(like)

    def run():
        _build.check(lib.launch_floor(blocks, threads, smem, stream),
                     "launch_floor")
    return device_ms(run)


def interp_check(t_in, v_in, count_in, t_out) -> tuple:
    """track_interp against its plain version, bitwise and within TOL,
    timed beside it, its bound and the launch floor of its grid; returns
    the output and the row."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import track_interp as ti
    got = ti.track_interp(t_in, v_in, count_in, t_out)
    want = ref.track_interp_ref(t_in, v_in, count_in, t_out)
    torch.cuda.synchronize()
    split = ti.last_plan
    rtol, atol = TOL["track_interp"]
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, rtol=rtol, atol=atol)
    bitwise = torch.equal(got, want)
    # The kernel reads only each row's first `count` knots (times and C
    # value planes), every query time and count, and writes (B,M,C).
    B, C, _ = v_in.shape
    M = t_out.shape[1]
    knots = int(count_in.sum().item())
    nbytes = (knots * (1 + C) + B + B * M + B * M * C) * 4
    b_ms, b_by = bound(nbytes, B * M * (6 + 3 * C))
    row = {"ms": device_ms(lambda: ti.track_interp(t_in, v_in, count_in,
                                                   t_out)),
           "plain_ms": device_ms(lambda: ref.track_interp_ref(
               t_in, v_in, count_in, t_out)),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": err, "bitwise": bitwise,
           "floor_ms": launch_floor_ms(split.blocks,
                                       split.rows * split.per_row,
                                       split.smem, t_in),
           "plan": split._asdict()}
    if not ok or not bitwise:
        raise AssertionError(f"track_interp at B={B} M={M} disagrees with "
                             f"its plain version: max |diff| {err}, "
                             f"bitwise {bitwise}")
    return got, row


def rates_check(v, count, dt: float) -> dict:
    """dynamic_rates against its plain version, bitwise (headings
    included) and within TOL (headings as wrapped angles), timed beside
    it, its bound and the launch floor of its grid."""
    import torch
    from repro_torch.kernels import dynamic_rates as dr
    from repro_torch.kernels import ref
    got = dr.dynamic_rates(v, count, dt)
    want = ref.dynamic_rates_ref(v, count, dt)
    torch.cuda.synchronize()
    split = dr.last_plan
    diff = (got - want).abs()
    diff[:, 2] = wrapped(got[:, 2], want[:, 2]).float()
    err = diff.max().item()
    rtol, atol = TOL["dynamic_rates"]
    ok = bool((diff <= atol + rtol * want.abs()).all())
    bitwise = torch.equal(got, want)
    # Positions at and past count read nothing and write zeros.
    B, _, M = v.shape
    valid = int(count.clamp(max=M).sum().item())
    b_ms, b_by = bound((valid * 3 + B + B * 4 * M) * 4, valid * 60)
    row = {"ms": device_ms(lambda: dr.dynamic_rates(v, count, dt)),
           "plain_ms": device_ms(lambda: ref.dynamic_rates_ref(
               v, count, dt)),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": err, "bitwise": bitwise,
           "floor_ms": launch_floor_ms(split.blocks,
                                       split.rows * split.per_row, 0, v),
           "plan": split._asdict()}
    if not ok or not bitwise:
        raise AssertionError(f"dynamic_rates at B={B} M={M} dt={dt} "
                             f"disagrees with its plain version: max "
                             f"|diff| {err}, bitwise {bitwise}")
    return row


def say_kernel(name: str, shape: str, row: dict,
               earlier_ms: float | None = None) -> None:
    """One [kernels] line: agreement, kernel, plain, library and bound
    times, and for the redesigned kernels the launch floor and the split
    ``plan`` chose, and ``earlier_ms`` (the earlier design's time as
    PERF.md records it, printed here only) where given."""
    rtol, atol = TOL[name]
    lib = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    extra = ""
    if "floor_ms" in row:
        p = row["plan"]
        extra = (f"; launch floor {row['floor_ms']:.4f} ms; "
                 + (f"route {p['route']}, " if "route" in p else "")
                 + f"{p['rows']} rows x {p['per_row']} threads a block, "
                   f"{p['blocks']} blocks, "
                 + (f"{p['smem']} B shared, " if "smem" in p else "")
                 + ("16-byte" if p["vec"] else "scalar") + " path")
    if earlier_ms:
        extra += (f"; earlier design {earlier_ms:.4f} ms "
                  f"(now x{row['ms'] / earlier_ms:.3f})")
    say("kernels", f"{name:13s} {shape}: max|diff| "
                   f"{row['max_abs_err']:.3g} (rtol {rtol}, atol {atol})"
                   + (f", bitwise {row['bitwise']}" if "bitwise" in row
                      else "")
                   + f"; kernel {row['ms']:.4f} ms, plain "
                   f"{row['plain_ms']:.4f} ms, library {lib} ms, bound "
                   f"{row['bound_ms']:.4g} ms ({row['bound_by']})" + extra)


def top_shape(by_shape: dict):
    """The most frequent launch shape (the larger shape on a tie)."""
    return max(by_shape.items(), key=lambda kv: (kv[1], kv[0]))[0]


def phase_workflow_shapes(shapes: dict) -> dict:
    """track_interp and dynamic_rates at each workflow's or bench
    matrix's most frequent launch shape (``shapes``: label -> kernel ->
    launches_by_shape),
    bitwise against their plain versions and timed beside them, their
    bounds and the launch floor of their grids."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    out = {}
    for label, by_kernel in shapes.items():
        B, N, M = top_shape(by_kernel["track_interp"])
        t_in, v_in, count_in, t_out, _ = (
            torch.from_numpy(x).to(dev)
            for x in bucket_inputs(rng, M, B=B, N=N))
        _, i_row = interp_check(t_in, v_in, count_in, t_out)
        Br, Mr = top_shape(by_kernel["dynamic_rates"])
        Nr = max((n for b, n, m in by_kernel["track_interp"]
                  if (b, m) == (Br, Mr)), default=N_KNOTS)
        t_in, v_in, count_in, t_out, count_out = (
            torch.from_numpy(x).to(dev)
            for x in bucket_inputs(rng, Mr, B=Br, N=Nr))
        grid, _ = interp_check(t_in, v_in, count_in, t_out)
        v_grid = grid.permute(0, 2, 1).contiguous()
        r_row = rates_check(v_grid, count_out, 1.0)
        say_kernel("track_interp", f"{label}'s top shape B={B} N={N} M={M} "
                   f"({by_kernel['track_interp'][(B, N, M)]} launches)",
                   i_row)
        say_kernel("dynamic_rates", f"{label}'s top shape B={Br} M={Mr} "
                   f"({by_kernel['dynamic_rates'][(Br, Mr)]} launches)",
                   r_row)
        out[label] = {"track_interp": dict(i_row, shape=[B, N, M]),
                      "dynamic_rates": dict(r_row, shape=[Br, Mr])}
    return out


def screen_cells(rng, C: int, K: int, T: int):
    """C cells of K rows of 1 Hz trails clustered around one point per
    cell (as tests/test_encounter_screen.py builds them, so a real share
    of pairs hit), each row valid over a random span; as (C, K, T) f32
    planes lat, lon, alt, val."""
    import numpy as np
    lat = (40.0 + rng.normal(0, 0.005, (C, K, 1))
           + np.cumsum(rng.normal(0, 1e-4, (C, K, T)), axis=2))
    lon = (-100.0 + rng.normal(0, 0.005, (C, K, 1))
           + np.cumsum(rng.normal(0, 1e-4, (C, K, T)), axis=2))
    alt = rng.uniform(400, 900, (C, K, 1)) + rng.normal(0, 5, (C, K, T))
    start = rng.integers(0, T // 2, (C, K, 1))
    end = rng.integers(T // 2, T + 1, (C, K, 1))
    t = np.arange(T)[None, None, :]
    val = (t >= start) & (t < end)
    return [x.astype(np.float32) for x in (lat, lon, alt, val)]


def phase_screen_kernels(floor: dict) -> dict:
    """The encounter-screen kernel against its plain version, bitwise,
    timed, at every cell-batch shape, with the split the timed launches
    took (``encounter_screen.last_plan``) and the design floor: ``floor``'s SASS instructions per pair-sample over
    this run's jointly valid pair-samples, at 128 lanes a clock on every
    SM at the card's highest SM clock."""
    import numpy as np
    import torch
    from repro_torch.kernels import encounter_screen as screen

    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = sm_clock_hz()
    say("kernels", f"encounter_screen design floor at {n_sm} SMs x "
                   f"{LANES_PER_SM_CLOCK} lanes x {clock_hz / 1e6:.0f} MHz "
                   f"(nvidia-smi clocks.max.sm)")
    rng = np.random.default_rng(12)
    rtol, atol = TOL["encounter_screen"]
    res = {"per_shape": {}, "max_abs_err": 0.0}
    for C, K, T in SCREEN_SHAPES:
        args = [torch.from_numpy(x).to(dev)
                for x in screen_cells(rng, C, K, T)]

        def kernel():
            return screen.encounter_screen(*args, h_m=SCREEN_H_M,
                                           v_m=SCREEN_V_M)

        def plain():
            return screen._screen_batch_plain(*args, h_m=SCREEN_H_M,
                                              v_m=SCREEN_V_M)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        hit = want[0] > 0.5
        ok = (torch.equal(got[0], want[0])
              and torch.equal(got[3][hit], want[3][hit]))
        err = 0.0
        for g, w in zip(got[1:3], want[1:3]):
            d = (g[hit] - w[hit]).abs()
            err = max(err, d.max().item() if d.numel() else 0.0)
            ok = ok and bool((d <= atol + rtol * w[hit].abs()).all())
        # No-hit entries (lower triangle and diagonal too) hold the
        # reference's constants.
        for g, fill in zip(got, (0.0, 1e30, 1e30, 0.0)):
            ok = ok and bool((g[~hit] == torch.tensor(
                fill, dtype=torch.float32, device=dev)).all())
        bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
        # Jointly valid pair-samples with i < j: n_t valid rows at an
        # instant make n_t (n_t - 1) / 2 of them.
        n_t = args[3].sum(dim=1).double()
        valid_ps = float(((n_t * n_t - n_t) / 2).sum().item())
        nbytes = 4 * C * K * T * 4 + 4 * C * K * K * 4
        b_ms, b_by = bound(nbytes, valid_ps * SCREEN_OPS_PER_PAIR_SAMPLE)
        earlier = SCREEN_EARLIER_MS.get((C, K, T))
        runs = 10
        screen.last_plan = None
        k_ms = device_ms(kernel, runs=runs)
        split = screen.last_plan
        floor_ms = (floor[split.regime]["per_pair_sample"] * valid_ps
                    / (n_sm * LANES_PER_SM_CLOCK * clock_hz) * 1e3)
        row = {"ms": k_ms,
               "plain_ms": device_ms(plain, runs=runs),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "max_abs_err": err, "bitwise": bitwise,
               "regime": split.regime, "strips": split.strips,
               "hits": int(hit.sum().item()),
               "pairs": C * K * (K - 1) // 2,
               "valid_pair_samples": valid_ps}
        say("kernels", f"encounter_screen C={C} K={K} T={T}: "
                       f"{row['hits']} of {row['pairs']} pairs hit, "
                       f"{valid_ps:.0f} jointly valid pair-samples; "
                       f"{split.regime}-K regime, {split.strips} strips "
                       f"({split.block_strips} across blocks, "
                       f"{split.blocks} blocks); "
                       f"max|diff| {err:.3g} (rtol {rtol}, atol {atol}), "
                       f"bitwise {bitwise}; kernel {row['ms']:.4f} ms "
                       f"(earlier design: " + (f"{earlier:.4f} ms" if earlier
                                              else "not timed") + f"), "
                       f"plain {row['plain_ms']:.4f} ms, library - ms, "
                       f"bound {b_ms:.4g} ms ({b_by}), design floor "
                       f"{floor_ms:.4g} ms")
        if not ok or not bitwise:
            raise AssertionError(
                f"encounter_screen at C={C} K={K} T={T} disagrees with "
                f"its plain version bitwise: max |diff| {err}")
        res["per_shape"][f"{C}x{K}x{T}"] = row
        res["max_abs_err"] = max(res["max_abs_err"], err)
    return res


# Kernels whose wrappers count launches by shape.
SHAPED = {"track_interp": "(B, N, M)", "dynamic_rates": "(B, M)"}
SHAPES_PRINTED = 12


def snapshot_shapes(mods: dict) -> dict:
    """The SHAPED kernels' launches by shape, most frequent first, and
    track_interp's launches by route, read just after a run."""
    shapes = {name: dict(sorted(mods[name].launches_by_shape.items(),
                                key=lambda kv: (-kv[1], kv[0])))
              for name in SHAPED}
    shapes["routes"] = dict(mods["track_interp"].launches_by_route)
    return shapes


def say_shapes(tag: str, shapes: dict, launches: dict) -> None:
    """Print a snapshot_shapes; each kernel's shapes must sum to its
    launches."""
    for name, key in SHAPED.items():
        by = shapes[name]
        more = len(by) - SHAPES_PRINTED
        say(tag, f"{name} launches by shape {key}: " + ", ".join(
            f"{k}: {n}" for k, n in list(by.items())[:SHAPES_PRINTED])
            + (f", and {more} more shapes" if more > 0 else ""))
        if sum(by.values()) != launches[name]:
            raise AssertionError(f"{name} launches_by_shape sums to "
                                 f"{sum(by.values())}, not "
                                 f"{launches[name]}")
    say(tag, f"track_interp launches by route {shapes['routes']}")


def zero_counters(mods: dict) -> None:
    for mod in mods.values():
        mod.launches = 0
    for name in SHAPED:
        mods[name].launches_by_shape.clear()
    for route in mods["track_interp"].launches_by_route:
        mods["track_interp"].launches_by_route[route] = 0


def phase_workflow() -> tuple[dict, str, dict]:
    import torch
    from repro_torch.kernels import agl_lookup, dynamic_rates, ops
    from repro_torch.kernels import track_interp
    from repro_torch.tracks.workflow import TrackWorkflow

    shutil.rmtree(WORK, ignore_errors=True)
    wf = TrackWorkflow(WORK, n_workers=8, tasks_per_message=4,
                       poll_interval=0.005, device="cuda")
    t0 = time.perf_counter()
    n_files = wf.generate_raw(n_files=8, scale=500)
    say("workflow", f"generated {n_files} raw files in "
                    f"{time.perf_counter() - t0:.2f}s")
    mods = {"track_interp": track_interp, "agl_lookup": agl_lookup,
            "dynamic_rates": dynamic_rates}
    zero_counters(mods)
    ops.reset_pipeline_stats()
    t0 = time.perf_counter()
    reports = wf.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in mods.items()}
    shapes = snapshot_shapes(mods)
    stats = ops.get_pipeline_stats()
    for r in reports:
        say("workflow", f"{r.phase:9s}: {r.tasks:4d} tasks on {r.workers} "
                        f"threads workers in {r.job_seconds:.3f}s "
                        f"({r.messages} messages)")
    say("workflow", f"end to end {wall:.3f}s; launches {launches}; "
                    f"pipeline stats {stats}")
    say_shapes("workflow", shapes, launches)
    if min(launches.values()) < 1:
        raise AssertionError(f"the workflow bypassed a kernel: {launches}")
    if stats["intermediate_transfers"] != 0:
        raise AssertionError(f"fused path crossed the host: {stats}")
    if [r.phase for r in reports] != ["organize", "archive", "process"]:
        raise AssertionError(f"phases ran: {[r.phase for r in reports]}")
    return launches, wf.archive_dir, shapes


PLANES = ("times", "lat", "lon", "alt_msl_m", "alt_agl_m", "vrate_ms",
          "gspeed_ms", "heading_rad", "turn_rad_s")


def card_vs_cpu(pairs, what: str, worst: dict | None = None) -> dict:
    """Segment outputs of the card against the CPU's (plain versions) on
    the same items, ``pairs`` of (tag, card, CPU): names, airspace and
    counts equal and every plane within CARD_ATOL + CARD_RTOL * |CPU|
    (headings as wrapped angles); returns the worst |diff| by plane,
    updating ``worst`` where given."""
    import numpy as np
    worst = {} if worst is None else worst
    for tag, g, w in pairs:
        if g.icao24 != w.icao24 or g.airspace != w.airspace or \
                not np.array_equal(g.count, w.count):
            raise AssertionError(f"{what} {tag}: names/airspace/counts "
                                 f"differ")
        for attr in PLANES:
            a, b = getattr(g, attr), getattr(w, attr)
            if a.shape != b.shape:
                raise AssertionError(f"{what} {tag} {attr}: shape "
                                     f"{a.shape} vs {b.shape}")
            if not a.size:
                continue
            if attr == "heading_rad":
                d = np.abs(np.angle(np.exp(1j * (a.astype(np.float64) - b))))
            else:
                d = np.abs(a.astype(np.float64) - b)
            worst[attr] = max(worst.get(attr, 0.0), float(d.max()))
            if (d > CARD_ATOL + CARD_RTOL * np.abs(b)).any():
                raise AssertionError(f"{what} {tag} {attr}: card and CPU "
                                     f"differ by {d.max()}")
    return worst


def phase_globe(archive_dir: str, globe_dem) -> None:
    import torch
    from repro_torch.geometry.aerodromes import synthetic_aerodromes
    from repro_torch.tracks.segments import (
        SegmentProcessor, segment_tasks_from_archive_tree, split_segments)

    tasks = segment_tasks_from_archive_tree(archive_dir)
    aero = synthetic_aerodromes(n=64)
    gpu = SegmentProcessor(dem=globe_dem, aerodromes=aero, device="cuda")
    cpu = SegmentProcessor(dem=globe_dem, aerodromes=aero, device="cpu")
    gpu.process_batch(tasks)                    # DEM upload, warm-up
    # Where process_batch's time goes: the host parse of the zip/CSV
    # archives, then the bucketed pipeline (packing, kernels, fetch).
    t0 = time.perf_counter()
    items = [(obs, split_segments(obs["time"]))
             for obs in (gpu.read_observations(t.payload) for t in tasks)]
    items = [it for it in items if it[1]]
    parse_s = time.perf_counter() - t0
    pipe_s = {}
    for name, proc in (("card", gpu), ("CPU", cpu)):
        t0 = time.perf_counter()
        proc._process_many(items)
        torch.cuda.synchronize()
        pipe_s[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = gpu.process_batch(tasks)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = cpu.process_batch(tasks)
    cpu_s = time.perf_counter() - t0
    n_seg = gpu.last_stats["n_segments"]
    if gpu.last_stats != cpu.last_stats:
        raise AssertionError(f"bucket plans differ: {gpu.last_stats} vs "
                             f"{cpu.last_stats}")
    worst = card_vs_cpu(((tid, got[tid], w) for tid, w in want.items()),
                        "GLOBE batch")
    say("globe", f"{len(tasks)} archives, {n_seg} segments, "
                 f"{gpu.last_stats['pipeline_calls']} pipeline calls on a "
                 f"{globe_dem.elevation_m.shape[0]} x "
                 f"{globe_dem.elevation_m.shape[1]} DEM: card "
                 f"{gpu_s:.3f}s ({n_seg / gpu_s:.1f} segments/s, host "
                 f"parse included), CPU plain {cpu_s:.3f}s "
                 f"({n_seg / cpu_s:.1f} segments/s)")
    say("globe", f"split: host parse {parse_s:.3f}s; pipeline alone "
                 f"card {pipe_s['card']:.3f}s "
                 f"({n_seg / pipe_s['card']:.1f} segments/s), CPU plain "
                 f"{pipe_s['CPU']:.3f}s "
                 f"({n_seg / pipe_s['CPU']:.1f} segments/s)")
    say("globe", f"max |card - CPU| per plane (limit {CARD_ATOL} + "
                 f"{CARD_RTOL} |CPU|): " + ", ".join(
                     f"{k} {v:.3g}" for k, v in worst.items()))

    # Device busy share of the card's pipeline, from a profiler trace of
    # one more pass (the timed passes above ran without the profiler).
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gpu._process_many(items)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    busy = _device_busy(prof)
    busy_ms = sum(busy.values())
    if busy_ms > 0:
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
        say("globe", f"profiled pipeline pass {prof_s * 1e3:.1f} ms wall, "
                     f"device busy {busy_ms:.3f} ms (idle share "
                     f"{1 - busy_ms / (prof_s * 1e3):.4f}); top: " + "; ".join(
                         f"{k[:40]} {v:.3f} ms" for k, v in top))
    else:
        say("globe", "profiler saw no device time: idle share not measured")


def brute_force_overlapping(rows, config) -> list:
    """``brute_force_screen`` over every pair of rows that share an
    instant, deduplicated: the all-pairs result, without the O(N^2 T)
    global grid (782 rows over 8 hours would take minutes in numpy).
    Rows that never share an instant are never jointly valid, and with
    integer start times on the 1 s grid each pair's samples align
    exactly as on the global grid, so the records are the same."""
    from repro_torch.kernels.encounter_screen import (
        brute_force_screen, dedup_candidates)
    if config.dt_s != 1.0 or any(r.t0 != int(r.t0) for r in rows):
        raise AssertionError("pairwise brute force needs integer start "
                             "times on a 1 s grid")
    rows = sorted(rows, key=lambda r: r.t0)
    out = []
    for a, ra in enumerate(rows):
        end = ra.t0 + len(ra)
        for rb in rows[a + 1:]:
            if rb.t0 >= end:
                break
            out.extend(brute_force_screen([ra, rb], config=config))
    return dedup_candidates(out)


def same_candidates(got, want, what: str) -> float:
    """Raise unless the pair sets and t_s are equal and h_m/v_m agree
    within CAND_ATOL_M; return the largest distance difference."""
    if [(c["a"], c["b"]) for c in got] != [(c["a"], c["b"]) for c in want]:
        raise AssertionError(f"candidate pairs differ from {what}: "
                             f"{len(got)} vs {len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        if g["t_s"] != w["t_s"]:
            raise AssertionError(f"{g['a']}/{g['b']}: t_s {g['t_s']} vs "
                                 f"{w['t_s']} ({what})")
        d = max(abs(g["h_m"] - w["h_m"]), abs(g["v_m"] - w["v_m"]))
        worst = max(worst, d)
        if d > CAND_ATOL_M:
            raise AssertionError(f"{g['a']}/{g['b']}: distances differ by "
                                 f"{d} m from {what}")
    return worst


def phase_screen_workflow() -> dict:
    """organize -> archive -> store-build -> process -> screen on the
    card, with every kernel's launch counter zeroed just before."""
    import numpy as np
    import torch
    from repro_torch.kernels import agl_lookup, dynamic_rates, ops
    from repro_torch.kernels import encounter_screen, track_interp
    from repro_torch.runtime import run_job
    from repro_torch.tracks.datasets import SCREEN_ROW_BYTES
    from repro_torch.tracks.segments import (
        SegmentProcessor, segment_tasks_from_archive_tree,
        segment_tasks_from_store)
    from repro_torch.tracks.workflow import (
        ScreenWorker, TrackWorkflow, _screen_rows_for_uri)

    root = WORK + "_screen"
    shutil.rmtree(root, ignore_errors=True)
    wf = TrackWorkflow(root, n_workers=8, tasks_per_message=4,
                       poll_interval=0.005, device="cuda", input="store",
                       store_target_points=8192, screen=True, **SCREEN_WF)
    wf.generate_raw(n_files=8, scale=500)
    mods = {"track_interp": track_interp, "agl_lookup": agl_lookup,
            "dynamic_rates": dynamic_rates,
            "encounter_screen": encounter_screen}
    zero_counters(mods)
    encounter_screen.launches_by_shape.clear()
    ops.reset_pipeline_stats()
    encounter_screen.reset_screen_stats()
    t0 = time.perf_counter()
    reports = wf.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in mods.items()}
    shapes = snapshot_shapes(mods)
    by_shape = dict(sorted(encounter_screen.launches_by_shape.items()))
    stats = ops.get_pipeline_stats()
    sstats = encounter_screen.get_screen_stats()
    for r in reports:
        say("screen", f"{r.phase:11s}: {r.tasks:5d} tasks on {r.workers} "
                      f"threads workers in {r.job_seconds:.3f}s "
                      f"({r.messages} messages)")
    with open(wf.candidates_path) as f:
        got = json.load(f)["candidates"]
    tasks = wf._screen_tasks_full()
    occupancy = [t.size_bytes // SCREEN_ROW_BYTES for t in tasks]
    say("screen", f"end to end {wall:.3f}s; {sstats['cells_screened']} "
                  f"cells screened ({sstats['pairs_screened']} pairs, "
                  f"{sstats['kernel_calls']} screen calls), largest "
                  f"occupancy {max(occupancy)}, {len(got)} candidates; "
                  f"launches {launches}; pipeline stats {stats}")
    phases = [r.phase for r in reports]
    if phases != ["organize", "archive", "store-build", "process",
                  "screen"]:
        raise AssertionError(f"phases ran: {phases}")
    say_shapes("screen", shapes, launches)
    say("screen", "encounter_screen launches by padded shape (Kp, Tp): "
                  + ", ".join(f"({k}, {t}): {n}"
                              for (k, t), n in by_shape.items()))
    if sum(by_shape.values()) != launches["encounter_screen"]:
        raise AssertionError(f"launches_by_shape {by_shape} does not sum "
                             f"to {launches['encounter_screen']}")
    if min(launches.values()) < 1:
        raise AssertionError(f"the workflow bypassed a kernel: {launches}")
    if stats["intermediate_transfers"] != 0:
        raise AssertionError(f"fused path crossed the host: {stats}")
    if not got:
        raise AssertionError("the screen found no candidates")

    # The rows the screen saw, from the store, on the card and on the
    # CPU: the resampled planes agree bitwise, so only the screen's
    # cosf can tell the two sides apart.
    gpu = SegmentProcessor(device="cuda")
    cpu = SegmentProcessor(device="cpu")
    shards = segment_tasks_from_store(wf.store_dir, granularity="shard")
    rows = [r for t in shards for r in _screen_rows_for_uri(gpu, t.payload)]
    rows_cpu = [r for t in shards
                for r in _screen_rows_for_uri(cpu, t.payload)]
    for a, b in zip(rows, rows_cpu):
        if a.row_id != b.row_id or not all(
                np.array_equal(getattr(a, k), getattr(b, k))
                for k in ("lat", "lon", "alt")):
            raise AssertionError(f"{a.row_id}: card and CPU planes differ")
    if len(rows) != len(rows_cpu):
        raise AssertionError("card and CPU rows differ in number")
    t0 = time.perf_counter()
    want = brute_force_overlapping(rows, wf.screen_config)
    bf_s = time.perf_counter() - t0
    d_bf = same_candidates(got, want, "brute force")

    # The screen tasks re-run on the CPU (plain versions), 8 processes.
    cpu_worker = ScreenWorker(wf.store_dir, h_thresh_m=wf.screen_config.h_thresh_m,
                              v_thresh_m=wf.screen_config.v_thresh_m,
                              device="cpu")
    t0 = time.perf_counter()
    res = run_job(tasks, cpu_worker, backend="processes", n_workers=8,
                  tasks_per_message=4, poll_interval=0.005)
    cpu_s = time.perf_counter() - t0
    cpu_cands = encounter_screen.dedup_candidates(
        c for t in tasks for c in res.results[t.task_id]["candidates"])
    d_cpu = same_candidates(got, cpu_cands, "the CPU re-run")
    say("screen", f"{len(rows)} rows; candidates = brute force over "
                  f"overlapping pairs ({bf_s:.2f}s, max |d| {d_bf:.3g} m) "
                  f"= CPU re-run of {len(tasks)} screen tasks on 8 "
                  f"processes ({cpu_s:.2f}s, max |d| {d_cpu:.3g} m); "
                  f"row planes card = CPU bitwise")

    # The store path's process phase against the zip path's, on the card.
    by_track = gpu.process_batch(
        segment_tasks_from_store(wf.store_dir, granularity="track"))
    by_zip = gpu.process_batch(
        segment_tasks_from_archive_tree(wf.archive_dir))
    if sorted(by_track) != sorted(by_zip):
        raise AssertionError("store and zip task ids differ")
    for tid, z in by_zip.items():
        g = by_track[tid]
        if g.icao24 != z.icao24 or g.airspace != z.airspace or not all(
                np.array_equal(getattr(g, k), getattr(z, k))
                for k in ("count", "times", "lat", "lon", "alt_msl_m",
                          "alt_agl_m", "vrate_ms", "gspeed_ms",
                          "heading_rad", "turn_rad_s")):
            raise AssertionError(f"{tid}: store and zip paths differ")
    say("screen", f"store path = zip path bitwise over {len(by_zip)} "
                  f"tracks on the card")
    profile_screen_tasks(wf, tasks[:SCREEN_PROFILE_TASKS])
    return launches, shapes, {
        "phase_seconds": {r.phase: r.job_seconds for r in reports},
        "wall_s": wall, "stats": sstats}


def tree_bytes(root: str) -> dict:
    """Every file under ``root``: relative path -> bytes."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def same_tree(got: dict, want: dict, what: str) -> None:
    """Raise unless the store trees and candidate files are equal."""
    if got.get("candidates.json") != want.get("candidates.json"):
        raise AssertionError(f"{what}: candidates.json differs")
    store = {k: v for k, v in want.items() if k.startswith("store")}
    if not store or {k: v for k, v in got.items()
                     if k.startswith("store")} != store:
        raise AssertionError(f"{what}: store/ differs")


def phase_dag(barrier: dict) -> tuple[dict, dict]:
    """The store + screen workflow as one streaming DAG on the card, at
    phase 5's data and settings and at its root (the store manifest
    records the archive root), held byte for byte against phase 5's
    barrier run; then a small DAG on 4 processes workers and 2 manager
    shards against a barrier run of the same data."""
    import torch
    import repro_torch.tracks.workflow as workflow_mod
    from repro_torch.kernels import agl_lookup, dynamic_rates, ops
    from repro_torch.kernels import encounter_screen, track_interp
    from repro_torch.obs import Tracer
    from repro_torch.tracks.segments import segment_tasks_from_store
    from repro_torch.tracks.workflow import TrackWorkflow, _CellBinEmitter

    root = WORK + "_screen"
    barrier_root = root + "_barrier"
    shutil.rmtree(barrier_root, ignore_errors=True)
    os.rename(root, barrier_root)
    want = tree_bytes(barrier_root)
    tracer = Tracer()
    wf = TrackWorkflow(root, n_workers=8, tasks_per_message=4,
                       poll_interval=0.005, device="cuda", input="store",
                       store_target_points=8192, screen=True, mode="dag",
                       tracer=tracer, **SCREEN_WF)
    wf.generate_raw(n_files=8, scale=500)
    mods = {"track_interp": track_interp, "agl_lookup": agl_lookup,
            "dynamic_rates": dynamic_rates,
            "encounter_screen": encounter_screen}
    # The workflow keeps no DagResult; catch it for the ledger check.
    dag_results = []
    run_dag = workflow_mod.run_dag

    def run_dag_kept(*args, **kwargs):
        dag_results.append(run_dag(*args, **kwargs))
        return dag_results[-1]

    zero_counters(mods)
    encounter_screen.launches_by_shape.clear()
    ops.reset_pipeline_stats()
    encounter_screen.reset_screen_stats()
    workflow_mod.run_dag = run_dag_kept
    try:
        t0 = time.perf_counter()
        reports = wf.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        workflow_mod.run_dag = run_dag
    launches = {name: mod.launches for name, mod in mods.items()}
    shapes = snapshot_shapes(mods)
    by_shape = dict(sorted(encounter_screen.launches_by_shape.items()))
    stats = ops.get_pipeline_stats()
    sstats = encounter_screen.get_screen_stats()
    if [r.phase for r in reports] != ["dag"]:
        raise AssertionError(f"phases ran: {[r.phase for r in reports]}")
    same_tree(tree_bytes(root), want, "DAG vs barrier")
    r = reports[0]
    barrier_sum = sum(barrier["phase_seconds"].values())
    say("dag", f"{r.tasks} tasks on {r.workers} threads workers in "
               f"{r.job_seconds:.3f}s ({r.messages} messages; end to end "
               f"{wall:.3f}s) beside the barrier run's phases "
               f"{barrier_sum:.3f}s in sum (end to end "
               f"{barrier['wall_s']:.3f}s): "
               + ", ".join(f"{k} {v:.3f}s"
                           for k, v in barrier["phase_seconds"].items()))
    say("dag", f"store/ ({len([k for k in want if k.startswith('store')])} "
               f"files) and candidates.json of the traced DAG "
               f"byte-identical to the untraced barrier run's")
    check_dag_trace(tracer, dag_results, r.job_seconds)
    say("dag", f"screen stats {sstats} (barrier: {barrier['stats']}); "
               f"launches {launches}, the cell-bin emitter's re-derivation "
               f"in the manager thread included; pipeline stats {stats}")
    say_shapes("dag", shapes, launches)
    say("dag", "encounter_screen launches by padded shape (Kp, Tp): "
               + ", ".join(f"({k}, {t}): {n}"
                           for (k, t), n in by_shape.items()))
    if sum(by_shape.values()) != launches["encounter_screen"]:
        raise AssertionError(f"launches_by_shape {by_shape} does not sum "
                             f"to {launches['encounter_screen']}")
    if min(launches.values()) < 1:
        raise AssertionError(f"the DAG bypassed a kernel: {launches}")
    if stats["intermediate_transfers"] != 0:
        raise AssertionError(f"fused path crossed the host: {stats}")

    # The emitter's share, replayed alone: a fresh emitter fed every
    # committed shard's process task, as the DAG fed it.
    zero_counters(mods)
    emitter = _CellBinEmitter(wf.store_dir, wf.screen_grid,
                              wf.screen_config, device="cuda")
    t0 = time.perf_counter()
    cut = [t for task in segment_tasks_from_store(wf.store_dir,
                                                  granularity="shard")
           for t in emitter.feed(task, None)]
    torch.cuda.synchronize()
    say("dag", f"of which the emitter's re-derivation, replayed alone: "
               f"{ {n: m.launches for n, m in mods.items()} } in "
               f"{time.perf_counter() - t0:.3f}s, cutting {len(cut)} "
               f"generations in shard order")

    # Processes workers (spawned: the parent runs CUDA by now) and two
    # manager shards, at tests/test_workflow_screen.py's settings.
    small = dict(n_workers=4, poll_interval=0.003, device="cuda",
                 input="store", store_target_points=2048, screen=True,
                 **SCREEN_WF)
    trees = {}
    for mode, kw in (("barrier", {}),
                     ("dag", dict(exec_backend="processes",
                                  n_manager_shards=2))):
        sroot = WORK + "_dag_small"
        shutil.rmtree(sroot, ignore_errors=True)
        swf = TrackWorkflow(sroot, mode=mode, **small, **kw)
        swf.generate_raw(n_files=1, scale=1000)
        t0 = time.perf_counter()
        sreports = swf.run()
        trees[mode] = tree_bytes(sroot)
        say("dag", f"small {mode}"
                   + (" (4 processes workers, 2 manager shards)"
                      if kw else " (4 threads workers)")
                   + f": {time.perf_counter() - t0:.3f}s, "
                   + ", ".join(f"{x.phase} {x.tasks} tasks "
                               f"{x.job_seconds:.3f}s" for x in sreports))
        shutil.rmtree(sroot)
    same_tree(trees["dag"], trees["barrier"], "small DAG vs barrier")
    n = len(json.loads(trees["dag"]["candidates.json"])["candidates"])
    if n < 1:
        raise AssertionError("the small DAG found no candidates")
    say("dag", f"small DAG: store/ and candidates.json ({n} candidates) "
               f"byte-identical to the barrier run's")
    shutil.rmtree(barrier_root)
    return launches, shapes, {"n_events": len(tracer),
                              "job_seconds": r.job_seconds}


def ledger_invariants(events, completed_ids) -> None:
    """tests/test_obs.py's span-ledger invariants: one exec span and one
    done instant per completed task and none for anything else, every
    requeued task that finished re-assigned after its requeue, and no
    two exec spans of one worker overlapping."""
    completed = sorted(completed_ids)
    execs = [e for e in events if e[2] == "exec"]
    if sorted(e[5] for e in execs) != completed:
        raise AssertionError("exec spans are not one per completed task")
    if sorted(e[5] for e in events if e[2] == "done") != completed:
        raise AssertionError("done instants are not one per completed "
                             "task")
    last_assigned, last_requeued = {}, {}
    for i, e in enumerate(events):
        if e[2] == "assigned":
            last_assigned[e[5]] = i
        elif e[2] == "requeued":
            last_requeued[e[5]] = i
    done = set(completed)
    for tid, i in last_requeued.items():
        if tid in done and last_assigned.get(tid, -1) < i:
            raise AssertionError(f"{tid} finished but was not re-assigned "
                                 f"after its requeue")
    by_worker = {}
    for e in execs:
        by_worker.setdefault(str(e[4]), []).append(e)
    for worker, spans in by_worker.items():
        spans.sort(key=lambda e: e[0])
        for prev, nxt in zip(spans, spans[1:]):
            if nxt[0] < prev[0] + prev[1] - 1e-9:
                raise AssertionError(f"worker {worker}: exec spans overlap")


def check_dag_trace(tracer, dag_results, job_seconds: float) -> None:
    """Phase 5b's trace: complete, true to the DAG's ledger, exported,
    read back and reported; prints the per-node split."""
    import contextlib
    import io

    from repro_torch.obs import (
        build_summary, from_chrome_trace, phase_of, write_trace_files)
    from repro_torch.obs.report import main as report_main

    t0 = time.perf_counter()
    if tracer.dropped != 0:
        raise AssertionError(f"the trace dropped {tracer.dropped} events")
    if len(dag_results) != 1:
        raise AssertionError(f"{len(dag_results)} run_dag calls, not 1")
    events = tracer.events
    ledger_invariants(events, dag_results[0].run.completed_ids)
    out = WORK + "_trace"
    shutil.rmtree(out, ignore_errors=True)
    paths = write_trace_files(tracer, out, label="dag")
    with open(paths["trace"]) as f:
        back = from_chrome_trace(json.load(f))
    if len(back) != len(events):
        raise AssertionError(f"trace.json read back {len(back)} events, "
                             f"the tracer held {len(events)}")
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        rc = report_main([paths["summary"]])
    if rc != 0:
        raise AssertionError(f"repro_torch.obs.report exited {rc}")
    for line in report.getvalue().splitlines():
        say("dag", f"report | {line}")
    with open(paths["summary"]) as f:
        summary = json.load(f)
    m = summary["scenario"]["metrics"]
    say("dag", f"trace: {len(events)} events, 0 dropped, ledger "
               f"invariants hold over {len(dag_results[0].run.completed_ids)}"
               f" completed tasks, trace.json read back to "
               f"{len(back)} events (checked, exported, read back and "
               f"reported in {time.perf_counter() - t0:.3f}s); makespan_s "
               f"{m['makespan_s']:.6f}, critical_path_s "
               f"{m['critical_path_s']:.6f} beside job_seconds "
               f"{job_seconds:.6f}")
    by_node = {}
    for e in events:
        by_node.setdefault(phase_of(e[5]), []).append(e)
    for node, phase in sorted(summary["phases"].items()):
        nm = build_summary(by_node[node])["scenario"]["metrics"]
        say("dag", f"node {node:11s}: n_tasks {phase['n_tasks']}, busy_s "
                   f"{phase['busy_s']:.6f}, critical_path_s "
                   f"{phase['critical_path_s']:.6f}, exec p50 "
                   f"{nm['exec_p50_s']:.6f} s p99 {nm['exec_p99_s']:.6f} s, "
                   f"straggler_count {nm['straggler_count']}")


def phase_trace(dag_trace: dict) -> None:
    """The tracer's host cost per event, and --trace as a user runs it."""
    from repro_torch.obs import INSTANT, Tracer

    t_phase = time.perf_counter()
    n = 1_000_000
    tracer = Tracer(capacity=n)
    emit = tracer.emit
    t0 = time.perf_counter()
    for i in range(n):
        emit(0.0, INSTANT, "done", "task", 0, "t", None)
    emit_us = (time.perf_counter() - t0) / n * 1e6
    tracer.clear()
    raw = tracer.raw
    event = (0.0, INSTANT, "done", "task", 0, "t", None)
    t0 = time.perf_counter()
    for i in range(n):
        raw(event)
    tracer.emitted += n
    raw_us = (time.perf_counter() - t0) / n * 1e6
    if len(tracer) != n or tracer.dropped != 0:
        raise AssertionError("the raw appends were not all kept")
    host_s = dag_trace["n_events"] * emit_us * 1e-6
    say("trace", f"emit {emit_us:.4f} us/event, raw append {raw_us:.4f} "
                 f"us/event ({n} each); phase 5b's {dag_trace['n_events']}"
                 f" events x emit = {host_s:.6f}s of host time beside its "
                 f"job_seconds {dag_trace['job_seconds']:.6f} "
                 f"({host_s / dag_trace['job_seconds'] * 100:.4f} %)")

    root = WORK + "_cli"
    out = root + "_trace"
    for d in (root, out):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.tracks.workflow", "--root",
         root, "--files", "1", "--scale", "1000", "--trace", out],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC))
    if proc.returncode != 0:
        raise AssertionError(f"--trace run exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("trace: ")]
    files = [os.path.join(out, f) for f in ("trace.json",
                                            "TRACE_summary.json")]
    if len(lines) != 1 or not all(os.path.isfile(f) for f in files):
        wrote = os.listdir(out) if os.path.isdir(out) else []
        raise AssertionError(f"--trace run printed {lines} and wrote "
                             f"{wrote}")
    say("trace", f"python -m repro_torch.tracks.workflow --files 1 --scale "
                 f"1000 --trace: exit 0 in {time.perf_counter() - t0:.3f}s; "
                 + "; ".join(ln.strip() for ln in proc.stdout.splitlines()))
    for d in (root, out):
        shutil.rmtree(d)
    say("trace", f"phase 5c in {time.perf_counter() - t_phase:.3f}s")


def profile_screen_tasks(wf, tasks) -> None:
    """Where a screen task's time goes: ``tasks`` run one after another
    on the card under cProfile (the host split between the store reads,
    the per-track segment pipeline and the cell screen) and
    torch.profiler (device busy time, hence the idle share)."""
    import cProfile
    import pstats
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.tracks.workflow import ScreenWorker

    worker = ScreenWorker(wf.store_dir,
                          h_thresh_m=wf.screen_config.h_thresh_m,
                          v_thresh_m=wf.screen_config.v_thresh_m,
                          device="cuda")
    worker(tasks[0])                            # processor, DEM upload
    host = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        host.enable()
        for t in tasks:
            worker(t)
        torch.cuda.synchronize()
        host.disable()
        wall = time.perf_counter() - t0
    cum = {}
    for (path, _line, name), row in pstats.Stats(host).stats.items():
        key = (os.path.basename(path), name)
        cum[key] = cum.get(key, 0.0) + row[3]
    split = {"store reads": cum.get(("segments.py", "read_observations"), 0),
             "segment pipeline": cum.get(("segments.py", "process_arrays"), 0),
             "cell screen": cum.get(("encounter_screen.py", "screen_cells"), 0)}
    by_kernel = _device_busy(prof)
    busy = sum(by_kernel.values()) / 1e3
    screen_ms = sum(v for k, v in by_kernel.items() if "screen_" in k)
    say("screen", f"{len(tasks)} screen tasks one after another on the "
                  f"card, profiled: {wall:.3f}s wall "
                  f"({wall / len(tasks) * 1e3:.2f} ms a task); host split "
                  + ", ".join(f"{k} {v:.3f}s ({v / wall:.2f})"
                              for k, v in split.items())
                  + (f"; device busy {busy:.4f}s (idle share "
                     f"{1 - busy / wall:.4f}), of it the encounter_screen "
                     f"kernels {screen_ms / 1e3:.4f}s "
                     f"({screen_ms / len(tasks):.4f} ms a task)"
                     if busy > 0 else
                     "; profiler saw no device time: idle share not "
                     "measured"))


def flash_bound(B, H, KV, T, S, hd, causal, itemsize, ops_per_s,
                ops_per_pair=None):
    """(ms, "bytes" | "operations"): q, k, v read once and o written once
    against ``ops_per_pair`` operations (default 4 * hd: 2 hd for the
    score, 2 hd for the weighted sum) for each (query, key) pair the mask
    keeps."""
    # Query t keeps keys 0 .. t + S - T, clipped to [0, S].
    pairs = (sum(min(max(t + S - T + 1, 0), S) for t in range(T))
             if causal else T * S)
    nbytes = itemsize * (2 * B * H * T * hd + 2 * B * KV * S * hd)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops_per_pair or 4 * hd) * pairs * B * H / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_flash() -> dict:
    """The flash kernels against their plain version at every shape, each
    through the route its dtype and head_dim select, timed beside the
    plain version, at T == S SDPA, and for bf16 the CUDA-core kernel's
    bf16 entry on the same inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    cases = [(shape, torch.float32) for shape in FLASH_TEST_SHAPES]
    cases.append((FLASH_BF16_SHAPE, torch.bfloat16))
    cases += [((1, 32, 8, T, T, 160, True), dt) for T in FLASH_LM_T
              for dt in (torch.bfloat16, torch.float32)]
    cases.append((FLASH_MAIN_PATH_SHAPE, torch.bfloat16))
    cases += [(shape, torch.bfloat16) for shape in FLASH_ARMS_SHAPES]
    res = {"per_shape": {}, "max_abs_err": 0.0}
    for (B, H, KV, T, S, hd, causal), dt in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                   for shape in ((B, H, T, hd), (B, KV, S, hd),
                                 (B, KV, S, hd)))
        bf16 = dt == torch.bfloat16
        route = "sm90" if bf16 else "cuda_core"
        before = dict(flash_mod.launches_by_route)
        got = flash_mod.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        name = f"B={B} H={H} KV={KV} T={T} S={S} hd={hd} " \
               f"{'causal' if causal else 'full'} {str(dt)[6:]}"
        routed = {r: flash_mod.launches_by_route[r] - before[r]
                  for r in before}
        if routed != {r: int(r == route) for r in before}:
            raise AssertionError(f"flash_attention at {name} went through "
                                 f"{routed}, expected route {route}")
        rtol, atol = ((FLASH_BF16_RTOL, FLASH_BF16_ATOL) if bf16
                      else (FLASH_F32_TOL, FLASH_F32_TOL))

        def gate(out):
            """(max |out - plain|, whether every element meets the gate,
            share of elements outside it)."""
            d = (out.float() - want).abs()
            outside = d > atol + rtol * want.abs()
            return (d.max().item(), not bool(outside.any()),
                    outside.float().mean().item())

        err, ok, _ = gate(got)
        tol = f"rtol {rtol:.3g}, atol {atol:.3g}"
        if not ok:
            raise AssertionError(f"flash_attention at {name} disagrees with "
                                 f"its plain version: max |diff| {err}")
        runs = 10 if T * S >= 2048 * 2048 else TIMED_RUNS
        row = {"route": route, "max_abs_err": err,
               "ms": device_ms(lambda: flash_mod.flash_attention(
                   q, k, v, causal=causal), runs=runs),
               "plain_ms": device_ms(lambda: ref.flash_attention_ref(
                   q, k, v, causal=causal), runs=runs),
               "library_ms": None, "cuda_core_ms": None}
        if bf16:
            # The CUDA-core kernel's bf16 entry (the route of every bf16
            # input before the tensor-core kernel), called directly on
            # the same inputs.
            old = flash_mod._launch("cuda_core", q, k, v, causal=causal)
            torch.cuda.synchronize()
            row["cuda_core_max_abs_err"], old_ok, _ = gate(old)
            if not old_ok:
                raise AssertionError(f"the CUDA-core bf16 entry at {name} "
                                     f"disagrees with the plain version")
            del old
            row["cuda_core_ms"] = device_ms(lambda: flash_mod._launch(
                "cuda_core", q, k, v, causal=causal), runs=runs)
        if T == S:
            lib = F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                 enable_gqa=True)
            (row["library_max_abs_err"], _,
             row["library_outside_gate"]) = gate(lib)
            del lib
            row["library_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True), runs=runs)
        rate = BF16_OPS_PER_S if bf16 else F32_OPS_PER_S
        row["bound_ms"], row["bound_by"] = flash_bound(
            B, H, KV, T, S, hd, causal, q.element_size(), rate)
        if bf16:
            # The sm90 kernel's own floor: 2 hd for the score and 4 hd for
            # P.V issued twice (hi and lo) per kept pair.
            floor_ms, _ = flash_bound(
                B, H, KV, T, S, hd, causal, q.element_size(), rate,
                ops_per_pair=6 * hd)
        lib = ("-" if row["library_ms"] is None
               else f"{row['library_ms']:.4f}")
        extra = ("" if not bf16 else
                 f", CUDA-core bf16 entry {row['cuda_core_ms']:.4f} ms "
                 f"({row['cuda_core_ms'] / row['ms']:.1f}x), design floor "
                 f"{floor_ms:.4f} ms")
        if "library_outside_gate" in row:
            extra += (f"; SDPA outside the gate: "
                      f"{row['library_outside_gate']:.4f} of the outputs")
        say("flash", f"{name} [{route}]: max|diff| {err:.3g} ({tol}); "
                     f"kernel {row['ms']:.4f} ms, plain "
                     f"{row['plain_ms']:.4f} ms, library {lib} ms, bound "
                     f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
                     f"{row['ms'] / row['bound_ms']:.1f}x the bound" + extra)
        res["per_shape"][name] = row
        res["max_abs_err"] = max(res["max_abs_err"], err)
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return res


# Phase 8: the bench matrices (repro_torch.bench).  Checks on a record's
# deterministic ``metrics`` must pass; checks on ``measured`` read a
# clock (speed gates) and are printed with their outcome.  The card's
# and the CPU's quick cells must agree on every metric but the fused-
# vs-unfused difference, which each side keeps within BENCH_DIFF_TOL.
BENCH_DIFF = "max_abs_diff_vs_baseline"
BENCH_DIFF_TOL = 1e-5
BENCH_CARD_KERNELS = {"kernels": ("track_interp", "agl_lookup",
                                  "dynamic_rates"),
                      "storage": ("track_interp", "agl_lookup",
                                  "dynamic_rates"),
                      "encounters": ("encounter_screen",)}
# Deterministic metrics every record that has them must hold, whatever
# its declared checks.
BENCH_EXACT = {"candidate_set_equal": 1, "candidate_values_equal": 1,
               "feed_bitwise_equal": 1.0, "rebuild_identical": 1.0,
               "intermediate_transfers": 0}


def bench_checks(kind: str, doc: dict) -> list:
    """Raise on an errored record or a failed check of a deterministic
    metric; return the speed checks (on ``measured``) as printable
    lines."""
    speed = []
    for rec in doc["scenarios"]:
        if rec["status"] == "error":
            raise AssertionError(f"{kind} {rec['name']}: {rec['error']}")
        m = rec["metrics"]
        for key, want in BENCH_EXACT.items():
            if key in m and m[key] != want:
                raise AssertionError(f"{kind} {rec['name']}: {key} = "
                                     f"{m[key]}, not {want}")
        if BENCH_DIFF in m and not m[BENCH_DIFF] <= BENCH_DIFF_TOL:
            raise AssertionError(f"{kind} {rec['name']}: {BENCH_DIFF} = "
                                 f"{m[BENCH_DIFF]}")
        for c in rec["checks"]:
            line = (f"{kind} {rec['name']}: {c['metric']} = {c['actual']} "
                    f"vs {c['kind']} {c['expect']}: "
                    f"{'pass' if c['passed'] else 'FAIL'}")
            if c["metric"] in rec["measured"]:
                speed.append(line)
            elif not c["passed"]:
                raise AssertionError(f"correctness check failed: {line}")
    return speed


def bench_same_as_cpu(kind: str, card: dict, cpu: dict) -> int:
    """The CPU run's records against the card run's same-named ones:
    every metric equal but BENCH_DIFF (each side within its tolerance,
    checked by bench_checks)."""
    by_name = {r["name"]: r for r in card["scenarios"]}
    for rec in cpu["scenarios"]:
        got = {k: v for k, v in by_name[rec["name"]]["metrics"].items()
               if k != BENCH_DIFF}
        want = {k: v for k, v in rec["metrics"].items() if k != BENCH_DIFF}
        if got != want:
            diff = {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                    if got.get(k) != want.get(k)}
            raise AssertionError(f"{kind} {rec['name']}: card and CPU "
                                 f"metrics differ: {diff}")
    return len(cpu["scenarios"])


def profile_kernel_cell(record: dict, repeats: int = 5,
                        rounds: int = 5) -> dict:
    """Where the kernels matrix's quick cell spends a steady batch, fused
    and unfused, on the card, in windows of ``repeats`` batches: first
    ``rounds`` unprofiled windows of each path, alternated (wall ms a
    batch, median and range; the idle share is taken against the
    median), then one under torch.profiler alone (device busy ms) and one
    under cProfile alone (the host split, as shares of that window's
    wall time: cProfile slows the host).  ``record`` is the cell's bench
    record, whose own timing (one window of its repeats) is printed
    beside."""
    import cProfile
    import pstats
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.bench import kernels as kbench
    from repro_torch.geometry.aerodromes import synthetic_aerodromes
    from repro_torch.tracks.segments import SegmentProcessor

    spec = next(sc for sc in kbench.kernel_scenarios()
                if sc.name == record["name"]).run
    items = kbench.synth_items(spec)

    def window(proc) -> float:
        t0 = time.perf_counter()
        for _ in range(repeats):
            proc._process_many(items)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / repeats * 1e3

    procs = {}
    for pipeline in ("fused", "unfused"):
        procs[pipeline] = SegmentProcessor(
            aerodromes=synthetic_aerodromes(n=48), device="cuda",
            pipeline=pipeline)
        procs[pipeline]._process_many(items)        # shapes, DEM upload
    torch.cuda.synchronize()
    walls = {pipeline: [] for pipeline in procs}
    for _ in range(rounds):
        for pipeline, proc in procs.items():
            walls[pipeline].append(window(proc))
    out = {}
    for pipeline, proc in procs.items():
        wall = statistics.median(walls[pipeline])
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall_traced = window(proc)
        busy = sum(_device_busy(prof).values()) / repeats
        host = cProfile.Profile()
        host.enable()
        wall_cprofile = window(proc)
        host.disable()
        cum = {}
        for (path, _line, name), row in pstats.Stats(host).stats.items():
            key = f"{os.path.basename(path)}:{name}"
            cum[key] = cum.get(key, 0.0) + row[3] / repeats * 1e3
        share = {k: cum.get(k, 0.0) / wall_cprofile for k in (
            "segments.py:_records", "ops.py:process_segments",
            "ops.py:track_interp", "ops.py:agl_lookup",
            "ops.py:dynamic_rates", "segments.py:_airspace_classes")}
        share["Tensor.cpu"] = sum(v for k, v in cum.items()
                                  if "method 'cpu' of" in k) / wall_cprofile
        idle = 1 - busy / wall if busy > 0 else None
        out[pipeline] = {"wall_ms": wall, "wall_ms_range":
                         [min(walls[pipeline]), max(walls[pipeline])],
                         "wall_traced_ms": wall_traced,
                         "wall_cprofile_ms": wall_cprofile,
                         "device_busy_ms": busy, "idle_share": idle,
                         "host_share": share}
        say("bench", f"{spec.workload} {pipeline}: {wall:.3f} ms a batch "
                     f"unprofiled (median of {rounds} windows of {repeats}, "
                     f"{min(walls[pipeline]):.3f}-{max(walls[pipeline]):.3f};"
                     f" {proc.last_stats['pipeline_calls']} pipeline calls); "
                     f"device busy {busy:.4f} ms under torch.profiler "
                     f"({wall_traced:.3f} ms a batch there), "
                     + (f"idle share {idle:.4f} of the unprofiled batch"
                        if idle is not None else "profiler saw no device "
                        "time: idle share not measured")
                     + f"; host shares under cProfile ({wall_cprofile:.3f} "
                       f"ms a batch there): " + ", ".join(
                           f"{k} {v:.3f}" for k, v in share.items() if v))
    m = record["measured"]
    say("bench", f"{spec.workload} unprofiled unfused/fused "
                 f"{out['unfused']['wall_ms'] / out['fused']['wall_ms']:.4f}"
                 f" (medians); the bench record's own window: fused "
                 f"{m['wall_s_per_batch'] * 1e3:.3f} ms, unfused "
                 f"{m['baseline_wall_s_per_batch'] * 1e3:.3f} ms a batch, "
                 f"speedup_x {m['speedup_x']:.4f}")
    return out


def bench_outputs_vs_cpu() -> dict:
    """The segment outputs of every kernels-matrix cell (fused and its
    unfused baseline) and of every storage cell that feeds the pipeline,
    on the card against the CPU on the same items (card_vs_cpu), pass by
    pass as the bench makes its pipeline calls; outside the counted
    runs.  Returns the worst |diff| by plane and what was compared."""
    import dataclasses
    import torch
    from repro_torch.bench import kernels as kbench
    from repro_torch.bench import storage as sbench
    from repro_torch.store.reader import TrackStore

    worst, archives, calls = {}, 0, 0
    card, cpu = torch.device("cuda"), torch.device("cpu")
    for sc in kbench.kernel_scenarios():
        for spec in (sc.run, sc.baseline):
            one = dataclasses.replace(spec, repeats=1)
            got = kbench._execute(one, card)["outputs"]
            want = kbench._execute(one, cpu)["outputs"]
            card_vs_cpu(((f"{spec.pipeline} archive {i}", g, w) for i, (g, w)
                         in enumerate(zip(got, want, strict=True))),
                        f"kernels {sc.name}", worst)
            archives += len(want)
    for sc in sbench.storage_scenarios():
        for spec in (sc.run, sc.baseline):
            if spec is None or spec.consume != "pipeline":
                continue
            fx = sbench._fixture(spec)
            if spec.source == "zip":
                work = [[(obs, segs)] for _tid, obs, segs
                        in sbench._feed_zip(fx, cold=False) if segs]
            else:
                work = [[it for it in b.items if it[1]] for b in
                        TrackStore(fx["store_root"]).iter_batches(prefetch=0)]
            on_card = sbench._consumer(spec, card)
            on_cpu = sbench._consumer(spec, cpu)
            for j, items in enumerate(w for w in work if w):
                card_vs_cpu(((f"{spec.source} call {j} track {i}", g, w)
                             for i, (g, w) in enumerate(zip(
                                 on_card._process_many(items),
                                 on_cpu._process_many(items), strict=True))),
                            f"storage {sc.name}", worst)
                calls += 1
    return {"worst": worst, "kernels_archives": archives,
            "storage_calls": calls}


def phase_bench() -> dict:
    """The bench matrices of repro_torch.bench: the campaign's quick tier
    (sim and threads), the kernels, storage and encounters matrices at
    their full tier on the card with the launch counters zeroed just
    before each and read just after, and the scheduling quick tier; then
    the quick cells of kernels and encounters again on the CPU."""
    import torch
    from repro_torch.bench import all_scenarios, schema
    from repro_torch.bench import encounters as ebench
    from repro_torch.bench import engine
    from repro_torch.bench import kernels as kbench
    from repro_torch.bench import scheduling as pbench
    from repro_torch.bench import storage as sbench
    from repro_torch.kernels import agl_lookup, dynamic_rates
    from repro_torch.kernels import encounter_screen, track_interp

    out_dir = os.path.join(WORK, "bench")
    os.makedirs(out_dir, exist_ok=True)
    mods = {"track_interp": track_interp, "agl_lookup": agl_lookup,
            "dynamic_rates": dynamic_rates,
            "encounter_screen": encounter_screen}
    matrices = (
        ("campaign", lambda: engine.run_campaign(
            all_scenarios(), quick=True, device="cuda"),
         schema.validate_campaign, engine.summary_lines),
        ("kernels", lambda: kbench.run_kernel_campaign(device="cuda"),
         schema.validate_kernels, kbench.kernel_summary_lines),
        ("storage", lambda: sbench.run_storage_campaign(device="cuda"),
         schema.validate_storage, sbench.storage_summary_lines),
        ("encounters", lambda: ebench.run_encounter_campaign(device="cuda"),
         schema.validate_encounters, ebench.encounter_summary_lines),
        ("scheduling", lambda: pbench.run_scheduling_campaign(
            quick=True, device="cuda"),
         schema.validate_scheduling, pbench.scheduling_summary_lines),
    )
    t_phase = time.perf_counter()
    docs, walls, launches, shapes, speed = {}, {}, {}, {}, []
    for kind, run, validate, summary in matrices:
        zero_counters(mods)
        encounter_screen.launches_by_shape.clear()
        t0 = time.perf_counter()
        doc = run()
        torch.cuda.synchronize()
        walls[kind] = time.perf_counter() - t0
        counted = {name: mod.launches for name, mod in mods.items()}
        problems = validate(doc)
        if problems:
            raise AssertionError(f"{kind} artifact invalid: {problems[:5]}")
        docs[kind] = doc
        path = os.path.join(out_dir, f"BENCH_{kind}.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        for line in summary(doc):
            say("bench", line)
        label = ("virtual seconds of the cost model; threads smoke on the "
                 "host" if kind == "campaign" else "on the card"
                 if kind in BENCH_CARD_KERNELS else "host work")
        say("bench", f"{kind}: wall {walls[kind]:.3f}s ({label}); "
                     f"environment {doc['environment']}; wrote {path}")
        speed += bench_checks(kind, doc)
        if kind in BENCH_CARD_KERNELS:
            launches[kind] = counted
            say("bench", f"{kind}: launches {counted}")
            if any(counted[name] < 1 for name in BENCH_CARD_KERNELS[kind]):
                raise AssertionError(f"the {kind} matrix bypassed a kernel: "
                                     f"{counted}")
            if kind in ("kernels", "storage"):
                shapes[f"{kind} matrix"] = snapshot_shapes(mods)
                say_shapes("bench", shapes[f"{kind} matrix"], counted)
            else:
                by = sorted(encounter_screen.launches_by_shape.items(),
                            key=lambda kv: (-kv[1], kv[0]))
                say("bench", "encounter_screen launches by shape (K, T): "
                    + ", ".join(f"{k}: {n}" for k, n in by[:SHAPES_PRINTED])
                    + (f", and {len(by) - SHAPES_PRINTED} more shapes"
                       if len(by) > SHAPES_PRINTED else ""))
                if sum(n for _, n in by) != counted["encounter_screen"]:
                    raise AssertionError("encounter_screen launches_by_shape "
                                         "does not sum to its launches")
        elif any(counted.values()):
            raise AssertionError(f"the {kind} matrix launched kernels: "
                                 f"{counted}")
    for line in speed:
        say("bench", f"speed check {line}")
    say("bench", f"kernels {BENCH_DIFF} on the card (limit "
                 f"{BENCH_DIFF_TOL}): " + ", ".join(
                     f"{r['name']} {r['metrics'][BENCH_DIFF]}"
                     for r in docs["kernels"]["scenarios"]))
    profile_kernel_cell(next(r for r in docs["kernels"]["scenarios"]
                             if r["tier"] == "quick"))

    # Outside the counted runs: the kernels' outputs on the matrices'
    # own items against the CPU's plain versions, then the quick cells
    # again on the CPU.
    t0 = time.perf_counter()
    vs = bench_outputs_vs_cpu()
    walls["card vs CPU outputs"] = time.perf_counter() - t0
    say("bench", f"card vs CPU outputs: {vs['kernels_archives']} archives "
                 f"of the kernels matrix (every cell, fused and unfused), "
                 f"{vs['storage_calls']} pipeline calls of the storage "
                 f"matrix's pipeline cells; max |card - CPU| per plane "
                 f"(limit {CARD_ATOL} + {CARD_RTOL} |CPU|, headings "
                 f"wrapped): " + ", ".join(
                     f"{k} {v:.3g}" for k, v in vs["worst"].items()))
    t0 = time.perf_counter()
    cpu = {"kernels": kbench.run_kernel_campaign(quick=True, device="cpu"),
           "encounters": ebench.run_encounter_campaign(quick=True,
                                                       device="cpu")}
    walls["cpu quick cells"] = time.perf_counter() - t0
    for kind, doc in cpu.items():
        bench_checks(kind, doc)
        n = bench_same_as_cpu(kind, docs[kind], doc)
        diffs = [(r["name"], r["metrics"][BENCH_DIFF])
                 for r in doc["scenarios"] if BENCH_DIFF in r["metrics"]]
        say("bench", f"{kind}: {n} quick cells, card metrics equal to the "
                     f"CPU run's" + (f"; CPU {BENCH_DIFF} {diffs}"
                                     if diffs else ""))
    total = time.perf_counter() - t_phase
    say("bench", "wall s " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in walls.items())
        + f"; phase 8 in {total:.3f}s")
    headline = {}
    for kind, metric in (("kernels", "speedup_x"),
                         ("storage", "feed_speedup_x"),
                         ("encounters", "kernel_speedup_x")):
        headline[kind] = {r["name"]: r["measured"][metric]
                          for r in docs[kind]["scenarios"]
                          if metric in r["measured"]}
        say("bench", f"{kind} {metric}: {headline[kind]}")
    return {"launches": launches, "shapes": shapes, "walls": walls,
            "total_s": total, "headline": headline}


# Phase 9: the serving mode at a real size.  run_serve's summary on this
# feed, from a run of the reference (threads, 8 workers, same seed).
SERVE_BIG = dict(n_files=2048, obs_per_file=256, target_points=2048,
                 feed_batch=32, backend="threads", n_workers=8)
SERVE_BIG_WANT = {"files_ingested": 2048, "points_ingested": 394124,
                  "retained_tracks": 2048, "nearest_track": "f01633.csv"}
SERVE_SMALL = dict(n_files=64, obs_per_file=256, target_points=2048,
                   feed_batch=32, n_workers=2)


def serving_bench(card: str) -> dict:
    """The serving matrix, not cut: every deterministic check must pass;
    the host-timing gates are printed pass or fail."""
    from repro_torch.bench import schema
    from repro_torch.bench import serving as vbench

    t0 = time.perf_counter()
    doc = vbench.run_serving_campaign()
    wall = time.perf_counter() - t0
    problems = schema.validate_serving(doc)
    if problems:
        raise AssertionError(f"serving artifact invalid: {problems[:5]}")
    out_dir = os.path.join(WORK, "bench")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "BENCH_serving.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    for line in vbench.serving_summary_lines(doc):
        say("serving", line)
    if [r["name"] for r in doc["scenarios"]] != [
            s.name for s in vbench.serving_scenarios()]:
        raise AssertionError("the serving matrix did not run every cell")
    for rec in doc["scenarios"]:
        if rec["status"] == "error":
            raise AssertionError(f"serving {rec['name']}: {rec['error']}")
        m, x = rec["metrics"], rec["measured"]
        if m["snapshot_identical"] != 1.0:
            raise AssertionError(f"serving {rec['name']}: live store is "
                                 f"not the batch build")
        if rec["spec"]["run"]["mode"] == "inline" and not \
                m["ingest_lag_max_points"] <= rec["spec"]["run"][
                    "target_points"]:
            raise AssertionError(f"serving {rec['name']}: ingest lag "
                                 f"{m['ingest_lag_max_points']} past the "
                                 f"shard target")
        say("serving", f"{rec['name']} (host times on the chip machine, "
                       f"{card}): tiny p50/p99 idle "
                       f"{x['tiny_p50_ms_idle']:.4f}/"
                       f"{x['tiny_p99_ms_idle']:.4f} ms, under ingest "
                       f"{x['tiny_p50_ms_ingest']:.4f}/"
                       f"{x['tiny_p99_ms_ingest']:.4f} ms; ingest "
                       f"{x['ingest_points_per_s']:.1f} points/s; snapshot "
                       f"read {x['snapshot_read_s']:.4f} s; p99 ratio "
                       f"{x['tiny_p99_ratio']:.4f}; shards "
                       f"{m['shards_committed']}, points "
                       f"{m['points_ingested']}")
        # The host-timing gates the matrix declares (the inline cells'
        # tiny-query p99 ratio), printed pass or fail, not raised.
        for c in rec["checks"]:
            if c["metric"] in x:
                say("serving", f"speed check {rec['name']}: {c['metric']} "
                               f"= {c['actual']} vs {c['kind']} "
                               f"{c['expect']}: "
                               f"{'pass' if c['passed'] else 'FAIL'}")
    say("serving", f"serving matrix: {len(doc['scenarios'])} cells in "
                   f"{wall:.3f}s (host work); wrote {path}")
    return doc


def serve_at(root: str, **kw) -> tuple[dict, float]:
    from repro_torch.tracks.workflow import run_serve
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    summary = run_serve(root, **kw)
    return summary, time.perf_counter() - t0


def same_outputs(got: dict, want: dict, what: str) -> int:
    """Segment outputs of two process_batch runs, bitwise: the same task
    ids and tracks, names, airspace, counts and every plane."""
    import numpy as np
    if list(got) != list(want):
        raise AssertionError(f"{what}: task ids differ")
    n = 0
    for task_id, by_track in want.items():
        if list(got[task_id]) != list(by_track):
            raise AssertionError(f"{what} {task_id}: tracks differ")
        for tid, w in by_track.items():
            g = got[task_id][tid]
            if g.icao24 != w.icao24 or g.airspace != w.airspace or \
                    not np.array_equal(g.count, w.count):
                raise AssertionError(f"{what} {tid}: names/airspace/counts "
                                     f"differ")
            for attr in PLANES:
                a, b = getattr(g, attr), getattr(w, attr)
                if a.shape != b.shape or a.tobytes() != b.tobytes():
                    raise AssertionError(f"{what} {tid} {attr}: not "
                                         f"bitwise equal")
            n += 1
    return n


def phase_serving(card: str, globe_dem) -> dict:
    """The serving mode on the chip machine: the serving matrix; run_serve
    at 2048 files, its summary against the reference's and its sealed
    live store against a batch build, byte for byte; a small processes
    serve against a threads serve; then the live store processed on the
    card with the process kernels' counters zeroed just before and read
    just after, bitwise against the batch store's outputs and within
    1e-4 + 1e-6 |CPU| of the CPU's plain versions."""
    import torch
    from repro_torch.geometry.aerodromes import synthetic_aerodromes
    from repro_torch.kernels import agl_lookup, dynamic_rates, track_interp
    from repro_torch.runtime.transports import _default_start_method
    from repro_torch.store.writer import build_store
    from repro_torch.tracks.segments import (
        SegmentProcessor, segment_tasks_from_store)

    t_phase = time.perf_counter()
    serving_bench(card)

    # run_serve at a real size, then a batch build of the same feed.
    root = os.path.join(WORK, "serve")
    summary, wall = serve_at(root, **SERVE_BIG)
    got = {k: summary[k] for k in SERVE_BIG_WANT}
    if got != SERVE_BIG_WANT or summary["snapshot"]["n_tracks"] != \
            SERVE_BIG_WANT["retained_tracks"]:
        raise AssertionError(f"run_serve summary {summary} is not the "
                             f"reference's {SERVE_BIG_WANT}")
    live, batch = os.path.join(root, "store_live"), os.path.join(root,
                                                                 "store_batch")
    t0 = time.perf_counter()
    build_store(os.path.join(root, "feed"), batch,
                target_points=SERVE_BIG["target_points"])
    build_s = time.perf_counter() - t0
    live_tree, batch_tree = tree_bytes(live), tree_bytes(batch)
    if live_tree != batch_tree:
        raise AssertionError("the sealed live store is not the batch "
                             "build's bytes")
    say("serving", f"run_serve {SERVE_BIG}: {summary['files_ingested']} "
                   f"files, {summary['shards_committed']} shards, "
                   f"{summary['points_ingested']} points, generation "
                   f"{summary['generation']}, {summary['retained_tracks']} "
                   f"tracks retained, nearest {summary['nearest_track']}, "
                   f"snapshot {summary['snapshot']['n_tracks']} tracks; "
                   f"job_seconds {summary['job_seconds']:.3f} s, wall "
                   f"{wall:.3f} s (host times on the chip machine, {card}); "
                   f"live store == batch build ({len(live_tree)} files, "
                   f"batch build {build_s:.3f} s)")

    # A small serve on processes workers (ShardBuilder crosses spawn: the
    # parent has initialised CUDA) against the same serve on threads, at
    # one root (the manifest records the feed root).
    small_root = os.path.join(WORK, "serve_small")
    small, s_wall = serve_at(small_root, backend="threads", **SERVE_SMALL)
    want_tree = tree_bytes(os.path.join(small_root, "store_live"))
    procs, p_wall = serve_at(small_root, backend="processes", **SERVE_SMALL)
    if tree_bytes(os.path.join(small_root, "store_live")) != want_tree:
        raise AssertionError("processes serve's store differs from the "
                             "threads serve's")
    small.pop("job_seconds")
    procs.pop("job_seconds")
    if procs != small:
        raise AssertionError(f"processes serve {procs} != threads {small}")
    say("serving", f"small serve ({SERVE_SMALL['n_files']} files, 2 "
                   f"processes workers, started by "
                   f"{_default_start_method()}): processes store == "
                   f"threads store "
                   f"({small['shards_committed']} shards); wall threads "
                   f"{s_wall:.3f} s, processes {p_wall:.3f} s")

    # The live store on the card.
    aero = synthetic_aerodromes(n=64)
    gpu = SegmentProcessor(dem=globe_dem, aerodromes=aero, device="cuda")
    cpu = SegmentProcessor(dem=globe_dem, aerodromes=aero, device="cpu")
    live_tasks = segment_tasks_from_store(live, granularity="shard")
    batch_tasks = segment_tasks_from_store(batch, granularity="shard")
    gpu.process_batch(batch_tasks[:1])          # DEM upload, warm-up
    mods = {"track_interp": track_interp, "agl_lookup": agl_lookup,
            "dynamic_rates": dynamic_rates}
    zero_counters(mods)
    t0 = time.perf_counter()
    on_card = gpu.process_batch(live_tasks)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in mods.items()}
    shapes = snapshot_shapes(mods)
    stats = dict(gpu.last_stats)
    if min(launches.values()) < 1:
        raise AssertionError(f"the live store bypassed a kernel: {launches}")
    say_shapes("serving", shapes, launches)
    n_tracks = same_outputs(gpu.process_batch(batch_tasks), on_card,
                            "live vs batch store on the card")
    t0 = time.perf_counter()
    on_cpu = cpu.process_batch(live_tasks)
    cpu_s = time.perf_counter() - t0
    worst = card_vs_cpu(((tid, on_card[task][tid], w)
                         for task, by in on_cpu.items()
                         for tid, w in by.items()), "live store")
    say("serving", f"live store on the card: {len(live_tasks)} shard "
                   f"tasks, {n_tracks} tracks, {stats['n_segments']} "
                   f"segments, {stats['pipeline_calls']} pipeline calls; "
                   f"launches {launches}; card {card_s:.3f} s, CPU plain "
                   f"{cpu_s:.3f} s ({card}); bitwise equal to the batch "
                   f"store's outputs; max |card - CPU| per plane (limit "
                   f"{CARD_ATOL} + {CARD_RTOL} |CPU|, headings wrapped): "
                   + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gpu.process_batch(live_tasks)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    busy = _device_busy(prof)
    busy_ms = sum(busy.values())
    if busy_ms > 0:
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:4]
        say("serving", f"profiled live-store pass {prof_s * 1e3:.1f} ms "
                       f"wall, device busy {busy_ms:.3f} ms (idle share "
                       f"{1 - busy_ms / (prof_s * 1e3):.4f}; {card}); top: "
                       + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in top))
    else:
        say("serving", "profiler saw no device time: idle share not "
                       "measured")
    total = time.perf_counter() - t_phase
    say("serving", f"phase 9 in {total:.3f}s")
    return {"launches": launches, "shapes": shapes, "total_s": total}


def rel_diff(a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / (b.float().abs().max() + 1e-6)).item()


def serve_and_profile(tag: str, cfg, params, rng, n_requests: int,
                      n_rounds: int) -> dict:
    """BatchedServer (``SERVE``'s slots and lengths) on the card: one
    warm-up request, then ``n_rounds`` gated rounds of ``n_requests``
    seeded requests of ``SERVE_NEW`` new tokens, each timed on its own,
    then one engine step under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import BatchedServer, Request

    class TimedServer(BatchedServer):
        """Times each admit (prefill) and engine step; both end in a host
        read of the argmax, so the host clock sees the device finish."""
        def admit(self, req):
            t0 = time.perf_counter()
            ok = super().admit(req)
            if ok:
                self.admit_s.append(time.perf_counter() - t0)
            return ok

        def step(self):
            t0 = time.perf_counter()
            super().step()
            self.step_s.append(time.perf_counter() - t0)

    server = TimedServer(cfg, params, device=torch.device("cuda"), **SERVE)
    ids = iter(range(1 + n_requests * n_rounds))

    def requests(n):
        out = []
        for _ in range(n):
            P = int(rng.integers(16, SERVE["prompt_len"] + 1))
            out.append(Request(next(ids), rng.integers(0, cfg.vocab_size, P),
                               max_new_tokens=SERVE_NEW))
        return out

    # One request outside the timed rounds: the first prefill and decode
    # at these shapes choose their cuBLAS algorithms and grow the cache
    # allocator.
    server.admit_s, server.step_s = [], []
    server.serve(requests(1))
    rounds = []
    for _ in range(n_rounds):
        server.admit_s, server.step_s = [], []
        steps0 = server.steps
        reqs = requests(n_requests)
        t0 = time.perf_counter()
        server.serve(reqs)
        serve_s = time.perf_counter() - t0
        if not all(r.done and len(r.tokens_out) == SERVE_NEW for r in reqs):
            raise AssertionError(f"requests unfinished: "
                                 f"{[len(r.tokens_out) for r in reqs]}")
        if not all(0 <= t < cfg.vocab_size
                   for r in reqs for t in r.tokens_out):
            raise AssertionError("a token outside the vocabulary")
        n_out = sum(len(r.tokens_out) for r in reqs)
        rounds.append({"tokens_per_s": n_out / serve_s,
                       "step_ms": statistics.median(server.step_s) * 1e3,
                       "admit_ms": statistics.median(server.admit_s) * 1e3})
        say(tag, f"BatchedServer {SERVE}, round {len(rounds)}: "
                 f"{len(reqs)} requests, {n_out} tokens in {serve_s:.3f}s "
                 f"({rounds[-1]['tokens_per_s']:.1f} tokens/s), "
                 f"{server.steps - steps0} engine steps, decode step "
                 f"{rounds[-1]['step_ms']:.1f} ms (median; first "
                 f"{server.step_s[0] * 1e3:.1f} ms), admit (prefill of "
                 f"one prompt + splice) {rounds[-1]['admit_ms']:.1f} ms "
                 f"(median)")
    step_ms = [r["step_ms"] for r in rounds]
    say(tag, f"decode step over {n_rounds} rounds: median "
             f"{statistics.median(step_ms):.1f} ms, spread (max - min) / "
             f"min {(max(step_ms) - min(step_ms)) / min(step_ms):.3f}")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.step()
        step_prof_s = time.perf_counter() - t0
    busy = _device_busy(prof)
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    busy_ms = sum(busy.values())
    say(tag, f"profiled decode step {step_prof_s * 1e3:.1f} ms wall, "
             f"device busy {busy_ms:.1f} ms (idle share "
             f"{1 - busy_ms / (step_prof_s * 1e3):.4f}); top: " + "; ".join(
                 f"{k[:48]} {v:.1f} ms" for k, v in top))
    return {"rounds": rounds, "step_ms": statistics.median(step_ms),
            "step_busy_ms": busy_ms,
            "tokens_per_s": statistics.median(r["tokens_per_s"]
                                              for r in rounds)}


def phase_lm() -> dict:
    """stablelm-12b at full width and depth on the card, through the
    port's forward, prefill/decode_step and BatchedServer."""
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.models import model as M

    dev = torch.device("cuda")
    cfg = get_arch(LM_ARCH)
    cfg_flash = dataclasses.replace(cfg, attention_impl="flash")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    say("lm", f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads (kv {cfg.n_kv_heads}, hd "
              f"{cfg.head_dim_}), d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: "
              f"{n_params} parameters, {n_bytes / 1e9:.2f} GB on the card, "
              f"drawn in {time.perf_counter() - t0:.2f}s")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_B, LM_T))
                            .astype(np.int32)).to(dev)
    n_tok = LM_B * LM_T

    def timed_forward(c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = M.forward(c, params, {"tokens": toks})
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, warm_s = timed_forward(cfg)              # cuBLAS and allocator warm-up
    del _
    torch.cuda.reset_peak_memory_stats()
    flash_mod.launches = 0
    for r in flash_mod.launches_by_route:
        flash_mod.launches_by_route[r] = 0
    lf, flash_s = timed_forward(cfg_flash)
    launches = flash_mod.launches
    by_route = dict(flash_mod.launches_by_route)
    peak_flash = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lx, xla_s = timed_forward(cfg)
    peak_xla = torch.cuda.max_memory_allocated()
    rel = rel_diff(lf, lx)
    finite = bool(torch.isfinite(lf).all() and torch.isfinite(lx).all())
    say("lm", f"forward B={LM_B} T={LM_T}: flash {flash_s:.3f}s "
              f"({n_tok / flash_s:.1f} tokens/s, peak "
              f"{peak_flash / 1e9:.2f} GB), xla {xla_s:.3f}s "
              f"({n_tok / xla_s:.1f} tokens/s, peak {peak_xla / 1e9:.2f} "
              f"GB), first (xla, warm-up) {warm_s:.3f}s; flash launches "
              f"{launches} by route {by_route}; max|flash - xla| / max|xla| "
              f"{rel:.3g} (gate {LM_REL_GATE}); finite {finite}")
    if launches != cfg.n_layers or by_route != {"sm90": cfg.n_layers,
                                                "cuda_core": 0}:
        raise AssertionError(f"flash forward launched the kernel {launches} "
                             f"times ({by_route}), expected "
                             f"{cfg.n_layers}, all on the sm90 route")
    if not finite or tuple(lf.shape) != (LM_B, LM_T, cfg.vocab_size):
        raise AssertionError(f"forward logits: shape {tuple(lf.shape)}, "
                             f"finite {finite}")
    if rel >= LM_REL_GATE:
        raise AssertionError(f"flash and xla logits differ: rel {rel}")
    del lf, lx

    # Where a flash forward's device time goes, by kernel.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        M.forward(cfg_flash, params, {"tokens": toks})
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    busy = _device_busy(prof)
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
    busy_ms = sum(busy.values())
    flash_ms = sum(v for k, v in busy.items() if "flash_attention" in k)
    flash_share = flash_ms / busy_ms
    say("lm", f"profiled flash forward {prof_s * 1e3:.1f} ms wall, device "
              f"busy {busy_ms:.1f} ms (idle share "
              f"{1 - busy_ms / (prof_s * 1e3):.4f}); flash kernel "
              f"{flash_ms:.1f} ms ({flash_share:.4f} of device "
              f"time); top: " + "; ".join(
                  f"{k[:48]} {v:.1f} ms" for k, v in top))

    # prefill(T) + decode_step against forward(T + 1).
    ptoks = toks[:, :LM_DECODE_T + 1]
    _, cache = M.prefill(cfg, params, {"tokens": ptoks[:, :LM_DECODE_T]},
                         cache_len=LM_DECODE_T + 4)
    dec, _ = M.decode_step(cfg, params, cache,
                           {"tokens": ptoks[:, LM_DECODE_T:]})
    full = M.forward(cfg, params, {"tokens": ptoks})
    rel_dec = rel_diff(dec[:, 0], full[:, LM_DECODE_T])
    say("lm", f"prefill({LM_DECODE_T}) + decode_step vs forward("
              f"{LM_DECODE_T + 1}): rel {rel_dec:.3g} (gate {LM_DECODE_GATE})")
    if not rel_dec < LM_DECODE_GATE:
        raise AssertionError(f"decode disagrees with forward: rel {rel_dec}")
    del cache, dec, full

    serve_and_profile("lm", cfg, params, rng, SERVE_REQUESTS, SERVE_ROUNDS)
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_by_route": by_route,
            "forward_tokens_per_s": n_tok / flash_s,
            "forward_flash_share": flash_share}


def layerwise_flash_vs_xla(cfg, params, batch) -> tuple[float, int]:
    """Each attention sublayer of an xla forward, fed the xla forward's
    own input to it, against the flash kernel on that same input: the
    worst max|flash - xla| / max|xla| over the layers, and how many
    layers were held.  Unlike the logits, this does not pass through
    the MoE routers, which turn a rounding difference in one layer into
    another expert choice in the next."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    x = M.encode_inputs(cfg, params, batch)
    worst, n = 0.0, 0
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
              head_dim=cfg.head_dim_, theta=cfg.rope_theta,
              window=cfg.sliding_window)
    for sb in range(cfg.n_superblocks):
        block = M._index(params["blocks"], sb)
        for i, kind in enumerate(cfg.block_pattern):
            p = block[f"s{i}"]
            if kind == "attn":
                h = L.rms_norm(x, p["norm1"], cfg.rms_eps)
                want = L.attention_train(h, p["mixer"], impl="xla", **kw)
                got = L.attention_train(h, p["mixer"], impl="flash", **kw)
                worst, n = max(worst, rel_diff(got, want)), n + 1
                del h, want, got
            x = M._apply_sublayer(
                cfg, kind, cfg.is_moe_layer(sb * cfg.pattern_period + i), p,
                x)
    return worst, n


def layerwise_bf16_vs_f32(cfg, params, batch) -> dict:
    """Each MoE feed-forward, Mamba mixer and RWKV-6 time and channel mix
    of a bf16 forward (xla attention), fed that forward's own input to
    it, against the same function in f32 on the same input and on the
    bf16 weights widened to f32: {kind: (worst max|bf16 - f32| /
    max|f32|, sublayers held)}.  The router's weights are f32 and its
    input the same values in both, so no route flips, and one layer's
    rounding does not pass on to the next."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import ssm as S

    worst: dict = {}

    def held(what, fn, h, p):
        got = fn(h, p)
        p32 = _widened(p)
        rel = rel_diff(got, fn(h.float(), p32))
        del p32
        w, n = worst.get(what, (0.0, 0))
        worst[what] = (max(w, rel), n + 1)
        return got

    x = M.encode_inputs(cfg, params, batch)
    for sb in range(cfg.n_superblocks):
        block = M._index(params["blocks"], sb)
        for i, kind in enumerate(cfg.block_pattern):
            p = block[f"s{i}"]
            is_moe = cfg.is_moe_layer(sb * cfg.pattern_period + i)
            h = L.rms_norm(x, p["norm1"], cfg.rms_eps)
            if kind == "mamba":
                mix = held("mamba", lambda a, q: S.mamba_train(
                    a, q, d_state=cfg.d_state), h, p["mixer"])
            elif kind == "rwkv6":
                mix = held("rwkv6 time mix", lambda a, q: S.rwkv6_time_mix(
                    a, q, head_dim=cfg.rwkv_head_dim), h, p["mixer"])
            else:
                mix = L.attention_train(
                    h, p["mixer"], n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                    head_dim=cfg.head_dim_, theta=cfg.rope_theta,
                    window=cfg.sliding_window, impl="xla")
            h = L.rms_norm(x + mix, p["norm2"], cfg.rms_eps)
            if kind == "rwkv6":
                held("rwkv6 channel mix", S.rwkv6_channel_mix, h, p["ffn"])
            elif is_moe:
                held("moe", lambda a, q: M._moe(cfg, q, a), h, p["ffn"])
            del h, mix
            x = M._apply_sublayer(cfg, kind, is_moe, p, x)
    return worst


def decode_vs_forward(cfg, params, head: dict) -> tuple:
    """prefill(T) + decode_step against forward(T + 1)'s last logits,
    ``head`` holding the T + 1 inputs: (rel, the decode's logits, the
    forward's logits at T), the logits in f32."""
    from repro_torch.models import model as M
    T = LM_DECODE_T
    _, cache = M.prefill(cfg, params, {k: v[:, :T] for k, v in head.items()},
                         cache_len=T + 4)
    dec, _ = M.decode_step(cfg, params, cache,
                           {k: v[:, T:] for k, v in head.items()})
    dec = dec[:, 0].float()
    full = M.forward(cfg, params, head)[:, T].float()
    return rel_diff(dec, full), dec, full


def phase_lm_arms() -> dict:
    """qwen3-moe, rwkv6, jamba (depth cut) and musicgen (embeds input) at
    full width on the card, one model at a time (``LM_ARMS``): forward
    flash vs xla with the flash counters zeroed just before and read
    just after (one sm90 launch per attention layer), each attention
    layer's flash output against xla's on the same input, each MoE,
    Mamba and RWKV-6 sublayer in bf16 against f32 on the same input and
    weights, prefill + decode_step against forward (in bf16 where
    ``bf16_gates``, and in f32 at full width), BatchedServer rounds
    where the reference serves the config, and where the device time
    goes.  Every gate of every model is checked; the phase fails at its
    end if any did not hold."""
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.models import model as M

    dev = torch.device("cuda")
    failures, res = [], {}

    def gate(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)
            say("arms", f"GATE FAILED: {what}")

    def params_on_card(cfg):
        t0 = time.perf_counter()
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dev)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in _leaves(params))
        gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
        return params, n, gb, time.perf_counter() - t0

    for arm in LM_ARMS:
        name, B, cf = arm["arch"], arm["B"], arm["cf"]
        t_model = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = dataclasses.replace(get_arch(name), **arm["cut"])
        cfg_flash = dataclasses.replace(cfg, attention_impl="flash")
        n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
        kinds = {k: sum(cfg.layer_kind(i) == k for i in range(cfg.n_layers))
                 for k in dict.fromkeys(cfg.block_pattern)}
        n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers)
                    if cfg.layer_kind(i) != "rwkv6")
        params, n_params, gb, init_s = params_on_card(cfg)
        cut = (f" (cut from {get_arch(name).n_layers} layers)"
               if arm["cut"] else "")
        say("arms", f"{name}: {cfg.n_layers} layers{cut} {kinds}, {n_moe} "
                    f"MoE ({cfg.n_experts} experts, top {cfg.top_k}), "
                    f"d_model {cfg.d_model}, heads {cfg.n_heads} (kv "
                    f"{cfg.n_kv_heads}, hd {cfg.head_dim_}), d_ff "
                    f"{cfg.d_ff}, vocab {cfg.vocab_size}, input "
                    f"{'embeds' if cfg.frontend else 'tokens'}: {n_params} "
                    f"parameters, {gb:.2f} GB on the card, drawn in "
                    f"{init_s:.2f}s")
        rng = np.random.default_rng(0)
        if cfg.frontend is not None:
            gen = torch.Generator(device=dev).manual_seed(1)
            batch = {"embeds": torch.randn(
                (B, LM_T, cfg.d_model), generator=gen, device=dev).to(
                    getattr(torch, cfg.activation_dtype))}
        else:
            batch = {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, LM_T)).astype(np.int32)).to(dev)}
        head = {k: v[:, :LM_DECODE_T + 1] for k, v in batch.items()}
        n_tok = B * LM_T

        def timed_forward(c):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = M.forward(c, params, batch)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        _, warm_s = timed_forward(cfg)          # cuBLAS and allocator warm-up
        del _
        torch.cuda.reset_peak_memory_stats()
        flash_mod.launches = 0
        for r in flash_mod.launches_by_route:
            flash_mod.launches_by_route[r] = 0
        lf, flash_s = timed_forward(cfg_flash)
        launches = flash_mod.launches
        by_route = dict(flash_mod.launches_by_route)
        peak_flash = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        lx, xla_s = timed_forward(cfg)
        peak_xla = torch.cuda.max_memory_allocated()
        rel = rel_diff(lf, lx)
        finite = bool(torch.isfinite(lf).all() and torch.isfinite(lx).all())
        # Token rows whose own max|flash - xla| reaches the gate's share
        # of max|xla|: a routing flip moves some rows, a wrong kernel all.
        row_rel = ((lf.float() - lx.float()).abs().amax(dim=-1)
                   / (lx.float().abs().max() + 1e-6))
        rows_out = (row_rel >= LM_REL_GATE).float().mean().item()
        shape = tuple(lf.shape)
        del lf, lx, row_rel
        say("arms", f"{name} forward B={B} T={LM_T}: flash {flash_s:.3f}s "
                    f"({n_tok / flash_s:.1f} tokens/s, peak "
                    f"{peak_flash / 1e9:.2f} GB), xla {xla_s:.3f}s "
                    f"({n_tok / xla_s:.1f} tokens/s, peak "
                    f"{peak_xla / 1e9:.2f} GB), first (xla, warm-up) "
                    f"{warm_s:.3f}s; flash launches {launches} by route "
                    f"{by_route}; max|flash - xla| / max|xla| {rel:.3g} "
                    f"({'gate ' + str(LM_REL_GATE) if arm['bf16_gates'] else 'not gated: bf16 routing/drift'}; "
                    f"token rows at or past {LM_REL_GATE}: {rows_out:.5f}); "
                    f"finite {finite}")
        gate(launches == n_attn and by_route == {"sm90": n_attn,
                                                 "cuda_core": 0},
             f"{name}: flash forward launched the kernel {launches} times "
             f"({by_route}), expected {n_attn}, all on the sm90 route")
        gate(finite and shape == (B, LM_T, cfg.vocab_size),
             f"{name}: forward logits shape {shape}, finite {finite}")
        if arm["bf16_gates"]:
            gate(rel < LM_REL_GATE, f"{name}: flash and xla logits differ: "
                                    f"rel {rel}")
        layer_rel = None
        if n_attn:
            layer_rel, n_held = layerwise_flash_vs_xla(cfg, params, batch)
            say("arms", f"{name} attention layers fed the xla forward's "
                        f"input, flash vs xla: worst rel {layer_rel:.3g} "
                        f"over {n_held} layers (gate {LM_REL_GATE})")
            gate(n_held == n_attn and layer_rel < LM_REL_GATE,
                 f"{name}: an attention layer's flash and xla outputs "
                 f"differ: rel {layer_rel} over {n_held} layers")
        sub_rel = {}
        if n_moe or set(kinds) - {"attn"}:
            t0 = time.perf_counter()
            sub_rel = layerwise_bf16_vs_f32(cfg, params, batch)
            want = {"moe": n_moe, "mamba": kinds.get("mamba", 0),
                    "rwkv6 time mix": kinds.get("rwkv6", 0),
                    "rwkv6 channel mix": kinds.get("rwkv6", 0)}
            want = {k: n for k, n in want.items() if n}
            say("arms", f"{name} sublayers fed the bf16 forward's input, "
                        f"bf16 vs f32 on the same weights, worst rel over "
                        f"the layers: " + ", ".join(
                            f"{k} {w:.3g} ({n} layers, gate "
                            f"{SUBLAYER_BF16_GATE[k]})"
                            for k, (w, n) in sub_rel.items())
                        + f"; {time.perf_counter() - t0:.1f}s")
            gate({k: n for k, (_, n) in sub_rel.items()} == want
                 and all(w < SUBLAYER_BF16_GATE[k]
                         for k, (w, _) in sub_rel.items()),
                 f"{name}: a bf16 sublayer differs from f32: {sub_rel}, "
                 f"expected layers {want}")

        # Where a flash forward's device time goes: by kernel, by kind
        # of kernel, and (MoE; its ranges need the CPU side traced) by
        # stage of the layer.
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if n_moe
                                          else [])
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            M.forward(cfg_flash, params, batch)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
        busy = _device_busy(prof)
        busy_ms = sum(busy.values())
        split = _kernel_split(busy)
        stages = _stage_device_ms(prof) if n_moe else {}
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
        del prof
        say("arms", f"{name} profiled flash forward {prof_s * 1e3:.1f} ms "
                    f"wall ({'CPU and ' if n_moe else ''}CUDA traced), "
                    f"device busy {busy_ms:.1f} ms; by kind: " + ", ".join(
                        f"{k} {v:.1f} ms ({v / busy_ms:.4f})"
                        for k, v in split.items()))
        if stages:
            say("arms", f"{name} MoE stages ({n_moe} layers), device ms of "
                        f"the kernels each launched: " + ", ".join(
                            f"{k} {v:.1f}" for k, v in stages.items()))
        say("arms", f"{name} top kernels: " + "; ".join(
            f"{k[:64]} {v:.1f} ms" for k, v in top))

        c_dec = (dataclasses.replace(cfg, capacity_factor=cf) if cf
                 else cfg)
        rel_dec, dec16, full16 = decode_vs_forward(c_dec, params, head)
        say("arms", f"{name} prefill({LM_DECODE_T}) + decode_step vs "
                    f"forward({LM_DECODE_T + 1}), bf16, capacity_factor "
                    f"{c_dec.capacity_factor}: rel {rel_dec:.3g} "
                    f"({'gate ' + str(LM_DECODE_GATE) if arm['bf16_gates'] else 'not gated: bf16 routing/drift'})")
        if arm["bf16_gates"]:
            gate(rel_dec < LM_DECODE_GATE,
                 f"{name}: decode disagrees with forward: rel {rel_dec}")
        row = {"params": n_params, "gb": gb, "n_layers": cfg.n_layers,
               "launches": launches, "launches_by_route": by_route,
               "flash_xla_rel": rel, "flash_xla_rows_out": rows_out,
               "flash_xla_layer_rel": layer_rel, "decode_rel_bf16": rel_dec,
               "sublayer_bf16_f32_rel": {k: w for k, (w, _) in
                                         sub_rel.items()},
               "forward_tokens_per_s": n_tok / flash_s,
               "forward_xla_tokens_per_s": n_tok / xla_s,
               "peak_gb": peak_flash / 1e9, "forward_busy_ms": busy_ms,
               "forward_split_ms": split, "moe_stages_ms": stages}
        if arm["serve"]:
            row.update(serve_and_profile("arms", cfg, params, rng,
                                         ARMS_SERVE_REQUESTS,
                                         ARMS_SERVE_ROUNDS))
        else:
            # No server (the reference refuses frontends): decode steps
            # on a prefilled cache, timed one by one.
            _, cache = M.prefill(cfg, params, {k: v[:, :LM_DECODE_T]
                                               for k, v in head.items()},
                                 cache_len=LM_DECODE_T + 4)
            last = {k: v[:, LM_DECODE_T:] for k, v in head.items()}
            step_s = []
            for _ in range(ARMS_DECODE_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, cache = M.decode_step(cfg, params, cache, last)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
            row["step_ms"] = statistics.median(step_s) * 1e3
            say("arms", f"{name} decode step on {B} rows: median "
                        f"{row['step_ms']:.1f} ms over "
                        f"{ARMS_DECODE_STEPS} (first {step_s[0] * 1e3:.1f}"
                        f" ms)")
            del cache
        # prefill + decode against forward in f32 at full width, where
        # rounding cannot flip a route: on the bf16 weights widened where
        # the whole depth fits in f32, else on an f32 draw of
        # ``f32_layers`` layers.
        f32 = dict(param_dtype="float32", activation_dtype="float32")
        if arm["f32_layers"]:
            f32["n_layers"] = arm["f32_layers"]
        c32 = dataclasses.replace(c_dec, **f32)
        widened = not arm["f32_layers"]
        if widened:
            params = _widened(params)
            gb32 = sum(t.numel() * 4 for t in _leaves(params)) / 1e9
        del batch
        if not widened:
            del params
            torch.cuda.empty_cache()
            params, _, gb32, _ = params_on_card(c32)
        rel32, dec32, full32 = decode_vs_forward(c32, params, {
            k: v.float() if v.is_floating_point() else v
            for k, v in head.items()})
        say("arms", f"{name} in f32 ({c32.n_layers} layers, {gb32:.2f} GB"
                    f"{', the bf16 weights widened' if widened else ''}): "
                    f"prefill({LM_DECODE_T}) + decode_step vs forward("
                    f"{LM_DECODE_T + 1}), capacity_factor "
                    f"{c32.capacity_factor}: rel {rel32:.3g} (gate "
                    f"{LM_DECODE_GATE})")
        gate(rel32 < LM_DECODE_GATE,
             f"{name}: f32 decode disagrees with forward: rel {rel32}")
        row.update(decode_rel_f32=rel32, f32_layers=c32.n_layers)
        if widened:
            row.update(decode_bf16_vs_f32=rel_diff(dec16, dec32),
                       forward_bf16_vs_f32=rel_diff(full16, full32))
            say("arms", f"{name} each bf16 path against its f32 twin on the "
                        f"same weights, logits at position {LM_DECODE_T}: "
                        f"prefill + decode rel "
                        f"{row['decode_bf16_vs_f32']:.3g}, forward rel "
                        f"{row['forward_bf16_vs_f32']:.3g} (bf16 decode vs "
                        f"bf16 forward {rel_dec:.3g})")
            if not arm["bf16_gates"]:
                # Without the whole-model bf16 gate: the two bf16 paths
                # stay closer to each other than the bf16 forward is to
                # its f32 twin, the rounding of bf16 itself.
                gate(rel_dec <= row["forward_bf16_vs_f32"],
                     f"{name}: bf16 decode drifts from bf16 forward "
                     f"({rel_dec}) past the bf16 forward's distance from "
                     f"f32 ({row['forward_bf16_vs_f32']})")
        del params, head, dec16, full16, dec32, full32
        torch.cuda.empty_cache()
        res[name] = row
        say("arms", f"{name} done in {time.perf_counter() - t_model:.1f}s")
    if failures:
        raise AssertionError("phase 7b: " + "; ".join(failures))
    return res


def zipf_store(root: str, vocab: int, n_shards: int,
               tokens_per_shard_mean: int, seed: int = 0) -> list:
    """A token store of Zipf(1.5)-skewed ids below ``vocab`` (a learnable
    unigram signal; uniform ids leave nothing above ln V), written by
    the port's ``synthetic_token_shards`` (checksummed codec shards of
    heavy-tailed sizes, ``store_manifest.json``) and reopened from its
    manifest, as a launcher reopens a store."""
    import numpy as np
    from repro_torch.data.pipeline import (synthetic_token_shards,
                                           token_shard_manifests)

    def zipf(rng, n):
        return np.minimum(rng.zipf(1.5, size=n), vocab - 1)
    synthetic_token_shards(root, n_shards=n_shards, vocab_size=vocab,
                           tokens_per_shard_mean=tokens_per_shard_mean,
                           seed=seed, token_sampler=zipf)
    return token_shard_manifests(root)


def phase_train(device: str = "cuda") -> dict:
    """Training on the card (TRAIN_* above): (a) full-width minicpm-2b
    through SelfScheduledLoader and Trainer, with every kernel counter
    zeroed just before and read just after (training launches none of
    the five: the configs train through the 'xla' attention, as the
    reference must); (b) peak memory of one step without remat and under
    each policy; (c) the f32 variant of reduced minicpm-2b on the card
    against the CPU; (d) a checkpointed run resumed by a fresh Trainer
    against the uninterrupted run; (e) ``train_witness`` at full width.
    ``device`` is the card but for a dry run of the phase's code on the
    CPU."""
    import dataclasses
    import gc
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SelfScheduledLoader
    from repro_torch.kernels import (agl_lookup, dynamic_rates,
                                     encounter_screen, track_interp)
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    dev = torch.device(device)
    root = os.path.join(WORK, "train")
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    mods = {"track_interp": track_interp, "agl_lookup": agl_lookup,
            "dynamic_rates": dynamic_rates,
            "encounter_screen": encounter_screen}
    out: dict = {}

    # (a) full width
    cfg = get_arch(TRAIN_ARCH)
    # twice the tokens the steps take, over 8 shards of heavy-tailed size
    shards = zipf_store(os.path.join(root, "shards"), cfg.vocab_size,
                        n_shards=8, tokens_per_shard_mean=TRAIN_STEPS
                        * TRAIN_B * (TRAIN_T + 1) // 4)
    t0 = time.perf_counter()
    loader = SelfScheduledLoader(shards, batch_size=TRAIN_B,
                                 seq_len=TRAIN_T, n_ingest_workers=4)
    batches = list(loader.batches(TRAIN_STEPS))
    say("train", f"loader: {len(shards)} Zipf store shards "
                 f"({sorted((s.n_tokens for s in shards), reverse=True)} "
                 f"tokens) ingested "
                 f"largest-first by {loader.n_ingest_workers} threads in "
                 f"{time.perf_counter() - t0:.3f}s, "
                 f"{loader.job_result.messages_sent} messages, "
                 f"{len(batches)} batches of {TRAIN_B} x {TRAIN_T}")
    zero_counters(mods)
    flash_mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, O.OptimizerConfig(),
                 TrainerConfig(workdir=os.path.join(root, "full"),
                               total_steps=TRAIN_STEPS, ckpt_every=0,
                               warmup_steps=2, log_every=1,
                               peak_lr=TRAIN_PEAK_LR), device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(tr.params))
    state_gb = sum(t.numel() * t.element_size()
                   for t in O.tree_leaves({"p": tr.params,
                                           "o": tr.opt_state})) / 1e9
    say("train", f"{cfg.name} at full width: {cfg.n_layers} layers, "
                 f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
                 f"{cfg.vocab_size}: {n_params} parameters "
                 f"({cfg.param_dtype}), params + AdamW f32 moments "
                 f"{state_gb:.2f} GB (+ bf16 grads {n_params * 2 / 1e9:.2f} "
                 f"GB in a step), built in {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    resident = []
    for b in batches[:-1]:
        tr.run(iter([b]), 1)
        resident.append(torch.cuda.memory_allocated())
    peak_unprofiled = torch.cuda.max_memory_allocated() / 1e9
    say("train", f"allocated after each step (GB): "
                 f"{[round(x / 1e9, 3) for x in resident]}")
    if len(set(resident)) != 1:
        raise AssertionError("a training step left tensors behind")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run(iter(batches[-1:]), 1)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log = tr.metrics_log
    launches = {name: mod.launches for name, mod in mods.items()}
    launches["flash_attention"] = flash_mod.launches
    say("train", f"kernel launches in the {TRAIN_STEPS} steps (counters "
                 f"zeroed just before): {launches}")
    if any(launches.values()):
        raise AssertionError(f"training launched kernels: {launches}")
    for r in log:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            raise AssertionError(f"non-finite training step: {r}")
    if not log[-1]["loss"] < log[0]["loss"]:
        raise AssertionError(f"loss did not fall: {[r['loss'] for r in log]}")
    step_s = statistics.median(r["sec"] for r in log[1:-1])
    busy = _device_busy(prof)
    split = _kernel_split(busy)
    total = sum(busy.values())
    out["full"] = {
        "arch": cfg.name, "params": n_params, "B": TRAIN_B, "T": TRAIN_T,
        "losses": [r["loss"] for r in log],
        "grad_norms": [r["grad_norm"] for r in log],
        "lr": [r["lr"] for r in log], "step_s": [r["sec"] for r in log],
        "step_ms_median": step_s * 1e3,
        "tokens_per_s": TRAIN_B * TRAIN_T / step_s,
        "peak_gb": peak_unprofiled, "state_gb": state_gb,
        "profiled_step_device_ms": total,
        "split_ms": split, "f32_gemm_share": split["gemm_f32"] / total}
    say("train", f"losses {[round(x, 4) for x in out['full']['losses']]}, "
                 f"grad norms {[round(x, 3) for x in out['full']['grad_norms']]}")
    say("train", f"step ms (steps 1..{TRAIN_STEPS - 2}, median) "
                 f"{step_s * 1e3:.1f} of {[round(r['sec'] * 1e3, 1) for r in log]}"
                 f"; {out['full']['tokens_per_s']:.1f} tokens/s; peak "
                 f"memory {peak_unprofiled:.2f} GB "
                 f"(max_memory_allocated); {TRAIN_STEPS} steps in "
                 f"{wall:.2f}s")
    say("train", f"profiled step: device busy {total:.1f} ms: f32 GEMMs "
                 f"{split['gemm_f32']:.1f} ({split['gemm_f32'] / total:.4f})"
                 f", bf16 GEMMs {split['gemm_bf16']:.1f}, copies (casts) "
                 f"{split['copy']:.1f} ({split['copy'] / total:.4f}), "
                 f"other {split['other']:.1f}, flash {split['flash']:.1f}")
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:12]
    say("train", "top kernels (ms): " + "; ".join(
        f"{k[:100]} {v:.1f}" for k, v in top))

    # (b) peak memory by remat setting, one step each
    one = {k: torch.from_numpy(v[:TRAIN_MEM_B]).to(dev)
           for k, v in batches[0].items()}
    out["memory"] = {}
    for label, kw in (("remat=False", dict(remat=False)),
                      ("nothing", dict(remat_policy="nothing")),
                      ("dots_no_batch", dict(remat_policy="dots_no_batch")),
                      ("everything", dict(remat_policy="everything"))):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 1e9
        t0 = time.perf_counter()
        loss, grads = ST.value_and_grad(cfg, tr.params, one, **kw)
        torch.cuda.synchronize()
        peak_fb = torch.cuda.max_memory_allocated() / 1e9
        O.apply_updates(tr.params, grads, tr.opt_state, tr.opt_cfg)
        torch.cuda.synchronize()
        del grads
        peak = torch.cuda.max_memory_allocated() / 1e9
        out["memory"][label] = {"peak_gb": peak, "fwd_bwd_peak_gb": peak_fb,
                                "resident_gb": base,
                                "step_s": time.perf_counter() - t0,
                                "loss": loss.item()}
        say("train", f"memory, {TRAIN_MEM_B} x {TRAIN_T} tokens, {label}: "
                     f"forward + backward peak {peak_fb:.2f} GB "
                     f"({peak_fb - base:.2f} GB over the {base:.2f} GB "
                     f"resident), step peak {peak:.2f} GB, step "
                     f"{out['memory'][label]['step_s']:.3f}s")
    tr.close()
    del tr, loss, one
    gc.collect()
    torch.cuda.empty_cache()

    # (c) card against CPU, f32, from the same weights
    cfg32 = dataclasses.replace(get_arch(TRAIN_ARCH, reduced=True),
                                param_dtype="float32",
                                activation_dtype="float32")
    host = M.init_params(cfg32, torch.Generator().manual_seed(0), "cpu")
    tree = M.tree_map(lambda t: t.numpy(), host)
    small_loader = SelfScheduledLoader(
        zipf_store(os.path.join(root, "small"), cfg32.vocab_size,
                   n_shards=8, tokens_per_shard_mean=2048, seed=1),
        batch_size=4, seq_len=64, n_ingest_workers=4)
    small = list(small_loader.batches(TRAIN_CMP_STEPS + TRAIN_RESUME_STEPS))
    small, rb = small[:TRAIN_CMP_STEPS], small[TRAIN_CMP_STEPS:]
    opt = O.OptimizerConfig(lr=1e-3)
    runs = {}
    for where, on in (("card", dev), ("cpu", torch.device("cpu"))):
        params = M.params_from_numpy(cfg32, tree, on)
        state = O.init_opt_state(params, opt)
        step = ST.make_train_step(cfg32, opt)
        losses = []
        for b in small:
            _, _, met = step(params, state,
                             {k: torch.from_numpy(v).to(on)
                              for k, v in b.items()})
            losses.append(met["loss"].item())
        runs[where] = (losses, O.tree_leaves(params))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(runs["card"][0],
                                                       runs["cpu"][0]))
    num = sum(float(((a.detach().cpu().double() - b.detach().double()) ** 2)
                    .sum()) for a, b in zip(runs["card"][1], runs["cpu"][1]))
    den = sum(float((b.detach().double() ** 2).sum())
              for b in runs["cpu"][1])
    param_rel = (num / den) ** 0.5
    out["card_vs_cpu"] = {"losses_card": runs["card"][0],
                          "losses_cpu": runs["cpu"][0],
                          "loss_rel": loss_rel, "param_rel": param_rel}
    say("train", f"card vs CPU, {cfg32.name} f32, {TRAIN_CMP_STEPS} steps: "
                 f"losses {runs['card'][0]} vs {runs['cpu'][0]}, max rel "
                 f"{loss_rel:.3e} (gate {TRAIN_CMP_LOSS_RTOL}); "
                 f"||dparams||/||params|| {param_rel:.3e} (gate "
                 f"{TRAIN_CMP_PARAM_RTOL})")
    if loss_rel > TRAIN_CMP_LOSS_RTOL or param_rel > TRAIN_CMP_PARAM_RTOL:
        raise AssertionError("training on the card disagrees with the CPU")

    # (d) checkpoint and resume, bf16
    cfgr = get_arch(TRAIN_ARCH, reduced=True)
    kw = dict(total_steps=TRAIN_RESUME_STEPS, ckpt_every=2, log_every=100,
              peak_lr=1e-2, warmup_steps=1)
    half = TRAIN_RESUME_STEPS // 2

    def trainer(name):
        return Trainer(cfgr, O.OptimizerConfig(),
                       TrainerConfig(workdir=os.path.join(root, name), **kw),
                       device=dev)
    whole = trainer("whole")
    want = [r["loss"] for r in whole.run(iter(rb), TRAIN_RESUME_STEPS)]
    whole.close()
    out["resume_want"] = want
    first = trainer("resumed")
    first.run(iter(rb[:half]), half)
    first.close()
    second = trainer("resumed")
    if second.step != half:
        raise AssertionError(f"resumed at step {second.step}, not {half}")
    got = [r["loss"] for r in second.run(iter(rb[half:]), half)]
    second.close()
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want[half:]))
    out["resume"] = {"want": want[half:], "got": got, "rel": rel,
                     "bitwise": got == want[half:]}
    say("train", f"resume ({cfgr.name}, bf16, checkpoint at step 2, fresh "
                 f"Trainer from step {half}): losses {got} vs the "
                 f"uninterrupted {want[half:]}, max rel {rel:.3e} (gate "
                 f"{TRAIN_RESUME_RTOL}), bitwise {out['resume']['bitwise']}; "
                 f"torch.use_deterministic_algorithms not set")
    if rel > TRAIN_RESUME_RTOL:
        raise AssertionError("the resumed run left the uninterrupted one")

    # (e) the full-width witness, from the Trainer's step-0 weights
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    w16 = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    out["witness"] = train_witness(
        cfg, w16, {k: torch.from_numpy(v).to(dev)
                   for k, v in batches[0].items()})
    del w16
    out["witness"]["s"] = time.perf_counter() - t0
    out["witness"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    say("train", f"witness in {out['witness']['s']:.1f}s, peak "
                 f"{out['witness']['peak_gb']:.2f} GB")
    out["phase_s"] = time.perf_counter() - t_phase
    say("train", f"phase 10 in {out['phase_s']:.1f}s")
    say("train", "summary " + json.dumps(out))
    # phase 11 trains on the same batches
    out["batches"], out["resume_batches"] = batches, rb
    return out


MESH_LOSS_RTOL = 1e-3        # mesh Trainer against phase 10's, a step
MESH_DRYRUN_TIMEOUT_S = 600


def phase_mesh(train: dict, card: str) -> dict:
    """Phase 11: (a) the dry run's sweep in a subprocess without the card
    (the fake process group cannot share a process with NCCL), started
    first; (b) the one-GPU mesh on the card while it runs; then (a)'s
    records read and held."""
    import gc
    import glob
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ARCHS, shapes_for
    from repro_torch.kernels import (agl_lookup, dynamic_rates,
                                     encounter_screen, track_interp)
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
    from repro_torch.roofline.analysis import compute_terms

    t_phase = time.perf_counter()
    mods = {"track_interp": track_interp, "agl_lookup": agl_lookup,
            "dynamic_rates": dynamic_rates,
            "encounter_screen": encounter_screen}
    zero_counters(mods)
    flash_mod.launches = 0
    out: dict = {}

    # (a) started now, read at the end
    dr_dir = tempfile.mkdtemp(prefix="dryrun_", dir=WORK)
    jobs = os.cpu_count() or 1
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
           "--multi-pod", "both", "--jobs", str(jobs), "--exec-backend",
           "processes", "--out", dr_dir]
    t_dry = time.perf_counter()
    dry_log = os.path.join(WORK, "dryrun.log")
    with open(dry_log, "w") as f:
        dry = subprocess.Popen(cmd, env=env, cwd=HERE, stdout=f,
                               stderr=subprocess.STDOUT)
    try:
        out["card"] = _mesh_on_card(train, card)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
        try:
            dry.wait(timeout=MESH_DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            dry.kill()
            dry.wait()
            raise
    dry_s = time.perf_counter() - t_dry
    with open(dry_log) as f:
        log = f.read()
    if dry.returncode != 0:
        print(log[-4000:])
        raise AssertionError(f"the dry run exited {dry.returncode}")

    recs = [json.load(open(p)) for p in sorted(glob.glob(
        os.path.join(dr_dir, "*.json")))]
    want_cells = 2 * sum(len(shapes_for(cfg)) for cfg in ARCHS.values())
    bad = [(r["arch"], r["shape"], r["mesh"], r.get("error"))
           for r in recs if not r["ok"]]
    if len(recs) != want_cells or bad:
        print(log[-4000:])
        for r in recs:
            if not r["ok"]:
                print(r["arch"], r["shape"], r["mesh"], r.get("traceback"))
        raise AssertionError(f"dry run: {len(recs)} of {want_cells} cells "
                             f"written, not ok: {bad}")
    say("mesh", f"dry run: {len(recs)} (arch x shape x mesh) cells ok in "
                f"{dry_s:.1f}s wall ({jobs} processes, no card); roofline "
                f"at the H100 SXM datasheet constants ({PEAK_FLOPS_BF16:.3g}"
                f" FLOP/s bf16, {HBM_BW:.3g} B/s HBM, {LINK_BW:.3g} B/s a "
                f"link), planning estimates from traced graphs, not "
                f"measurements")
    cells = []
    for r in recs:
        t = compute_terms(r)
        if not (t.compute_s > 0 and t.memory_s > 0
                and t.collective_s >= 0):
            raise AssertionError(f"dry run terms not positive: {t}")
        cells.append({"arch": t.arch, "shape": t.shape, "mesh": t.mesh,
                      "compute_s": t.compute_s, "memory_s": t.memory_s,
                      "collective_s": t.collective_s,
                      "bottleneck": t.bottleneck,
                      "useful_ratio": t.useful_ratio,
                      "roofline_fraction": t.roofline_fraction,
                      "trace_s": r["total_s"]})
        say("mesh", f"roofline {t.arch} {t.shape} {t.mesh}: compute "
                    f"{t.compute_s:.6g}s memory {t.memory_s:.6g}s "
                    f"collective {t.collective_s:.6g}s bottleneck "
                    f"{t.bottleneck} useful {t.useful_ratio:.4f} "
                    f"roofline {t.roofline_fraction:.4f} (traced in "
                    f"{r['total_s']}s)")
    out["dryrun"] = {"cells": cells, "wall_s": dry_s, "jobs": jobs}
    shutil.rmtree(dr_dir, ignore_errors=True)

    launches = {name: mod.launches for name, mod in mods.items()}
    launches["flash_attention"] = flash_mod.launches
    say("mesh", f"kernel launches in phase 11 (counters zeroed just "
                f"before): {launches}")
    if any(launches.values()):
        raise AssertionError(f"phase 11 launched kernels: {launches}")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    say("mesh", f"phase 11 in {out['phase_s']:.1f}s (dry run "
                f"{dry_s:.1f}s beside the card's part); {card}")
    say("mesh", "summary " + json.dumps(out))
    return out


def _mesh_on_card(train: dict, card: str) -> dict:
    """Phase 11 (b): the one-GPU mesh (see :func:`phase_mesh`)."""
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.triples import TriplesConfig
    from repro_torch.launch import steps as step_lib
    from repro_torch.launch.mesh import (
        make_mesh, mesh_from_triples, start_single_process_group)
    from repro_torch.train import optimizer as O
    from repro_torch.train.compression import (
        compressed_psum_leaf, make_compressed_allreduce)
    from repro_torch.train.trainer import Trainer, TrainerConfig
    out: dict = {}
    root = os.path.join(WORK, "mesh")
    shutil.rmtree(root, ignore_errors=True)
    start_single_process_group("nccl")
    mesh = mesh_from_triples(TriplesConfig(nodes=1, nppn=1,
                                           threads_per_process=1),
                             chips_per_node=1)
    say("mesh", f"one-GPU mesh from the triple (1, 1, 1): {mesh}")

    # full width, phase 10's batches and schedule
    cfg = get_arch(TRAIN_ARCH)
    batches = train["batches"]
    want = train["full"]["losses"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tr = Trainer(cfg, O.OptimizerConfig(),
                 TrainerConfig(workdir=os.path.join(root, "full"),
                               total_steps=TRAIN_STEPS, ckpt_every=0,
                               warmup_steps=2, log_every=1,
                               peak_lr=TRAIN_PEAK_LR), mesh=mesh)
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    # The mesh Trainer draws and places its leaves one at a time: while
    # it builds, at most one top-level leaf's or one superblock's f32
    # draws are alive beside the placed shards (twice that for the
    # copies distribute_tensor may make).  On one GPU the shards are the
    # whole leaves, so this holds the build to its final residency plus
    # that transient, not to a share of the model.
    held = torch.cuda.memory_allocated() - before
    above = torch.cuda.max_memory_allocated() - before - held
    specs = step_lib.param_specs(cfg)
    top = max(x.numel() for k, x in specs.items() if k != "blocks")
    sb = sum(x.numel() // cfg.n_superblocks
             for x in O.tree_leaves(specs["blocks"]))
    bound = 2 * 4 * max(top, sb)
    out["build_memory"] = {"held": held, "peak_above_held": above,
                           "bound": bound}
    say("mesh", f"Trainer(mesh=...) build: {held / 1e9:.3f} GB held "
                f"(parameters and moments), peak {above / 1e9:.3f} GB "
                f"above it (bound {bound / 1e9:.3f} GB: twice the larger "
                f"of the largest top-level leaf and one superblock, in "
                f"f32); {card}")
    if above > bound:
        raise AssertionError("the mesh Trainer held whole leaves at once")
    resident = []
    for b in batches:
        tr.run(iter([b]), 1)
        resident.append(torch.cuda.memory_allocated())
    got = [r["loss"] for r in tr.metrics_log]
    tr.close()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    out["full"] = {"losses": got, "want": want, "rel": rel,
                   "bitwise": got == want, "built_s": built_s,
                   "allocated": resident}
    say("mesh", f"Trainer(mesh=...) {cfg.name} full width, {len(got)} "
                f"steps of {TRAIN_B} x {TRAIN_T}: losses {got} vs phase "
                f"10's {want}, max rel {rel:.3e} (gate {MESH_LOSS_RTOL}), "
                f"bitwise {got == want}; allocated after each step (GB) "
                f"{[round(x / 1e9, 3) for x in resident]}; {card}")
    if rel > MESH_LOSS_RTOL:
        raise AssertionError("the mesh Trainer left the device Trainer")
    if len(set(resident)) != 1:
        raise AssertionError("a mesh training step left tensors behind")

    # re-mesh onto a fresh one-GPU mesh, phase 10 (d)'s bf16 run
    cfgr = get_arch(TRAIN_ARCH, reduced=True)
    rb = train["resume_batches"]
    want = train["resume_want"]
    half = TRAIN_RESUME_STEPS // 2
    tr = Trainer(cfgr, O.OptimizerConfig(),
                 TrainerConfig(workdir=os.path.join(root, "remesh"),
                               total_steps=TRAIN_RESUME_STEPS, ckpt_every=2,
                               log_every=100, peak_lr=1e-2,
                               warmup_steps=1), mesh=mesh)
    tr.run(iter(rb[:half]), half)
    fresh = make_mesh((1, 1, 1), ("nodes", "data", "model"))
    tr.remesh(fresh)
    if tr.mesh is not fresh or tr.step != half + 1:
        raise AssertionError(f"re-mesh resumed at step {tr.step}")
    tr.run(iter(rb[half:]), half)
    tr.close()
    got = [r["loss"] for r in tr.metrics_log]
    # As in the reference, the re-meshed run resumes at the step after
    # the committed one, so its schedule skips one step: the losses up
    # to the first one after the re-mesh (from the restored weights)
    # are the uninterrupted run's; later ones take other lrs.
    n = half + 1
    rel = max(abs(a - b) / abs(b) for a, b in zip(got[:n], want[:n]))
    out["remesh"] = {"losses": got, "want": want, "rel": rel,
                     "bitwise": got[:n] == want[:n]}
    say("mesh", f"re-mesh ({cfgr.name}, bf16, onto a fresh one-GPU mesh "
                f"after step {half - 1}, resumed at step {half + 1}): "
                f"losses {got} vs phase 10's uninterrupted {want}; the "
                f"first {n} max rel {rel:.3e} (gate {TRAIN_RESUME_RTOL}), "
                f"bitwise {got[:n] == want[:n]}")
    if rel > TRAIN_RESUME_RTOL:
        raise AssertionError("the re-meshed run left the uninterrupted one")

    # the compressed all-reduce over a one-pod mesh
    pods = make_mesh((1, 1), ("pod", "data"))
    g = torch.Generator(device="cuda").manual_seed(0)
    tree = {"a": torch.randn((4096, 1000), generator=g, device="cuda"),
            "b": torch.randn((777,), generator=g, device="cuda")}
    got = make_compressed_allreduce(pods, "pod")(
        tree, torch.Generator(device="cuda").manual_seed(1))
    g1 = torch.Generator(device="cuda").manual_seed(1)
    want = {k: compressed_psum_leaf(tree[k][None], g1) for k in ("a", "b")}
    same = all(torch.equal(got[k], want[k]) for k in want)
    err = max(float((got[k] - tree[k]).abs().max()
                    / tree[k].abs().max()) for k in tree)
    out["compressed"] = {"bitwise": same, "max_rel_err": err}
    say("mesh", f"make_compressed_allreduce over a one-pod mesh: bitwise "
                f"compressed_psum_leaf {same}; max |out - in| / max |in| "
                f"{err:.4f} (the reference's bound 0.02)")
    if not same or err >= 0.02:
        raise AssertionError("the compressed all-reduce disagrees")
    return out


def train_witness(cfg, w16: dict, batch: dict) -> dict:
    """Phase 10 (e) on ``cfg`` (bf16) at weights ``w16`` and ``batch``
    (tensors on one device): the f32 twin's gradient against central
    differences of its loss, leaf by leaf; the bf16 gradient against the
    f32 twin's; and the loss after a sign step of each TRAIN_WIT_ETAS in
    f32 and in bf16 (see the constants).  Raises if a gradient check
    fails; ``w16`` is left as it was."""
    import dataclasses
    import torch
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")

    def loss(c, w) -> float:
        with torch.no_grad():
            return M.loss_fn(c, w, batch).item()

    l16, g16 = ST.value_and_grad(cfg, w16, batch, remat_policy="nothing")
    w32 = _widened(w16)
    l32, g32 = ST.value_and_grad(cfg32, w32, batch, remat_policy="nothing")
    names = _leaf_paths(w16)
    W16, W32, G16, G32 = (O.tree_leaves(t) for t in (w16, w32, g16, g32))
    res: dict = {"loss_bf16": l16.item(), "loss_f32": l32.item(),
                 "grad_bf16_vs_f32": {}, "fd": {}}
    for n, a, b in zip(names, G16, G32):
        if n != "embed":
            res["grad_bf16_vs_f32"][n] = float((a.float() - b).norm()
                                               / b.norm())
            continue
        # the rows the batch's tokens look up, apart (see the constants)
        rows = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
        rows[batch["tokens"].flatten().long()] = True
        for part, m in (("embed[batch rows]", rows),
                        ("embed[other rows]", ~rows)):
            res["grad_bf16_vs_f32"][part] = float(
                (a[m].float() - b[m]).norm() / b[m].norm())
        res["embed_batch_rows"] = int(rows.sum())
    # central differences along each leaf's own gradient; w32 is
    # restored exactly from w16 (it is w16 widened)
    for n, w, src, g in zip(names, W32, W16, G32):
        g2 = float(g.norm()) ** 2
        e = TRAIN_FD_DL / g2
        w.copy_(src).add_(g, alpha=e)
        lp = loss(cfg32, w32)
        w.copy_(src).add_(g, alpha=-e)
        lm = loss(cfg32, w32)
        w.copy_(src)
        fd = (lp - lm) / (2 * e)
        res["fd"][n] = {"fd": fd, "g2": g2, "rel": abs(fd - g2) / g2}
    # sign steps: f32 from w32, bf16 from w16 (restored from w32)
    n16 = sum(w.numel() for w in W16 if w.dtype != torch.float32)
    res["sign_step"] = {"eta": list(TRAIN_WIT_ETAS), "f32": [],
                        "f32_first_order": [], "bf16": [],
                        "bf16_changed_share": []}
    g1 = sum(float(g.abs().sum()) for g in G32)
    for eta in TRAIN_WIT_ETAS:
        for w, src, g in zip(W32, W16, G32):
            w.copy_(src).add_(torch.sign(g), alpha=-eta)
        res["sign_step"]["f32"].append(loss(cfg32, w32))
        res["sign_step"]["f32_first_order"].append(l32.item() - eta * g1)
    for w, src in zip(W32, W16):
        w.copy_(src)
    for eta in TRAIN_WIT_ETAS:
        changed = 0
        for w, src, g in zip(W16, W32, G16):
            new = (src - eta * torch.sign(g.float())).to(w.dtype)
            if w.dtype != torch.float32:
                changed += int((new != w).sum())
            w.copy_(new)
        res["sign_step"]["bf16"].append(loss(cfg, w16))
        res["sign_step"]["bf16_changed_share"].append(changed / n16)
        for w, src in zip(W16, W32):
            w.copy_(src)
    del w32, g16, g32, W32, G16, G32

    worst_fd = max(res["fd"].items(), key=lambda kv: kv[1]["rel"])
    worst_bf = max(((n, v) for n, v in res["grad_bf16_vs_f32"].items()
                    if n != "embed[batch rows]"), key=lambda kv: kv[1])
    embed_bf = res["grad_bf16_vs_f32"]["embed[batch rows]"]
    loss_rel = abs(res["loss_bf16"] - res["loss_f32"]) / res["loss_f32"]
    res["loss_rel"] = loss_rel
    say("train", f"witness ({cfg.name}, {tuple(batch['labels'].shape)} "
                 f"tokens): loss bf16 {res['loss_bf16']:.6f}, f32 twin "
                 f"{res['loss_f32']:.6f} (rel {loss_rel:.3e})")
    say("train", "central differences / ||g||^2 - 1 by leaf (f32 twin, "
                 f"gate {TRAIN_FD_RTOL}): " + ", ".join(
                     f"{n} {r['rel']:.2e} (||g||^2 {r['g2']:.4g})"
                     for n, r in res["fd"].items()))
    say("train", "||g_bf16 - g_f32|| / ||g_f32|| by leaf (gate "
                 f"{TRAIN_BF16_GRAD_TOL}; embed's {res['embed_batch_rows']} "
                 f"batch rows {TRAIN_BF16_EMBED_TOL}): " + ", ".join(
                     f"{n} {v:.4f}" for n, v in
                     res["grad_bf16_vs_f32"].items()))
    st = res["sign_step"]
    say("train", f"loss after w - eta sign(g), eta {st['eta']}: f32 "
                 f"{[round(x, 4) for x in st['f32']]} (first order "
                 f"{[round(x, 2) for x in st['f32_first_order']]}; from "
                 f"{res['loss_f32']:.4f}), bf16 "
                 f"{[round(x, 4) for x in st['bf16']]} (bf16 elements "
                 f"changed {[round(x, 4) for x in st['bf16_changed_share']]})")
    if worst_fd[1]["rel"] > TRAIN_FD_RTOL:
        raise AssertionError(f"the f32 gradient of {worst_fd[0]} disagrees "
                             f"with central differences: {worst_fd[1]}")
    if worst_bf[1] > TRAIN_BF16_GRAD_TOL or loss_rel > TRAIN_BF16_LOSS_RTOL \
            or embed_bf > TRAIN_BF16_EMBED_TOL:
        raise AssertionError(f"the bf16 gradient of {worst_bf[0]}, the "
                             f"embedding's batch rows or the loss is off "
                             f"its f32 twin's: {worst_bf[1]}, {embed_bf}, "
                             f"{loss_rel}")
    return res


def _leaf_paths(tree, pre: str = "") -> list:
    """'a/b' names of a tree's leaves, in ``tree_leaves`` order."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += _leaf_paths(tree[k], pre + k + "/")
        else:
            out.append(pre + k)
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _widened(tree):
    """A parameter tree with every leaf cast to f32 (new tensors, also
    for leaves that are f32 already)."""
    import torch
    return {k: _widened(v) if isinstance(v, dict)
            else v.to(torch.float32, copy=True) for k, v in tree.items()}


def _device_busy(prof) -> dict:
    """Device time (ms) by kernel name from a torch.profiler run.  The
    MoE stages' ``record_function`` ranges, which the profiler may also
    show on the device's timeline, are not kernels and are left out."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return {e.key: getattr(e, "self_device_time_total", 0.0) / 1e3
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == cuda
            and e.key not in MOE_STAGES}


def _stage_device_ms(prof) -> dict:
    """Device time (ms) of the kernels launched inside each MoE stage's
    ``record_function`` range (CPU-side totals, which include every
    kernel its ops launched)."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    out = dict.fromkeys(MOE_STAGES, 0.0)
    for e in prof.key_averages():
        if e.key in out and getattr(e, "device_type", None) == cpu:
            out[e.key] += getattr(e, "device_time_total", 0.0) / 1e3
    return out


def _kernel_split(busy: dict) -> dict:
    """A profile's device ms by kind of kernel: GEMMs (cuBLAS/CUTLASS
    products, f32 and bf16 apart), the flash kernel, copies (casts of
    weights and activations to f32 among them), and the rest.  cuBLASLt's
    ``nvjet`` kernels are Hopper tensor-core GEMMs: with TF32 off (as
    main sets it) they take 16-bit operands, so they count as bf16
    whatever their names say (f32 products run as ``ffma`` kernels)."""
    split = dict.fromkeys(("gemm_f32", "gemm_bf16", "flash", "copy",
                           "other"), 0.0)
    for k, v in busy.items():
        low = k.lower()
        if "flash_attention" in low:
            split["flash"] += v
        elif any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet")):
            split["gemm_bf16" if any(w in low for w in (
                "bf16", "bfloat16", "_hsh", "_bsb", "nvjet")) else
                "gemm_f32"] += v
        elif "copy" in low:
            split["copy"] += v
        else:
            split["other"] += v
    return split


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch is missing; run it from "
              "the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    say("setup", f"python {sys.version.split()[0]}, torch "
                 f"{torch.__version__}, CUDA {torch.version.cuda}, "
                 f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card, screen_floor = phase_build()

    from repro_torch.geometry.dem import SyntheticGlobeDEM
    t0 = time.perf_counter()
    globe = SyntheticGlobeDEM(cells_per_deg=120)
    say("setup", f"GLOBE-resolution DEM generated in "
                 f"{time.perf_counter() - t0:.2f}s")
    results = phase_kernels(globe)
    screen = phase_screen_kernels(screen_floor)
    launches, archive_dir, zip_shapes = phase_workflow()
    phase_globe(archive_dir, globe)
    screen_launches, screen_shapes, barrier = phase_screen_workflow()
    dag_launches, dag_shapes, dag_trace = phase_dag(barrier)
    phase_trace(dag_trace)
    flash = phase_flash()
    lm = phase_lm()
    arms = phase_lm_arms()
    bench = phase_bench()
    serving = phase_serving(card, globe)
    train = phase_train()
    phase_mesh(train, card)
    top_shapes = phase_workflow_shapes({"zip workflow": zip_shapes,
                                        "store+screen workflow":
                                            screen_shapes,
                                        "store+screen DAG": dag_shapes,
                                        **bench["shapes"],
                                        "live store": serving["shapes"]})

    from repro_torch.kernels import _build
    sources = {"track_interp": "track_interp.cu",
               "agl_lookup": "agl_lookup.cu",
               "dynamic_rates": "dynamic_rates.cu",
               "encounter_screen": "encounter_screen.cu"}
    replaces = {"track_interp": "src/repro/kernels/track_interp.py:89",
                "agl_lookup": "src/repro/kernels/agl_lookup.py:94",
                "dynamic_rates": "src/repro/kernels/dynamic_rates.py:77",
                "encounter_screen":
                    "src/repro/kernels/encounter_screen.py:169"}
    rows = []
    for name, res in results.items():
        top = res["per_width"][WIDTHS[-1]]
        rows.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(_build.SRC_DIR / sources[name],
                                      HERE),
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": res["max_abs_err"],
            "rtol": TOL[name][0], "atol": TOL[name][1],
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "shape": f"B={B_ROWS} N={N_KNOTS} M={WIDTHS[-1]}",
            "per_width": {str(w): {k: v for k, v in r.items() if k != "plan"}
                          for w, r in res["per_width"].items()},
            "launches_screen_workflow": screen_launches[name],
            "launches_dag_workflow": dag_launches[name],
            "launches_bench": {kind: n[name] for kind, n in
                               bench["launches"].items()},
            "launches_live_store": serving["launches"][name],
        })
        if name in SHAPED:
            rows[-1]["plan"] = top["plan"]
            rows[-1]["floor_ms"] = top["floor_ms"]
            rows[-1]["workflow_top_shapes"] = {
                label: {k: v for k, v in by[name].items() if k != "plan"}
                for label, by in top_shapes.items()}
        if "ieee_dt" in res:
            rows[-1]["ieee_dt"] = {k: v for k, v in res["ieee_dt"].items()
                                   if k != "plan"}
    C, K, T = SCREEN_TOP_SHAPE
    top = screen["per_shape"][f"{C}x{K}x{T}"]
    rows.append({
        "name": "encounter_screen", "route": "cuda",
        "source": os.path.relpath(_build.SRC_DIR / sources[
            "encounter_screen"], HERE),
        "replaces": replaces["encounter_screen"],
        "launches": screen_launches["encounter_screen"],
        "max_abs_err": screen["max_abs_err"],
        "rtol": TOL["encounter_screen"][0],
        "atol": TOL["encounter_screen"][1],
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None, "shape": f"C={C} K={K} T={T}",
        "per_shape": screen["per_shape"],
        "launches_dag_workflow": dag_launches["encounter_screen"],
        "launches_bench": {kind: n["encounter_screen"] for kind, n in
                           bench["launches"].items()},
    })
    top_name = f"B=1 H=32 KV=8 T={FLASH_LM_T[-1]} S={FLASH_LM_T[-1]} " \
               f"hd=160 causal bfloat16"
    top = flash["per_shape"][top_name]
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": os.path.relpath(_build.SRC_DIR / "flash_attention_sm90.cu",
                                  HERE),
        "cuda_core_source": os.path.relpath(
            _build.SRC_DIR / "flash_attention.cu", HERE),
        "cuda_core_ms": top["cuda_core_ms"],
        "launches_by_route": lm["launches_by_route"],
        "replaces": "src/repro/kernels/flash_attention.py:124",
        "launches": lm["launches"],
        "max_abs_err": flash["max_abs_err"],
        "rtol": FLASH_F32_TOL, "atol": FLASH_F32_TOL,
        "bf16_rtol": FLASH_BF16_RTOL, "bf16_atol": FLASH_BF16_ATOL,
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"], "shape": top_name,
        "per_shape": flash["per_shape"],
        "lm_forward_tokens_per_s": lm["forward_tokens_per_s"],
        "lm_forward_flash_share": lm["forward_flash_share"],
        "launches_lm_arms": {n: r["launches"] for n, r in arms.items()},
        "lm_arms": arms,
    })
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
