#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   three kernel sources of ``src/repro_torch/csrc/`` with ``nvcc``, all at
   once; prints each K1, K2, K4, K6 and K9 instance's registers, stack
   frame and spills from ``ptxas`` and its local loads and stores (LDL/STL)
   in the SASS (any of them fails the run: K1's stack top, K2's and K4's
   carry, K6's on-chip columns and the rows K9 holds stay out of local
   memory).
2. Kernel phase, at C192 with 80 levels: each kernel against its plain
   PyTorch version on the same inputs on the card — K1 on ``fx_ppm``,
   ``edge_flux`` (regions), ``riem_coeffs`` (K offsets) and d_sw's
   heaviest opt-3 node, ``inner_y_update+al_x+fx_ppm`` (one launch of 7
   records), K2 on ``tridiag_solve`` and ``column_total``, K3 on
   ``interface_interp`` (monotone coordinates) and on coordinates in
   random order with NaNs (against the plain version marching,
   ``cuda.marching_plain``); K5, the member axis, on ``fx_ppm`` and
   ``tridiag_solve`` at 4 members under ``"grid"`` and ``"vmap:2,grid"``
   with one input broadcast (member stride 0); K4, the K-blocked solver
   kernel (K2's march with its copies a slab ahead), on ``precompute_pe``
   with ``block_k`` 8 and 16 (also against K2, exactly, and timed beside
   it) and at 4 members under ``"grid"`` and ``"vmap:2,grid"`` — with the
   max error, its tolerance, and both times (CUDA events after a
   warm-up).  Then the stencils past the encoder's old fixed tables
   (``TABLE_CASES`` of ``tests/test_torch_cuda.py``) at C192 L80 on one
   tile, each exactly its plain version.
3. Standalone phase: ``repro_torch.kernels.ops`` at C192 L80 shapes — K6
   ``tridiag`` on the six tile interiors stacked along J (80, 1152, 192),
   f32 and f64, each timed beside its bound, f32 also beside
   ``torch.linalg.solve`` on the same systems as dense matrices; K7
   ``fvt_flux`` on the six tiles' levels stacked along K (480, 204, 204),
   halo 6.
4. Path phase: ``make_step_sequential(FV3Config(npx=192, nk=80),
   opt_level=0)`` takes 3 steps on the card from ``init_state(cfg,
   seed=0)``; step 1 is held against the plain ``"torch"`` backend on the
   card over the interior.
   Prints the step time, the launches of each kernel per step, the peak
   device memory and the relative drift of the total mass, then traces one
   more step with ``torch.profiler`` (device time by kernel, and the idle
   share of the untraced step).
5. Ensemble phase: ``make_step_ensemble(..., opt_level=0)`` at C192 L80
   from ``ensemble_state(cfg, M, seed=0)`` — M = 4 under ``"grid"`` (3 steps),
   M = 6 under ``"vmap:4"`` (padded to 8, 2 chunks; 1 step), M = 4 under
   ``"vmap:2,grid"`` (1 step).  Step 1 must equal M single-member
   sequential steps on the member slices exactly, while the members
   differ; launches per step must be the sequential path's (twice them
   under ``"vmap:4"``).  Prints the step and per-member-step times and
   the peak device memory of each.
6. Opt phase: the four step programs at C192 L80 compiled on ``"cuda"`` at
   opt 0-4 for the default (H100) preset, with the static verifier after
   every pass: stencil nodes, rule counts, verifier violations and every
   vertical solver's tuned schedule; per step, the launches of K1, K2 and
   K4 and the ops, field loads (and distinct loads per record) and stores
   the interpreter executes.
7. Opt-3 phase: the reference's default path, ``make_step_sequential(cfg)``
   (opt 3, the H100 preset), 3 steps: step 1 against the plain opt-3 step
   (same programs, the whole-step bar) and against the plain opt-0 step of
   the path phase (the reference's bar between optimized and unoptimized
   steps), the step time, launches per step of K1-K4 (K1's must stay
   below 990, one launch per statement), peak memory, mass drift and a
   traced step with K1's
   device time and interpreted ops per ms; then the same step under the
   reference's TPU schedules, ``hardware="tpu-v5e"``, which puts d_sw's
   ``precompute_pe`` on K4 at ``block_k`` 16 (8 launches a step): its
   step 1 must equal the default step's exactly over the interior; then one
   M = 4 ``"grid"`` ensemble step at opt 3 on ``"tpu-v5e"``, which must
   equal 4 single opt-3 steps exactly (K4's carry reset per member).
   Distributed phase (``[distributed]`` lines, its own wall time):
   ``make_step_distributed`` at C192 L80, layout (2, 2) — 24 ranks of
   96 x 96 held by this process on one leading axis, opt 3, the H100
   preset, ``overlap=True`` (the interiors beside the exchange on a second
   stream) — takes 3 steps from ``blocks_from_global`` of the path phase's
   state; step 1 must equal the opt-3 sequential step 1 within 1e-5 over
   the interior, and exactly away from the tiles' corners (a cube
   corner's diagonal ghost cell carries what a program wrote into the
   ghost ring: ``corner_split``).  Prints the step time, launches of K1-K4
   and exchange passes per step, peak memory, mass drift and a traced step
   (device time by kernel, the ``halo_exchange`` range's device time, the
   idle share).  Then opt 4 against opt 3 without overlap (one step each,
   ``delpc_exchange_skipped`` as the cost model decides it; exactly equal
   away from the tiles' corners, within 1e-5 near them); the exchanger
   alone on every state field, exactly ``exchange_reference`` on the
   global tensors, timed; the split runners of c_sw, d_sw and tracer_2d
   (their strips are 6-wide domains) on the kernels against the plain
   lowering; and ``n_members=2`` on a (2, 6, 1, 1) mesh, overlapped
   (each member within 1e-5 of the sequential step on its state, exactly
   away from the tiles' corners) and with the exchange first (exactly).
8. LM kernel phase, at the serving shapes: K8 ``flash_attention`` at
   Granite-8B's B=8, S=2048, H=32, KVH=8, D=128 and Zamba2-7B's H=KVH=32,
   D=112 (softcap 0 and 50), at Gemma-2-2B's B=4, S=6144, H=8, KVH=4,
   D=256 with its window 4096 and softcap 50 (local layers), without the
   window (global layers) and with the window and softcap 0 (beside
   ``F.scaled_dot_product_attention`` with the window as a boolean mask),
   and with windows 1000 and 100 (softcap 30) at Granite's shape; each
   bound counts the (query, key) pairs its window keeps; K9 ``rmsnorm``
   and ``rmsnorm_residual`` at
   the prefill's 16384 rows and the decode step's 8 (d 4096 and 3584; at 8
   rows also the device time a call under ``torch.profiler``), each in
   float32 and bfloat16 against its plain version at
   the reference's tolerances (and at d 5120, K9's general instance; at 8
   rows the host µs a call beside the device µs, for ``F.rms_norm`` too,
   and K9's bars against this run's numbers),
   timed beside the plain version, its bound
   (float32 K8: three TF32 products on the tensor cores, its old CUDA-core
   bound printed beside) and one library call
   (``F.scaled_dot_product_attention``, in float32 too, ``F.rms_norm``);
   K8 in both dtypes also against a float64 attention of the same inputs
   beside the plain version: the max abs error, and each (b, s, h) row's
   error relative to the row's norm, whose mean and max must stay within
   2x the plain version's; K10
   ``ssm_state_scan`` (float32) at Zamba2-7B's (16, 8, 112, 64, 64) and a
   ragged (3, 2, 112, 64, 64) against its plain version (no library call
   computes it).  The build step prints each K8 instance's registers and
   spills from ``ptxas`` and counts the wgmma, TMA, mbarrier and local
   memory instructions in each K8 kernel's SASS (no wgmma in either, or a
   spill or local access in the float32 kernel, fails the run).
9. Serving phases: Granite-8B (36 layers), then Zamba2-7B (81 Mamba-2
   layers and one shared attention block applied 27 times), Gemma-2-2B
   (13 local and 13 global layers), Llama-4 Scout (4 of its 48 MoE layers),
   Grok-1 (2 of its 64) and xLSTM-1.3B (42 mLSTM and 6 sLSTM layers), each
   at full width (and depth, but for the MoE models, cut to fit their
   float32 weights on one card) with seeded weights; Gemma-2 with traffic
   of its own (:data:`TRAFFIC`: parity at one prompt of 4608 tokens,
   serving at 4 x 6144 into global caches of 6176 and local rings of 4096,
   decode from 6144, where the rings have wrapped).  Parity: float32
   weights, 2
   prompts of 512 tokens, prefill and 8 greedy decode steps through the
   kernels and again through the plain versions on the card (the same
   tokens), the prefill logits and every cache of both (KV, Mamba-2's
   conv tails and SSM states, mLSTM's C and n, sLSTM's h, c, n, m) held
   against an independent float64 prefill (mLSTM there the step-wise
   recurrence, not the chunked form; the kernel path within 1e-4 of the
   largest |value| and within 2x the plain path's own float32 error; an
   sLSTM state past 1e-4 within 2x the error of an independent float32
   prefill of the reference's equations instead), and the float32 prefill
   timed alone;
   for the MoE models, how many (token, layer) top-k expert choices of the
   prefill differ between the kernel path, the plain path and the float64
   (or, for the bf16 run, float32) prefill.
   Serving run: bfloat16 weights, 8
   prompts of 2048 tokens, prefill (median of 2 after a warm-up) and 31
   greedy decode steps into caches of 2080: prefill ms, decode ms per
   token, generated tokens/s, K8/K9/K10 launches per prefill and per
   decode step, peak memory, a traced prefill's device time by kernel
   group (and Zamba2's intra-chunk work, timed alone; xLSTM's sLSTM scan:
   its device time in the traced prefill and one layer's scan timed
   alone), a traced decode step's device idle share (its trace read both by
   ``device_rows`` and by ``key_averages``, which must agree), and the
   last-position logits against the plain path.
   int8 phase (``[int8]`` lines): Granite-8B's float32 model quantized to
   int8 (``repro_torch.serve.quantize_params``) and freed; in float32
   compute the int8 path equal to the model dequantized up front, within
   the parity bars of a float64 prefill of those weights, its correlation
   with the float32 logits printed (and held above 0.99 at 2 layers, the
   depth of the reference's own test); in bf16 compute at the serving
   traffic, prefill and decode times with int8 weights, then also with an
   int8 KV cache calibrated from the prompt (its steps held against the
   plain path's on the same caches and tokens), peak memory beside the bf16
   model's and the bytes of weights and caches.  Each LM phase prints its
   seconds (``[phase]``).
10. Backward kernel phase (``[bwd]`` lines): K8's backward (delta, dK/dV,
   dQ kernels) at Granite-8B's (8, 2048, 32/8, 128) and Gemma-2's (4,
   6144, 8/4, 256; window 4096, softcap 50), K9's (plain and residual) at
   (16384, 4096), K10's at the Zamba2 training micro-batch (32, 4, 112,
   64, 64), the serving shape (16, 8, 112, 64, 64) and a ragged (3, 1, 3,
   5, 7); float32 against a float64 plain run (each gradient within
   1e-4 of its largest |value| and within 2x the float32 plain version's
   error; K8's backward on the plain forward's o and lse, the forward
   kernel's printed beside; K10's the same bits in two runs), bf16 against
   the plain version at K8's and K9's bf16 tolerances; each timed beside
   the plain version, its bound and the library (SDPA forward + backward,
   ``F.rms_norm``'s backward; none for K10).
   Training parity (``[train-parity]``): one loss and backward through
   the kernels and through the plain versions, float32 (loss 1e-5
   relative, each gradient 1e-4 of its max) and bf16 (within 2x the plain
   path's bf16-vs-float32 distance), of a 2-layer full-width Granite at 2
   x 2048, one full-width Zamba2 group (the shared block and 3 Mamba-2
   layers: K10 forward and backward) at 2 x 2048, a local and a global
   full-width Gemma-2 layer at 1 x 6144 (past the window: K8's window
   instance forward and backward), one xLSTM-1.3B group (7 mLSTM layers
   and the sLSTM scan, no K8), and one Llama-4 Scout and one Grok-1 layer
   (MoE; Grok-1's softcap 30 through K8) at 2 x 2048; the gradients kept
   on the host one set at a time; the MoE models' bf16 runs print the
   (token, layer) expert choices that differ between the paths.
   Training (``[train]``, :data:`TRAIN`): float32 masters and the config's
   optimizer (AdamW; Adafactor for Grok-1), bf16 compute, grad_accum 2, 3
   steps and a traced fourth, at full width: Granite-8B (8 of its 36
   layers), Zamba2-7B (24 of its 81 Mamba-2 layers), xLSTM-1.3B (8 of 48
   layers: one pattern group) and Grok-1 (1 of 64) at 8 x 4096,
   Gemma-2-2B uncut at 4 x 8192; each step's loss and grad_norm (finite,
   the loss falling), step ms, tokens/s, model FLOPs and their rate, peak
   memory, the optimizer state's bytes, the launches per step of each
   kernel the pattern holds (:func:`train_kernels`; forward and backward;
   none of the others; Gemma-2 must launch K8's window backward once a
   local layer a microbatch), device time by kernel group (the MoE
   routing's own), the ``opt_update``, ``ssd_chunks`` and ``slstm_scan``
   ranges (device and host ms), the host's wall time inside the sLSTM
   mixers in each step (:func:`slstm_clock`), and the idle share.
   Training across ranks (``[train-dist]``, :data:`TRAIN_DIST`): 2
   full-width Granite-8B layers and one Zamba2-7B group, float32, 2 x
   2048, grad_accum 2, 3 steps, laid out by ``parallel.sharding`` on a
   (1, 1) mesh over NCCL in a process group of this one process (every
   weight gathered at its use, every gradient reduce-scattered), in turns
   with the unsharded step: losses and grad_norm at 1e-5 relative, the
   masters at 1e-4 of each one's max (and whether bit-equal), the kernels
   launched, step ms of both, peaks; a traced sharded Granite step (the
   NCCL kernels' device ms); Zamba2's state saved and restored through
   ``elastic.reshard_state``, bit for bit.  Then (:data:`TRAIN_DIST_GLOO`)
   two gloo processes on the one card, a (2, 1) mesh: each rank's peak
   beside the unsharded run's, held to it at the train-step tests' bars.
   The hillclimb's paths: ``[remat]`` (:data:`REMAT`: Granite-8B's
   training cell under remat "dots" in turns with "block", step ms, peak,
   the bytes a micro-batch keeps for its backward against the meta
   device's count and the allocator's growth; the 2-layer float32 parity
   step under "dots" against "block"), ``[int8-dist]``
   (:data:`INT8_DIST`, in the NCCL group: int8 Granite-8B layers on the
   (1, 1) mesh, bit-equal to the unsharded int8 model), and on two gloo
   processes ``[long-ctx]`` (:data:`LONG_CTX`: Gemma-2-2B's decode at a
   32,768-token prompt against caches split along the sequence, within
   1e-5 of the largest |logit| of the whole-cache decode, the same tokens)
   and ``[seq-shard]`` (:data:`SEQ_SHARD`: a prefill and a training
   micro-batch with the stream split over "model", bit-equal to the
   unsharded model's).
11. Prints the total wall time, a ``kernels`` JSON line and, last, the
   ``ok`` JSON line.

Each path (the sequential steps, the ensemble steps, the standalone ops,
the serving run, the training steps) is driven with the launch counts set
to 0 just before it and read just after.

Any failed check raises, and the script exits nonzero without the result
lines; so does a machine without a CUDA card, or a directory that holds
this script without the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data sheet: device-memory rate, the f32 rate outside the tensor
# cores (the stencils are f32 on CUDA cores) and the dense bf16 tensor-core
# rate (the least time of bf16 attention)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12

# the configuration every phase runs: C192 (6 x 192 x 192 columns), 80 levels
C192_L80 = {"npx": 192, "nk": 80}
KERNEL_RTOL = KERNEL_ATOL = 1e-6  # kernel vs plain, per element
F64_RTOL = F64_ATOL = 1e-12       # K6 in float64 vs plain
STEP_ATOL = 1e-5                  # one step vs the plain step, interior
# an optimized step vs the unoptimized one: the reference's own bar for
# that comparison (tests/test_fv3.py:131, assert_allclose rtol = atol =
# 5e-5) — its fusion moves the result by more than STEP_ATOL, and the port
# moves it by as much (tests/test_torch_optimizer.py holds it to the
# reference's optimized step at STEP_ATOL)
OPT_RTOL = OPT_ATOL = 5e-5
MASS_RTOL = 1e-5                  # relative drift of total mass, 3 steps
OPT3_HARDWARE = "tpu-v5e"          # the reference's preset: K4 on the path
# d_sw's heaviest node at opt 3: PPM's fused producers, one K1 launch
FUSED_NODE = "inner_y_update+al_x+fx_ppm"
# K1 launches per opt-3 step with one launch per PARALLEL statement
K1_LAUNCH_BAR = 990
SOURCE = "src/repro_torch/csrc/stencil_kernels.cu"
FV3_SOURCE = "src/repro_torch/csrc/fv3_kernels.cu"
PALLAS = "src/repro/core/backend/lowering_pallas.py"
LM_SOURCE = "src/repro_torch/csrc/lm_kernels.cu"

# the LM serving path: Granite-8B (36 attn layers, d_model 4096, GQA 32/8,
# d_head 128) at full width and depth
SERVE_ARCHS = ("granite_8b", "zamba2_7b")
# K8 at the prefill shapes of Granite-8B (GQA 32/8, d_head 128) and
# Zamba2-7B's shared block (MHA 32, d_head 112); K10 at Zamba2-7B's (16
# chunks of 128 for 8 x 2048 tokens, 112 heads, N = P = 64) and a ragged one
FA_SHAPES = ({"B": 8, "S": 2048, "H": 32, "KVH": 8, "D": 128},
             {"B": 8, "S": 2048, "H": 32, "KVH": 32, "D": 112})
# K8 at Gemma-2-2B's serving prefill (4 prompts of 6144 tokens, GQA 8/4,
# d_head 256), as (window, softcap) cases: its local layers (window 4096,
# softcap 50), its global layers (no window, softcap 50), and the window
# without the softcap, which one PyTorch call computes
# (F.scaled_dot_product_attention with the window as a boolean mask)
FA_GEMMA2 = {"B": 4, "S": 6144, "H": 8, "KVH": 4, "D": 256,
             "cases": ((4096, 50.0), (0, 50.0), (4096, 0.0))}
# and the window at Granite's shape (D 128, the MoE models' head width):
# 1000 keys, and 100 under Grok-1's softcap 30 and without a softcap (which
# masked SDPA computes)
FA_WINDOW_D128 = {"B": 8, "S": 2048, "H": 32, "KVH": 8, "D": 128,
                  "cases": ((1000, 0.0), (100, 30.0), (100, 0.0))}
FA_CASES = ((0, 0.0), (0, 50.0))  # the other shapes' (window, softcap)
SCAN_SHAPES = ((16, 8, 112, 64, 64), (3, 2, 112, 64, 64))
# K9 at the rows of a prefill of 8 prompts x 2048 tokens and the widths
# the served models give it, with their eps and a float32 weight (the
# models keep their norm weights in float32): Granite-8B's and Zamba2-7B's
# d_model (every ln1, the fused residual + ln2, the final norm) and
# Zamba2-7B's gated norm over d_inner (plain RMSNorm only)
NORM_CASES = (("granite_8b", 16384, 4096, 1e-5, True),
              ("zamba2_7b", 16384, 3584, 1e-5, True),
              ("zamba2_7b gated", 16384, 7168, 1e-6, False),
              # a decode step's 8 rows, where K9's launches are
              ("granite_8b decode", 8, 4096, 1e-5, True),
              ("zamba2_7b decode", 8, 3584, 1e-5, True),
              # a width no model gives it: K9's general instance
              ("general d 5120", 16384, 5120, 1e-5, True),
              ("general d 5120 decode", 8, 5120, 1e-5, True))
NORM_HEAD = (16384, 3584)        # the kernels line's K9 case (bf16)
NORM_DECODE_ROWS = 8             # also timed by device time a call
# kernel vs plain: the reference's own tolerances (tests/test_kernels.py)
FA_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 1e-1)}
# bf16 K8 and its plain version against a float64 attention of the same
# inputs, each (b, s, h) row's error over the row's norm: the kernel's mean
# and max over the rows within FA_F64_FACTOR of the plain version's.  FA_TOL
# alone is as large as |o| in the late rows (|o| ~ sqrt(1/keys)); the row
# norm lets every row count.
FA_F64_FACTOR = 2.0
# K8's backward in bf16 is held the same way on each gradient's rows, the
# kernel and the plain version on the same o and lse (the forward
# kernel's), leaving out rows whose float64 norm is at most ROW_FLOOR of
# the largest row of the three gradients: dq's first row of each (b, h) is
# 0 up to float64's rounding (its one key gives dS = P (dO.v - dO.o) with
# o = v), so its own norm measures nothing; its error stays in the max
# abs.  Training's chain (the forward kernel's o and lse into the backward
# kernel) is held against the plain path's on the mean over the rows
# alone: the max is set by rows whose gradient nearly cancels (dq's second
# query: dS_0 + dS_1 = 0), where the error is the bf16 rounding of o in
# delta = rowsum(dO o), and the two forwards round o differently.
ROW_FLOOR = 1e-6
# the log-sum-exp K8's forward writes for the backward, against the plain
# forward's (f32 in both dtypes): an lse off by x scales each P of its row
# by exp(x), so 1e-5 + 1e-5 |lse| keeps P within ~1e-4 at |lse| ~ 10
LSE_TOL = (1e-5, 1e-5)
NORM_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
PARITY = {"B": 2, "S": 512, "decode": 8}           # float32 weights
# float32 parity at full depth is held against an independent float64
# prefill: the kernel path's max abs error on the logits and on every KV
# cache within PARITY_REL of the largest |value|, and within PARITY_FACTOR
# of the plain path's own float32 error (parity_fails).  A fixed 1e-4
# between the two float32 paths is below float32's own error after 36
# layers: the plain path alone is ~1.4e-4 from float64 on logits of max |6|.
# An sLSTM state leaf past PARITY_REL is held instead within PARITY_FACTOR
# of an independent float32 prefill of the reference's equations
# (prefill_wide), no port code in it: that run's own error is past the bar
# too where the recurrence of the gates grows float32's error.
PARITY_REL = 1e-4
PARITY_FACTOR = 2.0
SERVE = {"B": 8, "S": 2048, "decode": 31, "cache": 2080}  # bfloat16
# the served models past Granite-8B and Zamba2-7B (SERVE_ARCHS, which the
# A/B scripts time): Gemma-2-2B at full width and depth, with traffic of
# its own so that its window (4096) binds: float32 parity at one prompt of
# window + 512 tokens, bfloat16 serving at 4 prompts of 6144 tokens into
# global caches of 6176 (local rings of 4096), decode from position 6144,
# where the rings have wrapped (6144 % 4096 != 0); the MoE models at full
# width with their depth cut to fit one card (float32 parity weights:
# Scout's 4 layers 43.5 GB, Grok-1's 2 layers 32.9 GB) and Granite's
# traffic; xLSTM-1.3B (42 mLSTM and 6 sLSTM layers) at full width and
# depth on Granite's traffic
SERVED_MODELS = SERVE_ARCHS + ("gemma2_2b", "llama4_scout_17b_a16e",
                               "grok1_314b", "xlstm_1p3b")
TRAFFIC = {"gemma2_2b": ({"B": 1, "S": 4608, "decode": 8},
                         {"B": 4, "S": 6144, "decode": 31, "cache": 6176})}
DEPTH = {"llama4_scout_17b_a16e": 4, "grok1_314b": 2}  # of 48 and 64
# int8 serving (weights quantized from the float32 parity model, then also
# the KV cache) on Granite-8B at full width and depth; the int8 path (each
# block dequantized at its use) against the model dequantized up front:
# bit for bit, or within INT8_UPFRONT_REL of max |logit| should cuBLAS
# pick another algorithm for one of them; against the unquantized float32
# logits, the reference's own bar (tests/test_models.py, on its 2-layer
# smoke model): correlation above INT8_CORR, held at INT8_CORR_LAYERS
# layers of full width and printed at full depth, where the quantization
# noise of seeded weights compounds (0.973 at 36 layers on an H100)
INT8_ARCH = "granite_8b"
INT8_UPFRONT_REL = 1e-6
INT8_CORR = 0.99
INT8_CORR_LAYERS = 2
LM_LAUNCHES = ("flash_attention", "flash_attention_window", "rmsnorm",
               "rmsnorm_residual", "ssm_state_scan")
# bf16 serving logits vs the plain path (both compute attention and norms in
# f32; they differ where a bf16 rounding of an activation flips, and 36
# layers grow those flips as they grow float32's): max abs difference over
# max |logit|, and the share of the 8 prompts whose top token agrees.  Set
# from the first full run on an H100 (4.797e-2 and 7 of 8) with a margin of
# 2x and one prompt; the kernel path must also stay within PARITY_FACTOR of
# the plain path's own distance to a float32 prefill of the same weights.
BF16_LOGIT_REL = 0.1
BF16_TOP1 = 0.75

# the training cells, each at full width through
# repro_torch.train.make_train_step (float32 masters, the config's
# optimizer, bf16 compute, global batch B x S in grad_accum microbatches,
# 3 steps and a traced fourth): Granite-8B cut to 8 of its 36 layers (the
# float32 masters, gradients and AdamW moments take 16 B a parameter:
# 34.4 GB for 2.148 G; the reference's train_4k length); Zamba2-7B cut to
# 24 of its 81 Mamba-2 layers (8 of its 27 groups, the shared block
# applied 8 times: 2.255 G, 36.1 GB; at 81 layers 6.699 G would need 107
# GB), the same 8 x 4096 tokens; Gemma-2-2B uncut (26 layers, 2.614 G,
# 41.8 GB) at its published 8192-token context (arXiv 2408.00118), 4 x
# 8192, the same 32,768 tokens a step: at 4096 tokens its 4096-key window
# would cover every key and its local layers would run only K8's causal
# instance; xLSTM-1.3B cut to one of its 6 pattern groups (7 mLSTM
# layers and 1 sLSTM: 0.378 G; no attention, so no K8), 8 x 4096, and
# untraced (``"trace": False``; the host's time inside the sLSTM mixers
# is clocked in the timed steps themselves, :func:`slstm_clock`): uncut
# (48 layers, 1.239 G, 19.8 GB) a step took 138.8 s and 188.6 s in two
# calls on an H100 80GB HBM3 at 700 W, host-bound (~4.8 M launches a
# step, the sLSTM scan's 4096 steps a layer and micro-batch), and the
# cell with its traced step 1243-1480 s, past this script's time (at this
# cut the traced step took ~95 s under the profiler and ~30 s to read,
# for a step of ~27 s): ``scripts/train_xlstm_uncut.py`` runs the uncut
# cell, traced.  Grok-1 cut to 1 of its 64
# layers, Adafactor as its config says (4.920 G; masters and gradients
# 39.4 GB, the factored moments 0.004 GB: 2 layers, 8.229 G, would leave
# no room for Adafactor's temporaries on a (8, 6144, 32768) float32
# expert tensor), 8 x 4096.  Llama-4 Scout has no cell: one of its 48
# layers (4.271 G, 68.3 GB of AdamW state, its untied 202,048 x 5120
# tables half of it) ran out of the card's memory in its first backward
# at 8 x 4096 (75.972 GiB at the peak; ROADMAP 12k-a).  ``of``: the
# config's depth, for the printed cut.
TRAIN = {
    "granite_8b": {"layers": 8, "of": 36, "B": 8, "S": 4096, "accum": 2,
                   "steps": 3},
    "zamba2_7b": {"layers": 24, "of": 81, "B": 8, "S": 4096, "accum": 2,
                  "steps": 3},
    "gemma2_2b": {"layers": None, "of": 26, "B": 4, "S": 8192, "accum": 2,
                  "steps": 3},
    "xlstm_1p3b": {"layers": 8, "of": 48, "B": 8, "S": 4096, "accum": 2,
                   "steps": 3, "trace": False},
    "grok1_314b": {"layers": 1, "of": 64, "B": 8, "S": 4096, "accum": 2,
                   "steps": 3},
}
# AdamW at the reference's OptConfig defaults: lr 3e-4 reached after 100
# warm-up steps, so steps 1-3 take 3e-6, 6e-6, 9e-6 (at lr 1e-3, 1e-4 or
# 3e-5 from the first step the loss of the seeded 8-layer model rose at
# step 2 on an H100: a first AdamW step moves each of its 2.15 G weights by
# about lr)
TRAIN_LR = 3e-4
TRAIN_WARMUP = 100
# one step of each model at full width and a cut depth, kernel path
# against the plain path (backend="ref") on the same weights and batch:
# 2 Granite layers at 2 x 2048; one Zamba2 group (the shared block and 3
# Mamba-2 layers) at 2 x 2048; a local and a global Gemma-2 layer at 1 x
# 6144, past the window, so the local layer runs K8's window instance
# forward and backward; one xLSTM-1.3B group (7 mLSTM layers and the sLSTM
# scan, differentiated on the card) at 2 x 2048; one Llama-4 Scout layer
# (top-1 and the shared expert) and one Grok-1 layer (top-2, K8 with the
# softcap 30 in f32's 3xTF32 and bf16's backward) at 2 x 2048
TRAIN_PARITY = {"granite_8b": {"layers": 2, "B": 2, "S": 2048},
                "zamba2_7b": {"layers": 3, "B": 2, "S": 2048},
                "gemma2_2b": {"layers": 2, "B": 1, "S": 6144},
                "xlstm_1p3b": {"layers": 8, "B": 2, "S": 2048},
                "llama4_scout_17b_a16e": {"layers": 1, "B": 2, "S": 2048},
                "grok1_314b": {"layers": 1, "B": 2, "S": 2048}}
TRAIN_LOSS_REL = 1e-5        # float32: the loss, relative
TRAIN_GRAD_REL = 1e-4        # float32: each gradient, of its max |value|
# a gradient whose max |value| is at most TRAIN_GRAD_FLOOR of the model's
# largest is the round-off of a gradient that is zero in exact arithmetic
# (Llama-4 Scout's router: a top-1 gate normalised over itself is 1, so
# the loss does not depend on the router's logits; its float32 gradient
# is ~6e-11 against a largest of ~0.1 on the smoke model, and two paths'
# round-off differ by all of it): it is held at TRAIN_GRAD_REL of the
# model's largest gradient max instead of its own.  TRAIN_GRAD_ZERO names,
# by model, the leaves that must fall under the floor (by the end of their
# names), and no other leaf may: a leaf that crosses it either way fails
# the step
TRAIN_GRAD_FLOOR = 1e-6
TRAIN_GRAD_ZERO = {"llama4_scout_17b_a16e": ("ffn.router",)}
# K8's backward at Granite's prefill shape, Gemma-2's (window 4096,
# softcap 50) and the shape the Granite training step launches it at
# (its micro-batch: 4 x 4096, so dK and dV sum H / KVH x S = 16384
# query rows in the accumulator); K9's at a prefill's rows of Granite's
# width; K10's at the Zamba2 training step's micro-batch (32 chunks of
# 128 for 4 x 4096 tokens, 112 heads, N = P = 64), at the serving
# prefill's (16, 8, 112, 64, 64) and at a ragged shape (N P = 35, neither a
# multiple of 4 nor of the CTA's 256 threads)
BWD_FA = ({"B": 8, "S": 2048, "H": 32, "KVH": 8, "D": 128, "window": 0,
           "softcap": 0.0},
          {"B": 4, "S": 6144, "H": 8, "KVH": 4, "D": 256, "window": 4096,
           "softcap": 50.0},
          {"B": 4, "S": 4096, "H": 32, "KVH": 8, "D": 128, "window": 0,
           "softcap": 0.0})
BWD_NORM = (16384, 4096)
BWD_SCAN = ((32, 4, 112, 64, 64), (16, 8, 112, 64, 64), (3, 1, 3, 5, 7))
MOE_GROUP = ("MoE routing (topk, one-hot cumsum, gathers into slots, "
             "index_add_)")
TRAIN_GROUPS = (
    ("K8 backward (flash_attention_bwd_*)", ("flash_attention_bwd",)),
    ("K8 forward flash_attention_wgmma_kernel", ("flash_attention",)),
    ("K9 backward (rmsnorm_bwd_*)", ("rmsnorm_bwd",)),
    ("K9 forward rmsnorm_kernel", ("rmsnorm_kernel",)),
    ("K10 backward ssm_state_scan_bwd_kernel", ("ssm_state_scan_bwd",)),
    ("K10 forward ssm_state_scan_kernel", ("ssm_state_scan",)),
    ("GEMMs (cuBLAS: projections, MLP, unembed, SSD's chunk einsums)",
     ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    # MoE's routing and token movement, forward and backward: topk and its
    # sort, the one-hot's scatter and its cumsum (the queue slots), the
    # gathers into and out of the capacity slots (index, index_put and its
    # accumulating backward) and index_add_ (its backward an index_select);
    # the loss's label gather shares the scatter/gather kernel and the
    # embedding's forward the index_select one (both a few MB).  Only the
    # MoE models' traces take this group: Mamba-2's and mLSTM's cumsums
    # run the same scan kernels
    (MOE_GROUP, ("topk", "bitonicsort", "scatter_gather", "scan",
                 "index_elementwise", "indexing_backward", "indexfunc",
                 "indexselect")),
    # torch's elementwise and reduction kernels: Mamba-2's ssd_chunks
    # (its forward device time also by its record_function range), casts,
    # the loss's softmax, the optimizer (its own range)
    ("elementwise and reductions (torch)", ("elementwise", "reduce_kernel")),
)
# the kernels a training step launches, by what its pattern holds: K9 for
# every block's pre-norm and the final norm; K8 where it has attention
# blocks, and K9's residual instance where one of them has a feed-forward
# after it (x + a and ln2 in one launch); K10 where it has Mamba-2 layers;
# K8's window instance where a local layer's window is shorter than the
# sequence (:func:`train_kernels`).  TRAIN_LAUNCHES: a dense model's
TRAIN_NORM = ("rmsnorm", "rmsnorm_bwd")
TRAIN_ATTN = ("flash_attention", "flash_attention_bwd")
TRAIN_RESIDUAL = ("rmsnorm_residual", "rmsnorm_residual_bwd")
TRAIN_LAUNCHES = TRAIN_ATTN + TRAIN_NORM + TRAIN_RESIDUAL
TRAIN_WINDOW = ("flash_attention_window", "flash_attention_bwd_window")
TRAIN_SCAN = ("ssm_state_scan", "ssm_state_scan_bwd")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms of ``fn()`` over ``reps`` runs, CUDA events, after
    ``warmup`` runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_per_call(fn, reps: int) -> tuple[float, str]:
    """Device ms of one call of ``fn`` and how it was read: its CUDA
    kernels' time under ``torch.profiler`` over ``reps`` calls after a
    warm-up, divided by ``reps`` (no host time, which event timing of short
    calls measures).  The profiler does not always record the device's
    events (a run on an H100 once had none for a call it had traced the
    line before); after two such tries the time is read from CUDA events
    around ``reps`` calls enqueued while the stream is held by a sleep
    kernel (:func:`queued_ms`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != DeviceType.CUDA:
                continue
            got = getattr(e, "self_device_time_total", None)
            us += (getattr(e, "self_cuda_time_total", 0) if got is None
                   else got)
        if us > 0.0:
            return us / 1e3 / reps, "profiler"
    return queued_ms(fn, reps), "events behind a sleep"


def queued_ms(fn, reps: int) -> float:
    """Device ms of one call of ``fn``: CUDA events around ``reps`` calls
    enqueued while a sleep kernel holds the stream, so the device runs
    them back to back (their kernels and the gaps between them)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # ~10 ms at the H100's clocks, far longer than enqueueing the calls
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us_per_call(fn, reps: int) -> float:
    """Host µs of one call of ``fn``: the wall clock around ``reps`` calls
    issued back to back, read before the device is waited for (a call whose
    kernel is shorter than its host time never waits on the queue)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t) / reps
    torch.cuda.synchronize()
    return us


def in_turns(fns: dict, measure, rounds: int = 7) -> dict:
    """The median of ``rounds`` measurements of each of ``fns``, taken in
    turns (so a drift of the host's speed reaches each alike)."""
    got = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            got[k].append(measure(fn))
    return {k: statistics.median(v) for k, v in got.items()}


def expr_ops(e, nk: int) -> int:
    """Arithmetic operations of one evaluation of ``e``; a level search
    counts one comparison per layer it marches."""
    from repro_torch.core.stencil.ir import (Const, FieldAccess, FoundLevel,
                                             LevelSearch, ParamRef)

    n = 0 if isinstance(e, (FieldAccess, FoundLevel, ParamRef, Const)) else 1
    if isinstance(e, LevelSearch):
        lo, hi = e.resolve_bounds(nk)
        n = hi - lo - 1
    return n + sum(expr_ops(c, nk) for c in e.children())


def bound(run, fields) -> tuple[float, str]:
    """Least time for one call of a compiled stencil on this card: each
    input field read once and each output written once over the write
    window, against the operations its statements do there.  A field the
    stencil writes is an input too only where a read can see its value from
    before the call (``prior_reads``): not ``pe`` of ``precompute_pe``,
    written at every level before its marching-previous read."""
    from repro_torch.core.backend import cuda as C

    st, dom = run.stencil, run.dom
    lead = 1
    for d in next(iter(fields.values())).shape[:-3]:
        lead *= d

    def stored(f):
        """Members x tiles of ``f`` held in memory: a field broadcast
        across members (stride 0) is read once."""
        if f not in fields or f in run.written:
            return lead
        x = fields[f]
        n = 1
        for size, stride in zip(x.shape[:-3], x.stride()[:-3]):
            n *= size if stride else 1
        return n

    plane = (dom.nj + 2 * dom.extend[1]) * (dom.ni + 2 * dom.extend[0])
    written = set(run.written)
    inputs = (set(st.read_fields()) - written) | C.prior_reads(st, dom.nk)
    nbytes = sum(4 * stored(f) * st.k_extent_of(f, dom.nk) * plane
                 for f in inputs)
    nbytes += sum(4 * lead * st.k_extent_of(f, dom.nk) * plane
                  for f in written)
    ops = 0
    for p in run.programs:
        for s in p.ir.statements:
            klo, khi = s.interval.resolve(st.k_extent_of(s.target, dom.nk))
            ops += expr_ops(s.value, dom.nk) * lead * max(0, khi - klo) * plane
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# input ranges: Courant numbers below 1, a diagonally dominant Thomas solve
RANGES = {"cx": (-0.9, 0.9), "aa": (-0.5, 0.5), "cc": (-0.5, 0.5),
          "bb": (2.0, 3.0)}


def kernel_inputs(stencil, base, dom, rng, device, lead=(6,)):
    """Inputs for one node at its program's shapes: C192 L80 on six tiles
    (``lead`` puts members before them).  Coordinates of the level search
    are monotone columns (``"remap_interp unsorted"``: in random order,
    with NaNs), and the Thomas solve gets a diagonally dominant system."""
    import numpy as np
    import torch

    out = {}
    for f in stencil.fields:
        shape = lead + dom.padded_shape(stencil.is_interface(f))
        lo, hi = RANGES.get(f, (0.5, 1.5))
        a = rng.uniform(lo, hi, shape).astype(np.float32)
        if base == "remap_interp" and f in ("fm", "pe", "pe_ref"):
            a = np.cumsum(a, axis=-3, dtype=np.float32)
        elif base == "remap_interp unsorted" and f in ("pe", "pe_ref"):
            # coordinates and targets in no order, a NaN in one value of
            # 1000 of each
            a = rng.uniform(0.0, 80.0, shape).astype(np.float32)
            a.flat[rng.choice(a.size, a.size // 1000, replace=False)] = np.nan
        out[f] = torch.from_numpy(a).to(device)
    return out


def kernel_phase(device) -> dict:
    """Each kernel against its plain version at C192 L80."""
    import numpy as np
    import torch

    from repro_torch.core.backend import cuda as C
    from repro_torch.fv3 import dyncore as D

    from repro_torch.core.backend import compile_program

    cfg = D.FV3Config(**C192_L80)
    dom = cfg.seq_dom()
    params = D.default_params(cfg)
    progs = {p.name: p for p in (D.build_csw_program(cfg, dom),
                                 D.build_dsw_program(cfg, dom),
                                 D.build_remap_program(cfg, dom))}
    # d_sw at opt 3: its heaviest fused node, one launch of 7 records
    fused = compile_program(D.build_dsw_program(cfg, dom), "cuda",
                            opt_level=3, device=device).program
    progs[FUSED_NODE] = fused
    cases = [("K1", "d_sw", "fx_ppm"), ("K1", "c_sw+riem", "edge_flux"),
             ("K1", "c_sw+riem", "riem_coeffs"),
             ("K1", FUSED_NODE, FUSED_NODE),
             ("K2", "c_sw+riem", "tridiag_solve"),
             ("K2", "vertical_remap", "column_total"),
             ("K3", "vertical_remap", "remap_interp"),
             ("K3", "vertical_remap", "remap_interp unsorted")]
    rng = np.random.default_rng(0)
    rows = []
    for kernel, prog_name, base in cases:
        prog = progs[prog_name]
        node = next(n for n in prog.all_nodes()
                    if n.base_name == base.split()[0]
                    or n.label.split("#")[0] == base)
        ndom = prog.node_dom(node)
        unsorted = base.endswith("unsorted")
        fields = kernel_inputs(node.stencil, base, ndom, rng, device)
        ps = {p: params[p] for p in node.stencil.params}
        run = C.CudaStencil(node.stencil, ndom)
        got = run(fields, ps)
        if unsorted:  # the plain version marching, as the kernel does
            with C.marching_plain():
                want = run.plain(fields, ps)
        else:
            want = run.plain(fields, ps)
        torch.cuda.synchronize()
        err = 0.0
        for w in run.written:
            nan = torch.isnan(want[w])
            if unsorted:  # NaN targets give NaN, in the same places
                if not torch.equal(torch.isnan(got[w]), nan):
                    raise RuntimeError(f"K3 on {base}: NaNs differ")
                got[w], want[w] = got[w].nan_to_num(), want[w].nan_to_num()
            elif not torch.isfinite(got[w]).all():
                raise RuntimeError(f"{base}: non-finite kernel output {w}")
            err = max(err, (got[w] - want[w]).abs().max().item())
            if not torch.allclose(got[w], want[w], rtol=KERNEL_RTOL,
                                  atol=KERNEL_ATOL):
                raise RuntimeError(f"{kernel} on {base}: {w} disagrees with "
                                   f"the plain version (max abs {err:.3e})")
        del got, want
        ms = cuda_ms(lambda: run(fields, ps), 5)
        if unsorted:
            with C.marching_plain():
                plain_ms = cuda_ms(lambda: run.plain(fields, ps), 2)
        else:
            plain_ms = cuda_ms(lambda: run.plain(fields, ps), 2)
        b_ms, b_by = bound(run, fields)
        extra = (" (coordinates in random order, NaNs among them and the "
                 "targets; plain version marching)" if unsorted else
                 " (search coordinate monotone: march and bisection pick "
                 "the same layer)" if kernel == "K3" else
                 f" records={sum(len(p.records()) for p in run.programs)}"
                 if kernel == "K1" else "")
        print(f"[kernel] {kernel} {base:14s} launches/call="
              f"{sum(not p.empty for p in run.programs)} max_abs_err={err:.3e}"
              f" tol=rtol {KERNEL_RTOL:g} + atol {KERNEL_ATOL:g}{extra} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
              f"({b_by})", flush=True)
        rows.append(dict(kernel=kernel, stencil=base, err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        del fields
        torch.cuda.empty_cache()
    return rows


def member_phase(device) -> list:
    """K5: the member axis of K1 (``fx_ppm``) and K2 (``tridiag_solve``) at
    C192 L80 on 4 members under "grid" (one member a thread) and
    "vmap:2,grid" (two), the first read-only input broadcast across
    members at member stride 0, against the plain version."""
    import torch

    from repro_torch.core.backend import cuda as C
    from repro_torch.fv3 import dyncore as D

    cfg = D.FV3Config(**C192_L80)
    dom = cfg.seq_dom()
    params = D.default_params(cfg)
    progs = {p.name: p for p in (D.build_csw_program(cfg, dom),
                                 D.build_dsw_program(cfg, dom))}
    M = 4
    gen = torch.Generator(device=device).manual_seed(1)
    rows = []
    for prog_name, base in (("d_sw", "fx_ppm"),
                            ("c_sw+riem", "tridiag_solve")):
        prog = progs[prog_name]
        node = next(n for n in prog.all_nodes() if n.base_name == base)
        ndom = prog.node_dom(node)
        ps = {p: params[p] for p in node.stencil.params}
        for batch, mchunk in (("grid", 1), ("vmap:2,grid", 2)):
            run = C.CudaStencil(node.stencil, ndom, n_members=M,
                                member_chunk=mchunk)
            bcast = next(f for f in run.stencil.fields
                         if f not in run.written)
            fields = {}
            for f in run.stencil.fields:
                lo, hi = RANGES.get(f, (0.5, 1.5))
                lead = (1, 6) if f == bcast else (M, 6)
                shape = lead + ndom.padded_shape(
                    run.stencil.is_interface(f))
                x = torch.rand(shape, generator=gen,
                               device=device) * (hi - lo) + lo
                fields[f] = x.expand((M,) + tuple(x.shape[1:]))
            got = run(fields, ps)
            want = run.plain(fields, ps)
            torch.cuda.synchronize()
            err = 0.0
            for w in run.written:
                if not torch.isfinite(got[w]).all():
                    raise RuntimeError(f"K5 {base}: non-finite output {w}")
                err = max(err, (got[w] - want[w]).abs().max().item())
                if not torch.allclose(got[w], want[w], rtol=KERNEL_RTOL,
                                      atol=KERNEL_ATOL):
                    raise RuntimeError(f"K5 on {base} ({batch}): {w} "
                                       "disagrees with the plain version "
                                       f"(max abs {err:.3e})")
            del got, want
            ms = cuda_ms(lambda: run(fields, ps), 5)
            plain_ms = cuda_ms(lambda: run.plain(fields, ps), 2)
            b_ms, b_by = bound(run, fields)
            print(f"[kernel] K5 {base:14s} M={M} batch={batch:11s} "
                  f"broadcast={bcast} launches/call="
                  f"{sum(not p.empty for p in run.programs)} "
                  f"max_abs_err={err:.3e} tol=rtol {KERNEL_RTOL:g} + atol "
                  f"{KERNEL_ATOL:g} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
            rows.append(dict(kernel="K5", stencil=base, batch=batch, err=err,
                             ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by))
            del fields
        torch.cuda.empty_cache()
    return rows


def kblocked_phase(device) -> list:
    """K4 on d_sw's ``precompute_pe`` at C192 L80 on six tiles, under the
    K-blocked schedules the reference's TPU tuner gives it (``block_k``
    16) and one shallower slab (8): against its plain version (the
    whole-column march) and against K2 on the same inputs, which it must
    equal exactly and beside which it is timed; then at 4 members under
    "grid" and "vmap:2,grid" (K2 with the same member axis)."""
    import numpy as np
    import torch

    from repro_torch.core.backend import cuda as C
    from repro_torch.core.stencil import Schedule
    from repro_torch.fv3 import dyncore as D

    cfg = D.FV3Config(**C192_L80)
    dom = cfg.seq_dom()
    params = D.default_params(cfg)
    prog = D.build_dsw_program(cfg, dom)
    node = next(n for n in prog.all_nodes() if n.base_name == "precompute_pe")
    ndom = prog.node_dom(node)
    ps = {p: params[p] for p in node.stencil.params}
    rng = np.random.default_rng(4)
    rows = []
    for bk, M, mchunk in ((16, None, 1), (8, None, 1), (16, 4, 1),
                          (16, 4, 2)):
        sched = Schedule(block_k=bk, k_as_grid=False)
        run = C.CudaStencil(node.stencil, ndom, schedule=sched, n_members=M,
                            member_chunk=mchunk)
        if [p.kind for p in run.programs] != ["kblocked"]:
            raise RuntimeError(f"precompute_pe at block_k={bk} did not "
                               "take the K-blocked kernel")
        column = C.CudaStencil(node.stencil, ndom, n_members=M,
                               member_chunk=mchunk)
        depth = C.copy_depth(run.programs[0])
        lead = (6,) if M is None else (M, 6)
        fields = kernel_inputs(node.stencil, "precompute_pe", ndom, rng,
                               device, lead=lead)
        got = run(fields, ps)
        want = run.plain(fields, ps)
        k2 = column(fields, ps)
        torch.cuda.synchronize()
        err = err_k2 = 0.0
        for w in run.written:
            if not torch.isfinite(got[w]).all():
                raise RuntimeError(f"K4 precompute_pe: non-finite output {w}")
            err = max(err, (got[w] - want[w]).abs().max().item())
            err_k2 = max(err_k2, (got[w] - k2[w]).abs().max().item())
            if not torch.allclose(got[w], want[w], rtol=KERNEL_RTOL,
                                  atol=KERNEL_ATOL):
                raise RuntimeError(f"K4 at block_k={bk}: {w} disagrees with "
                                   f"the plain version (max abs {err:.3e})")
        if err_k2 != 0.0:
            raise RuntimeError(f"K4 at block_k={bk} differs from K2 by "
                               f"{err_k2:.3e}")
        del got, want, k2
        ms = cuda_ms(lambda: run(fields, ps), 10)
        k2_ms = cuda_ms(lambda: column(fields, ps), 10)
        plain_ms = cuda_ms(lambda: run.plain(fields, ps), 2)
        b_ms, b_by = bound(run, fields)
        case = ("" if M is None else
                f" M={M} batch={'grid' if mchunk == 1 else 'vmap:2,grid'}")
        print(f"[kernel] K4 precompute_pe block_k={bk}{case} copies "
              f"{depth} levels ahead, launches/call={len(run.programs)} "
              f"max_abs_err={err:.3e} tol=rtol {KERNEL_RTOL:g} + atol "
              f"{KERNEL_ATOL:g}; vs K2 max abs {err_k2:.3e} (must be 0) "
              f"ms={ms:.4f} K2_ms={k2_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        rows.append(dict(kernel="K4", stencil="precompute_pe", block_k=bk,
                         members=M, err=err, ms=ms, k2_ms=k2_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        del fields
        torch.cuda.empty_cache()
    return rows


def table_phase(device) -> None:
    """The stencils past the encoder's old fixed tables (``TABLE_CASES`` of
    ``tests/test_torch_cuda.py``: 70 and 100 fields, 20 parameters, ~1300
    op words, 300 constants, a stack of ~41, a K1 group cut at a statement,
    a K-blocked solver whose marching-previous reads K4's tables cannot
    hold) at C192 L80 on one tile, each against its plain version on the
    same inputs: max abs 0.0, with the launches, their shared memory and
    both times."""
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_cuda import TABLE_CASES

    from repro_torch.core import stencil as S
    from repro_torch.core.backend import cuda as C

    dom = S.DomainSpec(ni=192, nj=192, nk=80, halo=6)
    gen = torch.Generator(device=device).manual_seed(21)
    for case, build in TABLE_CASES.items():
        blocked = case == "K4 tables"
        run = C.CudaStencil(build(S), dom, schedule=S.Schedule(
            block_k=16, k_as_grid=False) if blocked else None)
        if run.kblocked_refused != blocked:
            raise RuntimeError(f"{case}: K4 refusal {run.kblocked_refused}")
        fields = {f: 0.5 + torch.rand(
            (1,) + dom.padded_shape(run.stencil.is_interface(f)),
            generator=gen, device=device) for f in run.stencil.fields}
        params = {p: 0.5 + n / 40 for n, p in enumerate(run.stencil.params)}
        got = run(fields, params)
        want = run.plain(fields, params)
        torch.cuda.synchronize()
        err = 0.0
        for w in run.written:
            if not torch.isfinite(got[w]).all():
                raise RuntimeError(f"{case}: non-finite kernel output {w}")
            err = max(err, (got[w] - want[w]).abs().max().item())
        if err != 0.0:
            raise RuntimeError(f"{case}: the kernels differ from the plain "
                               f"version by {err:.3e}")
        del got, want
        ms = cuda_ms(lambda: run(fields, params), 3)
        plain_ms = cuda_ms(lambda: run.plain(fields, params), 1)
        launches = ", ".join(
            f"{p.kind} ({len(p.prog)} words, {len(p.consts)} constants, "
            f"stack {p.stack}, "
            f"{p.smem_bytes(C.copy_depth(p) if p.block_k else 1)} B of "
            "shared memory)" for p in run.programs)
        print(f"[tables] {case}: {len(run.slot_names)} slots, "
              f"{len(run.stencil.params)} parameters; launches {launches}; "
              f"max_abs_err={err:.3e} (must be 0) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f}", flush=True)
        del fields
        torch.cuda.empty_cache()


def standalone_phase(device) -> dict:
    """K6 and K7 through ``repro_torch.kernels.ops`` at C192 L80 shapes:
    the op calls counted, then each kernel against its plain version, and
    K6 against ``torch.linalg.solve`` on the same systems."""
    import torch

    from repro_torch.kernels import library as KL
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as KR

    gen = torch.Generator(device=device).manual_seed(2)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    nk, npx, h = C192_L80["nk"], C192_L80["npx"], 6
    a, b, c, d = (uniform((nk, 6 * npx, npx), lo, hi) for lo, hi in
                  ((0.1, 0.5), (2.0, 3.0), (0.1, 0.5), (-1.0, 1.0)))
    q = uniform((6 * nk, npx + 2 * h, npx + 2 * h), 1.0, 2.0)
    cx = uniform(q.shape, -0.9, 0.9)
    # the path: the op entry points, once each
    torch.cuda.synchronize()
    KL.reset_launches()
    x = ops.tridiag(a, b, c, d)
    f = ops.fvt_flux(q, cx, halo=h)
    torch.cuda.synchronize()
    launches = {k: KL.LAUNCHES[k] for k in ("tridiag", "fvt_flux")}
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a standalone kernel never launched: {launches}")

    def check(name, got, want, rtol, atol):
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{name}: non-finite kernel output")
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise RuntimeError(f"{name} disagrees with the plain version "
                               f"(max abs {err:.3e})")
        return err

    err6 = check("K6 tridiag f32", x, KR.tridiag_ref(a, b, c, d),
                 KERNEL_RTOL, KERNEL_ATOL)
    d64 = [t.double() for t in (a, b, c, d)]
    err6_64 = check("K6 tridiag f64", ops.tridiag(*d64),
                    KR.tridiag_ref(*d64), F64_RTOL, F64_ATOL)
    ms6_64 = cuda_ms(lambda: ops.tridiag(*d64), 10)
    # f64 doubles the bytes; its operations stay below them
    bound6_64 = 1e3 * 5 * 8 * a.numel() / HBM_BYTES_PER_S
    del d64
    err7 = check("K7 fvt_flux", f, KR.fvt_flux_ref(q, cx, halo=h),
                 KERNEL_RTOL, KERNEL_ATOL)
    ms6 = cuda_ms(lambda: ops.tridiag(a, b, c, d), 10)
    plain6 = cuda_ms(lambda: KR.tridiag_ref(a, b, c, d), 2)
    ms7 = cuda_ms(lambda: ops.fvt_flux(q, cx, halo=h), 10)
    plain7 = cuda_ms(lambda: KR.fvt_flux_ref(q, cx, halo=h), 2)
    # bounds: K6 reads a, b, c, d and writes x; 8 flops a point (forward
    # 6, back substitution 2).  K7 reads q, cx and writes fx; 32 flops on
    # each interior point (three interface values, the upwind branch taken,
    # the clip, the product), none on the halo columns.
    t6 = (5 * 4 * a.numel() / HBM_BYTES_PER_S, 8 * a.numel() / F32_OPS_PER_S)
    interior = q.shape[0] * q.shape[1] * (q.shape[2] - 2 * h)
    t7 = (3 * 4 * q.numel() / HBM_BYTES_PER_S, 32 * interior / F32_OPS_PER_S)
    # the library yardstick: one dense batched solve of the same systems,
    # the matrices built outside the timed window
    def by_column(t):
        return t.reshape(nk, -1).t()

    idx = torch.arange(nk, device=device)
    A = torch.zeros((6 * npx * npx, nk, nk), device=device)
    A[:, idx, idx] = by_column(b)
    A[:, idx[1:], idx[:-1]] = by_column(a)[:, 1:]
    A[:, idx[:-1], idx[1:]] = by_column(c)[:, :-1]
    rhs = by_column(d).unsqueeze(-1)
    lib_x = torch.linalg.solve(A, rhs)
    lib_err = (lib_x.squeeze(-1) - by_column(x)).abs().max().item()
    del lib_x
    lib6 = cuda_ms(lambda: torch.linalg.solve(A, rhs), 2)
    del A, rhs
    torch.cuda.empty_cache()
    rows = {}
    for key, name, err, ms, plain_ms, (tb, to), lib in (
            ("K6", f"tridiag {tuple(a.shape)} f32", err6, ms6, plain6, t6,
             lib6),
            ("K7", f"fvt_flux {tuple(q.shape)} halo {h}", err7, ms7, plain7,
             t7, None)):
        b_ms, b_by = 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")
        extra = (f" f64_max_abs_err={err6_64:.3e} (tol {F64_RTOL:g}) "
                 f"f64_ms={ms6_64:.4f} f64_bound_ms={bound6_64:.4f} (bytes);"
                 f" torch.linalg.solve library_ms={lib:.4f} (max abs diff "
                 f"to the kernel {lib_err:.3e})" if key == "K6" else "")
        count = launches["tridiag" if key == "K6" else "fvt_flux"]
        print(f"[kernel] {key} {name} launches={count} "
              f"max_abs_err={err:.3e} tol=rtol {KERNEL_RTOL:g} + atol "
              f"{KERNEL_ATOL:g} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}){extra}", flush=True)
        rows[key] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib)
    rows["K6"]["err"] = max(err6, err6_64)
    rows["K6"]["f64_ms"], rows["K6"]["f64_bound_ms"] = ms6_64, bound6_64
    return {"rows": rows, "launches": launches}


def interior(x, cfg):
    h, n = cfg.halo, cfg.npx
    return x[..., h:h + n, h:h + n]


def device_rows(prof, ranges: tuple = ()) -> tuple[list, dict]:
    """The device events of a finished ``torch.profiler`` run, read from
    its raw events (``key_averages`` builds a Python object for each event
    and links them, which is slow over the hundreds of thousands of events
    of a host-bound prefill): rows of (ms, launches, name) summed by name
    over kernels, copies and fills, and, for each of ``ranges``, (ms,
    calls, host ms): the device time of the events that host ops inside the
    range launched (linked by correlation id, as ``key_averages`` links
    them, on any stream), the range's host-side calls and their wall time
    on the host."""
    import bisect

    from torch.autograd import DeviceType

    by_name, spans, ops, linked = {}, {r: [] for r in ranges}, [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != DeviceType.CUDA:
            if name in spans:
                spans[name].append((e.start_ns(), e.end_ns()))
            elif ranges:
                ops.append((e.start_ns(), e.correlation_id()))
            continue
        if name in spans or name in MODEL_RANGES:
            continue  # a range's device-side twin spans its kernels
        ns = e.duration_ns()
        row = by_name.setdefault(name, [0, 0])
        row[0] += ns
        row[1] += 1
        if ranges:
            linked.append((e.linked_correlation_id(), ns))
    rows = [(ns / 1e6, n, name) for name, (ns, n) in by_name.items()
            if ns > 0]
    in_ranges = {}
    for r, sp in spans.items():
        sp.sort()
        firsts = [lo for lo, _ in sp]

        def inside(t, sp=sp, firsts=firsts):
            i = bisect.bisect_right(firsts, t) - 1
            return i >= 0 and t < sp[i][1]

        ids = {corr for t, corr in ops if inside(t)}
        in_ranges[r] = (sum(ns for corr, ns in linked if corr in ids) / 1e6,
                        len(sp), sum(hi - lo for lo, hi in sp) / 1e6)
    return rows, in_ranges


def check_device_rows(prof, rows: list) -> None:
    """Hold :func:`device_rows`' sums by name against the profiler's own
    reader, ``key_averages``' self device time of each device event name
    (both read the same raw events; ``key_averages`` keeps microseconds,
    truncated to whole ones by some versions, so each launch may differ by
    1 us).  Raises if a name is missing from either or its time differs."""
    from torch.autograd import DeviceType
    try:
        from torch.autograd.profiler_util import _rewrite_name
    except ImportError:
        def _rewrite_name(name, with_wildcard=False):
            return name

    theirs = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        got = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0) if got is None else got
        if us > 0:
            theirs[e.key] = theirs.get(e.key, 0.0) + us / 1e3
    ours = {}
    for ms, n, name in rows:
        key = _rewrite_name(name, with_wildcard=True)
        got = ours.setdefault(key, [0.0, 0])
        got[0] += ms
        got[1] += n
    bad = sorted(set(theirs) ^ set(ours)) + [
        k for k, (ms, n) in ours.items()
        if k in theirs and abs(ms - theirs[k]) > 1e-3 * n + 1e-6]
    worst = max([abs(ms - theirs[k]) for k, (ms, _) in ours.items()
                 if k in theirs] + [0.0])
    print(f"[trace] reader check: {len(ours)} device event names; "
          f"device_rows {sum(ms for ms, _ in ours.values()):.6f} ms, "
          f"key_averages {sum(theirs.values()):.6f} ms; worst difference "
          f"of a name {worst:.6f} ms: "
          f"{'agree' if not bad else 'DISAGREE'}", flush=True)
    if bad:
        raise RuntimeError("the trace reader disagrees with key_averages on "
                           + "; ".join(f"{k[:60]}: {ours.get(k, [None])[0]}"
                                       f" vs {theirs.get(k)} ms"
                                       for k in bad[:5]))


def trace_step(step, state, step_ms: float,
               untraced: str = "median of steps 2-3",
               groups: tuple = (), split_out: dict | None = None,
               ranges: tuple = (), check_reader: bool = False,
               list_group: str | None = None) -> float | None:
    """One more step under ``torch.profiler``: device time by kernel, and the
    device's idle share of an untraced step.  The profiler's host cost
    lengthens the traced step's wall time, so the share is taken against
    ``step_ms``, the median untraced step (``untraced`` says which): every
    step launches the same kernels on the same shapes, so its device time is
    the traced step's.  ``groups`` of (label, name fragments) also sum the
    device time of the kernels whose names hold a fragment, the first group
    that matches taking a kernel, the rest under "other"; ``split_out``
    receives them, label -> (ms, launches).  ``ranges`` names
    ``record_function`` ranges whose kernels' device time is printed (and
    put in ``split_out``) too, beside the host's wall time inside them.
    ``check_reader`` holds the trace reader against the profiler's own
    (:func:`check_device_rows`): a small step's.  ``list_group``: the label
    of a group whose kernels are printed one by one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    rows, in_ranges = device_rows(prof, ranges)
    print(f"[trace] traced in {t1 - t0:.1f} s, read in "
          f"{time.perf_counter() - t1:.1f} s")
    if check_reader:
        check_device_rows(prof, rows)
    for name, (ms, calls, wall) in in_ranges.items():
        print(f"[trace] range {name}: {ms:.3f} ms of device time in "
              f"{calls} calls, {wall:.3f} ms of host wall time in them")
        if split_out is not None:
            split_out[name] = (ms, calls)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print("[trace] device time: not measured (the profiler recorded no "
              "device events)")
        return None
    rows.sort(reverse=True)
    print(f"[trace] device busy in the traced step {busy:.3f} ms; untraced "
          f"step wall ({untraced}) {step_ms:.3f} ms; device idle "
          f"share of the untraced step {1 - busy / step_ms:.4f}")
    for ms, n, key in rows[:8]:
        print(f"[trace]   {ms:10.3f} ms {100 * ms / busy:5.1f}% x{n:5d} "
              f"{key[:70]}")
    if groups:
        split = {label: [0.0, 0] for label, _ in groups + (("other", ()),)}
        listed = []
        for ms, n, key in rows:
            label = next((g for g, frags in groups
                          if any(f in key.lower() for f in frags)), "other")
            split[label][0] += ms
            split[label][1] += n
            if label == list_group:
                listed.append((ms, n, key))
        for label, (ms, n) in split.items():
            print(f"[trace] split {ms:10.3f} ms {100 * ms / busy:5.1f}% "
                  f"x{n:5d} {label}")
        for ms, n, key in listed:
            print(f"[trace]   {list_group.split(' (')[0]}: {ms:10.3f} ms "
                  f"x{n:5d} {key[:90]}")
        if split_out is not None:
            split_out.update(split)
    return 1 - busy / step_ms


def path_phase(device) -> dict:
    """Three C192 L80 steps through the kernels; step 1 against the plain
    step on the card."""
    import torch

    from repro_torch.core.backend import cuda as C
    from repro_torch.fv3 import dyncore as D
    from repro_torch.fv3 import state as S

    cfg = D.FV3Config(**C192_L80)
    t0 = time.perf_counter()
    step = D.make_step_sequential(cfg, opt_level=0, device=device)
    s0 = S.init_state(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    m0 = S.total_mass(s0, cfg)
    torch.cuda.reset_peak_memory_stats()
    C.reset_launches()
    st, times, s1 = s0, [], None
    for i in range(3):
        t = time.perf_counter()
        st = step(st)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if i == 0:
            s1 = st
    launches = dict(C.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if min(launches[k] for k in ("horizontal", "column", "search")) <= 0:
        raise RuntimeError(f"a kernel of the path never launched: {launches}")
    for k, v in st.items():
        if tuple(v.shape) != tuple(s0[k].shape):
            raise RuntimeError(f"{k}: shape {tuple(v.shape)} after 3 steps")
        if not torch.isfinite(interior(v, cfg)).all():
            raise RuntimeError(f"{k}: non-finite values after 3 steps")
    drift = (S.total_mass(st, cfg) - m0) / m0
    if abs(drift) >= MASS_RTOL:
        raise RuntimeError(f"total mass drifted by {drift:.3e}")
    del st
    plain_step = D.make_step_sequential(cfg, backend="torch", opt_level=0,
                                        device=device)
    t = time.perf_counter()
    p1 = plain_step(s0)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    errs = {k: (interior(s1[k], cfg) - interior(p1[k], cfg)).abs().max().item()
            for k in s1}
    worst = max(errs.values())
    step_ms = 1e3 * statistics.median(times[1:])
    per_step = {k: v / 3 for k, v in launches.items()}
    print(f"[path] C192 L80, {step.n_kernels} stencil nodes, setup "
          f"{setup_s:.2f} s", flush=True)
    print(f"[path] step ms: {[round(1e3 * t, 3) for t in times]} -> median "
          f"of steps 2-3 = {step_ms:.3f} ms; plain torch step 1 = "
          f"{1e3 * plain_s:.3f} ms")
    print(f"[path] launches per step: {per_step}")
    print(f"[path] step 1 vs plain step, interior max abs err per field: "
          + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + f"; tol {STEP_ATOL:g}")
    print(f"[path] peak device memory {peak / 2**30:.3f} GiB; total mass "
          f"drift over 3 steps {drift:.3e} (tol {MASS_RTOL:g})", flush=True)
    if worst >= STEP_ATOL:
        raise RuntimeError(f"step 1 disagrees with the plain step: {errs}")
    del plain_step
    trace_step(step, s1, step_ms)
    return {"launches": launches, "step_ms": step_ms, "s0": s0,
            "plain1": p1}


ENSEMBLE_CASES = (  # members, batch, steps, launches per step / M=1's
    (4, "grid", 3, 1),
    (4, "vmap:2,grid", 1, 1),
    (6, "vmap:4", 1, 2),
)


def ensemble_phase(device, seq_launches: dict) -> dict:
    """C192 L80 ensemble steps: step 1 of each case against M
    single-member sequential steps on the member slices (exactly equal),
    and its launches per step against the sequential path's."""
    import torch

    from repro_torch.core.backend import cuda as C
    from repro_torch.fv3 import dyncore as D
    from repro_torch.fv3 import state as S

    cfg = D.FV3Config(**C192_L80)
    seq = D.make_step_sequential(cfg, opt_level=0, device=device)
    seq_step = {k: v / 3 for k, v in seq_launches.items()}  # 3 steps
    out, ens = {}, None
    for M, batch, n_steps, factor in ENSEMBLE_CASES:
        if ens is None or ens["pt"].shape[0] != M:
            ens = None
            t = time.perf_counter()
            ens = S.ensemble_state(cfg, M, seed=0, device=device)
            print(f"[ensemble] ensemble_state(C192 L80, M={M}) "
                  f"{time.perf_counter() - t:.2f} s", flush=True)
        step = D.make_step_ensemble(cfg, M, batch=batch, opt_level=0,
                                    device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        C.reset_launches()
        st, times, s1 = ens, [], None
        for i in range(n_steps):
            t = time.perf_counter()
            st = step(st)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            if i == 0:
                s1 = st
        launches = dict(C.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        del st
        per_step = {k: v / n_steps for k, v in launches.items()}
        want = {k: factor * seq_step[k]
                for k in ("horizontal", "column", "kblocked", "search")}
        want["member"] = want["horizontal"] + want["column"]
        diffs = dict.fromkeys(s1, 0.0)
        for m in range(M):
            single = seq({k: v[m] for k, v in ens.items()})
            for k, v in single.items():
                diffs[k] = max(diffs[k], (s1[k][m] - v).abs().max().item())
            del single
        spread = max((s1[k][1:] - s1[k][:1]).abs().max().item() for k in s1)
        finite = all(torch.isfinite(interior(v, cfg)).all().item()
                     for v in s1.values())
        step_ms = 1e3 * (statistics.median(times[1:]) if n_steps > 1
                         else times[0])
        which = "median of steps 2-3" if n_steps > 1 else "step 1"
        print(f"[ensemble] M={M} batch={batch}: {step.n_kernels} stencil "
              f"nodes, {step.n_chunks or 1} chunk(s) of "
              f"{step.member_chunk or M}; step ms "
              f"{[round(1e3 * t, 3) for t in times]} -> {which} "
              f"{step_ms:.3f} ms, {step_ms / M:.3f} ms per member-step",
              flush=True)
        print(f"[ensemble] M={M} batch={batch}: launches per step {per_step}"
              f" (sequential path x{factor}: {want})")
        print(f"[ensemble] M={M} batch={batch}: step 1 vs {M} single-member "
              "steps, max abs difference per field over whole arrays: "
              + ", ".join(f"{k}={v:.3e}" for k, v in diffs.items())
              + f"; largest difference between members {spread:.3e}")
        print(f"[ensemble] M={M} batch={batch}: peak device memory "
              f"{peak / 2**30:.3f} GiB", flush=True)
        if any(v != 0.0 for v in diffs.values()) or not finite:
            raise RuntimeError(f"ensemble step ({batch}, M={M}) differs from "
                               f"the single-member steps: {diffs}")
        if per_step != want:
            raise RuntimeError(f"ensemble step ({batch}, M={M}) launches "
                               f"{per_step}, expected {want}")
        if spread <= 0.0:
            raise RuntimeError("the ensemble members do not differ")
        out[(M, batch)] = {"launches": launches, "step_ms": step_ms,
                           "peak": peak}
        del s1, step
        torch.cuda.empty_cache()
    return out


def stream_work(fn, tiles: int = 6) -> dict:
    """What one call of a compiled program asks of the kernels: launches by
    kind, and the ops, field loads and stores the interpreter executes over
    all points, from each launch's per-statement counts
    (``Program.work``)."""
    from repro_torch.core.backend import cuda as C

    work = {"horizontal": 0, "column": 0, "kblocked": 0, "ops": 0,
            "k1_ops": 0, "loads": 0, "distinct": 0, "stores": 0}
    for node in fn.program.all_nodes():
        run = C.CudaStencil(node.stencil, fn.program.node_dom(node),
                            schedule=node.schedule)
        for prog in run.programs:
            if prog.empty:
                continue
            work[prog.kind] += 1
            for pts, ops, loads, distinct, stores in prog.work():
                work["ops"] += ops * tiles * pts
                if prog.kind == "horizontal":
                    work["k1_ops"] += ops * tiles * pts
                work["loads"] += loads * tiles * pts
                work["distinct"] += distinct * tiles * pts
                work["stores"] += stores * tiles * pts
    return work


def opt_phase(device) -> dict:
    """The four step programs at C192 L80 through the optimizer at opt 0-4
    for the default (H100) preset, verified after every pass, each compiled
    onto the kernels; per level, what a step asks of the kernels (each
    acoustic program runs n_split * k_split times a step, the others
    k_split times)."""
    from repro_torch.fv3 import dyncore as D
    from repro_torch.core.backend import compile_program

    cfg = D.FV3Config(**C192_L80)
    calls = {"c_sw+riem": cfg.n_split * cfg.k_split,
             "d_sw": cfg.n_split * cfg.k_split,
             "tracer_2d": cfg.k_split, "vertical_remap": cfg.k_split}
    levels = {}
    for level in range(5):
        total = 0
        step_work: dict = {}
        for prog in D._build_programs(cfg, cfg.seq_dom()):
            t = time.perf_counter()
            fn = compile_program(prog, "cuda", opt_level=level,
                                 verify="passes", device=device)
            secs = time.perf_counter() - t
            rep = fn.opt_report
            rules = dict(rep.rules) if rep else {}
            viol = rep.total_verify_violations if rep else 0
            scheds = [f"{n.label.split('#')[0][:48]}: "
                      + (n.schedule.describe() if n.schedule else "untuned")
                      for n in fn.program.all_nodes()
                      if n.stencil.is_vertical_solver()]
            total += fn.n_kernels
            for k, v in stream_work(fn).items():
                step_work[k] = step_work.get(k, 0) + calls[prog.name] * v
            print(f"[opt] opt{level} {prog.name:14s} n_kernels="
                  f"{fn.n_kernels:3d} verify_violations={viol} "
                  f"compile {secs:.2f} s rules={rules}")
            for line in scheds:
                print(f"[opt]     solver {line}")
        print(f"[opt] opt{level} step: {total} stencil nodes (hardware "
              f"{fn.hardware}); per step: launches K1 "
              f"{step_work['horizontal']} K2 {step_work['column']} K4 "
              f"{step_work['kblocked']}; interpreted ops "
              f"{step_work['ops'] / 1e9:.2f} G, field loads "
              f"{step_work['loads'] / 1e9:.2f} G (distinct per record "
              f"{step_work['distinct'] / 1e9:.2f} G), stores "
              f"{step_work['stores'] / 1e9:.2f} G", flush=True)
        levels[level] = step_work
    return levels


def opt3_phase(device, path: dict, work: dict) -> dict:
    """The reference's default path at C192 L80: the opt-3 step for the
    H100 preset (3 steps), then for the reference's TPU preset, where K4
    runs d_sw's ``precompute_pe``, then one M = 4 opt-3 ensemble step.
    ``work`` is the opt phase's count of a step's interpreted ops by
    level, which the traced step's K1 time turns into a rate."""
    import torch

    from repro_torch.core.backend import cuda as C
    from repro_torch.fv3 import dyncore as D
    from repro_torch.fv3 import state as S

    cfg = D.FV3Config(**C192_L80)
    s0, p1 = path["s0"], path["plain1"]
    m0 = S.total_mass(s0, cfg)
    out = {}
    s1_default = None
    for hw in (None, OPT3_HARDWARE):
        name = hw or "default (h100)"
        t = time.perf_counter()
        step = D.make_step_sequential(cfg, hardware=hw, device=device)
        setup_s = time.perf_counter() - t
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        C.reset_launches()
        st, times, s1 = s0, [], None
        for i in range(3):
            t = time.perf_counter()
            st = step(st)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            if i == 0:
                s1 = st
        launches = dict(C.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        per_step = {k: v / 3 for k, v in launches.items()}
        for k, v in st.items():
            if not torch.isfinite(interior(v, cfg)).all():
                raise RuntimeError(f"opt-3 {name}: {k} non-finite")
        drift = (S.total_mass(st, cfg) - m0) / m0
        del st
        errs = {k: (interior(s1[k], cfg) - interior(p1[k], cfg)).abs().max()
                .item() for k in s1}
        step_ms = 1e3 * statistics.median(times[1:])
        print(f"[opt3] hardware={name}: {step.n_kernels} stencil nodes, "
              f"setup {setup_s:.2f} s; step ms "
              f"{[round(1e3 * x, 3) for x in times]} -> median of steps 2-3 "
              f"= {step_ms:.3f} ms", flush=True)
        print(f"[opt3] hardware={name}: launches per step {per_step}; peak "
              f"device memory {peak / 2**30:.3f} GiB; mass drift over 3 "
              f"steps {drift:.3e} (tol {MASS_RTOL:g})")
        close = all(torch.allclose(interior(s1[k], cfg),
                                   interior(p1[k], cfg), rtol=OPT_RTOL,
                                   atol=OPT_ATOL) for k in s1)
        print(f"[opt3] hardware={name}: step 1 vs the plain opt-0 torch "
              "step, interior max abs err per field: "
              + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
              + f"; tol rtol {OPT_RTOL:g} + atol {OPT_ATOL:g}", flush=True)
        if not close:
            raise RuntimeError(f"opt-3 step ({name}) disagrees with the "
                               f"plain opt-0 step: {errs}")
        if abs(drift) >= MASS_RTOL:
            raise RuntimeError(f"opt-3 step ({name}): mass drift {drift:.3e}")
        need = ("horizontal", "column", "search")
        if min(launches[k] for k in need) <= 0:
            raise RuntimeError(f"opt-3 step ({name}): a kernel of the path "
                               f"never launched: {launches}")
        if hw is None:
            s1_default = s1
            if launches["kblocked"] != 0:
                raise RuntimeError("the H100 preset K-blocked a solver")
            # the same opt-3 programs on the plain lowering: the kernels'
            # share of the difference above
            plain3 = D.make_step_sequential(cfg, backend="torch",
                                            device=device)
            t = time.perf_counter()
            q1 = plain3(s0)
            torch.cuda.synchronize()
            plain3_ms = 1e3 * (time.perf_counter() - t)
            errs3 = {k: (interior(s1[k], cfg) - interior(q1[k], cfg)).abs()
                     .max().item() for k in s1}
            del q1, plain3
            print(f"[opt3] hardware={name}: step 1 vs the plain opt-3 torch "
                  f"step ({plain3_ms:.3f} ms), interior max abs err per "
                  "field: " + ", ".join(f"{k}={v:.3e}"
                                        for k, v in errs3.items())
                  + f"; tol {STEP_ATOL:g}", flush=True)
            if max(errs3.values()) >= STEP_ATOL:
                raise RuntimeError(f"the opt-3 step disagrees with the plain "
                                   f"opt-3 step: {errs3}")
            if per_step["horizontal"] >= K1_LAUNCH_BAR:
                raise RuntimeError(f"{per_step['horizontal']} K1 launches a "
                                   f"step, not below {K1_LAUNCH_BAR}")
            split: dict = {}
            trace_step(step, s1, step_ms, split_out=split,
                       groups=(("K1", ("stencil_parallel_kernel",)),
                               ("K2", ("stencil_column_kernel",))))
            if "K1" in split:
                k1_ms = split["K1"][0]
                print(f"[opt3] hardware={name}: K1 {k1_ms:.3f} ms of device "
                      f"time in the traced step, {split['K1'][1]} launches; "
                      f"{work[3]['k1_ops'] / k1_ms / 1e9:.3f} G interpreted "
                      f"ops per ms ({work[3]['k1_ops'] / 1e9:.2f} G of K1's "
                      "a step)",
                      flush=True)
        else:
            k4_per_step = cfg.n_split * cfg.k_split  # d_sw per substep
            if per_step["kblocked"] != k4_per_step:
                raise RuntimeError(f"K4 launched {per_step['kblocked']} "
                                   f"times a step, expected {k4_per_step}")
            diffs = {k: (interior(s1[k], cfg) - interior(s1_default[k], cfg))
                     .abs().max().item() for k in s1}
            whole = max((s1[k] - s1_default[k]).abs().max().item()
                        for k in s1)
            print(f"[opt3] hardware={name} vs default: step 1 interior max "
                  "abs difference per field: "
                  + ", ".join(f"{k}={v:.3e}" for k, v in diffs.items())
                  + f" (must be 0); whole arrays {whole:.3e}", flush=True)
            if any(v != 0.0 for v in diffs.values()):
                raise RuntimeError(f"the opt-3 step on {hw} schedules differs "
                                   f"from the default: {diffs}")
            trace_step(step, s1, step_ms,
                       groups=(("K1", ("stencil_parallel_kernel",)),
                               ("K2", ("stencil_column_kernel",)),
                               ("K4", ("stencil_kblocked_kernel",))))
        out[hw] = {"launches": launches, "step_ms": step_ms, "peak": peak}
        del s1, step
        torch.cuda.empty_cache()
    # the distributed phase holds its step 1 against this one
    out["s1"] = s1_default
    del s1_default
    # the member axis on the opt-3 path: K4's carry resets per member
    M = 4
    ens = S.ensemble_state(cfg, M, seed=0, device=device)
    step_e = D.make_step_ensemble(cfg, M, batch="grid",
                                  hardware=OPT3_HARDWARE, device=device)
    seq = D.make_step_sequential(cfg, hardware=OPT3_HARDWARE, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    C.reset_launches()
    t = time.perf_counter()
    e1 = step_e(ens)
    torch.cuda.synchronize()
    ens_ms = 1e3 * (time.perf_counter() - t)
    launches = dict(C.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    diffs = dict.fromkeys(e1, 0.0)
    for m in range(M):
        single = seq({k: v[m] for k, v in ens.items()})
        for k, v in single.items():
            diffs[k] = max(diffs[k], (e1[k][m] - v).abs().max().item())
        del single
    spread = max((e1[k][1:] - e1[k][:1]).abs().max().item() for k in e1)
    print(f"[opt3] ensemble M={M} batch=grid hardware={OPT3_HARDWARE}: "
          f"{step_e.n_kernels} stencil nodes; step 1 {ens_ms:.3f} ms, "
          f"{ens_ms / M:.3f} ms per member-step; launches {launches}; peak "
          f"{peak / 2**30:.3f} GiB", flush=True)
    print(f"[opt3] ensemble step 1 vs {M} single opt-3 steps, max abs "
          "difference per field over whole arrays: "
          + ", ".join(f"{k}={v:.3e}" for k, v in diffs.items())
          + f"; largest difference between members {spread:.3e}", flush=True)
    if any(v != 0.0 for v in diffs.values()) or spread <= 0.0:
        raise RuntimeError(f"the opt-3 ensemble step differs from its single "
                           f"steps: {diffs} (spread {spread:.3e})")
    want_k4 = cfg.n_split * cfg.k_split
    every = launches["horizontal"] + launches["column"] + launches["kblocked"]
    if launches["kblocked"] != want_k4 or launches["member"] != every:
        raise RuntimeError(f"opt-3 ensemble launches {launches}, expected "
                           f"{want_k4} K4 launches and every launch over "
                           "the member axis")
    out["ensemble"] = {"launches": launches, "step_ms": ens_ms,
                       "peak": peak}
    return out


# the distributed phase: C192 L80 over a (6, 2, 2) rank mesh, 24 ranks of
# 96 x 96 held by this process; and the member axis at layout (1, 1)
DIST_LAYOUT = (2, 2)
DIST_MEMBERS = 2
DIST_KERNELS = (("K1", ("stencil_parallel_kernel",)),
                ("K2", ("stencil_column_kernel",)),
                ("K4", ("stencil_kblocked_kernel",)))


def distributed_phase(device, s0: dict, seq1: dict) -> dict:
    """The distributed step on the card: 3 overlapped opt-3 steps (step 1
    against ``seq1``, the opt-3 sequential step 1 from ``s0``), a traced
    step, opt 4 against opt 3 without overlap, the exchanger alone against
    ``exchange_reference``, the split runners' strips on the kernels against
    the plain lowering, and the member axis."""
    import torch

    from repro_torch.core.backend import cuda as C
    from repro_torch.fv3 import dyncore as D
    from repro_torch.fv3 import halo as H
    from repro_torch.fv3 import state as S
    from repro_torch.fv3.mesh import make_mesh
    from repro_torch.fv3.overlap import make_overlapped_runner

    t_phase = time.perf_counter()
    cfg = D.FV3Config(layout=DIST_LAYOUT, **C192_L80)
    py, px = DIST_LAYOUT
    mesh = make_mesh((6, py, px), ("tile", "y", "x"))
    m0 = S.total_mass(s0, cfg)
    t = time.perf_counter()
    step = D.make_step_distributed(cfg, mesh, device=device)
    blocks = S.blocks_from_global(s0, cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    if not step.overlapped:
        raise RuntimeError("the C192 L80 layout (2, 2) step did not overlap")
    torch.cuda.reset_peak_memory_stats()
    C.reset_launches()
    ex0 = step.counters["exchanges"]
    st, times, b1 = blocks, [], None
    for i in range(3):
        t = time.perf_counter()
        st = step(st)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if i == 0:
            b1 = st
    launches = dict(C.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    exchanges = (step.counters["exchanges"] - ex0) / 3
    g3 = S.global_from_blocks(st, cfg)
    for k, v in g3.items():
        if not torch.isfinite(interior(v, cfg)).all():
            raise RuntimeError(f"distributed step: {k} non-finite")
    drift = (S.total_mass(g3, cfg) - m0) / m0
    del st, g3
    g1 = S.global_from_blocks(b1, cfg)
    cells, away = corner_split(g1, seq1, global_corners(cfg, device), cfg)
    errs = {k: v["err"] for k, v in cells.items()}
    del g1
    step_ms = 1e3 * statistics.median(times[1:])
    per_step = {k: v / 3 for k, v in launches.items()}
    print(f"[distributed] C192 L80 layout {DIST_LAYOUT}: {mesh.size} ranks of "
          f"{cfg.n_local} x {cfg.n_local} in one process, opt 3 (h100), "
          f"overlapped {step.overlapped}, {step.n_kernels} stencil nodes, "
          f"setup {setup_s:.2f} s", flush=True)
    print(f"[distributed] step ms {[round(1e3 * x, 3) for x in times]} -> "
          f"median of steps 2-3 = {step_ms:.3f} ms; launches per step "
          f"{per_step}; exchange passes per step {exchanges:g}")
    worst = max(cells, key=lambda k: cells[k]["err"])
    print(f"[distributed] step 1 vs the sequential opt-3 step 1, interior "
          "max abs err per field: "
          + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + f"; tol {STEP_ATOL:g}; worst field {worst} "
          f"{describe_cell(cells[worst])}; away from the tiles' corners "
          f"{max(away.values()):.3e} (must be 0)")
    print(f"[distributed] peak device memory {peak / 2**30:.3f} GiB; total "
          f"mass drift over 3 steps {drift:.3e} (tol {MASS_RTOL:g})",
          flush=True)
    if max(errs.values()) >= STEP_ATOL or max(away.values()) != 0.0:
        raise RuntimeError(f"the distributed step disagrees with the "
                           f"sequential step: {errs}, away from the "
                           f"corners {away}")
    if abs(drift) >= MASS_RTOL:
        raise RuntimeError(f"distributed step: mass drift {drift:.3e}")
    if min(launches[k] for k in ("horizontal", "column", "search")) <= 0:
        raise RuntimeError(f"a kernel of the distributed step never "
                           f"launched: {launches}")
    split: dict = {}
    idle = trace_step(step, b1, step_ms, split_out=split,
                      groups=DIST_KERNELS, ranges=("halo_exchange",))
    del step
    torch.cuda.empty_cache()

    # opt 4 against opt 3, the exchange before the compute
    plain_steps = {}
    for level in (3, 4):
        stp = D.make_step_distributed(cfg, mesh, opt_level=level,
                                      overlap=False, device=device)
        e0 = stp.counters["exchanges"]
        t = time.perf_counter()
        plain_steps[level] = stp(blocks)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        print(f"[distributed] opt {level}, overlap=False: step 1 {ms:.3f} ms;"
              f" delpc_exchange_skipped {stp.delpc_exchange_skipped}; "
              f"exchange passes per step {stp.counters['exchanges'] - e0}",
              flush=True)
        del stp
    # the widened rim equals the exchanged one wherever a neighbour's
    # interior lies there, but not at a cube corner's diagonal ghost cell
    # (see ``corner_split``): bit for bit away from the tiles' corners, and
    # within STEP_ATOL near them, with the worst cell reported
    g3, g4 = (S.global_from_blocks(plain_steps[lv], cfg) for lv in (3, 4))
    near, away = corner_split(g4, g3, global_corners(cfg, device), cfg)
    del g3, g4
    print("[distributed] opt 4 vs opt 3 (overlap=False), interior max abs "
          "difference away from the tiles' corners (must be 0): "
          + ", ".join(f"{k}={v:.3e}" for k, v in away.items()))
    print(f"[distributed] ... within the halo width of a tile's corner "
          f"(tol {STEP_ATOL:g}): "
          + ("; ".join(f"{k} {describe_cell(v)}" for k, v in near.items()
                       if v["cells"]) or "no cell differs"), flush=True)
    if any(v != 0.0 for v in away.values()):
        raise RuntimeError(f"the opt-4 distributed step differs from opt 3 "
                           f"away from the tiles' corners: {away}")
    if max(v["err"] for v in near.values()) >= STEP_ATOL:
        raise RuntimeError(f"the opt-4 distributed step differs from opt 3 "
                           f"near a tile's corner: {near}")
    del plain_steps
    torch.cuda.empty_cache()

    # the exchanger alone: every state field with the (u, v) pair
    g1 = S.global_from_blocks(b1, cfg)
    exchanger = H.make_halo_exchanger(cfg.decomposition(), mesh)
    stack = {k: v.reshape((-1,) + tuple(v.shape[-3:])) for k, v in
             S.blocks_from_global(g1, cfg).items()}
    got = exchanger(stack, vector_pairs=[("u", "v")])
    want = S.blocks_from_global(
        H.exchange_reference(g1, cfg.halo, vector_pairs=[("u", "v")]), cfg)
    diff = max((got[k].reshape(want[k].shape) - want[k]).abs().max().item()
               for k in want)
    ex_ms = cuda_ms(lambda: exchanger(stack, vector_pairs=[("u", "v")]),
                    reps=5)
    print(f"[distributed] exchanger, {len(stack)} fields with (u, v), "
          f"{len(exchanger.rounds)} rounds: {ex_ms:.3f} ms an exchange; max "
          f"abs difference to exchange_reference {diff:.3e} (must be 0)",
          flush=True)
    if diff != 0.0 or not all(torch.equal(got[k].reshape(want[k].shape),
                                          want[k]) for k in want):
        raise RuntimeError("the exchanger differs from exchange_reference")
    del got, want, g1

    # the split runners' strips (6-wide domains) on the kernels against the
    # same runners on the plain lowering
    dom = cfg.local_dom()
    progs = D._build_programs(cfg, dom)[:3]
    params = D.default_params(cfg)
    fresh = exchanger(stack, vector_pairs=[("u", "v")])
    metric = D._metric_terms(cfg, (mesh.size,) + dom.padded_shape(), device)
    strip_errs = {}
    for prog in progs:
        outs = {}
        for backend in ("cuda", "torch"):
            run = make_overlapped_runner(prog, backend=backend, opt_level=3,
                                         device=device)
            # the state fields and metric terms it reads (d_sw's delpc from
            # delp's values); what it writes first it allocates itself
            names = {f: {"delpc": "delp"}.get(f, f)
                     for f in run.full_run.input_fields}
            names = {f: src for f, src in names.items()
                     if src in fresh or f in metric}
            ins = {f: metric[f] if f in metric else fresh[src]
                   for f, src in names.items()}
            stale = {f: metric[f] if f in metric else stack[src]
                     for f, src in names.items()}
            C.reset_launches()
            outs[backend] = run(stale, ins, params)
            torch.cuda.synchronize()
            if backend == "cuda" and C.LAUNCHES["horizontal"] <= 0:
                raise RuntimeError(f"{prog.name}: no K1 launch")
            del run, ins, stale
        worst = 0.0
        for k in outs["cuda"]:
            a = interior_local(outs["cuda"][k], cfg)
            b = interior_local(outs["torch"][k], cfg)
            worst = max(worst, (a - b).abs().max().item())
            if not torch.allclose(a, b, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
                raise RuntimeError(f"{prog.name} strips: {k} differs from "
                                   "the plain runner")
        strip_errs[prog.name] = worst
        del outs
    print("[distributed] split runners (full domain + 4 strips of 6) on the "
          "kernels vs the plain lowering, interior max abs err: "
          + ", ".join(f"{k}={v:.3e}" for k, v in strip_errs.items())
          + f"; tol rtol {KERNEL_RTOL:g} + atol {KERNEL_ATOL:g}", flush=True)
    del stack, fresh, metric, blocks, b1
    torch.cuda.empty_cache()

    # the member axis: a (2, 6, 1, 1) mesh, one member per group; the
    # step with the exchange before the compute must equal the sequential
    # step on each member bit for bit, the overlapped one likewise away
    # from the tiles' corners and within STEP_ATOL near them (see
    # ``corner_split``)
    mcfg = D.FV3Config(**C192_L80)
    M = DIST_MEMBERS
    ens = S.ensemble_state(mcfg, M, seed=0, device=device)
    mmesh = make_mesh((M, 6, 1, 1), ("member", "tile", "y", "x"))
    mout, m_ms = {}, {}
    for ovl in (True, False):
        mstep = D.make_step_distributed(mcfg, mmesh, member_axis="member",
                                        n_members=M, overlap=ovl,
                                        device=device)
        if mstep.overlapped != ovl:
            raise RuntimeError(f"member-sharded step: overlapped "
                               f"{mstep.overlapped}, asked {ovl}")
        t = time.perf_counter()
        mout[ovl] = mstep(S.blocks_from_global(ens, mcfg))
        torch.cuda.synchronize()
        m_ms[ovl] = 1e3 * (time.perf_counter() - t)
        del mstep
    seq = D.make_step_sequential(mcfg, device=device)
    merrs = {True: [], False: []}
    maway = []
    mcorner = global_corners(mcfg, device)
    for m in range(M):
        ref = seq({k: v[m] for k, v in ens.items()})
        for ovl in (True, False):
            got = S.global_from_blocks({k: v[m] for k, v in
                                        mout[ovl].items()}, mcfg)
            cells, away = corner_split(got, ref, mcorner, mcfg)
            worst = max(cells, key=lambda k: cells[k]["err"])
            merrs[ovl].append(cells[worst]["err"])
            if ovl:
                maway.append(max(away.values()))
            print(f"[distributed] member {m}, overlap={ovl}: step 1 "
                  f"{m_ms[ovl]:.3f} ms; vs the sequential opt-3 step on its "
                  f"state, interior: worst field {worst} "
                  f"{describe_cell(cells[worst])}; away from the tiles' "
                  f"corners {max(away.values()):.3e}; cells that differ "
                  + ", ".join(f"{k}={v['cells']}" for k, v in cells.items()),
                  flush=True)
            del got
        del ref
    print(f"[distributed] member axis, mesh (2, 6, 1, 1), n_members={M}: "
          f"interior max abs err per member, overlapped {merrs[True]} (tol "
          f"{STEP_ATOL:g}; away from the tiles' corners {maway}, must be 0), "
          f"exchange first {merrs[False]} (must be 0)", flush=True)
    if max(merrs[True]) >= STEP_ATOL or max(maway) != 0.0 \
            or max(merrs[False]) != 0.0:
        raise RuntimeError(f"the member-sharded step disagrees: {merrs}, "
                           f"away from the corners {maway}")
    del ens, mout, seq
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"[distributed] wall {wall:.1f} s", flush=True)
    return {"launches": launches, "step_ms": step_ms, "idle": idle,
            "split": split, "exchange_ms": ex_ms, "peak": peak}


def interior_local(x, cfg):
    """A rank block's interior."""
    h, n = cfg.halo, cfg.n_local
    return x[..., h:h + n, h:h + n]


def worst_cell(got, want) -> dict:
    """Where ``got`` differs most from ``want``: the abs difference, the
    cell's index and ``want``'s value there, that difference in units of
    the value's last place (float32), and the count of cells that differ."""
    import torch

    d = (got - want).abs()
    at = int(d.argmax())
    idx = tuple(int(i) for i in torch.unravel_index(torch.tensor(at),
                                                    d.shape))
    value = want.reshape(-1)[at].abs().float()
    ulp = (torch.nextafter(value, torch.tensor(float("inf"),
                                               device=value.device))
           - value).item()
    err = d.reshape(-1)[at].item()
    return {"err": err, "cell": idx, "value": value.item(),
            "ulps": err / ulp, "cells": int((d > 0).sum())}


def describe_cell(c: dict) -> str:
    return (f"max {c['err']:.3e} at {c['cell']} (|value| {c['value']:.6g}, "
            f"{c['ulps']:g} ulp; {c['cells']} cells differ)")


def global_corners(cfg, device):
    """Interior cells ``(N, N)`` of a tile within the halo width of one of
    its corners, on ``device``."""
    import torch

    j = torch.arange(cfg.npx)
    edge = (j < cfg.halo) | (j >= cfg.npx - cfg.halo)
    return (edge[:, None] & edge[None, :]).to(device)


def corner_split(got: dict, want: dict, corners, cfg) -> tuple:
    """Per field of two global states, the worst interior cell
    (:func:`worst_cell`) and the max abs difference away from the tiles'
    corners (``corners``, :func:`global_corners`).

    At a cube corner the exchange (as ``exchange_reference``) fills a
    tile's diagonal ghost cell from a neighbour's ghost row as it was, that
    is from what the last program wrote into its ghost ring, and no
    neighbour interior lies there.  A step whose programs write other
    values into the ghost ring (the overlapped step's full-domain run on
    the pre-exchange state, opt 4's widened rim) may then differ in the
    cells a step reaches from that ghost cell, and only there."""
    cells, away = {}, {}
    for k in want:
        a, b = interior(got[k], cfg), interior(want[k], cfg)
        cells[k] = worst_cell(a, b)
        away[k] = (a - b).abs().masked_fill(corners, 0.0).max().item()
    return cells, away


def check_close(name: str, got, want, rtol: float, atol: float) -> float:
    """Max abs error of ``got`` against ``want``; raises on a non-finite
    value or a miss of rtol/atol."""
    import torch

    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: non-finite kernel output")
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise RuntimeError(f"{name} disagrees with the plain version (max abs "
                           f"{err:.3e}, rtol {rtol:g} atol {atol:g})")
    return err


def attention_f64(q, k, v, softcap: float, window: int = 0):
    """Causal attention of the same inputs in float64 (the keys of a
    ``window`` where it is not 0), one batch entry at a time (its (H, S, S)
    scores: 1.1 GB at Granite's shape, 2.4 GB at Gemma-2's): what the
    kernels and their plain versions are both measured against."""
    import torch

    from repro_torch.kernels.ref import attention_mask

    B, S, H, D = q.shape
    rep = H // k.shape[2]
    keep = attention_mask(S, window, q.device)
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for b in range(B):
        kb = k[b].double().repeat_interleave(rep, dim=1)
        vb = v[b].double().repeat_interleave(rep, dim=1)
        s = torch.einsum("qhd,khd->hqk", q[b].double(), kb) / math.sqrt(D)
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        p = torch.softmax(torch.where(keep, s, -1e30), dim=-1)
        out[b] = torch.einsum("hqk,khd->qhd", p, vb)
        del kb, vb, s, p
    return out


def attention_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal attention over S positions computes, each
    query over its last ``window`` keys where ``window`` is not 0: what the
    bound counts (these inputs' work, not the whole square)."""
    w = window if window > 0 else S
    return sum(min(r + 1, w) for r in range(S))


def row_stats(x, exact, floor: float = 0.0) -> list:
    """[sum, count, max] over the rows (the last axis) of each row's error
    norm over the row's float64 norm, rows whose float64 norm is at most
    ``floor`` left out, and the max abs error: what :func:`hold_rows`
    holds, summed over batch entries by :func:`merge_stats`."""
    norm = exact.norm(dim=-1)
    diff = x.double() - exact
    rel = (diff.norm(dim=-1) / norm)[norm > floor]
    out = [rel.sum().item(), rel.numel(),
           rel.max().item() if rel.numel() else 0.0,
           diff.abs().max().item()]
    del diff, rel
    return out


def merge_stats(a, b) -> list:
    """Two batch entries' :func:`row_stats` as one (``a`` may be None)."""
    if a is None:
        return b
    return [a[0] + b[0], a[1] + b[1], max(a[2], b[2]), max(a[3], b[3])]


def hold_rows(name: str, kernel: list, plain: list) -> dict:
    """The kernel's and the plain version's :func:`row_stats` as (kernel,
    plain) pairs: the max abs error, and the mean and max of the row
    errors.  Raises unless the kernel's mean and max are within
    :data:`FA_F64_FACTOR` of the plain version's, or when no row was
    held."""
    if not (kernel[1] and plain[1]):
        raise RuntimeError(f"{name}: no row to hold against float64")
    errs = {"abs": [kernel[3], plain[3]],
            "mean": [kernel[0] / kernel[1], plain[0] / plain[1]],
            "max": [kernel[2], plain[2]]}
    for stat in ("mean", "max"):
        k, p = errs[stat]
        if not k <= FA_F64_FACTOR * p:
            raise RuntimeError(
                f"{name}: {stat} row error against float64 {k:.3e}, "
                f"beyond {FA_F64_FACTOR:g}x the plain version's {p:.3e}")
    return errs


def f64_errors(name: str, got, want, exact) -> dict:
    """The kernel's (``got``) and the plain version's (``want``) distance to
    ``exact`` over the (b, s, h) rows, held by :func:`hold_rows`."""
    return hold_rows(name, row_stats(got, exact), row_stats(want, exact))


def k8_build_report(log: str) -> list:
    """Registers and spills of each K8 instance, from the ``ptxas -v``
    lines of the LM library's ``build.log``: (instance, registers, spill
    store bytes, spill load bytes, stack bytes)."""
    rows = []
    for name, regs, frame, st, ld in ptxas_report(log, "flash_attention"):
        if "bwd" in name:  # the backward kernels: build_report
            continue
        args = ", ".join(re.findall(r"Li(\d+)E", name)
                         + ["window" if "Lb1E" in name else "causal"])
        kind = (f"flash_attention_wgmma_kernel<{args}>" if "wgmma" in name
                else f"flash_attention_fwd_kernel<{args}> (float32)")
        rows.append((kind, regs, st, ld, frame))
    return rows


def sass_counts(lib: Path, function: str | tuple, keys: tuple) -> dict:
    """Instructions of each function whose name holds ``function`` (or one
    of a tuple of names) in the SASS of ``lib`` (``cuobjdump -sass``,
    beside ``nvcc``) that start with each of ``keys``: {mangled name: {key:
    count}}."""
    names = (function,) if isinstance(function, str) else function
    from repro_torch.core.backend.cuda import _nvcc

    sass = subprocess.run([str(Path(_nvcc()).parent / "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out = {}
    for func in sass.split("Function : ")[1:]:
        name = func.split("\n", 1)[0].strip()
        if not any(f in name for f in names):
            continue
        counts = out.setdefault(name, dict.fromkeys(keys, 0))
        for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z]+)", func):
            for key in keys:
                counts[key] += op.startswith(key)
    return out


#: K8's tensor-core kernels whose SASS is counted: the forwards' and the
#: backwards' (by the substring of their mangled names)
K8_SASS = (("bf16", "flash_attention_wgmma_kernel"),
           ("f32", "flash_attention_fwd_kernel"),
           ("bf16 backward dK/dV", "flash_attention_bwd_wgmma_dkdv_kernel"),
           ("bf16 backward dQ", "flash_attention_bwd_wgmma_dq_kernel"),
           ("f32 backward dK/dV", "flash_attention_bwd_tf32_dkdv_kernel"),
           ("f32 backward dQ", "flash_attention_bwd_tf32_dq_kernel"))
#: instances of each backward kind: (widths, with and without the window)
K8_BWD_INSTANCES = {"bf16": 10, "f32": 14}


def k8_sass_report(lib: Path) -> dict:
    """HGMMA (``wgmma``), UTMA* (TMA loads and stores), SYNCS* (mbarrier
    operations) and LDL/STL (local memory) in the SASS of each kernel of
    :data:`K8_SASS`: {kind: {"total": {...} over its instances,
    "instances": {mangled name: {...}}}}."""
    keys = ("HGMMA", "UTMA", "SYNCS", "LDL", "STL")
    out = {}
    for kind, fn in K8_SASS:
        found = sass_counts(lib, fn, keys)
        total = dict.fromkeys(keys, 0)
        for counts in found.values():
            for key in keys:
                total[key] += counts[key]
        out[kind] = {"total": total, "instances": found}
    return out


def ptxas_report(log: str, function: str) -> list:
    """(mangled name, registers, stack frame, spill store, spill load
    bytes) of each function whose name holds ``function``, from the
    ``ptxas -v`` lines of a ``build.log``."""
    rows, name, frame = [], None, None
    for line in log.splitlines():
        got = re.search(r"Compiling entry function '(\S+)'", line)
        if got:
            name, frame = got.group(1), None
            continue
        if name is None or function not in name:
            continue
        got = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                        r" (\d+) bytes spill loads", line)
        if got:
            frame = tuple(int(x) for x in got.groups())
        got = re.search(r"Used (\d+) registers", line)
        if got and frame is not None:
            rows.append((name, int(got.group(1))) + frame)
            name = None
    return rows


#: type arguments of K9's instances, as the mangled names spell them
K9_TYPES = {"4bf16f": "bf16, float", "f4bf16": "float, bf16",
            "ff": "float, float", "4bf16S0_": "bf16, bf16"}


def build_report(lib: Path, fv3_lib: Path, lm_lib: Path) -> None:
    """K1's, K2's and K4's instances (K3 is inlined into all three), K6's
    and K9's, and the backward kernels of K9 and K8: registers, stack frame
    and spills from ``ptxas``, local loads and stores (LDL/STL) and
    indirect branches (BRX, the op dispatch) in their SASS.  An instance
    with a spill or a local access fails the run: K1's stack top, K2's and
    K4's carry bits, K6's carries, the rows K9 holds and the backward's
    register tiles must live in registers."""
    bad = []
    for path, fns in ((lib, ("stencil_parallel_kernel",
                             "stencil_column_kernel",
                             "stencil_kblocked_kernel")),
                      (fv3_lib, ("tridiag_kernel",)),
                      (lm_lib, ("rmsnorm_kernel", "rmsnorm_bwd_kernel",
                                "flash_attention_bwd_tf32_dkdv_kernel",
                                "flash_attention_bwd_tf32_dq_kernel",
                                "flash_attention_bwd_wgmma_dkdv_kernel",
                                "flash_attention_bwd_wgmma_dq_kernel"))):
        log = (path.parent / "build.log").read_text()
        sass = sass_counts(path, fns, ("LDL", "STL", "BRX"))
        for fn in fns:
            found = ptxas_report(log, fn)
            if not found:
                raise RuntimeError(f"no ptxas report of {fn} in {path}")
            for name, regs, frame, st, ld in found:
                args = [{"b0": "false", "b1": "true"}.get(x, x[1:])
                        for x in re.findall(r"L(b[01]|i\d+)E", name)]
                if fn == "tridiag_kernel":  # tridiag_kernel<float|double>
                    args = ["double" if "IdE" in name else "float"]
                elif fn in ("rmsnorm_kernel", "rmsnorm_bwd_kernel"):
                    # <T, W, residual[, d or 0]>
                    types = re.search(fn + r"I(\w+?)Lb", name)
                    args = [K9_TYPES.get(types.group(1), types.group(1))
                            ] + args
                elif "wgmma" in fn:  # <DP, DN, window>
                    args = args[:2] + ["window" if args[2] == "true"
                                       else "causal"]
                elif "tf32" in fn:  # <D, window>
                    args = args[:1] + ["window" if args[1] == "true"
                                       else "causal"]
                counts = sass.get(name, {})
                print(f"[build] {fn}<{', '.join(args)}>: {regs} registers, "
                      f"stack frame {frame} B, spill stores {st} B, spill "
                      f"loads {ld} B; SASS {counts.get('LDL', 0)} LDL, "
                      f"{counts.get('STL', 0)} STL, {counts.get('BRX', 0)} "
                      "BRX", flush=True)
                if (st or ld or frame or counts.get("LDL") or
                        counts.get("STL")):
                    bad.append(name)
    if bad:
        raise RuntimeError(f"spills or local memory in {', '.join(bad)}")


def lm_kernel_phase(device) -> dict:
    """K8, K9 and K10 through ``repro_torch.kernels.ops`` at the serving
    shapes: K8 at Granite-8B's and Zamba2-7B's and at Gemma-2-2B's with and
    without its window (:data:`FA_GEMMA2`), K9 at the widths Granite and
    Zamba2 give it (:data:`NORM_CASES`, float32 weight), in float32 and
    bfloat16, and K10 (float32 only) at Zamba2's and a ragged one; each
    against its plain version, timed beside it, its bound and one library
    call computing the same function where there is one.  The bf16 cases
    (the serving dtype; K8 at Granite's shape and softcap 0, its window at
    Gemma-2's shape and softcap 0, K9 at :data:`NORM_HEAD`) head the
    ``kernels`` records."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as KR

    gen = torch.Generator(device=device).manual_seed(3)
    out = {"K8": [], "rmsnorm": [], "rmsnorm_residual": [], "K10": []}

    def normal(shape, dtype):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        size = torch.finfo(dtype).bits // 8
        for shape in FA_SHAPES + (FA_GEMMA2, FA_WINDOW_D128):
            B, S, H, KVH, D = (shape[k] for k in ("B", "S", "H", "KVH", "D"))
            q = normal((B, S, H, D), dtype)
            k, v = normal((B, S, KVH, D), dtype), normal((B, S, KVH, D),
                                                          dtype)
            rtol, atol = FA_TOL[name]
            for window, cap in shape.get("cases", FA_CASES):
                # bytes: q, k, v read once, o written once; operations: the
                # two products over the pairs the causal mask (and window)
                # keeps (4 D flops per score), on the tensor cores: bf16
                # once, f32 as three TF32 products (3xTF32); the f32
                # kernel's old CUDA-core bound, the flops once at 67
                # TFLOP/s, is printed beside it
                fa_bytes = (2 * q.numel() + 2 * k.numel()) * size
                fa_ops = 4 * B * H * D * attention_pairs(S, window)
                if dtype == torch.bfloat16:
                    t_o, rate = fa_ops / BF16_OPS_PER_S, BF16_OPS_PER_S
                else:
                    t_o, rate = 3 * fa_ops / TF32_OPS_PER_S, TF32_OPS_PER_S
                t_b = fa_bytes / HBM_BYTES_PER_S
                label = (f"K8 flash_attention {name} D={D} window={window} "
                         f"softcap {cap:g}")
                got = ops.flash_attention(q, k, v, softcap=cap,
                                          window=window)
                want = KR.flash_attention_ref(q, k, v, softcap=cap,
                                              window=window)
                torch.cuda.synchronize()
                err = check_close(label, got, want, rtol, atol)
                # both against float64: the bf16 kernel rounds P to bf16
                # before P V, the plain version keeps it in f32; the f32
                # kernel's products are 3xTF32, the plain version's f32
                f64 = f64_errors(label, got, want,
                                 attention_f64(q, k, v, cap, window))
                del got, want
                torch.cuda.empty_cache()
                ms = cuda_ms(lambda: ops.flash_attention(
                    q, k, v, softcap=cap, window=window), 5)
                plain_ms = cuda_ms(lambda: KR.flash_attention_ref(
                    q, k, v, softcap=cap, window=window), 2)
                lib_ms = None
                if cap == 0.0:
                    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                    keep = (KR.attention_mask(S, window, q.device)
                            if window else None)

                    def sdpa():
                        if keep is None:
                            return F.scaled_dot_product_attention(
                                qt, kt, vt, is_causal=True, enable_gqa=True)
                        return F.scaled_dot_product_attention(
                            qt, kt, vt, attn_mask=keep, enable_gqa=True)

                    lib_ms = cuda_ms(sdpa, 5)
                    del keep
                out["K8"].append(dict(
                    dtype=name, D=D, window=window, softcap=cap, err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=1e3 * max(t_b, t_o),
                    bound_by="bytes" if t_b >= t_o else "operations",
                    library_ms=lib_ms))
                print(f"[lm-kernel] K8 flash_attention {name} B={B} S={S} "
                      f"H={H} KVH={KVH} D={D} window={window} softcap="
                      f"{cap:g} max_abs_err={err:.3e} tol=rtol {rtol:g} + "
                      f"atol {atol:g} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                      f"bound_ms={1e3 * max(t_b, t_o):.4f} "
                      f"({out['K8'][-1]['bound_by']}; {fa_bytes / 1e6:.1f} "
                      f"MB, {fa_ops:.3e} flops"
                      + (f" at {rate / 1e12:g} TFLOP/s)" if dtype ==
                         torch.bfloat16 else
                         f" x 3 at {rate / 1e12:g} TFLOP/s TF32; CUDA-core "
                         f"f32 bound {1e3 * fa_ops / F32_OPS_PER_S:.4f})")
                      + ("" if lib_ms is None else
                         f" sdpa{' (window as a mask)' if window else ''} "
                         f"library_ms={lib_ms:.4f}")
                      + f" vs_float64 max_abs kernel={f64['abs'][0]:.3e} "
                      f"plain={f64['abs'][1]:.3e}, row/|row| mean "
                      f"kernel={f64['mean'][0]:.3e} plain="
                      f"{f64['mean'][1]:.3e}, max kernel="
                      f"{f64['max'][0]:.3e} plain={f64['max'][1]:.3e} "
                      f"(bar {FA_F64_FACTOR:g}x plain)", flush=True)
            del q, k, v
            torch.cuda.empty_cache()

        for case, rows_n, d, eps, residual in NORM_CASES:
            x, r = normal((rows_n, d), dtype), normal((rows_n, d), dtype)
            w = 0.1 * torch.randn(d, generator=gen, device=device)  # f32
            tol = NORM_TOL[name]
            err = check_close(f"K9 rmsnorm {name} {case}",
                              ops.rmsnorm(x, w, eps=eps),
                              KR.rmsnorm_ref(x, w, eps=eps), tol, tol)
            # the library's weight, (1 + w) in x's dtype (F.rms_norm takes
            # one dtype), made outside the timed window
            w1 = (1.0 + w).to(dtype)
            cases = [("rmsnorm", err, lambda: ops.rmsnorm(x, w, eps=eps),
                      lambda: KR.rmsnorm_ref(x, w, eps=eps),
                      lambda: F.rms_norm(x, (d,), weight=w1, eps=eps), 2, 4)]
            if residual:
                n_got, s_got = ops.rmsnorm_residual(x, r, w, eps=eps)
                n_want, s_want = KR.rmsnorm_residual_ref(x, r, w, eps=eps)
                err_r = max(
                    check_close(f"K9 rmsnorm_residual {name} {case}", n_got,
                                n_want, tol, tol),
                    check_close(f"K9 rmsnorm_residual {name} {case} (sum)",
                                s_got, s_want, tol, tol))
                del n_got, s_got, n_want, s_want
                cases.append((
                    "rmsnorm_residual", err_r,
                    lambda: ops.rmsnorm_residual(x, r, w, eps=eps),
                    lambda: KR.rmsnorm_residual_ref(x, r, w, eps=eps), None,
                    4, 5))
            decode = rows_n == NORM_DECODE_ROWS
            # both forms and F.rms_norm taken in turns, 7 rounds, the median
            # of each: at a decode step's rows host-bound calls, whose times
            # drift with the host's load, 200 calls after 500; else 50
            # calls after 5 (after one warm-up call the first of them ran
            # slower on an H100, the card coming up to speed)
            turns = {c[0]: c[2] for c in cases}
            turns["F.rms_norm"] = cases[0][4]
            call_ms = in_turns(turns, (lambda f: cuda_ms(f, 200, 500))
                               if decode else (lambda f: cuda_ms(f, 50, 5)))
            if decode:
                host_us = in_turns(turns, lambda f: host_us_per_call(f, 200))
            for key, e, run, plain, lib, n_arrays, flops in cases:
                # bytes: n_arrays (rows, d) arrays read or written once, and
                # the f32 w; f32 operations per element: square, sum, scale,
                # (1 + w) scale (and the residual add)
                t_b = (n_arrays * x.numel() * size + d * 4) / HBM_BYTES_PER_S
                t_o = flops * x.numel() / F32_OPS_PER_S
                plain_ms = cuda_ms(plain, 5)
                ms = call_ms[key]
                lib_ms = None if lib is None else call_ms["F.rms_norm"]
                dev = ""
                if decode:
                    # F.rms_norm of the same rows beside the residual
                    # kernel too: the norm is the part one call computes
                    k_ms, k_how = device_ms_per_call(run, 50)
                    f_ms, f_how = device_ms_per_call(cases[0][4], 50)
                    dev = (f" host_us={host_us[key]:.2f} "
                           f"device_us={1e3 * k_ms:.3f} ({k_how})"
                           f" F.rms_norm host_us={host_us['F.rms_norm']:.2f} "
                           f"device_us={1e3 * f_ms:.3f} ({f_how})")
                out[key].append(dict(
                    dtype=name, rows=rows_n, d=d, err=e, ms=ms,
                    plain_ms=plain_ms, bound_ms=1e3 * max(t_b, t_o),
                    bound_by="bytes" if t_b >= t_o else "operations",
                    library_ms=lib_ms))
                print(f"[lm-kernel] K9 {key} {name} w float32 {case} "
                      f"({rows_n}, {d}) eps={eps:g} max_abs_err={e:.3e} "
                      f"tol=rtol {tol:g} + atol {tol:g} ms={ms:.4f} "
                      f"plain_ms={plain_ms:.4f} bound_ms="
                      f"{1e3 * max(t_b, t_o):.4f} "
                      f"({out[key][-1]['bound_by']}) library_ms="
                      + ("none (no one call computes it)" if lib_ms is None
                         else f"{lib_ms:.4f} (F.rms_norm)") + dev, flush=True)
            del x, r, w, w1
            torch.cuda.empty_cache()

    k9_bars(out)
    for nc, B, H, N, P in SCAN_SHAPES:
        states = torch.randn((nc, B, H, N, P), generator=gen, device=device)
        decay = torch.rand((nc, B, H), generator=gen, device=device)
        err = check_close(f"K10 ssm_state_scan ({nc}, {B}, {H}, {N}, {P})",
                          ops.ssm_state_scan(states, decay),
                          KR.ssm_state_scan_ref(states, decay),
                          KERNEL_RTOL, KERNEL_ATOL)
        # bytes: the states read once, the prefix states written once, the
        # decay read once; operations: a multiply and an add per element
        # and chunk, f32 on the CUDA cores
        t_b = (2 * states.numel() + decay.numel()) * 4 / HBM_BYTES_PER_S
        t_o = 2 * states.numel() / F32_OPS_PER_S
        ms = cuda_ms(lambda: ops.ssm_state_scan(states, decay), 20)
        plain_ms = cuda_ms(lambda: KR.ssm_state_scan_ref(states, decay), 5)
        out["K10"].append(dict(
            shape=(nc, B, H, N, P), err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=1e3 * max(t_b, t_o),
            bound_by="bytes" if t_b >= t_o else "operations",
            library_ms=None))
        print(f"[lm-kernel] K10 ssm_state_scan float32 nc={nc} B={B} H={H} "
              f"N={N} P={P} max_abs_err={err:.3e} tol=rtol "
              f"{KERNEL_RTOL:g} + atol {KERNEL_ATOL:g} ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} bound_ms={1e3 * max(t_b, t_o):.4f} "
              f"({out['K10'][-1]['bound_by']}; {states.numel() * 8 / 1e6:.1f}"
              f" MB of states in and out) library_ms=none (no one call "
              f"computes the scan)", flush=True)
        del states, decay
        torch.cuda.empty_cache()
    return out


def k9_bars(out: dict) -> None:
    """Print K9's bars against this run's numbers ("a call" is CUDA events
    over back-to-back calls, host included): at a decode step's 8 rows (d
    4096 and 3584, float32 and bfloat16) a call no slower than
    ``F.rms_norm``'s and the residual form within 1.1x the plain form's; at
    :data:`NORM_HEAD` (16384, 3584) bfloat16 no slower than ``F.rms_norm``
    and both forms at 80 % of their bound or more.  Prints each as met or
    not; a bar is a measurement here, not a check that fails the run."""
    def row(key, dtype, rows, d):
        return next(r for r in out[key] if (r["dtype"], r["rows"], r["d"])
                    == (dtype, rows, d))

    bars = []
    for dtype in ("float32", "bfloat16"):
        for d in (4096, 3584):
            plain, res = (row(k, dtype, NORM_DECODE_ROWS, d)
                          for k in ("rmsnorm", "rmsnorm_residual"))
            bars.append((f"{dtype} 8 x {d} call <= F.rms_norm's",
                         plain["ms"], plain["library_ms"],
                         plain["ms"] <= plain["library_ms"]))
            bars.append((f"{dtype} 8 x {d} residual call <= 1.1x the plain "
                         "form's", res["ms"], 1.1 * plain["ms"],
                         res["ms"] <= 1.1 * plain["ms"]))
    head = row("rmsnorm", "bfloat16", *NORM_HEAD)
    shape = f"{NORM_HEAD[0]} x {NORM_HEAD[1]}"
    bars.append((f"bfloat16 {shape} <= F.rms_norm's", head["ms"],
                 head["library_ms"], head["ms"] <= head["library_ms"]))
    for key in ("rmsnorm", "rmsnorm_residual"):
        r = row(key, "bfloat16", *NORM_HEAD)
        bars.append((f"{key} bfloat16 {shape} >= 80 % of its bound",
                     r["ms"], r["bound_ms"] / 0.8,
                     r["bound_ms"] >= 0.8 * r["ms"]))
    for name, got, bar, met in bars:
        print(f"[lm-kernel] K9 bar: {name}: {got:.4f} ms against "
              f"{bar:.4f} ms: {'met' if met else 'NOT MET'}", flush=True)


def parity_fails(e_k: float, e_p: float, scale: float,
                 e_w: float | None = None) -> bool:
    """The float32 parity bar against a float64 prefill, for one leaf: the
    kernel path's max abs error ``e_k`` within :data:`PARITY_FACTOR` of
    the plain path's ``e_p``, and within :data:`PARITY_REL` of the largest
    |value| ``scale``.  ``e_w``, given for an sLSTM state leaf only, is
    the error of an independent float32 prefill of the reference's
    equations (:func:`prefill_wide`); past :data:`PARITY_REL`, such a leaf
    is held within :data:`PARITY_FACTOR` of it instead."""
    if e_k > PARITY_FACTOR * e_p:
        return True
    if e_w is not None and e_k > PARITY_REL * scale:
        return e_k > PARITY_FACTOR * e_w
    return e_k > PARITY_REL * scale


def greedy(model, tokens, n_decode: int, cache_len: int, backend: str,
           quantized: bool = False):
    """Prefill then ``n_decode`` greedy decode steps: (prefill logits, the
    prefill's caches, the generated tokens (B, 1 + n_decode)).  Decode
    writes the caches in place (a local block's ring over the prompt's
    positions, the Mamba-2 and xLSTM states over their own), so they are
    copied right after the prefill."""
    import torch

    from repro_torch import models as TM

    logits, caches = TM.prefill(model, tokens, cache_len=cache_len,
                                backend=backend, quantized=quantized)
    prefilled = [{k: v.clone() for k, v in c.items()} for c in caches]
    toks = [logits.argmax(-1)]
    S = tokens.shape[1]
    for i in range(n_decode):
        step, caches = TM.decode_step(model, toks[-1], caches, S + i,
                                      backend=backend, quantized=quantized)
        toks.append(step.argmax(-1))
    return logits, prefilled, torch.cat(toks, dim=1)


def prefill_wide(model, tokens, dtype, routes: list | None = None):
    """An independent prefill of a pre-norm model of ``attn``, ``local``
    (the window), ``shared_attn`` and ``mamba2`` blocks in ``dtype``
    (float64, or float32 for a bfloat16 model), written from the
    reference's equations, each block's weights widened one block (one
    expert) at a time; RoPE angles in float32, as the reference defines
    them.  It follows the reference's options that the served models use:
    sandwich norms, tied embeddings times sqrt(d_model), the attention and
    final softcaps, SwiGLU, GeGLU and GeLU feed-forwards, and the mixture
    of experts (``moe``: router softmax, top-k gates over their sum,
    capacity C per chunk of 8192 tokens by a one-hot cumsum in (token,
    choice) order, an expert at a time, the shared expert after; each
    layer's top-k choices appended to ``routes``).  A Mamba-2 layer runs
    the reference's own form: a loop over chunks that carries the state
    (no K10 regrouping).  An mLSTM layer runs, in float64, the one-token
    recurrence of the reference's ``mlstm_decode`` over the prompt, step
    by step (not the chunked form the model runs), and hands its final
    ``(C, n)`` on as the cache; in float32 (the reference of a bfloat16
    run) the whole prompt as one quadratic form and the final state as a
    sum over the prompt.  An sLSTM layer runs the reference's cell, step
    by step.  Returns
    the last-position logits and the caches in the model's order (``{"k",
    "v"}``, a local block's a ring of min(window, S) slots with position p
    in slot p % W; ``{"conv", "ssm"}``; ``{"C", "n"}``; ``{"h", "c", "n",
    "m"}``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.layers import MoE
    from repro_torch.models.transformer import MambaBlock, XLSTMBlock

    cfg = model.cfg
    if cfg.act not in ("swiglu", "geglu", "gelu") or cfg.parallel_block:
        raise ValueError(f"prefill_wide does not model {cfg.name}")
    B, S = tokens.shape
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def norm(x, w, eps=cfg.norm_eps):
        var = (x * x).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + eps) * (1.0 + w.to(dtype))

    def cap(x, c):
        return c * torch.tanh(x / c) if c > 0.0 else x

    half = D // 2
    freqs = (1.0 / cfg.rope_theta) ** (torch.arange(
        half, dtype=torch.float32, device=tokens.device) / half)
    ang = torch.arange(S, device=tokens.device, dtype=torch.float32)[:, None] \
        * freqs
    cos = torch.cos(ang).to(dtype)[:, None, :]
    sin = torch.sin(ang).to(dtype)[:, None, :]

    def rope(x):
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    pos = torch.arange(S, device=tokens.device)
    causal = pos[None, :] <= pos[:, None]
    windowed = causal & (pos[None, :] > pos[:, None] - cfg.window)

    def mlp(ff, h):
        if cfg.act == "swiglu":
            f = F.silu(h @ ff.wg.to(dtype)) * (h @ ff.wi.to(dtype))
        elif cfg.act == "geglu":
            f = F.gelu(h @ ff.wg.to(dtype), approximate="tanh") \
                * (h @ ff.wi.to(dtype))
        else:
            f = F.gelu(h @ ff.wi.to(dtype), approximate="tanh")
        return f @ ff.wo.to(dtype)

    def moe(ff, h):
        mc = cfg.moe
        E, K = mc.n_experts, mc.top_k
        xt = h.reshape(B * S, -1)
        tc = min(8192, B * S)
        C = min(tc, max(1, int(tc * K / E * mc.capacity_factor)))
        y = torch.zeros_like(xt)
        choices = []
        for c0 in range(0, B * S, tc):
            xc = xt[c0:c0 + tc]
            probs = torch.softmax(xc @ ff.router.to(dtype), dim=-1)
            gate, idx = torch.topk(probs, K, dim=-1)
            gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
            choices.append(idx)
            onehot = F.one_hot(idx, E)  # (tc, K, E)
            queue = (onehot.reshape(tc * K, E).cumsum(0).reshape(tc, K, E)
                     * onehot - 1)
            kept = (queue >= 0) & (queue < C)
            for e in range(E):
                t, k = kept[..., e].nonzero(as_tuple=True)
                xe = xc[t]
                he = xe @ ff.wi[e].to(dtype)
                if hasattr(ff, "wg"):
                    he = F.silu(xe @ ff.wg[e].to(dtype)) * he
                else:
                    he = F.gelu(he, approximate="tanh")
                y[c0:c0 + tc].index_add_(
                    0, t, (he @ ff.wo[e].to(dtype)) * gate[t, k, None])
        if routes is not None:
            routes.append(torch.cat(choices))
        y = y.reshape(h.shape)
        return y if ff.shared is None else y + mlp(ff.shared, h)

    def attn_block(blk, x):
        at, ff = blk.attn, blk.ffn
        h = norm(x, blk.ln1)
        q = rope((h @ at.wq.to(dtype)).reshape(B, S, H, D))
        k = rope((h @ at.wk.to(dtype)).reshape(B, S, KVH, D))
        v = (h @ at.wv.to(dtype)).reshape(B, S, KVH, D)
        kk = k.repeat_interleave(H // KVH, dim=2)
        vv = v.repeat_interleave(H // KVH, dim=2)
        s = cap(torch.einsum("bqhd,bkhd->bhqk", q, kk) / D ** 0.5,
                cfg.attn_softcap)
        keep = windowed if blk.local and cfg.window else causal
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        del s
        a = torch.einsum("bhqk,bkhd->bqhd", p, vv).reshape(B, S, H * D)
        a = a @ at.wo.to(dtype)
        if cfg.post_norm:
            a = norm(a, blk.ln1_post)
        x = x + a
        h = norm(x, blk.ln2)
        f = moe(ff, h) if isinstance(ff, MoE) else mlp(ff, h)
        if cfg.post_norm:
            f = norm(f, blk.ln2_post)
        if blk.local and cfg.window:  # the ring of the last W positions
            W = min(cfg.window, S)
            p = torch.arange(S - W, S, device=x.device)
            ring = {n: t.new_zeros((B, W) + t.shape[2:])
                    for n, t in (("k", k), ("v", v))}
            ring["k"][:, p % W] = k[:, p]
            ring["v"][:, p % W] = v[:, p]
            return x + f, ring
        return x + f, {"k": k, "v": v}

    def mamba_block(blk, x):
        mb, ssm = blk.mamba, cfg.ssm
        di, Hs, N, P = mb.di, mb.H, mb.N, mb.P
        h = norm(x, blk.ln1)
        z, xin, Bc, Cc, dt = torch.split(h @ mb.w_in.to(dtype),
                                         [di, di, N, N, Hs], dim=-1)
        dt = torch.logaddexp(dt + mb.dt_bias.to(dtype),
                             torch.zeros((), dtype=dtype, device=x.device))
        seq = torch.cat([xin, Bc, Cc], -1)
        K = ssm.d_conv
        full = torch.cat([seq.new_zeros((B, K - 1, seq.shape[2])), seq], 1)
        conv = F.silu(sum(full[:, i:i + S] * mb.conv_w[i].to(dtype)
                          for i in range(K)))
        xin, Bc, Cc = torch.split(conv, [di, N, N], dim=-1)
        A = -torch.exp(mb.A_log.to(dtype))
        L = min(ssm.chunk, S)
        while S % L:
            L -= 1
        tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
        state = x.new_zeros((B, Hs, N, P))
        ys = []
        for c in range(S // L):
            t = slice(c * L, (c + 1) * L)
            xc, dtc = xin[:, t].reshape(B, L, Hs, P), dt[:, t]
            Bv, Cv = Bc[:, t], Cc[:, t]
            cum = torch.cumsum(dtc * A, dim=1)
            decay = torch.exp(cum[:, :, None] - cum[:, None]).masked_fill(
                ~tri[None, :, :, None], 0.0)
            att = torch.einsum("bln,bsn->bls", Cv, Bv)[..., None] * decay
            y = torch.einsum("blsh,bshp->blhp", att, xc * dtc[..., None])
            y = y + torch.einsum("bln,bhnp->blhp", Cv, state) \
                * torch.exp(cum)[..., None]
            ys.append((y + xc * mb.D.to(dtype)[:, None]).reshape(B, L, di))
            w = torch.exp(cum[:, -1:] - cum) * dtc
            state = state * torch.exp(cum[:, -1])[..., None, None] \
                + torch.einsum("bln,blhp->bhnp", Bv, xc * w[..., None])
        y = norm(torch.cat(ys, 1) * F.silu(z), mb.norm_w, eps=1e-6)
        # the tail as a copy: a view would hold all of `full`
        return x + y @ mb.w_out.to(dtype), {"conv": full[:, S:].clone(),
                                            "ssm": state}

    def mlstm_block(blk, x):
        ml, dh = blk.mlstm, cfg.d_head
        h = norm(x, blk.ln1)
        q, k, v = ((h @ w.to(dtype)).reshape(B, S, H, dh)
                   for w in (ml.wq, ml.wk, ml.wv))
        k = k / dh ** 0.5
        i_raw, f_raw = torch.split(h @ ml.wif.to(dtype), H, dim=-1)
        log_f, i = F.logsigmoid(f_raw), torch.exp(F.logsigmoid(i_raw))
        if dtype != torch.float64:
            return mlstm_parallel(ml, h, x, q, k, v, log_f, i)
        f = torch.exp(log_f)
        C = x.new_zeros((B, H, dh, dh))
        n = x.new_zeros((B, H, dh))
        y = torch.empty_like(q)
        for t in range(S):
            C.mul_(f[:, t, :, None, None]).add_(
                i[:, t, :, None, None] * k[:, t, :, :, None]
                * v[:, t, :, None, :])
            n.mul_(f[:, t, :, None]).add_(i[:, t, :, None] * k[:, t])
            den = torch.einsum("bhd,bhd->bh", q[:, t], n).abs().clamp_min(1)
            y[:, t] = torch.einsum("bhd,bhde->bhe", q[:, t], C) \
                / den[..., None]
        y = y.reshape(B, S, H * dh) * torch.sigmoid(h @ ml.ogate.to(dtype))
        return x + y @ ml.wo.to(dtype), {"C": C, "n": n}

    def mlstm_parallel(ml, h, x, q, k, v, log_f, i):
        # the whole prompt as one quadratic form, y_t = sum_{s <= t}
        # exp(cum_t - cum_s) i_s (q_t . k_s) v_s over max(|its weights'
        # sum|, 1): the float32 reference of a bfloat16 run, where S
        # steps of the recurrence would cost S x 42 launches of B H dh^2
        cum = torch.cumsum(log_f, dim=1)                       # (B,S,H)
        keep = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
        w = torch.einsum("bthd,bshd->bhts", q, k) * torch.where(
            keep, torch.exp(torch.where(keep, cum.transpose(1, 2)[..., None]
                                        - cum.transpose(1, 2)[:, :, None],
                                        0.0)) * i.transpose(1, 2)[:, :, None],
            0.0)
        y = torch.einsum("bhts,bshd->bthd", w, v) / w.sum(-1).abs(
            ).clamp_min(1).transpose(1, 2)[..., None]
        del w
        wgt = torch.exp(cum[:, -1:] - cum) * i
        state = {"C": torch.einsum("bsh,bshd,bshe->bhde", wgt, k, v),
                 "n": torch.einsum("bsh,bshd->bhd", wgt, k)}
        y = y.reshape(B, S, -1) * torch.sigmoid(h @ ml.ogate.to(dtype))
        return x + y @ ml.wo.to(dtype), state

    def slstm_block(blk, x):
        sl, d, dh = blk.slstm, cfg.d_model, cfg.d_head
        h = norm(x, blk.ln1)
        pre = h @ sl.w_in.to(dtype)
        r = sl.r.to(dtype)
        hh, c, n, m = (x.new_zeros((B, d)) for _ in range(4))
        out = torch.empty_like(x)
        for t in range(S):
            rec = torch.einsum("bhd,ghde->bghe", hh.reshape(B, H, dh),
                               r).reshape(B, 4 * d)
            z, i_r, f_r, o = torch.chunk(pre[:, t] + rec, 4, dim=-1)
            log_f = F.logsigmoid(f_r)
            m_new = torch.maximum(log_f + m, i_r)
            i_s, f_s = torch.exp(i_r - m_new), torch.exp(log_f + m - m_new)
            c = f_s * c + i_s * torch.tanh(z)
            n = f_s * n + i_s
            m = m_new
            hh = torch.sigmoid(o) * c / n.clamp_min(1)
            out[:, t] = hh
        return x + out @ sl.wo.to(dtype), {"h": hh, "c": c, "n": n, "m": m}

    x = model.embed[tokens].to(dtype)
    if cfg.tie_embeddings:
        x = x * cfg.d_model ** 0.5
    caches = []
    for blk in model.stack():
        if isinstance(blk, XLSTMBlock):
            block = mlstm_block if blk.btype == "mlstm" else slstm_block
        else:
            block = mamba_block if isinstance(blk, MambaBlock) else attn_block
        x, cache = block(blk, x)
        caches.append(cache)
    h = norm(x[:, -1:], model.final_norm)
    w = model.embed.T if cfg.tie_embeddings else model.unembed
    return cap(h @ w.to(dtype), cfg.final_softcap), caches


def block_type(blk) -> str:
    """"attn" (any attention block, local and shared ones too), "mamba2",
    "mlstm" or "slstm"."""
    return getattr(blk, "btype", "mamba2" if hasattr(blk, "mamba")
                   else "attn")


def stack_counts(model) -> dict:
    """Block applications of the model by :func:`block_type`, and the local
    attention ones under "local"."""
    blocks = model.stack()
    counts = {k: 0 for k in ("attn", "mamba2", "mlstm", "slstm")}
    for b in blocks:
        counts[block_type(b)] += 1
    counts["local"] = sum(getattr(b, "local", False) for b in blocks)
    return counts


@contextlib.contextmanager
def moe_routes(store: list):
    """Within the block, every ``MoE.route`` call appends its chunk's top-k
    expert choices (tc, K) to ``store``."""
    from repro_torch.models.layers import MoE

    route = MoE.route

    def recording(self, xc):
        out = route(self, xc)
        store.append(out[0])
        return out

    MoE.route = recording
    try:
        yield store
    finally:
        MoE.route = route


def routes_differ(paths: dict, n_layers: int) -> dict:
    """For MoE prefills, {"a vs b": (token, layer) pairs whose set of top-k
    experts differ} over each pair of ``paths`` (name: the chunks' choices
    in call order, layer by layer), and the pairs in all (under "of")."""
    import torch

    def per_layer(chunks):
        per = len(chunks) // n_layers
        return torch.cat([torch.cat(chunks[i * per:(i + 1) * per])
                          for i in range(n_layers)]).sort(-1).values

    got = {k: per_layer(v) for k, v in paths.items()}
    names = list(got)
    out = {f"{a} vs {b}": int((got[a] != got[b]).any(-1).sum())
           for i, a in enumerate(names) for b in names[i + 1:]}
    out["of"] = got[names[0]].shape[0]
    return out


# what the serving phase calls each block type's cache leaves (None: any
# other leaf)
CACHE_KINDS = {"attn": {None: "KV caches"},
               "mamba2": {"conv": "conv tails", None: "SSM states"},
               "mlstm": {"C": "mLSTM C states", None: "mLSTM n states"},
               "slstm": {None: "sLSTM states"}}


# the profiler ranges the models open (record_function): a trace reads each
# range's device-side twin apart, since it spans kernels and is no kernel
MODEL_RANGES = ("slstm_scan", "ssd_chunks")
# device time of a traced prefill, by kernel name
PREFILL_GROUPS = (
    ("K8 flash_attention_wgmma_kernel", ("flash_attention",)),
    ("K10 ssm_state_scan_kernel", ("ssm_state_scan",)),
    ("K9 rmsnorm_kernel", ("rmsnorm_kernel",)),
    ("GEMMs (cuBLAS: projections, MLP, unembed, chunk einsums)",
     ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
)


def serving_phase(device, arch: str) -> dict:
    """``arch`` at full width (and full depth, or :data:`DEPTH`'s layers)
    with seeded weights: float32 parity of the kernel path against the
    plain path and a float64 prefill, then the bfloat16 serving run
    (prefill, greedy decode), with :data:`TRAFFIC`'s prompts where it names
    the model, else :data:`PARITY` and :data:`SERVE`."""
    import torch

    from repro_torch import configs as TC
    from repro_torch import models as TM
    from repro_torch.kernels import library as KL

    cfg = TC.get_config(arch)
    full_layers = cfg.n_layers
    if arch in DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=DEPTH[arch])
    parity, serve = TRAFFIC.get(arch, (PARITY, SERVE))
    gen = torch.Generator(device=device).manual_seed(4)
    t = time.perf_counter()
    model = TM.init_params(TM.Transformer(cfg, dtype=torch.float32,
                                          device=device), seed=0)
    torch.cuda.synchronize()
    n_params = TM.count_params(model)
    counts = stack_counts(model)
    n_attn, n_local, n_mamba = (counts[k] for k in ("attn", "local",
                                                     "mamba2"))
    n_xlstm = counts["mlstm"] + counts["slstm"]
    n_moe = n_attn if cfg.moe is not None else 0
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers of {cfg.pattern}"
          + (f" (depth cut from {full_layers} to fit one card: the float32 "
             f"parity weights)" if cfg.n_layers != full_layers else "")
          + f", d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
          f"of {cfg.d_head}, d_ff {cfg.d_ff}"
          + (f" x {cfg.moe.n_experts} experts, top-{cfg.moe.top_k}"
             f"{' + a shared expert' if cfg.moe.shared_expert else ''}, "
             f"capacity factor {cfg.moe.capacity_factor:g}"
             if cfg.moe is not None else "")
          + f", vocab {cfg.vocab}"
          + (f", window {cfg.window}" if n_local else "")
          + f"; {n_attn} attention applications ({n_local} local), "
          f"{n_mamba} Mamba-2 layers, {counts['mlstm']} mLSTM and "
          f"{counts['slstm']} sLSTM layers: {n_params / 1e9:.3f} G "
          f"parameters; "
          f"float32 weights initialised in {time.perf_counter() - t:.2f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB)", flush=True)
    B, S, n = parity["B"], parity["S"], parity["decode"]
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device)
    routes = {"kernel": [], "plain": [], "float64": []}
    KL.reset_launches()
    with moe_routes(routes["kernel"]):
        got = greedy(model, tokens, n, S + n, "cuda")
    launched = {k: KL.LAUNCHES[k] for k in LM_LAUNCHES}
    with moe_routes(routes["plain"]):
        want = greedy(model, tokens, n, S + n, "ref")
    exact = prefill_wide(model, tokens, torch.float64, routes["float64"])
    # the sLSTM states' float32 baseline, independent of the port's code
    wide32 = prefill_wide(model, tokens, torch.float32)[1] \
        if counts["slstm"] else None
    torch.cuda.synchronize()
    if n_moe:
        # the prefill's routes: each layer's chunks, before the decode's
        chunks = -(-B * S // 8192) * n_moe
        differ = routes_differ({"kernel": routes["kernel"][:chunks],
                                "plain": routes["plain"][:chunks],
                                "float64": routes["float64"]}, n_moe)
        print(f"[serve] MoE routing, float32 parity prefill: (token, layer) "
              f"top-{cfg.moe.top_k} expert choices that differ, of "
              f"{differ.pop('of')}: "
              + ", ".join(f"{k} {v}" for k, v in differ.items()),
              flush=True)
    same = torch.equal(got[2], want[2])
    # (name, kind, kernel path, plain path, float64, the independent
    # float32 prefill or None) for the logits and every leaf of every
    # cache; a KV cache over the prompt's slots
    cases = [("logits", "logits", got[0], want[0], exact[0], None)]
    for i, (blk, a, b, x) in enumerate(zip(model.stack(), got[1], want[1],
                                           exact[1])):
        kind = CACHE_KINDS[block_type(blk)]
        for leaf in x:
            cut = slice(0, S) if leaf in ("k", "v") else slice(None)
            cases.append((f"{leaf}{i}", kind.get(leaf, kind[None]),
                          a[leaf][:, cut], b[leaf][:, cut], x[leaf],
                          wide32[i][leaf] if block_type(blk) == "slstm"
                          else None))
    worst, failed = {}, []
    for name, kind, a, b, x, w32 in cases:
        if not torch.isfinite(a).all():
            raise RuntimeError(f"serving parity: non-finite {name}")
        scale = x.abs().max().item()
        e_k = (a.double() - x).abs().max().item()
        e_p = (b.double() - x).abs().max().item()
        e_kp = (a - b).abs().max().item()
        e_w = None if w32 is None else (w32.double() - x).abs().max().item()
        past = e_k > PARITY_REL * scale
        w = worst.setdefault(kind, [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0.0,
                                    0.0])
        w[:] = [max(w[0], e_k), max(w[1], e_p), max(w[2], e_kp),
                max(w[3], e_k / scale), max(w[4], e_k / max(e_p, 1e-30)),
                max(w[5], e_p / scale), w[6] + past,
                max(w[7], (e_w or 0.0) / scale),
                max(w[8], e_k / max(e_w, 1e-30) if past and e_w else 0.0)]
        if parity_fails(e_k, e_p, scale, e_w):
            failed.append(f"{name} of the kernel path is {e_k:.3e} from "
                          f"float64 (max |value| {scale:.3f}), the plain "
                          f"path {e_p:.3e}"
                          + ("" if e_w is None else
                             f", the independent float32 prefill {e_w:.3e}"))
    for kind, (e_k, e_p, e_kp, rel, ratio, rel_p, past, rel_w,
               ratio_w) in worst.items():
        print(f"[serve] parity, float32, B={B} prompt {S}, {kind}: max abs "
              f"vs float64: kernel path {e_k:.3e}, plain path {e_p:.3e} "
              f"(worst kernel/plain ratio {ratio:.3f}, bar "
              f"{PARITY_FACTOR:g}; worst kernel error / max |value| "
              f"{rel:.3e}, plain {rel_p:.3e}, bar {PARITY_REL:g}"
              + (f"; the independent float32 prefill {rel_w:.3e}; the "
                 f"kernel path past the bar in {past} of them, where its "
                 f"worst ratio to the independent float32 prefill's error "
                 f"is {ratio_w:.3f}, bar {PARITY_FACTOR:g}"
                 if kind == "sLSTM states" else "")
              + f"); kernel vs plain path {e_kp:.3e}")
    if failed:
        raise RuntimeError("serving parity: " + "; ".join(failed)
                           + f": beyond {PARITY_REL:g} of the scale (an "
                           f"sLSTM state: and {PARITY_FACTOR:g}x the "
                           f"independent float32 prefill's error) or "
                           f"{PARITY_FACTOR:g}x the plain path's error")
    print(f"[serve] parity: greedy tokens (prefill + {n} decode steps) "
          f"identical on both paths: {same}; kernel launches {launched}",
          flush=True)
    if not same:
        raise RuntimeError(f"greedy tokens differ: {got[2].tolist()} vs "
                           f"{want[2].tolist()}")
    if launched["flash_attention"] != n_attn \
            or launched["flash_attention_window"] != n_local \
            or launched["ssm_state_scan"] != n_mamba:
        raise RuntimeError(f"K8 (with a window)/K10 launched "
                           f"{launched['flash_attention']} "
                           f"({launched['flash_attention_window']})/"
                           f"{launched['ssm_state_scan']} times in the parity "
                           f"run, expected {n_attn} ({n_local})/{n_mamba}")
    del got, want, exact, wide32
    torch.cuda.empty_cache()
    # the float32 parity prefill (K8's float32 kernel), timed alone
    parity_ms = cuda_ms(lambda: TM.prefill(model, tokens, cache_len=S + n), 2)
    print(f"[serve] parity prefill, float32, B={B} prompt {S}: "
          f"{parity_ms:.3f} ms (CUDA events, mean of 2 after a warm-up)",
          flush=True)
    del model
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = TM.init_params(TM.Transformer(cfg, dtype=torch.bfloat16,
                                          device=device), seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    B, S, n, cache = (serve[k] for k in ("B", "S", "decode", "cache"))
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device)
    print(f"[serve] bfloat16 weights initialised in {init_s:.2f} s; B={B} "
          f"prompts of {S} tokens, caches of {cache}"
          + (f" (local rings of {min(cfg.window, cache)})" if n_local
             else ""), flush=True)
    routes = {"kernel": [], "plain": [], "float32": []}
    with moe_routes(routes["kernel"]):  # the warm-up
        logits, caches = TM.prefill(model, tokens, cache_len=cache)
    del logits, caches
    # the peak over the timed prefills: the weights, one prefill's
    # transients and its caches (each prefill frees the last one's first)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        logits = caches = None
        torch.cuda.synchronize()
        KL.reset_launches()
        t = time.perf_counter()
        logits, caches = TM.prefill(model, tokens, cache_len=cache)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        per_prefill = {k: KL.LAUNCHES[k] for k in LM_LAUNCHES}
    prefill_ms = 1e3 * statistics.median(times)
    peak_prefill = torch.cuda.max_memory_allocated()
    print(f"[serve] prefill ms {[round(1e3 * x, 3) for x in times]} -> "
          f"median {prefill_ms:.3f} ms ({B * S / prefill_ms * 1e3:.1f} prompt "
          f"tokens/s); peak device memory over a prefill "
          f"{peak_prefill / 2**30:.3f} GiB", flush=True)
    split = {}
    ranges = (("slstm_scan",) if counts["slstm"] else ()) + (
        ("ssd_chunks",) if counts["mamba2"] else ())
    idle_prefill = trace_step(
        lambda _: TM.prefill(model, tokens, cache_len=cache), None,
        prefill_ms, untraced="median prefill", groups=PREFILL_GROUPS,
        split_out=split, ranges=ranges)
    if counts["slstm"]:
        scan_ms = slstm_scan_ms(model, tokens)
        busy = sum(split[label][0] for label, _ in PREFILL_GROUPS
                   + (("other", ()),)) if split else 0.0
        dev_ms = split.get("slstm_scan", (None,))[0]
        print(f"[serve] sLSTM scan: device time in the traced prefill "
              + ("not measured" if dev_ms is None or not busy else
                 f"{dev_ms:.3f} ms of {busy:.3f} ms busy "
                 f"({100 * dev_ms / busy:.1f} %)")
              + f"; one layer's scan (x @ w_in, {S} steps of the cell, "
              f"@ wo) at B={B}: {scan_ms:.3f} ms (CUDA events), x "
              f"{counts['slstm']} layers = {counts['slstm'] * scan_ms:.3f} "
              f"ms, {100 * counts['slstm'] * scan_ms / prefill_ms:.1f} % of "
              f"the median prefill", flush=True)
    if n_mamba:
        chunk_ms = ssd_chunks_ms(model, tokens)
        print(f"[serve] intra-chunk work (Mamba2.ssd_chunks: decays, mask, "
              f"C.B, the intra-chunk product, the chunk states) of one layer "
              f"at B={B} S={S}: {chunk_ms:.3f} ms (CUDA events), x "
              f"{n_mamba} layers = {n_mamba * chunk_ms:.3f} ms of a prefill",
              flush=True)
    tok = logits.argmax(-1)
    steps = []
    KL.reset_launches()
    for i in range(n):
        t = time.perf_counter()
        step_logits, caches = TM.decode_step(model, tok, caches, S + i)
        tok = step_logits.argmax(-1)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t)
    per_step = {k: KL.LAUNCHES[k] / n for k in LM_LAUNCHES}
    # one request: a prefill and its decode steps
    request = {k: per_prefill[k] + KL.LAUNCHES[k] for k in LM_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    decode_ms = 1e3 * statistics.median(steps)
    tok_s = B * n / sum(steps)
    # every ln1 (and, with sandwich norms, ln1_post and ln2_post), the
    # gated norms, the final norm
    norms = n_attn * (3 if cfg.post_norm else 1) + 2 * n_mamba + n_xlstm + 1
    want_prefill = {"flash_attention": n_attn,
                    "flash_attention_window": n_local, "rmsnorm": norms,
                    "rmsnorm_residual": n_attn, "ssm_state_scan": n_mamba}
    want_step = {"flash_attention": 0, "flash_attention_window": 0,
                 "rmsnorm": norms, "rmsnorm_residual": n_attn,
                 "ssm_state_scan": 0}
    print(f"[serve] decode: {n} greedy steps, ms per step median "
          f"{decode_ms:.3f} (min {1e3 * min(steps):.3f}, max "
          f"{1e3 * max(steps):.3f}); {tok_s:.1f} generated tokens/s")
    print(f"[serve] launches per prefill {per_prefill} (expected "
          f"{want_prefill}); per decode step {per_step} (expected "
          f"{want_step})")
    print(f"[serve] peak device memory from the timed prefills through "
          f"decode {peak / 2**30:.3f} GiB", flush=True)
    if per_prefill != want_prefill or per_step != want_step:
        raise RuntimeError("the serving path did not launch K8/K9/K10 as "
                           "expected")
    idle = trace_step(lambda c: TM.decode_step(model, tok, c, S + n), caches,
                      decode_ms, untraced="median decode step",
                      check_reader=True)
    del caches
    torch.cuda.empty_cache()
    with moe_routes(routes["plain"]):
        plain, _ = TM.prefill(model, tokens, backend="ref")
    wide = prefill_wide(model, tokens, torch.float32, routes["float32"])[0]
    torch.cuda.synchronize()
    if not torch.isfinite(logits).all() or logits.shape != plain.shape:
        raise RuntimeError("serving logits non-finite or misshapen")
    if n_moe:
        differ = routes_differ(routes, n_moe)
        print(f"[serve] MoE routing, bfloat16 prefill (the float32 prefill "
              f"of the same weights as the reference): (token, layer) "
              f"top-{cfg.moe.top_k} expert choices that differ, of "
              f"{differ.pop('of')}: "
              + ", ".join(f"{k} {v}" for k, v in differ.items()),
              flush=True)

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.abs().max()).item()

    def top1(a, b):
        return (a.argmax(-1) == b.argmax(-1)).float().mean().item()

    r_kp, t_kp = rel(logits, plain), top1(logits, plain)
    r_k, r_p = rel(logits, wide), rel(plain, wide)
    print(f"[serve] bfloat16 last-position logits vs the plain path: max abs "
          f"difference / max |logit| = {r_kp:.3e} (bar {BF16_LOGIT_REL:g}); "
          f"top-1 agreement {t_kp:.3f} over {B} prompts (bar "
          f"{BF16_TOP1:g})")
    print(f"[serve] against a float32 prefill of the same bf16 weights: max "
          f"abs difference / max |logit| kernel path {r_k:.3e}, plain path "
          f"{r_p:.3e} (bar: kernel <= {PARITY_FACTOR:g}x plain); top-1 "
          f"agreement kernel {top1(logits, wide):.3f}, plain "
          f"{top1(plain, wide):.3f}", flush=True)
    if r_kp > BF16_LOGIT_REL or t_kp < BF16_TOP1 or r_k > PARITY_FACTOR * r_p:
        raise RuntimeError(f"bfloat16 serving logits miss the bar: vs plain "
                           f"{r_kp:.3e} (top-1 {t_kp:.3f}); vs float32 kernel "
                           f"{r_k:.3e}, plain {r_p:.3e}")
    del model, logits, plain, wide
    torch.cuda.empty_cache()
    return {"name": cfg.name, "layers": cfg.n_layers,
            "full_layers": full_layers, "n_params": n_params,
            "launches": request, "per_prefill": per_prefill,
            "per_step": per_step, "parity_launches": launched,
            "parity_prefill_ms": parity_ms, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "tok_s": tok_s, "peak": peak,
            "idle": idle, "idle_prefill": idle_prefill}


def int8_phase(device, bf16: dict) -> dict:
    """:data:`INT8_ARCH` at full width and depth with int8 weights,
    quantized (``repro_torch.serve.quantize_params``) from its float32
    parity model (seed 0), which is then freed.  In float32 compute, on
    :data:`PARITY`'s prompts: the prefill and greedy decode steps of the
    int8 path (each block dequantized at its use) equal to those of the
    model dequantized up front, bit for bit (or within
    :data:`INT8_UPFRONT_REL` of max |logit|, said so); the int8 path's
    logits and KV caches within :data:`PARITY_REL` and
    :data:`PARITY_FACTOR` of a float64 prefill of the dequantized weights
    (the plain path's error the factor's base); its logits' correlation
    with the unquantized float32 model's, printed, and held above
    :data:`INT8_CORR` on a cut of :data:`INT8_CORR_LAYERS` layers at full
    width (the depth of the reference's own test).  Then in
    bf16 compute at :data:`SERVE`: prefill ms (median of 2 after a
    warm-up), decode ms a step with the bf16 KV cache, and again with an
    int8 KV cache calibrated from the prompt's keys and values (per prompt
    and kv head, max |value| / 127), whose steps are held against the
    plain path's from the same caches on the same tokens at
    :data:`BF16_LOGIT_REL` and :data:`BF16_TOP1`; the peak device memory
    beside
    ``bf16``'s (the bf16 model's serving run), and the bytes of the
    weights and of the caches."""
    import torch

    from repro_torch import configs as TC
    from repro_torch import models as TM
    from repro_torch.kernels import library as KL
    from repro_torch.serve import (dequantize, quantization_error,
                                   quantize_params)

    cfg = TC.get_config(INT8_ARCH)
    gen = torch.Generator(device=device).manual_seed(5)
    t = time.perf_counter()
    model = TM.init_params(TM.Transformer(cfg, dtype=torch.float32,
                                          device=device), seed=0)
    n_params = TM.count_params(model)
    B, S, n = (PARITY[k] for k in ("B", "S", "decode"))
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device)
    full, _ = TM.prefill(model, tokens)  # the unquantized float32 logits
    q_err = quantization_error(model)
    qm = quantize_params(model)
    del model, _
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"[int8] {cfg.name}: {n_params / 1e9:.3f} G parameters quantized "
          f"from the float32 model in {time.perf_counter() - t:.2f} s (its "
          f"init, a prefill and quantization_error included): int8 values "
          f"and scales {qm.nbytes() / 1e9:.3f} GB resident, against bf16 "
          f"{2 * n_params / 1e9:.3f} GB and float32 {4 * n_params / 1e9:.3f}"
          f" GB; quantization_error {q_err:.3e} (the reference's bar 0.02)",
          flush=True)
    upfront = dequantize(qm)
    KL.reset_launches()
    got = greedy(qm, tokens, n, S + n, "cuda", quantized=True)
    parity_launches = {k: KL.LAUNCHES[k] for k in LM_LAUNCHES}
    ref = greedy(upfront, tokens, n, S + n, "cuda")
    torch.cuda.synchronize()
    same = torch.equal(got[0], ref[0]) and all(
        torch.equal(a[k], b[k]) for a, b in zip(got[1], ref[1]) for k in a)
    rel = ((got[0] - ref[0]).abs().max() / ref[0].abs().max()).item()
    print(f"[int8] float32 compute, B={B} prompt {S} + {n} greedy steps: "
          f"the int8 path (each block dequantized at its use) against the "
          f"model dequantized up front: logits and caches bit for bit "
          f"{same}; max |logit difference| / max |logit| {rel:.3e} (bar "
          f"{INT8_UPFRONT_REL:g} where not bit for bit); greedy tokens "
          f"identical {torch.equal(got[2], ref[2])}; kernel launches "
          f"{parity_launches}", flush=True)
    if not torch.equal(got[2], ref[2]) or (not same
                                           and rel > INT8_UPFRONT_REL):
        raise RuntimeError("the int8 path differs from the model "
                           "dequantized up front")
    if not same:
        print("[int8] not bit for bit: cuBLAS picked another algorithm for "
              "one of the paths' products", flush=True)
    plain, plain_caches = TM.prefill(qm, tokens, cache_len=S + n,
                                     backend="ref", quantized=True)
    exact = prefill_wide(upfront, tokens, torch.float64)
    del upfront, ref
    torch.cuda.empty_cache()
    cases = [("logits", got[0], plain, exact[0])] + [
        (f"{leaf}{i}", a[leaf][:, :S], b[leaf][:, :S], x[leaf])
        for i, (a, b, x) in enumerate(zip(got[1], plain_caches, exact[1]))
        for leaf in x]
    for name, a, b, x in cases:
        scale = x.abs().max().item()
        e_k = (a.double() - x).abs().max().item()
        e_p = (b.double() - x).abs().max().item()
        if not torch.isfinite(a).all() or parity_fails(e_k, e_p, scale):
            raise RuntimeError(
                f"int8 parity: {name} is {e_k:.3e} from float64 (max |value|"
                f" {scale:.3f}), the plain path {e_p:.3e}")
        if name in ("logits", "k0"):
            print(f"[int8] {name}: max abs vs a float64 prefill of the "
                  f"dequantized weights: int8 kernel path {e_k:.3e}, plain "
                  f"path {e_p:.3e} (bars {PARITY_REL:g} x max |value| "
                  f"{scale:.3f}, {PARITY_FACTOR:g}x plain); every cache "
                  f"held alike", flush=True)
    def correlation(a, b):
        return torch.corrcoef(torch.stack([a.flatten(), b.flatten()])
                              .double())[0, 1].item()

    corr = correlation(got[0], full)
    del got, plain, plain_caches, exact, cases
    torch.cuda.empty_cache()
    # the reference's bar at its own test's depth, at full width
    cut = dataclasses.replace(cfg, n_layers=INT8_CORR_LAYERS)
    small = TM.init_params(TM.Transformer(cut, dtype=torch.float32,
                                          device=device), seed=0)
    want, _ = TM.prefill(small, tokens)
    corr_cut = correlation(TM.prefill(quantize_params(small), tokens,
                                      quantized=True)[0], want)
    del small, want
    torch.cuda.empty_cache()
    print(f"[int8] logits of the int8 path against the unquantized float32 "
          f"model's: correlation at {cfg.n_layers} layers {corr:.6f}, at "
          f"the reference's test depth ({INT8_CORR_LAYERS} layers, full "
          f"width, the same prompts) {corr_cut:.6f} (the reference's bar "
          f"> {INT8_CORR:g}, held there)", flush=True)
    if not corr_cut > INT8_CORR:
        raise RuntimeError(f"int8 logits correlate {corr_cut:.4f} with "
                           f"float32 at {INT8_CORR_LAYERS} layers")

    q16 = qm.with_dtype(torch.bfloat16)
    B, S, n, size = (SERVE[k] for k in ("B", "S", "decode", "cache"))
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device)
    logits, caches = TM.prefill(q16, tokens, cache_len=size, quantized=True)
    del logits, caches
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        logits = caches = None
        torch.cuda.synchronize()
        KL.reset_launches()
        t = time.perf_counter()
        logits, caches = TM.prefill(q16, tokens, cache_len=size,
                                    quantized=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        per_prefill = {k: KL.LAUNCHES[k] for k in LM_LAUNCHES}
    prefill_ms = 1e3 * statistics.median(times)
    first = logits.argmax(-1)
    runs, launches, held = {}, dict(per_prefill), None
    for kv in ("bf16", "int8"):
        if kv == "int8":
            # the prompt's keys and values, quantized with per (prompt, kv
            # head) scales calibrated from them
            qcaches = TM.init_caches(cfg, B, size, dtype=torch.bfloat16,
                                     device=device, quant_kv=True)
            for c, f in zip(qcaches, caches):
                for key in ("k", "v"):
                    prompt = f[key][:, :S].float()
                    sc = prompt.abs().amax(dim=(1, 3), keepdim=True)
                    c[f"{key}_s"].copy_(sc.clamp_min(1e-6) / 127.0)
                    c[key][:, :S] = torch.clamp(torch.round(
                        prompt / c[f"{key}_s"]), -127, 127)
            del caches
            caches = qcaches
            # for the plain path's decode from the same calibrated caches,
            # held on the host so that the peak is the served run's
            held = [{k: v.cpu() for k, v in c.items()} for c in caches]
        tok, steps, toks, step_logits = first, [], [], []
        KL.reset_launches()
        for i in range(n):
            t = time.perf_counter()
            step, caches = TM.decode_step(q16, tok, caches, S + i,
                                          quantized=True)
            tok = step.argmax(-1)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t)
            toks.append(tok)
            step_logits.append(step)
        first_logits = step_logits[0]
        for k in LM_LAUNCHES:
            launches[k] += KL.LAUNCHES[k]
        kv_bytes = sum(t.numel() * t.element_size() for c in caches
                       for t in c.values())
        runs[kv] = (1e3 * statistics.median(steps), kv_bytes,
                    first_logits, {k: KL.LAUNCHES[k] / n
                                   for k in LM_LAUNCHES},
                    torch.cat(toks, dim=1), step_logits)
        print(f"[int8] a traced decode step, int8 weights, {kv} KV cache:",
              flush=True)
        trace_step(lambda c: TM.decode_step(q16, tok, c, S + n,
                                            quantized=True), caches,
                   runs[kv][0], untraced="median decode step")
        if not torch.isfinite(step).all():
            raise RuntimeError(f"int8 serving with a {kv} KV cache: "
                               "non-finite logits")
    peak = torch.cuda.max_memory_allocated()
    del caches
    # the int8 KV decode on the plain path, from the same calibrated caches
    # on the same tokens (the kernel path's), held as bf16 serving is
    caches = [{k: v.to(device) for k, v in c.items()} for c in held]
    del held
    inputs = [first] + [runs["int8"][4][:, i:i + 1] for i in range(n - 1)]
    r_kv, agree = 0.0, 0.0
    for i, tk in enumerate(inputs):
        step, caches = TM.decode_step(q16, tk, caches, S + i,
                                      quantized=True, backend="ref")
        got = runs["int8"][5][i]
        r_kv = max(r_kv, ((got.float() - step.float()).abs().max()
                          / step.float().abs().max()).item())
        agree += (got.argmax(-1) == step.argmax(-1)).float().mean().item()
    agree /= n
    del caches, step
    print(f"[int8] int8 KV cache, {n} decode steps from the same calibrated "
          f"caches on the same tokens, kernel path against the plain path: "
          f"worst step's max |logit difference| / max |logit| {r_kv:.3e} "
          f"(bar {BF16_LOGIT_REL:g}); top-1 agreement {agree:.3f} over "
          f"{n} steps x {B} prompts (bar {BF16_TOP1:g})", flush=True)
    if r_kv > BF16_LOGIT_REL or agree < BF16_TOP1:
        raise RuntimeError(f"int8 KV decode: the kernel path is {r_kv:.3e} "
                           f"of max |logit| from the plain path, top-1 "
                           f"agreement {agree:.3f}")
    print("[int8] a traced prefill, int8 weights:", flush=True)
    trace_step(lambda _: TM.prefill(q16, tokens, cache_len=size,
                                    quantized=True), None, prefill_ms,
               untraced="median prefill", groups=PREFILL_GROUPS)
    a, b = runs["int8"][2], runs["bf16"][2]
    kv_rel = ((a - b).abs().max() / b.abs().max()).item()
    kv_top1 = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    kv_greedy = (runs["int8"][4] == runs["bf16"][4]).float().mean().item()
    want = {"flash_attention": cfg.n_layers, "flash_attention_window": 0,
            "rmsnorm": cfg.n_layers + 1, "rmsnorm_residual": cfg.n_layers,
            "ssm_state_scan": 0}
    print(f"[int8] bf16 compute, B={B} prompts of {S} tokens, caches of "
          f"{size}: prefill ms {[round(1e3 * x, 3) for x in times]} -> "
          f"median {prefill_ms:.3f} ms (the bf16 model's "
          f"{bf16['prefill_ms']:.3f});"
          f" decode ms a step, median of {n}: bf16 KV cache "
          f"{runs['bf16'][0]:.3f}, int8 KV cache {runs['int8'][0]:.3f} (the "
          f"bf16 model's {bf16['decode_ms']:.3f}); the first decode step's "
          f"logits with the int8 cache against the bf16 cache's: max "
          f"|difference| / max |logit| {kv_rel:.3e}, top-1 agreement "
          f"{kv_top1:.3f} over {B} prompts; the {n} greedy tokens of each "
          f"prompt (each run its own) agree in {kv_greedy:.3f} of them",
          flush=True)
    print(f"[int8] bytes: weights {qm.nbytes() / 1e9:.3f} GB (bf16 "
          f"{2 * n_params / 1e9:.3f}); KV caches bf16 "
          f"{runs['bf16'][1] / 1e9:.3f} GB, int8 {runs['int8'][1] / 1e9:.3f} "
          f"GB; peak device memory from the timed prefills through both "
          f"decodes {peak / 2**30:.3f} GiB (the bf16 model's serving peak "
          f"{bf16['peak'] / 2**30:.3f} GiB)")
    print(f"[int8] launches per prefill {per_prefill}; per decode step "
          f"{runs['bf16'][3]} (expected {want} and the same less K8)",
          flush=True)
    step_want = dict(want, flash_attention=0)
    if per_prefill != want or any(r[3] != step_want for r in runs.values()):
        raise RuntimeError("the int8 run did not launch K8/K9 as expected")
    del q16, qm, logits
    torch.cuda.empty_cache()
    return {"name": f"{cfg.name} int8", "launches": launches,
            "parity_launches": parity_launches, "prefill_ms": prefill_ms,
            "decode_ms": runs["bf16"][0], "decode_kv8_ms": runs["int8"][0],
            "peak": peak}


def slstm_scan_ms(model, tokens) -> float:
    """CUDA-event ms of one sLSTM layer's mixer (the hoisted ``x @ w_in``,
    the scan over the prompt's steps, ``@ wo``) at the serving shape, on
    the normed embeddings of ``tokens``: a call's host time included,
    since the scan's launches are what it waits on."""
    from repro_torch.kernels import ops

    blk = next(b for b in model.layers if getattr(b, "btype", "") == "slstm")
    h = ops.rmsnorm(model.embed[tokens], blk.ln1, eps=model.cfg.norm_eps)
    return cuda_ms(lambda: blk.slstm(h), 1)


def ssd_chunks_ms(model, tokens) -> float:
    """CUDA-event ms of one Mamba-2 layer's intra-chunk work
    (``Mamba2.ssd_chunks``) at the serving shape, on the inputs the first
    Mamba-2 layer makes of the embedded ``tokens``."""
    from repro_torch.kernels import ops

    blk = next(b for b in model.layers if hasattr(b, "mamba"))
    h = ops.rmsnorm(model.embed[tokens], blk.ln1, eps=model.cfg.norm_eps)
    _, _, args = blk.mamba.chunk_inputs(h)
    return cuda_ms(lambda: blk.mamba.ssd_chunks(*args), 3)


def grad_errors(name: str, got: tuple, plain: tuple, exact: tuple,
                bar: float = PARITY_REL) -> list:
    """Each gradient of the kernel (``got``) and of the plain version
    (``plain``) against a float64 plain run (``exact``): (kernel, plain)
    max abs errors and the bar, the largest |value| of the float64
    gradient.  Raises unless the kernel's error is within ``bar`` of that
    scale and within :data:`PARITY_FACTOR` of the plain version's."""
    out = []
    for i, (g, p, e) in enumerate(zip(got, plain, exact)):
        scale = e.abs().max().item()
        ek = (g.double() - e).abs().max().item()
        ep = (p.double() - e).abs().max().item()
        out.append((ek, ep, scale))
        if not (ek <= bar * scale and ek <= PARITY_FACTOR * ep):
            raise RuntimeError(
                f"{name} gradient {i}: {ek:.3e} from float64, bar "
                f"{bar:g} x {scale:.3e} and {PARITY_FACTOR:g}x the plain "
                f"version's {ep:.3e}")
    return out


def backward_phase(device) -> dict:
    """K8's and K9's backward kernels against their plain versions on the
    card: float32 against a float64 plain run of the same inputs (within
    :data:`PARITY_REL` of each gradient's largest |value|, and within
    :data:`PARITY_FACTOR` of the float32 plain version's error; K8's on the
    plain forward's o and lse, and on the forward kernel's within
    :data:`PARITY_REL`), bf16 against the plain version at K8's and K9's
    bf16 tolerances and, row by row against float64, within
    :data:`FA_F64_FACTOR` of the plain version (K8: the forward kernel's o
    and lse into the backward kernel against the plain forward's into the
    plain backward; K8's mean also within it of the same equations with dS
    kept in float32, the plain version's ``round_ds=False``); the lse K8's
    forward writes against the plain forward's at :data:`LSE_TOL`; each
    timed beside the plain version, its bound and one library call: SDPA's
    backward alone through autograd on a kept forward graph for K8 (its
    forward and backward printed beside it), ``F.rms_norm``'s backward for
    K9."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref as KR
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd,
                                             rmsnorm_residual_bwd)

    gen = torch.Generator(device=device).manual_seed(5)
    out = {"K8": [], "K9": []}

    def normal(shape, dtype):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        size = torch.finfo(dtype).bits // 8
        for shape in BWD_FA:
            B, S, H, KVH, D, window, cap = (shape[k] for k in (
                "B", "S", "H", "KVH", "D", "window", "softcap"))
            q, do = normal((B, S, H, D), dtype), normal((B, S, H, D), dtype)
            k, v = normal((B, S, KVH, D), dtype), normal((B, S, KVH, D),
                                                          dtype)
            lse = torch.empty((B, H, S), device=device)
            o = flash_attention(q, k, v, softcap=cap, window=window, lse=lse)
            got = flash_attention_bwd(q, k, v, o, lse, do, softcap=cap,
                                      window=window)
            torch.cuda.synchronize()
            label = (f"K8 backward {name} B={B} S={S} H={H} KVH={KVH} D={D} "
                     f"window={window} softcap={cap:g}")
            if not all(torch.isfinite(g).all() for g in got):
                raise RuntimeError(f"{label}: non-finite gradient")
            # the lse the forward kernel writes against the plain
            # forward's, and both against float64 (printed)
            p_o, p_lse = KR.flash_attention_fwd_ref(
                q, k, v, softcap=cap, window=window)
            p_o = p_o.contiguous()
            lse_err = check_close(f"{label} lse", lse, p_lse, *LSE_TOL)
            lse64 = [0.0, 0.0]
            chain = got
            if dtype == torch.float32:
                # the backward kernel and its plain version on the same o
                # and lse, the plain forward's (the f32 forward kernel's are
                # 3xTF32 products: K8's forward is held on its own), each
                # against a float64 run, and the kernels' forward and
                # backward together (training's chain) within PARITY_REL
                got = flash_attention_bwd(q, k, v, p_o, p_lse, do,
                                          softcap=cap, window=window)
            # one batch entry at a time for the plain runs ((H, S, S)
            # scores: 1.1 GB in float64 at Granite's shape)
            errs, chained, err = None, [0.0, 0.0, 0.0], 0.0
            kstats, pstats, cstats, ustats = ([None] * 3 for _ in range(4))
            for b in range(B):
                one = tuple(x[b:b + 1] for x in (q, k, v))
                plain = KR.flash_attention_bwd_ref(
                    *one, p_o[b:b + 1], p_lse[b:b + 1], do[b:b + 1],
                    softcap=cap, window=window)
                one64 = tuple(x.double() for x in one)
                e_o, e_lse = KR.flash_attention_fwd_ref(
                    *one64, softcap=cap, window=window)
                exact = KR.flash_attention_bwd_ref(
                    *one64, e_o, e_lse, do[b:b + 1].double(),
                    softcap=cap, window=window)
                lse64 = [max(m, (x[b:b + 1].double() - e_lse).abs().max()
                             .item()) for m, x in zip(lse64, (lse, p_lse))]
                if dtype == torch.float32:
                    mine = tuple(g[b:b + 1] for g in got)
                    rows = [((g.double() - e).abs().max().item(),
                             (p.double() - e).abs().max().item(),
                             e.abs().max().item())
                            for g, p, e in zip(mine, plain, exact)]
                    errs = rows if errs is None else [
                        tuple(max(a, c) for a, c in zip(r0, r1))
                        for r0, r1 in zip(errs, rows)]
                    chained = [max(m, (g[b:b + 1].double() - e).abs().max()
                                   .item())
                               for m, g, e in zip(chained, chain, exact)]
                else:
                    # the backward kernel and its plain version on the
                    # forward kernel's o and lse (what training gives it),
                    # at FA_TOL and row by row against float64; and
                    # training's chain against the plain path's (the plain
                    # forward's o and lse into the plain backward), ``plain``
                    floor = ROW_FLOOR * max(e.norm(dim=-1).max().item()
                                            for e in exact)
                    same = KR.flash_attention_bwd_ref(
                        *one, o[b:b + 1], lse[b:b + 1], do[b:b + 1],
                        softcap=cap, window=window)
                    # the same equations with dS kept in float32: what
                    # rounding dS to enter the tensor cores costs
                    unround = KR.flash_attention_bwd_ref(
                        *one, o[b:b + 1], lse[b:b + 1], do[b:b + 1],
                        softcap=cap, window=window, round_ds=False)
                    for i, e in enumerate(exact):
                        mine = got[i][b:b + 1]
                        err = max(err, check_close(
                            f"{label} d{'qkv'[i]}", mine, same[i],
                            *FA_TOL[name]))
                        kstats[i] = merge_stats(kstats[i], row_stats(
                            mine, e, floor))
                        pstats[i] = merge_stats(pstats[i], row_stats(
                            same[i], e, floor))
                        cstats[i] = merge_stats(cstats[i], row_stats(
                            plain[i], e, floor))
                        ustats[i] = merge_stats(ustats[i], row_stats(
                            unround[i], e, floor))
                    del same, unround
                del plain, exact, e_o, e_lse
            lse_detail = (f"lse {lse_err:.3e} from the plain forward's "
                          f"(rtol {LSE_TOL[0]:g} + atol {LSE_TOL[1]:g}), "
                          f"from float64 kernel {lse64[0]:.3e} plain "
                          f"{lse64[1]:.3e}")
            if dtype == torch.float32:
                for i, (ek, ep, scale) in enumerate(errs):
                    if not (ek <= PARITY_REL * scale
                            and ek <= PARITY_FACTOR * ep):
                        raise RuntimeError(
                            f"{label} d{'qkv'[i]}: {ek:.3e} from float64, "
                            f"bar {PARITY_REL:g} x {scale:.3e} and "
                            f"{PARITY_FACTOR:g}x the plain version's "
                            f"{ep:.3e}")
                    if not chained[i] <= PARITY_REL * scale:
                        raise RuntimeError(
                            f"{label} d{'qkv'[i]} on the forward kernel's o "
                            f"and lse: {chained[i]:.3e} from float64, bar "
                            f"{PARITY_REL:g} x {scale:.3e}")
                err = max(e[0] for e in errs)
                detail = ", ".join(
                    f"d{'qkv'[i]} kernel {ek:.3e} plain {ep:.3e} of "
                    f"{scale:.3e}" for i, (ek, ep, scale) in enumerate(errs))
                detail += (f"; on the forward kernel's o and lse "
                           f"{', '.join(f'{c:.3e}' for c in chained)} (bar "
                           f"{PARITY_REL:g} of each)")
            else:
                held = [hold_rows(f"{label} d{'qkv'[i]}", kstats[i],
                                  pstats[i]) for i in range(3)]
                chain_mean = [(kstats[i][0] / kstats[i][1],
                               cstats[i][0] / cstats[i][1])
                              for i in range(3)]
                for i, (km, cm) in enumerate(chain_mean):
                    if not km <= FA_F64_FACTOR * cm:
                        raise RuntimeError(
                            f"{label} d{'qkv'[i]}: training's chain mean "
                            f"row error against float64 {km:.3e}, beyond "
                            f"{FA_F64_FACTOR:g}x the plain path's {cm:.3e}")
                # the bar that does not move with the plain version's own
                # rounding of dS: the equations with dS in float32
                unround_mean = [ustats[i][0] / ustats[i][1]
                                for i in range(3)]
                for i, um in enumerate(unround_mean):
                    km = kstats[i][0] / kstats[i][1]
                    if not km <= FA_F64_FACTOR * um:
                        raise RuntimeError(
                            f"{label} d{'qkv'[i]}: mean row error against "
                            f"float64 {km:.3e}, beyond {FA_F64_FACTOR:g}x "
                            f"the unrounded-dS equations' {um:.3e}")
                rtol, atol = FA_TOL[name]
                detail = f"tol rtol {rtol:g} + atol {atol:g}; " + ", ".join(
                    f"d{'qkv'[i]} row/|row| against float64 mean kernel "
                    f"{h['mean'][0]:.3e} plain {h['mean'][1]:.3e}, max "
                    f"kernel {h['max'][0]:.3e} plain {h['max'][1]:.3e}"
                    for i, h in enumerate(held))
                detail += (f" (bar {FA_F64_FACTOR:g}x plain); with dS "
                           f"unrounded mean " + ", ".join(
                               f"{um:.3e}" for um in unround_mean)
                           + f" (bar {FA_F64_FACTOR:g}x); the plain "
                           f"path's chain mean " + ", ".join(
                               f"{cm:.3e}" for _, cm in chain_mean)
                           + f" (bar {FA_F64_FACTOR:g}x), max "
                           + ", ".join(f"{c[2]:.3e}" for c in cstats))
            detail += "; " + lse_detail
            del p_o, p_lse, chain
            del got
            torch.cuda.empty_cache()
            ms = cuda_ms(lambda: flash_attention_bwd(
                q, k, v, o, lse, do, softcap=cap, window=window), 3)
            fwd_bwd_ms = cuda_ms(lambda: (flash_attention(
                q, k, v, softcap=cap, window=window, lse=lse),
                flash_attention_bwd(q, k, v, o, lse, do, softcap=cap,
                                    window=window)), 3)
            # the forward with and without writing lse, in turns
            fwd = in_turns({
                "lse": lambda: flash_attention(q, k, v, softcap=cap,
                                               window=window, lse=lse),
                "none": lambda: flash_attention(q, k, v, softcap=cap,
                                                window=window)},
                lambda fn: cuda_ms(fn, 10), rounds=3)
            plain_ms = cuda_ms(lambda: KR.flash_attention_bwd_ref(
                q, k, v, o, lse, do, softcap=cap, window=window), 1)
            torch.cuda.empty_cache()
            # SDPA forward + backward (autograd), the window as a boolean
            # mask; it takes no softcap
            leaves = [x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v)]
            keep = (KR.attention_mask(S, window, device) if window else None)
            dot = do.transpose(1, 2)

            def sdpa_fwd():
                return (F.scaled_dot_product_attention(
                    *leaves, is_causal=True, enable_gqa=True) if keep is None
                    else F.scaled_dot_product_attention(
                        *leaves, attn_mask=keep, enable_gqa=True))

            pair_ms = cuda_ms(lambda: torch.autograd.grad(
                sdpa_fwd(), leaves, dot), 3)
            # SDPA's backward alone: its graph kept from one forward
            kept = sdpa_fwd()
            lib_ms = cuda_ms(lambda: torch.autograd.grad(
                kept, leaves, dot, retain_graph=True), 3)
            del leaves, keep, dot, kept
            # bytes: q, k, v, o, dO read once, dq, dk, dv written once;
            # operations: the five products over the kept pairs (S and dP
            # recomputed, dV, dK, dQ), 2 D flops each a pair
            bwd_bytes = (4 * q.numel() + 4 * k.numel()) * size \
                + 2 * lse.numel() * 4
            # (bf16 once at 989 TFLOP/s; f32 as three TF32 products, 3x
            # over 495, its CUDA-core figure, once over 67, printed beside)
            bwd_ops = 10 * B * H * D * attention_pairs(S, window)
            if dtype == torch.bfloat16:
                t_o = bwd_ops / BF16_OPS_PER_S
                ops_note = (f"{bwd_ops:.3e} flops at "
                            f"{BF16_OPS_PER_S / 1e12:g} TFLOP/s")
            else:
                t_o = 3 * bwd_ops / TF32_OPS_PER_S
                ops_note = (f"3 x {bwd_ops:.3e} flops (3xTF32) at "
                            f"{TF32_OPS_PER_S / 1e12:g} TFLOP/s; on f32 FMAs "
                            f"at {F32_OPS_PER_S / 1e12:g} "
                            f"{1e3 * bwd_ops / F32_OPS_PER_S:.4f} ms")
            t_b = bwd_bytes / HBM_BYTES_PER_S
            out["K8"].append(dict(
                dtype=name, D=D, window=window, softcap=cap, err=err, ms=ms,
                plain_ms=plain_ms, fwd_bwd_ms=fwd_bwd_ms,
                fwd_ms=fwd["none"], fwd_lse_ms=fwd["lse"],
                bound_ms=1e3 * max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                library_ms=lib_ms))
            print(f"[bwd] {label}: max_abs_err={err:.3e} ({detail}) "
                  f"ms={ms:.4f} (forward with lse + backward "
                  f"{fwd_bwd_ms:.4f}; the forward {fwd['none']:.4f}, with "
                  f"lse {fwd['lse']:.4f}) plain_ms={plain_ms:.4f} bound_ms="
                  f"{1e3 * max(t_b, t_o):.4f} ({out['K8'][-1]['bound_by']}; "
                  f"{ops_note}, "
                  f"{bwd_bytes / 1e6:.1f} MB; the backward runs "
                  f"{bwd_ops / ms / 1e9:.1f} TFLOP/s of those 5 products, "
                  f"{1.4 * bwd_ops / ms / 1e9:.1f} of the 7 it runs) "
                  f"library_ms={lib_ms:.4f} (F.scaled_dot_product_attention"
                  f"'s backward alone, on a kept forward graph; its forward "
                  f"+ backward {pair_ms:.4f}"
                  f"{'; the window as a mask, no softcap' if window else ''})",
                  flush=True)
            del q, k, v, o, lse, do
            torch.cuda.empty_cache()

        rows_n, d = BWD_NORM
        for residual in (False, True):
            x, r = normal((rows_n, d), dtype), normal((rows_n, d), dtype)
            g, gs = normal((rows_n, d), dtype), normal((rows_n, d), dtype)
            w = 0.1 * torch.randn(d, generator=gen, device=device)  # f32
            form = "rmsnorm_residual" if residual else "rmsnorm"
            label = f"K9 {form} backward {name} ({rows_n}, {d})"

            def kernel():
                return (rmsnorm_residual_bwd(x, r, w, g, gs) if residual
                        else rmsnorm_bwd(x, w, g))

            def plain(*a):
                return (KR.rmsnorm_residual_bwd_ref(*a) if residual
                        else KR.rmsnorm_bwd_ref(*a))

            args = (x, r, w, g, gs) if residual else (x, w, g)
            got = kernel()
            want = plain(*args)
            torch.cuda.synchronize()
            if dtype == torch.float32:
                exact = plain(*(a.double() for a in args))
                errs = grad_errors(label, got, want, exact)
                err = max(e[0] for e in errs)
                detail = ", ".join(
                    f"d{n} kernel {ek:.3e} plain {ep:.3e} of {sc:.3e}"
                    for n, (ek, ep, sc) in zip(("x", "w"), errs))
                del exact
            else:
                tol = NORM_TOL[name]
                err = max(check_close(f"{label} d{n}", a, b, tol, tol)
                          for n, a, b in zip(("x", "w"), got, want))
                # and as K8's bf16: each row (dw: one) against float64
                exact = plain(*(a.double() for a in args))
                held = [hold_rows(f"{label} d{n}", row_stats(a, e),
                                  row_stats(b, e))
                        for n, a, b, e in zip(("x", "w"), got, want, exact)]
                detail = f"tol rtol = atol = {tol:g}; " + ", ".join(
                    f"d{n} row/|row| against float64 mean kernel "
                    f"{h['mean'][0]:.3e} plain {h['mean'][1]:.3e}, max "
                    f"kernel {h['max'][0]:.3e} plain {h['max'][1]:.3e}"
                    for n, h in zip(("x", "w"), held))
                detail += f" (bar {FA_F64_FACTOR:g}x plain)"
                del exact
            del got, want
            ms = cuda_ms(kernel, 20, warmup=3)
            plain_ms = cuda_ms(lambda: plain(*args), 3)
            lib_ms = None
            if not residual:
                # F.rms_norm's backward alone (its graph kept), weight 1 + w
                xl = x.detach().requires_grad_()
                w1 = (1.0 + w).to(dtype).requires_grad_()
                y = F.rms_norm(xl, (d,), weight=w1, eps=1e-5)
                lib_ms = cuda_ms(lambda: torch.autograd.grad(
                    y, (xl, w1), g, retain_graph=True), 20, warmup=3)
                del xl, w1, y
            n_io = (5 if residual else 3) * x.numel() * size + 2 * d * 4
            t_b = n_io / HBM_BYTES_PER_S
            out["K9"].append(dict(
                form=form, dtype=name, rows=rows_n, d=d, err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=1e3 * t_b, bound_by="bytes",
                library_ms=lib_ms))
            print(f"[bwd] {label}: max_abs_err={err:.3e} ({detail}) "
                  f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms="
                  f"{1e3 * t_b:.4f} (bytes; {n_io / 1e6:.1f} MB) library_ms="
                  + ("none (no one call)" if lib_ms is None else
                     f"{lib_ms:.4f} (F.rms_norm backward)"), flush=True)
            del x, r, g, gs, w
            torch.cuda.empty_cache()
    out["K10"] = scan_backward(device, gen)
    return out


def scan_backward(device, gen) -> list:
    """K10's backward (float32) at :data:`BWD_SCAN` against its plain
    version and a float64 plain run on seeded states, decay in (0, 1] and a
    seeded output gradient, on the forward kernel's output: each gradient
    within :data:`PARITY_REL` of its largest |value| and
    :data:`PARITY_FACTOR` of the plain version's error (:func:`grad_errors`),
    the same bits in two runs, timed beside the plain version and its
    bound (g and out read once, d states written once, decay read and d
    decay written once); no one PyTorch call computes it."""
    import torch

    from repro_torch.kernels import ref as KR
    from repro_torch.kernels.ssm_scan import (ssm_state_scan,
                                              ssm_state_scan_bwd)

    rows = []
    for shape in BWD_SCAN:
        states = torch.randn(shape, generator=gen, device=device)
        decay = 1.0 - torch.rand(shape[:3], generator=gen, device=device)
        g = torch.randn(shape, generator=gen, device=device)
        out = ssm_state_scan(states, decay)
        got = ssm_state_scan_bwd(g, out, decay)
        again = ssm_state_scan_bwd(g, out, decay)
        plain = KR.ssm_state_scan_bwd_ref(g, out, decay)
        torch.cuda.synchronize()
        label = f"K10 backward float32 {shape}"
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{label}: two runs differ")
        exact = KR.ssm_state_scan_bwd_ref(
            g.double(), KR.ssm_state_scan_ref(states.double(),
                                              decay.double()),
            decay.double())
        errs = grad_errors(label, got, plain, exact)
        same_ds = torch.equal(got[0], plain[0])
        del exact, again, plain
        ms = cuda_ms(lambda: ssm_state_scan_bwd(g, out, decay), 20,
                     warmup=3)
        plain_ms = cuda_ms(lambda: KR.ssm_state_scan_bwd_ref(g, out, decay),
                           3)
        n_io = 3 * g.numel() * 4 + 2 * decay.numel() * 4
        t_b = n_io / HBM_BYTES_PER_S
        rows.append(dict(shape=shape, err=max(e[0] for e in errs), ms=ms,
                         plain_ms=plain_ms, bound_ms=1e3 * t_b,
                         bound_by="bytes", library_ms=None))
        print(f"[bwd] {label}: max_abs_err={rows[-1]['err']:.3e} ("
              + ", ".join(f"d{n} kernel {ek:.3e} plain {ep:.3e} of {sc:.3e}"
                          for n, (ek, ep, sc) in zip(("states", "decay"),
                                                     errs))
              + f"; d states {'equal to' if same_ds else 'not'} the plain "
              f"version's bits; two runs the same bits) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={1e3 * t_b:.4f} (bytes; "
              f"{n_io / 1e6:.1f} MB) library_ms=none (no one call)",
              flush=True)
        del states, decay, g, out, got
        torch.cuda.empty_cache()
    return rows


def train_model(device, arch: str, layers: int | None, seed: int = 0):
    """``arch`` at full width, cut to ``layers`` layers (None: its
    config's depth), float32 masters from ``init_params(seed)``,
    trainable."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Transformer, init_params

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = init_params(Transformer(cfg, dtype=torch.float32, device=device),
                        seed=seed)
    return cfg, model.requires_grad_(True)


def train_kernels(cfg, S: int) -> tuple:
    """The :data:`library.LAUNCHES` keys a training step of ``cfg`` over
    S tokens must count, from its pattern: K9's (:data:`TRAIN_NORM`)
    always; K8's (:data:`TRAIN_ATTN`) where it has attention blocks, and
    K9's residual instance where one of them has a feed-forward after it
    (not in a ``parallel_block`` model); K10's where it has Mamba-2 layers;
    K8's window instances where it has local layers whose window S
    passes.  Every other key must stay at 0."""
    from repro_torch.models.transformer import has_ffn

    keys = TRAIN_NORM
    attn = [b for b in cfg.pattern if b in ("attn", "local", "shared_attn")]
    if attn:
        keys += TRAIN_ATTN
        if not cfg.parallel_block and any(has_ffn(b, cfg) for b in attn):
            keys += TRAIN_RESIDUAL
    if "mamba2" in cfg.pattern:
        keys += TRAIN_SCAN
    if "local" in cfg.pattern and 0 < cfg.window < S:
        keys += TRAIN_WINDOW
    return keys


def train_flops(model, B: int, S: int) -> float:
    """Model FLOPs of a training step over B x S tokens: 3 x the forward's
    (the backward twice it; the recomputation under remat not counted).
    The forward: 2 a matrix weight a token (every 2-D weight of each block
    application, the shared block at each of its applications, and the
    unembedding; not the embedding's gather nor Mamba-2's depthwise conv),
    the two attention products over the (query, key) pairs the causal mask
    and the window keep, 4 D flops a pair a head, and Mamba-2's four chunk
    einsums as ``Mamba2.forward`` computes them (C B^T and its product with
    x over whole L x L chunks, the chunk states and the inter-chunk
    term).  An MoE block's experts (3-D weights): top_k experts' weights a
    token (its router and shared expert are 2-D).  An mLSTM's chunk
    products as ``MLSTM.forward`` computes them, a head a token: q k^T and
    its product with v over whole L x L chunks (4 L dh), the state terms
    q C and the chunk's C (4 dh^2), q n and n (4 dh).  An sLSTM's
    recurrence ``h @ r``: 2 x 4 dh^2 a head a token."""
    from repro_torch.models.layers import MoE
    from repro_torch.models.ssm import chunk_len

    cfg = model.cfg
    H, dh = cfg.n_heads, cfg.d_head
    fwd = 2 * B * S * cfg.d_model * cfg.vocab
    for blk in model.stack():
        fwd += 2 * B * S * sum(p.numel() for n, p in blk.named_parameters()
                               if p.dim() == 2 and "conv" not in n)
        moe = getattr(blk, "ffn", None)
        if isinstance(moe, MoE):
            fwd += 2 * B * S * moe.moe.top_k * sum(
                p.numel() for p in moe.parameters()
                if p.dim() == 3) // moe.moe.n_experts
        if block_type(blk) == "attn":
            window = cfg.window if getattr(blk, "local", False) else 0
            fwd += 4 * B * H * dh * attention_pairs(S, window)
        elif block_type(blk) == "mlstm":
            L = chunk_len(S, blk.mlstm.chunk)
            fwd += B * S * H * (4 * L * dh + 4 * dh * dh + 4 * dh)
        elif block_type(blk) == "slstm":
            fwd += B * S * H * 8 * dh * dh
        elif block_type(blk) == "mamba2":
            m = blk.mamba
            L = chunk_len(S, m.chunk)
            fwd += (2 * B * S * L * (m.N + m.H * m.P)
                    + 4 * B * S * m.N * m.H * m.P)
    return 3 * fwd


def train_parity_phase(device, arch: str) -> dict:
    """One step's loss and gradients of ``arch`` at full width and
    :data:`TRAIN_PARITY`'s depth and batch through the kernels (K8, K9 and,
    by the model, K10 and K8's window instance, forward and backward;
    :func:`train_kernels`, and no other) and through the plain versions
    (``backend="ref"``, torch's autograd), the same weights and batch:
    float32 within :data:`TRAIN_LOSS_REL` and :data:`TRAIN_GRAD_REL`; in
    bf16 the kernel path's distance to the plain path within
    :data:`PARITY_FACTOR` of the plain path's own distance to its float32
    run (the bar of ``tests/test_torch_train_step.py``, where the port's
    bf16 step sits within the reference's bf16-vs-float32 distance).  Each
    dtype runs the plain path first; one gradient set at a time is kept, on
    the host (an MoE layer's is ~20 GB), and each of its tensors is brought
    back to the card to be compared with the next run's.  An MoE model's
    bf16 runs print the (token, layer) expert choices that differ between
    the paths (:func:`moe_routes`, the forward's, not the
    recomputation's)."""
    import torch

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import library as KL
    from repro_torch.models import loss_fn
    from repro_torch.models.layers import MoE

    B, S, layers = (TRAIN_PARITY[arch][k] for k in ("B", "S", "layers"))
    cfg, model = train_model(device, arch, layers)
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=S,
                                  global_batch=B, seed=0), 0, device=device)
    keys = train_kernels(cfg, S)
    print(f"[train-parity] {arch}: {cfg.n_layers} layers "
          f"({'/'.join(cfg.pattern)}) at full width, {B} x {S} tokens",
          flush=True)
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    n_moe = sum(isinstance(getattr(b, "ffn", None), MoE)
                for b in model.stack()) if cfg.moe else 0
    routes = {}

    def run(dtype, backend):
        model.zero_grad(set_to_none=True)
        KL.reset_launches()
        with moe_routes(routes.setdefault((dtype, backend), [])):
            loss = loss_fn(model, batch["tokens"], batch["labels"],
                           dtype=dtype, backend=backend)
            loss.backward()
        torch.cuda.synchronize()
        launches = {k: KL.LAUNCHES[k] for k in keys}
        if backend == "ref" and any(KL.LAUNCHES.values()):
            raise RuntimeError(f"the plain path launched {KL.LAUNCHES}")
        if backend == "cuda" and not all(launches.values()):
            raise RuntimeError(f"the kernel path skipped a kernel: "
                               f"{launches}")
        stray = {k: v for k, v in KL.LAUNCHES.items() if v and k not in keys}
        if stray:
            raise RuntimeError(f"the kernel path launched kernels outside "
                               f"{arch}'s path: {stray}")
        print(f"[train-parity] {arch} {str(dtype)[6:]} {backend}: loss "
              f"{loss.item():.6f}, launches {launches}", flush=True)
        return loss.item(), launches

    def on_host():  # the gradients of the last run, kept on the host
        return [q.grad.to("cpu") for q in params]

    def pairs(held):  # (this run's gradient, the held one on the card)
        for q, h in zip(params, held):
            yield q.grad, h.to(device)

    lr, _ = run(torch.float32, "ref")
    scales = [q.grad.abs().max().item() for q in params]
    top = max(scales)
    zero = [n for n, sc in zip(names, scales) if sc <= TRAIN_GRAD_FLOOR * top]
    expected = [n for n in names
                if n.endswith(TRAIN_GRAD_ZERO.get(arch, ()))]
    if zero != expected:
        raise RuntimeError(f"{arch}: the float32 gradients at most "
                           f"{TRAIN_GRAD_FLOOR:g} of the largest are {zero}, "
                           f"not {expected} (TRAIN_GRAD_ZERO)")
    gr = on_host()
    lk, launches = run(torch.float32, "cuda")
    rel = abs(lk - lr) / abs(lr)
    worst = max(((a - b).abs().max().item() / (
        top if n in zero else sc), n)
        for (a, b), n, sc in zip(pairs(gr), names, scales))
    spurious = {n: q.grad.abs().max().item() / top
                for n, q in zip(names, params) if n in zero}
    if any(v > TRAIN_GRAD_FLOOR for v in spurious.values()):
        raise RuntimeError(f"{arch}: the kernel path's gradient of a leaf "
                           f"that is zero in exact arithmetic passes "
                           f"{TRAIN_GRAD_FLOOR:g} of the largest: {spurious}")
    print(f"[train-parity] {arch} float32 kernel vs plain: loss rel "
          f"{rel:.3e} (bar {TRAIN_LOSS_REL:g}), worst gradient "
          f"{worst[0]:.3e} of its max |value| ({worst[1]}; bar "
          f"{TRAIN_GRAD_REL:g})"
          + (f"; {', '.join(zero)}: at most {TRAIN_GRAD_FLOOR:g} of the "
             f"largest gradient max {top:.3e} (zero in exact arithmetic), "
             "held against that; through the kernels "
             + ", ".join(f"{v:.3e}" for v in spurious.values())
             + " of it" if zero else ""), flush=True)
    if not (rel <= TRAIN_LOSS_REL and worst[0] <= TRAIN_GRAD_REL):
        raise RuntimeError(f"{arch} float32 training step: kernel path "
                           "disagrees with the plain path")

    def dist(held):  # mean |difference| over every gradient element
        return (sum((x - y).abs().sum().item() for x, y in pairs(held))
                / sum(q.numel() for q in params))

    l16r, _ = run(torch.bfloat16, "ref")
    bar_grad = dist(gr)
    del gr
    g16r = on_host()
    l16k, _ = run(torch.bfloat16, "cuda")
    d_grad = dist(g16r)
    del g16r
    d_loss, bar_loss = abs(l16k - l16r), abs(l16r - lr)
    print(f"[train-parity] {arch} bfloat16 kernel vs plain: loss "
          f"{d_loss:.3e} (plain bf16 vs float32 {bar_loss:.3e}), gradients "
          f"mean |diff| {d_grad:.3e} (plain bf16 vs float32 {bar_grad:.3e}); "
          f"bar {PARITY_FACTOR:g}x", flush=True)
    if n_moe:
        # the forward's chunks of every MoE layer, before the recomputation
        chunks = -(-B * S // 8192) * n_moe
        differ = routes_differ(
            {"kernel": routes[(torch.bfloat16, "cuda")][:chunks],
             "plain": routes[(torch.bfloat16, "ref")][:chunks],
             "plain float32": routes[(torch.float32, "ref")][:chunks]},
            n_moe)
        print(f"[train-parity] {arch} MoE routing, bfloat16 step: (token, "
              f"layer) top-{cfg.moe.top_k} expert choices that differ, of "
              f"{differ.pop('of')}: "
              + ", ".join(f"{k} {v}" for k, v in differ.items()),
              flush=True)
    if not (d_loss <= PARITY_FACTOR * bar_loss
            and d_grad <= PARITY_FACTOR * bar_grad):
        raise RuntimeError(f"{arch} bf16 training step: kernel path past "
                           "the bar")
    del model, params, routes
    torch.cuda.empty_cache()
    return {"loss_rel": rel, "grad_rel": worst[0], "launches_f32": launches}


SLSTM_SPANS = ("forward", "recomputation", "backward")


@contextlib.contextmanager
def slstm_clock(model, ms: dict):
    """Within the block, the host's wall time inside ``model``'s sLSTM
    mixers (``x @ w_in``, the scan over S steps, ``@ wo``), added up in
    ``ms`` (ms, and the spans counted under ``"n_<key>"``) by module and
    tensor hooks: ``"forward"``, the first pass; ``"recomputation"``, the
    mixer's forward again when checkpoint recomputes its group in the
    backward; ``"backward"``, from the hook on the mixer output's gradient
    to the hook on its input's, less every block's forward that the
    group's recomputation runs inside that span.  The scan's launches are
    what the host spends that time on.  Checkpoint's early stop is off
    inside the block, so that a recomputed block's forward returns (its
    hook sees its end; after the mixer only the residual add is left)."""
    import torch
    from torch.utils.checkpoint import set_checkpoint_early_stop

    from repro_torch.models import SLSTM

    clock = time.perf_counter
    starts, span = {}, {}   # forwards running; the open backward span

    def add(key, seconds):
        ms[key] = ms.get(key, 0.0) + 1e3 * seconds
        ms[f"n_{key}"] = ms.get(f"n_{key}", 0) + 1

    def pre(mod, args):
        starts[mod] = clock()

    def block_end(mod, args, out):
        took = clock() - starts.pop(mod)
        if span:
            span["nested"] += took

    def mixer_end(mod, args, out):
        took = clock() - starts.pop(mod)
        if span:
            add("recomputation", took)
            return
        add("forward", took)
        if out.requires_grad:
            out.register_hook(lambda g: span.update(start=clock(),
                                                    nested=0.0))
            args[0].register_hook(close)

    def close(grad):
        add("backward", clock() - span.pop("start") - span.pop("nested"))

    handles = []
    for blk in model.stack():
        mixer = getattr(blk, "slstm", None)
        handles += [blk.register_forward_pre_hook(pre),
                    blk.register_forward_hook(block_end)]
        if isinstance(mixer, SLSTM):
            handles += [mixer.register_forward_pre_hook(pre),
                        mixer.register_forward_hook(mixer_end)]
    try:
        with set_checkpoint_early_stop(False):
            yield ms
    finally:
        for h in handles:
            h.remove()


def train_phase(device, arch: str, cell: dict | None = None) -> dict:
    """``arch``'s training cell (:data:`TRAIN`): full width, the cell's
    depth, trained for ``steps`` steps through
    ``repro_torch.train.make_train_step`` (the config's optimizer, AdamW or
    Adafactor, at :data:`TRAIN_LR`, bf16 compute over float32 masters,
    ``grad_accum`` microbatches) on the synthetic pipeline's batches: the
    optimizer state's bytes, each step's loss and grad_norm (the loss
    finite and falling from step 1 to the last), step ms (median of steps
    2 onward), tokens/s, model FLOPs per step (:func:`train_flops`) and
    the rate they imply, peak memory, the launches per step of each kernel
    of :func:`train_kernels` (forward, recomputation included, and
    backward; none of any other; a model with local layers must launch K8's
    window backward once a local layer a microbatch), and one more step
    traced (unless the cell says ``"trace": False``): device time by
    kernel group (an MoE model's routing in its own, :data:`MOE_GROUP`,
    with its kernels listed), the optimizer's, ``ssd_chunks``' and
    ``slstm_scan``'s ranges (device and host ms), and the idle share; for
    a model with sLSTM layers, the host's wall time inside its sLSTM
    mixers in each untraced step (:func:`slstm_clock`) and its share of
    the step.  ``cell`` stands in for ``TRAIN[arch]`` where given."""
    import torch

    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.kernels import library as KL
    from repro_torch.train.optimizer import OptConfig, leaves
    from repro_torch.train.train_step import (TrainConfig, init_state,
                                              make_train_step)

    cell = cell or TRAIN[arch]
    torch.cuda.reset_peak_memory_stats()
    B, S, A, steps = (cell[k] for k in ("B", "S", "accum", "steps"))
    cfg, model = train_model(device, arch, cell["layers"])
    n_params = sum(p.numel() for p in model.parameters())
    state = init_state(cfg, model)
    opt_bytes = sum(t.numel() * t.element_size() for f in state.opt
                    if isinstance(f, dict) for t in leaves(f))
    step = make_train_step(cfg, TrainConfig(
        grad_accum=A, compute_dtype=torch.bfloat16,
        opt=OptConfig(lr=TRAIN_LR, warmup=TRAIN_WARMUP)))
    data = DataIterator(DataConfig(vocab=cfg.vocab, seq_len=S,
                                   global_batch=B, seed=0), device=device)
    flops = train_flops(model, B, S)
    n_local = sum(getattr(b, "local", False) for b in model.stack())
    n_slstm = stack_counts(model)["slstm"]
    print(f"[train] {cfg.name} {cfg.n_layers} of {cell['of']} layers at full "
          f"width: {n_params / 1e9:.3f} G parameters (float32 masters, "
          f"{cfg.optimizer}), batch {B} x {S} tokens, grad_accum {A}, bf16 "
          f"compute, lr {TRAIN_LR:g} (warmup {TRAIN_WARMUP}); model FLOPs a "
          f"step {flops:.4e}", flush=True)
    print(f"[train] {arch} {cfg.optimizer} state {opt_bytes / 1e9:.3f} GB "
          f"({opt_bytes / n_params:.3f} B a parameter); with the float32 "
          f"masters and gradients {(opt_bytes + 8 * n_params) / 1e9:.3f} GB, "
          f"{8 + opt_bytes / n_params:.3f} B a parameter (AdamW's: 16)",
          flush=True)
    batches = [next(data) for _ in range(steps + 1)]
    losses, norms, times, scans = [], [], [], []
    KL.reset_launches()
    for i in range(steps):
        scans.append({})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (slstm_clock(model, scans[-1]) if n_slstm
              else contextlib.nullcontext()):
            state, m = step(state, batches[i])
            loss, gn = m["loss"].item(), m["grad_norm"].item()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        norms.append(gn)
        print(f"[train] {arch} step {i + 1}: loss {loss:.6f} grad_norm "
              f"{gn:.6f} ({times[-1]:.1f} ms)", flush=True)
        if n_slstm:
            sc = scans[-1]
            inside = sum(sc.get(k, 0.0) for k in SLSTM_SPANS)
            print(f"[train] {arch} step {i + 1}: host wall time inside the "
                  f"sLSTM mixers ({n_slstm} layers) "
                  + ", ".join(f"{k} {sc.get(k, 0.0):.3f} ms "
                              f"({sc.get('n_' + k, 0)} spans)"
                              for k in SLSTM_SPANS)
                  + f": {inside:.3f} ms, {100 * inside / times[-1]:.1f} % "
                  f"of the step", flush=True)
    keys = train_kernels(cfg, S)
    launches = {k: KL.LAUNCHES[k] for k in keys}
    stray = {k: v for k, v in KL.LAUNCHES.items() if v and k not in keys}
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = statistics.median(times[1:])
    if not all(math.isfinite(x) for x in losses + norms):
        raise RuntimeError(f"non-finite training metrics {losses} {norms}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall: {losses}")
    print(f"[train] {arch} step ms {step_ms:.3f} (median of steps "
          f"2-{steps}), {B * S / (step_ms / 1e3):.1f} tokens/s, "
          f"{flops / (step_ms / 1e3) / 1e12:.2f} TFLOP/s of model FLOPs; "
          f"peak {peak:.3f} GiB", flush=True)
    per_step = {k: v / steps for k, v in launches.items()}
    print(f"[train] {arch} launches per step: "
          + ", ".join(f"{k} {v:g}" for k, v in per_step.items())
          + " (forwards with the recomputation); none of "
          + ", ".join(k for k in KL.LAUNCHES if k not in keys), flush=True)
    if not all(launches.values()):
        raise RuntimeError(f"the training path skipped a kernel: {launches}")
    if stray:
        raise RuntimeError(f"the training path launched kernels outside "
                           f"{arch}'s path: {stray}")
    if n_local and per_step["flash_attention_bwd_window"] != n_local * A:
        raise RuntimeError(
            f"{arch}: {per_step['flash_attention_bwd_window']:g} window "
            f"backward launches a step, not {n_local} local layers x {A}")
    split, idle = {}, None
    groups = tuple(g for g in TRAIN_GROUPS
                   if cfg.moe is not None or g[0] != MOE_GROUP)
    if cell.get("trace", True):
        idle = trace_step(
            lambda st: step(st, batches[steps]), state, step_ms,
            untraced=f"median of steps 2-{steps}", groups=groups,
            split_out=split,
            list_group=MOE_GROUP if cfg.moe is not None else None,
            ranges=("opt_update",) + tuple(
                r for r, b in (("ssd_chunks", "mamba2"),
                               ("slstm_scan", "slstm"))
                if b in cfg.pattern))
    if n_slstm:
        inside = sum(sc.get(k, 0.0) for sc in scans[1:] for k in SLSTM_SPANS)
        print(f"[train] {arch} host wall time inside the sLSTM mixers, "
              f"steps 2-{steps}: {inside:.3f} ms of {sum(times[1:]):.3f}, "
              f"{100 * inside / sum(times[1:]):.1f} % of the steps",
              flush=True)
        if not all(sc.get("n_" + k) == n_slstm * A
                   for sc in scans for k in SLSTM_SPANS):
            raise RuntimeError(f"{arch}: the sLSTM clock missed a span: "
                               f"{scans}")
    del state, model, step, batches
    torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": norms, "step_ms": step_ms,
            "tokens_per_s": B * S / (step_ms / 1e3), "flops": flops,
            "peak_gib": peak, "launches": launches, "idle": idle,
            "split": split, "opt_bytes": opt_bytes, "slstm_host": scans}


# training across ranks (``[train-dist]``): Granite-8B at full width in
# TRAIN_PARITY's cut (2 layers) at 2 x 2048, grad_accum 2, and one
# Zamba2-7B group (the shared block and 3 Mamba-2 layers), float32 masters
# and compute, AdamW, 3 steps, through ``parallel.sharding`` on a (1, 1)
# mesh over NCCL (one rank: every gather and reduce-scatter issued) in
# turns with the unsharded step; then Granite on two gloo ranks of the
# one card, a (2, 1) mesh, 2 x 2048 (a row a rank), one step (gloo stages
# every collective of CUDA tensors through the host: 11-15 s a step on an
# H100 80GB HBM3 at 700 W, PR 29)
TRAIN_DIST = {"granite_8b": {"layers": 2, "B": 2, "S": 2048, "accum": 2,
                             "steps": 3, "trace": True},
              "zamba2_7b": {"layers": 3, "B": 2, "S": 2048, "accum": 2,
                            "steps": 3, "reshard": True}}
# warmup 1: the one step applies the whole TRAIN_LR, so the masters' hold
# reads a material update
TRAIN_DIST_GLOO = {"arch": "granite_8b", "layers": 2, "B": 2, "S": 2048,
                   "accum": 1, "steps": 1, "warmup": 1, "mesh": (2, 1)}
DIST_GROUPS = (("NCCL collectives", ("nccl",)),) + tuple(
    g for g in TRAIN_GROUPS if g[0] != MOE_GROUP)
# the dry run's argument bytes a rank against the allocator's growth
DRYRUN_REL = 0.01


def masters_rel(got: dict, want: dict) -> tuple[float, str, bool]:
    """The worst master's max |difference| over its max |value|, its name,
    and whether every master is bit-equal."""
    import torch

    worst, name, equal = 0.0, "", True
    for n, b in want.items():
        a = got[n]
        equal = equal and bool(torch.equal(a, b))
        r = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        if r >= worst:
            worst, name = r, n
    return worst, name, equal


def train_dist_one_rank(device, arch: str) -> dict:
    """``arch``'s :data:`TRAIN_DIST` run over NCCL in a one-rank group: a
    (1, 1) mesh, the masters laid out by ``sharding.init_params`` (every
    parameter a ``DTensor``), each step through
    ``make_train_step(dp_axes=, param_specs=)`` on ``shard_batch``'s rows,
    in turns with the unsharded step on the same batches; losses and
    grad_norm at :data:`TRAIN_LOSS_REL`, the masters after the last step
    at :data:`TRAIN_GRAD_REL` of each one's max (and whether bit-equal);
    K8/K9 (K10) launched by the sharded steps; step ms of both (median of
    steps 2 onward) and each step's peak; where the run says ``trace``, a
    traced sharded step (the NCCL kernels' device ms); where it says
    ``reshard``, the state saved and restored through
    ``elastic.reshard_state`` onto the mesh, equal bit for bit."""
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataConfig, DataIterator,
                                           shard_batch)
    from repro_torch.kernels import library as KL
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import Transformer, init_params
    from repro_torch.parallel import sharding as SH
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.elastic import reshard_state
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (TrainConfig, init_state,
                                              make_train_step)

    c = TRAIN_DIST[arch]
    B, S, A, steps = (c[k] for k in ("B", "S", "accum", "steps"))
    cfg = dataclasses.replace(get_config(arch), n_layers=c["layers"])
    tc = TrainConfig(grad_accum=A, compute_dtype=torch.float32,
                     opt=OptConfig(lr=TRAIN_LR, warmup=TRAIN_WARMUP))
    torch.cuda.set_device(torch.cuda.current_device())
    mesh = device_mesh((1, 1), ("data", "model"), device_type="cuda")
    plain = init_state(cfg, init_params(
        Transformer(cfg, dtype=torch.float32, device=device), seed=0))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    sharded = init_state(cfg, SH.init_params(
        Transformer(cfg, dtype=torch.float32, device="meta"), seed=0,
        mesh=mesh))
    torch.cuda.synchronize()
    dryrun_check(arch, cfg, mesh,
                 torch.cuda.memory_allocated() - before)
    specs = SH.param_shardings(sharded.params, mesh)
    step = make_train_step(cfg, tc)
    sstep = make_train_step(cfg, tc, dp_axes=SH.dp_axes(mesh),
                            param_specs=specs)
    n_params = sum(p.numel() for p in plain.params.parameters())
    data = DataIterator(DataConfig(vocab=cfg.vocab, seq_len=S,
                                   global_batch=B, seed=0), device=device)
    batches = [next(data) for _ in range(steps + 1)]
    print(f"[train-dist] {arch}: {cfg.n_layers} layers at full width, "
          f"{n_params / 1e9:.3f} G parameters, float32 masters and compute, "
          f"{B} x {S} tokens, grad_accum {A}; NCCL, one rank, mesh (1, 1) "
          f"({len(specs)} parameters as DTensor shards)", flush=True)
    times = {"unsharded": [], "sharded": []}
    peaks = {"unsharded": 0.0, "sharded": 0.0}
    launches = {}
    for i in range(steps):
        for kind in ("unsharded", "sharded"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if kind == "sharded":
                KL.reset_launches()
            t0 = time.perf_counter()
            if kind == "unsharded":
                plain, m = step(plain, batches[i])
            else:
                sharded, ms = sstep(sharded, shard_batch(batches[i], mesh, A))
            torch.cuda.synchronize()
            times[kind].append(1e3 * (time.perf_counter() - t0))
            peaks[kind] = max(peaks[kind],
                              torch.cuda.max_memory_allocated() / 2**30)
            if kind == "sharded":
                for k, v in KL.LAUNCHES.items():
                    launches[k] = launches.get(k, 0) + v
        lp, gp = m["loss"].item(), m["grad_norm"].item()
        ls, gs = ms["loss"].item(), ms["grad_norm"].item()
        print(f"[train-dist] {arch} step {i + 1}: loss {ls:.6f} (unsharded "
              f"{lp:.6f}, rel {abs(ls - lp) / abs(lp):.3e}), grad_norm "
              f"{gs:.6f} (unsharded {gp:.6f}); "
              f"{times['sharded'][-1]:.1f} ms (unsharded "
              f"{times['unsharded'][-1]:.1f} ms)", flush=True)
        if not (abs(ls - lp) <= TRAIN_LOSS_REL * abs(lp)
                and abs(gs - gp) <= TRAIN_LOSS_REL * abs(gp)):
            raise RuntimeError(f"{arch}: the sharded step's metrics "
                               "disagree with the unsharded step's")
    worst, name, equal = masters_rel(
        {n: SH.full_tensor(p.detach())
         for n, p in sharded.params.named_parameters()},
        {n: p.detach() for n, p in plain.params.named_parameters()})
    keys = train_kernels(cfg, S)
    used = {k: launches.get(k, 0) for k in keys}
    med = {k: statistics.median(v[1:]) for k, v in times.items()}
    print(f"[train-dist] {arch} masters after {steps} steps: worst "
          f"{worst:.3e} of its max ({name}; bar {TRAIN_GRAD_REL:g}); "
          f"bit-equal to the unsharded masters: {'yes' if equal else 'no'}",
          flush=True)
    print(f"[train-dist] {arch} step ms {med['sharded']:.3f} sharded, "
          f"{med['unsharded']:.3f} unsharded (median of steps 2-{steps}, "
          f"in turns); peak {peaks['sharded']:.3f} GiB during a sharded "
          f"step, {peaks['unsharded']:.3f} GiB during an unsharded one "
          f"(both states resident); sharded launches "
          + ", ".join(f"{k} {v}" for k, v in used.items()), flush=True)
    if worst > TRAIN_GRAD_REL:
        raise RuntimeError(f"{arch}: sharded masters past the bar")
    if not all(used.values()):
        raise RuntimeError(f"the sharded training path skipped a kernel: "
                           f"{used}")
    out = {"loss_rel": abs(ls - lp) / abs(lp), "masters_rel": worst,
           "bit_equal": equal, "step_ms": med["sharded"],
           "plain_step_ms": med["unsharded"], "peak_gib": peaks["sharded"],
           "plain_peak_gib": peaks["unsharded"], "launches": used}
    del plain, step
    torch.cuda.empty_cache()
    if c.get("trace"):
        split = {}
        out["idle"] = trace_step(
            lambda st: sstep(st, shard_batch(batches[steps], mesh, A)),
            sharded, med["sharded"],
            untraced=f"median of sharded steps 2-{steps}",
            groups=DIST_GROUPS, split_out=split, ranges=("opt_update",))
        nccl = split.get("NCCL collectives", (0.0, 0))
        print(f"[train-dist] {arch} NCCL kernels' device ms in the traced "
              f"sharded step: {nccl[0]:.3f} in {nccl[1]} launches",
              flush=True)
        out["nccl_ms"], out["nccl_launches"] = nccl
    if not c.get("reshard"):
        del sharded
        torch.cuda.empty_cache()
        return out
    ckpt = ROOT / "build" / "repro_torch" / "chip_smoke_dist_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    saved_step = sharded.step
    save_checkpoint(ckpt, saved_step, sharded,
                    meta={"mesh": tuple(mesh.mesh.shape)})
    t1 = time.perf_counter()
    saved = {n: SH.full_tensor(p.detach())
             for n, p in sharded.params.named_parameters()}
    opt = [SH.full_tensor(t) for t in sharded.opt.m.values()
           for t in (t if isinstance(t, list) else [t])]
    del sharded
    torch.cuda.empty_cache()
    like = init_state(cfg, SH.init_params(
        Transformer(cfg, dtype=torch.float32, device="meta"), seed=1,
        mesh=mesh))
    back, manifest = reshard_state(ckpt, like, mesh)
    t2 = time.perf_counter()
    same = all(torch.equal(SH.full_tensor(p.detach()), saved[n])
               for n, p in back.params.named_parameters()) and all(
        torch.equal(SH.full_tensor(t), o) for t, o in zip(
            (t for v in back.opt.m.values()
             for t in (v if isinstance(v, list) else [v])), opt))
    print(f"[train-dist] {arch} checkpoint of step {manifest['step']} "
          f"(mesh {manifest['mesh']}) saved in {t1 - t0:.1f} s, restored "
          f"through reshard_state onto the (1, 1) mesh in {t2 - t1:.1f} s: "
          f"masters and moments {'bit-equal' if same else 'DIFFER'}",
          flush=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    if not same or back.step != saved_step:
        raise RuntimeError("reshard_state did not restore the state")
    del back, like, saved, opt
    torch.cuda.empty_cache()
    return out


def dryrun_check(arch: str, cfg, mesh, grown: int) -> None:
    """The dry run's argument bytes a rank (``launch.dryrun.state_specs``
    on ``mesh``: the masters' and optimizer state's shards, from their
    shapes, nothing allocated) against ``grown``, what
    ``torch.cuda.memory_allocated()`` grew by while the same state was
    built on the card, within :data:`DRYRUN_REL`.  The dry run makes no
    estimate of temporaries: it prints none."""
    from repro_torch.launch import dryrun

    want = dryrun.local_bytes(dryrun.state_specs(cfg, mesh))
    rel = abs(grown - want) / want
    print(f"[dryrun] {arch}: state_specs on the {tuple(mesh.mesh.shape)} "
          f"mesh: {want} argument bytes a rank (masters and optimizer "
          f"state); memory_allocated grew {grown} B building them on the "
          f"card: rel {rel:.3e} (bar {DRYRUN_REL:g}); temporaries: no "
          f"estimate (the dry run makes none)", flush=True)
    if rel > DRYRUN_REL:
        raise RuntimeError(f"{arch}: the dry run's argument bytes miss the "
                           "allocated state")


# serving on a mesh (``[serve-dist]``): Granite-8B at full width cut as
# TRAIN_DIST cuts it (2 layers), bfloat16, an 8 x 2048 prompt into caches of
# 2080, then 31 greedy decode steps, through ``prefill``/``decode_step`` on
# the model laid out on the (1, 1) NCCL mesh of ``[train-dist]`` (every
# weight gathered whole at each use), in turns with the unsharded model
SERVE_DIST = {"arch": "granite_8b", "layers": 2, "B": 8, "S": 2048,
              "decode": 31, "cache": 2080, "rounds": 2}


def serve_dist_one_rank(device) -> dict:
    """:data:`SERVE_DIST` over NCCL in the one-rank group of
    :func:`train_dist_phase`: the sharded and the unsharded model (the
    same seeded values) serve the same prompt in turns, ``rounds`` times;
    the first round's logits (prefill and every step), its caches after
    the prefill and after the last step, and the tokens must be equal bit
    for bit.  Prints each path's prefill ms and decode ms a step (medians
    over the rounds and steps), the peak over each path's serving, K8/K9's
    launches in a sharded request, and a traced sharded prefill's and
    decode step's NCCL launches and device ms."""
    import torch

    from repro_torch import models as TM
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import local_rows
    from repro_torch.kernels import library as KL
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.parallel import sharding as SH

    c = SERVE_DIST
    B, S, n, cache = (c[k] for k in ("B", "S", "decode", "cache"))
    cfg = dataclasses.replace(get_config(c["arch"]), n_layers=c["layers"])
    mesh = device_mesh((1, 1), ("data", "model"), device_type="cuda")
    models = {
        "unsharded": TM.init_params(TM.Transformer(
            cfg, dtype=torch.bfloat16, device=device), seed=0),
        "sharded": SH.init_params(TM.Transformer(
            cfg, dtype=torch.bfloat16, device="meta"), seed=0, mesh=mesh)}
    gen = torch.Generator(device=device).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device=device)
    rows = local_rows(mesh, B).to(device)
    print(f"[serve-dist] {cfg.name}: {cfg.n_layers} layers at full width, "
          f"bfloat16, B={B} prompts of {S} tokens, caches of {cache}, {n} "
          f"greedy steps; NCCL, one rank, mesh (1, 1) (every weight a "
          f"DTensor shard, gathered whole at each use)", flush=True)

    def serve(kind, keep):
        model = models[kind]
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, caches = TM.prefill(model, tokens[rows], cache_len=cache)
        torch.cuda.synchronize()
        pre_ms = 1e3 * (time.perf_counter() - t)
        out = {"logits": [logits], "prefill_caches": [
            {k: v.clone() for k, v in cc.items()} for cc in caches]
            if keep else None}
        tok, steps = logits.argmax(-1), []
        for i in range(n):
            t = time.perf_counter()
            step, caches = TM.decode_step(model, tok, caches, S + i)
            tok = step.argmax(-1)
            torch.cuda.synchronize()
            steps.append(1e3 * (time.perf_counter() - t))
            out["logits"].append(step)
            out.setdefault("tokens", []).append(tok)
        out["caches"] = caches
        return pre_ms, steps, out

    for kind in models:  # warm-up
        serve(kind, False)
    pre = {k: [] for k in models}
    dec = {k: [] for k in models}
    peaks = {k: 0.0 for k in models}
    first, launches = {}, {}
    for r in range(c["rounds"]):
        for kind in models:
            torch.cuda.reset_peak_memory_stats()
            KL.reset_launches()
            p_ms, steps, out = serve(kind, r == 0)
            peaks[kind] = max(peaks[kind],
                              torch.cuda.max_memory_allocated() / 2**30)
            pre[kind].append(p_ms)
            dec[kind] += steps
            if r == 0:
                first[kind] = out
                if kind == "sharded":
                    launches = {k: KL.LAUNCHES[k] for k in LM_LAUNCHES}
            del out
    a, b = first["sharded"], first["unsharded"]
    equal = {
        "logits": all(torch.equal(x, y) for x, y in zip(a["logits"],
                                                        b["logits"])),
        "prefill caches": all(torch.equal(x[k], y[k]) for x, y in zip(
            a["prefill_caches"], b["prefill_caches"]) for k in x),
        "caches": all(torch.equal(x[k], y[k]) for x, y in zip(
            a["caches"], b["caches"]) for k in x),
        "tokens": all(torch.equal(x, y) for x, y in zip(a["tokens"],
                                                        b["tokens"]))}
    med = {k: (statistics.median(pre[k]), statistics.median(dec[k]))
           for k in models}
    norms = cfg.n_layers + 1
    want = {"flash_attention": cfg.n_layers, "flash_attention_window": 0,
            "rmsnorm": norms * (1 + n), "rmsnorm_residual": cfg.n_layers
            * (1 + n), "ssm_state_scan": 0}
    print(f"[serve-dist] sharded vs unsharded, bit for bit: "
          + ", ".join(f"{k} {'equal' if v else 'DIFFER'}"
                      for k, v in equal.items()), flush=True)
    for kind in models:
        print(f"[serve-dist] {kind}: prefill ms {med[kind][0]:.3f} (median "
              f"of {c['rounds']}), decode ms a step {med[kind][1]:.3f} "
              f"(median of {c['rounds']} x {n}), peak {peaks[kind]:.3f} GiB "
              f"(both models resident)", flush=True)
    print(f"[serve-dist] sharded launches in a request (a prefill and {n} "
          f"steps): {launches} (expected {want})", flush=True)
    if not all(equal.values()):
        raise RuntimeError(f"serving on the mesh differs from the unsharded "
                           f"model: {equal}")
    if launches != want:
        raise RuntimeError("the sharded serving path did not launch K8/K9 "
                           "as expected")
    caches = a["caches"]
    tok = a["tokens"][-1]
    del first, a, b
    split = {}
    idle_prefill = trace_step(
        lambda _: TM.prefill(models["sharded"], tokens[rows],
                             cache_len=cache), None, med["sharded"][0],
        untraced="median sharded prefill", groups=DIST_GROUPS,
        split_out=split)
    nccl_prefill = split.get("NCCL collectives", (0.0, 0))
    print(f"[serve-dist] NCCL kernels in the traced sharded prefill: "
          f"{nccl_prefill[0]:.3f} ms of device time in {nccl_prefill[1]} "
          f"launches", flush=True)
    split = {}
    idle = trace_step(
        lambda cc: TM.decode_step(models["sharded"], tok, cc, S + n - 1),
        caches, med["sharded"][1], untraced="median sharded decode step",
        groups=DIST_GROUPS, split_out=split)
    nccl = split.get("NCCL collectives", (0.0, 0))
    print(f"[serve-dist] NCCL kernels in the traced sharded decode step: "
          f"{nccl[0]:.3f} ms of device time in {nccl[1]} launches",
          flush=True)
    del models, caches
    torch.cuda.empty_cache()
    return {"name": f"{cfg.name} serve-dist", "launches": launches,
            "parity_launches": {k: 0 for k in LM_LAUNCHES},
            "prefill_ms": med["sharded"][0], "decode_ms": med["sharded"][1],
            "plain_prefill_ms": med["unsharded"][0],
            "plain_decode_ms": med["unsharded"][1], "peak_gib": peaks,
            "nccl_ms": nccl[0], "nccl_launches": nccl[1], "idle": idle,
            "idle_prefill": idle_prefill}


GLOO_WORKER = r"""
import dataclasses, datetime, json, sys, time
import torch, torch.distributed as dist
rank, world, init, out, spec = sys.argv[1:6]
rank, world, spec = int(rank), int(world), json.loads(spec)
torch.backends.cuda.matmul.allow_tf32 = False
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=600))
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.kernels import library as KL
from repro_torch.launch.mesh import device_mesh
from repro_torch.models import Transformer, init_params
from repro_torch.models.weights import param_tree
from repro_torch.parallel import sharding as SH
from repro_torch.train.optimizer import OptConfig, leaves
from repro_torch.train.train_step import (TrainConfig, init_state,
                                          make_train_step)
dev = torch.device("cuda", 0)
cfg = dataclasses.replace(get_config(spec["arch"]), n_layers=spec["layers"])
tc = TrainConfig(grad_accum=spec["accum"], compute_dtype=torch.float32,
                 opt=OptConfig(lr=spec["lr"], warmup=spec["warmup"]))
mesh = device_mesh(tuple(spec["mesh"]), ("data", "model"),
                   device_type="cuda")
dc = DataConfig(vocab=cfg.vocab, seq_len=spec["S"], global_batch=spec["B"],
                seed=0)
torch.cuda.reset_peak_memory_stats()
state = init_state(cfg, SH.init_params(
    Transformer(cfg, dtype=torch.float32, device="meta"), seed=0,
    mesh=mesh))
resident = torch.cuda.memory_allocated() / 2**30
step = make_train_step(cfg, tc, dp_axes=SH.dp_axes(mesh),
                       param_specs=SH.param_shardings(state.params, mesh))
it = DataIterator(dc, device=dev, mesh=mesh, grad_accum=spec["accum"])
metrics, times = [], []
KL.reset_launches()
for i in range(spec["steps"]):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, next(it))
    torch.cuda.synchronize()
    times.append(1e3 * (time.perf_counter() - t0))
    metrics.append((m["loss"].item(), m["grad_norm"].item()))
launches = dict(KL.LAUNCHES)
peak = torch.cuda.max_memory_allocated() / 2**30
# every rank joins each gather; rank 0 keeps the masters and the first
# moments, on the host while the unsharded run's peak is read
full, first = {}, []
for n, p in state.params.named_parameters():
    whole = SH.full_tensor(p.detach())
    if rank == 0:
        full[n] = whole.cpu()
    del whole
for m in leaves(state.opt.m):
    whole = SH.full_tensor(m)
    if rank == 0:
        first.append(whole.cpu())
    del whole
del p, m, state, step  # the loops' last shards, else held on the card
torch.cuda.empty_cache()
res = {"rank": rank, "metrics": metrics, "times": times, "peak": peak,
       "resident": resident, "launches": launches}
if rank == 0:  # the unsharded run on the same batches
    torch.cuda.reset_peak_memory_stats()
    plain = init_state(cfg, init_params(
        Transformer(cfg, dtype=torch.float32, device=dev), seed=0))
    res["plain_resident"] = torch.cuda.memory_allocated() / 2**30
    step = make_train_step(cfg, tc)
    it = DataIterator(dc, device=dev)
    pm = []
    for i in range(spec["steps"]):
        plain, m = step(plain, next(it))
        pm.append((m["loss"].item(), m["grad_norm"].item()))
    res["plain_peak"] = torch.cuda.max_memory_allocated() / 2**30
    res["plain_metrics"] = pm
    worst, name, near, n_all, top = 0.0, "", 0, 0, 0.0
    for n, p in plain.params.named_parameters():
        b = p.detach()
        d = (full[n].to(dev) - b).abs()
        r = d.max().item() / max(b.abs().max().item(), 1e-30)
        if r >= worst:
            worst, name = r, n
        near += int((d <= 1e-6 + 1e-4 * b.abs()).sum())
        n_all += d.numel()
        top = max(top, d.max().item())
    res["masters_rel"], res["masters_worst"] = worst, name
    res["masters_near"], res["masters_max"] = near / n_all, top
    # the first moments, (1 - b1) x each clipped gradient after one step
    worst, name = 0.0, ""
    names = [k if not isinstance(x, list) else f"{k}[{j}]"
             for k, x in param_tree(plain.params).items()
             for j in (range(len(x)) if isinstance(x, list) else [0])]
    for k, a, b in zip(names, first, leaves(plain.opt.m)):
        r = ((a.to(dev) - b).abs().max().item()
             / max(b.abs().max().item(), 1e-30))
        if r >= worst:
            worst, name = r, k
    res["grads_rel"], res["grads_worst"] = worst, name
with open(out, "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def train_dist_gloo(device) -> dict:
    """:data:`TRAIN_DIST_GLOO`: two processes, each a gloo rank on the one
    card (``cuda:0``), a (2, 1) mesh: the masters, gradients and moments
    split over the data axis, each step's rows split between the ranks;
    each rank's peak beside the unsharded run's (rank 0, after); against
    the unsharded run on the same batches, the metrics at
    :data:`TRAIN_LOSS_REL`, the first moments at :data:`TRAIN_GRAD_REL`
    and the masters as a share of the step applied."""
    import os
    import shutil
    import tempfile

    g = TRAIN_DIST_GLOO
    world = g["mesh"][0] * g["mesh"][1]
    spec = dict(g, lr=TRAIN_LR)
    applied = TRAIN_LR * min(1.0, g["steps"] / g["warmup"])  # the last step's
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="4")
    print(f"[train-dist] {g['arch']}: {g['layers']} layers at full width, "
          f"{g['B']} x {g['S']} tokens, grad_accum {g['accum']}, "
          f"{g['steps']} steps; gloo, {world} ranks on the one card, mesh "
          f"{g['mesh']}", flush=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_WORKER, str(r), str(world),
         f"file://{tmp}/rdv", str(tmp / f"rank{r}.json"), json.dumps(spec)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("a gloo rank failed:\n" + "\n".join(
            log[-3000:] for log in logs))
    res = [json.loads((tmp / f"rank{r}.json").read_text())
           for r in range(world)]
    shutil.rmtree(tmp, ignore_errors=True)
    r0 = res[0]
    for i, ((l, gn), (pl, pg)) in enumerate(zip(r0["metrics"],
                                                r0["plain_metrics"])):
        print(f"[train-dist] gloo step {i + 1}: loss {l:.6f} (unsharded "
              f"{pl:.6f}, rel {abs(l - pl) / abs(pl):.3e}), grad_norm "
              f"{gn:.6f} (unsharded {pg:.6f}); "
              + ", ".join(f"rank {r['rank']} {r['times'][i]:.1f} ms"
                          for r in res), flush=True)
        if not (abs(l - pl) <= TRAIN_LOSS_REL * abs(pl)
                and abs(gn - pg) <= TRAIN_LOSS_REL * abs(pg)):
            raise RuntimeError("gloo ranks' metrics disagree with the "
                               "unsharded run's")
    for r in res:
        print(f"[train-dist] gloo rank {r['rank']}: peak {r['peak']:.3f} "
              f"GiB (state at start {r['resident']:.3f} GiB); launches "
              + ", ".join(f"{k} {v}" for k, v in r["launches"].items()
                          if k in TRAIN_LAUNCHES), flush=True)
        if not all(r["launches"].get(k) for k in TRAIN_LAUNCHES):
            raise RuntimeError(f"gloo rank {r['rank']} skipped a kernel")
    # two ranks sum each gradient in two halves, a reordering at float32's
    # round-off: the first moments ((1 - b1) x the clipped gradient) are
    # held at TRAIN_GRAD_REL of each one's max.  AdamW's normalised step
    # g / (|g| + eps) turns the round-off of an element whose |g| is near
    # eps into a share of the step, so the masters are held to 99.9 %
    # within rtol 1e-4 / atol 1e-6 (the train-step tests' bar) and every
    # element within half the applied step, which a missing, doubled or
    # sign-flipped update of an element with |g| >> eps passes by a step
    share = r0["masters_max"] / applied
    print(f"[train-dist] gloo unsharded run (rank 0 alone, after): peak "
          f"{r0['plain_peak']:.3f} GiB (state at start "
          f"{r0['plain_resident']:.3f} GiB); first moments: worst "
          f"{r0['grads_rel']:.3e} of its max ({r0['grads_worst']}; bar "
          f"{TRAIN_GRAD_REL:g}); masters: "
          f"{100 * r0['masters_near']:.4f} % within 1e-4 / 1e-6, max "
          f"|difference| {r0['masters_max']:.3e} = {share:.4f} of the "
          f"applied step {applied:g} (bar 0.5), worst "
          f"{r0['masters_rel']:.3e} of its max ({r0['masters_worst']}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if r0["grads_rel"] > TRAIN_GRAD_REL:
        raise RuntimeError("gloo ranks' gradients past the bar")
    if r0["masters_near"] < 0.999 or share > 0.5:
        raise RuntimeError("gloo ranks' masters past the bar")
    return {"peaks": [r["peak"] for r in res],
            "plain_peak": r0["plain_peak"], "masters_max": r0["masters_max"],
            "step_ms": [statistics.median(r["times"]) for r in res]}


def train_dist_phase(device) -> dict:
    """The ``[train-dist]`` phase: :func:`train_dist_one_rank` for each of
    :data:`TRAIN_DIST`, ``[serve-dist]`` (:func:`serve_dist_one_rank`) and
    ``[int8-dist]`` (:func:`int8_dist_one_rank`) over NCCL (the process
    group made here, of this one process, and destroyed after), then
    :func:`train_dist_gloo`."""
    import tempfile

    import torch
    import torch.distributed as dist

    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv",
                            rank=0, world_size=1,
                            device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        out = {arch: train_dist_one_rank(device, arch) for arch in TRAIN_DIST}
        t0 = time.perf_counter()
        out["serve"] = serve_dist_one_rank(device)
        print(f"[phase] serving on a mesh {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        out["int8"] = int8_dist_one_rank(device)
        print(f"[phase] int8 serving on a mesh "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        dist.destroy_process_group()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    out["gloo"] = train_dist_gloo(device)
    return out


# the hillclimb's paths on the card.  ``[remat]``: Granite-8B's training
# cell (TRAIN's cut: 8 of 36 layers, 8 x 4096, grad_accum 2) under remat
# "dots" in turns with "block" on one model and optimizer state, ``rounds``
# timed rounds after a warm-up round; the bytes one micro-batch's forward
# keeps for its backward (``models.remat.SavedBytes``) held against the
# same count on the meta device and against the allocator's growth over
# that forward, at REMAT_BYTES_REL; then the 2-layer float32 parity step
# (TRAIN_PARITY's Granite cut) under "dots" against "block"
REMAT = {"arch": "granite_8b", "rounds": 2}
REMAT_BYTES_REL = 0.01


@contextlib.contextmanager
def plain_on_meta():
    """While open, K8's and K9's wrappers, which refuse meta tensors, run
    their plain versions on them: a forward on the meta device through
    their ``autograd.Function``s then saves what the card's forward saves
    (the meta count of ``[remat]``)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as RN

    def attention(q, k, v, *, softcap=0.0, window=0, lse=None):
        o, rows = ref.flash_attention_fwd_ref(q, k, v, softcap=softcap,
                                              window=window)
        if lse is not None:
            lse.copy_(rows)
        return o

    plain = {(FA, "flash_attention"): attention,
             (RN, "rmsnorm"): ref.rmsnorm_ref,
             (RN, "rmsnorm_residual"): ref.rmsnorm_residual_ref}
    kernels = {key: getattr(*key) for key in plain}

    def routed(key):
        def call(x, *args, **kw):
            fn = plain[key] if x.device.type == "meta" else kernels[key]
            return fn(x, *args, **kw)
        return call

    for key in plain:
        setattr(*key, routed(key))
    try:
        yield
    finally:
        for key, fn in kernels.items():
            setattr(*key, fn)


def saved_for_backward(model, tokens, labels) -> tuple[int, int, int]:
    """(bytes, tensors) a bf16 loss forward of ``model`` keeps for its
    backward (:class:`repro_torch.models.remat.SavedBytes`), and the
    allocator's growth over that forward on the card (None elsewhere)."""
    import torch

    from repro_torch.models import loss_fn
    from repro_torch.models.remat import SavedBytes

    card = tokens.is_cuda
    if card:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
    with SavedBytes() as saved:
        loss = loss_fn(model, tokens, labels, dtype=torch.bfloat16)
    grown = None
    if card:
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - before
    del loss
    return saved.bytes, saved.tensors, grown


def remat_phase(device) -> dict:
    """``[remat]`` (:data:`REMAT`): step ms (median of the timed rounds)
    and peak GiB of each policy; launches per step of each kernel of
    :func:`train_kernels` under each, which must be equal (K8's and K9's
    forwards are recomputed under both) and none of another kernel; the
    saved-for-backward bytes of a micro-batch under each policy on the
    card, on the meta device and by the allocator; the float32 parity
    step's loss and gradients under "dots" against "block" (bit-equality
    printed, held at :data:`TRAIN_LOSS_REL` / :data:`TRAIN_GRAD_REL`)."""
    import torch

    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.kernels import library as KL
    from repro_torch.models import Transformer, loss_fn
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (TrainConfig, init_state,
                                              make_train_step)

    arch = REMAT["arch"]
    cell = TRAIN[arch]
    B, S, A = (cell[k] for k in ("B", "S", "accum"))
    cfg, model = train_model(device, arch, cell["layers"])
    policies = {r: dataclasses.replace(cfg, remat=r)
                for r in ("block", "dots")}
    state = init_state(cfg, model)
    step = make_train_step(cfg, TrainConfig(
        grad_accum=A, compute_dtype=torch.bfloat16,
        opt=OptConfig(lr=TRAIN_LR, warmup=TRAIN_WARMUP)))
    data = DataIterator(DataConfig(vocab=cfg.vocab, seq_len=S,
                                   global_batch=B, seed=0), device=device)
    print(f"[remat] {cfg.name} {cfg.n_layers} of {cell['of']} layers at "
          f"full width, batch {B} x {S}, grad_accum {A}, bf16 compute: "
          f"remat \"dots\" (aten.mm/addmm outputs kept) in turns with "
          f"\"block\", {REMAT['rounds']} timed rounds after a warm-up",
          flush=True)
    keys = train_kernels(cfg, S)
    times = {r: [] for r in policies}
    peaks = {r: 0.0 for r in policies}
    launches = {}
    for i in range(1 + REMAT["rounds"]):
        batch = next(data)
        for r, c in policies.items():
            model.cfg = c
            torch.cuda.reset_peak_memory_stats()
            KL.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss = m["loss"].item()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            if not math.isfinite(loss):
                raise RuntimeError(f"[remat] {r}: loss {loss}")
            if i == 0:
                launches[r] = dict(KL.LAUNCHES)
                continue
            times[r].append(ms)
            peaks[r] = max(peaks[r],
                           torch.cuda.max_memory_allocated() / 2**30)
    med = {r: statistics.median(t) for r, t in times.items()}
    for r in policies:
        print(f"[remat] {r}: step ms {med[r]:.3f} (median of "
              f"{REMAT['rounds']}: " + ", ".join(f"{t:.1f}" for t in times[r])
              + f"), {B * S / (med[r] / 1e3):.1f} tokens/s, peak "
              f"{peaks[r]:.3f} GiB; launches a step: "
              + ", ".join(f"{k} {launches[r][k]}" for k in keys), flush=True)
        stray = {k: v for k, v in launches[r].items() if v and k not in keys}
        if not all(launches[r][k] for k in keys) or stray:
            raise RuntimeError(f"[remat] {r}: launches {launches[r]}")
    if launches["dots"] != launches["block"]:
        raise RuntimeError(f"[remat] \"dots\" launched otherwise than "
                           f"\"block\": {launches}")
    print(f"[remat] dots / block step time {med['dots'] / med['block']:.4f}",
          flush=True)
    # what one micro-batch's forward keeps for its backward
    mb = B // A
    batch = next(data)
    tok, lab = batch["tokens"][:mb], batch["labels"][:mb]
    saved = {}
    for r, c in policies.items():
        model.cfg = c
        model.zero_grad(set_to_none=True)
        got = saved_for_backward(model, tok, lab)
        meta = Transformer(c, dtype=torch.float32, device="meta")
        with plain_on_meta():
            want = saved_for_backward(meta.requires_grad_(True),
                                      tok.to("meta"), lab.to("meta"))
        saved[r] = {"bytes": got[0], "tensors": got[1], "grown": got[2],
                    "meta": want[0]}
        rel = (None if got[2] is None
               else abs(got[2] - want[0]) / want[0])
        print(f"[remat] {r}: a micro-batch ({mb} x {S}) keeps "
              f"{got[0] / 1e9:.4f} GB in {got[1]} tensors for its backward "
              f"({got[0] / (mb * S * cfg.n_layers * 2):.1f} bf16 values a "
              f"token a layer); the meta count {want[0] / 1e9:.4f} GB in "
              f"{want[1]} tensors"
              + ("" if rel is None else
                 f"; the allocator grew by {got[2] / 1e9:.4f} GB over the "
                 f"forward (rel {rel:.3e} of the meta count, bar "
                 f"{REMAT_BYTES_REL:g})"), flush=True)
        if (got[0], got[1]) != want[:2] or (rel is not None
                                            and rel > REMAT_BYTES_REL):
            raise RuntimeError(f"[remat] {r}: saved bytes {got} against "
                               f"the meta count {want}")
    model.cfg = cfg
    del state, model, step, batch, tok, lab
    torch.cuda.empty_cache()
    # the float32 parity step under "dots" against "block"
    pc = TRAIN_PARITY[arch]
    cfg2, model = train_model(device, arch, pc["layers"])
    gen = torch.Generator(device=device).manual_seed(3)
    tok = torch.randint(0, cfg2.vocab, (pc["B"], pc["S"]), generator=gen,
                        device=device)
    lab = torch.randint(0, cfg2.vocab, (pc["B"], pc["S"]), generator=gen,
                        device=device)
    runs, parity_launches = {}, {}
    for r in ("block", "dots"):
        model.cfg = dataclasses.replace(cfg2, remat=r)
        model.zero_grad(set_to_none=True)
        KL.reset_launches()
        loss = loss_fn(model, tok, lab, dtype=torch.float32)
        loss.backward()
        parity_launches[r] = dict(KL.LAUNCHES)
        runs[r] = (loss.detach(), [p.grad.detach().clone()
                                   for p in model.parameters()])
    (la, ga), (lb, gb) = runs["block"], runs["dots"]
    equal = torch.equal(la, lb) and all(torch.equal(x, y)
                                        for x, y in zip(ga, gb))
    loss_rel = abs(lb.item() - la.item()) / abs(la.item())
    grad_rel = max((x - y).abs().max().item()
                   / max(y.abs().max().item(), 1e-30)
                   for x, y in zip(gb, ga))
    print(f"[remat] float32 parity step, {cfg2.n_layers} layers at "
          f"{pc['B']} x {pc['S']}: \"dots\" against \"block\" "
          f"{'bit-equal' if equal else 'NOT bit-equal'}; loss rel "
          f"{loss_rel:.3e} (bar {TRAIN_LOSS_REL:g}), worst gradient "
          f"{grad_rel:.3e} of its max (bar {TRAIN_GRAD_REL:g}); launches "
          + ", ".join(f"{k} {v}" for k, v in parity_launches["dots"].items()
                      if v), flush=True)
    if loss_rel > TRAIN_LOSS_REL or grad_rel > TRAIN_GRAD_REL:
        raise RuntimeError("[remat] the float32 parity step under \"dots\" "
                           "is past the bars")
    if not all(parity_launches["dots"].get(k) for k in keys):
        raise RuntimeError(f"[remat] the parity step skipped a kernel: "
                           f"{parity_launches['dots']}")
    del runs, model, ga, gb
    torch.cuda.empty_cache()
    return {"step_ms": med, "peak_gib": peaks, "saved": saved,
            "launches": launches["dots"],
            "parity_launches": parity_launches["dots"],
            "parity_equal": equal}


# ``[int8-dist]``: int8 Granite-8B (quantized from the float32 masters of
# 2 full-width layers) laid out on the (1, 1) NCCL mesh
# (``serve.quantize.shard_quantized``: every q and s a DTensor shard,
# gathered at use) in turns with the unsharded int8 model: bf16 compute,
# 8 x 2048 prompts, 8 greedy steps
INT8_DIST = {"arch": "granite_8b", "layers": 2, "B": 8, "S": 2048,
             "decode": 8, "cache": 2056, "rounds": 2}


def int8_dist_one_rank(device) -> dict:
    """``[int8-dist]`` (:data:`INT8_DIST`), in :func:`train_dist_phase`'s
    one-rank NCCL group: the logits (prefill and every step), the caches
    and the tokens of the sharded int8 model must equal the unsharded int8
    model's bit for bit; prints each one's prefill ms and decode ms a step
    (medians) and the sharded request's launches."""
    import torch

    from repro_torch import models as TM
    from repro_torch.configs import get_config
    from repro_torch.kernels import library as KL
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.serve import quantize_params, shard_quantized

    c = INT8_DIST
    B, S, n, cache = (c[k] for k in ("B", "S", "decode", "cache"))
    cfg = dataclasses.replace(get_config(c["arch"]), n_layers=c["layers"])
    f32 = TM.init_params(TM.Transformer(cfg, dtype=torch.float32,
                                        device=device), seed=0)
    qm = quantize_params(f32).with_dtype(torch.bfloat16)
    del f32
    torch.cuda.empty_cache()
    mesh = device_mesh((1, 1), ("data", "model"), device_type="cuda")
    models = {"unsharded": qm, "sharded": shard_quantized(qm, mesh)}
    gen = torch.Generator(device=device).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device=device)
    print(f"[int8-dist] {cfg.name}: {cfg.n_layers} layers at full width, "
          f"int8 weights ({qm.nbytes() / 1e9:.3f} GB), bf16 compute, B={B} "
          f"prompts of {S} tokens, {n} greedy steps; NCCL, one rank, mesh "
          f"(1, 1) (each q and s a DTensor shard, gathered at use)",
          flush=True)

    def serve(kind):
        model = models[kind]
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, caches = TM.prefill(model, tokens, cache_len=cache,
                                    quantized=True)
        torch.cuda.synchronize()
        out = {"pre_ms": 1e3 * (time.perf_counter() - t),
               "logits": [logits], "tokens": [], "steps": []}
        tok = logits.argmax(-1)
        for i in range(n):
            t = time.perf_counter()
            step, caches = TM.decode_step(model, tok, caches, S + i,
                                          quantized=True)
            tok = step.argmax(-1)
            torch.cuda.synchronize()
            out["steps"].append(1e3 * (time.perf_counter() - t))
            out["logits"].append(step)
            out["tokens"].append(tok)
        out["caches"] = caches
        return out

    for kind in models:  # warm-up
        serve(kind)
    pre = {k: [] for k in models}
    dec = {k: [] for k in models}
    first, launches = {}, {}
    for r in range(c["rounds"]):
        for kind in models:
            KL.reset_launches()
            out = serve(kind)
            pre[kind].append(out["pre_ms"])
            dec[kind] += out["steps"]
            if r == 0:
                first[kind] = out
                launches[kind] = {k: KL.LAUNCHES[k] for k in LM_LAUNCHES}
    a, b = first["sharded"], first["unsharded"]
    equal = {
        "logits": all(torch.equal(x, y) for x, y in zip(a["logits"],
                                                        b["logits"])),
        "caches": all(torch.equal(x[k], y[k]) for x, y in zip(
            a["caches"], b["caches"]) for k in x),
        "tokens": all(torch.equal(x, y) for x, y in zip(a["tokens"],
                                                        b["tokens"]))}
    med = {k: (statistics.median(pre[k]), statistics.median(dec[k]))
           for k in models}
    norms = cfg.n_layers + 1
    want = {"flash_attention": cfg.n_layers, "flash_attention_window": 0,
            "rmsnorm": norms * (1 + n), "rmsnorm_residual": cfg.n_layers
            * (1 + n), "ssm_state_scan": 0}
    print(f"[int8-dist] sharded vs unsharded int8, bit for bit: "
          + ", ".join(f"{k} {'equal' if v else 'DIFFER'}"
                      for k, v in equal.items()), flush=True)
    for kind in models:
        print(f"[int8-dist] {kind}: prefill ms {med[kind][0]:.3f} (median "
              f"of {c['rounds']}), decode ms a step {med[kind][1]:.3f} "
              f"(median of {c['rounds']} x {n})", flush=True)
    print(f"[int8-dist] sharded launches in a request: "
          f"{launches['sharded']} (expected {want})", flush=True)
    if not all(equal.values()):
        raise RuntimeError(f"int8 serving on the mesh differs from the "
                           f"unsharded int8 model: {equal}")
    if launches["sharded"] != want or launches["unsharded"] != want:
        raise RuntimeError("the int8 mesh path did not launch K8/K9 as "
                           "expected")
    del models, qm, first, a, b
    torch.cuda.empty_cache()
    return {"launches": launches["sharded"], "prefill_ms": med["sharded"][0],
            "decode_ms": med["sharded"][1],
            "plain_prefill_ms": med["unsharded"][0],
            "plain_decode_ms": med["unsharded"][1]}


# two gloo processes on the one card (NCCL refuses two ranks on one GPU).
# ``[long-ctx]``: Gemma-2-2B at full depth, float32, one row, a 32,768-token
# prompt (past the 4096 window: the local rings are split too) into caches
# of 32,776; each rank prefills the row, ``parallel.sharding.split_caches``
# keeps its slots of every KV cache on a (2, 1) mesh, then 8 greedy steps,
# against rank 0's decode of its whole caches.  ``[seq-shard]``: Granite-8B
# cut to 2 layers, bf16, 8 x 2048 prompts, laid out on a (1, 2) mesh, its
# prefill with ``seq_shard`` against the unsharded model's; and one bf16
# loss and backward of 2 x 2048 on the float32 masters, with ``seq_shard``
# through ``Gathered``, against the unsharded one (each rank its shard of
# each gradient)
LONG_CTX = {"arch": "gemma2_2b", "S": 32768, "decode": 8, "mesh": (2, 1)}
SEQ_SHARD = {"arch": "granite_8b", "layers": 2, "B": 8, "S": 2048,
             "mesh": (1, 2), "train": (2, 2048), "rounds": 2}
LONG_CTX_REL = 1e-5
#: the hillclimb's paths that compute in float32 (K8's f32 kernels)
HILL_F32 = ("remat-parity", "long-ctx prefill", "long-ctx decode")

PAIR_WORKER = r"""
import dataclasses, datetime, json, sys, time
import torch, torch.distributed as dist
rank, world, init, dest, spec = sys.argv[1:6]
rank, world, spec = int(rank), int(world), json.loads(spec)
torch.backends.cuda.matmul.allow_tf32 = False
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=600))
from repro_torch import models as TM
from repro_torch.configs import get_config
from repro_torch.data.pipeline import local_rows
from repro_torch.kernels import library as KL
from repro_torch.launch.mesh import device_mesh
from repro_torch.parallel import sharding as SH
dev = torch.device("cuda", 0)
res = {"rank": rank}

def ms_since(t):
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t)

def greedy(model, caches, logits, S, n):
    out, times, tok = [logits[:, -1]], [], logits.argmax(-1)
    for i in range(n):
        t = time.perf_counter()
        logits, caches = TM.decode_step(model, tok, caches, S + i)
        times.append(ms_since(t))
        out.append(logits[:, -1])
        tok = logits.argmax(-1)
    return torch.stack(out, 1), times

# [long-ctx]
lc = spec["long"]
cfg = get_config(lc["arch"])
S, n = lc["S"], lc["decode"]
model = TM.init_params(TM.Transformer(cfg, dtype=torch.float32, device=dev),
                       seed=0)
gen = torch.Generator(device=dev).manual_seed(5)
tokens = torch.randint(0, cfg.vocab, (1, S), generator=gen, device=dev)
mesh = device_mesh(tuple(lc["mesh"]), ("data", "model"), device_type="cuda")
KL.reset_launches()
torch.cuda.synchronize()
t = time.perf_counter()
with torch.no_grad():
    logits, caches = TM.prefill(model, tokens, cache_len=S + n)
res["long_prefill_ms"] = ms_since(t)
res["long_prefill_launches"] = dict(KL.LAUNCHES)
whole = ([{k: v.clone() for k, v in c.items()} for c in caches]
         if rank == 0 else None)
split = SH.split_caches(caches, mesh)
del caches
res["long_slots"] = sorted({SH.local(c["k"]).shape[1] for c in split
                            if "k" in c})
KL.reset_launches()
with torch.no_grad():
    got, times = greedy(model, split, logits, S, n)
res["long_decode_launches"] = dict(KL.LAUNCHES)
res["long_split_ms"] = times
if rank == 0:
    with torch.no_grad():
        want, times = greedy(model, whole, logits, S, n)
    res["long_whole_ms"] = times
    scale = want.abs().max().item()
    res["long_err"] = (got - want).abs().max().item() / scale
    res["long_tokens_equal"] = bool(torch.equal(got.argmax(-1),
                                                want.argmax(-1)))
    res["long_tokens"] = got.argmax(-1)[0].tolist()
del model, split, whole, logits, got
torch.cuda.empty_cache()
# [seq-shard]
ss = spec["seq"]
cfg = dataclasses.replace(get_config(ss["arch"]), n_layers=ss["layers"])
B, S = ss["B"], ss["S"]
mesh = device_mesh(tuple(ss["mesh"]), ("data", "model"), device_type="cuda")
sharded = SH.init_params(TM.Transformer(cfg, dtype=torch.bfloat16,
                                        device="meta"), seed=0, mesh=mesh)
plain = TM.init_params(TM.Transformer(cfg, dtype=torch.bfloat16, device=dev),
                       seed=0)
gen = torch.Generator(device=dev).manual_seed(5)
tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
rows = local_rows(mesh, B).to(dev)
runs = {"seq_shard": lambda: TM.prefill(sharded, tokens[rows],
                                        seq_shard=True),
        "sharded": lambda: TM.prefill(sharded, tokens[rows]),
        "unsharded": lambda: TM.prefill(plain, tokens[rows])}
times, first = {k: [] for k in runs}, {}
with torch.no_grad():
    for r in range(1 + ss["rounds"]):
        for k, run in runs.items():
            KL.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = run()
            ms = ms_since(t)
            if r == 0:
                res.setdefault("seq_launches", {})[k] = dict(KL.LAUNCHES)
                first[k] = out
            else:
                times[k].append(ms)
            del out
a, b = first["seq_shard"], first["unsharded"]
res["seq_times"] = times
res["seq_equal"] = {
    "logits": bool(torch.equal(a[0], b[0])),
    "caches": all(torch.equal(x[k], y[k]) for x, y in zip(a[1], b[1])
                  for k in x)}
del sharded, plain, a, b, first
torch.cuda.empty_cache()
# one training micro-batch with seq_shard on the float32 masters
tb, ts = ss["train"]
masters = SH.init_params(TM.Transformer(cfg, dtype=torch.float32,
                                        device="meta"), seed=0, mesh=mesh)
masters.requires_grad_(True)
plain = TM.init_params(TM.Transformer(cfg, dtype=torch.float32, device=dev),
                       seed=0).requires_grad_(True)
tok = torch.randint(0, cfg.vocab, (tb, ts), generator=gen, device=dev)
lab = torch.randint(0, cfg.vocab, (tb, ts), generator=gen, device=dev)
KL.reset_launches()
torch.cuda.synchronize()
t = time.perf_counter()
net = SH.Gathered(masters, SH.dp_axes(mesh))
loss = TM.loss_fn(net, tok, lab, seq_shard=True)
net.backward(loss)
res["seq_train_ms"] = ms_since(t)
res["seq_train_launches"] = dict(KL.LAUNCHES)
t = time.perf_counter()
want = TM.loss_fn(plain, tok, lab)
want.backward()
res["plain_train_ms"] = ms_since(t)
equal = bool(torch.equal(loss.detach(), want.detach()))
for p, q in zip(masters.parameters(), plain.parameters()):
    index = SH.local_block(q.shape, p.placements, p.device_mesh)
    equal = equal and bool(torch.equal(SH.local(p.grad), q.grad[index]))
res["seq_train_equal"] = equal
res["seq_train_loss"] = (loss.item(), want.item())
with open(dest, "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def pair_phase(device) -> dict:
    """``[long-ctx]`` (:data:`LONG_CTX`) and ``[seq-shard]``
    (:data:`SEQ_SHARD`) on two gloo processes of the card.  Holds: the
    split decode's logits within :data:`LONG_CTX_REL` of the largest
    |logit| of rank 0's whole-cache decode, with the same greedy tokens;
    the ``seq_shard`` prefill's logits and caches and the training
    micro-batch's loss and each rank's gradient shards bit-equal to the
    unsharded model's; each path's kernels launched (K8 f32's causal and
    window instances and K9 in the long prefill, K9 in every decode step,
    K8 bf16 and K9 in the ``seq_shard`` prefill, their backwards in its
    training micro-batch)."""
    import os
    import shutil
    import tempfile

    world = 2
    spec = {"long": LONG_CTX, "seq": SEQ_SHARD}
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="4")
    lc, ss = LONG_CTX, SEQ_SHARD
    print(f"[long-ctx] {lc['arch']} at full depth, float32, 1 row of "
          f"{lc['S']} prompt tokens, {lc['decode']} greedy steps; gloo, "
          f"{world} ranks on the one card, mesh {lc['mesh']}: each KV cache "
          f"split along its slots, the one-process decode of the same "
          f"caches on rank 0", flush=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", PAIR_WORKER, str(r), str(world),
         f"file://{tmp}/rdv", str(tmp / f"rank{r}.json"), json.dumps(spec)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("a gloo rank failed:\n" + "\n".join(
            log[-3000:] for log in logs))
    res = [json.loads((tmp / f"rank{r}.json").read_text())
           for r in range(world)]
    shutil.rmtree(tmp, ignore_errors=True)
    r0 = res[0]
    n = lc["decode"]
    norms = {k: v for k, v in r0["long_decode_launches"].items() if v}
    print(f"[long-ctx] prefill ms {r0['long_prefill_ms']:.3f} (rank 0; "
          f"rank 1 {res[1]['long_prefill_ms']:.3f}), launches "
          + ", ".join(f"{k} {v}" for k, v in
                      r0["long_prefill_launches"].items() if v)
          + f"; slots a rank {r0['long_slots']}", flush=True)
    print(f"[long-ctx] split decode ms a step "
          f"{statistics.median(r0['long_split_ms']):.3f} "
          f"(median of {n}), whole-cache decode "
          f"{statistics.median(r0['long_whole_ms']):.3f}; launches in the "
          f"{n} split steps: " + ", ".join(f"{k} {v}" for k, v in
                                           norms.items()), flush=True)
    print(f"[long-ctx] logits against the whole-cache decode: max "
          f"{r0['long_err']:.3e} of the largest |logit| (bar "
          f"{LONG_CTX_REL:g}); greedy tokens "
          f"{'equal' if r0['long_tokens_equal'] else 'DIFFER'} "
          f"{r0['long_tokens']}", flush=True)
    from repro_torch.configs import get_config

    pl = r0["long_prefill_launches"]
    cfg = get_config(lc["arch"])
    n_local = cfg.n_groups * cfg.pattern.count("local")
    if not (pl.get("flash_attention") == cfg.n_layers
            and pl.get("flash_attention_window") == n_local
            and pl.get("rmsnorm") and pl.get("rmsnorm_residual")):
        raise RuntimeError(f"[long-ctx] the prefill's launches {pl}")
    if not (norms.get("rmsnorm") and norms.get("rmsnorm_residual")
            and not norms.get("flash_attention")):
        raise RuntimeError(f"[long-ctx] the decode's launches {norms}")
    if r0["long_err"] > LONG_CTX_REL or not r0["long_tokens_equal"]:
        raise RuntimeError("[long-ctx] the split decode differs from the "
                           "whole-cache decode")
    print(f"[seq-shard] {ss['arch']}: {ss['layers']} layers at full width, "
          f"bf16, {ss['B']} x {ss['S']} prompts, mesh {ss['mesh']} (gloo, "
          f"the stream split over \"model\" between blocks)", flush=True)
    for r in res:
        med = {k: statistics.median(v) for k, v in r["seq_times"].items()}
        print(f"[seq-shard] rank {r['rank']}: prefill ms seq_shard "
              f"{med['seq_shard']:.3f}, sharded without it "
              f"{med['sharded']:.3f}, unsharded {med['unsharded']:.3f} "
              f"(medians of {ss['rounds']}); seq_shard against unsharded: "
              + ", ".join(f"{k} {'equal' if v else 'DIFFER'}"
                          for k, v in r["seq_equal"].items())
              + f"; training micro-batch {ss['train']} ms "
              f"{r['seq_train_ms']:.3f} (unsharded "
              f"{r['plain_train_ms']:.3f}), loss {r['seq_train_loss'][0]:.6f}"
              f" and gradient shards "
              f"{'bit-equal' if r['seq_train_equal'] else 'DIFFER'}",
              flush=True)
        got = r["seq_launches"]["seq_shard"]
        tl = r["seq_train_launches"]
        print(f"[seq-shard] rank {r['rank']} launches: prefill "
              + ", ".join(f"{k} {v}" for k, v in got.items() if v)
              + "; training micro-batch "
              + ", ".join(f"{k} {v}" for k, v in tl.items() if v),
              flush=True)
        if not all(r["seq_equal"].values()) or not r["seq_train_equal"]:
            raise RuntimeError(f"[seq-shard] rank {r['rank']} differs from "
                               "the unsharded model")
        if got != r["seq_launches"]["unsharded"] or not all(
                got.get(k) for k in ("flash_attention", "rmsnorm",
                                     "rmsnorm_residual")):
            raise RuntimeError(f"[seq-shard] prefill launches {got}")
        if not all(tl.get(k) for k in TRAIN_LAUNCHES):
            raise RuntimeError(f"[seq-shard] training launches {tl}")
    print(f"[phase] long-ctx and seq-shard (gloo pair) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"long_prefill": pl, "long_decode": norms,
            "seq_prefill": {k: sum(r["seq_launches"]["seq_shard"].get(k, 0)
                                   for r in res) for k in LM_LAUNCHES},
            "seq_train": {k: sum(r["seq_train_launches"].get(k, 0)
                                 for r in res) for k in TRAIN_LAUNCHES}}


def roofline_phase(serve: dict, train: dict) -> list:
    """``[roofline]``: for each training cell of :data:`TRAIN` and each
    served model's prefill and decode step, the cost model
    (``launch.roofline.analyze_cell`` on one card, ``chips=1``) at the
    cell's own config (depth cut as run), batch, length and ``grad_accum``
    (a decode step over the whole cache, which it reads): its FLOPs and
    HBM bytes, the compute and memory terms at the H100 data sheet's
    rates, the measured ms (a training step's median, a prefill's median,
    a decode step's median) and the bound over the measurement as a
    share.  A share above 100 % fails the run: no step beats its bound, so
    it would say the cost model undercounts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline as RL
    from repro_torch.models.config import ShapeSpec

    out = []

    def line(name, cfg, shape, accum, ms, extra=""):
        rec = RL.analyze_cell(cfg, shape, chips=1, grad_accum=accum)
        share = 1e3 * rec["bound_s"] / ms
        print(f"[roofline] {name}: cost model {rec['hlo_flops_corrected']:.4e}"
              f" FLOPs, {rec['hbm_bytes']:.4e} HBM bytes; compute "
              f"{1e3 * rec['compute_s']:.3f} ms, memory "
              f"{1e3 * rec['memory_s']:.3f} ms ({rec['dominant']}); "
              f"measured {ms:.3f} ms; bound / measured {100 * share:.1f} %"
              + extra, flush=True)
        out.append({"cell": name, "bound_ms": 1e3 * rec["bound_s"],
                    "ms": ms, "share": share, "dominant": rec["dominant"]})

    print(f"[roofline] one H100 priced from its data sheet: "
          f"{RL.PEAK_FLOPS:.4g} FLOP/s bf16 dense, {RL.HBM_BW:.4g} B/s HBM",
          flush=True)
    for arch, cell in TRAIN.items():
        cfg = get_config(arch)
        if cell["layers"] is not None:
            cfg = dataclasses.replace(cfg, n_layers=cell["layers"])
        B, S, run = cell["B"], cell["S"], train[arch]
        line(f"train {arch} ({cfg.n_layers} layers, {B} x {S}, grad_accum "
             f"{cell['accum']})", cfg, ShapeSpec(f"train_{S}", S, B, "train"),
             cell["accum"], run["step_ms"],
             f"; train_flops {run['flops'] / 1e12:.2f} TFLOP a step, "
             f"{run['flops'] / run['step_ms'] / 1e9:.1f} model TFLOP/s")
    for arch in SERVED_MODELS:
        run = serve[arch]
        cfg = dataclasses.replace(get_config(arch), n_layers=run["layers"])
        t = TRAFFIC.get(arch, (PARITY, SERVE))[1]
        B, S, cache = t["B"], t["S"], t["cache"]
        line(f"prefill {arch} ({cfg.n_layers} layers, {B} x {S})", cfg,
             ShapeSpec(f"prefill_{S}", S, B, "prefill"), None,
             run["prefill_ms"])
        line(f"decode {arch} ({cfg.n_layers} layers, {B} rows, cache "
             f"{cache})", cfg, ShapeSpec(f"decode_{cache}", cache, B,
                                         "decode"), None, run["decode_ms"])
    past = [r["cell"] for r in out if r["share"] > 1.0]
    if past:
        raise RuntimeError(f"a step beat its bound: {past}")
    return out


def kernel_records(rows: list, members: list, standalone: dict, path: dict,
                   ensemble: dict, opt3: dict, lm: dict, serve: dict,
                   distributed: dict, bwd: dict, parity: dict,
                   train: dict, hill: dict) -> list:
    """One record per kernel for the ``kernels`` line: the launches of its
    path (the opt-0 sequential step for K1-K3, the 3 opt-3 steps on the TPU
    preset's schedules for K4, the op calls for K6/K7; for K5 the member
    launches of the 3 opt-0 ensemble steps under "grid" plus those of the
    opt-3 M = 4 ensemble step, K4's 8 among them, each counted from zero
    just before its run), the worst error of its checks, and the times and
    bound of its first case (fx_ppm, tridiag_solve, interface_interp;
    fx_ppm under "grid" for K5; precompute_pe at block_k 16 for K4).  K8's
    bf16 kernel, K9 and K10 count one bf16 serving request (a prefill and
    its decode steps) of each served model (:data:`SERVED_MODELS`) and the
    int8 run's (a prefill and the decode steps over both KV caches), and
    take their times from the bf16 case (K8 at Granite's shape and softcap
    0, K9 at Zamba2's d_model over a prefill's rows with a float32 weight)
    and, for K10, Zamba2's serving shape; K8's float32 kernel counts the
    float32 parity runs of every model and the int8 run's float32 greedy
    run, and takes its times from the
    float32 case at Granite's shape, softcap 0.  K8's window has a record
    of each dtype: the launches with a window (Gemma-2's local layers,
    also counted in K8's record) and the times at Gemma-2's shape, window
    4096, softcap 0.  K1-K4 also carry ``distributed_launches``: their
    launches in the 3 overlapped distributed steps.  The backward kernels
    (no TPU counterpart: ``replaces`` names the forward kernel they
    differentiate) count the training cells' steps (bf16; K10's in
    float32) and the float32 parity steps (K8), and take their times from
    the backward phase at Granite's shape (K8), :data:`BWD_NORM` (K9) and
    the Zamba2 training step's micro-batch, :data:`BWD_SCAN`'s first (K10);
    K8's bf16 backward also carries ``window_launches`` (Gemma-2's local
    layers); K8's bf16 forward, K9's and K10's records also carry
    ``train_launches``, their launches in the training cells' steps
    (recomputation included).  ``parity`` and ``train`` map each
    architecture to its phase's result.  ``hill`` maps each path of the
    hillclimb (``[remat]``, ``[long-ctx]``, ``[seq-shard]``,
    ``[int8-dist]``) to its launches; the records of the kernels they run
    carry them as ``hillclimb_launches`` (K8's by the path's dtype)."""

    def trained(count):
        return sum(run["launches"].get(count, 0) for run in train.values())

    def hillclimbed(count, dtype=None):
        return {p: run.get(count, 0) for p, run in hill.items()
                if dtype is None or (p in HILL_F32) == (dtype == "float32")}

    replaces = {"K1": f"{PALLAS}:350", "K2": f"{PALLAS}:486",
                "K3": f"{PALLAS}:99", "K4": f"{PALLAS}:635",
                "K5": f"{PALLAS}:207",
                "K6": "src/repro/kernels/tridiag.py:22",
                "K7": "src/repro/kernels/fvt_flux.py:21"}
    names = {"K1": "stencil_parallel_kernel", "K2": "stencil_column_kernel",
             "K3": "march_search",
             "K4": "stencil_kblocked_kernel (march_columns, K2's march, "
                   "copies a slab ahead)",
             "K5": "member axis of stencil_parallel_kernel, "
                   "stencil_column_kernel and stencil_kblocked_kernel",
             "K6": "tridiag_kernel", "K7": "fvt_flux_kernel"}
    counts = {"K1": "horizontal", "K2": "column", "K3": "search"}
    kernels = []
    for k in ("K1", "K2", "K3", "K4", "K5"):
        mine = [r for r in rows + members if r["kernel"] == k]
        head = mine[0]
        launches = (ensemble[(4, "grid")]["launches"]["member"]
                    + opt3["ensemble"]["launches"]["member"] if k == "K5"
                    else opt3[OPT3_HARDWARE]["launches"]["kblocked"]
                    if k == "K4" else path["launches"][counts[k]])
        kernels.append({
            "name": names[k], "route": "cuda", "source": SOURCE,
            "replaces": replaces[k], "launches": launches,
            "max_abs_err": max(r["err"] for r in mine),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None})
        if k != "K5":
            kernels[-1]["distributed_launches"] = distributed["launches"][
                counts.get(k, "kblocked")]
    for k, count in (("K6", "tridiag"), ("K7", "fvt_flux")):
        r = standalone["rows"][k]
        kernels.append({
            "name": names[k], "route": "cuda", "source": FV3_SOURCE,
            "replaces": replaces[k],
            "launches": standalone["launches"][count],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    f32 = next(r for r in lm["K8"] if r["dtype"] == "float32"
               and r["softcap"] == 0.0 and r["D"] == 128
               and r["window"] == 0)
    kernels.append({
        "name": "flash_attention_fwd_kernel", "route": "cuda",
        "source": LM_SOURCE,
        "replaces": "src/repro/kernels/flash_attention.py:21",
        "launches": sum(run["parity_launches"]["flash_attention"]
                        for run in serve.values()),
        "max_abs_err": max(r["err"] for r in lm["K8"]
                           if r["dtype"] == "float32"),
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "hillclimb_launches": hillclimbed("flash_attention", "float32")})
    for key, name, line, count in (
            ("K8", "flash_attention_wgmma_kernel",
             "src/repro/kernels/flash_attention.py:21", "flash_attention"),
            ("rmsnorm", "rmsnorm_kernel", "src/repro/kernels/rmsnorm.py:17",
             "rmsnorm"),
            ("rmsnorm_residual", "rmsnorm_residual_kernel",
             "src/repro/kernels/rmsnorm.py:25", "rmsnorm_residual"),
            ("K10", "ssm_state_scan_kernel",
             "src/repro/kernels/ssm_scan.py:23", "ssm_state_scan")):
        mine = [r for r in lm[key] if key != "K8"
                or r["dtype"] == "bfloat16"]
        head = next(r for r in mine if r.get("dtype", "float32") ==
                    ("float32" if key == "K10" else "bfloat16")
                    and r.get("softcap", 0.0) == 0.0
                    and r.get("D", 128) == 128
                    and r.get("window", 0) == 0
                    and (r.get("rows"), r.get("d")) in ((None, None),
                                                        NORM_HEAD))
        kernels.append({
            "name": name, "route": "cuda", "source": LM_SOURCE,
            "replaces": line,
            "launches": sum(run["launches"][count] for run in serve.values()),
            "max_abs_err": max(r["err"] for r in mine), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "hillclimb_launches": hillclimbed(
                count, "bfloat16" if key == "K8" else None)})
    # K8 with its window (Gemma-2's local layers): the windowed launches of
    # the bf16 requests and of the f32 parity runs, the times of the window
    # 4096 case at Gemma-2's shape without the softcap (beside SDPA with the
    # window as a mask)
    for dtype, name, count in (
            ("bfloat16", "flash_attention_wgmma_kernel", "launches"),
            ("float32", "flash_attention_fwd_kernel", "parity_launches")):
        mine = [r for r in lm["K8"] if r["dtype"] == dtype and r["window"]]
        head = next(r for r in mine if r["softcap"] == 0.0)
        kernels.append({
            "name": f"{name} (window {head['window']}, D {head['D']})",
            "route": "cuda", "source": LM_SOURCE,
            "replaces": "src/repro/kernels/flash_attention.py:21",
            "launches": sum(run[count]["flash_attention_window"]
                            for run in serve.values()),
            "max_abs_err": max(r["err"] for r in mine), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "hillclimb_launches": hillclimbed("flash_attention_window",
                                              dtype)})
    for rec in kernels:
        count = {"flash_attention_wgmma_kernel": "flash_attention",
                 "rmsnorm_kernel": "rmsnorm",
                 "rmsnorm_residual_kernel": "rmsnorm_residual",
                 "ssm_state_scan_kernel": "ssm_state_scan"}.get(rec["name"])
        if count is not None:
            rec["train_launches"] = trained(count)
    bwd_names = {
        "bfloat16": "flash_attention_bwd_wgmma_dkdv_kernel, flash_attention_"
                    "bwd_wgmma_dq_kernel, flash_attention_bwd_rows_kernel",
        "float32": "flash_attention_bwd_tf32_dkdv_kernel, flash_attention_"
                   "bwd_tf32_dq_kernel, flash_attention_bwd_rows_kernel"}
    for dtype, launches in (
            ("bfloat16", trained("flash_attention_bwd")),
            ("float32", sum(run["launches_f32"].get("flash_attention_bwd", 0)
                            for run in parity.values()))):
        mine = [r for r in bwd["K8"] if r["dtype"] == dtype]
        head = mine[0]  # Granite's shape, BWD_FA's first
        kernels.append({
            "name": f"{bwd_names[dtype]} ({dtype})", "route": "cuda",
            "source": LM_SOURCE,
            "replaces": "src/repro/kernels/flash_attention.py:21",
            "note": "K8's backward; the reference differentiates its jnp "
                    "attention, no TPU kernel",
            "launches": launches,
            "max_abs_err": max(r["err"] for r in mine), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "hillclimb_launches": hillclimbed("flash_attention_bwd", dtype)})
        if dtype == "bfloat16":
            kernels[-1]["window_launches"] = trained(
                "flash_attention_bwd_window")
    for form, line in (("rmsnorm", "src/repro/kernels/rmsnorm.py:17"),
                       ("rmsnorm_residual",
                        "src/repro/kernels/rmsnorm.py:25")):
        mine = [r for r in bwd["K9"] if r["form"] == form]
        head = next(r for r in mine if r["dtype"] == "bfloat16")
        kernels.append({
            "name": f"rmsnorm_bwd_kernel<{form}> + rmsnorm_bwd_dw_kernel",
            "route": "cuda", "source": LM_SOURCE, "replaces": line,
            "note": "K9's backward; the reference differentiates its jnp "
                    "norm, no TPU kernel",
            "launches": trained(f"{form}_bwd"),
            "max_abs_err": max(r["err"] for r in mine), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "hillclimb_launches": hillclimbed(f"{form}_bwd")})
    head = bwd["K10"][0]  # the Zamba2 training step's micro-batch
    kernels.append({
        "name": "ssm_state_scan_bwd_kernel", "route": "cuda",
        "source": LM_SOURCE, "replaces": "src/repro/kernels/ssm_scan.py:23",
        "note": "K10's backward; the reference differentiates its lax.scan, "
                "no TPU kernel",
        "launches": trained("ssm_state_scan_bwd"),
        "max_abs_err": max(r["err"] for r in bwd["K10"]), "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"]})
    return kernels


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.backend import cuda as C
    from repro_torch.kernels import library as KL

    t_start = time.perf_counter()
    card = card_line()
    print(f"[card] {card}", flush=True)
    # full float32 products everywhere (the plain versions and the parity
    # run are float32 references; TF32 keeps ~3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(max_workers=3) as pool:
        libs = list(pool.map(C.build_library,
                             ("stencil_kernels", "fv3_kernels",
                              "lm_kernels")))
    C.load_library()
    KL.load_library()
    KL.load_lm_library()
    print(f"[build] {time.perf_counter() - t0:.2f} s -> "
          + ", ".join(str(lib.relative_to(ROOT)) for lib in libs),
          flush=True)
    for lib in libs:
        for line in (lib.parent / "build.log").read_text().splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"[build] {lib.stem}: {line.strip()}")
    build_report(*libs)
    sass = k8_sass_report(libs[2])
    for kind, fn in K8_SASS:
        c = sass[kind]["total"]
        print(f"[build] K8 {fn} SASS: {c['HGMMA']} HGMMA (wgmma), "
              f"{c['UTMA']} UTMA* (TMA), {c['SYNCS']} SYNCS* (mbarrier), "
              f"{c['LDL']} LDL, {c['STL']} STL instructions over its "
              f"{len(sass[kind]['instances'])} instances")
        if c["HGMMA"] == 0:
            raise RuntimeError(f"{fn} issues no wgmma")
    # the backwards: wgmma in every instance, no local memory; the bf16
    # instances load by TMA, the f32 ones store by it, both on mbarriers
    for kind in ("bf16 backward dK/dV", "bf16 backward dQ",
                 "f32 backward dK/dV", "f32 backward dQ"):
        found = sass[kind]["instances"]
        want = K8_BWD_INSTANCES[kind.split()[0]]
        if len(found) != want:
            raise RuntimeError(f"K8 {kind}: {len(found)} instances in the "
                               f"SASS, not {want // 2} widths x "
                               "causal/window")
        for name, c in found.items():
            if (c["HGMMA"] == 0 or c["UTMA"] == 0 or c["SYNCS"] == 0
                    or c["LDL"] or c["STL"]):
                raise RuntimeError(f"{name}: {c['HGMMA']} HGMMA, "
                                   f"{c['UTMA']} UTMA, {c['SYNCS']} SYNCS, "
                                   f"{c['LDL']} LDL, {c['STL']} STL")
    if sass["f32"]["total"]["LDL"] or sass["f32"]["total"]["STL"]:
        raise RuntimeError("flash_attention_fwd_kernel uses local memory")
    for kind, regs, st, ld, stack in k8_build_report(
            (libs[2].parent / "build.log").read_text()):
        print(f"[build] K8 {kind}: {regs} registers at launch"
              + (" (its consumer warpgroups raise theirs to 240 with "
                 "setmaxnreg)" if "wgmma" in kind else "")
              + f", spill stores {st} B, spill loads {ld} B, stack "
              f"{stack} B")
        if "float32" in kind and (st or ld or stack):
            raise RuntimeError(f"{kind} spills")
    device = torch.device("cuda")
    # a fresh tuning cache: every run searches the schedules anew
    from repro_torch.core.backend import TuningCache, set_default_cache

    cache = ROOT / "build" / "repro_torch" / "chip_smoke_tuning.json"
    cache.unlink(missing_ok=True)
    set_default_cache(TuningCache(cache))
    rows = kernel_phase(device)
    members = member_phase(device) + kblocked_phase(device)
    table_phase(device)
    standalone = standalone_phase(device)
    path = path_phase(device)
    ensemble = ensemble_phase(device, path["launches"])
    work = opt_phase(device)
    opt3 = opt3_phase(device, path, work)
    distributed = distributed_phase(device, path["s0"], opt3.pop("s1"))
    del path["s0"], path["plain1"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm = lm_kernel_phase(device)
    print(f"[phase] LM kernels {time.perf_counter() - t0:.1f} s", flush=True)
    serve = {}
    for arch in SERVED_MODELS:
        t0 = time.perf_counter()
        serve[arch] = serving_phase(device, arch)
        print(f"[phase] serving {arch} {time.perf_counter() - t0:.1f} s",
              flush=True)
    t0 = time.perf_counter()
    int8 = int8_phase(device, serve[INT8_ARCH])
    serve[int8["name"]] = int8
    print(f"[phase] int8 serving {INT8_ARCH} {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    t0 = time.perf_counter()
    bwd = backward_phase(device)
    print(f"[phase] backward kernels {time.perf_counter() - t0:.1f} s",
          flush=True)
    parity, train = {}, {}
    for arch in TRAIN_PARITY:
        t0 = time.perf_counter()
        parity[arch] = train_parity_phase(device, arch)
        print(f"[phase] training parity {arch} "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    for arch in TRAIN:
        t0 = time.perf_counter()
        train[arch] = train_phase(device, arch)
        print(f"[phase] training {arch} {time.perf_counter() - t0:.1f} s",
              flush=True)
    t0 = time.perf_counter()
    remat = remat_phase(device)
    print(f"[phase] remat {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    dist_out = train_dist_phase(device)
    print(f"[phase] training across ranks {time.perf_counter() - t0:.1f} s",
          flush=True)
    serve[dist_out["serve"]["name"]] = dist_out["serve"]
    pair = pair_phase(device)
    # each path of the hillclimb, its launches counted from 0 just before
    hill = {"remat": remat["launches"],
            "remat-parity": remat["parity_launches"],
            "long-ctx prefill": pair["long_prefill"],
            "long-ctx decode": pair["long_decode"],
            "seq-shard prefill": pair["seq_prefill"],
            "seq-shard train": pair["seq_train"],
            "int8-dist": dist_out["int8"]["launches"]}
    roofline_phase(serve, train)
    kernels = kernel_records(rows, members, standalone, path, ensemble, opt3,
                             lm, serve, distributed, bwd, parity, train, hill)
    print(f"[total] wall {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
