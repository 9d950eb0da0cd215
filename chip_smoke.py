#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (deepfm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  build      compile every CUDA kernel of the port from csrc/ (nvcc, one
             process per source, all at once) and the native negative
             sampler (g++, native/sampler.cc), print the card's name
             and power limit as nvidia-smi reports them and the attention
             forward's and backward's, cin_compress's, the bf16 CIN-stack
             forward's and backward's, fused_table_adam's, the row
             gather's and sparse_table_adam's ptxas lines (registers,
             shared memory, spills);
  cin_stack  hold the CIN-stack forward kernels (f32 on the FP32 pipes,
             bf16 on the tensor cores) against their plain PyTorch version
             on the card at six shapes (the serving config, bench.py's
             xDeepFM shape in f32 and bf16, a ragged shape the TPU
             kernel's gate refuses in f32 and bf16, and the xDeepFM
             paper's CIN at its batch in bf16), element by element
             (CIN_TOL), each launched twice to show the same bits and
             that it went through its own kernel (in bf16 also read, not
             gated, at CIN_SWEEP_DRAWS other seeded draws), with
             the kernel's, the plain version's and a library yardstick's
             median times (CUDA events) beside the shape's bound
             (below_library, the plan); in bf16 the check must also
             refuse two controls, the plain version without its
             hidden-state or outer-product rounding;
  cin_stack_bwd  the CIN-stack backward kernels (f32 on the FP32 pipes,
             bf16 on the tensor cores) against their plain version on the
             card at bench.py's xDeepFM shape in f32 and bf16, at the
             ragged shape in f32 and bf16, at the MovieLens configs'
             CIN in f32 and at the xDeepFM paper's Criteo CIN (B=4096,
             F=39, D=10, 3 x 200 maps) in bf16, the streamed layout of its
             plan (CIN_BWD_TOL), launched twice to show the same
             bits and that each went through its own kernel, timed beside
             its bound, its plain version and autograd through the plain
             forward (below_library, TFLOP/s, the plan), with its device
             time split by kernel (launch_breakdown: the tile kernel, dW,
             the split sums, db); in bf16 with the compiled tile kernel's
             registers, local memory, static shared memory and blocks an
             SM, and where the plan is streamed, the layers route's time
             on the same inputs (layers_ms, the route the bf16 backward
             took before the streamed layout); in bf16 the check must
             refuse the plain backward without its dcomp rounding, and
             the kernel is held besides to the plain version under the
             kernel's own ReLU masks (read from its dcomp workspace) at
             CIN_BWD_TOL, whose masks may part from the plain version's
             only within rounding of 0 (MASK_FLIP_TOL), with the mean
             relative error of each against the f32 backward under those
             masks; at the paper's CIN that is the gate, the comparison
             under the plain version's own masks is reported
             (CIN_BWD_OWN_MASKS_UNGATED);
  cin_compress  the per-layer CIN kernel against its plain version on the
             card in f32 at the three layer shapes of the xDeepFM paper's
             CIN (B=4096, F=27, D=10, 200 maps, H = 27, 200, 200) and a
             ragged shape (CIN_TOL), launched twice to show the same bits,
             timed beside its bound, the plain version and the outer
             product materialised plus one torch.matmul, with its plan
             (compress_plan: map tile, column tile, threads, grid, waves;
             at most 7 padded maps while M <= 256, at most
             MAX_PADDED_FMA_SHARE of a paper layer's products on them) and
             the compiled kernel's registers, local memory and blocks an
             SM (which must be the plan's), and its time split into device
             time (back-to-back launches) and host time a call; then the CIN
             stack's "layers" route (stack_route): its backward against
             the stack backward kernel at bench.py's f32 CIN shape
             (CIN_BWD_TOL); at the paper's CIN, CinStackFn's backward
             against the plain stack backward (ROUTE_BWD_TOL, which must
             refuse a planted fault); and its forward at a stack too wide
             for the stack forward against the plain version; each with
             the launches that show the route;
  attention  the attention-block forward and backward kernels against
             their plain versions at bench.py's AttentionDeepFM shape in
             bf16 and f32, at a ragged batch and at F=33 (ATTN_TOL), each
             launched twice, timed beside its bound (and the mixed bound:
             the core's f32 work at the FP32 rate), its plain version and
             scaled_dot_product_attention around the same projections
             (below_library); in bf16 the check must refuse the plain
             backward without its [dq|dk|dv] rounding and the plain
             forward without its context rounding; with the forward's plan
             (forward_plan), the compiled forward's registers, local memory
             and blocks an SM (which must be the plan's) and its call split
             into device and host time; then AutoInt's interacting layer
             at the paper's two layer shapes (INTERACT_SHAPES, B=16384,
             bf16 and f32) the same way (INTERACT_TOL; both plans;
             scaled_dot_product_attention at scale 1 around the same four
             projections as the library; in bf16 the check must refuse the
             plain backward without its [dq|dk|dv|dres] rounding; the
             backward's plan tiled and both its launches on the tiled
             core); last, the sha256 of every attention kernel's outputs at
             these shapes (attention_hashes; `python3 chip_smoke.py
             --attention-hashes TREE` prints another checkout's on the same
             inputs, its package first on the path);
  densify_rows_grad, segment_sumsq, sparse_table_adam, fused_table_adam
             the four table-update kernels at bench.py's shape (a 10.4M x 17
             table, 425,984 (id, cotangent) pairs drawn as bench.py draws
             its ids, bf16 moments, the clip active), each held against its
             plain version on the card (TABLE_TOL), launched twice to show
             the same bits, and timed (CUDA events) beside its bound, the
             plain version and, where one PyTorch call computes the same
             function, that call; the densify also with no pairs
             (fill_ms, the write stream alone, beside a memset of the
             same bytes), its achieved TB/s, on the
             long runs below (bit for bit, twice, timed) and on a ragged
             table (RAGGED_ROWS, ids also outside it) bit for bit, twice;
             fused_table_adam also on ragged, misaligned tables (8k + 3
             elements, views one element off a 16-byte boundary, f32 and
             bf16 moments, the clip on and off) bit for bit against its
             plain version; fused_table_adam's and sparse_table_adam's
             device time and host time a call beside the single-call time,
             and the device time's share of the bound; segment_sumsq's
             plan, its device time by kernel (torch.profiler), its host
             path (call_split) and its launches a call, which must be 1;
             then (long_runs) three of them again
             with two fields missing (id 0) in every row, runs of 16384
             equal ids, held to the plain versions and timed
             (sparse_table_adam with its call split, beside its uniform-ids
             time; segment_sumsq twice for the same bits, under
             LONG_RUN_SEGSQ_MS and one launch a call);
  packed_kernels  the packed layout's kernels at the same table packed
             (7 logical rows per 128-float row, 1,485,824 rows): the packed
             densify bit for bit against its plain version, twice, dead
             lanes 0, timed beside its bound, the plain version and one
             index_add_ into the flat packed table, and as the logical
             densify with no pairs, on the long runs and on the ragged
             table;
             sparse_table_adam on the packed table against its plain
             version (TABLE_TOL) and, bit for bit, against the logical
             kernel on the unpacked state, with its call split; the
             row-gather kernel bit for
             bit against its plain version, its single-call time split
             into device time (100 back-to-back launches) and host time
             per call, beside the same for index_select, in turns;
  train      the DeepFM train step at bench.py's full width and config
             (26 x 400k-id fields, d=16, DNN [512,256,128] with BatchNorm,
             batch 16384, bf16 compute, dropout 0) through the port's
             create_model and Trainer on the card: the default
             (sparse-fused) path timed over 10 steps after warm-up, with a
             torch.profiler step; 2 steps on it and 2 on the two-pass path
             from the same weights must agree (TRAIN_TOL); at 20k ids per
             field, in f32, the card's first-step gradients must agree
             with the CPU's (GRAD_MAX_REL, GRAD_NORM_REL) while three
             planted faults are refused, and with f32 moments the card's
             2 steps must agree with the CPU's (plain versions) on both
             paths; each path's kernels must have launched on it;
             then (train_packed) the same DeepFM step on packed tables: the
             sparse-fused step timed and profiled, 2 steps against the
             logical sparse-fused step from the same logical weights and
             against the packed two-pass step (TRAIN_TOL), the row-gather
             lookup (use_embedding_kernel, two-pass) against the default
             two-pass step, and at 20k ids in f32 the packed first-step
             gradients card against CPU with a planted fault (the packed
             densify one sub-slot off) that must be refused;
             then (train_models) xDeepFM and AttentionDeepFM at the same
             width on the sparse-fused path, timed and profiled as DeepFM
             (AttentionDeepFM in PROFILED_STEPS profiled steps, each of
             which must show its forward and backward kernels once per
             block), each of their kernels launched once per step (per
             block for attention; xDeepFM's CIN forward and backward on the
             tensor-core kernels, never the f32 ones), and at 20k ids,
             batch GRAD_BATCH, f32, their first-step gradients on the card
             against the CPU's, with a planted fault per model that must be
             refused (xDeepFM's through the f32 CIN-stack backward);
  train_xdeepfm_paper  the xDeepFM paper's Criteo configuration
             (paper_config: d=10, CIN 3 x 200 maps without split, DNN
             [400, 400], batch 4096, Adam) on bench.py's workload at
             width 10, through create_model and Trainer on the default
             sparse-fused path: timed and profiled as train_models, the
             launches of its 14 steps (the bf16 stack forward and stack
             backward once a step, no cin_compress), the trainer's device
             memory freed on deletion without the cycle collector; at 20k
             ids in f32, the launches of F32_TRAIN_STEPS steps (the f32
             stack forward, three cin_compress a step for the backward's
             layers route), and at batch GRAD_BATCH the first-step
             gradients on the card against the CPU, their CIN backward by
             the layers route, with a planted fault that must be refused
             (layer 1's dW taken from the wrong hidden state);
  train_autoint  AutoInt at its Criteo widths (autoint_config: d=16, 3
             interacting layers of 2 heads of 32, no DNN) on bench.py's
             workload with 13 dense fields (F=39) at batch 16384, through
             create_model and Trainer on the default sparse-fused path in
             bf16: the launches of its 13 steps, counted from 0, exactly
             one interacting_fwd and one interacting_bwd a layer a step,
             every backward on the tiled core (39 interacting_bwd_tiled),
             no attention-block kernel, the table update's kernels run;
             traced, the counters attention.rows and
             attention.tiled_core_rows equal, B*F a layer a step;
  train_baselines  the ablation baselines lr, fm and dnn (DNN [512,256,128]
             with BatchNorm) at bench.py's full width and config on the
             sparse-fused path, each timed and profiled as train_models,
             segment_sumsq and sparse_table_adam launched once a table a
             step and fused_table_adam never, and at 20k ids per field, f32,
             each model's first-step gradients on the card against the CPU
             with a planted fault (GRAD_FAULTS) that must be refused;
  train_lazy DeepFM with training.optimizer: lazy_adam at the same width on
             logical and packed tables, timed and profiled: the lookup's
             backward (densify_rows_grad, or densify_rows_grad_packed on
             packed tables) launched once a table a step, and no
             sparse_table_adam, segment_sumsq or fused_table_adam; then 2
             steps at 20k ids per field in f32 on the card against the CPU
             (training/parity.py, the untouched rows to rtol / atol);
  serve      the port's serving path at full width: synthetic MovieLens
             at ML-100K scale, xDeepFM from
             configs/xdeepfm_movielens_cin_tuned.yaml and AttentionDeepFM
             from configs/attention_deepfm_movielens.yaml, each with seeded
             random weights saved as the best checkpoint, the `serve`
             prologue, the HTTP server on an ephemeral port, GET /health,
             POST /score and GET /recommend; the served scores are held
             against the same checkpoint on the CPU, and the model's
             kernel's launch count must have risen; the xDeepFM checkpoint
             is written packed and served under the config's logical
             tables, and then under packed ones (SERVE_LAYOUT_TOL);
  train_loop the trainer loop through the CLI's commands at the full width
             of configs/xdeepfm_movielens_cin_tuned.yaml on synthetic
             ML-100K: `train` for TRAIN_LOOP_EPOCHS epochs (its
             results.json's training_info.kernels must name
             TRAIN_LOOP_KERNELS, each launched), `evaluate` on the best
             checkpoint (the best epoch's val metrics exactly; the test
             metrics exactly where the last epoch is the best), a run of
             one epoch resumed to TRAIN_LOOP_EPOCHS whose history must
             equal the unbroken run's, and `compare` over both runs; with
             the epoch seconds split into steps and staging, examples/s
             and the val and test evaluations' seconds; the inputs of the
             resumed run's first step's segment_sumsq and
             sparse_table_adam calls (each MovieLens table's sorted pairs
             at batch 4096 and its state) are kept, and each kernel is
             held there against its plain version (TABLE_TOL), twice for
             the same bits;
  predict_recommend  `predict` over the synthetic u.data and `recommend`
             for one user on train_loop's output directory, on the card (the
             f32 CIN-stack forward launched) and with device=cpu: the same
             kept rows with scores within SERVE_TOL, the same top-K items
             (ties of equal printed score aside);
  export     `export` on train_loop's best checkpoint (f32 xDeepFM at full
             width, its val split at EXPORT_NEG_EVAL eval negatives): f32
             for the host and for the card, int8 for the card and a pinned
             batch for the card (EXPORT_ARTIFACTS), each verified by the
             command; one process that imports nothing of the package
             loads them with torch.export and scores the val split and one
             request; each is held to the card's Predictor on the same
             rows (the f32 CIN-stack forward launched) within SERVE_TOL,
             int8 within SERVE_TOL of the Predictor on the dequantized
             int8 tables and within EXPORT_QUANT_TOL of the f32 one, and
             the planted int8 faults outside both; with the artifacts' bytes,
             export and load seconds, the int8 val AUC delta; then `train`
             must refuse configs/deepfm_criteo_multichip.yaml with the JAX
             package's mesh error before building data, and a step under
             profile.debug_nans must raise FloatingPointError on a
             planted NaN;
  packed_store  `synth-packed` at configs/deepfm_criteo_packed.yaml's
             geometry (2M train rows, 26 fields of 100,000 ids), then `train`
             with that config for 1 of its 3 epochs from the memory-mapped
             store (segment_sumsq and sparse_table_adam once a table a step,
             results.json's keys, epoch seconds and examples/s), then
             `pack-data` of train_loop's MovieLens data, which must load
             back equal to the adapter's arrays;
  data_parallel  data-parallel training on torch.distributed: DP_WORLD
             rank processes on the one card, spawned with torchrun's
             environment (gloo by the backend rule: NCCL refuses two ranks
             on one device), each on its rows of DP_STEPS global batches of
             bench.py's DeepFM at full width (DP_CASES: sparse-fused and
             two-pass, logical and packed tables), the replicas' bits
             checked after every step by an all-gathered fingerprint, each
             rank's launches counted from 0 (DP_LAUNCHES), its host-clock
             steps, one profiled step and one step's collectives (host
             clock, bytes); rank 0 holds the state after DP_STEPS steps
             against one process on the same global batches (DP_LOSS_REL,
             DP_BAND); at SMALL_VOCAB ids, GRAD_BATCH rows, f32, one step
             of each path against one process (training/parity.py, share
             limit on), the two-pass first-step gradients (the sparse
             gradient exchange's) against the CPU's (grad_check), and the
             planted faults (DP_FAULTS, and the exchange without its
             gather), each of which must be refused; a world of one rank
             under NCCL through the same code path, bit for bit the
             mesh-less trainer; then `python -m torch.distributed.run
             --nproc-per-node DP_WORLD -m deepfm_tpu_torch train` on
             train_loop's MovieLens xDeepFM for TRAIN_LOOP_EPOCHS epochs
             (one checkpoint and one results.json, cin_stack_fwd and
             cin_stack_bwd launched on every rank), a one-process
             `evaluate` reproducing its metrics, and a 1-epoch run resumed
             to TRAIN_LOOP_EPOCHS with the unbroken run's history;
  model_sharded  configs/deepfm_criteo_multichip.yaml's model (bench.py's
             26 x 400,000-id DeepFM) at global batch BENCH_BATCH on four
             gloo ranks at a MS_AXES (data, model) mesh on the one card,
             every table cut into two slabs: MS_STEPS steps of each of
             MS_CASES (routed packed sparse-fused, the config as written;
             psum sparse-fused; routed two-pass; logical psum two-pass),
             the replicas checked after every step (slabs over each data
             group), each rank's launches counted from 0 (MS_LAUNCHES),
             rank 0 holding the gathered state against one process on the
             same global batches (DP_LOSS_REL, MS_BAND; the first case
             beside a row-permuted control), one profiled step and one
             step's collectives by kind (all-to-all, model-group sum and
             gather, data-group gather); at SMALL_VOCAB ids, GRAD_BATCH
             rows, f32: one step of each case and of the row-gather case
             (MS_GATHER_CASE, its kernels counted) against one process
             under training/parity.py's one-step rule, the routed cases
             with their capacities shrunk (MS_SHRUNK) against the same
             step unshrunk, the fallbacks counted, every case's
             first-step gradients against the CPU's, and the planted
             faults (MS_FAULTS), each refused by the same comparison; then on
             two ranks at (1, 2) in f32 with clip 0 (MS_EXACT_CASES) every
             slab and leaf bit for bit one process's after MS_STEPS
             full-width steps; sparse_table_adam on each slab of a (., 2)
             mesh, both layouts, on the global stream shifted by -j *
             rows, against its plain version and the whole table's update;
             and `python -m torch.distributed.run --nproc-per-node 2 -m
             deepfm_tpu_torch train` on train_loop's MovieLens xDeepFM at
             mesh.model_axis=2 (one checkpoint of whole tables, a
             one-process `evaluate` reproducing it, a resumed run the
             unbroken history);
  sharded_scoring  the serving commands on SS_WORLD gloo ranks of the one
             card over the checkpoints of the two `torchrun` trains above
             (SS_MESHES: model_sharded's at (1, 2) with the all_to_all
             lookups, data_parallel's at (2, 1)): one process's card
             `predict` of the 100,000 rows of u.data is the reference;
             `predict` on the ranks (spawned with torchrun's environment,
             cin_stack_fwd's launches counted from 0 on every rank, which
             must launch it) must write, on rank 0 alone, the reference's
             file, with scores within SERVE_TOL (max |Δ| and whether they
             are its bits printed); `python -m torch.distributed.run
             --nproc-per-node SS_WORLD -m deepfm_tpu_torch predict` at
             (1, 2) must write the same file; `recommend` at (1, 2) the
             reference's top RECOMMEND_K on rank 0 alone; `serve` under
             torchrun at (1, 2): /health's whole-model count, /score of 1
             and SS_SCORE_ROWS rows and an unknown pair (null) and
             /recommend within SERVE_TOL of one process's ScoringService,
             SS_WARM_REQUESTS warm requests timed, then SIGINT to every
             rank, after which torchrun (and so every rank) must exit 0
             within SS_STOP_S; then ring attention over the field axis on
             RING_AXES gloo ranks at RING_SHAPE, f32 (RING_TOL, the JAX
             test's) and bf16 (RING_BF16_MAX_REL), forward and the q / k /
             v gradients of sum(out²) against unsharded attention on the
             card, two planted faults (RING_FAULTS) refused by the same
             check, and the ms of a call and of a hop with the bytes a
             rank sends a call;
  kernels    one line listing every ported kernel with its launch count
             on the path that runs it (serve for the f32 CIN-stack
             forward, the xDeepFM train step for the bf16 CIN-stack
             forward and backward, xDeepFM's f32 first-step gradients for
             the f32 CIN-stack backward, the paper's xDeepFM f32
             train steps for cin_compress, the
             AttentionDeepFM train step for the attention kernels, the
             AutoInt train step for the interacting layer's kernels (their
             numbers at layers 2-3's shape and at layer 1's), the
             sparse-fused DeepFM step for segment_sumsq and
             sparse_table_adam, the two-pass step for densify_rows_grad and
             fused_table_adam, the packed two-pass step for the packed
             densify, the use_embedding_kernel step for row_gather) and its
             numbers at that path's shape, after a line with each phase's
             seconds.

The last line is {"ok": true, "device": {...}}. Without CUDA, or outside a
checkout of the repository, the script fails before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM data sheet (dense): FP32 outside the tensor cores, bf16 tensor
# cores, HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# The xDeepFM paper's Criteo configuration (paper_config), on bench.py's
# workload at field width PAPER_WIDTH
PAPER_BATCH, PAPER_WIDTH = 4096, 10
PAPER_CIN = (200, 200, 200)
# AutoInt's Criteo widths (autoint_config; Song et al., CIKM 2019,
# arXiv:1810.11921, section 5.1.3): width 16, 3 interacting layers of 2
# heads of 32, over Criteo's 13 dense and 26 sparse fields, at the batch of
# portbench's autoint-paper.train-b16k cell
AUTOINT_WIDTH, AUTOINT_HEADS, AUTOINT_DIM, AUTOINT_LAYERS = 16, 2, 64, 3
AUTOINT_DENSE = 13

# (name, B, F, D, layer_sizes, split_half, dtype)
CIN_SHAPES = [
    ("serving", 4096, 16, 16, (128, 128, 64), True, "float32"),
    ("bench_f32", 16384, 27, 16, (128, 128), True, "float32"),
    ("bench_bf16", 16384, 27, 16, (128, 128), True, "bfloat16"),
    ("ragged", 1000, 13, 16, (10, 7), True, "float32"),
    # the xDeepFM paper's CIN at its batch (paper_config), which the paper
    # xDeepFM step runs through the stack forward
    ("paper_bf16", PAPER_BATCH, 27, PAPER_WIDTH, PAPER_CIN, False, "bfloat16"),
    # the ragged shape in bf16: odd F, layer sizes off the 16-map tile and
    # a batch off the bf16 kernel's 8-sample tile (last, so that the shapes
    # above keep their seeds)
    ("ragged_bf16", 1000, 13, 16, (10, 7), True, "bfloat16"),
]
# The kernel is held against the plain version element by element,
# |kernel - plain| <= atol + rtol * |plain|, and, in bf16, by its mean
# relative error sum|kernel - plain| / sum|plain| as well.
#   f32: rtol 2e-4 / atol 1e-5, the tolerance of the port's CPU tests: the
#        same f32 sums (up to 1728 terms) taken in another order.
#   bf16: rtol 2^-7, at least one ulp of the bf16 output (an ulp of v is
#        at most 2^-7 |v|): kernel and plain round the same f32 values,
#        which differ in their last f32 bits, so a rounding may land one
#        bf16 step apart, and a hidden value that lands one step apart
#        moves the next layer by far less than one more. atol 1e-3 covers
#        outputs near zero (ReLU cut most of the sum).
#        The mean limit sits between the kernel's reading and those of two
#        controls, the plain version with its hidden-state or its outer-
#        product rounding left out: a kernel that skipped either rounding
#        flips a large share of the outputs by an ulp and is refused. The
#        phase fails if the check does not refuse both controls.
CIN_TOL = {
    "float32": {"rtol": 2e-4, "atol": 1e-5, "mean_rel": None},
    "bfloat16": {"rtol": 2.0 ** -7, "atol": 1e-3, "mean_rel": 3e-5},
}
# In bf16 the same comparison is also read, not gated, at this many other
# seeded draws of each shape: how often an element of the tensor-core
# kernel, whose own additions are not round-to-nearest, lands beyond
# CIN_TOL (the gate above stays the one draw).
CIN_SWEEP_DRAWS = 6
# Served probabilities against the same checkpoint on the CPU.
SERVE_TOL = 1e-4
# (config, the layout its seeded checkpoint is written in): the xDeepFM
# checkpoint is written packed and served under the config's logical tables
# (converted on load) and, beside it, under packed ones
SERVE_CONFIGS = (("xdeepfm_movielens_cin_tuned.yaml", "packed"),
                 ("attention_deepfm_movielens.yaml", "logical"))
# Scores of one checkpoint served with packed and with logical tables: the
# same weights and the same arithmetic, so equal but for summation order
SERVE_LAYOUT_TOL = 1e-6
# The trainer loop's config and depth, and the kernels its results.json
# must name (training_info.kernels: those whose launch counts rose)
TRAIN_LOOP_CONFIG = "xdeepfm_movielens_cin_tuned.yaml"
TRAIN_LOOP_EPOCHS = 2
TRAIN_LOOP_KERNELS = ("cin_stack_fwd", "cin_stack_bwd", "segment_sumsq",
                      "sparse_table_adam")
# history keys that are host-clock readings, left out where two runs'
# histories are compared
HISTORY_CLOCK = ("epoch_seconds", "examples_per_sec")

# (name, B, F, D, layer_sizes, split_half, dtype) of the CIN-stack backward
CIN_BWD_SHAPES = [
    ("bench_f32", 16384, 27, 16, (128, 128), True, "float32"),
    ("bench_bf16", 16384, 27, 16, (128, 128), True, "bfloat16"),
    ("ragged", 1000, 13, 16, (10, 7), True, "float32"),
    # the ragged shape in bf16 through the tensor-core kernel: odd F, maps
    # off the 16-map tile, a batch off its 8-sample tile (last, so that the
    # shapes above keep their seeds)
    ("ragged_bf16", 1000, 13, 16, (10, 7), True, "bfloat16"),
    # the MovieLens configs' CIN (configs/xdeepfm_movielens*.yaml) at their
    # batch, in f32, the default compute dtype: one backward a train step
    ("movielens_f32", 4096, 16, 16, (128, 128, 64), True, "float32"),
    # the xDeepFM paper's CIN on Criteo's 39 fields at its batch (the
    # benchmark's xdeepfm-paper configuration), in bf16: the streamed
    # layout, where the f32 count sends the f32 backward to the layers route
    ("paper_bf16", PAPER_BATCH, 39, PAPER_WIDTH, PAPER_CIN, False, "bfloat16"),
]
# (name, B, F, d, attention_dim, heads, dtype) of the attention block with
# residual + LayerNorm (bench.py's AttentionDeepFM: 4 heads of 16, d=16)
ATTN_SHAPES = [
    ("bench_bf16", 16384, 27, 16, 64, 4, "bfloat16"),
    ("bench_f32", 16384, 27, 16, 64, 4, "float32"),
    ("ragged_bf16", 1000, 27, 16, 64, 4, "bfloat16"),
    # more fields than a warp has lanes: the backward core's lanes wrap
    ("f33_bf16", 2000, 33, 16, 64, 4, "bfloat16"),
]
# A gradient kernel against its plain version, per output (dx0, each dW_i
# and db_i; out, dx and each parameter's gradient), with scale = max|plain|:
#   share_outside  the share of elements with |kernel - plain| >
#                  atol_rel * scale + rtol * |plain|, at most outside_share;
#   mean_rel_err   sum|kernel - plain| / sum|plain|, at most mean_rel;
#   share_differing  (the output in the input's dtype, bf16 only) the share
#                  of elements that differ at all, at most differ_share.
# An output whose exact gradient is 0 (the attention key bias bk: the
# softmax ignores a shift every key shares) is measured on wk's scale.
# f32: the same sums in another order (CIN rtol 2e-4 / atol 1e-5, as the
# forward; attention 1e-4 / 1e-5, tighter since nothing crosses a ReLU).
# bf16: rtol one bf16 step. Kernel and plain version round f32 values that
# differ in their last bits, so a bf16 rounding (dcomp, dall, the hidden
# state, the bf16 output) may land one step apart, and a CIN comp within
# rounding of 0 may take the other side of the ReLU mask, which moves a
# whole row of dW a little; hence a share of elements outside and the mean
# relative error. A dropped rounding point (the controls) moves every
# element by about 2^-9: half of the bf16 dx0 and 7 % of the bf16 dx
# elements differ, against 2e-4 and 6e-4 for the kernels, and the weight
# gradients' mean relative error reads 1.1e-3 to 1.9e-3, against at most
# 9e-5 for the attention kernel and, for the CIN backward, 6e-6 on the FP32
# pipes and 3.6e-4 on the tensor cores, whose remat reproduces the
# tensor-core forward's comps, so more of its ReLU masks part from the
# plain version's f32 ones (an H100, bench shapes).
CIN_BWD_TOL = {
    "float32": {"rtol": 2e-4, "atol_rel": 1e-5, "outside_share": 1e-3,
                "mean_rel": 1e-4, "differ_share": None},
    "bfloat16": {"rtol": 2.0 ** -7, "atol_rel": 1e-3, "outside_share": 1e-2,
                 "mean_rel": 1e-3, "differ_share": 1e-2},
}
# The CIN stack's layers-route backward against the plain stack backward
# at the xDeepFM paper's CIN (f32, 3 x 200 maps, B=4096, D=10), per output:
# sum|diff| / sum|plain| (mean_rel_err) and ||diff|| / ||plain||
# (norm_rel_err). About 1e-5 of a layer's 8.2M comps lie within f32
# rounding of 0, so the kernel's remat and the plain version's (cuBLAS)
# disagree on ~100 ReLU masks a layer, and each flip moves every gradient
# below it by that sample's share: up to 30 % of a dW's elements fall
# outside rtol 2e-4, the mean relative error reads 8e-5 to 3e-4 and the
# norm's 1e-4 to 1.3e-3 (an H100), so no element-wise rule holds. A real fault moves the gradient by O(1): the
# check must refuse the route with layer 1's dW taken from the wrong hidden
# state (dw_from_wrong_hidden).
ROUTE_BWD_TOL = {"mean_rel": 1e-3, "norm_rel": 1e-2}
# The bf16 CIN backward's ReLU masks, the kernel's remat against the plain
# version's f32 comps. A comp's two remats differ by the order of their f32
# sums and by roundings of the hidden state to bf16 that land a step apart
# (at most 2^-7 of an element), so a mask may part only where the plain
# comp lies within 2^-7 of its scale, the sum of the absolute products that
# form it; 2^-6 leaves room for a flip in the layer before. A wrong remat
# parts masks at comps of every size, about half of them.
MASK_FLIP_TOL = {"over_scale": 2.0 ** -6, "share": 1e-3}
# bf16 shapes whose kernel is held to the plain version under the kernel's
# own masks alone (with MASK_FLIP_TOL on the masks): at the paper's CIN
# (K = H*F = 7,800 products a comp) the two remats' masks part on more
# comps than at bench.py's shape, and the comparison under the plain
# version's own masks has no limit read at this shape yet
CIN_BWD_OWN_MASKS_UNGATED = {"paper_bf16"}
ATTN_TOL = {
    "float32": {"rtol": 1e-4, "atol_rel": 1e-5, "outside_share": 0.0,
                "mean_rel": 1e-5, "differ_share": None},
    "bfloat16": {"rtol": 2.0 ** -7, "atol_rel": 1e-3, "outside_share": 0.0,
                 "mean_rel": 5e-4, "differ_share": 1e-2},
}
# (name, B, F, d_in, attention_dim, heads, dtype) of AutoInt's interacting
# layer at the paper's Criteo widths (2 heads of 32 over F=39): layer 1
# reads the embedding width 16, layers 2-3 the attention width 64
INTERACT_SHAPES = [
    ("autoint_l1_bf16", 16384, 39, 16, 64, 2, "bfloat16"),
    ("autoint_l1_f32", 16384, 39, 16, 64, 2, "float32"),
    ("autoint_l23_bf16", 16384, 39, 64, 64, 2, "bfloat16"),
    ("autoint_l23_f32", 16384, 39, 64, 64, 2, "float32"),
]
# The interacting layer against its plain version: ATTN_TOL's rules, but a
# ReLU mask may part where ctx + res lies within rounding of 0 (kernel and
# plain version sum in other orders), which moves that element's dres by
# its whole cotangent (an f32 dx element by 6.7 % of dx's scale at B=16384,
# d=16), so a share of elements may lie outside; and the weight gradients
# sum 639K rows of cotangents that cancel, so their mean relative error
# reads up to 2.4e-4 in either dtype (an H100). Leaving out the bf16
# rounding of [dq|dk|dv|dres] must still be refused.
INTERACT_TOL = {
    "float32": {"rtol": 1e-4, "atol_rel": 1e-5, "outside_share": 1e-3,
                "mean_rel": 5e-4, "differ_share": None},
    "bfloat16": {"rtol": 2.0 ** -7, "atol_rel": 1e-3, "outside_share": 1e-4,
                 "mean_rel": 5e-4, "differ_share": 1e-2},
}

# cin_compress: at most this share of a paper layer's products on padded
# maps (maps past M, up to the plan's map tiles); at most 7 padded maps
# while M <= 256
MAX_PADDED_FMA_SHARE = 0.04
# (name, B, H, F, D, M) of the per-layer CIN kernel: the three layers of
# the xDeepFM paper's CIN at its batch (layer 0's hidden state is x0), and
# a ragged shape
CIN_LAYER_SHAPES = [
    ("paper_layer0", 4096, 27, 27, 10, 200),
    ("paper_layer1", 4096, 200, 27, 10, 200),
    ("paper_layer2", 4096, 200, 27, 10, 200),
    ("ragged", 1000, 13, 13, 10, 7),
]

# bench.py's DeepFM workload (bench.py:71-77, 91-113, 131-150)
BENCH_BATCH = 16384
BENCH_FIELDS = 26
BENCH_VOCAB = 400_000
SMALL_VOCAB = 20_000  # the card-against-CPU comparison
D = 17  # d + 1 columns of the fused width-16 table
PACK = 128 // D  # logical rows of that table per packed 128-float row
LR, L2, CLIP = 1e-3, 1e-5, 1.0  # the config defaults bench.py keeps
# Table kernels against their plain versions on the card. Both sides round
# every f32 operation on its own (csrc/table_update.cuh) and sum each run
# of pairs in stream order, so the densified gradient and the Adam moments
# must match bit for bit; p may differ where a square root differs in its
# last bit (rel 1e-6); scalar reductions (segment sums, sum p'^2) are
# summed in another order (rel 1e-5).
TABLE_TOL = {"dense_exact": True, "p_rel": 1e-6, "scalar_rel": 1e-5}
# fused_table_adam's ragged, misaligned tables: 8k + 3 elements (D = 17),
# each tensor a view this many elements past its allocation
ADAM_RAGGED_ROWS = 1003
ADAM_OFFSETS = (0, 1, 3)
# Train steps against each other (sparse-fused against two-pass on the
# card; the card against the CPU at 20k ids in f32): each leaf under the
# rule of deepfm_tpu_torch/training/parity.py (rtol 1e-5 / atol 1e-7, the
# JAX package's own tolerance for its two paths, on all but 0.1 % of a
# leaf; every element within 2 * lr per step; a table moment within one
# bf16 step), and the losses to rel 1e-6 per step.
# The card against the CPU at 20k ids (f32, TF32 off) is held in two ways.
#   First-step gradients (before any Adam step): one train-mode forward and
#   backward from the same weights on both devices, the tables' gradients
#   densified by the kernel on the card and by its plain version on the
#   CPU. Each leaf is held by two readings against its CPU gradient g: the
#   largest difference over max|g| (GRAD_MAX_REL) and the difference's
#   norm over ||g|| (GRAD_NORM_REL); a Dense bias feeding a train-mode
#   BatchNorm, whose exact gradient is 0, is measured against its layer
#   weight's gradient. At batch 16384 some activations sit within f32
#   rounding of a ReLU kink, so the devices pass a different few through,
#   and the train-mode BatchNorm spreads that over the batch. A dense leaf
#   sums over the batch and moves by about 1e-3 of its max; a table row's
#   gradient comes from one or two rows of the batch, so a flip moves it by
#   a few % of the table's max (3.3e-2 measured on an H100), while the
#   table's norm moves far less. The check must refuse three planted
#   faults, the card's gradients with one DNN weight's sign flipped, with
#   the table's largest-gradient row dropped, and with the table's gradient
#   scaled by 1.05, or the phase fails.
#   Two steps: after Adam's normalisation those gradient differences are
#   steps that differ by up to lr, so there the 0.1 % share is dropped:
#   every parameter is held to its band, the loss to rel 1e-5 per step, and
#   the table rows the batch did not touch, whose update runs through the
#   kernels with no gradient noise (decay, clip, Adam), to rtol / atol,
#   moments included. That comparison keeps f32 moments: with bf16 ones the
#   clip norm's last-bit difference flips a few moment roundings even in
#   those rows (3.3e-6 on an untouched element, measured on an H100), which
#   the bf16 checks above cover.
TRAIN_TOL = {"loss_rel": 1e-6, "cpu_loss_rel": 1e-5}
GRAD_MAX_REL = {"dense": 1e-2, "table": 0.1}
GRAD_NORM_REL = 1e-2
# Fields whose ids are all 0 (padding/OOV, a missing value) in the long-run
# timing of the table kernels: each gives one run of BENCH_BATCH pairs.
LONG_RUN_FIELDS = 2
# segment_sumsq on those long runs must take less than this (ms): a run is
# summed by its block from staged rows, not walked by one thread (0.047 ms
# on uniform ids and 21.55 ms on the long runs when one thread walked each
# run, an H100)
LONG_RUN_SEGSQ_MS = 0.5
# The densify kernels' ragged table: rows not a multiple of 4, of a tile or
# of PACK, with ids drawn in [-5, rows + 5), so some fall outside it
RAGGED_ROWS, RAGGED_PAIRS = 1_000_003, 99_999
WARMUP_STEPS, TIMED_STEPS = 3, 10
# steps of the xDeepFM paper's configuration in f32, whose launches are
# counted (after one untimed step)
F32_TRAIN_STEPS = 3
TRAIN_MODELS = ("xdeepfm", "attention_deepfm")
# kernels that must show in each of PROFILED_STEPS profiled steps of a model
PROFILE_WATCH = {"attention_deepfm": ("attn_fwd_kernel", "attn_bwd_kernel")}
PROFILED_STEPS = 3
# profiled steps taken again, at most, in place of those whose profile lost
# a device record of the step's kernels (step_profile's "whole")
PROFILE_RETRIES = 3
# torch.profiler (Kineto over CUPTI; an H100, torch 2.11) loses the device
# records of the first few kernels of a session, now and then of the last
# few, and more of them the longer the process has run. Each profile is
# padded with this many kernels of its own on either side (PAD_KERNEL, by
# torch.cuda._sleep), which take the loss and are left out of every reading
PROFILE_PAD = 256
PAD_KERNEL = "spin_kernel"
GRAD_BATCH = 1024  # their first-step gradients, card against CPU
# (leaf, factor) planted into the card's first-step gradients per model;
# the check must refuse each
GRAD_FAULTS = {"xdeepfm": ("cin.conv_1_kernel", 1.05),
               "attention_deepfm": ("attention.block_0.wo", -1.0),
               "lr": ("bias", 1.05),
               "fm": ("embedding.table_w16", 1.05),
               "dnn": ("dnn.dense_1.weight", 1.05)}
DEVICE = "cuda"  # the card the table-kernel and train phases run on
# the ablation baselines (models/baselines.py), trained at bench.py's width
BASELINE_MODELS = ("lr", "fm", "dnn")
# lazy_adam's table layouts, and the densify kernel each one's lookup
# backward launches
LAZY_DENSIFY = {"logical": "densify_rows_grad",
                "packed": "densify_rows_grad_packed"}
# configs/deepfm_criteo_packed.yaml's store: its data_dir names 2M train
# rows; synth-packed's default 26 fields of 100,000 ids
PACKED_STORE_CONFIG = "deepfm_criteo_packed.yaml"
PACKED_STORE_ROWS = 2_000_000
PACKED_STORE_EPOCHS = 1  # cut from the config's 3
RESULTS_KEYS = {"run_id", "timestamp", "config", "val_metrics",
                "test_metrics", "training_info", "history"}
RECOMMEND_USER, RECOMMEND_K = 20, 10
# the export phase: its val split takes 99 eval negatives a user (cut from
# the config's 999, so the command's CPU reference scores it in seconds),
# its pinned artifact the config's batch. The int8 artifact is held within
# SERVE_TOL to the card's Predictor with the tables replaced by their
# dequantized int8 rows (the same function by another route), and within
# EXPORT_QUANT_TOL, a bound on quality, to the f32 Predictor; the limit lies
# between the sound reading and those of the planted faults of the int8
# lookup (EXPORT_INT8_FAULTS), which must each exceed both limits (PERF.md
# section 6, PR 16)
EXPORT_NEG_EVAL = 99
EXPORT_PINNED = 4096
EXPORT_QUANT_TOL = 0.04
# planted faults of an int8 lookup, as dequantized rows from (q, scale):
# each row scaled by the row before's scale, and every row read as zeros
EXPORT_INT8_FAULTS = ("scales_rolled", "rows_zeroed")
# (name, --platforms, --batch-size, --quantize) of the exported artifacts
EXPORT_ARTIFACTS = (("f32_cpu", "cpu", None, None),
                    ("f32_cuda", "cuda", None, None),
                    ("int8_cuda", "cuda", None, "int8"),
                    ("pinned_cuda", "cuda", EXPORT_PINNED, None))
DP_WORLD = 2  # ranks on the one card (gloo: NCCL refuses two on one device)
DP_STEPS = 5
DP_CASES = (("sparse_fused", "logical"), ("sparse_fused", "packed"),
            ("two_pass", "logical"), ("two_pass", "packed"))
# a rank's launches in DP_STEPS steps of bench.py's DeepFM (one table)
DP_LAUNCHES = {
    (path, layout): {
        "segment_sumsq": DP_STEPS * (path == "sparse_fused"),
        "sparse_table_adam": DP_STEPS * (path == "sparse_fused"),
        "densify_rows_grad": DP_STEPS * ((path, layout) == (
            "two_pass", "logical")),
        "densify_rows_grad_packed": DP_STEPS * ((path, layout) == (
            "two_pass", "packed")),
        "fused_table_adam": DP_STEPS * (path == "two_pass"),
    } for path, layout in DP_CASES}
# two ranks against one process after DP_STEPS bf16 Adam steps, a sanity
# bound (the JAX package reads ~1e-3 for data parallelism; the tight
# check is one f32 step, dp_checks): the losses within DP_LOSS_REL, every
# parameter element within training/parity.py's band 2 * lr * steps (the
# moments follow the gradient; the BatchNorm statistics are read, not
# gated: state_diff)
DP_LOSS_REL = 1e-2
DP_BAND = 2 * LR * DP_STEPS
# planted fault -> the check that must refuse it
DP_FAULTS = {"skip_reduce": "replicas", "skip_pair_gather": "one_process",
             "local_bn": "one_process"}
DP_RANK_TIMEOUT = 600  # seconds a rank run or a torchrun launch may take
MULTICHIP_CONFIG = "deepfm_criteo_multichip.yaml"
MULTICHIP_REFUSAL = "mesh 0x2 != 1 available devices"
# the model_sharded phase: configs/deepfm_criteo_multichip.yaml's model
# (bench.py's 26 x 400,000-id DeepFM) on a (2, 2) mesh of 4 ranks on the
# one card (gloo by the backend rule), MS_STEPS steps of each case
MS_AXES = (2, 2)
MS_STEPS = 3
# (case, table layout, embedding strategy, fused_backward): the config as
# written (routed sparse-fused), the psum strategy's replicated
# sparse-fused branch, two-pass with the routed exchange, and logical
# tables under psum two-pass
MS_CASES = (("routed_packed", "packed", "all_to_all", True),
            ("psum_sparse_fused", "packed", "psum", True),
            ("routed_two_pass", "packed", "all_to_all", False),
            ("psum_two_pass_logical", "logical", "psum", False))
# a rank's launches in MS_STEPS steps of each case (one table; every
# kernel on the rank's slab)
MS_LAUNCHES = {
    case: {"segment_sumsq": MS_STEPS * fused,
           "sparse_table_adam": MS_STEPS * fused,
           "densify_rows_grad": MS_STEPS * (not fused and layout == "logical"),
           "densify_rows_grad_packed": MS_STEPS * (not fused
                                                   and layout == "packed"),
           "fused_table_adam": MS_STEPS * (not fused)}
    for case, layout, _, fused in MS_CASES}
MS_BAND = 2 * LR * MS_STEPS
# the capacity factors shrunk so that the routed paths' buckets overflow
# (parallel/embedding_shard.py's constants)
MS_SHRUNK = {"ALL_TO_ALL_CAPACITY": 0.5, "ROUTED_EXCHANGE_CAPACITY": 0.25,
             "ROUTE_PAIRS_CAPACITY": 0.25}
# planted fault -> the case it runs on; each must be refused by the
# replica check or the one-step comparison with one process
MS_FAULTS = {"world_reduce": "psum_sparse_fused",
             "no_shift": "psum_sparse_fused",
             "peer_rows": "psum_two_pass_logical"}
# the row-gather kernel on the slabs (pallas.use_embedding_kernel: logical
# tables, two-pass, row_gather the all-to-all lookup's local gather), run
# at SMALL_VOCAB beside the MS_CASES there, with the kernels its step must
# launch
MS_GATHER_CASE = ("routed_row_gather", "logical", "all_to_all", False)
MS_GATHER_LAUNCHES = ("row_gather", "densify_rows_grad", "fused_table_adam")
# the cases held bit for bit to one process at (1, 2), f32, clip 0
MS_EXACT_CASES = ("psum_sparse_fused", "routed_two_pass")
# the sharded_scoring phase: the serving commands on SS_WORLD gloo ranks
# of the one card. Mesh -> (the run of dp_train_loop whose checkpoint it
# scores, its overrides)
SS_WORLD = 2
SS_MESHES = {"a2a_1x2": ("ms_loop", ("mesh.model_axis=2",
                                     "mesh.embedding_strategy=all_to_all")),
             "dp_2x1": ("dp_loop", ())}
SS_SCORE_ROWS = 100  # the rows of the multi-row /score request
SS_WARM_REQUESTS = 3
SS_SERVE_START_S = 300  # seconds the ranks may take to answer /health
SS_STOP_S = 30  # seconds every serve rank has to exit after SIGINT
# ring attention over the field axis on RING_AXES gloo ranks: B, F (F / 4
# fields a rank), H, Dh; f32 held to unsharded attention with the JAX
# test's tolerances (rtol, atol), bf16 by max |Δ| over max |reference|
RING_AXES = (1, 4)
RING_SHAPE = (2048, 256, 4, 16)
RING_TOL = {"out": (2e-5, 2e-6), "grads": (2e-4, 2e-5)}
RING_BF16_MAX_REL = 3e-2
RING_REPS = 5
# planted faults the f32 check must refuse: the last hop skipped (the last
# step sees the previous block again), and the hop sent the other way
# around the ring under the true hop's backward (every query still meets
# every block once, so the forward is right; each block's gradient goes to
# the wrong rank)
RING_FAULTS = ("skip_last_hop", "wrong_way")
# the (data, model) mesh of each spawned part (default: data only)
PART_AXES = {"ms_steps": MS_AXES, "ms_exact": (1, 2), "ss_ring": RING_AXES}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build() -> str:
    from deepfm_tpu_torch.native import sampler
    from deepfm_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    logs = build.build()
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler_lib = sampler.build()  # the native negative sampler (g++)
    sampler_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    gpu = smi.stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    ptxas = {
        src: [line.strip() for line in log.splitlines()
              if "Used" in line or "spill" in line or "Compiling entry" in line]
        for src, log in logs.items()
    }
    for src in ("attention_block.cu", "attention_bwd.cu", "cin_compress.cu",
                "cin_stack_fwd.cu", "cin_stack_bwd.cu",
                "cin_stack_fwd_mma.cu", "cin_stack_bwd_mma.cu",
                "fused_table_adam.cu", "row_gather.cu",
                "sparse_table_adam.cu"):
        for line in ptxas.get(src, []):
            print(f"ptxas {src}: {line}", flush=True)
    emit({"phase": "build", "seconds": seconds,
          "sources": sorted(logs), "gpu": gpu, "ptxas": ptxas,
          "native_sampler": sampler_lib.name,
          "native_sampler_seconds": sampler_s})
    return gpu


def cin_library(x0, weights, biases, layer_sizes, split_half):
    """Yardstick only, never called by the port: the same function as an
    einsum outer product plus torch.matmul per layer, in x0's dtype."""
    import torch

    from deepfm_tpu_torch.ops.cin import cin_layer_sizes

    direct_sizes, _ = cin_layer_sizes(layer_sizes, split_half)
    n = len(layer_sizes)
    bsz, f, d = x0.shape
    hidden, outs = x0, []
    for i in range(n):
        outer = torch.einsum("bhd,bfd->bhfd", hidden, x0).reshape(bsz, -1, d)
        comp = torch.relu(
            torch.matmul(weights[i].to(x0.dtype), outer)
            + biases[i].to(x0.dtype)[:, None]
        )
        if split_half and i < n - 1:
            direct, hidden = comp[:, : direct_sizes[i]], comp[:, direct_sizes[i]:]
        else:
            direct = hidden = comp
        outs.append(direct.float().sum(dim=2))
    return torch.cat(outs, dim=1).to(x0.dtype)


def cin_control(x0, weights, biases, layer_sizes, split_half, skip):
    """The plain bf16 version with one rounding point left out, ``skip`` =
    "hidden" (the hidden state handed on in f32) or "outer" (the outer
    product used unrounded): what a kernel that dropped that rounding
    would return. The bf16 check must refuse it."""
    import torch

    from deepfm_tpu_torch.ops.cin import cin_compress, cin_layer_sizes

    def rnd(t):
        return t.to(torch.bfloat16).float()

    direct_sizes, _ = cin_layer_sizes(layer_sizes, split_half)
    n = len(layer_sizes)
    x = x0.float()
    hidden, outs = x, []
    for i in range(n):
        comp = torch.relu(cin_compress(
            hidden, x, rnd(weights[i].float()), biases[i].float(),
            (lambda t: t) if skip == "outer" else rnd,
        ))
        if split_half and i < n - 1:
            direct, hidden = comp[:, : direct_sizes[i]], comp[:, direct_sizes[i]:]
        else:
            direct = hidden = comp
        if skip != "hidden":
            hidden = rnd(hidden)
        outs.append(direct.sum(dim=2))
    return torch.cat(outs, dim=1).to(x0.dtype)


def compare(got, want, tol) -> dict:
    """Error statistics of ``got`` against ``want`` and whether they pass
    ``tol`` (see CIN_TOL)."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    allowed = tol["atol"] + tol["rtol"] * want.abs()
    stats = {
        "max_abs_err": err.max().item(),
        "max_rel_err": (err / want.abs().clamp_min(1e-3)).max().item(),
        "max_err_over_tol": (err / allowed).max().item(),
        "mean_rel_err": (err.sum() / want.abs().sum().clamp_min(1e-30)).item(),
        "share_differing": (err > 0).float().mean().item(),
    }
    ok = bool(torch.isfinite(got).all()) and stats["max_err_over_tol"] <= 1.0
    if tol["mean_rel"] is not None:
        ok = ok and stats["mean_rel_err"] <= tol["mean_rel"]
    stats["ok"] = ok
    return stats


def cin_bound(bsz, f, d, layer_sizes, split_half, bf16):
    """(bound_ms, bound_by, flops): the larger of the operations over the
    peak rate for the operand type and the bytes (x0, weights, biases and
    output, each once) over the memory rate."""
    from deepfm_tpu_torch.ops.cin import cin_layer_sizes

    direct_sizes, next_sizes = cin_layer_sizes(layer_sizes, split_half)
    es = 2 if bf16 else 4
    flops, nbytes, h = 0, bsz * f * d * es, f
    for i, m in enumerate(layer_sizes):
        flops += 2 * bsz * m * h * f * d + bsz * h * f * d
        nbytes += m * h * f * es + 4 * m
        h = next_sizes[i]
    nbytes += bsz * sum(direct_sizes) * es
    t_ops = flops / (PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations", flops
    return 1e3 * t_bytes, "bytes", flops


def cin_inputs(gen, bsz, f, d, layer_sizes, split_half, dtype):
    """x0 (B, F, D) ~ N(0, 1) in ``dtype`` and f32 weights and biases
    uniform in +-(H*F)^-1/2 (the layers' init bound), on gen's device."""
    import torch

    from deepfm_tpu_torch.ops.cin import cin_layer_sizes

    dev = gen.device
    x0 = torch.randn(bsz, f, d, generator=gen, device=dev).to(dtype)
    _, next_sizes = cin_layer_sizes(layer_sizes, split_half)
    ws, bs, h = [], [], f
    for i, m in enumerate(layer_sizes):
        bound = (h * f) ** -0.5
        ws.append((torch.rand(m, h * f, generator=gen, device=dev) * 2 - 1) * bound)
        bs.append((torch.rand(m, generator=gen, device=dev) * 2 - 1) * bound)
        h = next_sizes[i]
    return x0, ws, bs


def phase_cin_stack() -> dict:
    import torch

    from deepfm_tpu_torch.ops.kernels.cin_stack import (
        cin_stack_forward,
        cin_stack_mma,
        cin_stack_plain,
        forward_plan,
        fp32_forward_plan,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results, failures = {}, []
    for k, (name, bsz, f, d, layers, split, dtype) in enumerate(CIN_SHAPES):
        gen = torch.Generator(device=dev).manual_seed(1000 + k)
        dt = getattr(torch, dtype)
        bf16 = dt == torch.bfloat16
        tol = CIN_TOL[dtype]
        x0, ws, bs = cin_inputs(gen, bsz, f, d, layers, split, dt)

        def kernel():
            return cin_stack_forward(x0, ws, bs, layers, split, bf16_operands=True)

        def plain():
            return cin_stack_plain(x0, ws, bs, layers, split, bf16_operands=True)

        def library():
            return cin_library(x0, ws, bs, layers, split)

        # bf16 takes the tensor-core kernel, f32 the FP32-pipe one: each
        # call here must launch its kernel once and the other not at all
        counter = cin_stack_mma if bf16 else cin_stack_forward
        other = cin_stack_forward if bf16 else cin_stack_mma
        before = (counter.launches, other.launches)
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        launched = (counter.launches - before[0], other.launches - before[1])
        same_bits = bool(torch.equal(got, again))
        del again
        want = plain()
        stats = compare(got, want, tol)
        if not stats["ok"]:
            failures.append(f"{name}: kernel outside tolerance {tol}: {stats}")
        if not same_bits or launched != (2, 0):
            failures.append(f"{name}: two launches gave other bits "
                            f"({not same_bits}) or the launches went "
                            f"elsewhere: {launched}")
        controls = {}
        if bf16:
            for skip in ("hidden", "outer"):
                ctl = compare(cin_control(x0, ws, bs, layers, split, skip), want, tol)
                controls[f"no_{skip}_round"] = ctl
                if ctl["ok"]:
                    failures.append(
                        f"{name}: the bf16 check passes a kernel without "
                        f"{skip} rounding: {ctl}")
        sweep = []
        for draw in range(CIN_SWEEP_DRAWS if bf16 else 0):
            g = torch.Generator(device=dev).manual_seed(2000 + 10 * k + draw)
            xd, wd, bd = cin_inputs(g, bsz, f, d, layers, split, dt)
            st = compare(
                cin_stack_forward(xd, wd, bd, layers, split, bf16_operands=True),
                cin_stack_plain(xd, wd, bd, layers, split, bf16_operands=True),
                tol)
            sweep.append({key: st[key] for key in (
                "max_err_over_tol", "mean_rel_err", "share_differing", "ok")})
            del xd, wd, bd
        big = bsz >= 16384
        ms = time_ms(kernel, reps=10 if big else 20)
        plain_ms = time_ms(plain, reps=3 if big else 10, warmup=1)
        library_ms = time_ms(library, reps=3 if big else 10, warmup=1)
        bound_ms, bound_by, flops = cin_bound(bsz, f, d, layers, split, bf16)
        rec = {
            "phase": "cin_stack", "shape": name, "B": bsz, "F": f, "D": d,
            "layers": list(layers), "split_half": split, "dtype": dtype,
            "kernel": "cin_stack_fwd_mma" if bf16 else "cin_stack_fwd",
            "tile": (forward_plan(bsz, f, d, layers, split) if bf16
                     else fp32_forward_plan(bsz, f, d, layers, split, sms)
                     )._asdict(),
            **stats, "tol": tol, "controls": controls,
            "same_bits": same_bits, "launched": launched,
            "seed_sweep": sweep,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "below_library": ms < library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
            "tflops": flops / (ms * 1e-3) / 1e12,
            "launches": counter.launches,
        }
        emit(rec)
        results[name] = rec
        del x0, ws, bs, got, want
        torch.cuda.empty_cache()
    if failures:
        fail("; ".join(failures))
    return results


def grad_compare(got: dict, want: dict, tol: dict, low: str,
                 ref_of: dict | None = None) -> dict:
    """Per output (name -> tensor) the error statistics of ``got`` against
    ``want`` and whether they pass ``tol`` (see CIN_BWD_TOL); ``low`` names
    the output in the input's dtype, ``ref_of`` maps an output whose exact
    value is 0 to the output whose scale it is measured on."""
    import torch

    outs = {}
    for name, w in want.items():
        a, w = got[name].float(), w.float()
        ref = want[(ref_of or {}).get(name, name)].float().abs()
        err = (a - w).abs()
        scale = ref.max().clamp_min(1e-30)
        s = {
            "max_abs_err": err.max().item(),
            "max_err_over_scale": (err.max() / scale).item(),
            "share_outside": (err > tol["atol_rel"] * scale
                              + tol["rtol"] * w.abs()).float().mean().item(),
            "mean_rel_err": (err.mean() / ref.mean().clamp_min(1e-30)).item(),
            "norm_rel_err": (err.norm() / ref.norm().clamp_min(1e-30)).item(),
            "share_differing": (err > 0).float().mean().item(),
        }
        ok = (bool(torch.isfinite(a).all())
              and s["share_outside"] <= tol["outside_share"]
              and s["mean_rel_err"] <= tol["mean_rel"])
        if name == low and tol["differ_share"] is not None:
            ok = ok and s["share_differing"] <= tol["differ_share"]
        outs[name] = {**s, "ok": ok}
    return {"outputs": outs, "ok": all(o["ok"] for o in outs.values())}


def cin_bwd_bound(bsz, f, d, layer_sizes, split_half, bf16):
    """(bound_ms, bound_by, flops) of the CIN-stack backward: per layer the
    remat, dW and A = W^T dcomp products (2 * B*D*M*H*F operations each),
    the outer product formed for the remat and dW and the two group sums;
    bytes: x0, g, weights and biases read, dx0, dW and db written."""
    from deepfm_tpu_torch.ops.cin import cin_layer_sizes

    direct_sizes, next_sizes = cin_layer_sizes(layer_sizes, split_half)
    es = 2 if bf16 else 4
    flops, h = 0, f
    nbytes = 2 * bsz * f * d * es + 4 * bsz * sum(direct_sizes)
    for i, m in enumerate(layer_sizes):
        flops += 3 * 2 * bsz * d * m * h * f + 2 * bsz * h * f * d \
            + 2 * 2 * bsz * h * f * d
        nbytes += m * h * f * (es + 4) + 2 * 4 * m
        h = next_sizes[i]
    t_ops = flops / (PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations", flops
    return 1e3 * t_bytes, "bytes", flops


def kernel_masks(x0, ws, bs, g, layers, split) -> list:
    """Each layer's ReLU mask (B, M, D) as the bf16 tile kernel's remat
    took it, read from the dW step's workspace: a map handed on to the next
    layer by its hidden state there (> 0); any other (the last layer's, and
    with split-half the pooled ones) by its dcomp (not 0), whose cotangent
    is g's alone, drawn from a normal law. (A handed-on map's dcomp is 0
    also where all of the next layer's masks are off, so it does not show
    the mask.)"""
    import torch

    from deepfm_tpu_torch.ops.cin import cin_layer_sizes
    from deepfm_tpu_torch.ops.kernels import cin_stack

    work = {}
    cin_stack._cin_stack_bwd_mma_cuda(x0, ws, bs, g, layers, split,
                                      workspace=work)
    bsz, _, d = x0.shape
    direct, nxt = cin_layer_sizes(layers, split)

    def rows(t, sizes):
        return torch.split(t[:sum(sizes), :bsz * d].reshape(-1, bsz, d),
                           list(sizes))

    dcomp = rows(work["dcomp"], layers)
    hid = rows(work["hid"], nxt[:-1]) if len(layers) > 1 else ()
    masks = []
    for i in range(len(layers)):
        mask = dcomp[i] != 0
        if i < len(layers) - 1:
            mask = torch.cat([mask[:direct[i]], hid[i] > 0]) if split \
                else hid[i] > 0
        masks.append(mask.permute(1, 0, 2))
    return masks


def mask_flips(x0, ws, bs, layers, split, masks) -> dict:
    """Per layer, where ``masks`` part from the plain bf16 remat's comp >
    0: their share of the layer's comps and the largest |comp| there over
    its scale (sum of |w| * |op(hid) x0| over the products that form it),
    and whether both pass MASK_FLIP_TOL."""
    import torch

    from deepfm_tpu_torch.ops.cin import cin_compress, cin_layer_sizes

    def op(t):
        return t.to(torch.bfloat16).float()

    direct_sizes, _ = cin_layer_sizes(layers, split)
    x = x0.float()
    hidden, out = x, []
    for i, m in enumerate(layers):
        w = op(ws[i].float())
        pre = cin_compress(op(hidden), x, w, bs[i].float(), op)
        scale = cin_compress(op(hidden).abs(), x.abs(), w.abs(),
                             torch.zeros_like(bs[i]), op)
        flip = masks[i] != (pre > 0)
        over = (pre.abs() / scale.clamp_min(1e-30))[flip]
        out.append({"share": flip.float().mean().item(),
                    "count": int(flip.sum()),
                    "max_over_scale": over.max().item() if over.numel() else 0.0})
        comp = torch.relu(pre)
        hidden = comp[:, direct_sizes[i]:] if split and i < len(layers) - 1 \
            else comp
        del pre, scale, flip
    ok = all(o["share"] <= MASK_FLIP_TOL["share"]
             and o["max_over_scale"] <= MASK_FLIP_TOL["over_scale"] for o in out)
    return {"layers": out, "ok": ok, "tol": MASK_FLIP_TOL}


def cin_grads_named(res) -> dict:
    dx0, dws, dbs = res
    return {"dx0": dx0, **{f"dW{i}": t for i, t in enumerate(dws)},
            **{f"db{i}": t for i, t in enumerate(dbs)}}


def phase_cin_stack_bwd() -> dict:
    import torch

    from deepfm_tpu_torch.ops.cin import cin_layer_sizes
    from deepfm_tpu_torch.ops.kernels.cin_stack import (
        bwd_mma_attributes,
        cin_stack_backward,
        cin_stack_backward_layers,
        cin_stack_backward_plain,
        cin_stack_bwd_mma,
        cin_stack_plain,
        fp32_backward_plan,
        mma_backward_plan,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results, failures = {}, []
    for k, (name, bsz, f, d, layers, split, dtype) in enumerate(CIN_BWD_SHAPES):
        gen = torch.Generator(device=dev).manual_seed(2000 + k)
        dt = getattr(torch, dtype)
        bf16 = dt == torch.bfloat16
        tol = CIN_BWD_TOL[dtype]
        x0, ws, bs = cin_inputs(gen, bsz, f, d, layers, split, dt)
        direct_sizes, _ = cin_layer_sizes(layers, split)
        g = torch.randn(bsz, sum(direct_sizes), generator=gen, device=dev)
        n = len(layers)

        def kernel():
            return cin_stack_backward(x0, ws, bs, g, layers, split, True)

        def plain(**kw):
            return cin_stack_backward_plain(x0, ws, bs, g, layers, split,
                                            True, **kw)

        def library():
            leaves = [t.detach().requires_grad_() for t in (x0, *ws, *bs)]
            out = cin_stack_plain(leaves[0], leaves[1:1 + n], leaves[1 + n:],
                                  layers, split, True)
            return torch.autograd.grad(out, leaves, g.to(out.dtype))

        # bf16 takes the tensor-core kernel, f32 the FP32-pipe one: each
        # call here must launch its kernel once and the other not at all
        counter = cin_stack_bwd_mma if bf16 else cin_stack_backward
        other = cin_stack_backward if bf16 else cin_stack_bwd_mma
        before = (counter.launches, other.launches)
        got, again = cin_grads_named(kernel()), cin_grads_named(kernel())
        torch.cuda.synchronize()
        launched = (counter.launches - before[0], other.launches - before[1])
        want = cin_grads_named(plain())
        same_bits = all(torch.equal(got[o], again[o]) for o in got)
        cmp = grad_compare(got, want, tol, "dx0")
        gated = not (bf16 and name in CIN_BWD_OWN_MASKS_UNGATED)
        failed_before = len(failures)
        if not same_bits or (gated and not cmp["ok"]):
            failures.append(f"{name}: kernel outside tolerance {tol} or not "
                            f"repeatable ({same_bits}): {cmp}")
        if launched != (2, 0):
            failures.append(f"{name}: the launches went elsewhere: {launched}")
        controls, masked = {}, {}
        if bf16:
            ctl = grad_compare(cin_grads_named(plain(dcomp_round=False)),
                               want, tol, "dx0")
            controls["no_dcomp_round"] = ctl
            if ctl["ok"]:
                failures.append(f"{name}: the bf16 check passes a kernel "
                                f"without the dcomp rounding: {ctl}")
            # the plain version under the kernel's own ReLU masks: the two
            # then differ by their arithmetic alone; the masks themselves
            # may part from the plain version's only within rounding of 0
            masks = kernel_masks(x0, ws, bs, g, layers, split)
            flips = mask_flips(x0, ws, bs, layers, split, masks)
            want_m = cin_grads_named(plain(masks=masks))
            cmp_m = grad_compare(got, want_m, tol, "dx0")
            ctl_m = grad_compare(
                cin_grads_named(plain(masks=masks, dcomp_round=False)),
                want_m, tol, "dx0")
            # which is the nearer to the backward without a rounding point
            # (f32) under the kernel's masks: the kernel or the plain version
            exact = cin_grads_named(cin_stack_backward_plain(
                x0.float(), ws, bs, g, layers, split, masks=masks))
            nearer = {who: {o: v["mean_rel_err"] for o, v in grad_compare(
                res, exact, tol, "dx0")["outputs"].items()}
                for who, res in (("kernel", got), ("plain", want),
                                 ("plain_under_kernel_masks", want_m))}
            masked = {"vs_plain_under_kernel_masks": cmp_m,
                      "mask_flips": flips, "no_dcomp_round": ctl_m,
                      "mean_rel_vs_f32_under_kernel_masks": nearer}
            if not (cmp_m["ok"] and flips["ok"]):
                failures.append(f"{name}: under the kernel's masks, kernel "
                                f"outside tolerance {tol} ({cmp_m}) or masks "
                                f"parting beyond rounding ({flips})")
            if ctl_m["ok"]:
                failures.append(f"{name}: under the kernel's masks, the check "
                                f"passes a plain version without the dcomp "
                                f"rounding: {ctl_m}")
            del masks, want_m, exact
        del got, again, want
        big = bsz >= 16384
        ms = time_ms(kernel, reps=5 if big else 20)
        plain_ms = time_ms(plain, reps=3 if big else 10, warmup=1)
        library_ms = time_ms(library, reps=3 if big else 10, warmup=1)
        bound_ms, bound_by, flops = cin_bwd_bound(bsz, f, d, layers, split, bf16)
        plan = (mma_backward_plan(bsz, f, d, layers, split) if bf16
                else fp32_backward_plan(bsz, f, d, layers, split, sms))
        extra = {}
        if bf16:
            extra["compiled"] = bwd_mma_attributes(x0, plan)
            if plan.streamed:
                extra["layers_ms"] = time_ms(
                    lambda: cin_stack_backward_layers(x0, ws, bs, g, layers,
                                                      split), reps=10)
                extra["layers_route"] = ("cin_stack_backward_layers: "
                                         "cin_compress, f32 cuBLAS products")
        plan = plan._asdict()
        rec = {
            "phase": "cin_stack_bwd", "shape": name, "B": bsz, "F": f, "D": d,
            "layers": list(layers), "split_half": split, "dtype": dtype,
            "kernel": "cin_stack_bwd_mma" if bf16 else "cin_stack_bwd",
            "plan": plan, "launched": launched,
            **cmp, "own_masks_ok": cmp["ok"], "own_masks_gated": gated,
            "ok": len(failures) == failed_before, "same_bits": same_bits,
            "tol": tol, "controls": controls, "under_kernel_masks": masked,
            "max_abs_err": max(o["max_abs_err"] for o in cmp["outputs"].values()),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "autograd through cin_stack_plain (forward + backward)",
            "below_library": ms < library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
            "tflops": flops / (ms * 1e-3) / 1e12,
            "breakdown": launch_breakdown(kernel),
            "launches": counter.launches, **extra,
        }
        emit(rec)
        results[name] = rec
        del x0, ws, bs, g
        torch.cuda.empty_cache()
    if failures:
        fail("; ".join(failures))
    return results


def cin_layer_bound(bsz, h, f, d, m):
    """(bound_ms, bound_by, flops) of one CIN layer in f32: the products of
    the contraction (2 * B*D*M*H*F) and the outer product (B*D*H*F) over the
    FP32 rate; bytes: hidden, x0, W and b read, the output written."""
    flops = 2 * bsz * m * h * f * d + bsz * h * f * d
    nbytes = 4 * (bsz * h * d + bsz * f * d + m * h * f + m + bsz * m * d)
    t_ops = flops / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations", flops
    return 1e3 * t_bytes, "bytes", flops


def phase_cin_compress() -> dict:
    """The per-layer CIN kernel against its plain version, timed; then the
    CIN stack's "layers" route against the stack backward kernel and
    against the plain versions, with the launches that show the route."""
    import torch

    from deepfm_tpu_torch.ops.cin import cin_layer_sizes, cin_outer
    from deepfm_tpu_torch.ops.kernels import build
    from deepfm_tpu_torch.ops.kernels.cin import (
        CHUNK,
        STAGES,
        cin_compress_layer,
        cin_compress_plain,
        compress_attributes,
        compress_plan,
        x0_resident,
    )
    from deepfm_tpu_torch.ops.kernels.cin_stack import (
        cin_stack_backward,
        cin_stack_backward_layers,
        cin_stack_backward_plain,
        cin_stack_forward,
        cin_stack_plain,
        stack_route,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    tol = CIN_TOL["float32"]
    results, failures = {}, []
    for k, (name, bsz, h, f, d, m) in enumerate(CIN_LAYER_SHAPES):
        gen = torch.Generator(device=dev).manual_seed(4000 + k)
        x0 = torch.randn(bsz, f, d, generator=gen, device=dev)
        hid = x0 if h == f and name.endswith("0") else torch.relu(
            torch.randn(bsz, h, d, generator=gen, device=dev))
        bound = (h * f) ** -0.5
        w = (torch.rand(m, h * f, generator=gen, device=dev) * 2 - 1) * bound
        b = (torch.rand(m, generator=gen, device=dev) * 2 - 1) * bound

        def kernel():
            return cin_compress_layer(hid, x0, w, b)

        def library():
            return torch.matmul(w, cin_outer(hid, x0)) + b[:, None]

        got, again = kernel(), kernel()
        want = cin_compress_plain(hid, x0, w, b)
        stats = compare(got, want, tol)
        same_bits = bool(torch.equal(got, again))
        if not (stats["ok"] and same_bits):
            failures.append(f"{name}: kernel outside tolerance {tol} or not "
                            f"repeatable ({same_bits}): {stats}")
        del got, again, want
        bound_ms, bound_by, flops = cin_layer_bound(bsz, h, f, d, m)
        ms = time_ms(kernel, reps=20)
        plan = compress_plan(bsz, f, d, m, sms=build.sm_count(x0))
        attrs = compress_attributes(x0, plan)
        padded_share = plan.padded_maps / (plan.map_tiles * plan.tile_maps)
        field_blocks = -(-f // CHUNK)  # a chunk: one hidden row, a field block
        if attrs["blocks_per_sm"] != plan.blocks_per_sm or (
                m <= 256 and plan.padded_maps > 7) or (
                name.startswith("paper") and padded_share > MAX_PADDED_FMA_SHARE):
            failures.append(f"{name}: plan {plan} against the compiled "
                            f"kernel {attrs}, padded share {padded_share}")
        rec = {
            "phase": "cin_compress", "shape": name, "B": bsz, "H": h, "F": f,
            "D": d, "M": m, "dtype": "float32", **stats, "tol": tol,
            "same_bits": same_bits, "ms": ms,
            "call_split": call_split(kernel, device_reps=20, host_reps=20),
            "plan": {**plan._asdict(), "tile_cols": plan.tile_cols,
                     "stages": STAGES,
                     "chunk_fields": -(-f // field_blocks),
                     "x0_resident": x0_resident(f),
                     "grid": plan.grid, "waves": plan.waves,
                     "wave_fill": plan.wave_fill,
                     "padded_fma_share": padded_share},
            "compiled": attrs,
            "plain_ms": time_ms(lambda: cin_compress_plain(hid, x0, w, b), reps=5),
            "library_ms": time_ms(library, reps=5),
            "library": "the outer product materialised plus one torch.matmul",
            "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
            "tflops": flops / (ms * 1e-3) / 1e12,
        }
        emit(rec)
        results[name] = rec
        del x0, hid, w, b
    torch.cuda.empty_cache()

    def route_check(label, launches, expect, cmp):
        ok = cmp["ok"] and all(launches[kn] == n for kn, n in expect.items())
        rec = {"phase": "cin_layers_route", "check": label, "launches": launches,
               "launches_expected": expect, **cmp, "ok": ok}
        emit(rec)
        results[label] = rec
        if not ok:
            failures.append(f"{label}: {rec}")

    bwd_tol = CIN_BWD_TOL["float32"]
    # (a) the layers route's backward against the stack backward kernel at
    # bench.py's f32 CIN shape, where both run: two implementations
    gen = torch.Generator(device=dev).manual_seed(4100)
    layers, split = (128, 128), True
    x0, ws, bs = cin_inputs(gen, BENCH_BATCH, 27, 16, layers, split, torch.float32)
    g = torch.randn(BENCH_BATCH, sum(cin_layer_sizes(layers, split)[0]),
                    generator=gen, device=dev)
    reset_counts()
    got = cin_grads_named(cin_stack_backward_layers(x0, ws, bs, g, layers, split))
    torch.cuda.synchronize()
    launches = read_counts()
    reset_counts()
    want = cin_grads_named(cin_stack_backward(x0, ws, bs, g, layers, split))
    torch.cuda.synchronize()
    stack_launches = read_counts()
    cmp = grad_compare(got, want, bwd_tol, "dx0")
    cmp["stack_kernel_launches"] = {k: stack_launches[k] for k in
                                    ("cin_stack_bwd", "cin_compress")}
    cmp["ok"] = cmp["ok"] and stack_launches["cin_stack_bwd"] == 1
    route_check("bench_f32_layers_vs_stack_backward",
                {k: launches[k] for k in ("cin_compress", "cin_stack_bwd")},
                {"cin_compress": len(layers), "cin_stack_bwd": 0}, cmp)
    del x0, ws, bs, g, got, want

    # (b) CinStackFn at the paper's CIN: the stack forward, the layers
    # route's backward, against the plain stack backward in f32
    # (ROUTE_BWD_TOL), which must refuse a planted fault
    gen = torch.Generator(device=dev).manual_seed(4200)
    layers, split = PAPER_CIN, False
    x0, ws, bs = cin_inputs(gen, PAPER_BATCH, 27, PAPER_WIDTH, layers, split,
                            torch.float32)
    g = torch.randn(PAPER_BATCH, sum(layers), generator=gen, device=dev)
    routes = [stack_route(PAPER_BATCH, 27, PAPER_WIDTH, layers, split, bwd)
              for bwd in (False, True)]
    n = len(layers)

    def stack_fn_grads():
        leaves = [t.detach().clone().requires_grad_() for t in (x0, *ws, *bs)]
        out = cin_stack_forward(leaves[0], leaves[1:1 + n], leaves[1 + n:],
                                layers, split)
        out.backward(g)
        return cin_grads_named((leaves[0].grad, [t.grad for t in leaves[1:1 + n]],
                                [t.grad for t in leaves[1 + n:]]))

    def route_cmp(got):
        cmp = grad_compare(got, want, bwd_tol, "dx0")
        cmp["ok"] = all(
            o["mean_rel_err"] <= ROUTE_BWD_TOL["mean_rel"]
            and o["norm_rel_err"] <= ROUTE_BWD_TOL["norm_rel"]
            and math.isfinite(o["max_abs_err"]) for o in cmp["outputs"].values())
        return cmp

    reset_counts()
    got = stack_fn_grads()
    torch.cuda.synchronize()
    launches = read_counts()
    want = cin_grads_named(cin_stack_backward_plain(x0, ws, bs, g, layers, split))
    cmp = route_cmp(got)
    with dw_from_wrong_hidden():
        control = route_cmp(stack_fn_grads())
    cmp.update(routes=routes, tol=ROUTE_BWD_TOL, control_refused=not control["ok"],
               control_dW1=control["outputs"]["dW1"])
    cmp["ok"] = cmp["ok"] and routes == ["stack", "layers"] and not control["ok"]
    route_check("paper_cin_stack_fn_vs_plain_backward",
                {k: launches[k] for k in ("cin_stack_fwd", "cin_compress", "cin_stack_bwd")},
                {"cin_stack_fwd": 1, "cin_compress": n, "cin_stack_bwd": 0}, cmp)
    del x0, ws, bs, g, got, want

    # (c) the layers route's forward, at a stack too wide for the stack
    # forward, against the plain version
    gen = torch.Generator(device=dev).manual_seed(4300)
    layers, split = (512,), False
    x0, ws, bs = cin_inputs(gen, 1024, 27, 16, layers, split, torch.float32)
    reset_counts()
    got = cin_stack_forward(x0, ws, bs, layers, split)
    torch.cuda.synchronize()
    launches = read_counts()
    cmp = compare(got, cin_stack_plain(x0, ws, bs, layers, split), tol)
    cmp["route"] = stack_route(1024, 27, 16, layers, split, False)
    cmp["ok"] = cmp["ok"] and cmp["route"] == "layers"
    route_check("wide_forward_layers_vs_plain",
                {k: launches[k] for k in ("cin_compress", "cin_stack_fwd")},
                {"cin_compress": 1, "cin_stack_fwd": 0}, cmp)
    del x0, ws, bs, got
    torch.cuda.empty_cache()
    if failures:
        fail("; ".join(failures))
    return results


def attn_params(gen, d, a) -> dict:
    """An attention block's parameters, f32, uniform in the layers' init
    bounds; LayerNorm scale and bias near 1 and 0."""
    import torch

    def u(shape, bound):
        return (torch.rand(shape, generator=gen, device=gen.device) * 2 - 1) * bound

    p = {}
    for nm in "qkv":
        p[f"w{nm}"], p[f"b{nm}"] = u((d, a), d ** -0.5), u((a,), d ** -0.5)
    p["wo"], p["bo"] = u((a, d), a ** -0.5), u((d,), a ** -0.5)
    p["ln_scale"], p["ln_bias"] = 1 + u((d,), 0.1), u((d,), 0.1)
    return p


def attention_library(x, p, heads):
    """Yardstick only, never called by the port: the same block with
    torch's scaled_dot_product_attention around the projections, in x's
    dtype."""
    import torch
    import torch.nn.functional as F

    bsz, f, d = x.shape
    a = p["wq"].shape[1]
    dt = x.dtype
    qkv = x @ torch.cat([p["wq"], p["wk"], p["wv"]], 1).to(dt) \
        + torch.cat([p["bq"], p["bk"], p["bv"]]).to(dt)
    q, k, v = (t.reshape(bsz, f, heads, a // heads).transpose(1, 2)
               for t in qkv.split(a, dim=2))
    ctx = F.scaled_dot_product_attention(q, k, v).transpose(1, 2)
    out = ctx.reshape(bsz, f, a) @ p["wo"].to(dt) + p["bo"].to(dt)
    return F.layer_norm(out + x, (d,), p["ln_scale"].to(dt),
                        p["ln_bias"].to(dt), eps=1e-5)


def attn_bound(bsz, f, d, a, heads, bf16, backward):
    """(bound_ms, bound_by, flops, mixed_bound_ms): the projections (QKV
    and output) and the attention core (scores and context) of the forward;
    the backward recomputes them and takes two products per forward
    product. Bytes: x (and g) read, out (or dx and the parameter gradients)
    written. bound_ms takes every operation at the operands' peak (bf16
    tensor cores in bf16); mixed_bound_ms, beside it, takes the core's f32
    operations at the FP32 rate and only the projections at the operands'
    peak (and is never below the byte time)."""
    es = 2 if bf16 else 4
    rows = bsz * f
    proj = 2 * rows * d * 4 * a
    core = 2 * 2 * bsz * heads * f * f * (a // heads)
    params = 4 * (4 * d * a + 3 * a + 3 * d)
    if backward:
        proj, core = 3 * proj, 3 * core
        nbytes = 3 * rows * d * es + 2 * params
    else:
        nbytes = 2 * rows * d * es + params
    flops = proj + core
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS
    t_ops = flops / peak
    t_bytes = nbytes / PEAK_BYTES_PER_S
    mixed = 1e3 * max(proj / peak + core / PEAK_FP32_FLOPS, t_bytes)
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations", flops, mixed
    return 1e3 * t_bytes, "bytes", flops, mixed


def interacting_library(x, p, heads):
    """Yardstick only, never called by the port: AutoInt's interacting
    layer with torch's scaled_dot_product_attention (scale 1) around the
    same four projections, in x's dtype."""
    import torch
    import torch.nn.functional as F

    bsz, f, _ = x.shape
    a = p["wq"].shape[1]
    w4 = torch.cat([p[n] for n in ("wq", "wk", "wv", "wres")], 1).to(x.dtype)
    q, k, v, res = (x @ w4).split(a, dim=2)
    q, k, v = (t.reshape(bsz, f, heads, a // heads).transpose(1, 2)
               for t in (q, k, v))
    ctx = F.scaled_dot_product_attention(q, k, v, scale=1.0)
    return torch.relu(ctx.transpose(1, 2).reshape(bsz, f, a) + res)


def interacting_bound(bsz, f, d, a, heads, bf16, backward):
    """(bound_ms, bound_by, flops, mixed_bound_ms) as attn_bound gives the
    block's: the four projections and the core's two products (scores and
    context); the backward recomputes them and takes two products per
    forward product. Bytes: x (and g) read, out (or dx and the weight
    gradients) written."""
    es = 2 if bf16 else 4
    rows = bsz * f
    proj = 2 * rows * d * 4 * a
    core = 2 * 2 * bsz * heads * f * f * (a // heads)
    params = 4 * d * a * es
    if backward:
        proj, core = 3 * proj, 3 * core
        nbytes = rows * (2 * d + a) * es + params + 4 * d * a * 4
    else:
        nbytes = rows * (d + a) * es + params
    flops = proj + core
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    mixed = 1e3 * max(proj / peak + core / PEAK_FP32_FLOPS, t_bytes)
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations", flops, mixed
    return 1e3 * t_bytes, "bytes", flops, mixed


def attention_case(k: int, bsz: int, f: int, d: int, a: int, dtype: str):
    """(p, x, g) of the attention phase's block shape ATTN_SHAPES[k]."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3000 + k)
    dt = getattr(torch, dtype)
    p = attn_params(gen, d, a)
    x = torch.randn(bsz, f, d, generator=gen, device="cuda").to(dt)
    g = torch.randn(bsz, f, d, generator=gen, device="cuda").to(dt)
    return p, x, g


def interacting_case(k: int, bsz: int, f: int, d: int, a: int, dtype: str):
    """(p, x, g) of the attention phase's interacting shape
    INTERACT_SHAPES[k]: scores and ReLU outputs of order 1
    (portbench/models/autoint.py's scales): inputs of mean square ~0.1,
    weights U(+-(3 / (sqrt(32) d 0.1))^0.5)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4000 + k)
    dt = getattr(torch, dtype)
    bound = (3.0 / (32 ** 0.5 * d * 0.1)) ** 0.5
    p = {n: (torch.rand(d, a, generator=gen, device="cuda") * 2 - 1) * bound
         for n in ("wq", "wk", "wv", "wres")}
    x = (torch.rand(bsz, f, d, generator=gen, device="cuda") * 0.55).to(dt)
    g = (torch.randn(bsz, f, a, generator=gen, device="cuda") * 1e-3).to(dt)
    return p, x, g


def attention_hashes() -> dict:
    """sha256 of every attention kernel's outputs at the attention phase's
    shapes and inputs, by shape: AttentionDeepFM's block forward (out) and
    backward (dx and each gradient) at ATTN_SHAPES, AutoInt's interacting
    forward (out) and backward (dx and dW4's blocks wq, wk, wv, wres) at
    INTERACT_SHAPES. ``--attention-hashes TREE`` gives another checkout's
    (its own kernels, built in its own tree) on the same inputs."""
    import hashlib

    import torch

    from deepfm_tpu_torch.ops.kernels.attention import (
        attention_block_backward,
        attention_block_forward,
        interacting_backward,
        interacting_forward,
    )

    def sha(t) -> str:
        t = t.detach().contiguous().cpu()
        return hashlib.sha256(t.view(torch.uint8).numpy().tobytes()).hexdigest()

    out = {}
    for k, (name, bsz, f, d, a, heads, dtype) in enumerate(ATTN_SHAPES):
        p, x, g = attention_case(k, bsz, f, d, a, dtype)
        dx, dp = attention_block_backward(x, p, g, heads, True)
        out[name] = {"out": sha(attention_block_forward(x, p, heads, True)),
                     "dx": sha(dx), **{n: sha(dp[n]) for n in sorted(dp)}}
    for k, (name, bsz, f, d, a, heads, dtype) in enumerate(INTERACT_SHAPES):
        p, x, g = interacting_case(k, bsz, f, d, a, dtype)
        dx, dp = interacting_backward(x, p, g, heads)
        out[name] = {"out": sha(interacting_forward(x, p, heads)),
                     "dx": sha(dx), **{n: sha(dp[n]) for n in sorted(dp)}}
        del p, x, g, dx, dp
        torch.cuda.empty_cache()
    return out


def attention_interacting(failures: list) -> dict:
    """The interacting layer's part of the attention phase: one record a
    shape of INTERACT_SHAPES; failures are appended to ``failures``."""
    import torch

    from deepfm_tpu_torch.ops.kernels.attention import (
        INTERACT_NAMES,
        forward_attributes,
        interacting_backward,
        interacting_backward_plain,
        interacting_backward_plan,
        interacting_forward,
        interacting_forward_plan,
        interacting_plain,
    )

    dev = torch.device("cuda", 0)
    results = {}
    for k, (name, bsz, f, d, a, heads, dtype) in enumerate(INTERACT_SHAPES):
        bf16 = dtype == "bfloat16"
        tol = INTERACT_TOL[dtype]
        p, x, g = interacting_case(k, bsz, f, d, a, dtype)

        def fwd():
            return interacting_forward(x, p, heads)

        def bwd():
            return interacting_backward(x, p, g, heads)

        def bwd_plain(**kw):
            dx, dp = interacting_backward_plain(x, p, g, heads, **kw)
            return {"dx": dx, **dp}

        def lib_fwd():
            return interacting_library(x, p, heads)

        def lib_bwd():
            leaves = [x.detach().requires_grad_(),
                      *[p[n].detach().requires_grad_() for n in INTERACT_NAMES]]
            out = interacting_library(leaves[0], dict(zip(INTERACT_NAMES,
                                                          leaves[1:])), heads)
            return torch.autograd.grad(out, leaves, g)

        out, out2 = fwd(), fwd()
        fcmp = grad_compare({"out": out},
                            {"out": interacting_plain(x, p, heads)}, tol, "out")
        tiled0 = interacting_backward.tiled_launches
        (dx, dp), (dx2, dp2) = bwd(), bwd()
        tiled_launches = interacting_backward.tiled_launches - tiled0
        got, again = {"dx": dx, **dp}, {"dx": dx2, **dp2}
        bcmp = grad_compare(got, bwd_plain(), tol, "dx")
        same_bits = torch.equal(out, out2) and all(
            torch.equal(got[o], again[o]) for o in got)
        if not (fcmp["ok"] and bcmp["ok"] and same_bits):
            failures.append(f"{name}: a kernel is outside tolerance {tol} or "
                            f"not repeatable ({same_bits}): {fcmp} {bcmp}")
        controls = {}
        if bf16:
            ctl = grad_compare(bwd_plain(dall_round=False), bwd_plain(), tol,
                               "dx")
            controls["no_dall_round"] = ctl
            if ctl["ok"]:
                failures.append(f"{name}: the bf16 check passes a backward "
                                f"without the [dq|dk|dv|dres] rounding: {ctl}")
        fp = interacting_forward_plan(f, d, a, heads)
        bp = interacting_backward_plan(f, d, a, heads)
        if not bp.tiled or tiled_launches != 2:
            failures.append(f"{name}: the backward's plan {bp} took the tiled "
                            f"core in {tiled_launches} of 2 launches")
        fattr = forward_attributes(x, fp, "interacting_fwd_attributes")
        if fattr["blocks_per_sm"] != fp.blocks_per_sm:
            failures.append(f"{name}: the compiled forward holds "
                            f"{fattr['blocks_per_sm']} blocks an SM, the plan "
                            f"{fp.blocks_per_sm}: {fattr}")
        del out, out2, dx, dp, dx2, dp2, got, again
        rec = {"phase": "attention", "shape": name, "layer": "interacting",
               "B": bsz, "F": f, "d": d, "attention_dim": a, "heads": heads,
               "dtype": dtype, "same_bits": same_bits, "tol": tol,
               "relu_share_on": (interacting_plain(x, p, heads).float() > 0)
               .float().mean().item(),
               "backward_plan": {"samples": bp.samples,
                                 "core_warps": bp.core_warps, "rows": bp.rows,
                                 "smem_bytes": bp.smem, "grid": bp.grid(bsz),
                                 "tiled": bp.tiled},
               "backward_tiled_launches": tiled_launches,
               "forward_plan": {
                   "samples": fp.samples, "core_warps": fp.core_warps,
                   "rows": fp.rows, "smem_bytes": fp.smem,
                   "blocks_per_sm": fp.blocks_per_sm,
                   "grid": fp.grid(bsz, torch.cuda.get_device_properties(
                       dev).multi_processor_count)},
               "forward_compiled": fattr, "controls": controls,
               "library": "scaled_dot_product_attention (scale 1) around the "
                          "same four projections and the ReLU (autograd for "
                          "the backward)"}
        for kind, cmp, kern, plain, lib in (
                ("forward", fcmp, fwd, lambda: interacting_plain(x, p, heads),
                 lib_fwd),
                ("backward", bcmp, bwd, bwd_plain, lib_bwd)):
            bound_ms, bound_by, flops, mixed_ms = interacting_bound(
                bsz, f, d, a, heads, bf16, kind == "backward")
            ms = time_ms(kern, reps=20)
            library_ms = time_ms(lib, reps=20)
            rec[kind] = {
                **cmp,
                "max_abs_err": max(o["max_abs_err"]
                                   for o in cmp["outputs"].values()),
                "ms": ms, "plain_ms": time_ms(plain, reps=5, warmup=1),
                "library_ms": library_ms, "below_library": ms < library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "mixed_bound_ms": mixed_ms,
                "gflop": flops / 1e9, "tflops": flops / (ms * 1e-3) / 1e12,
            }
        emit(rec)
        results[name] = rec
        del x, g, p
        torch.cuda.empty_cache()
    return results


def phase_attention() -> dict:
    import torch

    from deepfm_tpu_torch.ops.kernels.attention import (
        attention_block_backward,
        attention_block_backward_plain,
        attention_block_forward,
        attention_block_plain,
        backward_plan,
        forward_attributes,
        forward_plan,
        param_names,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    results, failures = {}, []
    for k, (name, bsz, f, d, a, heads, dtype) in enumerate(ATTN_SHAPES):
        bf16 = dtype == "bfloat16"
        tol = ATTN_TOL[dtype]
        p, x, g = attention_case(k, bsz, f, d, a, dtype)

        def fwd():
            return attention_block_forward(x, p, heads, True)

        def bwd():
            return attention_block_backward(x, p, g, heads, True)

        def bwd_plain(**kw):
            dx, dp = attention_block_backward_plain(x, p, g, heads, True, **kw)
            return {"dx": dx, **dp}

        def lib_fwd():
            return attention_library(x, p, heads)

        def lib_bwd():
            leaves = [x.detach().requires_grad_(),
                      *[p[n].detach().requires_grad_() for n in param_names(True)]]
            out = attention_library(leaves[0], dict(zip(param_names(True),
                                                        leaves[1:])), heads)
            return torch.autograd.grad(out, leaves, g)

        out, out2 = fwd(), fwd()
        fcmp = grad_compare({"out": out}, {"out": attention_block_plain(
            x, p, heads, True)}, tol, "out")
        (dx, dp), (dx2, dp2) = bwd(), bwd()
        got, again = {"dx": dx, **dp}, {"dx": dx2, **dp2}
        bcmp = grad_compare(got, bwd_plain(), tol, "dx", ref_of={"bk": "wk"})
        same_bits = torch.equal(out, out2) and all(
            torch.equal(got[o], again[o]) for o in got)
        if not (fcmp["ok"] and bcmp["ok"] and same_bits):
            failures.append(f"{name}: a kernel is outside tolerance {tol} or "
                            f"not repeatable ({same_bits}): {fcmp} {bcmp}")
        controls = {}
        if bf16:
            ctl = grad_compare(bwd_plain(dall_round=False), bwd_plain(), tol,
                               "dx", ref_of={"bk": "wk"})
            controls["no_dall_round"] = ctl
            if ctl["ok"]:
                failures.append(f"{name}: the bf16 check passes a backward "
                                f"without the [dq|dk|dv] rounding: {ctl}")
            ctl = grad_compare(
                {"out": attention_block_plain(x, p, heads, True,
                                              ctx_round=False)},
                {"out": attention_block_plain(x, p, heads, True)}, tol, "out")
            controls["no_ctx_round"] = ctl
            if ctl["ok"]:
                failures.append(f"{name}: the bf16 check passes a forward "
                                f"without the context's rounding: {ctl}")
        fp = forward_plan(f, d, a, heads)
        fattr = forward_attributes(x, fp)
        if fattr["blocks_per_sm"] != fp.blocks_per_sm:
            failures.append(f"{name}: the compiled forward holds "
                            f"{fattr['blocks_per_sm']} blocks an SM, the plan "
                            f"{fp.blocks_per_sm}: {fattr}")
        del out, out2, dx, dp, dx2, dp2, got, again
        big = bsz >= 16384
        reps = 20 if big else 50
        bp = backward_plan(f, d, a, heads)
        rec = {"phase": "attention", "shape": name, "B": bsz, "F": f, "d": d,
               "attention_dim": a, "heads": heads, "dtype": dtype,
               "residual": True, "same_bits": same_bits, "tol": tol,
               "backward_plan": {"samples": bp.samples,
                                 "core_warps": bp.core_warps, "rows": bp.rows,
                                 "smem_bytes": bp.smem, "grid": bp.grid(bsz)},
               "forward_plan": {
                   "samples": fp.samples, "core_warps": fp.core_warps,
                   "rows": fp.rows, "smem_bytes": fp.smem,
                   "blocks_per_sm": fp.blocks_per_sm,
                   "grid": fp.grid(bsz, torch.cuda.get_device_properties(
                       dev).multi_processor_count)},
               "forward_compiled": fattr,
               "controls": controls,
               "library": "scaled_dot_product_attention around the same "
                          "projections and layer_norm (autograd for the "
                          "backward)"}
        for kind, cmp, kern, plain, lib in (
                ("forward", fcmp, fwd,
                 lambda: attention_block_plain(x, p, heads, True), lib_fwd),
                ("backward", bcmp, bwd, bwd_plain, lib_bwd)):
            bound_ms, bound_by, flops, mixed_ms = attn_bound(
                bsz, f, d, a, heads, bf16, kind == "backward")
            ms = time_ms(kern, reps=reps)
            library_ms = time_ms(lib, reps=reps)
            rec[kind] = {
                **cmp,
                "max_abs_err": max(o["max_abs_err"]
                                   for o in cmp["outputs"].values()),
                "ms": ms, "plain_ms": time_ms(plain, reps=5, warmup=1),
                "library_ms": library_ms, "below_library": ms < library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "mixed_bound_ms": mixed_ms,
                "gflop": flops / 1e9, "tflops": flops / (ms * 1e-3) / 1e12,
            }
        split = call_split(fwd, device_reps=20 if big else 100,
                           host_reps=50 if big else 200)
        rec["forward"]["call_split"] = split
        rec["forward"]["device_share_of_mixed_bound"] = (
            rec["forward"]["mixed_bound_ms"] / split["device_ms"])
        emit(rec)
        results[name] = rec
        del x, g, p
        torch.cuda.empty_cache()
    results.update(attention_interacting(failures))
    results["sha256"] = attention_hashes()
    emit({"phase": "attention", "sha256": results["sha256"]})
    if failures:
        fail("; ".join(failures))
    return results


def free_device() -> None:
    """Give the device memory of deleted objects back to the card (a
    deleted Trainer goes by reference count; the collector runs first for
    any other cycle)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def mem_bound_ms(nbytes: float) -> float:
    return 1e3 * nbytes / PEAK_BYTES_PER_S


def call_split(fn, device_reps: int = 100, host_reps: int = 1000) -> dict:
    """One call's time taken apart: call_ms (CUDA events around one call,
    as time_ms takes it: host path and device time), device_ms (events
    around device_reps back-to-back calls, over the count) and host_us
    (host clock per call over host_reps calls, no synchronise; and
    host_us_idle_queue, one call at a time after a synchronise)."""
    import torch

    call_ms = time_ms(fn, reps=50)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(device_reps):
        fn()
    end.record()
    end.synchronize()
    device_ms = start.elapsed_time(end) / device_reps
    t0 = time.perf_counter()
    for _ in range(host_reps):
        fn()
    host_us = 1e6 * (time.perf_counter() - t0) / host_reps
    torch.cuda.synchronize()
    # one call at a time from an idle queue (median of 200): the host path
    # with no wait on the device
    hs = []
    for _ in range(200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        hs.append(time.perf_counter() - t0)
    host_us_idle = 1e6 * statistics.median(hs)
    torch.cuda.synchronize()
    return {"call_ms": call_ms, "device_ms": device_ms,
            "host_us": host_us,
            "host_us_idle_queue": host_us_idle}


def table_inputs(dev, seed=7, missing_fields=0):
    """bench.py's table update inputs on the card: ids drawn per field as
    bench.py draws them (uniform in [1, vocab), so duplicates occur) and
    offset into the fused table, cotangent rows, a table and bf16 moments
    away from zero, and the scalars of an active clip. The first
    ``missing_fields`` fields get id 0 (padding/OOV) in every row."""
    import torch

    rows = BENCH_FIELDS * BENCH_VOCAB
    gen = torch.Generator(device=dev).manual_seed(seed)
    local = torch.randint(1, BENCH_VOCAB, (BENCH_BATCH, BENCH_FIELDS),
                          generator=gen, device=dev)
    local[:, :missing_fields] = 0
    ids = (local + BENCH_VOCAB * torch.arange(BENCH_FIELDS, device=dev)).reshape(-1)
    ct = torch.randn(ids.shape[0], D, generator=gen, device=dev) * 1e-3
    p = (torch.rand(rows, D, generator=gen, device=dev) * 2 - 1) * 4e-3
    mu = (torch.randn(rows, D, generator=gen, device=dev) * 1e-4).bfloat16()
    nu = (torch.randn(rows, D, generator=gen, device=dev) * 1e-4).square().bfloat16()
    args = (LR, 2 * L2, torch.tensor(2.0, device=dev), CLIP,
            torch.tensor(4, dtype=torch.int32, device=dev))
    return ids, ct, p, mu, nu, args


def rel_err(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def adam_check(kernel, plain, fresh, extra, args) -> dict:
    """A table Adam kernel against its plain version on three fresh copies
    of the same state (``fresh()``): the moments bit for bit, p within
    TABLE_TOL, sum(p'^2) (sparse kernels) within TABLE_TOL, and a second
    launch giving the same bits; then both timed."""
    import torch

    k, q, k2 = fresh(), fresh(), fresh()
    rk = kernel(*k, *extra, *args)
    rq = plain(*q, *extra, *args)
    rk2 = kernel(*k2, *extra, *args)
    p_err = (k[0] - q[0]).abs()
    p_rel = (p_err / q[0].abs().clamp_min(1e-30)).max().item()
    moments_equal = bool(torch.equal(k[1], q[1]) and torch.equal(k[2], q[2]))
    det = all(torch.equal(a, b) for a, b in zip(k, k2))
    rec = {"max_abs_err": p_err.max().item(), "p_max_rel_err": p_rel,
           "p_share_differing": (p_err > 0).float().mean().item(),
           "moments_bit_equal": moments_equal, "deterministic": det,
           "moments": "bfloat16"}
    ok = moments_equal and det and p_rel <= TABLE_TOL["p_rel"]
    if len(rk) == 4:  # sparse: sum(p'^2)
        rec["psq_rel_err"] = rel_err(rk[3], rq[3])
        rec["deterministic"] = det = det and bool(torch.equal(rk[3], rk2[3]))
        ok = ok and det and rec["psq_rel_err"] <= TABLE_TOL["scalar_rel"]
    rec["ok"] = ok
    del k2, rk2
    rec["ms"] = time_ms(lambda: kernel(*k, *extra, *args), reps=20)
    rec["plain_ms"] = time_ms(lambda: plain(*q, *extra, *args), reps=3, warmup=1)
    return rec


def adam_ragged_checks(dev) -> list:
    """fused_table_adam on tables of ADAM_RAGGED_ROWS x D (8k + 3
    elements), stored at each offset of ADAM_OFFSETS elements past an
    allocation (every tensor a view that far off its 16-byte boundary),
    with f32 and bf16 moments, the clip off and on: p, mu and nu bit for
    bit against the plain version on aligned copies of the same state,
    and a second launch giving the same bits."""
    import torch

    from deepfm_tpu_torch.ops.kernels.adam import (
        fused_table_adam,
        fused_table_adam_plain,
        vector_split,
    )

    def at_offset(t, off):
        flat = torch.empty(t.numel() + off, dtype=t.dtype, device=dev)
        view = flat[off:].view(t.shape)
        view.copy_(t)
        return view

    out = []
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = ADAM_RAGGED_ROWS
    p = (torch.rand(rows, D, generator=gen, device=dev) * 2 - 1) * 4e-3
    g = torch.randn(rows, D, generator=gen, device=dev) * 1e-3
    m32 = torch.randn(rows, D, generator=gen, device=dev) * 1e-4
    v32 = (torch.randn(rows, D, generator=gen, device=dev) * 1e-4).square()
    for moments in (torch.float32, torch.bfloat16):
        mu, nu = m32.to(moments), v32.to(moments)
        for off in ADAM_OFFSETS:
            for clip in (0.0, CLIP):
                args = (LR, 2 * L2, torch.tensor(2.0, device=dev), clip,
                        torch.tensor(4, dtype=torch.int32, device=dev))
                k = [at_offset(t, off) for t in (p, mu, nu)]
                k2 = [at_offset(t, off) for t in (p, mu, nu)]
                gk = at_offset(g, off)
                q = [p.clone(), mu.clone(), nu.clone()]
                fused_table_adam(*k, gk, *args)
                fused_table_adam(*k2, gk, *args)
                fused_table_adam_plain(*q, g, *args)
                equal = all(torch.equal(a, b) for a, b in zip(k, q))
                det = all(torch.equal(a, b) for a, b in zip(k, k2))
                split = vector_split(p.numel(), [
                    (t.data_ptr(), t.element_size()) for t in (k[0], gk, *k[1:])])
                out.append({"moments": str(moments).split(".")[-1],
                            "offset": off, "clip": clip, "numel": p.numel(),
                            "split": split._asdict(), "bit_equal": equal,
                            "deterministic": det, "ok": equal and det})
    return out


def add_densify_edges(rec: dict, kernel, plain, num_rows: int, dev) -> None:
    """Adds to a densify record: the kernel ``kernel(sids, cts, num_rows)``
    against its plain version, bit for bit and twice, on the long runs
    (table_inputs with LONG_RUN_FIELDS fields at id 0, timed, and their time
    over the record's) and on the ragged table (RAGGED_ROWS, RAGGED_PAIRS),
    and whether the record's time is below its library call's."""
    import torch

    from deepfm_tpu_torch.ops.kernels.grad import sort_pairs

    out, rec_ms = {}, rec["ms"]
    ids, ct, *rest = table_inputs(dev, missing_fields=LONG_RUN_FIELDS)
    del rest
    gen = torch.Generator(device=dev).manual_seed(11)
    rids = torch.randint(-5, RAGGED_ROWS + 5, (RAGGED_PAIRS,), generator=gen,
                         device=dev)
    rct = torch.randn(RAGGED_PAIRS, D, generator=gen, device=dev)
    for name, pairs, rows in (("long_runs", (ids, ct), num_rows),
                              ("ragged", (rids, rct), RAGGED_ROWS)):
        sids, cts = sort_pairs(*pairs)
        got = kernel(sids, cts, rows)
        equal = bool(torch.equal(got, plain(sids, cts, rows)))
        det = bool(torch.equal(got, kernel(sids, cts, rows)))
        edge = {"rows": rows, "pairs": sids.numel(), "bit_equal": equal,
                "deterministic": det, "ok": equal and det}
        if name == "long_runs":
            _, runs = torch.unique_consecutive(sids, return_counts=True)
            edge.update(missing_fields=LONG_RUN_FIELDS,
                        max_run=int(runs.max()),
                        ms=time_ms(lambda: kernel(sids, cts, rows), reps=10))
        out[name] = edge
        del got, sids, cts
    del ids, ct, rids, rct
    torch.cuda.empty_cache()
    out["long_runs"]["over_bench_pairs"] = out["long_runs"]["ms"] / rec_ms
    rec.update(out)
    rec["ok"] = rec["ok"] and out["long_runs"]["ok"] and out["ragged"]["ok"]
    rec["below_library"] = rec_ms < rec["library_ms"]


def densify_record(kernel, sids, cts, num_rows, out_bytes, pair_bytes,
                   ms) -> dict:
    """What a densify record adds to its bit-equal check and times: the
    kernel with no pairs (fill_ms: the write stream alone) beside a memset
    of the same bytes (torch.empty(...).zero_(), the card's write rate in
    practice), its achieved rate and share of the bytes bound."""
    import torch

    bound = mem_bound_ms(out_bytes + pair_bytes)
    return {
        "fill_ms": time_ms(lambda: kernel(sids[:0], cts[:0], num_rows), reps=20),
        "memset_ms": time_ms(lambda: torch.empty(out_bytes // 4, device=cts.device).zero_(), reps=20),
        "fill_bound_ms": mem_bound_ms(out_bytes),
        "achieved_TBps": (out_bytes + pair_bytes) / ms / 1e9,
        "share_of_bound": bound / ms,
        "bound_ms": bound, "bound_by": "bytes",
    }


def sparse_call_split(kernel, fresh, extra, args, bound_ms) -> dict:
    """A sparse table Adam kernel's call split (call_split) on a fresh copy
    of the state, and its device time's share of the byte bound."""
    state = fresh()
    split = call_split(lambda: kernel(*state, *extra, *args), device_reps=20,
                       host_reps=50)
    del state
    return {"call_split": split,
            "device_share_of_bound": bound_ms / split["device_ms"]}


def segment_sumsq_split(fn, sids, cts, calls: int = 20) -> dict:
    """One segment_sumsq call on (sids, cts) taken apart: its device time
    by kernel and its device launches a call (launch_breakdown over
    ``calls`` calls: kernels, fills and copies), and its host path
    (call_split; host_us_idle_queue is one call from an idle queue).
    Should the profiler lose a kernel event (PROFILE_PAD), a kernel's time
    is taken per event seen, and its launches a call rounded."""
    bd = launch_breakdown(lambda: fn(sids, cts), calls=calls)
    by_kernel = {name: {"ms": k["ms"] / k["launches"],
                        "launches": round(k["launches"]),
                        "events_seen_a_call": k["launches"]}
                 for name, k in bd["kernels"].items()}
    return {"device_ms": sum(k["ms"] * k["launches"]
                             for k in by_kernel.values()),
            "by_kernel": by_kernel,
            "launches_a_call": sum(k["launches"] for k in by_kernel.values()),
            "call_split": call_split(lambda: fn(sids, cts))}


def segment_sumsq_probe() -> dict:
    """segment_sumsq alone at the table phase's shape, on uniform ids and
    on the long runs: its rel error against the plain version and its
    call split (segment_sumsq_split). It drives whichever deepfm_tpu_torch
    comes first on sys.path, so one call can measure two trees:

        PYTHONPATH=<tree> python -c 'import chip_smoke as c; c.segment_sumsq_probe()'
    """
    import torch

    from deepfm_tpu_torch.ops.kernels.grad import sort_pairs
    from deepfm_tpu_torch.ops.kernels.sparse_adam import (
        segment_sumsq,
        segment_sumsq_plain,
    )

    dev = torch.device(DEVICE)
    out = {"phase": "segment_sumsq_probe",
           "package": str(Path(sys.modules["deepfm_tpu_torch"].__file__).parent)}
    for name, missing in (("uniform", 0), ("long_runs", LONG_RUN_FIELDS)):
        ids, ct, *_ = table_inputs(dev, missing_fields=missing)
        sids, cts = sort_pairs(ids, ct)
        got = segment_sumsq(sids, cts)
        out[name] = {
            "rel_err": rel_err(got, segment_sumsq_plain(sids, cts)),
            "deterministic": bool(torch.equal(got, segment_sumsq(sids, cts))),
            "ms": time_ms(lambda: segment_sumsq(sids, cts), reps=50),
            **segment_sumsq_split(segment_sumsq, sids, cts),
        }
        del ids, ct, sids, cts
    emit(out)
    return out


def phase_table_kernels() -> dict:
    """The four table-update kernels at bench.py's shape."""
    import torch

    from deepfm_tpu_torch.ops.kernels.adam import (
        fused_table_adam,
        fused_table_adam_plain,
    )
    from deepfm_tpu_torch.ops.kernels.grad import (
        densify_sorted,
        segment_rows_plain,
        sort_pairs,
    )
    from deepfm_tpu_torch.ops.kernels.sparse_adam import (
        segment_sumsq,
        segment_sumsq_plain,
        segment_sumsq_plan,
        sparse_table_adam,
        sparse_table_adam_plain,
    )

    dev = torch.device(DEVICE)
    ids, ct, p, mu, nu, args = table_inputs(dev)
    rows, n = p.shape[0], ids.shape[0]
    sids, cts = sort_pairs(ids, ct)
    pair_bytes = n * (4 + 4 * D)
    elems = rows * D
    out, failures = {}, []

    _, run_lengths = torch.unique_consecutive(sids, return_counts=True)
    shape = {"rows": rows, "D": D, "pairs": n,
             "unique_ids": run_lengths.numel(),
             "max_run": int(run_lengths.max())}

    def record(name, rec):
        rec = {"phase": name, **shape, **rec}
        emit(rec)
        out[name] = rec
        if not rec["ok"]:
            failures.append(f"{name}: {rec}")

    # densify_rows_grad: bit for bit, deterministic; the write stream alone
    # (no pairs), the long runs and a ragged table
    got = densify_sorted(sids, cts, rows)
    again = densify_sorted(sids, cts, rows)
    want = segment_rows_plain(sids, cts, rows)
    err = (got - want).abs().max().item()
    ms = time_ms(lambda: densify_sorted(sids, cts, rows), reps=20)
    rec = {
        "max_abs_err": err, "bit_equal": bool(torch.equal(got, want)),
        "deterministic": bool(torch.equal(got, again)),
        "ok": bool(torch.equal(got, want) and torch.equal(got, again)),
        "ms": ms,
        "plain_ms": time_ms(lambda: segment_rows_plain(sids, cts, rows), reps=5, warmup=1),
        "library_ms": time_ms(lambda: torch.zeros(rows, D, device=dev).index_add_(0, ids, ct), reps=20),
        "library": "torch.zeros(rows, D).index_add_(0, ids, ct) (unsorted, atomics)",
        **densify_record(densify_sorted, sids, cts, rows, elems * 4,
                         pair_bytes, ms),
    }
    grad = got
    del again, want
    add_densify_edges(rec, densify_sorted, segment_rows_plain, rows, dev)
    record("densify_rows_grad", rec)

    # segment_sumsq: rel 1e-5 against the plain version, deterministic, one
    # launch a call; its device time by kernel and its host path
    got = segment_sumsq(sids, cts)
    want = segment_sumsq_plain(sids, cts)
    rel = rel_err(got, want)
    same = bool(torch.equal(got, segment_sumsq(sids, cts)))
    ssq_plan = segment_sumsq_plan(n, D)
    ssq_split = segment_sumsq_split(segment_sumsq, sids, cts)
    ssq_bound = mem_bound_ms(pair_bytes)
    record("segment_sumsq", {
        "value": got.item(), "plain": want.item(),
        "max_abs_err": abs(got.item() - want.item()), "rel_err": rel,
        "deterministic": same,
        "ok": (rel <= TABLE_TOL["scalar_rel"] and same
               and ssq_split["launches_a_call"] == 1),
        "ms": time_ms(lambda: segment_sumsq(sids, cts), reps=50),
        "plain_ms": time_ms(lambda: segment_sumsq_plain(sids, cts), reps=5, warmup=1),
        "library_ms": None,
        "library": "none: no single PyTorch call sums squares of segment sums",
        "plan": {**dataclasses.asdict(ssq_plan), "grid": ssq_plan.grid,
                 "smem": ssq_plan.smem},
        **ssq_split,
        "device_share_of_bound": ssq_bound / ssq_split["device_ms"],
        "bound_ms": ssq_bound, "bound_by": "bytes",
    })

    def fresh():
        return [p.clone(), mu.clone(), nu.clone()]

    rec = adam_check(sparse_table_adam, sparse_table_adam_plain, fresh,
                     (sids, cts), args)
    sparse_bound = mem_bound_ms(elems * (8 + 2 * 2 * 2) + pair_bytes)
    sparse_split = sparse_call_split(sparse_table_adam, fresh, (sids, cts),
                                     args, sparse_bound)
    record("sparse_table_adam", {
        **rec, "library_ms": None,
        "library": "none: no single PyTorch call densifies and applies Adam",
        **sparse_split,
        "bound_ms": sparse_bound,
        "bound_by": "bytes",
    })

    rec = adam_check(fused_table_adam, fused_table_adam_plain, fresh,
                     (grad,), args)
    lib_p = p.clone().requires_grad_()
    lib_p.grad = grad
    lib = torch.optim.Adam([lib_p], lr=LR, weight_decay=2 * L2, fused=True)
    lib_ms = time_ms(lib.step, reps=20)
    del lib, lib_p
    state = fresh()
    split = call_split(lambda: fused_table_adam(*state, grad, *args),
                       device_reps=20, host_reps=50)
    del state
    ragged = adam_ragged_checks(dev)
    bound = mem_bound_ms(elems * (4 + 4 + 4 + 2 * 2 * 2))
    record("fused_table_adam", {
        **rec,
        "library_ms": lib_ms,
        "library": "torch.optim.Adam(fused=True, weight_decay) step, f32 "
                   "moments: no clip, other op order",
        "below_library": rec["ms"] < lib_ms,
        "call_split": split,
        "device_share_of_bound": bound / split["device_ms"],
        "ragged": ragged,
        # the update is elementwise in the plain version's op order: p too
        # is the plain version's bit for bit
        "p_bit_equal": rec["max_abs_err"] == 0.0,
        "ok": (rec["ok"] and rec["max_abs_err"] == 0.0
               and all(r["ok"] for r in ragged)),
        "bound_ms": bound,
        "bound_by": "bytes",
    })
    del grad, ids, ct, p, mu, nu, sids, cts
    torch.cuda.empty_cache()

    # the same kernels where LONG_RUN_FIELDS fields are missing in every
    # row: runs of BENCH_BATCH equal ids, each summed in stream order (a
    # chain of adds that one thread once walked from device memory, fault
    # 3); held to the plain versions too
    ids, ct, p, mu, nu, args = table_inputs(dev, missing_fields=LONG_RUN_FIELDS)
    sids, cts = sort_pairs(ids, ct)
    _, run_lengths = torch.unique_consecutive(sids, return_counts=True)
    got = densify_sorted(sids, cts, rows)
    dense_equal = bool(torch.equal(got, segment_rows_plain(sids, cts, rows)))
    del got
    ssq = segment_sumsq(sids, cts)
    ssq_rel = rel_err(ssq, segment_sumsq_plain(sids, cts))
    ssq_same = bool(torch.equal(ssq, segment_sumsq(sids, cts)))
    rec = adam_check(sparse_table_adam, sparse_table_adam_plain, fresh,
                     (sids, cts), args)
    rec.update(sparse_call_split(sparse_table_adam, fresh, (sids, cts), args,
                                 sparse_bound))
    ssq_ms = time_ms(lambda: segment_sumsq(sids, cts), reps=10)
    ssq_long = segment_sumsq_split(segment_sumsq, sids, cts)
    record("long_runs", {
        "missing_fields": LONG_RUN_FIELDS, "max_run": int(run_lengths.max()),
        "unique_ids": run_lengths.numel(),
        "densify_rows_grad_bit_equal": dense_equal,
        "segment_sumsq_rel_err": ssq_rel,
        "segment_sumsq_deterministic": ssq_same,
        "sparse_table_adam": rec,
        "densify_rows_grad_ms": time_ms(lambda: densify_sorted(sids, cts, rows), reps=10),
        "segment_sumsq_ms": ssq_ms,
        "segment_sumsq_split": ssq_long,
        "segment_sumsq_limit_ms": LONG_RUN_SEGSQ_MS,
        "sparse_table_adam_ms": rec["ms"],
        "sparse_table_adam_over_uniform": (
            rec["ms"] / out["sparse_table_adam"]["ms"]),
        "sparse_table_adam_device_over_uniform": (
            rec["call_split"]["device_ms"]
            / out["sparse_table_adam"]["call_split"]["device_ms"]),
        "ok": (dense_equal and rec["ok"] and ssq_same
               and ssq_rel <= TABLE_TOL["scalar_rel"]
               and ssq_ms < LONG_RUN_SEGSQ_MS
               and ssq_long["launches_a_call"] == 1),
    })
    del ids, ct, p, mu, nu, sids, cts
    torch.cuda.empty_cache()
    if failures:
        fail("; ".join(failures))
    return out


def packed_rows_of(rows: int) -> int:
    """Physical rows of a packed table of ``rows`` logical rows (pad128 of
    ceil(rows / PACK), as create_model builds it)."""
    return -(-(-(-rows // PACK)) // 128) * 128


def phase_packed_kernels() -> dict:
    """The packed layout's kernels at bench.py's table: the packed densify
    (also on the long runs), the packed sparse_table_adam (against its
    plain version and against the logical kernel on the unpacked state)
    and the row gather."""
    import torch

    from deepfm_tpu_torch.ops.kernels.gather import row_gather, row_gather_plain
    from deepfm_tpu_torch.ops.kernels.grad import sort_pairs
    from deepfm_tpu_torch.ops.kernels.packed_grad import (
        densify_packed_plain,
        densify_packed_sorted,
    )
    from deepfm_tpu_torch.ops.kernels.sparse_adam import (
        sparse_table_adam,
        sparse_table_adam_plain,
    )
    from deepfm_tpu_torch.utils.layout import pack_table, unpack_table

    dev = torch.device(DEVICE)
    ids, ct, p, mu, nu, args = table_inputs(dev)
    rows, n = p.shape[0], ids.shape[0]
    phys = packed_rows_of(rows)
    num_rows = phys * PACK  # the packed lookup's backward asks for these
    sids, cts = sort_pairs(ids, ct)
    pair_bytes = n * (4 + 4 * D)
    out, failures = {}, []
    shape = {"logical_rows": rows, "phys_rows": phys, "pack": PACK, "D": D,
             "pairs": n}

    def record(name, rec):
        rec = {"phase": name, **shape, **rec}
        emit(rec)
        out[name] = rec
        if not rec["ok"]:
            failures.append(f"{name}: {rec}")

    # densify_rows_grad_packed: bit for bit, deterministic, dead lanes 0
    got = densify_packed_sorted(sids, cts, num_rows, PACK)
    again = densify_packed_sorted(sids, cts, num_rows, PACK)
    want = densify_packed_plain(sids, cts, num_rows, PACK)
    equal, det = bool(torch.equal(got, want)), bool(torch.equal(got, again))
    dead_zero = not bool(got[:, PACK * D:].any())
    err = (got - want).abs().max().item()
    del got, again, want
    offs = (((ids // PACK) * 128 + (ids % PACK) * D)[:, None]
            + torch.arange(D, device=dev)).reshape(-1)
    flat_ct = ct.reshape(-1)

    def kernel(s, c, r):
        return densify_packed_sorted(s, c, r, PACK)

    def plain(s, c, r):
        return densify_packed_plain(s, c, r, PACK)

    ms = time_ms(lambda: kernel(sids, cts, num_rows), reps=20)
    rec = {
        "max_abs_err": err, "bit_equal": equal, "deterministic": det,
        "dead_lanes_zero": dead_zero, "ok": equal and det and dead_zero,
        "ms": ms,
        "plain_ms": time_ms(lambda: plain(sids, cts, num_rows), reps=5, warmup=1),
        "library_ms": time_ms(lambda: torch.zeros(phys * 128, device=dev).index_add_(0, offs, flat_ct), reps=20),
        "library": "torch.zeros(phys * 128).index_add_(0, element offsets, ct) "
                   "(unsorted, atomics)",
        **densify_record(kernel, sids, cts, num_rows, phys * 128 * 4,
                         pair_bytes, ms),
    }
    del offs, flat_ct
    # the same where LONG_RUN_FIELDS fields are missing in every row, and
    # a ragged table (its last tile ends inside a physical row)
    add_densify_edges(rec, kernel, plain, num_rows, dev)
    record("densify_rows_grad_packed", rec)

    # sparse_table_adam on the packed table: against its plain version, and
    # against the logical kernel on the unpacked state
    packed_state = [pack_table(t, D, PACK, phys) for t in (p, mu, nu)]

    def fresh():
        return [t.clone() for t in packed_state]

    def kernel(*a):
        return sparse_table_adam(*a, pack=PACK)

    def plain(*a):
        return sparse_table_adam_plain(*a, pack=PACK)

    rec = adam_check(kernel, plain, fresh, (sids, cts), args)
    packed_bound = mem_bound_ms(phys * 128 * (8 + 2 * 2 * 2) + pair_bytes)
    rec.update(sparse_call_split(kernel, fresh, (sids, cts), args,
                                 packed_bound))
    k = fresh()
    *_, kpsq = kernel(*k, sids, cts, *args)
    lg = [p.clone(), mu.clone(), nu.clone()]
    *_, lpsq = sparse_table_adam(*lg, sids, cts, *args)
    same_as_logical = all(
        bool(torch.equal(unpack_table(a, D, PACK, rows), b))
        for a, b in zip(k, lg))
    dead_zero = not any(bool(t[:, PACK * D:].float().any()) for t in k)
    rec.update({
        "bit_equal_to_logical_kernel": same_as_logical,
        "psq_rel_err_to_logical_kernel": rel_err(kpsq, lpsq),
        "dead_lanes_zero": dead_zero,
        "library_ms": None,
        "library": "none: no single PyTorch call densifies and applies Adam",
        "bound_ms": packed_bound,
        "bound_by": "bytes",
    })
    rec["ok"] = (rec["ok"] and same_as_logical and dead_zero
                 and rec["psq_rel_err_to_logical_kernel"] <= TABLE_TOL["scalar_rel"])
    record("sparse_table_adam_packed", rec)
    del k, lg, packed_state, mu, nu
    torch.cuda.empty_cache()

    # row_gather: the logical table's rows at the step's ids; the single
    # call's time split into device and host time, for the kernel and for
    # index_select, in turns
    got = row_gather(p, ids)
    want = row_gather_plain(p, ids)
    equal = bool(torch.equal(got, want))
    det = bool(torch.equal(got, row_gather(p, ids)))

    def kernel():
        return row_gather(p, ids)

    def library():
        return torch.index_select(p, 0, ids)

    splits = [call_split(fn) for fn in (kernel, library, library, kernel)]
    ksplit = {k: (splits[0][k] + splits[3][k]) / 2 for k in splits[0]}
    lsplit = {k: (splits[1][k] + splits[2][k]) / 2 for k in splits[1]}
    bound_ms = mem_bound_ms(2 * n * D * 4 + n * 8)
    record("row_gather", {
        "table_rows": rows, "max_abs_err": (got - want).abs().max().item(),
        "bit_equal": equal, "deterministic": det, "ok": equal and det,
        "ms": ksplit["call_ms"],
        "plain_ms": time_ms(lambda: row_gather_plain(p, ids), reps=20),
        "library_ms": lsplit["call_ms"],
        "library": "torch.index_select(table, 0, ids)",
        "below_library": ksplit["call_ms"] < lsplit["call_ms"],
        "kernel": ksplit, "index_select": lsplit,
        "split_runs": splits,
        "device_below_library": ksplit["device_ms"] < lsplit["device_ms"],
        "device_share_of_bound": bound_ms / ksplit["device_ms"],
        "bound_ms": bound_ms, "bound_by": "bytes",
    })
    del got, want, ids, ct, p, sids, cts
    torch.cuda.empty_cache()
    if failures:
        fail("; ".join(failures))
    return out


def bench_workload(vocab: int, width: int = 16, seed: int = 0,
                   dense_fields: int = 1):
    """bench.py's _workload at ``vocab`` ids per field, in the port's own
    data classes: 26 sparse fields of width ``width`` (bench.py's 16) and
    ``dense_fields`` dense fields (bench.py's 1; Criteo's 13), one batch of
    16384 rows from numpy seed ``seed`` (bench.py's 0)."""
    import numpy as np

    from deepfm_tpu_torch.data.packing import pack_features, pack_schema
    from deepfm_tpu_torch.data.schema import (
        DatasetSchema,
        FeatureType,
        FieldSchema,
    )

    fields = {}
    for i in range(BENCH_FIELDS):
        fields[f"cat_{i}"] = FieldSchema(
            f"cat_{i}", FeatureType.SPARSE, vocab, width, "user" if i % 2 else "item")
    for j in range(dense_fields):
        fields[f"dense_{j}"] = FieldSchema(f"dense_{j}", FeatureType.DENSE, 0,
                                           width, "context")
    packed = pack_schema(DatasetSchema(fields=fields))
    rng = np.random.default_rng(seed)
    feats = {f"cat_{i}": rng.integers(1, vocab, BENCH_BATCH)
             for i in range(BENCH_FIELDS)}
    for j in range(dense_fields):
        feats[f"dense_{j}"] = rng.normal(size=BENCH_BATCH).astype(np.float32)
    labels = rng.integers(0, 2, BENCH_BATCH).astype(np.float32)
    return packed, pack_features(packed, feats, labels)


def head_rows(arrays, n: int):
    """The first ``n`` rows of a packed batch."""
    import dataclasses

    return dataclasses.replace(
        arrays, ids=arrays.ids[:n], dense=arrays.dense[:n],
        labels=arrays.labels[:n], weights=arrays.weights[:n])


def bench_config(device: str, compute_dtype: str = "bfloat16",
                 model_name: str = "deepfm", pallas: dict | None = None,
                 **training):
    """bench.py's config (bench.py:131-150) for the port; the CIN and
    attention sections keep their defaults, as bench.py does. ``pallas``
    sets the table layout or the row-gather lookup."""
    from deepfm_tpu_torch.config import config_from_dict

    return config_from_dict({
        "model_name": model_name,
        "device": device,
        "dnn": {"hidden_units": [512, 256, 128], "dropout": 0.0,
                "use_batch_norm": True},
        "training": {"batch_size": BENCH_BATCH, "compute_dtype": compute_dtype,
                     **training},
        "pallas": pallas or {},
    })


def paper_config(device: str, compute_dtype: str = "bfloat16", **training):
    """The xDeepFM paper's Criteo configuration for the port: Lian et al.,
    "xDeepFM: Combining Explicit and Implicit Feature Interactions for
    Recommender Systems", KDD 2018 (arXiv:1803.05170), section 4.1.3: field
    embedding dimension 10, 200 feature maps per CIN layer on Criteo, 400
    units per DNN layer, Adam at lr 0.001, batch 4096; CIN depth 3 (the
    depth study, section 4.3); every map of every layer pooled (its CIN has
    no split). BatchNorm, clip 1.0 and L2 1e-5 stay at the config
    defaults; dropout 0 and bf16 compute as bench.py runs."""
    from deepfm_tpu_torch.config import config_from_dict

    return config_from_dict({
        "model_name": "xdeepfm",
        "device": device,
        "feature": {"fm_embed_dim": PAPER_WIDTH},
        "cin": {"layer_sizes": list(PAPER_CIN), "split_half": False},
        "dnn": {"hidden_units": [400, 400], "dropout": 0.0},
        "training": {"batch_size": PAPER_BATCH, "compute_dtype": compute_dtype,
                     "lr": LR, **training},
    })


def autoint_config(device: str, compute_dtype: str = "bfloat16"):
    """AutoInt's Criteo configuration for the port (AUTOINT_*): no DNN, no
    dropout, Adam at lr 0.001, batch BENCH_BATCH, bf16 table moments, the
    default sparse-fused path on logical tables."""
    from deepfm_tpu_torch.config import config_from_dict

    return config_from_dict({
        "model_name": "autoint",
        "device": device,
        "feature": {"fm_embed_dim": AUTOINT_WIDTH},
        "attention": {"num_heads": AUTOINT_HEADS,
                      "attention_dim": AUTOINT_DIM,
                      "num_layers": AUTOINT_LAYERS},
        "dnn": {"hidden_units": [], "dropout": 0.0},
        "training": {"batch_size": BENCH_BATCH, "compute_dtype": compute_dtype,
                     "moments_dtype": "bfloat16", "lr": LR},
    })


def kernel_counters():
    """Every ported kernel's wrapper, whose ``launches`` counts its kernel's
    launches."""
    from deepfm_tpu_torch.ops.kernels import kernel_wrappers

    return kernel_wrappers()


def reset_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def snapshot(trainer) -> dict:
    """Host-independent copies of everything a step changes."""
    st = trainer.state
    out = {k: v.detach().clone()
           for k, v in trainer.model.state_dict().items()}
    for name, s in (st.table_opt or {}).items():
        out[f"{name}.mu"] = s.mu.clone()
        out[f"{name}.nu"] = s.nu.clone()
    return out


def first_step_grads(packed, arrays, device: str, cfg):
    """The loss and every parameter's gradient at the seeded initial weights
    of ``cfg``'s model: one train-mode forward and autograd backward on
    ``device``, the table's gradient densified by the kernel (CUDA) or its
    plain version (CPU)."""
    import torch

    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.training.steps import weighted_bce

    model = create_model(cfg.model_name, packed, cfg, device="cpu").to(device)
    model.train()
    ids, dense, labels, weights = batch_on(arrays, torch.device(device))
    loss = weighted_bce(model(ids, dense)[:, 0], labels, weights)
    names, params = zip(*model.named_parameters())
    # a leaf the model does not use (a baseline's) has a gradient of 0
    grads = torch.autograd.grad(loss, params, allow_unused=True,
                                materialize_grads=True)
    return loss.item(), {n: g.detach().cpu() for n, g in zip(names, grads)}


def grad_check(got: dict, want: dict, zero_gradient=None) -> dict:
    """Per leaf, max|got - want| over max|want| and ||got - want|| over
    ||want|| (a leaf of exact gradient 0, such as a BN-fed Dense bias,
    over its reference's: ``training/parity.py``, with the model's
    ``zero_gradient`` leaves), held to GRAD_MAX_REL and GRAD_NORM_REL."""
    from deepfm_tpu_torch.training.parity import zero_gradient_reference

    max_rel, norm_rel, failed = {}, {}, []
    for name, w in want.items():
        scale_of = zero_gradient_reference(name, zero_gradient) or name
        diff = got[name] - w
        ref = want[scale_of]
        max_rel[name] = diff.abs().max().item() / max(ref.abs().max().item(), 1e-30)
        norm_rel[name] = diff.norm().item() / max(ref.norm().item(), 1e-30)
        kind = "table" if "table_w" in name else "dense"
        if (not bool(got[name].isfinite().all())
                or max_rel[name] > GRAD_MAX_REL[kind]
                or norm_rel[name] > GRAD_NORM_REL):
            failed.append(name)
    return {"max_rel": max_rel, "norm_rel": norm_rel,
            "worst_max_rel": max(max_rel.values()),
            "worst_norm_rel": max(norm_rel.values()),
            "failed_leaves": failed, "ok": not failed}


def neighbour_slot(grad, dcol: int, pack: int):
    """A packed table gradient with each logical row's gradient moved to the
    next sub-slot of its physical row (the last to the first): what a packed
    densify that got its lane offset one slot wrong would return."""
    out = grad.clone()
    live = out[:, : pack * dcol].reshape(out.shape[0], pack, dcol)
    out[:, : pack * dcol] = live.roll(1, dims=1).reshape(out.shape[0], -1)
    return out


def phase_grads_card_vs_cpu(small, small_arrays,
                            model_name: str = "deepfm",
                            pallas: dict | None = None,
                            cfg=None, planted=None) -> dict:
    """First-step gradients, the card against the CPU, and the planted
    faults the check must refuse: three for DeepFM, GRAD_FAULTS' one for
    the other models, one (the neighbouring sub-slot) for packed tables.
    ``cfg`` (f32) replaces bench.py's config; ``planted`` = (name, a
    context manager factory) replaces the faults with the card's gradients
    taken again inside that context."""
    from deepfm_tpu_torch.models import create_model

    if cfg is None:
        cfg = bench_config("cpu", compute_dtype="float32",
                           model_name=model_name, pallas=pallas)
    zero = create_model(cfg.model_name, small, cfg,
                        device="cpu").zero_gradient_leaves
    cpu_loss, want = first_step_grads(small, small_arrays, "cpu", cfg)
    card_loss, got = first_step_grads(small, small_arrays, DEVICE, cfg)
    out = grad_check(got, want, zero)
    out["loss_rel_err"] = rel_err(card_loss, cpu_loss)
    table = next(n for n in got if "table_w" in n)
    if planted is not None:
        name, context = planted
        with context():
            faults = ((name, first_step_grads(small, small_arrays, DEVICE,
                                              cfg)[1]),)
    elif got[table].shape[1] == 128:  # packed
        faults = (("packed densify into the neighbouring sub-slot",
                   {**got, table: neighbour_slot(got[table], D, 128 // D)}),)
    elif model_name == "deepfm":
        flipped = {**got, "dnn.dense_1.weight": -got["dnn.dense_1.weight"]}
        dropped = {**got, table: got[table].clone()}
        dropped[table][want[table].abs().amax(dim=1).argmax()] = 0.0
        faults = (("dnn.dense_1.weight sign flipped", flipped),
                  ("largest table row dropped", dropped),
                  ("table gradient scaled by 1.05",
                   {**got, table: got[table] * 1.05}))
    else:
        leaf, factor = GRAD_FAULTS[model_name]
        faults = ((f"{leaf} scaled by {factor}",
                   {**got, leaf: got[leaf] * factor}),)
    controls = {}
    for name, fault in faults:
        c = grad_check(fault, want, zero)
        controls[name] = {"failed_leaves": c["failed_leaves"],
                          "worst_max_rel": c["worst_max_rel"],
                          "worst_norm_rel": c["worst_norm_rel"],
                          "refused": not c["ok"]}
    out["controls"] = controls
    out["ok"] = (out["ok"] and out["loss_rel_err"] <= TRAIN_TOL["cpu_loss_rel"]
                 and all(c["refused"] for c in controls.values()))
    return out


def profile_pad() -> None:
    import torch

    torch.cuda.synchronize()
    for _ in range(PROFILE_PAD):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


@contextlib.contextmanager
def profiling():
    """torch.profiler over the CPU and the card, the work padded on either
    side by PROFILE_PAD kernels of PAD_KERNEL."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profile_pad()
        yield prof
        profile_pad()


def profile_whole(prof) -> bool:
    """Whether every kernel launched between a profile's pads kept its
    device record (matched by correlation id)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    launches = sorted((e.start_ns(), e.correlation_id()) for e in events
                      if e.device_type() == DeviceType.CPU
                      and "Launch" in e.name() and "Kernel" in e.name())
    recorded = {e.correlation_id() for e in events
                if e.device_type() == DeviceType.CUDA}
    return all(cid in recorded
               for _, cid in launches[PROFILE_PAD:len(launches) - PROFILE_PAD])


def device_events(prof) -> list:
    """The profiler's device-side events (kernels, copies, fills), the
    pads' left out. A CPU op or autograd node also reports the device time
    of the kernels it launched as its own, so only these events are
    summed."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and PAD_KERNEL not in e.key]


def launch_breakdown(fn, calls: int = 3) -> dict:
    """torch.profiler over ``calls`` warm calls of ``fn``: the device time
    (ms) and launches a call of each device kernel, largest first, and
    their sum."""
    import torch

    fn()
    torch.cuda.synchronize()
    with profiling() as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = sorted(device_events(prof), key=lambda e: -e.self_device_time_total)
    return {
        "device_ms": sum(e.self_device_time_total for e in events) / 1e3 / calls,
        "kernels": {e.key[:70]: {"ms": e.self_device_time_total / 1e3 / calls,
                                 "launches": e.count / calls}
                    for e in events},
    }


def step_profile(step, watch=()) -> dict:
    """torch.profiler over one warm train step: the device's busy share of
    the host wall time and the device time by kernel; for each name in
    ``watch``, the launches of the device events whose name holds it.
    "whole" says whether every kernel of the step kept its device record
    (profile_whole)."""
    import torch

    with profiling() as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = device_events(prof)
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
        "device_busy_share": device_us / wall_us if wall_us else None,
        "device_kernels": sum(e.count for e in events),
        "whole": profile_whole(prof),
        "top_device_ms": {e.key[:70]: e.self_device_time_total / 1e3 for e in top},
        "watched": {w: sum(e.count for e in events if w in e.key)
                    for w in watch},
    }


def batch_on(arrays, dev):
    import torch

    return (torch.from_numpy(arrays.ids).to(dev),
            torch.from_numpy(arrays.dense).to(dev),
            torch.from_numpy(arrays.labels).to(dev),
            torch.ones(len(arrays.labels), device=dev))


def phase_train() -> dict:
    import torch

    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.training.parity import (
        ATOL,
        OUTSIDE_SHARE,
        RTOL,
        compare_leaves,
    )
    from deepfm_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    failures = []
    t0 = time.perf_counter()
    packed, arrays = bench_workload(BENCH_VOCAB)
    batch = batch_on(arrays, dev)
    config = bench_config(DEVICE)
    model = create_model("deepfm", packed, config, device=DEVICE)
    trainer = Trainer(model, packed, config)
    setup_s = time.perf_counter() - t0
    if trainer.path != "sparse_fused":
        fail(f"the default config took the {trainer.path} path")
    n_params = sum(p.numel() for p in model.parameters())

    # --- the main path (sparse-fused): counts start at 0 here -------------
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses = [trainer._train_step(*batch).item() for _ in range(2)]
    fused_state = snapshot(trainer)
    for _ in range(WARMUP_STEPS - 2):
        trainer._train_step(*batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_STEPS):
        s0 = time.perf_counter()
        loss = trainer._train_step(*batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - s0)
    profile = step_profile(lambda: trainer._train_step(*batch))
    torch.cuda.synchronize()
    fused_counts = read_counts()
    # --- end of the main path ----------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    last_loss = loss.item()
    del trainer, model
    free_device()

    # --- the two-pass path from the same weights: counts start at 0 -------
    config2 = bench_config(DEVICE, fused_backward=False)
    model2 = create_model("deepfm", packed, config2, device=DEVICE)
    trainer2 = Trainer(model2, packed, config2)
    reset_counts()
    losses2 = [trainer2._train_step(*batch).item() for _ in range(2)]
    torch.cuda.synchronize()
    two_pass_counts = read_counts()
    # --- end of the two-pass path -----------------------------------------
    if trainer2.path != "two_pass":
        failures.append(f"fused_backward: false took the {trainer2.path} path")
    paths_cmp = compare_leaves(snapshot(trainer2), fused_state, LR, steps=2)
    loss_rel = max(rel_err(a, b) for a, b in zip(losses, losses2))
    if loss_rel > TRAIN_TOL["loss_rel"] or paths_cmp["failed_leaves"]:
        failures.append(f"sparse-fused and two-pass differ: loss rel "
                        f"{loss_rel}, {paths_cmp}")
    del trainer2, model2, fused_state
    free_device()

    # --- the card against the CPU at 20k ids per field, f32 ---------------
    small, small_arrays = bench_workload(SMALL_VOCAB)
    grads_cmp = phase_grads_card_vs_cpu(small, small_arrays)
    if not grads_cmp["ok"]:
        failures.append(f"first-step gradients: the card differs from the "
                        f"CPU, or a planted fault passed: {grads_cmp}")
    cpu_cmp = {}
    for path, extra in (("sparse_fused", {}),
                        ("two_pass", {"fused_backward": False})):
        trainers = {}
        for device in ("cpu", DEVICE):
            cfg = bench_config(device, compute_dtype="float32",
                               moments_dtype="float32", **extra)
            m = create_model("deepfm", small, cfg, device="cpu")
            trainers[device] = Trainer(m, small, cfg)
        got_l, want_l = [], []
        for _ in range(2):
            got_l.append(trainers[DEVICE]._train_step(
                *batch_on(small_arrays, dev)).item())
            want_l.append(trainers["cpu"]._train_step(
                *batch_on(small_arrays, torch.device("cpu"))).item())
        cpu_model = trainers["cpu"].model
        untouched = torch.ones(cpu_model.embedding.table_w16.shape[0],
                               dtype=torch.bool)
        untouched[cpu_model.embedding.local_ids(0, torch.from_numpy(
            small_arrays.ids)).reshape(-1)] = False
        cmp = compare_leaves(snapshot(trainers[DEVICE]),
                             snapshot(trainers["cpu"]), LR, steps=2,
                             share_limit=False, untouched=untouched)
        cmp["loss_rel_err"] = max(rel_err(a, b) for a, b in zip(got_l, want_l))
        cmp["losses_card"], cmp["losses_cpu"] = got_l, want_l
        cpu_cmp[path] = cmp
        if cmp["loss_rel_err"] > TRAIN_TOL["cpu_loss_rel"] or cmp["failed_leaves"]:
            failures.append(f"{path}: the card differs from the CPU: {cmp}")
        del trainers
    free_device()

    for name in ("segment_sumsq", "sparse_table_adam"):
        if fused_counts[name] < 1:
            failures.append(f"{name} was not launched on the sparse-fused path")
    for name in ("densify_rows_grad", "fused_table_adam"):
        if two_pass_counts[name] < 1:
            failures.append(f"{name} was not launched on the two-pass path")
    finite = all(map(math.isfinite, losses + losses2 + [last_loss]))
    if not finite:
        failures.append("a loss is not finite")
    step_ms = 1e3 * statistics.median(times)
    out = {
        "phase": "train", "model": "deepfm", "path": "sparse_fused",
        "batch": BENCH_BATCH, "fields": BENCH_FIELDS, "vocab": BENCH_VOCAB,
        "table_rows": BENCH_FIELDS * BENCH_VOCAB, "n_params": n_params,
        "compute_dtype": "bfloat16", "moments_dtype": "bfloat16",
        "setup_s": setup_s, "losses": losses, "losses_two_pass": losses2,
        "last_loss": last_loss,
        "step_ms_median": step_ms, "step_ms_min": 1e3 * min(times),
        "step_ms_max": 1e3 * max(times), "timed_steps": TIMED_STEPS,
        "step_ms_all": [1e3 * t for t in times],
        "examples_per_s": BENCH_BATCH / (step_ms / 1e3),
        "peak_memory_gb": peak_gb, "profile_step": profile,
        "launches_sparse_fused": fused_counts,
        "launches_two_pass": two_pass_counts,
        "sparse_fused_vs_two_pass": {"loss_rel_err": loss_rel, **paths_cmp},
        "card_vs_cpu_20k_f32": cpu_cmp,
        "first_step_grads_card_vs_cpu_20k_f32": grads_cmp,
        "tol": {**TRAIN_TOL, "grad_max_rel": GRAD_MAX_REL,
                "grad_norm_rel": GRAD_NORM_REL, "rtol": RTOL, "atol": ATOL,
                "outside_share": OUTSIDE_SHARE},
        "ok": not failures,
    }
    emit(out)
    if failures:
        fail("; ".join(failures))
    return out


def timed_steps(trainer, batch) -> list:
    """Host-clock seconds of TIMED_STEPS train steps, each ending in a
    device synchronisation."""
    import torch

    times = []
    for _ in range(TIMED_STEPS):
        s0 = time.perf_counter()
        trainer._train_step(*batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - s0)
    return times


def unpack_snapshot(state: dict) -> dict:
    """A train-state snapshot with its packed table-shaped leaves (tables
    and their moments) unpacked to the logical layout."""
    from deepfm_tpu_torch.utils.layout import unpack_table

    rows = -(-BENCH_FIELDS * BENCH_VOCAB // 128) * 128  # the logical table's
    out = dict(state)
    for k, v in state.items():
        if "table_w" in k and v.dim() == 2 and v.shape[1] == 128:
            out[k] = unpack_table(v, D, PACK, rows)
    return out


def phase_train_packed() -> dict:
    """DeepFM at bench.py's full width on packed tables
    (pallas.table_layout: packed): the sparse-fused step timed and profiled
    (the main path of the packed sparse_table_adam); 2 steps against the
    logical sparse-fused step from the same logical weights; the packed
    two-pass step (the main path of the packed densify) against the packed
    sparse-fused one; the row-gather lookup (use_embedding_kernel, its main
    path) against the default two-pass step; and at 20k ids in f32 the
    packed first-step gradients on the card against the CPU, with a planted
    fault the check must refuse."""
    import torch

    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.training.parity import compare_leaves
    from deepfm_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    failures = []
    packed_cfg = {"table_layout": "packed"}
    packed, arrays = bench_workload(BENCH_VOCAB)
    batch = batch_on(arrays, dev)

    def trainer_for(pallas=None, **training):
        cfg = bench_config(DEVICE, pallas=pallas, **training)
        return Trainer(create_model("deepfm", packed, cfg, device=DEVICE),
                       packed, cfg)

    t0 = time.perf_counter()
    trainer = trainer_for(packed_cfg)
    setup_s = time.perf_counter() - t0
    table_shape = tuple(trainer.params["embedding.table_w16"].shape)
    if trainer.path != "sparse_fused" or table_shape != (
            packed_rows_of(BENCH_FIELDS * BENCH_VOCAB), 128):
        fail(f"packed config: path {trainer.path}, table {table_shape}")

    # --- the main path (packed, sparse-fused): counts start at 0 here ------
    reset_counts()
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    losses = [trainer._train_step(*batch).item() for _ in range(2)]
    packed_state = snapshot(trainer)
    for _ in range(WARMUP_STEPS - 2):
        trainer._train_step(*batch)
    torch.cuda.synchronize()
    times = timed_steps(trainer, batch)
    profile = step_profile(lambda: trainer._train_step(*batch))
    torch.cuda.synchronize()
    fused_counts = read_counts()
    # --- end of the main path ----------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    last_loss = trainer._train_step(*batch).item()
    for name in ("segment_sumsq", "sparse_table_adam"):
        if fused_counts[name] < 1:
            failures.append(f"{name} was not launched on the packed step")

    # --- logical sparse-fused from the same logical weights ----------------
    logical = trainer_for()
    losses_logical = [logical._train_step(*batch).item() for _ in range(2)]
    logical_state = snapshot(logical)
    unpacked = unpack_snapshot(packed_state)
    layouts_cmp = compare_leaves(unpacked, logical_state, LR, steps=2)
    layouts_cmp["loss_rel_err"] = max(
        rel_err(a, b) for a, b in zip(losses, losses_logical))
    layouts_cmp["bit_equal_leaves"] = sum(
        bool(torch.equal(unpacked[k], v)) for k, v in logical_state.items())
    layouts_cmp["leaves"] = len(logical_state)
    del unpacked, logical_state
    if layouts_cmp["loss_rel_err"] > TRAIN_TOL["loss_rel"] \
            or layouts_cmp["failed_leaves"]:
        failures.append(f"packed and logical sparse-fused differ: {layouts_cmp}")
    # the two layouts' steps timed in turns in this process (logical,
    # packed, logical), each window after the packed main path above, with
    # the device memory one step takes beyond what is allocated before it
    logical._train_step(*batch)
    windows = {"packed_main_path": times}
    for label, t in (("logical_1", logical), ("packed_2", trainer),
                     ("logical_2", logical)):
        windows[label] = timed_steps(t, batch)
    step_extra_gb = {}
    for label, t in (("logical", logical), ("packed", trainer)):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t._train_step(*batch)
        torch.cuda.synchronize()
        step_extra_gb[label] = (torch.cuda.max_memory_allocated() - before) / 1e9
    packed_ms = [1e3 * x for k, v in windows.items() if "packed" in k for x in v]
    logical_ms = [1e3 * x for k, v in windows.items() if "logical" in k for x in v]
    turns = {
        "window_median_ms": {k: 1e3 * statistics.median(v)
                             for k, v in windows.items()},
        "packed_median_ms": statistics.median(packed_ms),
        "logical_median_ms": statistics.median(logical_ms),
        "step_extra_memory_gb": step_extra_gb,
    }
    del trainer, logical
    free_device()

    # --- packed two-pass from the same weights: counts start at 0 ----------
    two_pass = trainer_for(packed_cfg, fused_backward=False)
    reset_counts()
    losses_two_pass = [two_pass._train_step(*batch).item() for _ in range(2)]
    torch.cuda.synchronize()
    two_pass_counts = read_counts()
    # --- end of the packed two-pass path ----------------------------------
    if two_pass.path != "two_pass":
        failures.append(f"fused_backward: false took the {two_pass.path} path")
    paths_cmp = compare_leaves(snapshot(two_pass), packed_state, LR, steps=2)
    paths_cmp["loss_rel_err"] = max(
        rel_err(a, b) for a, b in zip(losses, losses_two_pass))
    del two_pass, packed_state
    free_device()
    if paths_cmp["loss_rel_err"] > TRAIN_TOL["loss_rel"] \
            or paths_cmp["failed_leaves"]:
        failures.append(f"packed two-pass and sparse-fused differ: {paths_cmp}")
    for name in ("densify_rows_grad_packed", "fused_table_adam"):
        if two_pass_counts[name] < 1:
            failures.append(f"{name} was not launched on the packed two-pass path")

    # --- the row-gather lookup (use_embedding_kernel): counts start at 0 ---
    gather = trainer_for({"use_embedding_kernel": True})
    reset_counts()
    losses_gather = [gather._train_step(*batch).item() for _ in range(2)]
    torch.cuda.synchronize()
    gather_counts = read_counts()
    # --- end of the row-gather path ---------------------------------------
    gather_state = snapshot(gather)
    if gather.path != "two_pass" or gather.model.table_layout != "logical":
        failures.append(f"use_embedding_kernel took {gather.path} on "
                        f"{gather.model.table_layout} tables")
    del gather
    default = trainer_for(fused_backward=False)
    losses_default = [default._train_step(*batch).item() for _ in range(2)]
    default_state = snapshot(default)
    del default
    gather_cmp = compare_leaves(gather_state, default_state, LR, steps=2)
    gather_cmp["loss_rel_err"] = max(
        rel_err(a, b) for a, b in zip(losses_gather, losses_default))
    gather_cmp["bit_equal_leaves"] = sum(
        bool(torch.equal(gather_state[k], v)) for k, v in default_state.items())
    gather_cmp["leaves"] = len(default_state)
    del gather_state, default_state
    free_device()
    if gather_cmp["loss_rel_err"] > TRAIN_TOL["loss_rel"] \
            or gather_cmp["failed_leaves"]:
        failures.append(f"the row-gather lookup and the default differ: {gather_cmp}")
    if gather_counts["row_gather"] < 1 or gather_counts["densify_rows_grad"] < 1:
        failures.append(f"row_gather or its backward was not launched: {gather_counts}")

    # --- the card against the CPU at 20k ids per field, f32, packed --------
    small, small_arrays = bench_workload(SMALL_VOCAB)
    grads_cmp = phase_grads_card_vs_cpu(small, small_arrays, pallas=packed_cfg)
    if not grads_cmp["ok"]:
        failures.append(f"packed first-step gradients: the card differs from "
                        f"the CPU, or the planted fault passed: {grads_cmp}")
    free_device()

    all_losses = (losses + losses_logical + losses_two_pass + losses_gather
                  + losses_default + [last_loss])
    if not all(map(math.isfinite, all_losses)):
        failures.append("a loss is not finite")
    step_ms = 1e3 * statistics.median(times)
    out = {
        "phase": "train_packed", "model": "deepfm", "path": "sparse_fused",
        "table_layout": "packed", "table_shape": list(table_shape),
        "batch": BENCH_BATCH, "fields": BENCH_FIELDS, "vocab": BENCH_VOCAB,
        "compute_dtype": "bfloat16", "moments_dtype": "bfloat16",
        "setup_s": setup_s, "losses": losses, "last_loss": last_loss,
        "step_ms_median": step_ms, "step_ms_min": 1e3 * min(times),
        "step_ms_max": 1e3 * max(times), "timed_steps": TIMED_STEPS,
        "step_ms_all": [1e3 * t for t in times],
        "examples_per_s": BENCH_BATCH / (step_ms / 1e3),
        "allocated_gb_at_start": start_gb, "peak_memory_gb": peak_gb,
        "profile_step": profile, "packed_and_logical_in_turns": turns,
        "launches_sparse_fused": fused_counts,
        "launches_two_pass": two_pass_counts,
        "launches_row_gather": gather_counts,
        "packed_vs_logical_sparse_fused": layouts_cmp,
        "two_pass_vs_sparse_fused": paths_cmp,
        "row_gather_vs_default_two_pass": gather_cmp,
        "first_step_grads_card_vs_cpu_20k_f32": grads_cmp,
        "ok": not failures,
    }
    emit(out)
    if failures:
        fail("; ".join(failures))
    return out


def phase_train_models() -> dict:
    """xDeepFM and AttentionDeepFM at bench.py's full width on the default
    (sparse-fused) path, each model's steps its own main path; then their
    first-step gradients on the card against the CPU."""
    import torch

    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    packed, arrays = bench_workload(BENCH_VOCAB)
    batch = batch_on(arrays, dev)
    small, small_arrays = bench_workload(SMALL_VOCAB)
    small_arrays = head_rows(small_arrays, GRAD_BATCH)
    results, failures = {}, []
    for name in TRAIN_MODELS:
        t0 = time.perf_counter()
        config = bench_config(DEVICE, model_name=name)
        model = create_model(name, packed, config, device=DEVICE)
        trainer = Trainer(model, packed, config)
        setup_s = time.perf_counter() - t0
        if trainer.path != "sparse_fused":
            failures.append(f"{name}: the default config took the "
                            f"{trainer.path} path")
        # --- this model's main path: counts start at 0 here --------------
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        losses = [trainer._train_step(*batch).item()
                  for _ in range(WARMUP_STEPS)]
        times = []
        for _ in range(TIMED_STEPS):
            s0 = time.perf_counter()
            loss = trainer._train_step(*batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - s0)
        watch = PROFILE_WATCH.get(name, ())
        profiles = [step_profile(lambda: trainer._train_step(*batch), watch)]
        torch.cuda.synchronize()
        counts = read_counts()
        # --- end of the main path ------------------------------------------
        # AttentionDeepFM's kernels must show in each of PROFILED_STEPS
        # profiled steps whose profile is whole (the profiler once lost the
        # attention forward's record); a step whose profile lost a record is
        # profiled again, at most PROFILE_RETRIES times (PROFILE_PAD). The
        # further profiled steps run outside the counted window,
        # so every model's counts cover the same WARMUP_STEPS + TIMED_STEPS
        # + 1 steps
        for _ in range(PROFILED_STEPS - 1 + PROFILE_RETRIES if watch else 0):
            if sum(p["whole"] for p in profiles) == PROFILED_STEPS:
                break
            profiles.append(
                step_profile(lambda: trainer._train_step(*batch), watch))
        whole = [p for p in profiles if p["whole"]]
        profile = whole[0] if whole else profiles[0]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = WARMUP_STEPS + TIMED_STEPS + 1
        if watch and len(whole) < PROFILED_STEPS:
            failures.append(f"{name}: {len(whole)} of {len(profiles)} "
                            f"profiled steps kept every kernel's device "
                            f"event, expected {PROFILED_STEPS}")
        for i, prof in enumerate(profiles):
            if not prof["whole"]:
                continue
            for kernel, n in prof["watched"].items():
                if n != config.attention.num_layers:
                    failures.append(f"{name}: profiled step {i} shows {n} "
                                    f"{kernel} launches, expected "
                                    f"{config.attention.num_layers}")
        if name == "xdeepfm":
            # bf16 operands: every forward and backward on the tensor-core
            # kernels
            expected = {"cin_stack_fwd_mma": steps, "cin_stack_fwd": 0,
                        "cin_stack_bwd_mma": steps, "cin_stack_bwd": 0}
        else:
            blocks = config.attention.num_layers
            expected = {"attention_block_fwd": steps * blocks,
                        "attention_block_bwd": steps * blocks}
        for kernel, n in expected.items():
            if counts[kernel] != n:
                failures.append(f"{name}: {kernel} launched {counts[kernel]} "
                                f"times in {steps} steps, expected {n}")
        for kernel in ("segment_sumsq", "sparse_table_adam"):
            if counts[kernel] < 1:
                failures.append(f"{name}: {kernel} was not launched")
        losses.append(loss.item())
        if not all(map(math.isfinite, losses)):
            failures.append(f"{name}: a loss is not finite: {losses}")
        n_params = sum(p.numel() for p in model.parameters())
        del trainer, model
        free_device()

        # the f32 first-step gradients run the f32 kernels: their own path
        reset_counts()
        grads = phase_grads_card_vs_cpu(small, small_arrays, name)
        torch.cuda.synchronize()
        grad_counts = read_counts()
        if name == "xdeepfm" and (grad_counts["cin_stack_bwd"] < 1
                                  or grad_counts["cin_stack_bwd_mma"] != 0):
            failures.append(f"{name}: the f32 first-step gradients did not "
                            f"take the f32 stack backward: {grad_counts}")
        if not grads["ok"]:
            failures.append(f"{name}: first-step gradients: the card differs "
                            f"from the CPU, or a planted fault passed: {grads}")
        step_ms = 1e3 * statistics.median(times)
        rec = {
            "phase": "train_models", "model": name, "path": "sparse_fused",
            "batch": BENCH_BATCH, "fields": BENCH_FIELDS, "vocab": BENCH_VOCAB,
            "n_params": n_params, "compute_dtype": "bfloat16",
            "moments_dtype": "bfloat16", "setup_s": setup_s,
            "losses": losses, "step_ms_median": step_ms,
            "step_ms_min": 1e3 * min(times), "step_ms_max": 1e3 * max(times),
            "timed_steps": TIMED_STEPS, "step_ms_all": [1e3 * t for t in times],
            "examples_per_s": BENCH_BATCH / (step_ms / 1e3),
            "peak_memory_gb": peak_gb, "profile_step": profile,
            "profiled_steps_watched": [p["watched"] for p in profiles],
            "profiled_steps_whole": [p["whole"] for p in profiles],
            "profiled_steps_device_ms": [p["device_ms"] for p in profiles],
            "launches": counts, "launches_expected": expected,
            "launches_first_step_grads_f32": grad_counts,
            "first_step_grads_card_vs_cpu_20k_f32": {
                "batch": GRAD_BATCH, **grads},
            "tol": {"grad_max_rel": GRAD_MAX_REL,
                    "grad_norm_rel": GRAD_NORM_REL,
                    "cpu_loss_rel": TRAIN_TOL["cpu_loss_rel"]},
        }
        rec["ok"] = not [f for f in failures if f.startswith(name)]
        emit(rec)
        results[name] = rec
    if failures:
        fail("; ".join(failures))
    return results


@contextlib.contextmanager
def dw_from_wrong_hidden():
    """A planted fault of the CIN stack's layers-route backward: layer 1's
    dW taken from layer 2's input hidden state (layer 1's own output)
    instead of layer 1's input, what an off-by-one in the remat's hidden
    states would give. The adjoint loop runs from the last layer, so layer
    1 is the second call of ``cin_compress_backward``."""
    from deepfm_tpu_torch.ops.kernels import cin_stack

    real = cin_stack.cin_compress_backward
    hiddens = []

    def faulty(g, hidden, x0, w):
        hiddens.append(hidden)
        dhid, dx0, dw, db = real(g, hidden, x0, w)
        if len(hiddens) == 2:
            dw = real(g, hiddens[0], x0, w)[2]
        return dhid, dx0, dw, db

    cin_stack.cin_compress_backward = faulty
    try:
        yield
    finally:
        cin_stack.cin_compress_backward = real


def phase_train_xdeepfm_paper() -> dict:
    """The xDeepFM paper's Criteo configuration (paper_config) on bench.py's
    workload at width 10, on the default sparse-fused path with logical
    tables. Its bf16 steps run the stack forward and the stack backward on
    the tensor cores (the streamed layout of the backward's plan). Its f32
    steps, at 20k ids, run the backward by the layers route, the main path
    of cin_compress. Then its f32 first-step gradients on the card against
    the CPU, with a planted fault that must be refused."""
    import torch

    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.ops.kernels.cin_stack import stack_route
    from deepfm_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    failures = []
    t0 = time.perf_counter()
    packed, arrays = bench_workload(BENCH_VOCAB, PAPER_WIDTH)
    batch = batch_on(head_rows(arrays, PAPER_BATCH), dev)
    config = paper_config(DEVICE)
    model = create_model("xdeepfm", packed, config, device=DEVICE)
    trainer = Trainer(model, packed, config)
    setup_s = time.perf_counter() - t0
    routes = {(("backward" if bwd else "forward") + f"_{mode}"): stack_route(
        PAPER_BATCH, packed.num_fields, PAPER_WIDTH, PAPER_CIN, False, bwd,
        bf16=mode == "bf16") for bwd in (False, True) for mode in ("bf16", "f32")}
    if trainer.path != "sparse_fused" or routes != {
            "forward_bf16": "stack", "forward_f32": "stack",
            "backward_bf16": "stack", "backward_f32": "layers"}:
        fail(f"paper config: path {trainer.path}, CIN routes {routes}")
    n_params = sum(p.numel() for p in model.parameters())
    table_bytes = sum(p.numel() * p.element_size()
                      for n, p in model.named_parameters() if "table_w" in n)

    # --- the main path: counts start at 0 here ------------------------------
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses = [trainer._train_step(*batch).item() for _ in range(WARMUP_STEPS)]
    times = timed_steps(trainer, batch)
    profile = step_profile(lambda: trainer._train_step(*batch))
    torch.cuda.synchronize()
    counts = read_counts()
    # --- end of the main path ------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses.append(trainer._train_step(*batch).item())
    steps = WARMUP_STEPS + TIMED_STEPS + 1
    expected = {"cin_stack_fwd_mma": steps, "cin_stack_fwd": 0,
                "cin_compress": 0, "cin_stack_bwd": 0,
                "cin_stack_bwd_mma": steps}
    for kernel, n in expected.items():
        if counts[kernel] != n:
            failures.append(f"{kernel} launched {counts[kernel]} times in "
                            f"{steps} steps, expected {n}")
    for kernel in ("segment_sumsq", "sparse_table_adam"):
        if counts[kernel] < 1:
            failures.append(f"{kernel} was not launched")
    if not all(map(math.isfinite, losses)):
        failures.append(f"a loss is not finite: {losses}")

    # a deleted trainer's device memory goes back by reference count alone
    gc.disable()
    try:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        del trainer, model
        freed = before - torch.cuda.memory_allocated()
    finally:
        gc.enable()
    if freed < table_bytes:
        failures.append(f"deleting the trainer freed {freed} bytes without "
                        f"the cycle collector, less than its {table_bytes} "
                        f"bytes of tables")
    free_device()

    # the f32 configuration's train path at 20k ids: its backward takes the
    # layers route, the main path of cin_compress (three a step)
    small, small_arrays = bench_workload(SMALL_VOCAB, PAPER_WIDTH)
    cfg32 = paper_config(DEVICE, compute_dtype="float32")
    model32 = create_model("xdeepfm", small, cfg32, device=DEVICE)
    trainer32 = Trainer(model32, small, cfg32)
    batch32 = batch_on(head_rows(small_arrays, PAPER_BATCH), dev)
    trainer32._train_step(*batch32).item()
    reset_counts()
    f32_losses = [trainer32._train_step(*batch32).item()
                  for _ in range(F32_TRAIN_STEPS)]
    torch.cuda.synchronize()
    f32_counts = read_counts()
    del trainer32, model32, batch32
    free_device()
    expected_f32 = {"cin_stack_fwd": F32_TRAIN_STEPS, "cin_stack_fwd_mma": 0,
                    "cin_compress": F32_TRAIN_STEPS * len(PAPER_CIN),
                    "cin_stack_bwd": 0, "cin_stack_bwd_mma": 0}
    for kernel, n in expected_f32.items():
        if f32_counts[kernel] != n:
            failures.append(f"f32: {kernel} launched {f32_counts[kernel]} "
                            f"times in {F32_TRAIN_STEPS} steps, expected {n}")
    if not all(map(math.isfinite, f32_losses)):
        failures.append(f"an f32 loss is not finite: {f32_losses}")

    small_arrays = head_rows(small_arrays, GRAD_BATCH)
    reset_counts()
    grads = phase_grads_card_vs_cpu(
        small, small_arrays, cfg=paper_config("cpu", compute_dtype="float32"),
        planted=("layer 1's dW from layer 2's input hidden state",
                 dw_from_wrong_hidden))
    grad_counts = read_counts()
    if grad_counts["cin_compress"] < 1 or grad_counts["cin_stack_bwd_mma"]:
        failures.append(f"the f32 first-step gradients did not take the "
                        f"layers route: {grad_counts}")
    if not grads["ok"]:
        failures.append(f"first-step gradients: the card differs from the "
                        f"CPU, or the planted fault passed: {grads}")
    free_device()
    step_ms = 1e3 * statistics.median(times)
    out = {
        "phase": "train_xdeepfm_paper", "model": "xdeepfm",
        "path": "sparse_fused", "table_layout": "logical",
        "source": "Lian et al., KDD 2018 (arXiv:1803.05170), 4.1.3",
        "batch": PAPER_BATCH, "fields": BENCH_FIELDS, "vocab": BENCH_VOCAB,
        "width": PAPER_WIDTH, "cin": list(PAPER_CIN), "split_half": False,
        "dnn": [400, 400], "n_params": n_params, "compute_dtype": "bfloat16",
        "moments_dtype": "bfloat16", "cin_routes": routes, "setup_s": setup_s,
        "losses": losses, "step_ms_median": step_ms,
        "step_ms_min": 1e3 * min(times), "step_ms_max": 1e3 * max(times),
        "timed_steps": TIMED_STEPS, "step_ms_all": [1e3 * t for t in times],
        "examples_per_s": PAPER_BATCH / (step_ms / 1e3),
        "peak_memory_gb": peak_gb, "profile_step": profile,
        "launches": counts, "launches_expected": expected,
        "f32_train": {"vocab": SMALL_VOCAB, "steps": F32_TRAIN_STEPS,
                      "losses": f32_losses, "launches": f32_counts,
                      "launches_expected": expected_f32},
        "launches_first_step_grads_f32": grad_counts,
        "freed_without_gc_gb": freed / 1e9, "table_gb": table_bytes / 1e9,
        "first_step_grads_card_vs_cpu_20k_f32": {"batch": GRAD_BATCH, **grads},
        "tol": {"grad_max_rel": GRAD_MAX_REL, "grad_norm_rel": GRAD_NORM_REL,
                "cpu_loss_rel": TRAIN_TOL["cpu_loss_rel"]},
        "ok": not failures,
    }
    emit(out)
    if failures:
        fail("; ".join(failures))
    return out


def phase_train_autoint() -> dict:
    """AutoInt at its Criteo widths (autoint_config) on bench.py's workload
    with Criteo's 13 dense fields (F = 39), through create_model and
    Trainer on the default sparse-fused path in bf16: the launches of its
    WARMUP_STEPS + TIMED_STEPS steps, counted from 0, must be exactly one
    interacting_fwd and one interacting_bwd a layer a step (the backward's
    reduce kernel is part of its wrapper's call), each backward on the
    tiled core (interacting_bwd_tiled), and the table update's kernels must
    run."""
    import torch

    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.ops.kernels.attention import interacting_backward
    from deepfm_tpu_torch.training.trainer import Trainer
    from deepfm_tpu_torch.utils import tracing

    dev = torch.device(DEVICE)
    failures = []
    t0 = time.perf_counter()
    packed, arrays = bench_workload(BENCH_VOCAB, AUTOINT_WIDTH,
                                    dense_fields=AUTOINT_DENSE)
    batch = batch_on(arrays, dev)
    config = autoint_config(DEVICE)
    model = create_model("autoint", packed, config, device=DEVICE)
    trainer = Trainer(model, packed, config)
    setup_s = time.perf_counter() - t0
    if trainer.path != "sparse_fused" or packed.num_fields != (
            BENCH_FIELDS + AUTOINT_DENSE):
        fail(f"autoint: path {trainer.path}, {packed.num_fields} fields")

    # --- the main path: counts start at 0 here ------------------------------
    reset_counts()
    interacting_backward.tiled_launches = 0
    torch.cuda.reset_peak_memory_stats()
    traced = tracing.snapshot()
    tracing.enable()
    losses = [trainer._train_step(*batch).item() for _ in range(WARMUP_STEPS)]
    times = timed_steps(trainer, batch)
    torch.cuda.synchronize()
    tracing.disable()
    counters = tracing.since(traced)["counters"]
    counts = read_counts()
    counts["interacting_bwd_tiled"] = interacting_backward.tiled_launches
    # --- end of the main path ------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = WARMUP_STEPS + TIMED_STEPS
    expected = {"interacting_fwd": steps * AUTOINT_LAYERS,
                "interacting_bwd": steps * AUTOINT_LAYERS,
                "interacting_bwd_tiled": steps * AUTOINT_LAYERS,
                "attention_block_fwd": 0, "attention_block_bwd": 0}
    for kernel, n in expected.items():
        if counts[kernel] != n:
            failures.append(f"{kernel} launched {counts[kernel]} times in "
                            f"{steps} steps, expected {n}")
    for kernel in ("segment_sumsq", "sparse_table_adam"):
        if counts[kernel] < 1:
            failures.append(f"{kernel} was not launched")
    rows = steps * AUTOINT_LAYERS * BENCH_BATCH * packed.num_fields
    if not (counters.get("attention.rows") == rows
            == counters.get("attention.tiled_core_rows")):
        failures.append(f"attention counters {counters}, expected {rows} "
                        "rows, every one on the tiled core")
    if not all(map(math.isfinite, losses)):
        failures.append(f"a loss is not finite: {losses}")
    del trainer, model, batch
    free_device()
    step_ms = 1e3 * statistics.median(times)
    out = {
        "phase": "train_autoint", "model": "autoint", "path": "sparse_fused",
        "table_layout": "logical",
        "source": "Song et al., CIKM 2019 (arXiv:1810.11921), 5.1.3",
        "batch": BENCH_BATCH, "fields": packed.num_fields,
        "vocab": BENCH_VOCAB, "width": AUTOINT_WIDTH, "heads": AUTOINT_HEADS,
        "attention_dim": AUTOINT_DIM, "layers": AUTOINT_LAYERS,
        "compute_dtype": "bfloat16", "setup_s": setup_s, "losses": losses,
        "step_ms_median": step_ms, "step_ms_min": 1e3 * min(times),
        "step_ms_max": 1e3 * max(times),
        "examples_per_s": BENCH_BATCH / (step_ms / 1e3),
        "peak_memory_gb": peak_gb, "launches": counts,
        "launches_expected": expected, "attention_counters": counters,
        "ok": not failures,
    }
    emit(out)
    if failures:
        fail("; ".join(failures))
    return out


def interacting_kernel_rows(attn: dict, autoint: dict) -> list:
    """The kernels line's rows of the interacting layer's two kernels: their
    launches on AutoInt's train step (train_autoint), their numbers at
    layers 2-3's shape (autoint_l23_bf16) and, under ``layer_1``, at layer
    1's (autoint_l1_bf16). They port no TPU kernel (the JAX package has no
    AutoInt)."""
    rows = []
    for name, source, kind in (
            ("interacting_fwd", "attention_block.cu", "forward"),
            ("interacting_bwd", "attention_bwd.cu", "backward")):
        rec = attn["autoint_l23_bf16"][kind]
        rec1 = attn["autoint_l1_bf16"][kind]
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        rows.append({"name": name, "route": "cuda",
                     "source": f"deepfm_tpu_torch/csrc/{source}",
                     "replaces": None,
                     "launches": autoint["launches"][name],
                     **{k: rec[k] for k in keys},
                     "layer_1": {k: rec1[k] for k in keys}})
    return rows


def _http(method: str, url: str, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        body = json.loads(r.read())
        status = r.status
    return status, body, 1e3 * (time.perf_counter() - t0)


def request_breakdown(transform, packed, predictor, reps: int = 5) -> dict:
    """Median host-clock ms of the three host/device stages of a request:
    the adapter's feature transform, packing, and the predictor (H2D copy,
    model, D2H fetch; it ends in a host fetch, so the device is done)."""
    t = {"transform": [], "pack": [], "predict": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        ds = transform()
        t1 = time.perf_counter()
        arrays = ds.pack(packed)
        t2 = time.perf_counter()
        predictor.predict(arrays)
        t3 = time.perf_counter()
        t["transform"].append(t1 - t0)
        t["pack"].append(t2 - t1)
        t["predict"].append(t3 - t2)
    out = {k: 1e3 * statistics.median(v) for k, v in t.items()}
    out["rows"] = len(arrays)
    return out


def device_profile(predictor, arrays) -> dict:
    """torch.profiler over one warm predict: device time by kernel and the
    device's busy share of the host wall time."""
    import torch

    predictor.predict(arrays)
    with profiling() as prof:
        t0 = time.perf_counter()
        predictor.predict(arrays)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = device_events(prof)
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "rows": len(arrays), "wall_ms": wall_us / 1e3,
        "device_ms": device_us / 1e3,
        "device_busy_share": device_us / wall_us if wall_us else None,
        "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
    }


def phase_serve(tmp: Path, config_file: str, saved_layout: str) -> dict:
    """The serve path of ``config_file`` (logical tables) over a seeded
    random checkpoint written in ``saved_layout``; a packed checkpoint is
    also served under the same config with packed tables, whose scores
    must agree within SERVE_LAYOUT_TOL."""
    import numpy as np
    import torch

    from deepfm_tpu_torch.cli import _build_data, _restore_predictor
    from deepfm_tpu_torch.config import load_config
    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.serving import ScoringService, make_http_server
    from deepfm_tpu_torch.training.persistence import load_best, save_best
    from deepfm_tpu_torch.training.predict import Predictor

    t0 = time.perf_counter()
    data_dir = movielens_data(tmp)
    config = load_config(
        REPO / "configs" / config_file,
        [f"data.data_dir={data_dir}",
         f"output_dir={tmp / Path(config_file).stem}", "device=cuda"],
    )
    # seeded random weights stand in for a trained checkpoint
    _, _, packed0, _, _, _ = _build_data(config)
    saved_config = dataclasses.replace(config, pallas=dataclasses.replace(
        config.pallas, table_layout=saved_layout))
    save_best(create_model(config.model_name, packed0, saved_config,
                           device="cpu"), config.output_dir)
    setup_s = time.perf_counter() - t0
    kernel = {"xdeepfm": "cin_stack_fwd",
              "attention_deepfm": "attention_block_fwd"}[config.model_name]

    # --- the main path: every kernel count starts at 0 here -------------
    reset_counts()
    t0 = time.perf_counter()
    adapter, packed, _, _, model, predictor, _ = _restore_predictor(
        config, require=("serve", "score_id_pairs", "known_pair",
                         "now_timestamp", "recommend_candidates"),
    )
    service = ScoringService(adapter, packed, predictor, config.model_name)
    service.warmup()
    prologue_s = time.perf_counter() - t0
    server = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = "http://%s:%d" % server.server_address
        raw = np.loadtxt(data_dir / "u.data", dtype=np.int64)
        pick = np.random.default_rng(0).choice(len(raw), 300, replace=False)
        rows = [[int(u), int(m)] for u, m in raw[pick, :2]]
        rows.append([10**9, rows[0][1]])  # unknown user -> null
        user = rows[0][0]
        st_h, health, health_ms = _http("GET", f"{base}/health")
        st_s, scored, score_ms = _http("POST", f"{base}/score", {"rows": rows})
        st_r, rec, rec_ms = _http("GET", f"{base}/recommend?user={user}&k=10")
        torch.cuda.synchronize()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    launches = {kernel: read_counts()[kernel]}
    # --- end of the main path --------------------------------------------

    failures = []
    if (st_h, st_s, st_r) != (200, 200, 200):
        failures.append(f"HTTP status {st_h}/{st_s}/{st_r}")
    if health.get("status") != "ok" or health.get("n_params") != predictor.n_params:
        failures.append(f"/health answered {health}")
    scores = scored["scores"]
    if scores[-1] is not None or scored["n_scored"] != len(rows) - 1:
        failures.append("unknown id was scored, or a known one was not")
    served = np.asarray(scores[:-1], np.float64)
    if not (np.isfinite(served).all() and (served >= 0).all() and (served <= 1).all()):
        failures.append("served scores are not finite probabilities")
    items = rec["items"]
    rec_scores = [it["score"] for it in items]
    if len(items) != 10 or rec_scores != sorted(rec_scores, reverse=True):
        failures.append(f"/recommend answered {rec}")

    # reference: the same checkpoint on the CPU, where the plain version runs
    cpu_model = create_model(config.model_name, packed, config, device="cpu")
    load_best(cpu_model, config.output_dir)
    cpu = Predictor(cpu_model, packed, config, device="cpu")
    users = np.asarray([r[0] for r in rows[:-1]])
    ds, kept = adapter.score_id_pairs(users, np.asarray([r[1] for r in rows[:-1]]))
    want = cpu.predict(ds.pack(packed))
    score_err = float(np.abs(served[kept] - want).max())
    cds, cand = adapter.recommend_candidates(user)
    cwant = dict(zip(cand.tolist(), cpu.predict(cds.pack(packed)).tolist()))
    rec_err = max(abs(it["score"] - cwant[it["item"]]) for it in items)
    breakdown = {
        "score": request_breakdown(
            lambda: adapter.score_id_pairs(users, np.asarray([r[1] for r in rows[:-1]]))[0],
            packed, predictor),
        "recommend": request_breakdown(
            lambda: adapter.recommend_candidates(user)[0], packed, predictor),
    }
    profile = device_profile(predictor, cds.pack(packed))
    if max(score_err, rec_err) > SERVE_TOL:
        failures.append(f"served scores differ from the CPU by {score_err}/{rec_err}")
    if launches[kernel] < 1:
        failures.append(f"{kernel} was not launched on the serve path")
    layouts = None
    if saved_layout == "packed":
        # the packed checkpoint under the same config with packed tables
        packed_config = dataclasses.replace(config, pallas=dataclasses.replace(
            config.pallas, table_layout="packed"))
        *_, pmodel, ppredictor, _ = _restore_predictor(packed_config)
        pgot = ppredictor.predict(ds.pack(packed))
        layouts = {
            "served_table_shapes": {
                n: list(t.shape) for n, t in pmodel.named_parameters()
                if "table_w" in n},
            "max_abs_err_packed_vs_logical_config":
                float(np.abs(pgot - served[kept]).max()),
            "tol": SERVE_LAYOUT_TOL,
        }
        if not all(shape[1] == 128
                   for shape in layouts["served_table_shapes"].values()):
            failures.append(f"the packed config served {layouts}")
        if layouts["max_abs_err_packed_vs_logical_config"] > SERVE_LAYOUT_TOL:
            failures.append(f"packed and logical configs serve other scores: "
                            f"{layouts}")
        del pmodel, ppredictor
    out = {
        "phase": "serve", "model": config.model_name,
        "config": f"configs/{config_file}",
        "users": 943, "items": 1682, "rows": 100_000,
        "n_params": health.get("n_params"), "score_rows": len(rows),
        "setup_s": setup_s, "prologue_s": prologue_s,
        "health_ms": health_ms, "score_ms": score_ms, "recommend_ms": rec_ms,
        "candidates": len(cand), "max_abs_err_score": score_err,
        "max_abs_err_recommend": rec_err, "tol": SERVE_TOL,
        "breakdown_ms": breakdown, "profile_recommend_predict": profile,
        "launches": launches, "checkpoint_layout": saved_layout,
        "served_under_packed_config": layouts, "ok": not failures,
    }
    emit(out)
    if failures:
        fail("; ".join(failures))
    return out


def movielens_data(tmp: Path) -> Path:
    """Synthetic MovieLens at ML-100K scale (943 users, 1682 items, 100,000
    ratings), written once under ``tmp``."""
    from deepfm_tpu_torch.data.synthetic import generate_movielens_like

    data_dir = tmp / "ml-100k"
    if not (data_dir / "u.data").exists():
        generate_movielens_like(data_dir, num_users=943, num_items=1682,
                                num_rows=100_000, seed=0)
    return data_dir


class StepTableCalls:
    """Copies of the inputs of one train step's segment_sumsq and
    sparse_table_adam calls, one of each a table, made by wrappers that
    ``patched()`` puts in the step's module while a run goes on (the
    wrappers call the kernels as the step would, so the run is unchanged).
    A step calls segment_sumsq for every table before its first
    sparse_table_adam call, so the first step's calls are the
    segment_sumsq calls before any sparse_table_adam call and as many
    sparse_table_adam calls after them."""

    def __init__(self):
        self.sumsq, self.adam = [], []

    @contextlib.contextmanager
    def patched(self):
        import torch

        from deepfm_tpu_torch.training import steps

        def copy(a):
            return a.clone() if torch.is_tensor(a) else a

        real_sumsq, real_adam = steps.segment_sumsq, steps.sparse_table_adam

        def sumsq(sids, cts):
            if not self.adam:
                self.sumsq.append((sids.clone(), cts.clone()))
            return real_sumsq(sids, cts)

        def adam(*args, **kwargs):
            if len(self.adam) < len(self.sumsq):
                self.adam.append(([copy(a) for a in args], dict(kwargs)))
            return real_adam(*args, **kwargs)

        steps.segment_sumsq, steps.sparse_table_adam = sumsq, adam
        try:
            yield self
        finally:
            steps.segment_sumsq, steps.sparse_table_adam = real_sumsq, real_adam


def step_table_checks(calls: StepTableCalls) -> list:
    """segment_sumsq and sparse_table_adam held against their plain
    versions on the inputs of a recorded step (``StepTableCalls``): the
    sum within TABLE_TOL["scalar_rel"] and its bits twice; the table
    update by adam_check (moments bit for bit, p and sum(p'^2) within
    TABLE_TOL, a second launch's bits), with each table's pairs, runs and
    segment_sumsq plan."""
    import functools

    import torch

    from deepfm_tpu_torch.ops.kernels.sparse_adam import (
        SCAN,
        segment_sumsq,
        segment_sumsq_plain,
        segment_sumsq_plan,
        sparse_table_adam,
        sparse_table_adam_plain,
    )

    out = []
    for (sids, cts), (args, kwargs) in zip(calls.sumsq, calls.adam):
        state, extra, scalars = args[:3], args[3:5], args[5:]
        _, runs = torch.unique_consecutive(sids, return_counts=True)
        plan = segment_sumsq_plan(*cts.shape)
        got = segment_sumsq(sids, cts)
        rel = rel_err(got, segment_sumsq_plain(sids, cts))
        same = bool(torch.equal(got, segment_sumsq(sids, cts)))
        adam = adam_check(functools.partial(sparse_table_adam, **kwargs),
                          functools.partial(sparse_table_adam_plain, **kwargs),
                          lambda: [t.clone() for t in state], extra, scalars)
        adam["moments"] = str(state[1].dtype).split(".")[-1]
        out.append({
            "table_rows": state[0].shape[0], "width": state[0].shape[1],
            "pairs": cts.shape[0], "columns": cts.shape[1],
            "unique_ids": runs.numel(), "max_run": int(runs.max()),
            "runs_past_scan": int((runs > SCAN).sum()),
            "segment_sumsq_grid": plan.grid,
            "segment_sumsq_staged": plan.staged,
            "segment_sumsq_rel_err": rel,
            "segment_sumsq_deterministic": same,
            "sparse_table_adam": adam,
            "ok": rel <= TABLE_TOL["scalar_rel"] and same and adam["ok"],
        })
    return out


def phase_train_loop(tmp: Path) -> dict:
    """The trainer loop on the card through the CLI's commands, at the full
    width of configs/xdeepfm_movielens_cin_tuned.yaml (f32, CIN
    [128,128,64] split, DNN [256,128,64] with BatchNorm, dropout 0.1,
    batch 4096, Adam, clip 1.0, sparse-fused, 999 eval negatives) on
    synthetic ML-100K: ``train`` for TRAIN_LOOP_EPOCHS epochs (the main
    path), ``evaluate`` on its best checkpoint (the best epoch's val
    metrics exactly, and the test metrics exactly where the best epoch is
    the last), a run of 1 epoch resumed to TRAIN_LOOP_EPOCHS whose history
    must equal the unbroken run's, and ``compare`` over both runs. The
    resumed run's first step's table kernels are held against their plain
    versions on that step's inputs (step_table_checks)."""
    import io

    import torch

    from deepfm_tpu_torch.cli import evaluate_command, main as cli_main
    from deepfm_tpu_torch.cli import train_command
    from deepfm_tpu_torch.config import load_config

    def config(run: str, epochs: int):
        return load_config(REPO / "configs" / TRAIN_LOOP_CONFIG, [
            f"data.data_dir={data_dir}", f"training.num_epochs={epochs}",
            "training.resume=true", "device=cuda",
            f"output_dir={tmp / 'train_loop' / run}"])

    def clock_free(history):
        return [{k: v for k, v in h.items() if k not in HISTORY_CLOCK}
                for h in history]

    data_dir = movielens_data(tmp)
    failures = []

    # --- the main path: every kernel count starts at 0 here -------------
    reset_counts()
    t0 = time.perf_counter()
    trainer = train_command(config("whole", TRAIN_LOOP_EPOCHS))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_counts()
    # --- end of the main path --------------------------------------------

    out_dir = tmp / "train_loop" / "whole"
    results = json.loads((out_dir / "results.json").read_text())
    info = results["training_info"]
    timings = {k: list(v) for k, v in trainer.timings.items()}
    history = results["history"]
    del trainer
    free_device()
    missing = [k for k in TRAIN_LOOP_KERNELS if k not in info["kernels"]]
    if missing or any(launches[k] < 1 for k in TRAIN_LOOP_KERNELS):
        failures.append(f"kernels {missing} missing from training_info "
                        f"{info['kernels']} or not launched: {launches}")
    finite = all(math.isfinite(h["train_loss"]) for h in history) and all(
        math.isfinite(v) for v in results["test_metrics"].values())
    if len(history) != TRAIN_LOOP_EPOCHS or not finite:
        failures.append(f"history {history} or test metrics not finite")
    if not 0.0 <= results["test_metrics"]["auc"] <= 1.0:
        failures.append(f"test AUC {results['test_metrics']['auc']}")

    t0 = time.perf_counter()
    evaluated = evaluate_command(config("whole", TRAIN_LOOP_EPOCHS))
    evaluate_s = time.perf_counter() - t0
    last_is_best = info["best_epoch"] == info["total_epochs"]
    if evaluated["val"] != results["val_metrics"]:
        failures.append(f"evaluate's val metrics {evaluated['val']} differ "
                        f"from the best epoch's {results['val_metrics']}")
    if last_is_best and evaluated["test"] != results["test_metrics"]:
        failures.append(f"evaluate's test metrics {evaluated['test']} differ "
                        f"from train's {results['test_metrics']}")
    free_device()

    t0 = time.perf_counter()
    calls = StepTableCalls()
    with calls.patched():
        first = train_command(config("resumed", 1))
    del first
    free_device()
    resumed = train_command(config("resumed", TRAIN_LOOP_EPOCHS))
    resume_s = time.perf_counter() - t0
    resumed_history = list(resumed.history)
    del resumed
    free_device()
    same_history = clock_free(resumed_history) == clock_free(history)
    if not same_history:
        failures.append(f"the resumed history {resumed_history} differs from "
                        f"the unbroken run's {history}")

    step_tables = step_table_checks(calls)
    del calls
    free_device()
    if not step_tables or not all(t["ok"] for t in step_tables):
        failures.append(f"the step's table kernels against their plain "
                        f"versions: {step_tables}")

    table = io.StringIO()
    with contextlib.redirect_stdout(table):
        cli_main(["compare", "--dir", str(tmp / "train_loop")])
    rows = [line for line in table.getvalue().splitlines()
            if line.startswith(("whole", "resumed"))]
    if len(rows) != 2:
        failures.append(f"compare printed {table.getvalue()}")

    step_s = [e - s for e, s in zip(timings["epoch_seconds"],
                                     timings["stage_seconds"])]
    out = {
        "phase": "train_loop", "config": f"configs/{TRAIN_LOOP_CONFIG}",
        "users": 943, "items": 1682, "ratings": 100_000,
        "epochs": TRAIN_LOOP_EPOCHS, "train_s": train_s,
        "epoch_seconds": timings["epoch_seconds"],
        "epoch_step_seconds": step_s,
        "epoch_stage_seconds": timings["stage_seconds"],
        "val_eval_seconds": timings["val_seconds"],
        "val_predict_seconds": timings["val_predict_seconds"],
        "test_eval_seconds": timings["test_seconds"],
        "test_predict_seconds": timings["test_predict_seconds"],
        "examples_per_sec": [h["examples_per_sec"] for h in history],
        "train_loss": [h["train_loss"] for h in history],
        "val_auc": [h["val_auc"] for h in history],
        "test_metrics": results["test_metrics"],
        "best_epoch": info["best_epoch"],
        "training_info_kernels": info["kernels"], "backward": info["backward"],
        "launches": launches,
        "evaluate_s": evaluate_s, "evaluate_reproduces_val": (
            evaluated["val"] == results["val_metrics"]),
        "evaluate_reproduces_test": (
            evaluated["test"] == results["test_metrics"]),
        "resume_s": resume_s, "resumed_history_equal": same_history,
        "step_tables": step_tables,
        "ok": not failures,
    }
    emit(out)
    print(f"train_loop: epoch seconds {timings['epoch_seconds']}, "
          f"examples/s {out['examples_per_sec']}, val eval seconds "
          f"{timings['val_seconds']}, test eval seconds "
          f"{timings['test_seconds']}", flush=True)
    if failures:
        fail("; ".join(failures))
    return out


def main_path(trainer, batch, watch=()) -> dict:
    """A trainer's main path with every kernel count at 0 when it starts:
    WARMUP_STEPS steps, TIMED_STEPS timed steps (host clock, each ending in
    a synchronisation) and one profiled step (step_profile); returns the
    losses, the step times, the profile and the launch counts."""
    import torch

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses = [trainer._train_step(*batch).item()
              for _ in range(WARMUP_STEPS)]
    times = timed_steps(trainer, batch)
    profile = step_profile(lambda: trainer._train_step(*batch), watch)
    torch.cuda.synchronize()
    counts = read_counts()
    losses.append(trainer._train_step(*batch).item())
    step_ms = 1e3 * statistics.median(times)
    return {
        "losses": losses, "step_ms_median": step_ms,
        "step_ms_min": 1e3 * min(times), "step_ms_max": 1e3 * max(times),
        "timed_steps": TIMED_STEPS, "step_ms_all": [1e3 * t for t in times],
        "examples_per_s": BENCH_BATCH / (step_ms / 1e3),
        "device_ms": profile["device_ms"],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile_step": profile, "launches": counts,
        "steps": WARMUP_STEPS + TIMED_STEPS + 1,
    }


def check_launches(name: str, counts: dict, expected: dict,
                   failures: list) -> None:
    for kernel, n in expected.items():
        if counts[kernel] != n:
            failures.append(f"{name}: {kernel} launched {counts[kernel]} "
                            f"times, expected {n}")


def phase_train_baselines(gpu: str) -> dict:
    """The ablation baselines (lr, fm, dnn: models/baselines.py) at
    bench.py's full width and config on the default sparse-fused path,
    each model's steps its own main path: segment_sumsq and
    sparse_table_adam once a table a step, fused_table_adam never; then
    each model's first-step gradients at 20k ids per field, f32, on the
    card against the CPU, with a planted fault (GRAD_FAULTS) that must be
    refused."""
    import torch

    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    packed, arrays = bench_workload(BENCH_VOCAB)
    batch = batch_on(arrays, torch.device(DEVICE))
    small, small_arrays = bench_workload(SMALL_VOCAB)
    tables = len(packed.lookup_groups)
    results, failures = {}, []
    for name in BASELINE_MODELS:
        t0 = time.perf_counter()
        config = bench_config(DEVICE, model_name=name)
        model = create_model(name, packed, config, device=DEVICE)
        trainer = Trainer(model, packed, config)
        setup_s = time.perf_counter() - t0
        if trainer.path != "sparse_fused":
            failures.append(f"{name}: the default config took the "
                            f"{trainer.path} path")
        # --- this model's main path: counts start at 0 in main_path ------
        run = main_path(trainer, batch)
        # --- end of the main path ------------------------------------------
        steps = run["steps"]
        expected = {"segment_sumsq": steps * tables,
                    "sparse_table_adam": steps * tables,
                    "fused_table_adam": 0}
        check_launches(name, run["launches"], expected, failures)
        if not all(map(math.isfinite, run["losses"])):
            failures.append(f"{name}: a loss is not finite: {run['losses']}")
        n_params = sum(p.numel() for p in model.parameters())
        del trainer, model
        free_device()
        grads = phase_grads_card_vs_cpu(small, small_arrays, name)
        if not grads["ok"]:
            failures.append(f"{name}: first-step gradients: the card differs "
                            f"from the CPU, or a planted fault passed: {grads}")
        rec = {
            "phase": "train_baselines", "model": name, "card": gpu,
            "path": "sparse_fused", "batch": BENCH_BATCH,
            "fields": BENCH_FIELDS, "vocab": BENCH_VOCAB,
            "n_params": n_params, "compute_dtype": "bfloat16",
            "moments_dtype": "bfloat16", "setup_s": setup_s, **run,
            "launches_expected": expected,
            "first_step_grads_card_vs_cpu_20k_f32": grads,
            "tol": {"grad_max_rel": GRAD_MAX_REL,
                    "grad_norm_rel": GRAD_NORM_REL,
                    "cpu_loss_rel": TRAIN_TOL["cpu_loss_rel"]},
        }
        rec["ok"] = not [f for f in failures if f.startswith(name)]
        emit(rec)
        print(f"train_baselines {name}: step ms {rec['step_ms_median']:.3f} "
              f"(host clock), device ms {rec['device_ms']:.3f} ({gpu})",
              flush=True)
        results[name] = rec
    if failures:
        fail("; ".join(failures))
    return results


def phase_train_lazy(gpu: str) -> dict:
    """DeepFM with training.optimizer: lazy_adam at bench.py's full width,
    on logical and on packed tables, each layout's steps its own main path:
    the table gradient densified by its lookup's backward
    (densify_rows_grad, or densify_rows_grad_packed on packed tables) once
    a table a step, and no sparse_table_adam, segment_sumsq or
    fused_table_adam; then 2 steps at 20k ids per field in f32 on the card
    and on the CPU, held by training/parity.py's rule (the card's f32
    gradient parts from the CPU's at ReLU kinks, so without the share
    limit, the rows the batch did not touch to rtol / atol, moments
    included)."""
    import torch

    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.training.parity import compare_leaves
    from deepfm_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    packed, arrays = bench_workload(BENCH_VOCAB)
    batch = batch_on(arrays, torch.device(DEVICE))
    small, small_arrays = bench_workload(SMALL_VOCAB)
    tables = len(packed.lookup_groups)
    results, failures = {}, []
    for layout, densify in LAZY_DENSIFY.items():
        tag = f"lazy {layout}"
        pallas = {"table_layout": layout}
        t0 = time.perf_counter()
        config = bench_config(DEVICE, pallas=pallas, optimizer="lazy_adam")
        model = create_model("deepfm", packed, config, device=DEVICE)
        trainer = Trainer(model, packed, config)
        setup_s = time.perf_counter() - t0
        moments = {str(s.mu.dtype) for s in trainer.state.table_opt.values()}
        if trainer.path != "lazy" or moments != {"torch.float32"}:
            failures.append(f"{tag}: path {trainer.path}, moments {moments}")
        # --- this layout's main path: counts start at 0 in main_path -----
        run = main_path(trainer, batch)
        # --- end of the main path ------------------------------------------
        steps = run["steps"]
        other = next(k for k in LAZY_DENSIFY.values() if k != densify)
        expected = {densify: steps * tables, other: 0,
                    "sparse_table_adam": 0, "segment_sumsq": 0,
                    "fused_table_adam": 0}
        check_launches(tag, run["launches"], expected, failures)
        if not all(map(math.isfinite, run["losses"])):
            failures.append(f"{tag}: a loss is not finite: {run['losses']}")
        del trainer, model
        free_device()

        trainers = {}
        for device in ("cpu", DEVICE):
            cfg = bench_config(device, compute_dtype="float32", pallas=pallas,
                               optimizer="lazy_adam")
            m = create_model("deepfm", small, cfg, device="cpu")
            trainers[device] = Trainer(m, small, cfg)
        got_l, want_l = [], []
        for _ in range(2):
            got_l.append(trainers[DEVICE]._train_step(
                *batch_on(small_arrays, torch.device(DEVICE))).item())
            want_l.append(trainers["cpu"]._train_step(
                *batch_on(small_arrays, torch.device("cpu"))).item())
        cpu_model = trainers["cpu"].model
        rows = cpu_model.embedding.local_ids(0, torch.from_numpy(
            small_arrays.ids)).reshape(-1)
        pack = cpu_model.embedding.table_pack["table_w16"]
        untouched = torch.ones(cpu_model.embedding.table_w16.shape[0],
                               dtype=torch.bool)
        untouched[rows // pack] = False
        cmp = compare_leaves(snapshot(trainers[DEVICE]),
                             snapshot(trainers["cpu"]), LR, steps=2,
                             share_limit=False, untouched=untouched)
        cmp["loss_rel_err"] = max(rel_err(a, b) for a, b in zip(got_l, want_l))
        cmp["losses_card"], cmp["losses_cpu"] = got_l, want_l
        if (cmp["loss_rel_err"] > TRAIN_TOL["cpu_loss_rel"]
                or cmp["failed_leaves"]):
            failures.append(f"{tag}: the card differs from the CPU: {cmp}")
        del trainers, cpu_model
        free_device()
        rec = {
            "phase": "train_lazy", "model": "deepfm", "card": gpu,
            "path": "lazy", "table_layout": layout, "batch": BENCH_BATCH,
            "fields": BENCH_FIELDS, "vocab": BENCH_VOCAB,
            "compute_dtype": "bfloat16", "moments_dtype": "float32",
            "setup_s": setup_s, **run, "launches_expected": expected,
            "card_vs_cpu_20k_f32_2_steps": cmp,
            "tol": {"cpu_loss_rel": TRAIN_TOL["cpu_loss_rel"],
                    "parity": "training/parity.py, share_limit=False, "
                              "untouched rows to rtol / atol"},
        }
        rec["ok"] = not [f for f in failures if f.startswith(tag)]
        emit(rec)
        print(f"train_lazy {layout}: step ms {rec['step_ms_median']:.3f} "
              f"(host clock), device ms {rec['device_ms']:.3f} ({gpu})",
              flush=True)
        results[layout] = rec
    if failures:
        fail("; ".join(failures))
    return results


def phase_packed_store(tmp: Path, gpu: str) -> dict:
    """The on-disk packed store (data/store.py) through the port's CLI:
    ``synth-packed`` at configs/deepfm_criteo_packed.yaml's geometry
    (PACKED_STORE_ROWS train rows, the CLI's default 26 fields of 100,000
    ids) into ``tmp``, then ``train`` with that config on the card (its
    data_dir and output_dir overridden, PACKED_STORE_EPOCHS epoch of its 3)
    from the memory-mapped splits: the main path of the store, whose
    sparse-fused steps launch segment_sumsq and sparse_table_adam once a
    table a step; then ``pack-data`` of the MovieLens data the train_loop
    phase used, which must load back equal to the adapter's arrays."""
    import numpy as np
    import torch

    from deepfm_tpu_torch.cli import _build_data, main as cli_main
    from deepfm_tpu_torch.cli import train_command
    from deepfm_tpu_torch.config import load_config
    from deepfm_tpu_torch.data.store import load_packed

    failures = []
    store = tmp / "ctr_packed_2m"
    t0 = time.perf_counter()
    cli_main(["synth-packed", "--dir", str(store),
              "--rows", str(PACKED_STORE_ROWS)])
    synth_s = time.perf_counter() - t0
    config = load_config(REPO / "configs" / PACKED_STORE_CONFIG, [
        f"data.data_dir={store}", f"output_dir={tmp / 'packed_run'}",
        f"training.num_epochs={PACKED_STORE_EPOCHS}", f"device={DEVICE}"])

    # --- the main path: every kernel count starts at 0 here -------------
    reset_counts()
    t0 = time.perf_counter()
    trainer = train_command(config)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_counts()
    # --- end of the main path --------------------------------------------

    splits = {k: getattr(trainer, f"{k}_data") for k in ("train", "val",
                                                          "test")}
    memmapped = {k: isinstance(v.ids, np.memmap) for k, v in splits.items()}
    rows = {k: len(v) for k, v in splits.items()}
    steps = rows["train"] // config.training.batch_size
    tables = len(trainer.packed_schema.lookup_groups)
    timings = {k: list(v) for k, v in trainer.timings.items()}
    path = trainer.path
    del trainer, splits
    free_device()
    results = json.loads((tmp / "packed_run" / "results.json").read_text())
    history = results["history"]
    if not all(memmapped.values()):
        failures.append(f"the splits are not memory-mapped: {memmapped}")
    if path != "sparse_fused" or set(results) != RESULTS_KEYS:
        failures.append(f"path {path}, results.json keys {sorted(results)}")
    expected = {"segment_sumsq": steps * tables,
                "sparse_table_adam": steps * tables}
    check_launches("packed_store", launches, expected, failures)
    if not (len(history) == PACKED_STORE_EPOCHS
            and math.isfinite(history[0]["train_loss"])
            and 0.0 <= results["test_metrics"]["auc"] <= 1.0):
        failures.append(f"history {history}, test metrics "
                        f"{results['test_metrics']}")

    ml_config = load_config(REPO / "configs" / TRAIN_LOOP_CONFIG, [
        f"data.data_dir={movielens_data(tmp)}", f"device={DEVICE}",
        f"output_dir={tmp / 'pack_data_run'}"])
    t0 = time.perf_counter()
    cli_main(["pack-data", "--config",
              str(REPO / "configs" / TRAIN_LOOP_CONFIG), "--override",
              f"data.data_dir={movielens_data(tmp)}", f"device={DEVICE}",
              f"output_dir={tmp / 'pack_data_run'}",
              "--out", str(tmp / "ml_packed")])
    pack_s = time.perf_counter() - t0
    fresh = _build_data(ml_config)[3:]
    unequal = [
        f"{split}.{name}"
        for split, want in zip(("train", "val", "test"), fresh)
        for name in ("ids", "dense", "labels", "weights", "user_ids")
        if not np.array_equal(
            np.asarray(getattr(load_packed(tmp / "ml_packed" / split), name)),
            np.asarray(getattr(want, name)))]
    if unequal:
        failures.append(f"pack-data's store differs from the adapter's "
                        f"arrays: {unequal}")
    out = {
        "phase": "packed_store", "card": gpu,
        "config": f"configs/{PACKED_STORE_CONFIG}",
        "reduced": {"training.num_epochs": f"{PACKED_STORE_EPOCHS} of 3"},
        "rows": rows, "fields": 26, "vocab": 100_000,
        "synth_packed_s": synth_s, "train_s": train_s,
        "memmapped": memmapped, "path": path,
        "epoch_seconds": timings["epoch_seconds"],
        "epoch_stage_seconds": timings["stage_seconds"],
        "examples_per_sec": [h["examples_per_sec"] for h in history],
        "val_eval_seconds": timings["val_seconds"],
        "test_eval_seconds": timings["test_seconds"],
        "train_loss": [h["train_loss"] for h in history],
        "test_metrics": results["test_metrics"],
        "training_info_kernels": results["training_info"]["kernels"],
        "launches": launches, "launches_expected": expected,
        "pack_data_s": pack_s, "pack_data_equal": not unequal,
        "ok": not failures,
    }
    emit(out)
    print(f"packed_store: epoch seconds {timings['epoch_seconds']}, "
          f"examples/s {out['examples_per_sec']} ({gpu})", flush=True)
    if failures:
        fail("; ".join(failures))
    return out


def read_scores(path: Path):
    """A ``predict`` TSV as ([(user, item)], scores)."""
    rows = [line.split("\t") for line in path.read_text().splitlines()]
    return ([(int(u), int(i)) for u, i, _ in rows],
            [float(s) for *_, s in rows])


def read_top_k(text: str) -> list:
    """``recommend``'s printed table as [(item, score)]."""
    lines = text.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("Top-"))
    return [(int(r.split()[1]), float(r.split()[2]))
            for r in lines[start + 2:] if r.strip()]


def phase_predict_recommend(tmp: Path, gpu: str) -> dict:
    """``predict`` and ``recommend`` on the train_loop phase's output
    directory (xDeepFM, configs/xdeepfm_movielens_cin_tuned.yaml, f32): the
    card's run is the main path (the f32 CIN-stack forward launched);
    ``predict`` over the synthetic u.data on the card and with device=cpu
    must keep the same rows with scores within SERVE_TOL, and ``recommend``
    for RECOMMEND_USER must give the same top RECOMMEND_K items (ties of
    equal printed score in either order) and scores within SERVE_TOL."""
    import io

    import torch

    from deepfm_tpu_torch.cli import predict_command, recommend_command
    from deepfm_tpu_torch.config import load_config

    data_dir = movielens_data(tmp)
    run_dir = tmp / "train_loop" / "whole"
    failures = []

    def config(device):
        return load_config(REPO / "configs" / TRAIN_LOOP_CONFIG, [
            f"data.data_dir={data_dir}", f"output_dir={run_dir}",
            f"device={device}"])

    def recommend(device):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            recommend_command(config(device), RECOMMEND_USER, RECOMMEND_K,
                              include_seen=False)
        return read_top_k(text.getvalue())

    # --- the main path: every kernel count starts at 0 here -------------
    reset_counts()
    t0 = time.perf_counter()
    predict_command(config(DEVICE), str(data_dir / "u.data"),
                    str(tmp / "scores_card.tsv"))
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    top_card = recommend(DEVICE)
    torch.cuda.synchronize()
    recommend_s = time.perf_counter() - t0
    launches = read_counts()
    # --- end of the main path --------------------------------------------
    free_device()
    t0 = time.perf_counter()
    predict_command(config("cpu"), str(data_dir / "u.data"),
                    str(tmp / "scores_cpu.tsv"))
    predict_cpu_s = time.perf_counter() - t0
    top_cpu = recommend("cpu")

    keys_card, scores_card = read_scores(tmp / "scores_card.tsv")
    keys_cpu, scores_cpu = read_scores(tmp / "scores_cpu.tsv")
    same_rows = keys_card == keys_cpu
    score_err = max((abs(a - b) for a, b in zip(scores_card, scores_cpu)),
                    default=math.inf)
    if not same_rows or score_err > SERVE_TOL or not all(
            0.0 < s < 1.0 for s in scores_card):
        failures.append(f"predict: same rows {same_rows}, max score error "
                        f"{score_err} (tol {SERVE_TOL})")
    top_err = max((abs(a[1] - b[1]) for a, b in zip(top_card, top_cpu)),
                  default=math.inf)
    ties_aside = len(top_card) == len(top_cpu) == RECOMMEND_K and all(
        {i for i, s in top_card if s == score}
        == {i for i, s in top_cpu if s == score}
        for score in {s for _, s in top_cpu})
    if not ties_aside or top_err > SERVE_TOL:
        failures.append(f"recommend: card {top_card}, cpu {top_cpu}")
    if launches["cin_stack_fwd"] < 1:
        failures.append(f"cin_stack_fwd was not launched: {launches}")
    out = {
        "phase": "predict_recommend", "card": gpu,
        "config": f"configs/{TRAIN_LOOP_CONFIG}", "rows": len(keys_card),
        "predict_s": predict_s, "predict_cpu_s": predict_cpu_s,
        "recommend_s": recommend_s, "same_rows": same_rows,
        "max_score_err": score_err, "top_k_card": top_card,
        "top_k_cpu": top_cpu, "top_k_max_err": top_err,
        "launches": launches, "tol": SERVE_TOL, "ok": not failures,
    }
    emit(out)
    print(f"predict_recommend: predict {len(keys_card)} rows in "
          f"{predict_s:.2f} s, recommend in {recommend_s:.2f} s ({gpu})",
          flush=True)
    if failures:
        fail("; ".join(failures))
    return out


# Loads each artifact named on its command line with torch.export alone,
# scores the rows in ids.npy / dense.npy on the program's own device
# (a pinned batch in chunks, the last padded with id-0 rows) and one request
# of the first row (symbolic batches), and checks that it imported nothing
# of the package. Prints one JSON object; the scores go to <artifact>.npy.
EXPORT_LOADER = """
import json, sys, time
import numpy as np
import torch

ids, dense = np.load(sys.argv[1]), np.load(sys.argv[2])
out = {}
for path in sys.argv[3:]:
    t0 = time.perf_counter()
    program = torch.export.load(path)
    score = program.module()
    tensors = [*program.state_dict.values(), *program.constants.values()]
    device = next(t.device for t in tensors if isinstance(t, torch.Tensor))
    load_s = time.perf_counter() - t0
    first = program.graph_signature.user_inputs[0]
    batch = next(n.meta["val"].shape[0] for n in program.graph.nodes
                 if n.name == first)
    pinned = isinstance(batch, int)
    step = batch if pinned else len(ids)

    def run(i, d):
        n = len(i)
        if pinned and n < step:
            i = np.concatenate([i, np.zeros((step - n, i.shape[1]), i.dtype)])
            d = np.concatenate([d, np.zeros((step - n, d.shape[1]), d.dtype)])
        with torch.no_grad():
            got = score(torch.from_numpy(i).to(device),
                        torch.from_numpy(d).to(device))
        return got.cpu().numpy()[:n]

    t0 = time.perf_counter()
    scores = np.concatenate([run(ids[lo:lo + step], dense[lo:lo + step])
                             for lo in range(0, len(ids), step)])
    score_s = time.perf_counter() - t0
    np.save(path + ".npy", scores)
    out[path] = {"device": str(device), "batch": str(batch),
                 "fresh_load_s": load_s, "fresh_score_s": score_s,
                 "request": None if pinned else float(run(ids[:1],
                                                          dense[:1])[0])}
leaked = [m for m in sys.modules if m.startswith("deepfm_tpu")]
assert not leaked, leaked
print(json.dumps(out))
"""


def export_refusals(tmp: Path, gpu: str) -> dict:
    """Faults 5 and 6 on the card: ``train`` refuses
    configs/deepfm_criteo_multichip.yaml (model_axis 2) with the JAX
    package's mesh error before it builds any data; and under
    ``profile.debug_nans`` a DeepFM step (bench.py's width at SMALL_VOCAB
    ids, batch 1024, sparse-fused) runs clean, then raises
    FloatingPointError on a planted NaN before its update."""
    import torch

    from deepfm_tpu_torch import cli
    from deepfm_tpu_torch.config import load_config
    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.training.trainer import Trainer

    failures = []
    built = []
    real_build = cli._build_data

    def build_data(config):
        built.append(config)
        return real_build(config)

    cli._build_data = build_data
    try:
        cli.train_command(load_config(
            REPO / "configs" / MULTICHIP_CONFIG,
            ["device=cuda", f"output_dir={tmp / 'multichip'}"]))
        mesh_error = None
    except ValueError as e:
        mesh_error = str(e)
    finally:
        cli._build_data = real_build
    if not (mesh_error or "").startswith(MULTICHIP_REFUSAL) or built:
        failures.append(f"mesh: {MULTICHIP_CONFIG} gave {mesh_error!r}, "
                        f"data built {len(built)} times")

    packed, arrays = bench_workload(SMALL_VOCAB)
    arrays = head_rows(arrays, GRAD_BATCH)
    config = bench_config(DEVICE)
    config = dataclasses.replace(config, profile=dataclasses.replace(
        config.profile, debug_nans=True))
    trainer = Trainer(create_model("deepfm", packed, config, device=DEVICE),
                      packed, config)
    ids, dense, labels, weights = batch_on(arrays, torch.device(DEVICE))
    clean_loss = float(trainer._train_step(ids, dense, labels, weights))
    dense = dense.clone()
    dense[3, 0] = float("nan")
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    try:
        trainer._train_step(ids, dense, labels, weights)
        nan_error = None
    except FloatingPointError as e:
        nan_error = str(e)
    unchanged = all(torch.equal(p, before[n])
                    for n, p in trainer.model.named_parameters())
    if nan_error is None or not unchanged or not math.isfinite(clean_loss):
        failures.append(f"debug_nans: clean loss {clean_loss}, planted NaN "
                        f"gave {nan_error!r}, parameters unchanged "
                        f"{unchanged}")
    del trainer
    free_device()
    return {"mesh_error": mesh_error, "data_built": len(built),
            "debug_nans_path": "sparse_fused", "clean_loss": clean_loss,
            "debug_nans_error": nan_error,
            "params_unchanged_at_error": unchanged, "failures": failures}


def int8_predictor_scores(predictor, data) -> dict:
    """``predictor``'s scores of ``data`` with its model's embedding tables
    replaced by their dequantized int8 rows ``q * scale``
    (``quantize_embedding_tables``): "sound", the function an int8 artifact
    computes, by the f32 model's route on the card; then each planted fault
    of EXPORT_INT8_FAULTS in their place. The f32 tables are restored."""
    import numpy as np
    import torch

    from deepfm_tpu_torch.utils.export import quantize_embedding_tables
    from deepfm_tpu_torch.utils.layout import convert_table_tree

    model = predictor.model
    f32_state = {n: v.detach().clone() for n, v in model.state_dict().items()}
    qtabs = {dcol: (q.astype(np.float32), scale) for dcol, (q, scale)
             in quantize_embedding_tables(model).items()}
    to_packed = any(p > 1 for p in model.embedding.table_pack.values())
    dequantize = {
        "sound": lambda q, s: q * s[:, None],
        "scales_rolled": lambda q, s: q * np.roll(s, 1)[:, None],
        "rows_zeroed": lambda q, s: np.zeros_like(q),
    }
    scores = {}
    try:
        for name in ("sound", *EXPORT_INT8_FAULTS):
            tables = {f"embedding.table_w{dcol - 1}":
                      torch.from_numpy(dequantize[name](q, s))
                      for dcol, (q, s) in qtabs.items()}
            model.load_state_dict({**f32_state, **convert_table_tree(
                tables, predictor.packed, to_packed=to_packed)})
            scores[name] = predictor.predict(data)
    finally:
        model.load_state_dict(f32_state)
    return scores


def phase_export(tmp: Path, gpu: str) -> dict:
    """``export`` on train_loop's best checkpoint (xDeepFM,
    configs/xdeepfm_movielens_cin_tuned.yaml, f32, full width; the val
    split at EXPORT_NEG_EVAL eval negatives): the artifacts of
    EXPORT_ARTIFACTS, each verified by the command itself, then loaded in
    one process that imports nothing of the package (EXPORT_LOADER),
    which scores the val split and one request. The cuda artifacts are held
    to the card's Predictor on the same rows (the main path: the f32
    CIN-stack forward launched) within SERVE_TOL, and the cpu artifact (the
    plain version on the host) too. The int8 one is held within SERVE_TOL
    to the Predictor on its dequantized tables and within EXPORT_QUANT_TOL
    to the f32 one, where each planted fault of EXPORT_INT8_FAULTS must
    fall outside both (``int8_predictor_scores``); then the two refusals
    (``export_refusals``)."""
    import numpy as np
    import torch

    from deepfm_tpu_torch.cli import _restore_predictor, export_command
    from deepfm_tpu_torch.config import load_config

    data_dir = movielens_data(tmp)
    run_dir = tmp / "train_loop" / "whole"
    out_dir = tmp / "export"
    out_dir.mkdir(parents=True, exist_ok=True)
    config = load_config(REPO / "configs" / TRAIN_LOOP_CONFIG, [
        f"data.data_dir={data_dir}", f"output_dir={run_dir}",
        f"data.num_neg_eval={EXPORT_NEG_EVAL}", f"device={DEVICE}"])
    failures = []
    artifacts = {}
    for name, platform, batch, quantize in EXPORT_ARTIFACTS:
        path = out_dir / f"{name}.pt2"
        t0 = time.perf_counter()
        res = export_command(config, str(path), platform, batch, quantize)
        res["command_s"] = time.perf_counter() - t0
        res["inputs"] = [list(s) for s in res["inputs"]]
        artifacts[name] = res

    # --- the main path: every kernel count starts at 0 here -------------
    reset_counts()
    t0 = time.perf_counter()
    _, _, val_d, _, _, predictor, _ = _restore_predictor(config)
    want = predictor.predict(val_d)
    torch.cuda.synchronize()
    predictor_s = time.perf_counter() - t0
    launches = read_counts()
    # --- end of the main path --------------------------------------------
    int8_ref = int8_predictor_scores(predictor, val_d)
    del predictor
    free_device()
    if launches["cin_stack_fwd"] < 1:
        failures.append(f"cin_stack_fwd was not launched: {launches}")
    # the readings of the planted faults: each must fail both int8 checks
    int8_faults = {
        name: {"max_abs_err_vs_dequantized":
               float(np.abs(int8_ref[name] - int8_ref["sound"]).max()),
               "max_abs_err_vs_card": float(np.abs(int8_ref[name] - want).max())}
        for name in EXPORT_INT8_FAULTS}
    for name, rec in int8_faults.items():
        if not (rec["max_abs_err_vs_dequantized"] > SERVE_TOL
                and rec["max_abs_err_vs_card"] > EXPORT_QUANT_TOL):
            failures.append(f"planted int8 fault {name} passes a check: "
                            f"{rec} (tols {SERVE_TOL}, {EXPORT_QUANT_TOL})")

    np.save(out_dir / "ids.npy", val_d.ids)
    np.save(out_dir / "dense.npy", val_d.dense)
    paths = [str(out_dir / f"{name}.pt2") for name, *_ in EXPORT_ARTIFACTS]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", EXPORT_LOADER, str(out_dir / "ids.npy"),
         str(out_dir / "dense.npy"), *paths],
        cwd=out_dir, capture_output=True, text=True, timeout=600)
    loader_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"export: loading the artifacts without the package failed: "
             f"{proc.stderr[-2000:]}")
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    for (name, platform, _, quantize), path in zip(EXPORT_ARTIFACTS, paths):
        rec = artifacts[name]
        rec.update(loaded[path])
        got = np.load(path + ".npy")
        tol = EXPORT_QUANT_TOL if quantize else SERVE_TOL
        rec["max_abs_err_vs_card"] = float(np.abs(got - want).max())
        rec["request_abs_err_vs_card"] = (
            None if rec["request"] is None
            else abs(rec["request"] - float(want[0])))
        rec["tol"] = tol
        if not rec["device"].startswith(platform):
            failures.append(f"{name}: loaded on {rec['device']}")
        if got.shape != want.shape or not rec["max_abs_err_vs_card"] <= tol \
                or not (rec["request_abs_err_vs_card"] or 0.0) <= tol:
            failures.append(f"{name}: shape {got.shape}, max error "
                            f"{rec['max_abs_err_vs_card']}, request error "
                            f"{rec['request_abs_err_vs_card']} (tol {tol})")
        if quantize:
            sound = int8_ref["sound"]
            rec["max_abs_err_vs_dequantized"] = float(
                np.abs(got - sound).max())
            rec["request_abs_err_vs_dequantized"] = (
                None if rec["request"] is None
                else abs(rec["request"] - float(sound[0])))
            if not (rec["max_abs_err_vs_dequantized"] <= SERVE_TOL and
                    (rec["request_abs_err_vs_dequantized"] or 0.0)
                    <= SERVE_TOL):
                failures.append(
                    f"{name}: against the dequantized tables, max error "
                    f"{rec['max_abs_err_vs_dequantized']}, request error "
                    f"{rec['request_abs_err_vs_dequantized']} "
                    f"(tol {SERVE_TOL})")

    refusals = export_refusals(tmp, gpu)
    failures += refusals.pop("failures")
    f32, int8 = artifacts["f32_cuda"], artifacts["int8_cuda"]
    out = {
        "phase": "export", "card": gpu,
        "config": f"configs/{TRAIN_LOOP_CONFIG}", "val_rows": len(val_d),
        "artifacts": artifacts, "bytes_f32": f32["bytes"],
        "bytes_int8": int8["bytes"],
        "shrink_int8": f32["bytes"] / int8["bytes"],
        "auc_delta_int8": int8.get("auc_delta"), "int8_faults": int8_faults,
        "predictor_s": predictor_s, "loader_process_s": loader_s,
        "launches": launches, **refusals, "ok": not failures,
    }
    emit(out)
    print(f"export: f32 {f32['bytes']} B, int8 {int8['bytes']} B, export "
          f"{f32['export_s']:.2f} s, max error against the card "
          f"{f32['max_abs_err_vs_card']:.2e}, int8 "
          f"{int8['max_abs_err_vs_card']:.2e} (dequantized "
          f"{int8['max_abs_err_vs_dequantized']:.2e}), planted faults "
          + ", ".join(f"{n} {r['max_abs_err_vs_card']:.2e}"
                      for n, r in int8_faults.items()) + f" ({gpu})",
          flush=True)
    if failures:
        fail("; ".join(failures))
    return out


# ---------------------------------------------------------------------------
# data_parallel
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dp_rank_main(rank: int, world: int, port: int, part: str,
                 out: str, args: tuple = ()) -> None:
    """One rank of a DP_PARTS run: torchrun's environment for it, the
    process group started from there (``initialize_distributed``; a world
    of one names no coordinator and is started explicitly), the part run
    on the mesh (with ``args`` after it), its JSON result written to
    ``out``."""
    import traceback

    os.environ.update({"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world)})
    import torch.distributed as dist

    from deepfm_tpu_torch.parallel import build_mesh, initialize_distributed
    from deepfm_tpu_torch.parallel.mesh import backend_rule

    try:
        if world == 1:
            initialize_distributed(env=os.environ, device=DEVICE,
                                   init_method=f"tcp://localhost:{port}",
                                   rank=0, world_size=1)
        else:
            initialize_distributed(env=os.environ, device=DEVICE)
        mesh = build_mesh(*PART_AXES.get(part, (-1, 1)), device=DEVICE)
        result = DP_PARTS[part](mesh, *args)
        result.update(rank=rank, backend=mesh.backend,
                      device=str(mesh.device),
                      rule=backend_rule(mesh.device.type, world, 1)[1])
        Path(out).write_text(json.dumps(result))
    except BaseException:
        Path(f"{out}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(world: int, part: str, tmp: Path, args: tuple = ()) -> list:
    """``world`` rank processes (spawned, one card) running ``part`` (with
    ``args``); their results in rank order. Every rank is killed past
    DP_RANK_TIMEOUT."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [tmp / f"{part}_rank{r}.json" for r in range(world)]
    procs = [ctx.Process(target=dp_rank_main,
                         args=(r, world, port, part, str(outs[r]), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DP_RANK_TIMEOUT
    try:
        # a rank that fails leaves its peers waiting in a collective: stop
        # them at once rather than at the collectives' timeout
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = [Path(f"{o}.err").read_text() for o in outs
              if Path(f"{o}.err").exists()]
    if errors or any(p.exitcode != 0 for p in procs):
        fail(f"data_parallel {part}: rank exit codes "
             f"{[p.exitcode for p in procs]}: " + " | ".join(errors)[-3000:])
    return [json.loads(o.read_text()) for o in outs]


@contextlib.contextmanager
def timed_collectives(log: list, mesh=None):
    """Each collective of the port (``parallel/collectives.py``'s
    all_reduce_, all_gather_rows and all_to_all_rows, which the flat
    all-reduce, BatchNorm's sum, the model-group sum and the overflow flag
    call) timed on the host clock between two device synchronisations,
    with the bytes this rank sends, while the context is open; with
    ``mesh``, the group each ran on ("data", "model" or "world")."""
    import torch

    from deepfm_tpu_torch.parallel import collectives

    real = {n: getattr(collectives, n)
            for n in ("all_reduce_", "all_gather_rows", "all_to_all_rows")}

    def group_of(g):
        if mesh is None:
            return None
        for kind in ("data", "model", "world"):
            if g is getattr(mesh, f"{kind}_group"):
                return kind
        return "world" if g is mesh else None

    def timed(name, fn):
        def call(g, t, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(g, t, *args, **kwargs)
            torch.cuda.synchronize()
            rec = {"op": name, "bytes": t.numel() * t.element_size(),
                   "shape": list(t.shape), "dtype": str(t.dtype),
                   "ms": 1e3 * (time.perf_counter() - t0)}
            if mesh is not None:
                rec["group"] = group_of(g)
            log.append(rec)
            return out
        return call

    for name, fn in real.items():
        setattr(collectives, name, timed(name, fn))
    try:
        yield log
    finally:
        for name, fn in real.items():
            setattr(collectives, name, fn)


@contextlib.contextmanager
def dp_fault(name: str | None):
    """A planted fault of the data-parallel step (DP_FAULTS), undone on
    exit: "skip_reduce" (rank 1 takes part in the flat all-reduce but
    keeps its own dense gradients), "skip_pair_gather" (the sparse-fused
    step's (id, cotangent) pairs are not all-gathered), "local_bn"
    (BatchNorm's statistics stay per rank), "skip_exchange_gather" (the
    lookup's sparse gradient exchange densifies its own pairs only)."""
    from deepfm_tpu_torch.parallel import collectives, embedding_shard
    from deepfm_tpu_torch.training import steps

    undo = []

    def swap(owner, attr, value):
        undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    class Proxy:
        """``collectives`` with all_gather_rows an identity."""

        def __getattr__(self, attr):
            if attr == "all_gather_rows":
                return lambda mesh, t: t
            return getattr(collectives, attr)

    if name == "skip_reduce":
        real = collectives.all_reduce_flat

        def own_on_rank_1(mesh, tensors):
            summed = real(mesh, tensors)
            return list(tensors) if mesh.rank == 1 else summed

        swap(collectives, "all_reduce_flat", own_on_rank_1)
    elif name == "skip_pair_gather":
        swap(steps, "collectives", Proxy())
    elif name == "local_bn":
        swap(collectives, "all_reduce_sum", lambda mesh, t: t)
    elif name == "skip_exchange_gather":
        swap(embedding_shard, "collectives", Proxy())
    try:
        yield
    finally:
        for owner, attr, value in reversed(undo):
            setattr(owner, attr, value)


def state_diff(got: dict, want: dict, band: float) -> dict:
    """max |got - want| over the table leaves, their moments and the dense
    parameters of two train-state snapshots, with the parameters (tables
    and dense) that have an element outside ``band``; and the BatchNorm
    running statistics' largest error relative to their largest value
    (they are averages of the batches' statistics, not steps of lr, so the
    band does not bound them)."""
    out = {"tables": 0.0, "table_moments": 0.0, "dense": 0.0,
           "bn_stats_rel": 0.0, "outside_band": []}
    for name, w in want.items():
        err = (got[name].float() - w.float()).abs().max().item()
        if "running_" in name:
            scale = max(w.float().abs().max().item(), 1e-30)
            out["bn_stats_rel"] = max(out["bn_stats_rel"], err / scale)
            continue
        kind = ("table_moments" if name.endswith((".mu", ".nu"))
                else "tables" if "table_w" in name else "dense")
        out[kind] = max(out[kind], err)
        if kind != "table_moments" and err > band:
            out["outside_band"].append(name)
    return out


def collective_summary(log: list) -> dict:
    """A step's collectives by op: calls, bytes sent, host ms, and the
    largest call's."""
    out = {}
    for c in log:
        rec = out.setdefault(c["op"], {"calls": 0, "bytes": 0, "ms": 0.0,
                                       "largest": None})
        rec["calls"] += 1
        rec["bytes"] += c["bytes"]
        rec["ms"] += c["ms"]
        if rec["largest"] is None or c["bytes"] > rec["largest"]["bytes"]:
            rec["largest"] = c
    return out


def dp_local(arrays, mesh, dev):
    """The rank's rows of a global batch, on its device."""
    import dataclasses as dc

    from deepfm_tpu_torch.parallel import batch_rows

    rows = batch_rows(mesh, len(arrays.labels))
    return batch_on(dc.replace(
        arrays, ids=arrays.ids[rows], dense=arrays.dense[rows],
        labels=arrays.labels[rows], weights=arrays.weights[rows]), dev)


def dp_full_width(mesh) -> dict:
    """DP_CASES at bench.py's full width on the mesh: DP_STEPS steps on
    each rank's rows of DP_STEPS global batches, the replicas checked
    after every step, the launches counted from 0; rank 0 then takes the
    same global batches in one process for the comparison; then one
    profiled step and one step with its collectives timed."""
    import numpy as np
    import torch

    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.parallel import collectives
    from deepfm_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    packed, _ = bench_workload(BENCH_VOCAB)
    batches = [bench_workload(BENCH_VOCAB, seed=s)[1]
               for s in range(DP_STEPS)]
    out, failures = {}, []
    for path, layout in DP_CASES:
        case = f"{path}_{layout}"
        extra = {} if path == "sparse_fused" else {"fused_backward": False}
        cfg = bench_config(DEVICE, pallas={"table_layout": layout}, **extra)
        trainer = Trainer(create_model("deepfm", packed, cfg, mesh=mesh),
                          packed, cfg, mesh=mesh)
        if trainer.path != path:
            failures.append(f"{case}: took the {trainer.path} path")
        local = [dp_local(b, mesh, dev) for b in batches]
        # --- the main path: every kernel count starts at 0 here ---------
        reset_counts()
        losses, times = [], []
        for i, batch in enumerate(local):
            s0 = time.perf_counter()
            loss = trainer._train_step(*batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - s0)
            losses.append(loss.item())
            trainer.check_replicas(f"{case} step {i + 1}")
        counts = read_counts()
        # --- end of the main path ----------------------------------------
        check_launches(case, counts, DP_LAUNCHES[path, layout], failures)
        rec = {"losses": losses, "step_ms": [1e3 * t for t in times],
               "step_ms_median": 1e3 * statistics.median(times),
               "launches": {k: counts[k] for k in DP_LAUNCHES[path, layout]},
               "replicas_equal_every_step": True}
        if mesh.rank == 0:
            state = snapshot(trainer)
            ref = Trainer(create_model("deepfm", packed, cfg, device=DEVICE),
                          packed, cfg)
            ref_losses = [ref._train_step(*batch_on(b, dev)).item()
                          for b in batches]
            diff = state_diff(state, snapshot(ref), DP_BAND)
            loss_rel = max(rel_err(a, b) for a, b in zip(losses, ref_losses))
            rec["one_process"] = {
                "losses": ref_losses, "loss_rel_err": loss_rel,
                "max_abs_err": diff,
                # one process's device ms at the rank's row count
                "device_ms_rank_rows": step_profile(
                    lambda: ref._train_step(*local[0]))["device_ms"]}
            if loss_rel > DP_LOSS_REL or diff["outside_band"]:
                failures.append(f"{case}: two ranks against one process: "
                                f"{rec['one_process']}")
            if case == "sparse_fused_logical":
                # the control: one process again on the same batches with
                # their rows permuted (the same sums in another order),
                # how far DP_STEPS bf16 steps part when nothing but the
                # order of the sums changes
                control = Trainer(create_model("deepfm", packed, cfg,
                                               device=DEVICE), packed, cfg)
                for b, seed in zip(batches, range(DP_STEPS)):
                    order = np.random.default_rng(seed).permutation(
                        len(b.labels))
                    control._train_step(*batch_on(dataclasses.replace(
                        b, ids=b.ids[order], dense=b.dense[order],
                        labels=b.labels[order], weights=b.weights[order]),
                        dev))
                rec["one_process"]["control_permuted_rows"] = state_diff(
                    snapshot(control), snapshot(ref), DP_BAND)
                del control
            del ref, state
            free_device()
        collectives.barrier(mesh)
        rec["profile_step"] = step_profile(
            lambda: trainer._train_step(*local[0]))
        log = []
        with timed_collectives(log):
            trainer._train_step(*local[0])
        trainer.check_replicas(f"{case} after the profiled steps")
        rec["collectives"] = collective_summary(log)
        rec["collective_bytes"] = sum(c["bytes"] for c in log)
        rec["collective_ms"] = sum(c["ms"] for c in log)
        if not all(map(math.isfinite, losses)):
            failures.append(f"{case}: a loss is not finite: {losses}")
        out[case] = rec
        del trainer, local
        free_device()
    return {"cases": out, "failures": failures}


def dp_small_step(mesh, small, arrays, path: str, fault: str | None):
    """One DP step at SMALL_VOCAB ids, f32, GRAD_BATCH rows on ``path``
    under a planted ``fault``: the state after it, whether the replicas
    agree, and (rank 0) the comparison with one process on the card."""
    import torch

    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.training.parity import compare_leaves
    from deepfm_tpu_torch.training.trainer import Trainer

    extra = {} if path == "sparse_fused" else {"fused_backward": False}
    cfg = bench_config(DEVICE, compute_dtype="float32",
                       moments_dtype="float32", **extra)
    trainer = Trainer(create_model("deepfm", small, cfg, mesh=mesh), small,
                      cfg, mesh=mesh)
    with dp_fault(fault):
        loss = trainer._train_step(*dp_local(arrays, mesh, mesh.device))
    try:
        trainer.check_replicas(f"{path} under {fault}")
        replica_refusal = None
    except RuntimeError as e:
        replica_refusal = str(e)
    rec = {"loss": loss.item(), "replica_refusal": replica_refusal}
    if mesh.rank == 0:
        ref = Trainer(create_model("deepfm", small, cfg, device=DEVICE),
                      small, cfg)
        ref_loss = ref._train_step(*batch_on(arrays, mesh.device)).item()
        cmp = compare_leaves(snapshot(trainer), snapshot(ref), LR, steps=1,
                             zero_gradient=trainer.model.zero_gradient_leaves)
        rec["one_process"] = {"loss_rel_err": rel_err(loss.item(), ref_loss),
                              **cmp}
        rec["one_process_refused"] = bool(
            cmp["failed_leaves"]
            or rec["one_process"]["loss_rel_err"] > TRAIN_TOL["cpu_loss_rel"])
        del ref
    del trainer
    torch.cuda.synchronize()
    return rec


def dp_checks(mesh) -> dict:
    """At SMALL_VOCAB ids per field, f32, GRAD_BATCH rows: one step of each
    path against one process (training/parity.py, the share limit on: the
    first step is held tighter), the first-step gradients of the two-pass
    path (the exchange's table gradient) against the CPU's (grad_check),
    and the planted faults (DP_FAULTS), each of which must be refused."""
    import torch

    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.training.trainer import Trainer

    small, arrays = bench_workload(SMALL_VOCAB)
    arrays = head_rows(arrays, GRAD_BATCH)
    failures = []
    steps = {p: dp_small_step(mesh, small, arrays, p, None)
             for p in ("sparse_fused", "two_pass")}
    for p, rec in steps.items():
        if rec["replica_refusal"] or rec.get("one_process_refused"):
            failures.append(f"{p}: one f32 step against one process: {rec}")

    cfg = bench_config(DEVICE, compute_dtype="float32", fused_backward=False)
    cpu_cfg = bench_config("cpu", compute_dtype="float32",
                           fused_backward=False)

    def dp_grads(fault):
        trainer = Trainer(create_model("deepfm", small, cfg, mesh=mesh),
                          small, cfg, mesh=mesh)
        step = trainer._step_fn
        with dp_fault(fault):
            loss, grads = step.forward_backward(
                *dp_local(arrays, mesh, mesh.device))
            with torch.no_grad():
                loss, grads, _ = step.reduce_partials(loss, grads)
        return loss.item(), {n: g.detach().cpu() for n, g in grads.items()}

    grads = {"sound": dp_grads(None),
             "skip_exchange_gather": dp_grads("skip_exchange_gather")}
    faults = {f: dp_small_step(mesh, small, arrays, "sparse_fused", f)
              for f in DP_FAULTS}
    out = {"one_step": steps, "faults": faults}
    if mesh.rank == 0:
        zero = create_model("deepfm", small, cpu_cfg,
                            device="cpu").zero_gradient_leaves
        cpu_loss, want = first_step_grads(small, arrays, "cpu", cpu_cfg)
        checks = {}
        for name, (loss, got) in grads.items():
            c = grad_check(got, want, zero)
            checks[name] = {"loss_rel_err": rel_err(loss, cpu_loss),
                            "worst_max_rel": c["worst_max_rel"],
                            "worst_norm_rel": c["worst_norm_rel"],
                            "failed_leaves": c["failed_leaves"],
                            "refused": not c["ok"] or rel_err(
                                loss, cpu_loss) > TRAIN_TOL["cpu_loss_rel"]}
        out["first_step_grads_vs_cpu"] = checks
        if checks["sound"]["refused"]:
            failures.append(f"first-step gradients, two ranks against the "
                            f"CPU: {checks['sound']}")
        if not checks["skip_exchange_gather"]["refused"]:
            failures.append("the exchange without its gather passed the "
                            "first-step gradient check")
        for f, by in DP_FAULTS.items():
            refused = (faults[f]["replica_refusal"] is not None
                       if by == "replicas"
                       else faults[f]["one_process_refused"])
            faults[f]["refused"] = refused
            if not refused:
                failures.append(f"planted fault {f} was not refused by the "
                                f"{by} check: {faults[f]}")
    torch.cuda.synchronize()
    out["failures"] = failures
    return out


def dp_steps(mesh) -> dict:
    full = dp_full_width(mesh)
    checks = dp_checks(mesh)
    return {"full_width": full["cases"], "checks": checks,
            "failures": full["failures"] + checks["failures"]}


def dp_world1(mesh) -> dict:
    """A world of one rank under NCCL, through the data-parallel code path
    (a mesh, its collectives, the replicated sparse-fused path), against
    the mesh-less trainer: DP_STEPS steps at bench.py's full width, every
    state tensor and loss equal bit for bit."""
    import torch

    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    packed, _ = bench_workload(BENCH_VOCAB)
    batches = [batch_on(bench_workload(BENCH_VOCAB, seed=s)[1], mesh.device)
               for s in range(DP_STEPS)]
    cfg = bench_config(DEVICE)
    runs = {}
    for name, m in (("mesh", mesh), ("mesh_less", None)):
        trainer = Trainer(create_model("deepfm", packed, cfg, device=DEVICE,
                                       mesh=m), packed, cfg, mesh=m)
        losses = [trainer._train_step(*b).item() for b in batches]
        runs[name] = (losses, trainer.replica_state(), trainer.path)
    (l0, s0, p0), (l1, s1, p1) = runs["mesh"], runs["mesh_less"]
    differ = [n for n in s1 if not torch.equal(s0[n], s1[n])]
    failures = [] if (l0 == l1 and not differ and p0 == p1) else [
        f"world 1 under NCCL against the mesh-less trainer: losses {l0} / "
        f"{l1}, paths {p0} / {p1}, differing tensors {differ[:8]}"]
    return {"losses": l0, "tensors_compared": len(s1),
            "bit_equal": not failures, "failures": failures}


# ---------------------------------------------------------------------------
# model_sharded
# ---------------------------------------------------------------------------


def ms_case(name: str):
    return next(c for c in (*MS_CASES, MS_GATHER_CASE) if c[0] == name)


def ms_config(case: str, **training):
    """configs/deepfm_criteo_multichip.yaml on the card for ``case``: its
    table layout, embedding strategy and fused_backward (and the row-gather
    kernel for MS_GATHER_CASE), and ``training`` overrides."""
    from deepfm_tpu_torch.config import load_config

    _, layout, strategy, fused = ms_case(case)
    gather = str(case == MS_GATHER_CASE[0]).lower()
    return load_config(REPO / "configs" / MULTICHIP_CONFIG, [
        f"device={DEVICE}", f"pallas.table_layout={layout}",
        f"pallas.use_embedding_kernel={gather}",
        f"mesh.embedding_strategy={strategy}",
        f"training.fused_backward={str(fused).lower()}",
        *(f"training.{k}={v}" for k, v in training.items())])


def ms_whole(trainer) -> dict:
    """``snapshot`` of a sharded trainer with whole tables and moments:
    the slabs gathered over the model group, on the card (every rank
    calls it)."""
    from deepfm_tpu_torch.parallel import collectives, is_table_path

    group = trainer.mesh.model_group
    out = {}
    for name, t in snapshot(trainer).items():
        if is_table_path(name):
            t = collectives.all_gather_rows(group, t.float()).to(t.dtype)
        out[name] = t
    return out


def ms_trainer(mesh, packed, case: str, **training):
    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.training.trainer import Trainer

    cfg = ms_config(case, **training)
    return Trainer(create_model(cfg.model_name, packed, cfg, mesh=mesh),
                   packed, cfg, mesh=mesh), cfg


def ms_one_process(packed, cfg, batches):
    """One process on the card at the same global batches: (trainer,
    losses)."""
    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.training.trainer import Trainer

    ref = Trainer(create_model(cfg.model_name, packed, cfg, device=DEVICE),
                  packed, cfg)
    return ref, [ref._train_step(*batch_on(b, ref.device)).item()
                 for b in batches]


def collective_kinds(log: list) -> dict:
    """A step's collectives by kind: the all-to-alls (the lookup's
    buckets and rows), the data-group gathers (pairs, scores), the
    model-group sums (the psum lookup, the clip norm's table terms,
    table_psq) and gathers (the all-to-all lookup's rows), the data-group
    all-reduces (the flat one, BatchNorm's, the weight sum) and the
    world's flags: calls, bytes sent, host ms."""
    out = {}
    for c in log:
        kind = {"all_to_all_rows": "all_to_all",
                "all_gather_rows": f"{c['group']}_gather",
                "all_reduce_": f"{c['group']}_sum"}[c["op"]]
        rec = out.setdefault(kind, {"calls": 0, "bytes": 0, "ms": 0.0})
        rec["calls"] += 1
        rec["bytes"] += c["bytes"]
        rec["ms"] += c["ms"]
    return out


def ms_full_width(mesh) -> dict:
    """MS_CASES at the multichip config's full width on the (2, 2) mesh:
    MS_STEPS steps on each rank's data index's rows of MS_STEPS global
    batches, the replicas checked after every step, the launches counted
    from 0; the whole state (slabs gathered) then held by rank 0 against
    one process on the same global batches (MS_BAND, DP_LOSS_REL; the
    first case also beside a one-process control on row-permuted
    batches); then one profiled step and one step with its collectives
    timed by kind."""
    import numpy as np
    import torch

    from deepfm_tpu_torch.parallel import collectives, embedding_shard

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    packed, _ = bench_workload(BENCH_VOCAB)
    batches = [bench_workload(BENCH_VOCAB, seed=s)[1]
               for s in range(MS_STEPS)]
    out, failures = {}, []
    for case, layout, strategy, fused in MS_CASES:
        trainer, cfg = ms_trainer(mesh, packed, case)
        path = "sparse_fused" if fused else "two_pass"
        if trainer.path != path:
            failures.append(f"{case}: took the {trainer.path} path")
        local = [dp_local(b, mesh, dev) for b in batches]
        for k in embedding_shard.fallbacks:
            embedding_shard.fallbacks[k] = 0
        # --- the main path: every kernel count starts at 0 here ---------
        reset_counts()
        losses, times = [], []
        for i, batch in enumerate(local):
            s0 = time.perf_counter()
            loss = trainer._train_step(*batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - s0)
            losses.append(loss.item())
            trainer.check_replicas(f"{case} step {i + 1}")
        counts = read_counts()
        # --- end of the main path ----------------------------------------
        check_launches(case, counts, MS_LAUNCHES[case], failures)
        rec = {"layout": layout, "strategy": strategy, "path": trainer.path,
               "losses": losses, "step_ms": [1e3 * t for t in times],
               "step_ms_median": 1e3 * statistics.median(times),
               "launches": {k: counts[k] for k in MS_LAUNCHES[case]},
               "fallbacks": dict(embedding_shard.fallbacks),
               "slab_rows": {n: trainer.params[n].shape[0]
                             for n in trainer.table_names},
               "replicas_equal_every_step": True}
        whole = ms_whole(trainer)
        if mesh.rank == 0:
            ref, ref_losses = ms_one_process(packed, cfg, batches)
            diff = state_diff(whole, snapshot(ref), MS_BAND)
            loss_rel = max(rel_err(a, b) for a, b in zip(losses, ref_losses))
            rec["one_process"] = {"losses": ref_losses,
                                  "loss_rel_err": loss_rel,
                                  "max_abs_err": diff}
            if loss_rel > DP_LOSS_REL or diff["outside_band"]:
                failures.append(f"{case}: (2, 2) against one process: "
                                f"{rec['one_process']}")
            if case == MS_CASES[0][0]:
                control, _ = ms_one_process(packed, cfg, [])
                for b, seed in zip(batches, range(MS_STEPS)):
                    order = np.random.default_rng(seed).permutation(
                        len(b.labels))
                    control._train_step(*batch_on(dataclasses.replace(
                        b, ids=b.ids[order], dense=b.dense[order],
                        labels=b.labels[order], weights=b.weights[order]),
                        dev))
                rec["one_process"]["control_permuted_rows"] = state_diff(
                    snapshot(control), snapshot(ref), MS_BAND)
                del control
            del ref
        del whole
        free_device()
        collectives.barrier(mesh)
        rec["profile_step"] = step_profile(
            lambda: trainer._train_step(*local[0]))
        log = []
        with timed_collectives(log, mesh):
            trainer._train_step(*local[0])
        trainer.check_replicas(f"{case} after the profiled steps")
        rec["collectives"] = collective_kinds(log)
        rec["collective_bytes"] = sum(c["bytes"] for c in log)
        rec["collective_ms"] = sum(c["ms"] for c in log)
        if not all(map(math.isfinite, losses)):
            failures.append(f"{case}: a loss is not finite: {losses}")
        out[case] = rec
        del trainer, local
        free_device()
    return {"cases": out, "failures": failures}


@contextlib.contextmanager
def ms_fault(name: str | None, mesh):
    """A planted fault of the model-sharded step (MS_FAULTS), undone on
    exit: "world_reduce" (the flat all-reduce of the dense gradients over
    the world, not the data group), "no_shift" (each slab takes the
    global sorted ids unshifted); "peer_rows" is ``ms_rows``'."""
    from deepfm_tpu_torch.parallel import collectives
    from deepfm_tpu_torch.training import steps

    undo = []
    if name == "world_reduce":
        real = collectives.all_reduce_flat
        undo.append((collectives, "all_reduce_flat", real))
        collectives.all_reduce_flat = lambda g, ts: real(mesh.world_group,
                                                         ts)
    elif name == "no_shift":
        undo.append((steps, "slab_ids", steps.slab_ids))
        steps.slab_ids = lambda sids, j, rows: sids
    try:
        yield
    finally:
        for owner, attr, value in undo:
            setattr(owner, attr, value)


def ms_rows(arrays, mesh, fault):
    """The rank's rows of a global batch on its device; under "peer_rows"
    those of data index rank % data (model peers get different rows)."""
    if fault != "peer_rows":
        return dp_local(arrays, mesh, mesh.device)
    per = len(arrays.labels) // mesh.data
    i = mesh.rank % mesh.data
    return batch_on(head_rows(dataclasses.replace(
        arrays, ids=arrays.ids[i * per:], dense=arrays.dense[i * per:],
        labels=arrays.labels[i * per:], weights=arrays.weights[i * per:]),
        per), mesh.device)


def ms_small_step(mesh, small, arrays, case: str, fault=None,
                  shrunk: bool = False):
    """One step at SMALL_VOCAB ids, f32, GRAD_BATCH rows of ``case``
    (under a planted ``fault``, or with the capacities MS_SHRUNK): this
    rank's state after it, the fallbacks taken, the kernels it launched,
    and whether the replicas agree."""
    import torch

    from deepfm_tpu_torch.parallel import embedding_shard

    saved = {k: getattr(embedding_shard, k) for k in MS_SHRUNK}
    if shrunk:
        for k, v in MS_SHRUNK.items():
            setattr(embedding_shard, k, v)
    for k in embedding_shard.fallbacks:
        embedding_shard.fallbacks[k] = 0
    try:
        trainer, cfg = ms_trainer(mesh, small, case, compute_dtype="float32",
                                  moments_dtype="float32")
        batch = ms_rows(arrays, mesh, fault)
        reset_counts()
        with ms_fault(fault, mesh):
            loss = trainer._train_step(*batch).item()
        launches = {k: v for k, v in read_counts().items() if v}
    finally:
        for k, v in saved.items():
            setattr(embedding_shard, k, v)
    try:
        trainer.check_replicas(f"{case} under {fault}")
        refusal = None
    except RuntimeError as e:
        refusal = str(e)
    whole = ms_whole(trainer)
    out = {"loss": loss, "replica_refusal": refusal, "state": snapshot(
        trainer), "whole": whole if mesh.rank == 0 else None,
        "fallbacks": dict(embedding_shard.fallbacks), "cfg": cfg,
        "launches": launches}
    del trainer
    torch.cuda.synchronize()
    return out


def ms_vs_one_process(mesh, small, arrays, got: dict) -> dict:
    """``ms_small_step``'s result against one process's step on the same
    global batch (rank 0; every rank gives its replica check): the whole
    state under training/parity.py's one-step f32 rule, the share limit
    on, and the loss within TRAIN_TOL's cpu_loss_rel; ``refused`` when
    either check or the replica check fails."""
    from deepfm_tpu_torch.training.parity import compare_leaves

    rec = {"replica_refusal": got["replica_refusal"]}
    if mesh.rank != 0:
        return rec
    ref, ref_loss = ms_one_process(small, got["cfg"], [arrays])
    cmp = compare_leaves(got["whole"], snapshot(ref), LR, steps=1,
                         zero_gradient=ref.model.zero_gradient_leaves)
    rec.update(loss_rel_err=rel_err(got["loss"], ref_loss[0]),
               max_abs_err=cmp["max_abs_err"],
               max_share_outside_tol=cmp["max_share_outside_tol"],
               failed_leaves=cmp["failed_leaves"][:8])
    rec["refused"] = bool(got["replica_refusal"] or cmp["failed_leaves"]
                          or rec["loss_rel_err"] > TRAIN_TOL["cpu_loss_rel"])
    del ref
    return rec


def ms_fused_grads(mesh, small, arrays, case: str):
    """The first-step gradients of a sparse-fused ``case`` on the mesh (f32,
    clip 0), where no table gradient is formed: each table's densified
    from the pairs the step hands ``sparse_table_adam`` on the rank's slab
    (the ids outside it dropped; plain densify), the slabs gathered over
    the model group; the dense leaves' as the step hands them to the
    dense update, less the decay wd * p of the embedding leaves. (loss,
    name -> gradient on the CPU), the same on every rank."""
    import torch

    from deepfm_tpu_torch.ops.kernels.grad import densify_rows_grad_plain
    from deepfm_tpu_torch.ops.kernels.packed_grad import (
        densify_rows_grad_packed_plain,
    )
    from deepfm_tpu_torch.parallel import collectives
    from deepfm_tpu_torch.training import steps

    trainer, cfg = ms_trainer(mesh, small, case, compute_dtype="float32",
                              moments_dtype="float32", gradient_clip_norm=0.0)
    wd = 2.0 * cfg.feature.embedding_l2_reg
    name_of = {t.data_ptr(): n for n, t in trainer.params.items()}
    got, slabs = {}, {}
    real_adam, real_apply = steps.sparse_table_adam, trainer.tx.apply

    def adam_spy(p, mu, nu, sids, cts, *args, pack):
        rows = p.shape[0] * pack
        keep = (sids >= 0) & (sids < rows)
        ids, ct = sids[keep].long().cpu(), cts[keep].float().cpu()
        slabs[name_of[p.data_ptr()]] = (
            densify_rows_grad_plain(ct, ids, rows) if pack == 1 else
            densify_rows_grad_packed_plain(ct, ids, rows, pack))
        return real_adam(p, mu, nu, sids, cts, *args, pack=pack)

    def apply_spy(dense, params, opt_state):
        for n, g in dense.items():
            got[n] = (g - wd * params[n] if n.startswith("embedding.")
                      else g).detach().cpu()
        return real_apply(dense, params, opt_state)

    steps.sparse_table_adam, trainer.tx.apply = adam_spy, apply_spy
    try:
        loss = trainer._train_step(*dp_local(arrays, mesh, mesh.device))
    finally:
        steps.sparse_table_adam = real_adam
        del trainer.tx.apply
    for n in sorted(slabs):
        got[n] = collectives.all_gather_rows(
            mesh.model_group, slabs[n].to(mesh.device)).cpu()
    del trainer
    return loss.item(), got, cfg


def ms_checks(mesh) -> dict:
    """At SMALL_VOCAB ids per field, f32, GRAD_BATCH rows on the (2, 2)
    mesh: one step of every MS_CASE and of MS_GATHER_CASE against one
    process (``ms_vs_one_process``: training/parity.py's one-step f32
    rule, the share limit on; the gather case's kernels counted); the
    routed cases with their capacities shrunk (MS_SHRUNK) against the same
    steps unshrunk (the one-step f32 rule, every rank on its own slabs;
    the fallbacks counted); every case's first-step gradients, slabs
    gathered, against the CPU's (grad_check: the two-pass cases' from the
    exchange, the sparse-fused cases' from the pairs their kernel takes,
    ``ms_fused_grads``); and the planted faults (MS_FAULTS), each refused
    by the same comparison with one process or the replica check, their
    readings beside the sound steps'."""
    import torch

    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.parallel import collectives, is_table_path
    from deepfm_tpu_torch.training.parity import compare_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    small, arrays = bench_workload(SMALL_VOCAB)
    arrays = head_rows(arrays, GRAD_BATCH)
    failures = []
    out = {"sound": {}, "overflow": {}, "grads": {}, "faults": {}}
    plain = {}
    for case in (*(c[0] for c in MS_CASES), MS_GATHER_CASE[0]):
        got = ms_small_step(mesh, small, arrays, case)
        rec = ms_vs_one_process(mesh, small, arrays, got)
        rec["launches"] = got["launches"]
        if got["replica_refusal"] or rec.get("refused"):
            failures.append(f"{case}: one f32 step at (2, 2) against one "
                            f"process: {rec}")
        if case == MS_GATHER_CASE[0] and not all(
                got["launches"].get(k, 0) > 0 for k in MS_GATHER_LAUNCHES):
            failures.append(f"{case}: launched {got['launches']}, not each "
                            f"of {MS_GATHER_LAUNCHES}")
        out["sound"][case] = rec
        if case in ("routed_packed", "routed_two_pass"):
            plain[case] = got
        del got
    for case, unshrunk in plain.items():
        shrunk = ms_small_step(mesh, small, arrays, case, shrunk=True)
        cmp = compare_leaves(shrunk["state"], unshrunk["state"], LR, steps=1)
        rec = {"fallbacks": shrunk["fallbacks"],
               "unshrunk_fallbacks": unshrunk["fallbacks"],
               "failed_leaves": cmp["failed_leaves"],
               "loss_rel_err": rel_err(shrunk["loss"], unshrunk["loss"])}
        taken = ("lookup", "route_sorted_pairs") if case == "routed_packed" \
            else ("lookup", "exchange")
        if cmp["failed_leaves"] or rec["loss_rel_err"] > TRAIN_TOL[
                "cpu_loss_rel"] or not all(
                    shrunk["fallbacks"][k] > 0 for k in taken) or any(
                    unshrunk["fallbacks"].values()):
            failures.append(f"{case} with its capacities shrunk: {rec}")
        out["overflow"][case] = rec
        del shrunk
    del plain

    def two_pass_grads(case):
        trainer, cfg = ms_trainer(mesh, small, case, compute_dtype="float32")
        step = trainer._step_fn
        loss, grads = step.forward_backward(
            *dp_local(arrays, mesh, mesh.device))
        with torch.no_grad():
            loss, grads, _ = step.reduce_partials(loss, grads)
        whole = {n: (collectives.all_gather_rows(mesh.model_group, g)
                     if is_table_path(n) else g).detach().cpu()
                 for n, g in grads.items()}
        del trainer
        return loss.item(), whole, cfg

    for case, _, _, fused in MS_CASES:
        loss, got, cfg = (ms_fused_grads(mesh, small, arrays, case) if fused
                          else two_pass_grads(case))
        if mesh.rank == 0:
            cpu_cfg = dataclasses.replace(cfg, device="cpu")
            zero = create_model("deepfm", small, cpu_cfg,
                                device="cpu").zero_gradient_leaves
            cpu_loss, want = first_step_grads(small, arrays, "cpu", cpu_cfg)
            c = grad_check(got, want, zero)
            rec = {"loss_rel_err": rel_err(loss, cpu_loss),
                   "worst_max_rel": c["worst_max_rel"],
                   "worst_norm_rel": c["worst_norm_rel"],
                   "failed_leaves": c["failed_leaves"]}
            out["grads"][case] = rec
            if not c["ok"] or rec["loss_rel_err"] > TRAIN_TOL["cpu_loss_rel"]:
                failures.append(f"{case}: first-step gradients against the "
                                f"CPU: {rec}")
    for fault, case in MS_FAULTS.items():
        got = ms_small_step(mesh, small, arrays, case, fault)
        rec = ms_vs_one_process(mesh, small, arrays, got)
        if mesh.rank == 0 and not rec["refused"]:
            failures.append(f"planted fault {fault} was not refused: {rec}")
        out["faults"][fault] = rec
        del got
    torch.cuda.synchronize()
    out["failures"] = failures
    return out


def ms_steps(mesh) -> dict:
    full = ms_full_width(mesh)
    checks = ms_checks(mesh)
    return {"full_width": full["cases"], "checks": checks,
            "failures": full["failures"] + checks["failures"]}


def ms_exact(mesh) -> dict:
    """MS_EXACT_CASES on a (1, 2) mesh at full width, f32, clip 0,
    MS_STEPS steps: with one data row every sum but the clip norm's table
    terms is the one process's, in its order, so every slab (gathered),
    table moment and dense leaf must equal the one-process run's bit for
    bit; the leaves that do not are named, and held to training/parity.py's
    f32 rule."""
    import torch

    from deepfm_tpu_torch.training.parity import compare_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    packed, _ = bench_workload(BENCH_VOCAB)
    batches = [bench_workload(BENCH_VOCAB, seed=s)[1]
               for s in range(MS_STEPS)]
    out, failures = {}, []
    for case in MS_EXACT_CASES:
        trainer, cfg = ms_trainer(mesh, packed, case,
                                  compute_dtype="float32",
                                  moments_dtype="float32",
                                  gradient_clip_norm=0.0)
        losses = [trainer._train_step(*dp_local(b, mesh, mesh.device)).item()
                  for b in batches]
        whole = ms_whole(trainer)
        del trainer
        free_device()
        if mesh.rank == 0:
            ref, ref_losses = ms_one_process(packed, cfg, batches)
            want = snapshot(ref)
            differ = [n for n in want if not torch.equal(whole[n], want[n])]
            cmp = compare_leaves({n: whole[n] for n in differ},
                                 {n: want[n] for n in differ}, LR,
                                 steps=MS_STEPS)
            out[case] = {"losses_equal": losses == ref_losses,
                         "tensors": len(want), "differing": differ,
                         "differing_failed_f32_rule": cmp["failed_leaves"]}
            if losses != ref_losses or differ:
                failures.append(f"{case} at (1, 2) is not one process's bits: "
                                f"{out[case]}")
            del ref, want
        del whole
        free_device()
    return {"cases": out, "failures": failures}


def ms_kernel_slabs() -> dict:
    """sparse_table_adam on each slab of a (., 2) mesh, both layouts: the
    table-kernel phase's inputs (bench.py's 10.4M x 17 table, bf16
    moments, an active clip), the sorted global stream shifted by -j *
    (the slab's logical rows), so slab 0 sees ids past its top and slab 1
    negative ones; against the plain version on the slab (adam_check: the
    moments bit for bit, p within TABLE_TOL, sum(p'^2), a second launch
    the same bits) and the whole table's kernel update on the slab's rows
    (bit for bit); timed beside the slab's bound."""
    import torch

    from deepfm_tpu_torch.ops.kernels.sparse_adam import (
        sort_pairs,
        sparse_table_adam,
        sparse_table_adam_plain,
    )
    from deepfm_tpu_torch.utils.layout import pack_table

    dev = torch.device(DEVICE)
    ids, ct, p, mu, nu, args = table_inputs(dev)
    sids, cts = sort_pairs(ids, ct)
    rows = BENCH_FIELDS * BENCH_VOCAB
    phys = packed_rows_of(rows)
    out, failures = {}, []
    for layout, pack in (("logical", 1), ("packed", PACK)):
        state = ([p, mu, nu] if pack == 1 else
                 [pack_table(t, D, PACK, phys) for t in (p, mu, nu)])
        whole = [t.clone() for t in state]
        sparse_table_adam(*whole, sids, cts, *args, pack=pack)
        half = state[0].shape[0] // 2
        for j in (0, 1):
            lo = j * half
            local = sids - j * half * pack

            def fresh(lo=lo):
                return [t[lo:lo + half].clone() for t in state]

            def kernel(*a):
                return sparse_table_adam(*a, pack=pack)

            def plain(*a):
                return sparse_table_adam_plain(*a, pack=pack)

            rec = adam_check(kernel, plain, fresh, (local, cts), args)
            k = fresh()
            kernel(*k, local, cts, *args)
            rec["bit_equal_to_whole_table_update"] = all(
                bool(torch.equal(a, b[lo:lo + half]))
                for a, b in zip(k, whole))
            inside = int(((local >= 0) & (local < half * pack)).sum())
            rec["ids_outside_slab"] = sids.numel() - inside
            # the slab's p, mu and nu read and written once, and the
            # slab's own pairs read (a tile finds its range by a search)
            rec["bound_ms"] = mem_bound_ms(
                half * state[0].shape[1] * (8 + 2 * 2 * 2)
                + inside * (4 + 4 * D))
            rec["bound_by"] = "bytes"
            if not (rec["ok"] and rec["bit_equal_to_whole_table_update"]):
                failures.append(f"sparse_table_adam on slab {j} ({layout}): "
                                f"{rec}")
            out[f"{layout}_slab{j}"] = rec
            del k
        del state, whole
        torch.cuda.empty_cache()
    return {"cases": out, "failures": failures}


def ss_config(tmp: Path, run: str, extra=()):
    """train_loop's MovieLens xDeepFM config on the checkpoint of
    dp_train_loop's ``run`` (EXPORT_NEG_EVAL eval negatives, as it was
    trained), with ``extra`` overrides."""
    from deepfm_tpu_torch.config import load_config

    return load_config(REPO / "configs" / TRAIN_LOOP_CONFIG, [
        f"data.data_dir={movielens_data(tmp)}",
        f"data.num_neg_eval={EXPORT_NEG_EVAL}", f"device={DEVICE}",
        f"output_dir={tmp / run / 'whole'}", *extra])


@contextlib.contextmanager
def recorded_scores(cls):
    """Meanwhile, (scores, seconds) of every ``cls.predict`` call, in
    order."""
    real = cls.predict
    seen = []

    def predict(self, data):
        t0 = time.perf_counter()
        scores = real(self, data)
        seen.append((scores, time.perf_counter() - t0))
        return scores

    cls.predict = predict
    try:
        yield seen
    finally:
        cls.predict = real


def ss_commands(mesh, tmp: str) -> dict:
    """One of SS_WORLD ranks: ``predict`` over the synthetic u.data at each
    mesh of SS_MESHES into a file of the rank's own (rank 0 alone may
    write), its scores saved beside it, the command's and the scoring's
    seconds and cin_stack_fwd's launches counted from 0; then
    ``recommend`` at (1, 2), its stdout kept."""
    import io

    import numpy as np

    from deepfm_tpu_torch.cli import predict_command, recommend_command
    from deepfm_tpu_torch.training.trainer import Trainer

    tmp = Path(tmp)
    data = movielens_data(tmp)
    out = {"predict": {}}
    for name, (run, extra) in SS_MESHES.items():
        path = tmp / f"ss_{name}_rank{mesh.rank}.tsv"
        reset_counts()
        t0 = time.perf_counter()
        with recorded_scores(Trainer) as seen:
            predict_command(ss_config(tmp, run, extra), str(data / "u.data"),
                            str(path))
        (scores, predict_s), = seen
        np.save(tmp / f"ss_{name}_rank{mesh.rank}.npy", scores)
        out["predict"][name] = {
            "command_s": time.perf_counter() - t0, "predict_s": predict_s,
            "rows": len(scores), "wrote": path.exists(),
            "launches": read_counts()["cin_stack_fwd"]}
    run, extra = SS_MESHES["a2a_1x2"]
    text = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(text):
        recommend_command(ss_config(tmp, run, extra), RECOMMEND_USER,
                          RECOMMEND_K, include_seen=False)
    out["recommend"] = {"stdout": text.getvalue(),
                        "launches": read_counts()["cin_stack_fwd"]}
    return out


def plain_attention(q, k, v):
    """Unsharded softmax attention over fields, (B, F, H, Dh), in q's
    dtype."""
    import torch

    s = torch.einsum("bqhd,bkhd->bqhk", q, k) / math.sqrt(q.shape[-1])
    return torch.einsum("bqhk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


@contextlib.contextmanager
def ring_fault(name: str | None, m: int):
    """Meanwhile, ``collectives.ring_shift`` replaced by a RING_FAULTS
    fault (none for None)."""
    import torch

    from deepfm_tpu_torch.parallel import collectives

    real = collectives.ring_shift
    if name == "skip_last_hop":
        hops = [0]

        def shift(group, t):
            hops[0] += 1
            return t if hops[0] % (m - 1) == 0 else real(group, t)
    elif name == "wrong_way":
        class WrongWay(torch.autograd.Function):
            @staticmethod
            def forward(ctx, t, group):
                ctx.group = group
                return collectives._shift(group, t, -1)

            @staticmethod
            def backward(ctx, grad):
                return collectives._shift(ctx.group, grad, -1), None

        def shift(group, t):
            return WrongWay.apply(t, collectives._group(group))
    else:
        assert name is None, name
        shift = real
    collectives.ring_shift = shift
    try:
        yield
    finally:
        collectives.ring_shift = real


def ring_check(mesh, dtype: str, fault: str | None = None) -> dict:
    """The rank's ring_field_attention of RING_SHAPE's seeded q, k, v (the
    same on every rank) in ``dtype``, forward and the gradients of
    sum(out²), against unsharded attention on the card (f32, on the same
    inputs): each max |Δ| and whether the check passes (RING_TOL in f32,
    RING_BF16_MAX_REL in bf16)."""
    import torch

    from deepfm_tpu_torch.parallel import field_block, ring_field_attention

    gen = torch.Generator(device=mesh.device).manual_seed(0)
    whole = [torch.randn(RING_SHAPE, generator=gen, device=mesh.device)
             .to(getattr(torch, dtype)) for _ in range(3)]
    ref_in = [w.float().clone().requires_grad_() for w in whole]
    ref = plain_attention(*ref_in)
    (ref ** 2).sum().backward()
    want = {"out": field_block(mesh, ref.detach())}
    want.update({f"d{n}": field_block(mesh, t.grad)
                 for n, t in zip("qkv", ref_in)})
    del ref, ref_in
    blocks = [field_block(mesh, w).clone().requires_grad_() for w in whole]
    with ring_fault(fault, mesh.model):
        out = ring_field_attention(*blocks, mesh)
        (out.float() ** 2).sum().backward()
    got = {"out": out.detach()}
    got.update({f"d{n}": b.grad for n, b in zip("qkv", blocks)})
    rec = {}
    for key, w in want.items():
        g = got[key].float()
        err = float((g - w).abs().max())
        if dtype == "float32":
            rtol, atol = RING_TOL["out" if key == "out" else "grads"]
            ok = bool(torch.allclose(g, w, rtol=rtol, atol=atol))
        else:
            ok = err <= RING_BF16_MAX_REL * float(w.abs().max())
        rec[key] = {"max_abs_err": err, "max_abs_ref": float(w.abs().max()),
                    "ok": ok}
    rec["ok"] = all(r["ok"] for r in rec.values())
    return rec


def ss_ring(mesh) -> dict:
    """One of RING_AXES's ranks: ring attention in f32 and bf16 against
    unsharded attention (ring_check), the planted faults (RING_FAULTS),
    and the host-clock ms of an f32 call (forward; forward and backward)
    and of one hop of the stacked K/V block, with the bytes a rank sends."""
    import torch

    from deepfm_tpu_torch.parallel import (
        collectives,
        field_block,
        ring_field_attention,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"checks": {dtype: ring_check(mesh, dtype)
                      for dtype in ("float32", "bfloat16")},
           "faults": {f: ring_check(mesh, "float32", f)
                      for f in RING_FAULTS}}
    free_device()
    gen = torch.Generator(device=mesh.device).manual_seed(1)
    q, k, v = (field_block(mesh, torch.randn(RING_SHAPE, generator=gen,
                                             device=mesh.device))
               .contiguous().requires_grad_() for _ in range(3))
    kv = torch.stack([k.detach(), v.detach()])

    def clocked(fn):
        times = []
        for _ in range(RING_REPS + 1):
            collectives.barrier(mesh.model_group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times[1:])

    def forward():
        with torch.no_grad():
            ring_field_attention(q, k, v, mesh)

    def forward_backward():
        (ring_field_attention(q, k, v, mesh) ** 2).sum().backward()

    hops = mesh.model - 1
    out.update({
        "call_ms": clocked(forward),
        "call_fwd_bwd_ms": clocked(forward_backward),
        "hop_ms": clocked(lambda: collectives.ring_shift(
            mesh.model_group, kv)),
        "hops_a_call": hops,
        "bytes_a_call": hops * kv.numel() * kv.element_size(),
        "block": list(q.shape)})
    return out


DP_PARTS = {"steps": dp_steps, "world1": dp_world1, "ms_steps": ms_steps,
            "ms_exact": ms_exact, "ss_commands": ss_commands,
            "ss_ring": ss_ring}


def dp_train_loop(tmp: Path, ranks: int = DP_WORLD, extra=(),
                  run: str = "dp_loop", phase: str = "data_parallel"
                  ) -> dict:
    """``python -m torch.distributed.run --nproc-per-node ranks -m
    deepfm_tpu_torch train`` on train_loop's MovieLens xDeepFM (f32, full
    width; EXPORT_NEG_EVAL eval negatives, cut from 999 for the phase's
    time; ``extra`` overrides, such as a model axis) for
    TRAIN_LOOP_EPOCHS epochs; a one-process ``evaluate`` of its
    checkpoint; a run of 1 epoch resumed to TRAIN_LOOP_EPOCHS under the
    same launch. The checkpoint's tables must be whole: the one-process
    evaluate loads them strictly."""
    import torch

    from deepfm_tpu_torch.cli import evaluate_command
    from deepfm_tpu_torch.config import load_config

    data_dir = movielens_data(tmp)
    root = tmp / run

    def overrides(name, epochs):
        return [f"data.data_dir={data_dir}", f"training.num_epochs={epochs}",
                f"data.num_neg_eval={EXPORT_NEG_EVAL}",
                "training.resume=true", f"device={DEVICE}",
                f"output_dir={root / name}", *extra]

    def torchrun(name, epochs):
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc-per-node", str(ranks), "--master-addr",
               "localhost", "--master-port", str(free_port()),
               "-m", "deepfm_tpu_torch", "train", "--config",
               str(REPO / "configs" / TRAIN_LOOP_CONFIG), "--override",
               *overrides(name, epochs)]
        t0 = time.perf_counter()
        # its own session, so that a launch past its time is stopped with
        # every rank it started
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=DP_RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"{phase}: {' '.join(cmd[2:6])} train {name} exited "
                 f"{proc.returncode}: {out[-3000:]}")
        return time.perf_counter() - t0

    def clock_free(history):
        return [{k: v for k, v in h.items() if k not in HISTORY_CLOCK}
                for h in history]

    failures = []
    whole_s = torchrun("whole", TRAIN_LOOP_EPOCHS)
    files = sorted(p.name for p in (root / "whole").iterdir())
    results = json.loads((root / "whole" / "results.json").read_text())
    info = results["training_info"]
    config = load_config(REPO / "configs" / TRAIN_LOOP_CONFIG,
                         overrides("whole", TRAIN_LOOP_EPOCHS))
    want_mesh = {"data": ranks // max(config.mesh.model_axis, 1),
                 "model": max(config.mesh.model_axis, 1)}
    if files.count("results.json") != 1 or files.count("best_model.pt") != 1 \
            or any("rank" in f for f in files):
        failures.append(f"files written: {files}")
    missing = [k for k in ("cin_stack_fwd", "cin_stack_bwd")
               if k not in info["kernels"]]
    if missing or info["mesh"] != want_mesh or info["num_devices"] != ranks:
        failures.append(f"training_info {info}: {missing} not launched on "
                        f"every rank, or not a {want_mesh} mesh")
    # the one-process evaluate loads the checkpoint strictly into a model
    # of whole tables: slabs would not load
    saved = torch.load(root / "whole" / "best_model.pt", weights_only=True)
    table_shapes = {n: list(saved[n].shape) for n in saved
                    if "table_w" in n}
    del saved
    t0 = time.perf_counter()
    evaluated = evaluate_command(load_config(
        REPO / "configs" / TRAIN_LOOP_CONFIG,
        [o for o in overrides("whole", TRAIN_LOOP_EPOCHS)
         if not o.startswith("mesh.")]))
    evaluate_s = time.perf_counter() - t0
    last_is_best = info["best_epoch"] == info["total_epochs"]
    if evaluated["val"] != results["val_metrics"] or (
            last_is_best and evaluated["test"] != results["test_metrics"]):
        failures.append(f"one-process evaluate {evaluated} differs from "
                        f"the {ranks}-rank run's {results['val_metrics']} / "
                        f"{results['test_metrics']}")
    free_device()
    first_s = torchrun("resumed", 1)
    resume_s = torchrun("resumed", TRAIN_LOOP_EPOCHS)
    resumed = json.loads((root / "resumed" / "results.json").read_text())
    same = clock_free(resumed["history"]) == clock_free(results["history"])
    if not same:
        failures.append(f"the resumed history {resumed['history']} differs "
                        f"from the unbroken run's {results['history']}")
    return {"config": f"configs/{TRAIN_LOOP_CONFIG}", "ranks": ranks,
            "overrides": list(extra),
            "epochs": TRAIN_LOOP_EPOCHS, "files": files,
            "checkpoint_tables": table_shapes,
            "train_s": whole_s, "first_epoch_s": first_s,
            "resume_s": resume_s, "evaluate_s": evaluate_s,
            "epoch_seconds": [h["epoch_seconds"] for h in results["history"]],
            "examples_per_sec": [h["examples_per_sec"]
                                 for h in results["history"]],
            "examples_per_sec_per_device": info[
                "examples_per_sec_per_device"],
            "training_info_kernels": info["kernels"],
            "backward": info["backward"], "mesh": info["mesh"],
            "test_metrics": results["test_metrics"],
            "evaluate_reproduces_val": evaluated["val"] == results[
                "val_metrics"],
            "evaluate_reproduces_test": evaluated["test"] == results[
                "test_metrics"],
            "resumed_history_equal": same, "failures": failures}


def phase_data_parallel(tmp: Path, gpu: str) -> dict:
    """Data-parallel training on torch.distributed (module docstring)."""
    t0 = time.perf_counter()
    ranks = spawn_ranks(DP_WORLD, "steps", tmp)
    steps_s = time.perf_counter() - t0
    world1 = spawn_ranks(1, "world1", tmp)[0]
    t0 = time.perf_counter()
    loop = dp_train_loop(tmp)
    loop_s = time.perf_counter() - t0
    failures = [f for r in ranks for f in r["failures"]]
    failures += world1["failures"] + loop["failures"]
    full = {case: {"rank": [r["full_width"][case] for r in ranks]}
            for case in ranks[0]["full_width"]}
    out = {
        "phase": "data_parallel", "gpu": gpu, "ranks": DP_WORLD,
        "backend": ranks[0]["backend"], "backend_rule": ranks[0]["rule"],
        "devices": [r["device"] for r in ranks],
        "batch": BENCH_BATCH, "rows_per_rank": BENCH_BATCH // DP_WORLD,
        "steps": DP_STEPS, "steps_s": steps_s, "full_width": full,
        "checks": ranks[0]["checks"],
        "world1_nccl": {k: world1[k] for k in
                        ("backend", "bit_equal", "tensors_compared",
                         "losses")},
        "train_loop": loop, "train_loop_s": loop_s,
        "tol": {"loss_rel": DP_LOSS_REL, "band": DP_BAND,
                "one_step": "training/parity.py, share limit on",
                "grads": {"max_rel": GRAD_MAX_REL, "norm_rel": GRAD_NORM_REL}},
        "ok": not failures,
    }
    emit(out)
    summary = {case: {
        "step_ms_median": [r["step_ms_median"] for r in rec["rank"]],
        "device_ms": [r["profile_step"]["device_ms"] for r in rec["rank"]],
        "collective_ms": [r["collective_ms"] for r in rec["rank"]],
        "collective_mb": [r["collective_bytes"] / 1e6 for r in rec["rank"]],
        "one_process_device_ms_rank_rows":
            rec["rank"][0]["one_process"]["device_ms_rank_rows"],
        "vs_one_process": {
            "loss_rel_err": rec["rank"][0]["one_process"]["loss_rel_err"],
            **rec["rank"][0]["one_process"]["max_abs_err"]},
        "control_permuted_rows": rec["rank"][0]["one_process"].get(
            "control_permuted_rows")}
        for case, rec in full.items()}
    print(f"data_parallel ({gpu}; {DP_WORLD} ranks, {out['backend']}: "
          f"{out['backend_rule']}): {json.dumps(summary)}", flush=True)
    if failures:
        fail("; ".join(failures))
    return out


def phase_model_sharded(tmp: Path, gpu: str) -> dict:
    """Model-sharded tables on torch.distributed (module docstring)."""
    t0 = time.perf_counter()
    ranks = spawn_ranks(MS_AXES[0] * MS_AXES[1], "ms_steps", tmp)
    steps_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exact = spawn_ranks(2, "ms_exact", tmp)[0]
    exact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slabs = ms_kernel_slabs()
    slabs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loop = dp_train_loop(tmp, ranks=2, run="ms_loop", phase="model_sharded",
                         extra=("mesh.model_axis=2",
                                "mesh.embedding_strategy=all_to_all"))
    loop_s = time.perf_counter() - t0
    failures = [f for r in ranks for f in r["failures"]]
    failures += exact["failures"] + slabs["failures"] + loop["failures"]
    full = {case: {"rank": [r["full_width"][case] for r in ranks]}
            for case in ranks[0]["full_width"]}
    out = {
        "phase": "model_sharded", "gpu": gpu, "mesh": list(MS_AXES),
        "backend": ranks[0]["backend"], "backend_rule": ranks[0]["rule"],
        "devices": [r["device"] for r in ranks],
        "config": f"configs/{MULTICHIP_CONFIG}", "batch": BENCH_BATCH,
        "rows_per_rank": BENCH_BATCH // MS_AXES[0], "steps": MS_STEPS,
        "full_width": full, "checks": ranks[0]["checks"],
        "exact_1x2": exact["cases"], "kernel_slabs": slabs["cases"],
        "train_loop": loop,
        "seconds": {"steps": steps_s, "exact": exact_s,
                    "kernel_slabs": slabs_s, "train_loop": loop_s},
        "tol": {"loss_rel": DP_LOSS_REL, "band": MS_BAND,
                "exact": "bit for bit at (1, 2), f32, clip 0",
                "one_step": "training/parity.py, one f32 step, share "
                            "limit on",
                "overflow": "training/parity.py, one f32 step",
                "grads": {"max_rel": GRAD_MAX_REL, "norm_rel": GRAD_NORM_REL},
                "kernels": TABLE_TOL},
        "ok": not failures,
    }
    emit(out)
    summary = {case: {
        "step_ms_median": [r["step_ms_median"] for r in rec["rank"]],
        "device_ms": [r["profile_step"]["device_ms"] for r in rec["rank"]],
        "launches": rec["rank"][0]["launches"],
        "collectives_rank0": rec["rank"][0]["collectives"],
        "collective_ms": [r["collective_ms"] for r in rec["rank"]],
        "collective_mb": [r["collective_bytes"] / 1e6 for r in rec["rank"]],
        "vs_one_process": {
            "loss_rel_err": rec["rank"][0]["one_process"]["loss_rel_err"],
            **rec["rank"][0]["one_process"]["max_abs_err"]},
        "control_permuted_rows": rec["rank"][0]["one_process"].get(
            "control_permuted_rows")}
        for case, rec in full.items()}
    summary["kernel_slabs_ms"] = {k: [v["ms"], v["bound_ms"], v["plain_ms"]]
                                  for k, v in slabs["cases"].items()}
    checks = ranks[0]["checks"]
    summary["one_f32_step_vs_one_process"] = {
        case: {k: rec.get(k) for k in ("loss_rel_err", "max_abs_err",
                                      "max_share_outside_tol", "refused")}
        for part in ("sound", "faults") for case, rec in checks[part].items()}
    summary["first_step_grads_vs_cpu"] = checks["grads"]
    print(f"model_sharded ({gpu}; {MS_AXES[0] * MS_AXES[1]} ranks at "
          f"{MS_AXES}, {out['backend']}: {out['backend_rule']}): "
          f"{json.dumps(summary)}", flush=True)
    if failures:
        fail("; ".join(failures))
    return out


def torchrun_cmd(world: int, args: list) -> list:
    """``python -m torch.distributed.run --nproc-per-node world -m
    deepfm_tpu_torch ARGS`` on a free port of localhost."""
    return [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
            str(world), "--master-addr", "localhost", "--master-port",
            str(free_port()), "-m", "deepfm_tpu_torch", *args]


def children(pid: int) -> list:
    """The pids of ``pid``'s child processes (read from /proc)."""
    kids = []
    for entry in Path("/proc").iterdir():
        if entry.name.isdigit():
            try:
                stat = (entry / "stat").read_text()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                kids.append(int(entry.name))
    return kids


def ss_serve(tmp: Path) -> dict:
    """``serve`` under torchrun on SS_WORLD ranks at (1, 2) over the
    ms_loop checkpoint, against one process's ScoringService on the card:
    /health, /score of 1 row, of SS_SCORE_ROWS rows and an unknown pair,
    /recommend, SS_WARM_REQUESTS warm requests timed; then SIGINT to every
    rank, as torchrun sends it, and every rank must exit 0 (torchrun's own
    exit code is 0 only then) within SS_STOP_S."""
    import numpy as np

    from deepfm_tpu_torch.cli import _restore_predictor
    from deepfm_tpu_torch.serving import ScoringService

    run, extra = SS_MESHES["a2a_1x2"]
    data = movielens_data(tmp)
    raw = np.loadtxt(data / "u.data", dtype=np.int64)
    pick = np.random.default_rng(0).choice(len(raw), SS_SCORE_ROWS,
                                           replace=False)
    many = [[int(u), int(m)] for u, m in raw[pick, :2]] + [
        [10**9, int(raw[0, 1])]]
    one = many[:1]
    config = ss_config(tmp, run)
    adapter, packed, _, _, _, predictor, _ = _restore_predictor(config)
    service = ScoringService(adapter, packed, predictor, config.model_name)
    want = {"n_params": predictor.n_params,
            "one": service.score({"rows": one})["scores"],
            "many": service.score({"rows": many})["scores"],
            "recommend": service.recommend(RECOMMEND_USER, RECOMMEND_K)}
    del adapter, packed, predictor, service
    free_device()

    port = free_port()
    cmd = torchrun_cmd(SS_WORLD, [
        "serve", "--config", str(REPO / "configs" / TRAIN_LOOP_CONFIG),
        "--override",
        f"data.data_dir={data}", f"data.num_neg_eval={EXPORT_NEG_EVAL}",
        f"device={DEVICE}", f"output_dir={tmp / run / 'whole'}", *extra,
        "--port", str(port)])
    log = tmp / "ss_serve.log"
    base = f"http://127.0.0.1:{port}"
    got, failures = {}, []
    t0 = time.perf_counter()
    with open(log, "w") as sink:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=sink,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    try:
        while True:
            if proc.poll() is not None:
                fail(f"sharded_scoring: serve exited {proc.returncode} "
                     f"before it answered: {log.read_text()[-3000:]}")
            if time.perf_counter() - t0 > SS_SERVE_START_S:
                fail(f"sharded_scoring: serve did not answer in "
                     f"{SS_SERVE_START_S} s: {log.read_text()[-3000:]}")
            try:
                _, got["health"], _ = _http("GET", f"{base}/health")
                break
            except OSError:
                time.sleep(0.5)
        start_s = time.perf_counter() - t0
        _, body, _ = _http("POST", f"{base}/score", {"rows": one})
        got["one"] = body["scores"]
        _, body, _ = _http("POST", f"{base}/score", {"rows": many})
        got["many"] = body["scores"]
        _, got["recommend"], _ = _http(
            "GET", f"{base}/recommend?user={RECOMMEND_USER}&k={RECOMMEND_K}")
        warm_ms = [_http("POST", f"{base}/score", {"rows": many})[2]
                   for _ in range(SS_WARM_REQUESTS)]
        ranks = children(proc.pid)
        t1 = time.perf_counter()
        for pid in ranks:
            os.kill(pid, signal.SIGINT)
        try:
            rc = proc.wait(timeout=SS_STOP_S)
        except subprocess.TimeoutExpired:
            rc = None
        stop_s = time.perf_counter() - t1
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    text = log.read_text()
    if rc != 0 or len(ranks) != SS_WORLD:
        failures.append(f"serve: SIGINT to ranks {ranks}: torchrun exited "
                        f"{rc} after {stop_s:.1f} s: {text[-3000:]}")
    stopped = text.count("stopped by rank 0 after")
    if stopped != SS_WORLD - 1:
        failures.append(f"serve: {stopped} followers logged their stop")
    if got["health"].get("n_params") != want["n_params"]:
        failures.append(f"serve: /health {got['health']}, one process "
                        f"counts {want['n_params']} parameters")

    def score_err(a, b):
        if [x is None for x in a] != [x is None for x in b]:
            return math.inf
        return max((abs(x - y) for x, y in zip(a, b) if x is not None),
                   default=0.0)

    errs = {k: score_err(got[k], want[k]) for k in ("one", "many")}
    rec_got = [(it["item"], it["score"]) for it in got["recommend"]["items"]]
    rec_want = [(it["item"], it["score"]) for it in want["recommend"]["items"]]
    errs["recommend"] = (
        max(abs(a[1] - b[1]) for a, b in zip(rec_got, rec_want))
        if [i for i, _ in rec_got] == [i for i, _ in rec_want] else math.inf)
    if got["many"][-1] is not None or max(errs.values()) > SERVE_TOL:
        failures.append(f"serve: max |Δ| from one process {errs} (tol "
                        f"{SERVE_TOL}); unknown pair {got['many'][-1]}")
    return {"start_s": start_s, "stop_s": stop_s, "exit_code": rc,
            "ranks": len(ranks), "followers_stopped": stopped,
            "n_params": got["health"].get("n_params"),
            "n_params_one_process": want["n_params"],
            "max_abs_err": errs,
            "bit_for_bit": {k: got[k] == want[k] for k in ("one", "many")},
            "warm_score_ms": warm_ms, "warm_rows": len(many),
            "failures": failures}


def phase_sharded_scoring(tmp: Path, gpu: str) -> dict:
    """Sharded batch scoring and ring attention (module docstring)."""
    import io

    import numpy as np

    from deepfm_tpu_torch.cli import predict_command, recommend_command
    from deepfm_tpu_torch.training.predict import Predictor

    data = movielens_data(tmp)
    failures, seconds = [], {}
    # --- one process on the card: the reference -------------------------
    t0 = time.perf_counter()
    one = {}
    for name, (run, _) in SS_MESHES.items():
        with recorded_scores(Predictor) as seen:
            t1 = time.perf_counter()
            predict_command(ss_config(tmp, run), str(data / "u.data"),
                            str(tmp / f"ss_{name}_one.tsv"))
        (scores, predict_s), = seen
        one[name] = {"scores": scores, "command_s": time.perf_counter() - t1,
                     "predict_s": predict_s}
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        recommend_command(ss_config(tmp, SS_MESHES["a2a_1x2"][0]),
                          RECOMMEND_USER, RECOMMEND_K, include_seen=False)
    one_top = read_top_k(text.getvalue())
    free_device()
    seconds["one_process"] = time.perf_counter() - t0

    # --- the main path: the commands on every rank, launches from 0 -----
    t0 = time.perf_counter()
    ranks = spawn_ranks(SS_WORLD, "ss_commands", tmp, (str(tmp),))
    seconds["ranks"] = time.perf_counter() - t0
    predict = {}
    for name in SS_MESHES:
        want = one[name]["scores"]
        got = [np.load(tmp / f"ss_{name}_rank{r}.npy")
               for r in range(SS_WORLD)]
        rows_same = (tmp / f"ss_{name}_rank0.tsv").read_text() == (
            tmp / f"ss_{name}_one.tsv").read_text()
        errs = [float(np.abs(g - want).max()) if g.shape == want.shape
                else math.inf for g in got]
        rec = {"rows": len(want), "max_abs_err": max(errs),
               "bit_for_bit": all(np.array_equal(g, want) for g in got),
               "same_rows_and_file": rows_same,
               "written": [r["predict"][name]["wrote"] for r in ranks],
               "launches": [r["predict"][name]["launches"] for r in ranks],
               "command_s": [r["predict"][name]["command_s"] for r in ranks],
               "predict_s": [r["predict"][name]["predict_s"] for r in ranks],
               "one_process_command_s": one[name]["command_s"],
               "one_process_predict_s": one[name]["predict_s"]}
        predict[name] = rec
        if not rows_same or rec["max_abs_err"] > SERVE_TOL:
            failures.append(f"predict {name}: same rows and file "
                            f"{rows_same}, max |Δ| {rec['max_abs_err']}")
        if rec["written"] != [True] + [False] * (SS_WORLD - 1):
            failures.append(f"predict {name}: files written {rec['written']}")
        if min(rec["launches"]) < 1:
            failures.append(f"predict {name}: cin_stack_fwd launches "
                            f"{rec['launches']}")
    # --- the entry point: torchrun predict at (1, 2) --------------------
    run, extra = SS_MESHES["a2a_1x2"]
    out_tsv = tmp / "ss_torchrun.tsv"
    cmd = torchrun_cmd(SS_WORLD, [
        "predict", "--config", str(REPO / "configs" / TRAIN_LOOP_CONFIG),
        "--override", f"data.data_dir={data}",
        f"data.num_neg_eval={EXPORT_NEG_EVAL}", f"device={DEVICE}",
        f"output_dir={tmp / run / 'whole'}", *extra,
        "--input", str(data / "u.data"), "--output", str(out_tsv)])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=DP_RANK_TIMEOUT)
    seconds["torchrun_predict"] = time.perf_counter() - t0
    if proc.returncode != 0 or not out_tsv.exists() or out_tsv.read_text() \
            != (tmp / "ss_a2a_1x2_one.tsv").read_text():
        failures.append(f"torchrun predict exited {proc.returncode}, its "
                        f"file not the one process's: "
                        f"{(proc.stdout + proc.stderr)[-3000:]}")
    # --- recommend at (1, 2) --------------------------------------------
    top = read_top_k(ranks[0]["recommend"]["stdout"])
    top_err = max((abs(a[1] - b[1]) for a, b in zip(top, one_top)),
                  default=math.inf)
    recommend = {"top_k": top, "one_process": one_top,
                 "max_abs_err": top_err,
                 "same_items": [i for i, _ in top] == [i for i, _ in one_top],
                 "rank_1_printed": ranks[1]["recommend"]["stdout"] != "",
                 "launches": [r["recommend"]["launches"] for r in ranks]}
    if not recommend["same_items"] or top_err > SERVE_TOL or recommend[
            "rank_1_printed"] or len(top) != RECOMMEND_K:
        failures.append(f"recommend at (1, 2): {recommend}")
    # --- serve on the ranks, stopped by SIGINT ---------------------------
    t0 = time.perf_counter()
    serve = ss_serve(tmp)
    seconds["serve"] = time.perf_counter() - t0
    failures += serve["failures"]
    # --- ring attention ---------------------------------------------------
    t0 = time.perf_counter()
    ring = spawn_ranks(RING_AXES[0] * RING_AXES[1], "ss_ring", tmp)
    seconds["ring"] = time.perf_counter() - t0
    for r, rec in enumerate(ring):
        for dtype, check in rec["checks"].items():
            if not check["ok"]:
                failures.append(f"ring attention rank {r} {dtype}: {check}")
        for fault, check in rec["faults"].items():
            if check["ok"]:
                failures.append(f"ring attention rank {r}: the planted "
                                f"fault {fault} passed: {check}")
    # every rank must refuse each fault: the check of the refusing key
    # may differ by rank, not the verdict
    ring_summary = {
        "shape": list(RING_SHAPE), "axes": list(RING_AXES),
        "block": ring[0]["block"],
        "max_abs_err": {dtype: {k: max(r["checks"][dtype][k]["max_abs_err"]
                                       for r in ring)
                                for k in ("out", "dq", "dk", "dv")}
                        for dtype in ("float32", "bfloat16")},
        "max_abs_ref_bf16": {k: max(r["checks"]["bfloat16"][k]["max_abs_ref"]
                                    for r in ring)
                             for k in ("out", "dq", "dk", "dv")},
        "faults_max_abs_err": {f: {k: max(r["faults"][f][k]["max_abs_err"]
                                          for r in ring)
                                   for k in ("out", "dq", "dk", "dv")}
                               for f in RING_FAULTS},
        "faults_refused": {f: all(not r["faults"][f]["ok"] for r in ring)
                           for f in RING_FAULTS},
        "call_ms": [r["call_ms"] for r in ring],
        "call_fwd_bwd_ms": [r["call_fwd_bwd_ms"] for r in ring],
        "hop_ms": [r["hop_ms"] for r in ring],
        "hops_a_call": ring[0]["hops_a_call"],
        "bytes_a_call": ring[0]["bytes_a_call"],
        "tol": {"float32": RING_TOL, "bfloat16_max_rel": RING_BF16_MAX_REL}}
    out = {
        "phase": "sharded_scoring", "gpu": gpu, "ranks": SS_WORLD,
        "backend": ranks[0]["backend"], "backend_rule": ranks[0]["rule"],
        "config": f"configs/{TRAIN_LOOP_CONFIG}", "predict": predict,
        "recommend": recommend, "serve": serve, "ring_attention":
        ring_summary, "seconds": seconds, "tol": SERVE_TOL,
        "ok": not failures}
    emit(out)
    print(f"sharded_scoring ({gpu}; {SS_WORLD} ranks, {out['backend']}: "
          f"{out['backend_rule']}): "
          + json.dumps({
              "predict": {n: {k: p[k] for k in (
                  "max_abs_err", "bit_for_bit", "launches", "command_s",
                  "one_process_command_s")} for n, p in predict.items()},
              "serve": {k: serve[k] for k in (
                  "max_abs_err", "bit_for_bit", "warm_score_ms", "stop_s",
                  "exit_code")},
              "ring": {k: ring_summary[k] for k in (
                  "max_abs_err", "faults_refused", "call_ms", "hop_ms",
                  "bytes_a_call")},
              "seconds": seconds}), flush=True)
    if failures:
        fail("; ".join(failures))
    return out


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    if not (REPO / "deepfm_tpu_torch" / "__init__.py").is_file():
        fail(f"no deepfm_tpu_torch package beside {Path(__file__).name}: "
             "run it from a checkout of the repository")
    sys.path.insert(0, str(REPO))

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return result

    gpu = timed("build", phase_build)
    cin = timed("cin_stack", phase_cin_stack)
    cin_bwd = timed("cin_stack_bwd", phase_cin_stack_bwd)
    cin_layer = timed("cin_compress", phase_cin_compress)
    attn = timed("attention", phase_attention)
    table = timed("table_kernels", phase_table_kernels)
    packed_k = timed("packed_kernels", phase_packed_kernels)
    train = timed("train", phase_train)
    train_packed = timed("train_packed", phase_train_packed)
    models = timed("train_models", phase_train_models)
    paper = timed("train_xdeepfm_paper", phase_train_xdeepfm_paper)
    autoint = timed("train_autoint", phase_train_autoint)
    timed("train_baselines", phase_train_baselines, gpu)
    timed("train_lazy", phase_train_lazy, gpu)
    serve = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for cfg, layout in SERVE_CONFIGS:
            serve[cfg] = timed(f"serve {cfg}", phase_serve, Path(tmp), cfg,
                               layout)
        timed("train_loop", phase_train_loop, Path(tmp))
        timed("predict_recommend", phase_predict_recommend, Path(tmp), gpu)
        timed("export", phase_export, Path(tmp), gpu)
        timed("packed_store", phase_packed_store, Path(tmp), gpu)
        timed("data_parallel", phase_data_parallel, Path(tmp), gpu)
        timed("model_sharded", phase_model_sharded, Path(tmp), gpu)
        timed("sharded_scoring", phase_sharded_scoring, Path(tmp), gpu)
    emit({"phase_seconds": seconds, "total_seconds": sum(seconds.values())})
    kernels = []
    # (name, source, replaces, launches on its main path, its numbers at
    # that path's shape)
    for name, source, replaces, launches, rec in (
        ("cin_stack_fwd", "cin_stack_fwd.cu", "cin_stack_kernel.py:646",
         serve[SERVE_CONFIGS[0][0]]["launches"]["cin_stack_fwd"],
         cin["serving"]),
        ("cin_stack_fwd_mma", "cin_stack_fwd_mma.cu", "cin_stack_kernel.py:646",
         models["xdeepfm"]["launches"]["cin_stack_fwd_mma"],
         cin["bench_bf16"]),
        ("cin_stack_bwd", "cin_stack_bwd.cu", "cin_stack_kernel.py:742",
         models["xdeepfm"]["launches_first_step_grads_f32"]["cin_stack_bwd"],
         cin_bwd["bench_f32"]),
        ("cin_stack_bwd_mma", "cin_stack_bwd_mma.cu", "cin_stack_kernel.py:742",
         models["xdeepfm"]["launches"]["cin_stack_bwd_mma"],
         cin_bwd["bench_bf16"]),
        ("cin_compress", "cin_compress.cu", "cin_kernel.py:97",
         paper["f32_train"]["launches"]["cin_compress"],
         cin_layer["paper_layer1"]),
        ("attention_block_fwd", "attention_block.cu",
         "attention_fmajor_kernel.py:435",
         models["attention_deepfm"]["launches"]["attention_block_fwd"],
         attn["bench_bf16"]["forward"]),
        ("attention_block_bwd", "attention_bwd.cu",
         "attention_fmajor_kernel.py:476",
         models["attention_deepfm"]["launches"]["attention_block_bwd"],
         attn["bench_bf16"]["backward"]),
        # (the packed sparse_table_adam is the same kernel as the logical
        # one: its numbers are in the packed_kernels phase)
        ("segment_sumsq", "sparse_table_adam.cu", "sparse_adam_kernel.py:295",
         train["launches_sparse_fused"]["segment_sumsq"],
         table["segment_sumsq"]),
        ("sparse_table_adam", "sparse_table_adam.cu",
         "sparse_adam_kernel.py:429",
         train["launches_sparse_fused"]["sparse_table_adam"],
         table["sparse_table_adam"]),
        ("fused_table_adam", "fused_table_adam.cu", "adam_kernel.py:111",
         train["launches_two_pass"]["fused_table_adam"],
         table["fused_table_adam"]),
        ("densify_rows_grad", "densify_rows_grad.cu", "grad_kernel.py:237",
         train["launches_two_pass"]["densify_rows_grad"],
         table["densify_rows_grad"]),
        ("densify_rows_grad_packed", "densify_rows_grad_packed.cu",
         "packed_grad_kernel.py:256",
         train_packed["launches_two_pass"]["densify_rows_grad_packed"],
         packed_k["densify_rows_grad_packed"]),
        ("row_gather", "row_gather.cu", "embedding_kernel.py:110",
         train_packed["launches_row_gather"]["row_gather"],
         packed_k["row_gather"]),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"deepfm_tpu_torch/csrc/{source}",
            "replaces": f"deepfm_tpu/ops/pallas/{replaces}",
            "launches": launches,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        })
    kernels += interacting_kernel_rows(attn, autoint)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--attention-hashes"] and len(sys.argv) == 3:
        # another checkout's attention kernels on the attention phase's
        # inputs (its package first on the path; its kernels built there)
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        emit({"tree": sys.argv[2], "sha256": attention_hashes()})
    else:
        main()
