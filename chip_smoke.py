#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of NAVIS (``src/repro_torch``) on one
NVIDIA GPU and check every step.

Run from the repository root:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/``), holds each kernel against its plain PyTorch version at the
main path's shapes (the cache kernels, ``cache_replay`` and
``cache_ops``, bit for bit on every state field for each policy at 256
and 1,024 pages; ``pool_merge`` bit for bit with each route it takes
counted; ``casr_rerank`` on its ring and its direct route;
``entrance_search`` bit for bit against the host loop at the deep96 and
FineWeb-like widths, and timed on a wave of 10,000), times the merge and
CASR by case (``kernel_timings``) and the smallest launch,
then drives eight paths, each with the launch counts
set to 0 just before it and read just after:

- search: builds and searches a small index (the test suite's
  configuration) and a FineWeb-like 768-d one (the navis preset);
- update: on both indexes, insert waves (``insert_many``), sequential
  inserts and searches, deletes, and searches after them (navis);
- presets: the five baselines (and navis with bitmap visited sets on the
  small index) adopting each index's build (``build(shared=...)``):
  search and insert waves, sequential searches, FreshDiskANN's buffer,
  its search hits and ``merge``, and ``calibrate``; odinann's insert
  wave into the slots a pass reclaimed;
- maintenance: on the small index, ``consolidate`` after deletes (navis,
  odinann, FreshDiskANN), an insert wave into the freed slots and churn
  at capacity; on the FineWeb-like index after the update path, a pass
  over a fifth of it deleted, searches around it, insert waves drawn
  from the free list and a profiled repair step;
- sharded (``core/distributed.py``, all shards on the one card, the
  merge's gather through a one-rank NCCL group): the reference test's
  8 shards of 128, and half the FineWeb-like corpus in 8 shards of 1,250
  with a global codec: sharded search waves and a routed insert wave;
  and the sharded engine's dry-run (``distributed.dryrun``) of the
  FineWeb-like spec on both production meshes, on the host;
- serving (the LM substrate, ``repro_torch.launch.serve``): qwen2-0.5b at
  its published width (24 x 896, vocab 151,936, bf16, seeded random
  weights) serving batch 4 x 64 prompt tokens + 32 decode steps and
  batch 32 x 512 + 64, a float32 run against the same model on the host,
  and chunked against dense attention at 2 x 4,096 tokens; then each
  other architecture at its published widths, one at a time
  (``SERVE_MODELS``: the MoE moonshot-v1-16b-a3b whole, 56.1 GB;
  falcon-mamba-7b, hymba-1.5b and whisper-medium whole;
  llama-3.2-vision-90b at one period of its pattern and arctic-480b at one
  layer) at the launcher's 4 x 64 prompt tokens + 8 decode steps, and a
  float32 run
  against the host of each new layer kind at 2 layers;
- train (``repro_torch.train``, ``launch/train.py``, ``checkpoint/``):
  8 AdamW steps (bf16) of qwen2-0.5b at its published width at 8 x 256
  and 1 x 4,096 tokens, hymba-1.5b at 8 layers at 4 x 512 and whisper-medium
  whole at 4 x 448 (frames from the seed), each with its step time,
  tokens/s against the model FLOPs' bound, peak memory, launches and
  idle share, and one step's dot FLOPs counted on the card equal to the
  step analysis's count on meta tensors; the launcher as a subprocess
  (crash at step 3, resume
  from its checkpoint, against a run without the crash); float32 loss
  and gradients against the host at 2 layers, and the scan's backward
  against float64;
- mesh (``launch/mesh.py``, the expert-parallel MoE, ``launch/dryrun.py``):
  moonshot-v1-16b-a3b whole served at 4 x 64 + 8 through a 1 x 1 mesh on
  a one-rank NCCL group (prefill all-gathering the experts, decode keeping
  them 2-D sharded), equal bit for bit to the serve with no mesh under
  deterministic algorithms and in float32 at 2 layers within 1e-5, with
  the collectives of a prefill and a decode step equal to the step
  analysis's count of the same steps on meta tensors through a counting
  1 x 1 mesh (``launch/step_analysis.py``); then the dry-run (each
  cell's step analysis and memory model) over the 33 cells on both
  production meshes, on the host;
  then moonshot-v1-16b-a3b at its published widths cut to 4 layers,
  trained (AdamW, bf16) at 4 x 512 through the same mesh (the experts'
  backward through its collectives), bit for bit the run with no mesh
  under deterministic algorithms, and in float32 at 2 layers within
  1e-5 / 1e-4 of the host (its counts read apart, as ``mesh_train``);
  then the dense placement (every leaf held as its ``param_specs`` block
  and gathered on use; counts read as ``mesh_dense``): qwen2-0.5b and
  hymba-1.5b whole served at 4 x 64 + 8 and qwen2-0.5b trained at 8 x
  256 through the same mesh, bit for bit the runs with no mesh under
  deterministic algorithms, float32 at 2 layers against the host, and
  the collectives of a prefill, a decode and a train step, by part and
  with the backward's apart, equal to the counting mesh's; then RAG
  (``examples/rag_serving_torch.py``): the LM embeds 512
  documents, the navis index is built over them on the card
  and a wave of 256 embedded queries retrieves from it (its counts are
  read apart, as ``rag``).

The search and update paths must launch ``pool_merge``, ``adc_distance``,
``entrance_search`` and ``casr_rerank`` (once per search or insert wave)
and no other rerank entry; the presets path all of those,
``rerank_l2_rows`` (the full rerank) and ``rerank_l2_shared``
(FreshDiskANN's buffer scan, exactly once per FreshDiskANN search wave);
the maintenance path as the search path, and a pass itself launches no
rerank kernel; the sharded path as the search path, ``casr_rerank`` once
per shard and wave; the serving, training and mesh paths none of the
port's kernels (their products are ``torch.matmul``), and the RAG wave as
the search path.  Every engine
path replays its waves' traces with ``cache_replay`` (once a FineWeb-like
search wave; once an insert wave, with at most one ``cache_ops`` for its
commits' hints and admits), and the update and presets paths' threaded
traversals launch ``cache_ops`` once a hop; each FineWeb-like wave's
cache is held bit for bit against the host replay of the same calls.
``rerank_l2`` runs on no path (the kernel phase holds it).  After each
engine path one search wave and one insert wave (after the maintenance
path, one pass; after the sharded path, a sharded search and insert; after the
presets path also FreshDiskANN's search with its buffer full, and
``rerank_l2_shared`` on that buffer) are repeated with the plain versions
on the card (A/B).  Each phase prints one JSON
line; any failure exits non-zero without the final
result line.  With no CUDA device, or without the repository beside it,
it exits non-zero at once.
It takes no options: every run is the whole smoke.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_S = 67e12         # H100 SXM fp32 outside the tensor cores
WAVE = 256                  # lanes per kernel check and per query wave
PEAK_TF32_S = 495e12        # H100 SXM TF32 on the tensor cores, dense
RERANK_RTOL, RERANK_ATOL = 1e-5, 1e-3
# The cache kernels' check: every policy at the smoke's capacity (256
# pages) and the engine's default (1,024), on WAVE trace rows as wide as
# the FineWeb-like wave's (max_hops 96 x beam_width 4 + 1) with prefixes
# of 1-160 charged pages (the FineWeb-like waves charge 74-122 a lane),
# over tables of CACHE_P_MAX pages
CACHE_POLICIES = ("navis", "lru", "clock", "lfu", "none")
CACHE_CAPS = (256, 1024)
CACHE_ROW = 96 * 4 + 1
CACHE_P_MAX = 65_536
# The FineWeb-like cell (benchmarks/common.py:38-40, :72-77) keeps its
# widths and is cut in scale only: N vectors (the paper's corpora hold
# 60-120M; 20,000, not 100,000, so that the whole smoke, the mesh path's
# dense phase included, stays well inside its time limit on a slow host),
# built in seek waves of FINEWEB_BLOCK
# vertices instead of the benchmark's 64, which takes 8x as many
# host-bound waves per pass (tools/build_block_cut.py times both).
FINEWEB_N = 20_000
FINEWEB_BLOCK = 512
# The sharded path: the first SHARDS x SHARD_N vectors of the FineWeb-like
# corpus range-sharded into SHARDS shards of SHARD_N, each with
# SHARD_HEADROOM slots for inserts, all on the one card.  Cut to half the
# single engine's N (8 x 1,250) so that the whole smoke, with the
# training path, stays inside its time limit.
SHARDS = 8
SHARD_N = FINEWEB_N // SHARDS // 2
SHARD_HEADROOM = 1_200
# The serving path (the LM substrate): qwen2-0.5b at its published widths
# (src/repro/configs/qwen2_0_5b.py), bf16, weights drawn from a seed.
# SERVE_LOADS are (batch, prompt tokens, decode steps): the reference
# launcher's defaults, then a larger batch and prompt.  FP32_LOAD is the
# card-against-host check's, CHUNK_LOAD the (batch, tokens) of the
# chunked-attention check; RAG_QUERIES embedded queries make a RAG wave.
SERVE_ARCH = "qwen2-0.5b"
SERVE_LOADS = ((4, 64, 32), (32, 512, 64))
SERVE_MEM_BUDGET = 16 << 30   # bytes a serve may add to what is live
FP32_LOAD = (4, 64, 8)
CHUNK_LOAD = (2, 4096)
RAG_QUERIES = 256
# Then the serving path's other architectures, one at a time (each one's
# weights freed before the next), bf16, seeded random weights, at their
# published widths (src/repro/configs/<arch>.py), pinned by their
# parameter counts (the reference's T.param_count).  (arch, layers kept,
# loads): depth is cut only where the weights exceed the card,
# llama-3.2-vision-90b to one period of its pattern (4 attn + 1 cross
# layers; 175 GB in bf16 whole) and arctic-480b to 1 of its 35 layers
# (954 GB whole).  The load is the launcher's 4 x 64 prompt tokens with
# its 32 decode steps cut to SERVE_MODEL_DECODE; the larger ones (32 x
# 512 + 64 for each, 4 x 512 + 64 for llama-vision and 2 x 1,536 + 32
# for hymba, past its 1,024-slot rings) were cut to keep the whole smoke
# well inside its limit (qwen2-0.5b keeps 4 x 64 + 32 and 32 x 512 + 64,
# SERVE_LOADS; the CPU tests hold hymba's rings).
SERVE_MODEL_DECODE = 8
SERVE_MODELS = (
    ("moonshot-v1-16b-a3b", None, ((4, 64, SERVE_MODEL_DECODE),)),
    ("falcon-mamba-7b", None, ((4, 64, SERVE_MODEL_DECODE),)),
    ("hymba-1.5b", None, ((4, 64, SERVE_MODEL_DECODE),)),
    ("whisper-medium", None, ((4, 64, SERVE_MODEL_DECODE),)),
    ("llama-3.2-vision-90b", 5, ((4, 64, SERVE_MODEL_DECODE),)),
    ("arctic-480b", 1, ((4, 64, SERVE_MODEL_DECODE),)),
)
PUBLISHED_PARAMS = {
    "qwen2-0.5b": 494_032_768,
    "moonshot-v1-16b-a3b": 28_057_995_264, "falcon-mamba-7b": 7_272_665_088,
    "hymba-1.5b": 1_611_062_400, "whisper-medium": 846_202_880,
    "llama-3.2-vision-90b": 87_666_794_536, "arctic-480b": 476_850_275_328,
}
# The float32 card-against-host check of each new layer kind (MoE, mamba,
# hybrid, attn_cross) at full width, FP32_LAYERS deep, at FP32_LOAD.
FP32_MODELS = ("moonshot-v1-16b-a3b", "falcon-mamba-7b", "hymba-1.5b",
               "whisper-medium")
FP32_LAYERS = 2
# tanh gates of llama-vision's cross layers: zero at init, where a cross
# layer adds nothing, so the smoke opens them
CROSS_GATES = (0.7, -0.4)
# The training path (repro_torch.train, launch/train.py, checkpoint/):
# TRAIN_STEPS steps of AdamW (bf16 state, the cosine schedule) on one
# repeated TokenStream batch, bf16, seeded random weights, at published
# widths.  TRAIN_ARCH (the launcher's --arch) at TRAIN_LOADS (batch, seq):
# the launcher's default 8 x 256, then the train_4k cell's sequence of
# 4,096 with its global batch of 256 cut to 1; then TRAIN_MODELS (arch,
# layers kept, load): hymba-1.5b cut to 8 of its 32 layers (the scan's
# backward, the hybrid fuse, the windowed layers under autograd; its
# scan runs one step a token, so its depth sets the path's time) and
# whisper-medium whole (the encoder and cross-attention backward; frames
# [B, 1500, 1024] from the seed).  The launcher runs
# LAUNCHER_ARGS as a subprocess (4 steps: crash at step 3, resume, and a
# run without the crash; cut from 6 steps to keep the whole smoke under
# 900 s); TRAIN_FP32 holds float32 on the card against the
# host, each arch cut to TRAIN_FP32_LAYERS layers, at TRAIN_FP32_LOAD.
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_STEPS = 8
TRAIN_LOADS = ((8, 256), (1, 4096))
TRAIN_MODELS = (("hymba-1.5b", 8, (4, 512)),
                ("whisper-medium", None, (4, 448)))
LAUNCHER_ARGS = ("--arch", TRAIN_ARCH, "--full", "--steps", "4", "--batch",
                 "4", "--seq", "512", "--log-every", "1")
TRAIN_FP32 = ("qwen2-0.5b", "hymba-1.5b")
TRAIN_FP32_LAYERS = 2
TRAIN_FP32_LOAD = (2, 128)
PEAK_BF16_S = 989e12        # H100 SXM dense bf16 (NVIDIA data sheet)
# The mesh path (launch/mesh.py, the expert-parallel MoE, launch/dryrun.py):
# MESH_ARCH whole at its published widths (bf16, serving's seed) served at
# MESH_LOAD (the launcher's 4 x 64 prompt tokens, its 32 decode steps cut
# to 8 to keep the whole smoke well inside its limit) through a 1 x 1
# mesh on a one-rank NCCL group, against the same serve with no mesh
# (bit for bit under deterministic algorithms; in float32 at
# MESH_FP32_LAYERS layers within MESH_FP32_TOL); then the
# dry-run (each cell's step analysis and memory model) over every cell on
# both production meshes (DRYRUN_CELLS files), on the host.
MESH_ARCH = "moonshot-v1-16b-a3b"
MESH_LOAD = (4, 64, 8)
MESH_FP32_LAYERS = 2
MESH_FP32_TOL = 1e-5
DRYRUN_CELLS = 66
# Training over the mesh (make_train_step(rules=, mesh=)): MESH_ARCH at its
# published widths, bf16, its ArchSpec optimizer (AdamW, bf16 moments),
# cut to MESH_TRAIN_LAYERS of its 48 layers so that weights, gradients and
# moments (8 bytes a parameter) fit one card (4, not 8 as before, to keep
# the whole smoke well inside its limit); MESH_TRAIN_STEPS steps on one
# batch of MESH_TRAIN_LOAD (batch, seq), through the 1 x 1 mesh and with no
# mesh; float32 at MESH_FP32_LAYERS layers and TRAIN_FP32_LOAD through the
# mesh on the card against no mesh on the host.
MESH_TRAIN_LAYERS = 4
MESH_TRAIN_STEPS = 4
MESH_TRAIN_LOAD = (4, 512)
# The dense placement (every leaf held as its param_specs block, gathered
# on use): DENSE_SERVE at their published widths and depths (bf16,
# serving's seed) served at MESH_LOAD through the 1 x 1 mesh and with no
# mesh; DENSE_TRAIN trained MESH_TRAIN_STEPS AdamW steps at
# DENSE_TRAIN_LOAD through the mesh and with none; float32 at
# MESH_FP32_LAYERS layers through the mesh on the card against no mesh on
# the host.  Every collective is counted by part against the step
# analysis of the same step through a counting 1 x 1 mesh.
DENSE_SERVE = ("qwen2-0.5b", "hymba-1.5b")
DENSE_TRAIN = "qwen2-0.5b"
DENSE_TRAIN_LOAD = (8, 256)
DENSE_FP32_TOL = 1e-5

KERNELS = {
    "pool_merge": ("src/repro_torch/kernels/csrc/pool_merge.cu",
                   "src/repro/kernels/topk_pool.py:25"),
    "adc_distance": ("src/repro_torch/kernels/csrc/adc_distance.cu",
                     "src/repro/kernels/pq_adc.py:26"),
    "rerank_l2": ("src/repro_torch/kernels/csrc/rerank_l2.cu",
                  "src/repro/kernels/rerank_l2.py:29"),
    # the same kernel reading its rows in place by id (the full rerank)
    "rerank_l2_rows": ("src/repro_torch/kernels/csrc/rerank_l2.cu",
                       "src/repro/kernels/rerank_l2.py:29"),
    # every lane against the same rows, q.x on the tensor cores behind a
    # guard that recomputes near pairs with the row body (FreshDiskANN's
    # buffer scan)
    "rerank_l2_shared": ("src/repro_torch/kernels/csrc/rerank_l2_shared.cu",
                         "src/repro/kernels/rerank_l2.py:29"),
    # on the main path, the rerank kernel together with CASR's group loop
    # and its per-round merge (src/repro/core/casr.py:68)
    "casr_rerank": ("src/repro_torch/kernels/csrc/casr_rerank.cu",
                    "src/repro/kernels/rerank_l2.py:29"),
    # the cache's serial state machine: no Pallas kernel; its counterparts
    # are the reference's jitted replay of a wave's traces and its access
    # (with invalidate_page and priority_admit, the op stream's kinds)
    "cache_replay": ("src/repro_torch/kernels/csrc/cache_replay.cu",
                     "src/repro/core/cache.py:255"),
    "cache_ops": ("src/repro_torch/kernels/csrc/cache_replay.cu",
                  "src/repro/core/cache.py:275"),
    # the entrance's whole beam search, its ADC and merge fused: no Pallas
    # kernel; its counterpart is the reference's while_loop over
    # adc_distance_pallas and pool_merge_pallas
    "entrance_search": ("src/repro_torch/kernels/csrc/entrance_search.cu",
                        "src/repro/core/search.py:43"),
}
# Each path's launch gate: the kernels it must launch, and those it must
# not.  The navis preset's search and update paths rerank with CASR only,
# so no other rerank entry runs there; the presets path runs the full
# rerank through rerank_l2_rows and FreshDiskANN's buffer scan through
# rerank_l2_shared (once a FreshDiskANN search wave: BUFFER_SCANS).  The
# [B, S, D] entry rerank_l2 is on no path (the kernel phase holds it).
# Every engine path replays its waves' traces on the card (cache_replay);
# the sequential paths (update, presets) thread their traversals through
# cache_ops, one launch a hop.  Every engine path runs the entrance
# (entrance_search, one launch a search or seek).
NAVIS_OFF = ("rerank_l2", "rerank_l2_rows", "rerank_l2_shared")
PATH_KERNELS = {
    "search": (("pool_merge", "adc_distance", "casr_rerank",
                "cache_replay", "entrance_search"), NAVIS_OFF),
    "update": (("pool_merge", "adc_distance", "casr_rerank", "cache_replay",
                "cache_ops", "entrance_search"), NAVIS_OFF),
    "presets": (("pool_merge", "adc_distance", "rerank_l2_rows",
                 "rerank_l2_shared", "casr_rerank", "cache_replay",
                 "cache_ops", "entrance_search"), ("rerank_l2",)),
    # refine's re-seek and the repair splice launch pool_merge and
    # adc_distance; casr_rerank runs in the insert and search waves
    # around the passes (a pass itself launches no rerank kernel)
    "maintenance": (("pool_merge", "adc_distance", "casr_rerank",
                     "cache_replay", "entrance_search"), NAVIS_OFF),
    # every shard runs the navis search and insert waves (no buffer)
    "sharded": (("pool_merge", "adc_distance", "casr_rerank",
                 "cache_replay", "entrance_search"), NAVIS_OFF),
    # the LM serves with torch.matmul and plain torch ops: no kernel of the
    # port (the reference reaches no Pallas kernel there) ...
    "serving": ((), tuple(KERNELS)),
    # ... nor does training (its backward and optimizer are plain torch
    # too) ...
    "train": ((), tuple(KERNELS)),
    # ... nor does the mesh (its collectives are NCCL's, its products
    # torch.matmul), serving or training ...
    "mesh": ((), tuple(KERNELS)),
    "mesh_train": ((), tuple(KERNELS)),
    "mesh_dense": ((), tuple(KERNELS)),
    # ... and the RAG wave runs the navis search
    "rag": (("pool_merge", "adc_distance", "casr_rerank", "cache_replay",
             "entrance_search"), NAVIS_OFF),
}
# FreshDiskANN search waves the presets path ran (_scan_gate), each of
# which must launch rerank_l2_shared exactly once
BUFFER_SCANS = {"waves": 0}
# pool_merge's checks (P, Q, kind of _merge_case), each bit for bit and
# with the unsorted route taken by exactly the lanes whose pool is not
# ascending (which sorted route a sorted pool takes is the kernel's own
# tuning, and only has to be launched somewhere): the hop's (40, 192)
# and the seek's (64, 192), the entrance's (32, 32), FreshDiskANN's
# chunks of (10, 1,014), adversarial inputs, unsorted pools short and at
# the limit, and a sorted one of 512; together they reach all three routes
MERGE_CASES = ((40, 192, "grid"), (32, 32, "grid"), (10, 30, "grid"),
               (64, 128, "grid"), (40, 192, "all_equal"),
               (40, 192, "unsorted"), (40, 192, "signed_zero"),
               (64, 8, "grid"), (512, 512, "unsorted"), (64, 192, "grid"),
               (10, 1014, "grid"), (40, 192, "steady"), (64, 192, "steady"),
               (10, 1014, "steady"), (16, 32, "unsorted"),
               (512, 512, "grid"))
# the merges and CASR calls whose device time kernel_timings reports
MERGE_TIMED = ((40, 192, "grid"), (40, 192, "steady"), (64, 192, "grid"),
               (64, 192, "steady"), (32, 32, "grid"), (10, 1014, "grid"),
               (10, 1014, "steady"), (40, 192, "unsorted"),
               (512, 512, "unsorted"))
CASR_STORE = (100_000, 768)     # the synthetic store: FineWeb-like width
CASR_WIDE_STORE = (2_000, 8_192)   # D at the wrapper's limit (65.5 MB)
# (P, s, store, k): the hop's P 40 / s 4 and the seek's P 64 / s 8, the
# longest chain of rounds (s 1), the wrapper's limit (P 256), a top-k past
# 32 (its list in shared memory, not in the merge warp's registers), and
# S 8 at D 8,192, where two stages of the ring do not fit (rows read
# directly)
CASR_CASES = ((40, 4, "narrow", 10), (64, 8, "narrow", 10),
              (40, 1, "narrow", 10), (256, 8, "narrow", 10),
              (64, 8, "narrow", 40), (64, 8, "wide", 10))
CASR_K, CASR_DUP = 10, 2_000
# what the kernels line carries besides the kernels (launch_floor_ms)
KERNEL_LINE = {}
# entrance_search's checks: (label, M, c_max, codes) at the engine's
# ent_pool 32, r_ent 32 and max_hops 64: the deep96 cell's index (n_max
# 120,000, so c_max 2,400) and the FineWeb-like one (n_max 21,200: 424);
# the deep96 cell's wave of ENTRANCE_WAVE lanes is timed besides
ENTRANCE_CASES = (("deep96", 32, 2_400, 20_000),
                  ("fineweb_like", 96, 424, 20_000))
ENTRANCE_WAVE = 10_000
# the five baselines; the presets path also runs navis with bitmaps
BASELINES = ("freshdiskann", "odinann", "odinann_cache", "layout_only",
             "sel_vec")


class SmokeFailure(RuntimeError):
    pass


T_START = time.perf_counter()
# Past this many seconds the smoke dumps every thread's stack to standard
# error (and runs on), so that a run stopped at the 1,200 s limit shows
# where it was
STACKS_AFTER_S = 1_100


def emit(phase: str, **fields) -> None:
    """The phase's JSON line on standard output, and its time since the
    start on standard error (where a run that is stopped ended)."""
    print(json.dumps({"phase": phase, **fields}), flush=True)
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s {phase}",
          file=sys.stderr, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _launched_since(ops, before: dict) -> dict:
    """Each kernel's launches since the counts ``before``."""
    return {k: v - before[k] for k, v in ops.launches.items()}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


NO_DEVICE_EVENT = "not measured: no kernel event in the profile"


def device_ms(torch, fn, iters: int = 20) -> float | str:
    """Mean device time per call of the kernels ``fn`` launches, from the
    profiler's CUDA activity (execution only, no launch gaps); where the
    profiler reports no device time, says so (``NO_DEVICE_EVENT``)."""
    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(_self_device_us(e) for e in prof.key_averages())
    return total_us / 1e3 / iters if total_us > 0 else NO_DEVICE_EVENT


def _self_device_us(event) -> float:
    """A kernel row's device time.  An operator's row (``aten::mm``) also
    carries the time of the kernels it launched, which have rows of their
    own, so only rows on the CUDA device count: summing both would count
    a PyTorch operator's device time twice."""
    if getattr(event.device_type, "name", None) != "CUDA":
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def device_ms_cold(torch, fn, kernel: str, iters: int = 20) -> float:
    """Mean device time per call of the kernel named ``kernel`` that
    ``fn`` launches, with the L2 cache overwritten before each call (the
    main path reads its rows once, cold); only that kernel's events
    count."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total_us = sum(_self_device_us(e) for e in prof.key_averages()
                   if e.key.startswith(kernel + "("))
    return total_us / 1e3 / iters


def _is_kernel(key: str, name: str) -> bool:
    """Whether a profiler row is the port kernel ``name``'s (a template
    kernel's row reads ``void name_kernel<...>(...)``)."""
    key = key.removeprefix("void ")
    return key.startswith((name + "_kernel(", name + "_kernel<"))


def cache_us_per_launch(profile: dict) -> dict:
    """The cache kernels' device µs a launch in a ``profile_window``."""
    return {k: ms * 1e3 / n for k, (ms, n) in profile["port_kernels"].items()
            if k.startswith("cache_") and n}


def profile_window(torch, fn) -> dict:
    """Device busy share of one call of ``fn`` (host clock around it), its
    kernel launches, its five largest kernels by device time, and the
    port's kernels in it (device ms, launches).  Only the device's
    activity is recorded: recording every host operator too would slow
    the host the share is measured against (and a train step of hymba
    has ~190,000 launches)."""
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, _self_device_us(e) / 1e3, e.count)
            for e in prof.key_averages() if _self_device_us(e) > 0]
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    port = {name: [ms, n] for name in KERNELS for k, ms, n in rows
            if _is_kernel(k, name)}
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms if wall_ms else None,
            "kernel_launches": sum(r[2] for r in rows),
            "top_kernels": [[k[:160], ms, n] for k, ms, n in rows[:5]],
            "port_kernels": port}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env(torch) -> dict:
    from repro_torch import env_probe
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    probe = env_probe()
    fields = dict(nvidia_smi=nvidia_smi_line(), torch=probe["torch"],
                  cuda=probe["cuda"], device=probe["device_name"],
                  device_count=probe["device_count"],
                  nvcc=probe["nvcc_version"],
                  matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                  cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    emit("env", **fields)
    require(probe["nvcc"] is not None, "nvcc not found")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log = (lib.parent / "ptxas.log").read_text()
    usage = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    emit("build", seconds=time.perf_counter() - t0,
         library=os.path.relpath(lib, ROOT), ptxas=usage)
    return fields


def _kernel_record(torch, name, max_err, kernel, plain, library, n_bytes,
                   n_ops=0):
    """Times of the kernel, its plain version and the library yardstick
    (None where no single PyTorch call computes the function): ``*ms`` by
    CUDA events over back-to-back calls (what a caller pays per call,
    launch included), ``*device_ms`` by the profiler (execution only), and
    their difference, the host's cost per call.  The bound is the larger
    of bytes over HBM bandwidth and operations over the fp32 peak."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_FP32_S * 1e3
    source, replaces = KERNELS[name]
    ms, dev_ms = time_ms(torch, kernel), device_ms(torch, kernel)
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": 0, "max_abs_err": max_err,
           "ms": ms, "device_ms": dev_ms, "plain_ms": time_ms(torch, plain),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library and time_ms(torch, library)}
    extra = {"host_ms_per_call": (ms - dev_ms if isinstance(dev_ms, float)
                                  else None),
             "plain_device_ms": device_ms(torch, plain),
             "library_device_ms": library and device_ms(torch, library)}
    return rec, extra


def _merge_case(torch, gen, b: int, p: int, q: int, kind: str):
    """(pool_d, pool_ids, new_d, new_ids) for one merge check.  ``grid``:
    sorted pools with padded tails and new blocks with dropped entries,
    distances on a 0.25 grid so ties occur (most new entries can enter);
    ``steady``: each pool the P smallest of 8 L draws from the same grid,
    as a converged hop's pool or FreshDiskANN's top-k is (few can enter);
    the adversarial kinds: ``all_equal``, ``unsorted`` (pool in random
    order), ``signed_zero`` (-0.0 beside 0.0)."""
    dev = gen.device
    grid = lambda shape: torch.round(torch.rand(
        shape, generator=gen, device=dev) * 400) / 4
    ids = lambda shape: torch.randint(0, 10 ** 6, shape, generator=gen,
                                      device=dev, dtype=torch.int32)
    pool_d, new_d = grid((b, p)), grid((b, q))
    pool_i, new_i = ids((b, p)), ids((b, q))
    if kind == "all_equal":
        pool_d.fill_(1.5)
        new_d.fill_(1.5)
    elif kind == "signed_zero":
        for t in (pool_d, new_d):
            t[torch.rand(t.shape, generator=gen, device=dev) < 0.4] = 0.0
            t[torch.rand(t.shape, generator=gen, device=dev) < 0.4] = -0.0
    elif kind == "grid":
        pool_d = torch.sort(pool_d, dim=1).values
        pool_d[:, p - p // 4:] = 3.4e38
        pool_i[:, p - p // 4:] = -1
    elif kind == "steady":
        pool_d = torch.sort(grid((b, 8 * (p + q))), dim=1).values[:, :p]
        pool_d = pool_d.contiguous()
    drop = torch.rand((b, q), generator=gen, device=dev) < 0.2
    new_d[drop], new_i[drop] = 3.4e38, -1
    return pool_d, pool_i, new_d, new_i


def _casr_case(torch, gen, vectors, b: int, p: int, n_dup: int):
    """Queries near stored rows, and pools of p ids in a noisy exact-distance
    order (a PQ order's stand-in) with random -1 tails and one all -1
    lane.  Rows i < n_dup of ``vectors`` equal rows i + N // 2, and each
    pool holds such pairs, so exact ties occur and the pool position has
    to break them."""
    dev = vectors.device
    n = vectors.shape[0]
    off = n // 2
    src = torch.randint(0, n_dup, (b,), generator=gen, device=dev)
    q = vectors[src] + 0.5 * torch.randn((b, vectors.shape[1]),
                                         generator=gen, device=dev)
    cand = torch.randint(0, n, (b, p), generator=gen, device=dev)
    dup = torch.randint(0, n_dup, (b, 3), generator=gen, device=dev)
    cand[:, :8] = torch.cat([src[:, None], src[:, None] + off, dup,
                             dup + off], 1)
    d = ((vectors[cand] - q[:, None]) ** 2).sum(-1)
    noise = torch.randn((b, p), generator=gen, device=dev) * 30
    pools = cand.gather(1, torch.argsort(d + noise, dim=1)).to(torch.int32)
    tail = torch.randint(0, p // 2 + 1, (b, 1), generator=gen, device=dev)
    pools[torch.arange(p, device=dev) >= p - tail] = -1
    pools[-1] = -1
    return q.contiguous(), pools.contiguous()


def _casr_store(torch, gen, shape):
    """A [N, D] store whose rows i < N // 2 up to CASR_DUP repeat at i +
    N // 2 (exact ties that only the pool position can break)."""
    n, d = shape
    vectors = torch.randn((n, d), generator=gen, device="cuda")
    n_dup = min(CASR_DUP, n // 2)
    vectors[n // 2:n // 2 + n_dup] = vectors[:n_dup]
    return vectors


def _casr_dup(vectors) -> int:
    return min(CASR_DUP, vectors.shape[0] // 2)


def _casr_label(p: int, s: int, store: str, k: int = CASR_K) -> str:
    return (f"p{p}_s{s}" + ("_d8192" if store == "wide" else "") +
            ("" if k == CASR_K else f"_k{k}"))


def _prefetched_rows(torch, pools, rounds, s: int, stages: int) -> int:
    """Rows the ring read and CASR did not load: each lane's valid ids in
    the groups issued past its last loaded one (min(G, rounds + stages -
    1) groups issued, min(G, rounds) loaded)."""
    p = pools.shape[1]
    g_max = -(-p // s)
    group = torch.arange(p, device=pools.device) // s
    loaded = rounds.long().clamp(max=g_max)[:, None]
    issued = (rounds.long() + max(stages - 1, 0)).clamp(max=g_max)[:, None]
    past = (group[None] >= loaded) & (group[None] < issued) & (pools >= 0)
    return int(past.sum())


def kernel_timings(torch) -> dict:
    """Device ms a call (the profiler's) of ``pool_merge`` at MERGE_TIMED
    and of ``casr_rerank`` at CASR_CASES, CASR's P 40 / s 4 and
    ``rerank_l2_rows`` on pools of 64 also with the L2 overwritten before
    each call (``device_ms_cold``), and ``launch_floor_ms``: the smallest
    launch, one ``zero_()`` of 256 floats.  Inputs come from a fixed seed
    and only the wrappers' signatures are used, so ``tools/kernel_phase.py
    --timings`` runs it on another checkout's kernels for a comparison in
    one call."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(2222)
    b = WAVE
    floor = torch.zeros(256, device="cuda")

    def device_time(fn):    # the profiler now and then records no kernel event
        for _ in range(3):
            ms = device_ms(torch, fn)
            if isinstance(ms, float):
                break
        return ms

    out = {"launch_floor_ms": device_time(floor.zero_),
           "pool_merge": {}, "casr_rerank": {}, "rerank_l2_rows": {}}
    for p, q, kind in MERGE_TIMED:
        args = _merge_case(torch, gen, b, p, q, kind)
        out["pool_merge"][f"{p}x{q}_{kind}"] = device_time(
            lambda: ops.pool_merge(*args))
    stores = {"narrow": _casr_store(torch, gen, CASR_STORE),
              "wide": _casr_store(torch, gen, CASR_WIDE_STORE)}
    for p, s, store, k in CASR_CASES:
        vs = stores[store]
        q, pools = _casr_case(torch, gen, vs, b, p, _casr_dup(vs))
        label = _casr_label(p, s, store, k)
        call = lambda: ops.casr_rerank(q, vs, pools, k=k, s=s)
        out["casr_rerank"][label] = device_time(call)
        if (p, s, store, k) in ((40, 4, "narrow", CASR_K),
                                (64, 8, "narrow", CASR_K)):
            out["casr_rerank"][label + "_cold_l2"] = device_ms_cold(
                torch, call, "casr_rerank_kernel")
        if (p, s, store, k) == (64, 8, "narrow", CASR_K):
            rows = lambda: ops.rerank_l2_rows(q, vs, pools)
            out["rerank_l2_rows"]["pools_p64"] = device_time(rows)
            out["rerank_l2_rows"]["pools_p64_cold_l2"] = device_ms_cold(
                torch, rows, "rerank_l2_rows_kernel")
    emit("kernel:timings", **out)
    return out


def _distinct_rows(torch, pools, loaded) -> int:
    """Rows of the store a CASR call must read at least once: the distinct
    ids it loads over all lanes (lanes of one wave share candidates)."""
    return int(torch.unique(pools[loaded]).numel())


def _check_casr(torch, got, want, b: int) -> dict:
    """Grade the fused CASR kernel against its plain version: loaded flags,
    loads, rounds and top-k ids exact, except in lanes where two loaded
    distances lie within the rerank grade of each other without being
    equal (sums in another order may order such a pair either way); those
    lanes are counted.  Exact distances of positions both loaded: rtol
    1e-5 / atol 1e-3."""
    exact_k, loaded_k, ids_k, _, n_k, rounds_k = got
    exact_p, loaded_p, ids_p, _, n_p, rounds_p = want
    differ = ((loaded_k != loaded_p).any(1) | (n_k != n_p) |
              (rounds_k != rounds_p) | (ids_k != ids_p).any(1))
    dp = torch.where(loaded_p, exact_p, float("nan"))
    gap = (dp[:, :, None] - dp[:, None, :]).abs()
    tol = RERANK_ATOL + RERANK_RTOL * torch.maximum(dp[:, :, None].abs(),
                                                    dp[:, None, :].abs())
    near = ((gap > 0) & (gap <= tol)).flatten(1).any(1)
    both = loaded_k & loaded_p
    d_ok = bool(torch.allclose(exact_k[both], exact_p[both],
                               rtol=RERANK_RTOL, atol=RERANK_ATOL))
    return {"lanes": b, "near_tie_lanes": int((differ & near).sum()),
            "other_differing_lanes": int((differ & ~near).sum()),
            "exact_d_within_grade": d_ok,
            "max_abs_err": float((exact_k[both] - exact_p[both]).abs().max()),
            "mean_rounds": float(rounds_p.float().mean()),
            "max_rounds": int(rounds_p.max()),
            "mean_loaded": float(n_p.float().mean())}


def _slot_ids(torch, b: int, n_rows: int, count: int):
    """[b, n_rows] slot ids, -1 from ``count`` on: the buffer scan as
    ``rerank_l2_rows`` scored it before it had its own kernel."""
    slots = torch.arange(n_rows, device="cuda", dtype=torch.int32)
    return torch.where(slots < count, slots, -1)[None].expand(
        b, -1).contiguous()


def _shared_grade(torch, q, rows, count: int, label: str,
                  self_queries: bool = False) -> dict:
    """``rerank_l2_shared`` on (q, rows, count), gated: within the rerank
    grade of its plain version on every pair, INF past ``count``,
    bit-equal to ``rerank_l2_rows`` (the row body) on every pair its guard
    recomputed and on every pair whose exact d is under ``(SHARED_TAU - 2
    SHARED_EPS) S`` (S = ``‖q'‖² + ‖x'‖²``, shifted by the mean of the
    first 16 rows as the kernel shifts), the same result again with the
    flags marked; with ``self_queries``, each query's smallest distance 0
    (a buffered vector its own top hit).  Reported: the guard's flagged
    share, and the unguarded form's largest error over ``SHARED_EPS S``
    (the guard's premise: under 1)."""
    from repro_torch.kernels import ops, ref
    b, n_s = q.shape[0], rows.shape[0]
    got = ops.rerank_l2_shared(q, rows, count)
    want = ref.rerank_l2_shared_ref(q, rows, count)
    body = ops.rerank_l2_rows(q, rows, _slot_ids(torch, b, n_s, count))
    flags = torch.zeros((b, n_s), dtype=torch.uint8, device="cuda")
    marked = ops.rerank_l2_shared_guarded(q, rows, count, ops.SHARED_TAU,
                                          flags)
    raw = ops.rerank_l2_shared_guarded(q, rows, count, float("-inf"))
    torch.cuda.synchronize()
    live = slice(0, count)
    ok = bool(torch.allclose(got[:, live], want[:, live], rtol=RERANK_RTOL,
                             atol=RERANK_ATOL)) and \
        bool((got[:, count:] == 3.4e38).all())
    c = rows[:min(count, 16)].mean(0)
    sn = ((q - c) ** 2).sum(1)[:, None] + ((rows[live] - c) ** 2).sum(1)
    flagged = flags[:, live].bool()
    near = want[:, live] <= (ops.SHARED_TAU - 2 * ops.SHARED_EPS) * sn
    must = flagged | near
    same = bool(torch.equal(got[:, live][must], body[:, live][must]))
    again = bool(torch.equal(marked, got))
    tol = RERANK_ATOL + RERANK_RTOL * want[:, live].abs()
    raw_err = (raw[:, live] - want[:, live]).abs()
    own_top = (not self_queries or
               bool((got[:, live].min(1).values == 0).all()))
    out = dict(max_abs_err=float((got[:, live] - want[:, live]).abs()
                                 .max()) if count else 0.0,
               within_grade=ok, flagged=int(flagged.sum()),
               flagged_share=float(flagged.float().mean()) if count else 0.0,
               near=int(near.sum()), near_unflagged=int((near & ~flagged)
                                                       .sum()),
               equal_to_row_body_where_flagged_or_near=same,
               repeatable=again, own_top_hit=own_top,
               unguarded_max_err_over_eps_s=float(
                   (raw_err / (ops.SHARED_EPS * sn)).max()) if count
               else 0.0,
               unguarded_outside_grade=int((raw_err > tol).sum()),
               min_d_over_norms=float((want[:, live] / sn).min())
               if count else None)
    require(ok and same and again and own_top,
            f"rerank_l2_shared {label} outside rtol {RERANK_RTOL} / atol "
            f"{RERANK_ATOL}, not INF past the count, not bit-equal to "
            f"rerank_l2_rows where flagged or near, not repeatable, or a "
            f"buffered vector not its own top hit: {out}")
    return out


def _entrance_case(torch, gen, b: int, m: int, c: int, n: int):
    """A random entrance of c slots (5% dead, slot 0 live), each linked to
    16-32 distinct slots with a -1 tail, over n code rows, and b lanes'
    LUTs."""
    from repro_torch.core.entrance import EntranceGraph
    dev = torch.device("cuda")
    r = 32
    ids = torch.randint(0, n, (c,), generator=gen, device=dev,
                        dtype=torch.int32)
    dead = torch.rand(c, generator=gen, device=dev) < 0.05
    dead[0] = False
    ids[dead] = -1
    edges = torch.rand((c, c), generator=gen, device=dev).argsort(1)[:, :r]
    edges = edges.to(torch.int32).contiguous()
    deg = torch.randint(r // 2, r + 1, (c, 1), generator=gen, device=dev)
    edges[torch.arange(r, device=dev)[None] >= deg] = -1
    ent = EntranceGraph(ids=ids, edges=edges, count=int((ids >= 0).sum()),
                        main_to_ent=torch.full((n,), -1, dtype=torch.int32,
                                               device=dev))
    lut = torch.rand((b, m, 256), generator=gen, device=dev) * 10
    codes = torch.randint(0, 256, (n, m), generator=gen, device=dev,
                          dtype=torch.uint8)
    return ent, lut, codes


def _entrance_records(torch, gen, b: int):
    """entrance_search bit for bit against the host loop (E_ent, distance
    bits, lane iterations): under plain_on_device() in both visited modes
    and with its ADC and merge kernels (the loop the kernel replaced), at
    ENTRANCE_CASES' widths over b lanes; timed against both loops, and on
    the deep96 cell's wave of ENTRANCE_WAVE lanes against the loop with
    kernels.  Bound: bytes, each input read once (the LUTs, the
    entrance, the code rows it names) and the outputs written once."""
    from repro_torch.core import search as search_mod
    from repro_torch.kernels import ops
    p, hops_max = 32, 64

    def lanes(args, visited="hash"):
        return search_mod.entrance_lanes(*args, pool_size=p,
                                         max_hops=hops_max, visited=visited)

    def loop(args):
        return search_mod._entrance_loop(*args, pool_size=p,
                                         max_hops=hops_max, visited="hash")

    def plain(args, visited="hash"):
        with ops.plain_on_device():
            return lanes(args, visited)

    def bits(out):
        return [t.view(torch.int32) if t.dtype == torch.float32 else t
                for t in out]

    def same(a, b_):
        return all(torch.equal(x, y) for x, y in zip(bits(a), bits(b_)))

    def bound_ms(args, lanes_):
        ent, lut, codes = args
        c, r = ent.edges.shape
        n_bytes = (lut.numel() * 4 + c * (r * 4 + 4 + codes.shape[1]) +
                   lanes_ * (p * 8 + 4))
        return n_bytes / PEAK_BYTES_S * 1e3

    by_width = {}
    for label, m, c, n in ENTRANCE_CASES:
        args = _entrance_case(torch, gen, b, m, c, n)
        got = lanes(args)
        want = [plain(args, v) for v in ("hash", "bitmap")] + [loop(args)]
        torch.cuda.synchronize()
        require(all(same(got, w) for w in want),
                f"entrance_search at {label}'s widths differs from the "
                f"host loop")
        kern = lambda args=args: lanes(args)
        by_width[label] = {
            "m": m, "c_max": c, "iters_max": int(got[2].max()),
            "lane_steps": int(got[2].sum()),
            "ms": time_ms(torch, kern), "device_ms": device_ms(torch, kern),
            "loop_ms": time_ms(torch, lambda args=args: loop(args), iters=3,
                               warmup=1),
            "plain_ms": time_ms(torch, lambda args=args: plain(args),
                                iters=2, warmup=1),
            "bound_ms": bound_ms(args, b)}
    label, m, c, n = ENTRANCE_CASES[0]
    args = _entrance_case(torch, gen, ENTRANCE_WAVE, m, c, n)
    got = lanes(args)
    looped = loop(args)
    torch.cuda.synchronize()
    require(same(got, looped), "entrance_search on the deep96 wave differs "
                               "from the host loop")
    kern = lambda: lanes(args)
    wave = {"lanes": ENTRANCE_WAVE, "iters_max": int(got[2].max()),
            "lane_steps": int(got[2].sum()),
            "ms": time_ms(torch, kern, iters=10, warmup=2),
            "device_ms": device_ms(torch, kern, iters=5),
            "loop_ms": time_ms(torch, lambda: loop(args), iters=2, warmup=1),
            "bound_ms": bound_ms(args, ENTRANCE_WAVE)}
    source, replaces = KERNELS["entrance_search"]
    first = by_width[ENTRANCE_CASES[0][0]]
    rec = {"name": "entrance_search", "route": "cuda", "source": source,
           "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
           **{k: first[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms")},
           "bound_by": "bytes", "library_ms": None,
           "library_reason": "no single PyTorch call computes the search"}
    return rec, {"by_width": by_width, "deep96_wave": wave}


def phase_kernels(torch) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    b = WAVE
    records = {}

    # -- pool_merge: exact (distance bits and ids), ties and adversarial
    #    inputs included ------------------------------------------------
    timings = kernel_timings(torch)
    KERNEL_LINE["launch_floor_ms"] = timings["launch_floor_ms"]
    worst = 0.0
    route_counts = {}
    total_routes = torch.zeros(3, dtype=torch.int64, device=dev)
    for p, q, kind in MERGE_CASES:
        args = _merge_case(torch, gen, b, p, q, kind)
        routes = torch.zeros(3, dtype=torch.int64, device=dev)
        kd, ki = ops.pool_merge_with_routes(*args, routes)
        pd, pi = ref.pool_merge_ref(*args)
        n_unsorted = int((args[0][:, :-1] > args[0][:, 1:]).any(1).sum())
        torch.cuda.synchronize()
        require(torch.equal(kd.view(torch.int32), pd.view(torch.int32)) and
                torch.equal(ki, pi),
                f"pool_merge ({p},{q}) {kind} differs from its plain version")
        require(int(routes.sum()) == b and int(routes[2]) == n_unsorted,
                f"pool_merge ({p},{q}) {kind} took routes {routes.tolist()} "
                f"over {b} lanes, {n_unsorted} of them with an unsorted "
                f"pool: want one route a lane, the unsorted one exactly "
                f"there")
        route_counts[f"{p}x{q}_{kind}"] = routes.tolist()
        total_routes += routes
        worst = max(worst, float((kd - pd).abs().max()))
        if (p, q, kind) == (40, 192, "grid"):
            m_args = args
            cat_d = torch.cat([args[0], args[2]], 1)
    emit("kernel:pool_merge:routes", routes=list(ops.POOL_MERGE_ROUTES),
         by_case=route_counts, total=total_routes.tolist())
    require(bool((total_routes > 0).all()),
            f"pool_merge: a route never launched: {total_routes.tolist()}")
    # The merge must read L (distance, id) pairs and write P; its work is
    # sorting the Q new entries and one merge pass, about Q log2 Q + L
    # compares a lane (a kernel's own sort network is its choice).
    L = 40 + 192
    records["pool_merge"] = _kernel_record(
        torch, "pool_merge", worst,
        lambda: ops.pool_merge(*m_args),
        lambda: ref.pool_merge_ref(*m_args),
        lambda: torch.sort(cat_d, dim=1, stable=True),
        n_bytes=b * L * 8 + b * 40 * 8,
        n_ops=b * (192 * math.ceil(math.log2(192)) + L))
    records["pool_merge"][1].update(
        device_ms_by_case=timings["pool_merge"],
        bound_ms_by_case={f"{p}x{q}_{kind}": b * (2 * p + q) * 8 /
                          PEAK_BYTES_S * 1e3 for p, q, kind in MERGE_TIMED})

    # -- adc_distance: bit-exact -------------------------------------------
    m = 96
    worst = 0.0
    for c in (192, 32, 10):
        lut = torch.rand((b, m, 256), generator=gen, device=dev) * 10
        codes = torch.randint(0, 256, (b, c, m), generator=gen, device=dev,
                              dtype=torch.uint8)
        got = ops.adc_distance(lut, codes)
        want = ref.adc_distance_ref(lut, codes)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(err == 0.0, f"adc_distance C={c} not bit-exact: {err}")
        worst = max(worst, err)
        if c == 192:
            a_args = (lut, codes)
            offs = (torch.arange(b, device=dev)[:, None, None] * m * 256 +
                    torch.arange(m, device=dev) * 256)
            flat = (codes.long() + offs).reshape(b * c, m)
            weight = lut.reshape(-1, 1)
    records["adc_distance"] = _kernel_record(
        torch, "adc_distance", worst,
        lambda: ops.adc_distance(*a_args),
        lambda: ref.adc_distance_ref(*a_args),
        lambda: torch.nn.functional.embedding_bag(flat, weight, mode="sum"),
        n_bytes=b * m * 256 * 4 + b * 192 * m + b * 192 * 4,
        n_ops=b * 192 * m)

    # -- rerank_l2: rtol 1e-5 / atol 1e-3 (sum order differs) --------------
    d, s = 768, 4
    worst = 0.0
    for ss in (s, 40):
        cent = torch.randn((b, d), generator=gen, device=dev) * 3
        q = cent + torch.randn((b, d), generator=gen, device=dev)
        xs = cent[:, None] + torch.randn((b, ss, d), generator=gen,
                                         device=dev)
        got = ops.rerank_l2(q, xs)
        want = ref.rerank_l2_ref(q, xs)
        torch.cuda.synchronize()
        require(bool(torch.allclose(got, want, rtol=RERANK_RTOL,
                                    atol=RERANK_ATOL)),
                f"rerank_l2 S={ss} outside rtol {RERANK_RTOL} / atol "
                f"{RERANK_ATOL}")
        worst = max(worst, float((got - want).abs().max()))
        if ss == s:
            r_args = (q, xs)
    records["rerank_l2"] = _kernel_record(
        torch, "rerank_l2", worst,
        lambda: ops.rerank_l2(*r_args),
        lambda: ref.rerank_l2_ref(*r_args),
        lambda: torch.cdist(r_args[0][:, None], r_args[1]),
        n_bytes=b * d * 4 + b * s * d * 4 + b * s * 4, n_ops=3 * b * s * d)

    # -- casr_rerank: the fused group loop over a [100_000, 768] store, and
    #    S 8 at D 8,192 (rows read directly) over a [2,000, 8,192] one ----
    n_dup, k = CASR_DUP, CASR_K
    vectors = _casr_store(torch, gen, CASR_STORE)
    wide = None
    casr_grades = {}
    for p, s, store, k_ in CASR_CASES:
        if store == "wide" and wide is None:
            wide = _casr_store(torch, gen, CASR_WIDE_STORE)
        vs = vectors if store == "narrow" else wide
        q, pools = _casr_case(torch, gen, vs, b, p, _casr_dup(vs))
        got = ops.casr_rerank(q, vs, pools, k=k_, s=s)
        want = ref.casr_rerank_ref(q, vs, pools, k_, s)
        by_id = ops.rerank_l2_rows(q, vs, pools)
        torch.cuda.synchronize()
        label = _casr_label(p, s, store, k_)
        grade = _check_casr(torch, got, want, b)
        stages = ops.casr_rerank_stages(vs, p, k_, s)
        body = bool(torch.equal(got[0][got[1]].view(torch.int32),
                                by_id[got[1]].view(torch.int32)))
        grade.update(ring_stages=stages, merge_in_registers=k_ <= 32,
                     exact_d_equal_to_rerank_l2_rows_where_loaded=body)
        emit(f"kernel:casr_rerank:check_{label}", **grade)
        require(grade["other_differing_lanes"] == 0 and
                grade["exact_d_within_grade"] and body,
                f"casr_rerank ({label}) differs from its plain version "
                f"outside near ties, or its exact_d from rerank_l2_rows' "
                f"where loaded: {grade}")
        require((stages == 0) == (store == "wide"),
                f"casr_rerank ({label}) runs with {stages} ring stages: "
                f"want rows read directly (0) exactly at D 8,192")
        casr_grades[label] = grade
        if (p, s, store, k_) == (40, 4, "narrow", k):
            c_args = (q, vectors, pools)
            loaded_rows = int(want[4].sum())
            distinct_rows = _distinct_rows(torch, pools, want[1])
            c_stages = stages
            c_past = _prefetched_rows(torch, pools, want[5], s, stages)
    rec, extra = _kernel_record(
        torch, "casr_rerank",
        max(g["max_abs_err"] for g in casr_grades.values()),
        lambda: ops.casr_rerank(*c_args, k=k, s=4),
        lambda: ref.casr_rerank_ref(*c_args, k, 4),
        None,
        n_bytes=(distinct_rows * d * 4 + b * d * 4 + b * 40 * 4 +
                 b * 40 * 5 + b * k * 8 + b * 12),
        n_ops=3 * loaded_rows * d)
    # the slice-1 path: the same loop with one rerank_l2 and one pool_merge
    # launch per round
    pr6 = lambda: ref.casr_rerank_ref(*c_args, k, 4, rerank_l2=ops.rerank_l2,
                                      pool_merge=ops.pool_merge)
    rec["library_reason"] = ("no single PyTorch call computes CASR's "
                             "data-dependent group loop")
    extra.update(loop_of_kernels_ms=time_ms(torch, pr6),
                 loop_of_kernels_device_ms=device_ms(torch, pr6),
                 loaded_rows=loaded_rows, distinct_rows=distinct_rows,
                 ring_stages=c_stages, rows_read_past_loads=c_past,
                 bytes_read_past_loads=c_past * d * 4,
                 device_ms_by_case=timings["casr_rerank"])
    records["casr_rerank"] = (rec, extra)

    # -- rerank_l2_rows: rows read by id from the same store; within the
    #    rerank grade of the plain version, and equal to rerank_l2 on the
    #    rows gathered (one row body) ---------------------------------------
    q64, pools64 = _casr_case(torch, gen, vectors, b, 64, n_dup)
    rows_cold = device_ms_cold(
        torch, lambda: ops.rerank_l2_rows(q64, vectors, pools64),
        "rerank_l2_rows_kernel")
    buf = torch.arange(256, device=dev, dtype=torch.int32)
    buf_ids = torch.where(buf < 200, buf, -1)[None].expand(b, -1).contiguous()
    q_buf = (vectors[torch.randint(0, 200, (b,), generator=gen, device=dev)]
             + 0.5 * torch.randn((b, d), generator=gen, device=dev))
    rows = {}
    for case, q_, ids_ in (("pools_p64", q64, pools64),
                           ("buffer_256", q_buf, buf_ids)):
        got = ops.rerank_l2_rows(q_, vectors, ids_)
        want = ref.rerank_l2_rows_ref(q_, vectors, ids_)
        gathered = ops.rerank_l2(q_, vectors[ids_.clamp(min=0).long()])
        torch.cuda.synchronize()
        ok = ids_ >= 0
        same = (bool(torch.equal(got[ok], gathered[ok])) and
                bool((got[~ok] == 3.4e38).all()))
        require(bool(torch.allclose(got, want, rtol=RERANK_RTOL,
                                    atol=RERANK_ATOL)),
                f"rerank_l2_rows {case} outside rtol {RERANK_RTOL} / atol "
                f"{RERANK_ATOL}")
        require(same, f"rerank_l2_rows {case} differs from rerank_l2 on "
                "the rows gathered")
        n_valid = int(ok.sum())
        distinct = int(torch.unique(ids_[ok]).numel())
        flat = ids_.clamp(min=0).long()
        gather_cdist = (lambda q_=q_, flat=flat:
                        torch.cdist(q_[:, None], vectors[flat]))
        rows[case] = _kernel_record(
            torch, "rerank_l2_rows",
            float((got[ok] - want[ok]).abs().max()),
            lambda q_=q_, ids_=ids_: ops.rerank_l2_rows(q_, vectors, ids_),
            lambda q_=q_, ids_=ids_: ref.rerank_l2_rows_ref(q_, vectors,
                                                            ids_),
            # the buffer's lanes share their rows: one cdist of q against
            # them (it computes the root); a pool's rows are its own
            (lambda q_=q_: torch.cdist(q_, vectors[:200]))
            if case == "buffer_256" else gather_cdist,
            n_bytes=distinct * d * 4 + b * d * 4 + ids_.numel() * 8,
            n_ops=3 * n_valid * d)
        rows[case][1].update(rows_valid=n_valid, rows_distinct=distinct,
                             equal_to_rerank_l2_gathered=same)
        if case == "buffer_256":     # the old yardstick: a copy per lane
            rows[case][1].update(
                gather_cdist_ms=time_ms(torch, gather_cdist),
                gather_cdist_device_ms=device_ms(torch, gather_cdist))
    rec, extra = rows["pools_p64"]
    extra.update(device_ms_cold_l2=rows_cold,
                 device_ms_by_case=timings["rerank_l2_rows"])
    extra["buffer_256"] = {
        k: v for k, v in {**rows["buffer_256"][0],
                          **rows["buffer_256"][1]}.items()
        if k in ("max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
                 "library_device_ms", "gather_cdist_ms",
                 "gather_cdist_device_ms", "bound_ms", "bound_by",
                 "rows_valid", "rows_distinct",
                 "equal_to_rerank_l2_gathered")}
    records["rerank_l2_rows"] = (rec, extra)

    # -- rerank_l2_shared: every lane against the same rows (the buffer
    #    scan): buffer_256's lanes and rows, 200 of 256 in use, then a
    #    buffer of 4,096 with 10 and all in use, and
    #    4,096 near-duplicates queried by themselves plus noise (every pair
    #    where the unshifted expanded form would cancel); within the rerank
    #    grade, bit-equal to rerank_l2_rows on the slots' ids where the
    #    guard recomputed and where d is near, INF past the count, and
    #    rerank_l2_rows' time beside it -------------------------------------
    rows4k = vectors[:4096]
    q4k = (rows4k[torch.randint(0, 4096, (b,), generator=gen, device=dev)]
           + 0.5 * torch.randn((b, d), generator=gen, device=dev))
    dup4k = vectors[:1] + 0.05 * torch.randn((4096, d), generator=gen,
                                             device=dev)
    q_dup = (dup4k[torch.randint(0, 4096, (b,), generator=gen, device=dev)]
             + 0.05 * torch.randn((b, d), generator=gen, device=dev))
    shared = {}
    for case, q_, rows_, count in (("c200_s256", q_buf, vectors[:256], 200),
                                   ("c10_s4096", q4k, rows4k, 10),
                                   ("c4096_s4096", q4k, rows4k, 4096),
                                   ("dup_c4096_s4096", q_dup, dup4k, 4096)):
        grade = _shared_grade(torch, q_, rows_, count, case)
        n_s = rows_.shape[0]
        ids_ = _slot_ids(torch, b, n_s, count)
        by_id = lambda q_=q_, rows_=rows_, ids_=ids_: ops.rerank_l2_rows(
            q_, rows_, ids_)
        shared[case] = _kernel_record(
            torch, "rerank_l2_shared", grade["max_abs_err"],
            lambda q_=q_, rows_=rows_, c=count: ops.rerank_l2_shared(
                q_, rows_, c),
            lambda q_=q_, rows_=rows_, c=count: ref.rerank_l2_shared_ref(
                q_, rows_, c),
            # one call; it computes the root
            lambda q_=q_, rows_=rows_, c=count: torch.cdist(q_, rows_[:c]),
            n_bytes=count * d * 4 + b * d * 4 + b * n_s * 4,
            n_ops=3 * b * count * d)
        # the kernel's products: three TF32 ones (2 b count d each) on the
        # tensor cores; the difference form's fp32 operations beside them
        t_tf32 = 6 * b * count * d / PEAK_TF32_S * 1e3
        shared[case][1]["bound_fp32_ms"] = shared[case][0]["bound_ms"]
        shared[case][0]["bound_ms"] = max(
            t_tf32, (count * d * 4 + b * d * 4 + b * n_s * 4) /
            PEAK_BYTES_S * 1e3)
        shared[case][0]["bound_by"] = (
            "operations" if shared[case][0]["bound_ms"] == t_tf32
            else "bytes")
        shared[case][1].update(
            rows=n_s, count=count, bound_3xtf32_ms=t_tf32,
            library_computes="torch.cdist(q, rows[:count]): the root",
            rerank_l2_rows_ms=time_ms(torch, by_id),
            rerank_l2_rows_device_ms=device_ms(torch, by_id),
            **{k: v for k, v in grade.items() if k != "max_abs_err"})
    rec, extra = shared["c200_s256"]
    for case in ("c10_s4096", "c4096_s4096", "dup_c4096_s4096"):
        extra[case] = {k: v for k, v in {**shared[case][0],
                                         **shared[case][1]}.items()
                       if k not in ("name", "route", "source", "replaces",
                                    "launches")}
    records["rerank_l2_shared"] = (rec, extra)
    # -- entrance_search: every lane's whole entrance search, bit for bit
    #    the host loop's --------------------------------------------------
    records["entrance_search"] = _entrance_records(torch, gen, b)
    cache_records = phase_cache_kernels(torch)

    grades = {"pool_merge": "exact (distance bits and ids); the unsorted "
                            "route exactly on unsorted pools, every route "
                            "launched",
              "adc_distance": "bit-exact",
              "rerank_l2": f"rtol {RERANK_RTOL} / atol {RERANK_ATOL}",
              "rerank_l2_rows": f"rtol {RERANK_RTOL} / atol {RERANK_ATOL}; "
                                "bit-equal to rerank_l2 on the rows "
                                "gathered",
              "rerank_l2_shared": f"rtol {RERANK_RTOL} / atol "
                                  f"{RERANK_ATOL}; INF past the count; "
                                  "bit-equal to rerank_l2_rows where the "
                                  "guard recomputes and where d <= (tau - "
                                  "2 eps) S",
              "casr_rerank": "ids, loads and rounds exact outside near "
                             f"ties; distances rtol {RERANK_RTOL} / atol "
                             f"{RERANK_ATOL}, bit-equal to rerank_l2_rows "
                             "where loaded",
              "entrance_search": "exact (E_ent, distance bits and lane "
                                 "iterations) against the host loop, plain "
                                 "in both visited modes and with its "
                                 "kernels"}
    out = {}
    for name, (rec, extra) in records.items():
        emit(f"kernel:{name}", lanes=b, grade=grades[name],
             **{k: rec[k] for k in ("max_abs_err", "ms", "device_ms",
                                    "plain_ms", "library_ms",
                                    "library_reason", "bound_ms",
                                    "bound_by") if k in rec},
             **extra)
        out[name] = rec
    return {**out, **cache_records}


def _cache_inputs(torch, gen, cap: int):
    """A wave's traces [WAVE, CACHE_ROW] (prefixes of 1-160 pages, -1
    after) and an op stream of as many entries: four in five accesses,
    one in ten an eviction hint for a page accessed 1-8 entries before
    (so mostly resident), one in ten an admit, one in twenty a -1 hole.
    Pages come from a range of 4 x cap, skewed (u**3) so that hot pages
    re-hit: windows promote, frozen slots and CLOCK hands turn over."""
    dev = gen.device
    lens = torch.randint(1, 161, (WAVE,), generator=gen, device=dev)
    skewed = lambda *shape: (4 * cap * torch.rand(
        shape, generator=gen, device=dev) ** 3).to(torch.int32)
    col = torch.arange(CACHE_ROW, device=dev)
    traces = torch.where(col < lens[:, None], skewed(WAVE, CACHE_ROW), -1)
    n = int(lens.sum())
    r = torch.rand((n,), generator=gen, device=dev)
    kinds = torch.where(r < 0.8, 0, torch.where(r < 0.9, 1, 2)).to(torch.int8)
    pages = skewed(n)
    back = (torch.arange(n, device=dev) - torch.randint(
        1, 9, (n,), generator=gen, device=dev)).clamp(min=0)
    pages = torch.where(kinds == 1, pages[back], pages)
    holes = torch.rand((n,), generator=gen, device=dev) < 0.05
    return traces, torch.where(holes, -1, pages), kinds


def _cache_case(torch, entry: str, policy: str, cap: int, inputs) -> dict:
    """``entry`` on a fresh state against ``ref.cache_apply`` on a copy:
    every table and scalar and the hit count equal.  The plain version
    (the host replay) is timed by host clock on that run, the kernel by
    CUDA events and the profiler on the tables as they evolve.  The bound is
    the bytes the run must move: its valid entries (and kinds), each
    distinct page's entries read and written once, the region tables
    read and written once, the scalars and the key."""
    from repro_torch import random as jr
    from repro_torch.core import cache as cache_mod
    from repro_torch.kernels import ops, ref
    traces, pages, kinds = inputs
    st = cache_mod.init_cache(CACHE_P_MAX, cap, policy, jr.PRNGKey(cap),
                              device="cuda")
    k_tables = [getattr(st, n).clone() for n in cache_mod.TABLES]
    p_tables = [t.clone() for t in k_tables]
    if entry == "cache_replay":
        run_k = lambda: ops.cache_replay(st.policy, k_tables, traces)
        run_p = lambda: ref.cache_apply(st.policy, p_tables, traces=traces)
        valid = traces[traces >= 0]
        n_in = int(valid.numel()) * 4
    else:
        run_k = lambda: ops.cache_ops(st.policy, k_tables, pages, kinds)
        run_p = lambda: ref.cache_apply(st.policy, p_tables, pages=pages,
                                        kinds=kinds)
        valid = pages[pages >= 0]
        n_in = int(pages.numel()) * 5
    hits_k = run_k()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hits_p = run_p()
    plain_ms = (time.perf_counter() - t0) * 1e3
    differ = [n for n, a, b in zip(cache_mod.TABLES, k_tables, p_tables)
              if not torch.equal(a, b)]
    err = max(int((a.long() - b.long()).abs().max()) for a, b in
              zip(k_tables + [hits_k], p_tables + [hits_p]))
    ms = time_ms(torch, run_k, iters=5, warmup=1)
    dev_ms = device_ms(torch, run_k, iters=3)
    w, f = st.window_pages.numel(), st.frozen_pages.numel()
    n_bytes = (n_in + int(torch.unique(valid).numel()) * 9 * 2 +
               2 * (w + f) * 4 * 2 + 3 * 4 * 2 + 16 * 2 + 4)
    return {"policy": policy, "capacity": cap, "W": w, "F": f,
            "operations": int(valid.numel()), "hits": int(hits_k),
            "hits_equal": int(hits_k) == int(hits_p),
            "fields_differing": differ, "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": n_bytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
            "frozen_fill": int(k_tables[7]), "clock": int(k_tables[9])}


def phase_cache_kernels(torch) -> dict:
    """cache_replay and cache_ops against ref.cache_apply for every policy
    at CACHE_CAPS; each case bit-equal on every CacheState field, the key
    included, and on the hit count.  Returns each entry's record, from
    navis at 256 pages (the smoke's configuration)."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    out = {}
    for cap in CACHE_CAPS:
        inputs = _cache_inputs(torch, gen, cap)
        for entry in ("cache_replay", "cache_ops"):
            for policy in CACHE_POLICIES:
                case = _cache_case(torch, entry, policy, cap, inputs)
                emit(f"kernel:{entry}:{policy}_{cap}", **case)
                require(not case["fields_differing"] and case["hits_equal"],
                        f"{entry} ({policy}, {cap} pages) differs from its "
                        f"plain version: {case['fields_differing']}, hits "
                        f"equal {case['hits_equal']}")
                if (policy, cap) == ("navis", 256):
                    source, replaces = KERNELS[entry]
                    out[entry] = {
                        "name": entry, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": 0,
                        **{k: case[k] for k in (
                            "max_abs_err", "ms", "device_ms", "plain_ms",
                            "bound_ms", "bound_by")},
                        "library_ms": None,
                        "library_reason": "no single PyTorch call computes "
                                          "the serial replay"}
    return out


class _ReplayCheck:
    """Records each cache kernel call of the main path inside the block
    (the handle's tables before and after, its input, its hit count) and
    grades it afterwards against ``ref.cache_apply`` on the host from the
    same tables: the card's cache must equal the host replay bit for bit.
    The two copies of the tables a call costs fall inside the wave's
    ``replay_s``."""

    def __init__(self, torch):
        from repro_torch.core import cache as cache_mod
        self.torch, self.cls, self.calls = torch, cache_mod.DeviceCache, []

    def __enter__(self):
        spy, orig_replay, orig_apply = self, self.cls.replay, self.cls.apply
        self.orig = (orig_replay, orig_apply)

        def record(handle, fn, kw):
            before = [t.clone() for t in handle.tables]
            hits = fn()
            spy.calls.append((handle.policy, before, kw,
                              [t.clone() for t in handle.tables], hits))
            return hits

        self.cls.replay = lambda h, traces: record(
            h, lambda: orig_replay(h, traces), {"traces": traces})
        self.cls.apply = lambda h, pages, kinds: record(
            h, lambda: orig_apply(h, pages, kinds),
            {"pages": pages.reshape(-1).to(self.torch.int32),
             "kinds": kinds.to(self.torch.int8)})
        return self

    def __exit__(self, *exc):
        self.cls.replay, self.cls.apply = self.orig

    def check(self) -> dict:
        from repro_torch.kernels import ref
        t0 = time.perf_counter()
        bad = []
        for i, (policy, before, kw, after, hits) in enumerate(self.calls):
            want = ref.cache_apply(policy, before, **kw)
            if int(want) != int(hits) or not all(
                    self.torch.equal(a, b) for a, b in zip(before, after)):
                bad.append(i)
        return {"calls": len(self.calls), "differing_calls": bad,
                "host_replay_s": time.perf_counter() - t0}


def _spec_small(name: str = "navis", **overrides):
    """The test suite's configuration (tests/conftest.py:37-41)."""
    from repro_torch.core import preset
    return preset(name, dim=48, r=16, n_max=1600, e_search=40, e_pos=48,
                  pq_m=24, cache_capacity_pages=256, max_hops=64,
                  buffer_max=128, **overrides)


def _spec_fineweb(name: str, n_max: int):
    """The FineWeb-like cell (benchmarks/common.py:38-40, :72-77)."""
    from repro_torch.core import preset
    return preset(name, dim=768, r=48, n_max=n_max, pq_m=96, e_search=40,
                  e_pos=64, cache_capacity_pages=256, max_hops=96,
                  buffer_max=256)


def phase_small(torch) -> None:
    """The test suite's configuration, built and searched on the card."""
    from repro_torch import random as jr
    from repro_torch.core import (Engine, brute_force_topk,
                                  check_invariants, recall_at_k)
    from repro_torch.data import make_clustered, query_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    vecs, _, cents = make_clustered(gen, 1200, 48, n_clusters=12,
                                    scale=3.0, noise=1.0)
    qs = query_stream(gen, cents, 40)
    eng = Engine(_spec_small())
    t0 = time.perf_counter()
    state = eng.build(jr.PRNGKey(2), vecs, build_block=64, build_e_pos=32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids, dists, _, state = eng.search_many(state, qs)
    truth = brute_force_topk(qs, vecs, 1200, 10)
    recall = recall_at_k(ids, truth)
    inv = check_invariants(state.store)
    finite = bool(torch.isfinite(dists[ids >= 0]).all())
    emit("small", n=1200, build_s=build_s, recall_at_10=recall,
         invariants=all(inv.values()), shape=list(ids.shape),
         finite=finite)
    require(tuple(ids.shape) == (40, 10) and finite, "small: bad output")
    require(all(inv.values()), f"small: invariants {inv}")
    require(recall >= 0.9, f"small: recall@10 {recall} < 0.9")
    return eng, state, qs, cents


def _tree_diff(torch, a, b, name="") -> list[str]:
    """Names of the fields where two state objects differ (tensors by
    value, host numbers by ==)."""
    import dataclasses
    if isinstance(a, torch.Tensor):
        same = a.shape == b.shape and bool(torch.equal(a, b))
        return [] if same else [name]
    if dataclasses.is_dataclass(a):
        pairs = [(f.name, getattr(a, f.name), getattr(b, f.name))
                 for f in dataclasses.fields(a)]
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        pairs = list(zip(a._fields, a, b))
    else:
        return [] if a == b else [name]
    return [d for n, x, y in pairs
            for d in _tree_diff(torch, x, y, f"{name}.{n}" if name else n)]


def _entrance_inverse_ok(torch, ent) -> bool:
    """ids and main_to_ent are each other's inverse on the live members."""
    ids, m2e = ent.ids, ent.main_to_ent
    slots = torch.arange(ids.shape[0], device=ids.device)
    live = ids >= 0
    held = m2e >= 0
    verts = torch.arange(m2e.shape[0], device=m2e.device)
    return (bool((m2e[ids[live].long()] == slots[live]).all()) and
            bool((ids[m2e[held].long()] == verts[held]).all()))


def _self_search(torch, eng, state, vs, new_ids):
    """Search for each inserted vector (waves of WAVE queries).  Returns
    (ids [N, k], share of vectors found in their own top k)."""
    ids = torch.cat([eng.search_many(state, vs[i:i + WAVE])[0]
                     for i in range(0, vs.shape[0], WAVE)])
    return ids, float((ids == new_ids[:, None]).any(1).float().mean())


def phase_small_update(torch, eng, state, qs, cents) -> None:
    """The update path on the small index: an insert wave of 64, 8
    sequential inserts, 8 deletes (one an entrance member), then the 40
    queries through search_many and search_batch; and a wave of one
    against the sequential insert."""
    from repro_torch.core import check_invariants
    from repro_torch.data import insert_stream
    gen = torch.Generator(device="cuda").manual_seed(7)
    vs = insert_stream(gen, cents, 64, drift=0.2)
    vb = insert_stream(gen, cents, 8, drift=0.2)
    n0 = state.store.count
    stats_m, st = eng.insert_many(state, vs)
    stats_b, st = eng.insert_batch(st, vb)
    new_ids = torch.arange(n0, n0 + 72, device="cuda", dtype=torch.int32)
    ids = st.ent.ids.tolist()
    member = next(v for v in ids[1:] if v >= 0)
    victims = [member] + [v for v in (5, 17, 100, 200, 300, 400, 500, 600)
                          if v != member][:7]
    st = eng.delete_many(st, victims)
    ids_m, _, _, _ = eng.search_many(st, qs)
    ids_s, _, _, _ = eng.search_batch(st, qs)
    sids, self_hits = _self_search(torch, eng, st, torch.cat([vs, vb]),
                                   new_ids)
    dead = torch.tensor(victims, device="cuda", dtype=torch.int32)
    deleted_returned = int(torch.isin(torch.cat([ids_m, ids_s, sids]),
                                      dead).sum())
    inv = check_invariants(st.store)
    budget = _page_budget_ok(torch, st.store)
    dropped = int(stats_m.dropped.sum() + stats_b.dropped.sum())
    # a wave of one has no conflicts: the sequential insert's cache, bit
    # for bit, and its neighbor set
    one = insert_stream(gen, cents, 1, drift=0.2)
    _, st_m1 = eng.insert_many(st, one)
    _, st_s1, _ = eng.insert(st, one[0])
    cache_diff = _tree_diff(torch, st_m1.cache, st_s1.cache)
    nid = st.store.count
    same_nbrs = (sorted(st_m1.store.edges[nid].tolist()) ==
                 sorted(st_s1.store.edges[nid].tolist()))
    emit("small:update", inserted=72, deleted=len(victims),
         n_deleted=st.n_deleted, count=st.store.count,
         invariants=all(inv.values()), page_budget_ok=budget,
         dropped=dropped, self_hit_rate=self_hits,
         deleted_ids_returned=deleted_returned,
         search_many_equals_search_batch=bool(torch.equal(ids_m, ids_s)),
         entrance_promotions=st.ent.count - state.ent.count,
         wave_of_one_cache_diff=cache_diff,
         wave_of_one_same_neighbors=same_nbrs)
    require(all(inv.values()) and budget,
            f"small:update: invariants {inv}, page budget {budget}")
    require(dropped == 0, f"small:update: {dropped} inserts dropped")
    require(self_hits >= 0.9, f"small:update: self-search {self_hits}")
    require(deleted_returned == 0, "small:update: deleted ids returned")
    require(bool(torch.equal(ids_m, ids_s)),
            "small:update: search_many ids differ from search_batch")
    require(not cache_diff and same_nbrs,
            f"small:update: a wave of one differs from the sequential "
            f"insert (cache fields {cache_diff}, same neighbors "
            f"{same_nbrs})")


def _page_budget_ok(torch, store, packed: bool = False) -> bool:
    """Every page id inside the budget, and ``page_live`` counting the
    slots on each page.  Under the packed layout an insert moves its slot
    to a fresh page but its initial page keeps counting it (the
    reference's accounting, ROADMAP queue 3), so there the counts only
    bound ``page_live`` from below."""
    ep = store.edge_page.long()
    held = ep >= 0
    counts = torch.bincount(ep[held], minlength=store.p_max)
    inside = (store.next_page <= store.p_max and
              int(ep.max()) < store.next_page and
              counts.shape[0] == store.p_max)
    if packed:
        return inside and bool((counts <= store.page_live).all())
    return (inside and
            bool(torch.equal(counts.to(torch.int32), store.page_live)) and
            int(store.page_live.sum()) == int(held.sum()))


def phase_fineweb(torch, n: int = FINEWEB_N, block: int = FINEWEB_BLOCK,
                  n_waves: int = 4):
    """FineWeb-like cell (benchmarks/common.py:38-40, :72-77) at full width."""
    from repro_torch import random as jr
    from repro_torch.core import (Engine, brute_force_topk,
                                  check_invariants, preset, recall_at_k)
    from repro_torch.data import make_clustered, query_stream
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(42)
    vecs, _, cents = make_clustered(gen, n, 768, n_clusters=24, scale=3.0,
                                    noise=1.0)
    queries = query_stream(gen, cents, n_waves * WAVE)
    eng = Engine(_spec_fineweb("navis", n + 1200))
    marks = []

    def progress(stage, done, total):
        step = max(total // 10, 1)
        if done == total or done // step != (done - block) // step:
            marks.append((stage, done, round(time.perf_counter() - t0, 1)))

    t0 = time.perf_counter()
    state = eng.build(jr.PRNGKey(42), vecs, build_block=block,
                      build_e_pos=64, progress=progress)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    inv = check_invariants(state.store)
    budget = _page_budget_ok(torch, state.store)
    emit("fineweb_like:build", n=n, n_max=n + 1200, build_block=block,
         build_e_pos=64, build_s=build_s, invariants=all(inv.values()),
         page_budget_ok=budget, p_max=state.store.p_max,
         next_page=state.store.next_page,
         progress=marks)
    require(all(inv.values()), f"fineweb: invariants {inv}")
    require(budget, "fineweb: page budget check failed")

    all_ids = []
    for w in range(n_waves):
        qs = queries[w * WAVE:(w + 1) * WAVE]
        before = state.ctr_search
        launched = dict(ops.launches)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with _ReplayCheck(torch) as replay_check:
            ids, dists, stats, state = eng.search_many(state, qs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        replayed = replay_check.check()
        ctr = state.ctr_search
        per_q = lambda f: (int(getattr(ctr, f)) -
                           int(getattr(before, f))) / WAVE
        require(bool(torch.isfinite(dists[ids >= 0]).all()),
                "fineweb: non-finite distance")
        timing = eng.last_wave_timing
        wave_launches = _launched_since(ops, launched)
        emit(f"fineweb_like:wave{w}", queries=WAVE, wall_s=wall,
             qps=WAVE / wall, mean_hops=per_q("hops"),
             reads_per_query=per_q("read_requests"),
             cache_hits_per_query=per_q("cache_hits"),
             wave_s=timing["wave_s"], rerank_s=timing["rerank_s"],
             rerank_share_of_wave=timing["rerank_s"] / wall,
             replay_s=timing["replay_s"], replay_check=replayed,
             launches=wave_launches)
        require(wave_launches["casr_rerank"] == 1 and
                wave_launches["rerank_l2"] == 0,
                f"fineweb: a wave's CASR stage is not one casr_rerank "
                f"launch: {wave_launches}")
        require(wave_launches["cache_replay"] == 1 and
                wave_launches["cache_ops"] == 0 and replayed["calls"] == 1,
                f"fineweb: a wave's replay is not one cache_replay launch: "
                f"{wave_launches}")
        require(not replayed["differing_calls"],
                "fineweb: the card's cache differs from the host replay of "
                "the wave's traces")
        all_ids.append(ids)
    profile = profile_window(torch,
                             lambda: eng.search_many(state, queries[:WAVE]))
    emit("fineweb_like:profile", **profile,
         cache_us_per_launch=cache_us_per_launch(profile))
    truth = brute_force_topk(queries, vecs, n, 10)
    recall = recall_at_k(torch.cat(all_ids), truth)
    emit("fineweb_like", recall_at_10=recall, gated=False,
         pq_scan_recall_10_at_40=_pq_scan_recall(
             torch, eng, state, queries[:WAVE], truth[:WAVE], n, 40))
    return eng, state, queries[:WAVE], vecs, cents


def phase_fineweb_update(torch, eng, state, cents, n_rounds: int = 4):
    """The update path on the FineWeb-like index: rounds of an insert wave
    of WAVE vectors (drift 0.2) and a search wave, then 8 sequential
    inserts and searches, and one profiled insert wave."""
    from repro_torch.core import check_invariants
    from repro_torch.data import insert_stream, query_stream
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(43)
    n0 = state.store.count
    state0 = state
    inserted, per_insert_s = [], []
    for w in range(n_rounds):
        vs = insert_stream(gen, cents, WAVE, drift=0.2)
        qs = query_stream(gen, cents, WAVE)
        before, ent0 = state.ctr_insert, state.ent.count
        launched = dict(ops.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _ReplayCheck(torch) as replay_check:
            stats, state = eng.insert_many(state, vs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        wave_launches = _launched_since(ops, launched)
        replayed = replay_check.check()
        ctr = state.ctr_insert
        per = lambda f: (int(getattr(ctr, f)) -
                         int(getattr(before, f))) / WAVE
        hops = per("hops")
        timing, counts = eng.last_wave_timing, eng.last_wave_counts
        dropped = int(stats.dropped.sum())
        emit(f"fineweb_like:update:insert{w}", inserts=WAVE, wall_s=wall,
             inserts_per_s=WAVE / wall, seek_s=timing["seek_s"],
             replay_s=timing["replay_s"], commit_s=timing["commit_s"],
             mean_hops=hops,
             mean_rerank_rounds=float(stats.serial_rounds.double().mean())
             - hops,
             reads_per_insert=per("read_requests"),
             writes_per_insert=per("write_requests"),
             rmw_rereads_per_insert=counts["rmw_rereads"] / WAVE,
             cache_hits_per_insert=per("cache_hits"),
             entrance_promotions=state.ent.count - ent0,
             priority_admits=counts["priority_admits"], dropped=dropped,
             replay_check=replayed, launches=wave_launches)
        require(wave_launches["casr_rerank"] == 1 and
                wave_launches["rerank_l2"] == 0,
                f"fineweb:update: an insert wave's CASR stage is not one "
                f"casr_rerank launch: {wave_launches}")
        require(wave_launches["cache_replay"] == 1 and
                wave_launches["cache_ops"] <= 1,
                f"fineweb:update: an insert wave's cache is not one "
                f"cache_replay and at most one cache_ops launch: "
                f"{wave_launches}")
        require(not replayed["differing_calls"],
                "fineweb:update: the card's cache differs from the host "
                "replay of the wave's traces and commits")
        require(dropped == 0, f"fineweb:update: {dropped} inserts dropped")
        inserted.append(vs)
        per_insert_s.append(wall / WAVE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _ReplayCheck(torch) as replay_check:
            ids, dists, _, state = eng.search_many(state, qs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        replayed = replay_check.check()
        require(bool(torch.isfinite(dists[ids >= 0]).all()),
                "fineweb:update: non-finite distance")
        emit(f"fineweb_like:update:search{w}", queries=WAVE, wall_s=wall,
             qps=WAVE / wall, replay_s=eng.last_wave_timing["replay_s"],
             replay_check=replayed)
        require(not replayed["differing_calls"],
                "fineweb:update: the card's cache differs from the host "
                "replay of a search wave's traces")

    n_new = n_rounds * WAVE
    new_ids = torch.arange(n0, n0 + n_new, device="cuda", dtype=torch.int32)
    inv = check_invariants(state.store)
    budget = _page_budget_ok(torch, state.store)
    min_degree = int(state.store.degree[new_ids.long()].min())
    ent_ok = _entrance_inverse_ok(torch, state.ent)
    _, self_hits = _self_search(torch, eng, state, torch.cat(inserted),
                                new_ids)
    emit("fineweb_like:update", inserted=n_new, count=state.store.count,
         invariants=all(inv.values()), page_budget_ok=budget,
         p_max=state.store.p_max, next_page=state.store.next_page,
         min_degree_of_inserted=min_degree, entrance_inverse_ok=ent_ok,
         entrance_members=int((state.ent.ids >= 0).sum()),
         self_hit_rate=self_hits, self_hit_rate_gated=False)
    require(all(inv.values()) and budget,
            f"fineweb:update: invariants {inv}, page budget {budget}")
    require(min_degree > 0, "fineweb:update: an inserted vertex has no edge")
    require(ent_ok, "fineweb:update: entrance ids / main_to_ent broken")

    # sequential inserts and searches, one op at a time
    vs = insert_stream(gen, cents, 8, drift=0.2)
    qs = query_stream(gen, cents, 8)
    seq_insert_s, seq_search_s = [], []
    for i in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, _ = eng.insert(state, vs[i])
        torch.cuda.synchronize()
        seq_insert_s.append(time.perf_counter() - t0)
    for i in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, _, state = eng.search(state, qs[i])
        torch.cuda.synchronize()
        seq_search_s.append(time.perf_counter() - t0)
    # one more of each profiled (a cache_ops launch a hop), its state
    # dropped
    vs1, qs1 = insert_stream(gen, cents, 1, drift=0.2), query_stream(
        gen, cents, 1)
    seq_profile = profile_window(torch, lambda: eng.search(
        eng.insert(state, vs1[0])[1], qs1[0]))
    emit("fineweb_like:update:sequential",
         insert_s=seq_insert_s, search_s=seq_search_s,
         mean_insert_s=sum(seq_insert_s) / 8,
         mean_search_s=sum(seq_search_s) / 8,
         wave_s_per_insert=per_insert_s,
         profile_port_kernels=seq_profile["port_kernels"],
         cache_us_per_launch=cache_us_per_launch(seq_profile))
    # profiled on the state before the rounds: after them fewer than
    # WAVE slots are left
    vs = insert_stream(gen, cents, WAVE, drift=0.2)
    profile = profile_window(torch, lambda: eng.insert_many(state0, vs))
    emit("fineweb_like:update:profile", **profile,
         timing=eng.last_wave_timing,
         cache_us_per_launch=cache_us_per_launch(profile))
    return state


def _time_casr_on_seek_pools(torch, q, vectors, pools, k: int,
                             s: int) -> None:
    """``casr_rerank`` on a real insert wave's position-seek pools (P =
    e_pos, groups of s_pos), against its plain version: graded as in the
    kernel phase, timed, and bounded by the distinct rows these pools
    load (the wave's lanes share many candidates).
    Back-to-back calls find those rows in the L2 cache (tens of MB);
    ``device_ms_cold_l2`` overwrites it before each call, as the main
    path, which reads each row once a wave, finds it."""
    from repro_torch.kernels import ops, ref
    b, p = pools.shape
    got = ops.casr_rerank(q, vectors, pools, k=k, s=s)
    want = ref.casr_rerank_ref(q, vectors, pools, k, s)
    grade = _check_casr(torch, got, want, b)
    rows = int(want[4].sum())
    distinct = _distinct_rows(torch, pools, want[1])
    d = vectors.shape[1]
    rec, extra = _kernel_record(
        torch, "casr_rerank", grade["max_abs_err"],
        lambda: ops.casr_rerank(q, vectors, pools, k=k, s=s),
        lambda: ref.casr_rerank_ref(q, vectors, pools, k, s), None,
        n_bytes=(distinct * d * 4 + b * d * 4 + b * p * 4 + b * p * 5 +
                 b * k * 8 + b * 12),
        n_ops=3 * rows * d)
    extra["device_ms_cold_l2"] = device_ms_cold(
        torch, lambda: ops.casr_rerank(q, vectors, pools, k=k, s=s),
        "casr_rerank_kernel")
    emit(f"kernel:casr_rerank:seek_pools_p{p}_s{s}", loaded_rows=rows,
         distinct_rows=distinct, **grade,
         **{key: rec[key] for key in ("ms", "device_ms", "plain_ms",
                                      "bound_ms", "bound_by")}, **extra)
    require(grade["other_differing_lanes"] == 0 and
            grade["exact_d_within_grade"],
            f"casr_rerank on seek pools differs from its plain version "
            f"outside near ties: {grade}")


def phase_ab_update(torch, eng, state, cents, label: str = "ab:update",
                    time_casr: bool = True) -> None:
    """One insert wave of WAVE with the kernels, then under
    plain_on_device(), from the same state.  Seek lanes (neighbors, pool,
    hops, rounds, counters) must be identical except where two exact
    distances of the lane's pool lie within the rerank grade of each
    other (the kernels sum in another order); such lanes are counted.
    With no lane differing, the committed states (graph, pages, entrance,
    cache, counters) and the per-insert OpStats must be identical."""
    from repro_torch.core import insert as insert_mod
    from repro_torch.core import pq as pq_mod
    from repro_torch.core.iomodel import IOCounters
    from repro_torch.data import insert_stream
    from repro_torch.kernels import ops
    spec = eng.spec
    gen = torch.Generator(device="cuda").manual_seed(44)
    vs = insert_stream(gen, cents, WAVE, drift=0.2)

    def seek():
        entries, _ = eng._entries(state, pq_mod.adc_lut(eng.codec, vs))
        return insert_mod.position_seek(
            state.store, spec.lspec, eng.codec, state.codes, state.cache,
            IOCounters.zeros((WAVE,), "cuda"), vs, entries,
            e_pos=spec.e_pos, k=spec.k, s=spec.s_pos, rerank=spec.rerank,
            beam_width=spec.beam_width, max_hops=spec.max_hops,
            tombstone=state.tombstone, visited=spec.visited_impl)

    with _merge_routes(torch) as routes:
        seek_k = seek()
    if time_casr:
        _time_casr_on_seek_pools(torch, vs, state.store.vectors,
                                 seek_k.pool_ids, spec.k, spec.s_pos)
    stats_k, st_k = eng.insert_many(state, vs)
    torch.cuda.synchronize()
    before = dict(ops.launches)
    with ops.plain_on_device():
        seek_p = seek()
        stats_p, st_p = eng.insert_many(state, vs)
    torch.cuda.synchronize()
    flat = dict(ops.launches) == before
    differ = ((seek_k.nbrs != seek_p.nbrs).any(1) |
              (seek_k.pool_ids != seek_p.pool_ids).any(1) |
              (seek_k.hops != seek_p.hops) |
              (seek_k.rerank_rounds != seek_p.rerank_rounds))
    for f in ("read_requests", "useful_vec_bytes_read", "cache_hits"):
        differ |= getattr(seek_k.counters, f) != getattr(seek_p.counters, f)
    pool = seek_p.pool_ids
    d = ((state.store.vectors[pool.clamp(min=0).long()] - vs[:, None]) ** 2
         ).sum(-1)
    d = torch.where(pool >= 0, d, float("nan"))
    gap = (d[:, :, None] - d[:, None, :]).abs()
    tol = RERANK_ATOL + RERANK_RTOL * torch.maximum(d[:, :, None].abs(),
                                                    d[:, None, :].abs())
    near = ((gap > 0) & (gap <= tol)).flatten(1).any(1)
    n_differ = int(differ.sum())
    state_diff = _tree_diff(torch, st_k, st_p)
    stats_same = not _tree_diff(torch, stats_k, stats_p)
    emit(label, inserts=WAVE,
         seek_merge_routes=_routes_line(torch, routes),
         differing_seek_lanes=n_differ,
         near_tie_lanes_among_them=int((differ & near).sum()),
         near_tie_lanes=int(near.sum()), committed_state_diff=state_diff,
         opstats_identical=stats_same,
         launch_counts_flat_under_plain=flat)
    require(flat, f"{label}: kernels launched under plain_on_device()")
    require(not bool((differ & ~near).any()),
            f"{label}: a seek lane differs without a near tie")
    if n_differ == 0:
        require(not state_diff and stats_same,
                f"{label}: commits differ under the plain path: "
                f"{state_diff}, OpStats identical {stats_same}")



IO_FIELDS = ("hops", "read_requests", "edge_bytes_read",
             "useful_vec_bytes_read", "wasted_vec_bytes_read",
             "pad_bytes_read", "write_requests", "wasted_vec_bytes_written",
             "cache_hits")


def _io_per_op(before, after, n: int) -> dict:
    """Each I/O counter's growth from ``before`` to ``after``, per op."""
    return {f: (int(getattr(after, f)) - int(getattr(before, f))) / n
            for f in IO_FIELDS}


def _buffer_checks(torch, eng, state, vb, more) -> dict:
    """FreshDiskANN on the small index: buffered ``insert_batch`` of ``vb``
    (no I/O), a search for them (their virtual ids ``n_max + slot`` on
    top), then ``more`` buffered until ``needs_merge``, and ``merge``."""
    from repro_torch.core import check_invariants
    n_max = state.store.n_max
    stats, st = eng.insert_batch(state, vb)
    io = int(stats.read_requests.sum() + stats.write_requests.sum())
    ids, _, _, _ = eng.search_many(st, vb)
    slots = torch.arange(vb.shape[0], device="cuda", dtype=torch.int32)
    hits = bool((ids[:, 0] == n_max + slots).all())
    for i in range(0, more.shape[0], 8):
        if eng.needs_merge(st):
            break
        _, st = eng.insert_many(st, more[i:i + 8])
    due, buffered, count0 = eng.needs_merge(st), st.buf_count, st.store.count
    mstats, merged = eng.merge(st)
    inv = check_invariants(merged.store)
    out = dict(batch_io_requests=io, buffered_hits_on_top=hits,
               needs_merge_at=buffered, needs_merge=due,
               merged_count_growth=merged.store.count - count0,
               buf_count_after_merge=merged.buf_count,
               merge_write_requests=int(mstats.write_requests),
               merge_invariants=all(inv.values()),
               merge_page_budget_ok=_page_budget_ok(torch, merged.store,
                                                    packed=True))
    require(io == 0, f"presets:small: buffered inserts did I/O ({io})")
    require(hits, "presets:small: a buffered vector is not its own top hit")
    require(due and buffered > 0 and out["merged_count_growth"] == buffered
            and merged.buf_count == 0 and out["merge_write_requests"] > 0,
            f"presets:small: merge {out}")
    require(out["merge_invariants"] and out["merge_page_budget_ok"],
            f"presets:small: merge invariants {inv}")
    return out


def phase_presets_small(torch, eng, state, qs, cents) -> None:
    """The five baselines and navis with bitmaps on the small index, each
    adopting the navis build's bundle (``build(shared=...)``): the 40
    queries through ``search_many`` (recall >= 0.9, the reference's bar
    for odinann, tests/test_navis_core.py:241-245) and ``search_batch``
    (the same ids), an insert wave of 64 (drift 0.2; invariants, page
    budget, no drop); FreshDiskANN's buffer and merge; and ``calibrate``
    on navis."""
    from repro_torch import random as jr
    from repro_torch.core import (Engine, brute_force_topk,
                                  check_invariants, recall_at_k)
    from repro_torch.data import insert_stream
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(9)
    vecs = state.store.vectors[:1200]
    truth = brute_force_topk(qs, vecs, 1200, 10)
    bundle = eng.bundle(state)
    vs = insert_stream(gen, cents, 64, drift=0.2)
    cases = [(n, {}) for n in BASELINES] + [("navis",
                                             {"visited_impl": "bitmap"})]
    for name, over in cases:
        label = name + ("_bitmap" if over else "")
        fresh = name == "freshdiskann"
        e = Engine(_spec_small(name, **over))
        st = e.build(jr.PRNGKey(2), vecs, shared=bundle)
        before = dict(ops.launches)
        ids_m, d_m, _, _ = e.search_many(st, qs)
        _scan_gate(_launched_since(ops, before), int(fresh),
                   f"presets:small:{label}")
        before = dict(ops.launches)
        ids_b, _, _, _ = e.search_batch(st, qs)     # a wave per query
        _scan_gate(_launched_since(ops, before),
                   qs.shape[0] if fresh else 0,
                   f"presets:small:{label}:search_batch")
        recall = recall_at_k(ids_m, truth)
        before = dict(ops.launches)
        stats, st2 = e.insert_many(st, vs)
        _scan_gate(_launched_since(ops, before), 0,
                   f"presets:small:{label}:insert")
        inv = check_invariants(st2.store)
        budget = _page_budget_ok(torch, st2.store,
                                 packed=e.spec.layout == "packed")
        fields = dict(recall_at_10=recall,
                      search_many_equals_search_batch=bool(
                          torch.equal(ids_m, ids_b)),
                      finite=bool(torch.isfinite(d_m[ids_m >= 0]).all()),
                      invariants=all(inv.values()), page_budget_ok=budget,
                      dropped=int(stats.dropped.sum()),
                      count=st2.store.count, buf_count=st2.buf_count)
        if fresh:
            before = dict(ops.launches)
            fields.update(_buffer_checks(
                torch, e, st, insert_stream(gen, cents, 8, drift=0.2),
                insert_stream(gen, cents, 160, drift=0.2)))
            _scan_gate(_launched_since(ops, before), 1,
                       "presets:small:freshdiskann:buffer")
        emit(f"presets:small:{label}", **fields)
        require(recall >= 0.9, f"presets:small:{label}: recall@10 {recall}")
        require(fields["search_many_equals_search_batch"] and
                fields["finite"], f"presets:small:{label}: {fields}")
        require(all(inv.values()) and budget and fields["dropped"] == 0,
                f"presets:small:{label}: invariants {inv}, page budget "
                f"{budget}, dropped {fields['dropped']}")
    cal = Engine(_spec_small())
    cal.set_codec(eng.codec)
    new = cal.calibrate(state, qs)
    emit("presets:small:calibrate", queries=int(qs.shape[0]),
         s_search=new.s_search, s_pos=new.s_pos)
    require(new.s_search >= 1 and new.s_pos >= 1, "calibrate: s < 1")


def phase_presets_reuse(torch, eng, state, cents) -> None:
    """odinann on the small index after a pass: 40 deletes, ``consolidate``
    (the maintenance path's gates), then an insert wave of 64 that takes
    the 40 reclaimed slots and 24 fresh ones, its packed commits writing
    into the defragged pages.  Its full rerank launches rerank_l2_rows,
    so it runs on this path.  Gates: no drop, the free list used up,
    every invariant and the packed page budget."""
    from repro_torch import random as jr
    from repro_torch.core import Engine, check_invariants
    from repro_torch.data import insert_stream
    gen = torch.Generator(device="cuda").manual_seed(12)
    label = "presets:small:odinann:reuse"
    e = Engine(_spec_small("odinann"))
    st = e.build(jr.PRNGKey(2), state.store.vectors[:1200],
                 shared=eng.bundle(state))
    victims = _random_live(torch, st, 40, gen)
    _, st, info = _consolidate(torch, e, e.delete_many(st, victims))
    gates = _consolidation_gates(torch, e, st, victims, label)
    count0 = st.store.count
    stats, st = e.insert_many(st, insert_stream(gen, cents, 64, drift=0.2))
    inv = check_invariants(st.store, st.tombstone)
    out = dict(reuse_wave=64, dropped=int(stats.dropped.sum()),
               count_growth=st.store.count - count0,
               free_after=st.free_count, invariants=all(inv.values()),
               page_budget_ok=_page_budget_ok(torch, st.store, packed=True))
    emit(label, deleted=40, **info, consolidation=gates, **out)
    require(out["dropped"] == 0 and out["count_growth"] == 24 and
            out["free_after"] == 0 and out["invariants"] and
            out["page_budget_ok"], f"{label}: {out}")


def phase_presets_fineweb(torch, eng, state, vecs, cents):
    """Every preset on the FineWeb-like index, adopting the navis build's
    bundle (the post-build state; the cell's buffer_max 256 and 256 cache
    pages): one search wave and one insert wave of WAVE (drift 0.2) on
    the post-build state, with wall time and I/O per operation; for
    FreshDiskANN the insert wave is buffered, a search wave for the
    buffered vectors hits the buffer, and a timed ``merge`` follows.
    Gates: the presets that differ only in layout, cache or buffer return
    identical ids and distances; sel_vec the ids of navis; CASR reads
    fewer vector bytes than the full rerank; the decoupled layout writes
    fewer bytes per insert than the packed one; every state keeps its
    invariants and page budget, with no drop; rerank_l2_shared once a
    FreshDiskANN search wave.  Returns the odinann engine, its post-build
    state and the queries, and FreshDiskANN's engine, its state with the
    buffered wave, that wave and the queries (for the A/Bs)."""
    from repro_torch import random as jr
    from repro_torch.core import Engine, check_invariants
    from repro_torch.data import insert_stream, query_stream
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(45)
    qs = query_stream(gen, cents, WAVE)
    vs = insert_stream(gen, cents, WAVE, drift=0.2)
    bundle = eng.bundle(state)
    n_max = state.store.n_max
    out = {}
    for name in ("navis",) + BASELINES:
        e = Engine(_spec_fineweb(name, n_max))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = e.build(jr.PRNGKey(42), vecs, shared=bundle)
        torch.cuda.synchronize()
        adopt_s = time.perf_counter() - t0
        launched = dict(ops.launches)
        t0 = time.perf_counter()
        ids, dists, stats, st_s = e.search_many(st, qs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s_launch = _launched_since(ops, launched)
        search = dict(wall_s=wall, qps=WAVE / wall,
                      mean_rounds=float(stats.serial_rounds.double().mean()),
                      **_io_per_op(st.ctr_search, st_s.ctr_search, WAVE),
                      timing=e.last_wave_timing, launches=s_launch)
        launched = dict(ops.launches)
        t0 = time.perf_counter()
        istats, st_i = e.insert_many(st, vs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        i_launch = _launched_since(ops, launched)
        insert = dict(wall_s=wall, inserts_per_s=WAVE / wall,
                      mean_rounds=float(
                          istats.serial_rounds.double().mean()),
                      **_io_per_op(st.ctr_insert, st_i.ctr_insert, WAVE),
                      write_bytes_per_insert=float(
                          istats.write_bytes.double().mean()),
                      dropped=int(istats.dropped.sum()),
                      timing=e.last_wave_timing, launches=i_launch)
        fresh = name == "freshdiskann"
        _scan_gate(s_launch, int(fresh), f"presets:fineweb_like:{name}")
        _scan_gate(i_launch, 0, f"presets:fineweb_like:{name}:insert")
        packed = e.spec.layout == "packed"
        inv = check_invariants(st_i.store)
        budget = _page_budget_ok(torch, st_i.store, packed=packed)
        fields = dict(adopt_s=adopt_s, search=search, insert=insert,
                      invariants=all(inv.values()), page_budget_ok=budget)
        if fresh:
            fields["buffer"] = _fineweb_merge(torch, e, st_i, vs)
            buffered = (e, st_i, vs, qs)
        emit(f"presets:fineweb_like:{name}", **fields)
        require(all(inv.values()) and budget and insert["dropped"] == 0,
                f"presets:fineweb_like:{name}: invariants {inv}, page "
                f"budget {budget}, dropped {insert['dropped']}")
        require(bool(torch.isfinite(dists[ids >= 0]).all()),
                f"presets:fineweb_like:{name}: non-finite distance")
        out[name] = dict(
            ids=ids, dists=dists,
            vec_bytes=search["useful_vec_bytes_read"] +
            search["wasted_vec_bytes_read"],
            write_bytes=insert["write_bytes_per_insert"])
        if name == "odinann":
            ab = (e, st, qs)
    full = ("odinann", "odinann_cache", "layout_only", "freshdiskann")
    same = {n: bool(torch.equal(out[n]["ids"], out["odinann"]["ids"]) and
                    torch.equal(out[n]["dists"], out["odinann"]["dists"]))
            for n in full[1:]}
    sel_ids = bool(torch.equal(out["sel_vec"]["ids"], out["navis"]["ids"]))
    gates = dict(
        full_rerank_presets_identical=same,
        sel_vec_ids_equal_navis=sel_ids,
        vec_bytes_read_per_query={n: out[n]["vec_bytes"]
                                  for n in ("sel_vec", "layout_only")},
        write_bytes_per_insert={n: out[n]["write_bytes"]
                                for n in ("sel_vec", "odinann")})
    emit("presets:fineweb_like", **gates)
    require(all(same.values()), f"presets: layout, cache or buffer changed "
            f"a result: {same}")
    require(sel_ids, "presets: sel_vec's ids differ from navis's")
    require(out["sel_vec"]["vec_bytes"] < out["layout_only"]["vec_bytes"],
            "presets: CASR read no fewer vector bytes than the full rerank")
    require(out["sel_vec"]["write_bytes"] < out["odinann"]["write_bytes"],
            "presets: the decoupled layout wrote no fewer bytes per insert "
            "than the packed one")
    return ab, buffered


def _scan_gate(launched: dict, waves: int, label: str) -> None:
    """``rerank_l2_shared`` launched exactly ``waves`` times in
    ``launched`` (counts of one call): once a FreshDiskANN search wave,
    never elsewhere.  Adds the waves to BUFFER_SCANS."""
    n = launched["rerank_l2_shared"]
    require(n == waves, f"{label}: rerank_l2_shared launched {n} times for "
            f"{waves} FreshDiskANN search waves")
    BUFFER_SCANS["waves"] += waves


def phase_ab_buffer(torch, eng, state, vs, qs) -> None:
    """FreshDiskANN on the FineWeb-like index with its buffer full of the
    buffered wave ``vs``: ``rerank_l2_shared`` on the real buffer against
    its plain version, for the buffered vectors themselves (each its own
    nearest row, where the expanded form would cancel) and for the query
    wave (``_shared_grade``'s gates); then one search wave of half of each
    with the kernels and under plain_on_device() (``phase_ab``'s gates;
    ids ``n_max + slot`` read from the buffer)."""
    grades = {w: _shared_grade(torch, x, state.buf_vecs, state.buf_count,
                               f"ab:presets:buffer:{w}",
                               self_queries=w == "buffered")
              for w, x in (("buffered", vs), ("queries", qs))}
    emit("ab:presets:buffer:grade", buf_count=state.buf_count, **grades)
    half = vs.shape[0] // 2
    wave = torch.cat([vs[:half], qs[:half]]).contiguous()
    phase_ab(torch, eng, state, wave,
             torch.cat([state.store.vectors, state.buf_vecs]),
             label="ab:presets:buffer")


def _fineweb_merge(torch, eng, state, vs) -> dict:
    """After FreshDiskANN's buffered wave: ``needs_merge``, a search wave
    for the buffered vectors (each its own top hit, at ``n_max + slot``),
    then one timed ``merge`` with its I/O."""
    from repro_torch.core import check_invariants
    from repro_torch.kernels import ops
    n_max = state.store.n_max
    due = eng.needs_merge(state)
    before = dict(ops.launches)
    t0 = time.perf_counter()
    ids, _, _, _ = eng.search_many(state, vs)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    _scan_gate(_launched_since(ops, before), 1,
               "presets:fineweb_like:buffer_hits")
    slots = torch.arange(vs.shape[0], device="cuda", dtype=torch.int32)
    hits = int((ids[:, 0] == n_max + slots).sum())
    count0, buffered = state.store.count, state.buf_count
    before = dict(ops.launches)
    t0 = time.perf_counter()
    mstats, merged = eng.merge(state)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    _scan_gate(_launched_since(ops, before), 0, "presets:fineweb_like:merge")
    inv = check_invariants(merged.store)
    out = dict(needs_merge=due, buffered=buffered,
               buffer_hit_search_s=search_s, buffered_on_top=hits,
               merge_s=merge_s, merge_s_per_insert=merge_s / buffered,
               merge_io=_io_per_op(state.ctr_insert, merged.ctr_insert, 1),
               merge_write_bytes=int(mstats.write_bytes),
               count_growth=merged.store.count - count0,
               buf_count_after=merged.buf_count,
               invariants=all(inv.values()),
               page_budget_ok=_page_budget_ok(torch, merged.store,
                                              packed=True))
    require(due and hits == vs.shape[0],
            f"presets: the buffered wave: needs_merge {due}, {hits} of "
            f"{vs.shape[0]} buffered vectors on top")
    require(out["count_growth"] == buffered and merged.buf_count == 0 and
            out["merge_io"]["write_requests"] > 0 and out["invariants"] and
            out["page_budget_ok"], f"presets: merge {out}")
    return out


MAINT_IO = ("read_requests", "edge_bytes_read", "useful_vec_bytes_read",
            "pad_bytes_read", "write_requests", "edge_bytes_written",
            "wasted_vec_bytes_written", "pad_bytes_written", "hops",
            "cache_hits")


def _random_live(torch, state, n: int, gen):
    """``n`` distinct live ids drawn with ``gen`` (int32, on the card)."""
    live = torch.nonzero(state.live_mask)[:, 0]
    pick = torch.randperm(live.shape[0], generator=gen, device="cuda")[:n]
    return live[pick].to(torch.int32)


def _consolidate(torch, eng, state) -> tuple:
    """One timed ``consolidate`` with its own launches and I/O.  Returns
    (OpStats, new state, a dict for the phase line)."""
    from repro_torch.kernels import ops
    before = dict(ops.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats, st = eng.consolidate(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _launched_since(ops, before)
    io = {f: int(getattr(st.ctr_maint, f)) - int(getattr(state.ctr_maint, f))
          for f in MAINT_IO}
    out = dict(consolidate_s=wall, steps=int(stats.serial_rounds),
               **{k: v for k, v in eng.last_maint_timing.items()},
               maint_io=io, consolidate_launches=launched)
    require(all(launched[k] == 0 for k in ("casr_rerank",) + NAVIS_OFF),
            f"consolidate launched a rerank kernel: {launched}")
    return stats, st, out


def _consolidation_gates(torch, eng, st, victims, label: str) -> dict:
    """After a pass: every invariant (``no_dead_refs`` included), the
    victims and only they in the free list, live entrance members and
    default entries, the page budget with ``page_live`` counting exactly
    the holders (both layouts), the allocator reset to the holders'
    pages, and the cursor back at 0."""
    from repro_torch.core import check_invariants
    inv = check_invariants(st.store, st.tombstone)
    free = st.free_list[:st.free_count]
    members = st.ent.ids[st.ent.ids >= 0].long()
    holders = st.store.count - st.free_count
    out = dict(
        invariants=inv, free_count=st.free_count,
        free_list_is_victims=bool(torch.equal(
            torch.sort(free).values, torch.sort(victims).values)),
        entrance_members=int(members.shape[0]),
        entrance_live=not bool(st.tombstone[members].any()),
        default_entries_live=not bool(
            st.tombstone[st.default_entries.long()].any()),
        page_budget_ok=_page_budget_ok(torch, st.store),
        next_page=st.store.next_page, p_max=st.store.p_max,
        next_page_is_holders_pages=st.store.next_page ==
        -(-holders // eng.spec.lspec.per_page))
    require(all(inv.values()), f"{label}: invariants {inv}")
    require(st.free_count == victims.shape[0] and
            out["free_list_is_victims"],
            f"{label}: free list {st.free_count} of {victims.shape[0]}")
    require(out["entrance_live"] and out["default_entries_live"] and
            out["page_budget_ok"] and out["next_page_is_holders_pages"] and
            st.maint_cursor == 0, f"{label}: {out}")
    return out


def phase_maintenance_small(torch, eng, state, qs, cents) -> None:
    """Maintenance on the small index: navis after 60 deletes, one pass
    (gates above), an insert wave of 64 reusing the slots; churn at
    capacity (fill to n_max, then 3 rounds of delete 32 -> the lookahead
    trigger -> consolidate -> an insert wave of 32; no drop, recall@10 >=
    0.9 against the live-mask truth); one pass each of odinann (packed,
    static top-up) and FreshDiskANN on the adopted build."""
    from repro_torch import random as jr
    from repro_torch.core import Engine, brute_force_topk, recall_at_k
    from repro_torch.data import insert_stream
    gen = torch.Generator(device="cuda").manual_seed(11)
    victims = _random_live(torch, state, 60, gen)
    st = eng.delete_many(state, victims)
    _, st, info = _consolidate(torch, eng, st)
    gates = _consolidation_gates(torch, eng, st, victims, "maint:small")
    count0 = st.store.count
    stats, st = eng.insert_many(st, insert_stream(gen, cents, 64,
                                                  drift=0.2))
    dropped = int(stats.dropped.sum())
    emit("maint:small:navis", deleted=60, **info, **gates,
         reuse_wave=64, reuse_dropped=dropped,
         count_growth=st.store.count - count0, free_after=st.free_count)
    require(dropped == 0 and st.store.count == count0 + 4 and
            st.free_count == 0, "maint:small: the reuse wave")

    # churn at capacity
    n_max = st.store.n_max
    stats, st = eng.insert_many(st, insert_stream(
        gen, cents, n_max - st.store.count, drift=0.2))
    dropped = int(stats.dropped.sum())
    require(st.store.count == n_max, "maint:small:churn: fill")
    rounds = []
    for _ in range(3):
        victims = _random_live(torch, st, 32, gen)
        st = eng.delete_many(st, victims)
        due = eng.needs_consolidation(st, lookahead=32)
        _, st, info = _consolidate(torch, eng, st)
        freed = st.free_count
        stats, st = eng.insert_many(st, insert_stream(gen, cents, 32,
                                                      drift=0.2))
        dropped += int(stats.dropped.sum())
        rounds.append(dict(due=due, freed=freed,
                           consolidate_s=info["consolidate_s"]))
        require(due and freed == 32 and st.live_count == n_max,
                f"maint:small:churn: {rounds[-1]}")
    truth = brute_force_topk(qs, st.store.vectors, st.live_mask, 10)
    ids, _, _, _ = eng.search_many(st, qs)
    recall = recall_at_k(ids, truth)
    emit("maint:small:churn", n_max=n_max, rounds=rounds, dropped=dropped,
         recall_at_10=recall)
    require(dropped == 0, f"maint:small:churn: {dropped} inserts dropped")
    require(recall >= 0.9, f"maint:small:churn: recall@10 {recall}")

    # the packed layout with a static top-up, and FreshDiskANN (no insert
    # before: their full rerank would launch rerank_l2_rows on this path;
    # the CPU tests refine young vertices under both layouts)
    vecs = state.store.vectors[:1200]
    for name in ("odinann", "freshdiskann"):
        e = Engine(_spec_small(name))
        s = e.build(jr.PRNGKey(2), vecs, shared=eng.bundle(state))
        victims = _random_live(torch, s, 40, gen)
        s = e.delete_many(s, victims)
        _, s, info = _consolidate(torch, e, s)
        emit(f"maint:small:{name}", deleted=40, **info,
             **_consolidation_gates(torch, e, s, victims,
                                    f"maint:small:{name}"))


def phase_maintenance_fineweb(torch, eng, state, cents):
    """Maintenance on the FineWeb-like index after the update path (its
    insert waves left young vertices): ceil(0.2 * count) + 1 random live
    deletes, so ``needs_consolidation`` fires on its fraction; a search
    wave; one timed ``consolidate`` (its seconds by stage, steps, refine
    blocks, I/O and launches) with the gates above; a search wave (no
    tombstoned id, no tombstone skip) and recall@10 against the live-mask
    truth before and after; two insert waves of WAVE drawn from the free
    list only; one profiled repair step.  Returns (the state the pass
    started from, its OpStats, the state it left) for the A/B."""
    from repro_torch.core import brute_force_topk, recall_at_k
    from repro_torch.data import insert_stream, query_stream
    gen = torch.Generator(device="cuda").manual_seed(45)
    count = state.store.count
    young = int((state.young_mask & state.live_mask).sum())
    n_del = math.ceil(0.2 * count) + 1
    victims = _random_live(torch, state, n_del, gen)
    qs = query_stream(gen, cents, WAVE)
    t0 = time.perf_counter()
    deleted = eng.delete_many(state, victims)
    delete_s = time.perf_counter() - t0
    due = eng.needs_consolidation(deleted)
    young_live = int((deleted.young_mask & deleted.live_mask).sum())
    ids0, _, _, deleted = eng.search_many(deleted, qs)
    stats, done, info = _consolidate(torch, eng, deleted)
    gates = _consolidation_gates(torch, eng, done, victims,
                                 "maint:fineweb_like")
    skips0 = int(done.ctr_search.tombstone_skips)
    ids1, d1, _, after = eng.search_many(done, qs)
    skips = int(after.ctr_search.tombstone_skips) - skips0
    truth = brute_force_topk(qs, done.store.vectors, done.live_mask, 10)
    dead = [int(torch.isin(i, victims).sum()) for i in (ids0, ids1)]
    emit("maint:fineweb_like", count=count, deleted=n_del, delete_s=delete_s,
         needs_consolidation=due, young=young, young_live=young_live,
         **info, **gates, stream_write_pages=done.store.next_page,
         tombstoned_ids_returned=dead,
         tombstone_skips_after=skips,
         recall_at_10_before=recall_at_k(ids0, truth),
         recall_at_10_after=recall_at_k(ids1, truth), recall_gated=False)
    require(due, "maint:fineweb_like: needs_consolidation did not fire")
    require(young_live > 0, "maint:fineweb_like: no young vertex to refine")
    require(dead == [0, 0] and skips == 0,
            f"maint:fineweb_like: tombstoned ids {dead}, skips {skips}")
    require(bool(torch.isfinite(d1[ids1 >= 0]).all()),
            "maint:fineweb_like: non-finite distance")

    st, pages = after, [after.store.next_page]
    for w in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wstats, st = eng.insert_many(st, insert_stream(gen, cents, WAVE,
                                                       drift=0.2))
        torch.cuda.synchronize()
        pages.append(st.store.next_page)
        emit(f"maint:fineweb_like:reuse{w}", inserts=WAVE,
             wall_s=time.perf_counter() - t0,
             dropped=int(wstats.dropped.sum()), count=st.store.count,
             free_count=st.free_count, next_page=st.store.next_page)
        require(int(wstats.dropped.sum()) == 0 and st.store.count == count
                and st.free_count == n_del - (w + 1) * WAVE,
                f"maint:fineweb_like: reuse wave {w}")
    require(pages[0] < pages[1] < pages[2] <= st.store.p_max,
            f"maint:fineweb_like: next_page {pages}")
    import dataclasses
    cursor = (count // 2) // eng.spec.maint_block * eng.spec.maint_block
    emit("maint:fineweb_like:profile_repair_step", cursor=cursor,
         **profile_window(torch, lambda: eng.maintenance_step(
             dataclasses.replace(deleted, maint_cursor=cursor))))
    return deleted, stats, done


def phase_ab_maintenance(torch, eng, state, stats_k, st_k) -> None:
    """The same pass under plain_on_device(), from the same state with the
    deletes: every EngineState field and the OpStats identical to the
    kernels' pass (the kernels' sums are the plain versions', bit for
    bit)."""
    from repro_torch.kernels import ops
    before = dict(ops.launches)
    t0 = time.perf_counter()
    with ops.plain_on_device():
        stats_p, st_p = eng.consolidate(state)
    torch.cuda.synchronize()
    flat = dict(ops.launches) == before
    state_diff = _tree_diff(torch, st_k, st_p)
    stats_same = not _tree_diff(torch, stats_k, stats_p)
    emit("ab:maintenance", plain_consolidate_s=time.perf_counter() - t0,
         state_diff=state_diff, opstats_identical=stats_same,
         launch_counts_flat_under_plain=flat)
    require(flat, "ab:maintenance: kernels launched under plain_on_device()")
    require(not state_diff and stats_same,
            f"ab:maintenance: the plain pass differs: {state_diff}, "
            f"OpStats identical {stats_same}")


# ---------------------------------------------------------------------------
# the sharded path
# ---------------------------------------------------------------------------

def _init_group(torch, label: str = "sharded"):
    """A one-rank NCCL group through a ``file://`` store under ``build/``,
    so the sharded merge's gather (and the mesh's collectives) run through
    NCCL on the card.  Without NCCL the run fails."""
    import os
    import torch.distributed as dist
    store = ROOT / "build" / f"nccl_store_{os.getpid()}"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    try:
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                world_size=1, rank=0)
    except RuntimeError as exc:
        raise SmokeFailure(f"{label}: NCCL did not initialize: {exc}")
    emit(f"{label}:group", backend=dist.get_backend(), world_size=1,
         store=str(store.relative_to(ROOT)))
    return dist.group.WORLD


def _merge_restated(ids, dists, n_per: int):
    """distributed.py:120-137 restated in numpy on per-shard results
    [S, Q, k]: globalise, INF-pad, then the k smallest per query with the
    lower flat index first among equal distances (``lax.top_k``'s
    order)."""
    import numpy as np
    inf = np.float32(3.4e38)
    s, q, k = ids.shape
    gids = np.where(ids >= 0, ids + np.arange(s)[:, None, None] * n_per, -1)
    d = np.where(ids >= 0, dists, inf).astype(np.float32)
    d = d.transpose(1, 0, 2).reshape(q, s * k)
    gids = gids.transpose(1, 0, 2).reshape(q, s * k)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    d = np.take_along_axis(d, order, 1)
    return np.where(d < inf, np.take_along_axis(gids, order, 1), -1), d


def phase_dist_small(torch, group) -> None:
    """The reference test's own configuration (tests/test_distributed.py:
    18-47): N 1,024 at D 32 in 8 shards of 128, a sharded search of 16
    queries (recall@10 >= 0.75, its bar; the merge equal, bit for bit, to
    the reference's restated in numpy on the same per-shard results), then
    8 vectors routed with bucket 4 and a sharded insert (counts sum to
    1,032)."""
    import numpy as np
    from repro_torch import random as jr
    from repro_torch.core import (Engine, brute_force_topk,
                                  check_invariants, preset, recall_at_k)
    from repro_torch.core import distributed as dist_mod
    from repro_torch.data import make_clustered, query_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    vecs, _, cents = make_clustered(gen, 1024, 32, n_clusters=8, noise=1.0)
    qs = query_stream(gen, cents, 16)
    eng = Engine(preset("navis", dim=32, r=12, n_max=144, e_search=32,
                        e_pos=40, pq_m=16, cache_capacity_pages=64,
                        max_hops=48, buffer_max=32, ent_frac=0.10))
    t0 = time.perf_counter()
    states = dist_mod.build_sharded_state(eng, jr.PRNGKey(2), vecs, 8,
                                          group=group)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    search = dist_mod.make_sharded_search(eng, 128, group=group)
    ids, dists, _ = search(states, qs)
    per = [eng.search_many(st, qs)[:2] for st in states]
    want_i, want_d = _merge_restated(
        np.stack([i.cpu().numpy() for i, _ in per]),
        np.stack([d.cpu().numpy() for _, d in per]), 128)
    merge_equal = (np.array_equal(ids.cpu().numpy(), want_i) and
                   np.array_equal(dists.cpu().numpy(), want_d))
    recall = recall_at_k(ids, brute_force_topk(qs, vecs, 1024, 10))
    routed, valid = dist_mod.route_inserts(
        vecs[:8] + 0.01, torch.arange(8), 8, 4)
    states = dist_mod.make_sharded_insert(eng, 4, group=group)(
        states, routed, valid)
    counts = [st.store.count for st in states]
    inv = all(all(check_invariants(st.store).values()) for st in states)
    emit("dist:small", n=1024, shards=8, n_per=128, build_s=build_s,
         recall_at_10=recall, merge_equals_restated=merge_equal,
         counts=counts, invariants=inv, timing=search.last_timing)
    require(recall >= 0.75, f"dist:small: recall@10 {recall} < 0.75")
    require(merge_equal, "dist:small: the merge differs from the "
            "reference's restated on the same per-shard results")
    require(sum(counts) == 1024 + 8 and inv,
            f"dist:small: counts {counts}, invariants {inv}")


def _sharded_wave(torch, search, states, qs) -> tuple:
    """One timed sharded search wave with its launches and its I/O per
    query summed over the shards.  Returns (ids, dists, states, fields)."""
    from repro_torch.kernels import ops
    launched = dict(ops.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, dists, after = search(states, qs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    io = {f: sum(int(getattr(a.ctr_search, f)) - int(getattr(b.ctr_search, f))
                 for a, b in zip(after, states)) / qs.shape[0]
          for f in IO_FIELDS}
    fields = dict(queries=int(qs.shape[0]), wall_s=wall,
                  qps=qs.shape[0] / wall, **search.last_timing,
                  io_per_query=io,
                  launches=_launched_since(ops, launched))
    return ids, dists, after, fields


def _sharded_result_gates(torch, ids, dists, states, qs, n_per: int,
                          label: str) -> dict:
    """Global ids in range (a live local id of a shard) and unique per
    query, distances ascending, each within 1e-3 of the exact L2 to its
    id's vector (float64)."""
    q, k = ids.shape
    held = ids >= 0
    shard, local = (ids // n_per).long(), (ids % n_per).long()
    counts = torch.tensor([st.store.count for st in states],
                          device=ids.device)
    in_range = bool(((shard < len(states)) & (local < counts[
        shard.clamp(max=len(states) - 1)]))[held].all())
    srt = torch.sort(ids, dim=1).values
    unique = bool(((srt[:, 1:] != srt[:, :-1]) | (srt[:, 1:] < 0)).all())
    ascending = bool((dists[:, 1:] >= dists[:, :-1]).all())
    vecs = torch.zeros((q, k, qs.shape[1]), device=qs.device)
    for s, st in enumerate(states):
        m = held & (shard == s)
        vecs[m] = st.store.vectors[local[m]]
    exact = ((vecs.double() - qs[:, None].double()) ** 2).sum(-1)
    err = (dists.double() - exact).abs()[held]
    out = dict(ids_in_range=in_range, ids_unique=unique,
               dists_ascending=ascending, held_slots=int(held.sum()),
               max_abs_err_to_exact_l2=float(err.max()),
               exact_l2_within_1e_3=bool((err <= 1e-3).all()))
    require(in_range and unique and ascending and
            out["exact_l2_within_1e_3"], f"{label}: {out}")
    return out


def phase_dist_fineweb(torch, group, vecs, cents):
    """The FineWeb-like cell sharded: the corpus in SHARDS shards of
    SHARD_N (n_max SHARD_N + SHARD_HEADROOM, build block FINEWEB_BLOCK),
    one global codec; a sharded search wave of WAVE (QPS, seconds in the
    shard searches, the gather and the merge, I/O per query summed over
    the shards, recall@10 against brute force over the whole corpus;
    casr_rerank once per shard); a routed insert wave of WAVE (ids count
    .. count + WAVE - 1, WAVE / SHARDS a shard, no drop, invariants and
    page budget on every shard); a search wave after it.  Global ids use
    n_per = the shard's capacity, so inserted vertices keep unique ids.
    Returns (engine, post-build states, queries, routed, valid) for the
    A/B."""
    from repro_torch import random as jr
    from repro_torch.core import (Engine, brute_force_topk,
                                  check_invariants, recall_at_k)
    from repro_torch.core import distributed as dist_mod
    from repro_torch.data import insert_stream, query_stream
    n = SHARDS * SHARD_N
    n_max = SHARD_N + SHARD_HEADROOM
    eng = Engine(_spec_fineweb("navis", n_max))
    t0 = time.perf_counter()
    states = dist_mod.build_sharded_state(
        eng, jr.PRNGKey(42), vecs[:n], SHARDS, group=group,
        build_block=FINEWEB_BLOCK, build_e_pos=64)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    inv = [all(check_invariants(st.store).values()) for st in states]
    budget = [_page_budget_ok(torch, st.store) for st in states]
    emit("dist:fineweb_like:build", n=n, shards=SHARDS, shard_n=SHARD_N,
         reduced=[f"corpus: the first {n} of {FINEWEB_N} vectors"],
         n_max=n_max, build_block=FINEWEB_BLOCK, build_s=build_s,
         invariants=inv, page_budget_ok=budget)
    require(all(inv) and all(budget),
            f"dist:fineweb_like: invariants {inv}, page budget {budget}")

    gen = torch.Generator(device="cuda").manual_seed(46)
    qs = query_stream(gen, cents, WAVE)
    search = dist_mod.make_sharded_search(eng, n_max, group=group)
    ids, dists, searched, wave = _sharded_wave(torch, search, states, qs)
    gates = _sharded_result_gates(torch, ids, dists, searched, qs, n_max,
                                  "dist:fineweb_like")
    corpus = torch.where(ids >= 0, ids // n_max * SHARD_N + ids % n_max, -1)
    recall = recall_at_k(corpus, brute_force_topk(qs, vecs[:n], n, 10))
    emit("dist:fineweb_like:search", **wave, **gates, recall_at_10=recall,
         recall_gated=False)
    require(wave["launches"]["casr_rerank"] == SHARDS,
            f"dist:fineweb_like: casr_rerank launched "
            f"{wave['launches']['casr_rerank']} times for {SHARDS} shards")

    count = n
    vs = insert_stream(gen, cents, WAVE, drift=0.2)
    bucket = WAVE // SHARDS
    routed, valid = dist_mod.route_inserts(
        vs, torch.arange(count, count + WAVE), SHARDS, bucket)
    insert = dist_mod.make_sharded_insert(eng, bucket, group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inserted = insert(searched, routed, valid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dropped = int(sum(s.dropped.sum() for s in insert.last_stats))
    inv = [all(check_invariants(st.store).values()) for st in inserted]
    budget = [_page_budget_ok(torch, st.store) for st in inserted]
    emit("dist:fineweb_like:insert", inserts=WAVE, bucket=bucket,
         routed=int(valid.sum()), wall_s=wall, inserts_per_s=WAVE / wall,
         dropped=dropped, counts=[st.store.count for st in inserted],
         invariants=inv, page_budget_ok=budget)
    require(int(valid.sum()) == WAVE and dropped == 0,
            f"dist:fineweb_like: {WAVE - int(valid.sum())} routed entries "
            f"lost, {dropped} inserts dropped")
    require(all(inv) and all(budget),
            f"dist:fineweb_like: after the insert, invariants {inv}, page "
            f"budget {budget}")

    ids, dists, _, wave = _sharded_wave(torch, search, inserted, qs)
    gates = _sharded_result_gates(torch, ids, dists, inserted, qs, n_max,
                                  "dist:fineweb_like:search_after_insert")
    emit("dist:fineweb_like:search_after_insert", **wave, **gates)
    return eng, states, qs, routed, valid


def phase_dist_dryrun(torch) -> None:
    """``distributed.dryrun`` of the FineWeb-like spec on both production
    meshes (one shard a device; the reference's defaults: n_per 65,536, a
    wave of 64, buckets of 8), on the host: a shard's state bytes, each
    op's input bytes and collectives per device, and what no meta run
    counts.  Gated: the search gathers the ids and distances of every
    shard's pools (2 calls, 8 bytes a slot), the insert nothing."""
    from repro_torch.core import Engine
    from repro_torch.core import distributed as dist_mod
    from repro_torch.launch import mesh as M
    eng = Engine(_spec_fineweb("navis", SHARD_N + SHARD_HEADROOM))
    out = {name: dist_mod.dryrun(eng, M.make_production_mesh(multi_pod=multi))
           for name, multi in (("pod16x16", False), ("pod2x16x16", True))}
    emit("dist:dryrun", spec="fineweb_like", **out)
    for name, r in out.items():
        search = r["search"]["collectives"]
        pools = r["search"]["devices"] * 64 * eng.spec.k * 8
        require(search["op_counts"]["all-gather"] == 2 and
                search["bytes_by_kind"]["total"] == pools and
                r["insert"]["collectives"]["bytes_by_kind"]["total"] == 0,
                f"dist:dryrun {name}: {r}")


def phase_ab_sharded(torch, group, eng, states, qs, routed, valid) -> None:
    """The FineWeb-like sharded search and insert with the kernels, then
    under plain_on_device(), from the same post-build states: ids and
    every field of every shard's state identical after the search and
    after the insert (the insert starts from the kernels' searched
    states in both runs); distances within the rerank grade (the CASR
    kernel sums in another order than the plain version), and whether
    they are identical too."""
    from repro_torch.core import distributed as dist_mod
    from repro_torch.kernels import ops
    n_max = SHARD_N + SHARD_HEADROOM
    search = dist_mod.make_sharded_search(eng, n_max, group=group)
    insert = dist_mod.make_sharded_insert(eng, routed.shape[1], group=group)
    ids_k, d_k, searched_k = search(states, qs)
    inserted_k = insert(searched_k, routed, valid)
    torch.cuda.synchronize()
    before = dict(ops.launches)
    t0 = time.perf_counter()
    with ops.plain_on_device():
        ids_p, d_p, searched_p = search(states, qs)
        inserted_p = insert(searched_k, routed, valid)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    flat = dict(ops.launches) == before
    diff = {f"search:shard{s}": _tree_diff(torch, a, b)
            for s, (a, b) in enumerate(zip(searched_k, searched_p))}
    diff.update({f"insert:shard{s}": _tree_diff(torch, a, b)
                 for s, (a, b) in enumerate(zip(inserted_k, inserted_p))})
    diff = {k: v for k, v in diff.items() if v}
    ids_same = bool(torch.equal(ids_k, ids_p))
    held = ids_k >= 0
    d_ok = bool(torch.allclose(d_k[held], d_p[held], rtol=RERANK_RTOL,
                               atol=RERANK_ATOL))
    emit("ab:sharded", queries=int(qs.shape[0]), inserts=int(valid.sum()),
         plain_s=plain_s, ids_identical=ids_same,
         dists_identical=bool(torch.equal(d_k, d_p)),
         dists_within_tolerance=d_ok, state_diff=diff,
         launch_counts_flat_under_plain=flat)
    require(flat, "ab:sharded: kernels launched under plain_on_device()")
    require(ids_same and d_ok and not diff,
            f"ab:sharded: the plain run differs: ids identical {ids_same}, "
            f"dists within the grade {d_ok}, state fields {diff}")


def _pq_scan_recall(torch, eng, state, qs, truth, n: int, depth: int):
    """Share of the exact top-10 inside the top-``depth`` of a full PQ
    (ADC) scan of the corpus: the ceiling a PQ-guided search with a pool
    of ``depth`` can reach before its exact rerank."""
    from repro_torch.core import pq as pq_mod
    lut = pq_mod.adc_lut(eng.codec, qs)                    # [Q, M, 256]
    codes = state.codes[:n].long()
    d = torch.zeros((qs.shape[0], n), device=qs.device)
    for m in range(codes.shape[1]):
        d += lut[:, m, codes[:, m]]
    top = torch.sort(d, dim=1, stable=True).indices[:, :depth]
    hits = (top[:, :, None] == truth[:, None, :].long()).any(1)
    return float(hits.float().mean())


@contextlib.contextmanager
def _merge_routes(torch):
    """While open, ``ops.pool_merge`` launches through
    ``pool_merge_with_routes`` (the same kernel, the same results, one
    launch counted as before), adding each lane's route to the int64 [3]
    of its (P, Q) in the dict it yields: which routes a path's merges
    take.  Each call also records, on the device, its lanes whose pool
    still ends in padding (3.4e38: a search's first hops) and the new
    entries below each pool's largest (the survivors the kernel places).
    Only around calls that run the kernels."""
    from repro_torch.kernels import ops
    by_shape = {}
    kernel = ops.pool_merge

    def counted(pool_d, pool_ids, new_d, new_ids):
        key = f"{pool_d.shape[1]}x{new_d.shape[1]}"
        acc = by_shape.setdefault(key, {
            "routes": torch.zeros(3, dtype=torch.int64,
                                  device=pool_d.device), "calls": []})
        top = pool_d[:, -1:]
        padded = top[:, 0] >= 3.4e38
        survivors = (new_d < top).sum(1)
        acc["calls"].append(torch.stack([
            padded.sum(), (survivors * padded).sum(), survivors.sum(),
            torch.tensor(pool_d.shape[0], device=pool_d.device)]))
        return ops.pool_merge_with_routes(pool_d, pool_ids, new_d, new_ids,
                                          acc["routes"])
    ops.pool_merge = counted
    try:
        yield by_shape
    finally:
        ops.pool_merge = kernel


def _routes_line(torch, by_shape: dict) -> dict:
    """By (P, Q): the lanes each route took, the merges and lanes, the
    lanes whose pool ended in padding (in all, and merge by merge) and the
    mean survivors of those lanes and of the others."""
    from repro_torch.kernels import ops
    out = {}
    for key, acc in sorted(by_shape.items()):
        calls = torch.stack(acc["calls"]).tolist()
        padded = sum(c[0] for c in calls)
        lanes = sum(c[3] for c in calls)
        out[key] = {
            **dict(zip(ops.POOL_MERGE_ROUTES, acc["routes"].tolist())),
            "merges": len(calls), "lanes": lanes, "padded_lanes": padded,
            "padded_lanes_by_merge": [c[0] for c in calls],
            "mean_survivors_padded": sum(c[1] for c in calls) / padded
            if padded else None,
            "mean_survivors_other": (sum(c[2] - c[1] for c in calls) /
                                     (lanes - padded))
            if lanes > padded else None}
    return out


def phase_ab(torch, eng, state, qs, vecs, label: str = "ab") -> None:
    """One wave with the kernels, then under plain_on_device(): ids equal
    outside near ties, distances within the rerank grade, and each query
    whose ids are equal with the same I/O (reads, bytes, serial rounds,
    cache hits and misses).  The kernels' wave also counts the merge
    kernel's routes by shape (``merge_routes``)."""
    from repro_torch.kernels import ops
    with _merge_routes(torch) as routes:
        ids_k, d_k, st_k, state_k = eng.search_many(state, qs)
    torch.cuda.synchronize()
    before = dict(ops.launches)
    with ops.plain_on_device():
        ids_p, d_p, st_p, state_p = eng.search_many(state, qs)
    torch.cuda.synchronize()
    flat = dict(ops.launches) == before
    # the traversal's kernels are exact, so both waves charge the same
    # pages: the replayed caches must be equal bit for bit
    cache_diff = _tree_diff(torch, state_k.cache, state_p.cache)
    differ = ids_k != ids_p
    same_q = ~differ.any(1)
    io_same = torch.stack([a == b for a, b in zip(st_k, st_p)]).all(0)
    near_ties = 0
    if bool(differ.any()):
        rows, cols = differ.nonzero(as_tuple=True)
        ka, pa = ids_k[rows, cols].long(), ids_p[rows, cols].long()
        ok = (ka >= 0) & (pa >= 0)
        da = ((vecs[ka.clamp(min=0)] - qs[rows]) ** 2).sum(-1)
        db = ((vecs[pa.clamp(min=0)] - qs[rows]) ** 2).sum(-1)
        tie = ok & ((da - db).abs() <= RERANK_ATOL + RERANK_RTOL *
                    torch.maximum(da.abs(), db.abs()))
        near_ties = int(tie.sum())
        require(bool(tie.all()), f"{label}: {int((~tie).sum())} id slots "
                "differ beyond the rerank tolerance")
    same = ~differ & (ids_k >= 0)
    d_ok = bool(torch.allclose(d_k[same], d_p[same], rtol=RERANK_RTOL,
                               atol=RERANK_ATOL))
    emit(label, queries=int(qs.shape[0]), identical_slots=int(same.sum()),
         near_tie_slots=near_ties, dists_within_tolerance=d_ok,
         queries_with_equal_ids=int(same_q.sum()),
         equal_io_among_them=int((io_same & same_q).sum()),
         cache_diff=cache_diff, launch_counts_flat_under_plain=flat,
         merge_routes=_routes_line(torch, routes))
    require(flat, f"{label}: kernels launched under plain_on_device()")
    require(not cache_diff, f"{label}: the replayed cache differs under the "
            f"plain path: {cache_diff}")
    require(d_ok, f"{label}: distances outside the rerank tolerance")
    require(bool(io_same[same_q].all()),
            f"{label}: a query with equal ids has other I/O under the plain "
            "path")


# ---------------------------------------------------------------------------
# the serving path: the LM substrate (qwen2-0.5b at full width) and RAG
# ---------------------------------------------------------------------------

class Paths:
    """Each path's launch counts: set to 0 when it starts, read, printed
    and held to ``PATH_KERNELS`` when it ends."""

    def __init__(self, ops):
        self.ops, self.started = ops, {}

    def start(self, path: str) -> None:
        self.ops.reset_launches()
        self.started[path] = time.perf_counter()

    def end(self, path: str) -> dict:
        counts = dict(self.ops.launches)
        emit("kernels" if path == "search" else f"kernels:{path}",
             launches=counts,
             path_s=time.perf_counter() - self.started[path])
        on, off = PATH_KERNELS[path]
        require(all(counts[k] > 0 for k in on) and
                all(counts[k] == 0 for k in off),
                f"{path} path launches: want {on} launched and {off} not, "
                f"got {counts}")
        return counts


def serving_path(torch, paths: Paths) -> dict:
    """The LMs alone (their counts read as ``serving``): qwen2-0.5b, then
    the other architectures of SERVE_MODELS and the float32 checks of
    FP32_MODELS; then training (read as ``train``, ``train_path``); then
    the mesh (read as ``mesh``, ``mesh_path``); then RAG, where qwen2-0.5b
    embeds and the navis engine retrieves (read as ``rag``).  Returns each
    path's counts by name.  The mesh path's dry-run sweep, a host
    subprocess, starts first and runs beside all of them."""
    sweep = _start_dryrun()
    try:
        paths.start("serving")
        cfg, params = phase_serving(torch)
        params32 = phase_serving_fp32(torch)
        phase_serving_chunked(torch, params32, params)
        del params32
        for arch, layers, loads in SERVE_MODELS:
            phase_serving_model(torch, arch, layers, loads)
            torch.cuda.empty_cache()
        for arch in FP32_MODELS:
            phase_serving_fp32(torch, arch, FP32_LAYERS)
            torch.cuda.empty_cache()
        counts = {"serving": paths.end("serving")}
        counts["train"] = train_path(torch, paths)
    except BaseException:
        _stop(sweep)
        raise
    counts.update(mesh_path(torch, paths, sweep))
    paths.start("rag")
    phase_serving_rag(torch, cfg, params)
    counts["rag"] = paths.end("rag")
    return counts


def _serve_cfg(dtype: str = "bfloat16"):
    """The published qwen2-0.5b (``src/repro/configs/qwen2_0_5b.py``), in
    ``dtype``; its widths are checked, never cut."""
    import dataclasses
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(C.get_arch(SERVE_ARCH).model,
                              param_dtype=dtype)
    widths = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
              cfg.d_ff, cfg.vocab_size, cfg.qkv_bias, cfg.tie_embeddings)
    require(widths == (24, 896, 14, 2, 4864, 151_936, True, True),
            f"serving: {SERVE_ARCH} widths {widths}")
    return cfg, T.param_count(cfg)


def _published(arch: str, dtype: str = "bfloat16", layers=None):
    """The published configuration of ``arch`` in ``dtype``, its widths
    pinned by its parameter count, and cut to its first ``layers`` layers
    where given (whisper's encoder to as many).  Returns (cfg, the cuts
    made, as ``reduced``)."""
    import dataclasses
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    cfg = C.get_arch(arch).model
    n = T.param_count(cfg)
    require(n == PUBLISHED_PARAMS[arch],
            f"serving: {arch} has {n} parameters, published "
            f"{PUBLISHED_PARAMS[arch]}")
    cfg = dataclasses.replace(cfg, param_dtype=dtype)
    if layers is None or layers >= cfg.num_layers:
        return cfg, []
    stages, left = [], layers
    for pat in cfg.patterns:
        for _ in range(pat.repeats):
            for st in pat.stages:
                if left > 0:
                    stages.append(T.StageSpec(st.kind, min(st.count, left),
                                              st.window))
                    left -= stages[-1].count
    reduced = [f"depth: {layers} of {cfg.num_layers} layers"]
    if cfg.encoder_layers:
        reduced.append(f"encoder depth: {layers} of {cfg.encoder_layers}")
    cfg = dataclasses.replace(
        cfg, num_layers=layers, patterns=(T.Pattern(1, tuple(stages)),),
        encoder_layers=min(cfg.encoder_layers, layers))
    return cfg, reduced


def _rel_l2(torch, got, want) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want) /
                 torch.linalg.vector_norm(want))


def _prefill_then_decode(torch, cfg, params, tokens, cross=None) -> float:
    """Relative L2 error between the prefill of ``tokens[:, :S-1]`` then
    one decode of ``tokens[:, S-1]`` at ``pos = S-1``, and the last logits
    of the prefill of ``tokens`` (``cross``: the cross layers' source)."""
    from repro_torch.models import transformer as T
    S = tokens.shape[1]
    with torch.inference_mode():
        _, cache = T.prefill_step(cfg, params, tokens[:, :S - 1],
                                  max_seq=S, cross_src=cross)
        got, _ = T.decode_step(cfg, params, cache, tokens[:, S - 1:], S - 1)
        del cache
        want, _ = T.prefill_step(cfg, params, tokens, cross_src=cross)
    return _rel_l2(torch, got, want)


@contextlib.contextmanager
def _recorded_routes():
    """Every ``moe_router`` call's expert ids, in call order, while the
    context is open."""
    from repro_torch.models import layers as L
    routes, router = [], L.moe_router

    def record(wg, x, top_k):
        gates, idx = router(wg, x, top_k)
        routes.append(idx)
        return gates, idx
    L.moe_router = record
    try:
        yield routes
    finally:
        L.moe_router = router


def _no_drop(cfg):
    """A MoE configuration at the capacity factor E / k, where capacity =
    T and no assignment drops; other configurations as they are."""
    import dataclasses
    if not cfg.moe_experts:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=cfg.moe_experts / cfg.moe_top_k)


def _route_flips(routes, n_layers: int, batch: int) -> list[int]:
    """Per MoE layer, the rows whose expert set for the last token differs
    between the decode and the longer prefill of ``_prefill_then_decode``
    (its router calls: the shorter prefill's, the decode's, the longer
    prefill's, one per layer each)."""
    dec, full = routes[n_layers:2 * n_layers], routes[2 * n_layers:]
    return [int((d.sort(-1).values != f.reshape(batch, -1, f.shape[-1])
                 [:, -1].sort(-1).values).any(-1).sum())
            for d, f in zip(dec, full)]


def _has_mamba(cfg) -> bool:
    return any(st.kind in ("mamba", "hybrid") for pat in cfg.patterns
               for st in pat.stages)


def _serve_load(torch, cfg, params, label: str, batch: int, prompt: int,
                gen: int) -> dict:
    """``launch.serve.serve`` at one load after a short warm-up of it (2
    decode steps): the phases' times, the memory the serve adds to what
    is live, the output gates and the prefill-then-decode error in bf16,
    gated at 2e-2 relative L2 where the two sides compute the same
    function in the same way; ``prefill_then_decode_gated`` says whether
    it was.  Where they do not, the error is printed, and a float32 check
    on the card gates the same property:

    - A MoE's capacity binds at its published factor, so the prefill of
      S-1 tokens, the decode of one and the prefill of S drop different
      assignments (the reference's semantics).  The caches are checked
      at a factor where nothing drops (``_no_drop``), on the load's first
      4 rows (the buffers grow with T); even then a router logit rounded
      to bf16 that moves by an ulp between the decode's and the prefill's
      products can change a token's experts, so the error is gated only
      where every layer routed the last token alike (the layers where it
      did not are printed).  ``phase_serving_fp32`` gates it in float32.
    - The Mamba mixer's decode rounds otherwise than its prefill by the
      reference's definition (the conv as one product, ``y + x * D``
      summed in float32 before the cast), so in bf16 the two differ by
      more with each layer; ``_prefill_then_decode_fp32`` gates it at
      full depth in float32."""
    from repro_torch.launch.serve import cross_source, prompt_tokens, serve
    serve(cfg, batch=batch, prompt_len=prompt, gen=min(gen, 2), seed=0,
          device="cuda", params=params)                       # warm-up
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()       # the weights, earlier paths
    res = serve(cfg, batch=batch, prompt_len=prompt, gen=gen, seed=0,
                device="cuda", params=params)
    peak = torch.cuda.max_memory_allocated()
    tokens = prompt_tokens(cfg, batch, prompt, 0, "cuda")
    cross = cross_source(cfg, batch, 0, "cuda")
    rel = gate_rel = _prefill_then_decode(torch, cfg, params, tokens, cross)
    toks = res["tokens"]
    out = dict(batch=batch, prompt_len=prompt, decode_steps=gen,
               prefill_s=res["prefill_s"],
               prefill_tokens_s=batch * prompt / res["prefill_s"],
               decode_s=res["decode_s"],
               decode_tokens_s=batch * gen / res["decode_s"],
               decode_ms_per_step=res["decode_s"] / gen * 1e3,
               peak_mem_bytes=peak, live_before_bytes=live,
               serve_peak_bytes=peak - live,
               logits_finite=bool(torch.isfinite(res["logits"]).all()),
               tokens_in_vocab=bool(((toks >= 0) &
                                     (toks < cfg.vocab_size)).all()),
               prefill_then_decode_rel_l2=rel,
               sample=toks[0, :8].tolist())
    gated = not _has_mamba(cfg)
    if cfg.moe_experts:
        rows = min(batch, 4)
        with _recorded_routes() as routes:
            gate_rel = _prefill_then_decode(
                torch, _no_drop(cfg), params, tokens[:rows],
                None if cross is None else cross[:rows])
        flips = _route_flips(routes, cfg.num_layers, rows)
        gated = not any(flips)
        out.update(prefill_then_decode_rel_l2_no_drop=gate_rel,
                   route_flips_by_layer=flips,
                   layers_routed_apart=sum(f > 0 for f in flips))
    out["prefill_then_decode_gated"] = gated
    emit(f"serving:{label}", **out)
    require(tuple(toks.shape) == (batch, gen + 1) and
            out["logits_finite"] and out["tokens_in_vocab"],
            f"serving {label}: bad output {out}")
    require(not gated or gate_rel <= 2e-2,
            f"serving {label}: prefill-then-decode rel L2 {gate_rel}")
    require(peak - live <= SERVE_MEM_BUDGET,
            f"serving {label}: peak memory {peak - live} > "
            f"{SERVE_MEM_BUDGET}")
    return out


def _prefill_then_decode_fp32(torch, arch: str, layers, load) -> None:
    """The prefill-then-decode property of ``arch`` in float32 on the
    card, at the depth served, on ``load``'s prompts (a MoE at a factor
    where nothing drops): within 1e-3 relative L2."""
    from repro_torch.launch.serve import cross_source, prompt_tokens
    from repro_torch.models import transformer as T
    cfg, reduced = _published(arch, "float32", layers)
    batch, prompt, _ = load
    params = T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rel = _prefill_then_decode(
        torch, _no_drop(cfg), params, prompt_tokens(cfg, batch, prompt, 0,
                                                    "cuda"),
        cross_source(cfg, batch, 0, "cuda"))
    emit(f"serving:{arch}:fp32_prefill_then_decode", batch=batch,
         prompt_len=prompt, layers=cfg.num_layers, reduced=reduced,
         rel_l2=rel)
    require(rel <= 1e-3, f"serving {arch}: float32 prefill-then-decode {rel}")


def phase_serving(torch):
    """``launch.serve.serve`` with qwen2-0.5b at full width (bf16, seeded
    random weights, synthetic prompts) at each of SERVE_LOADS, after one
    warm-up run of the same load; then a profiled decode step and prefill
    (device idle share)."""
    from repro_torch.models import transformer as T
    cfg, n_params = _serve_cfg()
    t0 = time.perf_counter()
    params = T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    emit(f"serving:{SERVE_ARCH}:init", params=n_params,
         dtype=str(cfg.dtype), seconds=time.perf_counter() - t0,
         bytes=n_params * cfg.dtype.itemsize)
    for batch, prompt, gen in SERVE_LOADS:
        _serve_load(torch, cfg, params, SERVE_ARCH, batch, prompt, gen)
    _profile_serving(torch, cfg, params, SERVE_ARCH, SERVE_LOADS[-1])
    return cfg, params


def phase_serving_model(torch, arch: str, layers, loads) -> None:
    """One architecture of SERVE_MODELS: init on the card from a seeded
    generator (cross gates set to CROSS_GATES), ``serve`` at each of
    ``loads`` (after a warm-up of each),
    a profiled decode step and prefill at the largest load; every weight
    byte is read once a decode step (a MoE computes all its experts at
    decode), which bounds the step from below.  A model with Mamba layers
    then gates prefill-then-decode in float32 at its full depth."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cfg, reduced = _published(arch, layers=layers)
    t0 = time.perf_counter()
    params = T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    for stage in (st for pat in params["blocks"] for st in pat):
        if "gate_attn" in stage:
            stage["gate_attn"].fill_(CROSS_GATES[0])
            stage["gate_mlp"].fill_(CROSS_GATES[1])
    leaves = tree_leaves(params)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    expert_bytes = sum(
        t.numel() * t.element_size() for pat in params["blocks"]
        for stage in pat for t in stage.get("moe", {}).values())
    emit(f"serving:{arch}:init", params=sum(t.numel() for t in leaves),
         active_params=T.active_param_count(cfg), layers=cfg.num_layers,
         reduced=reduced, dtype=str(cfg.dtype), seconds=init_s,
         bytes=n_bytes, weights_read_bound_ms=n_bytes / PEAK_BYTES_S * 1e3,
         expert_bytes=expert_bytes,
         expert_read_bound_ms=expert_bytes / PEAK_BYTES_S * 1e3)
    for batch, prompt, gen in loads:
        _serve_load(torch, cfg, params, arch, batch, prompt, gen)
    _profile_serving(torch, cfg, params, arch,
                     max(loads, key=lambda ld: ld[0] * ld[1]))
    if _has_mamba(cfg):
        del params, leaves
        torch.cuda.empty_cache()
        _prefill_then_decode_fp32(torch, arch, layers, loads[0])


def _profile_serving(torch, cfg, params, label: str, load) -> None:
    """One decode step and one prefill at ``load`` under the profiler: the
    device's busy share, its kernel launches and its largest kernels."""
    from repro_torch.launch.serve import cross_source, prompt_tokens
    from repro_torch.models import transformer as T
    batch, prompt, gen = load
    tokens = prompt_tokens(cfg, batch, prompt, 0, "cuda")
    cross = cross_source(cfg, batch, 0, "cuda")
    with torch.inference_mode():
        logits, cache = T.prefill_step(cfg, params, tokens,
                                       max_seq=prompt + gen, cross_src=cross)
        cur = logits.argmax(-1)[:, None]
        T.decode_step(cfg, params, cache, cur, prompt)
        win = profile_window(torch, lambda: T.decode_step(
            cfg, params, cache, cur, prompt + 1))
        emit(f"serving:{label}:profile_decode_step", batch=batch, **win)
        del cache
        win = profile_window(torch, lambda: T.prefill_step(
            cfg, params, tokens, max_seq=prompt + gen, cross_src=cross))
        emit(f"serving:{label}:profile_prefill", batch=batch,
             prompt_len=prompt, **win)


def phase_serving_fp32(torch, arch: str = SERVE_ARCH, layers=None) -> dict:
    """The card against the host: ``arch`` at full width in float32 (cut
    to ``layers`` deep where given; qwen2-0.5b whole), the same seeded
    weights (and frames) on the card and in the port on the CPU (matmul
    precision "highest": no TF32), prefill of FP32_LOAD's prompts then
    teacher-forced decode steps, both sides decoding the CPU run's greedy
    tokens.  Logits within 1e-3 absolute at every step; the argmax equal
    wherever the CPU's top-2 gap exceeds 2e-3.  Then on the card, the
    prefill of S-1 prompt tokens and one decode against the prefill of S
    (a MoE at a capacity that drops nothing): within 1e-3 relative L2.
    Returns the card's weights."""
    from repro_torch.launch.serve import cross_source, prompt_tokens
    from repro_torch.models import transformer as T
    torch.set_float32_matmul_precision("highest")
    if arch == SERVE_ARCH:
        cfg, reduced = _serve_cfg("float32")[0], []
    else:
        cfg, reduced = _published(arch, "float32", layers)
    batch, prompt, steps = FP32_LOAD
    t0 = time.perf_counter()
    p_cpu = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    p_gpu = T.Transformer(cfg, p_cpu).to("cuda").tree()
    init_s = time.perf_counter() - t0
    tokens = prompt_tokens(cfg, batch, prompt, 1, "cpu")
    x_cpu = cross_source(cfg, batch, 1, "cpu")
    x_gpu = None if x_cpu is None else x_cpu.cuda()
    max_err, checked, flips, worst_gap = 0.0, 0, 0, None
    t0 = time.perf_counter()
    with torch.inference_mode():
        lc, cc = T.prefill_step(cfg, p_cpu, tokens, max_seq=prompt + steps,
                                cross_src=x_cpu)
        lg, cg = T.prefill_step(cfg, p_gpu, tokens.cuda(),
                                max_seq=prompt + steps, cross_src=x_gpu)
        for i in range(steps + 1):
            lg_h = lg.cpu()
            max_err = max(max_err, float((lg_h - lc).abs().max()))
            top2 = lc.topk(2, dim=-1).values
            gap = top2[:, 0] - top2[:, 1]
            clear = gap > 2e-3
            checked += int(clear.sum())
            flips += int((lg_h.argmax(-1) != lc.argmax(-1))[clear].sum())
            worst_gap = float(gap.min()) if worst_gap is None else \
                min(worst_gap, float(gap.min()))
            if i == steps:
                break
            nxt = lc.argmax(-1)[:, None]          # the CPU run's tokens
            lc, cc = T.decode_step(cfg, p_cpu, cc, nxt, prompt + i)
            lg, cg = T.decode_step(cfg, p_gpu, cg, nxt.cuda(), prompt + i)
    rel = _prefill_then_decode(torch, _no_drop(cfg), p_gpu, tokens.cuda(),
                               x_gpu)
    out = dict(batch=batch, prompt_len=prompt, decode_steps=steps,
               layers=cfg.num_layers, reduced=reduced,
               prefill_then_decode_rel_l2=rel,
               matmul_precision=torch.get_float32_matmul_precision(),
               matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
               init_s=init_s, run_s=time.perf_counter() - t0,
               max_abs_err=max_err, argmax_checked=checked,
               argmax_flips=flips, min_top2_gap=worst_gap)
    emit(f"serving:{arch}:fp32", **out)
    require(max_err <= 1e-3, f"serving fp32 {arch}: logits differ {out}")
    require(flips == 0, f"serving fp32 {arch}: argmax differs {out}")
    require(rel <= 1e-3, f"serving fp32 {arch}: prefill-then-decode {out}")
    return p_gpu


def phase_serving_chunked(torch, params32, params) -> None:
    """Layer 0's q, k, v (GQA repeated) of a CHUNK_LOAD forward, above the
    forward's 2,048-token threshold: ``chunked_attention`` against
    ``attention_core`` in float32 on the card, within 1e-4; then the bf16
    forward at that length (its attention goes chunked) is finite."""
    from repro_torch.launch.serve import prompt_tokens
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg32, _ = _serve_cfg("float32")
    cfg, _ = _serve_cfg()
    batch, seq = CHUNK_LOAD
    tokens = prompt_tokens(cfg, batch, seq, 2, "cuda")
    lp = T._layer(params32["blocks"][0][0], 0, 0)
    with torch.inference_mode():
        x = L.embed(params32["embed"], tokens, scale=cfg32.embed_scale)
        h = T._norm(lp["ln1"], x, cfg32)
        q, k, v = L._qkv(lp["attn"], h, n_heads=cfg32.num_heads,
                         n_kv=cfg32.num_kv_heads, head_dim=cfg32.hd,
                         qkv_bias=cfg32.qkv_bias)
        pos = torch.arange(seq, device="cuda")
        q = L.rope(q, pos, cfg32.rope_theta)
        k = L._repeat_kv(L.rope(k, pos, cfg32.rope_theta), cfg32.num_heads)
        v = L._repeat_kv(v, cfg32.num_heads)
        dense = L.attention_core(q, k, v, causal=True)
        chunked = L.chunked_attention(q, k, v, causal=True)
        err = float((dense - chunked).abs().max())
        dense_ms = time_ms(torch, lambda: L.attention_core(
            q, k, v, causal=True), iters=5, warmup=1)
        chunked_ms = time_ms(torch, lambda: L.chunked_attention(
            q, k, v, causal=True), iters=5, warmup=1)
        t0 = time.perf_counter()
        hidden = T.forward(cfg, params, tokens)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    out = dict(batch=batch, seq=seq, heads=cfg32.num_heads,
               max_abs_err=err, attention_core_ms=dense_ms,
               chunked_attention_ms=chunked_ms, bf16_forward_s=fwd_s,
               forward_finite=bool(torch.isfinite(hidden).all()))
    emit("serving:chunked", **out)
    require(err <= 1e-4, f"serving:chunked: {out}")
    require(out["forward_finite"] and
            tuple(hidden.shape) == (batch, seq, cfg.d_model),
            f"serving:chunked: forward {out}")


def phase_serving_rag(torch, cfg, params) -> None:
    """``examples/rag_serving_torch.py`` with qwen2-0.5b at full width: the
    512 documents' 896-d embeddings, the navis index built on the card,
    a wave of RAG_QUERIES embedded queries through ``search_many`` (a
    second wave timed warm).  Ids valid and unique per query, distances
    ascending and within 1e-3 relative of the exact L2; recall@5 against
    brute force over the 512 embeddings printed."""
    import importlib.util
    from repro_torch import random as jr
    from repro_torch.core import brute_force_topk, recall_at_k
    spec = importlib.util.spec_from_file_location(
        "rag_serving_torch", ROOT / "examples" / "rag_serving_torch.py")
    rag = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rag)
    key = jr.PRNGKey(0)
    t0 = time.perf_counter()
    docs = rag.embed_queries(cfg, params,
                             rag.document_tokens(cfg, key, "cuda"))
    torch.cuda.synchronize()
    embed_docs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng, state = rag.build_index(docs, key, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qs = rag.embed_queries(cfg, params,
                           [rag.query_tokens(cfg, key, RAG_QUERIES, "cuda")])
    torch.cuda.synchronize()
    embed_q_s = time.perf_counter() - t0
    waves = []
    for _ in range(2):
        t0 = time.perf_counter()
        ids, dists, stats, state = eng.search_many(state, qs)
        torch.cuda.synchronize()
        waves.append(time.perf_counter() - t0)
    n = docs.shape[0]
    top = rag.TOP
    held = ids >= 0
    srt = torch.sort(ids, dim=1).values
    exact = ((docs[ids.clamp(min=0).long()].double() -
              qs[:, None].double()) ** 2).sum(-1)
    rel = ((dists.double() - exact).abs() / exact.clamp(min=1e-12))[held]
    truth = brute_force_topk(qs, docs, n, top)
    out = dict(arch=SERVE_ARCH, dim=int(docs.shape[1]), docs=n,
               queries=RAG_QUERIES, embed_docs_s=embed_docs_s,
               build_s=build_s, embed_queries_s=embed_q_s,
               wave_s=waves, queries_s=[RAG_QUERIES / w for w in waves],
               reads_per_query=float(stats.read_requests.double().mean()),
               recall_at_5=recall_at_k(ids[:, :top], truth),
               ids_valid=bool(held.all() & (ids < n).all()),
               ids_unique=bool((srt[:, 1:] != srt[:, :-1]).all()),
               dists_ascending=bool((dists[:, 1:] >= dists[:, :-1]).all()),
               max_rel_err_to_exact_l2=float(rel.max()))
    emit("serving:rag", **out)
    require(tuple(docs.shape) == (512, 896) and
            bool(torch.isfinite(docs).all()), "serving:rag: embeddings")
    require(out["ids_valid"] and out["ids_unique"] and
            out["dists_ascending"] and out["max_rel_err_to_exact_l2"] <= 1e-3,
            f"serving:rag: {out}")


# ---------------------------------------------------------------------------
# the training path: the train step, the launcher and its checkpoints
# ---------------------------------------------------------------------------

def train_path(torch, paths: Paths) -> dict:
    """The LM's training path (its counts read as ``train``): qwen2-0.5b at
    TRAIN_LOADS, TRAIN_MODELS, the launcher's crash and resume, and the
    float32 checks against the host."""
    paths.start("train")
    for load in TRAIN_LOADS:
        phase_train(torch, TRAIN_ARCH, load)
    for arch, layers, load in TRAIN_MODELS:
        phase_train(torch, arch, load, layers)
    phase_train_launcher(torch)
    for arch in TRAIN_FP32:
        phase_train_fp32(torch, arch)
    phase_scan_backward_fp64(torch)
    return paths.end("train")


# ---------------------------------------------------------------------------
# the mesh path: the expert-parallel MoE through a one-rank NCCL mesh, and
# the dry-run's memory model
# ---------------------------------------------------------------------------

def mesh_path(torch, paths: Paths, sweep=None) -> dict:
    """``launch/mesh.py`` on the card: MESH_ARCH served through a 1 x 1
    mesh on a one-rank NCCL group, then the dry-run over every cell (the
    counts read as ``mesh``; ``sweep`` is its subprocess if already
    started); then MESH_ARCH trained through the same mesh (read as
    ``mesh_train``); then the dense models served and trained through it
    (read as ``mesh_dense``).  The group is torn down after."""
    if sweep is None:
        sweep = _start_dryrun()
    try:
        _init_group(torch, "mesh")
    except BaseException:
        _stop(sweep)
        raise
    try:
        paths.start("mesh")
        phase_mesh_serve(torch)
        phase_mesh_dryrun(torch, sweep)
        out = {"mesh": paths.end("mesh")}
        paths.start("mesh_train")
        phase_mesh_train(torch)
        out["mesh_train"] = paths.end("mesh_train")
        paths.start("mesh_dense")
        phase_mesh_dense(torch)
        out["mesh_dense"] = paths.end("mesh_dense")
        return out
    finally:
        _stop(sweep)
        torch.distributed.destroy_process_group()


def _parts(mesh) -> dict:
    """The mesh's collectives since its last reset, by part."""
    return {k: dict(v) for k, v in sorted(mesh.parts.items())}


def _meta(torch, tree):
    """``tree`` with each tensor a meta tensor of its shape and dtype."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: torch.empty_like(t, device="meta")
                    if isinstance(t, torch.Tensor) else t, tree)


def _counted(torch, make_step, *args) -> dict:
    """``launch.step_analysis.analyze`` of ``make_step(mesh)`` on ``args``
    made meta, through a counting 1 x 1 mesh: the collectives it counted
    (the mesh's ``stats`` and ``parts``, as the card's one-rank mesh
    reads its own), and the analysis's FLOPs, bytes and seconds."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch import step_analysis as SA
    counting = M.Mesh({"data": 1, "model": 1}, virtual=True, counting=True)
    t0 = time.perf_counter()
    res = SA.analyze(make_step(counting), *_meta(torch, args), mesh=counting)
    return dict(counting.stats, parts=_parts(counting),
                dot_flops=res["dot_flops"],
                hbm_traffic_bytes=res["hbm_traffic_bytes"],
                n_ops=res["n_ops"], analysis_s=time.perf_counter() - t0)


def _agree(card: dict, counted: dict) -> bool:
    """A step's collectives on the card equal the counting mesh's: call
    for call and byte for byte, in all, by part, and the backward's
    apart."""
    from repro_torch.launch.mesh import STATS
    return card["parts"] == counted["parts"] and all(
        card[k] == counted[k] for k in STATS)


def _mesh_steps(torch, cfg, params, mesh, load) -> dict:
    """One prefill and one decode step at ``load`` through ``mesh``, every
    leaf held as its ``param_specs`` block: the collectives each issues
    (calls and the bytes handed to them, in all and by part, from the
    mesh's own counts), the same steps counted on meta tensors through a
    counting mesh (``counted``), and a profiled decode step with and
    without the mesh (device busy share, launches)."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch.serve import prompt_tokens
    from repro_torch.models import transformer as T
    from repro_torch.train.serve_step import make_decode_step, \
        make_prefill_step
    batch, prompt, gen = load
    rules_p = M.make_rules(mesh, kind="prefill", global_batch=batch,
                           cfg=cfg)
    rules_d = M.make_rules(mesh, kind="decode", global_batch=batch, cfg=cfg)
    held = M.shard_tree(params, T.param_specs(cfg), mesh)
    tokens = prompt_tokens(cfg, batch, prompt, 0, "cuda")
    out = {}
    mesh.reset_stats()
    logits, cache = make_prefill_step(cfg, rules=rules_p, mesh=mesh,
                                      max_seq=prompt + gen)(held, tokens)
    out["prefill"] = dict(mesh.stats, parts=_parts(mesh))
    cur = logits.argmax(-1)[:, None].int()
    decode = make_decode_step(cfg, rules=rules_d, mesh=mesh)
    mesh.reset_stats()
    decode(held, cache, cur, prompt)
    out["decode_step"] = dict(mesh.stats, parts=_parts(mesh))
    out["counted"] = {
        "prefill": _counted(torch, lambda m: make_prefill_step(
            cfg, rules=rules_p, mesh=m, max_seq=prompt + gen), held, tokens),
        "decode_step": _counted(torch, lambda m: make_decode_step(
            cfg, rules=rules_d, mesh=m), held, cache, cur, prompt)}
    out["profile_decode_step_mesh"] = profile_window(
        torch, lambda: decode(held, cache, cur, prompt + 1))
    plain = make_decode_step(cfg)         # a 1 x 1 mesh's cache is whole
    out["profile_decode_step_no_mesh"] = profile_window(
        torch, lambda: plain(params, cache, cur, prompt + 1))
    return out


def _serve_pair(torch, serve, cfg, mesh, kw, gen: int) -> dict:
    """``serve`` with no mesh and through ``mesh``, each after a warm-up
    (2 decode steps): times, the memory each adds to what is live, the
    collectives' counts, and the results (``res``)."""
    runs = {}
    batch, prompt = kw["batch"], kw["prompt_len"]
    for name, m in (("no_mesh", None), ("mesh", mesh)):
        serve(cfg, gen=2, mesh=m, **kw)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        mesh.reset_stats()
        res = serve(cfg, gen=gen, mesh=m, **kw)
        runs[name] = dict(
            res=res, prefill_s=res["prefill_s"],
            prefill_tokens_s=batch * prompt / res["prefill_s"],
            decode_ms_per_step=res["decode_s"] / gen * 1e3,
            serve_peak_bytes=torch.cuda.max_memory_allocated() - live,
            collective_calls=mesh.stats["calls"],
            collective_bytes=mesh.stats["bytes"],
            collective_parts=_parts(mesh))
    return runs


def _same(a, b) -> dict:
    """Greedy tokens equal, final logits bit-equal, and their largest
    difference, of two serves."""
    return dict(tokens_equal=bool(a["tokens"].equal(b["tokens"])),
                logits_bit_equal=bool(a["logits"].equal(b["logits"])),
                logits_max_abs_diff=float(
                    (a["logits"] - b["logits"]).abs().max()))


def phase_mesh_serve(torch) -> None:
    """MESH_ARCH at its published widths and depth (bf16, serving's seed)
    served at MESH_LOAD by ``launch.serve.serve`` with no mesh and through
    ``make_smoke_mesh()`` (prefill in the gather regime, decode in the 2-D
    one, every collective through a one-rank NCCL group).

    A 1 x 1 mesh changes no arithmetic, and the MoE's combine
    (``layers._combine``) adds each token's k expert outputs in a fixed
    order, with no atomics.  Gated: in the default mode, two serves with
    no mesh give equal greedy tokens and bit-equal final logits (the
    mesh's difference from them is printed); under
    ``torch.use_deterministic_algorithms`` (no ``warn_only``: an op with
    no deterministic CUDA version raises) the mesh's serve equals the
    serve with no mesh in the same way; in float32 at MESH_FP32_LAYERS
    layers the logits within MESH_FP32_TOL; and the collectives of a
    prefill and a decode step equal the counting mesh's.  Printed:
    both serves' times, the memory each adds, and the collectives and a
    profile of a prefill and a decode step."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    cfg, reduced = _published(MESH_ARCH)
    params = T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    mesh = M.make_smoke_mesh()
    batch, prompt, gen = MESH_LOAD
    kw = dict(batch=batch, prompt_len=prompt, seed=0, device="cuda",
              params=params)
    runs = _serve_pair(torch, serve, cfg, mesh, kw, gen)
    again = serve(cfg, gen=gen, **kw)
    atomic = dict(mesh_vs_no_mesh=_same(runs["mesh"]["res"],
                                        runs["no_mesh"]["res"]),
                  no_mesh_vs_no_mesh=_same(again, runs["no_mesh"]["res"]))
    with _deterministic(torch):
        ordered = _same(serve(cfg, gen=gen, mesh=mesh, **kw),
                        serve(cfg, gen=gen, **kw))
    steps = _mesh_steps(torch, cfg, params, mesh, MESH_LOAD)
    agree = {k: _agree(steps[k], v) for k, v in steps["counted"].items()}
    sample = runs["mesh"]["res"]["tokens"][0, :8].tolist()
    for r in runs.values():
        del r["res"]
    del params
    torch.cuda.empty_cache()
    fp32 = _mesh_fp32(torch, mesh)
    emit(f"mesh:{MESH_ARCH}", mesh=mesh.shape, backend="nccl",
         layers=cfg.num_layers, reduced=reduced, dtype=str(cfg.dtype),
         batch=batch, prompt_len=prompt, decode_steps=gen, runs=runs,
         bf16_atomic=atomic, bf16_deterministic=ordered, fp32=fp32,
         collectives=steps, counts_agree=agree,
         mesh_adds_bytes=(runs["mesh"]["serve_peak_bytes"] -
                          runs["no_mesh"]["serve_peak_bytes"]),
         sample=sample)
    require(runs["no_mesh"]["collective_calls"] == 0 and
            runs["mesh"]["collective_calls"] > 0 and
            steps["decode_step"]["calls"] > 0,
            f"mesh: collectives {runs} {steps}")
    require(all(agree.values()),
            f"mesh: the card's collectives {steps} against the counting "
            f"mesh's {steps['counted']}")
    same = atomic["no_mesh_vs_no_mesh"]
    require(same["tokens_equal"] and same["logits_bit_equal"],
            f"mesh: two bf16 serves with no mesh differ {same}")
    require(ordered["tokens_equal"] and ordered["logits_bit_equal"],
            f"mesh: deterministic bf16 serves differ {ordered}")
    require(fp32["tokens_equal"] and
            fp32["logits_max_abs_diff"] <= MESH_FP32_TOL,
            f"mesh: float32 serves differ {fp32}")


@contextlib.contextmanager
def _deterministic(torch):
    """``torch.use_deterministic_algorithms(True)`` for the block: an op
    with no deterministic CUDA version raises (cuBLAS's workspace is fixed
    by ``CUBLAS_WORKSPACE_CONFIG``, set in ``main``)."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _mesh_fp32(torch, mesh) -> dict:
    """MESH_ARCH in float32 cut to MESH_FP32_LAYERS layers, served with no
    mesh and through ``mesh``."""
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    cfg, reduced = _published(MESH_ARCH, "float32", MESH_FP32_LAYERS)
    params = T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch, prompt, gen = MESH_LOAD
    kw = dict(batch=batch, prompt_len=prompt, gen=gen, seed=0,
              device="cuda", params=params)
    plain, meshed = serve(cfg, **kw), serve(cfg, mesh=mesh, **kw)
    return dict(layers=cfg.num_layers, reduced=reduced,
                rel_l2=_rel_l2(torch, meshed["logits"], plain["logits"]),
                **_same(meshed, plain))


DRYRUN_OUT = ROOT / "build" / "dryrun"


def _start_dryrun():
    """``python -m repro_torch.launch.dryrun --all --both-meshes`` started
    on the host (meta tensors over virtual counting meshes), to run beside
    the serving, training and mesh paths' work on the card."""
    import os
    import shutil
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--both-meshes", "--out", str(DRYRUN_OUT)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _stop(sweep) -> None:
    """Kill the dry-run's subprocess if it still runs."""
    if sweep.poll() is None:
        sweep.kill()
        sweep.communicate()


def phase_mesh_dryrun(torch, sweep) -> None:
    """The dry-run ``_start_dryrun`` started, waited for: DRYRUN_CELLS
    JSON files, each with a finite, positive memory model total, ``flops``
    and ``bytes_accessed`` above 0 and its collectives (bytes by kind
    summing to their total, calls by kind to those by part, some of
    each); the sweep's own seconds and the cells' analysis seconds, and
    for the MoE and vision cells the per-device GB and FLOPs."""
    t0 = time.perf_counter()
    try:
        stdout, stderr = sweep.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        sweep.kill()
        sweep.communicate()
        raise SmokeFailure("mesh:dryrun: the sweep ran past 600 s")
    waited = time.perf_counter() - t0
    require(sweep.returncode == 0,
            f"mesh:dryrun exited {sweep.returncode}: {stderr[-2000:]}")
    recs = {f.stem: json.loads(f.read_text())
            for f in sorted(DRYRUN_OUT.glob("*.json"))}

    def whole(r) -> bool:
        c = r.get("collectives") or {}
        kinds, calls = c.get("bytes_by_kind", {}), c.get("op_counts", {})
        total = r["memory_model"]["total"]
        return (math.isfinite(total) and total > 0 and
                r.get("flops", 0) > 0 and r.get("bytes_accessed", 0) > 0 and
                kinds.get("total", 0) > 0 and kinds["total"] == sum(
                    v for k, v in kinds.items() if k != "total") and
                sum(calls.values()) == sum(
                    v["calls"] for v in c.get("by_part", {}).values()) > 0)
    bad = [k for k, r in recs.items() if not whole(r)]
    line = [ln for ln in stdout.splitlines() if ln.startswith("sweep:")]
    shown = {k: dict(gb=r["memory_model"]["total"] / 1e9, flops=r["flops"],
                     bytes_accessed=r["bytes_accessed"],
                     collective_bytes=r["collectives"]["bytes_by_kind"][
                         "total"])
             for k, r in recs.items()
             if k.split("__")[0] in ("moonshot-v1-16b-a3b", "arctic-480b",
                                     "llama-3.2-vision-90b")}
    emit("mesh:dryrun", cells=len(recs), waited_s=waited,
         sweep=line[-1] if line else None,
         analysis_s=sum(r.get("analysis_s", 0) for r in recs.values()),
         bad=bad, per_device=shown)
    require(len(recs) == DRYRUN_CELLS and not bad,
            f"mesh:dryrun: {len(recs)} cells, incomplete records {bad}")


def _step_collectives(torch, mesh, loss_fn, params, data) -> dict:
    """The collectives of one forward (the loss) and its backward through
    ``mesh``, from the mesh's counts: the backward's own (``backward_*``:
    the gathers' sum-scatters and the entries' sums) apart from the
    forward collectives its recompute issues again.  No update."""
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    mesh.reset_stats()
    loss = loss_fn(params, data)
    fwd = dict(mesh.stats)
    grads = torch.autograd.grad(loss, leaves)
    del grads, loss
    after = dict(mesh.stats)
    return {
        "forward": {"calls": fwd["calls"], "bytes": fwd["bytes"]},
        "recompute": {
            "calls": after["calls"] - after["backward_calls"] - fwd["calls"],
            "bytes": after["bytes"] - after["backward_bytes"] - fwd["bytes"]},
        "backward": {"calls": after["backward_calls"],
                     "bytes": after["backward_bytes"]}}


def _mesh_train_run(torch, cfg, data, mesh, *, deterministic: bool,
                    profile: bool = False, arch: str = MESH_ARCH) -> dict:
    """MESH_TRAIN_STEPS steps of the train step of ``arch``'s optimizer
    from the seeded init (seed 0), through ``mesh`` (None: no mesh; every
    leaf held as its ``param_specs`` block), under deterministic
    algorithms or not, each step timed on the host clock to a
    synchronise: the losses, step times, peak memory against the static
    bytes (weights, gradients, moments), the run's seconds and its final
    parameters (on the card: 10.5 GB beside the next run's ~54 GB for
    MESH_ARCH).  ``profile``: the collectives of a forward and its
    backward and of a whole step (through the mesh, in all and by part),
    and then a profiled step."""
    from repro_torch import configs as C
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_step import (init_opt_state, make_loss_fn,
                                              make_train_step)
    from repro_torch.tree import tree_leaves
    start = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    out = {}
    mode = _deterministic(torch) if deterministic else contextlib.nullcontext()
    with mode:
        params = T.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        opt = O.make_optimizer(C.get_arch(arch).optimizer,
                               lr=O.cosine_schedule(
                                   3e-4, warmup=1, total=MESH_TRAIN_STEPS))
        state = init_opt_state(cfg, opt, params)
        out["static_bytes"] = sum(
            2 * t.numel() * t.element_size() for t in tree_leaves(params)) \
            + sum(t.numel() * t.element_size() for t in tree_leaves(state))
        kw = {}
        if mesh is not None:
            kw = dict(rules=M.make_rules(mesh, kind="train",
                                         global_batch=MESH_TRAIN_LOAD[0],
                                         cfg=cfg), mesh=mesh)
            params = M.shard_tree(params, T.param_specs(cfg), mesh)
            if profile:
                out["collectives"] = _step_collectives(
                    torch, mesh, make_loss_fn(cfg, **kw), params, data)
                mesh.reset_stats()
        step_fn = make_train_step(cfg, opt, **kw)
        losses, secs = [], []
        for i in range(MESH_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, data, i)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            if i == 0 and "collectives" in out:
                step = {k: mesh.stats[k] for k in ("calls", "bytes")}
                out["collectives"]["step"] = step
                out["collectives"]["step_stats"] = dict(
                    mesh.stats, parts=_parts(mesh))
                out["collectives"]["reduction_and_optimizer"] = {
                    k: step[k] - sum(out["collectives"][p][k] for p in (
                        "forward", "recompute", "backward"))
                    for k in step}
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated() - live
        out["final"] = [t.detach() for t in tree_leaves(params)]
        if profile:
            out["profile"] = profile_window(
                torch, lambda: step_fn(params, state, data,
                                       MESH_TRAIN_STEPS))
    del params, state, step_fn
    torch.cuda.empty_cache()
    step_s = sum(secs[1:]) / len(secs[1:])
    out.update(losses=losses, step_s=secs, step_ms=step_s * 1e3,
               tokens_s=data["tokens"].numel() / step_s,
               seconds=time.perf_counter() - start)
    return out


def _counted_train(torch, cfg, arch: str, data) -> dict:
    """``_counted`` of the train step ``_mesh_train_run`` takes through
    a mesh (``arch``'s optimizer, the train rules of ``data``'s batch),
    from the seeded init's shapes: the counting mesh's collectives."""
    from repro_torch import configs as C
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_step import init_opt_state, make_train_step
    opt = O.make_optimizer(C.get_arch(arch).optimizer, lr=O.cosine_schedule(
        3e-4, warmup=1, total=MESH_TRAIN_STEPS))
    params = T.param_shapes(cfg)
    rules = lambda m: M.make_rules(m, kind="train",
                                   global_batch=data["tokens"].shape[0],
                                   cfg=cfg)
    return _counted(torch, lambda m: make_train_step(
        cfg, opt, rules=rules(m), mesh=m), params,
        init_opt_state(cfg, opt, params), data, 0)


def _runs_differ(torch, a: dict, b: dict) -> dict:
    """Two runs' losses and final parameters: equal bit for bit, and the
    largest difference of a parameter (taken in its dtype, on the card);
    the parameters are then freed."""
    equal = [x.equal(y) for x, y in zip(a["final"], b["final"])]
    diff = max((0.0 if same else float((x - y).abs().max()))
               for same, x, y in zip(equal, a.pop("final"), b.pop("final")))
    torch.cuda.empty_cache()
    return dict(losses_equal=a["losses"] == b["losses"],
                params_bit_equal=all(equal), params_max_abs_diff=diff)


def phase_mesh_train(torch) -> None:
    """MESH_ARCH at its published widths (bf16, AdamW with bf16 moments)
    cut to MESH_TRAIN_LAYERS layers, MESH_TRAIN_STEPS steps on one batch
    of MESH_TRAIN_LOAD through ``make_smoke_mesh()`` (train rules: the
    experts gathered over ``data`` and summed over ``model`` in the
    forward, sum-scattered and their entries summed in the backward; the
    gradients reduced and the global norm summed through the mesh), then
    the same steps with no mesh, each run from the same seeded init and
    freed before the next.  Gated: finite, falling losses; under
    deterministic algorithms the mesh's losses and final parameters
    bit-equal to the run with no mesh (a 1 x 1 mesh changes no
    arithmetic); float32 at MESH_FP32_LAYERS layers through the mesh on
    the card within 1e-5 (loss) and 1e-4 (every gradient leaf, relative
    L2) of no mesh on the host; a step's collectives (in all, by part, the
    backward's apart) equal to the counting mesh's for the same step on
    meta tensors.  Printed: step ms and tokens/s with and
    without the mesh (and with no mesh in the default mode), the
    collectives of a step by part, peak memory against the static bytes,
    a profiled step of each, and whether two runs with no mesh in the
    default mode are bit-equal."""
    from repro_torch.launch import mesh as M
    start = time.perf_counter()
    mesh = M.make_smoke_mesh()
    cfg, reduced = _published(MESH_ARCH, layers=MESH_TRAIN_LAYERS)
    batch, seq = MESH_TRAIN_LOAD
    reduced = reduced + [f"batch x seq: {batch} x {seq} of the train_4k "
                         "cell's 256 x 4,096"]
    data = _train_batch(torch, cfg, batch, seq, 0, "cuda")
    meshed = _mesh_train_run(torch, cfg, data, mesh, deterministic=True,
                             profile=True)
    plain = _mesh_train_run(torch, cfg, data, None, deterministic=True,
                            profile=True)
    ordered = _runs_differ(torch, meshed, plain)
    counted = _counted_train(torch, cfg, MESH_ARCH, data)
    agree = _agree(meshed["collectives"]["step_stats"], counted)
    fp32 = _mesh_train_fp32(torch, mesh)
    emit("mesh:train", arch=MESH_ARCH, mesh=mesh.shape, backend="nccl",
         layers=cfg.num_layers, reduced=reduced, dtype=str(cfg.dtype),
         batch=batch, seq=seq, steps=MESH_TRAIN_STEPS,
         mesh_run=meshed, no_mesh_run=plain,
         deterministic_mesh_vs_no_mesh=ordered, counted=counted,
         counts_agree=agree, fp32=fp32,
         seconds=time.perf_counter() - start)
    losses = meshed["losses"]
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"mesh:train: losses {losses}")
    require(ordered["losses_equal"] and ordered["params_bit_equal"],
            f"mesh:train: the mesh's run differs from no mesh {ordered}")
    require(agree, f"mesh:train: a step's collectives "
            f"{meshed['collectives']['step_stats']} against the counting "
            f"mesh's {counted}")
    require(fp32["loss_rel"] <= 1e-5 and fp32["max_grad_rel_l2"] <= 1e-4,
            f"mesh:train: float32 against the host {fp32}")


def _mesh_train_fp32(torch, mesh, arch: str = MESH_ARCH) -> dict:
    """``arch`` in float32 (matmul precision "highest") cut to
    MESH_FP32_LAYERS layers, TRAIN_FP32_LOAD: the loss and its gradients
    through ``mesh`` on the card (every leaf its ``param_specs`` block)
    against ``mesh=None`` on the host, from the same weights (drawn on
    the card from a seed, copied to the host) and batch."""
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.train.train_step import make_grad_fn
    from repro_torch.tree import tree_leaves, tree_map
    start = time.perf_counter()
    torch.set_float32_matmul_precision("highest")
    cfg, reduced = _published(arch, "float32", MESH_FP32_LAYERS)
    batch, seq = TRAIN_FP32_LOAD
    p_gpu = T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(2), "cuda")
    p_cpu = tree_map(lambda t: t.to("cpu"), p_gpu)
    data = _train_batch(torch, cfg, batch, seq, 2, "cpu")
    t0 = time.perf_counter()
    want, g_cpu = make_grad_fn(cfg)(p_cpu, data)
    host_s = time.perf_counter() - t0
    p_gpu = M.shard_tree(p_gpu, T.param_specs(cfg), mesh)
    rules = M.make_rules(mesh, kind="train", global_batch=batch, cfg=cfg)
    got, g_gpu = make_grad_fn(cfg, rules=rules, mesh=mesh)(
        p_gpu, {k: v.cuda() for k, v in data.items()})
    rels = [_rel_l2(torch, a.cpu(), b) if float(b.norm()) > 0 else
            float(a.abs().max())
            for a, b in zip(tree_leaves(g_gpu), tree_leaves(g_cpu))]
    want, got = float(want), float(got)
    del p_cpu, p_gpu, g_cpu, g_gpu
    torch.cuda.empty_cache()
    return dict(layers=cfg.num_layers, reduced=reduced, batch=batch, seq=seq,
                loss_card=got, loss_host=want,
                loss_rel=abs(got - want) / abs(want), grad_leaves=len(rels),
                max_grad_rel_l2=max(rels), host_s=host_s,
                seconds=time.perf_counter() - start)


def _dense_serve(torch, arch: str, mesh) -> dict:
    """``arch`` at its published widths and depth (bf16, serving's seed)
    served at MESH_LOAD with no mesh and through ``mesh``, every leaf its
    ``param_specs`` block: both serves' times, the memory each adds and
    their collectives (``_serve_pair``); under deterministic algorithms
    the mesh's serve against the serve with no mesh; a prefill and a
    decode step's collectives against the counting mesh's, and a profiled
    decode step with the mesh and without."""
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    cfg, reduced = _published(arch)
    params = T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch, prompt, gen = MESH_LOAD
    kw = dict(batch=batch, prompt_len=prompt, seed=0, device="cuda",
              params=params)
    runs = _serve_pair(torch, serve, cfg, mesh, kw, gen)
    with _deterministic(torch):
        ordered = _same(serve(cfg, gen=gen, mesh=mesh, **kw),
                        serve(cfg, gen=gen, **kw))
    steps = _mesh_steps(torch, cfg, params, mesh, MESH_LOAD)
    for r in runs.values():
        del r["res"]
    del params
    torch.cuda.empty_cache()
    return dict(layers=cfg.num_layers, reduced=reduced, dtype=str(cfg.dtype),
                batch=batch, prompt_len=prompt, decode_steps=gen, runs=runs,
                mesh_adds_bytes=(runs["mesh"]["serve_peak_bytes"] -
                                 runs["no_mesh"]["serve_peak_bytes"]),
                bf16_deterministic=ordered, collectives=steps,
                counts_agree={k: _agree(steps[k], v)
                              for k, v in steps["counted"].items()})


def _dense_serve_fp32(torch, arch: str, mesh) -> dict:
    """``arch`` in float32 (matmul precision "highest") cut to
    MESH_FP32_LAYERS layers: prefill of MESH_LOAD's prompts and
    teacher-forced decode steps (the host's greedy tokens) through
    ``mesh`` on the card against no mesh on the host, from the same
    weights; the largest relative L2 of the logits over the steps."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch.serve import prompt_tokens
    from repro_torch.models import transformer as T
    from repro_torch.train.serve_step import make_decode_step, \
        make_prefill_step
    from repro_torch.tree import tree_map
    torch.set_float32_matmul_precision("highest")
    cfg, reduced = _published(arch, "float32", MESH_FP32_LAYERS)
    batch, prompt, _ = MESH_LOAD
    steps = 4
    p_cpu = T.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    p_gpu = M.shard_tree(tree_map(lambda t: t.to("cuda"), p_cpu),
                         T.param_specs(cfg), mesh)
    rp = M.make_rules(mesh, kind="prefill", global_batch=batch, cfg=cfg)
    rd = M.make_rules(mesh, kind="decode", global_batch=batch, cfg=cfg)
    prefill = make_prefill_step(cfg, rules=rp, mesh=mesh,
                                max_seq=prompt + steps)
    decode = make_decode_step(cfg, rules=rd, mesh=mesh)
    tokens = prompt_tokens(cfg, batch, prompt, 3, "cpu")
    rels = []
    with torch.inference_mode():
        lc, cc = T.prefill_step(cfg, p_cpu, tokens, max_seq=prompt + steps)
        lg, cg = prefill(p_gpu, tokens.cuda())
        for i in range(steps + 1):
            rels.append(_rel_l2(torch, lg.cpu(), lc))
            if i == steps:
                break
            nxt = lc.argmax(-1)[:, None].int()
            lc, cc = T.decode_step(cfg, p_cpu, cc, nxt, prompt + i)
            _, lg, cg = decode(p_gpu, cg, nxt.cuda(), prompt + i)
    del p_gpu
    torch.cuda.empty_cache()
    return dict(layers=cfg.num_layers, reduced=reduced, batch=batch,
                prompt_len=prompt, decode_steps=steps, logits_rel_l2=rels,
                max_rel_l2=max(rels))


def _dense_train(torch, mesh) -> dict:
    """DENSE_TRAIN at its published widths and depth (bf16, its AdamW with
    bf16 moments), MESH_TRAIN_STEPS steps at DENSE_TRAIN_LOAD through
    ``mesh`` and with no mesh under deterministic algorithms
    (``_mesh_train_run``), and a train step's collectives against the
    counting mesh's."""
    cfg, reduced = _published(DENSE_TRAIN)
    batch, seq = DENSE_TRAIN_LOAD
    data = _train_batch(torch, cfg, batch, seq, 0, "cuda")
    meshed = _mesh_train_run(torch, cfg, data, mesh, deterministic=True,
                             profile=True, arch=DENSE_TRAIN)
    plain = _mesh_train_run(torch, cfg, data, None, deterministic=True,
                            profile=True, arch=DENSE_TRAIN)
    ordered = _runs_differ(torch, meshed, plain)
    counted = _counted_train(torch, cfg, DENSE_TRAIN, data)
    return dict(arch=DENSE_TRAIN, layers=cfg.num_layers, reduced=reduced,
                batch=batch, seq=seq, steps=MESH_TRAIN_STEPS,
                mesh_run=meshed, no_mesh_run=plain,
                mesh_adds_bytes=(meshed["peak_mem_bytes"] -
                                 plain["peak_mem_bytes"]),
                deterministic_mesh_vs_no_mesh=ordered, counted=counted,
                counts_agree=_agree(meshed["collectives"]["step_stats"],
                                    counted))


def phase_mesh_dense(torch) -> None:
    """The dense placement through ``make_smoke_mesh()`` on the one-rank
    NCCL group: every leaf held as its ``param_specs`` block and gathered
    on use (FSDP over ``data``; the tensor-parallel attention, MLP, Mamba,
    embedding and logits over ``model``; the residual sequence-parallel
    in prefill and training; decode's caches split over the sequence).
    DENSE_SERVE served (``_dense_serve``), DENSE_TRAIN trained
    (``_dense_train``), and float32 at MESH_FP32_LAYERS layers against the
    host.  Gated: under deterministic algorithms the greedy tokens and
    final logits of each serve, and the losses and final parameters of
    the train runs, bit-equal to no mesh (a 1 x 1 mesh runs the
    arithmetic of no mesh); in float32, serving's logits within
    DENSE_FP32_TOL relative L2 of the host's at every step, the loss
    within 1e-5 and every gradient leaf within 1e-4 relative L2; the
    collectives of a prefill, a decode and a train step, in calls and
    bytes, in all, by part and the backward's apart, equal to the counting
    mesh's for the same steps on meta tensors.  Printed: step and
    decode times with and without the mesh, the memory the mesh adds,
    launches and idle share of a profiled decode step, the phase's
    seconds."""
    from repro_torch.launch import mesh as M
    start = time.perf_counter()
    mesh = M.make_smoke_mesh()
    serves = {arch: _dense_serve(torch, arch, mesh) for arch in DENSE_SERVE}
    train = _dense_train(torch, mesh)
    fp32 = {"serve": {arch: _dense_serve_fp32(torch, arch, mesh)
                      for arch in DENSE_SERVE},
            "train": _mesh_train_fp32(torch, mesh, DENSE_TRAIN)}
    emit("mesh:dense", mesh=mesh.shape, backend="nccl", serve=serves,
         train=train, fp32=fp32, seconds=time.perf_counter() - start)
    for arch, r in serves.items():
        ordered = r["bf16_deterministic"]
        require(ordered["tokens_equal"] and ordered["logits_bit_equal"],
                f"mesh:dense: {arch}'s deterministic serves differ "
                f"{ordered}")
        require(all(r["counts_agree"].values()),
                f"mesh:dense: {arch}'s collectives {r['collectives']} "
                f"against the counting mesh's")
        f = fp32["serve"][arch]
        require(f["max_rel_l2"] <= DENSE_FP32_TOL,
                f"mesh:dense: {arch} float32 serving against the host {f}")
    ordered = train["deterministic_mesh_vs_no_mesh"]
    require(ordered["losses_equal"] and ordered["params_bit_equal"],
            f"mesh:dense: the train runs differ {ordered}")
    require(train["counts_agree"],
            f"mesh:dense: a train step's collectives "
            f"{train['mesh_run']['collectives']} against the counting "
            f"mesh's {train['counted']}")
    losses = train["mesh_run"]["losses"]
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"mesh:dense: losses {losses}")
    f = fp32["train"]
    require(f["loss_rel"] <= 1e-5 and f["max_grad_rel_l2"] <= 1e-4,
            f"mesh:dense: float32 training against the host {f}")


def _train_flops(cfg, params, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 x parameters x the tokens they
    see (whisper's encoder sees the frames), plus the attention's score
    and PV products (4 x head_dim per query-key pair forward, 3x that with
    the backward; causal and windowed layers count only the keys a query
    sees)."""
    from repro_torch.tree import tree_leaves
    n_all = sum(t.numel() for t in tree_leaves(params))
    n_enc = sum(t.numel() for t in tree_leaves(params.get("encoder", {})))
    flops = 6.0 * ((n_all - n_enc) * batch * seq +
                   n_enc * batch * cfg.cross_seq)
    per_pair = 12.0 * batch * cfg.num_heads * cfg.hd
    for pat in cfg.patterns:
        for st in pat.stages:
            n = pat.repeats * st.count
            if st.kind in ("attn", "attn_cross", "hybrid"):
                w = st.window or seq
                flops += n * per_pair * sum(min(t + 1, w)
                                            for t in range(seq))
            if st.kind in ("attn_cross", "cross"):
                flops += n * per_pair * seq * cfg.cross_seq
    flops += cfg.encoder_layers * per_pair * cfg.cross_seq ** 2
    return flops


def _step_dot_flops(torch, cfg, opt, params, opt_state, data) -> dict:
    """One more train step on the card under
    ``torch.utils.flop_counter.FlopCounterMode`` (its dot FLOPs), and
    ``step_analysis.analyze`` of the same step on meta tensors of the same
    shapes (its dot FLOPs and the seconds it took on the host)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import step_analysis as SA
    from repro_torch.train.train_step import make_train_step
    with FlopCounterMode(display=False) as fc:
        make_train_step(cfg, opt)(params, opt_state, data, TRAIN_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meta = SA.analyze(make_train_step(cfg, opt),
                      *_meta(torch, (params, opt_state, data)), TRAIN_STEPS)
    return dict(dot_flops_card=fc.get_total_flops(),
                dot_flops_meta=meta["dot_flops"],
                hbm_traffic_bytes_meta=meta["hbm_traffic_bytes"],
                analysis_s=time.perf_counter() - t0)


def _train_batch(torch, cfg, batch: int, seq: int, seed: int, device):
    """``TokenStream``'s batch 0 (and the cross layers' source from the
    seed for a model that has them)."""
    from repro_torch.data import TokenStream
    from repro_torch.launch.serve import cross_source
    out = TokenStream(vocab_size=cfg.vocab_size, seq_len=seq, batch=batch,
                      seed=seed).make_batch(0, device=device)
    cross = cross_source(cfg, batch, seed, device)
    if cross is not None:
        out["cross_src"] = cross
    return out


def phase_train(torch, arch: str, load, layers=None) -> None:
    """``make_train_step`` for ``arch`` at its published widths (cut to its
    first ``layers`` layers where given; bf16,
    seeded random weights, AdamW with bf16 state and the launcher's cosine
    schedule) at ``load``: TRAIN_STEPS steps on one repeated batch, each
    timed on the host clock to a synchronise, then one profiled step.
    Gates: every loss finite, the last below the first.  Prints the step
    ms (mean of the last 6), tokens/s, the peak memory against the static
    bytes (params, grads, moments), launches a step, the idle share, and
    the bound: the model FLOPs at the bf16 dense peak; and one more step's
    dot FLOPs counted on the card (``FlopCounterMode``), gated equal to
    the step analysis's count on meta tensors, with its share of the bf16
    dense peak at the step time."""
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_step import init_opt_state, make_train_step
    from repro_torch.tree import tree_leaves
    batch, seq = load
    cfg, reduced = _published(arch, layers=layers)
    if (batch, seq) == TRAIN_LOADS[-1] and arch == TRAIN_ARCH:
        reduced = reduced + [f"batch: {batch} of the train_4k cell's 256"]
    start = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    opt = O.make_optimizer(C.get_arch(arch).optimizer, lr=O.cosine_schedule(
        3e-4, warmup=min(20, TRAIN_STEPS // 10 + 1), total=TRAIN_STEPS))
    opt_state = init_opt_state(cfg, opt, params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    static = sum(2 * t.numel() * t.element_size()
                 for t in tree_leaves(params)) + \
        sum(t.numel() * t.element_size() for t in tree_leaves(opt_state))
    step_fn = make_train_step(cfg, opt)
    data = _train_batch(torch, cfg, batch, seq, 0, "cuda")
    losses, secs = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, data, i)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() - live
    counted = _step_dot_flops(torch, cfg, opt, params, opt_state, data)
    t0 = time.perf_counter()
    win = profile_window(torch, lambda: step_fn(params, opt_state, data,
                                                TRAIN_STEPS))
    profile_s = time.perf_counter() - t0
    flops = _train_flops(cfg, params, batch, seq)
    step_s = sum(secs[-6:]) / 6
    out = dict(arch=arch, batch=batch, seq=seq, layers=cfg.num_layers,
               params=sum(t.numel() for t in tree_leaves(params)),
               reduced=reduced, dtype=str(cfg.dtype), init_s=init_s,
               losses=losses, step_s=secs, step_ms=step_s * 1e3,
               tokens_s=batch * seq / step_s, peak_mem_bytes=peak,
               static_bytes=static, model_flops=flops,
               bound_ms=flops / PEAK_BF16_S * 1e3,
               bound_by="operations (989 TFLOP/s bf16 dense)",
               share_of_bound=flops / PEAK_BF16_S / step_s,
               **counted,
               dot_flops_share_of_peak=(counted["dot_flops_card"] /
                                        PEAK_BF16_S / step_s),
               launches_per_step=win["kernel_launches"],
               idle_share=win["idle_share"], profile=win,
               profile_s=profile_s, seconds=time.perf_counter() - start)
    emit(f"train:{arch}:{batch}x{seq}", **out)
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"train {arch} {batch}x{seq}: losses {losses}")
    require(counted["dot_flops_card"] == counted["dot_flops_meta"],
            f"train {arch} {batch}x{seq}: dot FLOPs on the card "
            f"{counted['dot_flops_card']}, on meta tensors "
            f"{counted['dot_flops_meta']}")
    del params, opt_state, step_fn
    torch.cuda.empty_cache()


def _heartbeats(stdout: str) -> dict:
    beats = [json.loads(ln) for ln in stdout.splitlines()
             if ln.startswith("{")]
    return {b["step"]: b["loss"] for b in beats}


def phase_train_launcher(torch) -> None:
    """``python -m repro_torch.launch.train`` with LAUNCHER_ARGS (qwen2-0.5b
    --full, 4 steps of 4 x 512, a checkpoint every 2 steps) as a user runs
    it: crashed at step 3 (exit 42, LATEST at step 1), rerun (resumed from
    step 1, steps 2-3 logged, a final commit at step 3), then 4 steps
    without a crash or checkpoints.  The resumed run's losses equal the
    uninterrupted run's within 1e-3 relative (the card's atomics in the
    embedding backward make bit equality unsafe; the CPU test holds it)."""
    import os
    import shutil
    torch.cuda.empty_cache()
    ck = ROOT / "build" / "train_launcher"
    shutil.rmtree(ck, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def launch(*extra):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train",
             *LAUNCHER_ARGS, *extra], env=env, cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        return res, time.perf_counter() - t0
    try:
        crashed, crash_s = launch("--ckpt", str(ck), "--ckpt-every", "2",
                                  "--crash-at", "3")
        latest_after_crash = (ck / "LATEST").read_text() \
            if (ck / "LATEST").exists() else None
        resumed, resume_s = launch("--ckpt", str(ck), "--ckpt-every", "2")
        latest = (ck / "LATEST").read_text() \
            if (ck / "LATEST").exists() else None
        straight, straight_s = launch()
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    got, want = _heartbeats(resumed.stdout), _heartbeats(straight.stdout)
    rel = max((abs(got[s] - want[s]) / abs(want[s]) for s in got
               if s in want), default=None)
    out = dict(args=list(LAUNCHER_ARGS), crash_rc=crashed.returncode,
               latest_after_crash=latest_after_crash,
               resume_rc=resumed.returncode,
               resumed=("resumed from step 1" in resumed.stdout),
               resumed_steps=sorted(got), latest=latest,
               straight_rc=straight.returncode, losses_resumed=got,
               losses_straight=want, max_rel_loss_diff=rel,
               seconds=[crash_s, resume_s, straight_s])
    emit("train:launcher", **out)
    require(crashed.returncode == 42 and
            latest_after_crash == "step_00000001",
            f"train:launcher: crash run {out} {crashed.stderr[-2000:]}")
    require(resumed.returncode == 0 and out["resumed"] and
            sorted(got) == [2, 3] and latest == "step_00000003",
            f"train:launcher: resumed run {out} {resumed.stderr[-2000:]}")
    require(straight.returncode == 0 and rel is not None and rel <= 1e-3,
            f"train:launcher: resumed against uninterrupted {out} "
            f"{straight.stderr[-2000:]}")


def _loss_and_grads(torch, cfg, params, data):
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = T.lm_loss(cfg, params, data["tokens"],
                     cross_src=data.get("cross_src"))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), grads


def phase_train_fp32(torch, arch: str) -> None:
    """The card against the host in float32 (matmul precision "highest":
    no TF32): ``arch`` at its published widths cut to TRAIN_FP32_LAYERS
    layers, the same seeded weights and batch, ``lm_loss`` within 1e-5
    relative and every gradient leaf within 1e-4 relative L2."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    torch.set_float32_matmul_precision("highest")
    cfg, reduced = _published(arch, "float32", TRAIN_FP32_LAYERS)
    batch, seq = TRAIN_FP32_LOAD
    p_cpu = T.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    p_gpu = tree_map(lambda t: t.to("cuda"), p_cpu)
    data = _train_batch(torch, cfg, batch, seq, 2, "cpu")
    t0 = time.perf_counter()
    want, g_cpu = _loss_and_grads(torch, cfg, p_cpu, data)
    cpu_s = time.perf_counter() - t0
    got, g_gpu = _loss_and_grads(
        torch, cfg, p_gpu, {k: v.cuda() for k, v in data.items()})
    rels = [_rel_l2(torch, a.cpu(), b) if float(b.norm()) > 0 else
            float(a.abs().max()) for a, b in zip(g_gpu, g_cpu)]
    out = dict(arch=arch, batch=batch, seq=seq, layers=cfg.num_layers,
               reduced=reduced, loss_card=got, loss_host=want,
               loss_rel=abs(got - want) / abs(want),
               grad_leaves=len(rels), max_grad_rel_l2=max(rels),
               host_s=cpu_s)
    emit(f"train:{arch}:fp32", **out)
    require(out["loss_rel"] <= 1e-5 and out["max_grad_rel_l2"] <= 1e-4,
            f"train fp32 {arch}: {out}")


def phase_scan_backward_fp64(torch) -> None:
    """The selective scan's backward alone at hymba-1.5b's widths (d_inner
    3,200, N 16) at 2 x 128 tokens: float32 on the card against float64
    on the host, every input's gradient within 1e-4 relative L2."""
    from repro_torch.models import layers as L
    b, s, di, n = 2, 128, 3200, 16
    gen = torch.Generator().manual_seed(3)
    rnd = lambda *sh: torch.randn(sh, generator=gen, dtype=torch.float64)
    inputs = [rnd(b, s, di), L.softplus(rnd(b, s, di) - 1.0), rnd(b, s, n),
              rnd(b, s, n), torch.log(torch.arange(
                  1, n + 1, dtype=torch.float64)).expand(di, n).clone(),
              1.0 + 0.1 * rnd(di)]
    gy, gh = rnd(b, s, di), rnd(b, di, n)

    def grads(dev, dtype):
        xs = [t.to(dev, dtype).requires_grad_() for t in inputs]
        y, h = L.selective_scan(*xs)
        obj = (y * gy.to(dev, dtype)).sum() + (h * gh.to(dev, dtype)).sum()
        return torch.autograd.grad(obj, xs)
    want = grads("cpu", torch.float64)
    got = grads("cuda", torch.float32)
    rels = [_rel_l2(torch, g.cpu(), w) for g, w in zip(got, want)]
    emit("train:scan_backward_fp64", batch=b, seq=s, d_inner=di, d_state=n,
         rel_l2=dict(zip(("xc", "dt", "B", "C", "A_log", "D"), rels)))
    require(max(rels) <= 1e-4, f"train: scan backward against float64 "
            f"{rels}")


def main() -> int:
    import faulthandler
    import os
    faulthandler.dump_traceback_later(STACKS_AFTER_S)
    # cuBLAS gives one result for one input only with a fixed workspace,
    # which torch.use_deterministic_algorithms needs (set before any use)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import ops
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2

    paths = Paths(ops)
    start, path_counts = paths.start, paths.end

    try:
        env = phase_env(torch)
        records = phase_kernels(torch)
        # the search path
        start("search")
        small = phase_small(torch)
        fw_eng, fw_state, fw_qs, fw_vecs, fw_cents = phase_fineweb(torch)
        search = path_counts("search")
        phase_ab(torch, fw_eng, fw_state, fw_qs, fw_vecs)
        # the update path
        start("update")
        phase_small_update(torch, *small)
        fw_updated = phase_fineweb_update(torch, fw_eng, fw_state, fw_cents)
        update = path_counts("update")
        phase_ab_update(torch, fw_eng, fw_state, fw_cents)
        # the presets path
        start("presets")
        BUFFER_SCANS["waves"] = 0
        phase_presets_small(torch, *small)
        phase_presets_reuse(torch, small[0], small[1], small[3])
        (ab_eng, ab_state, ab_qs), buffered = phase_presets_fineweb(
            torch, fw_eng, fw_state, fw_vecs, fw_cents)
        presets = path_counts("presets")
        require(presets["rerank_l2_shared"] == BUFFER_SCANS["waves"],
                f"presets: rerank_l2_shared launched "
                f"{presets['rerank_l2_shared']} times for "
                f"{BUFFER_SCANS['waves']} FreshDiskANN search waves")
        phase_ab(torch, ab_eng, ab_state, ab_qs, fw_vecs,
                 label="ab:presets:search")
        phase_ab_update(torch, ab_eng, ab_state, fw_cents,
                        label="ab:presets:insert", time_casr=False)
        phase_ab_buffer(torch, *buffered)
        # the maintenance path
        start("maintenance")
        phase_maintenance_small(torch, *small)
        ab_maint = phase_maintenance_fineweb(torch, fw_eng, fw_updated,
                                             fw_cents)
        maintenance = path_counts("maintenance")
        phase_ab_maintenance(torch, fw_eng, *ab_maint)
        # the sharded path, its merge gathered through a one-rank NCCL group
        group = _init_group(torch)
        try:
            start("sharded")
            phase_dist_small(torch, group)
            ab_shard = phase_dist_fineweb(torch, group, fw_vecs, fw_cents)
            sharded = path_counts("sharded")
            phase_ab_sharded(torch, group, *ab_shard)
            phase_dist_dryrun(torch)
        finally:
            torch.distributed.destroy_process_group()
        lm = serving_path(torch, paths)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    paths = {"search": search, "update": update, "presets": presets,
             "maintenance": maintenance, "sharded": sharded, **lm}
    for name, rec in records.items():
        rec["launches"] = sum(p[name] for p in paths.values())
        rec["launches_by_path"] = {k: p[name] for k, p in paths.items()}
    faulthandler.cancel_dump_traceback_later()
    emit("smoke", seconds=time.perf_counter() - T_START)
    print(json.dumps({"kernels": list(records.values()), **KERNEL_LINE}))
    print(env["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
