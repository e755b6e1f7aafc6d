#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py [--parent DIR]

`--parent DIR` names an unpacked copy of an earlier tree (for example
`git archive HEAD` of the parent commit, under a directory `.gitignore`
lists): its `join_count` and `scatter_append` wrappers and kernels are
built and timed beside the port's, in turns on the same inputs, and
printed as "parent" (never on any path).  Without it nothing of the
kind runs.

Phases, each of which exits non-zero on any failed check:

1. device  — require CUDA; print the card's name and power limit;
2. build   — compile the four kernels of `src/repro_torch/kernels/csrc/`
             with nvcc into `build/`, one nvcc per source, all at once
             (with --parent, the parent's two as well); ptxas registers
             and spills;
3. kernel  — each CUDA kernel against its plain PyTorch version:
             `join_count` at B=2, L=S=2^19 and on edge cases, among them
             the sample boundaries of its design (S = T-1, T, T+1, 3T+5
             with T = 32,768 sampled keys, S < T, one block and several,
             runs of equal keys across windows, rows of SENTINEL_HI only),
             `scatter_append` at cap=2^19, W=3, k=256 (and k=0), with n
             and k by value (the path's entry) and as device data, at
             n*W not a multiple of 4 words and on an unaligned buffer,
             `filter_mask` at N=2^20, W=3 with 0, 1 and 2 conditions
             (all exactly), `flash_attention` at the LM prefill's two
             shapes (B=4, S=2048, H=16, Hkv=8, hd=256, bf16, window 0
             and 1024), a GQA/MQA sweep (zamba2's 32 / 32 at hd 64 and
             llama4's 40 / 8 at hd 128 among it), ragged S, S=1, one query tile,
             bf16 at hd 32, 64, 128 and fp32 at hd 16, 128 and 256 (bf16
             within one bf16 ulp, 1e-4 + 2**-7 |ref|; fp32 within 2e-3 +
             2e-3 |ref|); whisper-base's prefill shape (B=4, S=416, 8 / 8,
             hd 64, bf16: tensor-core, a tail tile) and the training
             forward's (B=4, S=2048, 12 / 2, hd 128, fp32: CUDA-core);
             each case naming the design it launched
             (tensor_core: TMA + wgmma with P split into two bf16
             halves; cuda_core); at the path's shapes also P as one bf16
             product and the earlier CUDA-core design (margins and device
             time, not on the path); wrapper
             times (CUDA events), device times (CUDA-graph replay of the
             bare launcher), bounds and library times (for `join_count`
             and `scatter_append` each the median of three rounds taken
             in rotation); the gradient of `flash_attention` (its
             autograd Function: the kernel forward, then
             `ops.attention_backward` in torch ops) against autograd of
             the plain version in fp32 at the training shape and at
             gemma3's local layers (B=1, S=2048, 16 / 8, hd 256, window
             1024), its ms beside the forward's; (g) the kernels at the
             per-device shapes of the production meshes' programs
             (traced on `meta` first, once: the paper cell on pod1 and
             pod2 and the chunked gemma3-12b prefill on pod1, which (e)
             and (f) read too): `join_count` at pod1's paper
             probes (B=1, L=2^22 and 2^26, S=2^22; exact) and
             `flash_attention` at the chunked pod1 gemma3-12b prefill's
             (B=2, S=32,768, 16 / 8, hd 256, bf16, window 0 and 1024;
             one ulp, against the plain version in row blocks), each
             timed beside its bound, plain version and library call
             (SDPA; where the GQA call fails, on k and v repeated to
             the query heads, with the error logged);
4. main    — the wizard's query path at 1,400 LUBM-style universities
             (1,013,987 triples): TuningSession.retune() -> apply() ->
             answer(q) for q1..q6, each equal to direct evaluation; the
             join probes must have gone through the kernel; a delta swap
             (remove q1, retune, apply) keeps the other answers exact; the
             views materialized on the device equal the host extents;
             then `join_count` at the shapes this path gave it, and a
             `[host]` line: wrapper and device time of one call and the
             split of its host time (perf_counter_ns over 10,000 calls);
5. verify  — the static verification stack (`repro_torch.analysis`) on
             the live session, in two parts.  After [main]'s delta swap:
             `session.verify(strict=True)` (22 views; every bucket body
             run on `meta` tensors, the joins through `join_count`'s
             shape rule), clean, counting every bucket, DAG node and
             view, with no launch and no host sync.  After [maint], with
             the maintainer bound: the same call, whose `maint/alignment`
             reads each maintained view's device count (one host sync
             each, checked by site); then one view's count planted one
             too high, reported as `maint/alignment` for that view and
             raised under `strict`, and restored (clean again); then the
             gate `python -m repro_torch.analysis --strict` (quickstart
             workload, on the card) as a subprocess, exit 0;
6. sharded — `ShardedBackend` over `make_host_mesh(8)`: eight subject
             shards of [main]'s store and 22 views stacked on the card,
             one program a rewriting with one `join_count` launch a join
             for all shards: a batch of q2..q6 at tier 0 equal to
             [main]'s direct answers (an unknown name -> None), a warm
             batch split into programs, gather and answer sets, its
             device busy share, its host syncs (one in the probe, two a
             member), `corrupt_shard(3)` (exact from the host, DEGRADED,
             quorum held), `restore_shard(3)` (HEALTHY at tier 0),
             `serve_async(sharded=True)` with eight requests; sharding
             seconds (triple table, views), exchanges made and elided,
             launches, peak device memory; the phase under 60 s; then
             `join_count` at the shapes this path gave it;
7. maint   — streaming view maintenance on the same session at full
             scale: TuningSession.ingest() of ten seeded batches (a 1 %
             delete, its re-insertion in quarters, mixed batches) through
             the device insert engine, each batch first rehearsed with
             per-pass timers and a host-sync count and rolled back by the
             maintainer's transactional apply, then applied and timed
             unobserved; every extent equals re-evaluation,
             every device buffer its host mirror, q2..q6 direct
             evaluation; the appends must have gone through
             `scatter_append`; then retune() with the measured costs,
             apply(), one more batch and the same checks; no host
             sync in one `ops.scatter_append` call with host counts nor
             in one `ViewMaintainer._append_rows`; then `scatter_append`
             at the shapes the stream gave it (both entries exact) and
             its `[host]` line, and `join_count` at the stream's shapes
             on the operands it gave, with its sample stride D swept
             from D/4 to 4D (each exact);
8. serve   — the session's serving entry points on the same session
             (22 views; q2..q6): `serve()` with a plain batch plus an
             unknown name (None), a repeat batch that runs no program,
             `invalidate()` then exactly one run; the host split of a
             fresh batch (program run with its results read back against
             the answer sets built from them), its device busy share
             under the profiler, its host syncs by site, one sync in the
             integrity probe; on `serve(maintenance=MaintenanceConfig(
             staleness_budget=0), chaos=FaultInjector())` each rung of
             the degradation ladder once (`device_call` x1 masked,
             x2 to tier 1 with `join_count` launching, `per_query_call`
             to tier 2, `ref_engine_call` to tier 3 stale, a failed
             `maintenance_apply` requeued), tiers 1-2 equal to tier 0's
             answers on the same store, then HEALTHY within three clean
             batches; three mixed batches of 512 triples under
             `submit()` at budget 0 and three on a server of budget 1,024
             (max staleness served within the budget); `retune_online`
             adds q1, removes it (q1 -> None) and adds it back;
             `serve_async` answers eight requests (completed ==
             admitted).  Every answer not flagged stale equals direct
             evaluation on the store it was served from: direct answers
             are evaluated once per store snapshot and name, in worker
             processes while the card serves, and waited for after
             [ckpt]; `join_count` and `scatter_append` launches of the
             phase;
9. ckpt    — `session.save()` under build/ (seconds, bytes),
             `TuningSession.load()` on the card and `apply()`: it launches
             `join_count` and its six answers equal the live session's;
             three more saves leave the newest three steps.  This apply
             and the first one of [main] are split into view
             materialization, triple-table upload, warmup and the rest;
10. lm     — LM serving of gemma3-12b at its published width and depth
             (48 layers) with attn_impl="chunked", bf16 weights from a
             seeded generator: prefill_with_cache of 4 prompts of 2,048
             tokens (every causal self-attention through the
             tensor-core `flash_attention`: 48 launches per prefill), 32 greedy
             decode steps through make_serve_step (no launch), then
             BatchedServer(batch=4, max_new=8).run(16); logits finite,
             tokens in the vocabulary, 8 requests finished.  Before it,
             at the same width and one group (6 layers, fp32): the
             chunked (kernel) forward against the dense forward, and
             teacher-forced decode after a kernel prefill against the
             forward at the continued positions;
11. lm_families — LM serving of the MoE and SSM families at their
             published widths, as [lm] serves gemma3-12b: granite-moe-1b
             (24 layers), zamba2-1.2b (38), rwkv6-3b (32) and
             llama4-maverick (1 of 48 layers: one is 36.7 GB in bf16),
             bf16 weights from seed 0, attn_impl="chunked"; flash_attention
             launches per prefill 24 / 19 / 0 / 1, all tensor-core; 32
             greedy decode steps, 8 BatchedServer requests each; the MoE
             pairs dropped per layer in the prefill and in one decode
             step; the measured prefill of granite-moe and zamba2
             profiled.  Before each, in fp32 at one group: granite-moe
             and zamba2 the kernel forward against the dense one (3e-3)
             and the prefill -> decode handoff (3e-2; MoE at
             capacity_factor = n_experts / top_k), rwkv6 the handoff only,
             llama4 none (fp32 does not fit).  The phase under 150 s;
12. sharded_lm — the logical-axis mesh layer (`distributed/sharding.py`,
             the expert-parallel MoE, the sharded train step, restore
             onto shardings) over make_mesh((2, 4), ("data", "model"))
             stacked on the card, DEFAULT_RULES: (a) granite-moe-1b at
             its published width and depth (24 layers, d 1024, 32 experts
             top-8): one MoE layer in fp32 (4 x 2,048 tokens) EP against
             `_moe_dense` at capacity factor 8.0 (no drop; rtol 2e-4,
             atol 2e-5, tests/test_moe_ep.py's) and, at the config's
             1.25, the stacked computation against the shard_map body run
             one shard at a time, no host sync; a bf16 prefill of 4 x
             2,048 tokens under `axis_ctx` (24 expert-parallel MoE calls,
             24 tensor-core `flash_attention` launches) beside the dense
             path's, pairs dropped per layer on both; (b) 4 fp32 train
             steps through `make_train_step(model, tc, mesh, rules)`,
             remat full (48 CUDA-core launches and 48 EP calls a step),
             the loss finite and falling, every gradient finite, s a
             step, tokens/s and peak GiB; (c) the state after step 2
             saved by `TrainSupervisor` and restored by
             `resume_or_init(shardings=train_state_shardings(...))` onto
             a (4, 2) mesh: every leaf bitwise equal, the next step's
             loss from it equal to the uninterrupted run's (1e-5
             relative); (d) llama4-maverick cut to one layer (as in
             [lm_families]): a bf16 EP prefill of 4 x 2,048 tokens at
             capacity factor 8.0, its shared expert split over the four
             expert shards, the MoE output against `_moe_dense` on the
             same input (2**-6 max |ref| + 2**-7 |ref|).  The phase under
             150 s;
13. lm_encdec — serving of whisper-base at its published width and depth
             (6 encoder + 6 decoder layers), bf16 weights from seed 0,
             attn_impl="chunked" at a chunk of 416: 4 requests of 1,500
             encoder frames and 416 prompt tokens; the encoder alone
             (no launch), prefill_with_cache (6 tensor-core
             `flash_attention` launches, one per decoder self-attention;
             host syncs of the cold one counted), 32 greedy decode steps
             (no launch; 448 positions, whisper's decoder context),
             BatchedServer(4, max_new=8).run(16); before it, in fp32 at
             full width and depth, the kernel forward against the dense
             one (3e-3) and prefill + decode against the forward (3e-2);
14. train  — qwen2-vl-2b at its published width and depth (28 layers),
             an fp32 train state, attn_impl="chunked", remat="full", no
             TF32: 8 steps of 4 x 2,048 tokens from `RDFTokenPipeline`
             over [main]'s session, 56 CUDA-core `flash_attention`
             launches a step (the forward and its recompute), the loss
             finite and falling, every layer's attn/wq gradient nonzero;
             before it, at one layer in fp32, the chunked step's
             gradients against the dense step's (1e-3); then
             `python -m repro_torch.launch.train` on whisper-base as a
             subprocess, 10 steps saving every 5 under build/train_ckpt,
             then 20 steps that resume from step 10.  [lm_encdec] and
             [train] together under 150 s;
15. dryrun — the dry-run tooling (`repro_torch.launch.dryrun`): (a)
             every (architecture x shape) cell, 10 x 4 with long_500k
             skipped where `applicable` says so, traced on `meta` and
             audited (`run_audit`) in 6 spawned processes, one line a
             cell (argument and temp GiB, t_compute, t_memory, bound,
             roofline_fraction, trace s), each per-group corrected
             count equal to the full trace's, the sweep under 240 s;
             (b) the paper cell (3-atom star join over 1e9 triples, 16
             data shards of a 16x16 mesh on one card) on `meta`; (c)
             the dry-run of [lm]'s gemma3-12b prefill (bf16, 4 x 2,048)
             and [train]'s qwen2-vl-2b step (fp32, remat full, 4 x
             2,048) at their own shapes: predicted argument bytes equal
             to the bytes those phases held (qwen2-vl's M-RoPE
             positions, which [train] does not feed, named apart), the
             predicted peak beside `max_memory_allocated` as a ratio,
             and model flops over the peak rate times the measured
             seconds (and, for the fp32 step, over the fp32 CUDA-core
             peak); (d) the paper program on the card at 2^24 triples
             drawn to fit its Statistics (the stacked TT built by sorts
             on the card, held equal to `shard_store_by_subject` at
             2^16): its answer equal to numpy's, `join_count` launches
             counted (> 0), its device ms beside the dry-run's t_memory
             for the same program and TT shapes; (e) the production
             sweep: every cell on pod1 (data 16, model 16) and pod2
             (pod 2, data 16, model 16) as rank 0's program of a fake
             process group of 256 / 512 ranks, and the chunked
             gemma3-12b prefill on pod1 (audited before (g)), through
             `run_audit` in 8 spawned processes: statuses as
             `applicable`, per-device flops, HBM and collective bytes
             > 0 (of them the gathers before reshapes), corrected equal
             to the full trace, the chunked cell's 48
             `flash_attention` calls, under 300 s; (f) the paper cell at
             1e9 triples on pod1 and pod2 per device: 2 of the 6 TT
             indexes read, one all-to-all and one 4-byte all-reduce;
16. report — a `{"kernels": [...]}` line, and as the last line
             `{"ok": true, "device": {...}}`.

Imports nothing of JAX or of the JAX package `repro`.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_UNIVERSITIES = 1400
EXPECTED_TRIPLES = 1_013_987
EXPECTED_ROWS = {"q1": 84_106, "q2": 16_906, "q3": 168_000, "q4": 25_200,
                 "q5": 50_400, "q6": 62_112}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
SENTINEL_HI = 2**31 - 1
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/join_count.cu"
REPLACES = "src/repro/kernels/join_count.py:82"
APPEND_SOURCE = "src/repro_torch/kernels/csrc/scatter_append.cu"
APPEND_REPLACES = "src/repro/kernels/scatter_append.py:69"
FILTER_SOURCE = "src/repro_torch/kernels/csrc/filter_mask.cu"
FILTER_REPLACES = "src/repro/kernels/filter_compact.py:51"
ATTN_SOURCE = "src/repro_torch/kernels/csrc/flash_attn_wgmma.cuh"
ATTN_LAUNCHER = "src/repro_torch/kernels/csrc/flash_attn.cu"
ATTN_REPLACES = "src/repro/kernels/flash_attn.py:98"
BF16_FLOPS_PER_S = 989.4e12  # H100 SXM dense bf16 tensor-core peak (data sheet)
FP32_FLOPS_PER_S = 66.9e12   # H100 SXM fp32 outside the tensor cores (data sheet)
HOST_CALLS = 10_000         # calls a [host] split times each part over
TT_CLASS_ROWS = 1 << 21     # capacity_for(1,013,987, safety=1.5)
BATCH = 512                 # steady-state batch of the maintenance stream
LM_ARCH = "gemma3-12b"
LM_BATCH = 4                # requests
LM_PROMPT = 2048            # prompt tokens per request
LM_CACHE = 2080             # cache positions: the prompt + LM_DECODE
LM_DECODE = 32              # greedy decode steps after the prefill
LM_SERVE_STEPS = 16         # BatchedServer.run steps
LM_SERVE_MAX_NEW = 8        # tokens per BatchedServer request
LM_CHECK_BATCH = 2          # the 6-layer fp32 parity checks
LM_CHECK_DECODE = 8         # teacher-forced steps after the check prefill
# [lm_families]: the MoE and SSM families at their published widths, each
# served as [lm] serves gemma3-12b (the same batch, prompt and steps)
LM_FAMILIES = ("granite-moe-1b-a400m", "zamba2-1.2b", "rwkv6-3b",
               "llama4-maverick-400b-a17b")
# depth cuts: (layers served, why, published layers)
LM_FAMILY_LAYERS = {
    "llama4-maverick-400b-a17b": (
        1, "one layer at published width is 18,365,163,520 parameters "
           "(128 experts of d_ff 8192 at d 5120, embedding and head of a "
           "202,048 vocabulary), 36.7 GB in bf16; two would not fit 80 GB",
        48)}
# the families that skip lm_checks' fp32 checks at one group, with why
LM_FAMILY_NO_CHECK = {
    "llama4-maverick-400b-a17b": "one layer in fp32 is 73.5 GB of weights "
                                 "before its logits, more than the card "
                                 "holds beside them; granite-moe runs the "
                                 "MoE checks in fp32"}
LM_FAMILY_PROFILED = ("granite-moe-1b-a400m", "zamba2-1.2b")
LM_FAMILIES_LIMIT_S = 150.0  # the [lm_families] phase's time limit
# [lm_encdec]: whisper-base served at its published width and depth
ENCDEC_ARCH = "whisper-base"
ENCDEC_FRAMES = 1500        # encoder frames a request: one 30 s window
ENCDEC_PROMPT = 416         # prompt tokens; attn_chunk too (S % chunk == 0)
ENCDEC_DECODE = 32          # greedy decode steps after the prefill
ENCDEC_CACHE = 448          # prompt + decode: whisper's decoder context
# [train]: qwen2-vl-2b trained at its published width and depth, then the
# train CLI on whisper-base
TRAIN_ARCH = "qwen2-vl-2b"
TRAIN_BATCH = 4
TRAIN_SEQ = 2048
TRAIN_STEPS = 8
TRAIN_CHECK_BATCH = 1       # the one-group chunked-vs-dense gradient check
# the attention gradient at gemma3's local layers: (B, S, H, Hkv, hd, window)
GEMMA_LOCAL_GRAD = (1, 2048, 16, 8, 256, 1024)
TRAIN_CKPT = "build/train_ckpt"
TRAIN_CLI = ["--arch", "whisper-base", "--batch", "4", "--seq", "1024",
             "--ckpt", TRAIN_CKPT, "--save-every", "5"]
TRAIN_CLI_STEPS = (10, 20)  # the first run, then the resumed one
NEW_PHASES_LIMIT_S = 150.0  # [lm_encdec] and [train] together
SHARDED_ARCH = "granite-moe-1b-a400m"         # [sharded_lm] (a)-(c)
SHARDED_SHARED_ARCH = "llama4-maverick-400b-a17b"   # (d): a shared expert
SHARDED_MESH = ((2, 4), ("data", "model"))
SHARDED_RESTORE_MESH = ((4, 2), ("data", "model"))  # (c)'s other shape
SHARDED_BATCH = 4
SHARDED_SEQ = 2048
SHARDED_DROPLESS_CF = 8.0   # tests/test_moe_ep.py's: no pair dropped here
SHARDED_DROPPING_CF = 0.5   # tests/test_torch_moe_ep.py's: pairs drop
SHARDED_TRAIN_STEPS = 4
SHARDED_SAVE_AT = 2         # the step whose state (c) saves and restores
SHARDED_CKPT = "build/sharded_ckpt"
SHARDED_LM_LIMIT_S = 150.0  # the [sharded_lm] phase's time limit
# EP against dense in fp32: tests/test_moe_ep.py:39-40 (rtol, atol)
EP_TOL = (2e-4, 2e-5)
# EP against dense in bf16, (atol in units of max |ref|, rtol): the EP
# path rounds each of the four expert shards' outputs to bf16 before
# their sum (the routed pair's output in its shard plus that shard's
# quarter of the shared expert's down-projection), where the dense path
# rounds the full sum once; four partial roundings of at most 2**-8 of
# a partial each, the partials no larger than the output's range: 2**-6
# of max |ref|, and one bf16 ulp (2**-7) of the entry for the final one
LLAMA_EP_TOL = (2.0 ** -6, 2.0 ** -7)
# the resumed step against the uninterrupted one: the same program on
# bitwise-equal state and batch, where only the order of fp32 atomic
# adds (the MoE combine, the embedding gradient) may differ between two
# runs; that moves a mean over 8,192 token losses by about 1e-6 of it
SHARDED_RESUME_RTOL = 1e-5
# [dryrun]: the dry-run tooling (repro_torch.launch.dryrun) on `meta`
DRYRUN_WORKERS = 6          # processes tracing the sweep's cells
DRYRUN_LIMIT_S = 240.0      # the sweep's time limit
DRYRUN_SLOW = ("rwkv6-3b", "zamba2-1.2b")  # the longest traces, started first
DRYRUN_ART = "build/dryrun_torch"  # the sweep's artifacts
PAPER_DEVICE_TRIPLES = 1 << 24  # the paper program on the card
PAPER_CHECK_TRIPLES = 1 << 16   # paper_tt against shard_store_by_subject
# [dryrun] (e)-(g): the dry-run on the production meshes, one device's
# program (rank 0 of a fake process group of 256 or 512 ranks)
PROD_MESHES = ("pod1", "pod2")
PROD_WORKERS = 8            # processes tracing the production sweep
PROD_LIMIT_S = 300.0        # the production sweep's time limit
PROD_ART = "build/dryrun_torch_pod"  # its artifacts
CHUNKED_CELL = ("gemma3-12b", "prefill_32k", "pod1", "chunked")
ATTN_ROWS = 2048            # query rows a piece of the plain attention at
#                             the per-device shape (its dense form: 137 GB)
# flash_attention against its plain version, as (atol, rtol): fp32 at the
# JAX kernel tests' 2e-3; bf16 at one bf16 ulp (2**-7 relative), since both
# compute in fp32 and round once to bf16 (the JAX tests' 3e-2 is as large
# as a typical output at the path's shapes, so it would hide a lost tile)
ATTN_TOL = {"float32": (2e-3, 2e-3), "bfloat16": (1e-4, 2 ** -7)}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def zero_counts(mods) -> None:
    """Set the launch counts of each kernel module to 0, flash_attn's
    per-design counts included."""
    for mod in mods:
        mod.launches = 0
        if hasattr(mod, "reset_launches"):
            mod.reset_launches()


def join_inputs(rng, B: int, L: int, S: int, key_space: int,
                invalid_frac: float = 0.1):
    """B probe rows (10% invalid = -1) and B ascending build rows with a
    SENTINEL_HI tail, as numpy int32."""
    import numpy as np

    probe = rng.integers(0, key_space, size=(B, L)).astype(np.int32)
    probe[rng.random((B, L)) < invalid_frac] = -1
    build = np.sort(rng.integers(0, key_space, size=(B, S)).astype(np.int32),
                    axis=1)
    for b in range(B):
        n_pad = int(rng.integers(0, max(S // 4, 1)))
        build[b, S - n_pad:] = SENTINEL_HI
    return probe, build


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA
    events around the whole run, after `warm` untimed calls)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device time per call of `fn`: `reps` calls captured in one CUDA
    graph and replayed between CUDA events, so no host enqueue is timed.
    `fn` is a kernel's bare launcher (or a plain version that reads no
    device value on the host)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = cuda_ms(graph.replay, reps=5, warm=1) / reps
    del graph
    return ms


def bound_ms(B: int, L: int, S: int) -> float:
    """Least time for the probe: read B*L probes and B*S build keys, write
    B*L lo and B*L counts (4 bytes each) at the card's memory rate."""
    return B * (12 * L + 4 * S) / HBM_BYTES_PER_S * 1e3


def append_bound_ms(cap: int, w: int) -> float:
    """Least time for the append: each of the cap*W output words is
    written once from one input word (of the buffer outside the appended
    window, of the delta rows inside it), 4 bytes each."""
    return 2 * cap * w * 4 / HBM_BYTES_PER_S * 1e3


def filter_bound_ms(n: int, w: int) -> float:
    """Least time for the mask: read N*W row words, write N mask words
    and one count per 512-row block."""
    return (n * w + n + -(-n // 512)) * 4 / HBM_BYTES_PER_S * 1e3


def ptxas_summary(name: str, label) -> str:
    """Registers and spills of each kernel of `name`'s library, from the
    ptxas report kept beside it; `label` names an entry from ptxas's
    "Compiling entry function" line (None: leave it out)."""
    from repro_torch.kernels import _build

    out, entry = [], None
    for line in _build.ptxas_log(name).splitlines():
        if "Compiling entry function" in line:
            entry = label(line)
        elif entry and "spill" in line:
            out.append(f"{entry}: {line.strip()}")
        elif entry and "Used" in line:
            out[-1] += f", {line.split(':', 1)[1].strip()}"
    return " | ".join(out)


def tc_label(line: str) -> str | None:
    """A tensor-core flash_attention instantiation: its head width and P."""
    import re

    m = re.search(r"flash_attn_tc_kernelILi(\d+)ELb(\d)E", line)
    return (f"hd {m.group(1)} P {'split' if m.group(2) == '1' else 'one'}"
            if m else None)


def kernel_label(line: str) -> str | None:
    """`<name>_kernel`, with its template argument where it has one."""
    import re

    m = re.search(r"\d([a-z_]+_kernel)(?:ILi(\d+)E)?", line)
    if not m:
        return None
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Microseconds per call of `fn` on the host clock: perf_counter_ns
    over `calls` back-to-back calls, after one untimed call, with one
    device synchronize at each end."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter_ns() - t0) / calls / 1e3


def medians(timers: dict, rounds: int = 3) -> dict:
    """Each timer's median over `rounds` rounds, the order of the timers
    rotated from round to round, so that a drift of the host's speed falls
    on all of them alike."""
    import statistics

    keys = list(timers)
    got = {key: [] for key in keys}
    for r in range(rounds):
        for key in keys[r % len(keys):] + keys[:r % len(keys)]:
            got[key].append(timers[key]())
    return {key: statistics.median(v) for key, v in got.items()}


def load_parent(parent: Path):
    """The parent tree's `ops`, `join_count` and `scatter_append` kernel
    modules, imported from `parent/src` while the port's stay loaded: each
    parent module binds the parent's own `_build`, sources and build
    directory.  For timing beside the port's only."""
    import importlib

    src = str((parent / "src").resolve())
    check((parent / "src" / "repro_torch" / "kernels" / "ops.py").is_file(),
          f"--parent {parent}: no src/repro_torch/kernels/ops.py there")

    def ours():
        return [k for k in sys.modules
                if k == "repro_torch" or k.startswith("repro_torch.")]

    mine = {k: sys.modules.pop(k) for k in ours()}
    sys.path.insert(0, src)
    try:
        return tuple(importlib.import_module(f"repro_torch.kernels.{m}")
                     for m in ("ops", "join_count", "scatter_append"))
    finally:
        sys.path.remove(src)
        for k in ours():
            del sys.modules[k]
        sys.modules.update(mine)


def join_host_split(ops, jc, probe, build) -> dict:
    """Microseconds of host time in one `ops.join_count` call at these
    operands, split: the operand checks (the wrapper with its launch
    stubbed), the two outputs (and the scratch, where the kernel samples
    the row), the device check and stream lookup, the C launcher (which
    enqueues the kernel); "other" is the wrapper's rest."""
    import torch

    from repro_torch.kernels import _build

    idx, L = probe.get_device(), probe.shape[-1]
    n_scratch, shape, _ = jc.launch_shape(probe.numel() // L, L,
                                          build.shape[-1], idx)

    def alloc():
        out = torch.empty_like(probe), torch.empty_like(probe)
        if n_scratch:
            probe.new_empty(n_scratch)
        return out

    lo, count = alloc()
    scratch = probe.new_empty(max(n_scratch, 1))
    fn = _build.launcher(jc.NAME, jc._ARGTYPES)
    args = (probe.data_ptr(), build.data_ptr(),
            scratch.data_ptr() if n_scratch else None, lo.data_ptr(),
            count.data_ptr(), shape, torch._C._cuda_getCurrentRawStream(idx))
    real = ops.join_count_cuda
    ops.join_count_cuda = lambda p, b: None
    try:
        checks = host_us(lambda: ops.join_count(probe, build))
    finally:
        ops.join_count_cuda = real
    parts = {"wrapper": host_us(lambda: ops.join_count(probe, build)),
             "checks": checks, "alloc": host_us(alloc),
             "device_and_stream": host_us(lambda: _build.launch(
                 lambda stream: 0, idx)),
             "launch": host_us(lambda: fn(*args))}
    parts["other"] = parts["wrapper"] - sum(
        v for key, v in parts.items() if key != "wrapper")
    return parts


def append_host_split(ops, sa, buf, n: int, rows, k: int) -> dict:
    """Microseconds of host time in one `ops.scatter_append` call with
    host counts, split as `join_host_split` splits a probe."""
    import torch

    from repro_torch.kernels import _build

    idx = buf.get_device()
    out = torch.empty_like(buf)
    fn = _build.launcher(sa.NAME, sa._COUNTS_ARGTYPES,
                         "scatter_append_counts_launch")
    args = (buf.data_ptr(), rows.data_ptr(), out.data_ptr(), buf.shape[0],
            buf.shape[1], rows.shape[0], n, k, idx,
            torch._C._cuda_getCurrentRawStream(idx))
    real = ops.scatter_append_counts_cuda
    ops.scatter_append_counts_cuda = lambda b, r, n_, k_: None
    try:
        checks = host_us(lambda: ops.scatter_append(buf, n, rows, k))
    finally:
        ops.scatter_append_counts_cuda = real
    parts = {"wrapper": host_us(lambda: ops.scatter_append(buf, n, rows, k)),
             "checks": checks, "alloc": host_us(lambda: torch.empty_like(buf)),
             "device_and_stream": host_us(lambda: _build.launch(
                 lambda stream: 0, idx)),
             "launch": host_us(lambda: fn(*args))}
    parts["other"] = parts["wrapper"] - sum(
        v for key, v in parts.items() if key != "wrapper")
    return parts


def count_syncs(fn):
    """Run `fn` with CUDA sync debugging on; returns (result, [file:line
    of each synchronizing call]) — this script's own synchronize calls
    excluded."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = []
    for w in caught:
        if "called a synchronizing CUDA operation" not in str(w.message):
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno, source=w.source)
        elif Path(w.filename).name != Path(__file__).name:
            where.append(f"{Path(w.filename).name}:{w.lineno}")
    return out, where


def profiled(fn, top: int = 8):
    """Run `fn` once under the profiler (CPU and CUDA activity), ending
    in a device synchronize.  Returns (its result, {wall_ms, busy_ms: the
    summed device time of its kernels and copies, events, flash_attn_ms:
    that of the flash_attention kernel, top: the `top` device names by
    summed ms})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    return out, {"wall_ms": wall_ms, "busy_ms": sum(by_name.values()),
                 "events": len(kern),
                 "flash_attn_ms": sum(ms for nm, ms in by_name.items()
                                      if "flash_attn" in nm),
                 "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:top]}


def compare_kernel(ops, ref, probe, build) -> int:
    """Run the kernel and the plain version on the same card tensors;
    return the largest absolute difference (must be 0)."""
    import torch

    lo, cnt = ops.join_count(probe, build)
    torch.cuda.synchronize()
    want_lo, want_cnt = ref.join_count_ref(probe, build)
    torch.cuda.synchronize()
    check(lo.shape == probe.shape and cnt.shape == probe.shape,
          f"join_count returned {tuple(lo.shape)}, {tuple(cnt.shape)} for "
          f"probes {tuple(probe.shape)}")
    return max(int((lo.long() - want_lo.long()).abs().max()),
               int((cnt.long() - want_cnt.long()).abs().max()))


def time_join(ops, ref, jc, probe, build, parent=None, reps: int = 20
              ) -> dict:
    """Wrapper, device, plain and library times of one probe shape (each
    the median of rounds taken in rotation) and its bound; with `parent`
    (its ops, join_count, scatter_append modules) the parent's wrapper and
    device times too."""
    import torch

    B, L, S = probe.numel() // probe.shape[-1], probe.shape[-1], \
        build.shape[-1]
    timers = {
        "ms": lambda: cuda_ms(lambda: ops.join_count(probe, build), reps),
        "plain_ms": lambda: cuda_ms(
            lambda: ref.join_count_ref(probe, build), reps),
        "library_ms": lambda: cuda_ms(lambda: (
            torch.searchsorted(build, probe, side="left", out_int32=True),
            torch.searchsorted(build, probe, side="right", out_int32=True)),
            reps)}
    devices = {"device_ms": lambda: graph_ms(
        lambda: jc.join_count_cuda(probe, build))}
    if parent is not None:
        pops, pjc, _ = parent
        timers["parent_ms"] = lambda: cuda_ms(
            lambda: pops.join_count(probe, build), reps)
        devices["parent_device_ms"] = lambda: graph_ms(
            lambda: pjc.join_count_cuda(probe, build))
    return {**medians(timers), **medians(devices),
            "bound_ms": bound_ms(B, L, S)}


def join_times(t: dict) -> str:
    """One shape's times, as the [kernel] and [shape] lines print them."""
    out = (f"kernel {t['ms']:.4f} ms (device {t['device_ms']:.5f} ms)")
    if "parent_ms" in t:
        out += (f", parent {t['parent_ms']:.4f} ms (device "
                f"{t['parent_device_ms']:.5f} ms, "
                f"{t['parent_device_ms'] / t['device_ms']:.2f}x)")
    return out + (f", plain {t['plain_ms']:.4f} ms, library (searchsorted "
                  f"x2) {t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} "
                  f"ms ({t['bound_ms'] / t['device_ms']:.1%} of it)")


def kernel_phase_join(ops, ref, jc, dev, parent) -> tuple[int, dict]:
    """join_count against its plain version at B=2, L=S=2^19 (key spaces 4
    and 10^6, timed), on edge cases and at the sample boundaries of its
    design.  Returns (max abs err, {label: times})."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    T = jc.MAX_SAMPLES
    cases = [("B2 L=S=2^19 keys 4", 2, 1 << 19, 1 << 19, 4),
             ("B2 L=S=2^19 keys 1e6", 2, 1 << 19, 1 << 19, 10**6),
             ("L=S=1", 1, 1, 1, 4),
             ("L,S not multiples of 256", 3, 1000, 777, 50)]
    # the sample boundaries of the launch plan (jc.plan): S < T, S = T-1,
    # T, T+1 and 3T+5 (a ragged last window); L = 4096 puts 1,024 probes
    # on each of 4 blocks a member, which sample every 4th to 16th key
    # through the pre-pass, L = 700 one block that reads its sample from
    # the row; key space 3 makes runs of equal keys far longer than a
    # window, so they cross sample boundaries
    cases += [(f"boundary S={S} keys {ks} L={L}", 2, L, S, ks)
              for S in (100, T - 1, T, T + 1, 3 * T + 5) for ks in (3, 10**6)
              for L in (4096, 700)]
    max_err, timed = 0, {}
    for label, B, L, S, ks in cases:
        p, b = join_inputs(rng, B, L, S, ks)
        if label.startswith("boundary"):   # half the probes hit the row
            p[:, : L // 2] = b[:, rng.integers(0, S, L // 2)]
        probe = torch.from_numpy(p).to(dev)
        build = torch.from_numpy(b).to(dev)
        err = compare_kernel(ops, ref, probe, build)
        check(err == 0, f"join_count differs from its plain version on "
                        f"{label}: max abs err {err}")
        max_err = max(max_err, err)
        if L >= 1 << 19:
            t = timed[label] = time_join(ops, ref, jc, probe, build, parent)
            log(f"[kernel] {label}: exact; {join_times(t)}")
    log(f"[kernel] join_count at the sample boundaries (T = {T}; S = 100, "
        f"T-1, T, T+1, 3T+5; L = 4096 and 700; key spaces 3 and 10^6): "
        f"exact")
    all_invalid = torch.full((2, 1000), -1, dtype=torch.int32, device=dev)
    ascending = torch.arange(512, dtype=torch.int32, device=dev).repeat(2, 1)
    err = compare_kernel(ops, ref, all_invalid, ascending)
    _lo, cnt = ops.join_count(all_invalid, ascending)
    check(err == 0 and int(cnt.sum()) == 0, "all-invalid probes matched")
    dup_p = torch.full((1, 200), 7, dtype=torch.int32, device=dev)
    for S in (300, 3 * T + 5):      # one run: in one window, across all
        dup_b = torch.full((1, S), 7, dtype=torch.int32, device=dev)
        err = max(err, compare_kernel(ops, ref, dup_p, dup_b))
        lo, cnt = ops.join_count(dup_p, dup_b)
        check(err == 0 and int(lo.max()) == 0 and bool((cnt == S).all()),
              f"duplicate-heavy case, S={S}")
    sentinel = torch.full((2, T + 1), SENTINEL_HI, dtype=torch.int32,
                          device=dev)
    err = max(err, compare_kernel(ops, ref, all_invalid, sentinel),
              compare_kernel(ops, ref, all_invalid[0].contiguous(),
                             sentinel[0].contiguous()))
    check(err == 0, "rows of SENTINEL_HI only, or a 1-D probe")
    log("[kernel] all-invalid, duplicate-heavy (one run of 300 and of "
        f"{3 * T + 5} keys), rows of SENTINEL_HI only, 1-D: exact")
    return max(max_err, err), timed


def append_inputs(rng, cap: int, n: int, dcap: int, w: int, dev):
    """A (cap, W) buffer with n valid rows and a -1 tail, and a (dcap, W)
    delta buffer, as int32 card tensors."""
    import numpy as np
    import torch

    buf = np.full((cap, w), -1, np.int32)
    buf[:n] = rng.integers(0, 1 << 20, (n, w))
    rows = rng.integers(0, 1 << 20, (dcap, w)).astype(np.int32)
    return torch.from_numpy(buf).to(dev), torch.from_numpy(rows).to(dev)


def compare_append(ops, ref, sa, buf, n: int, rows, k: int) -> int:
    """The kernel against the plain version on the same card tensors,
    through both entries (n and k by value, as the path launches it, and
    as the device data [[n, k]]); the input buffer must come back
    untouched.  Returns the max abs error."""
    import torch

    keep = buf.clone()
    got = ops.scatter_append(buf, n, rows, k)
    nk = torch.tensor([[n, k]], dtype=torch.int32, device=buf.device)
    got_nk = sa.scatter_append_cuda(buf, rows, nk)
    torch.cuda.synchronize()
    want = ref.scatter_append_ref(buf, rows, nk)
    torch.cuda.synchronize()
    check(torch.equal(buf, keep), "scatter_append wrote into its input")
    return max(int((got.long() - want.long()).abs().max()),
               int((got_nk.long() - want.long()).abs().max()))


def time_append(ops, ref, sa, buf, n: int, rows, k: int, parent=None,
                reps: int = 20) -> dict:
    """Wrapper, device, plain and one-call library times of one append
    shape (each the median of rounds taken in rotation), and its bound;
    with `parent`, the parent's wrapper and device times too."""
    import torch

    nk = torch.tensor([[n, k]], dtype=torch.int32, device=buf.device)
    idx = torch.arange(n, n + k, device=buf.device)
    delta = rows[:k]
    timers = {
        "ms": lambda: cuda_ms(lambda: ops.scatter_append(buf, n, rows, k),
                              reps),
        "plain_ms": lambda: cuda_ms(
            lambda: ref.scatter_append_ref(buf, rows, nk), reps),
        "library_ms": lambda: cuda_ms(
            lambda: buf.index_copy(0, idx, delta), reps)}
    devices = {"device_ms": lambda: graph_ms(
        lambda: sa.scatter_append_counts_cuda(buf, rows, n, k), reps)}
    if parent is not None:
        pops, _, psa = parent
        timers["parent_ms"] = lambda: cuda_ms(
            lambda: pops.scatter_append(buf, n, rows, k), reps)
        devices["parent_device_ms"] = lambda: graph_ms(
            lambda: psa.scatter_append_cuda(buf, rows, nk), reps)
    return {**medians(timers), **medians(devices),
            "bound_ms": append_bound_ms(buf.shape[0], buf.shape[1])}


def append_times(t: dict) -> str:
    """One shape's (or a sum of shapes') times, as printed."""
    out = f"kernel {t['ms']:.4f} ms (device {t['device_ms']:.5f} ms)"
    if "parent_ms" in t:
        out += (f", parent {t['parent_ms']:.4f} ms (device "
                f"{t['parent_device_ms']:.5f} ms)")
    return out + (f", plain {t['plain_ms']:.4f} ms, library (index_copy) "
                  f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms")


def kernel_phase_append(ops, ref, sa, dev, parent) -> tuple[int, dict]:
    """scatter_append against its plain version at cap=2^19, W=3, k=256
    for n in {0, cap/2, cap-256}, and on edge cases: k=0, n*W not a
    multiple of 4 words, a tail past the last 16-byte vector, a buffer off
    16-byte alignment.  Returns (max abs err, the times of the n=cap/2
    case)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(2)
    cap, w, k = 1 << 19, 3, 256
    max_err, mid = 0, None
    for n in (0, cap // 2, cap - k):
        buf, rows = append_inputs(rng, cap, n, k, w, dev)
        err = compare_append(ops, ref, sa, buf, n, rows, k)
        check(err == 0, f"scatter_append differs from its plain version at "
                        f"cap=2^19 n={n} k={k}: max abs err {err}")
        max_err = max(max_err, err)
        t = time_append(ops, ref, sa, buf, n, rows, k, parent)
        if n == cap // 2:
            mid = t
        log(f"[kernel] scatter_append cap=2^19 W={w} k={k} n={n}: exact; "
            + append_times(t))
    edges = [(4096, 1000, 256, 0, 3),    # k = 0
             (700, 300, 256, 200, 4),
             (700, 301, 256, 200, 3),    # n*W = 903: mid-vector window
             (1025, 5, 16, 13, 3),       # cap*W = 3075: a 3-word tail
             (999, 333, 64, 64, 5),
             ((1 << 19) + 1, 3, 256, 255, 3)]
    for cap_, n, dcap, k_, w_ in edges:
        buf, rows = append_inputs(rng, cap_, n, dcap, w_, dev)
        err = compare_append(ops, ref, sa, buf, n, rows, k_)
        check(err == 0, f"scatter_append differs at cap={cap_} n={n} "
                        f"dcap={dcap} k={k_} W={w_}")
        # the same buffer 4 bytes off 16-byte alignment: the word loop
        off = torch.empty(buf.numel() + 1, dtype=torch.int32, device=dev)[
            1:].view(buf.shape)
        off.copy_(buf)
        err = max(err, compare_append(ops, ref, sa, off, n, rows, k_))
        check(err == 0, f"scatter_append differs on an unaligned buffer at "
                        f"cap={cap_} n={n} k={k_} W={w_}")
    log("[kernel] scatter_append k=0; n*W not a multiple of 4 (cap=700 "
        "n=301, cap=1025 n=5 W=3, cap=999 n=333 W=5, cap=2^19+1 n=3); W=4; "
        "each aligned and 4 bytes off: exact through both entries")
    return max_err, mid


def kernel_phase_filter(ops, ref, fm, dev) -> tuple[int, dict]:
    """filter_mask against its plain version at N=2^20, W=3 with 0, 1
    and 2 conditions.  Returns (max abs err, the times of the
    one-condition case)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(3)
    n, w = 1 << 20, 3
    rows_np = rng.integers(0, 4, (n, w)).astype(np.int32)
    rows_np[rng.random(n) < 0.2, 0] = -1
    rows = torch.from_numpy(rows_np).to(dev)
    max_err, one = 0, None
    for conds in ((), ((1, 2),), ((1, 2), (2, 0))):
        mask, counts = ops.filter_mask(rows, conds)
        torch.cuda.synchronize()
        want_mask, want_counts = ref.filter_mask_ref(rows, conds)
        err = max(int((mask.long() - want_mask.long()).abs().max()),
                  int((counts.long() - want_counts.long()).abs().max()))
        check(err == 0 and int(counts.sum()) == int(mask.sum()),
              f"filter_mask differs from its plain version with conds "
              f"{conds}: max abs err {err}")
        max_err = max(max_err, err)
        t = {"ms": cuda_ms(lambda: ops.filter_mask(rows, conds)),
             "device_ms": graph_ms(lambda: fm.filter_mask_cuda(rows, conds)),
             "plain_ms": cuda_ms(lambda: ref.filter_mask_ref(rows, conds)),
             "bound_ms": filter_bound_ms(n, w)}
        if len(conds) == 1:
            one = t
        log(f"[kernel] filter_mask N=2^20 W={w} {len(conds)} condition(s): "
            f"exact ({int(mask.sum())} rows pass); kernel {t['ms']:.4f} ms "
            f"(device {t['device_ms']:.5f} ms), plain {t['plain_ms']:.4f} "
            f"ms, library — (no one PyTorch call gives the mask and the "
            f"per-block counts), bound {t['bound_ms']:.6f} ms")
    return max_err, one


def mixed_batch(rng, store, size: int, frac_deletes: float = 0.3):
    """`size` triples as `benchmarks/bench_maintenance.py` builds them:
    fresh inserts in the store's id universe, deletes drawn from the live
    table."""
    import numpy as np

    n_del = min(int(size * frac_deletes), len(store.triples))
    n_ins = size - n_del
    tt = store.triples
    subjects = np.unique(tt[:, 0])
    preds = np.unique(tt[:, 1])
    objects = np.unique(tt[:, 2])
    ins = np.stack([rng.choice(subjects, n_ins), rng.choice(preds, n_ins),
                    rng.choice(objects, n_ins)], axis=1).astype(np.int32)
    dels = tt[rng.choice(len(tt), n_del, replace=False)]
    return ins, dels


def check_maintained(session, workload, label: str) -> None:
    """Every view's extent equals its re-evaluation over the current
    store, every device buffer its host mirror, and q2..q6 direct
    evaluation."""
    import numpy as np

    from repro_torch.query import ref_engine as R

    t0 = time.perf_counter()
    ex = session.executor
    m = session.maintainer()
    for vid, view in ex.state.views.items():
        m.check_alignment(vid)
        width = len(view.cq.head)
        want = np.unique(R.evaluate_cq(view.cq, ex.store).rows
                         .reshape(-1, width), axis=0)
        got = np.unique(ex.extents[vid].rows.reshape(-1, width), axis=0)
        check(got.shape == want.shape and bool((got == want).all()),
              f"{label}: view v{vid} differs from its re-evaluation "
              f"({len(got)} vs {len(want)} rows)")
    t_views = time.perf_counter() - t0
    for q in workload[1:]:
        got = session.answer(q.name)
        check(got == ex.answer_group_direct(q.name),
              f"{label}: {q.name} differs from direct evaluation")
    log(f"[maint] {label}: {len(ex.state.views)} extents == re-evaluation "
        f"and device buffers == host mirrors ({t_views:.3f} s); q2..q6 == "
        f"direct ({time.perf_counter() - t0 - t_views:.3f} s)")


SPLITS = ("delta", "delete", "tt_upload", "insert_candidates", "append",
          "costs")


class Rehearsal(Exception):
    """Raised at the end of a rehearsed batch, so the maintainer's
    transactional `apply` rolls the batch back."""


def rehearse(session, ins, dels, shapes: dict) -> dict:
    """Run one batch with every observation on, then roll it back.

    Each pass of `ViewMaintainer._apply` is timed on the host clock, with
    a device synchronize at its end so its device work counts to it; the
    host syncs are counted (CUDA sync debug mode) and the append and join
    shapes recorded into `shapes["append"]` and `shapes["join"]` (the
    first operands of each join shape kept, cloned).  The measured-cost pass runs on a copy of the
    cost model and then raises `Rehearsal`: `apply` restores the executor
    and the maintainer's bookkeeping, which is checked here.  Returns the
    seconds, the split, the sync sites and the launches."""
    import copy

    import torch

    from repro_torch.kernels import join_count as jc
    from repro_torch.kernels import ops
    from repro_torch.kernels import scatter_append as sa
    from repro_torch.maintenance import maintainer as maint_mod
    from repro_torch.rdf.triples import TripleStore

    m = session.maintainer()
    ex = m.executor
    split = dict.fromkeys(SPLITS, 0.0)

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                split[name] += time.perf_counter() - t0
        return run

    real_costs = timed("costs", m._observe_costs)

    def costs_then_roll_back(report):
        saved = m.costs
        m.costs = copy.deepcopy(saved)
        try:
            real_costs(report)
        finally:
            m.costs = saved
        raise Rehearsal

    real_append, real_join = ops.scatter_append, ops.join_count

    def recording(buf, n, rows, k):
        key = (buf.shape[0], rows.shape[0], buf.shape[1], int(k))
        shapes["append"].setdefault(key, [0, int(n)])[0] += 1
        return real_append(buf, n, rows, k)

    def recording_join(probe, build):
        key = (tuple(probe.shape), build.shape[-1])
        if key not in shapes["join"]:
            shapes["join"][key] = [0, probe.clone(), build.clone()]
        shapes["join"][key][0] += 1
        return real_join(probe, build)

    def attempt() -> bool:
        try:
            session.ingest(ins, dels)
        except Rehearsal:
            return True
        return False

    state = (ex.store, ex.tt, dict(ex.extents), dict(ex.device_views),
             dict(m._ext_keys), m.tt_cap)
    real_eff, real_apply = maint_mod.effective_delta, TripleStore.apply_delta
    methods = {"_delete_pass": "delete", "_upload_tt": "tt_upload",
               "_insert_candidates_device": "insert_candidates",
               "_append_rows": "append"}
    la, lj = sa.launches, jc.launches
    maint_mod.effective_delta = timed("delta", real_eff)
    TripleStore.apply_delta = timed("delta", real_apply)
    for attr, name in methods.items():
        setattr(m, attr, timed(name, getattr(m, attr)))
    m._observe_costs = costs_then_roll_back
    ops.scatter_append, ops.join_count = recording, recording_join
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rolled_back, syncs = count_syncs(attempt)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        ops.scatter_append, ops.join_count = real_append, real_join
        maint_mod.effective_delta = real_eff
        TripleStore.apply_delta = real_apply
        for attr in (*methods, "_observe_costs"):
            delattr(m, attr)
    check(rolled_back, "the rehearsed batch was not rolled back")
    store, tt, extents, views, keys, tt_cap = state
    check(ex.store is store and session.store is store and ex.tt is tt
          and m.tt_cap == tt_cap
          and all(a.keys() == b.keys() and all(a[k] is b[k] for k in a)
                  for a, b in ((ex.extents, extents),
                               (ex.device_views, views),
                               (m._ext_keys, keys))),
          "rolling the rehearsed batch back left the state changed")
    return {"seconds": seconds, "split": split, "syncs": syncs,
            "scatter_append": sa.launches - la,
            "join_count": jc.launches - lj}


def commit(session, ins, dels, counted: dict):
    """One `ingest`, unobserved: host seconds between two device
    synchronizes, and the launches of each kernel in `counted` (its
    count set to 0 just before the batch and read just after)."""
    import torch

    for mod in counted.values():
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = session.ingest(ins, dels)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return rep, seconds, {name: mod.launches for name, mod in counted.items()}


def run_batch(session, label: str, ins, dels, counted: dict,
              shapes: dict) -> dict:
    """One batch: rehearsed with the timers and the sync counter on and
    rolled back, then applied unobserved."""
    r = rehearse(session, ins, dels, shapes)
    rep, seconds, launches = commit(session, ins, dels, counted)
    split = r["split"]
    row = {"batch": label, "inserts": len(ins), "deletes": len(dels),
           "eff_inserts": rep.eff_inserts, "eff_deletes": rep.eff_deletes,
           "appended": sum(rep.appended.values()),
           "removed": sum(rep.removed.values()),
           "candidates": rep.delta_candidates,
           "growths": len(rep.extent_growths), "seconds": seconds,
           "rehearsal_seconds": r["seconds"], **split,
           "other": r["seconds"] - sum(split.values()),
           **launches, "syncs": len(r["syncs"]),
           "rehearsal_launches": {k: r[k] for k in ("scatter_append",
                                                    "join_count")}}
    sites: dict[str, int] = {}
    for w in r["syncs"]:
        sites[w] = sites.get(w, 0) + 1
    log(f"[maint] {label}: +{rep.eff_inserts}/-{rep.eff_deletes} effective, "
        f"appended {row['appended']}, removed {row['removed']}, "
        f"{row['candidates']} candidates, {row['growths']} growth(s); "
        f"{seconds:.4f} s unobserved; rehearsed and rolled back "
        f"{r['seconds']:.4f} s = " + ", ".join(f"{k} {split[k]:.4f}"
                                               for k in SPLITS)
        + f", other {row['other']:.4f}; launches " + json.dumps(launches)
        + f" (rehearsal {json.dumps(row['rehearsal_launches'])}); "
        f"{len(r['syncs'])} host syncs "
        + json.dumps(dict(sorted(sites.items(), key=lambda kv: -kv[1])[:6])))
    return row


def maint_phase(session, workload, jc, sa, fm) -> dict:
    """Streaming maintenance on the main path's session at full scale.
    Each batch is rehearsed with every observation on and rolled back,
    then applied unobserved.  Returns the launch counts of the stream
    (the applied batches) and the append shapes it gave the kernel."""
    import numpy as np
    import torch

    from repro_torch.api import MaintenanceConfig

    t0 = time.perf_counter()
    m = session.maintainer(MaintenanceConfig())
    torch.cuda.synchronize()
    ex = session.executor
    tt_bytes = sum(t.numel() * t.element_size() for t in ex.tt.values())
    log(f"[maint] bound the maintainer in {time.perf_counter() - t0:.3f} s: "
        f"engine {m.engine}, TT class {m.tt_cap:,} rows ({tt_bytes / 1e6:.1f}"
        f" MB in six indexes), {len(m.plans.plans)} delta plans over "
        f"{len(m.plans.leaves)} delta leaves, {len(m.plans.oracle_vids)} "
        f"oracle views")
    check(m.engine == "device", f"default config chose the {m.engine} "
                                f"insert engine on the card")
    check(m.tt_cap == TT_CLASS_ROWS, f"TT class {m.tt_cap}, expected "
                                     f"{TT_CLASS_ROWS}")
    for q in workload[1:]:
        check(session.answer(q.name) == ex.answer_group_direct(q.name),
              f"{q.name} differs from direct evaluation over the padded TT")
    log("[maint] q2..q6 exact over the padded TT")

    counted = {"scatter_append": sa, "join_count": jc, "filter_mask": fm}
    shapes: dict[str, dict] = {"append": {}, "join": {}}
    rows: list[dict] = []
    rng = np.random.default_rng(1)
    live = session.store.triples
    held = live[rng.choice(len(live), round(0.01 * len(live)),
                           replace=False)]
    quarters = np.array_split(held, 4)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    rows.append(run_batch(session, "b1 delete 1% (H)", held[:0], held,
                          counted, shapes))
    for i, part in enumerate(quarters):
        cur = session.store.triples
        dels = cur[rng.choice(len(cur), BATCH, replace=False)]
        rows.append(run_batch(session, f"b{i + 2} re-insert H/4", part,
                              dels, counted, shapes))
        if i == 0:
            rec = m.telemetry()["delta_recompiles"]
            check(rec == 0, f"{rec} delta-program recompiles after batch 2")
    for b in range(6, 11):
        ins, dels = mixed_batch(rng, session.store, BATCH)
        rows.append(run_batch(session, f"b{b} mixed {BATCH}", ins, dels,
                              counted, shapes))
    stream = {name: sum(r[name] for r in rows) for name in counted}
    peak = torch.cuda.max_memory_allocated()
    tele = m.telemetry()
    log(f"[maint] stream of 10 batches: launches {json.dumps(stream)}; "
        f"peak device memory {peak / 2**20:.1f} MiB "
        f"({(peak - base_mem) / 2**20:.1f} MiB above the bound state); "
        f"total {sum(r['seconds'] for r in rows):.3f} s unobserved, "
        f"{sum(r['rehearsal_seconds'] for r in rows):.3f} s rehearsed")
    log("[maint] telemetry (rehearsals included) " + json.dumps(tele))
    log("[maint] batches " + json.dumps(rows))
    check(stream["scatter_append"] > 0,
          "the stream launched no scatter_append kernel")
    check(stream["filter_mask"] == 0,
          f"the stream launched filter_mask {stream['filter_mask']} times; "
          f"no path calls it")
    check(tele["delta_recompiles"] == 0,
          f"{tele['delta_recompiles']} delta-program recompiles")
    check(tele["delta_compiles"] == 1,
          f"{tele['delta_compiles']} delta-program compiles")
    check_maintained(session, workload, "after the stream")
    syncs = append_syncs(m)

    # retune against the measured costs, apply, one more batch
    check(len(session.maintenance_costs) > 0
          and session._search_cfg().maint_model is session.maintenance_costs,
          "retune does not see the measured maintenance costs")
    t0 = time.perf_counter()
    rep = session.retune()
    app = session.apply()
    torch.cuda.synchronize()
    log(f"[maint] retune + apply with {len(session.maintenance_costs)} "
        f"measured view costs in {time.perf_counter() - t0:.3f} s: "
        f"{rep.summary()}; {app.summary()}")
    check(session.maintainer() is m and m.executor is session.executor,
          "apply() did not rebind the session's maintainer")
    ins, dels = mixed_batch(rng, session.store, BATCH)
    after = run_batch(session, f"b11 mixed {BATCH} after the rebind", ins,
                      dels, counted, {"append": {}, "join": {}})
    check(after["eff_inserts"] + after["eff_deletes"] > 0,
          "the batch after the rebind changed nothing")
    check_maintained(session, workload, "after the rebind")
    return {"launches": stream, "shapes": shapes, "rows": rows,
            "after": after, "append_syncs": syncs}


def append_syncs(m) -> dict:
    """Host syncs in one `ops.scatter_append` call with host counts and in
    one `ViewMaintainer._append_rows` (16 of a view's own rows appended
    again, then the view put back as it was); both must be 0."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.maintenance.maintainer import MaintenanceReport

    ex, k = m.executor, 16
    vid = next(v for v, p in sorted(ex.device_views.items())
               if k <= len(ex.extents[v].rows) <= p.cap - k)
    rel, prel = ex.extents[vid], ex.device_views[vid]
    n = len(rel.rows)
    rows = torch.from_numpy(rel.rows[:k].copy()).to(prel.data.device)
    torch.cuda.synchronize()
    _, wrapper = count_syncs(lambda: ops.scatter_append(prel.data, n, rows,
                                                        k))
    torch.cuda.synchronize()
    try:
        _, append = count_syncs(lambda: m._append_rows(
            vid, rel.rows[:k].copy(), MaintenanceReport(0, 0, 0, 0)))
        torch.cuda.synchronize()
        check(len(ex.extents[vid].rows) == n + k
              and int(ex.device_views[vid].n) == n + k,
              f"_append_rows of {k} rows to v{vid} did not append them")
    finally:
        ex.extents[vid], ex.device_views[vid] = rel, prel
    m.check_alignment(vid)
    log(f"[syncs] one ops.scatter_append with host counts: {len(wrapper)} "
        f"synchronizing operation(s) {' '.join(wrapper)}; one _append_rows "
        f"of {k} rows to v{vid} (n={n}): {len(append)} {' '.join(append)}")
    check(not wrapper and not append,
          "the append path synchronized the host with the device")
    return {"ops.scatter_append": len(wrapper), "_append_rows": len(append)}


# ----------------------------------------------------------------------
# serving and persistence on the wizard session
# ----------------------------------------------------------------------
SERVE_BUDGETS = (0, 1024)    # staleness budgets of the two streaming runs
SERVE_STREAM = 3             # mixed batches of BATCH triples per budget
ASYNC_REQUESTS = 8           # requests offered to serve_async
DIRECT_WORKERS = 6           # processes that evaluate direct answers

def direct_answer(triples, cqs) -> set:
    """In a worker process: `answer_group_direct` of one name on one store
    snapshot, the union of its members' host reference evaluation."""
    from repro_torch.query import ref_engine as R
    from repro_torch.rdf.triples import TripleStore

    return R.evaluate_ucq(cqs, TripleStore(triples))


class DirectAnswers:
    """Every served answer against direct evaluation, which runs once per
    store snapshot and name in worker processes while the card serves.
    The first answer served for a (snapshot, name) is kept until its
    direct evaluation comes back (`settle`); every later one must equal
    it at once."""

    def __init__(self, pool):
        self.pool = pool
        self.stores: dict[int, object] = {}   # id(store) -> the store
        self.first: dict[tuple, tuple] = {}   # (id, name) -> (label, set, future)
        self.answers = 0

    def check(self, ex, names, out, label: str) -> None:
        token = id(ex.store)
        self.stores[token] = ex.store         # keeps the id unique
        queries = {q.name: q for q in ex.state.queries}
        for name, got in zip(names, out):
            key = (token, name)
            if key in self.first:
                check(got == self.first[key][1],
                      f"{label}: {name} differs from the answer served on "
                      f"the same store by {self.first[key][0]}")
            else:
                cqs = [queries[m] for m in ex.groups[name]]
                self.first[key] = (label, got, self.pool.submit(
                    direct_answer, ex.store.triples, cqs))
            self.answers += 1

    def settle(self) -> dict:
        t0 = time.perf_counter()
        for (_, name), (label, got, fut) in self.first.items():
            check(got == fut.result(),
                  f"{label}: {name} differs from direct evaluation")
        return {"answers": self.answers, "snapshots": len(self.stores),
                "evaluations": len(self.first),
                "wait_s": time.perf_counter() - t0}


def served(srv, names) -> tuple[list, float]:
    """One `answer_batch` between two device synchronizes: (answers, ms)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = srv.answer_batch(names)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def launches_of(counted: dict) -> dict:
    return {name: mod.launches for name, mod in counted.items()}


def since(counted: dict, before: dict) -> dict:
    return {name: mod.launches - before[name]
            for name, mod in counted.items()}


def sync_sites(syncs: list) -> str:
    return json.dumps(dict(sorted({w: syncs.count(w) for w in set(syncs)}
                                  .items(), key=lambda kv: -kv[1])))


def stream_run(srv, session, names, counted, direct, rng) -> dict:
    """`SERVE_STREAM` mixed batches under `submit()`, one served batch
    after each: tier 0, not stale, exact on the store it was computed on,
    the pending triples served within the server's budget."""
    budget = srv.maintainer.cfg.staleness_budget
    before = launches_of(counted)
    rows = []
    for i in range(SERVE_STREAM):
        ins, dels = mixed_batch(rng, session.store, BATCH)
        srv.submit(inserts=ins, deletes=dels)
        out, ms = served(srv, names)
        st = srv.stats
        check(st.last_batch == {"tier": 0, "degraded": False,
                                "stale": False},
              f"budget {budget}: batch {i} served as {st.last_batch}")
        direct.check(srv.executor, names, out, f"budget {budget}, batch {i}")
        rows.append({"ms": ms, "pending": st.backlog_triples})
    st = srv.stats
    check(st.max_staleness_served <= budget,
          f"budget {budget}: {st.max_staleness_served} pending triples "
          f"served")
    launches = since(counted, before)
    batch_ms = " ".join(f"{r['ms']:.2f}" for r in rows)
    log(f"[serve] budget {budget}: {SERVE_STREAM} batches of {BATCH} mixed "
        f"triples, batch ms {batch_ms} "
        f"(pending after each {[r['pending'] for r in rows]}); max "
        f"staleness served {st.max_staleness_served} <= {budget}; "
        f"{st.refreshes} maintenance passes ({st.maintenance_seconds:.3f} s, "
        f"{st.updates_applied} effective triples); launches "
        f"{json.dumps(launches)}")
    return {"budget": budget, "batch_ms": [r["ms"] for r in rows],
            "pending": [r["pending"] for r in rows],
            "max_staleness_served": st.max_staleness_served,
            "refreshes": st.refreshes,
            "maintenance_s": st.maintenance_seconds, "launches": launches}


def serve_phase(session, workload, counted: dict, pool) -> tuple[dict,
                                                                 object]:
    """The session's serving entry points at full scale on the card:
    `serve()` with plain batches, the degradation ladder under injected
    faults, streaming under two staleness budgets, `retune_online`, then
    `serve_async()`.  Every answer not flagged stale is held against
    direct evaluation on the store it was computed on (`DirectAnswers`,
    settled by the caller).  Returns (results, the DirectAnswers)."""
    import numpy as np
    import torch

    from repro_torch.api import MaintenanceConfig
    from repro_torch.serve.chaos import FaultInjector
    from repro_torch.serve.frontend import MeasuredServiceModel

    direct = DirectAnswers(pool)
    names = [q.name for q in session.workload]      # q2..q6 after [delta]
    rng = np.random.default_rng(2)
    seconds: dict[str, float] = {}
    out: dict = {}

    # ---- plain batches -------------------------------------------------
    t_part = time.perf_counter()
    srv = session.serve()
    ex = srv.executor
    batch = names + ["no_such_query"]
    got, first_ms = served(srv, batch)
    check(got[-1] is None and srv.stats.unknown == 1,
          "an unknown name was not answered None")
    direct.check(ex, names, got, "plain batch")
    tier0 = got[:-1]                  # the ladder's reference on this store
    runs = srv.stats.device_runs
    got, cached_ms = served(srv, batch)
    check(srv.stats.device_runs == runs,
          "a repeat batch ran the workload program again")
    direct.check(ex, names, got, "repeat batch")
    t0 = time.perf_counter()
    srv.invalidate()
    torch.cuda.synchronize()
    invalidate_s = time.perf_counter() - t0
    check(ex.workload.runs == 0, "invalidate() kept the old program")
    got, fresh_ms = served(srv, batch)
    check(srv.stats.device_runs == 1,
          f"invalidate() then a batch ran the program "
          f"{srv.stats.device_runs} times, expected 1")
    direct.check(ex, names, got, "batch after invalidate()")
    # a fresh batch (cached results dropped as a maintenance pass drops
    # them, the store unchanged): the program run with its results read
    # back, against the answer sets built from them
    ex.note_maintenance(ex.store)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.answer_workload()
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for name in names:
        ex.answer_group(name)
    sets_ms = (time.perf_counter() - t0) * 1e3
    ex.note_maintenance(ex.store)
    _, prof = profiled(lambda: srv.answer_batch(batch))
    ex.note_maintenance(ex.store)
    torch.cuda.synchronize()
    got, syncs = count_syncs(lambda: srv.answer_batch(batch))
    direct.check(ex, names, got, "sync-counted batch")
    _, probe_syncs = count_syncs(srv._integrity_ok)
    check(len(probe_syncs) == 1,
          f"the integrity probe of {len(ex.device_views)} views made "
          f"{len(probe_syncs)} host syncs, expected 1 (one transfer)")
    seconds["plain"] = time.perf_counter() - t_part
    log(f"[serve] plain batch q2..q6 + an unknown name: unknown -> None; "
        f"first {first_ms:.2f} ms, repeat {cached_ms:.2f} ms (no program "
        f"run), invalidate() {invalidate_s:.3f} s then exactly one run "
        f"({fresh_ms:.2f} ms)")
    log(f"[serve] a fresh batch: program run with its results read back "
        f"{run_ms:.2f} ms, answer sets built from them {sets_ms:.2f} ms; "
        f"profiled, wall {prof['wall_ms']:.3f} ms, device busy "
        f"{prof['busy_ms']:.3f} ms in {prof['events']} device events "
        f"({prof['busy_ms'] / prof['wall_ms']:.2%} busy); host syncs "
        f"{len(syncs)} by site {sync_sites(syncs)}; the integrity probe "
        f"of {len(ex.device_views)} views {len(probe_syncs)}")
    out["plain"] = {"first_ms": first_ms, "repeat_ms": cached_ms,
                    "invalidate_s": invalidate_s, "fresh_ms": fresh_ms,
                    "run_ms": run_ms, "sets_ms": sets_ms,
                    "profiled_wall_ms": prof["wall_ms"],
                    "profiled_busy_ms": prof["busy_ms"],
                    "batch_syncs": len(syncs), "probe_syncs": len(probe_syncs),
                    "views": len(ex.device_views)}

    # ---- the degradation ladder ------------------------------------------
    t_part = time.perf_counter()
    chaos = FaultInjector()
    lsrv = session.serve(maintenance=MaintenanceConfig(staleness_budget=0),
                         chaos=chaos)
    lkg = tier0
    ladder = {}

    def rung(label, arms, tier, health, stale=False, submit=False):
        nonlocal lkg
        if submit:
            ins, dels = mixed_batch(rng, session.store, BATCH)
            lsrv.submit(inserts=ins, deletes=dels)
        else:
            ex.note_maintenance(ex.store)   # the batch runs the program
        for site, count in arms:
            chaos.arm(site, count=count)
        before, injected = launches_of(counted), chaos.injected
        got, ms = served(lsrv, names)
        st = lsrv.stats
        check(st.served_tier in tier and st.health == health
              and st.last_batch["stale"] is stale,
              f"ladder {label}: tier {st.served_tier}, {st.health}, "
              f"{st.last_batch}; expected tier {tier}, {health}, stale "
              f"{stale}")
        if st.served_tier == 3:
            check(got == lkg, f"ladder {label}: not the last-known-good "
                              f"answers")
        else:
            # on this store: the plain batch's tier-0 answers
            for name, a, b in zip(names, got, tier0):
                check(a == b, f"ladder {label}: {name} differs from tier "
                              f"0's answer on the same store")
            lkg = got
            if not stale:
                direct.check(ex, names, got, f"ladder {label}")
        launches = since(counted, before)
        ladder[label] = {"tier": st.served_tier, "health": st.health,
                         "stale": stale, "ms": ms, "launches": launches,
                         "injected": chaos.injected - injected}
        log(f"[serve] ladder {label}: tier {st.served_tier} {st.health}"
            f"{' stale' if stale else ''} in {ms:.2f} ms; "
            f"{chaos.injected - injected} faults injected; launches "
            f"{json.dumps(launches)}")

    rung("device_call x1", [("device_call", 1)], (0,), "HEALTHY")
    rung("device_call x2", [("device_call", 2)], (1,), "DEGRADED")
    joins = sum(b.kind == "join" for b in ex.workload._prog.buckets)
    check(joins == 0
          or ladder["device_call x2"]["launches"]["join_count"] > 0,
          f"tier 1 launched no join_count kernel ({joins} join buckets)")
    rung("+per_query_call", [("device_call", None),
                             ("per_query_call", None)], (2,), "DEGRADED")
    rung("+ref_engine_call", [("ref_engine_call", None)], (3,),
         "STALE_ONLY", stale=True)
    chaos.clear()
    # the breaker may still be open: tier 0 or tier 1 serves, stale
    rung("maintenance_apply", [("maintenance_apply", 1)], (0, 1),
         "DEGRADED", stale=True, submit=True)
    check(lsrv.stats.maintenance_failures == 1
          and lsrv.stream.pending_triples == BATCH,
          f"the failed delta was not requeued: "
          f"{lsrv.stream.pending_triples} pending, "
          f"{lsrv.stats.maintenance_failures} failures")
    recovery = []
    for _ in range(3):
        got, ms = served(lsrv, names)
        recovery.append((ms, lsrv.stats.served_tier, lsrv.stats.health))
        direct.check(ex, names, got, "ladder recovery")
        if lsrv.stats.health == "HEALTHY":
            break
    check(lsrv.stats.health == "HEALTHY"
          and lsrv.stream.pending_triples == 0,
          f"not HEALTHY within three clean batches: {recovery}")
    log(f"[serve] ladder: HEALTHY after {len(recovery)} clean batch(es) "
        f"{json.dumps(recovery)}; stats " + json.dumps(
            {k: getattr(lsrv.stats, k) for k in (
                "fused_failures", "per_query_failures",
                "ref_engine_failures", "maintenance_failures",
                "degraded_answers", "stale_answers", "breaker_opens")}))
    out["ladder"] = dict(ladder, recovery=recovery)
    seconds["ladder"] = time.perf_counter() - t_part

    # ---- streaming under the two budgets, one fresh server each ---------
    t_part = time.perf_counter()
    out["stream"] = []
    for budget in SERVE_BUDGETS:
        bsrv = session.serve(maintenance=MaintenanceConfig(
            staleness_budget=budget))
        out["stream"].append(stream_run(bsrv, session, names, counted,
                                        direct, rng))
    seconds["stream"] = time.perf_counter() - t_part

    # ---- online retunes behind the budget-1024 server -------------------
    t_part = time.perf_counter()
    q1 = workload[0]
    all_names = [q1.name] + names
    t0 = time.perf_counter()
    bsrv.retune_online(add=[q1])
    add_s = time.perf_counter() - t0
    got, _ = served(bsrv, all_names)
    direct.check(ex, all_names, got, "q1 added online")
    t0 = time.perf_counter()
    bsrv.retune_online(remove=[q1.name])
    remove_s = time.perf_counter() - t0
    got, _ = served(bsrv, all_names)
    check(got[0] is None, "q1 still answered after its online removal")
    direct.check(ex, names, got[1:], "q1 removed online")
    # back to the six queries the checkpoint phase saves
    bsrv.retune_online(add=[q1])
    check(bsrv.stats.retunes == 3 and bsrv.stats.health == "HEALTHY",
          f"{bsrv.stats.retunes} online retunes, {bsrv.stats.health}")
    log(f"[serve] retune_online: add q1 {add_s:.3f} s, remove q1 "
        f"{remove_s:.3f} s (q1 -> None), q1 added back")
    out["retune_online_s"] = {"add": add_s, "remove": remove_s}
    seconds["retune_online"] = time.perf_counter() - t_part

    # ---- serve_async: a handful of requests ------------------------------
    t_part = time.perf_counter()
    fe = session.serve_async(service_model=MeasuredServiceModel())
    asrv, batches = fe.server, []
    answer_batch = asrv.answer_batch

    def recorded(batch_names):
        answers = answer_batch(batch_names)
        batches.append((list(batch_names), answers))
        return answers

    asrv.answer_batch = recorded
    for i in range(ASYNC_REQUESTS):
        fe.offer(all_names[i % len(all_names)], t=i * 1e-3)
    fe.flush()
    st = fe.stats
    check(st.offered == ASYNC_REQUESTS and st.completed == st.admitted,
          f"serve_async: offered {st.offered}, admitted {st.admitted}, "
          f"completed {st.completed}")
    for i, (batch_names, answers) in enumerate(batches):
        direct.check(asrv.executor, batch_names, answers, f"async batch {i}")
    check(sum(len(b) for b, _ in batches) == st.completed,
          "the frontend's batches do not hold its completed requests")
    seconds["async"] = time.perf_counter() - t_part
    log(f"[serve] serve_async: offered {st.offered}, admitted "
        f"{st.admitted}, completed {st.completed}, shed {st.shed} in "
        f"{st.batches} batch(es); latency (virtual s charged from card "
        f"wall time) {json.dumps(st.summary()['latency'])}")
    out["async"] = {"offered": st.offered, "admitted": st.admitted,
                    "completed": st.completed, "shed": st.shed,
                    "batches": st.batches}
    out["seconds"] = seconds
    return out, direct


# ----------------------------------------------------------------------
# the subject-sharded engine and backend on the wizard session
# ----------------------------------------------------------------------
SHARDS = 8                   # shards of the [sharded] mesh, all on the card
SHARDED_LIMIT_S = 60.0       # the phase's time limit, host fallback included


def sharded_split(be, names) -> tuple[dict, int]:
    """One warm healthy batch by part, as `ShardedBackend._answer_device`
    runs it: each member's sharded program up to its overflow read, the
    gather of its result, the answer set built from it.  Returns (ms by
    part, members run on the device)."""
    import torch

    from repro_torch.query import distributed as D

    ex = be.executor
    parts = {"program": 0.0, "gather": 0.0, "sets": 0.0}
    members = 0
    for name in names:
        for member in ex.groups[name]:
            if member in ex._oracle_names:
                continue
            members += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rel = be._fn(member)(be._tt, be._views)
            check(not bool(rel.overflow.any()), f"{member} overflowed")
            t1 = time.perf_counter()
            rows = D.gather_result(rel)
            t2 = time.perf_counter()
            _ = {tuple(r) for r in rows.tolist()}
            t3 = time.perf_counter()
            parts["program"] += (t1 - t0) * 1e3
            parts["gather"] += (t2 - t1) * 1e3
            parts["sets"] += (t3 - t2) * 1e3
    return parts, members


def sharded_phase(session, direct: dict, ops, ref, jc, parent) -> dict:
    """`ShardedBackend` over `SHARDS` subject shards on the card, on
    [main]'s session and store: a batch of q2..q6 at tier 0 equal to
    [main]'s direct answers, `corrupt_shard(3)` (exact, DEGRADED, quorum
    held), `restore_shard(3)` (HEALTHY), `serve_async(sharded=True)`;
    the join probes through `join_count`, then that kernel at the shapes
    this path gave it."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.query import distributed as D
    from repro_torch.serve.frontend import MeasuredServiceModel
    from repro_torch.serve.sharded import ShardedBackend

    t_phase = time.perf_counter()
    names = [q.name for q in session.workload]      # q2..q6 after [delta]
    want = [direct[n] for n in names]
    ex = session.executor
    mesh = make_host_mesh(SHARDS)                   # on the card
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts((jc,))

    # sharding, split into the triple table and the views
    shard_s = {"tt": 0.0, "views": 0.0}
    real = {"tt": D.shard_store_by_subject, "views": D.shard_prel_rows}

    def timed(key):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real[key](*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                shard_s[key] += time.perf_counter() - t0
        return run

    D.shard_store_by_subject, D.shard_prel_rows = timed("tt"), timed("views")
    try:
        t0 = time.perf_counter()
        be = ShardedBackend(ex, mesh=mesh)
        torch.cuda.synchronize()
        shard_s["total"] = time.perf_counter() - t0
    finally:
        D.shard_store_by_subject, D.shard_prel_rows = real["tt"], real["views"]
    lens = [len(s) for s in be._shards]
    check(sum(lens) == len(ex.store), f"the shards hold {sum(lens)} triples")
    log(f"[sharded] {SHARDS} shards of {len(ex.store):,} triples on "
        f"{mesh.device} (rows {min(lens):,}..{max(lens):,}, slab "
        f"{be._cap:,}), {len(be._views)} views: sharding "
        + split_text(shard_s))

    # tier 0: the first batch builds each member's program
    got, cold_ms = served(be, names + ["no_such_query"])
    check(got[-1] is None, "an unknown name was not answered None")
    for name, a, b in zip(names, got, want):
        check(a == b, f"[sharded] {name} differs from [main]'s direct "
                      f"answer")
    st = be.stats
    check(st.served_tier == 0 and st.health == "HEALTHY",
          f"tier {st.served_tier}, {st.health}: {st.faults}")
    launches = jc.launches
    check(launches > 0, "the sharded path launched no join_count kernel")
    members = [m for n in names for m in ex.groups[n]]
    oracle = [m for m in members if m in ex._oracle_names]
    fns = [be._fn(m) for m in members if m not in ex._oracle_names]
    moves = {"members": len(members), "oracle": len(oracle),
             "exchanges": sum(f.exchanges for f in fns),
             "elided": sum(f.elided for f in fns)}
    log(f"[sharded] q2..q6 at tier 0 == [main]'s direct answers, first "
        f"batch {cold_ms:.2f} ms (programs built); {launches} join_count "
        f"launches; exchanges across the members " + json.dumps(moves))

    # a warm healthy batch, its split, busy share and host syncs
    got, warm_ms = served(be, names)
    check(got == want, "a warm sharded batch differs from direct answers")
    split, device_members = sharded_split(be, names)
    _, prof = profiled(lambda: be.answer_batch(names))
    torch.cuda.synchronize()
    got, syncs = count_syncs(lambda: be.answer_batch(names))
    check(got == want, "the sync-counted sharded batch differs")
    # the probe's one read, then each member's overflow read and gather
    check(len(syncs) == 1 + 2 * device_members,
          f"a sharded batch made {len(syncs)} host syncs, expected "
          f"{1 + 2 * device_members} (the probe, then two a member)")
    log(f"[sharded] a warm batch {warm_ms:.2f} ms: programs "
        f"{split['program']:.2f} ms, gather {split['gather']:.2f} ms, "
        f"answer sets {split['sets']:.2f} ms over {device_members} members; "
        f"profiled, wall {prof['wall_ms']:.3f} ms, device busy "
        f"{prof['busy_ms']:.3f} ms in {prof['events']} device events "
        f"({prof['busy_ms'] / prof['wall_ms']:.2%} busy); host syncs "
        f"{len(syncs)} by site {sync_sites(syncs)}")
    for nm, ms in prof["top"]:
        log(f"[sharded]   {ms:.4f} ms  {nm[:100]}")

    # one lost shard: exact answers from the host, DEGRADED, quorum held
    be.corrupt_shard(3)
    got, degraded_ms = served(be, names)
    r = be.readiness()
    check(got == want and be.supervisor.health == "DEGRADED"
          and be.stats.served_tier == 2 and r["ready"] and r["quorum"]
          and r["shards"][3] == "DEGRADED"
          and all(h == "HEALTHY" for d, h in r["shards"].items() if d != 3),
          f"corrupt_shard(3): tier {be.stats.served_tier}, {r}")
    be.restore_shard(3)
    got, restored_ms = served(be, names)
    check(got == want and be.supervisor.health == "HEALTHY"
          and be.stats.served_tier == 0,
          f"restore_shard(3): tier {be.stats.served_tier}, "
          f"{be.supervisor.health}")
    log(f"[sharded] corrupt_shard(3): exact at tier 2 (host), DEGRADED, "
        f"quorum held, shard 3 DEGRADED, {degraded_ms:.2f} ms; "
        f"restore_shard(3): HEALTHY at tier 0, {restored_ms:.2f} ms")

    # the async frontend over a fresh sharded backend
    t0 = time.perf_counter()
    fe = session.serve_async(sharded=True, mesh=mesh,
                             service_model=MeasuredServiceModel())
    check(isinstance(fe.server, ShardedBackend) and fe.server.ndev == SHARDS,
          f"serve_async(sharded=True) serves through {type(fe.server)}")
    for i in range(ASYNC_REQUESTS):
        fe.offer(names[i % len(names)], t=i * 1e-3)
    fe.flush()
    async_s = time.perf_counter() - t0
    st = fe.stats
    check(st.offered == ASYNC_REQUESTS and st.completed == st.admitted,
          f"serve_async(sharded=True): offered {st.offered}, admitted "
          f"{st.admitted}, completed {st.completed}")
    check(fe.server.stats.served_tier == 0
          and fe.server.supervisor.health == "HEALTHY",
          f"serve_async(sharded=True) served at tier "
          f"{fe.server.stats.served_tier}, {fe.server.supervisor.health}")
    for name, b in zip(names, want):
        check(fe.server.answer(name) == b,
              f"serve_async(sharded=True): {name} differs")
    log(f"[sharded] serve_async(sharded=True): offered {st.offered}, "
        f"admitted {st.admitted}, completed {st.completed} in "
        f"{st.batches} batch(es), {async_s:.3f} s with its sharding")
    launches = jc.launches
    peak = torch.cuda.max_memory_allocated()
    del fe

    # join_count at the shapes the sharded path gives it
    captured = []
    real_join = ops.join_count

    def recording(probe, build):
        captured.append((probe.clone(), build.clone()))
        return real_join(probe, build)

    ops.join_count = recording
    try:
        be.answer_batch(names)
    finally:
        ops.join_count = real_join
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t_phase
    check(phase_s < SHARDED_LIMIT_S,
          f"[sharded] took {phase_s:.1f} s, limit {SHARDED_LIMIT_S:.0f} s")
    log(f"[sharded] phase {phase_s:.3f} s (under {SHARDED_LIMIT_S:.0f} s); "
        f"join_count launches {launches}; peak device memory "
        f"{peak / 2**20:.1f} MiB")
    totals: dict = {}
    max_err = 0
    for probe, build in captured:
        B, L = probe.shape
        S = build.shape[1]
        err = compare_kernel(ops, ref, probe, build)
        check(err == 0, f"join_count differs at the sharded shape B={B} "
                        f"L={L} S={S}")
        max_err = max(max_err, err)
        t = time_join(ops, ref, jc, probe, build, parent, reps=50)
        for key, v in t.items():
            totals[key] = totals.get(key, 0.0) + v
        log(f"[sharded-shape] B={B} L={L} S={S}: exact; {join_times(t)}")
    if captured:
        log(f"[sharded-shape] join_count over the sharded batch's "
            f"{len(captured)} calls: " + join_times(totals))
    return {"seconds": phase_s, "shard_s": shard_s, "cold_ms": cold_ms,
            "warm_ms": warm_ms, "split_ms": split,
            "device_members": device_members, "moves": moves,
            "profiled_wall_ms": prof["wall_ms"],
            "profiled_busy_ms": prof["busy_ms"], "syncs": len(syncs),
            "degraded_ms": degraded_ms, "restored_ms": restored_ms,
            "async_s": async_s, "launches": launches, "peak_bytes": peak,
            "max_abs_err": max_err,
            "join": dict(totals, calls=len(captured), shapes=[
                [p.shape[0], p.shape[1], b.shape[1]] for p, b in captured])}


GATE_TIMEOUT_S = 120         # the static gate's subprocess


def verify_live(session, counted: dict, label: str) -> dict:
    """`session.verify(strict=True)` on the live executor, timed, then
    once more under the sync counter.  The report must be clean and count
    every bucket of the program, every node of the DAG and every view;
    the analysis executes nothing, so it launches no kernel."""
    import torch

    from repro_torch.errors import InvariantViolation

    ex = session.executor
    prog = ex.workload._program()
    torch.cuda.synchronize()
    zero_counts(counted.values())
    try:
        t0 = time.perf_counter()
        report = session.verify(strict=True)
        seconds = time.perf_counter() - t0
        _, syncs = count_syncs(lambda: session.verify(strict=True))
    except InvariantViolation as e:
        fail(f"[verify] {label}: {e}")
    launched = launches_of(counted)
    log(f"[verify] {label}: {report.summary()} in {seconds:.4f} s; host "
        f"syncs {len(syncs)} {sync_sites(syncs)}; launches "
        f"{json.dumps(launched)}")
    want = {"buckets": prog.n_buckets, "nodes": len(ex.dag.nodes),
            "maint_views": len(ex.state.views)}
    for key, n in want.items():
        check(report.checked.get(key) == n,
              f"[verify] {label}: checked {key}={report.checked.get(key)}, "
              f"expected {n}")
    check(not any(launched.values()),
          f"[verify] {label} launched {json.dumps(launched)}")
    return {"seconds": seconds, "checked": dict(report.checked),
            "syncs": len(syncs), "sync_sites": sorted(set(syncs))}


def verify_phase(session, counted: dict) -> dict:
    """After [maint]: the live verify with the session's maintainer bound
    (`maint/alignment` reads each view's device count), a planted fault
    (one view's count one too high, restored after) reported and raised
    under `strict`, and the gate `python -m repro_torch.analysis
    --strict` (quickstart workload, on the card) as a subprocess."""
    from repro_torch.errors import InvariantViolation

    t_phase = time.perf_counter()
    m = session._maintainer
    ex = session.executor
    check(m is not None and m.executor is ex,
          "[verify] the session's maintainer is not bound to its executor")
    live = verify_live(session, counted, "after [maint], maintainer bound")
    aligned = [vid for vid in ex.device_views
               if vid not in m.plans.oracle_vids]
    check(live["syncs"] == len(aligned)
          and all(s.startswith("maintenance_check.py:")
                  for s in live["sync_sites"]),
          f"[verify] {live['syncs']} host syncs at {live['sync_sites']}, "
          f"expected one per maintained view ({len(aligned)}) in "
          f"maintenance_check.py")

    vid = min(aligned)
    rel = ex.device_views[vid]
    ex.device_views[vid] = rel._replace(n=rel.n + 1)
    try:
        report = session.verify()
        found = [(f.rule, f.location) for f in report.findings]
        try:
            session.verify(strict=True)
            raised = ""
        except InvariantViolation as e:
            raised = str(e)
    finally:
        ex.device_views[vid] = rel
    log(f"[verify] planted fault (view {vid}'s device count + 1): "
        f"{report.summary()}: {found}; strict raised "
        f"{'InvariantViolation' if raised else 'nothing'}")
    check(found == [("maint/alignment", f"view {vid}")],
          f"[verify] the planted fault gave {found}")
    check("maint/alignment" in raised,
          "[verify] verify(strict=True) did not raise on the planted fault")
    healed = verify_live(session, counted, "after the fault was restored")

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    gate = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict"],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=GATE_TIMEOUT_S)
    gate_s = time.perf_counter() - t0
    summary = (gate.stdout.strip().splitlines() or [""])[-1]
    log(f"[verify] gate `python -m repro_torch.analysis --strict` "
        f"(quickstart workload, on the card): exit {gate.returncode} in "
        f"{gate_s:.3f} s: {summary}")
    check(gate.returncode == 0 and summary.startswith("analysis: clean"),
          f"[verify] the gate failed:\n{gate.stdout[-4000:]}\n"
          f"{gate.stderr[-4000:]}")
    return {"live": live, "healed": healed, "fault_view": vid,
            "gate_s": gate_s, "gate": summary,
            "seconds": time.perf_counter() - t_phase}


def split_apply(session):
    """`session.apply()` with its parts timed: view materialization, the
    triple-table upload, the warmup (every bucket body built and run
    once, the results read back) and "other", the rest of it.  Each part
    ends on a device synchronize.  Returns (report, seconds by part)."""
    import torch

    from repro_torch.core import executor as X

    parts = {"materialize": 0.0, "tt_upload": 0.0, "warmup": 0.0}
    slots = {"materialize": (X, "materialize_state"),
             "tt_upload": (X.E, "tt_device_indexes"),
             "warmup": (X.QueryExecutor, "warmup")}
    real = {key: getattr(obj, attr) for key, (obj, attr) in slots.items()}

    def timed(key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return real[key](*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                parts[key] += time.perf_counter() - t0
        return run

    for key, (obj, attr) in slots.items():
        setattr(obj, attr, timed(key))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = session.apply()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for key, (obj, attr) in slots.items():
            setattr(obj, attr, real[key])
    parts["other"] = total - sum(parts.values())
    parts["total"] = total
    return report, parts


def split_text(parts: dict) -> str:
    return ", ".join(f"{k} {v:.3f}" for k, v in parts.items()) + " s"


def ckpt_phase(session, jc) -> dict:
    """`save()` under build/, `TuningSession.load()` on the card and
    `apply()`: the loaded session launches `join_count` and answers as
    the live one; three more saves leave the newest three steps."""
    import shutil

    from repro_torch.api import TuningSession
    from repro_torch.checkpoint import checkpoint as ckpt

    d = ROOT / "build" / "ckpt_session"
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    path = session.save(str(d))
    save_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in Path(path).iterdir())
    t0 = time.perf_counter()
    loaded = TuningSession.load(str(d))
    load_s = time.perf_counter() - t0
    check(loaded.device == session.device and loaded.cfg == session.cfg,
          f"the loaded session runs on {loaded.device} with {loaded.cfg}; "
          f"the live one on {session.device} with {session.cfg}")
    check(loaded.best.key() == session.best.key()
          and loaded.groups == session.groups
          and [q.name for q in loaded.workload]
          == [q.name for q in session.workload],
          "the loaded session's workload, best state or groups differ")
    check(bool((loaded.store.triples == session.store.triples).all()),
          "the loaded triple table differs")
    zero_counts((jc,))
    _, apply_split = split_apply(loaded)
    apply_s = apply_split["total"]
    launches = jc.launches
    check(launches > 0, "the loaded session's apply launched no join_count")
    for q in session.workload:
        check(loaded.answer(q.name) == session.answer(q.name),
              f"{q.name}: the loaded session's answer differs from the "
              f"live session's")
    more_s = []
    for step in (1, 2, 3):
        t0 = time.perf_counter()
        more = session.save(str(d))
        more_s.append(time.perf_counter() - t0)
        check(more.endswith(f"step_{step:08d}"), f"save {step + 1} wrote "
                                                 f"{more}")
    steps = ckpt.list_steps(str(d))
    check(steps == [1, 2, 3], f"four saves left steps {steps}, expected "
                              f"the newest three")
    log(f"[ckpt] save of {len(session.store):,} triples {save_s:.3f} s, "
        f"{size:,} bytes; load {load_s:.3f} s; apply {apply_s:.3f} s with "
        f"{launches} join_count launches; {len(session.workload)} answers "
        f"equal to the live session's; three more saves "
        f"{' '.join(f'{x:.3f}' for x in more_s)} s left steps {steps}")
    log(f"[ckpt] loaded apply split: {split_text(apply_split)}")
    del loaded
    shutil.rmtree(d, ignore_errors=True)
    return {"triples": len(session.store), "save_s": save_s, "bytes": size,
            "load_s": load_s, "apply_s": apply_s, "launches": launches,
            "apply_split": apply_split,
            "more_saves_s": more_s}


def stride_sweep(jc, probe, build) -> tuple[int, dict]:
    """The plan's D for these operands, and the device ms of the bare
    launch at each D from D/4 to 4D that changes the sample (the plan's
    grid kept; the pre-pass wherever D > 1 and there are several blocks);
    each result held exact against the plain version."""
    import ctypes

    import torch

    from repro_torch.kernels import _build, ref

    idx, L, S = probe.get_device(), probe.shape[-1], build.shape[-1]
    B = probe.numel() // L
    blocks, D, _ = jc.plan(B, L, S, jc._sm_count(idx))
    want_lo, want_count = ref.join_count_ref(probe, build)
    lo, count = torch.empty_like(probe), torch.empty_like(probe)
    scratch = probe.new_empty(B * jc.MAX_SAMPLES)
    fn = _build.launcher(jc.NAME, jc._ARGTYPES)
    times = {}
    for d in (D // 4, D // 2, D, 2 * D, 4 * D):
        if d < 1 or -(-S // d) > jc.MAX_SAMPLES or (d > 1 and d // 2 >= S):
            continue
        shape = jc.Shape(B, L, S, d, blocks, idx)
        pre = d > 1 and blocks > 1

        def launch():
            err = _build.launch(
                fn, idx, probe.data_ptr(), build.data_ptr(),
                scratch.data_ptr() if pre else None, lo.data_ptr(),
                count.data_ptr(), ctypes.addressof(shape))
            check(err == 0, f"join_count launch at D={d} failed: {err}")

        launch()
        torch.cuda.synchronize()
        check(torch.equal(lo, want_lo) and torch.equal(count, want_count),
              f"join_count differs at D={d}, B={B} L={L} S={S}")
        times[d] = graph_ms(launch)
    return D, times


def join_stream_phase(ops, ref, jc, shapes: dict, parent) -> tuple[int, dict]:
    """join_count at every (B, L, S) the stream gave it, on the operands it
    first gave at that shape: exact against the plain version; times
    summed over the stream's calls."""
    max_err, totals, each = 0, {"calls": 0}, []
    swept = {"plan_ms": 0.0, "best_ms": 0.0, "plan_is_best": 0, "each": []}
    for (pshape, S), (count, probe, build) in sorted(
            shapes.items(), key=lambda kv: (kv[0][0], kv[0][1])):
        err = compare_kernel(ops, ref, probe, build)
        check(err == 0, f"join_count differs at stream shape {pshape} S={S}")
        max_err = max(max_err, err)
        t = time_join(ops, ref, jc, probe, build, parent, reps=10)
        for key, v in t.items():
            totals[key] = totals.get(key, 0.0) + count * v
        totals["calls"] += count
        each.append(f"{'x'.join(map(str, pshape))}x{S} {count} calls "
                    f"{t['device_ms'] * 1e3:.2f}"
                    + (f"/{t['parent_device_ms'] * 1e3:.2f}" if parent
                       else ""))
        D, sweep = stride_sweep(jc, probe, build)
        best = min(sweep, key=sweep.get)
        swept["plan_ms"] += count * sweep[D]
        swept["best_ms"] += count * sweep[best]
        swept["plan_is_best"] += best == D
        swept["each"].append(f"{'x'.join(map(str, pshape))}x{S} plan D={D} "
                             + " ".join(f"{d}:{ms * 1e3:.2f}"
                                        for d, ms in sweep.items()))
    log(f"[shape] join_count at the stream's shapes, (B x) L x S, calls, "
        f"device us{' (parent)' if parent else ''}: " + "; ".join(each))
    log(f"[shape] join_count over the stream's {totals['calls']} calls "
        f"({len(shapes)} shapes, each exact): summed " + join_times(totals))
    log(f"[shape] join_count sample stride D at the stream's shapes, device "
        f"us of the bare launch at D/4 .. 4D (each exact): "
        + "; ".join(swept.pop("each")))
    log(f"[shape] join_count's plan takes the best D of the sweep on "
        f"{swept['plan_is_best']} of {len(shapes)} shapes; over the stream's "
        f"calls the plan's D sums to {swept['plan_ms']:.4f} ms, the best D "
        f"of each shape to {swept['best_ms']:.4f} ms")
    totals["stride_sweep"] = swept
    return max_err, totals


def append_shape_phase(ops, ref, sa, shapes: dict, dev, parent
                       ) -> tuple[int, dict]:
    """scatter_append at every (cap, dcap, W, k) the stream gave it, on
    fresh inputs with the stream's n: exact against the plain version
    through both entries; times summed over the stream's calls, printed
    per (cap, dcap, W) class; then the [host] line at the stream's most
    frequent shape."""
    import numpy as np
    import torch

    rng = np.random.default_rng(4)
    max_err = 0
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms")
    if parent is not None:
        keys += ("parent_ms", "parent_device_ms")
    totals = dict.fromkeys(keys, 0.0)
    totals["calls"] = 0
    classes: dict[tuple, dict] = {}
    for (cap, dcap, w, k), (count, n) in sorted(shapes.items()):
        buf, rows = append_inputs(rng, cap, n, dcap, w, dev)
        err = compare_append(ops, ref, sa, buf, n, rows, k)
        check(err == 0, f"scatter_append differs at stream shape cap={cap} "
                        f"dcap={dcap} W={w} k={k}")
        max_err = max(max_err, err)
        got = time_append(ops, ref, sa, buf, n, rows, k, parent, reps=10)
        c = classes.setdefault((cap, dcap, w), {"calls": 0, "k": [],
                                                **dict.fromkeys(keys, 0.0)})
        c["calls"] += count
        c["k"].append(k)
        for key in keys:
            c[key] += count * got[key]
            totals[key] += count * got[key]
        totals["calls"] += count
    for (cap, dcap, w), c in classes.items():
        log(f"[shape] scatter_append cap={cap} dcap={dcap} W={w}: "
            f"{c['calls']} calls, k {min(c['k'])}..{max(c['k'])}, exact "
            f"through both entries; summed " + append_times(c))
    log(f"[shape] scatter_append over the stream's {totals['calls']} calls "
        f"({len(shapes)} shapes): " + append_times(totals))
    (cap, dcap, w, k), (count, n) = max(shapes.items(),
                                        key=lambda kv: kv[1][0])
    buf, rows = append_inputs(rng, cap, n, dcap, w, dev)
    split = append_host_split(ops, sa, buf, n, rows, k)
    device = graph_ms(lambda: sa.scatter_append_counts_cuda(buf, rows, n, k))
    idx, delta = torch.arange(n, n + k, device=dev), rows[:k]
    library_us = host_us(lambda: buf.index_copy(0, idx, delta))
    parent_us = None if parent is None else host_us(
        lambda: parent[0].scatter_append(buf, n, rows, k))
    totals["host"] = {"shape": f"cap={cap} dcap={dcap} W={w} n={n} k={k}",
                      "calls_in_stream": count, "device_ms": device,
                      "library_us": library_us,
                      "parent_wrapper_us": parent_us, "split_us": split}
    log(f"[host] scatter_append at the stream's most frequent shape "
        f"(cap={cap} dcap={dcap} W={w} n={n} k={k}, {count} calls): "
        f"wrapper {split['wrapper']:.2f} us a call on the host (device "
        f"{device * 1e3:.2f} us); " + ", ".join(
            f"{key} {v:.2f}" for key, v in split.items() if key != "wrapper")
        + f" us; library (index_copy) {library_us:.2f} us"
        + ("" if parent_us is None else f"; parent wrapper {parent_us:.2f} us"))
    return max_err, totals


def attention_pairs(S: int, window: int) -> int:
    """Unmasked (query, key) pairs of one head: keys t <= s, and
    t > s - window when window > 0."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attention_bound(B: int, S: int, H: int, Hkv: int, hd: int, window: int,
                    elem: int = 2) -> tuple[float, str]:
    """Least time for the forward in ms, and what bounds it: read q, k, v
    and write o once at the card's memory rate ("bytes"), or do 4*hd
    flops per unmasked pair per head (the QK^T and PV products) at the
    dense bf16 tensor-core peak ("operations"); the larger."""
    nbytes = (2 * B * S * H * hd + 2 * B * S * Hkv * hd) * elem
    flops = 4 * hd * attention_pairs(S, window) * B * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_inputs(gen, B: int, S: int, H: int, Hkv: int, hd: int, dtype,
                     dev):
    """Standard-normal q (B,S,H,hd) and k, v (B,S,Hkv,hd) on the card."""
    import torch

    return tuple(torch.randn(shape, generator=gen, device=dev, dtype=dtype)
                 for shape in ((B, S, H, hd), (B, S, Hkv, hd),
                               (B, S, Hkv, hd)))


def limit_share(a, b, atol: float, rtol: float) -> tuple[float, float]:
    """(max |a - b|, max |a - b| / (atol + rtol * |b|)): the error and
    the share of the allclose limit it uses."""
    diff = (a.float() - b.float()).abs()
    return (float(diff.max()),
            float((diff / (atol + rtol * b.float().abs())).max()))


def close(a, b, atol: float, what: str, rtol: float | None = None,
          margin: list | None = None) -> float:
    """Max abs error of `a` against `b`; fails unless |a - b| <= atol +
    rtol * |b| everywhere (allclose; rtol = atol unless given).  Appends
    the largest |a - b| / (atol + rtol * |b|) to `margin` when given."""
    rtol = atol if rtol is None else rtol
    err, worst = limit_share(a, b, atol, rtol)
    check(worst <= 1.0, f"{what}: max abs err {err:.3e}, {worst:.3f} of the "
                        f"limit (atol {atol}, rtol {rtol})")
    if margin is not None:
        margin.append(worst)
    return err


def compare_attention(ops, ref, fa, q, k, v, window: int,
                      margin: list | None = None, want=None
                      ) -> tuple[float, str]:
    """The kernel against the plain version (`want`, computed here unless
    given) on the same card tensors, held to ATTN_TOL for the dtype; the
    launch must go through the design `fa.design` names.  Returns (the max
    abs error, that design) and appends the share of the limit used to
    `margin`."""
    import torch

    use = fa.design(q.dtype, q.shape[3])
    before = fa.design_launches[use]
    got = ops.flash_attention(q, k, v, window)
    torch.cuda.synchronize()
    check(fa.design_launches[use] == before + 1,
          f"flash_attention at {tuple(q.shape)} {q.dtype} did not launch "
          f"its {use} design")
    check(got.shape == q.shape and got.dtype == q.dtype,
          f"flash_attention returned {tuple(got.shape)} {got.dtype}")
    check(bool(torch.isfinite(got).all()), "flash_attention output not finite")
    atol, rtol = ATTN_TOL[str(q.dtype).replace("torch.", "")]
    if want is None:
        want = ref.flash_attention_ref(q, k, v, window)
    return close(got, want, atol,
                 f"flash_attention ({use}) against its plain version at "
                 f"{tuple(q.shape)} kv {tuple(k.shape)} window {window} "
                 f"{q.dtype}", rtol=rtol, margin=margin), use


def sdpa_call(q, k, v, window: int):
    """One PyTorch call computing the same function (the yardstick only;
    never on the port's path): SDPA on head-major views, causal with
    GQA, or with an explicit boolean band mask for a window."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = k.shape[2] != q.shape[2]
    if window <= 0:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=gqa)
    S = q.shape[1]
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = (j <= i) & (j > i - window)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=gqa)


def library_attention_ms(q, k, v, window: int) -> tuple[float | None, str]:
    """(ms, what was timed) of the library call at this shape:
    `sdpa_call` as it stands; where that call fails (its error is
    returned in the text), SDPA on k and v repeated to the H query heads
    (outside the timed call), which computes the same function; None
    where both fail."""
    import torch

    try:
        return cuda_ms(sdpa_call(q, k, v, window), 3, 1), "SDPA, GQA"
    except RuntimeError as e:
        err = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    torch.cuda.empty_cache()
    G = q.shape[2] // k.shape[2]
    ke, ve = (x.repeat_interleave(G, dim=2) for x in (k, v))
    try:
        ms = cuda_ms(sdpa_call(q, ke, ve, window), 3, 1)
    except RuntimeError as e:
        return None, (f"SDPA, GQA failed ({err}); on k, v repeated to "
                      f"{q.shape[2]} heads failed ({type(e).__name__}: "
                      f"{str(e).splitlines()[0][:160]})")
    finally:
        del ke, ve
        torch.cuda.empty_cache()
    return ms, (f"SDPA on k, v repeated to {q.shape[2]} heads; the GQA call "
                f"failed: {err}")


def kernel_phase_attention(ops, ref, fa, dev) -> tuple[float, dict]:
    """flash_attention against its plain version at the LM prefill's two
    shapes (a global and a sliding-window layer of `lm_config()` over
    LM_BATCH x LM_PROMPT tokens) and on the sweep cases; times of the
    two path shapes.  At those shapes also, not on the path: P V as one
    bf16 product (its share of the limit, not held to it) and the
    earlier, CUDA-core design (held to the limit and timed).  Returns
    (max abs err over every case, {window: times})."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(5)
    cfg = lm_config()
    B, S, H, Hkv, hd = (LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.n_kv_heads,
                        cfg.hd)
    atol, rtol = ATTN_TOL["bfloat16"]
    p_as = "split hi/lo bf16 products" if fa.SPLIT_P else "one bf16 product"
    max_err, path = 0.0, {}
    for window in (0, cfg.window):
        q, k, v = attention_inputs(gen, B, S, H, Hkv, hd, torch.bfloat16, dev)
        want = ref.flash_attention_ref(q, k, v, window)
        margin = []
        err, use = compare_attention(ops, ref, fa, q, k, v, window, margin,
                                     want)
        check(use == "tensor_core", f"the path's shape went to {use}")
        max_err = max(max_err, err)
        one_err, one_share = limit_share(fa.flash_attention_cuda(
            q, k, v, window, split_p=not fa.SPLIT_P), want, atol, rtol)
        earlier = fa.flash_attention_cuda(q, k, v, window, use="cuda_core")
        earlier_err, earlier_share = limit_share(earlier, want, atol, rtol)
        check(earlier_share <= 1.0, f"the CUDA-core design at the path's "
                                    f"shape: {earlier_share:.3f} of the limit")
        del earlier, want
        lib = sdpa_call(q, k, v, window)
        lib_err = float((lib().transpose(1, 2).float()
                         - ref.flash_attention_ref(q, k, v, window).float())
                        .abs().max())
        t = {"ms": cuda_ms(lambda: ops.flash_attention(q, k, v, window), 10),
             "device_ms": graph_ms(
                 lambda: fa.flash_attention_cuda(q, k, v, window), 5),
             "earlier_device_ms": graph_ms(
                 lambda: fa.flash_attention_cuda(q, k, v, window,
                                                 use="cuda_core"), 5),
             "plain_ms": cuda_ms(
                 lambda: ref.flash_attention_ref(q, k, v, window), 5, 1),
             "library_ms": cuda_ms(lib, 10)}
        t["bound_ms"], t["bound_by"] = attention_bound(B, S, H, Hkv, hd,
                                                       window)
        t.update(max_abs_err=err, share_of_limit=margin[0], design=use,
                 p_product=p_as, other_p_share_of_limit=one_share,
                 earlier_share_of_limit=earlier_share)
        path[window] = t
        how = "bool mask" if window else "causal"
        log(f"[kernel] flash_attention B={B} S={S} H={H} Hkv={Hkv} hd={hd} "
            f"bf16 window {window}: design {use}, P V as {p_as}: max abs "
            f"err {err:.3e} ({margin[0]:.3f} of the limit {atol} + 2**-7 "
            f"|ref|); P V as {'one bf16 product' if fa.SPLIT_P else 'split'}"
            f" (not on the path): max abs err {one_err:.3e}, {one_share:.3f}"
            f" of the limit; kernel {t['ms']:.4f} ms (device "
            f"{t['device_ms']:.4f} ms), earlier CUDA-core design device "
            f"{t['earlier_device_ms']:.4f} ms ({earlier_share:.3f} of the "
            f"limit), plain {t['plain_ms']:.4f} ms, library (SDPA, {how}, "
            f"err {lib_err:.3e}) {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']} "
            f"({t['bound_ms'] / t['device_ms']:.1%} of it)")
        del q, k, v
    bf = torch.bfloat16
    cases = [(2, 384, 16, kv, 256, w, bf) for kv in (1, 2, 16)
             for w in (0, 100)]
    cases += [(2, 1000, 16, 8, 256, 300, bf),   # ragged S
              (1, 1500, 16, 8, 256, 1024, bf),  # ragged S, the path's window
              (2, 64, 16, 8, 256, 0, bf),       # one query tile
              (2, 65, 16, 8, 256, 0, bf),       # ... and a one-row tail
              (3, 1, 4, 2, 64, 0, bf),
              (2, 333, 4, 2, 64, 70, bf),
              (2, 333, 4, 2, 128, 50, bf),
              (1, 300, 4, 2, 32, 9, bf),        # CUDA-core in bf16
              (3, 1, 4, 2, 64, 0, torch.float32),
              (2, 300, 8, 2, 16, 0, torch.float32),
              (2, 300, 8, 2, 16, 37, torch.float32),
              (1, 517, 4, 4, 128, 64, torch.float32),
              (1, 517, 4, 1, 128, 0, torch.float32)]
    # the CUDA-core hd 256 template at the path's S, in fp32
    cases += [(1, S, H, Hkv, hd, w, torch.float32) for w in (0, cfg.window)]
    # the [lm_families] prefills' shapes (granite-moe's 16 / 8 and
    # llama4's 40 / 8 heads, zamba2's shared block 32 / 32), each of which
    # must take the tensor-core design, as the prefill counts require
    served = {family_attention_case(arch) for arch in LM_FAMILIES}
    served.discard(None)
    cases += sorted(served)
    # whisper-base's decoder prefill (bf16 at hd 64: the tensor-core design,
    # 416 = 3 x 128 + 32 rows, a tail tile), qwen2-vl-2b's training forward
    # and granite-moe's sharded training forward (fp32: the CUDA-core design)
    expected = {encdec_attention_case(): "tensor_core",
                train_attention_case(): "cuda_core",
                sharded_train_attention_case(): "cuda_core"}
    cases += list(expected)
    margin = {"float32": [], "bfloat16": []}
    designs = dict.fromkeys(fa.DESIGNS, 0)
    launched = []
    for B, S, H, Hkv, hd, w, dt in cases:
        q, k, v = attention_inputs(gen, B, S, H, Hkv, hd, dt, dev)
        name = str(dt).replace("torch.", "")
        err, use = compare_attention(ops, ref, fa, q, k, v, w, margin[name])
        if (B, S, H, Hkv, hd, w, dt) in served:
            check(use == "tensor_core", f"the served prefill shape B={B} "
                  f"S={S} H={H}/{Hkv} hd={hd} went to {use}")
        want_use = expected.get((B, S, H, Hkv, hd, w, dt))
        check(want_use in (None, use), f"B={B} S={S} H={H}/{Hkv} hd={hd} "
                                       f"{name} went to {use}, not {want_use}")
        max_err = max(max_err, err)
        designs[use] += 1
        launched.append(f"B{B} S{S} H{H}/{Hkv} hd{hd} w{w} {name}: {use} "
                        f"{margin[name][-1]:.3f}")
    log(f"[kernel] flash_attention sweep, each case's design and share of "
        f"its limit: {'; '.join(launched)}")
    log(f"[kernel] flash_attention sweep of {len(cases)} cases (Hkv in 1, 2, "
        f"H; ragged S=1000 and S=1500; S=1; S=64, 65; bf16 at hd 32, 64, "
        f"128 and 256; the [lm_families] prefills at B={LM_BATCH}, S="
        f"{LM_PROMPT}: granite-moe's 16 / 8 and zamba2's 32 / 32 at hd 64, "
        f"llama4's 40 / 8 at hd 128, all tensor-core; whisper-base's "
        f"prefill {encdec_attention_case()[:5]} bf16, tensor-core; the "
        f"training forward {train_attention_case()[:5]} and granite-moe's "
        f"sharded one {sharded_train_attention_case()[:5]} fp32, CUDA-core; "
        f"fp32 at hd 16, 128 and 256 at the path's S), "
        f"launched as {json.dumps(designs)}: all within tolerance, max abs "
        f"err {max_err:.3e}; at most {max(margin['float32']):.3f} of the "
        f"fp32 limit (2e-3 + 2e-3 |ref|) and {max(margin['bfloat16']):.3f} "
        f"of the bf16 limit (1e-4 + 2**-7 |ref|)")
    return max_err, path


def lm_config():
    """The served model: the published gemma3-12b config (48 layers,
    d 3840, 16 heads, 8 kv heads, hd 256, vocab 262,144, window 1,024)
    with the chunked attention path, i.e. the flash_attention kernel."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(LM_ARCH), attn_impl="chunked")


def attn_per_group(cfg) -> int:
    """Causal self-attention applications in one group of `cfg`: each
    attn / swa block and each application of the shared block
    (mamba2_shared)."""
    return sum(kind in ("attn", "swa", "mamba2_shared")
               for kind in cfg.block_pattern)


def no_drop(cfg):
    """`cfg` with `capacity_factor = n_experts / top_k` for an MoE
    config: the capacity then holds every (token, expert) pair, so a
    teacher-forced decode drops what the forward drops (nothing); other
    configs unchanged."""
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def lm_checks(cfg, fa, dev, tag: str = "[lm]") -> dict:
    """At the served width and one group, fp32 weights from seed 1, no
    TF32 (MoE at `capacity_factor = n_experts / top_k`): (1) where the
    group has attention, the chunked forward, whose attention is the
    kernel, against the dense forward (the JAX test's tolerance, 3e-3;
    without attention the two forwards run the same code);
    (2) a kernel prefill of S tokens, then LM_CHECK_DECODE teacher-forced
    decode steps (for an SSM family as many as make the forward a whole
    number of chunks, which `mamba2_train` requires), against the dense
    forward over those tokens: prefill logits at 3e-3, decode logits at
    3e-2 (the JAX handoff test's: the cache is bf16)."""
    import torch

    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    S = 2 * cfg.attn_chunk
    one = no_drop(dataclasses.replace(cfg, n_layers=len(cfg.block_pattern)))
    n_attn = attn_per_group(one)
    n_dec = LM_CHECK_DECODE
    if one.ssm is not None:
        n_dec = -(-(S + n_dec) // one.ssm.chunk) * one.ssm.chunk - S
    chunked = build_model(one).init(
        torch.Generator(device=dev).manual_seed(1), dtype=torch.float32)
    dense = build_model(dataclasses.replace(one, attn_impl="dense")
                        ).load_params(chunked.params)
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (LM_CHECK_BATCH, S + n_dec),
                         generator=gen, device=dev, dtype=torch.int32)
    out = {}
    t0 = time.perf_counter()
    launched = 0
    if n_attn:
        zero_counts([fa])
        a = chunked.forward(tokens=toks[:, :S])
        launched = fa.launches
        b = dense.forward(tokens=toks[:, :S])
        check(launched == n_attn
              and fa.design_launches["cuda_core"] == launched,
              f"the chunked fp32 forward launched flash_attention {launched} "
              f"times ({json.dumps(fa.design_launches)}), expected {n_attn}")
        check(fa.launches == launched, "the dense forward launched the kernel")
        out["forward"] = close(a, b, 3e-3, "chunked (kernel) forward against "
                                           "the dense forward")
        del a, b
    full = dense.forward(tokens=toks)
    logits0, cache = chunked.prefill_with_cache(
        tokens=toks[:, :S], cache_len=S + n_dec)
    out["prefill"] = close(logits0, full[:, :S], 3e-3,
                           "kernel prefill logits against the dense forward")
    del logits0
    out["decode"] = 0.0
    for t in range(S, S + n_dec):
        logits, cache = chunked.decode_step(toks[:, t:t + 1], t, cache)
        out["decode"] = max(out["decode"], close(
            logits[:, 0], full[:, t], 3e-2,
            f"teacher-forced decode at position {t} against the forward"))
    torch.cuda.synchronize()
    moe = ("" if one.moe is None else
           f", capacity_factor {one.moe.capacity_factor:g} (n_experts / "
           f"top_k: no pair dropped)")
    fwd = (f"chunked (CUDA-core kernel, {launched} launches) vs dense forward "
           f"max abs err {out['forward']:.3e} (tol 3e-3); " if n_attn else "")
    log(f"{tag} checks at d={one.d_model}, {one.n_layers} layers (one group), "
        f"fp32, B={LM_CHECK_BATCH}, S={S}{moe}: {fwd}"
        f"{'kernel ' if n_attn else ''}prefill vs dense "
        f"forward {out['prefill']:.3e} (tol 3e-3); {n_dec} "
        f"teacher-forced decode steps vs the forward {out['decode']:.3e} "
        f"(tol 3e-2) ({time.perf_counter() - t0:.2f} s)")
    return out


def with_drops(fn, into: list):
    """`fn`, run with `layers._route` wrapped so that each MoE layer
    appends its dropped pairs (a device count: no host sync) to `into`."""
    from repro_torch.models import layers as L

    def run():
        real = L._route

        def route(cfg, logits, dtype):
            out = real(cfg, logits, dtype)
            into.append((~out[3]).sum())
            return out

        L._route = route
        try:
            return fn()
        finally:
            L._route = real
    return run


def run_counted(kernels: dict, fn):
    """(fn(), its seconds, the launches it made): every kernel count set
    to 0 just before `fn` and read just after it (flash_attention's per
    design too), the card synchronized on both sides."""
    import torch

    zero_counts(kernels.values())
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    got = {n: m.launches for n, m in kernels.items()}
    got.update({f"flash_attention.{d}": n for d, n in
                kernels["flash_attention"].design_launches.items()})
    return res, time.perf_counter() - t, got


def serve_lm(cfg, kernels: dict, dev, tag: str, checks: dict,
             profile: tuple = ("prefill", "decode step")) -> dict:
    """LM serving of `cfg` (bf16 weights from seed 0): prefill (twice:
    cold, then the measured one), LM_DECODE greedy decode steps,
    BatchedServer; then the runs named in `profile`, profiled.  A prefill
    must launch the tensor-core `flash_attention` once per causal
    self-attention, and decode none.  Every kernel count is set to 0 just
    before each run and read just after it."""
    import torch

    from repro_torch.models.model import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.serve.serve_step import (BatchedServer, ServeConfig,
                                              make_serve_step)

    n_attn = attn_per_group(cfg) * cfg.n_groups
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                  dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated() - base
    log(f"{tag} init (bf16, torch.Generator seed 0) {init_s:.3f} s: "
        f"{model.param_count():,} parameters in the tree "
        f"(cfg.param_count() {cfg.param_count():,}), "
        f"{weights / 2**30:.2f} GiB")
    gen = torch.Generator(device=dev).manual_seed(3)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=gen,
                            device=dev, dtype=torch.int32)

    counted = functools.partial(run_counted, kernels)

    prefill = lambda: model.prefill_with_cache(  # noqa: E731
        tokens=prompts, cache_len=LM_CACHE)
    drops_prefill: list = []
    ((logits, cache), prefill_syncs), cold_s, cold_launches = counted(
        lambda: count_syncs(with_drops(prefill, drops_prefill)))
    del logits, cache
    (logits, cache), prefill_s, launches = counted(prefill)
    peak_prefill = torch.cuda.max_memory_allocated()
    held = sum(x.nbytes for _, x in tree_leaves(model.params)) \
        + prompts.nbytes
    for got in (cold_launches, launches):
        check(got["flash_attention"] == n_attn
              and got["flash_attention.tensor_core"] == n_attn,
              f"a prefill launched flash_attention {json.dumps(got)}, "
              f"expected {n_attn} (one per causal self-attention) of the "
              f"tensor-core design")
    check(tuple(logits.shape) == (LM_BATCH, LM_PROMPT, cfg.vocab_padded),
          f"prefill logits {tuple(logits.shape)}")
    # row by row: isfinite over all the logits at once would hold about
    # twice their size in temporaries
    check(all(bool(torch.isfinite(row).all()) for row in logits),
          "prefill logits not finite")
    log(f"{tag} prefill_with_cache {LM_BATCH} x {LM_PROMPT} tokens "
        f"(cache {LM_CACHE}): {prefill_s:.4f} s ({cold_s:.4f} s cold), "
        f"{LM_BATCH * LM_PROMPT / prefill_s:,.0f} tokens/s; launches "
        f"{json.dumps(launches)}; peak device memory "
        f"{peak_prefill / 2**30:.2f} GiB; {len(prefill_syncs)} host syncs "
        f"in the cold one {' '.join(sorted(set(prefill_syncs)))}")

    step = make_serve_step(model, ServeConfig(cache_len=LM_CACHE))
    tok = torch.argmax(logits[:, -1, :].float(), dim=-1)[:, None].to(
        torch.int32)
    del logits
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(LM_DECODE + 1)]

    def decode():
        nonlocal tok, cache
        out = [tok]
        marks[0].record()
        for i in range(LM_DECODE):
            tok, cache = step(cache, tok, LM_PROMPT + i)
            out.append(tok)
            marks[i + 1].record()
        return torch.cat(out, dim=1)

    toks, decode_s, dec_launches = counted(decode)
    step_ms = sorted(marks[i].elapsed_time(marks[i + 1])
                     for i in range(LM_DECODE))
    # a step reads nothing back (pos is a host int): no host sync at all
    torch.cuda.synchronize()
    drops_decode: list = []
    (_, cache), syncs = count_syncs(with_drops(
        lambda: step(cache, toks[:, -1:], LM_PROMPT + LM_DECODE - 1),
        drops_decode))
    check(not syncs, f"a decode step made {len(syncs)} host syncs: "
                     f"{' '.join(syncs)}")
    check(dec_launches["flash_attention"] == 0
          and dec_launches["flash_attention.tensor_core"] == 0,
          f"decode launched flash_attention {json.dumps(dec_launches)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "a decoded token lies outside [0, vocab)")
    log(f"{tag} {LM_DECODE} greedy decode steps from position {LM_PROMPT}: "
        f"{decode_s * 1e3 / LM_DECODE:.3f} ms/step ({step_ms[0]:.3f} / "
        f"{step_ms[len(step_ms) // 2]:.3f} / {step_ms[-1]:.3f} ms min / "
        f"median / max by CUDA events), {LM_BATCH * LM_DECODE / decode_s:,.1f}"
        f" tokens/s; launches {json.dumps(dec_launches)}; 0 host syncs in "
        f"a step; request 0 {toks[0, :8].tolist()}...")
    drops = None
    if cfg.moe is not None:
        m = cfg.moe
        drops = {"prefill": torch.stack(drops_prefill).tolist(),
                 "decode_step": torch.stack(drops_decode).tolist(),
                 "prefill_pairs": LM_BATCH * LM_PROMPT * m.top_k,
                 "decode_pairs": LM_BATCH * m.top_k,
                 "capacity_factor": m.capacity_factor}
        check(len(drops["prefill"]) == len(drops["decode_step"])
              == cfg.n_layers, f"MoE drops recorded for "
                               f"{len(drops['prefill'])} layers")
        log(f"{tag} MoE pairs dropped per layer at capacity_factor "
            f"{m.capacity_factor:g}: prefill {drops['prefill']} of "
            f"{drops['prefill_pairs']:,}; one decode step "
            f"{drops['decode_step']} of {drops['decode_pairs']}")
    peak = torch.cuda.max_memory_allocated()
    del cache, toks

    # Random tied embeddings make the model echo its input token, and the
    # server's slots start from token 0, the default EOS: every request
    # would end at its first token.  An id outside the vocabulary as EOS
    # lets each request run to max_new.
    srv = BatchedServer(model, ServeConfig(cache_len=LM_CACHE),
                        batch=LM_BATCH, eos_id=cfg.vocab,
                        max_new=LM_SERVE_MAX_NEW)
    done, serve_s, srv_launches = counted(lambda: srv.run(LM_SERVE_STEPS))
    want = LM_BATCH * LM_SERVE_STEPS // LM_SERVE_MAX_NEW
    check(len(done) == want and all(len(r) == LM_SERVE_MAX_NEW
                                    for r in done),
          f"BatchedServer finished {len(done)} requests of lengths "
          f"{sorted({len(r) for r in done})}, expected {want} of "
          f"{LM_SERVE_MAX_NEW}")
    check(all(0 <= t < cfg.vocab for seq in done for t in seq),
          "BatchedServer produced a token outside [0, vocab)")
    log(f"{tag} BatchedServer(batch={LM_BATCH}, max_new={LM_SERVE_MAX_NEW})"
        f".run({LM_SERVE_STEPS}): {len(done)} requests finished in "
        f"{serve_s:.3f} s ({serve_s * 1e3 / LM_SERVE_STEPS:.3f} ms/step); "
        f"launches {json.dumps(srv_launches)}")
    # where the time goes: one prefill and one decode step, profiled
    del srv
    profiles = {}
    if profile:
        (logits, cache), profiles["prefill"] = profiled(prefill, top=6)
        tok = torch.argmax(logits[:, -1, :].float(), dim=-1)[:, None].to(
            torch.int32)
        del logits
        if "decode step" in profile:
            _, profiles["decode step"] = profiled(
                lambda: step(cache, tok, LM_PROMPT), top=6)
        del cache
        check(profiles["prefill"]["flash_attn_ms"] > 0 or n_attn == 0,
              "the profiler saw no flash_attention device time in the "
              "prefill")
    for label, prof in profiles.items():
        log(f"{tag} one {label} (profiled): wall {prof['wall_ms']:.3f} ms, "
            f"device busy {prof['busy_ms']:.3f} ms "
            f"({prof['busy_ms'] / prof['wall_ms']:.1%}) in {prof['events']} "
            f"device events; flash_attention {prof['flash_attn_ms']:.3f} ms "
            f"({prof['flash_attn_ms'] / max(prof['busy_ms'], 1e-9):.1%} of "
            f"busy)")
        for nm, ms in prof["top"]:
            log(f"{tag}   {ms:.4f} ms  {nm[:100]}")
    log(f"{tag} peak device memory (weights, prefill, decode) "
        f"{peak / 2**30:.2f} GiB, of which {base / 2**30:.2f} GiB held by "
        f"the earlier phases' session; weights {weights / 2**30:.2f} GiB; "
        f"request 0 of the server {done[0]}")
    del model
    torch.cuda.empty_cache()
    out = {"launches": launches, "prefill_s": prefill_s,
           "decode_step_ms": {"min": step_ms[0],
                              "median": step_ms[len(step_ms) // 2],
                              "max": step_ms[-1]},
           "cold_prefill_s": cold_s, "decode_ms": decode_s * 1e3 / LM_DECODE,
           "decode_tokens_per_s": LM_BATCH * LM_DECODE / decode_s,
           "prefill_syncs": len(prefill_syncs),
           "peak_gib": peak / 2**30, "checks": checks,
           "held_bytes": held, "prefill_peak_bytes": peak_prefill - base,
           "profiled": {k.replace(" ", "_"): v for k, v in profiles.items()},
           "requests": len(done)}
    if drops is not None:
        out["moe_drops"] = drops
    return out


def lm_phase(kernels: dict, dev) -> dict:
    """LM serving of gemma3-12b at full width: the one-group fp32 checks,
    then `serve_lm`."""
    cfg = lm_config()
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers ({cfg.n_groups} groups of "
        f"{'/'.join(cfg.block_pattern)}), d {cfg.d_model}, {cfg.n_heads} "
        f"heads, {cfg.n_kv_heads} kv heads, hd {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab:,}, window {cfg.window}, attn_impl "
        f"{cfg.attn_impl} (chunk {cfg.attn_chunk})")
    import torch

    checks = lm_checks(cfg, kernels["flash_attention"], dev)
    torch.cuda.empty_cache()
    return serve_lm(cfg, kernels, dev, "[lm]", checks)


def family_attention_case(arch: str):
    """The flash_attention shape of `arch`'s served prefill as a sweep case
    (B, S, H, Hkv, hd, window, dtype), or None for a family without
    attention.  Every attention layer of the families served has window 0
    (no swa block)."""
    import torch

    cfg, _ = family_config(arch)
    if not attn_per_group(cfg):
        return None
    check("swa" not in cfg.block_pattern, f"{arch} has a windowed layer")
    return (LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.hd, 0,
            torch.bfloat16)


def family_config(arch: str):
    """The published config of `arch` with the chunked attention path,
    cut to LM_FAMILY_LAYERS' depth where that names one; and the cut's
    reason (None: all layers)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), attn_impl="chunked")
    cut = LM_FAMILY_LAYERS.get(arch)
    if cut is None:
        return cfg, None
    return dataclasses.replace(cfg, n_layers=cut[0]), cut[1]


def lm_families_phase(kernels: dict, dev) -> dict:
    """LM serving of the MoE and SSM families, each at its published
    width: lm_checks' fp32 checks unless LM_FAMILY_NO_CHECK names it, then
    `serve_lm` (the MoE models' measured prefill profiled).  The phase
    must finish within LM_FAMILIES_LIMIT_S."""
    import torch

    t_phase = time.perf_counter()
    out = {}
    for arch in LM_FAMILIES:
        t0 = time.perf_counter()
        cfg, cut = family_config(arch)
        tag = f"[lm_families] {arch}"
        ffn = ("" if cfg.moe is None else
               f", MoE {cfg.moe.n_experts} experts top-{cfg.moe.top_k}"
               f"{' + shared' if cfg.moe.n_shared_experts else ''} "
               f"(capacity_factor {cfg.moe.capacity_factor:g})")
        ssm = ("" if cfg.ssm is None else
               f", ssm state {cfg.ssm.state_dim} head {cfg.ssm.head_dim} "
               f"chunk {cfg.ssm.chunk}")
        depth = (f"{cfg.n_layers} of {LM_FAMILY_LAYERS[arch][2]} layers, cut:"
                 f" {cut}" if cut else f"all {cfg.n_layers} layers")
        log(f"{tag}: {depth} ({cfg.n_groups} groups of "
            f"{'/'.join(cfg.block_pattern)}), d {cfg.d_model}, "
            f"{cfg.n_heads} heads, {cfg.n_kv_heads} kv heads, hd {cfg.hd}, "
            f"d_ff {cfg.d_ff}, vocab {cfg.vocab:,}{ffn}{ssm}, attn_impl "
            f"{cfg.attn_impl} (chunk {cfg.attn_chunk}); "
            f"{attn_per_group(cfg) * cfg.n_groups} flash_attention "
            f"launches a prefill")
        if arch in LM_FAMILY_NO_CHECK:
            checks = {}
            log(f"{tag} no fp32 checks: {LM_FAMILY_NO_CHECK[arch]}")
        else:
            checks = lm_checks(cfg, kernels["flash_attention"], dev, tag)
        torch.cuda.empty_cache()
        res = serve_lm(cfg, kernels, dev, tag, checks,
                       profile=("prefill",) if arch in LM_FAMILY_PROFILED
                       else ())
        res["seconds"] = time.perf_counter() - t0
        res["layers"] = cfg.n_layers
        log(f"{tag} {res['seconds']:.3f} s")
        out[arch] = res
    phase_s = time.perf_counter() - t_phase
    check(phase_s < LM_FAMILIES_LIMIT_S,
          f"[lm_families] took {phase_s:.1f} s, limit "
          f"{LM_FAMILIES_LIMIT_S:.0f} s")
    log(f"[lm_families] phase {phase_s:.3f} s (under "
        f"{LM_FAMILIES_LIMIT_S:.0f} s)")
    return {"models": out, "seconds": phase_s}


# ----------------------------------------------------------------------
# [sharded_lm]: the logical-axis mesh layer over a mesh stacked on the card
# ----------------------------------------------------------------------
def sharded_config(arch: str):
    """The model of [sharded_lm]: as [lm_families] serves it
    (`family_config`: the published config, chunked attention, llama4 cut
    to one layer), and the cut's reason."""
    return family_config(arch)


def with_ep_drops(fn, into: list):
    """`fn`, run with `layers._ep_route` wrapped so that each
    expert-parallel MoE call appends its dropped pairs per (data, expert)
    shard (a device tensor: no host sync) to `into`."""
    import torch

    from repro_torch.models import layers as L

    def run():
        real = L._ep_route

        def route(lay, idx, gates):
            out = real(lay, idx, gates)
            shard, se, _, _, keep, _ = out
            lost = ((se < lay.E_loc) & ~keep).long()
            into.append(torch.zeros(lay.n_dp * lay.n_ep, dtype=torch.long,
                                    device=se.device).index_add_(0, shard,
                                                                 lost))
            return out

        L._ep_route = route
        try:
            return fn()
        finally:
            L._ep_route = real
    return run


def under(mesh, fn):
    """`fn` run inside `axis_ctx(mesh, DEFAULT_RULES)`."""
    from repro_torch.distributed.sharding import DEFAULT_RULES, axis_ctx

    def run():
        with axis_ctx(mesh, DEFAULT_RULES):
            return fn()
    return run


def sharded_checks(cfg, mesh, dev) -> dict:
    """One MoE layer at the model's width, fp32 weights from seed 1 and
    fp32 tokens (SHARDED_BATCH x SHARDED_SEQ), no TF32: at capacity
    factor SHARDED_DROPLESS_CF (no pair dropped on either path) the EP
    output against `_moe_dense`'s, at the JAX EP test's tolerance
    (EP_TOL); at the config's capacity factor and at SHARDED_DROPPING_CF
    (where pairs drop) the stacked computation against the shard_map body
    run one shard at a time (`_moe_ep_loop`), its drops per shard, and
    its host syncs (none)."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models.params import init_params

    t0 = time.perf_counter()
    rtol, atol = EP_TOL
    gen = torch.Generator(device=dev).manual_seed(1)
    p = init_params(L.moe_template(cfg), gen, torch.float32, dev)
    x = torch.randn(SHARDED_BATCH, SHARDED_SEQ, cfg.d_model, generator=gen,
                    device=dev)
    T = SHARDED_BATCH * SHARDED_SEQ
    dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=SHARDED_DROPLESS_CF))
    ep_drops, dense_drops = [], []
    ep = under(mesh, with_ep_drops(lambda: L.moe(p, dropless, x), ep_drops))()
    dense = with_drops(lambda: L._moe_dense(p, dropless, x), dense_drops)()
    lost = int(ep_drops[0].sum()) + int(dense_drops[0])
    check(lost == 0, f"[sharded_lm] {lost} pairs dropped at capacity factor "
                     f"{SHARDED_DROPLESS_CF:g}")
    out = {"ep_vs_dense": close(ep, dense, atol, "EP MoE layer against "
                                "_moe_dense (dropless)", rtol=rtol)}
    del ep, dense
    loops = []
    for cf in (cfg.moe.capacity_factor, SHARDED_DROPPING_CF):
        at = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        drops: list = []
        (stacked, syncs) = count_syncs(under(mesh, with_ep_drops(
            lambda: L.moe(p, at, x), drops)))
        check(not syncs, f"[sharded_lm] the EP MoE layer made host syncs: "
                         f"{' '.join(syncs)}")
        lay = under(mesh, lambda: L._ep_layout(at, mesh, T))()
        loop = L._moe_ep_loop(p, at, x, lay)
        err = close(stacked, loop, atol, f"stacked EP against the per-shard "
                                         f"body at capacity factor {cf:g}",
                    rtol=rtol)
        loops.append({"capacity_factor": cf, "cap": lay.cap,
                      "max_abs_err": err,
                      "drops_per_shard": drops[0].tolist()})
        del stacked, loop
    out["stacked_vs_loop"] = loops
    torch.cuda.synchronize()
    log(f"[sharded_lm] checks, one MoE layer at d {cfg.d_model}, fp32, "
        f"{SHARDED_BATCH} x {SHARDED_SEQ} tokens, TF32 off: EP vs _moe_dense "
        f"at capacity factor {SHARDED_DROPLESS_CF:g} (0 pairs dropped on "
        f"either path) max abs err {out['ep_vs_dense']:.3e} (rtol {rtol}, "
        f"atol {atol}); the stacked computation vs the body shard by shard "
        + "; ".join(f"at capacity factor {c['capacity_factor']:g} (cap "
                    f"{c['cap']} a shard of {lay.T_loc} tokens) "
                    f"{c['max_abs_err']:.3e}, pairs dropped per (data, "
                    f"expert) shard {c['drops_per_shard']}" for c in loops)
        + f"; 0 host syncs ({time.perf_counter() - t0:.2f} s)")
    return out


def sharded_prefill(cfg, mesh, kernels: dict, dev, tag: str,
                    profile: bool = False) -> dict:
    """bf16 weights from seed 0; prefill_with_cache of SHARDED_BATCH x
    SHARDED_SEQ tokens under `axis_ctx(mesh, DEFAULT_RULES)` (cold, with
    its host syncs and its drops per layer and shard, then measured) and
    without it (the dense MoE path, its drops per layer).  Each prefill
    must run the EP path once per MoE layer and launch the tensor-core
    `flash_attention` once per attention layer.  Returns the numbers and
    the model, whose MoE layer inputs and outputs the caller may read
    through `captured` (the last EP prefill's, per layer); with
    `profile`, one more EP prefill under the profiler."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models.model import build_model

    n_attn = attn_per_group(cfg) * cfg.n_groups
    t0 = time.perf_counter()
    model = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                  dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab, (SHARDED_BATCH, SHARDED_SEQ),
                            generator=torch.Generator(device=dev).manual_seed(3),
                            device=dev, dtype=torch.int32)
    prefill = lambda: model.prefill_with_cache(  # noqa: E731
        tokens=prompts, cache_len=SHARDED_SEQ)
    captured: list = []
    real_moe = L.moe

    def keep_io(p, c, x):
        y = real_moe(p, c, x)
        captured.append((p, x, y))
        return y

    ep_drops: list = []
    ((logits, _), syncs), cold_s, cold = run_counted(kernels, lambda: count_syncs(
        under(mesh, with_ep_drops(prefill, ep_drops))))
    del logits
    calls: list = []
    L.moe = keep_io
    try:
        (logits, _), ep_s, launches = run_counted(
            kernels, under(mesh, with_ep_drops(prefill, calls)))
    finally:
        L.moe = real_moe
    n_moe = cfg.n_layers if cfg.moe else 0
    for got, n_ep in ((cold, len(ep_drops)), (launches, len(calls))):
        check(n_ep == n_moe, f"{tag} an EP prefill ran the expert-parallel "
                             f"path {n_ep} times, expected {n_moe}")
        check(got["flash_attention"] == n_attn
              and got["flash_attention.tensor_core"] == n_attn,
              f"{tag} an EP prefill launched flash_attention "
              f"{json.dumps(got)}, expected {n_attn} tensor-core")
    check(all(bool(torch.isfinite(row).all()) for row in logits),
          f"{tag} EP prefill logits not finite")
    del logits
    dense_drops: list = []
    (logits, _), dense_s, dense_launches = run_counted(
        kernels, with_drops(prefill, dense_drops))
    del logits
    ep_layer = torch.stack(ep_drops).sum(dim=1).tolist()
    dense_layer = torch.stack(dense_drops).tolist()
    pairs = SHARDED_BATCH * SHARDED_SEQ * cfg.moe.top_k
    log(f"{tag} bf16 prefill_with_cache {SHARDED_BATCH} x {SHARDED_SEQ} "
        f"tokens under {mesh_text(mesh)}: {ep_s:.4f} s ({cold_s:.4f} s cold; "
        f"init {init_s:.2f} s), dense path {dense_s:.4f} s; launches "
        f"{json.dumps(launches)}; {len(calls)} expert-parallel MoE calls; "
        f"{len(syncs)} host syncs in the cold one "
        f"{' '.join(sorted(set(syncs)))}")
    log(f"{tag} pairs dropped per layer at capacity factor "
        f"{cfg.moe.capacity_factor:g}, of {pairs:,}: EP {ep_layer} "
        f"(layer 0 per (data, expert) shard {ep_drops[0].tolist()}); dense "
        f"{dense_layer}")
    prof = None
    if profile:
        _, prof = profiled(under(mesh, prefill), top=8)
        log_profile(f"{tag} one EP prefill", prof)
    return {"profiled": prof,"model": model, "captured": captured, "prefill_s": ep_s,
            "cold_prefill_s": cold_s, "dense_prefill_s": dense_s,
            "launches": launches, "dense_launches": dense_launches,
            "ep_calls": len(calls), "prefill_syncs": len(syncs),
            "drops": {"ep": ep_layer, "dense": dense_layer,
                      "ep_layer0_per_shard": ep_drops[0].tolist(),
                      "pairs": pairs,
                      "capacity_factor": cfg.moe.capacity_factor}}


def log_profile(tag: str, prof: dict) -> None:
    log(f"{tag} (profiled): wall {prof['wall_ms']:.3f} ms, device busy "
        f"{prof['busy_ms']:.3f} ms ({prof['busy_ms'] / prof['wall_ms']:.1%}) "
        f"in {prof['events']} device events; flash_attention "
        f"{prof['flash_attn_ms']:.3f} ms")
    for nm, ms in prof["top"]:
        log(f"{tag}   {ms:.4f} ms  {nm[:100]}")


def mesh_text(mesh) -> str:
    return "(" + ", ".join(f"{a} {n}" for a, n in mesh.shape.items()) + ")"


def sharded_train(cfg, mesh, kernels: dict, dev) -> dict:
    """(b) SHARDED_TRAIN_STEPS train steps of `cfg` in fp32, remat full, no
    TF32, through `make_train_step(model, tc, mesh, DEFAULT_RULES)` on
    seeded batches of SHARDED_BATCH x SHARDED_SEQ tokens: each step runs
    the EP path twice a MoE layer (forward and recompute) and launches the
    CUDA-core `flash_attention` twice a layer; the loss finite and
    falling, every gradient finite.  (c) The state after step
    SHARDED_SAVE_AT is saved by `TrainSupervisor`, then
    `resume_or_init(shardings=train_state_shardings(...))` restores it
    onto the mesh SHARDED_RESTORE_MESH: every leaf bitwise equal to the
    saved state; the next step from it through the same step function
    gives the uninterrupted run's loss within SHARDED_RESUME_RTOL, and
    one through the restore mesh's step is printed beside it."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.distributed.fault import TrainSupervisor
    from repro_torch.distributed.sharding import DEFAULT_RULES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.model import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig

    fa = kernels["flash_attention"]
    n_launch = 2 * attn_per_group(cfg) * cfg.n_groups
    n_ep = 2 * cfg.n_layers
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    tc = TS.TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=1,
                                      total_steps=SHARDED_TRAIN_STEPS),
                        remat="full")
    state = TS.init_train_state(model, tc, torch.Generator(
        device=dev).manual_seed(0))
    step = TS.make_train_step(model, tc, mesh, DEFAULT_RULES)
    gen = torch.Generator(device=dev).manual_seed(4)
    batches = []
    for _ in range(SHARDED_TRAIN_STEPS):
        t = torch.randint(0, cfg.vocab, (SHARDED_BATCH, SHARDED_SEQ),
                          generator=gen, device=dev, dtype=torch.int32)
        batches.append({"tokens": t, "labels": torch.roll(t, -1, 1)})
    finite = []
    real_clip = TS.clip_by_global_norm

    def recording_clip(grads, max_norm):
        finite.append(torch.stack([torch.isfinite(g).all()
                                   for _, g in tree_leaves(grads)]).all())
        return real_clip(grads, max_norm)

    ckpt = ROOT / SHARDED_CKPT
    shutil.rmtree(ckpt, ignore_errors=True)
    sup = TrainSupervisor(str(ckpt), save_every=SHARDED_SAVE_AT, keep=1)
    losses, step_s, per_step, saved = [], [], [], None
    TS.clip_by_global_norm = recording_clip
    try:
        for i, batch in enumerate(batches):
            calls: list = []
            (state, metrics), dt, got = run_counted(
                kernels, with_ep_drops(lambda: step(state, batch), calls))
            losses.append(float(metrics["loss"]))
            step_s.append(dt)
            per_step.append({**got, "ep_calls": len(calls)})
            if i + 1 == SHARDED_SAVE_AT:
                saved = state
                t0 = time.perf_counter()
                sup.maybe_save(i + 1, state)
                save_s = time.perf_counter() - t0
    finally:
        TS.clip_by_global_norm = real_clip
    peak = torch.cuda.max_memory_allocated()
    for got in per_step:
        check(got["flash_attention"] == n_launch
              and got["flash_attention.cuda_core"] == n_launch
              and got["ep_calls"] == n_ep,
              f"[sharded_lm] a train step made {json.dumps(got)}, expected "
              f"{n_launch} CUDA-core flash_attention launches and {n_ep} "
              f"expert-parallel MoE calls")
    check(all(np.isfinite(losses)), f"[sharded_lm] train losses {losses}")
    check(losses[-1] < losses[0], f"[sharded_lm] the loss did not fall: "
                                  f"{losses}")
    check(bool(torch.stack(finite).all()), "[sharded_lm] a gradient is not "
                                           "finite")
    tokens = SHARDED_BATCH * SHARDED_SEQ
    med = sorted(step_s[1:])[len(step_s[1:]) // 2]
    state_bytes = sum(x.nbytes for _, x in tree_leaves(saved))
    log(f"[sharded_lm] {cfg.name} train under {mesh_text(mesh)}, fp32 state "
        f"of {state_bytes / 2**30:.2f} GiB, remat full, TF32 off, "
        f"{SHARDED_BATCH} x {SHARDED_SEQ} tokens: {len(losses)} steps "
        f"{' '.join(f'{t:.4f}' for t in step_s)} s (median after the first "
        f"{med:.4f} s, {tokens / med:,.0f} tokens/s); loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}; launches a step "
        f"{json.dumps(per_step[-1])}; every gradient finite; peak device "
        f"memory {peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB held by "
        f"the earlier phases)")

    # where the time of one step goes: one more step, profiled
    _, prof = profiled(lambda: step(state, batches[-1]), top=8)
    log_profile("[sharded_lm] one train step", prof)

    # (c) restore onto another mesh shape
    del state
    mesh2 = make_mesh(*SHARDED_RESTORE_MESH)
    t0 = time.perf_counter()
    restored, at = sup.resume_or_init(
        lambda: fail("[sharded_lm] no checkpoint to resume from"),
        target_shapes=TS.train_state_shapes(model, tc, torch.float32),
        shardings=TS.train_state_shardings(model, tc, mesh2, DEFAULT_RULES))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(at == SHARDED_SAVE_AT, f"[sharded_lm] resumed at step {at}")
    pairs = list(zip(tree_leaves(saved), tree_leaves(restored)))
    check(all(pa == pb and a.dtype == b.dtype and a.device == b.device
              for (pa, a), (pb, b) in pairs),
          "[sharded_lm] the restored state's leaves differ in path, dtype "
          "or device from the saved state's")
    bits = lambda t: t.reshape(-1).view(torch.uint8)  # noqa: E731
    check(all(torch.equal(bits(a), bits(b)) for (_, a), (_, b) in pairs),
          "[sharded_lm] a restored leaf differs bitwise from the saved one")
    del saved, pairs
    nxt = batches[SHARDED_SAVE_AT]
    want = losses[SHARDED_SAVE_AT]
    drops_same, drops_new = [], []
    _, m_same = with_ep_drops(lambda: step(restored, nxt), drops_same)()
    resumed = float(m_same["loss"])
    check(abs(resumed - want) <= SHARDED_RESUME_RTOL * abs(want),
          f"[sharded_lm] the resumed step's loss {resumed!r} differs from "
          f"the uninterrupted run's {want!r} by more than "
          f"{SHARDED_RESUME_RTOL:g} of it")
    del m_same
    _, m_new = with_ep_drops(lambda: TS.make_train_step(
        model, tc, mesh2, DEFAULT_RULES)(restored, nxt), drops_new)()
    on_new = float(m_new["loss"])
    check(np.isfinite(on_new), f"[sharded_lm] loss {on_new} on the restore "
                               f"mesh")
    lost = [int(torch.stack(d[:cfg.n_layers]).sum()) for d in (drops_same,
                                                                drops_new)]
    log(f"[sharded_lm] state after step {SHARDED_SAVE_AT} saved in "
        f"{save_s:.2f} s, restored by TrainSupervisor.resume_or_init("
        f"shardings=train_state_shardings(...)) on {mesh_text(mesh2)} in "
        f"{restore_s:.2f} s: every leaf bitwise equal to the saved one; the "
        f"next step's loss from it {resumed:.6f} against the uninterrupted "
        f"{want:.6f} (rel diff {abs(resumed - want) / abs(want):.2e}, tol "
        f"{SHARDED_RESUME_RTOL:g}); through the {mesh_text(mesh2)} step "
        f"{on_new:.6f} (pairs dropped in its forward {lost[1]:,} against "
        f"{lost[0]:,} on {mesh_text(mesh)}; not held to the tolerance: each "
        f"shard's capacity follows its token block, so its drops may "
        f"differ)")
    del restored, m_new
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"losses": losses, "step_s": step_s, "median_step_s": med,
            "tokens_per_s": tokens / med, "peak_gib": peak / 2**30,
            "launches_per_step": per_step[-1]["flash_attention"],
            "ep_calls_per_step": per_step[-1]["ep_calls"],
            "state_gib": state_bytes / 2**30, "save_s": save_s,
            "restore_s": restore_s, "resumed_loss": resumed,
            "uninterrupted_loss": want, "restore_mesh_loss": on_new,
            "restore_mesh_drops": lost[1], "mesh_drops": lost[0],
            "profiled_step": prof}


def sharded_lm_phase(kernels: dict, dev) -> dict:
    """The mesh layer of the port on one card: granite-moe-1b at its
    published width and depth over `make_mesh(SHARDED_MESH)` stacked on
    the card with DEFAULT_RULES — (a) `sharded_checks`, then the bf16 EP
    prefill (`sharded_prefill`); (b) and (c) `sharded_train`; (d)
    llama4-maverick cut to one layer (LM_FAMILY_LAYERS' cut), a bf16 EP
    prefill at capacity factor SHARDED_DROPLESS_CF (the shared expert
    split over the expert shards) whose MoE output is held against
    `_moe_dense` on the same input within LLAMA_EP_TOL.  The phase must
    finish within SHARDED_LM_LIMIT_S."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(*SHARDED_MESH)
    cfg, _ = sharded_config(SHARDED_ARCH)
    tag = f"[sharded_lm] {cfg.name}"
    log(f"{tag}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, d_ff {cfg.d_ff}, "
        f"capacity factor {cfg.moe.capacity_factor:g}; mesh "
        f"{mesh_text(mesh)} stacked on the card, DEFAULT_RULES")
    out = {"checks": sharded_checks(cfg, mesh, dev)}
    torch.cuda.empty_cache()
    pre = sharded_prefill(cfg, mesh, kernels, dev, tag, profile=True)
    del pre["model"], pre["captured"]
    out["prefill"] = pre
    torch.cuda.empty_cache()
    out["train"] = sharded_train(cfg, mesh, kernels, dev)

    # (d) llama4: the shared expert split over the expert shards
    cfg4, cut = sharded_config(SHARDED_SHARED_ARCH)
    cfg4 = dataclasses.replace(cfg4, moe=dataclasses.replace(
        cfg4.moe, capacity_factor=SHARDED_DROPLESS_CF))
    tag4 = f"[sharded_lm] {cfg4.name}"
    log(f"{tag4}: {cfg4.n_layers} layer(s), cut: {cut}; {cfg4.moe.n_experts} "
        f"experts top-{cfg4.moe.top_k} + {cfg4.moe.n_shared_experts} shared, "
        f"capacity factor {SHARDED_DROPLESS_CF:g}")
    pre4 = sharded_prefill(cfg4, mesh, kernels, dev, tag4)
    check(sum(pre4["drops"]["ep"]) == 0 and sum(pre4["drops"]["dense"]) == 0,
          f"{tag4} pairs dropped at capacity factor {SHARDED_DROPLESS_CF:g}: "
          f"{pre4['drops']}")
    p, x, ep = pre4["captured"][-1]
    dense = L._moe_dense(p, cfg4, x)
    ref_max = float(dense.abs().max())
    atol = LLAMA_EP_TOL[0] * ref_max
    err = close(ep, dense, atol, f"{tag4} EP MoE layer against _moe_dense",
                rtol=LLAMA_EP_TOL[1])
    share = limit_share(ep, dense, atol, LLAMA_EP_TOL[1])[1]
    log(f"{tag4} EP MoE layer output against _moe_dense on the same input "
        f"(bf16): max abs err {err:.3e}, {share:.3f} of the limit 2**-6 x "
        f"{ref_max:.4f} (max |ref|) + 2**-7 |ref|")
    del pre4["model"], pre4["captured"], p, x, ep, dense
    pre4.update(ep_vs_dense=err, ep_vs_dense_share=share)
    out["shared_expert"] = pre4
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    check(phase_s < SHARDED_LM_LIMIT_S,
          f"[sharded_lm] took {phase_s:.1f} s, limit "
          f"{SHARDED_LM_LIMIT_S:.0f} s")
    log(f"[sharded_lm] phase {phase_s:.3f} s (under "
        f"{SHARDED_LM_LIMIT_S:.0f} s)")
    out["seconds"] = phase_s
    return out


def encdec_config():
    """The served encoder-decoder: whisper-base as `configs/whisper_base.py`
    publishes it (6 encoder + 6 decoder layers, d 512, 8 heads, hd 64,
    vocabulary 51,865) with the chunked attention path at a chunk of
    ENCDEC_PROMPT, so that the prompt's decoder self-attention meets the
    path's `S % attn_chunk == 0` rule and runs the kernel."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(ENCDEC_ARCH), attn_impl="chunked",
                               attn_chunk=ENCDEC_PROMPT)


def train_config():
    """The trained model: qwen2-vl-2b as published (28 layers, d 1536, 12
    heads, 2 kv heads, hd 128, vocabulary 151,936, M-RoPE) with the
    chunked attention path (chunk 1,024: S = 2,048 runs the kernel)."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(TRAIN_ARCH), attn_impl="chunked")


def encdec_attention_case():
    """whisper-base's decoder self-attention in the [lm_encdec] prefill, as
    a sweep case (B, S, H, Hkv, hd, window, dtype)."""
    import torch

    cfg = encdec_config()
    return (LM_BATCH, ENCDEC_PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.hd, 0,
            torch.bfloat16)


def train_attention_case():
    """qwen2-vl-2b's attention in the [train] forward (fp32 state)."""
    import torch

    cfg = train_config()
    return (TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.hd, 0,
            torch.float32)


def sharded_train_attention_case():
    """granite-moe's attention in the [sharded_lm] train step (fp32 state,
    SHARDED_BATCH x SHARDED_SEQ tokens)."""
    import torch

    cfg, _ = sharded_config(SHARDED_ARCH)
    return (SHARDED_BATCH, SHARDED_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            0, torch.float32)


def attention_backward_bound(B: int, S: int, H: int, Hkv: int, hd: int,
                             window: int) -> tuple[float, str]:
    """Least time for the fp32 backward in ms, and what bounds it: read q,
    k, v, o, dO and write dq, dk, dv once at the card's memory rate, or do
    10*hd flops per unmasked pair per head (the scores again, dV, dP, dQ,
    dK) at the fp32 CUDA-core peak; the larger."""
    nbytes = (4 * B * S * H * hd + 4 * B * S * Hkv * hd) * 4
    flops = 10 * hd * attention_pairs(S, window) * B * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernel_phase_attention_backward(ops, ref, fa, dev) -> dict:
    """The gradient of `flash_attention` (its autograd Function: the kernel
    forward, then `ops.attention_backward` in torch ops) against autograd
    of the plain version, in fp32 at the fp32 tolerance, at the training
    shape (window 0) and at gemma3's local layers (B=1, S=2,048, H=16,
    Hkv=8, hd 256, window 1,024); the backward's ms beside the
    forward's."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(9)
    atol, rtol = ATTN_TOL["float32"]
    B, S, H, Hkv, hd, _, _ = train_attention_case()
    out = {}
    for label, (B, S, H, Hkv, hd, w) in (
            ("train", (B, S, H, Hkv, hd, 0)),
            ("gemma3_local", GEMMA_LOCAL_GRAD)):
        q, k, v = (x.requires_grad_() for x in attention_inputs(
            gen, B, S, H, Hkv, hd, torch.float32, dev))
        dout = torch.randn(q.shape, generator=gen, device=dev)
        before = fa.launches
        got = torch.autograd.grad(ops.flash_attention(q, k, v, w), (q, k, v),
                                  dout)
        torch.cuda.synchronize()
        check(fa.launches == before + 1, "the Function's forward did not "
                                         "launch the kernel")
        want = torch.autograd.grad(ref.flash_attention_ref(q, k, v, w),
                                   (q, k, v), dout)
        margin: list = []
        err = max(close(a, b, atol, f"d{n} of flash_attention at {label} "
                        f"B={B} S={S} H={H}/{Hkv} hd={hd} window {w}",
                        rtol=rtol, margin=margin)
                  for n, a, b in zip("qkv", got, want))
        del got, want
        qd, kd, vd = (x.detach() for x in (q, k, v))
        o = fa.flash_attention_cuda(qd, kd, vd, w)
        t = {"max_abs_err": err, "share_of_limit": max(margin),
             "forward_ms": cuda_ms(lambda: ops.flash_attention(qd, kd, vd, w),
                                   5, 1),
             "backward_ms": cuda_ms(lambda: ops.attention_backward(
                 qd, kd, vd, o, dout, w), 3, 1)}

        def plain_backward():
            x = [y.detach().requires_grad_() for y in (q, k, v)]
            torch.autograd.grad(ref.flash_attention_ref(*x, w), x, dout)

        t["plain_backward_ms"] = cuda_ms(plain_backward, 3, 1)
        t["bound_ms"], t["bound_by"] = attention_backward_bound(
            B, S, H, Hkv, hd, w)
        out[label] = t
        log(f"[kernel] flash_attention gradient at {label} B={B} S={S} "
            f"H={H}/{Hkv} hd={hd} fp32 window {w}: dq, dk, dv against "
            f"autograd of the plain version, max abs err {err:.3e} "
            f"({max(margin):.3f} of the limit {atol} + {rtol} |ref|); "
            f"forward (kernel) {t['forward_ms']:.4f} ms, backward (torch "
            f"ops, blocks of {ops.ATTN_BWD_BLOCK}) {t['backward_ms']:.4f} ms"
            f", plain version's autograd backward {t['plain_backward_ms']:.4f}"
            f" ms, backward bound {t['bound_ms']:.4f} ms by {t['bound_by']} "
            f"({t['bound_ms'] / t['backward_ms']:.1%} of it)")
        del q, k, v, dout, o
        torch.cuda.empty_cache()
    return out


def encdec_checks(cfg, fa, dev) -> dict:
    """At whisper-base's full width and depth in fp32 (weights from seed
    1, fp32 frames, no TF32): the chunked forward, whose decoder
    self-attention is the kernel, against the dense forward (3e-3); then
    a kernel prefill of ENCDEC_PROMPT tokens and LM_CHECK_DECODE
    teacher-forced decode steps against the dense forward (3e-3 for the
    prefill, 3e-2 for decode: the cache is bf16)."""
    import torch

    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    S, n_dec = ENCDEC_PROMPT, LM_CHECK_DECODE
    chunked = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(1), dtype=torch.float32)
    dense = build_model(dataclasses.replace(cfg, attn_impl="dense")
                        ).load_params(chunked.params)
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (LM_CHECK_BATCH, S + n_dec),
                         generator=gen, device=dev, dtype=torch.int32)
    frames = torch.randn((LM_CHECK_BATCH, ENCDEC_FRAMES, cfg.encoder.d_input),
                         generator=gen, device=dev)
    t0 = time.perf_counter()
    zero_counts([fa])
    a = chunked.forward(tokens=toks[:, :S], enc_frames=frames)
    launched = fa.launches
    b = dense.forward(tokens=toks[:, :S], enc_frames=frames)
    check(launched == cfg.n_layers
          and fa.design_launches["cuda_core"] == launched,
          f"the chunked fp32 forward launched flash_attention {launched} "
          f"times ({json.dumps(fa.design_launches)}), expected {cfg.n_layers}")
    check(fa.launches == launched, "the dense forward launched the kernel")
    out = {"forward": close(a, b, 3e-3, "chunked (kernel) forward against "
                                        "the dense forward")}
    del a, b
    full = dense.forward(tokens=toks, enc_frames=frames)
    logits0, cache = chunked.prefill_with_cache(
        tokens=toks[:, :S], enc_frames=frames, cache_len=S + n_dec)
    out["prefill"] = close(logits0, full[:, :S], 3e-3,
                           "kernel prefill logits against the dense forward")
    del logits0
    out["decode"] = 0.0
    for t in range(S, S + n_dec):
        logits, cache = chunked.decode_step(toks[:, t:t + 1], t, cache)
        out["decode"] = max(out["decode"], close(
            logits[:, 0], full[:, t], 3e-2,
            f"teacher-forced decode at position {t} against the forward"))
    torch.cuda.synchronize()
    log(f"[lm_encdec] checks at full width and depth, fp32, B="
        f"{LM_CHECK_BATCH}, {ENCDEC_FRAMES} frames, S={S}: chunked "
        f"(CUDA-core kernel, {launched} launches) vs dense forward max abs "
        f"err {out['forward']:.3e} (tol 3e-3); kernel prefill vs dense "
        f"forward {out['prefill']:.3e} (tol 3e-3); {n_dec} teacher-forced "
        f"decode steps vs the forward {out['decode']:.3e} (tol 3e-2) "
        f"({time.perf_counter() - t0:.2f} s)")
    return out


def encdec_phase(kernels: dict, dev) -> dict:
    """Serving of whisper-base at its published width and depth (bf16
    weights from seed 0, attn_impl="chunked"): 4 requests of ENCDEC_FRAMES
    encoder frames and ENCDEC_PROMPT prompt tokens; the encoder alone,
    then prefill_with_cache (cold with its host syncs counted, then
    measured): one tensor-core `flash_attention` launch per decoder layer,
    none in the encoder; ENCDEC_DECODE greedy decode steps (no launch);
    BatchedServer(batch=4, max_new=8).run(16).  Before it, the fp32
    checks at the same width and depth."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model
    from repro_torch.serve.serve_step import (BatchedServer, ServeConfig,
                                              make_serve_step)

    t_phase = time.perf_counter()
    cfg = encdec_config()
    fa = kernels["flash_attention"]
    log(f"[lm_encdec] {cfg.name}: {cfg.encoder.n_layers} encoder + "
        f"{cfg.n_layers} decoder layers, d {cfg.d_model}, {cfg.n_heads} "
        f"heads, {cfg.n_kv_heads} kv heads, hd {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab:,}, encoder frames of {cfg.encoder.d_input}, "
        f"attn_impl {cfg.attn_impl}; cut: attn_chunk {cfg.attn_chunk} (the "
        f"published config's 1,024 would leave the {ENCDEC_PROMPT}-token "
        f"prompt on the dense path: the chunked path needs S % attn_chunk "
        f"== 0); {cfg.n_layers} flash_attention launches a prefill")
    checks = encdec_checks(cfg, fa, dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                  dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(3)
    frames = torch.randn((LM_BATCH, ENCDEC_FRAMES, cfg.encoder.d_input),
                         generator=gen, device=dev, dtype=torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, ENCDEC_PROMPT),
                            generator=gen, device=dev, dtype=torch.int32)

    counted = functools.partial(run_counted, kernels)

    enc, _, _ = counted(lambda: T.encode(cfg, model.params, frames))
    enc, encode_s, enc_launches = counted(
        lambda: T.encode(cfg, model.params, frames))
    check(enc_launches["flash_attention"] == 0,
          f"the encoder launched flash_attention {json.dumps(enc_launches)}")
    check(tuple(enc.shape) == (LM_BATCH, ENCDEC_FRAMES, cfg.d_model)
          and bool(torch.isfinite(enc).all()), "encoder output")
    del enc
    prefill = lambda: model.prefill_with_cache(  # noqa: E731
        tokens=prompts, enc_frames=frames, cache_len=ENCDEC_CACHE)
    ((logits, cache), syncs), cold_s, cold_launches = counted(
        lambda: count_syncs(prefill))
    del logits, cache
    (logits, cache), prefill_s, launches = counted(prefill)
    for got in (cold_launches, launches):
        check(got["flash_attention"] == cfg.n_layers
              and got["flash_attention.tensor_core"] == cfg.n_layers,
              f"a prefill launched flash_attention {json.dumps(got)}, "
              f"expected {cfg.n_layers} of the tensor-core design (one per "
              f"decoder self-attention, none in the encoder)")
    check(tuple(logits.shape) == (LM_BATCH, ENCDEC_PROMPT, cfg.vocab_padded)
          and all(bool(torch.isfinite(row).all()) for row in logits),
          "prefill logits not finite or misshapen")
    check(tuple(cache["0:attn"]["xk"].shape)
          == (cfg.n_groups, LM_BATCH, ENCDEC_FRAMES, cfg.n_kv_heads, cfg.hd),
          f"cross-attention cache {tuple(cache['0:attn']['xk'].shape)}")
    log(f"[lm_encdec] encode {LM_BATCH} x {ENCDEC_FRAMES} frames: "
        f"{encode_s:.4f} s (launches {json.dumps(enc_launches)}); "
        f"prefill_with_cache (encoder included) of {LM_BATCH} x "
        f"{ENCDEC_PROMPT} tokens, cache {ENCDEC_CACHE}: {prefill_s:.4f} s "
        f"({cold_s:.4f} s cold); launches {json.dumps(launches)}; "
        f"{len(syncs)} host syncs in the cold one "
        f"{' '.join(sorted(set(syncs)))}")

    step = make_serve_step(model, ServeConfig(cache_len=ENCDEC_CACHE))
    tok = torch.argmax(logits[:, -1, :].float(), dim=-1)[:, None].to(
        torch.int32)
    del logits

    def decode():
        nonlocal tok, cache
        out = [tok]
        for i in range(ENCDEC_DECODE):
            tok, cache = step(cache, tok, ENCDEC_PROMPT + i)
            out.append(tok)
        return torch.cat(out, dim=1)

    toks, decode_s, dec_launches = counted(decode)
    check(dec_launches["flash_attention"] == 0,
          f"decode launched flash_attention {json.dumps(dec_launches)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "a decoded token lies outside [0, vocab)")
    log(f"[lm_encdec] {ENCDEC_DECODE} greedy decode steps from position "
        f"{ENCDEC_PROMPT} (cross-attention over {ENCDEC_FRAMES} frames): "
        f"{decode_s * 1e3 / ENCDEC_DECODE:.3f} ms/step, "
        f"{LM_BATCH * ENCDEC_DECODE / decode_s:,.1f} tokens/s; launches "
        f"{json.dumps(dec_launches)}; request 0 {toks[0, :8].tolist()}...")
    del cache, toks
    srv = BatchedServer(model, ServeConfig(cache_len=ENCDEC_CACHE),
                        batch=LM_BATCH, eos_id=cfg.vocab,
                        max_new=LM_SERVE_MAX_NEW)
    done, serve_s, srv_launches = counted(lambda: srv.run(LM_SERVE_STEPS))
    want = LM_BATCH * LM_SERVE_STEPS // LM_SERVE_MAX_NEW
    check(len(done) == want and all(len(r) == LM_SERVE_MAX_NEW
                                    for r in done)
          and all(0 <= t < cfg.vocab for seq in done for t in seq),
          f"BatchedServer finished {len(done)} requests, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[lm_encdec] BatchedServer(batch={LM_BATCH}, max_new="
        f"{LM_SERVE_MAX_NEW}).run({LM_SERVE_STEPS}) (a zero cross-attention "
        f"cache of 8 encoder positions): {len(done)} requests in "
        f"{serve_s:.3f} s; launches {json.dumps(srv_launches)}; peak device "
        f"memory {peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB held by the "
        f"earlier phases)")
    del srv, model
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"[lm_encdec] phase {phase_s:.3f} s")
    return {"launches": launches, "encode_s": encode_s,
            "prefill_s": prefill_s, "cold_prefill_s": cold_s,
            "decode_ms": decode_s * 1e3 / ENCDEC_DECODE,
            "prefill_syncs": len(syncs), "peak_gib": peak / 2**30,
            "requests": len(done), "checks": checks, "seconds": phase_s}


def train_grad_check(cfg, fa, dev) -> dict:
    """At one group (one layer) of `cfg`'s width in fp32 (seed 1, no
    TF32, remat "full"): the gradients of a chunked step (the kernel
    forward, twice: the forward and its recompute; the backward in torch
    ops) against the dense step's, leaf for leaf at 1e-3."""
    import torch

    from repro_torch.models.model import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              value_and_grad)

    torch.backends.cuda.matmul.allow_tf32 = False
    one = dataclasses.replace(cfg, n_layers=len(cfg.block_pattern))
    chunked = build_model(one)
    dense = build_model(dataclasses.replace(one, attn_impl="dense"))
    tc = TrainConfig(remat="full")
    params = init_train_state(chunked, tc, torch.Generator(
        device=dev).manual_seed(1))["params"]
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (TRAIN_CHECK_BATCH, TRAIN_SEQ + 1),
                         generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    t0 = time.perf_counter()
    zero_counts([fa])
    lc, gc = value_and_grad(chunked, params, batch, tc)
    torch.cuda.synchronize()
    launched = fa.launches
    check(launched == 2 * one.n_layers
          and fa.design_launches["cuda_core"] == launched,
          f"a one-layer chunked fp32 step launched flash_attention "
          f"{json.dumps(fa.design_launches)}, expected {2 * one.n_layers} "
          f"(the forward and its recompute)")
    ld, gd = value_and_grad(dense, params, batch, tc)
    err = {"loss": close(lc, ld, 1e-3, "chunked loss against dense")}
    dense_g = dict(tree_leaves(gd))
    err["grads"] = max(close(g, dense_g[path], 1e-3,
                             f"chunked gradient of {'/'.join(path)} against "
                             f"the dense step's")
                       for path, g in tree_leaves(gc))
    del gc, gd, dense_g, params
    torch.cuda.synchronize()
    log(f"[train] check at {TRAIN_ARCH}'s width, one layer, fp32, B="
        f"{TRAIN_CHECK_BATCH} S={TRAIN_SEQ}, remat full: chunked step "
        f"({launched} CUDA-core launches) vs dense step, loss "
        f"{err['loss']:.3e}, gradients max abs err {err['grads']:.3e} (tol "
        f"1e-3) ({time.perf_counter() - t0:.2f} s)")
    return err


def train_cli(steps: int) -> tuple[str, float]:
    """`python -m repro_torch.launch.train` on the card as a subprocess
    (whisper-base at full width); its stdout and seconds.  Fails unless
    it exits 0 and prints `done`."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI,
         "--steps", str(steps)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    dt = time.perf_counter() - t0
    check(res.returncode == 0 and "done" in res.stdout.splitlines(),
          f"the train CLI (--steps {steps}) exited {res.returncode}: "
          f"{res.stdout[-1500:]} {res.stderr[-1500:]}")
    return res.stdout, dt


def train_phase(kernels: dict, dev, session) -> dict:
    """Training on the card. (a) qwen2-vl-2b at its published width and
    depth: an fp32 train state from `init_train_state` (seed 0),
    attn_impl="chunked", remat="full", no TF32; batches of TRAIN_BATCH x
    TRAIN_SEQ tokens from `RDFTokenPipeline` over the session's tuned
    executor; TRAIN_STEPS steps, each launching the CUDA-core
    `flash_attention` twice a layer (the forward and its recompute);
    the loss finite and falling, a nonzero gradient on every layer's
    `attn/wq`.  Before it, `train_grad_check`.  (b) the train CLI as a
    subprocess on whisper-base, then again over its checkpoint, which
    must resume."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.data.pipeline import PipelineConfig, RDFTokenPipeline
    from repro_torch.models.model import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig

    t_phase = time.perf_counter()
    fa = kernels["flash_attention"]
    cfg = train_config()
    n_launch = 2 * attn_per_group(cfg) * cfg.n_groups
    log(f"[train] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads, {cfg.n_kv_heads} kv heads, hd {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab:,}, {cfg.param_count():,} parameters;"
        f" attn_impl {cfg.attn_impl} (chunk {cfg.attn_chunk}), remat full, "
        f"fp32, TF32 off; {n_launch} flash_attention launches a step")
    checks = train_grad_check(cfg, fa, dev)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    pipe = iter(RDFTokenPipeline(session.executor, PipelineConfig(
        seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, vocab=cfg.vocab)))
    pipe_s = time.perf_counter() - t0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    tc = TS.TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=1,
                                      total_steps=TRAIN_STEPS), remat="full")
    t0 = time.perf_counter()
    state = TS.init_train_state(model, tc, torch.Generator(
        device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = TS.make_train_step(model, tc)
    wq_nonzero = []
    real_clip = TS.clip_by_global_norm

    def recording_clip(grads, max_norm):
        wq = grads["groups"]["0:attn"]["attn"]["wq"]
        wq_nonzero.append((wq != 0).flatten(1).any(dim=1))
        return real_clip(grads, max_norm)

    losses, step_s, per_step = [], [], []
    held = 0
    TS.clip_by_global_norm = recording_clip
    try:
        for _ in range(TRAIN_STEPS):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(pipe).items()}
            held = held or sum(x.nbytes for _, x in tree_leaves(
                {"state": state, "batch": batch}))
            zero_counts(kernels.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per_step.append({"flash_attention": fa.launches,
                             **{f"flash_attention.{d}": n
                                for d, n in fa.design_launches.items()}})
    finally:
        TS.clip_by_global_norm = real_clip
    peak = torch.cuda.max_memory_allocated()
    fed = sorted(batch)
    for got in per_step:
        check(got["flash_attention"] == n_launch
              and got["flash_attention.cuda_core"] == n_launch,
              f"a train step launched flash_attention {json.dumps(got)}, "
              f"expected {n_launch} (CUDA-core: fp32)")
    check(all(np.isfinite(losses)), f"train losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    nonzero = torch.stack(wq_nonzero).all(dim=0)
    check(bool(nonzero.all()), f"layers with an all-zero attn/wq gradient: "
                               f"{(~nonzero).nonzero().flatten().tolist()}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = sorted(step_s[1:])
    med = steady[len(steady) // 2]
    log(f"[train] RDFTokenPipeline over the session's executor: "
        f"{pipe_s:.3f} s; init {init_s:.3f} s; {TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens: step s "
        f"{' '.join(f'{t:.4f}' for t in step_s)} (median after the first "
        f"{med:.4f} s, {tokens / med:,.0f} tokens/s); loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}; launches a step "
        f"{json.dumps(per_step[-1])}; every layer's attn/wq gradient "
        f"nonzero; peak device memory {peak / 2**30:.2f} GiB "
        f"({base / 2**30:.2f} GiB held by the earlier phases)")
    # where the time of one step goes: one more step, profiled
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()}
    (state, _), prof = profiled(lambda: step(state, batch), top=8)
    log(f"[train] one step (profiled): wall {prof['wall_ms']:.1f} ms, device "
        f"busy {prof['busy_ms']:.1f} ms ({prof['busy_ms'] / prof['wall_ms']:.1%}"
        f") in {prof['events']} device events; flash_attention "
        f"{prof['flash_attn_ms']:.3f} ms ({prof['flash_attn_ms'] / max(prof['busy_ms'], 1e-9):.1%} of busy)")
    for nm, ms in prof["top"]:
        log(f"[train]   {ms:.4f} ms  {nm[:100]}")
    del state, model, pipe, wq_nonzero, nonzero, batch
    torch.cuda.empty_cache()

    shutil.rmtree(ROOT / TRAIN_CKPT, ignore_errors=True)
    cli = {}
    for steps in TRAIN_CLI_STEPS:
        out, dt = train_cli(steps)
        cli[steps] = dt
        lines = [ln for ln in out.splitlines() if ln.startswith(
            ("arch=", "step", "resumed", "done"))]
        log(f"[train] CLI --steps {steps} ({dt:.3f} s): " + " | ".join(lines))
        if steps == TRAIN_CLI_STEPS[1]:
            check(f"resumed from step {TRAIN_CLI_STEPS[0]}"
                  in out.splitlines(), "the second CLI run did not resume "
                                       f"from step {TRAIN_CLI_STEPS[0]}")
    phase_s = time.perf_counter() - t_phase
    log(f"[train] phase {phase_s:.3f} s")
    return {"launches_per_step": per_step[-1]["flash_attention"],
            "step_s": step_s, "median_step_s": med,
            "tokens_per_s": tokens / med, "losses": losses,
            "peak_gib": peak / 2**30, "pipeline_s": pipe_s,
            "held_bytes": held, "peak_bytes": peak - base,
            "batch_keys": fed,
            "profiled_step": prof,
            "init_s": init_s, "checks": checks,
            "cli_s": {str(k): v for k, v in cli.items()},
            "seconds": phase_s}


# ----------------------------------------------------------------------
# [dryrun]: the dry-run tooling on `meta`, held against the card
# ----------------------------------------------------------------------
def dryrun_cell(cell: tuple) -> dict:
    """One cell of the sweep, in a worker process: `run_audit` (the whole
    step traced on `meta`, then the per-group corrected roofline), its
    artifact under DRYRUN_ART, and the worker's seconds."""
    from repro_torch.launch import dryrun as DR

    t0 = time.perf_counter()
    res = DR.run_audit(*cell, art_dir=str(ROOT / DRYRUN_ART), force=True)
    res["worker_s"] = time.perf_counter() - t0
    return res


def dryrun_sweep() -> dict:
    """(a) Every (architecture x shape) cell through `run_audit` in
    DRYRUN_WORKERS spawned processes (the trace touches no card); one
    line a cell; each corrected count equal to the full trace's; the
    sweep under DRYRUN_LIMIT_S."""
    from repro_torch.launch.shapes import all_cells, applicable

    cells = all_cells()
    # the longest traces first (rwkv6's and zamba2's loops), so the pool
    # ends together
    order = sorted(cells, key=lambda c: (c[0] not in DRYRUN_SLOW,
                                         c[1] != "train_4k"))
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=DRYRUN_WORKERS,
                             mp_context=mp.get_context("spawn")) as pool:
        done = dict(zip(order, pool.map(dryrun_cell, order)))
    wall = time.perf_counter() - t0
    n_ok = 0
    for arch, shape in cells:
        res = done[(arch, shape)]
        ok, _ = applicable(arch, shape)
        check(res["status"] == ("ok" if ok else "skipped"),
              f"[dryrun] {arch} {shape}: status {res['status']}")
        if not ok:
            log(f"[dryrun] {arch} {shape}: skipped ({res['reason'][:48]})")
            continue
        n_ok += 1
        mem, r, full = (res["memory"], res["roofline_corrected"],
                        res["roofline"])
        check(r["flops_per_device"] > 0 and r["hbm_bytes_per_device"] > 0
              and r["bottleneck"] in ("compute", "memory", "collective"),
              f"[dryrun] {arch} {shape}: roofline {json.dumps(r)}")
        for key in ("flops_per_device", "hbm_bytes_per_device",
                    "collective_bytes_per_device"):
            check(r[key] == full[key],
                  f"[dryrun] {arch} {shape}: corrected {key} {r[key]} != "
                  f"the full trace's {full[key]}")
        log(f"[dryrun] {arch} {shape}: args "
            f"{mem['argument_bytes'] / 2**30:.2f} GiB, temp "
            f"{mem['temp_bytes'] / 2**30:.2f} GiB; t_compute "
            f"{r['t_compute_s']:.6g} s, t_memory {r['t_memory_s']:.6g} s, "
            f"bound {r['bottleneck']}; roofline_fraction "
            f"{r['roofline_fraction']:.4f}; trace {res['lower_s']} s + "
            f"audit {res['audit_s']} s"
            + (f" (S extrapolated from {res['seq_probes']})"
               if "seq_probes" in res else ""))
    check(wall < DRYRUN_LIMIT_S,
          f"[dryrun] the sweep took {wall:.1f} s, limit {DRYRUN_LIMIT_S:.0f} s")
    log(f"[dryrun] sweep: {n_ok} cells traced and audited, "
        f"{len(cells) - n_ok} skipped, {wall:.3f} s in {DRYRUN_WORKERS} "
        f"processes (limit {DRYRUN_LIMIT_S:.0f} s); artifacts under "
        f"{DRYRUN_ART}")
    return {"seconds": wall, "cells": n_ok, "skipped": len(cells) - n_ok,
            "worker_s": {f"{a} {s}": round(r["worker_s"], 3)
                         for (a, s), r in done.items()}}


def dryrun_paper_meta() -> dict:
    """(b) The paper cell as the JAX dry-run lowers it: the 3-atom star
    join over 1e9 triples, 16 data shards of a 16x16 mesh (stacked on
    one card), traced on `meta`."""
    from repro_torch.launch import dryrun as DR

    res = DR.run_paper_cell()
    r, mem = res["roofline"], res["memory"]
    check(res["status"] == "ok" and res["shards"] == 16
          and r["hbm_bytes_per_device"] > 0,
          f"[dryrun] paper cell: {json.dumps(res)}")
    log(f"[dryrun] paper cell star3 over {DR.PAPER_TRIPLES:,} triples, "
        f"{res['shards']} shards x {res['rows_per_shard']:,} rows on one "
        f"card (meta): trace {res['lower_s']} s; args "
        f"{mem['argument_bytes'] / 2**30:.2f} GiB, temp "
        f"{mem['temp_bytes'] / 2**30:.2f} GiB; t_memory "
        f"{r['t_memory_s']:.6g} s, t_compute {r['t_compute_s']:.6g} s, "
        f"bound {r['bottleneck']}; exchanges {res['exchanges']}, elided "
        f"{res['elided']}")
    return res


def dryrun_against(label: str, arch: str, shape: str, cfg, batch: int,
                   seq: int, measured: dict, step_s: float, peak: int,
                   fp32: bool = False, **cell_kw) -> dict:
    """(c) The dry-run of the cell a phase measured, at that phase's own
    shape (make_cell's shape override): the predicted argument bytes
    equal the bytes of the params (state) and batch the phase held
    (`held_bytes`), but for batch leaves the phase does not feed; the
    predicted peak (arguments + temp) beside the phase's peak above the
    memory the earlier phases held; model flops over the peak rate times
    the measured seconds."""
    from repro_torch.launch import flops_audit as FA
    from repro_torch.launch import roofline as RL
    from repro_torch.launch import shapes as S

    spec = S.SHAPES[shape]
    saved = dict(spec)
    spec.update(seq=seq, batch=batch)
    try:
        cell = S.make_cell(arch, shape, cfg=cfg, **cell_kw)
    finally:
        spec.update(saved)
    counts = FA.count(cell.fn, *cell.args)
    args = FA.tree_bytes(cell.args)
    batch_arg = cell.args[-1]
    unfed = {k: v.nbytes for k, v in batch_arg.items()
             if k not in measured.get("batch_keys", batch_arg)}
    check(args - sum(unfed.values()) == measured["held_bytes"],
          f"[dryrun] {label}: predicted argument bytes {args:,} (less "
          f"{sum(unfed.values()):,} not fed) != held {measured['held_bytes']:,}")
    predicted_peak = args + counts["temp"]
    mf = RL.model_flops_for(cell.model.cfg, cell.kind, batch, seq)
    share = mf / (RL.PEAK_FLOPS * step_s)
    out = {"argument_bytes": args, "unfed_bytes": unfed,
           "held_bytes": measured["held_bytes"],
           "predicted_peak_bytes": predicted_peak, "measured_peak_bytes": peak,
           "peak_ratio": predicted_peak / peak, "model_flops": mf,
           "trace_flops": counts["flops"], "step_s": step_s,
           "bf16_peak_share": share, "trace_s": counts["seconds"]}
    text = (f"[dryrun] {label}: argument bytes {args:,} == held "
            f"{measured['held_bytes']:,}"
            + (f" + {sum(unfed.values()):,} of {sorted(unfed)} (not fed)"
               if unfed else "")
            + f"; predicted peak {predicted_peak / 2**30:.3f} GiB vs "
            f"max_memory_allocated {peak / 2**30:.3f} GiB (ratio "
            f"{predicted_peak / peak:.4f}); model_flops {mf:.6g} / "
            f"(PEAK_FLOPS x {step_s:.4f} s) = {share:.4f}")
    if fp32:
        out["fp32_peak_share"] = mf / (FP32_FLOPS_PER_S * step_s)
        text += (f", of the fp32 CUDA-core peak {out['fp32_peak_share']:.4f}")
    log(text + f"; trace {counts['seconds']:.3f} s")
    return out


def paper_tt(triples, ndev: int, dev) -> dict:
    """`query.distributed.shard_store_by_subject`'s stacked indexes of
    `triples` (deduplicated, hash-partitioned by subject, each shard's
    rows sorted in each index order, padded with SENTINEL_HI to the
    capacity class of the longest shard), built by sorts on the card:
    the host build takes minutes at 2^24 triples.  Held equal to it at
    PAPER_CHECK_TRIPLES."""
    import torch

    from repro_torch.query import cost
    from repro_torch.query import engine as E

    t = torch.unique(torch.from_numpy(triples).to(dev), dim=0)
    shard = t[:, 0] % ndev
    counts = torch.bincount(shard, minlength=ndev)
    longest = max(int(counts.max()), 1)
    cap = max(cost.capacity_for(longest, safety=1.0), longest)
    start = torch.cumsum(counts, 0) - counts
    out = {}
    for name in E.INDEX_NAMES:
        order = torch.arange(len(t), device=dev)
        for c in reversed(["spo".index(ch) for ch in name]):
            order = order[torch.sort(t[order, c], stable=True).indices]
        order = order[torch.sort(shard[order], stable=True).indices]
        sh = shard[order]
        slot = torch.arange(len(t), device=dev) - start[sh]
        buf = torch.full((ndev, cap, 3), SENTINEL_HI, dtype=torch.int32,
                         device=dev)
        buf[sh, slot] = t[order]
        out[name] = buf
    return out


def paper_device(kernels: dict, dev) -> dict:
    """(d) The paper program on the card at PAPER_DEVICE_TRIPLES triples
    drawn from seed 0 to fit its Statistics: its answer equal to the
    numpy evaluation (`dryrun.paper_reference`), no overflow, its joins
    through `join_count` (counted), its device time beside the dry-run's
    t_memory for the same program over TT indexes of the same shapes."""
    import numpy as np
    import torch

    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import flops_audit as FA
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.mesh import Mesh
    from repro_torch.query import distributed as D
    from repro_torch.rdf.triples import TripleStore

    small = DR.paper_triples(PAPER_CHECK_TRIPLES, seed=1)
    want_tt = D.shard_store_by_subject(TripleStore(small),
                                       Mesh(dict(DR.PAPER_MESH), dev))
    got_tt = paper_tt(small, len(next(iter(want_tt.values()))), dev)
    check(all(torch.equal(got_tt[k], want_tt[k]) for k in want_tt),
          "[dryrun] paper_tt differs from shard_store_by_subject")
    del small, want_tt, got_tt
    n = PAPER_DEVICE_TRIPLES
    t0 = time.perf_counter()
    triples = DR.paper_triples(n, seed=0)
    fn, ndev, _ = DR.paper_program(n, dev)
    tt = paper_tt(triples, ndev, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fn(tt, {})                                   # cold
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, run_s, launches = run_counted(kernels, lambda: fn(tt, {}))
    peak = torch.cuda.max_memory_allocated() - base
    check(launches["join_count"] > 0,
          f"[dryrun] the paper program launched {json.dumps(launches)}")
    check(not bool(out.overflow.any()), "[dryrun] the paper program overflowed")
    t0 = time.perf_counter()
    got = D.gather_result(out)
    want = DR.paper_reference(triples)
    ref_s = time.perf_counter() - t0
    check(got.shape == want.shape and bool((got == want).all()),
          f"[dryrun] the paper program's {len(got):,} rows differ from "
          f"numpy's {len(want):,}")
    del out
    ms = cuda_ms(lambda: fn(tt, {}), reps=10, warm=1)
    _, prof = profiled(lambda: fn(tt, {}), top=5)
    meta_fn, _, _ = DR.paper_program(n, torch.device("meta"))
    counts = FA.count(meta_fn, {k: torch.empty(v.shape, dtype=v.dtype,
                                               device="meta")
                                for k, v in tt.items()}, {})
    t_mem_ms = counts["bytes"] / RL.HBM_BW * 1e3
    log(f"[dryrun] paper program on the card: {n:,} triples (seed 0, "
        f"{len(np.unique(triples, axis=0)):,} distinct), {ndev} shards x "
        f"{tt['spo'].shape[1]:,} rows, built on the card in {build_s:.3f} "
        f"s; answer {len(got):,} rows == numpy ({ref_s:.3f} s with the "
        f"read-back); launches {json.dumps(launches)}; one run "
        f"{ms:.4f} ms by CUDA events ({run_s * 1e3:.3f} ms wall counted), "
        f"device busy {prof['busy_ms']:.4f} ms in {prof['events']} events; "
        f"dry-run of the same program and TT shapes on meta: t_memory "
        f"{t_mem_ms:.4f} ms (bytes {counts['bytes']:.6g}), device ms / "
        f"t_memory {ms / t_mem_ms:.4f}; temp {counts['temp'] / 2**30:.3f} "
        f"GiB predicted vs {peak / 2**30:.3f} GiB measured above the TT")
    for nm, t in prof["top"]:
        log(f"[dryrun]   {t:.4f} ms  {nm[:100]}")
    return {"triples": n, "rows": len(got), "launches": launches,
            "ms": ms, "busy_ms": prof["busy_ms"], "t_memory_ms": t_mem_ms,
            "predicted_bytes": counts["bytes"],
            "predicted_temp_bytes": counts["temp"], "peak_bytes": peak,
            "build_s": build_s, "top": prof["top"]}


def attn_env(tag: str):
    """os.environ patched for a cell traced with `tag`: REPRO_ATTN=chunked
    for the "chunked" tag, unset otherwise; restored on exit."""
    env = {k: v for k, v in os.environ.items() if k != "REPRO_ATTN"}
    if tag == "chunked":
        env["REPRO_ATTN"] = "chunked"
    return mock.patch.dict(os.environ, env, clear=True)


def per_device_traces() -> dict:
    """The production-mesh traces that [kernel] (g) and [dryrun] (e) and
    (f) read, each made once: the paper cell at PAPER_TRIPLES on pod1 and
    pod2 (`run_paper_cell`) and the chunked gemma3-12b prefill_32k cell
    on pod1 (`prod_cell`, its `run_audit`).  Their artifacts' `kernels`
    record each kernel call's per-device shapes."""
    from repro_torch.launch import dryrun as DR

    t0 = time.perf_counter()
    paper = {m: DR.run_paper_cell(mesh=m) for m in PROD_MESHES}
    chunked = prod_cell(CHUNKED_CELL)
    check(chunked["status"] == "ok",
          f"[dryrun] {' '.join(CHUNKED_CELL)}: status {chunked['status']} "
          f"{chunked.get('error', '')}\n{chunked.get('traceback', '')}")
    return {"paper": paper, "chunked": chunked,
            "seconds": time.perf_counter() - t0}


def attention_ref_rows(ref, q, k, v, window: int, rows: int = ATTN_ROWS):
    """`ref.flash_attention_ref`'s arithmetic (fp32 scores, -1e30 where
    masked, softmax, P V, one cast) by batch row and by blocks of `rows`
    queries, each against the keys it can see (a masked key's weight is
    exactly 0), for shapes whose dense scores do not fit the card."""
    import torch

    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    out = torch.empty_like(q)
    for b in range(B):
        for s0 in range(0, S, rows):
            s1 = min(S, s0 + rows)
            lo = 0 if window <= 0 else max(0, s0 - window + 1)
            qg = q[b:b + 1, s0:s1].reshape(1, s1 - s0, Hkv, G, hd).float()
            sc = torch.einsum("bskgh,btkh->bkgst", qg,
                              k[b:b + 1, lo:s1].float()) / (hd ** 0.5)
            i = torch.arange(s0, s1, device=q.device)[:, None]
            j = torch.arange(lo, s1, device=q.device)[None, :]
            mask = j <= i
            if window > 0:
                mask = mask & (j > i - window)
            p = torch.softmax(torch.where(mask, sc, -1e30), dim=-1)
            o = torch.einsum("bkgst,btkh->bskgh", p, v[b:b + 1, lo:s1].float())
            out[b:b + 1, s0:s1] = o.reshape(1, s1 - s0, H, hd).to(q.dtype)
            del sc, p, o
    return out


def kernel_phase_per_device(ops, ref, jc, fa, dev, traces: dict) -> dict:
    """(g) Each kernel of a production-mesh program held at the shapes
    rank 0 launches it at (`traces`, `per_device_traces`): `join_count`
    at the pod1 paper program's two probes (exact against its plain
    version) and `flash_attention` at the chunked pod1 gemma3-12b
    prefill's per-device shapes, its global and its window layers (bf16,
    one ulp, against its plain version in row blocks:
    `attention_ref_rows`); each timed beside its bound, its plain version
    and the library call (`library_attention_ms`)."""
    import numpy as np
    import torch

    from repro_torch.launch import dryrun as DR

    cases = {"join_count": traces["paper"]["pod1"]["kernels"]["join_count"],
             "flash_attention":
                 traces["chunked"]["kernels"]["flash_attention"]}
    out: dict = {"trace_s": traces["seconds"]}
    rng = np.random.default_rng(11)
    join = {"program": f"the pod1 paper program at {DR.PAPER_TRIPLES:,} "
                       f"triples, rank 0",
            "calls": cases["join_count"]["calls"], "shapes": {}, "ms": 0.0,
            "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "max_abs_err": 0}
    for key, n in cases["join_count"]["shapes"].items():
        (B, L), (_, S) = json.loads(key)
        p_np, b_np = join_inputs(rng, B, L, S, key_space=max(S // 2, 1))
        probe = torch.from_numpy(p_np).to(dev)
        build = torch.from_numpy(b_np).to(dev)
        err = compare_kernel(ops, ref, probe, build)
        check(err == 0, f"[kernel] join_count differs at the per-device "
                        f"shape B={B} L={L} S={S}")
        t = {"calls": n, "ms": cuda_ms(lambda: ops.join_count(probe, build),
                                       10),
             "plain_ms": cuda_ms(lambda: ref.join_count_ref(probe, build),
                                 3, 1),
             "library_ms": cuda_ms(lambda: (
                 torch.searchsorted(build, probe, side="left", out_int32=True),
                 torch.searchsorted(build, probe, side="right",
                                    out_int32=True)), 10),
             "bound_ms": bound_ms(B, L, S)}
        join["shapes"][f"B={B} L={L} S={S}"] = t
        for k2 in ("ms", "plain_ms", "library_ms", "bound_ms"):
            join[k2] += n * t[k2]
        log(f"[kernel] join_count at pod1's per-device paper probe B={B} "
            f"L={L:,} S={S:,} ({n} a run): exact; kernel {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, searchsorted x2 "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms")
        del probe, build
    out["join_count"] = join
    gen = torch.Generator(device=dev).manual_seed(13)
    atol, rtol = ATTN_TOL["bfloat16"]
    attn = {"program": f"{' '.join(CHUNKED_CELL[:2])} chunked on "
                       f"{CHUNKED_CELL[2]}, rank 0",
            "calls": cases["flash_attention"]["calls"], "shapes": {},
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
            "max_abs_err": 0.0}
    for key, n in cases["flash_attention"]["shapes"].items():
        qs, ks, _, window = json.loads(key)
        B, S, H, hd = qs
        Hkv = ks[2]
        q, k, v = attention_inputs(gen, B, S, H, Hkv, hd, torch.bfloat16, dev)
        want = attention_ref_rows(ref, q, k, v, window)
        margin = []
        err, use = compare_attention(ops, ref, fa, q, k, v, window, margin,
                                     want)
        del want
        lib_ms, lib_how = library_attention_ms(q, k, v, window)
        t = {"calls": n, "args": key, "design": use, "max_abs_err": err,
             "share_of_limit": margin[0],
             "ms": cuda_ms(lambda: ops.flash_attention(q, k, v, window), 3, 1),
             "plain_ms": cuda_ms(lambda: attention_ref_rows(ref, q, k, v,
                                                            window), 1, 0),
             "library_ms": lib_ms, "library_call": lib_how}
        t["bound_ms"], t["bound_by"] = attention_bound(B, S, H, Hkv, hd,
                                                       window)
        attn["shapes"][f"B={B} S={S} H={H} Hkv={Hkv} hd={hd} "
                       f"window={window}"] = t
        attn["max_abs_err"] = max(attn["max_abs_err"], err)
        attn["bound_by"] = t["bound_by"]
        for k2 in ("ms", "plain_ms", "bound_ms"):
            attn[k2] += n * t[k2]
        if t["library_ms"] is None:
            attn["library_ms"] = None
        elif attn["library_ms"] is not None:
            attn["library_ms"] += n * t["library_ms"]
        log(f"[kernel] flash_attention at pod1's per-device chunked "
            f"gemma3-12b prefill B={B} S={S:,} H={H} Hkv={Hkv} hd={hd} bf16 "
            f"window {window} ({n} a prefill): design {use}, max abs err "
            f"{err:.3e} ({margin[0]:.3f} of the limit {atol} + 2**-7 |ref|); "
            f"kernel {t['ms']:.4f} ms, plain (row blocks) "
            f"{t['plain_ms']:.4f} ms, library "
            + ("n/a" if lib_ms is None else f"{lib_ms:.4f} ms")
            + f" ({lib_how}), bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
        del q, k, v
        torch.cuda.empty_cache()
    out["flash_attention"] = attn
    return out


def prod_cell(task: tuple) -> dict:
    """One cell of the production sweep, in a worker process:
    `run_audit` on its mesh (rank 0's program traced on `meta`, then the
    per-group corrected roofline, each trace inside a fake process
    group), its artifact under PROD_ART, and the worker's seconds."""
    from repro_torch.launch import dryrun as DR

    import traceback

    arch, shape, mesh, tag = task
    t0 = time.perf_counter()
    try:
        with attn_env(tag):
            res = DR.run_audit(arch, shape, mesh=mesh, tag=tag,
                               art_dir=str(ROOT / PROD_ART), force=True)
    except Exception as e:  # noqa: BLE001 - reported by the sweep
        res = {"status": "failed", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    res["worker_s"] = time.perf_counter() - t0
    return res


def production_sweep(chunked: dict) -> dict:
    """(e) Every (architecture x shape) cell on pod1 and pod2 through
    `run_audit` in PROD_WORKERS spawned processes, and the chunked
    gemma3-12b prefill on pod1 (`chunked`, audited once before (g));
    one line a cell; each status as `applicable` says, per-device flops,
    HBM bytes and collective bytes > 0 for every ok cell, each corrected
    count equal to the full trace's; the chunked cell's `flash_attention`
    calls one a layer; the pool under PROD_LIMIT_S."""
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import all_cells, applicable

    tasks = [(a, s, m, "") for m in PROD_MESHES for a, s in all_cells()]
    order = sorted(tasks, key=lambda c: (c[0] not in DRYRUN_SLOW,
                                         c[1] != "train_4k"))
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=PROD_WORKERS,
                             mp_context=mp.get_context("spawn")) as pool:
        done = dict(zip(order, pool.map(prod_cell, order)))
    wall = time.perf_counter() - t0
    tasks.append(CHUNKED_CELL)
    done[CHUNKED_CELL] = chunked
    n_ok = 0
    for task in tasks:
        arch, shape, mesh, tag = task
        res = done[task]
        label = f"{arch} {shape} {mesh}" + (f".{tag}" if tag else "")
        ok, _ = applicable(arch, shape)
        check(res["status"] == ("ok" if ok else "skipped"),
              f"[dryrun] {label}: status {res['status']} "
              f"{res.get('error', '')}\n{res.get('traceback', '')}")
        if res["status"] == "failed":
            continue
        check(res["chips"] == (256 if mesh == "pod1" else 512),
              f"[dryrun] {label}: {res['chips']} chips")
        if not ok:
            log(f"[dryrun] {label}: skipped ({res['reason'][:48]})")
            continue
        n_ok += 1
        mem, r, full = (res["memory"], res["roofline_corrected"],
                        res["roofline"])
        for key in ("flops_per_device", "hbm_bytes_per_device",
                    "collective_bytes_per_device"):
            check(r[key] > 0, f"[dryrun] {label}: {key} {r[key]}")
            check(r[key] == full[key],
                  f"[dryrun] {label}: corrected {key} {r[key]} != the full "
                  f"trace's {full[key]}")
        det = full["collective_detail"]
        gathers = res["uneven_view_gathers"]
        log(f"[dryrun] {label}: per device args "
            f"{mem['argument_bytes'] / 2**30:.3f} GiB, temp "
            f"{mem['temp_bytes'] / 2**30:.2f} GiB, flops "
            f"{r['flops_per_device']:.6g}, HBM bytes "
            f"{r['hbm_bytes_per_device']:.6g}, collective bytes "
            f"{r['collective_bytes_per_device']:.6g} "
            f"{json.dumps(det.get('count', {}), sort_keys=True)} (of them "
            f"{gathers['calls']:.0f} gathers before a reshape, "
            f"{gathers['bytes']:.6g} B); bound "
            f"{r['bottleneck']}; trace {res['lower_s']} s + audit "
            f"{res['audit_s']} s")
    arch, shape, mesh, tag = CHUNKED_CELL
    chunked = done[CHUNKED_CELL]["kernels"].get("flash_attention", {})
    layers = get_config(arch).n_layers
    check(chunked.get("calls") == layers,
          f"[dryrun] chunked {arch} {shape} {mesh}: flash_attention calls "
          f"{json.dumps(chunked)}, expected {layers}")
    check(wall < PROD_LIMIT_S, f"[dryrun] the production sweep took "
                               f"{wall:.1f} s, limit {PROD_LIMIT_S:.0f} s")
    log(f"[dryrun] production sweep: {n_ok} cells traced and audited per "
        f"device on {'/'.join(PROD_MESHES)} (the chunked {arch} {shape} "
        f"{mesh} among them: {chunked['calls']} flash_attention calls), "
        f"{len(tasks) - n_ok} skipped, {wall:.3f} s in {PROD_WORKERS} "
        f"processes (limit {PROD_LIMIT_S:.0f} s); artifacts under {PROD_ART}")
    return {"seconds": wall, "cells": n_ok, "skipped": len(tasks) - n_ok,
            "chunked_flash_calls": chunked["calls"],
            "worker_s": {" ".join(t[:3]) + (f".{t[3]}" if t[3] else ""):
                         round(r["worker_s"], 3) for t, r in done.items()}}


def paper_per_device(papers: dict) -> dict:
    """(f) The paper cell at PAPER_TRIPLES on pod1 and pod2, rank 0's
    program (`papers`, traced once before (g)): it reads 2 of the 6 TT
    indexes (2 x rows_per_shard x 12 bytes), exchanges once (one
    all-to-all) and ORs its overflow flag once (one 4-byte
    all-reduce)."""
    from repro_torch.launch import dryrun as DR

    out = {}
    for mesh in PROD_MESHES:
        res = papers[mesh]
        mem, r = res["memory"], res["roofline"]
        det = r["collective_detail"]
        want = 2 * res["rows_per_shard"] * 3 * 4
        check(mem["argument_bytes"] == want,
              f"[dryrun] paper {mesh}: argument bytes "
              f"{mem['argument_bytes']:,} != 2 indexes x "
              f"{res['rows_per_shard']:,} rows x 12 = {want:,}")
        check(det["count"] == {"all-to-all": 1, "all-reduce": 1}
              and det["bytes"]["all-reduce"] == 4,
              f"[dryrun] paper {mesh}: collectives {json.dumps(det)}")
        log(f"[dryrun] paper cell star3 over {DR.PAPER_TRIPLES:,} triples on "
            f"{mesh} ({res['chips']} chips), rank 0's program (meta): "
            f"trace {res['lower_s']} s; args {mem['argument_bytes']:,} B "
            f"(2 of 6 indexes x {res['rows_per_shard']:,} rows), temp "
            f"{mem['temp_bytes'] / 2**30:.3f} GiB, out "
            f"{mem['output_bytes']:,} B; collectives "
            f"{json.dumps(det['bytes'], sort_keys=True)} "
            f"{json.dumps(det['count'], sort_keys=True)}; flops "
            f"{r['flops_per_device']:.6g}, HBM bytes "
            f"{r['hbm_bytes_per_device']:.6g}, bound {r['bottleneck']}; "
            f"join_count {json.dumps(res['kernels'].get('join_count', {}))}")
        out[mesh] = {k: res[k] for k in ("lower_s", "memory", "roofline",
                                         "rows_per_shard", "kernels")}
    return out


def dryrun_phase(kernels: dict, dev, lm: dict, train: dict,
                 traces: dict) -> dict:
    """[dryrun]: (a) the sweep, (b) the paper cell on meta, (c) the
    dry-run held against [lm]'s gemma3-12b prefill and [train]'s
    qwen2-vl-2b step, (d) the paper program on the card, (e) the
    production sweep, (f) the paper cell per device on pod1 and pod2
    ((g), the kernels at the per-device shapes, is in [kernel]; it and
    (e) and (f) read the same `traces`, `per_device_traces`)."""
    import torch

    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig

    t_phase = time.perf_counter()
    sweep = dryrun_sweep()
    paper = dryrun_paper_meta()
    held = {
        "lm": dryrun_against(
            f"{LM_ARCH} prefill, bf16, chunked, {LM_BATCH} x {LM_PROMPT} "
            f"([lm]; measured: prefill_with_cache, cache {LM_CACHE})",
            LM_ARCH, "prefill_32k", lm_config(), LM_BATCH, LM_PROMPT,
            lm, lm["prefill_s"], lm["prefill_peak_bytes"]),
        "train": dryrun_against(
            f"{TRAIN_ARCH} train step, fp32, remat full, {TRAIN_BATCH} x "
            f"{TRAIN_SEQ} ([train])", TRAIN_ARCH, "train_4k", train_config(),
            TRAIN_BATCH, TRAIN_SEQ, train, train["median_step_s"],
            train["peak_bytes"], fp32=True, param_dtype=torch.float32,
            tc=TS.TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=1,
                                            total_steps=TRAIN_STEPS),
                              remat="full"))}
    torch.cuda.empty_cache()
    device = paper_device(kernels, dev)
    production = production_sweep(traces["chunked"])
    paper_pods = paper_per_device(traces["paper"])
    phase_s = time.perf_counter() - t_phase
    log(f"[dryrun] phase {phase_s:.3f} s")
    return {"sweep": sweep, "paper_meta": {k: paper[k] for k in (
        "lower_s", "memory", "roofline", "shards", "rows_per_shard")},
        "held": held, "paper_device": device, "production": production,
        "paper_per_device": paper_pods, "seconds": phase_s}


def main(argv: list[str]) -> None:
    import argparse

    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="an unpacked earlier tree whose join_count and "
                             "scatter_append are timed beside the port's")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    import repro_torch
    from repro_torch.api import TuningSession
    from repro_torch.kernels import filter_mask as fm
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import join_count as jc
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import scatter_append as sa
    from repro_torch.rdf.generator import generate, lubm_workload
    from repro_torch.views.materializer import materialize_state_device

    # ---- 1. device ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} | nvidia-smi: {card_line} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | "
        f"devices {torch.cuda.device_count()}")

    dev = repro_torch.device()
    parent = None if args.parent is None else load_parent(args.parent)

    # ---- 2. build: one nvcc per kernel source, all at once ------------
    t0 = time.perf_counter()
    mods = (jc, sa, fm, fa) + (() if parent is None else parent[1:])
    with ThreadPoolExecutor(max_workers=len(mods)) as pool:
        libs = list(pool.map(lambda mod: mod.build(), mods))
    log(f"[build] {', '.join(os.path.relpath(lib, ROOT) for lib in libs)} "
        f"in {time.perf_counter() - t0:.3f} s")
    ptxas = {name: ptxas_summary(name, kernel_label)
             for name in ("join_count", "scatter_append")}
    for name, summary in ptxas.items():
        log(f"[build] ptxas, {name}: {summary}")
    log(f"[build] ptxas, tensor-core flash_attention: "
        f"{ptxas_summary('flash_attn', tc_label)}")

    # ---- 3. kernel against its plain version -------------------------
    max_err, join_2p19 = kernel_phase_join(ops, ref, jc, dev, parent)
    append_err, append_2p19 = kernel_phase_append(ops, ref, sa, dev, parent)
    filter_err, filter_2p20 = kernel_phase_filter(ops, ref, fm, dev)
    attn_err, attn_path = kernel_phase_attention(ops, ref, fa, dev)
    attn_grad = kernel_phase_attention_backward(ops, ref, fa, dev)
    traces = per_device_traces()
    per_device = kernel_phase_per_device(ops, ref, jc, fa, dev, traces)
    max_err = max(max_err, per_device["join_count"]["max_abs_err"])
    attn_err = max(attn_err, per_device["flash_attention"]["max_abs_err"])

    # ---- 4. main path -------------------------------------------------
    steps: dict[str, float] = {}
    t0 = time.perf_counter()
    uni = generate(n_universities=N_UNIVERSITIES, seed=0)
    steps["generate"] = time.perf_counter() - t0
    store = uni.store
    check(len(store) == EXPECTED_TRIPLES,
          f"store has {len(store)} triples, expected {EXPECTED_TRIPLES}")
    workload = lubm_workload(uni.dictionary)
    t0 = time.perf_counter()
    _ = store.stats
    steps["statistics"] = time.perf_counter() - t0
    log(f"[main] {len(store):,} triples from {N_UNIVERSITIES} universities "
        f"(generate {steps['generate']:.2f} s, statistics "
        f"{steps['statistics']:.2f} s)")

    torch.cuda.reset_peak_memory_stats()
    zero_counts((jc, sa, fm, fa))
    session = TuningSession(store, workload, schema=uni.schema,
                            type_id=uni.type_id, device="cuda")
    t0 = time.perf_counter()
    rep = session.retune()
    steps["retune"] = time.perf_counter() - t0
    app, apply_split = split_apply(session)
    steps["apply"] = apply_split["total"]
    log(f"[main] retune {steps['retune']:.3f} s: {rep.summary()}")
    log(f"[main] apply {steps['apply']:.3f} s: {app.summary()}")
    log(f"[main] apply split: {split_text(apply_split)}")
    direct: dict[str, set] = {}
    steps["answer"] = steps["direct"] = 0.0
    for q in workload:
        t0 = time.perf_counter()
        got = session.answer(q.name)
        dt = time.perf_counter() - t0
        steps["answer"] += dt
        t0 = time.perf_counter()
        direct[q.name] = session.executor.answer_group_direct(q.name)
        steps["direct"] += time.perf_counter() - t0
        check(got == direct[q.name],
              f"{q.name}: answer differs from direct evaluation")
        check(len(got) == EXPECTED_ROWS[q.name],
              f"{q.name}: {len(got)} rows, expected {EXPECTED_ROWS[q.name]}")
        log(f"[main] {q.name}: {len(got):,} rows == direct ({dt:.4f} s)")
    main_launches = {"join_count": jc.launches, "scatter_append": sa.launches,
                     "filter_mask": fm.launches,
                     "flash_attention": fa.launches}
    check(main_launches["join_count"] > 0,
          "the main path launched no join_count kernel")
    check(main_launches["filter_mask"] == 0,
          f"the main path launched filter_mask {main_launches['filter_mask']}"
          f" times; no path calls it")
    ex = session.executor
    tele = ex.telemetry()
    prog = ex.workload._prog
    log(f"[main] launches on the main path: {json.dumps(main_launches)}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
        f" MiB")
    log("[main] telemetry " + json.dumps(
        {k: v for k, v in tele.items() if k != "bucket_compile_log"}))
    log("[main] buckets " + json.dumps(
        [[b.kind, b.wave, b.cap, len(b.node_ids)] for b in prog.buckets]))

    # delta swap: drop q1, warm retune, apply
    t0 = time.perf_counter()
    session.remove_query("q1")
    rep2 = session.retune()
    steps["retune_delta"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    app2 = session.apply()
    torch.cuda.synchronize()
    steps["apply_delta"] = time.perf_counter() - t0
    log(f"[delta] retune {steps['retune_delta']:.3f} s: {rep2.summary()}")
    log(f"[delta] apply {steps['apply_delta']:.3f} s: {app2.summary()}")
    for q in workload[1:]:
        got = session.answer(q.name)
        check(got == direct[q.name], f"{q.name}: answer after the delta "
                                     f"swap differs from direct evaluation")
    log(f"[delta] q2..q6 exact after the swap; launches so far "
        f"{jc.launches}")

    # views materialized by the device program equal the host extents
    t0 = time.perf_counter()
    before = jc.launches
    dev_ext, _, _ = materialize_state_device(session.best, store,
                                             device="cuda")
    torch.cuda.synchronize()
    steps["materialize_device"] = time.perf_counter() - t0
    for vid, host in session.executor.extents.items():
        a = np.unique(dev_ext[vid].rows, axis=0)
        b = np.unique(host.rows, axis=0)
        check(dev_ext[vid].cols == host.cols and a.shape == b.shape
              and bool((a == b).all()),
              f"view v{vid}: device extent differs from the host extent")
    log(f"[views] {len(dev_ext)} device extents == host extents "
        f"({steps['materialize_device']:.3f} s, "
        f"{jc.launches - before} join_count launches)")

    # ---- 4. (cont.) the kernel at the main path's shapes -------------
    captured = []
    real = ops.join_count

    def recording(probe, build):
        captured.append((probe.clone(), build.clone()))
        return real(probe, build)

    ops.join_count = recording
    try:
        ex.workload.run(ex.tt, ex.device_views)
    finally:
        ops.join_count = real
    torch.cuda.synchronize()
    check(len(captured) > 0, "no join probe on the main path to measure")
    totals: dict = {}
    for probe, build in captured:
        B, L = probe.shape
        S = build.shape[1]
        err = compare_kernel(ops, ref, probe, build)
        check(err == 0, f"join_count differs at main-path shape "
                        f"B={B} L={L} S={S}")
        max_err = max(max_err, err)
        t = time_join(ops, ref, jc, probe, build, parent, reps=50)
        for key, v in t.items():
            totals[key] = totals.get(key, 0.0) + v
        log(f"[shape] B={B} L={L} S={S}: exact; {join_times(t)}")
    log(f"[shape] join_count over the main path's {len(captured)} calls: "
        + join_times(totals))
    probe, build = max(captured, key=lambda pb: pb[0].numel())
    split = join_host_split(ops, jc, probe, build)
    device = graph_ms(lambda: jc.join_count_cuda(probe, build))
    library_us = host_us(lambda: (
        torch.searchsorted(build, probe, side="left", out_int32=True),
        torch.searchsorted(build, probe, side="right", out_int32=True)))
    parent_us = None if parent is None else host_us(
        lambda: parent[0].join_count(probe, build))
    totals["host"] = {"shape": f"B={probe.shape[0]} L={probe.shape[1]} "
                               f"S={build.shape[1]}",
                      "device_ms": device, "library_us": library_us,
                      "parent_wrapper_us": parent_us, "split_us": split}
    log(f"[host] join_count at the main path's largest call "
        f"({totals['host']['shape']}): wrapper {split['wrapper']:.2f} us a "
        f"call on the host (device {device * 1e3:.2f} us); " + ", ".join(
            f"{key} {v:.2f}" for key, v in split.items() if key != "wrapper")
        + f" us; library (searchsorted x2) {library_us:.2f} us"
        + ("" if parent_us is None else f"; parent wrapper {parent_us:.2f} us"))

    # the program's only host sync is the one transfer of all overflow
    # flags per execute, as in the JAX package
    torch.cuda.synchronize()
    _, syncs = count_syncs(lambda: ex.workload.run(ex.tt, ex.device_views))
    log(f"[syncs] one workload run: {len(syncs)} synchronizing operation(s) "
        + " ".join(syncs))
    check(len(syncs) == 1, f"a workload run made {len(syncs)} host syncs, "
                           f"expected 1 (the overflow flags)")
    log("[steps] " + json.dumps({k: round(v, 4) for k, v in steps.items()}))

    # ---- 5. static verification of the live configuration --------------
    # no maintainer is bound yet: the lint and the static maintenance
    # check read nothing from the card
    verify_counted = {"join_count": jc, "scatter_append": sa,
                      "filter_mask": fm, "flash_attention": fa}
    verified = {"main": verify_live(session, verify_counted,
                                    "after [main]'s delta swap")}
    check(verified["main"]["syncs"] == 0,
          f"[verify] {verified['main']['syncs']} host syncs without a "
          f"maintainer, expected none")

    # ---- 6. the subject-sharded engine and backend --------------------
    sharded = sharded_phase(session, direct, ops, ref, jc, parent)
    steps["sharded"] = sharded["seconds"]
    max_err = max(max_err, sharded["max_abs_err"])

    # ---- 7. streaming maintenance ------------------------------------
    t0 = time.perf_counter()
    maint = maint_phase(session, workload, jc, sa, fm)
    steps["maint"] = time.perf_counter() - t0
    shape_err, append_stream = append_shape_phase(
        ops, ref, sa, maint["shapes"]["append"], dev, parent)
    append_err = max(append_err, shape_err)
    shape_err, join_stream = join_stream_phase(
        ops, ref, jc, maint["shapes"]["join"], parent)
    max_err = max(max_err, shape_err)
    del maint["shapes"]
    log(f"[maint] phase {steps['maint']:.3f} s")

    # ---- 5. (cont.) static verification with the maintainer bound -----
    verified.update(verify_phase(session, verify_counted))
    steps["verify"] = verified["main"]["seconds"] + verified["seconds"]
    log(f"[verify] phase {verified['seconds']:.3f} s after [maint] (the "
        f"gate {verified['gate_s']:.3f} s of it), "
        f"{verified['main']['seconds']:.4f} s after [main]")

    # ---- 8. serving and persistence ------------------------------------
    # direct answers are evaluated in worker processes (spawned: they
    # touch no CUDA) while the card serves, and settled after [ckpt]
    counted = {"join_count": jc, "scatter_append": sa, "filter_mask": fm}
    with ProcessPoolExecutor(max_workers=DIRECT_WORKERS,
                             mp_context=mp.get_context("spawn")) as pool:
        t0 = time.perf_counter()
        zero_counts(counted.values())
        serve, direct = serve_phase(session, workload, counted, pool)
        serve["launches"] = launches_of(counted)
        steps["serve"] = time.perf_counter() - t0
        log(f"[serve] launches on the serve path: "
            f"{json.dumps(serve['launches'])}; parts (s) "
            + json.dumps({k: round(v, 3)
                          for k, v in serve["seconds"].items()}))
        check(serve["launches"]["join_count"] > 0
              and serve["launches"]["scatter_append"] > 0,
              f"the serve path launched {json.dumps(serve['launches'])}")
        check(serve["launches"]["filter_mask"] == 0,
              "the serve path launched filter_mask; no path calls it")
        t0 = time.perf_counter()
        saved = ckpt_phase(session, jc)
        steps["ckpt"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        settled = direct.settle()
        steps["settle"] = time.perf_counter() - t0
    log(f"[serve] {settled['answers']} served answers on "
        f"{settled['snapshots']} store snapshots == direct evaluation "
        f"({settled['evaluations']} evaluations in {DIRECT_WORKERS} worker "
        f"processes; {settled['wait_s']:.3f} s waited for them after "
        f"[ckpt])")
    log(f"[serve] phase {steps['serve']:.3f} s; [ckpt] phase "
        f"{steps['ckpt']:.3f} s; together with the wait "
        f"{steps['serve'] + steps['ckpt'] + steps['settle']:.3f} s")

    # ---- 10. LM serving ------------------------------------------------
    t0 = time.perf_counter()
    lm = lm_phase({"join_count": jc, "scatter_append": sa, "filter_mask": fm,
                   "flash_attention": fa}, dev)
    steps["lm"] = time.perf_counter() - t0
    log(f"[lm] phase {steps['lm']:.3f} s")

    # ---- 11. LM serving of the MoE and SSM families ---------------------
    families = lm_families_phase({"join_count": jc, "scatter_append": sa,
                                  "filter_mask": fm, "flash_attention": fa},
                                 dev)
    steps["lm_families"] = families["seconds"]

    # ---- 12. the logical-axis mesh layer ---------------------------------
    every = {"join_count": jc, "scatter_append": sa, "filter_mask": fm,
             "flash_attention": fa}
    sharded_lm = sharded_lm_phase(every, dev)
    steps["sharded_lm"] = sharded_lm["seconds"]

    # ---- 13. the encoder-decoder, and training ---------------------------
    encdec = encdec_phase(every, dev)
    steps["lm_encdec"] = encdec["seconds"]
    train = train_phase(every, dev, session)
    steps["train"] = train["seconds"]
    both_s = encdec["seconds"] + train["seconds"]
    check(both_s < NEW_PHASES_LIMIT_S,
          f"[lm_encdec] and [train] took {both_s:.1f} s, limit "
          f"{NEW_PHASES_LIMIT_S:.0f} s")
    log(f"[lm_encdec] + [train] {both_s:.3f} s (under "
        f"{NEW_PHASES_LIMIT_S:.0f} s)")

    # ---- 15. the dry-run tooling -----------------------------------------
    dry = dryrun_phase(every, dev, lm, train, traces)
    steps["dryrun"] = dry["seconds"]
    # per prefill: one launch per layer, at the global or the window shape;
    # ms, plain_ms, library_ms and bound_ms are sums of the per-call
    # numbers over those launches, device_ms the kernel's device time
    # inside the profiled prefill itself
    cfg = lm_config()
    n_win = cfg.block_pattern.count("swa") * cfg.n_groups
    per_prefill = {key: (cfg.n_layers - n_win) * attn_path[0][key]
                   + n_win * attn_path[cfg.window][key]
                   for key in ("ms", "device_ms", "earlier_device_ms",
                               "plain_ms", "library_ms", "bound_ms")}

    kernels = [{
        "name": "join_count", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": main_launches["join_count"],
        "max_abs_err": max_err, "ms": totals["ms"],
        "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
        "bound_by": "bytes", "library_ms": totals["library_ms"],
        "device_ms": totals["device_ms"],
        "parent_ms": totals.get("parent_ms"),
        "parent_device_ms": totals.get("parent_device_ms"),
        "main_path_calls": len(captured),
        "maint_launches": maint["launches"]["join_count"],
        "serve_launches": serve["launches"]["join_count"],
        "ckpt_launches": saved["launches"],
        "sharded_launches": sharded["launches"],
        "dryrun_launches": dry["paper_device"]["launches"]["join_count"],
        "sharded": {k: sharded[k] for k in ("join", "device_members",
                                            "moves")},
        "host": totals["host"], "ptxas": ptxas["join_count"],
        "at_2p19": join_2p19, "stream": join_stream,
        "per_device": per_device["join_count"],
    }, {
        "name": "scatter_append", "route": "cuda", "source": APPEND_SOURCE,
        "replaces": APPEND_REPLACES,
        "launches": maint["launches"]["scatter_append"],
        "max_abs_err": append_err, "ms": append_stream["ms"],
        "plain_ms": append_stream["plain_ms"],
        "bound_ms": append_stream["bound_ms"], "bound_by": "bytes",
        "library_ms": append_stream["library_ms"],
        "device_ms": append_stream["device_ms"],
        "parent_ms": append_stream.get("parent_ms"),
        "parent_device_ms": append_stream.get("parent_device_ms"),
        "main_path_calls": append_stream["calls"],
        "serve_launches": serve["launches"]["scatter_append"],
        "host": append_stream["host"], "ptxas": ptxas["scatter_append"],
        "syncs": maint["append_syncs"],
        "at_2p19": append_2p19,
    }, {
        "name": "filter_mask", "route": "cuda", "source": FILTER_SOURCE,
        "replaces": FILTER_REPLACES,
        "launches": main_launches["filter_mask"],
        "max_abs_err": filter_err, "ms": filter_2p20["ms"],
        "plain_ms": filter_2p20["plain_ms"],
        "bound_ms": filter_2p20["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "device_ms": filter_2p20["device_ms"],
        "maint_launches": maint["launches"]["filter_mask"],
        "serve_launches": serve["launches"]["filter_mask"],
        "shape": "N=2^20 W=3, one condition",
    }, {
        "name": "flash_attention", "route": "cuda", "source": ATTN_SOURCE,
        "launcher": ATTN_LAUNCHER, "replaces": ATTN_REPLACES,
        "launches": lm["launches"]["flash_attention.tensor_core"],
        "launches_by_design": {
            d: lm["launches"][f"flash_attention.{d}"] for d in fa.DESIGNS},
        "design": "tensor_core (TMA + wgmma)",
        "p_product": attn_path[0]["p_product"],
        "max_abs_err": attn_err, "ms": per_prefill["ms"],
        "plain_ms": per_prefill["plain_ms"],
        "bound_ms": per_prefill["bound_ms"],
        "bound_by": attn_path[0]["bound_by"],
        "library_ms": per_prefill["library_ms"],
        "device_ms": lm["profiled"]["prefill"]["flash_attn_ms"],
        "device_ms_sum_of_per_call": per_prefill["device_ms"],
        "earlier_device_ms": {f"window_{w}": t["earlier_device_ms"]
                              for w, t in attn_path.items()},
        "earlier_device_ms_sum_of_per_call": per_prefill["earlier_device_ms"],
        "earlier_design": "cuda_core (the earlier kernel: fp32 products on "
                          "the CUDA cores)",
        "per_prefill": f"sums over {cfg.n_layers - n_win} global + {n_win} "
                       f"window launches of per_call, but device_ms: the "
                       f"profiled prefill's",
        "main_path_calls": lm["launches"]["flash_attention"],
        "launches_by_model": {
            LM_ARCH: lm["launches"]["flash_attention.tensor_core"],
            **{arch: r["launches"]["flash_attention.tensor_core"]
               for arch, r in families["models"].items()},
            ENCDEC_ARCH: encdec["launches"]["flash_attention.tensor_core"],
            f"{TRAIN_ARCH} train step": train["launches_per_step"],
            f"{SHARDED_ARCH} EP prefill":
                sharded_lm["prefill"]["launches"]["flash_attention.tensor_core"],
            f"{SHARDED_ARCH} sharded train step":
                sharded_lm["train"]["launches_per_step"],
            f"{SHARDED_SHARED_ARCH} EP prefill": sharded_lm["shared_expert"][
                "launches"]["flash_attention.tensor_core"]},
        "backward_ms": attn_grad["train"]["backward_ms"],
        "backward": attn_grad,
        "per_call": {f"window_{w}": t for w, t in attn_path.items()},
        "lm": {k: v for k, v in lm.items() if k != "launches"},
        "lm_families": {arch: {k: v for k, v in r.items() if k != "launches"}
                        for arch, r in families["models"].items()},
        "lm_encdec": {k: v for k, v in encdec.items() if k != "launches"},
        "train": train,
        "sharded_lm": sharded_lm,
        "dryrun": dry,
        "per_device": per_device["flash_attention"],
    }]
    log(card_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
