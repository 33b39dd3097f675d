"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--rows 1048576]

Phases, each raising on failure (the script then exits non-zero):

1. require CUDA; print the card's name and ``nvidia-smi`` name/power limit;
2. build every kernel from ``src/repro_torch/kernels/csrc`` (one nvcc per
   source, all started together) and print the build seconds;
3. hold ``fused_embed`` against its plain PyTorch version on the card at
   the main path's shapes, the calibration probe's, one wide shape and
   N = 0, in float32 (atol 2e-5) and bfloat16 (atol 2e-2); then
   ``rmsnorm``, ``flash_attention`` and ``decode_attention`` at the LM
   paths' full-width shapes (phase 7b's too: head dim 128 and 256, and
   recurrentgemma's GQA group of 16 x 256; whisper's non-causal flash at
   S 1500 and with Sq != Sk, decode at G 1 over 1500 positions) and a few
   ragged ones (the attention kernels also at their q / kv tile edges and
   decode's split edges), in float32
   (atol 2e-5 for rmsnorm, 5e-5 for attention) and bfloat16 (one bf16 ulp
   of the value plus atol 2e-2 for rmsnorm, 2e-4 for attention);
4. SQL path: ``MorphingSession(backend="torch")`` over a ``--rows`` table
   (gender, len, 16-wide float32 emb from ``--seed``) with a linear-mode
   zoo, so the resolved trunk runs ``fused_embed``: CREATE TASK, a
   grouped AVG cold and warm, a PREDICT over a slice. Launch counts are
   zeroed just before each query and read just after; rows are held to a
   ``backend="numpy"`` session at atol 1e-5;
5. the quickstart query (full 16-model zoo, 600 rows) through the
   selector, on the card;
6. served path: the same table, zoo and task behind the online tier, on a
   decoupled store. It logs Eq. 10's op_cost for "host" and "cuda" at the
   largest request's rows (the servers' ``nrows_hint``) and at 2048 (what
   dispatch workers plan at) and, if it picks the host at either, pins the
   phase to the card (``EngineConfig(devices=("cuda",))``). A
   ``MorphingServer`` serves 32 concurrent ``PREDICT ... WHERE len > c``
   requests (8 cuts in 180-194, ~25-100 K rows each) cold, then again
   warm, each round through a fresh server stopped before its launch
   count is read: every lane on "cuda", launches > 0 cold and 0 warm, a
   warm share hit rate of 1.0, no retry, failed batch or breaker trip,
   and every score within 1e-5 of a ``backend="numpy"`` server's; then
   one fresh request with a scripted ``FaultInjector`` error, retried to
   the numpy server's scores; then a ``DispatchServer`` of 2 torch worker
   processes on the same session serves the 32 requests again: scores
   within 1e-5 of the in-process ones, each worker's profile of the card
   measured, trunk rows in the workers' ``ServerStats``, no worker death,
   redispatch, retry or failed batch. It logs wall seconds, rows/s,
   latency percentiles, coalescing and the launches of each round;
6b. the multi-device tier: ``make_backends("torch", device_count=visible
   + 1)`` clamps to the visible GPUs (one card: a plain ``TorchBackend``,
   no mesh); ``MeshTorchBackend`` over every visible GPU and over
   ``(cuda:0, cuda:0)`` runs the phase-4 table (2^20 x 16) in 2^16-row
   chunks in all four trunk modes, each held to a single-device
   ``TorchBackend`` and the numpy oracle at atol 1e-5, the linear mode's
   ``fused_embed`` launches exactly shards x chunks; wall seconds against
   the single device and ``device_ms`` of one shard's launch; then
   ``calibrate`` through the 2-entry mesh (``device_count == 2``, both
   rates measured), and a session whose pool is that mesh (reached through
   ``repro_torch.launch.mesh.visible_devices``) runs phase 4's PREDICT and
   one 32-request ``MorphingServer`` round, held to the numpy session and
   server at 1e-5 (``stats().devices == 2``); then a 1-rank NCCL world
   over a ``FileStore``: ``compressed_all_reduce`` of h2o-danube-1.8b's
   first-layer gradients within one quantisation step (residuals too),
   uncompressed exact, and a 1-stage ``gpipe_apply`` forward and backward
   against the sequential run;
7. LM path, h2o-danube-1.8b at full width and depth (random weights from
   ``--seed``), through ``repro_torch.models`` / ``repro_torch.launch.serve``:
   a float32 copy, B = 4, prompt 1024, 16 teacher-forced decode steps, and
   B = 1, prompt 8192 (past the 4096 window, so decode runs on the
   circular cache), each logit held against the plain route (every kernel
   replaced by its plain version, chunked attention) at atol 1e-3; then
   the bfloat16 config through ``ServingEngine.generate`` (slots from the
   cost model, prompt 512, gen 32), timed; then the same serving run
   through the launcher's ``main`` as a user calls it. The launch counts
   of both are held to 24 flash_attention per prefill, 24 (gen - 1)
   decode_attention and 49 gen rmsnorm per slot chunk;
7b. the MoE, SSM and hybrid families at full width and depth (random
   weights from ``--seed``, each model freed before the next):
   olmoe-1b-7b (B 2, prompt 1024), mamba2-370m (B 4, prompt 1024) and
   recurrentgemma-9b (B 1, prompt 4096, past its 2048 window), each as a
   float32 copy with 8 teacher-forced decode steps held against the plain
   route at atol 1e-3 (olmoe under a routing rule: the MoE routing
   decisions that differ between the routes are counted per layer and at
   most 1% may differ; the logits are held on the rows whose decisions
   agreed in every layer), then the bf16 config through
   ``ServingEngine.generate`` (32 slots, prompt 512, gen 32), timed, with
   its peak memory and one decode profile; gemma-2b's float32 check (dense,
   head dim 256: B 2, prompt 1024); then the launcher's ``main`` for
   olmoe-1b-7b (1 slot from the cost model, 4 requests). Launch counts
   are held to each config's layers: flash_attention / decode_attention /
   rmsnorm 16 / 16 / 33 (olmoe), 0 / 0 / 49 (mamba2), 12 / 12 / 77
   (recurrentgemma) a prefill / step / forward, times the slot chunks;
8. time every kernel and its plain version with CUDA events at the main
   paths' shapes (``fused_embed`` at 256, 2^20 and 1 rows; ``rmsnorm``
   also at 4096 x 16384, its multi-warp register instance; the attention
   kernels also at recurrentgemma-9b's served shapes, head dim 256 with
   one kv head: flash at B 32, S 512, window 2048, decode at a 2048-slot
   cache; flash at whisper's encoder, B 32, 16 heads, S 1500, D 64,
   non-causal), after holding
   the two together on those very inputs,
   beside the least time the card could take (H100 SXM data
   sheet: 3.35 TB/s HBM, 67 TFLOP/s float32, 989 TFLOP/s bf16 dense
   tensor) and one PyTorch library call where one computes the same
   function (``F.rms_norm``, ``F.scaled_dot_product_attention``; for flash
   at S <= window both the band-mask call and ``is_causal=True``, for
   whisper's encoder ``is_causal=False``); for the
   kernels and the library calls also the card's own time a call under
   ``torch.profiler`` (``device_ms``) and its share of the bound, which a
   call of a few µs needs: CUDA events over back-to-back calls then read
   the host. ``device_ms`` traces after a thrown-away warm-up step and
   holds each kernel's event count to a whole multiple of the calls
   (once more, then it raises), so a trace that lost events is not read.
   Then the bf16 flash backward kernel at danube-train's, whisper's
   encoder, olmoe's and gemma-2b's training shapes
   (``flash_backward_timings``), held to its plain twin fed the kernel's
   own o and lse, beside the plain chunked backward and autograd through
   SDPA;
9. (run before 8) whisper-medium (arXiv:2212.04356) at full width and
   depth, nothing cut (24 + 24 layers, d 1024, 16 heads of 64, random
   weights from ``--seed``): a float32 copy, B 2 x 1500 frames, a 440-token
   prefill and 8 teacher-forced decode steps, every logit held against the
   plain route at atol 1e-3; then bf16 serving, 32 slots x 1500 frames x a
   64-token prompt -> 64 tokens after a warm-up (``prefill`` with max_len
   128, then ``make_serve_step``), timed, with its peak memory and a decode
   profile; launches held to 72 flash_attention a prefill (24 encoder + 24
   decoder self + 24 cross), 48 decode_attention a step and no rmsnorm
   (whisper's norms are layernorms);
10. training: ``loss`` and ``torch.autograd.grad`` of h2o-danube-1.8b
   (float32, full width and depth, B 1 x 1024) and of whisper-medium
   (float32, B 2 x 1500 frames x 448 tokens) through the kernel route
   (rmsnorm and flash_attention through their autograd Functions) and the
   plain route: each leaf's max |g_kernel - g_plain| within 1e-3 of
   max |g_plain| or, past that, within twice a naive-attention plain
   route's spread on the leaf (its float32 floor), losses within 1e-4;
   then bf16 h2o-danube-1.8b through
   the training launcher's loop (``repro_torch.launch.train.train``,
   4 steps of 8 x 4096 tokens in micro-batches of 2): finite losses and
   grad norms, params moved, no ``failure`` or ``restart`` event (the
   controller retries a failing step), launches a micro-batch those of a
   forward and its remat recompute (48 flash_attention, 97 rmsnorm) and
   24 launches of flash's backward kernel (none in the float32 checks);
   step seconds, tokens/s, the model FLOPs share (6 N tokens over the
   step and 989 TFLOP/s) and peak memory;
11. the sharded LM, on the (1, 1) ``("data", "model")`` device mesh of a
   1-rank NCCL world: (a) one h2o-danube-1.8b train step (full width, 2
   layers, float32, B 2 x 1024) from params placed by their logical axes
   (``shard_params``, DTensor) under ``axis_rules``, against the same
   step off the mesh: loss within 1e-4 and every param within 5e-3 (the
   reference's ``tests/test_distributed.py`` bounds), every gradient the
   step updates with within 1e-4 of its leaf's largest off the mesh, the
   rmsnorm and flash_attention launches equal to the step's off the mesh;
   (b)
   olmoe-1b-7b's MoE block at full width (64 experts, top 8, d 2048),
   float32, x (2, 512, 2048) x 0.5: ``moe_apply(mesh=...)`` (the
   expert-parallel branch) against the single-device call, y within 1e-4
   and its gradient within 1e-4 of each leaf's max, and aux within 1e-5 of
   ``moe_dense``'s; (c) the launcher with ``--mesh host`` at phase
   10's cell (bf16, 8 x 4096, accum 4) for 3 steps, in a 1-rank world it
   starts itself: launches those of phase 10, step seconds (median of
   steps 2-3), tokens/s and peak memory beside phase 10's; (d) (a) for
   gemma-2b (2 layers, its 8 q heads whole over ``"model"``), mamba2-370m
   (2 layers, the SSD heads split over ``"model"``) and recurrentgemma-9b
   (3 layers: two RG-LRU blocks, the width split, and a local attention
   block at head dim 256; its AdamW moments in bf16, as the dry run keeps
   the largest configs', so that its step fits the card);

12. the dry run (``repro_torch.launch.dryrun``) against the card: (a)
   h2o-danube-1.8b ``decode_32k`` at full shape on a 1-rank NCCL world's
   (1, 1) mesh: ``lower_cell`` with the mesh swapped for it gives argument
   bytes equal to the bytes of the params, cache and tokens placed on the
   card (``memory_allocated`` grows by them, give or take the allocator's
   512-byte rounding of each tensor); the real serve step on the kernel
   route from a random cache gives the next tokens of the step off the
   mesh, 24 ``decode_attention`` (through ``decode_attention_partial``)
   and 49 ``rmsnorm`` launches a step; its device time beside the
   record's memory term; (b) danube's train_4k, prefill_32k, decode_32k
   and long_500k, olmoe-1b-7b's, gemma-2b's and recurrentgemma-9b's
   train_4k, and gemma-2b's and mamba2-370m's prefill_32k traced on fake
   CUDA tensors over a 256-rank fake world, each in a process of its own
   started before phase 11: every roofline term positive, the useful
   FLOPs ratio in (0, 1.5], the FLOPs a device within 5% of the
   reference's own dry run's (a constant of this script, printed beside
   it), olmoe's expert-parallel collectives recorded
   (the experts' FSDP all-gathers and the all-reduce combine a layer),
   danube decode_32k's argument bytes at most (a)'s / 16. Phase 3 also holds
   ``decode_attention_partial`` over 1, 2 and 4 slices, merged by
   ``combine_partials``, to the whole kernel (danube's and
   recurrentgemma's shapes, a slice wholly past length included) and logs
   the bf16 decode gap to the reference's rounded decode.

The last three lines are the ``nvidia-smi`` name/power-limit line, one
JSON object with the kernel table, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12         # H100 SXM data sheet, float32 non-tensor
BF16_FLOPS_PER_S = 989e12       # H100 SXM data sheet, bf16 dense tensor
# the share of a kernel's events a profiler trace may lose before
# device_ms stops reading it
DEVICE_EVENTS_LOST = 0.1
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ATTN_F32_TOL = 5e-5             # softmax over up to 4096 keys, other order
# bf16 attention: both sides compute in f32 and round once to bf16, so
# they differ by at most one ulp of the value (BF16_RTOL) beyond f32 noise
ATTN_BF16_TOL = 2e-4
BF16_RTOL = 2.0 ** -7           # one bf16 ulp of the value
LM_ARCH = "h2o-danube-1.8b"
LM_F32_ATOL = 1e-3              # full-depth f32 logits, kernel vs plain
LM_RUNS = ((4, 1024), (1, 8192))  # (B, prompt) of the f32 route checks
LM_STEPS = 16                   # teacher-forced decode steps after each
SERVE_PROMPT, SERVE_GEN = 512, 32
LONG_S = 8192                   # the long prefill: past the 4096 window
# phase 7b: the MoE, SSM and hybrid families at full width and depth, and
# gemma-2b (dense, head dim 256); arch -> (B, prompt) of the f32 check
FAMILIES = {"olmoe-1b-7b": (2, 1024), "mamba2-370m": (4, 1024),
            "recurrentgemma-9b": (1, 4096)}   # past its 2048 window
D256_DENSE = ("gemma-2b", 2, 1024)
FAMILY_STEPS = 8
# flash_attention a prefill, decode_attention a step, rmsnorm a forward
FAMILY_LAUNCHES = {"olmoe-1b-7b": (16, 16, 33), "mamba2-370m": (0, 0, 49),
                   "recurrentgemma-9b": (12, 12, 77),
                   "gemma-2b": (18, 18, 37)}
ROUTE_DIFF_MAX = 0.01           # share of MoE routing decisions that differ
SERVE_SLOTS = 32                # the families' bf16 serving runs
CLI_ARCH, CLI_REQUESTS = "olmoe-1b-7b", 4   # the launcher's run: 1 slot
ROW_ATOL = 1e-5
# phase 9: whisper-medium at full width and depth. f32 check: (B, frames,
# decoder context, teacher-forced decode steps); bf16 serving: slots x
# frames (its 30 s window) x prompt -> gen tokens
WHISPER = "whisper-medium"
WHISPER_F32 = (2, 1500, 448, 8)
WHISPER_SLOTS, WHISPER_PROMPT, WHISPER_GEN = 32, 64, 64
# phase 10: training. f32 gradient checks: per leaf max |g_kernel - g_plain|
# within GRAD_RTOL of max |g_plain| or GRAD_SPREAD times two plain routes'
# spread on the leaf (see grad_check), losses within LOSS_ATOL; bf16 training
# through the launcher at the reference's TRAIN_4K length, micro-batches of
# 2 (a temporary --ckpt-dir is added; --ckpt-every above --steps: a
# checkpoint with AdamW state would be ~18 GB)
GRAD_RTOL, GRAD_SPREAD, LOSS_ATOL = 1e-3, 2.0, 1e-4
TRAIN_GRAD_LM = (1, 1024)
TRAIN_ARGV = ["--arch", LM_ARCH, "--steps", "4", "--batch", "8", "--seq",
              "4096", "--accum", "4", "--ckpt-every", "100", "--log-every",
              "1"]
# phase 11: the sharded LM on a 1-rank NCCL world's (1, 1) ("data",
# "model") mesh. (a) h2o-danube-1.8b at full width, SHARD_LAYERS layers,
# float32, SHARD_BATCH: one train step on the mesh against the same step
# off it, at the reference test's bounds (tests/test_distributed.py);
# (b) olmoe-1b-7b's MoE block at full width, float32, x EP_X * 0.5:
# moe_apply on the mesh (the EP branch) against the single-device call, y
# EP_Y_TOL and its gradient within EP_GRAD_RTOL of the largest, and aux
# within EP_AUX_TOL of moe_dense's; (c) the launcher with --mesh host at phase
# 10's cell, SHARD_TRAIN_STEPS steps
SHARD_LAYERS, SHARD_BATCH = 2, (2, 1024)
# (d) the same check for the families whose cores split over "model" (or,
# gemma's heads, stay whole over it), at full width, float32: arch ->
# (layers, AdamW moments' dtype). recurrentgemma's one pattern cycle (two
# RG-LRU blocks and its local attention, flash at head dim 256) keeps its
# moments in bf16, as the dry run does for the largest configs: in f32
# its step's params, gradients, moments and their updates (1.64 B
# params, 6.55 GB each) and the update's temporaries outgrow 80 GB
SHARD_FAMILIES = {"gemma-2b": (2, "float32"),
                  "mamba2-370m": (2, "float32"),
                  "recurrentgemma-9b": (3, "bfloat16")}
SHARD_LOSS_TOL, SHARD_PARAM_TOL = 1e-4, 5e-3
# a first AdamW step in warm-up moves each param by about lr / 100 = 1e-5
# whatever its gradient: (a) and (d) also hold the gradients the step
# updates with, each leaf within SHARD_GRAD_RTOL of its largest value off
# the mesh (the EP check's measure)
SHARD_GRAD_RTOL = 1e-4
EP_ARCH, EP_X = "olmoe-1b-7b", (2, 512)
EP_Y_TOL, EP_AUX_TOL, EP_GRAD_RTOL = 1e-4, 1e-5, 1e-4
SHARD_TRAIN_STEPS = 3
# phase 12c: decode_attention_partial's check shapes (B, Hq, Hkv, W, D):
# danube's decode_32k cell as phase 12a runs it (its global batch of 128,
# the 4096 window: 1.3 GB of bf16 cache), 32 serving slots of danube, and
# recurrentgemma's G 16 x D 256
PARTIAL_SHAPES = ((128, 32, 8, 4096, 80), (32, 32, 8, 4096, 80),
                  (8, 16, 1, 2048, 256))
PARTIAL_F32_TOL, PARTIAL_LSE_TOL = 1e-5, 1e-3
DECODE_GAP = {}                 # shape -> the bf16 decode gap (logged)
# phase 12: the dry run. (a) DRY_ARCH's DRY_SHAPE at full shape on the
# 1-rank world's (1, 1) mesh, DRY_STEPS decode steps; (b) DRY_CELLS traced
# on a 256-rank fake world
DRY_ARCH, DRY_SHAPE, DRY_STEPS = "h2o-danube-1.8b", "decode_32k", 4
DRY_DECODE_LAUNCHES = 24        # one a layer, on the (1, 1) mesh's 1 rank
# (b) each cell with the reference's flops_per_device: its own dry run
# (python -m repro.launch.dryrun --all --mesh single, XLA on a CPU with
# 256 forced devices), written down here
DRY_REF_FLOPS = {
    ("h2o-danube-1.8b", "train_4k"): 6.347425e13,
    ("h2o-danube-1.8b", "prefill_32k"): 1.848985e13,
    ("h2o-danube-1.8b", "decode_32k"): 2.252472e9,
    ("h2o-danube-1.8b", "long_500k"): 1.759744e7,
    ("olmoe-1b-7b", "train_4k"): 5.091684e13,
    ("gemma-2b", "train_4k"): 7.906176e13,
    ("gemma-2b", "prefill_32k"): 2.643995e13,
    ("recurrentgemma-9b", "train_4k"): 2.698614e14,
    ("mamba2-370m", "prefill_32k"): 3.416123e12}
DRY_CELLS = tuple(DRY_REF_FLOPS)
DRY_FLOPS_RTOL = 0.05           # the port's count against the reference's
DRY_USEFUL_MAX = 1.5
ALLOC_ROUND = 512               # the caching allocator's rounding a tensor
FLASH_DESIGN = ("bf16: mma.sync m16n8k16 + cp.async, P as bf16 hi/lo; "
                "f32: FMA; bf16 backward: FlashAttention-2 over k tiles from "
                "the forward's lse, P and dS as bf16 hi/lo, dQ by f32 atomics")
DECODE_DESIGN = ("split-KV + combine; bf16: mma.sync over the GQA group, "
                 "a 16-byte cp.async ring per warp; f32: FMA")
RMSNORM_DESIGN = ("register path: a row held in registers by 1-16 warps, "
                  "streaming 16-byte loads/stores, warp-shuffle sum, "
                  "persistent grid, next row prefetched; else one block a row")
EMBED_DESIGN = ("staged path: w staged once a persistent block, each warp "
                "walks its own row tiles: x by 16-byte cp.async into a "
                "2-stage ring, a row a lane against broadcast w columns, f32 "
                "FMA + tanhf, the tile out by a bulk (TMA) store from a "
                "double-buffered shared tile; else D-chunked w slabs")
SQL_AVG = ("SELECT gender, AVG(t(emb)) FROM reviews WHERE len > 20 "
           "GROUP BY gender")
SQL_PREDICT = "PREDICT emb USING TASK t FROM reviews WHERE len > 190"
CREATE_T = ("CREATE TASK t (INPUT=Series, OUTPUT IN ('POS','NEG','NEU'), "
            "TYPE='Classification');")
# the served path: 32 overlapping requests a round, 4 of each cut
SERVE_CUTS = (180, 182, 184, 186, 188, 190, 192, 194)
SERVE_REQUESTS = [f"PREDICT emb USING TASK t FROM reviews WHERE len > {c}"
                  for c in SERVE_CUTS] * 4
SERVE_FAULT_SQL = "PREDICT emb USING TASK t FROM reviews WHERE len < 3"
DISPATCH_WORKERS = 2
# phase 6b: the mesh backend runs the SQL path's table in chunks of this
MESH_CHUNK = 1 << 16
RESULT_TIMEOUT_S = 600.0


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# -- phase 3: kernel against its plain version ------------------------------

def compare_kernel(fused_embed, fused_embed_ref, dev):
    shapes = ([(n, 16, k) for n in (1, 32, 100, 256, 511)
               for k in (8, 28, 33, 40)]
              + [(64, 32, 64), (512, 32, 64), (4096, 1024, 512),
                 (4099, 64, 33), (257, 16, 1), (1000, 16, 512),
                 (0, 16, 33)])
    g = torch.Generator(device="cpu").manual_seed(1)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for n, d, k in shapes:
        x32 = torch.randn((n, d), generator=g).to(dev)
        w = (torch.randn((d, k), generator=g) * 0.05).to(dev)
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for mean, scale in ((0.0, 1.0), (0.5, 2.0)):
                got = fused_embed(x, w, mean=mean, scale=scale)
                torch.cuda.synchronize()
                want = fused_embed_ref(x, w, mean, scale)
                torch.cuda.synchronize()
                check(got.shape == (n, k) and got.dtype == dtype,
                      f"fused_embed shape/dtype {got.shape} {got.dtype}")
                err = (float((got.float() - want.float()).abs().max())
                       if n else 0.0)
                check(err < TOL[dtype], f"fused_embed {n}x{d}x{k} {dtype} "
                      f"mean={mean} scale={scale}: err {err}")
                worst[dtype] = max(worst[dtype], err)
                errs.append(f"{str(dtype)[6:]}/{mean}/{scale}={err:.2e}")
        log(f"compare fused_embed N={n} D={d} K={k}: " + " ".join(errs))
    return worst


def _close(got, want, dtype, atol):
    """(max |got - want|, its largest part beyond one bf16 ulp of the value
    in bfloat16, within atol plus that ulp)."""
    g, w = got.float(), want.float()
    if not g.numel():
        return 0.0, 0.0, True
    diff = (g - w).abs()
    beyond = diff - (BF16_RTOL * w.abs() if dtype == torch.bfloat16 else 0.0)
    return (float(diff.max()), max(0.0, float(beyond.max())),
            bool((beyond <= atol).all()))


def _attn_tol(dtype):
    return ATTN_F32_TOL if dtype == torch.float32 else ATTN_BF16_TOL


def compare_lm_kernels(dev):
    """rmsnorm / flash_attention / decode_attention against their plain
    versions: the LM path's full-width shapes plus ragged ones."""
    from repro_torch.kernels import decode_attention, flash_attention, rmsnorm
    from repro_torch.kernels.decode_attention import _split_plan
    from repro_torch.kernels.ref import (decode_attention_ref,
                                         flash_attention_ref, rmsnorm_ref)
    g = torch.Generator(device="cpu").manual_seed(3)
    worst = {n: {torch.float32: 0.0, torch.bfloat16: 0.0}
             for n in ("rmsnorm", "flash_attention", "decode_attention")}
    beyond_ulp = {n: 0.0 for n in worst}

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev, dtype)

    def record(name, dtype, got, want, atol, what):
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name} {what}: {got.shape} {got.dtype}")
        err, beyond, ok = _close(got, want, dtype, atol)
        check(ok, f"{name} {what} {dtype}: err {err}, beyond one ulp "
              f"{beyond} > {atol}")
        worst[name][dtype] = max(worst[name][dtype], err)
        if dtype == torch.bfloat16:
            beyond_ulp[name] = max(beyond_ulp[name], beyond)
        return err

    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        errs = []
        for n, d in ((1, 2560), (4, 2560), (32, 2560), (16384, 2560),
                     (2000, 16384), (3000, 1024), (37, 80), (5, 7)):
            x, w = randn((n, d), dtype), randn((d,), dtype, 0.1)
            errs.append(record("rmsnorm", dtype, rmsnorm(x, w),
                               rmsnorm_ref(x, w), TOL[dtype], f"{n}x{d}"))
        log(f"compare rmsnorm {tag}: max err {max(errs):.2e}")
        atol = _attn_tol(dtype)
        for B, Hq, Hkv, S, D, causal, window in (
                (1, 8, 2, 100, 80, True, 7), (2, 4, 4, 37, 128, False, 16),
                (1, 4, 4, 1, 16, True, None), (2, 8, 2, 65, 80, True, 64),
                (3, 8, 8, 63, 32, True, 1), (1, 16, 2, 129, 128, False, 7),
                (2, 32, 8, 300, 80, True, None),
                (32, 32, 8, SERVE_PROMPT, 80, True, 4096),
                (4, 32, 8, 1024, 80, True, 4096),
                (1, 32, 8, LONG_S, 80, True, 4096),
                # phase 7b's shapes: olmoe (D 128), gemma-2b and
                # recurrentgemma (D 256, MQA, a 2048 window), ragged S
                (2, 16, 16, 1024, 128, True, None),
                (2, 8, 1, 1024, 256, True, None),
                (32, 16, 1, SERVE_PROMPT, 256, True, 2048),
                (1, 16, 1, 4096, 256, True, 2048),
                (1, 16, 2, 300, 256, False, 33),
                # whisper-medium (D 64, no GQA): encoder, decoder self
                (2, 16, 16, 1500, 64, False, None),
                (32, 16, 16, 64, 64, True, None)):
            # the model's [B, S, H, D] layout, read through strided views
            q = randn((B, S, Hq, D), dtype).transpose(1, 2)
            k = randn((B, S, Hkv, D), dtype).transpose(1, 2)
            v = randn((B, S, Hkv, D), dtype).transpose(1, 2)
            got = flash_attention(q, k, v, causal=causal, window=window)
            G = Hq // Hkv
            errs = [record("flash_attention", dtype, got[:, h * G:(h + 1) * G],
                           flash_attention_ref(q[:, h * G:(h + 1) * G],
                                               k[:, h:h + 1], v[:, h:h + 1],
                                               causal=causal, window=window),
                           atol, f"B={B} S={S} kv head {h}")
                    for h in range(Hkv)]
            log(f"compare flash_attention {tag} B={B} Hq={Hq} Hkv={Hkv} S={S} "
                f"D={D} causal={causal} window={window}: max err "
                f"{max(errs):.2e}")
        # whisper's cross-attention: non-causal with Sq != Sk
        for B, H, Sq, Sk in ((2, 16, 440, 1500), (32, 16, 64, 1500),
                             (2, 16, 1500, 64)):
            q = randn((B, Sq, H, 64), dtype).transpose(1, 2)
            k = randn((B, Sk, H, 64), dtype).transpose(1, 2)
            v = randn((B, Sk, H, 64), dtype).transpose(1, 2)
            err = record("flash_attention", dtype,
                         flash_attention(q, k, v, causal=False),
                         flash_attention_ref(q, k, v, causal=False), atol,
                         f"cross B={B} Sq={Sq} Sk={Sk}")
            log(f"compare flash_attention {tag} cross B={B} H={H} Sq={Sq} "
                f"Sk={Sk} D=64: max err {err:.2e}")
        for B, Hq, Hkv, W, D in ((32, 32, 8, 4096, 80), (4, 32, 8, 4096, 80),
                                 (1, 32, 8, 4096, 80), (64, 32, 8, 4096, 80),
                                 (3, 16, 2, 384, 16),
                                 # olmoe; gemma-2b; recurrentgemma's G·D 4096
                                 (32, 16, 16, 544, 128), (2, 8, 1, 1032, 256),
                                 (32, 16, 1, 2048, 256),
                                 (1, 16, 1, 2048, 256),
                                 # whisper: G 1, D 64, the 1500-frame cache
                                 (32, 16, 16, 1500, 64)):
            q = randn((B, Hq, D), dtype)
            kc = randn((B, W, Hkv, D), dtype).transpose(1, 2)
            vc = randn((B, W, Hkv, D), dtype).transpose(1, 2)
            errs = []
            chunk = _split_plan(B, Hkv, W)[0]      # split edges at length W
            for length in (1, 528, 600, chunk - 1, chunk, chunk + 1, W,
                           torch.randint(1, W + 1, (B,), generator=g).to(dev)):
                if isinstance(length, int) and length > W:
                    continue
                errs.append(record(
                    "decode_attention", dtype,
                    decode_attention(q, kc, vc, length),
                    decode_attention_ref(q, kc, vc, length), atol,
                    f"B={B} W={W} length={length}"))
            log(f"compare decode_attention {tag} B={B} Hq={Hq} Hkv={Hkv} W={W}"
                f" D={D}: max err {max(errs):.2e}")
        compare_decode_partial(dev, dtype, randn, record)
        if dtype == torch.bfloat16:
            decode_bf16_gap(dev, randn)
    log("compare bf16, largest error beyond one ulp of the value: " + ", ".join(
        f"{n} {e:.3e}" for n, e in beyond_ulp.items()))
    return worst


def compare_decode_partial(dev, dtype, randn, record):
    """(phase 12c) ``decode_attention_partial`` over 1, 2 and 4 contiguous
    slices of the cache, merged by ``combine_partials``, against the whole
    ``decode_attention`` at danube's and recurrentgemma's decode shapes:
    within one bf16 ulp plus ATTN_BF16_TOL, or PARTIAL_F32_TOL in f32; each
    slice's o against the plain twin's at the attention bound and its lse
    within PARTIAL_LSE_TOL. One length leaves the last slices wholly past
    it: o = 0, lse = -inf."""
    from repro_torch.kernels.decode_attention import (
        combine_partials, decode_attention, decode_attention_partial)
    from repro_torch.kernels.ref import decode_attention_partial_ref
    tag = str(dtype)[6:]
    atol = PARTIAL_F32_TOL if dtype == torch.float32 else ATTN_BF16_TOL
    for B, Hq, Hkv, W, D in PARTIAL_SHAPES:
        q = randn((B, Hq, D), dtype)
        kc = randn((B, W, Hkv, D), dtype).transpose(1, 2)
        vc = randn((B, W, Hkv, D), dtype).transpose(1, 2)
        errs, lse_err, o_err, empty = [], 0.0, 0.0, 0
        for length in (W, W - 7, W // 4 + 3):
            whole = decode_attention(q, kc, vc, length)
            for n in (1, 2, 4):
                ws = W // n
                os_, ls_ = [], []
                for i in range(n):
                    ks, vs = (c[:, :, i * ws:(i + 1) * ws] for c in (kc, vc))
                    ln = max(0, min(length - i * ws, ws))
                    o, lse = decode_attention_partial(q, ks, vs, ln)
                    ro, rl = decode_attention_partial_ref(q, ks, vs, ln)
                    torch.cuda.synchronize()
                    if ln == 0:
                        check(bool(torch.isneginf(lse).all())
                              and not bool(o.abs().max() > 0),
                              f"decode_attention_partial: a slice past "
                              f"length {length} gave lse {lse.max()} and "
                              f"|o| {o.abs().max()}")
                        empty += 1
                    else:
                        e = float((lse - rl).abs().max())
                        check(e <= PARTIAL_LSE_TOL, f"decode_attention_"
                              f"partial {tag} lse err {e} at B={B} W={W} "
                              f"slice {i} of {n}, length {length}")
                        lse_err = max(lse_err, e)
                        e, _, ok = _close(o, ro, torch.float32,
                                          _attn_tol(dtype))
                        check(ok, f"decode_attention_partial {tag} o err "
                              f"{e} at B={B} W={W} slice {i} of {n}, "
                              f"length {length}")
                        o_err = max(o_err, e)
                    os_.append(o)
                    ls_.append(lse)
                errs.append(record(
                    "decode_attention", dtype,
                    combine_partials(os_, ls_, dtype), whole, atol,
                    f"partial B={B} W={W} {n} slices, length {length}"))
        log(f"compare decode_attention_partial {tag} B={B} Hq={Hq} Hkv={Hkv}"
            f" W={W} D={D} over 1/2/4 slices: max err vs the whole kernel "
            f"{max(errs):.2e} (bound {atol} beyond one ulp in bf16); each "
            f"slice vs the plain twin: max o err {o_err:.2e}, max lse err "
            f"{lse_err:.2e}; {empty} slices wholly past length")


def decode_bf16_gap(dev, randn):
    """The bf16 decode gap: the kernel keeps scores and probabilities in
    f32, the reference's model-level decode rounds the scaled q and the
    probabilities to the cache dtype (``models.attention.
    decode_attention``). Logged at danube's and recurrentgemma's decode
    shapes, a full window, beside the kernel's gap to the f32 plain
    version."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ref import decode_attention_ref
    from repro_torch.models.attention import \
        decode_attention as rounded_decode
    for B, Hq, Hkv, W, D in PARTIAL_SHAPES:
        q = randn((B, 1, Hq, D), torch.bfloat16)
        kc = randn((B, W, Hkv, D), torch.bfloat16)
        vc = randn((B, W, Hkv, D), torch.bfloat16)
        got = decode_attention(q.reshape(B, Hq, D), kc.transpose(1, 2),
                               vc.transpose(1, 2), W).float()
        rounded = rounded_decode(q, kc, vc, W - 1, window=W).reshape(
            B, Hq, D).float()
        f32 = decode_attention_ref(q.reshape(B, Hq, D), kc.transpose(1, 2),
                                   vc.transpose(1, 2), W).float()
        torch.cuda.synchronize()
        gap = (got - rounded).abs()
        ulps = gap / (BF16_RTOL * rounded.abs()).clamp(min=1e-30)
        log(f"bf16 decode gap B={B} Hq={Hq} Hkv={Hkv} W={W} D={D}: kernel vs "
            f"the reference's rounded decode max {float(gap.max()):.3e} "
            f"(mean {float(gap.mean()):.3e}, median "
            f"{float(ulps.median()):.2f} ulp of the value, max |value| "
            f"{float(rounded.abs().max()):.3e}); kernel vs f32 plain max "
            f"{float((got - f32).abs().max()):.3e}")
        DECODE_GAP[(B, Hq, Hkv, W, D)] = float(gap.max())


# -- phase 4: the SQL path --------------------------------------------------

def make_table(rows: int, seed: int):
    rng = np.random.default_rng(seed)
    return {"gender": rng.integers(0, 2, rows),
            "len": rng.integers(1, 200, rows),
            "emb": rng.standard_normal((rows, 16)).astype(np.float32)}


def main_path(args, fused_embed):
    from repro_torch.core import (ModelSelector, TaskFeaturizer, build_tasks,
                                  build_zoo, make_task, transfer_matrix)
    from repro_torch.engine import EngineConfig, MorphingSession

    zoo = [m for m in build_zoo(16, seed=0) if m.mode == "linear"]
    hist = build_tasks(24, seed=1)
    fz = TaskFeaturizer()
    feats = np.stack([fz.features(t.X, t.y) for t in hist])
    sel = ModelSelector(k=2).fit_offline(transfer_matrix(zoo, hist), feats,
                                         zoo=zoo)
    log(f"main path zoo: {[(m.name, tuple(m.W.shape)) for m in zoo]}")
    table = make_table(args.rows, args.seed)
    sample = make_task(np.random.default_rng(args.seed + 7), "gauss",
                       n=128, dim=16, classes=3)

    sessions = {}
    for backend in ("torch", "numpy"):
        sess = MorphingSession(selector=sel, zoo=zoo,
                               config=EngineConfig(backend=backend))
        sess.register_table("reviews", table)
        sess.sql(CREATE_T)
        sessions[backend] = sess

    sess = sessions["torch"]
    check(sess.hw is not None and sess.hw["cuda"].measured,
          "auto-calibration did not measure the torch backend")
    tb = sess.backends["cuda"]
    check(tb.device.type == "cuda", f"torch backend on {tb.device}")
    rm = sess.resolve_task("t", sample.X, sample.y)
    check(rm.zoo_model.mode == "linear",
          f"resolved {rm.model_id} in mode {rm.zoo_model.mode}")
    log(f"resolved t -> {rm.model_id} mode={rm.zoo_model.mode} "
        f"W={tuple(rm.zoo_model.W.shape)}")

    out = {}
    for label, sql in (("cold", SQL_AVG), ("warm", SQL_AVG),
                       ("predict", SQL_PREDICT)):
        fused_embed.launch_count = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sess.sql(sql)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[label] = (res, fused_embed.launch_count, secs)
        log(f"query {label}: {secs:.4f} s, launches={out[label][1]}, "
            f"rows_in={res.report.rows_in} rows_out={res.report.rows_out} "
            f"share_hit_rate={res.report.share_hit_rate} "
            f"compile_count={res.report.compile_count} "
            f"backend_of={sorted(set(res.report.backend_of.values()))} "
            f"op_seconds={res.report.op_seconds} "
            f"infer_seconds={res.report.batch_infer_seconds:.4f}")
    cold, warm, pred = out["cold"], out["warm"], out["predict"]
    check(cold[1] > 0, "fused_embed was not launched by the cold query")
    check(warm[1] == 0, f"warm query launched fused_embed {warm[1]} times")
    check(warm[0].report.share_hit_rate == 1.0,
          f"warm share hit rate {warm[0].report.share_hit_rate}")
    check(warm[0].report.compile_count == 0, "warm query saw new shapes")
    check(tb.stage_count == 1, f"stage_count {tb.stage_count}")
    check(set(cold[0].report.backend_of.values()) == {"torch"},
          f"backends {cold[0].report.backend_of}")

    ref = sessions["numpy"]
    ref.resolve_task("t", sample.X, sample.y)
    check(ref.models["t"].model_id == rm.model_id,
          "numpy session resolved another model")
    for label, sql in (("cold", SQL_AVG), ("warm", SQL_AVG),
                       ("predict", SQL_PREDICT)):
        t0 = time.perf_counter()
        want = ref.sql(sql).rows
        if label == "predict":
            predict_want = want
        log(f"numpy session query {label}: "
            f"{time.perf_counter() - t0:.4f} s")
        got = out[label][0].rows
        check(list(got) == list(want), f"{label} columns differ")
        worst = 0.0
        for col in want:
            a = np.asarray(got[col], np.float64)
            b = np.asarray(want[col], np.float64)
            check(a.shape == b.shape, f"{label}.{col} shape differs")
            check(bool(np.all(np.isfinite(a))), f"{label}.{col} not finite")
            worst = max(worst, float(np.abs(a - b).max()) if a.size else 0.0)
        check(worst <= ROW_ATOL, f"{label} rows differ from numpy by {worst}")
        log(f"rows {label}: torch vs numpy max abs diff {worst:.3e} "
            f"({len(next(iter(got.values())))} rows)")
    log(f"cold AVG rows: {dict((k, np.asarray(v).tolist()) for k, v in cold[0].rows.items())}")
    return {"launches": cold[1], "cold_s": cold[2], "warm_s": warm[2],
            "predict_s": pred[2], "predict_launches": pred[1],
            "model": rm.model_id, "K": int(rm.zoo_model.W.shape[1]),
            "stage_count": tb.stage_count,
            "world": {"sel": sel, "zoo": zoo, "table": table,
                      "sample": sample, "predict_want": predict_want}}


# -- phase 5: the quickstart query ------------------------------------------

def quickstart():
    from repro_torch.core import (ModelSelector, TaskFeaturizer, build_tasks,
                                  build_zoo, make_task, transfer_matrix)
    from repro_torch.engine import EngineConfig, MorphingSession

    zoo = build_zoo(16, seed=0)
    hist = build_tasks(32, seed=1)
    fz = TaskFeaturizer()
    feats = np.stack([fz.features(t.X, t.y) for t in hist])
    sel = ModelSelector(k=6, n_anchors=3).fit_offline(
        transfer_matrix(zoo, hist), feats, zoo=zoo)
    db = MorphingSession(selector=sel, zoo=zoo,
                         config=EngineConfig(backend="torch"))
    rng = np.random.default_rng(0)
    n = 600
    db.register_table("reviews", {
        "gender": rng.integers(0, 2, n), "len": rng.integers(1, 200, n),
        "emb": rng.standard_normal((n, 16)).astype(np.float32)})
    db.sql("CREATE TASK sentiment_classifier (INPUT=Series, "
           "OUTPUT IN ('POS','NEG','NEU'), TYPE='Classification');")
    sample = make_task(rng, "gauss", n=128, dim=16, classes=3)
    res = db.sql("SELECT gender, AVG(sentiment_classifier(emb)) FROM "
                 "reviews WHERE len > 20 GROUP BY gender;",
                 sample=(sample.X, sample.y))
    rm = db.models["sentiment_classifier"]
    scores = np.asarray(res.rows["mean__score"])
    check(scores.shape == (2,) and bool(np.all(np.isfinite(scores))),
          f"quickstart rows {res.rows}")
    log(f"quickstart: resolved {rm.model_id} mode={rm.zoo_model.mode}, "
        f"rows={dict((k, np.asarray(v).tolist()) for k, v in res.rows.items())}")


# -- phase 6: the served path ------------------------------------------------

def _serve_round(server_of, requests, fused_embed, label):
    """Serve ``requests`` concurrently through a fresh server, stopped
    (lanes joined) before the launch count is read. Returns (scores of
    each request, ServerStats, launches, wall seconds, the server)."""
    fused_embed.launch_count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with server_of() as srv:
        ids = [srv.submit(q) for q in requests]
        scores = [srv.result(i, timeout=RESULT_TIMEOUT_S).scores
                  for i in ids]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = fused_embed.launch_count
    st = srv.stats()
    rows = sum(len(x) for x in scores)
    log(f"served {label}: {len(requests)} requests, {rows} rows in "
        f"{secs:.4f} s ({rows / secs:.1f} rows/s), launches={launches}, "
        f"lanes={[(ln.key, ln.device) for ln in srv._lanes.values()]}, "
        f"p50={st.p50_latency_s:.4f} s p95={st.p95_latency_s:.4f} s, "
        f"mean_coalesced={st.mean_coalesced:.2f} batches={st.batches}, "
        f"embed_rows={st.embed_rows} embed_batches={st.embed_batches} "
        f"dedup_rows={st.dedup_rows} share_hit_rate={st.share_hit_rate:.4f}"
        f", batch_rows_by_lane={st.batch_rows_by_lane}, retries="
        f"{st.retries} failed_batches={st.failed_batches} breaker_trips="
        f"{st.breaker_trips}")
    return scores, st, launches, secs, srv


def _fault_free(st, label):
    check(st.retries == 0 and st.failed_batches == 0
          and st.breaker_trips == 0,
          f"{label}: retries {st.retries}, failed batches "
          f"{st.failed_batches}, breaker trips {st.breaker_trips}")


def _same_scores(got, want, label):
    worst = 0.0
    for a, b in zip(got, want, strict=True):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        check(a.shape == b.shape, f"{label}: shape {a.shape} != {b.shape}")
        check(bool(np.all(np.isfinite(a))), f"{label}: scores not finite")
        worst = max(worst, float(np.abs(a - b).max()) if a.size else 0.0)
    check(worst <= ROW_ATOL, f"{label}: scores differ by {worst}")
    return worst


def served_path(world, fused_embed, model_id, torch_device="cuda"):
    """The online serving tier on the card: ``MorphingServer`` lanes and a
    ``DispatchServer`` of worker processes, both over the SQL path's
    table and linear zoo, held against a ``backend="numpy"`` server."""
    import tempfile

    from repro_torch.engine import (AdmissionPolicy, DispatchServer,
                                    EngineConfig, MorphingServer,
                                    MorphingSession)
    from repro_torch.pipeline.cost import choose_device, op_cost
    from repro_torch.training import FaultInjector

    table = world["table"]
    hint = max(int((table["len"] > c).sum()) for c in SERVE_CUTS)
    # one retry for the fault round; the queue cap of a deployment whose
    # requests run to 10^5 rows (the default 65536 would reject them)
    policy = AdmissionPolicy(retry_limit=1, max_queue_rows=1 << 24)
    tmp = tempfile.TemporaryDirectory(prefix="served-")
    root = Path(tmp.name)

    def session(backend, devices):
        sess = MorphingSession(
            selector=world["sel"], zoo=world["zoo"],
            root=root / f"{backend}-{'-'.join(devices)}",
            config=EngineConfig(model_store="decoupled", backend=backend,
                                devices=devices, policy=policy,
                                torch_device=torch_device))
        sess.register_table("reviews", table)
        sess.sql(CREATE_T)
        rm = sess.resolve_task("t", world["sample"].X, world["sample"].y)
        check(rm.model_id == model_id,
              f"served session resolved {rm.model_id}, not {model_id}")
        return sess

    try:
        sess = session("auto", ("host", "cuda"))
        rm = sess.models["t"]
        picks = {}
        for n in (hint, 2048):
            costs = {d: op_cost(rm.profile, n, d, sess.hw)
                     for d in sess.devices}
            picks[n] = choose_device(rm.profile, n, sess.devices, sess.hw)
            log(f"Eq. 10 at {n} rows: op_cost " + ", ".join(
                f"{d} {c:.6e} s" for d, c in costs.items())
                + f" -> {picks[n]}")
        if "host" in picks.values():
            # a deployment that pins the trunk to the card
            log("Eq. 10 picks the host at "
                f"{[n for n, d in picks.items() if d == 'host']} rows: the "
                "served phase runs with EngineConfig(devices=('cuda',))")
            sess = session("auto", ("cuda",))
        check(sess.hw is not None and sess.hw["cuda"].measured,
              "served session: the card's profile was not measured")
        ref = session("numpy", ("host", "cuda"))

        def server(s):
            return lambda: MorphingServer(session=s, nrows_hint=hint)

        want, _, _, rsecs, _ = _serve_round(server(ref), SERVE_REQUESTS,
                                            fused_embed, "numpy server")
        out = {}
        for label in ("cold", "warm"):
            got, st, launches, secs, srv = _serve_round(
                server(sess), SERVE_REQUESTS, fused_embed, label)
            check(all(ln.device == "cuda" for ln in srv._lanes.values()),
                  f"{label}: lanes on {[ln.device for ln in srv._lanes.values()]}")
            _fault_free(st, label)
            err = _same_scores(got, want, f"served {label} vs numpy")
            log(f"served {label} vs numpy server: max abs diff {err:.3e}")
            out[label] = {"scores": got, "stats": st, "launches": launches,
                          "secs": secs, "err": err}
        check(out["cold"]["launches"] > 0,
              "the cold round launched no fused_embed")
        check(out["warm"]["launches"] == 0,
              f"the warm round launched fused_embed "
              f"{out['warm']['launches']} times")
        check(out["warm"]["stats"].share_hit_rate == 1.0,
              f"warm share hit rate {out['warm']['stats'].share_hit_rate}")

        # one injected fault on a fresh request, retried through the lane
        fi = FaultInjector(scripted_errors={0})
        sess.backends.set_fault_injector(fi)
        try:
            got, st, f_launches, _, _ = _serve_round(
                server(sess), [SERVE_FAULT_SQL], fused_embed, "fault round")
        finally:
            fi.disarm()
            sess.backends.set_fault_injector(None)
        want_f, _, _, _, _ = _serve_round(server(ref), [SERVE_FAULT_SQL],
                                          fused_embed, "numpy fault round")
        check(fi.injected_errors == 1 and st.retries >= 1
              and st.failed_batches == 0,
              f"fault round: injected {fi.injected_errors}, retries "
              f"{st.retries}, failed batches {st.failed_batches}")
        check(f_launches > 0, "the fault round's retry launched no kernel")
        f_err = _same_scores(got, want_f, "fault round vs numpy")

        # the dispatch tier: worker processes, each its own CUDA context
        dsrv = DispatchServer(session=sess, workers=DISPATCH_WORKERS,
                              worker_backend="torch",
                              start_timeout_s=RESULT_TIMEOUT_S,
                              lease_timeout_s=RESULT_TIMEOUT_S)
        t0 = time.perf_counter()
        dsrv.start()
        start_s = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            ids = [dsrv.submit(q) for q in SERVE_REQUESTS]
            got = [dsrv.result(i, timeout=RESULT_TIMEOUT_S).scores
                   for i in ids]
            d_secs = time.perf_counter() - t0
            dst = dsrv.stats()
            hw = {w: h.hw for w, h in dsrv._workers.items()}
        finally:
            dsrv.stop()
        d_rows = sum(len(x) for x in got)
        d_err = _same_scores(got, out["cold"]["scores"],
                             "dispatch vs in-process")
        for w, prof in hw.items():
            check(prof is not None and prof["cuda"].measured,
                  f"dispatch worker {w} did not measure the card")
        check(sum(ws.embed_rows for ws in dst.per_worker.values()) > 0,
              "no dispatch worker ran a trunk")
        check(dst.worker_deaths == 0 and dst.redispatches == 0
              and dst.retries == 0 and dst.failed_batches == 0,
              f"dispatch: deaths {dst.worker_deaths}, redispatches "
              f"{dst.redispatches}, retries {dst.retries}, failed batches "
              f"{dst.failed_batches}")
        log(f"dispatch: {DISPATCH_WORKERS} workers up in {start_s:.2f} s; "
            f"{len(SERVE_REQUESTS)} requests, {d_rows} rows in {d_secs:.4f} s "
            f"({d_rows / d_secs:.1f} rows/s), leases={dst.leases} "
            f"scale_outs={dst.scale_outs}, per worker (embed_rows, "
            f"embed_batches, rows): " + str({
                w: (ws.embed_rows, ws.embed_batches, ws.rows)
                for w, ws in dst.per_worker.items()})
            + ", worker profiles (cuda flops/s, launch s): " + str({
                w: (p["cuda"].flops_per_s, p["cuda"].launch_latency_s)
                for w, p in hw.items()})
            + f"; vs in-process max abs diff {d_err:.3e}")
    finally:
        tmp.cleanup()
    cold, warm = out["cold"], out["warm"]
    rows = sum(len(x) for x in cold["scores"])
    return {"launches": cold["launches"], "picks": picks,
            "devices": sess.devices, "cold_s": cold["secs"],
            "warm_s": warm["secs"], "numpy_s": rsecs, "rows": rows,
            "err": max(cold["err"], warm["err"], f_err, d_err),
            "dispatch_start_s": start_s, "dispatch_s": d_secs,
            "want": want, "hint": hint}


# -- phase 6b: the multi-device tier -----------------------------------------

def _by_mode(world, model_id):
    """One zoo model of each trunk mode: the SQL path's resolved linear
    model, and the first of each other mode in the 16-model zoo."""
    from repro_torch.core import build_zoo
    out = {"linear": next(m for m in world["zoo"] if m.name == model_id)}
    for m in build_zoo(16, seed=0):
        out.setdefault(m.mode, m)
    return out


def _embed_table(backend, zm, X, version):
    """Every MESH_CHUNK-row chunk of X through ``backend.run_infer``
    (staged and warmed up first): (features, wall seconds, launches)."""
    from repro_torch.kernels.fused_embed import fused_embed
    from repro_torch.pipeline.backend import InferSpec
    from repro_torch.pipeline.batcher import BatcherStats

    spec = InferSpec(kind="embed", task="t", col="x", out="f", table="m",
                     version=version, model=SimpleNamespace(zoo_model=zm),
                     stats=BatcherStats())
    backend.stage(version, zm)
    backend.run_infer(spec, {"x": X[:MESH_CHUNK]})
    backend.synchronize()
    fused_embed.launch_count = 0
    t0 = time.perf_counter()
    out = np.concatenate([backend.run_infer(spec, {"x": X[i:i + MESH_CHUNK]})
                          ["f"] for i in range(0, len(X), MESH_CHUNK)])
    backend.synchronize()
    return out, time.perf_counter() - t0, fused_embed.launch_count


def _max_diff(a, b, label):
    check(a.shape == b.shape, f"{label}: shape {a.shape} != {b.shape}")
    check(bool(np.all(np.isfinite(a))), f"{label}: not finite")
    return float(np.abs(np.asarray(a, np.float64) - b).max())


def mesh_path(world, model_id, predict_want, serve_want, hint, dev,
              torch_device="cuda"):
    """(a) the clamp of a too-wide pool; (b) MeshTorchBackend over every
    visible GPU and over (cuda:0, cuda:0) at the SQL path's table, all
    four trunk modes against TorchBackend and numpy; (c) calibration, the
    SQL PREDICT and one served round through a 2-entry mesh session.
    ``torch_device="cpu"`` rehearses it on the CPU, where only the launch
    counts fail."""
    import tempfile

    import repro_torch.launch.mesh as mesh_mod
    from repro_torch.engine import (AdmissionPolicy, EngineConfig,
                                    MorphingServer, MorphingSession)
    from repro_torch.engine.session import _calib_rows
    from repro_torch.kernels.fused_embed import fused_embed
    from repro_torch.launch.mesh import ServingMesh
    from repro_torch.pipeline.backend import (MeshTorchBackend, TorchBackend,
                                              make_backends)
    from repro_torch.pipeline.cost import calibrate

    n_vis = len(mesh_mod.visible_devices(torch_device))
    cuda0 = torch.device(torch_device, 0)
    # (a) a request past the visible GPUs clamps to them
    pool = make_backends("torch", device_count=n_vis + 1,
                         torch_device=torch_device)
    if n_vis == 1:
        check(type(pool["cuda"]) is TorchBackend and pool.mesh is None
              and pool.device_count == 1,
              f"clamp: {type(pool['cuda']).__name__}, mesh {pool.mesh}")
    else:
        check(type(pool["cuda"]) is MeshTorchBackend
              and pool.device_count == n_vis, f"clamp: {pool.device_count}")
    log(f"mesh clamp: device_count={n_vis + 1} asked, {n_vis} visible -> "
        f"{type(pool['cuda']).__name__}, device_count={pool.device_count}, "
        f"mesh={pool.mesh}")
    del pool

    # (b) the mesh backend at the SQL path's size, every trunk mode
    X = world["table"]["emb"]
    chunks = -(-len(X) // MESH_CHUNK)
    meshes = {"all": MeshTorchBackend(device=torch_device),
              "dup": MeshTorchBackend(ServingMesh((cuda0, cuda0)))}
    res = {}
    for mode, zm in _by_mode(world, model_id).items():
        want = np.concatenate([zm.features(X[i:i + MESH_CHUNK])
                               for i in range(0, len(X), MESH_CHUNK)])
        single, s_secs, s_l = _embed_table(
            TorchBackend(device=torch_device), zm, X, f"mesh-{mode}")
        check(s_l == (chunks if mode == "linear" else 0),
              f"{mode}: single device launched fused_embed {s_l} times")
        for label, b in meshes.items():
            got, secs, launches = _embed_table(b, zm, X, f"mesh-{mode}")
            want_l = b.device_count * chunks if mode == "linear" else 0
            check(launches == want_l, f"{mode} mesh {label}: {launches} "
                  f"fused_embed launches, not {want_l}")
            e_s = _max_diff(got, single, f"{mode} mesh {label} vs single")
            e_o = _max_diff(got, want, f"{mode} mesh {label} vs numpy")
            check(max(e_s, e_o) <= ROW_ATOL, f"{mode} mesh {label}: max abs "
                  f"diff {e_s} vs single, {e_o} vs numpy")
            res[(mode, label)] = {"secs": secs, "single_s": s_secs,
                                  "launches": launches,
                                  "shards": b.device_count}
            log(f"mesh {label} {[str(d) for d in b.mesh.devices]} {mode} "
                f"K={got.shape[1]}: {len(X)} rows in {chunks} chunks, "
                f"{secs:.4f} s (single device {s_secs:.4f} s, split cost "
                f"{secs / s_secs:.3f}x), launches={launches}, max abs diff "
                f"{e_s:.3e} vs single, {e_o:.3e} vs numpy")
    W = torch.from_numpy(_by_mode(world, model_id)["linear"].W).to(dev)
    xs = torch.from_numpy(X[:MESH_CHUNK]).to(dev)
    shard_ms, _ = device_ms(lambda: fused_embed(xs[:MESH_CHUNK // 2], W), 50)
    chunk_ms, _ = device_ms(lambda: fused_embed(xs, W), 50)
    log(f"mesh device_ms: fused_embed a shard ({MESH_CHUNK // 2} x 16 -> "
        f"{W.shape[1]}) {shard_ms:.5f} ms, a whole chunk ({MESH_CHUNK} "
        f"rows) {chunk_ms:.5f} ms")

    # (c) calibration, the SQL path and a served round through the mesh
    prof = calibrate(meshes["dup"], "cuda", rows=_calib_rows("cuda"))
    check(prof.measured and prof.device_count == 2 and prof.flops_per_s > 0
          and prof.device_flops_per_s > 0, f"mesh calibration: {prof}")
    log(f"mesh calibrate (cuda:0, cuda:0): flops_per_s={prof.flops_per_s:.6e}"
        f" device_flops_per_s={prof.device_flops_per_s:.6e} launch="
        f"{prof.launch_latency_s:.6e} s device_count={prof.device_count}")
    real = mesh_mod.visible_devices
    mesh_mod.visible_devices = lambda device_type="cuda": (
        (cuda0, cuda0) if device_type == torch_device else real(device_type))
    tmp = tempfile.TemporaryDirectory(prefix="mesh-")
    try:
        sess = MorphingSession(
            selector=world["sel"], zoo=world["zoo"], root=Path(tmp.name),
            config=EngineConfig(model_store="decoupled", backend="torch",
                                devices=("cuda",), device_count=2,
                                torch_device=torch_device,
                                policy=AdmissionPolicy(
                                    retry_limit=1, max_queue_rows=1 << 24)))
    finally:
        mesh_mod.visible_devices = real
    try:
        mb = sess.backends["cuda"]
        check(sess.device_count == 2 and isinstance(mb, MeshTorchBackend)
              and mb.mesh.devices == (cuda0, cuda0),
              f"mesh session: device_count {sess.device_count}, {mb}")
        check(sess.hw is not None and sess.hw["cuda"].measured
              and sess.hw["cuda"].device_count == 2,
              "mesh session: the mesh profile was not measured")
        sess.register_table("reviews", world["table"])
        sess.sql(CREATE_T)
        rm = sess.resolve_task("t", world["sample"].X, world["sample"].y)
        check(rm.model_id == model_id, f"mesh session resolved {rm.model_id}")
        fused_embed.launch_count = 0
        t0 = time.perf_counter()
        got = sess.sql(SQL_PREDICT)
        torch.cuda.synchronize()
        p_secs = time.perf_counter() - t0
        p_l = fused_embed.launch_count
        check(p_l > 0 and p_l == 2 * got.report.batch_batches,
              f"mesh PREDICT launches {p_l}, not 2 a chunk "
              f"({got.report.batch_batches} chunks embedded)")
        p_err = max(_max_diff(np.asarray(got.rows[c]),
                              np.asarray(predict_want[c], np.float64),
                              f"mesh PREDICT {c}") for c in predict_want)
        check(p_err <= ROW_ATOL, f"mesh PREDICT differs from numpy by {p_err}")
        log(f"mesh session PREDICT: {got.report.rows_in} rows in "
            f"{p_secs:.4f} s, launches={p_l}, embed batches="
            f"{got.report.batch_batches}, max abs diff vs numpy {p_err:.3e}")
        scores, st, s_l, s_secs, srv = _serve_round(
            lambda: MorphingServer(session=sess, nrows_hint=hint),
            SERVE_REQUESTS, fused_embed, "mesh server")
        _fault_free(st, "mesh server")
        check(all(ln.device == "cuda" for ln in srv._lanes.values()),
              f"mesh server lanes on "
              f"{[ln.device for ln in srv._lanes.values()]}")
        check(st.devices == 2 and st.mesh_rows_per_s > 0,
              f"mesh server: devices {st.devices}, mesh_rows_per_s "
              f"{st.mesh_rows_per_s}")
        check(s_l > 0 and s_l == 2 * st.embed_batches,
              f"mesh server launches {s_l}, not 2 a batch "
              f"({st.embed_batches} embed batches)")
        s_err = _same_scores(scores, serve_want, "mesh server vs numpy")
        log(f"mesh server vs numpy server: max abs diff {s_err:.3e}, "
            f"mesh_rows_per_s={st.mesh_rows_per_s:.1f}")
    finally:
        tmp.cleanup()
    return {"b": res, "shard_device_ms": shard_ms, "chunk_device_ms": chunk_ms,
            "chunks": chunks, "predict_s": p_secs, "predict_launches": p_l,
            "serve_s": s_secs, "serve_launches": s_l,
            "err": max(p_err, s_err)}


def distributed_path(dev):
    """(d) a 1-rank NCCL world over a FileStore: compressed_all_reduce of
    h2o-danube-1.8b's first-layer gradients, and a 1-stage gpipe_apply
    forward and backward against the sequential run. On a CPU ``dev`` (a
    rehearsal) the world is gloo."""
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import (compressed_all_reduce,
                                         compression_ratio, gpipe_apply,
                                         init_ef_state)
    from repro_torch.models import build_model
    from repro_torch.models.spec import tree_map_specs
    from repro_torch.training.optimizer import tree_leaves

    nccl = dev.type == "cuda"
    check(dist.is_nccl_available() or not nccl, "torch.distributed has no NCCL")
    g = torch.Generator(device=dev).manual_seed(5)
    layer = build_model(get_config(LM_ARCH)).specs()["layers"]
    grads = tree_map_specs(
        lambda s: torch.randn(s.shape[1:], generator=g, device=dev) * 1e-3,
        layer)
    with tempfile.TemporaryDirectory(prefix="nccl-") as tmp:
        dist.init_process_group(
            "nccl" if nccl else "gloo",
            store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device())
            if nccl else None)
        try:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            red, ef = compressed_all_reduce(grads, init_ef_state(grads))
            torch.cuda.synchronize(dev)
            c_secs = time.perf_counter() - t0
            plain, _ = compressed_all_reduce(grads, ef, enabled=False)
            worst = 0.0
            for gl, rl, el, pl in zip(tree_leaves(grads), tree_leaves(red),
                                      tree_leaves(ef.residual),
                                      tree_leaves(plain)):
                step = float(gl.abs().max()) / 127.0
                err = float((rl - gl).abs().max())
                check(err <= step and float(el.abs().max()) <= step,
                      f"compressed all-reduce: err {err}, residual "
                      f"{float(el.abs().max())}, step {step}")
                check(torch.equal(pl, gl), "uncompressed all-reduce moved")
                worst = max(worst, err / step)
            n = sum(x.numel() for x in tree_leaves(grads))
            log(f"nccl 1 rank: compressed_all_reduce of {LM_ARCH} layer 0 "
                f"({n} values) in {c_secs:.4f} s, worst error "
                f"{worst:.4f} of a quantisation step, wire ratio "
                f"{compression_ratio(grads):.4f}; uncompressed exact")

            D, L, M, mb = 256, 2, 8, 4
            Ws = (torch.randn((L, D, D), generator=g, device=dev)
                  * (0.5 / D ** 0.5)).requires_grad_()
            x = torch.randn((M, mb, D), generator=g, device=dev)

            def stage(W, h):
                for w in W:
                    h = torch.tanh(h @ w)
                return h
            out = gpipe_apply(stage, Ws, x)
            out.sum().backward()
            g_pipe, Ws.grad = Ws.grad, None
            want = torch.stack([stage(Ws, x[m]) for m in range(M)])
            want.sum().backward()
            f_err = float((out - want).abs().max().detach())
            g_err = float((g_pipe - Ws.grad).abs().max())
            g_max = float(Ws.grad.abs().max())
            check(f_err <= 1e-6 and g_err <= 1e-5 * g_max,
                  f"gpipe 1 stage: forward {f_err}, grads {g_err} of {g_max}")
            log(f"nccl 1 rank: gpipe_apply {M} x {mb} x {D}, {L} layers: "
                f"forward {f_err:.3e}, grads {g_err:.3e} (max |g| "
                f"{g_max:.3e}) against the sequential run")
        finally:
            dist.destroy_process_group()
    return {"compress_s": c_secs, "compress_worst_steps": worst}


# -- phase 7: the LM path ---------------------------------------------------

LM_KERNELS = ("rmsnorm", "flash_attention", "decode_attention")
# each wrapper's device kernels, by the names the profiler shows
PROFILE_KERNELS = {
    "rmsnorm": ("rmsnorm_kernel", "rmsnorm_reg_kernel"),
    "flash_attention": ("flash_mma_kernel", "flash_fma_kernel"),
    "decode_attention": ("decode_mma_kernel", "decode_fma_kernel",
                         "decode_combine_kernel")}


def _lm_kernels():
    from repro_torch.kernels import decode_attention, flash_attention, rmsnorm
    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
            "decode_attention": decode_attention}


def _zero_counts():
    torch.cuda.synchronize()
    for fn in _lm_kernels().values():
        fn.launch_count = 0
    _lm_kernels()["flash_attention"].backward_launch_count = 0


def _read_counts(backward: bool = False):
    """Launches of each LM kernel since ``_zero_counts``; with ``backward``
    also flash's backward kernel's, as ``flash_attention_backward``."""
    torch.cuda.synchronize()
    kernels = _lm_kernels()
    counts = {n: fn.launch_count for n, fn in kernels.items()}
    if backward:
        counts["flash_attention_backward"] = (
            kernels["flash_attention"].backward_launch_count)
    return counts


def lm_launches(cfg):
    """(attention layers, rmsnorm launches a forward) of a config: one
    flash_attention a prefill and one decode_attention a step for each
    attention layer; two norms for each attention or RG-LRU block, one for
    each SSM block, one final norm (``_qk_norm`` and mamba's gated norm
    stay plain, as in the reference)."""
    kinds = cfg.layer_kinds()
    return (sum(k == "attn" for k in kinds),
            sum(1 if k == "ssm" else 2 for k in kinds) + 1)


class RouteLog:
    """Records every MoE routing decision while active: it wraps
    ``repro_torch.models.moe._route`` and keeps, for each call (one MoE
    layer's tokens), each token's expert set and which of its copies the
    batched implementation keeps under its per-expert capacity ``cap_e``.
    A token's decision is that pair."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._orig = moe, moe._route

        def route(cfg, router_w, x2d):
            probs, gate, idx, aux = self._orig(cfg, router_w, x2d)
            T, k = idx.shape
            E = cfg.moe.num_experts
            cap_e = moe._capacity(T * k, E, cfg.moe.capacity_factor)
            flat = idx.reshape(-1)
            order = torch.argsort(flat, stable=True)
            counts = torch.bincount(flat, minlength=E)
            starts = torch.cumsum(counts, 0) - counts
            rank = torch.empty_like(order)
            rank[order] = torch.arange(T * k, device=idx.device)
            kept = (rank - starts[flat]).reshape(T, k) < cap_e
            srt, perm = torch.sort(idx, dim=1)
            self.calls.append((srt, torch.gather(kept, 1, perm)))
            return probs, gate, idx, aux

        moe._route = route
        return self

    def __exit__(self, *exc):
        self._moe._route = self._orig


def _route_diffs(a: RouteLog, b: RouteLog, B: int):
    """Per MoE call, the tokens whose decisions differ between two runs;
    the batch rows that saw any such token (a prefill call's T = B * S
    tokens are row-major, a decode call's T = B); decisions in all."""
    check(len(a.calls) == len(b.calls), f"routing calls {len(a.calls)} != "
          f"{len(b.calls)}")
    per_call, bad_rows, total = [], set(), 0
    for (ia, ka), (ib, kb) in zip(a.calls, b.calls):
        T = ia.shape[0]
        differ = ((ia != ib) | (ka != kb)).any(dim=1)
        per_call.append(int(differ.sum()))
        total += T
        for t in differ.nonzero().flatten().tolist():
            bad_rows.add(t // (T // B))
    return per_call, bad_rows, total


@torch.inference_mode()
def lm_teacher_forced(cfg, params, tokens, steps: int, label: str,
                      frames=None):
    """Prefill ``tokens[:, :-steps]`` (against ``frames`` for an
    encoder-decoder config) and feed the last ``steps`` tokens one decode
    step at a time, through the kernel route and then the plain route on
    the same params; every step's logits are held together.

    An MoE config logs its routing decisions on both routes (``RouteLog``):
    a 1e-6 difference between the kernel and the plain version can swap
    two experts on a near-tie, which moves that row's logits far more than
    the tolerance without any kernel fault. So the check counts the
    decisions that differ, per layer, fails if more than
    ``ROUTE_DIFF_MAX`` of them do, and holds the logits of the rows whose
    decisions agreed in every layer, failing if no row is left."""
    from repro_torch.models import build_model
    P = tokens.shape[1] - steps
    B = tokens.shape[0]
    out, routes = {}, {}
    for use in (True, False):
        m = build_model(cfg, attn_impl="chunked", use_kernels=use)
        if use:
            _zero_counts()
        routes[use] = RouteLog()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prompt = (tokens[:, :P] if frames is None
                  else {"frames": frames, "tokens": tokens[:, :P]})
        with routes[use] if cfg.is_moe else contextlib.nullcontext():
            lg, st = m.prefill(params, prompt, max_len=P + steps)
            logits = [lg]
            for t in range(P, P + steps):
                lg, st = m.decode_step(params, st, tokens[:, t:t + 1])
                logits.append(lg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _read_counts() if use else None
        out[use] = (logits, secs, counts)
        del st
    got, k_s, counts = out[True]
    want, p_s, _ = out[False]
    rows = list(range(B))
    route_note = ""
    if cfg.is_moe:
        per_call, bad, total = _route_diffs(routes[True], routes[False], B)
        n_moe = sum(k == "attn" for k in cfg.layer_kinds())
        per_layer = [sum(per_call[i::n_moe]) for i in range(n_moe)]
        share = sum(per_call) / total
        rows = [b for b in rows if b not in bad]
        route_note = (f"; routing decisions differing {sum(per_call)} of "
                      f"{total} ({share:.2e}), per layer {per_layer}, rows "
                      f"held {rows} of {B}")
        log(f"lm {label}: routing decisions that differ between the routes, "
            f"per layer: {per_layer} of {total // n_moe} a layer")
        check(share <= ROUTE_DIFF_MAX, f"{label}: {share:.2e} of the routing "
              f"decisions differ (> {ROUTE_DIFF_MAX})")
        check(bool(rows), f"{label}: every row's routing differs somewhere")
    diffs = []
    for a, b in zip(got, want):
        check(a.shape == (B, 1, cfg.padded_vocab) and bool(
            torch.isfinite(a).all()), f"{label}: logits {a.shape} not finite")
        diffs.append(float((a[rows].float() - b[rows].float()).abs().max()))
    if cfg.is_encoder_decoder:
        n_flash, n_dec = encdec_launches(cfg)
        want_counts = {"flash_attention": n_flash,
                       "decode_attention": n_dec * steps, "rmsnorm": 0}
    else:
        n_attn, norms = lm_launches(cfg)
        want_counts = {"flash_attention": n_attn,
                       "decode_attention": n_attn * steps,
                       "rmsnorm": norms * (steps + 1)}
    check(counts == want_counts, f"{label}: launches {counts} != "
          f"{want_counts}")
    check(max(diffs) <= LM_F32_ATOL, f"{label}: logits differ from the "
          f"plain route by {max(diffs)}")
    log(f"lm {label}: prefill {P} + {steps} decode steps, B={B}: kernel "
        f"route {k_s:.3f} s, plain route {p_s:.3f} s; launches {counts}; "
        f"max |logit - plain| prefill {diffs[0]:.3e}, decode steps "
        f"{max(diffs[1:]):.3e} (atol {LM_F32_ATOL}){route_note}")
    return {"prefill_err": diffs[0], "decode_err": max(diffs[1:]),
            "launches": counts, "kernel_s": k_s, "plain_s": p_s,
            "rows_held": len(rows)}


def _kernel_events(prof) -> dict:
    """(device µs, event count) by kernel name in a ``torch.profiler``
    trace. Kernel events only: a CPU op's self device time is its kernels'
    time again, and counting both would count each kernel twice."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            us, n = by_name.get(e.key, (0.0, 0))
            by_name[e.key] = (us + e.self_device_time_total, n + e.count)
    return by_name


def _kernel_us(prof) -> dict:
    """Device µs by kernel name in a ``torch.profiler`` trace."""
    return {k: us for k, (us, _) in _kernel_events(prof).items()}


@torch.inference_mode()
def profile_decode(engine, prompts, steps: int):
    """torch.profiler over ``steps`` decode steps of the serving engine
    (after a prefill of ``prompts``): see :func:`profile_steps`."""
    m, params = engine.model, engine.params
    chunk = torch.as_tensor(prompts, dtype=torch.long, device=engine.device)
    logits, state = m.prefill(params, chunk, max_len=engine.max_len)
    tok = logits[:, -1:, :].argmax(dim=-1)
    box = [tok, state]

    def step():
        box[0], box[1] = engine.serve_step(params, box[1], box[0])

    return profile_steps(step, steps, f"decode steps (B={chunk.shape[0]})")


def profile_steps(step, steps: int, label: str):
    """torch.profiler over ``steps`` calls of ``step`` (after one warm
    call): device time by kernel, the LM kernels' share of it, and the
    device's busy share of the wall time. The caller picks the grad mode
    (serving steps run under ``inference_mode``)."""
    from torch.profiler import ProfilerActivity, profile
    step()                                              # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = _kernel_us(prof)
    total = sum(by_name.values())
    ours = {n: sum(us for k, us in by_name.items()
                   if any(name in k for name in names))
            for n, names in PROFILE_KERNELS.items()}
    log(f"profile {steps} {label}: wall "
        f"{wall_us / steps / 1e3:.3f} ms a step, device busy "
        f"{total / steps / 1e3:.3f} ms a step ({total / wall_us:.3f} of the "
        f"wall); LM kernels {', '.join(f'{n} {us / steps / 1e3:.3f} ms' for n, us in ours.items())}"
        f" a step ({sum(ours.values()) / max(total, 1e-9):.3f} of device "
        "time)")
    for k, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"profile   {us / steps / 1e3:9.4f} ms/step  {k[:100]}")
    return {"wall_ms_per_step": wall_us / steps / 1e3,
            "device_ms_per_step": total / steps / 1e3,
            "busy_share": total / wall_us,
            "lm_kernel_ms_per_step": {n: us / steps / 1e3
                                      for n, us in ours.items()}}


def lm_path(args, dev):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    res = {}
    cfg = get_config(LM_ARCH)
    log(f"lm config {cfg.arch_id}: L={cfg.num_layers} d={cfg.d_model} "
        f"Hq={cfg.num_heads} Hkv={cfg.num_kv_heads} hd={cfg.head_dim} "
        f"ff={cfg.d_ff} V={cfg.vocab_size} window={cfg.sliding_window} "
        f"params={cfg.param_count()}")

    # float32 copy, kernel route against the plain route
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = build_model(cfg32).init(gen)
    rng = np.random.default_rng(args.seed)
    res["f32"] = {}
    for B, P in LM_RUNS:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (B, P + LM_STEPS))).to(dev)
        res["f32"][(B, P)] = lm_teacher_forced(
            cfg32, params, toks, LM_STEPS, f"f32 B={B} prompt={P}")
    del params, toks
    torch.cuda.empty_cache()

    # the bf16 config through the serving engine, timed
    prompt, gen_tokens = SERVE_PROMPT, SERVE_GEN
    slots = serve.serving_slots(cfg)
    model = build_model(cfg, attn_impl="chunked")
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    engine = serve.ServingEngine(model, params, max_len=prompt + gen_tokens,
                                 batch_slots=slots, device=dev)
    prompts = rng.integers(0, cfg.vocab_size, (slots, prompt)).astype(
        np.int32)
    engine.generate(prompts[:, :64], 2)          # warm-up: handles, first launches
    engine.stats = dict.fromkeys(engine.stats, 0)
    _zero_counts()
    out = engine.generate(prompts, gen_tokens)
    counts = _read_counts()
    st = engine.stats
    chunks = -(-prompts.shape[0] // slots)
    L = cfg.num_layers
    want_counts = {"flash_attention": L * chunks,
                   "decode_attention": L * (gen_tokens - 1) * chunks,
                   "rmsnorm": (2 * L + 1) * gen_tokens * chunks}
    check(out.shape == (slots, gen_tokens) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab_size, f"generate gave {out.shape}")
    check(counts == want_counts, f"generate launches {counts} != "
          f"{want_counts}")
    decode_tps = st["decode_tokens"] / st["decode_s"]
    log(f"lm serve bf16: slots={slots} (cost model) prompt={prompt} "
        f"gen={gen_tokens}: prefill {st['prefill_s']:.4f} s "
        f"({st['prefill_tokens'] / st['prefill_s']:.1f} tok/s), decode "
        f"{st['decode_s']:.4f} s ({decode_tps:.1f} tok/s); launches "
        f"{counts}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    res["profile"] = profile_decode(engine, prompts, 4)
    del engine, params
    torch.cuda.empty_cache()

    # the launcher as a user runs it: its own weights, prompts and engine
    argv = ["--arch", LM_ARCH, "--requests", str(slots), "--prompt-len",
            str(prompt), "--gen", str(gen_tokens)]
    _zero_counts()
    t0 = time.perf_counter()
    rc = serve.main(argv)
    cli_s = time.perf_counter() - t0
    cli_counts = _read_counts()
    check(rc == 0, f"repro_torch.launch.serve.main exited {rc}")
    check(cli_counts == want_counts, f"serve.main launches {cli_counts} != "
          f"{want_counts}")
    log(f"lm serve cli: python -m repro_torch.launch.serve {' '.join(argv)}: "
        f"{cli_s:.3f} s including weight init; launches {cli_counts}")
    res["serve"] = {"slots": slots, "prompt": prompt, "gen": gen_tokens,
                    "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
                    "decode_tok_s": decode_tps, "launches": cli_counts,
                    "cli_s": cli_s}
    torch.cuda.empty_cache()
    return res


# -- phase 7b: the MoE, SSM and hybrid families -----------------------------

def _want_counts(cfg, chunks: int, gen_tokens: int) -> dict:
    n_attn, norms = lm_launches(cfg)
    return {"flash_attention": n_attn * chunks,
            "decode_attention": n_attn * (gen_tokens - 1) * chunks,
            "rmsnorm": norms * gen_tokens * chunks}


def family_serve(cfg, dev, seed: int, rng):
    """The bf16 config through ``ServingEngine.generate``: SERVE_SLOTS slots
    x SERVE_PROMPT-token prompts -> SERVE_GEN tokens after a warm-up, timed,
    launch counts held to the config's layers, then one decode profile."""
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    model = build_model(cfg, attn_impl="chunked")
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    engine = serve.ServingEngine(model, params,
                                 max_len=SERVE_PROMPT + SERVE_GEN,
                                 batch_slots=SERVE_SLOTS, device=dev)
    prompts = rng.integers(0, cfg.vocab_size,
                           (SERVE_SLOTS, SERVE_PROMPT)).astype(np.int32)
    engine.generate(prompts[:, :64], 2)          # warm-up
    engine.stats = dict.fromkeys(engine.stats, 0)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    out = engine.generate(prompts, SERVE_GEN)
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st = engine.stats
    want = _want_counts(cfg, 1, SERVE_GEN)
    check(out.shape == (SERVE_SLOTS, SERVE_GEN) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab_size,
          f"{cfg.arch_id} generate gave {out.shape}")
    check(counts == want, f"{cfg.arch_id} generate launches {counts} != "
          f"{want}")
    tps = st["decode_tokens"] / st["decode_s"]
    log(f"lm serve {cfg.arch_id} bf16: slots={SERVE_SLOTS} prompt="
        f"{SERVE_PROMPT} gen={SERVE_GEN}: prefill {st['prefill_s']:.4f} s "
        f"({st['prefill_tokens'] / st['prefill_s']:.1f} tok/s), decode "
        f"{st['decode_s']:.4f} s ({tps:.1f} tok/s); launches {counts}; "
        f"peak memory {peak:.2f} GiB")
    prof = profile_decode(engine, prompts, 4)
    del engine, params
    torch.cuda.empty_cache()
    return {"prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
            "decode_tok_s": tps, "peak_gib": peak, "launches": counts,
            "profile": prof}


def lm_families(args, dev):
    """olmoe-1b-7b, mamba2-370m and recurrentgemma-9b at full width and
    depth (random weights from ``--seed``), each freed before the next: a
    float32 copy's kernel route held against its plain route at
    LM_F32_ATOL (olmoe under the routing rule of ``lm_teacher_forced``),
    then the bf16 config served and timed; gemma-2b's f32 check (dense,
    head dim 256); then the launcher's ``main`` for olmoe-1b-7b as a user
    runs it (1 slot from the cost model)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    rng = np.random.default_rng(args.seed + 1)
    res = {}
    runs = [(a, b, p) for a, (b, p) in FAMILIES.items()] + [D256_DENSE]
    for arch, B, P in runs:
        cfg = get_config(arch)
        n_attn, norms = lm_launches(cfg)
        check((n_attn, n_attn, norms) == FAMILY_LAUNCHES[arch],
              f"{arch}: {n_attn} attention layers, {norms} norms a forward, "
              f"not {FAMILY_LAUNCHES[arch]}")
        log(f"lm config {arch}: family={cfg.family} L={cfg.num_layers} "
            f"d={cfg.d_model} Hq={cfg.num_heads} Hkv={cfg.num_kv_heads} "
            f"hd={cfg.resolved_head_dim} kinds={sorted(set(cfg.layer_kinds()))} "
            f"window={cfg.local_attn_window if cfg.family == 'hybrid' else cfg.sliding_window} "
            f"params={cfg.param_count()}")
        cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
        params = build_model(cfg32).init(
            torch.Generator(device=dev).manual_seed(args.seed))
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, P + FAMILY_STEPS))).to(dev)
        res[arch] = {"f32": lm_teacher_forced(
            cfg32, params, toks, FAMILY_STEPS, f"{arch} f32 B={B} prompt={P}")}
        del params, toks
        torch.cuda.empty_cache()
        if arch in FAMILIES:
            res[arch]["serve"] = family_serve(cfg, dev, args.seed, rng)

    cfg = get_config(CLI_ARCH)
    slots = serve.serving_slots(cfg)
    check(slots == 1, f"{CLI_ARCH}: the cost model gave {slots} slots, not 1")
    argv = ["--arch", CLI_ARCH, "--requests", str(CLI_REQUESTS),
            "--prompt-len", str(SERVE_PROMPT), "--gen", str(SERVE_GEN)]
    _zero_counts()
    t0 = time.perf_counter()
    rc = serve.main(argv)
    cli_s = time.perf_counter() - t0
    counts = _read_counts()
    want = _want_counts(cfg, CLI_REQUESTS // slots, SERVE_GEN)
    check(rc == 0, f"repro_torch.launch.serve.main exited {rc}")
    check(counts == want, f"serve.main {CLI_ARCH} launches {counts} != "
          f"{want}")
    log(f"lm serve cli: python -m repro_torch.launch.serve {' '.join(argv)}: "
        f"{cli_s:.3f} s including weight init; slots {slots}; launches "
        f"{counts}")
    res["cli"] = {"arch": CLI_ARCH, "slots": slots, "s": cli_s,
                  "launches": counts}
    torch.cuda.empty_cache()
    return res


# -- phase 9: whisper-medium, the encoder-decoder family -------------------

def encdec_launches(cfg):
    """(flash a prefill, decode_attention a step) of an encoder-decoder
    config: encoder self-attention, decoder self- and cross-attention a
    layer each in prefill; a self and a cross decode a layer a step. Its
    norms are layernorms: no rmsnorm launch."""
    return cfg.num_encoder_layers + 2 * cfg.num_layers, 2 * cfg.num_layers


def _whisper_batch(cfg, dev, rng, B, frames, tokens, dtype):
    return {"frames": torch.from_numpy(rng.standard_normal(
                (B, frames, cfg.d_model)).astype(np.float32)).to(dev, dtype),
            "tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, tokens))).to(dev)}


@torch.inference_mode()
def whisper_generate(model, params, batch, gen: int, max_len: int):
    """Greedy decode as a user drives the enc-dec model: ``prefill`` with a
    ``max_len``, then ``make_serve_step``. Returns (tokens [B, gen],
    prefill s, decode s), each timed from a synchronize to a synchronize."""
    from repro_torch.training import make_serve_step
    serve_step = make_serve_step(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = model.prefill(params, batch, max_len=max_len)
    tok = logits[:, -1:, :].argmax(dim=-1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [tok]
    for _ in range(gen - 1):
        tok, state = serve_step(params, state, tok)
        out.append(tok)
    toks = torch.cat(out, dim=1).cpu()
    t2 = time.perf_counter()
    return toks, t1 - t0, t2 - t1


def whisper_path(args, dev):
    """whisper-medium at full width and depth (random weights from
    ``--seed``): a float32 copy's kernel route held against its plain route
    over a 440-token prefill and 8 teacher-forced decode steps at B 2 x
    1500 frames; then the bf16 config serving WHISPER_SLOTS x 1500 frames x
    a WHISPER_PROMPT-token prompt -> WHISPER_GEN tokens, timed after a
    warm-up, with exact launch counts, peak memory and a decode profile."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import dtype_of
    from repro_torch.training import make_serve_step
    cfg = get_config(WHISPER)
    model = build_model(cfg)
    spec_n = _spec_count(model.specs())
    log(f"whisper config {cfg.arch_id}: L_enc={cfg.num_encoder_layers} "
        f"L_dec={cfg.num_layers} d={cfg.d_model} H={cfg.num_heads} "
        f"hd={cfg.resolved_head_dim} ff={cfg.d_ff} V={cfg.vocab_size} "
        f"(padded {cfg.padded_vocab}) norm={cfg.norm} act={cfg.activation}: "
        f"{spec_n} parameters by the spec tree, cfg.param_count() "
        f"{cfg.param_count()}")
    rng = np.random.default_rng(args.seed + 2)
    res = {"params_spec": spec_n, "params_cfg": cfg.param_count()}

    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    params = build_model(cfg32).init(
        torch.Generator(device=dev).manual_seed(args.seed))
    B, frames, ctx, steps = WHISPER_F32
    batch = _whisper_batch(cfg, dev, rng, B, frames, ctx, torch.float32)
    res["f32"] = lm_teacher_forced(cfg32, params, batch["tokens"], steps,
                                   f"{WHISPER} f32 B={B} frames={frames} "
                                   f"tokens={ctx}", frames=batch["frames"])
    del params, batch
    torch.cuda.empty_cache()

    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    batch = _whisper_batch(cfg, dev, rng, WHISPER_SLOTS, frames,
                           WHISPER_PROMPT, dtype_of(cfg))
    max_len = WHISPER_PROMPT + WHISPER_GEN
    warm = {"frames": batch["frames"][:4], "tokens": batch["tokens"][:4]}
    whisper_generate(model, params, warm, 2, max_len)          # warm-up
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    toks, pre_s, dec_s = whisper_generate(model, params, batch, WHISPER_GEN,
                                          max_len)
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_flash, n_dec = encdec_launches(cfg)
    want = {"flash_attention": n_flash,
            "decode_attention": n_dec * (WHISPER_GEN - 1), "rmsnorm": 0}
    check(tuple(toks.shape) == (WHISPER_SLOTS, WHISPER_GEN)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          f"whisper generate gave {tuple(toks.shape)}")
    check(counts == want, f"whisper generate launches {counts} != {want}")
    tps = WHISPER_SLOTS * (WHISPER_GEN - 1) / dec_s
    log(f"whisper serve bf16: slots={WHISPER_SLOTS} frames={frames} prompt="
        f"{WHISPER_PROMPT} gen={WHISPER_GEN} (max_len {max_len}): prefill "
        f"{pre_s:.4f} s, decode {dec_s:.4f} s ({tps:.1f} tok/s); launches "
        f"{counts}; peak memory {peak:.2f} GiB")

    with torch.inference_mode():
        lg, state = model.prefill(params, batch, max_len=max_len)
        box = [lg[:, -1:, :].argmax(dim=-1), state]
    serve_step = make_serve_step(model)

    def step():
        box[0], box[1] = serve_step(params, box[1], box[0])

    with torch.inference_mode():
        prof = profile_steps(step, 4,
                             f"whisper decode steps (B={WHISPER_SLOTS})")
    del params, batch, box, state, lg
    torch.cuda.empty_cache()
    res["serve"] = {"prefill_s": pre_s, "decode_s": dec_s,
                    "decode_tok_s": tps, "peak_gib": peak,
                    "launches": counts, "profile": prof}
    return res


def _spec_count(specs) -> int:
    """Parameters in a spec tree."""
    if isinstance(specs, dict):
        return sum(_spec_count(v) for v in specs.values())
    return int(np.prod(specs.shape))


# -- phase 10: training ------------------------------------------------------

def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def grad_check(cfg, params, batch, label: str, launches: dict):
    """``loss`` and ``torch.autograd.grad`` through the kernel route and the
    plain route (chunked attention) on the same float32 params, the losses
    within LOSS_ATOL and the kernel route's launches exactly ``launches``.
    Each leaf's ``max |g_kernel - g_plain|`` must be within GRAD_RTOL of
    ``max |g_plain|``, or within GRAD_SPREAD times the spread of two plain
    routes on that leaf (``max |g_naive - g_plain|``, naive attention
    against chunked, no kernel in either): a leaf whose gradient cancels
    to ~1e-4 of the others' (whisper's cross-attention wq / wk, the norm
    before it) sits at the float32 floor, where two plain versions of one
    function differ by ~1e-3 of it too."""
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import tree_leaves, tree_map
    out = {}
    for route, use, impl in (("kernel", True, "chunked"),
                             ("plain", False, "chunked"),
                             ("naive", False, "naive")):
        m = build_model(cfg, attn_impl=impl, use_kernels=use)
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        if use:
            _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = m.loss(tracked, batch)
        grads = torch.autograd.grad(loss, tree_leaves(tracked),
                                    allow_unused=True)
        torch.cuda.synchronize()
        out[route] = (float(loss.detach()), grads,
                      time.perf_counter() - t0,
                      _read_counts(backward=True) if use else None)
        del tracked, loss
    lk, gk, k_s, counts = out["kernel"]
    lp, gp, p_s, _ = out["plain"]
    names = _leaf_names(params)
    worst, floor_bound = (0.0, "", 0.0), []
    for name, a, b, c in zip(names, gk, gp, out["naive"][1]):
        check(a is not None and b is not None, f"{label}: no grad for {name}")
        check(bool(torch.isfinite(a).all()), f"{label}: {name} not finite")
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        spread = float((c - b).abs().max())
        rel = err / max(scale, 1e-30)
        if rel > GRAD_RTOL:
            check(err <= GRAD_SPREAD * spread, f"{label}: {name} grads "
                  f"differ by {rel:.3e} of max |g_plain| {scale:.3e}, "
                  f"{err / max(spread, 1e-30):.2f}x the plain routes' "
                  f"spread {spread:.3e}")
            floor_bound.append(f"{name} {rel:.3e} ({err / spread:.2f}x "
                               "the plain spread)")
        worst = max(worst, (rel, name, scale))
    check(abs(lk - lp) <= LOSS_ATOL, f"{label}: loss {lk} vs plain {lp}")
    check(counts == launches, f"{label}: launches {counts} != {launches}")
    log(f"grads {label}: loss kernel {lk:.6f} plain {lp:.6f} (|diff| "
        f"{abs(lk - lp):.3e}); {len(names)} leaves, worst {worst[1]} at "
        f"{worst[0]:.3e} of max |g_plain| {worst[2]:.3e} (bound {GRAD_RTOL});"
        f" past it, within {GRAD_SPREAD}x the plain routes' spread: "
        f"{floor_bound or 'none'}; kernel route {k_s:.3f} s, plain "
        f"{p_s:.3f} s; launches {counts}")
    del out, gk, gp
    torch.cuda.empty_cache()
    return {"loss_diff": abs(lk - lp), "worst_rel": worst[0],
            "worst_leaf": worst[1], "floor_bound": floor_bound,
            "launches": counts}


def train_launches(cfg, micro_batches: int) -> dict:
    """Launches of a training forward under full remat, per micro-batch
    times ``micro_batches``: each layer's flash and norms run in the forward
    and again in its recompute; the final norm runs once (outside remat);
    the norms' backwards are plain."""
    n_attn, norms = lm_launches(cfg)
    return {"flash_attention": 2 * n_attn * micro_batches,
            "decode_attention": 0,
            "rmsnorm": (2 * (norms - 1) + 1) * micro_batches}


def train_backward_launches(cfg, micro_batches: int, dtype) -> dict:
    """``train_launches`` with flash's backward kernel: one launch a layer a
    micro-batch in bfloat16; float32 takes the plain backward, none."""
    n_attn, _ = lm_launches(cfg)
    return {**train_launches(cfg, micro_batches),
            "flash_attention_backward":
                n_attn * micro_batches * (dtype == torch.bfloat16)}


def training_path(args, dev):
    """Phase 10: f32 gradient checks (h2o-danube-1.8b, whisper-medium) at
    full width and depth, then bf16 h2o-danube-1.8b training through the
    launcher's loop (``repro_torch.launch.train.train``) for TRAIN_ARGV."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    res = {}
    rng = np.random.default_rng(args.seed + 3)

    cfg = get_config(LM_ARCH)
    check(cfg.remat_policy == "full", f"{LM_ARCH} remat {cfg.remat_policy}")
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    params = build_model(cfg32).init(
        torch.Generator(device=dev).manual_seed(args.seed))
    B, S = TRAIN_GRAD_LM
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S))).to(dev)}
    res["grad_lm"] = grad_check(cfg32, params, batch,
                                f"{LM_ARCH} f32 B={B} S={S}",
                                train_backward_launches(cfg, 1,
                                                        torch.float32))
    del params, batch
    torch.cuda.empty_cache()

    wcfg = get_config(WHISPER)
    wcfg32 = wcfg.replace(dtype="float32", param_dtype="float32")
    params = build_model(wcfg32).init(
        torch.Generator(device=dev).manual_seed(args.seed))
    B, frames, ctx, _ = WHISPER_F32
    batch = _whisper_batch(wcfg, dev, rng, B, frames, ctx, torch.float32)
    n_flash, _ = encdec_launches(wcfg)
    res["grad_whisper"] = grad_check(
        wcfg32, params, batch, f"{WHISPER} f32 B={B} frames={frames} "
        f"tokens={ctx}", {"flash_attention": 2 * n_flash,
                          "decode_attention": 0, "rmsnorm": 0,
                          "flash_attention_backward": 0})
    del params, batch
    torch.cuda.empty_cache()

    res["train"] = train_bf16(dev)
    torch.cuda.empty_cache()
    return res


def train_bf16(dev):
    """bf16 h2o-danube-1.8b through the training launcher's loop for
    TRAIN_ARGV (a temporary --ckpt-dir added): finite losses and grad
    norms, params moved, no failure or restart event, launches those of a
    forward and its remat recompute and of flash's backward a micro-batch;
    timed."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import tree_leaves, tree_map
    cfg = get_config(LM_ARCH)
    with tempfile.TemporaryDirectory(prefix="train-ckpt-") as ckpt:
        argv = TRAIN_ARGV + ["--ckpt-dir", ckpt]
        targs = train_launcher.parse_args(argv)
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        run = train_launcher.train(targs)
        counts = _read_counts(backward=True)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    kinds = [k for k, _ in run.events]
    check("failure" not in kinds and "restart" not in kinds,
          f"training events {run.events}")
    check(run.step == targs.steps and len(run.losses) == targs.steps,
          f"trained {run.step} steps, {len(run.losses)} losses")
    check(all(np.isfinite(run.losses)) and all(np.isfinite(run.grad_norms)),
          f"losses {run.losses}, grad norms {run.grad_norms}")
    want = train_backward_launches(cfg, targs.steps * targs.accum,
                                   torch.bfloat16)
    check(counts == want, f"training launches {counts} != {want}")
    init = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    moved = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree_leaves(run.params), tree_leaves(init)))
    check(moved > 0, "training left every param where it started")
    del init
    run = run._replace(opt=None)
    # one micro-batch's loss and gradients on the trained params, profiled
    rows = targs.batch // targs.accum
    model = build_model(cfg)
    mb = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (rows, targs.seq))).to(dev)}
    leaves = tree_leaves(run.params)

    def micro_batch():
        tracked = [p.detach().requires_grad_() for p in leaves]
        it = iter(tracked)
        loss, _ = model.loss(tree_map(lambda _: next(it), run.params), mb)
        torch.autograd.grad(loss, tracked)

    prof = profile_steps(micro_batch, 1, f"training micro-batch ({rows} x "
                         f"{targs.seq}, loss + grads, full remat)")
    run = run._replace(params=None)
    del leaves
    tokens = targs.batch * targs.seq
    steady = float(np.median(run.step_seconds[1:]))
    n = cfg.param_count()
    mfu = 6.0 * n * tokens / steady / BF16_FLOPS_PER_S
    log(f"train bf16 {LM_ARCH}: python -m repro_torch.launch.train "
        f"{' '.join(TRAIN_ARGV)}: {run.step} steps, step seconds "
        f"{[round(x, 4) for x in run.step_seconds]} (steady {steady:.4f} s, "
        f"{tokens / steady:.1f} tok/s, model FLOPs share {mfu:.4f} of "
        f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s, derived from 6 x {n} x "
        f"{tokens}); losses {[round(x, 4) for x in run.losses]}, grad norms "
        f"{[round(x, 4) for x in run.grad_norms]}; max param move {moved:.3e};"
        f" events {kinds}; launches {counts}; peak memory {peak:.2f} GiB")
    return {"step_s": run.step_seconds, "steady_s": steady,
            "tok_s": tokens / steady, "mfu": mfu, "peak_gib": peak,
            "losses": run.losses, "grad_norms": run.grad_norms,
            "launches": counts, "profile": prof,
            "launches_per_step": {k: v // targs.steps
                                  for k, v in counts.items()}}


# -- phase 11: the sharded LM -------------------------------------------------

def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def grad_gap(want, got, dev) -> float:
    """The largest over the leaves of max |got - want| / max |want| (inf
    where a leaf of ``want`` is all 0 and ``got``'s is not)."""
    worst = 0.0
    for a, b in zip(want, got):
        err = float((a.to(dev) - b).abs().max())
        scale = float(a.abs().max())
        worst = max(worst, err / scale if scale else
                    (0.0 if err == 0 else math.inf))
    return worst


def sharded_step_check(dev, mesh, seed: int, arch: str = LM_ARCH,
                       layers: int = SHARD_LAYERS, opt_dtype="float32"):
    """(a) one ``arch`` train step (full width, ``layers`` layers,
    float32, SHARD_BATCH) on the mesh, from params placed by its logical
    axes (``shard_params``), against the same step off the mesh: loss and
    params at the reference test's bounds, the gradients the step updates
    with (each in its param's placements, then made whole) within
    SHARD_GRAD_RTOL of each leaf's largest, launches equal (and (d), for
    each of SHARD_FAMILIES)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (axis_rules,
                                                  rules_for_config,
                                                  shard_params,
                                                  tree_shardings)
    from repro_torch.models import batch_axes, build_model
    from repro_torch.training import (OptimizerConfig, init_state,
                                      make_train_step)
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.step import _loss_and_grads
    cfg = get_config(arch).replace(num_layers=layers, dtype="float32",
                                   param_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.reset_peak_memory_stats()
    B, S = SHARD_BATCH
    batch = {"tokens": torch.from_numpy(np.random.default_rng(
        seed + 11).integers(0, cfg.vocab_size, (B, S))).to(dev)}
    step = make_train_step(model, OptimizerConfig(learning_rate=1e-3,
                                                  opt_dtype=opt_dtype))
    rules = rules_for_config(cfg)
    runs = {}
    for where in ("off", "mesh"):
        with (axis_rules(rules, mesh=mesh) if where == "mesh"
              else contextlib.nullcontext()):
            p, b = params, batch
            if where == "mesh":
                p = shard_params(params, mesh, model.param_axes(), rules)
                bp = tree_shardings(mesh, batch_axes(cfg), rules)
                b = {k: distribute_tensor(v, mesh, bp[k], src_data_rank=None)
                     for k, v in batch.items()}
            opt = init_state(p, opt_dtype)
            _zero_counts()
            t0 = time.perf_counter()
            p1, _, out = step(p, opt, b)
            loss = float(_whole(out["loss"]))
            secs = time.perf_counter() - t0
            counts = _read_counts()
            placed = [getattr(t, "placements", None) for t in tree_leaves(p1)]
            check(placed == [getattr(t, "placements", None)
                             for t in tree_leaves(p)],
                  f"sharded step {where}: params left their placements")
            # the step off the mesh waits on the host: a full-width f32
            # step holds params, gradients and two AdamW states twice
            # (recurrentgemma-9b: 6.55 GB each) while it updates
            kept = "cpu" if where == "off" else dev
            p1 = [_whole(t).detach().to(kept) for t in tree_leaves(p1)]
            del opt
            # the gradients the step updates with, once more (the step
            # returns none), after its launches were read
            g = [_whole(t).detach().to(kept)
                 for t in _loss_and_grads(model, p, b)[2]]
            runs[where] = (loss, p1, secs, counts, g)
            del p1, p, b, g
    (lo, po, so, co, go), (lm, pm, sm, cm, gm) = runs["off"], runs["mesh"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss_gap = abs(lo - lm)
    param_gap = max(float((a.to(dev) - b).abs().max())
                    for a, b in zip(po, pm))
    g_gap = grad_gap(go, gm, dev)
    want = train_launches(cfg, 1)
    check(loss_gap < SHARD_LOSS_TOL and param_gap < SHARD_PARAM_TOL
          and g_gap <= SHARD_GRAD_RTOL,
          f"sharded step {arch}: loss gap {loss_gap}, param gap "
          f"{param_gap}, gradient gap {g_gap} of each leaf's largest")
    check(cm == co == want, f"sharded step {arch} launches {cm}, off the "
          f"mesh {co}, want {want}")
    log(f"sharded step {arch} f32 ({opt_dtype} moments) {layers} layers "
        f"B={B} S={S} on "
        f"a {tuple(mesh.shape)} mesh: loss {lm:.6f} vs off the mesh "
        f"{lo:.6f} (gap {loss_gap:.3e}, bound {SHARD_LOSS_TOL}); max param "
        f"gap {param_gap:.3e} (bound {SHARD_PARAM_TOL}); gradients within "
        f"{g_gap:.3e} of each leaf's largest (bound {SHARD_GRAD_RTOL}); "
        f"launches {cm} (off "
        f"the mesh {co}); step {sm:.4f} s on the mesh, {so:.4f} s off; "
        f"peak {peak:.2f} GiB")
    del runs, po, pm, go, gm, params
    torch.cuda.empty_cache()
    return {"loss_gap": loss_gap, "param_gap": param_gap,
            "grad_gap": g_gap, "launches": cm,
            "mesh_s": sm, "off_s": so, "peak_gib": peak}


def ep_check(dev, mesh, seed: int):
    """(b) olmoe-1b-7b's MoE block at full width, float32: ``moe_apply``
    on the mesh (the expert-parallel branch) against the single-device
    call, y and the gradient of ``sum(y * ct) + 3 aux``, and aux against
    ``moe_dense``'s. The router and x come from a CPU generator (the
    routing, and so the capacity drops, are then the same on every
    machine), the expert weights from the card's. Some seeds drop tokens
    at capacity (seed 8: y 0.082 from ``moe_dense``'s on one device too),
    so y is held to the single-device call, which drops the same ones;
    its gap to ``moe_dense`` is printed."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (PartitionSpec, axis_rules,
                                                  make_rules,
                                                  spec_placements)
    from repro_torch.models import moe
    from repro_torch.models.spec import init_params
    cfg = get_config(EP_ARCH).replace(dtype="float32", param_dtype="float32")
    p = init_params(moe.moe_specs(cfg),
                    torch.Generator(device=dev).manual_seed(seed), "float32",
                    dev)
    g = torch.Generator().manual_seed(seed + 11)
    p["router"] = (torch.randn(tuple(p["router"].shape), generator=g)
                   * 0.02).to(dev)
    x = (torch.randn((*EP_X, cfg.d_model), generator=g) * 0.5).to(dev)
    ct = torch.randn(tuple(x.shape), generator=g).to(dev)
    names = sorted(p)
    with torch.no_grad():
        yd, auxd = moe.moe_dense(cfg, p, x)

    def grads(xs, ps, **kw):
        y, aux = moe.moe_apply(cfg, dict(zip(names, ps)), xs, **kw)
        loss = (y * ct).sum() + 3.0 * aux
        return y, aux, torch.autograd.grad(loss, [xs] + ps)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y1, _, g1 = grads(x.detach().requires_grad_(),
                      [p[k].detach().requires_grad_() for k in names])
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    PS = PartitionSpec
    specs = {"router": PS(None, None), "wi": PS("model", "data", None),
             "wg": PS("model", "data", None), "wo": PS("model", None, "data")}
    with axis_rules(make_rules(), mesh=mesh):
        xd = distribute_tensor(x, mesh, spec_placements(
            mesh, PS("data", None, None)), src_data_rank=None)
        pd = [distribute_tensor(p[k], mesh, spec_placements(mesh, specs[k]),
                                src_data_rank=None) for k in names]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux, ge = grads(xd.requires_grad_(),
                           [t.requires_grad_() for t in pd], mesh=mesh)
        torch.cuda.synchronize()
        ep_s = time.perf_counter() - t0
    y_err = float((_whole(y).detach() - y1.detach()).abs().max())
    dense_gap = float((y1.detach() - yd).abs().max())
    aux_err = abs(float(_whole(aux)) - float(auxd))
    check(y_err < EP_Y_TOL and aux_err < EP_AUX_TOL,
          f"EP moe: y {y_err} (bound {EP_Y_TOL}), aux {aux_err} (bound "
          f"{EP_AUX_TOL})")
    rel = {}
    for name, a, b in zip(["x"] + names, ge, g1):
        rel[name] = float((_whole(a) - b).abs().max()) / max(
            float(b.abs().max()), 1e-30)
    check(max(rel.values()) < EP_GRAD_RTOL, f"EP moe grads: {rel} of max |g|"
          f" (bound {EP_GRAD_RTOL})")
    log(f"EP moe {EP_ARCH} f32 x {tuple(x.shape)} on a {tuple(mesh.shape)} "
        f"mesh: max |y - y_single_device| {y_err:.3e} (bound {EP_Y_TOL}; "
        f"the single-device call's gap to moe_dense {dense_gap:.3e}), |aux - "
        f"dense| {aux_err:.3e} (bound {EP_AUX_TOL}); grads against the "
        f"single-device call, max |diff| / max |g|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + f"; forward + backward {ep_s:.4f} s on the mesh, {one_s:.4f} s off")
    del p, x, ct, yd, y1, g1, ge, xd, pd, y
    torch.cuda.empty_cache()
    return {"y_err": y_err, "dense_gap": dense_gap, "aux_err": aux_err,
            "grad_rel": rel,
            "mesh_s": ep_s, "off_s": one_s}


def sharded_train(dev):
    """(c) bf16 h2o-danube-1.8b through the launcher with --mesh host at
    phase 10's cell for SHARD_TRAIN_STEPS steps (the launcher starts its
    own 1-rank NCCL world): finite losses, no failure or restart event,
    launches those of phase 10; step seconds, tokens/s, peak memory."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_launcher
    cfg = get_config(LM_ARCH)
    argv = list(TRAIN_ARGV)
    argv[argv.index("--steps") + 1] = str(SHARD_TRAIN_STEPS)
    with tempfile.TemporaryDirectory(prefix="train-ckpt-") as ckpt:
        targs = train_launcher.parse_args(argv + ["--mesh", "host",
                                                  "--ckpt-dir", ckpt])
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        run = train_launcher.train(targs)
        counts = _read_counts(backward=True)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    kinds = [k for k, _ in run.events]
    check("failure" not in kinds and "restart" not in kinds,
          f"sharded training events {run.events}")
    check(run.step == targs.steps and all(np.isfinite(run.losses))
          and all(np.isfinite(run.grad_norms)),
          f"sharded training: {run.step} steps, losses {run.losses}")
    want = train_backward_launches(cfg, targs.steps * targs.accum,
                                   torch.bfloat16)
    check(counts == want, f"sharded training launches {counts} != {want}")
    mesh_shape = tuple(run.params["final_norm"].device_mesh.shape)
    tokens = targs.batch * targs.seq
    steady = float(np.median(run.step_seconds[1:]))
    log(f"train bf16 {LM_ARCH} --mesh host ({mesh_shape} mesh): "
        f"{run.step} steps, step seconds "
        f"{[round(x, 4) for x in run.step_seconds]} (steps 2-"
        f"{run.step} median {steady:.4f} s, {tokens / steady:.1f} tok/s); "
        f"losses {[round(x, 4) for x in run.losses]}; events {kinds}; "
        f"launches {counts}; peak memory {peak:.2f} GiB")
    del run
    torch.cuda.empty_cache()
    return {"steady_s": steady, "tok_s": tokens / steady, "peak_gib": peak,
            "launches": counts, "mesh": mesh_shape}


def sharded_path(args, dev):
    """Phase 11: (a), (b) and (d) on the (1, 1) mesh of a 1-rank NCCL world
    over a FileStore, then (c) the launcher, which starts its own world."""
    import os
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    res = {}
    with tempfile.TemporaryDirectory(prefix="nccl-") as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            res["step"] = sharded_step_check(dev, mesh, args.seed)
            res["ep"] = ep_check(dev, mesh, args.seed)
            res["families"] = {
                arch: sharded_step_check(dev, mesh, args.seed, arch, *how)
                for arch, how in SHARD_FAMILIES.items()}
        finally:
            dist.destroy_process_group()
    res["train"] = sharded_train(dev)
    return res


# -- phase 12: the dry run against the card ---------------------------------

def _nbytes(tree) -> int:
    from repro_torch.launch.dryrun import _leaves
    from torch.distributed.tensor import DTensor
    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for t in _leaves(tree))


def _tensor_count(tree) -> int:
    from repro_torch.launch.dryrun import _leaves
    return len(_leaves(tree))


def dry_card_cell(dev, mesh, seed: int):
    """(a) h2o-danube-1.8b decode_32k at full shape on the (1, 1) mesh:
    ``lower_cell`` with the mesh swapped for it gives argument bytes equal
    to the bytes of the params, cache and tokens placed on the card (and
    ``memory_allocated`` grows by them, give or take the allocator's
    rounding of each tensor to ALLOC_ROUND bytes); the real serve step on
    the kernel route, from a random cache DRY_STEPS short of its
    32768-position context, gives the next tokens of the step off the
    mesh, DRY_DECODE_LAUNCHES decode_attention launches a step and the
    rmsnorm launches of a danube decode step; its device time beside the
    record's memory term; the record's temp bytes beside the step's peak
    allocation."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import (axis_rules,
                                                  rules_for_config,
                                                  shard_params)
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import build_model
    from repro_torch.models.attention import KVCache
    from repro_torch.models.transformer import DecodeState
    from repro_torch.training import make_serve_step
    from repro_torch.training.optimizer import tree_map
    shape = SHAPES[DRY_SHAPE]
    real = mesh_mod.make_production_mesh
    mesh_mod.make_production_mesh = lambda multi_pod=False: mesh
    try:
        t0 = time.perf_counter()
        rec, _ = dryrun.lower_cell(DRY_ARCH, DRY_SHAPE, False)
        trace_s = time.perf_counter() - t0
    finally:
        mesh_mod.make_production_mesh = real
    check(rec["mesh_device"] == "cuda" and rec["chips"] == 1,
          f"dry-run on the (1, 1) mesh: {rec['mesh_device']}, "
          f"{rec['chips']} chips")
    cfg = get_config(DRY_ARCH)
    rules = rules_for_config(cfg, overrides=dryrun._rule_overrides(
        cfg, shape, mesh))
    model = build_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    start = S - DRY_STEPS - 1
    step = make_serve_step(model)

    def random_state():
        """The cache of a 32768-position context DRY_STEPS + 1 short of
        its end (window full and wrapped), random from the seed."""
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        st = model.init_cache(B, S, device=dev)
        for t in (st.kv.k, st.kv.v):
            t.normal_(generator=gen)
        return DecodeState(KVCache(st.kv.k, st.kv.v, start), None, None,
                           start)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = shard_params(model.init(gen, dev), mesh, model.param_axes(),
                          rules)
    state = shard_params(random_state(), mesh, model.cache_axes(), rules)
    tok = shard_params(torch.randint(0, cfg.vocab_size, (B, 1), device=dev,
                                     generator=gen, dtype=torch.int32),
                       mesh, ("batch", None), rules)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - mem0
    placed = _nbytes((params, state, tok))
    n_tensors = _tensor_count((params, state, tok))
    arg = rec["memory_analysis"]["argument_size_in_bytes"]
    check(arg == placed, f"dry-run argument bytes {arg} != {placed} placed "
          "on the card")
    check(0 <= grown - placed <= ALLOC_ROUND * n_tensors,
          f"memory_allocated grew {grown}, placed {placed} bytes in "
          f"{n_tensors} tensors")
    log(f"dry-run {DRY_ARCH} {DRY_SHAPE} on the (1, 1) mesh: traced in "
        f"{trace_s:.2f} s; argument bytes {arg} == {placed} placed in "
        f"{n_tensors} tensors; memory_allocated grew {grown} (rounding "
        f"{grown - placed} bytes)")

    first = tok.to_local().clone()
    nxt, toks, counts = tok, [], []
    with torch.no_grad(), axis_rules(rules, mesh=mesh):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(DRY_STEPS):
            _zero_counts()
            nxt, state = step(params, state, nxt)
            counts.append(_read_counts())
            toks.append(_whole(nxt).clone())
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base

        def one_step():
            step(params, state, nxt)

        step_ms, _ = device_ms(one_step, 4)
    del state
    torch.cuda.empty_cache()
    # the same steps off the mesh, from the same cache made again
    off_params = tree_map(lambda t: t.to_local(), params)
    off, nxt_off, same = random_state(), first, True
    with torch.no_grad():
        for i in range(DRY_STEPS):
            _zero_counts()
            nxt_off, off = step(off_params, off, nxt_off)
            off_counts = _read_counts()
            same = same and bool((nxt_off == toks[i]).all())
    del off
    check(same, "mesh decode tokens differ from the step off the mesh")
    want = {"rmsnorm": 2 * cfg.num_layers + 1, "flash_attention": 0,
            "decode_attention": DRY_DECODE_LAUNCHES}
    check(all(c == want for c in counts) and off_counts == want,
          f"mesh decode launches {counts}, off the mesh {off_counts}, want "
          f"{want}")
    mem_ms = rec["roofline"]["memory_s"] * 1e3
    temp = rec["memory_analysis"]["temp_size_in_bytes"]
    log(f"dry-run cell on the card: next tokens equal off the mesh over "
        f"{DRY_STEPS} steps; launches a step {counts[0]}; step device time "
        f"{step_ms:.4f} ms vs the record's memory term {mem_ms:.4f} ms "
        f"(ratio {step_ms / mem_ms:.4f}; the record traces the plain route); "
        f"record temp bytes {temp} vs the step's peak allocation {peak}")
    del params, off_params, tok, nxt
    torch.cuda.empty_cache()
    return {"arg_bytes": arg, "placed": placed, "grown": grown,
            "launches": counts[0], "step_device_ms": step_ms,
            "record_memory_ms": mem_ms, "temp": temp, "peak": peak,
            "trace_s": trace_s}


def _dry_cell(arch: str, shape: str) -> dict:
    """One production record, in a process of its own: ``lower_cell``
    starts its 256-rank fake world there."""
    from repro_torch.launch import dryrun
    rec, _ = dryrun.lower_cell(arch, shape, False)
    return rec


def dry_records(futs, card_arg_bytes: int):
    """(b) the production records (``futs``: each cell's future), traced
    on fake CUDA tensors over a 256-rank fake world: every roofline term
    positive, useful FLOPs ratio in (0, DRY_USEFUL_MAX], FLOPs a device
    within DRY_FLOPS_RTOL of the reference's, olmoe's EP collectives
    recorded (an all-gather of each expert weight and an all-reduce
    combine a MoE layer at least), danube decode_32k's argument bytes at
    most (a)'s / 16."""
    from repro_torch.configs import get_config
    out = {}
    for (arch, shape), fut in futs.items():
        rec = fut.result()
        r = rec["roofline"]
        ratio = rec["useful_flops_ratio"]
        coll = rec["collectives"]["collective_counts"]
        check(rec["mesh_device"] == "cuda" and rec["chips"] == 256,
              f"dry-run {arch} {shape}: {rec['mesh_device']} mesh, "
              f"{rec['chips']} ranks")
        check(min(r["compute_s"], r["memory_s"], r["collective_s"]) > 0
              and ratio is not None and 0 < ratio <= DRY_USEFUL_MAX,
              f"dry-run {arch} {shape}: roofline {r}, useful {ratio}")
        ref = DRY_REF_FLOPS[(arch, shape)]
        flops = rec["flops_per_device"]
        check(abs(flops / ref - 1) <= DRY_FLOPS_RTOL,
              f"dry-run {arch} {shape}: {flops} FLOPs a device, the "
              f"reference's {ref}")
        mem = rec["memory_analysis"]
        if arch == EP_ARCH:
            # the EP block's own collectives, the reference's design
            # (src/repro/models/moe.py:134-181): each MoE layer all-gathers
            # its experts' FSDP shards (wi, wg, wo) and sums its combine
            # over "model" (an all-reduce); no all-to-all moves tokens
            layers = get_config(arch).num_layers
            check(coll.get("all-gather", 0) >= 3 * layers
                  and coll.get("all-reduce", 0) >= layers,
                  f"dry-run {arch} {shape}: the EP block's gathers and "
                  f"combines missing from {coll}")
        if (arch, shape) == (DRY_ARCH, DRY_SHAPE):
            arg = rec["memory_analysis"]["argument_size_in_bytes"]
            check(arg * 16 <= card_arg_bytes, f"dry-run {arch} {shape}: "
                  f"{arg} argument bytes a rank, (a) {card_arg_bytes}")
        log(f"OK  {arch}/{shape}/single: flops_per_device {flops:.6e} "
            f"(reference {ref:.6e}, ratio {flops / ref:.4f}); argument + "
            f"temp {mem['argument_size_in_bytes'] + mem['temp_size_in_bytes']}"
            f" B; compute={r['compute_s']:.4f}s "
            f"memory={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s "
            f"dominant={r['dominant']} useful={ratio:.3f} (trace "
            f"{rec['compile_s']:.0f}s) collectives {coll} bytes "
            f"{rec['collectives']['collective_operand_bytes']} largest "
            f"{rec['collective_ops'][:2]} memory {rec['memory_analysis']}")
        out[(arch, shape)] = rec
    return out


def dry_pool():
    """A pool for (b)'s traces, one spawned process a cell: a trace is host
    work (a full-depth one takes minutes), so :func:`main` starts them
    before phase 11, beside phase 11's and 12 (a)'s card work."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(max_workers=len(DRY_CELLS),
                               mp_context=mp.get_context("spawn"))


def dryrun_path(args, dev, futs):
    """Phase 12: (a) on the (1, 1) mesh of a 1-rank NCCL world over a
    FileStore, then (b)'s records (``futs``, started by :func:`main`) are
    read and checked."""
    card = dry_card_path(dev, args.seed)
    recs = dry_records(futs, card["arg_bytes"])
    return {"card": card, "records": recs}


def dry_card_path(dev, seed: int):
    """(a) on the (1, 1) mesh of a 1-rank NCCL world over a FileStore."""
    import os
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    with tempfile.TemporaryDirectory(prefix="nccl-") as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            return dry_card_cell(dev, mesh, seed)
        finally:
            dist.destroy_process_group()


# -- phase 8: timing --------------------------------------------------------

def time_ms(fn, reps: int) -> float:
    for _ in range(5):
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


def device_ms(fn, reps: int, traces: int = 4):
    """(the card's ms a call, kernel events a call): the kernel time of
    ``reps`` calls under ``torch.profiler``, over ``reps``. For a call of a
    few µs, CUDA events over back-to-back calls read the host's enqueue
    time where that is the longer; this reads only the kernels.

    The profiler can lose kernel events (a trace of 50 calls has come back
    with 48 calls' events, and one with none), and a sum over a short count
    reads below the truth. So the calls are traced in the active step of a
    schedule, after a step that is traced and thrown away, with a pause for
    the trace's last records before it stops, and a trace is taken again,
    up to ``traces`` times, until every kernel's event count is a whole,
    nonzero multiple of ``reps``. Where no trace is, the time is read from
    the one that lost the fewest events, provided each kernel kept at least
    ``1 - DEVICE_EVENTS_LOST`` of its events: each kernel's mean event time
    times its launches a call (its count over ``reps``, rounded). Fewer
    raises."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    best = None                 # (events lost, events, launches a call)
    for attempt in range(1, traces + 1):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     acc_events=True) as prof:
            for _ in range(2):          # the warm-up step, the traced one
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                time.sleep(0.02)        # let the last records land
                prof.step()
        ev = _kernel_events(prof)
        short = {k[:60]: n for k, (_, n) in ev.items() if n % reps}
        if ev and not short:
            return (sum(us for us, _ in ev.values()) / reps / 1e3,
                    sum(n for _, n in ev.values()) // reps)
        log(f"device_ms: trace {attempt} of {reps} calls recorded kernel "
            f"events {short or 'none'}, not whole multiples of {reps}")
        per = {k: round(n / reps) for k, (_, n) in ev.items()}
        lost = {k: abs(per[k] * reps - n) for k, (_, n) in ev.items()}
        if ev and all(per[k] >= 1 and lost[k] <= DEVICE_EVENTS_LOST
                      * per[k] * reps for k in ev):
            if best is None or sum(lost.values()) < best[0]:
                best = (sum(lost.values()), ev, per)
    if best is None:
        raise AssertionError(
            f"device_ms: {traces} traces of {reps} calls each lost more than "
            f"{DEVICE_EVENTS_LOST:.0%} of a kernel's events: "
            f"{short or 'none recorded'}")
    n_lost, ev, per = best
    log(f"device_ms: read from mean event times of the trace that lost "
        f"{n_lost} events: launches a call "
        f"{ {k[:60]: c for k, c in per.items()} }")
    return (sum(us / n * per[k] for k, (us, n) in ev.items()) / 1e3,
            sum(per.values()))


def bound_ms(n: int, d: int, k: int):
    """Least time for the work: each input read once, the output written
    once (float32), against 2DK FMA flops + one tanh per output."""
    nbytes = 4.0 * (n * d + d * k + n * k)
    ops = 2.0 * n * d * k + n * k
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timings(fused_embed, fused_embed_ref, dev, K):
    """fused_embed at the SQL path's 256-row chunk, at 2^20 rows and at one
    row, with its plain version (no PyTorch call computes it alone)."""
    g = torch.Generator(device="cpu").manual_seed(2)
    res = {}
    for n, d, k, reps in ((256, 16, K, 400), (1 << 20, 16, K, 50),
                          (1, 16, 8, 400)):
        x = torch.randn((n, d), generator=g).to(dev)
        w = (torch.randn((d, k), generator=g) * 0.05).to(dev)
        res[(n, d, k)] = _timed(
            "fused_embed", lambda: fused_embed(x, w),
            lambda: fused_embed_ref(x, w), None, reps, bound_ms(n, d, k),
            [n, d, k], TOL[torch.float32])
    return res


def _bound(nbytes: float, ops: float, peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timed(name, kernel, plain, library, reps, bound, shape, atol,
           library_causal=None):
    """Hold kernel and plain together on the inputs to be timed, then time
    plain, kernel, kernel, plain (and the library calls) in turns."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err, beyond, ok = _close(got, want, got.dtype, atol)
    check(ok, f"{name} {shape}: err {err}, beyond one ulp {beyond} > {atol}")
    del got, want
    p1 = time_ms(plain, reps)
    k1 = time_ms(kernel, reps)
    k2 = time_ms(kernel, reps)
    p2 = time_ms(plain, reps)
    lib = time_ms(library, reps) if library is not None else None
    extra = {} if library_causal is None else {
        "library_causal_ms": time_ms(library_causal, reps)}
    # the card's own time of the kernel and of the library calls
    dev_reps = min(reps, 50)
    extra["device_ms"], extra["device_events_per_call"] = device_ms(
        kernel, dev_reps)
    if library is not None:
        extra["library_device_ms"], _ = device_ms(library, dev_reps)
    if library_causal is not None:
        extra["library_causal_device_ms"], _ = device_ms(library_causal,
                                                         dev_reps)
    b, by = bound
    extra["bound_share"] = b / extra["device_ms"]
    log(f"time {name} {shape}: max err {err:.2e} ({beyond:.2e} beyond one "
        f"ulp); kernel {k1:.5f}/{k2:.5f} ms, plain "
        f"{p1:.5f}/{p2:.5f} ms, library "
        f"{'none' if lib is None else f'{lib:.5f} ms'}"
        + "".join(f", {key} {v:.5f}" if isinstance(v, float)
                  else f", {key} {v}" for key, v in extra.items())
        + f", bound {b:.6f} ms ({by})")
    return {"shape": shape, "ms": min(k1, k2), "plain_ms": min(p1, p2),
            "library_ms": lib, **extra, "bound_ms": b, "bound_by": by}


def lm_timings(dev, slots: int, prompt: int, gen_tokens: int):
    """Each LM kernel at the bf16 serving path's shapes (and flash at the
    8192-token prefill), with the plain version and the library call."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention, flash_attention, rmsnorm
    from repro_torch.kernels.decode_attention import decode_attention_partial
    from repro_torch.kernels.ref import (decode_attention_partial_ref,
                                         decode_attention_ref,
                                         flash_attention_ref, rmsnorm_ref)
    bf = torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(4)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev, bf)

    res = {}
    D, Hq, Hkv, hd, W = 2560, 32, 8, 80, 4096
    # decode and prefill of the serving path; llama3-405b's width, whose rows
    # take 8 warps each
    for label, n, d in (("decode", slots, D), ("prefill", slots * prompt, D),
                        ("wide", 4096, 16384)):
        x, w = randn((n, d)), randn((d,), 0.1)
        w1 = 1.0 + w.float()
        res[f"rmsnorm_{label}"] = _timed(
            "rmsnorm", lambda: rmsnorm(x, w), lambda: rmsnorm_ref(x, w),
            lambda: F.rms_norm(x, (d,), w1.to(bf), 1e-6), 200,
            _bound(2.0 * (2 * n * d + d), 4.0 * n * d, BF16_FLOPS_PER_S),
            [n, d], TOL[bf])
        del x
    for label, B, S in (("prefill", slots, prompt), ("long", 1, LONG_S)):
        q = randn((B, S, Hq, hd)).transpose(1, 2)
        k = randn((B, S, Hkv, hd)).transpose(1, 2)
        v = randn((B, S, Hkv, hd)).transpose(1, 2)
        pos = torch.arange(S, device=dev)
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
        pairs = float(band.sum())
        # at S <= window the band is the causal mask: SDPA's own causal path
        causal = None if S > W else (
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   enable_gqa=True))
        res[f"flash_attention_{label}"] = _timed(
            "flash_attention",
            lambda: flash_attention(q, k, v, causal=True, window=W),
            lambda: flash_attention_ref(q, k, v, causal=True, window=W),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                                   enable_gqa=True),
            20 if S <= 1024 else 3,
            _bound(2.0 * B * S * hd * (2 * Hq + 2 * Hkv),
                   4.0 * B * Hq * hd * pairs, BF16_FLOPS_PER_S),
            [B, Hq, Hkv, S, hd], ATTN_BF16_TOL, library_causal=causal)
        del q, k, v, band
    # recurrentgemma-9b's served prefill: head dim 256, MQA, window 2048
    Hq2, Hkv2, hd2, W2 = 16, 1, 256, 2048
    q = randn((slots, prompt, Hq2, hd2)).transpose(1, 2)
    k = randn((slots, prompt, Hkv2, hd2)).transpose(1, 2)
    v = randn((slots, prompt, Hkv2, hd2)).transpose(1, 2)
    pos = torch.arange(prompt, device=dev)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W2)
    res["flash_attention_d256"] = _timed(
        "flash_attention",
        lambda: flash_attention(q, k, v, causal=True, window=W2),
        lambda: flash_attention_ref(q, k, v, causal=True, window=W2),
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                               enable_gqa=True),
        20,
        _bound(2.0 * slots * prompt * hd2 * (2 * Hq2 + 2 * Hkv2),
               4.0 * slots * Hq2 * hd2 * float(band.sum()), BF16_FLOPS_PER_S),
        [slots, Hq2, Hkv2, prompt, hd2], ATTN_BF16_TOL,
        library_causal=lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
    del q, k, v, band
    length = prompt + gen_tokens // 2
    q = randn((slots, Hq2, hd2))
    kc = randn((slots, W2, Hkv2, hd2)).transpose(1, 2)
    vc = randn((slots, W2, Hkv2, hd2)).transpose(1, 2)
    res["decode_attention_d256"] = _timed(
        "decode_attention", lambda: decode_attention(q, kc, vc, length),
        lambda: decode_attention_ref(q, kc, vc, length),
        lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc[:, :, :length], vc[:, :, :length],
            enable_gqa=True),
        200,
        _bound(2.0 * (2 * slots * Hkv2 * length * hd2
                      + 2 * slots * Hq2 * hd2),
               4.0 * slots * Hq2 * length * hd2, BF16_FLOPS_PER_S),
        [slots, Hq2, Hkv2, W2, hd2, length], ATTN_BF16_TOL)
    del q, kc, vc
    q = randn((slots, Hq, hd))
    kc = randn((slots, W, Hkv, hd)).transpose(1, 2)
    vc = randn((slots, W, Hkv, hd)).transpose(1, 2)
    res["decode_attention"] = _timed(
        "decode_attention", lambda: decode_attention(q, kc, vc, length),
        lambda: decode_attention_ref(q, kc, vc, length),
        lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc[:, :, :length], vc[:, :, :length],
            enable_gqa=True),
        200,
        _bound(2.0 * (2 * slots * Hkv * length * hd + 2 * slots * Hq * hd),
               4.0 * slots * Hq * length * hd, BF16_FLOPS_PER_S),
        [slots, Hq, Hkv, W, hd, length], ATTN_BF16_TOL)
    del q, kc, vc
    # decode_attention_partial at phase 12a's card cell: danube's
    # decode_32k batch over its full window, one slice (the (1, 1) mesh),
    # an f32 o and each head's lse out. No PyTorch call returns the lse
    B = 128
    q = randn((B, Hq, hd))
    kc = randn((B, W, Hkv, hd)).transpose(1, 2)
    vc = randn((B, W, Hkv, hd)).transpose(1, 2)
    res["decode_attention_partial"] = _timed(
        "decode_attention_partial",
        lambda: decode_attention_partial(q, kc, vc, W)[0],
        lambda: decode_attention_partial_ref(q, kc, vc, W)[0], None, 50,
        _bound(2.0 * (2 * B * Hkv * W * hd + B * Hq * hd)
               + 4.0 * (B * Hq * hd + B * Hq), 4.0 * B * Hq * W * hd,
               BF16_FLOPS_PER_S),
        [B, Hq, Hkv, W, hd, W], ATTN_BF16_TOL)
    del q, kc, vc
    # whisper-medium's encoder at its serving batch: 16 heads of 64, no
    # GQA, non-causal over its 1500 frames (SDPA with is_causal=False)
    Bw, Hw, Sw, Dw = WHISPER_SLOTS, 16, WHISPER_F32[1], 64
    q = randn((Bw, Sw, Hw, Dw)).transpose(1, 2)
    k = randn((Bw, Sw, Hw, Dw)).transpose(1, 2)
    v = randn((Bw, Sw, Hw, Dw)).transpose(1, 2)
    res["flash_attention_whisper"] = _timed(
        "flash_attention",
        lambda: flash_attention(q, k, v, causal=False),
        lambda: flash_attention_ref(q, k, v, causal=False),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=False),
        20,
        _bound(2.0 * Bw * Sw * Dw * 4 * Hw, 4.0 * Bw * Hw * Dw * Sw * Sw,
               BF16_FLOPS_PER_S),
        [Bw, Hw, Hw, Sw, Dw], ATTN_BF16_TOL)
    del q, k, v
    # moonlight-train-8k's training forward: latent attention, q.k 192
    # (128 + 64 rope), values 128 (the last 128 columns of each head's
    # up-projection), 16 heads, causal over the 8192-token context
    Bm, Hm, Sm = 2, 16, 8192
    q = randn((Bm, Sm, Hm, 192)).transpose(1, 2)
    k = randn((Bm, Sm, Hm, 192)).transpose(1, 2)
    v = randn((Bm, Sm, Hm, 256))[..., 128:].transpose(1, 2)
    pairs = Sm * (Sm + 1) / 2
    res["flash_attention_moonlight"] = _timed(
        "flash_attention",
        lambda: flash_attention(q, k, v, causal=True),
        lambda: flash_attention_ref(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        10,
        _bound(2.0 * Bm * Sm * Hm * (2 * 192 + 2 * 128),
               2.0 * Bm * Hm * (192 + 128) * pairs, BF16_FLOPS_PER_S),
        [Bm, Hm, Hm, Sm, 192, 128], ATTN_BF16_TOL)
    return res


# the backward kernel's rows (PERF.md §6): (label, B, Hq, Hkv, Sq, Sk, D,
# causal, window[, Dv]) of danube-train's call, whisper-medium's encoder,
# olmoe-1b-7b's and gemma-2b's at their 4096-token training shapes, and
# moonlight-train-8k's (q.k 192, values 128)
FLASH_BWD_CELLS = (
    ("danube_train", 2, 32, 8, 4096, 4096, 80, True, None),
    ("whisper_encoder", 2, 16, 16, 1500, 1500, 64, False, None),
    ("olmoe_train", 2, 16, 16, 4096, 4096, 128, True, None),
    ("gemma_train", 2, 8, 1, 4096, 4096, 256, True, None),
    ("moonlight_train", 2, 16, 16, 8192, 8192, 192, True, None, 128))


def flash_backward_timings(dev):
    """The bf16 flash backward kernel (one launch: delta, the main kernel,
    dq's conversion) at each ``FLASH_BWD_CELLS`` shape: held to its plain
    twin (``ref.flash_attention_backward_ref``) fed the kernel's own o and
    lse, one batch row at a time, within one bf16 ulp plus 1e-3 of the
    largest gradient (the bound of the CUDA test against the twin); the gap
    to the plain chunked backward, which differentiates its own float32
    recompute, is printed. Then timed plain, kernel, kernel, plain, and
    autograd through SDPA as the library yardstick (the port never calls
    it). Bound: the five products, 2 (3 D + 2 Dv) FLOPs a pair in the band
    (10 D where Dv = D), or the bytes of q, k, v, o, dO, lse read and dq,
    dk, dv written once."""
    import torch.nn.functional as F
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import (FlashAttentionFunction,
                                                     _launch,
                                                     _launch_backward)
    from repro_torch.kernels.ref import flash_attention_backward_ref
    bf = torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(5)
    res = {}
    for label, B, Hq, Hkv, Sq, Sk, D, causal, window, *dv in \
            FLASH_BWD_CELLS:
        Dv = dv[0] if dv else D
        q, do = (torch.randn((B, Sq, Hq, d), generator=g).to(dev, bf)
                 .transpose(1, 2) for d in (D, Dv))
        k, v = (torch.randn((B, Sk, Hkv, d), generator=g).to(dev, bf)
                .transpose(1, 2) for d in (D, Dv))
        o, lse = _launch(q, k, v, causal, window, with_lse=True)
        ctx = SimpleNamespace(saved_tensors=(q, k, v),
                              needs_input_grad=(True,) * 3, causal=causal,
                              window=window)

        def kernel():
            return _launch_backward(q, k, v, o, lse, do, causal, window)

        def plain():
            return FlashAttentionFunction._plain(ctx, do)[:3]

        got = kernel()
        twin = [torch.cat(parts, 0) for parts in zip(*(
            flash_attention_backward_ref(
                q[b:b + 1], k[b:b + 1], v[b:b + 1], o[b:b + 1],
                lse[b:b + 1, :, :Sq], do[b:b + 1], causal=causal,
                window=window) for b in range(B)))]
        errs, plain_errs = [], []
        for name, a, t, p in zip("qkv", got, twin, plain()):
            atol = 1e-3 * max(1.0, float(t.float().abs().max()))
            err, beyond, ok = _close(a, t, bf, atol)
            check(ok, f"flash backward {label} d{name}: err {err} against "
                      f"the twin, beyond one ulp {beyond} > {atol}")
            errs.append(err)
            plain_errs.append(float((a.float() - p.float()).abs().max()))
        del got, twin
        pos = torch.arange(max(Sq, Sk), device=dev)
        band = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
        if causal:
            band &= pos[None, :Sk] <= pos[:Sq, None]
        if window is not None:
            band &= pos[None, :Sk] > pos[:Sq, None] - window
        pairs = float(band.sum()) * B * Hq
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(
            *leaves, is_causal=causal and window is None,
            attn_mask=band if window is not None else None,
            enable_gqa=Hq != Hkv)

        def library():
            return torch.autograd.grad(out, leaves, do, retain_graph=True)

        reps = 10
        p1 = time_ms(plain, 2)
        k1 = time_ms(kernel, reps)
        k2 = time_ms(kernel, reps)
        p2 = time_ms(plain, 2)
        lib = time_ms(library, reps)
        dev_ms, events = device_ms(kernel, reps)
        lib_dev, _ = device_ms(library, reps)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                kernel()
            torch.cuda.synchronize()
        parts = {n[:40]: us / reps / 1e3 for n, us in _kernel_us(prof).items()}
        b_ms, by = _bound(2.0 * (2 * (D + Dv) * (B * Hq * Sq + B * Hkv * Sk))
                          + 4.0 * B * Hq * Sq, 2.0 * (3 * D + 2 * Dv) * pairs,
                          BF16_FLOPS_PER_S)
        res[label] = {"shape": [B, Hq, Hkv, Sq, Sk, D, causal, window, Dv],
                      "device_ms": dev_ms, "events_per_call": events,
                      "ms": min(k1, k2), "plain_ms": min(p1, p2),
                      "library_ms": lib, "library_device_ms": lib_dev,
                      "bound_ms": b_ms, "bound_by": by,
                      "bound_share": b_ms / dev_ms, "max_err": errs,
                      "max_err_plain": plain_errs, "kernels_ms": parts}
        log(f"time flash backward {label} {res[label]['shape']}: device "
            f"{dev_ms:.5f} ms ({events} events a call: {parts}), kernel "
            f"{k1:.5f}/{k2:.5f} ms, plain {p1:.5f}/{p2:.5f} ms, library "
            f"{lib:.5f} ms (device {lib_dev:.5f}), bound {b_ms:.5f} ms ({by}), "
            f"share {b_ms / dev_ms:.4f}; max err dq/dk/dv {errs} against the "
            f"twin, {plain_errs} against the plain backward")
        del q, k, v, do, o, lse, leaves, out, band
        torch.cuda.empty_cache()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1 << 20)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_embed import fused_embed
    from repro_torch.kernels.ref import fused_embed_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"device: {kind} (torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(f"nvidia-smi: {smi}")

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {built} (wall {time.perf_counter() - t0:.2f} s)")

    worst = compare_kernel(fused_embed, fused_embed_ref, dev)
    lm_worst = compare_lm_kernels(dev)
    mp = main_path(args, fused_embed)
    quickstart()
    world = mp.pop("world")
    sp = served_path(world, fused_embed, mp["model"])
    t0 = time.perf_counter()
    ms = mesh_path(world, mp["model"], world["predict_want"], sp.pop("want"),
                   sp["hint"], dev)
    dp = distributed_path(dev)
    log(f"phase 6b: {time.perf_counter() - t0:.2f} s")
    del world
    lm = lm_path(args, dev)
    fam = lm_families(args, dev)
    wh = whisper_path(args, dev)
    tr = training_path(args, dev)
    with dry_pool() as pool:
        futs = {cell: pool.submit(_dry_cell, *cell) for cell in DRY_CELLS}
        t0 = time.perf_counter()
        sh = sharded_path(args, dev)
        log(f"phase 11: {time.perf_counter() - t0:.2f} s (phase 12 (b)'s "
            f"{len(DRY_CELLS)} traces running beside it)")
        t0 = time.perf_counter()
        dr = dryrun_path(args, dev, futs)
        log(f"phase 12: {time.perf_counter() - t0:.2f} s")
    tm = timings(fused_embed, fused_embed_ref, dev, mp["K"])
    sv = lm["serve"]
    lt = lm_timings(dev, sv["slots"], sv["prompt"], sv["gen"])
    fb = flash_backward_timings(dev)

    kernels = [{
        "name": "fused_embed", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_embed.cu",
        "replaces": "src/repro/kernels/fused_embed.py:44",
        "launches": mp["launches"], "launches_served": sp["launches"],
        "launches_mesh": {
            "shards": 2, "chunks": ms["chunks"],
            "launches": ms["b"][("linear", "dup")]["launches"],
            "predict": ms["predict_launches"],
            "served": ms["serve_launches"]},
        "max_abs_err": worst[torch.float32],
        "max_abs_err_bf16": worst[torch.bfloat16],
        **tm[(256, 16, mp["K"])], "design": EMBED_DESIGN,
        "at_2p20_rows": tm[(1 << 20, 16, mp["K"])],
        "at_1_row": tm[(1, 16, 8)],
    }]

    def fam_launches(name):
        return {a: fam[a]["serve"]["launches"][name] for a in FAMILIES}

    def lm_entry(name, replaces, timing, **extra):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": replaces, "launches": sv["launches"][name],
                "max_abs_err": lm_worst[name][torch.float32],
                "max_abs_err_bf16": lm_worst[name][torch.bfloat16],
                **timing, **extra}

    kernels += [
        lm_entry("rmsnorm", "src/repro/kernels/rmsnorm.py:32",
                 lt["rmsnorm_decode"], design=RMSNORM_DESIGN,
                 at_prefill=lt["rmsnorm_prefill"],
                 at_wide=lt["rmsnorm_wide"],
                 launches_families=fam_launches("rmsnorm"),
                 launches_train_step=tr["train"]["launches_per_step"][
                     "rmsnorm"],
                 launches_sharded_step=sh["step"]["launches"]["rmsnorm"],
                 launches_sharded_families={
                     a: f["launches"]["rmsnorm"]
                     for a, f in sh["families"].items()}),
        lm_entry("flash_attention", "src/repro/kernels/flash_attention.py:104",
                 lt["flash_attention_prefill"], design=FLASH_DESIGN,
                 at_8192=lt["flash_attention_long"],
                 at_d256=lt["flash_attention_d256"],
                 at_whisper_encoder=lt["flash_attention_whisper"],
                 backward=fb,
                 launches_backward_train_step=tr["train"][
                     "launches_per_step"]["flash_attention_backward"],
                 launches_families=fam_launches("flash_attention"),
                 launches_whisper=wh["serve"]["launches"]["flash_attention"],
                 launches_train_step=tr["train"]["launches_per_step"][
                     "flash_attention"],
                 launches_sharded_step=sh["step"]["launches"][
                     "flash_attention"],
                 launches_sharded_families={
                     a: f["launches"]["flash_attention"]
                     for a, f in sh["families"].items()}),
        lm_entry("decode_attention",
                 "src/repro/kernels/decode_attention.py:72",
                 lt["decode_attention"], design=DECODE_DESIGN,
                 at_d256=lt["decode_attention_d256"],
                 at_partial_card_cell=lt["decode_attention_partial"],
                 launches_families=fam_launches("decode_attention"),
                 launches_whisper=wh["serve"]["launches"][
                     "decode_attention"],
                 launches_mesh_decode_step=dr["card"]["launches"][
                     "decode_attention"],
                 decode_bf16_gap=max(DECODE_GAP.values())),
    ]
    log(f"main path: model={mp['model']} stage_count={mp['stage_count']} "
        f"cold={mp['cold_s']:.4f} s warm={mp['warm_s']:.4f} s "
        f"predict={mp['predict_s']:.4f} s "
        f"(launches cold={mp['launches']} predict={mp['predict_launches']})")
    log(f"served path: devices={sp['devices']} Eq. 10 picks={sp['picks']} "
        f"cold={sp['cold_s']:.4f} s warm={sp['warm_s']:.4f} s numpy server="
        f"{sp['numpy_s']:.4f} s ({sp['rows']} rows a round, launches cold="
        f"{sp['launches']}), dispatch up {sp['dispatch_start_s']:.2f} s, "
        f"served {sp['dispatch_s']:.4f} s, max abs diff {sp['err']:.3e}")
    dup, lin = ms["b"][("linear", "dup")], ms["b"][("linear", "all")]
    log(f"mesh path: linear {dup['secs']:.4f} s over (cuda:0, cuda:0), "
        f"{lin['secs']:.4f} s over {lin['shards']} visible, single device "
        f"{dup['single_s']:.4f} s; a shard's fused_embed "
        f"{ms['shard_device_ms']:.5f} ms on the device, a chunk's "
        f"{ms['chunk_device_ms']:.5f} ms; session PREDICT "
        f"{ms['predict_s']:.4f} s, server round {ms['serve_s']:.4f} s, max "
        f"abs diff {ms['err']:.3e}; nccl compressed all-reduce "
        f"{dp['compress_s']:.4f} s, worst {dp['compress_worst_steps']:.4f} "
        "of a step")
    log(f"lm path: serve bf16 prefill {sv['prefill_s']:.4f} s, decode "
        f"{sv['decode_tok_s']:.1f} tok/s, launches {sv['launches']}; f32 "
        "max |logit - plain| (prefill/decode): " + ", ".join(
            f"B={b} prompt={p}: {r['prefill_err']:.3e}/{r['decode_err']:.3e}"
            for (b, p), r in lm["f32"].items()))
    for arch in FAMILIES:
        f, sv_f = fam[arch]["f32"], fam[arch]["serve"]
        log(f"lm {arch}: serve bf16 prefill {sv_f['prefill_s']:.4f} s, "
            f"decode {sv_f['decode_tok_s']:.1f} tok/s, peak "
            f"{sv_f['peak_gib']:.2f} GiB, launches {sv_f['launches']}; f32 "
            f"max |logit - plain| {f['prefill_err']:.3e}/"
            f"{f['decode_err']:.3e} on {f['rows_held']} rows")
    g = fam[D256_DENSE[0]]["f32"]
    log(f"lm {D256_DENSE[0]} f32 max |logit - plain| {g['prefill_err']:.3e}/"
        f"{g['decode_err']:.3e}; launcher {fam['cli']}")
    ws, wf = wh["serve"], wh["f32"]
    log(f"whisper: {wh['params_spec']} parameters (cfg.param_count() "
        f"{wh['params_cfg']}); serve bf16 prefill {ws['prefill_s']:.4f} s, "
        f"decode {ws['decode_tok_s']:.1f} tok/s, peak {ws['peak_gib']:.2f} "
        f"GiB, launches {ws['launches']}; f32 max |logit - plain| "
        f"{wf['prefill_err']:.3e}/{wf['decode_err']:.3e}")
    t = tr["train"]
    log(f"training: grads worst {tr['grad_lm']['worst_rel']:.3e} "
        f"({LM_ARCH}, {tr['grad_lm']['worst_leaf']}), "
        f"{tr['grad_whisper']['worst_rel']:.3e} ({WHISPER}, "
        f"{tr['grad_whisper']['worst_leaf']}) of max |g_plain|; bf16 "
        f"{LM_ARCH} steady step {t['steady_s']:.4f} s, {t['tok_s']:.1f} "
        f"tok/s, model FLOPs share {t['mfu']:.4f}, peak {t['peak_gib']:.2f} "
        f"GiB, launches a step {t['launches_per_step']}")
    st, ep, stt = sh["step"], sh["ep"], sh["train"]
    log(f"sharded: {LM_ARCH} step on the (1, 1) mesh, loss gap "
        f"{st['loss_gap']:.3e}, param gap {st['param_gap']:.3e}, launches "
        f"{st['launches']}; " + "; ".join(
            f"{a} loss gap {f['loss_gap']:.3e}, param gap "
            f"{f['param_gap']:.3e}, launches {f['launches']}"
            for a, f in sh["families"].items())
        + f"; EP {EP_ARCH} y {ep['y_err']:.3e}, aux "
        f"{ep['aux_err']:.3e}, worst grad {max(ep['grad_rel'].values()):.3e}"
        f"; --mesh host steady step {stt['steady_s']:.4f} s, "
        f"{stt['tok_s']:.1f} tok/s, peak {stt['peak_gib']:.2f} GiB (--mesh "
        f"none: {t['steady_s']:.4f} s, {t['tok_s']:.1f} tok/s, peak "
        f"{t['peak_gib']:.2f} GiB)")
    c = dr["card"]
    log(f"dry run: {DRY_ARCH} {DRY_SHAPE} on the (1, 1) mesh: argument "
        f"bytes {c['arg_bytes']} == placed {c['placed']} (memory_allocated "
        f"+{c['grown']}), launches a step {c['launches']}, step "
        f"{c['step_device_ms']:.4f} ms on the device vs the record's memory "
        f"term {c['record_memory_ms']:.4f} ms, record temp {c['temp']} vs "
        f"peak {c['peak']}; records: " + "; ".join(
            f"{a}/{sh_} {r['roofline']['dominant']} compute "
            f"{r['roofline']['compute_s']:.4g} s memory "
            f"{r['roofline']['memory_s']:.4g} s coll "
            f"{r['roofline']['collective_s']:.4g} s useful "
            f"{r['useful_flops_ratio']:.3f} trace {r['compile_s']:.1f} s"
            for (a, sh_), r in dr["records"].items()))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
