"""Port parity for ``repro_torch.launch.dryrun`` and the sharded decode step
it traces.

- ``lower_cell`` on an 8-rank fake world, the production mesh swapped for
  the (2, 4) host mesh, against the reference's ``lower_cell`` on 8 forced
  host devices with its mesh swapped the same way (each in a subprocess,
  as ``tests/test_distributed.py`` runs the reference's): gemma-2b
  ``decode_32k`` and h2o-danube-1.8b ``train_4k`` at smoke width through
  ``cfg_overrides``, and (``FAMILY_CELLS``) gemma-2b with fewer q heads
  than ``"model"`` kept whole over it, mamba2 and recurrentgemma
  ``train_4k`` and ``prefill_32k``, mamba2's ``decode_32k``, olmoe's and
  kimi's ``train_4k`` under remat: FLOPs a device equal but for ops each
  named in ``_named_difference``, gemma's rank-local dots the
  reference's HLO dots (both repeat the replicated heads' attention on
  each ``"model"`` rank). ``model_flops_per_device`` is exact;
  ``flops_per_device`` (the port's FLOP counter against the reference's
  jaxpr count) is equal; ``argument_size_in_bytes`` is equal to the byte
  (rank 0's shards of the same params, optimizer state, batch and cache),
  but for the reference's 4-byte device scalar of the decode position.
  The record keeps every key of the reference's and names its mesh's
  device type (``"cpu"`` here). ``mesh: "multi"`` runs one cell on a
  512-rank fake world. The all-reduces are held to the reference's, op by
  op at the activation's shape (the bulk of the collective term), with
  each difference named in the test; the other kinds are compared where
  the two agree (on a ``"cpu"`` mesh DTensor stands an all-gather for an
  all-to-all). A DTensor matmul under the counting mode on that world
  counts its local piece only: DTensor's global-shape stand-in run does
  not reach the mode.
- The sharded decode step, in a 4-rank gloo group on a (2, 2) mesh with
  ``cache_seq`` over ``"model"`` (the dry-run's decode rules): a dense
  (h2o-danube, its 64-slot smoke window), a hybrid (recurrentgemma,
  RG-LRU), an SSM (mamba2) smoke LM and whisper's decoder, after an
  off-mesh prefill of 60 tokens, 6 greedy steps across the window's wrap
  and one more: tokens equal and logits and caches within 1e-5 of the
  port's single-device decode, on the plain route and the kernel route
  (each wrapper's plain version on the CPU), every rank holding its
  slice of the caches. The params are the reference's init; the
  reference's single-device decode, fed the mesh's tokens, picks the
  same greedy tokens and its logits after the last are within 2e-4 of
  the mesh's.
- ``decode_attention_partial`` (the plain twin on the CPU) over 1, 2 and
  4 slices, merged by ``combine_partials``, against
  ``decode_attention_ref``; ``decode_attention_slice`` (the plain route's
  slice, with the window's circular slots) merged against the plain
  ``decode_attention`` before and after the window wraps; the wrappers
  refuse fake tensors; ``set_decode_f32_upcast`` drops the rounding.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_workers as W  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    combine_partials, decode_attention, decode_attention_partial)
from repro_torch.kernels.ref import decode_attention_ref  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SUBPROCESS_TIMEOUT_S = 480
GROUP_TIMEOUT_S = 240
DECODE_TOL = 1e-5
# the port against the reference, float32 through a whole smoke model: the
# bound of the single-device decode parity tests (test_torch_models.py)
REF_TOL = 2e-4
PROMPT, MAX_LEN, DECODE_B = 60, 72, 4
SMOKE = {"num_layers": 2, "d_model": 128, "num_heads": 4, "head_dim": 32,
         "d_ff": 256, "vocab_size": 512}
CELLS = (("gemma-2b", "decode_32k", dict(SMOKE, num_kv_heads=1)),
         ("h2o-danube-1.8b", "train_4k", dict(SMOKE, num_kv_heads=2)))
# the cells the sharded LM of every family must lower as the reference
# does: gemma with fewer q heads (2) than the "model" axis (4), kept whole
# over it (its config's shard_attn_heads=False); mamba2's SSD heads and
# recurrentgemma's RG-LRU width split over "model"; recurrentgemma's
# residual sequence-parallel (its seq_parallel). One layer each where the
# pattern allows, to keep the trace short.
GEMMA = dict(SMOKE, num_layers=1, num_heads=2, num_kv_heads=1)
MAMBA = dict(SMOKE, num_layers=1, d_ff=0,
             ssm={"state_dim": 16, "head_dim": 16, "expand": 2,
                  "conv_dim": 4, "chunk": 32, "n_groups": 1})
GRIFFIN = dict(SMOKE, num_layers=3, num_kv_heads=1, rglru_width=128,
               local_attn_window=64)
# the EP block under full remat (olmoe's train_4k was 1.35x the
# reference's: the counter charged remat's replay to the EP body's
# shards), and kimi's gradient accumulation over 4 micro-batches
EXPERTS = {"num_experts": 8, "top_k": 2, "d_ff_expert": 64,
           "impl": "batched"}
OLMOE = dict(SMOKE, num_layers=1, num_kv_heads=4, moe=EXPERTS)
KIMI = dict(SMOKE, num_layers=1, num_kv_heads=2, moe=EXPERTS)
FAMILY_CELLS = tuple((a, s, ov) for a, ov in (
    ("gemma-2b", GEMMA), ("mamba2-370m", MAMBA),
    ("recurrentgemma-9b", GRIFFIN)) for s in ("train_4k", "prefill_32k")) + (
    ("mamba2-370m", "decode_32k", MAMBA), ("olmoe-1b-7b", "train_4k", OLMOE),
    ("kimi-k2-1t-a32b", "train_4k", KIMI))
MULTI = ("h2o-danube-1.8b", "decode_32k",
         dict(SMOKE, d_model=256, num_heads=16, num_kv_heads=8, head_dim=16,
              d_ff=512))
RECORD_KEYS = ("flops_per_device", "model_flops_per_device",
               "hlo_dot_flops_per_device", "bytes_accessed_per_device",
               "useful_flops_ratio", "memory_analysis", "roofline",
               "collectives", "chips", "mesh")

_REFERENCE = """
    import json
    import re
    import repro.launch.dryrun as dr
    import repro.launch.mesh as mesh_mod
    from repro.analysis.hlo_cost import HloModule
    small = lambda multi_pod=False: mesh_mod.make_host_mesh(2, 4)
    mesh_mod.make_production_mesh = small
    dr.make_production_mesh = small
    KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")

    def collective_ops(text):
        # [kind, result array shapes, times run (loop trips)] for each
        # collective of the compiled module, walked as hlo_cost walks it
        mod, ops = HloModule(text), []
        def walk(name, mult):
            for ins in mod.computations.get(name, []):
                if ins.op == "while":
                    walk(mod._called(ins, "body"), mult * mod._trip_count(
                        mod._called(ins, "condition")))
                    continue
                if ins.op in ("call", "async-start", "conditional"):
                    for key in ("to_apply", "calls", "true_computation",
                                "false_computation"):
                        if mod._called(ins, key):
                            walk(mod._called(ins, key), mult)
                    continue
                for kind in KINDS:
                    if ins.op in (kind, kind + "-start"):
                        shapes = [[int(d) for d in m.split(",") if d]
                                  for m in re.findall(r"\\w+\\[([\\d,]*)\\]",
                                                      ins.type_str)]
                        ops.append([kind, shapes, mult])
        walk(mod.entry, 1)
        return ops

    from repro.configs.base import MoEConfig, SSMConfig
    out = {}
    for arch, shape, ov in CELLS:
        if "ssm" in ov:
            ov = dict(ov, ssm=SSMConfig(**ov["ssm"]))
        if "moe" in ov:
            ov = dict(ov, moe=MoEConfig(**ov["moe"]))
        rec, compiled = dr.lower_cell(arch, shape, False, cfg_overrides=ov)
        rec["collective_ops"] = collective_ops(compiled.as_text())
        out[arch + "/" + shape] = rec
    print("RECORDS" + json.dumps(out))
"""

_PORT = """
    import json
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    import repro_torch.launch.dryrun as dr
    import repro_torch.launch.mesh as mesh_mod
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    # a DTensor matmul on the 8-rank world, on fake tensors as the dry run
    # traces: (64, 32) split over the ranks @ (32, 16) whole
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.analysis.op_cost import OpCostMode
    flat = init_device_mesh("cpu", (8,))
    with FakeTensorMode(allow_non_fake_inputs=True):
        a = distribute_tensor(torch.empty(64, 32), flat, [Shard(0)])
        b = distribute_tensor(torch.empty(32, 16), flat, [Replicate()])
        with OpCostMode() as mode:
            a @ b
    c = mode.cost()
    probe = {"dot_flops": c.dot_flops, "global_flops": c.global_flops,
             "bytes": c.bytes_accessed}
    # a strided shard: a [16, 64, 32] gradient split over "data" on its
    # rows and over "model" on its sequence, flattened for a weight's
    # gradient product (a sequence-parallel residual's, on the 512-rank
    # mesh); DTensor reads its offsets with .tolist()
    mesh2 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    with FakeTensorMode(allow_non_fake_inputs=True):
        g = distribute_tensor(torch.empty(16, 64, 32), mesh2,
                              [Shard(0), Shard(1)])
        h = distribute_tensor(torch.empty(16, 64, 48), mesh2,
                              [Shard(0), Shard(2)])
        with OpCostMode() as mode:
            w = h.reshape(-1, 48).t() @ g.reshape(-1, 32)
    probe["strided"] = [list(w.shape), mode.cost().global_flops]
    real = mesh_mod.make_production_mesh
    mesh_mod.make_production_mesh = (
        lambda multi_pod=False: mesh_mod.make_host_mesh(2, 4))
    from repro_torch.configs.base import MoEConfig, SSMConfig
    out = {}
    for arch, shape, ov in CELLS:
        if "ssm" in ov:
            ov = dict(ov, ssm=SSMConfig(**ov["ssm"]))
        if "moe" in ov:
            ov = dict(ov, moe=MoEConfig(**ov["moe"]))
        rec, _ = dr.lower_cell(arch, shape, False, cfg_overrides=ov)
        out[arch + "/" + shape] = rec
    dist.destroy_process_group()
    mesh_mod.make_production_mesh = real
    if MULTI:
        arch, shape, ov = MULTI
        rec, _ = dr.lower_cell(arch, shape, True, cfg_overrides=ov)
        out["multi"] = rec
        out["world"] = dist.get_world_size()
    out["probe"] = probe
    print("RECORDS" + json.dumps(out))
"""


def _start(code: str, env_extra: dict, cells, multi) -> subprocess.Popen:
    env = dict(os.environ)
    env.update(env_extra)
    env["PYTHONPATH"] = str(REPO / "src")
    head = f"CELLS = {cells!r}\nMULTI = {multi!r}\n"
    return subprocess.Popen(
        [sys.executable, "-c", head + textwrap.dedent(code)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _records(proc: subprocess.Popen) -> dict:
    try:
        out, err = proc.communicate(timeout=SUBPROCESS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-4000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RECORDS")]
    return json.loads(line[-1][len("RECORDS"):])


@pytest.fixture(scope="module")
def records():
    """Both packages' records of CELLS (and the port's of MULTI) and of
    FAMILY_CELLS, traced in six subprocesses at once."""
    ref_env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
               "JAX_PLATFORMS": "cpu"}
    halves = (FAMILY_CELLS[::2], FAMILY_CELLS[1::2])
    procs = [_start(_REFERENCE, ref_env, CELLS, None),
             _start(_PORT, {}, CELLS, MULTI)]
    procs += [_start(code, env, cells, None) for cells in halves
              for code, env in ((_REFERENCE, ref_env), (_PORT, {}))]
    try:
        ref, port, *fam = [_records(p) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, got in enumerate(fam):
        (ref if i % 2 == 0 else port).update(
            {k: v for k, v in got.items() if k != "probe"})
    return SimpleNamespace(ref=ref, port=port)


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s, _ in CELLS])
def test_lower_cell_matches_reference(records, cell):
    r, p = records.ref[cell], records.port[cell]
    assert set(r) <= set(p), set(r) - set(p)
    assert p["mesh_device"] == "cpu" and p["chips"] == r["chips"] == 8
    assert p["model_flops_per_device"] == r["model_flops_per_device"]
    # the port's counter and the reference's jaxpr count see the same
    # matmuls: projections, MLP, logits, chunked attention's score and
    # value products (each kv chunk a q chunk reaches), their gradients
    # and remat's recompute; no difference to list
    assert p["flops_per_device"] == r["flops_per_device"], (
        p["flops_per_device"], r["flops_per_device"])
    # to the byte, but for the decode position: the reference's state
    # holds it as an int32 device scalar (4 bytes; its KV cache's own
    # index scalar is unused, and jit prunes it), the port's as a host int
    index_bytes = 4 if "decode" in cell else 0
    assert (p["memory_analysis"]["argument_size_in_bytes"] + index_bytes
            == r["memory_analysis"]["argument_size_in_bytes"])
    for k in RECORD_KEYS:
        assert p[k] is not None, k
    t = p["roofline"]
    assert t["compute_s"] > 0 and t["memory_s"] > 0
    assert p["xla_cost_flops_loop_once"] is None
    assert p["loop_trip_counts"] == []
    _check_collectives(cell, r, p)


def _named_difference(cell: str, ov: dict) -> float:
    """The reference's FLOPs a device that the port's count has not, op by
    op (0 for the cells with none).

    - mamba2: its SSD writes two three-operand einsums
      (``bclhn,bclhp,bclh->bchpn``, ``bclhn,bchpn,bclh->bclhp``) whose
      ``bclh`` factor jnp's contraction path lowers as a ``dot_general``
      with no contracting dim, which the reference's jaxpr count charges
      2 FLOPs an element of [b, S, H, P]; the port multiplies it in
      elementwise (no matmul).
    - olmoe, kimi: the reference routes inside its EP ``shard_map``, so each
      "model" rank repeats the router product [T / data, d] x [d, E] on
      its data shard's tokens, and the jaxpr count charges the body times
      the mesh size; the port routes once on the DTensors, before its EP
      body (``models/moe.py`` ``_moe_ep``).

    - mamba2's decode step: the state update's outer product
      ``bhn,bhp->bhpn`` is such a dot in the reference (2 FLOPs an
      element of [B, H, P, N]) and a broadcast multiply in the port.

    Each runs once in a forward; a train step adds remat's recompute and
    the two operands' gradients."""
    from repro_torch.configs import SHAPES
    shape = SHAPES[cell.split("/")[1]]
    runs = 4 if shape.kind == "train" else 1
    tokens = shape.global_batch * shape.seq_len
    model = 4                                           # the (2, 4) mesh
    if cell == "mamba2-370m/decode_32k":
        s = ov["ssm"]
        d_in = s["expand"] * ov["d_model"]
        per_run = 2.0 * shape.global_batch * d_in * s["state_dim"]  # BHPN
    elif cell.startswith("mamba2"):
        d_in = ov["ssm"]["expand"] * ov["d_model"]
        per_run = 2 * 2.0 * tokens * d_in               # two dots, b·S·H·P
    elif "moe" in ov:
        per_run = (model - 1) * 2.0 * tokens * ov["d_model"] * \
            ov["moe"]["num_experts"]
    else:
        return 0.0
    return ov["num_layers"] * runs * per_run / 8


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s, _ in FAMILY_CELLS])
def test_family_cells_match_reference(records, cell):
    """gemma's replicated heads, mamba2's split SSD heads, recurrentgemma's
    split RG-LRU width and sequence-parallel residual lower as the
    reference's, and the EP block under remat (olmoe; kimi with its
    gradient accumulation): model FLOPs exact,
    FLOPs a device equal but for the ops named in _named_difference,
    argument bytes equal."""
    r, p = records.ref[cell], records.port[cell]
    ov = {f"{a}/{s}": o for a, s, o in FAMILY_CELLS}[cell]
    assert p["model_flops_per_device"] == r["model_flops_per_device"]
    extra = _named_difference(cell, ov)
    assert p["flops_per_device"] + extra == pytest.approx(
        r["flops_per_device"], rel=1e-12), (p["flops_per_device"], extra,
                                            r["flops_per_device"])
    index_bytes = 4 if "decode" in cell else 0      # as in the test above
    assert (p["memory_analysis"]["argument_size_in_bytes"] + index_bytes
            == r["memory_analysis"]["argument_size_in_bytes"])
    own = p["hlo_dot_flops_per_device"]
    if cell.startswith("gemma"):
        # the 2 q heads stay whole over "model" (shard_attn_heads=False):
        # each model rank repeats its data shard's attention, in the
        # reference's compiled step too (its score products are
        # [128, 1024, 1024] a device at train_4k: the data shard's whole
        # batch). The FLOPs a device count that work once, as the
        # reference's jaxpr does; the dots each rank runs are the
        # reference's HLO dots
        assert own == pytest.approx(r["hlo_dot_flops_per_device"], rel=0.02)
        assert own > 2 * p["flops_per_device"]
    elif "moe" not in ov and "decode" not in cell:
        # split heads / width: no rank repeats another's scan or products
        assert own <= 1.03 * p["flops_per_device"]
    # the split cores hold their share: a train or prefill step's temp
    # bytes within 3x the reference's (mamba2 prefill_32k held 6.9x with
    # every head whole; a decode step's are a few MB either way)
    if "decode" not in cell:
        assert (p["memory_analysis"]["temp_size_in_bytes"]
                <= 3 * r["memory_analysis"]["temp_size_in_bytes"])


def _ops(rec, kind, shape=None):
    """(times run, operand bytes) of ``rec``'s ``kind`` collectives, those
    of one operand ``shape`` only if given. The reference's entries list
    the result arrays of each op (an all-reduce's are its operands)."""
    n = b = 0
    for op in rec["collective_ops"]:
        if op[0] != kind:
            continue
        if len(op) == 5:                        # the port's
            if shape is None or op[1] == shape:
                n, b = n + op[3], b + op[4]
        else:                                   # the reference's
            n += op[2] * sum(1 for s in op[1] if shape in (None, s))
    return n, b


def _largest_op_bytes(rec) -> float:
    """The largest single collective's operand bytes (the reference's at
    4 bytes an element, its CPU pipeline's f32)."""
    if rec is None or not rec["collective_ops"]:
        return 0.0
    if len(rec["collective_ops"][0]) == 5:
        return max(op[4] / op[3] for op in rec["collective_ops"])
    return max(4.0 * float(np.prod(s)) for op in rec["collective_ops"]
               for s in op[1])


def _check_collectives(cell, r, p):
    """The port's collectives against the reference's, op by op where the
    two lower the same product, each difference named."""
    rc, pc = r["collectives"], p["collectives"]
    L = SMOKE["num_layers"]
    # the port's all-reduce term is no larger than the reference's (its
    # f32 payloads charged at bf16, as the reference's record does)
    assert (pc["collective_operand_bytes"]["all-reduce"]
            <= rc["collective_operand_bytes"]["all-reduce"])
    if "train" in cell:
        # train_4k smoke on (2, 4): 128 rows a data shard, 4096 tokens,
        # d_model 128. Both lower tensor parallelism over "model" as
        # all-reduces of the activation [128, 4096, 128] (bf16 in the
        # port), which are the bulk of the term
        act = [256 // 2, 4096, SMOKE["d_model"]]
        n_ref, _ = _ops(r, "all-reduce", act)
        n, b = _ops(p, "all-reduce", act)
        # the port: a layer's attention and MLP outputs in the forward,
        # the attention's again in remat's recompute, the two column-
        # parallel inputs' gradients in the backward; the logits' input
        # gradient and the vocab-split embedding lookup's sum over "model"
        # once each. The reference: the same plus, a layer, the MLP
        # output again in the recompute (torch.utils.checkpoint stops
        # recomputing once the backward's saved tensors are back, before
        # that all-reduce)
        assert n == 5 * L + 2 == n_ref - L, (n, n_ref)
        assert b == n * float(np.prod(act)) * 2
        # the vocab-split loss: each row's max, then its sum of exp and
        # gold logit stacked, over "model" (f32 [128, 4095]: the labels
        # drop the last position), once each
        rows = [256 // 2, 4096 - 1]
        assert _ops(p, "all-reduce", rows)[0] == 1
        assert _ops(p, "all-reduce", [2] + rows)[0] == 1
        ce = _ops(p, "all-reduce", rows)[1] + _ops(p, "all-reduce",
                                                   [2] + rows)[1]
        assert ce == 3 * 4 * float(np.prod(rows))
        # nothing else of note: the norms' squares, the grad norm
        assert (pc["collective_operand_bytes"]["all-reduce"] - b - ce
                < 1e-3 * b)
        # the reference also sums its chunked attention's products over
        # "model" (2 kv heads on a 4-wide axis); the port cuts the q heads
        # to each rank's kv head (kv_head_slice) and sums none
        assert not [op for op in p["collective_ops"]
                    if op[0] == "all-reduce" and len(op[1]) == 4]
        assert [op for op in r["collective_ops"]
                if op[0] == "all-reduce" and len(op[1][0]) == 4]
        # the data-split gradients: DTensor reduce-scatters them (small);
        # XLA's CPU pipeline all-reduces and slices them
        assert "reduce-scatter" not in rc["collective_counts"]
        assert (pc["collective_operand_bytes"]["reduce-scatter"]
                < 1e-3 * pc["collective_operand_bytes"]["all-reduce"])
    else:
        # decode_32k smoke: the cache is split over "model" and neither
        # moves it (a rank's slice is 64 x 8192 x 32 a layer, 33.5 MB in
        # bf16); every collective is under 1 MB
        assert max(_largest_op_bytes(r), _largest_op_bytes(p)) < 1 << 20
        # the attention over the split cache: the port gathers each
        # slice's (o, lse) and merges them (combine_partials), once a
        # layer; the reference sums its softmax max, sum and the
        # probabilities times V over "model"
        B, H, hd = 128 // 2, SMOKE["num_heads"], SMOKE["head_dim"]
        assert _ops(p, "all-gather", [1, B, H, hd])[0] == L
        assert _ops(p, "all-gather", [1, B, H])[0] == L
        assert _ops(r, "all-reduce", [B, 1, H, hd])[0] >= L
        # the port's all-reduces are the [64, 1, 128] residual's partial
        # sums over "model", resolved at each norm that reads them, and
        # the vocab-split embedding lookup's sum
        n, b = _ops(p, "all-reduce", [B, 1, SMOKE["d_model"]])
        assert n == pc["collective_counts"]["all-reduce"] == 2 * L + 1
    # kinds: the reference's collective-permutes (XLA's re-layout of small
    # weights) and, in decode, its all-to-all have no counterpart on a
    # "cpu" mesh, where DTensor stands all-gathers for such moves
    assert set(pc["collective_counts"]) - {"reduce-scatter"} <= set(
        rc["collective_counts"])


def test_multi_pod_cell_runs_on_512_ranks(records):
    p = records.port["multi"]
    assert records.port["world"] == 512
    assert p["mesh"] == "multi" and p["chips"] == 512
    assert p["roofline"]["memory_s"] > 0 and p["useful_flops_ratio"] > 0
    assert p["memory_analysis"]["argument_size_in_bytes"] > 0


def test_stand_in_runs_are_not_counted(records):
    """DTensor runs an op once more at its global shapes to find its
    output's (the sharding propagator's tensor-meta step). The mode must
    see only the rank's local piece: (8, 32) @ (32, 16) on rank 0."""
    probe = records.port["probe"]
    assert probe["dot_flops"] == 2 * 8 * 32 * 16
    assert probe["global_flops"] == 2 * 64 * 32 * 16
    assert probe["bytes"] == (8 * 32 + 32 * 16 + 8 * 16) * 4


def test_a_strided_shard_traces_on_fake_tensors(records):
    """A split dim flattened into another (a strided shard) prices and
    redistributes under the counting modes on fake tensors: DTensor reads
    its offsets with .tolist(), which the modes let run on a real index
    tensor (the fault of recurrentgemma-9b's multi-pod train_4k, which
    shows only at the production shape)."""
    shape, flops = records.port["probe"]["strided"]
    assert shape == [48, 32] and flops == 2 * 48 * 16 * 64 * 32


def test_report_reads_the_port_records(records, tmp_path):
    from repro_torch.analysis.report import summarize
    for key, rec in records.port.items():
        if not isinstance(rec, dict) or "arch" not in rec:
            continue
        d = tmp_path / rec["mesh"] / rec["arch"]
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{rec['shape']}.json").write_text(json.dumps(rec))
    s = summarize(tmp_path)
    assert len(s["single"]) == len(CELLS) + len(FAMILY_CELLS)
    assert len(s["multi"]) == 1
    assert all(r["dominant"] in ("compute", "memory", "collective")
               for r in s["single"] + s["multi"])


def test_importing_the_dryrun_starts_no_process_group():
    import torch.distributed as dist

    import repro_torch.launch.dryrun  # noqa: F401
    assert not dist.is_initialized()


# -- the sharded decode step ---------------------------------------------------

def _decode_inputs():
    """Each family's smoke params from the reference's init, a prompt of
    PROMPT tokens for DECODE_B rows (and whisper's encoder frames), as
    numpy."""
    jax = pytest.importorskip("jax")
    from repro.configs import smoke_config as jsmoke
    from repro.models import build_model as jbuild
    rng = np.random.default_rng(11)
    inputs, models = {}, {}
    for i, arch in enumerate(W.DECODE_ARCHS):
        jcfg = jsmoke(arch)
        jm = jbuild(jcfg, attn_impl="naive")
        params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(i)))
        toks = rng.integers(0, jcfg.vocab_size, (DECODE_B, PROMPT))
        frames = (rng.standard_normal((DECODE_B, 32, jcfg.d_model))
                  .astype(np.float32) if jcfg.is_encoder_decoder else None)
        inputs[arch], models[arch] = (params, toks, frames), jm
    return inputs, models


def _reference_decode(jm, params, toks, frames, tokens):
    """The reference's single-device decode, teacher-forced on the port's
    mesh ``tokens`` [B, DECODE_STEPS]: its greedy tokens and the logits of
    the step after the last (the step the port's ``logits`` are of)."""
    import jax
    import jax.numpy as jnp
    step = jax.jit(jm.decode_step)
    inp = jnp.asarray(toks)
    if frames is not None:
        inp = {"tokens": inp, "frames": jnp.asarray(frames)}
    logits, state = jm.prefill(params, inp, max_len=MAX_LEN)
    nxt, greedy = jnp.argmax(logits[:, -1:], axis=-1), []
    for t in range(W.DECODE_STEPS + 1):
        logits, state = step(params, state, nxt)
        if t == W.DECODE_STEPS:
            break
        greedy.append(np.asarray(jnp.argmax(logits[:, -1:], axis=-1)))
        nxt = jnp.asarray(tokens[:, t:t + 1])
    return np.concatenate(greedy, axis=1), np.asarray(logits)


@pytest.fixture(scope="module")
def decode_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("decode")
    inputs, models = _decode_inputs()
    ranks = {route: W.run_group(W.sharded_decode, 4, root / route, inputs,
                                MAX_LEN, route == "kernels",
                                timeout=GROUP_TIMEOUT_S)
             for route in ("plain", "kernels")}
    ref = {(route, arch): _reference_decode(
        models[arch], *inputs[arch], ranks[route][0][arch]["mesh"]["tokens"])
        for route in ranks for arch in W.DECODE_ARCHS}
    return SimpleNamespace(ranks=ranks, ref=ref)


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("arch", W.DECODE_ARCHS)
def test_sharded_decode_matches_the_reference(decode_world, route, arch):
    """The mesh's greedy tokens are the reference's single-device greedy
    tokens, and its logits after them within REF_TOL of the reference's,
    on the same params and prompt."""
    mesh = decode_world.ranks[route][0][arch]["mesh"]
    greedy, logits = decode_world.ref[route, arch]
    assert (mesh["tokens"] == greedy).all()
    assert np.abs(mesh["logits"] - logits).max() < REF_TOL


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("arch", W.DECODE_ARCHS)
def test_sharded_decode_matches_single_device(decode_world, route, arch):
    ranks = decode_world.ranks[route]
    off, mesh = ranks[0][arch]["off"], ranks[0][arch]["mesh"]
    assert mesh["tokens"].shape == (4, W.DECODE_STEPS)
    assert (mesh["tokens"] == off["tokens"]).all()
    assert np.abs(mesh["logits"] - off["logits"]).max() < DECODE_TOL
    assert mesh["index"] == off["index"] == PROMPT + W.DECODE_STEPS
    for a, b in zip(mesh["caches"], off["caches"]):
        assert np.abs(a - b).max() < DECODE_TOL
    # every rank holds its slice: the KV caches split over the batch and
    # the cache length, the recurrent states over the batch and the width
    for shape, whole in zip(mesh["local"], off["caches"]):
        assert shape is not None and shape[1] == whole.shape[1] // 2
        assert int(np.prod(shape)) * 4 == whole.size
    for other in ranks[1:]:
        assert (other[arch]["mesh"]["tokens"] == mesh["tokens"]).all()


def _cache(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("length", [64, 57, 19])
def test_partials_combine_to_the_whole_decode(n, length):
    rng = np.random.default_rng(n * 100 + length)
    B, Hq, Hkv, S, D = 3, 8, 2, 64, 16
    q = _cache(rng, B, Hq, D)
    k, v = _cache(rng, B, Hkv, S, D), _cache(rng, B, Hkv, S, D)
    ws, os_, ls_ = S // n, [], []
    for i in range(n):
        ln = max(0, min(length - i * ws, ws))
        o, lse = decode_attention_partial(q, k[:, :, i * ws:(i + 1) * ws],
                                          v[:, :, i * ws:(i + 1) * ws], ln)
        assert o.dtype == lse.dtype == torch.float32
        if ln == 0:                     # a slice wholly past length
            assert torch.isneginf(lse).all() and not o.abs().max() > 0
        os_.append(o)
        ls_.append(lse)
    got = combine_partials(os_, ls_)
    want = decode_attention_ref(q, k, v, length)
    assert (got - want).abs().max() < 1e-6


@pytest.mark.parametrize("index", [40, 63, 64, 100])
def test_plain_slices_combine_to_the_windowed_decode(index):
    """The plain route's slices of a circular cache, with ``length -
    first`` clamped to a slice for the kernel route: before the window
    first wraps and after."""
    rng = np.random.default_rng(index)
    B, Hq, Hkv, W_, D, n = 2, 4, 2, 64, 16, 4
    q = _cache(rng, B, 1, Hq, D)
    k, v = _cache(rng, B, W_, Hkv, D), _cache(rng, B, W_, Hkv, D)
    want = A.decode_attention(q, k, v, index, window=W_)
    ws = W_ // n
    os_, ls_, kos, kls = [], [], [], []
    for i in range(n):
        o, lse = A.decode_attention_slice(q, k[:, i * ws:(i + 1) * ws],
                                          v[:, i * ws:(i + 1) * ws], index,
                                          W_, i * ws, window=W_)
        os_.append(o)
        ls_.append(lse)
        ln = max(0, min(min(index + 1, W_) - i * ws, ws))
        ko, kl = decode_attention_partial(
            q.reshape(B, Hq, D), k[:, i * ws:(i + 1) * ws].transpose(1, 2),
            v[:, i * ws:(i + 1) * ws].transpose(1, 2), ln)
        kos.append(ko)
        kls.append(kl)
    got = combine_partials(os_, ls_).reshape(B, 1, Hq, D)
    assert (got - want).abs().max() < 1e-6
    got_k = combine_partials(kos, kls).reshape(B, 1, Hq, D)
    assert (got_k - want).abs().max() < 1e-6


def test_decode_f32_upcast_drops_the_rounding():
    rng = np.random.default_rng(5)
    q = _cache(rng, 2, 1, 4, 16).to(torch.bfloat16)
    k = _cache(rng, 2, 32, 2, 16).to(torch.bfloat16)
    v = _cache(rng, 2, 32, 2, 16).to(torch.bfloat16)
    rounded = A.decode_attention(q, k, v, 31)
    try:
        A.set_decode_f32_upcast(True)
        upcast = A.decode_attention(q, k, v, 31)
    finally:
        A.set_decode_f32_upcast(False)
    f32 = decode_attention_ref(q.reshape(2, 4, 16), k.transpose(1, 2),
                               v.transpose(1, 2), 32).reshape(2, 1, 4, 16)
    assert torch.equal(upcast, f32)
    assert not torch.equal(rounded, upcast)


def test_cache_axes_match_reference():
    jax = pytest.importorskip("jax")
    from repro.configs import smoke_config as jsmoke
    from repro.models import build_model as jbuild
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    for arch in W.DECODE_ARCHS + ("olmoe-1b-7b",):
        ref = jbuild(jsmoke(arch)).cache_axes()
        got = build_model(smoke_config(arch)).cache_axes()
        assert jax.tree_util.tree_leaves(
            ref, is_leaf=lambda x: isinstance(x, tuple)
            and all(a is None or isinstance(a, str) for a in x)) == [
            a for a in _axes_leaves(got)], arch


def _axes_leaves(tree):
    import dataclasses
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _axes_leaves(getattr(tree, f.name))]
    if tree is None:
        return []
    return [tree]


def test_kernel_wrappers_refuse_fake_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.empty(2, 4, 16)
        k = torch.empty(2, 2, 32, 16)
        with pytest.raises(ValueError, match="fake tensor"):
            decode_attention(q, k, k, 32)
        with pytest.raises(ValueError, match="fake tensor"):
            decode_attention_partial(q, k, k, 32)
    meta = torch.empty(2, 4, 16, device="meta")
    with pytest.raises(ValueError):
        decode_attention(meta, torch.empty(2, 2, 32, 16, device="meta"),
                         torch.empty(2, 2, 32, 16, device="meta"), 32)
