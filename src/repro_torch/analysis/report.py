"""Roofline report: aggregate dry-run records into the §Roofline table.

Port of ``src/repro/analysis/report.py``: the same functions, the same
rows and table for the same records (the port's records keep every key of
the reference's). The improvement notes name the card's terms (shared
memory, NVLink and InfiniBand) where the reference's name the TPU's.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

SKIP_NOTES = {
    ("llama3-405b", "long_500k"): "full attention — skipped per brief",
    ("gemma-2b", "long_500k"): "full attention — skipped per brief",
    ("granite-3-8b", "long_500k"): "full attention — skipped per brief",
    ("chameleon-34b", "long_500k"): "full attention — skipped per brief",
    ("whisper-medium", "long_500k"): "full attention — skipped per brief",
    ("olmoe-1b-7b", "long_500k"): "full attention — skipped per brief",
    ("kimi-k2-1t-a32b", "long_500k"): "full attention — skipped per brief",
}

IMPROVEMENT_NOTES = {
    "compute": ("remat recompute + attention-score FLOPs are the gap to "
                "6ND; reduce remat (policy) or fuse attention (the CUDA "
                "flash kernel)"),
    "memory": ("unfused attention-score/activation round-trips dominate; "
               "the CUDA flash kernel keeps them in shared memory and "
               "registers"),
    "collective": ("gradient all-reduce should be a reduce-scatter onto "
                   "FSDP shards; overlap with bwd compute (NVLink within "
                   "a node, InfiniBand across)"),
}


def load_records(art_dir: Path, mesh: str = "single") -> List[dict]:
    recs = []
    for p in sorted((art_dir / mesh).glob("*/*.json")):
        recs.append(json.loads(p.read_text()))
    return recs


def roofline_row(rec: dict) -> dict:
    r = rec["roofline"]
    terms = {"compute": r["compute_s"], "memory": r["memory_s"],
             "collective": r["collective_s"]}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    frac = (r["compute_s"] / bound) if bound > 0 else 0.0
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "compute_s": r["compute_s"],
        "memory_s": r["memory_s"],
        "collective_s": r["collective_s"],
        "dominant": dominant,
        "roofline_fraction": frac,   # compute / bound: 1.0 = compute-bound
        "useful_ratio": rec.get("useful_flops_ratio"),
        "model_flops_pd": rec.get("model_flops_per_device"),
        "flops_pd": rec.get("flops_per_device"),
        "note": IMPROVEMENT_NOTES[dominant],
    }


def markdown_table(rows: List[dict]) -> str:
    hdr = ("| arch | shape | mesh | compute(s) | memory(s) | coll(s) | "
           "dominant | roofline-frac | 6ND/HLO |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        ur = r["useful_ratio"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.4g} | {r['memory_s']:.4g} "
            f"| {r['collective_s']:.4g} | {r['dominant']} "
            f"| {r['roofline_fraction']:.3f} "
            f"| {ur:.3f} |\n" if ur is not None else
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | - | - | - | - | - |\n")
    return "".join(out)


def summarize(art_dir: Path) -> Dict[str, list]:
    single = [roofline_row(r) for r in load_records(art_dir, "single")]
    multi = [roofline_row(r) for r in load_records(art_dir, "multi")]
    return {"single": single, "multi": multi}
