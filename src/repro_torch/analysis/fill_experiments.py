"""Fill the <!-- ROOFLINE_TABLE --> marker of a markdown file from the
port's dry-run records (single + multi-pod summary).

Port of ``src/repro/analysis/fill_experiments.py``: ``build_tables`` gives
the reference's text for the same records. ``main`` reads the port's
records (``artifacts/dryrun_torch/``, never the reference's
``artifacts/dryrun/``) and fills ``EXPERIMENTS.md`` at the repo root, as
the reference's does.

    PYTHONPATH=src python -m repro_torch.analysis.fill_experiments
"""
from __future__ import annotations

import sys
from pathlib import Path

from repro_torch.analysis.report import (load_records, markdown_table,
                                         roofline_row)

ROOT = Path(__file__).resolve().parents[3]
MARKER = "<!-- ROOFLINE_TABLE -->"


def build_tables(art: Path) -> str:
    single = [roofline_row(r) for r in load_records(art, "single")]
    multi = [roofline_row(r) for r in load_records(art, "multi")]
    out = ["### Single pod (16x16 = 256 chips)\n\n",
           markdown_table(single), "\n",
           "### Multi-pod (2x16x16 = 512 chips)\n\n",
           markdown_table(multi)]
    return "".join(out)


def main(art: Path = ROOT / "artifacts" / "dryrun_torch",
         exp: Path = ROOT / "EXPERIMENTS.md") -> int:
    if not exp.exists():
        print(f"{exp} not found", file=sys.stderr)
        return 1
    text = exp.read_text()
    if MARKER not in text:
        print("marker not found", file=sys.stderr)
        return 1
    table = build_tables(art)
    exp.write_text(text.replace(MARKER, table))
    print(f"filled roofline tables ({len(table)} chars)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
