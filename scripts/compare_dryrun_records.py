"""Compare the port's dry-run records with the reference's, cell by cell.

    PYTHONPATH=src python -m repro.launch.dryrun --all --mesh both \\
        --out /tmp/dry_ref
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out /tmp/dry_port
    python scripts/compare_dryrun_records.py /tmp/dry_ref /tmp/dry_port \\
        [--before /tmp/dry_port_old] [--markdown | --compact] \\
        [--ops multi/kimi-k2-1t-a32b/decode_32k ...]

Each record directory holds ``<mesh>/<arch>/<shape>.json`` (a failed cell
leaves ``<shape>.err``). For every cell the reference lowered, prints
``flops_per_device``, argument + temp bytes and collective operand bytes
of both packages (and of ``--before``, an older port's records, where
given), the port's FLOPs over the reference's, and whether the port's
cell is missing or failed; ``--compact`` prints a markdown table of
(arch, shape) cells, two a row, the single- and multi-pod meshes side
by side ("s; m"), with the port's rank-local matmul FLOPs
(``hlo_dot_flops_per_device``) over the reference's compiled HLO dots:
work a rank repeats shows there, not in ``flops_per_device``, which
counts the global program's matmuls once over the ranks. ``--ops`` prints
the port's collectives of the named cells by kind, operand shape and
dtype (the record's ``collective_ops``), most bytes first, beside the
reference's bytes by kind.
Exits 1 if a cell the reference lowered has no port record. Counts only:
the records' roofline seconds use each package's own hardware constants
and are not compared.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _records(root: Path) -> dict:
    out = {}
    for f in sorted(root.glob("*/*/*.json")):
        rec = json.loads(f.read_text())
        out[(rec["mesh"], rec["arch"], rec["shape"])] = rec
    return out


def _errors(root: Path) -> set:
    return {(f.parent.parent.name, f.parent.name, f.stem)
            for f in root.glob("*/*/*.err")}


def _terms(rec) -> tuple:
    if rec is None:
        return None, None, None
    m = rec["memory_analysis"]
    at = m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
    return (rec["flops_per_device"], at,
            rec["collectives"]["total_collective_bytes"])


def _fmt(x, unit="") -> str:
    if x is None:
        return "-"
    return f"{x / 1e9:.2f}" if unit == "GB" else f"{x:.4g}"


def _compact(ref, port, before, failed, failed_before) -> None:
    """One row an (arch, shape): reference FLOPs a device, the port's
    over it (before -> after), the port's HLO dots over the reference's,
    argument + temp GB and collective GB (reference -> before -> after),
    "single; multi"."""
    def ratio(recs, errs, key, field="flops_per_device"):
        if key in recs:
            return f"{recs[key][field] / ref[key][field]:.4f}"
        return "FAIL" if key in errs else "-"

    def gb(recs, errs, key, i):
        if key in recs:
            return _fmt(_terms(recs[key])[i], "GB")
        return "FAIL" if key in errs else "-"

    def trail(key, i):
        return (f"{gb(ref, set(), key, i)} → "
                + (f"{gb(before, failed_before, key, i)} → " if before
                   else "") + gb(port, failed, key, i))

    head = ("Cell | ref FLOPs/dev (s; m) | port/ref before → after (s; m) "
            "| HLO dots port/ref (s; m) | A+T GB ref → before → after "
            "(s; m) | coll GB ref → before → after (s; m)")
    print(f"| {head} | {head} |")
    print("|---" * 12 + "|")
    cells = sorted({(a, sh) for _, a, sh in ref})
    rows = []
    for a, sh in cells:
        keys = [(m, a, sh) for m in ("single", "multi")]
        fl = "; ".join(_fmt(_terms(ref[k])[0]) for k in keys)
        rt = "; ".join(
            (f"{ratio(before, failed_before, k)} → " if before else "")
            + ratio(port, failed, k) for k in keys)
        hd = "; ".join(ratio(port, failed, k, "hlo_dot_flops_per_device")
                       for k in keys)
        at = "; ".join(trail(k, 1) for k in keys)
        co = "; ".join(trail(k, 2) for k in keys)
        rows.append(f"{a} {sh} | {fl} | {rt} | {hd} | {at} | {co}")
    # two cells a row, to keep the table short
    for i in range(0, len(rows), 2):
        pair = rows[i:i + 2] + [" | " * 5] * (2 - len(rows[i:i + 2]))
        print("| " + " | ".join(pair) + " |")


def _ops(ref, port, cells, top: int = 8) -> None:
    """The port's largest collectives of each ``mesh/arch/shape`` cell."""
    for cell in cells:
        key = tuple(cell.split("/"))
        if key not in port:
            print(f"{cell}: no port record")
            continue
        rc = ref[key]["collectives"]["collective_operand_bytes"]
        pc = port[key]["collectives"]["collective_operand_bytes"]
        print(f"{cell}: operand GB by kind, reference "
              + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in sorted(rc.items()))
              + "; port "
              + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in sorted(pc.items())))
        for kind, shape, dtype, n, b in port[key]["collective_ops"][:top]:
            print(f"  {kind:14s} {str(tuple(shape)):28s} {dtype:9s} "
                  f"x{int(n):<5d} {b / 1e9:.3f} GB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ref", type=Path)
    ap.add_argument("port", type=Path)
    ap.add_argument("--before", type=Path, default=None)
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--compact", action="store_true")
    ap.add_argument("--ops", nargs="+", default=[],
                    help="mesh/arch/shape cells whose collectives to list")
    args = ap.parse_args(argv)
    ref, port = _records(args.ref), _records(args.port)
    before = _records(args.before) if args.before else {}
    failed = _errors(args.port)
    failed_before = _errors(args.before) if args.before else set()
    cols = ["mesh", "arch", "shape", "ref flops/dev", "port flops/dev",
            "port/ref", "ref A+T GB", "port A+T GB", "ref coll GB",
            "port coll GB"]
    if args.before:
        cols[4:4] = ["before flops/dev"]
        cols[8:8] = ["before A+T GB"]
        cols.append("before coll GB")
    rows, missing = [], []
    for key in sorted(ref):
        rf, ra, rc = _terms(ref[key])
        pf, pa, pc = _terms(port.get(key))
        if key not in port:
            missing.append(key)
        ratio = (f"{pf / rf:.4f}" if pf is not None and rf else
                 "FAIL" if key in failed else "missing")
        row = [*key, _fmt(rf), _fmt(pf), ratio, _fmt(ra, "GB"),
               _fmt(pa, "GB"), _fmt(rc, "GB"), _fmt(pc, "GB")]
        if args.before:
            bf, ba, bc = _terms(before.get(key))
            gone = "FAIL" if key in failed_before else "-"
            row[4:4] = [_fmt(bf) if bf is not None else gone]
            row[8:8] = [_fmt(ba, "GB") if ba is not None else gone]
            row.append(_fmt(bc, "GB") if bc is not None else gone)
        rows.append(row)
    if args.ops:
        _ops(ref, port, args.ops)
    elif args.compact:
        _compact(ref, port, before, failed, failed_before)
    elif args.markdown:
        print("| " + " | ".join(cols) + " |")
        print("|" + "---|" * len(cols))
        for r in rows:
            print("| " + " | ".join(r) + " |")
    else:
        w = [max(len(str(c)), *(len(str(r[i])) for r in rows))
             for i, c in enumerate(cols)]
        print("  ".join(c.ljust(w[i]) for i, c in enumerate(cols)))
        for r in rows:
            print("  ".join(str(x).ljust(w[i]) for i, x in enumerate(r)))
    print(f"{len(ref)} reference cells, {len(ref) - len(missing)} with a "
          f"port record, {len(missing)} without: {missing}")
    return 1 if missing else 0


if __name__ == "__main__":
    sys.exit(main())
