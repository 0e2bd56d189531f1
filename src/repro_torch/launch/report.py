"""Aggregate the port's dry-run records into the roofline table and the
dry-run summary (port of ``repro/launch/report.py``), with the peak a
``--measure`` run took on the card beside the argument bytes.

  PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(dir_: str):
    recs = []
    for fn in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(fn) as f:
            recs.append(json.load(f))
    return recs


def fmt_s(x):
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.1f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def roofline_table(recs, mesh=None):
    rows = ["| arch | shape | layers | argument (GB) | measured peak (GB) | "
            "compute | memory | collective | bottleneck | MFU | useful |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if mesh is not None and r.get("mesh") != mesh:
            continue
        head = f"| {r['arch']} | {r['shape']} | {r.get('layers', '—')} |"
        if r["status"] == "skipped":
            rows.append(f"{head} — | — | — | — | — | skipped: "
                        f"{r['reason'][:40]}… | — | — |")
            continue
        if r["status"] == "FAILED":
            rows.append(f"{head} FAILED | | | | | | | |")
            continue
        m = r["memory"]
        fit = f"{m['argument_gb']:.2f}{'' if m['fits_card'] else ' ✗'}"
        peak = f"{m['peak_gb']:.2f}" if "peak_gb" in m else "—"
        if "roofline" not in r:          # not countable on meta
            rows.append(f"{head} {fit} | {peak} | — | — | — | "
                        f"{r['status'][:40]}… | — | — |")
            continue
        rl = r["roofline"]
        mfu = f"{rl['mfu']:.1%}" + (f" (measured {r['measured_mfu']:.1%})"
                                    if "measured_mfu" in r else "")
        rows.append(
            f"{head} {fit} | {peak} | {fmt_s(rl['compute_s'])} | "
            f"{fmt_s(rl['memory_s'])} | {fmt_s(rl['collective_s'])} | "
            f"{rl['bottleneck']} | {mfu} | {rl['useful_ratio']:.2f} |")
    return "\n".join(rows)


def dryrun_summary(recs):
    ok = [r for r in recs if r["status"] == "ok"]
    skip = [r for r in recs if r["status"] == "skipped"]
    fail = [r for r in recs if r["status"] == "FAILED"]
    meta = [r for r in recs if r["status"].startswith("not countable")]
    lines = [f"cells: {len(ok)} ok / {len(skip)} skipped / {len(meta)} not "
             f"countable on meta / {len(fail)} FAILED"]
    sized = ok + meta
    fits = sum(1 for r in sized if r["memory"]["fits_card"])
    lines.append(f"memory: {fits}/{len(sized)} sized cells fit one card's "
                 "memory per worker")
    measured = [r for r in sized if "peak_gb" in r["memory"]]
    for r in measured:
        m = r["memory"]
        lines.append(f"  measured {r['arch']} x {r['shape']} L={r['layers']}:"
                     f" argument {m['argument_gb']:.2f} GB, peak "
                     f"{m['peak_gb']:.2f} GB (temp {m['temp_gb']:.2f})")
    for r in meta:
        lines.append(f"  {r['arch']} x {r['shape']} x {r['mesh']}: "
                     f"{r['status'][:120]}")
    for r in fail:
        lines.append(f"  FAILED {r['arch']} x {r['shape']} x {r['mesh']}: "
                     f"{r.get('error', '')[:120]}")
    multi = [r for r in ok if r["mesh"] == "pod2x16x16"]
    lines.append(f"multi-pod (2x16x16): {len(multi)} cells counted -- the "
                 "'pod' axis shards the batch")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default="experiments/dryrun_torch")
    p.add_argument("--mesh", default=None,
                   help="one mesh's records only (pod16x16, pod2x16x16, "
                        "card); default: all")
    args = p.parse_args(argv)
    recs = load(args.dir)
    print("## Dry-run summary\n")
    print(dryrun_summary(recs))
    print("\n## Roofline (the whole step's count over the mesh's cards)\n")
    print(roofline_table(recs, args.mesh))


if __name__ == "__main__":
    main()
