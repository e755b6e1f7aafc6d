"""Render the dry-run artifacts (`launch/dryrun.py`) into markdown tables.

    PYTHONPATH=src python -m repro_torch.launch.report             # markdown
    PYTHONPATH=src python -m repro_torch.launch.report --pick      # hillclimb picks

Twin of `repro/launch/report.py`, reading artifacts/dryrun_torch/; each
row's mesh is the artifact's own label: "pod1" (data 16, model 16) and
"pod2" (pod 2, data 16, model 16), per device, and "h100" (one card).
One dry-run table and one roofline table a mesh.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "artifacts", "dryrun_torch")


def load_all(tag: str = "", art: str = ART) -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(art, "*.json"))):
        base = os.path.basename(path)
        parts = base[:-5].split("__")
        if tag and not base.endswith(f".{tag}.json"):
            continue
        if not tag and len(parts[-1].split(".")) > 1:
            continue
        with open(path) as f:
            d = json.load(f)
        d["_file"] = base
        out.append(d)
    return out


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}µs"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


MESH_ORDER = ("pod1", "pod2", "h100")


def mesh_of(d: dict) -> str:
    return d.get("mesh", "?")


def meshes_in(cells: list[dict]) -> list[str]:
    """The mesh labels of `cells`: pod1, pod2, h100, then any other."""
    found = {mesh_of(d) for d in cells}
    return [m for m in MESH_ORDER if m in found] + sorted(
        found - set(MESH_ORDER))


def dryrun_table(cells: list[dict], mesh: str | None = None) -> str:
    """Rows of the cells on `mesh` (every mesh when None)."""
    rows = ["| arch | shape | mesh | status | trace | bytes/dev (args+tmp) | collective ops |",
            "|---|---|---|---|---|---|---|"]
    for d in cells:
        if mesh is not None and mesh_of(d) != mesh:
            continue
        mesh_d = mesh_of(d)
        if d.get("status") == "skipped":
            rows.append(f"| {d['arch']} | {d['shape']} | {mesh_d} | skipped"
                        f" | — | — | — |")
            continue
        mem = d.get("memory", {})
        gb = (mem.get("argument_bytes", 0) + mem.get("temp_bytes", 0)) / 2**30
        det = d.get("roofline", {}).get("collective_detail", {})
        ops = ",".join(f"{k}:{v}" for k, v in
                       sorted(det.get("count", {}).items()))
        rows.append(
            f"| {d['arch']} | {d['shape']} | {mesh_d} | ok | "
            f"{d.get('lower_s', 0):.1f}s | {gb:.2f} GiB | {ops or '—'} |")
    return "\n".join(rows)


def roofline_table(cells: list[dict], mesh: str | None = None) -> str:
    """Rows of the cells on `mesh` (every mesh when None), the corrected
    terms where the audit added them."""
    rows = ["| arch | shape | mesh | t_comp | t_mem | t_coll | bound | useful | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    for d in cells:
        if (mesh is not None and mesh_of(d) != mesh) or d.get("status") != "ok":
            continue
        r = d.get("roofline_corrected") or d.get("roofline", {})
        if not r:
            continue
        rows.append(
            f"| {d['arch']} | {d['shape']} | {mesh_of(d)} | "
            f"{fmt_s(r['t_compute_s'])} | "
            f"{fmt_s(r['t_memory_s'])} | {fmt_s(r['t_collective_s'])} | "
            f"{r['bottleneck']} | {r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} |")
    return "\n".join(rows)


def picks(cells: list[dict]) -> dict:
    """The three hillclimb cells: worst fraction, most collective-bound,
    paper-representative (the query_step is always the third)."""
    ok = [d for d in cells if d.get("status") == "ok"
          and d.get("kind") != "query"]

    def rc(d):
        return d.get("roofline_corrected") or d["roofline"]

    # worst fraction among heavyweight cells (train/prefill carry the flops)
    heavy = [d for d in ok if d["kind"] in ("train", "prefill")]
    worst = min(heavy, key=lambda d: rc(d)["roofline_fraction"])
    coll = max(ok, key=lambda d: (rc(d)["t_collective_s"] /
                                  max(max(rc(d)["t_compute_s"],
                                          rc(d)["t_memory_s"]), 1e-12)))
    return {
        "worst_fraction": (worst["arch"], worst["shape"],
                           rc(worst)["roofline_fraction"]),
        "most_collective": (coll["arch"], coll["shape"],
                            rc(coll)["t_collective_s"] /
                            max(rc(coll)["t_compute_s"], 1e-12)),
        "paper": ("rdfviews-query-step", "star3_1000000000", None),
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pick", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--art-dir", default=ART)
    args = ap.parse_args(argv)
    cells = load_all(args.tag, args.art_dir)
    if args.pick:
        print(json.dumps(picks(cells), indent=1))
        return
    meshes = meshes_in(cells)
    if not meshes:
        print("## Dry-run (no artifacts)")
    for mesh in meshes:
        chips = {d.get("chips") for d in cells if mesh_of(d) == mesh}
        print(f"## Dry-run ({mesh}, {'/'.join(map(str, sorted(chips)))} "
              f"chips, per device)\n")
        print(dryrun_table(cells, mesh))
        print(f"\n## Roofline ({mesh}, per-group corrected)\n")
        print(roofline_table(cells, mesh))
        print()


if __name__ == "__main__":
    main()
