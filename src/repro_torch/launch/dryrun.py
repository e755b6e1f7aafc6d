"""Dry-run of every (architecture x input shape) cell on one NVIDIA H100:
a trace on the `meta` device, its memory and its roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun              # every cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \
        --shape train_4k                                            # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --audit      # + corrected
    PYTHONPATH=src python -m repro_torch.launch.dryrun --paper      # query_step

Twin of `repro/launch/dryrun.py`, which pins 512 host devices and
lowers and compiles each cell on the production meshes (16x16 and
2x16x16).  The port has one mesh, one card (`MESH`, "h100", chips = 1):
each cell's step is traced on `meta` tensors (`launch/flops_audit.py`),
with no allocation and no compile, so it needs no card and runs as well
on the CPU.  `--multi-pod` and `--both-meshes` exit non-zero: their
per-device programs of 256 and 512 chips need `make_production_mesh`,
shards placed on several cards with NCCL collectives and the collective
bytes between them (ROADMAP A11).  A cell is traced with `mesh=None`,
outside `axis_ctx`, even though `distributed/sharding.py` is ported.

Results are cached incrementally in artifacts/dryrun_torch/<cell>.json
(`--force` re-runs); `--art-dir` writes elsewhere.  Nothing is written
under artifacts/dryrun/, the JAX dry-run's directory.  The artifact
keeps the JAX fields: `memory` holds `argument_bytes` (the cell's
arguments), `output_bytes` (its result), `temp_bytes` (the peak of live
bytes above the arguments during the trace) and `generated_code_bytes`
(0: nothing is compiled); `lower_s` is the trace's seconds and
`compile_s` 0.  The module sets no environment variable and is imported
by tests.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.launch import flops_audit as FA
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.shapes import (SHAPES, applicable, env_cfg,
                                       make_cell, rules_for)

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")
MESH = "h100"           # the one mesh: one card
CHIPS = 1
SEVERAL_CARDS = ("meshes of several cards (the JAX dry-run's 16x16 and "
                 "2x16x16) wait for ROADMAP A11: make_production_mesh, "
                 "shards placed on several cards with NCCL collectives, "
                 "and the collective bytes between them")
PAPER_TRIPLES = 1_000_000_000
PAPER_MESH = {"data": 16, "model": 16}   # make_production_mesh()'s pod1


def _one_card(multi_pod: bool) -> None:
    if multi_pod:
        raise ValueError(SEVERAL_CARDS)


def cell_path(arch: str, shape: str, multi_pod: bool = False, tag: str = "",
              art_dir: str = ART_DIR) -> str:
    _one_card(multi_pod)
    suffix = f".{tag}" if tag else ""
    return os.path.join(art_dir, f"{arch}__{shape}__{MESH}{suffix}.json")


def _memory(args_bytes: int, counts: dict) -> dict:
    return {"argument_bytes": int(args_bytes),
            "output_bytes": int(counts["out"]),
            "temp_bytes": int(counts["temp"]),
            "generated_code_bytes": 0}


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             rules: dict | None = None) -> dict:
    """Trace the cell of `arch` at `shape` on `meta` (the whole step;
    for a sequence-affine config past `FA.SEQ_PROBE`'s lengths, two
    traces extrapolated, `flops_audit.measure`)."""
    _one_card(multi_pod)
    ok, why = applicable(arch, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "chips": CHIPS, "mesh": MESH,
                "multi_pod": False, "status": "skipped", "reason": why}
    cfg = env_cfg(get_config(arch))
    spec = SHAPES[shape]
    rules = rules or rules_for(arch, shape)
    cell = make_cell(arch, shape, rules=rules, cfg=cfg)
    args_bytes = FA.tree_bytes(cell.args)
    del cell
    counts = FA.measure(arch, shape, rules, cfg)
    mf = RL.model_flops_for(cfg, spec["kind"], spec["batch"], spec["seq"])
    roof = RL.extract(counts, CHIPS, mf)
    result = {
        "arch": arch, "shape": shape, "chips": CHIPS, "mesh": MESH,
        "multi_pod": False, "status": "ok",
        "kind": spec["kind"], "seq": spec["seq"], "batch": spec["batch"],
        "attn_impl": cfg.attn_impl,
        "lower_s": round(counts["seconds"], 2), "compile_s": 0.0,
        "memory": _memory(args_bytes, counts),
        "roofline": roof.as_dict(),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "rules": rules,
    }
    if "seq_probes" in counts:
        result["seq_probes"] = counts["seq_probes"]
    return result


# ----------------------------------------------------------------------
# the paper's own workload: distributed query_step
# ----------------------------------------------------------------------
def paper_statistics(n_triples: int):
    """The `Statistics` the paper cell is planned with (the JAX
    dry-run's): 64 predicates of equal count, 8 triples a subject and 16
    an object within each."""
    from repro_torch.rdf.triples import Statistics

    n_preds = 64
    per_pred = n_triples / n_preds
    return Statistics(
        n_triples=n_triples, n_ids=n_triples // 4,
        pred_count={p: int(per_pred) for p in range(n_preds)},
        pred_distinct_s={p: int(per_pred / 8) for p in range(n_preds)},
        pred_distinct_o={p: int(per_pred / 16) for p in range(n_preds)},
        distinct_s=n_triples // 8, distinct_o=n_triples // 16,
        distinct_p=n_preds, pred_obj_hist={},
    )


def paper_plan():
    """The 3-atom star-join rewriting: (x p1 y), (x p2 z), (z p3 w) ->
    (x, w)."""
    from repro_torch.core.queries import Atom, Const, Var
    from repro_torch.query.plan import EquiJoin, Project, TTScan

    x, y, z, w = Var("x"), Var("y"), Var("z"), Var("w")
    return Project(
        EquiJoin(
            EquiJoin(TTScan(Atom(x, Const(1), y)), TTScan(Atom(x, Const(2), z)),
                     (("x", "x"),)),
            TTScan(Atom(z, Const(3), w)),
            (("z", "z"),),
        ),
        ("x", "w"),
    )


def paper_axis():
    """The partition axes of the query engine: REPRO_QUERY_AXES
    (default "data"; "data,model" flattens the whole mesh into the
    hash-partition space), as the JAX dry-run reads it."""
    axes_env = os.environ.get("REPRO_QUERY_AXES", "data")
    return tuple(axes_env.split(",")) if "," in axes_env else axes_env


def paper_program(n_triples: int, device: torch.device):
    """(fn, ndev, per_dev): the distributed program of `paper_plan` over
    a `PAPER_MESH` mesh on `device`, its shard count and its TT rows a
    shard (multiples of 1024 with 5 % headroom, as the JAX dry-run
    pads)."""
    from repro_torch.query import distributed as D

    mesh = Mesh(dict(PAPER_MESH), device)
    axis = paper_axis()
    names = axis if isinstance(axis, tuple) else (axis,)
    ndev = int(np.prod([mesh.shape[a] for a in names]))
    fn = D.build_distributed_executor(paper_plan(), paper_statistics(n_triples),
                                      {}, mesh, axis=axis, safety=2.0)
    per_dev = int(-(-n_triples / ndev * 1.05 // 1024) * 1024)
    return fn, ndev, per_dev


def paper_triples(n_triples: int, seed: int = 0) -> np.ndarray:
    """`n_triples` (a multiple of 1,024) `(s, p, o)` int32 triples drawn
    from `seed` to fit `paper_statistics`: 64 predicates of n/64 triples;
    within each, subjects uniform over n/512 ids and objects over n/1024
    (8 triples a subject, 16 an object)."""
    rng = np.random.default_rng(seed)
    per = n_triples // 64
    return np.stack([rng.integers(0, per // 8, n_triples, dtype=np.int32),
                     np.repeat(np.arange(64, dtype=np.int32), per),
                     rng.integers(0, per // 16, n_triples, dtype=np.int32)],
                    axis=1)


def paper_reference(triples: np.ndarray) -> np.ndarray:
    """The answer of `paper_plan` over `triples` in numpy, as sorted
    unique `(x, w)` rows: x a subject of predicate 1, (x 2 z) and
    (z 3 w)."""
    by_p = {p: triples[triples[:, 1] == p] for p in (1, 2, 3)}
    xz = by_p[2][np.isin(by_p[2][:, 0], by_p[1][:, 0])][:, [0, 2]]
    p3 = by_p[3][np.argsort(by_p[3][:, 0], kind="stable")]
    lo = np.searchsorted(p3[:, 0], xz[:, 1], side="left")
    n = np.searchsorted(p3[:, 0], xz[:, 1], side="right") - lo
    first = np.repeat(lo - (np.cumsum(n) - n), n)
    w = p3[first + np.arange(int(n.sum())), 2]
    rows = np.stack([np.repeat(xz[:, 0], n), w], axis=1)
    return np.unique(rows, axis=0).astype(np.int32)


def run_paper_cell(multi_pod: bool = False,
                   n_triples: int = PAPER_TRIPLES) -> dict:
    """Trace the distributed evaluation of the 3-atom star-join rewriting
    over a `n_triples` TT, hash-sharded by subject over the data axis of
    a 16x16 mesh whose 16 data shards the port stacks on one card
    (`query/distributed.py`): TT indexes of `(ndev, per_dev, 3)` int32
    on `meta`, the joins' probes through `join_count`'s shape rule."""
    _one_card(multi_pod)
    from repro_torch.query import engine as QE

    t0 = time.perf_counter()
    fn, ndev, per_dev = paper_program(n_triples, torch.device("meta"))
    tt = {k: torch.empty((ndev, per_dev, 3), dtype=torch.int32,
                         device="meta") for k in QE.INDEX_NAMES}
    counts = FA.count(fn, tt, {})
    roof = RL.extract(counts, CHIPS, model_flops=0.0)
    return {
        "arch": "rdfviews-query-step", "shape": f"star3_{n_triples}",
        "chips": CHIPS, "mesh": MESH, "multi_pod": False, "status": "ok",
        "kind": "query", "lower_s": round(time.perf_counter() - t0, 2),
        "compile_s": 0.0,
        "memory": _memory(FA.tree_bytes(tt), counts),
        "roofline": roof.as_dict(),
        "shards": ndev, "rows_per_shard": per_dev,
        "mesh_shape": dict(PAPER_MESH),
        "exchanges": fn.exchanges, "elided": fn.elided,
    }


def run_audit(arch: str, shape: str, multi_pod: bool = False, tag: str = "",
              art_dir: str = ART_DIR, force: bool = False) -> dict:
    """Attach the per-group corrected roofline to the cell's artifact,
    running the cell first when its artifact is absent (or `force`).
    Returns the artifact."""
    path = cell_path(arch, shape, multi_pod, tag, art_dir)
    res = None
    if os.path.exists(path) and not force:
        with open(path) as f:
            res = json.load(f)
    if res is None:
        res = run_cell(arch, shape)
    if res.get("status") == "ok" and (force or "roofline_corrected" not in res):
        t0 = time.perf_counter()
        c = FA.corrected_costs(arch, shape)
        roof = RL.Roofline(flops=c["flops"], hbm_bytes=c["bytes"],
                           collective_bytes=c["coll"], chips=res["chips"],
                           model_flops=res["roofline"]["model_flops"])
        res["roofline_corrected"] = roof.as_dict()
        res["audit_detail"] = {k: c[k] for k in ("stem", "per_group",
                                                 "loop_correction")}
        res["audit_s"] = round(time.perf_counter() - t0, 2)
    os.makedirs(art_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return res


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one architecture id")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="refused: one card")
    ap.add_argument("--both-meshes", action="store_true",
                    help="refused: one card")
    ap.add_argument("--paper", action="store_true",
                    help="trace the paper's distributed query_step")
    ap.add_argument("--audit", action="store_true",
                    help="add the per-group corrected roofline to artifacts")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="result filename suffix")
    ap.add_argument("--art-dir", default=ART_DIR,
                    help="artifact directory (default artifacts/dryrun_torch)")
    args = ap.parse_args(argv)
    if args.multi_pod or args.both_meshes:
        ap.exit(2, f"dryrun: --multi-pod / --both-meshes refused: "
                   f"{SEVERAL_CARDS}\n")

    os.makedirs(args.art_dir, exist_ok=True)
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)

    if args.audit:
        failures = []
        for arch in archs:
            for shape in shapes:
                try:
                    res = run_audit(arch, shape, tag=args.tag,
                                    art_dir=args.art_dir, force=args.force)
                    if res["status"] != "ok":
                        print(f"SKIP  {arch} {shape} {MESH}")
                        continue
                    r = res["roofline_corrected"]
                    print(f"AUDIT {arch} {shape} {MESH}: "
                          f"bottleneck={r['bottleneck']} "
                          f"frac={r['roofline_fraction']:.3f} "
                          f"useful={r['useful_flops_ratio']:.2f}")
                except Exception as e:  # noqa: BLE001 - report and continue
                    failures.append(f"{arch} {shape}")
                    print(f"AUDIT-FAIL {arch} {shape}: {e}")
                    traceback.print_exc()
        if failures:
            raise SystemExit(f"{len(failures)} FAILURES: {failures}")
        return

    if args.paper:
        path = cell_path("rdfviews-query-step", "star3", tag=args.tag,
                         art_dir=args.art_dir)
        if os.path.exists(path) and not args.force:
            print(f"cached {path}")
            return
        res = run_paper_cell()
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        print(f"PAPER {MESH} trace={res['lower_s']}s "
              f"bottleneck={res['roofline']['bottleneck']}")
        return

    failures = []
    for arch in archs:
        for shape in shapes:
            path = cell_path(arch, shape, tag=args.tag, art_dir=args.art_dir)
            if os.path.exists(path) and not args.force:
                print(f"cached {arch} {shape} {MESH}")
                continue
            label = f"{arch} {shape} {MESH}"
            try:
                res = run_cell(arch, shape)
            except Exception as e:  # noqa: BLE001 - report and continue
                failures.append(label)
                print(f"FAIL  {label}: {e}")
                traceback.print_exc()
                continue
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            if res["status"] == "skipped":
                print(f"SKIP  {label}: {res['reason'][:60]}")
            else:
                r = res["roofline"]
                print(f"OK    {label}: trace={res['lower_s']}s "
                      f"bottleneck={r['bottleneck']} "
                      f"frac={r['roofline_fraction']:.3f}")
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print("\nall cells complete")


if __name__ == "__main__":
    main()
