"""Dry-run of every (architecture x input shape) cell on the production
meshes, as one device's program, and on one NVIDIA H100: a trace on the
`meta` device, its memory and its roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun              # pod1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \
        --shape train_4k --multi-pod                                # pod2
    PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes --audit
    PYTHONPATH=src python -m repro_torch.launch.dryrun --paper      # query_step
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh h100  # one card

Twin of `repro/launch/dryrun.py`, which pins 512 host devices and
lowers and compiles each cell for `make_production_mesh()`: (data 16,
model 16), "pod1", or with `--multi-pod` (pod 2, data 16, model 16),
"pod2"; `--both-meshes` runs both.  The port traces the per-device
program instead: rank 0 of a fake process group of 256 or 512 ranks
(`launch.mesh.per_device`) runs the cell's step on meta DTensors of its
own shards, and `launch/flops_audit.py` counts its local ops and the
collectives it issues.  `--mesh h100` keeps the one-card cells (chips =
1, the whole program on one card, no collective); the JAX CLI has no
such mesh.  The Python API's default mesh is "h100" (`multi_pod=True`
is pod2; `mesh=` names any of the three).  Nothing needs a card, and
everything runs as well on the CPU.

Results are cached incrementally in
artifacts/dryrun_torch/<arch>__<shape>__<pod1|pod2|h100>[.tag].json
(`--force` re-runs); `--art-dir` writes elsewhere.  Nothing is written
under artifacts/dryrun/, the JAX dry-run's directory.  The artifact
keeps the JAX fields, per device: `memory` holds `argument_bytes` (on a
production mesh the argument shards the program reads, as JAX's jit
drops the others, and a decode cell's position, a host int here and a
4-byte argument in JAX; on one card every argument), `output_bytes`
(its result), `temp_bytes` (the peak of live bytes above the arguments
during the trace) and `generated_code_bytes` (0: nothing is compiled);
`chips` and `mesh_shape` the mesh's; `lower_s` is the trace's seconds
and `compile_s` 0.  The module sets no environment variable and is
imported by tests.
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
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.shapes import (SHAPES, applicable, env_cfg,
                                       make_cell, rules_for)

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")
MESHES = ("pod1", "pod2", "h100")   # the production meshes, one card
POSITION_BYTES = 4      # a decode cell's position: JAX's 0-d int32
PAPER_TRIPLES = 1_000_000_000
PAPER_MESH = dict(make_production_mesh(device="cpu").shape)   # pod1's


def mesh_label(multi_pod: bool = False, mesh: str | None = None) -> str:
    """The mesh a call names: `mesh` if given, else "pod2" for
    `multi_pod`, else "h100" (the Python API's default)."""
    label = mesh or ("pod2" if multi_pod else "h100")
    if label not in MESHES:
        raise ValueError(f"mesh {label!r} is none of {MESHES}")
    return label


def production(label: str) -> Mesh | None:
    """The production mesh of `label` (its fake group's `DeviceMesh`
    lives on the CPU; the cells' tensors are on `meta`), None for one
    card."""
    if label == "h100":
        return None
    return make_production_mesh(multi_pod=label == "pod2", device="cpu")


def cell_path(arch: str, shape: str, multi_pod: bool = False, tag: str = "",
              art_dir: str = ART_DIR, mesh: str | None = None) -> str:
    suffix = f".{tag}" if tag else ""
    label = mesh_label(multi_pod, mesh)
    return os.path.join(art_dir, f"{arch}__{shape}__{label}{suffix}.json")


def _header(label: str, pm: Mesh | None) -> dict:
    head = {"chips": FA.chips_of(pm), "mesh": label,
            "multi_pod": label == "pod2"}
    if pm is not None:
        head["mesh_shape"] = dict(pm.shape)
    return head


def _memory(args_bytes: int, counts: dict) -> dict:
    return {"argument_bytes": int(args_bytes),
            "output_bytes": int(counts["out"]),
            "temp_bytes": int(counts["temp"]),
            "generated_code_bytes": 0}


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             rules: dict | None = None, mesh: str | None = None) -> dict:
    """Trace the cell of `arch` at `shape` on `meta` (the whole step;
    for a sequence-affine config past `FA.SEQ_PROBE`'s lengths, two
    traces extrapolated, `flops_audit.measure`): on one card, or as rank
    0's program of a production mesh."""
    label = mesh_label(multi_pod, mesh)
    pm = production(label)
    head = {"arch": arch, "shape": shape, **_header(label, pm)}
    ok, why = applicable(arch, shape)
    if not ok:
        return {**head, "status": "skipped", "reason": why}
    cfg = env_cfg(get_config(arch))
    spec = SHAPES[shape]
    rules = rules or rules_for(arch, shape)
    with FA.on(pm):
        if pm is None:
            cell = make_cell(arch, shape, rules=rules, cfg=cfg)
            args_bytes = FA.tree_bytes(cell.args)
            del cell
        counts = FA.measure(arch, shape, rules, cfg, pm)
    if pm is not None:
        args_bytes = counts["args_read"] + (
            POSITION_BYTES if spec["kind"] == "decode" else 0)
    mf = RL.model_flops_for(cfg, spec["kind"], spec["batch"], spec["seq"])
    roof = RL.extract(counts, head["chips"], mf)
    result = {
        **head, "status": "ok",
        "kind": spec["kind"], "seq": spec["seq"], "batch": spec["batch"],
        "attn_impl": cfg.attn_impl,
        "lower_s": round(counts["seconds"], 2), "compile_s": 0.0,
        "memory": _memory(args_bytes, counts),
        "roofline": roof.as_dict(),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "rules": rules,
        "kernels": FA.kernel_summary(counts),
    }
    if pm is not None:
        result["uneven_view_gathers"] = {
            "calls": counts["view_gathers"],
            "bytes": counts["view_gather_bytes"]}
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


def paper_program(n_triples: int, device: torch.device, mesh=None):
    """(fn, ndev, per_dev): the distributed program of `paper_plan` over
    the `PAPER_MESH` shards stacked on `device`, or, given a production
    mesh inside its `per_device` context, one device's program of it;
    its shard count and its TT rows a shard (multiples of 1024 with 5 %
    headroom, as the JAX dry-run pads)."""
    from repro_torch.query import distributed as D

    mesh = mesh if mesh is not None else Mesh(dict(PAPER_MESH), device)
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
                   n_triples: int = PAPER_TRIPLES,
                   mesh: str | None = None) -> dict:
    """Trace the distributed evaluation of the 3-atom star-join rewriting
    over a `n_triples` TT hash-sharded by subject over the data axis.
    On one card ("h100") the 16 data shards of `PAPER_MESH` are stacked
    (`query/distributed.py`): TT indexes of `(ndev, per_dev, 3)` int32 on
    `meta`.  On a production mesh it is rank 0's program, its TT shards
    `(per_dev, 3)` on `meta`, its exchange an `all_to_all_single` and
    its overflow an `all_reduce`; argument bytes count the indexes it
    reads.  The joins' probes go through `join_count`'s shape rule."""
    from repro_torch.query import engine as QE

    label = mesh_label(multi_pod, mesh)
    pm = production(label)
    t0 = time.perf_counter()
    with FA.on(pm):
        fn, ndev, per_dev = paper_program(n_triples, torch.device("meta"), pm)
        shard = (per_dev, 3) if pm is not None else (ndev, per_dev, 3)
        tt = {k: torch.empty(shard, dtype=torch.int32, device="meta")
              for k in QE.INDEX_NAMES}
        counts = FA.count(fn, tt, {})
    head = _header(label, pm)
    roof = RL.extract(counts, head["chips"], model_flops=0.0)
    args_bytes = counts["args_read"] if pm is not None else FA.tree_bytes(tt)
    return {
        "arch": "rdfviews-query-step", "shape": f"star3_{n_triples}",
        **head, "status": "ok",
        "kind": "query", "lower_s": round(time.perf_counter() - t0, 2),
        "compile_s": 0.0,
        "memory": _memory(args_bytes, counts),
        "roofline": roof.as_dict(),
        "shards": ndev, "rows_per_shard": per_dev,
        "mesh_shape": head.get("mesh_shape", dict(PAPER_MESH)),
        "exchanges": fn.exchanges, "elided": fn.elided,
        "kernels": FA.kernel_summary(counts),
    }


def run_audit(arch: str, shape: str, multi_pod: bool = False, tag: str = "",
              art_dir: str = ART_DIR, force: bool = False,
              mesh: str | None = None) -> dict:
    """Attach the per-group corrected roofline to the cell's artifact,
    running the cell first when its artifact is absent (or `force`).
    Returns the artifact."""
    label = mesh_label(multi_pod, mesh)
    path = cell_path(arch, shape, tag=tag, art_dir=art_dir, mesh=label)
    res = None
    if os.path.exists(path) and not force:
        with open(path) as f:
            res = json.load(f)
    if res is None:
        res = run_cell(arch, shape, mesh=label)
    if res.get("status") == "ok" and (force or "roofline_corrected" not in res):
        t0 = time.perf_counter()
        c = FA.corrected_costs(arch, shape, production(label))
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


def meshes_of(args) -> list[str]:
    """The meshes the flags name, as JAX's CLI reads them: pod1 with no
    flag, pod2 with --multi-pod, both with --both-meshes; --mesh names
    one (h100 the one card)."""
    if args.mesh:
        return [args.mesh]
    if args.both_meshes:
        return ["pod1", "pod2"]
    return ["pod2" if args.multi_pod else "pod1"]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one architecture id")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (pod 2, data 16, model 16) mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="pod1 and pod2")
    ap.add_argument("--mesh", default=None, choices=list(MESHES),
                    help="one mesh by name (h100: one card)")
    ap.add_argument("--paper", action="store_true",
                    help="trace the paper's distributed query_step")
    ap.add_argument("--audit", action="store_true",
                    help="add the per-group corrected roofline to artifacts")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="result filename suffix")
    ap.add_argument("--art-dir", default=ART_DIR,
                    help="artifact directory (default artifacts/dryrun_torch)")
    args = ap.parse_args(argv)
    if args.mesh and (args.multi_pod or args.both_meshes):
        ap.error("--mesh names one mesh: leave out --multi-pod and "
                 "--both-meshes")

    os.makedirs(args.art_dir, exist_ok=True)
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = meshes_of(args)

    if args.audit:
        failures = []
        for label in meshes:
            for arch in archs:
                for shape in shapes:
                    try:
                        res = run_audit(arch, shape, tag=args.tag,
                                        art_dir=args.art_dir,
                                        force=args.force, mesh=label)
                        if res["status"] != "ok":
                            print(f"SKIP  {arch} {shape} {label}")
                            continue
                        r = res["roofline_corrected"]
                        print(f"AUDIT {arch} {shape} {label}: "
                              f"bottleneck={r['bottleneck']} "
                              f"frac={r['roofline_fraction']:.3f} "
                              f"useful={r['useful_flops_ratio']:.2f} "
                              f"coll={r['collective_bytes_per_device']:.6g}")
                    except Exception as e:  # noqa: BLE001 - report, go on
                        failures.append(f"{arch} {shape} {label}")
                        print(f"FAIL  {arch} {shape} {label}: {e}")
                        traceback.print_exc()
        if failures:
            print(f"\n{len(failures)} FAILURES: {failures}")
            raise SystemExit(1)
        return

    if args.paper:
        for label in meshes:
            path = cell_path("rdfviews-query-step", "star3", tag=args.tag,
                             art_dir=args.art_dir, mesh=label)
            if os.path.exists(path) and not args.force:
                print(f"cached {path}")
                continue
            res = run_paper_cell(mesh=label)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            print(f"PAPER {label} trace={res['lower_s']}s "
                  f"bottleneck={res['roofline']['bottleneck']}")
        return

    failures = []
    for label in meshes:
        for arch in archs:
            for shape in shapes:
                path = cell_path(arch, shape, tag=args.tag,
                                 art_dir=args.art_dir, mesh=label)
                if os.path.exists(path) and not args.force:
                    print(f"cached {arch} {shape} {label}")
                    continue
                text = f"{arch} {shape} {label}"
                try:
                    res = run_cell(arch, shape, mesh=label)
                except Exception as e:  # noqa: BLE001 - report and continue
                    failures.append(text)
                    print(f"FAIL  {text}: {e}")
                    traceback.print_exc()
                    continue
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                if res["status"] == "skipped":
                    print(f"SKIP  {text}: {res['reason'][:60]}")
                else:
                    r = res["roofline"]
                    print(f"OK    {text}: trace={res['lower_s']}s "
                          f"bottleneck={r['bottleneck']} "
                          f"frac={r['roofline_fraction']:.3f}")
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print("\nall cells complete")


if __name__ == "__main__":
    main()
