"""The control of `correct`: the program with one stated guarantee broken.

    python3 -m rdfbench.control --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

The configuration states answers complete under RDFS entailment, which
the store keeps by holding the RDFS closure of the data (`load`
`rdfs_closure`).  The control loads the explicit triples alone (`load`
`explicit`), the store that tempts: smaller and quicker to build, and
incomplete.  Each seed runs the cell's whole harness (set-up, a window
at the cell's own size and load, the reference's comparison) so, and
prints the result line; `correct` has to come out false, and
`wrong_rows` is the control's reading.  Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from rdfbench import registry, run

BROKEN = {"load": "explicit"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    run.fixed_caches(registry.ROOT)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        res = run.run_cell(args.workload, seed, args.seconds, False,
                           t_start=time.perf_counter(), overrides=BROKEN)
        print(json.dumps({"seed": seed, "control": BROKEN, **res}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
