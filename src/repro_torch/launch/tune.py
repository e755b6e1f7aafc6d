"""The storage tuning wizard CLI (the demo's GUI, headless).

The counterpart of `repro/launch/tune.py`, on the card unless
`--device cpu` is given:

    PYTHONPATH=src python -m repro_torch.launch.tune --universities 2 \
        --strategy greedy --w-exec 1 --w-maint 0.1 --w-space 0.01 --verify
"""
from __future__ import annotations

import argparse

from repro_torch.core.quality import QualityWeights
from repro_torch.core.search import SearchConfig
from repro_torch.core.wizard import WizardConfig, tune
from repro_torch.rdf.generator import generate, lubm_workload


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--universities", type=int, default=1)
    ap.add_argument("--strategy", default="greedy",
                    choices=["exhaustive_dfs", "best_first", "greedy", "beam",
                             "anneal"])
    ap.add_argument("--max-states", type=int, default=1000)
    ap.add_argument("--max-seconds", type=float, default=30.0)
    ap.add_argument("--w-exec", type=float, default=1.0)
    ap.add_argument("--w-maint", type=float, default=0.1)
    ap.add_argument("--w-space", type=float, default=0.01)
    ap.add_argument("--no-schema", action="store_true")
    ap.add_argument("--verify", action="store_true",
                    help="check view answers == direct evaluation")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    uni = generate(n_universities=args.universities, seed=0)
    workload = lubm_workload(uni.dictionary)
    cfg = WizardConfig(
        search=SearchConfig(
            strategy=args.strategy, max_states=args.max_states,
            max_seconds=args.max_seconds,
            weights=QualityWeights(w_exec=args.w_exec, w_maint=args.w_maint,
                                   w_space=args.w_space)),
        use_schema=not args.no_schema,
    )
    print(f"TT: {len(uni.store)} triples; workload: {len(workload)} queries")
    rep = tune(uni.store, workload, uni.schema, uni.type_id, cfg,
               device=args.device)
    print(rep.summary())

    if args.verify:
        ok = True
        for q in workload:
            got = rep.executor.answer_group(q.name)
            want = rep.executor.answer_group_direct(q.name)
            status = "ok" if got == want else "MISMATCH"
            ok &= got == want
            print(f"  {q.name}: {len(got)} answers [{status}]")
        print("verification:", "PASSED" if ok else "FAILED")


if __name__ == "__main__":
    main()
