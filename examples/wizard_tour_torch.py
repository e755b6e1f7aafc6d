"""The demo scenario of §4, headless: play the DBA.

Walks the attendee flow: pick a dataset, tune with different strategies,
adjust the quality-function weights, inspect the search, then issue
queries against TT vs views.  The tour of `examples/wizard_tour.py` on
`repro_torch`, on the card unless `--device cpu` is given:

    PYTHONPATH=src python examples/wizard_tour_torch.py
    PYTHONPATH=src python examples/wizard_tour_torch.py --device cpu
"""
import argparse
import time

from repro_torch.core.quality import QualityWeights, quality
from repro_torch.core.search import SearchConfig, search
from repro_torch.core.state import initial_state
from repro_torch.core.wizard import WizardConfig, tune
from repro_torch.rdf.generator import generate, lubm_workload

parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
parser.add_argument("--device", default=None, help="cuda (default) or cpu")
args = parser.parse_args()

print("=" * 66)
print("RDFViewS storage tuning wizard — demo tour")
print("=" * 66)

# --- choose a dataset (the demo pre-loads LUBM et al.) ---------------
uni = generate(n_universities=1, seed=0, dept_per_univ=2)
workload = lubm_workload(uni.dictionary)
stats = uni.store.stats
print(f"\n[dataset] LUBM-style: {len(uni.store):,} triples, "
      f"{stats.distinct_p} predicates")
print(f"[workload] {len(workload)} conjunctive queries, weights "
      f"{[q.weight for q in workload]}")

# --- quick search vs optimal search (the demo's main knob) ----------
st0 = initial_state(workload)
print(f"\n[initial state] {len(st0.views)} views "
      f"(= materialize the workload; best exec, worst space)")
for strat in ["greedy", "beam", "best_first"]:
    t0 = time.perf_counter()
    res = search(st0, stats, SearchConfig(strategy=strat, max_states=800,
                                          max_seconds=20))
    print(f"  {strat:12s}: {res.summary()}")

# --- steer with the quality weights ----------------------------------
print("\n[weights] space-hungry vs space-frugal configurations:")
for name, w in [("exec-heavy", QualityWeights(1.0, 0.0, 1e-6)),
                ("balanced", QualityWeights(1.0, 0.1, 0.01)),
                ("space-heavy", QualityWeights(1e-6, 0.0, 1.0))]:
    res = search(st0, stats, SearchConfig(strategy="greedy", max_states=500,
                                          weights=w))
    q = res.best_quality
    print(f"  {name:12s}: views={len(res.best.views)} "
          f"exec={q.exec_cost:10.0f} space={q.space_bytes:9.0f}B")

# --- full pipeline with RDFS + verification ---------------------------
print("\n[full tune] greedy + RDFS reformulation:")
rep = tune(uni.store, workload, uni.schema, uni.type_id,
           WizardConfig(search=SearchConfig(strategy="greedy",
                                            max_states=500)),
           device=args.device)
print(rep.summary())
print("\n[verify] answers from views == direct evaluation:")
for q in workload:
    got = rep.executor.answer_group(q.name)
    want = rep.executor.answer_group_direct(q.name)
    print(f"  {q.name}: {len(got)} answers {'ok' if got == want else 'FAIL'}")
print("\ntour complete.")
