"""Quickstart on the PyTorch port: tune, answer, serve, save and load.

    PYTHONPATH=src python examples/quickstart_torch.py              # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The session lifecycle of `examples/quickstart.py` on `repro_torch`:
generate -> retune -> apply -> answer -> serve (a streaming server under
a staleness budget, then the async frontend) -> save -> load.  The
session runs on the CUDA card unless `--device cpu` is given; without a
card and without that flag it stops with an error rather than move to
the CPU.
"""
import argparse
import tempfile
import time

import numpy as np

from repro_torch.api import (FrontendConfig, MaintenanceConfig,
                             QualityWeights, QueryClass, SearchConfig,
                             TuningSession, WizardConfig)
from repro_torch.rdf.generator import generate, lubm_workload
from repro_torch.serve.frontend import FixedServiceModel

parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
parser.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
parser.add_argument("--universities", type=int, default=2)
args = parser.parse_args()

# 1) an RDF universe: LUBM-style instance data + RDFS schema
uni = generate(n_universities=args.universities, seed=0)
workload = lubm_workload(uni.dictionary)
print(f"triple table: {len(uni.store):,} triples, "
      f"workload: {len(workload)} weighted conjunctive queries")

# 2) a tuning session on the device: reformulation, then the search
cfg = WizardConfig(
    search=SearchConfig(strategy="greedy", max_states=500,
                        weights=QualityWeights(w_exec=1.0, w_maint=0.1,
                                               w_space=0.01)))
session = TuningSession(uni.store, workload, schema=uni.schema, cfg=cfg,
                        device=args.device)
t0 = time.perf_counter()
report = session.retune()
swap = session.apply()
print(f"\nwizard finished in {time.perf_counter() - t0:.2f}s on "
      f"{session.device}")
print(report.summary())
print(swap.summary())

# 3) answers from the materialized views against direct evaluation
print("\nanswers (views vs direct):")
for q in workload:
    t0 = time.perf_counter()
    via_views = session.answer(q.name)
    t_views = time.perf_counter() - t0
    assert via_views == session.executor.answer_group_direct(q.name)
    print(f"  {q.name}: {len(via_views):5d} answers in "
          f"{t_views * 1e3:7.2f} ms")

# 4) serve a streaming store: writes are maintained incrementally, and
# answers are never more than `staleness_budget` pending triples stale
rng = np.random.default_rng(7)
tt = session.store.triples
server = session.serve(maintenance=MaintenanceConfig(staleness_budget=64))
names = [q.name for q in workload]
for _ in range(4):
    rows = tt[rng.choice(len(tt), 32)].copy()
    rows[:, 2] = rows[::-1, 2]          # recombine: mostly-novel triples
    server.submit(inserts=rows)
    server.answer_batch(names)
server.flush()
st = server.stats
print(f"\nstreamed {st.updates_submitted} triples in {st.refreshes} "
      f"maintenance passes, served at most {st.max_staleness_served} "
      f"triples stale; health {st.health}")
for name, got in zip(names, server.answer_batch(names)):
    assert got == session.executor.answer_group_direct(name)
print("views stayed exact under the write stream")

# 5) the async frontend: micro-batches and per-class SLOs on a virtual
# clock (a fixed service model keeps this run deterministic)
fe = session.serve_async(
    classes=[QueryClass("gold", priority=1, slo=0.05),
             QueryClass("bulk")],
    frontend=FrontendConfig(queue_cap=16, batching_window=0.005,
                            max_batch=8),
    service_model=FixedServiceModel(0.002, 0.0005))
for i, name in enumerate(names * 3):
    fe.offer(name, "gold" if i % 3 == 0 else "bulk", t=i * 0.002)
fe.flush()
print(f"\nfrontend: {fe.stats.completed} of {fe.stats.offered} requests in "
      f"{fe.stats.batches} batches, shed {fe.stats.shed}; gold p99 "
      f"{fe.stats.latency['gold'].percentile(99) * 1e3:.1f} ms (virtual)")

# 6) persist and resume: the layout the JAX package also reads
with tempfile.TemporaryDirectory() as d:
    path = session.save(d)
    loaded = TuningSession.load(d, device=args.device)
    loaded.apply()
    for name in names:
        assert loaded.answer(name) == session.answer(name)
    print(f"\nsaved to {path} and loaded on {loaded.device}: "
          f"{len(names)} queries answered as before")
