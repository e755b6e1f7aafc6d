"""End-to-end demo on the PyTorch port: train an LM on an RDF corpus
served through the wizard's materialized views (the counterpart of
`train_lm_on_rdf.py`).

RDFViewS tunes the storage for the data pipeline's SPARQL workload;
training batches are verbalized from the rewritten queries' answers.

    PYTHONPATH=src python examples/train_lm_on_rdf_torch.py            # quick
    PYTHONPATH=src python examples/train_lm_on_rdf_torch.py --full     # ~100M,
                                                 # a few hundred steps
    PYTHONPATH=src python examples/train_lm_on_rdf_torch.py --device cpu
(on the card unless `--device cpu` is given)
"""
import argparse
import time

import torch

import repro_torch
from repro_torch.core.search import SearchConfig
from repro_torch.core.wizard import WizardConfig, tune
from repro_torch.data.pipeline import PipelineConfig, RDFTokenPipeline
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.rdf.generator import generate, lubm_workload
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)

ap = argparse.ArgumentParser()
ap.add_argument("--full", action="store_true",
                help="~100M params, 300 steps")
ap.add_argument("--steps", type=int, default=0)
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()
dev = repro_torch.device(args.device)

if args.full:
    cfg = ModelConfig(name="rdf-lm-100m", n_layers=12, d_model=768,
                      n_heads=12, n_kv_heads=4, d_ff=3072, vocab=16384)
    steps = args.steps or 300
    seq, batch = 256, 8
else:
    cfg = ModelConfig(name="rdf-lm-10m", n_layers=4, d_model=256,
                      n_heads=8, n_kv_heads=4, d_ff=1024, vocab=4096)
    steps = args.steps or 30
    seq, batch = 128, 4

# --- storage tuning (the paper) -------------------------------------
uni = generate(n_universities=2, seed=0)
rep = tune(uni.store, lubm_workload(uni.dictionary), uni.schema, uni.type_id,
           WizardConfig(search=SearchConfig(strategy="greedy", max_states=300)),
           device=dev)
print("wizard:", rep.result.summary())

# --- data pipeline over the tuned store ------------------------------
pipe = iter(RDFTokenPipeline(rep.executor,
                             PipelineConfig(seq_len=seq, batch_size=batch,
                                            vocab=cfg.vocab)))

# --- train ------------------------------------------------------------
model = build_model(cfg, dev)
n_params = cfg.param_count()
print(f"model: {cfg.name} ({n_params/1e6:.1f}M params), "
      f"{steps} steps @ batch={batch} seq={seq} on {dev}")
tc = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=max(steps // 10, 1),
                               total_steps=steps), remat="none")
state = init_train_state(model, tc, torch.Generator(device=dev).manual_seed(0))
step_fn = make_train_step(model, tc)

t_start = time.perf_counter()
first = last = None
for i in range(1, steps + 1):
    b = {k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()}
    state, metrics = step_fn(state, b)
    loss = float(metrics["loss"])
    first = first if first is not None else loss
    last = loss
    if i % max(steps // 10, 1) == 0:
        dt = time.perf_counter() - t_start
        print(f"step {i:4d}/{steps} loss {loss:7.4f} "
              f"({batch*seq*i/dt:,.0f} tok/s)")
print(f"\nloss {first:.4f} -> {last:.4f} "
      f"({'improved' if last < first else 'NO IMPROVEMENT'})")
if not last < first:
    raise SystemExit("training must reduce loss")
