"""Batched serving demo on the PyTorch port: continuous-batching loop
over request slots (the counterpart of `serve_batched.py`).

    PYTHONPATH=src python examples/serve_batched_torch.py --arch gemma3-12b
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
(the reduced config; on the card unless `--device cpu` is given)
"""
import argparse
import time

import torch

import repro_torch
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import build_model
from repro_torch.serve.serve_step import BatchedServer, ServeConfig

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="gemma3-12b")
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--steps", type=int, default=32)
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

dev = repro_torch.device(args.device)
cfg = get_smoke_config(args.arch)
model = build_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
server = BatchedServer(model, ServeConfig(cache_len=64, temperature=0.8),
                       batch=args.batch, max_new=8)
t0 = time.perf_counter()
done = server.run(args.steps,
                  generator=torch.Generator(device=dev).manual_seed(42))
dt = time.perf_counter() - t0
tput = args.batch * args.steps / dt
print(f"arch={cfg.name} batch={args.batch} device={dev}")
print(f"{args.steps} decode steps in {dt:.2f}s -> {tput:.0f} tok/s")
print(f"completed requests: {len(done)}")
for i, seq in enumerate(done[:5]):
    print(f"  req{i}: {seq}")
