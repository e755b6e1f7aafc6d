"""Training launcher.

The counterpart of `repro/launch/train.py`, on the card unless
`--device cpu` is given:

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
        --smoke --steps 20 --batch 4 --seq 64 --data rdf --ckpt /tmp/ck

One process on one device.  Fault tolerance: periodic checkpoints +
resume (in the JAX package's layout: either launcher resumes the
other's), straggler watermarks per step.
"""
from __future__ import annotations

import argparse
import time

import torch

import repro_torch
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import PipelineConfig, SyntheticPipeline
from repro_torch.distributed.fault import StragglerMonitor, TrainSupervisor
from repro_torch.models.model import build_model
from repro_torch.models.params import tree_leaves
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)


def build_pipeline(args, cfg):
    if args.data == "rdf":
        from repro_torch.core.search import SearchConfig
        from repro_torch.core.wizard import WizardConfig, tune
        from repro_torch.data.pipeline import RDFTokenPipeline
        from repro_torch.rdf.generator import generate, lubm_workload

        uni = generate(n_universities=args.universities, seed=0)
        rep = tune(uni.store, lubm_workload(uni.dictionary), uni.schema,
                   uni.type_id,
                   WizardConfig(search=SearchConfig(strategy="greedy",
                                                    max_states=200)),
                   device=args.device)
        print("wizard:", rep.result.summary())
        return RDFTokenPipeline(
            rep.executor, PipelineConfig(seq_len=args.seq,
                                         batch_size=args.batch,
                                         vocab=cfg.vocab))
    return SyntheticPipeline(PipelineConfig(seq_len=args.seq,
                                            batch_size=args.batch,
                                            vocab=cfg.vocab))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--data", choices=["rdf", "synthetic"], default="synthetic")
    ap.add_argument("--universities", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = repro_torch.device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.ssm is not None and args.seq % cfg.ssm.chunk != 0:
        args.seq = max(cfg.ssm.chunk, (args.seq // cfg.ssm.chunk) * cfg.ssm.chunk)
    model = build_model(cfg, dev)
    tc = TrainConfig(opt=OptConfig(lr=args.lr, total_steps=args.steps,
                                   warmup_steps=max(args.steps // 20, 1)),
                     remat="none" if args.smoke else "full",
                     accum_steps=args.accum)
    step_fn = make_train_step(model, tc)
    pipe = iter(build_pipeline(args, cfg))

    def init():
        return init_train_state(model, tc,
                                torch.Generator(device=dev).manual_seed(0))

    start = 0
    if args.ckpt:
        sup = TrainSupervisor(args.ckpt, save_every=args.save_every)
        state, start = sup.resume_or_init(init)
        if start:
            print(f"resumed from step {start}")
    else:
        sup = None
        state = init()

    mon = StragglerMonitor()
    n_params = sum(x.numel() for _, x in tree_leaves(state["params"]))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M steps={args.steps}")

    for i in range(start + 1, args.steps + 1):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        mon.record(0, dt)  # one process: host 0
        if i % 5 == 0 or i == args.steps:
            tps = args.batch * args.seq / dt
            print(f"step {i:5d} loss {loss:8.4f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:7.1f} ms "
                  f"({tps:,.0f} tok/s)")
        if sup is not None:
            sup.maybe_save(i, state)
    slow = mon.check()
    if slow:
        print(f"straggler hosts flagged: {sorted(slow)}")
    print("done")


if __name__ == "__main__":
    main()
