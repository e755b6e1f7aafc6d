"""Serving: the decode step + a minimal batched-request engine.

Twin of `repro/serve/serve_step.py`.  The model holds its parameters
(`models/model.py`), so the step takes none; `pos` is a host int, so a
step reads nothing back from the device but the tokens the server
hands out (as JAX's `np.asarray(self.tokens)` does).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.model import Model


@dataclass(frozen=True)
class ServeConfig:
    temperature: float = 0.0  # 0 = greedy
    cache_len: int = 4096


def make_serve_step(model: Model, sc: ServeConfig):
    """step(cache, token, pos, generator=None) -> (next_token, cache).

    Greedy takes the first maximum of the last logits (as `jnp.argmax`);
    `temperature > 0` samples from softmax(logits / temperature) with
    `generator` (numbers differ from `jax.random.categorical`'s)."""

    def step(cache, token, pos: int, generator: torch.Generator | None = None):
        logits, cache = model.decode_step(token, pos, cache)
        last = logits[:, -1, :].float()
        if sc.temperature > 0.0:
            probs = torch.softmax(last / sc.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(last, dim=-1)
        return nxt[:, None].to(torch.int32), cache

    return step


def make_prefill(model: Model):
    """prefill(tokens, positions=None, enc_frames=None) -> logits (the
    inference-prefill workload)."""

    def prefill(tokens, positions=None, enc_frames=None):
        return model.forward(tokens=tokens, positions=positions,
                             enc_frames=enc_frames)

    return prefill


class BatchedServer:
    """Toy continuous-batching server: fixed batch of request slots, each
    slot decodes independently; finished slots are refilled.  Exercises
    the serving path end-to-end."""

    def __init__(self, model: Model, sc: ServeConfig, batch: int,
                 eos_id: int = 0, max_new: int = 16):
        self.model = model
        self.sc = sc
        self.batch = batch
        self.eos_id = eos_id
        self.max_new = max_new
        self.step_fn = make_serve_step(model, sc)
        enc_len = 8 if model.cfg.encoder is not None else 0
        self.cache = model.init_cache(batch, sc.cache_len, enc_len)
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32,
                                  device=model.device)
        self.produced: list[list[int]] = [[] for _ in range(batch)]
        self.done: list[list[int]] = []

    def run(self, steps: int, generator: torch.Generator | None = None):
        for pos in range(steps):
            self.tokens, self.cache = self.step_fn(self.cache, self.tokens,
                                                   pos, generator)
            toks = self.tokens[:, 0].tolist()
            for i, t in enumerate(toks):
                self.produced[i].append(t)
                if t == self.eos_id or len(self.produced[i]) >= self.max_new:
                    # bounded by steps*batch within one run() call
                    self.done.append(self.produced[i])  # lint: allow-unbounded
                    self.produced[i] = []  # slot refilled with a new request
        return self.done
