"""Model facade: template + parameters + entry points per config.

Twin of `repro/models/model.py`.  Where the JAX `Model` is a stateless
facade handed `params` on every call, the port's `Model` holds them:
`params` is the one representation, a nested dict of plain tensors in
the JAX package's layout, so the two compare leaf for leaf.  Training
(`repro_torch.train.train_step`) differentiates the model's functions
over such a tree (`transformer.forward`), not over the module.
"""
from __future__ import annotations

import torch
from torch import nn

import repro_torch
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (count_params, init_params, tree_leaves,
                                       tree_map, tree_shapes)


class Model(nn.Module):
    """A model of any family on one device.  `init` or `load_params`
    gives it parameters; until then the entry points raise."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.device = device
        self.template = T.model_template(cfg)
        self.params: dict | None = None

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator | None = None,
             dtype: torch.dtype = torch.float32) -> "Model":
        """Random parameters on the model's device in `dtype`, drawn from
        `generator` (a generator on that device; seed 0 when None)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return self.load_params(init_params(self.template, generator, dtype,
                                            self.device))

    def load_params(self, tree: dict) -> "Model":
        """Take a nested dict of tensors shaped as the template (no copy
        where they already lie on the model's device)."""
        want = tree_shapes(self.template)
        got = dict(tree_leaves(tree))
        if set(got) != set(dict(tree_leaves(want))):
            missing = sorted("/".join(p) for p in
                             set(dict(tree_leaves(want))) ^ set(got))
            raise ValueError(f"parameter tree differs from the template at "
                             f"{missing[:5]}")
        for path, shape in tree_leaves(want):
            if tuple(got[path].shape) != shape:
                raise ValueError(f"parameter {'/'.join(path)} has shape "
                                 f"{tuple(got[path].shape)}, expected {shape}")
        self.params = tree_map(lambda _s, x: x.to(self.device), self.template,
                               tree)
        return self

    def param_count(self) -> int:
        return count_params(self.template)

    def _params(self) -> dict:
        if self.params is None:
            raise RuntimeError("the model has no parameters: call init() or "
                               "load_params() first")
        return self.params

    # ------------------------------------------------------------------
    def forward(self, tokens=None, embeds=None, positions=None,
                enc_frames=None, remat: str = "none"):
        return T.forward(self.cfg, self._params(), tokens=tokens,
                         embeds=embeds, positions=positions,
                         enc_frames=enc_frames, remat=remat)

    def decode_step(self, token, pos: int, cache):
        return T.decode_step(self.cfg, self._params(), token, pos, cache)

    def prefill_with_cache(self, tokens=None, embeds=None, positions=None,
                           enc_frames=None, cache_len: int = 0):
        return T.prefill_with_cache(self.cfg, self._params(), tokens=tokens,
                                    embeds=embeds, positions=positions,
                                    enc_frames=enc_frames,
                                    cache_len=cache_len)

    def cache_shapes(self, batch: int, cache_len: int,
                     enc_len: int = 0) -> dict:
        return T.cache_template(self.cfg, batch, cache_len, enc_len)

    def cache_axes(self) -> dict:
        return T.cache_logical_axes(self.cfg)

    def init_cache(self, batch: int, cache_len: int,
                   enc_len: int = 0) -> dict:
        return tree_map(
            lambda sd: torch.zeros(sd[0], dtype=sd[1], device=self.device),
            self.cache_shapes(batch, cache_len, enc_len))


def build_model(cfg: ModelConfig, device=None) -> Model:
    """A `Model` for `cfg` on `device` (the card unless "cpu" is asked):
    every family of `configs/` (dense, MoE, Mamba2 hybrid, RWKV6 and the
    encoder-decoder)."""
    return Model(cfg, repro_torch.device(device))
