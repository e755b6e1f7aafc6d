"""Roofline terms of a dry-run trace on one NVIDIA H100.

Twin of `repro/launch/roofline.py`:

  compute    = flops / (chips * PEAK_FLOPS)
  memory     = bytes / (chips * HBM_BW)
  collective = collective_bytes / (chips * LINK_BW)

The JAX module reads flops and bytes from XLA's `cost_analysis()` of a
compiled program and collective bytes from its optimized HLO text.  The
port compiles nothing: `launch/flops_audit.py` traces a step on the
`meta` device and counts flops, bytes and collective bytes, and
`extract` turns those counts into a `Roofline`.  `parse_collectives` is
kept, a copy of JAX's, for HLO text handed to it.

The peaks are the H100 SXM5's data-sheet figures (dense, no sparsity,
at the full 700 W power limit); the JAX module's are the TPU v5e's.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

# NVIDIA H100 SXM5 per card (data sheet)
PEAK_FLOPS = 989.4e12    # dense bf16 on the tensor cores
HBM_BW = 3.35e12         # B/s, HBM3
LINK_BW = 450e9          # B/s, NVLink 4, per direction

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}

_SHAPE_RE = re.compile(r"(pred|bf16|f16|f32|f64|s8|u8|s16|u16|s32|u32|s64|u64)\[([\d,]*)\]")
_COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")


def _bytes_of_shape(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


@dataclass
class CollectiveStats:
    bytes_by_op: dict[str, int] = field(default_factory=dict)
    count_by_op: dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Sum OUTPUT shape bytes of every collective op line.

    HLO lines look like:
      %ag = bf16[256,4096,5120] all-gather(%x), ...
    The output shape is a good proxy for wire bytes (all-reduce moves
    ~2x in a ring; we report raw operand bytes and note the convention).
    """
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        stripped = line.strip()
        # match '<shape> <op-name>(' on def lines, including fusions' roots
        for op in _COLL_OPS:
            if f" {op}(" not in stripped and f"{op}-start(" not in stripped:
                continue
            m = _SHAPE_RE.search(stripped.split("=", 1)[0] if "=" in stripped else stripped)
            if m is None:
                # shape appears after '=' for most HLO dumps
                rhs = stripped.split("=", 1)[-1]
                m = _SHAPE_RE.search(rhs)
            if m is None:
                continue
            b = _bytes_of_shape(m.group(1), m.group(2))
            stats.bytes_by_op[op] = stats.bytes_by_op.get(op, 0) + b
            stats.count_by_op[op] = stats.count_by_op.get(op, 0) + 1
            break
    return stats


@dataclass
class Roofline:
    """All byte/flop inputs are PER-DEVICE; `global_flops = flops * chips`
    recovers the whole-program numbers.  On one card (`chips = 1`) the
    two agree."""

    flops: float                 # per-device flops
    hbm_bytes: float             # per-device bytes accessed
    collective_bytes: float      # per-device collective bytes
    chips: int
    model_flops: float = 0.0     # analytic 6*N*D (or 6*N_active*D), GLOBAL
    collectives: CollectiveStats | None = None

    @property
    def global_flops(self) -> float:
        return self.flops * self.chips

    @property
    def t_compute(self) -> float:
        return self.global_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes * self.chips / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes * self.chips / (self.chips * LINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.global_flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful work time / achievable step time (all terms overlap-free)."""
        denom = max(self.t_compute, self.t_memory, self.t_collective)
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / denom if denom else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "flops_global": self.global_flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collective_detail": (
                {"bytes": self.collectives.bytes_by_op,
                 "count": self.collectives.count_by_op}
                if self.collectives else {}),
        }


def model_flops_for(cfg, kind: str, batch: int, seq: int) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D for training, 2*N_active*D for
    inference (forward-only), per executed step."""
    n = cfg.active_param_count()
    if kind == "train":
        tokens = batch * seq
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = batch * seq
        return 2.0 * n * tokens
    # decode: one token per sequence per step
    return 2.0 * n * batch


def extract(counts: dict, chips: int, model_flops: float) -> Roofline:
    """A `Roofline` from the counts of a trace (`flops_audit.count`):
    `flops`, `bytes` and `coll` per device, `coll_by_op` and
    `coll_count_by_op` the collective bytes and their number by op name
    (none on one card)."""
    coll = CollectiveStats(
        bytes_by_op=dict(counts.get("coll_by_op", {})),
        count_by_op=dict(counts.get("coll_count_by_op", {})))
    return Roofline(flops=float(counts["flops"]),
                    hbm_bytes=float(counts["bytes"]),
                    collective_bytes=float(counts["coll"]), chips=chips,
                    model_flops=model_flops, collectives=coll)
