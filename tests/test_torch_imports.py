"""The port stands alone: importing every `repro_torch` module pulls in
neither JAX nor the JAX package, and entry points refuse to move to the
CPU unless asked."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"


def _port_modules() -> list[str]:
    root = SRC / "repro_torch"
    mods = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_port_modules_found():
    mods = _port_modules()
    for name in ("repro_torch", "repro_torch.query.engine",
                 "repro_torch.query.buckets", "repro_torch.query.workload",
                 "repro_torch.kernels.join_count", "repro_torch.kernels.ops",
                 "repro_torch.kernels.ref", "repro_torch.views.materializer",
                 "repro_torch.core.executor", "repro_torch.core.wizard",
                 "repro_torch.api.session", "repro_torch.api.convert",
                 "repro_torch.kernels._build",
                 "repro_torch.kernels.scatter_append",
                 "repro_torch.kernels.filter_mask",
                 "repro_torch.views.maintenance", "repro_torch.maintenance",
                 "repro_torch.maintenance.maintainer",
                 "repro_torch.maintenance.delta_plan",
                 "repro_torch.maintenance.host_delta",
                 "repro_torch.maintenance.stream",
                 "repro_torch.maintenance.drift",
                 "repro_torch.kernels.flash_attn", "repro_torch.models.config",
                 "repro_torch.models.params", "repro_torch.models.layers",
                 "repro_torch.models.transformer", "repro_torch.models.model",
                 "repro_torch.configs", "repro_torch.configs.gemma3_12b",
                 "repro_torch.serve.serve_step",
                 "repro_torch.rdf.parser",
                 "repro_torch.checkpoint.checkpoint",
                 "repro_torch.distributed.fault",
                 "repro_torch.distributed.sharding",
                 "repro_torch.serve.chaos", "repro_torch.serve.query_server",
                 "repro_torch.serve.frontend", "repro_torch.serve.loadgen",
                 "repro_torch.launch.mesh", "repro_torch.query.distributed",
                 "repro_torch.serve.sharded", "repro_torch.analysis",
                 "repro_torch.analysis.findings",
                 "repro_torch.analysis.ir_verifier",
                 "repro_torch.analysis.capacity",
                 "repro_torch.analysis.maintenance_check",
                 "repro_torch.analysis.repo_rules",
                 "repro_torch.analysis.body_lint",
                 "repro_torch.analysis.driver", "repro_torch.analysis.cli",
                 "repro_torch.analysis.__main__",
                 "repro_torch.models.ssm", "repro_torch.launch.tune",
                 "repro_torch.train.optimizer",
                 "repro_torch.train.train_step",
                 "repro_torch.data.pipeline", "repro_torch.launch.train",
                 *DRYRUN_MODULES):
        assert name in mods


DRYRUN_MODULES = tuple(f"repro_torch.launch.{m}" for m in (
    "shapes", "roofline", "flops_audit", "dryrun", "report"))


def test_dryrun_modules_import_alone():
    """The five dry-run modules, imported in a fresh interpreter, pull in
    neither JAX nor the JAX package, and set no XLA flag."""
    code = (
        "import importlib, os, sys\n"
        f"for m in {DRYRUN_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad), os.environ.get('XLA_FLAGS') or '')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_importing_every_module_leaves_jax_and_repro_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_fake_group_loads_only_in_per_device():
    """No module of the port loads the fake process group's internals or
    starts a process group when it is imported: `launch.mesh.per_device`
    does both, and undoes the group, when it is entered."""
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import torch.distributed as dist\n"
        "fake = 'torch.testing._internal.distributed.fake_pg'\n"
        "print(fake in sys.modules, dist.is_initialized())\n"
        "from repro_torch.launch.mesh import make_production_mesh, "
        "per_device\n"
        "with per_device(make_production_mesh(device='cpu')):\n"
        "    print(fake in sys.modules, dist.is_initialized())\n"
        "print(dist.is_initialized())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "True", "True", "False"]


def test_device_raises_without_cuda():
    import torch

    import repro_torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA error cannot show")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.device("cuda")
    assert repro_torch.device("cpu") == torch.device("cpu")


def test_entry_points_default_to_the_card():
    import numpy as np
    import torch

    from repro_torch.api import TuningSession
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.query import engine as E
    from repro_torch.rdf.triples import TripleStore

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA error cannot show")
    store = TripleStore(np.array([[0, 1, 2]], np.int32))
    for call in (lambda: E.make_prel(np.zeros((1, 2), np.int32), 4),
                 lambda: E.tt_device_indexes(store),
                 lambda: TuningSession(store),
                 lambda: build_model(get_smoke_config("gemma3-12b"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
