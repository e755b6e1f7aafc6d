"""The port's CLIs and its demo tour run end to end on the CPU
(subprocess smoke), as `tests/test_launchers.py` runs the JAX package's.
The wizard CLI's stdout equals the JAX CLI's line for line, but for the
search's elapsed seconds; the train CLI resumes from its checkpoint."""
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUNE_ARGS = ["--universities", "1", "--strategy", "greedy", "--max-states",
             "100", "--verify"]


def _run(args, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=timeout)


def _masked(stdout: str) -> list[str]:
    return re.sub(r" in \d+\.\d+s;", " in <s>s;", stdout).splitlines()


def test_tune_cli_prints_the_jax_clis_lines():
    port = _run(["-m", "repro_torch.launch.tune"] + TUNE_ARGS
                + ["--device", "cpu"])
    assert port.returncode == 0, port.stderr[-2000:]
    assert "verification: PASSED" in port.stdout
    ref = _run(["-m", "repro.launch.tune"] + TUNE_ARGS)
    assert ref.returncode == 0, ref.stderr[-2000:]
    got, want = _masked(port.stdout), _masked(ref.stdout)
    assert any("in <s>s;" in line for line in got)
    assert got == want


def test_tune_cli_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA error cannot show")
    res = _run(["-m", "repro_torch.launch.tune", "--max-states", "10"])
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr


def test_wizard_tour_torch_verifies():
    res = _run([os.path.join("examples", "wizard_tour_torch.py"), "--device",
                "cpu"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "[verify] answers from views == direct evaluation:" in res.stdout
    lines = [line for line in res.stdout.splitlines()
             if re.fullmatch(r"  q\d: \d+ answers (ok|FAIL)", line)]
    assert len(lines) == 6 and all(line.endswith(" ok") for line in lines)
    assert "tour complete." in res.stdout


def test_train_cli_with_checkpoint_resume(tmp_path):
    """The twin of `tests/test_launchers.py::
    test_train_cli_with_checkpoint_resume`, on the CPU."""
    ckpt = str(tmp_path / "ck")
    args = ["-m", "repro_torch.launch.train", "--arch", "whisper-base",
            "--smoke", "--batch", "2", "--seq", "16", "--data", "synthetic",
            "--ckpt", ckpt, "--save-every", "2", "--device", "cpu"]
    res = _run(args + ["--steps", "6"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "arch=whisper-smoke params=" in res.stdout
    assert "done" in res.stdout
    # resume continues from the saved step
    res2 = _run(args + ["--steps", "8"])
    assert res2.returncode == 0, res2.stderr[-2000:]
    assert "resumed from step 6" in res2.stdout
    assert "step     8 loss" in res2.stdout and "done" in res2.stdout


def test_train_cli_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA error cannot show")
    res = _run(["-m", "repro_torch.launch.train", "--arch", "whisper-base",
                "--smoke", "--steps", "1"])
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
