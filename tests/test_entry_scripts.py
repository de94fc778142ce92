"""``chip_smoke.py`` and ``bench.py`` refuse to run without a GPU: no CPU
fallback, no result line."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [[], ["--four-cards"]])
def test_chip_smoke_fails_without_gpu(args):
    r = _run([str(REPO / "chip_smoke.py"), *args], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_outside_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("args", [["rs"], ["no-such-section"]])
def test_bench_fails_without_gpu(args):
    r = _run([str(REPO / "bench.py"), *args], REPO)
    assert r.returncode != 0
    assert r.stdout == ""
