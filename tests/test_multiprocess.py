"""Launch the 2-process jax.distributed time-block receiver test
(the localhost stand-in for multi-process runs, SURVEY.md s4 item 4)."""

import pathlib
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_timeblock_receiver():
    worker = pathlib.Path(__file__).parent / "distributed_worker.py"
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), port],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=500)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i}: OK" in out
