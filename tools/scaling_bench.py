"""Two-process scaling datum for the time-block receiver on CPU devices
(BASELINE config #5's localhost stand-in).

Measures sustained decode throughput of
`parallel.timeblock.timeblock_receiver` at 1 process vs 2 localhost
`jax.distributed` processes (CPU devices), where the shard-boundary halo
`ppermute` crosses a real process boundary over gRPC.  Per-device work is
held constant (each time shard decodes warmup+f_own frames per call), so
ideal scaling doubles the span throughput at 2 processes.

Caveat printed with the result: this host has few cores, so the 2-process
run contends for CPU with XLA compute itself — the efficiency reported is
a LOWER bound dominated by compute contention, not by the halo exchange.

Usage:  python tools/scaling_bench.py            # parent: runs both configs
        (worker mode is internal: --worker I --procs N --port P)
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

DEV_PER_PROC = 2
# Shard size is the compute/comm knob: halo bytes are fixed (warmup
# frames), so larger F_OWN raises the compute-to-communication ratio.
F_OWN = int(os.environ.get("SCALING_F_OWN", "6"))
WARMUP = 5
ITERS = 8


def worker(pid: int, n_procs: int, port: str) -> None:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DEV_PER_PROC}")
    import jax

    jax.config.update("jax_platforms", "cpu")
    if n_procs > 1:
        jax.distributed.initialize(
            coordinator_address=f"127.0.0.1:{port}",
            num_processes=n_procs, process_id=pid)
    assert jax.device_count() == n_procs * DEV_PER_PROC

    import time

    import numpy as np
    import jax.numpy as jnp  # noqa: F401

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from dabtools_tpu import constants as C
    from dabtools_tpu.parallel.mesh import make_receiver_mesh
    from dabtools_tpu.parallel.timeblock import halo_sizes, timeblock_receiver
    from tests.test_closed_loop import build_ensemble, modulate

    n_time = n_procs * DEV_PER_PROC
    g0 = WARMUP + 1
    ens = build_ensemble()
    n_frames_total = g0 + n_time * F_OWN + 1
    x, payload_bytes = modulate(ens, n_frames_total, seed=55)

    fr = C.MODE_I.frame_size
    lh, rh = halo_sizes(WARMUP)
    span_start, span_len = g0 * fr, n_time * F_OWN * fr
    span = x[span_start:span_start + span_len][None]
    prefix = x[span_start - lh:span_start][None]
    suffix = x[span_start + span_len:span_start + span_len + rh][None]

    mesh = make_receiver_mesh(n_channels=1, n_time=n_time)
    fn = timeblock_receiver(mesh, ens, frames_per_shard=F_OWN,
                            warmup_frames=WARMUP)

    P = jax.sharding.PartitionSpec

    def shard(arr, spec):
        sh = jax.sharding.NamedSharding(mesh, spec)
        return jax.make_array_from_callback(
            arr.shape, sh, lambda idx: arr[idx])

    xs = shard(span, P("channels", "time"))
    ps = shard(prefix, P("channels"))
    ss = shard(suffix, P("channels"))

    out = fn(xs, ps, ss, g0)            # compile + warmup
    jax.block_until_ready(out)
    jax.block_until_ready(fn(xs, ps, ss, g0))

    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = fn(xs, ps, ss, g0)
    jax.block_until_ready(out)
    t = (time.perf_counter() - t0) / ITERS

    # Correctness ride-along: the measured program decodes bit-exactly.
    from jax.experimental import multihost_utils
    got = out["subch"]["1"]
    if n_procs > 1:
        got = multihost_utils.process_allgather(got, tiled=True)
    got = np.asarray(got)
    for j in range(n_time * F_OWN * 4):
        n = g0 * 4 + j - 15
        if n >= 0:
            assert got[0, j].tobytes() == payload_bytes[1][n].tobytes(), \
                f"row {j} mismatch in measured program"

    if pid == 0:
        print(json.dumps({
            "n_procs": n_procs, "n_time": n_time,
            "span_frames": n_time * F_OWN,
            "sec_per_span": t,
            "samples_per_s": span_len / t,
        }), flush=True)


def run_config(n_procs: int) -> dict:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    # Pin each process to DISJOINT cores (2 each): per-process compute
    # resources are then identical in both configs, so the efficiency
    # delta isolates the distributed-runtime + halo-exchange overhead
    # instead of measuring host core saturation (unpinned, the 1-proc
    # run already consumes all cores and "efficiency" reads ~1/n_procs).
    procs = [subprocess.Popen(
        ["taskset", "-c", f"{2 * i},{2 * i + 1}",
         sys.executable, os.path.abspath(__file__), "--worker", str(i),
         "--procs", str(n_procs), "--port", port],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(n_procs)]
    outs = [p.communicate(timeout=900) for p in procs]
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"proc {i} rc={p.returncode}:\n{err[-3000:]}")
    return json.loads(outs[0][0].strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--port", default="0")
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.procs, args.port)
        return 0

    r1 = run_config(1)
    r2 = run_config(2)
    eff = r2["samples_per_s"] / (2 * r1["samples_per_s"])
    ncpu = os.cpu_count()
    print(json.dumps({
        "metric": "timeblock_2proc_scaling_efficiency",
        "1proc": r1, "2proc": r2,
        "efficiency": round(eff, 3),
        "note": (f"localhost jax.distributed CPU measurement on {ncpu} "
                 f"cores, each process pinned to 2 disjoint cores so the "
                 f"delta isolates distributed-runtime + halo overhead "
                 f"(~{(WARMUP * 196608 + 256 + 4096) * 8 / 1e6:.1f} MB of "
                 f"halo samples per span at the one cross-process seam)"),
    }, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
