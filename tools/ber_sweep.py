"""BER / decode-rate characterization sweep (SURVEY.md s7 stage 5).

Sweeps SNR (and optionally CFO) over the closed loop and writes JSON-lines
results: pre-Viterbi raw BER, post-FEC frame decode rate, FIB CRC rate.
Not a CI test (minutes of CPU); run ad hoc:

  python tools/ber_sweep.py --snrs 4 5 6 7 8 10 12 --frames 12 -o ber.jsonl

Runs on CPU by default; --gpu runs every decode on the GPU (one
DabReceiver jit per point, persistent-cache friendly) so the waterfall
also pins the GPU path, Viterbi kernel included, under noise.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np  # noqa: E402


def run_point(snr_db: float, cfo_hz: float, n_frames: int, seed: int):
    import jax
    from dabtools_tpu.eti.parse import EtiParser
    from dabtools_tpu.mod.impairments import awgn, carrier_offset
    from dabtools_tpu.models.receiver import DabReceiver
    from tests.test_closed_loop import build_ensemble, modulate

    ens = build_ensemble()
    x, payload_bytes = modulate(ens, n_frames, seed=seed)
    rng = np.random.default_rng(seed + 10_000)
    if cfo_hz:
        x = carrier_offset(x, cfo_hz)
    x = awgn(x, snr_db, rng)

    rx = DabReceiver(n_frames=4)
    t0 = time.time()
    eti = rx.feed(x)
    wall = time.time() - t0

    fib_ok = sum(s.fib_crc_ok for s in rx.stats)
    fib_bad = sum(s.fib_crc_bad for s in rx.stats)
    frames = list(EtiParser().feed(b"".join(eti))) if eti else []
    good = 0
    if rx.ensemble is not None and frames:
        a = rx._activation_cif
        # coarse lock may legitimately land on the next frame's null when
        # the first dip is clipped/tied; account via the measured position
        from dabtools_tpu import constants as C
        off = round(rx.stats[0].null_start / C.MODE_I.frame_size) * 4
        good = sum(
            f.subchannel_data(1) == payload_bytes[1][a + k + off].tobytes()
            for k, f in enumerate(frames)
            if a + k + off < len(payload_bytes[1]))
    return {
        "snr_db": snr_db,
        "cfo_hz": cfo_hz,
        "acquired": rx.ensemble is not None,
        "fib_crc_rate": fib_ok / max(fib_ok + fib_bad, 1),
        "eti_frames": len(frames),
        "frame_decode_rate": good / max(len(frames), 1),
        "wall_s": round(wall, 2),
    }


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--snrs", type=float, nargs="+",
                   default=[2, 4, 5, 6, 7, 8, 10, 14])
    p.add_argument("--cfo", type=float, default=0.0)
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--seeds", type=int, default=2)
    p.add_argument("--gpu", action="store_true",
                   help="decode on the GPU instead of the CPU")
    p.add_argument("-o", "--output", default="-")
    args = p.parse_args()

    import jax
    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        from dabtools_tpu.utils.jitcache import enable_persistent_cache
        enable_persistent_cache()
        dev = jax.devices()[0]
        if dev.platform != "gpu":
            print("--gpu requested but no GPU found; refusing to "
                  "mislabel results", file=sys.stderr)
            return 3
        print(f"# device: {dev.device_kind} ({dev.platform})",
              file=sys.stderr)
    # Resume-friendly: results append as each point lands, and a restart
    # skips points already on disk.
    platform = jax.devices()[0].platform
    # Count records per (snr, cfo, platform): seeds are written in
    # order, so a point is done when `seed < count`.  Counting (rather
    # than keying on the "seed" field) also resumes files written
    # before the field existed.
    done: dict = {}
    if args.output != "-" and Path(args.output).exists():
        for line in Path(args.output).read_text().splitlines():
            try:
                r = json.loads(line)
                # Records written before the n_frames field existed were
                # all 12-frame sweeps; default so they still resume.
                key = (r["snr_db"], r["cfo_hz"], r["platform"],
                       r.get("n_frames", 12))
            except (ValueError, KeyError):
                continue
            done[key] = done.get(key, 0) + 1
        if done:
            print(f"# resuming: {sum(done.values())} points already on "
                  f"disk", file=sys.stderr)
    out = sys.stdout if args.output == "-" else open(args.output, "a")
    for snr in args.snrs:
        for seed in range(args.seeds):
            if seed < done.get((snr, args.cfo, platform, args.frames), 0):
                continue
            rec = run_point(snr, args.cfo, args.frames, seed)
            rec["platform"] = platform
            rec["seed"] = seed
            rec["n_frames"] = args.frames
            out.write(json.dumps(rec) + "\n")
            out.flush()
            print(f"SNR {snr:5.1f} dB seed {seed}: acq={rec['acquired']} "
                  f"fib={rec['fib_crc_rate']:.2f} "
                  f"frames={rec['frame_decode_rate']:.2f}",
                  file=sys.stderr)
    if args.output != "-":
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
