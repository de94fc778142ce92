"""Smoke test of the receiver on one GPU, through its normal entry points.

Run from the root of a checkout:

    python chip_smoke.py               # one GPU
    python chip_smoke.py --four-cards  # only the sharded path, 4 GPUs

Phases (one card), each printed with what it checked and how long it took:

  device    a GPU is present (no CPU fallback); prints the card's name and
            power limit, the JAX/jaxlib versions, the compile cache and
            whether the native host library loaded
  viterbi   the GPU Viterbi kernel against the XLA scan on the card, at
            the flagship block's ragged job (64 FIC + 576 MSC codewords
            from punctured, noisy encoded bits): identical bits and
            metrics; both timed
  numerics  the channelizer (fft and direct) and the resampler on the GPU
            against the CPU backend, within a stated tolerance
  receiver  the flagship 9 x 128 kbit/s EEP-3A mux (864/864 CUs) through
            ``DabReceiver(n_frames=16).feed`` as cf32, as RTL-SDR u8 and
            impaired (AWGN 14 dB + CFO): every payload byte equals the
            modulator's, every FIB CRC passes
  cli       ``dab2eti`` (in-process) on a cf32 file of the same signal
            gives the library's ETI bytes; the mixed mux (EEP + UEP +
            DAB+) through ``dab2eti``: payloads exact and every DAB+
            access unit RS-decodes with a good CRC to the built AU

``--four-cards`` runs only ``__graft_entry__.dryrun_multichip(4)``: a
2 x 2 channels x time mesh, bit-exact against the modulator and against
one device's ``process_block`` on the same span.

A failing phase raises.  The last line of stdout is the JSON result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent


def phase(name: str):
    def wrap(fn):
        def run(*args):
            t0 = time.perf_counter()
            summary = fn(*args)
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s: "
                  f"{summary}", flush=True)
        return run
    return wrap


def median_ms(fn, *args, repeats: int = 20) -> float:
    import jax
    jax.block_until_ready(fn(*args))               # warm-up
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


@phase("device")
def phase_device(n_cards: int):
    import jax
    import jaxlib

    from dabtools_tpu.utils import native
    from dabtools_tpu.utils.jitcache import enable_persistent_cache

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    print(smi)
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    print(f"compile cache: {enable_persistent_cache()}")
    print("native host library: "
          + ("loaded" if native.lib() is not None
             else "not loaded (NumPy fallbacks)"))
    if len(jax.devices()) < n_cards:
        raise RuntimeError(f"need {n_cards} GPUs, found {jax.devices()}")
    return f"{len(jax.devices())} x {jax.devices()[0].device_kind}"


def flagship_viterbi_job(rng):
    """One 16-frame flagship block's Viterbi job: 64 FIC codewords and
    576 EEP-3A 128 kbit/s codewords, encoded, punctured, sent over BPSK
    with AWGN and depunctured (erasures where punctured)."""
    import jax.numpy as jnp
    import numpy as np

    from dabtools_tpu.mod.convcode import conv_encode
    from dabtools_tpu.ops.fec import depuncture
    from dabtools_tpu.tables.puncturing import FIC_PROFILE, eep_profile

    jobs = []
    for n, prof in ((64, FIC_PROFILE), (576, eep_profile(3, "A", 128))):
        bits = rng.integers(0, 2, (n, prof.data_bits), dtype=np.uint8)
        tx = np.stack([conv_encode(b) for b in bits])[
            :, prof.mask().astype(bool)]
        soft = (1.0 - 2.0 * tx) + rng.normal(0, 0.6, tx.shape)
        jobs.append((depuncture(jnp.asarray(soft, jnp.float32), prof),
                     bits))
    return jobs


@phase("viterbi")
def phase_viterbi():
    import jax
    import numpy as np

    from dabtools_tpu.ops.viterbi import (use_kernel, viterbi_decode_ragged,
                                          viterbi_decode_xla)

    if not use_kernel():
        raise RuntimeError("the GPU Viterbi kernel is not selected")
    (fic, fic_bits), (msc, msc_bits) = flagship_viterbi_job(
        np.random.default_rng(1))
    kernel = jax.jit(lambda a, b: viterbi_decode_ragged([a, b]))
    ref = jax.jit(lambda a, b: [viterbi_decode_xla(a), viterbi_decode_xla(b)])
    errs = 0
    for (kb, km), (rb, rm), tx in zip(kernel(fic, msc), ref(fic, msc),
                                      (fic_bits, msc_bits)):
        kb, km, rb, rm = map(np.asarray, (kb, km, rb, rm))
        # Same arithmetic in the same order on both sides (exact signed
        # branch-metric sums, IEEE add and max): metrics must be EQUAL.
        if not np.array_equal(kb, rb):
            raise AssertionError("kernel bits differ from the XLA scan")
        if not np.array_equal(km, rm):
            raise AssertionError("kernel metrics differ from the XLA scan: "
                                 f"max |d| {np.abs(km - rm).max()}")
        errs += int((kb != tx).sum())
    t_k = median_ms(kernel, fic, msc)
    t_x = median_ms(ref, fic, msc)
    return (f"64 FIC + 576 MSC codewords: bits and metrics identical to "
            f"the XLA scan ({errs} residual bit errors vs transmitted); "
            f"median of 20: kernel {t_k:.3f} ms, XLA scan {t_x:.3f} ms")


# Relative tolerance for the GPU-vs-CPU front-end comparison: both sides
# compute in full f32 (the channelizer's conv at HIGHEST precision, the
# resampler as an elementwise product and sum), so they differ only in
# summation order and FFT library, i.e. a few f32 ulps of the output RMS.
# A TF32 path would show ~1e-3.
FRONTEND_RTOL = 1e-5


@phase("numerics")
def phase_numerics():
    import jax
    import numpy as np

    from dabtools_tpu.ops.fir import Channelizer
    from dabtools_tpu.ops.resample import Resampler

    rng = np.random.default_rng(2)
    z = rng.normal(0, 0.3, (2, 409_600)).astype(np.float32)
    x = (z[0] + 1j * z[1]).astype(np.complex64)       # 50 ms at 8.192 Msps
    cpu = jax.devices("cpu")[0]
    cases = {
        f"channelizer[{m}]": lambda m=m: Channelizer(
            8_192_000, offsets_hz=[-1_712_000, 0, 1_712_000], method=m)(x)
        for m in ("fft", "direct")}
    cases["resampler 2.4->2.048 Msps"] = lambda: Resampler(2_400_000)(
        x[:240_000])
    worst = []
    for name, run in cases.items():
        y_gpu = np.asarray(run())
        with jax.default_device(cpu):
            y_cpu = np.asarray(run())
        rel = float(np.abs(y_gpu - y_cpu).max()
                    / np.sqrt(np.mean(np.abs(y_cpu) ** 2)))
        if not rel <= FRONTEND_RTOL:
            raise AssertionError(f"{name}: GPU vs CPU max error {rel:.2e} "
                                 f"of the output RMS > {FRONTEND_RTOL}")
        worst.append(f"{name} {rel:.1e}")
    return ("GPU vs CPU, max error / output RMS (limit "
            f"{FRONTEND_RTOL}): " + ", ".join(worst))


def check_eti(eti, rx, payload) -> int:
    """ETI frame count; raises unless every sub-channel of every frame
    equals the modulator's bytes and every FIB CRC passed."""
    from dabtools_tpu.eti.parse import EtiParser

    frames = list(EtiParser().feed(b"".join(eti)))
    if not frames:
        raise AssertionError("no ETI frames")
    a = rx._activation_cif
    for k, f in enumerate(frames):
        if not (f.header_crc_ok and f.mst_crc_ok):
            raise AssertionError(f"ETI frame {k}: bad CRC")
        for sc, rows in payload.items():
            if f.subchannel_data(sc) != rows[a + k].tobytes():
                raise AssertionError(f"ETI frame {k}: subch {sc} differs")
    bad = sum(s.fib_crc_bad for s in rx.stats)
    if bad:
        raise AssertionError(f"{bad} FIB CRC failures")
    return len(frames)


@phase("receiver")
def phase_receiver(flag: dict):
    import numpy as np

    from dabtools_tpu.mod.impairments import awgn, carrier_offset, quantize_u8
    from dabtools_tpu.models.receiver import DabReceiver

    ens, x, payload = flag["ens"], flag["x"], flag["payload"]
    inputs = {
        "cf32": x,
        "u8": quantize_u8(x),
        "AWGN 14 dB + CFO 350 Hz": carrier_offset(
            awgn(x, 14.0, np.random.default_rng(99)), 350.0),
    }
    done = []
    for name, iq in inputs.items():
        t0 = time.perf_counter()
        rx = DabReceiver(n_frames=16)
        eti = rx.feed(iq)
        if rx.ensemble is None or rx.ensemble.subchannels != ens.subchannels:
            raise AssertionError(f"{name}: ensemble not acquired")
        n = check_eti(eti, rx, payload)
        done.append(f"{name} {n} ETI frames exact "
                    f"({time.perf_counter() - t0:.1f} s)")
        if name == "cf32":
            flag["eti"] = b"".join(eti)
    return "; ".join(done)


def dab2eti_bytes(x, tmp: Path, name: str) -> bytes:
    from dabtools_tpu.cli import dab2eti

    iq, out = tmp / f"{name}.cf32", tmp / f"{name}.eti"
    x.tofile(iq)
    rc = dab2eti.main([str(iq), "--format", "cf32", "--frames-per-block",
                       "16", "-o", str(out)])
    if rc != 0:
        raise AssertionError(f"dab2eti exited {rc}")
    return out.read_bytes()


@phase("cli")
def phase_cli(flag: dict):
    from __graft_entry__ import _dryrun_ensemble
    from dabtools_tpu.eti.dabplus import SuperframeDecoder
    from dabtools_tpu.eti.parse import EtiParser
    from dabtools_tpu.mod.modulator import modulate_ensemble

    with tempfile.TemporaryDirectory() as d:
        eti = dab2eti_bytes(flag["x"], Path(d), "flagship")
        if eti != flag["eti"]:
            raise AssertionError("dab2eti ETI differs from DabReceiver's")
        mix = _dryrun_ensemble()
        xm, payload, aus = modulate_ensemble(mix, 20, seed=7,
                                             dabplus_subch=7)
        mix_eti = dab2eti_bytes(xm, Path(d), "mixed")
    frames = list(EtiParser().feed(mix_eti))
    if not frames:
        raise AssertionError("mixed mux: no ETI frames")
    # The first ETI frame is logical frame 0 (acquisition replays the
    # first block), so frame k carries CIF k.
    for k, f in enumerate(frames):
        for sc, rows in payload.items():
            if f.subchannel_data(sc) != rows[k].tobytes():
                raise AssertionError(f"mixed mux frame {k} subch {sc}")
    sfd = SuperframeDecoder(72)
    got = [au for f in frames for au in sfd.feed(f.subchannel_data(7))]
    if not got or not all(au.crc_ok for au in got):
        raise AssertionError("DAB+ access unit CRC failure")
    datas = [au.data for au in got]
    k0 = aus.index(datas[0])
    if datas != aus[k0: k0 + len(datas)]:
        raise AssertionError("DAB+ access units differ from the built ones")
    return (f"flagship: {len(eti)} ETI bytes equal the library's; mixed "
            f"mux: {len(frames)} ETI frames exact, {len(got)} DAB+ access "
            f"units with good CRCs equal the built ones")


@phase("four-cards")
def phase_four_cards():
    from __graft_entry__ import dryrun_multichip
    dryrun_multichip(4)
    return "2 x 2 channels x time mesh"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)
    if not (REPO / "dabtools_tpu").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke.py: no GPU (JAX found {devices[0].platform!r}); "
              f"there is no CPU fallback", file=sys.stderr)
        return 1
    n_cards = 4 if args.four_cards else 1
    phase_device(n_cards)
    if args.four_cards:
        phase_four_cards()
    else:
        from __graft_entry__ import _flagship_ensemble
        from dabtools_tpu.mod.modulator import modulate_ensemble

        phase_viterbi()
        phase_numerics()
        ens = _flagship_ensemble()
        x, payload, _ = modulate_ensemble(ens, 20, seed=0)
        flag = {"ens": ens, "x": x, "payload": payload}
        phase_receiver(flag)
        phase_cli(flag)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
