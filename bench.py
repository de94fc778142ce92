"""Benchmarks on the GPU (BASELINE.md configs), in one process.

Every result is one JSON line on stdout naming the device it ran on
(JAX platform, device kind and count, and the card's name and power limit
from ``nvidia-smi``).  Times are host-clock spans closed by
``block_until_ready``: the median and spread over repeated calls after a
warm-up call, whose time is reported as set-up (compile).  Decoded bits
are checked by fetching the outputs.  With no GPU the script exits
non-zero: CPU numbers are never reported as device numbers.

Sections (default: all, in this order):

  config1      flagship 9 x 128 kbit/s EEP-3A mux, one ``process_block``
               per 16-frame block (modulated IQ; payload rows checked)
  closedloop   the same mux through ``DabReceiver.feed``, ETI bit-exact
  mixedmux     6 x EEP-3A + UEP + DAB+ through ``DabReceiver``; the DAB+
               access units RS-decode with good CRCs
  batched      config 3: 8 ensembles in one ``channel_parallel_block``
  e2e          u8 IQ -> ETI bytes incl. all host work, and ETI assembly
               alone
  channelizer  config 4: 16.384 Msps -> 7 DAB blocks, fft and direct
  rs           config 2: RS(120,110) batch decode
  kernels      batched FFT-2048; Viterbi at the flagship's ragged shape
               (64 FIC + 576 MSC codewords), GPU kernel vs the XLA scan
  viterbi-ab   the receiver per 16-frame block (``process_block`` and one
               ``DabReceiver.feed`` block) with the kernel and with the XLA
               scan

Usage: python bench.py [section ...]
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

from dabtools_tpu.mod.modulator import modulate_ensemble  # noqa: E402
from dabtools_tpu.utils.jitcache import enable_persistent_cache  # noqa: E402

_DEVICE: dict = {}


def device_info() -> dict:
    """The device every line is stamped with; exits without a GPU."""
    if not _DEVICE:
        dev = jax.devices()[0]
        if dev.platform != "gpu":
            sys.exit(f"bench.py: no GPU (JAX platform {dev.platform!r}); "
                     f"not reporting CPU numbers")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        _DEVICE.update(platform=dev.platform, kind=dev.device_kind,
                       count=len(jax.devices()), nvidia_smi=smi)
    return dict(_DEVICE)


def emit(section: str, **fields) -> None:
    print(json.dumps({"section": section, **fields,
                      "device": device_info()}), flush=True)


def timed(fn, *args, repeats: int = 20) -> dict:
    """Set-up (first call, compile included) and the median/min/max of
    ``repeats`` further calls, in ms."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    setup = time.perf_counter() - t0
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return {"setup_s": setup, "median_ms": statistics.median(ts) * 1e3,
            "min_ms": min(ts) * 1e3, "max_ms": max(ts) * 1e3,
            "repeats": repeats, "out": out}


def _ms(t: dict) -> dict:
    return {k: v for k, v in t.items() if k != "out"}


def _noise(n, rng, scale=0.3):
    z = rng.normal(size=(n, 2)).astype(np.float32) * scale
    return jnp.asarray(z[:, 0] + 1j * z[:, 1])


def _eti_payload_check(eti, rx, pb) -> int:
    """Number of ETI frames; raises unless every sub-channel of every
    frame equals the modulator's bytes."""
    from dabtools_tpu.eti.parse import EtiParser
    frames = list(EtiParser().feed(b"".join(eti)))
    a = rx._activation_cif
    for k, f in enumerate(frames):
        for sc, rows in pb.items():
            if f.subchannel_data(sc) != rows[a + k].tobytes():
                raise AssertionError(f"ETI frame {k} subch {sc} mismatch")
    if not frames:
        raise AssertionError("no ETI frames")
    return len(frames)


def sec_config1(ens, rng):
    from dabtools_tpu import constants as C
    from dabtools_tpu.models.receiver import block_samples, process_block
    from dabtools_tpu.ops.fec import init_deinterleave_ring
    from dabtools_tpu.utils.crc import crc16_ok_batch

    n_frames = 16
    xm, pb, _ = modulate_ensemble(ens, n_frames + 4, seed=0)
    x = jnp.asarray(xm[: block_samples(n_frames)])
    rings = jax.device_put({str(s.subchid): init_deinterleave_ring(
        s.profile.tx_bits) for s in ens.subchannels})
    step = functools.partial(process_block, ensemble=ens.decode_config(),
                             mode=C.MODE_I, n_frames=n_frames)
    t = timed(step, x, rings, jnp.asarray(0, jnp.int32))
    out = jax.device_get(t["out"][0])
    # Zero-init rings: rows >= 15 are fully determined by in-block data.
    n_cifs = n_frames * C.MODE_I.n_cifs
    rows = sum(1 for sc in pb for j in range(15, n_cifs)
               if out["subch"][str(sc)][j].tobytes()
               == pb[sc][j - 15].tobytes())
    fib = np.asarray(out["fib_bytes"]).reshape(-1, C.FIB_BYTES)
    want = len(pb) * (n_cifs - 15)
    if rows != want or not crc16_ok_batch(fib).all():
        raise AssertionError(f"config1: {rows}/{want} payload rows")
    samples = n_frames * C.MODE_I.frame_size
    emit("config1", block_frames=n_frames, **_ms(t),
         msamples_per_s=samples / t["median_ms"] / 1e3,
         realtime_x=samples / C.SAMPLE_RATE / t["median_ms"] * 1e3,
         payload_rows_exact=rows)


def sec_closedloop(ens, rng):
    from dabtools_tpu.models.receiver import DabReceiver
    x, pb, _ = modulate_ensemble(ens, 20, seed=0)
    rx = DabReceiver(n_frames=16, ensemble=ens)
    t0 = time.perf_counter()
    eti = rx.feed(x)
    emit("closedloop", eti_frames_exact=_eti_payload_check(eti, rx, pb),
         wall_s=time.perf_counter() - t0)


def sec_mixedmux(ens, rng):
    from __graft_entry__ import _dryrun_ensemble
    from dabtools_tpu.eti.dabplus import SuperframeDecoder
    from dabtools_tpu.eti.parse import EtiParser
    from dabtools_tpu.models.receiver import DabReceiver

    mix = _dryrun_ensemble()
    x, pb, aus = modulate_ensemble(mix, 20, seed=7, dabplus_subch=7)
    rx = DabReceiver(n_frames=16, ensemble=mix)
    eti = rx.feed(x)
    n = _eti_payload_check(eti, rx, pb)
    sfd = SuperframeDecoder(72)
    got = [au for f in EtiParser().feed(b"".join(eti))
           for au in sfd.feed(f.subchannel_data(7))]
    datas = [au.data for au in got]
    if not got or not all(au.crc_ok for au in got) or \
            datas != aus[aus.index(datas[0]): aus.index(datas[0]) + len(got)]:
        raise AssertionError("mixedmux: DAB+ access units wrong")
    emit("mixedmux", eti_frames_exact=n, dabplus_aus_exact=len(got))


def sec_batched(ens, rng):
    from dabtools_tpu import constants as C
    from dabtools_tpu.models.receiver import block_samples
    from dabtools_tpu.ops.fec import init_deinterleave_ring
    from dabtools_tpu.parallel.channel import channel_parallel_block

    n_ch, nf = 8, 8
    xb = jnp.stack([_noise(block_samples(nf), rng) for _ in range(n_ch)])
    rings8 = {str(s.subchid): jnp.tile(
        init_deinterleave_ring(s.profile.tx_bits)[None], (n_ch, 1, 1))
        for s in ens.subchannels}
    step8 = functools.partial(channel_parallel_block,
                              cif_count=jnp.asarray(0, jnp.int32),
                              ensemble=ens, n_frames=nf, mesh=None)
    t = timed(step8, xb, rings8)
    sps = n_ch * nf * C.MODE_I.frame_size / t["median_ms"] * 1e3
    emit("batched", ensembles=n_ch, block_frames=nf, **_ms(t),
         msamples_per_s=sps / 1e6, realtime_x=sps / C.SAMPLE_RATE)


def sec_e2e(ens, rng):
    from dabtools_tpu import constants as C
    from dabtools_tpu.eti.assemble import EtiAssembler
    from dabtools_tpu.mod.impairments import quantize_u8
    from dabtools_tpu.models.receiver import DabReceiver, block_samples
    from dabtools_tpu.utils.crc import crc16_ok_batch

    x, _, _ = modulate_ensemble(ens, 30, seed=0)
    u8 = quantize_u8(x)
    rx = DabReceiver(n_frames=8)
    warm = 2 * (block_samples(8) + 2 * C.MODE_I.frame_size)   # u8 bytes
    rx.feed(u8[:warm])            # compiles both programs, acquires MCI
    if rx.ensemble is None:
        raise AssertionError("e2e: warm-up did not acquire")
    t0 = time.perf_counter()
    eti = rx.feed(u8[warm:])
    t = time.perf_counter() - t0
    # Real time = the 24 ms of signal each emitted ETI frame carries.
    emit("e2e", eti_frames=len(eti), wall_s=t,
         realtime_x=len(eti) * 0.024 / t)

    # Host half alone: ETI assembly, one native crossing per 64 CIFs.
    asm = EtiAssembler(rx.ensemble)
    fibs = [[rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
             for _ in range(3)] for _ in range(64)]
    sub_data = {s.subchid: rng.integers(0, 256, s.data_bytes,
                                        dtype=np.uint8).tobytes()
                for s in rx.ensemble.subchannels}
    n_cif = 4000
    t0 = time.perf_counter()
    for i in range(0, n_cif, 64):
        crc16_ok_batch(np.frombuffer(b"".join(b"".join(f) for f in fibs),
                                     np.uint8).reshape(-1, 32))
        asm.frame_batch(fibs, [sub_data] * 64)
    t = time.perf_counter() - t0
    emit("e2e-host", us_per_frame=t / n_cif * 1e6,
         realtime_x=n_cif * 0.024 / t)


def sec_channelizer(ens, rng):
    import math

    from dabtools_tpu.ops.fir import Channelizer, _channelize, _channelize_fft

    fs = 16_384_000
    offsets = [(-3 + k) * 1_712_000 for k in range(7)]
    x = np.asarray(_noise(fs // 4, rng))                  # 250 ms
    for method in ("fft", "direct"):
        ch = Channelizer(fs, offsets_hz=offsets, method=method)
        if method == "direct":
            n_out = (x.size - ch.num_taps) // ch.decim + 1
            xd = jnp.asarray(x[: n_out * ch.decim + ch.num_taps - 1])
            fn = functools.partial(
                _channelize, mixers=tuple(jnp.asarray(m) for m in ch._mixers),
                phases=jnp.zeros(len(ch._mixers), jnp.int32),
                taps=ch._taps_key, decim=ch.decim,
                q_list=tuple(m.size for m in ch._mixers))
        else:
            n, hop = ch.N_FFT, ch.hop
            n_chunks = (x.size - n) // hop + 1
            starts = np.arange(n_chunks, dtype=np.int64) * hop
            phases = np.empty((len(offsets), n_chunks), np.complex64)
            for k, f in enumerate(offsets):
                g = math.gcd(abs(f), fs) or fs
                p, q = f // g, fs // g
                phases[k] = np.exp(-2j * np.pi * ((starts % q) * p % q) / q)
            xd = jnp.asarray(x[: (n_chunks - 1) * hop + n])
            fn = functools.partial(
                _channelize_fft, hspec=jnp.asarray(ch._hspec),
                phases=jnp.asarray(phases), n_fft=n, hop=hop,
                decim=ch.decim, shifts=tuple(ch._bin_shift))
        t = timed(fn, xd)
        emit("channelizer", method=method, fs_msps=fs / 1e6,
             blocks=len(offsets), taps=ch.num_taps, **_ms(t),
             realtime_x=250.0 / t["median_ms"])


def sec_rs(ens, rng):
    from dabtools_tpu import constants as C
    from dabtools_tpu.ops.rs import rs_decode_batch
    from dabtools_tpu.utils.gf256 import rs_encode

    data = rng.integers(0, 256, size=(2048, C.RS_K), dtype=np.uint8)
    t = timed(rs_decode_batch, jnp.asarray(rs_encode(data)))
    if not np.array_equal(np.asarray(t["out"][0]), data):
        raise AssertionError("rs: decoded data wrong")
    emit("rs", codewords=2048, **_ms(t),
         codewords_per_s=2048 / t["median_ms"] * 1e3)


def viterbi_flagship_job(rng, sigma=0.9):
    """The flagship block's Viterbi job from noisy encoded bits: 64 FIC
    codewords (T=774) and 576 MSC codewords (T=3078), with erasures."""
    from dabtools_tpu.mod.convcode import conv_encode

    def job(n, t):
        bits = rng.integers(0, 2, (n, t - 6)).astype(np.uint8)
        cw = np.stack([conv_encode(b) for b in bits]).astype(np.float32)
        soft = (1 - 2 * cw) + rng.normal(0, sigma, cw.shape).astype(
            np.float32)
        soft[:, 3::8] = 0.0                  # punctured positions
        return jnp.asarray(soft), bits
    return job(64, 774), job(576, 3078)


def sec_kernels(ens, rng):
    from dabtools_tpu.ops.viterbi import (viterbi_decode_ragged,
                                          viterbi_decode_xla)

    spec = jnp.asarray(np.asarray(_noise(16 * 76 * 2048, rng)).reshape(
        16 * 76, 2048))
    t = timed(jax.jit(lambda a: jnp.fft.fft(a, axis=-1)), spec)
    emit("kernel-fft", shape=[16 * 76, 2048], **_ms(t))

    (fic, _), (msc, _) = viterbi_flagship_job(rng)
    kernel = timed(jax.jit(lambda a, b: viterbi_decode_ragged([a, b])),
                   fic, msc)
    xla = timed(jax.jit(lambda a, b: [viterbi_decode_xla(a),
                                      viterbi_decode_xla(b)]), fic, msc)
    for (kb, km), (xb, xm) in zip(kernel["out"], xla["out"]):
        if not (np.array_equal(np.asarray(kb), np.asarray(xb))
                and np.array_equal(np.asarray(km), np.asarray(xm))):
            raise AssertionError("Viterbi kernel differs from XLA")
    emit("kernel-viterbi", impl="gpu-kernel", lanes=[64, 576],
         **_ms(kernel))
    emit("kernel-viterbi", impl="xla-scan", lanes=[64, 576], **_ms(xla))


def sec_viterbi_ab(ens, rng):
    """The receiver per 16-frame block with the GPU Viterbi kernel and
    with the XLA scan: the device step (``process_block``) and one
    ``DabReceiver.feed`` block in steady state, each way, on the same
    modulated flagship signal; the decoded bytes must agree."""
    from dabtools_tpu import constants as C
    from dabtools_tpu.models.receiver import (DabReceiver, block_samples,
                                              process_block)
    from dabtools_tpu.ops import viterbi as V
    from dabtools_tpu.ops.fec import init_deinterleave_ring

    n_frames, n_feeds = 16, 5
    fr = C.MODE_I.frame_size
    x, _, _ = modulate_ensemble(ens, 20 + n_frames * n_feeds, seed=0)
    xb = jnp.asarray(x[: block_samples(n_frames)])
    rings = jax.device_put({str(s.subchid): init_deinterleave_ring(
        s.profile.tx_bits) for s in ens.subchannels})
    step = functools.partial(process_block, ensemble=ens.decode_config(),
                             mode=C.MODE_I, n_frames=n_frames)
    use_kernel, eti = V.use_kernel, {}
    try:
        for impl, kernel in (("gpu-kernel", True), ("xla-scan", False)):
            V.use_kernel = lambda k=kernel: k
            process_block.clear_cache()
            t = timed(step, xb, rings, jnp.asarray(0, jnp.int32))
            emit("viterbi-ab", impl=impl, layer="process_block",
                 block_frames=n_frames, **_ms(t))
            rx = DabReceiver(n_frames=n_frames, ensemble=ens)
            eti[impl] = rx.feed(x[: 20 * fr])       # compiles, first block
            ts = []
            for k in range(n_feeds):
                seg = x[(20 + k * n_frames) * fr: (20 + (k + 1) * n_frames)
                        * fr]
                t0 = time.perf_counter()
                eti[impl] += rx.feed(seg)
                ts.append(time.perf_counter() - t0)
            emit("viterbi-ab", impl=impl, layer="DabReceiver.feed",
                 block_frames=n_frames, median_ms=statistics.median(ts) * 1e3,
                 min_ms=min(ts) * 1e3, max_ms=max(ts) * 1e3, repeats=n_feeds)
    finally:
        V.use_kernel = use_kernel
        process_block.clear_cache()
    if not eti["gpu-kernel"] or eti["gpu-kernel"] != eti["xla-scan"]:
        raise AssertionError("kernel and XLA receivers disagree")


SECTIONS = {"config1": sec_config1, "closedloop": sec_closedloop,
            "mixedmux": sec_mixedmux, "batched": sec_batched,
            "e2e": sec_e2e, "channelizer": sec_channelizer, "rs": sec_rs,
            "kernels": sec_kernels, "viterbi-ab": sec_viterbi_ab}


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(SECTIONS)
    unknown = [n for n in names if n not in SECTIONS]
    if unknown:
        sys.exit(f"unknown section(s) {unknown}; choose from "
                 f"{list(SECTIONS)}")
    device_info()
    enable_persistent_cache()
    from __graft_entry__ import _flagship_ensemble
    ens = _flagship_ensemble()
    for name in names:
        SECTIONS[name](ens, np.random.default_rng(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
