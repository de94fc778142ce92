"""etiinfo/eti2mpa tools, checkpoint files, and sample-clock drift."""

import subprocess
import sys

import numpy as np

from dabtools_tpu import constants as C
from dabtools_tpu.eti.parse import EtiParser
from dabtools_tpu.models.receiver import DabReceiver

from tests.test_closed_loop import build_ensemble, modulate


def _resample_ppm(x: np.ndarray, ppm: float) -> np.ndarray:
    """Linear-interpolation resample modelling a sample-clock offset."""
    ratio = 1.0 + ppm * 1e-6
    t_out = np.arange(int(x.size / ratio)) * ratio
    re = np.interp(t_out, np.arange(x.size), x.real)
    im = np.interp(t_out, np.arange(x.size), x.imag)
    return (re + 1j * im).astype(np.complex64)


def test_clock_drift_50ppm():
    """50 ppm sample-clock offset (typical cheap RTL-SDR): per-frame PRS
    fine sync absorbs the drift and payloads stay bit-exact."""
    ens = build_ensemble()
    x, payload_bytes = modulate(ens, 14, seed=9)
    x = _resample_ppm(x, 50.0)
    rx = DabReceiver(n_frames=4)
    eti = rx.feed(x)
    assert rx.ensemble is not None
    assert len(eti) > 8
    frames = list(EtiParser().feed(b"".join(eti)))
    a = rx._activation_cif
    ok = sum(f.subchannel_data(1) == payload_bytes[1][a + k].tobytes()
             for k, f in enumerate(frames))
    assert ok == len(frames)
    # fine sync tracked the drift: PRS offsets move across the block
    offs = rx.stats[-1]
    assert offs.prs_peak_min > 0.5


def test_checkpoint_file_roundtrip(tmp_path):
    ens = build_ensemble()
    x, payload_bytes = modulate(ens, 16, seed=10)
    half = 9 * C.MODE_I.frame_size + 57
    rx1 = DabReceiver(n_frames=4)
    eti = rx1.feed(x[:half])
    leftover = rx1.pending_samples()
    path = tmp_path / "rx.ckpt"
    rx1.save_checkpoint(str(path))

    rx2 = DabReceiver.load_checkpoint(str(path), n_frames=4)
    eti += rx2.feed(np.concatenate([leftover, x[half:]]))
    frames = list(EtiParser().feed(b"".join(eti)))
    a = rx2._activation_cif
    assert len(frames) >= 10
    for k, f in enumerate(frames):
        assert f.subchannel_data(1) == payload_bytes[1][a + k].tobytes()


def _make_eti(tmp_path):
    ens = build_ensemble()
    x, _ = modulate(ens, 12, seed=11)
    rx = DabReceiver(n_frames=4)
    eti = b"".join(rx.feed(x))
    p = tmp_path / "t.eti"
    p.write_bytes(eti)
    return p


def test_etiinfo_summary(tmp_path):
    p = _make_eti(tmp_path)
    r = subprocess.run(
        [sys.executable, "-m", "dabtools_tpu.cli.etiinfo", str(p)],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "ensemble: 0x4FFF 'TEST DAB'" in r.stdout
    assert "subch  1: CU   0+48  EEP-3A 64 kbit/s" in r.stdout
    assert "header CRC failures: 0" in r.stdout
    assert "FCT discontinuities: 0" in r.stdout


def test_eti2mpa_alias(tmp_path):
    p = _make_eti(tmp_path)
    r = subprocess.run(
        [sys.executable, "-m", "dabtools_tpu.cli.eti2mpa",
         "--subch", "1", str(p), "-o", str(tmp_path / "out.mp2")],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "out.mp2").stat().st_size > 0


def test_tist_external_epoch():
    """TIST from an external time source: DabReceiver(tist=<epoch>) stamps
    frame phases as (epoch + cif*24ms) mod 1 s — the SFN lab-grade option
    (a capture's recorded UTC start time anchors the output timeline)."""
    ens = build_ensemble()
    x, _ = modulate(ens, 14, seed=11)
    epoch = 1755561600.8125          # any UTC timestamp; phase .8125 s
    rx = DabReceiver(n_frames=4, tist=epoch)
    frames = list(EtiParser().feed(b"".join(rx.feed(x))))
    assert len(frames) > 8
    a = rx._activation_cif
    from dabtools_tpu.eti.assemble import TIST_TICKS_PER_FRAME
    tick0 = frames[0].tist
    want0 = round(((epoch + a * 24e-3) % 1.0) * 16_384_000)
    assert tick0 == want0 % (16_384_000), (tick0, want0)
    for k in range(1, len(frames)):
        assert (frames[k].tist - frames[k - 1].tist) % 16_384_000 \
            == TIST_TICKS_PER_FRAME


def test_tist_epoch_zero_is_a_valid_anchor():
    """tist=0.0 means 'sample 0 is exactly on a UTC second', not 'TIST
    off' (review r3 finding: falsy-float bug)."""
    ens = build_ensemble()
    x, _ = modulate(ens, 10, seed=12)
    rx = DabReceiver(n_frames=4, tist=0.0)
    frames = list(EtiParser().feed(b"".join(rx.feed(x))))
    assert frames and all(f.tist is not None for f in frames)


def test_dab2eti_tist_flags_mutually_exclusive(tmp_path):
    """--tist/--tist-utc/--tist-epoch pick different timestamp anchors;
    combining them must be a hard argparse error, not silent precedence
    (ADVICE r3)."""
    import subprocess
    import sys

    cap = tmp_path / "cap.cf32"
    cap.write_bytes(b"\x00" * 64)
    r = subprocess.run(
        [sys.executable, "-m", "dabtools_tpu.cli.dab2eti", "--cpu",
         "--format", "cf32", "--tist", "--tist-epoch", "123.0", str(cap)],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 2
    assert "mutually exclusive" in r.stderr
