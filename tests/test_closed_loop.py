"""Closed-loop integration: modulate a full ensemble -> DabReceiver ->
ETI(NI) -> parse -> payload bit-exactness (SURVEY.md s4 item 3; the
bit-exactness contract is proxied by the golden modulator while no
reference captures exist — see SURVEY.md availability notice)."""

import numpy as np
import pytest

from dabtools_tpu import constants as C
from dabtools_tpu.eti.parse import EtiParser
from dabtools_tpu.fic.config import Ensemble, Service, ServiceComponent, Subchannel
from dabtools_tpu.mod.impairments import awgn, carrier_offset, timing_offset
from dabtools_tpu.mod.modulator import modulate_ensemble
from dabtools_tpu.models.receiver import DabReceiver


def build_ensemble():
    return Ensemble(
        eid=0x4FFF,
        label="TEST DAB",
        subchannels=(Subchannel.eep(1, 0, 3, "A", 64),),
        services=(Service(sid=0x1234, label="SVC ONE", components=(
            ServiceComponent(tmid=0, subchid=1, ascty=0),)),),
    )


def modulate(ens, n_frames, seed=0, payload_subchids=(1,)):
    """(IQ, {subchid: payload bytes per CIF}) of ``ens`` with random
    payloads (``payload_subchids`` is accepted for older callers)."""
    x, payload_bytes, _ = modulate_ensemble(ens, n_frames, seed)
    return x, payload_bytes


@pytest.mark.parametrize("impair", ["clean", "noisy"])
def test_closed_loop_single_subchannel(impair):
    ens = build_ensemble()
    n_frames = 14
    x, payload_bytes = modulate(ens, n_frames)
    if impair == "noisy":
        rng = np.random.default_rng(99)
        x = awgn(x, 18.0, rng)
        x = carrier_offset(x, 350.0)
        x = timing_offset(x, 1234)

    rx = DabReceiver(n_frames=4)
    eti = rx.feed(x)

    # MCI must have been acquired from the FIBs alone.
    assert rx.ensemble is not None
    assert rx.ensemble.eid == ens.eid
    assert rx.ensemble.subchannels == ens.subchannels
    assert rx.ensemble.label == ens.label

    # Sync diagnostics sane.
    st = rx.stats[-1]
    assert st.fib_crc_bad == 0
    assert st.null_ratio < 0.2
    if impair == "noisy":
        assert abs(st.cfo_carriers - 0.35) < 0.05

    assert len(eti) > 0, "no ETI frames emitted"
    frames = list(EtiParser().feed(b"".join(eti)))
    assert len(frames) == len(eti)

    a = rx._activation_cif
    for k, f in enumerate(frames):
        n = a + k                      # global CIF index of this ETI frame
        assert f.header_crc_ok and f.mst_crc_ok
        assert f.fct == k % 250
        got = f.subchannel_data(1)
        expect = payload_bytes[1][n].tobytes()
        assert got == expect, f"payload mismatch at CIF {n}"
        # FIC in the ETI frame: FIBs of transmission frame n//4, CIF n%4,
        # which carry this very ensemble's MCI with valid CRCs
        from dabtools_tpu.utils.crc import crc16_ok
        for i in range(3):
            assert crc16_ok(f.fic[32 * i:32 * (i + 1)])


def test_closed_loop_two_subchannels_and_checkpoint():
    ens = Ensemble(
        eid=0xD00D,
        label="TWO SUBCH",
        subchannels=(Subchannel.eep(1, 0, 3, "A", 64),
                     Subchannel.eep(9, 48, 2, "B", 64)),
        services=(Service(sid=1, components=(
            ServiceComponent(tmid=0, subchid=1),)),
                  Service(sid=2, components=(
            ServiceComponent(tmid=0, subchid=9, ascty=63),))),
    )
    n_frames = 16
    x, payload_bytes = modulate(ens, n_frames, seed=7)

    # Stream in two pieces through two receiver instances with a
    # checkpoint/restore in between (SURVEY.md s5.4).
    rx1 = DabReceiver(n_frames=4)
    half = 9 * C.MODE_I.frame_size + 100
    eti = rx1.feed(x[:half])
    ckpt = rx1.checkpoint()
    leftover = rx1.pending_samples()

    rx2 = DabReceiver(n_frames=4)
    rx2.restore(ckpt)
    eti += rx2.feed(np.concatenate([leftover, x[half:]]))

    assert len(eti) >= 10
    frames = list(EtiParser().feed(b"".join(eti)))
    a = ckpt["activation_cif"]
    for k, f in enumerate(frames):
        n = a + k
        for sc in (1, 9):
            assert f.subchannel_data(sc) == payload_bytes[sc][n].tobytes(), \
                f"subch {sc} mismatch at CIF {n}"


def test_low_latency_single_frame_blocks():
    """n_frames=1 (96 ms latency mode) works: drift estimation degrades
    gracefully and payloads stay bit-exact."""
    ens = build_ensemble()
    x, payload_bytes = modulate(ens, 10, seed=77)
    rx = DabReceiver(n_frames=1)
    eti = rx.feed(x)
    assert rx.ensemble is not None
    assert len(eti) >= 4
    frames = list(EtiParser().feed(b"".join(eti)))
    a = rx._activation_cif
    for k, f in enumerate(frames):
        assert f.subchannel_data(1) == payload_bytes[1][a + k].tobytes(), k


def test_u8_feed_matches_cf32_feed():
    """Raw u8 IQ fed straight to the receiver (device-side conversion)
    produces byte-identical ETI to host-converted cf32 of the same bytes."""
    from dabtools_tpu.mod.impairments import quantize_u8, u8_to_complex

    ens = build_ensemble()
    x, _ = modulate(ens, 10, seed=3)
    u8 = quantize_u8(x)
    rx_u8 = DabReceiver(n_frames=4, ensemble=ens)
    rx_cf = DabReceiver(n_frames=4, ensemble=ens)
    # split across two feeds to exercise the chunked u8 ring (odd split)
    cut = 12345
    eti_u8 = rx_u8.feed(u8[:2 * cut + 1]) + rx_u8.feed(u8[2 * cut + 1:])
    eti_cf = rx_cf.feed(u8_to_complex(u8))
    assert eti_u8 and eti_u8 == eti_cf


def test_checkpoint_file_roundtrip_pickle_free(tmp_path):
    """save_checkpoint/load_checkpoint: mid-stream resume from the npz
    container stays bit-exact, and the file loads with pickle disabled."""
    ens = Ensemble(
        eid=0xD11D, label="CKPT FILE",
        subchannels=(Subchannel.eep(1, 0, 3, "A", 64),),
        services=(Service(sid=5, label="SVC", components=(
            ServiceComponent(tmid=0, subchid=1),)),),
    )
    x, payload_bytes = modulate(ens, 16, seed=21)
    rx1 = DabReceiver(n_frames=4)
    half = 9 * C.MODE_I.frame_size + 77
    eti = rx1.feed(x[:half])
    path = tmp_path / "rx.ckpt.npz"
    rx1.save_checkpoint(path)
    leftover = rx1.pending_samples()

    rx2 = DabReceiver.load_checkpoint(path, n_frames=4)
    assert rx2.ensemble == rx1.ensemble
    eti += rx2.feed(np.concatenate([leftover, x[half:]]))

    frames = list(EtiParser().feed(b"".join(eti)))
    assert len(frames) >= 10
    a = rx1._activation_cif
    for k, f in enumerate(frames):
        assert f.fct == k % 250      # FCT continuity across the resume
        assert f.subchannel_data(1) == payload_bytes[1][a + k].tobytes(), k
