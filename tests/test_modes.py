"""Closed-loop receiver tests for transmission Modes II, III, IV.

The upstream reference handles Mode I only (SURVEY.md s5.6); the other
modes share this framework's mode-generic pipeline with their own
numerology (constants.MODES), frequency interleaver (full-period LCG per
T_u) and PRS tables (reconstructed EN 300 401 Tables 45-47, [K-med] —
docs/INTEROP.md row 18; the modulator and receiver share them so the
loop is exact either way).

Mode III exercises the frame-spanning FIC codewords (4 FIBs/frame,
3 FIBs/codeword) — both directions must slice the same codeword stream.
"""

import numpy as np
import pytest

from dabtools_tpu import constants as C
from dabtools_tpu.eti.parse import EtiParser
from dabtools_tpu.fic.config import Ensemble, Service, ServiceComponent, Subchannel
from dabtools_tpu.fic.fig import build_fibs_for_ensemble
from dabtools_tpu.mod.modulator import Modulator, SubchannelSource
from dabtools_tpu.models.receiver import DabReceiver


def _ensemble(eid):
    return Ensemble(
        eid=eid, label="MODE TEST",
        subchannels=(Subchannel.eep(1, 0, 3, "A", 64),),
        services=(Service(sid=1, components=(
            ServiceComponent(tmid=0, subchid=1),)),))


def _modulate(ens, mode, n_frames, seed=0):
    rng = np.random.default_rng(seed)
    sub = ens.subchannels[0]
    mod = Modulator([SubchannelSource(0, sub.profile)], mode=mode)
    n_cifs = n_frames * mode.n_cifs
    payload = np.unpackbits(
        rng.integers(0, 256, size=(n_cifs, sub.data_bytes), dtype=np.uint8),
        axis=-1)
    x = mod.frames(
        n_frames,
        lambda f: build_fibs_for_ensemble(ens, f, n_fibs=mode.n_fibs),
        lambda f, i: payload[f * mode.n_cifs:(f + 1) * mode.n_cifs])
    return x, np.packbits(payload, axis=-1)


@pytest.mark.parametrize("mode_name,n_frames,block", [
    ("II", 28, 4),      # 1 CIF/frame: 16-CIF priming needs many frames
    ("III", 27, 6),     # FIC codewords span frames: block must be 3k
    ("IV", 16, 4),      # 2 CIFs/frame
])
def test_closed_loop_mode(mode_name, n_frames, block):
    mode = C.MODES[mode_name]
    ens = _ensemble(0x2000 + ord(mode_name[-1]))
    x, payload_bytes = _modulate(ens, mode, n_frames)
    rx = DabReceiver(n_frames=block, mode=mode)
    eti = rx.feed(x)
    assert rx.ensemble is not None and rx.ensemble.eid == ens.eid
    assert len(eti) >= 2
    frames = list(EtiParser(mode=mode).feed(b"".join(eti)))
    assert all(f.header_crc_ok and f.mst_crc_ok for f in frames)
    a = rx._activation_cif
    for k, f in enumerate(frames):
        assert f.subchannel_data(1) == payload_bytes[a + k].tobytes(), (
            f"Mode {mode_name}: ETI frame {k} payload mismatch")
    # FIC carried in the ETI parses back to the ensemble.
    from dabtools_tpu.fic.fig import FigParser
    fp = FigParser()
    for f in frames:
        for i in range(0, len(f.fic), 32):
            fp.feed_fib(f.fic[i:i + 32])
    assert fp.ensemble() is not None and fp.ensemble().eid == ens.eid


def test_mode_iii_block_alignment_enforced():
    mode = C.MODES["III"]
    with pytest.raises(Exception, match="multiple-of-3|codeword"):
        ens = _ensemble(0x2333)
        x, _ = _modulate(ens, mode, 9)
        DabReceiver(n_frames=4, mode=mode).feed(x)


def test_mode_iii_modulator_rejects_partial_codewords():
    mode = C.MODES["III"]
    ens = _ensemble(0x2334)
    with pytest.raises(ValueError, match="multiple of 3"):
        _modulate(ens, mode, 4)


def test_mode_tables_consistent():
    from dabtools_tpu.tables.freq_interleave import freq_interleave_map
    from dabtools_tpu.tables.prs import prs_carriers
    for name, mode in C.MODES.items():
        assert freq_interleave_map(mode).shape == (mode.n_carriers,)
        z = prs_carriers(mode)
        assert z.shape == (mode.n_carriers,)
        np.testing.assert_allclose(np.abs(z), 1.0, rtol=1e-6)
        # 24 ms-multiple frame duration at 2.048 Msps
        assert mode.frame_size % (C.SAMPLE_RATE * 24 // 1000) == 0


def test_mode_iii_merged_dispatch_matches_xla(monkeypatch):
    """Mode III through the GPU kernel's ragged path (interpret mode):
    FIC codewords SPAN frames (4 FIBs/frame, block=3k), so the merged
    FIC+MSC launch must slice the block's whole FIC stream correctly.
    Byte-compare vs the XLA scan."""
    import functools

    from dabtools_tpu.models import receiver as R
    from dabtools_tpu.ops import viterbi as V

    mode = C.MODES["III"]
    ens = _ensemble(0x3333)
    x, payload_bytes = _modulate(ens, mode, 27)
    rx_ref = DabReceiver(n_frames=6, mode=mode)
    eti_ref = rx_ref.feed(x)
    assert eti_ref

    monkeypatch.setattr(R, "viterbi_decode_ragged", functools.partial(
        V.viterbi_decode_ragged, interpret=True))
    R.process_block.clear_cache()
    try:
        rx = DabReceiver(n_frames=6, mode=mode)
        eti = rx.feed(x)
    finally:
        R.process_block.clear_cache()
    assert eti == eti_ref
