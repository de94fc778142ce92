import numpy as np
import pytest

from dabtools_tpu import constants as C
from dabtools_tpu.eti.assemble import EtiAssembler, tpl_for_subchannel
from dabtools_tpu.eti.parse import EtiParser
from dabtools_tpu.fic.config import Ensemble, Service, ServiceComponent, Subchannel
from dabtools_tpu.fic.fig import FigParser, build_fibs_for_ensemble
from dabtools_tpu.utils.crc import crc16_ok


def example_ensemble():
    return Ensemble(
        eid=0x4FFF,
        label="TEST DAB",
        subchannels=(
            Subchannel.eep(1, 0, 3, "A", 64),      # 48 CUs
            Subchannel.eep(5, 48, 1, "B", 96),     # 81 CUs
        ),
        services=(
            Service(sid=0x1234, label="SVC ONE", components=(
                ServiceComponent(tmid=0, subchid=1, ascty=0),)),
            Service(sid=0x5678, label="SVC TWO", components=(
                ServiceComponent(tmid=0, subchid=5, ascty=63),)),
        ),
    )


class TestFigRoundtrip:
    def test_fibs_have_valid_crcs(self):
        fibs = build_fibs_for_ensemble(example_ensemble(), 0)
        assert fibs.shape == (12, 32)
        for i in range(12):
            assert crc16_ok(fibs[i].tobytes())

    def test_parse_recovers_config(self):
        ens = example_ensemble()
        fibs = build_fibs_for_ensemble(ens, frame_idx=7)
        parser = FigParser()
        for i in range(12):
            parser.feed_fib(fibs[i].tobytes())
        got = parser.ensemble()
        assert got is not None
        assert got.eid == ens.eid
        assert got.label == ens.label
        assert got.subchannels == ens.subchannels
        assert {s.sid for s in got.services} == {0x1234, 0x5678}
        svc = {s.sid: s for s in got.services}
        assert svc[0x1234].label == "SVC ONE"
        assert svc[0x5678].components[0].is_dabplus
        assert parser.cif_count == 7 * 4

    def test_bad_crc_fib_rejected(self):
        fibs = build_fibs_for_ensemble(example_ensemble(), 0)
        parser = FigParser()
        bad = fibs[0].copy()
        bad[5] ^= 0xFF
        parser.feed_fib(bad.tobytes())
        assert parser.fibs_bad == 1 and parser.fibs_ok == 0
        assert parser.ensemble() is None

    def test_uep_subchannel_roundtrip(self):
        ens = Ensemble(eid=1, subchannels=(Subchannel.uep(3, 100, 35),))
        fibs = build_fibs_for_ensemble(ens, 0)
        parser = FigParser()
        for i in range(12):
            parser.feed_fib(fibs[i].tobytes())
        got = parser.ensemble().subchannels[0]
        assert got.protection_type == "UEP"
        assert got.uep_table_index == 35
        assert got.bitrate_kbps == 128
        assert got.size_cus == 96


class TestEtiRoundtrip:
    def _roundtrip(self, n_frames=3):
        ens = example_ensemble()
        asm = EtiAssembler(ens)
        rng = np.random.default_rng(0)
        sent = []
        raw = b""
        for n in range(n_frames):
            fibs = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
                    for _ in range(3)]
            data = {s.subchid: rng.integers(0, 256, s.data_bytes,
                                            dtype=np.uint8).tobytes()
                    for s in ens.subchannels}
            sent.append((fibs, data))
            raw += asm.frame(fibs, data)
        return ens, sent, raw

    def test_frame_size_and_parse(self):
        ens, sent, raw = self._roundtrip()
        assert len(raw) == 3 * C.ETI_FRAME_BYTES
        frames = list(EtiParser().feed(raw))
        assert len(frames) == 3
        for n, (f, (fibs, data)) in enumerate(zip(frames, sent)):
            assert f.header_crc_ok and f.mst_crc_ok
            assert f.err == 0xFF
            assert f.fct == n
            assert f.mid == 1
            assert f.fic == b"".join(fibs)
            for s in ens.subchannels:
                assert f.subchannel_data(s.subchid) == data[s.subchid]

    def test_resync_after_garbage(self):
        _, sent, raw = self._roundtrip()
        parser = EtiParser()
        garbled = b"\xde\xad\xbe\xef" * 300 + raw
        frames = list(parser.feed(garbled))
        assert len(frames) == 3
        assert parser.resyncs >= 1
        assert frames[0].fic == b"".join(sent[0][0])

    def test_streaming_feed_in_chunks(self):
        _, _, raw = self._roundtrip()
        parser = EtiParser()
        frames = []
        for i in range(0, len(raw), 1000):
            frames.extend(parser.feed(raw[i:i + 1000]))
        assert len(frames) == 3

    def test_tpl_encoding(self):
        # 6-bit TPL: EEP = 0b1 option(3) level-1(2); UEP = 0b0 index(5)
        assert tpl_for_subchannel(Subchannel.eep(0, 0, 3, "A", 64)) == 0x22
        assert tpl_for_subchannel(Subchannel.eep(0, 0, 1, "B", 32)) == 0x24
        assert tpl_for_subchannel(Subchannel.uep(0, 0, 20)) == 20
        # indexes beyond the 5-bit field clamp (display-only field)
        assert tpl_for_subchannel(Subchannel.uep(0, 0, 35)) == 0x1F

    def test_stc_wide_stl_roundtrip(self):
        """A >255-word sub-channel (legal up to 864 CUs) needs the 10-bit
        STL field; 8 bits silently truncated it (review finding)."""
        from dabtools_tpu.eti.parse import EtiParser
        ens = Ensemble(
            eid=1, subchannels=(Subchannel.eep(3, 0, 3, "A", 864),))
        assert ens.subchannels[0].data_bytes // 8 == 324   # words > 255
        asm = EtiAssembler(ens)
        rng = np.random.default_rng(0)
        data = rng.integers(0, 256, ens.subchannels[0].data_bytes,
                            dtype=np.uint8).tobytes()
        fibs = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
                for _ in range(3)]
        frame = next(iter(EtiParser().feed(asm.frame(fibs, {3: data}))))
        assert frame.streams[3].stl_words == len(data) // 8
        assert frame.subchannel_data(3) == data

    def test_wrong_subch_size_rejected(self):
        ens = example_ensemble()
        asm = EtiAssembler(ens)
        fibs = [b"\x00" * 32] * 3
        with pytest.raises(ValueError):
            asm.frame(fibs, {1: b"\x00" * 10, 5: b"\x00" * 288})


def test_fp_counter_continuous_across_fct_wrap():
    """FP is mod-8 continuous even when FCT wraps at 250 (ETS 300 799)."""
    ens = Ensemble(eid=1, subchannels=(Subchannel.eep(1, 0, 3, "A", 8),))
    asm = EtiAssembler(ens)
    fibs = [b"\x00" * 32] * 3
    data = {1: b"\x00" * 24}
    fps, fcts = [], []
    for _ in range(252):
        f = next(iter(EtiParser().feed(asm.frame(fibs, data))))
        fps.append(f.fp)
        fcts.append(f.fct)
    assert fcts[249] == 249 and fcts[250] == 0
    for i in range(1, 252):
        assert fps[i] == (fps[i - 1] + 1) % 8, f"FP discontinuity at {i}"


def test_fig_splitting_supports_flagship_mux():
    """9 sub-channels + 9 services need multiple FIG 0/1 / 0/2 per frame."""
    import sys, pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
    from __graft_entry__ import _flagship_ensemble
    ens = _flagship_ensemble()
    fibs = build_fibs_for_ensemble(ens, 0)
    parser = FigParser()
    for i in range(12):
        parser.feed_fib(fibs[i].tobytes())
    got = parser.ensemble()
    assert got.subchannels == ens.subchannels
    assert len(got.services) == 9


def test_malformed_fig_does_not_crash_parser():
    """CRC-valid but semantically invalid FIGs must degrade to a counter
    (a corrupt FIB passes CRC16 with p~2^-16; real muxes may signal
    combinations we don't model)."""
    from dabtools_tpu.utils.crc import crc16_ccitt
    # FIG 0/1 long form with size 7 CUs, level 1-A: no valid EEP bitrate
    body = bytes([0x01,                      # CN/OE/PD=0, ext=1
                  (9 << 2) | 0,              # subchid=9, start hi
                  0,                         # start lo
                  0b10000000 | 0b0000000,    # long form, option 0, lvl...
                  7])                        # size=7 (invalid for EEP 1-A)
    fig = bytes([0x00 | len(body)]) + body
    payload = (fig + b"\xff").ljust(30, b"\x00")
    fib = payload + crc16_ccitt(payload).to_bytes(2, "big")
    p = FigParser()
    p.feed_fib(fib)                          # must not raise
    assert p.figs_malformed == 1
    assert p.ensemble() is None


class TestTist:
    """TIST timestamping (ETS 300 799; 1/16.384 MHz ticks, 24 ms/frame)."""

    def _frames(self, asm, n):
        ens = asm.ensemble
        rng = np.random.default_rng(1)
        raw = b""
        for _ in range(n):
            fibs = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
                    for _ in range(3)]
            data = {s.subchid: rng.integers(0, 256, s.data_bytes,
                                            dtype=np.uint8).tobytes()
                    for s in ens.subchannels}
            raw += asm.frame(fibs, data)
        return list(EtiParser().feed(raw))

    def test_disabled_by_default(self):
        frames = self._frames(EtiAssembler(example_ensemble()), 2)
        assert all(f.tist is None and f.tist_seconds is None for f in frames)

    def test_ticks_advance_24ms(self):
        from dabtools_tpu.eti.assemble import TIST_TICKS_PER_FRAME
        frames = self._frames(
            EtiAssembler(example_ensemble(), tist_start=0.1), 4)
        assert frames[0].tist == int(0.1 * 16_384_000)
        for a, b in zip(frames, frames[1:]):
            assert b.tist - a.tist == TIST_TICKS_PER_FRAME
        assert all(f.header_crc_ok and f.mst_crc_ok for f in frames)

    def test_wraps_at_one_second(self):
        from dabtools_tpu.eti.assemble import (TIST_TICKS_PER_FRAME,
                                               TIST_TICKS_PER_SEC)
        frames = self._frames(
            EtiAssembler(example_ensemble(), tist_start=0.99), 2)
        assert frames[1].tist == (frames[0].tist
                                  + TIST_TICKS_PER_FRAME) % TIST_TICKS_PER_SEC
        assert frames[1].tist < frames[0].tist

    def test_python_and_native_paths_agree(self):
        from dabtools_tpu.utils import native
        if native.lib() is None:
            import pytest
            pytest.skip("native library unavailable")
        frames = self._frames(
            EtiAssembler(example_ensemble(), tist_start=0.5), 1)
        assert abs(frames[0].tist_seconds - 0.5) < 1e-6


class TestFig013:
    """User application signalling (slideshow discovery, EN 300 401 6.3.6)."""

    def test_roundtrip(self):
        ens = Ensemble(
            eid=7, label="UA",
            subchannels=(Subchannel.eep(1, 0, 3, "A", 64),),
            services=(Service(sid=0x42, components=(
                ServiceComponent(tmid=0, subchid=1, user_apps=(2,)),)),))
        fibs = build_fibs_for_ensemble(ens, 0)
        parser = FigParser()
        for i in range(12):
            parser.feed_fib(fibs[i].tobytes())
        got = parser.ensemble()
        comp = got.services[0].components[0]
        assert comp.user_apps == (2,)

    def test_order_independent(self):
        """FIG 0/13 arriving before FIG 0/2 still attaches."""
        parser = FigParser()
        ens = Ensemble(
            eid=8,
            subchannels=(Subchannel.eep(1, 0, 3, "A", 64),),
            services=(Service(sid=0x43, components=(
                ServiceComponent(tmid=0, subchid=1, user_apps=(2, 5)),)),))
        fibs = build_fibs_for_ensemble(ens, 0)
        # Feed in reverse so 0/13 (later FIB or later FIG) ordering varies.
        for i in reversed(range(12)):
            parser.feed_fib(fibs[i].tobytes())
        comp = parser.ensemble().services[0].components[0]
        assert comp.user_apps == (2, 5)


def test_big_mux_mci_spreads_across_frames():
    """A 24-service mux (more MCI than one frame's FIBs can hold) builds
    without error; the parser accumulates the full ensemble over a few
    frames, as with real multi-frame MCI."""
    from dabtools_tpu.fic.config import Ensemble, Service, ServiceComponent, Subchannel
    from dabtools_tpu.fic.fig import FigParser, build_fibs_for_ensemble

    subs = tuple(Subchannel.eep(i, 36 * i, 3, "A", 48) for i in range(24))
    svcs = tuple(Service(sid=0x4000 + i, label=f"SERVICE {i:02d}",
                         components=(ServiceComponent(tmid=0, subchid=i),))
                 for i in range(24))
    ens = Ensemble(eid=0xBEEF, label="BIG MUX", subchannels=subs,
                   services=svcs)
    fp = FigParser()
    got = None
    for f in range(16):
        fibs = build_fibs_for_ensemble(ens, f)
        assert fibs.shape == (12, 32)
        for fib in fibs:
            fp.feed_fib(fib.tobytes())
        got = fp.ensemble()
        if (got is not None and len(got.subchannels) == 24
                and len(got.services) == 24):
            break
    assert got is not None
    assert {s.subchid for s in got.subchannels} == set(range(24))
    assert {s.sid for s in got.services} == {0x4000 + i for i in range(24)}
    # every frame still carries FIG 0/0 (the parser always sees the eid)
    assert got.eid == 0xBEEF


class TestComponentAndXpadLabels:
    """FIG 1/4 (service component label) + FIG 1/6 (X-PAD app label)."""

    def _ens(self):
        return Ensemble(
            eid=0x4FFF, label="LBL MUX",
            subchannels=(Subchannel.eep(1, 0, 3, "A", 64),
                         Subchannel.eep(5, 48, 1, "B", 96)),
            services=(
                Service(sid=0x1234, label="SVC ONE", components=(
                    ServiceComponent(tmid=0, subchid=1, ascty=0,
                                     label="MAIN AUDIO"),)),
                Service(sid=0x5678, label="SVC TWO", components=(
                    ServiceComponent(tmid=0, subchid=5, ascty=63),
                    ServiceComponent(tmid=0, subchid=1, ascty=0,
                                     primary=False, label="SECONDARY"),))))

    def _parse_frames(self, ens, n_frames=6, extra_figs=()):
        parser = FigParser()
        for t in range(n_frames):
            fibs = build_fibs_for_ensemble(ens, t, extra_figs=extra_figs)
            for i in range(fibs.shape[0]):
                parser.feed_fib(fibs[i].tobytes())
        return parser

    def test_fig_1_4_roundtrip(self):
        parser = self._parse_frames(self._ens())
        out = parser.ensemble()
        by_sid = {s.sid: s for s in out.services}
        assert by_sid[0x1234].components[0].label == "MAIN AUDIO"
        assert by_sid[0x5678].components[0].label == ""
        assert by_sid[0x5678].components[1].label == "SECONDARY"

    def test_fig_1_4_data_service_32bit_sid(self):
        from dabtools_tpu.fic.fig import fig_1_4
        fig = fig_1_4(0xE1C00042, "EPG DATA", scids=0, pd=True)
        parser = FigParser()
        payload = fig + b"\xff"
        payload = payload.ljust(30, b"\x00")
        from dabtools_tpu.utils.crc import crc16_ccitt
        parser.feed_fib(payload + crc16_ccitt(payload).to_bytes(2, "big"))
        assert parser.component_labels[(0xE1C00042, 0)] == "EPG DATA"

    def test_fig_1_6_roundtrip(self):
        from dabtools_tpu.fic.fig import fig_1_6
        ens = self._ens()
        parser = self._parse_frames(
            ens, extra_figs=(fig_1_6(0x1234, 2, "NOW PLAYING"),
                             fig_1_6(0xE1C00042, 12, "SLIDES", pd=True)))
        assert parser.xpad_labels[(0x1234, 0, 2)] == "NOW PLAYING"
        assert parser.xpad_labels[(0xE1C00042, 0, 12)] == "SLIDES"

    def test_fig_1_4_scids_resolves_via_fig_0_8(self):
        """When FIG 0/8 maps the SCIdS to a transport, attachment follows
        the transport, not the component index."""
        from dabtools_tpu.fic.fig import fig_1_4
        parser = self._parse_frames(self._ens())
        # Point SCIdS 9 at subch 5 (SVC TWO's first component) via the
        # parser's FIG 0/8 map, then label SCIdS 9.
        parser.scids_map[(0x5678, 9)] = ("subch", 5)
        fig = fig_1_4(0x5678, "VIA 0/8", scids=9)
        payload = (fig + b"\xff").ljust(30, b"\x00")
        from dabtools_tpu.utils.crc import crc16_ccitt
        parser.feed_fib(payload + crc16_ccitt(payload).to_bytes(2, "big"))
        out = parser.ensemble()
        by_sid = {s.sid: s for s in out.services}
        assert by_sid[0x5678].components[0].label == "VIA 0/8"
