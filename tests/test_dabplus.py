import numpy as np
import pytest

from dabtools_tpu import constants as C
from dabtools_tpu.eti.dabplus import (
    AccessUnit,
    SuperframeBuilder,
    SuperframeConfig,
    SuperframeDecoder,
    adts_wrap,
)
from dabtools_tpu.utils.gf256 import rs_decode, rs_encode


class TestRS:
    def test_roundtrip_and_correction(self):
        rng = np.random.default_rng(0)
        data = rng.integers(0, 256, size=(4, C.RS_K), dtype=np.uint8)
        cw = rs_encode(data)
        assert cw.shape == (4, C.RS_N)
        corrupted = cw.copy()
        for row in range(4):
            pos = rng.choice(C.RS_N, size=row + 1, replace=False)
            for p in pos:
                corrupted[row, p] ^= rng.integers(1, 256)
        dec, counts = rs_decode(corrupted)
        assert counts.tolist() == [1, 2, 3, 4]
        np.testing.assert_array_equal(dec, data)

    def test_uncorrectable_flagged(self):
        rng = np.random.default_rng(1)
        cw = rs_encode(rng.integers(0, 256, C.RS_K, dtype=np.uint8))
        bad = cw.copy()
        for p in rng.choice(C.RS_N, size=8, replace=False):
            bad[p] ^= rng.integers(1, 256)
        _, n = rs_decode(bad)
        assert n == -1


def _make_aus(builder, rng):
    return [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            for n in builder.au_sizes()]


class TestSuperframe:
    @pytest.mark.parametrize("dac_rate,sbr", [(1, 1), (0, 0), (1, 0), (0, 1)])
    def test_builder_decoder_roundtrip(self, dac_rate, sbr):
        rng = np.random.default_rng(2)
        cfg = SuperframeConfig(dac_rate=dac_rate, sbr_flag=sbr)
        b = SuperframeBuilder(64, cfg)
        aus = _make_aus(b, rng)
        frames = b.build(aus)
        assert frames.shape == (5, 192)

        dec = SuperframeDecoder(64)
        got = []
        for f in frames:
            got.extend(dec.feed(f.tobytes()))
        assert len(got) == cfg.num_aus
        for i, au in enumerate(got):
            assert au.crc_ok
            assert au.data == aus[i]
        assert dec.config.num_aus == cfg.num_aus
        assert dec.config.sample_rate == cfg.sample_rate

    def test_phase_sync_with_offset_start(self):
        """Decoder finds the 5-frame phase when fed mid-superframe."""
        rng = np.random.default_rng(3)
        b = SuperframeBuilder(64)
        dec = SuperframeDecoder(64)
        all_aus, got = [], []
        frames = []
        for _ in range(4):
            aus = _make_aus(b, rng)
            all_aus.append(aus)
            frames.extend(b.build(aus))
        for f in frames[2:]:           # start 2 frames into superframe 0
            got.extend(dec.feed(np.asarray(f).tobytes()))
        # superframe 0 is unrecoverable; 1..3 decode fully
        assert len(got) == 3 * b.cfg.num_aus
        assert all(a.crc_ok for a in got)
        assert [a.data for a in got[:b.cfg.num_aus]] == list(all_aus[1])

    def test_byte_errors_corrected_by_rs(self):
        rng = np.random.default_rng(4)
        b = SuperframeBuilder(96)
        aus = _make_aus(b, rng)
        frames = b.build(aus).reshape(-1).copy()
        # exactly 5 byte errors in each of 6 RS columns (the max t=5)
        n_cols = b.n_cols
        for col in range(6):
            for row in rng.choice(C.RS_N, size=5, replace=False):
                frames[row * n_cols + col] ^= rng.integers(1, 256)
        dec = SuperframeDecoder(96)
        got = []
        for f in frames.reshape(5, -1):
            got.extend(dec.feed(f.tobytes()))
        assert len(got) == b.cfg.num_aus
        assert all(a.crc_ok for a in got)
        assert dec.stats["rs_corrected"] >= 25

    def test_adts_wrap(self):
        cfg = SuperframeConfig(dac_rate=1, sbr_flag=1)
        au = b"\x01\x02\x03\x04"
        adts = adts_wrap(au, cfg)
        assert adts[:2] == b"\xff\xf1"
        assert len(adts) == len(au) + 7
        frame_len = ((adts[3] & 0x03) << 11) | (adts[4] << 3) | (adts[5] >> 5)
        assert frame_len == len(adts)


def test_modulate_ensemble_carries_dabplus_superframes():
    """The shared modulator helper: the DAB+ sub-channel's payload rows
    are real superframes whose access units decode, in order, to the AUs
    it returns; the other sub-channel carries random bytes."""
    from dabtools_tpu.fic.config import (Ensemble, Service,
                                         ServiceComponent, Subchannel)
    from dabtools_tpu.mod.modulator import modulate_ensemble

    ens = Ensemble(
        eid=0xD0D0, label="DAB+ HELPER",
        subchannels=(Subchannel.eep(0, 0, 3, "A", 64),
                     Subchannel.eep(1, 48, 3, "A", 72)),
        services=(Service(sid=2, components=(
            ServiceComponent(tmid=0, subchid=1, ascty=63),)),))
    x, payload, aus = modulate_ensemble(ens, 6, seed=3, dabplus_subch=1)
    assert x.dtype == np.complex64 and x.size == 6 * C.MODE_I.frame_size
    assert payload[0].shape == (24, ens.subchannel(0).data_bytes)
    sfd = SuperframeDecoder(72)
    got = [au for row in payload[1] for au in sfd.feed(row.tobytes())]
    assert got and all(au.crc_ok for au in got)
    assert [au.data for au in got] == aus[: len(got)]
