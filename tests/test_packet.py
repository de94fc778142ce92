"""MSC packet mode (EN 300 401 s5.3.2): packet transport round-trips,
FIG 0/2 pd=1 + FIG 0/3 signalling, and the full RF closed loop carrying a
packet-mode MOT service (beyond-reference: upstream dabtools is
stream-audio only)."""

import numpy as np
import pytest

from dabtools_tpu import constants as C
from dabtools_tpu.eti.mot import MotDecoder, MotEncoder
from dabtools_tpu.eti.packet import (
    PACKET_SIZES,
    PacketDecoder,
    PacketEncoder,
    build_packet,
    padding_packet,
)
from dabtools_tpu.fic.config import (
    Ensemble,
    PacketComponent,
    Service,
    ServiceComponent,
    Subchannel,
)
from dabtools_tpu.fic.fig import FigParser, build_fibs_for_ensemble


def test_packet_sizes_and_padding():
    for size in PACKET_SIZES:
        p = build_packet(5, b"hi", 0, True, True, size)
        assert len(p) == size
    assert len(padding_packet()) == 24


def _roundtrip(dgs, packet_size=96, frame_bytes=96, chunk=17):
    enc = PacketEncoder(address=5, packet_size=packet_size)
    for dg in dgs:
        enc.add_data_group(dg)
    stream = bytearray()
    while enc.pending_bytes:
        stream += enc.take_frame(frame_bytes)
    stream += enc.take_frame(frame_bytes)          # a pure-padding frame
    dec = PacketDecoder()
    got = []
    for i in range(0, len(stream), chunk):          # straddling feeds
        got += dec.feed(bytes(stream[i:i + chunk]))
    return got, dec


@pytest.mark.parametrize("packet_size", PACKET_SIZES)
def test_packet_roundtrip(packet_size):
    rng = np.random.default_rng(1)
    dgs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
           for n in (1, 19, 91, 400, 2000)]
    got, dec = _roundtrip(dgs, packet_size)
    assert [d for _, d in got] == dgs
    assert all(a == 5 for a, _ in got)
    assert dec.stats["crc_failures"] == 0
    assert dec.stats["continuity_errors"] == 0
    assert dec.stats["padding"] > 0


def test_packet_resync_after_corruption():
    rng = np.random.default_rng(2)
    dgs = [rng.integers(0, 256, 200, dtype=np.uint8).tobytes()
           for _ in range(3)]
    enc = PacketEncoder(address=9, packet_size=48)
    for dg in dgs:
        enc.add_data_group(dg)
    stream = bytearray(enc.take_frame(((enc.pending_bytes + 23) // 24) * 24))
    stream[60] ^= 0xFF                  # corrupt inside the first group
    dec = PacketDecoder()
    got = dec.feed(bytes(stream))
    # first group lost, later groups recovered after byte-level resync
    assert dgs[-1] in [d for _, d in got]
    assert dec.stats["crc_failures"] >= 1


def test_packet_continuity_gap_drops_group():
    rng = np.random.default_rng(3)
    dg = rng.integers(0, 256, 500, dtype=np.uint8).tobytes()
    enc = PacketEncoder(address=1, packet_size=24)
    enc.add_data_group(dg)
    packets = list(enc._queue)
    del packets[3]                      # lose one mid-group packet
    enc2 = PacketEncoder(address=1, packet_size=24)
    enc2.add_data_group(b"after")
    dec = PacketDecoder()
    got = dec.feed(b"".join(packets) + b"".join(enc2._queue))
    assert [d for _, d in got] == [b"after"]
    assert dec.stats["continuity_errors"] == 1


def test_packet_addresses_interleave():
    a = PacketEncoder(address=2, packet_size=24)
    b = PacketEncoder(address=3, packet_size=24)
    a.add_data_group(b"A" * 100)
    b.add_data_group(b"B" * 100)
    mixed = bytearray()
    while a._queue or b._queue:         # alternate packets of two groups
        for e in (a, b):
            if e._queue:
                mixed += e._queue.pop(0)
    got = PacketDecoder().feed(bytes(mixed))
    assert sorted(got) == [(2, b"A" * 100), (3, b"B" * 100)]


def _packet_ensemble():
    return Ensemble(
        eid=0x4001, label="PKT TEST",
        subchannels=(Subchannel.eep(1, 0, 3, "A", 64),
                     Subchannel.eep(2, 48, 3, "A", 32)),
        services=(
            Service(sid=0x1001, label="AUDIO", components=(
                ServiceComponent(tmid=0, subchid=1),)),
            Service(sid=0xE1C00042, label="DATA SVC", components=(
                ServiceComponent(tmid=3, subchid=-1, scid=7,
                                 user_apps=(7,)),)),    # 7 = EPG
        ),
        packet_components=(
            PacketComponent(scid=7, subchid=2, address=0x21, dscty=60),),
    )


def test_fig_packet_signalling_roundtrip():
    ens = _packet_ensemble()
    p = FigParser()
    for f in range(4):
        for fib in build_fibs_for_ensemble(ens, f):
            p.feed_fib(fib.tobytes())
    got = p.ensemble()
    assert got.eid == ens.eid
    assert got.subchannels == ens.subchannels
    assert got.packet_components == ens.packet_components
    data_svc = next(s for s in got.services if s.sid == 0xE1C00042)
    comp = data_svc.components[0]
    assert comp.tmid == 3 and comp.scid == 7
    # FIG 0/13 pd=1 apps land on the component FIG 0/8 maps via SCId
    assert comp.user_apps == (7,)
    assert data_svc.label == "DATA SVC"
    pc = got.packet_component(7)
    assert (pc.subchid, pc.address, pc.dscty, pc.dg) == (2, 0x21, 60, True)


def test_packet_mot_closed_loop():
    """Full RF loop: MOT carousel -> packets -> modulated sub-channel ->
    DabReceiver -> ETI -> packet decode -> MOT objects bit-exact."""
    from dabtools_tpu.eti.parse import EtiParser
    from dabtools_tpu.fic.fig import build_fibs_for_ensemble as fibs_for
    from dabtools_tpu.mod.modulator import Modulator, SubchannelSource
    from dabtools_tpu.models.receiver import DabReceiver

    ens = _packet_ensemble()
    pc = ens.packet_component(7)
    sub = ens.subchannel(pc.subchid)

    rng = np.random.default_rng(4)
    objects = [("logo.png", rng.integers(0, 256, 310, dtype=np.uint8)
                .tobytes()),
               ("news.txt", b"packet mode over GPU decode " * 10)]
    mot = MotEncoder(seg_size=64)
    enc = PacketEncoder(address=pc.address, packet_size=96)
    for dg in mot.carousel_groups(objects):
        enc.add_data_group(dg)

    n_frames = 14
    frame_bytes = sub.data_bytes
    pkt_frames = [enc.take_frame(frame_bytes)
                  for _ in range(n_frames * C.MODE_I.n_cifs)]
    assert enc.pending_bytes == 0, "carousel must fit the test stream"

    order = [s.subchid for s in ens.sorted_subchannels()]
    n_cifs = n_frames * C.MODE_I.n_cifs
    audio = np.unpackbits(rng.integers(
        0, 256, (n_cifs, ens.subchannel(1).data_bytes), dtype=np.uint8),
        axis=-1)

    def payload_fn(f, i):
        if order[i] == pc.subchid:
            rows = [np.unpackbits(np.frombuffer(
                pkt_frames[f * 4 + k], dtype=np.uint8))
                for k in range(4)]
            return np.stack(rows)
        return audio[f * 4:(f + 1) * 4]

    mod = Modulator([SubchannelSource(s.start_cu, s.profile)
                     for s in ens.sorted_subchannels()])
    x = mod.frames(n_frames, lambda f: fibs_for(ens, f), payload_fn)

    rx = DabReceiver(n_frames=4)
    eti = rx.feed(x)
    assert rx.ensemble is not None
    assert rx.ensemble.packet_components == ens.packet_components
    assert len(eti) > 0

    pdec = PacketDecoder()
    mdec = MotDecoder()
    got: list = []
    for frame in EtiParser().feed(b"".join(eti)):
        for addr, dg in pdec.feed(frame.subchannel_data(pc.subchid)):
            if addr == pc.address:
                got += mdec.feed_data_group(dg)
    assert pdec.stats["crc_failures"] == 0
    names = {o.name: o.body for o in got}
    for name, body in objects:
        assert names.get(name) == body, f"object {name} mismatch"


# ----------------------------------------------------------- CLI surface
def test_eti2audio_packet_service_cli(tmp_path):
    """eti2audio on a packet-mode service: emits the MSC data groups and
    decodes MOT objects into --objects DIR (host-assembled ETI)."""
    import subprocess
    import sys

    from dabtools_tpu.eti.assemble import EtiAssembler

    ens = _packet_ensemble()
    pc = ens.packet_component(7)
    sub = ens.subchannel(pc.subchid)

    rng = np.random.default_rng(5)
    objects = [("weather.png", rng.integers(0, 256, 256, dtype=np.uint8)
                .tobytes()),
               ("epg.bin", b"\x01\x02" * 150)]
    mot = MotEncoder(seg_size=64)
    enc = PacketEncoder(address=pc.address, packet_size=96)
    for dg in mot.carousel_groups(objects):
        enc.add_data_group(dg)

    asm = EtiAssembler(ens)
    n_cifs = 40
    audio = rng.integers(0, 256, (n_cifs, ens.subchannel(1).data_bytes),
                         dtype=np.uint8)
    eti = bytearray()
    for n in range(n_cifs):
        fibs = [f.tobytes()
                for f in build_fibs_for_ensemble(ens, n // 4)[
                    3 * (n % 4): 3 * (n % 4) + 3]]
        eti += asm.frame(fibs, {
            1: audio[n].tobytes(),
            pc.subchid: enc.take_frame(sub.data_bytes)})
    src = tmp_path / "pkt.eti"
    src.write_bytes(bytes(eti))

    r = subprocess.run(
        [sys.executable, "-m", "dabtools_tpu.cli.eti2audio", "--list",
         str(src)], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "0xE1C00042" in r.stdout and "packet" in r.stdout
    assert "addr 0x021" in r.stdout

    outdir = tmp_path / "objects"
    dgs_out = tmp_path / "groups.bin"
    r = subprocess.run(
        [sys.executable, "-m", "dabtools_tpu.cli.eti2audio",
         "--sid", "0xE1C00042", "--objects", str(outdir), str(src),
         "-o", str(dgs_out)],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "packet sub-channel 2 address 0x021" in r.stderr
    assert dgs_out.stat().st_size > 0
    written = {p.name: p.read_bytes() for p in outdir.iterdir()}
    for name, body in objects:
        assert written.get(name) == body, f"object {name} mismatch"


def test_fig_time_and_lto_roundtrip():
    """FIG 0/9 (ECC/LTO) + FIG 0/10 (date & time) build -> parse."""
    import datetime

    from dabtools_tpu.fic.fig import fig_0_9, fig_0_10

    ens = _packet_ensemble()
    t = datetime.datetime(2026, 8, 17, 23, 41, 7, 250000)
    extra = (fig_0_9(lto_half_hours=-2, ecc=0xE1, table_id=1), fig_0_10(t))
    p = FigParser()
    for f in range(4):
        for fib in build_fibs_for_ensemble(ens, f, extra_figs=extra):
            p.feed_fib(fib.tobytes())
    assert p.figs_malformed == 0
    assert (p.ecc, p.lto_half_hours, p.intl_table) == (0xE1, -2, 1)
    assert p.utc == t
    # MJD sanity against a known anchor: 2000-01-01 = MJD 51544
    assert (datetime.date(2000, 1, 1).toordinal()
            - datetime.date(1858, 11, 17).toordinal()) == 51544


def test_take_frame_rejects_oversized_packets():
    """A queue head that can never fit the frame must raise, not spin the
    standard `while pending_bytes` drain loop forever."""
    enc = PacketEncoder(address=1, packet_size=96)
    enc.add_data_group(b"x" * 200)
    with pytest.raises(ValueError, match="exceeds"):
        enc.take_frame(72)


def test_command_packet_advances_continuity():
    """A command packet (e.g. CA) inside a data group advances the
    address's continuity chain; the group must still assemble."""
    enc = PacketEncoder(address=6, packet_size=24)
    enc.add_data_group(b"D" * 40)            # 3 packets: cont 0,1,2
    packets = list(enc._queue)
    cmd = build_packet(6, b"", 1, False, False, 24, command=True)
    # fix continuity: cmd took index 1, so shift the data packets after it
    p1 = bytearray(packets[1]); p1[0] = (p1[0] & 0xCF) | (2 << 4)
    p2 = bytearray(packets[2]); p2[0] = (p2[0] & 0xCF) | (3 << 4)
    from dabtools_tpu.utils.crc import crc16_ccitt
    for p in (p1, p2):
        p[-2:] = crc16_ccitt(bytes(p[:-2])).to_bytes(2, "big")
    dec = PacketDecoder()
    got = dec.feed(packets[0] + cmd + bytes(p1) + bytes(p2))
    assert got == [(6, b"D" * 40)]
    assert dec.stats["command"] == 1
    assert dec.stats["continuity_errors"] == 0


def test_malformed_useful_length_dropped():
    """A CRC-aliased header claiming more useful bytes than the data
    field holds must be dropped, never leak padding/CRC into a group."""
    p = bytearray(build_packet(7, b"hi", 0, True, True, 24))
    p[2] = 120                               # useful length > 24 - 5
    from dabtools_tpu.utils.crc import crc16_ccitt
    p[-2:] = crc16_ccitt(bytes(p[:-2])).to_bytes(2, "big")
    dec = PacketDecoder()
    assert dec.feed(bytes(p)) == []
    assert dec.stats["malformed"] == 1


def test_eti2audio_all_includes_packet_service(tmp_path):
    """--all also extracts packet data services' MOT objects."""
    import subprocess
    import sys

    from dabtools_tpu.eti.assemble import EtiAssembler

    ens = _packet_ensemble()
    pc = ens.packet_component(7)
    sub = ens.subchannel(pc.subchid)
    rng = np.random.default_rng(8)
    objects = [("a.png", rng.integers(0, 256, 200, dtype=np.uint8)
                .tobytes())]
    mot = MotEncoder(seg_size=64)
    enc = PacketEncoder(address=pc.address, packet_size=96)
    for dg in mot.carousel_groups(objects):
        enc.add_data_group(dg)
    asm = EtiAssembler(ens)
    eti = bytearray()
    for n in range(24):
        fibs = [f.tobytes() for f in build_fibs_for_ensemble(ens, n // 4)[
            3 * (n % 4): 3 * (n % 4) + 3]]
        eti += asm.frame(fibs, {
            1: rng.integers(0, 256, 192, dtype=np.uint8).tobytes(),
            pc.subchid: enc.take_frame(sub.data_bytes)})
    src = tmp_path / "mux.eti"
    src.write_bytes(bytes(eti))
    outdir = tmp_path / "all"
    r = subprocess.run(
        [sys.executable, "-m", "dabtools_tpu.cli.eti2audio",
         "--all", str(outdir), str(src)],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert (outdir / "0x1001_AUDIO.mp2").stat().st_size == 24 * 192
    got = (outdir / "0xE1C00042_DATA_SVC_objects" / "a.png").read_bytes()
    assert got == objects[0][1]
