"""Mid-stream ensemble reconfiguration: the mux changes its sub-channel
organization; the receiver re-specializes and continues decoding."""

import numpy as np

from dabtools_tpu import constants as C
from dabtools_tpu.eti.parse import EtiParser
from dabtools_tpu.fic.config import Ensemble, Subchannel
from dabtools_tpu.models.receiver import DabReceiver

from tests.test_closed_loop import build_ensemble, modulate


def test_mux_reconfiguration():
    ens1 = build_ensemble()                              # subch 1 @ CU 0
    ens2 = Ensemble(eid=ens1.eid, label="TEST DAB",
                    subchannels=(Subchannel.eep(3, 96, 2, "B", 64),))
    # Phase 2 must outlast the merged transient: old FIG subchannel
    # entries age out max_subch_age_fibs=120 FIB-feeds (~2.5 4-frame
    # blocks) after their last sighting — each FIB now ticks ONCE (the
    # pre-r5 replay passes double-fed reconfig blocks, aging ~1 block
    # fast; ADVICE r4) — then reconfirmation takes 2 more blocks.
    x1, p1 = modulate(ens1, 10, seed=20)
    x2, p2 = modulate(ens2, 22, seed=21)

    rx = DabReceiver(n_frames=4)
    eti = rx.feed(np.concatenate([x1, x2]))
    assert rx.ensemble is not None
    # final configuration is the new one
    assert rx.ensemble.subchannels[0].subchid == 3
    frames = list(EtiParser().feed(b"".join(eti)))
    assert frames, "no ETI emitted at all"

    # Frames from phase 1 carry subch 1; after a short merged transient
    # (both sub-channels "live" while the old FIG entries age out) the
    # receiver converges to the new configuration.
    phase1 = [f for f in frames if set(f.streams) == {1}]
    phase2 = [f for f in frames if set(f.streams) == {3}]
    assert phase1 and len(phase2) >= 4
    assert set(frames[-1].streams) == {3}

    # Phase-2 payloads are bit-exact against the second modulator run.
    a2 = rx._activation_cif
    # global CIF of the first ens2 CIF: x1 contributed 40 CIFs of signal,
    # but block boundaries blur the seam; instead locate by content.
    expect_rows = {p2[3][n].tobytes(): n for n in range(64)}
    matched = sum(f.subchannel_data(3) in expect_rows for f in phase2)
    assert matched >= len(phase2) - 2    # seam frames may be transient
    # and they appear in order
    idxs = [expect_rows[f.subchannel_data(3)] for f in phase2
            if f.subchannel_data(3) in expect_rows]
    assert idxs == sorted(idxs)


def test_mux_revert_a_b_a():
    """A -> B -> A: the FIB dedup cache must not freeze the parser on B
    (cache is cleared at every activation)."""
    ens_a = build_ensemble()
    ens_b = Ensemble(eid=ens_a.eid, label="TEST DAB",
                     subchannels=(Subchannel.eep(3, 96, 2, "B", 64),))
    # each phase outlasts the (single-tick-accurate) aging transient —
    # see the note in test_mux_reconfiguration
    xa1, _ = modulate(ens_a, 10, seed=50)
    xb, _ = modulate(ens_b, 18, seed=51)
    xa2, pa2 = modulate(ens_a, 20, seed=52)

    rx = DabReceiver(n_frames=4)
    eti = rx.feed(np.concatenate([xa1, xb, xa2]))
    assert rx.ensemble is not None
    assert rx.ensemble.subchannels == ens_a.subchannels, \
        "receiver failed to revert to config A"
    frames = list(EtiParser().feed(b"".join(eti)))
    assert set(frames[-1].streams) == {1}
    # the tail of the stream decodes config A bit-exactly
    expect_rows = {pa2[1][n].tobytes() for n in range(56)}
    tail = [f for f in frames[-6:] if set(f.streams) == {1}]
    assert tail and all(f.subchannel_data(1) in expect_rows for f in tail)
