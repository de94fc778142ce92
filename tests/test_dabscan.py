"""dabscan CLI: find two synthesized ensembles in a wideband capture."""

import subprocess
import sys

import numpy as np
import pytest

from dabtools_tpu import constants as C
from dabtools_tpu.tables.bandiii import BAND_III, blocks_within

from tests.test_channelizer import upconvert
from tests.test_closed_loop import build_ensemble, modulate


def test_bandiii_table_sanity():
    assert BAND_III["5A"] == 174_928_000
    assert BAND_III["6A"] - BAND_III["5D"] == 1_872_000
    assert BAND_III["5B"] - BAND_III["5A"] == 1_712_000
    assert len(BAND_III) == 8 * 4 + 6
    assert BAND_III["13F"] == 239_200_000
    inside = blocks_within(184.5e6, 8.192e6)
    assert [l for l, _ in inside] == ["6A", "6B", "6C", "6D"]


def test_scan_finds_ensembles(tmp_path):
    fs = 8_192_000
    center = 184.5e6
    factor = fs // C.SAMPLE_RATE
    from dabtools_tpu.fic.config import Ensemble, Subchannel
    ens_a = build_ensemble()                       # at 6A
    ens_b = Ensemble(eid=0xB10C, label="BLOCK B",
                     subchannels=(Subchannel.eep(4, 0, 2, "B", 64),))
    xa, _ = modulate(ens_a, 8, seed=1)
    xb, _ = modulate(ens_b, 8, seed=2)
    wide = (upconvert(xa, factor, BAND_III["6A"] - center, fs)
            + upconvert(xb, factor, BAND_III["6C"] - center, fs)) * 0.5
    cap = tmp_path / "wide.cf32"
    wide.astype(np.complex64).tofile(cap)

    r = subprocess.run(
        [sys.executable, "-m", "dabtools_tpu.cli.dabscan", "--cpu",
         "--center", str(center), "--rate", str(fs),
         "--seconds", "0.8", str(cap)],
        capture_output=True, text=True, timeout=500)
    assert r.returncode == 0, r.stderr + r.stdout
    lines = r.stdout.splitlines()
    a_line = next(l for l in lines if l.startswith("6A"))
    c_line = next(l for l in lines if l.startswith("6C"))
    b_line = next(l for l in lines if l.startswith("6B"))
    assert "0x4FFF" in a_line and "TEST DAB" in a_line
    assert "0xB10C" in c_line and "BLOCK B" in c_line
    assert "--" in b_line                      # empty block stays empty
    assert "2 ensemble(s) found" in r.stderr

    # --json: one object per candidate block, machine-readable
    import json
    r = subprocess.run(
        [sys.executable, "-m", "dabtools_tpu.cli.dabscan", "--cpu",
         "--center", str(center), "--rate", str(fs),
         "--seconds", "0.8", "--json", str(cap)],
        capture_output=True, text=True, timeout=500)
    assert r.returncode == 0, r.stderr + r.stdout
    recs = {j["block"]: j for j in map(json.loads, r.stdout.splitlines())}
    assert set(recs) == {"6A", "6B", "6C", "6D"}
    assert recs["6A"]["eid"] == "0x4FFF"
    assert recs["6C"]["label"] == "BLOCK B"
    assert isinstance(recs["6C"]["services"], list)
    assert "eid" not in recs["6B"]
    # snr_db provenance travels with every record, found-or-not
    # (VERDICT r2: the estimator's saturation/bias caveat must be
    # machine-readable, not source-only)
    for rec in recs.values():
        assert rec["snr_method"] == "null_floor"
        assert "saturates" in rec["snr_caveat"]
