"""Distributed tests on the 8-device virtual CPU mesh (SURVEY.md s4 item 4):
sharded output must equal the sequential single-device output bit-exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dabtools_tpu import constants as C
from dabtools_tpu.models.receiver import DabReceiver, block_samples, process_block
from dabtools_tpu.ops.fec import init_deinterleave_ring
from dabtools_tpu.parallel.channel import channel_parallel_block
from dabtools_tpu.parallel.mesh import make_receiver_mesh
from dabtools_tpu.parallel.timeblock import halo_sizes, timeblock_receiver

from tests.test_closed_loop import build_ensemble, modulate


@pytest.fixture(scope="module")
def ensemble():
    return build_ensemble()


def test_mesh_construction():
    mesh = make_receiver_mesh()
    assert mesh.shape == {"channels": 8, "time": 1}
    mesh = make_receiver_mesh(n_time=4)
    assert mesh.shape == {"channels": 2, "time": 4}
    with pytest.raises(ValueError):
        make_receiver_mesh(n_channels=3, n_time=3)


def test_channel_parallel_matches_sequential(ensemble):
    """8 streams sharded over 8 devices == 8 sequential decodes."""
    n_frames = 6
    xs, payloads = [], []
    for c in range(8):
        x, p = modulate(ensemble, n_frames, seed=100 + c)
        xs.append(x[: block_samples(4)])
        payloads.append(p)
    xb = jnp.asarray(np.stack(xs))

    mesh = make_receiver_mesh(n_channels=8, n_time=1)
    rings = {str(s.subchid): jnp.tile(
        init_deinterleave_ring(s.profile.tx_bits)[None], (8, 1, 1))
        for s in ensemble.subchannels}
    out, _, _ = channel_parallel_block(
        xb, rings, jnp.asarray(0, jnp.int32), ensemble=ensemble,
        n_frames=4, mesh=mesh)

    # Sequential reference on each channel.
    for c in range(8):
        ring1 = {str(s.subchid): init_deinterleave_ring(s.profile.tx_bits)
                 for s in ensemble.subchannels}
        ref, _, _ = process_block(
            xb[c], ring1, jnp.asarray(0, jnp.int32), ensemble=ensemble,
            n_frames=4)
        np.testing.assert_array_equal(np.asarray(out["fib_bytes"][c]),
                                      np.asarray(ref["fib_bytes"]))
        for k in ref["subch"]:
            np.testing.assert_array_equal(np.asarray(out["subch"][k][c]),
                                          np.asarray(ref["subch"][k]))


def test_timeblock_matches_sequential(ensemble):
    """Time-sharded span == sequential receiver, bit-exact, incl. the
    deinterleaver dependency across shard seams."""
    n_time = 4
    f_own = 6
    warmup = 5
    g0 = warmup + 1                   # span starts at frame g0 (> lh back)
    n_frames_total = g0 + n_time * f_own + 1          # +1 for suffix
    x, payload_bytes = modulate(ensemble, n_frames_total, seed=55)

    fr = C.MODE_I.frame_size
    lh, rh = halo_sizes(warmup)
    span_start = g0 * fr
    span_len = n_time * f_own * fr
    span = x[span_start: span_start + span_len]
    prefix = x[span_start - lh: span_start]
    suffix = x[span_start + span_len: span_start + span_len + rh]

    mesh = make_receiver_mesh(n_channels=2, n_time=n_time)
    fn = timeblock_receiver(mesh, ensemble, frames_per_shard=f_own,
                            warmup_frames=warmup)
    xb = jnp.asarray(np.stack([span, span]))          # 2 identical channels
    out = fn(xb, jnp.asarray(np.stack([prefix, prefix])),
             jnp.asarray(np.stack([suffix, suffix])),
             g0)

    assert out["fib_bytes"].shape == (2, n_time * f_own, 12, 32)

    # Sequential ground truth: payload bytes straight from the modulator.
    sub = ensemble.subchannels[0]
    got = np.asarray(out["subch"][str(sub.subchid)])
    for c in range(2):
        for j in range(n_time * f_own * 4):
            n = g0 * 4 + j - 15           # logical frame of output row j
            if n < 0:
                continue
            assert got[c, j].tobytes() == payload_bytes[1][n].tobytes(), \
                f"channel {c} row {j} (logical frame {n}) mismatch"

    # FIBs decoded on every shard match the modulated FIBs.
    from dabtools_tpu.utils.crc import crc16_ok
    fib_bytes = np.asarray(out["fib_bytes"])
    for c in range(2):
        for f in range(n_time * f_own):
            for i in range(12):
                assert crc16_ok(fib_bytes[c, f, i].tobytes())


def test_timeblock_cold_start_transient_is_local(ensemble):
    """Zero prefix corrupts only shard 0's output, not later shards."""
    n_time = 4
    f_own = 6
    warmup = 5
    g0 = warmup + 1
    n_frames_total = g0 + n_time * f_own + 1
    x, payload_bytes = modulate(ensemble, n_frames_total, seed=77)
    fr = C.MODE_I.frame_size
    lh, rh = halo_sizes(warmup)
    span_start = g0 * fr
    span_len = n_time * f_own * fr
    span = x[span_start: span_start + span_len]
    suffix = x[span_start + span_len: span_start + span_len + rh]

    mesh = make_receiver_mesh(n_channels=2, n_time=n_time)
    fn = timeblock_receiver(mesh, ensemble, frames_per_shard=f_own,
                            warmup_frames=warmup)
    xb = jnp.asarray(np.stack([span, span]))
    zeros = jnp.zeros((2, lh), dtype=jnp.complex64)
    out = fn(xb, zeros, jnp.asarray(np.stack([suffix, suffix])), g0)

    sub = ensemble.subchannels[0]
    got = np.asarray(out["subch"][str(sub.subchid)])
    # Shards 1..3 (rows >= f_own*4) are still bit-exact.
    for j in range(f_own * 4, n_time * f_own * 4):
        n = g0 * 4 + j - 15
        assert got[0, j].tobytes() == payload_bytes[1][n].tobytes()


@pytest.mark.parametrize("mode_name,f_own,warmup,g0", [
    ("II", 17, 16, 17),    # 1 CIF/frame: 16-frame warmup primes the ring
    ("III", 21, 18, 21),   # FIC codewords span 3 frames: all multiples of 3
    ("IV", 9, 8, 9),       # 2 CIFs/frame
])
def test_timeblock_modes_ii_iv(mode_name, f_own, warmup, g0):
    """Modes II-IV under time-block sharding: payload + FIC bit-exact
    across shard seams (Mode III includes frame-spanning FIC codewords)."""
    from dabtools_tpu.utils.crc import crc16_ok
    from tests.test_modes import _ensemble, _modulate

    mode = C.MODES[mode_name]
    ens = _ensemble(0x3100 + ord(mode_name[-1]))
    n_time = 2
    n_total = g0 + n_time * f_own + 3
    x, pb = _modulate(ens, mode, n_total)
    fr = mode.frame_size
    lh, rh = halo_sizes(warmup, mode)
    mesh = make_receiver_mesh(n_channels=4, n_time=n_time)
    fn = timeblock_receiver(mesh, ens, mode=mode, frames_per_shard=f_own,
                            warmup_frames=warmup)
    tile = lambda a: jnp.asarray(np.broadcast_to(a, (4, a.size)))
    s0, sl = g0 * fr, n_time * f_own * fr
    out = fn(tile(x[s0:s0 + sl]), tile(x[s0 - lh:s0]),
             tile(x[s0 + sl:s0 + sl + rh]), g0)
    got = np.asarray(out["subch"]["1"])
    for c in range(4):
        for j in range(n_time * f_own * mode.n_cifs):
            n = g0 * mode.n_cifs + j - 15
            assert got[c, j].tobytes() == pb[n].tobytes(), \
                f"Mode {mode_name} ch {c} row {j} (logical {n}) mismatch"
    fb = np.asarray(out["fib_bytes"])
    assert fb.shape[1:] == (n_time * f_own, mode.n_fibs, 32)
    assert all(crc16_ok(fb[0, f, i].tobytes())
               for f in range(fb.shape[1]) for i in range(fb.shape[2]))


def test_timeblock_mode_iii_rejects_misaligned_shards():
    mesh = make_receiver_mesh(n_channels=4, n_time=2)
    from tests.test_modes import _ensemble
    ens = _ensemble(0x3203)
    with pytest.raises(ValueError, match="multiples of 3"):
        timeblock_receiver(mesh, ens, mode=C.MODES["III"],
                           frames_per_shard=20, warmup_frames=18)


def test_dryrun_multichip_four_devices(capsys):
    """What ``chip_smoke.py --four-cards`` runs on four GPUs: the 2 x 2
    channels x time mesh, bit-exact against the modulator, the ETI host
    half and one device's process_block on the same span."""
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(4)
    assert "equal to one device's process_block" in capsys.readouterr().out
