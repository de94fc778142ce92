"""GPU Viterbi kernel (``ops/viterbi_gpu.py``) against the XLA scan.

The kernel runs here in the Pallas interpreter (``interpret=True``), which
executes the same kernel body on the CPU; the compiled kernel is compared
with the XLA scan on the card by ``chip_smoke.py`` (phase ``viterbi``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dabtools_tpu import constants as C
from dabtools_tpu.mod.convcode import conv_encode, viterbi_decode_ref
from dabtools_tpu.ops import viterbi as V
from dabtools_tpu.ops import viterbi_gpu as G
from dabtools_tpu.ops.fec import depuncture
from dabtools_tpu.tables.puncturing import FIC_PROFILE, eep_profile


def _noisy(rng, batch, t, sigma=0.8, erase_every=0):
    """(bits (batch, t-6), soft (batch, 4t) f32) of random codewords."""
    bits = rng.integers(0, 2, (batch, t - C.TAIL_BITS), dtype=np.uint8)
    soft = np.stack([1.0 - 2.0 * conv_encode(b) for b in bits])
    soft = soft + rng.normal(0, sigma, soft.shape)
    if erase_every:
        soft[:, ::erase_every] = 0.0
    return bits, soft.astype(np.float32)


def _punctured(rng, batch, profile, sigma=0.6):
    bits = rng.integers(0, 2, (batch, profile.data_bits), dtype=np.uint8)
    tx = np.stack([conv_encode(b) for b in bits])[
        :, profile.mask().astype(bool)]
    soft = (1.0 - 2.0 * tx) + rng.normal(0, sigma, tx.shape)
    return bits, np.asarray(depuncture(jnp.asarray(soft, jnp.float32),
                                       profile))


def _assert_same(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


@pytest.mark.parametrize("batch,t", [(1, 40), (3, 64), (33, 106), (7, 200),
                                     (5, 151)])
def test_kernel_matches_xla(batch, t):
    _, soft = _noisy(np.random.default_rng(t), batch, t)
    got = G.viterbi_decode_gpu(soft, interpret=True)
    assert got[0].shape == (batch, t - C.TAIL_BITS)
    assert got[0].dtype == jnp.uint8 and got[1].shape == (batch,)
    _assert_same(got, V.viterbi_decode_xla(jnp.asarray(soft)))


def test_fic_punctured_codewords():
    bits, soft = _punctured(np.random.default_rng(3), 4, FIC_PROFILE)
    got = G.viterbi_decode_gpu(soft, interpret=True)
    _assert_same(got, V.viterbi_decode_xla(jnp.asarray(soft)))
    ref = np.stack([viterbi_decode_ref(s) for s in soft])
    np.testing.assert_array_equal(np.asarray(got[0]), ref)
    assert (np.asarray(got[0]) == bits).mean() > 0.99


def test_full_length_msc_codewords():
    """T = 3078: one 128 kbit/s EEP-3A logical frame per codeword."""
    bits, soft = _punctured(np.random.default_rng(4), 2,
                            eep_profile(3, "A", 128))
    got = G.viterbi_decode_gpu(soft, interpret=True)
    assert soft.shape[-1] == 4 * 3078
    _assert_same(got, V.viterbi_decode_xla(jnp.asarray(soft)))
    np.testing.assert_array_equal(np.asarray(got[0]), bits)


@pytest.mark.parametrize("jobs", [
    [(2, 50), (3, 120)],
    [(4, 31), (1, 200), (2, 77)],
    [(1, 7), (2, 8), (3, 64)],
], ids=["two", "three-odd", "shortest"])
def test_ragged_matches_per_batch(jobs):
    rng = np.random.default_rng(len(jobs))
    softs = [_noisy(rng, b, t)[1] for b, t in jobs]
    got = V.viterbi_decode_ragged(softs, interpret=True)
    assert len(got) == len(jobs)
    for g, s in zip(got, softs):
        _assert_same(g, V.viterbi_decode_xla(jnp.asarray(s)))


def test_bits_beyond_lane_length_are_zero():
    _, soft = _noisy(np.random.default_rng(5), 3, 48)
    lengths = np.array([48, 20, 33])
    soft[1, 4 * 20:] = 0.0
    soft[2, 4 * 33:] = 0.0
    bits, metric = G.viterbi_decode_gpu(soft, lengths, interpret=True)
    bits = np.asarray(bits)
    for k, n in enumerate(lengths):
        want = V.viterbi_decode_xla(jnp.asarray(soft[k: k + 1, : 4 * n]))
        np.testing.assert_array_equal(bits[k, : n - C.TAIL_BITS],
                                      np.asarray(want[0])[0])
        assert not bits[k, n - C.TAIL_BITS:].any()
        assert np.asarray(metric)[k] == np.asarray(want[1])[0]


@pytest.mark.parametrize("lengths,match", [
    (np.array([10, 10]), "lengths must be"),          # wrong shape
    (np.array([10, 10, 41]), "exceed the tail"),       # longer than T
    (np.array([10, 0, 10]), "exceed the tail"),        # empty lane
    (np.array([10, C.TAIL_BITS, 10]), "exceed the tail"),  # tail only
])
def test_invalid_lengths(lengths, match):
    soft = np.zeros((3, 4 * 40), np.float32)
    with pytest.raises(ValueError, match=match):
        G.viterbi_decode_gpu(soft, lengths, interpret=True)


@pytest.mark.parametrize("shape", [(4, 10), (2, 3, 40)])
def test_invalid_soft_shape(shape):
    with pytest.raises(ValueError, match="soft bits"):
        G.viterbi_decode_gpu(np.zeros(shape, np.float32), interpret=True)


@pytest.mark.parametrize("batch", [G.BL - 1, G.BL + 1, 2 * G.BL + 5])
def test_batch_not_multiple_of_lane_block(batch):
    _, soft = _noisy(np.random.default_rng(batch), batch, 24)
    _assert_same(G.viterbi_decode_gpu(soft, interpret=True),
                 V.viterbi_decode_xla(jnp.asarray(soft)))


def test_vmap_matches_per_slice():
    """vmap adds a grid axis to the kernel (it runs in parallel on a
    GPU): the channel-parallel and time-block receivers rely on it."""
    _, soft = _noisy(np.random.default_rng(6), 6, 32)
    soft = soft.reshape(2, 3, -1)
    f = jax.vmap(functools.partial(V.viterbi_decode, interpret=True))
    bits, metric = f(jnp.asarray(soft))
    for i in range(2):
        _assert_same((bits[i], metric[i]),
                     V.viterbi_decode_xla(jnp.asarray(soft[i])))


def test_single_codeword_squeezes():
    bits, soft = _noisy(np.random.default_rng(7), 1, 30, sigma=0.3)
    dec, metric = V.viterbi_decode(soft[0], interpret=True)
    assert dec.shape == (30 - C.TAIL_BITS,) and metric.shape == ()
    np.testing.assert_array_equal(np.asarray(dec), bits[0])


@pytest.mark.parametrize("backend,kernel", [("cpu", False), ("gpu", True),
                                            ("tpu", False)])
def test_platform_selects_implementation(monkeypatch, backend, kernel):
    """One choice, from the platform: the kernel on a GPU, the XLA scan
    elsewhere; interpret mode only when a caller asks for it."""
    monkeypatch.setattr(V.jax, "default_backend", lambda: backend)
    assert V.use_kernel() is kernel
    calls = []

    def fake_kernel(soft, lengths=None, interpret=False):
        calls.append((soft.shape, lengths, interpret))
        n = soft.shape[0]
        return (jnp.zeros((n, soft.shape[1] // 4 - C.TAIL_BITS), jnp.uint8),
                jnp.zeros((n,), jnp.float32))

    monkeypatch.setattr(G, "viterbi_decode_gpu", fake_kernel)
    softs = [np.zeros((2, 4 * 20), np.float32),
             np.zeros((3, 4 * 12), np.float32)]
    out = V.viterbi_decode_ragged(softs)
    assert [o[0].shape for o in out] == [(2, 14), (3, 6)]
    if kernel:
        # ONE launch for both batches, padded to the longest, never
        # interpreted unless asked.
        [(shape, lengths, interpret)] = calls
        assert shape == (5, 4 * 20) and not interpret
        np.testing.assert_array_equal(lengths, [20, 20, 12, 12, 12])
    else:
        assert calls == []


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_single_batch_decode_follows_platform(monkeypatch, backend):
    """``viterbi_decode`` takes the same one choice; on a GPU the kernel
    is compiled, never interpreted, unless a caller asks."""
    monkeypatch.setattr(V.jax, "default_backend", lambda: backend)
    calls = []
    monkeypatch.setattr(G, "viterbi_decode_gpu",
                        lambda soft, lengths=None, interpret=False:
                        calls.append(interpret) or (None, None))
    soft = _noisy(np.random.default_rng(12), 2, 16)[1]
    out = V.viterbi_decode(soft)
    if backend == "gpu":
        assert calls == [False]
    else:
        assert calls == [] and out[0].shape == (2, 10)


def test_patterns_match_the_encoder():
    """Transition (s, u) emits the coded bits of register (u << 6) | s."""
    from dabtools_tpu.mod.convcode import output_table

    pat, distinct = G._patterns()
    table = output_table()
    for s in range(64):
        for u in range(2):
            assert [(pat[2 * s + u] >> k) & 1 for k in range(4)] == \
                list(table[(u << 6) | s])
    assert set(distinct) == set(pat)


def test_branch_metrics_exact_and_identical():
    """Kernel and reference sum the signed soft bits in the same order,
    so their branch metrics agree bit for bit (no matmul, no TF32)."""
    soft = np.random.default_rng(8).normal(size=(5, 9, 4)).astype(
        np.float32)
    ref = np.asarray(V.branch_metrics(jnp.asarray(soft)))      # (5, 9, 128)
    pat, _ = G._patterns()
    for t in range(9):
        bm = G._branch_metrics([jnp.asarray(soft[:, t, k]) for k in range(4)])
        for s in range(64):
            for u in range(2):
                np.testing.assert_array_equal(
                    np.asarray(bm[pat[2 * s + u]]),
                    ref[:, t, 4 * (s >> 1) + 2 * (s & 1) + u])


@pytest.mark.parametrize("profile", [FIC_PROFILE, eep_profile(3, "A", 64),
                                     eep_profile(1, "B", 32)],
                         ids=["fic", "eep3a-64", "eep1b-32"])
def test_xla_scan_matches_numpy_reference(profile):
    bits, soft = _punctured(np.random.default_rng(9), 2, profile)
    dec, _ = V.viterbi_decode_xla(jnp.asarray(soft))
    np.testing.assert_array_equal(
        np.asarray(dec), np.stack([viterbi_decode_ref(s) for s in soft]))


@pytest.mark.parametrize("jobs", [[(2, 40), (1, 90)], [(3, 25)]])
def test_xla_ragged_path_matches_per_batch(jobs):
    """Off the GPU each batch decodes on its own through the XLA scan."""
    rng = np.random.default_rng(10)
    softs = [_noisy(rng, b, t)[1] for b, t in jobs]
    for g, s in zip(V.viterbi_decode_ragged(softs), softs):
        _assert_same(g, V.viterbi_decode_xla(jnp.asarray(s)))


def test_receiver_merged_dispatch_bit_exact(monkeypatch):
    """The receiver's ONE Viterbi launch per block (FIC + two puncturing
    profile groups, ragged lanes) through the kernel gives the XLA
    path's ETI bytes."""
    from dabtools_tpu.fic.config import (Ensemble, Service,
                                         ServiceComponent, Subchannel)
    from dabtools_tpu.mod.modulator import modulate_ensemble
    from dabtools_tpu.models import receiver as R

    ens = Ensemble(
        eid=0xBEEF, label="RAGGED",
        subchannels=(Subchannel.eep(1, 0, 3, "A", 64),
                     Subchannel.eep(2, 48, 2, "B", 32)),
        services=(Service(sid=1, components=(
            ServiceComponent(tmid=0, subchid=1),)),
                  Service(sid=2, components=(
            ServiceComponent(tmid=0, subchid=2),))))
    x, payload, _ = modulate_ensemble(ens, 10, seed=11)
    eti_xla = R.DabReceiver(n_frames=4, ensemble=ens).feed(x)
    monkeypatch.setattr(R, "viterbi_decode_ragged", functools.partial(
        V.viterbi_decode_ragged, interpret=True))
    R.process_block.clear_cache()
    try:
        rx = R.DabReceiver(n_frames=4, ensemble=ens)
        eti = rx.feed(x)
    finally:
        R.process_block.clear_cache()
    assert eti and eti == eti_xla
    from dabtools_tpu.eti.parse import EtiParser
    for k, f in enumerate(EtiParser().feed(b"".join(eti))):
        for sc in (1, 2):
            n = rx._activation_cif + k
            assert f.subchannel_data(sc) == payload[sc][n].tobytes()


@pytest.mark.gpu
def test_kernel_on_gpu_matches_xla():
    """Compiled kernel at the flagship's ragged widths (64 FIC + 576 MSC
    lanes) on the card; ``chip_smoke.py`` phase ``viterbi`` runs this."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run python chip_smoke.py on the card)")
    import chip_smoke
    chip_smoke.phase_viterbi()
