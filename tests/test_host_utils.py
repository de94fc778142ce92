import numpy as np
import pytest

from dabtools_tpu.mod.convcode import conv_encode, output_table, viterbi_decode_ref
from dabtools_tpu.tables.puncturing import fic_puncture_mask
from dabtools_tpu.utils.bits import bits_to_bytes, bytes_to_bits
from dabtools_tpu.utils.crc import crc16_ccitt, crc16_ok, firecode
from dabtools_tpu.utils.prbs import energy_dispersal_bits, scramble_bits


class TestCRC:
    def test_ccitt_known_answer(self):
        # CRC-16/CCITT-FALSE("123456789") = 0x29B1; DAB complements it.
        assert crc16_ccitt(b"123456789") == 0x29B1 ^ 0xFFFF

    def test_roundtrip(self):
        rng = np.random.default_rng(0)
        for _ in range(5):
            data = rng.integers(0, 256, size=30, dtype=np.uint8).tobytes()
            crc = crc16_ccitt(data)
            assert crc16_ok(data + crc.to_bytes(2, "big"))
            assert not crc16_ok(data + ((crc ^ 1).to_bytes(2, "big")))

    def test_firecode_detects_errors(self):
        rng = np.random.default_rng(1)
        data = rng.integers(0, 256, size=9, dtype=np.uint8).tobytes()
        fc = firecode(data)
        corrupted = bytes([data[0] ^ 0x40]) + data[1:]
        assert firecode(corrupted) != fc

    def test_firecode_linearity(self):
        # CRC over GF(2) is linear: crc(a^b) == crc(a)^crc(b) for init=0.
        rng = np.random.default_rng(2)
        a = rng.integers(0, 256, size=9, dtype=np.uint8)
        b = rng.integers(0, 256, size=9, dtype=np.uint8)
        assert firecode((a ^ b).tobytes()) == (
            firecode(a.tobytes()) ^ firecode(b.tobytes()))


class TestPRBS:
    def test_period_and_balance(self):
        bits = energy_dispersal_bits(1022)  # two periods of 511
        assert (bits[:511] == bits[511:]).all()
        assert bits[:511].sum() == 256  # m-sequence weight

    def test_scramble_involution(self):
        rng = np.random.default_rng(3)
        bits = rng.integers(0, 2, size=768, dtype=np.uint8)
        assert (scramble_bits(scramble_bits(bits)) == bits).all()


class TestBits:
    def test_roundtrip(self):
        rng = np.random.default_rng(4)
        data = rng.integers(0, 256, size=64, dtype=np.uint8).tobytes()
        assert bits_to_bytes(bytes_to_bits(data)) == data


class TestConvCode:
    def test_impulse_response_matches_polys(self):
        # Single 1 followed by zeros: outputs trace the generator taps.
        out = conv_encode(np.array([1], dtype=np.uint8)).reshape(-1, 4)
        # step 0: register = 1000000 -> D^0 coefficient of each poly
        assert out[0].tolist() == [1, 1, 1, 1]
        # step n: register = 1 at position D^n
        expect = {  # poly -> coefficient list D^0..D^6
            0o133: [1, 0, 1, 1, 0, 1, 1],
            0o171: [1, 1, 1, 1, 0, 0, 1],
            0o145: [1, 1, 0, 0, 1, 0, 1],
        }
        for n in range(7):
            row = out[n].tolist()
            assert row == [expect[0o133][n], expect[0o171][n],
                           expect[0o145][n], expect[0o133][n]]

    def test_output_table_shape(self):
        t = output_table()
        assert t.shape == (128, 4)
        assert t[0].tolist() == [0, 0, 0, 0]

    def test_viterbi_clean(self):
        rng = np.random.default_rng(5)
        bits = rng.integers(0, 2, size=768, dtype=np.uint8)
        mother = conv_encode(bits)
        soft = (1.0 - 2.0 * mother).astype(np.float64)
        decoded = viterbi_decode_ref(soft)
        assert (decoded == bits).all()

    def test_viterbi_with_fic_puncturing_and_noise(self):
        rng = np.random.default_rng(6)
        bits = rng.integers(0, 2, size=768, dtype=np.uint8)
        mother = conv_encode(bits).astype(np.float64)
        soft = 1.0 - 2.0 * mother
        soft += rng.normal(scale=0.45, size=soft.shape)  # ~7 dB Eb/N0-ish
        mask = fic_puncture_mask().astype(bool)
        soft[~mask] = 0.0  # erasures at punctured positions
        decoded = viterbi_decode_ref(soft)
        assert (decoded == bits).all()

    def test_viterbi_vs_bruteforce_short(self):
        rng = np.random.default_rng(7)
        n = 8
        for _ in range(3):
            soft = rng.normal(size=4 * (n + 6))
            best, best_metric = None, -np.inf
            for msg in range(2 ** n):
                bits = np.array([(msg >> (n - 1 - i)) & 1 for i in range(n)],
                                dtype=np.uint8)
                enc = conv_encode(bits)
                metric = float(np.sum((1.0 - 2.0 * enc) * soft))
                if metric > best_metric:
                    best, best_metric = bits, metric
            decoded = viterbi_decode_ref(soft)
            assert (decoded == best).all()


@pytest.mark.parametrize("env_dir", [True, False])
def test_enable_persistent_cache(tmp_path, monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR set: used as is, no directory set in
    code.  Unset: the cache goes to the fixed <repo>/.jax_cache."""
    import pathlib

    import jax

    from dabtools_tpu.utils import jitcache

    repo = pathlib.Path(__file__).resolve().parents[1]
    assert jitcache._DEFAULT == repo / ".jax_cache"
    updates = []
    real_update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda k, v: (
        updates.append(k), real_update(k, v)))
    target = tmp_path / "jc"
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(jitcache, "_DEFAULT", target)
    assert jitcache.enable_persistent_cache() == str(target)
    if env_dir:
        assert "jax_compilation_cache_dir" not in updates
    else:
        assert updates == ["jax_compilation_cache_dir"]
        assert target.is_dir()
        assert jax.config.jax_compilation_cache_dir == str(target)
    # compiling through the cache must not change results
    import jax.numpy as jnp
    import numpy as np
    f = jax.jit(lambda x: x * 2 + 1)
    np.testing.assert_array_equal(np.asarray(f(jnp.arange(4))),
                                  [1, 3, 5, 7])
    # tmp_path is deleted after the test: detach the global config again
    real_update("jax_compilation_cache_dir", None)
