"""window_slices: bit-identity with lax.dynamic_slice at every vmap depth.

The helper exists purely as a gather-layout realization (ops/slicing.py);
its contract is that the extracted values are EXACTLY what a per-start
``lax.dynamic_slice`` would produce, including the start-clamping
behavior, no matter how many vmap levels wrap it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dabtools_tpu.ops.slicing import window_slices

LEN = 17


def _ref(x, starts):
    return np.stack([
        np.asarray(jax.lax.dynamic_slice(x, (int(s),), (LEN,)))
        for s in np.asarray(starts)])


@pytest.fixture()
def data():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 3, 200)).astype(np.float32)
    # in-range, zero, and far-out-of-range (clamp) starts
    starts = rng.integers(-50, 400, size=(4, 3, 6)).astype(np.int32)
    return jnp.asarray(x), jnp.asarray(starts)


def test_unbatched(data):
    x, starts = data
    out = window_slices(x[0, 0], starts[0, 0], LEN)
    np.testing.assert_array_equal(out, _ref(x[0, 0], starts[0, 0]))


def test_one_vmap_level_operand_batched(data):
    x, starts = data
    out = jax.vmap(lambda xc, sc: window_slices(xc, sc, LEN))(
        x[0], starts[0])
    for c in range(x.shape[1]):
        np.testing.assert_array_equal(out[c], _ref(x[0, c], starts[0, c]))


def test_one_vmap_level_shared_operand(data):
    x, starts = data
    out = jax.vmap(lambda sc: window_slices(x[0, 0], sc, LEN))(starts[0])
    for c in range(starts.shape[1]):
        np.testing.assert_array_equal(out[c], _ref(x[0, 0], starts[0, c]))


def test_two_vmap_levels(data):
    x, starts = data
    f = lambda xc, sc: window_slices(xc, sc, LEN)  # noqa: E731
    out = jax.jit(jax.vmap(jax.vmap(f)))(x, starts)
    for a in range(x.shape[0]):
        for c in range(x.shape[1]):
            np.testing.assert_array_equal(
                out[a, c], _ref(x[a, c], starts[a, c]))


def test_two_levels_unbatched_operand_lowering_has_flat_gather(data):
    """The channel level must collapse into the sample axis: the lowered
    module contains a gather whose operand is the FLAT (channels*n,)
    vector, and no gather with a (channels, n) operand."""
    x, starts = data
    f = jax.vmap(lambda xc, sc: window_slices(xc, sc, LEN))
    txt = jax.jit(f).lower(x[0], starts[0]).as_text()
    n_flat = x.shape[2] * x.shape[1]
    assert f"tensor<{n_flat}xf32>" in txt  # the flat operand exists
    import re
    for m in re.finditer(r'"stablehlo\.gather"\(([^)]*)\)[^\n]*'
                         r':\s*\(tensor<([0-9x]+)xf32>', txt):
        dims = m.group(2).split("x")
        assert len(dims) == 1, f"batched-operand gather leaked: {m.group(0)}"


def test_clamp_never_crosses_channels():
    """A start beyond a channel's end must clamp within ITS channel, not
    read the next channel's samples (the flat collapse adds base offsets
    AFTER clamping)."""
    x = jnp.stack([jnp.zeros(50, jnp.float32),
                   jnp.ones(50, jnp.float32)])
    starts = jnp.asarray([[49], [49]], jnp.int32)  # clamp to 50 - LEN
    out = jax.vmap(lambda xc, sc: window_slices(xc, sc, LEN))(x, starts)
    np.testing.assert_array_equal(out[0, 0], np.zeros(LEN, np.float32))
    np.testing.assert_array_equal(out[1, 0], np.ones(LEN, np.float32))


def test_symbol_window_layouts_bit_identical():
    """gather_symbol_windows twostage vs persym: same sample indices =>
    bit-identical windows, unbatched and under a channel vmap, with
    traced CFO and drift engaged."""
    from dabtools_tpu import constants as C
    from dabtools_tpu.ops.ofdm import gather_symbol_windows

    mode = C.MODE_I
    rng = np.random.default_rng(7)
    n = 2 * mode.frame_size + 8192
    z = rng.normal(size=(2, n, 2)).astype(np.float32)
    x = jnp.asarray((z[..., 0] + 1j * z[..., 1]).astype(np.complex64))
    starts = jnp.asarray([[3, mode.frame_size + 11],
                          [7, mode.frame_size + 2]], jnp.int32)

    def run(layout):
        f = lambda xc, sc: gather_symbol_windows(  # noqa: E731
            xc, sc, mode, cfo_norm=0.37, drift=3.2, layout=layout)
        single = f(x[0], starts[0])
        batched = jax.vmap(f)(x, starts)
        return single, batched

    s_two, b_two = run("twostage")
    s_per, b_per = run("persym")
    np.testing.assert_array_equal(np.asarray(s_two), np.asarray(s_per))
    np.testing.assert_array_equal(np.asarray(b_two), np.asarray(b_per))
