"""Dynamic window extraction as whole-window row slices under ANY vmap
nesting.

The receiver extracts dynamic-start windows from the sample block
everywhere (OFDM symbol windows, the PRS matched-filter window, the
guard-correlation windows).  The realization kept here is the one
``jax.vmap(lax.dynamic_slice)`` lowers to: a gather with an UNBATCHED
operand and whole-window ``slice_sizes`` — contiguous row copies,
rather than an element-indexed gather from the block (the slow path on
the accelerator this was first written for; whether the distinction
matters on a GPU is not measured yet).

The trap is batching the OPERAND: ``jax.vmap`` over a channel axis (the
config-3 channel-parallel receiver) rewrites the same dynamic_slice
into a gather over the now-(channels, n)-shaped block.
``window_slices`` fixes that with a ``custom_vmap`` rule that
COLLAPSES every mapped axis into the sample axis instead: the samples
flatten to one (channels*n,) vector, starts get per-channel base
offsets, and the call recurses — so the lowered gather keeps an
unbatched operand at every nesting depth.

Out-of-range starts follow the exact ``lax.dynamic_slice`` contract the
unbatched path has always had — one NumPy-style wrap of negative
starts, then a clamp into ``[0, n - length]`` — applied PER CHANNEL and
BEFORE the flat-axis base offsets, so a runaway start can never slide a
window into a neighboring channel's samples.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.cache
def _window_slicer(length: int):
    from jax import custom_batching

    @custom_batching.custom_vmap
    def ws(x, starts):
        """x: (n,), starts: (m,) int32 -> (m, length) windows."""
        return jax.vmap(
            lambda s: jax.lax.dynamic_slice(x, (s,), (length,)))(starts)

    @ws.def_vmap
    def _rule(axis_size, in_batched, x, starts):  # noqa: ANN001
        x_b, s_b = in_batched
        if not x_b and not s_b:
            return ws(x, starts), False
        if not x_b:
            # Shared samples, batched starts: fold the mapped axis into
            # the row axis — still an unbatched-operand gather.
            m = starts.shape[-1]
            out = ws(x, starts.reshape(axis_size * m))
            return out.reshape(axis_size, m, length), True
        if not s_b:
            starts = jnp.broadcast_to(
                starts[None], (axis_size, *starts.shape))
        n = x.shape[-1]
        m = starts.shape[-1]
        # Exact lax.dynamic_slice start semantics, applied PER CHANNEL:
        # one NumPy-style wrap of negative starts, then clamp into
        # [0, n - length].
        s = starts.astype(jnp.int32)
        s = jnp.clip(jnp.where(s < 0, s + n, s), 0, n - length)
        base = (jnp.arange(axis_size, dtype=jnp.int32) * n)[:, None]
        out = ws(x.reshape(axis_size * n),
                 (s + base).reshape(axis_size * m))
        return out.reshape(axis_size, m, length), True

    return ws


def window_slices(x: jnp.ndarray, starts: jnp.ndarray, length: int):
    """``stack([x[s:s+length] for s in starts])`` with dynamic ``starts``.

    ``x``: (n,) samples; ``starts``: (m,) int32 (traced ok); returns
    (m, length).  Starts clamp to ``[0, n - length]`` (the
    ``lax.dynamic_slice`` contract).  Safe to ``jax.vmap`` to any depth:
    mapped axes collapse into the sample axis (see module docstring)
    instead of batching the gather operand.
    """
    return _window_slicer(int(length))(x, starts.astype(jnp.int32))
