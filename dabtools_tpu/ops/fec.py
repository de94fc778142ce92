"""Device-side FEC plumbing: depuncture, descramble, time-deinterleave.

Reference counterparts: `upstream:input_sdr.c` depuncture + energy-dispersal
(R11/R13) and the 16-CIF time deinterleaver (R15).  Accelerator design: every
table becomes a *static* gather index map built at trace time (N7/N8 in
SURVEY.md), so XLA sees constant-index gathers and fixed shapes; the
deinterleaver ring is explicit `scan` carry state that also crosses block
boundaries (and, under time-block sharding, travels with the halo).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dabtools_tpu import constants as C
from dabtools_tpu.tables.puncturing import (
    PuncturingProfile,
    puncture_mask_for_profile,
)
from dabtools_tpu.tables.time_interleave import DELAYS
from dabtools_tpu.utils.prbs import energy_dispersal_bits


@functools.cache
def depuncture_gather_map(profile: PuncturingProfile) -> np.ndarray:
    """int32 (mother_bits,): index into the tx-bit stream, or ``tx_bits``
    (sentinel -> reads a zero pad) for punctured positions."""
    mask = puncture_mask_for_profile(profile)
    idx = np.full(mask.size, profile.tx_bits, dtype=np.int32)
    idx[mask.astype(bool)] = np.arange(int(mask.sum()), dtype=np.int32)
    return idx


def depuncture(soft_tx: jnp.ndarray, profile: PuncturingProfile) -> jnp.ndarray:
    """(batch, tx_bits) soft bits -> (batch, mother_bits) with 0 erasures."""
    idx = jnp.asarray(depuncture_gather_map(profile))
    padded = jnp.concatenate(
        [soft_tx, jnp.zeros((*soft_tx.shape[:-1], 1), soft_tx.dtype)], axis=-1)
    return padded[..., idx]


def descramble(bits: jnp.ndarray) -> jnp.ndarray:
    """XOR decoded hard bits (..., n) with the energy-dispersal PRBS."""
    prbs = jnp.asarray(energy_dispersal_bits(bits.shape[-1]))
    return jnp.bitwise_xor(bits, prbs)


# ------------------------------------------------------------ deinterleave
@functools.cache
def _rx_slot_offsets(n_bits: int) -> np.ndarray:
    """For output CIF n, bit i lives in received CIF ``n - 15 + d(i)``;
    returns the per-bit offset ``d(i) - 15`` (int32, (n_bits,))."""
    return (DELAYS[np.arange(n_bits) % 16] - 15).astype(np.int32)


@functools.cache
def _lag_onehot(n_bits: int) -> np.ndarray:
    """(16, n_bits) float32 one-hot of each lane's lag (see
    _rx_slot_offsets): row o+15 is 1.0 where lane i reads offset o."""
    off = _rx_slot_offsets(n_bits)
    oh = np.zeros((16, n_bits), dtype=np.float32)
    oh[off + 15, np.arange(n_bits)] = 1.0
    return oh


def time_deinterleave(ring: jnp.ndarray, cif_count: jnp.ndarray,
                      coded: jnp.ndarray):
    """De-interleave a run of received coded CIF contributions.

    ``ring``: (16, n_bits) float32 — the last 16 received CIFs (soft bits),
    slot ``k`` holding received CIF with global index ``== k (mod 16)``.
    ``cif_count``: int32 scalar, global index of the first CIF in ``coded``.
    ``coded``: (n_cifs, n_bits) newly received coded CIFs (soft).

    Returns ``(new_ring, out)`` where ``out[(n_cifs, n_bits)]`` are the
    re-aligned coded logical frames; ``out[j]`` is logical frame
    ``cif_count + j - 15`` (garbage for global index < 15 — the unavoidable
    384 ms startup transient, as in the reference receiver).
    """
    n_cifs, n_bits = coded.shape
    # Scan-free formulation (a per-CIF scan is hundreds of sequential
    # micro-gathers).  out[j, i] is simply the
    # received stream at global CIF (cif_count + j + off_i), so build the
    # stream H = [15 history rows from the ring | coded] and select among
    # the 16 STATIC lag slices per lane — one vectorized select instead
    # of n_cifs sequential ring updates.  Bit-identical to the scan
    # (slot s of the ring holds the most recent global index == s mod 16,
    # so ring[(cif_count-15+r) % 16] is global CIF cif_count-15+r).
    hist_rows = (cif_count - 15 + jnp.arange(15, dtype=jnp.int32)) % 16
    # jnp.take: `ring` may arrive as host numpy (cold-start init), whose
    # __getitem__ rejects traced indices
    hist = jnp.take(jnp.asarray(ring), hist_rows, axis=0)  # (15, n_bits)
    H = jnp.concatenate([hist, coded], axis=0)         # (15+n_cifs, n_bits)
    # Lag selection as a one-hot masked SUM, not a per-element gather:
    # 16 elementwise multiply-adds of the static lag slices.  Exact:
    # each output element is 1.0 * its lane's slice + 15 true zeros.
    onehot = jnp.asarray(_lag_onehot(n_bits))          # (16, n_bits) f32
    out = sum(
        jax.lax.slice_in_dim(H, 15 + o, 15 + o + n_cifs, axis=0)
        * onehot[o + 15][None, :]
        for o in range(-15, 1))
    # New ring: slot s holds the most recent global index == s (mod 16).
    glast = cif_count + n_cifs - 1
    g_s = glast - ((glast - jnp.arange(16, dtype=jnp.int32)) % 16)
    new_ring = H[g_s - (cif_count - 15)]
    return new_ring, out


def init_deinterleave_ring(n_bits: int) -> np.ndarray:
    # Host-side zeros on purpose: a jnp.zeros here would be one device
    # dispatch per sub-channel *before* the pipeline's main compile; jit
    # device-puts the arrays on first call.
    return np.zeros((C.TIME_INTERLEAVE_DEPTH, n_bits), dtype=np.float32)
