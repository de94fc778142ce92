"""Batched soft-decision Viterbi for the DAB K=7 rate-1/4 code (N6).

Reference counterpart: `upstream:viterbi.c` (R12, a scalar C ACS loop with
traceback).  This is NOT a translation — the trellis is batched over
codewords and written gather-free:

* Branch metrics for ALL transitions of ALL time steps are computed up
  front as exact signed sums of each step's 4 soft bits in a fixed order,
  ``((±s0 ±s1) ±s2) ±s3`` — the same order the GPU kernel uses, so the two
  agree bit for bit and no matmul precision (TF32) enters.
* The ACS recursion needs NO gathers: with path metrics viewed as
  ``pm[c, b]`` (c = state>>1, b = state&1), the two predecessors of targets
  ``u*32 + c`` are exactly ``pm[c, 0]`` and ``pm[c, 1]`` — a reshape +
  transpose.
* The time recursion is a `lax.scan` carrying ``pm``; decisions stream out
  as uint8.
* Traceback is a second (reverse) scan; the per-step "pick my decision bit"
  is a one-hot reduction, again gather-free.

Conventions (shared with mod.convcode — see its docstring):
soft > 0 means coded bit 0; erasures (punctured positions) are exactly 0.

On a GPU the decode runs as the Pallas kernel in ``viterbi_gpu.py``
(identical semantics); this XLA version is the reference everywhere else
and what the tests pin the kernel to.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dabtools_tpu import constants as C
from dabtools_tpu.mod.convcode import output_table

NEG_INF = -1e30


def use_kernel() -> bool:
    """The one implementation choice: the GPU kernel on a GPU, the XLA
    scan on every other backend."""
    return jax.default_backend() == "gpu"


@functools.cache
def transition_matrix() -> np.ndarray:
    """W: (128, 4) float32; row ``4*c + 2*b + u`` is the +/-1 pattern of the
    coded bits on the transition (state=2c+b) --input u--> (u*32 + c)."""
    table = output_table()  # out[reg] -> 4 bits, reg = (u << 6) | state
    w = np.empty((128, 4), dtype=np.float32)
    for c in range(32):
        for b in range(2):
            for u in range(2):
                reg = (u << 6) | (2 * c + b)
                w[4 * c + 2 * b + u] = 1.0 - 2.0 * table[reg]
    return w


def _acs_scan(bm: jnp.ndarray, pm0: jnp.ndarray):
    """bm: (T, batch, 32, 2, 2) branch metrics; pm0: (batch, 64).

    Returns (final pm, decisions (T, batch, 64) uint8).
    """

    def step(pm, bm_t):
        # pm[batch, 64] viewed as pairs: pred states (2c, 2c+1) -> pm2[c, b]
        pm2 = pm.reshape(pm.shape[0], 32, 2, 1)
        cand = pm2 + bm_t                       # [batch, 32, 2(b), 2(u)]
        take1 = (cand[:, :, 1, :] > cand[:, :, 0, :])
        new = jnp.max(cand, axis=2)             # [batch, 32, 2(u)]
        # target state index = u*32 + c  ->  axes (u, c)
        new = new.transpose(0, 2, 1).reshape(pm.shape[0], 64)
        dec = take1.transpose(0, 2, 1).reshape(pm.shape[0], 64)
        return new, dec.astype(jnp.uint8)

    return jax.lax.scan(step, pm0, bm)


def _traceback(decisions: jnp.ndarray) -> jnp.ndarray:
    """decisions: (T, batch, 64) uint8 -> decoded bits (batch, T) uint8.

    Starts from state 0 (the zero tail guarantees it).
    """
    batch = decisions.shape[1]
    state0 = jnp.zeros((batch,), dtype=jnp.int32)

    def step(state, dec_t):
        bit = (state >> 5).astype(jnp.uint8)
        onehot = jax.nn.one_hot(state, 64, dtype=dec_t.dtype)
        d = jnp.sum(onehot * dec_t, axis=-1).astype(jnp.int32)
        prev = 2 * (state & 31) + d
        return prev, bit

    _, bits_rev = jax.lax.scan(step, state0, decisions[::-1])
    return bits_rev[::-1].transpose(1, 0)


def branch_metrics(soft: jnp.ndarray) -> jnp.ndarray:
    """(batch, T, 4) soft bits -> (batch, T, 128) transition metrics, row
    ``4*c + 2*b + u`` as in :func:`transition_matrix`: the exact signed
    sum ``((±s0 ±s1) ±s2) ±s3`` (the GPU kernel's order)."""
    neg = jnp.asarray(transition_matrix() < 0)               # (128, 4)
    term = [jnp.where(neg[:, k], -soft[..., k, None], soft[..., k, None])
            for k in range(4)]
    return ((term[0] + term[1]) + term[2]) + term[3]


def viterbi_decode(soft: jnp.ndarray, *, interpret: bool = False):
    """Decode a batch of mother codewords.

    ``soft``: (batch, 4*(n+6)) float32, positive => coded bit 0, 0 = erasure.
    Returns ``(bits, metric)``: bits (batch, n) uint8 information bits (tail
    stripped); metric (batch,) float32 — the winning path's correlation with
    the received soft bits (a BER/confidence proxy, SURVEY.md s5.5).

    Runs the GPU kernel on a GPU (:func:`use_kernel`) and the XLA scan
    elsewhere; ``interpret=True`` (tests only) runs the kernel in the
    Pallas interpreter on any backend.
    """
    soft = jnp.asarray(soft, dtype=jnp.float32)
    squeeze = soft.ndim == 1
    if squeeze:
        soft = soft[None]
    if interpret or use_kernel():
        from dabtools_tpu.ops.viterbi_gpu import viterbi_decode_gpu
        bits, metric = viterbi_decode_gpu(soft, interpret=interpret)
    else:
        bits, metric = viterbi_decode_xla(soft)
    return (bits[0], metric[0]) if squeeze else (bits, metric)


def viterbi_decode_xla(soft: jnp.ndarray):
    batch, n4 = soft.shape
    assert n4 % 4 == 0, "mother codeword length must be a multiple of 4"
    t_steps = n4 // 4
    bm = branch_metrics(soft.reshape(batch, t_steps, 4))
    bm = bm.reshape(batch, t_steps, 32, 2, 2).transpose(1, 0, 2, 3, 4)

    pm0 = jnp.full((batch, 64), NEG_INF, dtype=jnp.float32)
    pm0 = pm0.at[:, 0].set(0.0)
    pm_final, decisions = _acs_scan(bm, pm0)
    bits = _traceback(decisions)

    return bits[:, : t_steps - C.TAIL_BITS], pm_final[:, 0]


def viterbi_decode_ragged(softs, *, interpret: bool = False):
    """Decode several codeword batches of (possibly) DIFFERENT lengths.

    ``softs``: sequence of (batch_i, 4*T_i) soft-bit arrays (same
    conventions as :func:`viterbi_decode`).  Returns a list of
    ``(bits_i, metric_i)`` in the same order, each bit-identical to
    ``viterbi_decode(softs[i])``.

    On the GPU kernel the batches are right-padded to the longest T,
    concatenated along lanes, and decoded with a per-lane length vector
    — so a heterogeneous mux (FIC + several UEP/EEP profile groups) costs
    ONE launch instead of one per group.  Reference counterpart: none —
    upstream (R9/R15) decodes each codeword in a scalar C loop.

    The XLA scan decodes each batch on its own (same results, one scan
    per batch).
    """
    softs = [jnp.asarray(s, jnp.float32) for s in softs]
    if any(s.ndim != 2 for s in softs):
        raise ValueError("each batch must be (batch_i, 4*T_i) soft bits")
    if not softs:
        return []
    if not (interpret or use_kernel()):
        return [viterbi_decode_xla(s) for s in softs]
    from dabtools_tpu.ops.viterbi_gpu import viterbi_decode_gpu
    ts = [s.shape[-1] // 4 for s in softs]
    n4_max = max(s.shape[-1] for s in softs)
    soft = jnp.concatenate(
        [jnp.pad(s, ((0, 0), (0, n4_max - s.shape[-1]))) for s in softs],
        axis=0)
    lengths = np.concatenate(
        [np.full(s.shape[0], t, np.int32) for s, t in zip(softs, ts)])
    bits, metric = viterbi_decode_gpu(soft, lengths, interpret=interpret)
    out, o = [], 0
    for s, t in zip(softs, ts):
        b = s.shape[0]
        out.append((bits[o: o + b, : t - C.TAIL_BITS], metric[o: o + b]))
        o += b
    return out
