"""Viterbi decoder for the DAB K=7 rate-1/4 code as a GPU kernel (N6).

Pallas through Triton.  Same contract and bit-identical output as the XLA
reference in ``ops.viterbi`` (the tests compare the two).

Design for the GPU:

* The grid runs over blocks of ``BL`` codewords ("lanes").  One program
  decodes its lanes through every trellis step in ONE launch: the 64 path
  metrics are 64 separate (BL,) register vectors carried through an
  in-kernel loop, so the butterfly's predecessor selection is plain
  Python renaming, not a gather or a shuffle.  Each thread owns one lane.
* Branch metrics are exact signed sums of the step's 4 soft bits in a
  fixed order (``((±s0 ±s1) ±s2) ±s3``), computed once per distinct
  coded-bit pattern; the XLA reference sums in the same order, so there
  is no matmul precision (TF32) question and the bits match.
* Decisions are written packed, two int32 words per step and lane
  (target states 0-31 and 32-63).  Traceback is a second kernel: a
  reverse loop over those words with shift-and-mask bit extraction.
* Lanes are ragged: each carries its own trellis length.  A lane's
  metric is captured at its own last step and its traceback starts
  there, so the zero padding beyond it is never read.  FIC and every MSC
  profile group therefore share one launch
  (``ops.viterbi.viterbi_decode_ragged``).
* Radix-2: with every state in its own register, fusing two steps
  (radix-4) would double the adds per step pair and save nothing on a
  dependency chain that 64 independent states already hide.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from dabtools_tpu import constants as C
from dabtools_tpu.ops.viterbi import NEG_INF, transition_matrix

# Trellis steps per loop iteration: their soft bits (or decision words)
# are loaded together at the top of the iteration so the loads overlap.
# Lanes per program: one warp, each thread owning one lane.
# Measured on an H100 80GB HBM3 (700 W) at the flagship block's ragged job
# (64 FIC + 576 MSC lanes, T = 3078), median of 20 launches:
#   TC  1 / 2 / 4 / 8 / 16 at BL=32:  3.25 / 3.18 / 2.25 / 2.57 / 2.31 ms
#   BL  4 / 8 / 16 / 32 at TC=4:      2.25 / 2.25 / 2.20 / 2.25 ms
# Each thread runs its codeword's whole trellis, so at 640 lanes the time
# does not depend on BL; BL=32 fills every thread of the warp, which is
# what counts once lanes outnumber the SMs (batched ensembles).  Larger TC
# is no faster and compiles much longer (TC=16: 165 s).
TC = 4
BL = 32
# Bit c of an int32 decision word.
_BIT = [np.uint32(1 << c).astype(np.int32) for c in range(32)]


@functools.cache
def _patterns() -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(pattern of each transition, the distinct patterns).

    A pattern is the 4-bit coded output of a transition, bit k = coded
    bit k; transition (state s, input u) is entry ``2*s + u``, the row of
    :func:`ops.viterbi.transition_matrix`."""
    w = transition_matrix()
    pat = tuple(sum(1 << k for k in range(4) if w[r, k] < 0)
                for r in range(128))
    return pat, tuple(sorted(set(pat)))


def _branch_metrics(s):
    """{pattern: ((±s0 ±s1) ±s2) ±s3} for every pattern the code emits."""
    _, distinct = _patterns()
    neg = [-v for v in s]
    term = lambda p, k: neg[k] if (p >> k) & 1 else s[k]   # noqa: E731
    return {p: ((term(p, 0) + term(p, 1)) + term(p, 2)) + term(p, 3)
            for p in distinct}


def _acs_kernel(soft_ref, len_ref, dec_ref, metric_ref):
    """soft (T_pad, 4, BL) f32, lengths (1, BL) -> decisions
    (T_pad, 2, BL) int32, metric (1, BL) f32."""
    pat, _ = _patterns()
    lens = len_ref[0, :]
    bl = lens.shape[0]
    zero = jnp.zeros((bl,), jnp.float32)
    pm0 = (zero,) + tuple(zero + NEG_INF for _ in range(63))

    def chunk(ci, carry):
        pm, metric = carry
        t0 = ci * TC
        softs = [[soft_ref[t0 + j, k, :] for k in range(4)]
                 for j in range(TC)]
        for j in range(TC):
            bm = _branch_metrics(softs[j])
            new = [None] * 64
            words = [jnp.zeros((bl,), jnp.int32) for _ in range(2)]
            for c in range(32):
                p0, p1 = pm[2 * c], pm[2 * c + 1]
                for u in range(2):
                    a = p0 + bm[pat[2 * (2 * c) + u]]
                    b = p1 + bm[pat[2 * (2 * c + 1) + u]]
                    new[32 * u + c] = jnp.maximum(a, b)
                    words[u] = words[u] | jnp.where(b > a, _BIT[c], 0)
            dec_ref[t0 + j, 0, :] = words[0]
            dec_ref[t0 + j, 1, :] = words[1]
            metric = jnp.where(t0 + j == lens - 1, new[0], metric)
            pm = tuple(new)
        return pm, metric

    _, metric = jax.lax.fori_loop(0, soft_ref.shape[0] // TC, chunk,
                                  (pm0, zero))
    metric_ref[0, :] = metric


def _traceback_kernel(dec_ref, len_ref, bits_ref):
    """decisions (T_pad, 2, BL), lengths (1, BL) -> bits (T_pad, BL)
    int32: the input bit of each step, 0 beyond the lane's length."""
    lens = len_ref[0, :]
    n_chunks = dec_ref.shape[0] // TC

    def chunk(k, state):
        t0 = (n_chunks - 1 - k) * TC
        words = [(dec_ref[t0 + j, 0, :], dec_ref[t0 + j, 1, :])
                 for j in range(TC)]
        for j in reversed(range(TC)):
            live = t0 + j < lens
            bits_ref[t0 + j, :] = state >> 5
            w = jnp.where(state >= 32, words[j][1], words[j][0])
            d = jax.lax.shift_right_logical(w, state & 31) & 1
            # Dead steps hold state 0, so each lane starts its traceback
            # at its own last step from the tail-terminated state 0.
            state = jnp.where(live, 2 * (state & 31) + d, 0)
        return state

    jax.lax.fori_loop(0, n_chunks, chunk, jnp.zeros_like(lens))


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@functools.partial(jax.jit, static_argnames=("interpret",))
def _decode(soft, lengths, interpret: bool = False):
    b0, n4 = soft.shape
    t = n4 // 4
    t_pad = _round_up(t, TC)
    b = _round_up(max(b0, 1), BL)
    soft_t = jnp.zeros((t_pad, 4, b), jnp.float32).at[:t, :, :b0].set(
        soft.reshape(b0, t, 4).transpose(1, 2, 0))
    lens = jnp.zeros((1, b), jnp.int32).at[0, :b0].set(lengths)
    params = pl_triton.CompilerParams(num_warps=1, num_stages=1)
    grid = (b // BL,)
    len_spec = pl.BlockSpec((1, BL), lambda i: (0, i))
    dec, metric = pl.pallas_call(
        _acs_kernel,
        grid=grid,
        in_specs=[pl.BlockSpec((t_pad, 4, BL), lambda i: (0, 0, i)),
                  len_spec],
        out_specs=(pl.BlockSpec((t_pad, 2, BL), lambda i: (0, 0, i)),
                   len_spec),
        out_shape=(jax.ShapeDtypeStruct((t_pad, 2, b), jnp.int32),
                   jax.ShapeDtypeStruct((1, b), jnp.float32)),
        compiler_params=params,
        interpret=interpret,
        name="viterbi_acs",
    )(soft_t, lens)
    bits_t = pl.pallas_call(
        _traceback_kernel,
        grid=grid,
        in_specs=[pl.BlockSpec((t_pad, 2, BL), lambda i: (0, 0, i)),
                  len_spec],
        out_specs=pl.BlockSpec((t_pad, BL), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((t_pad, b), jnp.int32),
        compiler_params=params,
        interpret=interpret,
        name="viterbi_traceback",
    )(dec, lens)
    bits = bits_t[: t - C.TAIL_BITS, :b0].T.astype(jnp.uint8)
    return bits, metric[0, :b0]


def viterbi_decode_gpu(soft, lengths=None, interpret: bool = False):
    """Decode ``soft`` (batch, 4*T) on the GPU kernel.

    ``lengths`` (optional, (batch,) int): per-lane trellis length incl.
    the tail, each in ``[TAIL_BITS + 1, T]``; shorter lanes are
    zero-padded on the right.  Lane ``k``'s information bits are
    ``bits[k, :lengths[k] - TAIL_BITS]``; positions beyond are zeros.
    Returns ``(bits (batch, T - TAIL_BITS) uint8, metric (batch,) f32)``.

    ``interpret=True`` runs the kernel in the Pallas interpreter (tests on
    a machine without a GPU); nothing chooses it automatically.
    """
    soft = jnp.asarray(soft, jnp.float32)
    if soft.ndim != 2 or soft.shape[-1] % 4:
        raise ValueError("expected (batch, 4*T) soft bits")
    t = soft.shape[-1] // 4
    if lengths is None:
        lengths = np.full(soft.shape[0], t, np.int32)
    if isinstance(lengths, (np.ndarray, list, tuple)):
        ln = np.asarray(lengths)
        if ln.shape != (soft.shape[0],):
            raise ValueError("lengths must be (batch,)")
        if (ln > t).any() or (ln <= C.TAIL_BITS).any():
            raise ValueError("each lane length must exceed the tail and "
                             "be <= the padded codeword length")
    return _decode(soft, jnp.asarray(lengths, jnp.int32),
                   interpret=bool(interpret))
