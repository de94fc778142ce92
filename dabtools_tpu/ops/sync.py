"""Sync engine: null-symbol coarse time, guard-interval fractional CFO,
PRS matched filter for fine time + integer CFO (N3).

Reference counterpart: `upstream:input_sdr.c` `dab_coarse_time_sync` /
`dab_fine_time_sync` (R5) and the PRS correlation used by the WaveFinder AFC
(R3).  Redesigned for the accelerator: alignment is computed *as data*
inside jit (argmin/argmax + dynamic_slice), never as host control flow;
the PRS search evaluates all (integer-CFO, timing) hypotheses as one
batched FFT correlation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dabtools_tpu.constants import MODE_I, Mode
from dabtools_tpu.ops.slicing import window_slices
from dabtools_tpu.tables.prs import prs_time


# Where machine-readable output carries an snr_db derived from this,
# attach SNR_METHOD/SNR_CAVEAT so consumers see the estimator's limits
# without reading source (dabscan --json, --stats-json).
SNR_METHOD = "null_floor"
SNR_CAVEAT = ("saturates ~30 dB; underestimates when TII carriers or "
              "long SFN echo tails raise the null-symbol floor")


def null_ratio_to_snr_db(null_ratio: float) -> float:
    """SNR estimated from the null-symbol noise floor.

    null_ratio r = P_null / P_mean, so SNR = (1 - r) / r.  See SNR_CAVEAT
    for the estimator's known biases.  One shared definition so
    FrameStats.snr_db and dabscan cannot drift apart (ADVICE r2).
    """
    import math
    r = min(max(float(null_ratio), 1e-6), 1.0 - 1e-6)
    return 10.0 * math.log10(1.0 / r - 1.0)


def moving_power(x: jnp.ndarray, window: int) -> jnp.ndarray:
    """Sliding-window power sum, valid positions only (cumsum trick)."""
    p = jnp.abs(x) ** 2
    cs = jnp.concatenate([jnp.zeros(1, p.dtype), jnp.cumsum(p)])
    return cs[window:] - cs[:-window]


def coarse_null_sync(x: jnp.ndarray, mode: Mode = MODE_I) -> dict:
    """Locate the null symbol inside the first frame-length of ``x``.

    Returns traced scalars: ``null_start`` (int32) and ``null_ratio``
    (null power / mean power — sync-confidence metric, SURVEY.md s5.3).
    """
    n = mode.frame_size + mode.null_size
    win = moving_power(x[:n], mode.null_size)[: mode.frame_size]
    null_start = jnp.argmin(win).astype(jnp.int32)
    ratio = win[null_start] / (jnp.mean(win) + 1e-20)
    return {"null_start": null_start, "null_ratio": ratio}


def fractional_cfo(x: jnp.ndarray, frame_start: jnp.ndarray,
                   mode: Mode = MODE_I, n_syms: int = 8) -> jnp.ndarray:
    """Fractional CFO (in carrier spacings, |.| < 0.5) from guard-interval
    correlation over the first ``n_syms`` symbols of the frame at
    ``frame_start`` (start of null symbol; traced ok)."""
    sym0 = frame_start + mode.null_size
    starts = sym0 + jnp.arange(n_syms, dtype=jnp.int32) * mode.symbol_size
    # Whole symbols via window_slices (guard + tail are its two ends):
    # row-slice gather that stays fast under an outer channel vmap.
    sym = window_slices(x, starts, mode.symbol_size)     # (n_syms, T_s)
    guard = sym[:, : mode.guard]
    tail = sym[:, mode.fft_size: mode.fft_size + mode.guard]
    corr = jnp.sum(jnp.conj(guard) * tail)
    # phase advance over T_u samples = 2*pi * cfo_norm
    return jnp.angle(corr) / (2.0 * jnp.pi)


@functools.cache
def _prs_templates(mode: Mode, max_int_cfo: int, fft_len: int) -> np.ndarray:
    """Conjugated spectra of the PRS shifted by c carriers, zero-padded to
    ``fft_len``; (2*max_int_cfo+1, fft_len) complex64."""
    t = prs_time(mode)
    n = np.arange(mode.fft_size)
    temps = []
    for c in range(-max_int_cfo, max_int_cfo + 1):
        shifted = t * np.exp(2j * np.pi * c * n / mode.fft_size)
        padded = np.zeros(fft_len, dtype=np.complex64)
        padded[: mode.fft_size] = shifted
        temps.append(np.conj(np.fft.fft(padded)))
    return np.stack(temps).astype(np.complex64)


def fine_sync_prs(x: jnp.ndarray, prs_guess: jnp.ndarray,
                  mode: Mode = MODE_I, search: int = 256,
                  max_int_cfo: int = 8,
                  frac_cfo: jnp.ndarray | float = 0.0):
    """Joint fine-timing + integer-CFO estimate from the PRS.

    ``prs_guess``: traced int32 — estimated start of the PRS *useful* part
    (i.e. frame_start + null + guard).  Searches timing offsets in
    [-search, +search) and integer CFOs in [-max_int_cfo, +max_int_cfo]
    by correlating against precomputed shifted PRS templates (one batched
    FFT correlation evaluates every hypothesis).

    ``frac_cfo``: the guard-interval fractional-CFO estimate (carriers,
    |.| <= 0.5), derotated from the window BEFORE the integer search.
    Without it, a true CFO near a half-carrier boundary is ambiguous: the
    fractional estimator wraps to the other side (+0.49 vs -0.49 carriers)
    while the template correlation — evaluated at a half-carrier residual
    where adjacent templates score almost equally — can pick the integer
    bin that pairs with the OTHER wrap, a full 1-carrier error.  (Found by
    the sharded-impairments test: one time shard of a 2.5-carrier-CFO
    signal resolved 2.49, another 1.51.)

    Returns dict of traced values: ``offset`` (int32, add to prs_guess),
    ``int_cfo`` (int32, carriers), ``peak`` (float32 normalized 0..1
    correlation quality).
    """
    win_len = mode.fft_size + 2 * search
    fft_len = int(2 ** np.ceil(np.log2(win_len + mode.fft_size)))
    # window_slices (not dynamic_slice) so the receiver's per-frame vmap
    # AND config 3's channel vmap both stay on the gather fast path.
    win = window_slices(x, jnp.asarray(prs_guess - search)[None],
                        win_len)[0]
    # exp(-j*2*pi*f*t): same compensation convention as the demod ramp
    # (ops/ofdm.py gather_symbol_windows); only |corr| is used below, so
    # the window-relative timebase is fine.
    ph = -2.0 * jnp.pi * jnp.mod(
        jnp.asarray(frac_cfo, jnp.float32)
        * jnp.arange(win_len, dtype=jnp.float32) / mode.fft_size, 1.0)
    win = win * jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
    wspec = jnp.fft.fft(win, n=fft_len)
    temps = jnp.asarray(_prs_templates(mode, max_int_cfo, fft_len))
    corr = jnp.fft.ifft(wspec[None, :] * temps, axis=-1)
    mag = jnp.abs(corr[:, : 2 * search])        # lag = offset + search
    flat = jnp.argmax(mag)
    n_lags = 2 * search
    c_idx = flat // n_lags
    lag = flat % n_lags
    energy = jnp.sqrt(jnp.sum(jnp.abs(win[search:search + mode.fft_size]) ** 2)
                      * jnp.sum(jnp.abs(jnp.asarray(prs_time(mode))) ** 2))
    peak = mag.reshape(-1)[flat] / (energy + 1e-20)
    return {
        "offset": (lag - search).astype(jnp.int32),
        "int_cfo": (c_idx - max_int_cfo).astype(jnp.int32),
        "peak": peak.astype(jnp.float32),
    }


def channel_impulse_response(x: jnp.ndarray, prs_start: jnp.ndarray,
                             cfo_carriers: jnp.ndarray,
                             mode: Mode = MODE_I) -> jnp.ndarray:
    """Least-squares channel impulse response from the synchronized PRS.

    The PRS is a known unit-magnitude spectrum Z_k, so the per-carrier LS
    channel estimate is simply H_k = Y_k * conj(Z_k) on the active
    carriers; IFFT gives the complex CIR h[n], whose |h| peaks at each
    propagation path's delay.  This is the SFN-analysis view professional
    DAB monitors provide; the reference has no counterpart
    (`upstream:input_sdr.c` uses the PRS only for sync, SURVEY.md R5).

    ``prs_start``: traced int32, start of the PRS useful part after fine
    sync.  ``cfo_carriers``: traced float32 total CFO in carrier spacings
    (integer part undone by a spectrum roll, fractional part by a time-
    domain derotation, so the estimate stays coherent).

    Returns (fft_size,) complex64, circularly shifted so index
    ``fft_size // 2`` is lag 0 (the receiver's timing reference);
    pre-cursor paths appear below the center, echoes above it.
    """
    from dabtools_tpu.tables.prs import prs_spectrum

    win = window_slices(x, jnp.asarray(prs_start)[None],
                        mode.fft_size)[0]
    ic = jnp.round(cfo_carriers)
    frac = cfo_carriers - ic
    n = jnp.arange(mode.fft_size, dtype=jnp.float32)
    win = win * jnp.exp(-2j * jnp.pi * frac * n / mode.fft_size)
    y = jnp.roll(jnp.fft.fft(win), -ic.astype(jnp.int32))
    z = prs_spectrum(mode)
    h = jnp.fft.ifft(y * jnp.conj(jnp.asarray(z))
                     * jnp.asarray((np.abs(z) > 0).astype(np.float32)))
    return jnp.roll(h, mode.fft_size // 2)
