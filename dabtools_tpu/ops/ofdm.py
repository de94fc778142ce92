"""Batched OFDM demodulation (N4).

Reference counterpart: the per-symbol loop in `upstream:input_sdr.c`
(`dab_demod`, R7): drop guard, 2048-pt FFT (fftw3f), conjugate multiply
with the previous symbol, frequency deinterleave, QPSK soft bits.

Redesigned for the accelerator: all symbols of a whole *block* of frames
are demodulated as one tensor program — a single gather builds the
(frames, 76, 2048) window tensor (with per-frame traced start offsets, so
data-dependent sync becomes *data*, not control flow), one batched FFT runs
on XLA's FFT, and the differential demap + deinterleave + soft-bit
extraction are fused elementwise/gather ops.  Host<->device crossing happens
once per block, not per symbol (SURVEY.md s3.4).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from dabtools_tpu.constants import MODE_I, SAMPLE_RATE, Mode
from dabtools_tpu.ops.slicing import window_slices
from dabtools_tpu.tables.freq_interleave import freq_interleave_map


@functools.cache
def _interleave_idx(mode: Mode) -> np.ndarray:
    return freq_interleave_map(mode)


# Static clip margin for per-symbol drift window shifts: keeps the
# per-frame slice length static under jit.  50 ppm over one Mode I frame
# is ~10 samples; 64 is 6x headroom.
_DRIFT_MARGIN = 64


def _drift_adjustment(drift, sym_pos: jnp.ndarray, mode: Mode) -> jnp.ndarray:
    """Per-symbol integer window shift for sample-clock drift, CLIPPED to
    the static slice margin.  Shared by ``gather_symbol_windows`` (which
    shifts the windows) and ``demod_frames`` (which undoes the shifts in
    phase): both sides MUST see the identical clipped value, or a drift
    estimate beyond the margin silently corrupts the DQPSK differential
    instead of degrading gracefully."""
    return jnp.clip(jnp.round(
        jnp.asarray(drift, jnp.float32) * sym_pos / mode.frame_size
    ), -_DRIFT_MARGIN, _DRIFT_MARGIN)


def gather_symbol_windows(x: jnp.ndarray, frame_starts: jnp.ndarray,
                          mode: Mode = MODE_I,
                          cfo_norm: jnp.ndarray | float = 0.0,
                          drift: jnp.ndarray | float = 0.0,
                          layout: str | None = None) -> jnp.ndarray:
    """Gather the useful part of every OFDM symbol of every frame.

    ``x``: (n_samples,) complex64 baseband block.
    ``frame_starts``: (B,) int32 — index of the first sample of each frame's
    *null symbol* (may be traced values from the sync engine).
    ``cfo_norm``: residual CFO in units of the carrier spacing
    (f_cfo / (fs / T_u)); corrected with a per-sample phase ramp evaluated
    on the gathered windows.
    ``drift``: sample-clock drift in samples per frame (traced float ok);
    symbol windows slide linearly within the frame so a cheap-tuner ppm
    offset stays within +-0.5 sample at every symbol (the PRS fine sync
    only corrects the frame *start*).

    ``layout`` (or ``DABTOOLS_WINDOW_GATHER``) picks the extraction
    realization — identical values (same sample indices), different
    gather structure:

      twostage — one row-slice gather of whole frame windows, then the
                 (76, 2048) local windows gathered WITHIN each frame
                 slice (the historical default).
      persym   — one row-slice gather straight to the (B*76, 2048)
                 symbol windows: ~20%% fewer bytes, no second gather,
                 and a single flat-operand gather under a channel vmap.

    Returns (B, n_symbols, T_u) complex64.
    """
    if layout is None:
        layout = os.environ.get("DABTOOLS_WINDOW_GATHER", "twostage")
    if layout not in ("twostage", "persym"):
        raise ValueError("layout must be 'twostage' or 'persym'")
    sym_idx = jnp.arange(mode.n_symbols, dtype=jnp.int32)
    sym_pos = (mode.null_size + sym_idx * mode.symbol_size).astype(jnp.float32)
    MARGIN = _DRIFT_MARGIN
    drift_adj = _drift_adjustment(drift, sym_pos, mode).astype(jnp.int32)
    # NB: a window shifted by `a` samples multiplies FFT bin b by
    # exp(j*2*pi*a*b/N); demod_frames undoes this so the per-symbol integer
    # steps don't corrupt the DQPSK differential (a 1-sample step is
    # 2.4 rad at the band edge!).
    #
    # Layout note: both layouts below keep whole-window ROW slices as the
    # gather unit instead of ONE flat per-ELEMENT gather of the (B, S, T)
    # window tensor (which was the slow path on the accelerator this was
    # first written for); the samples/indices are identical either way.
    # No left margin needed: the smallest in-frame offset is
    # null+guard-MARGIN > 2500, so the slice begins exactly at the
    # frame start (identical clamping behavior to the old flat gather).
    frame_len = (mode.null_size + (mode.n_symbols - 1) * mode.symbol_size
                 + mode.guard + mode.fft_size + MARGIN)

    if x.shape[0] < frame_len:
        # shorter-than-a-frame inputs (unit tests, tail blocks): edge-pad
        # so the static slice fits — same values the old flat gather's
        # per-element index clamping produced
        x = jnp.pad(x, (0, frame_len - x.shape[0]), mode="edge")

    # Absolute sample index of the first sample of every symbol window
    # (also the CFO ramp's phase reference — the block timebase).
    starts = (frame_starts[:, None] + mode.null_size
              + sym_idx[None, :] * mode.symbol_size + mode.guard
              + drift_adj[None, :])

    # window_slices (not a plain vmapped dynamic_slice) so that an OUTER
    # channel vmap (config 3) collapses into the sample axis instead of
    # batching the gather operand (see ops.slicing).
    if layout == "persym":
        win = window_slices(
            x, starts.reshape(-1), mode.fft_size).reshape(
            frame_starts.shape[0], mode.n_symbols, mode.fft_size)
    else:
        local = (mode.null_size + sym_idx[:, None] * mode.symbol_size
                 + mode.guard + drift_adj[:, None]
                 + jnp.arange(mode.fft_size, dtype=jnp.int32)[None, :])
        frames = window_slices(x, frame_starts, frame_len)  # (B, frame_len)
        win = frames[:, local]
    idx = starts[:, :, None] + jnp.arange(mode.fft_size, dtype=jnp.int32)
    cfo_norm = jnp.asarray(cfo_norm, dtype=jnp.float32)
    # exp(-j*2*pi*f*t): f in carrier spacings, t in samples / T_u.
    phase = -2.0 * jnp.pi * jnp.mod(
        cfo_norm * idx.astype(jnp.float32) / mode.fft_size, 1.0)
    win = win * jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
    return win


def demod_frames(x: jnp.ndarray, frame_starts: jnp.ndarray,
                 mode: Mode = MODE_I,
                 cfo_norm: jnp.ndarray | float = 0.0,
                 drift: jnp.ndarray | float = 0.0):
    """Full-block OFDM demod: samples -> soft bits.

    Returns ``(soft, diag)``: soft (B, n_symbols-1, 2*K) float32 with
    positive => coded bit 0 (symbol 0 of each frame is the PRS and consumed
    as the differential reference); ``diag`` holds per-frame magnitudes for
    observability.
    """
    win = gather_symbol_windows(x, frame_starts, mode, cfo_norm, drift)
    spec = jnp.fft.fft(win, axis=-1)
    # Undo the per-symbol drift-adjustment window shifts in phase so every
    # symbol is referenced to one timebase (see gather_symbol_windows).
    sym_idx = jnp.arange(mode.n_symbols, dtype=jnp.int32)
    sym_pos = (mode.null_size + sym_idx * mode.symbol_size).astype(jnp.float32)
    adj = _drift_adjustment(drift, sym_pos, mode)
    bins = jnp.arange(mode.fft_size, dtype=jnp.float32)
    ph = -2.0 * jnp.pi * jnp.mod(
        adj[:, None] * bins[None, :] / mode.fft_size, 1.0)
    spec = spec * jax.lax.complex(jnp.cos(ph), jnp.sin(ph))[None]
    z = spec[:, 1:, :] * jnp.conj(spec[:, :-1, :])
    q = z[..., jnp.asarray(_interleave_idx(mode))]
    # Normalize per frame so Viterbi metrics are SNR-comparable.
    scale = jnp.mean(jnp.abs(q), axis=(1, 2), keepdims=True) + 1e-20
    qn = q / scale
    soft = jnp.concatenate([qn.real, qn.imag], axis=-1).astype(jnp.float32)
    diag = {
        "carrier_mag_mean": scale[:, 0, 0],
        # dispersion of |q| around its mean: crude per-frame SNR proxy
        "carrier_mag_cv": jnp.std(jnp.abs(q), axis=(1, 2)) / scale[:, 0, 0],
    }
    return soft, diag


def cfo_from_hz(cfo_hz, mode: Mode = MODE_I):
    """Convert Hz to carrier-spacing units used by ``gather_symbol_windows``."""
    carrier_spacing = SAMPLE_RATE / mode.fft_size
    return cfo_hz / carrier_spacing
