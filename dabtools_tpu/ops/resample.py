"""Rational-rate polyphase resampler: native SDR rates -> 2.048 Msps.

The reference requires the dongle to be *tuned* to exactly 2.048 Msps
(`upstream:dab2eti.c` sets the rate); many SDRs run cleaner at other rates
(RTL-SDR's natural 2.4 Msps, Airspy 2.5/10 Msps...).  This front-end
converts by L/M with a polyphase FIR:

  y[n] = sum_k h[k*L + phase(n)] * x[floor(n*M/L) - k]

On the device the L polyphase branches become one batched product —
gather the input into (n_out, taps_per_phase) windows, multiply by the
per-output phase's tap row elementwise and sum in f32 (no matmul, so no
reduced-precision TF32 path on a GPU; only the summation order differs
from the CPU's).  Streaming keeps an input tail + output-phase offset so
chunk boundaries are seamless (same overlap-save discipline as the
channelizer, N2).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from dabtools_tpu.constants import SAMPLE_RATE
from dabtools_tpu.ops.fir import design_lowpass


class Resampler:
    """Convert complex IQ from ``fs_in`` to ``fs_out`` (default DAB rate)."""

    def __init__(self, fs_in: int, fs_out: int = SAMPLE_RATE,
                 taps_per_phase: int = 24, beta: float = 8.6):
        g = math.gcd(int(fs_in), int(fs_out))
        self.up = fs_out // g          # L
        self.down = fs_in // g         # M
        if self.up > 512:
            raise ValueError(
                f"{fs_in} -> {fs_out} needs interpolation factor {self.up}; "
                "choose a rationally-related capture rate")
        self.fs_in, self.fs_out = int(fs_in), int(fs_out)
        n_taps = taps_per_phase * self.up
        # cutoff at the tighter of the two Nyquists, in units of fs_in*L
        cutoff = 0.45 * min(fs_in, fs_out)
        proto = design_lowpass(n_taps, cutoff / (fs_in * self.up), beta)
        proto *= self.up               # interpolation gain
        # polyphase bank: phase p uses taps h[p], h[p+L], ...
        self.bank = proto.reshape(taps_per_phase, self.up).T.copy()
        self.taps_per_phase = taps_per_phase
        self._tail = np.zeros(taps_per_phase - 1, dtype=np.complex64)
        self._next_out = 0             # global output index
        self._consumed = 0             # global input samples consumed
        self._fn = jax.jit(self._resample_chunk)

    def _resample_chunk(self, x, phases, starts):
        # x: (n_in,) complex64; windows: (n_out, T) via gather
        idx = starts[:, None] + jnp.arange(self.taps_per_phase)[None, ::-1]
        win = x[idx]                               # (n_out, T)
        taps = jnp.asarray(self.bank)[phases]      # (n_out, T)
        yr = jnp.sum(win.real * taps, axis=-1)
        yi = jnp.sum(win.imag * taps, axis=-1)
        return jax.lax.complex(yr, yi)

    def __call__(self, samples: np.ndarray) -> np.ndarray:
        x = np.concatenate([self._tail,
                            np.asarray(samples, dtype=np.complex64)])
        base = self._consumed - self._tail.size    # global idx of x[0]
        t = self.taps_per_phase
        # output n uses inputs [floor(n*M/L) - t + 1 .. floor(n*M/L)]
        n0 = self._next_out
        # last output whose newest input is within x:
        last_in = base + x.size - 1
        n1 = (last_in * self.up + self.up - 1) // self.down  # upper bound
        while n1 * self.down // self.up > last_in:
            n1 -= 1
        if n1 < n0:
            self._tail = x[-(t - 1):] if x.size >= t - 1 else x
            self._consumed = base + x.size
            return np.zeros(0, dtype=np.complex64)
        n = np.arange(n0, n1 + 1)
        newest = n * self.down // self.up          # global input index
        starts = (newest - base) - (t - 1)
        # warmup is covered by the zero-filled initial tail, so starts is
        # always non-negative (the first call's base is -(t-1))
        assert starts.min() >= 0, "resampler window before buffer start"
        phases = (n * self.down) % self.up
        y = np.asarray(self._fn(jnp.asarray(x),
                                jnp.asarray(phases, jnp.int32),
                                jnp.asarray(starts, jnp.int32)))
        self._next_out = int(n[-1]) + 1
        self._tail = x[-(t - 1):].copy()
        self._consumed = base + x.size
        return y
