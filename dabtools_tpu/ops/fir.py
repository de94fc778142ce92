"""Wideband channelizer: one capture -> many DAB blocks (N2; BASELINE
config #4).

No counterpart exists in the reference (one RTL-SDR tunes one 2.048 Msps
block); this is the front-end that lets the device ingest a wideband SDR
capture (e.g. 16-20+ Msps spanning several Band III blocks) and feed the
channel-parallel receiver (N13).

Design:
* Per-block mixing uses a *periodic* mixer table (offsets live on a raster,
  so f/fs = p/q with small q) indexed mod q — exact phase for arbitrarily
  long streams with no float accumulation error, and a tiny gather instead
  of a huge phase ramp.
* The anti-alias FIR + decimation runs as `lax.conv_general_dilated` with
  window_strides=M (real taps applied to re/im planes) at HIGHEST
  precision (full f32: a GPU would otherwise run it in TF32); all K blocks
  are one batched conv.
* Streaming uses overlap-save: the shared (taps-1)-sample wideband tail is
  the carry state; under time-block sharding the same tail rides the
  ppermute halo (SURVEY.md s5.7).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from dabtools_tpu.constants import SAMPLE_RATE


def design_lowpass(num_taps: int, cutoff_norm: float,
                   beta: float = 8.6) -> np.ndarray:
    """Kaiser-windowed sinc low-pass; ``cutoff_norm`` = cutoff / fs."""
    n = np.arange(num_taps) - (num_taps - 1) / 2
    h = 2 * cutoff_norm * np.sinc(2 * cutoff_norm * n)
    h *= np.kaiser(num_taps, beta)
    return (h / h.sum()).astype(np.float32)


class Channelizer:
    """Split a wideband IQ stream into DAB baseband blocks.

    ``offsets_hz``: centre-frequency offset of each DAB block relative to
    the capture centre (integer Hz, on the receiver raster).

    ``method``:
      * ``"fft"`` (default when every offset is FFT-bin-aligned):
        overlap-save frequency-domain filtering — one batched FFT per
        chunk, mixing as an exact integer spectrum roll, filtering as a
        bin product, and decimation as alias-folding before a short IFFT.
        ~T/(2 log N) times less arithmetic than the direct form.
      * ``"direct"``: strided `conv_general_dilated`; also
        the cross-check reference for the fft method (tests assert
        equivalence to float tolerance).
    """

    N_FFT = 4096

    def __init__(self, fs_in: int, offsets_hz: list[int],
                 num_taps: int | None = None, out_rate: int = SAMPLE_RATE,
                 method: str = "auto"):
        if fs_in % out_rate:
            raise ValueError(
                f"fs_in ({fs_in}) must be an integer multiple of the DAB "
                f"rate ({out_rate})")
        self.fs_in = int(fs_in)
        self.decim = fs_in // out_rate
        self.offsets_hz = [int(f) for f in offsets_hz]
        for f in self.offsets_hz:
            if abs(f) > fs_in / 2:
                raise ValueError(f"offset {f} Hz outside capture bandwidth")
        if num_taps is None:
            # transition 0.768->0.944 MHz (adjacent-block spacing 1.712 MHz)
            trans = 0.176e6 / fs_in
            num_taps = int(np.ceil(5.0 / trans)) | 1
        self.num_taps = num_taps
        self.taps = design_lowpass(num_taps, cutoff_norm=0.85e6 / fs_in)
        self._mixers = [self._mixer_table(f) for f in self.offsets_hz]
        self._consumed = 0              # wideband samples consumed so far
        self._tail: np.ndarray | None = None
        self._taps_key = tuple(self.taps.tolist())

        bin_hz = fs_in / self.N_FFT
        aligned = all(f % bin_hz == 0 for f in self.offsets_hz)
        if method not in ("auto", "fft", "direct"):
            raise ValueError(f"unknown channelizer method {method!r}")
        # The overlap-save hop must be a positive multiple of decim:
        # num_taps <= N_FFT - decim guarantees it (num_taps < N_FFT alone
        # lets hop collapse to 0 for large decim, e.g. 143.36 Msps).
        fft_fits = num_taps <= self.N_FFT - self.decim
        if method == "auto":
            method = "fft" if aligned and fft_fits else "direct"
        if method == "fft" and not aligned:
            raise ValueError("fft method needs bin-aligned offsets "
                             f"(multiples of {bin_hz:.0f} Hz)")
        if method == "fft" and not fft_fits:
            raise ValueError(
                f"fft method needs num_taps <= {self.N_FFT - self.decim} "
                f"(N_FFT - decim) for a positive overlap-save hop; "
                f"got {num_taps}.  Use method='direct'.")
        self.method = method
        if method == "fft":
            n = self.N_FFT
            # correlation (to match the direct conv) => conjugated spectrum
            h = np.zeros(n, dtype=np.complex64)
            h[: num_taps] = self.taps
            self._hspec = np.conj(np.fft.fft(h)).astype(np.complex64)
            self._bin_shift = [int(f / bin_hz) for f in self.offsets_hz]
            self.hop = (n - num_taps + 1) // self.decim * self.decim

    def _mixer_table(self, f_hz: int) -> np.ndarray:
        g = math.gcd(abs(f_hz), self.fs_in) or self.fs_in
        q = self.fs_in // g
        p = f_hz // g
        i = np.arange(q, dtype=np.float64)
        return np.exp(-2j * np.pi * p * i / q).astype(np.complex64)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        """Feed wideband samples; returns (K, n_out) baseband complex64.

        Streaming: keeps the (taps-1)-sample tail and absolute phase so
        consecutive calls are seamless.
        """
        x = np.asarray(x, dtype=np.complex64)
        if self._tail is not None:
            x = np.concatenate([self._tail, x])
            start = self._consumed - self._tail.size
        else:
            start = 0
        if self.method == "fft":
            return self._call_fft(x, start)
        # Output m uses inputs [mM, mM + taps); keep the unfinished tail.
        n_out = max(0, (x.size - self.num_taps) // self.decim + 1)
        used = n_out * self.decim
        self._tail = x[used:].copy()
        self._consumed = start + used + self._tail.size
        if n_out == 0:
            return np.zeros((len(self.offsets_hz), 0), dtype=np.complex64)
        phases = tuple(int((start) % m.size) for m in self._mixers)
        return np.asarray(_channelize(
            jnp.asarray(x[: used + self.num_taps - 1]),
            tuple(jnp.asarray(m) for m in self._mixers),
            jnp.asarray(phases, dtype=jnp.int32),
            taps=self._taps_key, decim=self.decim,
            q_list=tuple(m.size for m in self._mixers)))

    def _call_fft(self, x: np.ndarray, start: int) -> np.ndarray:
        n, hop = self.N_FFT, self.hop
        n_chunks = max(0, (x.size - n) // hop + 1)
        n_out = n_chunks * (hop // self.decim)
        used = n_out * self.decim
        self._tail = x[used:].copy()
        self._consumed = start + used + self._tail.size
        if n_chunks == 0:
            return np.zeros((len(self.offsets_hz), 0), dtype=np.complex64)
        # Per-(offset, chunk) global mixer phase at the chunk start,
        # computed with exact integer arithmetic (no float accumulation).
        phases = np.empty((len(self.offsets_hz), n_chunks),
                          dtype=np.complex64)
        starts = start + np.arange(n_chunks, dtype=np.int64) * hop
        for k, f in enumerate(self.offsets_hz):
            g = math.gcd(abs(f), self.fs_in) or self.fs_in
            p, q = f // g, self.fs_in // g
            phases[k] = np.exp(-2j * np.pi * ((starts % q) * p % q) / q)
        return np.asarray(_channelize_fft(
            jnp.asarray(x[: (n_chunks - 1) * hop + n]),
            jnp.asarray(self._hspec), jnp.asarray(phases),
            n_fft=n, hop=hop, decim=self.decim,
            shifts=tuple(self._bin_shift)))


@functools.partial(jax.jit,
                   static_argnames=("n_fft", "hop", "decim", "shifts"))
def _channelize_fft(x, hspec, phases, *, n_fft, hop, decim, shifts):
    n_chunks = (x.shape[0] - n_fft) // hop + 1
    nd = n_fft // decim
    n_ch = len(shifts)
    idx = (jnp.arange(n_chunks)[:, None] * hop
           + jnp.arange(n_fft)[None, :])
    spec = jnp.fft.fft(x[idx], axis=-1)            # (n_chunks, n_fft)
    # All channels' spectrum rolls as one gather, then ONE batched IFFT
    # over (n_chunks, K, nd) — no per-channel kernel launches.
    roll = ((jnp.arange(n_fft)[None, :]
             + jnp.asarray(shifts, jnp.int32)[:, None]) % n_fft)  # (K, n)
    mixed = spec[:, roll] * hspec[None, None, :]   # (n_chunks, K, n_fft)
    folded = mixed.reshape(n_chunks, n_ch, decim, nd).sum(axis=2)
    z = jnp.fft.ifft(folded, axis=-1) / decim      # (n_chunks, K, nd)
    z = z[:, :, : hop // decim] * phases.T[:, :, None]
    return (z.transpose(1, 0, 2).reshape(n_ch, -1)).astype(jnp.complex64)


@functools.partial(jax.jit,
                   static_argnames=("taps", "decim", "q_list"))
def _channelize(x, mixers, phases, *, taps, decim, q_list):
    """Modulated-filter-bank form of mix -> FIR -> decimate.

    y_c[m] = sum_k h[k] x[mD+k] mix_c[start+mD+k]
           = mix_c[start+mD] * sum_k (h[k] mix_c[k]) x[mD+k],
    so all K channels are ONE strided conv with 2K real output channels
    (modulated complex taps, trace-time constants) plus a periodic
    output derotation — the wideband input is read once instead of
    materializing K mixed copies (the memory-bandwidth win), and the
    device sees one matmul-shaped conv instead of K single-channel ones.
    """
    h = jnp.asarray(taps, dtype=jnp.float32)       # (T,)
    n_taps = h.shape[0]
    n_ch = len(q_list)
    k_idx = jnp.arange(n_taps, dtype=jnp.int32)
    hh = jnp.stack([mix[k_idx % q]                 # (K, T) complex taps
                    for mix, q in zip(mixers, q_list)]) * h[None, :]
    filt = jnp.concatenate([hh.real, hh.imag], axis=0)[:, None, :]
    planes = jnp.stack([x.real, x.imag])[:, None, :]         # (2, 1, n)
    y = jax.lax.conv_general_dilated(
        planes, filt, window_strides=(decim,), padding="VALID",
        precision=jax.lax.Precision.HIGHEST)
    # y[b, oc]: b = re/im of x; oc < K = re(taps), oc >= K = im(taps)
    yr = y[0, :n_ch] - y[1, n_ch:]                 # (K, n_out)
    yi = y[0, n_ch:] + y[1, :n_ch]
    z = jax.lax.complex(yr, yi)
    m = jnp.arange(z.shape[1], dtype=jnp.int32)
    derot = jnp.stack([mix[(phases[k] + m * decim) % q]
                       for k, (mix, q) in enumerate(zip(mixers, q_list))])
    return z * derot
