"""Time-block (sequence) parallel receiver with halo exchange (N14/N15;
BASELINE config #5; SURVEY.md s5.7).

The IQ stream's time axis is sharded across the mesh's ``time`` axis.  Each
shard decodes its own ``F`` transmission frames plus ``W`` *warmup* frames
read from a left halo obtained by `ppermute` from its left neighbor — the
same ring pattern as context-parallel attention, minus the softmax algebra.
The warmup re-primes the 16-CIF time-deinterleaver locally (W*n_cifs >= 16),
turning the only sequential cross-shard dependency into redundant compute:
shards are then fully independent, so scaling is limited only by the halo
bytes (LH+RH samples) between devices.

Boundary shards take their halo from explicit ``prefix``/``suffix`` arrays
(the streaming host supplies the previous span's tail / next span's head;
zeros at cold start give the usual startup transient).

Deterministic seams: shard ``i`` emits exactly global frames
``[i*F, (i+1)*F)`` of the span — no duplicates, no gaps, bit-identical to
the sequential receiver (asserted in tests on an 8-device CPU mesh).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dabtools_tpu import constants as C
from dabtools_tpu.fic.config import Ensemble
from dabtools_tpu.models.receiver import pipeline_core
from dabtools_tpu.ops.fec import init_deinterleave_ring

P = jax.sharding.PartitionSpec


def halo_sizes(warmup_frames: int, mode=C.MODE_I,
               left_margin: int = 256, right_margin: int = 4096):
    """(LH, RH) halo sample counts."""
    return warmup_frames * mode.frame_size + left_margin, right_margin


def timeblock_receiver(mesh: jax.sharding.Mesh, ensemble: Ensemble,
                       mode=C.MODE_I, frames_per_shard: int = 4,
                       warmup_frames: int = 5, search: int = 192,
                       max_int_cfo: int = 8, left_margin: int = 256,
                       right_margin: int = 4096):
    """Build the jitted sharded span decoder.

    Returns ``fn(x, prefix, suffix, g0) -> out`` where
      * ``x``: (n_channels, n_shards*F*frame_size) complex64, frame-aligned
        (sample 0 is a null-symbol start in steady state);
      * ``prefix``: (n_channels, LH) samples preceding the span;
      * ``suffix``: (n_channels, RH) samples following it;
      * ``g0``: int32 global frame index of the span's first frame;
      * ``out``: global pytree — fib_bytes (C, n_shards*F, 12, 32),
        subch[id] (C, n_shards*F*n_cifs, data_bits), metrics, diagnostics.
    """
    n_shards = mesh.shape["time"]
    fr = mode.frame_size
    f_own = frames_per_shard
    w = warmup_frames
    if w * mode.n_cifs < C.TIME_INTERLEAVE_DEPTH:
        raise ValueError(
            f"warmup_frames={w} gives {w * mode.n_cifs} CIFs < "
            f"{C.TIME_INTERLEAVE_DEPTH} needed to prime the deinterleaver")
    # Mode III FIC codewords span 3 frames: every shard's scan must start
    # on a codeword boundary (global frame multiple of 3), so shard spans
    # and warmup must preserve that phase (and g0 must be a multiple of 3).
    fic_span = 1
    if mode.fic_bits_per_frame % C.FIC_PUNCTURED_BITS:
        import math
        fic_span = C.FIC_PUNCTURED_BITS // math.gcd(
            mode.fic_bits_per_frame, C.FIC_PUNCTURED_BITS)
        if f_own % fic_span or w % fic_span:
            raise ValueError(
                f"Mode {mode.name}: frames_per_shard={f_own} and "
                f"warmup_frames={w} must be multiples of {fic_span} "
                f"(FIC codewords span {fic_span} frames)")
    lh, rh = halo_sizes(w, mode, left_margin, right_margin)
    if max(lh, rh) > f_own * fr:
        raise ValueError(
            f"halo ({lh} samples) exceeds the shard span "
            f"({f_own} frames = {f_own * fr}); single-hop ppermute halo "
            f"exchange requires frames_per_shard > warmup_frames")
    guesses = left_margin + jnp.arange(w + f_own, dtype=jnp.int32) * fr

    def local_fn(x, prefix, suffix, g0):
        # x: (C_loc, F*fr) — this time-shard's samples
        i = jax.lax.axis_index("time")
        lctx = jax.lax.ppermute(
            x[:, -lh:], "time", [(k, k + 1) for k in range(n_shards - 1)])
        rctx = jax.lax.ppermute(
            x[:, :rh], "time", [(k, k - 1) for k in range(1, n_shards)])
        lctx = jnp.where(i == 0, prefix, lctx)
        rctx = jnp.where(i == n_shards - 1, suffix, rctx)
        xe = jnp.concatenate([lctx, x, rctx], axis=-1)

        cif0 = (g0 + i * f_own - w) * mode.n_cifs

        def one_channel(xc):
            rings = {str(s.subchid): init_deinterleave_ring(s.profile.tx_bits)
                     for s in ensemble.subchannels}
            out, _, _ = pipeline_core(
                xc, guesses, rings, cif0, ensemble=ensemble, mode=mode,
                search=search, max_int_cfo=max_int_cfo)
            return out

        out = jax.vmap(one_channel)(xe)
        own_cifs = slice(w * mode.n_cifs, None)
        return {
            "fib_bytes": out["fib_bytes"][:, w:],
            "fic_metric": out["fic_metric"][:, w:],
            "prs_peak": out["prs_peak"][:, w:],
            "prs_offset": out["prs_offset"][:, w:],
            "cfo_carriers": out["cfo_carriers"][:, None],
            "subch": {k: v[:, own_cifs] for k, v in out["subch"].items()},
            "subch_metric": {k: v[:, own_cifs]
                             for k, v in out["subch_metric"].items()},
        }

    sharded = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P("channels", "time"), P("channels"), P("channels"), P()),
        out_specs={
            "fib_bytes": P("channels", "time"),
            "fic_metric": P("channels", "time"),
            "prs_peak": P("channels", "time"),
            "prs_offset": P("channels", "time"),
            "cfo_carriers": P("channels", "time"),
            "subch": {str(s.subchid): P("channels", "time")
                      for s in ensemble.subchannels},
            "subch_metric": {str(s.subchid): P("channels", "time")
                             for s in ensemble.subchannels},
        },
        check_vma=False)

    @jax.jit
    def _run(x, prefix, suffix, g0):
        expect = n_shards * f_own * fr
        if x.shape[-1] != expect:
            raise ValueError(
                f"span must be {expect} samples "
                f"({n_shards} shards x {f_own} frames), got {x.shape[-1]}")
        if prefix.shape[-1] != lh or suffix.shape[-1] != rh:
            raise ValueError(
                f"prefix/suffix must be {lh}/{rh} samples, got "
                f"{prefix.shape[-1]}/{suffix.shape[-1]}")
        return sharded(x, prefix, suffix,
                       jnp.asarray(g0, dtype=jnp.int32))

    def run(x, prefix, suffix, g0):
        # The third leg of the Mode III codeword-phase invariant: g0
        # itself must sit on a codeword boundary (the other two are
        # checked at construction above).  Checked here, outside the
        # jit, where g0 is still a concrete int.
        if (fic_span > 1 and isinstance(g0, (int, np.integer))
                and int(g0) % fic_span):
            raise ValueError(
                f"Mode {mode.name}: g0={g0} must be a multiple of "
                f"{fic_span} (FIC codewords span {fic_span} frames)")
        return _run(x, prefix, suffix, g0)

    return run
