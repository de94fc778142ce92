"""Signal-driven identification of a missing UEP Table 33 row (N7).

The one Table 33 row the offline build could not reconstruct with
confidence — (192 kbit/s, protection level 2) — is recoverable *from the
broadcast itself*: `tables.puncturing.enumerate_uep_candidates` lists
every constraint-satisfying row (the standard's row is guaranteed to be
among them), and the correct one is the only layout whose depuncture
keeps the Viterbi decode aligned — a wrong PI split shifts every
transmitted bit after the first divergent region, collapsing the path
metric.  All candidates decode in ONE batched Viterbi call (one device
launch over every candidate's lanes) rather than a Python loop.

Reference counterpart: none — upstream hard-codes its UEP tables
(SURVEY.md s2a R14); this subsystem exists precisely because this build
refuses to ship a guessed row as standard data.

The decision is accepted only when the winner clears an absolute
normalized-metric floor AND beats the runner-up by a margin, on every
probed logical frame; otherwise the sub-channel stays skipped
(``DabReceiver`` wires this up under ``uep_autoprobe``).
"""

from __future__ import annotations

import functools
import logging
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from dabtools_tpu.ops.fec import depuncture_gather_map
from dabtools_tpu.ops.viterbi import viterbi_decode
from dabtools_tpu.tables.puncturing import PuncturingProfile

log = logging.getLogger("dabtools_tpu.uep_probe")


@functools.partial(jax.jit, static_argnames=("profiles",))
def _metrics_batched(aligned: jnp.ndarray,
                     profiles: tuple[PuncturingProfile, ...]) -> jnp.ndarray:
    """(n_rows, tx_bits) soft rows -> (n_cand, n_rows) normalized path
    metrics, one batched Viterbi call over all candidates x rows.

    Every candidate for a (bitrate, level) pair shares data_bits, so the
    depunctured mother length is identical and the candidates stack into
    one lane batch.  Metrics are normalized by sum|soft| per row: the
    correct alignment approaches the soft-decision ceiling (~1.0 clean),
    a wrong one rides the random-walk floor.
    """
    # One fused gather instead of n_cand depuncture calls: stack the
    # candidates' gather maps (punctured positions read the zero pad).
    maps = jnp.asarray(np.stack(
        [depuncture_gather_map(p) for p in profiles]))  # (C, mother)
    padded = jnp.concatenate(
        [aligned, jnp.zeros((aligned.shape[0], 1), aligned.dtype)], axis=-1)
    dep = padded[:, maps]                               # (R, C, mother)
    stacked = dep.swapaxes(0, 1).reshape(
        len(profiles) * aligned.shape[0], -1)
    _, metric = viterbi_decode(stacked)
    ceil = jnp.sum(jnp.abs(aligned), axis=-1)          # (n_rows,)
    return metric.reshape(len(profiles), -1) / ceil[None, :]


def candidate_metrics(aligned_soft, profiles: Sequence[PuncturingProfile]
                      ) -> np.ndarray:
    """Normalized per-candidate, per-row path metrics (host ndarray)."""
    aligned = jnp.asarray(aligned_soft, dtype=jnp.float32)
    if aligned.ndim == 1:
        aligned = aligned[None]
    return np.asarray(_metrics_batched(aligned, tuple(profiles)))


def identify_uep_profile(aligned_soft,
                         profiles: Sequence[PuncturingProfile],
                         *, margin: float = 0.002,
                         floor: float = 0.80) -> tuple[int | None, dict]:
    """Pick the candidate the signal was punctured with, or None.

    ``aligned_soft``: (n_rows, tx_bits) fully-primed deinterleaved soft
    rows of the sub-channel (>=2 rows recommended; the receiver uses 4).
    Accepts index i iff candidate i wins on EVERY row, its mean
    normalized metric clears ``floor``, and it beats the runner-up's
    mean by ``margin``.  Defaults calibrated on synthetic sweeps: at
    noise where the mux still decodes (metric >= ~0.84), the true row
    wins every row with mean gap >= 0.0024 even against candidates
    differing in a single region boundary; 0.80/0.002 sit under that
    with the per-row-win test carrying the discrimination.  The floor
    alone is NOT a discriminator: the max over thousands of random
    alignments of a free Viterbi path correlation reaches ~0.85 on pure
    noise — but a different candidate wins each row there, so the
    per-row-win + margin tests reject it (pinned in
    tests/test_uep_autoprobe.py).  Returns ``(index_or_None,
    diagnostics)``.
    """
    if len(profiles) < 2:
        # With one candidate, per-row-win is trivially true and the gap
        # is measured against 0.0, so acceptance would degenerate to the
        # 0.80 floor alone — which free-path correlation on pure noise
        # can approach (see above).  The probe needs competition to
        # discriminate; refuse rather than rubber-stamp (ADVICE r4).
        return None, {"best": None, "n_candidates": len(profiles),
                      "reason": "need >= 2 candidate profiles for the "
                                "per-row-win/margin tests to bind"}
    m = candidate_metrics(aligned_soft, profiles)      # (n_cand, n_rows)
    mean = m.mean(axis=1)
    order = np.argsort(mean)[::-1]
    best, second = int(order[0]), int(order[1]) if len(order) > 1 else None
    per_row_win = bool((m[best] >= m.max(axis=0) - 1e-6).all())
    gap = float(mean[best] - (mean[second] if second is not None else 0.0))
    diag = {
        "best": best, "best_metric": float(mean[best]),
        "runner_up": second,
        "runner_up_metric": float(mean[second]) if second is not None
        else None,
        "gap": gap, "per_row_win": per_row_win,
        "n_rows": int(m.shape[1]), "n_candidates": int(m.shape[0]),
    }
    ok = per_row_win and mean[best] >= floor and gap >= margin
    if ok:
        log.info("UEP row identified from signal: %s (metric %.3f, "
                 "runner-up %.3f, gap %.3f over %d rows)",
                 profiles[best].name, mean[best],
                 diag["runner_up_metric"] or 0.0, gap, m.shape[1])
    return (best if ok else None), diag
