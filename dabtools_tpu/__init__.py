"""dabtools_tpu: a DAB/DAB+ receiver framework in JAX.

The capabilities of linuxstb/dabtools, redesigned for JAX/XLA/Pallas on
GPUs (one card or a mesh of them).  See README.md for the architecture
and SURVEY.md for the reference analysis this build follows.

Quick start::

    from dabtools_tpu.models.receiver import DabReceiver
    rx = DabReceiver(n_frames=16)
    eti_frames = rx.feed(iq_samples)   # complex64 @ 2.048 Msps
"""

__version__ = "0.2.0"

from dabtools_tpu import constants  # noqa: F401
