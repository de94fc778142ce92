"""CLI entry points mirroring the reference's surface (N18):

  ``dab2eti``  — IQ capture/stream -> ETI(NI) on stdout
                 (`upstream:dab2eti.c`; frequency/gain args are accepted for
                 interface parity but tuning hardware is out of scope —
                 file/stdin IQ and a librtlsdr dongle are the sources).
  ``eti2audio`` — ETI -> MP2 elementary stream (eti2mpa equivalent,
                 `upstream:eti2mpa.c`) or DAB+ AAC (raw/ADTS), selected by
                 service or sub-channel id with MCI auto-detection from the
                 FIC carried in the ETI.
"""
