"""Empirical calibration constants (port of `radae_tpu/calibration.py`).

The pilot-statistics SNR estimator corrects its raw dB reading by the
straight line ``snrdB_est = (raw_dB - c) / m``, refit on this pipeline
(the analog of the reference's empirical fit, reference:
radae/dsp.py:415-416 m=0.8070 c=2.513).  The values come from
``tools/est_snr.py refit_pipeline`` (TransmitterOne -> calibrated AWGN ->
ReceiverOne raw pilot statistics, 0-12 dB, 3 seeds, max residual 0.52 dB)
and are radae_tpu's: a test holds the two packages' constants equal.

Both runtimes consume these constants:
  * the per-frame receiver, ``dsp/streaming.py`` (ReceiverOne);
  * the native C runtime, through ``native/snr_cal.h``, which
    :func:`render_native_header` renders byte for byte.  The header is
    shared by both packages and names radae_tpu's module as its source, so
    the template below keeps that text as it is; a test holds the render
    equal to the checked-in file.

To re-calibrate: run ``python -m radae_tpu_torch est_snr --refit``, update
the two constants here and in radae_tpu/calibration.py, then regenerate
the header with ``write_native_header()``.
"""

import os

SNR_CAL_M = 0.8745
SNR_CAL_C = 2.548

_HEADER_TEMPLATE = """\
/* GENERATED by radae_tpu/calibration.py -- do not edit by hand.
 * Single source of truth: radae_tpu/calibration.py (SNR_CAL_M/SNR_CAL_C).
 * Regenerate: python -c "from radae_tpu.calibration import \\
 *   write_native_header; write_native_header()"
 */
#ifndef RADAE_SNR_CAL_H
#define RADAE_SNR_CAL_H

#define RO_SNR_CAL_M {m}f
#define RO_SNR_CAL_C {c}f

#endif /* RADAE_SNR_CAL_H */
"""

NATIVE_HEADER = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "snr_cal.h")


def render_native_header() -> str:
    return _HEADER_TEMPLATE.format(m=repr(SNR_CAL_M), c=repr(SNR_CAL_C))


def write_native_header(path: str | None = None) -> str:
    """Write the header to `path` (default: the repo's native/snr_cal.h)."""
    path = path or NATIVE_HEADER
    with open(path, "w") as f:
        f.write(render_native_header())
    return path
