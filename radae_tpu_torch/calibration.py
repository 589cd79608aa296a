"""Empirical calibration constants (the part of `radae_tpu/calibration.py`
the port uses).

The pilot-statistics SNR estimator corrects its raw dB reading by the
straight line ``snrdB_est = (raw_dB - c) / m``, refit on this pipeline
(the analog of the reference's empirical fit, reference:
radae/dsp.py:415-416 m=0.8070 c=2.513).  The values are radae_tpu's.
"""

SNR_CAL_M = 0.8745
SNR_CAL_C = 2.548
