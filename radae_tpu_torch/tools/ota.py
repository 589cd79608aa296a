"""Over-the-air style end-to-end test driver (port of
`radae_tpu/tools/ota.py`).

Equivalent of the reference's ota_test.sh / chirp calibration workflow
(reference: ota_test.sh, test/chirp_mpp.sh): builds a tx file of
[chirp | silence | radae signal], passes it through the simulated channel at
a target C/No, then (a) verifies the chirp-measured C/No against the target
within 2 dB and locates the chirp in time, and (b) decodes the radae signal
with the standalone receiver and gates on loss/acq time.

The chirp and the channel are numpy; the port's `inference`, `rx` and
`loss` tools run on `--device` (default cuda; refused without a card),
with `--auxdata` where the checkpoint was trained with it (radae_tpu's
driver passes it never, so it cannot run such a checkpoint, the flagship
fixture among them).  Each tool's wall time goes to stderr.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np

from .chirp import gen_chirp, est_CNo
from ..channel.doppler import multipath_samples


def build_ota_tx(radae_iq: np.ndarray, Fs=8000, chirp_secs=2.0,
                 gap_secs=0.5):
    sig_rms = np.sqrt((np.abs(radae_iq) ** 2).mean())
    chirp = gen_chirp(Fs=Fs, T=chirp_secs, amp=sig_rms)
    gap = np.zeros(int(gap_secs * Fs), np.complex64)
    return np.concatenate([chirp, gap, radae_iq]).astype(np.complex64), chirp_secs


def apply_channel(tx: np.ndarray, CNodB: float, channel: str = "awgn",
                  Fs=8000, rng=None):
    """AWGN (or multipath) at a target C/No, C measured from the signal."""
    if rng is None:
        rng = np.random.default_rng(0)
    rx = tx.copy()
    if channel != "awgn":
        _, G, hf_gain = multipath_samples(channel, Fs, 50, 1,
                                          len(tx) / Fs + 1, rng=rng)
        G = hf_gain * G[: len(tx)]
        d = int(0.002 * Fs)
        rx = tx * G[:, 0]
        rx[d:] += tx[:-d] * G[:-d, 1]
    C = (np.abs(tx[np.abs(tx) > 0]) ** 2).mean()
    No = C / (10 ** (CNodB / 10))            # W/Hz
    sigma2 = No * Fs
    rx = rx + np.sqrt(sigma2 / 2) * (rng.standard_normal(len(rx))
                                     + 1j * rng.standard_normal(len(rx)))
    return rx.astype(np.complex64)


def trained_with_auxdata(model_name: str) -> bool:
    """Whether a native checkpoint records auxdata among its model args (as
    tools/evaluate.py reads them): inference and rx then take --auxdata."""
    if model_name in ("", "random") or model_name.endswith(".pth"):
        return False
    from ..convert import load_checkpoint
    meta = load_checkpoint(model_name)[1]
    return bool(meta.get("model_args", {}).get("auxdata"))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model_name", type=str)
    p.add_argument("features", type=str)
    p.add_argument("--CNodB", type=float, default=45.0)
    p.add_argument("--channel", type=str, default="awgn")
    p.add_argument("--loss_test", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the inference, rx and loss tools "
                        "(default cuda; cpu runs them on the host)")
    args = p.parse_args(argv)

    from . import inference, rx as rx_tool, loss as loss_tool
    from .. import resolve_device
    resolve_device(args.device)
    dev = ["--device", args.device]
    aux = ["--auxdata"] if trained_with_auxdata(args.model_name) else []
    wall = {}

    with tempfile.TemporaryDirectory() as d:
        txf = f"{d}/tx.f32"
        t0 = time.perf_counter()
        inference.main([args.model_name, args.features, "/dev/null",
                        "--EbNodB", "100", "--rate_Fs", "--pilots",
                        "--pilot_eq", "--eq_ls", "--cp", "0.004",
                        "--bottleneck", "3", "--coarse_mag",
                        "--time_offset", "-16", "--write_rx", txf,
                        "--end_of_over", "--seed", str(args.seed)]
                       + aux + dev)
        wall["inference"] = time.perf_counter() - t0
        radae_iq = np.fromfile(txf, np.complex64)
        tx, chirp_secs = build_ota_tx(radae_iq)
        rx = apply_channel(tx, args.CNodB, args.channel,
                           rng=np.random.default_rng(args.seed))

        # (a) chirp C/No calibration
        # analysis span must match the tx chirp length: est_CNo averages
        # over one span, so a longer span dilutes C with non-chirp windows
        CNo_meas, t_chirp = est_CNo(rx[: int((chirp_secs + 0.5) * 8000)],
                                    chirp_secs=chirp_secs)
        err = abs(CNo_meas - args.CNodB)
        print(f"chirp C/No: measured {CNo_meas:5.1f} dBHz "
              f"target {args.CNodB:5.1f} (err {err:4.1f} dB) "
              f"at t={t_chirp:4.2f} s")
        cal_ok = err < 2.0 and t_chirp <= chirp_secs

        # (b) decode the radae section
        rxf = f"{d}/rx.f32"
        fh = f"{d}/fh.f32"
        rx.tofile(rxf)
        t0 = time.perf_counter()
        try:
            rx_tool.main([args.model_name, rxf, fh] + aux + dev)
        except SystemExit:
            print("FAIL (no acquisition)")
            return 1
        wall["rx"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rc = loss_tool.main([args.features, fh, "--clip_end", "60",
                             "--loss_test", str(args.loss_test or 99),
                             "--acq_time_test", "5.0"] + dev)
        wall["loss"] = time.perf_counter() - t0
        print("ota wall time: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in wall.items()), file=sys.stderr)
        ok = cal_ok and rc == 0
        print("OTA PASS" if ok else "OTA FAIL")
        return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
