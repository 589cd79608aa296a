"""Diagnostic plot suite (a numpy and matplotlib copy of
`radae_tpu/tools/plots.py`; reference: radae_plots.m, plot_specgram.m).

Matplotlib equivalents of the Octave plot helpers: QPSK scatter (2-D and
3-D density mesh), signal spectrum, spectrogram, PAPR CCDF, 99% power
bandwidth, per-frame loss curves, multi-run loss-vs-Eq/No (and C/No)
comparison curves, and BER-vs-theory overlays.  All figures are written
to PNG (headless).  matplotlib is imported at a plot's first call, not
with the module.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def scatter_plot(z_path, out_png, latent_dim=80):
    plt = _plt()
    z = np.fromfile(z_path, np.float32)
    sym = z[::2] + 1j * z[1::2]
    plt.figure(figsize=(5, 5))
    plt.plot(sym.real[:20000], sym.imag[:20000], "+", ms=2)
    plt.axis("equal"); plt.grid(True)
    plt.title("QPSK scatter"); plt.savefig(out_png); plt.close()


def spectrum_plot(iq_path, out_png, Fs=8000):
    plt = _plt()
    x = np.fromfile(iq_path, np.complex64)
    n = min(len(x), 1 << 16)
    spec = np.abs(np.fft.fft(x[:n] * np.hanning(n))) ** 2
    f = np.fft.fftfreq(n, 1 / Fs)
    order = np.argsort(f)
    plt.figure(figsize=(8, 4))
    plt.plot(f[order], 10 * np.log10(spec[order] + 1e-12))
    plt.xlabel("Hz"); plt.ylabel("dB"); plt.grid(True)
    # 99% power bandwidth annotation (radae_plots.m)
    psorted = np.sort(spec)[::-1]
    csum = np.cumsum(psorted)
    plt.title(f"spectrum (99% power in top "
              f"{(csum < 0.99 * csum[-1]).sum() * Fs / n:.0f} Hz)")
    plt.savefig(out_png); plt.close()


def papr_plot(iq_path, out_png):
    plt = _plt()
    x = np.fromfile(iq_path, np.complex64)
    p = np.abs(x) ** 2
    mean_p = p.mean()
    papr_db = 10 * np.log10(np.maximum(p, 1e-12) / mean_p)
    thr = np.linspace(0, 12, 200)
    ccdf = [(papr_db > t).mean() for t in thr]
    plt.figure(figsize=(6, 4))
    plt.semilogy(thr, ccdf)
    plt.xlabel("PAPR (dB)"); plt.ylabel("CCDF"); plt.grid(True)
    plt.title(f"PAPR: {10*np.log10(p.max()/mean_p):.2f} dB peak")
    plt.savefig(out_png); plt.close()


def specgram_plot(iq_path, out_png, Fs=8000, fmin=0.0, fmax=3000.0,
                  real_input=False):
    """Spectrogram (reference: plot_specgram.m): one spectral slice every
    20 ms over a 160 ms window, magnitude normalised to 0 dB peak and
    clipped to the [-20, -3] dB band, displayed on a log scale."""
    plt = _plt()
    x = np.fromfile(iq_path, np.float32 if real_input else np.complex64)
    step = int(20 * Fs / 1000)
    window = int(160 * Fs / 1000)
    if len(x) < window:        # shorter than one analysis window: zero-pad
        x = np.pad(x, (0, window - len(x)))
    fftn = 1 << int(np.ceil(np.log2(window)))
    win = np.hanning(window)
    n_slices = max(1, (len(x) - window) // step + 1)
    S = np.empty((fftn // 2 - 1, n_slices))
    for i in range(n_slices):
        seg = x[i * step:i * step + window] * win
        spec = np.fft.fft(seg, fftn)
        S[:, i] = np.abs(spec[1:fftn // 2])    # 0 < f <= Fs/2
    S /= max(S.max(), 1e-30)
    S = np.clip(S, 10 ** (-20 / 10), 10 ** (-3 / 10))
    t = np.arange(n_slices) * step / Fs
    f = np.arange(1, fftn // 2) * Fs / fftn
    plt.figure(figsize=(8, 4))
    plt.imshow(np.log(S), origin="lower", aspect="auto",
               extent=[t[0], t[-1] if len(t) > 1 else step / Fs,
                       f[0], f[-1]], cmap="viridis")
    plt.ylim(fmin, fmax)
    plt.xlabel("Time (s)"); plt.ylabel("Freq (Hz)")
    plt.title("spectrogram"); plt.colorbar(label="log |S|")
    plt.savefig(out_png); plt.close()


def scatter3d_plot(z_path, out_png, bins=25):
    """3-D constellation density (radae_plots.m figure 3: hist3 + mesh):
    2-D histogram of the received symbols rendered as a surface."""
    plt = _plt()
    from mpl_toolkits.mplot3d import Axes3D  # noqa: F401 (side-effect)

    z = np.fromfile(z_path, np.float32)
    sym = z[::2] + 1j * z[1::2]
    nn, xe, ye = np.histogram2d(sym.real, sym.imag, bins=bins)
    xc = 0.5 * (xe[:-1] + xe[1:])
    yc = 0.5 * (ye[:-1] + ye[1:])
    X, Y = np.meshgrid(xc, yc, indexing="ij")
    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot_wireframe(X, Y, nn, rstride=1, cstride=1, linewidth=0.5)
    ax.set_xlabel("I"); ax.set_ylabel("Q"); ax.set_zlabel("count")
    ax.set_title("Scatter 3D")
    fig.savefig(out_png); plt.close(fig)


def loss_eqno_plot(pairs, out_png, Rs=None, latent_dim=None, B=None):
    """Multi-run loss-vs-Eq/No comparison (radae_plots.m loss_EqNo_plot /
    loss_CNo_plot): `pairs` is a list of (EqNo_file.txt, legend).  Each
    file holds rows of (EqNo dB, loss) as dumped by train --plot_EqNo.
    With Rs/latent_dim/B given, the x-axis converts to C/No (B=1) or
    SNR in bandwidth B: CNo = EqNo + 10 log10(Rs * Nc / B)."""
    plt = _plt()
    plt.figure(figsize=(7, 4))
    for path, legend in pairs:
        data = np.loadtxt(path)
        data = np.atleast_2d(data)
        x = data[:, 0]
        if Rs is not None and latent_dim is not None and B is not None:
            x = x + 10 * np.log10(Rs * (latent_dim / 2) / B)
        plt.plot(x, data[:, 1], "+-", label=legend.replace("_", " "))
    if Rs is not None and latent_dim is not None and B is not None:
        plt.xlabel("C/No (dB)" if B == 1 else f"SNR in {B} Hz (dB)")
    else:
        plt.xlabel("Eq/No (dB)")
    plt.ylabel("loss"); plt.grid(True); plt.legend(frameon=False)
    plt.savefig(out_png); plt.close()


def ber_plot(pairs, out_png):
    """BER-vs-Eb/No curves with closed-form AWGN and Rayleigh/multipath
    theory overlays (radae_plots.m ofdm_sync_plots)."""
    from scipy.special import erfc
    plt = _plt()
    EbNodB = np.arange(-8, 5)
    EbNo = 10 ** (EbNodB / 10)
    plt.figure(figsize=(7, 4))
    plt.semilogy(EbNodB, 0.5 * erfc(np.sqrt(EbNo)), "b+-",
                 label="AWGN theory")
    plt.semilogy(EbNodB, 0.5 * (1 - np.sqrt(EbNo / (EbNo + 1))), "bx-",
                 label="Multipath theory")
    for path, legend in pairs:
        data = np.atleast_2d(np.loadtxt(path))
        plt.semilogy(data[:, 0], data[:, 1], "o-",
                     label=legend.replace("_", " "))
    plt.grid(True, which="both"); plt.legend(frameon=False)
    plt.xlabel("Eb/No (dB)"); plt.ylabel("BER")
    plt.savefig(out_png); plt.close()


def loss_curves_plot(txt_paths, out_png):
    plt = _plt()
    plt.figure(figsize=(7, 4))
    for path in txt_paths:
        y = np.loadtxt(path)
        if y.ndim == 2:
            plt.plot(y[:, 0], y[:, 1], label=path)
        else:
            plt.semilogy(np.arange(1, len(y) + 1), y, label=path)
    plt.grid(True); plt.legend(); plt.xlabel("epoch / EqNo dB")
    plt.ylabel("loss"); plt.savefig(out_png); plt.close()


def _pairs(inputs):
    if len(inputs) % 2:
        raise SystemExit("expected FILE LEGEND pairs")
    return list(zip(inputs[::2], inputs[1::2]))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("kind", choices=["scatter", "scatter3d", "spectrum",
                                    "specgram", "papr", "loss",
                                    "loss_eqno", "loss_cno", "ber"])
    p.add_argument("inputs", nargs="+",
                   help="data file(s); loss_eqno/loss_cno/ber take "
                        "FILE LEGEND pairs")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--fmax", type=float, default=3000.0,
                   help="specgram: top of displayed band (Hz)")
    p.add_argument("--real", action="store_true",
                   help="specgram: input is real f32, not complex IQ")
    p.add_argument("--Rs", type=float, default=50.0)
    p.add_argument("--latent-dim", type=int, default=80)
    p.add_argument("--B", type=float, default=3000.0,
                   help="loss_cno: noise bandwidth (1 for C/No)")
    args = p.parse_args(argv)
    if args.kind == "scatter":
        scatter_plot(args.inputs[0], args.out)
    elif args.kind == "scatter3d":
        scatter3d_plot(args.inputs[0], args.out)
    elif args.kind == "spectrum":
        spectrum_plot(args.inputs[0], args.out)
    elif args.kind == "specgram":
        specgram_plot(args.inputs[0], args.out, fmax=args.fmax,
                      real_input=args.real)
    elif args.kind == "papr":
        papr_plot(args.inputs[0], args.out)
    elif args.kind == "loss_eqno":
        loss_eqno_plot(_pairs(args.inputs), args.out)
    elif args.kind == "loss_cno":
        loss_eqno_plot(_pairs(args.inputs), args.out, Rs=args.Rs,
                       latent_dim=args.latent_dim, B=args.B)
    elif args.kind == "ber":
        ber_plot(_pairs(args.inputs), args.out)
    else:
        loss_curves_plot(args.inputs, args.out)
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
