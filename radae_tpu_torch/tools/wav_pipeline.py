"""WAV -> RADAE -> WAV demo pipeline (port of
`radae_tpu/tools/wav_pipeline.py`; reference: inference.sh workflow).

Brackets the radae inference path with vocoder analysis/synthesis, like the
reference's `lpcnet_demo -features | inference.py | lpcnet_demo
-fargan-synthesis` pipe (reference: inference.sh:33-46).  Uses the external
FARGAN binary if present, else the trained neural vocoder, else the
built-in mel vocoder.  The port's `inference` and the neural vocoder run
on --device (default cuda; cpu when asked).

    python -m radae_tpu_torch wav model.npz in.wav out.wav \
        [--vocoder neural] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import wave

import numpy as np

from .. import resolve_device
from ..vocoder import get_vocoder, SPEECH_FS
from ..data.io import NB_TOTAL_FEATURES


def read_wav(path):
    with wave.open(path, "rb") as w:
        assert w.getsampwidth() == 2
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        fs = w.getframerate()
    if fs != SPEECH_FS:
        # linear resample to 16 kHz
        t_out = np.arange(int(len(pcm) * SPEECH_FS / fs)) * (fs / SPEECH_FS)
        pcm = np.interp(t_out, np.arange(len(pcm)), pcm).astype(np.int16)
    return pcm


def write_wav(path, pcm):
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SPEECH_FS)
        w.writeframes(np.asarray(pcm, np.int16).tobytes())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model_name", type=str)
    p.add_argument("wav_in", type=str)
    p.add_argument("wav_out", type=str)
    p.add_argument("--EbNodB", type=float, default=100)
    p.add_argument("--g_file", type=str, default="")
    p.add_argument("--passthru", action="store_true",
                   help="vocoder-only roundtrip, no radae")
    p.add_argument("--auxdata", action="store_true")
    p.add_argument("--vocoder", choices=("auto", "mel", "neural"),
                   default="auto",
                   help="synthesis back-end: auto = FARGAN binary if "
                        "present else the trained neural fixture else mel; "
                        "neural = fixtures/vocoder_nn.npz")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    resolve_device(args.device)

    voc = get_vocoder(backend=args.vocoder, device=args.device)
    pcm = read_wav(args.wav_in)
    feats = voc.extract(pcm)
    print(f"extracted {feats.shape[0]} feature frames "
          f"({type(voc).__name__})", file=sys.stderr)

    if args.passthru:
        out_feats = feats
    else:
        import tempfile
        from . import inference
        with tempfile.TemporaryDirectory() as d:
            fin, fout = f"{d}/f.f32", f"{d}/fh.f32"
            feats.astype(np.float32).tofile(fin)
            argv2 = [args.model_name, fin, fout, "--EbNodB", str(args.EbNodB),
                     "--rate_Fs", "--pilots", "--pilot_eq", "--eq_ls",
                     "--cp", "0.004", "--bottleneck", "3", "--coarse_mag",
                     "--time_offset", "-16", "--seed", str(args.seed),
                     "--device", args.device]
            if args.auxdata:
                argv2.append("--auxdata")
            if args.g_file:
                argv2 += ["--g_file", args.g_file]
            inference.main(argv2)
            out_feats = np.fromfile(fout, np.float32).reshape(
                -1, NB_TOTAL_FEATURES)

    pcm_out = voc.synthesize(out_feats)
    write_wav(args.wav_out, pcm_out)
    print(f"wrote {args.wav_out}: {len(pcm_out)/SPEECH_FS:.2f} s",
          file=sys.stderr)


if __name__ == "__main__":
    main()
