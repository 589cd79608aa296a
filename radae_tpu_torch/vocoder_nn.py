"""Neural vocoder: parallel harmonic + filtered-noise synthesis (port of
`radae_tpu/vocoder_nn.py`).

A small frame-rate GRU maps the 20 vocoder features to harmonic amplitudes
and noise band gains; synthesis is then a parallel oscillator bank
(cumulative-phase cosines at multiples of the pitch, linear amplitude
upsampling) plus fixed band-pass-filtered noise, and the multi-resolution
spectral loss runs on framed real DFT matmuls.  radae_tpu has no Pallas
kernel for this net, so the port runs it as torch ops on the device it is
given: the frame GRU is `torch.gru` (the op behind torch.nn.GRU, cuDNN on
the card; gate order r, z, n and n = tanh(x_n + r * (W_hn h + b_hn)) are
radae_tpu's, and its `gru.w_ih` (3H, I) is `weight_ih_l0` as it is), the
noise bank `F.conv1d` (a cross-correlation padded taps//2, as radae_tpu's
conv_general_dilated).  The oscillators' phase is an f32 cumsum over the
whole input, as radae_tpu's: on the card it rounds otherwise than on the
CPU, so long inputs agree by spectral distance, short ones value for value.

Same interface contract as vocoder.MelVocoder / FARGANVocoder: 36-float
frames (18 cepstra + pitch + voicing), int16 pcm at 16 kHz.  Analysis is
shared with MelVocoder.  Params are radae_tpu's tree ({"in", "gru",
"harm", "noise"}, numpy from `init_params` / `load_params`);
`params_to_torch` puts them on a device.

Train:  python -m radae_tpu_torch vocoder_nn train CORPUS.npz OUTDIR
Synth:  python -m radae_tpu_torch vocoder_nn synth WEIGHTS.npz FEAT.f32 OUT.pcm
Corpus: python -m radae_tpu_torch vocoder_nn corpus WAVDIR CORPUS.npz
(each with --device cpu to run on the CPU; cuda is the default)
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import warnings
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.optim.lr_scheduler import LambdaLR

from . import resolve_device
from .data.io import NB_TOTAL_FEATURES
from .runtime import f32_device
from .vocoder import (FRAME, NCEPS, NFFT, PITCH_MAX_HZ, PITCH_MIN_HZ,
                      SPEECH_FS, MelVocoder)

N_HARM = 64                  # oscillator bank size (62.5 Hz f0 -> 4 kHz)
N_NOISE = 18                 # noise bands
HID = 192
LAG_MIN = int(SPEECH_FS / PITCH_MAX_HZ)
LAG_MAX = int(SPEECH_FS / PITCH_MIN_HZ)
LAG_GEO = float(np.sqrt(LAG_MIN * LAG_MAX))
DECAY_ALPHA = 0.2            # cosine decay's floor, a fraction of lr


# -- fixed noise-band FIR bank (host-precomputed) ---------------------------

def _noise_firs(nb=N_NOISE, taps=129, fs=SPEECH_FS):
    """Mel-spaced band-pass FIRs, (nb, taps)."""
    def mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def imel(m):
        return 700.0 * (10 ** (m / 2595.0) - 1.0)

    edges = imel(np.linspace(mel(80), mel(fs / 2 - 100), nb + 1))
    t = np.arange(taps) - taps // 2
    win = np.hamming(taps)
    firs = np.zeros((nb, taps), np.float32)
    for b in range(nb):
        lo, hi = edges[b], edges[b + 1]
        ideal = (2 * hi / fs * np.sinc(2 * hi * t / fs)
                 - 2 * lo / fs * np.sinc(2 * lo * t / fs))
        firs[b] = (ideal * win).astype(np.float32)
    return firs


# -- model ------------------------------------------------------------------

def init_params(seed: int = 0, hid: int = HID):
    """Random weights (numpy): radae_tpu's `init_params(seed, hid)` draw
    for draw."""
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"w": (rng.standard_normal((i, o)) / np.sqrt(i))
                .astype(np.float32),
                "b": np.zeros(o, np.float32)}

    def gru(i, h):
        return {"w_ih": (rng.standard_normal((3 * h, i)) / np.sqrt(i))
                .astype(np.float32),
                "w_hh": (rng.standard_normal((3 * h, h)) / np.sqrt(h))
                .astype(np.float32),
                "b_ih": np.zeros(3 * h, np.float32),
                "b_hh": np.zeros(3 * h, np.float32)}

    return {"in": dense(20, hid), "gru": gru(hid, hid),
            "harm": dense(hid, N_HARM + 1), "noise": dense(hid, N_NOISE)}


def params_to_torch(params, device="cuda") -> Dict[str, Dict[str, Any]]:
    """radae_tpu's vocoder params ({"in", "gru", "harm", "noise"} of numpy
    arrays, or of tensors) -> the same tree of f32 tensors on `device`,
    in the same layouts (dense w (in, out), gru w_ih (3H, in))."""
    dev = f32_device(device)
    return {k1: {k2: torch.as_tensor(v, dtype=torch.float32).to(dev)
                 for k2, v in d.items()} for k1, d in params.items()}


def _gru_seq(g, x):
    """(B, T, I) -> (B, T, H): the GRU from the zero state."""
    H = g["w_hh"].shape[1]
    h0 = x.new_zeros((1, x.shape[0], H))
    with warnings.catch_warnings():
        # cuDNN copies the four tensors into one buffer a call (small)
        warnings.filterwarnings("ignore", "RNN module weights")
        y, _ = torch.gru(x, h0, [g["w_ih"], g["w_hh"], g["b_ih"], g["b_hh"]],
                         True, 1, 0.0, torch.is_grad_enabled(), False, True)
    return y


def frame_net(params, feats):
    """(B, T, 20) features -> (harm_amps (B,T,N_HARM), noise_g (B,T,N_NOISE)).

    Amplitudes come out in linear domain via exp of a bounded pre-
    activation; the cepstral energy term keeps them well-scaled."""
    x = torch.tanh(feats @ params["in"]["w"] + params["in"]["b"])
    h = _gru_seq(params["gru"], x)
    ha = h @ params["harm"]["w"] + params["harm"]["b"]
    gain = torch.exp(torch.clamp(ha[..., :1], -12.0, 6.0))
    harm = torch.softmax(ha[..., 1:], dim=-1) * gain
    noise = torch.exp(torch.clamp(h @ params["noise"]["w"]
                                  + params["noise"]["b"], -12.0, 6.0))
    return harm, noise


def _upsample_linear(x, n=FRAME):
    """(B, T, K) frame values -> (B, (T-1)*n, K) linear interpolation."""
    w = (torch.arange(n, dtype=torch.float32, device=x.device)
         / n)[None, None, :, None]
    a, b = x[:, :-1, None, :], x[:, 1:, None, :]
    up = a * (1.0 - w) + b * w
    B, Tm1, _, K = up.shape
    return up.reshape(B, Tm1 * n, K)


def synth(params, feats, noise_sig):
    """(B, T, 20) features + (B, (T-1)*FRAME) white noise -> pcm float.

    Output covers frames 0..T-2 (one frame of look-ahead, mirroring the
    2-frame analysis window)."""
    dev = feats.device
    f0 = SPEECH_FS / (LAG_GEO * 2.0 ** (1.5 * feats[..., 18]))   # (B, T)
    harm, noiseg = frame_net(params, feats)

    f0_up = _upsample_linear(f0[..., None])[..., 0]     # (B, S)
    phase = 2.0 * math.pi * torch.cumsum(f0_up, dim=1) / SPEECH_FS
    k = torch.arange(1, N_HARM + 1, dtype=torch.float32, device=dev)
    # antialias: zero any harmonic above 0.95 * Nyquist (per sample)
    alias = (f0_up[..., None] * k[None, None, :]) < (0.475 * SPEECH_FS)
    cosines = torch.cos(phase[..., None] * k[None, None, :]) * alias
    amps = _upsample_linear(harm)                        # (B, S, N_HARM)
    harmonic = torch.sum(cosines * amps, dim=-1)

    firs = torch.as_tensor(_noise_firs(), device=dev)   # (NB, taps)
    taps = firs.shape[1]
    banded = F.conv1d(noise_sig[:, None, :], firs[:, None, :],
                      padding=taps // 2)                 # (B, NB, S)
    gains = _upsample_linear(noiseg)                     # (B, S, NB)
    noise = torch.sum(banded.transpose(1, 2) * gains, dim=-1)
    return harmonic + noise


# -- multi-resolution spectral loss (real matmuls, no device FFT) -----------

def _stft_mats(nfft):
    t = np.arange(nfft)[:, None]
    f = np.arange(nfft // 2 + 1)[None, :]
    w = np.hanning(nfft)[:, None]
    c = (np.cos(2 * np.pi * t * f / nfft) * w).astype(np.float32)
    s = (np.sin(2 * np.pi * t * f / nfft) * w).astype(np.float32)
    return c, s


def _frames(x, nfft, hop):
    B, S = x.shape
    n = (S - nfft) // hop + 1
    idx = (np.arange(n)[:, None] * hop + np.arange(nfft)[None, :])
    return x[:, torch.as_tensor(idx, device=x.device)]  # (B, n, nfft)


def spectral_loss(pred, target, resolutions=((512, 128), (1024, 256),
                                             (256, 64))):
    total = 0.0
    for nfft, hop in resolutions:
        c, s = (torch.as_tensor(m, device=pred.device)
                for m in _stft_mats(nfft))
        pf, tf = _frames(pred, nfft, hop), _frames(target, nfft, hop)
        pm = torch.sqrt((pf @ c) ** 2 + (pf @ s) ** 2 + 1e-9)
        tm = torch.sqrt((tf @ c) ** 2 + (tf @ s) ** 2 + 1e-9)
        total = total + torch.mean(torch.abs(pm - tm)) \
            + 0.2 * torch.mean(torch.abs(torch.log(pm) - torch.log(tm)))
    return total / len(resolutions)


# -- training ---------------------------------------------------------------

def build_corpus(wav_dir: str, out_path: str, seed: int = 0):
    """Augmented (features, pcm) pairs for vocoder training, one npz."""
    from .data.augment import augment_pcm, read_wav

    voc = MelVocoder()
    rng = np.random.default_rng(seed)
    pcms, featss = [], []
    for name in sorted(os.listdir(wav_dir)):
        if not name.endswith(".wav") or name == "all.wav":
            continue
        pcm = read_wav(os.path.join(wav_dir, name))
        for v in augment_pcm(pcm, rng, speeds=(0.9, 1.0, 1.12),
                             tilts=(0.0, 0.4), reverse=True):
            feats = voc.extract(v.astype(np.int16))
            n = feats.shape[0]
            pcms.append((v[: (n + 1) * FRAME] / 32768.0)
                        .astype(np.float32))
            featss.append(feats[:, :20].astype(np.float32))
        print(f"{name}: {len(pcms)} variants total", file=sys.stderr)
    bounds = np.cumsum([0] + [len(f) for f in featss])
    np.savez(out_path, pcm=np.concatenate(pcms),
             feats=np.concatenate(featss), bounds=bounds)
    print(f"corpus: {bounds[-1]} frames ({bounds[-1] / 100:.0f} s)",
          file=sys.stderr)


@dataclass
class VocoderTrainState:
    params: Dict[str, Dict[str, torch.Tensor]]   # leaf tensors, updated in place
    optimizer: torch.optim.Adam
    scheduler: LambdaLR


def cosine_decay(decay_steps: int):
    """optax.cosine_decay_schedule's factor of lr at step s: from 1 down to
    DECAY_ALPHA over decay_steps, then DECAY_ALPHA."""
    def factor(s):
        c = 0.5 * (1.0 + math.cos(math.pi * min(s, decay_steps) / decay_steps))
        return (1.0 - DECAY_ALPHA) * c + DECAY_ALPHA
    return factor


def make_train_step(lr=3e-4, decay_steps: int | None = None):
    """(init, step): init(params, device) -> VocoderTrainState over leaf
    tensors copied from the tree (numpy or tensors); step(state, feats,
    pcm, noise_sig) -> (state, loss), one Adam update (optax.adam's
    defaults: betas 0.9, 0.999, eps 1e-8) of the spectral loss of synth.
    decay_steps enables cosine LR decay (to 0.2*lr) over that many
    optimizer steps — the v2 fixture recipe."""

    def init(params, device="cuda") -> VocoderTrainState:
        tree = {k1: {k2: v.detach().clone().contiguous().requires_grad_(True)
                     for k2, v in d.items()}
                for k1, d in params_to_torch(params, device).items()}
        leaves = [v for d in tree.values() for v in d.values()]
        opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        sched = LambdaLR(opt, (lambda s: 1.0) if decay_steps is None
                         else cosine_decay(decay_steps))
        return VocoderTrainState(tree, opt, sched)

    def step(state: VocoderTrainState, feats, pcm, noise_sig):
        state.optimizer.zero_grad(set_to_none=True)
        loss = spectral_loss(synth(state.params, feats, noise_sig), pcm)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        return state, loss.detach()

    return init, step


def clean_metric(params, feats36: np.ndarray) -> float:
    """Clean-corpus round-trip fidelity: synthesize -> re-analyse ->
    cepstral MSE vs the input features (±1 frame alignment slack).  Used
    for checkpoint selection: training loss on the noisy augmented corpus
    keeps falling while this metric peaks early and then degrades."""
    dev = params["in"]["w"].device
    f = torch.as_tensor(np.ascontiguousarray(feats36[None, :, :20]),
                        device=dev)
    nz = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (1, (len(feats36) - 1) * FRAME)).astype(np.float32), device=dev)
    with torch.no_grad():
        y = synth(params, f, nz)[0].cpu().numpy()
    peak = np.abs(y).max() + 1e-9
    pcm16 = (y / max(peak / 0.7, 1.0) * 29000).astype(np.int16)
    return cepstral_distance(feats36, pcm16)


def cepstral_distance(feats36: np.ndarray, pcm16: np.ndarray) -> float:
    """Re-analyse int16 pcm with MelVocoder: the mean squared error of its
    18 cepstra against feats36's, the best of +-1 frame of alignment."""
    f2 = MelVocoder().extract(np.asarray(pcm16, np.int16))
    n = min(len(f2), len(feats36)) - 2
    best = np.inf
    for d in (-1, 0, 1):
        a = feats36[max(0, -d): n - max(0, d), :18]
        b = f2[max(0, d): n - max(0, -d), :18]
        m = min(len(a), len(b))
        best = min(best, float(np.mean((a[:m] - b[:m]) ** 2)))
    return best


def train(corpus_path: str, out_dir: str, epochs: int = 60, batch: int = 16,
          t_frames: int = 101, lr: float = 3e-4, seed: int = 0,
          hid: int = HID, lr_decay: bool = False, select_on: str = "",
          log=print, device="cuda"):
    """select_on: path of a 36-float feature file; every 10 epochs the
    clean metric is evaluated on its first 400 frames and the best
    checkpoint saved as vocoder_best.npz (the shipped-fixture recipe:
    hid=256, lr_decay=True, select_on=fixtures/speech_feats.f32)."""
    dev = f32_device(device)
    data = np.load(corpus_path)
    feats, pcm, bounds = data["feats"], data["pcm"], data["bounds"]
    # valid window starts within one utterance.  Each variant's stored pcm
    # is one FRAME longer than its feature count ((n+1)*FRAME vs n, the
    # 2-frame analysis window), so the pcm sample offset of global feature
    # frame i in variant u is (i + u) * FRAME — NOT i * FRAME.
    starts = []
    for u in range(len(bounds) - 1):
        lo, hi = int(bounds[u]), int(bounds[u + 1])
        starts += [(s, (s + u) * FRAME)
                   for s in range(lo, hi - t_frames - 1, t_frames // 2)]
    starts = np.array(starts)
    S = (t_frames - 1) * FRAME

    nb = max(1, len(starts) // batch)
    init, step = make_train_step(
        lr, decay_steps=epochs * nb if lr_decay else None)
    state = init(init_params(seed, hid=hid), dev)
    rng = np.random.default_rng(seed + 1)
    os.makedirs(out_dir, exist_ok=True)
    sel_feats = (np.fromfile(select_on, np.float32).reshape(-1, 36)[:400]
                 if select_on else None)
    best = np.inf
    for ep in range(1, epochs + 1):
        order = rng.permutation(starts)
        losses = []
        for b in range(nb):
            idx = order[b * batch:(b + 1) * batch]
            if len(idx) < batch:
                break
            fb = np.stack([feats[i:i + t_frames] for i, _ in idx])
            pb = np.stack([pcm[p:p + S] for _, p in idx])
            nz = rng.standard_normal((batch, S)).astype(np.float32)
            state, loss = step(state, torch.as_tensor(fb, device=dev),
                               torch.as_tensor(pb, device=dev),
                               torch.as_tensor(nz, device=dev))
            losses.append(loss)
        tot = float(torch.stack(losses).sum()) if losses else 0.0
        msg = f"vocoder epoch {ep}: loss {tot / nb:.4f}"
        if sel_feats is not None and (ep % 10 == 0 or ep == epochs):
            d = clean_metric(state.params, sel_feats)
            msg += f" cepdist {d:.4f}"
            if d < best:
                best = d
                save_params(os.path.join(out_dir, "vocoder_best.npz"),
                            state.params)
        log(msg)
        if ep % 20 == 0 or ep == epochs:
            save_params(os.path.join(out_dir, f"vocoder_ep{ep}.npz"),
                        state.params)
    return state.params


def save_params(path, params):
    out = {}
    for k1, d in params.items():
        for k2, v in d.items():
            out[f"{k1}.{k2}"] = (v.detach().cpu().numpy()
                                 if isinstance(v, torch.Tensor)
                                 else np.asarray(v))
    np.savez(path, **out)


def load_params(path):
    """The {"in", "gru", "harm", "noise"} tree of numpy arrays of a weights
    file (`params_to_torch` puts it on a device)."""
    data = np.load(path)
    params: dict = {}
    for k, v in data.items():
        k1, k2 = k.split(".")
        params.setdefault(k1, {})[k2] = np.asarray(v)
    return params


def envelope_correct(y: np.ndarray, feats: np.ndarray,
                     voc: MelVocoder | None = None) -> np.ndarray:
    """Spectral-envelope post-filter: per-frame band-gain correction of a
    rendered waveform toward the band energies encoded in the cepstral
    features (overlap-add, same filterbank inversion the classical
    synthesis uses).  The neural render contributes the excitation/phase
    structure; this pins its coarse spectrum to the transmitted envelope.
    Host-side numpy (a copy of radae_tpu's)."""
    if voc is None:
        voc = MelVocoder()

    y = np.asarray(y, np.float32)
    T = min(feats.shape[0], len(y) // FRAME - 1)
    win = voc.win
    out = np.zeros(len(y), np.float32)
    wsum = np.zeros(len(y), np.float32)
    for t in range(T):
        seg = y[t * FRAME:(t + 2) * FRAME] * win
        E = np.fft.rfft(seg, NFFT)
        eband = voc.fb @ (np.abs(E) ** 2) + 1e-10
        band = 10 ** (voc.idct @ feats[t, :NCEPS])
        gain_bin = voc.fb.T @ np.sqrt(band / eband) / (voc.fb.sum(0) + 1e-6)
        z = np.fft.irfft(E * gain_bin, NFFT)[:2 * FRAME]
        out[t * FRAME:(t + 2) * FRAME] += z * win
        wsum[t * FRAME:(t + 2) * FRAME] += win ** 2
    return out / np.maximum(wsum, 1e-6)


class NeuralVocoder:
    """MelVocoder analysis + trained parallel neural synthesis (36-float
    frame contract, like FARGANVocoder), synthesizing on `device` (default
    cuda, refused without a card; "cpu" when asked)."""

    def __init__(self, weights_path: str, env_correct: bool = True,
                 device="cuda"):
        self.device = f32_device(device)
        self.params = params_to_torch(load_params(weights_path), self.device)
        self.analysis = MelVocoder()
        self.env_correct = env_correct

    def extract(self, pcm: np.ndarray) -> np.ndarray:
        return self.analysis.extract(pcm)

    def synthesize(self, features: np.ndarray) -> np.ndarray:
        f = np.ascontiguousarray(np.asarray(features, np.float32)[None, :, :20])
        rng = np.random.default_rng(0)
        S = (f.shape[1] - 1) * FRAME
        nz = rng.standard_normal((1, S)).astype(np.float32)
        with torch.no_grad():
            y = synth(self.params, torch.as_tensor(f, device=self.device),
                      torch.as_tensor(nz, device=self.device))[0].cpu().numpy()
        if self.env_correct:
            # the post-filter pins absolute band energies to the features
            # (in the analysis' /32768 units): keep that exact gain so the
            # cepstral c0 round-trips, just undo the analysis scaling
            y = envelope_correct(y, f[0], self.analysis)
            return np.clip(y * 32768.0, -32767, 32767).astype(np.int16)
        peak = np.abs(y).max() + 1e-9
        return (y / max(peak / 0.7, 1.0) * 32767 * 0.9).astype(np.int16)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    sub = p.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("corpus", parents=[common])
    pc.add_argument("wav_dir")
    pc.add_argument("out")
    pt = sub.add_parser("train", parents=[common])
    pt.add_argument("corpus")
    pt.add_argument("out_dir")
    pt.add_argument("--epochs", type=int, default=60)
    pt.add_argument("--batch", type=int, default=16)
    pt.add_argument("--lr", type=float, default=3e-4)
    pt.add_argument("--hid", type=int, default=HID)
    pt.add_argument("--lr-decay", action="store_true")
    pt.add_argument("--select-on", default="",
                    help="feature file for clean-metric checkpoint "
                         "selection (saves vocoder_best.npz)")
    ps = sub.add_parser("synth", parents=[common])
    ps.add_argument("weights")
    ps.add_argument("feat_f32")
    ps.add_argument("out_pcm")
    args = p.parse_args(argv)
    resolve_device(args.device)

    if args.cmd == "corpus":
        build_corpus(args.wav_dir, args.out)
    elif args.cmd == "train":
        train(args.corpus, args.out_dir, epochs=args.epochs,
              batch=args.batch, lr=args.lr, hid=args.hid,
              lr_decay=args.lr_decay, select_on=args.select_on,
              device=args.device)
    else:
        v = NeuralVocoder(args.weights, device=args.device)
        feats = np.fromfile(args.feat_f32,
                            np.float32).reshape(-1, NB_TOTAL_FEATURES)
        v.synthesize(feats).tofile(args.out_pcm)
    return 0


if __name__ == "__main__":
    sys.exit(main())
