"""SNR x channel evaluation sweep (port of `radae_tpu/tools/evaluate.py`).

The reference's evaluate.sh / evaluate_loop.sh harness (reference:
evaluate_loop.sh:43-53 sweeps SNR over {AWGN, MPG, MPP, MPD} channel
classes by invoking inference again and again) as one batch: each row of
the (channel x Eb/No x realisation) grid is an independent channel draw,
and the whole grid goes through one forward.  Prints a loss (or, with
--ber, a BER) table per (channel, Eb/No) cell, optionally as JSON.

Over several cards (`torchrun --nproc_per_node N`) `run_sweep` runs each
rank's rows of the grid, reduces them into per-cell sums with a one-hot
product and combines the ranks with one all_reduce of sums and counts
(radae_tpu's `run_sweep_shard_map`).  Each rank draws the whole grid's
noise and keeps its rows (ops/draws.py), so a grid that splits evenly
gives one process's table.  --shard_map is accepted, so radae_tpu's
command lines run, and changes nothing: one function serves both.

--audio DIR writes, per (channel, Eb/No) cell, the decoded wav, the SSB
comparison wav at the same C/No and a README of the measured numbers and
the decoded audio's fwSegSNR (`write_audio_cells`, on rank 0).

    python -m radae_tpu_torch evaluate model.npz features.f32 \\
        [--channels awgn,mpp] [--EbNodB 0,3,6,10] [--audio DIR] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import wave

import numpy as np
import torch

from ..channel.doppler import fade_two_path, multipath_samples
from ..config import RADAEConfig
from ..convert import load_checkpoint
from ..data.io import NB_TOTAL_FEATURES, NUM_USED_FEATURES, read_f32
from ..models.core import distortion_loss
from ..models.radae import RADAE
from ..ops import cplx
from ..ops.draws import BatchRows
from ..parallel.distributed import join_from_env
from ..parallel.mesh import rank_rows
from ..parallel.trainstep import step_generator
from ..utils.quality import fwsegsnr_aligned
from ..vocoder import SPEECH_FS, get_vocoder
from .ch import analog_compressor, apply_ch
from .tx_batch import load_params

CHANNELS = ["awgn", "mpg", "mpp", "mpd"]


def build_grid_batch(cfg, feats_seq, channels, EbNodB_list, reps, rng):
    """One batch row per (channel, EbNo, rep): features replicated, H/G per
    row an independent realisation."""
    B = len(channels) * len(EbNodB_list) * reps
    T = feats_seq.shape[0]
    n_rs = cfg.num_timesteps_at_rate_Rs(T)
    n_fs = cfg.num_timesteps_at_rate_Fs(n_rs)

    feats = np.broadcast_to(feats_seq[None], (B, T, feats_seq.shape[1])).copy()
    H = np.ones((B, n_rs, cfg.Nc), np.float32)
    G = np.zeros((B, n_fs, 2), np.complex64)
    G[:, :, 0] = 1
    ebno = np.zeros((B,), np.float32)

    rows = []
    i = 0
    for ch in channels:
        for e in EbNodB_list:
            for rep in range(reps):
                ebno[i] = e
                if ch != "awgn":
                    nsec = n_fs / cfg.Fs + 1
                    _, Gs, hf_gain = multipath_samples(
                        ch, cfg.Fs, cfg.Rs_dash, cfg.Nc, nsec, rng=rng)
                    G[i] = hf_gain * Gs[:n_fs]
                rows.append((ch, e, rep))
                i += 1
    return feats, H, G, ebno, rows


def run_sweep(model, params, feats_seq, channels, EbNodB_list, reps=2,
              group=None, seed=0, metric="loss"):
    """The grid through one forward, EbNodB riding in as a per-row tensor.
    Returns {(channel, EbNo): mean over the reps}.  With a group each rank
    runs its rows of the grid only: its rows reduced into per-(channel,
    EbNo) sums by a one-hot product, then one all_reduce of sums and
    counts, so no rank gathers per-row values (radae_tpu's
    `run_sweep_shard_map`; its jit-sharded `run_sweep` is this without a
    group).  Rows that pad the grid to a multiple of the world size fall
    in a dead cell."""
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    feats, H, G, ebno, rows = build_grid_batch(cfg, feats_seq, channels,
                                               EbNodB_list, reps, rng)
    world = 1
    if group is not None:
        import torch.distributed as dist
        world = dist.get_world_size(group)
    cells = {(ch, e): i for i, (ch, e) in enumerate(
        (c, e) for c in channels for e in EbNodB_list)}
    n_cells = len(cells)
    cell_id = np.array([cells[(ch, e)] for ch, e, _ in rows], np.int64)
    pad = (-len(rows)) % world
    if pad:
        feats, H, G, ebno = (np.concatenate([a, a[:pad]])
                             for a in (feats, H, G, ebno))
        cell_id = np.concatenate([cell_id, np.full(pad, n_cells)])
    onehot = np.eye(n_cells + 1, dtype=np.float32)[cell_id][:, :n_cells]
    sl = rank_rows(len(cell_id), group)
    key = step_generator(model.device, seed, 0)
    if group is not None:
        key = BatchRows(key, len(cell_id), sl.start, sl.stop, group)
    with torch.no_grad():            # per-row loss on the first 20, or BER
        out = model.forward(params, feats[sl], H[sl], cplx.pack_np(G[sl]),
                            key=key, EbNodB=ebno[sl])
        if metric == "ber":
            losses = out["ber_row"]
        else:
            f = model._tensor(feats[sl])
            losses = distortion_loss(f[..., :20],
                                     out["features_hat"][..., :20])
    oh = torch.as_tensor(onehot[sl], device=model.device)
    sums = torch.cat([oh.T @ losses.float(), oh.sum(dim=0)])
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(sums, group=group)       # ONE collective
    means = (sums[:n_cells] / sums[n_cells:].clamp(min=1.0)).cpu().numpy()
    return {k: float(means[i]) for k, i in cells.items()}


def _write_wav(path, pcm, fs):
    pcm = np.clip(np.asarray(pcm, np.float32), -32767, 32767)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(fs))
        w.writeframes(pcm.astype(np.int16).tobytes())


def _pad36(f20):
    """Synthesis back-ends take the full 36-float-per-frame feature
    layout (the FARGAN binary parses its input as 36-wide frames;
    the built-in vocoders read the first 20 columns)."""
    out = np.zeros((f20.shape[0], NB_TOTAL_FEATURES), np.float32)
    out[:, :f20.shape[1]] = f20
    return out


def write_audio_cells(model, params, feats_seq, channels, EbNodB_list,
                      outdir, seed=0, name="sample"):
    """A/B listening material per sweep cell (reference: evaluate.sh).

    For each (channel, EbNo) cell, writes next to each other:
      <name>_<E>dB_<ch>.wav      decoded RADAE audio at that operating point
      <name>_<E>dB_<ch>_ssb.wav  the SSB comparison: compressed speech +
                                 calibrated noise at the SAME C/No as the
                                 RADAE signal (via tools/ch, the independent
                                 channel/measurement path)
      <name>_<E>dB_<ch>_zREADME.txt  measured Eb/No / C/No / SNR3k / PAPR
    plus once: zz_<name>_orig.wav (clean vocoder reference) and
    zz_<name>_ssb.wav (compressed clean SSB tx signal).  The forward and
    the neural vocoder run on the model's device; each cell's forward
    draws from a generator seeded `seed` (radae_tpu's fixed key a cell).
    """
    from scipy.signal import decimate

    os.makedirs(outdir, exist_ok=True)
    cfg = model.cfg
    voc = get_vocoder(device=model.device)
    rng = np.random.default_rng(seed)

    # clean references, written once
    clean16k = np.asarray(voc.synthesize(_pad36(feats_seq[:, :20])),
                          np.float32)
    _write_wav(os.path.join(outdir, f"zz_{name}_orig.wav"), clean16k,
               SPEECH_FS)
    # SSB path runs at the modem rate (8 kHz): decimate by 2 post-LPF
    clean8k = decimate(clean16k, int(SPEECH_FS // 8000)).astype(np.float32)
    ssb_tx = analog_compressor(clean8k)
    _write_wav(os.path.join(outdir, f"zz_{name}_ssb.wav"), ssb_tx, 8000)

    T = feats_seq.shape[0]
    n_rs = cfg.num_timesteps_at_rate_Rs(T)
    n_fs = cfg.num_timesteps_at_rate_Fs(n_rs)
    written = []
    for ch in channels:
        for e in EbNodB_list:
            H = model.default_H(1, n_rs)
            G = model.default_G(1, n_fs)
            if ch != "awgn":
                _, Gs, hf_gain = multipath_samples(
                    ch, cfg.Fs, cfg.Rs_dash, cfg.Nc, n_fs / cfg.Fs + 1,
                    rng=rng)
                G = cplx.pack_np((hf_gain * Gs[:n_fs])[None])
            key = torch.Generator(device=model.device)
            key.manual_seed(seed)
            with torch.no_grad():
                out = model.forward(params, feats_seq[None], H, G, key=key,
                                    EbNodB=np.full((1,), e, np.float32))
            fh = out["features_hat"][0].cpu().numpy()
            base = os.path.join(outdir, f"{name}_{e:g}dB_{ch}")
            decoded = np.asarray(voc.synthesize(_pad36(fh[:, :20])),
                                 np.float32)
            _write_wav(base + ".wav", decoded, SPEECH_FS)
            # end-to-end listening proxy: fwSegSNR of the decoded audio
            # against the clean vocoder reference (utils/quality.py)
            q_e2e = fwsegsnr_aligned(clean16k, decoded, fs=SPEECH_FS)

            # measured RADAE operating point (tools/inference.py printout)
            tx = (out["tx"].re + 1j * out["tx"].im).cpu().numpy()
            sigma = float(out["sigma"].flatten()[0])
            S = float(np.mean(np.abs(tx) ** 2))
            CNodB = 10 * np.log10(S * cfg.Fs / sigma ** 2)
            EbNodB_meas = CNodB + 10 * np.log10(
                cfg.M / (cfg.Fs * cfg.Nc * cfg.bps))
            SNRdB = CNodB - 10 * np.log10(3000.0)
            PAPRdB = 20 * np.log10(np.max(np.abs(tx)) / np.sqrt(S))

            # SSB at the SAME C/No: fade first, then calibrate the noise
            # density from the post-fade power (reference: evaluate.sh
            # measures RMS with --after_fade) via the independent ch path
            ssb_sig = ssb_tx.astype(np.complex64)
            if ch != "awgn":
                ssb_sig = fade_two_path(ssb_sig, ch, 8000, rng=rng,
                                        normalize=False)
            C_ssb = float(np.mean(np.abs(ssb_sig) ** 2))
            No_dB = 10 * np.log10(max(C_ssb, 1e-12)) - CNodB
            ssb_rx, CNo_meas = apply_ch(ssb_sig, No_dB, Fs=8000, rng=rng)
            ssb_rx = ssb_rx.real
            peak = np.abs(ssb_rx).max() + 1e-9
            _write_wav(base + "_ssb.wav", ssb_rx / peak * 16384, 8000)

            with open(base + "_zREADME.txt", "w") as f:
                f.write("Waveform           EbNo  PAPR  C/No  SNR3k\n")
                f.write(f"Radio Autoencoder: {EbNodB_meas:5.2f} {PAPRdB:5.2f}"
                        f" {CNodB:5.2f} {SNRdB:5.2f}\n")
                f.write(f"SSB..............:   n/a   n/a {CNo_meas:5.2f}"
                        f" {CNo_meas - 10 * np.log10(3000.0):5.2f}\n")
                f.write(f"RADAE decoded-audio fwSegSNR vs clean reference: "
                        f"{q_e2e:5.2f} dB\n")
            written.append(base)
    return written


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("model_name", type=str,
                   help="checkpoint (.npz or .pth), or random")
    p.add_argument("features", type=str)
    p.add_argument("--channels", type=str, default="awgn,mpp")
    p.add_argument("--EbNodB", type=str, default="0,3,6,10")
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--latent-dim", type=int, default=80)
    p.add_argument("--auxdata", action="store_true")
    p.add_argument("--json", type=str, default="")
    p.add_argument("--ber", action="store_true",
                   help="QPSK substitution BER grid instead of feature "
                        "loss (reference ofdm_sync.sh BER-vs-EbNo curves, "
                        "the whole curve as one batch)")
    p.add_argument("--shard_map", action="store_true",
                   help="accepted for radae_tpu's command lines; the sweep "
                        "is the same with or without it")
    p.add_argument("--audio", type=str, default="",
                   help="also write per-cell A/B listening audio to this "
                        "directory: decoded RADAE wav + matched-C/No SSB "
                        "comparison wav + measured-numbers README "
                        "(reference: evaluate.sh)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; with torchrun, "
                        "cuda:LOCAL_RANK)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device, group, rank, world = join_from_env(args.device)
    try:
        run(args, device, group, rank)
    finally:
        if group is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def run(args, device, group, rank):
    # Native checkpoints record their model args: infer --auxdata from the
    # checkpoint so a trained-with-aux model evaluates correctly without
    # the flag (a mismatch otherwise fails deep in the encoder matmul).
    if (not args.auxdata and args.model_name not in ("", "random")
            and not args.model_name.endswith(".pth")):
        _, meta = load_checkpoint(args.model_name)
        if meta.get("model_args", {}).get("auxdata"):
            if rank == 0:
                print("note: checkpoint was trained with auxdata; enabling it",
                      file=sys.stderr)
            args.auxdata = True

    nf = 21 if args.auxdata else 20
    common = dict(feature_dim=nf, latent_dim=args.latent_dim, EbNodB=100,
                  rate_Fs=True, pilots=True, pilot_eq=True, eq_mean6=False,
                  cyclic_prefix=0.004)
    if args.ber:
        # BER calibration waveform: bottleneck 1, no PA clip / coarse mag
        # (reference model05, test/inference_ber_awgn.sh + ofdm_sync.sh)
        cfg = RADAEConfig(bottleneck=1, ber_test=True, **common)
    else:
        cfg = RADAEConfig(coarse_mag=True, time_offset=-16, bottleneck=3,
                          **common)
    model = RADAE(cfg, device)
    params = load_params(args.model_name, lambda: model.init(args.seed))

    f = read_f32(args.features, NB_TOTAL_FEATURES)[:, :NUM_USED_FEATURES]
    T = cfg.num_10ms_times_steps_rounded_to_modem_frames(
        min(f.shape[0], int(args.seconds * 100)))
    feats_seq = f[:T].astype(np.float32)
    if args.auxdata:
        aux = -np.ones((T, 1), np.float32)
        feats_seq = np.concatenate([feats_seq, aux], axis=1)

    channels = args.channels.split(",")
    ebnos = [float(x) for x in args.EbNodB.split(",")]
    metric = "ber" if args.ber else "loss"
    t0 = time.time()
    table = run_sweep(model, params, feats_seq, channels, ebnos,
                      reps=args.reps, group=group, seed=args.seed,
                      metric=metric)
    dt = time.time() - t0
    if rank != 0:
        return table

    print(f"{'channel':8s} " + " ".join(f"{e:7.1f}" for e in ebnos))
    for ch in channels:
        print(f"{ch:8s} " + " ".join(f"{table[(ch, e)]:7.3f}" for e in ebnos))
    print(f"sweep: {len(channels)*len(ebnos)*args.reps} cells in {dt:.1f}s",
          file=sys.stderr)
    if args.json:
        with open(args.json, "w") as fj:
            json.dump({f"{ch}@{e}": v for (ch, e), v in table.items()}, fj)
    if args.audio:
        name = os.path.splitext(os.path.basename(args.features))[0]
        written = write_audio_cells(model, params, feats_seq, channels,
                                    ebnos, args.audio, seed=args.seed,
                                    name=name)
        print(f"audio: {len(written)} cell pairs in {args.audio}",
              file=sys.stderr)
    return table


if __name__ == "__main__":
    main()
