"""Multi-over PTT session runner, the console station loop (port of
`radae_tpu/tools/ptt_loop.py`).

Analog of the reference's script-based console station (reference:
ptt_test.sh — keys a radio with hamlib rigctl, alternates SSB/RADAE
tx/rx overs through the sound card).  Without a radio or audio device the
session runs the same protocol over the simulated channel: a schedule of
OVERS — [PTT on] features -> tx -> channel -> [PTT off] gap -> next over —
into one continuous rx stream that a single receiver instance must handle:
acquire each over, decode, detect the EOO, drop back to search during the
gap, and re-acquire the next over.

The transmitter and the receiver are the port's `RadaeTx` and `RadaeRx`
(apps/txe.py, apps/rxe.py) on `--device` (default cuda; refused without a
card): on a card each received frame launches the f32 decoder kernel at
B=1.  `make_session` builds the session IQ and `receive_session` runs the
one receiver over it, so a session from anywhere (radae_tpu's, a recording)
can be received.

Hardware hooks: ``--ptt-on-cmd`` / ``--ptt-off-cmd`` run an arbitrary
shell command at each PTT edge (e.g. ``rigctl -m MODEL -r PORT T 1``),
and ``--rig-out FILE`` writes the session IQ for an external radio path.
PTT edges fire while each over's IQ is actually being written (key down
just before the over's samples go out, key up just after; ``--pace``
makes the writes track wall-clock for a fifo into an audio player) — the
two pieces ptt_test.sh gets from hamlib + aplay.

Exit code 0 iff every over acquired, decoded, and ended with an EOO.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

from ..data.io import NB_TOTAL_FEATURES, read_f32
from ..convert import load_checkpoint

ROWS_PER_FRAME = 12      # 10 ms feature rows per 120 ms modem frame
FS = 8000


def make_session(params, feats_rows: np.ndarray, n_overs: int = 2,
                 over_secs: float = 6.0, gap_secs: float = 2.0,
                 channel: str | None = None, snrdB: float | None = None,
                 auxdata: bool = True, seed: int = 0, device="cuda"):
    """The session's IQ through the channel and the (start, end) sample
    index of each over in it: gap, then each over (its frames and the EOO
    frame) followed by a gap."""
    from ..apps.txe import RadaeTx

    frames_per_over = max(2, int(over_secs / 0.12))
    rng = np.random.default_rng(seed)

    tx = RadaeTx(params=params, auxdata=auxdata, device=device)
    nrows = len(feats_rows) // ROWS_PER_FRAME * ROWS_PER_FRAME
    gap = np.zeros(int(gap_secs * FS), np.complex64)

    # assemble the session stream, marking over boundaries
    pieces, marks = [gap.copy()], []
    pos = len(gap)
    for _ in range(n_overs):
        frames = [tx.do_radae_tx(
            feats_rows[(i * ROWS_PER_FRAME) % nrows:
                       (i * ROWS_PER_FRAME) % nrows + ROWS_PER_FRAME]
            .flatten()) for i in range(frames_per_over)]
        over = np.concatenate(frames + [tx.do_eoo()])
        marks.append((pos, pos + len(over)))
        pieces += [over, gap.copy()]
        pos += len(over) + len(gap)
    session = np.concatenate(pieces).astype(np.complex64)

    # channel
    if channel and channel != "awgn":
        from ..channel.doppler import fade_two_path
        session = fade_two_path(session, channel, FS, rng=rng)
    if snrdB is not None:
        sig = session[np.abs(session) > 0]
        S = (np.abs(sig) ** 2).mean()
        sigma2 = S / 10 ** (snrdB / 10) * FS / 3000
        session = (session + np.sqrt(sigma2 / 2) *
                   (rng.standard_normal(len(session))
                    + 1j * rng.standard_normal(len(session)))
                   ).astype(np.complex64)
    return session, marks


def receive_session(params, session: np.ndarray, marks, auxdata: bool = True,
                    v: int = 0, device="cuda"):
    """One receiver across the whole session.  Returns (reports, counts):
    one report per over with keys acquired, acq_frame, eoo,
    frames_decoded, unsynced_after; counts {"frames": frames received,
    "decoded": frames the decoder ran on, in an over or not}."""
    from ..apps.rxe import RadaeRx

    rx = RadaeRx(params=params, auxdata=auxdata, v=v, device=device)
    floats_out = np.zeros(rx.get_n_floats_out(), np.float32)
    reports = [dict(acquired=False, acq_frame=None, eoo=False,
                    frames_decoded=0, unsynced_after=False)
               for _ in range(len(marks))]
    ptr = frame = decoded = 0
    while ptr + rx.get_nin() <= len(session):
        nin = rx.get_nin()
        ret = rx.do_radae_rx(session[ptr:ptr + nin], floats_out)
        decoded += ret & 1
        centre = ptr + nin // 2
        over_idx = next((i for i, (a, b) in enumerate(marks)
                         if a - 960 <= centre < b + 2 * 960), None)
        if over_idx is not None:
            rep = reports[over_idx]
            if ret & 1:
                rep["frames_decoded"] += 1
                if not rep["acquired"]:
                    rep["acquired"] = True
                    rep["acq_frame"] = frame
            if ret & 2:
                rep["eoo"] = True
        elif rx.state == "search" and any(r["eoo"] for r in reports):
            i = max(i for i, r in enumerate(reports) if r["eoo"])
            reports[i]["unsynced_after"] = True
        ptr += nin
        frame += 1
    return reports, {"frames": frame, "decoded": decoded}


def run_session(params, feats_rows: np.ndarray, n_overs: int = 2,
                over_secs: float = 6.0, gap_secs: float = 2.0,
                channel: str | None = None, snrdB: float | None = None,
                auxdata: bool = True, seed: int = 0, v: int = 0,
                device="cuda"):
    """Run the multi-over protocol; returns (reports, session_iq, marks).

    reports: one dict per over with keys acquired, acq_frame, eoo,
    frames_decoded, unsynced_after.  marks: (start, end) sample index of
    each over in session_iq (for emit_session's PTT keying).
    """
    session, marks = make_session(params, feats_rows, n_overs, over_secs,
                                  gap_secs, channel, snrdB, auxdata, seed,
                                  device)
    reports, _ = receive_session(params, session, marks, auxdata, v, device)
    return reports, session, marks


def emit_session(session: np.ndarray, marks, out_file: str,
                 ptt_hook=None, pace: bool = False, fs: int = FS):
    """Write the session IQ, keying PTT around each over's samples AS THEY
    ARE WRITTEN — the rig is keyed exactly while its IQ is going out (the
    piece ptt_test.sh gets from hamlib + aplay), not during synthesis.
    With pace=True, writes track wall-clock so an external player consuming
    out_file (e.g. a fifo into aplay) stays aligned with the keying."""
    import time

    pos = 0
    with open(out_file, "wb") as f:
        for a, b in marks:
            f.write(session[pos:a].astype(np.complex64).tobytes())
            f.flush()
            if pace:
                time.sleep((a - pos) / fs)
            if ptt_hook:
                ptt_hook(True)
            f.write(session[a:b].astype(np.complex64).tobytes())
            f.flush()
            if pace:
                time.sleep((b - a) / fs)
            if ptt_hook:
                ptt_hook(False)
            pos = b
        f.write(session[pos:].astype(np.complex64).tobytes())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model_name")
    p.add_argument("features")
    p.add_argument("--overs", type=int, default=2)
    p.add_argument("--over-secs", type=float, default=6.0)
    p.add_argument("--gap-secs", type=float, default=2.0)
    p.add_argument("--channel", default=None)
    p.add_argument("--snrdB", type=float, default=None)
    p.add_argument("--noauxdata", dest="auxdata", action="store_false")
    p.add_argument("--ptt-on-cmd", default="",
                   help="shell command run at each PTT key-down "
                        "(e.g. 'rigctl -m 3061 -r /dev/ttyUSB0 T 1')")
    p.add_argument("--ptt-off-cmd", default="")
    p.add_argument("--rig-out", default="",
                   help="write session IQ (.f32 I/Q pairs) to FILE for an "
                        "external radio path instead of gating on decode; "
                        "PTT edges fire around each over's write")
    p.add_argument("--pace", action="store_true",
                   help="pace --rig-out writes at real time (use with a "
                        "fifo into an audio player so PTT keying tracks "
                        "playback)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-v", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the transmitter and receiver "
                        "(default cuda; cpu runs them on the host)")
    args = p.parse_args(argv)

    params, _ = load_checkpoint(args.model_name)
    feats = read_f32(args.features, NB_TOTAL_FEATURES)

    def ptt_hook(on: bool):
        cmd = args.ptt_on_cmd if on else args.ptt_off_cmd
        if cmd:
            subprocess.run(cmd, shell=True, check=False)

    have_ptt = bool(args.ptt_on_cmd or args.ptt_off_cmd)
    reports, session, marks = run_session(
        params, feats, n_overs=args.overs, over_secs=args.over_secs,
        gap_secs=args.gap_secs, channel=args.channel, snrdB=args.snrdB,
        auxdata=args.auxdata, seed=args.seed, v=args.v, device=args.device)

    if args.rig_out or have_ptt:
        # real radio path: PTT keys exactly while each over's IQ is written
        emit_session(session, marks, args.rig_out or os.devnull,
                     ptt_hook=ptt_hook if have_ptt else None,
                     pace=args.pace)
    ok = True
    for i, r in enumerate(reports):
        status = "OK" if (r["acquired"] and r["eoo"]) else "FAIL"
        ok &= status == "OK"
        print(f"over {i}: {status} acq_frame={r['acq_frame']} "
              f"decoded={r['frames_decoded']} eoo={r['eoo']} "
              f"unsync_after={r['unsynced_after']}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
