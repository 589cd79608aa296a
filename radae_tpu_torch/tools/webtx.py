"""Web transmit front-end, the public_html analog (port of
`radae_tpu/tools/webtx.py`).

The reference ships a tiny web front-end — a form that accepts a wav
upload and a CGI that turns it into a RADAE transmission for an OTA rig
(reference: public_html/tx_form.html, public_html/tx_process.cgi).  This
is the same service on the stdlib http.server: GET / serves the form,
POST /tx runs vocoder analysis + the streaming transmitter on the
uploaded wav and returns the modulated IQ (.f32 interleaved I/Q at 8 kHz)
as a download, ready to feed a transceiver or the rx tools.

The transmitter (apps/txe.py) and the vocoder run on `--device` (default
cuda; refused without a card).

    python -m radae_tpu_torch report ...   # results page (tools/report.py)
    python -m radae_tpu_torch webtx fixtures/model_fs_flagship.npz --port 8080
"""

from __future__ import annotations

import argparse
import io
import sys
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

FORM = b"""<!doctype html>
<html><head><title>RADAE web tx</title></head><body>
<h2>RADAE transmit</h2>
<p>Upload a mono 16-bit wav; the response is the modulated RADAE signal
(.f32 interleaved I/Q, 8 kHz) ending in an EOO frame.</p>
<form method="post" action="/tx" enctype="multipart/form-data">
  <input type="file" name="wav" accept=".wav">
  <input type="submit" value="Modulate">
</form></body></html>
"""


def _multipart_file(content_type: str, body: bytes):
    """Return the first file part's payload from a multipart/form-data body,
    or None.  Splits on the boundary declared in the Content-Type header."""
    import email.message

    msg = email.message.Message()
    msg["Content-Type"] = content_type
    if msg.get_content_type() != "multipart/form-data":
        return None
    boundary = msg.get_param("boundary")
    if not boundary:
        return None
    delim = b"--" + boundary.encode("utf-8", "surrogateescape")
    parts = body.split(delim)
    # parts[0] = preamble, parts[-1] = b"--..." epilogue after final delim
    for part in parts[1:-1]:
        if part[:2] == b"\r\n":
            part = part[2:]
        head, sep, payload = part.partition(b"\r\n\r\n")
        if sep and b"filename=" in head:
            # the trailing CRLF belongs to the next delimiter line
            return payload[:-2] if payload.endswith(b"\r\n") else payload
    return None


def make_handler(params, auxdata=True, device="cuda"):
    import threading

    from ..apps.txe import RadaeTx
    from ..vocoder import get_vocoder, SPEECH_FS

    voc = get_vocoder(device=device)
    # one transmitter for the process: a per-request RadaeTx would copy the
    # weights to the device again on every upload.  The encoder/OFDM state
    # is per-over, so serialize requests on a lock and reset state between
    # overs.
    tx = RadaeTx(params=params, auxdata=auxdata, device=device)
    tx_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            print("webtx: " + fmt % args, file=sys.stderr)

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(FORM)

        def do_POST(self):
            if self.path != "/tx":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            # accept either raw wav bytes or a multipart/form-data upload;
            # multipart is split on the declared boundary (RFC 2046), not on
            # byte heuristics that could truncate PCM containing "\r\n--"
            if body[:4] != b"RIFF":
                body = _multipart_file(self.headers.get("Content-Type", ""),
                                       body)
                if body is None or body[:4] != b"RIFF":
                    self.send_error(400, "no wav payload found")
                    return
            try:
                with wave.open(io.BytesIO(body), "rb") as w:
                    assert w.getsampwidth() == 2
                    pcm = np.frombuffer(w.readframes(w.getnframes()),
                                        np.int16)
                    if w.getnchannels() > 1:
                        pcm = pcm[::w.getnchannels()]
                    fs = w.getframerate()
                if fs != SPEECH_FS:
                    t = np.arange(int(len(pcm) * SPEECH_FS / fs)) \
                        * (fs / SPEECH_FS)
                    pcm = np.interp(t, np.arange(len(pcm)),
                                    pcm).astype(np.int16)
            except Exception as e:  # noqa: BLE001 - report to the client
                self.send_error(400, f"bad wav: {e}")
                return

            feats = voc.extract(pcm)
            rows = 12
            nmf = len(feats) // rows
            if nmf == 0:
                self.send_error(400, "wav shorter than one modem frame")
                return
            with tx_lock:
                tx.enc_state = None              # fresh over
                frames = [tx.do_radae_tx(feats[i * rows:(i + 1) * rows]
                                         .flatten()) for i in range(nmf)]
                iq = np.concatenate(frames + [tx.do_eoo()]) \
                    .astype(np.complex64)

            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Disposition",
                             'attachment; filename="radae_tx.f32"')
            self.end_headers()
            self.wfile.write(iq.tobytes())

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model_name")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--noauxdata", dest="auxdata", action="store_false")
    p.add_argument("--serve-requests", type=int, default=0,
                   help="serve exactly N requests then exit (for tests); "
                        "0 = serve forever")
    p.add_argument("--device", default="cuda",
                   help="torch device of the transmitter and the vocoder "
                        "(default cuda; cpu runs them on the host)")
    args = p.parse_args(argv)

    from ..convert import load_checkpoint
    params, _ = load_checkpoint(args.model_name)
    srv = ThreadingHTTPServer(("127.0.0.1", args.port),
                              make_handler(params, args.auxdata,
                                           args.device))
    print(f"webtx: listening on http://127.0.0.1:{srv.server_port}/",
          file=sys.stderr)
    if args.serve_requests:
        for _ in range(args.serve_requests):
            srv.handle_request()
    else:
        srv.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
