"""The port's per-frame product path (apps/txe.py, apps/rxe.py and the
`python -m radae_tpu_torch` CLI) against radae_tpu's on the CPU, on the
fixture checkpoint and fixtures/speech_feats.f32.

The transmitter is held with its quantization noise off (rtol 1e-4, atol
1e-5 over 5 chained frames), the EOO frame and the --bypass_enc path too.
The receiver is held frame by frame against radae_tpu's on streams from
radae_tpu's transmitter (noise on): return codes, state, nin, tmax, fmax
and uw_errors equal, features at rtol 1e-4, atol 1e-5, the SNR estimate
within 1e-3 dB.  The decoder runs as the fused kernel's plain version on
CPU tensors.  One gate runs the port's own tx (noise on) into its rx: the
clean-stream loss and EOO gates of tests/test_streaming_trained.py."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from radae_tpu.apps.rxe import RadaeRx as JRadaeRx
from radae_tpu.apps.txe import RadaeTx as JRadaeTx
from radae_tpu_torch.apps.rxe import RadaeRx
from radae_tpu_torch.apps.txe import RadaeTx
from radae_tpu_torch.convert import load_checkpoint
from radae_tpu_torch.data.io import NB_TOTAL_FEATURES, read_f32
from radae_tpu_torch.dsp.rrc import sample_clock_offset
from radae_tpu_torch.models.core import distortion_loss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "fixtures", "model_fs_flagship.npz")
TOL = dict(rtol=1e-4, atol=1e-5)
NF = 16             # modem frames of the parity streams
GATE_NF = 40        # and of the end-to-end gate (tests/test_streaming_trained.py)
EOO_SEED = 65647


@pytest.fixture(scope="module")
def fixture():
    params, meta = load_checkpoint(CKPT)
    feats = read_f32(os.path.join(ROOT, "fixtures", "speech_feats.f32"),
                     NB_TOTAL_FEATURES)
    return params, meta, feats


def _eoo_bits(n):
    return np.sign(np.random.default_rng(EOO_SEED).random(n)
                   - 0.5).astype(np.float32)


def _stream(tx, feats, nframes):
    frames = [tx.do_radae_tx(feats[i * 12:(i + 1) * 12].flatten())
              for i in range(nframes)]
    return np.concatenate(frames + [tx.do_eoo(),
                                    np.zeros(3000, np.complex64)])


@pytest.fixture(scope="module")
def jax_stream(fixture):
    """radae_tpu's tx (noise on) of NF frames, then its EOO frame with
    data bits, then 3000 zeros."""
    params, _, feats = fixture
    tx = JRadaeTx(params=params, auxdata=True)
    tx.set_eoo_bits(_eoo_bits(tx.get_Neoo_bits()))
    return _stream(tx, feats, NF)


def _features(feats, k):
    f = np.zeros((1, 12, 21), np.float32)
    f[0, :, :20] = feats[12 * k:12 * (k + 1), :20]
    f[0, :, 20] = -1.0
    return f


def test_tx_noise_off_step_matches_jax(fixture):
    params, _, feats = fixture
    ours, ref = RadaeTx(params=params, device="cpu"), JRadaeTx(params=params)
    st, jst = ours.encoder.zero_state(1, "cpu"), ref.encoder.zero_state(1)
    for k in range(5):
        f = _features(feats, k)
        got, st = ours._step(ours.params, torch.as_tensor(f), st, None)
        want, jst = ref._jit_step(ref.params, f, jst, None)
        assert tuple(got.shape) == (ours.Nmf, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_tx_eoo_and_bypass_enc_match_jax(fixture):
    params, _, feats = fixture
    ours, ref = RadaeTx(params=params, device="cpu"), JRadaeTx(params=params)
    np.testing.assert_allclose(ours.do_eoo(), ref.do_eoo(), rtol=0, atol=1e-6)
    bits = _eoo_bits(ours.get_Neoo_bits())
    ours.set_eoo_bits(bits)
    ref.set_eoo_bits(bits)
    np.testing.assert_allclose(ours.do_eoo(), ref.do_eoo(), rtol=0, atol=1e-6)
    assert ours.get_Neoo() == ref.get_Neoo() and ours.Nmf == ref.Nmf
    rng = np.random.default_rng(8)
    for bpf in (False, True):
        ours = RadaeTx(bypass_enc=True, txbpf_en=bpf, device="cpu")
        ref = JRadaeTx(bypass_enc=True, txbpf_en=bpf)
        assert ours.get_n_floats_in() == ref.get_n_floats_in()
        for _ in range(3):
            z = np.tanh(rng.standard_normal(ours.n_floats_in)).astype(
                np.float32)
            got, want = ours.do_radae_tx(z), ref.do_radae_tx(z)
            assert got.dtype == np.complex64 and got.shape == want.shape
            np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(ours.do_eoo(), ref.do_eoo(), rtol=1e-5,
                                   atol=1e-6)


def _channel(name, stream):
    if name == "foff":
        n = np.arange(len(stream))
        return (stream * np.exp(2j * np.pi * 7.3 * n / 8000)).astype(
            np.complex64)
    if name == "slip":
        # 5000 ppm drifts tmax 4.8 samples a frame; the delay puts the first
        # tmax near M, so the receiver slips (nin = Nmf - M) within NF frames
        delayed = np.concatenate([np.zeros(720, np.complex64), stream])
        return sample_clock_offset(delayed, 5000)
    return stream


STREAMS = {"clean": ("clean", {}), "foff": ("foff", {}),
           "slip": ("slip", {}), "foff_err": ("clean", {"foff_err": 25.0})}


@pytest.mark.parametrize("name", list(STREAMS))
def test_rx_matches_jax_frame_by_frame(fixture, jax_stream, name):
    params = fixture[0]
    channel, kw = STREAMS[name]
    stream = _channel(channel, jax_stream)
    ours = RadaeRx(params=params, auxdata=True, v=0, device="cpu", **kw)
    ref = JRadaeRx(params=params, auxdata=True, v=0, **kw)
    out, out_ref = (np.zeros(ref.get_n_floats_out(), np.float32)
                    for _ in range(2))
    ptr, events = 0, {"valid": 0, "eoo": 0, "slips": 0, "unsync": 0}
    while ptr + ref.get_nin() <= len(stream):
        nin = ref.get_nin()
        assert ours.get_nin() == nin
        events["slips"] += nin != ref.Nmf
        prev = ref.state
        chunk = stream[ptr:ptr + nin]
        ret, want = ours.do_radae_rx(chunk, out), ref.do_radae_rx(chunk,
                                                                  out_ref)
        ptr += nin
        where = (name, ref.mf)
        assert ret == want, where
        assert (ours.state, ours.nin, ours.tmax, ours.fmax, ours.uw_errors) \
            == (ref.state, ref.nin, ref.tmax, ref.fmax, ref.uw_errors), where
        assert abs(ours.receiver.snrdB_3k_est
                   - ref.receiver.snrdB_3k_est) < 1e-3, where
        assert ours.get_snrdB_3k_est() == ref.get_snrdB_3k_est(), where
        if ret:
            np.testing.assert_allclose(out, out_ref, **TOL, err_msg=str(where))
        events["valid"] += ret & 1
        events["eoo"] += ret >> 1
        events["unsync"] += prev == "sync" and ref.state == "search"
    assert events["valid"] >= 8, events
    if name in ("clean", "foff"):
        assert events["eoo"] == 1, events
    if name == "slip":
        assert events["slips"] >= 1, events
    if name == "foff_err":             # the unique word drops the false sync
        assert events["unsync"] > events["eoo"], events


def _rx(rx, stream):
    floats_out = np.zeros(rx.get_n_floats_out(), np.float32)
    chunks, eoo_soft, ptr = [], None, 0
    while ptr + rx.get_nin() <= len(stream):
        nin = rx.get_nin()
        ret = rx.do_radae_rx(stream[ptr:ptr + nin], floats_out)
        ptr += nin
        if ret & 1:
            chunks.append(floats_out.reshape(-1, 36).copy())
        if ret & 2:
            eoo_soft = floats_out.copy()
    out = np.concatenate(chunks) if chunks else np.zeros((0, 36), np.float32)
    return out, eoo_soft


@pytest.fixture(scope="module")
def port_loopback(fixture):
    """The port's tx (noise on) of GATE_NF frames + the EOO frame with data
    bits + 3000 zeros, through the port's rx."""
    params, _, feats = fixture
    tx = RadaeTx(params=params, auxdata=True, device="cpu")
    bits = _eoo_bits(tx.get_Neoo_bits())
    tx.set_eoo_bits(bits)
    stream = _stream(tx, feats, GATE_NF)
    out, eoo_soft = _rx(RadaeRx(params=params, auxdata=True, v=0,
                                device="cpu"), stream)
    return out, eoo_soft, bits


def test_port_loopback_loss_gate(fixture, port_loopback):
    """tests/test_streaming_trained.py's clean gate: acquisition within
    ~0.7 s and the aligned loss below the checkpoint's loss + 0.15."""
    _, meta, feats = fixture
    out, _, _ = port_loopback
    assert out.shape[0] >= 34 * 12, out.shape
    n = out.shape[0]
    ref = torch.as_tensor(feats[:12 * GATE_NF, :20])
    got = torch.as_tensor(out[None, :, :20])
    loss = min(float(distortion_loss(ref[None, s:s + n], got)[0])
               for s in range(0, 12 * GATE_NF - n + 1))
    assert loss < float(meta.get("loss", 0.35)) + 0.15, loss


def test_port_loopback_eoo_gate(port_loopback):
    """tests/test_streaming_trained.py's EOO data gate: found, BER < 0.05."""
    _, eoo_soft, bits = port_loopback
    assert eoo_soft is not None
    ber = float((eoo_soft[:len(bits)] * bits < 0).mean())
    assert ber < 0.05, ber


def test_cli_pipe_gives_the_classes_bytes(fixture, tmp_path):
    """python -m radae_tpu_torch txe --device cpu | ... rxe --device cpu on
    10 frames: the bytes RadaeTx and RadaeRx give."""
    params, _, feats = fixture
    nf = 10
    fin = tmp_path / "f.f32"
    feats[:12 * nf].astype(np.float32).tofile(fin)
    env = dict(os.environ, OMP_NUM_THREADS="1")

    def cli(*args, stdin):
        r = subprocess.run([sys.executable, "-m", "radae_tpu_torch", *args,
                            "--model_name", CKPT, "--device", "cpu"],
                           input=stdin, capture_output=True, cwd=ROOT,
                           env=env, timeout=120)
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        return r.stdout

    iq = cli("txe", stdin=fin.read_bytes())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # as the CLI's OMP_NUM_THREADS=1
    try:
        tx = RadaeTx(params=params, device="cpu")
        want = np.concatenate([tx.do_radae_tx(feats[12 * k:12 * (k + 1)]
                                              .flatten()) for k in range(nf)]
                              + [tx.do_eoo()])
        assert iq == want.tobytes()
        stream = np.concatenate([want, np.zeros(3000, np.complex64)])
        got = cli("rxe", "-v", "0", stdin=stream.tobytes())
        out, _ = _rx(RadaeRx(params=params, v=0, device="cpu"), stream)
    finally:
        torch.set_num_threads(threads)
    assert len(got) > 0 and got == out.tobytes()
