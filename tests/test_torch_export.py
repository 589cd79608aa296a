"""The port's host-side modules against radae_tpu's on the CPU: the
flat-binary helpers (data/io.py) and the int16 converters exactly, the SNR
calibration constants and the native header byte for byte, the weight
export (RTPW blob byte for byte, the generated C arrays but for the line
that names the generator, the native C decoder on the port's blob against
the port's plain CoreDecoder at test_native.py's tolerance), the one-copy
transfer of a params tree (utils/hostio.py), the results page and the
plots."""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import threadpoolctl
import torch

from radae_tpu import calibration as jcal
from radae_tpu import export as jexport
from radae_tpu.data import io as jio
from radae_tpu.tools import converters as jconv
from radae_tpu_torch import calibration, export
from radae_tpu_torch.convert import load_checkpoint, params_to_torch
from radae_tpu_torch.data import io as pio
from radae_tpu_torch.tools import converters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "fixtures", "model_fs_flagship.npz")


@pytest.fixture(scope="module")
def one_thread():
    """One thread in torch and in numpy's BLAS (the random weights' QR):
    pools that the test workers share slowed a random model's init
    thirtyfold beside three other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    return load_checkpoint(CKPT)[0]


def test_data_package_exports_radae_tpus_names():
    import radae_tpu.data as jdata
    import radae_tpu_torch.data as pdata
    names = [n for n in dir(jdata) if not n.startswith("_")
             and n not in ("io", "dataset")]
    assert all(hasattr(pdata, n) for n in names), names


def test_io_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((40, 36)).astype(np.float32)
    fpath = str(tmp_path / "f.f32")
    feats.tofile(fpath)
    for num_used in (20, 21):
        got = pio.features_from_file(fpath, num_used)
        want = jio.features_from_file(fpath, num_used)
        assert got.shape == (1, 40, num_used) and np.array_equal(got, want)
    for f, n in ((feats[None, :, :21], 21), (feats[:, :20], 20),
                 (feats[:, :18], 20)):
        pio.features_to_file(str(tmp_path / "p.f32"), f, n)
        jio.features_to_file(str(tmp_path / "j.f32"), f, n)
        assert (tmp_path / "p.f32").read_bytes() == \
            (tmp_path / "j.f32").read_bytes()
    iq = (rng.standard_normal(100) + 1j * rng.standard_normal(100)) \
        .astype(np.complex64)
    pio.write_c64(str(tmp_path / "p.c64"), iq)
    jio.write_c64(str(tmp_path / "j.c64"), iq)
    assert (tmp_path / "p.c64").read_bytes() == \
        (tmp_path / "j.c64").read_bytes()
    assert np.array_equal(pio.read_c64(str(tmp_path / "p.c64")), iq)
    x = 5 * rng.standard_normal(64).astype(np.float32)
    for a in (x, iq * 5, (iq * 5).astype(np.complex128)):
        for real in (False, True):
            got = pio.f32_to_int16(a, real=real)
            assert got.dtype == np.int16
            assert np.array_equal(got, jio.f32_to_int16(a, real=real))
    s = rng.integers(-32768, 32767, 64).astype(np.int16)
    for zeropad in (False, True):
        assert np.array_equal(pio.int16_to_f32(s, 1000.0, zeropad),
                              jio.int16_to_f32(s, 1000.0, zeropad))


def _pipe(fn, argv, data, monkeypatch):
    out = io.BytesIO()
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))
    monkeypatch.setattr(sys, "stdout", io.TextIOWrapper(out))
    fn(argv)
    sys.stdout.flush()
    return out.getvalue()


@pytest.mark.parametrize("argv", [[], ["--real"], ["--scale", "1000"]])
def test_f32toint16_matches_jax(argv, monkeypatch):
    # longer than one 4096-sample read, so the stream crosses reads
    x = (3 * np.random.default_rng(1).standard_normal(10000)).astype(
        np.float32).tobytes()
    assert _pipe(converters.f32toint16, argv, x, monkeypatch) == \
        _pipe(jconv.f32toint16, argv, x, monkeypatch)


@pytest.mark.parametrize("argv", [[], ["--zeropad"], ["--scale", "1000"]])
def test_int16tof32_matches_jax(argv, monkeypatch):
    x = np.random.default_rng(2).integers(-32768, 32767, 10001).astype(
        np.int16).tobytes()
    assert _pipe(converters.int16tof32, argv, x, monkeypatch) == \
        _pipe(jconv.int16tof32, argv, x, monkeypatch)


def test_calibration_constants_and_native_header(tmp_path):
    assert (calibration.SNR_CAL_M, calibration.SNR_CAL_C) == \
        (jcal.SNR_CAL_M, jcal.SNR_CAL_C)
    with open(os.path.join(ROOT, "native", "snr_cal.h")) as f:
        on_disk = f.read()
    assert calibration.render_native_header() == on_disk
    assert calibration.render_native_header() == jcal.render_native_header()
    path = calibration.write_native_header(str(tmp_path / "snr_cal.h"))
    assert open(path).read() == on_disk


def test_blob_matches_jax_byte_for_byte(tree, tmp_path):
    ours, theirs = str(tmp_path / "p.bin"), str(tmp_path / "j.bin")
    export.write_blob(ours, tree)
    jexport.write_blob(theirs, tree)
    blob = open(ours, "rb").read()
    assert blob[:4] == b"RTPW" and blob == open(theirs, "rb").read()
    # a tree of tensors exports the same bytes
    export.write_blob(ours, params_to_torch(tree, "cpu"))
    assert open(ours, "rb").read() == blob


def test_c_arrays_match_jax_but_the_generator_line(tree, tmp_path):
    # the decoder's input, first GLU and output layers: a fused GLU and
    # plain matrices and biases (the whole tree formats 1.7M values, 2.6 s
    # a package)
    part = {"decoder": {k: tree["decoder"][k]
                        for k in ("dense_1", "glu1", "output")}}
    export.write_c_arrays(str(tmp_path / "p"), part)
    jexport.write_c_arrays(str(tmp_path / "j"), part)
    for ext in (".h", ".c"):
        ours = (tmp_path / f"p{ext}").read_text().splitlines()
        theirs = (tmp_path / f"j{ext}").read_text().splitlines()
        assert len(ours) == len(theirs)
        diff = [(a, b) for a, b in zip(ours, theirs) if a != b]
        if ext == ".c":    # the include names the file's own prefix
            diff = [(a, b) for a, b in diff
                    if (a, b) != ('#include "p.h"', '#include "j.h"')]
        assert len(diff) == 1, diff
        assert "generated by radae_tpu_torch.export" in diff[0][0]
        assert "generated by radae_tpu.export" in diff[0][1]


def test_export_main_random_matches_jax(one_thread, tmp_path):
    ours, theirs = str(tmp_path / "p.bin"), str(tmp_path / "j.bin")
    export.main(["random", ours, "--auxdata"])
    jexport.main(["random", theirs, "--auxdata"])
    assert open(ours, "rb").read() == open(theirs, "rb").read()


def test_native_decoder_on_the_ports_blob(one_thread, tree, tmp_path):
    """The port's blob through the unchanged native runtime (built into
    tmp_path, not native/build, which tests/test_native.py builds) against
    the port's plain CoreDecoder (tests/test_native.py's tolerance)."""
    from radae_tpu_torch.models.core import CoreDecoder
    nb = str(tmp_path / "nb")
    r = subprocess.run(["make", "-C", os.path.join(ROOT, "native"),
                        f"BUILD={nb}", f"{nb}/test_core"],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    blob = str(tmp_path / "w.bin")
    export.write_blob(blob, tree)
    z = np.tanh(np.random.default_rng(1).standard_normal(
        (1, 12, 80))).astype(np.float32)
    fin, fout = str(tmp_path / "z.f32"), str(tmp_path / "f.f32")
    z.tofile(fin)
    r = subprocess.run([f"{nb}/test_core", "dec", blob, fin, fout],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    f_c = np.fromfile(fout, np.float32).reshape(1, -1, 21)
    with torch.no_grad():
        want, _ = CoreDecoder(80, 21)(params_to_torch(tree["decoder"], "cpu"),
                                      torch.as_tensor(z))
    np.testing.assert_allclose(f_c, want.numpy(), rtol=1e-4, atol=2e-4)


def test_device_put_tree_round_trips_exactly(tree):
    from radae_tpu_torch.utils.hostio import device_put_tree, to_host
    got = device_put_tree(tree, "cpu")
    # one buffer: every leaf a view of the same storage
    bases = set()

    def walk(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                walk(a[k], b[k])
        else:
            assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
            assert np.array_equal(to_host(b), a)
            bases.add(b.untyped_storage().data_ptr())
    walk(tree, got)
    assert len(bases) == 1
    nested = device_put_tree({"a": [np.ones(3, np.float32),
                                    (np.zeros((2, 2), np.float32),)]}, "cpu")
    assert isinstance(nested["a"], list) and isinstance(nested["a"][1], tuple)
    with pytest.raises(TypeError):
        device_put_tree({"a": np.ones(3)}, "cpu")


def test_to_host_handles_complex_values():
    from radae_tpu_torch.ops import cplx
    from radae_tpu_torch.utils.hostio import host_complex, to_host
    z = (np.arange(6) + 1j * np.arange(6)[::-1]).astype(np.complex64)
    for x in (torch.as_tensor(z), torch.as_tensor(z.astype(np.complex128)),
              cplx.C(torch.as_tensor(z.real.copy()),
                     torch.as_tensor(z.imag.copy()))):
        got = host_complex(x)
        assert got.dtype == np.complex64 and np.array_equal(got, z)
    assert np.array_equal(to_host(torch.arange(4.0)), np.arange(4.0))
    assert to_host(z) is z


def test_report_renders_the_named_records(tmp_path):
    from radae_tpu_torch.tools.report import main as report_main
    sweep = {"awgn@3.0": 0.31, "awgn@10.0": 0.22,
             "mpp@3.0": 0.45, "mpp@10.0": 0.27}
    sj = tmp_path / "sweep.json"
    sj.write_text(json.dumps(sweep))
    rec = tmp_path / "bench_line.json"
    rec.write_text(json.dumps({"metric": "serving_throughput",
                               "value": 1234.5, "unit": "audio-s/s",
                               "config": "B=8"}))
    (tmp_path / "other.json").write_text(json.dumps(
        {"metric": "not_named", "value": 1.0}))
    out = tmp_path / "out.html"
    assert report_main([str(out), "--sweep", str(sj),
                        "--bench", str(rec)]) == 0
    page = out.read_text()
    assert "0.450" in page and "mpp" in page and "10 dB" in page
    assert "serving_throughput" in page and "1,234.5" in page
    assert "bench_line.json" in page and "B=8" in page
    assert "not_named" not in page


def test_plots_writes_every_kind(tmp_path):
    from radae_tpu_torch.tools.plots import main as plots_main
    rng = np.random.default_rng(0)
    z = np.sign(rng.standard_normal(4000)).astype(np.float32)
    zf = str(tmp_path / "z.f32")
    z.tofile(zf)
    iq = (rng.standard_normal(8000)
          + 1j * rng.standard_normal(8000)).astype(np.complex64)
    qf = str(tmp_path / "iq.f32")
    iq.tofile(qf)
    for kind, src in (("scatter", zf), ("scatter3d", zf), ("spectrum", qf),
                      ("specgram", qf), ("papr", qf)):
        out = str(tmp_path / f"{kind}.png")
        plots_main([kind, src, "--out", out])
        assert os.path.getsize(out) > 1000
    c1, c2 = str(tmp_path / "run1.txt"), str(tmp_path / "run2.txt")
    np.savetxt(c1, np.column_stack([np.arange(0, 10, 2.0),
                                    0.3 - 0.02 * np.arange(5)]))
    np.savetxt(c2, np.column_stack([np.arange(0, 10, 2.0),
                                    0.35 - 0.02 * np.arange(5)]))
    for kind in ("loss_eqno", "loss_cno", "ber"):
        out = str(tmp_path / f"{kind}.png")
        plots_main([kind, c1, "model_a", c2, "model_b", "--out", out])
        assert os.path.getsize(out) > 1000
    out = str(tmp_path / "loss.png")
    plots_main(["loss", c1, c2, "--out", out])
    assert os.path.getsize(out) > 1000
