"""The port's spans and counters (radae_tpu_torch/trace.py) on the CPU:
nothing recorded without a profiler, each serving path's spans once a call
and nested, on the profiler's clock, the counters, and the benchmark's
readers of them (benchmark/spans.py, benchmark/metrics/) on hand-laid
spans and kernels."""

import importlib
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from radae_tpu_torch import trace
from radae_tpu_torch.config import flagship_config
from radae_tpu_torch.models.core import CoreDecoder, CoreEncoder
from radae_tpu_torch.models.radae import RADAE
from radae_tpu_torch.ops import _kernels, fused_core
from radae_tpu_torch.runtime import (make_streaming_rx_step,
                                     make_streaming_tx_step)

B = 2
READERS = ("front_end_host_ms", "front_end_dev_ms", "kernel_host_ms",
           "idle_program_pct")
# each path's spans: name -> the name of the span it opens inside
NESTING = {
    "rx": {"rx.front_end": None, "rx.front_end.dft": "rx.front_end",
           "rx.front_end.pilot_eq": "rx.front_end",
           "rx.front_end.demap": "rx.front_end", "rx.decode": None,
           "kernel.fused_decoder_step": "rx.decode"},
    "tx": {"tx.encode": None, "kernel.fused_encoder_step": "tx.encode",
           "tx.modulate": None, "modulate.map_pilots": "tx.modulate",
           "modulate.idft_cp": "tx.modulate", "modulate.pa": "tx.modulate"},
    "file": {"file.front_end": None, "file.front_end.dft": "file.front_end",
             "file.front_end.pilot_eq": "file.front_end",
             "file.front_end.demap": "file.front_end", "file.decode": None,
             "codec.weights": "file.decode",
             "kernel.fused_decoder_step": "file.decode"},
}


@pytest.fixture(autouse=True)
def empty_buffer():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.reset()
    yield
    trace.reset()
    torch.set_num_threads(n)


def _tensors(tree):
    return {k: _tensors(v) if isinstance(v, dict)
            else torch.as_tensor(v, dtype=torch.float32)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def paths():
    """One call of each serving path at B=2 (a file of 3 modem frames),
    each a closure over its state."""
    cfg = flagship_config(quant_noise=False)
    rng = np.random.default_rng(3)
    dec = CoreDecoder(cfg.latent_dim, cfg.feature_dim)
    enc = CoreEncoder(cfg.feature_dim, cfg.latent_dim, cfg.bottleneck)
    rx_step = make_streaming_rx_step(cfg, dec, B, fused=True, device="cpu")
    tx_step = make_streaming_tx_step(cfg, enc, B, fused=True, device="cpu")
    dw = fused_core.decoder_weights(dec.init(1), "cpu")
    ew = fused_core.encoder_weights(enc.init(2), "cpu")
    iq = torch.as_tensor(rng.standard_normal(
        (B, cfg.Nmf + cfg.M + cfg.Ncp, 2)).astype(np.float32))
    feats = torch.as_tensor(rng.standard_normal(
        (B, 12, cfg.feature_dim)).astype(np.float32))
    state = {"rx": fused_core.decoder_state_zero(B, "cpu"),
             "tx": fused_core.encoder_state_zero(B, "cpu")}
    model = RADAE(cfg, "cpu")
    params = model.init(0)
    z = np.tanh(rng.standard_normal((1, 3 * cfg.Nzmf, cfg.latent_dim)))
    tx = model.transmitter(z.astype(np.float32),
                           cfg.num_timesteps_at_rate_Rs(3 * 4 * cfg.Nzmf))
    file = torch.stack([tx.re[0], tx.im[0]], dim=-1)

    def rx():
        _, state["rx"] = rx_step(dw, iq, state["rx"])

    def tx_call():
        _, state["tx"] = tx_step(ew, feats, state["tx"])

    return {"rx": rx, "tx": tx_call,
            "file": lambda: model.receiver(params, file)}


def _traced(call, n):
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            call()
    return prof


def test_no_profiler_records_nothing(paths):
    with torch.no_grad():
        paths["rx"]()
        paths["rx"]()
    assert trace.spans() == [] and trace.dropped() == 0
    # the no-op context is one shared object
    assert trace.span("a", "cpu") is trace.span("b")


@pytest.mark.parametrize("path", sorted(NESTING))
def test_spans_nest_once_a_call(paths, path):
    _traced(paths[path], 2)
    got = trace.spans()
    want = NESTING[path]
    assert sorted(s.name for s in got) == sorted(list(want) * 2)
    for s in got:
        assert s.parent == want[s.name], s
        assert s.card_ms is None and s.t1_ns >= s.t0_ns
        if s.parent is not None:
            # inside one of its parent's spans
            assert any(p.name == s.parent and p.t0_ns <= s.t0_ns
                       and s.t1_ns <= p.t1_ns for p in got), s


def test_span_clock_is_the_profilers(paths):
    """Each span's time.time_ns() edges lie within 50 us of its range's
    start and end in the profiler's events: one clock."""
    prof = _traced(paths["rx"], 3)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if (e.name() in NESTING["rx"]
                and e.device_type() == torch.autograd.DeviceType.CPU):
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in NESTING["rx"]:
        ss = sorted((s for s in trace.spans() if s.name == name),
                    key=lambda s: s.t0_ns)
        rs = sorted(ranges[name])
        assert len(ss) == len(rs) == 3
        for s, (a, b) in list(zip(ss, rs))[1:]:     # the first call warms up
            assert abs(s.t0_ns - a) <= 50_000 and abs(s.t1_ns - b) <= 50_000, (
                s, a, b)


def test_launch_counter_is_fused_core_launches():
    assert trace.COUNTERS["launch"] is fused_core.LAUNCHES
    assert set(trace.COUNTERS) == {"launch", "pack", "build", "load"}
    assert len(fused_core.LAUNCHES) == 23
    key = "fused_decoder_step"
    saved = dict(fused_core.LAUNCHES)
    try:
        fused_core.LAUNCHES[key] += 5
        assert trace.COUNTERS["launch"][key] == saved[key] + 5
        fused_core.reset_launches()
        assert not any(trace.COUNTERS["launch"].values())
    finally:
        fused_core.LAUNCHES.update(saved)


def test_decoder_pack_counts_repacks_only():
    """pack.decoder moves on the first receiver call and after an in-place
    update of a decoder leaf, not on a repeat call."""
    cfg = flagship_config(quant_noise=False)
    model = RADAE(cfg, "cpu")
    params = _tensors(model.init(0))
    file = torch.zeros((3 * cfg.Nmf, 2))
    packs = trace.COUNTERS["pack"]
    n0, e0 = packs["decoder"], packs["encoder"]
    with torch.no_grad():
        model.receiver(params, file)
        assert packs["decoder"] == n0 + 1
        model.receiver(params, file)
        assert packs["decoder"] == n0 + 1
        params["decoder"]["dense_1"]["w"].mul_(1.5)
        model.receiver(params, file)
        assert packs["decoder"] == n0 + 2
    assert packs["encoder"] == e0


def test_span_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with trace.span(f"s{i}"):
                pass
    assert [s.name for s in trace.spans()] == ["s0", "s1", "s2"]
    assert trace.dropped() == 2
    trace.reset()
    assert trace.spans() == [] and trace.dropped() == 0


def test_build_and_load_counters(monkeypatch, tmp_path):
    """An nvcc run counts under build, with its seconds; a library load
    under load (a stand-in compiler and loader)."""
    monkeypatch.setitem(trace.COUNTERS, "build", {})
    monkeypatch.setitem(trace.COUNTERS, "load", {})
    monkeypatch.setattr(_kernels, "SRC_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "nvcc", lambda: shutil.which("true"))
    monkeypatch.setattr(_kernels, "_loaded", {})
    monkeypatch.setitem(_kernels._SIGNATURES, "stub", {"radae_stub": []})
    monkeypatch.setattr(_kernels.ctypes, "CDLL",
                        lambda path: SimpleNamespace(
                            radae_stub=SimpleNamespace()))
    (tmp_path / "stub.cu").write_text("// stub\n")
    _kernels.library("stub")
    _kernels.library("stub")
    assert trace.COUNTERS["build"]["stub"] == 1
    assert trace.COUNTERS["build"]["stub_s"] > 0
    assert trace.COUNTERS["load"] == {"stub": 1}


# -- the benchmark's readers ------------------------------------------------

def _reader(name):
    return importlib.import_module(f"benchmark.metrics.{name}")


def _ctx(spans, monkeypatch, kernels=(), calls=1, window_s=1.0,
         call_dev_s=()):
    """A run's context with the program's buffer replaced by `spans`
    ((name, parent, t0 s, t1 s, card ms)) and a trace of `kernels`
    ((name, start s, duration s)) on a card clock of its own."""
    recs = [trace.Span(n, p, round(a * 1e9), round(b * 1e9), c)
            for n, p, a, b, c in spans]
    monkeypatch.setattr(trace, "spans", lambda: list(recs))
    return SimpleNamespace(calls=calls, call_dev_s=list(call_dev_s),
                           trace=SimpleNamespace(kernels=list(kernels),
                                                 window_s=window_s,
                                                 busy_s=0.5))


# one rx call on the host's clock: the modem span, then the decoder's
RX_CALL = [("rx.front_end", None, 100.05, 100.25, 150.0),
           ("rx.front_end.dft", "rx.front_end", 100.06, 100.24, None),
           ("rx.decode", None, 100.45, 100.60, None),
           ("kernel.fused_decoder_step", "rx.decode", 100.46, 100.47, None)]


def test_idle_program_pct_reads_the_hand_computed_share(monkeypatch):
    """The card's clock runs 1 s ahead.  The call starts on the card at
    101.05 (its decoder kernel ends at 101.50, 0.45 s of card time after
    the harness's first event): its top-level spans land on [101.05,
    101.25] and [101.45, 101.60] against device work [101.00, 101.10] and
    [101.30, 101.50]: 0.15 + 0.10 s idle of a 1 s window; a child span
    adds nothing."""
    ctx = _ctx(RX_CALL, monkeypatch, call_dev_s=[0.45],
               kernels=[("copy", 101.0, 0.1),
                        ("void dec_kernel<false>", 101.3, 0.2)])
    assert _reader("idle_program_pct").read(ctx) == pytest.approx(25.0,
                                                                  abs=1e-4)


@pytest.mark.parametrize("modem_after", [False, True])
def test_front_end_dev_ms_counts_busy_time_in_the_card_window(
        monkeypatch, modem_after):
    """The card's clock runs 0.5 s ahead.  rx: the call starts on the card
    at 100.50 and its decoder kernel runs from 100.545, so the modem's
    window is [100.50, 100.545]: 20 ms of its work, not the previous
    call's gather at 100.49 nor the one after the kernel.  tx: the encoder
    kernel ends at 100.52 and the modem span has 30 card ms, so the window
    is [100.52, 100.55]: the same 20 ms, not the gather at 100.551."""
    if modem_after:
        spans_ = [("tx.encode", None, 100.0, 100.0008, None),
                  ("kernel.fused_encoder_step", "tx.encode", 100.0001,
                   100.0007, None),
                  ("tx.modulate", None, 100.001, 100.002, 30.0)]
        kernels = [("void enc_kernel<false>", 100.5, 0.02),
                   ("idft", 100.521, 0.01), ("pa", 100.535, 0.01),
                   ("gather", 100.551, 0.01)]
        dev_s = 100.55 - 100.499
    else:
        spans_ = [("rx.front_end", None, 100.0, 100.002, 50.0),
                  ("rx.decode", None, 100.003, 100.004, None),
                  ("kernel.fused_decoder_step", "rx.decode", 100.003,
                   100.0035, None)]
        kernels = [("gather", 100.49, 0.005), ("copy", 100.51, 0.01),
                   ("gemm", 100.53, 0.01),
                   ("void dec_kernel<false>", 100.545, 0.5),
                   ("gather", 101.05, 0.01)]
        dev_s = 101.045 - 100.5
    ctx = _ctx(spans_, monkeypatch, kernels=kernels, call_dev_s=[dev_s])
    assert _reader("front_end_dev_ms").read(ctx) == pytest.approx(20.0,
                                                                  abs=1e-3)
    assert _reader("front_end_host_ms").read(ctx) == pytest.approx(
        1.0 if modem_after else 2.0, abs=1e-3)


def test_card_readers_fail_where_calls_and_kernels_do_not_pair(monkeypatch):
    ctx = _ctx(RX_CALL, monkeypatch, call_dev_s=[0.45],
               kernels=[("void dec_kernel<false>", 101.3, 0.2),
                        ("void dec_kernel<false>", 101.6, 0.2)])
    for name in ("front_end_dev_ms", "idle_program_pct"):
        with pytest.raises(RuntimeError, match="2 core kernels"):
            _reader(name).read(ctx)


def test_kernel_host_ms_sums_kernel_and_weight_spans(monkeypatch):
    ctx = _ctx([("file.front_end", None, 1.0, 1.004, None),
                ("codec.weights", "file.decode", 1.005, 1.0051, None),
                ("kernel.fused_decoder_step", "file.decode", 1.006, 1.0064,
                 None),
                ("file.decode", None, 1.005, 1.007, None)], monkeypatch,
               calls=1)
    assert _reader("kernel_host_ms").read(ctx) == pytest.approx(0.5,
                                                                abs=1e-3)
    # off the card: no events, no kernels
    assert _reader("front_end_dev_ms").read(ctx) is None
    assert _reader("idle_program_pct").read(ctx) is None


def test_modem_readers_fail_on_a_count_other_than_one_a_call(monkeypatch):
    ctx = _ctx([("tx.modulate", None, 1.0, 1.001, None),
                ("tx.modulate", None, 2.0, 2.001, None)], monkeypatch,
               calls=3)
    with pytest.raises(RuntimeError, match="2 top-level modem spans"):
        _reader("front_end_host_ms").read(ctx)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_with_an_empty_buffer(name, monkeypatch):
    ctx = _ctx([], monkeypatch, kernels=[("k", 1.0, 0.1)])
    assert _reader(name).read(ctx) is None
