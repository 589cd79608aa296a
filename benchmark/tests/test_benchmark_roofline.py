"""The roofline's FLOP and byte counts against hand counts."""

import pytest

from benchmark.reference import roofline as r

CFG = {"latent_dim": 80, "feature_dim": 21, "M": 160, "Ncp": 32, "Ns": 4,
       "Nc": 30}


def test_decoder_counts():
    # dense_1 96x80; GRU w_ih 288 x (96+224+352+480+608), w_hh 5 x 288x96;
    # GLU 5 x 96x96; conv taps 2 x 32 x (192+320+448+576+704); out 84x736
    mats = (96 * 80 + 288 * 1760 + 5 * 288 * 96 + 5 * 96 * 96
            + 2 * 32 * 2240 + 84 * 736)
    assert mats == 904064
    assert r.decoder_shapes(80, 21) == (904064, 96 + 5 * 576 + 5 * 32 + 84,
                                        5 * 96 + 2240)
    assert r.decoder_shapes(40, 21)[0] == 904064 - 96 * 40
    assert r.decoder_shapes(80, 21)[2] == 2720


def test_encoder_counts():
    mats = (64 * 84 + 192 * 1920 + 5 * 192 * 64 + 2 * 96 * 2240 + 80 * 864)
    assert mats == 934656
    mats_e, _, state = r.encoder_shapes(80, 21)
    assert mats_e == 934656
    # h 5 x 64; rings 1x128, 2x288, 2x448, 2x608, 2x768
    assert state == 320 + 128 + 2 * (288 + 448 + 608 + 768) == 4672


def test_stream_call_bounds():
    f, b = r.kernel_cost("dec", 16384, 3, 80, 21)
    assert f == 2 * 904064 * 3 * 16384
    assert b == 4 * (904064 + 3220 + 16384 * (240 + 252 + 2 * 2720))
    assert r.least_s(f, b) == pytest.approx(b / 3.35e12)     # bytes bind
    f, b = r.kernel_cost("enc", 16384, 3, 80, 21)
    assert b == 4 * (934656 + 2544 + 16384 * (252 + 240 + 2 * 4672))
    assert r.least_s(f, b) * 1e3 == pytest.approx(0.1935, abs=1e-4)


def test_model_flops():
    cfg = {"latent_dim": 80, "feature_dim": 21}
    rx = {"direction": "rx", "streams": 2, "frames": 5}
    tx = {"direction": "tx", "streams": 2, "frames": 1}
    assert r.model_flops(rx, cfg) == 2 * 904064 * 15 * 2
    assert r.model_flops(tx, cfg) == 2 * 934656 * 3 * 2


def test_frame_cost():
    # 6 DFT rows x 160 x 30 at 8 FLOP; samples 2 x (5 x 192 + 192); 252
    # features out; state 2720 in and out; the DFT matrix 2 x 160 x 30
    f, b = r.frame_cost(16384, CFG)
    assert f == 16384 * (2 * 904064 * 3 + 8 * 6 * 160 * 30)
    assert b == 4 * (904064 + 3220 + 9600 + 16384 * (2304 + 252 + 5440))


def test_kernel_files():
    from benchmark import kernels
    assert kernels.names() == ["dec_kernel", "dec_merged_kernel",
                               "enc_kernel", "rx_frame_kernel"]
    rx = {"direction": "rx", "streams": 16384, "frames": 1}
    tx = dict(rx, direction="tx")
    dec = kernels.kernel("dec_kernel")
    assert dec.cost(rx, CFG) == r.kernel_cost("dec", 16384, 3, 80, 21)
    assert kernels.kernel("dec_merged_kernel").cost(rx, CFG) == dec.cost(rx, CFG)
    assert dec.cost(tx, CFG) is None
    enc = kernels.kernel("enc_kernel")
    assert enc.cost(tx, CFG) == r.kernel_cost("enc", 16384, 3, 80, 21)
    assert enc.cost(rx, CFG) is None
    two = dict(rx, frames=2)
    f1, b1 = r.frame_cost(16384, CFG)
    assert kernels.kernel("rx_frame_kernel").cost(two, CFG) == (2 * f1, 2 * b1)
    # every kernel's trace name is told from the others'
    for k in kernels.names():
        assert kernels.is_core(f"void (anonymous namespace)::{k}<false>()")
        others = [o for o in kernels.names() if o != k]
        assert all(kernels.kernel(o).MATCH not in
                   f"void {k}<false>()" for o in others)
    assert not kernels.is_core("void at::native::elementwise_kernel<128>()")


def _ctx(direction="rx", calls=4):
    from types import SimpleNamespace
    from benchmark import trace
    kname = "dec_kernel" if direction == "rx" else "enc_kernel"
    kern = [(f"void (anonymous namespace)::{kname}<false>(float*)", 0.1 * i,
             0.04) for i in range(calls)]
    kern += [("ampere_sgemm_32x32", 0.1 * i + 0.05, 0.01) for i in range(calls)]
    t = trace.Trace(window_s=0.1 * calls, busy_s=0.05 * calls,
                    kernels=kern, idle_by_range={}, device_ops=[])
    work = [{"direction": direction, "streams": 16384, "frames": 1}] * calls
    return SimpleNamespace(trace=t, work=work, calls=calls, cfg=CFG)


def test_device_metrics_from_a_trace():
    from benchmark.harness import load_module
    from conftest import ROOT

    def read(name, ctx):
        return load_module(ROOT / f"benchmark/metrics/{name}.py",
                           f"m_{name}").read(ctx)

    ctx = _ctx()
    least = r.least_s(*r.kernel_cost("dec", 16384, 3, 80, 21))
    assert read("dec_kernel_roofline", ctx) == pytest.approx(
        100 * least / 0.04)
    assert read("enc_kernel_roofline", ctx) is None
    assert read("modem_dev_ms", ctx) == pytest.approx(10.0)
    assert read("idle_pct", ctx) == pytest.approx(50.0)
    assert read("step_mfu", ctx) == pytest.approx(
        100 * 2 * 904064 * 3 * 16384 / 0.05 / 989e12)
    tx = _ctx("tx")
    assert read("dec_kernel_roofline", tx) is None
    assert read("enc_kernel_roofline", tx) == pytest.approx(
        100 * r.least_s(*r.kernel_cost("enc", 16384, 3, 80, 21)) / 0.04)


def test_a_share_over_100_fails_the_run(monkeypatch):
    from types import SimpleNamespace
    from conftest import run_small
    from benchmark import harness

    monkeypatch.setattr(harness.Spec, "reader", lambda self, m: SimpleNamespace(
        read=lambda ctx: 101.0))
    with pytest.raises(RuntimeError, match="counted too high"):
        run_small("flagship.rx_streams", trace=True)
