"""The benchmark's plain reference against the port's plain CPU path, at a
few streams and frames and on one short file: the same functions, to f32
rounding."""

import json

import pytest
import torch

from conftest import ROOT
from benchmark import generator
from benchmark.program import program_config
from benchmark.reference import radae_ref as R
from benchmark.streams import rel_gap, state_gap

TOL = 2e-5      # largest difference over largest magnitude: f32 rounding
                # through five GRU layers (the CPU reads 1e-7 to 4e-6)


def setup(config):
    cfg = json.loads((ROOT / f"benchmark/configs/{config}.json").read_text())
    nets = R.Nets(R.load_weights(ROOT / cfg["weights"], "cpu"))
    return cfg, nets, R.Modem(cfg, "cpu")


def tree(cfg):
    from radae_tpu_torch.convert import load_checkpoint
    return load_checkpoint(str(ROOT / cfg["weights"]))[0]


@pytest.mark.parametrize("config", ["flagship", "l40"])
def test_geometry_matches_the_program(config):
    cfg, _, modem = setup(config)
    pc = program_config(cfg)
    assert torch.allclose(modem.Wfwd, torch.as_tensor(pc.Wfwd), atol=2e-6)
    assert torch.allclose(modem.Winv, torch.as_tensor(pc.Winv), atol=1e-7)
    assert torch.allclose(modem.P, torch.as_tensor(pc.P))
    assert modem.pilot_gain == pytest.approx(pc.pilot_gain, rel=1e-12)
    assert modem.Nmf == pc.Nmf


@pytest.mark.parametrize("config", ["flagship", "l40"])
def test_rx_step_matches_the_port(config):
    from radae_tpu_torch.models.core import CoreDecoder
    from radae_tpu_torch.ops import fused_core
    from radae_tpu_torch.runtime import make_streaming_rx_step

    cfg, nets, modem = setup(config)
    t = json.loads((ROOT / "benchmark/traffic/rx_streams.json").read_text())
    t.update(streams=5, pool_frames=3)
    pool = generator.stream_iq(ROOT, t, cfg, nets, modem,
                               generator.Source(9, "cpu"))
    pc = program_config(cfg)
    step = make_streaming_rx_step(pc, CoreDecoder(pc.latent_dim, 21), 5,
                                  fused=True, device="cpu")
    w = fused_core.decoder_weights(tree(cfg)["decoder"], "cpu")
    s, rs = fused_core.decoder_state_zero(5, "cpu"), nets.decoder_zero_state(5, "cpu")
    for k in range(3):
        f, s = step(w, pool[k], s)
        rf, rs = nets.decoder(modem.rx_frame(R.unpacked(pool[k])), rs)
        assert rel_gap(f, rf) < TOL and state_gap(s, rs) < TOL


def test_tx_step_matches_the_port():
    from radae_tpu_torch.models.core import CoreEncoder
    from radae_tpu_torch.ops import fused_core
    from radae_tpu_torch.runtime import make_streaming_tx_step

    cfg, nets, modem = setup("flagship")
    t = json.loads((ROOT / "benchmark/traffic/tx_streams.json").read_text())
    t.update(streams=5, pool_frames=3)
    pool = generator.stream_features(ROOT, t, cfg, generator.Source(9, "cpu"))
    pc = program_config(cfg)
    step = make_streaming_tx_step(pc, CoreEncoder(21, 80, 3), 5, fused=True,
                                  device="cpu")
    w = fused_core.encoder_weights(tree(cfg)["encoder"], "cpu")
    s, rs = fused_core.encoder_state_zero(5, "cpu"), nets.encoder_zero_state(5, "cpu")
    for k in range(3):
        out, s = step(w, pool[k], s)
        z, rs = nets.encoder(pool[k], rs, 3)
        assert rel_gap(out, R.packed(modem.modulate(z))) < TOL
        assert state_gap(s, rs) < TOL


def test_file_receiver_matches_the_port():
    from radae_tpu_torch.models.radae import RADAE

    cfg, nets, modem = setup("flagship")
    t = json.loads((ROOT / "benchmark/traffic/rx_file.json").read_text())
    t.update(files=2, seconds=[1.0, 2.0])
    files = generator.file_iq(ROOT, t, cfg, nets, modem,
                              generator.Source(9, "cpu"))
    model = RADAE(program_config(cfg), "cpu")
    with torch.no_grad():
        f, z = model.receiver(tree(cfg), files[1])
    rz = modem.rx_file(R.unpacked(files[1]))
    rf, _ = nets.decoder(rz, nets.decoder_zero_state(1, "cpu"))
    assert rel_gap(z, rz) < TOL and rel_gap(f, rf) < TOL


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -(1.0 + 2 ** -11), 3.0e-3])
    r = R.round_tf32(x)
    assert r[0] == 1.0
    assert r[1] == 1.0 + 2 ** -10          # the tie goes away from zero
    assert r[2] == 1.0 + 2 ** -10
    assert r[3] == -(1.0 + 2 ** -10)
    assert abs(r[4] - 3.0e-3) <= 3.0e-3 * 2 ** -11
