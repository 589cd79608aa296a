"""The traffic generator: the same seed gives the same inputs, another
seed other content at the same sizes."""

import json

import pytest
import torch

from conftest import ROOT, SMALL
from benchmark import generator
from benchmark.reference import radae_ref as R

CFG = json.loads((ROOT / "benchmark/configs/flagship.json").read_text())


def traffic(name):
    t = json.loads((ROOT / f"benchmark/traffic/{name}.json").read_text())
    return dict(t, **SMALL[name])


def make(name, seed):
    src = generator.Source(seed, "cpu")
    nets = R.Nets(R.load_weights(ROOT / CFG["weights"], "cpu"))
    modem = R.Modem(CFG, "cpu")
    t = traffic(name)
    if name == "rx_streams":
        return [generator.stream_iq(ROOT, t, CFG, nets, modem, src)]
    if name == "tx_streams":
        return [generator.stream_features(ROOT, t, CFG, src)]
    return generator.file_iq(ROOT, t, CFG, nets, modem, src)


@pytest.mark.parametrize("name", ["rx_streams", "tx_streams", "rx_file"])
def test_traffic_is_deterministic_by_seed(name):
    a, b, c = make(name, 2**31 + 11), make(name, 2**31 + 11), make(name, 7)
    assert [x.shape for x in a] == [x.shape for x in c]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    assert all(torch.isfinite(x).all() for x in a)


def test_stream_pool_frames_overlap_by_the_next_pilot_row():
    (pool,) = make("rx_streams", 3)
    M, Ncp, Nmf = CFG["M"], CFG["Ncp"], (CFG["Ns"] + 1) * (CFG["M"] + CFG["Ncp"])
    assert pool.shape == (4, 4, Nmf + M + Ncp, 2)
    # frame k's closing pilot row is frame k+1's first row
    assert torch.equal(pool[0, :, Nmf:], pool[1, :, :M + Ncp])


def test_file_lengths_and_order_do_not_depend_on_the_seed():
    t = json.loads((ROOT / "benchmark/traffic/rx_file.json").read_text())
    frames = generator.file_frames(t)
    assert len(frames) == 16 and min(frames) == 40 and max(frames) == 243
    for seed in (1, 2**31 + 5):
        order = generator.file_order(t, generator.Source(seed, "cpu"), 48)
        assert sorted(order) == sorted(list(range(16)) * 3)
    o1 = generator.file_order(t, generator.Source(1, "cpu"), 16)
    o2 = generator.file_order(t, generator.Source(2, "cpu"), 16)
    assert o1 != o2
