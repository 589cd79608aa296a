"""The check against its control and its faults: the reference in TF32 in
the program's place, and the timed path broken underneath, each come out
not correct, with every other step of a run as the benchmark runs it."""

import pytest
import torch

from conftest import CELLS, ROOT, SMALL, run_small
from benchmark import harness


def judged(line, cell):
    """The line's compared numbers held to the cell's limits."""
    limits = harness.Spec(ROOT).limits(cell)
    return all(c["value"] <= limits[k] for k, c in line["checks"].items())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    assert judged(run_small(cell), cell)
    assert not judged(run_small(cell, sut="control"), cell)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell, card):
    import time
    traffic = harness.Spec(ROOT).workload(cell)["traffic"]
    small = dict(SMALL[traffic])
    if "streams" in small:
        small.update(streams=256, check_streams=32)
    for sut, want in (("program", True), ("control", False)):
        line = harness.run_cell(ROOT, cell, 31, 0.5, False, card,
                                time.perf_counter(), sut=sut, overrides=small)
        assert judged(line, cell) is want


# -- faults planted in the program --------------------------------------------

def _unchanged_state(step):
    def f(w, x, state, *a, **k):
        out, _ = step(w, x, state, *a, **k)
        return out, state
    return f


def _half_batch(step):
    """The second half of the streams is not computed: it gets the mean of
    the first half's outputs and keeps its state."""
    def f(w, x, state, *a, **k):
        h = x.shape[0] // 2
        out, new = step(w, x, state, *a, **k)
        out = out.clone()
        out[h:] = out[:h].mean(dim=0, keepdim=True)
        new = tuple(torch.cat([n[:h], s[h:]]) for n, s in zip(new, state))
        return out, new
    return f


def _altered(step):
    """Every answer nudged where it is produced: one output column moved by
    a thousandth of the output's largest magnitude."""
    def f(w, x, state, *a, **k):
        out, new = step(w, x, state, *a, **k)
        out = out.clone()
        out[..., 0] += 1e-3 * out.abs().max()
        return out, new
    return f


def _half_chain(step):
    """The second half of a file's z-steps is not decoded: it gets the mean
    of the first half's features."""
    def f(w, z, state, *a, **k):
        out, new = step(w, z, state, *a, **k)
        out = out.clone()
        h = out.shape[1] // 2
        out[:, h:] = out[:, :h].mean(dim=1, keepdim=True)
        return out, new
    return f


FAULTS = [
    ("flagship.rx_streams", "fused_decoder_step", _unchanged_state),
    ("flagship.rx_streams", "fused_decoder_step", _half_batch),
    ("flagship.rx_streams", "fused_decoder_step", _altered),
    ("l40.rx_streams", "fused_decoder_step", _unchanged_state),
    ("flagship.tx_streams", "fused_encoder_step", _unchanged_state),
    ("flagship.tx_streams", "fused_encoder_step", _half_batch),
    ("flagship.tx_streams", "fused_encoder_step", _altered),
    ("flagship.rx_file", "fused_decoder_step", _altered),
    ("flagship.rx_file", "fused_decoder_step", _half_chain),
]


@pytest.mark.parametrize("cell,target,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}"
                              for c, _, f in FAULTS])
def test_fault_is_not_correct(cell, target, fault, monkeypatch):
    from radae_tpu_torch.ops import fused_core
    monkeypatch.setattr(fused_core, target, fault(getattr(fused_core, target)))
    line = run_small(cell)
    assert line["correct"] is False
    assert not judged(line, cell)
