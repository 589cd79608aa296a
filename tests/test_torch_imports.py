"""The port stands alone: no file of radae_tpu_torch/ or chip_smoke.py
imports jax or radae_tpu, importing the port loads neither, and entry points
refuse to run on a missing card instead of falling back to the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(ROOT))
                    for p in (ROOT / "radae_tpu_torch").rglob("*.py")) \
    + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "radae_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module"):
            bad += [a.value for a in node.args if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "radae_tpu_torch").rglob("*.py")) + ["chip_smoke"]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_default_device_entry_points_raise_without_a_card(monkeypatch):
    from radae_tpu_torch import runtime
    from radae_tpu_torch.apps.rxe import RadaeRx
    from radae_tpu_torch.apps.txe import RadaeTx
    from radae_tpu_torch.config import flagship_config
    from radae_tpu_torch.convert import load_checkpoint, params_to_torch
    from radae_tpu_torch.dsp.streaming import ReceiverOne, TransmitterOne
    from radae_tpu_torch.models.core import CoreDecoder, CoreEncoder
    from radae_tpu_torch.ops import fused_core
    from radae_tpu_torch.tools import evaluate, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = flagship_config()
    with pytest.raises(RuntimeError, match="is_available"):
        runtime.make_streaming_rx_step(cfg, CoreDecoder(80, 21), 4)
    with pytest.raises(RuntimeError, match="is_available"):
        runtime.make_streaming_tx_step(cfg, CoreEncoder(21, 80, 3), 4)
    with pytest.raises(RuntimeError, match="is_available"):
        params_to_torch({"w": [1.0]})
    with pytest.raises(RuntimeError, match="is_available"):
        fused_core.make_fused_rx_frame_step(cfg, 4)
    with pytest.raises(RuntimeError, match="is_available"):
        fused_core.decoder_state_zero(4, merged=True)
    tree, _ = load_checkpoint(str(ROOT / "fixtures" / "model_fs_flagship.npz"))
    feats = str(ROOT / "fixtures" / "speech_feats.f32")
    for make in (lambda: TransmitterOne(cfg), lambda: ReceiverOne(cfg),
                 lambda: RadaeTx(params=tree), lambda: RadaeRx(params=tree),
                 lambda: RadaeTx(bypass_enc=True),
                 lambda: RadaeRx(bypass_dec=True),
                 lambda: train.main([feats, "/nonexistent", "--rate_Fs"]),
                 lambda: evaluate.main(["random", feats])):
        with pytest.raises(RuntimeError, match="is_available"):
            make()



def test_batch_serving_entry_points_default_to_the_card(monkeypatch,
                                                        tmp_path):
    from radae_tpu_torch import runtime
    from radae_tpu_torch.config import flagship_config
    from radae_tpu_torch.convert import load_checkpoint
    from radae_tpu_torch.models.core import CoreDecoder
    from radae_tpu_torch.ops import acquisition_op, fused_core
    from radae_tpu_torch.tools import rx_batch, tx_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = flagship_config()
    tree, _ = load_checkpoint(str(ROOT / "fixtures" / "model_fs_flagship.npz"))
    feat = tmp_path / "f.f32"
    np.zeros((24, 36), np.float32).tofile(feat)
    for make in (
            lambda: runtime.make_batched_receiver(cfg, CoreDecoder(80, 21),
                                                  4, 2),
            lambda: acquisition_op.make_detect_pilots(cfg),
            lambda: acquisition_op.make_detect_pilots_windowed(cfg, 2),
            lambda: acquisition_op.make_refine(cfg),
            lambda: fused_core.encoder_weights(tree["encoder"], quant="int8"),
            lambda: tx_batch.main([str(ROOT / "fixtures" /
                                       "model_fs_flagship.npz"),
                                   str(tmp_path), str(feat), "--fused"]),
            lambda: rx_batch.main([str(ROOT / "fixtures" /
                                       "model_fs_flagship.npz"),
                                   str(tmp_path), str(feat)])):
        with pytest.raises(RuntimeError, match="is_available"):
            make()


def test_file_tools_default_to_the_card(monkeypatch, tmp_path):
    from radae_tpu_torch.config import flagship_config
    from radae_tpu_torch.models.radae import RADAE
    from radae_tpu_torch.tools import inference, loss, rx, stateful

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feat = str(tmp_path / "f.f32")
    np.zeros((24, 36), np.float32).tofile(feat)
    iq = str(tmp_path / "iq.f32")
    np.zeros(4000, np.complex64).tofile(iq)
    for make in (lambda: RADAE(flagship_config()),
                 lambda: inference.main(["random", feat, "/dev/null"]),
                 lambda: rx.main(["random", iq, "/dev/null"]),
                 lambda: loss.main([feat, feat]),
                 lambda: stateful.stateful_encoder(["random", feat]),
                 lambda: stateful.stateful_decoder(["random", feat])):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
