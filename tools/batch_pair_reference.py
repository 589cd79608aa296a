#!/usr/bin/env python3
"""chip_smoke.py's JAX_PAIR_0_3: streams 0-3 of its batch serving pair
through radae_tpu on the CPU.

    JAX_PLATFORMS=cpu python3 tools/batch_pair_reference.py

The same inputs as chip_smoke.py's phase 4, for the first 4 streams: the
fixture's features (chip_smoke.stream_features), 20 frames through
radae_tpu's make_streaming_tx_step with the int8 encoder kernel
(fused_quant="int8", Pallas in interpret mode), the end-of-over frame
appended, chip_smoke.pair_channel, then radae_tpu's make_batched_receiver
(n_windows=12, refine=True, eoo=True, fused=True, fused_quant="int8", the
decoder kernel in interpret mode).  Prints, per stream, the acquisition
(tmax, fmax, win, eoo_frame) and the distortion loss of the frames decoded
before the EOO (chip_smoke.pair_losses), and the constant to paste.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

N = 4


def main() -> int:
    import jax
    import jax.numpy as jnp
    from radae_tpu.config import flagship_config
    from radae_tpu.convert import load_checkpoint
    from radae_tpu.models.core import CoreDecoder, CoreEncoder, distortion_loss
    from radae_tpu.ops import fused_core as jfc
    from radae_tpu.runtime import make_batched_receiver, make_streaming_tx_step

    cfg = flagship_config()
    tree, _ = load_checkpoint(os.path.join(ROOT, "fixtures",
                                           "model_fs_flagship.npz"))
    raw = np.fromfile(os.path.join(ROOT, "fixtures", "speech_feats.f32"),
                      np.float32).reshape(-1, 36)
    feats = cs.stream_features(raw, N, cs.N_FRAMES, cfg.feature_dim)
    for name in ("make_fused_encoder_step", "make_fused_decoder_step"):
        orig = getattr(jfc, name)
        setattr(jfc, name, lambda *a, _o=orig, **k: _o(*a, **{**k,
                                                             "interpret": True}))
    tx = make_streaming_tx_step(cfg, CoreEncoder(21, 80, 3), N, fused=True,
                                fused_tile=N, fused_quant="int8")
    w = tuple(jax.device_put(a) for a in jfc.encoder_weights(
        tree["encoder"], quant="int8"))
    st, iq = jfc.encoder_state_zero(N), []
    for k in range(cs.N_FRAMES):
        s, st = tx(w, feats[:, 12 * k:12 * (k + 1)], st)
        iq.append(np.asarray(s))
    eoo = cfg.eoo.flatten().astype(np.complex64)
    eoo = np.broadcast_to(np.stack([eoo.real, eoo.imag], -1), (N, len(eoo), 2))
    over = np.concatenate(iq + [eoo], axis=1).astype(np.float32)
    buf = cs.pair_channel(over, cfg, cs.pair_buffer_len(cfg, cs.N_FRAMES))

    rx = make_batched_receiver(cfg, CoreDecoder(80, 21), N, cs.N_FRAMES,
                               n_windows=cs.PAIR_WINDOWS, refine=True,
                               eoo=True, fused=True, fused_tile=N,
                               fused_quant="int8")
    out = rx(tuple(jfc.decoder_weights(tree["decoder"], quant="int8")),
             jnp.asarray(buf))
    out = {k: np.asarray(v) for k, v in out.items()}
    loss = cs.pair_losses(lambda a, b: np.asarray(distortion_loss(a, b)),
                          feats, out["features"], out["win"], cs.N_FRAMES)
    for b in range(N):
        print(f"stream {b}: acquired {bool(out['candidate'][b])} tmax "
              f"{int(out['tmax'][b])} fmax {float(out['fmax'][b])} win "
              f"{int(out['win'][b])} eoo_frame {int(out['eoo_frame'][b])} "
              f"loss {loss[b]:.8g}")
    const = {"tmax": [int(x) for x in out["tmax"]],
             "fmax": [float(x) for x in out["fmax"]],
             "loss": [float(f"{x:.8g}") for x in loss]}
    print(f"JAX_PAIR_0_3 = {const}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
