"""Command-line dispatcher: `python -m radae_tpu_torch <tool> [args...]`
(the table of `radae_tpu/__main__.py`, every tool's port).  A tool's module
is imported when it is called, not with this file."""

import sys

TOOLS = {
    "txe": ("radae_tpu_torch.apps.txe", "main"),
    "rxe": ("radae_tpu_torch.apps.rxe", "main"),
    "tx_batch": ("radae_tpu_torch.tools.tx_batch", "main"),
    "rx_batch": ("radae_tpu_torch.tools.rx_batch", "main"),
    "inference": ("radae_tpu_torch.tools.inference", "main"),
    "rx": ("radae_tpu_torch.tools.rx", "main"),
    "loss": ("radae_tpu_torch.tools.loss", "main"),
    "stateful_encoder": ("radae_tpu_torch.tools.stateful", "stateful_encoder"),
    "stateful_decoder": ("radae_tpu_torch.tools.stateful", "stateful_decoder"),
    "train": ("radae_tpu_torch.tools.train", "main"),
    "evaluate": ("radae_tpu_torch.tools.evaluate", "main"),
    "bbfm_inference": ("radae_tpu_torch.tools.bbfm", "bbfm_inference"),
    "bbfm_rx": ("radae_tpu_torch.tools.bbfm", "bbfm_rx"),
    "train_bbfm": ("radae_tpu_torch.tools.bbfm", "train_bbfm"),
    "sc_tx": ("radae_tpu_torch.tools.sc_modem", "sc_tx"),
    "sc_rx": ("radae_tpu_torch.tools.sc_modem", "sc_rx"),
    "ch": ("radae_tpu_torch.tools.ch", "main"),
    "wav": ("radae_tpu_torch.tools.wav_pipeline", "main"),
    "vocoder_nn": ("radae_tpu_torch.vocoder_nn", "main"),
    "est_snr": ("radae_tpu_torch.tools.est_snr", "main"),
    "est_cno": ("radae_tpu_torch.tools.chirp", "est_CNo_main"),
    "chirp": ("radae_tpu_torch.tools.chirp", "chirp_main"),
    "eoo_ber": ("radae_tpu_torch.tools.chirp", "eoo_ber_main"),
    "f32toint16": ("radae_tpu_torch.tools.converters", "f32toint16"),
    "int16tof32": ("radae_tpu_torch.tools.converters", "int16tof32"),
    "ml_pilots": ("radae_tpu_torch.tools.ml_pilots", "main"),
    "export": ("radae_tpu_torch.export", "main"),
    "ota": ("radae_tpu_torch.tools.ota", "main"),
    "ptt_loop": ("radae_tpu_torch.tools.ptt_loop", "main"),
    "webtx": ("radae_tpu_torch.tools.webtx", "main"),
    "report": ("radae_tpu_torch.tools.report", "main"),
    "plots": ("radae_tpu_torch.tools.plots", "main"),
    "profile": ("radae_tpu_torch.tools.profile", "main"),
}


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m radae_tpu_torch <tool> [args...]\n\ntools:")
        for name in sorted(TOOLS):
            print(f"  {name}")
        return 0
    name = sys.argv[1]
    if name not in TOOLS:
        print(f"unknown tool {name!r}; run with --help for the list",
              file=sys.stderr)
        return 2
    mod_name, fn_name = TOOLS[name]
    import importlib
    fn = getattr(importlib.import_module(mod_name), fn_name)
    return fn(sys.argv[2:]) or 0


if __name__ == "__main__":
    sys.exit(main())
