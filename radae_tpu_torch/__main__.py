"""Command-line dispatcher: `python -m radae_tpu_torch <tool> [args...]`
(the tools the port has, in the form of `radae_tpu/__main__.py`)."""

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
