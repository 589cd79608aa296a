"""radae_tpu_torch: the PyTorch/CUDA port of radae_tpu.

The package imports torch and numpy only.  Its entry points take an explicit
`device` that defaults to "cuda" and raise when no card is present, unless
the caller asks for the CPU.  Submodules are imported on demand:

  config        modem geometry (numpy)
  convert       npz checkpoints -> torch parameter trees
  ops           split-complex modem math, pilot EQ, fused core kernels
  models        stateful core encoder/decoder, the RADAE model (forward
                with the simulated channel, the vanilla receiver)
  data          feature files, the training dataset
  parallel      the train step (autograd, Adam, LR decay), data parallel
                over a torch.distributed group
  runtime       batched streaming tx/rx serving steps
  dsp           the per-frame transmitter and receiver, BPF, acquisition
  apps          the per-frame product path: txe and rxe
  channel       fading samples (numpy), the simulated channel
  tools         the batch tools tx_batch and rx_batch, the file tools
                inference, rx, loss and stateful, train and evaluate
  __main__      `python -m radae_tpu_torch <tool>`
  bench         the serving benchmark (`python -m radae_tpu_torch.bench`),
                whose supervising process imports no torch: so neither
                does this file until resolve_device is called
"""


def resolve_device(device):
    """The torch.device an entry point runs on.

    A CUDA device is refused when no card is present: the port never
    falls back to the CPU on its own."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev
