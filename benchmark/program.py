"""The program's configuration object, made from a configuration file."""

from __future__ import annotations

# the file's keys that are RADAEConfig fields, as the deployed waveform
# sets them (radae_txe.py, radae_rxe.py)
PROGRAM_KEYS = ("feature_dim", "latent_dim", "bottleneck", "rate_Fs",
                "pilots", "pilot_eq", "eq_mean6", "cyclic_prefix",
                "coarse_mag", "time_offset")
# the modem numbers the file states and the program derives
GEOMETRY = ("Fs", "M", "Ncp", "Ns", "Nc", "carrier_1_index")


def program_config(cfg):
    """The port's RADAEConfig for a configuration file; raises where the
    geometry it derives is not the one the file states (and the
    reference runs)."""
    from radae_tpu_torch.config import RADAEConfig

    pc = RADAEConfig(**{k: cfg[k] for k in PROGRAM_KEYS})
    bad = {k: (getattr(pc, k), cfg[k]) for k in GEOMETRY
           if getattr(pc, k) != cfg[k]}
    if bad:
        raise ValueError(f"the program derives another modem geometry "
                         f"(program, file): {bad}")
    return pc
