"""The port's modem constants equal radae_tpu's (radae_tpu_torch/config.py)."""

import numpy as np
import pytest

from radae_tpu.config import flagship_config as jax_flagship_config
from radae_tpu_torch.config import flagship_config

CONSTANTS = ["M", "Ncp", "Nc", "Nmf", "Winv", "Wfwd", "P", "pend", "eoo",
             "pilot_gain", "w"]


@pytest.mark.parametrize("overrides", [{}, {"latent_dim": 40}],
                         ids=["flagship", "latent40"])
@pytest.mark.parametrize("name", CONSTANTS)
def test_derived_constant_matches_jax(name, overrides):
    ours = getattr(flagship_config(**overrides), name)
    ref = getattr(jax_flagship_config(**overrides), name)
    assert np.asarray(ours).dtype == np.asarray(ref).dtype
    np.testing.assert_array_equal(ours, ref)
