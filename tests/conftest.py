"""Test config: JAX on an 8-device virtual CPU mesh by default.

The platform comes from JAX_PLATFORMS (the tier-1 command sets
``cpu``). What needs a GPU is checked by chip_smoke.py on the card.
"""

import jax

jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)
