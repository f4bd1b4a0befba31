"""Test configuration: force a virtual 8-device CPU mesh before jax loads.

Multi-chip sharding logic is tested on a single host via
XLA's host-platform device-count override (see SURVEY.md §4).
"""

import os

# RABBITSALIGN_TEST_GPU=1 keeps the GPU visible so the tests marked `gpu`
# run on the card instead of skipping:
#   RABBITSALIGN_TEST_GPU=1 python -m pytest tests/ -m gpu
_use_gpu = os.environ.get("RABBITSALIGN_TEST_GPU", "") == "1"

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if not _use_gpu:
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")

import random

import numpy as np
import pytest


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise
    (decided at run time, never at import or collection)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {dev.platform}); run with "
                    "RABBITSALIGN_TEST_GPU=1 on the card")
    return dev


@pytest.fixture
def rng():
    random.seed(1234)
    np.random.seed(1234)
    return random


def random_dna(n: int, alphabet: str = "ACGT", seed=None) -> str:
    r = random.Random(seed) if seed is not None else random
    return "".join(r.choice(alphabet) for _ in range(n))
