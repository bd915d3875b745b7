"""Test configuration.

Tests run JAX on a virtual 8-device CPU mesh so multi-device sharding
paths (shard_map over a ('blocks',) mesh) are exercised without an
accelerator.  Must be set before JAX initializes.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and skip
elsewhere.  On a card, run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``;
``python chip_smoke.py`` runs the same checks.
"""

import os
import random
import sys

# chip_smoke.py and bench.py live at the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# Tests run on a virtual 8-device CPU mesh unless JAX_PLATFORMS says
# otherwise (the gpu-marked tests); jax.config is set again after
# import in case JAX was configured before this file ran.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere; decided "
        "in the gpu_devices fixture, never at import)")


@pytest.fixture(scope="session")
def gpu_devices():
    """The GPU devices JAX sees; skips the test when there are none
    (always under the default JAX_PLATFORMS=cpu)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("no NVIDIA GPU: run `python chip_smoke.py` on the card")
    return devs


@pytest.fixture(scope="session")
def corpus():
    """Deterministic fixture corpus mirroring the reference compat suite.

    reference: src/test_compat.zig:25-57 (TestData.init): short string,
    1000B of 8-byte repeats, lorem text, seeded random, empty, byte ramp.
    """
    rng = random.Random(0x5EED)
    lorem = (b"Lorem ipsum dolor sit amet, consectetur adipiscing elit, "
             b"sed do eiusmod tempor incididunt ut labore et dolore magna "
             b"aliqua. Ut enim ad minim veniam, quis nostrud exercitation "
             b"ullamco laboris nisi ut aliquip ex ea commodo consequat. ")
    return {
        "hello": b"Hello World!",
        "repeated": b"ABCDEFGH" * 125,                       # 1000 bytes
        "lorem": lorem * 40,
        "random256": bytes(rng.randrange(256) for _ in range(256)),
        "empty": b"",
        "ramp": bytes(i & 0xFF for i in range(100_000)),
        "tiny": b"abc",
        "rle": b"a" * 10_000,
        "mixed": (lorem + bytes(rng.randrange(256) for _ in range(333))) * 30,
    }
