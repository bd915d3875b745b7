"""Device mesh helpers.

The natural device decomposition of LZ4 is block-parallel: every frame
block in ``.independent`` mode is its own compression problem
(SURVEY.md section 2.5), so the canonical mesh is one dimension,
``('blocks',)``, laid over all devices.  The GPUs of one host reach
each other all to all, so the mesh follows the algorithm alone;
multi-host runs shard the corpus over hosts and blocks over each
host's devices.  There is no tensor/model axis -- the "model"
(hash/candidate machinery) is tiny and replicated.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def local_device_count() -> int:
    return jax.local_device_count()


def blocks_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D ('blocks',) mesh over the first n devices (default: all)."""
    devs = list(devices) if devices is not None else jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), ("blocks",))
