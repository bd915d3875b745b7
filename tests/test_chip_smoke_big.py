"""chip_smoke.py's l12, big and linked phases at tiny sizes on the CPU,
and route counters on 4MB-block frames.

Every device-encoder program costs tens of seconds to compile on the
CPU, and pytest-xdist runs one file per worker, so the phases are split
over three files by the programs they share.  This file holds level
12, the 4MB-block programs and the linked stepper."""

import numpy as np
import pytest

import chip_smoke as cs
from zig_lz4_tpu import frame as lz4f
from zig_lz4_tpu.parallel import ShardedFrameCodec, blocks_mesh

PHASES = {
    "l12": lambda: cs.phase_frame(blocks_mesh(), 8 * 2048, level=12,
                                  block_size=2048, compare_blocks=0),
    "big": lambda: cs.phase_big(blocks_mesh(1), 300_000),
    "linked": lambda: cs.phase_linked(blocks_mesh(), 200_000),
}


@pytest.mark.parametrize("phase", list(PHASES))
def test_chip_smoke_phase_on_cpu(phase):
    st = PHASES[phase]()
    assert st["bytes_in"] > 0 and st["ratio"] > 1
    assert st["routes"].get("decode_device", 0) > 0, st["routes"]
    assert st["routes"].get("decode_host", 0) == 0, st["routes"]


def test_routes_4mb_frames_counted_where_they_go():
    """4MB blocks: an incompressible block is device-encoded and stored;
    a block whose payload exceeds every device fetch quantum decodes on
    the host, and the counter says so."""
    rng = np.random.default_rng(6)
    codec = ShardedFrameCodec(mesh=blocks_mesh(1),
                              block_size_id=lz4f.BlockSizeID.max4MB)
    noise = rng.integers(0, 256, 300_000, np.uint8).tobytes()
    assert codec.decompress_frame(codec.compress_frame(noise)) == noise
    assert dict(+codec.routes) == {"encode_device": 1, "decode_stored": 1}
    half = (rng.integers(0, 256, 3 << 20, np.uint8).tobytes()
            + bytes(1 << 20))
    frame = lz4f.compress_frame(half, lz4f.Preferences(
        frame_info=lz4f.FrameInfo(block_size_id=lz4f.BlockSizeID.max4MB,
                                  block_mode=lz4f.BlockMode.independent)))
    codec.routes.clear()
    assert codec.decompress_frame(frame) == half
    assert dict(+codec.routes) == {"decode_host": 1}
