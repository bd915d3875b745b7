"""chip_smoke.py's level-0 phases (fast, dict, cli) at tiny sizes on the
virtual CPU mesh, and route counters on a 64KB-block frame.

Every device-encoder program costs tens of seconds to compile on the
CPU, and pytest-xdist runs one file per worker, so the phases are split
over three files by the programs they share.  This file's cases share
one level-0 program with a 64KB window; the dictionary case reaches it
with a 1KB dictionary and 63KB blocks."""

import numpy as np
import pytest

import chip_smoke as cs
from zig_lz4_tpu import frame as lz4f
from zig_lz4_tpu.parallel import ShardedFrameCodec, blocks_mesh

PHASES = {
    "fast": lambda: cs.phase_frame(blocks_mesh(), 8 * 65536, level=0,
                                   compare_blocks=0),
    "dict": lambda: cs.phase_dict(blocks_mesh(), 8 * 64512, dict_size=1024,
                                  block_size=64512),
    "cli": lambda: cs.phase_cli(100_000, level=1),
}


@pytest.mark.parametrize("phase", list(PHASES))
def test_chip_smoke_phase_on_cpu(phase):
    st = PHASES[phase]()
    assert st["bytes_in"] > 0 and st["ratio"] > 1
    assert st["routes"].get("decode_device", 0) > 0, st["routes"]
    assert st["routes"].get("decode_host", 0) == 0, st["routes"]


def test_routes_64k_frame_all_on_device():
    """A 64KB-block frame: device encode and decode carry every block,
    store-uncompressed records are counted apart, the host carries
    none."""
    rng = np.random.default_rng(5)
    text = b"".join(b"record %d of the route test; " % i
                    for i in range(8000))[:3 * 65536]
    data = (text[:65536] + rng.integers(0, 256, 65536, np.uint8).tobytes()
            + text[65536:])
    frame = lz4f.compress_frame(data, lz4f.Preferences(
        frame_info=lz4f.FrameInfo(block_mode=lz4f.BlockMode.independent)))
    codec = ShardedFrameCodec(mesh=blocks_mesh())
    assert codec.decompress_frame(frame) == data
    assert dict(+codec.routes) == {"decode_device": 3, "decode_stored": 1}
    codec.routes.clear()
    assert codec.decompress_frame(codec.compress_frame(data)) == data
    assert codec.routes["encode_device"] == 4
    assert codec.routes["encode_host"] == codec.routes["decode_host"] == 0
