"""Multi-host frame layer (single-process path; the process-allgather
degenerates to identity, the rest of the pipeline -- host-major block
spans, local device-parallel encode, ordered gather, frame
serialization -- is identical to a multi-host run)."""

import random

import pytest

from zig_lz4_tpu import frame as lz4f
from zig_lz4_tpu.parallel.multihost import MultiHostFrameCodec


def _corpus(n):
    rng = random.Random(77)
    words = b"multi host pod slice dictionary broadcast gather ".split()
    out = bytearray()
    while len(out) < n:
        r = rng.random()
        if r < 0.6:
            out += rng.choice(words) + b" "
        else:
            out += bytes(rng.randrange(256) for _ in range(rng.randrange(30)))
    return bytes(out[:n])


@pytest.fixture(scope="module")
def codec():
    c = MultiHostFrameCodec(block_checksum=True)
    c.block_size = 4096          # small blocks: fast CPU-mesh compiles
    c.local.block_size = 4096
    c.local.window = 4096
    return c


def test_multihost_frame_roundtrip(codec):
    data = _corpus(30_000)
    frame = codec.compress_corpus(data)
    assert lz4f.decompress_frame(frame) == data


def test_multihost_content_hash(codec):
    data = _corpus(12_000)
    frame = codec.compress_corpus(data, content_hash=True)
    assert lz4f.decompress_frame(frame) == data
    bad = bytearray(frame)
    bad[len(bad) // 2] ^= 1
    with pytest.raises(Exception):
        lz4f.decompress_frame(bytes(bad))


def test_multihost_block_checksums_verified(codec):
    data = _corpus(9_000)
    frame = codec.compress_corpus(data)
    info = lz4f.get_frame_info(frame)
    assert info.block_checksum
