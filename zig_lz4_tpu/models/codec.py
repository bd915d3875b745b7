"""Codec model families -- the user-facing "models" of this framework.

The reference exposes three encoder families behind one compressHC
entry point plus the fast path (reference: src/lz4hc.zig:59-97 level
table; src/lz4.zig:292 fast).  Here each family is a small model class
with a uniform interface so pipelines (frame layer, sharded codec,
benchmarks) can treat them interchangeably:

  * FastCodec  -- greedy hash-table matcher (levels <= 0;
                  acceleration = 1 - level).  Host: C++ native/oracle.
  * HCCodec    -- MID / hash-chain / optimal strategies (levels 2-12).
  * DeviceCodec -- the vectorized XLA codec (ops/jax_block): the
                  flagship family, one block per vmap lane.

All families emit interchangeable LZ4 block bytes; any decoder decodes
any family's output.
"""

from __future__ import annotations

from .. import backend
from ..constants import compress_bound
from ..ops import hc as _hc

__all__ = ["BlockCodec", "FastCodec", "HCCodec", "DeviceCodec", "get_codec"]


class BlockCodec:
    """Uniform block-codec interface."""

    level: int = 0

    def compress(self, data: bytes, max_output: int | None = None) -> bytes:
        raise NotImplementedError

    def decompress(self, comp: bytes, max_output_size: int) -> bytes:
        return backend.decompress_safe(comp, max_output_size)


class FastCodec(BlockCodec):
    """reference: src/lz4.zig:283-447."""

    def __init__(self, acceleration: int = 1):
        self.acceleration = acceleration
        self.level = 1 - acceleration

    def compress(self, data, max_output=None):
        return backend.compress_fast(data, self.acceleration, max_output)


class HCCodec(BlockCodec):
    """reference: src/lz4hc.zig:1440-1494."""

    def __init__(self, level: int = _hc.LZ4HC_CLEVEL_DEFAULT):
        self.level = level

    def compress(self, data, max_output=None):
        return _hc.compress_hc(data, self.level, max_output=max_output)


class DeviceCodec(BlockCodec):
    """Vectorized XLA block codec; one device call per compress.

    ``level`` <= 1 selects the fast finder; 2..12 the HC-class
    suffix-order finder (deeper candidate probes + lazy deferral,
    same wire format).  For bulk work use the batched entry points in
    ops/jax_block or the ShardedFrameCodec pipeline -- this class is
    the single-block convenience wrapper.
    """

    def __init__(self, block_capacity: int = 65536, level: int = 1):
        self.block_capacity = block_capacity
        self.level = level

    def compress(self, data, max_output=None):
        import numpy as np
        from ..errors import OutputTooSmall
        from ..ops.jax_block import level_params, make_block_encoder
        data = bytes(data)
        if len(data) > self.block_capacity:
            raise ValueError(
                f"block {len(data)} exceeds capacity {self.block_capacity}")
        buf = np.zeros(self.block_capacity, np.uint8)
        buf[:len(data)] = np.frombuffer(data, np.uint8)
        out, n = make_block_encoder(self.block_capacity,
                                    *level_params(self.level))(
            buf, np.int32(len(data)))
        comp = bytes(np.asarray(out)[:int(n)])
        if max_output is not None and len(comp) > max_output:
            raise OutputTooSmall(f"{len(comp)} > {max_output}")
        return comp

    def decompress(self, comp, max_output_size):
        import numpy as np
        from ..ops.jax_block import (MAX_SEQS, make_block_decoder,
                                     parse_sequences, seqs_to_arrays)
        comp = bytes(comp)
        ccap = compress_bound(self.block_capacity)
        buf = np.zeros(ccap, np.uint8)
        buf[:len(comp)] = np.frombuffer(comp, np.uint8)
        lit, lsrc, ml, off, ns = seqs_to_arrays(
            parse_sequences(comp), MAX_SEQS(self.block_capacity))
        out, n = make_block_decoder(self.block_capacity)(
            buf, lit, lsrc, ml, off, ns)
        res = bytes(np.asarray(out)[:int(n)])
        if len(res) > max_output_size:
            from ..errors import OutputTooSmall
            raise OutputTooSmall(f"{len(res)} > {max_output_size}")
        return res


def get_codec(level: int | str = 0) -> BlockCodec:
    """Level dispatch mirroring the frame layer's rules
    (reference: src/lz4f.zig:393-404): <= 0 fast, >= 1 HC; "device"
    (optionally with a level, "device9") for the vectorized family."""
    if isinstance(level, str) and level.startswith("device"):
        return DeviceCodec(level=int(level[6:] or 1))
    level = int(level)
    if level <= 0:
        return FastCodec(1 - level)
    return HCCodec(level)
