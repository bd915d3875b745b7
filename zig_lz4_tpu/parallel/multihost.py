"""Multi-host frame compression (SURVEY.md section 2.5, config 5).

Design: the corpus is sharded across hosts in whole frame blocks
(64KB-4MB each).  Every host compresses its contiguous span of blocks
on its local devices via :class:`ShardedFrameCodec`'s encoder (blocks
data-parallel within the host), then the variable-length compressed
payloads are all-gathered across hosts in frame order and host 0 -- or
every host, identically -- serializes the spec-conformant frame.  A
shared dictionary, when given, is replicated to every host/device (the
broadcast analog of the reference's loadDict, src/lz4.zig:798).

Checksums: per-block xxHash32 checksums parallelize perfectly and are
used in multi-host mode; the whole-content checksum is a strictly
sequential xxh32 stream, so it is computed only when ``content_hash``
is requested (host-0 pass over the raw corpus) -- both layouts are
spec-conformant (the content checksum is an optional frame feature).

Single-process use works unchanged (process_count == 1); across
hosts call :func:`initialize` first (wraps
``jax.distributed.initialize``) so ``jax.devices()`` is the global
device set.
"""

from __future__ import annotations

import numpy as np

from .. import frame as lz4f
from ..constants import WINDOW_SIZE
from ..utils.xxhash32 import xxh32
from .sharded import ShardedFrameCodec, _UNCOMPRESSED_BIT

__all__ = ["initialize", "MultiHostFrameCodec"]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               initialization_timeout: int = 300) -> None:
    """Bring up the JAX distributed runtime (idempotent).

    After the runtime is up, one tiny all-gather runs immediately:
    the first cross-process collective performs the Gloo/backend
    rendezvous through the coordinator's key-value store, whose get
    carries a ~30s timeout -- if the first collective is instead
    reached after minutes of (skewed) JIT compilation, the EARLY
    process times out waiting for the late one (observed as
    ``GetKeyValue() timed out`` in ``process_allgather``).  Running
    the rendezvous here, while inter-process skew is milliseconds,
    makes later collectives independent of compile-time skew."""
    import jax
    try:
        jax.distributed.initialize(
            coordinator_address, num_processes, process_id,
            initialization_timeout=initialization_timeout)
    except RuntimeError:
        pass    # already initialized
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.process_allgather(np.zeros(1, np.int32))


def _process_info():
    import jax
    return jax.process_index(), jax.process_count()


def _allgather_bytes(payload: bytes):
    """All-gather one bytes blob per process; returns list[bytes] in
    process order.  Uses a padded uint8 all-gather over the global
    mesh."""
    import jax
    from jax.experimental import multihost_utils

    pid, pcount = _process_info()
    if pcount == 1:
        return [payload]
    # lengths first, then padded payloads
    lens = multihost_utils.process_allgather(
        np.array([len(payload)], np.int64))
    lens = np.asarray(lens).reshape(-1)
    # quantize the padded capacity so repeated gathers reuse compiled
    # shapes (each new shape is a fresh XLA compile on every host)
    cap = max(-(-int(lens.max()) // 65536) * 65536, 65536)
    buf = np.zeros(cap, np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, np.uint8)
    all_bufs = np.asarray(multihost_utils.process_allgather(buf))
    all_bufs = all_bufs.reshape(pcount, cap)
    return [all_bufs[p, :int(lens[p])].tobytes() for p in range(pcount)]


class MultiHostFrameCodec:
    """Corpus -> one LZ4 frame, blocks sharded host-major then
    device-parallel; compressed blocks all-gathered in frame order."""

    def __init__(self, block_size_id=lz4f.BlockSizeID.max64KB,
                 block_checksum: bool = True,
                 dictionary: bytes | None = None,
                 local_mesh=None, compression_level: int = 0,
                 decode_engine: str = "win"):
        self.bsid = lz4f.BlockSizeID(block_size_id)
        self.block_size = self.bsid.to_block_size()
        self.block_checksum = block_checksum
        self.dict = bytes(dictionary)[-WINDOW_SIZE:] if dictionary \
            else None
        if local_mesh is None:
            # each host drives its LOCAL devices only: the span split is
            # the cross-host parallelism, the mesh the within-host one
            # (a global mesh would make per-host device_puts disagree)
            import jax
            from jax.sharding import Mesh
            local_mesh = Mesh(np.array(jax.local_devices()), ("blocks",))
        self.local = ShardedFrameCodec(
            mesh=local_mesh, block_size_id=self.bsid,
            content_checksum=False, block_checksum=False,
            dictionary=self.dict, compression_level=compression_level,
            decode_engine=decode_engine)

    def _local_span(self, n_blocks: int):
        pid, pcount = _process_info()
        per = -(-n_blocks // pcount)
        lo = min(pid * per, n_blocks)
        hi = min(lo + per, n_blocks)
        return lo, hi

    def compress_corpus(self, data: bytes,
                        content_hash: bool = False) -> bytes:
        """Compress ``data`` (the full corpus, visible to every host --
        or at least its local span; only ``[lo*bs, hi*bs)`` is read)
        into one LZ4 frame.  Every host returns the identical frame."""
        data = bytes(data)
        bs = self.block_size
        n_blocks = max((len(data) + bs - 1) // bs, 0)
        lo, hi = self._local_span(n_blocks)

        # local device-parallel encode of this host's span
        records = bytearray()
        for b0 in range(lo, hi, 256):
            b1 = min(b0 + 256, hi)
            span = data[b0 * bs:b1 * bs]
            payloads = self.local._encode_span(span)
            for raw, comp in payloads:
                if len(comp) < len(raw):
                    stored, word = comp, len(comp)
                else:
                    stored, word = raw, len(raw) | _UNCOMPRESSED_BIT
                records += word.to_bytes(4, "little")
                records += stored
                if self.block_checksum:
                    records += xxh32(stored).to_bytes(4, "little")

        # ordered gather across hosts
        parts = _allgather_bytes(bytes(records))

        info = lz4f.FrameInfo(
            block_size_id=self.bsid,
            block_mode=lz4f.BlockMode.independent,
            content_checksum=content_hash,
            block_checksum=self.block_checksum,
            content_size=len(data))
        out = bytearray(lz4f.write_frame_header(info))
        for p in parts:
            out += p
        out += (0).to_bytes(4, "little")
        if content_hash:
            out += xxh32(data).to_bytes(4, "little")
        return bytes(out)

    def decompress_corpus(self, frame: bytes) -> bytes:
        """Multi-host parallel decode of an independent-mode frame.

        Every host scans the (cheap) block-record structure, decodes
        its host-major span of blocks on its local devices, and the
        decoded spans are all-gathered in process order; every
        host returns the identical corpus.  Content checksum /
        content size are verified on the assembled corpus.
        """
        frame = bytes(frame)
        info, pos = lz4f.parse_frame_header(frame)
        if info.block_mode == lz4f.BlockMode.linked or \
                info.frame_type == lz4f.FrameType.skippable_frame:
            # sequential dependency chain: host streaming decoder
            return lz4f.decompress_frame(frame,
                                         dictionary=self.dict or None)
        bs = info.block_size_id.to_block_size()

        # host scan: split frame into block records (all hosts run the
        # identical scan; it is cheap pointer walking)
        records = []
        while True:
            if pos + 4 > len(frame):
                raise lz4f.E.FrameSizeWrong("truncated block header")
            word = int.from_bytes(frame[pos:pos + 4], "little")
            pos += 4
            if word == 0:
                break
            uncompressed = bool(word & _UNCOMPRESSED_BIT)
            blen = word & ~_UNCOMPRESSED_BIT
            if pos + blen > len(frame):
                raise lz4f.E.FrameSizeWrong("truncated block payload")
            payload = frame[pos:pos + blen]
            pos += blen
            if info.block_checksum:
                expect = int.from_bytes(frame[pos:pos + 4], "little")
                pos += 4
                if xxh32(payload) != expect:
                    raise lz4f.E.BlockChecksumInvalid(
                        "block checksum mismatch")
            records.append((payload, uncompressed))

        lo, hi = self._local_span(len(records))
        span = self.local._decode_records(records[lo:hi], bs)
        parts = _allgather_bytes(b"".join(span))
        content = b"".join(parts)

        if info.content_checksum:
            if pos + 4 > len(frame):
                raise lz4f.E.FrameSizeWrong("missing content checksum")
            expect = int.from_bytes(frame[pos:pos + 4], "little")
            if xxh32(content) != expect:
                raise lz4f.E.ContentChecksumInvalid(
                    "content checksum mismatch")
        if info.content_size and len(content) != info.content_size:
            raise lz4f.E.FrameSizeWrong(
                f"content size {info.content_size} != {len(content)}")
        return content
