"""Sharded frame compression/decompression over a ('blocks',) mesh.

The device frame pipeline (SURVEY.md section 2.5):

  compress:  chunk corpus -> [B, blk] block matrix sharded over the
             mesh -> per-device vectorized encode (ops/jax_block) with
             the dictionary broadcast (replicated) to every device ->
             ordered host gather of (payload, length) -> wire-format
             frame assembly on the host (C++ native checksums).

  decompress: host splits the frame into block payloads and resolves
             each into a per-byte literal-source map (T-map, native
             runtime) -> [B, ...] arrays sharded over the mesh -> one
             parity-keyed device merge per block -> ordered gather ->
             checksum verification.

Block-independent frames shard freely; linked frames have a sequential
64KB dependency chain, which the host resolves structurally so the
device decodes whole windows of blocks at a time (reference cannot
decode them at all -- SURVEY.md section 2.3).

Multi-host: parallel/multihost.py runs this codec on each host's local
devices and gathers the compressed spans in frame order.

Every codec counts the blocks each route carried in ``routes``, so a
caller can check that the device did the work.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import errors as E
from .. import frame as lz4f
from ..constants import WINDOW_SIZE, compress_bound
from ..ops.jax_block import (MAX_SEQS, _decode_block, _encode_block,
                             device_encoder_supports,
                             device_frag_decoder_supports, level_params)
from ..utils.xxhash32 import xxh32, xxh32_stream
from .mesh import blocks_mesh

__all__ = ["ShardedFrameCodec"]

_UNCOMPRESSED_BIT = 0x80000000
#: fragment-decoder tiers: (fcap divisor of block size, max rounds).
#: Most blocks fit the cheap tier; match-dense blocks go to wider /
#: deeper tiers; the rest fall back to the host codec.  The resolver's
#: split_max trades fragment count against round depth.  The deep
#: (bs, 12-round) tier runs only on multi-device meshes.
_FRAG_TIERS = ((8, 2), (4, 8), (1, 12))
#: narrow-fcap fallback ladder for BIG blocks (1MB/4MB), used when no
#: standard tier's pack geometry fits: at a QUANTIZED fetch buffer
#: (payload <= bs/2) the chase engine's int32 packs cover bs/64 and
#: bs/256 fragment budgets even at 4MB windows, so compressible big
#: blocks decode on-device; incompressible ones stay host-side
#: (reference block sizes: lz4f.zig:71-78).
_FRAG_TIERS_BIG = ((64, 12), (256, 12))
_FRAG_SPLIT_MAX = 8
_FRAG_RMAX = _FRAG_TIERS[-1][1]
#: chase-engine tiers: (fcap divisor of block size, max chain depth).
#: The pointer-doubling decoder reaches depth 2^(dense+doublings) at a
#: fixed merge count, so the resolver keeps natural chains
#: (round_limit=64) instead of splitting matches to bound rounds.
#: Coverage of 64KB device streams under this resolve: HC-9 blocks
#: 100% at fcap=bs/2, fast blocks 100% at fcap=bs, depth <= 64 for
#: both (bench corpus).  The trailing
#: narrow (bs/32) tier never fires at 64KB (earlier tiers take
#: everything first) -- it exists for 1MB blocks, where only the
#: bs/32 pack geometry fits int32 and highly-compressible blocks
#: (nfrag <= 32K) gain a device path the linear engines never had.
_CHASE_TIERS = ((4, 16), (2, 64), (1, 64), (32, 64))
_CHASE_RMAX = 64
#: device big-window encode (1MB/4MB frame blocks, whose emission
#: pack geometry exceeds int32 -- ops/jax_block.device_encoder_supports):
#: each block encodes as independent _SUB-byte sub-spans carrying
#: their last-64KB history prefix IN-window (start = history length),
#: and the per-sub streams stitch into ONE spec-conformant block
#: stream (ops/block.concat_streams).  Matches cross sub-span
#: emission boundaries through the history operand, so the only
#: ratio cost vs a monolithic encode is the per-boundary sequence
#: split (~3 bytes per 256KB).  reference block sizes: lz4f.zig:71-78.
_SUB = 262144
_SUBH = 65536


def _chase_config(depth: int) -> tuple[int, int, int]:
    """(dense, doublings, qcap) reaching 2^(dense+dbl) >= ``depth``.

    Frontier statistics of HC-9 streams of the bench corpus: every
    block converges within 5 doublings, and after 4 dense rounds the
    worst frontier is ~1.1K bytes -- so depth <= 32 runs PURE-DENSE
    (no pool machinery, no scatter), and deeper budgets add pool
    rounds that in practice fire once with a 4K pool.  (The naive
    dense=2 + blk/8 pool would overflow on 12.5% of blocks --
    match-dense streams still carry ~40K unconverged bytes at that
    point.)  The budget rounds UP: a 12-round resolve needs depth 16,
    not 8 (at depth 8 1.6% of deep-tier blocks fail self-validation
    and reroute)."""
    e = max((depth - 1).bit_length(), 1)    # 2^e >= depth
    dense = min(e, 5)
    dbl = e - dense
    return dense, dbl, 4096 if dbl else 0


@functools.lru_cache(maxsize=None)
def _sharded_encoder(mesh: Mesh, window: int, hc: int = 0,
                     deep: int = 0):
    """jit-compiled batched encoder with block-sharded in/out specs."""
    fn = jax.vmap(functools.partial(_encode_block, blk=window, hc=hc,
                                    deep=deep))
    shard = NamedSharding(mesh, P("blocks"))
    shard2 = NamedSharding(mesh, P("blocks", None))
    return jax.jit(fn, in_shardings=(shard2, shard, shard),
                   out_shardings=(shard2, shard))


@functools.lru_cache(maxsize=None)
def _sharded_decoder(mesh: Mesh, blk: int, ccap: int, nseq_cap: int,
                     hcap: int):
    fn = jax.vmap(functools.partial(_decode_block, blk=blk,
                                    nseq_cap=nseq_cap, hcap=hcap),
                  in_axes=(0, None, 0, 0, 0, 0, 0))
    s1 = NamedSharding(mesh, P("blocks"))
    s2 = NamedSharding(mesh, P("blocks", None))
    # the history window is broadcast (replicated) to every device
    sh = NamedSharding(mesh, P(None))
    return jax.jit(fn, in_shardings=(s2, sh, s2, s2, s2, s2, s1),
                   out_shardings=(s2, s1))


def _native_missing():
    from ..native import unavailable_reason
    raise RuntimeError("device decode needs the native host library: "
                       f"{unavailable_reason()}")


def _parse_block(payload: bytes, nseq_cap: int, history_len: int = 0):
    """Sequence parse via the native runtime, Python fallback."""
    from ..native import native_parse_sequences
    r = native_parse_sequences(payload, nseq_cap, history_len)
    if r is not None:
        return r
    from ..ops.jax_block import parse_sequences, seqs_to_arrays
    return seqs_to_arrays(parse_sequences(payload, history_len), nseq_cap)


class ShardedFrameCodec:
    """Data-parallel LZ4 frame codec over a device mesh.

    Produces spec-conformant frames in ``independent`` block mode
    (the parallel fast path); decodes independent frames in parallel
    and linked frames window by window on the device.

    ``routes`` counts the blocks each route carried since construction:
    ``encode_device`` / ``encode_host``, ``decode_device`` /
    ``decode_host``, and ``decode_stored`` for store-uncompressed
    records, which are copied as they are.
    """

    def __init__(self, mesh: Mesh | None = None,
                 block_size_id: lz4f.BlockSizeID = lz4f.BlockSizeID.max64KB,
                 content_checksum: bool = True,
                 block_checksum: bool = False,
                 dictionary: bytes | None = None,
                 dict_id: int = 0,
                 compression_level: int = 0,
                 decode_engine: str = "tmap"):
        #: levels <= 1 use the fast device finder; 2..12 the HC-class
        #: suffix-order finder (ops/jax_block hc mode) -- same wire
        #: format, better ratio, decodable by any LZ4 decoder
        self.level = int(compression_level)
        #: decode engine: "tmap" (default) = host per-byte
        #: literal-source maps (native lz4tpu_resolve_tmap: full path
        #: compression) + ONE parity-keyed device merge per block --
        #: no rounds, no tiers, 100% coverage.  "mixed" = the
        #: fragment ladder (windowed merges on the 2-round tier,
        #: pointer-doubling chase deeper); "win" / "chase" force one
        #: fragment engine everywhere ("chase" also switches to the
        #: natural-chain resolve with its 100%-coverage single tier).
        if decode_engine not in ("tmap", "win", "chase", "mixed"):
            raise ValueError(f"unknown decode_engine {decode_engine!r}")
        self.decode_engine = decode_engine
        self.routes: collections.Counter[str] = collections.Counter()
        self.hc, self.deep = level_params(self.level)
        self.mesh = mesh or blocks_mesh()
        self.n_devices = self.mesh.devices.size
        self.block_size = lz4f.BlockSizeID(block_size_id).to_block_size()
        self.dict = bytes(dictionary)[-WINDOW_SIZE:] if dictionary else b""
        self.dcap = len(self.dict)
        self.window = self.dcap + self.block_size
        self.info = lz4f.FrameInfo(
            block_size_id=lz4f.BlockSizeID(block_size_id),
            block_mode=lz4f.BlockMode.independent,
            content_checksum=content_checksum,
            block_checksum=block_checksum,
            dict_id=dict_id if dictionary else 0)

    # -- compression ----------------------------------------------------

    def _encode_batch(self, windows: np.ndarray, lens: np.ndarray,
                      starts: np.ndarray):
        enc = _sharded_encoder(self.mesh, self.window, self.hc,
                               self.deep)
        shard = NamedSharding(self.mesh, P("blocks"))
        shard2 = NamedSharding(self.mesh, P("blocks", None))
        w = jax.device_put(windows, shard2)
        l = jax.device_put(lens, shard)
        s = jax.device_put(starts, shard)
        out, out_len = enc(w, l, s)
        return np.asarray(out), np.asarray(out_len)   # ordered gather

    def _device_big_capable(self) -> bool:
        return (self.block_size > _SUB
                and device_encoder_supports(_SUBH + _SUB))

    def _encode_raws_big(self, raws: list[bytes]) -> list[bytes]:
        """Device encode of blocks beyond the one-window pack
        geometry: split each into _SUB-byte sub-spans with their 64KB
        history prefix in-window, batch-encode every sub-window on
        the mesh, stitch per block (see _SUB note above)."""
        from ..ops.block import concat_streams
        subw = _SUBH + _SUB
        entries = []                     # (block idx, history, span)
        for bi, raw in enumerate(raws):
            for s0 in range(0, max(len(raw), 1), _SUB):
                hist = self.dict if s0 == 0 else \
                    raw[max(s0 - _SUBH, 0):s0]
                entries.append((bi, hist, raw[s0:s0 + _SUB]))
        batch = max(self.n_devices * 4, self.n_devices)
        payloads: list[bytes] = []
        for c0 in range(0, len(entries), batch):
            group = entries[c0:c0 + batch]
            nb_pad = batch if c0 + batch <= len(entries) else \
                -(-len(group) // self.n_devices) * self.n_devices
            windows = np.zeros((nb_pad, subw), np.uint8)
            lens = np.zeros(nb_pad, np.int32)
            starts = np.zeros(nb_pad, np.int32)
            for k, (_bi, hist, span) in enumerate(group):
                hl = len(hist)
                if hl:
                    windows[k, :hl] = np.frombuffer(hist, np.uint8)
                windows[k, hl:hl + len(span)] = \
                    np.frombuffer(span, np.uint8)
                lens[k] = hl + len(span)
                starts[k] = hl
            enc = _sharded_encoder(self.mesh, subw, self.hc, self.deep)
            shard = NamedSharding(self.mesh, P("blocks"))
            shard2 = NamedSharding(self.mesh, P("blocks", None))
            out, olen = enc(jax.device_put(windows, shard2),
                            jax.device_put(lens, shard),
                            jax.device_put(starts, shard))
            out, olen = np.asarray(out), np.asarray(olen)
            payloads += [out[k, :int(olen[k])].tobytes()
                         for k in range(len(group))]
        per_block: list[list[bytes]] = [[] for _ in raws]
        for (bi, _h, _s), p in zip(entries, payloads):
            per_block[bi].append(p)
        self.routes["encode_device"] += len(raws)
        return [concat_streams(ps) for ps in per_block]

    def _encode_span(self, span: bytes) -> list[tuple[bytes, bytes]]:
        """Chip-parallel encode of a contiguous byte span into
        per-block (raw, compressed) pairs -- the multi-host layer's
        local building block."""
        bs = self.block_size
        nb = max((len(span) + bs - 1) // bs, 0)
        if nb == 0:
            return []
        if not device_encoder_supports(self.window):
            raws = [span[k * bs:(k + 1) * bs] for k in range(nb)]
            if self._device_big_capable():
                return list(zip(raws, self._encode_raws_big(raws)))
            # host codec fallback (native batched when available)
            from ..ops import hc as hc_mod
            from ..ops.block import compress_fast
            comps = [hc_mod.compress_hc(r, self.level) if self.level > 1
                     else compress_fast(r) for r in raws]
            self.routes["encode_host"] += nb
            return list(zip(raws, comps))
        nb_pad = -(-nb // self.n_devices) * self.n_devices
        windows = np.zeros((nb_pad, self.window), np.uint8)
        lens = np.full(nb_pad, self.dcap, np.int32)
        starts = np.full(nb_pad, self.dcap, np.int32)
        dict_arr = np.frombuffer(self.dict, np.uint8) if self.dcap \
            else None
        raws = []
        for k in range(nb):
            blkdata = span[k * bs:(k + 1) * bs]
            raws.append(blkdata)
            if self.dcap:
                windows[k, :self.dcap] = dict_arr
            windows[k, self.dcap:self.dcap + len(blkdata)] = \
                np.frombuffer(blkdata, np.uint8)
            lens[k] = self.dcap + len(blkdata)
        payloads, plens = self._encode_batch(windows, lens, starts)
        self.routes["encode_device"] += nb
        return [(raws[k], payloads[k, :int(plens[k])].tobytes())
                for k in range(nb)]

    def compress_frame(self, data: bytes,
                       batch_blocks: int | None = None) -> bytes:
        """Compress ``data`` into one LZ4 frame, blocks in parallel.

        Windows beyond the device encoder's pack geometry (4MB block
        size) route to the host frame layer -- same wire output."""
        data = bytes(data)
        # declare the (known) content size so decoders can verify the
        # round-trip (reference FLG bit 3, lz4f.zig:106-122)
        info = dataclasses.replace(self.info, content_size=len(data))
        if not device_encoder_supports(self.window):
            if self._device_big_capable():
                return self._compress_frame_big(data, info)
            prefs = lz4f.Preferences(frame_info=info)
            self.routes["encode_host"] += -(-len(data) // self.block_size)
            return lz4f.compress_frame(data, prefs,
                                       dictionary=self.dict or None)
        bs = self.block_size
        n_blocks = max((len(data) + bs - 1) // bs, 0)
        out = bytearray(lz4f.write_frame_header(info))
        chash = xxh32_stream() if self.info.content_checksum else None
        if chash is not None and data:
            chash.update(data)

        # batch granularity: a multiple of the mesh size
        batch = batch_blocks or self.n_devices * 8
        batch = max((batch // self.n_devices) * self.n_devices,
                    self.n_devices)

        dict_arr = np.frombuffer(self.dict, np.uint8)
        for b0 in range(0, n_blocks, batch):
            nb = min(batch, n_blocks - b0)
            nb_pad = -(-nb // self.n_devices) * self.n_devices
            windows = np.zeros((nb_pad, self.window), np.uint8)
            lens = np.zeros(nb_pad, np.int32)
            starts = np.full(nb_pad, self.dcap, np.int32)
            raws = []
            for k in range(nb):
                blkdata = data[(b0 + k) * bs:(b0 + k + 1) * bs]
                raws.append(blkdata)
                if self.dcap:
                    windows[k, :self.dcap] = dict_arr
                windows[k, self.dcap:self.dcap + len(blkdata)] = \
                    np.frombuffer(blkdata, np.uint8)
                lens[k] = self.dcap + len(blkdata)
            # unused pad rows: n == start -> zero-length output
            lens[nb:] = self.dcap
            payloads, plens = self._encode_batch(windows, lens, starts)
            self.routes["encode_device"] += nb
            for k in range(nb):
                raw = raws[k]
                comp = payloads[k, :int(plens[k])].tobytes()
                if len(comp) < len(raw):
                    stored, word = comp, len(comp)
                else:   # store-uncompressed fallback (lz4f.zig:407-418)
                    stored, word = raw, len(raw) | _UNCOMPRESSED_BIT
                out += word.to_bytes(4, "little")
                out += stored
                if self.info.block_checksum:
                    out += xxh32(stored).to_bytes(4, "little")

        out += (0).to_bytes(4, "little")
        if chash is not None:
            out += chash.digest().to_bytes(4, "little")
        return bytes(out)

    def _compress_frame_big(self, data: bytes, info) -> bytes:
        """Frame assembly for 1MB/4MB blocks via the sub-span device
        encoder (same wire output as the main path)."""
        bs = self.block_size
        n_blocks = max((len(data) + bs - 1) // bs, 0)
        out = bytearray(lz4f.write_frame_header(info))
        chash = xxh32_stream() if self.info.content_checksum else None
        if chash is not None and data:
            chash.update(data)
        batch = max(self.n_devices, 4)
        for b0 in range(0, n_blocks, batch):
            raws = [data[(b0 + k) * bs:(b0 + k + 1) * bs]
                    for k in range(min(batch, n_blocks - b0))]
            comps = self._encode_raws_big(raws)
            for raw, comp in zip(raws, comps):
                if len(comp) < len(raw):
                    stored, word = comp, len(comp)
                else:   # store-uncompressed fallback (lz4f.zig:407-418)
                    stored, word = raw, len(raw) | _UNCOMPRESSED_BIT
                out += word.to_bytes(4, "little")
                out += stored
                if self.info.block_checksum:
                    out += xxh32(stored).to_bytes(4, "little")
        out += (0).to_bytes(4, "little")
        if chash is not None:
            out += chash.digest().to_bytes(4, "little")
        return bytes(out)

    # -- decompression ----------------------------------------------------

    def decompress_frame(self, comp: bytes) -> bytes:
        """Parallel decode of an independent-mode frame; linked frames
        fall back to the streaming host decoder."""
        comp = bytes(comp)
        info, pos = lz4f.parse_frame_header(comp)
        if info.frame_type == lz4f.FrameType.skippable_frame:
            return lz4f.decompress_frame(comp, dictionary=self.dict or None)
        if info.block_mode == lz4f.BlockMode.linked:
            res = self._decompress_linked_device(comp, info, pos)
            if res is not None:
                return res
            return lz4f.decompress_frame(comp, dictionary=self.dict or None)
        bs = info.block_size_id.to_block_size()
        ccap = compress_bound(bs)
        nseq_cap = MAX_SEQS(bs)

        # host scan: split frame into block records
        payloads, raws_out = [], []
        chash = xxh32_stream() if info.content_checksum else None
        while True:
            if pos + 4 > len(comp):
                raise E.FrameSizeWrong("truncated block header")
            word = int.from_bytes(comp[pos:pos + 4], "little")
            pos += 4
            if word == 0:
                break
            uncompressed = bool(word & _UNCOMPRESSED_BIT)
            blen = word & ~_UNCOMPRESSED_BIT
            if pos + blen > len(comp):
                raise E.FrameSizeWrong("truncated block payload")
            payload = comp[pos:pos + blen]
            pos += blen
            if info.block_checksum:
                expect = int.from_bytes(comp[pos:pos + 4], "little")
                pos += 4
                if xxh32(payload) != expect:
                    raise E.BlockChecksumInvalid("block checksum mismatch")
            payloads.append((payload, uncompressed))

        results = self._decode_records(payloads, bs)

        content = b"".join(results)    # ordered frame gather
        if chash is not None:
            chash.update(content)
            if pos + 4 > len(comp):
                raise E.FrameSizeWrong("missing content checksum")
            expect = int.from_bytes(comp[pos:pos + 4], "little")
            pos += 4
            if chash.digest() != expect:
                raise E.ContentChecksumInvalid("content checksum mismatch")
        if info.content_size and len(content) != info.content_size:
            raise E.FrameSizeWrong(
                f"content size {info.content_size} != {len(content)}")
        if pos < len(comp):          # concatenated frames (lz4 CLI)
            return content + self.decompress_frame(comp[pos:])
        return content

    def _decompress_linked_device(self, comp: bytes, info,
                                  pos: int) -> bytes | None:
        """DEVICE decode of a linked-mode frame via windowed T-maps.

        Linked blocks form a 64KB dependency chain (reference
        streaming prefix semantics: src/lz4.zig:870-957), but T-map
        resolution is purely STRUCTURAL -- the native linked resolver
        (lz4tpu_resolve_tmap_linked) path-compresses every
        history-reaching match through earlier blocks' entries without
        ever needing decoded BYTES, so the host resolves the whole
        frame up front, window by window.  Bytes are only needed for
        each window's fetch buffer [entry history | payloads]; the
        entry history is the previous window's device output tail, so
        the device steps chain ON DEVICE (ops/jax_decode
        ``_linked_tmap_step``) and the host syncs once at the end --
        the dependency chain serializes only the device merges, not
        resolve/dispatch (round-4 engine did one resolve + one
        dispatch + one sync PER BLOCK).  Returns None when a payload
        cannot fit any supported window geometry (caller falls back
        to the host streaming decoder)."""
        from ..native import native_resolve_tmap_linked
        from ..ops.jax_decode import _bits, _linked_tmap_stepper
        bs = info.block_size_id.to_block_size()
        H = WINDOW_SIZE
        # window geometry: fetch = [H-byte entry history | <= PCQ
        # payload bytes], output <= NOUT; the one-merge byte pack
        # needs bits(H + PCQ + 1) + 9 <= 31 (jax_decode
        # _decode_flat_fetch), which caps PCQ at 4MB - H - 2 -- only
        # near-incompressible 4MB payloads miss it
        NOUT = max(bs, 1 << 21)
        PCQ = min(compress_bound(bs) if bs >= (1 << 20) else 1 << 20,
                  (1 << 22) - 2 - H)
        if _bits(H + PCQ + 1) + 9 > 31:     # pragma: no cover
            return None

        # host scan: frame -> (payload, is_raw) records
        payloads: list[tuple[bytes, bool]] = []
        while True:
            if pos + 4 > len(comp):
                raise E.FrameSizeWrong("truncated block header")
            word = int.from_bytes(comp[pos:pos + 4], "little")
            pos += 4
            if word == 0:
                break
            uncompressed = bool(word & _UNCOMPRESSED_BIT)
            blen = word & ~_UNCOMPRESSED_BIT
            if pos + blen > len(comp):
                raise E.FrameSizeWrong("truncated block payload")
            payload = comp[pos:pos + blen]
            pos += blen
            if info.block_checksum:
                expect = int.from_bytes(comp[pos:pos + 4], "little")
                pos += 4
                if xxh32(payload) != expect:
                    raise E.BlockChecksumInvalid("block checksum")
            payloads.append((payload, uncompressed))
        if any(len(p) > PCQ for p, _u in payloads):
            self.routes["decode_host"] += len(payloads)
            return None          # host streaming decoder takes over

        # window assembly: greedy under the payload and output budgets
        windows: list[tuple[int, int]] = []      # [b0, b1) record spans
        b0 = 0
        while b0 < len(payloads):
            b1, psum = b0, 0
            while (b1 < len(payloads)
                   and psum + len(payloads[b1][0]) <= PCQ
                   and (b1 - b0 + 1) * bs <= NOUT):
                psum += len(payloads[b1][0])
                b1 += 1
            windows.append((b0, b1))
            b0 = b1

        # host resolve (sequential, structural -- no bytes needed)
        step = _linked_tmap_stepper(H, PCQ, NOUT)
        hist0 = np.zeros(H, np.uint8)
        dlen = min(len(self.dict), H)
        if dlen:         # right-aligned: dict_base = H - dict_len
            hist0[H - dlen:] = np.frombuffer(self.dict[-dlen:], np.uint8)
        hist_dev = jax.device_put(hist0)
        outs, win_totals = [], []
        for b0, b1 in windows:
            recs = payloads[b0:b1]
            offs = np.zeros(len(recs), np.int64)
            lens = np.zeros(len(recs), np.int64)
            lit_base = np.zeros(len(recs), np.int64)
            is_raw = np.zeros(len(recs), np.int8)
            pay = np.zeros(PCQ, np.uint8)
            cpos = 0
            for j, (p, raw_flag) in enumerate(recs):
                offs[j] = cpos
                lens[j] = len(p)
                lit_base[j] = H + cpos
                is_raw[j] = raw_flag
                pay[cpos:cpos + len(p)] = np.frombuffer(p, np.uint8)
                cpos += len(p)
            window_pay = bytes(pay[:cpos])
            r = native_resolve_tmap_linked(
                window_pay, offs, lens, lit_base, is_raw,
                dict_len=dlen, total_cap=NOUT, blk_cap=bs,
                dict_base=H - dlen)
            if r is None:
                _native_missing()
            T, _olens, total = r
            # T rows past ``total`` are uninitialized; the device step
            # masks them via total_len (dead rows sort to the end)
            out_d, hist_dev = step(hist_dev, jax.device_put(pay),
                                   jax.device_put(T),
                                   np.int32(total))
            outs.append(out_d)
            win_totals.append(total)
            dlen = min(H, dlen + total)

        out_parts = [np.asarray(o)[:t].tobytes()
                     for o, t in zip(outs, win_totals)]
        self.routes["decode_device"] += len(payloads)
        chash = xxh32_stream() if info.content_checksum else None
        if chash is not None:
            for part in out_parts:
                chash.update(part)
        content = b"".join(out_parts)
        if chash is not None:
            if pos + 4 > len(comp):
                raise E.FrameSizeWrong("missing content checksum")
            if chash.digest() != int.from_bytes(comp[pos:pos + 4],
                                                "little"):
                raise E.ContentChecksumInvalid("content checksum")
            pos += 4
        if info.content_size and len(content) != info.content_size:
            raise E.FrameSizeWrong(
                f"content size {info.content_size} != {len(content)}")
        if pos < len(comp):          # concatenated frames (lz4 CLI)
            return content + self.decompress_frame(comp[pos:])
        return content

    def _decode_tmap(self, payloads: list, bs: int, comp_idx: list,
                     results: list) -> None:
        """T-map decode of compressed records -- the default engine:
        host per-byte literal-source maps (full path compression,
        native lz4tpu_resolve_tmap) + ONE parity-keyed device merge
        per block, 100% coverage, no convergence budget.

        Fills ``results`` in place; raises when the native resolver is
        unavailable.  Blocks whose payload exceeds every supported
        fetch quantum (1MB/4MB incompressible blocks) or that overrun
        the block size stay None for the host routes.  reference
        decode semantics: src/lz4.zig:89-251."""
        from ..native import native_resolve_tmap
        from ..ops.jax_block import (_batched_tmap_decoder,
                                     device_tmap_decoder_supports)
        ccap = compress_bound(bs)
        quanta = [q for q in (bs // 4, bs // 2, ccap)
                  if device_tmap_decoder_supports(bs, self.dcap + q)]
        if not quanta:
            return               # no device geometry: host takes all
        q_max = max(quanta)
        concat = b"".join(payloads[k][0] for k in comp_idx)
        if not concat:
            return
        offs64 = np.zeros(len(comp_idx), np.int64)
        lens64 = np.zeros(len(comp_idx), np.int64)
        cpos = 0
        for j, k in enumerate(comp_idx):
            offs64[j] = cpos
            lens64[j] = len(payloads[k][0])
            cpos += lens64[j]
        r = native_resolve_tmap(concat, offs64, lens64, bs,
                                hist_len=self.dcap)
        if r is None:
            _native_missing()
        T, olens = r
        elig = [j for j in range(len(comp_idx))
                if olens[j] >= 0 and lens64[j] <= q_max]
        dec = _batched_tmap_decoder(bs)
        batch = max(self.n_devices * 8, min(64, len(elig)))
        dict_arr = np.frombuffer(self.dict, np.uint8) if self.dcap \
            else None
        s1 = NamedSharding(self.mesh, P("blocks"))
        s2 = NamedSharding(self.mesh, P("blocks", None))
        pending = []        # async dispatch; ONE sync pass at the end
        for c0 in range(0, len(elig), batch):
            grp = elig[c0:c0 + batch]
            need = int(lens64[grp].max())
            fetch_t = self.dcap + next(q for q in quanta if q >= need)
            nb_pad = -(-len(grp) // self.n_devices) * self.n_devices
            sel = grp + [grp[0]] * (nb_pad - len(grp))
            bufs = np.zeros((nb_pad, fetch_t), np.uint8)
            if self.dcap:
                bufs[:, :self.dcap] = dict_arr
            for jj, j in enumerate(grp):
                p = payloads[comp_idx[j]][0]
                bufs[jj, self.dcap:self.dcap + len(p)] = \
                    np.frombuffer(p, np.uint8)
            bufs[len(grp):] = bufs[0]
            pending.append((grp, dec(
                jax.device_put(bufs, s2),
                jax.device_put(T[sel], s2),
                jax.device_put(olens[sel].astype(np.int32), s1))))
        for grp, out_d in pending:
            outs = np.asarray(out_d)
            for jj, j in enumerate(grp):
                results[comp_idx[j]] = outs[jj, :int(olens[j])] \
                    .tobytes()
        self.routes["decode_device"] += len(elig)

    def _decode_records(self, payloads: list, bs: int) -> list:
        """Decode a list of (payload, uncompressed) block records of an
        independent-mode frame into raw blocks, device-batched.

        The default T-map engine takes every block whose payload fits
        a device fetch quantum; the fragment engines, when selected,
        tier blocks by fragment count and round depth.  The fetch
        buffer is [dictionary | payload] so dictionary frames decode
        on-device too.  Blocks beyond every device geometry take a
        host route, counted in ``routes``.
        """
        ccap = compress_bound(bs)
        nseq_cap = MAX_SEQS(bs)
        results: list[bytes | None] = [None] * len(payloads)
        comp_idx = [k for k, (_, u) in enumerate(payloads) if not u]
        for k, (p, u) in enumerate(payloads):
            if u:
                results[k] = p
        self.routes["decode_stored"] += len(payloads) - len(comp_idx)

        # keep only tiers whose pack geometry fits this block size --
        # e.g. at 256KB blocks fcap = bs/2 exceeds the chunk widths,
        # but bs/4 still fits, so big blocks keep a device path.
        # The deep capability tier (match-dense blocks, many rounds)
        # runs only on multi-device meshes; on one device the host
        # codec takes those blocks.
        eng = self.decode_engine
        if eng == "tmap":
            if comp_idx:
                self._decode_tmap(payloads, bs, comp_idx, results)
            eng = "none"         # leftovers take the host routes
        chase = eng == "chase"
        if eng == "none":
            use = ()
            resolve_rmax = _FRAG_RMAX
            supports = device_frag_decoder_supports
        elif chase:
            from ..ops.jax_block import device_chase_decoder_supports
            use = _CHASE_TIERS
            resolve_rmax = _CHASE_RMAX
            supports = device_chase_decoder_supports
        elif eng == "mixed":
            from ..ops.jax_block import device_chase_decoder_supports

            def supports(b_, f_, c_, rmax=None):
                eng_ = device_frag_decoder_supports if (rmax or 0) <= 2 \
                    else device_chase_decoder_supports
                return eng_(b_, f_, c_)
            use = _FRAG_TIERS if self.n_devices > 1 else _FRAG_TIERS[:-1]
            resolve_rmax = _FRAG_RMAX
        else:
            use = _FRAG_TIERS if self.n_devices > 1 else _FRAG_TIERS[:-1]
            resolve_rmax = _FRAG_RMAX
            supports = device_frag_decoder_supports
        mixed = eng == "mixed"
        # Tier support is checked at QUANTIZED fetch sizes: the fetch
        # buffer is sized per batch to the smallest quantum holding
        # its largest payload (bs/4, bs/2, full bound), and a tier
        # whose packs only fit at a small quantum simply restricts
        # itself to payloads that small -- this is what gives 1MB/4MB
        # blocks a device path (their full compress_bound overflows
        # the int32 packs, but compressible payloads don't).
        quanta = (bs // 4, bs // 2, ccap)

        def tier_q(div, rmax):
            """Largest fetch quantum whose pack geometry fits this
            tier (0 = the tier cannot fit at any quantum)."""
            f_ = bs // div
            for q in reversed(quanta):
                okq = (supports(bs, f_, self.dcap + q, rmax=rmax)
                       if mixed else supports(bs, f_, self.dcap + q))
                if okq:
                    return q
            return 0

        fit_tiers = [(div, rmax, q) for div, rmax in use
                     if (q := tier_q(div, rmax))]
        if not fit_tiers and mixed:
            # big-block narrow ladder (rmax > 2 -> the chase engine)
            fit_tiers = [(div, rmax, q) for div, rmax in _FRAG_TIERS_BIG
                         if (q := tier_q(div, rmax))]
        # one resolve at the WIDEST fitting fcap serves every tier
        fcap_hi = max((bs // div for div, _r, _q in fit_tiers), default=0)
        tiers = None
        if comp_idx and fit_tiers:
            from ..native import native_resolve_blocks
            concat = b"".join(payloads[k][0] for k in comp_idx)
            offs64 = np.zeros(len(comp_idx), np.int64)
            lens64 = np.zeros(len(comp_idx), np.int64)
            cpos = 0
            for j, k in enumerate(comp_idx):
                offs64[j] = cpos
                lens64[j] = len(payloads[k][0])
                cpos += len(payloads[k][0])
            r = native_resolve_blocks(
                concat, offs64, lens64, fcap_hi, out_cap=bs,
                hist_len=self.dcap, split_max=_FRAG_SPLIT_MAX,
                round_limit=resolve_rmax) if cpos else None
            if r is not None:
                fdst, flen, fsrc, fper, fph, nfrag, rounds, olens = r
                jmap = {k: j for j, k in enumerate(comp_idx)}
                plen = np.array([len(payloads[k][0]) for k in comp_idx],
                                np.int64)
                tiers = []
                taken = np.zeros(len(comp_idx), bool)
                for div, rmax, q in fit_tiers:
                    fcap_t = bs // div
                    ok = (~taken & (nfrag >= 0) & (nfrag <= fcap_t)
                          & (rounds <= rmax) & (olens <= bs)
                          & (plen <= q))
                    taken |= ok
                    tiers.append((fcap_t, rmax,
                                  [comp_idx[j] for j in np.where(ok)[0]]))

        batch = max(self.n_devices * 8, self.n_devices)
        if tiers:
            from ..ops.jax_block import (_batched_frag_decoder,
                                         _batched_frag_decoder_chase,
                                         _batched_frag_decoder_win,
                                         device_win_decoder_supports)
            # Fetch-buffer quantization: the literal merge sorts over
            # the fetch buffer's STATIC row count, but compressible
            # payloads are far smaller than compress_bound(bs) -- so
            # size each batch's buffer to the smallest quantum that
            # fits its largest payload (bs/4 at ratio >= 4, bs/2 at
            # >= 2, else the full bound), which halves the merge rows
            # at each step down.  Shrinking
            # a fetch buffer only relaxes the pack geometry (see
            # _frag_geometry), and every tier member's payload fits
            # that tier's supported quantum by construction (tier_q).
            for fcap_t, rmax, group_idx in tiers:
                if not group_idx:
                    continue
                for c0 in range(0, len(group_idx), batch):
                    group = group_idx[c0:c0 + batch]
                    need = max(len(payloads[k][0]) for k in group)
                    fetch_t = self.dcap + next(
                        (q for q in quanta if q >= need), ccap)
                    # per-tier engine: windowed for the shallow tier,
                    # chase for the deep tiers in mixed mode;
                    # self-validation flags route the rare failures
                    # onward to the host codec.
                    if chase or (mixed and rmax > 2):
                        dn, dbl, qc = _chase_config(rmax)
                        dec = _batched_frag_decoder_chase(
                            bs, fcap_t, dn, dbl, qc)
                        use_win = True   # same (out, ok) shape
                    else:
                        use_win = device_win_decoder_supports(
                            bs, fcap_t, fetch_t)
                        # wide groups on the shallow tier
                        wg = 16 if rmax <= 2 else 8
                        dec = (_batched_frag_decoder_win(bs, fcap_t,
                                                         rmax, g=wg)
                               if use_win
                               else _batched_frag_decoder(bs, fcap_t,
                                                          rmax))
                    nb_pad = -(-len(group) // self.n_devices) \
                        * self.n_devices
                    sel = [jmap[k] for k in group] + \
                        [jmap[group[0]]] * (nb_pad - len(group))
                    bufs = np.zeros((nb_pad, fetch_t), np.uint8)
                    if self.dcap:
                        bufs[:, :self.dcap] = np.frombuffer(
                            self.dict, np.uint8)
                    for j, k in enumerate(group):
                        p = payloads[k][0]
                        bufs[j, self.dcap:self.dcap + len(p)] = \
                            np.frombuffer(p, np.uint8)
                    bufs[len(group):] = bufs[0]
                    r = dec(
                        bufs, fdst[sel, :fcap_t], fsrc[sel, :fcap_t],
                        fper[sel, :fcap_t], fph[sel, :fcap_t],
                        nfrag[sel], olens[sel].astype(np.int32))
                    if use_win:
                        outs, oks = np.asarray(r[0]), np.asarray(r[1])
                    else:
                        outs, oks = np.asarray(r), None
                    for j, k in enumerate(group):
                        if oks is None or oks[j]:
                            results[k] = outs[j, :int(olens[jmap[k]])] \
                                .tobytes()
                            self.routes["decode_device"] += 1

        rest = [k for k in comp_idx if results[k] is None]
        if rest and self.dcap and (compress_bound(bs) + self.dcap
                                   ).bit_length() > 17:
            # dictionary blocks beyond every fragment tier, where the
            # pointer-jumping decoder's packs don't cover
            # block+history: host dict decoder (rare)
            from ..ops.block import decompress_safe_using_dict
            for k in rest:
                results[k] = decompress_safe_using_dict(
                    payloads[k][0], bs, self.dict)
            self.routes["decode_host"] += len(rest)
            rest = []
        if rest and not self.dcap:
            # pathological blocks (fragment explosion / deep periodic
            # nesting) and blocks beyond every device geometry: the
            # host codec takes them.
            from ..native import native_decompress_blocks
            concat2 = b"".join(payloads[k][0] for k in rest)
            ro = np.zeros(len(rest), np.int64)
            rl = np.zeros(len(rest), np.int64)
            rp = 0
            for j, k in enumerate(rest):
                ro[j] = rp
                rl[j] = len(payloads[k][0])
                rp += rl[j]
            hr = native_decompress_blocks(concat2, ro, rl, bs)
            if hr is not None:
                ho, hol = hr
                for j, k in enumerate(rest):
                    results[k] = ho[j, :int(hol[j])].tobytes()
                self.routes["decode_host"] += len(rest)
                rest = []

        for c0 in range(0, len(rest), batch):
            group = rest[c0:c0 + batch]
            nb_pad = -(-len(group) // self.n_devices) * self.n_devices
            bufs = np.zeros((nb_pad, ccap), np.uint8)
            lits = np.zeros((nb_pad, nseq_cap), np.int32)
            lsrcs = np.zeros((nb_pad, nseq_cap), np.int32)
            mls = np.zeros((nb_pad, nseq_cap), np.int32)
            offs = np.ones((nb_pad, nseq_cap), np.int32)
            nss = np.zeros(nb_pad, np.int32)
            for j, k in enumerate(group):
                payload = payloads[k][0]
                bufs[j, :len(payload)] = np.frombuffer(payload, np.uint8)
                lit, lsrc, ml, off, ns = _parse_block(payload, nseq_cap,
                                                      self.dcap)
                if int(lit.sum()) + int(ml.sum()) > bs:
                    raise E.CorruptedData(
                        f"block {k} decodes to more than the frame "
                        f"block size {bs}")
                lits[j], lsrcs[j], mls[j], offs[j], nss[j] = \
                    lit, lsrc, ml, off, ns
            hcap = max(self.dcap, 1)
            hist = np.zeros(hcap, np.uint8)
            if self.dcap:
                hist[:] = np.frombuffer(self.dict, np.uint8)
            dec = _sharded_decoder(self.mesh, bs, ccap, nseq_cap, hcap)
            s1 = NamedSharding(self.mesh, P("blocks"))
            s2 = NamedSharding(self.mesh, P("blocks", None))
            sh = NamedSharding(self.mesh, P(None))
            outs, olens = dec(jax.device_put(bufs, s2),
                              jax.device_put(hist, sh),
                              jax.device_put(lits, s2),
                              jax.device_put(lsrcs, s2),
                              jax.device_put(mls, s2),
                              jax.device_put(offs, s2),
                              jax.device_put(nss, s1))
            outs = np.asarray(outs)
            olens = np.asarray(olens)
            for j, k in enumerate(group):
                results[k] = outs[j, :int(olens[j])].tobytes()
            self.routes["decode_device"] += len(group)

        return results
