#!/usr/bin/env python
"""Smoke run of the LZ4 frame pipeline on an NVIDIA GPU.

Drives the codec once through the entry points a user calls
(``ShardedFrameCodec`` and the CLI) at real sizes on the bench corpus
mix (``bench.make_corpus``) and checks every output byte: each frame
decodes with the independent host frame decoder, each device decode
equals the input, and on 16 sampled blocks the device encoder's
payloads equal the same jitted encoder's payloads on a CPU device (the
codec is integer-only, so the match is exact).  One line per phase goes
to stdout, then one JSON line:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Run from the repo root, as the only process using the card(s):

    python chip_smoke.py               # every phase on one card
    python chip_smoke.py --four-cards  # the 4-card mesh against 1 card

It exits non-zero and prints no result when JAX finds no GPU, when the
native host library cannot be built, or at the first wrong byte; no
phase catches its own failure.  Each phase function takes the mesh and
the sizes, so the tests run every phase at a tiny size on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import re
import sys
import tempfile
import time

MB = 1 << 20
KB64 = 1 << 16


class SmokeFailure(AssertionError):
    """A phase produced a wrong byte or used a route it must not."""


def _expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


@functools.lru_cache(maxsize=2)
def _corpus_mb(mb: int) -> bytes:
    from bench import make_corpus
    return make_corpus(mb)


def corpus(nbytes: int) -> bytes:
    """The first ``nbytes`` of the seeded bench corpus mix."""
    return _corpus_mb(max(-(-nbytes // MB), 1))[:nbytes]


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def _codec(mesh, block_size: int | None = None, **kw):
    from zig_lz4_tpu.parallel.sharded import ShardedFrameCodec
    codec = ShardedFrameCodec(mesh=mesh, **kw)
    if block_size:
        # tests shrink the blocks (wire-valid: any block may be shorter
        # than the declared maximum) to keep CPU compiles small
        codec.block_size = block_size
        codec.window = codec.dcap + block_size
    return codec


def _no_host(stats: dict) -> None:
    r = stats["routes"]
    _expect(r.get("encode_host", 0) == 0 and r.get("decode_host", 0) == 0,
            f"a host route carried blocks: {r}")


def _round_trip(codec, data: bytes, host_decode) -> dict:
    """Encode and decode ``data`` twice; every result is checked.  The
    first call of each includes compilation; ``routes`` counts the
    second encode and decode."""
    frame, enc1 = _timed(codec.compress_frame, data)
    _expect(host_decode(frame) == data, "host frame decoder != input")
    out, dec1 = _timed(codec.decompress_frame, frame)
    _expect(out == data, "device decode != input")
    codec.routes.clear()
    frame2, enc2 = _timed(codec.compress_frame, data)
    _expect(frame2 == frame, "second encode != first encode")
    out, dec2 = _timed(codec.decompress_frame, frame2)
    _expect(out == data, "second device decode != input")
    return {"bytes_in": len(data), "ratio": len(data) / len(frame),
            "encode_first_s": enc1, "encode_second_s": enc2,
            "decode_first_s": dec1, "decode_second_s": dec2,
            "routes": dict(codec.routes)}


def encoder_vs_cpu(mesh, level: int, nblocks: int = 16,
                   block_size: int | None = None) -> int:
    """Payloads of the mesh's encoder == the CPU device's payloads on
    ``nblocks`` corpus blocks, batched as the frame path batches them.
    Returns the number of blocks compared."""
    import jax
    from zig_lz4_tpu.parallel.mesh import blocks_mesh
    cpu = blocks_mesh(devices=jax.devices("cpu")[:1])
    codecs = [_codec(m, block_size, compression_level=level)
              for m in (mesh, cpu)]
    bs = codecs[0].block_size
    data = corpus(nblocks * bs)
    span = codecs[0].n_devices * 8 * bs

    def payloads(c):
        return [p for s0 in range(0, len(data), span)
                for _raw, p in c._encode_span(data[s0:s0 + span])]

    dev, ref = payloads(codecs[0]), payloads(codecs[1])
    _expect(len(dev) == nblocks and dev == ref,
            f"level {level}: device payloads != CPU payloads")
    return nblocks


def _memory(compiled) -> dict:
    m = compiled.memory_analysis()
    return {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}


def memory_report(codec, nblocks: int) -> dict:
    """Compile time and ``memory_analysis()`` of the frame encoder and
    the T-map decoder at the shapes the frame path gives them (the
    decoder at its largest fetch quantum)."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from zig_lz4_tpu.constants import compress_bound
    from zig_lz4_tpu.ops.jax_decode import _batched_tmap_decoder
    from zig_lz4_tpu.parallel.sharded import _sharded_encoder
    s1 = NamedSharding(codec.mesh, P("blocks"))
    s2 = NamedSharding(codec.mesh, P("blocks", None))

    def sds(shape, dtype, sh):
        # real (zero) arrays, placed as the frame path places its
        # inputs, so this compile and the frame path's share a cache key
        return jax.device_put(np.zeros(shape, dtype), sh)

    bs, nd = codec.block_size, codec.n_devices
    enc_rows = -(-min(nd * 8, nblocks) // nd) * nd
    dec_rows = -(-max(nd * 8, min(64, nblocks)) // nd) * nd
    enc = _sharded_encoder(codec.mesh, codec.window, codec.hc, codec.deep)
    ce, t_enc = _timed(lambda: enc.lower(
        sds((enc_rows, codec.window), np.uint8, s2),
        sds((enc_rows,), np.int32, s1),
        sds((enc_rows,), np.int32, s1)).compile())
    dec = _batched_tmap_decoder(bs)
    cd, t_dec = _timed(lambda: dec.lower(
        sds((dec_rows, codec.dcap + compress_bound(bs)), np.uint8, s2),
        sds((dec_rows, bs), np.int32, s2),
        sds((dec_rows,), np.int32, s1)).compile())
    return {"encoder": {"rows": enc_rows, "compile_s": t_enc,
                        **_memory(ce)},
            "tmap_decoder": {"rows": dec_rows, "compile_s": t_dec,
                             **_memory(cd)}}


# -- phases: each takes the mesh and sizes, returns its line's fields --

def phase_frame(mesh, nbytes: int, level: int = 0,
                block_size: int | None = None, compare_blocks: int = 16,
                memory: bool = False) -> dict:
    """An independent 64KB-block frame with a content checksum at
    ``level`` (the l9, fast and l12 phases)."""
    from zig_lz4_tpu import frame as lz4f
    codec = _codec(mesh, block_size, compression_level=level)
    st = {}
    if memory:
        st["memory"] = memory_report(codec,
                                     -(-nbytes // codec.block_size))
    st.update(_round_trip(codec, corpus(nbytes), lz4f.decompress_frame))
    _no_host(st)
    if compare_blocks:
        st["vs_cpu_blocks_equal"] = encoder_vs_cpu(mesh, level,
                                                   compare_blocks,
                                                   block_size)
    return st


def phase_dict(mesh, nbytes: int, dict_size: int = KB64,
               block_size: int | None = None) -> dict:
    """A frame whose blocks match into a shared external dictionary."""
    from zig_lz4_tpu import frame as lz4f
    src = corpus(nbytes + dict_size)
    data, dictionary = src[:nbytes], src[nbytes:]
    codec = _codec(mesh, block_size, dictionary=dictionary,
                   dict_id=0x5EED)
    st = _round_trip(codec, data, lambda f: lz4f.decompress_frame(
        f, dictionary=dictionary))
    _no_host(st)
    return st


def phase_big(mesh, nbytes: int) -> dict:
    """4MB blocks: sub-span device encode and 4MB T-map decode.
    Blocks beyond the device geometry may take a host route; the line
    counts them."""
    from zig_lz4_tpu import frame as lz4f
    codec = _codec(mesh, block_size_id=lz4f.BlockSizeID.max4MB)
    return _round_trip(codec, corpus(nbytes), lz4f.decompress_frame)


def phase_linked(mesh, nbytes: int) -> dict:
    """Device decode of a host-encoded linked-mode 64KB-block frame."""
    from zig_lz4_tpu import frame as lz4f
    data = corpus(nbytes)
    prefs = lz4f.Preferences(frame_info=lz4f.FrameInfo(
        block_size_id=lz4f.BlockSizeID.max64KB,
        block_mode=lz4f.BlockMode.linked, content_checksum=True))
    frame, t_host = _timed(lz4f.compress_frame, data, prefs)
    codec = _codec(mesh)
    out, dec1 = _timed(codec.decompress_frame, frame)
    _expect(out == data, "linked device decode != input")
    codec.routes.clear()
    out, dec2 = _timed(codec.decompress_frame, frame)
    _expect(out == data, "second linked device decode != input")
    st = {"bytes_in": len(data), "ratio": len(data) / len(frame),
          "host_encode_s": t_host, "decode_first_s": dec1,
          "decode_second_s": dec2, "routes": dict(codec.routes)}
    _no_host(st)
    return st


_ROUTES = re.compile(r" routes ((?:\w+=\d+ ?)*)$", re.M)


def phase_cli(nbytes: int, level: int = 9) -> dict:
    """``cli.main`` in this process: compress with ``--engine device``,
    then ``-d``; the device codec runs on every visible device."""
    from zig_lz4_tpu import cli
    from zig_lz4_tpu import frame as lz4f
    data = corpus(nbytes)

    def run(argv):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, t = _timed(cli.main, argv)
        _expect(rc == 0, f"cli {argv} exited {rc}: {err.getvalue()}")
        m = _ROUTES.search(err.getvalue())
        _expect(m is not None, f"cli printed no routes: {err.getvalue()}")
        return t, {k: int(v) for k, v in
                   (kv.split("=") for kv in m.group(1).split())}

    st = {"bytes_in": len(data)}
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "in.bin")
        comp, back = src + ".lz4", os.path.join(d, "back.bin")
        with open(src, "wb") as f:
            f.write(data)
        for call in ("first", "second"):
            t, r_enc = run([f"-{level}", "--engine", "device", "-f", "-v",
                            src, comp])
            st[f"encode_{call}_s"] = t
            with open(comp, "rb") as f:
                frame = f.read()
            _expect(lz4f.decompress_frame(frame) == data,
                    "host frame decoder != input (cli frame)")
            t, r_dec = run(["-d", "--engine", "device", "-f", "-v",
                            comp, back])
            st[f"decode_{call}_s"] = t
            with open(back, "rb") as f:
                _expect(f.read() == data, "cli -d output != input")
    st["ratio"] = len(data) / len(frame)
    st["routes"] = {**r_enc, **r_dec}
    _no_host(st)
    return st


def phase_four_cards(mesh4, mesh1, nbytes: int, level: int = 9,
                     block_size: int | None = None) -> dict:
    """The l9 corpus encoded and T-map-decoded on a 4-device mesh and on
    a 1-device mesh: the frames must be byte-identical and both decodes
    must equal the input."""
    from zig_lz4_tpu import frame as lz4f
    data = corpus(nbytes)
    st = {"bytes_in": len(data)}
    frames = {}
    for name, mesh in (("4dev", mesh4), ("1dev", mesh1)):
        codec = _codec(mesh, block_size, compression_level=level)
        for call in ("first", "second"):
            frame, t = _timed(codec.compress_frame, data)
            st[f"{name}_encode_{call}_s"] = t
            out, t = _timed(codec.decompress_frame, frame)
            st[f"{name}_decode_{call}_s"] = t
            _expect(out == data, f"{name} device decode != input")
        frames[name] = frame
        st[f"{name}_routes"] = dict(codec.routes)
        _no_host({"routes": st[f"{name}_routes"]})
    _expect(lz4f.decompress_frame(frames["4dev"]) == data,
            "host frame decoder != input (4-device frame)")
    _expect(frames["4dev"] == frames["1dev"],
            "4-device frame != 1-device frame")
    st["frames_identical"] = True
    st["ratio"] = len(data) / len(frames["4dev"])
    return st


def _peak_bytes() -> int | None:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _run(name: str, card: str, phase, *args, **kw) -> None:
    """Run one phase and print its line (no failure is caught)."""
    fields, t = _timed(lambda: phase(*args, **kw))
    print(f"phase {name} card={card!r} " + json.dumps(
        {**fields, "phase_s": t, "peak_bytes_in_use": _peak_bytes()}),
        flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh against 1 card")
    args = ap.parse_args(argv)

    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 1
    from zig_lz4_tpu import native
    from zig_lz4_tpu.parallel.mesh import blocks_mesh
    if not native.is_available():
        print("chip_smoke: native host library unavailable: "
              f"{native.unavailable_reason()}", file=sys.stderr)
        return 1
    from bench import card_line
    card = card_line()
    devs = jax.devices()
    print(f"card: {card}; jax {jax.__version__}; devices {len(devs)} x "
          f"{devs[0].device_kind}", flush=True)

    t0 = time.perf_counter()
    if args.four_cards:
        _expect(len(devs) >= 4, f"--four-cards needs 4 GPUs, have "
                f"{len(devs)}")
        _run("four_cards", card, phase_four_cards, blocks_mesh(4),
             blocks_mesh(1), 64 * MB)
    else:
        mesh = blocks_mesh(1)
        _run("l9", card, phase_frame, mesh, 64 * MB, level=9, memory=True)
        _run("fast", card, phase_frame, mesh, 64 * MB, level=0)
        _run("l12", card, phase_frame, mesh, 8 * MB, level=12)
        _run("dict", card, phase_dict, mesh, 8 * MB)
        _run("big", card, phase_big, mesh, 32 * MB)
        _run("linked", card, phase_linked, mesh, 16 * MB)
        _run("cli", card, phase_cli, 8 * MB)
    print(f"total_s {time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
