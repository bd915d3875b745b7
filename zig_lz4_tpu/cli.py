"""lz4-compatible command-line tool.

The reference ships an ``lz4`` executable that only runs a self-test
(reference: src/main.zig:1-5, build.zig:60-90); this CLI is a real
file compressor producing/consuming standard LZ4 frames, modeled on
the flags of Yann Collet's lz4(1):

  zig-lz4 [flags] [input] [output]

    -1 .. -12      compression level (0/1 = fast, 2..12 = HC)
    -d             decompress
    -z             force compression (default when input not .lz4)
    -t             test integrity (decompress to nowhere)
    -f             overwrite output
    -k             keep input (default; symmetry with lz4(1))
    -c             write to stdout
    -B4..-B7       block size 64KB/256KB/1MB/4MB
    -BI / -BD      block independence (default) / linked mode
    --no-frame-crc drop the content checksum
    --block-crc    add per-block checksums
    --content-size embed the content size in the header
    --engine E     host | device | oracle   (default host)
    --decode-engine tmap | mixed | win | chase
                   device decode engine (--engine device only;
                   default tmap, as ShardedFrameCodec)
    --self-test    run the library smoke suite and exit
    -v / -q        verbosity

With no input (or "-"), reads stdin; with no output, appends/strips
``.lz4``.  ``--engine device`` routes blocks through the sharded device
codec (ShardedFrameCodec).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="zig-lz4", add_help=True,
        description="LZ4 frame compressor with a JAX device codec")
    p.add_argument("input", nargs="?", default="-")
    p.add_argument("output", nargs="?", default=None)
    for lv in range(1, 13):
        p.add_argument(f"-{lv}", dest="level", action="store_const",
                       const=lv, help=argparse.SUPPRESS)
    p.add_argument("-0", dest="level", action="store_const", const=0,
                   help=argparse.SUPPRESS)
    p.add_argument("-d", "--decompress", action="store_true")
    p.add_argument("-z", "--compress", action="store_true")
    p.add_argument("-t", "--test", action="store_true")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("-k", "--keep", action="store_true", default=True)
    p.add_argument("-c", "--stdout", action="store_true")
    p.add_argument("-B4", dest="bsid", action="store_const", const=4)
    p.add_argument("-B5", dest="bsid", action="store_const", const=5)
    p.add_argument("-B6", dest="bsid", action="store_const", const=6)
    p.add_argument("-B7", dest="bsid", action="store_const", const=7)
    p.add_argument("-BI", dest="linked", action="store_false",
                   default=False)
    p.add_argument("-BD", dest="linked", action="store_true")
    p.add_argument("--no-frame-crc", dest="content_checksum",
                   action="store_false", default=True)
    p.add_argument("--block-crc", dest="block_checksum",
                   action="store_true", default=False)
    p.add_argument("--content-size", action="store_true")
    p.add_argument("--engine", choices=("host", "device", "oracle"),
                   default="host")
    p.add_argument("--decode-engine",
                   choices=("tmap", "mixed", "win", "chase"),
                   default="tmap",
                   help="device decode engine for --engine device: "
                        "tmap one-merge decode (default), the mixed "
                        "fragment ladder, windowed tiers, or "
                        "pointer-doubling chase")
    p.add_argument("-D", "--dictionary", default=None,
                   help="dictionary file (last 64KB used)")
    p.add_argument("--self-test", action="store_true")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-q", "--quiet", action="store_true")
    p.set_defaults(level=1, bsid=4)
    return p


def _read(path: str) -> bytes:
    if path == "-":
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def _write(path: str | None, data: bytes, force: bool,
           to_stdout: bool) -> None:
    if to_stdout or path in (None, "-"):
        sys.stdout.buffer.write(data)
        sys.stdout.buffer.flush()
        return
    if os.path.exists(path) and not force:
        raise SystemExit(f"zig-lz4: {path} already exists; use -f")
    with open(path, "wb") as f:
        f.write(data)


def _routes(codec) -> str:
    """Verbose suffix naming the blocks each device-codec route took."""
    return " routes " + " ".join(f"{k}={v}" for k, v in
                                 sorted(codec.routes.items()))


def _self_test() -> int:
    """Reference-style smoke suite (reference: src/test.zig round-trip
    cases run by the installed exe)."""
    import random
    from . import compress_default, decompress_safe, compress_hc
    from . import frame as lz4f
    rng = random.Random(0x5EED)
    cases = [b"", b"abc", b"Hello World!", b"ABCDEFGH" * 125,
             bytes(rng.randrange(256) for _ in range(256)),
             bytes(i & 0xFF for i in range(10_000)), b"a" * 10_000]
    for d in cases:
        assert decompress_safe(compress_default(d), len(d)) == d
        assert decompress_safe(compress_hc(d, 9), len(d)) == d
        assert lz4f.decompress_frame(lz4f.compress_frame(d)) == d
    print("zig-lz4: self-test OK (block fast/HC + frame round-trips)")
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.self_test:
        return _self_test()

    from . import frame as lz4f
    from .errors import LZ4Error

    inp = args.input
    decompress = args.decompress or args.test or (
        not args.compress and inp.endswith(".lz4"))

    data = _read(inp)
    t0 = time.perf_counter()
    routes = ""

    if decompress:
        try:
            if args.engine == "device":
                from .parallel.sharded import ShardedFrameCodec
                codec = ShardedFrameCodec(decode_engine=args.decode_engine)
                out = codec.decompress_frame(data)
                routes = _routes(codec)
            else:
                dict_ = _read(args.dictionary) if args.dictionary else None
                out = lz4f.decompress_frame(data, dictionary=dict_)
        except LZ4Error as e:
            print(f"zig-lz4: {inp}: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 1
        dt = time.perf_counter() - t0
        if args.test:
            if not args.quiet:
                print(f"{inp}: decoded {len(out)} bytes OK")
            return 0
        # stdin input with no -o: write to stdout, like lz4(1)
        dst = args.output or (None if inp == "-" else
                              inp[:-4] if inp.endswith(".lz4") else
                              inp + ".out")
        _write(dst, out, args.force, args.stdout)
        if args.verbose and not args.quiet:
            print(f"{inp}: {len(data)} -> {len(out)} bytes "
                  f"({len(out)/max(dt,1e-9)/1e6:.1f} MB/s){routes}",
                  file=sys.stderr)
        return 0

    # compression
    info = lz4f.FrameInfo(
        block_size_id=lz4f.BlockSizeID(args.bsid),
        block_mode=(lz4f.BlockMode.linked if args.linked
                    else lz4f.BlockMode.independent),
        content_checksum=args.content_checksum,
        block_checksum=args.block_checksum,
        content_size=len(data) if args.content_size else 0)
    # lz4(1) semantics: -1 is the fast codec; -2..-12 are HC levels
    prefs = lz4f.Preferences(frame_info=info,
                             compression_level=(0 if args.level <= 1
                                                else args.level))
    if args.engine == "device":
        from .parallel.sharded import ShardedFrameCodec
        codec = ShardedFrameCodec(
            block_size_id=lz4f.BlockSizeID(args.bsid),
            content_checksum=args.content_checksum,
            block_checksum=args.block_checksum,
            compression_level=(0 if args.level <= 1 else args.level))
        out = codec.compress_frame(data)
        routes = _routes(codec)
    else:
        dict_ = _read(args.dictionary) if args.dictionary else None
        out = lz4f.compress_frame(data, prefs, dictionary=dict_)
    dt = time.perf_counter() - t0
    dst = args.output or (inp + ".lz4" if inp != "-" else None)
    _write(dst, out, args.force, args.stdout)
    if args.verbose and not args.quiet:
        ratio = len(data) / max(len(out), 1)
        print(f"{inp}: {len(data)} -> {len(out)} bytes (ratio {ratio:.3f}, "
              f"{len(data)/max(dt,1e-9)/1e6:.1f} MB/s, level {args.level}, "
              f"engine {args.engine}){routes}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
