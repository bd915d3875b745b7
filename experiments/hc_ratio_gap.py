"""Where does the device HC finder lose ratio vs native HC9?

Per-content-type comparison of the device suffix-order finder (hc=8)
against the native hash-chain levels, with sequence-level statistics
(match bytes, literal bytes, sequence counts, match-length histogram)
parsed from both compressed streams.  This decides whether round-3
ratio work should attack the FINDER (missing/short matches) or the
PARSE (sequence granularity, lazy depth, price model).

Run: python experiments/hc_ratio_gap.py [cpu]   (cpu = run the device
algorithm on the CPU backend -- bit-identical output, slower wall
clock, no accelerator needed; default uses JAX's default backend)
"""
import functools
import os
import sys

if "cpu" in sys.argv[1:]:
    os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import jax  # noqa: E402

if "cpu" in sys.argv[1:]:
    jax.config.update("jax_platforms", "cpu")

import zig_lz4_tpu.ops.jax_block as jb  # noqa: E402
from zig_lz4_tpu.native import (native_compress_hc_blocks,  # noqa: E402
                                native_compress_blocks)
from bench import make_corpus  # noqa: E402

BLK = 65536
PER_TYPE = int(os.environ.get("NB", "4"))

# regenerate the bench corpus' six content types UNSHUFFLED so blocks
# classify cleanly (same generators as bench.make_corpus)
import bench  # noqa: E402

rng = np.random.default_rng(0xC0FFEE)
corpus = make_corpus(12)


def typed_blocks():
    """PER_TYPE 64KB blocks of each bench content type."""
    import bench as _b
    r = np.random.default_rng(0xC0FFEE)
    gens = {}
    # reconstruct the generators with a local rng (mirrors make_corpus)
    def text(n):
        words = [b"the", b"of", b"and", b"to", b"in", b"that", b"was",
                 b"his", b"he", b"it", b"with", b"is", b"for", b"as",
                 b"had", b"you", b"not", b"be", b"her", b"on", b"at",
                 b"by", b"which", b"have", b"or", b"from", b"this",
                 b"him", b"but", b"all", b"she", b"they", b"were",
                 b"compression", b"dictionary", b"entropy", b"silesia"]
        idx = r.integers(0, len(words), n // 4)
        return b" ".join(words[i] for i in idx)[:n]

    def xmlish(n):
        tags = [b"<row Id=\"%d\" Count=\"%d\"/>" % (i, int(r.integers(999)))
                for i in range(200)]
        idx = r.integers(0, len(tags), n // 16)
        return b"\n".join(tags[i] for i in idx)[:n]

    def codeish(n):
        lines = [b"    if (state->pos + len > state->cap) return -1;",
                 b"    memcpy(dst + op, src + ip, run_length);",
                 b"    for (size_t i = 0; i < n; ++i) acc += table[i];",
                 b"    return lz4_emit_sequence(ctx, literals, match);",
                 b"    uint32_t h = (seq * 2654435761u) >> shift;"]
        idx = r.integers(0, len(lines), n // 30)
        return b"\n".join(lines[i] for i in idx)[:n]

    def records(n):
        k = n // 16
        rec = np.zeros((k, 16), np.uint8)
        rec[:, 0] = r.integers(0, 4, k)
        rec[:, 1] = 0xAB
        rec[:, 2:6] = np.arange(k, dtype=np.uint32).view(np.uint8) \
            .reshape(k, 4) if k else 0
        rec[:, 6:10] = r.integers(0, 3, (k, 4))
        return rec.tobytes()

    def rle(n):
        out = bytearray()
        while len(out) < n:
            out += bytes([int(r.integers(256))]) * int(r.integers(20, 400))
        return bytes(out[:n])

    n = PER_TYPE * BLK
    return {"text": text(n), "xml": xmlish(n), "code": codeish(n),
            "records": records(n), "rle": rle(n)}


def seq_stats(comp: bytes):
    seqs = jb.parse_sequences(comp)
    nseq = len(seqs)
    lit = sum(s[0] for s in seqs)
    mbytes = sum(s[2] for s in seqs)
    mls = [s[2] for s in seqs if s[2] > 0]
    hist = np.histogram(mls, bins=[4, 8, 16, 32, 40, 64, 128, 1 << 20])[0] \
        if mls else np.zeros(7, int)
    return nseq, lit, mbytes, hist


def main():
    data = typed_blocks()
    # optional device level argument (e.g. 12 = deep-rank tiers);
    # default matches the original hc=8 (level 8/9 class) probe
    lvls = [int(a) for a in sys.argv[1:] if a.isdigit()]
    dev_level = lvls[0] if lvls else 9
    hc, deep = jb.level_params(dev_level)
    enc = jax.jit(jax.vmap(functools.partial(jb._encode_block, blk=BLK,
                                             hc=hc, deep=deep)))
    print(f"{'type':8s} {'devL%-3d' % dev_level:>8s} {'natHC2':>8s} "
          f"{'natHC9':>8s} {'natHC12':>8s}   dev/HC9  dev/HC12  "
          f"seq-stats dev | HC9")
    for name, blob in data.items():
        nb = len(blob) // BLK
        blocks = np.frombuffer(blob[:nb * BLK], np.uint8).reshape(nb, BLK)
        lens = np.full(nb, BLK, np.int64)
        out, olen = enc(blocks, lens.astype(np.int32),
                        np.zeros(nb, np.int32))
        out, olen = np.asarray(out), np.asarray(olen)
        dev = int(olen.sum())
        nat = {}
        for lvl in (2, 9, 12):
            _, ol = native_compress_hc_blocks(blocks, lens, lvl)
            nat[lvl] = int(ol.sum())
        # sequence stats on block 0 of each stream
        dstats = seq_stats(bytes(out[0][:olen[0]]))
        cb, cl = native_compress_hc_blocks(blocks[:1], lens[:1], 9)
        nstats = seq_stats(bytes(cb[0][:cl[0]]))
        print(f"{name:8s} {dev:8d} {nat[2]:8d} {nat[9]:8d} {nat[12]:8d}"
              f"   {dev / nat[9]:7.3f}  {dev / nat[12]:7.3f}  "
              f"nseq {dstats[0]}/{nstats[0]} lit {dstats[1]}/{nstats[1]}"
              f" mb {dstats[2]}/{nstats[2]}")
        print(f"{'':8s} ml-hist dev {dstats[3].tolist()} "
              f"| HC9 {nstats[3].tolist()}  (bins 4,8,16,32,40,64,128+)")


if __name__ == "__main__":
    main()
