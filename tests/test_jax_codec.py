"""JAX vectorized codec tests (runs on CPU backend; same code compiles
for the GPU).  Cross-validation against the oracle block codec:
  * JAX-encoded blocks must decode with the oracle decoder.
  * oracle-encoded blocks must decode with the JAX device decoder.
"""

import random

import numpy as np
import pytest

from zig_lz4_tpu import compress_default, decompress_safe
from zig_lz4_tpu.constants import compress_bound
from zig_lz4_tpu.ops.jax_block import (
    MAX_SEQS,
    decode_blocks_jax,
    encode_blocks_jax,
    make_block_decoder,
    make_block_encoder,
    parse_sequences,
    seqs_to_arrays,
)

BLK = 4096  # small block size keeps CPU-backend compiles fast


def _pad(data: bytes, blk=BLK):
    buf = np.zeros(blk, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    return buf


def jax_encode(data: bytes, blk=BLK) -> bytes:
    enc = make_block_encoder(blk)
    out, n = enc(_pad(data, blk), np.int32(len(data)))
    return bytes(np.asarray(out)[:int(n)])


def jax_decode(comp: bytes, out_size: int, blk=BLK) -> bytes:
    dec = make_block_decoder(blk)
    ccap = compress_bound(blk)
    buf = np.zeros(ccap, np.uint8)
    buf[:len(comp)] = np.frombuffer(comp, np.uint8)
    lit, lsrc, ml, off, ns = seqs_to_arrays(parse_sequences(comp),
                                            MAX_SEQS(blk))
    out, n = dec(buf, lit, lsrc, ml, off, ns)
    return bytes(np.asarray(out)[:int(n)])


CASES = {
    "text": (b"the quick brown fox jumps over the lazy dog " * 80)[:3500],
    "rle": b"a" * 3000,
    "rle2": b"ab" * 1500,
    "random": bytes(random.Random(1).randrange(256) for _ in range(3000)),
    "low_entropy": bytes(random.Random(2).randrange(4) for _ in range(4000)),
    "ramp": bytes(i & 0xFF for i in range(4096)),
    "tiny": b"hello",
    "twelve": b"0123456789ab",
    "thirteen": b"0123456789abc",
    "empty": b"",
    "mixed": (b"abcabcabc" + bytes(random.Random(3).randrange(256)
                                   for _ in range(200))) * 10,
}


@pytest.mark.parametrize("name", list(CASES))
def test_jax_encode_oracle_decodes(name):
    data = CASES[name]
    comp = jax_encode(data)
    assert decompress_safe(comp, max(len(data), 1)) == data


@pytest.mark.parametrize("name", list(CASES))
def test_oracle_encode_jax_decodes(name):
    data = CASES[name]
    comp = compress_default(data)
    if not comp:
        assert data == b""
        return
    assert jax_decode(comp, len(data)) == data


@pytest.mark.parametrize("name", list(CASES))
def test_jax_roundtrip_self(name):
    data = CASES[name]
    comp = jax_encode(data)
    if comp:
        assert jax_decode(comp, len(data)) == data


def test_jax_ratio_close_to_oracle():
    # On realistic text the parallel candidate finder (sees all
    # positions) matches or beats the serial oracle.
    words = (b"the quick brown fox jumps over the lazy dog pack my box "
             b"with five dozen liquor jugs ").split()
    rng = random.Random(99)
    buf = bytearray()
    while len(buf) < 3800:
        buf += rng.choice(words) + b" "
    data = bytes(buf[:3800])
    assert len(jax_encode(data)) <= len(compress_default(data)) * 1.02


def test_jax_ratio_periodic_bounded():
    # Long-period data pays the _EXT_TRIPS match-length cap: matches
    # are split into consecutive sequences (wire-valid).  Bound the
    # cost until the periodic-run extension lands (round 2).
    data = CASES["text"]
    assert len(jax_encode(data)) <= len(compress_default(data)) * 2


def test_jax_rle_efficient():
    comp = jax_encode(CASES["rle"])
    assert len(comp) < 64  # RLE fast path produces long matches


def test_batched_encode_matches_single():
    enc = make_block_encoder(BLK)
    names = ["text", "rle", "low_entropy", "ramp"]
    blocks = np.stack([_pad(CASES[n]) for n in names])
    lens = np.array([len(CASES[n]) for n in names], np.int32)
    outs, ns = encode_blocks_jax(blocks, lens, BLK)
    for k, name in enumerate(names):
        single = jax_encode(CASES[name])
        batched = bytes(np.asarray(outs[k])[:int(ns[k])])
        assert batched == single


def test_batched_decode():
    names = ["text", "rle", "low_entropy", "ramp"]
    comps = [compress_default(CASES[n]) for n in names]
    ccap = compress_bound(BLK)
    nseq_cap = MAX_SEQS(BLK)
    bufs, lits, lsrcs, mls, offs, nss = [], [], [], [], [], []
    for c in comps:
        buf = np.zeros(ccap, np.uint8)
        buf[:len(c)] = np.frombuffer(c, np.uint8)
        lit, lsrc, ml, off, ns = seqs_to_arrays(parse_sequences(c), nseq_cap)
        bufs.append(buf); lits.append(lit); lsrcs.append(lsrc)
        mls.append(ml); offs.append(off); nss.append(ns)
    outs, lens = decode_blocks_jax(
        np.stack(bufs), np.stack(lits), np.stack(lsrcs),
        np.stack(mls), np.stack(offs), np.array(nss), BLK)
    for k, name in enumerate(names):
        assert bytes(np.asarray(outs[k])[:int(lens[k])]) == CASES[name]


def test_fuzz_jax_vs_oracle():
    rng = random.Random(777)
    for trial in range(25):
        n = rng.randrange(0, BLK)
        kind = trial % 4
        if kind == 0:
            data = bytes(rng.randrange(256) for _ in range(n))
        elif kind == 1:
            unit = bytes(rng.randrange(256)
                         for _ in range(rng.randrange(1, 12)))
            data = (unit * (n // max(len(unit), 1) + 1))[:n]
        elif kind == 2:
            data = bytes(rng.randrange(3) for _ in range(n))
        else:
            data = bytes(min(255, max(0, int(128 + 60 * np.sin(i / 9))))
                         for i in range(n))
        comp = jax_encode(data)
        assert decompress_safe(comp, max(n, 1)) == data, f"trial {trial}"


def test_jax_encode_with_dictionary():
    """History-prefix encoding: window = dict + data, start = len(dict).
    Output decodes with the oracle dict decoder and compresses far
    below raw size when data repeats the dictionary."""
    from zig_lz4_tpu import decompress_safe_using_dict
    dict_ = bytes(random.Random(9).randrange(256) for _ in range(1500))
    data = dict_[200:1200]  # pure dictionary content
    window = np.zeros(BLK, np.uint8)
    window[:len(dict_)] = np.frombuffer(dict_, np.uint8)
    window[len(dict_):len(dict_) + len(data)] = np.frombuffer(data, np.uint8)
    enc = make_block_encoder(BLK)
    out, n = enc(window, np.int32(len(dict_) + len(data)),
                 np.int32(len(dict_)))
    comp = bytes(np.asarray(out)[:int(n)])
    assert len(comp) < len(data) // 4
    assert decompress_safe_using_dict(comp, len(data), dict_) == data


def test_hc_mode_roundtrip_and_ratio():
    """HC-class finder (multi-key suffix-order sort + lazy deferral):
    output stays wire-decodable at every probe depth and within a few
    bytes of fast mode on tiny blocks.  (At 4KB the fast finder's
    chain extension already recovers most long matches; the HC win is
    a 64KB-scale effect -- +28%..34% corpus ratio on the bench corpus
    -- which CPU-backend unit tests cannot afford to compile.)  reference quality target: lz4hc.zig:514-681."""
    import numpy as np
    from zig_lz4_tpu import decompress_safe
    from zig_lz4_tpu.ops.jax_block import make_block_encoder
    blk = 4096
    rng = np.random.default_rng(11)
    text = (b"the quick brown fox jumps over the lazy dog -- " * 120)
    # three 64-byte templates sharing an 8-byte prefix, interleaved:
    # the nearest-2 fast finder sees only the short shared-prefix
    # matches while the lexicographic HC probes find the full-template
    # repeats -- the case HC exists for
    pre = bytes(rng.integers(0, 256, 8, dtype=np.uint8))
    tmpl = [pre + bytes(rng.integers(0, 256, 56, dtype=np.uint8))
            for _ in range(3)]
    adversarial = b"".join(tmpl[k % 3] for k in range(blk // 64))
    cases = [
        text[:blk],
        ((b"abcabcabcabc" + bytes(rng.integers(0, 256, 90,
                                               dtype=np.uint8))) * 36)[:blk],
        (text[:800] + bytes(rng.integers(0, 256, 100,
                                         dtype=np.uint8))) * 4,
        adversarial[:blk],
    ]
    enc0 = make_block_encoder(blk, 0)
    enc4 = make_block_encoder(blk, 4)
    tot0 = tot4 = 0
    for data in cases:
        data = data[:blk]
        buf = np.zeros(blk, np.uint8)
        buf[:len(data)] = np.frombuffer(data, np.uint8)
        o0, n0 = enc0(buf, np.int32(len(data)))
        o4, n4 = enc4(buf, np.int32(len(data)))
        c0 = bytes(np.asarray(o0)[:int(n0)])
        c4 = bytes(np.asarray(o4)[:int(n4)])
        assert decompress_safe(c4, blk) == data
        tot0 += len(c0)
        tot4 += len(c4)
    # tiny-block aggregate must stay within noise of the fast parse
    # (the corpus-level ratio WIN is asserted by
    # test_hc_ratio_beats_fast_64k and the bench, not here)
    assert tot4 <= tot0 * 1.05 + 8, (tot4, tot0)


def test_tpu_codec_level_registry():
    from zig_lz4_tpu.models.codec import get_codec
    c = get_codec("device9")
    assert c.level == 9
    data = b"registry level test " * 40
    assert c.decompress(c.compress(data), len(data)) == data


def test_hc_mode_with_dictionary():
    """HC finder + history prefix (start > 0): probes may select
    dictionary matches; output decodes with the oracle dict decoder."""
    import numpy as np
    from zig_lz4_tpu import decompress_safe_using_dict
    from zig_lz4_tpu.ops.jax_block import make_block_encoder
    rng = np.random.default_rng(21)
    dict_ = bytes(rng.integers(0, 256, 1500, dtype=np.uint8))
    data = dict_[100:600] + b"fresh tail bytes" + dict_[700:1100]
    window = np.zeros(BLK, np.uint8)
    window[:len(dict_)] = np.frombuffer(dict_, np.uint8)
    window[len(dict_):len(dict_) + len(data)] = np.frombuffer(
        data, np.uint8)
    enc = make_block_encoder(BLK, 4)
    out, n = enc(window, np.int32(len(dict_) + len(data)),
                 np.int32(len(dict_)))
    comp = bytes(np.asarray(out)[:int(n)])
    assert len(comp) < len(data) // 3
    assert decompress_safe_using_dict(comp, len(data), dict_) == data


def test_fuzz_hc_history_roundtrip():
    """Fuzz the HC parse (probes + fallback + post-parse extension /
    absorb, round 3) across content kinds and random history splits:
    every stream must decode bit-exact with the oracle dict decoder.
    The extension pass moves/drops selections after the greedy parse,
    so this guards its coverage-repair invariants (disjoint matches,
    valid trimmed tails) under start > 0 too.  The extension only runs
    at deep levels (>= 10), so the
    fuzz encoder uses a deep config (hc=4, deep=1) to keep the
    extension + absorb + deep-rank paths under fuzz."""
    import numpy as np
    from zig_lz4_tpu import decompress_safe_using_dict, decompress_safe
    from zig_lz4_tpu.ops.jax_block import make_block_encoder

    enc = make_block_encoder(BLK, 4, 1)   # deep: extension pass runs
    rng = random.Random(4242)
    nprng = np.random.default_rng(4242)
    for trial in range(20):
        kind = trial % 4
        n = rng.randrange(64, BLK)
        if kind == 0:      # template repeats (long matches, absorb-y)
            unit = bytes(nprng.integers(0, 256, rng.randrange(30, 70),
                                        dtype=np.uint8))
            data = (unit * (n // len(unit) + 1))[:n]
        elif kind == 1:    # code-like line salad
            lines = [bytes(nprng.integers(32, 127, rng.randrange(20, 50),
                                          dtype=np.uint8))
                     for _ in range(4)]
            data = b"\n".join(lines[rng.randrange(4)]
                              for _ in range(n // 20))[:n]
        elif kind == 2:    # low-entropy bytes
            data = bytes(rng.randrange(3) for _ in range(n))
        else:              # incompressible
            data = bytes(nprng.integers(0, 256, n, dtype=np.uint8))
        hist = rng.randrange(0, min(800, BLK - n))
        dict_ = bytes(nprng.integers(0, 256, hist, dtype=np.uint8)) \
            if hist else b""
        window = np.zeros(BLK, np.uint8)
        if hist:
            window[:hist] = np.frombuffer(dict_, np.uint8)
        window[hist:hist + n] = np.frombuffer(data, np.uint8)
        out, olen = enc(window, np.int32(hist + n), np.int32(hist))
        comp = bytes(np.asarray(out)[:int(olen)])
        if hist:
            got = decompress_safe_using_dict(comp, n, dict_)
        else:
            got = decompress_safe(comp, n)
        assert got == data, f"trial {trial} (kind {kind}, hist {hist})"
