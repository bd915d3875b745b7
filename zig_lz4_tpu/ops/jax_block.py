"""Device LZ4 block codec -- vectorized JAX/XLA implementation.

This is NOT a port of the reference's serial loops.  LZ4 coding is
re-cast onto data-parallel primitives: multi-operand ``lax.sort`` for
every data-dependent movement (grouping, merging), packed ``cummax`` /
``cumsum`` forward and reverse fills for broadcasting per-sequence
fields to bytes, and elementwise / roll arithmetic for the rest.  The
hot path has no gathers and no floats: the sort-instead-of-gather
choice was made on the accelerator the codec was first written for,
and whether it still wins on the GPU waits to be measured there
(ROADMAP Queue 1).

ENCODE (``make_block_encoder``), per block, vmapped over blocks:
  1. ONE stable sort groups positions by their 4-byte string (fast
     mode) or orders them 8-byte-lexicographically (HC mode, hc > 0).
     u32 windows at i+4..i+4W and a backward window ride along, so
     exact match lengths (to 4+4W+3) and backward extension come from
     CONTIGUOUS compares against sorted-order neighbors -- an exact
     nearest-match finder (fast) or a suffix-array-class longest
     -match finder (HC), vs the reference's lossy 4096-entry hash
     probe (src/lz4.zig:292-447) / hash-chain walk (lz4hc.zig:514).
  2. Unbounded lengths for capped chains (RLE / periodic data) via a
     reverse packed-cummax over same-offset runs; HC mode adds
     one-step lazy deferral.
  3. Parse: levels <= 9 run an EXACT greedy parse over the full
     position domain (a lax.scan over K-wide position chunks with an
     unrolled in-chunk select -- sequential semantics, vector
     execution across the vmapped batch); the deep levels 10-12 run
     a PRICE-AWARE backward DP over the same candidates first (see
     _PRICE_DP / run_dp) and the greedy scan then reconstructs the
     DP's chosen path.
  4. Emission entirely in the position domain: sequence boundaries,
     output offsets, and literal destinations come from packed
     cummax fills + cumsums; each match's covered bytes publish its
     five header bytes and ml-escape middles; ONE 2-operand grand
     sort IS the dense output (lit-escape middles + the tail header
     ride a ~blk/255-row pool).  No scatter, no gather, no ncap
     compaction sorts.

DECODE lives in ops/jax_decode.py: the byte-serial parse and LZ77
chain resolution run on the host (C++ native), and the device
reconstructs each block with one parity-keyed merge (the T-map
engine) or, as explicit options, the fragment engines.

Wire format identical to the oracle in ops/block.py; tests
cross-decode all backends.  reference wire behavior: src/lz4.zig
(format constants :12-44, decoder :89-251).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
from jax import lax

from ..constants import compress_bound

# Persistent compilation cache: the device codec compiles one program
# per (blk, hc, deep, batch) configuration, so every process after the
# first starts warm.  JAX reads JAX_COMPILATION_CACHE_DIR itself; only
# when it is unset does the cache go to a fixed path in the checkout
# (the path is part of each entry's key, so it must not move).
if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".jax_cache"))

__all__ = [
    "make_block_encoder", "make_block_decoder",
    "encode_blocks_jax", "decode_blocks_jax", "parse_sequences",
    "seqs_to_arrays", "MAX_SEQS",
]

#: carried u32 windows -> exact match lengths up to 4 + 4*_W + 3.
#: Each halving of W loses ~1.7% ratio; the ride-along operands'
#: device cost on the GPU is not measured yet.
_W = 8
#: greedy-parse chunk width (positions per scan step)
_K = 32
#: HC lazy deferral depth: True = two-step (emit up to 2 literals to
#: reach a strictly-more-profitable match), False = one-step.
_LAZY2 = True
#: HC positional fallback probes (one extra stable 4-byte grouping
#: sort recovering short gap matches the lex orders miss); ratio
#: effect measured in experiments/hc_ratio_gap.py.
_FALLBACK = True
#: scan unroll factor for the greedy parse
_UNROLL = 8
#: post-parse same-offset extension: pool rows / byte budget (HC mode;
#: 0 disables).  See the `_EXT_POOL` block in _encode_block.  512/32
#: produces output byte-identical to 1024/64 on all five content types
#: of the bench corpus, at a smaller pool.
_EXT_POOL = 512
_EXT_BYTES = 32
#: price-aware parse (deep levels 10-12): replace greedy selection +
#: lazy deferral with a backward byte-cost DP over the exact candidate
#: set (the device analog of the reference's optimal parser,
#: lz4hc.zig:1068-1391 with the price model :466-486).  Suffix costs
#: are non-increasing (any parse of suffix i restricted to i+1 stays
#: valid: drop a literal, or shorten the leading match by one -- a
#: 4-byte match degrades to >= as-cheap literals), so pricing ONLY the
#: full length of each position's best candidate is optimal over the
#: candidate set; truncation never needs separate prices.
_PRICE_DP = True
#: DP literal cost (x256 scale).  256 (exact for runs < 15) beats 257
#: (amortized-escape biased) by 11B on 'code' (typed 4x64KB blocks)
#: with everything else within +-2B -- the escape bias pushed the DP
#: into marginal matches -- so the exact value wins.
_DP_LITC = 256
#: DP cost ring size: match jumps longer than _DP_R are priced at
#: their truncated length (reconstruction still takes the full
#: length -- only the price of rare > _DP_R-byte matches is
#: approximated, and emission merges same-offset continuations).
_DP_R = 512
#: extension/parse iterations.  None = auto by level: OFF for levels
#: <= 9 (deep == 0) and 1 for the deep levels 10-12.  At L9 the pass
#: buys only +0.12% corpus ratio, so the throughput levels skip it;
#: the deep levels keep it for the per-type win ('code' content
#: truncation 62-65% -> 0.2%).  Its device cost on the GPU is not
#: measured yet.  Set an int to force a count at every level (probe
#: hook).
_EXT_ITERS = None


def _bits(v: int) -> int:
    return max(int(v).bit_length(), 1)


def device_encoder_supports(blk: int) -> bool:
    """True when ``blk``-byte windows fit the emission pack geometry:
    PB-prefixed hi/lo fills need _bits(cap)+_bits(blk) <= 40 and the
    lit-middle pool packs need _bits(blk/255)+_bits(cap) <= 31 --
    holds through 256KB windows (the pool-pack bound trips first, at
    512KB); 512KB-4MB frame blocks route to the host codec."""
    cap_bits = _bits(compress_bound(blk) + 2)
    return (cap_bits + 9 <= 31
            and cap_bits - 9 <= 31 - _bits(blk)
            and _bits(max(blk // 255 + 8, 8) + 2) + cap_bits <= 31)


# (the decoder support predicates live in ops/jax_decode.py)


# =====================================================================
# ENCODE
# =====================================================================

def fast_params(accel: int) -> tuple[int, int]:
    """Map the fast-mode acceleration knob to (W, probes).

    The reference's acceleration skips match-finder probes
    (src/lz4.zig:292, :332 -- ``step = searchMatchNb >> 6``); the
    device encoder has no serial probe loop, so the speed/ratio trade
    lives in the sort operands instead: the LCP window count W (each
    halving loses ~1.7% ratio) and the probe count (second
    sorted-order neighbor).  accel=1 -> (8, 2) full quality;
    2 -> (4, 2); 4 -> (2, 1); >= 8 -> (1, 1)."""
    accel = max(int(accel), 1)
    if accel <= 1:
        return _W, 2
    if accel == 2:
        return 4, 2
    if accel <= 4:
        return 2, 1
    return 1, 1


def _encode_block(data, n, start, *, blk: int, stage: int = 0,
                  W: int = _W, hc: int = 0, deep: int = 0,
                  fast_probes: int = 2):
    """Compress one block with optional history prefix.

    data: uint8[blk] window = [history/dictionary bytes | new data]
    n:    int32 total valid length of the window
    start:int32 index where emission begins; positions below ``start``
          are history (dictionary or previous blocks in linked mode):
          matched against but never re-emitted.
    hc:   0 = fast mode: single-key grouping sort, nearest-2
          candidates (greedy, reference src/lz4.zig:292-447 class).
          >= 1 = HC mode: TWO-key (8-byte lexicographic) sort turns
          the finder into a suffix-array-class matcher -- the hc
          nearest sorted-order neighbors in EACH direction are probed
          with exact LCPs and the longest match wins, plus one-step
          lazy deferral.  Reference semantics target: lz4hc.zig
          hash-chain search (:514-681) quality at vector cost.
    deep: 0 = off.  1..3 = optimal-class long-match discovery
          (levels 10-12): EXACT prefix-doubled ranks (suffix-array
          construction, Manber-Myers, 8-key rounds) extend the
          lexicographic order
          to 128 / 256 / 1024 bytes and provide exact long-match
          length TIERS -- rank_d[i] == rank_d[j] if and only if the
          d-byte prefixes are byte-identical, so (unlike hashing) a
          tier can never claim a false match.  This closes the
          measured ratio gap on long-match data, where the fine
          windows cap LCP measurement at 39 bytes and all long
          candidates look alike (experiments/hc_ratio_gap.py: the
          'code' content type was 2.7x native HC9 without it).
          Reference semantics target: the optimal parser's long-match
          quality, lz4hc.zig:1068-1391.

    Returns (out uint8[cap], out_len int32).
    """
    cap = compress_bound(blk)
    # selected matches are disjoint and >= 4 bytes -> at most blk//4;
    # +2 slots for the tail literal sequence and padding
    ncap = blk // 4 + 2

    # emission packs are ((pos+1) << 9) | byte -- positions <= cap
    assert _bits(cap + 2) + 9 <= 31, "block too large for packed fills"
    BIG = jnp.int32(1 << 28)

    i32 = jnp.int32
    n = jnp.asarray(n, i32)
    start = jnp.asarray(start, i32)
    idx = lax.broadcasted_iota(i32, (blk, 1), 0).squeeze(-1)

    # zero bytes past n so padded reads are deterministic
    b = jnp.where(idx < n, data.astype(jnp.int32), 0)

    max_sort_ml = 4 + 4 * W + 3

    # u32 little-endian windows at i, i+4, ..., i+4W (contiguous)
    ext = 4 * (W + 1)
    bp = jnp.pad(b.astype(jnp.uint32), (0, ext + 4))
    su = (bp[:blk + ext] | (bp[1:blk + ext + 1] << 8)
          | (bp[2:blk + ext + 2] << 16) | (bp[3:blk + ext + 3] << 24))
    # positions without 4 valid bytes are poisoned to the max key so
    # they sort last; validity is re-checked on idx_s below, which
    # also rejects genuine 0xFFFFFFFF strings colliding with poison
    s0 = jnp.where(idx > n - 4, jnp.uint32(0xFFFFFFFF), su[:blk])
    wins = [su[4 * k:4 * k + blk] for k in range(1, W + 1)]
    # backward window: bytes b[i-2..i-1] as LE u16 (high byte = b[i-1];
    # a 4-byte window gains ~0 ratio)
    bb = jnp.pad(b.astype(jnp.uint32), (2, 2))
    wb16 = bb[:blk] | (bb[1:blk + 1] << 8)
    pack_iw = blk <= 65536
    if pack_iw:
        side = ((idx.astype(jnp.uint32) << 16) | wb16,)
    else:
        side = (idx, wb16.astype(jnp.uint16))

    # --- deep mode: exact prefix-doubled ranks (see docstring) ---
    tier_list = []                  # [(L, position-domain op)] nested
    if deep:
        def shl(x, k):
            """x[i+k] with -1 fill past the end (shorter-suffix rows;
            any false tier equality among tail rows is voided by the
            ml <= n - 5 - idx clamp below)."""
            if k >= blk:
                return jnp.full((blk,), -1, i32)
            return jnp.concatenate([x[k:], jnp.full((k,), -1, i32)])

        def ranksN(keys):
            """Exact rank (equivalence class id) of each position
            under the N-key order: one sort + rank cumsum + unsort."""
            ops_ = lax.sort(keys + (idx,), num_keys=len(keys))
            srt, idxs = ops_[:-1], ops_[-1]
            newg = jnp.zeros((blk,), bool)
            for k_ in srt:
                newg = newg | (k_ != jnp.concatenate([k_[:1], k_[:-1]]))
            newg = jnp.where(idx == 0, True, newg)
            r_s = jnp.cumsum(newg.astype(i32))
            _, r_ = lax.sort((idxs, r_s), num_keys=1)
            return r_

        # 8-KEY doubling rounds, first rank straight off the byte
        # windows (32-byte order in one sort pair): fewer rank sorts
        # than a 4-key ladder at the same final depth and the same
        # ratio; whether the wider comparators pay for the saved sorts
        # on the GPU is not measured yet.
        r = ranksN((s0,) + tuple(wins[:7]))             # 32-byte rank
        if deep == 1:               # 128-byte grand order (L10)
            tier_list = [(32 * (k + 1), shl(r, 32 * k))
                         for k in range(4)]
            NK = 4
        elif deep == 2:             # 256-byte grand order (L11)
            tier_list = [(32 * (k + 1), shl(r, 32 * k))
                         for k in range(8)]
            NK = 8
        else:                       # 1024-byte grand order (L12)
            tier_list = [(32 * (k + 1), shl(r, 32 * k))
                         for k in range(7)]
            r2 = ranksN(tuple(op for _L, op in tier_list) + (shl(r, 224),))
            tier_list += [(256 * (k + 1), shl(r2, 256 * k))
                          for k in range(4)]
            NK = 4
        group_keys = tuple(op for _L, op in tier_list[-NK:])
    if stage == 11:     # profiling hook: rank-tier construction only
        acc = s0.astype(jnp.int32)
        for _L, op in tier_list:
            acc = acc + op
        return (jnp.zeros((cap,), jnp.uint8),
                jnp.sum(acc).astype(jnp.int32))

    # fast: group by the 4-byte string, stable -> sorted-order
    # neighbors are the NEAREST previous occurrences.  HC: add the
    # next 4 bytes as a second key -> 8-byte lexicographic order, so
    # sorted-order neighbors (both directions) carry the LONGEST
    # common prefixes (suffix-array property).
    # hc >= 1: 8-byte lex order plus a third key (12-byte order): the
    # operand already rides, and the extra key sharpens long-match
    # discovery.
    # deep >= 1: the grouping keys are the deepest rank + its shifts
    # (4 * depth bytes of exact lexicographic order); the fine
    # windows and the shallower rank tiers ride as operands.
    if deep:
        ops = lax.sort(group_keys + (s0,) + side + tuple(wins)
                       + tuple(op for _L, op in tier_list[:-NK]),
                       num_keys=NK, is_stable=True)
        s0_s = ops[NK]
        base = NK + 1
    else:
        nkeys = 3 if hc else 1
        ops = lax.sort((s0,) + ((wins[0], wins[1]) if hc else ()) + side
                       + tuple(wins), num_keys=nkeys, is_stable=True)
        s0_s = ops[0]
        base = nkeys
    if pack_iw:
        idx_s = (ops[base] >> 16).astype(i32)
        wb_s = ops[base] & 0xFFFF
        base += 1
    else:
        idx_s = ops[base]
        wb_s = ops[base + 1].astype(jnp.uint32)
        base += 2
    wins_s = ops[base:base + W]
    tier_sorted = []                # [(L, sorted-domain op)] nested
    if deep:
        tier_sorted = list(zip(
            [L for L, _ in tier_list],
            list(ops[base + W:]) + list(ops[0:NK])))

    if stage == 12:     # profiling hook: + the grand grouping sort
        acc = idx_s + s0_s.astype(jnp.int32) + wb_s.astype(jnp.int32)
        for wk in wins_s:
            acc = acc + wk.astype(jnp.int32)
        for _L, op_s in tier_sorted:
            acc = acc + op_s
        return (jnp.zeros((cap,), jnp.uint8),
                jnp.sum(acc).astype(jnp.int32))

    t_pos = jnp.arange(blk, dtype=i32)

    def cand_at(shift, env):
        """Candidate + exact LCP + backward-extension count vs the
        shift-th sorted-order neighbor sharing the 4-byte string --
        contiguous compares in sorted order, no gathers.  Negative
        shifts probe the other lexicographic direction (HC mode);
        candidates at LATER positions are rejected explicitly.
        ``env`` = (idx_s, s0_s, wins_s, wb_s, tier_sorted) of the
        grouping sort being probed (primary lex order, or the
        fallback 4-byte grouping below).
        Returns (cand, total ml, fine ml, tier index, back count);
        in deep mode the tier chain measures EXACT long-match lower
        bounds (rank equality at nested depths) past the fine
        windows' 39-byte ceiling."""
        idx_s, s0_s, wins_s, wb_s, tier_sorted = env
        edge = (t_pos >= shift) if shift > 0 else (t_pos < blk + shift)
        ok = (edge & (idx_s <= n - 4)
              & (jnp.roll(idx_s, shift) <= n - 4)
              & (s0_s == jnp.roll(s0_s, shift)))
        ck = jnp.roll(idx_s, shift)
        ok = ok & (ck < idx_s) & (idx_s - ck <= 65535)
        mlk = jnp.full((blk,), 4, i32)
        still = ok
        for wk in wins_s:
            prev = jnp.roll(wk, shift)
            x = wk ^ prev
            eq = x == 0
            pb = jnp.where((x & 0xFF) == 0,
                           jnp.where((x & 0xFFFF) == 0,
                                     jnp.where((x & 0xFFFFFF) == 0,
                                               3, 2), 1), 0)
            mlk = mlk + jnp.where(still & eq, 4, 0) \
                      + jnp.where(still & ~eq, pb.astype(i32), 0)
            still = still & eq
        tier = jnp.zeros((blk,), i32)
        dml = jnp.zeros((blk,), i32)
        still_t = ok
        for tk, (L, op_s) in enumerate(tier_sorted):
            takes = still_t & (op_s == jnp.roll(op_s, shift))
            tier = jnp.where(takes, tk + 1, tier)
            dml = jnp.where(takes, L, dml)
            still_t = takes
        # backward bytes in common (suffix of the 2 bytes before i)
        bx = (wb_s ^ jnp.roll(wb_s, shift)).astype(jnp.int32)
        bk = jnp.where((bx & 0xFF00) != 0, 0,
                       jnp.where(bx != 0, 1, 2))
        return (jnp.where(ok, ck, -1),
                jnp.where(ok, jnp.maximum(mlk, dml), 0),
                jnp.where(ok, mlk, 0), tier, jnp.where(ok, bk, 0))

    env = (idx_s, s0_s, wins_s, wb_s, tier_sorted)
    if hc:
        # longest match among the hc nearest lex neighbors each way;
        # ties prefer the nearest (smallest-offset) candidate
        shifts = [s_ for k_ in range(1, hc + 1) for s_ in (k_, -k_)]
    else:
        # nearest and second-nearest previous occurrence: the second
        # often carries the longer (periodic) offset when a nearer
        # duplicate 4-gram interrupts a long-match chain (probes=1
        # drops it -- the acceleration trade, fast_params)
        shifts = list(range(1, max(fast_probes, 1) + 1))
    cand_s, ml_s, mlf_s, tier_s, bk_s = cand_at(shifts[0], env)
    for s_ in shifts[1:]:
        ck, mk, mf, tk_, kk_ = cand_at(s_, env)
        if hc:
            better = (mk > ml_s) | ((mk == ml_s) & (ck > cand_s))
        else:
            better = mk > ml_s
        cand_s = jnp.where(better, ck, cand_s)
        ml_s = jnp.where(better, mk, ml_s)
        mlf_s = jnp.where(better, mf, mlf_s)
        tier_s = jnp.where(better, tk_, tier_s)
        bk_s = jnp.where(better, kk_, bk_s)
    if stage == 1:
        return (jnp.zeros((cap,), jnp.uint8),
                jnp.sum(cand_s + ml_s + bk_s).astype(jnp.int32))

    # --- unsort: back to position order (ONE packed operand --
    # every extra sort operand costs a full permutation pass) ---
    # pack: cand+1 (19b) | fine ml (6b, <= 39) | tier (4b) | back (2b)
    assert _bits(blk) + 12 <= 31, "block too large for candidate pack"
    pk_s = jnp.where(cand_s >= 0,
                     (((cand_s + 1) << 12) | (mlf_s << 6)
                      | (tier_s << 2) | bk_s), 0)
    _, pk_u = lax.sort((idx_s, pk_s), num_keys=1)
    cand = (pk_u >> 12) - 1
    mlf = (pk_u >> 6) & 63
    tier = (pk_u >> 2) & 15
    back = pk_u & 3
    ml = mlf
    for tk, (L, _op) in enumerate(tier_sorted):
        ml = jnp.where(tier == tk + 1, jnp.maximum(mlf, L), ml)

    if hc and _FALLBACK:
        # --- FALLBACK probes: nearest-previous by 4-byte group ------
        # The lexicographic orders above sort equal-prefix groups by
        # SUFFIX CONTENT, so the +-hc probes can see only later
        # positions (or out-of-window ones) and miss the short
        # gap-filling matches a positional hash chain finds trivially
        # -- measured as 10-30x more literal bytes than native HC9
        # (experiments/hc_ratio_gap.py at L12: text 3690 vs 273
        # lit/blk, code 1810 vs 210).  One extra STABLE single-key
        # grouping sort (the fast finder's order: equal 4-byte groups
        # are index-ordered, so roll(1/2) IS the nearest previous
        # occurrence) recovers them; its candidate wins only when
        # strictly longer.  reference analog: every hash-chain probe
        # starts from the positionally nearest occurrence,
        # lz4hc.zig:571-622.
        ops2 = lax.sort((s0,) + side + tuple(wins), num_keys=1,
                        is_stable=True)
        s0_s2 = ops2[0]
        if pack_iw:
            idx_s2 = (ops2[1] >> 16).astype(i32)
            wb_s2 = ops2[1] & 0xFFFF
            b2 = 2
        else:
            idx_s2 = ops2[1]
            wb_s2 = ops2[2].astype(jnp.uint32)
            b2 = 3
        env2 = (idx_s2, s0_s2, ops2[b2:b2 + W], wb_s2, [])
        c2, m2, mf2, _t2, k2 = cand_at(1, env2)
        c2b, m2b, mf2b, _t2b, k2b = cand_at(2, env2)
        b2x = m2b > m2
        c2 = jnp.where(b2x, c2b, c2)
        m2 = jnp.where(b2x, m2b, m2)
        mf2 = jnp.where(b2x, mf2b, mf2)
        k2 = jnp.where(b2x, k2b, k2)
        pk2 = jnp.where(c2 >= 0,
                        (((c2 + 1) << 12) | (mf2 << 6) | k2), 0)
        _, pk2_u = lax.sort((idx_s2, pk2), num_keys=1)
        cand2 = (pk2_u >> 12) - 1
        mlf2 = (pk2_u >> 6) & 63
        back2 = pk2_u & 3
        fb_better = mlf2 > ml
        cand = jnp.where(fb_better, cand2, cand)
        mlf = jnp.where(fb_better, mlf2, mlf)
        tier = jnp.where(fb_better, 0, tier)
        back = jnp.where(fb_better, back2, back)
        ml = jnp.where(fb_better, mlf2, ml)

    if stage == 2:
        return (jnp.zeros((cap,), jnp.uint8),
                jnp.sum(cand + ml + back).astype(jnp.int32))

    valid = (cand >= 0) & (idx <= n - 13)
    mlf = jnp.where(valid, mlf, 0)
    ml = jnp.where(valid, ml, 0)
    off = jnp.where(valid, idx - cand, 1 << 20)

    # --- exact unbounded extension of capped match chains ---
    # If position i's match is capped at the sort-carried window and
    # position i+1 matches at the same offset, then exactly
    # ml_true[i] = 1 + ml_true[i+1].  Same-offset runs collapse via a
    # reverse packed cummax carrying (position, boundary ml): long
    # matches (RLE, periodic data, big repeats) get exact lengths with
    # one scan.  A match is "capped" (possibly underestimated) when
    # the fine windows saturated OR its length came from a rank tier
    # (true lcp is in [tier, next tier)).
    capped = valid & ((mlf >= max_sort_ml - 3) | (ml > mlf))
    off_next = jnp.concatenate([off[1:], jnp.full((1,), 1 << 21, i32)])
    valid_next = jnp.concatenate([valid[1:], jnp.zeros((1,), bool)])
    link = capped & valid_next & (off_next == off)
    bnd = ~link
    # boundary pack also carries the boundary row's OWN capped bit:
    # a row whose chain ends at a capped boundary may still be
    # underestimated (the post-parse extension below needs to know)
    assert _bits(blk) + 12 <= 31, "block too large for boundary pack"
    pk = jnp.where(bnd, ((blk - 1 - idx) << 12)
                   | (capped.astype(i32) << 11) | jnp.minimum(ml, 2047),
                   -1)
    f = lax.cummax(pk, reverse=True)
    e = (blk - 1) - (f >> 12)
    bml = f & 2047
    cap_end = valid & (f >= 0) & (((f >> 11) & 1) == 1)
    ml = jnp.where(capped, jnp.maximum((e - idx) + bml, ml), ml)

    ml = jnp.minimum(ml, jnp.maximum(n - 5 - idx, 0))
    is_match = valid & (ml >= 4) & (idx >= start)
    use_dp = bool(deep) and _PRICE_DP
    if use_dp:
        # --- price-aware parse: backward byte-cost DP ---------------
        # Shortest path over the position DAG with edges i -> i+1
        # (one literal, LITC) and i -> i+ml[i] (the full best match,
        # 3 header bytes + ml-escape bytes).  Computed as a REVERSE
        # scan over KD-position chunks: within a chunk the literal
        # chain collapses to one suffix-cummin over A[k] = price[k] +
        # cost[k + jmp[k]] + k*LITC, and within-chunk match edges
        # (jump >= 4 -> chain depth <= KD/4) settle in KD/4 + 1
        # monotone relaxation rounds of one (KD,)-gather + cummin
        # each.  The carry is a _DP_R-entry ring of exact suffix
        # costs; bytes past n ride every path identically (matches
        # are clamped to end before n - 4), so the phantom-literal
        # constant cancels out of all comparisons.  Reconstruction =
        # the greedy scan below with is_match := take (follow literal
        # edges to the first position whose DP choice is its match).
        # reference semantics: lz4hc.zig:1068-1391 (compressOptimal),
        # price model :466-486; divergence: literal-run escape bytes
        # (every 255 past 14) are not priced -- runs < 15 are priced
        # exactly and longer runs under-price by ~1/255.
        SCD = 256                       # cost scale (sub-byte pricing)
        LITC = _DP_LITC                 # 1 byte + amortized escape
        KD = _K if blk >= _K else blk
        RD = min(_DP_R, blk)
        stepsD = blk // KD
        INF_D = jnp.int32(1 << 28)
        karr = jnp.arange(KD, dtype=i32)
        nround = KD // 4 + 1

        def run_dp(ml_c, im_c):
            """(take[], trunc18[]) of the backward DP over candidates
            (ml_c, im_c); re-run after the extension pass updates
            lengths.  Matches longer than the ring are priced at
            their TRUNCATED length (the full-length escape bytes
            against a ring-bounded jump would make a 64KB RLE match
            look worse than literals; the overcharge is one +3 header
            per RD bytes, and reconstruction takes the full length
            regardless).

            Besides the full length, each match also prices ONE
            truncated option: exactly 18 bytes (the longest
            escape-free match -- ml >= 19 pays a 4th header byte).
            Suffix costs are non-increasing, so longer truncations
            are dominated by the full length at equal header cost;
            the 18-cut is the single point where a shorter jump is
            strictly CHEAPER, and it wins precisely when the trimmed
            bytes are absorbed downstream for free (cost[i+18] ==
            cost[i+ml]) -- the reference optimal parser gets this
            from pricing every length (lz4hc.zig:1149-1311).  Its
            read is a static shift, so it costs no extra one-hot."""
            jmp_d = jnp.minimum(ml_c, RD)
            mlesc_d = jnp.where(jmp_d - 4 >= 15,
                                1 + jnp.maximum(jmp_d - 19, 0) // 255,
                                0)
            price_d = SCD * (3 + mlesc_d)
            kcol = jnp.arange(KD, dtype=i32)[None, :]
            rcol = jnp.arange(RD, dtype=i32)[None, :]

            tr_ok = RD >= 18        # 18-cut needs an 18-deep ring

            def dstep(ring, xs):
                # All data-dependent reads are small one-hot
                # select-reduces, NOT gathers (the gather-free choice;
                # a jnp.take variant is not measured on the GPU yet).
                # The index matrices are round-invariant
                # (jumps don't change), so they build once per step;
                # ring reads (jumps past the chunk) reduce once per
                # step, in-chunk reads ((KD, KD) one-hot) per round.
                pr, jm, im = xs
                tgt = karr + jm
                oh_ring = (tgt[:, None] - KD) == rcol       # (KD, RD)
                rd_ring = jnp.sum(jnp.where(oh_ring, ring[None, :], 0),
                                  axis=1)
                oh_in = tgt[:, None] == kcol                # (KD, KD)
                in_chunk = tgt < KD
                im_tr = im & (jm > 18) if tr_ok else \
                    jnp.zeros_like(im)
                pr_tr = 3 * SCD
                T = KD * LITC + ring[0]     # all-literals-to-carry
                est = T - karr * LITC

                def rd_of(est):
                    rd_in = jnp.sum(jnp.where(oh_in, est[None, :], 0),
                                    axis=1)
                    return jnp.where(in_chunk, rd_in, rd_ring)

                def rd18_of(est):
                    return jnp.concatenate([est, ring])[18:18 + KD]

                for _r in range(nround):
                    A = jnp.where(im, pr + rd_of(est) + karr * LITC,
                                  INF_D)
                    if tr_ok:
                        A = jnp.minimum(A, jnp.where(
                            im_tr, pr_tr + rd18_of(est) + karr * LITC,
                            INF_D))
                    sfx = lax.cummin(A, reverse=True)
                    est = jnp.minimum(sfx, T) - karr * LITC
                nxt = jnp.concatenate([est[1:], ring[:1]])
                a_full = pr + rd_of(est)
                if tr_ok:
                    a_tr = jnp.where(im_tr, pr_tr + rd18_of(est),
                                     INF_D)
                    tr_k = im_tr & (a_tr < a_full)
                    best = jnp.minimum(a_full, a_tr)
                else:
                    tr_k = jnp.zeros_like(im)
                    best = a_full
                take_k = im & (best <= LITC + nxt)
                ring = jnp.concatenate([est, ring[:RD - KD]])
                return ring, (take_k, tr_k)

            # carry derives from an input so its varying-axes type
            # matches the scan body's outputs under shard_map
            ring0 = jnp.zeros((RD,), i32) + ml_c[0] * 0
            _, (takes, trs) = lax.scan(
                dstep, ring0,
                (price_d.reshape(stepsD, KD), jmp_d.reshape(stepsD, KD),
                 im_c.reshape(stepsD, KD)), reverse=True)
            return takes.reshape(blk), trs.reshape(blk)

        is_match, _tr18 = run_dp(ml, is_match)
        # apply the DP's 18-cut: the trimmed match drops its escape
        # byte; trimmed rows leave the capped-chain extension alone
        # (re-extending would just re-pay the escape)
        ml = jnp.where(_tr18, jnp.minimum(ml, 18), ml)
        cap_end = cap_end & ~_tr18
    if hc and not use_dp:
        # two-step lazy deferral (post chain-extension, exact
        # lengths): emit 1-2 literals instead of matching here when a
        # strictly-more-profitable match starts at i+1 or i+2
        # (reference analog: the HC lazy/lazy2 retries,
        # lz4hc.zig:744-829).  Cascades are suppressed in one
        # fixpoint-style pass: a position whose TARGET also intends
        # to defer keeps its own match; the 2-step defer additionally
        # requires i+1 not to compete (no match there, or it defers
        # to the same longer match via its own 1-step test).
        def sh(x, k, fill):
            z = jnp.full((k,), fill, x.dtype)
            return jnp.concatenate([x[k:], z])

        ml1, im1 = sh(ml, 1, 0), sh(is_match, 1, False)
        g1 = im1 & (ml1 > ml + 1)
        if _LAZY2:
            ml2, im2 = sh(ml, 2, 0), sh(is_match, 2, False)
            g2 = im2 & (ml2 > ml + 2)
            d0 = g1 | g2              # optimistic defer intent
            d0_1, d0_2 = sh(d0, 1, False), sh(d0, 2, False)
            defer = is_match & ((g1 & ~d0_1)
                                | (g2 & ~d0_2 & (d0_1 | ~im1)))
        else:
            g1_1 = sh(g1, 1, False)
            defer = is_match & g1 & ~g1_1
        is_match = is_match & ~defer
    if stage == 3:
        return (jnp.zeros((cap,), jnp.uint8),
                jnp.sum(jnp.where(is_match, ml + back, 0))
                .astype(jnp.int32))

    # --- EXACT greedy parse over the FULL position domain ---
    # Semantics of the serial encoder's main loop (take the candidate
    # at the lowest position not covered by the previous match), run
    # as a scan over K-wide position chunks with an unrolled in-chunk
    # select.  No candidate pruning at all: positions are already in
    # order, so no compaction sorts are needed either.
    E = idx + ml
    K = _K if blk >= _K else blk
    steps = blk // K
    base = jnp.arange(steps, dtype=i32) * K

    def gstep(endv, xs):
        e, m, b0 = xs
        sels = []
        for kk in range(K):
            s = m[kk] & (b0 + kk >= endv)
            endv = jnp.where(s, e[kk], endv)
            sels.append(s)
        return endv, jnp.stack(sels)

    def run_greedy(Ev):
        _, selc = lax.scan(gstep, jnp.zeros_like(n),
                           (Ev.reshape(steps, K),
                            is_match.reshape(steps, K), base),
                           unroll=_UNROLL)
        return selc.reshape(blk)

    chosen = run_greedy(idx + ml)
    if stage == 4:
        return (jnp.zeros((cap,), jnp.uint8),
                jnp.sum(jnp.where(chosen, idx, 0)).astype(jnp.int32))

    ext_iters = _EXT_ITERS if _EXT_ITERS is not None else (1 if deep
                                                           else 0)
    if hc and _EXT_POOL and ext_iters:
        # --- post-parse exact extension + one-pass absorb -----------
        # The chain-extension above fires only when position i+1
        # SELECTED the same offset; inside long repeats the
        # suffix-order probes often pick a different, equally capped
        # candidate, so the chain breaks and the capped match stays
        # underestimated -- measured on 'code' content as 62-65% of
        # emitted matches truncated, ~10% of the block in lost
        # extension bytes, ~ALL of it running PAST the next chosen
        # match's start.  Recover
        # serial-parser semantics in two steps: (1) pool the chosen
        # matches whose effective end is capped and measure each TRUE
        # end with gathered 4-byte compares at its own offset; (2)
        # repair coverage in ONE pass -- the running end of the
        # repaired parse is simply the exclusive running max of the
        # extended ends over chosen rows (independent of keep/drop
        # decisions), so each overlapped match is either dropped
        # (fully covered) or MOVED to its trimmed start, where its
        # tail -- at the same offset, already end-exact -- remains a
        # valid match.  Pool overflow or budget exhaustion only costs
        # ratio, never correctness.  Reference analog: serial parsers
        # measure ends exactly before advancing (lz4hc.zig:514-681).
        # pool scales with window size (a 256KB window carries ~4x the
        # chosen matches of the 64KB tuning point)
        P = min(_EXT_POOL * max(blk // 65536, 1), blk)
        offs4 = jnp.arange(0, 16, 4, dtype=i32)
        exted = jnp.zeros((blk,), bool)

        def extend_chosen(chosen, ml, exted):
            """Pool the capped, not-yet-extended chosen ends and
            measure their exact extensions; returns updated (ml,
            exted).  16 bytes per round: one (P, 4)-shaped u32 gather
            per side (fewer, larger gathers -- dispatch dominates at
            this P)."""
            elig = chosen & cap_end & ~exted
            keyx = jnp.where(elig, idx, BIG)
            capv = jnp.clip(n - 5 - (idx + ml), 0, _EXT_BYTES)
            kx, Ep, offp, capp = lax.sort((keyx, idx + ml, off, capv),
                                          num_keys=1)
            i_p, Ep, offp, capp = kx[:P], Ep[:P], offp[:P], capp[:P]
            pool_ok = i_p < BIG
            e_p = jnp.zeros((P,), i32)
            alive = pool_ok & (capp > 0)
            for _ in range(max(_EXT_BYTES // 16, 1)):
                base_p = Ep + e_p
                ia = jnp.clip(base_p[:, None] + offs4, 0, blk - 1)
                ib = jnp.clip((base_p - offp)[:, None] + offs4, 0,
                              blk - 1)
                xw = jnp.take(su, ia) ^ jnp.take(su, ib)     # (P, 4)
                eqw = xw == 0
                pbw = jnp.where(
                    (xw & 0xFF) == 0,
                    jnp.where((xw & 0xFFFF) == 0,
                              jnp.where((xw & 0xFFFFFF) == 0,
                                        3, 2), 1), 0).astype(i32)
                adv = jnp.zeros((P,), i32)
                still = jnp.ones((P,), bool)
                for w in range(4):
                    adv = adv + jnp.where(
                        still, jnp.where(eqw[:, w], 4, pbw[:, w]), 0)
                    still = still & eqw[:, w]
                adv = jnp.minimum(adv, capp - e_p)
                adv = jnp.where(alive, adv, 0)
                e_p = e_p + adv
                alive = alive & still & (e_p < capp)
            tgtp = jnp.where(pool_ok, i_p, blk)
            ml = ml.at[tgtp].add(jnp.where(pool_ok, e_p, 0),
                                 mode='drop')
            exted = exted.at[tgtp].set(True, mode='drop')
            return ml, exted

        # ext_iters > 1: re-run the parse between extension passes so
        # freshly exposed positions select their own full-length
        # candidates (serial-parser reselection) instead of keeping
        # trimmed tails; in DP mode the price DP itself re-runs on
        # the EXTENDED lengths (capped matches were under-priced on
        # the first pass).  The final pass still goes through the
        # absorb below.
        for it in range(ext_iters):
            ml, exted = extend_chosen(chosen, ml, exted)
            if it < ext_iters - 1:
                if use_dp:
                    is_match, t18 = run_dp(ml, valid & (ml >= 4)
                                           & (idx >= start))
                    ml = jnp.where(t18, jnp.minimum(ml, 18), ml)
                    cap_end = cap_end & ~t18
                chosen = run_greedy(idx + ml)

        # one-pass absorb: prevcov = exclusive running max of extended
        # ends over chosen rows.  keep/drop decisions cannot change it
        # (a dropped match's end never exceeds the running max), so a
        # single fill settles all cascades.
        Ev = idx + ml
        fC = lax.cummax(jnp.where(chosen, Ev, 0))
        prevcov = jnp.concatenate([jnp.zeros((1,), i32), fC[:-1]])
        s_new = jnp.maximum(idx, prevcov)
        keep = chosen & (Ev - s_new >= 4)
        movedv = keep & (prevcov > idx)
        chosen = keep & ~movedv
        # moved matches: scatter (chosen, ml, off, back) to the
        # trimmed start rows.  Targets are the ends of the previous
        # kept matches -> strictly increasing -> collision-free, and
        # never equal to a surviving stationary row (that row would
        # itself have been moved).
        keym = jnp.where(movedv, idx, BIG)
        km, pcm, Em, offm = lax.sort((keym, prevcov, Ev, off),
                                     num_keys=1)
        km, pcm, Em, offm = km[:P], pcm[:P], Em[:P], offm[:P]
        okm = km < BIG
        tgt = jnp.where(okm, pcm, blk)
        chosen = chosen.at[tgt].set(True, mode='drop')
        ml = ml.at[tgt].set(jnp.where(okm, Em - pcm, 0), mode='drop')
        off = off.at[tgt].set(jnp.where(okm, offm, 0), mode='drop')
        back = back.at[tgt].set(0, mode='drop')
    if stage == 9:   # post-extension/absorb profiling hook (valid at
        #              every level: ext_iters == 0 returns the
        #              pre-extension parse checksum)
        return (jnp.zeros((cap,), jnp.uint8),
                jnp.sum(jnp.where(chosen, idx + ml, 0))
                .astype(jnp.int32))

    # ========== EMISSION: position-domain fills + ONE grand sort ====
    # Every output byte is published by exactly one row: literal bytes
    # by their own source position, all five header bytes of a
    # sequence (token / lit-escape remainder / offset lo+hi / ml
    # remainder) and the ml-escape middles by the >=4 positions its
    # match COVERS, and the (rare) lit-escape middles plus the tail
    # header by a ~blk/255-row pool.  Sequence boundaries, output
    # offsets and per-byte roles all come from packed cummax fills and
    # cumsums over the position domain -- the ncap compaction sorts
    # and the literal-destination merge of the round-1 design are
    # gone: 5 sorts traded for ~14 fills, a trade that waits to be
    # measured on the GPU.
    PB = _bits(blk)                  # idx+1, E+1, blk-idx fit PB bits
    S2 = 31 - PB                     # payload width for PB-prefixed packs
    # hi chunks (field >> 9) of cap-bounded fields must fit S2 bits
    assert _bits(cap + 2) - 9 <= S2, "block too large for emission fills"
    M2 = (1 << S2) - 1

    def shiftr(x, fill):
        """x shifted one position right (exclusive forward fill)."""
        return jnp.concatenate([jnp.full((1,), fill, x.dtype), x[:-1]])

    def shiftl(x, fill):
        """x shifted one position left (exclusive reverse fill)."""
        return jnp.concatenate([x[1:], jnp.full((1,), fill, x.dtype)])

    E = idx + ml
    ch = chosen

    # (E, off) of the last chosen match at <= i: both packs lead with
    # E+1 (strictly increasing over chosen rows) so they agree on rows
    fEh = lax.cummax(jnp.where(ch, ((E + 1) << 8) | (off >> 8), -1))
    fEl = lax.cummax(jnp.where(ch, ((E + 1) << 8) | (off & 0xFF), -1))
    lastE_in = jnp.where(fEh >= 0, (fEh >> 8) - 1, -1)
    lastOff_in = ((fEh & 0xFF) << 8) | (fEl & 0xFF)
    fEh_x, fEl_x = shiftr(fEh, -1), shiftr(fEl, -1)
    lastE_x = jnp.where(fEh_x >= 0, (fEh_x >> 8) - 1, -1)
    lastOff_x = ((fEh_x & 0xFF) << 8) | (fEl_x & 0xFF)

    # chain-link detection: previous chosen ends exactly here with the
    # same offset -> this selection continues a longer physical match
    link = ch & (lastE_x == idx) & (lastOff_x == off)
    head = ch & ~link

    # (start, off) of the next chosen match at >= i (reverse fills)
    fSh = lax.cummax(jnp.where(ch, ((blk - idx) << 8) | (off >> 8), -1),
                     reverse=True)
    fSl = lax.cummax(jnp.where(ch, ((blk - idx) << 8) | (off & 0xFF),
                               -1), reverse=True)
    fSh_n, fSl_n = shiftl(fSh, -1), shiftl(fSl, -1)
    nextStart = jnp.where(fSh_n >= 0, blk - (fSh_n >> 8), BIG)
    nextOff = ((fSh_n & 0xFF) << 8) | (fSl_n & 0xFF)
    is_end = ch & ~((nextStart == E) & (nextOff == off))

    # E of the nearest chain-run end at >= i -> merged match end
    fMh = lax.cummax(jnp.where(is_end,
                               ((blk - idx) << S2) | (E >> 9), -1),
                     reverse=True)
    fMl = lax.cummax(jnp.where(is_end,
                               ((blk - idx) << S2) | (E & 0x1FF), -1),
                     reverse=True)
    EM = ((fMh & M2) << 9) | (fMl & 0x1FF)

    # --- per-head sequence fields (meaningful at head rows) ---
    prevEnd = jnp.maximum(lastE_x, start)     # previous sequence end
    lit_raw = idx - prevEnd
    backq = jnp.clip(jnp.minimum(jnp.minimum(back, lit_raw), idx - off),
                     0, None)
    backq = jnp.where(head, backq, 0)
    mml_h = (EM - idx) + backq                # merged + back-extended
    lit_len_h = lit_raw - backq
    lit_ext_h = jnp.where(lit_len_h >= 15,
                          1 + (lit_len_h - 15) // 255, 0)
    ml_ext_h = jnp.where(mml_h - 4 >= 15, 1 + (mml_h - 19) // 255, 0)
    seqlen_h = 1 + lit_ext_h + lit_len_h + 2 + ml_ext_h
    seqcost = jnp.where(head, seqlen_h, 0)
    cum = jnp.cumsum(seqcost)     # at i: total output of seqs with
    #                               head <= i (inclusive)
    if stage == 5:
        return (jnp.zeros((cap,), jnp.uint8),
                jnp.sum(cum + backq + EM).astype(jnp.int32))

    # --- head -> covered-byte fills ---
    fH = lax.cummax(jnp.where(head, (idx << 2) | backq, -1))
    lastHead = fH >> 2
    lastBq = fH & 3
    fLh = lax.cummax(jnp.where(head,
                               ((idx + 1) << S2) | (seqlen_h >> 9), -1))
    fLl = lax.cummax(jnp.where(head,
                               ((idx + 1) << S2) | (seqlen_h & 0x1FF),
                               -1))
    seqlen_f = ((fLh & M2) << 9) | (fLl & 0x1FF)
    fGh = lax.cummax(jnp.where(head,
                               ((idx + 1) << S2) | (mml_h >> 9), -1))
    fGl = lax.cummax(jnp.where(head,
                               ((idx + 1) << S2) | (mml_h & 0x1FF), -1))
    mml_f = ((fGh & M2) << 9) | (fGl & 0x1FF)

    # next head at >= i with its back-extension (literal upper bound)
    fN = lax.cummax(jnp.where(head, ((blk - idx) << 2) | backq, -1),
                    reverse=True)
    nh = jnp.where(fN >= 0, blk - (fN >> 2), BIG)
    nbq = jnp.where(fN >= 0, fN & 3, 0)
    lit_end_lim = jnp.minimum(nh - nbq, n)

    # --- literal classification + destination (pure position math) --
    covered = lastE_in > idx
    is_lit = (idx >= start) & (idx < n) & ~covered & (idx < lit_end_lim)
    LS = jnp.maximum(lastE_in, start)         # own literal-run start
    lit_len_i = lit_end_lim - LS
    lit_ext_i = jnp.where(lit_len_i >= 15,
                          1 + (lit_len_i - 15) // 255, 0)
    dest = cum + 1 + lit_ext_i + (idx - LS)
    if stage == 6:
        return (jnp.zeros((cap,), jnp.uint8),
                jnp.sum(jnp.where(is_lit, dest, 0)).astype(jnp.int32))

    # --- covered-byte header roles ---
    # A merged match covers [lastHead, EM_own) = ml2 >= 4 rows; by
    # rel = i - lastHead they publish token / lit-rem / off lo / off
    # hi / ml-rem / ml-escape middles.  Sequence output coordinates
    # derive from cum: at a covered byte, cum includes the own head,
    # so cum == out_start + seqlen (the sequence's output end).
    rel = idx - lastHead
    own_len = seqlen_f
    out_end = cum
    out_start_o = out_end - own_len
    ml_ext_o = jnp.where(mml_f - 4 >= 15, 1 + (mml_f - 19) // 255, 0)
    pos_off = out_end - 2 - ml_ext_o
    # invert lit_len + lit_ext from S = seqlen - 3 - ml_ext (exact:
    # S = 16 + 256q + r for lit_len = 15 + 255q + r, r < 255)
    S = own_len - 3 - ml_ext_o
    lit_ext_o = jnp.where(S >= 16, 1 + (S - 16) // 256, 0)
    lit_len_o = S - lit_ext_o
    lit_rem_o = jnp.clip(lit_len_o - 15 - 255 * (lit_ext_o - 1), 0,
                         254)
    ml_rem_o = jnp.clip(mml_f - 19 - 255 * (ml_ext_o - 1), 0, 254)
    token_o = (jnp.minimum(lit_len_o, 15) << 4) | jnp.minimum(
        mml_f - 4, 15)
    off_o = lastOff_in
    cm_o = jnp.maximum(ml_ext_o - 1, 0)

    key_cov = jnp.where(
        rel == 0, out_start_o,
        jnp.where((rel == 1) & (lit_ext_o >= 1),
                  out_start_o + lit_ext_o,
                  jnp.where(rel == 2, pos_off,
                            jnp.where(rel == 3, pos_off + 1,
                                      jnp.where((rel == 4)
                                                & (ml_ext_o >= 1),
                                                pos_off + 1 + ml_ext_o,
                                                jnp.where(
                                                    (rel >= 5)
                                                    & (rel - 5 < cm_o),
                                                    pos_off + rel - 3,
                                                    BIG))))))
    val_cov = jnp.where(
        rel == 0, token_o,
        jnp.where(rel == 1, lit_rem_o,
                  jnp.where(rel == 2, off_o & 0xFF,
                            jnp.where(rel == 3, off_o >> 8,
                                      jnp.where(rel == 4, ml_rem_o,
                                                255)))))

    # --- tail literal-only sequence (scalars) ---
    tail_start = jnp.maximum(jnp.max(jnp.where(ch, E, -1)), start)
    tail_lit = n - tail_start
    tail_ext = jnp.where(tail_lit >= 15, 1 + (tail_lit - 15) // 255, 0)
    tail_token = jnp.minimum(tail_lit, 15) << 4
    tail_rem = jnp.clip(tail_lit - 15 - 255 * (tail_ext - 1), 0, 254)
    total_cum = cum[blk - 1]
    out_len = total_cum + 1 + tail_ext + tail_lit

    # --- lit-escape-middle pool (plus tail middles) ---
    # counts are tiny (sum lit_len <= blk -> <= blk/255 + 1 middles);
    # anchors (sequences with middles) are compacted by one 2-operand
    # sort, pool positions by one tiny merge
    GP = max(blk // 255 + 8, 8)
    cl_h = jnp.where(head, jnp.maximum(lit_ext_h - 1, 0), 0)
    cum_cl = jnp.cumsum(cl_h) - cl_h
    first_pos_h = (cum - seqcost) + 1         # out_start + 1 at heads
    cl_tail = jnp.maximum(tail_ext - 1, 0)
    total_cl = jnp.sum(cl_h) + cl_tail
    # anchor rows: (cum_cl, first_pos - cum_cl + 1) packed; + tail
    S4 = _bits(cap + 2)              # payload width for pool packs
    assert _bits(GP + 2) + S4 <= 31, "block too large for pool packs"
    ak_pos = jnp.where(head & (cl_h > 0), cum_cl, BIG)
    av_pos = jnp.where(head & (cl_h > 0),
                       ((cum_cl + 1) << S4)
                       | (first_pos_h - cum_cl + 1), -1)
    tk = jnp.where(cl_tail > 0, jnp.sum(cl_h), BIG)[None]
    tv = ((jnp.sum(cl_h) + 1) << S4)[None] | \
        (total_cum + 2 - jnp.sum(cl_h))[None]
    aks, avs = lax.sort(
        (jnp.concatenate([ak_pos, tk]), jnp.concatenate([av_pos, tv])),
        num_keys=1)
    aks, avs = aks[:GP], avs[:GP]             # <= blk/270+1 anchors
    gi = jnp.arange(GP, dtype=i32)
    kk = jnp.concatenate([aks * 2, gi * 2 + 1])
    vv = jnp.concatenate([avs, jnp.full((GP,), -1, i32)])
    kks, vvs = lax.sort((kk, vv), num_keys=1, is_stable=True)
    fP = lax.cummax(vvs)
    pool_pos = (fP & ((1 << S4) - 1)) - 1 + (kks >> 1)
    isq = (kks & 1) == 1
    pk_pool = jnp.where(isq & ((kks >> 1) < total_cl) & (fP >= 0),
                        pool_pos, BIG)
    _, mid_pos = lax.sort((jnp.where(isq, kks >> 1, BIG), pk_pool),
                          num_keys=1)
    mid_pos = mid_pos[:GP]

    # --- grand placement: ONE sort IS the dense output ---
    k_data = jnp.where(is_lit, dest,
                       jnp.where(covered & (idx >= start), key_cov,
                                 BIG))
    v_data = jnp.where(is_lit, b, val_cov)
    tail_keys = jnp.stack([total_cum,
                           jnp.where(tail_ext >= 1,
                                     total_cum + tail_ext, BIG)])
    tail_vals = jnp.stack([tail_token, tail_rem])
    k8 = jnp.concatenate([k_data, mid_pos, tail_keys])
    v8 = jnp.concatenate([v_data, jnp.full((GP,), 255, i32),
                          tail_vals])
    k8s, vx = lax.sort((k8, jnp.where(k8 < BIG, v8, 0)), num_keys=1)
    # row count (blk + GP + 2) can sit a few bytes under cap; pad so
    # the output buffer always has the compress_bound shape
    vx = jnp.pad(vx, (0, max(cap - vx.shape[0], 0)))
    if stage == 7:
        return (jnp.zeros((cap,), jnp.uint8),
                jnp.sum(vx[:cap]).astype(jnp.int32))
    out = vx[:cap].astype(jnp.uint8)

    out_len = jnp.where(n == start, 0, out_len)
    return out, out_len


def level_params(level: int) -> tuple[int, int]:
    """Map a compression level to (hc probes, deep rank rounds).

    Levels <= 1: the fast nearest-2 finder.  Levels 2..9: suffix-order
    probes = level over the 12-byte lexicographic sort (ratio returns
    diminish past ~8; level 9 pays one extra probe pair).
    Levels 10..12: 8 probes over progressively deeper EXACT-rank
    orders -- 128 / 256 / 1024-byte lexicographic depth with exact
    long-match tiers (the device analog of the reference's optimal
    strategy levels, lz4hc.zig:72-86).  Every level is a distinct
    configuration; no silent aliasing."""
    level = int(level)
    if level <= 1:
        return 0, 0
    if level <= 9:
        return level, 0
    return 8, min(level - 9, 3)


def hc_probes(level: int) -> int:
    """Back-compat shim: probe depth only (see level_params)."""
    return level_params(level)[0]


@functools.lru_cache(maxsize=None)
def make_block_encoder(blk: int, hc: int = 0, deep: int = 0,
                       accel: int = 1):
    """Build a jitted encoder for windows of capacity ``blk`` bytes.

    Returns fn(data uint8[blk], n int32, start int32=0)
            -> (out uint8[bound], len).
    vmap over a leading axis for batched multi-block encode; pass a
    nonzero ``start`` for dictionary / linked-history encoding,
    ``hc`` > 0 for the HC-class finder and ``deep`` > 0 for the
    optimal-class long-match tiers (see _encode_block).  ``accel``
    (fast mode only, reference src/lz4.zig:292 compressFast(accel))
    trades ratio for speed via fast_params.
    """
    W, probes = fast_params(accel) if not hc else (_W, 2)
    fn = functools.partial(_encode_block, blk=blk, hc=hc, deep=deep,
                           W=W, fast_probes=probes)
    jfn = jax.jit(fn)

    def call(data, n, start=0):
        return jfn(data, n, jnp.asarray(start, jnp.int32))
    return call


@functools.lru_cache(maxsize=None)
def _batched_encoder(blk: int, hc: int = 0, deep: int = 0,
                     accel: int = 1):
    W, probes = fast_params(accel) if not hc else (_W, 2)
    fn = functools.partial(_encode_block, blk=blk, hc=hc, deep=deep,
                           W=W, fast_probes=probes)
    return jax.jit(jax.vmap(fn))


def encode_blocks_jax(blocks, lengths, blk: int, starts=None,
                      hc: int = 0, deep: int = 0, accel: int = 1):
    """Batched block encode: blocks uint8[B, blk], lengths int32[B],
    optional starts int32[B] (history/dictionary prefix lengths)."""
    import numpy as np
    if starts is None:
        starts = np.zeros(blocks.shape[0], np.int32)
    return _batched_encoder(blk, hc, deep, accel)(blocks, lengths,
                                                  starts)


# ---------------------------------------------------------------------
# DECODE: moved to ops/jax_decode.py (round 5 split -- no behavior
# change); every name is re-exported here so existing imports and the
# experiment/bench scripts keep working unchanged.
# ---------------------------------------------------------------------
from .jax_decode import (  # noqa: E402,F401
    MAX_SEQS, parse_sequences, seqs_to_arrays, _decode_block,
    _frag_geometry, device_frag_decoder_supports,
    device_win_decoder_supports, _decode_block_frags,
    _decode_block_frags_win, device_chase_decoder_supports,
    _decode_block_frags_chase, _batched_frag_decoder_chase,
    win_tier_config, _batched_frag_decoder_win, _batched_frag_decoder,
    decode_blocks_frags, resolve_fragments_py, make_block_decoder,
    _batched_decoder, decode_blocks_jax, resolve_tmap_py,
    device_tmap_decoder_supports, _decode_block_tmap,
    _batched_tmap_decoder)
