"""Device LZ4 block decoders -- the decode half of the device
codec (split out of jax_block.py, which keeps the encoder + price DP
and re-exports every name here for back-compat).

Host side: ``parse_sequences`` / ``resolve_fragments_py`` (and their
C++ native equivalents) turn a compressed block into fixed-shape
sequence or fragment tables; device side, four gather-free engines
reconstruct the bytes with parity-keyed merges (sorts) and packed
cummax fills:

  * ``_decode_block``          per-sequence pointer jumping (history /
                               dictionary decode, universal fallback)
  * ``_decode_block_frags``    byte-granular round-bounded merges
  * ``_decode_block_frags_win``  windowed merges (the shallow-tier
                               fast path, g=8/16 groups)
  * ``_decode_block_frags_chase``  pointer doubling (depth 2^k after
                               k merges -- the deep-tier engine)

The production engine is the T-map one-merge decoder
(``_decode_block_tmap``, fed by the native per-byte literal-source
resolver); the engines above remain as explicit options.

reference decode semantics: src/lz4.zig:89-251 (generic decoder),
:870-957 (streaming prefix continuation).  See jax_block.py's module
docstring for the sort-instead-of-gather choice that shaped these.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..constants import compress_bound


def _bits(v: int) -> int:
    return max(int(v).bit_length(), 1)


def MAX_SEQS(blk: int) -> int:
    """Worst-case sequence count for decoding a blk-byte block."""
    return blk // 4 + 2


# =====================================================================
# DECODE
# =====================================================================

def parse_sequences(comp: bytes, history_len: int = 0):
    """Host-side token parse: compressed block -> sequence arrays.

    Returns list of (lit_len, lit_comp_start, match_len, offset); the
    tail sequence has match_len == 0.  Validates structure and raises
    the block error taxonomy on corruption.  ``history_len`` extends
    the reachable window behind the block (streaming prefix or
    dictionary).  This is the cheap serial part of decode; the
    bandwidth-heavy reconstruction runs on device.
    """
    from ..errors import CorruptedData
    seqs = []
    ip, iend = 0, len(comp)
    op = 0
    while ip < iend:
        token = comp[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if ip >= iend:
                    raise CorruptedData("truncated literal length")
                x = comp[ip]
                ip += 1
                lit += x
                if x != 255:
                    break
        if ip + lit > iend:
            raise CorruptedData("literal run overruns input")
        lit_start = ip
        ip += lit
        op += lit
        if ip >= iend:
            seqs.append((lit, lit_start, 0, 0))
            break
        if ip + 2 > iend:
            raise CorruptedData("truncated offset")
        off = comp[ip] | (comp[ip + 1] << 8)
        ip += 2
        if off == 0 or off > op + history_len:
            raise CorruptedData(f"bad offset {off} at output pos {op}")
        ml = token & 15
        if ml == 15:
            while True:
                if ip >= iend:
                    raise CorruptedData("truncated match length")
                x = comp[ip]
                ip += 1
                ml += x
                if x != 255:
                    break
        ml += 4
        op += ml
        seqs.append((lit, lit_start, ml, off))
    return seqs


def seqs_to_arrays(seqs, nseq_cap: int):
    """Pack parsed sequences into fixed-shape arrays for the device."""
    import numpy as np
    ns = len(seqs)
    if ns > nseq_cap:
        raise ValueError(f"{ns} sequences exceed capacity {nseq_cap}")
    lit = np.zeros(nseq_cap, np.int32)
    lsrc = np.zeros(nseq_cap, np.int32)
    ml = np.zeros(nseq_cap, np.int32)
    off = np.ones(nseq_cap, np.int32)
    for k, (a, b_, c, d) in enumerate(seqs):
        lit[k], lsrc[k], ml[k], off[k] = a, b_, c, max(d, 1)
    return lit, lsrc, ml, off, np.int32(ns)


def _decode_block(comp, hist, lit_len, lit_src, mlen, off, nseq, *,
                  blk: int, nseq_cap: int, hcap: int):
    """Device reconstruction from parsed sequences -- gather-free.

    comp: uint8[ccap] compressed payload; hist: uint8[hcap] history /
    dictionary window logically preceding the output (offsets may
    reach into it); sequence arrays int32[nseq_cap].
    Returns (out uint8[blk], out_len int32).

    Strategy (all sorts + packed-cummax fills, no gathers):
      1. Merge-fill per-sequence fields onto output bytes.
      2. Literal bytes land via one monotone merge against comp.
      3. Self-overlapping matches (offset < length, e.g. RLE) resolve
         elementwise: ultimate in-sequence source = modular position
         before the match start.  No iteration.
      4. Remaining match bytes point strictly before their sequence;
         a while_loop of merge rounds resolves them with POINTER
         JUMPING (unresolved bytes adopt their target's pointer), so
         rounds <= log2(chain depth) + 1.  History bytes participate
         as pre-resolved rows at negative keys (linked/dict decode).
    reference decode semantics: src/lz4.zig:89-251.
    """
    i32 = jnp.int32
    q_idx = jnp.arange(nseq_cap, dtype=i32)
    live = q_idx < nseq
    lit_len = jnp.where(live, lit_len, 0)
    mlen = jnp.where(live, mlen, 0)
    off = jnp.where(live, off.astype(i32), 1)

    seg = lit_len + mlen
    seg_start = jnp.cumsum(seg) - seg          # output offset of seq
    out_len = jnp.sum(seg)

    PB = _bits(max(blk, comp.shape[0]) + hcap)
    PM = (1 << PB) - 1
    assert _bits(nseq_cap + 1) + PB <= 32, "block too large for fills"
    assert PB <= 17, "device decode supports blocks <= 64KB + history"
    BIG = jnp.int32(1 << 28)
    u32 = jnp.uint32
    qp = (q_idx + 1).astype(u32) << PB

    j = lax.broadcasted_iota(i32, (blk, 1), 0).squeeze(-1)

    # --- 1. merge-fill sequence fields onto output bytes ---
    kseq = jnp.where(live & (seg > 0), seg_start, BIG)
    a1 = jnp.where(live, qp | seg_start.astype(u32), 0)
    a2 = jnp.where(live, qp | lit_len.astype(u32), 0)
    a3 = jnp.where(live, qp | lit_src.astype(u32), 0)
    a4 = jnp.where(live, qp | off.astype(u32), 0)
    kk = jnp.concatenate([kseq, j])
    z = jnp.zeros((blk,), u32)
    tg = jnp.concatenate([jnp.zeros((nseq_cap,), i32),
                          jnp.ones((blk,), i32)])
    ks, tgs, f1, f2, f3, f4 = lax.sort(
        (kk, tg,
         jnp.concatenate([a1, z]), jnp.concatenate([a2, z]),
         jnp.concatenate([a3, z]), jnp.concatenate([a4, z])),
        num_keys=2, is_stable=True)
    f1, f2, f3, f4 = (lax.cummax(f1), lax.cummax(f2),
                      lax.cummax(f3), lax.cummax(f4))
    # dense extraction by output position
    kx = jnp.where(tgs == 1, ks, BIG)
    _, S, L, LS, O = lax.sort(
        (kx,
         (f1 & PM).astype(i32), (f2 & PM).astype(i32),
         (f3 & PM).astype(i32), (f4 & PM).astype(i32)), num_keys=1)
    S, L, LS, O = S[:blk], L[:blk], LS[:blk], O[:blk]
    rel = j - S
    is_lit = rel < L

    # --- 2. literal bytes via monotone merge against comp ---
    ccap = comp.shape[0]
    csrc = jnp.arange(ccap, dtype=i32)
    lq = jnp.where(is_lit, LS + rel, BIG)
    kms, tms, vms, pms = lax.sort(
        (jnp.concatenate([csrc, lq]),
         jnp.concatenate([jnp.zeros((ccap,), i32),
                          jnp.ones((blk,), i32)]),
         jnp.concatenate([(csrc << 8) | comp.astype(i32),
                          jnp.full((blk,), -1, i32)]),
         jnp.concatenate([jnp.zeros((ccap,), i32), j])),
        num_keys=2, is_stable=True)
    fv = lax.cummax(vms)
    lit_val = jnp.where((fv >> 8) == kms, fv & 0xFF, 0)
    kx2 = jnp.where(tms == 1, pms, BIG)
    _, litv = lax.sort((kx2, lit_val), num_keys=1)
    litv = litv[:blk]

    known = is_lit | (j >= out_len)
    value = jnp.where(is_lit & (j < out_len), litv, 0)

    # --- 3. self-overlap resolution (elementwise) ---
    # match starts at mstart = S + L; byte j copies from j - O; while
    # that lands inside the same match, fold modularly to before it.
    mstart = S + L
    srcp = j - O
    fold = (~known) & (srcp >= mstart)
    srcp = jnp.where(fold, mstart - O + ((j - mstart) % O), srcp)

    # --- 4. merge rounds with pointer jumping ---
    # Publishers: history rows (keys -hcap..-1, pre-resolved) + all
    # output rows (resolved -> value; unresolved -> their srcp, for
    # jumping).  srcp spans [-hcap, blk): publish shifted by hcap,
    # split hi/lo to fit packs.
    hk = jnp.arange(-hcap, 0, dtype=i32)
    hval = hist.astype(i32)

    def resolve_round(state):
        value, known, srcp, it = state
        pubv = jnp.where(known, (j << 8) | value, -1)
        su_ = srcp + hcap                    # [0, blk + hcap)
        pub_hi = jnp.where(~known, (j << 9) | (su_ >> 8), -1)
        pub_lo = jnp.where(~known, (j << 8) | (su_ & 0xFF), -1)
        qk = jnp.where(known, BIG, srcp)

        kr = jnp.concatenate([hk, j, qk])
        tr = jnp.concatenate([jnp.zeros((hcap,), i32),
                              jnp.zeros((blk,), i32),
                              jnp.ones((blk,), i32)])
        hi = jnp.concatenate([jnp.full((hcap,), -1, i32), pub_hi,
                              jnp.full((blk,), -1, i32)])
        lo = jnp.concatenate([jnp.full((hcap,), -1, i32), pub_lo,
                              jnp.full((blk,), -1, i32)])
        pr = jnp.concatenate([jnp.zeros((hcap,), i32), j, j])
        # value publication: packed with key+hcap so the leading field
        # stays non-negative and monotone over the history+out rows
        hv = jnp.concatenate([((hk + hcap) << 8) | hval,
                              jnp.where(known, ((j + hcap) << 8) | value,
                                        -1),
                              jnp.full((blk,), -1, i32)])

        krs, trs, hvs, his, los, prs = lax.sort(
            (kr, tr, hv, hi, lo, pr), num_keys=2, is_stable=True)
        fhv = lax.cummax(hvs)
        fhi = lax.cummax(his)
        flo = lax.cummax(los)

        isq = trs == 1
        hit_val = isq & ((fhv >> 8) == krs + hcap)
        got_val = fhv & 0xFF
        # target unresolved: adopt its srcp (pointer jump); hi/lo must
        # come from the same publisher row -- both packs lead with the
        # publisher's j, and fills pick the latest row <= query, which
        # is the same row for both (same anchor set).
        hit_jmp = (isq & ~hit_val & ((fhi >> 9) == krs)
                   & ((flo >> 8) == krs))
        jmp_su = ((fhi & 0x1FF) << 8) | (flo & 0xFF)

        kx3 = jnp.where(isq, prs, BIG)
        _, gv, gkv, gj, gjv = lax.sort(
            (kx3, got_val, hit_val.astype(i32), jmp_su,
             hit_jmp.astype(i32)), num_keys=1)
        gv, gkv = gv[:blk], gkv[:blk]
        gj, gjv = gj[:blk], gjv[:blk]

        newly = (~known) & (gkv == 1)
        value = jnp.where(newly, gv, value)
        known2 = known | newly
        srcp = jnp.where(known2, srcp,
                         jnp.where(gjv == 1, gj - hcap, srcp))
        return value, known2, srcp, it + 1

    def cond(state):
        _, known, _, it = state
        return (~jnp.all(known)) & (it < 20)

    value, known, _, _ = lax.while_loop(
        cond, resolve_round, (value, known, srcp, jnp.int32(0)))
    out = jnp.where(j < out_len, value, 0)
    return out.astype(jnp.uint8), out_len


def _frag_geometry(blk: int, fcap: int, fetch_cap: int):
    """Chunk layout for the fragment decoder's rank-prefixed packs.

    Fields (fdst < blk, fsrc, fper <= 65535, fphase < fper) ride the
    merge sort as CW-bit chunks prefixed by the fragment rank+1, plus
    one leftover chunk -- 5 value operands total.  fsrc is a FETCH
    coordinate (< fetch_cap) on LIT fragments but an OUT-space
    coordinate (< blk) on PER fragments, so its leftover width must
    cover BOTH -- sizing it by fetch_cap alone silently corrupted the
    pack whenever a quantized fetch buffer (bs/4) was smaller than
    the block at a wide-fcap tier (CW < bits(blk)); caught in round 5
    by a content-checksum mismatch on the 4MB device tier.
    Returns (CW, r1, r2, r3, r4) or None when the layout does not
    fit int32."""
    QB = _bits(fcap + 1)
    CW = 31 - QB
    r1 = max(_bits(blk) - CW, 0)
    r2 = max(_bits(max(fetch_cap, blk)) - CW, 0)
    r3 = max(16 - CW, 0)
    r4 = r3
    if CW < 1 or r1 + r2 + r3 + r4 > CW or _bits(fetch_cap) + 10 > 31:
        return None
    return CW, r1, r2, r3, r4


def device_frag_decoder_supports(blk: int, fcap: int | None = None,
                                 fetch_cap: int | None = None) -> bool:
    """True when the fragment decoder's pack geometry covers
    ``blk``-byte outputs fetching from ``fetch_cap`` source bytes
    (compressed payload + optional dictionary/history prefix)."""
    fcap = fcap or blk // 2
    fetch_cap = fetch_cap or compress_bound(blk)
    return (_frag_geometry(blk, fcap, fetch_cap) is not None
            and _bits(blk) + 10 <= 31)


def device_win_decoder_supports(blk: int, fcap: int | None = None,
                                fetch_cap: int | None = None) -> bool:
    """True when the WINDOWED fragment decoder's chunk packs cover
    this geometry (64KB blocks; 256KB outgrows the 16-bit chunk +
    publisher-rank int32 budget and stays on the byte-granular
    decoder)."""
    fcap = fcap or blk // 2
    fetch_cap = fetch_cap or compress_bound(blk)
    return (blk % 64 == 0
            and _frag_geometry(blk, fcap, fetch_cap) is not None
            and _bits(blk // 8 + 1) + 16 <= 31
            and _bits(fetch_cap + 1) + 9 <= 31)


def _decode_block_frags(comp, fdst, fsrc, fper, fphase, nfrag,
                        out_len, *, blk: int, fcap: int, rounds: int,
                        stage: int = 0):
    """Round-bounded device reconstruction from host-resolved
    fragments (see native lz4tpu_resolve_blocks).

    Every fragment maps output bytes to a source:
      LIT (fper == 0): out[fdst+k] = comp[fsrc+k]
      PER (fper > 0):  out[fdst+k] = out[fsrc + (fphase+k) % fper]
    ``comp`` is the fetch buffer -- the compressed payload, optionally
    with the dictionary/history window prepended (fsrc pre-shifted by
    the resolver's hist_len).

    All merges use PARITY-PACKED keys (publishers at 2k, queries at
    2k+1 -- unique keys, so no second sort key and no stable-sort
    cost) and rank-prefixed chunk packs, which carry fewer operands
    per merge than a field-per-operand layout.  reference decode
    semantics: src/lz4.zig:89-251.
    """
    i32 = jnp.int32
    BIG = jnp.int32(1 << 28)
    geo = _frag_geometry(blk, fcap, comp.shape[0])
    assert geo is not None, "fragment pack geometry does not fit"
    CW, r1, r2, r3, r4 = geo
    CM = (1 << CW) - 1
    fq = jnp.arange(fcap, dtype=i32)
    fl = fq < nfrag
    j = lax.broadcasted_iota(i32, (blk, 1), 0).squeeze(-1)

    # --- merge A: fill per-byte fragment params ---
    lefts = ((fdst >> CW) | ((fsrc >> CW) << r1)
             | ((fper >> CW) << (r1 + r2))
             | ((fphase >> CW) << (r1 + r2 + r3)))
    rank = (fq + 1) << CW

    def pk(part):
        return jnp.where(fl, rank | (part & CM), -1)

    kk = jnp.concatenate([jnp.where(fl, fdst * 2, BIG), j * 2 + 1])
    za = jnp.full((blk,), -1, i32)
    kks, pAs, pBs, pCs, pEs, pDs = lax.sort(
        (kk,
         jnp.concatenate([pk(fdst), za]),
         jnp.concatenate([pk(fsrc), za]),
         jnp.concatenate([pk(fper), za]),
         jnp.concatenate([pk(fphase), za]),
         jnp.concatenate([pk(lefts), za])),
        num_keys=1)
    fA, fB, fC, fE, fD = (lax.cummax(pAs), lax.cummax(pBs),
                          lax.cummax(pCs), lax.cummax(pEs),
                          lax.cummax(pDs))
    lf = fD & CM
    FD = (fA & CM) | ((lf & ((1 << r1) - 1)) << CW)
    FS = (fB & CM) | (((lf >> r1) & ((1 << r2) - 1)) << CW)
    FP = (fC & CM) | (((lf >> (r1 + r2)) & ((1 << r3) - 1)) << CW)
    FH = (fE & CM) | (((lf >> (r1 + r2 + r3))
                       & ((1 << r4) - 1)) << CW)
    ok = fA >= 0
    rel = (kks >> 1) - FD
    is_per = FP > 0
    t = jnp.where(is_per, FS + (FH + rel) % jnp.maximum(FP, 1),
                  FS + rel)
    t = jnp.where(ok, t, 0)
    if stage == 1:
        return (t + kks).astype(jnp.uint8)
    # extract byte rows back to output order
    isb = (kks & 1) == 1
    _, tp = lax.sort((jnp.where(isb, kks >> 1, BIG),
                      (t << 1) | is_per.astype(i32)), num_keys=1)
    T = tp[:blk] >> 1
    PERB = (tp[:blk] & 1) == 1
    live = j < out_len
    if stage == 2:
        return (T + PERB).astype(jnp.uint8)

    # --- merge B: literal bytes from the fetch buffer ---
    ccap = comp.shape[0]
    cs = jnp.arange(ccap, dtype=i32)
    qk = jnp.where(live & ~PERB, T * 2 + 1, BIG)
    # pb carries j+1 on EVERY byte row (dead queries included) so the
    # extraction below returns a dense j-ordered column
    kb, vb, pb = lax.sort(
        (jnp.concatenate([cs * 2, qk]),
         jnp.concatenate([((cs + 1) << 9) | comp.astype(i32),
                          jnp.full((blk,), -1, i32)]),
         jnp.concatenate([jnp.zeros((ccap,), i32), j + 1])),
        num_keys=1)
    fv = lax.cummax(vb)
    isq = (kb & 1) == 1
    hit = isq & ((fv >> 9) - 1 == (kb >> 1))
    _, litv = lax.sort((jnp.where(pb > 0, pb - 1, BIG),
                        jnp.where(hit, fv & 0xFF, 0)), num_keys=1)
    value = jnp.where(live & ~PERB, litv[:blk], 0)
    known = (~live) | ~PERB
    if stage == 3:
        return value.astype(jnp.uint8)

    # --- periodic rounds: known bytes publish, unresolved query T ---
    for _ in range(max(rounds, 0)):
        pubv = jnp.where(known, ((j + 1) << 9) | value, -1)
        qk2 = jnp.where(known, BIG, T * 2 + 1)
        kr, vr, pr = lax.sort(
            (jnp.concatenate([j * 2, qk2]),
             jnp.concatenate([pubv, jnp.full((blk,), -1, i32)]),
             jnp.concatenate([jnp.zeros((blk,), i32), j + 1])),
            num_keys=1)
        fvr = lax.cummax(vr)
        isq2 = (kr & 1) == 1
        got = isq2 & ((fvr >> 9) - 1 == (kr >> 1))
        _, rv = lax.sort((jnp.where(pr > 0, pr - 1, BIG),
                          jnp.where(got, fvr & 0xFF, -1)), num_keys=1)
        newly = (~known) & (rv[:blk] >= 0)
        value = jnp.where(newly, rv[:blk], value)
        known = known | newly

    out = jnp.where(live, value, 0)
    return out.astype(jnp.uint8)


def _decode_block_frags_win(comp, fdst, fsrc, fper, fphase, nfrag,
                            out_len, *, blk: int, fcap: int,
                            rounds: int, wins: int = 2,
                            pool: int = 512, lit_wins: int = 3,
                            lit_pool: int = 1024, g: int = 8):
    """WINDOWED fragment decoder -- the round-3 fast path.

    Same contract as _decode_block_frags, but each periodic round
    sorts ~blk/2.7 rows instead of 4*blk:

      * PUBLISHERS sit at every 8th position and carry an aligned
        16-byte window of the value state as rank-prefixed 16-bit
        chunk operands -- sort cost is nearly independent of operand
        count, so wide windows ride free.  Known-ness is a SENTINEL
        (-1 = unknown), so no separate flag state exists.
      * QUERIES are per 8-byte output GROUP: ``wins`` aligned windows
        cover the first source run, the last, and (wins >= 3) the
        first byte those two miss -- a group touching <= wins source
        runs resolves from window fetches alone.
      * Leftover bytes (tiny fragments / mid-group period wraps) ride
        a POOL of per-byte queries, applied back to the dense state
        with ONE pool-sized scatter per round (pool-sized, never
        blk-sized).  Uncovered-byte budgets on HC-class streams of
        the bench corpus: periodic side p90 < 120
        bytes at wins=2; literal side needs wins=3..4 on fast tiers
        and stays byte-granular (lit_wins=0) on the deep tier.

    SELF-VALIDATING: returns (out, ok).  ok=False when a pool
    overflowed or any live byte stayed unresolved; the caller
    re-routes those blocks to the byte-granular decoder or the host
    codec, so correctness never depends on the pool bounds.
    reference decode semantics: src/lz4.zig:89-251.

    ``g`` is the group/publisher stride: publishers sit at every
    g-th position carrying an aligned 2g-byte window (g 16-bit chunk
    operands + ceil(2g/16) validity-mask operands); queries are per
    g-byte output group.  g=16 halves the per-round sort rows
    (queries dominate) at the cost of wider (free-ish) operand rows
    and more pool pressure.
    """
    i32 = jnp.int32
    BIG = jnp.int32(1 << 28)
    G = g
    assert G in (8, 16), "windowed decoder supports g in (8, 16)"
    gsh = G.bit_length() - 1
    W = 2 * G                       # window bytes per publisher
    nmask = W // 16                 # 16-bit validity operands
    assert blk % 64 == 0, "windowed decoder needs blk % 64 == 0"
    NG = blk // G                   # output groups == publishers
    NP = NG
    ccap = comp.shape[0]
    P = pool
    assert _bits(NP + 1) + 16 <= 31, "chunk pack overflow (blk too large)"
    assert _bits(ccap + 1) + 9 <= 31, "fetch buffer too large"

    geo = _frag_geometry(blk, fcap, ccap)
    assert geo is not None, "fragment pack geometry does not fit"
    CW, r1, r2, r3, r4 = geo
    CM = (1 << CW) - 1
    fq = jnp.arange(fcap, dtype=i32)
    fl = fq < nfrag
    j = lax.broadcasted_iota(i32, (blk, 1), 0).squeeze(-1)

    # ---- merge A: per-byte fragment params (as the byte decoder) ---
    lefts = ((fdst >> CW) | ((fsrc >> CW) << r1)
             | ((fper >> CW) << (r1 + r2))
             | ((fphase >> CW) << (r1 + r2 + r3)))
    rank = (fq + 1) << CW

    def pk(part):
        return jnp.where(fl, rank | (part & CM), -1)

    kk = jnp.concatenate([jnp.where(fl, fdst * 2, BIG), j * 2 + 1])
    za = jnp.full((blk,), -1, i32)
    kks, pAs, pBs, pCs, pEs, pDs = lax.sort(
        (kk,
         jnp.concatenate([pk(fdst), za]),
         jnp.concatenate([pk(fsrc), za]),
         jnp.concatenate([pk(fper), za]),
         jnp.concatenate([pk(fphase), za]),
         jnp.concatenate([pk(lefts), za])),
        num_keys=1)
    fA, fB, fC, fE, fD = (lax.cummax(pAs), lax.cummax(pBs),
                          lax.cummax(pCs), lax.cummax(pEs),
                          lax.cummax(pDs))
    lf = fD & CM
    FD = (fA & CM) | ((lf & ((1 << r1) - 1)) << CW)
    FS = (fB & CM) | (((lf >> r1) & ((1 << r2) - 1)) << CW)
    FP = (fC & CM) | (((lf >> (r1 + r2)) & ((1 << r3) - 1)) << CW)
    FH = (fE & CM) | (((lf >> (r1 + r2 + r3))
                       & ((1 << r4) - 1)) << CW)
    ok_row = fA >= 0
    rel = (kks >> 1) - FD
    is_per = FP > 0
    t = jnp.where(is_per, FS + (FH + rel) % jnp.maximum(FP, 1),
                  FS + rel)
    t = jnp.where(ok_row, t, 0)
    isb = (kks & 1) == 1
    _, tp = lax.sort((jnp.where(isb, kks >> 1, BIG),
                      (t << 1) | is_per.astype(i32)), num_keys=1)
    T = tp[:blk] >> 1
    PERB = (tp[:blk] & 1) == 1
    live = j < out_len

    TB = _bits(max(blk, ccap) + 16)
    kidx = lax.broadcasted_iota(i32, (NG, G), 1)
    Tg_all = T.reshape(NG, G)

    def win_first(unres_g):
        """Aligned publisher index of the first not-yet-covered byte
        per group + per-byte (offset, coverage)."""
        m1 = jnp.min(jnp.where(unres_g, (kidx << TB) | Tg_all, BIG),
                     axis=1)
        A = jnp.where(m1 < BIG, (m1 & ((1 << TB) - 1)) >> gsh, BIG)
        Ab = jnp.broadcast_to(A[:, None], (NG, G)).reshape(blk)
        d = T - Ab * G
        c = (d >= 0) & (d < W)
        return A, d, c

    def win_last(unres_g):
        m2 = jnp.max(jnp.where(unres_g, (kidx << TB) | Tg_all, -1),
                     axis=1)
        Tlast = m2 & ((1 << TB) - 1)
        A = jnp.where(m2 >= 0,
                      jnp.maximum(Tlast - (G - 1), 0) >> gsh, BIG)
        Ab = jnp.broadcast_to(A[:, None], (NG, G)).reshape(blk)
        d = T - Ab * G
        c = (d >= 0) & (d < W)
        return A, d, c

    def windows_and_pool(unres, nwins, npool):
        """``nwins`` per-group windows + a pool of the leftovers.
        Returns ([(A, d, cov)], pool_j, pool_T, pool_alive)."""
        ug = unres.reshape(NG, G)
        A1, d1, c1 = win_first(ug)
        out = [(A1, d1, unres & c1)]
        cov = c1
        if nwins >= 2:
            A2, d2, c2 = win_last(ug)
            out.append((A2, d2, unres & c2))
            cov = cov | c2
        for _ in range(nwins - 2):
            Aw, dw, cw = win_first(ug & ~cov.reshape(NG, G))
            out.append((Aw, dw, unres & cw))
            cov = cov | cw
        uncovered = unres & ~cov
        pkx, pj_, pT_ = lax.sort(
            (jnp.where(uncovered, j, BIG), j, T), num_keys=1)
        alive = pkx[:npool] < BIG
        return (out, jnp.where(alive, pj_[:npool], blk),
                jnp.where(alive, pT_[:npool], 0), alive)

    def windowed_fetch(pub_ops, npubs, winset, pT, palive, npool):
        """One windowed merge: dense publishers + per-window group
        queries + pool queries -> per-slot chunk rows."""
        BK = jnp.int32(1 << 29)
        nw = len(winset)
        kq = jnp.concatenate(
            [jnp.arange(npubs, dtype=i32) * 2]
            + [jnp.where(A < BIG, A * 2 + 1, BK) for A, _d, _c in winset]
            + [jnp.where(palive, (pT >> gsh) * 2 + 1, BK)])
        slot = jnp.concatenate(
            [jnp.full((npubs,), BIG, i32)]
            + [jnp.arange(NG, dtype=i32) + w * NG for w in range(nw)]
            + [jnp.arange(npool, dtype=i32) + nw * NG])
        NQ = nw * NG + npool
        qz = jnp.full((NQ,), -1, i32)
        rows = [jnp.concatenate([op, qz]) for op in pub_ops]
        srt = lax.sort((kq, slot) + tuple(rows), num_keys=1)
        fills = [lax.cummax(x) for x in srt[2:]]
        es = lax.sort((srt[1],) + tuple(fills), num_keys=1)
        return [x[:NQ] & 0xFFFF for x in es[1:1 + len(pub_ops)]]

    def chunk_select(rows_, d):
        """Byte ``d`` (0..W-1) of a W-byte chunk row set."""
        ci = jnp.clip(d, 0, W - 1) >> 1
        ch = rows_[0]
        for c in range(1, W // 2):
            ch = jnp.where(ci == c, rows_[c], ch)
        return (ch >> ((d & 1) * 8)) & 0xFF

    def apply_windows(value, chunks, winset):
        """Resolve group bytes from their window fetches (literal
        path: the fetch buffer is static data, every byte known)."""
        for w, (A, d, cov) in enumerate(winset):
            rows_ = [jnp.broadcast_to(
                c[w * NG:(w + 1) * NG][:, None], (NG, G)).reshape(blk)
                for c in chunks]
            byte = chunk_select(rows_, d)
            newly = cov & (value < 0)
            value = jnp.where(newly, byte, value)
        return value

    # ---- literal fill ---------------------------------------------
    lit_unres = live & ~PERB
    if lit_wins:
        # windowed: comp publishers are static data, always known
        NPC = -(-ccap // G)
        assert _bits(NPC + 1) + 16 <= 31, "fetch chunk pack overflow"
        winL, pjL, pTL, palL = windows_and_pool(lit_unres, lit_wins,
                                                lit_pool)
        cpad = jnp.concatenate(
            [comp.astype(i32),
             jnp.zeros(((NPC + 2) * G - ccap,), i32)])
        Rc = cpad.reshape(NPC + 2, G)
        W16c = jnp.concatenate([Rc[:NPC], Rc[1:NPC + 1]], axis=1)
        cidx = jnp.arange(NPC, dtype=i32)
        ops_c = []
        for c in range(W // 2):
            ch = W16c[:, 2 * c] | (W16c[:, 2 * c + 1] << 8)
            ops_c.append(((cidx + 1) << 16) | ch)
        chL = windowed_fetch(ops_c, NPC, winL, pTL, palL, lit_pool)
        value = jnp.where(live, -1, 0)
        value = apply_windows(value, chL, winL)
        nwL = len(winL)
        prL = [c[nwL * NG:] for c in chL]
        pbyteL = chunk_select(prL, pTL & (G - 1))
        idxL = jnp.where(palL, pjL, blk)
        value = value.at[idxL].set(pbyteL, mode='drop')
    else:
        # byte-granular merge (always exact, no pool)
        cs = jnp.arange(ccap, dtype=i32)
        lit_q = jnp.where(lit_unres, T * 2 + 1, BIG)
        kb, vb, pb = lax.sort(
            (jnp.concatenate([cs * 2, lit_q]),
             jnp.concatenate([((cs + 1) << 9) | comp.astype(i32),
                              jnp.full((blk,), -1, i32)]),
             jnp.concatenate([jnp.zeros((ccap,), i32), j + 1])),
            num_keys=1)
        fv = lax.cummax(vb)
        isq = (kb & 1) == 1
        hit = isq & ((fv >> 9) - 1 == (kb >> 1))
        _, litv = lax.sort((jnp.where(pb > 0, pb - 1, BIG),
                            jnp.where(hit, fv & 0xFF, -1)), num_keys=1)
        value = jnp.where(live, -1, 0)
        value = jnp.where(lit_unres, litv[:blk], value)

    # ---- periodic rounds: windowed merges over output state -------
    # value >= 0 IS the known flag (sentinel -1 = unresolved); the
    # publisher chunks carry value & 0xFF plus a per-window KNOWN
    # MASK operand folded into the 9th chunk slot... the mask rides
    # as chunk operand 8 is NOT available (8 chunks carry 16 bytes),
    # so known-ness rides IN-BAND: unknown bytes publish 0 and a
    # 16-bit validity mask is packed as a ninth operand.
    per_unres = live & PERB
    winR, pjR, pTR, palR = windows_and_pool(per_unres, wins, P)
    pdR = pTR & (G - 1)
    pool_live = palR
    nwR = len(winR)

    pidx = jnp.arange(NP, dtype=i32)
    BK = jnp.int32(1 << 29)
    kq_static = jnp.concatenate(
        [pidx * 2]
        + [jnp.where(A < BIG, A * 2 + 1, BK) for A, _d, _c in winR]
        + [jnp.where(palR, (pTR >> gsh) * 2 + 1, BK)])
    slot_static = jnp.concatenate(
        [jnp.full((NP,), BIG, i32)]
        + [jnp.arange(NG, dtype=i32) + w * NG for w in range(nwR)]
        + [jnp.arange(P, dtype=i32) + nwR * NG])
    NQR = nwR * NG + P
    qzR = jnp.full((NQR,), -1, i32)

    for _ in range(max(rounds, 0)):
        vpad = jnp.concatenate([value, jnp.full((W,), -1, i32)])
        Rv = vpad.reshape(NP + 2, G)
        W16v = jnp.concatenate([Rv[:NP], Rv[1:NP + 1]], axis=1)
        pub_ops = []
        for c in range(W // 2):
            b0 = jnp.maximum(W16v[:, 2 * c], 0)
            b1 = jnp.maximum(W16v[:, 2 * c + 1], 0)
            pub_ops.append(((pidx + 1) << 16) | b0 | (b1 << 8))
        for m in range(nmask):
            maskp = jnp.zeros((NP,), i32)
            for d in range(16):
                maskp = maskp | ((W16v[:, 16 * m + d] >= 0)
                                 .astype(i32) << d)
            pub_ops.append(((pidx + 1) << 16) | maskp)

        rows = [jnp.concatenate([op, qzR]) for op in pub_ops]
        srt = lax.sort((kq_static, slot_static) + tuple(rows),
                       num_keys=1)
        fills = [lax.cummax(x) for x in srt[2:]]
        es = lax.sort((srt[1],) + tuple(fills), num_keys=1)
        nch = W // 2
        chunks = [x[:NQR] & 0xFFFF for x in es[1:1 + nch]]
        masks = [es[1 + nch + m][:NQR] & 0xFFFF for m in range(nmask)]

        def mask_bit(mrows, d):
            """Validity bit for window byte ``d`` (0..W-1)."""
            sel = mrows[0]
            for m in range(1, nmask):
                sel = jnp.where((d >> 4) == m, mrows[m], sel)
            return (sel >> (d & 15)) & 1

        for w, (A, d, cov) in enumerate(winR):
            rows_ = [jnp.broadcast_to(
                c[w * NG:(w + 1) * NG][:, None], (NG, G)).reshape(blk)
                for c in chunks]
            mrows = [jnp.broadcast_to(
                mk[w * NG:(w + 1) * NG][:, None],
                (NG, G)).reshape(blk) for mk in masks]
            byte = chunk_select(rows_, d)
            bit = mask_bit(mrows, jnp.clip(d, 0, W - 1))
            newly = cov & (value < 0) & (bit == 1)
            value = jnp.where(newly, byte, value)
        # pool: per-byte fetch + ONE dense scatter (sentinel known)
        prow = [c[nwR * NG:] for c in chunks]
        pmrows = [mk[nwR * NG:] for mk in masks]
        pbyte = chunk_select(prow, pdR)
        pbit = mask_bit(pmrows, pdR)
        pnew = pool_live & (pbit == 1)
        idx = jnp.where(pnew, pjR, blk)
        value = value.at[idx].set(pbyte, mode='drop')
        pool_live = pool_live & ~pnew

    ok = jnp.all(value >= 0)
    out = jnp.where(live & (value >= 0), value, 0)
    return out.astype(jnp.uint8), ok


def device_chase_decoder_supports(blk: int, fcap: int | None = None,
                                  fetch_cap: int | None = None) -> bool:
    """True when the CHASE decoder's packs cover this geometry.

    Needs the merge-A fragment pack (same as the byte decoder), a
    rank-chunk pack for tagged positions ((j+1) << CW | chunk with at
    least 1 chunk bit), and the 9-bit comp-fetch pack."""
    fcap = fcap or blk // 2
    fetch_cap = fetch_cap or compress_bound(blk)
    return (_frag_geometry(blk, fcap, fetch_cap) is not None
            and 31 - _bits(blk + 1) >= 4
            and _bits(fetch_cap + 1) + 9 <= 31)


def _decode_block_frags_chase(comp, fdst, fsrc, fper, fphase, nfrag,
                              out_len, *, blk: int, fcap: int,
                              dense: int = 2, doublings: int = 4,
                              qcap: int = 0):
    """POINTER-DOUBLING fragment decoder (round-3, v2 fast path).

    The windowed/byte decoders iterate over the VALUE state: one
    dependency level per round, so chain depth is bounded by a static
    round count and deep blocks fall to the host.  This decoder
    iterates over the POSITION state, which is fully known after
    merge A: every output byte's one-hop source ``T`` is a pure
    function of its covering fragment, so the final literal source of
    every byte is ``T`` composed with itself -- and composition
    doubles reachable depth per merge instead of adding 1.

      * merge A (unchanged): per-byte (T, PERB).  The chase state is
        a TAGGED position nx: output-space [0, blk) while the byte
        still points at another copy byte, comp-space [blk, blk+ccap)
        once it has resolved to a literal source (comp positions are
        fixpoints, so convergence is monotone and needs no flags).
      * ``dense`` doubling merges: publishers at EVERY position carry
        nx as rank-prefixed chunks; queries are the not-yet-converged
        bytes.  nx' [i] = nx[nx[i]] -- depth 2^k after k merges.
        2*blk rows, ~4 operands, no masks, no per-byte selects.
      * frontier compaction: bytes still unconverged (chains deeper
        than 2^dense -- measured rare) compact into a qcap-slot pool;
        ``doublings`` more merges run blk+qcap rows each, scattering
        pool progress back so composition keeps doubling.  Total
        reachable depth: 2^(dense + doublings).
      * final merge: every live byte fetches comp[nx - blk] exactly
        (per-byte rows, no pool to overflow).

    SELF-VALIDATING: returns (out, ok); ok=False iff any live byte
    failed to converge (frontier overflow or chain deeper than
    2^(dense+doublings)) -- stale positions can never produce wrong
    bytes, only unconverged ones, and those are detected exactly.
    reference decode semantics: src/lz4.zig:89-251.
    """
    i32 = jnp.int32
    BIG = jnp.int32(1 << 28)
    ccap = comp.shape[0]
    CB = blk                        # comp-space tag base
    Q = qcap or max(blk // 8, 1024)
    assert _bits(ccap + 1) + 9 <= 31, "fetch buffer too large"

    geo = _frag_geometry(blk, fcap, ccap)
    assert geo is not None, "fragment pack geometry does not fit"
    CW, r1, r2, r3, r4 = geo
    CM = (1 << CW) - 1
    fq = jnp.arange(fcap, dtype=i32)
    fl = fq < nfrag
    j = lax.broadcasted_iota(i32, (blk, 1), 0).squeeze(-1)

    # ---- merge A: per-byte fragment params (as the byte decoder) ---
    lefts = ((fdst >> CW) | ((fsrc >> CW) << r1)
             | ((fper >> CW) << (r1 + r2))
             | ((fphase >> CW) << (r1 + r2 + r3)))
    rank = (fq + 1) << CW

    def pk(part):
        return jnp.where(fl, rank | (part & CM), -1)

    kk = jnp.concatenate([jnp.where(fl, fdst * 2, BIG), j * 2 + 1])
    za = jnp.full((blk,), -1, i32)
    kks, pAs, pBs, pCs, pEs, pDs = lax.sort(
        (kk,
         jnp.concatenate([pk(fdst), za]),
         jnp.concatenate([pk(fsrc), za]),
         jnp.concatenate([pk(fper), za]),
         jnp.concatenate([pk(fphase), za]),
         jnp.concatenate([pk(lefts), za])),
        num_keys=1)
    fA, fB, fC, fE, fD = (lax.cummax(pAs), lax.cummax(pBs),
                          lax.cummax(pCs), lax.cummax(pEs),
                          lax.cummax(pDs))
    lf = fD & CM
    FD = (fA & CM) | ((lf & ((1 << r1) - 1)) << CW)
    FS = (fB & CM) | (((lf >> r1) & ((1 << r2) - 1)) << CW)
    FP = (fC & CM) | (((lf >> (r1 + r2)) & ((1 << r3) - 1)) << CW)
    FH = (fE & CM) | (((lf >> (r1 + r2 + r3))
                       & ((1 << r4) - 1)) << CW)
    ok_row = fA >= 0
    rel = (kks >> 1) - FD
    is_per = FP > 0
    t = jnp.where(is_per, FS + (FH + rel) % jnp.maximum(FP, 1),
                  FS + rel)
    t = jnp.where(ok_row, t, 0)
    isb = (kks & 1) == 1
    _, tp = lax.sort((jnp.where(isb, kks >> 1, BIG),
                      (t << 1) | is_per.astype(i32)), num_keys=1)
    T = tp[:blk] >> 1
    PERB = (tp[:blk] & 1) == 1
    live = j < out_len

    # ---- tagged position state --------------------------------------
    nx = jnp.where(live,
                   jnp.where(PERB, jnp.clip(T, 0, blk - 1),
                             jnp.clip(T, 0, ccap - 1) + CB),
                   CB)

    # rank-chunk pack for tagged positions: ((j+1) << CWn) | chunk
    VB = _bits(blk + ccap)          # tagged-position value bits
    CWn = 31 - _bits(blk + 1)
    NCH = -(-VB // CWn)
    CMn = (1 << CWn) - 1
    rankn = (j + 1) << CWn

    def _fetch_nx(nx, kq, pb_q, nq):
        """One doubling merge: dense nx publishers + nq query rows
        (keys kq = target*2+1 or BIG, passengers pb_q) -> fetched
        tagged positions in passenger order."""
        keys = jnp.concatenate([j * 2, kq])
        pb = jnp.concatenate([jnp.zeros((blk,), i32), pb_q])
        zq = jnp.full((nq,), -1, i32)
        ops = tuple(
            jnp.concatenate([rankn | ((nx >> (c * CWn)) & CMn), zq])
            for c in range(NCH))
        srt = lax.sort((keys, pb) + ops, num_keys=1)
        fills = [lax.cummax(x) for x in srt[2:]]
        es = lax.sort((srt[1],) + tuple(fills), num_keys=1)
        v = es[1][blk:] & CMn
        for c in range(1, NCH):
            v = v | ((es[1 + c][blk:] & CMn) << (c * CWn))
        return v

    # ---- dense doubling rounds (depth 2^dense) ----------------------
    for _ in range(max(dense, 0)):
        unc = nx < CB
        kq = jnp.where(unc, nx * 2 + 1, BIG)
        v = _fetch_nx(nx, kq, j + 1, blk)
        nx = jnp.where(unc, v, nx)

    # ---- frontier compaction + pool doubling rounds -----------------
    if doublings > 0:
        unc = nx < CB
        sk, pj_, pv_ = lax.sort((jnp.where(unc, j, BIG), j, nx),
                                num_keys=1)
        pal = sk[:Q] < BIG
        pj = jnp.where(pal, pj_[:Q], blk)
        pnx = jnp.where(pal, pv_[:Q], CB)
        for _ in range(doublings):
            punc = pal & (pnx < CB)
            kq = jnp.where(punc, pnx * 2 + 1, BIG)
            v = _fetch_nx(nx, kq, jnp.arange(Q, dtype=i32) + 1, Q)
            pnx = jnp.where(punc, v, pnx)
            nx = nx.at[pj].set(pnx, mode='drop')

    conv = ~live | (nx >= CB)

    # ---- final exact comp fetch (per-byte rows, no pool) ------------
    cp = jnp.clip(nx - CB, 0, ccap - 1)
    cs = jnp.arange(ccap, dtype=i32)
    qk = jnp.where(live, cp * 2 + 1, BIG)
    kb, vb, pb2 = lax.sort(
        (jnp.concatenate([cs * 2, qk]),
         jnp.concatenate([((cs + 1) << 9) | comp.astype(i32),
                          jnp.full((blk,), -1, i32)]),
         jnp.concatenate([jnp.zeros((ccap,), i32), j + 1])),
        num_keys=1)
    fv = lax.cummax(vb)
    isq = (kb & 1) == 1
    hit = isq & ((fv >> 9) - 1 == (kb >> 1))
    _, litv = lax.sort((jnp.where(pb2 > 0, pb2 - 1, BIG),
                        jnp.where(hit, fv & 0xFF, -1)), num_keys=1)
    value = jnp.where(live & conv, litv[:blk], -1)
    ok = jnp.all(conv) & jnp.all(jnp.where(live, value >= 0, True))
    out = jnp.where(live & (value >= 0), value, 0)
    return out.astype(jnp.uint8), ok


def resolve_tmap_py(comp: bytes, out_cap: int, hist_len: int = 0):
    """Pure-Python mirror of the native per-byte literal-source map
    resolver (lz4tpu_resolve_tmap): full host-side path compression
    -- T[p] is the fetch coordinate ([history | payload]) whose byte
    equals output byte p.  Returns (T int32[out_cap], out_len) or
    None when the block overruns out_cap.  reference decode
    semantics: src/lz4.zig:89-251."""
    import numpy as np
    from ..errors import CorruptedData
    T = np.zeros(out_cap, np.int32)
    ip, n = 0, len(comp)
    op = 0
    while ip < n:
        token = comp[ip]; ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if ip >= n:
                    raise CorruptedData("truncated literal length")
                x = comp[ip]; ip += 1; lit += x
                if x != 255:
                    break
        if ip + lit > n:
            raise CorruptedData("literal overrun")
        if lit:
            if op + lit > out_cap:
                return None
            T[op:op + lit] = hist_len + np.arange(ip, ip + lit)
            op += lit; ip += lit
        if ip >= n:
            break
        if ip + 2 > n:
            raise CorruptedData("truncated offset")
        off = comp[ip] | (comp[ip + 1] << 8); ip += 2
        if off == 0 or off > op + hist_len:
            raise CorruptedData(f"bad offset {off} at {op}")
        ml = token & 15
        if ml == 15:
            while True:
                if ip >= n:
                    raise CorruptedData("truncated match length")
                x = comp[ip]; ip += 1; ml += x
                if x != 255:
                    break
        ml += 4
        if op + ml > out_cap:
            return None
        take = min(ml, off)
        s = op - off
        if s >= 0:
            T[op:op + take] = T[s:s + take]
        else:
            hb = min(-s, take)
            T[op:op + hb] = hist_len + s + np.arange(hb)
            if take > hb:
                T[op + hb:op + take] = T[:take - hb]
        done = take
        while done < ml:                 # period-doubling tail
            c = min(done, ml - done)
            T[op + done:op + done + c] = T[op:op + c]
            done += c
        op += ml
    return T, op


def device_tmap_decoder_supports(blk: int,
                                 fetch_cap: int | None = None) -> bool:
    """True when the one-merge T-map decoder's byte pack covers this
    (block, fetch buffer) geometry -- 64KB through 4MB blocks at
    quantized fetch buffers (a full 4MB compress_bound just overflows
    the 9-bit byte pack; payload <= bs/2 fits)."""
    fetch_cap = fetch_cap or compress_bound(blk)
    return _bits(fetch_cap + 1) + 9 <= 31


def _decode_block_tmap(comp, T, out_len, *, blk: int):
    """ONE-merge device decode from a host-resolved per-byte literal
    -source map (native lz4tpu_resolve_tmap / resolve_tmap_py).

    The resolver already path-compressed every LZ77 chain to its
    literal source, so reconstruction is a single parity-keyed merge
    of the fetch buffer's bytes against T -- no rounds, no tiers, no
    convergence budget, 100% coverage by construction.  This is the
    production decode engine (round 5); the fragment engines remain
    as explicit options.  reference decode semantics:
    src/lz4.zig:89-251."""
    i32 = jnp.int32
    BIG = jnp.int32(1 << 28)
    ccap = comp.shape[0]
    assert _bits(ccap + 1) + 9 <= 31, "fetch buffer too large"
    j = lax.broadcasted_iota(i32, (blk, 1), 0).squeeze(-1)
    live = j < out_len
    cp = jnp.clip(T, 0, ccap - 1)
    cs = jnp.arange(ccap, dtype=i32)
    qk = jnp.where(live, cp * 2 + 1, BIG)
    kb, vb, pb = lax.sort(
        (jnp.concatenate([cs * 2, qk]),
         jnp.concatenate([((cs + 1) << 9) | comp.astype(i32),
                          jnp.full((blk,), -1, i32)]),
         jnp.concatenate([jnp.zeros((ccap,), i32), j + 1])),
        num_keys=1)
    fv = lax.cummax(vb)
    isq = (kb & 1) == 1
    hit = isq & ((fv >> 9) - 1 == (kb >> 1))
    _, litv = lax.sort((jnp.where(pb > 0, pb - 1, BIG),
                        jnp.where(hit, fv & 0xFF, 0)), num_keys=1)
    out = jnp.where(live, litv[:blk], 0)
    return out.astype(jnp.uint8)


@functools.lru_cache(maxsize=None)
def _batched_tmap_decoder(blk: int):
    fn = functools.partial(_decode_block_tmap, blk=blk)
    return jax.jit(jax.vmap(fn))


def _decode_flat_fetch(fetch, T, total_len, *, FC: int, NOUT: int):
    """Flat one-merge decode of a LINKED-mode window from its global
    T-map (native lz4tpu_resolve_tmap_linked): ``fetch`` uint8[FC] =
    [window-entry history | payloads], ``T`` int32[NOUT] global
    literal-source coordinates for the window's frame-contiguous
    output, ``total_len`` its live length.  Because the host already
    path-compressed every cross-block chain to static fetch data, the
    sequential 64KB history dependency (src/lz4.zig:870-957) costs
    the device NOTHING -- one parity-keyed merge reconstructs the
    whole window."""
    i32 = jnp.int32
    BIG = jnp.int32(1 << 28)
    assert _bits(FC + 1) + 9 <= 31, "fetch window too large"
    j = lax.broadcasted_iota(i32, (NOUT, 1), 0).squeeze(-1)
    live = j < total_len
    cp = jnp.clip(T, 0, FC - 1)
    cs = jnp.arange(FC, dtype=i32)
    qk = jnp.where(live, cp * 2 + 1, BIG)
    kb, vb, pb = lax.sort(
        (jnp.concatenate([cs * 2, qk]),
         jnp.concatenate([((cs + 1) << 9) | fetch.astype(i32),
                          jnp.full((NOUT,), -1, i32)]),
         jnp.concatenate([jnp.zeros((FC,), i32), j + 1])),
        num_keys=1)
    fv = lax.cummax(vb)
    isq = (kb & 1) == 1
    hit = isq & ((fv >> 9) - 1 == (kb >> 1))
    _, litv = lax.sort((jnp.where(pb > 0, pb - 1, BIG),
                        jnp.where(hit, fv & 0xFF, 0)), num_keys=1)
    out = jnp.where(live, litv[:NOUT], 0)
    return out.astype(jnp.uint8)


@functools.lru_cache(maxsize=None)
def _flat_tmap_decoder(FC: int, NOUT: int):
    fn = functools.partial(_decode_flat_fetch, FC=FC, NOUT=NOUT)
    return jax.jit(fn)


def _linked_tmap_step(hist_pad, payloads, T, total_len, *, H: int,
                      PCQ: int, NOUT: int):
    """One linked-window device step with a carried history operand.

    ``hist_pad`` uint8[H] holds the window-entry history RIGHT-ALIGNED
    (dict_base = H - dict_len in the resolver's coordinates), so the
    fetch buffer is simply [hist_pad | payloads] and the resolver's
    history coordinates land on the live tail.  Returns (out[NOUT],
    new_hist[H]) where new_hist is the last H bytes of
    hist_pad + out[:total_len] -- again right-aligned, so windows
    chain device-side with NO host round-trip: step k+1 consumes
    step k's new_hist as a device array and XLA pipelines the whole
    frame's dispatch queue (the 64KB dependency serializes only the
    device work itself).  reference streaming prefix semantics:
    src/lz4.zig:870-957."""
    fetch = jnp.concatenate([hist_pad, payloads])
    out = _decode_flat_fetch(fetch, T, total_len, FC=H + PCQ, NOUT=NOUT)
    cat = jnp.concatenate([hist_pad, out])
    new_hist = lax.dynamic_slice(
        cat, (jnp.clip(total_len, 0, NOUT),), (H,))
    return out, new_hist


@functools.lru_cache(maxsize=None)
def _linked_tmap_stepper(H: int, PCQ: int, NOUT: int):
    fn = functools.partial(_linked_tmap_step, H=H, PCQ=PCQ, NOUT=NOUT)
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _batched_frag_decoder_chase(blk: int, fcap: int, dense: int = 2,
                                doublings: int = 4, qcap: int = 0):
    fn = functools.partial(_decode_block_frags_chase, blk=blk,
                           fcap=fcap, dense=dense,
                           doublings=doublings, qcap=qcap)
    return jax.jit(jax.vmap(fn))


def win_tier_config(blk: int, fcap: int, rounds: int) -> dict:
    """Per-tier windowed-decoder configuration (uncovered-byte
    budgets on HC-class streams of the bench corpus):
    periodic side needs only 2 windows + a few hundred pool slots;
    the literal side needs 3-4 windows on fast tiers and stays
    byte-granular on the match-dense deep tier."""
    if rounds <= 2:
        return dict(wins=2, pool=256, lit_wins=3, lit_pool=1024)
    if fcap < blk:
        return dict(wins=2, pool=512, lit_wins=4, lit_pool=2048)
    return dict(wins=2, pool=512, lit_wins=0, lit_pool=0)


@functools.lru_cache(maxsize=None)
def _batched_frag_decoder_win(blk: int, fcap: int, rounds: int,
                              wins: int | None = None,
                              pool: int | None = None,
                              lit_wins: int | None = None,
                              lit_pool: int | None = None,
                              g: int = 8):
    cfg = win_tier_config(blk, fcap, rounds)
    if wins is not None:
        cfg["wins"] = wins
    if pool is not None:
        cfg["pool"] = pool
    if lit_wins is not None:
        cfg["lit_wins"] = lit_wins
    if lit_pool is not None:
        cfg["lit_pool"] = lit_pool
    fn = functools.partial(_decode_block_frags_win, blk=blk, fcap=fcap,
                           rounds=rounds, g=g, **cfg)
    return jax.jit(jax.vmap(fn))


@functools.lru_cache(maxsize=None)
def _batched_frag_decoder(blk: int, fcap: int, rounds: int):
    fn = functools.partial(_decode_block_frags, blk=blk, fcap=fcap,
                           rounds=rounds)
    return jax.jit(jax.vmap(fn))


def decode_blocks_frags(comp_blocks, fdst, fsrc, fper, fphase, nfrag,
                        out_lens, rounds: int, blk: int):
    """Batched round-bounded decode from host-resolved fragments.
    ``comp_blocks`` rows are fetch buffers ([history | payload] when
    the resolver ran with hist_len > 0)."""
    fcap = fdst.shape[-1]
    return _batched_frag_decoder(blk, fcap, int(rounds))(
        comp_blocks, fdst, fsrc, fper, fphase, nfrag,
        jnp.asarray(out_lens, jnp.int32))


def resolve_fragments_py(comp: bytes, fcap: int = 1 << 30,
                         out_cap: int = 4 << 20, hist_len: int = 0,
                         split_max: int = 8, round_limit: int = 4):
    """Pure-Python mirror of the native fragment resolver (tests and
    no-native fallback).  Matches lz4tpu_resolve_blocks: per-match
    splitting capped at ``split_max`` segments, over-fragmenting
    matches become one PER copy-fragment with round = 1 + max round
    of the bytes it reads (up to ``round_limit``); LIT sources are
    shifted by ``hist_len`` for a [history | comp] fetch buffer.
    Returns (fdst, flen, fsrc, fper, fphase lists, rounds, out_len)
    or None on fragment-budget / out_cap overflow."""
    frags = []          # (dst, len, src, per, phase, round)
    ip, n = 0, len(comp)
    op = 0
    max_round = 0
    round_limit = min(round_limit, 250)
    from ..errors import CorruptedData
    import bisect

    dsts = []
    byte_round = bytearray(out_cap + 1)

    def walk(s, take, count_only, d=0):
        """Split [s, s+take) over covering fragments; returns segment
        count (count_only) or emits fragments (-1 = budget hit)."""
        nonlocal max_round
        cur, remaining = s, take
        nseg = 0
        while remaining > 0:
            if cur < 0:
                seg = min(-cur, remaining)
                if not count_only:
                    if len(frags) >= fcap:
                        return -1
                    frags.append((d, seg, hist_len + cur, 0, 0, 0))
                    dsts.append(d)
                    byte_round[d:d + seg] = bytes(seg)
                    d += seg
                nseg += 1
                cur += seg; remaining -= seg
                continue
            fi = bisect.bisect_right(dsts, cur) - 1
            fd, flen_, fs, fp, fh, fr = frags[fi]
            into = cur - fd
            seg = min(flen_ - into, remaining)
            if not count_only:
                if len(frags) >= fcap:
                    return -1
                if fp == 0:
                    frags.append((d, seg, fs + into, 0, 0, 0))
                    byte_round[d:d + seg] = bytes(seg)
                else:
                    frags.append((d, seg, fs, fp, (fh + into) % fp, fr))
                    byte_round[d:d + seg] = bytes([min(fr, 250)]) * seg
                    max_round = max(max_round, fr)
                dsts.append(d)
                d += seg
            nseg += 1
            if count_only and nseg > split_max:
                return nseg
            cur += seg; remaining -= seg
        return nseg

    while ip < n:
        token = comp[ip]; ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if ip >= n:
                    raise CorruptedData("truncated literal length")
                x = comp[ip]; ip += 1; lit += x
                if x != 255:
                    break
        if ip + lit > n:
            raise CorruptedData("literal overrun")
        if lit:
            if len(frags) >= fcap or op + lit > out_cap:
                return None
            frags.append((op, lit, hist_len + ip, 0, 0, 0))
            dsts.append(op)
            byte_round[op:op + lit] = bytes(lit)
            op += lit; ip += lit
        if ip >= n:
            break
        if ip + 2 > n:
            raise CorruptedData("truncated offset")
        off = comp[ip] | (comp[ip + 1] << 8); ip += 2
        if off == 0 or off > op + hist_len:
            raise CorruptedData(f"bad offset {off} at {op}")
        ml = token & 15
        if ml == 15:
            while True:
                if ip >= n:
                    raise CorruptedData("truncated match length")
                x = comp[ip]; ip += 1; ml += x
                if x != 255:
                    break
        ml += 4
        if op + ml > out_cap:
            return None
        take = min(ml, off)
        s = op - off

        def copy_frag():
            """One PER copy-fragment for the whole head (round
            permitting); None-able budget result."""
            nonlocal max_round
            r = 1 + max(byte_round[s:s + take])
            if r > round_limit or len(frags) >= fcap:
                return False
            frags.append((op, take, s, off, 0, r))
            dsts.append(op)
            byte_round[op:op + take] = bytes([r]) * take
            max_round = max(max_round, r)
            return True

        split_ok = walk(s, take, count_only=True) <= split_max
        if not split_ok and s >= 0:
            if not copy_frag():
                split_ok = True
        elif not split_ok:
            split_ok = True         # history-reaching head: must split
        if split_ok:
            nf0 = len(frags)
            mr0 = max_round
            if walk(s, take, count_only=False, d=op) < 0:
                # budget pressure mid-split: roll back and prefer the
                # single copy-fragment, like the native resolver
                del frags[nf0:]
                del dsts[nf0:]
                max_round = mr0
                if s < 0 or not copy_frag():
                    return None

        if ml > take:
            # flattened tail (see the native resolver): reads the
            # pre-existing window [s, s+read_n) -- same bytes, one
            # round shallower than reading the head's output whenever
            # the head was a copy-fragment; s < 0 (history-reaching
            # head) keeps the head-window form
            read_n = min(ml - take, off)
            tsrc = s if s >= 0 else op
            r = 1 + max(byte_round[tsrc:tsrc + read_n])
            if len(frags) >= fcap:
                return None
            frags.append((op + take, ml - take, tsrc, off, 0, r))
            dsts.append(op + take)
            byte_round[op + take:op + ml] = bytes([min(r, 250)]) * (ml - take)
            max_round = max(max_round, r)
        op += ml
    return frags, max_round, op


@functools.lru_cache(maxsize=None)
def make_block_decoder(blk: int, ccap: int | None = None,
                       nseq_cap: int | None = None, hcap: int = 1):
    """Build a jitted device decoder for ``blk``-byte output blocks.

    Returned fn(comp, lit, lsrc, ml, off, ns[, hist]) -- ``hist`` is
    the dictionary/prefix window (uint8[hcap]); omitted -> zeros.
    """
    import numpy as np
    ccap = ccap or compress_bound(blk)
    nseq_cap = nseq_cap or MAX_SEQS(blk)
    fn = functools.partial(_decode_block, blk=blk, nseq_cap=nseq_cap,
                           hcap=hcap)
    jfn = jax.jit(fn)
    dummy = np.zeros(hcap, np.uint8)

    def call(comp, lit, lsrc, ml, off, ns, hist=None):
        return jfn(comp, dummy if hist is None else hist,
                   lit, lsrc, ml, off, ns)
    return call


@functools.lru_cache(maxsize=None)
def _batched_decoder(blk: int, nseq_cap: int, hcap: int = 1):
    fn = functools.partial(_decode_block, blk=blk, nseq_cap=nseq_cap,
                           hcap=hcap)
    return jax.jit(jax.vmap(fn))


def decode_blocks_jax(comp_blocks, lit_len, lit_src, mlen, off, nseq,
                      blk: int, hists=None):
    """Batched device decode from pre-parsed sequence arrays."""
    import numpy as np
    nseq_cap = lit_len.shape[-1]
    if hists is None:
        hists = np.zeros((comp_blocks.shape[0], 1), np.uint8)
    return _batched_decoder(blk, nseq_cap, hists.shape[-1])(
        comp_blocks, hists, lit_len, lit_src, mlen, off, nseq)
