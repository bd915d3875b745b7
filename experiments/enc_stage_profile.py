"""Per-stage timing of the device encoder on the accelerator.

_encode_block has stage=1..7 early-return hooks (plus stage=9 after
the HC post-parse extension/absorb); timing the cumulative prefixes
attributes cost to each pipeline stage:
  1 grouping sort + cand_at    2 +unsort        3 +chain extension
  4 +greedy scan               9 +extension/absorb (hc only)
  5 +compact/coalesce/budgets  6 +merge1 literal fill
  7 +pools/grand placement     0 full

Args: [B] [lvlN] [stages=a,b,..] -- e.g. `enc_stage_profile.py 8 lvl9`
profiles the level-9 HC configuration at the frame path's one-card
batch; `stages=3,4,0` times only those prefixes (each is a compile).
"""
import functools
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import zig_lz4_tpu.ops.jax_block as jb  # noqa: E402
from bench import make_corpus  # noqa: E402

BLK = 65536
args = [a for a in sys.argv[1:] if a[:3] not in ("lvl", "sta")]
lvls = [a for a in sys.argv[1:] if a.startswith("lvl")]
picked = [a[7:] for a in sys.argv[1:] if a.startswith("stages=")]
HC, DEEP = jb.level_params(int(lvls[0][3:])) if lvls else (0, 0)
B = int(args[0]) if args else 64
corpus = make_corpus(max(12, B * BLK // (1 << 20) + 2))
blocks = np.frombuffer(corpus[:B * BLK], np.uint8).reshape(B, BLK)
lens = np.full(B, BLK, np.int32)
starts = np.zeros(B, np.int32)
db = jax.device_put(blocks)
dl = jax.device_put(lens)
ds = jax.device_put(starts)

print(f"devices: {jax.devices()}  B={B} hc={HC} deep={DEEP}", flush=True)

prev = 0.0
stages = ((11, 12, 1, 2, 3, 4, 9, 5, 6, 7, 0) if DEEP
          else (12, 1, 2, 3, 4, 9, 5, 6, 7, 0) if HC
          else (12, 1, 2, 3, 4, 5, 6, 7, 0))
if picked:
    stages = tuple(int(x) for x in picked[0].split(","))
for stage in stages:
    fn = jax.jit(jax.vmap(functools.partial(
        jb._encode_block, blk=BLK, stage=stage, hc=HC, deep=DEEP)))
    out, chk = fn(db, dl, ds)
    np.asarray(chk)  # compile + warm
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        out, chk = fn(db, dl, ds)
        float(np.asarray(jnp.sum(chk)))
        ts.append(time.perf_counter() - t0)
    t = min(ts)
    name = {11: "rank-tiers", 12: "+grand-sort",
            1: "+cand-probes", 2: "+unsort", 3: "+chain-ext",
            4: "+greedy-scan", 9: "+extend/absorb",
            5: "+compact/coalesce", 6: "+merge1-lit",
            7: "+pools/grand", 0: "FULL"}[stage]
    print(f"stage {stage} ({name:18s}): {t*1e3:7.1f} ms total, "
          f"{t/B*1e3:6.3f} ms/blk, delta {max(t-prev,0)/B*1e3:6.3f} ms/blk",
          flush=True)
    if stage != 0:
        prev = t
