"""Direct cost attribution: sort passes vs operand count vs cand_at
compute vs cummax, on the accelerator at B=64 x 64K rows."""
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

B, N = 64, 65536
rng = np.random.default_rng(0)
key = jax.device_put(rng.integers(0, 1 << 30, (B, N), np.int32))
vals = [jax.device_put(rng.integers(0, 1 << 30, (B, N), np.int32))
        for _ in range(11)]


def timeit(fn, *a):
    r = fn(*a)
    np.asarray(jax.tree_util.tree_leaves(r)[0][:, ::997])
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = fn(*a)
        np.asarray(jax.tree_util.tree_leaves(r)[0][:, ::997])
        ts.append(time.perf_counter() - t0)
    return min(ts) / B * 1e3


for nops in (1, 2, 4, 8, 12):
    f = jax.jit(lambda k, *v: lax.sort((k,) + v, num_keys=1,
                                       is_stable=True)[0])
    t = timeit(f, key, *vals[:nops - 1])
    print(f"sort {nops:2d} ops: {t:.3f} ms/blk", flush=True)

# u8 operand cost vs i32
u8vals = [jax.device_put(rng.integers(0, 255, (B, N), np.uint8))
          for _ in range(8)]
f = jax.jit(lambda k, *v: lax.sort((k,) + v, num_keys=1,
                                   is_stable=True)[0])
print(f"sort 1 key + 8 u8 ops: {timeit(f, key, *u8vals):.3f} ms/blk",
      flush=True)

# cummax
f = jax.jit(lambda x: lax.cummax(x, axis=1))
print(f"cummax 1: {timeit(f, key):.3f} ms/blk", flush=True)
f = jax.jit(lambda *xs: tuple(lax.cummax(x, axis=1) for x in xs))
print(f"cummax x8: {timeit(f, key, *vals[:7]):.3f} ms/blk", flush=True)
f = jax.jit(lambda x: jnp.cumsum(x, axis=1))
print(f"cumsum 1: {timeit(f, key):.3f} ms/blk", flush=True)

# unstable vs stable, fewer rows
f = jax.jit(lambda k, *v: lax.sort((k,) + v, num_keys=1,
                                   is_stable=False)[0])
print(f"sort 4 ops unstable: {timeit(f, key, *vals[:3]):.3f} ms/blk",
      flush=True)
half = jax.device_put(rng.integers(0, 1 << 30, (B, N // 4), np.int32))
hv = [jax.device_put(rng.integers(0, 1 << 30, (B, N // 4), np.int32))
      for _ in range(3)]
f = jax.jit(lambda k, *v: lax.sort((k,) + v, num_keys=1,
                                   is_stable=True)[0])
print(f"sort 4 ops 16K rows: {timeit(f, half, *hv):.3f} ms/blk",
      flush=True)
big = jax.device_put(rng.integers(0, 1 << 30, (B, 2 * N), np.int32))
bv = [jax.device_put(rng.integers(0, 1 << 30, (B, 2 * N), np.int32))
      for _ in range(3)]
print(f"sort 4 ops 128K rows: {timeit(f, big, *bv):.3f} ms/blk",
      flush=True)
