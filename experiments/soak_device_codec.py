"""Soak: the device encoder across ALL levels (0-12), random sizes,
random history splits and five content kinds, every stream
cross-decoded by the native/oracle host decoder.

Run: python experiments/soak_device_codec.py [seconds]  (default 1500)
Failing windows are dumped to the temp directory for replay.
"""
import os, sys, tempfile, time
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import numpy as np
import zig_lz4_tpu.ops.jax_block as jb
from zig_lz4_tpu.native import native_decompress, native_compress_fast
from zig_lz4_tpu.ops.block import decompress_safe_using_dict

rng = np.random.default_rng(0x50AC)
BLK = 32768
B = 16
fails = 0
trials = 0
t_end = time.time() + (int(sys.argv[1]) if len(sys.argv) > 1 else 1500)

def gen(kind, n):
    if kind == 0:
        unit = rng.integers(0, 256, int(rng.integers(3, 200)), dtype=np.uint8).tobytes()
        return (unit * (n // len(unit) + 1))[:n]
    if kind == 1:
        words = [rng.integers(32, 127, int(rng.integers(2, 12)), dtype=np.uint8).tobytes() for _ in range(30)]
        return b" ".join(words[int(rng.integers(30))] for _ in range(n // 5))[:n]
    if kind == 2:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == 3:
        out = bytearray()
        while len(out) < n:
            out += bytes([int(rng.integers(256))]) * int(rng.integers(1, 500))
        return bytes(out[:n])
    return bytes(int(128 + 100 * np.sin(i / (1 + kind))) & 0xFF for i in range(n))

encs = {}
while time.time() < t_end:
    lvl = int(rng.integers(0, 13))
    hc, deep = jb.level_params(lvl)
    key = (hc, deep)
    if key not in encs:
        encs[key] = jb._batched_encoder(BLK, hc, deep)
    wins = np.zeros((B, BLK), np.uint8)
    lens = np.zeros(B, np.int32)
    starts = np.zeros(B, np.int32)
    metas = []
    for k in range(B):
        hist = int(rng.integers(0, 2000)) if rng.random() < 0.4 else 0
        n = int(rng.integers(hist + 1, BLK + 1))
        data = gen(int(rng.integers(5)), n)
        wins[k, :n] = np.frombuffer(data, np.uint8)
        lens[k] = n
        starts[k] = hist
        metas.append((data, hist, n))
    out, olen = encs[key](wins, lens, starts)
    out, olen = np.asarray(out), np.asarray(olen)
    for k in range(B):
        data, hist, n = metas[k]
        comp = out[k, :olen[k]].tobytes()
        want = data[hist:n]
        if hist:
            got = decompress_safe_using_dict(comp, len(want), data[:hist])
        else:
            got = native_decompress(comp, len(want))
        trials += 1
        if got != want:
            fails += 1
            print(f"FAIL lvl={lvl} hist={hist} n={n} kind?", flush=True)
            np.save(os.path.join(tempfile.gettempdir(),
                                 f"soak_fail_{trials}.npy"), wins[k])
print(f"soak done: {trials} trials, {fails} failures, {len(encs)} level configs")
