"""chip_smoke.py's phases at tiny sizes on the virtual CPU mesh, its
refusal to run without a GPU, and the runtime pieces it relies on:
compile-cache placement, the hash-keyed native build, and the native
library as a hard requirement of device decode.

Every device-encoder program costs tens of seconds to compile on the
CPU, and pytest-xdist runs one file per worker, so the phases are split
over three files by the programs they share.  This file holds level 9
on the 8-, 4- and 1-device meshes; the GPU-vs-CPU payload identity at
every level runs on the card (test_gpu_encoder_matches_cpu, and
chip_smoke.py itself)."""

import os
import subprocess
import sys

import pytest

import chip_smoke as cs
from zig_lz4_tpu import frame as lz4f
from zig_lz4_tpu import native
from zig_lz4_tpu.parallel import ShardedFrameCodec, blocks_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLK = 2048          # shrunk blocks: 8 per frame -> 8 rows on every mesh

PHASES = {
    "l9": lambda: cs.phase_frame(blocks_mesh(), 8 * BLK, level=9,
                                 block_size=BLK, compare_blocks=8,
                                 memory=True),
    "four_cards": lambda: cs.phase_four_cards(
        blocks_mesh(4), blocks_mesh(1), 8 * BLK, block_size=BLK),
}


@pytest.mark.parametrize("phase", list(PHASES))
def test_chip_smoke_phase_on_cpu(phase):
    st = PHASES[phase]()
    assert st["bytes_in"] > 0 and st["ratio"] > 1
    if phase == "l9":
        for prog in ("encoder", "tmap_decoder"):
            assert st["memory"][prog]["argument_size_in_bytes"] > 0
    if phase == "four_cards":
        assert st["frames_identical"]
    else:
        routes = st["routes"]
        assert routes.get("decode_device", 0) > 0, routes
        assert routes.get("decode_host", 0) == 0, routes


@pytest.mark.parametrize("isolated", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, isolated):
    """No GPU (and, isolated, no repo beside the script): non-zero exit
    and no result line."""
    cwd = ROOT
    if isolated:
        cwd = str(tmp_path)
        with open(os.path.join(ROOT, "chip_smoke.py"), "rb") as f:
            (tmp_path / "chip_smoke.py").write_bytes(f.read())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("level", [0, 9, 12])
def test_gpu_encoder_matches_cpu(gpu_devices, level):
    """GPU payload bytes == CPU payload bytes on 16 corpus blocks."""
    mesh = blocks_mesh(devices=gpu_devices[:1])
    assert cs.encoder_vs_cpu(mesh, level) == 16


@pytest.mark.parametrize("env_dir", [None, "from_env"])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins; otherwise <checkout>/.jax_cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(ROOT, ".jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = subprocess.run(
        [sys.executable, "-c", "import jax, zig_lz4_tpu.ops.jax_block; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == want


_SRC = 'extern "C" int version() { return %d; }\n'


def test_native_build_hash_keyed_and_atomic(tmp_path, monkeypatch):
    """The library name carries the source hash; the compiler writes a
    temporary name that is renamed into place; an unchanged source is
    not rebuilt and an edited one is."""
    import ctypes
    src, out = tmp_path / "k.cpp", str(tmp_path / "build")
    src.write_text(_SRC % 1)
    so = native.library_path(str(src), out)
    compiled_to = []
    real_run = native.subprocess.run

    def spy(cmd, **kw):
        target = cmd[cmd.index("-o") + 1]
        compiled_to.append(target)
        final = native.library_path(str(src), out)
        assert target.endswith(".tmp") and not os.path.exists(final)
        return real_run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", spy)
    assert native.build(str(src), out) == so
    assert len(compiled_to) == 1 and os.path.exists(so)
    assert not [f for f in os.listdir(out) if f.endswith(".tmp")]
    assert native.build(str(src), out) == so         # no rebuild
    assert len(compiled_to) == 1
    src.write_text(_SRC % 2)
    so2 = native.build(str(src), out)
    assert so2 != so and len(compiled_to) == 2
    assert ctypes.CDLL(so2).version() == 2


def test_native_build_concurrent_processes(tmp_path):
    """More builders than cores on one fresh directory: every process
    gets the same library and loads it whole."""
    src, out = tmp_path / "k.cpp", str(tmp_path / "build")
    src.write_text(_SRC % 7)
    code = ("import ctypes, sys; from zig_lz4_tpu import native; "
            "print(ctypes.CDLL(native.build(sys.argv[1], sys.argv[2]))"
            ".version())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(src), out],
                              cwd=ROOT, stdout=subprocess.PIPE, text=True)
             for _ in range((os.cpu_count() or 1) + 1)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert all(o.strip() == "7" for o in outs)
    assert sorted(os.listdir(out)) == [".lock", os.path.basename(
        native.library_path(str(src), out))]


@pytest.mark.parametrize("mode", [lz4f.BlockMode.independent,
                                  lz4f.BlockMode.linked])
def test_device_decode_without_native_raises(monkeypatch, mode):
    """The device decode path needs the native resolver: without it the
    codec raises instead of switching engines or going to the host."""
    data = cs.corpus(150_000)
    frame = lz4f.compress_frame(data, lz4f.Preferences(
        frame_info=lz4f.FrameInfo(block_mode=mode)))
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(native, "_load_error", "forced off by the test")

    def no_ladder(*a, **k):
        raise AssertionError("fell back to the fragment ladder")

    monkeypatch.setattr(native, "native_resolve_blocks", no_ladder)
    codec = ShardedFrameCodec(mesh=blocks_mesh())
    with pytest.raises(RuntimeError, match="forced off by the test"):
        codec.decompress_frame(frame)
    assert codec.routes["decode_host"] == 0
