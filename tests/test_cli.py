"""CLI tests -- file compress/decompress/test flows, lz4(1) flag
semantics (the reference's exe only self-tests: src/main.zig:1-5;
ours is a real frame compressor)."""

import os
import random
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import pytest

from zig_lz4_tpu import frame as lz4f
from zig_lz4_tpu.cli import main


@pytest.fixture()
def sample(tmp_path):
    rng = random.Random(7)
    data = ((b"a quick brown fox " * 400)
            + bytes(rng.randrange(256) for _ in range(4000))
            + b"z" * 9000)
    p = tmp_path / "sample.bin"
    p.write_bytes(data)
    return p, data


def test_cli_round_trip(sample, tmp_path):
    p, data = sample
    dst = tmp_path / "sample.bin.lz4"
    assert main([str(p), str(dst), "-f", "-q"]) == 0
    frame = dst.read_bytes()
    assert lz4f.decompress_frame(frame) == data
    out = tmp_path / "restored.bin"
    assert main(["-d", "-f", "-q", str(dst), str(out)]) == 0
    assert out.read_bytes() == data


@pytest.mark.parametrize("level", [1, 2, 9, 12])
def test_cli_levels(sample, tmp_path, level):
    p, data = sample
    dst = tmp_path / f"l{level}.lz4"
    assert main([f"-{level}", "-f", "-q", str(p), str(dst)]) == 0
    assert lz4f.decompress_frame(dst.read_bytes()) == data


def test_cli_block_flags(sample, tmp_path):
    p, data = sample
    dst = tmp_path / "b.lz4"
    assert main(["-B5", "--block-crc", "--content-size", "-f", "-q",
                 str(p), str(dst)]) == 0
    info = lz4f.get_frame_info(dst.read_bytes())
    assert info.block_size_id == lz4f.BlockSizeID.max256KB
    assert info.block_checksum
    assert info.content_size == len(data)
    assert lz4f.decompress_frame(dst.read_bytes()) == data


def test_cli_linked_mode(sample, tmp_path):
    p, data = sample
    dst = tmp_path / "bd.lz4"
    assert main(["-BD", "-f", "-q", str(p), str(dst)]) == 0
    info = lz4f.get_frame_info(dst.read_bytes())
    assert info.block_mode == lz4f.BlockMode.linked
    assert lz4f.decompress_frame(dst.read_bytes()) == data


def test_cli_test_mode_detects_corruption(sample, tmp_path, capsys):
    p, data = sample
    dst = tmp_path / "t.lz4"
    assert main(["-f", "-q", str(p), str(dst)]) == 0
    assert main(["-t", "-q", str(dst)]) == 0
    bad = bytearray(dst.read_bytes())
    bad[len(bad) // 2] ^= 0x20
    badf = tmp_path / "bad.lz4"
    badf.write_bytes(bytes(bad))
    assert main(["-t", "-q", str(badf)]) == 1


def test_cli_no_overwrite(sample, tmp_path):
    p, data = sample
    dst = tmp_path / "x.lz4"
    dst.write_bytes(b"existing")
    with pytest.raises(SystemExit):
        main([str(p), str(dst), "-q"])


def test_cli_self_test():
    assert main(["--self-test"]) == 0


def test_cli_subprocess_stdout(sample, tmp_path):
    """Real process invocation: compress to stdout, pipe semantics."""
    p, data = sample
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "zig_lz4_tpu.cli", "-c", "-q", str(p)],
        capture_output=True, env=env, cwd=_ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-500:]
    assert lz4f.decompress_frame(r.stdout) == data


def test_cli_tpu_decode_engines(sample, tmp_path):
    """--engine device with the default T-map decode and the two
    fragment engines (windowed tiers and pointer-doubling chase)
    restores the frame bit-exact."""
    p, data = sample
    dst = tmp_path / "dev.lz4"
    assert main(["-4", "-f", "-q", "--engine", "device",
                 str(p), str(dst)]) == 0
    for eng in (None, "win", "chase"):
        out = tmp_path / f"restored_{eng}.bin"
        flags = ["--decode-engine", eng] if eng else []
        assert main(["-d", "-f", "-q", "--engine", "device", *flags,
                     str(dst), str(out)]) == 0
        assert out.read_bytes() == data
