"""zig_lz4_tpu -- an accelerator-native LZ4 compression framework.

A from-scratch re-design of the capabilities of the reference
implementation (jedisct1/zig-lz4, a pure-Zig CPU LZ4 library) for an
accelerator (an NVIDIA GPU) driven through JAX: the block codec, HC
modes (levels 2-12), the LZ4 frame format with xxHash32 checksums,
streaming with a 64KB window, and external dictionaries -- built on
JAX/XLA for the compute path, with a C++ native host runtime and a
bit-exact Python oracle.  The package name is kept for import
stability.

Public facade mirrors the reference's flat namespace
(reference: src/root.zig:1-57).
"""

from .constants import (
    ACCELERATION_DEFAULT,
    ACCELERATION_MAX,
    LZ4_DISTANCE_MAX,
    LZ4_MAX_INPUT_SIZE,
    LZ4_MEMORY_USAGE,
    MFLIMIT,
    MINMATCH,
    compress_bound,
    decoder_ring_buffer_size,
)
from .errors import (
    BlockError,
    CorruptedData,
    DecompressionFailed,
    FrameError,
    InputTooLarge,
    InvalidState,
    LZ4Error,
    OutputTooSmall,
)
from .ops.block import (
    HashTable,
    compress_default,
    compress_dest_size,
    compress_fast,
    compress_fast_ext_state,
    decompress_safe,
    decompress_safe_partial,
    decompress_safe_partial_using_dict,
    decompress_safe_using_dict,
    sizeof_state,
)
from .version import (
    FRAMEWORK_VERSION,
    VERSION_MAJOR,
    VERSION_MINOR,
    VERSION_RELEASE,
    version_number,
    version_string,
)

__version__ = FRAMEWORK_VERSION


def __getattr__(name):
    # Lazy imports for heavier layers (frame, HC, streaming, JAX).
    # importlib.import_module (not `from . import x`) -- the latter
    # falls back to getattr on the package and recurses.
    import importlib
    if name in ("lz4f", "frame"):
        return importlib.import_module(".frame", __name__)
    if name == "lz4hc":
        return importlib.import_module(".ops.hc", __name__)
    if name in ("Stream", "StreamDecode", "StreamHC"):
        from . import stream
        return getattr(stream, name)
    if name == "compress_hc":
        from .ops.hc import compress_hc
        return compress_hc
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
