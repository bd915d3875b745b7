from .codec import (
    BlockCodec,
    FastCodec,
    HCCodec,
    DeviceCodec,
    get_codec,
)

__all__ = ["BlockCodec", "FastCodec", "HCCodec", "DeviceCodec", "get_codec"]
