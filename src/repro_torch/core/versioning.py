"""Format versioning — the port's copy of ``repro.core.versioning``.

A release supports a range of wire format versions.  At compression time the
caller picks one; the engine refuses any codec whose ``min_version`` is
newer.  Frames carry their version and the decoder checks it.
"""
from __future__ import annotations

MIN_FORMAT_VERSION = 1
# v1: core transforms (store/delta/zigzag/transpose/bitpack/rle/constant/split)
# v2: tokenize/string codecs, huffman, fse, lz, parsers
# v3: float_split family, lane-parallel entropy variants, zlib backend
# v4: multi-chunk container frames + fused_delta_bitpack
CURRENT_FORMAT_VERSION = 4

# First format version whose decoders understand the multi-chunk container
# record; compress(chunk_bytes=...) refuses to emit one at older versions.
CONTAINER_MIN_VERSION = 4


class VersionError(ValueError):
    pass


def check_compress_version(version: int) -> int:
    if not (MIN_FORMAT_VERSION <= version <= CURRENT_FORMAT_VERSION):
        raise VersionError(
            f"format version {version} outside supported"
            f" [{MIN_FORMAT_VERSION}, {CURRENT_FORMAT_VERSION}]"
        )
    return version


def check_decode_version(version: int) -> int:
    if not (MIN_FORMAT_VERSION <= version <= CURRENT_FORMAT_VERSION):
        raise VersionError(
            f"frame format version {version} not supported by this library"
            f" (supports [{MIN_FORMAT_VERSION}, {CURRENT_FORMAT_VERSION}])"
        )
    return version
