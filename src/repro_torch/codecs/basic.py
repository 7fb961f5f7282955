"""Structural codecs.  Only ``store`` is in this slice: the trial menus of
``numeric_auto`` and ``entropy_auto`` start with it."""
from __future__ import annotations

from ..core.codec import CodecSpec, register_codec


# --------------------------------------------------------------------- store
def _store_enc(streams, params):
    return [streams[0]], b""


def _store_dec(outs, header):
    return [outs[0]]


register_codec(
    CodecSpec(
        "store",
        codec_id=1,
        encode=_store_enc,
        decode=_store_dec,
        doc="identity; terminal passthrough",
    )
)
