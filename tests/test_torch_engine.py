"""The slice end to end on the CPU: the port's frames against the reference's.

Numeric columns of 256 KiB (int64 timestamps, zipf-distributed u32 ids and
a constant column), made with numpy from fixed seeds, go through
``numeric_profile()`` at levels 1, 3 and 5 and through the two explicit
pipelines.  The port's frame must equal ``repro.core.compress(...,
backend="device")`` byte for byte, and each package's decoder must read the
other's frame back to the column.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.codecs.profiles import numeric_profile as ref_numeric_profile  # noqa: E402
from repro.core import CompressionCtx as RefCtx  # noqa: E402
from repro.core import compress as ref_compress  # noqa: E402
from repro.core import decompress as ref_decompress  # noqa: E402
from repro.core.graph import pipeline as ref_pipeline  # noqa: E402
from repro.core.message import numeric as ref_numeric  # noqa: E402

COLUMN_BYTES = 1 << 18


def _column(kind):
    rng = np.random.default_rng({"timestamps": 1, "zipf": 2, "constant": 3}[kind])
    if kind == "timestamps":  # monotone ns timestamps with jittered gaps
        n = COLUMN_BYTES // 8
        gaps = rng.integers(900_000, 1_100_000, n)
        return (1_700_000_000_000_000_000 + np.cumsum(gaps)).astype(np.int64)
    n = COLUMN_BYTES // 4
    if kind == "zipf":
        return (rng.zipf(1.3, n) % (1 << 32)).astype(np.uint32)
    return np.full(n, 0xC0FFEE, np.uint32)


PLANS = {
    "numeric_l1": ("profile", 1),
    "numeric_l3": ("profile", 3),
    "numeric_l5": ("profile", 5),
    "delta_transpose_huffman": (("delta", "transpose", "huffman"), 5),
    "delta_transpose_fse": (("delta", "transpose", "fse"), 5),
}


@pytest.mark.parametrize("kind", ["timestamps", "zipf", "constant"])
@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_port_frame_equals_reference_device_frame(kind, plan_name):
    col = _column(kind)
    spec, level = PLANS[plan_name]
    if spec == "profile":
        plan, ref_plan = repro_torch.numeric_profile(), ref_numeric_profile()
    else:
        plan, ref_plan = repro_torch.pipeline(*spec), ref_pipeline(*spec)
    frame = repro_torch.compress(
        plan, repro_torch.numeric(col), repro_torch.CompressionCtx(level=level), device="cpu", use_resolve_cache=False
    )
    ref_frame = ref_compress(
        ref_plan, ref_numeric(col), ctx=RefCtx(level=level), backend="device",
        use_resolve_cache=False,
    )
    assert frame == ref_frame
    (ours,) = repro_torch.decompress(ref_frame, device="cpu")
    assert ours.content_bytes() == col.tobytes()
    (theirs,) = ref_decompress(frame)
    assert theirs.content_bytes() == col.tobytes()


def test_selector_commits_to_the_reference_choice():
    col = _column("timestamps")
    resolved = repro_torch.core.resolve(
        repro_torch.numeric_profile(), [repro_torch.numeric(col)]
    )
    from repro.core import resolve as ref_resolve

    ref_resolved = ref_resolve(ref_numeric_profile(), [ref_numeric(col)], use_cache=False)
    assert resolved.codec_names() == ref_resolved.codec_names()


def test_empty_and_tiny_columns_roundtrip():
    for col in (np.zeros(0, np.uint32), np.array([5], np.uint64), np.arange(3, dtype=np.uint16)):
        frame = repro_torch.compress(repro_torch.numeric_profile(), repro_torch.numeric(col), device="cpu", use_resolve_cache=False)
        assert frame == ref_compress(ref_numeric_profile(), ref_numeric(col), use_resolve_cache=False)
        (out,) = repro_torch.decompress(frame, device="cpu")
        assert out.content_bytes() == col.tobytes()

