"""The port's fault plane (``repro_torch.reliability.faults``) and the seams in
its atomic sink and sources, against the reference's on the CPU.

Mirrors ``tests/test_reliability_faults.py`` for what the port has: disarmed
plans cost nothing, armed plans are seed-deterministic, a JSON plan from one
package arms the other's the same way, a torn write leaves a partial prefix,
and ``compress_file``'s sink and source faults leave no partial output.  A
record plan over the same ``compress_file`` call sees the same ``(point,
occurrence)`` list in both packages, once the port's encoder points
(``device.encode.cpu.<codec>``, one a codec call; the reference's host
encoders pass none) are set aside.
"""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.codecs.profiles import resolve_profile_spec as ref_profile_spec  # noqa: E402
from repro.core import stream_io as ref_stream_io  # noqa: E402
from repro.reliability import faults as ref_faults  # noqa: E402
from repro_torch.codecs.profiles import resolve_profile_spec  # noqa: E402
from repro_torch.core import stream_io  # noqa: E402
from repro_torch.reliability import (  # noqa: E402
    FaultPlan,
    FaultyIO,
    InjectedFault,
    crash_point,
    current_plan,
    fault_point,
    wrap_io,
)
from repro_torch.reliability import faults  # noqa: E402

CPU = "cpu"


# ------------------------------------------------------------------ disarmed
def test_disarmed_is_pass_through():
    assert current_plan() is None
    f = io.BytesIO()
    assert wrap_io(f, "io.x") is f  # the original object, not a proxy
    fault_point("any.name")  # no-op, no state
    crash_point("ckpt.leaf")


def test_the_packages_keep_separate_planes():
    with ref_faults.FaultPlan().at("p.x").arm(all_threads=True):
        assert current_plan() is None
        fault_point("p.x")  # the reference's plan is not the port's
        with FaultPlan().at("p.x").arm(all_threads=True):
            with pytest.raises(InjectedFault):
                fault_point("p.x")
    assert crash_point is fault_point


# ----------------------------------------------------------------- schedules
def test_explicit_rule_fires_on_exact_occurrence():
    plan = FaultPlan().at("p.x", nth=3)
    with plan.arm():
        fault_point("p.x")
        fault_point("p.x")
        with pytest.raises(InjectedFault):
            fault_point("p.x")
        fault_point("p.x")  # times=1: only the 3rd fires
        fault_point("p.other")  # different point, own counter
    assert plan.fired == [("p.x", 3, "raise")]


def test_occurrences_count_per_point_name():
    plan = FaultPlan().at("a.*", nth=2, times=2)
    with plan.arm():
        fault_point("a.one")
        fault_point("a.two")  # each name is on its 1st occurrence
        for _ in range(2):
            with pytest.raises(InjectedFault):
                fault_point("a.one")
        fault_point("a.one")
        with pytest.raises(InjectedFault):
            fault_point("a.two")
    assert plan.fired == [("a.one", 2, "raise"), ("a.one", 3, "raise"), ("a.two", 2, "raise")]


def _fired(plane, seed, n=200):
    plan = plane.FaultPlan(seed=seed).every("w.*", 0.3)
    fired = []
    with plan.arm():
        for i in range(n):
            try:
                plane.fault_point(f"w.{i % 5}")
            except plane.InjectedFault:
                fired.append(i)
    return fired


def test_seeded_random_schedule_is_deterministic_and_the_references():
    a = _fired(faults, 7)
    assert a == _fired(faults, 7) and a  # same seed => same sequence, and it fires
    assert _fired(faults, 8) != a
    assert a == _fired(ref_faults, 7)  # the same draws as the reference's


def test_global_arming_is_exclusive():
    p1, p2 = FaultPlan(), FaultPlan()
    with p1.arm(all_threads=True):
        with pytest.raises(RuntimeError):
            with p2.arm(all_threads=True):
                pass
    with p2.arm(all_threads=True):  # slot released on exit
        pass
    assert current_plan() is None


def test_a_global_plan_is_seen_by_other_threads():
    import threading

    seen = []
    with FaultPlan().at("t.x", nth=2).arm(all_threads=True) as plan:
        def worker():
            for _ in range(3):
                try:
                    fault_point("t.x")
                    seen.append("ok")
                except InjectedFault:
                    seen.append("fault")

        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
    assert seen == ["ok", "fault", "ok"] and plan.fired == [("t.x", 2, "raise")]


def test_bad_rules_are_refused():
    with pytest.raises(ValueError):
        FaultPlan().at("x", action="explode")
    with pytest.raises(ValueError):
        FaultPlan().at("x", nth=0)
    with pytest.raises(ValueError):
        FaultPlan().every("x", 1.5)


@pytest.mark.parametrize("direction", ("port_to_reference", "reference_to_port"))
def test_json_plan_from_one_package_arms_the_others(direction):
    src, dst = (faults, ref_faults) if direction == "port_to_reference" else (ref_faults, faults)
    plan = src.FaultPlan().at("a.x", nth=2, action="drop").at("b.*", nth=1, times=2)
    blob = plan.to_json()
    assert blob == dst.FaultPlan.from_json(blob).to_json()
    clone = dst.FaultPlan.from_json(blob)
    with clone.arm():
        dst.fault_point("a.x")
        with pytest.raises(ConnectionResetError):
            dst.fault_point("a.x")
        for name in ("b.one", "b.one"):
            with pytest.raises(dst.InjectedFault):
                dst.fault_point(name)
        dst.fault_point("b.one")
    assert clone.fired == [("a.x", 2, "drop"), ("b.one", 1, "raise"), ("b.one", 2, "raise")]
    rec = dst.FaultPlan.from_json(src.FaultPlan(record=True).to_json())
    assert rec.record


def test_custom_exception_factory():
    plan = FaultPlan().at("c.x", exc=lambda name: KeyError(name))
    with plan.arm():
        with pytest.raises(KeyError):
            fault_point("c.x")


# ----------------------------------------------------------------- I/O seams
def test_short_write_leaves_a_partial_prefix():
    buf = io.BytesIO()
    plan = FaultPlan().at("io.t.write", action="short")
    with plan.arm():
        f = wrap_io(buf, "io.t")
        assert isinstance(f, FaultyIO)
        with pytest.raises(InjectedFault):
            f.write(b"0123456789")
    assert buf.getvalue() == b"01234"  # torn, not absent and not complete


def test_proxy_passes_seek_tell_read_and_fileno_through(tmp_path):
    path = tmp_path / "f.bin"
    with open(path, "w+b") as raw, FaultPlan().arm():
        f = wrap_io(raw, "io.t")
        f.write(b"abcdef")
        assert f.tell() == 6
        f.seek(2)
        assert f.read(3) == b"cde" and f.fileno() == raw.fileno()


def _src(tmp_path, payload=b"log line payload\n" * 4000):
    src = tmp_path / "src.bin"
    src.write_bytes(payload)
    return src


@pytest.mark.parametrize("action", ("raise", "short"))
def test_compress_file_sink_fault_never_leaves_partial_output(tmp_path, action):
    src, dst = _src(tmp_path), tmp_path / "out.ozl"
    plan = resolve_profile_spec("generic")
    with FaultPlan().at("io.sink.write", nth=3, action=action).arm(all_threads=True):
        with pytest.raises(InjectedFault):
            stream_io.compress_file(src, dst, plan, device=CPU, chunk_bytes=4096)
    assert not dst.exists()  # atomic sink: the final path never appeared
    assert not list(tmp_path.glob("*.tmp"))  # staging cleaned up on the error
    stream_io.compress_file(src, dst, plan, device=CPU, chunk_bytes=4096)  # disarmed
    assert dst.read_bytes() == ref_stream_io_bytes(tmp_path, src)


def ref_stream_io_bytes(tmp_path, src):
    out = tmp_path / "ref.ozl"
    ref_stream_io.compress_file(src, out, ref_profile_spec("generic"), chunk_bytes=4096)
    return out.read_bytes()


def test_replace_fault_keeps_the_old_output(tmp_path):
    src, dst = _src(tmp_path), tmp_path / "out.ozl"
    dst.write_bytes(b"old")
    with FaultPlan().at("sink.replace.before").arm(all_threads=True):
        with pytest.raises(InjectedFault):
            stream_io.compress_file(src, dst, resolve_profile_spec("generic"), device=CPU)
    assert dst.read_bytes() == b"old" and not list(tmp_path.glob("*.tmp"))


def test_decompress_source_read_fault_propagates(tmp_path):
    src, dst, back = _src(tmp_path, b"abcdefgh" * 2000), tmp_path / "out.ozl", tmp_path / "b"
    stream_io.compress_file(src, dst, resolve_profile_spec("generic"), device=CPU,
                            chunk_bytes=4096)
    with FaultPlan().at("io.src.read").arm(all_threads=True):
        with pytest.raises(InjectedFault):
            stream_io.decompress_file(dst, back, device=CPU)
    assert not back.exists()
    with FaultPlan().at("io.src.read", nth=3).arm(all_threads=True):
        with pytest.raises(InjectedFault):
            stream_io.compress_file(src, tmp_path / "again.ozl", resolve_profile_spec("generic"),
                                    device=CPU, chunk_bytes=4096)
    assert not (tmp_path / "again.ozl").exists()
    stream_io.decompress_file(dst, back, device=CPU)
    assert back.read_bytes() == src.read_bytes()


@pytest.mark.parametrize("size,chunk_bytes", [(40960, 4096), (40961, 4096), (1000, 4096),
                                              (20000, 0)])
def test_record_plan_sees_the_references_sites(tmp_path, size, chunk_bytes):
    rng = np.random.default_rng(size)
    src = _src(tmp_path, rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    sites = {}
    for name, plane, run in (
        ("port", faults, lambda: stream_io.compress_file(
            src, tmp_path / "p.ozl", resolve_profile_spec("generic"), device=CPU,
            chunk_bytes=chunk_bytes)),
        ("reference", ref_faults, lambda: ref_stream_io.compress_file(
            src, tmp_path / "r.ozl", ref_profile_spec("generic"), chunk_bytes=chunk_bytes)),
    ):
        plan = plane.FaultPlan(record=True)
        with plan.arm(all_threads=True):
            run()
        sites[name] = plan.sites
    encoder = [n for n, _ in sites["port"] if n.startswith("device.encode.")]
    assert encoder and all(n.startswith("device.encode.cpu.") for n in encoder)
    sites["port"] = [(n, k) for n, k in sites["port"] if not n.startswith("device.encode.")]
    assert sites["port"] == sites["reference"] and sites["port"]
    assert (tmp_path / "p.ozl").read_bytes() == (tmp_path / "r.ozl").read_bytes()
    for name, plane, run in (
        ("port", faults, lambda: stream_io.decompress_file(tmp_path / "p.ozl",
                                                           tmp_path / "p.bin", device=CPU)),
        ("reference", ref_faults, lambda: ref_stream_io.decompress_file(
            tmp_path / "r.ozl", tmp_path / "r.bin")),
    ):
        plan = plane.FaultPlan(record=True)
        with plan.arm(all_threads=True):
            run()
        sites[name] = plan.sites
    assert sites["port"] == sites["reference"]
