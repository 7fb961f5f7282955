"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

Usage (from the repository root, on a machine with one CUDA card):

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero, and no result line is printed:

1. build   — compile the port's CUDA kernels from ``src/repro_torch/csrc``.
2. kernels — each kernel (delta, byte shuffle, Huffman map, tANS encode) at
             the main path's shapes, held bit-exactly (tolerance 0) against
             its plain PyTorch version on the same card, and timed beside the
             plain version and a one-call PyTorch yardstick where one exists.
3. main    — two 64 MiB numeric columns (A: 2^23 int64 nanosecond timestamps
             with jittered gaps; B: 2^24 zipf-distributed uint32 ids), made
             from ``--seed``, each through ``numeric_profile()`` at level 5,
             ``delta+transpose+huffman`` and ``delta+transpose+fse`` via
             ``repro_torch.compress(..., device="cuda")``.  Every frame
             decodes to its column; the frame of a 4 MiB prefix written on
             the card equals the one written on the CPU; every kernel's
             launch counter rose during this phase.
4. profile — one more compress per plan and column under torch.profiler
             (the card's busy time and its top kernels) and cProfile (the
             host's time by function), for the "where the time goes" record.
5. identity — the card's name and power limit.

Output: a line per phase; then the ``{"kernels": [...]}`` JSON line, the
``nvidia-smi`` name/power line, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
COLUMN_BYTES = 64 << 20
PREFIX_BYTES = 4 << 20


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def columns(seed: int):
    """A: int64 ns timestamps, monotone with jittered gaps; B: zipf uint32 ids."""
    rng = np.random.default_rng(seed)
    n_a = COLUMN_BYTES // 8
    gaps = 1_000_000 + rng.integers(-250_000, 250_000, n_a)  # ~1 ms ticks, jittered
    col_a = (1_700_000_000_000_000_000 + np.cumsum(gaps)).astype(np.int64)
    n_b = COLUMN_BYTES // 4
    id_space = rng.integers(0, 1 << 32, 1 << 22, dtype=np.uint64).astype(np.uint32)
    rank = np.minimum(rng.zipf(1.15, n_b), id_space.size) - 1
    col_b = id_space[rank]
    return {"A_timestamps_i64": col_a, "B_zipf_ids_u32": col_b}


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> float:
    import torch

    err = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"shape/dtype {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
        if not torch.equal(a, b):
            diff = (a.to(torch.float64) - b.to(torch.float64)).abs().max()
            err = max(err, 1.0, float(diff))
    return err


def kernel_phase(cols, ops, ref, entropy):
    """Each kernel at the main path's shapes against its plain version."""
    import torch

    dev = "cuda"
    col_a = torch.from_numpy(cols["A_timestamps_i64"]).to(dev)
    col_b = torch.from_numpy(cols["B_zipf_ids_u32"].view(np.int32)).to(dev)
    rows = []

    def row(name, source, replaces, err, ms, plain_ms, nbytes, nops, library_ms):
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = nops / CUDA_CORE_OPS_PER_S * 1e3
        rows.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": 0,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": library_ms,
        })
        print(f"kernel {name}: max_abs_err={err} ms={ms} plain_ms={plain_ms}"
              f" bound_ms={rows[-1]['bound_ms']} library_ms={library_ms}")

    # K1 delta on both columns' widths (int64 timestamps, uint32 ids)
    err = max_abs_err([ops.delta_encode(col_a), ops.delta_encode(col_b)],
                      [ref.delta_encode(col_a), ref.delta_encode(col_b)])
    zero = col_a.new_zeros(1)
    row("delta_encode", "src/repro_torch/csrc/delta.cu", "src/repro/kernels/delta.py:30",
        err, cuda_ms(lambda: ops.delta_encode(col_a), 20),
        cuda_ms(lambda: ref.delta_encode(col_a), 5),
        2 * COLUMN_BYTES, col_a.numel(),
        cuda_ms(lambda: torch.diff(col_a, prepend=zero), 20))

    # K3 byte shuffle: the transpose of column A's 8-byte records, and the
    # tANS lane layout (65,536 lanes of 1024 symbols)
    recs = col_a.view(torch.uint8).view(-1, 8)
    lanes = col_b.view(torch.uint8).view(-1, 1024)
    err = max_abs_err([ops.byteshuffle(recs), ops.byteshuffle(lanes)],
                      [ref.byteshuffle(recs), ref.byteshuffle(lanes)])
    row("byteshuffle", "src/repro_torch/csrc/byteshuffle.cu",
        "src/repro/kernels/byteshuffle.py:21",
        err, cuda_ms(lambda: ops.byteshuffle(recs), 20),
        cuda_ms(lambda: ref.byteshuffle(recs), 20),
        2 * COLUMN_BYTES, 0, cuda_ms(lambda: recs.t().contiguous(), 20))

    # K14 Huffman map over 2^26 byte symbols (the transposed column B)
    planes = ops.byteshuffle(col_b.view(torch.uint8).view(-1, 4)).reshape(-1)
    counts = ref.histogram_exact(planes).cpu().numpy().astype(np.int64)
    lens = entropy._huffman_code_lengths(counts)
    codes = entropy._huffman_codes_cached(lens)
    tcodes = torch.from_numpy(codes.astype(np.int32)).to(dev)
    tlens = torch.from_numpy(lens.astype(np.int32)).to(dev)
    err = max_abs_err(ops.huffman_map(planes, tcodes, tlens),
                      ref.huffman_map(planes, tcodes, tlens))
    n_sym = planes.numel()
    row("huffman_map", "src/repro_torch/csrc/huffman.cu", "src/repro/kernels/huffman.py:34",
        err, cuda_ms(lambda: ops.huffman_map(planes, tcodes, tlens), 20),
        cuda_ms(lambda: ref.huffman_map(planes, tcodes, tlens), 5),
        n_sym * (1 + 4 + 4) + 2 * 256 * 4, 0,
        cuda_ms(lambda: tcodes[planes.long()], 5))

    # K9 tANS lane walk over the same 2^26 symbols: 65,536 lanes of 1024
    table_log = 11
    norm = entropy._normalize_counts(counts, table_log)
    _ds, _dn, _db, enc, nb0, thr, st0 = entropy._fse_tables_cached(norm, table_log)
    i32 = lambda a: torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)  # noqa: E731
    lanesT = ops.byteshuffle(planes.view(-1, 1024))
    n_lanes = lanesT.shape[1]
    rem = torch.full((n_lanes,), 1024, dtype=torch.int32, device=dev)
    sym_start, compact = ref.compact_encode_table(i32(norm), i32(enc.reshape(-1)), enc.shape[1])
    args = (lanesT, rem, i32(nb0), i32(thr), i32(st0), i32(norm),
            sym_start, compact, enc.shape[1], 1 << table_log)
    err = max_abs_err(ops.fse_encode(*args), ref.fse_encode_lanes(*args))
    row("fse_encode", "src/repro_torch/csrc/fse.cu", "src/repro/kernels/fse.py:76",
        err, cuda_ms(lambda: ops.fse_encode(*args), 10),
        cuda_ms(lambda: ref.fse_encode_lanes(*args), 2),
        n_sym * (1 + 4 + 4) + n_lanes * 8 + (5 * 256 + (1 << table_log)) * 4,
        n_sym * 12, None)
    for r in rows:
        if r["max_abs_err"] != 0:
            fail(f"kernel {r['name']} disagrees with its plain version")
    return rows


def main_path(cols, rt, ops):
    """The three plans on both columns through the port's entry points."""
    import torch

    plans = {
        "numeric_l5": rt.numeric_profile(),
        "delta+transpose+huffman": rt.pipeline("delta", "transpose", "huffman"),
        "delta+transpose+fse": rt.pipeline("delta", "transpose", "fse"),
    }
    # warm the allocator, the kernels and PyTorch's lazily loaded modules on
    # small prefixes, outside the counted and timed run
    for col in cols.values():
        for plan in plans.values():
            rt.compress(plan, rt.numeric(col[: (1 << 16) // col.itemsize]), device="cuda")
    frames = {}
    ops.reset_launches()
    for cname, col in cols.items():
        for pname, plan in plans.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame = rt.compress(plan, rt.numeric(col), device="cuda")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            frames[cname, pname] = frame
            print(f"main {cname} {pname} [{frame_codecs(rt, frame)}]:"
                  f" ratio={col.nbytes / len(frame)}"
                  f" compress_MBps={col.nbytes / dt / 1e6} seconds={dt}")
    launches = ops.launch_counts()
    print(f"main launches {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"the main path never launched {missing}")
    for (cname, pname), frame in frames.items():
        col = cols[cname]
        (out,) = rt.decompress(frame)
        if out.content_bytes() != col.tobytes():
            fail(f"{cname} {pname}: decompress did not return the column")
        prefix = col[: PREFIX_BYTES // col.itemsize]
        on_card = rt.compress(plans[pname], rt.numeric(prefix), device="cuda")
        on_cpu = rt.compress(plans[pname], rt.numeric(prefix), device="cpu")
        if on_card != on_cpu:
            fail(f"{cname} {pname}: the card's 4 MiB frame differs from the CPU's")
        print(f"check {cname} {pname}: roundtrip ok, 4 MiB card frame == cpu frame"
              f" ({len(on_card)} bytes)")
    return launches


def frame_codecs(rt, frame: bytes) -> str:
    """The codecs a frame records, in execution order."""
    from repro_torch.core.codec import get_codec_by_id
    from repro_torch.core.wire import read_frame

    return "+".join(get_codec_by_id(node.codec_id).name for node in read_frame(frame)[2])


def profile_phase(cols, rt) -> None:
    """Where one compress call's time goes: the card's busy time from
    ``torch.profiler`` (its kernels, by name) and the host's time from
    ``cProfile`` (its functions, by cumulative time)."""
    import cProfile
    import pstats

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plans = {
        "numeric_l5": rt.numeric_profile(),
        "delta+transpose+huffman": rt.pipeline("delta", "transpose", "huffman"),
        "delta+transpose+fse": rt.pipeline("delta", "transpose", "fse"),
    }
    for cname, col in cols.items():
        for pname, plan in plans.items():
            stream = rt.numeric(col)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                frame = rt.compress(plan, stream, device="cuda")
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            # kernels and copies as the card ran them (op-level rows would
            # count the same time twice; the buffer request is the tracer's own)
            dev = [
                (e.self_device_time_total / 1e3, e.key[:48])
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.key != "Activity Buffer Request"
            ]
            busy_ms = sum(ms for ms, _ in dev)
            top = ", ".join(f"{k}={ms:.3f}" for ms, k in sorted(dev, reverse=True)[:5])
            print(f"profile {cname} {pname} [{frame_codecs(rt, frame)}]: wall_ms={wall_ms}"
                  f" device_busy_ms={busy_ms} idle_share={1 - busy_ms / wall_ms}"
                  f" top_device_ms: {top}")
            host = cProfile.Profile()
            host.enable()
            rt.compress(plan, stream, device="cuda")
            torch.cuda.synchronize()
            host.disable()
            stats = pstats.Stats(host).stats  # (file, line, name) -> (cc, nc, tottime, cumtime, ..)
            rows = sorted(
                ((v[2] * 1e3, f"{os.path.basename(k[0])}:{k[2]}") for k, v in stats.items()),
                reverse=True,
            )
            print(f"profile {cname} {pname} host_self_ms: "
                  + ", ".join(f"{name}={ms:.1f}" for ms, name in rows[:8]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch as rt
    from repro_torch.codecs import entropy
    from repro_torch.kernels import _build, ops, ref

    t0 = time.perf_counter()
    _build.library()
    print(f"build seconds={time.perf_counter() - t0} (compile {_build.build_seconds})")
    for text in _build.build_log:
        for line in text.splitlines():
            if "registers" in line or line.startswith("=="):
                print(f"build {line.strip()}")

    t0 = time.perf_counter()
    cols = columns(args.seed)
    print(f"data seconds={time.perf_counter() - t0} seed={args.seed}")
    rows = kernel_phase(cols, ops, ref, entropy)
    launches = main_path(cols, rt, ops)
    for r in rows:
        r["launches"] = launches[r["name"]]
    profile_phase(cols, rt)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(json.dumps({"kernels": rows}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
