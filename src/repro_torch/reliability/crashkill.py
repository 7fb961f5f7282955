"""Crash-kill fuzzing: SIGKILL real subprocesses at every crash point.

The durability seams (shard rewrites, checkpoint publishes, atomic sinks)
promise specific invariants across a crash at *any* instant — the aside copy
is never swept while the canonical dir is missing, a half-written checkpoint
step is never visible, the final output path never holds partial bytes.
Monkeypatched exceptions cannot honestly test those promises: a Python
exception unwinds ``finally`` blocks and context managers that a real crash
does not.  This harness starts a genuine victim process per kill site and
``SIGKILL``s it mid-operation:

1. a *record* run (``FaultPlan(record=True)``) executes the scenario once,
   cleanly, enumerating every ``(crash point, occurrence)`` it passes;
2. one victim subprocess per site re-runs the scenario with a ``kill`` rule
   armed at exactly that occurrence — the process dies with ``-SIGKILL``,
   no cleanup code of any kind runs;
3. the parent asserts the scenario's recovery invariants over the remains.

Scenario state is content-addressed by version number (:func:`shard_arrays`
etc. are pure functions of an integer), so the parent can check that what
survived is byte-exactly *some consistent version* — old or new, never a
blend, never a torn file.

The port's copy of ``repro.reliability.crashkill``: the same three scenarios,
content and invariants, with torch tensors, run on a ``device`` (the card
unless the caller names the CPU).  The victim entry point is
``python -m repro_torch.reliability._victim SCENARIO WORKDIR [DEVICE]``,
spawned (never forked), so a card victim makes its own CUDA context; the
fault plan travels in the ``REPRO_FAULT_PLAN`` environment variable as JSON,
in the reference's form.
"""
from __future__ import annotations

import io
import json
import os
import signal
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .faults import FaultPlan

__all__ = [
    "SCENARIOS",
    "ENV_PLAN",
    "shard_arrays",
    "ckpt_tree",
    "sink_payload",
    "run_victim",
    "enumerate_sites",
    "run_kill",
    "check_invariants",
    "kill_sweep",
]

ENV_PLAN = "REPRO_FAULT_PLAN"
SITES_FILE = "sites.json"
ENCODE_POINT_PREFIX = "device.encode."  # core/codec.py: an encoder call's fault point
SCENARIOS = ("shard_rewrite", "checkpoint", "atomic_sink")
SINK_CHUNK_BYTES = 1 << 12
VICTIM_TIMEOUT = 300.0
# the directory holding the repro_torch package, put on a victim's path
_PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])


# ----------------------------------------------------------- scenario content
# Pure functions of a version number (the reference's numpy draws, as CPU
# tensors): the victim writes version 1 over a version-0 baseline, and the
# parent regenerates both to decide which one (exactly) survived the kill.
def shard_arrays(version: int) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(1000 + version)
    return {
        f"col{i:02d}": torch.from_numpy(
            rng.integers(0, 1 << 16, size=192 + 8 * i, dtype=np.uint32)
        )
        for i in range(12)
    }


def ckpt_tree(version: int) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(2000 + version)
    return {
        f"layer{i:02d}": torch.from_numpy(rng.standard_normal(48 + 4 * i).astype(np.float32))
        for i in range(16)
    }


def sink_payload(version: int) -> bytes:
    rng = np.random.default_rng(3000 + version)
    return rng.integers(0, 256, size=10 * SINK_CHUNK_BYTES, dtype=np.uint8).tobytes()


def _sink_plan():
    from ..codecs.profiles import resolve_profile_spec

    return resolve_profile_spec("generic")


# ------------------------------------------------------------------- victim
def _armed(plan: Optional[FaultPlan], fn) -> None:
    if plan is None:
        fn()
    else:
        with plan.arm(all_threads=True):
            fn()


def run_victim(scenario: str, workdir, device: str = "cuda") -> None:
    """Scenario body executed *inside the victim process*, on ``device``.

    Establishes the version-0 baseline unfaulted (once per workdir), then
    performs the version-1 operation with the environment's fault plan armed
    — the kill lands somewhere inside that operation.
    """
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    blob = os.environ.get(ENV_PLAN)
    plan = FaultPlan.from_json(blob) if blob else None
    setup_done = workdir / "setup.done"

    if scenario == "shard_rewrite":
        from ..data.shard_store import CompressedShardStore

        store = CompressedShardStore(workdir / "store", device=device)
        if not setup_done.exists():
            store.write_shard(0, shard_arrays(0))
            setup_done.touch()
        _armed(plan, lambda: store.write_shard(0, shard_arrays(1)))
    elif scenario == "checkpoint":
        from ..distributed import checkpoint as ck

        ckdir = workdir / "ckpt"
        if not setup_done.exists():
            ck.save_checkpoint(ckdir, 1, ckpt_tree(0), device=device)
            setup_done.touch()
        _armed(plan, lambda: ck.save_checkpoint(ckdir, 2, ckpt_tree(1), device=device))
    elif scenario == "atomic_sink":
        from ..core import stream_io

        src = workdir / "src.bin"
        old = workdir / "old_src.bin"
        dst = workdir / "out.ozl"
        sink_plan = _sink_plan()
        if not setup_done.exists():
            with stream_io._atomic_sink(src) as f:
                f.write(sink_payload(1))
            with stream_io._atomic_sink(old) as f:
                f.write(sink_payload(0))
            stream_io.compress_file(
                old, dst, sink_plan, device=device, chunk_bytes=SINK_CHUNK_BYTES
            )
            setup_done.touch()
        _armed(
            plan,
            lambda: stream_io.compress_file(
                src, dst, sink_plan, device=device, chunk_bytes=SINK_CHUNK_BYTES
            ),
        )
    else:
        raise SystemExit(f"unknown crash-kill scenario {scenario!r}")

    if plan is not None and plan.record:
        from ..core.stream_io import _atomic_sink

        # an encoder's fault point precedes its codec's work and tears no
        # file, so it is no kill site (the reference's host encoders pass none)
        sites = [[name, occ] for name, occ in plan.sites
                 if not name.startswith(ENCODE_POINT_PREFIX)]
        with _atomic_sink(workdir / SITES_FILE) as f:
            f.write(json.dumps(sites).encode())


# ------------------------------------------------------------------ harness
def _spawn(scenario: str, workdir: Path, plan: Optional[FaultPlan], device: str):
    env = dict(os.environ)
    if plan is not None:
        env[ENV_PLAN] = plan.to_json()
    else:
        env.pop(ENV_PLAN, None)
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = _PACKAGE_ROOT + (os.pathsep + path if path else "")
    # a victim's tensors are small: one intra-op thread each keeps a sweep's
    # parallel victims from oversubscribing the cores
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.reliability._victim", scenario,
         str(workdir), device],
        env=env,
        capture_output=True,
        timeout=VICTIM_TIMEOUT,
    )


def enumerate_sites(scenario: str, workdir, device: str = "cuda") -> List[Tuple[str, int]]:
    """Record run: execute the scenario cleanly, return every kill site."""
    workdir = Path(workdir)
    proc = _spawn(scenario, workdir, FaultPlan(record=True), device)
    if proc.returncode != 0:
        raise RuntimeError(
            f"record run for {scenario!r} failed rc={proc.returncode}:\n"
            f"{proc.stderr.decode(errors='replace')}"
        )
    sites = json.loads((workdir / SITES_FILE).read_text())
    return [(name, int(occ)) for name, occ in sites]


def run_kill(
    scenario: str, workdir, point: str, occurrence: int, device: str = "cuda"
) -> int:
    """One kill run: victim must die with SIGKILL at (point, occurrence)."""
    plan = FaultPlan().at(point, nth=occurrence, action="kill")
    proc = _spawn(scenario, Path(workdir), plan, device)
    return proc.returncode


# --------------------------------------------------------------- invariants
def _same(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> bool:
    return set(got) == set(want) and all(
        got[k].dtype == want[k].dtype and torch.equal(got[k].cpu(), want[k]) for k in want
    )


def _assert_arrays_match_version(
    got: Dict[str, torch.Tensor], make, label: str
) -> int:
    for version in (0, 1):
        if _same(got, make(version)):
            return version
    raise AssertionError(f"{label}: survivor matches neither version 0 nor 1")


def check_invariants(scenario: str, workdir, device: str = "cuda") -> dict:
    """Assert the scenario's recovery contract over a (possibly killed)
    workdir, restoring on ``device``; returns which content version survived."""
    workdir = Path(workdir)
    if scenario == "shard_rewrite":
        from ..data.shard_store import CompressedShardStore

        store = CompressedShardStore(workdir / "store", device=device)
        got = store.read_shard(0)  # promotes the aside if the kill left one
        version = _assert_arrays_match_version(got, shard_arrays, "shard 0")
        final = store.directory / "shard_000000"
        if not final.exists():
            raise AssertionError("canonical shard dir missing after recovery")
        names = {p.name for p in final.iterdir()}
        meta = json.loads((final / "meta.json").read_text())
        want_names = {f"{e['name']}.ozl" for e in meta["entries"]} | {"meta.json"}
        if names != want_names:
            raise AssertionError(
                f"orphan entries in shard dir: {sorted(names ^ want_names)}"
            )
        return {"scenario": scenario, "version": version}
    if scenario == "checkpoint":
        from ..distributed import checkpoint as ck

        ckdir = workdir / "ckpt"
        step = ck.latest_step(ckdir)
        if step is None:
            raise AssertionError("no valid checkpoint survived the kill")
        leaves, _manifest = ck.restore_checkpoint(ckdir, step, device=device)  # CRC-verified
        version = 0 if step == 1 else 1
        if not _same(leaves, ckpt_tree(version)):
            raise AssertionError(f"restored step {step} is not version {version}")
        for d in ckdir.iterdir():
            # anything published (no .tmp suffix) must be a complete step
            if d.name.startswith("step_") and not d.name.endswith(".tmp"):
                if ck._valid_manifest(d) is None:
                    raise AssertionError(f"half-published checkpoint dir {d.name}")
        return {"scenario": scenario, "version": version, "step": step}
    if scenario == "atomic_sink":
        from ..core import stream_io

        dst = workdir / "out.ozl"
        if not dst.exists():
            raise AssertionError("final output path vanished")
        out = io.BytesIO()
        stream_io.decompress_file(dst, out, device=device)  # fail-closed: any tear raises
        got = out.getvalue()
        for version in (0, 1):
            if got == sink_payload(version):
                return {"scenario": scenario, "version": version}
        raise AssertionError("final output is neither the old nor new payload")
    raise ValueError(f"unknown crash-kill scenario {scenario!r}")


# -------------------------------------------------------------------- sweep
def kill_sweep(
    base_dir,
    scenarios: Sequence[str] = SCENARIOS,
    *,
    max_workers: int = 4,
    device: str = "cuda",
) -> dict:
    """Full sweep: enumerate every kill site per scenario, SIGKILL a fresh
    victim at each, assert recovery invariants every time.  Returns a summary
    (site counts, survivor-version histogram) for reporting.

    The record runs, then the kill runs of every scenario, share one pool of
    ``max_workers`` victims at a time (each victim is a fresh interpreter
    that imports torch, so the pool is kept full across scenarios).
    """
    base_dir = Path(base_dir)

    def one(job):
        scenario, i, point, occ = job
        workdir = base_dir / scenario / f"site_{i:03d}"
        rc = run_kill(scenario, workdir, point, occ, device)
        if rc != -signal.SIGKILL:
            raise AssertionError(
                f"{scenario} site {point}#{occ}: victim exited rc={rc},"
                f" expected SIGKILL — the kill rule never fired"
            )
        return scenario, check_invariants(scenario, workdir, device)

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        recorded = list(pool.map(
            lambda sc: enumerate_sites(sc, base_dir / sc / "record", device), scenarios
        ))
        jobs = []
        for scenario, sites in zip(scenarios, recorded):
            if not sites:
                raise AssertionError(f"{scenario}: record run saw no crash points")
            check_invariants(scenario, base_dir / scenario / "record", device)
            jobs += [(scenario, i, point, occ) for i, (point, occ) in enumerate(sites)]
        results = list(pool.map(one, jobs))
    summary: dict = {"scenarios": {}, "total_sites": len(jobs)}
    for scenario, sites in zip(scenarios, recorded):
        versions: Dict[int, int] = {}
        for sc, verdict in results:
            if sc == scenario:
                versions[verdict["version"]] = versions.get(verdict["version"], 0) + 1
        summary["scenarios"][scenario] = {
            "sites": len(sites),
            "survivor_versions": versions,
        }
    return summary
