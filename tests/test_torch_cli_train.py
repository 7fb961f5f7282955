"""``python -m repro_torch train`` against the reference's ``python -m repro
train``, on the CPU, tolerance 0.

Each side runs in its own directory on the same relative names, the
reference with its trainer on ``backend="device"`` (``_torch_train_ref``, a
test-side patch) and both resolve caches emptied first.  On a small CSV, a
struct file and a numeric file, with ``--all-points`` and ``--seed``, the
port (``--device cpu``) writes the reference's ``.ozp`` bytes and prints its
lines, but for timings and the deploy hint's package name.  The refusals (an
unknown frontend, bad widths, ``csv`` on a file that is not CSV, empty and
unalignable samples) carry the reference's messages and codes.  Without a
card and without ``--device`` it exits 2 with the ``NoCardError`` message
and writes nothing, in-process and as a child; two children at ``--workers``
1 and 4 write identical plans, as ``tests/test_trainer_parallel.py``'s do.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_train_ref import clear_caches, ref_device_trainer  # noqa: E402

from repro import cli as ref_cli  # noqa: E402
from repro_torch import cli  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TIMING = re.compile(rb"\d+\.\d+s")


def _struct_file() -> bytes:
    rng = np.random.default_rng(0)
    n = 1500
    rec = np.empty((n, 8), np.uint8)
    rec[:, :4] = np.sort(rng.integers(0, 1 << 20, n)).astype(np.uint32).view(np.uint8).reshape(n, 4)
    rec[:, 4:] = rng.integers(0, 7, n).astype(np.uint32).view(np.uint8).reshape(n, 4)
    return rec.tobytes()


def _numeric_file() -> bytes:
    rng = np.random.default_rng(4)
    return np.sort(rng.integers(0, 1 << 24, 4000)).astype(np.uint32).tobytes()


def _csv_file() -> bytes:
    """``tests/test_trainer_parallel.py``'s CLI corpus."""
    rng = np.random.default_rng(3)
    animals = [b"cat", b"dog", b"emu"]
    rows = [b"%d,%s,%d" % (i * 5, animals[int(rng.integers(3))], int(rng.integers(50)))
            for i in range(2000)]
    return b"\n".join(rows) + b"\n"


CASES = {
    "csv": (_csv_file(), ["--pop", "4", "--gens", "1", "--seed", "0", "--sample-bytes", "8KiB"]),
    "struct": (_struct_file(), ["--frontend", "struct:4,4", "--pop", "6", "--gens", "1",
                                "--seed", "3", "--level", "7"]),
    "numeric": (_numeric_file(), ["--pop", "6", "--gens", "1", "--seed", "5", "--points", "4"]),
}


def _run(fn, argv, cwd, monkeypatch, capsys):
    """``fn(argv)`` in ``cwd`` -> (exit code, stdout, stderr); a SystemExit's
    message is returned as its stderr with code ``"exit"``."""
    monkeypatch.chdir(cwd)
    clear_caches()
    capsys.readouterr()
    try:
        rc = fn(argv)
    except SystemExit as e:
        out = capsys.readouterr()
        return "exit", out.out, str(e)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(tmp_path, monkeypatch, capsys, argv, files):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    for d in (port_dir, ref_dir):
        d.mkdir(exist_ok=True)
        for name, blob in files.items():
            (d / name).write_bytes(blob)
    got = _run(cli.main, argv + ["--device", "cpu"], port_dir, monkeypatch, capsys)
    with ref_device_trainer():
        want = _run(ref_cli.main, argv, ref_dir, monkeypatch, capsys)
    return got, want, port_dir, ref_dir


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _lines(text: str) -> list:
    text = text.replace("python -m repro_torch compress", "python -m repro compress")
    return [TIMING.sub(b"Xs", line.encode()) for line in text.splitlines()]


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_writes_the_references_plan_files(case, tmp_path, monkeypatch, capsys):
    blob, flags = CASES[case]
    argv = ["train", "in.bin", "--out", "plan.ozp", "--all-points", "--workers", "1"] + flags
    got, want, port_dir, ref_dir = _both(tmp_path, monkeypatch, capsys, argv, {"in.bin": blob})
    assert got[0] == want[0] == 0, (got, want)
    assert _lines(got[1]) == _lines(want[1])
    assert got[2] == want[2] == ""
    files = _files(port_dir)
    assert files == _files(ref_dir)
    assert len(files) > 2 and "plan.ozp" in files
    assert "verified lossless" in got[1]
    assert got[1].splitlines()[-1] == "deploy with: python -m repro_torch compress FILE --plan plan.ozp"


def test_train_without_all_points_writes_one_plan_at_the_default_path(tmp_path, monkeypatch, capsys):
    blob, flags = CASES["numeric"]
    got, want, port_dir, ref_dir = _both(
        tmp_path, monkeypatch, capsys, ["train", "vals.bin", "--workers", "2"] + flags,
        {"vals.bin": blob})
    assert got[0] == want[0] == 0
    assert _lines(got[1]) == _lines(want[1])
    assert _files(port_dir) == _files(ref_dir)
    assert sorted(_files(port_dir)) == ["vals.bin", "vals.ozp"]


REFUSALS = {
    "unknown frontend": (["--frontend", "bogus"], b"1,2\n3,4\n" * 20),
    "struct width 0": (["--frontend", "struct:4,0"], b"\x00" * 80),
    "struct no widths": (["--frontend", "struct:"], b"\x00" * 80),
    "numeric width 3": (["--frontend", "numeric:3"], b"\x00" * 81),
    "graph bin width 5": (["--frontend", "graph:bin:5"], b"\x00" * 80),
    "graph bin not a width": (["--frontend", "graph:bin:x"], b"\x00" * 80),
    "graph bin extra": (["--frontend", "graph:bin:4:2"], b"\x00" * 80),
    "graph newline separator": (["--frontend", "graph:\n"], b"1 2\n" * 40),
    "csv on binary": (["--frontend", "csv"], bytes(range(256)) * 4),
    "csv tab on commas": (["--frontend", "csv::\t"], b"1,2\n3,4\n" * 20),
    "empty sample": ([], b""),
    "nothing left after alignment": (["--frontend", "numeric:8"], b"\x01\x02\x03\x04\x05"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_train_refuses_as_the_reference_does(name, tmp_path, monkeypatch, capsys):
    flags, blob = REFUSALS[name]
    got, want, port_dir, ref_dir = _both(
        tmp_path, monkeypatch, capsys, ["train", "in.bin", "--out", "p.ozp"] + flags,
        {"in.bin": blob})
    assert got == want
    assert got[0] == "exit" and got[2]
    assert _files(port_dir) == {"in.bin": blob}


def test_train_without_a_card_exits_2_and_writes_nothing(tmp_path, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "in.bin").write_bytes(_numeric_file())
    capsys.readouterr()
    assert cli.main(["train", "in.bin", "--out", "p.ozp"]) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert out.err.startswith("error (NoCardError): repro_torch runs on the card")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["in.bin"]


# ------------------------------------------------------------- child processes
def _child(args, cwd, **env):
    full = dict(os.environ, PYTHONPATH=str(REPO / "src"), **env)
    return subprocess.run([sys.executable, "-m", "repro_torch", *args], cwd=cwd,
                          capture_output=True, text=True, env=full, timeout=300)


def test_a_child_without_a_card_exits_2(tmp_path):
    (tmp_path / "in.bin").write_bytes(_numeric_file())
    r = _child(["train", "in.bin", "--out", "p.ozp"], tmp_path, CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 2
    assert r.stderr.startswith("error (NoCardError): repro_torch runs on the card")
    assert r.stdout == "" and sorted(p.name for p in tmp_path.iterdir()) == ["in.bin"]


def test_children_at_one_and_four_workers_write_identical_plans(tmp_path):
    (tmp_path / "vals.bin").write_bytes(_numeric_file())
    blobs = {}
    for workers in (1, 4):
        r = _child(["train", "vals.bin", "--out", f"plan_w{workers}.ozp", "--pop", "6",
                    "--gens", "1", "--seed", "5", "--workers", str(workers), "--all-points",
                    "--device", "cpu"], tmp_path)
        assert r.returncode == 0, r.stderr
        assert f"on {workers} worker(s)" in r.stdout
        blobs[workers] = [p.read_bytes() for p in sorted(tmp_path.glob(f"plan_w{workers}*.ozp"))]
    assert blobs[1] == blobs[4] and len(blobs[1]) > 1
