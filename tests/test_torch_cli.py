"""The port's command line against the reference's: ``repro_torch.cli.main``
with ``--device cpu`` beside ``repro.cli.main`` with ``--backend device``.

Each side runs in its own directory on the same relative file names, with
both resolve caches emptied before it, so output files, exit codes, stdout
and stderr compare as they are: the compressed files are byte-equal for
``generic``, ``numeric``, ``csv:N``, ``graph``, ``graph:bin:4`` and a trained
``--plan``; the compress, decompress and ``profiles`` lines, the errors (a bad
profile spec, garbage given to ``inspect``, a corrupt container failing closed
and leaving no output) and the salvage and verify case of
``tests/test_salvage.py`` are equal.  ``inspect`` is equal line for line,
each node's ``  :: in -> out`` stream types included.  The
in-place and default-path cases of ``tests/test_cli_edges.py`` hold, and one
``python -m repro_torch`` child runs with ``--device cpu``, one without a
card exits 2 with the ``NoCardError`` message and writes nothing.  All on the
CPU, tolerance 0.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import repro_torch  # noqa: E402
from repro import cli as ref_cli  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro_torch import cli  # noqa: E402
from repro_torch.core import wire  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TRAINED = REPO / "results" / "trained"
DATA = b"the quick brown fox jumps over the lazy dog\n" * 250  # 11,000 bytes


def _clear():
    ref_engine.resolve_cache_clear()
    repro_torch.resolve_cache_clear()


def _run(fn, argv, cwd, monkeypatch, capsys):
    """``fn(argv)`` in ``cwd`` -> (exit code, stdout, stderr); a SystemExit's
    message is returned as its stderr with code ``"exit"``."""
    monkeypatch.chdir(cwd)
    _clear()
    capsys.readouterr()
    try:
        rc = fn(argv)
    except SystemExit as e:
        out = capsys.readouterr()
        return "exit", out.out, str(e)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _port_argv(argv):
    if argv[0] in ("compress", "decompress"):
        return argv + ["--device", "cpu"]
    return argv


def _ref_argv(argv):
    if argv[0] == "compress":
        return argv + ["--backend", "device"]
    return argv


def _both(tmp_path, monkeypatch, capsys, argv, files=None):
    """Run the command in both packages, each in its own directory holding
    ``files`` (name -> bytes) -> (port result, reference result, port dir,
    reference dir)."""
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    for d in (port_dir, ref_dir):
        d.mkdir(exist_ok=True)
        for name, blob in (files or {}).items():
            (d / name).write_bytes(blob)
    got = _run(cli.main, _port_argv(argv), port_dir, monkeypatch, capsys)
    want = _run(ref_cli.main, _ref_argv(argv), ref_dir, monkeypatch, capsys)
    return got, want, port_dir, ref_dir


def _numeric_file() -> bytes:
    rng = np.random.default_rng(5)
    return np.cumsum(rng.integers(0, 1000, 3000)).astype(np.int64).tobytes()


def _edges() -> bytes:
    return b"# golden\n" + b"".join(b"%d\t%d\n" % (i // 3, (i * 7) % 101) for i in range(600))


def _pairs() -> bytes:
    rng = np.random.default_rng(9)
    return np.sort(rng.integers(0, 5000, (800, 2)).astype(np.uint32), axis=0).tobytes()


SPECS = {
    "generic": (["--profile", "generic", "--chunk-bytes", "4096"], DATA),
    "generic level 3 format 3": (["--profile", "generic", "--level", "3",
                                  "--format-version", "3", "--chunk-bytes", "0"], DATA),
    "numeric": (["--profile", "numeric", "--chunk-bytes", "8KiB"], _numeric_file()),
    "csv:8": (["--profile", "csv:8"], chip_smoke.make_ppmf_csv(300, 3)),
    "csv:7 unchunked": (["--profile", "csv:7", "--chunk-bytes", "0"],
                        chip_smoke.make_psam_csv(200, 4)),
    "graph": (["--profile", "graph"], _edges()),
    "graph:bin:4": (["--profile", "graph:bin:4", "--chunk-bytes", "4000"], _pairs()),
    "plan ppmf_person_7": (["--plan", str(TRAINED / "ppmf_person_7.ozp"),
                            "--chunk-bytes", "0"], chip_smoke.make_ppmf_csv(300, 3)),
    "plan psam_h_3": (["--plan", str(TRAINED / "psam_h_3.ozp"), "--chunk-bytes", "0"],
                      chip_smoke.make_psam_csv(200, 4)),
}


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_compress_and_decompress_equal_the_reference(tmp_path, monkeypatch, capsys, spec):
    flags, data = SPECS[spec]
    got, want, pd, rd = _both(tmp_path, monkeypatch, capsys,
                              ["compress", "in.bin", "-o", "in.ozl"] + flags, {"in.bin": data})
    assert got == want and got[0] == 0
    blob = (pd / "in.ozl").read_bytes()
    assert blob == (rd / "in.ozl").read_bytes()
    got, want, pd, rd = _both(tmp_path, monkeypatch, capsys, ["decompress", "in.ozl"])
    assert got == want and got[0] == 0
    assert (pd / "in").read_bytes() == data == (rd / "in").read_bytes()
    got, want, _, _ = _both(tmp_path, monkeypatch, capsys, ["inspect", "in.ozl", "--chunks", "2"])
    assert got[0] == want[0] == 0 and got[2] == want[2]
    assert got[1] == want[1]


def test_profiles_lists_the_references(tmp_path, monkeypatch, capsys):
    got, want, _, _ = _both(tmp_path, monkeypatch, capsys, ["profiles"])
    assert got == want and got[0] == 0 and "graph:bin:W" in got[1]


@pytest.mark.parametrize("spec", ["bogus", "struct:", "csv:x", "graph:bin:3", "csv:3:"])
def test_a_bad_profile_spec_is_the_references_usage_error(tmp_path, monkeypatch, capsys, spec):
    got, want, _, _ = _both(tmp_path, monkeypatch, capsys,
                            ["compress", "in.bin", "--profile", spec], {"in.bin": DATA})
    assert got == want and got[0] == "exit"


@pytest.mark.parametrize("size", ["4X", "MiB", ""])
def test_a_bad_size_is_the_references_usage_error(tmp_path, monkeypatch, capsys, size):
    got, want, _, _ = _both(tmp_path, monkeypatch, capsys,
                            ["compress", "in.bin", "--chunk-bytes", size], {"in.bin": DATA})
    assert got == want and got[0] == "exit"


def test_parse_size_is_the_references():
    for text in ("0", "1048576", "4MiB", "64K", "1.5M", "2GB", "3kb", " 7 ", "1e3"):
        assert cli._parse_size(text) == ref_cli._parse_size(text)


def test_inspect_garbage_fails_as_the_reference(tmp_path, monkeypatch, capsys):
    got, want, _, _ = _both(tmp_path, monkeypatch, capsys, ["inspect", "junk.bin"],
                            {"junk.bin": b"definitely not a frame"})
    assert got == want and got[0] == 2


def test_a_missing_input_fails_as_the_reference(tmp_path, monkeypatch, capsys):
    for argv in (["compress", "nope.bin"], ["decompress", "nope.ozl"], ["inspect", "nope.ozl"]):
        got, want, _, _ = _both(tmp_path, monkeypatch, capsys, argv)
        assert got == want and got[0] == 2


def _container(chunk: int = 2048) -> bytes:
    _clear()
    return repro_torch.compress(repro_torch.generic_profile(), repro_torch.serial(DATA),
                                device="cpu", chunk_bytes=chunk)


@pytest.mark.parametrize("where", ["chunk payload", "container trailer", "chunk length"])
def test_a_corrupt_container_fails_closed_as_the_reference(tmp_path, monkeypatch, capsys, where):
    blob = bytearray(_container())
    n, pos = wire.read_varint(blob, 5)
    flen, fpos = wire.read_varint(blob, pos)
    if where == "chunk payload":
        blob[fpos + flen // 2] ^= 0xFF
    elif where == "container trailer":
        blob[-1] ^= 0x01
    else:
        blob[pos] ^= 0x40
    got, want, pd, rd = _both(tmp_path, monkeypatch, capsys,
                              ["decompress", "bad.ozl", "-o", "out.bin"], {"bad.ozl": bytes(blob)})
    assert got == want and got[0] == 2
    assert not (pd / "out.bin").exists() and not (rd / "out.bin").exists()
    assert not list(pd.glob("*.tmp"))


def test_salvage_and_verify_as_the_reference(tmp_path, monkeypatch, capsys):
    """``tests/test_salvage.py``'s CLI case: 64 chunks, three damaged."""
    chunk = 256
    rng = np.random.default_rng(42)
    base = rng.integers(0, 8, size=64 * chunk, dtype=np.uint8)
    payload = (base + np.arange(64 * chunk, dtype=np.uint64) // chunk % 8).astype(
        np.uint8).tobytes()
    _clear()
    blob = repro_torch.compress(repro_torch.generic_profile(), repro_torch.serial(payload),
                                device="cpu", chunk_bytes=chunk)
    n, pos = wire.read_varint(blob, 5)
    spans = []
    for _ in range(n):
        ln, pos = wire.read_varint(blob, pos)
        spans.append((pos, pos + ln))
        pos += ln
    bad = bytearray(blob)
    for i in (7, 8, 40):
        lo, hi = spans[i]
        bad[(lo + hi) // 2] ^= 0xFF
    files = {"good.ozl": blob, "bad.ozl": bytes(bad)}
    for argv, rc in ((["inspect", "good.ozl", "--verify"], 0),
                     (["inspect", "bad.ozl", "--verify"], 1),
                     (["decompress", "bad.ozl", "-o", "out.bin"], 2),
                     (["decompress", "bad.ozl", "-o", "out.bin", "--salvage"], 1),
                     (["decompress", "good.ozl", "-o", "out2.bin", "--salvage"], 0)):
        got, want, pd, rd = _both(tmp_path, monkeypatch, capsys, argv, files)
        assert got == want and got[0] == rc, argv
        files = {}
    assert "61/64 recovered" in _run(cli.main, ["inspect", "bad.ozl", "--verify"], pd,
                                     monkeypatch, capsys)[1]
    assert (pd / "out.bin").read_bytes() == (rd / "out.bin").read_bytes() == b"".join(
        payload[i * chunk: (i + 1) * chunk] for i in range(64) if i not in (7, 8, 40))
    assert (pd / "out2.bin").read_bytes() == payload


def test_inspect_containers_frames_and_empty_as_the_reference(tmp_path, monkeypatch, capsys):
    import struct
    import zlib

    empty = bytearray(b"OZLC\x04")
    wire.write_varint(empty, 0)
    empty = bytes(empty) + struct.pack("<I", zlib.crc32(bytes(empty)) & 0xFFFFFFFF)
    _clear()
    frame = repro_torch.compress(repro_torch.text_profile(), repro_torch.serial(DATA),
                                 device="cpu")
    strings = repro_torch.compress(repro_torch.generic_profile(),
                                   repro_torch.strings([b"ab", b"", b"xyz"] * 30), device="cpu")
    files = {"c.ozl": _container(), "f.ozl": frame, "e.ozlc": empty, "s.ozl": strings}
    for argv in (["inspect", "c.ozl"], ["inspect", "c.ozl", "--chunks", "9"],
                 ["inspect", "f.ozl"], ["inspect", "e.ozlc"], ["inspect", "s.ozl"],
                 ["inspect", "f.ozl", "--verify"], ["inspect", "e.ozlc", "--verify"]):
        got, want, _, _ = _both(tmp_path, monkeypatch, capsys, argv, files)
        files = {}
        assert got[0] == want[0] == 0 and got[2] == want[2], argv
        assert got[1] == want[1], argv


def test_inspect_stays_on_the_host(tmp_path, monkeypatch, capsys):
    """``inspect`` parses with the CPU as the payloads' device: no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = tmp_path / "c.ozl"
    f.write_bytes(_container())
    assert cli.main(["inspect", str(f)]) == 0
    assert cli.main(["inspect", str(f), "--verify"]) == 0
    assert "container: " in capsys.readouterr().out


# ------------------------------------------------- test_cli_edges.py's cases
def test_cli_compress_in_place_roundtrips(tmp_path):
    f = tmp_path / "corpus.bin"
    f.write_bytes(DATA)
    assert cli.main(["compress", str(f), "-o", str(f), "--profile", "generic",
                     "--device", "cpu"]) == 0
    assert f.stat().st_size > 0 and f.read_bytes()[:4] == wire.MAGIC
    assert cli.main(["decompress", str(f), "-o", str(f), "--device", "cpu"]) == 0
    assert f.read_bytes() == DATA


def test_cli_default_output_paths_unharmed(tmp_path):
    f = tmp_path / "corpus.bin"
    f.write_bytes(DATA)
    assert cli.main(["compress", str(f), "--profile", "generic", "--device", "cpu"]) == 0
    assert f.read_bytes() == DATA
    ozl = tmp_path / "corpus.bin.ozl"
    assert ozl.exists()
    f.unlink()
    assert cli.main(["decompress", str(ozl), "--device", "cpu"]) == 0  # strips .ozl
    assert f.read_bytes() == DATA
    other = tmp_path / "corpus.frame"
    other.write_bytes(ozl.read_bytes())
    assert cli.main(["decompress", str(other), "--device", "cpu"]) == 0  # INPUT.out
    assert (tmp_path / "corpus.frame.out").read_bytes() == DATA


def test_cli_in_place_container_roundtrips(tmp_path):
    f = tmp_path / "big.bin"
    f.write_bytes(DATA)
    assert cli.main(["compress", str(f), "-o", str(f), "--chunk-bytes", "1K",
                     "--device", "cpu"]) == 0
    assert f.read_bytes()[:4] == wire.CONTAINER_MAGIC
    assert cli.main(["decompress", str(f), "-o", str(f), "--device", "cpu"]) == 0
    assert f.read_bytes() == DATA


# ------------------------------------------------------------- child processes
def _child(args, tmp_path, **env):
    full = dict(os.environ, PYTHONPATH=str(REPO / "src"), **env)
    return subprocess.run([sys.executable, "-m", "repro_torch", *args], cwd=tmp_path,
                          capture_output=True, text=True, env=full, timeout=300)


def test_python_dash_m_repro_torch_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    (tmp_path / "in.bin").write_bytes(DATA)
    r = _child(["compress", "in.bin", "--chunk-bytes", "2K", "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("in.bin -> in.bin.ozl: 11000 -> ")
    _clear()
    assert (tmp_path / "in.bin.ozl").read_bytes() == _container()
    r = _child(["decompress", "in.bin.ozl", "-o", "back.bin", "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "back.bin").read_bytes() == DATA


def test_python_dash_m_repro_torch_without_a_card_exits_2(tmp_path):
    (tmp_path / "in.bin").write_bytes(DATA)
    r = _child(["compress", "in.bin", "-o", "out.ozl"], tmp_path, CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 2
    assert r.stderr.startswith("error (NoCardError): repro_torch runs on the card")
    assert r.stdout == "" and sorted(p.name for p in tmp_path.iterdir()) == ["in.bin"]
