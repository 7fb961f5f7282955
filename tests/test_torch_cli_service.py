"""The port's ``serve`` and ``client`` commands against the reference's, on
the CPU: ``repro_torch.cli.main`` with ``--device cpu`` beside
``repro.cli.main`` with ``--backend device``.

Each side serves in its own directory on the same relative names, its
``serve`` running on a thread (its SIGINT/SIGTERM handler recorded and called
to stop it, as a signal would) while ``client`` calls run on the test's
thread, each thread's output kept apart.  The ``serve`` lines (registrations,
"serving on ...", "server stopped"), the ``client`` lines and output files of
``compress`` and ``decompress``, ``ping``'s line up to its uptime, the keys
of ``stats`` and the metric names of ``metrics`` are the reference's; the
usage errors are too.  Two ``python -m repro_torch serve`` children: one on
the CPU stopped by SIGTERM (exit 0, "server stopped"), one without a card
(exit 2 with the ``NoCardError`` message, no socket left behind).
"""
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro import cli as ref_cli  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro_torch import cli  # noqa: E402
from repro_torch.service import ServiceClient  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
DATA = b"req=deadbeef level=INFO svc=auth handled in 42us\n" * 800
UPTIME = re.compile(r"up [0-9.]+s$")


class _PerThread(io.TextIOBase):
    """A ``sys.stdout`` that keeps each thread's output apart."""

    def __init__(self):
        self.out = {}
        self._lock = threading.Lock()

    def writable(self):
        return True

    def write(self, s):
        with self._lock:
            self.out.setdefault(threading.get_ident(), io.StringIO()).write(s)
        return len(s)

    def text(self, ident):
        return self.out.get(ident, io.StringIO()).getvalue()


def _serve_session(main, serve_argv, client_argvs, cwd, monkeypatch):
    """``main(serve_argv)`` on a thread, each of ``client_argvs`` through
    ``main`` here once it answers a ping, then the recorded SIGTERM handler
    -> (serve exit code, serve output, [(client exit code, output)])."""
    handlers = {}
    monkeypatch.setattr(signal, "signal", lambda sig, fn: handlers.__setitem__(sig, fn))
    monkeypatch.chdir(cwd)
    ref_engine.resolve_cache_clear()
    repro_torch.resolve_cache_clear()
    out = _PerThread()
    monkeypatch.setattr(sys, "stdout", out)
    result = {}
    serve = threading.Thread(target=lambda: result.setdefault("rc", main(serve_argv)))
    serve.start()
    try:
        deadline = time.monotonic() + 30
        while True:
            try:
                with ServiceClient("unix:ozl.sock", timeout=5.0) as c:
                    c.ping()
                break
            except OSError:
                if time.monotonic() > deadline or not serve.is_alive():
                    raise
                time.sleep(0.05)
        clients = []
        for argv in client_argvs:
            start = len(out.text(threading.get_ident()))
            try:
                rc = main(argv)
            except SystemExit as e:
                rc = f"exit: {e}"
            clients.append((rc, out.text(threading.get_ident())[start:]))
    finally:
        handlers[signal.SIGTERM](signal.SIGTERM, None)
        serve.join(30)
    assert not serve.is_alive()
    assert set(handlers) == {signal.SIGINT, signal.SIGTERM}
    return result["rc"], out.text(serve.ident), clients


def _both(tmp_path, monkeypatch, serve_argv, client_argvs, files):
    runs = {}
    for name, main, flags in (("port", cli.main, ["--device", "cpu"]),
                              ("ref", ref_cli.main, ["--backend", "device"])):
        d = tmp_path / name
        d.mkdir()
        for fname, blob in files.items():
            (d / fname).write_bytes(blob)
        runs[name] = _serve_session(main, serve_argv + flags, client_argvs, d, monkeypatch)
    return runs["port"], runs["ref"], tmp_path / "port", tmp_path / "ref"


def test_serve_and_client_are_the_references(tmp_path, monkeypatch):
    plan = repro_torch.Compressor(repro_torch.pipeline(("zlib_backend", {"level": 6})),
                                  name="trained", level=6)
    files = {"in.bin": DATA, "trained.ozp": plan.serialize()}
    serve = ["serve", "--socket", "ozl.sock", "--profile", "text", "--profile", "generic",
             "--register", "trained.ozp", "--session-threads", "2", "--timeout", "20"]
    clients = [
        ["client", "ping", "--socket", "ozl.sock"],
        ["client", "compress", "in.bin", "--socket", "ozl.sock", "--plan-id", "generic",
         "--chunk-bytes", "8KiB"],
        ["client", "compress", "in.bin", "-o", "t.ozl", "--socket", "ozl.sock", "--plan-id",
         "trained", "--chunk-bytes", "0"],
        ["client", "decompress", "in.bin.ozl", "-o", "back.bin", "--socket", "ozl.sock"],
        ["client", "decompress", "t.ozl", "--socket", "ozl.sock"],
        ["client", "compress", "in.bin", "--socket", "ozl.sock"],
        ["client", "compress", "in.bin", "--socket", "ozl.sock", "--plan-id", "nope"],
        ["client", "compress", "--socket", "ozl.sock"],
        ["client", "stats", "--socket", "ozl.sock"],
        ["client", "metrics", "--socket", "ozl.sock"],
    ]
    (rc, served, got), (ref_rc, ref_served, want), pd, rd = _both(
        tmp_path, monkeypatch, serve, clients, files)
    assert rc == ref_rc == 0
    assert served == ref_served
    assert served.splitlines()[-2:] == ["serving on unix:ozl.sock (3 plan(s); ^C to stop)",
                                        "server stopped"]
    ping, ref_ping = got[0], want[0]
    assert ping[0] == ref_ping[0] == 0
    assert UPTIME.sub("", ping[1].strip()) == UPTIME.sub("", ref_ping[1].strip())
    assert got[1:8] == want[1:8]
    assert [g[0] for g in got[1:5]] == [0] * 4
    assert [g[0] for g in got[5:8]] == ["exit: client compress needs --plan-id", 2,
                                        "exit: client compress needs an input file"]
    for name in ("in.bin.ozl", "t.ozl", "back.bin", "t"):
        assert (pd / name).read_bytes() == (rd / name).read_bytes()
    assert (pd / "back.bin").read_bytes() == DATA == (pd / "t").read_bytes()
    stats, ref_stats = json.loads(got[8][1]), json.loads(want[8][1])
    assert set(stats) == set(ref_stats)
    assert stats["requests"] == ref_stats["requests"]
    assert stats["registry"] == ref_stats["registry"]
    names = [{ln.split("{")[0].split(" ")[0] for ln in run[9][1].splitlines()}
             for run in (got, want)]
    # the reference's device backend reports its health; the port has none
    assert names[0] == names[1] - {"ozl_backend_quarantined", "ozl_backend_failovers_total"}


def test_usage_errors_are_the_references(tmp_path, monkeypatch, capsys):
    """Usage errors exit with the reference's message; ``--workers`` (the
    reference's pre-forked plane) is not accepted."""
    for argv in (["serve", "--socket", "a.sock", "--tcp", "h:1"], ["serve"],
                 ["serve", "--socket", "a.sock", "--profile", "bogus"],
                 ["serve", "--tcp", "nope"], ["client", "ping"]):
        outs = []
        for main, extra in ((cli.main, ["--device", "cpu"] if argv[0] == "serve" else []),
                            (ref_cli.main, [])):
            monkeypatch.chdir(tmp_path)
            with pytest.raises(SystemExit) as e:
                main(argv + extra)
            outs.append(str(e.value))
        assert outs[0] == outs[1], argv
    with pytest.raises(SystemExit):
        cli.main(["serve", "--socket", "a.sock", "--workers", "2", "--device", "cpu"])
    assert "--workers" in capsys.readouterr().err


def _child(args, cwd, **env):
    full = dict(os.environ, PYTHONPATH=str(REPO / "src"), **env)
    return subprocess.Popen([sys.executable, "-m", "repro_torch", *args], cwd=cwd, env=full,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_python_dash_m_repro_torch_serve_stops_on_sigterm(tmp_path, monkeypatch):
    (tmp_path / "in.bin").write_bytes(DATA)
    proc = _child(["serve", "--socket", "ozl.sock", "--profile", "text", "--device", "cpu"],
                  tmp_path)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                with ServiceClient(str(tmp_path / "ozl.sock"), timeout=10.0) as c:
                    assert c.ping()["plans"] == 1
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, proc.stderr.read()
                time.sleep(0.1)
        monkeypatch.chdir(tmp_path)
        assert cli.main(["client", "compress", "in.bin", "--socket", "ozl.sock",
                         "--plan-id", "text"]) == 0
        repro_torch.resolve_cache_clear()
        assert (tmp_path / "in.bin.ozl").read_bytes() == repro_torch.compress(
            repro_torch.text_profile(), repro_torch.serial(DATA), device="cpu",
            chunk_bytes=4 << 20)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert out.splitlines() == ["registered profile text (digest b57578e89099)",
                                "serving on unix:ozl.sock (1 plan(s); ^C to stop)",
                                "server stopped"]
    assert not (tmp_path / "ozl.sock").exists()


def test_python_dash_m_repro_torch_serve_without_a_card_exits_2(tmp_path):
    proc = _child(["serve", "--socket", "ozl.sock", "--profile", "text"], tmp_path,
                  CUDA_VISIBLE_DEVICES="")
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 2
    assert err.startswith("error (NoCardError): repro_torch runs on the card")
    assert out == "" and list(tmp_path.iterdir()) == []
