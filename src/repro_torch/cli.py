"""The universal command line of the port: ``python -m repro_torch``.

The port's copy of ``repro.cli``: any named profile or serialized trained
plan compresses any file into the self-describing wire format, and every
frame, whoever wrote it, decompresses and inspects with the same two
subcommands.

    python -m repro_torch compress   corpus.bin -o corpus.ozl --profile text
    python -m repro_torch inspect    corpus.ozl [--chunks N] [--verify]
    python -m repro_torch decompress corpus.ozl -o corpus.out [--salvage]
    python -m repro_torch profiles
    python -m repro_torch lint       plan.ozp generic [--json]
    python -m repro_torch train      samples/*.bin --out plan.ozp [--all-points]
    python -m repro_torch serve  --socket /tmp/ozl.sock --profile text --register plan.ozp
    python -m repro_torch client compress corpus.bin --socket /tmp/ozl.sock --plan-id text

``compress`` and ``decompress`` run on the card unless ``--device cpu`` is
given (the reference's ``--backend`` has no counterpart: every codec runs on
the chosen device); without a card the default exits 2 with the
``NoCardError`` message and writes nothing.  Compression streams through a
:class:`~repro_torch.core.engine.CompressorSession` (``stream_io``), so a
file above ``--chunk-bytes`` (4 MiB by default) becomes an ``OZLC``
container.  ``inspect`` parses the embedded graph and stored streams on the
host without decoding any payload, and annotates each node with its inferred
``  :: in -> out`` stream types (``repro_torch.analysis``).  ``lint``
type-checks ``.ozp`` plans and profile specs statically: it takes no
``--device``, launches nothing and exits 1 on a type error, 2 on an
unreadable target.  ``serve`` runs the
threaded compression daemon (``repro_torch.service``) in this process, on the
card unless ``--device cpu`` is given (without a card it exits 2 with the
``NoCardError`` message), until SIGINT or SIGTERM; an ill-typed
``--register`` plan ends it with ``serve: plan ... is ill-typed: ...`` before
any socket is bound.  ``train`` is the ``zli-train`` analogue (paper
§VI-C): it sniffs the sample format (``--frontend auto``), runs the NSGA-II
trainer (``repro_torch.training``) with every candidate encoded and decoded
on the card unless ``--device cpu`` is given (without a card it exits 2 with
the ``NoCardError`` message and writes nothing), and writes deployable
``.ozp`` plans through an atomic sink, byte for byte the reference's for the
same ``--seed`` and any ``--workers``.  The reference's ``serve
--workers`` (its pre-forked plane) is not accepted yet.  ``client`` talks
to a running daemon of either package and never touches the card.  Output
files, exit codes and printed lines are the reference's, but for timings and
``train``'s deploy hint, which names ``python -m repro_torch``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Callable, Dict, Tuple

from . import _device
from . import codecs as _codecs  # noqa: F401  (registers the codec suite)
from .core import stream_io, wire
from .core.codec import get_codec_by_id
from .core.engine import CompressionCtx, Compressor
from .core.graph import Plan
from .core.message import SType
from .core.versioning import CURRENT_FORMAT_VERSION

__all__ = ["main", "named_profiles", "build_parser"]


# ------------------------------------------------------------------ profiles
def named_profiles() -> Dict[str, Tuple[Callable[[], Plan], str]]:
    """Parameterless named profiles: name -> (factory, one-line description)."""
    from .codecs.profiles import named_profiles as _named

    return _named()


def _profile_plan(spec: str) -> Plan:
    """Resolve ``--profile``: a named profile, ``struct:W1,W2,..``, ``csv:N``
    or ``graph[:bin:W]``."""
    from .codecs.profiles import resolve_profile_spec

    try:
        return resolve_profile_spec(spec)
    except ValueError as err:
        raise SystemExit(str(err)) from None


def _parse_size(text: str) -> int:
    t = text.strip()
    mult = 1
    for suffix, m in (
        ("KIB", 1 << 10), ("MIB", 1 << 20), ("GIB", 1 << 30),
        ("KB", 10 ** 3), ("MB", 10 ** 6), ("GB", 10 ** 9),
        ("K", 1 << 10), ("M", 1 << 20), ("G", 1 << 30),
    ):
        if t.upper().endswith(suffix):
            mult = m
            t = t[: -len(suffix)]
            break
    try:
        return int(float(t) * mult)
    except ValueError:
        raise SystemExit(f"bad size {text!r} (try 1048576, 4MiB, 64K, ...)") from None


def _load_compressor(args) -> Compressor:
    if args.plan:
        comp = Compressor.deserialize(Path(args.plan).read_bytes())
    else:
        comp = Compressor(_profile_plan(args.profile))
    if args.level is not None:
        comp.level = args.level
    if args.format_version is not None:
        comp.format_version = args.format_version
    return comp


# --------------------------------------------------------------- subcommands
def _cmd_compress(args) -> int:
    src = Path(args.input)
    dst = Path(args.output) if args.output else src.with_name(src.name + ".ozl")
    comp = _load_compressor(args)
    stats = stream_io.compress_file(
        src,
        dst,
        comp.plan,
        ctx=CompressionCtx(comp.format_version, comp.level),
        device=args.device,
        chunk_bytes=_parse_size(args.chunk_bytes),
        n_workers=args.workers,
        window=args.window,
    )
    ratio = stats["bytes_in"] / max(stats["bytes_out"], 1)
    kind = "container" if stats["container"] else "frame"
    print(
        f"{src} -> {dst}: {stats['bytes_in']} -> {stats['bytes_out']} bytes"
        f" (x{ratio:.2f}), {stats['chunks']} chunk(s), {kind},"
        f" plan={comp.name or comp.plan.name or 'anonymous'}"
    )
    return 0


def _cmd_decompress(args) -> int:
    src = Path(args.input)
    if args.output:
        dst = Path(args.output)
    elif src.suffix == ".ozl":
        dst = src.with_suffix("")
    else:
        dst = src.with_name(src.name + ".out")
    stats = stream_io.decompress_file(
        src, dst, device=args.device, n_workers=args.workers, window=args.window,
        salvage=args.salvage,
    )
    print(
        f"{src} -> {dst}: {stats['bytes_in']} -> {stats['bytes_out']} bytes,"
        f" {stats['chunks']} chunk(s)"
    )
    rep = stats.get("salvage")
    if rep is not None:
        report = wire.SalvageReport(
            n_chunks=rep["n_chunks"],
            recovered=list(rep["recovered"]),
            recovered_unplaced=rep["recovered_unplaced"],
            damaged=[tuple(r) for r in rep["damaged"]],
            trailer_ok=rep["trailer_ok"],
            notes=list(rep["notes"]),
        )
        print(f"salvage: {report.summary()}")
        if not rep["intact"]:
            # recovered-with-losses is distinguishable from a clean decode
            print("salvage: output is PARTIAL (see damaged ranges)", file=sys.stderr)
            return 1
    return 0


_STYPE_NAMES = {t: t.name for t in SType}


def _codec_name(codec_id: int) -> str:
    try:
        return get_codec_by_id(codec_id).name
    except KeyError:
        return f"codec#{codec_id}"


def _print_frame(frame: bytes, indent: str = "") -> None:
    """Print one frame's embedded graph; its payloads stay on the host and
    are never decoded.

    Each node is annotated with its inferred input/output stream types
    (``repro_torch.analysis`` over the codec signatures), still without
    touching any payload bytes.
    """
    from .analysis import annotate_resolved_nodes

    version, n_inputs, nodes, stored = wire.read_frame(frame, "cpu")
    print(
        f"{indent}frame v{version}: {len(frame)} bytes, {n_inputs} input(s),"
        f" {len(nodes)} codec node(s), {len(stored)} stored stream(s)"
    )
    node_types, _report = annotate_resolved_nodes(n_inputs, nodes, format_version=version)
    for i, node in enumerate(nodes):
        ins = ",".join(map(str, node.inputs))
        in_t, out_t = node_types[i]
        print(
            f"{indent}  node {i:3d}  {_codec_name(node.codec_id):<20}"
            f" in=[{ins}] out={node.n_out} header={len(node.header)}B"
            f"  :: {in_t or '-'} -> {out_t or '-'}"
        )
    payload_total = 0
    for eid in sorted(stored):
        s = stored[eid]
        payload = s.data.nbytes
        payload_total += payload
        extra = f" strings={s.n_elts}" if s.stype == SType.STRING else ""
        print(
            f"{indent}  edge {eid:4d}  {_STYPE_NAMES[s.stype]:<8} w={s.width}"
            f" n={s.n_elts} payload={payload}B{extra}"
        )
    print(f"{indent}  stored payload total: {payload_total}B")


def _cmd_inspect(args) -> int:
    path = Path(args.input)
    if args.verify:
        # a CRC walk over every chunk that reads no payload: damage is
        # reported chunk-exact and the exit code is the verdict
        with open(path, "rb") as f:
            report = wire.verify_container(f)
        print(f"{path}: {report.summary()}")
        return 0 if report.intact else 1
    with open(path, "rb") as f:
        magic = f.read(4)
        f.seek(0)
        if magic == wire.CONTAINER_MAGIC:
            sizes = []
            shown = 0
            # allow_empty: inspect is structural, so it takes a foreign
            # zero-chunk container that no writer here emits
            for i, chunk in enumerate(wire.iter_container_frames(f, allow_empty=True)):
                sizes.append(len(chunk))
                if shown < args.chunks:
                    print(f"chunk {i}:")
                    _print_frame(chunk, indent="  ")
                    shown += 1
            total = path.stat().st_size
            if not sizes:
                print(
                    f"container: 0 chunk(s), {total} bytes total"
                    " (empty container: no data, nothing to decode)"
                )
                return 0
            print(
                f"container: {len(sizes)} chunk(s), {total} bytes total,"
                f" chunk frames min/median/max ="
                f" {min(sizes)}/{sorted(sizes)[len(sizes) // 2]}/{max(sizes)}B"
            )
            if shown < len(sizes):
                print(f"(graphs shown for first {shown}; --chunks N for more)")
        elif magic == wire.MAGIC:
            _print_frame(f.read())
        else:
            print(f"{path}: not an OZLJ frame or OZLC container", file=sys.stderr)
            return 2
    return 0


# ------------------------------------------------------------------ training
def _parse_frontend(spec: str, first_sample: bytes):
    """Resolve ``--frontend``: auto-sniffing or an explicit frontend form."""
    from .codecs.parse import sniff_csv
    from .training import (
        CsvFrontend,
        Frontend,
        GraphFrontend,
        NumericFrontend,
        StructFrontend,
        detect_frontend,
    )

    if spec == "auto":
        return detect_frontend(first_sample)
    if spec == "raw":
        return Frontend()
    if spec == "csv" or spec.startswith("csv:"):
        parts = spec.split(":")
        sep = parts[2] if len(parts) > 2 else ","
        if len(parts) > 1 and parts[1]:
            return CsvFrontend(n_cols=int(parts[1]), sep=sep)
        sniffed = sniff_csv(first_sample, seps=(sep.encode(),))
        if sniffed is None:
            raise SystemExit(
                f"--frontend csv: samples are not rectangular {sep!r}-separated"
                f" CSV; pass csv:N to force a column count"
            )
        return CsvFrontend(n_cols=sniffed[0], sep=sniffed[1])
    if spec.startswith("struct:"):
        widths = tuple(int(w) for w in spec[len("struct:") :].split(",") if w)
        if not widths or any(w < 1 for w in widths):
            raise SystemExit(f"--frontend {spec!r}: field widths must be >= 1")
        return StructFrontend(widths=widths)
    if spec == "numeric" or spec.startswith("numeric:"):
        width = int(spec.split(":")[1]) if ":" in spec else 4
        if width not in (1, 2, 4, 8):
            raise SystemExit(f"--frontend {spec!r}: width must be 1/2/4/8")
        return NumericFrontend(width=width)
    if spec == "graph" or spec.startswith("graph:"):
        parts = spec.split(":")
        if len(parts) > 1 and parts[1] == "bin":
            try:
                width = int(parts[2]) if len(parts) > 2 and parts[2] else 4
            except ValueError:
                raise SystemExit(f"--frontend {spec!r}: bad pair width") from None
            if width not in (2, 4, 8) or len(parts) > 3:
                raise SystemExit(
                    f"--frontend {spec!r}: expected graph:bin:W with W in 2/4/8"
                )
            return GraphFrontend(binary_width=width)
        sep = ":".join(parts[1:]) if len(parts) > 1 else "auto"
        if not sep or "\n" in sep or "\r" in sep:
            raise SystemExit(
                f"--frontend {spec!r}: separator must be non-empty, newline-free"
            )
        return GraphFrontend(sep=sep)
    raise SystemExit(
        f"unknown frontend {spec!r}; known: auto, raw, csv[:N[:sep]],"
        f" struct:W1,W2,.., numeric[:W], graph[:sep], graph:bin[:W]"
    )


def _trim_sample(frontend, blob: bytes) -> bytes:
    """Cut a sample so the frontend parses it whole (line/record aligned)."""
    name = getattr(frontend, "name", "raw")
    if name == "csv":
        cut = blob.rfind(b"\n")
        return blob[: cut + 1] if cut >= 0 else blob
    if name == "numeric":
        return blob[: len(blob) - len(blob) % frontend.width]
    if name == "struct":
        rec = sum(frontend.widths) or 1
        return blob[: len(blob) - len(blob) % rec]
    if name == "graph":
        if frontend.binary_width:
            pair = 2 * frontend.binary_width
            return blob[: len(blob) - len(blob) % pair]
        cut = blob.rfind(b"\n")
        return blob[: cut + 1] if cut >= 0 else blob
    return blob


def _frontend_desc(frontend) -> str:
    name = getattr(frontend, "name", "raw")
    if name == "csv":
        return f"csv ({frontend.n_cols} cols, sep {frontend.sep!r})"
    if name == "numeric":
        return f"numeric (width {frontend.width})"
    if name == "struct":
        return f"struct (record {sum(frontend.widths)}B, {len(frontend.widths)} fields)"
    if name == "graph":
        if frontend.binary_width:
            return f"graph (binary pairs, width {frontend.binary_width})"
        return f"graph (edge list, sep {frontend.sep!r})"
    return name


def _cmd_train(args) -> int:
    from .core.message import serial
    from .training import train

    device = _device.resolve_device(args.device)  # no card: exit 2, nothing written
    paths = [Path(p) for p in args.samples]
    limit = _parse_size(args.sample_bytes)
    blobs = [p.read_bytes()[:limit] for p in paths]
    if not blobs or not any(blobs):
        raise SystemExit("train: no sample bytes")
    frontend = _parse_frontend(args.frontend, blobs[0])
    blobs = [_trim_sample(frontend, b) for b in blobs]
    blobs = [b for b in blobs if b]
    if not blobs:
        raise SystemExit(
            "train: no usable sample bytes after frontend alignment"
            f" ({_frontend_desc(frontend)})"
        )
    total = sum(len(b) for b in blobs)
    print(
        f"training on {len(blobs)} sample(s), {total} bytes,"
        f" frontend: {_frontend_desc(frontend)}"
    )
    tc = train(
        [[serial(b)] for b in blobs],
        frontend,
        pop_size=args.pop,
        generations=args.gens,
        n_points=args.points,
        seed=args.seed,
        workers=args.workers,
        verbose=args.verbose,
        device=device,
    )
    st = tc.stats
    print(
        f"trained in {st['train_seconds']:.1f}s: {st['evaluations']:.0f} candidate"
        f" evaluations on {st['workers']:.0f} worker(s)"
        f" ({st['eval_wall_seconds']:.1f}s candidate encode time),"
        f" {st['n_streams']:.0f} stream(s) -> {st['n_clusters']:.0f} cluster(s)"
    )
    plans = tc.pareto_plans()  # size-ascending (best ratio first)
    if not plans:
        raise SystemExit(
            "train: no Pareto point survived training — nothing to emit"
            " (try more samples, a higher --pop, or more --gens)"
        )
    print("pareto tradeoff points (training-sample size vs encode-cost estimate):")
    for i, (plan, sz, tm) in enumerate(plans):
        print(f"  [{i}] {sz:>10.0f} B  {tm * 1e3:>8.2f} ms  {len(plan.nodes)} codec node(s)")

    out = Path(args.out) if args.out else paths[0].with_suffix(".ozp")
    emitted = []
    for i, (plan, _sz, _tm) in enumerate(plans):
        if i == 0:
            path = out
        elif args.all_points:
            path = out.with_name(f"{out.stem}.p{i}{out.suffix or '.ozp'}")
        else:
            continue
        comp = Compressor(
            plan, level=args.level if args.level is not None else 5, device=device
        )
        if not all(comp.roundtrip_check(b) for b in blobs):
            raise SystemExit(f"train: point {i} failed the losslessness check")
        with stream_io._atomic_sink(path) as f:
            f.write(comp.serialize())
        emitted.append((i, path))
    if not emitted:
        raise SystemExit(
            "train: no plan emitted (every tradeoff point was skipped)"
        )
    for i, path in emitted:
        tag = "best-ratio point" if i == 0 else f"tradeoff point {i}"
        print(f"wrote {path} ({path.stat().st_size} bytes, {tag}; verified lossless)")
    print(f"deploy with: python -m repro_torch compress FILE --plan {emitted[0][1]}")
    return 0


def _cmd_lint(args) -> int:
    """Static plan analysis: type-check ``.ozp`` plans / profile specs.

    Exit 0 when every target is error-free (warnings and infos don't fail
    the lint), 1 when any target has a type error, 2 on unreadable targets.
    Nothing runs on a device.
    """
    import json

    from .analysis import check_plan
    from .codecs.profiles import resolve_profile_spec
    from .core.serialize import deserialize_plan

    results = []
    broken = False
    for target in args.targets:
        path = Path(target)
        try:
            if path.exists():
                plan, meta = deserialize_plan(path.read_bytes())
                fv = meta.get("format_version")
            else:  # not a file: treat as a profile spec (`generic`, `csv:3`)
                plan, fv = resolve_profile_spec(target), None
        except (ValueError, KeyError, OSError) as err:
            broken = True
            results.append({"target": str(target), "ok": False,
                            "load_error": str(err), "diagnostics": []})
            continue
        report = check_plan(plan, format_version=fv)
        results.append({"target": str(target), **report.to_dict()})

    n_err = sum(
        1 for r in results
        for d in r["diagnostics"] if d["severity"] == "error"
    )
    if args.json:
        print(json.dumps({"targets": results, "errors": n_err}, indent=1))
    else:
        for r in results:
            verdict = "clean" if r["ok"] else "FAILED"
            print(f"{r['target']}: {verdict}")
            if r.get("load_error"):
                print(f"  unreadable: {r['load_error']}")
            for d in r["diagnostics"]:
                loc = "".join(f" {k} {d[k]}" for k in ("node", "edge") if k in d)
                print(f"  {d['severity']}[{d['code']}]{loc}: {d['message']}")
    if broken:
        return 2
    return 1 if n_err else 0


def _cmd_profiles(_args) -> int:
    for name, (_fn, doc) in sorted(named_profiles().items()):
        print(f"{name:<12} {doc}")
    print("struct:W1,..  Generic record format: field_split + per-field auto backend.")
    print("csv:N[:sep]   CSV frontend + per-column parse_numeric + auto backends.")
    print("graph:bin:W   Binary edge-list frontend: interleaved width-W (u, v) pairs.")
    return 0


# ------------------------------------------------------------------- service
def _service_address(args) -> str:
    if args.socket and args.tcp:
        raise SystemExit("pass --socket or --tcp, not both")
    if args.socket:
        return f"unix:{args.socket}"
    if args.tcp:
        return args.tcp
    raise SystemExit("pass --socket PATH or --tcp HOST:PORT")


def _cmd_serve(args) -> int:
    import signal
    import socket

    from .service import CompressionServer, PlanRegistry
    from .service.protocol import parse_address

    spec = _service_address(args)  # exactly one of --socket / --tcp
    try:
        family, target = parse_address(spec)
    except ValueError as err:
        raise SystemExit(str(err)) from None
    device = _device.resolve_device(args.device)  # no card: exit 2, nothing served
    registry = PlanRegistry()
    try:
        for spec in args.profile or []:
            entry = registry.register_profile(spec)
            print(f"registered profile {entry.plan_id} (digest {entry.digest[:12]})")
        for path in args.register or []:
            entry = registry.register_file(path)
            print(
                f"registered plan {entry.plan_id} from {path}"
                f" (digest {entry.digest[:12]})"
            )
    except (ValueError, OSError) as err:
        raise SystemExit(f"serve: {err}") from None
    if not len(registry):
        print("warning: no plans registered; only decompress/stats will work")

    if family == socket.AF_UNIX:
        addr_kw = dict(socket_path=target)
    else:
        host, port = target
        addr_kw = dict(host=host, port=port)
    server = CompressionServer(
        registry,
        **addr_kw,
        max_clients=args.max_clients,
        sessions_per_plan=args.sessions_per_plan,
        n_workers=args.session_threads,
        window=args.window,
        request_timeout=args.timeout,
        idle_timeout=args.idle_timeout,
        admission_timeout=args.admission_timeout,
        device=device,
        rate_limit=args.rate_limit,
        rate_burst=args.rate_burst,
    )

    def _stop(_sig, _frm):
        server.request_stop()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    print(f"serving on {server.address} ({len(registry)} plan(s); ^C to stop)")
    sys.stdout.flush()
    try:
        server.serve_forever()
    finally:
        server.shutdown()
        print("server stopped")
    return 0


def _cmd_client(args) -> int:
    from .service import ServiceClient

    address = _service_address(args)
    with ServiceClient(address, timeout=args.timeout, retries=args.retries) as client:
        if args.action == "stats":
            import json

            print(json.dumps(client.stats(), indent=2, sort_keys=True))
            return 0
        if args.action == "metrics":
            sys.stdout.write(client.metrics().decode())
            return 0
        if args.action == "ping":
            info = client.ping()
            print(
                f"{address}: ok, protocol v{info['protocol_version']},"
                f" {info['plans']} plan(s), up {info['uptime_s']}s"
            )
            return 0
        if not args.input:
            raise SystemExit(f"client {args.action} needs an input file")
        src = Path(args.input)
        if args.action == "compress":
            if not args.plan_id:
                raise SystemExit("client compress needs --plan-id")
            dst = Path(args.output) if args.output else src.with_name(src.name + ".ozl")
            stats = client.compress_file(
                src, dst, args.plan_id, chunk_bytes=_parse_size(args.chunk_bytes)
            )
            ratio = stats["bytes_in"] / max(stats["bytes_out"], 1)
            kind = "container" if stats["container"] else "frame"
            print(
                f"{src} -> {dst}: {stats['bytes_in']} -> {stats['bytes_out']}"
                f" bytes (x{ratio:.2f}), {stats['chunks']} chunk(s), {kind},"
                f" plan={stats['plan_id']} digest={stats['digest'][:12]}"
            )
        else:  # decompress
            if args.output:
                dst = Path(args.output)
            elif src.suffix == ".ozl":
                dst = src.with_suffix("")
            else:
                dst = src.with_name(src.name + ".out")
            stats = client.decompress_file(src, dst)
            print(
                f"{src} -> {dst}: {stats['bytes_in']} -> {stats['bytes_out']}"
                f" bytes, {stats['chunks']} chunk(s)"
            )
    return 0


# -------------------------------------------------------------------- parser
def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="OpenZL-style graph compression on the card: universal compress /"
        " decompress / inspect over the self-describing wire format.",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress", help="compress a file with a profile or plan")
    c.add_argument("input")
    c.add_argument("-o", "--output", default=None, help="default: INPUT.ozl")
    g = c.add_mutually_exclusive_group()
    g.add_argument("--profile", default="generic", help="named profile (see"
                   " `profiles`), struct:W1,W2,.., csv:N[:sep] or graph[:bin:W]")
    g.add_argument("--plan", default=None, help="serialized trained plan (.ozp)")
    c.add_argument("--chunk-bytes", default="4MiB", help="chunk size for the"
                   " streaming container; 0 = single frame (default 4MiB)")
    c.add_argument("--device", default="cuda", help="device every codec runs on"
                   " (default cuda; cpu runs the kernels' plain versions)")
    c.add_argument("--level", type=int, default=None, help="effort 1-9")
    c.add_argument("--format-version", type=int, default=None,
                   help=f"wire format version (default {CURRENT_FORMAT_VERSION})")
    c.add_argument("--workers", type=int, default=None, help="encode threads")
    c.add_argument("--window", type=int, default=None,
                   help="max in-flight chunks (bounds peak memory)")
    c.set_defaults(fn=_cmd_compress)

    d = sub.add_parser("decompress", help="universal decode of any frame")
    d.add_argument("input")
    d.add_argument("-o", "--output", default=None,
                   help="default: strip .ozl, else INPUT.out")
    d.add_argument("--device", default="cuda", help="device every decoder runs on"
                   " (default cuda)")
    d.add_argument("--workers", type=int, default=None, help="decode threads")
    d.add_argument("--window", type=int, default=None,
                   help="max in-flight chunks (bounds peak memory)")
    d.add_argument("--salvage", action="store_true",
                   help="best-effort recovery of a damaged container: write"
                   " every intact chunk, report lost ranges, exit 1 on losses"
                   " (default: fail closed on any corruption)")
    d.set_defaults(fn=_cmd_decompress)

    i = sub.add_parser(
        "inspect", help="print a frame's embedded graph without decompressing"
    )
    i.add_argument("input")
    i.add_argument("--chunks", type=int, default=1,
                   help="container chunks to print graphs for (default 1)")
    i.add_argument("--verify", action="store_true",
                   help="walk every chunk's CRC (no payload decode); nonzero"
                   " exit + damage report when anything fails")
    i.set_defaults(fn=_cmd_inspect)

    t = sub.add_parser(
        "train", help="train a compressor from sample files (paper §VI-C)"
    )
    t.add_argument("samples", nargs="+", help="sample files (one input each)")
    t.add_argument("--out", default=None,
                   help="output plan path (default: FIRST_SAMPLE.ozp)")
    t.add_argument("--frontend", default="auto",
                   help="auto (sniff graph/csv/struct/numeric/raw), raw,"
                   " csv[:N[:sep]], struct:W1,W2,.., numeric[:W],"
                   " graph[:sep], graph:bin[:W]")
    t.add_argument("--pop", type=int, default=16, help="NSGA-II population")
    t.add_argument("--gens", type=int, default=6, help="NSGA-II generations")
    t.add_argument("--points", type=int, default=8,
                   help="max Pareto tradeoff points kept")
    t.add_argument("--seed", type=int, default=0,
                   help="training seed (same seed => byte-identical plans)")
    t.add_argument("--workers", type=int, default=None,
                   help="evaluation threads (default: all CPUs)")
    t.add_argument("--level", type=int, default=None,
                   help="effort 1-9 recorded in the emitted plan")
    t.add_argument("--sample-bytes", default="4MiB",
                   help="per-file training sample cap (default 4MiB)")
    t.add_argument("--all-points", action="store_true",
                   help="also write every tradeoff point as OUT.pN.ozp")
    t.add_argument("--device", default="cuda", help="device the candidates are"
                   " encoded and decoded on (default cuda; cpu runs the"
                   " kernels' plain versions)")
    t.add_argument("-v", "--verbose", action="store_true")
    t.set_defaults(fn=_cmd_train)

    p = sub.add_parser("profiles", help="list named profiles")
    p.set_defaults(fn=_cmd_profiles)

    ln = sub.add_parser(
        "lint", help="static type-check of .ozp plans / profile specs"
    )
    ln.add_argument("targets", nargs="+", metavar="PLAN.ozp|PROFILE",
                    help="serialized plan files or profile specs to check")
    ln.add_argument("--json", action="store_true",
                    help="machine-readable diagnostics")
    ln.set_defaults(fn=_cmd_lint)

    s = sub.add_parser(
        "serve", help="run the compression daemon (paper §VIII services)"
    )
    s.add_argument("--socket", default=None, help="Unix socket path to bind")
    s.add_argument("--tcp", default=None, help="HOST:PORT to bind (TCP)")
    s.add_argument("--register", action="append", metavar="PLAN.ozp",
                   help="serialized trained plan to register (repeatable;"
                   " id = file stem)")
    s.add_argument("--profile", action="append", metavar="NAME",
                   help="named profile to register (repeatable; id = name)")
    s.add_argument("--max-clients", type=int, default=8,
                   help="concurrent connections served (default 8)")
    s.add_argument("--sessions-per-plan", type=int, default=2,
                   help="compressor sessions pooled per plan (default 2)")
    s.add_argument("--session-threads", type=int, default=None,
                   help="encode/decode threads per compression session")
    s.add_argument("--rate-limit", type=float, default=None,
                   help="per-client token-bucket rate (requests/second) for"
                        " compress/decompress; rejected requests carry"
                        " error_kind=rate_limited + retry_after")
    s.add_argument("--rate-burst", type=float, default=None,
                   help="token-bucket burst capacity (default 2x rate)")
    s.add_argument("--window", type=int, default=None,
                   help="max in-flight chunks per request (bounds memory)")
    s.add_argument("--timeout", type=float, default=60.0,
                   help="per-request socket timeout seconds (default 60)")
    s.add_argument("--idle-timeout", type=float, default=300.0,
                   help="seconds a persistent connection may sit idle between"
                        " requests before the server drops it (default 300)")
    s.add_argument("--admission-timeout", type=float, default=None,
                   help="shed compress requests that cannot get a pooled"
                        " session within this many seconds (error_kind="
                        "overloaded + retry_after); default: block instead")
    s.add_argument("--device", default="cuda",
                   help="device every pooled session runs on (default cuda;"
                        " cpu runs the kernels' plain versions)")
    s.set_defaults(fn=_cmd_serve)

    cl = sub.add_parser("client", help="talk to a running compression daemon")
    cl.add_argument(
        "action",
        choices=["compress", "decompress", "stats", "ping", "metrics"],
    )
    cl.add_argument("input", nargs="?", default=None)
    cl.add_argument("-o", "--output", default=None, help="default: INPUT.ozl /"
                    " strip .ozl")
    cl.add_argument("--socket", default=None, help="daemon Unix socket path")
    cl.add_argument("--tcp", default=None, help="daemon HOST:PORT")
    cl.add_argument("--plan-id", default=None,
                    help="registered plan id or content digest (compress)")
    cl.add_argument("--chunk-bytes", default="4MiB",
                    help="chunk size for the container (default 4MiB, as the"
                    " offline CLI)")
    cl.add_argument("--timeout", type=float, default=60.0,
                    help="client socket timeout seconds (default 60)")
    cl.add_argument("--retries", type=int, default=0,
                    help="bounded retries (backoff + jitter, honoring the"
                         " server's retry_after) when the daemon sheds load")
    cl.set_defaults(fn=_cmd_client)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except SystemExit:
        raise
    except Exception as err:  # fail with a message, not a traceback
        kind = type(err).__name__ if not isinstance(err, wire.FrameError) else "frame"
        print(f"error ({kind}): {err}", file=sys.stderr)
        return 2


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
