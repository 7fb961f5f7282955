"""The universal command line of the port: ``python -m repro_torch``.

The port's copy of ``repro.cli``: any named profile or serialized trained
plan compresses any file into the self-describing wire format, and every
frame, whoever wrote it, decompresses and inspects with the same two
subcommands.

    python -m repro_torch compress   corpus.bin -o corpus.ozl --profile text
    python -m repro_torch inspect    corpus.ozl [--chunks N] [--verify]
    python -m repro_torch decompress corpus.ozl -o corpus.out [--salvage]
    python -m repro_torch profiles

``compress`` and ``decompress`` run on the card unless ``--device cpu`` is
given (the reference's ``--backend`` has no counterpart: every codec runs on
the chosen device); without a card the default exits 2 with the
``NoCardError`` message and writes nothing.  Compression streams through a
:class:`~repro_torch.core.engine.CompressorSession` (``stream_io``), so a
file above ``--chunk-bytes`` (4 MiB by default) becomes an ``OZLC``
container.  ``inspect`` parses the embedded graph and stored streams on the
host without decoding any payload; its node lines carry no ``:: in -> out``
type annotation (the codec signatures are not ported).  Output files, exit
codes and printed lines are the reference's.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Callable, Dict, Tuple

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
    are never decoded."""
    version, n_inputs, nodes, stored = wire.read_frame(frame, "cpu")
    print(
        f"{indent}frame v{version}: {len(frame)} bytes, {n_inputs} input(s),"
        f" {len(nodes)} codec node(s), {len(stored)} stored stream(s)"
    )
    for i, node in enumerate(nodes):
        ins = ",".join(map(str, node.inputs))
        print(
            f"{indent}  node {i:3d}  {_codec_name(node.codec_id):<20}"
            f" in=[{ins}] out={node.n_out} header={len(node.header)}B"
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


def _cmd_profiles(_args) -> int:
    for name, (_fn, doc) in sorted(named_profiles().items()):
        print(f"{name:<12} {doc}")
    print("struct:W1,..  Generic record format: field_split + per-field auto backend.")
    print("csv:N[:sep]   CSV frontend + per-column parse_numeric + auto backends.")
    print("graph:bin:W   Binary edge-list frontend: interleaved width-W (u, v) pairs.")
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

    p = sub.add_parser("profiles", help="list named profiles")
    p.set_defaults(fn=_cmd_profiles)
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
