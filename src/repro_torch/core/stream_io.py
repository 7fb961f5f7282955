"""File and iterator sources and sinks for the streaming sessions — the
port's copy of ``repro.core.stream_io``.

``iter_file_chunks`` lazily reads element-aligned chunks from a file-like
object and puts each on the device as it is read; ``compress_file`` and
``decompress_file`` wire those chunks through a
:class:`~repro_torch.core.engine.CompressorSession` /
:class:`~repro_torch.core.engine.DecompressorSession` into and out of the
container record, with peak memory bounded by the session's in-flight
window, not the file size.

Wire compatibility: ``compress_file(src, dst, plan, chunk_bytes=N)`` writes
byte for byte the reference's ``compress_file`` output, which is
``compress(plan, serial(src_bytes), chunk_bytes=N)``'s for a source of known
size; a file that fits one chunk gets a bare frame, not a container.  A
source of unknown size (a pipe) gets a container whose count is backpatched
(``wire.ContainerWriter``), as the reference's does.

Path destinations are written through :func:`_atomic_sink`: staged in a
temporary file beside the destination, fsynced, moved over it with
``os.replace`` and the directory fsynced, so ``compress_file(f, f)`` reads
the intact source and an error never leaves a partial output.  The sink
and the sources carry the reference's fault seams: the sink's writes hit
``io.sink.write`` and a source's reads ``io.src.read``
(:func:`~repro_torch.reliability.faults.wrap_io`, a pass-through unless a
plan is armed), and ``sink.replace.before`` and ``sink.replace.after`` are
crash points around the publishing ``os.replace``.
"""
from __future__ import annotations

import os
import tempfile
from contextlib import contextmanager
from pathlib import Path
from typing import BinaryIO, Iterator, Optional, Union

import torch

from ..reliability.faults import crash_point, wrap_io
from .engine import (
    CompressionCtx,
    CompressorSession,
    DecompressorSession,
    DeviceLike,
    _split_chunks,
)
from .graph import Plan
from .message import Stream, serial

__all__ = [
    "iter_file_chunks",
    "iter_stream_chunks",
    "compress_file",
    "decompress_file",
]

DEFAULT_CHUNK_BYTES = 4 << 20

PathOrFile = Union[str, "os.PathLike[str]", BinaryIO]


@contextmanager
def _open(src: PathOrFile, mode: str):
    if isinstance(src, (str, os.PathLike)):
        with open(src, mode) as f:
            yield f
    else:
        yield src  # caller-owned file object: not closed here


def same_path(src: PathOrFile, dst: PathOrFile) -> bool:
    """True when two path-like arguments name the same file.

    Uses ``os.path.samefile`` (inode identity: hardlinks, symlinks) when both
    exist, falling back to resolved-path equality for a not-yet-created dst.
    File objects never compare equal: their targets are not visible.
    """
    if not (isinstance(src, (str, os.PathLike)) and isinstance(dst, (str, os.PathLike))):
        return False
    try:
        if os.path.exists(src) and os.path.exists(dst):
            return os.path.samefile(src, dst)
    except OSError:
        pass
    return os.path.realpath(os.fspath(src)) == os.path.realpath(os.fspath(dst))


def _fsync_dir(path: Path) -> None:
    """Make a rename in ``path`` durable (where the platform allows it)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextmanager
def _atomic_sink(dst: PathOrFile):
    """Open ``dst`` for writing without ever truncating the final path.

    A path destination is written through a same-directory temporary file
    that is fsynced and moved over ``dst`` with ``os.replace`` only after the
    writer body completes, and the directory is fsynced after it; on any
    error the temporary file is removed and ``dst`` is untouched.  File
    objects pass through: the caller owns them.

    A symlink destination is resolved first, so the rename replaces the
    link's target and the link survives.  A destination hardlinked under
    other names gets a fresh inode, so the other names keep the old content.
    """
    if not isinstance(dst, (str, os.PathLike)):
        yield dst
        return
    final = Path(os.path.realpath(os.fspath(dst)))
    fd, tmp_name = tempfile.mkstemp(
        dir=final.parent, prefix=final.name + ".", suffix=".tmp"
    )
    tmp = Path(tmp_name)
    try:
        # mkstemp creates 0600: restore the mode open(dst, "wb") would give
        try:
            mode = os.stat(final).st_mode & 0o7777
        except OSError:
            umask = os.umask(0)
            os.umask(umask)
            mode = 0o666 & ~umask
        os.chmod(fd, mode)
        # read and write: the unknown-count container backpatches its count
        # and re-reads its body for the CRC trailer
        with os.fdopen(fd, "r+b") as f:
            yield wrap_io(f, "io.sink")
            f.flush()
            os.fsync(f.fileno())
        crash_point("sink.replace.before")
        os.replace(tmp, final)
        crash_point("sink.replace.after")
        _fsync_dir(final.parent)
    except BaseException:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise


def _input_size(f: BinaryIO) -> Optional[int]:
    """Remaining byte count, when the source can tell (regular files).

    A non-seekable source may volunteer its total through a ``size_hint``
    attribute, which keeps it on the known-count (byte-identical) path.
    """
    hint = getattr(f, "size_hint", None)
    if hint is not None:
        return int(hint)
    try:
        if not f.seekable():
            return None
        pos = f.tell()
        end = f.seek(0, os.SEEK_END)
        f.seek(pos)
        return end - pos
    except (OSError, ValueError, AttributeError):
        return None  # a minimal reader with read() only: not seekable


def iter_file_chunks(
    f: BinaryIO, chunk_bytes: int = DEFAULT_CHUNK_BYTES, device: DeviceLike = None
) -> Iterator[Stream]:
    """Lazily read a binary source as SERIAL chunk streams of ``chunk_bytes``.

    The chunk boundaries are ``engine._split_chunks``'s on the whole file, so
    frames compressed from this iterator are byte-identical to the in-memory
    chunked path.  Holds one chunk at a time; with ``device`` each chunk is
    copied there as it is read (in a session, on its draw thread).
    """
    if chunk_bytes < 1:
        raise ValueError("chunk_bytes must be >= 1")
    dev = None if device is None else torch.device(device)
    while True:
        block = f.read(chunk_bytes)
        if not block:
            return
        s = serial(block)
        yield s if dev is None else s.to(dev)


def iter_stream_chunks(s: Stream, chunk_bytes: int) -> Iterator[Stream]:
    """Element-aligned chunk views over an in-memory stream (no copies)."""
    yield from _split_chunks(s, chunk_bytes)


def _bare(session: CompressorSession, fout, s: Stream) -> dict:
    frame = session.compress(s, chunk_bytes=0)
    fout.write(frame)
    return {"bytes_in": s.nbytes, "bytes_out": len(frame), "chunks": 1, "container": False}


def compress_file(
    src: PathOrFile,
    dst: PathOrFile,
    plan: Plan,
    *,
    ctx: Optional[CompressionCtx] = None,
    device: DeviceLike = "cuda",
    chunk_bytes: Optional[int] = DEFAULT_CHUNK_BYTES,
    n_workers: Optional[int] = None,
    window: Optional[int] = None,
    session: Optional[CompressorSession] = None,
) -> dict:
    """Compress a file without ever loading it whole -> stats dict.

    ``src`` and ``dst`` are paths or binary file objects.  With
    ``chunk_bytes`` set (the default), the input streams through the
    session's bounded window, each chunk put on the session's device as it is
    read; an input that fits one chunk becomes a bare frame.
    ``chunk_bytes=0`` or ``None`` forces the single-frame path for any size.
    Pass ``session`` to reuse a long-lived session; its plan must match, and
    its device is used.  Returns ``{"bytes_in", "bytes_out", "chunks",
    "container"}``.
    """
    own_session = session is None
    if session is None:
        session = CompressorSession(
            plan, ctx=ctx, device=device, chunk_bytes=chunk_bytes,
            n_workers=n_workers, window=window,
        )
    elif session.plan != plan:
        raise ValueError(
            f"session plan {session.plan.name!r} does not match the requested"
            f" plan {plan.name!r}; reuse one session per plan"
        )
    try:
        with _open(src, "rb") as fin, _atomic_sink(dst) as fout:
            fin = wrap_io(fin, "io.src")
            if not chunk_bytes:
                return _bare(session, fout, serial(fin.read()))
            size = _input_size(fin)
            if size is not None and size <= chunk_bytes:
                return _bare(session, fout, serial(fin.read()))
            chunks = iter_file_chunks(fin, chunk_bytes, session.device)
            if size is not None:
                n_chunks = -(-size // chunk_bytes)
                n_out = session.compress_chunks(chunks, fout, n_chunks=n_chunks)
                return {"bytes_in": size, "bytes_out": n_out, "chunks": n_chunks,
                        "container": True}
            # unknown length: look ahead one chunk so a short input still gets
            # a bare frame, as the in-memory path gives it
            first = next(chunks, None)
            if first is None:
                first = serial(b"")
            second = next(chunks, None)
            if second is None:
                return _bare(session, fout, first)
            seen = [first.nbytes + second.nbytes]

            def _chain():
                yield first
                yield second
                for ch in chunks:
                    seen[0] += ch.nbytes
                    yield ch

            before = session.stats["chunks"]
            n_out = session.compress_chunks(_chain(), fout, n_chunks=None)
            return {"bytes_in": seen[0], "bytes_out": n_out,
                    "chunks": session.stats["chunks"] - before, "container": True}
    finally:
        if own_session:
            session.close()


def decompress_file(
    src: PathOrFile,
    dst: PathOrFile,
    *,
    device: DeviceLike = "cuda",
    n_workers: Optional[int] = None,
    window: Optional[int] = None,
    session: Optional[DecompressorSession] = None,
    salvage: bool = False,
) -> dict:
    """Universal streaming decode: any frame or container -> raw content bytes.

    Container chunks decode on the session's device behind its window and
    append to ``dst`` in order, so peak memory is ~window × chunk size, not
    the output size.  The written bytes are each regenerated stream's
    ``content_bytes()`` (for data compressed by ``compress_file``, the
    original file).  Returns ``{"bytes_in", "bytes_out", "chunks"}``.

    ``salvage=True`` switches to the recovery decoder
    (:meth:`DecompressorSession.decompress_salvage`): every intact chunk of a
    damaged container is written (byte-exact, in chunk order; lost chunks are
    absent from the output) and the stats carry the damage report under
    ``"salvage"``.  The default path stays fail-closed.
    """
    own_session = session is None
    if session is None:
        session = DecompressorSession(device=device, n_workers=n_workers, window=window)
    try:
        bytes_out = chunks = 0
        with _open(src, "rb") as fin, _atomic_sink(dst) as fout:
            fin = wrap_io(fin, "io.src")
            if salvage:
                data = fin.read()
                streams, report = session.decompress_salvage(data)
                for s in streams:
                    payload = s.content_bytes()
                    fout.write(payload)
                    bytes_out += len(payload)
                    chunks += 1
                return {"bytes_in": len(data), "bytes_out": bytes_out, "chunks": chunks,
                        "salvage": report.to_dict()}
            counted = _CountingReader(fin)
            for s in session.iter_frames(counted):
                payload = s.content_bytes()
                fout.write(payload)
                bytes_out += len(payload)
                chunks += 1
        return {"bytes_in": counted.n, "bytes_out": bytes_out, "chunks": chunks}
    finally:
        if own_session:
            session.close()


class _CountingReader:
    def __init__(self, f: BinaryIO):
        self._f = f
        self.n = 0

    def read(self, n: int = -1) -> bytes:
        b = self._f.read(n)
        self.n += len(b)
        return b
