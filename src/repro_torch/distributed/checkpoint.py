"""Checkpoints of torch tensor trees with OpenZL compression (paper §VIII
"PyTorch model checkpoints" / "Embedding storage"); the port of
``repro.distributed.checkpoint``.

Every leaf is compressed on the card with the float-split graphs
(f32/bf16/f64), ``zlib_backend`` (1-byte leaves) or the numeric
auto-profile, the technique the paper deploys at Meta (~17% on fp32
checkpoints, ~30% on bf16 embeddings).  Frames are self-describing, so a
restore needs no compressor configuration, and the directories are the
reference's: the same file names, manifest keys and leaf frames, the dtype
written under its numpy name, so each package restores the other's.

Fault-tolerance contract:
  * atomic: write to step_<n>.tmp, then rename -- a crash never leaves a
    half checkpoint visible (``ckpt.*`` crash points mark the steps);
  * restartable: :meth:`CheckpointManager.restore_or_none` picks the newest
    valid manifest (partial steps are skipped);
  * async: ``save()`` can overlap the next train step (a background thread
    compressing a snapshot taken on the card).

Leaves stay on the device: a save compresses a card tensor where it lies, and
a restore returns the tensors on the device it is given.  The reference's
``shardings=`` (an elastic restore onto a mesh) is not ported yet; a restore
takes a ``device=`` instead.

Trees are nested ``dict`` / ``OrderedDict`` / ``list`` / ``tuple`` / ``None``
with ``torch.Tensor`` leaves, flattened in JAX's order with JAX's key strings
(a ``dict``'s keys sorted, an ``OrderedDict``'s -- so a ``state_dict()``'s --
in insertion order, a sequence element keyed ``[i]``, ``None`` holding no
leaf), so the leaf files of a tree are numbered as the reference numbers them.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from collections import OrderedDict
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from .. import _device
from ..codecs.profiles import (
    bfloat16_profile,
    float32_profile,
    float64_profile,
    numeric_profile,
)
from ..core.engine import CompressorSession, DecompressorSession, DeviceLike
from ..core.graph import Plan, pipeline
from ..core.message import Stream, numeric
from ..reliability.faults import crash_point

__all__ = [
    "CheckpointManager",
    "close_codec_sessions",
    "codec_session_stats",
    "compress_leaf",
    "decompress_leaf",
    "dtype_name",
    "flatten_tree",
    "latest_step",
    "restore_checkpoint",
    "restore_tree",
    "save_checkpoint",
    "set_checkpoint_plan",
]

MANIFEST = "manifest.json"

# the numpy name of each dtype a leaf may have (the manifest's "dtype")
_DTYPES: Dict[str, torch.dtype] = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "uint16": torch.uint16,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
    "uint32": torch.uint32,
    "float32": torch.float32,
    "int64": torch.int64,
    "uint64": torch.uint64,
    "float64": torch.float64,
}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


def dtype_name(dtype: Union[str, torch.dtype]) -> str:
    """The numpy name of a leaf dtype (``torch.float32`` -> ``"float32"``);
    ``TypeError`` for a dtype with no route, as the reference raises."""
    name = dtype if isinstance(dtype, str) else _NAMES.get(dtype)
    if name not in _DTYPES:
        raise TypeError(f"unsupported checkpoint dtype {dtype}")
    return name


# ------------------------------------------------- long-lived codec sessions
# One CompressorSession per (leaf plan, device) and one DecompressorSession
# per device: thousands of leaves reuse the same resolve cache, coder tables
# and device instead of paying session construction per leaf.  Sessions are
# thread-safe, so the async save's thread shares them with the restore path.
_SESSION_LOCK = threading.Lock()
_ENC_SESSIONS: Dict[Tuple[Plan, torch.device], CompressorSession] = {}
_DEC_SESSIONS: Dict[torch.device, DecompressorSession] = {}


def _enc_session(plan: Plan, dev: torch.device) -> CompressorSession:
    with _SESSION_LOCK:
        sess = _ENC_SESSIONS.get((plan, dev))
        if sess is None:
            sess = _ENC_SESSIONS[plan, dev] = CompressorSession(plan, device=dev)
        return sess


def _dec_session(dev: torch.device) -> DecompressorSession:
    with _SESSION_LOCK:
        sess = _DEC_SESSIONS.get(dev)
        if sess is None:
            sess = _DEC_SESSIONS[dev] = DecompressorSession(device=dev)
        return sess


def codec_session_stats() -> dict:
    """Aggregate encode/decode session counters (the reference's keys;
    ``enc_plans`` counts the (plan, device) sessions)."""
    with _SESSION_LOCK:
        enc = [s.stats for s in _ENC_SESSIONS.values()]
        dec = [s.stats for s in _DEC_SESSIONS.values()]
    agg = {"enc_plans": len(enc)}
    for k in ("calls", "bytes_in", "bytes_out"):
        agg[f"enc_{k}"] = sum(s[k] for s in enc)
        agg[f"dec_{k}"] = int(sum(s[k] for s in dec))
    return agg


def close_codec_sessions() -> None:
    """Release the sessions' thread pools (tests / worker shutdown)."""
    with _SESSION_LOCK:
        sessions = list(_ENC_SESSIONS.values()) + list(_DEC_SESSIONS.values())
        _ENC_SESSIONS.clear()
        _DEC_SESSIONS.clear()
    for s in sessions:
        s.close()


# Trained-plan overrides: a plan registered for a dtype name ("float32", ...)
# -- or "*" for all dtypes -- replaces the shipped profile for checkpoint
# leaves.  Restore is unaffected: frames are self-describing.
_PLAN_OVERRIDES: Dict[str, Plan] = {}


def set_checkpoint_plan(dtype: str, plan: Optional[Plan]) -> None:
    """Route checkpoint leaves of the numpy dtype name ``dtype`` (or ``"*"``)
    through ``plan``; ``None`` clears the override."""
    with _SESSION_LOCK:
        if plan is None:
            _PLAN_OVERRIDES.pop(dtype, None)
        else:
            _PLAN_OVERRIDES[dtype] = plan.validate()


def _plan_for_dtype(name: str) -> Tuple[Plan, bool]:
    """-> (plan, is_trained_override)."""
    with _SESSION_LOCK:
        override = _PLAN_OVERRIDES.get(name) or _PLAN_OVERRIDES.get("*")
    if override is not None:
        return override, True
    if name == "float32":
        return float32_profile(), False
    if name == "bfloat16":
        return bfloat16_profile(), False
    if name == "float64":
        return float64_profile(), False
    if name in ("int8", "uint8", "bool"):
        return pipeline("zlib_backend"), False
    return numeric_profile(), False


def _to_numeric_stream(t: torch.Tensor) -> Stream:
    """The leaf's bit patterns as a NUMERIC stream: views on its device
    (``bool`` and the floats bit-cast), one copy only for a non-contiguous
    leaf, made on its own device."""
    flat = t.reshape(-1)
    if flat.dtype == torch.bool:
        flat = flat.view(torch.uint8)
    return numeric(flat)


def compress_leaf(t: torch.Tensor, *, device: DeviceLike = "cuda") -> bytes:
    """One leaf -> its frame, compressed on ``device`` (the card unless the
    caller names the CPU; a leaf elsewhere is moved there first)."""
    dev = _device.resolve_device(device)
    plan, trained = _plan_for_dtype(dtype_name(t.dtype))
    stream = _to_numeric_stream(t.to(dev))
    session = _enc_session(plan, dev)
    if not trained:
        return session.compress(stream)
    try:
        return session.compress(stream)
    except ValueError:
        # a plan trained on raw sample files starts from a SERIAL input (its
        # frontend re-types the bytes): feed it the leaf's bytes instead.  A
        # kernel's or the card's error is not a refusal and propagates.
        return session.compress(stream.as_serial())


def decompress_leaf(
    frame: bytes, shape, dtype: Union[str, torch.dtype], *, device: DeviceLike = "cuda"
) -> torch.Tensor:
    """A leaf's frame -> the tensor of ``shape`` and ``dtype`` on ``device``
    (a view of the decoded stream's bytes, which never leave the device)."""
    dev = _device.resolve_device(device)
    name = dtype_name(dtype)
    (stream,) = _dec_session(dev).decompress(frame)
    raw = stream.raw()
    shape = tuple(int(n) for n in shape)
    itemsize = 1 if name == "bool" else _DTYPES[name].itemsize
    count = 1
    for n in shape:
        count *= n
    if raw.numel() != count * itemsize:
        raise ValueError(
            f"leaf frame holds {raw.numel()} bytes, {shape} {name} needs {count * itemsize}"
        )
    if name == "bool":
        return raw.to(torch.bool).reshape(shape)
    return raw.view(_DTYPES[name]).reshape(shape)


# ------------------------------------------------------------- tree plumbing
def _tree_map(fn: Callable[[str, torch.Tensor], Any], tree: Any, path: Tuple[str, ...] = ()):
    """Apply ``fn(key, leaf)`` to every leaf in JAX's order, rebuilding the
    containers (a ``dict`` with its keys sorted, as JAX unflattens it)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn("/".join(path), tree)
    if type(tree) is OrderedDict:
        return OrderedDict((k, _tree_map(fn, v, path + (str(k),))) for k, v in tree.items())
    if type(tree) is dict:
        try:
            keys = sorted(tree)
        except TypeError as err:
            raise ValueError(f"checkpoint tree dict keys cannot be sorted: {err}") from None
        return {k: _tree_map(fn, tree[k], path + (str(k),)) for k in keys}
    if type(tree) in (list, tuple):
        return type(tree)(_tree_map(fn, v, path + (f"[{i}]",)) for i, v in enumerate(tree))
    raise TypeError(
        f"checkpoint tree node of type {type(tree).__name__}: leaves are torch"
        " tensors, containers dict, OrderedDict, list, tuple or None"
    )


def flatten_tree(tree: Any) -> List[Tuple[str, torch.Tensor]]:
    """``[(key, leaf), ...]`` in JAX's order with ``_leaf_key``'s strings."""
    flat: List[Tuple[str, torch.Tensor]] = []
    _tree_map(lambda key, leaf: flat.append((key, leaf)), tree)
    return flat


# ---------------------------------------------------------------- save/load
def save_checkpoint(
    directory,
    step: int,
    tree: Any,
    metadata: Optional[dict] = None,
    *,
    device: DeviceLike = "cuda",
) -> dict:
    """Compress every leaf of ``tree`` on ``device`` into ``step_<n>.tmp``,
    then publish it by renaming it to ``step_<n>`` -> the manifest."""
    dev = _device.resolve_device(device)
    directory = Path(directory)
    tmp = directory / f"step_{step:010d}.tmp"
    final = directory / f"step_{step:010d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves = []
    t0 = time.time()
    raw_total = comp_total = 0
    for i, (key, leaf) in enumerate(flatten_tree(tree)):
        frame = compress_leaf(leaf, device=dev)
        fname = f"leaf_{i:05d}.ozl"
        (tmp / fname).write_bytes(frame)
        crash_point("ckpt.leaf")
        nbytes = leaf.numel() * leaf.element_size()
        raw_total += nbytes
        comp_total += len(frame)
        leaves.append(
            {
                "key": key,
                "file": fname,
                "shape": list(leaf.shape),
                "dtype": dtype_name(leaf.dtype),
                "raw_bytes": int(nbytes),
                "compressed_bytes": len(frame),
                "crc32": zlib.crc32(frame) & 0xFFFFFFFF,
            }
        )
    manifest = {
        "step": step,
        "created": time.time(),
        "save_seconds": round(time.time() - t0, 3),
        "raw_bytes": raw_total,
        "compressed_bytes": comp_total,
        "ratio": round(raw_total / max(comp_total, 1), 4),
        "metadata": metadata or {},
        "leaves": leaves,
    }
    (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
    crash_point("ckpt.manifest")
    os.replace(tmp, final)  # atomic publish
    crash_point("ckpt.publish.after")
    return manifest


def _valid_manifest(step_dir: Path) -> Optional[dict]:
    mpath = step_dir / MANIFEST
    if not mpath.exists():
        return None
    try:
        manifest = json.loads(mpath.read_text())
        for leaf in manifest["leaves"]:
            f = step_dir / leaf["file"]
            if not f.exists():
                return None
        return manifest
    except Exception:
        return None


def restore_checkpoint(
    directory,
    step: Optional[int] = None,
    *,
    verify_crc: bool = True,
    device: DeviceLike = "cuda",
) -> Tuple[Dict[str, torch.Tensor], dict]:
    """-> ({leaf_key: tensor on ``device``}, manifest); :func:`restore_tree`
    rebuilds a tree."""
    dev = _device.resolve_device(device)
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {directory}")
    step_dir = directory / f"step_{step:010d}"
    manifest = _valid_manifest(step_dir)
    if manifest is None:
        raise FileNotFoundError(f"checkpoint step {step} invalid/missing")
    out: Dict[str, torch.Tensor] = {}
    for leaf in manifest["leaves"]:
        frame = (step_dir / leaf["file"]).read_bytes()
        if verify_crc and (zlib.crc32(frame) & 0xFFFFFFFF) != leaf["crc32"]:
            raise IOError(f"checkpoint leaf {leaf['key']} corrupt (crc mismatch)")
        out[leaf["key"]] = decompress_leaf(
            frame, tuple(leaf["shape"]), leaf["dtype"], device=dev
        )
    return out, manifest


def restore_tree(
    directory, like: Any, step: Optional[int] = None, *, device: DeviceLike = "cuda"
):
    """Rebuild a tree shaped ``like`` (a tree of tensors, ``meta`` ones
    included) on ``device``, each leaf cast to its counterpart's dtype
    -> (tree, manifest)."""
    leaves_by_key, manifest = restore_checkpoint(directory, step, device=device)

    def one(key: str, like_leaf: torch.Tensor) -> torch.Tensor:
        if key not in leaves_by_key:
            raise KeyError(f"checkpoint missing leaf {key}")
        t = leaves_by_key[key]
        return t if t.dtype == like_leaf.dtype else t.to(like_leaf.dtype)

    return _tree_map(one, like), manifest


def latest_step(directory) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for d in directory.iterdir():
        if d.name.startswith("step_") and not d.name.endswith(".tmp"):
            try:
                s = int(d.name[5:])
            except ValueError:
                continue
            if _valid_manifest(d):
                steps.append(s)
    return max(steps) if steps else None


class CheckpointManager:
    """keep-K, interval-based, optionally async checkpointing with resume.

    Leaves are compressed on ``device`` (the card unless the caller names the
    CPU).  With ``async_save`` a save returns once it has snapshotted the
    tree: each leaf is cloned on the caller's current CUDA stream and an event
    recorded there, and the background thread's own stream waits on that
    event before it compresses, so an in-place update the caller queues
    after ``save()`` returns never reaches what is saved.  The snapshot holds
    one copy of the tree in the leaves' memory until the save ends.  A
    synchronous save compresses the tree in place, on the caller's stream.
    An error of the background save is raised by the next :meth:`wait`.
    """

    def __init__(
        self,
        directory,
        *,
        save_interval: int = 100,
        keep: int = 3,
        async_save: bool = False,
        device: DeviceLike = "cuda",
    ):
        self.device = _device.resolve_device(device)
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.save_interval = save_interval
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stream = (
            torch.cuda.Stream(self.device)
            if async_save and self.device.type == "cuda"
            else None
        )
        self.history: list = []

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_interval == 0

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None) -> None:
        self.wait()
        if not self.async_save:
            self._save(step, tree, metadata)
            return
        snapshot = _tree_map(lambda _key, t: t.detach().clone(), tree)
        ready = None
        if any(t.is_cuda for _key, t in flatten_tree(snapshot)):
            ready = torch.cuda.Event()
            ready.record()  # on the caller's current stream, behind the clones

        def work():
            try:
                if self._stream is None:
                    if ready is not None:
                        ready.synchronize()
                    self._save(step, snapshot, metadata)
                    return
                if ready is not None:
                    self._stream.wait_event(ready)
                with torch.cuda.stream(self._stream):
                    self._save(step, snapshot, metadata)
                # the snapshot's memory is the caller stream's: free it only
                # after this stream's reads of it are done
                self._stream.synchronize()
            except BaseException as err:  # re-raised by wait()
                self._error = err

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _save(self, step: int, tree: Any, metadata: Optional[dict]) -> None:
        m = save_checkpoint(self.directory, step, tree, metadata, device=self.device)
        self.history.append(m)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(
            int(d.name[5:])
            for d in self.directory.iterdir()
            if d.name.startswith("step_") and not d.name.endswith(".tmp")
        )
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.directory / f"step_{s:010d}", ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def restore_or_none(self, like: Any, *, device: DeviceLike = None):
        """-> (step, tree, manifest) of the newest valid step on ``device``
        (the manager's unless given), or None."""
        step = self.latest_step()
        if step is None:
            return None
        tree, manifest = restore_tree(
            self.directory, like, step, device=self.device if device is None else device
        )
        return step, tree, manifest
