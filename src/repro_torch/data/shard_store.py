"""OpenZL-compressed training-data shards (paper §VIII "Feature storage",
"Training data" integrations); the port of ``repro.data.shard_store``.

Shards are dicts of torch tensors; every tensor is compressed on the store's
device with the leaf codec the checkpoint path uses
(:func:`repro_torch.distributed.checkpoint.compress_leaf`), and read back
onto it.  The directory layout and ``meta.json`` are the reference's (dtypes
under their numpy names), so each package reads the other's shards.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
import zlib
from pathlib import Path
from typing import Dict, List

import torch

from .. import _device
from ..core.engine import DeviceLike
from ..distributed.checkpoint import compress_leaf, decompress_leaf, dtype_name
from ..reliability.faults import crash_point


class CompressedShardStore:
    """Shards under ``directory``, compressed and read back on ``device``
    (the card unless the caller names the CPU)."""

    # a tmp dir untouched for this long is a crashed writer's leftover; a
    # *live* concurrent writer's staging dir is always younger (it is being
    # written right now), so the sweep never deletes in-flight work
    STALE_TMP_SECONDS = 15 * 60

    def __init__(self, directory, *, device: DeviceLike = "cuda"):
        self.device = _device.resolve_device(device)
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)

    def _stale_tmps(self, idx: int) -> List[Path]:
        cutoff = time.time() - self.STALE_TMP_SECONDS
        final_exists = (self.directory / f"shard_{idx:06d}").exists()
        candidates = [
            d for d in self.directory.glob(f"shard_{idx:06d}.*.tmp") if d.is_dir()
        ]
        legacy = self.directory / f"shard_{idx:06d}.tmp"
        if legacy.is_dir():  # pre-atomic-rewrite fixed tmp name (old crashes)
            candidates.append(legacy)
        out = []
        for d in candidates:
            if ".old." in d.name and not final_exists:
                continue  # the aside may be the only surviving copy: keep it
            try:
                if d.stat().st_mtime <= cutoff:
                    out.append(d)
            except OSError:
                pass  # vanished under us: someone else cleaned it
        return out

    def _recover_aside(self, idx: int) -> None:
        """Self-heal after a crash between rewrite's two ``os.replace`` calls:
        if the shard dir is missing but a renamed-aside copy exists, promote
        the newest aside back to the canonical path."""
        final = self.directory / f"shard_{idx:06d}"
        if final.exists():
            return
        stamped = []
        for d in self.directory.glob(f"shard_{idx:06d}.old.*.tmp"):
            try:
                if d.is_dir():
                    stamped.append((d.stat().st_mtime, d))
            except OSError:
                pass  # vanished between glob and stat: concurrent cleanup
        if not stamped:
            return
        newest = max(stamped, key=lambda t: t[0])[1]
        try:
            os.replace(newest, final)
        except OSError:
            pass  # another process recovered first

    def write_shard(self, idx: int, arrays: Dict[str, torch.Tensor]) -> dict:
        """Write (or atomically rewrite) one shard directory.

        Every call stages into a *fresh* unique tmp dir — reusing a stale
        ``.tmp`` left by a crashed writer would leak its orphan ``.ozl``
        entries into the new shard (present on disk, absent from
        ``meta.json``).  Rewriting an existing shard renames it aside first
        (``os.replace`` cannot replace a non-empty directory), swaps the new
        dir in, then deletes the old one; a concurrent reader may observe the
        brief gap between the two renames as a missing dir (one writer per
        shard is the contract — readers retry or tolerate), and a reader
        whose ``_recover_aside`` promotes the aside back *into* that gap is
        handled by re-renaming it aside and retrying the swap (the writer's
        new data always wins); a *crash* in that gap is recovered: the aside copy is never swept while the
        canonical dir is missing, and the next write or read promotes it
        back.  Stale tmps from crashed writers (age-gated, so a live
        concurrent writer's staging is untouched) are swept on the way out.
        """
        self._recover_aside(idx)
        final = self.directory / f"shard_{idx:06d}"
        tmp = Path(
            tempfile.mkdtemp(
                dir=self.directory, prefix=f"shard_{idx:06d}.", suffix=".tmp"
            )
        )
        crash_point("shard.staged")
        try:
            entries = []
            raw = comp = 0
            for name, t in arrays.items():
                frame = compress_leaf(t, device=self.device)
                (tmp / f"{name}.ozl").write_bytes(frame)
                crash_point("shard.entry")
                nbytes = t.numel() * t.element_size()
                raw += nbytes
                comp += len(frame)
                entries.append(
                    {
                        "name": name,
                        "shape": list(t.shape),
                        "dtype": dtype_name(t.dtype),
                        "raw_bytes": int(nbytes),
                        "compressed_bytes": len(frame),
                        "crc32": zlib.crc32(frame) & 0xFFFFFFFF,
                    }
                )
            meta = {
                "idx": idx,
                "entries": entries,
                "raw_bytes": raw,
                "compressed_bytes": comp,
            }
            (tmp / "meta.json").write_text(json.dumps(meta))
            crash_point("shard.meta")
            if final.exists():
                # rename-aside-then-replace: readers only ever see a complete
                # shard dir (old or new), never a partially deleted one
                aside = Path(
                    tempfile.mkdtemp(
                        dir=self.directory,
                        prefix=f"shard_{idx:06d}.old.",
                        suffix=".tmp",
                    )
                )
                os.rmdir(aside)
                crash_point("shard.aside.before")
                os.replace(final, aside)
                crash_point("shard.aside.after")
                for _ in range(16):
                    try:
                        os.replace(tmp, final)
                        break
                    except OSError:
                        # a concurrent reader's _recover_aside can promote
                        # the aside back into the rename gap, refilling
                        # final: move it aside again and retry — the
                        # writer's new data must win
                        try:
                            os.replace(final, aside)
                        except OSError:
                            pass
                else:
                    raise OSError(
                        f"shard {idx}: canonical dir kept reappearing while"
                        " swapping in the rewrite"
                    )
                crash_point("shard.swap.after")
                shutil.rmtree(aside, ignore_errors=True)
                crash_point("shard.cleanup")
            else:
                crash_point("shard.publish.before")
                os.replace(tmp, final)
                crash_point("shard.publish.after")
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for stale in self._stale_tmps(idx):
            shutil.rmtree(stale, ignore_errors=True)
        crash_point("shard.done")
        return meta

    def read_shard(self, idx: int) -> Dict[str, torch.Tensor]:
        d = self.directory / f"shard_{idx:06d}"
        if not d.exists():
            self._recover_aside(idx)
        meta = json.loads((d / "meta.json").read_text())
        out = {}
        for e in meta["entries"]:
            frame = (d / f"{e['name']}.ozl").read_bytes()
            if (zlib.crc32(frame) & 0xFFFFFFFF) != e["crc32"]:
                raise IOError(f"shard {idx} entry {e['name']} corrupt")
            out[e["name"]] = decompress_leaf(
                frame, tuple(e["shape"]), e["dtype"], device=self.device
            )
        return out

    def shard_ids(self) -> List[int]:
        return sorted(
            int(d.name[6:])
            for d in self.directory.iterdir()
            if d.name.startswith("shard_") and not d.name.endswith(".tmp")
        )

    def stats(self) -> dict:
        raw = comp = 0
        for i in self.shard_ids():
            meta = json.loads((self.directory / f"shard_{i:06d}" / "meta.json").read_text())
            raw += meta["raw_bytes"]
            comp += meta["compressed_bytes"]
        return {"raw_bytes": raw, "compressed_bytes": comp, "ratio": raw / max(comp, 1)}
