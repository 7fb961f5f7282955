"""Wrappers around the port's CUDA kernels, with launch counters.

Each wrapper checks its tensors, allocates the outputs with ``torch.empty``
and launches its kernel on the current CUDA stream.  It takes its kernel's
plain PyTorch version (``kernels/ref.py``) only for tensors that lie on the
CPU; for a CUDA tensor it launches the kernel or raises — there is no
fallback and no size window.  ``<wrapper>.launches`` counts the launches
made by this process (reset with :func:`reset_launches`).

Kernels and the TPU kernels they replace:

  ===================  ===========================================================
  wrapper              TPU kernel (``src/repro/kernels``)
  ===================  ===========================================================
  ``delta_encode``     ``delta.py`` ``delta_encode_pallas`` (K1)
  ``byteshuffle``      ``byteshuffle.py`` ``byteshuffle_pallas`` (K3)
  ``huffman_map``      ``huffman.py`` ``huffman_map_pallas`` (K14)
  ``fse_encode``       ``fse.py`` ``fse_encode_pallas`` (K9)
  ===================  ===========================================================
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import ref

KERNELS = ("delta_encode", "byteshuffle", "huffman_map", "fse_encode")
FSE_MAX_TABLE_LOG = 15  # the encode table must fit in one block's shared memory


def _lib():
    from ._build import library

    return library()


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors; raise for any device but CPU or CUDA."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    (dev,) = devs
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"repro_torch kernels run on cuda or cpu tensors, not {dev}")
    return False


def _need(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def _launched(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def reset_launches() -> None:
    for name in KERNELS:
        globals()[name].launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: globals()[name].launches for name in KERNELS}


# ------------------------------------------------------------------ K1 delta
def delta_encode(x: torch.Tensor) -> torch.Tensor:
    """Wrapping first difference of a 1-D uint8/int16/int32/int64 carrier."""
    if x.dim() != 1 or x.element_size() not in (1, 2, 4, 8) or x.is_floating_point():
        raise TypeError(f"delta_encode: 1-D integer tensor of width 1/2/4/8, got {x.dtype}")
    if _on_cpu(x):
        return ref.delta_encode(x)
    _need(x, x.dtype, "delta_encode")
    out = torch.empty_like(x)
    if x.numel():
        _launched(
            _lib().repro_delta_encode(
                x.data_ptr(), out.data_ptr(), x.numel(), x.element_size(), _stream(x)
            ),
            "delta_encode",
        )
        delta_encode.launches += 1
    return out


delta_encode.launches = 0


# ------------------------------------------------------------ K3 byteshuffle
def byteshuffle(x: torch.Tensor) -> torch.Tensor:
    """(n, w) uint8 records -> (w, n) byte planes, for any w >= 1."""
    if x.dim() != 2:
        raise ValueError(f"byteshuffle: (n, w) tensor expected, got {tuple(x.shape)}")
    if _on_cpu(x):
        return ref.byteshuffle(x)
    _need(x, torch.uint8, "byteshuffle")
    n, w = x.shape
    out = torch.empty((w, n), dtype=torch.uint8, device=x.device)
    if x.numel():
        _launched(
            _lib().repro_byteshuffle(x.data_ptr(), out.data_ptr(), n, w, _stream(x)),
            "byteshuffle",
        )
        byteshuffle.launches += 1
    return out


byteshuffle.launches = 0


# ------------------------------------------------------------ K14 huffman map
def huffman_map(
    x: torch.Tensor, codes: torch.Tensor, lens: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symbols -> (canonical code int32, code length int32) per symbol."""
    if x.dim() != 1 or codes.shape != (256,) or lens.shape != (256,):
        raise ValueError("huffman_map: 1-D symbols and 256-entry tables expected")
    if _on_cpu(x, codes, lens):
        return ref.huffman_map(x, codes, lens)
    _need(x, torch.uint8, "huffman_map symbols")
    _need(codes, torch.int32, "huffman_map codes")
    _need(lens, torch.int32, "huffman_map lens")
    n = x.numel()
    code = torch.empty(n, dtype=torch.int32, device=x.device)
    nbits = torch.empty(n, dtype=torch.int32, device=x.device)
    if n:
        _launched(
            _lib().repro_huffman_map(
                x.data_ptr(), codes.data_ptr(), lens.data_ptr(),
                code.data_ptr(), nbits.data_ptr(), n, _stream(x),
            ),
            "huffman_map",
        )
        huffman_map.launches += 1
    return code, nbits


huffman_map.launches = 0


# ------------------------------------------------------------ K9 tANS encode
def fse_encode(
    lanesT: torch.Tensor,
    rem: torch.Tensor,
    nb0: torch.Tensor,
    thr: torch.Tensor,
    st0: torch.Tensor,
    norm: torch.Tensor,
    sym_start: torch.Tensor,
    enc_compact: torch.Tensor,
    width: int,
    total: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tANS backward lane walk -> (vals int32, nbits int32) planes + final states.

    ``lanesT`` is (max_rem, n_lanes) uint8, ``rem`` the int32 lane lengths,
    the per-symbol tables int32[256], and the encode table in its compact
    form (``ref.compact_encode_table``: ``total`` entries, located per
    symbol by ``sym_start``) so that it fits in shared memory.
    """
    max_rem, n_lanes = lanesT.shape
    tables = (nb0, thr, st0, norm, sym_start)
    if rem.shape != (n_lanes,) or any(t.shape != (256,) for t in tables):
        raise ValueError("fse_encode: rem[n_lanes] and 256-entry tables expected")
    if enc_compact.shape != (total,):
        raise ValueError("fse_encode: the compact encode table holds total entries")
    if _on_cpu(lanesT, rem, enc_compact, *tables):
        return ref.fse_encode_lanes(
            lanesT, rem, nb0, thr, st0, norm, sym_start, enc_compact, width, total
        )
    if total > 1 << FSE_MAX_TABLE_LOG:
        raise ValueError(
            f"fse_encode: table_log above {FSE_MAX_TABLE_LOG} does not fit the"
            " kernel's shared-memory encode table"
        )
    _need(lanesT, torch.uint8, "fse_encode lanes")
    for t in (rem, enc_compact, *tables):
        _need(t, torch.int32, "fse_encode tables")
    vals = torch.empty((max_rem, n_lanes), dtype=torch.int32, device=lanesT.device)
    nbs = torch.empty((max_rem, n_lanes), dtype=torch.int32, device=lanesT.device)
    state = torch.empty(n_lanes, dtype=torch.int32, device=lanesT.device)
    if n_lanes:
        _launched(
            _lib().repro_fse_encode(
                lanesT.data_ptr(), rem.data_ptr(), nb0.data_ptr(), thr.data_ptr(),
                st0.data_ptr(), norm.data_ptr(), sym_start.data_ptr(),
                enc_compact.data_ptr(), vals.data_ptr(), nbs.data_ptr(),
                state.data_ptr(), max_rem, n_lanes, total, width, _stream(lanesT),
            ),
            "fse_encode",
        )
        fse_encode.launches += 1
    return vals, nbs, state


fse_encode.launches = 0
