"""Codec registry — the node vocabulary of the graph model.

The port's copy of ``repro.core.codec``'s spec and registries.  A codec is a
reversible pair ``(encode, decode)`` over tuples of streams; codec ids are
wire-stable and ``min_version`` gates each codec by format version.

There is one encoder per codec.  It runs on the device its input tensors
live on: a codec with a kernel launches it for a CUDA tensor and takes the
kernel's plain PyTorch version for a CPU tensor (see ``kernels/ops.py``).
There is no per-backend twin registry and no silent fallback to the host.
Decoders follow the same rule: a decoder takes its streams on one device
and returns the regenerated streams on that device, launching the decode
kernels for CUDA tensors and taking their plain versions for CPU tensors.
Only the ``zlib_backend`` leaf goes through the host, since zlib is a host
library.  A decoder whose codec has no output streams (``constant``) has no
tensor to learn the device from: its spec sets ``wants_device``, and
``run_decode`` hands it the decode device as the ``device`` keyword.

Every codec declares the reference's stream-type signature (``CodecSig``:
input ports, an abstract ``transfer``, a param schema, an expansion bound),
which ``repro_torch.analysis`` interprets over whole plans.  An encoder
refuses an input its signature rejects with ``ValueError`` before any
kernel is launched.

Every encoder call passes the fault point ``device.encode.<device
type>.<codec>`` (``device.encode.cuda.float_split`` on the card), where the
device is that of the call's input tensors: an armed
:class:`~repro_torch.reliability.faults.FaultPlan` makes the call fail there
as a card fault would, before the encoder runs.

A compression that only measures a candidate (a selector's trial, the
trainer's size probe and genome evaluation) runs under :func:`trial`.  A
codec whose reference raises on some input refuses it there as well, so that
the candidate is judged as the reference judges it; outside a trial the
codec may encode what the reference cannot (Huffman's length cap,
``codecs/entropy.py``).
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..reliability.faults import InjectedDeviceFault, fault_point
from .message import Stream

__all__ = [
    "Atom",
    "InPort",
    "ParamSpec",
    "CodecSig",
    "ANY_STYPES",
    "FIXED_STYPES",
    "BYTE_STYPES",
    "NUMERIC_WIDTHS",
    "CodecSpec",
    "register_codec",
    "get_codec",
    "get_codec_by_id",
    "all_codecs",
    "trial",
    "in_trial",
]

_IN_TRIAL: contextvars.ContextVar[bool] = contextvars.ContextVar("in_trial", default=False)


@contextlib.contextmanager
def trial():
    """Mark the compressions inside as measurements of a candidate."""
    token = _IN_TRIAL.set(True)
    try:
        yield
    finally:
        _IN_TRIAL.reset(token)


def in_trial() -> bool:
    return _IN_TRIAL.get()


EncodeFn = Callable[..., Tuple[List[Stream], bytes]]
DecodeFn = Callable[[Sequence[Stream], bytes], List[Stream]]


# ------------------------------------------------------- stream-type signatures
#
# The static contract of a codec over the stream-type lattice (paper §III-C:
# edges are *typed*), the same data as the reference's.  An ``Atom`` is one
# point of the lattice: ``(stype, width)`` with ``width is None`` meaning "any
# width legal for that stype".  ``repro_torch.analysis`` interprets whole
# plans over them before a byte is compressed; nothing here reads a tensor.

Atom = Tuple[int, Optional[int]]  # (int(SType), width-or-None)

# SType values as ints: SERIAL=0, STRUCT=1, NUMERIC=2, STRING=3.
ANY_STYPES = frozenset((0, 1, 2, 3))
FIXED_STYPES = frozenset((0, 1, 2))  # everything except STRING
BYTE_STYPES = frozenset((0,))  # SERIAL only
NUMERIC_WIDTHS = frozenset((1, 2, 4, 8))


@dataclass(frozen=True)
class InPort:
    """Acceptance constraint for one codec input edge.

    ``widths is None`` accepts any width legal for the stype; otherwise the
    concrete width must be in the set (an unknown width *may* match: the
    analyzer reports definite errors only).
    """

    stypes: frozenset
    widths: Optional[frozenset] = None

    def accepts(self, atom: Atom) -> bool:
        st, w = atom
        if st not in self.stypes:
            return False
        if self.widths is not None and w is not None and w not in self.widths:
            return False
        return True


@dataclass(frozen=True)
class ParamSpec:
    """Schema entry for one codec parameter (documentation + lint surface)."""

    name: str
    kind: str  # "int" | "int_list" | "str" | "float"
    required: bool = False
    choices: Optional[tuple] = None
    doc: str = ""


@dataclass(frozen=True)
class CodecSig:
    """Declared stream-type signature of a codec.

    * ``inputs``: one ``InPort`` per declared input; for a variadic codec
      (``n_inputs == -1``) a single port applied to every wired input.
    * ``transfer(atoms, params, n_out)``: the abstract output function.  Given
      one ``Atom`` per input (widths may be ``None``) plus the node's params
      and output count, it returns the output atoms, or ``None`` where the
      encoder would refuse the combination (concat's "all same type",
      adj_gap's equal widths, float_split's fmt).  Pure and total.
    * ``params``: the declared parameter schema.
    * ``expansion``: worst-case output-bytes/input-bytes bound over all
      outputs together.
    * ``packed_outputs``: output indices that carry entropy-packed bytes.
    """

    inputs: Tuple[InPort, ...]
    transfer: Callable[[Tuple[Atom, ...], dict, int], Optional[List[Atom]]]
    params: Tuple[ParamSpec, ...] = ()
    expansion: float = 1.0
    packed_outputs: Tuple[int, ...] = ()


@dataclass(frozen=True)
class CodecSpec:
    name: str
    codec_id: int  # wire-stable; never reuse
    encode: EncodeFn
    decode: DecodeFn
    n_inputs: int = 1  # -1 => variadic
    n_outputs: int = 1  # -1 => variadic (actual count recorded per node on wire)
    min_version: int = 1  # first format version that understands this codec
    doc: str = ""
    wants_device: bool = False  # decode(outs, header, device=...) is called
    sig: Optional[CodecSig] = None  # stream-type signature (coverage-enforced)

    def run_encode(self, streams: Sequence[Stream], params=None):
        params = dict(params or {})
        if self.n_inputs >= 0 and len(streams) != self.n_inputs:
            raise ValueError(
                f"codec {self.name}: expected {self.n_inputs} inputs, got {len(streams)}"
            )
        # injectable card failure (repro_torch.reliability), where a real
        # kernel's would surface; one contextvar read when disarmed
        device = streams[0].device.type if streams else "cpu"
        fault_point(f"device.encode.{device}.{self.name}", InjectedDeviceFault)
        outs, header = self.encode(list(streams), params)
        if self.n_outputs >= 0 and len(outs) != self.n_outputs:
            raise AssertionError(
                f"codec {self.name}: produced {len(outs)} outputs, spec says {self.n_outputs}"
            )
        if not isinstance(header, (bytes, bytearray)):
            raise AssertionError(f"codec {self.name}: header must be bytes")
        return [o.validate() for o in outs], bytes(header)

    def run_decode(self, out_streams: Sequence[Stream], header: bytes, device=None):
        """Regenerate the inputs; ``device`` is where they are built, and is
        required by a decoder that ``wants_device``."""
        if self.wants_device:
            if device is None:
                raise TypeError(f"codec {self.name}: decode needs the decode device")
            ins = self.decode(list(out_streams), header, device=torch.device(device))
        else:
            ins = self.decode(list(out_streams), header)
        return [s.validate() for s in ins]


_BY_NAME: Dict[str, CodecSpec] = {}
_BY_ID: Dict[int, CodecSpec] = {}


def register_codec(spec: CodecSpec) -> CodecSpec:
    if spec.name in _BY_NAME:
        raise ValueError(f"duplicate codec name {spec.name!r}")
    if spec.codec_id in _BY_ID:
        raise ValueError(
            f"duplicate codec id {spec.codec_id} ({spec.name!r} vs"
            f" {_BY_ID[spec.codec_id].name!r})"
        )
    _BY_NAME[spec.name] = spec
    _BY_ID[spec.codec_id] = spec
    return spec


def get_codec(name: str) -> CodecSpec:
    _ensure_standard_library()
    try:
        return _BY_NAME[name]
    except KeyError:
        raise KeyError(f"unknown codec {name!r}; known: {sorted(_BY_NAME)}") from None


def get_codec_by_id(codec_id: int) -> CodecSpec:
    _ensure_standard_library()
    try:
        return _BY_ID[codec_id]
    except KeyError:
        raise KeyError(f"unknown codec id {codec_id}") from None


def all_codecs() -> Dict[str, CodecSpec]:
    _ensure_standard_library()
    return dict(_BY_NAME)


_loaded = False
_load_lock = threading.RLock()


def _ensure_standard_library() -> None:
    """Lazily import the codec suite so ``core`` has no import cycle."""
    global _loaded
    if not _loaded:
        with _load_lock:
            if not _loaded:
                from repro_torch import codecs as _  # noqa: F401  (registers on import)

                _loaded = True
