"""Time the byte and bit kernels of one source tree on one NVIDIA card.

Usage (on a machine with one CUDA card):

    python3 kernel_turns.py [--root DIR] [--label NAME] [--seed N]

``--root`` is a checkout of this repository (default: the one that holds
this file).  Its ``src/repro_torch`` is imported and its kernels are built
into its own ``build/``; the timing is always ``cuda_ms`` and ``turns_ms`` of
the ``chip_smoke.py`` beside this file.  So one command can time two commits
by one method: unpack the other commit into a git-ignored directory and run
this script on each tree in turn, e.g. parent, change, change, parent.

What it times, each kernel first held against ``kernels/ref.py`` bit for bit:

- K4 byte unshuffle at chip_smoke's four shapes (column A's and B's planes,
  the Huffman and tANS decoders' lanes), at ragged ones (n % 16 != 0, as a
  column of arbitrary length or a lane count ceil(n / block) gives), and from
  a plane that starts 1 byte into its allocation; each in turns with
  ``t().contiguous()``;
- K5 bitpack at 4 bits on a uint8[2^26] (column G's shape) and at 8, 16 and
  32 bits on an int32[2^24] (B's deltas), and at 32 bits from an input 4
  bytes into its allocation; at 32 bits in turns with ``clone()``;
- K3 byte shuffle (in turns with ``t().contiguous()``), K6 bitunpack at 4 and
  32 bits (at 32 in turns with ``clone()``) and K11 fused delta + bitpack at
  8 bits, at chip_smoke's shapes: kernels whose sources a K4/K5 change must
  leave as they are.

Prints a line per shape, then one JSON object with every number, the card's
name and power limit as ``nvidia-smi`` gives them, and the label.  Exits
non-zero without a card or on any mismatch.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

K4_SHAPES = (
    (8, 1 << 23), (4, 1 << 24), (4096, 16384), (1024, 65536),  # chip_smoke's
    (8, (1 << 23) - 8), (4, (1 << 24) - 4), (2, (1 << 25) - 1),  # ragged columns
    (4096, 16383), (1024, 65535),  # ragged lane counts
)
K4_OFFSET_SHAPES = ((8, 1 << 23), (4096, 16384))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this script times kernels on the card")
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch.kernels import _build, ops, ref

    _build.library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    result = {"label": args.label, "root": os.path.relpath(os.path.abspath(args.root), HERE)}

    def check(got, want, what):
        if not torch.equal(got, want):
            cs.fail(f"{args.label}: {what} differs from its plain version")

    def planes(w, n, offset=0):
        buf = torch.randint(0, 256, (w * n + offset,), dtype=torch.uint8, device="cuda",
                            generator=gen)
        return buf[offset:].view(w, n)

    k4 = {}
    for w, n in K4_SHAPES:
        k4[f"({w}, {n})"] = planes(w, n)
    for w, n in K4_OFFSET_SHAPES:
        k4[f"({w}, {n}) +1 byte"] = planes(w, n, 1)
    result["byteunshuffle"] = {}
    for key, p in k4.items():
        check(ops.byteunshuffle(p), ref.byteunshuffle(p), f"byteunshuffle {key}")
        ms, lib = cs.turns_ms(lambda p=p: ops.byteunshuffle(p), lambda p=p: p.t().contiguous(), 20)
        bound = 2 * p.numel() / cs.HBM_BYTES_PER_S * 1e3
        result["byteunshuffle"][key] = {"ms": ms, "library_ms": lib, "bound_ms": bound}
        print(f"{args.label} byteunshuffle {key}: ms={ms} t_contiguous_ms={lib} bound_ms={bound}")
    del k4

    g = torch.randint(0, 16, (1 << 26,), dtype=torch.uint8, device="cuda", generator=gen)
    d_full = torch.randint(-(1 << 31), 1 << 31, ((1 << 24) + 1,), dtype=torch.int64,
                           device="cuda", generator=gen).to(torch.int32)
    d, d_off = d_full[:-1], d_full[1:]
    cases = {"uint8[2^26] at 4 bits": (g, 4), "int32[2^24] at 8 bits": (d, 8),
             "int32[2^24] at 16 bits": (d, 16), "int32[2^24] at 32 bits": (d, 32),
             "int32[2^24] +4 bytes at 32 bits": (d_off, 32)}
    result["bitpack"] = {}
    for key, (x, bits) in cases.items():
        check(ops.bitpack(x, bits), ref.bitpack(x, bits), f"bitpack {key}")
        bound = (x.numel() * x.element_size() + x.numel() * bits // 8) / cs.HBM_BYTES_PER_S * 1e3
        if bits == 32:
            ms, lib = cs.turns_ms(lambda x=x: ops.bitpack(x, 32), lambda x=x: x.clone(), 20)
        else:
            ms, lib = min(cs.cuda_ms(lambda x=x, b=bits: ops.bitpack(x, b), 20) for _ in range(3)), None
        result["bitpack"][key] = {"ms": ms, "clone_ms": lib, "bound_ms": bound}
        print(f"{args.label} bitpack {key}: ms={ms} clone_ms={lib} bound_ms={bound}")

    recs = planes(8, 1 << 23).reshape(-1, 8)
    check(ops.byteshuffle(recs), ref.byteshuffle(recs), "byteshuffle")
    ms, lib = cs.turns_ms(lambda: ops.byteshuffle(recs), lambda: recs.t().contiguous(), 20)
    result["byteshuffle"] = {"(2^23, 8)": {"ms": ms, "library_ms": lib}}
    print(f"{args.label} byteshuffle (2^23, 8): ms={ms} t_contiguous_ms={lib}")
    g_words, d_words = ops.bitpack(g, 4), ops.bitpack(d, 32)
    check(ops.bitunpack(g_words, 4, g.numel(), 1), g, "bitunpack at 4 bits")
    check(ops.bitunpack(d_words, 32, d.numel(), 4), d, "bitunpack at 32 bits")
    u4 = min(cs.cuda_ms(lambda: ops.bitunpack(g_words, 4, g.numel(), 1), 20) for _ in range(3))
    u32, clone = cs.turns_ms(lambda: ops.bitunpack(d_words, 32, d.numel(), 4),
                             lambda: d_words.clone(), 20)
    result["bitunpack"] = {"4 bits -> uint8[2^26]": {"ms": u4},
                           "32 bits -> int32[2^24]": {"ms": u32, "clone_ms": clone}}
    print(f"{args.label} bitunpack: 4 bits ms={u4}; 32 bits ms={u32} clone_ms={clone}")
    offsets = torch.cumsum(torch.randint(0, 256, (1 << 24,), dtype=torch.int64, device="cuda",
                                         generator=gen), 0).to(torch.int32)
    check(ops.fused_delta_bitpack(offsets, 8), ref.fused_delta_bitpack(offsets, 8),
          "fused_delta_bitpack")
    f8 = min(cs.cuda_ms(lambda: ops.fused_delta_bitpack(offsets, 8), 20) for _ in range(3))
    result["fused_delta_bitpack"] = {"uint32[2^24] at 8 bits": {"ms": f8}}
    print(f"{args.label} fused_delta_bitpack at 8 bits: ms={f8}")

    result["card"] = cs.nvidia_smi("name,power.limit")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
