"""Time the byte, bit, delta, histogram and entropy-lane kernels of one source tree on one NVIDIA card.

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
- K2 delta decode on an int64[2^23] (column A's deltas) and a uint32[2^24]
  (B's), from the tensor's start and from ``d[1:]``, each in turns with the
  ``torch.cumsum`` that computes the same function (``dtype=torch.int32`` on
  the uint32 carrier, which wraps as K2 does);
- K6 bitunpack at 4 bits to uint8[2^26] (column G's shape), at 8 bits to
  int32[2^24], and at 32 bits to int32[2^24], from words at their
  allocation's start and 1 word into it, at 32 bits in turns with
  ``clone()``;
- K3 byte shuffle at chip_smoke's four shapes (column A's and B's records,
  the tANS lane layout, a 64 KiB selector trial), at ragged ones and from
  an input 1 byte into its allocation, each in turns with
  ``t().contiguous()``;
- K9 tANS encode at 65,536 and at 64 lanes of 1024 symbols (table_log 11);
- K11 fused delta + bitpack at 8 bits, at chip_smoke's shape;
- K12 fused delta + bitpack decode on column F's shape (2^22 words at 8
  bits to uint32[2^24], the words K11 packs from string offsets), from
  words 1 word into their allocation, and on random words at every bits to
  2^24 uint32 and uint8 values, each beside its bound;
- K13 histogram on a 64 KiB selector trial's sample of column A's delta +
  transposed stream, on the whole 2^26-byte stream, on 2^26 uniform bytes,
  on column C's bfloat16 exponent plane (2^25 bytes) and on 2^26 equal
  bytes, each timed as one ``ops.histogram`` call (any fill the wrapper
  launches included); for the trial's call and K12's, the device
  operations of one call (kernels and memsets, from ``torch.profiler``);
- K15 Huffman decode at 16,384 lanes of 4096 (columns A and B) and K10
  tANS decode at 65,536 lanes of 1024 and their first 16,384 (table_log 11;
  column D's exponent plane has as many) and at 4096 lanes (table_log 16),
  on the lanes the tree's own codec writes for chip_smoke's columns (A's
  4 MiB prefix at table_log 16) through ``delta``, ``transpose`` and the coder;
  where the tree's K15 copies only its LUT's least period
  (``ops.huffman_lut_log``), it is also timed in turns with a launch that
  copies the whole 2^15-entry LUT;
  and K10 at 64 lanes (table_log 27, 64-bit step entries) on chip_smoke's
  64 KiB of uniform bytes through ``fse`` alone (its tables take ~45 s to
  build on the host).

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
# K3: (n, w, input offset) -> chip_smoke's shapes (column A's and B's
# records, the tANS lane layout, a 64 KiB selector trial), ragged ones, and
# from 1 byte into the allocation
K3_SHAPES = {
    "(2^23, 8)": (1 << 23, 8, 0), "(2^24, 4)": (1 << 24, 4, 0),
    "(65536, 1024)": (65536, 1024, 0), "(8192, 8)": (8192, 8, 0),
    "(2^23 - 8, 8)": ((1 << 23) - 8, 8, 0), "(2^24 - 1, 4)": ((1 << 24) - 1, 4, 0),
    "(65535, 1024)": (65535, 1024, 0), "(2^23, 8) +1 byte": (1 << 23, 8, 1),
}
# K9: lanes of 1024 symbols at table_log 11, the main path's 65,536 lanes
# and a 64 KiB selector trial's 64
K9_LANES = (65536, 64)


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

    result["byteshuffle"] = {}
    for key, (n, w, offset) in K3_SHAPES.items():
        x = planes(w, n, offset).reshape(n, w)
        check(ops.byteshuffle(x), ref.byteshuffle(x), f"byteshuffle {key}")
        ms, lib = cs.turns_ms(lambda x=x: ops.byteshuffle(x), lambda x=x: x.t().contiguous(), 20)
        bound = 2 * x.numel() / cs.HBM_BYTES_PER_S * 1e3
        result["byteshuffle"][key] = {"ms": ms, "library_ms": lib, "bound_ms": bound}
        print(f"{args.label} byteshuffle {key}: ms={ms} t_contiguous_ms={lib} bound_ms={bound}")
    result["fse_encode"] = fse_encode_times(args.label, ops, ref, gen, check)
    g_words = ops.bitpack(g, 4)
    check(ops.bitunpack(g_words, 4, g.numel(), 1), g, "bitunpack at 4 bits")
    u4 = min(cs.cuda_ms(lambda: ops.bitunpack(g_words, 4, g.numel(), 1), 20) for _ in range(3))
    u4_bound = (g.numel() + g.numel() // 2) / cs.HBM_BYTES_PER_S * 1e3
    result["bitunpack"] = {"4 bits -> uint8[2^26]": {"ms": u4, "bound_ms": u4_bound}}
    n = d.numel()
    for key, words, bits in (("8 bits -> int32[2^24]", d[: n // 4], 8),
                             ("32 bits -> int32[2^24]", d, 32),
                             ("32 bits -> int32[2^24], words +1 word", d_off, 32)):
        check(ops.bitunpack(words, bits, n, 4), ref.bitunpack(words, bits, n, 4),
              f"bitunpack {key}")
        bound = (words.numel() * 4 + 4 * n) / cs.HBM_BYTES_PER_S * 1e3
        if bits == 32:
            ms, lib = cs.turns_ms(lambda w=words: ops.bitunpack(w, 32, n, 4),
                                  lambda w=words: w.clone(), 20)
        else:
            ms, lib = min(cs.cuda_ms(lambda w=words: ops.bitunpack(w, 8, n, 4), 20)
                          for _ in range(3)), None
        result["bitunpack"][key] = {"ms": ms, "clone_ms": lib, "bound_ms": bound}
    print(f"{args.label} bitunpack: {json.dumps(result['bitunpack'])}")
    result["delta_decode"] = {}
    for key, width, count in (("int64[2^23]", 8, 1 << 23), ("uint32[2^24]", 4, 1 << 24)):
        full = torch.randint(-(1 << 62), 1 << 62, (count + 1,), dtype=torch.int64, device="cuda",
                             generator=gen)
        full = full if width == 8 else full.to(torch.int32)
        dtype = None if width == 8 else torch.int32
        for view, x in (("", full[:-1]), (" from d[1:]", full[1:])):
            check(ops.delta_decode(x), ref.delta_decode(x), f"delta_decode {key}{view}")
            ms, lib = cs.turns_ms(lambda x=x: ops.delta_decode(x),
                                  lambda x=x: torch.cumsum(x, 0, dtype=dtype), 20)
            bound = 2 * x.numel() * width / cs.HBM_BYTES_PER_S * 1e3
            result["delta_decode"][key + view] = {"ms": ms, "cumsum_ms": lib, "bound_ms": bound}
            print(f"{args.label} delta_decode {key}{view}: ms={ms} cumsum_ms={lib}"
                  f" bound_ms={bound}")
    offsets = torch.cumsum(torch.randint(0, 256, (1 << 24,), dtype=torch.int64, device="cuda",
                                         generator=gen), 0).to(torch.int32)
    check(ops.fused_delta_bitpack(offsets, 8), ref.fused_delta_bitpack(offsets, 8),
          "fused_delta_bitpack")
    f8 = min(cs.cuda_ms(lambda: ops.fused_delta_bitpack(offsets, 8), 20) for _ in range(3))
    result["fused_delta_bitpack"] = {"uint32[2^24] at 8 bits": {"ms": f8}}
    print(f"{args.label} fused_delta_bitpack at 8 bits: ms={f8}")

    result.update(hist_fdb_times(args.label, args.seed, ops, ref, gen, check))
    result.update(entropy_decode_times(args.label, args.seed, ops, ref, check))

    result["card"] = cs.nvidia_smi("name,power.limit")
    print(json.dumps(result))


def device_ops(fn) -> dict:
    """The device operations (kernels, memsets) of one call of ``fn``, by
    name, from ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key != "Activity Buffer Request"}


def hist_fdb_times(label, seed, ops, ref, gen, check):
    """K13 and K12 at the shapes of the module docstring, each held against
    its plain version, then timed (least of three ``cuda_ms``)."""
    import numpy as np
    import torch

    import chip_smoke as cs

    dev = "cuda"
    best = lambda fn: min(cs.cuda_ms(fn, 20) for _ in range(3))  # noqa: E731
    rng = np.random.default_rng(seed)
    col_a = torch.from_numpy(cs.timestamps(rng, cs.COLUMN_BYTES // 8)).to(dev)
    a_stream = ops.byteshuffle(ops.delta_encode(col_a).view(torch.uint8).view(-1, 8)).reshape(-1)
    w32 = rng.normal(0.0, 0.02, cs.COLUMN_BYTES // 2).astype(np.float32)
    bf16 = torch.from_numpy(w32).to(torch.bfloat16).view(torch.int16).to(dev)
    shapes = {
        "64 KiB trial of A": a_stream[: cs.TRIAL_BYTES],
        "A uint8[2^26]": a_stream,
        "uniform uint8[2^26]": torch.randint(0, 256, (1 << 26,), dtype=torch.uint8, device=dev,
                                             generator=gen),
        "C exponent uint8[2^25]": ops.float_split(bf16, 0)[1],
        "one value uint8[2^26]": torch.full((1 << 26,), 7, dtype=torch.uint8, device=dev),
    }
    del col_a, bf16
    hist = {}
    for key, x in shapes.items():
        check(ops.histogram(x), ref.histogram_exact(x), f"histogram {key}")
        hist[key] = {"ms": best(lambda x=x: ops.histogram(x)),
                     "bound_ms": (x.numel() + 256 * 8) / cs.HBM_BYTES_PER_S * 1e3}
        print(f"{label} histogram {key}: {json.dumps(hist[key])}")
    trial = shapes["64 KiB trial of A"]
    hist["64 KiB trial of A"]["device_ops"] = device_ops(lambda: ops.histogram(trial))
    print(f"{label} histogram trial device ops: {hist['64 KiB trial of A']['device_ops']}")
    del shapes, trial, a_stream

    offsets = torch.cumsum(torch.randint(0, 256, (1 << 24,), dtype=torch.int64, device=dev,
                                         generator=gen), 0).to(torch.int32)
    f_words = ops.fused_delta_bitpack(offsets, 8)
    shifted = torch.cat([f_words[:1], f_words])[1:]
    n = offsets.numel()
    cases = {"F: 8 bits -> uint32[2^24]": (f_words, 8, 4),
             "F: 8 bits -> uint32[2^24], words +1 word": (shifted, 8, 4)}
    for bits in ref.PACK_BITS:
        words = torch.randint(-(1 << 31), 1 << 31, (n * bits // 32,), dtype=torch.int64,
                              device=dev, generator=gen).to(torch.int32)
        for width in (4, 1):
            cases[f"{bits} bits -> {'uint32' if width == 4 else 'uint8'}[2^24]"] = (
                words, bits, width)
    fdb = {}
    for key, (words, bits, width) in cases.items():
        check(ops.fused_delta_bitpack_decode(words, bits, n, width),
              ref.fused_delta_bitpack_decode(words, bits, n, width),
              f"fused_delta_bitpack_decode {key}")
        args = (words, bits, n, width)
        fdb[key] = {"ms": best(lambda a=args: ops.fused_delta_bitpack_decode(*a)),
                    "bound_ms": (words.numel() * 4 + n * width) / cs.HBM_BYTES_PER_S * 1e3}
        print(f"{label} fused_delta_bitpack_decode {key}: {json.dumps(fdb[key])}")
    fdb["F: 8 bits -> uint32[2^24]"]["device_ops"] = device_ops(
        lambda: ops.fused_delta_bitpack_decode(f_words, 8, n, 4))
    print(f"{label} fused_delta_bitpack_decode F device ops:"
          f" {fdb['F: 8 bits -> uint32[2^24]']['device_ops']}")
    return {"histogram": hist, "fused_delta_bitpack_decode": fdb}


def fse_encode_times(label, ops, ref, gen, check):
    """K9 at ``K9_LANES`` lanes of 1024 exponentially distributed bytes, with the
    tables of table_log 11 that the port's codec builds for them; each held
    against ``ref.fse_encode_lanes``, then timed (least of three
    ``cuda_ms``)."""
    import numpy as np
    import torch
    from repro_torch.codecs import entropy

    import chip_smoke as cs

    dev = "cuda"
    i32 = lambda a: torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)  # noqa: E731
    sym = (torch.empty(K9_LANES[0] * 1024, device=dev).exponential_(1 / 24, generator=gen)
           .clamp_(max=255).to(torch.uint8))  # skewed bytes, mean ~24
    counts = torch.bincount(sym, minlength=256).cpu().numpy().astype(np.int64)
    norm = entropy._normalize_counts(counts, 11)
    _ds, _dn, _db, enc, nb0, thr, st0 = entropy._fse_tables_cached(norm, 11)
    sym_start, compact = ref.compact_encode_table(i32(norm), i32(enc.reshape(-1)), enc.shape[1])
    out = {}
    for n_lanes in K9_LANES:
        lanesT = ops.byteshuffle(sym[: n_lanes * 1024].view(n_lanes, 1024))
        rem = torch.full((n_lanes,), 1024, dtype=torch.int32, device=dev)
        a = (lanesT, rem, i32(nb0), i32(thr), i32(st0), i32(norm), sym_start, compact,
             enc.shape[1], 1 << 11)
        for got, want in zip(ops.fse_encode(*a), ref.fse_encode_lanes(*a)):
            check(got, want, f"fse_encode {n_lanes} lanes")
        ms = min(cs.cuda_ms(lambda a=a: ops.fse_encode(*a), 20) for _ in range(3))
        bound = (n_lanes * 1024 * 9 + n_lanes * 8 + (5 * 256 + (1 << 11)) * 4) / cs.HBM_BYTES_PER_S * 1e3
        out[f"{n_lanes} lanes x 1024"] = {"ms": ms, "bound_ms": bound}
        print(f"{label} fse_encode {n_lanes} lanes x 1024: ms={ms} bound_ms={bound}")
    return out


def entropy_decode_times(label, seed, ops, ref, check):
    """K15 on columns A's and B's lanes and K10 on A's, as the tree's
    decoders hand them over (``entropy.huffman_lanes`` / ``fse_lanes``), K10
    also on A's first 16,384 lanes and on ``WIDE_BYTES`` uniform bytes at
    table_log 27, each held against its plain version, then timed (least of
    three ``cuda_ms``; K15 in turns with a whole-LUT launch where the tree
    has one)."""
    import numpy as np
    import repro_torch as rt
    from repro_torch.codecs import entropy

    import chip_smoke as cs

    cols = cs.columns(seed)
    col_a = cols["A_timestamps_i64"]
    out = {"huffman_decode": {}, "fse_decode": {}}

    def lanes(codec, col, params=None):
        step = (codec, params) if params else codec
        if isinstance(col, bytes):
            frame = rt.compress(rt.pipeline(step), rt.serial(col), device="cuda")
        else:
            frame = rt.compress(rt.pipeline("delta", "transpose", step), rt.numeric(col),
                                device="cuda")
        streams = cs.node_streams(frame, codec)
        return entropy.huffman_lanes(*streams) if codec == "huffman" else entropy.fse_lanes(*streams)

    for cname in ("A_timestamps_i64", "B_zipf_ids_u32"):
        buf, pos, lut, max_rem, _n, _stype = lanes("huffman", cols[cname])
        want = ref.huffman_decode_lanes(buf, pos, lut, max_rem)
        check(ops.huffman_decode(buf, pos, lut, max_rem), want, f"huffman_decode {cname}")
        key = f"{cname[0]}: {pos.numel()} lanes x {max_rem}"
        kernel = lambda a=(buf, pos, lut, max_rem): ops.huffman_decode(*a)  # noqa: E731
        if hasattr(ops, "huffman_lut_log"):
            whole = lambda a=(buf, pos, lut, max_rem): whole_lut_decode(ops, *a)  # noqa: E731
            check(whole(), want, f"huffman_decode {cname}, the whole LUT copied")
            ms, whole_ms = cs.turns_ms(kernel, whole, 20)
            out["huffman_decode"][key] = {"ms": ms, "whole_lut_ms": whole_ms,
                                          "lut_log": ops.huffman_lut_log(lut)}
        else:
            out["huffman_decode"][key] = {"ms": min(cs.cuda_ms(kernel, 20) for _ in range(3))}
        print(f"{label} huffman_decode {key}: {json.dumps(out['huffman_decode'][key])}")
    del cols
    wide = np.random.default_rng(seed + cs.WIDE_TABLE_LOG).integers(
        0, 256, cs.WIDE_BYTES, dtype=np.uint8).tobytes()
    a11, _n, _stype = lanes("fse", col_a)
    first = (a11[0], *(a[:16384] for a in a11[1:4]), *a11[4:])
    cases = {"table_log 11": a11, "table_log 11, first lanes": first,
             "table_log 16": lanes("fse", col_a[: cs.PREFIX_BYTES // 8], {"table_log": 16})[0],
             f"table_log {cs.WIDE_TABLE_LOG}":
                 lanes("fse", wide, {"table_log": cs.WIDE_TABLE_LOG})[0]}
    for name, args in cases.items():
        check(ops.fse_decode(*args), ref.fse_decode_lanes(*args), f"fse_decode {name}")
        ms = min(cs.cuda_ms(lambda a=args: ops.fse_decode(*a), 20) for _ in range(3))
        key = f"{args[2].numel()} lanes x {args[6]}, {name}"
        out["fse_decode"][key] = {"ms": ms}
        print(f"{label} fse_decode {key}: ms={ms}")
    del cases, args
    # drop the 2^27-state tables from the table cache (a tree before the
    # coder-table cache kept them in a module dict)
    if hasattr(entropy, "_TABLES"):
        entropy._TABLES.clear()
    else:
        entropy.active_cache().clear()
    return out


def whole_lut_decode(ops, buf, pos, lut, max_rem):
    """K15 as ``ops.huffman_decode`` launches it, but copying all 2^15 LUT
    entries into each block (a LUT is periodic in its least period, so the
    result is the same)."""
    import torch

    out = torch.empty((max_rem, pos.numel()), dtype=torch.uint8, device=buf.device)
    ops._launched(ops._lib().repro_huffman_decode(
        buf.data_ptr(), buf.numel(), pos.data_ptr(), lut.data_ptr(), 15, out.data_ptr(),
        max_rem, pos.numel(), ops._stream(buf)), "huffman_decode")
    return out


if __name__ == "__main__":
    main()
