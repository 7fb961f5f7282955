"""repro_torch — the PyTorch/CUDA port of ``repro``'s compressor and decoder.

A separate package beside the JAX reference: it keeps its own copy of the
wire format, engine, codecs and coder-table builders, and imports nothing of
``repro`` or ``jax``.  Frames are byte-identical to the reference's.

Entry points::

    from repro_torch import compress, decompress, numeric, numeric_profile
    frame = compress(numeric_profile(), numeric(column))        # on the card
    frame = compress(numeric_profile(), numeric(column), device="cpu")
    (out,) = decompress(frame)                   # on the card; out.data is a CUDA tensor
    (out,) = decompress(frame, device="cpu")
    frame = compress(bfloat16_profile(), numeric(weights))  # a bf16 tensor on the card
    frame = compress(pipeline("delta", "bitpack"), numeric(offsets))  # fuses to K11
    frame = compress(pipeline(("bitpack", {"bits": 4})), numeric(int4_codes))
    frame = compress(generic_profile(), serial(blob), chunk_bytes=4 << 20)
    (out,) = decompress(frame)                   # a container, joined on the card
    frame = compress(generic_profile(), strings([b"ab", b"", b"ab"]))  # a STRING column
    frame = compress(sao_profile(), serial(sao_file))     # the paper's §IV example
    frame = compress(struct_profile([8, 8, 2, 2, 4, 4]), struct(records, 28))
    frame = compress(csv_profile(8), serial(csv_file))    # the paper's §VI-C CSVs
    frame = compress(graph_profile(), serial(edge_file))  # SNAP-style u<TAB>v lines
    frame = compress(resolve_profile_spec("graph:bin:4"), serial(pairs))  # as the CLI names it
    with CompressorSession(generic_profile(), chunk_bytes=4 << 20) as session:
        frame = session.compress(serial(blob))   # chunks encoded on a pool
    stream_io.compress_file("in.bin", "out.ozl", generic_profile())  # repro_torch.core.stream_io
    comp = Compressor.deserialize(open("plan.ozp", "rb").read())  # a trained .ozp plan file
    frame = comp.compress(serial(csv_file), chunk_bytes=0)
    from repro_torch.training import detect_frontend, train     # the trainer
    tc = train([[serial(sample)]], detect_frontend(sample))     # candidates on the card
    comp = Compressor(tc.best_ratio_plan())                     # deploy its best point
    # the command line: python -m repro_torch compress F [--plan P.ozp] [--device cpu]
    #                   python -m repro_torch train SAMPLE --out P.ozp [--device cpu]

Both entry points run on the card unless the caller names the CPU, and
raise without a card.  On the card every codec whose encoder or decoder had
a TPU kernel in the reference launches a hand-written CUDA kernel
(``repro_torch.kernels.ops``); with ``device="cpu"`` the same codecs take
the kernels' plain PyTorch versions.  ``execute`` fuses an adjacent
``delta`` -> ``bitpack`` pair into ``fused_delta_bitpack``, as the
reference's device backend does, and lowers it back where the data refuses.
With ``chunk_bytes`` the input is split into views of its tensor on the
device, the plan is resolved once on the first chunk and executed on every
chunk, and the chunk frames go into one ``OZLC`` container, byte for byte
the reference's.  The chunks are encoded in parallel on a session's pool
(``CompressorSession``, ``DecompressorSession``); ``compress_file`` and
``decompress_file`` (``repro_torch.core.stream_io``) stream files and pipes
through them.  Resolutions are memoized (``resolve_cache_info``) and coder
tables too (``coder_cache_info``), as the reference's are.  ``Compressor``
reads and writes ``.ozp`` plan files without ``msgpack``
(``repro_torch.core.serialize``), ``repro_torch.training`` trains plans
from sample files with the reference's NSGA-II search (the same seed gives
the reference's plans), and ``python -m repro_torch`` is the command line
(``repro_torch.cli``), ``train`` included.
"""
from .codecs.profiles import (  # noqa: F401
    SAO_FIELDS,
    SAO_HEADER_BYTES,
    bfloat16_profile,
    csv_profile,
    float32_profile,
    float64_profile,
    generic_profile,
    graph_bin_profile,
    graph_profile,
    named_profiles,
    numeric_profile,
    resolve_profile_spec,
    sao_profile,
    struct_profile,
    text_profile,
)
from .codecs.coder_cache import (  # noqa: F401
    coder_cache_clear,
    coder_cache_disabled,
    coder_cache_info,
)
from .core import (  # noqa: F401
    CompressionCtx,
    Compressor,
    CompressorSession,
    DecompressorSession,
    GraphBuilder,
    Plan,
    Stream,
    SessionPool,
    SType,
    compress,
    decompress,
    deserialize_plan,
    numeric,
    pipeline,
    plan_digest,
    plan_from_dict,
    resolve_cache_clear,
    resolve_cache_info,
    serial,
    set_resolve_check,
    serialize_plan,
    strings,
    struct,
)
