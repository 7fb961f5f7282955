"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

Usage (from the repository root, on a machine with one CUDA card):

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero, and no result line is printed:

1. build   — compile the port's CUDA kernels from ``src/repro_torch/csrc``.
2. kernels — each of the sixteen kernels at the main path's shapes, held
             bit-exactly (tolerance 0) against its plain PyTorch version on
             the same card, and timed beside the plain version and a one-call
             PyTorch yardstick where one exists: the encode kernels (delta;
             byte shuffle at widths 1 to 1024, n a multiple of 16 and n % 16
             of 1, 7 and 15, from records at offsets 0, 1 and 16 bytes, so
             that its narrow, wide and byte-wise paths all run with their
             unaligned plane stores, then timed in turns with
             ``t().contiguous()`` at column A's and B's records, the tANS
             lane layout (65,536, 1024), a 64 KiB trial's (8192, 8) and the
             SAO catalogue's (258,997, 8);
             Huffman map; tANS encode at 65,536 lanes and at a 64 KiB
             trial's 64, each at table_log 11, 15 and 16, with full lanes
             and with lanes of length 1 and 2 and a short last lane, timed
             at both lane counts; float split on columns
             C's and D's shapes, the histogram on column A's 2^26-byte
             transposed stream, uniform bytes, C's exponent plane, 2^26
             equal bytes and a 64 KiB trial's sample (one launch a call),
             beside ``torch.bincount``, and at every size up to 64 bytes,
             64 KiB and past it from byte offsets 0-15 of a view, and on
             2^32 + 17 equal bytes); the encode kernels that a container's
             chunk views reach (delta, byte shuffle, Huffman map, float
             split, bitpack and fused delta + bitpack) also on views at
             every byte offset 0-15 their element width allows, on ragged
             sizes (``encode_offset_sweep``); the decode
             kernels (delta decode on A's and B's deltas, in turns with
             ``torch.cumsum`` (``dtype=torch.int32`` on B's carrier), then
             at widths 1, 2, 4 and 8 on ragged sizes and around its tile,
             from every element offset below 16 bytes into its tensor
             (``d[0:]`` to ``d[15:]`` for uint8), and 50 times back to
             back on 2^26 and 2^28 uint8 deltas, every result equal; Huffman
             decode and tANS decode on column A's entropy-coded streams, 50
             times back to back, then Huffman decode at 1 to 16,384 lanes
             started in order, reversed, all equal and at the stream's end,
             and on streams of 1 to 12,805 symbols (short last lanes) under
             tables with 15-bit codes, codes of at most 8 bits and one
             symbol, and tANS decode on 1000 lanes of 1 (no bits), 2, 517
             and 1024 symbols at table_log 5, 11, 15 and 16; the lane
             refill (65,536 and 2^24 cursors), float merge on C's and D's
             planes, and
             byte unshuffle on A's and B's planes and both decoders' lanes,
             and at a ragged size of each regime, (8, 2^23 - 8) and
             (4096, 16383), and the SAO catalogue's (8, 258,997), each
             timed in turns with ``t().contiguous()``
             (``turns_ms``), then at widths 1 to
             1024 on ragged sizes and multiples of 16, from planes at offsets
             0, 1 and 16 bytes, so that its narrow, wide and byte-wise paths
             all run, with their shifted loads and partial groups), and the
             bit packers: bitpack and bitunpack (K5, K6) at every bits in {1,
             2, 4, 8, 16, 32} and stream width 1/2/4 on small ragged sizes,
             aligned and offset (K6 from words 1, 2 and 3 words into their
             allocation), then timed on column G at 4 bits and on B's
             deltas at 32 bits (both in turns with a clone, K5 also at 8 and
             16 bits), and fused delta + bitpack and its decode (K11, K12)
             at every bits on ragged sizes (K12 also at every bits and
             width around its tile, from words 0-3 words in, and 50 times
             back to back on 2^26 and 2^28 values), then timed on column F
             at 8 bits.  tANS at
             table_log 16, whose tables the kernels read from global memory,
             is checked on a 4 MiB prefix, and at table_log 27, whose decode
             step entries are 64-bit, on 64 KiB of uniform random bytes: the
             card's frame equals the CPU's, K10 equals its plain version, and
             the frame decodes on the card.
3. main    — seven 64 MiB columns made from ``--seed``: two numeric ones (A:
             2^23 int64 nanosecond timestamps with jittered gaps; B: 2^24
             zipf-distributed uint32 ids), each through ``numeric_profile()``
             at level 5, ``delta+transpose+huffman`` and
             ``delta+transpose+fse``, and B also through ``delta+bitpack``,
             whose wrapped u32 deltas refuse fusion, so the step lowers to
             ``delta`` + ``bitpack`` at 32 bits (K1, K5); three of
             normal(0, 0.02) weights, each through its float profile at
             level 5 (C: 2^25 bfloat16, one 4096 x 8192 linear layer of an
             LLM checkpoint, handed over as a ``torch.bfloat16`` tensor; D:
             2^24 float32 master weights; E: 2^23 float64); F: 2^24 uint32
             string offsets (an Arrow/Parquet offsets buffer) through
             ``delta+bitpack``, which fuses to ``fused_delta_bitpack`` at 8
             bits (K1 for the precondition, K11); and G: 2^26 int4 weight
             codes stored one per byte through ``bitpack``, at 4 bits (K5);
             all via ``repro_torch.compress(..., device="cuda")``.  Every
             frame decodes to its column and records the codecs above; the
             frame of a 4 MiB prefix written on the card equals the one
             written on the CPU; every encode kernel's launch counter rose
             during this phase.
4. decode  — each of the twelve frames through
             ``repro_torch.decompress(frame, device="cuda")``, timed
             (decompress MB/s) and checked against its column on the card;
             the delta decode, byte unshuffle, Huffman decode, tANS decode,
             float merge, bitunpack and fused decode counters rose during
             this phase.
5. container — the reference CLI's default path, chunked compression
             into ``OZLC`` containers, at level 5: A as NUMERIC through
             ``generic_profile()`` at 4 MiB chunks (16), A's bytes as
             STRUCT(8) records through it at 4 MiB + 8 (``interpret_numeric``
             then ``numeric_auto``; odd chunks start 8 bytes off a 16-byte
             boundary), G as a SERIAL byte stream (a raw file) through it at
             4 MiB + 3 (chunks start at every residue mod 16), and F through
             ``delta+bitpack`` at 4 MiB + 4; each ``compress(...,
             device="cuda", chunk_bytes=N)`` then ``decompress(...,
             device="cuda")``, with the launch counts reset before and read
             after each half.  Each container starts with ``OZLC`` and holds
             the expected chunk count, decodes on the card to the column
             (compared on the card), and on a 4 MiB prefix at 1 MiB plus the
             same remainder equals the CPU's container byte for byte with
             as many fresh per-chunk re-resolves; the kernels the first
             chunk's codecs name launched.  A is also compressed unchunked in
             the same run.  A container whose third chunk has one payload
             byte flipped raises ``FrameError`` on the card before any
             kernel launches.
6. records — the structural codecs, STRING streams and the record
             profiles at level 5, made from ``--seed``: S, the SAO star
             catalogue of the paper's §IV at the published size of
             Silesia's ``sao`` (258,997 records of 28 bytes behind a 28-byte
             header, 7,251,944 bytes; ``make_sao``) through
             ``sao_profile()``; R, 2,396,745 such records headerless (64
             MiB) through ``struct_profile([8, 8, 2, 2, 4, 4])``
             (``field_split``, then ``generic_auto`` a field); T, a STRING
             column of 2^22 strings (one Arrow/Parquet row group's worth:
             words of a 2^16-word lowercase vocabulary, zipf(1.1) over
             their ranks, each min(zipf(1.6), 255) bytes, 1/16 of the rows
             empty) through ``generic_profile()`` unchunked and at 4 MiB
             chunks, and through its dictionary plan (``tokenize``, then
             ``generic_auto`` on the alphabet and ``numeric_auto`` on the
             indices).  Each call through ``compress(..., device="cuda")``
             and back through ``decompress``, with the launch counts reset
             before and read after each half: decoded on the card and equal
             to its input there; the card's frame (or container, at 1 MiB)
             on a prefix (S whole; 4 MiB of R and T) equal to the CPU's;
             S's compress launches delta, byte shuffle, histogram, Huffman
             map and tANS encode, its decompress delta decode and byte
             unshuffle.  Then each structural codec alone (``dup``,
             ``constant``, ``split_n``, ``concat``, ``field_split``,
             ``string_split``, ``rle``, ``transpose_split``, STRING
             ``tokenize``) on a prefix, card frame equal to the CPU's and
             decoded on the card; and T through ``store``, its lengths'
             varints written and read one Python call a string against the
             vectorised wire, in one run.
7. csv     — the CSV frontend of the paper's §VI-C at level 5, made from
             ``--seed`` (+ 3 and + 4): C1, the census PPMF person file
             (``make_ppmf_csv``, 3,400,000 rows, 8 columns, ~67 MB), and C2,
             the ACS PUMS housing file (``make_psam_csv``, 2,000,000 rows, 7
             columns, ~66 MB), each through ``csv_profile(n_cols)``
             (``csv_split``, then ``parse_numeric`` a column and the auto
             selectors on its bitmap, values and exceptions), unchunked:
             compressed and decompressed on the card with the launch
             counts reset before and read after each half, decoded on the
             card and equal to the input there, the frame of a prefix cut
             after the last newline at or before 4 MiB equal to the CPU's,
             each column's codecs printed, and at least one encode and one
             decode kernel launched over the phase.  Then the edge corpus
             (``CSV_EDGES``: CRLF, a lone \\r, separators with a border,
             a UTF-8 separator, empty fields, no trailing newline, every
             int64 boundary string), each card frame equal to the CPU's and
             decoded on the card; and ``csv_split`` and ``parse_numeric``
             alone each way on C1 and C2 (MB/s, exceptions per column).
8. graph   — the graph frontend at level 5, unchunked: G1, a SNAP-style
             text edge list of 64 MiB (``synth_edge_pairs``, the recipe of
             ``benchmarks/engine_bench.py``'s ``synth_edges``, seed
             ``--seed`` + 5: 6,319,532 edges at seed 0, the scale of SNAP's
             web-Google),
             through ``graph_profile()`` (``edge_list``, then
             ``adjacency_auto``'s trials between raw columns, plain gaps and
             ``adj_gap(window=8)``'s reference coding), and G2, its complete
             lines' pairs as interleaved uint32, through
             ``graph_bin_profile(4)``; each compressed and decompressed on
             the card with the launch counts reset before and read after
             each half (each side must launch a kernel), decoded on the card
             and equal to the input there, a 4 MiB prefix's frame equal to
             the CPU's.  Then the edge corpus (``GRAPH_EDGES``: CRLF,
             comments, negative ids, 2^63 as text, ties between separators,
             "::" and "\\r", unsorted and decreasing lists, a hub, a chain of
             200 reference runs, binary ids at and above 2^(8w-1)), each
             card frame equal to the CPU's; and ``edge_list``,
             ``edge_list_bin`` and ``adj_gap`` at windows 0 and 8 alone each
             way on G1 and G2, with the reference runs and decode levels.
9. sessions — the engine's sessions on the card, after the graph phase, with
             4 MiB chunks (``SESSION_CHUNK_BYTES``): A through
             ``CompressorSession(generic_profile())`` with ``n_workers=1`` and
             with the default pool (the containers byte-equal), back through
             a pooled ``DecompressorSession``; A again from a side stream
             (``torch.cuda.stream``), written there behind a device sleep,
             through ``delta -> transpose -> zlib_backend`` (a worker that
             launched on its own stream would read it before the copy
             lands); C through a pooled ``CompressorSession(bfloat16_profile())``
             (float split, histogram and tANS on the pool's threads, the
             tables from the process-wide coder-table cache) against one
             worker; G1 written to a temporary file and through
             ``compress_file`` from its path (a known count; one worker and
             the pool, byte-equal) and from an OS pipe (the count
             backpatched; the same chunks), back through ``decompress_file``
             (one worker and the pool) and
             ``DecompressorSession.iter_frames``; ``compress_traced`` on
             A's 4 MiB.  Each decode equals the input on the card, each
             cell's 4 MiB prefix at 1 MiB chunks equals the CPU's container
             with both caches emptied before each side, and each side of
             each call launches a kernel; MB/s each way, the sessions'
             stats, both caches' counters, the peak of allocated card
             memory and ``profile sessions`` lines.
10. checkpoint — the checkpoint leaf path, its manager and the shard store
             on the card (``repro_torch.distributed.checkpoint``,
             ``repro_torch.data``), after the sessions phase.  The CPU's
             frames first: ``compress_leaf`` of a 4 MiB slice (the first 2^21
             weights) of ``layers/wq`` and of ``embed`` on the card equal to
             the CPU's frame and decoded on the card; a route tree of one
             leaf per dtype route (float32, float64, float16, int8, uint8,
             bool, int16, int32, int64, uint32; 1-4 MiB each, made from
             ``--seed`` + 6) through ``save_checkpoint`` on the card, each
             leaf file equal to the CPU's frame and restored on the card to
             its input.  Then the serving checkpoint of Llama-3.2-1B
             (``repro/configs/llama3_2_1b.py``, the stacked tree of
             ``repro/models/transformer.py``'s ``init_params``: 16 layers,
             d_model 2048, 32 heads, 8 KV heads, d_ff 8192, vocab 128256,
             tied embeddings; 11 bfloat16 leaves, 1,235,814,400 weights,
             2,471,628,800 bytes; weights normal(0, 0.02) and norms ones,
             drawn on the card from ``--seed``): ``CheckpointManager(keep=2,
             async_save=True).save(100, ...)`` behind a device sleep, every
             weight's sign flipped in place (``neg_()``) right after
             ``save()`` returns, ``wait()``, a synchronous save of step 200;
             ``restore_or_none`` gives step 200 equal to the flipped tree
             bit for bit and ``restore_tree(..., 100)`` the tree before the
             flip; the async save again from a side stream, the flip queued
             there; the synchronous save and ``restore_or_none`` run under
             torch.profiler (the card's idle share), a save of ``w_gate``
             alone and the side stream's restore under cProfile.  Then the
             trainer's shards (``repro/launch/train.py``'s ``make_shards`` at
             ``train_4k``'s batch 256, sequence 4096: 4 x 4,195,328 zipf
             int32 tokens over the vocab, chip_smoke's copy of
             ``zipf_tokens``) through ``CompressedShardStore``: written,
             shard 0 rewritten, read back on the card equal, ``stats()``.
             While the CPU's frames are made, two crash kills with card
             victims (``repro_torch.reliability.crashkill``, the
             ``checkpoint`` scenario at ``ckpt.leaf`` #3 and
             ``ckpt.manifest`` #1, two spawned interpreters at once): each
             victim dies by ``SIGKILL``, and ``check_invariants`` on the card
             finds step 1 intact and nothing half-published.  The launch
             counts are reset before and read after each save, restore and
             store call (each save launches float split, each restore float
             merge); save and restore seconds and MB/s, the manifest's and
             each leaf's ratio, the peak allocated card memory with the
             snapshot's share, the sessions' counters.
11. cli     — the command line (``repro_torch.cli``, ``python -m
             repro_torch``) on the card, after the checkpoint phase, on files
             in a temporary directory, each in-process ``cli.main(argv)``
             call with the launch counts reset before and read after it and
             timed on the host clock: column A (64 MiB) on the CLI's defaults
             (``generic``, 4 MiB chunks: 16 chunks; its chunks choose the
             host's ``zlib_backend``, so the decode may launch nothing)
             through ``compress``, ``inspect`` (no launch) and
             ``decompress``, equal to A; A through ``--profile struct:8``
             on the defaults, a kernel launched each way; A's 4 MiB prefix
             at 1 MiB chunks equal to ``--device cpu``'s container, the
             resolve cache emptied before each side.  C1 and C2 (the CSV
             phase's files) through the trained plan files
             ``results/trained/ppmf_person_7.ozp`` and ``psam_h_3.ozp`` with
             ``--chunk-bytes 0`` and back, equal to the input; a lower point
             of the family where the card and the CPU both refuse the file
             (printed); the row-aligned prefix of at most 4 MiB equal to
             ``Compressor.deserialize(blob).compress(..., device="cpu")``.
             Salvage: A through ``struct:8`` at 1 MiB chunks (64), one byte
             flipped in the middle of chunks 7, 8 and 40: ``inspect
             --verify`` exits 1 and prints 61/64 recovered and 7..8, 40 (0
             on the intact container), ``decompress`` exits 2 and leaves no
             output, ``decompress --salvage`` exits 1 with A without the
             three chunks, decoded on the card (0 and A itself from the
             intact container).  Every tracked ``.ozp`` (``tests/golden``,
             ``results/trained``: 104) read and written byte for byte with
             ``msgpack`` never imported.  Two ``python -m repro_torch``
             children (C2's compress and decompress through its plan) exit 0
             with files equal to the in-process calls', their wall seconds
             printed.
12. service — the compression service (``repro_torch.service``) on the card,
             after the cli phase: an in-process ``CompressionServer(device=
             "cuda")`` on a Unix socket in a temporary directory, with
             ``struct:8`` and a float32 plan file (``interpret_numeric`` at
             width 4, then the float32 profile: ``float32_bytes_plan``)
             registered, two sessions a plan, eight clients.  A and D (64 MiB
             each) as single requests at 4 MiB chunks through
             ``ServiceClient``, each way: decoded equal to the input, the
             container equal to ``stream_io.compress_file``'s on the card,
             ``struct:8`` launching delta and byte shuffle then delta decode
             and byte unshuffle, float32 float split then float merge; each
             one's 4 MiB prefix at 1 MiB chunks equal to the CPU's container,
             both caches emptied before each side.  Eight clients at once,
             each a different 16 MiB slice of A through ``struct:8`` and back,
             every container equal to its offline twin (MB/s each way, the
             ``stats`` verb's p50/p99 per verb, the pool's acquires, creates
             and waits).  The ``stats`` (its request counts as sent, no
             error), ``metrics`` and ``ping`` verbs.  The fault drill, with a
             quarantine threshold of 3 and a 2 s cooldown: a ``FaultPlan``
             armed at ``device.encode.cuda.float_split`` (and at every host
             encoder, which must never fire): three float32 requests answered
             with the injected fault on one connection that stays open, the
             fourth ``plan_quarantined`` with a ``retry_after``, ``struct:8``
             requests served between them with their launches counted; after
             the cooldown a float32 request succeeds, equal to the offline
             container.  One A request under torch.profiler and the request
             core on this thread under cProfile.  Then ``python -m repro_torch
             serve --socket ... --profile struct:8`` as a child on the card,
             ``client ping``, ``client compress`` (A) and ``client
             decompress`` children, their files equal to the in-process
             service's, and SIGTERM stopping the server with exit 0 and
             "server stopped"; each child's wall seconds.  The launch counts
             are reset before and read after each request group.
13. frontend — the non-blocking service frontend
             (``repro_torch.service.ServiceFrontend``) after the service
             phase's server has shut down: one ``RequestCore(device="cuda")``
             with the same two plans behind one event loop on a Unix socket
             (four compute threads, 512 connections, a 10 s request
             deadline).  A and D as single requests at 4 MiB chunks each way:
             decoded equal, each container equal to the threaded server's
             from the service phase and to the offline ``compress_file``'s on
             the card, each 4 MiB prefix's at 1 MiB chunks to the CPU's.  Two
             16 MiB requests (A's and D's) pipelined on one raw socket, two
             in-order responses equal to their offline containers.  200 idle
             connections and 40 slow-loris sockets (1-7 bytes of a request
             each) parked while A runs once more and the eight clients run on
             16 MiB slices of A with a ninth pinging (MB/s each way, the ping
             round trip's and the ``stats`` verb's p50/p99); every loris
             reaped within the deadline + 5 s, the active connections back
             to the 200.  One A request under torch.profiler and one under
             cProfile and a clock around ``feed``, ``_pump_write``,
             ``_response_chunks``, ``handle`` and ``compress_file``, beside
             the service phase's request.  ``stop()`` while an A compress
             runs: the loop exits within 30 s after the request ends,
             ``torch.cuda.synchronize()`` raises nothing, no session is
             checked out before ``core.close()``.  Launch counts are reset
             before and read after each request group.
14. signatures — codec signatures and the plan type-checker
             (``repro_torch.analysis``) on the card, after the frontend
             phase: every single-input codec on each of the reference
             probe's seven atoms (SERIAL, STRING, STRUCT(3), NUMERIC(1/2/4/8);
             ``tests/test_analysis.py``'s samples repeated to 1 MiB of card
             streams, 64 KiB for ``lz77`` and the three host leaves) through
             ``CodecSpec.run_encode``: where the signature accepts, the
             outputs stay on the card and ``run_decode(device="cuda")`` gives
             the input back (compared on the card); where it refuses, the
             encode raises ``ValueError`` (never ``KernelError``) with no
             launch, and ``check_plan`` flags the same wiring; the
             accept/refuse matrix on one line, and every kernel but K16
             launched over the probe.  ``check_plan`` of every plan the
             other phases compress through at its real inputs' atoms
             (columns A-G, S, R, T, C1, C2, G1, G2, the sessions' plans, the
             checkpoint route tree's ten dtypes and the Llama leaves, the
             CLI's ``generic``, ``struct:8`` and two trained plan files, the
             service's two plans, the level-7 plans), each clean, with its
             host ms.  A's ``numeric_profile`` compress from an empty
             resolve cache, ``RESOLVE_CHECK_PAIRS`` pairs in turns with
             ``set_resolve_check`` off and on, writes the main phase's frame
             every time (the medians of each and of the pairs' differences
             printed); each ``tests/illtyped`` plan on 1 MiB
             card streams of a type it refuses raises ``PlanTypeError`` with
             its manifest's code and launches nothing.  A
             ``RequestCore(device="cuda")``'s registry refuses the five with
             ``error_kind="ill_typed_plan"`` and stays empty, then serves A
             through ``struct:8``, its container equal to the offline one;
             one ``python -m repro_torch lint --json`` child exits 1 with each
             file's code (its wall seconds); ``inspect`` of the main phase's
             A frame prints an ``  :: in -> out`` suffix on every node line.
15. train — the compressor trainer (``repro_torch.training``) on the card,
             after the signatures phase: ``detect_frontend`` on the first
             4 MiB of A, B, C, G, S, C1, C2, G1 and G2 (each choice
             printed); C1, the PPMF person recipe (3,400,000 rows, ~66 MB),
             written to a file and trained by a ``python -m repro_torch
             train --all-points`` child at the CLI's defaults (a 4 MiB
             sample, pop 16, 6 generations, 8 points, seed 0, all CPUs),
             its lines, wall seconds and MiB/min printed, then all of C1
             compressed with each emitted point on the card into one frame
             (``csv_split`` needs whole rows) and decoded back to it, the
             best-ratio point alone (the MB/s a user deploying it gets),
             then the others at once on C1's first 4 MiB of whole rows, a
             thread and a CUDA stream each (MB/s under that contention; ratios beside ``csv_profile(8)``'s and
             the cli phase's trained plan's); A's first 4 MiB trained
             in-process at ``detect_frontend``'s choice and the same
             defaults under torch.profiler (stage seconds, evaluations,
             invalid and pruned counts, the card's idle share), then at one
             worker under cProfile (the largest host stages; equal plans),
             its best-ratio plan round-tripping all 64 MiB of A at 4 MiB
             chunks (ratio beside ``numeric_profile``'s at the same chunks);
             a 256 KiB C1 prefix trained at
             pop 4 and 2 generations on the card at the default workers and
             at one, and on the CPU, with equal objectives and plan bytes;
             ``device.encode.cuda.huffman`` armed for one small train, which
             must raise ``InjectedDeviceFault``.  K1, K3, K13 and K14 must
             launch over the phase's in-process calls.
16. lm      — the LM train and serve drivers (``repro_torch.models``,
             ``repro_torch.launch``) on the card, after the train phase:
             Llama-3.2-1B's widths (d_model 2048, 32 heads, 8 KV heads,
             d_ff 8192, vocab 128256, tied, rope theta 500,000) at one
             layer, batch 1 and 16 tokens, from one numpy tree made from
             ``--seed``, on the card and on the CPU: logits, loss, every
             gradient, one ``adamw`` step, and ``decode_step`` over the 16
             tokens against ``forward``, each largest absolute error
             printed beside its tolerance; the same for the reduced
             olmoe-1b-7b (MoE) and h2o-danube-3-4b (SWA, 40 tokens past its
             window of 16, so its ring wraps); then
             ``repro_torch.launch.train.main`` in-process at Llama-3.2-1B's
             full config (16 layers, remat) with ``--steps 5
             --save-interval 3 --fail-at-step 4``, which must return 42
             after saving step 3, and again, which must print the restored
             step 3 and its data cursor and end at step 5 with a final
             save; finite losses; the step-3 leaves restored on the card
             equal a host copy of what was saved, bit for bit, and the
             small leaves and the params' ``wk`` leaf also their frames'
             CPU decode; each save's and restore's seconds, MB/s, ratio and
             peak allocated card memory, and each train step's tokens/s;
             one ``python -m repro_torch.launch.serve --arch llama3.2-1b
             --batch 8 --prompt-len 32 --gen 32`` child from step 5 (its
             prefill and decode tok/s, the 33.6 MB KV cache, its wall
             seconds).  The launch counts are reset before the first train
             run and read after the second; K1, K3, K4, K7, K8, K9, K10,
             K13 and K14 must launch.
17. level7 — ``float32_profile()`` on a 4 MiB prefix of D and
             ``bfloat16_profile()`` on one of C at ``CompressionCtx(level=7)``,
             whose selectors try ``lzma_backend``; ``float32_profile()`` on 4
             MiB of D's first 40,000 weights repeated, whose frame must record
             ``lzma_backend``; and ``transpose -> bz2_backend`` on A's 4 MiB,
             whose frame records ``bz2_backend``: compressed and decompressed on the card
             with the launch counts reset before and read after each half
             (float split, histogram and byte shuffle must launch, then float
             merge and byte unshuffle); each frame equals the CPU's and
             decodes to its prefix on the card; one profiled call each way.
18. profile — one more compress and one decompress per plan and column, each
             under torch.profiler (the card's busy time and its top kernels)
             and cProfile (the host's time by function) at once, so its wall
             ms and idle share include cProfile's overhead, for the "where
             the time goes" record, then each kernel's device ms summed over
             them;
             then the container phase's calls and A's unchunked one, and
             the records phase's, the CSV phase's and the graph phase's calls.
19. identity — the card's name and power limit.

Output: a line per phase; then the ``{"kernels": [...]}`` JSON line (each
kernel's ``launches`` in the main and decode phases, ``container_launches``,
``records_launches``, ``csv_launches``, ``graph_launches``,
``sessions_launches``, ``checkpoint_launches``, ``cli_launches``,
``service_launches``, ``frontend_launches``, ``signatures_launches``,
``train_launches`` and ``lm_launches``), the
``nvidia-smi`` name/power line, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
# the entropy decoders' dependent chain: at least one shared-memory table
# lookup per symbol, taken as 30 cycles (an assumption, not a measurement);
# the latency floor it gives is printed on a line of its own, apart from the
# measured numbers of the kernels line
STEP_CYCLES = 30
QUEUE_CYCLES = 2_000_000  # ~1 ms at the H100's 1980 MHz: cuda_ms's head start
ENCODE_KERNELS = (
    "delta_encode", "byteshuffle", "huffman_map", "fse_encode", "float_split", "histogram",
    "bitpack", "fused_delta_bitpack",
)
DECODE_KERNELS = (
    "delta_decode", "byteunshuffle", "huffman_decode", "fse_decode", "float_merge",
    "bitunpack", "fused_delta_bitpack_decode",
)
PLANS = {
    "numeric_profile": lambda rt: rt.numeric_profile(),
    "delta+transpose+huffman": lambda rt: rt.pipeline("delta", "transpose", "huffman"),
    "delta+transpose+fse": lambda rt: rt.pipeline("delta", "transpose", "fse"),
    "bfloat16_profile": lambda rt: rt.bfloat16_profile(),
    "float32_profile": lambda rt: rt.float32_profile(),
    "float64_profile": lambda rt: rt.float64_profile(),
    "delta+bitpack": lambda rt: rt.pipeline("delta", "bitpack"),
    "bitpack": lambda rt: rt.pipeline("bitpack"),
    "transpose+bz2_backend": lambda rt: rt.pipeline("transpose", "bz2_backend"),
    "generic_profile": lambda rt: rt.generic_profile(),
}
NUMERIC_PLANS = ("numeric_profile", "delta+transpose+huffman", "delta+transpose+fse")
COLUMN_PLANS = {
    "A_timestamps_i64": NUMERIC_PLANS,
    "B_zipf_ids_u32": NUMERIC_PLANS + ("delta+bitpack",),
    "C_weights_bf16": ("bfloat16_profile",),
    "D_weights_f32": ("float32_profile",),
    "E_weights_f64": ("float64_profile",),
    "F_string_offsets_u32": ("delta+bitpack",),
    "G_int4_codes_u8": ("bitpack",),
}
# the codecs each bit-packing frame must record: F fuses (K11), G packs (K5),
# and B's wrapped u32 deltas refuse fusion, so its step lowers to delta + bitpack;
# and the level-7 phase's bz2 frame
FRAME_CODECS = {
    ("F_string_offsets_u32", "delta+bitpack"): "fused_delta_bitpack",
    ("G_int4_codes_u8", "bitpack"): "bitpack",
    ("B_zipf_ids_u32", "delta+bitpack"): "delta+bitpack",
    ("A_timestamps_i64", "transpose+bz2_backend"): "transpose+bz2_backend",
}
RAGGED_SIZES = (1, 31, 33, 1000, 4097, 100_003)
# K4's widths and sizes: w of 1, 2, 4 and 8 take the narrow path, w % 16 == 0
# the wide one and the other widths the byte-wise one; the ragged sizes and
# the offset planes run the vector paths' shifted loads and partial groups
UNSHUFFLE_WIDTHS = (1, 2, 3, 4, 8, 16, 33, 1024)
UNSHUFFLE_SIZES = RAGGED_SIZES + (16, 4096, 100_000)
# K3's sizes: multiples of 16 and n % 16 of 1, 7 and 15, so that its vector
# paths' unaligned plane stores and partial groups run at every width
SHUFFLE_SIZES = (1, 7, 15, 16, 31, 33, 1000, 4096, 4103, 100_000, 100_007)
# and one size at which the narrow path takes its eight-warp blocks
SHUFFLE_LARGE = (1 << 21) + 15
# K9's tables: the default, the largest held in shared memory, and global
FSE_TABLE_LOGS = (11, 15, 16)
# K15's lane counts (one, around its 128-lane blocks, column A's) and
# stream lengths (so max_rem of 1, 2, 3, 4095 and 4096, and short last lanes)
HUFF_LANE_COUNTS = (1, 63, 64, 65, 127, 128, 129, 16384)
HUFF_LENGTHS = (1, 2, 3, 4095, 4096, 3 * 4096 + 517)
# K10's tables: from 32 states to the largest held in shared memory, and
# global (table_log 27 is checked on a frame of its own)
FSE_DECODE_TABLE_LOGS = (5, 11, 15, 16)
# K2's back-to-back decodes of one input, at 2^26 and 2^28 uint8 deltas
# (4096 and 16,384 tiles): its look-back's ordering faults would show only
# under contention, as results that differ between runs; K15 and K10 are
# run as many times on column A's streams
CONTENTION_RUNS = 50
CONTENTION_LOG_SIZES = (26, 28)
# K13's sweep: every size up to 64 bytes, a 64 KiB selector trial's sample,
# and sizes past it at which the card takes one block of its large
# configuration, then several, then all it holds at once, each from byte
# offsets 0-15 of a view; single-value streams past the one-block size; a
# single-value stream of 2^32 + 17 bytes (a bin above 2^32) from byte 1 of
# its buffer; and the ms of a 64 KiB trial's call
HIST_SMALL_SIZES = tuple(range(65)) + (1 << 16, (1 << 16) + 16, (1 << 18) + 17, (1 << 25) + 5)
HIST_HUGE = (1 << 32) + 17
TRIAL_BYTES = 1 << 16
# the port's kernels in a profile (their CUDA function names), and the host
# stages whose cumulative time the profile phase prints: selector trials,
# the host codecs, and the frame's trip through the host
PORT_KERNEL = re.compile(
    r"(?:void )?((?:delta|byte(?:un)?shuffle|huffman|fse|lane_refill|float_split|float_merge"
    r"|histogram|bit(?:un)?pack|fused_delta_bitpack|fdb)_\w*)(<HConfig<\d+, \d+> >)?")
# K13's configurations, by the template argument in its kernel's name: one
# block for up to 64 KiB (the selector trials' samples), a grid above
HIST_CONFIGS = {"<HConfig<1, 8> >": "histogram_kernel (one block, <= 64 KiB)",
                "<HConfig<2, 16> >": "histogram_kernel (grid, > 64 KiB)"}
HOST_STAGES = ("choose_best", "_lz77_enc", "_lz77_dec", "_zlib_enc", "_zlib_dec",
               "_lzma_enc", "_lzma_dec", "_bz2_enc", "_bz2_dec", "write_frame", "read_frame",
               "write_container", "read_container", "_pack_bits", "_unpack_bits",
               "_tokenize_strings", "_untokenize_strings", "write_varints",
               "read_string_lengths", "_csv_split_enc", "_csv_split_dec",
               "_parse_numeric_enc", "_parse_numeric_dec", "_edge_list_enc", "_edge_list_dec",
               "_adj_gap_enc", "_adj_gap_dec", "_adjacency_auto")
COLUMN_BYTES = 64 << 20
PREFIX_BYTES = 4 << 20
# the level-7 phase: the float profiles, whose entropy_auto and bytes_auto
# menus add lzma_backend from level 7, and the bz2 leaf behind transpose, on
# 4 MiB prefixes (lzma on a whole 64 MiB column's planes takes tens of
# seconds on the host), each with the host leaf its frame must record (None:
# whatever the selectors pick); H_tiled_f32 is D's first 40,000 weights
# repeated, whose exponent plane repeats past DEFLATE's 32 KiB window and
# inside the 64 KiB trial sample, so its selector commits to lzma; the
# kernels each run must launch
LEVEL = 7
LEVEL_COLUMNS = (("D_weights_f32", "float32_profile", None),
                 ("C_weights_bf16", "bfloat16_profile", None),
                 ("H_tiled_f32", "float32_profile", "lzma_backend"),
                 ("A_timestamps_i64", "transpose+bz2_backend", "bz2_backend"))
TILE_VALUES = 40_000
LEVEL_ENCODE_KERNELS = ("float_split", "histogram", "byteshuffle")
LEVEL_DECODE_KERNELS = ("float_merge", "byteunshuffle")
WIDE_TABLE_LOG = 27  # above 26 the tANS decode step entries are 64-bit
WIDE_BYTES = 64 << 10
# the container phase: (label, column, stream kind, plan, chunk bytes past 4
# MiB), chunked at CHUNK_BYTES + the remainder and, on a 4 MiB prefix against
# the CPU, at PREFIX_CHUNK_BYTES + the remainder, so that the prefix's chunks
# start at the same offsets mod 16
CHUNK_BYTES = 4 << 20
PREFIX_CHUNK_BYTES = 1 << 20
CONTAINER_CALLS = (("A", "A_timestamps_i64", "numeric", "generic_profile", 0),
                   ("A_struct8", "A_timestamps_i64", "struct8", "generic_profile", 8),
                   ("G_serial", "G_int4_codes_u8", "serial", "generic_profile", 3),
                   ("F", "F_string_offsets_u32", "numeric", "delta+bitpack", 4))
# the kernels a codec's encoder and decoder launch on the card, whatever its
# data (bitpack is left out: at bits that do not divide 32 it takes the bit
# writer, not K5)
ENCODE_KERNELS_OF = {"delta": ("delta_encode",), "transpose": ("byteshuffle",),
                     "transpose_split": ("byteshuffle",),
                     "huffman": ("histogram", "huffman_map"),
                     "fse": ("histogram", "byteshuffle", "fse_encode"),
                     "fused_delta_bitpack": ("delta_encode", "fused_delta_bitpack"),
                     "float_split": ("float_split",)}
DECODE_KERNELS_OF = {"delta": ("delta_decode",), "transpose": ("byteunshuffle",),
                     "transpose_split": ("byteunshuffle",),
                     "huffman": ("huffman_decode", "byteunshuffle"),
                     "fse": ("fse_decode", "byteunshuffle"),
                     "fused_delta_bitpack": ("fused_delta_bitpack_decode",),
                     "float_split": ("float_merge",)}
# the records phase: the SAO catalogue at the published size of Silesia's
# ``sao`` (258,997 records of 28 bytes behind a 28-byte header: 7,251,944
# bytes), the same records headerless at 64 MiB, and a STRING column
SAO_HEADER_BYTES = 28
SAO_RECORDS = 258_997
SAO_WIDTHS = (8, 8, 2, 2, 4, 4)
R_RECORDS = COLUMN_BYTES // 28  # 2,396,745 records, 67,108,860 bytes
PREFIX_RECORDS = PREFIX_BYTES // 28
T_STRINGS = 1 << 22
T_VOCAB = 1 << 16
# the records phase's calls: (label, source, plan, chunk bytes); S's compress
# must launch SAO_ENCODE_KERNELS and its decompress SAO_DECODE_KERNELS
RECORD_CALLS = (("S", "S", "sao_profile", None),
                ("R", "R", "struct_profile", None),
                ("T", "T", "generic_profile", None),
                ("T_chunked", "T", "generic_profile", CHUNK_BYTES),
                ("T_dict", "T", "string_dict", None))
SAO_ENCODE_KERNELS = ("delta_encode", "byteshuffle", "histogram", "huffman_map", "fse_encode")
SAO_DECODE_KERNELS = ("delta_decode", "byteunshuffle")
# the CSV phase: the census files of the paper's §VI-C (the recipes of
# ``benchmarks/datasets.py``, copied), each through ``csv_profile(n_cols)``
# unchunked at level 5: (label, recipe, rows, columns, seed past --seed); C1
# is the PPMF person file at 3,400,000 rows (~67 MB), C2 the ACS PUMS
# housing file at 2,000,000 rows (~66 MB); seed 0 gives the recipes' seeds
CSV_CALLS = (("C1", "ppmf", 3_400_000, 8, 3), ("C2", "psam", 2_000_000, 7, 4))
POW10 = 10 ** np.arange(19, dtype=np.int64)
# the edge corpus: (label, file, columns, separator); each through
# ``csv_profile`` on the card, its frame equal to the CPU's.  The traps of a
# byte-exact split and parse: CRLF lines, a lone \r in a field, a last line
# without \r or without \n, one line, one field, separators with a border
# over runs of their bytes, a multi-byte UTF-8 separator, empty fields, and
# every int64 boundary and 19-, 20- and 21-byte digit string
INT64_EDGES = (b"0", b"-0", b"00", b"01", b"-01", b"+1", b" 1", b"1 ", b"-", b"",
               b"9223372036854775807", b"9223372036854775808", b"-9223372036854775808",
               b"-9223372036854775809", b"1234567890123456789", b"-1234567890123456789",
               b"12345678901234567890", b"99999999999999999999", b"-12345678901234567890",
               b"123456789012345678901", b"9223372036000000000", b"9223372035999999999",
               b"-9223372036999999999", b"1000000000", b"-999999999", b"\xd9\xa3")
CSV_EDGES = (
    ("crlf", b"1,a\r\n-2,b\r\n30,\r\n", 2, ","),
    ("lone_cr", b"1,a\rb\r\n2,\rc\r\n", 2, ","),
    ("cr_not_last", b"1,a\r\n2,b\r", 2, ","),
    ("cr_unterminated", b"1,a\r\n2,b\n", 2, ","),
    ("colons", b":::::\n1::2:::3\n::::\n::7::\n", 3, "::"),
    ("aba", b"ababa\n1aba2\n-7aba\nabab\n", 2, "aba"),
    ("section_sign", "1§2\n-3§x\n§\n".encode(), 2, "§"),
    ("empty_fields", b",,\n1,,2\n,,\n,-0,\n", 3, ","),
    ("no_trailing_newline", b"1,2\n3,4", 2, ","),
    ("one_line", b"-1,2\n", 2, ","),
    ("one_field", b"7", 1, ","),
    ("blank_lines", b"\n\n", 1, ","),
    ("int64", b"\n".join(INT64_EDGES) + b"\n", 1, ","),
)
# the graph phase: a SNAP-style text edge list at 64 MiB (the recipe of
# ``benchmarks/engine_bench.py``'s ``synth_edges``, copied; seed --seed + 5),
# 6,319,532 edges over 451,032 source nodes at seed 0, the scale of SNAP's
# web-Google (875,713 nodes, 5,105,039 edges), through ``graph_profile()``; and its
# complete lines' (u, v) pairs as interleaved uint32, through
# ``graph_bin_profile(4)``; both unchunked at level 5
GRAPH_BYTES = 64 << 20
# the sessions phase: chunks of the reference CLI's default size, and the
# device sleep (~0.1 s at 1980 MHz) behind which a side stream writes A
SESSION_CHUNK_BYTES = 4 << 20
SIDE_SLEEP_CYCLES = 200_000_000
GRAPH_SEED_SHIFT = 5
GRAPH_WINDOWS = (0, 8)  # adj_gap alone: plain gaps, and the profile's window
# the graph edge corpus: (label, file, profile spec or ``graph_profile``
# kwargs); each through its profile on the card, its frame equal to the
# CPU's.  The traps of the text parse (CRLF, comments and blank lines, no
# trailing newline, negative ids, -0, leading zeros, 2^63 as text, two
# separators on a line, a tie between tab and space, the separators "::" and
# "\r"), of adjacency lists (unsorted and duplicate edges, a decreasing
# list, a hub that no list may take as a reference, a chain of 200 runs each
# a copy of the one before), and binary ids at and above 2^(8w - 1)
HUB = b"".join(b"1\t%d\n" % (v * 3) for v in range(100)) + b"".join(
    b"2\t%d\n" % (v * 30) for v in range(10))
CHAIN = b"".join(b"%d\t%d\n" % (u, (1 << 40) + 7 * v) for u in range(200) for v in range(12))


def _bin_pairs(width: int) -> bytes:
    top = 1 << (8 * width - 1)
    ids = [0, 1, top - 1, top, top + 1, (top << 1) - 1]
    pairs = [(u, v) for u in ids for v in ids] + [(ids[3], v) for v in range(40, 0, -3)]
    dt = {2: np.uint16, 4: np.uint32, 8: np.uint64}[width]
    return np.array(pairs, dtype=dt).tobytes()


GRAPH_EDGES = (
    ("empty", b"", "graph"),
    ("newline", b"\n", "graph"),
    ("no_trailing_newline", b"1\t2\n1\t5\n3\t4", "graph"),
    ("comments_blank_lines", b"# FromNodeId\tToNodeId\n\n1\t2\n\n# x\n2\t3\n", "graph"),
    ("crlf", b"1\t2\r\n1\t3\r\n4\t5\r\n", "graph"),
    ("negative_ids", b"-1\t-2\n-1\t5\n-3\t-9223372036854775808\n", "graph"),
    ("minus_zero_leading_zeros", b"-0\t1\n01\t2\n1\t002\n0\t0\n", "graph"),
    ("two63_text", b"9223372036854775808\t1\n9223372036854775807\t18446744073709551615\n"
     b"9223372036854775807\t9223372036854775807\n", "graph"),
    ("two_separators", b"1\t2\t3\n1 2 3\n4\t5\n1\t\t2\n", "graph"),
    ("tab_space_tie", b"1\t2\n3 4\n5\t6\n7 8\n", "graph"),
    ("colons", b"1::2\n1:::3\n5::::6\n7::8\n::\n", "graph:::"),
    ("cr_separator", b"1\r2\n1\r3\r\n5\r6\n", {"sep": "\r"}),
    ("unsorted_duplicates", b"3\t1\n1\t3\n1\t3\n2\t9\n1\t3\n1\t2\n", "graph"),
    ("decreasing", b"1\t9\n1\t7\n1\t5\n1\t3\n1\t1\n", "graph"),
    ("hub", HUB, "graph"),
    ("chain_200", CHAIN, "graph"),
    ("bin2", _bin_pairs(2), "graph:bin:2"),
    ("bin4", _bin_pairs(4), "graph:bin:4"),
    ("bin8", _bin_pairs(8), "graph:bin:8"),
)
# encode_offset_sweep's sizes: ragged, past one vector and past a block's
OFFSET_SIZES = (1, 37, 4097)
# the checkpoint phase: the serving checkpoint of Llama-3.2-1B, the tree of
# ``repro/models/transformer.py``'s ``init_params`` for
# ``repro/configs/llama3_2_1b.py`` (stacked layer leaves, tied embeddings,
# bfloat16) at full width and depth: 11 leaves, 1,235,814,400 weights
LLAMA_LAYERS, LLAMA_D, LLAMA_HEADS, LLAMA_KV_HEADS = 16, 2048, 32, 8
LLAMA_FF, LLAMA_VOCAB = 8192, 128256
LLAMA_WEIGHTS = 1_235_814_400
CKPT_SLICE = 1 << 21  # the weights (4 MiB) of a leaf's slice held against the CPU's frame
CKPT_SLICED = ("params/layers/wq", "params/embed")
CKPT_HOST_LEAF = "params/layers/w_gate"  # the leaf whose save runs under cProfile
# one leaf per dtype route of ``compress_leaf``: (numpy dtype name, bytes)
ROUTE_LEAVES = (("float32", 1 << 20), ("float64", 2 << 20), ("float16", 1 << 20),
                ("int8", 1 << 20), ("uint8", 1 << 20), ("bool", 1 << 20),
                ("int16", 2 << 20), ("int32", 4 << 20), ("int64", 4 << 20),
                ("uint32", 3 << 20))
# the trainer's data shards (``repro/launch/train.py``'s ``make_shards`` at
# ``train_4k``'s batch 256 and sequence 4096): zipf tokens over the vocab
SHARDS, SHARD_BATCH, SHARD_SEQ = 4, 256, 4096
SHARD_TOKENS = SHARD_BATCH * (SHARD_SEQ + 1) * 4
# the crash kills with card victims: (crash point, occurrence)
CKPT_KILLS = (("ckpt.leaf", 3), ("ckpt.manifest", 1))
CKPT_SAVE_KERNELS = ("float_split",)
# the cli phase: (CSV_CALLS label, trained plan family, point) through --plan
CLI_TRAINED = (("C1", "ppmf_person", 7), ("C2", "psam_h", 3))
CLI_SALVAGE_CHUNK_BYTES = 1 << 20
# A's bytes as 8-byte records (field_split, then delta + transpose + zlib on
# the card): the generic default codes them with zlib alone, which decodes on
# the host, so the salvage case and the kernels-each-way check use this
CLI_RECORD_PROFILE = "struct:8"
CLI_DAMAGED = (7, 8, 40)  # the chunks damaged for salvage, as tests/test_salvage.py's
PLAN_FILES = 104  # the tracked .ozp files of tests/golden and results/trained
CKPT_RESTORE_KERNELS = ("float_merge",)
SERVICE_RECORD_PLAN = "struct:8"  # A's records: K1, K3 each way's encode, K2, K4 decode
SERVICE_FLOAT_PLAN = "float32"  # D's raw bytes: interpret_numeric, then the float profile
SERVICE_CLIENTS = 8
SERVICE_SLICE_BYTES = 16 << 20
SERVICE_SLICE_STEP = 6 << 20  # client i sends A[i * 6 MiB: i * 6 MiB + 16 MiB]
SERVICE_QUARANTINE = 3  # failures that trip a plan's breaker in the fault drill
SERVICE_COOLDOWN_S = 2.0
SERVICE_FAULT_POINT = "device.encode.cuda.float_split"
SERVICE_KERNELS = {SERVICE_RECORD_PLAN: (("delta_encode", "byteshuffle"),
                                         ("delta_decode", "byteunshuffle")),
                   SERVICE_FLOAT_PLAN: (("float_split",), ("float_merge",))}
SERVICE_HOST_STAGES = ("handle", "_do_compress", "read_request", "_next_block",
                       "write_response", "_write_body", "compress_file", "compress_chunks",
                       "rollover", "BlockReader.read", "spool.write")
FRONTEND_COMPUTE_THREADS = 4
FRONTEND_MAX_CONNS = 512
FRONTEND_REQUEST_TIMEOUT = 10.0  # the slow-loris budget: a frame must land within it
FRONTEND_IDLE = 200  # idle connections parked on the loop through the crowd
FRONTEND_LORIS = 40  # sockets each holding 1-7 bytes of a valid request
FRONTEND_PIPELINE_BYTES = 16 << 20
FRONTEND_STOP_JOIN_S = 30.0
FRONTEND_A_TURNS = 2  # A compresses alone (warm), then as many with the crowd parked
# the frontend's A request's host stages, each timed by a clock around its calls
FRONTEND_HOST_STAGES = ("feed", "_pump_write", "_response_chunks", "handle", "compress_file")
# the signatures phase: the reference probe's seven concrete atoms (SERIAL,
# STRING, STRUCT(3), NUMERIC(1/2/4/8)), its samples scaled to 1 MiB on the
# card (the host leaves to 64 KiB), and the repeats of each plan's check
SIG_ATOMS = ((0, 1), (3, 1), (1, 3), (2, 1), (2, 2), (2, 4), (2, 8))
SIG_BYTES = 1 << 20
SIG_HOST_BYTES = 64 << 10
SIG_HOST_LEAVES = ("lz77", "zlib_backend", "lzma_backend", "bz2_backend")
SIG_CHECK_REPEATS = 5
# A's checked and unchecked compresses, timed in turns (the order flips each pair)
RESOLVE_CHECK_PAIRS = 5
# the train phase: detect_frontend on the first 4 MiB of these; C1 through a
# `python -m repro_torch train` child at the CLI's defaults; A's first 4 MiB
# trained in-process at the same defaults; a 256 KiB C1 prefix at pop 4 and
# 2 generations on the card (the default workers and one) and on the CPU
TRAIN_SNIFF = ("A", "B", "C", "G", "S", "C1", "C2", "G1", "G2")
TRAIN_SAMPLE_BYTES = 4 << 20  # the CLI's --sample-bytes default
TRAIN_POP, TRAIN_GENS, TRAIN_POINTS = 16, 6, 8  # the CLI's --pop, --gens, --points
TRAIN_CHECK_BYTES = 256 << 10
TRAIN_REST_BYTES = 4 << 20  # the other points round-trip this much of C1, the best all of it
TRAIN_CHECK_POP, TRAIN_CHECK_GENS = 4, 2
TRAIN_CHILD_TIMEOUT = 600
TRAIN_FAULT_POINT = "device.encode.cuda.huffman"
TRAIN_FAULT_BYTES = 64 << 10
# K1, K3, K13, K14: the numeric seeds' delta, transpose -> huffman and fse
TRAIN_KERNELS = ("delta_encode", "byteshuffle", "histogram", "huffman_map")
TRAIN_HOST_STAGES = ("train", "cluster_streams", "_size_of", "nsga2", "evaluate_batch",
                     "_evaluate_plan", "_statically_rejected", "compile_genome",
                     "compress_traced", "decompress", "_same_stream", "pareto_prune",
                     "_lzma_enc", "_bz2_enc", "_zlib_enc", "_lz77_enc", "choose_best")
# the lm phase: Llama-3.2-1B's widths at depth 1 on the card against the CPU
# (batch 1, 16 tokens), the reduced MoE and SWA archs (the SWA arch fed
# past its window of 16, so its ring wraps), the full-width train driver
# crashed at step 4 and resumed to a final save at step 5, and a serve child
LM_ARCH = "llama3.2-1b"
LM_TOKENS = 16
LM_REDUCED = (("olmoe-1b-7b", 24), ("h2o-danube-3-4b", 40))  # (arch, tokens)
LM_LR = 3e-3  # launch.train's --lr default
LM_ATOL = {"logits": 1e-4, "loss": 1e-4, "decode": 3e-4}
LM_GRAD_RTOL = 1e-4  # of each leaf's largest gradient
LM_ADAM_ATOL = 1e-6  # m, v and params where no gradient sits at a sign flip
LM_SIGN_FLIP = 1e-3  # a param may move 2 lr apart where |g| < this x its leaf's max
LM_TRAIN_ARGS = ("--arch", LM_ARCH, "--steps", "5", "--save-interval", "3", "--log-every", "1")
LM_FAIL_AT = 4
LM_SAVED, LM_LAST = 3, 5
LM_SERVE_ARGS = ("--arch", LM_ARCH, "--batch", "8", "--prompt-len", "32", "--gen", "32")
LM_SERVE_TIMEOUT = 600
# the step-3 leaves decoded on the CPU beside the card's restore: every leaf
# under 1 MiB and the params' 67 MB wk leaf (the CPU decodes ~16 MB/s)
LM_CPU_LEAF_BYTES = 1 << 20
LM_CPU_LEAVES = ("params/layers/wk",)
# the leaf codec of f32 leaves, the int32 count and the int32 token shards
LM_KERNELS = ("delta_encode", "byteshuffle", "byteunshuffle", "float_split", "float_merge",
              "fse_encode", "fse_decode", "histogram", "huffman_map")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def columns(seed: int):
    """A: int64 ns timestamps, monotone with jittered gaps; B: zipf uint32 ids;
    C, D, E: normal(0, 0.02) weights in bfloat16 (as their uint16 bit
    patterns), float32 and float64; F: uint32 string offsets (an Arrow/Parquet
    offsets buffer: 0, then the running sum of lengths min(zipf(1.6), 255));
    G: int4 weight codes stored one per byte, clip(rint(normal(7.5, 2.5)), 0, 15)."""
    import torch

    rng = np.random.default_rng(seed)
    col_a = timestamps(rng, COLUMN_BYTES // 8)
    n_b = COLUMN_BYTES // 4
    id_space = rng.integers(0, 1 << 32, 1 << 22, dtype=np.uint64).astype(np.uint32)
    rank = np.minimum(rng.zipf(1.15, n_b), id_space.size) - 1
    col_b = id_space[rank]
    w32 = rng.normal(0.0, 0.02, COLUMN_BYTES // 2).astype(np.float32)
    col_c = torch.from_numpy(w32).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    col_d = rng.normal(0.0, 0.02, COLUMN_BYTES // 4).astype(np.float32)
    col_e = rng.normal(0.0, 0.02, COLUMN_BYTES // 8)
    lengths = np.minimum(rng.zipf(1.6, COLUMN_BYTES // 4 - 1), 255)
    col_f = np.concatenate([[0], np.cumsum(lengths)]).astype(np.uint32)
    col_g = np.clip(np.rint(rng.normal(7.5, 2.5, COLUMN_BYTES)), 0, 15).astype(np.uint8)
    return {"A_timestamps_i64": col_a, "B_zipf_ids_u32": col_b, "C_weights_bf16": col_c,
            "D_weights_f32": col_d, "E_weights_f64": col_e, "F_string_offsets_u32": col_f,
            "G_int4_codes_u8": col_g}


def timestamps(rng, n: int) -> np.ndarray:
    """Column A: n int64 nanosecond timestamps, ~1 ms ticks jittered by ±25 %."""
    gaps = 1_000_000 + rng.integers(-250_000, 250_000, n)
    return (1_700_000_000_000_000_000 + np.cumsum(gaps)).astype(np.int64)


def make_sao(n_records: int, seed: int) -> bytes:
    """The SAO star catalogue of the paper's §IV: a 28-byte header, then
    28-byte records of sorted right-ascension f64, bounded declination f64,
    low-cardinality spectral/magnitude/motion fields (the recipe of
    ``benchmarks/datasets.py``'s ``make_sao``, copied: that module imports
    the JAX package)."""
    rng = np.random.default_rng(seed)
    rec = np.zeros(
        n_records,
        dtype=[("sra", "<f8"), ("sdec", "<f8"), ("is", "<u2"), ("mag", "<i2"),
               ("xrpm", "<f4"), ("xdpm", "<f4")],
    )
    rec["sra"] = np.sort(rng.uniform(0, 2 * np.pi, n_records))
    rec["sdec"] = rng.uniform(-np.pi / 2, np.pi / 2, n_records)
    p = np.arange(1, 65, dtype=np.float64) ** -1.3
    rec["is"] = rng.choice(64, n_records, p=p / p.sum())
    rec["mag"] = rng.choice(np.arange(-149, 1450, 10, dtype=np.int16), n_records)
    rec["xrpm"] = rng.choice(np.round(np.linspace(-0.5, 0.5, 997), 5).astype(np.float32),
                             n_records)
    rec["xdpm"] = rng.choice(np.round(np.linspace(-0.5, 0.5, 1009), 5).astype(np.float32),
                             n_records)
    return b"\x00" * SAO_HEADER_BYTES + rec.tobytes()


def string_column(seed: int, n: int):
    """T: n strings, one Arrow/Parquet row group's string column: words of a
    vocabulary of 2^16 lowercase words, word r drawn with probability
    proportional to r^-1.1, each word min(zipf(1.6), 255) bytes long, and
    1/16 of the rows empty -> (content bytes, uint32 lengths)."""
    rng = np.random.default_rng(seed)
    word_lens = np.minimum(rng.zipf(1.6, T_VOCAB), 255).astype(np.int64)
    vocab = rng.integers(ord("a"), ord("z") + 1, int(word_lens.sum()), dtype=np.uint8)
    word_off = np.cumsum(word_lens) - word_lens
    p = np.arange(1, T_VOCAB + 1, dtype=np.float64) ** -1.1
    rank = rng.choice(T_VOCAB, n, p=p / p.sum())
    lengths = np.where(rng.random(n) < 1 / 16, 0, word_lens[rank])
    total = int(lengths.sum())
    row_off = np.cumsum(lengths) - lengths
    pos = np.arange(total, dtype=np.int64) + np.repeat(word_off[rank] - row_off, lengths)
    return vocab[pos], lengths.astype(np.uint32)


def _zipf_p(n, a, rng):
    p = np.arange(1, n + 1, dtype=np.float64) ** -a
    return p / p.sum()


def csv_rows(fields, sep: int = ord(",")) -> bytes:
    """Rows of non-negative ints as CSV text: each field ``b"%0*d" % (least,
    v)``, or nothing where ``empty`` is set, joined by ``sep`` (a byte) and
    each row ended by "\\n", written digit by digit into one buffer (numpy,
    no loop over rows).  ``fields``: (values, least digits, empty or None)
    per column."""
    widths = []
    for v, least, empty in fields:
        n_digits = np.maximum(np.searchsorted(POW10[1:], v, side="right") + 1, least)
        widths.append(n_digits if empty is None else np.where(empty, 0, n_digits))
    row_len = sum(widths) + len(fields)
    row_end = np.cumsum(row_len)
    out = np.full(int(row_end[-1]), sep, np.uint8)
    start = row_end - row_len
    for (v, _least, _empty), n_digits in zip(fields, widths):
        for k in range(int(n_digits.max())):  # each value's k-th digit from the right
            has = np.flatnonzero(k < n_digits)
            out[start[has] + n_digits[has] - 1 - k] = ord("0") + v[has] // POW10[k] % 10
        start += n_digits + 1
    out[row_end - 1] = ord("\n")
    return out.tobytes()


def make_ppmf_csv(n_rows: int = 120_000, seed: int = 3) -> bytes:
    """Census microdata (the PPMF person file): categorical codes, bounded
    ints, constant columns (the recipe of ``benchmarks/datasets.py``'s
    ``make_ppmf_csv``, copied, its rows written by ``csv_rows``)."""
    rng = np.random.default_rng(seed)
    state = rng.choice(56, n_rows, p=_zipf_p(56, 0.8, rng))
    county = rng.choice(999, n_rows, p=_zipf_p(999, 1.0, rng))
    age = rng.integers(0, 116, n_rows)
    sex = rng.choice([1, 2], n_rows)
    race = rng.choice(63, n_rows, p=_zipf_p(63, 1.6, rng))
    hisp = rng.choice([1, 2], n_rows, p=[0.81, 0.19])
    rtype = np.full(n_rows, 3)
    gqtype = rng.choice([0, 101, 201, 301, 401, 501], n_rows,
                        p=[0.96, 0.01, 0.01, 0.005, 0.005, 0.01])
    return csv_rows([(state, 1, None), (county, 3, None), (age, 1, None), (sex, 1, None),
                     (race, 1, None), (hisp, 1, None), (rtype, 1, None), (gqtype, 1, None)])


def make_psam_csv(n_rows: int = 80_000, seed: int = 4) -> bytes:
    """ACS PUMS-ish housing file: 13-digit serials, codes, and two columns
    with empty fields (the recipe of ``benchmarks/datasets.py``'s
    ``make_psam_csv``, copied, its rows written by ``csv_rows``)."""
    rng = np.random.default_rng(seed)
    serialno = 2023000000000 + np.cumsum(rng.integers(1, 40, n_rows).astype(np.int64))
    puma = rng.choice(2400, n_rows, p=_zipf_p(2400, 0.7, rng))
    wgtp = rng.integers(1, 300, n_rows)
    np_ = rng.choice(9, n_rows, p=_zipf_p(9, 1.4, rng))
    bds = rng.choice(6, n_rows, p=_zipf_p(6, 1.1, rng))
    rnt = np.where(rng.random(n_rows) < 0.6, rng.integers(100, 4000, n_rows), 0)
    val = np.where(rng.random(n_rows) < 0.55, rng.integers(10, 999, n_rows) * 1000, 0)
    return csv_rows([(serialno, 1, None), (puma, 1, None), (wgtp, 1, None), (np_, 1, None),
                     (bds, 1, None), (rnt, 1, rnt == 0), (val, 1, val == 0)])


def synth_edge_pairs(nbytes: int, seed: int = 0):
    """SNAP-style text edge list: ``# comment`` header then sorted ``u\\tv``
    lines, power-law target popularity (the recipe of
    ``benchmarks/engine_bench.py``'s ``synth_edges``, copied: the same
    ``rng`` calls and grow-until-covered loop, its lines written by
    ``csv_rows``).  Returns the text and all the recipe's (u, v) pairs."""
    rng = np.random.default_rng(seed)
    n_edges = nbytes // 8 + 64
    while True:  # dedup + short ids shrink the text: grow until it covers
        n_nodes = max(n_edges // 16, 64)
        w = 1.0 / np.arange(1, n_nodes + 1) ** 1.1
        w /= w.sum()
        dst = rng.choice(n_nodes, size=n_edges, p=w).astype(np.uint64)
        src = np.sort(rng.integers(0, n_nodes, n_edges)).astype(np.uint64)
        # np.unique(np.stack([src, dst], 1), axis=0), as one sort of
        # int64 keys: the rows' order is the keys' order, as dst < n_nodes
        keys = np.unique(src.astype(np.int64) * n_nodes + dst.astype(np.int64))
        pairs = np.stack([keys // n_nodes, keys % n_nodes], axis=1).astype(np.uint64)
        head = (
            b"# SNAP-style synthetic graph  Nodes: %d  Edges: %d\n"
            b"# FromNodeId\tToNodeId\n" % (n_nodes, len(pairs))
        )
        ids = pairs.astype(np.int64)
        n_digits = np.searchsorted(POW10[1:], ids, side="right") + 1
        if len(head) + int(n_digits.sum()) + 2 * len(pairs) >= nbytes:  # the text's size
            body = csv_rows([(ids[:, 0], 1, None), (ids[:, 1], 1, None)], sep=ord("\t"))
            return (head + body)[:nbytes], pairs
        n_edges += n_edges // 2


def stream_of(rt, cname: str, col: np.ndarray):
    """The column as a user hands it to ``compress``: column C as a
    ``torch.bfloat16`` weight tensor, the others as their numpy arrays."""
    import torch

    if cname == "C_weights_bf16":
        return rt.numeric(torch.from_numpy(col.view(np.int16)).view(torch.bfloat16))
    return rt.numeric(col)


def cuda_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn``: ``reps`` calls between two CUDA events,
    after one warm-up call.  The window opens behind a device-side sleep of
    ``QUEUE_CYCLES``, during which the host queues the calls, so the host's
    latency to launch the first one (a Python wrapper's checks, the ctypes
    call) is not counted as device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def turns_ms(kernel, library, reps: int):
    """``cuda_ms`` of a kernel and of the PyTorch call it is held against,
    timed in turns (kernel, library, library, kernel, kernel, library); the
    least of each one's three is kept, so a settling clock weighs on neither."""
    times = {kernel: [], library: []}
    for fn in (kernel, library, library, kernel, kernel, library):
        times[fn].append(cuda_ms(fn, reps))
    return min(times[kernel]), min(times[library])


def max_abs_err(got, want) -> float:
    import torch

    err = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"shape/dtype {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
        if not torch.equal(a, b):
            diff = (a.to(torch.float64) - b.to(torch.float64)).abs().max()
            err = max(err, 1.0, float(diff))
    return err


def kernel_phase(cols, rt, ops, ref, entropy, seed, sm_hz):
    """Each kernel at the main path's shapes against its plain version."""
    import torch

    dev = "cuda"
    col_a = torch.from_numpy(cols["A_timestamps_i64"]).to(dev)
    col_b = torch.from_numpy(cols["B_zipf_ids_u32"].view(np.int32)).to(dev)
    rows = []
    swept = encode_offset_sweep(ops, ref, seed)

    def row(name, source, replaces, err, ms, plain_ms, nbytes, nops, library_ms, **extra):
        err = max(err, swept.get(name, 0.0))
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = nops / CUDA_CORE_OPS_PER_S * 1e3
        rows.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": 0,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": library_ms,
            **extra,
        })
        print(f"kernel {name}: max_abs_err={err} ms={ms} plain_ms={plain_ms}"
              f" bound_ms={rows[-1]['bound_ms']} library_ms={library_ms}"
              + "".join(f" {k}={v}" for k, v in extra.items()))

    # K1 delta on both columns' widths (int64 timestamps, uint32 ids)
    err = max_abs_err([ops.delta_encode(col_a), ops.delta_encode(col_b)],
                      [ref.delta_encode(col_a), ref.delta_encode(col_b)])
    zero = col_a.new_zeros(1)
    row("delta_encode", "src/repro_torch/csrc/delta.cu", "src/repro/kernels/delta.py:30",
        err, cuda_ms(lambda: ops.delta_encode(col_a), 20),
        cuda_ms(lambda: ref.delta_encode(col_a), 5),
        2 * COLUMN_BYTES, col_a.numel(),
        cuda_ms(lambda: torch.diff(col_a, prepend=zero), 20))

    # K3 byte shuffle: every width, n % 16 and input offset of the sweep,
    # then the main path's shapes, each timed in turns with t().contiguous():
    # column A's 8-byte and B's 4-byte records, the tANS lane layout (65,536
    # lanes of 1024 symbols), a 64 KiB selector trial's records and the SAO
    # catalogue's 8-byte fields (the records phase's transpose_split)
    recs = col_a.view(torch.uint8).view(-1, 8)
    lanes = col_b.view(torch.uint8).view(-1, 1024)
    shuffle_shapes = {"(2^23, 8)": recs, "(2^24, 4)": col_b.view(torch.uint8).view(-1, 4),
                      "(65536, 1024)": lanes, "(8192, 8)": recs[:8192],
                      f"({SAO_RECORDS}, 8)": recs[:SAO_RECORDS]}
    err = max_abs_err([ops.byteshuffle(x) for x in shuffle_shapes.values()],
                      [ref.byteshuffle(x) for x in shuffle_shapes.values()])
    err = max(err, shuffle_sweep(ops, ref, seed))
    timed = {k: turns_ms(lambda x=x: ops.byteshuffle(x), lambda x=x: x.t().contiguous(), 20)
             for k, x in shuffle_shapes.items()}
    row("byteshuffle", "src/repro_torch/csrc/byteshuffle.cu",
        "src/repro/kernels/byteshuffle.py:21",
        err, timed["(2^23, 8)"][0], cuda_ms(lambda: ref.byteshuffle(recs), 20),
        2 * COLUMN_BYTES, 0, timed["(2^23, 8)"][1],
        shape="uint8 (2^23, 8) (column A's records)",
        ms_by_shape={k: t[0] for k, t in timed.items()},
        library_ms_by_shape={k: t[1] for k, t in timed.items()},
        bound_ms_by_shape={k: 2 * x.numel() / HBM_BYTES_PER_S * 1e3
                           for k, x in shuffle_shapes.items()})

    # K14 Huffman map over 2^26 byte symbols (the transposed column B)
    planes = ops.byteshuffle(col_b.view(torch.uint8).view(-1, 4)).reshape(-1)
    counts = ref.histogram_exact(planes).cpu().numpy().astype(np.int64)
    lens = entropy._huffman_code_lengths(counts)
    codes = entropy._huffman_codes_cached(lens)
    tcodes = torch.from_numpy(codes.astype(np.int32)).to(dev)
    tlens = torch.from_numpy(lens.astype(np.int32)).to(dev)
    err = max_abs_err(ops.huffman_map(planes, tcodes, tlens),
                      ref.huffman_map(planes, tcodes, tlens))
    n_sym = planes.numel()
    row("huffman_map", "src/repro_torch/csrc/huffman.cu", "src/repro/kernels/huffman.py:34",
        err, cuda_ms(lambda: ops.huffman_map(planes, tcodes, tlens), 20),
        cuda_ms(lambda: ref.huffman_map(planes, tcodes, tlens), 5),
        n_sym * (1 + 4 + 4) + 2 * 256 * 4, 0,
        cuda_ms(lambda: tcodes[planes.long()], 5))

    # K9 tANS lane walk over the same 2^26 symbols (65,536 lanes of 1024) and
    # over a 64 KiB selector trial's 64 lanes, checked at every table_log and
    # lane-length pattern of fse_encode_check, timed at table_log 11
    err, k9 = fse_encode_check(ops, ref, entropy, planes, counts, seed)
    args, trial = k9[11, 1 << 16], k9[11, 64]
    n_lanes = args[0].shape[1]
    k9_bytes = lambda a: (a[0].numel() * (1 + 4 + 4) + a[0].shape[1] * 8  # noqa: E731
                          + (5 * 256 + a[-1]) * 4)
    row("fse_encode", "src/repro_torch/csrc/fse.cu", "src/repro/kernels/fse.py:76",
        err, cuda_ms(lambda: ops.fse_encode(*args), 10),
        cuda_ms(lambda: ref.fse_encode_lanes(*args), 2),
        k9_bytes(args), n_sym * 12, None,
        shape=f"{n_lanes} lanes x 1024, table_log 11",
        trial_ms=cuda_ms(lambda: ops.fse_encode(*trial), 20),
        trial_shape="64 lanes x 1024 (a 64 KiB selector trial)",
        trial_bound_ms=k9_bytes(trial) / HBM_BYTES_PER_S * 1e3,
        table_log_15_ms=cuda_ms(lambda: ops.fse_encode(*k9[15, 1 << 16]), 10),
        table_log_16_ms=cuda_ms(lambda: ops.fse_encode(*k9[16, 1 << 16]), 10))
    print(f"latency floor, from an assumed {STEP_CYCLES} cycles per dependent step at"
          f" the max SM clock (derived, not measured):"
          f" fse_encode_64_lanes_ms={trial[0].shape[0] * STEP_CYCLES / sm_hz * 1e3}")
    del k9, args, trial

    # K7 float split on columns C's and D's shapes (bfloat16 2^25, float32 2^24)
    col_c = torch.from_numpy(cols["C_weights_bf16"].view(np.int16)).to(dev)
    col_d = torch.from_numpy(cols["D_weights_f32"].view(np.int32)).to(dev)
    split_c, split_d = ops.float_split(col_c, 0), ops.float_split(col_d, 2)
    err = max_abs_err([*split_c, *split_d],
                      [*ref.float_split(col_c, 0), *ref.float_split(col_d, 2)])
    row("float_split", "src/repro_torch/csrc/float_split.cu",
        "src/repro/kernels/float_split.py:41",
        err, cuda_ms(lambda: ops.float_split(col_c, 0), 20),
        cuda_ms(lambda: ref.float_split(col_c, 0), 5),
        tensor_bytes(col_c, *split_c), 5 * col_c.numel(), None,
        shape=f"bfloat16[{col_c.numel()}]",
        f32_ms=cuda_ms(lambda: ops.float_split(col_d, 2), 20),
        f32_plain_ms=cuda_ms(lambda: ref.float_split(col_d, 2), 5),
        f32_bound_ms=tensor_bytes(col_d, *split_d) / HBM_BYTES_PER_S * 1e3)

    # K13 histogram: column A's delta + transposed stream (2^26 bytes, the
    # high planes nearly all one value), uniform random bytes, column C's
    # exponent plane and a single-value stream, then a 64 KiB selector
    # trial's sample of A's stream; timed beside torch.bincount, its plain
    # version, and held against it on the sweep of histogram_sweep
    a_stream = ops.byteshuffle(ops.delta_encode(col_a).view(torch.uint8).view(-1, 8)).reshape(-1)
    uniform = torch.from_numpy(
        np.random.default_rng(seed).integers(0, 256, a_stream.numel(), dtype=np.uint8)).to(dev)
    exp_c = split_c[1]
    single = torch.full_like(a_stream, 7)
    trial = a_stream[:TRIAL_BYTES]
    hist_inputs = [a_stream, uniform, exp_c, single, trial, a_stream[3:-5]]
    err = max_abs_err([ops.histogram(x) for x in hist_inputs],
                      [ref.histogram_exact(x) for x in hist_inputs])
    err = max(err, histogram_sweep(ops, ref, seed))
    ops.reset_launches()
    ops.histogram(trial)
    trial_launches = ops.histogram.launches
    row("histogram", "src/repro_torch/csrc/histogram.cu", "src/repro/kernels/histogram.py:38",
        err, cuda_ms(lambda: ops.histogram(a_stream), 20),
        cuda_ms(lambda: ref.histogram_exact(a_stream), 20),
        a_stream.numel() + 256 * 8, a_stream.numel(),
        cuda_ms(lambda: torch.bincount(a_stream, minlength=256), 20),
        shape=f"uint8[{a_stream.numel()}] (column A, delta + transpose)",
        uniform_ms=cuda_ms(lambda: ops.histogram(uniform), 20),
        uniform_bincount_ms=cuda_ms(lambda: torch.bincount(uniform, minlength=256), 20),
        bf16_exponent_ms=cuda_ms(lambda: ops.histogram(exp_c), 20),
        bf16_exponent_bincount_ms=cuda_ms(lambda: torch.bincount(exp_c, minlength=256), 20),
        bf16_exponent_bound_ms=(exp_c.numel() + 256 * 8) / HBM_BYTES_PER_S * 1e3,
        single_value_ms=cuda_ms(lambda: ops.histogram(single), 20),
        trial_ms=cuda_ms(lambda: ops.histogram(trial), 20),
        trial_ms_one_call=cuda_ms(lambda: ops.histogram(trial), 1),
        trial_bincount_ms=cuda_ms(lambda: torch.bincount(trial, minlength=256), 20),
        trial_bound_ms=(TRIAL_BYTES + 256 * 8) / HBM_BYTES_PER_S * 1e3,
        trial_launches_per_call=trial_launches)
    if trial_launches != 1:
        fail(f"histogram: a 64 KiB trial's call launched {trial_launches} kernels, not 1")
    del single

    # K2 delta decode: the inverse of K1 on both columns' widths, each timed
    # in turns with the one cumsum call that computes the same function (on
    # B's int32 carrier with dtype=int32, which wraps as K2 does: a plain
    # cumsum of an int32 tensor returns int64)
    d_a, d_b = ops.delta_encode(col_a), ops.delta_encode(col_b)
    got = [ops.delta_decode(d_a), ops.delta_decode(d_b)]
    err = max_abs_err(got, [ref.delta_decode(d_a), ref.delta_decode(d_b)])
    err = max(err, max_abs_err(got, [col_a, col_b]))
    err = max(err, delta_decode_sweep(ops, ref, seed))
    a_ms, a_cumsum_ms = turns_ms(lambda: ops.delta_decode(d_a), lambda: torch.cumsum(d_a, 0), 20)
    b_ms, b_cumsum_ms = turns_ms(lambda: ops.delta_decode(d_b),
                                 lambda: torch.cumsum(d_b, 0, dtype=torch.int32), 20)
    row("delta_decode", "src/repro_torch/csrc/delta.cu", "src/repro/kernels/delta.py:56",
        err, a_ms, cuda_ms(lambda: ref.delta_decode(d_a), 5),
        2 * COLUMN_BYTES, col_a.numel(), a_cumsum_ms,
        shape=f"int64[{d_a.numel()}] (column A's deltas)",
        u32_ms=b_ms, u32_library_ms=b_cumsum_ms,
        u32_bound_ms=2 * COLUMN_BYTES / HBM_BYTES_PER_S * 1e3)

    # K15 Huffman decode and K10 tANS decode on column A's entropy-coded
    # streams, as decompress hands them over
    col_a_np = cols["A_timestamps_i64"]
    huff = entropy.huffman_lanes(*node_streams(
        rt.compress(rt.pipeline("delta", "transpose", "huffman"), rt.numeric(col_a_np),
                    device="cuda"),
        "huffman"))
    buf, pos, lut, max_rem, n_sym_a, _stype = huff
    h_planes = ops.huffman_decode(buf, pos, lut, max_rem)
    err = max_abs_err([h_planes], [ref.huffman_decode_lanes(buf, pos, lut, max_rem)])
    err = max(err, back_to_back("huffman_decode", lambda: ops.huffman_decode(buf, pos, lut, max_rem),
                                h_planes))
    err = max(err, huffman_decode_sweep(rt, ops, ref, entropy, huff, seed))
    stream_bytes = buf.numel()
    row("huffman_decode", "src/repro_torch/csrc/huffman.cu", "src/repro/kernels/huffman.py:84",
        err, cuda_ms(lambda: ops.huffman_decode(buf, pos, lut, max_rem), 5),
        cuda_ms(lambda: ref.huffman_decode_lanes(buf, pos, lut, max_rem), 1),
        stream_bytes + pos.numel() * 8 + lut.numel() * 2 + h_planes.numel(),
        n_sym_a * 8, None,
        shape=f"{pos.numel()} lanes x {max_rem}")

    f_args, _n, _stype = entropy.fse_lanes(*node_streams(
        rt.compress(rt.pipeline("delta", "transpose", "fse"), rt.numeric(col_a_np),
                    device="cuda"),
        "fse"))
    fbuf, _base, bitlen, _state0, sym, _nbb, f_rem = f_args
    f_planes = ops.fse_decode(*f_args)
    err = max_abs_err([f_planes], [ref.fse_decode_lanes(*f_args)])
    err = max(err, back_to_back("fse_decode", lambda: ops.fse_decode(*f_args), f_planes))
    err = max(err, fse_decode_sweep(ops, ref, entropy, seed))
    # table_log 16: K9 and K10 read tables of 2^16 entries from global memory
    wide = rt.pipeline("delta", "transpose", ("fse", {"table_log": 16}))
    prefix_a = col_a_np[: PREFIX_BYTES // 8]
    wide_frame = card_frame(rt, wide, rt.numeric(prefix_a))
    if wide_frame != cpu_frame(rt, wide, rt.numeric(prefix_a)):
        fail("table_log 16: the card's frame differs from the CPU's")
    w_args, _n, _stype = entropy.fse_lanes(*node_streams(wide_frame, "fse"))
    err = max(err, max_abs_err([ops.fse_decode(*w_args)], [ref.fse_decode_lanes(*w_args)]))
    (wide_out,) = rt.decompress(wide_frame, device="cuda")
    if not torch.equal(wide_out.data, rt.numeric(prefix_a).data.to(dev)):
        fail("table_log 16: decompress on the card did not return the prefix")
    # table_log 27: 2^27-state tables, 64-bit step entries.  Uniform bytes keep
    # the reference's (256, max count) encode table small (skewed data at this
    # table_log would take tens of GiB of host memory to build it).
    t0 = time.perf_counter()
    wide_bytes = np.random.default_rng(seed + WIDE_TABLE_LOG).integers(
        0, 256, WIDE_BYTES, dtype=np.uint8).tobytes()
    plan27 = rt.pipeline(("fse", {"table_log": WIDE_TABLE_LOG}))
    # the host tables (~45 s to build) are built once, in the process-wide
    # coder-table cache, which the calls below share
    frame27 = card_frame(rt, plan27, rt.serial(wide_bytes))
    if frame27 != cpu_frame(rt, plan27, rt.serial(wide_bytes)):
        fail(f"table_log {WIDE_TABLE_LOG}: the card's frame differs from the CPU's")
    args27, _n, _stype = entropy.fse_lanes(*node_streams(frame27, "fse"))
    sym27, nbb27 = args27[4], args27[5]
    if nbb27.dtype != torch.int64 or nbb27.numel() != 1 << WIDE_TABLE_LOG:
        fail(f"table_log {WIDE_TABLE_LOG}: the decode step table is not 2^27 64-bit entries")
    err = max(err, max_abs_err([ops.fse_decode(*args27)], [ref.fse_decode_lanes(*args27)]))
    (out27,) = rt.decompress(frame27, device="cuda")
    if out27.content_bytes() != wide_bytes:
        fail(f"table_log {WIDE_TABLE_LOG}: decompress on the card did not return the input")
    table27_bytes = tensor_bytes(sym27, nbb27)
    wide27_ms = cuda_ms(lambda: ops.fse_decode(*args27), 5)
    print(f"check table_log {WIDE_TABLE_LOG}: {WIDE_BYTES} uniform bytes, card frame == cpu"
          f" frame ({len(frame27)} bytes), K10 == plain, decoded on the card;"
          f" decode tables {table27_bytes} bytes on the card;"
          f" seconds={time.perf_counter() - t0}")
    del args27, sym27, nbb27
    rt.coder_cache_clear()  # the 2^27-state tables leave the process-wide cache
    row("fse_decode", "src/repro_torch/csrc/fse.cu", "src/repro/kernels/fse.py:167",
        err, cuda_ms(lambda: ops.fse_decode(*f_args), 10),
        cuda_ms(lambda: ref.fse_decode_lanes(*f_args), 1),
        fbuf.numel() + bitlen.numel() * (8 + 8 + 4) + sym.numel() * 5 + f_planes.numel(),
        f_planes.numel() * 8, None,
        shape=f"{bitlen.numel()} lanes x {f_rem}",
        table_log_16_ms=cuda_ms(lambda: ops.fse_decode(*w_args), 10),
        table_log_16_shape=f"{w_args[2].numel()} lanes x {w_args[6]}",
        table_log_27_ms=wide27_ms, table_log_27_table_bytes=table27_bytes)
    print(f"latency floor, from an assumed {STEP_CYCLES} cycles per dependent step at"
          f" the max SM clock (derived, not measured):"
          f" huffman_decode_ms={max_rem * STEP_CYCLES / sm_hz * 1e3}"
          f" fse_decode_ms={f_rem * STEP_CYCLES / sm_hz * 1e3}")

    # K4 byte unshuffle: column A's and B's planes, both decoders' lanes and
    # the SAO catalogue's 8-byte planes (the records phase's transpose_split)
    shapes = {
        "(8, 2^23)": ops.byteshuffle(recs),
        "(4, 2^24)": ops.byteshuffle(col_b.view(torch.uint8).view(-1, 4)),
        f"{tuple(h_planes.shape)}": h_planes,
        f"{tuple(f_planes.shape)}": f_planes,
        f"(8, {SAO_RECORDS})": ops.byteshuffle(recs[:SAO_RECORDS]),
    }
    err = max_abs_err([ops.byteunshuffle(p) for p in shapes.values()],
                      [ref.byteunshuffle(p) for p in shapes.values()])
    err = max(err, max_abs_err([ops.byteunshuffle(shapes["(8, 2^23)"])], [recs]))
    if not torch.equal(ops.byteunshuffle(h_planes).reshape(-1)[:n_sym_a],
                       ops.byteunshuffle(f_planes).reshape(-1)[:n_sym_a]):
        fail("the Huffman and tANS decoders disagree on column A's planes")
    err = max(err, unshuffle_sweep(ops, ref, seed))
    planes_a = shapes["(8, 2^23)"]
    # a ragged size of each regime (a column of 2^23 - 8 records, a lane count
    # that is not a multiple of 16), timed and checked like the rest
    ragged = {"(8, 2^23 - 8)": planes_a.reshape(-1)[: 8 * ((1 << 23) - 8)].view(8, -1),
              f"({h_planes.shape[0]}, {h_planes.shape[1] - 1})":
                  h_planes.reshape(-1)[: h_planes.shape[0] * (h_planes.shape[1] - 1)]
                  .view(h_planes.shape[0], -1)}
    err = max(err, max_abs_err([ops.byteunshuffle(p) for p in ragged.values()],
                               [ref.byteunshuffle(p) for p in ragged.values()]))
    shapes.update(ragged)
    timed = {k: turns_ms(lambda p=p: ops.byteunshuffle(p), lambda p=p: p.t().contiguous(), 20)
             for k, p in shapes.items()}
    ms_by_shape = {k: t[0] for k, t in timed.items()}
    library_by_shape = {k: t[1] for k, t in timed.items()}
    bound_by_shape = {k: 2 * p.numel() / HBM_BYTES_PER_S * 1e3 for k, p in shapes.items()}
    row("byteunshuffle", "src/repro_torch/csrc/byteshuffle.cu",
        "src/repro/kernels/byteshuffle.py:36",
        err, ms_by_shape["(8, 2^23)"],
        cuda_ms(lambda: ref.byteunshuffle(planes_a), 20),
        2 * COLUMN_BYTES, 0, library_by_shape["(8, 2^23)"],
        shape="uint8 (8, 2^23) (column A's planes)", ms_by_shape=ms_by_shape,
        library_ms_by_shape=library_by_shape, bound_ms_by_shape=bound_by_shape)

    # K8 float merge: C's and D's planes back to their bit patterns
    merged = [ops.float_merge(*split_c, 0), ops.float_merge(*split_d, 2)]
    err = max_abs_err(merged, [ref.float_merge(*split_c, 0), ref.float_merge(*split_d, 2)])
    err = max(err, max_abs_err(merged, [col_c, col_d]))
    row("float_merge", "src/repro_torch/csrc/float_split.cu",
        "src/repro/kernels/float_split.py:62",
        err, cuda_ms(lambda: ops.float_merge(*split_c, 0), 20),
        cuda_ms(lambda: ref.float_merge(*split_c, 0), 5),
        tensor_bytes(col_c, *split_c), 5 * col_c.numel(), None,
        shape=f"bfloat16[{col_c.numel()}]",
        f32_ms=cuda_ms(lambda: ops.float_merge(*split_d, 2), 20),
        f32_plain_ms=cuda_ms(lambda: ref.float_merge(*split_d, 2), 5),
        f32_bound_ms=tensor_bytes(col_d, *split_d) / HBM_BYTES_PER_S * 1e3)

    # K16 lane refill on 65,536 cursors into column A's Huffman bitstream,
    # and on 2^24, where its bytes and not the launch set its time
    rng = np.random.default_rng(seed)
    cursors = torch.from_numpy(rng.integers(0, 8 * (stream_bytes - 16), 1 << 16)).to(dev)
    many = torch.from_numpy(rng.integers(0, 8 * (stream_bytes - 16), 1 << 24)).to(dev)
    err = max_abs_err([ops.lane_refill(buf, c) for c in (cursors, many)],
                      [ref.lane_refill(buf, c) for c in (cursors, many)])
    row("lane_refill", "src/repro_torch/csrc/lane_refill.cu",
        "src/repro/kernels/lane_refill.py:39",
        err, cuda_ms(lambda: ops.lane_refill(buf, cursors), 20),
        cuda_ms(lambda: ref.lane_refill(buf, cursors), 20),
        cursors.numel() * (8 + 5 + 4), cursors.numel() * 8, None,
        runs_inside=[],
        cursors_2_24_ms=cuda_ms(lambda: ops.lane_refill(buf, many), 20),
        cursors_2_24_plain_ms=cuda_ms(lambda: ref.lane_refill(buf, many), 2),
        cursors_2_24_bound_ms=many.numel() * (8 + 5 + 4) / HBM_BYTES_PER_S * 1e3,
        # a cursor's 5-byte window at a random offset moves a 32-byte sector
        cursors_2_24_sector_bound_ms=many.numel() * (8 + 32 + 4) / HBM_BYTES_PER_S * 1e3)
    del many

    bitpack_rows(cols, ops, ref, seed, row)
    for r in rows:
        if r["max_abs_err"] != 0:
            fail(f"kernel {r['name']} disagrees with its plain version")
    return rows


def shuffle_sweep(ops, ref, seed) -> float:
    """K3 at every width of ``UNSHUFFLE_WIDTHS`` and size of ``SHUFFLE_SIZES``
    (multiples of 16 and n % 16 of 1, 7 and 15), and at the narrow widths
    also at ``SHUFFLE_LARGE`` records, on records that start at
    their allocation, 1 byte into it and 16 bytes into it: the narrow, wide
    and byte-wise paths with their shifted loads, unaligned plane stores and
    partial groups, each against ``ref.byteshuffle``."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    err = 0.0
    cases = [(w, n) for w in UNSHUFFLE_WIDTHS for n in SHUFFLE_SIZES]
    cases += [(w, SHUFFLE_LARGE) for w in (1, 2, 4, 8)]
    for w, n in cases:
        buf = torch.randint(0, 256, (w * n + 16,), dtype=torch.uint8, device="cuda",
                            generator=gen)
        for offset in (0, 1, 16):
            x = buf[offset: offset + w * n].view(n, w)
            err = max(err, max_abs_err([ops.byteshuffle(x)], [ref.byteshuffle(x)]))
    print(f"check byteshuffle: w {UNSHUFFLE_WIDTHS} x n {SHUFFLE_SIZES}, and w (1, 2, 4, 8)"
          f" x n {SHUFFLE_LARGE}, x record offsets (0, 1, 16): max_abs_err={err}")
    return err


def encode_offset_sweep(ops, ref, seed) -> dict:
    """The encode kernels that a container's chunk views reach, on views that
    start at every byte offset below 16 that the element width allows (every
    one for bytes), at ``OFFSET_SIZES``: K1 at widths 1/2/4/8, K5 and K11 at
    every bits and width 1/2/4, K7 in each float format, K14, and K3 at
    widths 1, 2, 3, 4, 8 and 16; each against its plain version.  A chunk
    of a NUMERIC column starts at any multiple of its element, and one of a
    SERIAL stream at any byte."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    carriers = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    errs = {k: 0.0 for k in ("delta_encode", "bitpack", "fused_delta_bitpack", "float_split",
                             "huffman_map", "byteshuffle")}

    def views(width, n):
        """n-element views of a random buffer at byte offsets 0, w, .. < 16."""
        buf = torch.randint(0, 256, (width * n + 16,), dtype=torch.uint8, device="cuda",
                            generator=gen)
        return [buf[off: off + width * n].view(carriers[width]) for off in range(0, 16, width)]

    def check(name, got, want):
        errs[name] = max(errs[name], max_abs_err(got, want))

    for n in OFFSET_SIZES:
        for width in carriers:
            for x in views(width, n):
                check("delta_encode", [ops.delta_encode(x)], [ref.delta_encode(x)])
        for width in (1, 2, 4):
            for bits in ref.PACK_BITS:
                for x in views(width, n):
                    if bits < 8 * width:  # values below 2^bits, masked in place (a view)
                        x.bitwise_and_((1 << bits) - 1)
                    check("bitpack", [ops.bitpack(x, bits)], [ref.bitpack(x, bits)])
                    check("fused_delta_bitpack", [ops.fused_delta_bitpack(x, bits)],
                          [ref.fused_delta_bitpack(x, bits)])
        for fmt, (width, *_rest) in ref.FLOAT_FORMATS.items():
            for x in views(width, n):
                check("float_split", [*ops.float_split(x, fmt)], [*ref.float_split(x, fmt)])
        codes = torch.randint(0, 1 << 15, (256,), dtype=torch.int32, device="cuda", generator=gen)
        lens = torch.randint(1, 16, (256,), dtype=torch.int32, device="cuda", generator=gen)
        for x in views(1, n):
            check("huffman_map", [*ops.huffman_map(x, codes, lens)],
                  [*ref.huffman_map(x, codes, lens)])
            for w in (1, 2, 3, 4, 8, 16):
                recs = x[: n // w * w].view(-1, w)
                check("byteshuffle", [ops.byteshuffle(recs)], [ref.byteshuffle(recs)])
    print(f"check encode kernels on views at byte offsets 0-15 (steps of the element width),"
          f" n {OFFSET_SIZES}: {json.dumps(errs)}")
    return errs


def fse_encode_check(ops, ref, entropy, planes, counts, seed):
    """K9 against ``ref.fse_encode_lanes`` on the 2^26 symbols of ``planes``
    as 65,536 lanes and on their first 64 KiB as a selector trial's 64 lanes,
    at each table_log of ``FSE_TABLE_LOGS`` (tables from ``counts``), with
    every lane full and with lanes of length 1 and 2 and a short last lane.
    Then symbols the table does not hold (norm 0), which step to state 0:
    uniform bytes in 1000 lanes, a short last one zero-padded, under tables
    of table_log 11 (shared) and 16 (global) normalized from bytes 64-127
    alone, so that byte 0 and most symbols are absent.  Returns the error
    and each (table_log, n_lanes) case's arguments with full lanes."""
    import torch

    dev = "cuda"
    i32 = lambda a: torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)  # noqa: E731
    layouts = [ops.byteshuffle(planes.view(-1, 1024)),
               ops.byteshuffle(planes[: 64 * 1024].view(64, 1024))]
    err = 0.0
    cases = {}
    for table_log in FSE_TABLE_LOGS:
        norm = entropy._normalize_counts(counts, table_log)
        _ds, _dn, _db, enc, nb0, thr, st0 = entropy._fse_tables_cached(norm, table_log)
        sym_start, compact = ref.compact_encode_table(i32(norm), i32(enc.reshape(-1)),
                                                      enc.shape[1])
        tables = (i32(nb0), i32(thr), i32(st0), i32(norm), sym_start, compact, enc.shape[1],
                  1 << table_log)
        for lanesT in layouts:
            n_lanes = lanesT.shape[1]
            full = torch.full((n_lanes,), 1024, dtype=torch.int32, device=dev)
            short = full.clone()
            short[0], short[1], short[-1] = 1, 2, 517
            for rem in (full, short):
                args = (lanesT, rem, *tables)
                err = max(err, max_abs_err(ops.fse_encode(*args), ref.fse_encode_lanes(*args)))
            cases[table_log, n_lanes] = (lanesT, full, *tables)
    print(f"check fse_encode: table_log {FSE_TABLE_LOGS} x (65536, 64) lanes x (all full;"
          f" lanes of 1 and 2 and a last lane of 517): max_abs_err={err}")

    rng = np.random.default_rng(seed + 9)
    other = np.bincount(rng.zipf(1.3, 4000) % 64 + 64, minlength=256).astype(np.int64)
    n_sym = 999 * 1024 + 517
    padded = np.zeros(1000 * 1024, np.uint8)
    padded[:n_sym] = rng.integers(0, 256, n_sym, dtype=np.uint8)
    lanesT = ops.byteshuffle(torch.from_numpy(padded).to(dev).view(1000, 1024))
    rem = torch.full((1000,), 1024, dtype=torch.int32, device=dev)
    rem[0], rem[1], rem[-1] = 1, 2, 517
    absent_err = 0.0
    for table_log in (11, 16):
        norm = entropy._normalize_counts(other, table_log)
        if not (norm[padded[:n_sym]] == 0).any() or norm[0] != 0:
            fail(f"fse_encode absent-symbol case at table_log {table_log} holds every symbol")
        _ds, _dn, _db, enc, nb0, thr, st0 = entropy._fse_tables_cached(norm, table_log)
        sym_start, compact = ref.compact_encode_table(i32(norm), i32(enc.reshape(-1)),
                                                      enc.shape[1])
        args = (lanesT, rem, i32(nb0), i32(thr), i32(st0), i32(norm), sym_start, compact,
                enc.shape[1], 1 << table_log)
        absent_err = max(absent_err, max_abs_err(ops.fse_encode(*args),
                                                 ref.fse_encode_lanes(*args)))
    print(f"check fse_encode: absent symbols, table_log (11, 16) x 1000 lanes (lanes of 1"
          f" and 2, a zero-padded last lane of 517): max_abs_err={absent_err}")
    return max(err, absent_err), cases


def back_to_back(name, fn, want, what="column A's stream") -> float:
    """``fn`` run ``CONTENTION_RUNS`` times back to back on ``what``, every
    result equal to ``want`` (the plain version's result, or the kernel's
    own first one held against it by the caller); 1.0 if one differs."""
    import torch

    runs = [fn() for _ in range(CONTENTION_RUNS)]
    differ = sum(not torch.equal(r, want) for r in runs)
    print(f"check {name}: {CONTENTION_RUNS} back-to-back runs on {what}, {differ} differ")
    return 1.0 if differ else 0.0


def huffman_decode_sweep(rt, ops, ref, entropy, huff, seed) -> float:
    """K15 against ``ref.huffman_decode_lanes``: column A's lanes (``huff``)
    at lane counts ``HUFF_LANE_COUNTS``, started in reverse order, with
    equal starts and with starts at the stream's end; then streams the codec
    writes on the card at every length of ``HUFF_LENGTHS`` (so max_rem of 1,
    2, 3, 4095 and 4096, and short last lanes) under a table with 15-bit
    codes, one whose codes have at most 8 bits, and a one-symbol table."""
    import torch

    buf, pos, lut, max_rem, _n, _stype = huff
    n_data = buf.numel() - 16 - ((15 * max_rem + 7) >> 3)  # the glue's pad
    err = 0.0
    # the plain version decodes each lane alone from its start (one column of
    # its (max_rem, lanes) result a lane), so its result for every lane in
    # order and for one lane at the stream's end gives each set of starts'
    # expected columns
    every = ref.huffman_decode_lanes(buf, pos, lut, max_rem)
    at_end = ref.huffman_decode_lanes(buf, torch.full_like(pos[:1], 8 * n_data), lut, max_rem)
    for k in HUFF_LANE_COUNTS:
        lanes = torch.arange(k, device=pos.device)
        starts = {"in order": lanes, "reversed": lanes.flip(0),
                  "equal": torch.zeros_like(lanes)}
        for order in starts.values():
            err = max(err, max_abs_err([ops.huffman_decode(buf, pos[order], lut, max_rem)],
                                       [every[:, order]]))
        err = max(err, max_abs_err(
            [ops.huffman_decode(buf, torch.full_like(pos[:k], 8 * n_data), lut, max_rem)],
            [at_end.expand(-1, k)]))
    rng = np.random.default_rng(seed + 15)
    tables = {  # counts 1, 1, 2, 4, ..., 2^14 give codes of 15 bits down to 1
        "15-bit codes": rng.permutation(np.repeat(np.arange(16, dtype=np.uint8),
                                                  [1] + [1 << i for i in range(15)])),
        "codes of at most 8 bits": rng.integers(0, 16, 1 << 16, dtype=np.uint8),
        "one symbol": np.full(1 << 16, 42, np.uint8),
    }
    logs = {}
    plan = rt.pipeline("huffman")
    for name, data in tables.items():
        for n in HUFF_LENGTHS + (data.size,):  # the LUT's period is read at the last
            raw = np.resize(data, n).tobytes()
            frame = rt.compress(plan, rt.serial(raw), device="cuda")
            hb, hp, hl, hm, _n, _st = entropy.huffman_lanes(*node_streams(frame, "huffman"))
            logs[name] = ops.huffman_lut_log(hl)
            q = torch.cat([hp, hp.flip(0)])  # every lane twice, the second time in reverse
            err = max(err, max_abs_err([ops.huffman_decode(hb, q, hl, hm)],
                                       [ref.huffman_decode_lanes(hb, q, hl, hm)]))
            (back,) = rt.decompress(frame, device="cuda")
            if back.content_bytes() != raw:
                fail(f"huffman_decode sweep: {name}, {n} symbols did not decode on the card")
    if logs["15-bit codes"] != 15 or logs["codes of at most 8 bits"] > 8:
        fail(f"huffman_decode sweep: the tables' LUT periods are {logs}")
    print(f"check huffman_decode: column A's lanes x {HUFF_LANE_COUNTS} (in order, reversed,"
          f" equal, at the stream's end); streams of {HUFF_LENGTHS} symbols under tables with"
          f" 15-bit codes, codes of at most 8 bits and one symbol (LUT logs {logs}):"
          f" max_abs_err={err}")
    return err


def fse_decode_sweep(ops, ref, entropy, seed) -> float:
    """K10 against ``ref.fse_decode_lanes`` on 1000 lanes that the port's K9
    encodes on the card, at each table_log of ``FSE_DECODE_TABLE_LOGS``: lanes
    of 1 symbol (no bits) and 2, a last lane of 517, the rest full; then on
    the same lanes repeated to more than 128 lanes per SM, so that K10 runs
    its 256-lane blocks as well as its 128-lane ones at each table_log."""
    import torch

    dev = "cuda"
    copies = 128 * torch.cuda.get_device_properties(0).multi_processor_count // 1000 + 1
    i32 = lambda a: torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)  # noqa: E731
    rng = np.random.default_rng(seed + 10)
    rem = torch.full((1000,), 1024, dtype=torch.int32, device=dev)
    rem[0], rem[1], rem[-1] = 1, 2, 517
    err = 0.0
    empty = 0
    for table_log in FSE_DECODE_TABLE_LOGS:
        alphabet = min(200, 1 << (table_log - 1))
        lanes = torch.from_numpy((rng.zipf(1.25, (1000, 1024)) % alphabet).astype(np.uint8))
        lanes[torch.arange(1024)[None, :] >= rem.cpu()[:, None]] = 0
        counts = np.bincount(lanes.numpy().reshape(-1), minlength=256).astype(np.int64)
        norm = entropy._normalize_counts(counts, table_log)
        ds, dn, db, enc, nb0, thr, st0 = entropy._fse_tables_cached(norm, table_log)
        sym_start, compact = ref.compact_encode_table(i32(norm), i32(enc.reshape(-1)),
                                                      enc.shape[1])
        vals, nbs, state = ops.fse_encode(
            ops.byteshuffle(lanes.to(dev)), rem, i32(nb0), i32(thr), i32(st0), i32(norm),
            sym_start, compact, enc.shape[1], 1 << table_log)
        goffs, bitlen, byte_off = ref.fse_lane_offsets(nbs)
        stream = ref.pack_bits(vals, goffs, int(byte_off[-1]))[: int(byte_off[-1])]
        sym, nbb = ref.pack_fse_table(*(torch.from_numpy(a.copy()).to(dev) for a in (ds, dn, db)))
        args = (torch.cat([stream, stream.new_zeros(8)]),
                ref.exclusive_offsets((bitlen + 7) >> 3)[:-1], bitlen, state, sym, nbb, 1024)
        got = ops.fse_decode(*args)
        err = max(err, max_abs_err([got], [ref.fse_decode_lanes(*args)]))
        many = (args[0], *(a.repeat(copies) for a in args[1:4]), *args[4:])
        err = max(err, max_abs_err([ops.fse_decode(*many)], [ref.fse_decode_lanes(*many)]))
        back = ops.byteunshuffle(got).cpu()
        if not all(torch.equal(back[k, :r], lanes[k, :r]) for k, r in enumerate(rem.tolist())):
            fail(f"fse_decode sweep: table_log {table_log} did not return the lanes")
        empty += int((bitlen == 0).sum())
    if not empty:
        fail("fse_decode sweep: no lane of bitlen 0")
    print(f"check fse_decode: 1000 lanes (of 1 symbol and no bits, 2, a last one of 517, the"
          f" rest full), and {copies} times over, x table_log {FSE_DECODE_TABLE_LOGS}:"
          f" max_abs_err={err}")
    return err


def unshuffle_sweep(ops, ref, seed) -> float:
    """K4 at every width of ``UNSHUFFLE_WIDTHS`` and size of ``UNSHUFFLE_SIZES``,
    on planes that start at their allocation, 1 byte into it and 16 bytes
    into it: the narrow, wide and byte-wise paths, each against
    ``ref.byteunshuffle``."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    err = 0.0
    for w in UNSHUFFLE_WIDTHS:
        for n in UNSHUFFLE_SIZES:
            buf = torch.randint(0, 256, (w * n + 16,), dtype=torch.uint8, device="cuda",
                                generator=gen)
            for offset in (0, 1, 16):
                p = buf[offset: offset + w * n].view(w, n)
                err = max(err, max_abs_err([ops.byteunshuffle(p)], [ref.byteunshuffle(p)]))
    print(f"check byteunshuffle: w {UNSHUFFLE_WIDTHS} x n {UNSHUFFLE_SIZES} x plane offsets"
          f" (0, 1, 16): max_abs_err={err}")
    return err


def delta_decode_sweep(ops, ref, seed) -> float:
    """K2 at widths 1, 2, 4 and 8, at ``RAGGED_SIZES`` and around its tile
    (one less, equal, one more, twice plus one), from every element offset
    of a tensor below 16 bytes (``d[0:]`` to ``d[15:]`` for uint8, ``d[0:]``
    and ``d[1:]`` for int64), so that the shifted loads run at every byte
    offset, on values drawn over the whole width so that the sums
    wrap; then 2^26 and 2^28 uint8 deltas, both ways, and decoded
    ``CONTENTION_RUNS`` times back to back on one stream, every result equal:
    each against ``ref.delta_decode``."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    err = 0.0

    def deltas(n, width):  # uniform over the width's every bit pattern
        hi = torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int64, device="cuda",
                           generator=gen)
        x = (hi << 32) | torch.randint(0, 1 << 32, (n,), dtype=torch.int64, device="cuda",
                                       generator=gen)
        if width == 8:
            return x
        if width == 1:
            return (x & 255).to(torch.uint8)
        half = 1 << (8 * width - 1)
        return ((x & (2 * half - 1)) - half).to(torch.int16 if width == 2 else torch.int32)

    tiles = {}
    for width in (1, 2, 4, 8):
        t = tiles[width] = ops.delta_decode_tile(width)
        offsets = 16 // width
        for n in RAGGED_SIZES + (t - 1, t, t + 1, 2 * t + 1):
            full = deltas(n + offsets, width)
            for o in range(offsets):
                d = full[o: o + n]
                err = max(err, max_abs_err([ops.delta_decode(d)], [ref.delta_decode(d)]))
    for log_n in CONTENTION_LOG_SIZES:
        full = deltas((1 << log_n) + 1, 1)
        big = full[:-1]
        err = max(err, max_abs_err([ops.delta_decode(full[1:])], [ref.delta_decode(full[1:])]))
        err = max(err, back_to_back("delta_decode", lambda: ops.delta_decode(big),
                                    ref.delta_decode(big), f"2^{log_n} uint8 deltas"))
        del full, big
    print(f"check delta_decode: widths (1, 2, 4, 8) x n {RAGGED_SIZES} and each width's tile"
          f" {json.dumps(tiles)} -1, +0, +1, 2x+1, from byte offsets 0-15; uint8 deltas of"
          + "".join(f" 2^{k} ({(1 << k) // tiles[1]} tiles)" for k in CONTENTION_LOG_SIZES)
          + f" both ways and {CONTENTION_RUNS} times back to back, all equal:"
          f" max_abs_err={err}")
    return err


def histogram_sweep(ops, ref, seed) -> float:
    """K13 against ``ref.histogram_exact``: every size of ``HIST_SMALL_SIZES``
    from byte offsets 0-15 of a view (the unaligned head and tail, the
    one-block trial grid, and the large configuration at one block, several
    and every block the card holds); single-value streams of the last three
    sizes in bins 0 and 255; and a single-value stream of ``HIST_HUGE``
    bytes, one bin above 2^32, from byte 1 of its buffer.  (The grid keeps a
    block's counts under 2^32, so on an 80 GB card no counter comes near
    its cap: that takes 2^32 bytes a block, past 500 GB at one block an SM.)"""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    buf = torch.randint(0, 256, (HIST_SMALL_SIZES[-1] + 16,), dtype=torch.uint8, device="cuda",
                        generator=gen)
    err = 0.0
    for n in HIST_SMALL_SIZES:
        for offset in range(16):
            x = buf[offset: offset + n]
            err = max(err, max_abs_err([ops.histogram(x)], [ref.histogram_exact(x)]))
    for value in (0, 255):
        buf.fill_(value)
        for n in HIST_SMALL_SIZES[-3:]:
            x = buf[1: 1 + n]
            err = max(err, max_abs_err([ops.histogram(x)], [ref.histogram_exact(x)]))
    del buf, x
    huge = torch.full((HIST_HUGE + 1,), 200, dtype=torch.uint8, device="cuda")[1:]
    got = ops.histogram(huge)
    err = max(err, max_abs_err([got], [chunked_histogram(ref, huge)]))
    if int(got[200]) != HIST_HUGE:
        fail(f"histogram: bin 200 of {HIST_HUGE} equal bytes counts {int(got[200])}")
    del huge
    print(f"check histogram: n 0-64 and {HIST_SMALL_SIZES[65:]} x byte offsets 0-15; single"
          f" values (bins 0, 255) at {HIST_SMALL_SIZES[-3:]}; {HIST_HUGE} equal bytes from"
          f" byte 1: max_abs_err={err}")
    return err


def chunked_histogram(ref, x):
    """``ref.histogram_exact`` of x, summed over pieces of 2^30 bytes."""
    return sum(ref.histogram_exact(x[i: i + (1 << 30)]) for i in range(0, x.numel(), 1 << 30))


def fdb_decode_sweep(ops, ref, seed) -> float:
    """K12 against ``ref.fused_delta_bitpack_decode`` at every bits of
    ``ref.PACK_BITS`` and width 1, 2 and 4, at n around the tile
    (``ops.fused_delta_bitpack_decode_tile``: one word's values and one value
    on either side of one and two tiles, and inside the first tile at its
    quarters, where the runs of a tile's sub-tiles meet), from words 0-3 words into their
    buffer, on random words, so the sums wrap; then ``CONTENTION_RUNS`` runs
    back to back at 2^26 and 2^28 values (8 bits to uint8), every result
    equal."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    err = 0.0
    tiles = {}
    for width in (1, 2, 4):
        for bits in ref.PACK_BITS:
            per = 32 // bits
            t = tiles[f"{bits}->{width}"] = ops.fused_delta_bitpack_decode_tile(width, bits)
            for n in (1, per, t // 4 - 1, t // 2 + 1, 3 * t // 4 + per, t - per, t - 1, t,
                      t + 1, t + per, 2 * t - 1, 2 * t + per + 1):
                m = -(-n // per)
                buf = torch.randint(-(1 << 31), 1 << 31, (m + 3,), dtype=torch.int64,
                                    device="cuda", generator=gen).to(torch.int32)
                for offset in range(4):
                    w = buf[offset: offset + m]
                    err = max(err, max_abs_err(
                        [ops.fused_delta_bitpack_decode(w, bits, n, width)],
                        [ref.fused_delta_bitpack_decode(w, bits, n, width)]))
    for log_n in CONTENTION_LOG_SIZES:
        n = 1 << log_n
        w = torch.randint(-(1 << 31), 1 << 31, (n // 4,), dtype=torch.int64, device="cuda",
                          generator=gen).to(torch.int32)
        err = max(err, back_to_back("fused_delta_bitpack_decode",
                                    lambda: ops.fused_delta_bitpack_decode(w, 8, n, 1),
                                    ref.fused_delta_bitpack_decode(w, 8, n, 1),
                                    f"2^{log_n} values at 8 bits"))
        del w
    print(f"check fused_delta_bitpack_decode: bits {ref.PACK_BITS} x widths (1, 2, 4) around"
          f" the tiles {json.dumps(tiles)}, from words 0-3 words in; {CONTENTION_RUNS} runs"
          f" back to back at 2^{CONTENTION_LOG_SIZES[0]} and 2^{CONTENTION_LOG_SIZES[1]}"
          f" values: max_abs_err={err}")
    return err


def bitpack_rows(cols, ops, ref, seed, row) -> None:
    """K5, K6, K11 and K12: every bits and stream width on small ragged
    sizes, then timed at the main path's shapes (G at 4 bits and B's deltas
    at 32 bits through K5 and K6, F at 8 bits through K11 and K12)."""
    import torch

    dev = "cuda"
    rng = np.random.default_rng(seed)
    carriers = {1: np.uint8, 2: np.int16, 4: np.int32}
    unsigned = {1: np.uint8, 2: np.uint16, 4: np.uint32}
    errs = {"bitpack": 0.0, "bitunpack": 0.0, "fused_delta_bitpack": 0.0,
            "fused_delta_bitpack_decode": 0.0}
    for width, carrier in carriers.items():
        for bits in ref.PACK_BITS:
            for n in RAGGED_SIZES:
                # values below 2^bits, read unsigned at the stream's width;
                # x[1:] also starts off the allocation's alignment
                full = rng.integers(0, 1 << min(bits, 8 * width), n + 1, dtype=np.uint64)
                x = torch.from_numpy(full.astype(unsigned[width]).view(carrier)).to(dev)
                for v in (x[:n], x[1:]):
                    words = ops.bitpack(v, bits)
                    errs["bitpack"] = max(errs["bitpack"],
                                          max_abs_err([words], [ref.bitpack(v, bits)]))
                    fused = ops.fused_delta_bitpack(v, bits)
                    errs["fused_delta_bitpack"] = max(
                        errs["fused_delta_bitpack"],
                        max_abs_err([fused], [ref.fused_delta_bitpack(v, bits)]))
                    for out_width in carriers:
                        errs["bitunpack"] = max(errs["bitunpack"], max_abs_err(
                            [ops.bitunpack(words, bits, n, out_width)],
                            [ref.bitunpack(words, bits, n, out_width)]))
                        errs["fused_delta_bitpack_decode"] = max(
                            errs["fused_delta_bitpack_decode"], max_abs_err(
                                [ops.fused_delta_bitpack_decode(fused, bits, n, out_width)],
                                [ref.fused_delta_bitpack_decode(fused, bits, n, out_width)]))
                    errs["bitunpack"] = max(errs["bitunpack"], max_abs_err(
                        [ops.bitunpack(words, bits, n, width)], [v]))
                # K6 from words 1, 2 and 3 words into their allocation (a
                # payload view into a frame), at every output width
                buf = torch.zeros(words.numel() + 3, dtype=torch.int32, device=dev)
                for offset in (1, 2, 3):
                    view = buf[offset: offset + words.numel()]
                    view.copy_(words)
                    for out_width in carriers:
                        errs["bitunpack"] = max(errs["bitunpack"], max_abs_err(
                            [ops.bitunpack(view, bits, n, out_width)],
                            [ref.bitunpack(view, bits, n, out_width)]))
    errs["fused_delta_bitpack_decode"] = max(errs["fused_delta_bitpack_decode"],
                                             fdb_decode_sweep(ops, ref, seed))
    print(f"check bit packing: bits {ref.PACK_BITS} x widths (1, 2, 4) x n {RAGGED_SIZES},"
          f" aligned and offset, bitunpack also from words 1-3 words in: {json.dumps(errs)}")

    col_g = torch.from_numpy(cols["G_int4_codes_u8"]).to(dev)
    col_b = torch.from_numpy(cols["B_zipf_ids_u32"].view(np.int32)).to(dev)
    col_f = torch.from_numpy(cols["F_string_offsets_u32"].view(np.int32)).to(dev)
    d_b = ops.delta_encode(col_b)
    n_g, n_b, n_f = col_g.numel(), d_b.numel(), col_f.numel()
    g_words, b_words = ops.bitpack(col_g, 4), ops.bitpack(d_b, 32)
    f_words = ops.fused_delta_bitpack(col_f, 8)
    g_bytes = n_g + n_g // 2
    b_bytes = 2 * 4 * n_b
    f_bytes = 4 * n_f + n_f
    err = max_abs_err([g_words, b_words, ops.bitpack(d_b, 8), ops.bitpack(d_b, 16)],
                      [ref.bitpack(col_g, 4), ref.bitpack(d_b, 32), ref.bitpack(d_b, 8),
                       ref.bitpack(d_b, 16)])
    # B's deltas at 8 and 16 bits: the kernel's other input-to-output ratios
    # (values past 2^bits add into the next slots, as in the reference)
    b32_ms, b32_clone_ms = turns_ms(lambda: ops.bitpack(d_b, 32), lambda: d_b.clone(), 20)
    b_narrow = {}
    for bits in (8, 16):
        b_narrow[f"b{bits}_ms"] = cuda_ms(lambda bits=bits: ops.bitpack(d_b, bits), 20)
        b_narrow[f"b{bits}_bound_ms"] = (4 * n_b + n_b * bits // 8) / HBM_BYTES_PER_S * 1e3
    row("bitpack", "src/repro_torch/csrc/bitpack.cu", "src/repro/kernels/bitpack.py:41",
        max(err, errs["bitpack"]), cuda_ms(lambda: ops.bitpack(col_g, 4), 20),
        cuda_ms(lambda: ref.bitpack(col_g, 4), 5), g_bytes, n_g, None,
        shape=f"uint8[{n_g}] at 4 bits (column G)",
        b32_ms=b32_ms, b32_plain_ms=cuda_ms(lambda: ref.bitpack(d_b, 32), 5),
        b32_bound_ms=b_bytes / HBM_BYTES_PER_S * 1e3, b32_clone_ms=b32_clone_ms, **b_narrow)
    got = [ops.bitunpack(g_words, 4, n_g, 1), ops.bitunpack(b_words, 32, n_b, 4)]
    err = max(max_abs_err(got, [ref.bitunpack(g_words, 4, n_g, 1),
                                ref.bitunpack(b_words, 32, n_b, 4)]),
              max_abs_err(got, [col_g, d_b]))
    u32_ms, u32_clone_ms = turns_ms(lambda: ops.bitunpack(b_words, 32, n_b, 4),
                                    lambda: b_words.clone(), 20)
    row("bitunpack", "src/repro_torch/csrc/bitpack.cu", "src/repro/kernels/bitpack.py:58",
        max(err, errs["bitunpack"]), cuda_ms(lambda: ops.bitunpack(g_words, 4, n_g, 1), 20),
        cuda_ms(lambda: ref.bitunpack(g_words, 4, n_g, 1), 5), g_bytes, n_g, None,
        shape=f"int32[{g_words.numel()}] at 4 bits -> uint8 (column G)",
        b32_ms=u32_ms, b32_plain_ms=cuda_ms(lambda: ref.bitunpack(b_words, 32, n_b, 4), 5),
        b32_bound_ms=b_bytes / HBM_BYTES_PER_S * 1e3, b32_clone_ms=u32_clone_ms)
    err = max_abs_err([f_words], [ref.fused_delta_bitpack(col_f, 8)])
    row("fused_delta_bitpack", "src/repro_torch/csrc/fused_delta_bitpack.cu",
        "src/repro/kernels/fused_delta_bitpack.py:45",
        max(err, errs["fused_delta_bitpack"]),
        cuda_ms(lambda: ops.fused_delta_bitpack(col_f, 8), 20),
        cuda_ms(lambda: ref.fused_delta_bitpack(col_f, 8), 5), f_bytes, 2 * n_f, None,
        shape=f"uint32[{n_f}] at 8 bits (column F)")
    back = ops.fused_delta_bitpack_decode(f_words, 8, n_f, 4)
    err = max(max_abs_err([back], [ref.fused_delta_bitpack_decode(f_words, 8, n_f, 4)]),
              max_abs_err([back], [col_f]))
    row("fused_delta_bitpack_decode", "src/repro_torch/csrc/fused_delta_bitpack.cu",
        "src/repro/kernels/fused_delta_bitpack.py:93",
        max(err, errs["fused_delta_bitpack_decode"]),
        cuda_ms(lambda: ops.fused_delta_bitpack_decode(f_words, 8, n_f, 4), 20),
        cuda_ms(lambda: ref.fused_delta_bitpack_decode(f_words, 8, n_f, 4), 5),
        f_bytes, 2 * n_f, None,
        shape=f"int32[{f_words.numel()}] at 8 bits -> uint32 (column F)",
        tile_values=ops.fused_delta_bitpack_decode_tile(4, 8))


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def node_streams(frame: bytes, codec: str):
    """The stored output streams (on the card) and the header of a frame's
    node of ``codec``."""
    from repro_torch.core.codec import get_codec_by_id
    from repro_torch.core.wire import read_frame

    _version, n_inputs, nodes, stored = read_frame(frame, "cuda")
    first = n_inputs
    for node in nodes:
        if get_codec_by_id(node.codec_id).name == codec:
            return [stored[e] for e in range(first, first + node.n_out)], node.header
        first += node.n_out
    fail(f"the frame has no {codec} node")


def column_plans(cols):
    return [(cname, pname) for cname in cols for pname in COLUMN_PLANS[cname]]


def main_path(cols, rt, ops):
    """Each column through its plans via the port's entry points."""
    import torch

    plans = {name: make(rt) for name, make in PLANS.items()}
    # warm the allocator, the kernels and PyTorch's lazily loaded modules on
    # small prefixes, outside the counted and timed run
    for cname, pname in column_plans(cols):
        col = cols[cname]
        rt.compress(plans[pname], stream_of(rt, cname, col[: (1 << 16) // col.itemsize]),
                    device="cuda")
    frames = {}
    ops.reset_launches()
    for cname, pname in column_plans(cols):
        col, plan = cols[cname], plans[pname]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = rt.compress(plan, stream_of(rt, cname, col), device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        frames[cname, pname] = frame
        codecs = frame_codecs(rt, frame)
        if FRAME_CODECS.get((cname, pname), codecs) != codecs:
            fail(f"{cname} {pname}: the frame records {codecs},"
                 f" not {FRAME_CODECS[cname, pname]}")
        print(f"main {cname} {pname} [{codecs}]:"
              f" ratio={col.nbytes / len(frame)}"
              f" compress_MBps={col.nbytes / dt / 1e6} seconds={dt}")
    launches = ops.launch_counts()
    print(f"main launches {json.dumps(launches)}")
    missing = [k for k in ENCODE_KERNELS if launches[k] == 0]
    if missing:
        fail(f"the main path never launched {missing}")
    for (cname, pname), frame in frames.items():
        col = cols[cname]
        (out,) = rt.decompress(frame, device="cuda")
        if out.content_bytes() != col.tobytes():
            fail(f"{cname} {pname}: decompress did not return the column")
        prefix = col[: PREFIX_BYTES // col.itemsize]
        on_card = card_frame(rt, plans[pname], stream_of(rt, cname, prefix))
        on_cpu = cpu_frame(rt, plans[pname], stream_of(rt, cname, prefix))
        if on_card != on_cpu:
            fail(f"{cname} {pname}: the card's 4 MiB frame differs from the CPU's")
        print(f"check {cname} {pname}: roundtrip ok, 4 MiB card frame == cpu frame"
              f" ({len(on_card)} bytes)")
    return launches, frames


def decode_phase(cols, frames, rt, ops):
    """Every frame of the main path through the card's universal decoder."""
    import torch

    # warm the decoders, their table caches and the kernels on small frames,
    # outside the counted and timed run
    for (cname, pname), _ in frames.items():
        prefix = cols[cname][: (1 << 16) // cols[cname].itemsize]
        frame = rt.compress(PLANS[pname](rt), stream_of(rt, cname, prefix), device="cuda")
        rt.decompress(frame, device="cuda")
    torch.cuda.synchronize()
    ops.reset_launches()
    results = []
    for (cname, pname), frame in frames.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (out,) = rt.decompress(frame, device="cuda")
        torch.cuda.synchronize()
        results.append((cname, pname, out, time.perf_counter() - t0))
    launches = ops.launch_counts()
    print(f"decode launches {json.dumps(launches)}")
    for cname, pname, out, dt in results:
        col = cols[cname]
        want = rt.numeric(col).data.to("cuda")
        if out.data.device.type != "cuda" or not torch.equal(out.data, want):
            fail(f"{cname} {pname}: decompress on the card did not return the column")
        print(f"decode {cname} {pname}: decompress_MBps={col.nbytes / dt / 1e6} seconds={dt}"
              f" output on {out.data.device}, equal to the column on the card")
    missing = [k for k in DECODE_KERNELS if launches[k] == 0]
    if missing:
        fail(f"the decode path never launched {missing}")
    return launches


def container_stream(rt, kind: str, col: np.ndarray):
    """The column as the container phase hands it over: a NUMERIC column, its
    bytes as STRUCT(8) records, or its bytes as a SERIAL stream (a raw file)."""
    if kind == "numeric":
        return rt.numeric(col)
    if kind == "struct8":
        return rt.struct(col.view(np.uint8), 8)
    return rt.serial(col.view(np.uint8))


def chunk_offset(frame: bytes, index: int) -> int:
    """The byte offset of chunk ``index``'s frame inside a container."""
    from repro_torch.core import wire

    _n_chunks, pos = wire.read_varint(frame, 5)
    for _ in range(index):
        flen, pos = wire.read_varint(frame, pos)
        pos += flen
    return wire.read_varint(frame, pos)[1]


def container_phase(cols, rt, ops):
    """Chunked compression into ``OZLC`` containers on the card, as the
    reference CLI's ``compress`` does by default (``CONTAINER_CALLS``): each
    call through ``compress(..., chunk_bytes=N)`` and back through
    ``decompress``, with the launch counts reset just before and read just
    after each half.  Returns the calls (for the profile phase) and each
    kernel's launches summed over them."""
    import torch
    from repro_torch.core import engine, wire

    calls, totals = [], {k: 0 for k in ops.KERNELS}
    t_phase = time.perf_counter()
    for label, cname, kind, pname, rem in CONTAINER_CALLS:
        col = cols[cname]
        plan = PLANS[pname](rt)
        stream = container_stream(rt, kind, col)
        # the 4 MiB prefix at 1 MiB + rem (chunks at the same offsets mod 16):
        # the card's container is the CPU's, with as many fresh re-resolves;
        # this also warms the kernels and the allocator outside the counts
        prefix = container_stream(rt, kind, col[: PREFIX_BYTES // col.itemsize])
        small = {}
        for where, dev in (("card", "cuda"), ("cpu", "cpu")):
            rt.resolve_cache_clear()  # each side resolves (and runs its trials) afresh
            before = engine.fresh_resolves
            frame = rt.compress(plan, prefix, device=dev, chunk_bytes=PREFIX_CHUNK_BYTES + rem)
            small[where] = frame, engine.fresh_resolves - before
        if small["card"][0] != small["cpu"][0]:
            fail(f"container {label}: the card's 4 MiB container differs from the CPU's")
        if small["card"][1] != small["cpu"][1]:
            fail(f"container {label}: {small['card'][1]} fresh re-resolves on the card's"
                 f" prefix, {small['cpu'][1]} on the CPU's")

        chunk_bytes = CHUNK_BYTES + rem
        torch.cuda.synchronize()
        ops.reset_launches()
        before = engine.fresh_resolves
        t0 = time.perf_counter()
        frame = rt.compress(plan, stream, device="cuda", chunk_bytes=chunk_bytes)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        encode = ops.launch_counts()
        reresolves = engine.fresh_resolves - before
        ops.reset_launches()
        t0 = time.perf_counter()
        (out,) = rt.decompress(frame, device="cuda")
        torch.cuda.synchronize()
        ddt = time.perf_counter() - t0
        decode = ops.launch_counts()
        for k in totals:
            totals[k] += encode[k] + decode[k]

        elt = {"numeric": col.itemsize, "struct8": 8, "serial": 1}[kind]
        per = chunk_bytes // elt  # elements a chunk
        want_chunks = -(-(col.nbytes // elt) // per)
        if bytes(frame[:4]) != wire.CONTAINER_MAGIC:
            fail(f"container {label}: the frame starts with {bytes(frame[:4])}, not OZLC")
        _version, chunks = wire.read_container(frame)
        if len(chunks) != want_chunks:
            fail(f"container {label}: {len(chunks)} chunks, not {want_chunks}")
        want = stream.data.to("cuda")
        if (out.data.device.type != "cuda" or (out.stype, out.width) != (stream.stype, stream.width)
                or not torch.equal(out.data, want)):
            fail(f"container {label}: decompress on the card did not return the column")
        codecs = frame_codecs(rt, chunks[0])
        named = codecs.split("+")
        missing = ([k for c in named for k in ENCODE_KERNELS_OF.get(c, ()) if encode[k] == 0]
                   + [k for c in named for k in DECODE_KERNELS_OF.get(c, ()) if decode[k] == 0])
        if missing:
            fail(f"container {label} [{codecs}]: never launched {missing}")
        starts = sorted({i * per * elt % 16 for i in range(want_chunks)})
        print(f"container {label} {pname} chunk_bytes={chunk_bytes} [{codecs}]:"
              f" chunks={len(chunks)} chunk_starts_mod_16={starts}"
              f" fresh_resolves={reresolves} ratio={col.nbytes / len(frame)}"
              f" compress_MBps={col.nbytes / dt / 1e6} seconds={dt}"
              f" decompress_MBps={col.nbytes / ddt / 1e6} decompress_seconds={ddt}"
              f" prefix_fresh_resolves={small['card'][1]}")
        print(f"container {label} launches: compress {json.dumps(encode)}"
              f" decompress {json.dumps(decode)}")
        print(f"check container {label}: OZLC, {len(chunks)} chunks, roundtrip on the card ok,"
              f" 4 MiB card container == cpu container ({len(small['card'][0])} bytes),"
              f" first chunk's kernels launched")
        calls.append((label, pname, plan, stream, chunk_bytes, frame, codecs))

        if label == "A":  # the same column unchunked, in the same run
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            whole = rt.compress(plan, stream, device="cuda")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            t0 = time.perf_counter()
            (back,) = rt.decompress(whole, device="cuda")
            torch.cuda.synchronize()
            ddt = time.perf_counter() - t0
            if not torch.equal(back.data, want):
                fail("container A unchunked: decompress on the card did not return the column")
            print(f"container A {pname} unchunked [{frame_codecs(rt, whole)}]:"
                  f" ratio={col.nbytes / len(whole)}"
                  f" compress_MBps={col.nbytes / dt / 1e6} seconds={dt}"
                  f" decompress_MBps={col.nbytes / ddt / 1e6} decompress_seconds={ddt}")
            calls.append(("A_unchunked", pname, plan, stream, None, whole,
                          frame_codecs(rt, whole)))

            # one payload byte of the third chunk flipped: the container's
            # CRC fails before any chunk decodes, so no kernel launches
            bad = bytearray(frame)
            bad[chunk_offset(frame, 2) + len(chunks[2]) // 2] ^= 0x01
            ops.reset_launches()
            try:
                rt.decompress(bytes(bad), device="cuda")
            except wire.FrameError as err:
                launched = {k: v for k, v in ops.launch_counts().items() if v}
                if launched:
                    fail(f"container A corrupted: launched {launched} before failing")
                print(f"check container A, third chunk's payload byte flipped: FrameError"
                      f" ({err}) on the card, no kernel launched, no stream")
            else:
                fail("container A corrupted: decompress on the card returned a stream")
    print(f"container phase seconds={time.perf_counter() - t_phase}")
    return calls, totals


def record_plan(rt, pname: str):
    """The records phase's plans: the paper's §IV SAO graph, the generic record
    path over the SAO fields, the generic profile, and T's dictionary plan
    (``tokenize``, then ``generic_auto`` on the alphabet and ``numeric_auto``
    on the u32 indices)."""
    if pname == "sao_profile":
        return rt.sao_profile()
    if pname == "struct_profile":
        return rt.struct_profile(list(SAO_WIDTHS))
    if pname == "generic_profile":
        return rt.generic_profile()
    g = rt.GraphBuilder(1)
    alpha, idx = g.add("tokenize", g.input(0))
    g.select("generic_auto", alpha)
    g.select("numeric_auto", idx)
    return g.build("string_dict")


def string_stream(rt, content: np.ndarray, lengths: np.ndarray):
    import torch

    return rt.Stream(torch.from_numpy(content), rt.SType.STRING, 1, lengths).validate()


def string_prefix(rt, content: np.ndarray, lengths: np.ndarray, nbytes: int):
    """T's first strings whose bytes total at most ``nbytes``."""
    keep = int(np.searchsorted(np.cumsum(lengths, dtype=np.int64), nbytes, side="right"))
    return string_stream(rt, content[: int(lengths[:keep].sum())], lengths[:keep])


def same_stream(out, want) -> bool:
    """``out`` lies on the card and equals ``want`` (compared on the card)."""
    import torch

    if out.data.device.type != "cuda" or (out.stype, out.width) != (want.stype, want.width):
        return False
    if want.lengths is not None and not np.array_equal(out.lengths, want.lengths):
        return False
    return torch.equal(out.data, want.data.to("cuda"))


def first_codecs(rt, frame: bytes) -> str:
    """The codecs a frame records, or a container's first chunk."""
    from repro_torch.core import wire

    return frame_codecs(rt, wire.read_container(frame)[1][0] if wire.is_container(frame)
                        else frame)


def records_data(rt, seed: int):
    """S, R and T (their streams on the host) and their prefixes."""
    t0 = time.perf_counter()
    sao = make_sao(SAO_RECORDS, seed)
    recs = np.frombuffer(make_sao(R_RECORDS, seed + 1), np.uint8)[SAO_HEADER_BYTES:]
    content, lengths = string_column(seed, T_STRINGS)
    streams = {"S": rt.serial(sao), "R": rt.struct(recs, 28),
               "T": string_stream(rt, content, lengths)}
    prefixes = {"S": streams["S"], "R": rt.struct(recs[: PREFIX_RECORDS * 28], 28),
                "T": string_prefix(rt, content, lengths, PREFIX_BYTES)}
    print(f"records data: S {len(sao)} bytes ({SAO_RECORDS} records of 28 + a"
          f" {SAO_HEADER_BYTES}-byte header), R {recs.size} bytes ({R_RECORDS} records),"
          f" T {lengths.size} strings, {content.size} content bytes"
          f" ({content.size / 2 ** 20} MiB), {int((lengths == 0).sum())} empty,"
          f" {int(len(np.unique(lengths)))} distinct lengths;"
          f" seconds={time.perf_counter() - t0}")
    return streams, prefixes, (content, lengths)


def records_phase(rt, ops, seed: int):
    """The structural codecs, STRING streams and the record profiles on the
    card (``RECORD_CALLS``): each call through ``compress(...,
    device="cuda")`` and back through ``decompress``, with the launch counts
    reset just before and read just after each half; the prefix's frame (or
    container) equal to the CPU's; then the codec sweep and T's stored frame.
    Returns the calls (for the profile phase) and each kernel's launches
    summed over them."""
    import torch
    from repro_torch.core import wire

    streams, prefixes, (_content, lengths) = records_data(rt, seed)
    calls, totals = [], {k: 0 for k in ops.KERNELS}
    t_phase = time.perf_counter()
    for label, src, pname, chunk_bytes in RECORD_CALLS:
        plan, stream, prefix = record_plan(rt, pname), streams[src], prefixes[src]
        # the prefix on the card and on the CPU (chunked at 1 MiB where the call
        # is chunked); this also warms the kernels and the allocator
        small = PREFIX_CHUNK_BYTES if chunk_bytes else None
        on_card = card_frame(rt, plan, prefix, chunk_bytes=small)
        if on_card != cpu_frame(rt, plan, prefix, chunk_bytes=small):
            fail(f"records {label}: the card's prefix frame differs from the CPU's")
        (back,) = rt.decompress(on_card, device="cuda")
        if not same_stream(back, prefix):
            fail(f"records {label}: the prefix frame did not decode on the card")

        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        frame = rt.compress(plan, stream, device="cuda", chunk_bytes=chunk_bytes)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        encode = ops.launch_counts()
        ops.reset_launches()
        t0 = time.perf_counter()
        (out,) = rt.decompress(frame, device="cuda")
        torch.cuda.synchronize()
        ddt = time.perf_counter() - t0
        decode = ops.launch_counts()
        for k in totals:
            totals[k] += encode[k] + decode[k]
        if not same_stream(out, stream):
            fail(f"records {label}: decompress on the card did not return the input")
        codecs = first_codecs(rt, frame)
        named = codecs.split("+")
        missing = ([k for c in named for k in ENCODE_KERNELS_OF.get(c, ()) if encode[k] == 0]
                   + [k for c in named for k in DECODE_KERNELS_OF.get(c, ()) if decode[k] == 0])
        if label == "S":
            missing += ([k for k in SAO_ENCODE_KERNELS if encode[k] == 0]
                        + [k for k in SAO_DECODE_KERNELS if decode[k] == 0])
        if missing:
            fail(f"records {label} [{codecs}]: never launched {sorted(set(missing))}")
        nbytes = stream.nbytes  # T: its content and 4 bytes a length
        chunks = f" chunks={len(wire.read_container(frame)[1])}" if chunk_bytes else ""
        print(f"records {label} {pname} chunk_bytes={chunk_bytes} [{codecs}]:{chunks}"
              f" bytes={nbytes} frame_bytes={len(frame)} ratio={nbytes / len(frame)}"
              f" compress_MBps={nbytes / dt / 1e6} seconds={dt}"
              f" decompress_MBps={nbytes / ddt / 1e6} decompress_seconds={ddt}")
        print(f"records {label} launches: compress {json.dumps(encode)}"
              f" decompress {json.dumps(decode)}")
        print(f"check records {label}: decoded on the card (output on {out.data.device}),"
              f" equal to the input; prefix card frame == cpu frame ({len(on_card)} bytes,"
              f" {prefix.nbytes} input bytes); the kernels of its codecs launched")
        calls.append((label, pname, plan, stream, chunk_bytes, frame, codecs))
    print(f"records launches {json.dumps(totals)}")
    codec_sweep(rt, streams, prefixes)
    store_strings(rt, streams["T"], lengths)
    print(f"records phase seconds={time.perf_counter() - t_phase}")
    return calls, totals


def codec_sweep(rt, streams, prefixes) -> None:
    """Each structural codec alone (its outputs stored) on the card, on a
    prefix of S, R or T: the frame equals the CPU's and decodes on the card."""
    import torch

    r_raw = prefixes["R"].data.numpy()
    n = PREFIX_RECORDS
    is_field = r_raw.reshape(n, 28)[:, 16:18].copy().view(np.uint16).reshape(-1)
    inputs = {
        "S": streams["S"], "R": prefixes["R"], "T": prefixes["T"],
        # R's first record, repeated: an all-equal column
        "R_constant": rt.struct(np.tile(r_raw[:28], n), 28),
        # R's IS field sorted: 64 runs
        "R_IS_sorted": rt.numeric(np.sort(is_field, kind="stable")),
        "R_SRA0": rt.numeric(r_raw.reshape(n, 28)[:, :8].copy().view(np.uint64).reshape(-1)),
    }
    sweep = (("dup", "S", {}), ("constant", "R_constant", {}),
             ("split_n", "S", {"sizes": [SAO_HEADER_BYTES, -1]}), ("concat", "R", None),
             ("field_split", "R", {"widths": list(SAO_WIDTHS)}), ("string_split", "T", {}),
             ("rle", "R_IS_sorted", {}), ("transpose_split", "R_SRA0", {}),
             ("tokenize", "T", {}))
    for codec, src, params in sweep:
        g = rt.GraphBuilder(1)
        if params is None:  # concat: the halves of a split, joined again
            a, b = g.add("split_n", g.input(0), n_out=2, sizes=[n // 2, -1])
            g.add("concat", a, b)
        else:
            n_out = {"split_n": 2, "field_split": len(SAO_WIDTHS), "transpose_split": 8}.get(codec)
            g.add(codec, g.input(0), n_out=n_out, **params)
        plan, stream = g.build(f"sweep_{codec}"), inputs[src]
        rt.compress(plan, stream, device="cuda")  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = rt.compress(plan, stream, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        (out,) = rt.decompress(frame, device="cuda")
        torch.cuda.synchronize()
        ddt = time.perf_counter() - t0
        if not same_stream(out, stream):
            fail(f"sweep {codec}: decompress on the card did not return {src}")
        if frame != cpu_frame(rt, plan, stream):
            fail(f"sweep {codec}: the card's frame differs from the CPU's")
        print(f"sweep {codec} on {src} [{frame_codecs(rt, frame)}]: bytes={stream.nbytes}"
              f" frame_bytes={len(frame)} compress_MBps={stream.nbytes / dt / 1e6}"
              f" decompress_MBps={stream.nbytes / ddt / 1e6}; card frame == cpu frame,"
              f" decoded on {out.data.device}")


def store_strings(rt, stream, lengths: np.ndarray) -> None:
    """T through ``store``: the STRING lengths' trip through the wire, one
    Python varint call a string (as ``write_frame`` and ``read_frame`` did
    before) against the vectorised ``write_varints`` and
    ``read_string_lengths``, in one run."""
    import torch
    from repro_torch.core import wire

    t0 = time.perf_counter()
    loop = bytearray()
    for ln in lengths.tolist():
        wire.write_varint(loop, int(ln))
    loop_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    pos, back = 0, np.empty(lengths.size, np.uint32)
    for i in range(lengths.size):
        back[i], pos = wire.read_varint(loop, pos)
    loop_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    vec = wire.write_varints(lengths)
    vec_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    vec_back, _pos = wire.read_string_lengths(vec, 0, len(vec), lengths.size)
    vec_read = time.perf_counter() - t0
    if vec != bytes(loop) or not (np.array_equal(back, lengths)
                                  and np.array_equal(vec_back, lengths)):
        fail("store T: the vectorised varints differ from the loop's")
    plan = rt.pipeline("store")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame = rt.compress(plan, stream, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    (out,) = rt.decompress(frame, device="cuda")
    torch.cuda.synchronize()
    ddt = time.perf_counter() - t0
    if not same_stream(out, stream):
        fail("store T: decompress on the card did not return T")
    print(f"store T: {lengths.size} lengths, {len(vec)} varint bytes;"
          f" before (a Python call a string) write_seconds={loop_write}"
          f" read_seconds={loop_read}; after (numpy) write_seconds={vec_write}"
          f" read_seconds={vec_read}; store compress_seconds={dt}"
          f" decompress_seconds={ddt} frame_bytes={len(frame)}")


def csv_files(seed: int):
    """C1 and C2 (``CSV_CALLS``) as bytes, made from ``seed``."""
    t0 = time.perf_counter()
    make = {"ppmf": make_ppmf_csv, "psam": make_psam_csv}
    files = {label: make[recipe](n_rows, seed + shift)
             for label, recipe, n_rows, _n_cols, shift in CSV_CALLS}
    print("csv data: " + ", ".join(f"{label} {len(raw)} bytes ({n_rows} rows of {n_cols})"
                                   for (label, _r, n_rows, n_cols, _s), raw
                                   in zip(CSV_CALLS, files.values()))
          + f"; seconds={time.perf_counter() - t0}")
    return files


def csv_column_codecs(rt, frame: bytes) -> dict:
    """The codecs a ``csv_profile`` frame records for each column, in order:
    each node belongs to the column of its first input, and ``csv_split``'s
    k-th output starts column k."""
    from repro_torch.core import wire
    from repro_torch.core.codec import get_codec_by_id

    _version, n_inputs, nodes, _stored = wire.read_frame(frame)
    col_of, edge, cols = {}, n_inputs, {}
    for node in nodes:
        name = get_codec_by_id(node.codec_id).name
        col = None if name == "csv_split" else col_of[node.inputs[0]]
        if col is not None:
            cols.setdefault(col, []).append(name)
        for k in range(node.n_out):
            col_of[edge + k] = k if col is None else col
        edge += node.n_out
    return {c: "+".join(names) for c, names in sorted(cols.items())}


def csv_phase(rt, ops, seed: int):
    """The CSV frontend on the card (``CSV_CALLS``): each file through
    ``compress(..., device="cuda")`` and back through ``decompress``, with
    the launch counts reset just before and read just after each half; the
    frame of a prefix cut after the last newline at or before 4 MiB equal to
    the CPU's; then the edge corpus and the codecs alone.  Returns the calls
    (for the profile phase) and each kernel's launches summed over them."""
    import torch

    files = csv_files(seed)
    calls, totals = [], {k: 0 for k in ops.KERNELS}
    t_phase = time.perf_counter()
    for label, _recipe, _n_rows, n_cols, _shift in CSV_CALLS:
        raw = files[label]
        plan, stream = rt.csv_profile(n_cols), rt.serial(raw)
        prefix = rt.serial(raw[: raw.rfind(b"\n", 0, PREFIX_BYTES) + 1])
        on_card = card_frame(rt, plan, prefix)  # also warms the card
        if on_card != cpu_frame(rt, plan, prefix):
            fail(f"csv {label}: the card's prefix frame differs from the CPU's")
        (back,) = rt.decompress(on_card, device="cuda")
        if not same_stream(back, prefix):
            fail(f"csv {label}: the prefix frame did not decode on the card")

        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        frame = rt.compress(plan, stream, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        encode = ops.launch_counts()
        ops.reset_launches()
        t0 = time.perf_counter()
        (out,) = rt.decompress(frame, device="cuda")
        torch.cuda.synchronize()
        ddt = time.perf_counter() - t0
        decode = ops.launch_counts()
        for k in totals:
            totals[k] += encode[k] + decode[k]
        if not same_stream(out, stream):
            fail(f"csv {label}: decompress on the card did not return the input")
        codecs = frame_codecs(rt, frame)
        named = codecs.split("+")
        missing = ([k for c in named for k in ENCODE_KERNELS_OF.get(c, ()) if encode[k] == 0]
                   + [k for c in named for k in DECODE_KERNELS_OF.get(c, ()) if decode[k] == 0])
        if missing:
            fail(f"csv {label}: never launched {sorted(set(missing))}")
        print(f"csv {label} csv_profile({n_cols}): bytes={len(raw)} frame_bytes={len(frame)}"
              f" ratio={len(raw) / len(frame)} compress_MBps={len(raw) / dt / 1e6}"
              f" seconds={dt} decompress_MBps={len(raw) / ddt / 1e6} decompress_seconds={ddt}")
        print(f"csv {label} column codecs: {json.dumps(csv_column_codecs(rt, frame))}")
        print(f"csv {label} launches: compress {json.dumps(encode)}"
              f" decompress {json.dumps(decode)}")
        print(f"check csv {label}: decoded on the card (output on {out.data.device}), equal to"
              f" the input; prefix card frame == cpu frame ({len(on_card)} bytes,"
              f" {prefix.nbytes} input bytes); the kernels of its codecs launched")
        calls.append((label, f"csv_profile({n_cols})", plan, stream, None, frame, codecs))
    if not (sum(totals[k] for k in ENCODE_KERNELS) and sum(totals[k] for k in DECODE_KERNELS)):
        fail(f"the csv phase launched no encode or no decode kernel: {totals}")
    print(f"csv launches {json.dumps(totals)}")
    csv_edges(rt)
    csv_sweep(rt, files)
    print(f"csv phase seconds={time.perf_counter() - t_phase}")
    return calls, totals


def csv_edges(rt) -> None:
    """The edge corpus (``CSV_EDGES``) through ``csv_profile`` on the card:
    each frame equals the CPU's and decodes on the card to its file."""
    for label, raw, n_cols, sep in CSV_EDGES:
        plan, stream = rt.csv_profile(n_cols, sep), rt.serial(raw)
        frame = card_frame(rt, plan, stream)
        if frame != cpu_frame(rt, plan, stream):
            fail(f"csv edge {label}: the card's frame differs from the CPU's")
        (out,) = rt.decompress(frame, device="cuda")
        if not same_stream(out, stream):
            fail(f"csv edge {label}: decompress on the card did not return the file")
    print(f"check csv edges: {len(CSV_EDGES)} files ({', '.join(e[0] for e in CSV_EDGES)}),"
          f" each card frame == cpu frame and decoded on the card")


def csv_sweep(rt, files) -> None:
    """``csv_split`` and ``parse_numeric`` alone on the card, each way, on
    C1 and C2 at full size (the "CSV frontend" layer): MB/s of the file's
    bytes, and each column's exception count."""
    import torch
    from repro_torch.core.codec import get_codec

    split, parse = get_codec("csv_split"), get_codec("parse_numeric")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for label, raw in files.items():
        stream = rt.serial(raw).to("cuda")
        (cols, header), t_split = timed(lambda: split.run_encode([stream], {}))
        parsed, t_parse = timed(lambda: [parse.run_encode([c], {}) for c in cols])
        back_cols, t_unparse = timed(lambda: [parse.run_decode(o, h, "cuda")[0]
                                              for o, h in parsed])
        (back,), t_join = timed(lambda: split.run_decode(back_cols, header, "cuda"))
        if not same_stream(back, stream):
            fail(f"csv sweep {label}: csv_split + parse_numeric did not return the file")
        mb = len(raw) / 1e6
        print(f"csv sweep {label}: csv_split encode_MBps={mb / t_split} decode_MBps={mb / t_join}"
              f" parse_numeric encode_MBps={mb / t_parse} decode_MBps={mb / t_unparse}"
              f" (seconds {t_split}, {t_join}, {t_parse}, {t_unparse}); exceptions per column"
              f" {[o[2].n_elts for o, _h in parsed]} of {cols[0].n_elts} rows")


def graph_files(seed: int):
    """G1, the text edge list, and G2, its complete lines' pairs as
    interleaved uint32 (``GRAPH_BYTES``), made from ``seed``."""
    t0 = time.perf_counter()
    raw, pairs = synth_edge_pairs(GRAPH_BYTES, seed + GRAPH_SEED_SHIFT)
    n_lines = raw.count(b"\n") - 2  # the complete edge lines past the two comments
    pairs = pairs[:n_lines]
    pairs_bin = pairs.astype(np.uint32).tobytes()
    print(f"graph data: G1 {len(raw)} bytes ({n_lines} complete edge lines,"
          f" {len(np.unique(pairs[:, 0]))} source nodes); G2 {len(pairs_bin)} bytes;"
          f" seconds={time.perf_counter() - t0}")
    return {"G1": raw, "G2": pairs_bin}


def graph_phase(rt, ops, seed: int):
    """The graph frontend on the card: G1 through ``graph_profile()`` and G2
    through ``graph_bin_profile(4)``, each through ``compress(...,
    device="cuda")`` and back through ``decompress``, with the launch counts
    reset just before and read just after each half; a 4 MiB prefix's frame
    (G1 cut after a newline, G2 whole pairs) equal to the CPU's; then the
    edge corpus and the codecs alone.  Returns the calls (for the profile
    phase) and each kernel's launches summed over them."""
    import torch

    files = graph_files(seed)
    plans = {"G1": ("graph_profile()", rt.graph_profile()),
             "G2": ("graph_bin_profile(4)", rt.graph_bin_profile(4))}
    calls, totals = [], {k: 0 for k in ops.KERNELS}
    t_phase = time.perf_counter()
    for label, raw in files.items():
        pname, plan = plans[label]
        stream = rt.serial(raw)
        cut = raw.rfind(b"\n", 0, PREFIX_BYTES) + 1 if label == "G1" else PREFIX_BYTES
        prefix = rt.serial(raw[:cut])
        t0 = time.perf_counter()
        on_card = card_frame(rt, plan, prefix)  # also warms the card
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = cpu_frame(rt, plan, prefix)
        t_cpu = time.perf_counter() - t0
        if on_card != on_cpu:
            fail(f"graph {label}: the card's prefix frame differs from the CPU's")
        (back,) = rt.decompress(on_card, device="cuda")
        if not same_stream(back, prefix):
            fail(f"graph {label}: the prefix frame did not decode on the card")

        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        frame = rt.compress(plan, stream, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        encode = ops.launch_counts()
        ops.reset_launches()
        t0 = time.perf_counter()
        (out,) = rt.decompress(frame, device="cuda")
        torch.cuda.synchronize()
        ddt = time.perf_counter() - t0
        decode = ops.launch_counts()
        for k in totals:
            totals[k] += encode[k] + decode[k]
        if not same_stream(out, stream):
            fail(f"graph {label}: decompress on the card did not return the input")
        if not (sum(encode.values()) and sum(decode.values())):
            fail(f"graph {label}: a side launched no kernel: {encode} {decode}")
        codecs = frame_codecs(rt, frame)
        named = codecs.split("+")
        missing = ([k for c in named for k in ENCODE_KERNELS_OF.get(c, ()) if encode[k] == 0]
                   + [k for c in named for k in DECODE_KERNELS_OF.get(c, ()) if decode[k] == 0])
        if missing:
            fail(f"graph {label}: never launched {sorted(set(missing))}")
        print(f"graph {label} {pname} [{codecs}]: bytes={len(raw)} frame_bytes={len(frame)}"
              f" ratio={len(raw) / len(frame)} compress_MBps={len(raw) / dt / 1e6}"
              f" seconds={dt} decompress_MBps={len(raw) / ddt / 1e6} decompress_seconds={ddt}")
        print(f"graph {label} launches: compress {json.dumps(encode)}"
              f" decompress {json.dumps(decode)}")
        print(f"check graph {label}: decoded on the card (output on {out.data.device}), equal"
              f" to the input; prefix card frame == cpu frame ({len(on_card)} bytes,"
              f" {prefix.nbytes} input bytes; compress seconds card {t_card} cpu {t_cpu});"
              f" the kernels of its codecs launched")
        calls.append((label, pname, plan, stream, None, frame, codecs))
    print(f"graph launches {json.dumps(totals)}")
    graph_edges(rt)
    graph_sweep(rt, files)
    print(f"graph phase seconds={time.perf_counter() - t_phase}")
    return calls, totals


def _pipe_reader(path: str):
    """The file at ``path`` behind an OS pipe (read() only, not seekable),
    written by a thread; returns the read end and the thread."""
    import threading

    r, w = os.pipe()

    def feed():
        with open(path, "rb") as f, os.fdopen(w, "wb") as out:
            while True:
                block = f.read(1 << 20)
                if not block:
                    break
                out.write(block)

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    return os.fdopen(r, "rb"), t


def sessions_phase(cols, graph_calls, rt, ops):
    """Sessions on the card (``SESSION_CHUNK_BYTES`` chunks): A through
    ``CompressorSession(generic_profile())`` with one worker and with the
    default pool, then from a side stream; C through a pooled
    ``CompressorSession(bfloat16_profile())``; G1 as a file through
    ``compress_file`` from its path (one worker and the pool) and from a
    pipe, back through ``decompress_file`` (one worker and the pool) and
    ``DecompressorSession.iter_frames``; and
    ``compress_traced`` on A's 4 MiB.  The launch counts are reset just
    before and read just after each call.  Returns each kernel's launches
    summed over the phase's calls, and its plans, each ``(label, plan,
    stream, format_version)`` with a stream of that plan's input type."""
    import tempfile

    import torch
    from repro_torch.core import stream_io, wire

    totals = {k: 0 for k in ops.KERNELS}
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def counted(label, way, fn):
        """``fn()`` on the card with its launches counted; each side must launch."""
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = ops.launch_counts()
        for k in totals:
            totals[k] += got[k]
        if not sum(got.values()):
            fail(f"sessions {label}: the {way} launched no kernel")
        return out, dt, got

    def same_prefix(label, plan, prefix):
        """The 4 MiB prefix through sessions at 1 MiB chunks: the card's
        container equals the CPU's, both caches emptied before each side."""
        frames = {}
        for dev, n_workers in (("cuda", None), ("cpu", 1)):
            rt.resolve_cache_clear()
            rt.coder_cache_clear()
            # one worker on the CPU: the plain versions take many small
            # steps, which threads would only contend for
            with rt.CompressorSession(plan, device=dev, chunk_bytes=PREFIX_CHUNK_BYTES,
                                      n_workers=n_workers) as s:
                frames[dev] = s.compress(prefix)
        if frames["cuda"] != frames["cpu"]:
            fail(f"sessions {label}: the card's 4 MiB container differs from the CPU's")
        return len(frames["cuda"])

    def missing_kernels(frame, encode, decode):
        codecs = frame_codecs(rt, wire.read_container(frame)[1][0])
        named = codecs.split("+")
        return codecs, sorted(
            {k for c in named for k in ENCODE_KERNELS_OF.get(c, ()) if encode[k] == 0}
            | {k for c in named for k in DECODE_KERNELS_OF.get(c, ()) if decode[k] == 0})

    def stats_of(session) -> str:
        st = dict(session.stats)
        st["workers"] = session.n_workers or len(os.sched_getaffinity(0))
        return " ".join(f"{k}={st[k]}" for k in (
            "workers", "chunks", "max_inflight", "prefetch_hits", "prefetch_misses",
            "draw_wait_s", "encode_wait_s"))

    # ---- A: one worker, the default pool, and a side stream
    col_a = cols["A_timestamps_i64"]
    a = torch.from_numpy(col_a).to("cuda")
    plan = rt.generic_profile()
    prefix_bytes = same_prefix("A", plan, rt.numeric(col_a[: PREFIX_BYTES // 8]))
    print(f"sessions A prefix check seconds={time.perf_counter() - t_phase}")
    with rt.CompressorSession(plan, chunk_bytes=SESSION_CHUNK_BYTES, n_workers=1) as one, \
            rt.CompressorSession(plan, chunk_bytes=SESSION_CHUNK_BYTES) as pool, \
            rt.DecompressorSession() as dec:
        one.compress(rt.numeric(a[: PREFIX_BYTES // 8]))  # warm-up outside the counts
        serial_frame, t_one, enc_one = counted("A", "compress", lambda: one.compress(rt.numeric(a)))
        frame, t_pool, enc_pool = counted("A", "compress", lambda: pool.compress(rt.numeric(a)))
        if frame != serial_frame:
            fail("sessions A: the pooled container differs from the one-worker container")
        (out,), t_dec, dec_pool = counted("A", "decompress", lambda: dec.decompress(frame))
        if out.data.device.type != "cuda" or not torch.equal(out.data, a):
            fail("sessions A: the DecompressorSession did not return the column on the card")
        codecs, missing = missing_kernels(frame, enc_pool, dec_pool)
        if missing:
            fail(f"sessions A [{codecs}]: never launched {missing}")
        nbytes = col_a.nbytes
        print(f"sessions A generic_profile chunk_bytes={SESSION_CHUNK_BYTES} [{codecs}]:"
              f" chunks={len(wire.read_container(frame)[1])} ratio={nbytes / len(frame)}"
              f" one_worker_compress_MBps={nbytes / t_one / 1e6} seconds={t_one}"
              f" pool_compress_MBps={nbytes / t_pool / 1e6} seconds={t_pool}"
              f" pool_decompress_MBps={nbytes / t_dec / 1e6} decompress_seconds={t_dec}")
        print(f"sessions A stats: one worker {stats_of(one)}; pool {stats_of(pool)};"
              f" decode {stats_of(dec)}; coder tables (process-wide) {rt.coder_cache_info()}")
        print(f"sessions A launches: one-worker compress {json.dumps(enc_one)} pooled compress"
              f" {json.dumps(enc_pool)} decompress {json.dumps(dec_pool)}")
        print(f"check sessions A: pooled container == one-worker container ({len(frame)} bytes);"
              f" decoded on the card, equal; 4 MiB prefix card == cpu ({prefix_bytes} bytes)")
        profile_call("sessions A CompressorSession (pool)", lambda: pool.compress(rt.numeric(a)))
        profile_call("sessions A DecompressorSession (pool)", lambda: dec.decompress(frame))

        # from a side stream: the column is written there behind a device
        # sleep, so a worker that launched on its own (default) stream would
        # read it before the copy lands; a plan without selectors, so that no
        # trial's host copy waits for the side stream before the workers start
        plain = rt.pipeline("delta", "transpose", "zlib_backend")
        with rt.CompressorSession(plain, chunk_bytes=SESSION_CHUNK_BYTES) as side_sess:
            want = side_sess.compress(rt.numeric(a))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            ops.reset_launches()
            t0 = time.perf_counter()
            with torch.cuda.stream(side):
                col = torch.zeros_like(a)
                torch.cuda._sleep(SIDE_SLEEP_CYCLES)
                col.copy_(a)
                got = side_sess.compress(rt.numeric(col))
                (back,) = dec.decompress(got)
                same = torch.equal(back.data, col)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            side_launches = ops.launch_counts()
            for k in totals:
                totals[k] += side_launches[k]
        if got != want or not same:
            fail("sessions A from a side stream: the container or its decode differs")
        if not (side_launches["delta_encode"] and side_launches["delta_decode"]):
            fail(f"sessions A from a side stream: a side launched no kernel {side_launches}")
        print(f"check sessions A from a side stream (the column written there behind a"
              f" {SIDE_SLEEP_CYCLES}-cycle sleep, through delta+transpose+zlib_backend):"
              f" container == the default stream's ({len(got)} bytes), decoded equal;"
              f" seconds={dt}")

        # compress_traced on A's first 4 MiB
        head = rt.numeric(a[: PREFIX_BYTES // 8])
        traced, trace_dt, trace_launches = counted(
            "A traced", "compress", lambda: pool.compress_traced(head))
        frame_t, trace, seconds = traced
        if frame_t != pool.compress(head, chunk_bytes=0) or not trace:
            fail("sessions compress_traced: its frame differs from compress's, or no trace")
        print(f"sessions compress_traced A[:4 MiB] [{frame_codecs(rt, frame_t)}]:"
              f" seconds={seconds} trace={json.dumps(trace)}")
    del a, out, col, back

    # ---- C: bf16 weights through a pooled session
    col_c = cols["C_weights_bf16"]
    c = stream_of(rt, "C_weights_bf16", col_c)
    c_card = rt.numeric(c.data.to("cuda"))
    plan_c = rt.bfloat16_profile()
    t0 = time.perf_counter()
    prefix_c = same_prefix("C", plan_c, stream_of(rt, "C_weights_bf16",
                                                  col_c[: PREFIX_BYTES // 2]))
    print(f"sessions C prefix check seconds={time.perf_counter() - t0}"
          f" (phase {time.perf_counter() - t_phase})")
    with rt.CompressorSession(plan_c, chunk_bytes=SESSION_CHUNK_BYTES) as pool, \
            rt.CompressorSession(plan_c, chunk_bytes=SESSION_CHUNK_BYTES, n_workers=1) as one, \
            rt.DecompressorSession() as dec:
        pool.compress(rt.numeric(c_card.data[: PREFIX_BYTES // 2]))  # warm-up
        frame_c, t_c, enc_c = counted("C", "compress", lambda: pool.compress(c_card))
        if frame_c != one.compress(c_card):
            fail("sessions C: the pooled container differs from the one-worker container")
        (out_c,), td_c, dec_c = counted("C", "decompress", lambda: dec.decompress(frame_c))
        if not torch.equal(out_c.data, c_card.data):
            fail("sessions C: the DecompressorSession did not return the weights on the card")
        codecs, missing = missing_kernels(frame_c, enc_c, dec_c)
        if missing:
            fail(f"sessions C [{codecs}]: never launched {missing}")
        print(f"sessions C bfloat16_profile chunk_bytes={SESSION_CHUNK_BYTES} [{codecs}]:"
              f" chunks={len(wire.read_container(frame_c)[1])} ratio={col_c.nbytes / len(frame_c)}"
              f" pool_compress_MBps={col_c.nbytes / t_c / 1e6} seconds={t_c}"
              f" pool_decompress_MBps={col_c.nbytes / td_c / 1e6} decompress_seconds={td_c}")
        print(f"sessions C stats: pool {stats_of(pool)}; decode {stats_of(dec)};"
              f" coder tables (process-wide) {rt.coder_cache_info()}")
        print(f"sessions C launches: compress {json.dumps(enc_c)} decompress {json.dumps(dec_c)}")
        print(f"check sessions C: pooled container == one-worker container ({len(frame_c)}"
              f" bytes); decoded on the card, equal; 4 MiB prefix card == cpu ({prefix_c} bytes)")
        profile_call("sessions C CompressorSession (pool)", lambda: pool.compress(c_card))
        profile_call("sessions C DecompressorSession (pool)", lambda: dec.decompress(frame_c))
    del c_card, out_c

    # ---- G1: the edge list as a file, from its path and from a pipe
    raw = next(call for call in graph_calls if call[0] == "G1")[3].content_bytes()
    plan_g = rt.graph_profile()
    cut = raw.rfind(b"\n", 0, PREFIX_BYTES) + 1
    t0 = time.perf_counter()
    prefix_g = same_prefix("G1", plan_g, rt.serial(raw[:cut]))
    print(f"sessions G1 prefix check seconds={time.perf_counter() - t0}"
          f" (phase {time.perf_counter() - t_phase})")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "g1.txt")
        with open(src, "wb") as f:
            f.write(raw)
        known, piped = os.path.join(tmp, "known.ozl"), os.path.join(tmp, "piped.ozl")
        back_path = os.path.join(tmp, "back.txt")
        one_path, one_back = os.path.join(tmp, "one.ozl"), os.path.join(tmp, "one.txt")
        with rt.CompressorSession(plan_g, chunk_bytes=SESSION_CHUNK_BYTES) as sess, \
                rt.CompressorSession(plan_g, chunk_bytes=SESSION_CHUNK_BYTES,
                                     n_workers=1) as one, \
                rt.DecompressorSession() as dec, rt.DecompressorSession(n_workers=1) as dec_one:
            # each from an empty resolve cache, so that neither skips a trial
            # the other ran
            rt.resolve_cache_clear()
            _, t_k1, _ = counted("G1 file, one worker", "compress", lambda: (
                stream_io.compress_file(src, one_path, plan_g,
                                        chunk_bytes=SESSION_CHUNK_BYTES, session=one)))
            rt.resolve_cache_clear()
            stats_k, t_k, enc_k = counted("G1 file", "compress", lambda: stream_io.compress_file(
                src, known, plan_g, chunk_bytes=SESSION_CHUNK_BYTES, session=sess))
            pipe, feeder = _pipe_reader(src)
            with pipe:
                stats_p, t_p, enc_p = counted("G1 pipe", "compress", lambda: (
                    stream_io.compress_file(pipe, piped, plan_g,
                                            chunk_bytes=SESSION_CHUNK_BYTES, session=sess)))
            feeder.join()
            with open(known, "rb") as f:
                known_frame = f.read()
            with open(piped, "rb") as f:
                piped_frame = f.read()
            if (wire.read_container(piped_frame)[1] != wire.read_container(known_frame)[1]
                    or not stats_p["container"] or piped_frame[5] & 0x80 == 0):
                fail("sessions G1: the pipe's container differs from the known-size one's")
            with open(one_path, "rb") as f:
                if f.read() != known_frame:
                    fail("sessions G1: the pooled container differs from the one-worker one")
            _, td_k1, _ = counted("G1 file, one worker", "decompress", lambda: (
                stream_io.decompress_file(known, one_back, session=dec_one)))
            dstats, td_k, dec_k = counted("G1 file", "decompress", lambda: (
                stream_io.decompress_file(known, back_path, session=dec)))
            for path in (one_back, back_path):
                with open(path, "rb") as f:
                    if f.read() != raw:
                        fail("sessions G1: decompress_file did not return the file")
            with open(piped, "rb") as f:
                parts, td_p, dec_p = counted("G1 pipe", "decompress",
                                             lambda: list(dec.iter_frames(f)))
            want_g = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to("cuda")
            got_g = torch.cat([p.data for p in parts])
            if got_g.device.type != "cuda" or not torch.equal(got_g, want_g):
                fail("sessions G1: iter_frames did not return the file on the card")
            codecs, missing = missing_kernels(known_frame, enc_k, dec_k)
            if missing:
                fail(f"sessions G1 [{codecs}]: never launched {missing}")
            n = len(raw)
            print(f"sessions G1 graph_profile chunk_bytes={SESSION_CHUNK_BYTES} [{codecs}]:"
                  f" chunks={stats_k['chunks']} ratio={n / len(known_frame)}"
                  f" compress_file_MBps={n / t_k / 1e6} seconds={t_k}"
                  f" one_worker_compress_file_MBps={n / t_k1 / 1e6} seconds={t_k1}"
                  f" pipe_compress_file_MBps={n / t_p / 1e6} seconds={t_p}"
                  f" decompress_file_MBps={n / td_k / 1e6} seconds={td_k}"
                  f" one_worker_decompress_file_MBps={n / td_k1 / 1e6} seconds={td_k1}"
                  f" iter_frames_MBps={n / td_p / 1e6} seconds={td_p}"
                  f" decompress_file_bytes_in={dstats['bytes_in']}")
            print(f"sessions G1 stats: {stats_of(sess)}; one worker {stats_of(one)};"
                  f" decode {stats_of(dec)}; one-worker decode {stats_of(dec_one)}")
            print(f"sessions G1 launches: compress_file {json.dumps(enc_k)} pipe"
                  f" {json.dumps(enc_p)} decompress_file {json.dumps(dec_k)} iter_frames"
                  f" {json.dumps(dec_p)}")
            print(f"check sessions G1 files: the pipe's chunks == the known-size container's"
                  f" ({len(known_frame)} bytes) == the one-worker container,"
                  f" count backpatched ({len(piped_frame)} bytes);"
                  f" decompress_file (pooled and one worker) and iter_frames"
                  f" returned the file (on the card); 4 MiB prefix card == cpu"
                  f" ({prefix_g} bytes)")
            profile_call("sessions G1 compress_file", lambda: stream_io.compress_file(
                src, known, plan_g, chunk_bytes=SESSION_CHUNK_BYTES, session=sess))
            profile_call("sessions G1 decompress_file", lambda: stream_io.decompress_file(
                known, back_path, session=dec))
    print(f"sessions caches: resolve {rt.resolve_cache_info()} coder (process-wide)"
          f" {rt.coder_cache_info()}")
    print(f"sessions peak max_memory_allocated={torch.cuda.max_memory_allocated()}")
    print(f"sessions launches {json.dumps(totals)}")
    print(f"sessions phase seconds={time.perf_counter() - t_phase}")
    a_typed = stream_of(rt, "A_timestamps_i64", col_a)
    return totals, [("sessions A generic_profile", plan, a_typed, None),
                    ("sessions A delta+transpose+zlib_backend", plain, a_typed, None),
                    ("sessions C bfloat16_profile", plan_c, c, None),
                    ("sessions G1 graph_profile", plan_g, rt.serial(raw), None)]


def zipf_tokens(n: int, vocab: int, seed: int = 0, alpha: float = 1.2) -> np.ndarray:
    """``repro/data/synthetic.py``'s ``zipf_tokens``, copied: zipf(``alpha``)
    ranks over ``vocab`` with a light bigram structure, as int32."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks**-alpha
    probs /= probs.sum()
    base = rng.choice(vocab, size=n, p=probs).astype(np.int32)
    shift = rng.integers(0, 7, size=n).astype(np.int32)
    out = (base + np.roll(base, 1) % 7 + shift) % vocab
    return out.astype(np.int32)


def llama_params(seed: int, device: str = "cuda") -> dict:
    """The Llama-3.2-1B parameter tree of ``init_params`` (stacked layers,
    tied embeddings), bfloat16 on ``device``: weights normal(0, 0.02) drawn
    there from ``seed``, norms ones."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, dh, ff, n = LLAMA_D, LLAMA_D // LLAMA_HEADS, LLAMA_FF, LLAMA_LAYERS

    def w(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device=device).normal_(
            0.0, 0.02, generator=gen)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=device)

    return {
        "embed": w(LLAMA_VOCAB, d),
        "final_norm": ones(d),
        "layers": {
            "attn_norm": ones(n, d), "mlp_norm": ones(n, d),
            "wq": w(n, d, LLAMA_HEADS * dh), "wk": w(n, d, LLAMA_KV_HEADS * dh),
            "wv": w(n, d, LLAMA_KV_HEADS * dh), "wo": w(n, LLAMA_HEADS * dh, d),
            "w_gate": w(n, d, ff), "w_up": w(n, d, ff), "w_down": w(n, ff, d),
        },
    }


def route_arrays(seed: int) -> dict:
    """One array per dtype route of ``compress_leaf`` (``ROUTE_LEAVES``), made
    from ``seed`` + 6: weights, masks, codes, counters, token ids, hashes."""
    rng = np.random.default_rng(seed + 6)
    out = {}
    for name, nbytes in ROUTE_LEAVES:
        n = nbytes // np.dtype(name).itemsize
        if name.startswith("float"):
            a = rng.normal(0.0, 0.02, n).astype(name)
        elif name == "bool":
            a = rng.random(n) < 0.1
        elif name == "int8":
            a = np.clip(np.rint(rng.normal(0.0, 20.0, n)), -128, 127).astype(np.int8)
        elif name == "uint8":
            a = np.clip(np.rint(rng.normal(7.5, 2.5, n)), 0, 15).astype(np.uint8)
        elif name == "int16":
            a = rng.integers(-1000, 1000, n).astype(np.int16)
        elif name == "int32":
            a = (np.minimum(rng.zipf(1.2, n), LLAMA_VOCAB) - 1).astype(np.int32)
        elif name == "int64":
            a = np.cumsum(rng.integers(0, 3, n)).astype(np.int64)
        else:
            a = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        out[name] = a
    return out


def checkpoint_phase(rt, ops, seed: int):
    """The checkpoint leaf path, its manager and the shard store on the card:
    two crash kills with card victims, spawned first and checked once the
    CPU's frames are made (4 MiB slices of Llama-3.2-1B leaves, and the route
    tree through ``save_checkpoint``); then the full Llama-3.2-1B bfloat16
    tree through an async ``CheckpointManager`` with an in-place update
    right after ``save()`` returns, from the default stream and from a side
    stream, a synchronous save and restores, each held bit for bit (the
    synchronous save and ``restore_or_none`` under torch.profiler, a save of
    one 2^28-weight leaf and a restore under cProfile); and the trainer's
    shards through
    ``CompressedShardStore``.  The launch counts are reset just before and
    read just after each save, restore and store call.  Returns each
    kernel's launches summed over them, and the plan of each dtype the
    trees hold as ``(label, plan, stream, format_version)``."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from repro_torch.data import CompressedShardStore
    from repro_torch.distributed import checkpoint as ck
    from repro_torch.reliability import crashkill

    totals = {k: 0 for k in ops.KERNELS}
    t_phase = time.perf_counter()

    def counted(label, fn, need=(), profiled=False):
        """``fn()`` on the card with its launches counted and printed; with
        ``profiled``, under torch.profiler (``profile_device``)."""
        torch.cuda.synchronize()
        ops.reset_launches()
        if profiled:
            _, out, dt = profile_device(f"checkpoint {label}", fn)
        else:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        got = ops.launch_counts()
        for k in totals:
            totals[k] += got[k]
        missing = [k for k in need if got[k] == 0]
        if missing:
            fail(f"checkpoint {label}: never launched {missing}")
        print(f"checkpoint {label} launches {json.dumps({k: v for k, v in got.items() if v})}")
        return out, dt

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    def equal(got, want, flipped=False):
        """Bit for bit; ``flipped``: ``got`` is ``want`` with every sign flipped."""
        if got.device.type != "cuda" or got.dtype != want.dtype or got.shape != want.shape:
            return False
        g = bits(got)
        return torch.equal(g ^ -32768 if flipped else g, bits(want))

    def like_of(tree):
        return {k: like_of(v) if isinstance(v, dict) else torch.empty_like(v, device="meta")
                for k, v in tree.items()}

    def check_tree(label, back, flat, flipped=False):
        got = ck.flatten_tree(back)
        if [k for k, _ in got] != [k for k, _ in flat]:
            fail(f"checkpoint {label}: restored keys {[k for k, _ in got]}")
        for (key, g), (_, w) in zip(got, flat):
            if not equal(g, w, flipped):
                fail(f"checkpoint {label}: leaf {key} differs")

    # ---- (iv) crash kills with card victims, in the shadow of the CPU's frames
    kill_dir = tempfile.TemporaryDirectory()

    def kill(site):
        point, occ = site
        work = os.path.join(kill_dir.name, f"{point}_{occ}")
        t0 = time.perf_counter()
        rc = crashkill.run_kill("checkpoint", work, point, occ, "cuda")
        return site, rc, work, time.perf_counter() - t0

    victims = ThreadPoolExecutor(len(CKPT_KILLS))
    kills = victims.map(kill, CKPT_KILLS)

    # ---- (ii) the CPU's frames: 4 MiB slices of two leaves, the route tree
    params = llama_params(seed)
    tree = {"params": params}
    like = {"params": like_of(params)}
    flat = ck.flatten_tree(tree)
    leaves = dict(flat)
    raw_bytes = sum(t.numel() * t.element_size() for _, t in flat)
    n_weights = sum(t.numel() for _, t in flat)
    if LLAMA_LAYERS == 16 and n_weights != LLAMA_WEIGHTS:
        fail(f"checkpoint: the Llama-3.2-1B tree holds {n_weights} weights")
    # one stream of each dtype the tree holds, on the host: its type is all
    # that the signatures phase reads of it
    typed = [(f"checkpoint Llama-3.2-1B {dt}", ck._plan_for_dtype(dt)[0],
              ck._to_numeric_stream(torch.zeros(1, dtype=t.dtype)), None)
             for dt, t in {ck.dtype_name(t.dtype): t for _, t in flat}.items()]
    print(f"checkpoint tree Llama-3.2-1B layers={LLAMA_LAYERS} leaves={len(flat)}"
          f" weights={n_weights} bytes={raw_bytes}: "
          + " ".join(f"{k}={tuple(t.shape)}" for k, t in flat))
    t0 = time.perf_counter()
    for key in CKPT_SLICED:
        part = leaves[key].reshape(-1)[:CKPT_SLICE]
        rt.resolve_cache_clear()
        card = ck.compress_leaf(part)
        rt.resolve_cache_clear()
        if card != ck.compress_leaf(part.cpu(), device="cpu"):
            fail(f"checkpoint {key}[:{CKPT_SLICE}]: the card's frame differs from the CPU's")
        if not equal(ck.decompress_leaf(card, part.shape, "bfloat16"), part):
            fail(f"checkpoint {key}[:{CKPT_SLICE}]: the frame does not decode to it on the card")
        print(f"check checkpoint {key}[:{CKPT_SLICE}]: card frame == cpu frame"
              f" ({len(card)} bytes, ratio {part.numel() * 2 / len(card)}), decoded on the card")
    arrays = route_arrays(seed)
    typed += [(f"checkpoint route {name}", ck._plan_for_dtype(name)[0],
               ck._to_numeric_stream(torch.from_numpy(a)), None) for name, a in arrays.items()]
    route = {name: torch.from_numpy(a).to("cuda") for name, a in arrays.items()}
    with tempfile.TemporaryDirectory() as tmp:
        rt.resolve_cache_clear()
        manifest, t_route = counted("route save", lambda: ck.save_checkpoint(tmp, 1, route))
        back, _ = ck.restore_checkpoint(tmp, 1)
        step_dir = os.path.join(tmp, "step_0000000001")
        for entry in manifest["leaves"]:
            name = entry["key"]
            rt.resolve_cache_clear()
            cpu = ck.compress_leaf(torch.from_numpy(arrays[name]), device="cpu")
            with open(os.path.join(step_dir, entry["file"]), "rb") as f:
                if f.read() != cpu:
                    fail(f"checkpoint route leaf {name}: the card's frame differs from the CPU's")
            got = back[name]
            if got.device.type != "cuda" or ck.dtype_name(got.dtype) != name or not torch.equal(
                    got.cpu(), torch.from_numpy(arrays[name])):
                fail(f"checkpoint route leaf {name}: the restore differs from the input")
        print(f"check checkpoint route tree: {len(route)} leaves, each card frame == cpu frame"
              f" and restored on the card; ratios "
              + " ".join(f"{e['key']}={e['raw_bytes'] / e['compressed_bytes']}"
                         for e in manifest["leaves"])
              + f"; card save seconds={t_route}")
    del route, back
    print(f"checkpoint cpu frames seconds={time.perf_counter() - t0}")
    for (point, occ), rc, work, dt in kills:
        if rc != -signal.SIGKILL:
            fail(f"checkpoint kill at {point}#{occ}: the card victim exited rc={rc}")
        verdict = crashkill.check_invariants("checkpoint", work, "cuda")
        if verdict != {"scenario": "checkpoint", "version": 0, "step": 1}:
            fail(f"checkpoint kill at {point}#{occ}: {verdict}")
        print(f"check checkpoint kill at {point}#{occ}: the card victim died by SIGKILL"
              f" (rc={rc}, {dt} s); step 1 restored on the card intact, nothing"
              f" half-published")
    victims.shutdown()
    kill_dir.cleanup()
    print(f"checkpoint kills and cpu frames seconds={time.perf_counter() - t_phase}")

    # ---- (i) the Llama-3.2-1B tree: async, synchronous, restores
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "ckpt")
        mgr = ck.CheckpointManager(d, keep=2, async_save=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        ops.reset_launches()
        t0 = time.perf_counter()
        # the snapshot's clones queue behind a device sleep: a save thread
        # that did not wait for them would read the snapshot before it lands
        torch.cuda._sleep(SIDE_SLEEP_CYCLES)
        mgr.save(100, tree)
        t_return = time.perf_counter() - t0
        for _, t in flat:
            t.neg_()  # the next train step's in-place update
        mgr.wait()
        torch.cuda.synchronize()
        t_async = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        got = ops.launch_counts()
        for k in totals:
            totals[k] += got[k]
        if not got["float_split"]:
            fail("checkpoint async save: never launched float_split")
        print(f"checkpoint async save 100 launches {json.dumps({k: v for k, v in got.items() if v})}")
        sync = ck.CheckpointManager(d, keep=2)
        _, t_sync = counted("save 200 (synchronous)", lambda: sync.save(200, tree),
                            CKPT_SAVE_KERNELS, profiled=True)
        m200 = sync.history[-1]
        out, t_restore = counted("restore_or_none", lambda: mgr.restore_or_none(like),
                                 CKPT_RESTORE_KERNELS, profiled=True)
        step, back, _ = out
        if step != 200:
            fail(f"checkpoint restore_or_none: step {step}, not 200")
        check_tree("restore_or_none step 200", back, flat)
        del out, back
        out, t_restore100 = counted("restore_tree 100", lambda: ck.restore_tree(d, like, 100),
                                    CKPT_RESTORE_KERNELS)
        check_tree("restore_tree step 100 (saved before the update)", out[0], flat, flipped=True)
        del out
        print(f"check checkpoint Llama-3.2-1B: step 200 restored on the card equal bit for bit;"
              f" step 100, saved async before the in-place update, equal to the tree before it;"
              f" steps kept {sorted(os.listdir(d))}")

        # the same from a side stream, the update queued there
        side_dir = os.path.join(tmp, "side")
        side_mgr = ck.CheckpointManager(side_dir, keep=1, async_save=True)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            torch.cuda._sleep(SIDE_SLEEP_CYCLES)
            side_mgr.save(300, tree)
            for _, t in flat:
                t.neg_()
        side_mgr.wait()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        t_side = time.perf_counter() - t0
        got = ops.launch_counts()
        for k in totals:
            totals[k] += got[k]
        back, _ = profile_host("checkpoint restore_tree (Llama-3.2-1B)",
                               lambda: ck.restore_tree(side_dir, like, 300))
        check_tree("side-stream async save 300", back, flat, flipped=True)
        del back
        print(f"check checkpoint side stream: step 300, saved async from a side stream"
              f" before the update queued there, equal to the tree before it;"
              f" seconds={t_side}")

        # the host's share of a save, on one 2^28-weight leaf (a fifth of it)
        profile_host(f"checkpoint save_checkpoint (synchronous, {CKPT_HOST_LEAF})",
                     lambda: ck.save_checkpoint(os.path.join(tmp, "prof"), 400,
                                                {CKPT_HOST_LEAF: leaves[CKPT_HOST_LEAF]}))
        mb = raw_bytes / 1e6
        print(f"checkpoint Llama-3.2-1B bytes={raw_bytes} ratio={m200['ratio']}"
              f" compressed_bytes={m200['compressed_bytes']}"
              f" async_save_return_seconds={t_return} async_save_seconds={t_async}"
              f" async_save_MBps={mb / t_async} sync_save_seconds={t_sync} (profiled)"
              f" sync_save_MBps={mb / t_sync} restore_seconds={t_restore} (profiled)"
              f" restore_MBps={mb / t_restore} restore_tree_seconds={t_restore100}"
              f" restore_tree_MBps={mb / t_restore100} side_stream_async_save_seconds={t_side}"
              f" (reads warm from the page cache)")
        print("checkpoint leaf ratios: " + " ".join(
            f"{e['key']}={e['raw_bytes'] / e['compressed_bytes']}" for e in m200["leaves"]))
        print(f"checkpoint memory: resident tree {resident} bytes, peak allocated during the"
              f" async save {peak}, snapshot {raw_bytes} ({raw_bytes / peak} of the peak)")
    del like

    # ---- (iii) the trainer's data shards
    tokens = [zipf_tokens(SHARD_TOKENS, LLAMA_VOCAB, seed=seed + i) for i in range(SHARDS + 1)]
    want = [tokens[SHARDS]] + tokens[1:SHARDS]  # shard 0 rewritten
    with tempfile.TemporaryDirectory() as tmp:
        store = CompressedShardStore(tmp)
        _, t_write = counted("shard write", lambda: [
            store.write_shard(i, {"tokens": torch.from_numpy(tokens[i]).to("cuda")})
            for i in range(SHARDS)])
        _, t_rewrite = counted("shard rewrite", lambda: store.write_shard(
            0, {"tokens": torch.from_numpy(tokens[SHARDS]).to("cuda")}))
        read, t_read = counted("shard read", lambda: [store.read_shard(i)
                                                     for i in store.shard_ids()])
        for i, shard in enumerate(read):
            got = shard["tokens"]
            if got.device.type != "cuda" or not torch.equal(
                    got, torch.from_numpy(want[i]).to("cuda")):
                fail(f"checkpoint shard {i}: read back differs")
        if store.shard_ids() != list(range(SHARDS)) or any(
                n.endswith(".tmp") for n in os.listdir(tmp)):
            fail(f"checkpoint shards: the store holds {sorted(os.listdir(tmp))}")
        nbytes = SHARDS * SHARD_TOKENS * 4
        print(f"check checkpoint shards: {SHARDS} shards of {SHARD_TOKENS} zipf tokens (vocab"
              f" {LLAMA_VOCAB}), shard 0 rewritten, read back on the card equal; stats"
              f" {store.stats()} write_MBps={nbytes / t_write / 1e6} seconds={t_write}"
              f" rewrite_seconds={t_rewrite} read_MBps={nbytes / t_read / 1e6}"
              f" seconds={t_read}")
    del read

    print(f"checkpoint sessions {json.dumps(ck.codec_session_stats())}")
    ck.close_codec_sessions()
    print(f"checkpoint launches {json.dumps(totals)}")
    print(f"checkpoint phase seconds={time.perf_counter() - t_phase}")
    return totals, typed


def cli_phase(cols, csv_calls, rt, ops):
    """The command line on the card (``repro_torch.cli``), after the checkpoint
    phase, on files in a temporary directory: column A on the CLI's defaults
    (compress, inspect, decompress; a 4 MiB prefix at 1 MiB chunks equal to
    ``--device cpu``'s container), C1 and C2 through trained plan files,
    salvage and verify of A's 1 MiB-chunk container with chunks 7, 8 and 40
    damaged, every tracked plan file read and written without ``msgpack``,
    and two ``python -m repro_torch`` children.  Each in-process call runs
    through ``cli.main(argv)`` with the launch counts reset just before and
    read just after it.  Returns each kernel's launches summed over them,
    the plans it compressed through as ``(label, plan, stream,
    format_version)``, and each trained plan file's name and ratio by label."""
    import contextlib
    import glob
    import io
    import tempfile

    import torch
    from repro_torch import cli
    from repro_torch.core import serialize, wire

    totals = {k: 0 for k in ops.KERNELS}
    ratios = {}
    t_phase = time.perf_counter()

    def run(label, argv, rc_want=(0,), launch=True):
        """``cli.main(argv)`` on the card, timed on the host clock to a
        synchronize -> (exit code, stdout, stderr, seconds, launches).
        ``launch``: True, a kernel must launch; False, none may; None, either."""
        torch.cuda.synchronize()
        ops.reset_launches()
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = cli.main(argv)
        except SystemExit as e:
            fail(f"cli {label}: exited with {e}")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = ops.launch_counts()
        for k in totals:
            totals[k] += got[k]
        if rc not in rc_want:
            fail(f"cli {label}: exit code {rc}, expected {rc_want}: {err.getvalue().strip()}")
        launched = {k: v for k, v in got.items() if v}
        if launch is True and not launched:
            fail(f"cli {label}: launched no kernel")
        if launch is False and launched:
            fail(f"cli {label}: launched {launched}, expected none")
        return rc, out.getvalue(), err.getvalue(), dt, launched

    def report(label, raw, packed, dt, stdout, launched):
        """The call's line: raw and packed bytes, ratio, MB/s of the raw bytes,
        chunks as the CLI printed them, launches."""
        m = re.search(r"(\d+) chunk\(s\)", stdout)
        print(f"cli {label}: raw_bytes={raw} packed_bytes={packed} ratio={raw / max(packed, 1)}"
              f" MBps={raw / dt / 1e6} seconds={dt} chunks={m.group(1) if m else None}"
              f" launches={json.dumps(launched)}")

    def slurp(path) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def same_file(path, want: bytes) -> bool:
        return slurp(path) == want

    def chunk_spans(blob: bytes):
        n, pos = wire.read_varint(blob, 5)
        spans = []
        for _ in range(n):
            ln, pos = wire.read_varint(blob, pos)
            spans.append((pos, pos + ln))
            pos += ln
        return spans

    with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-") as tmp:
        def at(name):
            return os.path.join(tmp, name)

        # 1. A on the CLI's defaults: generic, 4 MiB chunks, the card
        a = cols["A_timestamps_i64"].tobytes()
        with open(at("A.bin"), "wb") as f:
            f.write(a)
        typed = [("cli A generic", rt.resolve_profile_spec("generic"), rt.serial(a), None),
                 (f"cli A {CLI_RECORD_PROFILE}", rt.resolve_profile_spec(CLI_RECORD_PROFILE),
                  rt.serial(a), None)]
        _, out, _, dt, launched = run("compress A", ["compress", at("A.bin")])
        if f"{len(a) // CHUNK_BYTES} chunk(s), container" not in out:
            fail(f"cli compress A: {out.strip()}")
        packed = os.path.getsize(at("A.bin.ozl"))
        report("compress A (defaults)", len(a), packed, dt, out, launched)
        _, out, _, dt, _ = run("inspect A", ["inspect", at("A.bin.ozl")], launch=False)
        if f"container: {len(a) // CHUNK_BYTES} chunk(s)" not in out:
            fail(f"cli inspect A: {out.strip()}")
        print(f"cli inspect A: seconds={dt} lines={len(out.splitlines())} launches={{}}")
        # the generic profile codes A's raw bytes with the host's zlib_backend
        # alone, whose decode launches nothing
        _, out, _, dt, launched = run("decompress A", ["decompress", at("A.bin.ozl"), "-o",
                                                       at("A.out")], launch=None)
        if not same_file(at("A.out"), a):
            fail("cli decompress A: the output differs from A")
        report("decompress A", len(a), packed, dt, out, launched)
        # A as 8-byte records, on the default chunks: delta and byte shuffle
        # each way on the card
        _, out, _, dt, launched = run("compress A struct", [
            "compress", at("A.bin"), "-o", at("A.struct.ozl"), "--profile", CLI_RECORD_PROFILE])
        packed = os.path.getsize(at("A.struct.ozl"))
        report(f"compress A --profile {CLI_RECORD_PROFILE}", len(a), packed, dt, out, launched)
        _, out, _, dt, launched = run("decompress A struct", [
            "decompress", at("A.struct.ozl"), "-o", at("A.struct.out")])
        if not same_file(at("A.struct.out"), a):
            fail(f"cli decompress A --profile {CLI_RECORD_PROFILE}: the output differs from A")
        report(f"decompress A --profile {CLI_RECORD_PROFILE}", len(a), packed, dt, out, launched)
        with open(at("A4.bin"), "wb") as f:
            f.write(a[:PREFIX_BYTES])
        rt.resolve_cache_clear()
        run("compress A 4 MiB", ["compress", at("A4.bin"), "-o", at("A4.card.ozl"),
                                 "--chunk-bytes", str(PREFIX_CHUNK_BYTES)])
        rt.resolve_cache_clear()
        run("compress A 4 MiB on the cpu", ["compress", at("A4.bin"), "-o", at("A4.cpu.ozl"),
                                            "--chunk-bytes", str(PREFIX_CHUNK_BYTES),
                                            "--device", "cpu"], launch=False)
        card = slurp(at("A4.card.ozl"))
        if not same_file(at("A4.cpu.ozl"), card) or card[:4] != wire.CONTAINER_MAGIC:
            fail("cli compress A 4 MiB: the card's container differs from the CPU's")
        print(f"check cli A: {len(a) // CHUNK_BYTES} chunks on the defaults, decoded on the card equal to A,"
              f" inspect launched nothing; the 4 MiB prefix's card container =="
              f" --device cpu's ({len(card)} bytes, {PREFIX_BYTES // PREFIX_CHUNK_BYTES} chunks);"
              f" --profile {CLI_RECORD_PROFILE} launched kernels each way")

        # 2. C1 and C2 through trained plan files, one frame each
        raws = {label: stream.content_bytes() for label, _n, _p, stream, *_ in csv_calls}
        chosen = {}
        for label, family, point in CLI_TRAINED:
            raw = raws[label]
            src = at(f"{label}.csv")
            with open(src, "wb") as f:
                f.write(raw)
            for p in range(point, -1, -1):
                plan_path = os.path.join(HERE, "results", "trained", f"{family}_{p}.ozp")
                rc, out, err, dt, launched = run(
                    f"compress {label}", ["compress", src, "--plan", plan_path,
                                          "--chunk-bytes", "0"], rc_want=(0, 2), launch=None)
                if rc == 0:
                    break
                if not err.startswith("error (ValueError)"):
                    fail(f"cli compress {label} --plan {family}_{p}: {err.strip()}")
                comp = rt.Compressor.deserialize(slurp(plan_path), device="cpu")
                try:
                    comp.compress(rt.serial(raw), chunk_bytes=0)
                except ValueError:
                    print(f"cli {label}: plan {family}_{p} refuses the full file on the card"
                          f" and on the CPU: {err.strip()}")
                    continue
                fail(f"cli compress {label} --plan {family}_{p}: the card refused ({err.strip()})"
                     " where the CPU accepts")
            else:
                fail(f"cli {label}: no {family} plan accepts the full file")
            if not launched:
                fail(f"cli compress {label}: launched no kernel")
            comp = rt.Compressor.deserialize(slurp(plan_path), device="cpu")
            typed.append((f"cli {label} {family}_{p}.ozp", comp.plan, rt.serial(raw),
                          comp.format_version))
            ozl = src + ".ozl"
            packed = os.path.getsize(ozl)
            report(f"compress {label} --plan {family}_{p}", len(raw), packed, dt, out, launched)
            ratios[label] = (f"{family}_{p}.ozp", len(raw) / packed)
            _, out, _, dt, launched = run(f"decompress {label}",
                                          ["decompress", ozl, "-o", at(f"{label}.out")])
            if not same_file(at(f"{label}.out"), raw):
                fail(f"cli decompress {label}: the output differs from the input")
            report(f"decompress {label}", len(raw), packed, dt, out, launched)
            prefix = raw[: raw.rfind(b"\n", 0, PREFIX_BYTES) + 1]
            with open(at(f"{label}4.csv"), "wb") as f:
                f.write(prefix)
            rt.resolve_cache_clear()
            run(f"compress {label} prefix", ["compress", at(f"{label}4.csv"), "--plan", plan_path,
                                             "--chunk-bytes", "0"], launch=None)
            comp = rt.Compressor.deserialize(slurp(plan_path))
            rt.resolve_cache_clear()
            if not same_file(at(f"{label}4.csv.ozl"),
                             comp.compress(rt.serial(prefix), device="cpu", chunk_bytes=0)):
                fail(f"cli {label}: the prefix's card frame differs from the CPU's")
            print(f"check cli {label}: --plan {family}_{p} decoded on the card equal to the"
                  f" file; the {len(prefix)}-byte prefix's card frame == the CPU's"
                  f" Compressor.deserialize(...).compress frame; codecs"
                  f" {frame_codecs(rt, slurp(ozl))}")
            chosen[label] = (plan_path, ozl, raw)

        # 3. salvage and verify on the card
        _, out, _, dt, launched = run("compress A 1 MiB", [
            "compress", at("A.bin"), "-o", at("A1.ozl"), "--profile", CLI_RECORD_PROFILE,
            "--chunk-bytes", str(CLI_SALVAGE_CHUNK_BYTES)])
        blob = slurp(at("A1.ozl"))
        spans = chunk_spans(blob)
        n_chunks = len(a) // CLI_SALVAGE_CHUNK_BYTES
        if len(spans) != n_chunks:
            fail(f"cli compress A 1 MiB: {len(spans)} chunks, expected {n_chunks}")
        report("compress A 1 MiB", len(a), len(blob), dt, out, launched)
        bad = bytearray(blob)
        for i in CLI_DAMAGED:
            lo, hi = spans[i]
            bad[(lo + hi) // 2] ^= 0xFF
        with open(at("A1bad.ozl"), "wb") as f:
            f.write(bad)
        _, out, _, dt, _ = run("verify A", ["inspect", at("A1.ozl"), "--verify"], launch=False)
        if f"{n_chunks}/{n_chunks} recovered" not in out:
            fail(f"cli inspect --verify A: {out.strip()}")
        _, out, _, dt_verify, _ = run("verify damaged A", ["inspect", at("A1bad.ozl"), "--verify"],
                                      rc_want=(1,), launch=False)
        if f"{n_chunks - 3}/{n_chunks} recovered" not in out or "7..8, 40" not in out:
            fail(f"cli inspect --verify damaged A: {out.strip()}")
        print(f"cli verify: intact seconds={dt}, damaged seconds={dt_verify}: {out.strip()}")
        _, _, err, dt, _ = run("decompress damaged A", ["decompress", at("A1bad.ozl"), "-o",
                                                        at("Abad.out")], rc_want=(2,), launch=None)
        if os.path.exists(at("Abad.out")) or any(n.endswith(".tmp") for n in os.listdir(tmp)):
            fail("cli decompress damaged A: left an output behind")
        print(f"cli decompress damaged A: exit 2 in {dt} s, no output: {err.strip()}")
        _, out, _, dt, launched = run("salvage A", ["decompress", at("A1bad.ozl"), "-o",
                                                    at("Asalv.out"), "--salvage"], rc_want=(1,))
        want = b"".join(a[i * CLI_SALVAGE_CHUNK_BYTES: (i + 1) * CLI_SALVAGE_CHUNK_BYTES]
                        for i in range(n_chunks) if i not in CLI_DAMAGED)
        if not same_file(at("Asalv.out"), want):
            fail("cli decompress --salvage: the output is not A without chunks 7, 8 and 40")
        report("salvage A (61 of 64 chunks)", len(want), len(bad), dt, out, launched)
        _, out, _, dt, launched = run("salvage intact A", ["decompress", at("A1.ozl"), "-o",
                                                           at("Aok.out"), "--salvage"])
        if not same_file(at("Aok.out"), a):
            fail("cli decompress --salvage of the intact container: the output differs from A")
        report("salvage intact A", len(a), len(blob), dt, out, launched)
        print(f"check cli salvage: verify exits 0 intact and 1 damaged ({n_chunks - 3}/{n_chunks}"
              " recovered, damaged 7..8, 40); decompress fails closed (exit 2, no output);"
              " --salvage exits 1 with A without chunks 7, 8, 40 decoded on the card, and 0"
              " with A from the intact container")

        # 4. every tracked plan file, without msgpack
        t0 = time.perf_counter()
        paths = (sorted(glob.glob(os.path.join(HERE, "tests", "golden", "*.ozp")))
                 + sorted(glob.glob(os.path.join(HERE, "results", "trained", "*.ozp"))))
        with_knobs = 0
        for path in paths:
            blob = slurp(path)
            plan, meta = serialize.deserialize_plan(blob)
            if serialize.serialize_plan(plan, meta["name"], format_version=meta.get("format_version"),
                                        level=meta.get("level")) != blob:
                fail(f"cli plan files: {path} does not re-serialize to its bytes")
            again = rt.Compressor.deserialize(blob).serialize()
            if rt.Compressor.deserialize(again).serialize() != again:
                fail(f"cli plan files: {path} is no fixed point of Compressor.serialize")
            if "format_version" in meta and "level" in meta:
                with_knobs += 1
                if again != blob:
                    fail(f"cli plan files: Compressor.serialize of {path} differs from it")
            serialize.plan_digest(plan, format_version=meta.get("format_version"),
                                  level=meta.get("level"))
        if len(paths) != PLAN_FILES or "msgpack" in sys.modules:
            fail(f"cli plan files: {len(paths)} files (expected {PLAN_FILES}); msgpack loaded:"
                 f" {'msgpack' in sys.modules}")
        print(f"check cli plan files: {len(paths)} .ozp files read and written byte for byte"
              f" without msgpack ({with_knobs} carry format_version and level, and"
              f" Compressor.deserialize(blob).serialize() gives their bytes; the rest gain"
              f" the two knobs); seconds={time.perf_counter() - t0}")

        # 5. two children: python -m repro_torch, each with its import and CUDA context
        plan_path, ozl, raw = chosen["C2"]
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        for argv, check, what in (
                (["compress", at("C2.csv"), "--plan", plan_path, "--chunk-bytes", "0", "-o",
                  at("C2.child.ozl")], at("C2.child.ozl"), slurp(ozl)),
                (["decompress", at("C2.child.ozl"), "-o", at("C2.child.out")],
                 at("C2.child.out"), raw)):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "repro_torch", *argv], capture_output=True,
                               text=True, env=env, timeout=600)
            dt = time.perf_counter() - t0
            if r.returncode:
                fail(f"cli child {argv[0]}: exit {r.returncode}: {r.stderr.strip()[-2000:]}")
            if not same_file(check, what):
                fail(f"cli child {argv[0]}: its file differs from the in-process call's")
            print(f"cli child {argv[0]} C2: wall_seconds={dt} (import, CUDA context and the"
                  f" call): {r.stdout.strip()}")
        print("check cli children: python -m repro_torch compress and decompress exit 0,"
              " their files equal the in-process calls'")

    print(f"cli launches {json.dumps(totals)}")
    print(f"cli phase seconds={time.perf_counter() - t_phase}")
    return totals, typed, ratios


def float32_bytes_plan(rt):
    """float32 weights sent as raw bytes: ``interpret_numeric`` at width 4,
    then the float32 profile's split and selectors (a plan a service operator
    registers as a ``.ozp`` file; the named ``float32`` profile wants a
    numeric column, which a byte stream is not)."""
    g = rt.GraphBuilder(1)
    x = g.add("interpret_numeric", g.input(0), width=4)
    signs, exp, man = g.add("float_split", x, fmt=2)
    g.select("bytes_auto", signs)
    g.select("entropy_auto", exp)
    g.select("numeric_auto", man)
    return g.build(SERVICE_FLOAT_PLAN)


def service_plans(rt) -> dict:
    """The service phases' two registered plans, by name."""
    return {SERVICE_RECORD_PLAN: rt.resolve_profile_spec(SERVICE_RECORD_PLAN),
            SERVICE_FLOAT_PLAN: float32_bytes_plan(rt)}


def request_group(ops, totals: dict, label: str, fn, want=None):
    """``fn()`` with the launch counts reset just before and read just after,
    added into ``totals``; ``want`` names kernels that must have launched ->
    (``fn()``'s result, seconds, the kernels launched)."""
    import torch

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = ops.launch_counts()
    for k in totals:
        totals[k] += got[k]
    missing = [k for k in (want or ()) if not got[k]]
    if missing:
        fail(f"{label}: {missing} did not launch ({got})")
    return out, dt, {k: v for k, v in got.items() if v}


def offline_container(plan, data: bytes, chunk_bytes: int, device: str = "cuda") -> bytes:
    """``stream_io.compress_file``'s container of ``data`` (a seekable source:
    the known-count path)."""
    import io

    from repro_torch.core import stream_io

    buf = io.BytesIO()
    stream_io.compress_file(io.BytesIO(data), buf, plan, device=device, chunk_bytes=chunk_bytes)
    return buf.getvalue()


def run_clients(client_cls, address, slices):
    """One client a slice, all at once through ``address``: each compresses its
    slice through ``SERVICE_RECORD_PLAN`` at ``CHUNK_BYTES``, then, once all
    have, decompresses its container; the two rounds are timed from their
    common start to their last answer -> (containers, decoded slices, seconds
    each way, errors)."""
    import threading

    n = len(slices)
    frames, backs, errors = [None] * n, [None] * n, []
    gate = threading.Barrier(n + 1)
    secs = {"compress": 0.0, "decompress": 0.0}

    def client(i):
        try:
            with client_cls(address, timeout=300.0) as ci:
                gate.wait()
                frames[i] = ci.compress_bytes(slices[i], SERVICE_RECORD_PLAN,
                                              chunk_bytes=CHUNK_BYTES)[0]
                gate.wait()
                gate.wait()
                backs[i] = ci.decompress_bytes(frames[i])[0]
                gate.wait()
        except Exception as err:  # reported by the caller, then fail
            errors.append((i, repr(err)))
            gate.abort()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    try:
        for way in ("compress", "decompress"):
            gate.wait()
            t0 = time.perf_counter()
            gate.wait()
            secs[way] = time.perf_counter() - t0
    except threading.BrokenBarrierError:
        pass
    for t in threads:
        t.join(600)
    return frames, backs, secs, errors


def service_phase(cols, rt, ops):
    """The compression service on the card (``repro_torch.service``), after
    the cli phase: an in-process ``CompressionServer(device="cuda")`` on a
    Unix socket with ``struct:8`` and a float32 plan file registered; A and D
    (64 MiB each) through ``ServiceClient`` each way, equal to the offline
    ``stream_io.compress_file`` container on the card and, on a 4 MiB prefix
    at 1 MiB chunks, to the CPU's; eight clients at once on 16 MiB slices of
    A; the ``stats``, ``metrics`` and ``ping`` verbs; the fault drill (a card
    fault at every ``float_split`` encode: three structured errors on one
    connection, then ``plan_quarantined``, ``struct:8`` serving throughout,
    recovery after the cooldown); ``python -m repro_torch serve`` and
    ``client`` children; one A request under torch.profiler and cProfile.
    The launch counts are reset just before and read just after each request
    group.  Returns each kernel's launches summed over the groups, and what the
    frontend phase holds its own against: A's and D's containers, their 4 MiB
    prefixes' CPU containers, and the A request's profile."""
    import tempfile

    from repro_torch.core import wire
    from repro_torch.reliability import FaultPlan
    from repro_torch.service import (CompressionServer, PlanRegistry, ServiceClient,
                                     ServiceUnavailable)
    from repro_torch.service import protocol as SP

    totals = {k: 0 for k in ops.KERNELS}
    t_phase = time.perf_counter()
    a = cols["A_timestamps_i64"].tobytes()
    d = cols["D_weights_f32"].tobytes()
    plans = service_plans(rt)
    float_plan = plans[SERVICE_FLOAT_PLAN]
    sent = {"ping": 0, "compress": 0, "decompress": 0, "stats": 0}

    def group(label, fn, want=None):
        return request_group(ops, totals, f"service {label}", fn, want)

    def offline(name, data: bytes, chunk_bytes: int, device: str = "cuda") -> bytes:
        return offline_container(plans[name], data, chunk_bytes, device)

    def roundtrip(c, label, name, data: bytes, chunk_bytes: int):
        """One compress and one decompress request through ``c``: each a
        request group; the container must equal the offline one and decode
        to ``data``."""
        enc, kdec = SERVICE_KERNELS[name]
        (frame, info), dt_c, l_c = group(f"{label} compress", lambda: c.compress_bytes(
            data, name, chunk_bytes=chunk_bytes), enc)
        (back, _), dt_d, l_d = group(f"{label} decompress", lambda: c.decompress_bytes(frame),
                                     kdec)
        sent["compress"] += 1
        sent["decompress"] += 1
        if back != data:
            fail(f"service {label}: the decompressed bytes differ from the input")
        if frame != offline(name, data, chunk_bytes):
            fail(f"service {label}: the container differs from the offline compress_file's")
        n = -(-len(data) // chunk_bytes)
        if info["chunks"] != n or (n > 1) != (frame[:4] == wire.CONTAINER_MAGIC):
            fail(f"service {label}: {info['chunks']} chunks, expected {n}")
        print(f"service {label} through {name}: raw_bytes={len(data)} packed_bytes={len(frame)}"
              f" ratio={len(data) / len(frame)} compress_MBps={len(data) / dt_c / 1e6}"
              f" decompress_MBps={len(data) / dt_d / 1e6} compress_s={dt_c} decompress_s={dt_d}"
              f" chunks={n} compress_launches={json.dumps(l_c)}"
              f" decompress_launches={json.dumps(l_d)}")
        return frame

    with tempfile.TemporaryDirectory(prefix="chip-smoke-svc-") as tmp:
        def at(name):
            return os.path.join(tmp, name)

        ozp = at(f"{SERVICE_FLOAT_PLAN}.ozp")
        with open(ozp, "wb") as f:
            f.write(rt.Compressor(float_plan, name=SERVICE_FLOAT_PLAN).serialize())
        reg = PlanRegistry()
        reg.register_profile(SERVICE_RECORD_PLAN)
        reg.register_file(ozp)
        rt.resolve_cache_clear()
        rt.coder_cache_clear()
        t0 = time.perf_counter()
        srv = CompressionServer(reg, socket_path=at("ozl.sock"), device="cuda",
                                sessions_per_plan=2, max_clients=SERVICE_CLIENTS,
                                request_timeout=300.0, quarantine_threshold=SERVICE_QUARANTINE,
                                quarantine_cooldown_s=SERVICE_COOLDOWN_S).start()
        print(f"service server: {srv.address} on {srv.device}, plans"
              f" {[e['plan_id'] for e in reg.entries()]}, start_seconds={time.perf_counter() - t0}")
        try:
            with ServiceClient(srv.address, timeout=300.0) as c:
                # 1. A and D, single requests at 4 MiB chunks, each way
                frame_a = roundtrip(c, "A", SERVICE_RECORD_PLAN, a, CHUNK_BYTES)
                frame_d = roundtrip(c, "D", SERVICE_FLOAT_PLAN, d, CHUNK_BYTES)
                cpu_prefix = {}
                # the 4 MiB prefixes at 1 MiB chunks against the CPU's
                for label, name, data in (("A", SERVICE_RECORD_PLAN, a),
                                          ("D", SERVICE_FLOAT_PLAN, d)):
                    prefix = data[:PREFIX_BYTES]
                    rt.resolve_cache_clear()
                    rt.coder_cache_clear()
                    card, _, _ = group(f"{label} prefix", lambda: c.compress_bytes(
                        prefix, name, chunk_bytes=PREFIX_CHUNK_BYTES)[0])
                    sent["compress"] += 1
                    rt.resolve_cache_clear()
                    rt.coder_cache_clear()
                    t0 = time.perf_counter()
                    cpu = cpu_prefix[label] = offline(name, prefix, PREFIX_CHUNK_BYTES, "cpu")
                    if card != cpu or card[:4] != wire.CONTAINER_MAGIC:
                        fail(f"service {label} prefix: the card's container differs from the CPU's")
                    print(f"check service {label}: the service's container == the offline"
                          f" compress_file's on the card, decoded equal to {label}; the 4 MiB"
                          f" prefix's container at 1 MiB chunks == the CPU's ({len(card)} bytes;"
                          f" the CPU side {time.perf_counter() - t0} s)")

            # 2. eight clients at once on 16 MiB slices of A, compress then decompress
            slices = [a[i * SERVICE_SLICE_STEP: i * SERVICE_SLICE_STEP + SERVICE_SLICE_BYTES]
                      for i in range(SERVICE_CLIENTS)]
            if len({len(x) for x in slices}) != 1:
                fail("service clients: the slices of A are not all 16 MiB")
            (frames, backs, secs, errors), dt, launched = group(
                "clients", lambda: run_clients(ServiceClient, srv.address, slices),
                SERVICE_KERNELS[SERVICE_RECORD_PLAN][0] + SERVICE_KERNELS[SERVICE_RECORD_PLAN][1])
            if errors:
                fail(f"service clients: {errors}")
            sent["compress"] += SERVICE_CLIENTS
            sent["decompress"] += SERVICE_CLIENTS
            for i in range(SERVICE_CLIENTS):
                if backs[i] != slices[i]:
                    fail(f"service client {i}: the decompressed slice differs")
                if frames[i] != offline(SERVICE_RECORD_PLAN, slices[i], CHUNK_BYTES):
                    fail(f"service client {i}: the container differs from the offline one")
            total = SERVICE_CLIENTS * SERVICE_SLICE_BYTES
            st = srv.stats()
            pool = st["sessions"][reg.resolve(SERVICE_RECORD_PLAN).digest]
            print(f"service clients: {SERVICE_CLIENTS} at once, {SERVICE_SLICE_BYTES} bytes each;"
                  f" compress_MBps={total / secs['compress'] / 1e6} ({secs['compress']} s)"
                  f" decompress_MBps={total / secs['decompress'] / 1e6} ({secs['decompress']} s)"
                  f" group_seconds={dt} launches={json.dumps(launched)}")
            print(f"service latency (stats verb, ms): "
                  + ", ".join(f"{v}: n={x['n']} p50={x['p50_ms']} p99={x['p99_ms']}"
                              for v, x in sorted(st["latency"].items()))
                  + f"; {SERVICE_RECORD_PLAN} pool: acquires={pool['acquires']}"
                  f" creates={pool['creates']} waits={pool['waits']} created={pool['created']}"
                  f" in_use={pool['in_use']}")
            print("check service clients: every container == its offline twin, every slice"
                  " decoded equal")

            # 3. the stats, metrics and ping verbs
            with ServiceClient(srv.address, timeout=60.0) as c:
                st = c.stats()
                sent["stats"] += 1
                text = c.metrics().decode()
                sent["stats"] += 1
                info = c.ping()
                sent["ping"] += 1
                want = dict(sent, stats=sent["stats"] - 1, ping=sent["ping"] - 1)
                if st["requests"] != want or st["errors"] or st["shed"]:
                    fail(f"service stats: requests {st['requests']} (sent {want}),"
                         f" errors {st['errors']}, shed {st['shed']}")
                if (f'ozl_requests_total{{verb="compress"}} {sent["compress"]}' not in text
                        or not info["ok"] or info["plans"] != 2):
                    fail(f"service metrics or ping: {text[:400]!r} {info}")
            print(f"check service verbs: stats counts {st['requests']} as sent, errors 0;"
                  f" metrics {len(text.splitlines())} lines; ping ok; resolve_cache"
                  f" {st['resolve_cache']} coder_cache {st['coder_cache']}"
                  f" bytes_in={st['bytes_in']} bytes_out={st['bytes_out']}")

            # 4. the fault drill: a card fault at every float_split encode
            dp = d[:PREFIX_BYTES]
            ap = a[:PREFIX_BYTES]
            digest = reg.resolve(SERVICE_FLOAT_PLAN).digest
            with ServiceClient(srv.address, timeout=60.0) as c:
                c.ping()
                conns = srv.stats()["connections"]
                # every host encoder would fire too: a retry on the host would show
                plan = FaultPlan().at(SERVICE_FAULT_POINT, times=10 ** 6).at(
                    "device.encode.cpu.*", times=10 ** 6)

                def drill():
                    kinds = []
                    with plan.arm(all_threads=True):
                        for i in range(SERVICE_QUARANTINE + 1):
                            try:
                                c.compress_bytes(dp, SERVICE_FLOAT_PLAN,
                                                 chunk_bytes=PREFIX_CHUNK_BYTES)
                                kinds.append("ok")
                            except ServiceUnavailable as err:
                                kinds.append((err.kind, err.retry_after))
                            except RuntimeError as err:
                                kinds.append(str(err))
                            # the other plan keeps serving meanwhile
                            if c.compress_bytes(ap, SERVICE_RECORD_PLAN)[0] != frame_a4:
                                fail("service drill: struct:8's container changed under the fault")
                    return kinds

                frame_a4 = offline(SERVICE_RECORD_PLAN, ap, CHUNK_BYTES)
                kinds, dt, launched = group("drill", drill, SERVICE_KERNELS[SERVICE_RECORD_PLAN][0])
                fired = [n for n, _k, _a in plan.fired]
                errs = kinds[:SERVICE_QUARANTINE]
                if (any(f"InjectedDeviceFault: injected fault at '{SERVICE_FAULT_POINT}'" not in e
                        for e in errs if isinstance(e, str)) or not all(isinstance(e, str)
                                                                         for e in errs)):
                    fail(f"service drill: the first {SERVICE_QUARANTINE} answers were {errs}")
                last = kinds[-1]
                if not (isinstance(last, tuple) and last[0] == "plan_quarantined"
                        and last[1] and last[1] > 0):
                    fail(f"service drill: the request after the threshold got {last}")
                if not fired or set(fired) != {SERVICE_FAULT_POINT}:
                    fail(f"service drill: faults fired at {sorted(set(fired))}")
                q = srv.stats()["quarantine"][digest]
                if not q["quarantined"] or q["trips"] != 1:
                    fail(f"service drill: quarantine {q}")
                if srv.stats()["connections"] != conns:
                    fail("service drill: the connection was dropped")
                time.sleep(SERVICE_COOLDOWN_S + 0.1)
                (good, _), _, l_ok = group("drill recovery", lambda: c.compress_bytes(
                    dp, SERVICE_FLOAT_PLAN, chunk_bytes=PREFIX_CHUNK_BYTES), ("float_split",))
                if good != offline(SERVICE_FLOAT_PLAN, dp, PREFIX_CHUNK_BYTES):
                    fail("service drill: the recovered container differs from the offline one")
                if srv.stats()["quarantine"][digest]["quarantined"]:
                    fail("service drill: the plan is still quarantined after a success")
            print(f"service drill: answers {kinds}; faults fired {len(fired)}, all at"
                  f" {SERVICE_FAULT_POINT}, none at a host encoder; {SERVICE_RECORD_PLAN}"
                  f" launches {json.dumps(launched)}; recovery launches {json.dumps(l_ok)};"
                  f" drill_seconds={dt}")
            print(f"check service drill: {SERVICE_QUARANTINE} structured errors on one open"
                  f" connection, then plan_quarantined with retry_after; {SERVICE_RECORD_PLAN}"
                  f" served throughout; no encoder ran on the host; after"
                  f" {SERVICE_COOLDOWN_S} s the plan's container == the offline one")

            # 5. one A request under torch.profiler, and the request core under cProfile
            profile = {}
            with ServiceClient(srv.address, timeout=300.0) as c:
                profile_device("service A compress (struct:8, 4 MiB chunks)",
                               lambda: c.compress_bytes(a, SERVICE_RECORD_PLAN,
                                                        chunk_bytes=CHUNK_BYTES), profile)
            profile["host_ms"] = service_host_profile(srv, SP, request_bytes(
                SP, {"plan": SERVICE_RECORD_PLAN, "size": len(a), "chunk_bytes": CHUNK_BYTES}, a))
        finally:
            srv.shutdown()

        # 6. the command line: a serve child on the card and three client children
        with open(at("A.bin"), "wb") as f:
            f.write(a)
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        sock = at("cli.sock")
        t0 = time.perf_counter()
        server = subprocess.Popen([sys.executable, "-m", "repro_torch", "serve", "--socket", sock,
                                   "--profile", SERVICE_RECORD_PLAN], env=env, text=True,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        try:
            while True:
                try:
                    with ServiceClient(sock, timeout=10.0) as c:
                        c.ping()
                    break
                except OSError:
                    if server.poll() is not None or time.perf_counter() - t0 > 300:
                        server.kill()
                        _, err = server.communicate()
                        fail(f"service serve child did not answer: {err[-2000:]}")
                    time.sleep(0.1)
            print(f"service serve child: answering after {time.perf_counter() - t0} s")
            for argv, check, what in (
                    (["ping"], None, None),
                    (["compress", at("A.bin"), "-o", at("A.svc.ozl"), "--plan-id",
                      SERVICE_RECORD_PLAN, "--chunk-bytes", str(CHUNK_BYTES)], at("A.svc.ozl"),
                     frame_a),
                    (["decompress", at("A.svc.ozl"), "-o", at("A.svc.out")], at("A.svc.out"), a)):
                t1 = time.perf_counter()
                r = subprocess.run([sys.executable, "-m", "repro_torch", "client", *argv,
                                    "--socket", sock], capture_output=True, text=True, env=env,
                                   timeout=600)
                dt = time.perf_counter() - t1
                if r.returncode:
                    fail(f"service client child {argv[0]}: exit {r.returncode}: {r.stderr[-2000:]}")
                if check is not None:
                    with open(check, "rb") as f:
                        if f.read() != what:
                            fail(f"service client child {argv[0]}: its file differs from the"
                                 " in-process one")
                print(f"service client child {argv[0]}: wall_seconds={dt}: {r.stdout.strip()}")
            server.send_signal(signal.SIGTERM)
            out, err = server.communicate(timeout=120)
        finally:
            if server.poll() is None:
                server.kill()
                server.communicate()
        if server.returncode or "server stopped" not in out:
            fail(f"service serve child: exit {server.returncode}: {out[-1000:]} {err[-2000:]}")
        print(f"service serve child: wall_seconds={time.perf_counter() - t0}, exit 0 on"
              f" SIGTERM: {out.strip()!r}")
        print("check service cli: serve on the card, client ping/compress/decompress exit 0,"
              " their files == the in-process service's, SIGTERM stops the server")

    print(f"service launches {json.dumps(totals)}")
    print(f"service phase seconds={time.perf_counter() - t_phase}")
    typed = [(f"service {name}", plans[name], rt.serial(data), None)
             for name, data in ((SERVICE_RECORD_PLAN, a), (SERVICE_FLOAT_PLAN, d))]
    return totals, {"frames": {"A": frame_a, "D": frame_d}, "cpu_prefix": cpu_prefix,
                    "profile": profile, "typed": typed}


def request_bytes(SP, header: dict, data: bytes) -> bytes:
    """One framed compress request with ``data`` as its body in the
    protocol's default blocks."""
    import io

    buf = io.BytesIO()
    SP.write_request(buf, SP.VERB_COMPRESS, header, SP.iter_body_blocks(data))
    return buf.getvalue()


def service_host_profile(srv, SP, request: bytes) -> dict:
    """One framed A request through the server's request core on this thread
    under cProfile (the handler's own path, without the socket): the
    cumulative ms of the protocol, the spool and the session -> those ms."""
    import cProfile
    import io
    import pstats

    import torch

    host = cProfile.Profile()
    host.enable()
    t0 = time.perf_counter()
    verb, header, body = SP.read_request(io.BytesIO(request))
    resp, out = srv.core.handle(verb, header, body)
    sink = io.BytesIO()
    SP.write_response(sink, SP.STATUS_OK, resp, SP.iter_body_blocks(out))
    out.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host.disable()
    stats = pstats.Stats(host).stats
    cum = {}
    for (path, _line, name), v in stats.items():
        key = name if name in SERVICE_HOST_STAGES else None
        if name == "read" and path.endswith("protocol.py"):
            key = "BlockReader.read"  # the request body, block by block
        if name == "write" and path.endswith("tempfile.py"):
            key = "spool.write"
        if key:
            cum[key] = cum.get(key, 0.0) + v[3] * 1e3
    print(f"profile service request core (A, {SERVICE_RECORD_PLAN}): wall_ms={wall * 1e3}"
          f" host_cumulative_ms: {json.dumps(cum)}")
    return {"wall_ms": wall * 1e3, **cum}


def frontend_phase(cols, rt, ops, svc):
    """The non-blocking service frontend on the card
    (``repro_torch.service.ServiceFrontend``), after the service phase's
    server has shut down: one ``RequestCore(device="cuda")`` with the service
    phase's two plans behind one event loop on a Unix socket (four compute
    threads, 512 connections, a 10 s request deadline).  A and D (64 MiB
    each) as single requests at 4 MiB chunks each way, decoded equal, each
    container equal to the threaded server's from the service phase (``svc``)
    and to the offline ``compress_file``'s on the card, each 4 MiB prefix's
    at 1 MiB chunks to the CPU's; two requests pipelined on one raw socket;
    A twice alone (warm), then 200 idle connections and 40 slow-loris
    sockets parked while A runs twice more and the eight clients run on
    16 MiB slices of A, a ninth pinging; every loris reaped by the deadline;
    one A request under torch.profiler and one with each host stage clocked
    (and cProfile on the compute thread), beside the service phase's;
    ``stop()`` while an A compress holds a pooled session.  The launch counts are reset just before and read
    just after each request group -> each kernel's launches summed over the
    groups."""
    import cProfile
    import pstats
    import resource
    import socket
    import tempfile
    import threading

    import torch
    from repro_torch.core import stream_io, wire
    from repro_torch.service import PlanRegistry, RequestCore, ServiceClient, ServiceFrontend
    from repro_torch.service import frontend as FE
    from repro_torch.service import protocol as SP

    totals = {k: 0 for k in ops.KERNELS}
    t_phase = time.perf_counter()
    a = cols["A_timestamps_i64"].tobytes()
    d = cols["D_weights_f32"].tobytes()
    plans = service_plans(rt)
    enc_a, dec_a = SERVICE_KERNELS[SERVICE_RECORD_PLAN]
    # each parked connection holds two descriptors in this process
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft != resource.RLIM_INFINITY and soft < 4 * FRONTEND_MAX_CONNS:
        want = 4 * FRONTEND_MAX_CONNS
        resource.setrlimit(resource.RLIMIT_NOFILE,
                           (want if hard == resource.RLIM_INFINITY else min(want, hard), hard))

    def group(label, fn, want=None):
        return request_group(ops, totals, f"frontend {label}", fn, want)

    def q(xs, p: float) -> float:
        """``RequestCore``'s percentile of ``xs``, in ms."""
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(round(p * (len(xs) - 1))))] * 1e3

    def active() -> int:
        return fe.transport_stats()["active_connections"]

    def settle(n: int, what: str, seconds: float = 30.0) -> None:
        deadline = time.monotonic() + seconds
        while active() != n:
            if time.monotonic() > deadline:
                fail(f"frontend {what}: {active()} active connections, expected {n}")
            time.sleep(0.01)

    with tempfile.TemporaryDirectory(prefix="chip-smoke-fe-") as tmp:
        ozp = os.path.join(tmp, f"{SERVICE_FLOAT_PLAN}.ozp")
        with open(ozp, "wb") as f:
            f.write(rt.Compressor(plans[SERVICE_FLOAT_PLAN], name=SERVICE_FLOAT_PLAN).serialize())
        reg = PlanRegistry()
        reg.register_profile(SERVICE_RECORD_PLAN)
        reg.register_file(ozp)
        rt.resolve_cache_clear()
        rt.coder_cache_clear()
        path = os.path.join(tmp, "fe.sock")
        t0 = time.perf_counter()
        core = RequestCore(reg, device="cuda", sessions_per_plan=2, request_timeout=300.0)
        finished = []  # (size, perf_counter) of each compress request whose handle returned
        handle = core.handle

        def counted(verb, header, body):
            out = handle(verb, header, body)
            if verb == SP.VERB_COMPRESS:
                finished.append((header.get("size"), time.perf_counter()))
            return out

        core.handle = counted
        lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        lst.bind(path)
        lst.listen(FRONTEND_MAX_CONNS)
        fe = ServiceFrontend(core, lst, compute_threads=FRONTEND_COMPUTE_THREADS,
                             max_conns=FRONTEND_MAX_CONNS,
                             request_timeout=FRONTEND_REQUEST_TIMEOUT, owns_listener=True)
        loop = threading.Thread(target=fe.serve_forever, name="frontend-loop", daemon=True)
        loop.start()
        address = f"unix:{path}"
        print(f"frontend: {address} on {core.device}, compute_threads={FRONTEND_COMPUTE_THREADS}"
              f" max_conns={FRONTEND_MAX_CONNS} request_timeout={FRONTEND_REQUEST_TIMEOUT},"
              f" start_seconds={time.perf_counter() - t0}")
        stopped = False
        try:
            # 1. A and D, single requests at 4 MiB chunks, each way
            alone = {}
            with ServiceClient(address, timeout=300.0) as c:
                for label, name, data in (("A", SERVICE_RECORD_PLAN, a),
                                          ("D", SERVICE_FLOAT_PLAN, d)):
                    enc, dec = SERVICE_KERNELS[name]
                    (frame, info), dt_c, l_c = group(f"{label} compress", lambda: c.compress_bytes(
                        data, name, chunk_bytes=CHUNK_BYTES), enc)
                    (back, _), dt_d, l_d = group(f"{label} decompress",
                                                 lambda: c.decompress_bytes(frame), dec)
                    n = -(-len(data) // CHUNK_BYTES)
                    if back != data:
                        fail(f"frontend {label}: the decompressed bytes differ from the input")
                    if frame != svc["frames"][label]:
                        fail(f"frontend {label}: the container differs from the threaded server's")
                    if frame != offline_container(plans[name], data, CHUNK_BYTES):
                        fail(f"frontend {label}: the container differs from the offline one")
                    if info["chunks"] != n or frame[:4] != wire.CONTAINER_MAGIC:
                        fail(f"frontend {label}: {info['chunks']} chunks, expected {n}")
                    alone[label] = dt_c
                    print(f"frontend {label} through {name}: raw_bytes={len(data)}"
                          f" packed_bytes={len(frame)} ratio={len(data) / len(frame)}"
                          f" compress_MBps={len(data) / dt_c / 1e6}"
                          f" decompress_MBps={len(data) / dt_d / 1e6} compress_s={dt_c}"
                          f" decompress_s={dt_d} chunks={n} compress_launches={json.dumps(l_c)}"
                          f" decompress_launches={json.dumps(l_d)}")
                    prefix = data[:PREFIX_BYTES]
                    rt.resolve_cache_clear()
                    rt.coder_cache_clear()
                    card, _, _ = group(f"{label} prefix", lambda: c.compress_bytes(
                        prefix, name, chunk_bytes=PREFIX_CHUNK_BYTES)[0])
                    if card != svc["cpu_prefix"][label]:
                        fail(f"frontend {label} prefix: the card's container differs from the CPU's")
                    print(f"check frontend {label}: decoded equal; the container == the threaded"
                          f" server's and the offline compress_file's on the card; the 4 MiB"
                          f" prefix's at 1 MiB chunks == the CPU's ({len(card)} bytes)")

            # 2. two requests written back to back on one raw socket
            pipe_in = ((SERVICE_RECORD_PLAN, a[:FRONTEND_PIPELINE_BYTES]),
                       (SERVICE_FLOAT_PLAN, d[:FRONTEND_PIPELINE_BYTES]))
            blobs = [request_bytes(SP, {"plan": name, "size": len(x), "chunk_bytes": CHUNK_BYTES},
                                   x) for name, x in pipe_in]
            raw = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            raw.settimeout(300.0)
            raw.connect(path)
            second_started, werr = threading.Event(), []

            def writer():
                # the first request and the second's first byte go out before
                # any response byte is read; the rest of the second follows
                # while the first's response is read (the server pauses
                # reading while a request runs, so a 16 MiB second request
                # cannot sit whole in the socket's buffer)
                try:
                    raw.sendall(blobs[0] + blobs[1][:1])
                    second_started.set()
                    raw.sendall(blobs[1][1:])
                except OSError as err:
                    werr.append(repr(err))
                    second_started.set()

            def pipeline():
                w = threading.Thread(target=writer)
                w.start()
                second_started.wait(300.0)
                r = raw.makefile("rb")
                got = []
                for _ in blobs:
                    status, header, body = SP.read_response(r)
                    got.append((status, header, body.read()))
                w.join(300.0)
                r.close()
                return got

            got, dt, launched = group("pipelined", pipeline,
                                      enc_a + SERVICE_KERNELS[SERVICE_FLOAT_PLAN][0])
            raw.close()
            if werr:
                fail(f"frontend pipelined: the writer failed: {werr}")
            for (name, x), (status, header, body) in zip(pipe_in, got):
                if status != SP.STATUS_OK or body != offline_container(plans[name], x, CHUNK_BYTES):
                    fail(f"frontend pipelined {name}: status {status} {header}, or the container"
                         " differs from the offline one")
            print(f"frontend pipelined: 2 requests ({FRONTEND_PIPELINE_BYTES} bytes of A through"
                  f" {SERVICE_RECORD_PLAN}, of D through {SERVICE_FLOAT_PLAN}) on one socket,"
                  f" seconds={dt} launches={json.dumps(launched)}")
            print("check frontend pipelined: two in-order responses, each == its offline"
                  " container")

            # 3. the crowd: idle and slow-loris sockets parked, then A, then
            # the eight clients with a ninth pinging
            settle(0, "before the crowd")
            # A alone, warm (the pool's sessions were built by the first
            # request), then A with the crowd parked: the pair the crowd is
            # read against
            warm, crowded = [], []

            def a_compress(label, into):
                with ServiceClient(address, timeout=300.0) as c:
                    (frame, _), dt, launched = group(label, lambda: c.compress_bytes(
                        a, SERVICE_RECORD_PLAN, chunk_bytes=CHUNK_BYTES), enc_a)
                if frame != svc["frames"]["A"]:
                    fail(f"frontend {label}: A's container differs from the threaded server's")
                into.append(dt)
                return launched

            for _ in range(FRONTEND_A_TURNS):
                a_compress("A compress, warm alone", warm)
            parked = []

            def dial():
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.settimeout(60.0)
                s.connect(path)
                parked.append(s)
                return s

            for _ in range(FRONTEND_IDLE):
                dial()
            t_loris = time.monotonic()
            lorises = [dial() for _ in range(FRONTEND_LORIS)]
            for i, s in enumerate(lorises):
                s.sendall(blobs[0][: 1 + i % 7])
            n_parked = FRONTEND_IDLE + FRONTEND_LORIS
            settle(n_parked, "parking the crowd")
            for _ in range(FRONTEND_A_TURNS):
                launched = a_compress("A compress, crowd parked", crowded)
            print(f"frontend A with {n_parked} sockets parked: compress_s={crowded}"
                  f" compress_MBps={len(a) / min(crowded) / 1e6}; warm alone just before:"
                  f" compress_s={warm} compress_MBps={len(a) / min(warm) / 1e6};"
                  f" parked_over_warm={min(crowded) / min(warm)} (best of {FRONTEND_A_TURNS}"
                  f" each; the first, cold request: compress_s={alone['A']})"
                  f" launches={json.dumps(launched)}")
            slices = [a[i * SERVICE_SLICE_STEP: i * SERVICE_SLICE_STEP + SERVICE_SLICE_BYTES]
                      for i in range(SERVICE_CLIENTS)]
            rtts, ping_errors, crowd_done = [], [], threading.Event()

            def pinger():
                try:
                    with ServiceClient(address, timeout=60.0) as pc:
                        while not crowd_done.is_set():
                            t1 = time.perf_counter()
                            pc.ping()
                            rtts.append(time.perf_counter() - t1)
                            crowd_done.wait(0.005)
                except Exception as err:  # reported below, then fail
                    ping_errors.append(repr(err))

            ping_thread = threading.Thread(target=pinger)
            ping_thread.start()
            try:
                (frames, backs, secs, errors), dt, launched = group(
                    "crowd", lambda: run_clients(ServiceClient, address, slices), enc_a + dec_a)
            finally:
                crowd_done.set()
                ping_thread.join(60.0)
            if errors or ping_errors or not rtts:
                fail(f"frontend crowd: client errors {errors}, ping errors {ping_errors}")
            for i in range(SERVICE_CLIENTS):
                if backs[i] != slices[i]:
                    fail(f"frontend crowd client {i}: the decompressed slice differs")
                if frames[i] != offline_container(plans[SERVICE_RECORD_PLAN], slices[i],
                                                  CHUNK_BYTES):
                    fail(f"frontend crowd client {i}: the container differs from the offline one")
            with ServiceClient(address, timeout=60.0) as c:
                st = c.stats()
            total = SERVICE_CLIENTS * SERVICE_SLICE_BYTES
            print(f"frontend crowd: {SERVICE_CLIENTS} clients at once, {SERVICE_SLICE_BYTES} bytes"
                  f" each, beside {FRONTEND_IDLE} idle and {FRONTEND_LORIS} slow-loris sockets;"
                  f" compress_MBps={total / secs['compress'] / 1e6} ({secs['compress']} s)"
                  f" decompress_MBps={total / secs['decompress'] / 1e6} ({secs['decompress']} s)"
                  f" group_seconds={dt} launches={json.dumps(launched)}")
            print(f"frontend crowd ping (a ninth client, ms): n={len(rtts)} p50={q(rtts, 0.5)}"
                  f" p99={q(rtts, 0.99)} max={max(rtts) * 1e3}; latency (stats verb, ms): "
                  + ", ".join(f"{v}: n={x['n']} p50={x['p50_ms']} p99={x['p99_ms']}"
                              for v, x in sorted(st["latency"].items())))
            reaped = []
            for i, s in enumerate(lorises):
                s.settimeout(max(0.1, t_loris + FRONTEND_REQUEST_TIMEOUT + 5.0 - time.monotonic()))
                try:
                    while s.recv(65536):
                        pass
                except (ConnectionResetError, BrokenPipeError):
                    pass
                except socket.timeout:
                    fail(f"frontend crowd: loris {i} not reaped within"
                         f" {FRONTEND_REQUEST_TIMEOUT + 5.0} s")
                reaped.append(time.monotonic() - t_loris)
                s.close()
            settle(FRONTEND_IDLE, "after the crowd")
            print(f"check frontend crowd: every container == its offline twin, every slice decoded"
                  f" equal; {FRONTEND_LORIS} lorises reaped {min(reaped)}-{max(reaped)} s after"
                  f" their first bytes (deadline {FRONTEND_REQUEST_TIMEOUT} s);"
                  f" active_connections back to {FRONTEND_IDLE}")
            for s in parked:
                s.close()
            settle(0, "after closing the idle crowd")

            # 4. one A request under torch.profiler, then one with a clock
            # around each host stage and cProfile on the compute thread's
            # handle (cProfile under Python 3.12 sees every thread and
            # misattributes calls that interleave across them; around handle
            # the loop thread only ticks in select)
            prof = {}
            with ServiceClient(address, timeout=300.0) as c:
                c.ping()
                profile_device("frontend A compress (struct:8, 4 MiB chunks)",
                               lambda: c.compress_bytes(a, SERVICE_RECORD_PLAN,
                                                        chunk_bytes=CHUNK_BYTES), prof)
                timed = {name: 0.0 for name in FRONTEND_HOST_STAGES}
                host = cProfile.Profile()

                def clocked(fn, name):
                    def call(*args, **kw):
                        t1 = time.perf_counter()
                        try:
                            return fn(*args, **kw)
                        finally:
                            timed[name] += (time.perf_counter() - t1) * 1e3
                    return call

                def clocked_chunks(*args, **kw):
                    pieces = saved_chunks(*args, **kw)
                    while True:
                        t1 = time.perf_counter()
                        piece = next(pieces, None)
                        timed["_response_chunks"] += (time.perf_counter() - t1) * 1e3
                        if piece is None:
                            return
                        yield piece

                def profiled_handle(*args, **kw):  # on the compute thread
                    host.enable()
                    try:
                        return saved_handle(*args, **kw)
                    finally:
                        host.disable()

                saved_feed, saved_chunks = FE.FrameParser.feed, FE._response_chunks
                saved_file, saved_handle = stream_io.compress_file, core.handle
                FE.FrameParser.feed = clocked(saved_feed, "feed")
                FE._response_chunks = clocked_chunks
                stream_io.compress_file = clocked(saved_file, "compress_file")
                core.handle = clocked(profiled_handle, "handle")
                fe._pump_write = clocked(fe._pump_write, "_pump_write")
                try:
                    t1 = time.perf_counter()
                    frame, _ = c.compress_bytes(a, SERVICE_RECORD_PLAN, chunk_bytes=CHUNK_BYTES)
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t1) * 1e3
                finally:
                    FE.FrameParser.feed, FE._response_chunks = saved_feed, saved_chunks
                    stream_io.compress_file, core.handle = saved_file, saved_handle
                    del fe._pump_write
            if frame != svc["frames"]["A"]:
                fail("frontend profile: A's container differs from the threaded server's")
            cum = {}
            for (src, _line, name), v in pstats.Stats(host).stats.items():
                if (os.path.basename(src), name) in (("server.py", "handle"),
                                                     ("stream_io.py", "compress_file")):
                    cum[name] = cum.get(name, 0.0) + v[3] * 1e3
            sp = svc["profile"]
            print(f"profile frontend A ({SERVICE_RECORD_PLAN}, one call each, this run):"
                  f" torch.profiler wall_ms={prof['wall_ms']} device_busy_ms={prof['busy_ms']}"
                  f" idle_share={prof['idle_share']}; clocked wall_ms={wall_ms}"
                  f" host_clocked_ms (a clock around each call): {json.dumps(timed)}"
                  f" host_cumulative_ms (cProfile on the compute thread): {json.dumps(cum)};"
                  f" the service phase's same request: torch.profiler wall_ms={sp['wall_ms']}"
                  f" device_busy_ms={sp['busy_ms']} idle_share={sp['idle_share']}, its request"
                  f" core on one thread under cProfile, host_cumulative_ms:"
                  f" {json.dumps(sp['host_ms'])}")

            # 5. stop() while an A compress holds a pooled session on a
            # compute thread: its compress_file waits at a gate that opens
            # only after stop() is issued, so all of its card work runs after
            blob = request_bytes(SP, {"plan": SERVICE_RECORD_PLAN, "size": len(a),
                                      "chunk_bytes": CHUNK_BYTES}, a)
            raw = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            raw.settimeout(300.0)
            raw.connect(path)
            held, release = threading.Event(), threading.Event()
            compress_file = stream_io.compress_file

            def gated(*args, **kw):  # on the compute thread, its session checked out
                held.set()
                release.wait(120.0)
                return compress_file(*args, **kw)

            def in_flight():
                before = len(finished)
                stream_io.compress_file = gated
                try:
                    raw.sendall(blob)
                    if not held.wait(120.0):
                        fail("frontend stop: the A request never reached compress_file")
                    with ServiceClient(address, timeout=30.0) as pc:
                        t1 = time.perf_counter()
                        pc.ping()  # the loop answers while a compute thread holds A
                        ping_ms = (time.perf_counter() - t1) * 1e3
                    in_use = core.pool.total_in_use()
                    t_stop = time.perf_counter()
                    fe.stop()
                    release.set()
                    loop.join(FRONTEND_STOP_JOIN_S)
                    join_s = time.perf_counter() - t_stop
                finally:
                    release.set()
                    stream_io.compress_file = compress_file
                torch.cuda.synchronize()
                try:
                    tail = raw.recv(65536)
                except ConnectionResetError:
                    tail = b""
                return before, in_use, t_stop, ping_ms, join_s, tail

            (before, in_use, t_stop, ping_ms, join_s, tail), _, launched = group(
                "stop in flight", in_flight, enc_a)
            stopped = True
            raw.close()
            if loop.is_alive():
                fail(f"frontend stop: the loop thread is alive {FRONTEND_STOP_JOIN_S} s after"
                     " stop()")
            if in_use != 1 or [size for size, _ in finished[before:]] != [len(a)]:
                fail(f"frontend stop: {in_use} sessions checked out at stop(), requests ended"
                     f" {finished[before:]}")
            end_after_stop = finished[-1][1] - t_stop
            if not 0.0 < end_after_stop <= join_s:
                fail(f"frontend stop: the A request ended {end_after_stop} s after stop(), the"
                     f" loop {join_s} s after")
            if core.pool.total_in_use() or tail:
                fail(f"frontend stop: {core.pool.total_in_use()} sessions checked out, or a"
                     f" response on a closed connection ({len(tail)} bytes)")
            counters = core.counters()
            if counters["errors"] != FRONTEND_LORIS or counters["shed"] or (
                    fe.transport_stats()["shed_connections"]):
                fail(f"frontend: errors {counters['errors']} (the {FRONTEND_LORIS} reaped"
                     f" lorises only), shed {counters['shed']}, {fe.transport_stats()}")
            print(f"frontend stop in flight: ping while A was held ping_ms={ping_ms}; stop() to"
                  f" the request's end {end_after_stop} s, to the loop's exit {join_s} s;"
                  f" launches={json.dumps(launched)};"
                  f" transport {json.dumps(fe.transport_stats())}; requests"
                  f" {json.dumps(counters['requests'])}")
            print("check frontend stop: stop() issued while A held a pooled session, its card"
                  " work ran after, serve_forever returned after the request ended, the loop"
                  " thread exited, torch.cuda.synchronize() raised nothing, no session checked"
                  " out before core.close(); errors are the reaped lorises only")
        finally:
            if not stopped:
                fe.stop()
                loop.join(FRONTEND_STOP_JOIN_S)
            core.close()

    print(f"frontend launches {json.dumps(totals)}")
    print(f"frontend phase seconds={time.perf_counter() - t_phase}")
    return totals


def graph_edges(rt) -> None:
    """The graph edge corpus (``GRAPH_EDGES``) through its profiles on the
    card: each frame equals the CPU's and decodes on the card to its file."""
    for label, raw, how in GRAPH_EDGES:
        # a profile spec through the catalogue, or graph_profile's keyword
        # arguments (a separator that the spec refuses)
        plan = rt.resolve_profile_spec(how) if isinstance(how, str) else rt.graph_profile(**how)
        stream = rt.serial(raw)
        frame = card_frame(rt, plan, stream)
        if frame != cpu_frame(rt, plan, stream):
            fail(f"graph edge {label}: the card's frame differs from the CPU's")
        (out,) = rt.decompress(frame, device="cuda")
        if not same_stream(out, stream):
            fail(f"graph edge {label}: decompress on the card did not return the file")
    print(f"check graph edges: {len(GRAPH_EDGES)} files ({', '.join(e[0] for e in GRAPH_EDGES)}),"
          f" each card frame == cpu frame and decoded on the card")


def graph_sweep(rt, files) -> None:
    """``edge_list`` and ``edge_list_bin``, then ``adj_gap`` at each of
    ``GRAPH_WINDOWS``, alone on the card, each way, on G1 and G2 at full
    size (the "graph frontend" layer): seconds, the reference runs that
    ``adj_gap`` chose, and its decoder's dependency levels."""
    import torch
    from repro_torch.codecs.graph import reference_levels
    from repro_torch.core.codec import get_codec

    adj = get_codec("adj_gap")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for label, raw in files.items():
        stream = rt.serial(raw).to("cuda")
        front, params = ((get_codec("edge_list"), {}) if label == "G1"
                         else (get_codec("edge_list_bin"), {"width": 4}))
        (outs, header), t_enc = timed(lambda: front.run_encode([stream], params))
        (back,), t_dec = timed(lambda: front.run_decode(outs, header))
        if not same_stream(back, stream):
            fail(f"graph sweep {label}: {front.name} did not return the file")
        line = (f"graph sweep {label}: {front.name} encode_seconds={t_enc}"
                f" decode_seconds={t_dec} edges={outs[0].n_elts}")
        for window in GRAPH_WINDOWS:
            (adj_outs, adj_header), a_enc = timed(
                lambda: adj.run_encode(outs[:2], {"window": window}))
            (src, dst), a_dec = timed(lambda: adj.run_decode(adj_outs, adj_header))
            if not (same_stream(src, outs[0]) and same_stream(dst, outs[1])):
                fail(f"graph sweep {label}: adj_gap(window={window}) did not return the columns")
            refs = adj_outs[2].data
            line += (f"; adj_gap window={window}: encode_seconds={a_enc}"
                     f" decode_seconds={a_dec} runs={refs.numel()}"
                     f" reference_runs={int((refs != 0).sum())}"
                     f" copy_bits={adj_outs[3].n_elts * 8} gaps={adj_outs[4].n_elts}"
                     f" decode_levels={reference_levels(refs)}")
        print(line)


def sig_sample(rt, atom, codec: str, nbytes: int):
    """The reference probe's value-level sample of ``atom`` for ``codec``
    (``tests/test_analysis.py``'s ``_sample``), its pattern repeated to at
    least ``nbytes``, on the card -> (stream, params as ``_params_for``)."""
    import torch

    st, w = atom

    def rep(unit: bytes) -> bytes:
        return unit * -(-nbytes // len(unit))

    if st == 0:
        if codec == "csv_split":
            raw = rep(b"1,2\n3,4\n5,6\n")
        elif codec == "edge_list":
            raw = rep(b"0 1\n0 2\n1 2\n2 3\n")
        elif codec == "edge_list_bin":
            raw = rep(np.array([0, 1, 0, 2, 1, 2], np.uint32).tobytes())
        elif codec == "constant":
            raw = rep(b"\x07")
        else:
            raw = rep(bytes(range(16)))
        strm = rt.serial(np.frombuffer(raw, np.uint8).copy())
    elif st == 3:
        k = -(-nbytes // 19)  # "alphabetagammaalpha": 19 bytes a group of four
        strm = rt.strings([b"alpha", b"beta", b"gamma", b"alpha"] * k)
    elif st == 1:
        raw = rep(b"abc") if codec == "constant" else rep(bytes(range(48)))
        strm = rt.struct(np.frombuffer(raw, np.uint8).copy(), 3)
    else:
        n = -(-nbytes // w)
        dt = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[w]
        if codec == "constant":
            vals = np.full(n, 5, dt)
        else:  # the probe's ramp, stretched: deltas of 0 and 1 at every width
            vals = (np.arange(n, dtype=np.uint64) * min(n, 1 << (8 * w)) // n).astype(dt)
        strm = rt.numeric(vals)
    strm = rt.Stream(strm.data.to("cuda"), strm.stype, strm.width, strm.lengths)
    torch.cuda.synchronize()
    if codec == "split_n":
        params = {"sizes": [strm.n_elts // 2, strm.n_elts - strm.n_elts // 2]}
    elif codec == "field_split":
        params = {"widths": [1, 2]} if st == 1 else {"widths": [1]}
    elif codec == "interpret_numeric":
        params = {"width": 2}
    elif codec == "float_split":
        params = {"fmt": {2: 0, 4: 2, 8: 3}.get(w, 2)}
    elif codec == "edge_list_bin":
        params = {"width": 4}
    else:
        params = {}
    return strm, params


def same_on_card(got, want) -> bool:
    """Two streams equal in type, lengths and bytes, compared on the card."""
    import torch

    if (got.stype, got.width) != (want.stype, want.width):
        return False
    if (got.lengths is None) != (want.lengths is None):
        return False
    if got.lengths is not None and not np.array_equal(np.asarray(got.lengths),
                                                      np.asarray(want.lengths)):
        return False
    a, b = got.raw(), want.raw()
    return a.device.type == "cuda" and a.numel() == b.numel() and bool(torch.equal(a, b))


def signature_probe(rt, ops, totals: dict) -> None:
    """Every single-input codec on each of the reference probe's seven atoms
    at ``SIG_BYTES`` on the card (``SIG_HOST_BYTES`` for the host leaves):
    where its signature accepts, the encode's outputs stay on the card and
    the decode gives the input back; where it refuses, the encode raises
    ``ValueError`` (never ``KernelError`` or another ``RuntimeError``) with
    no launch, and ``check_plan`` flags the same wiring."""
    import torch
    from repro_torch.analysis import check_plan
    from repro_torch.core.codec import all_codecs

    matrix, launched_by = {}, {}
    for name, spec in sorted(all_codecs().items()):
        if spec.n_inputs != 1:
            continue
        row = ""
        nbytes = SIG_HOST_BYTES if name in SIG_HOST_LEAVES else SIG_BYTES
        for atom in SIG_ATOMS:
            strm, params = sig_sample(rt, atom, name, nbytes)
            accepts = spec.sig.inputs[0].accepts(atom)
            torch.cuda.synchronize()
            ops.reset_launches()
            err = None
            try:
                outs, header = spec.run_encode([strm], params)
            except Exception as e:  # noqa: BLE001 - the probe judges the type below
                err = e
            torch.cuda.synchronize()
            enc = ops.launch_counts()
            if not accepts:
                if not isinstance(err, ValueError) or isinstance(err, ops.KernelError):
                    fail(f"signatures {name} on {atom}: refused with"
                         f" {type(err).__name__}: {err}, not a codec's ValueError")
                if any(enc.values()):
                    fail(f"signatures {name} on {atom}: refused after launching"
                         f" {({k: v for k, v in enc.items() if v})}")
                g = rt.GraphBuilder(1)
                g.add(name, g.input(0), n_out=spec.n_outputs if spec.n_outputs >= 0 else 2,
                      **params)
                if check_plan(g.build(), input_atoms=[atom]).ok:
                    fail(f"signatures {name} on {atom}: encode refuses, check_plan passes")
                row += "r"
                continue
            if err is not None:
                fail(f"signatures {name} on {atom}: accepted, but encode raised"
                     f" {type(err).__name__}: {err}")
            off_card = [o.data.device.type for o in outs if o.data.device.type != "cuda"]
            if off_card:
                fail(f"signatures {name} on {atom}: outputs left the card ({off_card})")
            ops.reset_launches()
            (back,) = spec.run_decode(outs, header, device="cuda")
            torch.cuda.synchronize()
            dec = ops.launch_counts()
            if not same_on_card(back, strm):
                fail(f"signatures {name} on {atom}: decode did not give the input back")
            for k in totals:
                totals[k] += enc[k] + dec[k]
            launched_by[name] = sorted(set(launched_by.get(name, ())) | {
                k for k in ops.KERNELS if enc[k] + dec[k]})
            row += "A"
        matrix[name] = row
    for name, want in ENCODE_KERNELS_OF.items():
        missing = [k for k in want + DECODE_KERNELS_OF[name] if k not in launched_by[name]]
        if missing:
            fail(f"signatures {name}: {missing} never launched ({launched_by[name]})")
    missing = [k for k in ops.KERNELS if k != "lane_refill" and not totals[k]]
    if missing:
        fail(f"signatures: the probe never launched {missing}")
    atoms = ",".join(f"({s},{w})" for s, w in SIG_ATOMS)
    print(f"signatures matrix atoms=[{atoms}] (A accepted and round-tripped on the card,"
          f" r refused with ValueError and no launch): {json.dumps(matrix)}")
    print(f"signatures kernels by codec: {json.dumps(launched_by)}")


def phase_plans(rt, cols, phase_calls: dict, typed: list):
    """Every plan the other phases compress through, each with the atoms of
    its real inputs (stype and width only: no card data is read) ->
    [(label, plan, atoms, format_version)].  ``phase_calls`` holds the
    container, records, csv and graph phases' calls by phase; ``typed``
    the other phases' ``(label, plan, stream, format_version)``; the main
    and level-7 phases' plans follow from ``column_plans`` and
    ``LEVEL_COLUMNS``, which those phases read."""
    from repro_torch.analysis import atoms_for_streams

    sources = level_sources(cols)

    def atoms_of(cname):
        return atoms_for_streams([stream_of(rt, cname, sources[cname])])

    out = [(f"main {cname} {pname}", PLANS[pname](rt), atoms_of(cname), None)
           for cname, pname in column_plans(cols)]
    for phase, calls in phase_calls.items():
        for label, pname, plan, stream, *_rest in calls:
            out.append((f"{phase} {label} {pname}", plan, atoms_for_streams([stream]), None))
    out += [(label, plan, atoms_for_streams([stream]), fv)
            for label, plan, stream, fv in typed]
    out += [(f"level7 {cname} {pname}", PLANS[pname](rt), atoms_of(cname), None)
            for cname, pname, _leaf in LEVEL_COLUMNS]
    return out


def signatures_phase(cols, frames, rt, ops, phase_calls: dict, typed: list):
    """Codec signatures and the plan type-checker on the card
    (``repro_torch.analysis``), after the frontend phase: the signature
    probe (``signature_probe``); ``check_plan`` of every other phase's plan
    at its inputs' real types, each clean, with its host ms; the resolve
    check (``set_resolve_check``) on A's ``numeric_profile`` compress, frame
    unchanged, and on the five ill-typed plans of ``tests/illtyped``, each
    refused with its manifest's code and no launch; a ``RequestCore(device=
    "cuda")``'s registry refusing them and serving A through ``struct:8``;
    one ``python -m repro_torch lint --json`` child; ``inspect``'s typed node
    lines on the main phase's A frame.  Returns each kernel's launches over
    the probe's accepted calls and the A request."""
    import contextlib
    import io
    import tempfile

    import torch
    from repro_torch import cli
    from repro_torch.analysis import PlanTypeError, check_plan
    from repro_torch.service import PlanRegistry, RequestCore
    from repro_torch.service import protocol as SP

    totals = {k: 0 for k in ops.KERNELS}
    t_phase = time.perf_counter()

    # 1. every single-input codec's signature against its encoder on the card
    t0 = time.perf_counter()
    signature_probe(rt, ops, totals)
    print(f"signatures probe seconds={time.perf_counter() - t0}")

    # 2. every phase's plan at its real input types: clean, and what it costs
    for label, plan, atoms, fv in phase_plans(rt, cols, phase_calls, typed):
        t0 = time.perf_counter()
        report = check_plan(plan, format_version=fv, input_atoms=atoms)
        first = time.perf_counter() - t0
        again = []
        for _ in range(SIG_CHECK_REPEATS):
            t0 = time.perf_counter()
            check_plan(plan, format_version=fv, input_atoms=atoms)
            again.append(time.perf_counter() - t0)
        if not report.ok:
            fail(f"signatures {label}: check_plan at {atoms} reports"
                 f" {[str(d) for d in report.errors]}")
        print(f"signatures check_plan {label} atoms={atoms} nodes={len(plan.nodes)}:"
              f" clean, host_ms first={first * 1e3} min_of_{SIG_CHECK_REPEATS}="
              f"{min(again) * 1e3} warnings={len(report.warnings)}")

    # 3. the resolve check on the card
    a_col = cols["A_timestamps_i64"]
    a_plan = PLANS["numeric_profile"](rt)
    a_stream = stream_of(rt, "A_timestamps_i64", a_col)
    timed = {False: [], True: []}
    for i in range(RESOLVE_CHECK_PAIRS):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            rt.resolve_cache_clear()  # the check runs on a resolve-cache miss
            rt.set_resolve_check(on)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                frame = rt.compress(a_plan, a_stream, device="cuda")
                torch.cuda.synchronize()
                timed[on].append(time.perf_counter() - t0)
            finally:
                rt.set_resolve_check(False)
            if frame != frames["A_timestamps_i64", "numeric_profile"]:
                fail(f"signatures resolve check {'on' if on else 'off'}: A's frame differs"
                     " from the main phase's")
    med = {on: statistics.median(v) for on, v in timed.items()}
    diff = statistics.median(b - a for a, b in zip(timed[False], timed[True]))
    print(f"signatures resolve check A numeric_profile: frame equal on and off over"
          f" {RESOLVE_CHECK_PAIRS} pairs in turns; compress seconds median off={med[False]}"
          f" on={med[True]}, median of the pairs' on-off={diff};"
          f" off={timed[False]} on={timed[True]}")
    manifest_path = os.path.join(HERE, "tests", "illtyped", "manifest.json")
    with open(manifest_path) as f:
        manifest = json.load(f)
    ill = {}
    for fname, want in sorted(manifest.items()):
        with open(os.path.join(HERE, "tests", "illtyped", fname), "rb") as f:
            ill[fname] = f.read()
        comp = rt.Compressor.deserialize(ill[fname])
        atom = next(a for a in SIG_ATOMS if want["expect"] in {
            d.code for d in check_plan(comp.plan, format_version=comp.format_version,
                                       input_atoms=[a] * comp.plan.n_inputs).errors})
        streams = [sig_sample(rt, atom, "", SIG_BYTES)[0] for _ in range(comp.plan.n_inputs)]
        rt.resolve_cache_clear()
        rt.set_resolve_check(True)
        torch.cuda.synchronize()
        ops.reset_launches()
        try:
            comp.compress(streams if len(streams) > 1 else streams[0], device="cuda",
                          chunk_bytes=0)
            fail(f"signatures resolve check {fname}: compressed an ill-typed plan")
        except PlanTypeError as err:
            codes = sorted({d["code"] for d in err.extra["diagnostics"]})
        finally:
            rt.set_resolve_check(False)
        torch.cuda.synchronize()
        got = {k: v for k, v in ops.launch_counts().items() if v}
        if want["expect"] not in codes or got:
            fail(f"signatures resolve check {fname}: codes {codes}, launches {got}")
        print(f"signatures resolve check {fname} at {atom}: PlanTypeError {codes}, no launch")

    # 4. the registry of a request core on the card, and lint in a child
    reg = PlanRegistry()
    core = RequestCore(reg, device="cuda", sessions_per_plan=1, request_timeout=300.0)
    try:
        with tempfile.TemporaryDirectory(prefix="chip-smoke-sig-") as tmp:
            for fname, blob in sorted(ill.items()):
                path = os.path.join(tmp, fname)
                with open(path, "wb") as f:
                    f.write(blob)
                t0 = time.perf_counter()
                try:
                    reg.register_file(path)
                    fail(f"signatures registry: registered the ill-typed {fname}")
                except PlanTypeError as err:
                    kind = err.extra["error_kind"]
                    codes = sorted({d["code"] for d in err.extra["diagnostics"]})
                dt = time.perf_counter() - t0
                if kind != "ill_typed_plan" or manifest[fname]["expect"] not in codes or len(reg):
                    fail(f"signatures registry {fname}: {kind} {codes}, {len(reg)} registered")
                print(f"signatures registry refuses {fname}: {kind} {codes}"
                      f" host_ms={dt * 1e3}")
        entry = reg.register_profile(SERVICE_RECORD_PLAN)
        data = a_col.tobytes()
        req = request_bytes(SP, {"plan": SERVICE_RECORD_PLAN, "size": len(data),
                                 "chunk_bytes": CHUNK_BYTES}, data)

        def one_request():
            verb, header, body = SP.read_request(io.BytesIO(req))
            resp, out = core.handle(verb, header, body)
            try:
                return resp, out.read()
            finally:
                out.close()

        (resp, container), dt, launched = request_group(
            ops, totals, "signatures registry A", one_request,
            SERVICE_KERNELS[SERVICE_RECORD_PLAN][0])
        if container != offline_container(entry.compressor.plan, data, CHUNK_BYTES):
            fail("signatures registry: A's container differs from the offline one")
        print(f"signatures registry A through {SERVICE_RECORD_PLAN} ({entry.digest[:12]}):"
              f" container equal to the offline one, {len(container)} bytes,"
              f" seconds={dt} launched={json.dumps(launched)}")
    finally:
        core.close()
    files = [os.path.join("tests", "illtyped", f) for f in sorted(manifest)]
    env = {**os.environ, "PYTHONPATH": os.path.join(HERE, "src")}
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-m", "repro_torch", "lint", "--json"]
                           + files + ["generic"], capture_output=True, text=True,
                           cwd=HERE, env=env, timeout=300)
    wall = time.perf_counter() - t0
    if child.returncode != 1:
        fail(f"signatures lint child: exit {child.returncode}: {child.stderr.strip()[-500:]}")
    out = json.loads(child.stdout)
    for t, fname in zip(out["targets"], sorted(manifest)):
        codes = {d["code"] for d in t["diagnostics"]}
        if t["target"] != os.path.join("tests", "illtyped", fname) or \
                manifest[fname]["expect"] not in codes:
            fail(f"signatures lint child: {t['target']} gave {sorted(codes)}")
    if not out["targets"][-1]["ok"]:
        fail("signatures lint child: generic is not clean")
    print(f"signatures lint child: exit 1, {out['errors']} errors over"
          f" {len(out['targets'])} targets, wall seconds={wall}")

    # 5. inspect's typed node lines on the main phase's A frame
    with tempfile.TemporaryDirectory(prefix="chip-smoke-sig-") as tmp:
        path = os.path.join(tmp, "A.ozl")
        with open(path, "wb") as f:
            f.write(frames["A_timestamps_i64", "numeric_profile"])
        buf = io.StringIO()
        torch.cuda.synchronize()
        ops.reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["inspect", path])
        torch.cuda.synchronize()
        got = {k: v for k, v in ops.launch_counts().items() if v}
    nodes = [ln for ln in buf.getvalue().splitlines() if ln.lstrip().startswith("node ")]
    if rc != 0 or not nodes or got or not all("  :: " in ln for ln in nodes):
        fail(f"signatures inspect: exit {rc}, launches {got}, lines {nodes}")
    for ln in nodes:
        print(f"signatures inspect A numeric_profile |{ln}")
    print(f"signatures phase seconds={time.perf_counter() - t_phase}")
    return totals


def train_phase(cols, frames, record_calls, csv_calls, graph_calls, cli_ratios, rt, ops):
    """The compressor trainer on the card (``repro_torch.training``), after
    the signatures phase: ``detect_frontend`` on the first 4 MiB of each of
    ``TRAIN_SNIFF``; C1 (the PPMF person recipe, 66 MB) through a ``python
    -m repro_torch train --all-points`` child at the CLI's defaults, each
    emitted point then compressing all of C1 on the card into one frame and
    decoding back to it (the best-ratio point alone, timed, then the others
    at once on C1's first ``TRAIN_REST_BYTES`` of whole rows, a thread and a
    CUDA stream each); A's first 4 MiB trained in-process at the same defaults under
    torch.profiler, then at one worker under cProfile (equal plans), its
    best-ratio plan round-tripping all of A at 4 MiB chunks
    (``numeric_profile`` beside it); a 256 KiB C1 prefix trained on
    the card at the default workers and at one, and on the CPU, with equal
    objectives and plan bytes; a train with ``TRAIN_FAULT_POINT`` armed
    raising ``InjectedDeviceFault``.  The launch counts are reset just before
    and read just after each in-process call (the child's launches are its
    own process's).  Returns each kernel's launches summed over them."""
    import cProfile
    import glob
    import pstats
    import tempfile

    import torch
    from repro_torch.core.serialize import serialize_plan
    from repro_torch.reliability import FaultPlan, InjectedDeviceFault
    from repro_torch.training import detect_frontend, train

    totals = {k: 0 for k in ops.KERNELS}
    t_phase = time.perf_counter()

    def counted(fn):
        """``fn()`` on the card, timed to a synchronize -> (result, seconds,
        the kernels it launched)."""
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = ops.launch_counts()
        for k in totals:
            totals[k] += got[k]
        return out, dt, {k: v for k, v in got.items() if v}

    def outcome(tc):
        return ([(p.est_size, p.est_time) for p in tc.points],
                [serialize_plan(plan) for plan, _sz, _tm in tc.pareto_plans()])

    def stats_line(tc) -> str:
        keys = ("train_seconds", "parse_seconds", "cluster_seconds", "search_seconds",
                "merge_seconds", "train_bytes", "train_speed_mib_min", "n_streams",
                "n_clusters", "workers", "evaluations", "invalid_evaluations",
                "pruned_static", "eval_wall_seconds", "session_hits", "session_misses")
        return " ".join(f"{k}={tc.stats[k]}" for k in keys)

    # 1. sniffing on the first 4 MiB of each recipe
    heads = {label[0]: col.view(np.uint8)[:TRAIN_SAMPLE_BYTES].tobytes()
             for label, col in cols.items()}
    raws = {}
    for calls in (record_calls, csv_calls, graph_calls):
        for label, _pname, _plan, stream, *_ in calls:
            raws[label] = stream
            heads[label] = stream.data[:TRAIN_SAMPLE_BYTES].cpu().numpy().tobytes()
    picked = {}
    for label in TRAIN_SNIFF:
        t0 = time.perf_counter()
        picked[label] = detect_frontend(heads[label])
        print(f"train sniff {label}: {len(heads[label])} bytes -> {picked[label]!r}"
              f" host_ms={(time.perf_counter() - t0) * 1e3}")
    if type(picked["C1"]).__name__ != "CsvFrontend" or picked["C1"].n_cols != 8:
        fail(f"train sniff C1: {picked['C1']!r}, expected an 8-column CSV")

    # 2. C1 at full width through the command line, as a user runs it
    c1 = raws["C1"].content_bytes()
    c1_stream = rt.serial(torch.from_numpy(np.frombuffer(c1, np.uint8).copy()).cuda())
    csv_frame = next(frame for label, *_r, frame, _codecs in csv_calls if label == "C1")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp:
        src = os.path.join(tmp, "C1.csv")
        with open(src, "wb") as f:
            f.write(c1)
        env = {**os.environ, "PYTHONPATH": os.path.join(HERE, "src")}
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-m", "repro_torch", "train", src, "--out",
                                os.path.join(tmp, "c1.ozp"), "--all-points"],
                               capture_output=True, text=True, cwd=tmp, env=env,
                               timeout=TRAIN_CHILD_TIMEOUT)
        wall = time.perf_counter() - t0
        for line in child.stdout.splitlines():
            print(f"train C1 child | {line}")
        if child.returncode:
            fail(f"train C1 child: exit {child.returncode}: {child.stderr.strip()[-800:]}")
        sample = int(re.search(r"sample\(s\), (\d+) bytes", child.stdout).group(1))
        wrote = re.findall(r"^wrote (\S+) \(", child.stdout, re.M)
        if sorted(wrote) != sorted(glob.glob(os.path.join(tmp, "c1*.ozp"))) or not wrote:
            fail(f"train C1 child: wrote {wrote}")
        print(f"train C1 child: wall seconds={wall} (start-up included), sample_bytes={sample},"
              f" MiB_per_min={sample / 2 ** 20 / (wall / 60)}, {len(wrote)} point(s)")
        # one frame a point (csv_split needs whole rows, so a CSV plan is
        # deployed unchunked, `compress --plan P --chunk-bytes 0`); the
        # best-ratio point, the plan the child tells a user to deploy, alone
        # first (the MB/s a user gets), then each frame a chain of host
        # leaves, the others at once, a thread and a CUDA stream each, to keep
        # the phase inside the run's limit
        best = re.search(r"^wrote (\S+) \(\d+ bytes, best-ratio point", child.stdout,
                         re.M).group(1)

        def round_trip(path, stream=c1_stream):
            with open(path, "rb") as f:
                comp = rt.Compressor.deserialize(f.read(), device="cuda")
            side = torch.cuda.Stream()
            with torch.cuda.stream(side):
                t0 = time.perf_counter()
                frame = comp.compress(stream, chunk_bytes=0)
                side.synchronize()
                t1 = time.perf_counter()
                (back,) = rt.decompress(frame, device="cuda")
                side.synchronize()
                t2 = time.perf_counter()
                ok = same_stream(back, stream)
            return comp, frame, t1 - t0, t2 - t1, ok

        from concurrent.futures import ThreadPoolExecutor

        # the best-ratio point on all of C1; the others on its first
        # TRAIN_REST_BYTES of whole rows
        head = c1[: c1.rfind(b"\n", 0, TRAIN_REST_BYTES) + 1]
        head_stream = rt.serial(torch.from_numpy(np.frombuffer(head, np.uint8).copy()).cuda())
        alone, _, launched = counted(lambda: round_trip(best))
        rest = [path for path in wrote if path != best]
        with ThreadPoolExecutor(max_workers=max(len(rest), 1)) as pool:
            done, wall, launched_rest = counted(
                lambda: list(pool.map(lambda path: round_trip(path, head_stream), rest)))
        for path, (comp, frame, dt, ddt, ok) in [(best, alone), *zip(rest, done)]:
            n = len(c1) if path == best else len(head)
            if not ok:
                fail(f"train C1 {os.path.basename(path)}: {n} bytes of C1 did not come back on"
                     " the card")
            how = (f"alone: compress_MBps={n / dt / 1e6} seconds={dt}"
                   f" decompress_MBps={n / ddt / 1e6} decompress_seconds={ddt}"
                   if path == best else
                   f"under {len(rest)}-way contention, the others at once:"
                   f" contended_compress_MBps={n / dt / 1e6}"
                   f" contended_decompress_MBps={n / ddt / 1e6}")
            print(f"train C1 point {wrote.index(path)} ({os.path.basename(path)},"
                  f" {len(comp.plan.nodes)} nodes): {'all ' if path == best else 'the first '}"
                  f"{n} bytes round-trip on the card, ratio={n / len(frame)} {how}"
                  f" codecs={frame_codecs(rt, frame)}")
        del alone, done, head_stream
        print(f"train C1 points: the best-ratio point alone on all of C1, launches"
              f" {json.dumps(launched)}; the other {len(rest)} round trips of {len(head)} bytes"
              f" at once in {wall} s, launches {json.dumps(launched_rest)}")
    plan_name, cli_ratio = cli_ratios["C1"]
    print(f"train C1 beside: csv_profile(8) ratio={len(c1) / len(csv_frame)} (csv phase),"
          f" {plan_name} ratio={cli_ratio} (cli phase), both unchunked")
    del c1_stream

    # 3. A's first 4 MiB in-process at the CLI's defaults, profiled
    a4 = heads["A"]
    fe_a = picked["A"]

    def train_a(workers=None):
        rt.resolve_cache_clear()
        return train([[rt.serial(a4)]], fe_a, pop_size=TRAIN_POP, generations=TRAIN_GENS,
                     n_points=TRAIN_POINTS, seed=0, workers=workers)

    prof = {}
    _, (tc_a, dt, launched), _ = profile_device("train A 4 MiB", lambda: counted(train_a),
                                                prof)
    print(f"train A 4 MiB {fe_a!r}: wall seconds={dt} idle_share={prof['idle_share']}"
          f" {stats_line(tc_a)} launches={json.dumps(launched)}")
    host = cProfile.Profile()
    host.enable()
    tc_a1, dt1, launched1 = counted(lambda: train_a(1))
    host.disable()
    if outcome(tc_a1) != outcome(tc_a):
        fail("train A: one worker gave other plans than the default pool")
    stats = pstats.Stats(host).stats
    rows = sorted(((v[2] * 1e3, f"{os.path.basename(k[0])}:{k[2]}") for k, v in stats.items()),
                  reverse=True)
    cum = {}
    for k, v in stats.items():
        if k[2] in TRAIN_HOST_STAGES:
            cum[k[2]] = cum.get(k[2], 0.0) + v[3] * 1e3
    print(f"train A 4 MiB workers=1: wall seconds={dt1} (cProfile on) {stats_line(tc_a1)},"
          f" plans equal to the pool's; host_self_ms: "
          + ", ".join(f"{name}={ms:.1f}" for ms, name in rows[:10])
          + f" host_cumulative_ms: {json.dumps(cum)}")
    col_a = cols["A_timestamps_i64"]
    a_stream = rt.serial(torch.from_numpy(col_a.view(np.uint8)).cuda())
    plan = tc_a.best_ratio_plan()
    frame, dt, enc = counted(lambda: rt.compress(plan, a_stream, chunk_bytes=CHUNK_BYTES))
    (back,), ddt, dec = counted(lambda: rt.decompress(frame, device="cuda"))
    if not same_stream(back, a_stream):
        fail("train A: the best-ratio plan did not round-trip all of A on the card")
    del back, a_stream
    base, bdt, _ = counted(lambda: rt.compress(
        PLANS["numeric_profile"](rt), stream_of(rt, "A_timestamps_i64", col_a),
        chunk_bytes=CHUNK_BYTES))
    print(f"train A best-ratio plan on all {col_a.nbytes} bytes at {CHUNK_BYTES} B chunks:"
          f" round-trip on the card, ratio={col_a.nbytes / len(frame)} beside"
          f" numeric_profile's {col_a.nbytes / len(base)} at the same chunks"
          f" ({col_a.nbytes / len(frames['A_timestamps_i64', 'numeric_profile'])} unchunked,"
          f" main phase); compress_MBps={col_a.nbytes / dt / 1e6} (numeric_profile's"
          f" {col_a.nbytes / bdt / 1e6}) decompress_MBps={col_a.nbytes / ddt / 1e6}"
          f" codecs={first_codecs(rt, frame)} launches compress {json.dumps(enc)}"
          f" decompress {json.dumps(dec)}")

    # 4. the card against the CPU on a 256 KiB C1 prefix
    small = c1[: c1.rfind(b"\n", 0, TRAIN_CHECK_BYTES) + 1]
    fe_small = detect_frontend(small)
    seen = {}
    # the CPU leg runs one evaluation thread: the kernels' plain versions use
    # torch's own threads, which a pool of one thread per core would crowd
    for label, device, workers in (("card", "cuda", None), ("card workers=1", "cuda", 1),
                                   ("cpu", "cpu", 1)):
        rt.resolve_cache_clear()
        tc, dt, launched = counted(lambda: train(
            [[rt.serial(small)]], fe_small, pop_size=TRAIN_CHECK_POP,
            generations=TRAIN_CHECK_GENS, seed=0, workers=workers, device=device))
        seen[label] = outcome(tc)
        if (device == "cpu") == bool(launched):
            fail(f"train check {label}: launches {launched}")
        print(f"train check C1 {len(small)} bytes {label}: wall seconds={dt}"
              f" {stats_line(tc)} objectives={seen[label][0]} launches={json.dumps(launched)}")
    if not seen["card"] == seen["card workers=1"] == seen["cpu"]:
        fail("train check: the card and the CPU trained different plans")
    print(f"check train C1 {len(small)} bytes: the card at the default workers and at one and"
          f" the CPU give equal objectives and {len(seen['cpu'][1])} equal plan files")

    # 5. a card fault ends training instead of scoring a genome
    fault = FaultPlan().at(TRAIN_FAULT_POINT)
    try:
        with fault.arm(all_threads=True):
            train([[rt.serial(a4[:TRAIN_FAULT_BYTES])]], fe_a, pop_size=4, generations=1,
                  seed=0)
        fail(f"train fault: {TRAIN_FAULT_POINT} armed and training finished")
    except InjectedDeviceFault as err:
        print(f"check train fault: {TRAIN_FAULT_POINT} raised {type(err).__name__}"
              f" out of train ({err}); fired {fault.fired}")

    missing = [k for k in TRAIN_KERNELS if not totals[k]]
    if missing:
        fail(f"train phase: never launched {missing}: {totals}")
    print(f"train launches {json.dumps(totals)}")
    print(f"train phase seconds={time.perf_counter() - t_phase}")
    return totals


def lm_numpy_tree(cfg, rng) -> dict:
    """A parameter tree of the transformer config ``cfg`` as float32 numpy
    arrays drawn from ``rng`` with ``init_params``'s distributions
    (normal(0, 0.02) embeddings, normal / sqrt(fan-in) matrices, unit norms),
    layers stacked on a leading ``n_layers`` axis."""
    D, H, KV, dh, F, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
                          cfg.n_layers)

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    layers = {"attn_norm": np.ones((L, D), np.float32), "mlp_norm": np.ones((L, D), np.float32),
              "wq": normal((L, D, H * dh), D ** -0.5), "wk": normal((L, D, KV * dh), D ** -0.5),
              "wv": normal((L, D, KV * dh), D ** -0.5), "wo": normal((L, H * dh, D), (H * dh) ** -0.5)}
    if cfg.n_experts:
        E = cfg.n_experts
        layers.update(router=normal((L, D, E), D ** -0.5), w_gate=normal((L, E, D, F), D ** -0.5),
                      w_up=normal((L, E, D, F), D ** -0.5), w_down=normal((L, E, F, D), F ** -0.5))
    else:
        layers.update(w_gate=normal((L, D, F), D ** -0.5), w_up=normal((L, D, F), D ** -0.5),
                      w_down=normal((L, F, D), F ** -0.5))
    tree = {"embed": normal((cfg.vocab, D), 0.02), "final_norm": np.ones(D, np.float32),
            "layers": layers}
    if not cfg.tie_embeddings:
        tree["lm_head"] = normal((D, cfg.vocab), D ** -0.5)
    return tree


def lm_side(tree_np, tokens, labels, cfg, device: str, decode: bool) -> dict:
    """On ``device``: the logits and loss of ``tree_np`` on ``tokens``, every
    gradient, one ``adamw`` step from a fresh state, and (``decode``) the
    logits of ``decode_step`` over the tokens one at a time -> flat dict of
    results keyed as the checkpoint keys them."""
    import torch
    from repro_torch.distributed import optimizer as opt
    from repro_torch.distributed.checkpoint import flatten_tree
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_numpy

    params = params_from_numpy(tree_np, device=device)
    toks = torch.from_numpy(tokens).to(device)
    batch = {"tokens": toks, "labels": torch.from_numpy(labels).to(device)}
    out = {}
    with torch.no_grad():
        out["logits"] = T.forward(params, toks, cfg)
    leaves = opt.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = T.loss_fn(leaves, batch, cfg)
    flat = flatten_tree(leaves)
    grads = torch.autograd.grad(loss, [t for _k, t in flat])
    out["loss"] = loss.detach()
    by_id = {id(t): g for (_k, t), g in zip(flat, grads)}
    out.update({f"grad/{k}": g for (k, _t), g in zip(flat, grads)})
    adam = opt.adamw(lr=LM_LR)
    new_p, state = adam.update(opt.tree_map(lambda t: by_id[id(t)], leaves), adam.init(params),
                               params)
    del leaves, flat, grads, by_id
    out.update({f"adamw/{k}": t for k, t in flatten_tree({"params": new_p, "m": state["m"],
                                                         "v": state["v"]})})
    if decode:
        B, S = tokens.shape
        with torch.no_grad():
            cache = T.init_kv_cache(cfg, B, S, device=device)
            steps = []
            for t in range(S):
                logits, cache = T.decode_step(params, cache, toks[:, t:t + 1], t, cfg)
                steps.append(logits)
        out["decode"] = torch.stack(steps, dim=1)
    if device == "cuda":
        torch.cuda.synchronize()
    return out


def lm_compare(label: str, card: dict, cpu: dict, cfg, decode_vs_forward: bool) -> None:
    """Hold the card's results against the CPU's (both on the card): logits,
    loss, decode within ``LM_ATOL``; each gradient within ``LM_GRAD_RTOL`` of
    its leaf's largest; the adamw step's m and v within ``LM_ADAM_ATOL``, its
    params too except where a gradient near 0 takes the sign the other side
    did not (``LM_SIGN_FLIP``).  Prints each largest absolute error."""
    import torch

    def err(a, b):
        return float((a.float() - b.float().to(a.device)).abs().max())

    errs = {k: err(card[k], cpu[k]) for k in ("logits", "loss")}
    grad_abs = grad_rel = 0.0
    flips = 0
    adam = {"params": 0.0, "m": 0.0, "v": 0.0}
    for key in card:
        if key.startswith("grad/"):
            want = cpu[key].to(card[key].device)
            e = err(card[key], want)
            grad_abs = max(grad_abs, e)
            grad_rel = max(grad_rel, e / max(float(want.abs().max()), 1e-30))
        elif key.startswith("adamw/params/"):
            leaf = key[len("adamw/params/"):]
            diff = (card[key].float() - cpu[key].float().to(card[key].device)).abs()
            g = cpu[f"grad/{leaf}"].to(diff.device).abs()
            moved = diff > LM_ADAM_ATOL
            flips += int(moved.sum())
            if bool((moved & (g >= LM_SIGN_FLIP * g.max())).any()) or \
                    float(diff.max()) > 2 * LM_LR + 1e-6:
                fail(f"lm {label}: adamw moved {leaf} by {float(diff.max())} where its"
                     " gradient is not near 0")
            adam["params"] = max(adam["params"], float(diff.masked_fill(moved, 0).max()))
        elif key.startswith("adamw/"):
            part = key.split("/")[1]
            adam[part] = max(adam[part], err(card[key], cpu[key]))
    if "decode" in card:
        errs["decode card vs cpu"] = err(card["decode"], cpu["decode"])
        if decode_vs_forward:
            errs["decode vs forward (card)"] = err(card["decode"], card["logits"])
    print(f"lm {label}: max_abs_err " + " ".join(f"{k}={v}" for k, v in errs.items())
          + f" grads: max_abs_err={grad_abs} max_rel_err={grad_rel} (of each leaf's largest)"
          f" adamw(lr={LM_LR}) step: m max_abs_err={adam['m']} v max_abs_err={adam['v']}"
          f" params max_abs_err={adam['params']} outside {flips} weights whose gradient"
          f" sits at a sign flip; tolerances logits {LM_ATOL['logits']} loss {LM_ATOL['loss']}"
          f" decode {LM_ATOL['decode']} grads {LM_GRAD_RTOL} relative adamw {LM_ADAM_ATOL}")
    for k, v in errs.items():
        tol = LM_ATOL["decode" if k.startswith("decode") else k]
        if not v <= tol:
            fail(f"lm {label}: {k} max_abs_err {v} above {tol}")
    if not grad_rel <= LM_GRAD_RTOL:
        fail(f"lm {label}: a gradient is {grad_rel} of its leaf's largest off the CPU's")
    if not max(adam.values()) <= LM_ADAM_ATOL:
        fail(f"lm {label}: the adamw step is {adam} off the CPU's")


def lm_phase(ops, seed: int):
    """The LM train and serve drivers on the card (``repro_torch.models``,
    ``repro_torch.launch``), after the train phase: Llama-3.2-1B's widths at
    one layer, then the reduced MoE and SWA archs, card against CPU
    (``lm_side``, ``lm_compare``); the train driver in-process at
    Llama-3.2-1B's full config crashed at step 4 (exit 42, step 3 saved),
    then resumed from step 3 and its data cursor to a final save at step 5,
    each save, restore and train step timed (the step-3 leaves held bit for
    bit against a host copy of what was saved, and those of
    ``LM_CPU_LEAVES`` and every leaf under ``LM_CPU_LEAF_BYTES`` against
    the frames' CPU decode); one ``python -m repro_torch.launch.serve``
    child from step 5.  The launch counts are reset just before the first
    train run and read just after the second -> each kernel's launches."""
    import contextlib
    import dataclasses
    import io
    import math
    import tempfile

    import torch
    from repro_torch.codecs import entropy
    from repro_torch.configs import get_arch
    from repro_torch.distributed import checkpoint as ck
    from repro_torch.launch import train as lm_train

    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("lm: TF32 matmul is on; the card would not meet the CPU in float32")
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 35)

    # 1. Llama-3.2-1B's widths at depth 1, batch 1, 16 tokens
    full = get_arch(LM_ARCH).model_cfg
    cfg = dataclasses.replace(full, n_layers=1, remat=False)
    t0 = time.perf_counter()
    tree = lm_numpy_tree(cfg, rng)
    tokens = rng.integers(0, cfg.vocab, (1, LM_TOKENS)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (1, LM_TOKENS)).astype(np.int32)
    t1 = time.perf_counter()
    card = lm_side(tree, tokens, labels, cfg, "cuda", decode=True)
    t2 = time.perf_counter()
    cpu = lm_side(tree, tokens, labels, cfg, "cpu", decode=True)
    t3 = time.perf_counter()
    lm_compare(f"{LM_ARCH} widths (d_model {cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads}"
               f" kv heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied, rope theta"
               f" {cfg.rope_theta}) at 1 layer, batch 1, {LM_TOKENS} tokens", card, cpu, cfg,
               decode_vs_forward=True)
    print(f"lm widths seconds: data={t1 - t0} card={t2 - t1} cpu={t3 - t2}")
    del card, cpu, tree

    # 2. the reduced MoE and SWA archs (the SWA one past its window)
    for arch, n in LM_REDUCED:
        rcfg = get_arch(arch).reduced_cfg
        tree = lm_numpy_tree(rcfg, rng)
        tokens = rng.integers(0, rcfg.vocab, (2, n)).astype(np.int32)
        labels = rng.integers(0, rcfg.vocab, (2, n)).astype(np.int32)
        card = lm_side(tree, tokens, labels, rcfg, "cuda", decode=True)
        cpu = lm_side(tree, tokens, labels, rcfg, "cpu", decode=True)
        # a full forward drops picks past an expert's capacity, one decoded
        # token never does: MoE decode is held against the CPU's decode only
        lm_compare(f"{arch} reduced ({rcfg.n_experts} experts top {rcfg.top_k},"
                   f" window {rcfg.sliding_window}) batch 2, {n} tokens", card, cpu, rcfg,
                   decode_vs_forward=not rcfg.n_experts)

    # 3. the train driver at full width: crash at step 4, resume to step 5
    saves, restores, steps, snapshot, capped = [], [], [], {}, []
    orig_save, orig_restore, orig_step = ck.save_checkpoint, ck.restore_tree, lm_train.train_step
    orig_capped = entropy._package_merge_lengths

    def counted_capped(*args):  # Huffman lengths the count flattening could not cap
        capped.append(1)
        return orig_capped(*args)

    def bits(t):
        return t.detach().reshape(-1).view(torch.uint8)

    def timed_save(directory, step, tree, metadata=None, *, device="cuda"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        capped.clear()
        t0 = time.perf_counter()
        manifest = orig_save(directory, step, tree, metadata, device=device)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        saves.append((step, dt, manifest, torch.cuda.max_memory_allocated(), len(capped)))
        if step == LM_SAVED:  # what was saved, kept on the host for the resume
            snapshot.update((k, t.detach().cpu()) for k, t in ck.flatten_tree(tree))
        return manifest

    def timed_restore(directory, like, step=None, *, device="cuda"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tree, manifest = orig_restore(directory, like, step, device=device)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        restores.append((manifest["step"], dt, manifest, torch.cuda.max_memory_allocated(), 0))
        if manifest["step"] == LM_SAVED:
            t1 = time.perf_counter()
            restored = dict(ck.flatten_tree(tree))
            if sorted(restored) != sorted(snapshot):
                fail(f"lm resume: restored leaves {sorted(restored)} are not the saved ones")
            for key, t in restored.items():
                if not torch.equal(bits(t.cpu()), bits(snapshot[key])):
                    fail(f"lm resume: leaf {key} differs from what was saved")
            step_dir = os.path.join(directory, f"step_{LM_SAVED:010d}")
            on_cpu = 0
            for leaf in manifest["leaves"]:
                if leaf["raw_bytes"] >= LM_CPU_LEAF_BYTES and leaf["key"] not in LM_CPU_LEAVES:
                    continue
                with open(os.path.join(step_dir, leaf["file"]), "rb") as f:
                    want = ck.decompress_leaf(f.read(), leaf["shape"], leaf["dtype"],
                                              device="cpu")
                if not torch.equal(bits(restored[leaf["key"]].cpu()), bits(want)):
                    fail(f"lm resume: leaf {leaf['key']} differs from its frame's CPU decode")
                on_cpu += leaf["raw_bytes"]
            print(f"check lm resume: all {len(restored)} step-{LM_SAVED} leaves"
                  f" ({manifest['raw_bytes']} bytes) restored on the card equal what was saved,"
                  f" bit for bit; {on_cpu} bytes of them also equal their frames' CPU decode"
                  f" (host seconds {time.perf_counter() - t1})")
            snapshot.clear()
        return tree, manifest

    def timed_step(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_step(*args, **kw)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        return out

    def run(argv, label):
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = lm_train.main(argv)
        finally:
            for line in buf.getvalue().splitlines():
                print(f"lm train {label} | {line}")
        return rc, buf.getvalue(), time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="chip-smoke-lm-") as tmp:
        ckpt, data = os.path.join(tmp, "ckpt"), os.path.join(tmp, "data")
        argv = [*LM_TRAIN_ARGS, "--ckpt-dir", ckpt, "--data-dir", data]
        ck.save_checkpoint, ck.restore_tree, lm_train.train_step = (timed_save, timed_restore,
                                                                    timed_step)
        entropy._package_merge_lengths = counted_capped
        try:
            torch.cuda.synchronize()
            ops.reset_launches()
            rc1, out1, wall1 = run(argv + ["--fail-at-step", str(LM_FAIL_AT)], "crash")
            torch.cuda.empty_cache()
            rc2, out2, wall2 = run(argv, "resume")
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        finally:
            ck.save_checkpoint, ck.restore_tree, lm_train.train_step = (orig_save, orig_restore,
                                                                        orig_step)
            entropy._package_merge_lengths = orig_capped
        if rc1 != 42 or f"[failure-sim] crashing at step {LM_FAIL_AT}" not in out1:
            fail(f"lm train: the crash run returned {rc1}")
        if [s for s, *_ in saves] != [LM_SAVED, LM_LAST] or rc2 != 0:
            fail(f"lm train: saves {[s for s, *_ in saves]}, resume returned {rc2}")
        cursor = saves[0][2]["metadata"]["data_cursor"]
        resumed = re.search(rf"^\[resume\] restored step {LM_SAVED} .*data cursor (\d+)$", out2,
                            re.M)
        if not resumed or int(resumed.group(1)) != cursor:
            fail(f"lm train: no resume from step {LM_SAVED} at its data cursor {cursor}")
        if f"[done] {LM_LAST} steps" not in out2 or [s for s, *_ in restores] != [LM_SAVED]:
            fail("lm train: the resume did not end with its final save")
        losses = [float(v) for v in re.findall(r"^step\s+\d+ loss (\S+)", out1 + out2, re.M)]
        if len(losses) != LM_FAIL_AT + LM_LAST - LM_SAVED or not all(map(math.isfinite, losses)):
            fail(f"lm train: losses {losses}")
        tokens_per_step = 8 * 64  # launch.train's --batch and --seq defaults
        steady = steps[1:LM_FAIL_AT] + steps[LM_FAIL_AT + 1:]  # each run's first step left out
        for label, items in (("save", saves), ("restore", restores)):
            for step, dt, m, peak, n_capped in items:
                print(f"lm {label} step {step}: {len(m['leaves'])} leaves raw_bytes={m['raw_bytes']}"
                      f" compressed_bytes={m['compressed_bytes']} ratio={m['ratio']}"
                      f" seconds={dt} MBps={m['raw_bytes'] / dt / 1e6}"
                      f" peak_allocated_GB={peak / 1e9} package_merge_calls={n_capped}")
        print(f"lm train: {full.n_layers} layers, remat={full.remat}, {tokens_per_step} tokens a"
              f" step; step seconds {steps}; tokens_per_s"
              f" {[tokens_per_step / dt for dt in steps]}; steady (each run's first step left"
              f" out) tokens_per_s={tokens_per_step * len(steady) / sum(steady)};"
              f" losses {losses}; crash run wall seconds={wall1}, resume run {wall2}")

        # 4. serve from step 5, as a user starts it
        torch.cuda.empty_cache()
        env = {**os.environ, "PYTHONPATH": os.path.join(HERE, "src")}
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *LM_SERVE_ARGS,
                                "--ckpt-dir", ckpt], capture_output=True, text=True, cwd=tmp,
                               env=env, timeout=LM_SERVE_TIMEOUT)
        wall = time.perf_counter() - t0
    for line in child.stdout.splitlines():
        print(f"lm serve child | {line}")
    if child.returncode:
        fail(f"lm serve child: exit {child.returncode}: {child.stderr.strip()[-800:]}")
    prefill = re.search(r"prefill: (\d+) tokens in (\S+)s \((\d+) tok/s", child.stdout)
    decode = re.search(r"decode:\s+(\d+) tokens in (\S+)s \((\d+) tok/s", child.stdout)
    cache_mb = re.search(r"kv-cache: (\S+) MB \(linear\)", child.stdout)
    want_mb = 2 * full.n_layers * 8 * 64 * full.n_kv_heads * full.d_head * 4 / 1e6
    if f"[serve] loaded checkpoint step {LM_LAST}" not in child.stdout or not (
            prefill and decode and cache_mb) or abs(float(cache_mb.group(1)) - want_mb) > 0.05:
        fail(f"lm serve child: {child.stdout[-800:]}")
    print(f"lm serve child: wall seconds={wall} (start-up, init and the restore of all"
          f" {restores[0][2]['raw_bytes']} bytes included), prefill tok/s={prefill.group(3)},"
          f" decode tok/s={decode.group(3)}, kv-cache MB={cache_mb.group(1)} (expected {want_mb})")
    missing = [k for k in LM_KERNELS if not launches[k]]
    if missing:
        fail(f"lm phase: never launched {missing}: {launches}")
    print(f"lm launches {json.dumps(launches)}")
    print(f"lm phase seconds={time.perf_counter() - t_phase}")
    return launches


def level_sources(cols) -> dict:
    """The level-7 phase's columns by name: ``cols`` and H_tiled_f32."""
    d = cols["D_weights_f32"]
    return {**cols, "H_tiled_f32": np.resize(d[:TILE_VALUES], PREFIX_BYTES // d.itemsize)}


def level_phase(cols, rt, ops) -> None:
    """The level-7 path on the card: each of ``LEVEL_COLUMNS`` through
    ``compress`` and back through ``decompress``, with the launch counts reset
    just before and read just after each half; each frame must equal the
    CPU's, decode to its prefix on the card, and record the host leaf named
    beside it; then one profiled compress and decompress per plan."""
    import torch

    ctx = rt.CompressionCtx(level=LEVEL)
    sources = level_sources(cols)
    plans = {pname: PLANS[pname](rt) for _, pname, _ in LEVEL_COLUMNS}
    prefixes = {cname: sources[cname][: PREFIX_BYTES // sources[cname].itemsize]
                for cname, _, _ in LEVEL_COLUMNS}
    for cname, pname, _ in LEVEL_COLUMNS:  # warm-up on 64 KiB, outside the counted run
        small = prefixes[cname][: (1 << 16) // prefixes[cname].itemsize]
        rt.decompress(rt.compress(plans[pname], stream_of(rt, cname, small), ctx,
                                  device="cuda"), device="cuda")
    torch.cuda.synchronize()
    frames = {}
    ops.reset_launches()
    for cname, pname, _ in LEVEL_COLUMNS:
        rt.resolve_cache_clear()  # resolved afresh, as the CPU's frame below is
        t0 = time.perf_counter()
        frames[cname, pname] = rt.compress(plans[pname], stream_of(rt, cname, prefixes[cname]),
                                           ctx, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"level{LEVEL} {cname} {pname} [{frame_codecs(rt, frames[cname, pname])}]:"
              f" bytes={prefixes[cname].nbytes}"
              f" ratio={prefixes[cname].nbytes / len(frames[cname, pname])}"
              f" compress_MBps={prefixes[cname].nbytes / dt / 1e6} seconds={dt}")
    encode = ops.launch_counts()
    print(f"level{LEVEL} launches {json.dumps(encode)}")
    outs = {}
    ops.reset_launches()
    for key, frame in frames.items():
        t0 = time.perf_counter()
        (outs[key],) = rt.decompress(frame, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"level{LEVEL} decode {key[0]} {key[1]}:"
              f" decompress_MBps={prefixes[key[0]].nbytes / dt / 1e6} seconds={dt}")
    decode = ops.launch_counts()
    print(f"level{LEVEL} decode launches {json.dumps(decode)}")
    missing = ([k for k in LEVEL_ENCODE_KERNELS if encode[k] == 0]
               + [k for k in LEVEL_DECODE_KERNELS if decode[k] == 0])
    if missing:
        fail(f"the level-{LEVEL} path never launched {missing}")
    for cname, pname, leaf in LEVEL_COLUMNS:
        prefix, frame, out = prefixes[cname], frames[cname, pname], outs[cname, pname]
        if out.data.device.type != "cuda" or out.content_bytes() != prefix.tobytes():
            fail(f"level {LEVEL} {cname} {pname}: decompress on the card did not return the prefix")
        if frame != cpu_frame(rt, plans[pname], stream_of(rt, cname, prefix), ctx):
            fail(f"level {LEVEL} {cname} {pname}: the card's frame differs from the CPU's")
        codecs = frame_codecs(rt, frame)
        if FRAME_CODECS.get((cname, pname), codecs) != codecs:
            fail(f"level {LEVEL} {cname} {pname}: the frame records {codecs}")
        if leaf is not None and leaf not in codecs.split("+"):
            fail(f"level {LEVEL} {cname} {pname}: the frame records {codecs}, no {leaf}")
        print(f"check level{LEVEL} {cname} {pname}: roundtrip on the card ok,"
              f" card frame == cpu frame ({len(frame)} bytes)")
    for (cname, pname), frame in frames.items():
        stream = stream_of(rt, cname, prefixes[cname])
        codecs = frame_codecs(rt, frame)
        profile_call(f"level{LEVEL} {cname} {pname} [{codecs}]",
                     lambda: rt.compress(plans[pname], stream, ctx, device="cuda"))
        profile_call(f"level{LEVEL} decompress {cname} {pname} [{codecs}]",
                     lambda: rt.decompress(frame, device="cuda"))


def card_frame(rt, *args, **kw) -> bytes:
    """The card's frame, resolved from an empty resolve cache (see
    ``cpu_frame``): an entry of an earlier stream of the same shape would
    otherwise choose its plan."""
    rt.resolve_cache_clear()
    return rt.compress(*args, device="cuda", **kw)


def cpu_frame(rt, *args, **kw) -> bytes:
    """The CPU's frame, resolved from an empty resolve cache.  Selector trials
    consult the cache: a CPU call that found the card call's entries there
    would reuse the card's choices, and its frame would equal the card's
    whatever the CPU's trials gave."""
    rt.resolve_cache_clear()
    return rt.compress(*args, device="cpu", **kw)


def frame_codecs(rt, frame: bytes) -> str:
    """The codecs a frame records, in execution order."""
    from repro_torch.core.codec import get_codec_by_id
    from repro_torch.core.wire import read_frame

    return "+".join(get_codec_by_id(node.codec_id).name for node in read_frame(frame)[2])


def profile_phase(cols, frames, rt, container_calls, record_calls, csv_calls,
                  graph_calls) -> None:
    """Where one compress and one decompress call's time goes: the card's busy
    time from ``torch.profiler`` (its kernels, by name) and the host's time
    from ``cProfile`` (its functions, by cumulative time) in a second call
    (``profile_call``); the main and
    decode phases' calls, summed per kernel, then the container phase's, the
    records phase's, the CSV phase's and the graph phase's."""
    plans = {name: make(rt) for name, make in PLANS.items()}
    sums = {"compress": {}, "decompress": {}}
    for cname, pname in column_plans(cols):
        plan, frame = plans[pname], frames[cname, pname]
        stream = stream_of(rt, cname, cols[cname])
        codecs = frame_codecs(rt, frame)
        for way, fn in (("compress", lambda: rt.compress(plan, stream, device="cuda")),
                        ("decompress", lambda: rt.decompress(frame, device="cuda"))):
            label = f"{cname} {pname} [{codecs}]"
            ours = profile_call(label if way == "compress" else f"decompress {label}", fn)
            for k, ms in ours.items():
                sums[way][k] = sums[way].get(k, 0.0) + ms
    total = {k: sums["compress"].get(k, 0.0) + sums["decompress"].get(k, 0.0)
             for k in {**sums["compress"], **sums["decompress"]}}
    print(f"profile sums, device ms per kernel over the {len(frames)} compress and"
          f" {len(frames)} decompress calls: {json.dumps(dict(sorted(total.items())))}"
          f" compress: {json.dumps(sums['compress'])} decompress: {json.dumps(sums['decompress'])}")
    tagged = ([("container", c) for c in container_calls]
              + [("records", c) for c in record_calls] + [("csv", c) for c in csv_calls]
              + [("graph", c) for c in graph_calls])
    for phase, (label, pname, plan, stream, chunk_bytes, frame, codecs) in tagged:
        tag = f"{phase} {label} {pname} chunk_bytes={chunk_bytes} [{codecs}]"
        profile_call(tag, lambda: rt.compress(plan, stream, device="cuda",
                                              chunk_bytes=chunk_bytes))
        profile_call(f"decompress {tag}", lambda: rt.decompress(frame, device="cuda"))


def profile_call(label: str, fn) -> dict:
    """``fn`` once under ``profile_device`` and once under ``profile_host``
    -> the port's kernels' device ms.  The passes are apart, so that the
    wall ms and idle share carry no cProfile overhead."""
    ours, _, _ = profile_device(label, fn)
    profile_host(label, fn)
    return ours


def profile_device(label: str, fn, into=None):
    """One call of ``fn`` under torch.profiler: prints its wall ms, the card's
    busy ms and idle share, the top device rows and the port's kernels' ms
    (also into the dict ``into``, where one is given) -> (kernels' ms,
    ``fn()``'s result, wall seconds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels and copies as the card ran them (op-level rows would count the
    # same time twice; the buffer request is the tracer's own)
    averages = prof.key_averages()  # one pass over the trace's events
    dev = [
        (e.self_device_time_total / 1e3, e.key[:48])
        for e in averages
        if e.device_type == DeviceType.CUDA and e.key != "Activity Buffer Request"
    ]
    busy_ms = sum(ms for ms, _ in dev)
    top = ", ".join(f"{k}={ms:.3f}" for ms, k in sorted(dev, reverse=True)[:5])
    ours = {}
    for ms, k in dev:
        m = PORT_KERNEL.match(k)
        if m:
            ours[m.group(1)] = ours.get(m.group(1), 0.0) + ms
    for e in averages:  # launches and ms of K13's two configurations
        m = PORT_KERNEL.match(e.key) if e.device_type == DeviceType.CUDA else None
        if m and m.group(2) in HIST_CONFIGS:
            name = HIST_CONFIGS[m.group(2)]
            ours[name] = ours.get(name, 0.0) + e.self_device_time_total / 1e3
            ours[name + " launches"] = ours.get(name + " launches", 0) + e.count
    print(f"profile {label}: wall_ms={wall_ms} device_busy_ms={busy_ms}"
          f" idle_share={1 - busy_ms / wall_ms} top_device_ms: {top}"
          f" port_kernels_ms: {json.dumps(ours)}")
    if into is not None:
        into.update(wall_ms=wall_ms, busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms)
    return ours, out, wall_ms / 1e3


def profile_host(label: str, fn):
    """One call of ``fn`` under cProfile: prints the host's top functions by
    self ms and the named host stages' cumulative ms -> ``fn()``'s result."""
    import cProfile
    import pstats

    import torch

    host = cProfile.Profile()
    host.enable()
    out = fn()
    torch.cuda.synchronize()
    host.disable()
    stats = pstats.Stats(host).stats  # (file, line, name) -> (cc, nc, tottime, cumtime, ..)
    rows = sorted(
        ((v[2] * 1e3, f"{os.path.basename(k[0])}:{k[2]}") for k, v in stats.items()),
        reverse=True,
    )
    cum = {k[2]: v[3] * 1e3 for k, v in stats.items() if k[2] in HOST_STAGES}
    print(f"profile {label} host_self_ms: "
          + ", ".join(f"{name}={ms:.1f}" for ms, name in rows[:8])
          + f" host_cumulative_ms: {json.dumps(cum)}")
    return out


def nvidia_smi(query: str) -> str:
    """The first card's line of ``nvidia-smi --query-gpu=<query>``."""
    smi = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch as rt
    from repro_torch.codecs import entropy
    from repro_torch.kernels import _build, ops, ref

    t_run = t0 = time.perf_counter()
    _build.library()
    print(f"build seconds={time.perf_counter() - t0} (compile {_build.build_seconds})")
    for text in _build.build_log:
        for line in text.splitlines():
            if "registers" in line or line.startswith("=="):
                print(f"build {line.strip()}")

    max_sm = nvidia_smi("clocks.max.sm")
    sm_hz = float(max_sm.split()[0]) * 1e6
    print(f"card max SM clock {max_sm}")

    t0 = time.perf_counter()
    cols = columns(args.seed)
    print(f"data seconds={time.perf_counter() - t0} seed={args.seed}")
    t0 = time.perf_counter()
    rows = kernel_phase(cols, rt, ops, ref, entropy, args.seed, sm_hz)
    print(f"kernel phase seconds={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    launches, frames = main_path(cols, rt, ops)
    launches.update({k: v for k, v in decode_phase(cols, frames, rt, ops).items()
                     if k not in ENCODE_KERNELS})
    print(f"main and decode phases seconds={time.perf_counter() - t0}")
    container_calls, container_launches = container_phase(cols, rt, ops)
    record_calls, records_launches = records_phase(rt, ops, args.seed)
    csv_calls, csv_launches = csv_phase(rt, ops, args.seed)
    graph_calls, graph_launches = graph_phase(rt, ops, args.seed)
    sessions_launches, sessions_typed = sessions_phase(cols, graph_calls, rt, ops)
    checkpoint_launches, checkpoint_typed = checkpoint_phase(rt, ops, args.seed)
    cli_launches, cli_typed, cli_ratios = cli_phase(cols, csv_calls, rt, ops)
    service_launches, service_out = service_phase(cols, rt, ops)
    frontend_launches = frontend_phase(cols, rt, ops, service_out)
    signatures_launches = signatures_phase(
        cols, frames, rt, ops,
        {"container": container_calls, "records": record_calls, "csv": csv_calls,
         "graph": graph_calls},
        sessions_typed + checkpoint_typed + cli_typed + service_out["typed"])
    train_launches = train_phase(cols, frames, record_calls, csv_calls, graph_calls, cli_ratios,
                                 rt, ops)
    lm_launches = lm_phase(ops, args.seed)
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["container_launches"] = container_launches[r["name"]]
        r["records_launches"] = records_launches[r["name"]]
        r["csv_launches"] = csv_launches[r["name"]]
        r["graph_launches"] = graph_launches[r["name"]]
        r["sessions_launches"] = sessions_launches[r["name"]]
        r["checkpoint_launches"] = checkpoint_launches[r["name"]]
        r["cli_launches"] = cli_launches[r["name"]]
        r["service_launches"] = service_launches[r["name"]]
        r["frontend_launches"] = frontend_launches[r["name"]]
        r["signatures_launches"] = signatures_launches[r["name"]]
        r["train_launches"] = train_launches[r["name"]]
        r["lm_launches"] = lm_launches[r["name"]]
    t0 = time.perf_counter()
    level_phase(cols, rt, ops)
    print(f"level7 phase seconds={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    profile_phase(cols, frames, rt, container_calls, record_calls, csv_calls, graph_calls)
    print(f"profile phase seconds={time.perf_counter() - t0}")
    identity = nvidia_smi("name,power.limit")
    print(f"run seconds={time.perf_counter() - t_run} (the build included)")
    print(json.dumps({"kernels": rows}))
    print(identity)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
