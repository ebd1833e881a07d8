#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with an NVIDIA Hopper card and the CUDA toolkit. It imports nothing of JAX
or of the JAX package. Fifteen phases (phases 13 to 15 run before the
report, phase 12); any failure exits non-zero:

1. **Kernels.** Builds ``kernels/csrc/codec_{int8,int4,fp8}.cu``,
   ``flash_decode.cu``, ``rwkv6_wkv.cu``, ``mamba_scan.cu`` and
   ``staging.cu`` with nvcc (sm_90a), one compiler process each, all at
   once, and holds each of the six codec
   kernels against its plain PyTorch version on the card, bitwise
   (tolerance 0): encodes at (16, 131072) and (8, 131072) (the main path's
   encode and re-encode), (16, 524288) (fp8 walks its rows twice), (3,
   1000), (1, 256), (2, 131070) and a (16, 131072) view one float past a
   16-byte boundary (the scalar paths), with and without the carried
   error, plus rows with subnormal e4m3 outputs, signed zeros, a NaN and
   +-inf among finite values (wire bytes bitwise in every block, NaN
   blocks included; scales and residuals bitwise where the plain one is
   a number, NaN at the same positions);
   decode-reduce over W in {1, 2, 3, 5, 8, 9, 17} (3, 5, 9 and 17
   outside the kernels' unrolled peer counts), at the compressed
   reduce_scatter's (8, 2, 524288), at the last gradient bucket's rows of
   7800 (fp8: wire rows of 8-byte, not 16-byte multiples) and at lengths
   1000, 999 and 1001 (rows of the output that do not start 16-byte
   aligned; fp8 wire rows that are no multiple of 8 bytes), each decoded
   whole and 3 short, and with the wire copied 1 and 3 bytes into a
   buffer (a contiguous view at an odd address: int4 and fp8 must take
   it, bitwise; the int8 wrapper must refuse it, launching nothing), int4
   also 2 and 4 bytes in (its byte reads, and its 4-byte reads at an
   address that is no multiple of 8). The flash-decode kernel is held
   against its plain version within ``FLASH_TOL * (1 + |plain|)`` (both
   fp32 from the same inputs) at the serving shapes: B 8, H 15, KV 5, hd 64
   (smollm), H 64, KV 8, hd 128 (jamba) and H 4, KV 2, hd 32 (the reduced
   config), S 2048 and 1000, bf16 and fp32, for (B,) lengths (all S, all 1,
   mixed) and scalar lengths 1, S // 3, S and 0.
   The split-S grid's own edges are held too: every split boundary +-1
   of the kernel's split count and lengths 0 and -3, at smollm's and
   jamba's shapes with B 8 and B 1 (the most splits); the combine tickets
   must be back at zero. The WKV6 kernels (the tick kernel below 16
   steps, the chunked one from 16) are held against their plain version
   within ``RWKV_TOL * (1 + |plain|)`` on y and the final state at the
   rwkv6-1.6b decode tick (B 8, T 1, H 32, hd 64), at prefills (B 1, T
   1024 and 1000), at the reduced config (H 4, hd 32, T 7 and 130) and
   the tick kernel at hd 20 and 128 (1 and 9-12 steps), bf16 and fp32, s0
   zero and random, and with the final state written over s0; the tick
   kernel also at the decode tick and at 7 steps, hd 20, and the chunked
   one alone at 15, 16 and 17 steps and at hd 20, with a tenth of the
   decays exactly 0 or subnormal; the recurrent kernel (reached only by
   ``rwkv6_wkv_recurrent``) at the decode tick and at T 130. The scan
   kernel is
   held against its plain version within ``MAMBA_TOL * (1 + |plain|)`` on
   y and the final state at the jamba decode tick (B 8, T 1, Di 16384, N
   16), at prefills (B 1, T 1024 and 1000), at the reduced config (Di
   256), at N 5 and 32 (the kernel's padded and widest lane splits) and
   at Di 200 (no CTA's 32 channels divide it), bf16 and fp32 x, h0 none
   and random, and with the final state written over h0. Times each kernel
   and its plain version at the main paths' shapes (median of 20 runs, CUDA
   events around device work only, L2 flushed between runs; the scan kernel
   at the decode tick and at a 1024-step prefill, the WKV6 tick kernel at
   the decode tick, the recurrent one at both, the chunked one at the
   prefill with its two passes profiled,
   the scan's bound with its SFU term at the card's SM clock), and for
   flash decode (smollm's and
   jamba's shapes)
   also one ``scaled_dot_product_attention`` call as the library yardstick
   (no single PyTorch call computes the WKV6 recurrence or the scan). For
   the scan, the WKV6 tick and recurrent kernels at the decode tick and
   the six codec kernels it also records CUPTI's time of the
   kernel alone (L2 flushed) and the events' own floor, the events' time
   of a one-element fill; each decode-reduce kernel also at the
   compressed reduce_scatter's (8, 2, 524288): events, CUPTI and its
   bytes bound; each encode also at the (8, 131072) re-encode (events,
   CUPTI, bytes bound) and with the carried error, fp8's with its cluster
   plan. ``--parent DIR`` (a checkout of the parent commit): the parent's
   encodes are built from its sources into a fresh directory outside the
   repository, held bitwise to this tree's and timed beside them.
   The staging kernels are held bitwise against their plain versions:
   pip_mcoll allgather's step-6 buffer V (8, 2, 4·m) rolled by the node
   index and Bruck's (8, 8, m) rolled by the rank at 8 B and 4 MiB per
   rank, the ring's per-rank take, the multi-object round's flat source
   map (-1 where no rank sends) over the sliced ``V[:, :1]``, a full shift
   map over a slice (both maps recorded from what ``ppermute`` hands the
   kernel in one pip_mcoll and one Bruck allgather), float32, bf16, int8, uint64 and bool rows of lengths
   that are no multiple of 16 B (whole, sliced and strided sources), and
   zero-size operands (no launch). They are timed at those shapes as the
   others are, each beside its bytes bound, its plain version and one
   PyTorch call as the yardstick: advanced indexing for the roll and the
   per-rank take, ``index_select`` for the flat pack.
   The fused AdamW kernel (``adamw.cu``, built with the others; no Pallas
   original: the reference's AdamW is plain ``jnp``) is held bitwise
   against the plain passes (``ref.adamw_update``) on ``m``, ``v``, the
   master and the stored weights in ``ADAMW_CASES``: bf16 and float32
   weights, decay and master on and off, leaves at flat offsets 1-3
   (scalar heads and tails), qwen3-moe's largest leaf; then timed at that
   leaf and at a smollm-360m layer's wq (events and CUPTI, L2 flushed)
   beside the plain passes and its bytes bound. Its launches are counted
   over phases 9, 13 and 14, each more than 0 (``launches_by_path``).
2. **Slice.** The full-width smollm-360m gradient sync: 409,007,040
   float32 gradients per rank on ``RankGrid(2, 4, "cuda")``, 4 MiB buckets
   (391), one persistent ``pip_mcoll`` carry op per bucket with error
   feedback (``OverlappedGradSync``): two steps each under ``int8_block``
   (budget 0.5/127), ``int4_block`` (0.5/7) and ``fp8_sim`` (2^-4), one
   sync released before the next is built (no staging launch: the
   compressed allreduce moves no rows). Every bucket's sum must lie
   within ``collective_tolerance(codec, "allreduce", 8, A)`` of the
   float64 sum of the collective's input rows (gradient plus carried error;
   ``A`` their max-abs). Launch counts are zeroed just before each run and
   must equal 2 encodes and 1 decode-reduce per bucket per step (782 and
   391 a step; fp8's encode is one ``fp8_encode`` launch, no amax pass).
   One more step
   of each runs under ``torch.profiler``. Under ``int8_block`` one more
   step runs untraced and one with telemetry on, both timed: the traced
   step must leave one start->wait window per bucket (391), each on its
   own ``bucket:<i>`` track inside the step's ``train/sync`` span, its
   Chrome trace exported to ``build/grad_sync_trace.json`` must load back
   equal, and ``telemetry.snapshot()`` must hold one sampled
   error-feedback and one achieved-ratio observation per bucket. Then one
   lossless ``algo="auto"``
   bucket sync, and one full-width pass of ``comm.reduce_scatter(bucket,
   algo="pip_mcoll", codec=c)`` over all 391 buckets for each codec: within
   ``collective_tolerance(c, "reduce_scatter", 8, A)`` of the float64 sum,
   exactly one decode-reduce launch per bucket; then one more pass over
   the first 16 buckets under ``torch.profiler`` (the decode-reduce's time
   per launch on that path). Peak memory must stay under 50 GB.
3. **Collectives.** Every (collective, algorithm) pair through the
   ``Communicator`` on the 2x4 grid at per-rank sizes 8 B, 64 KiB and
   4 MiB of float32 and 64 KiB of int32; chunk-capable algorithms also at
   ``chunks=3``; codec-capable ones also under the three codecs (float32).
   Oracles by plain indexing on the card: data movement bitwise, reductions
   within ``8 * 2**-23 * sum|x|``, compressed gathers, exchanges, broadcasts
   and scatters bitwise equal to ``decode(encode(.))`` of the source rows,
   compressed reductions within the codec's collective tolerance. The
   staging counts are zeroed before each checked call and read after it:
   more than 0 for every plan that moves rows (``oracles.moves_rows``), 0
   for the others (the compressed allreduce among them). One line per pair
   with its median host-clock time per call at 8 B and 4 MiB and its
   staging launches at 8 B; one profiled pip_mcoll allgather at 8 B and 4
   MiB gives the staging kernels' device time per launch on the path.
4. **Serving smollm-360m.** Full width (bf16, random weights from a seeded
   ``torch.Generator``) served by ``Engine(max_batch=8, max_len=2048,
   flags=RunFlags(use_flash_decode=True), mesh=RankGrid(2, 4))`` with
   the default devices, as the README's serving example builds them:
   16 requests with prompt lengths drawn from a numpy seed in [64, 1024],
   32 new tokens each. Every request must return 32 tokens within the
   vocab; every kernel count is zeroed just before the run and read just
   after: flash-decode launches must equal ticks x 32 layers, the staging
   launches ticks x those of one call of the run's persistent sync op made
   alone (more than 0 exactly when the plan moves rows:
   ``oracles.moves_rows``), every other
   kernel's 0; the persistent sync op must start once per tick with no
   rebind, and the tokens must equal a sync-free engine's on the same
   weights, bitwise. Three teacher-forced ticks on the same caches hold
   every layer's flash-decode output within ``FLASH_TOL * (1 + |plain|)``
   of the plain version on that layer's own operands (the live cache and
   (B,) lengths), and the kernel path's logits within ``TEACHER_TOL``
   times the largest logit of the plain-version path's (a guard against
   gross path faults only: the kernel's precision is held by the per-layer
   check). Records prefill and tick times (host clock), tokens per second,
   one profiled decode tick (device busy, idle share, top device kernels,
   flash-decode time per launch), peak device memory and the plan the tick
   sync resolved to. This phase passes the engine's ``sync_algo="auto"``
   and ``sync_error_budget=0.0`` explicitly, and measures the telemetry
   hooks' cost, telemetry off, on the tick sync's persistent broadcast:
   under ``HOOK_LIMIT`` (2%) against a stripped copy of ``start`` and
   ``wait`` without them, the min over ``HOOK_BLOCKS`` blocks of the
   medians of ``HOOK_PAIRS`` interleaved pairs.
5. **Serving rwkv6-1.6b.** The same run for the attention-free family:
   full-width rwkv6-1.6b (24 layers, d 2048, 32 heads of 64; bf16, seeded
   random weights) served by ``Engine(max_batch=8, max_len=2048,
   flags=RunFlags(use_rwkv_kernel=True), mesh=RankGrid(2, 4))``, the same
   16 requests. The tick kernel's WKV6 launches must equal 24 x ticks,
   the chunked ones 24 x 16 prefills and the recurrent kernel's 0,
   the staging launches as in phase 4, every other kernel's 0; the tick
   sync and the sync-free tokens as in phase 4. The prefill of the longest
   prompt and three teacher-forced ticks hold every layer's WKV6 call
   within ``RWKV_TOL * (1 + |plain|)`` of the plain version on its own
   operands (the live state and that layer's r, k, v, w), and the kernel
   path's logits within ``TEACHER_TOL`` times the largest logit of the
   plain recurrence's. Records as phase 4,
   plus one profiled prefill of the longest prompt.
6. **Serving jamba.** Full-width jamba-1.5-large cut to its first five
   layers (mamba+FFN, mamba+MoE, mamba+FFN, mamba+MoE, attention+FFN; d
   8192, 64 heads of 128, 8 KV heads, 16 experts top-2 of d_ff 24576, Di
   16384; bf16, seeded random weights, some 48 GB) served by
   ``Engine(max_batch=8, max_len=2048, flags=RunFlags(use_flash_decode=
   True, use_mamba_kernel=True), mesh=RankGrid(2, 4))``, the earlier
   phases' memory freed first, the same 16 requests. The scan launches
   must equal 4 x (ticks + 16 prefills), the flash-decode launches the
   ticks, the staging launches as in phase 4, every other kernel's 0; the
   tick sync and the sync-free tokens as in phase 4. The prefill of the
   longest prompt and three teacher-forced ticks hold every mamba layer's
   scan within ``MAMBA_TOL * (1 + |plain|)`` of the plain version on its
   own operands, and the kernel path's logits within ``TEACHER_TOL`` times
   the largest logit of the plain-version path's (the plain scan and flash
   decode's plain version). Records as phase 5, each profile with the device-time shares
   of the MoE's expert products, the other matrix products, the scan and
   flash decode.
7. **Calibration.** ``Communicator(RankGrid(2, 4)).calibrate(
   include_splits=True, sizes=(8, 4 MiB))`` into a selector of its own,
   with telemetry on: every plan of every collective, timed on the host
   clock around a device synchronize, on the root and on the
   ``("node",)``, ``("local",)`` and ``("node", "local")`` groups; every
   timed sample must be one synced plan observation (rows x 10). Each
   lattice member's ``comm.plan`` at each size must resolve from
   measurement to its lossless argmin, and so must the table saved and
   loaded back. One ``calibrate`` line per (group, collective, size) with
   every measured plan's median. The artifact's calibrate sections
   (``topology``, ``sizes``, ``backend``, ``process_count``, ``table``,
   ``latency_rows``, ``model_vs_measured`` with ``per_plan`` rows) must
   validate under the port's schema (``core/artifact.py``) and are written
   to ``build/calibration_artifact.json``. A fresh fit of the link preset
   to the lossless rows (``costmodel.fit_net``) is printed beside the
   checked-in ``h100_grid`` in one ``calibrate_fit`` line, with the count
   of cells where the prior's argmin equals the measured one and the
   median |signed_rel_err| under the checked-in preset, the fresh fit and
   ``host_cpu`` on the same rows. Then drift and repair (one ``drift``
   line): the slowest lossless allreduce plan at 4 MiB gets a 1e-9 s row
   and ``choose`` must take it; run through a persistent op with blocking
   waits, ``drift_report`` must flag it (``drift_vs_table > 0.5``), and
   after ``Selector.ingest`` ``choose`` must give the measured argmin
   again.
8. **Two processes on the card.** The ``torch.distributed`` transport:
   the card's compute mode is printed (``Exclusive_Process`` fails the
   phase). The parent's ``RankGrid(2, 4)`` runs every (collective,
   algorithm) pair at 8 B and 4 MiB per rank on numpy-seeded float32
   (a -0.0 on rank 0) and int32, each codec-capable pair under the three
   codecs and each compressed allreduce also with an error-feedback carry
   (148 cases), keeping a sha256 of every result row, and one full-width
   smollm-360m ``int8_block`` sync step with error feedback (each rank's
   gradient from a generator seeded by its global rank), keeping an int64
   digest of each bucket's output and new-error rows and holding every
   bucket within its tolerance; then it frees the card's memory. Two
   workers (``distributed.launch.run``, the kernels already built) each
   hold four ranks of ``launch.mesh.make_process_grid()`` on the card, the
   node axis over the ``"shm"`` transport the grid chooses for processes
   on one card: every held row's digest must equal the parent's, the key
   must be ``2x4/h100_ipc/h100_grid``, staging launches more than
   0 exactly where ``oracles.moves_rows`` says, codec launches the
   parent's per call, the sync step's launches 2 encodes and 1
   decode-reduce per bucket. A short calibration on both workers must
   write one merged table (``build/two_process_table.json``, rank 0) and
   resolve ``auto`` alike on both. One ``{"two_process": ...}`` line: the
   card, each lossless plan's median host ms per call over
   ``TP_ITERS`` calls at both sizes in one process and in each worker,
   with the bytes each worker sent per call, the sync step's times and
   bytes, the launches.
9. **Train.** The train step at full width: smollm-360m (32 layers, d
   960, 409,007,040 bf16 weights from a seeded ``torch.Generator``) on
   ``RankGrid(2, 4)``, one 2048-token sequence a rank (the step-0 batch of
   ``data.pipeline.SyntheticLM(vocab, 2048, 8, seed=0)``, every step, so
   the loss must fall), ``remat="dots"``, AdamW at a constant 1e-4 with no
   warmup, the earlier phases' memory freed first; every kernel count is
   zeroed just before each leg and read just after. (a) The fused int8
   error-feedback step (``make_manual_train_step(algo="pip_mcoll",
   error_budget=0.5/127)``), 3 steps: the loss falls at every step and
   stays finite; a step launches 782 ``int8_block_encode`` and 391
   ``int8_decode_reduce``, the staging kernels as the sync calls do alone
   (more than 0 exactly where ``oracles.moves_rows`` says), every other
   kernel 0; then one profiled step. (d) ``compress_tree`` on rank 0's
   gradient (12 leaves) with a carried error: 12 ``int8_encode_feedback``
   launches, wire forms and new error bitwise the plain versions' on the
   same operands, the decoded tree within the int8 bound; counted on a
   path of its own, ``compress_tree``, since no train step calls it. (b)
   The lossless fused step (``algo="auto"``) against ``train_step`` over
   8 microbatches of the global batch, two steps each from the same
   weights: both losses within ``rtol=1e-5``, the weights after the first
   within 5e-2 and AdamW's ``m`` after the first (the applied gradient
   times 1 - b1) within 1e-4 of each leaf's largest |m|; two steps timed,
   one profiled. (c) ``make_overlapped_train_step(segmented=True)`` with
   ``overlap=True`` and its barrier twin, 2 steps each from the same
   start: the sha256 of the weights, ``m`` and ``v`` and the losses
   equal; the segmented and the monolithic decomposition, two steps each,
   against (b)'s ``train_step`` at (b)'s bars; one profiled step and one
   traced one (every stage a span nested in
   ``train/step``, a ``bucket:<i>`` window per bucket; the Chrome trace
   in ``build/train_trace.json``). Peak device memory under 70 GB. One
   ``{"train": ...}`` line: each leg's step times (host clock around a
   synchronize; the median of the steps after the first), tokens per
   second, profiled step (device busy, idle share, top kernels) and
   launches, the peak.
10. **The MoE family.** (a) The flash-decode kernel past 8 query heads a
   kv group, held as in phase 1 at qwen3-moe's serving shape (B 8, S
   2048, 64 heads of 64 over 4 KV heads: G 16) and at G 9, 11, 12 and 16 at
   reduced sizes, bf16 and fp32, then the split grid's edges at
   qwen3-moe's shape (its split count counts the head groups), the
   tickets back at zero; timed there (events and CUPTI) beside its bound
   and one SDPA call. (b) qwen3-moe's MoE layer at full width (d 4096,
   128 experts top-8 of d_ff 1536) expert parallel on ``RankGrid(2,
   4)``, the experts over the local axis (32 a rank), the batch over the
   nodes, on seeded bf16 tokens (8, 512): each of ``pip_mcoll``,
   ``pip_pipeline`` at 2 and 4 chunks and ``xla`` forced through
   ``Communicator.plan``, and ``auto``; at capacity 4 no routing dropped
   and the output within the reference check's 6e-2 of the local path's,
   at the default 1.25 the drops counted; at both the lossless plans
   bitwise equal; under ``error_budget=0.07`` the combine's own plan
   (its codec recorded) within ``6e-2 + 0.07 * max|y|`` of the lossless
   output; no kernel launched (the all-to-alls move no rows through the
   staging primitives, ``oracles.moves_rows``; the compressed combine
   uses the codecs' plain encode and decode); each plan's median host
   time per call and one profiled call split into all-to-alls and expert
   products. Then arctic-480b's MoE layer (d 7168, 128 experts top-2 of
   d_ff 4864) under ``auto`` and the compressed combine, the same
   checks. (c, d) qwen3-moe cut to its first 4 layers (every width the
   published one) served as phase 4 serves smollm (the local MoE, as the
   reference's engine runs it; flash-decode launches ticks x 4, three
   teacher-forced ticks with every layer's flash call held to the plain
   version), then ``DecoderLM.forward(tokens, rules=..., grid=RankGrid(2,
   4))`` on (8, 512) seeded tokens at capacity 4 against the local path:
   each MoE layer teacher-forced (the local forward's input) routes every
   token alike and lies within 6e-2, and the logits of every sequence up
   to its first token routed otherwise in some layer (a bf16 near tie)
   within ``TEACHER_TOL`` times the largest logit. (e) arctic cut to 1
   layer (the MoE and its dense residual MLP, 64 padded heads over 8 KV
   heads: G 8) served the same way. One ``{"moe": ...}`` and one
   ``{"serve_moe": ...}`` line per model, each with its peak memory;
   each leg frees the card before the next.
11. **The model families left.** (a) The flash-decode kernel at the new
   serving shapes, held as in phase 10: seamless's self-attention (B 8,
   S 2048, 16 heads of 64 over 16 KV heads: G 1), qwen1.5-4b's (20 over
   20 of 128: G 1) and phi3-medium-14b's (40 over 10 of 128: G 4), bf16
   and fp32, vector and scalar lengths (0 included), the split edges
   +-1, the tickets back at zero; each timed (events and CUPTI) beside
   its plain version, one SDPA call and its bytes bound. (b)
   seamless-m4t-large-v2 at full depth (24 + 24 layers, d 1024, vocab
   256,206; 2,034,886,656 seeded bf16 parameters): ``EncDecLM.encode``
   on frames (8, 1024, 1024) and (1, 4096, 1024) (the second past the
   streaming threshold: every encoder layer streams, and one layer's
   non-causal ``attend_streaming`` is held to ``attend_full`` on its own
   q, k and v within ``STREAM_TOL`` of the largest output), then
   ``cross_cache`` and 32 greedy ticks from one start token at a scalar
   index with the flash-decode kernel (launches 32 x 24, nothing else),
   the tokens equal to a run without the kernel under the top-2 margin
   guard, three teacher-forced ticks (every layer's flash call within
   ``FLASH_TOL`` of the plain version, the logits within ``TEACHER_TOL``
   of the plain-version path's), and one profiled tick split into the
   flash kernel, the cross-attention (a profiler range around the
   decoder's plain cross-attention decode) and the matrix products. (c)
   seamless trained through ``train_step`` on one device: one sequence
   of 2048 frames and 2048 tokens, remat on, AdamW at 1e-4, 3 steps, the
   loss falling at every step, the peak under 70 GB. (d) qwen2-vl-72b
   cut to its first 8 layers (9,512,820,736 parameters) served as phase
   10 serves (the tick sync on ``RankGrid(2, 4)``, tokens equal to a
   sync-free engine's, flash launches ticks x 8, staging as one sync
   call's x ticks, three teacher-forced ticks), then its VL input:
   ``DecoderLM.forward(tokens, caches=, embeds=, positions3=)`` on 256
   seeded patch embeddings (8, 256, 8192) on a (1, 16, 16) grid before
   256 text tokens, and 32 teacher-forced ticks at a per-row index (the
   text positions from each row's own index), every flash call held. (e)
   yi-34b's first 8 layers (5,497,805,824 parameters, 64 padded heads
   over 8: G 8), qwen1.5-4b whole (40 layers, QKV biases, G 1) and
   phi3-medium-14b whole (40 layers, G 4) served as (d). One
   ``{"encdec": ...}`` line per seamless leg and one ``{"serve_<model>":
   ...}`` line per served model, each with its peak memory; each leg
   frees the card before the next.
12. **Report.** The slice, collectives, serving and calibration summaries,
   the card's name and power limit (as nvidia-smi gives them), the
   ``{"kernels": [...]}`` line (the 14 TPU kernels of the repository, each
   codec's feedback encode apart from its residual encode and the WKV6
   recurrence's chunked prefill kernel apart from its tick kernel, with the
   feedback launches the slice phase counted apart: 0, since its
   compressed allreduce encodes without the carried error; the staging
   and codec kernels' ``launches_by_path`` include ``two_process``, both
   workers' launches; flash decode's and the staging kernels' include
   ``serve_qwen3_moe`` and ``serve_arctic``, the staging kernels' also
   ``moe_ep``, the expert-parallel layer's (0: no plan of it moves
   rows); flash decode's also ``serve_seamless``, ``vl_prefill``,
   ``serve_qwen2_vl``, ``serve_yi``, ``serve_qwen15`` and ``serve_phi3``,
   the staging kernels' the four phase-11 engine paths; every entry's
   ``launches_by_path`` has ``train``,
   the train steps' launches; the feedback encodes' also have
   ``compress_tree``, leg (d)'s, which their launches include; every
   entry's also has phase 13's ``ep_backward``, ``sharded_train`` and
   ``train_driver``, each 0, asserted), and last
   ``{"ok": true, "device": {...}}``.
13. **Sharded training**, before the report, the earlier phases' memory
   freed first, each leg freeing the card before the next. (a)
   qwen3-moe's MoE layer at full width (d 4096, 128 experts top-8 of d_ff
   1536) on ``RankGrid(2, 4)``, ``Rules(batch=("node",), tp="local")``,
   seeded bf16 tokens (8, 512) that require grad:
   ``torch.autograd.grad`` of ``sum(y * r)`` with respect to the router,
   the three expert weights and x under each lossless plan forced through
   ``Communicator.plan`` and ``auto``; at capacity 4 no drop, the plans'
   gradients bitwise and each leaf's within ``SHARD_TOL`` times the local
   path's largest entry of the local path's; at 1.25 the drops counted,
   the gradients finite, the plans bitwise; under ``error_budget=0.07``
   in grad mode each forced compressed combine raises and launches
   nothing; each plan's forward-and-backward host ms, profiles of the
   forward and of forward and backward split into all-to-alls and expert
   products. (b) qwen3-moe cut to its first layer (3,696,766,976
   parameters): at capacity 4 and aux weight 0 the sharded
   ``value_and_grad`` against the single-device one (``ce`` within
   ``rtol=2e-2``, every leaf's gradient within ``SHARD_TOL`` of its
   largest local entry); then 3 sharded ``train_step`` calls at the
   config's capacity and aux weight, AdamW at a constant 1e-4: the loss
   finite and falling at every step, the peak under 75 GB, no kernel
   launched; step times, tokens/s, a profiled step. (c) smollm-360m's
   train state saved blocking and async and restored on the card (sha256
   of the weights, ``m`` and ``v`` equal), then ``python -m
   repro_torch.launch.train`` uninterrupted, killed at step 5 (exit 42)
   and resumed from step 4, the printed losses at steps 6 and 7 equal,
   the checkpoint directories removed. One ``{"ep_backward": ...}``, one
   ``{"sharded_train": ...}`` and one ``{"train_driver": ...}`` line, each
   with its peak memory.
14. **The roofline on the card**, after phase 13, the earlier phases'
   memory freed first (``roofline_phase``). (a) smollm-360m at full width
   runs one-device ``train_step``s of (8, 2048) tokens (remat "dots",
   AdamW at a constant 1e-4): a warm-up, 3 steps timed on the host clock
   around a synchronize, then one step under the work counter
   (``roofline/counter.py``); the same step on ``meta`` weights is counted
   too. Its FLOPs and collective bytes must equal the ``meta`` count's
   bitwise, its HBM bytes too or each differing op is named
   (``bytes_differ_by_op``); the roofline bound of the count from the H100
   SXM5's data-sheet peaks (``roofline/terms.py``) must be at most the
   median step (a fraction above 1 fails as an impossible reading); the
   counted live peak is recorded beside ``max_memory_allocated``. (b)
   smollm-360m's and rwkv6-1.6b's decode ticks at full width, 8 rows at
   per-row offsets into 2048-position caches, with the flash-decode and
   the WKV6 kernels on: one counted tick, whose kernel calls must equal
   the wrapper's launches (each launch's registered cost counted once)
   with no other kernel, then 10 timed ticks, the count's bound at most
   their median. (c) ``launch.dryrun.run_cell`` of smollm-360m x train_4k
   and qwen3-moe x decode_32k on the 32x8 grid on ``meta``, their terms
   printed. (d) ``repro_torch.examples.quickstart``, ``serve_llm`` and
   ``collectives_demo`` on the card, each's last line its ``... OK``. One
   ``{"roofline_train": ...}`` line, one ``{"roofline_tick": ...}`` per
   served model, one ``{"roofline_dryrun": ...}`` and one
   ``{"roofline_examples": ...}``; every ``{"kernels": ...}`` entry's
   ``launches_by_path`` gains ``roofline_train``,
   ``roofline_flash_decode``, ``roofline_rwkv6_wkv`` and
   ``example_<name>``.
15. **One process per rank on the card**, after phase 14, the earlier
   phases' memory freed first (``process_groups_phase``): the port's
   process groups, where every axis of the ``ProcessGrid(2, 4)`` crosses
   processes, under both transports in the same spawns: every worker builds
   a grid handed a ``GlooTransport`` and one that chooses its own, which
   must be ``"shm"`` (CUDA IPC device slots, no host copy), and runs each
   leg below on both, one after the other. The parent's ``RankGrid(2, 4)`` results come first
   (phase 8's case digests and sync step, the groups below, the sync-free
   engine's tokens, the EP layer's digests), then the card is freed and
   ``distributed.launch.run`` starts eight one-rank workers (the kernels
   already built): (a) phase 8's 148 cases, every held row bitwise the
   parent's (sha256), staging launches > 0 exactly where
   ``oracles.moves_rows`` says, the key ``2x4/host_ipc/host_ipc``
   (``2x4/h100_ipc/h100_ipc`` under ``"shm"``), each lossless plan's host
   ms per call at 8 B and 4 MiB per rank under both transports beside
   phase 8's two-process and the one-process times with the bytes sent;
   the
   ``("node",)`` and ``("local",)`` children and the color splits
   ``[0, 1] * 4`` with and without a key that reverses each group, six
   collectives each under ``pip_mcoll`` at both sizes, bitwise; (b) the
   full-width smollm-360m int8 EF sync step (391 buckets), every bucket's
   output and new error bitwise the parent's, 2 encodes and 1
   decode-reduce a bucket in every worker; (d) smollm-360m served at full
   width by each worker's ``Engine(mesh=ProcessGrid(2, 4))`` (phase 4's
   16 requests), tokens equal to the sync-free engine's, ``flash_decode``
   launches ticks x 32 and staging launches one sync call's x ticks per
   worker, tick p50/p99 and tokens/s beside phase 4's; (e) under
   ``"shm"`` only, ``calibrate(include_splits=True)`` at 8 B and 4 MiB per
   rank (lossless plans, median of 10, folded over the workers with max),
   ``costmodel.fit_net`` of those rows (the constants behind
   ``h100_ipc``) and in how many cells the checked-in ``h100_ipc``, the
   fresh fit and ``host_ipc`` pick the measured argmin. Every ``"shm"``
   leg moves no payload byte through host memory (``host_bytes`` 0). Then
   four workers
   of two ranks (each node two processes, the TP group across a process
   boundary): (c) qwen3-moe's MoE layer at full width on (8, 512) bf16
   tokens, capacity factor 4 (no drop), under ``pip_mcoll``,
   ``pip_pipeline`` c2, ``xla`` and ``auto``: routings, drops, y and aux
   bitwise the parent's, and under ``pip_mcoll`` and ``auto`` the
   gradients of ``sum(y * r)`` with respect to the router, the three
   expert weights and x bitwise the parent's (two ranks an expert: the
   cross-process sums keep its order), host ms forward and
   forward+backward, the peak per worker (with the ``"shm"`` slots, which
   PyTorch's allocator does not see). One ``{"process_groups": ...}`` line
   naming the card; every ``{"kernels": ...}`` entry's
   ``launches_by_path`` gains ``pg_collectives``, ``pg_sync``,
   ``pg_moe`` and ``pg_serve`` and their ``_shm`` twins, summed over the
   workers.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
STEPS = 2
#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: modeled fp32 operations per element: the block encodes (add, abs, max,
#: mul, div, rint, 2 clips, fma), the fp8 encode (add, abs, max, mul, max,
#: div, 2 clips, 2 converts, fma) and one fma per peer in decode-reduce
ENCODE_OPS_PER_ELEM = 9
FP8_ENCODE_OPS_PER_ELEM = 11
DECODE_OPS_PER_ELEM_PEER = 2
#: clock cycles of the spin kernel queued ahead of each timed run (about
#: 4 ms at the H100's 1.98 GHz boost clock: a plain version at jamba's
#: flash-decode shape takes over 1 ms of host time to queue)
SPIN_CYCLES = 8_000_000
#: (codec, error budget) of the slice's sync runs, in order
SYNC_CODECS = (("int8_block", 0.5 / 127), ("int4_block", 0.5 / 7),
               ("fp8_sim", 2.0 ** -4))
#: CUDA kernels each codec's encode and decode-reduce wrappers launch
CODEC_KERNELS = {
    "int8_block": (("int8_block_encode",), "int8_decode_reduce"),
    "int4_block": (("int4_block_encode",), "int4_decode_reduce"),
    "fp8_sim": (("fp8_encode",), "fp8_decode_reduce"),
}
#: each codec's encode kernel (its launch counter's key)
ENCODE_NAMES = {"int8": "int8_block_encode", "int4": "int4_block_encode",
                "fp8": "fp8_encode"}
#: the CUDA kernel behind each codec's encode wrappers
ENCODE_CUDA_KERNELS = {
    "int8": "int8_block_encode<HAS_ERR, VEC> (a warp a quantization block, "
            "8 elements a lane; CTAs of 4 warps walk the blocks over a grid "
            "sized to the SMs, the next block's loads before this one's "
            "stores)",
    "int4": "int4_block_encode<HAS_ERR, VEC> (a warp a quantization block, "
            "8 elements a lane packed into one 4-byte wire word; CTAs of 4 "
            "warps walk the blocks over a grid sized to the SMs, the next "
            "block's loads before this one's stores)",
    "fp8": "fp8_encode<HAS_ERR, VEC, NV, WALK> (one launch, a thread-block "
           "cluster a slice; the amax across the cluster through distributed "
           "shared memory, the row in registers from load to store; rows "
           "too long for them walked twice)",
}
#: the CUDA kernel behind each codec's decode-reduce wrapper
DECODE_CUDA_KERNELS = {
    "int8": "int8_decode_reduce<W_T, VEC_OUT> (8 outputs a thread, all "
            "peers' loads in flight; 8-byte wire reads, the wrapper refuses "
            "a wire that is not 8-byte aligned)",
    "int4": "int4_decode_reduce<W_T, VEC_IN, VEC_OUT> (8 outputs a thread, "
            "all peers' loads in flight; 4-byte wire reads where q's "
            "address allows, single bytes elsewhere)",
    "fp8": "fp8_decode_reduce<W_T, VEC_IN, VEC_OUT> (8 outputs a thread, "
           "all peers' loads in flight; 8-byte wire reads where q and Lq "
           "allow, single bytes elsewhere)",
}
#: each codec's error-feedback encode launches, counted apart (the main
#: path's compressed allreduce encodes without the carried error)
FEEDBACK_KERNELS = {c: tuple(k + "_feedback" for k in encodes)
                    for c, (encodes, _) in CODEC_KERNELS.items()}
PEAK_LIMIT_BYTES = 50e9
#: the disabled telemetry hooks' cost on the tick sync's round trip, and
#: the interleaved blocks and pairs it is measured over
HOOK_LIMIT = 0.02
HOOK_BLOCKS, HOOK_PAIRS = 25, 60
#: full 4 MiB buckets of the profiled compressed reduce_scatter pass
PROFILED_BUCKETS = 16
#: per-rank message sizes of the collectives phase (bytes)
COLL_SIZES = (8, 64 << 10, 4 << 20)
TIME_ITERS = 10
#: per-rank message sizes at which the staging kernels are held and timed,
#: and at which the calibration phase measures every plan: the paper's two
#: regimes
STAGING_SIZES = CAL_SIZES = (8, 4 << 20)
#: timed samples per calibrated plan (each after one warm call)
CAL_ITERS = 10
#: the artifact sections phase 7 builds (the reference benchmark's
#: ``pipeline_crossover`` and ``compression`` are not ported)
CAL_SECTIONS = ("topology", "sizes", "backend", "process_count", "table",
                "latency_rows", "model_vs_measured")
#: blocking waits of the poisoned plan in the drift leg
DRIFT_WAITS = 10
#: serving (full-width smollm-360m, rwkv6-1.6b, then jamba's first five
#: layers): max_batch slots of max_len positions, 16 requests with prompts
#: drawn in [64, 1024] and 32 new tokens each
SERVE_BATCH, SERVE_LEN = 8, 2048
SERVE_REQUESTS, SERVE_NEW, SERVE_PROMPT = 16, 32, (64, 1024)
#: the flash-decode kernel against its plain version: both fp32 from the
#: same inputs, apart only in the order of their fp32 sums
FLASH_TOL = 2e-5
#: the WKV6 kernel against its plain version: fp32 from the same inputs,
#: apart in the order of the sum over the state's rows and in fused
#: multiply-adds (the reference's own kernel-vs-ref tolerance for fp32)
RWKV_TOL = 1e-4
#: the mamba scan kernel against its plain version: fp32 from the same
#: inputs, apart in the order of the sum over the N states and in fused
#: multiply-adds (the rwkv6_wkv tolerance, for the same reason)
MAMBA_TOL = 1e-4
#: teacher-forced bf16 logits, kernel path against the plain-version path:
#: relative to the largest |logit| (the attention, WKV or scan outputs
#: differ in the order of fp32 sums; each layer rounds them to bf16)
TEACHER_TICKS, TEACHER_TOL = 3, 2.0 ** -5
#: H100 SXM special-function units: exponentials per SM per clock, SMs
#: (the SM clock is the card's own, read with nvidia-smi)
SFU_EXP_PER_SM_CLOCK, N_SMS = 16, 132
#: modeled fp32 operations of the scan per (step, channel, state): dt*A,
#: dA*h, (dt*x)*B, their add, h*C and its sum; the exponential counts
#: apart, against the SFU rate
SCAN_OPS_PER_ELEM = 6
#: the jamba serving cut: its first five layers at full width
JAMBA_ARCH, JAMBA_LAYERS = "jamba-1.5-large-398b", 5
#: kernel-name fragments of cuBLAS's matrix products in a profile
GEMM_NAMES = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitk")
#: the chunked WKV6 kernel's two passes (``csrc/rwkv6_wkv.cu``), one
#: launch each per call, and the tick and recurrent kernels' names
CHUNKED_PASSES = ("wkv_chunk_intra", "wkv_chunk_state")
TICK_KERNEL, RECURRENT_KERNEL = "rwkv6_wkv_tick_kernel", "rwkv6_wkv_kernel"
#: the profiler range put around the MoE's expert products, and the one
#: put around its all-to-alls (phase 10)
EXPERT_RANGE, A2A_RANGE = "moe_experts", "moe_alltoall"
#: phase 10, the MoE family: qwen3-moe cut to its first 4 layers and
#: arctic to 1 for serving, every width the published one; the
#: expert-parallel layer's tokens, one (4, 512) batch shard a node
MOE_Q_ARCH, MOE_Q_LAYERS = "qwen3-moe-235b-a22b", 4
MOE_A_ARCH, MOE_A_LAYERS = "arctic-480b", 1
MOE_TOKENS = (8, 512)
#: the expert-parallel layer's forced lossless plans (algo, chunks), the
#: compressed combine's budget, the reference check's bar against the
#: local path (tests/checks/moe_ep_check.py) and the timed calls a plan
MOE_PLANS = (("pip_mcoll", 1), ("pip_pipeline", 2), ("pip_pipeline", 4),
             ("xla", 1))
MOE_BUDGET, MOE_TOL, MOE_ITERS = 0.07, 6e-2, 5
#: compressed combines forced under MOE_BUDGET besides ``auto``'s own
#: (algo, chunks, codec; the dispatch stays lossless on the same algo)
MOE_CODEC_PLANS = (("pip_mcoll", 1, "int8_block"),
                   ("pip_pipeline", 2, "fp8_sim"))
#: flash_decode past 8 heads a kv group: qwen3-moe's serving shape (G 16,
#: hd 64), then G 9, 11, 12 and 16 at reduced sizes
FLASH_GROUPS = ((SERVE_BATCH, SERVE_LEN, 64, 4, 64),
                (SERVE_BATCH, 1000, 18, 2, 32),
                (SERVE_BATCH, 1000, 22, 2, 64),
                (SERVE_BATCH, 1000, 24, 2, 64),
                (SERVE_BATCH, 1000, 32, 2, 128))
#: the staging kernels' names in a profile (``csrc/staging.cu``) and in
#: their wrapper's launch counts
STAGING_KERNELS = ("shift_blocks_kernel", "pack_blocks_kernel")
STAGING_NAMES = ("shift_blocks", "pack_blocks")


def _smi(query: str, *fmt: str) -> str:
    """The first card's ``query`` as ``nvidia-smi --query-gpu`` gives it
    (csv, no header, plus ``fmt`` options such as ``nounits``)."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=" + ",".join(("csv", "noheader") + fmt)],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def time_ms(torch, fn, flush, n: int = 20, spin: bool = True) -> float:
    """Median device time of ``fn`` over ``n`` runs, between two CUDA
    events, with the L2 cache flushed before each run.

    A spin kernel is queued ahead of the flush and the first event, so the
    host has queued all of ``fn``'s launches before the device reaches
    them: the events then bracket device work, not the host's dispatch. A
    run whose queueing took longer than half the spin (a stall of the
    shared host) is discarded and run again; raises if more than ``n``
    runs had to be discarded. ``spin=False`` drops the spin for a ``fn``
    that queues more launches than the device's queue holds behind one (a
    plain version looping over time steps): its events then also bracket
    the gaps in which the device waits for the host."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if not spin:
        times = []
        for _ in range(n):
            flush.zero_()
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)
    a.record()
    torch.cuda._sleep(SPIN_CYCLES)
    b.record()
    b.synchronize()
    spin_ms = a.elapsed_time(b)
    times, slow = [], []
    while len(times) < n:
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        flush.zero_()
        a.record()
        fn()
        b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.synchronize()
        if host_ms <= spin_ms / 2:
            times.append(a.elapsed_time(b))
            continue
        slow.append(host_ms)
        if len(slow) > n:
            raise RuntimeError(f"timing: the host queued {len(slow)} runs "
                               f"slower than half the {spin_ms} ms spin "
                               f"(ms: {slow})")
    return statistics.median(times)


def event_floor_ms(torch, dev, flush) -> float:
    """:func:`time_ms` of a one-element fill: what the CUDA events around
    any single launch measure at least (the launch and the events
    themselves), beside each kernel's ``ms``."""
    one = torch.empty(1, device=dev)
    return time_ms(torch, lambda: one.zero_(), flush)


def cupti_ms(torch, fn, flush, name: str, n: int = 5):
    """Mean device time per launch of the kernels whose name contains
    ``name`` over ``n`` runs of ``fn``, the L2 cache flushed before each
    (CUPTI, by :func:`profile_call`): the kernel's own time, without the
    launch and event overhead that :func:`time_ms` includes. A trace now
    and then records none of the kernels, so up to three traces are
    taken."""
    def runs():
        for _ in range(n):
            flush.zero_()
            fn()
    ms = "not measured"
    for _ in range(3):
        ms = profile_call(torch, runs, [name]).get("per_launch_ms", {}).get(
            name, "not measured")
        if ms != "not measured":
            break
    return ms


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def scan_bound(nbytes: float, ops: float, exps: float, sm_mhz: float):
    """The scan's bound: the larger of its bytes over the memory rate, its
    fp32 operations over the fp32 rate and its exponentials over the SFU
    rate at the card's SM clock. Returns (ms, "bytes" or "operations",
    each term in ms)."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "fp32_operations": ops / FP32_FLOP_PER_S * 1e3,
             "exponentials": exps / (SFU_EXP_PER_SM_CLOCK * N_SMS
                                     * sm_mhz * 1e6) * 1e3}
    top = max(terms, key=terms.get)
    return terms[top], ("bytes" if top == "bytes" else "operations"), terms


def max_diff(torch, got, want) -> float:
    return float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0


def byte_diff(torch, got, want) -> int:
    """The largest difference of two same-shaped outputs' bytes, read as
    uint8: the error of a kernel that moves bytes, defined for every dtype
    and NaN payload."""
    if not got.numel():
        return 0
    a = got.contiguous().view(torch.uint8).int()
    b = want.contiguous().view(torch.uint8).int()
    return int((a - b).abs().max())


def same_bits(torch, got, want) -> bool:
    """Bitwise equality, compared as bytes: signed zeros and NaN payloads
    count, and every dtype compares (the card has no ``eq`` for uint64)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dim() == 0:
        got, want = got[None], want[None]
    return torch.equal(got.contiguous().view(torch.uint8),
                       want.contiguous().view(torch.uint8))


# ---------------------------------------------------------------------------
# phase 1: kernels
# ---------------------------------------------------------------------------


def _edge_rows(torch, dev, L=1000):
    """Rows with subnormal e4m3 outputs (one large element, the rest down
    to 2**-12), signed zeros, rounding ties, an all-zero row, a NaN, and
    +inf and -inf among finite values (row 5: blocks 0 and 2 of the block
    codecs)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.zeros((6, L), device=dev)
    x[0] = torch.randn(L, generator=gen, device=dev) * torch.exp2(
        -torch.randint(0, 13, (L,), generator=gen, device=dev).float())
    x[0, 0] = 448.0
    x[1] = -0.0
    x[1, ::3] = torch.randn(len(range(0, L, 3)), generator=gen,
                            device=dev) * 1e-3
    x[1, 7] = 1.0
    x[2] = 1.5 * torch.exp2(torch.randint(-9, 8, (L,), generator=gen,
                                          device=dev).float())
    x[2, 1] = 448.0
    x[4] = torch.randn(L, generator=gen, device=dev)
    x[4, 17] = float("nan")
    x[5] = torch.randn(L, generator=gen, device=dev)
    x[5, 3], x[5, 600] = float("inf"), float("-inf")
    return x


def _check_encode(torch, what, got, want) -> float:
    """Wire bytes bitwise in every block, NaN-scale blocks included; scales
    and residuals bitwise wherever the plain one is a number and NaN at the
    same positions (a NaN's payload is not part of the contract: the plain
    residual rounds a float64 NaN, the kernel's fused multiply-add a
    float32 one). Returns the max abs difference of the compared values."""
    worst = 0.0
    for a, b, name in ((got[0]["q"], want[0]["q"], "q"),
                       (got[0]["scale"], want[0]["scale"], "scale"),
                       (got[1], want[1], "res")):
        nan = b.isnan() if b.is_floating_point() else \
            torch.zeros(b.shape, dtype=torch.bool, device=b.device)
        if not torch.equal(a.isnan() if a.is_floating_point() else nan, nan):
            raise AssertionError(f"{what}: NaN positions of {name} differ "
                                 f"from the plain version's")
        if not same_bits(torch, a[~nan], b[~nan]):
            rows = (a != b).logical_and(~nan).reshape(a.shape[0], -1).any(1)
            raise AssertionError(
                f"{what}: {name} of rows {rows.nonzero().flatten().tolist()} "
                f"differs from the plain version: max "
                f"{max_diff(torch, a[~nan], b[~nan])}")
        worst = max(worst, max_diff(torch, a[~nan], b[~nan]))
    return worst


def _wire_bytes(S, L):
    nb = -(-L // 256)
    return {"int8": S * nb * 256, "int4": S * nb * 128, "fp8": S * L}


def _scale_bytes(S, L):
    nb = -(-L // 256)
    return {"int8": 4 * S * nb, "int4": 4 * S * nb, "fp8": 4 * S}


def encode_bytes(codec: str, S: int, L: int, err: bool = False) -> int:
    """What one encode over (S, L) must move: x (and the carried error)
    read, the wire, the scales and the f32 residual written."""
    return 4 * S * L * (2 if err else 1) + _wire_bytes(S, L)[codec] \
        + _scale_bytes(S, L)[codec] + 4 * S * L


def parent_libraries(parent) -> dict:
    """The parent tree's int8, int4 and fp8 codec libraries, built from its
    sources with this tree's nvcc flags into a fresh directory outside the
    repository and bound with the parent's encode signatures (this tree's
    too)."""
    import ctypes
    import tempfile

    from repro_torch.kernels import _build

    out = pathlib.Path(tempfile.mkdtemp(prefix="parent_codecs_"))
    csrc = pathlib.Path(parent) / "src" / "repro_torch" / "kernels" / "csrc"
    libs = {}
    for c in ("int8", "int4", "fp8"):
        so = out / f"libcodec_{c}.so"
        proc = subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", str(so),
                               str(csrc / f"codec_{c}.cu")],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"the parent's codec_{c}.cu: {proc.stderr}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, f"codec_{c}_encode")
        P, I64 = ctypes.c_void_p, ctypes.c_longlong
        fn.restype = ctypes.c_int
        fn.argtypes = [P] * 5 + [I64, I64, P] if c == "fp8" \
            else [P] * 5 + [I64, I64, I64, P]
        libs[c] = fn
    return libs


def _parent_encode(torch, fn, codec, x, err=None):
    """One encode through the parent's library, allocating as its wrapper
    did."""
    S, L = x.shape
    nb = -(-L // 256)
    dev = x.device
    res = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = None if err is None else err.data_ptr()
    if codec == "fp8":
        q = torch.empty(x.shape, dtype=torch.uint8, device=dev)
        scale = torch.empty(S, device=dev)
        rc = fn(x.data_ptr(), ptr, q.data_ptr(), scale.data_ptr(),
                res.data_ptr(), S, L, stream)
    else:
        q = torch.empty((S, nb, 256 if codec == "int8" else 128),
                        dtype=torch.int8 if codec == "int8" else torch.uint8,
                        device=dev)
        scale = torch.empty((S, nb), device=dev)
        rc = fn(x.data_ptr(), ptr, q.data_ptr(), scale.data_ptr(),
                res.data_ptr(), S, L, nb, stream)
    if rc:
        raise RuntimeError(f"the parent's {codec} encode: CUDA error {rc}")
    return {"q": q, "scale": scale}, res


def parent_encode_times(torch, libs, codec, inputs, kernels, flush):
    """The parent's encode beside this tree's on the same inputs, in the
    same run: bitwise equal outputs, then events and CUPTI at (16,
    131072), feedback, and the (8, 131072) re-encode."""
    x, e, x8 = inputs
    kenc, kfb = kernels
    fn = libs[codec]
    for args, mine in (((x,), kenc(x)), ((x, e), kfb(x, e)),
                       ((x8,), kenc(x8))):
        theirs = _parent_encode(torch, fn, codec, *args)
        torch.cuda.synchronize()
        for a, b in ((mine[0]["q"], theirs[0]["q"]),
                     (mine[0]["scale"], theirs[0]["scale"]),
                     (mine[1], theirs[1])):
            if not same_bits(torch, a, b):
                raise AssertionError(f"{codec} encode differs from the "
                                     f"parent's")
    def cupti(fn_):
        return cupti_ms(torch, fn_, flush, ENCODE_NAMES[codec])
    run = (lambda *a: lambda: _parent_encode(torch, fn, codec, *a))
    return {"ms": time_ms(torch, run(x), flush),
            "kernel_cupti_ms": cupti(run(x)),
            "feedback_ms": time_ms(torch, run(x, e), flush),
            "feedback_kernel_cupti_ms": cupti(run(x, e)),
            "reencode_ms": time_ms(torch, run(x8), flush),
            "reencode_kernel_cupti_ms": cupti(run(x8)),
            "bitwise": True}


def kernel_phase(torch, kcodec, ref, dev, parent=None):
    """Each kernel against its plain version; returns per-kernel records
    (without launches) and raises on any mismatch. ``parent``: the parent
    tree's codec libraries (:func:`parent_libraries`), whose encodes are
    then held bitwise to this tree's and timed beside them."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    codecs = ("int8", "int4", "fp8")
    err = {c: {"enc": 0.0, "dec": 0.0} for c in codecs}
    checked = dict.fromkeys(codecs, 0)  # decode-reduce cases
    # (16, 131072) and (8, 131072): the main path's encode and re-encode
    # (fp8: clusters of 8 and 16 CTAs, rows in registers); (16, 524288):
    # fp8 walks its rows twice; L % 4 != 0 and a view one float past a
    # 16-byte boundary: the encodes' scalar paths
    for S, L, offset in ((16, 131072, 0), (8, 131072, 0), (16, 524288, 0),
                         (3, 1000, 0), (1, 256, 0), (2, 131070, 0),
                         (16, 131072, 1)):
        x = torch.randn((S, L), generator=gen, device=dev) \
            * torch.rand((S, 1), generator=gen, device=dev) * 100
        e = torch.randn((S, L), generator=gen, device=dev) * 0.01
        if offset:
            x, e = (torch.zeros(S * L + offset, device=dev)[offset:].view(
                S, L).copy_(t) for t in (x, e))
        for c in codecs:
            for what, k, p, args in (
                    ("residual", getattr(kcodec, f"{c}_encode_residual"),
                     getattr(ref, f"{c}_encode_residual"), (x,)),
                    ("feedback", getattr(kcodec, f"{c}_encode_feedback"),
                     getattr(ref, f"{c}_encode_feedback"), (x, e))):
                got, want = k(*args), p(*args)
                torch.cuda.synchronize()
                err[c]["enc"] = max(err[c]["enc"], _check_encode(
                    torch, f"{c} encode {what} {S}x{L} at float {offset}",
                    got, want))
    edge = _edge_rows(torch, dev)
    for c in codecs:
        got = getattr(kcodec, f"{c}_encode_residual")(edge)
        want = getattr(ref, f"{c}_encode_residual")(edge)
        torch.cuda.synchronize()
        if not bool(want[0]["scale"][4].isnan().any()):
            raise AssertionError(f"{c} edge rows: the NaN row has no NaN "
                                 f"scale")
        if not bool(want[0]["scale"][5].isinf().any()):
            raise AssertionError(f"{c} edge rows: the inf row has no "
                                 f"infinite scale")
        err[c]["enc"] = max(err[c]["enc"], _check_encode(
            torch, f"{c} encode edge rows", got, want))
        if c == "fp8":
            q = got[0]["q"][0]
            if not bool(((q & 0x78) == 0).logical_and((q & 0x07) != 0).any()):
                raise AssertionError("fp8 edge rows reached no subnormal "
                                     "e4m3 value")
    # (8, 2, 524288): the compressed reduce_scatter's wire on the main path;
    # (8, 2, 7800): the last gradient bucket's (fp8 rows of 7800 bytes,
    # 8-byte but not 16-byte multiples); 999 and 1001: odd rows; W 9, 17:
    # a group of 8 peers and a rest
    for R, W, L in ((8, 1, 131072), (8, 2, 131072), (8, 8, 131072),
                    (8, 2, 524288), (1, 2, 1000), (8, 3, 131072),
                    (8, 5, 131072), (2, 2, 999), (8, 2, 7800),
                    (8, 9, 131072), (2, 17, 1001), (8, 17, 7800)):
        x = torch.randn((R, W, L), generator=gen, device=dev)
        for c in codecs:
            comp, _ = getattr(ref, f"{c}_encode_residual")(x)
            # the wire as encoded, decoded whole and 3 short; then copied
            # to 1 and 3 bytes into a buffer (a contiguous view at an odd
            # address), where the int8 kernel's wrapper must refuse it;
            # int4 also at bytes 2 (its byte reads) and 4 (its 4-byte
            # reads, at an address that is no multiple of 8)
            for offset, length in ((0, L), (0, L - 3), (1, L), (3, L - 3)) \
                    + (((2, L), (4, L - 3)) if c == "int4" else ()):
                if offset:
                    buf = torch.zeros(comp["q"].numel() + offset,
                                      dtype=comp["q"].dtype, device=dev)
                    comp = {**comp, "q": buf[offset:].view(
                        comp["q"].shape).copy_(comp["q"])}
                what = (f"{c} decode_reduce R={R} W={W} L={L} length "
                        f"{length} wire at byte {offset}")
                if offset and c == "int8":
                    before = dict(kcodec.launches)
                    try:
                        kcodec.int8_decode_reduce(comp, length)
                    except ValueError as e:
                        if "8-byte aligned" not in str(e):
                            raise
                    else:
                        raise AssertionError(f"{what}: not refused")
                    if kcodec.launches != before:
                        raise AssertionError(f"{what}: launched")
                    continue
                got = getattr(kcodec, f"{c}_decode_reduce")(comp, length)
                want = getattr(ref, f"{c}_decode_reduce")(comp, length)
                torch.cuda.synchronize()
                if not same_bits(torch, got, want):
                    raise AssertionError(f"{what} differs from its plain "
                                         f"version: max "
                                         f"{max_diff(torch, got, want)}")
                err[c]["dec"] = max(err[c]["dec"], max_diff(torch, got,
                                                            want))
                checked[c] += 1

    # times at the main path's shapes: the first encode of each bucket is
    # (ranks * W, Ls) = (16, 131072), the re-encode of the reduced slice
    # (8, 131072); decode-reduce gets (8, 2, ...) wire
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    S, L, R, W = 16, 131072, 8, 2
    x = torch.randn((S, L), generator=gen, device=dev)
    e = torch.randn((S, L), generator=gen, device=dev) * 0.01
    x8 = torch.randn((S // 2, L), generator=gen, device=dev)
    xw = torch.randn((R, W, L), generator=gen, device=dev)
    wire, scales = _wire_bytes(S, L), _scale_bytes(S, L)
    replaces = {"int8": (136, 146), "int4": (214, 223), "fp8": (303, 311)}
    ops = {"int8": ENCODE_OPS_PER_ELEM, "int4": ENCODE_OPS_PER_ELEM,
           "fp8": FP8_ENCODE_OPS_PER_ELEM}
    floor = event_floor_ms(torch, dev, flush)
    records, dec_comp = {}, {}
    for c in codecs:
        src = f"src/repro_torch/kernels/csrc/codec_{c}.cu"
        kenc = getattr(kcodec, f"{c}_encode_residual")
        penc = getattr(ref, f"{c}_encode_residual")
        kfb = getattr(kcodec, f"{c}_encode_feedback")
        pfb = getattr(ref, f"{c}_encode_feedback")
        enc_bytes = encode_bytes(c, S, L)
        enc_b, enc_by = bound_ms(enc_bytes, ops[c] * S * L)
        fb_b, _ = bound_ms(encode_bytes(c, S, L, err=True), ops[c] * S * L)
        re_bytes = encode_bytes(c, S // 2, L)
        comp, _ = penc(xw)
        dec_comp[c] = comp
        # R * W == S: decode reads the same wire and scale bytes the encode
        # wrote, and writes the f32 sum per rank
        dec_bytes = wire[c] + scales[c] + 4 * R * L
        dec_b, dec_by = bound_ms(dec_bytes, DECODE_OPS_PER_ELEM_PEER * R * W
                                 * L)
        kdec = getattr(kcodec, f"{c}_decode_reduce")
        pdec = getattr(ref, f"{c}_decode_reduce")
        name = ENCODE_NAMES[c]
        records[name] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/codec.py:{replaces[c][0]}",
            "cuda_kernel": ENCODE_CUDA_KERNELS[c],
            "max_abs_err": err[c]["enc"],
            "ms": time_ms(torch, lambda: kenc(x), flush),
            "kernel_cupti_ms": cupti_ms(torch, lambda: kenc(x), flush, name),
            "event_floor_ms": floor,
            "plain_ms": time_ms(torch, lambda: penc(x), flush),
            "bound_ms": enc_b, "bound_by": enc_by, "library_ms": None,
            "bytes": enc_bytes, "shape": [S, L],
            # the re-encode of each bucket's reduced (8, 131072) slice
            "reencode_shape": {
                "shape": [S // 2, L],
                "ms": time_ms(torch, lambda: kenc(x8), flush),
                "kernel_cupti_ms": cupti_ms(torch, lambda: kenc(x8), flush,
                                            name),
                "bytes": re_bytes,
                "bound_ms": bound_ms(re_bytes, ops[c] * S // 2 * L)[0]},
            # the mean bound of the path's encodes: half at each shape
            "path_bound_ms": (enc_b + bound_ms(
                re_bytes, ops[c] * S // 2 * L)[0]) / 2,
            "feedback_ms": time_ms(torch, lambda: kfb(x, e), flush),
            "feedback_kernel_cupti_ms": cupti_ms(
                torch, lambda: kfb(x, e), flush, name),
            "feedback_plain_ms": time_ms(torch, lambda: pfb(x, e), flush),
            "feedback_bound_ms": fb_b}
        if c == "fp8":
            records[name]["cluster_plan"] = {
                f"{s}x{L}{' feedback' if fb else ''}":
                    kcodec.fp8_encode_plan(s, L, feedback=fb)
                for s, fb in ((S, False), (S // 2, False), (S, True))}
        if parent is not None:
            records[name]["parent"] = parent_encode_times(
                torch, parent, c, (x, e, x8), (kenc, kfb), flush)
        records[f"{c}_decode_reduce"] = {
            "name": f"{c}_decode_reduce", "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/codec.py:{replaces[c][1]}",
            "max_abs_err": err[c]["dec"],
            "ms": time_ms(torch, lambda: kdec(comp, L), flush),
            "plain_ms": time_ms(torch, lambda: pdec(comp, L), flush),
            "bound_ms": dec_b, "bound_by": dec_by, "library_ms": None,
            "bytes": dec_bytes, "cases_checked": checked[c],
            "shape": list(comp["q"].shape)}
    # each decode-reduce kernel alone (CUPTI), the events' floor, and the
    # compressed reduce_scatter's wire, (8, 2, 524288) decoded
    Lrs = 4 * L
    for c in codecs:
        rec = records[f"{c}_decode_reduce"]
        kdec = getattr(kcodec, f"{c}_decode_reduce")
        rec["cuda_kernel"] = DECODE_CUDA_KERNELS[c]
        rec["kernel_cupti_ms"] = cupti_ms(
            torch, lambda: kdec(dec_comp[c], L), flush, rec["name"])
        rec["event_floor_ms"] = floor
        comp, _ = getattr(ref, f"{c}_encode_residual")(
            torch.randn((R, W, Lrs), generator=gen, device=dev))
        nbytes = sum(t.numel() * t.element_size() for t in comp.values()) \
            + 4 * R * Lrs
        rec["reduce_scatter_shape"] = {
            "shape": list(comp["q"].shape),
            "ms": time_ms(torch, lambda: kdec(comp, Lrs), flush),
            "kernel_cupti_ms": cupti_ms(
                torch, lambda: kdec(comp, Lrs), flush, rec["name"]),
            "bytes": nbytes,
            "bound_ms": bound_ms(nbytes, DECODE_OPS_PER_ELEM_PEER * R * W
                                 * Lrs)[0]}
    return records


#: the AdamW kernel's cases, each held bitwise to the plain passes on the
#: card: (label, elements, weight dtype, master_fp32, decay, flat offset
#: of the leaf in elements); the first two are also timed: qwen3-moe's
#: largest leaf (an expert stack's w_up, (1, 128, 4096, 1536)) and one
#: smollm-360m layer's wq (960, 960)
ADAMW_CASES = (
    ("qwen3-moe moe/w_up", 805306368, "bfloat16", False, False, 0),
    ("smollm-360m attn/wq", 921600, "bfloat16", False, False, 0),
    ("decayed bf16 at offset 1", 1003, "bfloat16", False, True, 1),
    ("master, offset 2", 4099, "bfloat16", True, True, 2),
    ("float32 router, offset 3", 513, "float32", False, False, 3),
    ("float32 master", 2001, "float32", True, True, 0))
ADAMW_TIMED = 2


def _adamw_leaf(torch, dev, gen, n, dtype, master, off):
    """One leaf of ``n`` seeded weights with its float32 gradient, ``m``,
    ``v`` and master (None unless ``master``), each a view ``off``
    elements into a buffer of its own, as a leaf at flat offset ``off``
    sees them."""
    from repro_torch.models.params import FlatParams
    w = torch.randn(n, generator=gen, device=dev).to(getattr(torch, dtype))
    p = FlatParams([("leaf", [w])])
    g, m, v = (torch.empty(n + off, device=dev)[off:] for _ in range(3))
    g.normal_(0, 1e-2, generator=gen)
    m.normal_(0, 1e-3, generator=gen)
    v.uniform_(0, 1e-5, generator=gen)
    mst = p.read(out=torch.empty(n + off, device=dev)[off:]) if master \
        else None
    return p, g, m, v, mst


def adamw_phase(torch, kadamw, ref, dev):
    """The fused AdamW kernel (``csrc/adamw.cu``) against the plain passes
    (``ref.adamw_update``), bitwise, on the card: ``m``, ``v``, the master
    and the stored weights after one update of each of ``ADAMW_CASES``
    from a seeded state (the clip's scale 0.5, step 3's constants). Then,
    at the first ``ADAMW_TIMED`` cases, the kernel's time (events and
    CUPTI, L2 flushed), the plain passes' and the bytes bound. Returns the
    record (without the train paths' launches)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    h = kadamw.Hyper(lr=1e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                     bc1=1 - 0.9 ** 3, bc2=1 - 0.95 ** 3)
    scale = torch.tensor(0.5, device=dev)
    one = torch.tensor(1.0, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    kadamw.reset_launches()
    checked, timed = 0, {}
    for i, (label, n, dtype, master, decay, off) in enumerate(ADAMW_CASES):
        p, g, m, v, mst = _adamw_leaf(torch, dev, gen, n, dtype, master,
                                      off)
        q = type(p)([("leaf", [p.tensors[0].clone()])])
        m2, v2 = m.clone(), v.clone()
        mst2 = None if mst is None else mst.clone()
        ref.adamw_update(q, g.clone(), m2, v2, mst2, scale, h, [decay])
        kadamw.adamw_update(p, g, m, v, mst, scale, h, [decay])
        torch.cuda.synchronize()
        for what, a, b in (("m", m, m2), ("v", v, v2), ("master", mst, mst2),
                           ("weights", p.tensors[0], q.tensors[0])):
            if a is not None and not same_bits(torch, a, b):
                raise AssertionError(f"adamw_update {label}: {what} differs "
                                     f"from the plain passes")
        checked += 1
        del q, m2, v2, mst2
        if i < ADAMW_TIMED:
            cost = kadamw.update_cost(p, master, [decay])
            bound, bound_by = bound_ms(cost.nbytes, cost.ops)
            timed[label] = {
                "elements": n, "dtype": dtype, "bytes": cost.nbytes,
                "ops": cost.ops,
                "ms": time_ms(torch, lambda: kadamw.adamw_update(
                    p, g, m, v, None, one, h, [decay]), flush),
                "kernel_cupti_ms": cupti_ms(
                    torch, lambda: kadamw.adamw_update(
                        p, g, m, v, None, one, h, [decay]), flush,
                    "adamw_update_kernel"),
                # ~16 launches a 2**24-element piece: events around the
                # call, the host's dispatch gaps included
                "plain_ms": time_ms(torch, lambda: ref.adamw_update(
                    p, g, m, v, None, one, h, [decay]), flush, spin=False),
                "bound_ms": bound, "bound_by": bound_by}
            t = timed[label]
            t["bound_share"] = (bound / t["kernel_cupti_ms"]
                                if isinstance(t["kernel_cupti_ms"], float)
                                else "not measured")
        del p, g, m, v, mst
        torch.cuda.empty_cache()
    head = timed[ADAMW_CASES[0][0]]
    return {
        "name": "adamw_update", "route": "cuda",
        "cuda_kernel": "adamw_update_kernel<W, MASTER, DECAY>",
        "source": "src/repro_torch/kernels/csrc/adamw.cu",
        "replaces": "none: the reference's AdamW is plain jnp "
                    "(src/repro/optim/adamw.py); the port's plain passes "
                    "ref.adamw_update",
        "max_abs_err": 0.0, "tolerance": "bitwise",
        "cases_checked": checked,
        "launches_in_phase": kadamw.launches["adamw_update"],
        **{k: head[k] for k in ("ms", "kernel_cupti_ms", "plain_ms",
                                "bound_ms", "bound_by", "bytes")},
        "event_floor_ms": event_floor_ms(torch, dev, flush),
        "library_ms": None, "shape": [ADAMW_CASES[0][1]],
        "timed": timed}


# ---------------------------------------------------------------------------
# phase 2: the slice (full-width gradient sync, compressed reduce_scatter)
# ---------------------------------------------------------------------------


def _range_kernels(torch, events, label):
    """``(name, us)`` of every kernel launched inside the profiler ranges
    named ``label``: the kernels of each CPU op whose time lies within one
    of them (each kernel hangs off the one op that launched it)."""
    cpu = torch.autograd.DeviceType.CPU
    spans = [e.time_range for e in events
             if e.name == label and e.device_type == cpu]
    return [(k.name, k.duration) for e in events
            if e.name != label and e.device_type == cpu
            and any(sp.start <= e.time_range.start
                    and e.time_range.end <= sp.end for sp in spans)
            for k in e.kernels]


def _is_gemm(name: str) -> bool:
    return any(g in name.lower() for g in GEMM_NAMES)


def profile_call(torch, fn, names, top: int = 12, ranges=()):
    """``fn()`` once under ``torch.profiler``: device time per kernel
    (CUPTI), its sum, the wall time of the same call and the device's idle
    share of it, the total and the mean device time per launch of each
    kernel whose name contains one of ``names``, the time of the matrix
    products (``GEMM_NAMES``), and for each profiler range in ``ranges``
    the time of the kernels launched inside it and of its matrix products.
    ``fn`` itself runs outside any ``except``; only the profiler's own
    calls may end in "not measured"."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    try:
        prof.start()
    except RuntimeError as e:
        prof, reason = None, repr(e)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if prof is None:
        return {"device_busy_ms": "not measured", "step_ms": wall_ms,
                "reason": reason}
    try:
        prof.stop()
        # a range also shows as a device-side span of its kernels: not
        # device work of its own
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.key not in ranges]
    except (RuntimeError, AttributeError) as e:
        return {"device_busy_ms": "not measured", "step_ms": wall_ms,
                "reason": repr(e)}
    busy = sum(ms for _, ms, _ in rows)
    if not busy:
        return {"device_busy_ms": "not measured", "step_ms": wall_ms,
                "reason": "profiler recorded no device time"}
    if busy > wall_ms:
        raise AssertionError(f"profiled call: device busy {busy} ms exceeds "
                             f"its wall time {wall_ms} ms")
    per_launch, name_ms = {}, {}
    for name in names:
        hits = [r for r in rows if name in r[0]]
        ms, n = sum(r[1] for r in hits), sum(r[2] for r in hits)
        per_launch[name] = ms / n if n else "not measured"
        name_ms[name] = ms
    in_ranges = {}
    for label in ranges:
        try:
            hits = _range_kernels(torch, prof.events(), label)
            in_ranges[label] = {
                "ms": sum(us for _, us in hits) / 1e3,
                "gemm_ms": sum(us for k, us in hits if _is_gemm(k)) / 1e3,
                "kernels": len(hits)}
        except (RuntimeError, AttributeError) as e:
            in_ranges[label] = {"ms": "not measured", "reason": repr(e)}
    rows.sort(key=lambda r: -r[1])
    return {"device_busy_ms": busy, "step_ms": wall_ms,
            "idle_share": 1.0 - busy / wall_ms,
            "per_launch_ms": per_launch, "name_ms": name_ms,
            "gemm_ms": sum(ms for k, ms, _ in rows if _is_gemm(k)),
            "ranges": in_ranges,
            "kernels": [{"name": k[:90], "ms": ms, "count": n}
                        for k, ms, n in rows[:top]]}


def profile_step(torch, gs, buckets, mvec, step, names):
    """One more sync step under ``torch.profiler`` (see
    :func:`profile_call`)."""
    def run():
        gs.ensure_ops(step)
        gs.sync(buckets, mvec)
    return profile_call(torch, run, names)


def traced_step(torch, gs, buckets, mvec, step):
    """One sync step untraced, then one with telemetry on inside a
    ``train/sync`` span, both timed on the host clock around a device
    synchronize. The traced step must leave one window per bucket, each on
    its own ``bucket:<i>`` track and inside the span; the Chrome trace is
    exported to ``build/grad_sync_trace.json`` and must load back equal;
    ``snapshot()`` must hold one sampled error-feedback and one ratio
    observation per bucket (each bucket's first traced wait is sampled)."""
    from repro_torch.core import telemetry

    dev = mvec.device

    def timed():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        gs.ensure_ops(step)
        gs.sync(buckets, mvec)
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    untraced_s = timed()
    telemetry.reset()
    telemetry.enable()
    try:
        with telemetry.span("train/sync", cat="train"):
            traced_s = timed()
    finally:
        telemetry.disable()
    spans = telemetry.spans()
    (outer,) = [sp for sp in spans if sp.name == "train/sync"]
    windows = [sp for sp in spans if sp.cat == "bucket"]
    n = len(gs.slices)
    if sorted(sp.track for sp in windows) != sorted(
            f"bucket:{i}" for i in range(n)):
        raise AssertionError(f"traced sync: {len(windows)} bucket windows "
                             f"on {len({sp.track for sp in windows})} "
                             f"tracks, expected one on each of {n}")
    for sp in windows:
        if not outer.start <= sp.start <= sp.end <= outer.end:
            raise AssertionError(f"{sp.name} on {sp.track} lies outside "
                                 f"the traced sync's span")
    path = ROOT / "build" / "grad_sync_trace.json"
    trace = telemetry.export_chrome_trace(path)
    if json.loads(path.read_text()) != trace:
        raise AssertionError(f"{path} does not load back equal")
    tracks = {e["args"]["name"] for e in trace["traceEvents"]
              if e["ph"] == "M"}
    if not {f"bucket:{i}" for i in range(n)} <= tracks:
        raise AssertionError("the exported trace lacks bucket tracks")
    snap = telemetry.snapshot()
    codec = gs._ops[0].codec
    ef = snap["histograms"].get(f"codec.{codec}.ef_rel_error", {})
    ratio = snap["histograms"].get(f"codec.{codec}.achieved_ratio", {})
    if ef.get("count") != n or ratio.get("count") != n:
        raise AssertionError(f"sampled probes: {ef.get('count')} error and "
                             f"{ratio.get('count')} ratio observations, "
                             f"expected {n} each")
    telemetry.reset()
    return {"untraced_s": untraced_s, "traced_s": traced_s,
            "bucket_windows": len(windows), "spans": len(spans),
            "spans_dropped": snap["tracer"]["dropped"],
            "trace": str(path.relative_to(ROOT)),
            "trace_events": len(trace["traceEvents"]),
            "ef_rel_error": ef, "achieved_ratio": ratio,
            "ef_bound_exceeded": snap["counters"].get(
                f"codec.{codec}.ef_bound_exceeded", 0)}


def sync_run(torch, comm, kcodec, kstaging, grads, slices, codec, budget,
             gen, steps: int = STEPS, trace: bool = False):
    """``steps`` compressed sync steps of every bucket under ``codec``,
    each bucket checked against the float64 sum of its input rows, then
    one profiled step, and with ``trace`` one untraced and one traced step
    (:func:`traced_step`). Launch counts are zeroed just before the first
    step and read just after the last (the compressed allreduce moves no
    rows through the grid's staging primitives: its staging launches are
    0); the sync's ops and error state are released before returning."""
    from repro_torch.core import compress
    from repro_torch.train import manual_step as ms

    world = comm.grid.world
    dev = grads.device
    buckets = [grads[:, s:s + n] for s, n in slices]
    gs = ms.OverlappedGradSync(comm, slices, metric_len=4, algo="pip_mcoll",
                               codec=codec, error_budget=budget)
    mvec = torch.arange(world * 4, dtype=torch.float32,
                        device=dev).reshape(world, 4)
    gs.ensure_ops(0)  # init: resolve the plans, allocate buffers and state
    torch.cuda.synchronize(dev)
    kcodec.reset_launches()
    kstaging.reset_launches()
    step_s, worst = [], 0.0
    for step in range(steps):
        grads.normal_(0.0, 1e-2, generator=gen)
        # what each bucket's allreduce must approximate: the float64 sum of
        # its input rows (gradient + carried error, added in float32 as the
        # collective does), and that input's max-abs for the tolerance
        want, amax = [], []
        for b, e in zip(buckets, gs.errs):
            g = b if e is None else b + e
            want.append(g.double().sum(0))
            amax.append(float(g.abs().max()))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        gs.ensure_ops(step)
        synced, msum = gs.sync(buckets, mvec)
        torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        for i, (y, w, a) in enumerate(zip(synced, want, amax)):
            tol = compress.collective_tolerance(codec, "allreduce", world, a)
            got = float((y.double() - w).abs().max())
            if not torch.isfinite(y).all() or got > tol:
                raise AssertionError(f"{codec} step {step} bucket {i}: max "
                                     f"error {got} > tolerance {tol}")
            worst = max(worst, got / tol)
        if not torch.equal(msum, mvec.sum(0, keepdim=True).expand_as(mvec)):
            raise AssertionError("metric allreduce is not exact")
        del synced, want
    torch.cuda.synchronize(dev)
    launches = {**kcodec.launches, **kstaging.launches}
    encodes, decode = CODEC_KERNELS[codec]
    want_launches = {k: 0 for k in launches}
    for k in encodes:
        want_launches[k] = 2 * steps * len(slices)
    want_launches[decode] = steps * len(slices)
    if launches != want_launches:
        raise AssertionError(f"{codec}: kernel launches {launches} on the "
                             f"main path, expected {want_launches}")
    profile = profile_step(torch, gs, buckets, mvec, steps,
                           names=encodes + (decode,))
    plan = gs.plans()[0]
    traced = traced_step(torch, gs, buckets, mvec, steps) if trace else None
    gs.release()
    out = {"codec": codec, "budget": budget, "plan": plan,
           "steps": steps, "step_s": step_s, "worst_err_over_tol": worst,
           "launches": {k: v for k, v in launches.items() if v},
           "feedback_launches": {k: launches[k]
                                 for k in FEEDBACK_KERNELS[codec]},
           "profile": profile}
    if traced is not None:
        out["traced"] = traced
    return out


def reduce_scatter_run(torch, comm, kcodec, kstaging, grads, slices, codec,
                       gen):
    """One full-width pass of the compressed reduce_scatter over every
    bucket: each within the codec's reduce_scatter tolerance of the
    float64 sum, exactly one decode-reduce launch per bucket, no other
    kernel's (no staging launch either)."""
    from repro_torch.core import compress

    world = comm.grid.world
    grads.normal_(0.0, 1e-2, generator=gen)
    torch.cuda.synchronize()
    kcodec.reset_launches()
    kstaging.reset_launches()
    worst = 0.0
    t0 = time.perf_counter()
    for i, (s, n) in enumerate(slices):
        b = grads[:, s:s + n]
        y = comm.reduce_scatter(b, algo="pip_mcoll", codec=codec)
        if tuple(y.shape) != (n,):
            raise AssertionError(f"reduce_scatter bucket {i}: shape "
                                 f"{tuple(y.shape)}, expected ({n},)")
        tol = compress.collective_tolerance(codec, "reduce_scatter", world,
                                            float(b.abs().max()))
        got = float((y.double() - b.double().sum(0)).abs().max())
        if not torch.isfinite(y).all() or got > tol:
            raise AssertionError(f"{codec} reduce_scatter bucket {i}: max "
                                 f"error {got} > tolerance {tol}")
        worst = max(worst, got / tol)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in {**kcodec.launches,
                                  **kstaging.launches}.items() if v}
    decode = CODEC_KERNELS[codec][1]
    want = {decode: len(slices)}
    if launches != want:
        raise AssertionError(f"{codec} reduce_scatter: kernel launches "
                             f"{launches}, expected {want}")

    def profiled():
        for s, n in slices[:PROFILED_BUCKETS]:
            comm.reduce_scatter(grads[:, s:s + n], algo="pip_mcoll",
                                codec=codec)
    profile = profile_call(torch, profiled, (decode,))
    return {"codec": codec, "buckets": len(slices), "seconds": seconds,
            "worst_err_over_tol": worst, "launches": launches,
            "profile": {"buckets": len(slices[:PROFILED_BUCKETS]),
                        **{k: profile.get(k) for k in (
                            "device_busy_ms", "step_ms", "idle_share",
                            "per_launch_ms")}}}


def slice_phase(torch, dev, cfg, kcodec, kstaging):
    """The main path on the card at full width: the three codecs' sync
    runs, one lossless auto bucket, the compressed reduce_scatter passes.
    Returns a summary dict."""
    from repro_torch.core.autotune import encode_plan
    from repro_torch.core.comm import Communicator
    from repro_torch.core.grid import RankGrid
    from repro_torch.models.params import leaf_views, param_shapes
    from repro_torch.train import manual_step as ms

    bucket_bytes = ms.DEFAULT_BUCKET_BYTES
    shapes = param_shapes(cfg)
    total = sum(int(torch.Size(s).numel()) for _, s in shapes)
    if total != cfg.n_params():
        raise AssertionError(f"layout has {total} params, config "
                             f"{cfg.n_params()}")
    grid = RankGrid(2, 4, dev)
    comm = Communicator(grid)
    world = grid.world
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    grads = torch.empty((world, total), dtype=torch.float32, device=dev)
    leaves = leaf_views(grads, shapes)  # the tree: views, no copies
    slices = ms.bucket_slices(total, bucket_bytes // 4)
    syncs = [sync_run(torch, comm, kcodec, kstaging, grads, slices, codec,
                      budget, gen, trace=codec == "int8_block")
             for codec, budget in SYNC_CODECS]

    # one lossless bucket through algo="auto"
    b = grads[:, :slices[0][1]]
    plan = comm.plan("allreduce", b[0].numel() * 4)
    y = comm.allreduce(b, algo="auto")
    exact = b.double().sum(0)
    bound = 8 * 2.0 ** -23 * b.double().abs().sum(0)
    if not bool(((y.double() - exact).abs() <= bound).all()):
        raise AssertionError("lossless auto allreduce outside the float32 "
                             "summation bound")
    del y, exact, bound
    rs = [reduce_scatter_run(torch, comm, kcodec, kstaging, grads, slices,
                             codec, gen) for codec, _ in SYNC_CODECS]
    peak = torch.cuda.max_memory_allocated(dev)
    if peak > PEAK_LIMIT_BYTES:
        raise AssertionError(f"peak device memory {peak} B over "
                             f"{PEAK_LIMIT_BYTES} B")
    return {
        "model": cfg.name, "grid": [grid.n_nodes, grid.n_local],
        "params_per_rank": total, "leaves": len(leaves),
        "buckets": len(slices), "bucket_bytes": bucket_bytes,
        "syncs": syncs, "reduce_scatter": rs,
        "auto_plan": encode_plan(plan.algo, plan.chunks, plan.codec),
        "peak_mem_bytes": peak,
    }


# ---------------------------------------------------------------------------
# phase 3: every (collective, algorithm) pair through the Communicator
# ---------------------------------------------------------------------------


def _operand(torch, coll, nbytes, dtype, world, gen, dev):
    """The global operand whose per-rank message is ``nbytes`` (the
    reference's ``example_input`` convention: a collective that splits its
    message over the ranks carries at least one element per peer)."""
    elems = max(1, nbytes // 4)
    s = max(1, elems // world)
    shape = {"allgather": (world * elems,), "scatter": (world * elems,),
             "broadcast": (elems,), "allreduce": (world, elems),
             "reduce_scatter": (world, world * s),
             "alltoall": (world, world, s)}[coll]
    if dtype == torch.int32:
        return torch.randint(-1000, 1000, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    return torch.randn(shape, generator=gen, device=dev)


def _check_pair(torch, compress, oracles, coll, x, got, world, N, P,
                codec):
    """Raise unless ``got`` is what ``coll`` must give on ``x``."""
    if coll in oracles.MOVEMENT:
        want = oracles.movement(coll, x, N, P, codec)
        if not torch.equal(got, want):
            raise AssertionError(f"not bitwise: max "
                                 f"{max_diff(torch, got, want)}")
        return
    exact = oracles.exact_sum(coll, x)
    if codec == "none":
        bound = 8 * 2.0 ** -23 * x.double().abs().sum(0)
        ok = bool(((got.double() - exact).abs() <= bound).all())
    else:
        tol = compress.collective_tolerance(codec, coll, world,
                                            float(x.abs().max()))
        ok = float((got.double() - exact).abs().max()) <= tol
    if not ok:
        raise AssertionError("outside its bound")


def _host_ms(torch, fn, n: int = TIME_ITERS) -> float:
    """Median host-clock time per call, each call ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def collectives_phase(torch, dev, kstaging):
    """Every pair, every variant, checked; one timing line per pair. The
    staging counts are zeroed just before each checked call and read just
    after: more than 0 where the plan moves rows (``oracles.moves_rows``),
    0 elsewhere (the compressed allreduce among them). Then one profiled
    pip_mcoll allgather at 8 B and at 4 MiB per rank, for the staging
    kernels' device time per launch on the path."""
    from repro_torch.core import compress, mcoll, oracles, runtime
    from repro_torch.core.comm import Communicator
    from repro_torch.core.grid import RankGrid

    N, P = 2, 4
    comm = Communicator(RankGrid(N, P, dev))
    world = N * P
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    lines, checked = [], 0
    staged = {k: 0 for k in kstaging.launches}
    for coll in runtime.collectives():
        for algo in mcoll.algorithms(coll):
            variants = [(nb, torch.float32, {}) for nb in COLL_SIZES]
            variants.append((64 << 10, torch.int32, {}))
            if mcoll.supports_chunks(coll, algo):
                variants += [(nb, torch.float32, {"chunks": 3})
                             for nb in COLL_SIZES]
            if mcoll.supports_codec(coll, algo):
                variants += [(nb, torch.float32, {"codec": c})
                             for c, _ in SYNC_CODECS for nb in COLL_SIZES]
            times, moved = {}, {}
            for nbytes, dtype, knobs in variants:
                x = _operand(torch, coll, nbytes, dtype, world, gen, dev)
                what = (f"{coll}/{algo} {nbytes} B {dtype} "
                        f"{json.dumps(knobs)}")
                codec = knobs.get("codec", "none")
                torch.cuda.synchronize()
                kstaging.reset_launches()
                got = comm.invoke(coll, x, algo=algo, **knobs)
                torch.cuda.synchronize()
                launched = dict(kstaging.launches)
                try:
                    _check_pair(torch, compress, oracles, coll, x, got,
                                world, N, P, codec)
                except AssertionError as e:
                    raise AssertionError(f"{what}: {e}") from None
                moves = oracles.moves_rows(coll, algo, codec)
                if (sum(launched.values()) > 0) != moves:
                    raise AssertionError(
                        f"{what}: staging launches {launched}, expected "
                        f"{'more than 0' if moves else '0'}")
                for k, n in launched.items():
                    staged[k] += n
                checked += 1
                if not knobs and dtype == torch.float32:
                    moved[nbytes] = launched
                if not knobs and dtype == torch.float32 \
                        and nbytes in (COLL_SIZES[0], COLL_SIZES[-1]):
                    times[nbytes] = _host_ms(
                        torch, lambda: comm.invoke(coll, x, algo=algo))
            line = {"collective": coll, "algo": algo,
                    "variants": len(variants),
                    "ms_8B": times[COLL_SIZES[0]],
                    "ms_4MiB": times[COLL_SIZES[-1]],
                    "staging_launches_8B": moved[COLL_SIZES[0]]}
            print("collective " + json.dumps(line))
            lines.append(line)
    profiles = {}
    for nbytes in STAGING_SIZES:
        x = _operand(torch, "allgather", nbytes, torch.float32, world, gen,
                     dev)
        comm.allgather(x, algo="pip_mcoll")
        profiles[nbytes] = profile_call(
            torch, lambda: comm.allgather(x, algo="pip_mcoll"),
            STAGING_KERNELS)
    return {"pairs": len(lines), "checked": checked,
            "staging_launches": staged, "rows": lines,
            "allgather_profiles": profiles}


# ---------------------------------------------------------------------------
# phase 4: serving (the flash-decode kernel, then the Engine at full width)
# ---------------------------------------------------------------------------


def _flash_inputs(torch, B, S, H, KV, hd, dtype, gen, dev):
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


def _flash_bytes_ops(B, H, KV, hd, esize, valid):
    """What one flash-decode call must move and compute, for ``valid``
    positions read summed over the B rows: q, the valid K/V prefix of each
    row and the fp32 output; 4 flops per (query head, valid position, dim)
    (q.k and p.v)."""
    return (B * H * hd * esize + 2 * valid * KV * hd * esize + B * H * hd * 4,
            4 * H * hd * valid)


def _flash_timed(torch, kattn, ref, dev, gen, flush, H, KV, hd):
    """The kernel's time, the plain version's and one library call's at
    (SERVE_BATCH, SERVE_LEN, H, KV, hd), bf16, every row at SERVE_LEN,
    with the bound."""
    B, S = SERVE_BATCH, SERVE_LEN
    q, k, v = _flash_inputs(torch, B, S, H, KV, hd, torch.bfloat16, gen, dev)
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    nbytes, ops = _flash_bytes_ops(B, H, KV, hd, q.element_size(), B * S)
    bound, bound_by = bound_ms(nbytes, ops)
    # the library yardstick: one SDPA call with a per-row length mask
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, enable_gqa=True)

    lib_err = max_diff(torch, library().float().transpose(1, 2).reshape(
        B, 1, H * hd), ref.flash_decode(q, k, v, lengths))
    return {
        "ms": time_ms(torch, lambda: kattn.flash_decode(q, k, v, lengths),
                      flush),
        "plain_ms": time_ms(torch, lambda: ref.flash_decode(q, k, v,
                                                            lengths), flush),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": time_ms(torch, library, flush),
        "library_max_abs_err": lib_err,
        "bytes": nbytes, "shape": [B, S, H, KV, hd], "dtype": "bfloat16"}


def _check_flash(torch, kattn, ref, q, k, v, lengths, what):
    """The kernel's output within ``FLASH_TOL * (1 + |plain|)`` of the
    plain version's; returns the largest absolute difference."""
    got = kattn.flash_decode(q, k, v, lengths)
    want = ref.flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    err = max_diff(torch, got, want)
    if not bool(torch.isfinite(got).all()) or not bool(
            ((got - want).abs() <= FLASH_TOL * (1 + want.abs())).all()):
        raise AssertionError(f"flash_decode {what} lengths={lengths}: max "
                             f"error {err} outside {FLASH_TOL} * (1 + "
                             f"|plain|)")
    return err


def flash_phase(torch, kattn, ref, dev):
    """The flash-decode kernel against its plain version at the serving
    shapes (smollm's full width, jamba's G 8, hd 128, and the reduced
    config's G 2, hd 32), at S = 2048 and at S = 1000 (no multiple of
    512), bf16 and fp32, for (B,) lengths (full, 1, mixed), scalar lengths
    (1, S // 3, S) and the all-masked length 0; then the split-S grid's
    own edges at smollm's and jamba's shapes, B 8 and B 1 (the most
    splits): every boundary of the kernel's split count +-1, and lengths 0
    and -3 (every split all-masked); the combine tickets must be back at
    zero. Then its time, the plain version's and one library call's at
    smollm's and jamba's full-width shapes with every row at S. Returns
    its record (without launches)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst, checked = 0.0, 0
    for B, S, H, KV, hd in ((SERVE_BATCH, SERVE_LEN, 15, 5, 64),
                            (SERVE_BATCH, 1000, 15, 5, 64),
                            (SERVE_BATCH, SERVE_LEN, 64, 8, 128),
                            (SERVE_BATCH, 1000, 64, 8, 128),
                            (SERVE_BATCH, SERVE_LEN, 4, 2, 32),
                            (SERVE_BATCH, 1000, 4, 2, 32)):
        mixed = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                              dtype=torch.int32)
        mixed[0], mixed[1] = S, 1
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _flash_inputs(torch, B, S, H, KV, hd, dtype, gen, dev)
            for lengths in (torch.full((B,), S, dtype=torch.int32,
                                       device=dev),
                            torch.ones((B,), dtype=torch.int32, device=dev),
                            mixed, 1, S // 3, S, 0):
                worst = max(worst, _check_flash(
                    torch, kattn, ref, q, k, v, lengths,
                    f"B={B} S={S} H={H} KV={KV} hd={hd} {dtype}"))
                checked += 1
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = {}
    for B, H, KV, hd in ((SERVE_BATCH, 15, 5, 64), (1, 15, 5, 64),
                         (SERVE_BATCH, 64, 8, 128), (1, 64, 8, 128)):
        S = SERVE_LEN
        q, k, v = _flash_inputs(torch, B, S, H, KV, hd, torch.bfloat16, gen,
                                dev)
        n = kattn.split_count(B, KV, S, hd, 2, n_sm)
        span = -(-S // n)
        splits[f"B={B} H={H} KV={KV} hd={hd}"] = {"n_split": n, "span": span}
        edges = [e + d for e in range(span, S, span) for d in (-1, 0, 1)]
        for lengths in (*edges, 0, -3):
            worst = max(worst, _check_flash(
                torch, kattn, ref, q, k, v, lengths,
                f"B={B} S={S} H={H} KV={KV} hd={hd} {n} splits"))
            checked += 1
    if any(bool(t.any()) for t in kattn._tickets.values()):
        raise AssertionError("flash_decode left a combine ticket non-zero")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    smollm = _flash_timed(torch, kattn, ref, dev, gen, flush, 15, 5, 64)
    return {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:60",
        "max_abs_err": worst, "tolerance": f"{FLASH_TOL} * (1 + |plain|)",
        "cases_checked": checked, "splits": splits, **smollm,
        "library_call": "scaled_dot_product_attention(attn_mask=<per-row "
                        "length mask>, enable_gqa=True), bf16 out",
        "jamba_shape": _flash_timed(torch, kattn, ref, dev, gen, flush, 64,
                                    8, 128)}


def _rwkv_inputs(torch, B, T, H, hd, dtype, zero_state, gen, dev):
    """r, k, v in ``dtype``; the decay w in (0, 0.98), u and s0 float32."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    r, k, v = (randn(B, T, H, hd).to(dtype) for _ in range(3))
    w = torch.sigmoid(randn(B, T, H, hd)) * 0.98
    u = randn(H, hd) * 0.1
    s0 = torch.zeros((B, H, hd, hd), device=dev) if zero_state \
        else randn(B, H, hd, hd) * 0.1
    return r, k, v, w, u, s0


def _rwkv_bytes_ops(B, T, H, hd, esize):
    """What one WKV6 call must move and compute: r, k, v in their type, w
    and y in fp32, s0 read and sT written once, u once; 5 fp32 flops per
    (step, head, state element), 2 for y's sum over the state and 3 for the
    update, and 3 per (step, head, lane) for the bonus term's dot product
    sum_i r_i u_i k_i (it multiplies v_j, not each state element)."""
    return (B * T * H * hd * (3 * esize + 4 + 4) + 2 * B * H * hd * hd * 4
            + H * hd * 4, 5 * B * T * H * hd * hd + 3 * B * T * H * hd)


def _check_rwkv(torch, what, got, want):
    """``got`` (y, sT) within ``RWKV_TOL * (1 + |plain|)`` of ``want``;
    returns the worst absolute difference."""
    worst = 0.0
    for name, a, b in (("y", got[0], want[0]), ("sT", got[1], want[1])):
        if a.shape != b.shape or not bool(torch.isfinite(a).all()) or not \
                bool(((a - b).abs() <= RWKV_TOL * (1 + b.abs())).all()):
            raise AssertionError(f"rwkv6_wkv {what}: {name} max error "
                                 f"{max_diff(torch, a, b)} outside "
                                 f"{RWKV_TOL} * (1 + |plain|)")
        worst = max(worst, max_diff(torch, a, b))
    return worst


def rwkv_phase(torch, krwkv, ref, dev):
    """The WKV6 kernels against their plain version at the serving shapes,
    through the wrapper's dispatch (the tick kernel below one chunk of
    steps, the chunked one from there): the decode tick (B 8, T 1) and
    prefills (B 1, T 1024 and 1000) of full-width rwkv6-1.6b (H 32, hd 64),
    the reduced config (H 4, hd 32, T 7 and 130), and the tick kernel at hd
    20 and 128, 1 and 9-12 steps; bf16 and fp32 r/k/v, s0 zero and random,
    and the final state written over s0 (it must equal the separate
    output). Then the tick kernel at the decode tick and at 7 steps, hd 20,
    and the chunked kernel alone at one chunk -1, +0 and +1 steps (H 32, hd
    64) and at T 130 (H 4, hd 20), with a tenth of the decays exactly 0 or
    subnormal, the final state also over s0; the recurrent kernel (which
    only ``rwkv6_wkv_recurrent`` reaches) at the tick and at T 130. Then
    the times at the decode and the 1024-step prefill shapes: the tick
    kernel at the decode (events and CUPTI), the recurrent kernel at both
    (CUPTI at the decode too; the prefill for comparison: the dispatch
    takes the chunked one there), the chunked one at the prefill with its
    two passes profiled, each plain version, and the bounds. Returns the
    two records (without launches)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    keys = ("rwkv6_wkv", "rwkv6_wkv_recurrent", "rwkv6_wkv_chunked")
    worst = dict.fromkeys(keys, 0.0)
    checked = dict.fromkeys(keys, 0)

    def check(what, launch, ops, key):
        want = ref.rwkv6_wkv(*ops)
        before = dict(krwkv.launches)
        got = launch(*ops)
        torch.cuda.synchronize()
        if krwkv.launches != {**before, key: before[key] + 1}:
            raise AssertionError(f"rwkv6_wkv {what}: launches "
                                 f"{krwkv.launches}, expected one more "
                                 f"{key} than {before}")
        worst[key] = max(worst[key], _check_rwkv(torch, what, got, want))
        s0 = ops[-1]
        y2, s2 = launch(*ops[:-1], s0, state_out=s0)
        torch.cuda.synchronize()
        if s2 is not s0 or not torch.equal(y2, got[0]) or \
                not torch.equal(s0, got[1]):
            raise AssertionError(f"rwkv6_wkv {what}: the state written "
                                 f"over s0 differs from the separate output")
        checked[key] += 1

    for B, T, H, hd in ((SERVE_BATCH, 1, 32, 64), (1, 1024, 32, 64),
                        (1, 1000, 32, 64), (SERVE_BATCH, 7, 4, 32),
                        (2, 130, 4, 32), (SERVE_BATCH, 1, 4, 20),
                        (2, 9, 4, 20), (SERVE_BATCH, 1, 2, 128),
                        (1, 12, 2, 128)):
        key = "rwkv6_wkv_chunked" if T >= krwkv.CHUNKED_FROM \
            else "rwkv6_wkv"
        for dtype in (torch.bfloat16, torch.float32):
            for zero_state in (True, False):
                ops = _rwkv_inputs(torch, B, T, H, hd, dtype, zero_state,
                                   gen, dev)
                check(f"B={B} T={T} H={H} hd={hd} {dtype} s0="
                      f"{'zero' if zero_state else 'random'}",
                      krwkv.rwkv6_wkv, ops, key)
    tiny = torch.tensor([1e-39, 1e-42, 1e-45], device=dev)
    for B, T, H, hd, key in (
            (SERVE_BATCH, 1, 32, 64, "rwkv6_wkv"), (2, 7, 4, 20, "rwkv6_wkv"),
            (1, krwkv.CHUNK - 1, 32, 64, "rwkv6_wkv_chunked"),
            (1, krwkv.CHUNK, 32, 64, "rwkv6_wkv_chunked"),
            (1, krwkv.CHUNK + 1, 32, 64, "rwkv6_wkv_chunked"),
            (2, 130, 4, 20, "rwkv6_wkv_chunked")):
        launch = krwkv.rwkv6_wkv_chunked if key == "rwkv6_wkv_chunked" \
            else krwkv.rwkv6_wkv
        for decays in ("zeros", "subnormal"):
            for dtype in (torch.bfloat16, torch.float32):
                ops = _rwkv_inputs(torch, B, T, H, hd, dtype, False, gen,
                                   dev)
                w = ops[3]
                pick = torch.rand(w.shape, generator=gen, device=dev) < 0.1
                w[pick] = 0.0 if decays == "zeros" else tiny[torch.randint(
                    0, 3, (int(pick.sum()),), generator=gen, device=dev)]
                check(f"{key} B={B} T={T} H={H} hd={hd} {dtype} decays "
                      f"{decays}", launch, ops, key)
    for B, T, H, hd in ((SERVE_BATCH, 1, 32, 64), (2, 130, 4, 32)):
        for dtype in (torch.bfloat16, torch.float32):
            ops = _rwkv_inputs(torch, B, T, H, hd, dtype, False, gen, dev)
            check(f"recurrent B={B} T={T} H={H} hd={hd} {dtype}",
                  krwkv.rwkv6_wkv_recurrent, ops, "rwkv6_wkv_recurrent")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    timed = {}
    for tag, (B, T) in (("decode", (SERVE_BATCH, 1)), ("prefill", (1, 1024))):
        H, hd = 32, 64
        ops = _rwkv_inputs(torch, B, T, H, hd, torch.bfloat16, False, gen,
                           dev)
        nbytes, nops = _rwkv_bytes_ops(B, T, H, hd, 2)
        bound, bound_by = bound_ms(nbytes, nops)
        timed[tag] = {
            "shape": [B, T, H, hd], "dtype": "bfloat16", "bytes": nbytes,
            "flops": nops, "bound_ms": bound, "bound_by": bound_by,
            "recurrent_ms": time_ms(
                torch, lambda: krwkv.rwkv6_wkv_recurrent(*ops), flush),
            # the plain version queues some 7 launches per step: at T 1024
            # more than the device's queue holds behind the spin
            "plain_ms": time_ms(torch, lambda: ref.rwkv6_wkv(*ops), flush,
                                spin=T == 1),
            "plain_timing": "device time" if T == 1 else
                            "events around the call, host dispatch "
                            "included"}
        if tag == "decode":
            timed[tag].update({
                "tick_ms": time_ms(torch, lambda: krwkv.rwkv6_wkv(*ops),
                                   flush),
                "tick_cupti_ms": cupti_ms(
                    torch, lambda: krwkv.rwkv6_wkv(*ops), flush,
                    TICK_KERNEL),
                "recurrent_cupti_ms": cupti_ms(
                    torch, lambda: krwkv.rwkv6_wkv_recurrent(*ops), flush,
                    RECURRENT_KERNEL),
                "event_floor_ms": event_floor_ms(torch, dev, flush)})
        if tag == "prefill":
            timed[tag].update({
                "chunked_ms": time_ms(
                    torch, lambda: krwkv.rwkv6_wkv_chunked(*ops), flush),
                "chunked_plain_ms": time_ms(
                    torch, lambda: ref.rwkv6_wkv_chunked(*ops), flush,
                    spin=False),
                # a trace that recorded no device time is "not measured"
                "passes": profile_call(
                    torch, lambda: krwkv.rwkv6_wkv_chunked(*ops),
                    CHUNKED_PASSES).get("per_launch_ms", "not measured")})
    dec, pre = timed["decode"], timed["prefill"]
    common = {"route": "cuda",
              "source": "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
              "replaces": "src/repro/kernels/rwkv6_wkv.py:51",
              "tolerance": f"{RWKV_TOL} * (1 + |plain|)",
              "library_ms": None, "dtype": "bfloat16"}
    return {
        "rwkv6_wkv": {
            "name": "rwkv6_wkv", **common,
            "cuda_kernel": "rwkv6_wkv_tick_kernel<T, HD, VEC, EXACT, ONE> "
                           "(a (b, h) state over 4 * HD threads, whole-row "
                           "warp loads; calls of fewer than "
                           f"{krwkv.CHUNKED_FROM} steps)",
            "max_abs_err": worst["rwkv6_wkv"],
            "cases_checked": checked["rwkv6_wkv"],
            "ms": dec["tick_ms"], "kernel_cupti_ms": dec["tick_cupti_ms"],
            "event_floor_ms": dec["event_floor_ms"],
            "plain_ms": dec["plain_ms"],
            "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
            "bytes": dec["bytes"], "shape": dec["shape"],
            "recurrent": {
                "cuda_kernel": "rwkv6_wkv_kernel<T, HD> (rwkv6_wkv_"
                               "recurrent only)",
                "max_abs_err": worst["rwkv6_wkv_recurrent"],
                "cases_checked": checked["rwkv6_wkv_recurrent"],
                "ms": dec["recurrent_ms"],
                "kernel_cupti_ms": dec["recurrent_cupti_ms"],
                "prefill_for_comparison": {
                    "shape": pre["shape"], "ms": pre["recurrent_ms"],
                    "bound_ms": pre["bound_ms"]}}},
        "rwkv6_wkv_chunked": {
            "name": "rwkv6_wkv_chunked", **common,
            "cuda_kernel": " + ".join(CHUNKED_PASSES) + " (chunks of "
                           f"{krwkv.CHUNK} steps; calls of "
                           f"{krwkv.CHUNKED_FROM} steps or more)",
            "launches_per_call": len(CHUNKED_PASSES),
            "max_abs_err": worst["rwkv6_wkv_chunked"],
            "cases_checked": checked["rwkv6_wkv_chunked"],
            "ms": pre["chunked_ms"], "plain_ms": pre["chunked_plain_ms"],
            "plain_timing": "events around the call, host dispatch "
                            "included",
            "sequential_plain_ms": pre["plain_ms"],
            "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
            "passes_ms": pre["passes"], "bytes": pre["bytes"],
            "shape": pre["shape"]}}


def _mamba_inputs(torch, B, T, Di, N, dtype, zero_state, gen, dev):
    """dt (softplus of a normal), A (negative), Bm, Cm float32, x in
    ``dtype``, h0 float32 (None for a zero state)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(randn(B, T, Di))
    A = -torch.exp(randn(Di, N) * 0.5)
    Bm, Cm = randn(B, T, N), randn(B, T, N)
    x = randn(B, T, Di).to(dtype)
    return dt, A, Bm, Cm, x, None if zero_state else randn(B, Di, N) * 0.1


def _mamba_work(B, T, Di, N, esize):
    """What one scan call from a carried state must move and compute: dt
    and y in fp32 and x in its type over (B, T, Di), Bm and Cm in fp32,
    A once, h0 read and hT written once; SCAN_OPS_PER_ELEM fp32 operations
    per (step, channel, state) plus dt*x per (step, channel); and B*T*Di*N
    exponentials. Returns (bytes, operations, exponentials)."""
    return (B * T * Di * (4 + esize + 4) + 2 * B * T * N * 4 + Di * N * 4
            + 2 * B * Di * N * 4,
            SCAN_OPS_PER_ELEM * B * T * Di * N + B * T * Di, B * T * Di * N)


def _check_mamba(torch, what, got, want):
    """``got`` (y, hT) within ``MAMBA_TOL * (1 + |plain|)`` of ``want``;
    returns the worst absolute difference."""
    worst = 0.0
    for name, a, b in (("y", got[0], want[0]), ("hT", got[1], want[1])):
        if a.shape != b.shape or not bool(torch.isfinite(a).all()) or not \
                bool(((a - b).abs() <= MAMBA_TOL * (1 + b.abs())).all()):
            raise AssertionError(f"mamba_scan {what}: {name} max error "
                                 f"{max_diff(torch, a, b)} outside "
                                 f"{MAMBA_TOL} * (1 + |plain|)")
        worst = max(worst, max_diff(torch, a, b))
    return worst


def mamba_phase(torch, kmamba, ref, dev, sm_mhz):
    """The scan kernel against its plain version at the serving shapes:
    the decode tick (B 8, T 1) and prefills (B 1, T 1024 and 1000) of
    full-width jamba (Di 16384, N 16), the reduced config (Di 256, T 1
    and 130), and at T 130 N 5 and 32 and Di 200; bf16 and fp32 x, h0
    zero (none) and random, and the final state written over h0 (it must
    equal the separate output). Then the
    kernel's and the plain version's times at the tick and the 1024-step
    prefill, with their bounds (``scan_bound``, at ``sm_mhz``). Returns its
    record (without launches)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    worst, checked = 0.0, 0
    for B, T, Di, N in ((SERVE_BATCH, 1, 16384, 16), (1, 1024, 16384, 16),
                        (1, 1000, 16384, 16), (SERVE_BATCH, 1, 256, 16),
                        (2, 130, 256, 16), (2, 130, 256, 5),
                        (2, 130, 256, 32), (2, 130, 200, 16)):
        for dtype in (torch.bfloat16, torch.float32):
            for zero_state in (True, False):
                ops = _mamba_inputs(torch, B, T, Di, N, dtype, zero_state,
                                    gen, dev)
                what = f"B={B} T={T} Di={Di} N={N} {dtype} " \
                       f"h0={'none' if zero_state else 'random'}"
                want = ref.mamba_scan(*ops)
                got = kmamba.mamba_scan(*ops)
                torch.cuda.synchronize()
                worst = max(worst, _check_mamba(torch, what, got, want))
                h0 = torch.zeros_like(got[1]) if zero_state else ops[-1]
                y2, h2 = kmamba.mamba_scan(*ops[:-1], h0, state_out=h0)
                torch.cuda.synchronize()
                if h2 is not h0 or not torch.equal(y2, got[0]) or \
                        not torch.equal(h0, got[1]):
                    raise AssertionError(f"mamba_scan {what}: the state "
                                         f"written over h0 differs from "
                                         f"the separate output")
                checked += 1

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    timed = {}
    for tag, (B, T) in (("decode", (SERVE_BATCH, 1)), ("prefill", (1, 1024))):
        Di, N = 16384, 16
        ops = _mamba_inputs(torch, B, T, Di, N, torch.bfloat16, False, gen,
                            dev)
        nbytes, nops, exps = _mamba_work(B, T, Di, N, 2)
        bound, bound_by, terms = scan_bound(nbytes, nops, exps, sm_mhz)
        timed[tag] = {
            "shape": [B, T, Di, N], "dtype": "bfloat16", "bytes": nbytes,
            "flops": nops, "exponentials": exps,
            "ms": time_ms(torch, lambda: kmamba.mamba_scan(*ops), flush),
            # the plain version queues some 8 launches per step: at T 1024
            # more than the device's queue holds behind the spin
            "plain_ms": time_ms(torch, lambda: ref.mamba_scan(*ops), flush,
                                spin=T == 1),
            "plain_timing": "device time" if T == 1 else
                            "events around the call, host dispatch "
                            "included",
            "bound_ms": bound, "bound_by": bound_by,
            "bound_terms_ms": terms,
            "kernel_cupti_ms": cupti_ms(
                torch, lambda: kmamba.mamba_scan(*ops), flush, "mamba_scan")}
    dec = timed["decode"]
    return {
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:51",
        "max_abs_err": worst, "tolerance": f"{MAMBA_TOL} * (1 + |plain|)",
        "cases_checked": checked,
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "bound_terms_ms": dec["bound_terms_ms"], "sm_clock_max_mhz": sm_mhz,
        "library_ms": None, "bytes": dec["bytes"], "shape": dec["shape"],
        "dtype": "bfloat16", "kernel_cupti_ms": dec["kernel_cupti_ms"],
        "event_floor_ms": event_floor_ms(torch, dev, flush),
        "prefill": timed["prefill"]}


# ---------------------------------------------------------------------------
# phase 1, continued: the staging kernels
# ---------------------------------------------------------------------------


def _random_bits(torch, shape, dtype, gen, dev):
    """A tensor of ``dtype`` with random bits (NaN payloads and signed
    zeros among them for the float types)."""
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=gen, device=dev).bool()
    size = torch.empty((), dtype=dtype).element_size()
    return torch.randint(0, 256, tuple(shape) + (size,), generator=gen,
                         device=dev, dtype=torch.uint8).view(dtype).reshape(
                             shape)


def _staging_maps(torch, kstaging, dev):
    """The flat source maps that ``ppermute`` hands ``pack_blocks`` in one
    pip_mcoll allgather (its multi-object round: -1 on the lanes that
    receive nothing) and in one Bruck allgather (its second round, a shift
    by 2 where every rank receives), recorded from those two collectives on
    the 2x4 grid at 8 B per rank."""
    from repro_torch.core.comm import Communicator
    from repro_torch.core.grid import RankGrid

    comm = Communicator(RankGrid(2, 4, dev))
    x = torch.zeros((8, 2), device=dev)
    pack, maps = kstaging.pack_blocks, {}

    def record(src, idx):
        if idx.dim() == 1:  # the flat form: a ppermute round
            maps.setdefault(algo, []).append(idx.clone())
        return pack(src, idx)

    kstaging.pack_blocks = record
    try:
        for algo in ("pip_mcoll", "bruck"):
            comm.allgather(x, algo=algo)
    finally:
        kstaging.pack_blocks = pack
    torch.cuda.synchronize()
    mo, shift = maps["pip_mcoll"][0], maps["bruck"][1]
    if not bool((mo < 0).any()) or bool((shift < 0).any()):
        raise AssertionError(f"recorded source maps {mo.tolist()} (pip_mcoll) "
                             f"and {shift.tolist()} (Bruck): expected -1 in "
                             f"the first and none in the second")
    return mo, shift


def staging_phase(torch, kstaging, ref, dev):
    """The staging kernels against their plain versions, bitwise, on the
    card: pip_mcoll allgather's step-6 buffer V (8, 2, 4·m) rolled by the
    node index and Bruck's (8, 8, m) rolled by the rank, at 8 B and 4 MiB
    per rank; the ring's per-rank take (8, 8) of Bruck's buffer; the
    multi-object round's flat source map (-1 on three lanes of each node)
    over the sliced V[:, :1]; a full shift map over a slice of Bruck's
    buffer; pip_mcoll scatter's lane slice (m scalar rows per rank of a
    strided source); then float32, bf16, int8, uint64 and bool rows of
    lengths that are no multiple of 16 B (sliced, strided and whole
    sources, shifts of either sign, indices outside the rows); and
    zero-size operands, which launch nothing. Then the times at the main
    path's shapes. Returns the two records (without launches)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    W, N, P = 8, 2, 4
    r = torch.arange(W, device=dev)
    node = r // P
    ring = (r[:, None] - torch.arange(W, device=dev)[None, :]) % W
    mo_map, full_map = _staging_maps(torch, kstaging, dev)
    checked = {"shift_blocks": 0, "pack_blocks": 0}
    worst = {"shift_blocks": 0, "pack_blocks": 0}

    def check(kernel, what, *args):
        got = getattr(kstaging, kernel)(*args)
        want = getattr(ref, kernel)(*args)
        torch.cuda.synchronize()
        worst[kernel] = max(worst[kernel], byte_diff(torch, got, want))
        if not same_bits(torch, got, want):
            raise AssertionError(f"{kernel} {what}: differs from its plain "
                                 f"version")
        checked[kernel] += 1

    for nbytes in STAGING_SIZES:
        m = max(1, nbytes // 4)
        V = _random_bits(torch, (W, N, P * m), torch.float32, gen, dev)
        Bk = _random_bits(torch, (W, W, m), torch.float32, gen, dev)
        check("shift_blocks", f"V {nbytes} B per rank", V, node)
        check("shift_blocks", f"Bruck {nbytes} B per rank", Bk, r)
        check("pack_blocks", f"ring take {nbytes} B per rank", Bk, ring)
        check("pack_blocks", f"multi-object round {nbytes} B per rank",
              V[:, :1], mo_map)
        check("pack_blocks", f"shift round {nbytes} B per rank",
              Bk[:, 2:4], full_map)
        lane = (r % P * m)[:, None] + torch.arange(m, device=dev)[None, :]
        check("pack_blocks", f"scatter lane slice {nbytes} B per rank",
              V[:, 0], lane)
        del V, Bk
    idx = torch.stack([(r * 3 + k) % 8 - 1 for k in range(3)], 1)
    for dtype in (torch.float32, torch.bfloat16, torch.int8, torch.uint64,
                  torch.bool):
        for m in (1, 3, 5, 7, 33, 1001):
            x = _random_bits(torch, (W, 6, m), dtype, gen, dev)
            for what, src in (("whole", x), ("sliced", x[:, 1:5]),
                              ("strided rows", x[:, :, :(m + 1) // 2])):
                label = f"{dtype} rows of {m} ({what})"
                check("shift_blocks", label, src, r * 5 - 7)
                check("pack_blocks", label + " per rank", src, idx)
                check("pack_blocks", label + " flat", src, mo_map)
    kstaging.reset_launches()
    empty = (kstaging.shift_blocks(torch.zeros((W, 0, 3), device=dev), r),
             kstaging.pack_blocks(torch.zeros((W, 5), device=dev),
                                  r[:0]),
             kstaging.pack_blocks(torch.zeros((W, 4, 0), device=dev), idx))
    if [tuple(t.shape) for t in empty] != [(W, 0, 3), (0, 5), (W, 3, 0)] \
            or any(kstaging.launches.values()):
        raise AssertionError(f"zero-size staging operands: shapes "
                             f"{[tuple(t.shape) for t in empty]}, launches "
                             f"{kstaging.launches}")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = r[:, None]
    # the multi-object round reads only the rows that are sent
    sent = int((mo_map >= 0).sum())
    timed = {"shift_blocks": {}, "pack_blocks": {}}
    for nbytes in STAGING_SIZES:
        m = max(1, nbytes // 4)
        V = torch.randn((W, N, P * m), generator=gen, device=dev)
        Bk = torch.randn((W, W, m), generator=gen, device=dev)
        sidx = (torch.arange(N, device=dev)[None, :] - node[:, None]) % N
        lane = (r % P * m)[:, None] + torch.arange(m, device=dev)[None, :]
        src = Bk[:, 2:4]
        # each output byte read once and written once, plus the int64
        # shift or index per row
        cases = {
            "shift_blocks": ("V", V, node, lambda: V[rows, sidx],
                             2 * V.numel() * 4 + 8 * W,
                             "v[rows[:, None], idx] (advanced indexing, "
                             "the index precomputed)"),
            "pack_blocks": ("flat shift round", src, full_map,
                            lambda: src.index_select(0, full_map),
                            2 * src.numel() * 4 + 8 * W, "index_select"),
            "pack_per_rank": ("ring take", Bk, ring,
                              lambda: Bk[rows, ring],
                              2 * Bk.numel() * 4 + 8 * W * W,
                              "x[rows[:, None], idx] (advanced indexing)"),
            "pack_multi_object": ("multi-object round", V[:, :1], mo_map,
                                  None, (sent + W) * P * m * 4 + 8 * W,
                                  None),
            # pip_mcoll scatter's last step: each rank takes its m scalar
            # rows of the node block (a strided source)
            "pack_scalar_rows": ("scatter's lane slice", V[:, 0], lane,
                                 lambda: V[:, 0][rows, lane],
                                 2 * W * m * 4 + 8 * W * m,
                                 "x[rows[:, None], idx] (advanced "
                                 "indexing)")}
        for key, (what, a, b, library, nb, lib_call) in cases.items():
            kernel = "shift_blocks" if key == "shift_blocks" \
                else "pack_blocks"
            k_fn = getattr(kstaging, kernel)
            p_fn = getattr(ref, kernel)
            bound, bound_by = bound_ms(nb, 0)
            timed[kernel].setdefault(key, {})[nbytes] = {
                "what": what, "shape": list(a.shape), "bytes": nb,
                "ms": time_ms(torch, lambda: k_fn(a, b), flush),
                # the plain versions read their row mask back to the host
                "plain_ms": time_ms(torch, lambda: p_fn(a, b), flush,
                                    spin=False),
                "bound_ms": bound, "bound_by": bound_by,
                "library_ms": (time_ms(torch, library, flush)
                               if library else None),
                "library_call": lib_call}
        del V, Bk, src
    records = {}
    for kernel, line, main in (("shift_blocks", 34, "shift_blocks"),
                               ("pack_blocks", 60, "pack_blocks")):
        head = timed[kernel][main][STAGING_SIZES[-1]]
        records[kernel] = {
            "name": kernel, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/staging.cu",
            "replaces": f"src/repro/kernels/staging.py:{line}",
            "max_abs_err": worst[kernel], "tolerance": "bitwise",
            "max_abs_err_of": "the output bytes, read as uint8 (the rows "
                              "hold random bits, NaN payloads among them)",
            "cases_checked": checked[kernel],
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "library_call", "bytes",
                                    "shape", "what")},
            "plain_timing": "events around the call, its host read of the "
                            "row mask included",
            "dtype": "float32", "per_rank_bytes": STAGING_SIZES[-1],
            "timed": {key: {str(nb): t for nb, t in by_size.items()}
                      for key, by_size in timed[kernel].items()}}
    return records


def _serve_requests(np, vocab):
    rng = np.random.default_rng(SEED)
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1,
                        size=SERVE_REQUESTS)
    return [rng.integers(0, vocab, size=(int(n),), dtype=np.int32)
            for n in lens]


def _timed(fn, into):
    """``fn`` with its host-clock seconds appended to ``into`` per call
    (each call ends in a device-to-host read, so the clock covers its
    device work)."""
    def call(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        into.append(time.perf_counter() - t0)
        return out
    return call


def _flash_held(torch, kattn, ref, errs):
    """A stand-in for ``kattn.flash_decode`` that launches the kernel and
    holds its output within ``FLASH_TOL * (1 + |plain|)`` of the plain
    version on the call's own operands (the live cache and the (B,)
    lengths)."""
    launch = kattn.flash_decode

    def held(q, k, v, lengths):
        got = launch(q, k, v, lengths)
        want = ref.flash_decode(q, k, v, lengths)
        err = max_diff(torch, got, want)
        if not bool(torch.isfinite(got).all()) or not bool(
                ((got - want).abs() <= FLASH_TOL * (1 + want.abs())).all()):
            shown = lengths.tolist() if torch.is_tensor(lengths) \
                else lengths
            raise AssertionError(
                f"flash_decode on the serving path (layer call "
                f"{len(errs)}, lengths {shown}): max error "
                f"{err} outside {FLASH_TOL} * (1 + |plain|)")
        errs.append(err)
        return got
    return held


def forced_ticks(torch, step, caches, toks, index, runs, ticks, width):
    """``ticks`` decode steps ``step(toks, caches, index, flags) -> logits
    (B, 1, width)`` from ``toks`` (B, 1) at ``index`` (an int or a (B,)
    tensor), each run once per entry of ``runs``, ``(label, flags,
    swaps)``, every run from the caches as the tick found them (all their
    tensors restored in between); ``swaps`` maps ``(module, attribute)``
    to a stand-in set for that run only (a kernel wrapper held to its
    plain version, or the plain version itself). The first run is the
    kernel path; the last is the plain-version path, whose greedy tokens
    and caches feed the next step. Returns the worst |logit| difference of
    the kernel path from each other run (by label) and the largest |logit|
    of the plain-version path."""
    worst = {label: 0.0 for label, _, _ in runs[1:]}
    top = 0.0
    for _ in range(ticks):
        saved = [{n: t.clone() for n, t in c.items()} for c in caches]
        outs = []
        for i, (label, flags, swaps) in enumerate(runs):
            if i:
                for c, sv in zip(caches, saved):
                    for n in c:
                        c[n].copy_(sv[n])
            kept = {key: getattr(*key) for key in swaps}
            for (mod, attr), fn in swaps.items():
                setattr(mod, attr, fn)
            try:
                out = step(toks, caches, index, flags)
            finally:
                for (mod, attr), fn in kept.items():
                    setattr(mod, attr, fn)
            if out.shape != (toks.shape[0], 1, width) \
                    or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"teacher-forced {label} logits: shape "
                                     f"{tuple(out.shape)} or not finite")
            outs.append(out)
        for (label, _, _), out in zip(runs[1:], outs[1:]):
            worst[label] = max(worst[label], max_diff(torch, outs[0], out))
        top = max(top, float(outs[-1].float().abs().max()))
        toks = outs[-1][:, 0].argmax(-1, keepdim=True)
        index = index + 1
        del saved
    return worst, top


def teacher_forced(torch, eng, model, runs, ticks):
    """:func:`forced_ticks` of the engine's admitted slots, each at its own
    length."""
    toks = torch.tensor([[r.out_tokens[-1]] for r in eng.active],
                        device=eng.device)
    lengths = torch.tensor(eng.lengths, device=eng.device)
    return forced_ticks(
        torch, lambda t, c, i, f: model(t, c, i, flags=f)[0], eng.caches,
        toks, lengths, runs, ticks, model.lm_head.shape[1])


def _check_held(name, errs, want):
    if len(errs) != want:
        raise AssertionError(f"{len(errs)} {name} calls held to the plain "
                             f"version, expected {want}")


def serve_main(torch, dev, cfg, flags, kmods, hooks=False, **sync_kw):
    """The serving main path at full width: ``cfg`` in bf16 with random
    weights from a seeded generator, built with the default devices (the
    card) as the README's serving example builds it, served by
    ``Engine(max_batch=SERVE_BATCH, max_len=SERVE_LEN, flags=flags,
    mesh=RankGrid(2, 4), **sync_kw)``: SERVE_REQUESTS requests of SERVE_NEW
    tokens. Every kernel count of ``kmods`` is zeroed just before the run
    and read just after; then one call of the run's persistent sync op,
    alone, gives the launches a tick's sync makes (``sync_launches``), and
    with ``hooks`` the telemetry hooks' cost on that op
    (:func:`hook_cost`). Checks the tokens, the tick sync, and the tokens
    of a sync-free engine on the same weights (bitwise). Returns the
    model, an engine factory, the request factory and the run's record
    (with ``sync_plan``, the plan the tick sync resolved to)."""
    import numpy as np
    from repro_torch.core.grid import RankGrid
    from repro_torch.models import params as tparams
    from repro_torch.models.decoder import DecoderLM
    from repro_torch.serve.engine import Engine, Request

    gc.collect()  # the earlier phases' models and buffers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    # the README's serving example: the default device and grid (the card)
    model = DecoderLM(cfg, torch.Generator("cuda").manual_seed(SEED))
    if model.device != dev:
        raise AssertionError(f"model on {model.device}, expected {dev}")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != tparams.n_params(cfg):
        raise AssertionError(f"model has {n_params} params, the "
                             f"reference's tree {tparams.n_params(cfg)}")
    prompts = _serve_requests(np, cfg.vocab)

    def requests():
        return [Request(prompt=p.copy(), max_new_tokens=SERVE_NEW)
                for p in prompts]

    def engine(mesh):
        return Engine(model, cfg, max_batch=SERVE_BATCH, max_len=SERVE_LEN,
                      flags=flags, mesh=mesh, **sync_kw)

    # the main path: launch counts zeroed just before, read just after
    eng = engine(RankGrid(2, 4))
    prefill_s, decode_s = [], []
    eng._admit = _timed(eng._admit, prefill_s)
    eng._decode_tick = _timed(eng._decode_tick, decode_s)
    torch.cuda.synchronize()
    for km in kmods:
        km.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(requests())
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k: n for km in kmods for k, n in km.launches.items()}
    m = eng.metrics()
    if len(done) != SERVE_REQUESTS:
        raise AssertionError(f"served {len(done)} of {SERVE_REQUESTS}")
    for r in done:
        if len(r.out_tokens) != SERVE_NEW or not all(
                0 <= t < cfg.vocab for t in r.out_tokens):
            raise AssertionError(f"request of {len(r.prompt)} tokens: "
                                 f"{len(r.out_tokens)} tokens, expected "
                                 f"{SERVE_NEW} within the vocab")
    if m["sync_starts"] != m["ticks"] or m["plan_rebinds"]:
        raise AssertionError(f"tick sync: {m['sync_starts']} starts over "
                             f"{m['ticks']} ticks, {m['plan_rebinds']} "
                             f"rebinds")
    plan = eng._sync_op.plan
    # one call of the same persistent op, alone: a tick's sync launches
    # (its buffers were made in the engine's inference mode)
    with torch.inference_mode():
        tick_tokens = torch.zeros(SERVE_BATCH, dtype=torch.int32,
                                  device=dev)
        torch.cuda.synchronize()
        for km in kmods:
            km.reset_launches()
        eng._sync_op.start(tick_tokens).wait()
        torch.cuda.synchronize()
        sync_launches = {k: n for km in kmods
                         for k, n in km.launches.items() if n}
        hook = hook_cost(torch, eng._sync_op, tick_tokens) if hooks else None
    tokens = {tuple(r.prompt.tolist()): r.out_tokens for r in done}
    del eng, done

    # the same requests without the sync: the same tokens, bitwise
    ref_done = engine(None).run(requests())
    if {tuple(r.prompt.tolist()): r.out_tokens for r in ref_done} != tokens:
        raise AssertionError("tokens of the synced engine differ from the "
                             "sync-free engine's")
    del ref_done
    generated = SERVE_REQUESTS * SERVE_NEW
    record = {
        "model": cfg.name, "params": n_params, "dtype": "bfloat16",
        "init_s": init_s, "max_batch": SERVE_BATCH, "max_len": SERVE_LEN,
        "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW,
        "prompt_lens": [len(p) for p in prompts], "grid": [2, 4],
        "sync_plan": plan, "metrics": m, "wall_s": wall_s,
        "tokens_per_s": generated / wall_s,
        "prefill_s": {"p50": statistics.median(prefill_s),
                      "max": max(prefill_s), "n": len(prefill_s),
                      "total": sum(prefill_s)},
        "decode_tick_s": {"p50": statistics.median(decode_s),
                          "p99": sorted(decode_s)[
                              int(0.99 * (len(decode_s) - 1))],
                          "n": len(decode_s)},
        "launches": launches, "sync_launches": sync_launches}
    if hook is not None:
        record["hook_cost"] = hook
    return model, engine, requests, record


def hook_cost(torch, op, x, blocks: int = HOOK_BLOCKS,
              pairs: int = HOOK_PAIRS):
    """The telemetry hooks' cost, telemetry disabled, on a persistent op's
    blocking round trip ``op.start(x).wait()`` (after the reference's
    ``tests/checks/telemetry_check.py`` part 3): against a stripped copy of
    ``PersistentOp.start`` and ``CollHandle.wait`` without the hook lines,
    the two interleaved pairwise, ``pairs`` of each in each of ``blocks``
    blocks; the cost is the min over blocks of the instrumented medians
    over the min of the stripped ones, less 1, and must stay under
    ``HOOK_LIMIT``. Also gives the reference's hook-level bound: what the
    disabled hooks execute (an ``enabled()`` read and the token checks),
    timed in a tight loop, over the round trip."""
    from repro_torch.core import telemetry
    from repro_torch.core.comm import CollHandle

    if telemetry.enabled():
        raise AssertionError("the hook cost is measured with telemetry off")

    def instrumented():
        op.start(x).wait(block=True)

    def stripped():
        # PersistentOp.start + CollHandle.wait(block=True), hooks removed
        if op._released or op._inflight >= op.depth or op.carry:
            raise AssertionError("the op cannot start")
        op._check_operand(x)
        out = op._out[op.starts % op.depth]
        out.copy_(op._fn(x))
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(out.device))
        op._inflight += 1
        op.starts += 1
        handle = CollHandle(op, out, event)
        handle._done = True
        op._inflight -= 1
        event.synchronize()

    def hook_lines():
        if telemetry.enabled():
            raise AssertionError
        token, t0 = None, 0.0
        if token is not None:
            raise AssertionError
        return t0

    for _ in range(5):  # warm both
        instrumented()
        stripped()
    inst, strip = [], []
    for _ in range(blocks):
        a, b = [], []
        for r in range(pairs):
            first, second = (instrumented, stripped) if r % 2 else \
                (stripped, instrumented)
            t0 = time.perf_counter()
            first()
            t1 = time.perf_counter()
            second()
            t2 = time.perf_counter()
            (a if r % 2 else b).append(t1 - t0)
            (b if r % 2 else a).append(t2 - t1)
        inst.append(statistics.median(a))
        strip.append(statistics.median(b))
    reps = 200_000
    t0 = time.perf_counter()
    for _ in range(reps):
        hook_lines()
    hook_s = (time.perf_counter() - t0) / reps
    cost = min(inst) / min(strip) - 1.0
    if cost >= HOOK_LIMIT:
        raise AssertionError(f"disabled telemetry hooks cost {cost:.4f} of "
                             f"the tick sync's round trip ({min(inst)} s "
                             f"against {min(strip)} s stripped), over "
                             f"{HOOK_LIMIT}")
    return {"plan": op.plan, "blocks": blocks, "pairs": pairs,
            "instrumented_s": min(inst), "stripped_s": min(strip),
            "cost": cost, "limit": HOOK_LIMIT,
            "block_medians_s": {"instrumented": inst, "stripped": strip},
            "hook_lines_s": hook_s, "hook_lines_share": hook_s / min(inst)}


def _staged(record):
    """The staging launches of a serving run and its profiled tick's
    device time per staging launch."""
    per_launch = record["profile"].get("per_launch_ms", {})
    return {**{k: record["launches"].get(k, 0) for k in STAGING_NAMES},
            "tick_path_ms": {k: per_launch.get(k, "not measured")
                             for k in STAGING_KERNELS}}


def _with_sync(record, want):
    """``want`` plus the tick sync's launches times the ticks; a tick's sync
    launches the staging kernels exactly when its plan moves rows
    (``oracles.moves_rows``: the broadcast trees do, the vendor baseline
    does not)."""
    from repro_torch.core import autotune, oracles

    per_tick = record["sync_launches"]
    algo, _, codec = autotune.decode_plan(record["sync_plan"])
    staged = sum(per_tick.get(k, 0) for k in STAGING_NAMES)
    if bool(staged) != oracles.moves_rows("broadcast", algo, codec):
        raise AssertionError(f"the tick sync ({record['sync_plan']}) "
                             f"launched {staged} staging kernels: "
                             f"{per_tick}")
    ticks = record["metrics"]["ticks"]
    return {**want, **{k: want.get(k, 0) + n * ticks
                       for k, n in per_tick.items()}}


def _check_launches(what, launches, want):
    """Every counted kernel launched as ``want`` says, the others never."""
    expected = {k: want.get(k, 0) for k in launches}
    if launches != expected:
        raise AssertionError(f"{what}: kernel launches {launches}, expected "
                             f"{expected}")


def serve_phase(torch, dev, cfg, kattn, ref, kmods):
    """Full-width smollm-360m served by the Engine with the 2x4-grid token
    sync and the flash-decode kernel on every decode tick. Returns a
    summary dict."""
    import numpy as np
    from repro_torch.core.grid import RankGrid
    from repro_torch.models.decoder import RunFlags

    model, engine, requests, record = serve_main(
        torch, dev, cfg, RunFlags(use_flash_decode=True), kmods, hooks=True,
        sync_algo="auto", sync_error_budget=0.0)
    m, launches = record["metrics"], record["launches"]
    _check_launches("smollm serving", launches, _with_sync(
        record, {"flash_decode": m["ticks"] * cfg.n_layers}))

    # teacher-forced ticks: the kernel path against the plain-version path
    # on the same caches; then one profiled tick (with its sync)
    eng = engine(RankGrid(2, 4))
    with torch.inference_mode():
        for slot, req in enumerate(requests()[:SERVE_BATCH]):
            eng._admit(req, slot)
        # the kernel, the model's plain attention (it rounds the
        # probabilities to bf16 as the reference does), and the kernel's
        # plain version in its place
        errs = []
        worst, top = teacher_forced(
            torch, eng, model,
            [("kernel", RunFlags(use_flash_decode=True),
              {(kattn, "flash_decode"): _flash_held(torch, kattn, ref,
                                                    errs)}),
             ("plain attention", RunFlags(), {}),
             ("plain-version", RunFlags(use_flash_decode=True),
              {(kattn, "flash_decode"): ref.flash_decode})], TEACHER_TICKS)
        _check_held("flash_decode", errs, TEACHER_TICKS * cfg.n_layers)
        worst, worst_attn = worst["plain-version"], worst["plain attention"]
        if worst > TEACHER_TOL * top:
            raise AssertionError(f"teacher-forced logits: kernel path "
                                 f"{worst} from the plain-version path, "
                                 f"over {TEACHER_TOL} * {top}")
        # the profiled tick reads lengths + 1 positions per row
        valid = int(np.minimum(eng.lengths.astype(np.int64) + 1,
                               SERVE_LEN).sum())
        profile = profile_call(torch, eng._decode_tick,
                               ("flash_decode",) + STAGING_KERNELS)
    tick_bytes, tick_ops = _flash_bytes_ops(
        SERVE_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 2, valid)
    path_bound, _ = bound_ms(tick_bytes, tick_ops)
    record.update({
        "flash_launches": launches["flash_decode"],
        "teacher_forced": {"ticks": TEACHER_TICKS, "max_abs_err": worst,
                           "max_abs_logit": top,
                           "tolerance": f"{TEACHER_TOL} * max|logit|",
                           "max_abs_err_vs_plain_attention": worst_attn,
                           "kernel_calls_held_to_plain": len(errs),
                           "kernel_max_abs_err": max(errs),
                           "kernel_tolerance":
                               f"{FLASH_TOL} * (1 + |plain|)"},
        "profile": profile, "flash_path_bound_ms": path_bound,
        "flash_path_bytes": tick_bytes,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)})
    return record


def _rwkv_held(torch, krwkv, ref, errs):
    """A stand-in for ``krwkv.rwkv6_wkv`` that launches the kernel and
    holds its output and final state within ``RWKV_TOL * (1 + |plain|)``
    of the plain version on the call's own operands (the live state is
    copied first: the kernel writes the final state over it)."""
    launch = krwkv.rwkv6_wkv

    def held(r, k, v, w, u, s0, state_out=None):
        want = ref.rwkv6_wkv(r, k, v, w, u, s0.clone())
        got = launch(r, k, v, w, u, s0, state_out=state_out)
        errs.append(_check_rwkv(torch, f"on the serving path (layer call "
                                f"{len(errs)}, T={r.shape[1]})", got, want))
        return got
    return held


def rwkv_serve_phase(torch, dev, cfg, krwkv, ref, kmods):
    """Full-width rwkv6-1.6b served by the Engine with the 2x4-grid token
    sync and the WKV6 kernel in every layer, on every prefill and decode
    tick. Returns a summary dict."""
    from repro_torch.core.grid import RankGrid
    from repro_torch.models.decoder import RunFlags

    model, engine, requests, record = serve_main(
        torch, dev, cfg, RunFlags(use_rwkv_kernel=True), kmods)
    m, launches = record["metrics"], record["launches"]
    _check_launches("rwkv serving", launches, _with_sync(record, {
        "rwkv6_wkv": cfg.n_layers * m["ticks"],
        "rwkv6_wkv_chunked": cfg.n_layers * SERVE_REQUESTS}))

    eng = engine(RankGrid(2, 4))
    longest = max(requests(), key=lambda r: len(r.prompt))
    with torch.inference_mode():
        # the longest prompt's prefill, every layer's call held to plain
        errs = []
        launch = krwkv.rwkv6_wkv
        krwkv.rwkv6_wkv = _rwkv_held(torch, krwkv, ref, errs)
        try:
            eng._admit(longest, 0)
        finally:
            krwkv.rwkv6_wkv = launch
        _check_held("rwkv6_wkv", errs, cfg.n_layers)
        prefill_err = max(errs)
        # one profiled prefill of the same prompt into the same slot
        prefill_profile = profile_call(
            torch, lambda: eng._admit(longest, 0), CHUNKED_PASSES)
        for slot, req in enumerate(requests()[:SERVE_BATCH - 1]):
            eng._admit(req, slot + 1)
        # the kernel, then the plain recurrence (the plain-version path)
        errs = []
        worst, top = teacher_forced(
            torch, eng, model,
            [("kernel", RunFlags(use_rwkv_kernel=True),
              {(krwkv, "rwkv6_wkv"): _rwkv_held(torch, krwkv, ref, errs)}),
             ("plain-version", RunFlags(), {})], TEACHER_TICKS)
        _check_held("rwkv6_wkv", errs, TEACHER_TICKS * cfg.n_layers)
        worst = worst["plain-version"]
        if worst > TEACHER_TOL * top:
            raise AssertionError(f"teacher-forced logits: kernel path "
                                 f"{worst} from the plain-version path, "
                                 f"over {TEACHER_TOL} * {top}")
        profile = profile_call(torch, eng._decode_tick,
                               (TICK_KERNEL, RECURRENT_KERNEL)
                               + STAGING_KERNELS)
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    record.update({
        "rwkv_launches": launches["rwkv6_wkv"],
        "rwkv_chunked_launches": launches["rwkv6_wkv_chunked"],
        "held_to_plain": {
            "prefill_prompt_len": len(longest.prompt),
            "prefill_calls": cfg.n_layers,
            "prefill_max_abs_err": prefill_err,
            "tick_calls": len(errs), "tick_max_abs_err": max(errs),
            "tolerance": f"{RWKV_TOL} * (1 + |plain|)"},
        "teacher_forced": {"ticks": TEACHER_TICKS, "max_abs_err": worst,
                           "max_abs_logit": top,
                           "tolerance": f"{TEACHER_TOL} * max|logit|"},
        "profile": profile, "prefill_profile": prefill_profile,
        "rwkv_path_bound_ms": bound_ms(*_rwkv_bytes_ops(
            SERVE_BATCH, 1, H, hd, 2))[0],
        "rwkv_prefill_path_bound_ms": bound_ms(*_rwkv_bytes_ops(
            1, len(longest.prompt), H, hd, 2))[0],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)})
    return record


def _mamba_held(torch, kmamba, ref, errs):
    """A stand-in for ``kmamba.mamba_scan`` that launches the kernel and
    holds its output and final state within ``MAMBA_TOL * (1 + |plain|)``
    of the plain version on the call's own operands (the plain version
    copies the live state before the kernel writes over it)."""
    launch = kmamba.mamba_scan

    def held(dt, A, Bm, Cm, x, h0=None, state_out=None):
        want = ref.mamba_scan(dt, A, Bm, Cm, x, h0)
        got = launch(dt, A, Bm, Cm, x, h0, state_out=state_out)
        errs.append(_check_mamba(torch, f"on the serving path (layer call "
                                 f"{len(errs)}, T={dt.shape[1]})", got,
                                 want))
        return got
    return held


def _profile_experts(torch, fn, names=("mamba_scan", "flash_decode")):
    """:func:`profile_call` of ``fn`` with the MoE's expert products inside
    an ``EXPERT_RANGE`` profiler range, and the device-time shares of the
    expert products, the other matrix products and each kernel of
    ``names``."""
    from repro_torch.layers import moe as tmoe

    experts = tmoe.MoE._experts

    def ranged(self, *args):
        with torch.profiler.record_function(EXPERT_RANGE):
            return experts(self, *args)

    tmoe.MoE._experts = ranged
    try:
        prof = profile_call(torch, fn, tuple(names) + STAGING_KERNELS,
                            ranges=(EXPERT_RANGE,))
    finally:
        tmoe.MoE._experts = experts
    busy = prof["device_busy_ms"]
    expert_gemm = prof["ranges"][EXPERT_RANGE]["gemm_ms"] \
        if isinstance(busy, float) else "not measured"
    if isinstance(expert_gemm, float):
        prof["shares"] = {
            "expert_gemms": expert_gemm / busy,
            "other_gemms": (prof["gemm_ms"] - expert_gemm) / busy,
            **{name: prof["name_ms"][name] / busy for name in names}}
    return prof


def jamba_serve_phase(torch, dev, cfg, kattn, kmamba, ref, kmods):
    """Full-width jamba cut to its first five layers (four mamba, one
    attention, MoE on two) served by the Engine with the 2x4-grid token
    sync, the scan kernel in every mamba layer on every prefill and decode
    tick, and the flash-decode kernel in the attention layer on every
    tick. Returns a summary dict."""
    from repro_torch.core.grid import RankGrid
    from repro_torch.models.decoder import RunFlags

    flags = RunFlags(use_flash_decode=True, use_mamba_kernel=True)
    model, engine, requests, record = serve_main(torch, dev, cfg, flags,
                                                 kmods)
    m, launches = record["metrics"], record["launches"]
    pat = cfg.block_pattern
    kinds = [pat[i % len(pat)] for i in range(cfg.n_layers)]
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attn")
    _check_launches("jamba serving", launches, _with_sync(record, {
        "mamba_scan": n_mamba * (m["ticks"] + SERVE_REQUESTS),
        "flash_decode": n_attn * m["ticks"]}))

    eng = engine(RankGrid(2, 4))
    longest = max(requests(), key=lambda r: len(r.prompt))
    with torch.inference_mode():
        # the longest prompt's prefill, every mamba layer's call held
        errs = []
        launch = kmamba.mamba_scan
        kmamba.mamba_scan = _mamba_held(torch, kmamba, ref, errs)
        try:
            eng._admit(longest, 0)
        finally:
            kmamba.mamba_scan = launch
        _check_held("mamba_scan", errs, n_mamba)
        prefill_err = max(errs)
        # one profiled prefill of the same prompt into the same slot
        prefill_profile = _profile_experts(torch,
                                           lambda: eng._admit(longest, 0))
        for slot, req in enumerate(requests()[:SERVE_BATCH - 1]):
            eng._admit(req, slot + 1)
        # the kernels, then their plain versions (the plain scan and the
        # flash kernel's plain version)
        errs = []
        worst, top = teacher_forced(
            torch, eng, model,
            [("kernel", flags,
              {(kmamba, "mamba_scan"): _mamba_held(torch, kmamba, ref,
                                                   errs)}),
             ("plain-version", RunFlags(use_flash_decode=True),
              {(kattn, "flash_decode"): ref.flash_decode})], TEACHER_TICKS)
        _check_held("mamba_scan", errs, TEACHER_TICKS * n_mamba)
        worst = worst["plain-version"]
        if worst > TEACHER_TOL * top:
            raise AssertionError(f"teacher-forced logits: kernel path "
                                 f"{worst} from the plain-version path, "
                                 f"over {TEACHER_TOL} * {top}")
        profile = _profile_experts(torch, eng._decode_tick)
    Di, N = 2 * cfg.d_model, cfg.mamba_d_state
    record.update({
        "layers": kinds, "moe_layers": sum(hasattr(b, "moe")
                                           for b in model.blocks),
        "mamba_launches": launches["mamba_scan"],
        "flash_launches": launches["flash_decode"],
        "held_to_plain": {
            "prefill_prompt_len": len(longest.prompt),
            "prefill_calls": n_mamba, "prefill_max_abs_err": prefill_err,
            "tick_calls": len(errs), "tick_max_abs_err": max(errs),
            "tolerance": f"{MAMBA_TOL} * (1 + |plain|)"},
        "teacher_forced": {"ticks": TEACHER_TICKS, "max_abs_err": worst,
                           "max_abs_logit": top,
                           "tolerance": f"{TEACHER_TOL} * max|logit|"},
        "profile": profile, "prefill_profile": prefill_profile,
        "mamba_path_work": _mamba_work(SERVE_BATCH, 1, Di, N, 2),
        "mamba_prefill_path_work": _mamba_work(1, len(longest.prompt), Di,
                                               N, 2),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)})
    return record


# ---------------------------------------------------------------------------
# phase 7: calibration over the split lattice
# ---------------------------------------------------------------------------


def _fit_samples(comm, rows):
    """``costmodel.fit_net`` samples from the lossless calibration rows of
    ``comm`` and its split lattice, each with its group's topology."""
    topos = {c.topo.group: c.topo for c in (comm,) + comm.split_lattice()}
    return [(r.collective, r.algo, topos[r.group], r.nbytes, r.chunks,
             r.seconds) for r in rows if r.codec == "none"]


def _agreement(sections):
    """Over the ``model_vs_measured`` cells: how many the prior's algorithm
    (and full plan) matches the measured lossless argmin in, and the
    median |signed_rel_err| of the lossless per-plan rows."""
    cells = sections["model_vs_measured"]
    errs = [abs(pp["signed_rel_err"]) for c in cells for pp in c["per_plan"]
            if "@" not in pp["plan"] and pp["signed_rel_err"] is not None]
    return {"cells": len(cells),
            "agree_algo": sum(c["agree"] for c in cells),
            "agree_plan": sum(c["prior_plan"] == c["measured_plan"]
                              for c in cells),
            "median_abs_rel_err": statistics.median(errs),
            "rows": len(errs)}


def calibrate_phase(torch, dev):
    """``Communicator(RankGrid(2, 4)).calibrate(include_splits=True)`` on
    the card at ``CAL_SIZES``, every collective, into a selector of its own
    (the serving phases' plans stay the priors'), with telemetry on: every
    timed sample must be one synced plan observation (rows x iters). Every
    member of the lattice must then resolve ``auto`` at each calibrated
    size from measurement, to the argmin of its lossless rows; the table is
    saved, reloaded, and must resolve the same. Prints one ``calibrate``
    line per (group, collective, size) with every measured plan's median
    (codec plans as ``algo@codec``).

    Then the tuning loop: the artifact's calibrate sections
    (``artifact.calibration_sections``) validated by the port's schema and
    written to ``build/calibration_artifact.json``; a fresh fit of the
    link preset to the lossless rows (``costmodel.fit_net``), beside the
    checked-in ``h100_grid``; one ``calibrate_fit`` line with each preset's
    argmin agreement and median |signed rel err| on the same rows (the
    checked-in preset, the fresh fit, ``host_cpu``); and the drift leg
    (:func:`drift_leg`)."""
    from repro_torch.core import artifact, autotune, costmodel, runtime
    from repro_torch.core import telemetry
    from repro_torch.core.comm import Communicator
    from repro_torch.core.grid import RankGrid

    comm = Communicator(RankGrid(2, 4), selector=autotune.Selector())
    torch.cuda.synchronize()
    telemetry.reset()
    telemetry.enable()
    t0 = time.perf_counter()
    try:
        rows = comm.calibrate(include_splits=True, sizes=CAL_SIZES,
                              iters=CAL_ITERS)
    finally:
        telemetry.disable()
    seconds = time.perf_counter() - t0
    synced = sum(len(o.samples) for o in telemetry.plan_observations())
    if synced != len(rows) * CAL_ITERS:
        raise AssertionError(f"calibration: {synced} synced observations, "
                             f"expected {len(rows)} rows x {CAL_ITERS}")
    path = ROOT / "build" / "calibrated_table.json"
    comm.selector.table.save(path)
    loaded = autotune.Selector(autotune.TuningTable.load(path))
    best = []
    for c in (comm,) + comm.split_lattice():
        group = c.topo.group or "root"
        for coll in runtime.collectives():
            for nb in CAL_SIZES:
                measured = {autotune.encode_plan(r.algo, r.chunks,
                                                 r.codec): r.seconds
                            for r in rows if r.group == c.topo.group
                            and r.collective == coll and r.nbytes == nb}
                mine = {k: v for k, v in measured.items()
                        if autotune.decode_plan(k)[2] == "none"}
                sel = c.plan(coll, nb)
                plan = autotune.encode_plan(sel.algo, sel.chunks, sel.codec)
                if sel.source != "measured" or \
                        mine.get(plan) != min(mine.values()):
                    raise AssertionError(
                        f"calibrated {group} {coll} at {nb} B resolves to "
                        f"{plan} ({sel.source}); measured {mine}")
                again = loaded.choose(coll, c.topo, nb)
                if again.source != "measured" or (again.algo, again.chunks,
                                                  again.codec) != \
                        (sel.algo, sel.chunks, sel.codec):
                    raise AssertionError(f"reloaded table: {group} {coll} "
                                         f"at {nb} B resolves to {again}")
                line = {"group": group, "collective": coll, "nbytes": nb,
                        "auto": plan, "ms": {k: v * 1e3
                                             for k, v in measured.items()}}
                print("calibrate " + json.dumps(line))
                best.append(line)

    # the artifact, validated by the port's schema before it is written
    sections = artifact.calibration_sections(comm, rows)
    artifact.validate(sections, sections=CAL_SECTIONS)
    art_path = ROOT / "build" / "calibration_artifact.json"
    art_path.write_text(json.dumps(sections))
    artifact.validate_file(art_path, sections=CAL_SECTIONS)
    # a fresh fit beside the checked-in preset, each priced on these rows
    fitted, report = costmodel.fit_net(_fit_samples(comm, rows),
                                       "h100_grid")
    checked_in = costmodel.resolve_net(comm.topo.link_names[0])
    fit_line = {
        "link": comm.topo.link_names[0],
        "checked_in": dataclasses.asdict(checked_in),
        "fresh_fit": {**dataclasses.asdict(fitted),
                      **{k: v for k, v in report.items()
                         if k != "rel_err"}},
        "agreement": {
            "checked_in": _agreement(sections),
            "fresh_fit": _agreement(artifact.calibration_sections(
                comm, rows, link=fitted)),
            "host_cpu": _agreement(artifact.calibration_sections(
                comm, rows, link="host_cpu"))}}
    print("calibrate_fit " + json.dumps(fit_line))
    drift = drift_leg(torch, comm)
    return {"rows": len(rows), "seconds": seconds,
            "synced_observations": synced,
            "groups": sorted({r.group or "root" for r in rows}),
            "resolved": len(best), "table": str(path.relative_to(ROOT)),
            "artifact": str(art_path.relative_to(ROOT)),
            "fit": fit_line, "fit_rel_err": report["rel_err"],
            "drift": drift}


def drift_leg(torch, comm):
    """Drift and repair on the card, after the reference's
    ``tests/checks/telemetry_check.py`` part 2, on the calibrated root (its
    calibration's synced observations still held): the slowest lossless
    allreduce plan at 4 MiB per rank gets a table row of 1e-9 s and
    ``choose`` must take it; that plan then runs through a persistent op
    with ``DRIFT_WAITS`` blocking waits, telemetry on; ``drift_report`` must
    flag its row with ``drift_vs_table > 0.5``; ``Selector.ingest`` must
    repair the table, so that ``choose`` returns the measured argmin again
    and nothing of the victim is flagged."""
    from repro_torch.core import autotune, runtime, telemetry

    topo, sel, nb = comm.topo, comm.selector, CAL_SIZES[-1]
    good = sel.choose("allreduce", topo, nb)
    good_plan = autotune.encode_plan(good.algo, good.chunks, good.codec)
    entry = sel.table.lookup(topo, "allreduce", "float32", nb)
    lossless = {k: v for k, v in entry.items()
                if autotune.decode_plan(k)[2] == "none"}
    victim = max(lossless, key=lossless.get)
    sel.table.record(topo, "allreduce", "float32", nb, victim, 1e-9)
    hijacked = sel.choose("allreduce", topo, nb)
    if autotune.encode_plan(hijacked.algo, hijacked.chunks,
                            hijacked.codec) != victim:
        raise AssertionError(f"the poisoned {victim} row did not hijack "
                             f"choose: {hijacked}")
    algo, chunks, _ = autotune.decode_plan(victim)
    x = runtime.example_input("allreduce", topo, nb, device=comm.grid.device)
    telemetry.enable()
    try:
        op = comm.allreduce_init(x, algo=algo,
                                 chunks=chunks if chunks > 1 else None)
        for _ in range(DRIFT_WAITS):
            op.start(x).wait(block=True)
        op.release()
    finally:
        telemetry.disable()
    flagged = {r.plan: r for r in telemetry.drifted_plans(selector=sel)}
    row = flagged.get(victim)
    if row is None or row.table_s != 1e-9 or not row.drift_vs_table > 0.5:
        raise AssertionError(f"drift_report did not flag the poisoned "
                             f"{victim} row: {row}")
    ingested = sel.ingest(min_samples=2)
    repaired = sel.choose("allreduce", topo, nb)
    repaired_plan = autotune.encode_plan(repaired.algo, repaired.chunks,
                                         repaired.codec)
    if repaired_plan != good_plan or victim in {
            r.plan for r in telemetry.drifted_plans(selector=sel)}:
        raise AssertionError(f"ingest did not repair the table: choose "
                             f"gives {repaired_plan}, measured argmin "
                             f"{good_plan}")
    telemetry.reset()
    line = {"victim": victim, "victim_measured_s": lossless[victim],
            "argmin": good_plan, "argmin_s": lossless[good_plan],
            "flagged": dataclasses.asdict(row), "ingested": ingested,
            "repaired": repaired_plan}
    print("drift " + json.dumps(line))
    return line


#: line of each codec's feedback encode in ``src/repro/kernels/codec.py``
# ---------------------------------------------------------------------------
# phase 8: two processes on the card (the torch.distributed transport)
# ---------------------------------------------------------------------------

TP_PROCS, TP_RANKS = 2, 4
TP_SIZES = (COLL_SIZES[0], COLL_SIZES[-1])
#: timed calls per plan and size (median)
TP_ITERS = 5
#: a spawn's deadline, seconds
TP_TIMEOUT = 600
TP_CAL = ("allreduce", "broadcast")
TP_CAL_ITERS = 3
TP_TABLE = "two_process_table.json"
#: the workers' topology key: the node axis crosses processes (the "shm"
#: transport, which processes on one card choose), the local axis stays on
#: the card
TP_KEY = "2x4/h100_ipc/h100_grid"
#: the full-width sync step: codec and budget, as phase 2's int8 run
TP_CODEC, TP_BUDGET = SYNC_CODECS[0]


def tp_cases():
    """Every (collective, algorithm) pair at 8 B and 4 MiB per rank,
    float32 (a -0.0 on rank 0) and int32, each codec-capable one under the
    three codecs, and the compressed allreduces with an error-feedback
    carry: ``(collective, algo, nbytes, dtype, codec, carry)``."""
    from repro_torch.core import mcoll, runtime
    cases = []
    for coll in runtime.collectives():
        for algo in mcoll.algorithms(coll):
            for nb in TP_SIZES:
                cases += [(coll, algo, nb, "float32", "none", False),
                          (coll, algo, nb, "int32", "none", False)]
                if mcoll.supports_codec(coll, algo):
                    for codec, _ in SYNC_CODECS:
                        cases.append((coll, algo, nb, "float32", codec,
                                      False))
                        if runtime.supports_carry(coll, algo):
                            cases.append((coll, algo, nb, "float32", codec,
                                          True))
    return cases


def tp_operand(np, coll, nbytes, dtype, world=TP_PROCS * TP_RANKS):
    """The global operand of one case (``_operand``'s shapes), numpy-seeded
    from the case so every process draws the same; float32 holds a -0.0
    on rank 0."""
    elems = max(1, nbytes // 4)
    s = max(1, elems // world)
    shape = {"allgather": (world * elems,), "scatter": (world * elems,),
             "broadcast": (elems,), "allreduce": (world, elems),
             "reduce_scatter": (world, world * s),
             "alltoall": (world, world, s)}[coll]
    rng = np.random.default_rng([SEED, len(coll), nbytes, len(dtype)])
    if dtype == "int32":
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[0] = -0.0
    return x


def _tp_inputs(torch, np, case, dev, rows, cache):
    """``(x, err)`` of one case on ``dev``: this process's ``rows`` of a
    carry case's gradient and error (a held operand), else the full
    operand and no error. Operands are drawn once per (collective, size,
    dtype) and kept in ``cache``."""
    coll, _, nb, dtype, _, carry = case
    key = (coll, nb, dtype)
    if key not in cache:
        cache[key] = torch.from_numpy(tp_operand(np, coll, nb, dtype)).to(
            dev)
    x = cache[key]
    if not carry:
        return x, None
    if nb not in cache:
        rng = np.random.default_rng([SEED, 7, nb])
        cache[nb] = torch.from_numpy((rng.standard_normal(tuple(x.shape))
                                      * 1e-3).astype(np.float32)).to(dev)
    return x[rows].clone(), cache[nb][rows].clone()


def _tp_run(comm, case, x, err):
    """One call of a case: ``(result, new error or None)``."""
    coll, algo, _, _, codec, carry = case
    knobs = {} if codec == "none" else {"codec": codec}
    if not carry:
        return comm.invoke(coll, x, algo=algo, **knobs), None
    op = comm.allreduce_init(x, algo=algo, carry=True, **knobs)
    y, e = op.start(x, carry=err).wait()
    y, e = y.clone(), e.clone()
    op.release()
    return y, e


def _row_sha(torch, y, rows: int):
    """sha256 of each of the ``rows`` rows of a result (dim 0 split into
    ``rows`` equal parts), from its bytes on the host."""
    import hashlib
    b = y.detach().contiguous().reshape(rows, -1).view(torch.uint8).cpu()
    return [hashlib.sha256(r.numpy().tobytes()).hexdigest() for r in b]


def _digest(torch, y):
    """A bitwise digest of each row of a float32 ``(rows, n)`` tensor on the
    card: the int64 sum of its bit patterns times a fixed odd weight per
    column (wrapping, so independent of the sum's order)."""
    w = y.contiguous().view(torch.int32).to(torch.int64)
    k = torch.arange(w.shape[1], dtype=torch.int64, device=w.device)
    return (w * (k * 2654435761 + 1)).sum(1).tolist()


def tp_sync_step(torch, comm, total):
    """One bucketed ``TP_CODEC`` sync step with error feedback of a
    full-width gradient on the ranks ``comm.grid`` holds, each rank's row
    drawn from a generator seeded by its global rank (so any layout of
    ranks over processes draws the same numbers). Returns per bucket and
    held rank the digests of the output and the new error, the step's
    host seconds and, on a grid that holds every rank, the worst bucket
    error over its tolerance against the float64 sum."""
    from repro_torch.core import compress
    from repro_torch.train import manual_step as ms

    grid = comm.grid
    dev = grid.device
    slices = ms.bucket_slices(total, ms.DEFAULT_BUCKET_BYTES // 4)
    grads = torch.empty((grid.rows, total), dtype=torch.float32, device=dev)
    for i in range(grid.rows):
        gen = torch.Generator(device=dev).manual_seed(
            SEED + 1000 + grid.offset + i)
        grads[i].normal_(0.0, 1e-2, generator=gen)
    buckets = [grads[:, s:s + n] for s, n in slices]
    gs = ms.OverlappedGradSync(comm, slices, metric_len=4, algo="pip_mcoll",
                               codec=TP_CODEC, error_budget=TP_BUDGET)
    mvec = torch.arange(grid.offset * 4, (grid.offset + grid.rows) * 4,
                        dtype=torch.float32, device=dev).reshape(-1, 4)
    gs.ensure_ops(0)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    synced, _ = gs.sync(buckets, mvec)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    out = {"buckets": len(slices), "seconds": seconds,
           "out": [_digest(torch, y) for y in synced],
           "err": [_digest(torch, e) for e in gs.errs]}
    if grid.rows == grid.world:
        worst = 0.0
        for b, y in zip(buckets, synced):
            tol = compress.collective_tolerance(TP_CODEC, "allreduce",
                                                grid.world,
                                                float(b.abs().max()))
            got = float((y.double() - b.double().sum(0)).abs().max())
            if not torch.isfinite(y).all() or got > tol:
                raise AssertionError(f"two-process sync: bucket error "
                                     f"{got} > tolerance {tol}")
            worst = max(worst, got / tol)
        out["worst_err_over_tol"] = worst
    gs.release()
    del synced, buckets, grads
    return out


def tp_collectives(torch, np, comm, kcodec, kstaging):
    """Every case of :func:`tp_cases` on ``comm``: per case the sha256 of
    each held result row (and new-error row), the staging and codec
    launches of the call; per lossless float32 pair and size the median
    host ms per call over ``TP_ITERS`` calls (each ended by a synchronize)
    and, on a ``ProcessGrid``, the bytes it sent to other processes per
    call. Staging launches must be more than 0 exactly where
    ``oracles.moves_rows`` says, codec launches exactly for the compressed
    reductions."""
    from repro_torch.core import compress, oracles
    grid = comm.grid
    rows = slice(grid.offset, grid.offset + grid.rows)
    digests, launched, times, cache = {}, {}, {}, {}
    for case in tp_cases():
        coll, algo, nb, dtype, codec, carry = case
        key = f"{coll}/{algo}/{nb}/{dtype}/{codec}" + ("/carry" * carry)
        x, err = _tp_inputs(torch, np, case, grid.device, rows, cache)
        torch.cuda.synchronize()
        kcodec.reset_launches()
        kstaging.reset_launches()
        y, e = _tp_run(comm, case, x, err)
        torch.cuda.synchronize()
        launched[key] = {k: n for k, n in {**kcodec.launches,
                                           **kstaging.launches}.items()
                         if n}
        staged = sum(kstaging.launches.values())
        if (staged > 0) != oracles.moves_rows(coll, algo, codec):
            raise AssertionError(f"{key}: staging launches "
                                 f"{kstaging.launches}")
        # the fused codec kernels serve the compressed reductions; the
        # compressed gathers, exchanges and trees encode and decode plain
        fused = codec != "none" and coll in compress.REDUCING
        if (sum(kcodec.launches.values()) > 0) != fused:
            raise AssertionError(f"{key}: codec launches "
                                 f"{kcodec.launches}")
        digests[key] = _row_sha(torch, y, grid.rows) + (
            _row_sha(torch, e, grid.rows) if e is not None else [])
        if codec == "none" and dtype == "float32":
            sent = getattr(grid, "bytes_sent", 0)
            ms_call = _host_ms(torch, lambda: comm.invoke(coll, x,
                                                          algo=algo),
                               n=TP_ITERS)
            times[key] = {"ms": ms_call,
                          "bytes_sent_per_call": (getattr(
                              grid, "bytes_sent", 0) - sent)
                          / (TP_ITERS + 1)}
        del x, err, y, e
    return digests, launched, times


def two_process_worker(total, table_path, device="cuda"):
    """A phase-8 worker (``distributed.launch.run``): this process's four
    ranks of the ``make_process_grid(device)`` grid run every case of
    :func:`tp_cases`, the full-width sync step and a short calibration.
    Kernel counts are zeroed just before each leg and read just after."""
    import numpy as np
    import torch
    from repro_torch.core import autotune
    from repro_torch.core.comm import Communicator
    from repro_torch.distributed import backend
    from repro_torch.kernels import codec as kcodec
    from repro_torch.kernels import staging as kstaging
    from repro_torch.launch.mesh import make_process_grid

    grid = make_process_grid(device)
    if grid.device.type == "cuda":
        torch.cuda.set_device(grid.device)
    comm = Communicator(grid)
    res = {"rank": grid.rank, "device": str(grid.device),
           "backend": backend.current_backend().name,
           "topo_key": autotune.topo_key(comm.topo), "rows": grid.rows,
           "offset": grid.offset}
    t0 = time.perf_counter()
    res["digests"], res["launched"], res["times"] = tp_collectives(
        torch, np, comm, kcodec, kstaging)
    res["collectives_s"] = time.perf_counter() - t0
    res["collective_launches"] = _sum_launches(res["launched"])
    torch.cuda.empty_cache()
    kcodec.reset_launches()
    kstaging.reset_launches()
    sent = grid.bytes_sent
    res["sync"] = tp_sync_step(torch, comm, total)
    res["sync"]["bytes_sent"] = grid.bytes_sent - sent
    res["sync"]["launches"] = {k: n for k, n in {
        **kcodec.launches, **kstaging.launches}.items() if n}
    torch.cuda.empty_cache()
    ccomm = Communicator(grid, selector=autotune.Selector())
    t0 = time.perf_counter()
    cal = ccomm.calibrate(names=TP_CAL, sizes=TP_SIZES, iters=TP_CAL_ITERS,
                          codecs=(), path=table_path)
    res["calibrate"] = {
        "rows": len(cal), "seconds": time.perf_counter() - t0,
        "table": ccomm.selector.table.to_json(),
        "auto": {f"{c}/{nb}": autotune.encode_plan(*(lambda s: (
            s.algo, s.chunks, s.codec))(ccomm.plan(c, nb)))
            for c in TP_CAL for nb in TP_SIZES}}
    return res


def tp_model_vs_measured(plans):
    """The cost model under the workers' topology (``TP_KEY``'s links:
    ``h100_ipc`` on the node axis) against each
    lossless plan's measured two-process time (the slower worker's): each
    plan's ``model_ms``, and per (collective, size) cell whether the
    model's argmin is the measured one, with the median |(measured -
    model) / model|."""
    from repro_torch.core import autotune
    from repro_torch.core.topology import Topology
    _, node_link, local_link = TP_KEY.split("/")
    topo = Topology(TP_PROCS, TP_RANKS, node_link=node_link,
                    local_link=local_link)
    cells, errs = {}, []
    for p in plans:
        coll, algo, nb = p["plan"].split("/")[:3]
        model = autotune.predicted_seconds(coll, algo, topo, int(nb))
        p["model_ms"] = model * 1e3 if model else None
        if p["model_ms"]:
            got = max(p["two_process_ms"])
            errs.append(abs(got - p["model_ms"]) / p["model_ms"])
            cells.setdefault((coll, nb), []).append(
                (got, p["model_ms"], algo))
    agree = sum(min(c)[2] == min(c, key=lambda r: r[1])[2]
                for c in cells.values())
    return {"link": TP_KEY, "cells": len(cells), "agree_algo": agree,
            "median_abs_rel_err": statistics.median(errs),
            "plans": len(errs)}


def _sum_launches(launched):
    total = {}
    for counts in launched.values():
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    return total


def two_process_phase(torch, dev, cfg, kcodec, kstaging, keep=None):
    """Phase 8: the parent's ``RankGrid(2, 4)`` runs every case and the
    full-width sync step, keeps the digests and frees the card; then two
    workers of four ranks each (``distributed.launch.run``) run the same on
    ``make_process_grid()``, and every held row must be bitwise the
    parent's. Returns the record of the ``{"two_process": ...}`` line;
    ``keep`` (a dict) receives the parent's digests, times and sync step,
    which phase 15 holds its workers to."""
    import numpy as np
    from repro_torch.core.comm import Communicator
    from repro_torch.core.grid import RankGrid
    from repro_torch.core.autotune import TuningTable
    from repro_torch.distributed import launch
    from repro_torch.models.params import param_shapes

    mode = _smi("compute_mode")
    print(f"two-process phase: compute mode {mode}")
    if "exclusive_process" in mode.lower().replace(" ", "_"):
        raise AssertionError(f"the card's compute mode is {mode}: two "
                             f"processes cannot share it")
    total = sum(int(torch.Size(s).numel()) for _, s in param_shapes(cfg))
    comm = Communicator(RankGrid(TP_PROCS, TP_RANKS, dev))
    t0 = time.perf_counter()
    digests, launched, times = tp_collectives(torch, np, comm, kcodec,
                                              kstaging)
    parent_s = time.perf_counter() - t0
    sync = tp_sync_step(torch, comm, total)
    del comm
    gc.collect()
    torch.cuda.empty_cache()
    table_path = ROOT / "build" / TP_TABLE
    table_path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    workers = launch.run(two_process_worker, total, str(table_path),
                         str(dev), processes=TP_PROCS,
                         ranks_per_process=TP_RANKS, timeout=TP_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    world = TP_PROCS * TP_RANKS
    for w in workers:
        rows = slice(w["offset"], w["offset"] + w["rows"])
        if w["topo_key"] != TP_KEY:
            raise AssertionError(f"rank {w['rank']}: key {w['topo_key']}")
        if torch.device(w["device"]).type != dev.type:
            raise AssertionError(f"rank {w['rank']} on {w['device']}")
        for key, want in digests.items():
            got = w["digests"][key]
            # per-row digests: the result's rows, then the new error's
            n = len(want) // world
            mine = [d for i in range(n) for d in want[i * world:(i + 1)
                                                      * world][rows]]
            if got != mine:
                raise AssertionError(f"rank {w['rank']}: {key} not bitwise "
                                     f"the one-process grid's")
            # the same codec launches per call as the one-process grid's
            # (one per call, whatever the rows); staging as moves_rows says
            codecs = [{k: n for k, n in c.items()
                       if k not in kstaging.launches}
                      for c in (launched[key], w["launched"][key])]
            if codecs[0] != codecs[1]:
                raise AssertionError(f"rank {w['rank']}: {key} codec "
                                     f"launches {codecs[1]}, one process "
                                     f"{codecs[0]}")
        for part in ("out", "err"):
            want = [[d[i] for i in range(rows.start, rows.stop)]
                    for d in sync[part]]
            if w["sync"][part] != want:
                raise AssertionError(f"rank {w['rank']}: sync {part} not "
                                     f"bitwise the one-process step's")
        encodes, decode = CODEC_KERNELS[TP_CODEC]
        want = {**{k: 2 * sync["buckets"] for k in encodes},
                decode: sync["buckets"]}
        if w["sync"]["launches"] != want:
            raise AssertionError(f"rank {w['rank']}: sync step launches "
                                 f"{w['sync']['launches']}, expected "
                                 f"{want}")
    table = TuningTable.load(table_path)
    if list(table.entries) != [TP_KEY] or any(
            w["calibrate"]["table"] != table.to_json() for w in workers):
        raise AssertionError(f"merged table: {list(table.entries)}")
    if workers[0]["calibrate"]["auto"] != workers[1]["calibrate"]["auto"]:
        raise AssertionError("auto resolves differently on the two ranks")
    rec = {"card": _smi("name,power.limit"), "processes": TP_PROCS,
           "ranks_per_process": TP_RANKS, "compute_mode": mode, "topo_key": workers[0]["topo_key"],
           "cases": len(digests), "parent_s": parent_s, "spawn_s": spawn_s,
           "plans": [{"plan": key, "one_process_ms": t["ms"],
                      "two_process_ms": [w["times"][key]["ms"]
                                         for w in workers],
                      "bytes_sent_per_call": [
                          w["times"][key]["bytes_sent_per_call"]
                          for w in workers],
                      "launches": [w["launched"][key] for w in workers]}
                     for key, t in times.items()],
           "sync": {"buckets": sync["buckets"],
                    "one_process_s": sync["seconds"],
                    "worst_err_over_tol": sync["worst_err_over_tol"],
                    "two_process_s": [w["sync"]["seconds"] for w in workers],
                    "bytes_sent": [w["sync"]["bytes_sent"]
                                   for w in workers],
                    "launches": [w["sync"]["launches"] for w in workers]},
           "calibrate": {"rows": [w["calibrate"]["rows"] for w in workers],
                         "seconds": [w["calibrate"]["seconds"]
                                     for w in workers],
                         "auto": workers[0]["calibrate"]["auto"],
                         "table": str(table_path.relative_to(ROOT))},
           "worker_collectives_s": [w["collectives_s"] for w in workers],
           "model_vs_measured": None,
           "launches": [w["collective_launches"] for w in workers]}
    rec["model_vs_measured"] = tp_model_vs_measured(rec["plans"])
    if keep is not None:
        keep.update(digests=digests, times=times, sync=sync)
    return rec


# ---------------------------------------------------------------------------
# phase 9: the train step
# ---------------------------------------------------------------------------

#: the train phase: one sequence a rank, AdamW at a constant rate, the
#: legs' step counts, the peak device memory allowed, and the error budget
#: of leg (a) (admits int8_block only)
TRAIN_SEQ, TRAIN_LR = 2048, 1e-4
TRAIN_STEPS_A, TRAIN_STEPS_C = 3, 2
TRAIN_PEAK_LIMIT_BYTES = 70e9
TRAIN_BUDGET = 0.5 / 127
TRAIN_TRACE = "train_trace.json"
#: kernels named in the train profiles' per-launch times
TRAIN_NAMES = ("int8_block_encode", "int8_decode_reduce") + STAGING_KERNELS


def _launches(kmods):
    return {k: n for km in kmods for k, n in km.launches.items()}


def profile_device(torch, fn, names, top: int = 12):
    """:func:`profile_call`'s record for a call of tens of thousands of
    launches (a train step): only the device's activity is recorded and
    read straight from the profiler's own events, without building its
    tables (which take minutes at that size)."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    try:
        prof.start()
    except RuntimeError as e:
        prof, reason = None, repr(e)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if prof is None:
        return {"device_busy_ms": "not measured", "step_ms": wall_ms,
                "reason": reason}
    try:
        prof.stop()
        events = [(e.name(), e.duration_ns() / 1e6)
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
    except (RuntimeError, AttributeError) as e:
        return {"device_busy_ms": "not measured", "step_ms": wall_ms,
                "reason": repr(e)}
    rows = {}
    for name, ms in events:
        tot, n = rows.get(name, (0.0, 0))
        rows[name] = (tot + ms, n + 1)
    busy = sum(ms for ms, _ in rows.values())
    if not busy:
        return {"device_busy_ms": "not measured", "step_ms": wall_ms,
                "reason": "profiler recorded no device time"}
    if busy > wall_ms:
        raise AssertionError(f"profiled call: device busy {busy} ms exceeds "
                             f"its wall time {wall_ms} ms")
    per_launch = {}
    for want in names:
        hits = [v for k, v in rows.items() if want in k]
        n = sum(c for _, c in hits)
        per_launch[want] = (sum(ms for ms, _ in hits) / n if n
                            else "not measured")
    order = sorted(rows.items(), key=lambda kv: -kv[1][0])
    return {"device_busy_ms": busy, "step_ms": wall_ms,
            "idle_share": 1.0 - busy / wall_ms, "per_launch_ms": per_launch,
            "gemm_ms": sum(ms for k, (ms, _) in rows.items()
                           if _is_gemm(k)),
            "launches": sum(n for _, n in rows.values()),
            "kernels": [{"name": k[:90], "ms": ms, "count": n}
                        for k, (ms, n) in order[:top]]}


def _reset(kmods):
    for km in kmods:
        km.reset_launches()


def _sha(torch, tensors) -> str:
    """sha256 of the tensors' bytes, one after another."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def _timed_steps(torch, dev, fn, n):
    """``n`` calls of ``fn``, each timed on the host clock around a device
    synchronize; returns (times in s, results)."""
    times, outs = [], []
    for _ in range(n):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    return times, outs


def _leg_record(times, tokens, profile, launches):
    """A leg's step times (the median of the steps after the first),
    tokens per second, its profiled step and launches."""
    later = times[1:] or times
    med = statistics.median(later)
    prof = {k: profile.get(k) for k in ("device_busy_ms", "step_ms",
                                         "idle_share", "gemm_ms",
                                         "per_launch_ms", "launches",
                                         "kernels", "reason")
            if k in profile}
    return {"step_s": times, "median_step_s": med,
            "tokens_per_s": tokens / med, "profile": prof,
            "launches": {k: n for k, n in launches.items() if n}}


def _sync_alone(torch, dev, kmods, fn):
    """The kernel launches of one call of ``fn`` alone."""
    torch.cuda.synchronize(dev)
    _reset(kmods)
    fn()
    torch.cuda.synchronize(dev)
    return _launches(kmods)


def _m_rel_err(torch, m, want, spans) -> float:
    """AdamW's first moment after one step against another's: the largest,
    over the leaves, of max |m - want| over the leaf's max |want|."""
    worst = 0.0
    for _, s, e, _ in spans:
        scale = float(want[s:e].abs().max())
        d = float((m[s:e] - want[s:e]).abs().max())
        worst = max(worst, d / scale if scale else (0.0 if d == 0.0
                                                    else float("inf")))
    return worst


def _spans_nested(spans, bounds, n_buckets):
    """The traced segmented step's stages as spans on the main track
    inside ``train/step``, each bucket's window on its own track inside
    it; returns the outer span."""
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    (outer,) = by_name["train/step"]
    stages = (["train/fwd", "train/head_bwd"]
              + [f"train/chunk_bwd[{k}]" for k in range(len(bounds))]
              + ["train/embed_bwd", "train/apply"])
    for name in stages:
        (s,) = by_name[name]
        if s.track != "main" or not (outer.start <= s.start
                                     and s.end <= outer.end + 1e-9):
            raise AssertionError(f"{name} not nested in train/step")
    buckets = [s for s in spans if s.track.startswith("bucket:")]
    if sorted(s.track for s in buckets) != sorted(
            f"bucket:{i}" for i in range(n_buckets)):
        raise AssertionError(f"{len(buckets)} bucket windows, expected "
                             f"one on each of {n_buckets} tracks")
    for s in buckets:
        if not (outer.start <= s.start and s.end <= outer.end + 1e-9):
            raise AssertionError(f"{s.track} not nested in train/step")
    return outer


def train_phase(torch, dev, cfg, kmods):
    """The train step at full width (see the module docstring, phase 9).
    Returns the ``{"train": ...}`` record, each kernel counter's launches
    over the train steps of legs (a), (b) and (c), and over leg (d)'s
    ``compress_tree`` call (its own path: no step calls it)."""
    import numpy as np

    from repro_torch.core import compress, oracles, telemetry
    from repro_torch.core.autotune import encode_plan
    from repro_torch.core.comm import Communicator
    from repro_torch.core.grid import RankGrid
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.decoder import DecoderLM, RunFlags
    from repro_torch.models.params import FlatParams
    from repro_torch.optim import adamw
    from repro_torch.train import manual_step as ms
    from repro_torch.train.step import TrainConfig, train_step, value_and_grad

    kcodec, kstaging = kmods[0], kmods[-1]
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    grid = RankGrid(2, 4)
    world = grid.world
    comm = Communicator(grid)
    model = DecoderLM(cfg, torch.Generator(dev).manual_seed(SEED))
    flat = FlatParams.of(model)
    init = [t.detach().clone() for t in flat.tensors]
    data = SyntheticLM(cfg.vocab, TRAIN_SEQ, world, seed=0).batch(0)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).long().to(dev)
             for k, v in data.items()}
    tokens = int(batch["tokens"].numel())
    ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=0,
                             schedule="constant")
    tcfg = TrainConfig(optimizer=ocfg, flags=RunFlags(remat="dots"))

    def restart():
        with torch.no_grad():
            for t, t0 in zip(flat.tensors, init):
                t.copy_(t0)
        return adamw.init(flat, ocfg)

    rec = {"model": cfg.name, "n_params": flat.n, "ranks": world,
           "tokens_per_step": tokens, "remat": "dots", "lr": TRAIN_LR,
           "card": _smi("name,power.limit")}
    path_launches = {}

    def count(leg, launches, path=path_launches):
        rec.setdefault("launches", {})[leg] = {k: n for k, n in
                                               launches.items() if n}
        for k, n in launches.items():
            path[k] = path.get(k, 0) + n

    legs_s = {"setup": time.perf_counter() - t_phase}
    # (a) fused int8 error feedback, 3 steps on the step-0 batch
    slices = ms.bucket_slices(flat.n, ms.DEFAULT_BUCKET_BYTES // 4)
    err = ms.init_error_state(flat.n, comm, TRAIN_BUDGET)
    bucket_sync = ms._make_grad_sync(comm, "pip_mcoll", None, None,
                                     TRAIN_BUDGET)
    metric_sync = ms._make_grad_sync(comm, "pip_mcoll", None, None, 0.0)
    probe = torch.zeros((world, slices[0][1]), device=dev)
    alone_bucket = _sync_alone(torch, dev, kmods, lambda: bucket_sync(
        probe, torch.zeros_like(probe)))
    alone_metric = _sync_alone(torch, dev, kmods, lambda: metric_sync(
        torch.zeros((world, 1), device=dev), None))
    del probe
    plan = ms._resolve_plan(comm.topo, slices[0][1] * 4, torch.float32,
                            "pip_mcoll", None, None, TRAIN_BUDGET)
    mplan = ms._resolve_plan(comm.topo, 4, torch.float32, "pip_mcoll", None,
                             None, 0.0)
    for what, alone, (algo, kw) in (("bucket", alone_bucket, plan),
                                    ("metric", alone_metric, mplan)):
        staged = sum(alone.get(k, 0) for k in STAGING_NAMES)
        if bool(staged) != oracles.moves_rows("allreduce", algo,
                                              kw.get("codec", "none")):
            raise AssertionError(f"train {what} sync {algo} {kw}: {staged} "
                                 f"staging launches alone")
    opt = restart()
    step_a = ms.make_manual_train_step(cfg, tcfg, grid, algo="pip_mcoll",
                                       error_budget=TRAIN_BUDGET)
    torch.cuda.synchronize(dev)
    _reset(kmods)
    times, outs = _timed_steps(torch, dev, lambda: step_a(
        model, opt, err, batch)[1], TRAIN_STEPS_A)
    launches = _launches(kmods)
    losses = [float(m["loss"]) for m in outs]
    if not all(np.isfinite(losses)) or \
            not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"train leg (a): losses {losses} do not fall "
                             f"(step times {times} s)")
    metric_calls = 7  # the loss, then loss, aux, ce, tokens, grad norm, lr
    want = {k: TRAIN_STEPS_A * (len(slices) * alone_bucket.get(k, 0)
                                + metric_calls * alone_metric.get(k, 0))
            for k in launches}
    if launches["int8_block_encode"] != 2 * len(slices) * TRAIN_STEPS_A or \
            launches["int8_decode_reduce"] != len(slices) * TRAIN_STEPS_A:
        raise AssertionError(f"train leg (a): codec launches {launches}")
    _check_launches("train leg (a)", launches, want)
    count("a", launches)
    _reset(kmods)
    prof = profile_device(torch, lambda: step_a(model, opt, err, batch),
                          TRAIN_NAMES)
    count("a_profiled", _launches(kmods))
    rec["a"] = dict(_leg_record(times, tokens, prof, launches),
                    losses=losses, plan=encode_plan(
                        plan[0], plan[1].get("chunks", 1),
                        plan[1].get("codec", "none")),
                    buckets=len(slices),
                    per_step={k: n // TRAIN_STEPS_A
                              for k, n in launches.items() if n})

    legs_s["a"] = time.perf_counter() - t_phase - sum(legs_s.values())
    # (d) compress_tree on rank 0's gradient (after (a)) with a carried
    # error: one feedback encode per leaf, bitwise its plain version
    del step_a, err
    gc.collect()
    torch.cuda.empty_cache()
    shard = {k: v[:1] for k, v in batch.items()}
    _, _, grads = value_and_grad(model, flat, shard, tcfg)
    g0 = flat.gather(grads)
    del grads
    tree = {p: g0[s:e] for p, s, e, _ in flat.spans}
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    e0 = {p: torch.randn(e - s, generator=gen, device=dev) * 1e-6
          for p, s, e, _ in flat.spans}
    torch.cuda.synchronize(dev)
    _reset(kmods)
    comp, new_err = compress.compress_tree(tree, e0)
    torch.cuda.synchronize(dev)
    d_launches = _launches(kmods)
    with compress.reference_paths():
        plain, plain_err = compress.compress_tree(tree, e0)
    same = all(same_bits(torch, a, b) for a, b in zip(
        comp[0] + comp[1] + [new_err[p] for p in tree],
        plain[0] + plain[1] + [plain_err[p] for p in tree]))
    if d_launches.get("int8_block_encode_feedback") != len(tree) or \
            not same:
        raise AssertionError(f"train leg (d): {d_launches}, bitwise {same}")
    dec = compress.decompress_tree(comp, tree)
    dec_err = max(float((dec[p] - (tree[p] + e0[p])).abs().max())
                  / max(float((tree[p] + e0[p]).abs().max()), 1e-30)
                  for p in tree)
    if dec_err > compress.meta("int8_block").error_bound:
        raise AssertionError(f"train leg (d): decoded within {dec_err} of "
                             f"the leaf max, bound "
                             f"{compress.meta('int8_block').error_bound}")
    tree_launches = {}
    count("d", d_launches, tree_launches)
    rec["d"] = {"leaves": len(tree), "bitwise": same,
                "decode_rel_err": dec_err,
                "wire_bytes": compress.wire_bytes(comp)}
    del g0, tree, e0, comp, new_err, plain, plain_err, dec

    legs_s["d"] = time.perf_counter() - t_phase - sum(legs_s.values())
    # (b) the lossless fused step (auto) against train_step over 8
    # microbatches of the global batch, two steps from the same start: the
    # losses, the weights and, leaf by leaf, AdamW's m after the first
    # step ((1 - b1) times the mean gradient: a weight moves about lr,
    # only m tells a gradient routed to the wrong leaf)
    opt = restart()
    _reset(kmods)
    tcfg_ts = TrainConfig(optimizer=ocfg, microbatches=world,
                          flags=tcfg.flags)
    run_ts = lambda: train_step(model, opt, batch, tcfg_ts, flat)
    times_ts, outs_ts = _timed_steps(torch, dev, run_ts, 1)
    want_params = [t.detach().clone() for t in flat.tensors]
    want_m = opt["m"].clone()
    outs_ts += _timed_steps(torch, dev, run_ts, 1)[1]
    count("b_train_step", _launches(kmods))
    loss_ts = [float(m["loss"]) for m in outs_ts]

    def against_train_step(leg, losses, m, diff):
        m_err = _m_rel_err(torch, m, want_m, flat.spans)
        if any(abs(a - b) > 1e-5 * abs(b) for a, b in zip(losses, loss_ts)) \
                or diff >= 5e-2 or m_err > 1e-4:
            raise AssertionError(f"train leg ({leg}): losses {losses} vs "
                                 f"{loss_ts}, weights {diff}, m {m_err}")
        return m_err

    opt = restart()
    step_b = ms.make_manual_train_step(cfg, tcfg, grid)
    _reset(kmods)
    run_b = lambda: step_b(model, opt, (), batch)[1]
    times, outs = _timed_steps(torch, dev, run_b, 1)
    diff_b = max(max_diff(torch, t.detach(), w)
                 for t, w in zip(flat.tensors, want_params))
    m_b = opt["m"].clone()
    more, outs2 = _timed_steps(torch, dev, run_b, 1)
    b_launches = _launches(kmods)
    loss_b = [float(outs[0]["loss"]), float(outs2[0]["loss"])]
    m_err_b = against_train_step("b", loss_b, m_b, diff_b)
    del m_b
    count("b", b_launches)
    _reset(kmods)
    prof = profile_device(torch, run_b, TRAIN_NAMES)
    count("b_profiled", _launches(kmods))
    rec["b"] = dict(_leg_record(times + more, tokens, prof, b_launches),
                    losses=loss_b, train_step_losses=loss_ts,
                    train_step_s=times_ts[0], max_weight_diff=diff_b,
                    m_rel_err=m_err_b)
    del step_b
    gc.collect()
    torch.cuda.empty_cache()

    legs_s["b"] = time.perf_counter() - t_phase - sum(legs_s.values())
    # (c) the overlapped segmented step and its barrier twin, 2 steps
    # each, bitwise; the monolithic decomposition's first step within the
    # bars of (b); one profiled and one traced step
    twins = {}
    for overlap in (True, False):
        opt = restart()
        step_c = ms.make_overlapped_train_step(cfg, tcfg, grid,
                                               overlap=overlap,
                                               segmented=True)
        _reset(kmods)
        times, outs = _timed_steps(torch, dev, lambda: step_c(
            model, opt, batch), TRAIN_STEPS_C)
        c_launches = _launches(kmods)
        count(f"c_overlap{int(overlap)}", c_launches)
        twins[overlap] = {
            "step_s": times, "losses": [float(m["loss"]) for m in outs],
            "sha256": {"params": _sha(torch, flat.tensors),
                       "m": _sha(torch, [opt["m"]]),
                       "v": _sha(torch, [opt["v"]])},
            "launches": {k: n for k, n in c_launches.items() if n}}
        if overlap:
            mode, bounds = step_c.mode, list(step_c.bounds)
            n_buckets = len(step_c.grad_sync.plans())
            _reset(kmods)
            prof = profile_device(torch, lambda: step_c(model, opt, batch),
                                  TRAIN_NAMES)
            count("c_profiled", _launches(kmods))
            telemetry.enable()
            try:
                telemetry.reset()
                step_c(model, opt, batch)
                torch.cuda.synchronize(dev)
                spans = telemetry.spans()
                out_path = ROOT / "build" / TRAIN_TRACE
                out_path.parent.mkdir(exist_ok=True)
                telemetry.export_chrome_trace(out_path)
            finally:
                telemetry.disable()
            outer = _spans_nested(spans, bounds, n_buckets)
            traced = {"spans": len(spans),
                      "step_s": outer.end - outer.start,
                      "trace": str(out_path.relative_to(ROOT))}
        step_c.release()
        del step_c
        gc.collect()
        torch.cuda.empty_cache()
    if twins[True]["sha256"] != twins[False]["sha256"] or \
            twins[True]["losses"] != twins[False]["losses"]:
        raise AssertionError(f"train leg (c): the twins differ: {twins}")
    # segmented and monolithic against train_step (leg (b)'s bars: both
    # losses, the weights and m after the first step) and each other
    firsts = {}
    for seg in (True, False):
        opt = restart()
        step_c = ms.make_overlapped_train_step(cfg, tcfg, grid,
                                               segmented=seg)
        losses = [float(step_c(model, opt, batch)["loss"])]
        params = [t.detach().clone() for t in flat.tensors]
        diff = max(max_diff(torch, t, w)
                   for t, w in zip(params, want_params))
        m_c = opt["m"].clone()
        losses.append(float(step_c(model, opt, batch)["loss"]))
        m_err = against_train_step(f"c, segmented={seg}", losses, m_c, diff)
        firsts[seg] = (losses, params, {"losses": losses,
                                        "max_weight_diff": diff,
                                        "m_rel_err": m_err})
        step_c.release()
        del step_c, m_c
    diff_c = max(max_diff(torch, a, b)
                 for a, b in zip(firsts[True][1], firsts[False][1]))
    if abs(firsts[True][0][0] - firsts[False][0][0]) > 1e-5 * abs(
            firsts[False][0][0]) or diff_c >= 5e-2:
        raise AssertionError(f"train leg (c): segmented {firsts[True][0]} "
                             f"vs monolithic {firsts[False][0]}, weights "
                             f"{diff_c}")
    rec["c"] = dict(_leg_record(twins[True]["step_s"], tokens, prof,
                                twins[True]["launches"]),
                    mode=mode, segments=len(bounds), buckets=n_buckets,
                    twins=twins, barrier_median_step_s=statistics.median(
                        twins[False]["step_s"][1:]
                        or twins[False]["step_s"]),
                    segmented_vs_monolithic={
                        "loss": [firsts[True][0][0], firsts[False][0][0]],
                        "max_weight_diff": diff_c},
                    vs_train_step={"segmented": firsts[True][2],
                                   "monolithic": firsts[False][2]},
                    traced=traced)
    del firsts, init, want_params, want_m
    peak = torch.cuda.max_memory_allocated(dev)
    if peak > TRAIN_PEAK_LIMIT_BYTES:
        raise AssertionError(f"train phase: peak {peak} B over "
                             f"{TRAIN_PEAK_LIMIT_BYTES} B")
    rec["peak_mem_bytes"] = peak
    rec["path_launches"] = {k: n for k, n in path_launches.items() if n}
    rec["compress_tree_launches"] = {k: n for k, n in tree_launches.items()
                                     if n}
    legs_s["c"] = time.perf_counter() - t_phase - sum(legs_s.values())
    rec["legs_s"] = legs_s
    rec["phase_s"] = time.perf_counter() - t_phase
    del model, flat, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec, path_launches, tree_launches


# ---------------------------------------------------------------------------
# phase 10: the MoE family
# ---------------------------------------------------------------------------


def flash_group_leg(torch, kattn, ref, dev):
    """``flash_decode`` past 8 query heads a kv group: qwen3-moe's serving
    shape (G 16) and G 9, 11, 12 and 16 at reduced sizes, bf16 and fp32, for
    (B,) lengths (full, 1, mixed) and scalar lengths (1, S // 3, S, 0),
    within ``FLASH_TOL * (1 + |plain|)`` of the plain version; then the
    split grid's edges at qwen3-moe's shape, B 8 and B 1 (every boundary
    of the kernel's own split count, which counts the head groups, +-1,
    and lengths 0 and -3); the combine tickets back at zero. Then the
    kernel's time (events and CUPTI), the plain version's and one SDPA
    call's at qwen3-moe's shape, every row at SERVE_LEN, with the bound."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    worst, checked = 0.0, 0
    for B, S, H, KV, hd in FLASH_GROUPS:
        mixed = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                              dtype=torch.int32)
        mixed[0], mixed[1] = S, 1
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _flash_inputs(torch, B, S, H, KV, hd, dtype, gen, dev)
            for lengths in (torch.full((B,), S, dtype=torch.int32,
                                       device=dev),
                            torch.ones((B,), dtype=torch.int32, device=dev),
                            mixed, 1, S // 3, S, 0):
                worst = max(worst, _check_flash(
                    torch, kattn, ref, q, k, v, lengths,
                    f"B={B} S={S} H={H} KV={KV} hd={hd} {dtype}"))
                checked += 1
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    _, S, H, KV, hd = FLASH_GROUPS[0]
    splits = {}
    for B in (SERVE_BATCH, 1):
        q, k, v = _flash_inputs(torch, B, S, H, KV, hd, torch.bfloat16, gen,
                                dev)
        n = kattn.split_count(B, KV, S, hd, 2, n_sm, H // KV)
        span = -(-S // n)
        splits[f"B={B} H={H} KV={KV} hd={hd}"] = {
            "n_split": n, "span": span,
            "head_groups": kattn.head_groups(H // KV)}
        edges = [e + d for e in range(span, S, span) for d in (-1, 0, 1)]
        for lengths in (*edges, 0, -3):
            worst = max(worst, _check_flash(
                torch, kattn, ref, q, k, v, lengths,
                f"B={B} S={S} H={H} KV={KV} hd={hd} {n} splits"))
            checked += 1
    if any(bool(t.any()) for t in kattn._tickets.values()):
        raise AssertionError("flash_decode left a combine ticket non-zero")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    timed = _flash_timed(torch, kattn, ref, dev, gen, flush, H, KV, hd)
    q, k, v = _flash_inputs(torch, SERVE_BATCH, S, H, KV, hd,
                            torch.bfloat16, gen, dev)
    full = torch.full((SERVE_BATCH,), S, dtype=torch.int32, device=dev)
    timed["kernel_cupti_ms"] = cupti_ms(
        torch, lambda: kattn.flash_decode(q, k, v, full), flush,
        "flash_decode")
    timed["n_split"] = kattn.split_count(SERVE_BATCH, KV, S, hd, 2, n_sm,
                                         H // KV)
    return {"cases_checked": checked, "max_abs_err": worst,
            "tolerance": f"{FLASH_TOL} * (1 + |plain|)", "splits": splits,
            "shapes": [list(s) for s in FLASH_GROUPS],
            "qwen3_moe_shape": timed}


def _forced(autotune, algo, chunks, codec="none"):
    """A stand-in for ``Communicator.plan`` resolving every request to
    ``(algo, chunks)``, lossless, and one under an error budget to
    ``(algo, chunks, codec)``."""
    def plan(self, collective, nbytes, dtype="float32", error_budget=0.0):
        return autotune.Selection(collective, algo, 0.0, "forced", "",
                                  chunks=chunks,
                                  codec=codec if error_budget > 0 else "none")
    return plan


def _with_plan(fn, plan):
    """``fn()`` with ``Communicator.plan`` replaced by ``plan`` (None:
    the selector's own) for the call."""
    from repro_torch.core import comm as tcomm

    def call():
        if plan is None:
            return fn()
        kept = tcomm.Communicator.plan
        tcomm.Communicator.plan = plan
        try:
            return fn()
        finally:
            tcomm.Communicator.plan = kept
    return call


def _combine_input_max(torch, fn):
    """``fn()`` (one expert-parallel call) with the largest |value| of the
    combine all-to-all's operand (the expert outputs, the call's last
    all-to-all), which a codec's error bound is relative to."""
    from repro_torch.core import mcoll

    algos, seen = dict(mcoll.ALLTOALL), []

    def recording(f):
        def call(x, *args, **kw):
            seen.append(x)
            return f(x, *args, **kw)
        return call

    mcoll.ALLTOALL.update({k: recording(f) for k, f in algos.items()})
    try:
        out = fn()
    finally:
        mcoll.ALLTOALL.update(algos)
    return out, float(seen[-1].float().abs().max())


def _host_timed(torch, fn, n: int = MOE_ITERS):
    """``fn()``'s last result and its median host-clock seconds over ``n``
    calls after a first one (:func:`_timed_steps`)."""
    times, outs = _timed_steps(torch, None, fn, n + 1)
    return outs[-1], statistics.median(times[1:])


def _profile_ep(torch, fn):
    """:func:`profile_call` of one expert-parallel call with its expert
    products inside ``EXPERT_RANGE`` and its all-to-alls inside
    ``A2A_RANGE``: their device time and their shares of the busy time."""
    from repro_torch.core import mcoll
    from repro_torch.layers import moe as tmoe

    experts, algos = tmoe.MoE._experts, dict(mcoll.ALLTOALL)

    def ranged(label, f):
        def call(*args, **kw):
            with torch.profiler.record_function(label):
                return f(*args, **kw)
        return call

    tmoe.MoE._experts = ranged(EXPERT_RANGE, experts)
    mcoll.ALLTOALL.update({k: ranged(A2A_RANGE, f) for k, f in algos.items()})
    try:
        prof = profile_call(torch, fn, STAGING_KERNELS,
                            ranges=(EXPERT_RANGE, A2A_RANGE))
    finally:
        tmoe.MoE._experts = experts
        mcoll.ALLTOALL.update(algos)
    busy = prof["device_busy_ms"]
    if isinstance(busy, float) and all(
            isinstance(prof["ranges"][r]["ms"], float)
            for r in (EXPERT_RANGE, A2A_RANGE)):
        expert_ms = prof["ranges"][EXPERT_RANGE]["ms"]
        a2a_ms = prof["ranges"][A2A_RANGE]["ms"]
        prof["split_ms"] = {"alltoalls": a2a_ms, "expert_products":
                            prof["ranges"][EXPERT_RANGE]["gemm_ms"],
                            "experts_all": expert_ms,
                            "rest": busy - expert_ms - a2a_ms}
        prof["shares"] = {k: v / busy for k, v in prof["split_ms"].items()}
    return prof


def moe_layer_leg(torch, dev, cfg, kmods, plans):
    """One MoE layer of ``cfg`` at full width (bf16 experts from a seeded
    generator) expert parallel on ``RankGrid(2, 4)``, the experts over the
    local axis and the batch over the nodes, on seeded bf16 tokens of
    ``MOE_TOKENS``. For each capacity (``tp``: nothing can drop; the
    config's default) every plan of ``plans`` (``(name, algo, chunks)``,
    forced through ``Communicator.plan``; algo None: ``comm.plan``'s own
    resolution) runs ``MOE_ITERS + 1`` times with every kernel count
    zeroed before and read after: no kernel launches (the all-to-alls and
    the all-gather move no rows through the staging primitives:
    ``oracles.moves_rows``; the compressed combine uses the codecs' plain
    encode and decode), the lossless plans' outputs equal bitwise, no
    routing dropped at capacity tp, where the output must lie within the
    reference check's ``MOE_TOL`` of the local path's. Under
    ``error_budget=MOE_BUDGET`` at the default capacity the combine runs
    the plan the selector resolves (its codec recorded) and each of
    ``MOE_CODEC_PLANS``, each output within ``MOE_TOL`` plus the codec's
    stated bound times the largest expert output (the combine's operand)
    of the lossless one (and whether it also meets the reference check's
    ``MOE_TOL + MOE_BUDGET * max|y|``). Records each plan's median host
    time per call, the drop counts, one profiled call's split into
    all-to-alls and expert products, the peak memory."""
    from repro_torch.core import autotune, compress, oracles
    from repro_torch.core.comm import communicator
    from repro_torch.core.grid import RankGrid
    from repro_torch.layers import moe as tmoe
    from repro_torch.sharding.rules import Rules

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    layer = tmoe.MoE(cfg, torch.Generator("cuda").manual_seed(SEED + 11))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S = MOE_TOKENS
    x = torch.randn((B, S, cfg.d_model), device=dev,
                    generator=torch.Generator("cuda").manual_seed(SEED + 12)
                    ).to(torch.bfloat16)
    grid, rules = RankGrid(2, 4), Rules(batch=("node",), tp="local")
    tp, bshard = grid.n_local, grid.n_nodes
    comm = communicator(grid).split(axes="local")
    moe0 = cfg.moe
    record = {"model": cfg.name, "d_model": cfg.d_model,
              "experts": moe0.n_experts, "top_k": moe0.top_k,
              "d_ff_expert": moe0.d_ff_expert,
              "expert_params": sum(p.numel() for n, p in
                                   layer.named_parameters() if n != "router"),
              "tokens": [B, S], "grid": [2, 4], "batch_axes": ["node"],
              "tp_axis": "local", "experts_per_rank": moe0.n_experts // tp,
              "init_s": init_s, "capacities": {}}
    staged = dict.fromkeys(STAGING_NAMES, 0)

    def run(name, fn):
        for km in kmods:
            km.reset_launches()
        out, secs = _host_timed(torch, fn)
        launches = {k: n for km in kmods for k, n in km.launches.items()}
        for k in STAGING_NAMES:
            staged[k] += launches.get(k, 0)
        _check_launches(f"{cfg.name} expert-parallel MoE, {name}", launches,
                        {})
        return out, secs

    for cap, factor in (("tp", float(tp)), ("default", moe0.capacity_factor)):
        ccfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            moe0, capacity_factor=factor))
        layer.cfg = ccfg
        capacity = tmoe.ep_capacity(B // bshard * S, tp, ccfg.moe)
        nbytes = tp * capacity * cfg.d_model * 2
        rec = {"capacity_factor": factor, "capacity": capacity,
               "dispatch_bytes_all_ranks": grid.world * nbytes,
               "plans": {}}
        ys = {}
        for name, algo, chunks in plans:
            if algo is None:
                sel = comm.plan("alltoall", nbytes, dtype="bfloat16")
                algo_r, chunks_r = sel.algo, sel.chunks
            else:
                algo_r, chunks_r = algo, chunks
            fn = _with_plan(lambda: layer(x, rules=rules, grid=grid),
                            None if algo is None
                            else _forced(autotune, algo, chunks))
            (y, aux), secs = run(name, fn)
            if oracles.moves_rows("alltoall", algo_r):
                raise AssertionError(f"{algo_r}: an all-to-all that moves "
                                     f"rows")
            dropped = int((~layer.ep_routing["kept"]).sum())
            if not bool(torch.isfinite(y).all()) or y.shape != x.shape:
                raise AssertionError(f"{cfg.name} {name}: y {tuple(y.shape)}"
                                     f" or not finite")
            ys[name] = y
            rec["plans"][name] = {"algo": algo_r, "chunks": chunks_r,
                                  "host_ms": secs * 1e3, "dropped": dropped,
                                  "aux": float(aux)}
        names = list(ys)
        for name in names[1:]:
            if not torch.equal(ys[name], ys[names[0]]):
                raise AssertionError(f"{cfg.name} capacity {cap}: plan "
                                     f"{name} differs from {names[0]}")
        drops = {p["dropped"] for p in rec["plans"].values()}
        if len(drops) != 1:
            raise AssertionError(f"drop counts differ across plans: {drops}")
        rec["dropped"] = drops.pop()
        rec["routings"] = grid.world * -(-(B // bshard * S) // tp) \
            * moe0.top_k
        rec["lossless_bitwise"] = names
        y0 = ys[names[0]]
        if cap == "tp":
            if rec["dropped"]:
                raise AssertionError(f"{rec['dropped']} routings dropped at "
                                     f"capacity tp")
            (y_local, _), local_s = _host_timed(torch, lambda: layer(x), 1)
            err = (y0.float() - y_local.float()).abs()
            if not bool((err <= MOE_TOL + MOE_TOL
                         * y_local.float().abs()).all()):
                raise AssertionError(f"{cfg.name}: expert-parallel y "
                                     f"{float(err.max())} from the local "
                                     f"path's, outside {MOE_TOL}")
            rec["local_path"] = {"host_ms": local_s * 1e3,
                                 "max_abs_err": float(err.max()),
                                 "tolerance": f"{MOE_TOL} + {MOE_TOL} * "
                                              f"|local|"}
            del y_local, err
        else:
            # the combine under an error budget: the selector's own plan,
            # then each forced codec; within the codec's stated bound of
            # the largest expert output (the combine's operand) beyond the
            # reference check's MOE_TOL, and, the reference's own bar,
            # MOE_TOL + MOE_BUDGET * max|y|
            scale = float(y0.float().abs().max())
            rec["compressed_combine"] = {}
            for algo, chunks, codec in ((None, None, None),) \
                    + MOE_CODEC_PLANS:
                plan = None if algo is None else _forced(autotune, algo,
                                                         chunks, codec)
                if algo is None:
                    sel = comm.plan("alltoall", nbytes, dtype="bfloat16",
                                    error_budget=MOE_BUDGET)
                    algo, chunks, codec = sel.algo, sel.chunks, sel.codec
                (_, out_max) = _combine_input_max(torch, _with_plan(
                    lambda: layer(x, rules=rules, grid=grid), plan))
                (y_c, _), secs = run(f"combine {codec}", _with_plan(
                    lambda: layer(x, rules=rules, grid=grid,
                                  error_budget=MOE_BUDGET), plan))
                err = float((y_c.float() - y0.float()).abs().max())
                bound = compress.codec(codec).meta.error_bound
                if err > MOE_TOL + bound * out_max:
                    raise AssertionError(
                        f"{cfg.name}: combine {algo}#c{chunks}@{codec} "
                        f"{err} from the lossless y, over {MOE_TOL} + "
                        f"{bound} * {out_max}")
                key = "auto" if plan is None else f"{algo}#c{chunks}@{codec}"
                rec["compressed_combine"][key] = {
                    "error_budget": MOE_BUDGET, "algo": algo,
                    "chunks": chunks, "codec": codec, "host_ms": secs * 1e3,
                    "max_abs_err": err, "max_abs_y": scale,
                    "max_abs_expert_output": out_max,
                    "tolerance": f"{MOE_TOL} + {bound} * "
                                 f"max|expert output|",
                    "within_reference_bar": err <= MOE_TOL
                    + MOE_BUDGET * scale}
                del y_c
            layer(x, rules=rules, grid=grid)  # warm the profiled plan
            rec["profile"] = _profile_ep(
                torch, lambda: layer(x, rules=rules, grid=grid))
        record["capacities"][cap] = rec
        del ys, y0
    record["staging_launches"] = staged
    record["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    del layer
    return record


def _moe_recorder(cls, calls):
    """A stand-in for ``cls.forward`` (the MoE layer's) appending ``(layer,
    x, y, ids)`` of every call to ``calls`` (``ids``: the expert-parallel
    call's routing, ``(world, t, k)``; None for a local call)."""
    forward = cls.forward

    def recording(self, x, rules=None, grid=None, error_budget=0.0):
        y, aux = forward(self, x, rules, grid, error_budget)
        ep = grid is not None
        calls.append((self, x, y, self.ep_routing["ids"] if ep else None))
        return y, aux
    return forward, recording


def moe_decoder_leg(torch, dev, model, cfg):
    """``model`` (``cfg`` at full width) through ``DecoderLM.forward(tokens,
    rules=..., grid=RankGrid(2, 4))`` at capacity tp on seeded tokens of
    ``MOE_TOKENS`` (one batch shard a node, the experts over the local
    axis: rank ``(n, l)`` routes tokens ``n * 2048 + l * 512 ..``, so the
    ranks' routings in flat order are the tokens' in order), against the
    local path. No routing dropped. Each MoE layer, teacher-forced: the
    expert-parallel layer on the local forward's own input routes every
    token as the local layer does and lies within the reference check's
    ``MOE_TOL`` of its output. The whole forward: the logits of every
    sequence with no routing difference from the local forward in any
    layer, up to its last token, within ``TEACHER_TOL`` times the largest
    logit (in bf16 the two paths' expert products round alike only up to
    cuBLAS's choice of kernel by row count, and a token whose top-k sits
    on a near tie may then route differently in a later layer, which
    moves it and, through attention, the tokens after it); the
    differences counted. Records both forwards' host times."""
    from repro_torch.core.grid import RankGrid
    from repro_torch.layers import moe as tmoe
    from repro_torch.sharding.rules import Rules

    grid, rules = RankGrid(2, 4), Rules(batch=("node",), tp="local")
    B, S = MOE_TOKENS
    k = cfg.moe.top_k
    tokens = torch.randint(0, cfg.vocab, MOE_TOKENS, device=dev,
                           generator=torch.Generator("cuda").manual_seed(
                               SEED + 13))
    ep_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(grid.n_local)))
    for blk in model.blocks:
        blk.moe.cfg = ep_cfg
    calls, cls = [], type(model.blocks[0].moe)
    forward, recording = _moe_recorder(cls, calls)
    try:
        with torch.inference_mode():
            _, ep_s = _host_timed(
                torch, lambda: model(tokens, rules=rules, grid=grid), 2)
            _, local_s = _host_timed(torch, lambda: model(tokens), 2)
            cls.forward = recording
            try:
                logits, aux, _ = model(tokens, rules=rules, grid=grid)
                ep_calls, calls[:] = list(calls), []
                local, aux_local, _ = model(tokens)
                local_calls = list(calls)
            finally:
                cls.forward = forward
            dropped = sum(int((~blk.moe.ep_routing["kept"]).sum())
                          for blk in model.blocks)
            layers, moved = [], torch.zeros(B, S, dtype=torch.bool,
                                            device=dev)
            for (layer, x_ep, _, ids_ep), (_, x_loc, y_loc, _) in zip(
                    ep_calls, local_calls):
                ids_loc = tmoe._route(layer.router, x_loc.reshape(-1,
                                      cfg.d_model), k)[1]
                y_tf, _ = layer(x_loc, rules=rules, grid=grid)
                same = torch.equal(layer.ep_routing["ids"].reshape(-1, k),
                                   ids_loc)
                err = (y_tf.float() - y_loc.float()).abs()
                if not same or not bool((err <= MOE_TOL + MOE_TOL
                                         * y_loc.float().abs()).all()):
                    raise AssertionError(
                        f"teacher-forced expert-parallel layer: routing "
                        f"equal {same}, max error {float(err.max())} over "
                        f"{MOE_TOL} + {MOE_TOL} * |local|")
                differ = (ids_ep.reshape(-1, k).sort(-1).values
                          != ids_loc.sort(-1).values).any(-1).reshape(B, S)
                moved |= differ
                layers.append({"teacher_forced_max_abs_err":
                               float(err.max()),
                               "tokens_routed_differently":
                               int(differ.sum())})
                del y_tf, err
    finally:
        for blk in model.blocks:
            blk.moe.cfg = cfg
    if dropped:
        raise AssertionError(f"{dropped} routings dropped at capacity tp")
    if not bool(torch.isfinite(logits).all()) or logits.shape != local.shape:
        raise AssertionError(f"expert-parallel logits {tuple(logits.shape)} "
                             f"or not finite")
    top = float(local.float().abs().max())
    row_err = (logits.float() - local.float()).abs().amax(-1)  # (B, S)
    after = moved.cummax(-1).values  # a moved token and those after it
    clean = ~after
    err_clean = float(row_err[clean].max()) if bool(clean.any()) else 0.0
    if not bool(clean.any()) or err_clean > TEACHER_TOL * top:
        raise AssertionError(f"expert-parallel logits {err_clean} from the "
                             f"local path's where no routing moved, over "
                             f"{TEACHER_TOL} * {top} (or no such token)")
    return {"tokens": list(MOE_TOKENS), "capacity_factor": ep_cfg.moe
            .capacity_factor, "dropped": dropped, "layers": layers,
            "tokens_with_a_moved_routing": int(moved.sum()),
            "tokens_held": int(clean.sum()),
            "max_abs_err_held": err_clean,
            "max_abs_err_all": float(row_err.max()),
            "tokens_over_tolerance": int((row_err > TEACHER_TOL
                                          * top).sum()),
            "max_abs_logit": top, "tolerance": f"{TEACHER_TOL} * max|logit|",
            "aux": float(aux), "aux_local": float(aux_local),
            "ep_forward_s": ep_s, "local_forward_s": local_s}


def moe_serve_leg(torch, dev, cfg, kattn, ref, kmods, decoder=False,
                  vl=False):
    """``cfg`` (a decoder model, an MoE one among them, at most cut in
    depth, every width the published one) served as phase 4 serves
    smollm, with the flash-decode kernel on every tick and the local MoE
    (the reference's ``Engine`` passes no mesh to the model): the tokens
    equal a sync-free engine's, flash launches ticks x layers, the tick
    sync's staging launches; three teacher-forced ticks hold every
    layer's flash-decode call to the plain version and the logits to the
    plain-version path's; one profiled tick with the expert products'
    share. ``decoder``: then :func:`moe_decoder_leg` on the same weights;
    ``vl``: then :func:`vl_leg`."""
    import numpy as np
    from repro_torch.core.grid import RankGrid
    from repro_torch.models.decoder import RunFlags

    flags = RunFlags(use_flash_decode=True)
    model, engine, requests, record = serve_main(torch, dev, cfg, flags,
                                                 kmods)
    m, launches = record["metrics"], record["launches"]
    _check_launches(f"{cfg.name} serving", launches, _with_sync(
        record, {"flash_decode": m["ticks"] * cfg.n_layers}))
    eng = engine(RankGrid(2, 4))
    with torch.inference_mode():
        for slot, req in enumerate(requests()[:SERVE_BATCH]):
            eng._admit(req, slot)
        errs = []
        worst, top = teacher_forced(
            torch, eng, model,
            [("kernel", flags,
              {(kattn, "flash_decode"): _flash_held(torch, kattn, ref,
                                                    errs)}),
             ("plain-version", flags,
              {(kattn, "flash_decode"): ref.flash_decode})], TEACHER_TICKS)
        _check_held("flash_decode", errs, TEACHER_TICKS * cfg.n_layers)
        worst = worst["plain-version"]
        if worst > TEACHER_TOL * top:
            raise AssertionError(f"teacher-forced logits: kernel path "
                                 f"{worst} from the plain-version path, "
                                 f"over {TEACHER_TOL} * {top}")
        valid = int(np.minimum(eng.lengths.astype(np.int64) + 1,
                               SERVE_LEN).sum())
        profile = _profile_experts(torch, eng._decode_tick,
                                   ("flash_decode",))
    del eng
    tick_bytes, tick_ops = _flash_bytes_ops(
        SERVE_BATCH, cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim, 2,
        valid)
    record.update({
        "layers": cfg.n_layers, "heads": [cfg.n_heads, cfg.padded_heads,
                                          cfg.n_kv_heads, cfg.head_dim],
        "group": cfg.padded_heads // cfg.n_kv_heads,
        "flash_launches": launches["flash_decode"],
        "teacher_forced": {"ticks": TEACHER_TICKS, "max_abs_err": worst,
                           "max_abs_logit": top,
                           "tolerance": f"{TEACHER_TOL} * max|logit|",
                           "kernel_calls_held_to_plain": len(errs),
                           "kernel_max_abs_err": max(errs),
                           "kernel_tolerance":
                               f"{FLASH_TOL} * (1 + |plain|)"},
        "profile": profile,
        "flash_path_bound_ms": bound_ms(tick_bytes, tick_ops)[0],
        "flash_path_bytes": tick_bytes})
    if decoder:
        record["decoder_ep"] = moe_decoder_leg(torch, dev, model, cfg)
    if vl:
        record["vl"] = vl_leg(torch, dev, model, cfg, kattn, ref, kmods)
    record["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    del model
    return record


def moe_phase(torch, dev, kattn, ref, kmods):
    """Phase 10, the MoE family at full width: (a) ``flash_decode`` past 8
    heads a group (:func:`flash_group_leg`); (b) qwen3-moe's MoE layer
    expert parallel under every plan, then arctic-480b's under ``auto``
    and the compressed combine (:func:`moe_layer_leg`); (c, d) qwen3-moe
    cut to its first ``MOE_Q_LAYERS`` layers served, then through the
    expert-parallel decoder; (e) arctic cut to ``MOE_A_LAYERS`` served
    (:func:`moe_serve_leg`). Each leg frees the card before the next.
    Prints one ``{"moe": ...}`` and one ``{"serve_moe": ...}`` line per
    model; returns the flash leg, the staging launches on the EP path and
    both serving records' flash launches and paths."""
    from repro_torch.configs import first_layers, get_config

    qwen, arctic = get_config(MOE_Q_ARCH), get_config(MOE_A_ARCH)
    t0 = time.perf_counter()
    flash = flash_group_leg(torch, kattn, ref, dev)
    print(f"moe phase: flash_decode at G 9-16 within {FLASH_TOL} * (1 + "
          f"|plain|) in {flash['cases_checked']} cases "
          f"({time.perf_counter() - t0:.3f} s)")
    plans = tuple((f"{a}#c{c}" if c > 1 else a, a, c) for a, c in MOE_PLANS)
    staged = dict.fromkeys(STAGING_NAMES, 0)
    for cfg, legs in ((qwen, plans + (("auto", None, None),)),
                      (arctic, (("auto", None, None),))):
        rec = moe_layer_leg(torch, dev, cfg, kmods, legs)
        for k in STAGING_NAMES:
            staged[k] += rec["staging_launches"][k]
        print(json.dumps({"moe": rec}))
        print(f"moe phase: {cfg.name} expert-parallel layer done "
              f"({time.perf_counter() - t0:.3f} s)")
        del rec
    serve = {}
    for cfg, n, key, decoder in ((qwen, MOE_Q_LAYERS, "serve_qwen3_moe",
                                  True),
                                 (arctic, MOE_A_LAYERS, "serve_arctic",
                                  False)):
        gc.collect()
        torch.cuda.empty_cache()
        rec = moe_serve_leg(torch, dev, first_layers(cfg, n), kattn, ref,
                            kmods, decoder=decoder)
        print(json.dumps({"serve_moe": rec}))
        print(f"moe phase: {cfg.name} served ({time.perf_counter() - t0:.3f}"
              f" s)")
        serve[key] = {"flash_launches": rec["flash_launches"],
                      "path_ms": rec["profile"].get("per_launch_ms", {}).get(
                          "flash_decode", "not measured"),
                      "staged": _staged(rec)}
        del rec
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash": flash, "ep_staging": staged, "serve": serve}


#: phase 11, the model families left: seamless-m4t-large-v2 at full
#: depth; qwen2-vl-72b and yi-34b cut to their first 8 layers (the whole
#: of either does not fit one card beside its caches), qwen1.5-4b and
#: phi3-medium-14b whole; every width the published one
SEAMLESS_ARCH = "seamless-m4t-large-v2"
#: seamless's encoder inputs (B, S_enc): attend_full, then past the
#: streaming threshold (the non-causal streaming attention)
ENCDEC_FRAMES = ((SERVE_BATCH, 1024), (1, 4096))
#: seamless's greedy decode: ticks from one fixed start token, a scalar
#: index, SERVE_LEN positions of self-attention cache
ENCDEC_TICKS, ENCDEC_START = 32, 2
#: seamless training on one device: one sequence of the reference's
#: train_4k split (S // 2 frames and S // 2 tokens), remat on, 3 steps
ENCDEC_TRAIN_LEN, ENCDEC_TRAIN_STEPS = 2048, 3
#: attend_streaming against attend_full, non-causal, on one encoder
#: layer's own bf16 q, k and v, relative to the largest |output|: both sum
#: in float32, and each rounds its probabilities to bf16 before p.v,
#: against other running maxima
STREAM_TOL = 2.0 ** -7
#: the profiler range put around the seamless decoder's cross-attention
CROSS_RANGE = "cross_attention"
#: qwen2-vl's VL leg: 256 patch embeddings on a (1, 16, 16) (t, h, w)
#: grid, then 256 text tokens, then ticks at a per-row index
VL_ARCH, VL_GRID_THW, VL_TEXT, VL_TICKS = "qwen2-vl-72b", (1, 16, 16), \
    256, 32
#: the decoder configs served in phase 11: (arch, layers kept (None:
#: all), the path's name)
FAMILY_SERVE = ((VL_ARCH, 8, "serve_qwen2_vl"), ("yi-34b", 8, "serve_yi"),
                ("qwen1.5-4b", None, "serve_qwen15"),
                ("phi3-medium-14b", None, "serve_phi3"))
#: flash_decode at phase 11's new serving shapes (H, KV, hd):
#: seamless's self-attention (G 1, hd 64), qwen1.5's (G 1, hd 128) and
#: phi3's (G 4, hd 128), at (SERVE_BATCH, SERVE_LEN)
FLASH_NEW = {"seamless": (16, 16, 64), "qwen15": (20, 20, 128),
             "phi3": (40, 10, 128)}


def flash_new_leg(torch, kattn, ref, dev):
    """``flash_decode`` at phase 11's new shapes (G 1 and G 4), bf16 and
    fp32, for (B,) lengths (full, 1, mixed) and scalar lengths (1, S // 3,
    S, 0) within ``FLASH_TOL * (1 + |plain|)`` of the plain version, then
    every split edge of the kernel's own split count +-1 and lengths 0 and
    -3; the combine tickets back at zero. Each shape timed (events and
    CUPTI) beside its plain version, one SDPA call and its bound, every row
    at SERVE_LEN."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    B, S = SERVE_BATCH, SERVE_LEN
    worst, checked, splits, timed = 0.0, 0, {}, {}
    for name, (H, KV, hd) in FLASH_NEW.items():
        what = f"{name}: B={B} S={S} H={H} KV={KV} hd={hd}"
        mixed = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                              dtype=torch.int32)
        mixed[0], mixed[1] = S, 1
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _flash_inputs(torch, B, S, H, KV, hd, dtype, gen, dev)
            for lengths in (torch.full((B,), S, dtype=torch.int32,
                                       device=dev),
                            torch.ones((B,), dtype=torch.int32, device=dev),
                            mixed, 1, S // 3, S, 0):
                worst = max(worst, _check_flash(torch, kattn, ref, q, k, v,
                                                lengths, f"{what} {dtype}"))
                checked += 1
        q, k, v = _flash_inputs(torch, B, S, H, KV, hd, torch.bfloat16, gen,
                                dev)
        n = kattn.split_count(B, KV, S, hd, 2, n_sm, H // KV)
        span = -(-S // n)
        for lengths in [e + d for e in range(span, S, span)
                        for d in (-1, 0, 1)] + [0, -3]:
            worst = max(worst, _check_flash(torch, kattn, ref, q, k, v,
                                            lengths, f"{what} {n} splits"))
            checked += 1
        splits[name] = {"n_split": n, "span": span,
                        "head_groups": kattn.head_groups(H // KV)}
        rec = _flash_timed(torch, kattn, ref, dev, gen, flush, H, KV, hd)
        full = torch.full((B,), S, dtype=torch.int32, device=dev)
        rec["kernel_cupti_ms"] = cupti_ms(
            torch, lambda: kattn.flash_decode(q, k, v, full), flush,
            "flash_decode")
        rec["n_split"] = n
        timed[name] = rec
    if any(bool(t.any()) for t in kattn._tickets.values()):
        raise AssertionError("flash_decode left a combine ticket non-zero")
    return {"cases_checked": checked, "max_abs_err": worst,
            "tolerance": f"{FLASH_TOL} * (1 + |plain|)", "splits": splits,
            "shapes": timed}


def _ranged_cross(torch, attention):
    """A stand-in for ``attention.attend_decode`` that puts the calls
    without the kernel (the encoder-decoder's cross-attention decode)
    inside a ``CROSS_RANGE`` profiler range."""
    plain = attention.attend_decode

    def ranged(q, k, v, cur_index, use_kernel=False):
        if use_kernel:
            return plain(q, k, v, cur_index, use_kernel)
        with torch.profiler.record_function(CROSS_RANGE):
            return plain(q, k, v, cur_index, use_kernel)
    return ranged


def _greedy_decode(torch, model, xkv, flags, ticks, start, dev):
    """``ticks`` greedy steps of the encoder-decoder from ``start`` at a
    scalar index on fresh caches of SERVE_LEN positions, each timed on the
    host clock around a synchronize. Returns the tokens (B, ticks), each
    step's (top-2 margin, max |logit|) per row (B, ticks, 2), the times,
    the caches and the last tokens."""
    B = xkv[0]["k"].shape[0]
    caches = model.init_cache(B, SERVE_LEN)
    tok = torch.full((B, 1), start, dtype=torch.long, device=dev)
    toks, margins, times = [], [], []
    for i in range(ticks):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, _ = model.decode_forward(tok, None, flags, caches, i, xkv)
        row = logits[:, -1].float()
        tok = row.argmax(-1, keepdim=True)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        top2 = row.topk(2, dim=-1).values
        toks.append(tok[:, 0])
        margins.append(torch.stack([top2[:, 0] - top2[:, 1],
                                    row.abs().amax(-1)], -1))
    return (torch.stack(toks, 1).cpu().tolist(),
            torch.stack(margins, 1).cpu().tolist(), times, caches, tok)


def _guarded(got, want, margins, tol, what):
    """Each row's tokens equal, or first apart where the plain run's top-2
    margin is within ``2 * tol`` of its largest |logit| (a bf16 near tie);
    returns the rows that agree."""
    same = 0
    for r, (g, w) in enumerate(zip(got, want)):
        diff = [j for j, (a, b) in enumerate(zip(g, w)) if a != b]
        if not diff:
            same += 1
            continue
        margin, top = margins[r][diff[0]]
        if margin > 2 * tol * top:
            raise AssertionError(f"{what} row {r} token {diff[0]}: {g} vs "
                                 f"{w}, plain top-2 margin {margin} (max "
                                 f"|logit| {top})")
    return same


def seamless_serve_leg(torch, dev, kattn, ref, kmods):
    """seamless-m4t-large-v2 at full depth (24 + 24 layers, d 1024, vocab
    256,206; seeded bf16): ``encode`` at ENCDEC_FRAMES (the second past the
    streaming threshold: 24 streaming calls, one encoder layer's streaming
    attention held to ``attend_full`` on its own q, k and v), then
    ``cross_cache`` and ENCDEC_TICKS greedy ticks with the flash-decode
    kernel (launches ticks x 24, every other kernel none), the tokens
    against a run without it under the top-2 margin guard, three
    teacher-forced ticks (every layer's flash call held to the plain
    version, the logits within ``TEACHER_TOL`` of the plain-version
    path's), one profiled tick split into the self-attention's flash
    kernel, the cross-attention and the matrix products."""
    from repro_torch.configs import get_config
    from repro_torch.layers import attention
    from repro_torch.models import params as tparams
    from repro_torch.models.decoder import RunFlags
    from repro_torch.models.encdec import EncDecLM

    cfg = get_config(SEAMLESS_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = EncDecLM(cfg, torch.Generator("cuda").manual_seed(SEED))
    if model.device != dev:
        raise AssertionError(f"model on {model.device}, expected {dev}")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != tparams.n_params(cfg):
        raise AssertionError(f"seamless has {n_params} params, the "
                             f"reference's tree {tparams.n_params(cfg)}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    flags, plain = RunFlags(use_flash_decode=True), RunFlags()
    D = cfg.d_model
    rec = {"leg": "serve", "model": cfg.name, "params": n_params,
           "layers": [cfg.enc_layers, cfg.n_layers], "dtype": "bfloat16",
           "init_s": init_s, "encode": {}}
    stream = attention.attend_streaming
    streamed = []

    def counted(*args, **kw):
        streamed.append(args[0].shape[1])
        return stream(*args, **kw)

    with torch.inference_mode():
        for B, S in ENCDEC_FRAMES:
            frames = torch.randn((B, S, D), generator=gen,
                                 device=dev).to(torch.bfloat16)
            times = []
            streamed.clear()
            attention.attend_streaming = counted
            try:
                for _ in range(2):
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    out = model.encode(frames)
                    torch.cuda.synchronize(dev)
                    times.append(time.perf_counter() - t0)
            finally:
                attention.attend_streaming = stream
            want = 2 * cfg.enc_layers if S * S > \
                attention.STREAMING_THRESHOLD ** 2 else 0
            if len(streamed) != want or out.shape != (B, S, D) or \
                    not bool(torch.isfinite(out).all()):
                raise AssertionError(f"encode ({B}, {S}): {len(streamed)} "
                                     f"streaming calls (expected {want}), "
                                     f"output {tuple(out.shape)}")
            entry = {"s": times, "streaming_calls": len(streamed) // 2}
            if want:
                # one encoder layer: streaming against full attention on
                # the layer's own q, k and v
                layer = model.enc[0]
                x = layer.ln1(frames, cfg.norm_eps)
                q, k, v = (
                    (x @ w).reshape(B, S, -1, cfg.head_dim)
                    for w in (layer.attn.wq, layer.attn.wk, layer.attn.wv))
                full = attention.attend_full(q, k, v, False)
                err = max_diff(torch, stream(q, k, v, False), full)
                top = float(full.abs().max())
                if err > STREAM_TOL * top:
                    raise AssertionError(f"attend_streaming (non-causal) "
                                         f"{err} from attend_full, over "
                                         f"{STREAM_TOL} * {top}")
                entry["streaming_vs_full"] = {
                    "max_abs_err": err, "max_abs_out": top,
                    "tolerance": f"{STREAM_TOL} * max|full|"}
                del q, k, v, full, x
            else:
                enc_out = out
            rec["encode"][f"{B}x{S}"] = entry
            del out, frames
        t0 = time.perf_counter()
        xkv = model.cross_cache(enc_out)
        torch.cuda.synchronize(dev)
        rec["cross_cache_s"] = time.perf_counter() - t0
        # the decode: kernel counts zeroed just before, read just after
        _reset(kmods)
        toks, _, times, caches, _ = _greedy_decode(
            torch, model, xkv, flags, ENCDEC_TICKS, ENCDEC_START, dev)
        launches = _launches(kmods)
        _check_launches("seamless decode", launches,
                        {"flash_decode": ENCDEC_TICKS * cfg.n_layers})
        del caches
        want, margins, plain_times, caches, tok = _greedy_decode(
            torch, model, xkv, plain, ENCDEC_TICKS, ENCDEC_START, dev)
        same = _guarded(toks, want, margins, TEACHER_TOL,
                        "seamless tokens against the plain attention")
        # teacher-forced ticks from the plain run's state: the kernel held
        # to its plain version, and the plain version in its place
        errs = []
        worst, top = forced_ticks(
            torch, lambda t, c, i, f: model.decode_forward(
                t, None, f, c, i, xkv)[0], caches, tok, ENCDEC_TICKS,
            [("kernel", flags,
              {(kattn, "flash_decode"): _flash_held(torch, kattn, ref,
                                                    errs)}),
             ("plain-version", flags,
              {(kattn, "flash_decode"): ref.flash_decode})], TEACHER_TICKS,
            model.lm_head.shape[1])
        _check_held("flash_decode", errs, TEACHER_TICKS * cfg.n_layers)
        worst = worst["plain-version"]
        if worst > TEACHER_TOL * top:
            raise AssertionError(f"seamless teacher-forced logits: kernel "
                                 f"path {worst} from the plain-version "
                                 f"path, over {TEACHER_TOL} * {top}")
        index = ENCDEC_TICKS + TEACHER_TICKS
        attend = attention.attend_decode
        attention.attend_decode = _ranged_cross(torch, attention)
        try:
            profile = profile_call(
                torch, lambda: model.decode_forward(tok, None, flags, caches,
                                                    index, xkv),
                ("flash_decode",), ranges=(CROSS_RANGE,))
        finally:
            attention.attend_decode = attend
    busy = profile["device_busy_ms"]
    if isinstance(busy, float):
        cross = profile["ranges"][CROSS_RANGE]
        profile["shares"] = {
            "flash_decode": profile["name_ms"]["flash_decode"] / busy,
            "cross_attention": cross["ms"] / busy
            if isinstance(cross["ms"], float) else "not measured",
            "gemms": profile["gemm_ms"] / busy}
    B = SERVE_BATCH
    valid = B * (index + 1)
    tick_bytes, tick_ops = _flash_bytes_ops(B, cfg.n_heads, cfg.n_kv_heads,
                                            cfg.head_dim, 2, valid)
    rec.update({
        "batch": B, "max_len": SERVE_LEN, "ticks": ENCDEC_TICKS,
        "start_token": ENCDEC_START, "launches": launches,
        "flash_launches": launches["flash_decode"],
        "tokens_equal_plain_rows": same,
        "decode_tick_s": {"p50": statistics.median(times),
                          "p99": sorted(times)[int(0.99 * (len(times) - 1))],
                          "n": len(times)},
        "plain_tick_p50_s": statistics.median(plain_times),
        "tokens_per_s": B * ENCDEC_TICKS / sum(times),
        "teacher_forced": {"ticks": TEACHER_TICKS, "max_abs_err": worst,
                           "max_abs_logit": top,
                           "tolerance": f"{TEACHER_TOL} * max|logit|",
                           "kernel_calls_held_to_plain": len(errs),
                           "kernel_max_abs_err": max(errs),
                           "kernel_tolerance":
                               f"{FLASH_TOL} * (1 + |plain|)"},
        "profile": profile,
        "flash_path_bound_ms": bound_ms(tick_bytes, tick_ops)[0],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)})
    del model, xkv, caches, enc_out
    return rec


def seamless_train_leg(torch, dev, kmods):
    """seamless-m4t-large-v2 at full depth through ``train_step`` on one
    device: one sequence of ENCDEC_TRAIN_LEN seeded frames and tokens,
    remat on, AdamW at TRAIN_LR, ENCDEC_TRAIN_STEPS steps on the same
    batch: the loss falls at every step, no kernel launches, the peak under
    TRAIN_PEAK_LIMIT_BYTES."""
    from repro_torch.configs import get_config
    from repro_torch.models.decoder import RunFlags
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.params import FlatParams
    from repro_torch.optim import adamw
    from repro_torch.train.step import TrainConfig, train_step

    cfg = get_config(SEAMLESS_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = EncDecLM(cfg, torch.Generator("cuda").manual_seed(SEED))
    flat = FlatParams.of(model.trainable())
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    S = ENCDEC_TRAIN_LEN
    tokens = torch.randint(0, cfg.vocab, (1, S + 1), generator=gen,
                           device=dev)
    batch = {"frames": torch.randn((1, S, cfg.d_model), generator=gen,
                                   device=dev).to(torch.bfloat16),
             "tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=0,
                             schedule="constant")
    opt = adamw.init(flat, ocfg)
    tcfg = TrainConfig(optimizer=ocfg, flags=RunFlags(remat="dots"))
    _reset(kmods)
    times, mets = _timed_steps(
        torch, dev, lambda: train_step(model, opt, batch, tcfg, flat),
        ENCDEC_TRAIN_STEPS)
    _check_launches("seamless train", _launches(kmods), {})
    losses = [float(m["loss"]) for m in mets]
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(b < a for a, b in zip(losses, losses[1:])) or \
            not all(l == l for l in losses):
        raise AssertionError(f"seamless training: losses {losses} do not "
                             f"fall at every step")
    if peak >= TRAIN_PEAK_LIMIT_BYTES:
        raise AssertionError(f"seamless training peak {peak} B, over "
                             f"{TRAIN_PEAK_LIMIT_BYTES}")
    rec = {"leg": "train", "model": cfg.name, "params": flat.n,
           "frames": S, "tokens": S, "remat": "full (every layer)",
           "lr": TRAIN_LR, "losses": losses, "step_s": times,
           "median_step_s": statistics.median(times[1:]),
           "grad_norm": [float(m["grad_norm"]) for m in mets],
           "peak_mem_bytes": peak,
           "peak_limit_bytes": TRAIN_PEAK_LIMIT_BYTES}
    del model, flat, opt, batch, mets
    return rec


def vl_leg(torch, dev, model, cfg, kattn, ref, kmods):
    """qwen2-vl's VL input at full width: ``DecoderLM.forward(tokens,
    caches=, embeds=, positions3=)`` on SERVE_BATCH rows of seeded patch
    embeddings on a VL_GRID_THW (t, h, w) grid before VL_TEXT text tokens
    (their M-RoPE positions the patches' grid, then the text on all three
    streams), then VL_TICKS teacher-forced ticks at a per-row index (the
    text positions from each row's own index, as the reference's), every
    layer's flash call held to the plain version and the logits within
    ``TEACHER_TOL`` of the plain-version path's. Launches: ticks x layers
    flash, nothing else."""
    from repro_torch.models.decoder import RunFlags

    nt, nh, nw = VL_GRID_THW
    B, P = SERVE_BATCH, nt * nh * nw
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    embeds = torch.randn((B, P, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (B, VL_TEXT), generator=gen,
                           device=dev)
    grid = torch.stack(torch.meshgrid(
        torch.arange(nt, device=dev), torch.arange(nh, device=dev),
        torch.arange(nw, device=dev), indexing="ij")).reshape(3, P)
    text = (grid.max() + 1 + torch.arange(VL_TEXT, device=dev)).expand(3, -1)
    positions3 = torch.cat([grid, text], 1).expand(B, 3, P + VL_TEXT)
    flags = RunFlags(use_flash_decode=True)
    caches = model.init_cache(B, SERVE_LEN)
    with torch.inference_mode():
        _reset(kmods)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, _, _ = model(tokens, caches, flags=flags, embeds=embeds,
                             positions3=positions3)
        torch.cuda.synchronize(dev)
        prefill_s = time.perf_counter() - t0
        if logits.shape != (B, P + VL_TEXT, model.lm_head.shape[1]) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"VL prefill logits {tuple(logits.shape)} "
                                 f"or not finite")
        tok = logits[:, -1:].argmax(-1)
        del logits
        index = torch.full((B,), P + VL_TEXT, dtype=torch.long, device=dev)
        errs = []
        t0 = time.perf_counter()
        worst, top = forced_ticks(
            torch, lambda t, c, i, f: model(t, c, i, flags=f)[0], caches,
            tok, index,
            [("kernel", flags,
              {(kattn, "flash_decode"): _flash_held(torch, kattn, ref,
                                                    errs)}),
             ("plain-version", flags,
              {(kattn, "flash_decode"): ref.flash_decode})], VL_TICKS,
            model.lm_head.shape[1])
        ticks_s = time.perf_counter() - t0
    launches = _launches(kmods)
    _check_launches("qwen2-vl VL leg", launches,
                    {"flash_decode": VL_TICKS * cfg.n_layers})
    _check_held("flash_decode", errs, VL_TICKS * cfg.n_layers)
    worst = worst["plain-version"]
    if worst > TEACHER_TOL * top:
        raise AssertionError(f"qwen2-vl teacher-forced logits: kernel path "
                             f"{worst} from the plain-version path, over "
                             f"{TEACHER_TOL} * {top}")
    del caches, embeds
    return {"patches": P, "grid_thw": list(VL_GRID_THW), "text": VL_TEXT,
            "prefill_s": prefill_s, "ticks": VL_TICKS,
            "forced_ticks_s": ticks_s, "launches": launches,
            "flash_launches": launches["flash_decode"],
            "teacher_forced": {"max_abs_err": worst, "max_abs_logit": top,
                               "tolerance": f"{TEACHER_TOL} * max|logit|",
                               "kernel_calls_held_to_plain": len(errs),
                               "kernel_max_abs_err": max(errs),
                               "kernel_tolerance":
                                   f"{FLASH_TOL} * (1 + |plain|)"}}


def families_phase(torch, dev, kattn, ref, kmods):
    """Phase 11, the model families left, at full width: (a)
    ``flash_decode`` at the new shapes (:func:`flash_new_leg`); (b)
    seamless-m4t-large-v2 encoded and decoded (:func:`seamless_serve_leg`)
    and (c) trained (:func:`seamless_train_leg`); (d) qwen2-vl-72b's first
    8 layers served, then its VL input (:func:`vl_leg`); (e) yi-34b's
    first 8 layers, qwen1.5-4b and phi3-medium-14b served (the serving
    legs as phase 10's, :func:`moe_serve_leg`). Each leg frees the card
    before the next. Prints one ``{"encdec": ...}`` line per seamless leg
    and one ``{"serve_<model>": ...}`` line per served model; returns the
    flash leg and each path's flash and staging launches."""
    from repro_torch.configs import first_layers, get_config

    t0 = time.perf_counter()
    flash = flash_new_leg(torch, kattn, ref, dev)
    print(f"families phase: flash_decode at G 1 and G 4 within {FLASH_TOL} "
          f"* (1 + |plain|) in {flash['cases_checked']} cases "
          f"({time.perf_counter() - t0:.3f} s)")
    paths = {}
    rec = seamless_serve_leg(torch, dev, kattn, ref, kmods)
    paths["serve_seamless"] = {
        "flash_launches": rec["flash_launches"],
        "path_ms": rec["profile"].get("per_launch_ms", {}).get(
            "flash_decode", "not measured")}
    print(json.dumps({"encdec": rec}))
    print(f"families phase: seamless served ({time.perf_counter() - t0:.3f}"
          f" s)")
    del rec
    rec = seamless_train_leg(torch, dev, kmods)
    print(json.dumps({"encdec": rec}))
    print(f"families phase: seamless trained ({time.perf_counter() - t0:.3f}"
          f" s)")
    del rec
    for arch, n, key in FAMILY_SERVE:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        cfg = first_layers(cfg, n) if n else cfg
        rec = moe_serve_leg(torch, dev, cfg, kattn, ref, kmods,
                            vl=arch == VL_ARCH)
        print(json.dumps({key: rec}))
        print(f"families phase: {arch} served ({time.perf_counter() - t0:.3f}"
              f" s)")
        paths[key] = {"flash_launches": rec["flash_launches"],
                      "path_ms": rec["profile"].get("per_launch_ms", {}).get(
                          "flash_decode", "not measured"),
                      "staged": _staged(rec)}
        if "vl" in rec:
            paths["vl_prefill"] = {"flash_launches":
                                   rec["vl"]["flash_launches"]}
        del rec
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash": flash, "paths": paths}


#: phase 13, sharded training: qwen3-moe's MoE layer and the model cut to
#: its first layer (every width the published one) on ``RankGrid(2, 4)``,
#: then smollm-360m's checkpoints and the training driver
SHARD_ARCH = "qwen3-moe-235b-a22b"
SHARD_TOKENS = (8, 512)
#: the comparisons' capacity factor (no routing drops), the reference
#: check's bars (tests/checks/moe_ep_check.py, sharded_train_check.py):
#: a leaf's gradient against the local path's, relative to its largest
#: entry, and the loss
SHARD_CAP, SHARD_TOL, SHARD_CE_RTOL = 4.0, 6e-2, 2e-2
SHARD_STEPS, SHARD_LR = 3, 1e-4
SHARD_PEAK_LIMIT_BYTES = 75e9
#: fused forward-and-backward calls timed per plan after a first one
SHARD_ITERS = 3
DRIVER_ARCH = "smollm-360m"
DRIVER_ARGS = ("--arch", DRIVER_ARCH, "--steps", "8", "--batch", "8",
               "--seq", "512", "--ckpt-every", "4", "--ckpt-blocking",
               "--log-every", "1", "--lr", "1e-4")
#: the killed run's last step, the step it resumes from, the steps whose
#: printed losses must equal the uninterrupted run's
DRIVER_DIE, DRIVER_RESUME, DRIVER_HELD = 5, 4, (6, 7)
DRIVER_TIMEOUT = 600
#: ``python -m repro_torch.launch.train`` (the module run as ``-m`` runs
#: it) that prints its kernel launches at a normal exit
DRIVER_PRELUDE = (
    "import atexit, json, runpy, sys\n"
    "from repro_torch.kernels import attention, codec, mamba, rwkv, "
    "staging\n"
    "mods = (codec, attention, rwkv, mamba, staging)\n"
    "atexit.register(lambda: print('LAUNCHES ' + json.dumps("
    "{k: n for m in mods for k, n in m.launches.items()})))\n"
    "runpy.run_module('repro_torch.launch.train', run_name='__main__', "
    "alter_sys=True)\n")


def _leaf_err(torch, got, want):
    """``(max |got - want|, max |want|)`` in float32, a slab of dim 0 at a
    time."""
    err = top = 0.0
    for a, b in zip(got.reshape(got.shape[0], -1) if got.dim() else [got],
                    want.reshape(want.shape[0], -1) if want.dim()
                    else [want]):
        b = b.float()
        err = max(err, float((a.float() - b).abs().max()))
        top = max(top, float(b.abs().max()))
    return err, top


def _ep_grads(torch, layer, x, r, **kw):
    """The gradients of ``sum(y * r)`` with respect to the router, the
    three expert weights and ``x``, and the call's ``y``."""
    y, _ = layer(x, **kw)
    grads = torch.autograd.grad((y.float() * r).sum(),
                                [layer.router, layer.w_gate, layer.w_up,
                                 layer.w_down, x])
    return dict(zip(("router", "w_gate", "w_up", "w_down", "x"), grads)), y


def ep_backward_leg(torch, dev, cfg, kmods):
    """Phase 13 (a): qwen3-moe's MoE layer at full width (seeded bf16
    experts, made trainable) expert parallel on ``RankGrid(2, 4)``, the
    experts over the local axis, on seeded bf16 tokens of ``SHARD_TOKENS``
    that require grad: ``torch.autograd.grad`` of ``sum(y * r)`` (``r``
    seeded) under each lossless plan forced through ``Communicator.plan``
    and ``auto``. At capacity ``SHARD_CAP`` no routing drops, the plans'
    gradients are equal bitwise, and each leaf's lies within ``SHARD_TOL``
    times the local path's largest entry of the local path's; at the
    config's capacity the drops are counted, the gradients finite and the
    plans bitwise equal. Under ``error_budget=MOE_BUDGET`` in grad mode
    each forced compressed combine raises and launches nothing. No kernel
    launches anywhere. Records each plan's forward-and-backward host time
    and the ``auto`` plan's profiles (forward alone, forward and
    backward) split into all-to-alls and expert products."""
    from repro_torch.core import autotune
    from repro_torch.core.comm import communicator
    from repro_torch.core.grid import RankGrid
    from repro_torch.layers import moe as tmoe
    from repro_torch.sharding.rules import Rules

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    layer = tmoe.MoE(cfg, torch.Generator("cuda").manual_seed(SEED + 31))
    layer.requires_grad_(True)
    B, S = SHARD_TOKENS
    gen = torch.Generator("cuda").manual_seed(SEED + 32)
    x = torch.randn((B, S, cfg.d_model), device=dev, generator=gen).to(
        torch.bfloat16).requires_grad_()
    r = torch.randn((B, S, cfg.d_model), device=dev, generator=gen)
    grid, rules = RankGrid(2, 4), Rules(batch=("node",), tp="local")
    comm = communicator(grid).split(axes="local")
    moe0 = cfg.moe
    plans = tuple((f"{a}#c{c}" if c > 1 else a, a, c) for a, c in MOE_PLANS) \
        + (("auto", None, None),)
    record = {"model": cfg.name, "experts": moe0.n_experts,
              "top_k": moe0.top_k, "d_ff_expert": moe0.d_ff_expert,
              "tokens": [B, S], "grid": [2, 4], "capacities": {},
              "tolerance": f"{SHARD_TOL} * max|g_local| per leaf"}
    _reset(kmods)
    for cap, factor in (("4", SHARD_CAP), ("default", moe0.capacity_factor)):
        layer.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            moe0, capacity_factor=factor))
        capacity = tmoe.ep_capacity(B // grid.n_nodes * S, grid.n_local,
                                    layer.cfg.moe)
        rec = {"capacity_factor": factor, "capacity": capacity,
               "plans": {}}
        first = None
        for name, algo, chunks in plans:
            plan = None if algo is None else _forced(autotune, algo, chunks)
            if algo is None:
                sel = comm.plan("alltoall", grid.n_local * capacity
                                * cfg.d_model * 2, dtype="bfloat16")
                algo, chunks = sel.algo, sel.chunks
            fn = _with_plan(lambda: _ep_grads(torch, layer, x, r,
                                              rules=rules, grid=grid), plan)
            (grads, y), secs = _host_timed(torch, fn, SHARD_ITERS)
            dropped = int((~layer.ep_routing["kept"]).sum())
            finite = all(bool(torch.isfinite(g).all())
                         for g in grads.values())
            if not finite:
                raise AssertionError(f"EP backward {name} at capacity "
                                     f"{cap}: a gradient is not finite")
            rec["plans"][name] = {"algo": algo, "chunks": chunks,
                                  "fwd_bwd_host_ms": secs * 1e3,
                                  "dropped": dropped}
            if first is None:
                first = (name, grads, dropped)
                continue
            for leaf, g in grads.items():
                if not torch.equal(g, first[1][leaf]):
                    raise AssertionError(f"EP backward capacity {cap}: "
                                         f"{name}'s d{leaf} differs from "
                                         f"{first[0]}'s")
            if dropped != first[2]:
                raise AssertionError(f"drop counts differ: {dropped} vs "
                                     f"{first[2]}")
            del grads, y
        rec["dropped"] = first[2]
        rec["lossless_bitwise"] = [p[0] for p in plans]
        if cap == "4":
            if first[2]:
                raise AssertionError(f"{first[2]} routings dropped at "
                                     f"capacity {SHARD_CAP}")
            (local, _), local_s = _host_timed(
                torch, lambda: _ep_grads(torch, layer, x, r), 1)
            rec["local_fwd_bwd_host_ms"] = local_s * 1e3
            rec["vs_local"] = {}
            for leaf, g in first[1].items():
                err, top = _leaf_err(torch, g, local[leaf])
                if err > SHARD_TOL * top:
                    raise AssertionError(f"EP d{leaf}: {err} from the local "
                                         f"path's, over {SHARD_TOL} * {top}")
                rec["vs_local"][leaf] = {"max_abs_err": err,
                                         "max_abs_local": top,
                                         "bitwise": err == 0.0}
            del local
            fwd = lambda: layer(x, rules=rules, grid=grid)
            fwd()
            rec["profile_forward"] = _profile_ep(torch, fwd)
            rec["profile_forward_backward"] = _profile_ep(
                torch, lambda: _ep_grads(torch, layer, x, r, rules=rules,
                                         grid=grid))
        record["capacities"][cap] = rec
        del first
    launches = _launches(kmods)
    _check_launches("EP backward", launches, {})
    refused = {}
    for algo, chunks, codec in MOE_CODEC_PLANS:
        _reset(kmods)
        try:
            _with_plan(lambda: layer(x, rules=rules, grid=grid,
                                     error_budget=MOE_BUDGET),
                       _forced(autotune, algo, chunks, codec))()
        except ValueError as e:
            refused[f"{algo}#c{chunks}@{codec}"] = str(e)[:80]
        else:
            raise AssertionError(f"the compressed combine {codec} ran under "
                                 f"grad")
        _check_launches(f"refused combine {codec}", _launches(kmods), {})
    record["refused_under_grad"] = refused
    record["launches"] = launches
    record["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    del layer, x, r
    return record


def _leaf_paths(flat):
    """Each weight tensor's leaf path, in ``flat.tensors``' order."""
    firsts = [f for _, _, _, f in flat.spans] + [len(flat.tensors)]
    return [p for (p, _, _, f), nxt in zip(flat.spans, firsts[1:])
            for _ in range(nxt - f)]


def sharded_train_leg(torch, dev, kmods):
    """Phase 13 (b): qwen3-moe cut to its first layer (every width the
    published one, seeded bf16 weights) on ``RankGrid(2, 4)`` under
    ``Rules(batch=("node",), tp="local")``, on the step-0 batch of
    ``SyntheticLM(vocab, 512, 8, seed=0)``. (b1) at capacity
    ``SHARD_CAP`` and aux weight 0 (the aux is defined per slice on the
    expert-parallel path): ``value_and_grad`` sharded against on one
    device, ``ce`` within ``SHARD_CE_RTOL`` and every leaf's gradient
    within ``SHARD_TOL`` times its largest local entry. (b2) at the
    config's own capacity and aux weight, ``SHARD_STEPS`` sharded
    ``train_step`` calls with AdamW at a constant ``SHARD_LR``: the loss
    finite and falling at every step, the peak under
    ``SHARD_PEAK_LIMIT_BYTES``, no kernel launched; then one profiled
    step."""
    from repro_torch.configs import first_layers, get_config
    from repro_torch.core.grid import RankGrid
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.decoder import DecoderLM, RunFlags
    from repro_torch.models.params import FlatParams, n_params
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import Rules
    from repro_torch.train.step import TrainConfig, train_step, \
        value_and_grad

    gc.collect()
    torch.cuda.empty_cache()
    cfg = first_layers(get_config(SHARD_ARCH), 1)
    cmp_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=SHARD_CAP, aux_loss_weight=0.0))
    t0 = time.perf_counter()
    model = DecoderLM(cmp_cfg, torch.Generator("cuda").manual_seed(
        SEED + 41)).trainable()
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    flat = FlatParams.of(model)
    B, S = SHARD_TOKENS
    host = SyntheticLM(cfg.vocab, S, B, seed=0).batch(0)
    batch = {k: torch.from_numpy(v).to(dev).long() for k, v in host.items()}
    grid, rules = RankGrid(2, 4), Rules(batch=("node",), tp="local")
    ocfg = adamw.AdamWConfig(lr=SHARD_LR, schedule="constant",
                             warmup_steps=0)
    tcfg = TrainConfig(optimizer=ocfg, flags=RunFlags(remat="none"))
    record = {"model": cfg.name, "layers": cfg.n_layers,
              "params": n_params(cfg), "tokens": [B, S], "grid": [2, 4],
              "init_s": init_s}
    _reset(kmods)
    _, m_local, g_local = value_and_grad(model, flat, batch, tcfg)
    _, m_ep, g_ep = value_and_grad(model, flat, batch, tcfg, rules, grid)
    ce_l, ce_e = float(m_local["ce"]), float(m_ep["ce"])
    if not abs(ce_e - ce_l) <= SHARD_CE_RTOL * abs(ce_l):
        raise AssertionError(f"sharded ce {ce_e} vs {ce_l}, over rtol "
                             f"{SHARD_CE_RTOL}")
    worst = {}
    for path, a, b in zip(_leaf_paths(flat), g_ep, g_local):
        err, top = _leaf_err(torch, a, b)
        if err > SHARD_TOL * top:
            raise AssertionError(f"sharded d{path}: {err} from the local "
                                 f"gradient, over {SHARD_TOL} * {top}")
        e0, t0_ = worst.get(path, (0.0, 0.0))
        worst[path] = (max(e0, err), max(t0_, top))
    record["compare"] = {
        "capacity_factor": SHARD_CAP, "aux_loss_weight": 0.0,
        "ce_local": ce_l, "ce_sharded": ce_e,
        "ce_rtol": SHARD_CE_RTOL,
        "grad_max_rel_err": {p: (e / t if t else 0.0)
                             for p, (e, t) in worst.items()},
        "grad_bitwise": all(e == 0.0 for e, _ in worst.values()),
        "tolerance": f"{SHARD_TOL} * max|g_local| per leaf"}
    del g_local, g_ep, m_local, m_ep
    compare_launches = _launches(kmods)
    _check_launches("sharded value_and_grad", compare_launches, {})

    model.cfg = cfg
    for blk in model.blocks:
        blk.moe.cfg = cfg
    opt = adamw.init(flat, ocfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset(kmods)
    step = lambda: train_step(model, opt, batch, tcfg, flat, rules=rules,
                              grid=grid)
    times, mets = _timed_steps(torch, dev, step, SHARD_STEPS)
    losses = [float(m["loss"]) for m in mets]
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(v) for v in losses) or any(
            b >= a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"sharded train losses {losses}: not finite "
                             f"or not falling at every step")
    if peak >= SHARD_PEAK_LIMIT_BYTES:
        raise AssertionError(f"sharded train peak {peak} B over "
                             f"{SHARD_PEAK_LIMIT_BYTES}")
    profile = profile_device(torch, step, ())
    launches = _launches(kmods)
    _check_launches("sharded train step", launches, {})
    record.update(_leg_record(times, B * S, profile, launches))
    record.update({"losses": losses, "aux": [float(m["aux"]) for m in mets],
                   "capacity_factor": cfg.moe.capacity_factor,
                   "aux_loss_weight": cfg.moe.aux_loss_weight,
                   "lr": SHARD_LR, "peak_mem_bytes": peak,
                   "peak_limit_bytes": SHARD_PEAK_LIMIT_BYTES,
                   "launches": {k: compare_launches[k] + n
                                for k, n in launches.items()}})
    del model, flat, opt, mets
    return record


def _driver(args, env):
    """One ``python -m repro_torch.launch.train`` run (through
    ``DRIVER_PRELUDE``): exit code, stdout, its printed losses by step,
    its kernel launches (None after a hard exit) and its wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", DRIVER_PRELUDE, *args],
                          capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=DRIVER_TIMEOUT)
    losses, launches = {}, None
    for line in proc.stdout.splitlines():
        if line.startswith("[train] step"):
            losses[int(line.split()[2])] = line.split()[4]
        elif line.startswith("LAUNCHES "):
            launches = json.loads(line[len("LAUNCHES "):])
    return {"rc": proc.returncode, "stdout": proc.stdout,
            "stderr": proc.stderr[-2000:], "losses": losses,
            "launches": launches, "wall_s": time.perf_counter() - t0}


def train_driver_leg(torch, dev, kmods):
    """Phase 13 (c): smollm-360m at full width. In process: its train
    state on the card (seeded bf16 weights, float32 ``m`` and ``v`` drawn
    seeded, the step) saved blocking and async, restored into a like-tree
    on the card, the sha256 of the weights, ``m`` and ``v`` equal to the
    saved ones. Then three runs of ``python -m repro_torch.launch.train``
    (``DRIVER_ARGS``, a directory each under ``build/``): uninterrupted;
    killed at ``DRIVER_DIE`` (exit 42); resumed (``resumed from step
    DRIVER_RESUME``), whose printed losses at ``DRIVER_HELD`` must equal
    the uninterrupted run's. The directories are removed."""
    import os
    import shutil
    from repro_torch.checkpoint.manager import CheckpointManager, \
        train_state
    from repro_torch.configs import get_config
    from repro_torch.models.decoder import DecoderLM
    from repro_torch.models.params import FlatParams
    from repro_torch.optim import adamw

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    dirs = {k: build / f"ckpt_{k}" for k in ("inproc", "ref", "ft")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    record = {"model": DRIVER_ARCH,
              "disk_free_bytes": shutil.disk_usage(build).free}
    _reset(kmods)
    gen = torch.Generator("cuda").manual_seed(SEED + 51)
    model = DecoderLM(get_config(DRIVER_ARCH), gen)
    flat = FlatParams.of(model)
    opt = adamw.init(flat, adamw.AdamWConfig())
    opt["m"].normal_(generator=gen)
    opt["v"].uniform_(generator=gen)
    opt["step"] = 5
    state = train_state(flat, opt)
    shas = {k: _sha(torch, list(v.values())) for k, v in (
        ("params", state["params"]), ("m", state["opt"]["m"]),
        ("v", state["opt"]["v"]))}
    leaves = list(state["params"].values()) + list(
        state["opt"]["m"].values()) + list(state["opt"]["v"].values())
    record["bytes"] = sum(t.numel() * t.element_size() for t in leaves)
    mgr = CheckpointManager(str(dirs["inproc"]))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    mgr.save(5, state)
    record["save_blocking_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mgr.save(6, state, blocking=False)
    record["save_async_return_s"] = time.perf_counter() - t0
    mgr.wait()
    record["save_async_s"] = time.perf_counter() - t0
    for step in (5, 6):
        t0 = time.perf_counter()
        back = mgr.restore(step, state)
        torch.cuda.synchronize(dev)
        record[f"restore_s_step{step}"] = time.perf_counter() - t0
        got = {k: _sha(torch, list(v.values())) for k, v in (
            ("params", back["params"]), ("m", back["opt"]["m"]),
            ("v", back["opt"]["v"]))}
        if got != shas or int(back["opt"]["step"]) != 5:
            raise AssertionError(f"checkpoint step {step}: restored sha256 "
                                 f"{got} != saved {shas}")
        if any(t.device != dev for t in back["params"].values()):
            raise AssertionError("restored weights not on the card")
        del back
    record["sha256"] = shas
    record["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    inproc = _launches(kmods)
    _check_launches("in-process checkpoint", inproc, {})
    del model, flat, opt, state, leaves
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(dirs["inproc"], ignore_errors=True)

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + (
        ":" + os.environ["PYTHONPATH"] if os.environ.get("PYTHONPATH")
        else ""))
    runs = {}
    try:
        runs["uninterrupted"] = _driver(
            DRIVER_ARGS + ("--ckpt-dir", str(dirs["ref"])), env)
        shutil.rmtree(dirs["ref"], ignore_errors=True)
        runs["killed"] = _driver(DRIVER_ARGS + (
            "--ckpt-dir", str(dirs["ft"]), "--die-at-step",
            str(DRIVER_DIE)), env)
        runs["resumed"] = _driver(
            DRIVER_ARGS + ("--ckpt-dir", str(dirs["ft"])), env)
    finally:
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)
    want = {"uninterrupted": 0, "killed": 42, "resumed": 0}
    for name, run in runs.items():
        if run["rc"] != want[name]:
            raise AssertionError(f"driver {name}: exit {run['rc']}, "
                                 f"expected {want[name]}\n{run['stdout']}"
                                 f"\n{run['stderr']}")
    if "injected failure" not in runs["killed"]["stdout"]:
        raise AssertionError("driver killed: no injected failure printed")
    if f"resumed from step {DRIVER_RESUME}" not in runs["resumed"]["stdout"]:
        raise AssertionError("driver resumed: no 'resumed from step "
                             f"{DRIVER_RESUME}'")
    ref_l, res_l = runs["uninterrupted"]["losses"], runs["resumed"]["losses"]
    for step in DRIVER_HELD:
        if ref_l.get(step) is None or ref_l.get(step) != res_l.get(step):
            raise AssertionError(f"driver step {step}: resumed loss "
                                 f"{res_l.get(step)} != uninterrupted "
                                 f"{ref_l.get(step)}")
    launches = dict(inproc)
    for name in ("uninterrupted", "resumed"):
        counted = runs[name]["launches"]
        if counted is None:
            raise AssertionError(f"driver {name}: no launch counts printed")
        _check_launches(f"driver {name}", counted, {})
        for k, n in counted.items():
            launches[k] = launches.get(k, 0) + n
    record["runs"] = {name: {"rc": run["rc"], "wall_s": run["wall_s"],
                             "losses": run["losses"],
                             "launches": run["launches"],
                             "step_s": [float(line.split("(")[1].split(
                                 "s/step")[0]) for line in
                                 run["stdout"].splitlines()
                                 if line.startswith("[train] step")]}
                      for name, run in runs.items()}
    record["held_steps"] = list(DRIVER_HELD)
    record["launches"] = launches
    return record


def sharded_train_phase(torch, dev, kmods):
    """Phase 13, sharded training (:func:`ep_backward_leg`,
    :func:`sharded_train_leg`, :func:`train_driver_leg`), each leg freeing
    the card before the next. Prints one ``{"ep_backward": ...}``, one
    ``{"sharded_train": ...}`` and one ``{"train_driver": ...}`` line;
    returns each path's kernel launches (all 0)."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    out = {}
    for key, leg in (("ep_backward", lambda: ep_backward_leg(
            torch, dev, get_config(SHARD_ARCH), kmods)),
                     ("sharded_train", lambda: sharded_train_leg(
                         torch, dev, kmods)),
                     ("train_driver", lambda: train_driver_leg(
                         torch, dev, kmods))):
        rec = leg()
        out[key] = rec["launches"]
        print(json.dumps({key: rec}))
        print(f"sharded-training phase: {key} done "
              f"({time.perf_counter() - t0:.3f} s)")
        del rec
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 14: the roofline on the card
# ---------------------------------------------------------------------------

#: (a) one-device train steps: the arch, (batch, sequence), timed steps
ROOF_ARCH, ROOF_TOKENS, ROOF_STEPS = "smollm-360m", (8, 2048), 3
#: (b) serving ticks with the kernels: (arch, RunFlags knob, the kernel's
#: counter name), 8 rows of a 2048-position cache at per-row offsets
ROOF_SERVE = (("smollm-360m", "use_flash_decode", "flash_decode"),
              ("rwkv6-1.6b", "use_rwkv_kernel", "rwkv6_wkv"))
ROOF_TICKS = 10
#: (c) dry-run cells on the 32x8 production grid on meta
ROOF_CELLS = (("smollm-360m", "train_4k"), ("qwen3-moe-235b-a22b",
                                            "decode_32k"))
#: (d) the examples, each ending with "<name> OK"
ROOF_EXAMPLES = ("quickstart", "serve_llm", "collectives_demo")


def _roof_bound(costs):
    """The H100 SXM5 roofline bound of counted work (``roofline.terms``):
    ``(seconds, "compute" or "memory", each term)``."""
    from repro_torch.roofline import terms as T
    hw = T.H100_SXM
    terms = {"compute": costs.flops / hw.peak_flops,
             "memory": costs.memory_bytes / hw.hbm_bw}
    by = max(terms, key=terms.get)
    return terms[by], by, terms


def _by_op_diff(card, meta):
    """The ops whose counted bytes or calls differ between two counts."""
    return {k: {"card": list(card.get(k, (0, 0))),
                "meta": list(meta.get(k, (0, 0)))}
            for k in sorted(set(card) | set(meta))
            if tuple(card.get(k, (0, 0))) != tuple(meta.get(k, (0, 0)))}


def roofline_train_leg(torch, dev, kmods):
    """Phase 14 (a): full-width one-device ``train_step`` of ``ROOF_ARCH``
    at ``ROOF_TOKENS``, remat "dots": its count on the card against the
    same step's count on ``meta`` (FLOPs and collective bytes bitwise,
    HBM bytes equal or each differing op named), and the roofline bound
    of the count against the measured median step (host clock around a
    synchronize, after a warm-up)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.decoder import DecoderLM, RunFlags
    from repro_torch.models.params import FlatParams
    from repro_torch.optim import adamw
    from repro_torch.roofline.counter import WorkCounter
    from repro_torch.train.step import TrainConfig, train_step

    cfg = get_config(ROOF_ARCH)
    B, S = ROOF_TOKENS
    ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=0,
                             schedule="constant")
    tcfg = TrainConfig(optimizer=ocfg, flags=RunFlags(remat="dots"))
    host = SyntheticLM(cfg.vocab, S, B, seed=0).batch(0)

    def setup(device, gen):
        model = DecoderLM(cfg, gen, device=device)
        flat = FlatParams.of(model)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).long()
                 .to(device) for k, v in host.items()}
        return model, flat, adamw.init(flat, ocfg), batch

    def counted(model, flat, opt, batch):
        with WorkCounter() as wc:
            train_step(model, opt, batch, tcfg, flat)
        return wc

    t0 = time.perf_counter()
    meta = counted(*setup("meta", None))
    meta_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    model, flat, opt, batch = setup(dev, torch.Generator(dev)
                                    .manual_seed(SEED))
    _reset(kmods)
    train_step(model, opt, batch, tcfg, flat)  # warm-up
    times, _ = _timed_steps(torch, dev, lambda: train_step(
        model, opt, batch, tcfg, flat), ROOF_STEPS)
    torch.cuda.synchronize(dev)
    card = counted(model, flat, opt, batch)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    launches = _launches(kmods)
    cc, mc = card.costs(), meta.costs()
    if cc.flops != mc.flops:
        raise AssertionError(f"train step: {cc.flops} FLOPs on the card, "
                             f"{mc.flops} on meta")
    if cc.collective_bytes != mc.collective_bytes:
        raise AssertionError(f"train step: collective bytes "
                             f"{cc.collective_bytes} on the card, "
                             f"{mc.collective_bytes} on meta")
    differ = _by_op_diff(card.by_op, meta.by_op)
    if cc.memory_bytes != mc.memory_bytes and not differ:
        raise AssertionError("train step: HBM bytes differ and no op "
                             "names the difference")
    bound, by, terms = _roof_bound(cc)
    step = statistics.median(times)
    if bound > step:
        raise AssertionError(f"train step: the roofline bound {bound} s "
                             f"exceeds the measured step {step} s (an "
                             f"impossible reading)")
    rec = {"model": cfg.name, "tokens": [B, S], "remat": "dots",
           "step_s": times, "median_step_s": step,
           "flops": cc.flops, "memory_bytes": {"card": cc.memory_bytes,
                                               "meta": mc.memory_bytes},
           "bytes_differ_by_op": differ,
           "collective_bytes": cc.collective_bytes,
           "aten_ops": {"card": cc.aten_ops, "meta": mc.aten_ops},
           "bound_s": bound, "bound_by": by, "terms_s": terms,
           "roofline_fraction": bound / step,
           "peak_live_bytes": {"card": cc.peak_live_bytes,
                               "meta": mc.peak_live_bytes},
           "max_memory_allocated": peak, "meta_count_s": meta_s,
           "launches": launches}
    del model, flat, opt, batch
    return rec


def roofline_serve_leg(torch, dev, kmods, arch, knob, kernel):
    """Phase 14 (b): full-width ``arch`` decode ticks of 8 rows at per-row
    offsets into 2048-position caches with the kernel ``knob`` on: one
    counted tick (the kernel's registered cost once per launch, the
    wrapper's launch count), then ``ROOF_TICKS`` timed ticks, the count's
    bound at most their median."""
    from repro_torch.configs import get_config
    from repro_torch.models.decoder import DecoderLM, RunFlags
    from repro_torch.roofline.counter import WorkCounter

    cfg = get_config(arch)
    B = SERVE_BATCH
    model = DecoderLM(cfg, torch.Generator(dev).manual_seed(SEED),
                      device=dev)
    caches = model.init_cache(B, SERVE_LEN)
    gen = torch.Generator(dev).manual_seed(SEED)
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device=dev)
    idx = torch.arange(B, device=dev) * (SERVE_PROMPT[1] // B) \
        + SERVE_PROMPT[0]
    flags = RunFlags(**{knob: True})

    @torch.no_grad()
    def tick():
        return model(tok, caches=caches, cache_index=idx, flags=flags)[0]
    tick()
    _reset(kmods)
    torch.cuda.synchronize(dev)
    with WorkCounter() as wc:
        tick()
    torch.cuda.synchronize(dev)
    launched = _launches(kmods)
    costs = wc.costs()
    calls = costs.kernels.get(kernel, {}).get("calls", 0)
    if not calls or calls != launched.get(kernel, 0):
        raise AssertionError(f"{arch} tick: {calls} counted calls of "
                             f"{kernel}, {launched.get(kernel, 0)} launches")
    others = {k: n for k, n in launched.items() if n and k != kernel}
    if others or set(costs.kernels) != {kernel}:
        raise AssertionError(f"{arch} tick: other kernels {others}, "
                             f"counted {sorted(costs.kernels)}")
    _reset(kmods)
    times, _ = _timed_steps(torch, dev, tick, ROOF_TICKS)
    tick_launches = _launches(kmods)
    bound, by, terms = _roof_bound(costs)
    med = statistics.median(times)
    if bound > med:
        raise AssertionError(f"{arch} tick: the roofline bound {bound} s "
                             f"exceeds the measured tick {med} s")
    rec = {"model": cfg.name, "rows": B, "cache": SERVE_LEN,
           "offsets": idx.tolist(), "kernel": kernel,
           "counted_calls": calls, "kernel_cost": costs.kernels[kernel],
           "flops": costs.flops, "memory_bytes": costs.memory_bytes,
           "kernel_ops": costs.kernel_ops, "tick_s": times,
           "median_tick_s": med, "bound_s": bound, "bound_by": by,
           "terms_s": terms, "roofline_fraction": bound / med}
    launches = {k: launched.get(k, 0) + tick_launches.get(k, 0)
                for k in set(launched) | set(tick_launches)}
    del model, caches
    return rec, launches


def roofline_examples_leg(torch, dev, kmods):
    """Phase 14 (d): the three examples on ``dev``'s kind of device, in
    this process (the kernels already built), each's stdout ending with
    its OK line; returns their seconds and each's kernel launches."""
    import contextlib
    import importlib
    import io
    out = {}
    for name in ROOF_EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        buf = io.StringIO()
        _reset(kmods)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                mod.main(["--device", dev.type])
        finally:
            # the training driver turns deterministic algorithms on
            torch.use_deterministic_algorithms(False)
        lines = buf.getvalue().splitlines()
        if not lines or lines[-1] != f"{name} OK":
            raise AssertionError(f"example {name}: last line "
                                 f"{lines[-1:] if lines else None}")
        print(f"  {name}: {lines[-1]}")
        out[name] = {"seconds": time.perf_counter() - t0,
                     "launches": _launches(kmods)}
    return out


def roofline_phase(torch, dev, kmods):
    """Phase 14, the roofline on the card: (a) :func:`roofline_train_leg`,
    (b) :func:`roofline_serve_leg` for each of ``ROOF_SERVE``, (c)
    ``launch.dryrun.run_cell`` of ``ROOF_CELLS`` on the 32x8 grid on
    ``meta``, (d) :func:`roofline_examples_leg`. Prints one
    ``{"roofline_train": ...}``, one ``{"roofline_tick": ...}`` per served
    model, one ``{"roofline_dryrun": ...}`` and one ``{"roofline_examples":
    ...}`` line as each leg ends; returns each path's kernel launches."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    paths = {}
    rec = roofline_train_leg(torch, dev, kmods)
    paths["roofline_train"] = rec["launches"]
    print(json.dumps({"roofline_train": rec}))
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    for arch, knob, kernel in ROOF_SERVE:
        rec, paths[f"roofline_{kernel}"] = roofline_serve_leg(
            torch, dev, kmods, arch, knob, kernel)
        print(json.dumps({"roofline_tick": rec}))
        del rec
        gc.collect()
        torch.cuda.empty_cache()
    cells = {}
    for arch, shape in ROOF_CELLS:
        cell = dryrun.run_cell(arch, shape, False)
        if cell["status"] != "ok":
            raise AssertionError(f"dry run {arch} x {shape}: {cell}")
        cells[f"{arch}/{shape}"] = {
            k: cell[k] for k in ("mesh", "count_s", "roofline", "hlo",
                                 "memory", "moe_rule")}
    print(json.dumps({"roofline_dryrun": cells}))
    examples = roofline_examples_leg(torch, dev, kmods)
    for name, ex in examples.items():
        paths[f"example_{name}"] = ex["launches"]
    print(json.dumps({"roofline_examples": examples}))
    print(f"roofline phase: {time.perf_counter() - t0:.3f} s")
    return paths


FEEDBACK_LINES = {"int8": 123, "int4": 204, "fp8": 294}


# ---------------------------------------------------------------------------
# phase 15: one process per rank on the card (process groups, both transports)
# ---------------------------------------------------------------------------

#: (a), (b), (d) and (e): eight one-rank workers; (c): four workers of two
#: ranks
PG_PROCS, PG_MOE_PROCS = 8, 4
#: every worker runs every leg on a grid of each transport, in this order
PG_TRANSPORTS = ("gloo", "shm")
#: every axis crosses processes in both layouts: the key under each
PG_KEYS = {"gloo": "2x4/host_ipc/host_ipc", "shm": "2x4/h100_ipc/h100_ipc"}
PG_TIMEOUT = 900
#: the color splits across processes: alternating ranks, and the same
#: with a key that reverses each group
PG_SPLITS = {"alternate": ([0, 1] * 4, None),
             "alternate_reversed": ([0, 1] * 4, list(range(8))[::-1])}
#: the children's and the color groups' collectives and per-rank sizes
PG_GROUP_COLLS = ("allreduce", "alltoall", "allgather", "reduce_scatter",
                  "broadcast", "scatter")
#: the EP layer: capacity factor 4 (the TP size: nothing drops), the plans
#: forced through Communicator.plan (None: the selector's) and the ones
#: also taken through the backward
PG_MOE_CAP = 4.0
PG_MOE_PLANS = (("pip_mcoll", "pip_mcoll", 1),
                ("pip_pipeline_c2", "pip_pipeline", 2), ("xla", "xla", 1),
                ("auto", None, None))
PG_MOE_BWD = ("pip_mcoll", "auto")
PG_MOE_ITERS = 2
#: elements per digest chunk
PG_DIGEST_CHUNK = 1 << 24


def _bits_digest(torch, t):
    """A bitwise digest of ``t`` on its device: per chunk of
    ``PG_DIGEST_CHUNK`` elements the int64 sum of its bit patterns times a
    fixed odd weight per position (wrapping, so independent of the sum's
    order)."""
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[t.element_size()]
    flat = t.detach().contiguous().reshape(-1).view(bits)
    out = []
    for s in range(0, flat.numel(), PG_DIGEST_CHUNK):
        w = flat[s:s + PG_DIGEST_CHUNK].to(torch.int64)
        k = torch.arange(s, s + w.numel(), dtype=torch.int64,
                         device=w.device)
        out.append(int((w * (k * 2654435761 + 1)).sum()))
    return out


def pg_groups(torch, np, comm, kstaging):
    """The ``("node",)`` and ``("local",)`` children and the color splits
    of ``PG_SPLITS`` on ``comm``, every collective of ``PG_GROUP_COLLS``
    under ``pip_mcoll`` at ``TP_SIZES``: per call the member indices this
    process holds and the sha256 of each held result row, and the staging
    launches of all the calls."""
    from repro_torch.core import runtime
    grid = comm.grid
    world = grid.world
    out = {}
    _reset((kstaging,))
    for ax in ("node", "local"):
        child = comm.split(axes=ax)
        for coll in PG_GROUP_COLLS:
            for nb in TP_SIZES:
                x = runtime.example_input(coll, child.topo, nb, devices=world,
                                          device=grid.device)
                y = child.invoke(coll, x, algo="pip_mcoll")
                out[f"{ax}/{coll}/{nb}"] = (list(grid.held),
                                            _row_sha(torch, y, grid.rows))
    for name, (color, key) in PG_SPLITS.items():
        for c, child in comm.split(color=color, key=key).items():
            held = [i for i, r in enumerate(child.ranks) if r in grid.held]
            if not held:
                continue
            for coll in PG_GROUP_COLLS:
                for nb in TP_SIZES:
                    x = torch.from_numpy(tp_operand(
                        np, coll, nb, "float32", world=len(child.ranks))).to(
                            grid.device)
                    y = child.invoke(coll, x, algo="pip_mcoll")
                    out[f"{name}/{c}/{coll}/{nb}"] = (
                        held, _row_sha(torch, y, len(held)))
    torch.cuda.synchronize()
    return out, {k: n for k, n in kstaging.launches.items() if n}


def pg_serve(torch, np, grid, cfg, kmods):
    """Full-width ``cfg`` (seeded bf16 weights, the same in every process)
    served by ``Engine(max_batch=SERVE_BATCH, max_len=SERVE_LEN,
    use_flash_decode=True, mesh=grid)`` (no mesh: the sync-free engine):
    the phase-4 requests' tokens, the tick times, the run's launches and
    one sync call's alone."""
    from repro_torch.models.decoder import DecoderLM, RunFlags
    from repro_torch.serve.engine import Engine, Request

    model = DecoderLM(cfg, torch.Generator("cuda").manual_seed(SEED))
    prompts = _serve_requests(np, cfg.vocab)
    eng = Engine(model, cfg, max_batch=SERVE_BATCH, max_len=SERVE_LEN,
                 flags=RunFlags(use_flash_decode=True), mesh=grid,
                 sync_algo="auto")
    prefill_s, decode_s = [], []
    eng._admit = _timed(eng._admit, prefill_s)
    eng._decode_tick = _timed(eng._decode_tick, decode_s)
    torch.cuda.synchronize()
    _reset(kmods)
    t0 = time.perf_counter()
    done = eng.run([Request(prompt=p.copy(), max_new_tokens=SERVE_NEW)
                    for p in prompts])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    rec = {"tokens": {tuple(r.prompt.tolist()): r.out_tokens for r in done},
           "metrics": eng.metrics(), "wall_s": wall_s,
           "tokens_per_s": SERVE_REQUESTS * SERVE_NEW / wall_s,
           "decode_tick_s": {"p50": statistics.median(decode_s),
                             "p99": sorted(decode_s)[
                                 int(0.99 * (len(decode_s) - 1))],
                             "n": len(decode_s)},
           "prefill_s_p50": statistics.median(prefill_s),
           "launches": _launches(kmods)}
    if grid is not None:
        rec["sync_plan"] = eng._sync_op.plan
        with torch.inference_mode():
            tick = torch.zeros(SERVE_BATCH, dtype=torch.int32,
                               device=grid.device)
            rec["sync_launches"] = _sync_alone(
                torch, None, kmods, lambda: eng._sync_op.start(tick).wait())
    del eng, model
    return rec


def pg_moe(torch, cfg, grid, kmods):
    """``cfg``'s MoE layer at full width (seeded bf16 experts, the same in
    every process) expert parallel on ``grid``, the batch over the nodes
    and the experts over the local axis, capacity factor ``PG_MOE_CAP``,
    on seeded bf16 tokens of ``MOE_TOKENS``: under each plan of
    ``PG_MOE_PLANS`` the digests of y, aux, the routings and the kept
    flags (forward under no_grad, its median host ms), and under those of
    ``PG_MOE_BWD`` the digests of ``torch.autograd.grad(sum(y * r))`` with
    respect to the router, the three expert weights and x, with the
    forward+backward host ms. The launches of every call (none: the
    all-to-alls and the all-gather move no rows through the staging
    primitives) and the peak memory."""
    from repro_torch.core import autotune
    from repro_torch.layers import moe as tmoe
    from repro_torch.sharding.rules import Rules

    dev = grid.device
    torch.cuda.reset_peak_memory_stats(dev)
    ccfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=PG_MOE_CAP))
    layer = tmoe.MoE(ccfg, torch.Generator("cuda").manual_seed(SEED + 11))
    B, S = MOE_TOKENS
    x, r = (torch.randn((B, S, cfg.d_model), device=dev,
                        generator=torch.Generator("cuda").manual_seed(s)
                        ).to(torch.bfloat16) for s in (SEED + 12, SEED + 13))
    rules = Rules(batch=("node",), tp="local")
    out = {"plans": {}}
    _reset(kmods)
    for name, algo, chunks in PG_MOE_PLANS:
        plan = None if algo is None else _forced(autotune, algo, chunks)
        with torch.no_grad():
            (y, aux), secs = _host_timed(torch, _with_plan(
                lambda: layer(x, rules=rules, grid=grid), plan),
                PG_MOE_ITERS)
        kept = layer.ep_routing["kept"]
        rec = {"host_ms": secs * 1e3, "aux": float(aux),
               "dropped": int((~kept).sum()),
               "digests": {"y": _bits_digest(torch, y),
                           "ids": _bits_digest(torch,
                                               layer.ep_routing["ids"]),
                           "kept": _bits_digest(torch, kept)}}
        del y, aux
        if name in PG_MOE_BWD:
            layer.requires_grad_(True)
            xg = x.clone().requires_grad_()
            leaves = [layer.router, layer.w_gate, layer.w_up, layer.w_down,
                      xg]

            def fb():
                y, _ = layer(xg, rules=rules, grid=grid)
                return torch.autograd.grad((y * r).sum(), leaves)
            grads, secs = _host_timed(torch, _with_plan(fb, plan), 1)
            rec["fwd_bwd_host_ms"] = secs * 1e3
            rec["grad_digests"] = {
                n: _bits_digest(torch, g) for n, g in zip(
                    ("router", "w_gate", "w_up", "w_down", "x"), grads)}
            rec["grad_max_abs"] = {
                n: float(g.float().abs().max()) for n, g in zip(
                    ("router", "w_gate", "w_up", "w_down", "x"), grads)}
            del grads, xg, leaves
            layer.requires_grad_(False)
        out["plans"][name] = rec
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = _launches(kmods)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    del layer, x, r
    return out


def _pg_build(device):
    """The worker's communicator on a ``ProcessGrid(2, 4)`` of each
    transport, and the kernel modules: gloo handed in, ``"shm"`` the one
    the grid chooses for processes on one card (checked)."""
    import torch
    from repro_torch.core.comm import Communicator
    from repro_torch.core.grid import ProcessGrid
    from repro_torch.distributed.transport import GlooTransport
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import codec as kcodec
    from repro_torch.kernels import mamba as kmamba
    from repro_torch.kernels import rwkv as krwkv
    from repro_torch.kernels import staging as kstaging
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    comms = {"gloo": Communicator(ProcessGrid(2, 4, device,
                                              transport=GlooTransport())),
             "shm": Communicator(ProcessGrid(2, 4, device))}
    for name, comm in comms.items():
        if comm.grid.transport.name != name:
            raise AssertionError(f"the {name} grid runs over "
                                 f"{comm.grid.transport.name}")
    return comms, (kcodec, kattn, krwkv, kmamba, kstaging)


def _slot_bytes(grid):
    """The device bytes of the transport's slots (0 under gloo)."""
    return getattr(grid.transport, "slot_bytes", 0)


def pg_calibrate(torch, comm):
    """(e) ``calibrate(include_splits=True)`` of ``comm``'s grid into a
    selector of its own at ``CAL_SIZES``, lossless plans, ``CAL_ITERS``
    samples each; each row's median folded over the processes with max (a
    collective is as slow as its slowest process, as the tuning-table
    merge folds). On process 0 ``costmodel.fit_net`` of the folded rows
    and, per preset (the grid's own links, the fresh fit, ``host_ipc``),
    the cells whose prior argmin is the measured one."""
    import torch.distributed as dist
    from repro_torch.core import artifact, autotune, costmodel
    from repro_torch.core.comm import Communicator

    grid = comm.grid
    ccomm = Communicator(grid, selector=autotune.Selector())
    host0 = grid.host_bytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = ccomm.calibrate(include_splits=True, sizes=CAL_SIZES,
                           iters=CAL_ITERS, codecs=())
    seconds = time.perf_counter() - t0
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, [r.seconds for r in rows])
    rows = [dataclasses.replace(r, seconds=max(e[i] for e in every))
            for i, r in enumerate(rows)]
    out = {"rows": len(rows), "seconds": seconds,
           "host_bytes": grid.host_bytes - host0}
    if grid.rank == 0:
        fitted, report = costmodel.fit_net(_fit_samples(ccomm, rows),
                                           "h100_ipc")
        out.update({
            "link": ccomm.topo.link_names[0],
            "checked_in": dataclasses.asdict(
                costmodel.resolve_net(ccomm.topo.link_names[0])),
            "fresh_fit": {**dataclasses.asdict(fitted),
                          **{k: v for k, v in report.items()
                             if k != "rel_err"}},
            "fit_rel_err": report["rel_err"],
            "agreement": {
                "checked_in": _agreement(artifact.calibration_sections(
                    ccomm, rows)),
                "fresh_fit": _agreement(artifact.calibration_sections(
                    ccomm, rows, link=fitted)),
                "host_ipc": _agreement(artifact.calibration_sections(
                    ccomm, rows, link="host_ipc"))},
            "rows_ms": [[r.group or "root", r.collective, r.algo, r.chunks,
                         r.nbytes, r.seconds * 1e3] for r in rows]})
    return out


def process_groups_worker(total, device="cuda"):
    """A phase-15 worker of one rank (``distributed.launch.run``, eight of
    them): on its gloo grid and then on its ``"shm"`` grid, leg by leg,
    (a) every case of :func:`tp_cases` and the groups of :func:`pg_groups`,
    (b) the full-width sync step, (d) the serving run, each with its kernel
    counts zeroed just before and read just after and the payload bytes
    its transport moved through host memory; then (e), :func:`pg_calibrate`
    on the ``"shm"`` grid; the slots' bytes and the worker's peak."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import autotune
    from repro_torch.kernels import codec as kcodec
    from repro_torch.kernels import staging as kstaging

    comms, kmods = _pg_build(device)
    first = comms[PG_TRANSPORTS[0]].grid
    res = {"rank": first.rank, "held": list(first.held),
           "device": str(first.device)}
    for name, comm in comms.items():
        res[name] = {"topo_key": autotune.topo_key(comm.topo),
                     "host_bytes": {}}

    def collectives(out, comm):
        t0 = time.perf_counter()
        out["digests"], out["launched"], out["times"] = tp_collectives(
            torch, np, comm, kcodec, kstaging)
        out["groups"], out["group_launches"] = pg_groups(torch, np, comm,
                                                         kstaging)
        out["collectives_s"] = time.perf_counter() - t0
        out["collective_launches"] = _sum_launches(
            {**out["launched"], "groups": out["group_launches"]})

    def sync(out, comm):
        _reset(kmods)
        sent = comm.grid.bytes_sent
        out["sync"] = tp_sync_step(torch, comm, total)
        out["sync"]["bytes_sent"] = comm.grid.bytes_sent - sent
        out["sync"]["launches"] = {k: n for k, n in _launches(kmods).items()
                                   if n}

    def serve(out, comm):
        out["serve"] = pg_serve(torch, np, comm.grid,
                                get_config("smollm-360m"), kmods)

    for label, leg in (("collectives", collectives), ("sync", sync),
                       ("serve", serve)):
        for name, comm in comms.items():
            torch.cuda.empty_cache()
            host0 = comm.grid.host_bytes
            leg(res[name], comm)
            res[name]["host_bytes"][label] = comm.grid.host_bytes - host0
    torch.cuda.empty_cache()
    res["shm"]["calibrate"] = pg_calibrate(torch, comms["shm"])
    res["slot_bytes"] = _slot_bytes(comms["shm"].grid)
    res["peak_mem_bytes"] = (torch.cuda.max_memory_allocated(first.device)
                             + res["slot_bytes"])
    return res


def process_groups_moe_worker(device="cuda"):
    """A phase-15 worker of two ranks (four of them): leg (c),
    :func:`pg_moe` on ``ProcessGrid(2, 4)``, each node two processes, on
    the gloo grid and then on the ``"shm"`` grid; the peak with the
    slots."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import autotune

    comms, kmods = _pg_build(device)
    first = comms[PG_TRANSPORTS[0]].grid
    res = {"rank": first.rank, "held": list(first.held),
           "device": str(first.device)}
    for name, comm in comms.items():
        host0 = comm.grid.host_bytes
        t0 = time.perf_counter()
        rec = pg_moe(torch, get_config(MOE_Q_ARCH), comm.grid, kmods)
        rec["moe_s"] = time.perf_counter() - t0
        rec["host_bytes"] = comm.grid.host_bytes - host0
        rec["topo_key"] = autotune.topo_key(comm.topo)
        rec["slot_bytes"] = _slot_bytes(comm.grid)
        rec["peak_mem_bytes"] += rec["slot_bytes"]
        res[name] = rec
        gc.collect()
        torch.cuda.empty_cache()
    return res


def _pg_rows(want, held):
    """The parent's per-row digests of a call, those of the rows
    ``held``: the result's rows, then the new error's when there is one."""
    return [d for i in range(len(want) // PG_PROCS)
            for d in [want[i * PG_PROCS + h] for h in held]]


def _pg_check(workers, moe_workers, parent, groups, served, moe, sync_want,
              n_layers):
    """Every worker's every leg under each transport against the parent's
    one-process results: held rows, group calls, the sync step's digests
    and launches, the served tokens and launches, the EP layer's digests;
    the keys; under ``"shm"`` on the card no payload byte through host
    memory."""
    for w in workers:
        held = w["held"]
        for name in PG_TRANSPORTS:
            got, who = w[name], f"rank {w['rank']} ({name})"
            if got["topo_key"] != PG_KEYS[name] or held != [w["rank"]]:
                raise AssertionError(f"{who}: key {got['topo_key']}, held "
                                     f"{held}")
            if name == "shm" and w["device"].startswith("cuda") and \
                    any(got["host_bytes"].values()):
                raise AssertionError(f"{who}: host bytes "
                                     f"{got['host_bytes']}")
            for key, want in parent["digests"].items():
                if got["digests"][key] != _pg_rows(want, held):
                    raise AssertionError(f"{who}: {key} not bitwise the "
                                         f"one-process grid's")
            for key, (mine, shas) in got["groups"].items():
                pmine, pshas = groups[key]
                if shas != [pshas[i] for i in mine]:
                    raise AssertionError(f"{who}: group call {key} not "
                                         f"bitwise the one-process grid's")
            for part in ("out", "err"):
                if got["sync"][part] != [[d[h] for h in held]
                                         for d in parent["sync"][part]]:
                    raise AssertionError(f"{who}: sync {part} not bitwise "
                                         f"the one-process step's")
            if got["sync"]["launches"] != sync_want:
                raise AssertionError(f"{who}: sync step launches "
                                     f"{got['sync']['launches']}, expected "
                                     f"{sync_want}")
            sv = got["serve"]
            if sv["tokens"] != served["tokens"]:
                raise AssertionError(f"{who}: synced tokens differ from the "
                                     f"sync-free engine's")
            m = sv["metrics"]
            if m["sync_starts"] != m["ticks"] or m["plan_rebinds"]:
                raise AssertionError(f"{who}: {m['sync_starts']} sync "
                                     f"starts over {m['ticks']} ticks")
            _check_launches(f"{who} serving", sv["launches"], _with_sync(
                sv, {"flash_decode": m["ticks"] * n_layers}))
        if w["device"].startswith("cuda") and \
                w["shm"]["calibrate"]["host_bytes"]:
            raise AssertionError(f"rank {w['rank']}: the calibration moved "
                                 f"host bytes")
    # every member of every color group is held by exactly one worker
    for name in PG_TRANSPORTS:
        for key, (pmine, _) in groups.items():
            seen = sorted(i for w in workers
                          for i in w[name]["groups"].get(key, ([], None))[0])
            if seen != pmine:
                raise AssertionError(f"group call {key} ({name}): members "
                                     f"{seen}")
    for w in moe_workers:
        for name in PG_TRANSPORTS:
            got, who = w[name], f"MoE rank {w['rank']} ({name})"
            if got["topo_key"] != PG_KEYS[name] or \
                    w["held"] != [2 * w["rank"], 2 * w["rank"] + 1]:
                raise AssertionError(f"{who}: key {got['topo_key']}, held "
                                     f"{w['held']}")
            if name == "shm" and w["device"].startswith("cuda") and \
                    got["host_bytes"]:
                raise AssertionError(f"{who}: host bytes "
                                     f"{got['host_bytes']}")
            if any(got["launches"].values()):
                raise AssertionError(f"{who}: kernel launches "
                                     f"{got['launches']}")
            for plan, want in moe["plans"].items():
                mine = got["plans"][plan]
                if want["dropped"]:
                    raise AssertionError(f"{want['dropped']} routings "
                                         f"dropped at capacity {PG_MOE_CAP}")
                for k in ("digests", "grad_digests"):
                    if mine.get(k) != want.get(k):
                        raise AssertionError(f"{who}: {plan} {k} not "
                                             f"bitwise the one-process "
                                             f"grid's")
                if (mine["aux"], mine["dropped"]) != (want["aux"],
                                                      want["dropped"]):
                    raise AssertionError(f"{who}: {plan} aux or drops "
                                         f"differ")


def process_groups_phase(torch, dev, kmods, parent=None, earlier=None):
    """Phase 15: the port's process groups on the card, under both
    transports. The parent's ``RankGrid(2, 4)`` results come first
    (``parent``: phase 8's case digests and sync step, else computed here),
    with the groups, the sync-free engine's tokens and the EP layer's
    digests; the card is freed; then eight one-rank workers run (a), (b),
    (d) on a gloo and a ``"shm"`` grid and (e) on the ``"shm"`` one, and
    four workers of two ranks run (c) on both, and every held row, digest
    and token must be the parent's (:func:`_pg_check`). ``earlier``:
    phase 4's and phase 8's records, written beside this phase's numbers.
    Returns the ``{"process_groups": ...}`` record and each path's launches
    summed over the workers (``pg_<leg>`` under gloo, ``pg_<leg>_shm``)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.comm import Communicator
    from repro_torch.core.grid import RankGrid
    from repro_torch.distributed import launch
    from repro_torch.models.params import param_shapes

    kcodec, kattn, _, _, kstaging = kmods
    smollm = get_config("smollm-360m")
    total = sum(int(torch.Size(s).numel()) for _, s in param_shapes(smollm))
    comm = Communicator(RankGrid(2, 4, dev))
    t0 = time.perf_counter()
    if parent is None:
        digests, launched, times = tp_collectives(torch, np, comm, kcodec,
                                                  kstaging)
        parent = {"digests": digests, "times": times,
                  "sync": tp_sync_step(torch, comm, total)}
    groups, _ = pg_groups(torch, np, comm, kstaging)
    torch.cuda.empty_cache()
    served = pg_serve(torch, np, None, smollm, kmods)
    gc.collect()
    torch.cuda.empty_cache()
    moe = pg_moe(torch, get_config(MOE_Q_ARCH), comm.grid, kmods)
    parent_s = time.perf_counter() - t0
    del comm
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    workers = launch.run(process_groups_worker, total, str(dev),
                         processes=PG_PROCS, ranks_per_process=1,
                         timeout=PG_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    moe_workers = launch.run(process_groups_moe_worker, str(dev),
                             processes=PG_MOE_PROCS, ranks_per_process=2,
                             timeout=PG_TIMEOUT)
    moe_spawn_s = time.perf_counter() - t0

    encodes, decode = CODEC_KERNELS[TP_CODEC]
    sync_want = {**{k: 2 * parent["sync"]["buckets"] for k in encodes},
                 decode: parent["sync"]["buckets"]}
    _pg_check(workers, moe_workers, parent, groups, served, moe, sync_want,
              smollm.n_layers)

    def paths(counts_list):
        total_ = {}
        for c in counts_list:
            for k, n in c.items():
                total_[k] = total_.get(k, 0) + n
        return total_
    on_paths = {}
    for name in PG_TRANSPORTS:
        tag = "" if name == "gloo" else f"_{name}"
        on_paths.update({
            f"pg_collectives{tag}": paths(w[name]["collective_launches"]
                                          for w in workers),
            f"pg_sync{tag}": paths(w[name]["sync"]["launches"]
                                   for w in workers),
            f"pg_serve{tag}": paths(w[name]["serve"]["launches"]
                                    for w in workers),
            f"pg_moe{tag}": paths(w[name]["launches"] for w in moe_workers)})
        if not on_paths[f"pg_serve{tag}"].get("flash_decode") or not any(
                on_paths[f"pg_collectives{tag}"].get(k)
                for k in STAGING_NAMES):
            raise AssertionError(f"phase 15 launches {on_paths}")
    earlier = earlier or {}
    two = {p["plan"]: p for p in earlier.get("two_process", {}).get(
        "plans", [])}
    serve4 = earlier.get("serve", {})

    def each(fn):
        return {name: [fn(w[name]) for w in workers]
                for name in PG_TRANSPORTS}
    rec = {"card": _smi("name,power.limit"), "topo_keys": PG_KEYS,
           "workers": {"collectives_sync_serve": [PG_PROCS, 1],
                       "moe": [PG_MOE_PROCS, 2]},
           "parent_s": parent_s, "spawn_s": spawn_s,
           "moe_spawn_s": moe_spawn_s,
           "cases": len(parent["digests"]), "group_calls": len(groups),
           "worker_collectives_s": each(lambda r: r["collectives_s"]),
           "host_bytes": each(lambda r: r["host_bytes"]),
           "slot_bytes_per_worker": [w["slot_bytes"] for w in workers],
           "peak_mem_bytes_per_worker": [w["peak_mem_bytes"]
                                         for w in workers],
           "plans": [{"plan": key, "one_process_ms": t["ms"],
                      "two_process_ms": two.get(key, {}).get(
                          "two_process_ms", "not measured in this run"),
                      "eight_process_ms": each(
                          lambda r: r["times"][key]["ms"]),
                      "bytes_sent_per_call": [
                          w["gloo"]["times"][key]["bytes_sent_per_call"]
                          for w in workers]}
                     for key, t in parent["times"].items()],
           "sync": {"buckets": parent["sync"]["buckets"],
                    "one_process_s": parent["sync"]["seconds"],
                    "eight_process_s": each(lambda r: r["sync"]["seconds"]),
                    "bytes_sent": [w["gloo"]["sync"]["bytes_sent"]
                                   for w in workers],
                    "launches_per_worker": sync_want},
           "moe": {"tokens": list(MOE_TOKENS), "capacity_factor": PG_MOE_CAP,
                   "dropped": 0,
                   "plans": {plan: {
                       "one_process_host_ms": want["host_ms"],
                       "four_process_host_ms": {
                           name: [w[name]["plans"][plan]["host_ms"]
                                  for w in moe_workers]
                           for name in PG_TRANSPORTS},
                       "one_process_fwd_bwd_ms": want.get("fwd_bwd_host_ms"),
                       "four_process_fwd_bwd_ms": {
                           name: [w[name]["plans"][plan].get(
                               "fwd_bwd_host_ms") for w in moe_workers]
                           for name in PG_TRANSPORTS},
                       "aux": want["aux"],
                       "grad_max_abs": want.get("grad_max_abs"),
                       "bitwise": True}
                       for plan, want in moe["plans"].items()},
                   "backward_plans": list(PG_MOE_BWD),
                   "peak_mem_bytes_one_process": moe["peak_mem_bytes"],
                   "peak_mem_bytes_per_worker": {
                       name: [w[name]["peak_mem_bytes"] for w in moe_workers]
                       for name in PG_TRANSPORTS},
                   "slot_bytes_per_worker": [w["shm"]["slot_bytes"]
                                             for w in moe_workers],
                   "host_bytes": {name: [w[name]["host_bytes"]
                                         for w in moe_workers]
                                  for name in PG_TRANSPORTS},
                   "worker_s": {name: [w[name]["moe_s"] for w in moe_workers]
                                for name in PG_TRANSPORTS}},
           "serve": {"sync_plan": each(lambda r: r["serve"]["sync_plan"]),
                     "ticks": workers[0]["gloo"]["serve"]["metrics"]["ticks"],
                     "sync_free": {k: served[k] for k in (
                         "decode_tick_s", "tokens_per_s", "wall_s")},
                     "phase4": {k: serve4.get(k, "not measured in this run")
                                for k in ("decode_tick_s", "tokens_per_s")},
                     "tick_s": each(lambda r: r["serve"]["decode_tick_s"]),
                     "tokens_per_s": each(
                         lambda r: r["serve"]["tokens_per_s"]),
                     "sync_launches": each(
                         lambda r: r["serve"]["sync_launches"])},
           "calibrate": {
               "seconds": [w["shm"]["calibrate"]["seconds"]
                           for w in workers],
               **{k: v for k, v in workers[0]["shm"]["calibrate"].items()
                  if k != "seconds"}},
           "launches_by_path": on_paths}
    return rec, on_paths


def _counter_keys(name):
    """The launch counters behind one ``{"kernels": ...}`` entry."""
    for c, codec in (("int8", "int8_block"), ("int4", "int4_block"),
                     ("fp8", "fp8_sim")):
        encodes, decode = CODEC_KERNELS[codec]
        if name == f"{c}_encode_feedback":
            return FEEDBACK_KERNELS[codec]
        if name == f"{c}_encode_residual":
            return encodes
        if name == f"{c}_decode_reduce":
            return (decode,)
    if name == "rwkv6_wkv":  # the recurrent kernel sits behind it too
        return (name, "rwkv6_wkv_recurrent")
    return (name,)


def kernel_lines(kernels, on_train, on_tree, on_sharded, on_roofline):
    """The ``{"kernels": [...]}`` entries, one per TPU kernel of the
    repository, in the order of PERF.md's table: each codec's feedback
    encode (the HAS_ERR variant of its encode kernel, timed in phase 1;
    its launches counted apart in the slice phase, where the compressed
    allreduce encodes without feedback; the int8 one launched by the train
    phase's direct ``compress_tree`` call, which no train step makes), its
    residual encode and its decode-reduce, then the staging, flash-decode,
    scan and WKV6 kernels (the tick kernel for the tick, the chunked one
    for the prefill). ``on_train``: each counter's launches over the train
    steps (``launches_by_path["train"]`` of every entry); ``on_tree``: over
    the ``compress_tree`` call (the feedback encodes'
    ``launches_by_path["compress_tree"]``); ``on_sharded``: phase 13's
    paths' launches (``ep_backward``, ``sharded_train`` and
    ``train_driver`` in every entry's ``launches_by_path``, all 0);
    ``on_roofline``: phase 14's paths' launches (``roofline_train``, the
    two ``roofline_<kernel>`` serving ticks and the ``example_<name>``
    runs) and phase 15's, summed over its workers (``pg_collectives``,
    ``pg_sync``, ``pg_moe``, ``pg_serve``), in every entry's
    ``launches_by_path``."""
    out = []
    for c, encode in (("int8", "int8_block_encode"),
                      ("int4", "int4_block_encode"), ("fp8", "fp8_encode")):
        rec = kernels[encode]
        fb_train = on_train.get(encode + "_feedback", 0)
        fb_tree = on_tree.get(encode + "_feedback", 0)
        out.append({
            "name": f"{c}_encode_feedback", "route": "cuda",
            "cuda_kernel": rec["cuda_kernel"] + ", HAS_ERR",
            "source": rec["source"],
            "replaces": f"src/repro/kernels/codec.py:{FEEDBACK_LINES[c]}",
            "launches": rec["feedback_launches"] + fb_train + fb_tree,
            "launches_by_cuda_kernel": {
                k: n + on_train.get(k, 0) + on_tree.get(k, 0)
                for k, n in rec["feedback_launches_by_cuda_kernel"].items()},
            "launches_by_path": {"slice": rec["feedback_launches"],
                                 "compress_tree": fb_tree,
                                 "train": fb_train},
            "max_abs_err": rec["max_abs_err"], "ms": rec["feedback_ms"],
            "kernel_cupti_ms": rec["feedback_kernel_cupti_ms"],
            "event_floor_ms": rec["event_floor_ms"],
            "plain_ms": rec["feedback_plain_ms"],
            "bound_ms": rec["feedback_bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shape": rec["shape"]})
        if "parent" in rec:
            out[-1]["parent"] = {k[len("feedback_"):]: v for k, v in
                                 rec["parent"].items()
                                 if k.startswith("feedback_")}
        residual = {k: v for k, v in rec.items()
                    if not k.startswith("feedback_")}
        if "parent" in rec:
            residual["parent"] = {k: v for k, v in rec["parent"].items()
                                  if not k.startswith("feedback_")}
        residual["launches_by_path"] = dict(
            rec.get("launches_by_path", {}), train=on_train.get(encode, 0))
        out.append({**residual, "name": f"{c}_encode_residual"})
        out.append(kernels[f"{c}_decode_reduce"])
        out[-1]["launches_by_path"] = dict(
            out[-1].get("launches_by_path", {}),
            train=on_train.get(f"{c}_decode_reduce", 0))
    for k in ("shift_blocks", "pack_blocks", "flash_decode", "mamba_scan",
              "rwkv6_wkv", "rwkv6_wkv_chunked"):
        rec = kernels[k]
        rec["launches_by_path"] = dict(rec.get("launches_by_path", {}),
                                       train=on_train.get(k, 0))
        out.append(rec)
    for rec in out:
        keys = _counter_keys(rec["name"])
        for path, counts in on_sharded.items():
            n = sum(counts.get(k, 0) for k in keys)
            if n:
                raise AssertionError(f"{rec['name']}: {n} launches on the "
                                     f"{path} path")
            rec["launches_by_path"][path] = n
        for path, counts in on_roofline.items():
            rec["launches_by_path"][path] = sum(counts.get(k, 0)
                                                for k in keys)
    return out


def main(argv=None) -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description="the port's smoke test on one "
                                 "GPU")
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit: its codec "
                    "encodes are built outside the repository, held bitwise "
                    "to this tree's and timed beside them in phase 1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this smoke test "
                    "runs on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import first_layers, get_config
        from repro_torch.kernels import _build, ref
        from repro_torch.kernels import adamw as kadamw
        from repro_torch.kernels import attention as kattn
        from repro_torch.kernels import codec as kcodec
        from repro_torch.kernels import mamba as kmamba
        from repro_torch.kernels import rwkv as krwkv
        from repro_torch.kernels import staging as kstaging
    except ImportError as e:
        return fail(f"the port's sources are missing ({e}); run from the "
                    f"repository root")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smollm, rwkv6 = get_config("smollm-360m"), get_config("rwkv6-1.6b")
    jamba = first_layers(get_config(JAMBA_ARCH), JAMBA_LAYERS)
    kmods = (kcodec, kattn, krwkv, kmamba, kstaging)
    sm_mhz = float(_smi("clocks.max.sm", "nounits"))

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.3f} s")
    for lib in libs:
        print(f"  {lib.relative_to(ROOT)}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("    " + line.strip())

    parent = parent_libraries(args.parent) if args.parent else None
    kernels = kernel_phase(torch, kcodec, ref, dev, parent=parent)
    print("kernel phase: all six codec kernels bitwise equal to their plain "
          "versions")
    for name in ENCODE_NAMES.values():
        print("kernel " + json.dumps(kernels[name]))
    kernels["flash_decode"] = flash_phase(torch, kattn, ref, dev)
    print(f"kernel phase: flash_decode within {FLASH_TOL} * (1 + |plain|) "
          f"of its plain version in "
          f"{kernels['flash_decode']['cases_checked']} cases "
          f"({time.perf_counter() - t0:.3f} s so far)")
    kernels.update(rwkv_phase(torch, krwkv, ref, dev))
    print(f"kernel phase: rwkv6_wkv (tick kernel), its recurrent kernel "
          f"and rwkv6_wkv_chunked within "
          f"{RWKV_TOL} * (1 + |plain|) of their plain version in "
          f"{kernels['rwkv6_wkv']['cases_checked']}, "
          f"{kernels['rwkv6_wkv']['recurrent']['cases_checked']} and "
          f"{kernels['rwkv6_wkv_chunked']['cases_checked']} cases "
          f"({time.perf_counter() - t0:.3f} s so far)")
    kernels["mamba_scan"] = mamba_phase(torch, kmamba, ref, dev, sm_mhz)
    print(f"kernel phase: mamba_scan within {MAMBA_TOL} * (1 + |plain|) of "
          f"its plain version in {kernels['mamba_scan']['cases_checked']} "
          f"cases ({time.perf_counter() - t0:.3f} s so far)")
    kernels.update(staging_phase(torch, kstaging, ref, dev))
    print(f"kernel phase: shift_blocks and pack_blocks bitwise equal to "
          f"their plain versions in "
          f"{kernels['shift_blocks']['cases_checked']} and "
          f"{kernels['pack_blocks']['cases_checked']} cases "
          f"({time.perf_counter() - t0:.3f} s so far)")
    adamw_rec = adamw_phase(torch, kadamw, ref, dev)
    print(f"kernel phase: adamw_update bitwise equal to the plain passes in "
          f"{adamw_rec['cases_checked']} cases "
          f"({time.perf_counter() - t0:.3f} s so far)")
    for name in ("flash_decode", "rwkv6_wkv", "rwkv6_wkv_chunked",
                 "mamba_scan", "shift_blocks", "pack_blocks"):
        print("kernel " + json.dumps(kernels[name]))
    print("kernel " + json.dumps(adamw_rec))
    summary = slice_phase(torch, dev, smollm, kcodec, kstaging)
    for run in summary["syncs"]:
        per_launch = run["profile"].get("per_launch_ms", {})
        encodes, decode = CODEC_KERNELS[run["codec"]]
        rec = kernels[encodes[-1]]
        rec["launches"] = run["launches"][encodes[-1]]
        rec["launches_by_cuda_kernel"] = {k: run["launches"][k]
                                          for k in encodes}
        rec["path_ms"] = {k: per_launch.get(k, "not measured")
                          for k in encodes} if len(encodes) > 1 \
            else per_launch.get(encodes[0], "not measured")
        fb = run["feedback_launches"]
        rec["feedback_launches"] = fb[FEEDBACK_KERNELS[run["codec"]][-1]]
        rec["feedback_launches_by_cuda_kernel"] = fb
        kernels[decode]["launches"] = run["launches"][decode]
        kernels[decode]["path_ms"] = per_launch.get(decode, "not measured")
    for run in summary["reduce_scatter"]:
        dec = CODEC_KERNELS[run["codec"]][1]
        kernels[dec]["reduce_scatter_launches"] = run["launches"][dec]
        kernels[dec]["reduce_scatter_path_ms"] = (
            run["profile"].get("per_launch_ms") or {}).get(
                dec, "not measured")
    print(json.dumps({"slice": summary}))
    print(f"slice phase done ({time.perf_counter() - t0:.3f} s so far)")
    coll = collectives_phase(torch, dev, kstaging)
    print(json.dumps({"collectives": {k: v for k, v in coll.items()
                                      if k != "rows"}}))
    print(f"collectives phase done ({time.perf_counter() - t0:.3f} s so "
          f"far)")
    staged = {"collectives": coll["staging_launches"]}
    for name, kname in zip(STAGING_NAMES, STAGING_KERNELS):
        if not coll["staging_launches"][name]:
            raise AssertionError(f"{name}: no launch in the collectives "
                                 f"phase")
        rec = kernels[name]
        rec["launches"] = coll["staging_launches"][name]
        rec["path_ms"] = {
            f"pip_mcoll allgather {nb} B per rank": prof.get(
                "per_launch_ms", {}).get(kname, "not measured")
            for nb, prof in coll["allgather_profiles"].items()}
    serve = serve_phase(torch, dev, smollm, kattn, ref, kmods)
    kernels["flash_decode"]["launches"] = serve["flash_launches"]
    kernels["flash_decode"]["path_ms"] = serve["profile"].get(
        "per_launch_ms", {}).get("flash_decode", "not measured")
    kernels["flash_decode"]["path_bound_ms"] = serve["flash_path_bound_ms"]
    staged["serve_smollm"] = _staged(serve)
    serve4 = {k: serve[k] for k in ("decode_tick_s", "tokens_per_s")}
    print(json.dumps({"serve": serve}))
    print(f"serving phase done ({time.perf_counter() - t0:.3f} s so far)")
    serve = rwkv_serve_phase(torch, dev, rwkv6, krwkv, ref, kmods)
    rec = kernels["rwkv6_wkv"]
    rec["launches"] = serve["rwkv_launches"]
    rec["path_ms"] = serve["profile"].get("per_launch_ms", {}).get(
        TICK_KERNEL, "not measured")
    rec["path_bound_ms"] = serve["rwkv_path_bound_ms"]
    rec = kernels["rwkv6_wkv_chunked"]
    rec["launches"] = serve["rwkv_chunked_launches"]
    rec["path_ms"] = {name: serve["prefill_profile"].get(
        "per_launch_ms", {}).get(name, "not measured")
        for name in CHUNKED_PASSES}
    rec["path_bound_ms"] = serve["rwkv_prefill_path_bound_ms"]
    staged["serve_rwkv"] = _staged(serve)
    print(json.dumps({"serve_rwkv": serve}))
    print(f"rwkv serving phase done ({time.perf_counter() - t0:.3f} s so "
          f"far)")
    del serve
    serve = jamba_serve_phase(torch, dev, jamba, kattn, kmamba, ref, kmods)
    rec = kernels["mamba_scan"]
    rec["launches"] = serve["mamba_launches"]
    rec["path_ms"] = serve["profile"].get("per_launch_ms", {}).get(
        "mamba_scan", "not measured")
    rec["path_bound_ms"] = scan_bound(*serve["mamba_path_work"], sm_mhz)[0]
    rec["prefill"]["path_ms"] = serve["prefill_profile"].get(
        "per_launch_ms", {}).get("mamba_scan", "not measured")
    rec["prefill"]["path_bound_ms"] = scan_bound(
        *serve["mamba_prefill_path_work"], sm_mhz)[0]
    flash = kernels["flash_decode"]
    flash["launches_by_path"] = {"serve_smollm": flash["launches"],
                                 "serve_jamba": serve["flash_launches"]}
    flash["jamba_shape"]["path_ms"] = serve["profile"].get(
        "per_launch_ms", {}).get("flash_decode", "not measured")
    staged["serve_jamba"] = _staged(serve)
    print(json.dumps({"serve_jamba": serve}))
    print(f"jamba serving phase done ({time.perf_counter() - t0:.3f} s so "
          f"far)")
    del serve
    gc.collect()  # the jamba model
    torch.cuda.empty_cache()
    cal = calibrate_phase(torch, dev)
    print(json.dumps({"calibrate": cal}))
    print(f"calibration phase done ({time.perf_counter() - t0:.3f} s in "
          f"all)")
    for name, kname in zip(STAGING_NAMES, STAGING_KERNELS):
        kernels[name]["launches_by_path"] = {
            path: launches.get(name, 0) for path, launches in staged.items()}
        kernels[name]["tick_path_ms"] = {
            path: launches["tick_path_ms"][kname]
            for path, launches in staged.items() if path != "collectives"}
    gc.collect()
    torch.cuda.empty_cache()
    tp_parent = {}
    two = two_process_phase(torch, dev, smollm, kcodec, kstaging,
                            keep=tp_parent)
    print(json.dumps({"two_process": two}))
    print(f"two-process phase done ({time.perf_counter() - t0:.3f} s in "
          f"all)")
    on_two = {}  # each kernel's launches on both workers, all legs
    for counts in two["launches"] + two["sync"]["launches"]:
        for k, n in counts.items():
            on_two[k] = on_two.get(k, 0) + n
    for name in STAGING_NAMES:
        kernels[name]["launches_by_path"]["two_process"] = on_two.get(name,
                                                                      0)
    for codec, _ in SYNC_CODECS:
        encodes, decode = CODEC_KERNELS[codec]
        for key, counted in ((encodes[-1], encodes[-1]), (decode, decode)):
            rec = kernels[key]
            rec["launches_by_path"] = {"slice": rec["launches"],
                                       "two_process": on_two.get(counted, 0)}
            if not on_two.get(counted):
                raise AssertionError(f"{counted}: no launch on the "
                                     f"two-process path")

    gc.collect()
    torch.cuda.empty_cache()
    kadamw.reset_launches()
    train, on_train, on_tree = train_phase(torch, dev, smollm, kmods)
    adamw_paths = {"train": kadamw.launches["adamw_update"]}
    print(json.dumps({"train": train}))
    print(f"train phase done ({time.perf_counter() - t0:.3f} s in all)")
    for name in ("flash_decode", "mamba_scan", "rwkv6_wkv",
                 "rwkv6_wkv_recurrent", "rwkv6_wkv_chunked",
                 "int8_block_encode_feedback"):
        if on_train.get(name):
            raise AssertionError(f"{name}: launched on the train path")

    gc.collect()
    torch.cuda.empty_cache()
    moe = moe_phase(torch, dev, kattn, ref, kmods)
    print(f"moe phase done ({time.perf_counter() - t0:.3f} s in all)")
    flash = kernels["flash_decode"]
    flash["max_abs_err"] = max(flash["max_abs_err"],
                               moe["flash"]["max_abs_err"])
    flash["cases_checked"] += moe["flash"]["cases_checked"]
    flash["wide_groups"] = {k: v for k, v in moe["flash"].items()
                            if k != "qwen3_moe_shape"}
    flash["qwen3_moe_shape"] = dict(
        moe["flash"]["qwen3_moe_shape"],
        path_ms=moe["serve"]["serve_qwen3_moe"]["path_ms"])
    flash["arctic_path_ms"] = moe["serve"]["serve_arctic"]["path_ms"]
    for key, rec in moe["serve"].items():
        flash["launches_by_path"][key] = rec["flash_launches"]
        if not rec["flash_launches"]:
            raise AssertionError(f"flash_decode: no launch on {key}")
    for name, kname in zip(STAGING_NAMES, STAGING_KERNELS):
        paths = kernels[name]["launches_by_path"]
        paths["moe_ep"] = moe["ep_staging"][name]
        for key, rec in moe["serve"].items():
            paths[key] = rec["staged"][name]
            kernels[name]["tick_path_ms"][key] = \
                rec["staged"]["tick_path_ms"][kname]
    del moe

    gc.collect()
    torch.cuda.empty_cache()
    fam = families_phase(torch, dev, kattn, ref, kmods)
    print(f"families phase done ({time.perf_counter() - t0:.3f} s in all)")
    flash["max_abs_err"] = max(flash["max_abs_err"],
                               fam["flash"]["max_abs_err"])
    flash["cases_checked"] += fam["flash"]["cases_checked"]
    flash["phase11_shapes"] = fam["flash"]["shapes"]
    flash["phase11_splits"] = fam["flash"]["splits"]
    flash["phase11_path_ms"] = {}
    for key, rec in fam["paths"].items():
        flash["launches_by_path"][key] = rec["flash_launches"]
        if not rec["flash_launches"]:
            raise AssertionError(f"flash_decode: no launch on {key}")
        if "path_ms" in rec:
            flash["phase11_path_ms"][key] = rec["path_ms"]
        if "staged" in rec:
            for name, kname in zip(STAGING_NAMES, STAGING_KERNELS):
                kernels[name]["launches_by_path"][key] = \
                    rec["staged"][name]
                kernels[name]["tick_path_ms"][key] = \
                    rec["staged"]["tick_path_ms"][kname]

    gc.collect()
    torch.cuda.empty_cache()
    kadamw.reset_launches()
    sharded = sharded_train_phase(torch, dev, kmods)
    adamw_paths["sharded_train"] = kadamw.launches["adamw_update"]
    print(f"sharded-training phase done ({time.perf_counter() - t0:.3f} s "
          f"in all)")

    gc.collect()
    torch.cuda.empty_cache()
    kadamw.reset_launches()
    roof = roofline_phase(torch, dev, kmods)
    adamw_paths["roofline"] = kadamw.launches["adamw_update"]
    for path, n in adamw_paths.items():
        if not n:
            raise AssertionError(f"adamw_update: no launch on the {path} "
                                 f"path")
    adamw_rec["launches"] = sum(adamw_paths.values())
    adamw_rec["launches_by_path"] = adamw_paths
    print(f"roofline phase done ({time.perf_counter() - t0:.3f} s in all)")
    for path, want in (("roofline_train", None),
                       ("roofline_flash_decode", "flash_decode"),
                       ("roofline_rwkv6_wkv", "rwkv6_wkv")):
        extra = {k: n for k, n in roof[path].items() if n and k != want}
        if extra or (want and not roof[path].get(want)):
            raise AssertionError(f"{path}: launches {roof[path]}")

    gc.collect()
    torch.cuda.empty_cache()
    groups, on_groups = process_groups_phase(
        torch, dev, kmods, parent=tp_parent,
        earlier={"two_process": two, "serve": serve4})
    print(json.dumps({"process_groups": groups}))
    print(f"process-groups phase done ({time.perf_counter() - t0:.3f} s in "
          f"all)")

    print(_smi("name,power.limit"))
    print(json.dumps({"kernels": kernel_lines(kernels, on_train, on_tree,
                                              sharded, {**roof,
                                                        **on_groups})
                      + [adamw_rec]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
