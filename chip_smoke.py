#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # needs one CUDA card
    python3 chip_smoke.py --gloo-probe   # only gloo's refusals on CUDA

Builds both hand-written kernels from ``src/repro_torch/csrc`` and runs
these phases, each printing one JSON line.  They run in the order 1, 17,
18, 9b's training, 16, then 2-15 and 19: the phases that launch neither
kernel use the card while the kernels build (``EARLY``).

1. env — GPU name and power limit, torch/CUDA versions, kernel build time
   (both sources compiled in parallel, in the background of the EARLY
   phases; the line is printed once the build is done, with the seconds
   the phases after it waited for it).
2. kv_quant — the bulk kernel against its plain PyTorch version at the
   decode shapes (128 rows; and the GQA smoke planes), edge-case rows
   included, and at one layer of the longest prompt's prefill (91,744 rows
   x 128 bf16, K 2-bit and V 1.5-bit, per-head clip factors): 0 differing
   bytes allowed.  L2-cold device times of both, the byte bound and its
   share.
2b. kv_append — the fused decode append (one launch per layer) against
   its plain version (``kv_cache.decode_append``) for 300 steps from
   identical caches, at the serve shape (4 slots x 32 heads x 128,
   PAPER_POLICY, max_len 4229) and the GQA shape (Hkv 8, D 64, group 64),
   striped and pooled (256 blocks of 16 per slot over a seeded
   permutation); slots pass through the sinks, the window's filling,
   eviction and past the capacity, one row with ``valid`` False on some
   steps: every leaf byte-equal after every step (pool block 0 excluded).
   Kernel µs per launch (L2-cold) against its byte bound, the plain
   append's device time (CUDA events) and host wall time per call, and one
   CUDA-graph capture and replay byte-equal to eager launches.
3. decode_attn — the split kernel against its plain version (f32, atol
   3e-5 / rtol 1e-4 on the normalized output, m and l) at the serve shape,
   the GQA shape and one 131072-token slot (131000 live); pruned walk and
   a second launch bitwise equal to the first; times, bound and its share,
   and scaled_dot_product_attention over the same tokens dequantized to
   bf16 as a yardstick.
4. decode_attn_pooled — the kernel's block-table mode (DESIGN.md §9) at
   the serve shape (4 slots x 256 pool blocks of 16 tokens, a seeded
   permutation of physical blocks, two slots sharing entries) and at one
   131072-token slot (8192 blocks), each against its plain version (same
   tolerance), bitwise equal to the striped kernel over the gathered
   planes, pruned walk bitwise equal to the full walk; times, bound, and
   SDPA over the gathered tokens.

Kernel and yardstick times are device times (a sleep kernel holds the
stream while the calls are queued) of launches rotating over 4 copies of
the inputs, so that decode_attn reads its planes from device memory and
not from the 50 MB L2, as each layer of a decode step does.
5. serve — the port's Engine at full llama2-7b width (random bf16 weights
   from a seed), PAPER_POLICY, max_len 4229 (a packed region of 4096
   tokens = 256 pool blocks of 16), 8 greedy requests in two admission
   waves on 4 slots; asserts every request finishes, one kv_append launch
   per layer per decode step, two bulk kv_quant launches per layer per
   prefill, zero plain-version calls, and cuda-vs-reference backend logits
   on one step.  Decode step time comes from the Engine's own decode
   chunks (each one ends in a host copy) and from CUDA-event times of
   single steps, each with its spread.
6. serve_pooled — (a) the same 8 requests at 18 new tokens (across one
   sync) through a pooled Engine (768 blocks of 16 tokens): every token
   stream the first 18 of the serve phase's; (b) shared-prefix traffic, 8 requests with one 2048-token
   prefix and suffixes of 128..1024 tokens, 512 blocks: every request
   finishes, prefix hit rate > 0, peak resident packed bytes under half
   the striped worst case, a clean pool audit.  Both runs attend through
   the block-table kernel only (no striped or plain decode_attn call).
7. serve_graph — the serving harness of DESIGN.md §10 at the same width,
   policy, slots, steps per sync and max_len: (a) the serve phase's 8
   requests through a warmed striped Engine, then a warmed pooled one
   (768 blocks), each decode step a replay of the CUDA graph warmup
   captured: every stream bitwise equal to the eager serve phase's, the
   launch identities with graphs on, no post-warmup graph miss; (b) ms per
   step from the warmed Engine's own chunks; at 4 x 2048, whole Engine
   chunks striped and pooled, both replayed, in ABBA turns; (c) the
   device busy share of a replay window and its device time by kind of
   kernel (torch.profiler; if it shows no kernel under replay, the busy
   share is not measured); (d) an
   open-loop Poisson trace (8 requests at 2 req/s, prompts 512-3000, half
   sharing a 256-token prefix) through ``run_open_loop`` on a warmed pooled
   Engine with the async host loop: no post-warmup miss, every request
   finished, the launch identities, a clean pool audit; TTFT/TPOT
   percentiles and SLA attainment printed for information; (e) the warmup
   report (kernel load, capture and rehearsal seconds, graph count).
8. serve_chunked — chunked prefill (DESIGN.md §7) at the same width,
   policy, slots and max_len, ``prefill_chunk`` 512: (a) one layer's
   chunk append (32 heads x 128, bf16) for a 3000-token prompt in chunks
   of 512 (the tail of 440 padded to 512) through ``kv_append_chunk``, its
   plain token loop and a ``kv_append`` loop: every leaf byte-equal after
   every chunk, two bulk launches per evicting chunk; L2-cold device ms
   of one chunk append against its byte bound; (b) the serve phase's 8
   requests through warmed chunked engines, striped then pooled (768
   blocks): every request finished, no graph miss, bulk kv_quant launches
   == 2 x layers x evicting chunks (computed from the prompts), kv_append
   launches == layers x decode steps, no plain call, pooled streams equal
   to striped, final-chunk logits within relative L2 0.05 of the serve
   phase's whole-prompt logits (top-1 agreement and stream equality
   reported, not gated); the 3000-token prefill timed whole and chunked
   in ABBA turns; (c) serve_graph (d)'s open-loop trace on a warmed
   pooled async chunked engine, with the launch identities; TTFT/TPOT
   percentiles reported beside serve_graph (d)'s whole-prompt ones, not
   gated.
9. calibrate — offline calibration (paper Sec. 3.1) at llama2-7b's width
   while its weights are loaded: (a) ``collect_kv`` over 8 prompts of 512
   tokens (``SyntheticCorpus(vocab, seed=0)``, rngs 100-107: 4096
   samples a layer), then ``calibrate_model`` on the kernel route: the
   seconds of collection, of the host's statistics and k-means, and of
   the device's clip search; exactly 2 x 11 x 32 bulk kv_quant launches
   and no other call; layers 0 and 31 through the plain route on the card
   with equal permutations and bitwise-equal clip factors; layer 0's
   table on the CPU and the clip-factor histogram (reported);
   one clip-search launch (131,072 rows x 128 f32, one shared clip
   factor) byte-equal to its plain version, L2-cold ms and byte bound;
   (b) the serve phase's 8 requests through warmed striped and pooled
   engines serving the table: every request finished, pooled streams
   equal striped, 0 graph misses, the launch identities, no plain call,
   cuda-vs-reference logits of one step at 4 x 2048 within relative L2
   0.05; (c) reported: the relative MSE of each layer's cache read back
   (``materialize_kv``) against the fp K/V in the same channel order for
   one 2048-token prompt, identity against calibrated, and one decode
   step's logits against FP16_POLICY both ways; (d) replayed steps at
   4 x 2048, calibrated against identity in ABBA turns; (e)
   ``fuse_v_permutation``: fused weights with an identity perm_v against
   the unfused ones with the calibrated perm_v, prefill logits within
   relative L2 0.05 (gated), one decode step's (reported); (f) the
   quality path's proxy perplexity (``quality.common.forward_with_method``)
   at full width on the phase's weights and table: one 2048-token
   ``SyntheticCorpus`` prompt under PAPER_POLICY for fp16, rtn, kivi and
   skvq, each through the kernel route (2 bulk kv_quant launches a layer
   for a quantizing method, none for fp16, no plain quantizer call:
   gated) with logits bitwise equal to the same forward through the plain
   quantizer on the card (gated); KIVI's 2048-token key rows cut into
   256-channel rows byte-equal to the plain quantizer in one launch, and a
   1.5-bit row of that width refused (gated), its L2-cold ms against the
   byte bound; ppl (random weights), seconds and peak memory reported.
9b. quality — the paper's accuracy evaluation (``repro_torch.quality``):
   the studies' stand-in (2 layers, d 128) trained 300 steps on the card
   into a temporary directory (with the EARLY phases), then Tables 1/5 with the schedule sweep
   (``quality_ladder``) and Table 3 (``component_ablation``) on the
   kernel route (the bulk launches worked out from the studies' code, no
   plain quantizer call: gated), every ppl equal to the same studies
   through the plain quantizer on the card (gated), ``sched_uniform``
   within 1e-6 of ``skvq`` (gated); the rows with ``holds=`` and the CPU
   route's relative ppl gaps from the same checkpoint (reported).
10. serve_schedule — per-layer policy schedules (DESIGN.md §8): (a) both
   kernels at the widths of the bits ladder, new on the card: the bulk
   kv_quant at K 4-bit and V 2-bit (128 and 91,744 rows; 0 differing
   bytes), kv_append at (4, 4) and (2, 2) for 300 steps in both layouts
   (byte-equal, graph replay included), decode_attn at (4, 4) and (2, 2)
   striped and pooled at the serve shape (f32 tolerance; times, bound,
   SDPA); (b) first_last_fp16(PAPER_POLICY, 2) and the ladder ((4,4),
   (2,2), (2,1.5)) with the serve phase's 8 requests through warmed
   striped, pooled (768 blocks, one pool per quantized band) and chunked
   (512) engines and an eager first wave: pooled streams == striped,
   replayed == eager, final-chunk logits within relative L2 0.05 of
   whole-prompt, 0 graph misses, the launch identities over the quantized
   layers (28 and 32) with the fp16 route on exactly the guard layers, no
   plain call; cuda-vs-reference logits of one step at 4 x 2048
   (relative L2 gated, top-1 agreement reported); (c) a uniform schedule's
   streams bitwise the bare policy's; (d) every striped engine's cache
   bytes by band equal to ``schedule_cache_nbytes``, beside bf16 and the
   peak; the replayed step of each schedule at 4 x 2048 in ABBA turns
   against uniform; (e) granite_8b at full width (36 layers, Hkv 8, Gq 4,
   D 128; llama2-7b's weights freed first): 4 requests through a warmed
   engine with the launch identities, cuda-vs-reference logits, and
   decode_attn at that shape against its plain version and SDPA.
11. serve_degrade — the degradation ladder and fault model (DESIGN.md
   §11) at the same width, policy, slots and max_len: each request of the
   serve phase's grouped 1536/1536 pair alone through a warmed striped
   Engine gives its grouped stream (the bytes the group changes
   reported); (a) the 8 requests at priority 0 plus, after the first
   decode chunk, two priority-1 requests of 2048 tokens through a warmed
   pooled async Engine of 390 blocks with a 256 MiB host spill tier:
   preemptions, spilled and restored blocks >= 1, every priority-0 stream
   bitwise the serve phase's, valid FinishReasons, a clean audit (tier
   included), the launch identities, no plain call, no graph miss; ms per
   spilled and restored block against the host link's byte bound, host ms
   per preemption, prefill and restore ms of the victims, and batched
   against one-block reads; (b) a seeded chaos trace (pool bursts, NaN
   poisoning, host-loop crashes) over the 8 prompts at priorities 0/1,
   chunked at 512 under a TickClock, run twice on fresh engines: equal
   FinishReasons, streams, counters and injector accounting, NaN
   quarantines == NaN events, the injector done, surviving streams the
   serve phase's; (c) deadlines (running and queued), a cancel and a
   one-chunk timeout under a TickClock (each early end holds no block
   after its tick, one trip, no shed), and a real-clock watchdog below a
   chunk's time shedding everything after two chunks; the replayed step
   with the guard input against the step without it, ABBA at 4 x 2048.
11b. table6 — paper Table 6 measured (``repro_torch.speed.memory_latency``)
   at llama2-7b's full width and depth with serve_degrade's weights,
   batch 1, caches filled by the bulk kv_quant kernel in 65536-token
   chunks (``fill_caches``) and decode steps eager and replayed as one
   CUDA graph: (a) the kernel suite's gates at its own sizes: block
   pruning >= 4x fewer blocks at 25% occupancy (``kernel_bench``'s ragged
   sweep at cap 2048) and ``decode_step`` through every backend within
   2e-2 of the reference backend; (b) the filler's first 65536-token chunk
   of layer 0 through the kernel byte-equal to ``kv_quant_plain`` (0
   bytes); (c) kv2, kv4 and fp16 (the port's route and SDPA) at 32768 and
   131072 tokens: replayed and eager ms with spreads, peak memory, the
   op_cost bound and its share, or ``fits=false`` with the bytes needed
   (kv2 and kv4 must fit), finite logits, and the launches: kv_append and
   decode_attn once a layer a step, the bulk quantizer twice a layer a
   filled chunk, no plain call (the fp16 rows: the fp16 route, no
   kernel); the kv2 and kv4 rows' memory: the fill leaves its planes and
   at most 16 MiB more allocated, peaks at most 3 GiB above them, and
   the decode steps hold at most 128 MiB above the filled cache (one
   layer's kv2 planes are 262e6 B at 131072 tokens: a copy of them in the
   step fails); (d) the headline, 1,048,576 tokens at PAPER_POLICY: it
   must fit, with peak memory under the card's total, finite logits and
   the same launch and memory gates; its first chunk's packed rows
   byte-equal to (b)'s plain planes, and layer 0's decode_attn over every
   kv head and over a slice of 4 heads against ``decode_attn_plain`` on
   that slice (f32 tolerance), run between the fill's launch counts and
   the steps' and reported with its own launches; replayed and eager ms,
   peak memory and the bound's share printed.
12. serve_families — the gemma local/global family and qwen2-vl's M-RoPE
   decoder at full width (random bf16 weights from seed 0, PAPER_POLICY,
   identity calibration, 4 slots; every earlier model freed first, the
   peak so far reported), one JSON line a part: (kernels) decode_attn at
   gemma3's Hkv 4 / Gq 2 / D 256, over its 1024-token local_slice view,
   at gemma2's Hkv 16 / Gq 2 / D 128 with softcap 50 and a 4096-token
   window (lo > 0) and at qwen2-vl's Gq 7 (the G 8 template), each
   against its plain version (f32 tolerance), pruned == full == a second
   launch bitwise, L2-cold ms, bound and SDPA; kv_append at Hkv 4 / D 256
   and Hkv 16 / D 128 over 300 steps (byte-equal, graph replay); the bulk
   quantizer at one gemma3 layer's 3000-token prefill (11,468 rows x
   256, 0 differing bytes); (gemma3) gemma3-4b through eager striped,
   then warmed striped, pooled (768 blocks) and chunked (512) engines on
   mix (a): every request finished, replayed and pooled streams equal
   the eager ones, chunked final logits within relative L2 0.05 of
   whole-prompt (bitwise reported), the launch identities, no plain
   call, no graph miss, blocks visited by the first local and global
   layer (every family's eager run, here and in the phases below, serves
   mix (a) at 18 new tokens a request, in one eager chunk of 17 steps a
   wave, two past the first sync of 16 replayed steps, and the replayed
   streams must begin with its streams; pooled streams equal the replayed striped
   ones in full), cuda-vs-reference logits, and (b) the unrolled step at 4 x
   2048 against the default step (relative L2 gated at 0.05, top-1, one
   step's launches), then (b') the unrolled step on a 1-rank ``("pod",
   "data", "model")`` mesh on NCCL under SERVE_RULES (DTensors, the
   kernels run per rank through ``run_local``), 4 steps against the same
   steps on plain tensors: every cache leaf byte-equal, logits within
   relative L2 1e-5, 34 decode_attn and 34 kv_append launches a step, 29
   of the decode_attn over the local layers' 1024-token slices; (qwen2_vl)
   qwen2-vl-7b on mix (a) eager and warmed striped (equal streams, the
   identities), cuda-vs-reference logits, and one prefill from patch
   embeddings (32 text + 16 x 16 patches + 32 text, distinct (t, h, w)
   positions) with 8 decode steps from embeddings, cuda against
   reference per step (gated at 0.05); (gemma2) gemma2-27b (54.5 GB of
   weights) on one card: 4 requests of 1024-6000 tokens, 32 new, through
   a warmed striped Engine at max_len 8325 (identities, lo > 0 on the
   local layers for the 5000- and 6000-token prompts), replayed steps at
   4 x 2048 (CUDA events), peak memory, cuda-vs-reference logits.
13. serve_moe — the MoE family at full width (random bf16 weights from
   seed 0, PAPER_POLICY, identity calibration, 4 slots; every earlier
   model freed first, the peak so far reported), one JSON line a part:
   (kernels) decode_attn at deepseek's Hkv 16 / Gq 1 / D 128 and
   granite-moe's Hkv 8 / Gq 2 / D 64 over 4096 packed tokens (live
   500/1500/2900/3900), each against its plain version (f32 tolerance),
   pruned == full == a second launch bitwise, L2-cold ms, bound and SDPA;
   kv_append at Hkv 8 / D 64 over 300 steps (byte-equal, graph replay);
   the bulk quantizer at one deepseek layer's 3000-token prefill (45,872
   rows x 128, 0 differing bytes); (deepseek) deepseek-moe-16b (28
   layers, 64 experts top-6 of 1408 and 2 shared, the first layer dense;
   32.75 GB of weights) and (granite_moe) granite-moe-1b-a400m (24
   layers, 32 experts top-8 of 512), each on mix (a) through an eager
   striped, then a warmed striped Engine: every request finished,
   replayed streams equal the eager ones, the launch identities, no plain
   call, no graph miss; cuda-vs-reference logits at 4 x 2048 (gated at
   0.05); the 3000-token prefill's ms; the replayed step at 4 x 2048
   (CUDA events), beside the bytes of
   the weights a step reads over the HBM rate with every expert, with at
   most 4 x top_k experts a layer, and with the experts that step's
   router picked (counted in one eager step); the pool and chunked
   prefill refusing the family with the reference's messages; peak
   memory.
14. serve_hybrid — hymba-1.5b at full width (random bf16 weights from seed
   0, PAPER_POLICY, identity calibration, 4 slots; every earlier model
   freed first), one JSON line a part: (kernels) decode_attn at Hkv 5 /
   Gq 5 / D 64 (the launch plan takes one kv head a CTA) over 4096 packed
   tokens (live 500/1500/2900/3900) and over a local layer's 1024-token
   ``local_slice`` view, each against its plain version (f32 tolerance),
   pruned == full == a second launch bitwise, L2-cold ms, bound and SDPA;
   kv_append at Hkv 5 / D 64 over 300 steps (byte-equal, graph replay);
   the bulk quantizer at one layer's 3000-token prefill (14,335 rows x
   64, 0 differing bytes); (hymba) mix (a) through an eager striped, then
   a warmed striped Engine (the Mamba state ``ssm_conv``/``ssm_h`` in the
   Engine's caches, updated in place inside the captured step): every
   request finished, replayed streams equal the eager ones, the launch
   identities, no plain call, no graph miss; cuda-vs-reference logits at
   4 x 2048 (gated at 0.05); the 3000-token prefill's ms; the replayed
   step at 4 x 2048 (CUDA events); the pool and chunked prefill refusing
   the family; peak memory.
15. serve_encdec — seamless-m4t-large-v2 at full width (seed 0,
   PAPER_POLICY, 4 slots), one JSON line a part: (kernels) decode_attn
   over the decoder's self cache (Hkv 16 / Gq 1 / D 64, 4096 packed) and
   over a 4096-frame cross cache quantized whole under
   ``without_window()`` (window 0, no sinks, every frame packed, no fp
   segment), each against its plain version and SDPA; kv_append at Hkv 16
   / D 64; the bulk quantizer at one layer's cross cache for 4 slots
   (262,144 rows x 64); (seamless) through ``prefill_model`` /
   ``decode_step`` (the Engine refuses the family): 4 prompts of 1024
   tokens over 4 x 4096 seeded frames in one batched prefill (4 bulk
   launches a layer), 32 greedy steps eager (2 decode_attn launches a
   layer a step, 1 kv_append, no plain call, the cross cache untouched)
   and the same 32 from the same prefill replaying one captured step
   (streams equal); cuda-vs-reference logits (gated at 0.05); the
   encoder's ms at 4 x 4096 frames; the replayed step at 4 x 2048 (CUDA
   events); peak memory.
16. serve_rwkv — rwkv6-3b (RWKV6, attention-free: no KV cache, so neither
   kernel may run anywhere in the phase; its launch counters are gated
   to zero deltas) at full width (32 layers, d 2560, 40 heads of 64,
   random bf16 weights from seed 0), one JSON line a part: (wkv)
   ``wkv_chunked`` against the step recurrence ``wkv_naive`` at one
   layer's 3000-token prefill (B 1, S 3008, H 40, hd 64, f32) within
   atol 2e-4 / rtol 1e-3 (the reference test's), ms of each; (rwkv) mix
   (a) through an eager, then a warmed Engine (the state ``wkv``,
   ``x_prev``, ``x_prev_ffn`` updated in place inside the captured step):
   every request finished, replayed streams equal the eager ones, no
   graph miss, replays == decode steps; the replayed step at 4 x 2048
   (CUDA events); the state
   bytes a slot (the Engine's caches = 4 x that, and the same shapes at
   max_len 131205); the 3000-token prefill's ms; the pool and chunked
   prefill refusing the family; peak memory; seconds by part.
17. train — the single-device training path (``training.make_train_step``
   on ``forward_train``, f32 params, grads and AdamW moments, f32
   matmuls with TF32 off) at llama3.2-1b's full width (16 layers, d
   2048, vocab 128,256: 1.24 B params): 8 steps at batch 8 x seq 128 and
   4 at 8 x 512 on ``DataLoader`` batches (loss and grad norm finite at
   every step; step ms, tokens/s, 6 x params x tokens over the f32 peak,
   peak memory), 4 steps on one repeated batch (its loss must fall),
   loss and gradients with remat off against ``nothing`` and ``dots``
   (loss within 1e-5 relative, each gradient leaf within 1e-4 of its
   largest magnitude), and a checkpoint round trip at full width and 2
   layers (2 steps, save, one more step; restored into a fresh state,
   the same step bitwise: params, moments, steps, metrics; save and
   restore ms and bytes); both kernels' launch counters at zero deltas.
18. distributed — the distributed substrate (``torch.distributed``,
   DTensor; no kernel may launch): (a) world 1 on NCCL (a TCP store on
   localhost), mesh (1, 1, 1) ``("pod", "data", "model")``, llama3.2-1b
   at full width in f32, 8 x 128 tokens, remat on: 2 steps of
   ``make_train_step(mesh=)`` from ``place_state`` against 2 plain steps
   from the same seed's state (loss, nll, grad norm and every param
   within 1e-5 relative; expected equal), then 4 steps of each in turns
   timed with CUDA events and the peak memory a step adds; 2
   sequence-parallel steps (``SEQ_PARALLEL_TRAIN_RULES``) gated the same
   way; ``int8_allreduce_pod`` on a pod of one returns x and one-stage
   ``pipeline_forward`` equals the microbatches run through the layers,
   and its gradients sequential autograd's, bitwise; (b) 4 ranks spawned
   on the one card over gloo with CUDA tensors, mesh (2, 1, 2):
   ``int8_allreduce_pod`` of distinct inputs a
   rank equal to the numpy formula over each pod group, exactly.  The
   sharded step and the pipeline need collectives gloo refuses on CUDA
   tensors (``--gloo-probe``), and NCCL refuses two ranks on one card,
   so (b) leaves them out and names them.
19. analytic — the analytic launch path (``launch.op_cost``,
   ``launch.roofline``, ``launch.dryrun``): (a) one eager llama2-7b decode
   step at 4 x 2048 on the cuda backend under the op counter, both kernels
   reporting through their own formula (exactly 32 decode_attn and 32
   kv_append reports, the launch counts equal), FLOPs and bytes by
   category, the roofline's t_compute / t_memory on the H100 constants
   and the share of that bound the replayed step of serve_graph reaches
   (bound / replayed ms); (b) ``model_flops`` of the step beside the
   counter's matmul FLOPs; (c) two full-width dry-run cells (llama3.2-1b
   x decode_32k, and gemma3-4b x decode_32k x unroll_local: the unrolled
   step on the 16 x 16 mesh) on 16 x 16 fake ranks, one after the other
   in a subprocess on the CPU, started before the first phase so that it
   runs beside them (their rows, status ok, in
   ``build/analytic/dryrun.json``; their trace seconds reported).
20. a ``timing`` line of seconds per phase, then the kernel summary line
   (decode_attn entries also carry the long slot's ``long_ms``,
   ``long_bound_ms`` and ``long_library_ms``; kv_quant its prefill-size
   ``prefill_ms``, ``prefill_bound_ms`` and ``prefill_rows``, and one
   chunk append's ``chunk_ms``, ``chunk_bound_ms``, ``chunk_plain_ms``
   and ``chunk_rows``, and the clip search's ``calib_ms``,
   ``calib_bound_ms``, ``calib_plain_ms``, ``calib_rows`` and
   ``calib_launches``, and the quality path's ``quality_ms``,
   ``quality_bound_ms``, ``quality_rows`` and ``quality_launches``; every
   entry the ``widths`` of serve_schedule
   (a) and (e); decode_attn, kv_append and kv_quant the ``families``
   rows of serve_families, the ``moe`` rows of serve_moe, the ``hybrid``
   rows of serve_hybrid and the ``encdec`` rows of serve_encdec; launches
   count the serve, serve_pooled (b), serve_chunked (b), calibrate (a),
   (b), (f), quality, serve_schedule (b), (e), serve_degrade, serve_families,
   serve_moe and serve_hybrid serve runs, serve_encdec's prefill and
   eager steps, and table6's fills and steps), the card line, and the
   last line ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero.  Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's HBM rate and f32 peak (H100 SXM data sheet), one source
# with the port's roofline
from repro_torch.launch.roofline import (  # noqa: E402
    F32_PEAK_FLOPS as F32_FLOP_PER_S, HBM_BW as HBM_BYTES_PER_S)
# the CUDA-event timer, the card line and the spread of a sample: one
# source with the speed suites
from repro_torch.speed.common import (  # noqa: E402
    cuda_ms, gpu_line, spread)
ATOL, RTOL = 3e-5, 1e-4          # decode_attn kernel vs plain, f32
LOGIT_REL_TOL = 0.05             # cuda vs reference backend, bf16 model
SLA_TTFT_MS, SLA_TPOT_MS = 2000.0, 500.0   # the port CLI docstring's SLA
# per-slot cache capacity of the serve phases: 4229 - 5 sinks - 128 window
# leaves a packed region of 4096 tokens = 256 pool blocks of 16
MAX_LEN = 4229
POOL_BT = 16
# the long-context decode_attn case: one slot of 131072 packed tokens
# (+ 5 sinks + 128 window), 131000 of them live
LONG_MAX_LEN, LONG_LIVE = 131205, 131000
# one layer of the longest serve prompt's prefill: B*S*Hkv = 1 x 2867 x 32
# rows (3000 tokens - 5 sinks - 128 window quantized)
PREFILL_ROWS = 2867 * 32
APPEND_STEPS = 300               # >= 2 wraps of the 128-token ring
APPEND_PLAIN_ITERS = 10          # timed calls of the plain append
L2_COPIES = 4                    # input copies a timing rotates over


# per-kernel numbers beyond the contract's keys that the summary line carries
KERNEL_EXTRAS = ("long_ms", "long_bound_ms", "long_library_ms", "prefill_ms",
                 "prefill_bound_ms", "prefill_rows", "plain_wall_ms",
                 "chunk_ms", "chunk_bound_ms", "chunk_plain_ms", "chunk_rows",
                 "widths", "calib_ms", "calib_bound_ms", "calib_plain_ms",
                 "calib_rows", "calib_launches",
                 "quality_ms", "quality_bound_ms", "quality_rows",
                 "quality_launches", "families", "moe", "hybrid", "encdec")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def copies(tree, n: int = L2_COPIES):
    """``n`` copies of a dict of tensors (the first is ``tree`` itself)."""
    return [tree] + [{k: v.clone() for k, v in tree.items()}
                     for _ in range(n - 1)]


def bound(nbytes: float, flops: float):
    """Least time the card could take (ms) and what bounds it: the bytes
    over the HBM rate or the f32 operations over the f32 peak."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


# ------------------------------------------------------------------ phases

# phases that launch neither kernel: they run while the kernels build
# (serve_rwkv last: its Engine's warmup loads the kernels, so it waits
# there for the build)
EARLY = ("train", "distributed", "quality_model", "serve_rwkv")


def phase_env(state):
    """Starts the kernels' build in a thread (its nvcc processes run while
    the EARLY phases use the card) and reads the card's name and power
    limit; ``phase_build`` waits for the build and prints the line."""
    import threading
    from repro_torch.kernels import _build
    box = {}

    def build():
        t0 = time.monotonic()
        try:
            _build.build_all()
        except BaseException as e:              # re-raised by phase_build
            box["error"] = e
        box["build_s"] = time.monotonic() - t0
    box["thread"] = threading.Thread(target=build, daemon=True)
    box["thread"].start()
    state["build"] = box
    state["gpu"] = gpu_line()


def phase_build(state):
    import torch
    from repro_torch.kernels import _build
    box = state.pop("build")
    t0 = time.monotonic()
    box["thread"].join()
    wait_s = time.monotonic() - t0
    check("error" not in box, f"kernel build failed: {box.get('error')}")
    res = {}
    for name, log in _build.BUILD_INFO["ptxas"].items():
        res[name] = [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln]
    emit({"phase": "env", "gpu": state["gpu"], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_s": round(box["build_s"], 3),
          "build_wait_s": round(wait_s, 3), "built_beside": list(EARLY),
          "build_dir": _build.BUILD_INFO["dir"], "ptxas": res})


def _edge_rows(gen, d, dev):
    import torch
    u = lambda lo, hi: torch.rand(d, generator=gen, device=dev) * (hi - lo) + lo
    n = lambda s, m=0.0: torch.randn(d, generator=gen, device=dev) * s + m
    rows = [torch.zeros(d, device=dev), torch.full((d,), 0.5, device=dev),
            torch.full((d,), -3.0, device=dev), u(0.0, 1e-3), u(-2e-4, 2e-4),
            torch.cat([torch.zeros(1, device=dev), u(0.0, 1e-3)[1:]]),
            n(900.0), n(1.0, -1000.0)]
    return torch.stack(rows)


def _kv_quant_rows(gen, dev, d, gs, bits, dtype):
    """128 rows x ``d`` (a decode step's rows; edge rows first) through the
    bulk kernel and its plain version: 0 differing bytes; L2-warm times and
    the byte bound."""
    import torch
    from repro_torch.core.quant import (dequantize_groups, n_meta_groups,
                                        plane_layout)
    from repro_torch.kernels import kv_quant as KQ
    x = torch.randn((128, d), generator=gen, device=dev)
    x[:8] = _edge_rows(gen, d, dev)
    x = x.to(dtype)
    g = n_meta_groups(d, bits, gs)
    alpha = 0.8 + 0.2 * torch.rand((128, g), generator=gen, device=dev)
    got = KQ.kv_quant(x, bits, gs, alpha)
    want = KQ.kv_quant_plain(x, bits, gs, alpha)
    diff = sum(int((got[k].view(torch.uint8) != want[k].view(torch.uint8)
                    ).sum()) for k in want)
    check(diff == 0, f"kv_quant d={d} bits={bits} {dtype}: {diff} bytes "
          f"differ from the plain version")
    # the same bytes dequantize to the same values: err is 0.0
    deq = [dequantize_groups(qt, d, bits, gs, True, torch.float32)
           for qt in (got, want)]
    err = float((deq[0] - deq[1]).abs().max())
    ms = cuda_ms(lambda: KQ.kv_quant(x, bits, gs, alpha))
    plain_ms = cuda_ms(lambda: KQ.kv_quant_plain(x, bits, gs, alpha))
    out_b = sum(v.numel() * v.element_size() for v in got.values())
    in_b = x.numel() * x.element_size() + alpha.numel() * 4
    # per element: min, max, subtract, divide, round, 2 clamps
    bound_ms, bound_by = bound(in_b + out_b, 7 * x.numel())
    return {"d": d, "bits": bits, "dtype": str(dtype)[6:], "rows": 128,
            "planes": len(plane_layout(d, bits, gs)), "diff_bytes": diff,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_kv_quant(state):
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = [_kv_quant_rows(gen, dev, d, gs, bits, dtype)
            for d, gs in ((128, 128), (64, 64))      # llama2-7b, GQA smoke
            for bits in (2.0, 1.5)
            for dtype in (torch.bfloat16, torch.float32)]
    prefill = [_kv_quant_prefill(gen, dev, bits) for bits in (2.0, 1.5)]
    worst = max(r["max_abs_err"] for r in rows + prefill)
    emit({"phase": "kv_quant", "cases": rows, "prefill": prefill,
          "timing": f"device time, rotating over {L2_COPIES} input copies"})
    main = rows[0]                       # K plane of a decode step, bf16
    state["kv_quant"] = {"max_abs_err": worst, "ms": main["ms"],
                         "plain_ms": main["plain_ms"],
                         "bound_ms": main["bound_ms"],
                         "bound_by": main["bound_by"],
                         "prefill_ms": prefill[0]["ms"],
                         "prefill_bound_ms": prefill[0]["bound_ms"],
                         "prefill_rows": PREFILL_ROWS}


def _kv_quant_prefill(gen, dev, bits, rows=PREFILL_ROWS, d=128, h=32):
    """One layer of the longest prompt's prefill through the bulk kernel:
    ``rows`` x ``d`` bf16 rows (edge rows first; llama2-7b's PREFILL_ROWS
    x 128 by default), per-head (h, G) clip factors read by row % h; 0
    differing bytes from the plain version, L2-cold times, the byte bound
    and its share."""
    import torch
    from repro_torch.core.quant import dequantize_groups, n_meta_groups
    from repro_torch.kernels import kv_quant as KQ
    gs = 128
    x = torch.randn((rows, d), generator=gen, device=dev)
    x[:8] = _edge_rows(gen, d, dev)
    x = x.to(torch.bfloat16)
    alpha = 0.8 + 0.2 * torch.rand((h, n_meta_groups(d, bits, gs)),
                                   generator=gen, device=dev)
    got = KQ.kv_quant(x, bits, gs, alpha)
    want = KQ.kv_quant_plain(x, bits, gs, alpha)
    diff = sum(int((got[k].view(torch.uint8) != want[k].view(torch.uint8)
                    ).sum()) for k in want)
    check(diff == 0, f"kv_quant prefill rows bits={bits}: {diff} bytes "
          f"differ from the plain version")
    deq = [dequantize_groups(qt, d, bits, gs, True, torch.float32)
           for qt in (got, want)]
    err = float((deq[0] - deq[1]).abs().max())
    del deq, want
    xs = [x] + [x.clone() for _ in range(L2_COPIES - 1)]
    ms = cuda_ms([lambda c=c: KQ.kv_quant(c, bits, gs, alpha) for c in xs])
    plain_ms = cuda_ms([lambda c=c: KQ.kv_quant_plain(c, bits, gs, alpha)
                        for c in xs], iters=4, warmup=1)
    out_b = sum(v.numel() * v.element_size() for v in got.values())
    in_b = x.numel() * x.element_size() + alpha.numel() * 4
    bound_ms, bound_by = bound(in_b + out_b, 7 * x.numel())
    del xs, x, got
    torch.cuda.empty_cache()
    return {"rows": rows, "d": d, "bits": bits, "dtype": "bfloat16",
            "alpha": f"per head ({h}, G)", "diff_bytes": diff,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bytes": in_b + out_b, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms}


def _policy(gs=128, bits=(2.0, 1.5)):
    """PAPER_POLICY at group ``gs`` and widths ``bits`` (K, V)."""
    import dataclasses
    from repro_torch.core.policy import PAPER_POLICY
    return dataclasses.replace(PAPER_POLICY, group_size=gs, bits_k=bits[0],
                               bits_v=bits[1])


def _append_caches(gen, dev, hkv, d, gs, pooled, bits=(2.0, 1.5)):
    """A kernel and a plain cache with identical seeded contents at the
    serve capacity (max_len 4229; pooled: 256 blocks of 16 per slot over a
    seeded permutation of 4 * 256 + 1 physical blocks), slots at 0 (sinks
    first), 40 (window filling), 2000 and 4100 (past the capacity within
    APPEND_STEPS)."""
    import numpy as np
    import torch
    from repro_torch.core import kv_cache as kvc
    from repro_torch.core.quant import n_meta_groups
    pol, b = _policy(gs, bits), 4
    if pooled:
        nb = (MAX_LEN - pol.n_sink - pol.window) // POOL_BT
        cache = kvc.init_pooled_cache(b, MAX_LEN, hkv, d, pol, b * nb,
                                      POOL_BT, torch.bfloat16, device=dev)
        tbl = np.random.default_rng(4).permutation(np.arange(1, b * nb + 1))
        cache["block_tbl"].copy_(torch.as_tensor(
            tbl.reshape(b, nb).astype(np.int32)))
    else:
        cache = kvc.init_cache(b, MAX_LEN, hkv, d, pol, torch.bfloat16,
                               device=dev)
    for k, v in cache.items():
        if k == "length":
            v.copy_(torch.tensor([0, 40, 2000, 4100]))
        elif v.is_floating_point():
            v.copy_(torch.randn(v.shape, generator=gen, device=dev))
        elif k != "block_tbl":
            v.copy_(torch.randint(0, 256, v.shape, generator=gen,
                                  device=dev))
    alphas = [0.8 + 0.2 * torch.rand((hkv, n_meta_groups(d, bits, gs)),
                                     generator=gen, device=dev)
              for bits in (pol.bits_k, pol.bits_v)]
    return pol, cache, {k: v.clone() for k, v in cache.items()}, alphas


def _caches_differ(a, c, pooled):
    """Leaves of two caches that differ in any byte (pool block 0, where
    the plain version steers rows that write nothing, excluded)."""
    import torch
    from repro_torch.core.kv_cache import is_plane_key
    bad = []
    for k in c:
        x, y = a[k], c[k]
        if pooled and is_plane_key(k):
            x, y = x[1:], y[1:]
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        if not torch.equal(x, y):
            bad.append(k)
    return bad


def _append_bound(cache, pol, hkv, d):
    """Bytes one append launch must move at these lengths: per slot and
    head the new K/V rows in and out (ring or sink), and where the slot
    evicts the ring rows in and the packed rows out (plus its table entry
    if pooled); the clip factors and lengths once."""
    from repro_torch.core.quant import n_meta_groups, packed_nbytes
    lens = cache["length"].tolist()
    gsz = min(pol.group_size, d)
    packed = (packed_nbytes(d, pol.bits_k, gsz, 8)
              + packed_nbytes(d, pol.bits_v, gsz, 8))
    row = 2 * d * 2                                  # K + V rows, bf16
    n_ev = sum(1 for t in lens if t - pol.n_sink - pol.window >= 0)
    nbytes = (len(lens) * hkv * 2 * row + n_ev * hkv * (row + packed)
              + n_ev * 4 * ("block_tbl" in cache) + 8 * len(lens)
              + 4 * hkv * (n_meta_groups(d, pol.bits_k, gsz)
                           + n_meta_groups(d, pol.bits_v, gsz)))
    return nbytes, *bound(nbytes, 7 * 2 * n_ev * hkv * d)


def _host_ms(fn, n: int = 30) -> float:
    """Host wall time per call of ``n`` calls ending in a synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _append_case(gen, dev, hkv, d, gs, pooled, widths=(2.0, 1.5)):
    import torch
    from repro_torch.core.quant import dequantize_groups
    from repro_torch.kernels import kv_quant as KQ
    pol, kc, pc, (ak, av) = _append_caches(gen, dev, hkv, d, gs, pooled,
                                           widths)
    b = kc["length"].shape[0]
    start = kc["length"].tolist()
    new = lambda: torch.randn((b, 1, hkv, d), generator=gen, device=dev
                              ).to(torch.bfloat16)
    for step in range(APPEND_STEPS):
        kn, vn = new(), new()
        valid = None if step % 3 == 0 else torch.tensor(
            [True, True, step % 3 == 1, True], device=dev)
        KQ.kv_append(kc, kn, vn, pol, ak, av, valid=valid)
        KQ.kv_append_plain(pc, kn, vn, pol, ak, av, valid=valid)
        bad = _caches_differ(kc, pc, pooled)
        check(not bad, f"kv_append hkv={hkv} d={d} bits={widths} pooled="
              f"{pooled} step {step}: leaves {bad} differ from the plain "
              f"version")
    end = kc["length"].tolist()
    cap = MAX_LEN - pol.n_sink - pol.window
    check(start[0] == 0 and end[0] > pol.n_sink + pol.window
          and start[1] < pol.n_sink + pol.window < end[1]
          and end[3] > MAX_LEN and end[2] < start[2] + APPEND_STEPS,
          f"kv_append lengths {start} -> {end} miss a phase")
    gsz = min(gs, d)
    err = 0.0
    for pref, bits in (("qk", pol.bits_k), ("qv", pol.bits_v)):
        qts = [{k[3:]: v[1:] if pooled else v for k, v in c.items()
                if k.startswith(pref + "_")} for c in (kc, pc)]
        deq = [dequantize_groups(qt, d, bits, gsz, True, torch.float32)
               for qt in qts]
        err = max(err, float((deq[0] - deq[1]).abs().max()))
        del deq
    # timings from the evicting state the steps left, valid = None
    kn, vn = new(), new()
    nbytes, bound_ms, bound_by = _append_bound(kc, pol, hkv, d)
    cs = copies(kc)
    ms = cuda_ms([lambda c=c: KQ.kv_append(c, kn, vn, pol, ak, av)
                  for c in cs])
    wall_ms = _host_ms(lambda: KQ.kv_append(cs[0], kn, vn, pol, ak, av))
    del cs
    plain_wall_ms = _host_ms(lambda: KQ.kv_append_plain(pc, kn, vn, pol, ak,
                                                        av))
    # the plain append is host-bound: hold the stream twice as long as the
    # host takes to queue the timed calls (~2 GHz: 2e6 cycles a ms)
    plain_ms = cuda_ms(lambda: KQ.kv_append_plain(pc, kn, vn, pol, ak, av),
                       iters=APPEND_PLAIN_ITERS, warmup=1,
                       hold=int(2 * APPEND_PLAIN_ITERS * plain_wall_ms * 2e6))
    # one capture + replays, byte-equal to eager launches from one state
    # (the library is loaded: the launches above came first)
    gc, ec = copies(kc, 3)[1:]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        KQ.kv_append(gc, kn, vn, pol, ak, av)
    for _ in range(8):
        graph.replay()
        KQ.kv_append(ec, kn, vn, pol, ak, av)
    torch.cuda.synchronize()
    bad = _caches_differ(gc, ec, pooled)
    check(not bad, f"kv_append CUDA-graph replay differs from eager: {bad}")
    del gc, ec, kc, pc, graph
    torch.cuda.empty_cache()
    return {"b": b, "hkv": hkv, "d": d, "group": gs, "bits": list(widths),
            "layout": "pooled" if pooled else "striped",
            "steps": APPEND_STEPS, "lengths_start": start,
            "lengths_end": end, "packed_capacity": cap, "diff_leaves": 0,
            "max_abs_err": err, "ms": ms, "wall_ms": wall_ms,
            "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
            "plain_ms": plain_ms, "plain_wall_ms": plain_wall_ms,
            "graph_replay_equal": True}


def phase_kv_append(state):
    """The fused decode append against its plain version, both layouts,
    the serve and GQA head shapes."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = [_append_case(gen, dev, hkv, d, gs, pooled)
            for hkv, d, gs in ((32, 128, 128), (8, 64, 64))
            for pooled in (False, True)]
    emit({"phase": "kv_append", "cases": rows,
          "timing": f"kernel: device time, rotating over {L2_COPIES} cache "
                    f"copies; plain: device time (CUDA events, the stream "
                    f"held while the calls are queued) and host wall time "
                    f"per call"})
    main = rows[0]
    state["kv_append"] = {k: main[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "plain_wall_ms",
        "wall_ms")}
    state["kv_append"].update(
        max_abs_err=max(r["max_abs_err"] for r in rows), library_ms=None)


def _attn_case(gen, dev, b, hkv, gq, d, live, max_len=MAX_LEN,
               bits=(2.0, 1.5), window=0):
    """Packed planes of a ``max_len``-token cache (the serve phase's: 4096
    packed tokens) at widths ``bits`` with ``live`` packed tokens per slot
    (of which a local ``window`` keeps the last ones), built by the port's
    own prefill + masks."""
    import torch
    from repro_torch.core import kv_cache as kvc
    from repro_torch.kernels import ops
    POL = _policy(128, bits)
    from repro_torch.core import segments as seg
    k = torch.randn((b, max_len, hkv, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn((b, max_len, hkv, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    cache = kvc.prefill(k, v, max_len, POL, quant_fn=ops.make_kernel_quant_fn())
    del k, v
    cache["length"].copy_(torch.tensor(live, device=dev) + POL.n_sink
                          + POL.window)
    lens = cache["length"]
    cap = cache["qk_codes_hi"].shape[1]
    bs, s_pad = ops._block_pad(cap, 256)
    ok = ops._packed_ok(ops._padded_j(cap, s_pad, dev), lens, lens - 1,
                        seg.effective_window(window), POL, b)
    k_qt = {kk[3:]: vv for kk, vv in cache.items() if kk.startswith("qk_")}
    v_qt = {kk[3:]: vv for kk, vv in cache.items() if kk.startswith("qv_")}
    q = torch.randn((b, hkv, gq, d), generator=gen, device=dev)
    # a local window of W attends the query's last W tokens: the fp
    # window's POL.window of them, and the W - POL.window newest packed
    reach = [n if not window else min(n, window - POL.window) for n in live]
    check(int((ok > 0).sum()) == sum(reach), "decode_attn case: live tokens")
    return (POL, q, k_qt, v_qt, ok.to(torch.float32),
            seg.packed_block_bounds(ok, bs), bs)


def _attn_bound(pol, q, hkv, gq, d, n_live, extra_bytes=0):
    """Bound of one decode_attn call: the live tokens' packed K and V rows
    and mask entries, q, the outputs (and ``extra_bytes``), or its f32
    operations."""
    from repro_torch.core.quant import packed_nbytes
    gsz = min(pol.group_size, d)
    per_tok = hkv * (packed_nbytes(d, pol.bits_k, gsz, 8)
                     + packed_nbytes(d, pol.bits_v, gsz, 8))
    nbytes = (n_live * (per_tok + 4) + q.numel() * 4
              + 4 * hkv * gq * (d + 2) + extra_bytes)
    # per live token and kv head: dequantize K and V (2 x 2D), then
    # q.k and p.v for each of the Gq query rows (2 x 2D x Gq)
    flops = n_live * hkv * (4 * d + 4 * d * gq)
    return nbytes, flops, *bound(nbytes, flops)


def _sdpa_ms(pol, q, k_qt, v_qt, mask, scale):
    """Device time of scaled_dot_product_attention over the same tokens
    dequantized to bf16, masked, rotating over copies like the kernel's
    timing: the library yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.quant import dequantize_groups
    b, hkv, gq, d = q.shape
    gsz = min(pol.group_size, d)
    kd = dequantize_groups(k_qt, d, pol.bits_k, gsz, True, torch.bfloat16)
    vd = dequantize_groups(v_qt, d, pol.bits_v, gsz, True, torch.bfloat16)
    kv = copies({"k": kd.transpose(1, 2).contiguous(),        # B, H, S, D
                 "v": vd.transpose(1, 2).contiguous()})
    del kd, vd
    qb = q.reshape(b, hkv * gq, 1, d).to(torch.bfloat16)
    am = (mask[:, : kv[0]["k"].shape[2]] > 0)[:, None, None, :]
    ms = cuda_ms([lambda c=c: F.scaled_dot_product_attention(
        qb, c["k"], c["v"], attn_mask=am, scale=scale, enable_gqa=gq > 1)
        for c in kv])
    del kv
    torch.cuda.empty_cache()
    return ms


def _check_attn(name, got, want, *same):
    """f32 tolerance against the plain version; ``same``: results that must
    equal ``got`` bitwise (another launch, the full walk, ...)."""
    import torch
    torch.cuda.synchronize()
    for what, other in same:
        check(all(torch.equal(a, c) for a, c in zip(got, other)),
              f"{name}: differs bitwise from {what}")
    out_g, out_w = got[0] / got[2], want[0] / want[2]
    for what, x, y in (("out", out_g, out_w), ("m", got[1], want[1]),
                       ("l", got[2], want[2])):
        check(torch.allclose(x, y, atol=ATOL, rtol=RTOL),
              f"{name}: {what} outside atol={ATOL} rtol={RTOL}: max err "
              f"{float((x - y).abs().max())}")
    return float((out_g - out_w).abs().max())


def _attn_row(name, pol, q, k_qt, v_qt, mask, bounds, bs, live,
              table=None, long=False, scale=None, softcap=0.0):
    """Check one decode_attn case (striped, or pooled with ``table``) and
    time it L2-cold next to its plain version and SDPA (which has no
    softcap: with one, a yardstick of the same size, not the same
    function).  ``live``: the attended packed tokens per slot."""
    import torch
    from repro_torch.kernels import decode_attn as DA
    b, hkv, gq, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    kw = dict(block_s=bs, block_bounds=bounds, block_table=table,
              softcap=softcap)
    args = (q, k_qt, v_qt, mask, pol, d, scale)
    got = DA.decode_attn(*args, **kw)
    again = DA.decode_attn(*args, **kw)
    full = DA.decode_attn(*args, block_s=bs, block_table=table,
                          softcap=softcap)
    want = DA.decode_attn_plain(*args, **kw)
    same = [("a second launch", again), ("the full walk", full)]
    k_g = v_g = None
    if table is not None:
        k_g, v_g = DA.gather_planes(k_qt, table), DA.gather_planes(v_qt,
                                                                   table)
        same.append(("the striped kernel over the gathered planes",
                      DA.decode_attn(q, k_g, v_g, mask, pol, d, scale,
                                     block_s=bs, block_bounds=bounds,
                                     softcap=softcap)))
    err = _check_attn(name, got, want, *same)
    del got, again, full, want, same
    ks, vs = copies(k_qt), copies(v_qt)
    ms = cuda_ms([lambda k=k, v=v: DA.decode_attn(q, k, v, mask, pol, d,
                                                   scale, **kw)
                  for k, v in zip(ks, vs)])
    full_ms = cuda_ms([lambda k=k, v=v: DA.decode_attn(
        q, k, v, mask, pol, d, scale, block_s=bs, block_table=table,
        softcap=softcap) for k, v in zip(ks, vs)])
    del ks, vs
    plain_ms = cuda_ms(lambda: DA.decode_attn_plain(*args, **kw),
                       iters=1 if long else 3, warmup=0 if long else 1)
    extra = 0 if table is None else table.numel() * 4
    nbytes, flops, bound_ms, bound_by = _attn_bound(pol, q, hkv, gq, d,
                                                    sum(live), extra)
    library_ms = _sdpa_ms(pol, q, k_g if table is not None else k_qt,
                          v_g if table is not None else v_qt, mask, scale)
    torch.cuda.empty_cache()
    return {"b": b, "hkv": hkv, "gq": gq, "d": d, "mask": mask.shape[1],
            "tile": bs, "live": live if len(live) <= 8 else sum(live),
            "max_abs_err": err, "ms": ms, "full_walk_ms": full_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "bytes": nbytes, "flops": flops,
            "library_ms": library_ms}


def phase_decode_attn(state):
    """The striped kernel at the serve shape, the GQA shape and one
    131072-token slot."""
    import torch
    from repro_torch.kernels import decode_attn as DA
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for hkv, gq, d, live, max_len in (
            (32, 1, 128, [500, 1500, 2900, 3900], MAX_LEN),
            (8, 4, 64, [500, 1500, 2900, 3900], MAX_LEN),
            (32, 1, 128, [LONG_LIVE], LONG_MAX_LEN)):
        pol, q, k_qt, v_qt, mask, bounds, bs = _attn_case(
            gen, dev, len(live), hkv, gq, d, live, max_len)
        row = _attn_row(f"decode_attn hkv={hkv} S={max_len}", pol, q, k_qt,
                        v_qt, mask, bounds, bs, live,
                        long=max_len == LONG_MAX_LEN)
        row.update(max_len=max_len, packed=k_qt["codes_hi"].shape[1],
                   plan=DA.launch_plan(len(live), hkv, d, pol, mask.shape[1],
                                       bs, dev))
        rows.append(row)
        del pol, q, k_qt, v_qt, mask, bounds
        torch.cuda.empty_cache()
    emit({"phase": "decode_attn", "cases": rows, "atol": ATOL, "rtol": RTOL,
          "timing": f"device time, rotating over {L2_COPIES} input copies"})
    state["decode_attn"] = _kernel_stats(rows[0], rows[2])


def _kernel_stats(serve, long):
    out = {k: serve[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}
    out["max_abs_err"] = max(serve["max_abs_err"], long["max_abs_err"])
    out.update(long_ms=long["ms"], long_bound_ms=long["bound_ms"],
               long_library_ms=long["library_ms"])
    return out


def _pool(dev, b, nb, k_st, v_st, seed, share=0):
    """Scatter striped planes (B, NB * POOL_BT, ...) into a pool of
    B * NB + 1 blocks through a seeded permutation (block 0 stays null);
    slot 1 shares its first ``share`` table entries with slot 0."""
    import numpy as np
    import torch
    perm = np.random.default_rng(seed).permutation(np.arange(1, b * nb + 1))
    tbl = perm.reshape(b, nb).astype(np.int32)
    if share:
        tbl[1, :share] = tbl[0, :share]
    out = []
    for src in (k_st, v_st):
        dst = {}
        for k, v in src.items():
            if share:
                v = v.clone()
                v[1, :share * POOL_BT] = v[0, :share * POOL_BT]
            blocks = v.reshape((b * nb, POOL_BT) + tuple(v.shape[2:]))
            p = torch.zeros((b * nb + 1,) + tuple(blocks.shape[1:]),
                            dtype=v.dtype, device=dev)
            p[torch.as_tensor(tbl.reshape(-1), device=dev).long()] = blocks
            dst[k] = p
        out.append(dst)
    return out[0], out[1], torch.as_tensor(tbl, device=dev)


def phase_decode_attn_pooled(state):
    """The block-table mode at the serve shape (4 slots x NB = 256 logical
    blocks of 16 tokens over 4 * 256 + 1 physical blocks, two slots sharing
    8) and at one 131072-token slot (8192 blocks)."""
    import torch
    from repro_torch.core import segments as seg
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for live, max_len, share in (([500, 1500, 2900, 3900], MAX_LEN, 8),
                                 ([LONG_LIVE], LONG_MAX_LEN, 0)):
        b = len(live)
        pol, q, k_st, v_st, mask, _, bs = _attn_case(gen, dev, b, 32, 1, 128,
                                                     live, max_len)
        nb = k_st["codes_hi"].shape[1] // POOL_BT
        check(nb * POOL_BT == k_st["codes_hi"].shape[1] and bs == 256,
              f"pooled case: NB={nb} tile={bs}")
        k_qt, v_qt, table = _pool(dev, b, nb, k_st, v_st, 3, share)
        del k_st, v_st
        torch.cuda.empty_cache()
        bounds = seg.packed_block_bounds(mask > 0, bs)
        row = _attn_row(f"decode_attn pooled S={max_len}", pol, q, k_qt,
                        v_qt, mask, bounds, bs, live, table=table,
                        long=max_len == LONG_MAX_LEN)
        row.update(bt=POOL_BT, nb=nb, phys_blocks=b * nb + 1)
        rows.append(row)
        del pol, q, k_qt, v_qt, mask, bounds, table
        torch.cuda.empty_cache()
    emit({"phase": "decode_attn_pooled", "cases": rows, "atol": ATOL,
          "rtol": RTOL,
          "timing": f"device time, rotating over {L2_COPIES} input copies"})
    state["decode_attn_pooled"] = _kernel_stats(rows[0], rows[1])


SERVE_LENS = [1024, 2048, 3000, 512, 1536, 1536, 2500, 1024]  # two waves
SERVE_NEW, SERVE_SLOTS, SERVE_SPS = 64, 4, 16
STEP_CONTEXT, TIMED_STEPS = 2048, 8      # single-step timings: 4 x 2048
# the family phases' eager runs: 18 new tokens, so that the replayed
# streams' tokens 17-18 come from the second graph chunk of SERVE_SPS
# steps and the state carried across a sync is held to the eager run; the
# eager Engine syncs every EAGER_SPS steps, one chunk a wave.  The eager
# pooled run of serve_pooled (a) serves as many, syncing every SERVE_SPS
EAGER_NEW_FAMILY = SERVE_SPS + 2
EAGER_SPS = EAGER_NEW_FAMILY - 1


def _timed_chunks(eng):
    """Wrap the Engine's decode chunk: every chunk ends in its one
    device->host copy, so its wall time is that of ``steps_per_sync``
    decode steps as the Engine runs them.  Returns the (ms per step,
    active slots) list it fills."""
    chunks = []
    decode_chunk = eng._decode_chunk

    def timed_chunk():
        active = eng.active_slots
        t = time.monotonic()
        decode_chunk()
        chunks.append(((time.monotonic() - t) * 1e3 / eng.steps_per_sync,
                       active))
    eng._decode_chunk = timed_chunk
    return chunks


def _counted_prefills(eng, logits=None):
    """Wrap the Engine's group admission (one ``prefill_model`` call per
    group); returns the list it appends one entry per prefill to.  With a
    ``logits`` dict, each admitted request's last-token logits (f32, on
    the host) are kept under its rid."""
    calls = []
    admit_group = eng._admit_group

    def counted(handles, slots):
        calls.append(len(handles))
        if logits is None:
            admit_group(handles, slots)
            return
        from repro_torch.models import transformer as T
        prefill = T.prefill_model

        def keep(*args, **kw):
            out = prefill(*args, **kw)
            for h, row in zip(handles, out[0][:, -1].float().cpu()):
                logits[h.rid] = row
            return out
        T.prefill_model = keep
        try:
            admit_group(handles, slots)
        finally:
            T.prefill_model = prefill
    eng._admit_group = counted
    return calls


def _check_main_path(cfg, counts, steps, prefills, what, n_quant=None):
    """The main path's launch counts: one fused append per quantized layer
    per decode step, two bulk quantizer launches per quantized layer per
    prefill, no call of any plain version, and the fp16 route on exactly
    the other layers (``n_quant`` quantized layers of ``cfg.n_layers``;
    all by default)."""
    nq = cfg.n_layers if n_quant is None else n_quant
    kq, f16 = counts["kv_quant"], counts["fp16"]
    check(kq["append"] == nq * steps,
          f"{what}: kv_append launches {kq['append']} != quantized layers "
          f"x steps = {nq * steps}")
    check(kq["kernel"] == 2 * nq * prefills,
          f"{what}: bulk kv_quant launches {kq['kernel']} != 2 x quantized "
          f"layers x prefills = {2 * nq * prefills}")
    check(counts["decode_attn"]["plain"] == 0 and kq["plain"] == 0
          and kq["append_plain"] == 0,
          f"{what}: the wrong version ran on the main path: {counts}")
    nf = cfg.n_layers - nq
    check(f16["attend"] == f16["append"] == nf * steps,
          f"{what}: fp16 route calls {f16} != fp16 layers x steps = "
          f"{nf * steps}")


def _serve_requests(cfg):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    return rng, [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                         max_new=SERVE_NEW, seed=i)
                 for i, n in enumerate(SERVE_LENS)]


def phase_serve(state):
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine
    dev = torch.device("cuda")
    cfg = configs.get("llama2_7b")
    t0 = time.monotonic()
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    state["params"] = params
    eng = Engine(params, cfg, PAPER_POLICY, batch_slots=SERVE_SLOTS,
                 max_len=MAX_LEN, steps_per_sync=SERVE_SPS, backend="cuda",
                 device=dev)
    chunks = _timed_chunks(eng)
    state["serve_logits"] = {}
    prefills = _counted_prefills(eng, state["serve_logits"])
    rng, reqs = _serve_requests(cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()                                    # main path only
    t0 = time.monotonic()
    handles = [eng.submit(r) for r in reqs]
    eng.run(handles)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    steps = eng.n_decode_steps
    check(all(h.finish_reason == "length" and len(h.tokens) == SERVE_NEW
              for h in handles),
          f"not every request finished with length: "
          f"{[(h.finish_reason, len(h.tokens)) for h in handles]}")
    check(all(0 <= t < cfg.vocab_size for h in handles for t in h.tokens),
          "token id out of range")
    check(counts["decode_attn"]["kernel"] == cfg.n_layers * steps,
          f"decode_attn launches {counts['decode_attn']} != layers x steps "
          f"= {cfg.n_layers * steps}")
    _check_main_path(cfg, counts, steps, len(prefills), "serve")
    peak = torch.cuda.max_memory_allocated()
    state["launches"] = {k: counts[k]["kernel"]
                         for k in ("decode_attn", "kv_quant")}
    state["launches"]["kv_append"] = counts["kv_quant"]["append"]
    state["serve_streams"] = [list(h.tokens) for h in handles]
    ttft = [(h.first_token_time - h.submit_time) * 1e3 for h in handles]

    # prefill of the longest prompt alone, synced
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (1, max(SERVE_LENS))), device=dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, _ = T.prefill_model(params, cfg, prompt, PAPER_POLICY,
                                calib=eng.calib, max_len=MAX_LEN,
                                backend="cuda")
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")

    # single decode steps of a 4-slot batch at STEP_CONTEXT, each between
    # two CUDA events; then one step on the cuda and reference backends
    # from the same cache
    batch = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                         (SERVE_SLOTS, STEP_CONTEXT)),
                            device=dev)
    _, base = T.prefill_model(params, cfg, batch, PAPER_POLICY,
                              calib=eng.calib, max_len=MAX_LEN,
                              backend="cuda")
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, 1)),
                          device=dev)
    clone = lambda c: {g: {k: v.clone() for k, v in d.items()}
                       for g, d in c.items()}
    step_caches = clone(base)
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(TIMED_STEPS + 1)]
    tk = tok
    torch.cuda.synchronize()
    marks[0].record()
    for i in range(TIMED_STEPS):
        lg, step_caches = T.decode_step(params, cfg, tk, step_caches,
                                        PAPER_POLICY, calib=eng.calib,
                                        backend="cuda")
        tk = lg[:, -1].argmax(-1, keepdim=True)
        marks[i + 1].record()
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    lc, _ = T.decode_step(params, cfg, tok, clone(base), PAPER_POLICY,
                          calib=eng.calib, backend="cuda")
    lr, _ = T.decode_step(params, cfg, tok, clone(base), PAPER_POLICY,
                          calib=eng.calib, backend="reference")
    lc, lr = lc[:, -1].float(), lr[:, -1].float()
    check(bool(torch.isfinite(lc).all() and torch.isfinite(lr).all()),
          "decode logits not finite")
    rel = float((lc - lr).norm() / lr.norm())
    top1 = float((lc.argmax(-1) == lr.argmax(-1)).float().mean())
    check(rel <= LOGIT_REL_TOL, f"cuda vs reference logits: relative L2 "
          f"{rel:.4f} > {LOGIT_REL_TOL}")
    tokens = sum(len(h.tokens) for h in handles)
    cache_b = T.cache_bytes(eng._caches)
    bf16_b = T.bf16_cache_bytes(cfg, SERVE_SLOTS, MAX_LEN)
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
          "params_init_s": round(init_s, 3), "requests": len(handles),
          "prompt_lens": SERVE_LENS, "max_new": SERVE_NEW,
          "slots": SERVE_SLOTS, "steps_per_sync": SERVE_SPS,
          "decode_steps": steps, "wall_s": wall,
          "tokens": tokens, "tokens_per_s": tokens / wall,
          "ttft_ms_p50": float(np.percentile(ttft, 50)),
          "prefill_ms_longest": prefill_ms,
          # the first chunk carries one-time warm-up: the spread is over
          # the others
          "engine_chunk_ms_per_step": [round(ms, 3) for ms, _ in chunks],
          "engine_chunk_active_slots": [n for _, n in chunks],
          "engine_ms_per_step": spread([ms for ms, _ in chunks[1:]]),
          "single_step_context": STEP_CONTEXT,
          "single_step_ms": spread(step_ms),
          "launches": counts, "peak_mem_bytes": peak,
          "cache_bytes": cache_b, "bf16_cache_bytes": bf16_b,
          "cache_ratio": cache_b / bf16_b, "logits_rel_l2": rel,
          "logits_rel_tol": LOGIT_REL_TOL, "top1_agreement": top1,
          "prefills": len(prefills)})


SHARED_PREFIX, SHARED_NEW = 2048, 32
SHARED_SUFFIXES = [128 * (i + 1) for i in range(8)]


def _pooled_run(state, cfg, reqs, pool_blocks):
    """Serve ``reqs`` through a pooled Engine with the counts set to 0
    just before; returns the engine, handles, counts, wall s, chunks.
    Engines of earlier runs are collected first (``_timed_chunks`` ties
    each into a reference cycle), so the peak is this run's own."""
    import gc
    import torch
    gc.collect()
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine
    eng = Engine(state["params"], cfg, PAPER_POLICY, batch_slots=SERVE_SLOTS,
                 max_len=MAX_LEN, steps_per_sync=SERVE_SPS, backend="cuda",
                 pool_blocks=pool_blocks, pool_block_tokens=POOL_BT,
                 device=torch.device("cuda"))
    chunks = _timed_chunks(eng)
    prefills = _counted_prefills(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()                                    # main path only
    t0 = time.monotonic()
    handles = [eng.submit(r) for r in reqs]
    eng.run(handles)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    steps = eng.n_decode_steps
    da = counts["decode_attn"]
    check(da["pooled"] == cfg.n_layers * steps and da["kernel"] == 0,
          f"pooled decode_attn launches {da} != layers x steps = "
          f"{cfg.n_layers * steps} on the block-table kernel alone")
    _check_main_path(cfg, counts, steps, len(prefills), "serve_pooled")
    check(all(h.finished and h.finish_reason == "length" for h in handles),
          f"not every pooled request finished with length: "
          f"{[(h.finish_reason, len(h.tokens)) for h in handles]}")
    audit = eng.check_invariants()
    st = eng.stats()
    check(st["used"] == 0 and st["reserved"] == 0,
          f"pool not drained: {st}")
    return eng, handles, counts, wall, chunks, audit


def _pool_report(eng, handles, counts, wall, chunks, audit):
    import numpy as np
    import torch
    st = eng.stats()
    tokens = sum(len(h.tokens) for h in handles)
    ttft = [(h.first_token_time - h.submit_time) * 1e3 for h in handles]
    return {"requests": len(handles), "decode_steps": eng.n_decode_steps,
            "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "engine_chunk_ms_per_step": [round(ms, 3) for ms, _ in chunks],
            "engine_chunk_active_slots": [n for _, n in chunks],
            "engine_ms_per_step": spread([ms for ms, _ in chunks[1:]]),
            "launches": counts,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "pool": {k: st[k] for k in (
                "pool_blocks", "pool_block_tokens", "peak_used",
                "prefix_hits", "prefix_misses", "prefix_hit_rate",
                "cow_copies", "peak_resident_bytes",
                "striped_worst_case_bytes")},
            "peak_over_striped": st["peak_resident_bytes"]
            / st["striped_worst_case_bytes"],
            "pool_exhausted_stalls": st["counters"]["pool_exhausted_stalls"],
            "admitted": st["counters"]["admitted"],
            "pool_bytes": eng.backend_info["pool_bytes"], "audit": audit}


def phase_serve_pooled(state):
    import numpy as np
    from repro_torch import configs
    from repro_torch.serving import Request
    cfg = configs.get("llama2_7b")
    # (a) the serve phase's traffic, EAGER_NEW_FAMILY tokens a request
    # (across one sync): streams the striped run's first tokens; serve_graph
    # holds the replayed pooled streams to the striped ones in full
    reqs = _eager_requests(cfg)
    run = _pooled_run(state, cfg, reqs, 768)
    streams = [list(h.tokens) for h in run[1]]
    same = [b[:EAGER_NEW_FAMILY] == a
            for a, b in zip(streams, state["serve_streams"])]
    check(all(same) and all(len(a) == EAGER_NEW_FAMILY for a in streams),
          f"pooled streams differ from the striped serve phase "
          f"(request equal: {same})")
    rep_a = _pool_report(*run)
    del run
    # (b) one shared system prompt, distinct suffixes
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, SHARED_PREFIX)
    reqs = [Request(prompt=np.concatenate(
                [prefix, rng.integers(0, cfg.vocab_size, n)]),
                max_new=SHARED_NEW, seed=i)
            for i, n in enumerate(SHARED_SUFFIXES)]
    run = _pooled_run(state, cfg, reqs, 512)
    rep_b = _pool_report(*run)
    state["launches"]["decode_attn_pooled"] = \
        run[2]["decode_attn"]["pooled"]
    del run
    check(rep_b["pool"]["prefix_hit_rate"] > 0,
          f"shared-prefix traffic hit no resident block: {rep_b['pool']}")
    check(rep_b["peak_over_striped"] < 0.5,
          f"peak resident packed bytes {rep_b['pool']['peak_resident_bytes']}"
          f" not under half the striped worst case "
          f"{rep_b['pool']['striped_worst_case_bytes']}")
    emit({"phase": "serve_pooled", "arch": cfg.name, "max_len": MAX_LEN,
          "slots": SERVE_SLOTS, "steps_per_sync": SERVE_SPS,
          "same_traffic": dict(rep_a, prompt_lens=SERVE_LENS,
                               max_new=EAGER_NEW_FAMILY,
                               streams_equal=True),
          "shared_prefix": dict(rep_b, prefix=SHARED_PREFIX,
                                suffixes=SHARED_SUFFIXES,
                                max_new=SHARED_NEW)})


GRAPH_ABBA_ROUNDS = 1
ABBA_NEW = 1024          # budget of the timing requests: 4 x 192 blocks


def _graph_engine(state, cfg, pool_blocks=None, async_host=False,
                  prefill_chunk=None, policy=None, calib=None, **engine_kw):
    """A warmed Engine (DESIGN.md §10) at the serve shape (chunked
    admission with ``prefill_chunk``; PAPER_POLICY unless ``policy``, a
    policy or a schedule, is given; identity calibration unless ``calib``
    is a stacked table; ``engine_kw`` passes the degradation arguments of
    DESIGN.md §11); engines of earlier runs that nothing holds are
    collected first, so their memory is free."""
    import gc
    import torch
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.serving import Engine
    gc.collect()
    torch.cuda.empty_cache()
    eng = Engine(state["params"], cfg, policy or PAPER_POLICY,
                 batch_slots=SERVE_SLOTS,
                 max_len=MAX_LEN, steps_per_sync=SERVE_SPS, backend="cuda",
                 pool_blocks=pool_blocks, pool_block_tokens=POOL_BT,
                 async_host=async_host, prefill_chunk=prefill_chunk,
                 calib=calib, device=torch.device("cuda"), **engine_kw)
    rep = eng.warmup()
    check(rep["n_graphs"] == 1 and rep["post_warmup_misses"] == 0,
          f"warmup captured no decode step: {rep}")
    return eng, rep


def _n_quant(eng) -> int:
    """Quantized layers of an engine's schedule."""
    return sum(not p.is_fp16 for p in eng.schedule)


def _check_graph_path(cfg, eng, counts, prefills, what):
    """The launch identities with graphs on: every decode step a replay,
    one decode_attn launch per quantized layer per step on the layout's
    kernel, and the main path's kv_quant and fp16-route identities."""
    steps, nq = eng.n_decode_steps, _n_quant(eng)
    da = counts["decode_attn"]
    mode = "pooled" if eng.stats()["pooled"] else "kernel"
    check(da[mode] == nq * steps and da["plain"] == 0
          and sum(da.values()) == da[mode],
          f"{what}: decode_attn launches {da} != quantized layers x steps = "
          f"{nq * steps} on the {mode} kernel alone")
    _check_main_path(cfg, counts, steps, len(prefills), what, nq)
    rep = eng.warmup_report()
    check(rep["replays"] == steps, f"{what}: {rep['replays']} replays for "
          f"{steps} decode steps")
    check(rep["post_warmup_misses"] == 0,
          f"{what}: post-warmup graph misses {rep['cold_names']}")


def _graph_serve(state, cfg, pool_blocks):
    """(a) the serve phase's requests through a warmed Engine: streams
    bitwise equal to the eager serve phase's, counts with graphs on."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    eng, warm = _graph_engine(state, cfg, pool_blocks)
    chunks = _timed_chunks(eng)
    prefills = _counted_prefills(eng)
    _, reqs = _serve_requests(cfg)
    torch.cuda.synchronize()
    reset_launch_counts()                                    # main path only
    t0 = time.monotonic()
    handles = [eng.submit(r) for r in reqs]
    eng.run(handles)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    what = f"serve_graph {'pooled' if pool_blocks else 'striped'}"
    _check_graph_path(cfg, eng, counts, prefills, what)
    streams = [list(h.tokens) for h in handles]
    same = [a == b for a, b in zip(streams, state["serve_streams"])]
    check(all(same), f"{what}: replayed streams differ from the eager serve "
          f"phase's (request equal: {same})")
    if pool_blocks:
        eng.check_invariants()
    tokens = sum(len(h.tokens) for h in handles)
    return eng, {"warmup": warm, "decode_steps": eng.n_decode_steps,
                 "wall_s": wall, "tokens": tokens,
                 "tokens_per_s": tokens / wall,
                 "engine_chunk_ms_per_step": [round(ms, 3)
                                              for ms, _ in chunks],
                 "engine_ms_per_step": spread([ms for ms, _ in chunks[1:]]),
                 "launches": counts, "prefills": len(prefills),
                 "streams_equal_eager": True}


def _load_slots(eng, cfg):
    """Admit SERVE_SLOTS requests of STEP_CONTEXT seeded tokens (the same
    prompts on every engine) and run their first chunk."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(2)
    for i in range(SERVE_SLOTS):
        eng.submit(Request(prompt=rng.integers(0, cfg.vocab_size,
                                               STEP_CONTEXT),
                           max_new=ABBA_NEW, seed=i))
    eng.step()
    check(eng.active_slots == SERVE_SLOTS, "ABBA engine: slots not admitted")


def _abba(runs, rounds=GRAPH_ABBA_ROUNDS):
    """``runs`` {name: chunk fn} for two names A, B, called A B B A per
    round; host wall time of each chunk, synchronized before and after,
    in ms per step."""
    import torch
    a, b = runs
    times = {a: [], b: []}
    for _ in range(rounds):
        for name in (a, b, b, a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3 / SERVE_SPS)
    out = {name: spread(t) for name, t in times.items()}
    out["order"] = f"ABBA (A {a}, B {b}), ms per step"
    out[f"{b}_over_{a}"] = out[b]["mean"] / out[a]["mean"]
    return out


def _graph_timings(eng_s, eng_p, cfg):
    """(b) at SERVE_SLOTS x STEP_CONTEXT, whole Engine chunks striped
    against pooled, both replayed; (c) CUDA-event times and the profiler
    over replayed chunks."""
    import numpy as np
    import torch
    for eng in (eng_s, eng_p):
        _load_slots(eng, cfg)
    dev = eng_s.device
    tok = torch.as_tensor(eng_s._tok, device=dev)
    done = torch.zeros(SERVE_SLOTS, dtype=torch.bool, device=dev)
    temps = torch.zeros(SERVE_SLOTS, dtype=torch.float32, device=dev)
    eos = torch.full((SERVE_SLOTS,), -1, dtype=torch.int64, device=dev)
    host_t = np.zeros(SERVE_SLOTS, np.float32)
    gens = [None] * SERVE_SLOTS
    graph = lambda: eng_s._decode_steps(SERVE_SPS, tok, done, temps, eos,
                                        gens, host_t)
    vs_pooled = _abba({"striped": eng_s._decode_chunk,
                       "pooled": eng_p._decode_chunk})
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    for e in ev[1:]:
        graph()
        e.record()
    torch.cuda.synchronize()
    event_ms = spread([a.elapsed_time(b) / SERVE_SPS
                        for a, b in zip(ev, ev[1:])])
    prof = _profile_decode(graph)
    per_step = {k: prof[k] / SERVE_SPS for k in (
        "wall_ms_per_step", "device_ms_per_step", "kernels_per_step")}
    return vs_pooled, event_ms, prof, per_step


def phase_serve_graph(state):
    from repro_torch import configs
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (MetricsRecorder, poisson_trace,
                                     run_open_loop)
    cfg = configs.get("llama2_7b")
    eng_s, striped = _graph_serve(state, cfg, None)
    eng_p, pooled = _graph_serve(state, cfg, 768)
    vs_pooled, event_ms, prof, per_step = _graph_timings(
        eng_s, eng_p, cfg)
    state["replay_ms"] = event_ms["mean"]       # the analytic phase's share
    del eng_s, eng_p
    if per_step["kernels_per_step"] > 0 and per_step["device_ms_per_step"]:
        busy = {"source": "torch.profiler over replays",
                "busy_share": prof["device_busy_share"]}
    else:
        busy = {"source": "not measured: the profiler saw no kernel under "
                          "replay", "busy_share": None}
    # (d) open-loop Poisson traffic, warmed pooled Engine, async host loop
    eng, warm = _graph_engine(state, cfg, 768, async_host=True)
    chunks = _timed_chunks(eng)
    prefills = _counted_prefills(eng)
    spec = _open_loop_spec(cfg)
    trace = poisson_trace(spec)
    rec = MetricsRecorder()
    reset_launch_counts()                                    # main path only
    handles, makespan = run_open_loop(eng, trace, rec)
    counts = launch_counts()
    _check_graph_path(cfg, eng, counts, prefills, "serve_graph open loop")
    check(all(h.finished and h.finish_reason == "length"
              and len(h.tokens) == a.request.max_new
              for h, a in zip(handles, trace)),
          f"open loop: not every request finished: "
          f"{[(h.finish_reason, len(h.tokens)) for h in handles]}")
    audit = eng.check_invariants()
    st = eng.stats()
    check(st["used"] == 0 and st["reserved"] == 0, f"pool not drained: {st}")
    eng.close()
    summary = rec.summary(sla_ttft_ms=SLA_TTFT_MS, sla_tpot_ms=SLA_TPOT_MS)
    state["open_loop_whole"] = _open_loop_summary(
        summary, handles, trace, makespan, eng.n_decode_steps)
    emit({"phase": "serve_graph", "arch": cfg.name, "max_len": MAX_LEN,
          "slots": SERVE_SLOTS, "steps_per_sync": SERVE_SPS,
          "striped": striped, "pooled": pooled,
          "abba_striped_vs_pooled": vs_pooled,
          "replay_event_ms_per_step": event_ms,
          "replay_profile": dict(prof, per_step=per_step),
          "busy": busy,
          "open_loop": {"spec": _spec_dict(spec),
                        "makespan_s": makespan, "warmup": warm,
                        "decode_steps": eng.n_decode_steps,
                        "prefills": len(prefills), "launches": counts,
                        "engine_ms_per_step": spread(
                            [ms for ms, _ in chunks[1:]] or [0.0]),
                        "stats": st, "audit": audit, "summary": summary}})


CHUNK = 512                       # prefill_chunk of the serve_chunked phase
CHUNK_PROMPT = 3000               # the longest serve prompt: 5 x 512 + 440


def _chunk_plan(lens, chunk=CHUNK):
    """(t0, n_valid) of every chunk the Engine runs for prompts of ``lens``
    tokens, in order."""
    return [(t0, min(chunk, n - t0)) for n in lens
            for t0 in range(0, n, chunk)]


def _evicting_chunks(lens, chunk=CHUNK):
    """Chunks of those prompts that evict at least one row (each costs two
    bulk kv_quant launches a layer)."""
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.kernels.kv_quant import chunk_evictions
    return sum(lo < hi for lo, hi in (chunk_evictions(PAPER_POLICY, t0, n)
                                      for t0, n in _chunk_plan(lens, chunk)))


def _chunk_bound(pol, hkv, d, t0, n):
    """Bytes and bound of one chunk append: the evicted rows read once
    (ring or chunk) and their packed rows written, the chunk rows that
    land in the ring or the sinks read and written, the clip factors; or
    the f32 operations of quantizing the evicted rows."""
    from repro_torch.core.quant import n_meta_groups, packed_nbytes
    from repro_torch.kernels.kv_quant import chunk_evictions
    lo, hi = chunk_evictions(pol, t0, n)
    n_ev = max(0, hi - lo)
    end = t0 + n
    n_fp = max(0, min(pol.n_sink, end) - t0) + max(
        0, end - max(pol.n_sink, end - pol.window, t0))
    gsz = min(pol.group_size, d)
    row = 2 * hkv * d * 2                       # K + V rows, bf16
    packed = hkv * (packed_nbytes(d, pol.bits_k, gsz, 8)
                    + packed_nbytes(d, pol.bits_v, gsz, 8))
    nbytes = (n_ev * (row + packed) + 2 * n_fp * row + 4 * hkv
              * (n_meta_groups(d, pol.bits_k, gsz)
                 + n_meta_groups(d, pol.bits_v, gsz)))
    return nbytes, *bound(nbytes, 7 * 2 * n_ev * hkv * d)


def _chunk_append_case(gen, dev):
    """(a) One layer of llama2-7b (32 heads x 128, PAPER_POLICY, max_len
    4229, bf16): a 3000-token prompt in chunks of 512 (the tail of 440
    padded to 512) through ``kv_append_chunk``, its plain token loop and a
    loop of ``kv_append``: every leaf byte-equal after every chunk; then
    L2-cold device ms of one evicting chunk append against its bound."""
    import torch
    from repro_torch.core import kv_cache as kvc
    from repro_torch.core.policy import PAPER_POLICY as pol
    from repro_torch.core.quant import n_meta_groups
    from repro_torch.kernels import kv_quant as KQ
    hkv, d = 32, 128
    caches = [kvc.init_cache(1, MAX_LEN, hkv, d, pol, torch.bfloat16,
                             device=dev) for _ in range(3)]
    route, plain, loop = caches
    ak, av = (0.8 + 0.2 * torch.rand((hkv, n_meta_groups(d, b, 128)),
                                     generator=gen, device=dev)
              for b in (pol.bits_k, pol.bits_v))
    new = lambda: torch.randn((1, CHUNK, hkv, d), generator=gen,
                              device=dev).to(torch.bfloat16)
    chunks, launches = [], 0
    for t0, n in _chunk_plan([CHUNK_PROMPT]):
        k, v = new(), new()
        before = KQ.LAUNCHES["kernel"]
        KQ.kv_append_chunk(route, k, v, pol, t0, n, ak, av)
        launches += KQ.LAUNCHES["kernel"] - before
        KQ.kv_append_chunk_plain(plain, k, v, pol, t0, n, ak, av)
        for i in range(n):
            KQ.kv_append(loop, k[:, i:i + 1].contiguous(),
                         v[:, i:i + 1].contiguous(), pol, ak, av)
        bad = (_caches_differ(route, plain, False)
               + _caches_differ(route, loop, False))
        check(not bad, f"kv_append_chunk t0={t0} n={n}: leaves {bad} differ "
              f"from the plain loop or the kv_append loop")
        chunks.append({"t0": t0, "n_valid": n, "bucket": CHUNK,
                       "diff_leaves": 0})
    check(launches == 2 * _evicting_chunks([CHUNK_PROMPT]),
          f"kv_append_chunk: {launches} bulk launches for "
          f"{_evicting_chunks([CHUNK_PROMPT])} evicting chunks")
    # timing: a chunk at t0 = 2048 (512 rows evicted: 128 from the ring,
    # 384 from the chunk), rotating over cache copies
    t0 = 2048
    k, v = new(), new()
    for c in caches:
        c["length"].fill_(t0)
    nbytes, bound_ms, bound_by = _chunk_bound(pol, hkv, d, t0, CHUNK)
    cs = copies(route)
    ms = cuda_ms([lambda c=c: KQ.kv_append_chunk(c, k, v, pol, t0, CHUNK,
                                                 ak, av) for c in cs])
    del cs
    plain_ms = cuda_ms(lambda: KQ.kv_append_chunk_plain(
        plain, k, v, pol, t0, CHUNK, ak, av), iters=1, warmup=0)
    loop_ms = cuda_ms(lambda: [KQ.kv_append(
        loop, k[:, i:i + 1].contiguous(), v[:, i:i + 1].contiguous(), pol,
        ak, av) for i in range(CHUNK)], iters=1, warmup=1)
    del caches, route, plain, loop
    torch.cuda.empty_cache()
    return {"hkv": hkv, "d": d, "max_len": MAX_LEN, "prompt": CHUNK_PROMPT,
            "chunks": chunks, "bulk_launches": launches,
            "timed": {"t0": t0, "n_valid": CHUNK, "ms": ms,
                      "bytes": nbytes, "bound_ms": bound_ms,
                      "bound_by": bound_by, "bound_share": bound_ms / ms,
                      "plain_ms": plain_ms, "kv_append_loop_ms": loop_ms,
                      "timing": "route: device time rotating over "
                                f"{L2_COPIES} cache copies; plain token "
                                "loop and kv_append loop: one call between "
                                "CUDA events (host-bound)"}}


def _check_chunked_path(cfg, eng, counts, n_evicting, what, n_chunks=0):
    """The main path's identities with chunked admission: two bulk
    kv_quant launches a quantized layer per evicting chunk, one kv_append a
    quantized layer per decode step on the layout's decode_attn kernel, the
    fp16 route on the other layers (one chunk append per chunk of the
    ``n_chunks``, one attend and one append per step), one replay per
    step, no plain call and no graph miss."""
    steps, nq = eng.n_decode_steps, _n_quant(eng)
    nf = cfg.n_layers - nq
    kq, da, f16 = counts["kv_quant"], counts["decode_attn"], counts["fp16"]
    mode = "pooled" if eng.stats()["pooled"] else "kernel"
    check(kq["kernel"] == 2 * nq * n_evicting,
          f"{what}: bulk kv_quant launches {kq['kernel']} != 2 x quantized "
          f"layers x evicting chunks = {2 * nq * n_evicting}")
    check(kq["append"] == nq * steps,
          f"{what}: kv_append launches {kq['append']} != quantized layers x "
          f"steps = {nq * steps}")
    check(da[mode] == nq * steps and sum(da.values()) == da[mode],
          f"{what}: decode_attn launches {da} != quantized layers x steps on "
          f"the {mode} kernel alone")
    check(kq["plain"] == kq["append_plain"] == kq["chunk_plain"] == 0,
          f"{what}: a plain version ran on the main path: {counts}")
    check(f16["attend"] == f16["append"] == nf * steps
          and f16["chunk_append"] == nf * n_chunks,
          f"{what}: fp16 route calls {f16} != {nf} fp16 layers x {steps} "
          f"steps / {n_chunks} chunks")
    rep = eng.warmup_report()
    check(rep["replays"] == steps and rep["post_warmup_misses"] == 0,
          f"{what}: {rep['replays']} replays for {steps} steps, misses "
          f"{rep['cold_names']}")


def _chunked_serve(state, cfg, pool_blocks):
    """(b) The serve phase's requests through a warmed chunked Engine; the
    final-chunk logits of each request kept by rid."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    eng, warm = _graph_engine(state, cfg, pool_blocks, prefill_chunk=CHUNK)
    logits = {}
    finish = eng._finish_prefill

    def keep(job, lg):
        logits[job.handle.rid] = lg[0, -1].float().cpu()
        finish(job, lg)
    eng._finish_prefill = keep
    _, reqs = _serve_requests(cfg)
    torch.cuda.synchronize()
    reset_launch_counts()                                    # main path only
    t0 = time.monotonic()
    handles = [eng.submit(r) for r in reqs]
    eng.run(handles)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    what = f"serve_chunked {'pooled' if pool_blocks else 'striped'}"
    _check_chunked_path(cfg, eng, counts, _evicting_chunks(SERVE_LENS), what)
    check(all(h.finished and h.finish_reason == "length"
              and len(h.tokens) == SERVE_NEW for h in handles),
          f"{what}: not every request finished: "
          f"{[(h.finish_reason, len(h.tokens)) for h in handles]}")
    if pool_blocks:
        eng.check_invariants()
    ttft = [(h.first_token_time - h.submit_time) * 1e3 for h in handles]
    tokens = sum(len(h.tokens) for h in handles)
    return ([list(h.tokens) for h in handles], [logits[h.rid]
                                                 for h in handles],
            {"warmup": warm, "wall_s": wall, "tokens": tokens,
             "tokens_per_s": tokens / wall, "decode_steps":
             eng.n_decode_steps, "ttft_ms": spread(ttft),
             "buckets_run": list(eng.prefill_shapes), "launches": counts})


def _open_loop_run(state, cfg):
    """(c) serve_graph (d)'s open-loop trace on a warmed pooled async
    Engine with chunked admission: the launch identities, every request
    finished, a clean audit; the SLA summary."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (MetricsRecorder, poisson_trace,
                                     run_open_loop)
    eng, _ = _graph_engine(state, cfg, 768, async_host=True,
                           prefill_chunk=CHUNK)
    trace = poisson_trace(_open_loop_spec(cfg))
    rec = MetricsRecorder()
    reset_launch_counts()                                    # main path only
    handles, makespan = run_open_loop(eng, trace, rec)
    counts = launch_counts()
    what = f"serve_chunked open loop chunk={CHUNK}"
    _check_chunked_path(cfg, eng, counts, _evicting_chunks(
        [len(a.request.prompt) for a in trace], CHUNK), what)
    check(all(h.finished and h.finish_reason == "length"
              and len(h.tokens) == a.request.max_new
              for h, a in zip(handles, trace)),
          f"{what}: not every request finished")
    eng.check_invariants()
    eng.close()
    s = rec.summary(sla_ttft_ms=SLA_TTFT_MS, sla_tpot_ms=SLA_TPOT_MS)
    return _open_loop_summary(s, handles, trace, makespan,
                              eng.n_decode_steps)


def _open_loop_summary(s, handles, trace, makespan, steps):
    """The latency percentiles of an open-loop run's SLA summary ``s``,
    its makespan and decode steps, the mean TTFT of its longest prompts
    and the SLA attainment."""
    import numpy as np
    out = {k: s[k] for k in ("ttft_ms", "tpot_ms", "queue_wait_ms",
                             "e2e_ms")}
    longest = [(h.first_token_time - h.submit_time) * 1e3
               for h, a in zip(handles, trace)
               if len(a.request.prompt) == max(len(b.request.prompt)
                                               for b in trace)]
    out.update(makespan_s=makespan, decode_steps=steps,
               ttft_ms_longest_prompts=float(np.mean(longest)),
               attainment=s.get("goodput", {}).get("attainment"))
    return out


def _open_loop_spec(cfg):
    from repro_torch.serving import WorkloadSpec
    return WorkloadSpec(n_requests=8, arrival_rate=2.0,
                        prompt_lens=(512, 1024, 2048, 3000),
                        max_news=(16, 32, 64), shared_prefix_ratio=0.5,
                        shared_prefix_len=256, vocab=cfg.vocab_size, seed=0)


def _prefill_ms_both_ways(state, cfg):
    """Synced host ms of the 3000-token prompt's prefill, whole
    (``prefill_model``) and chunked (six ``prefill_chunk`` calls, each
    timed), alternating whole, chunked, chunked, whole."""
    import numpy as np
    import torch
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.models import transformer as T
    dev = torch.device("cuda")
    params = state["params"]
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                               CHUNK_PROMPT)
    st = T.prefill_chunk_init(cfg, PAPER_POLICY, MAX_LEN, MAX_LEN,
                              dtype=torch.bfloat16, device=dev)

    def whole():
        toks = torch.as_tensor(prompt[None], device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.prefill_model(params, cfg, toks, PAPER_POLICY, max_len=MAX_LEN,
                        backend="cuda")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def chunked():
        for leaf in st["caches"]["scan"].values():
            leaf.zero_()
        per = []
        for t0, n in _chunk_plan([CHUNK_PROMPT]):
            toks = np.zeros(CHUNK, np.int64)
            toks[:n] = prompt[t0:t0 + n]
            toks = torch.as_tensor(toks[None], device=dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            T.prefill_chunk(params, cfg, toks, st, PAPER_POLICY, t0, n,
                            backend="cuda")
            torch.cuda.synchronize()
            per.append((time.perf_counter() - t) * 1e3)
        return per

    whole()                                                   # warm-up
    runs = {"whole": [], "chunked": []}
    for name in ("whole", "chunked", "chunked", "whole"):
        runs[name].append(whole() if name == "whole" else chunked())
    del st
    torch.cuda.empty_cache()
    return {"whole_ms": runs["whole"],
            "chunked_ms": [sum(p) for p in runs["chunked"]],
            "chunked_ms_per_chunk": [[round(x, 2) for x in p]
                                     for p in runs["chunked"]],
            "order": "whole, chunked, chunked, whole (synced host ms)"}


def phase_serve_chunked(state):
    import torch
    from repro_torch import configs
    cfg = configs.get("llama2_7b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    append = _chunk_append_case(gen, dev)
    # (b) chunked engines, striped then pooled
    s_streams, s_logits, striped = _chunked_serve(state, cfg, None)
    p_streams, p_logits, pooled = _chunked_serve(state, cfg, 768)
    same = [a == b for a, b in zip(p_streams, s_streams)]
    check(all(same), f"serve_chunked: pooled streams differ from striped "
          f"chunked streams (request equal: {same})")
    whole = [state["serve_logits"][i] for i in range(len(SERVE_LENS))]
    rel = [float((c - w).norm() / w.norm()) for c, w in zip(s_logits, whole)]
    top1 = [bool(c.argmax() == w.argmax()) for c, w in zip(s_logits, whole)]
    check(max(rel) <= LOGIT_REL_TOL and all(
        bool(torch.isfinite(c).all()) for c in s_logits),
          f"serve_chunked: final-chunk logits vs whole-prompt relative L2 "
          f"{max(rel):.4f} > {LOGIT_REL_TOL}")
    streams_equal = [a == b for a, b in zip(s_streams,
                                            state["serve_streams"])]
    for run in (striped, pooled):
        kq, da = run["launches"]["kv_quant"], run["launches"]["decode_attn"]
        state["launches"]["kv_quant"] += kq["kernel"]
        state["launches"]["kv_append"] += kq["append"]
        state["launches"]["decode_attn"] += da["kernel"]
        state["launches"]["decode_attn_pooled"] += da["pooled"]
    prefill = _prefill_ms_both_ways(state, cfg)
    # (c) the open-loop trace chunked; serve_graph (d) ran it whole-prompt
    chunked_loop = _open_loop_run(state, cfg)
    tm = state["kv_quant"]
    timed = append["timed"]
    tm.update(chunk_ms=timed["ms"], chunk_bound_ms=timed["bound_ms"],
              chunk_plain_ms=timed["plain_ms"], chunk_rows=CHUNK)
    emit({"phase": "serve_chunked", "arch": cfg.name, "max_len": MAX_LEN,
          "prefill_chunk": CHUNK, "chunk_append": append,
          "engines": {"striped": striped, "pooled": pooled,
                      "pooled_streams_equal_striped": True,
                      "evicting_chunks": _evicting_chunks(SERVE_LENS),
                      "final_logits_rel_l2_vs_whole": rel,
                      "final_logits_rel_tol": LOGIT_REL_TOL,
                      "top1_agreement_vs_whole": sum(top1) / len(top1),
                      "streams_equal_whole": streams_equal},
          "prefill_3000": prefill,
          "open_loop": {"spec": _spec_dict(_open_loop_spec(cfg)),
                        "chunked": chunked_loop,
                        "whole": dict(state.pop("open_loop_whole"),
                                      run="serve_graph (d)")}})


# ------------------------------------------- calibrate (paper Sec. 3.1)

CALIB_PROMPTS, CALIB_LEN = 8, 512       # 4096 samples a layer
CALIB_CHECK_LAYERS = (0, 31)            # held to the plain route
RECON_LEN = 2048                        # the reconstruction-error prompt


def _calib_tokens(cfg, dev):
    """The calibration prompts: CALIB_PROMPTS x CALIB_LEN tokens of
    ``SyntheticCorpus(vocab, seed=0)`` drawn with rngs 100, 101, ..."""
    import numpy as np
    import torch
    from repro_torch.data import SyntheticCorpus
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    return torch.as_tensor(np.stack([
        corpus.sample(CALIB_LEN, np.random.default_rng(100 + i))
        for i in range(CALIB_PROMPTS)]), device=dev)


def _timed_search():
    """Time calibration's clip search (``calibrate._group_mse_alpha``,
    on the device; it ends in a host copy, so its wall time is the
    device's): returns the list of seconds each call appends to and the
    function that restores the search."""
    from repro_torch.core import calibrate as C
    search = C._group_mse_alpha
    secs = []

    def timed(*args, **kw):
        t = time.monotonic()
        out = search(*args, **kw)
        secs.append(time.monotonic() - t)
        return out
    C._group_mse_alpha = timed
    return secs, lambda: setattr(C, "_group_mse_alpha", search)


def _same_table(a, b) -> bool:
    """Equal permutations and bitwise-equal clip factors of two
    LayerCalibrations."""
    import numpy as np
    return (all(np.array_equal(getattr(a, f), getattr(b, f))
                for f in ("perm_k", "perm_v"))
            and all(np.array_equal(getattr(a, f).view(np.uint32),
                                   getattr(b, f).view(np.uint32))
                    for f in ("alpha_k", "alpha_v")))


def _calib_launch(ks, perm, bits):
    """One clip-search launch of the bulk kernel at the calibration's
    shape: a layer's 4096 x 32 samples reordered, as f32 rows x 128, one
    shared clip factor; L2-cold ms over 4 copies against the plain
    version, and the byte bound."""
    import numpy as np
    import torch
    from repro_torch.kernels import kv_quant as KQ
    idx = torch.from_numpy(perm).to(ks.device).long()
    x = torch.gather(ks, 2, idx[None].expand(ks.shape)).float()
    x = x.reshape(-1, ks.shape[-1])
    alpha = torch.tensor(np.float32(0.9), device=ks.device)
    d = x.shape[1]
    got = KQ.kv_quant(x, bits, d, alpha)
    want = KQ.kv_quant_plain(x, bits, d, alpha)
    diff = sum(int((got[k].view(torch.uint8) != want[k].view(torch.uint8)
                    ).sum()) for k in want)
    check(diff == 0, f"calibrate: kv_quant at the calibration shape, bits "
          f"{bits}: {diff} bytes differ from the plain version")
    xs = [x] + [x.clone() for _ in range(L2_COPIES - 1)]
    ms = cuda_ms([lambda c=c: KQ.kv_quant(c, bits, d, alpha) for c in xs])
    plain_ms = cuda_ms([lambda c=c: KQ.kv_quant_plain(c, bits, d, alpha)
                        for c in xs], iters=4, warmup=1)
    g_total = sum(v.shape[-1] for k, v in got.items()
                  if k.startswith("scale"))
    out_b = sum(v.numel() * v.element_size() for v in got.values())
    in_b = x.numel() * x.element_size() + 4 * g_total
    bound_ms, bound_by = bound(in_b + out_b, 7 * x.numel())
    del xs, x, got, want
    torch.cuda.empty_cache()
    return {"rows": ks.shape[0] * ks.shape[1], "d": d, "bits": bits,
            "dtype": "float32", "alpha": "one shared (0.9)",
            "diff_bytes": diff, "ms": ms, "plain_ms": plain_ms,
            "bytes": in_b + out_b, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms}


def _calibrate_run(state, cfg):
    """(a) collect_kv over the calibration prompts, then calibrate_model
    on the kernel route: seconds by part, the kv_quant launches (2 x 11
    grid points x layers, no plain call), the plain route on the card
    equal for CALIB_CHECK_LAYERS (gated), the CPU's table for the first
    of them and the clip-factor histogram (reported)."""
    import numpy as np
    import torch
    from repro_torch.core import calibrate as C
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.core.quant import quantize_groups
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as T
    dev = torch.device("cuda")
    toks = _calib_tokens(cfg, dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ks, vs = T.collect_kv(state["params"], cfg, toks)
    torch.cuda.synchronize()
    collect_s = time.monotonic() - t0
    n = CALIB_PROMPTS * CALIB_LEN
    check(ks.shape == vs.shape == (cfg.n_layers, n, cfg.n_kv_heads,
                                   cfg.head_dim)
          and ks.dtype == torch.bfloat16
          and bool(torch.isfinite(ks).all() and torch.isfinite(vs).all()),
          f"calibrate: collect_kv gave {tuple(ks.shape)} {ks.dtype}")
    secs, restore = _timed_search()
    torch.cuda.synchronize()
    reset_launch_counts()                    # the calibration path only
    t0 = time.monotonic()
    try:
        cal = C.calibrate_model(lambda: (ks, vs), PAPER_POLICY)
    finally:
        restore()
    total_s = time.monotonic() - t0
    counts = launch_counts()
    want = 2 * len(C.ALPHA_GRID) * cfg.n_layers
    kq = counts["kv_quant"]
    check(kq["kernel"] == want and kq["plain"] == 0
          and sum(kq.values()) == want
          and sum(counts["decode_attn"].values()) == 0,
          f"calibrate: launches {counts} != {want} bulk kv_quant launches "
          f"(2 x {len(C.ALPHA_GRID)} grid points x {cfg.n_layers} layers) "
          f"and nothing else")
    gated, cpu = {}, {}
    for l in CALIB_CHECK_LAYERS:
        plain = C.calibrate_layer(ks[l], vs[l], PAPER_POLICY, seed=31 * l,
                                  quant_fn=quantize_groups)
        check(_same_table(plain, cal.layers[l]),
              f"calibrate: layer {l}: the kernel route's table differs from "
              f"the plain route's on the card")
        gated[str(l)] = "equal"
        if l != CALIB_CHECK_LAYERS[0]:          # the CPU's table: one layer
            continue
        t0 = time.monotonic()
        host = C.calibrate_layer(ks[l].cpu(), vs[l].cpu(), PAPER_POLICY,
                                 seed=31 * l)
        got = cal.layers[l]
        cpu[str(l)] = {
            "perms_differ": int((host.perm_k != got.perm_k).sum()
                                + (host.perm_v != got.perm_v).sum()),
            "alpha_k_flips": int((host.alpha_k != got.alpha_k).sum()),
            "alpha_v_flips": int((host.alpha_v != got.alpha_v).sum()),
            "cpu_s": time.monotonic() - t0}
    hist = {}
    for f in ("alpha_k", "alpha_v"):
        vals = np.concatenate([getattr(l, f).reshape(-1) for l in cal.layers])
        hist[f] = {f"{a:g}": int((vals == np.float32(a)).sum())
                   for a in C.ALPHA_GRID}
    perms_moved = {f: int(sum((getattr(l, f) != np.arange(cfg.head_dim)
                               ).any(-1).sum() for l in cal.layers))
                   for f in ("perm_k", "perm_v")}
    launch = [_calib_launch(ks[0], cal.layers[0].perm_k, PAPER_POLICY.bits_k),
              _calib_launch(vs[0], cal.layers[0].perm_v, PAPER_POLICY.bits_v)]
    del ks, vs
    torch.cuda.empty_cache()
    rep = {"prompts": CALIB_PROMPTS, "prompt_len": CALIB_LEN,
           "samples_per_layer": n, "collect_s": collect_s,
           "calibrate_s": total_s, "clip_search_device_s": sum(secs),
           "host_features_kmeans_s": total_s - sum(secs),
           "launches": counts, "launches_expected": want,
           "plain_route_on_card": gated, "cpu_tables": cpu,
           "alpha_histogram": hist, "heads_reordered": perms_moved,
           "kv_quant_launch": launch}
    return cal, rep


def _calib_serve(state, cfg, table, pool_blocks):
    """(b) the serve phase's 8 requests through a warmed Engine serving
    the calibrated table: every request finished, the launch identities,
    no graph miss, a clean audit when pooled."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    eng, warm = _graph_engine(state, cfg, pool_blocks, calib=table)
    prefills = _counted_prefills(eng)
    _, reqs = _serve_requests(cfg)
    torch.cuda.synchronize()
    reset_launch_counts()                                    # main path only
    t0 = time.monotonic()
    handles = [eng.submit(r) for r in reqs]
    eng.run(handles)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    what = f"calibrate {'pooled' if pool_blocks else 'striped'}"
    _check_graph_path(cfg, eng, counts, prefills, what)
    check(all(h.finished and h.finish_reason == "length"
              and len(h.tokens) == SERVE_NEW for h in handles),
          f"{what}: not every request finished: "
          f"{[(h.finish_reason, len(h.tokens)) for h in handles]}")
    if pool_blocks:
        eng.check_invariants()
    tokens = sum(len(h.tokens) for h in handles)
    return eng, [list(h.tokens) for h in handles], {
        "warmup": warm, "decode_steps": eng.n_decode_steps, "wall_s": wall,
        "tokens": tokens, "tokens_per_s": tokens / wall, "launches": counts,
        "prefills": len(prefills)}


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _recon_error(state, cfg, table):
    """(c) one RECON_LEN-token prompt prefilled under identity and under
    the calibrated table: each layer's cache read back (materialize_kv)
    against the fp K/V in the same channel order, over the packed
    positions; relative MSE for K and V, mean and worst layer."""
    import numpy as np
    import torch
    from repro_torch.core import kv_cache as kvc
    from repro_torch.core.policy import PAPER_POLICY as POL
    from repro_torch.models import transformer as T
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, RECON_LEN)),
                          device=dev)
    params = state["params"]
    ks, vs = T.collect_kv(params, cfg, tok, max_samples=RECON_LEN)
    lo, hi = POL.n_sink, RECON_LEN - POL.window          # packed positions
    out = {}
    for name, cal in (("identity", None), ("calibrated", table)):
        _, caches = T.prefill_model(params, cfg, tok, POL, calib=cal,
                                    max_len=MAX_LEN, backend="cuda")
        tab = cal or T.identity_calib(cfg, POL, device=dev)
        errs = {"k": [], "v": []}
        for l in range(cfg.n_layers):
            layer = {k: v[l] for k, v in caches["scan"].items()}
            kh, vh = kvc.materialize_kv(layer, cfg.head_dim, POL, RECON_LEN)
            for key, x, perm, xh in (("k", ks[l], tab["perm_k"][l], kh),
                                     ("v", vs[l], tab["perm_v"][l], vh)):
                xp = torch.gather(x.float(), -1, perm[None].expand(x.shape))
                e = (xh[0, lo:hi] - xp[lo:hi]) ** 2
                errs[key].append(float(e.sum() / (xp[lo:hi] ** 2).sum()))
        out[name] = {f"{key}_{stat}": fn(errs[key]) for key in ("k", "v")
                     for stat, fn in (("mean", np.mean), ("worst", max))}
        out[name].update({f"{key}_worst_layer": int(np.argmax(errs[key]))
                          for key in ("k", "v")})
        del caches
    return tok, out


def _fp16_distance(state, cfg, table):
    """(c) one decode step's logits at 4 x STEP_CONTEXT under identity and
    under the calibrated table, each against FP16_POLICY (relative L2,
    top-1)."""
    import numpy as np
    import torch
    from repro_torch.core.policy import FP16_POLICY, PAPER_POLICY
    from repro_torch.models import transformer as T
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    batch = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                         (SERVE_SLOTS, STEP_CONTEXT)),
                            device=dev)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, 1)),
                          device=dev)
    logits = {}
    for name, pol, cal in (("fp16", FP16_POLICY, None),
                           ("identity", PAPER_POLICY, None),
                           ("calibrated", PAPER_POLICY, table)):
        _, base = T.prefill_model(state["params"], cfg, batch, pol,
                                  calib=cal, max_len=MAX_LEN, backend="cuda")
        lg, _ = T.decode_step(state["params"], cfg, tok, base, pol,
                              calib=cal, backend="cuda")
        logits[name] = lg[:, -1].float()
        del base
    ref = logits["fp16"]
    return {name: {"logits_rel_l2_vs_fp16": _rel(logits[name], ref),
                   "top1_agreement_vs_fp16": float(
                       (logits[name].argmax(-1) == ref.argmax(-1))
                       .float().mean())}
            for name in ("identity", "calibrated")}


def _fused_v(state, cfg, table, tok):
    """(e) fuse_v_permutation: fused weights with an identity perm_v
    against the unfused weights with the calibrated perm_v, the final
    prefill logits of ``tok`` (gated, relative L2) and one decode step
    (reported)."""
    import torch
    from repro_torch.core.policy import PAPER_POLICY as POL
    from repro_torch.models import transformer as T
    params = state["params"]
    attn = T.fuse_v_permutation(params["layers"]["attn"], table["perm_v"],
                                cfg.n_heads)
    fused = dict(params, layers=dict(params["layers"], attn=attn))
    eye = T.identity_calib(cfg, POL, device=tok.device)["perm_v"]
    table_f = dict(table, perm_v=eye)
    runs, nxt = {}, None
    for name, p, cal in (("unfused", params, table),
                         ("fused", fused, table_f)):
        lg, caches = T.prefill_model(p, cfg, tok, POL, calib=cal,
                                     max_len=MAX_LEN, backend="cuda")
        if nxt is None:                  # both decode the same next token
            nxt = lg[:, -1].argmax(-1, keepdim=True)
        dl, _ = T.decode_step(p, cfg, nxt, caches, POL, calib=cal,
                              backend="cuda")
        runs[name] = (lg[:, -1].float(), dl[:, -1].float())
        del caches
    del fused
    torch.cuda.empty_cache()
    rel = _rel(runs["fused"][0], runs["unfused"][0])
    check(rel <= LOGIT_REL_TOL, f"calibrate: fused-V prefill logits "
          f"relative L2 {rel:.4f} > {LOGIT_REL_TOL}")
    return {"prefill_logits_rel_l2": rel, "rel_tol": LOGIT_REL_TOL,
            "decode_logits_rel_l2": _rel(runs["fused"][1],
                                         runs["unfused"][1]),
            "top1_equal": bool(runs["fused"][0].argmax()
                               == runs["unfused"][0].argmax())}


def phase_calibrate(state):
    """Offline calibration (paper Sec. 3.1) on the card at llama2-7b's
    width, PAPER_POLICY: (a) calibrate on the kernel route; (b) serve the
    table from warmed striped and pooled engines; (c) reconstruction error
    and distance from fp16, identity against calibrated; (d) replayed
    steps calibrated against identity in ABBA turns; (e)
    fuse_v_permutation."""
    import torch
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_POLICY
    cfg = configs.get("llama2_7b")
    cal, calib_rep = _calibrate_run(state, cfg)
    table = cal.stacked()
    eng_s, s_streams, striped = _calib_serve(state, cfg, table, None)
    eng_p, p_streams, pooled = _calib_serve(state, cfg, table, 768)
    del eng_p
    same = [a == b for a, b in zip(p_streams, s_streams)]
    check(all(same), f"calibrate: pooled streams differ from striped "
          f"(request equal: {same})")
    backends = _backend_logits(state["params"], cfg, PAPER_POLICY,
                               calib=table)
    tok, recon = _recon_error(state, cfg, table)
    fp16 = _fp16_distance(state, cfg, table)
    # (d) replayed steps at 4 x STEP_CONTEXT: calibrated against identity
    eng_i, _ = _graph_engine(state, cfg)
    for eng in (eng_i, eng_s):
        _load_slots(eng, cfg)
    turns = _abba({"identity": eng_i._decode_chunk,
                   "calibrated": eng_s._decode_chunk})
    del eng_i, eng_s
    fused = _fused_v(state, cfg, table, tok)
    torch.cuda.empty_cache()
    kq = calib_rep["launches"]["kv_quant"]
    state["launches"]["kv_quant"] += kq["kernel"]
    for run in (striped, pooled):
        kq, da = run["launches"]["kv_quant"], run["launches"]["decode_attn"]
        state["launches"]["kv_quant"] += kq["kernel"]
        state["launches"]["kv_append"] += kq["append"]
        state["launches"]["decode_attn"] += da["kernel"]
        state["launches"]["decode_attn_pooled"] += da["pooled"]
    k_launch = calib_rep["kv_quant_launch"][0]
    state["kv_quant"].update(
        calib_ms=k_launch["ms"], calib_bound_ms=k_launch["bound_ms"],
        calib_plain_ms=k_launch["plain_ms"], calib_rows=k_launch["rows"],
        calib_launches=calib_rep["launches_expected"])
    same_id = [a == b for a, b in zip(s_streams, state["serve_streams"])]
    quality = _quality_pass(state, cfg, cal)
    emit({"phase": "calibrate", "arch": cfg.name, "max_len": MAX_LEN,
          "slots": SERVE_SLOTS, "steps_per_sync": SERVE_SPS,
          "calibration": calib_rep,
          "serve": {"striped": striped, "pooled": dict(
              pooled, streams_equal_striped=True),
                    "streams_equal_identity": same_id,
                    "cuda_vs_reference": backends},
          "reconstruction_rel_mse": recon, "distance_from_fp16": fp16,
          "abba_calibrated_vs_identity_4x2048": turns,
          "fuse_v_permutation": fused, "proxy_ppl_full_width": quality})


# ------------------------------- quality (the paper's accuracy evaluation)

QUALITY_LEN = 2048          # calibrate (f): one prompt of the proxy ppl
QUALITY_METHODS = ("fp16", "rtn", "kivi", "skvq")


@contextlib.contextmanager
def _plain_quantizer_spy():
    """Counts the calls of the plain quantizer (``core.quant.
    quantize_groups``: ``fake_quant``'s default and the CPU route of
    ``calibrate.resolve_quant_fn``) while installed; ``kv_quant_plain``
    counts its own (``launch_counts()["kv_quant"]["plain"]``)."""
    from repro_torch.core import calibrate as CAL
    from repro_torch.core import quant as Q
    orig = Q.quantize_groups
    calls = [0]

    def spy(*args, **kw):
        calls[0] += 1
        return orig(*args, **kw)
    Q.quantize_groups = CAL.quantize_groups = spy
    try:
        yield calls
    finally:
        Q.quantize_groups = CAL.quantize_groups = orig


def _check_quality_launches(counts, plain_calls, want, what):
    """The quality path's launch identity: exactly ``want`` bulk kv_quant
    launches, no plain call of either kind, no other kernel."""
    kq = counts["kv_quant"]
    check(kq["kernel"] == want and sum(kq.values()) == want
          and plain_calls == 0
          and sum(counts["decode_attn"].values()) == 0,
          f"{what}: launches {counts} (plain quantizer calls {plain_calls}) "
          f"!= {want} bulk kv_quant launches and nothing else")


def _kivi_rows(k):
    """KIVI's key rows at the full-width pass: one layer's K (1, S, H, D)
    quantized along the tokens, as ``fake_quant(axis=1)`` hands them to
    the kernel route: (H x D) rows of S channels, group 128, cut into rows
    of ``split_width`` channels.  Byte-equal to the plain quantizer on the
    whole rows (gated), one launch, L2-cold ms against its byte bound; a
    row of the same width at V's 1.5 bits has no exact cut and must raise
    (gated)."""
    import torch
    from repro_torch.core.policy import PAPER_POLICY as POL
    from repro_torch.core.quant import quantize_groups
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import make_kernel_quant_fn, split_width
    x = k.movedim(1, -1).contiguous()
    d, gs = x.shape[-1], POL.group_size
    qf = make_kernel_quant_fn()
    reset_launch_counts()
    got = qf(x, POL.bits_k, gs, None, True)
    launches = launch_counts()["kv_quant"]["kernel"]
    want = quantize_groups(x, POL.bits_k, gs, None, True)
    diff = sum(int((got[n].view(torch.uint8) != want[n].view(torch.uint8)
                    ).sum()) for n in want)
    check(diff == 0 and launches == 1,
          f"calibrate (f): KIVI's {d}-token key rows through the kernel "
          f"route: {diff} bytes differ from the plain quantizer, "
          f"{launches} launches")
    try:
        qf(x, 1.5, gs, None, True)
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "no exact split" in refused,
          f"calibrate (f): a {d}-channel row at 1.5 bits was not refused")
    xs = [x] + [x.clone() for _ in range(L2_COPIES - 1)]
    ms = cuda_ms([lambda c=c: qf(c, POL.bits_k, gs, None, True) for c in xs])
    out_b = sum(v.numel() * v.element_size() for v in got.values())
    in_b = x.numel() * x.element_size()
    bound_ms, bound_by = bound(in_b + out_b, 7 * x.numel())
    w = split_width(d, POL.bits_k, gs)
    del xs, got, want
    return {"rows": x.numel() // w, "width": w, "row_tokens": d,
            "dtype": str(x.dtype).replace("torch.", ""),
            "bits": POL.bits_k, "group": gs, "diff_bytes": diff,
            "launches": launches, "ms": ms, "bytes": in_b + out_b,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "refused_1.5_bits": refused}


def _quality_pass(state, cfg, cal):
    """(f) The proxy-ppl evaluator (``quality.common.forward_with_method``)
    at llama2-7b's full width with the phase's weights and table: one
    QUALITY_LEN-token ``SyntheticCorpus`` prompt under PAPER_POLICY for
    QUALITY_METHODS, each through the kernel route (exactly 2 bulk
    launches a layer for a quantizing method, none for fp16, no plain
    quantizer call: gated) and through the plain quantizer on the card:
    logits bitwise equal (gated).  KIVI's key rows: :func:`_kivi_rows`.
    Reported: ppl (random weights: meaningless as quality), seconds, the
    peak memory above the weights."""
    import numpy as np
    import torch
    from repro_torch.core.baselines import METHODS
    from repro_torch.core.policy import PAPER_POLICY as POL
    from repro_torch.core.quant import quantize_groups
    from repro_torch.data import SyntheticCorpus
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.quality import common as QC
    params = state["params"]
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    tok = torch.as_tensor(corpus.sample(QUALITY_LEN, np.random.default_rng(
        200))[None].astype(np.int64), device=torch.device("cuda"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t_all = time.monotonic()
    rows, stash, launches = {}, {}, 0
    for name in QUALITY_METHODS:
        method = METHODS[name]
        if name == "kivi":
            def method(k, v, ctx, kivi=method):
                stash.setdefault("k", k)
                return kivi(k, v, ctx)
        want = 0 if name == "fp16" else 2 * cfg.n_layers
        reset_launch_counts()
        t0 = time.monotonic()
        with _plain_quantizer_spy() as plain_calls:
            lk = QC.forward_with_method(params, cfg, tok, method, cal.layers,
                                        POL)
            torch.cuda.synchronize()
        kern_s = time.monotonic() - t0
        _check_quality_launches(launch_counts(), plain_calls[0], want,
                                f"calibrate (f) {name}")
        launches += want
        t0 = time.monotonic()
        lp = QC.forward_with_method(params, cfg, tok, METHODS[name],
                                    cal.layers, POL, quantize_groups)
        torch.cuda.synchronize()
        plain_s = time.monotonic() - t0
        same = bool(torch.equal(lk, lp))
        check(same and bool(torch.isfinite(lk).all()),
              f"calibrate (f) {name}: the kernel route's logits differ from "
              f"the plain quantizer's on the card (max abs "
              f"{float((lk.float() - lp.float()).abs().max()):.3g})")
        rows[name] = {"ppl_random_weights": QC._ppl(lk, tok),
                      "logits_bitwise_plain": same, "launches": want,
                      "kernel_s": kern_s, "plain_s": plain_s}
        del lk, lp
    peak = torch.cuda.max_memory_allocated() - base
    kivi = _kivi_rows(stash.pop("k"))
    launches += kivi["launches"]
    state["launches"]["kv_quant"] += launches
    state["kv_quant"].update(quality_ms=kivi["ms"],
                             quality_bound_ms=kivi["bound_ms"],
                             quality_rows=kivi["rows"],
                             quality_launches=launches)
    torch.cuda.empty_cache()
    return {"prompt_tokens": QUALITY_LEN, "policy": "PAPER_POLICY",
            "calibration": "the phase's table", "methods": rows,
            "note": "ppl of random weights: no quality meaning",
            "launches": launches, "peak_bytes_above_weights": peak,
            "kivi_key_rows": kivi, "seconds": time.monotonic() - t_all}


def _quality_expected(n: int) -> dict:
    """Bulk kv_quant launches of ``quality_ladder.run`` and
    ``component_ablation.run`` on an ``n``-layer model, worked out from the
    studies' code: a calibration clips K and V of every quantized layer at
    each of the 11 grid points (an fp16 guard layer: none); a quantizing
    method or stage quantizes K and V once a layer (fp16: none)."""
    from repro_torch.core.calibrate import ALPHA_GRID
    from repro_torch.quality.component_ablation import STAGES
    clip = 2 * len(ALPHA_GRID)
    table1 = (clip * n                       # calibrate(pol)
              + 5 * 2 * n                    # rtn smoothquant rptq kivi skvq
              + 2 * n                        # sched_uniform (same table)
              + clip * (n - 1) + 2 * (n - 1)   # sched_guard_first_fp16
              + clip * n + 2 * n)            # sched_ladder_k4_first
    table3 = clip * n + len(STAGES) * 2 * n + 2 * (n - 1)   # + fp16_guard
    return {"table1": table1, "table3": table3}


def phase_quality_model(state):
    """The studies' stand-in model trained TRAIN_STEPS on the card into a
    temporary directory (no kernel may launch: it runs while the kernels
    build); ``phase_quality`` evaluates it and removes the directory."""
    import os
    import tempfile
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.quality import common as QC
    tmp = tempfile.mkdtemp(prefix="quality_")
    state["quality"] = {"tmp": tmp,
                        "cache": os.path.join(tmp, "bench_model_torch")}
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    cfg, _, _ = QC.bench_model(state["quality"]["cache"], "cuda")
    torch.cuda.synchronize()
    state["quality"].update(cfg=cfg, train_s=time.monotonic() - t0)
    _no_kernel_launch(before, "quality: training")


def _quality_cleanup(q):
    import shutil
    from repro_torch.quality import common as QC
    QC._bench_model.cache_clear()
    shutil.rmtree(q["tmp"], ignore_errors=True)


def phase_quality(state):
    """The paper's accuracy evaluation on the card: the studies' stand-in
    model (``phase_quality_model``), then
    ``quality_ladder.run`` (Tables 1/5, the schedule sweep) and
    ``component_ablation.run`` (Table 3) on the kernel route (the expected
    bulk launches, no plain quantizer call: gated) and through the plain
    quantizer on the card (every method's, stage's and schedule's ppl
    equal: gated); ``sched_uniform`` within 1e-6 of ``skvq`` (gated); the
    rows with their ``holds=`` (reported, not gated: the port trains its
    own weights); the same studies on the CPU from the same checkpoint,
    relative ppl gaps (reported)."""
    import torch
    from repro_torch.core.quant import quantize_groups
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.quality import common as QC
    from repro_torch.quality import component_ablation, quality_ladder
    q = state.pop("quality")
    cfg, cache = q["cfg"], q["cache"]
    studies = (("table1", quality_ladder.run),
               ("table3", component_ablation.run))
    try:
        want = _quality_expected(cfg.n_layers)
        kern, lines, secs = {}, {}, {"train": q["train_s"]}
        for name, run in studies:
            lines[name] = []
            reset_launch_counts()
            t0 = time.monotonic()
            with _plain_quantizer_spy() as plain_calls:
                kern[name] = run(lines[name].append, cache_dir=cache,
                                 device="cuda")
                torch.cuda.synchronize()
            secs[f"{name}_kernel"] = time.monotonic() - t0
            _check_quality_launches(launch_counts(), plain_calls[0],
                                    want[name], f"quality {name}")
        plain, cpu = {}, {}
        for name, run in studies:
            t0 = time.monotonic()
            plain[name] = run(lambda r: None, cache_dir=cache, device="cuda",
                              quant_fn=quantize_groups)
            secs[f"{name}_plain"] = time.monotonic() - t0
            check(plain[name] == kern[name],
                  f"quality {name}: the kernel route's ppl {kern[name]} != "
                  f"the plain quantizer's {plain[name]} on the card")
            t0 = time.monotonic()
            cpu[name] = run(lambda r: None, cache_dir=cache, device="cpu")
            secs[f"{name}_cpu"] = time.monotonic() - t0
        gap = abs(kern["table1"]["sched_uniform"] - kern["table1"]["skvq"])
        check(gap < 1e-6, f"quality: sched_uniform - skvq = {gap} >= 1e-6")
        launches = sum(want.values())
        state["launches"]["kv_quant"] += launches
        kq = state["kv_quant"]
        kq["quality_launches"] = kq.get("quality_launches", 0) + launches
        emit({"phase": "quality", "model": {
                  "arch": cfg.name, "layers": cfg.n_layers,
                  "d_model": cfg.d_model, "heads": cfg.n_heads,
                  "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
                  "vocab": cfg.vocab_size, "train_steps": QC.TRAIN_STEPS},
              "rows": lines, "launches": want,
              "kernel_equals_plain_on_card": True,
              "sched_uniform_minus_skvq": gap,
              "cpu_rel_gap": {n: {k: (kern[n][k] - cpu[n][k]) / cpu[n][k]
                                  for k in kern[n]} for n in kern},
              "seconds": secs})
    finally:
        _quality_cleanup(q)


# ------------------------------------------------ serve_schedule (DESIGN.md §8)

GUARD_LAYERS = 2
LADDER = ((4.0, 4.0), (2.0, 2.0), (2.0, 1.5))
WIDTHS = ((4.0, 4.0), (2.0, 2.0))   # the ladder's widths new on the card
EAGER_NEW = 16          # the eager check: the first wave, 16 new tokens
GRANITE_LENS, GRANITE_NEW = [512, 1024, 1536, 2048], 32


def _schedules():
    """The two presets of the phase, materialized by each Engine."""
    from repro_torch.core.policy import PAPER_POLICY, PolicySchedule
    return {"first_last_fp16": PolicySchedule.first_last_fp16(
                PAPER_POLICY, GUARD_LAYERS),
            "ladder": PolicySchedule.bits_ladder(PAPER_POLICY, LADDER)}


def _clone(tree):
    import torch
    if torch.is_tensor(tree):
        return tree.clone()
    return {k: _clone(v) for k, v in tree.items()}


def _width_kernels(gen, dev):
    """(a) Both kernels at the ladder's widths against their plain
    versions: the bulk kv_quant at K 4-bit and V 2-bit (128 rows and one
    layer of the 3000-token prefill), kv_append at (4, 4) and (2, 2) for
    300 steps in both layouts, decode_attn at (4, 4) and (2, 2) striped and
    pooled at the serve shape."""
    import torch
    kq = []
    for bits in (4.0, 2.0):
        kq.append(_kv_quant_rows(gen, dev, 128, 128, bits, torch.bfloat16))
        kq.append(_kv_quant_prefill(gen, dev, bits))
    app = [_append_case(gen, dev, 32, 128, 128, pooled, bits)
           for bits in WIDTHS for pooled in (False, True)]
    attn, live = [], [500, 1500, 2900, 3900]
    for bits in WIDTHS:
        name = f"K{bits[0]:g}V{bits[1]:g}"
        pol, q, k_qt, v_qt, mask, bounds, bs = _attn_case(
            gen, dev, len(live), 32, 1, 128, live, MAX_LEN, bits)
        row = _attn_row(f"decode_attn {name}", pol, q, k_qt, v_qt, mask,
                        bounds, bs, live)
        attn.append(dict(row, bits=list(bits), layout="striped"))
        nb = k_qt["codes_hi"].shape[1] // POOL_BT
        k_p, v_p, table = _pool(dev, len(live), nb, k_qt, v_qt, 3, 8)
        del k_qt, v_qt
        row = _attn_row(f"decode_attn pooled {name}", pol, q, k_p, v_p, mask,
                        bounds, bs, live, table=table)
        attn.append(dict(row, bits=list(bits), layout="pooled", bt=POOL_BT,
                         nb=nb))
        del q, k_p, v_p, mask, bounds, table
        torch.cuda.empty_cache()
    return {"kv_quant": kq, "kv_append": app, "decode_attn": attn}


def _band_bytes(eng, cfg):
    """(d) The engine's cache bytes by band (``length`` excluded); for a
    striped engine they must equal ``schedule_cache_nbytes`` x slots."""
    from repro_torch.core import kv_cache as kvc
    layer = kvc.schedule_cache_nbytes(eng.schedule, cfg.n_layers, MAX_LEN,
                                      cfg.n_kv_heads, cfg.head_dim,
                                      eng.params["embed"].dtype)
    group, out = eng._caches["scan"], {}
    for bs, be, pol in eng.schedule.bands():
        band = group if "length" in group else group[f"L{bs:03d}"]
        got = sum(v.numel() * v.element_size() for k, v in band.items()
                  if k != "length")
        out[f"L{bs:03d}"] = {"layers": be - bs, "bits": [pol.bits_k,
                                                         pol.bits_v],
                             "pooled": "block_tbl" in band, "bytes": got,
                             "schedule_cache_nbytes": SERVE_SLOTS
                             * sum(layer[bs:be])}
    return out


def _sched_serve(state, cfg, sched, what, pool_blocks=None, chunk=None):
    """(b) The serve phase's 8 requests through a warmed Engine under
    ``sched`` (striped, pooled with ``pool_blocks``, or chunked at
    ``chunk``): every step a replay, the launch identities over the
    quantized layers, every request finished, a clean audit per band.
    Returns the engine, streams, last-token logits by rid (whole-prompt or
    final-chunk) and a report."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as T
    eng, warm = _graph_engine(state, cfg, pool_blocks, prefill_chunk=chunk,
                              policy=sched)
    logits = {}
    prefills = _counted_prefills(eng, logits)
    if chunk:
        finish = eng._finish_prefill

        def keep(job, lg):
            logits[job.handle.rid] = lg[0, -1].float().cpu()
            finish(job, lg)
        eng._finish_prefill = keep
    _, reqs = _serve_requests(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()                                    # main path only
    t0 = time.monotonic()
    handles = [eng.submit(r) for r in reqs]
    eng.run(handles)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    if chunk:
        _check_chunked_path(cfg, eng, counts, _evicting_chunks(SERVE_LENS),
                            what, n_chunks=len(_chunk_plan(SERVE_LENS)))
    else:
        _check_graph_path(cfg, eng, counts, prefills, what)
    check(all(h.finished and h.finish_reason == "length"
              and len(h.tokens) == SERVE_NEW for h in handles),
          f"{what}: not every request finished: "
          f"{[(h.finish_reason, len(h.tokens)) for h in handles]}")
    quant = [f"scan/L{bs:03d}" for bs, _, p in eng.schedule.bands()
             if not p.is_fp16]
    audit = eng.check_invariants()
    if pool_blocks:
        check(sorted(audit) == quant, f"{what}: pools {sorted(audit)} != "
              f"one per quantized band {quant}")
    tokens = sum(len(h.tokens) for h in handles)
    rep = {"warmup": warm, "decode_steps": eng.n_decode_steps,
           "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
           "launches": counts, "peak_mem_bytes":
           torch.cuda.max_memory_allocated(), "band_bytes":
           _band_bytes(eng, cfg), "bf16_cache_bytes":
           T.bf16_cache_bytes(cfg, SERVE_SLOTS, MAX_LEN)}
    if pool_blocks:
        st = eng.stats()
        rep.update(pool_bytes=eng.backend_info["pool_bytes"],
                   pool_bands=sorted(st["bands"]),
                   peak_resident_bytes=st["peak_resident_bytes"],
                   striped_worst_case_bytes=st["striped_worst_case_bytes"])
    return eng, [list(h.tokens) for h in handles], logits, rep


def _sched_eager(state, cfg, sched, what):
    """Replayed against eager: the first wave's 4 requests through an
    unwarmed Engine for EAGER_NEW tokens, with the eager path's launch
    identities; returns the streams."""
    import dataclasses
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine
    eng = Engine(state["params"], cfg, sched, batch_slots=SERVE_SLOTS,
                 max_len=MAX_LEN, steps_per_sync=SERVE_SPS, backend="cuda",
                 device=torch.device("cuda"))
    prefills = _counted_prefills(eng)
    _, reqs = _serve_requests(cfg)
    reset_launch_counts()                                    # main path only
    handles = [eng.submit(dataclasses.replace(r, max_new=EAGER_NEW))
               for r in reqs[:SERVE_SLOTS]]
    eng.run(handles)
    torch.cuda.synchronize()
    _check_main_path(cfg, launch_counts(), eng.n_decode_steps, len(prefills),
                     what, _n_quant(eng))
    return [list(h.tokens) for h in handles]


def _backend_logits(params, cfg, policy, seed=2, context=STEP_CONTEXT,
                    calib=None):
    """One decode step of a 4-slot batch at ``context`` tokens on the cuda
    and the reference backends from the same prefilled cache (with the
    stacked table ``calib``, identity by default): relative L2 of the
    logits (gated) and top-1 agreement (reported)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    batch = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                         (SERVE_SLOTS, context)), device=dev)
    _, base = T.prefill_model(params, cfg, batch, policy, calib=calib,
                              max_len=MAX_LEN, backend="cuda")
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, 1)),
                          device=dev)
    lc, _ = T.decode_step(params, cfg, tok, _clone(base), policy,
                          calib=calib, backend="cuda")
    lr, _ = T.decode_step(params, cfg, tok, base, policy, calib=calib,
                          backend="reference")
    lc, lr = lc[:, -1].float(), lr[:, -1].float()
    check(bool(torch.isfinite(lc).all() and torch.isfinite(lr).all()),
          "decode logits not finite")
    rel = float((lc - lr).norm() / lr.norm())
    check(rel <= LOGIT_REL_TOL, f"cuda vs reference logits: relative L2 "
          f"{rel:.4f} > {LOGIT_REL_TOL}")
    return {"logits_rel_l2": rel, "top1_agreement":
            float((lc.argmax(-1) == lr.argmax(-1)).float().mean())}


def _one_schedule(state, cfg, name, sched):
    """(b) + (d) for one schedule: striped, pooled (768 blocks), eager and
    chunked (512) runs and the cuda-vs-reference step; returns the warmed
    striped engine (for the turns against uniform) and the report."""
    import gc
    import torch
    eng_s, streams, whole, striped = _sched_serve(state, cfg, sched,
                                                  f"{name} striped")
    for band, b in striped["band_bytes"].items():
        check(b["bytes"] == b["schedule_cache_nbytes"],
              f"{name}: band {band} holds {b['bytes']} bytes != "
              f"schedule_cache_nbytes {b['schedule_cache_nbytes']}")
    eng_p, p_streams, _, pooled = _sched_serve(state, cfg, sched,
                                               f"{name} pooled", 768)
    del eng_p
    same = [a == b for a, b in zip(p_streams, streams)]
    check(all(same), f"{name}: pooled streams differ from striped "
          f"(request equal: {same})")
    gc.collect()
    eager = _sched_eager(state, cfg, sched, f"{name} eager")
    same = [a == b[:EAGER_NEW] for a, b in zip(eager, streams)]
    check(all(same), f"{name}: replayed streams differ from eager "
          f"(request equal: {same})")
    eng_c, c_streams, final, chunked = _sched_serve(
        state, cfg, sched, f"{name} chunked", chunk=CHUNK)
    del eng_c
    rel = [float((final[i] - whole[i]).norm() / whole[i].norm())
           for i in range(len(SERVE_LENS))]
    check(max(rel) <= LOGIT_REL_TOL and all(
        bool(torch.isfinite(v).all()) for v in final.values()),
          f"{name}: final-chunk logits vs whole-prompt relative L2 "
          f"{max(rel):.4f} > {LOGIT_REL_TOL}")
    chunked.update(final_logits_rel_l2_vs_whole=rel,
                   streams_equal_whole=[a == b for a, b in
                                        zip(c_streams, streams)])
    backends = _backend_logits(state["params"], cfg, sched)
    for run in (striped, pooled, chunked):
        kq, da = run["launches"]["kv_quant"], run["launches"]["decode_attn"]
        state["launches"]["kv_quant"] += kq["kernel"]
        state["launches"]["kv_append"] += kq["append"]
        state["launches"]["decode_attn"] += da["kernel"]
        state["launches"]["decode_attn_pooled"] += da["pooled"]
    bands = [(bs, be, p.bits_k, p.bits_v, p.window, p.n_sink)
             for bs, be, p in eng_s.schedule.bands()]
    return eng_s, {"bands": bands, "quantized_layers": _n_quant(eng_s),
                   "avg_bits": eng_s.schedule.avg_bits(cfg.head_dim),
                   "striped": striped, "pooled": dict(
                       pooled, streams_equal_striped=True),
                   "eager_first_wave_equal": True, "chunked": chunked,
                   "cuda_vs_reference": backends}


def _granite(state):
    """(e) granite_8b at full width (36 layers, 8 kv heads of 128, Gq 4),
    random bf16 weights from seed 0, PAPER_POLICY: 4 requests through a
    warmed Engine with the launch identities, cuda-vs-reference logits at
    4 x 1024, and decode_attn at Hkv 8 / Gq 4 / D 128 against its plain
    version and SDPA."""
    import gc
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine, Request
    state.pop("params", None)                 # free the llama2-7b weights
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = configs.get("granite_8b")
    t0 = time.monotonic()
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    eng = Engine(params, cfg, PAPER_POLICY, batch_slots=SERVE_SLOTS,
                 max_len=MAX_LEN, steps_per_sync=SERVE_SPS, backend="cuda",
                 device=dev)
    warm = eng.warmup()
    check(warm["n_graphs"] == 1 and warm["post_warmup_misses"] == 0,
          f"granite: warmup captured no decode step: {warm}")
    prefills = _counted_prefills(eng)
    rng = np.random.default_rng(4)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new=GRANITE_NEW, seed=i)
            for i, n in enumerate(GRANITE_LENS)]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()                                    # main path only
    t0 = time.monotonic()
    handles = [eng.submit(r) for r in reqs]
    eng.run(handles)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    _check_graph_path(cfg, eng, counts, prefills, "granite")
    check(all(h.finished and h.finish_reason == "length"
              and len(h.tokens) == GRANITE_NEW
              and all(0 <= t < cfg.vocab_size for t in h.tokens)
              for h in handles),
          f"granite: not every request finished: "
          f"{[(h.finish_reason, len(h.tokens)) for h in handles]}")
    peak = torch.cuda.max_memory_allocated()
    steps = eng.n_decode_steps
    del eng
    gc.collect()
    backends = _backend_logits(params, cfg, PAPER_POLICY, seed=5,
                               context=1024)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(9)
    live = [500, 1500, 2900, 3900]
    pol, q, k_qt, v_qt, mask, bounds, bs = _attn_case(
        gen, dev, len(live), cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
        cfg.head_dim, live)
    attn = _attn_row("decode_attn granite", pol, q, k_qt, v_qt, mask, bounds,
                     bs, live)
    kq, da = counts["kv_quant"], counts["decode_attn"]
    state["launches"]["kv_quant"] += kq["kernel"]
    state["launches"]["kv_append"] += kq["append"]
    state["launches"]["decode_attn"] += da["kernel"]
    return {"arch": cfg.name, "layers": cfg.n_layers, "hkv": cfg.n_kv_heads,
            "gq": cfg.n_heads // cfg.n_kv_heads, "d": cfg.head_dim,
            "params_init_s": init_s, "warmup": warm, "prompt_lens":
            GRANITE_LENS, "max_new": GRANITE_NEW, "decode_steps": steps,
            "wall_s": wall, "launches": counts, "peak_mem_bytes": peak,
            "cuda_vs_reference": backends,
            "decode_attn": dict(attn, bits=[pol.bits_k, pol.bits_v])}


def _width_row(row, **extra):
    keys = ("bits", "layout", "rows", "hkv", "gq", "d", "lo", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return dict({k: row[k] for k in keys if k in row}, **extra)


def phase_serve_schedule(state):
    """Per-layer policy schedules (DESIGN.md §8) on the card: (a) both
    kernels at the ladder's widths; (b) first_last_fp16(PAPER_POLICY, 2)
    and the default ladder through warmed engines striped, pooled and
    chunked, with an eager first wave and the cuda-vs-reference step; (c) a
    uniform schedule bitwise the bare policy; (d) cache bytes by band; the
    replayed step of each schedule at 4 x 2048 in turns against uniform;
    (e) granite_8b."""
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_POLICY, PolicySchedule
    cfg = configs.get("llama2_7b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    widths = _width_kernels(gen, dev)
    # (c) uniform schedule == bare policy (the eager serve phase's streams)
    uni = PolicySchedule.uniform(PAPER_POLICY, cfg.n_layers)
    eng_u, u_streams, _, uniform = _sched_serve(state, cfg, uni, "uniform")
    same = [a == b for a, b in zip(u_streams, state["serve_streams"])]
    check(all(same), f"uniform schedule streams differ from the bare "
          f"policy's (request equal: {same})")
    engines, scheds = {}, {}
    for name, sched in _schedules().items():
        engines[name], scheds[name] = _one_schedule(state, cfg, name, sched)
    # the replayed step of each schedule at 4 x 2048 against uniform
    for eng in [eng_u] + list(engines.values()):
        _load_slots(eng, cfg)
    turns = {name: _abba({"uniform": eng_u._decode_chunk,
                          name: eng._decode_chunk})
             for name, eng in engines.items()}
    del eng_u, engines, eng
    gc.collect()
    granite = _granite(state)
    for key, rows in (("kv_quant", widths["kv_quant"]),
                      ("kv_append", widths["kv_append"])):
        st = state[key]
        st["widths"] = [_width_row(r) for r in rows]
        st["max_abs_err"] = max([st["max_abs_err"]]
                                + [r["max_abs_err"] for r in rows])
    for key, layout in (("decode_attn", "striped"),
                        ("decode_attn_pooled", "pooled")):
        rows = [r for r in widths["decode_attn"] if r["layout"] == layout]
        if layout == "striped":
            rows.append(dict(granite["decode_attn"], layout="granite"))
        st = state[key]
        st["widths"] = [_width_row(r) for r in rows]
        st["max_abs_err"] = max([st["max_abs_err"]]
                                + [r["max_abs_err"] for r in rows])
    emit({"phase": "serve_schedule", "arch": cfg.name, "max_len": MAX_LEN,
          "slots": SERVE_SLOTS, "steps_per_sync": SERVE_SPS,
          "kernels": widths,
          "uniform": dict(uniform, streams_equal_bare_policy=True),
          "schedules": scheds, "abba_vs_uniform_4x2048": turns,
          "granite_8b": granite})


def _spec_dict(spec):
    import dataclasses
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(spec).items()}


# ------------------------------------------ serve_degrade (DESIGN.md §11)

# 3 of the first wave's 4 requests fit (eventual demand 61 + 125 + 185 =
# 371 blocks, 15 more reserved than allocated): the 512-token request waits
# with a slot free, so a priority-1 arrival finds both a slot and a short
# pool, the condition under which the reference preempts
# (src/repro/serving/engine.py:1337, 1365-1371)
DEGRADE_POOL = 390
DEGRADE_SPILL = 256 << 20        # 264 llama2-7b blocks of 1,015,808 bytes
DEGRADE_HI = 2                   # priority-1 arrivals after the first chunk
HOST_LINK_BYTES_PER_S = 64e9     # PCIe 5.0 x16, one direction (raw rate)
CHAOS_SPEC = dict(n_events=8, kinds=("pool", "nan", "crash"),
                  horizon_ticks=24, duration=4, magnitude=0.9, seed=0)
CHAOS_NEW = 32
READ_BLOCKS = 64                 # blocks of the batched-vs-single read


def _synced(fn, log):
    """Wrap an Engine method: synchronized host ms of each call, with its
    first argument's size where it has one, appended to ``log``."""
    import torch

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0) * 1e3)
        return out
    return timed


def _check_degrade_path(cfg, eng, counts, what, prefills=None):
    """The launch identities of a run that preempts, restores or sheds:
    one kv_append and one block-table decode_attn launch a layer a step,
    one replay a step, no plain call, no graph miss; bulk kv_quant
    launches in whole layers (2 x layers x prefills when ``prefills``, the
    whole-prompt groups, is known)."""
    steps, nq = eng.n_decode_steps, _n_quant(eng)
    kq, da = counts["kv_quant"], counts["decode_attn"]
    check(kq["append"] == nq * steps and da["pooled"] == nq * steps
          and sum(da.values()) == da["pooled"],
          f"{what}: kv_append {kq['append']} / decode_attn {da} != layers "
          f"x steps = {nq * steps} on the block-table kernel")
    want = (2 * nq * prefills if prefills is not None
            else kq["kernel"] - kq["kernel"] % (2 * nq))
    check(kq["kernel"] == want and kq["kernel"] > 0,
          f"{what}: bulk kv_quant launches {kq['kernel']} != {want}")
    check(kq["plain"] == kq["append_plain"] == kq["chunk_plain"] == 0,
          f"{what}: a plain version ran: {counts}")
    rep = eng.warmup_report()
    check(rep["replays"] == steps and rep["post_warmup_misses"] == 0,
          f"{what}: {rep['replays']} replays for {steps} steps, misses "
          f"{rep['cold_names']}")


def _add_launches(state, counts):
    kq, da = counts["kv_quant"], counts["decode_attn"]
    state["launches"]["kv_quant"] += kq["kernel"]
    state["launches"]["kv_append"] += kq["append"]
    state["launches"]["decode_attn"] += da["kernel"]
    state["launches"]["decode_attn_pooled"] += da["pooled"]


def _u8(x):
    """A tensor's bytes, as a dense uint8 tensor."""
    import torch
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    return y.copy_(x).view(torch.uint8)


def _batch_of_one(state, cfg):
    """Trouble (1) of the preemption replay: a resumed request is
    prefilled in a group of another size.  The serve phase prefilled the
    1536/1536 pair as one group of 2; here each runs alone through a
    warmed striped Engine and must give the serve phase's stream.  Also
    reported: the bytes of the pair's caches and last logits that differ
    between the group of 2 and the runs of 1 (cuBLAS may pick another
    kernel for M = 1536 than for 3072 rows)."""
    import numpy as np
    import torch
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as T
    eng, warm = _graph_engine(state, cfg)
    _, reqs = _serve_requests(cfg)
    wave2 = SERVE_LENS[SERVE_SLOTS:]
    pair = [i for i in range(SERVE_SLOTS, len(SERVE_LENS))
            if wave2.count(SERVE_LENS[i]) > 1]
    prefills = _counted_prefills(eng)
    reset_launch_counts()
    streams = {}
    for i in pair:
        h = eng.submit(reqs[i])
        eng.run([h])
        streams[i] = list(h.tokens)
    counts = launch_counts()
    _check_graph_path(cfg, eng, counts, prefills, "serve_degrade batch-of-1")
    same = {i: streams[i] == state["serve_streams"][i] for i in pair}
    check(all(same.values()), f"serve_degrade: batch-of-1 streams differ "
          f"from the grouped serve phase's: {same}")
    dev = torch.device("cuda")
    toks = torch.as_tensor(np.stack([reqs[i].prompt for i in pair]),
                           device=dev)
    group = T.prefill_model(state["params"], cfg, toks, PAPER_POLICY,
                            max_len=MAX_LEN, backend="cuda")
    diff = {"cache_bytes": 0, "cache_bytes_total": 0, "logits_max_abs": 0.0}
    for row, i in enumerate(pair):
        lg, c1 = T.prefill_model(state["params"], cfg, toks[row:row + 1],
                                 PAPER_POLICY, max_len=MAX_LEN,
                                 backend="cuda")
        diff["logits_max_abs"] = max(diff["logits_max_abs"], float(
            (lg[0, -1].float() - group[0][row, -1].float()).abs().max()))
        for k, v in c1["scan"].items():
            a = _u8(v[:, 0])
            b = _u8(group[1]["scan"][k][:, row])
            diff["cache_bytes"] += int((a != b).sum())
            diff["cache_bytes_total"] += a.numel()
    del group
    return eng, {"requests": pair, "warmup": warm,
                 "streams_equal_grouped": same, "launches": counts,
                 "group_vs_alone": diff}


def _preempt_run(state, cfg):
    """(a) The serve phase's 8 requests at priority 0 and, after the first
    decode chunk, DEGRADE_HI priority-1 requests of 2048 tokens, through a
    warmed pooled async Engine with the host spill tier: preemption, spill
    and restore; the streams, counters and audit checked; spill, restore,
    preemption and prefill host ms recorded (synchronized)."""
    import numpy as np
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import FinishReason, Request
    eng, warm = _graph_engine(state, cfg, DEGRADE_POOL, async_host=True,
                              host_spill_bytes=DEGRADE_SPILL)
    logs = {k: [] for k in ("spill", "restore", "preempt", "prefill")}
    sizes = {"spill": [], "restore": []}
    spill, restore = eng._spill_evicted, eng._restore_blocks

    def spill_sized():
        sizes["spill"].append(len(eng._evicted))
        spill()

    def restore_sized(rest):
        sizes["restore"].append(sum(len(r) for r in rest.values()))
        restore(rest)
    eng._spill_evicted = _synced(spill_sized, logs["spill"])
    eng._restore_blocks = _synced(restore_sized, logs["restore"])
    eng._preempt_slot = _synced(eng._preempt_slot, logs["preempt"])
    groups = []
    admit = eng._admit_group

    def admit_logged(handles, slots):
        groups.append([h.rid for h in handles])
        admit(handles, slots)
    eng._admit_group = _synced(admit_logged, logs["prefill"])
    prefills = _counted_prefills(eng)
    _, reqs = _serve_requests(cfg)
    rng = np.random.default_rng(11)
    hi = [Request(prompt=rng.integers(0, cfg.vocab_size, 2048),
                  max_new=SERVE_NEW, seed=100 + i, priority=1)
          for i in range(DEGRADE_HI)]
    reset_launch_counts()                                    # main path only
    t0 = time.monotonic()
    handles = [eng.submit(r) for r in reqs]
    eng.step()
    his = [eng.submit(r) for r in hi]
    ticks = 1
    while eng.step():
        ticks += 1
        check(ticks < 400, "serve_degrade (a): engine still busy")
    eng.drain()
    wall = time.monotonic() - t0
    counts = launch_counts()
    _check_degrade_path(cfg, eng, counts, "serve_degrade (a)", len(prefills))
    c = eng.stats()["counters"]
    check(c["preemptions"] >= 1 and c["spilled_blocks"] >= 1
          and c["restored_blocks"] >= 1,
          f"serve_degrade (a): no preempt/spill/restore round trip: {c}")
    every = handles + his
    check(all(h.finished and FinishReason.valid(h.finish_reason)
              and h.finish_reason == "length"
              and len(h.tokens) == SERVE_NEW for h in every),
          f"serve_degrade (a): "
          f"{[(h.finish_reason, len(h.tokens)) for h in every]}")
    same = [list(h.tokens) == s for h, s in zip(handles,
                                                state["serve_streams"])]
    check(all(same), f"serve_degrade (a): priority-0 streams differ from the "
          f"serve phase's (request equal: {same})")
    audit = eng.check_invariants()
    st = eng.stats()
    check(st["used"] == 0 and st["reserved"] == 0, f"pool not drained: {st}")
    victims = [h.rid for h in handles if h.preempted]
    tier = st["host_spill"]
    per_block = tier["bytes"] / max(tier["entries"], 1)
    n_sp, n_re = sum(sizes["spill"]), sum(sizes["restore"])
    sp_ms, re_ms = sum(logs["spill"]), sum(logs["restore"])
    link = per_block / HOST_LINK_BYTES_PER_S * 1e3
    figures = {
        "block_bytes": per_block,
        "spill_ms_per_block": sp_ms / max(n_sp, 1),
        "restore_ms_per_block": re_ms / max(n_re, 1),
        "host_link_bound_ms_per_block": link,
        "spill_bound_share": link / (sp_ms / max(n_sp, 1)) if n_sp else None,
        "restore_bound_share": (link / (re_ms / max(n_re, 1))
                                if n_re else None),
        "spill_calls": sum(1 for n in sizes["spill"] if n),
        "spilled": n_sp,
        "restore_calls": sum(1 for n in sizes["restore"] if n),
        "restored": n_re,
        "preempt_host_ms": logs["preempt"],
        "prefill_groups": [{"rids": g, "ms": ms}
                           for g, ms in zip(groups, logs["prefill"])],
        "spills": [{"blocks": n, "ms": ms}
                   for n, ms in zip(sizes["spill"], logs["spill"]) if n],
        "restores": [{"blocks": n, "ms": ms}
                     for n, ms in zip(sizes["restore"], logs["restore"])
                     if n]}
    return eng, {"pool_blocks": DEGRADE_POOL, "spill_budget": DEGRADE_SPILL,
                 "warmup": warm, "ticks": ticks, "wall_s": wall,
                 "decode_steps": eng.n_decode_steps,
                 "prefills": len(prefills), "launches": counts,
                 "counters": c, "host_spill": tier, "audit": audit,
                 "victims": victims, "streams_equal_serve": same,
                 "hi_streams": [list(h.tokens)[:8] for h in his],
                 "figures": figures}


def _read_write_ms(eng):
    """Spill reads and restore writes of READ_BLOCKS blocks on a drained
    Engine's pool, ms a block, the best of 3: through the Engine's pinned
    staging buffer (its path), through fresh pageable memory, and one
    block a call; the staged read split into the device gather, the
    device->host copy and the host's per-block copies; every write a byte
    round trip."""
    import torch
    from repro_torch.core import kv_cache as kvc
    band = eng._caches["scan"]
    phys = list(range(1, READ_BLOCKS + 1))
    stage = eng._host_stage()

    def best(fn):
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / READ_BLOCKS)
        return min(ms)
    out = {"blocks": READ_BLOCKS, "block_bytes": kvc.pool_block_bytes(band, 1),
           "read_staged_ms_per_block": best(
               lambda: kvc.pool_read_blocks(band, phys, 1, stage=stage)),
           "read_pageable_ms_per_block": best(
               lambda: kvc.pool_read_blocks(band, phys, 1)),
           "read_one_a_call_ms_per_block": best(
               lambda: [kvc.pool_read_block(band, p, 1) for p in phys])}
    idx = torch.as_tensor(phys, device=eng.device)
    parts = lambda: torch.cat(
        [v[:, idx].movedim(1, 0).contiguous().reshape(READ_BLOCKS, -1)
         for k, v in band.items() if kvc.is_plane_key(k)], dim=1)
    flat = parts()
    host = stage[:flat.numel()].view(flat.shape)
    raw = host.numpy()
    out["read_split_ms_per_block"] = {
        "gather": best(parts), "copy": best(lambda: host.copy_(flat)),
        "host_rows": best(lambda: [raw[i].copy()
                                   for i in range(READ_BLOCKS)])}
    blocks = kvc.pool_read_blocks(band, phys, 1, stage=stage)
    before = {k: v[:, 1:READ_BLOCKS + 1].clone() for k, v in band.items()
              if kvc.is_plane_key(k)}
    out["write_staged_ms_per_block"] = best(
        lambda: kvc.pool_write_blocks(band, blocks, phys, 1, stage=stage))
    out["write_pageable_ms_per_block"] = best(
        lambda: kvc.pool_write_blocks(band, blocks, phys, 1))
    check(all(torch.equal(v[:, 1:READ_BLOCKS + 1], before[k])
              for k, v in band.items() if kvc.is_plane_key(k)),
          "serve_degrade: block read/write round trip changed bytes")
    return out


def _chaos_run(state, cfg):
    """(b) One seeded chaos trace (pool bursts, NaN poisoning, host-loop
    crashes) over the serve prompts at priorities 0/1, chunked at 512, on
    a warmed pooled async Engine under a TickClock."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (ChaosSpec, FaultInjector, FinishReason,
                                     Request, TickClock, chaos_trace)
    inj = FaultInjector(chaos_trace(ChaosSpec(**CHAOS_SPEC)))
    eng, _ = _graph_engine(state, cfg, DEGRADE_POOL, async_host=True,
                           prefill_chunk=CHUNK,
                           host_spill_bytes=DEGRADE_SPILL,
                           clock=TickClock(0.01), faults=inj)
    _, reqs = _serve_requests(cfg)
    reset_launch_counts()                                    # main path only
    t0 = time.monotonic()
    hs = [eng.submit(Request(prompt=r.prompt, max_new=CHAOS_NEW,
                             seed=r.seed, priority=i % 2))
          for i, r in enumerate(reqs)]
    ticks = 0
    while eng.step():
        ticks += 1
        check(ticks < 400, "serve_degrade (b): engine still busy")
    eng.drain()
    wall = time.monotonic() - t0
    counts = launch_counts()
    _check_degrade_path(cfg, eng, counts, "serve_degrade (b)")
    audit = eng.check_invariants()
    c = eng.stats()["counters"]
    check(all(h.finished and FinishReason.valid(h.finish_reason)
              for h in hs), f"serve_degrade (b): a stream hung: {hs}")
    check(inj.done, f"serve_degrade (b): injector not done: {inj.stats()}")
    check(c["nan_quarantines"] == inj.injected["nan"],
          f"serve_degrade (b): {c['nan_quarantines']} quarantines for "
          f"{inj.injected['nan']} NaN events")
    clean = [list(h.tokens) == s[:CHAOS_NEW] for h, s in
             zip(hs, state["serve_streams"]) if h.finish_reason == "length"]
    check(all(clean), f"serve_degrade (b): a surviving stream differs from "
          f"the serve phase's: {clean}")
    out = {"reasons": [h.finish_reason for h in hs],
           "streams": [list(h.tokens) for h in hs],
           "counters": c, "injector": inj.stats(), "audit": audit,
           "ticks": ticks, "wall_s": wall,
           "decode_steps": eng.n_decode_steps, "launches": counts}
    eng.close()
    return out


def _ends_in_place(eng, log):
    """Step wrapper for (c): after each tick, every stream that ended in
    it holds no block (its slot's table rows are empty) and the pool's
    used count is the blocks the remaining tables hold."""
    step = eng.step
    pool = next(iter(eng._pools.values()))

    def stepped():
        before = {h: i for i, h in enumerate(eng._slot_handle)
                  if h is not None}
        queued = list(eng._queue)
        worked = step()
        for h in queued + list(before):
            if h._sched_fin in ("deadline", "cancelled") and \
                    h.rid not in {e["rid"] for e in log}:
                slot = before.get(h)
                held = int((pool.tables != 0).sum())
                log.append({"rid": h.rid, "reason": h._sched_fin,
                            "tick": eng._tick, "was_running": slot is not None,
                            "slot_row_blocks": (int((pool.tables[slot] != 0)
                                                    .sum()) if slot is not None
                                                else 0),
                            "used": pool.used(), "table_blocks": held})
        return worked
    eng.step = stepped


def _deadline_run(state, cfg):
    """(c) Deadlines, cancel and a one-chunk timeout under a TickClock of
    one second a tick: a running request past its deadline, a queued one
    past its deadline and a cancelled running one each end in the tick
    they are due, holding no block after it; one slow chunk trips the
    watchdog once and sheds nothing; the survivors' streams equal the
    serve phase's."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (ChaosEvent, FaultInjector, Request,
                                     TickClock)
    inj = FaultInjector([ChaosEvent(tick=4, kind="timeout", duration=1,
                                    magnitude=99.0)])
    eng, _ = _graph_engine(state, cfg, DEGRADE_POOL, async_host=True,
                           host_spill_bytes=DEGRADE_SPILL,
                           clock=TickClock(1.0), faults=inj,
                           step_timeout_s=30.0, watchdog_max_trips=2)
    _, reqs = _serve_requests(cfg)
    log = []
    _ends_in_place(eng, log)
    reset_launch_counts()                                    # main path only
    run = eng.submit(Request(prompt=reqs[0].prompt, max_new=SERVE_NEW,
                             seed=0, deadline_ms=2500.0))
    cancel = eng.submit(Request(prompt=reqs[3].prompt, max_new=SERVE_NEW,
                                seed=3))
    keep = [eng.submit(reqs[i]) for i in (1, 6)]
    queued = eng.submit(Request(prompt=reqs[4].prompt, max_new=SERVE_NEW,
                                seed=4, deadline_ms=1500.0))
    eng.step()
    cancel.cancel()
    ticks = 1
    while eng.step():
        ticks += 1
        check(ticks < 400, "serve_degrade (c): engine still busy")
    eng.drain()
    counts = launch_counts()
    _check_degrade_path(cfg, eng, counts, "serve_degrade (c)")
    audit = eng.check_invariants()
    c = eng.stats()["counters"]
    want = {run.rid: ("deadline", True), queued.rid: ("deadline", False),
            cancel.rid: ("cancelled", True)}
    got = {e["rid"]: (e["reason"], e["was_running"]) for e in log}
    check(got == want and all(e["slot_row_blocks"] == 0 and e["used"] ==
                              e["table_blocks"] for e in log),
          f"serve_degrade (c): early ends {log}, want {want}")
    check([h.finish_reason for h in (run, queued, cancel)]
          == ["deadline", "deadline", "cancelled"] and not queued.tokens,
          f"serve_degrade (c): {[run, queued, cancel]}")
    check(c["deadline_misses"] == 2 and c["cancelled"] == 1
          and c["watchdog_trips"] == 1 and c["shed"] == 0,
          f"serve_degrade (c): counters {c}")
    same = [list(h.tokens) == state["serve_streams"][i]
            and h.finish_reason == "length" for h, i in zip(keep, (1, 6))]
    check(all(same), f"serve_degrade (c): survivors differ: {same}")
    out = {"ends": log, "counters": c, "audit": audit,
           "tokens_before_deadline": len(run.tokens),
           "tokens_before_cancel": len(cancel.tokens),
           "decode_steps": eng.n_decode_steps, "launches": counts}
    eng.close()
    return out


def _watchdog_run(state, cfg):
    """(c) The watchdog on the real clock: ``step_timeout_s`` below a
    replayed chunk's time and two trips allowed shed every stream after
    the second chunk; the audit is clean and the pool empty."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Request
    eng, _ = _graph_engine(state, cfg, DEGRADE_POOL, async_host=True,
                           host_spill_bytes=DEGRADE_SPILL,
                           step_timeout_s=0.05, watchdog_max_trips=2)
    _, reqs = _serve_requests(cfg)
    reset_launch_counts()                                    # main path only
    hs = [eng.submit(Request(prompt=reqs[i].prompt, max_new=SERVE_NEW,
                             seed=i)) for i in (0, 1, 3, 7, 4)]
    ticks = 0
    while eng.step():
        ticks += 1
        check(ticks < 10, "serve_degrade (c): the watchdog never fired")
    eng.drain()
    counts = launch_counts()
    _check_degrade_path(cfg, eng, counts, "serve_degrade watchdog")
    audit = eng.check_invariants()
    c, st = eng.stats()["counters"], eng.stats()
    check(c["watchdog_trips"] == 2 and c["shed"] == len(hs)
          and all(h.finish_reason == "shed" for h in hs)
          and eng.n_decode_steps == 2 * SERVE_SPS
          and st["used"] == 0 and st["reserved"] == 0,
          f"serve_degrade watchdog: {c}, {[h.finish_reason for h in hs]}, "
          f"{eng.n_decode_steps} steps")
    out = {"step_timeout_s": 0.05, "counters": c, "audit": audit,
           "decode_steps": eng.n_decode_steps, "launches": counts}
    eng.close()
    return out


def _guard_abba(eng, cfg):
    """Replayed chunks at 4 x 2048 with the NaN guard input (the Engine's
    graph) against the same step captured without it (the graph of the
    serve phases before the guard), in ABBA turns on one Engine."""
    import numpy as np
    import torch
    from repro_torch.serving import decode_one
    _load_slots(eng, cfg)
    dev, b = eng.device, eng.batch_slots
    tok = torch.as_tensor(eng._tok, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    temps = torch.zeros(b, dtype=torch.float32, device=dev)
    eos = torch.full((b,), -1, dtype=torch.int64, device=dev)
    host_t = np.zeros(b, np.float32)
    gens = [None] * b

    def bare(token, done, bad, live, temps, eos, unif):
        return decode_one(eng.params, cfg, eng.schedule, token, eng._caches,
                          done, bad, live, temps, eos, unif, calib=eng.calib,
                          backend=eng.backend)
    static = (tok.clone(), done.clone(), done.clone(),
              torch.zeros(b, dtype=torch.int32, device=dev), temps.clone(),
              eos.clone(), eng._unif)
    eng._graphs.warm("decode_step_bare", bare, static)

    def unguarded():
        t, d = tok, done
        bad = torch.zeros(b, dtype=torch.bool, device=dev)
        live = torch.zeros(b, dtype=torch.int32, device=dev)
        for _ in range(SERVE_SPS):
            t, d, bad, live = eng._graphs.call(
                "decode_step_bare", bare, t[:, None] if t.dim() == 1 else t,
                d, bad, live, temps, eos, eng._unif)
    guarded = lambda: eng._decode_steps(SERVE_SPS, tok, done, temps, eos,
                                        gens, host_t)
    return _abba({"unguarded": unguarded, "guarded": guarded})


def phase_serve_degrade(state):
    """The degradation ladder and fault model (DESIGN.md §11) at llama2-7b
    width: the batch-of-1 check, (a) preemption with spill and restore,
    (b) a chaos trace replayed twice, (c) deadlines, cancel and the
    watchdog, block read/write costs, and the guard's step cost."""
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as T
    cfg = configs.get("llama2_7b")
    state["params"] = T.init_params(cfg, seed=0, dtype=torch.bfloat16,
                                    device=torch.device("cuda"))
    eng_s, single = _batch_of_one(state, cfg)
    _add_launches(state, single["launches"])
    eng_a, preempt = _preempt_run(state, cfg)
    _add_launches(state, preempt["launches"])
    rw = _read_write_ms(eng_a)
    eng_a.close()
    del eng_a
    gc.collect()
    runs = [_chaos_run(state, cfg) for _ in range(2)]
    for r in runs:
        _add_launches(state, r["launches"])
    keys = ("reasons", "streams", "counters", "injector")
    same = {k: runs[0][k] == runs[1][k] for k in keys}
    check(all(same.values()), f"serve_degrade (b): the chaos replay "
          f"diverged: {same}")
    deadlines = _deadline_run(state, cfg)
    _add_launches(state, deadlines["launches"])
    watchdog = _watchdog_run(state, cfg)
    _add_launches(state, watchdog["launches"])
    guard = _guard_abba(eng_s, cfg)
    eng_s.close()
    del eng_s
    gc.collect()
    torch.cuda.empty_cache()
    chaos = dict(runs[0], streams=None, replay_equal=same,
                 spec=dict(CHAOS_SPEC, kinds=list(CHAOS_SPEC["kinds"])),
                 max_new=CHAOS_NEW, second_wall_s=runs[1]["wall_s"])
    emit({"phase": "serve_degrade", "arch": cfg.name, "max_len": MAX_LEN,
          "slots": SERVE_SLOTS, "steps_per_sync": SERVE_SPS,
          "gpu": state["gpu"], "batch_of_one": single, "preempt": preempt,
          "block_copies": rw, "chaos": chaos, "deadlines": deadlines,
          "watchdog": watchdog, "abba_guard_4x2048": guard})


# --------------------------------------------------------------- table6

T6_CONTEXTS = (32768, 131072)        # the batch-1 rows of every policy
T6_HEADLINE = 1_048_576              # the paper's 1M-token context
T6_HEADS = 4                         # kv heads of the 1M decode_attn check
# memory a quantized row may hold beyond what it held when it began and
# its planes (PERF.md section 2 has the measured values): the allocator's
# rounding of the filled planes (up to 1 MiB a leaf left unsplit); the
# fill's transients (a chunk's bf16 draws and the quantizer's, 0.60-2.29e9
# B); the decode steps' (the mask, the split partials, the capture
# stream's 32 MiB cuBLAS workspace: 45-78e6 B), under one layer's planes
# from 131072 tokens on (262e6 B for kv2), so that a copy of a layer's
# planes in the step fails the row there and at 1M
T6_PLANES_SLACK = 16 << 20
T6_FILL_SLACK = 3 << 30
T6_STEP_SLACK = 128 << 20


def _t6_plain_chunk(cfg, dev):
    """The filler's first chunk of layer 0 (``FILL_CHUNK`` tokens, its
    packed rows past the sinks) through the filler's quantizer (the bulk
    kernel) and through ``kv_quant_plain`` on the card: the plain planes,
    which the 1M cache must hold, and the bytes that differ."""
    from repro_torch.core.policy import PAPER_POLICY as pol
    from repro_torch.kernels.kv_quant import kv_quant_plain
    from repro_torch.kernels.ops import make_kernel_quant_fn
    from repro_torch.speed import memory_latency as ML
    k, v = ML.seeded_kv(cfg, 0, dev)(0, 0, ML.FILL_CHUNK)
    qf = make_kernel_quant_fn()
    want, diff = {}, 0
    for name, x, bits in (("qk", k, pol.bits_k), ("qv", v, pol.bits_v)):
        rows = x[:, pol.n_sink:]
        got = qf(rows, bits, pol.group_size, None, pol.fp8_meta)
        plain = kv_quant_plain(rows.reshape(-1, cfg.head_dim), bits,
                               pol.group_size, None, pol.fp8_meta)
        for kk, t in plain.items():
            t = t.reshape(got[kk].shape)
            diff += int((_u8(t) != _u8(got[kk])).sum())
            want[f"{name}_{kk}"] = t
    return want, diff, rows.shape[1] * cfg.n_kv_heads


def _t6_probe(cfg, caches, want, dev):
    """Layer 0 of the filled 1M cache: (a) the packed rows of the first
    chunk against the plain quantizer's, byte for byte; (b) decode_attn
    over every kv head (the step's launch) and over a slice of
    ``T6_HEADS`` heads, each against ``decode_attn_plain`` on that slice
    (f32 tolerance).  ``_t6_row`` runs it between the fill's launch
    counts and the steps'."""
    import torch
    from repro_torch.core import segments as seg
    from repro_torch.core.policy import PAPER_POLICY as pol
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attn import (BLOCK_S, decode_attn,
                                                 decode_attn_plain)
    layer = {k: t[0] for k, t in caches["scan"].items()}
    n = next(iter(want.values())).shape[1]
    diff = sum(int((_u8(t) != _u8(layer[k][:, :n])).sum())
               for k, t in want.items())
    k_qt = {kk[3:]: t for kk, t in layer.items() if kk.startswith("qk_")}
    v_qt = {kk[3:]: t for kk, t in layer.items() if kk.startswith("qv_")}
    s_q = k_qt["codes_hi"].shape[1]
    bs, s_pad = ops._block_pad(s_q, BLOCK_S)
    lens = layer["length"]
    ok = ops._packed_ok(ops._padded_j(s_q, s_pad, dev), lens, lens - 1,
                        seg.effective_window(None), pol, 1)
    bounds = seg.packed_block_bounds(ok, bs)
    mask = ok.to(torch.float32)
    g = torch.Generator(device=dev).manual_seed(6)
    d = cfg.head_dim
    q = torch.randn((1, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, d),
                    generator=g, device=dev)
    args = dict(block_s=bs, block_bounds=bounds)
    full = decode_attn(q, k_qt, v_qt, mask, pol, d, d ** -0.5, **args)
    h = T6_HEADS
    ks = {kk: t[:, :, :h].contiguous() for kk, t in k_qt.items()}
    vs = {kk: t[:, :, :h].contiguous() for kk, t in v_qt.items()}
    t0 = time.monotonic()
    plain = decode_attn_plain(q[:, :h], ks, vs, mask, pol, d, d ** -0.5,
                              **args)
    plain_s = time.monotonic() - t0
    sliced = decode_attn(q[:, :h], ks, vs, mask, pol, d, d ** -0.5, **args)
    err = {"all_heads": _check_attn("table6 1M decode_attn (every head)",
                                    tuple(t[:, :h] for t in full), plain),
           "head_slice": _check_attn("table6 1M decode_attn (4 heads)",
                                     sliced, plain)}
    return {"chunk_rows_diff_bytes": diff, "chunk_tokens": n,
            "decode_attn_max_abs_err": err, "heads": h, "packed": s_q,
            "live_packed": int((mask > 0).sum()), "plain_s": plain_s}


def _t6_row(state, params, cfg, label, pol, backend, context, probe=None):
    """One measured row (``speed.memory_latency.measure``) with its launch
    counts: the fill's and the steps', each read from 0, added to the
    script's totals (a ``probe`` runs between them and reports its own
    launches under ``"launches"``, outside the totals).  A quantized row's
    launches are gated: ``kv_append`` and ``decode_attn`` once a layer a
    step, the bulk quantizer twice a layer a filled chunk, no plain call;
    an fp16 row's steps take the fp16 route and launch neither kernel.  A
    quantized row's memory is gated too: the fill leaves the planes and
    nothing else (``T6_PLANES_SLACK``), its peak stays within
    ``T6_FILL_SLACK`` of them, and the steps hold at most
    ``T6_STEP_SLACK`` above the filled cache."""
    from repro_torch.kernels import (launch_count_delta, launch_counts,
                                     reset_launch_counts)
    from repro_torch.speed import memory_latency as ML
    fill = {}

    def between(caches):
        fill.update(launch_counts())
        out = probe(caches)
        out["launches"] = launch_count_delta(fill, launch_counts())
        reset_launch_counts()
        return out
    reset_launch_counts()
    r = ML.measure(params, cfg, pol, context, device=params["embed"].device,
                   backend=backend, probe=between if probe else None)
    counts = launch_counts()
    counts = {k: {c: n + fill.get(k, {}).get(c, 0) for c, n in d.items()}
              for k, d in counts.items()}
    _add_launches(state, counts)
    r["launches"] = counts
    if not r["fits"]:
        return r
    steps = r["length_after"] - context
    n = cfg.n_layers
    kq, da, f16 = counts["kv_quant"], counts["decode_attn"], counts["fp16"]
    what = f"table6 {label} at {context}"
    check(r["finite"], f"{what}: logits not finite")
    check(kq["plain"] == kq["append_plain"] == da["plain"] == 0,
          f"{what}: a plain version ran: {counts}")
    if pol.is_fp16:
        check(kq["kernel"] == kq["append"] == da["kernel"] == 0
              and f16["attend"] == (n * steps if backend == "cuda" else 0)
              and f16["append"] == n * steps,
              f"{what}: launches {counts} for {steps} fp16 steps")
    else:
        # the filled chunks that hold packed rows: [ns, context - window)
        chunks = -(-(context - pol.window) // ML.FILL_CHUNK)
        check(da["kernel"] == kq["append"] == n * steps
              and kq["kernel"] == 2 * n * chunks,
              f"{what}: launches {counts} for {steps} steps and {chunks} "
              f"filled chunks a layer")
        layer = r["cache_bytes"] // n
        planes = r["step_base_mem_bytes"] - r["base_mem_bytes"]
        fill_temp = r["fill_peak_mem_bytes"] - r["step_base_mem_bytes"]
        step_temp = r["step_peak_mem_bytes"] - r["step_base_mem_bytes"]
        r["mem_gate"] = {"planes_left": planes, "fill_temp": fill_temp,
                         "step_temp": step_temp, "layer_planes": layer,
                         "step_slack": T6_STEP_SLACK,
                         "fill_slack": T6_FILL_SLACK}
        check(0 <= planes - r["cache_bytes"] <= T6_PLANES_SLACK,
              f"{what}: the fill left {planes} B allocated for "
              f"{r['cache_bytes']} B of planes")
        check(fill_temp <= T6_FILL_SLACK,
              f"{what}: the fill peaked {fill_temp} B above its planes "
              f"(limit {T6_FILL_SLACK})")
        check(step_temp <= T6_STEP_SLACK,
              f"{what}: the steps held {step_temp} B above the filled "
              f"cache (limit {T6_STEP_SLACK}, one layer's planes {layer})")
    return r


def phase_table6(state):
    """Paper Table 6 on the card (``repro_torch.speed.memory_latency``) at
    llama2-7b's full width and depth with serve_degrade's weights: the
    batch-1 rows of kv2, kv4 and fp16 (the route and SDPA) at 32768 and
    131072 tokens, the 1,048,576-token kv2 headline with its probe, and
    the kernel suite's ragged and backend-drift gates."""
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.speed import kernel_bench as KB
    from repro_torch.speed import memory_latency as ML
    dev = torch.device("cuda")
    cfg = configs.get("llama2_7b")
    params = state["params"]
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(dev).total_memory
    before = {"allocated_bytes": torch.cuda.memory_allocated(),
              "free_bytes": torch.cuda.mem_get_info()[0],
              "total_bytes": total}
    suite = []
    ragged = KB._bench_ragged_occupancy(suite.append, smoke=False, device=dev)
    drift = KB._bench_decode_step_backends(suite.append, smoke=False,
                                           device=dev)["drift"]
    want, diff, rows = _t6_plain_chunk(cfg, dev)
    check(diff == 0, f"table6: the filler's chunk differs from "
          f"kv_quant_plain in {diff} bytes")
    csv, out = [], {}
    for s in T6_CONTEXTS:
        for label, pol, bk in ML.POLICIES:
            r = _t6_row(state, params, cfg, label, pol, bk, s)
            ML.measured_row(csv.append, label, r, ML.analytic_ms(label, s))
            out[f"{label}_s{s}"] = r
            check(r["fits"] or label.startswith("fp16"),
                  f"table6: {label} at {s} tokens did not fit: {r}")
    gc.collect()
    torch.cuda.empty_cache()
    head = _t6_row(state, params, cfg, "kv2", PAPER_POLICY, "cuda",
                   T6_HEADLINE, probe=lambda c: _t6_probe(cfg, c, want, dev))
    del want
    ML.measured_row(csv.append, "kv2", head,
                    ML.analytic_ms("kv2", T6_HEADLINE))
    check(head["fits"], f"table6: the {T6_HEADLINE}-token kv2 cache did not "
          f"fit: {head}")
    check(head["probe"]["chunk_rows_diff_bytes"] == 0,
          f"table6: the 1M cache's first chunk differs from kv_quant_plain: "
          f"{head['probe']}")
    check(head["peak_mem_bytes"] < total,
          f"table6: peak {head['peak_mem_bytes']} >= the card's {total}")
    state.pop("params", None)
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "table6", "arch": cfg.name, "gpu": state["gpu"],
          "before": before, "chunk_check": {"rows": rows, "diff_bytes": diff},
          "headline": head, "rows": out, "csv": csv,
          "kernel_suite": {"ragged": {f"{o}_{k}": v for (o, k), v in
                                      ragged.items()},
                           "drift": drift, "rows": suite}})


# ------------------------------- serve_families (gemma local/global, M-RoPE)

GEMMA2_LENS, GEMMA2_NEW = [1024, 3000, 5000, 6000], 32
GEMMA2_MAX_LEN = 8325            # 5 sinks + 128 window + 8192 packed tokens
FAMILY_LIVE = [500, 1500, 2900, 3900]          # packed tokens of the rows
GEMMA2_LIVE = [900, 2800, 4800, 5800]
PATCH_GRID, TEXT_LEN, EMBED_STEPS = 16, 32, 8   # qwen2-vl's embeds run


def _family_engine(params, cfg, warm, max_len=MAX_LEN, pool_blocks=None,
                   prefill_chunk=None, steps_per_sync=SERVE_SPS):
    """An Engine of the serve shape for one of the new families (eager, or
    warmed with one captured decode step)."""
    import gc
    import torch
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.serving import Engine
    gc.collect()
    torch.cuda.empty_cache()
    eng = Engine(params, cfg, PAPER_POLICY, batch_slots=SERVE_SLOTS,
                 max_len=max_len, steps_per_sync=steps_per_sync,
                 backend="cuda", pool_blocks=pool_blocks,
                 pool_block_tokens=POOL_BT,
                 prefill_chunk=prefill_chunk, device=torch.device("cuda"))
    rep = None
    if warm:
        rep = eng.warmup()
        check(rep["n_graphs"] == 1 and rep["post_warmup_misses"] == 0,
              f"{cfg.name}: warmup captured no decode step: {rep}")
    return eng, rep


def _block_probe(eng, cfg):
    """Wrap the Engine's decode chunk: before its first chunk, the pruning
    report (``decode_block_report``, the kernel's [lo, hi) bounds) of the
    first local and the first global layer, by slot with each slot's
    prompt length; returns the dict it fills."""
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.kernels.ops import decode_block_report
    probe = {}
    chunk = eng._decode_chunk
    kinds = {}
    for i in range(cfg.n_layers):
        kinds.setdefault("local" if cfg.layer_is_local(i) else "global", i)

    def first():
        if not probe:
            lens = [None if h is None else len(h.request.prompt)
                    for h in eng._slot_handle]
            for kind, i in kinds.items():
                rep = decode_block_report(
                    {k: v[i] for k, v in eng._caches["scan"].items()},
                    PAPER_POLICY, cfg.head_dim,
                    window=cfg.local_window if kind == "local" else 0)
                probe[kind] = {"layer": i, "prompt_lens": lens,
                               "lo": rep["bounds"][:, 0].tolist(),
                               "visited": rep["visited"].tolist(),
                               "total": rep["total"]}
        chunk()
    eng._decode_chunk = first
    return probe


def _family_serve(state, cfg, eng, reqs, what):
    """``reqs`` through ``eng``: every request finished at its budget, the
    main path's launch identities for its mode (eager, replayed or
    chunked), the launches added to the kernel line's totals.  Returns the
    streams, each request's last prompt logits (whole, or of its final
    chunk; f32 on the host) and the run's report."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    logits = {}
    if eng.prefill_chunk:
        finish = eng._finish_prefill

        def keep(job, lg):
            logits[job.handle.rid] = lg[0, -1].float().cpu()
            finish(job, lg)
        eng._finish_prefill = keep
        prefills = None
    else:
        prefills = _counted_prefills(eng, logits)
    chunks = _timed_chunks(eng)
    torch.cuda.synchronize()
    reset_launch_counts()                                    # main path only
    t0 = time.monotonic()
    handles = [eng.submit(r) for r in reqs]
    eng.run(handles)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    check(all(h.finished and h.finish_reason == "length"
              and len(h.tokens) == r.max_new
              and all(0 <= t < cfg.vocab_size for t in h.tokens)
              for h, r in zip(handles, reqs)),
          f"{what}: not every request finished: "
          f"{[(h.finish_reason, len(h.tokens)) for h in handles]}")
    steps = eng.n_decode_steps
    if eng.prefill_chunk:
        _check_chunked_path(cfg, eng, counts, _evicting_chunks(
            [len(r.prompt) for r in reqs], eng.prefill_chunk), what)
    elif eng.warmup_report()["warmed"]:
        _check_graph_path(cfg, eng, counts, prefills, what)
    else:
        check(counts["decode_attn"]["kernel"] == cfg.n_layers * steps,
              f"{what}: decode_attn launches {counts['decode_attn']} != "
              f"layers x steps = {cfg.n_layers * steps}")
        _check_main_path(cfg, counts, steps, len(prefills), what)
    if eng.stats()["pooled"]:
        eng.check_invariants()
    _add_launches(state, counts)
    tokens = sum(len(h.tokens) for h in handles)
    return [list(h.tokens) for h in handles], [logits[h.rid]
                                                for h in handles], {
        "decode_steps": steps, "wall_s": wall, "tokens": tokens,
        "tokens_per_s": tokens / wall,
        "engine_ms_per_step": spread([ms for ms, _ in chunks[1:]]
                                      or [ms for ms, _ in chunks]),
        "launches": counts}


def _replayed_step_ms(eng, cfg, chunks: int = 4):
    """CUDA-event ms per replayed step of a warmed Engine with its slots
    loaded at STEP_CONTEXT (``_load_slots``), over ``chunks`` chunks, and
    the function that runs one such chunk of SERVE_SPS replays."""
    import numpy as np
    import torch
    _load_slots(eng, cfg)
    dev = eng.device
    tok = torch.as_tensor(eng._tok, device=dev)
    done = torch.zeros(SERVE_SLOTS, dtype=torch.bool, device=dev)
    temps = torch.zeros(SERVE_SLOTS, dtype=torch.float32, device=dev)
    eos = torch.full((SERVE_SLOTS,), -1, dtype=torch.int64, device=dev)
    run = lambda: eng._decode_steps(SERVE_SPS, tok, done, temps, eos,
                                    [None] * SERVE_SLOTS,
                                    np.zeros(SERVE_SLOTS, np.float32))
    run()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(chunks + 1)]
    ev[0].record()
    for e in ev[1:]:
        run()
        e.record()
    torch.cuda.synchronize()
    return spread([a.elapsed_time(b) / SERVE_SPS
                    for a, b in zip(ev, ev[1:])]), run


def _family_init(cfg):
    """Random bf16 weights of ``cfg`` from seed 0 on the card (the peak
    memory counter restarts here)."""
    import torch
    from repro_torch.models import transformer as T
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16,
                           device=torch.device("cuda"))
    torch.cuda.synchronize()
    n = sum(v.numel() for v in _leaves(params))
    return params, {"params_init_s": time.monotonic() - t0, "params": n,
                    "weight_bytes": 2 * n}


def _leaves(tree):
    import torch
    if torch.is_tensor(tree):
        return [tree]
    return [x for v in tree.values() for x in _leaves(v)]


def _eager_requests(cfg):
    """Mix (a)'s 8 requests at EAGER_NEW_FAMILY new tokens each (both
    waves, across one sync a wave): the eager run that the replayed ones
    are held to."""
    import dataclasses
    return [dataclasses.replace(r, max_new=EAGER_NEW_FAMILY)
            for r in _serve_requests(cfg)[1]]


def _mix_a(state, cfg, params, what, chunked=True, pooled=True):
    """Mix (a) through an eager striped Engine (EAGER_NEW_FAMILY new tokens
    a request), then warmed striped, pooled (768 blocks) and chunked (512)
    Engines (SERVE_NEW): the replayed streams begin with the eager ones,
    pooled streams equal the replayed striped ones, final-chunk logits
    within relative L2 0.05 of whole-prompt."""
    import gc
    import torch
    eng, _ = _family_engine(params, cfg, False, steps_per_sync=EAGER_SPS)
    probe = _block_probe(eng, cfg)
    streams, whole, eager = _family_serve(
        state, cfg, eng, _eager_requests(cfg), f"{what} eager striped")
    del eng
    runs = {"eager_striped": dict(eager, blocks=probe,
                                  new_tokens=EAGER_NEW_FAMILY)}
    striped = None
    modes = [("graph_striped", {})]
    if pooled:
        modes.append(("graph_pooled", {"pool_blocks": 768}))
    if chunked:
        modes.append(("graph_chunked", {"prefill_chunk": CHUNK}))
    for name, kw in modes:
        eng, warm = _family_engine(params, cfg, True, **kw)
        got, final, rep = _family_serve(
            state, cfg, eng, _serve_requests(cfg)[1], f"{what} {name}")
        del eng
        gc.collect()
        same = [a[:EAGER_NEW_FAMILY] == b for a, b in zip(got, streams)]
        rep.update(warmup=warm, streams_equal_eager=same)
        if name == "graph_striped":
            striped = got
        if name == "graph_chunked":
            rel = [float((final[i] - whole[i]).norm() / whole[i].norm())
                   for i in range(len(SERVE_LENS))]
            check(max(rel) <= LOGIT_REL_TOL and all(
                bool(torch.isfinite(v).all()) for v in final),
                f"{what}: final-chunk logits vs whole-prompt relative L2 "
                f"{max(rel):.4f} > {LOGIT_REL_TOL}")
            rep.update(final_logits_rel_l2_vs_whole=rel,
                       final_logits_bitwise_whole=[
                           bool(torch.equal(final[i], whole[i]))
                           for i in range(len(SERVE_LENS))])
        else:
            check(all(same), f"{what} {name}: streams differ from the "
                  f"eager striped streams (request equal: {same})")
        if name == "graph_pooled":
            same = [a == b for a, b in zip(got, striped)]
            rep["streams_equal_graph_striped"] = same
            check(all(same), f"{what} {name}: streams differ from the "
                  f"replayed striped streams (request equal: {same})")
        runs[name] = rep
    return runs


def _unroll_turns(params, cfg):
    """(b) From one 4 x 2048 prefill: the unrolled step (local layers over
    their hoisted 1024-token slices, pre-append) against the default step:
    logits relative L2 (gated at 0.05) and top-1, the launches of one
    unrolled step, and eager step times in ABBA turns from cloned
    caches."""
    import numpy as np
    import torch
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as T
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    batch = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                         (SERVE_SLOTS, STEP_CONTEXT)),
                            device=dev)
    _, base = T.prefill_model(params, cfg, batch, PAPER_POLICY,
                              max_len=MAX_LEN, backend="cuda")
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, 1)),
                          device=dev)
    step = {"default": lambda c: T.decode_step(params, cfg, tok, c,
                                               PAPER_POLICY, backend="cuda"),
            "unrolled": lambda c: T.decode_step(params, cfg, tok, c,
                                                PAPER_POLICY, backend="cuda",
                                                unroll=True)}
    ld = step["default"](_clone(base))[0][:, -1].float()
    torch.cuda.synchronize()
    reset_launch_counts()
    lu = step["unrolled"](_clone(base))[0][:, -1].float()
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["decode_attn"]["kernel"] == cfg.n_layers
          and counts["kv_quant"]["append"] == cfg.n_layers
          and counts["decode_attn"]["plain"] == 0,
          f"unrolled step: launches {counts}")
    check(bool(torch.isfinite(lu).all()), "unrolled logits not finite")
    rel = float((lu - ld).norm() / ld.norm())
    check(rel <= LOGIT_REL_TOL, f"unrolled vs default step: relative L2 "
          f"{rel:.4f} > {LOGIT_REL_TOL}")
    return {"context": STEP_CONTEXT, "local_layers": sum(
        cfg.layer_is_local(i) for i in range(cfg.n_layers)),
        "slice_tokens": cfg.local_window, "logits_rel_l2": rel,
        "top1_agreement": float((lu.argmax(-1) == ld.argmax(-1)).float()
                                .mean()), "launches_one_step": counts}


UNROLL_MESH_STEPS = 4            # unrolled steps on the 1-rank mesh
UNROLL_MESH_TOL = 1e-5           # logits' relative L2 against one device


def _decode_attn_spy():
    """Wrap ``kernels.ops.decode_attn`` (the wrapper the cuda backend's
    attention calls) to record the token count of the packed planes each
    launch walks; returns (the list, a function that unwraps it)."""
    from repro_torch.kernels import ops
    real, seen = ops.decode_attn, []

    def spy(qg, k_qt, *a, **kw):
        seen.append(int(k_qt["codes_hi"].shape[1]))
        return real(qg, k_qt, *a, **kw)
    ops.decode_attn = spy
    return seen, lambda: setattr(ops, "decode_attn", real)


def _unroll_mesh(params, cfg):
    """(b') The unrolled step on a 1-rank ("pod", "data", "model") mesh on
    NCCL under SERVE_RULES (the cache, params and tokens DTensors laid
    out by ``launch.shardings``; each layer's append and attention run on
    the rank's rows and heads through ``run_local``) against the same
    step on plain tensors, from one 4 x 2048 prefill, for
    UNROLL_MESH_STEPS steps of seeded tokens: every cache leaf byte-equal
    after every step, logits within UNROLL_MESH_TOL relative L2, and one
    sharded step's launches: one decode_attn and one kv_append a layer,
    the local layers' decode_attn over their local_window-token slice."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.distributed import sharding as S
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.launch.shardings import (cache_shardings,
                                              params_shardings, place,
                                              token_sharding)
    from repro_torch.models import transformer as T
    t0 = time.monotonic()
    dev = init_world(init_method=f"tcp://localhost:{_free_port()}",
                     world_size=1, rank=0)
    mesh = make_mesh((1, 1, 1), DIST_AXES)
    rng = np.random.default_rng(9)
    batch = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                         (SERVE_SLOTS, STEP_CONTEXT)),
                            device=dev)
    with torch.no_grad():
        _, plain = T.prefill_model(params, cfg, batch, PAPER_POLICY,
                                   max_len=MAX_LEN, backend="cuda")
    sharded = place(_clone(plain), cache_shardings(plain, cfg, mesh), mesh)
    pm = place(params, params_shardings(params, mesh), mesh)
    n_local = sum(cfg.layer_is_local(i) for i in range(cfg.n_layers))
    out = {"steps": UNROLL_MESH_STEPS, "mesh": [1, 1, 1], "backend": "nccl",
           "rules": "SERVE_RULES", "logits_rel_l2": [], "local_layers":
           n_local, "slice_tokens": cfg.local_window}
    for i in range(UNROLL_MESH_STEPS):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (SERVE_SLOTS, 1)), device=dev)
        with torch.no_grad():
            lp, plain = T.decode_step(params, cfg, tok, plain, PAPER_POLICY,
                                      backend="cuda", unroll=True)
            torch.cuda.synchronize()
            reset_launch_counts()
            seen, unspy = _decode_attn_spy()
            try:
                with S.sharded_region(mesh, S.SERVE_RULES):
                    ls, sharded = T.decode_step(
                        pm, cfg, S.distribute(tok, token_sharding(tok, mesh),
                                              mesh),
                        sharded, PAPER_POLICY, backend="cuda", unroll=True)
                    ls = ls.full_tensor()
                torch.cuda.synchronize()
            finally:
                unspy()
        counts = launch_counts()
        n_slice = sum(n == cfg.local_window for n in seen)
        check(counts["decode_attn"]["kernel"] == cfg.n_layers
              and counts["kv_quant"]["append"] == cfg.n_layers
              and counts["decode_attn"]["plain"] == 0
              and counts["kv_quant"]["append_plain"] == 0
              and n_slice == n_local and len(seen) == cfg.n_layers,
              f"unrolled step on the mesh, step {i}: launches {counts}, "
              f"{n_slice} of {len(seen)} decode_attn over "
              f"{cfg.local_window}-token slices")
        lp, ls = lp.float(), ls.float()
        rel = float((ls - lp).norm() / lp.norm())
        out["logits_rel_l2"].append(rel)
        check(bool(torch.isfinite(ls).all()) and rel <= UNROLL_MESH_TOL,
              f"unrolled step on the mesh, step {i}: logits relative L2 "
              f"{rel} > {UNROLL_MESH_TOL}")
        for k, a in plain["scan"].items():
            b = sharded["scan"][k].to_local()
            check(a.shape == b.shape and torch.equal(_u8(a), _u8(b)),
                  f"unrolled step on the mesh, step {i}: cache leaf {k} "
                  f"differs from the one-device step's")
    out.update(launches_one_step=counts, slice_launches_one_step=n_slice,
               caches_bytewise=True, seconds=time.monotonic() - t0)
    del pm, plain, sharded
    dist.destroy_process_group()
    return out


def _gemma3(state):
    """(a) + (b): gemma3-4b at full width."""
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_POLICY
    cfg = configs.get("gemma3_4b")
    params, init = _family_init(cfg)
    runs = _mix_a(state, cfg, params, "gemma3")
    backends = _backend_logits(params, cfg, PAPER_POLICY, seed=6)
    unroll = _unroll_turns(params, cfg)
    unroll["mesh"] = _unroll_mesh(params, cfg)
    peak = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    return dict(init, arch=cfg.name, runs=runs, cuda_vs_reference=backends,
                unroll=unroll, peak_mem_bytes=peak)


def _gemma2(state):
    """(c) gemma2-27b at full width on one card: 4 requests through a
    warmed striped Engine; lo > 0 on the local layers for the two long
    prompts; replayed steps at 4 x 2048 (CUDA events); cuda against
    reference logits."""
    import gc
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.serving import Request
    cfg = configs.get("gemma2_27b")
    params, init = _family_init(cfg)
    eng, warm = _family_engine(params, cfg, True, max_len=GEMMA2_MAX_LEN)
    probe = _block_probe(eng, cfg)
    rng = np.random.default_rng(8)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new=GEMMA2_NEW, seed=i)
            for i, n in enumerate(GEMMA2_LENS)]
    _, _, rep = _family_serve(state, cfg, eng, reqs, "gemma2 graph striped")
    replayed, _ = _replayed_step_ms(eng, cfg)
    peak = torch.cuda.max_memory_allocated()
    loc = probe["local"]
    long_lo = [lo for n, lo in zip(loc["prompt_lens"], loc["lo"])
               if n in GEMMA2_LENS[2:]]
    check(len(long_lo) == 2 and min(long_lo) > 0,
          f"gemma2: the local layers' lower bound is 0 for a long prompt: "
          f"{loc}")
    del eng
    gc.collect()
    backends = _backend_logits(params, cfg, PAPER_POLICY, seed=9,
                               context=1024)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(init, arch=cfg.name, max_len=GEMMA2_MAX_LEN,
                prompt_lens=GEMMA2_LENS, max_new=GEMMA2_NEW, warmup=warm,
                run=dict(rep, blocks=probe), peak_mem_bytes=peak,
                replayed_step_ms_4x2048=replayed,
                cuda_vs_reference=backends)


def _patch_inputs(params, cfg, rng, dev):
    """Qwen2-VL-style inputs for the stubbed frontend: TEXT_LEN text
    tokens, a PATCH_GRID x PATCH_GRID grid of patch embeddings, TEXT_LEN
    text tokens, per slot; M-RoPE positions: text (i, i, i), patch (r, c)
    at (T0, T0 + r, T0 + c), the text after at max + 1 on."""
    import numpy as np
    import torch
    g, n = PATCH_GRID, TEXT_LEN
    t0 = n
    text = np.arange(n)
    pt = np.full(g * g, t0)
    ph = t0 + np.repeat(np.arange(g), g)
    pw = t0 + np.tile(np.arange(g), g)
    after = t0 + g + np.arange(n)
    pos = np.stack([np.concatenate([text, pt, after]),
                    np.concatenate([text, ph, after]),
                    np.concatenate([text, pw, after])])
    s = pos.shape[1]
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, s)),
                          device=dev)
    emb = params["embed"][ids]
    patches = (torch.randn((SERVE_SLOTS, g * g, cfg.d_model), device=dev,
                           generator=torch.Generator(dev).manual_seed(3))
               * 0.02).to(emb.dtype)
    emb[:, n:n + g * g] = patches
    positions = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    return emb, positions[:, None].expand(3, SERVE_SLOTS, s).contiguous(), \
        int(pos.max()) + 1


def _embeds_run(params, cfg):
    """(d) One prefill from patch embeddings with distinct (t, h, w)
    positions, then EMBED_STEPS decode steps from embeddings on the cuda
    and the reference backends from the same cache: logits relative L2 per
    step (gated at 0.05), top-1, the cuda side's launches."""
    import numpy as np
    import torch
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as T
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    emb, pos, nxt = _patch_inputs(params, cfg, rng, dev)
    logits, base = T.prefill_model(params, cfg, None, PAPER_POLICY,
                                   max_len=MAX_LEN, backend="cuda",
                                   embeds=emb, positions=pos)
    check(bool(torch.isfinite(logits).all()), "embeds prefill not finite")
    caches = {"cuda": _clone(base), "reference": base}
    rel, top1 = [], []
    reset_launch_counts()
    for step in range(EMBED_STEPS):
        ids = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (SERVE_SLOTS, 1)), device=dev)
        e = params["embed"][ids]
        p3 = torch.full((3, SERVE_SLOTS, 1), nxt + step, dtype=torch.int32,
                        device=dev)
        out = {}
        for name in ("cuda", "reference"):
            lg, caches[name] = T.decode_step(params, cfg, None, caches[name],
                                             PAPER_POLICY, backend=name,
                                             embeds=e, positions=p3)
            out[name] = lg[:, -1].float()
        check(bool(torch.isfinite(out["cuda"]).all()),
              "embeds decode not finite")
        rel.append(float((out["cuda"] - out["reference"]).norm()
                         / out["reference"].norm()))
        top1.append(float((out["cuda"].argmax(-1)
                           == out["reference"].argmax(-1)).float().mean()))
    counts = launch_counts()
    check(max(rel) <= LOGIT_REL_TOL, f"embeds run: cuda vs reference "
          f"relative L2 {max(rel):.4f} > {LOGIT_REL_TOL}")
    check(counts["decode_attn"]["kernel"] == cfg.n_layers * EMBED_STEPS
          and counts["kv_quant"]["append"] == cfg.n_layers * EMBED_STEPS,
          f"embeds run: cuda launches {counts}")
    return {"prompt": {"text": TEXT_LEN, "patches": PATCH_GRID ** 2,
                       "text_after": TEXT_LEN, "tokens": pos.shape[-1]},
            "steps": EMBED_STEPS, "logits_rel_l2": rel,
            "top1_agreement": top1, "cuda_launches": counts}


def _qwen2vl(state):
    """(d) qwen2-vl-7b at full width: mix (a) whole-prompt and striped
    (eager and warmed), cuda against reference logits, and the embeds
    run."""
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_POLICY
    cfg = configs.get("qwen2_vl_7b")
    params, init = _family_init(cfg)
    runs = _mix_a(state, cfg, params, "qwen2-vl", chunked=False,
                  pooled=False)
    backends = _backend_logits(params, cfg, PAPER_POLICY, seed=10)
    embeds = _embeds_run(params, cfg)
    peak = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    return dict(init, arch=cfg.name, runs=runs, cuda_vs_reference=backends,
                embeds=embeds, peak_mem_bytes=peak)


def _slice_case(case, live, window):
    """The per-slot local view the unrolled step hands the kernel: each
    slot's last ``window`` packed tokens of ``case``'s planes, with the
    mask and bounds of a local layer at that window."""
    import torch
    from repro_torch.core import segments as seg
    from repro_torch.kernels import ops
    from repro_torch.models.attention import slice_indices, take_tokens
    pol, q, k_qt, v_qt, _, _, bs = case
    lens = torch.tensor(live, device=q.device) + pol.n_sink + pol.window
    j = slice_indices(lens, pol, window, k_qt["codes_hi"].shape[1])
    k_sl = {k: take_tokens(v, j) for k, v in k_qt.items()}
    v_sl = {k: take_tokens(v, j) for k, v in v_qt.items()}
    bs, s_pad = ops._block_pad(window, bs)
    ok = ops._packed_ok(ops._pad_j(j, s_pad), lens, lens - 1,
                        seg.effective_window(window), pol, q.shape[0])
    return (pol, q, k_sl, v_sl, ok.to(torch.float32),
            seg.packed_block_bounds(ok, bs), bs)


def _family_kernels():
    """Both kernels at the new families' shapes, each against its plain
    version, L2-cold, with its bound (and SDPA for decode_attn)."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    attn = {}

    def row(name, case, **kw):
        mask = case[4]
        live = [int(x) for x in (mask > 0).sum(dim=1).tolist()]
        r = _attn_row(f"decode_attn {name}", *case, live, **kw)
        r["lo"] = case[5][:, 0].tolist()
        attn[name] = r
        return r
    g3 = _attn_case(gen, dev, 4, 4, 2, 256, FAMILY_LIVE)
    row("gemma3 (Hkv 4, Gq 2, D 256)", g3)
    row("gemma3 local_slice 1024", _slice_case(g3, FAMILY_LIVE, 1024))
    del g3
    g2 = _attn_case(gen, dev, 4, 16, 2, 128, GEMMA2_LIVE,
                    max_len=GEMMA2_MAX_LEN, window=4096)
    r = row("gemma2 (Hkv 16, Gq 2, D 128, softcap 50, window 4096)", g2,
            scale=(4608 / 32) ** -0.5, softcap=50.0)
    check(r["lo"][2] > 0 and r["lo"][3] > 0,
          f"gemma2 row: the local window sets no lower bound: {r['lo']}")
    del g2
    row("qwen2-vl (Hkv 4, Gq 7 on the G 8 template, D 128)",
        _attn_case(gen, dev, 4, 4, 7, 128, FAMILY_LIVE))
    torch.cuda.empty_cache()
    append = {f"Hkv {h} D {d}": _append_case(gen, dev, h, d, 128, False)
              for h, d in ((4, 256), (16, 128))}
    quant = {f"K{bits}": _kv_quant_prefill(gen, dev, bits, rows=2867 * 4,
                                           d=256, h=4)
             for bits in (2.0, 1.5)}
    return attn, append, quant


def phase_serve_families(state):
    """The gemma local/global family and qwen2-vl's M-RoPE decoder at full
    width, and both kernels at their head shapes."""
    import gc
    import torch
    state.pop("params", None)
    gc.collect()
    torch.cuda.empty_cache()
    before = {"peak_bytes_so_far": torch.cuda.max_memory_allocated(),
              "allocated_after_free": torch.cuda.memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    head = {"phase": "serve_families", "gpu": state["gpu"]}
    attn, append, quant = _family_kernels()
    for name, rows in (("decode_attn", attn), ("kv_append", append),
                       ("kv_quant", quant)):
        state.setdefault(name, {})["families"] = {
            k: _width_row(r) for k, r in rows.items()}
    emit(dict(head, part="kernels", before=before, decode_attn=attn,
              kv_append=append, kv_quant=quant, atol=ATOL, rtol=RTOL))
    common = {"max_len": MAX_LEN, "slots": SERVE_SLOTS,
              "steps_per_sync": SERVE_SPS}
    emit(dict(head, part="gemma3", **common, **_gemma3(state)))
    emit(dict(head, part="qwen2_vl", **common, **_qwen2vl(state)))
    emit(dict(head, part="gemma2", **_gemma2(state)))


# ------------------------------------------ serve_moe (deepseek, granite-moe)

MOE_PREFILL = 3000               # the longest serve prompt, timed alone
PREFILL_TURNS = 1


def _moe_kernels():
    """Both kernels at the MoE models' head shapes, each against its plain
    version, L2-cold, with its bound (and SDPA for decode_attn): decode_attn
    at deepseek's Hkv 16 / Gq 1 / D 128 and granite-moe's Hkv 8 / Gq 2 /
    D 64 over 4096 packed tokens; kv_append at Hkv 8 / D 64; the bulk
    quantizer on one deepseek layer's 3000-token prefill (2867 x 16 rows x
    128, K2 and V1.5)."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    attn = {}
    for name, hkv, gq, d in (("deepseek (Hkv 16, Gq 1, D 128)", 16, 1, 128),
                             ("granite-moe (Hkv 8, Gq 2, D 64)", 8, 2, 64)):
        case = _attn_case(gen, dev, 4, hkv, gq, d, FAMILY_LIVE)
        attn[name] = _attn_row(f"decode_attn {name}", *case, FAMILY_LIVE)
        del case
        torch.cuda.empty_cache()
    append = {"Hkv 8 D 64": _append_case(gen, dev, 8, 64, 128, False)}
    quant = {f"K{bits}": _kv_quant_prefill(gen, dev, bits, rows=2867 * 16,
                                           d=128, h=16)
             for bits in (2.0, 1.5)}
    return attn, append, quant


def _weight_bytes(params, cfg, experts_read=None):
    """Bytes of the weights one decode step reads: every leaf but the
    embedding table (the step gathers 4 of its rows; a tied table is read
    whole as the head), with the routed experts counted in full, or
    ``experts_read`` of them a MoE layer (a list, one count a layer)."""
    moe = params["layers"]["moe"]
    total = sum(v.numel() * v.element_size() for v in _leaves(params))
    if not cfg.tie_embeddings:
        total -= params["embed"].numel() * params["embed"].element_size()
    if experts_read is None:
        return total
    per_expert = sum(moe[k][0, 0].numel() * moe[k].element_size()
                     for k in moe if k.startswith("experts_"))
    n_moe = moe["router"].shape[0]
    return total - per_expert * (cfg.n_experts * n_moe - sum(experts_read))


def _routed_experts(params, cfg, eng):
    """Distinct experts each MoE layer's router picks in one eager decode
    step of ``eng``'s loaded slots (from a copy of its caches)."""
    import torch
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    seen, route = [], M.route

    def spy(*args, **kw):
        out = route(*args, **kw)
        seen.append(int(torch.unique(out[1]).numel()))
        return out
    M.route = spy
    try:
        tok = torch.as_tensor(eng._tok, device=eng.device)
        T.decode_step(params, cfg, tok, _clone(eng._caches), eng.schedule,
                      calib=eng.calib, backend="cuda")
    finally:
        M.route = route
    return seen


def _refusals(params, cfg):
    """The pool and chunked prefill refuse the family on the card."""
    import torch
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.serving import Engine
    out = {}
    for what, kw in (("pool", dict(pool_blocks=768,
                                   pool_block_tokens=POOL_BT)),
                     ("chunk", dict(prefill_chunk=CHUNK))):
        try:
            Engine(params, cfg, PAPER_POLICY, batch_slots=SERVE_SLOTS,
                   max_len=MAX_LEN, backend="cuda",
                   device=torch.device("cuda"), **kw)
        except (ValueError, NotImplementedError) as e:
            out[what] = str(e)
        else:
            fail(f"{cfg.name}: the {what} accepted the {cfg.family} family")
    check("dense family only" in out["pool"]
          and "moe expert capacity" in out["chunk"],
          f"{cfg.name}: refusal messages {out}")
    return out


def _prefill_ms(params, cfg):
    """Host ms (synchronised) of one whole-prompt prefill of MOE_PREFILL
    tokens, PREFILL_TURNS times after one warm call."""
    import numpy as np
    import torch
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.models import transformer as T
    toks = torch.as_tensor(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (1, MOE_PREFILL)), device=torch.device("cuda"))
    times = []
    for i in range(PREFILL_TURNS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.prefill_model(params, cfg, toks, PAPER_POLICY, max_len=MAX_LEN,
                        backend="cuda")
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return spread(times)


def _moe_model(state, arch, seed):
    """One MoE model at full width: mix (a) eager and warmed striped
    (streams equal, the launch identities, no plain call, no graph miss),
    cuda against reference logits, the 3000-token prefill, the replayed
    step at 4 x 2048 beside the two weight-read bounds, the refusals,
    peak memory."""
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_POLICY
    cfg = configs.get(arch)
    params, init = _family_init(cfg)
    runs = _mix_a(state, cfg, params, cfg.name, chunked=False, pooled=False)
    backends = _backend_logits(params, cfg, PAPER_POLICY, seed=seed)
    prefill = _prefill_ms(params, cfg)
    eng, warm = _family_engine(params, cfg, True)
    replayed, run = _replayed_step_ms(eng, cfg)
    routed = _routed_experts(params, cfg, eng)
    del eng
    gc.collect()
    n_moe = cfg.n_layers - cfg.first_dense
    reads = {"all_experts": _weight_bytes(params, cfg),
             "routed_at_most": _weight_bytes(
                 params, cfg, [min(cfg.n_experts, SERVE_SLOTS * cfg.top_k)]
                 * n_moe),
             "routed_this_step": _weight_bytes(params, cfg, routed)}
    bounds = {k: {"bytes": b, "ms": b / HBM_BYTES_PER_S * 1e3,
                  "share_of_replayed": b / HBM_BYTES_PER_S * 1e3
                  / replayed["mean"]} for k, b in reads.items()}
    refusals = _refusals(params, cfg)
    peak = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(init, arch=cfg.name, runs=runs, cuda_vs_reference=backends,
                prefill_ms=dict(prefill, tokens=MOE_PREFILL),
                warmup=warm, replayed_step_ms_4x2048=replayed,
                experts_routed_per_layer=routed,
                weight_read_bounds=bounds, refusals=refusals,
                peak_mem_bytes=peak)


def phase_serve_moe(state):
    """The MoE family at full width, and both kernels at its head
    shapes."""
    import gc
    import torch
    state.pop("params", None)
    gc.collect()
    torch.cuda.empty_cache()
    before = {"peak_bytes_so_far": torch.cuda.max_memory_allocated(),
              "allocated_after_free": torch.cuda.memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    head = {"phase": "serve_moe", "gpu": state["gpu"]}
    attn, append, quant = _moe_kernels()
    for name, rows in (("decode_attn", attn), ("kv_append", append),
                       ("kv_quant", quant)):
        state.setdefault(name, {})["moe"] = {
            k: _width_row(r) for k, r in rows.items()}
    emit(dict(head, part="kernels", before=before, decode_attn=attn,
              kv_append=append, kv_quant=quant, atol=ATOL, rtol=RTOL))
    common = {"max_len": MAX_LEN, "slots": SERVE_SLOTS,
              "steps_per_sync": SERVE_SPS}
    emit(dict(head, part="deepseek", **common,
              **_moe_model(state, "deepseek_moe_16b", seed=15)))
    emit(dict(head, part="granite_moe", **common,
              **_moe_model(state, "granite_moe_1b_a400m", seed=16)))


# --------------------------------------------- serve_hybrid (hymba-1.5b)



def _hybrid_kernels():
    """Both kernels at hymba's head shapes, each against its plain version,
    L2-cold, with its bound (and SDPA for decode_attn): decode_attn at Hkv
    5 / Gq 5 / D 64 over 4096 packed tokens (live 500/1500/2900/3900; the
    launch plan's one kv head a CTA), a global layer and a local layer's
    1024-token ``local_slice`` view; kv_append at Hkv 5 / D 64; the bulk
    quantizer at one layer's 3000-token prefill (2867 x 5 rows x 64, K2
    and V1.5)."""
    import torch
    from repro_torch.kernels import decode_attn as DA
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    case = _attn_case(gen, dev, 4, 5, 5, 64, FAMILY_LIVE)
    attn = {}
    for name, c in (("hymba global (Hkv 5, Gq 5 on the G 8 template, D 64)",
                     case),
                    ("hymba local_slice 1024",
                     _slice_case(case, FAMILY_LIVE, 1024))):
        plan = DA.launch_plan(4, 5, 64, c[0], c[4].shape[1], c[6], dev)
        check(plan[0] == 1, f"{name}: launch plan {plan} does not take one "
              f"kv head a CTA at Hkv 5")
        live = [int(x) for x in (c[4] > 0).sum(dim=1).tolist()]
        r = _attn_row(f"decode_attn {name}", *c, live)
        r.update(lo=c[5][:, 0].tolist(), plan=list(plan))
        attn[name] = r
    del case
    torch.cuda.empty_cache()
    append = {"Hkv 5 D 64": _append_case(gen, dev, 5, 64, 128, False)}
    quant = {f"K{bits}": _kv_quant_prefill(gen, dev, bits, rows=2867 * 5,
                                           d=64, h=5)
             for bits in (2.0, 1.5)}
    return attn, append, quant


def _hybrid_model(state):
    """hymba-1.5b at full width: mix (a) eager and warmed striped (streams
    equal, the launch identities, no plain call, no graph miss), cuda
    against reference logits, the 3000-token prefill's ms and its profile
    by kind with the SSM scan apart, the replayed step at 4 x 2048 with its
    profile by kind, the refusals, the decode state's bytes, peak memory."""
    import gc
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    cfg = configs.get("hymba_1p5b")
    params, init = _family_init(cfg)
    runs = _mix_a(state, cfg, params, cfg.name, chunked=False, pooled=False)
    backends = _backend_logits(params, cfg, PAPER_POLICY, seed=18)
    prefill = _prefill_ms(params, cfg)
    eng, warm = _family_engine(params, cfg, True)
    replayed, run = _replayed_step_ms(eng, cfg)
    state_bytes = sum(int(np.prod(shape)) * torch.empty((), dtype=dt)
                      .element_size() for shape, dt in S.state_shapes(
                          SERVE_SLOTS, cfg, torch.bfloat16).values()
                      ) * cfg.n_layers
    del eng
    gc.collect()
    refusals = _refusals(params, cfg)
    peak = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(init, arch=cfg.name, runs=runs, cuda_vs_reference=backends,
                prefill_ms=dict(prefill, tokens=MOE_PREFILL),
                warmup=warm,
                replayed_step_ms_4x2048=replayed,
                ssm_state_bytes_4_slots=state_bytes, refusals=refusals,
                peak_mem_bytes=peak)


def phase_serve_hybrid(state):
    """The hybrid family (hymba-1.5b) at full width, and both kernels at
    its head shapes."""
    import gc
    import torch
    state.pop("params", None)
    gc.collect()
    torch.cuda.empty_cache()
    before = {"peak_bytes_so_far": torch.cuda.max_memory_allocated(),
              "allocated_after_free": torch.cuda.memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    head = {"phase": "serve_hybrid", "gpu": state["gpu"]}
    attn, append, quant = _hybrid_kernels()
    for name, rows in (("decode_attn", attn), ("kv_append", append),
                       ("kv_quant", quant)):
        state.setdefault(name, {})["hybrid"] = {
            k: _width_row(r) for k, r in rows.items()}
    emit(dict(head, part="kernels", before=before, decode_attn=attn,
              kv_append=append, kv_quant=quant, atol=ATOL, rtol=RTOL))
    emit(dict(head, part="hymba", max_len=MAX_LEN, slots=SERVE_SLOTS,
              steps_per_sync=SERVE_SPS, **_hybrid_model(state)))


# ------------------------------ serve_encdec (seamless-m4t-large-v2)

ENC_FRAMES = 4096                # the config's enc_seq_len: stub frames
ENCDEC_PROMPT, ENCDEC_STEPS = 1024, 32
ENCODER_TURNS = 1


def _cross_case(gen, dev, b, hkv, d, frames):
    """A cross-attention cache of ``frames`` frames per slot, quantized
    whole by the bulk kernel under PAPER_POLICY.without_window() (window
    0, no sinks: every frame packed, no fp segment), all of it live, and
    one query row per kv head: the decode_attn case of an enc-dec decoder
    layer's cross attention."""
    import torch
    from repro_torch.core import kv_cache as kvc
    from repro_torch.core import segments as seg
    from repro_torch.kernels import ops
    pol = _policy(128).without_window()
    k = torch.randn((b, frames, hkv, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn((b, frames, hkv, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    cache = kvc.prefill(k, v, frames, pol, quant_fn=ops.make_kernel_quant_fn())
    del k, v
    check(not any(kk.startswith(("sink_", "win_")) for kk in cache),
          f"cross cache holds an fp segment: {sorted(cache)}")
    lens = cache["length"]
    cap = cache["qk_codes_hi"].shape[1]
    bs, s_pad = ops._block_pad(cap, 256)
    ok = ops._packed_ok(ops._padded_j(cap, s_pad, dev), lens, lens - 1,
                        seg.effective_window(0), pol, b)
    check(cap == frames and int((ok > 0).sum()) == b * frames,
          "cross case: every frame packed and live")
    k_qt = {kk[3:]: vv for kk, vv in cache.items() if kk.startswith("qk_")}
    v_qt = {kk[3:]: vv for kk, vv in cache.items() if kk.startswith("qv_")}
    q = torch.randn((b, hkv, 1, d), generator=gen, device=dev)
    return (pol, q, k_qt, v_qt, ok.to(torch.float32),
            seg.packed_block_bounds(ok, bs), bs)


def _encdec_kernels():
    """Both kernels at seamless's head shapes, each against its plain
    version, L2-cold, with its bound and SDPA: decode_attn over the
    decoder's self cache (Hkv 16 / Gq 1 / D 64, 4096 packed, live
    500/1500/2900/3900) and over a 4096-frame cross cache (window 0, no
    sinks, every frame live); kv_append at Hkv 16 / D 64; the bulk
    quantizer at one layer's cross cache for 4 slots (4 x 4096 x 16 rows x
    64, K2 and V1.5)."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    attn = {}
    case = _attn_case(gen, dev, 4, 16, 1, 64, FAMILY_LIVE)
    attn["seamless self (Hkv 16, Gq 1, D 64)"] = _attn_row(
        "decode_attn seamless self", *case, FAMILY_LIVE)
    del case
    case = _cross_case(gen, dev, 4, 16, 64, ENC_FRAMES)
    attn["seamless cross (4096 frames, window 0, no sinks)"] = _attn_row(
        "decode_attn seamless cross", *case, [ENC_FRAMES] * 4)
    del case
    torch.cuda.empty_cache()
    append = {"Hkv 16 D 64": _append_case(gen, dev, 16, 64, 128, False)}
    quant = {f"K{bits}": _kv_quant_prefill(gen, dev, bits,
                                           rows=4 * ENC_FRAMES * 16, d=64,
                                           h=16)
             for bits in (2.0, 1.5)}
    return attn, append, quant


def _encdec_inputs(cfg, n, length, seed):
    """``n`` prompts of ``length`` tokens from the CLI's corpus and ``n``
    x ENC_FRAMES stub frames from a seeded normal generator, on the card
    (frames in the weights' bf16)."""
    import numpy as np
    import torch
    from repro_torch.data import SyntheticCorpus
    dev = torch.device("cuda")
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    toks = np.stack([corpus.sample(length, np.random.default_rng(seed + i))
                     for i in range(n)])
    frames = np.random.default_rng(seed).standard_normal(
        (n, ENC_FRAMES, cfg.d_model), dtype=np.float32)
    return (torch.as_tensor(toks, device=dev),
            torch.as_tensor(frames, device=dev).to(torch.bfloat16))


def _greedy_graph(params, cfg, base, first, steps):
    """``steps`` greedy tokens from a copy of ``base``, replaying ONE
    captured decode step (token in, next token written back to the same
    static buffer), and what a later replay needs alive: the graph and
    the buffers it reads and writes (freed ones would be reused)."""
    import torch
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.models import transformer as T
    tok = first.clone()
    caches = _clone(base)
    scratch = _clone(base)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm outside the capture
        T.decode_step(params, cfg, tok, scratch, PAPER_POLICY,
                      backend="cuda")
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    del scratch
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits, _ = T.decode_step(params, cfg, tok, caches, PAPER_POLICY,
                                  backend="cuda")
        tok.copy_(logits[:, -1].float().argmax(-1)[:, None])
    out = []
    for _ in range(steps):
        graph.replay()
        out.append(tok[:, 0].clone())
    torch.cuda.synchronize()
    return torch.stack(out, dim=1).tolist(), {"graph": graph, "tok": tok,
                                              "caches": caches}


def _encdec_model(state):
    """seamless-m4t-large-v2 at full width through ``prefill_model`` /
    ``decode_step`` (the Engine refuses the family): 4 prompts of 1024
    tokens over 4 x 4096 frames in one batched prefill (four bulk
    launches a layer), 32 greedy steps eager (two decode_attn launches a
    layer a step, one kv_append, the cross cache untouched) and the same
    32 from the same prefill through one captured step (streams equal),
    cuda against reference logits, the encoder's ms at 4 x 4096 frames,
    the replayed step at 4 x 2048, peak memory."""
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import check_servable
    cfg = configs.get("seamless_m4t_large_v2")
    params, init = _family_init(cfg)
    toks, frames = _encdec_inputs(cfg, SERVE_SLOTS, ENCDEC_PROMPT, 20)
    torch.cuda.synchronize()
    reset_launch_counts()                                    # main path
    t0 = time.monotonic()
    logits, base = T.prefill_model(params, cfg, toks, PAPER_POLICY,
                                   max_len=MAX_LEN, backend="cuda",
                                   enc_embeds=frames)
    first = logits[:, -1].float().argmax(-1)[:, None]
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t0
    pre = launch_counts()
    check(pre["kv_quant"]["kernel"] == 4 * cfg.n_layers
          and pre["kv_quant"]["plain"] == 0,
          f"seamless prefill: bulk kv_quant launches {pre['kv_quant']} != "
          f"4 x layers = {4 * cfg.n_layers}")
    caches = _clone(base)
    tok, stream = first, []
    reset_launch_counts()
    t0 = time.monotonic()
    for _ in range(ENCDEC_STEPS):
        lg, caches = T.decode_step(params, cfg, tok, caches, PAPER_POLICY,
                                   backend="cuda")
        tok = lg[:, -1].float().argmax(-1)[:, None]
        stream.append(tok[:, 0])
    torch.cuda.synchronize()
    eager_s = time.monotonic() - t0
    counts = launch_counts()
    da, kq = counts["decode_attn"], counts["kv_quant"]
    n = cfg.n_layers * ENCDEC_STEPS
    check(da["kernel"] == 2 * n and kq["append"] == n and da["plain"] == 0
          and kq["plain"] == 0 and kq["append_plain"] == 0,
          f"seamless decode: launches {counts} != 2 decode_attn and 1 "
          f"kv_append a layer a step ({n} layer-steps), no plain call")
    for k, v in base["scan"].items():
        if k.startswith("x_"):
            check(torch.equal(caches["scan"][k], v),
                  f"seamless decode wrote the cross cache leaf {k}")
    for name, c in (("prefill", pre), ("decode", counts)):
        _add_launches(state, c)
    eager = torch.stack(stream, dim=1).tolist()
    reset_launch_counts()
    graphed, _ = _greedy_graph(params, cfg, base, first, ENCDEC_STEPS)
    cap = launch_counts()
    check(graphed == eager, "seamless: replayed greedy streams differ from "
          "the eager ones")
    check(all(0 <= t < cfg.vocab_size for row in eager for t in row),
          "seamless: token id out of range")
    del caches
    # cuda against reference, one step from the prefill
    tok1 = first
    lc, _ = T.decode_step(params, cfg, tok1, _clone(base), PAPER_POLICY,
                          backend="cuda")
    lr, _ = T.decode_step(params, cfg, tok1, _clone(base), PAPER_POLICY,
                          backend="reference")
    lc, lr = lc[:, -1].float(), lr[:, -1].float()
    check(bool(torch.isfinite(lc).all() and torch.isfinite(lr).all()),
          "seamless decode logits not finite")
    rel = float((lc - lr).norm() / lr.norm())
    check(rel <= LOGIT_REL_TOL, f"seamless cuda vs reference logits: "
          f"relative L2 {rel:.4f} > {LOGIT_REL_TOL}")
    backends = {"logits_rel_l2": rel, "top1_agreement":
                float((lc.argmax(-1) == lr.argmax(-1)).float().mean())}
    cross_bytes = sum(v.numel() * v.element_size()
                      for k, v in base["scan"].items() if k.startswith("x_"))
    del base, logits
    gc.collect()
    # the encoder alone at 4 x 4096 frames, synced
    enc = []
    for i in range(ENCODER_TURNS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T._encode(params, cfg, frames)
        torch.cuda.synchronize()
        if i:
            enc.append((time.perf_counter() - t0) * 1e3)
    # the replayed step at 4 x 2048
    toks2, _ = _encdec_inputs(cfg, SERVE_SLOTS, STEP_CONTEXT, 21)
    lg2, base2 = T.prefill_model(params, cfg, toks2, PAPER_POLICY,
                                 max_len=MAX_LEN, backend="cuda",
                                 enc_embeds=frames)
    _, live = _greedy_graph(params, cfg, base2,
                            lg2[:, -1].float().argmax(-1)[:, None], 1)
    del base2, lg2

    def run():
        for _ in range(SERVE_SPS):
            live["graph"].replay()
    run()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    for e in ev[1:]:
        run()
        e.record()
    torch.cuda.synchronize()
    replayed = spread([a.elapsed_time(b) / SERVE_SPS
                        for a, b in zip(ev, ev[1:])])
    refusal = None
    try:
        check_servable(cfg)
    except NotImplementedError as e:
        refusal = str(e)
    check(refusal is not None, "the Engine accepts the encdec family")
    peak = torch.cuda.max_memory_allocated()
    del params, live, frames
    gc.collect()
    torch.cuda.empty_cache()
    return dict(init, arch=cfg.name, prompt=ENCDEC_PROMPT,
                frames=ENC_FRAMES, steps=ENCDEC_STEPS,
                prefill_s=prefill_s, prefill_launches=pre,
                eager_ms_per_step=eager_s * 1e3 / ENCDEC_STEPS,
                decode_launches=counts, captured_step_launches=cap,
                streams_equal_replayed=True, cuda_vs_reference=backends,
                cross_cache_bytes=cross_bytes,
                encoder_ms_4x4096=spread(enc),
                replayed_step_ms_4x2048=replayed,
                engine_refusal=refusal, peak_mem_bytes=peak)


def phase_serve_encdec(state):
    """The enc-dec family (seamless-m4t-large-v2) at full width, and both
    kernels at its head shapes and over its cross cache."""
    import gc
    import torch
    state.pop("params", None)
    gc.collect()
    torch.cuda.empty_cache()
    before = {"peak_bytes_so_far": torch.cuda.max_memory_allocated(),
              "allocated_after_free": torch.cuda.memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    head = {"phase": "serve_encdec", "gpu": state["gpu"]}
    attn, append, quant = _encdec_kernels()
    for name, rows in (("decode_attn", attn), ("kv_append", append),
                       ("kv_quant", quant)):
        state.setdefault(name, {})["encdec"] = {
            k: _width_row(r) for k, r in rows.items()}
    emit(dict(head, part="kernels", before=before, decode_attn=attn,
              kv_append=append, kv_quant=quant, atol=ATOL, rtol=RTOL))
    emit(dict(head, part="seamless", max_len=MAX_LEN, slots=SERVE_SLOTS,
              **_encdec_model(state)))


# ------------------------------------------------- serve_rwkv (rwkv6-3b)

WKV_SHAPE = (1, 3008, 40, 64)     # one layer's 3000-token prefill, padded
WKV_ATOL, WKV_RTOL = 2e-4, 1e-3   # tests/test_models.py, chunked vs naive


def _no_kernel_launch(before, what):
    """Neither kernel (decode_attn, kv_quant, kv_append, their plain
    versions, the fp16 route) was called since ``before``."""
    from repro_torch.kernels import launch_count_delta, launch_counts
    delta = launch_count_delta(before, launch_counts())
    moved = {k: {c: n for c, n in d.items() if n} for k, d in delta.items()}
    check(not any(moved.values()),
          f"{what}: a kernel counter moved on a path without a KV cache: "
          f"{moved}")
    return delta


def _wkv_gate():
    """``wkv_chunked`` against the step recurrence ``wkv_naive`` on the
    card at one layer's full-width shapes (B 1, S 3000 padded to 3008, H
    40, hd 64, f32; the reference test's input law: normal r/k/v/u,
    log-decay -exp(N(0,1) - 1) clamped to [-5, -1e-4], zero state), within
    the reference test's tolerance; synchronised ms of each."""
    import torch
    from repro_torch.models import rwkv6 as R
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    b, s, h, d = WKV_SHAPE
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    r, k, v = rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d)
    logw = torch.clamp(-torch.exp(rnd(b, s, h, d) - 1), -5.0, -1e-4)
    u = rnd(h, d)
    s0 = torch.zeros((b, h, d, d), device=dev)
    out, ms = {}, {}
    for name, fn in (("chunked", R.wkv_chunked), ("naive", R.wkv_naive)):
        fn(r, k, v, logw, u, s0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn(r, k, v, logw, u, s0)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
    res = {}
    for i, what in enumerate(("y", "state")):
        got, want = out["chunked"][i], out["naive"][i]
        err = (got - want).abs()
        ratio = float((err / (WKV_ATOL + WKV_RTOL * want.abs())).max())
        res[what] = {"max_abs_err": float(err.max()),
                     "max_abs": float(want.abs().max()),
                     "worst_share_of_tol": ratio}
        check(bool(torch.isfinite(got).all()) and ratio <= 1.0,
              f"wkv_chunked vs wkv_naive ({what}) at {WKV_SHAPE}: "
              f"{res[what]} exceeds atol {WKV_ATOL} / rtol {WKV_RTOL}")
    return dict(res, shape=list(WKV_SHAPE), atol=WKV_ATOL, rtol=WKV_RTOL,
                ms=ms)


def _rwkv_serve(eng, reqs, what):
    """``reqs`` through ``eng``: every request finished at its budget; the
    streams, wall time, tokens/s and the Engine's ms per step."""
    import torch
    chunks = _timed_chunks(eng)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    handles = [eng.submit(r) for r in reqs]
    eng.run(handles)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    check(all(h.finished and h.finish_reason == "length"
              and len(h.tokens) == r.max_new for h, r in zip(handles, reqs)),
          f"{what}: not every request finished: "
          f"{[(h.finish_reason, len(h.tokens)) for h in handles]}")
    tokens = sum(len(h.tokens) for h in handles)
    return [list(h.tokens) for h in handles], {
        "decode_steps": eng.n_decode_steps, "wall_s": wall,
        "tokens": tokens, "tokens_per_s": tokens / wall,
        "engine_ms_per_step": spread([ms for ms, _ in chunks[1:]]
                                      or [ms for ms, _ in chunks])}


def _rwkv_model(state):
    """rwkv6-3b at full width (random bf16 weights from seed 0): mix (a)
    eager and warmed (streams equal, no graph miss, replays == steps), the
    3000-token prefill's ms, the replayed step at
    4 x 2048 with its kernel count, the state bytes a slot (equal at any
    max_len), the refusals, peak memory."""
    import gc
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.models import transformer as T
    cfg = configs.get("rwkv6_3b")
    marks = [("start", time.monotonic())]
    mark = lambda name: marks.append((name, time.monotonic()))
    params, init = _family_init(cfg)
    eng, _ = _family_engine(params, cfg, False, steps_per_sync=EAGER_SPS)
    eager, eager_rep = _rwkv_serve(eng, _eager_requests(cfg), "rwkv eager")
    del eng
    mark("eager")
    eng, warm = _family_engine(params, cfg, True)
    got, rep = _rwkv_serve(eng, _serve_requests(cfg)[1], "rwkv graph")
    mark("graph")
    wr = eng.warmup_report()
    same = [a[:EAGER_NEW_FAMILY] == b for a, b in zip(got, eager)]
    check(all(same) and wr["post_warmup_misses"] == 0
          and wr["replays"] == eng.n_decode_steps,
          f"rwkv: replayed streams equal eager {same}, warmup {wr}, "
          f"decode steps {eng.n_decode_steps}")
    rep.update(streams_equal_eager=same, replays=wr["replays"])
    replayed, run = _replayed_step_ms(eng, cfg)
    mark("replayed")
    cache_bytes = T.cache_bytes(eng._caches)
    del eng
    gc.collect()
    per_slot = sum(int(np.prod(shape)) * torch.empty((), dtype=dt)
                   .element_size() for shape, dt in T.layer_cache_shapes(
                       cfg, 1, MAX_LEN, PAPER_POLICY).values()) * cfg.n_layers
    longer = T.layer_cache_shapes(cfg, 1, LONG_MAX_LEN, PAPER_POLICY)
    check(cache_bytes == per_slot * SERVE_SLOTS and longer ==
          T.layer_cache_shapes(cfg, 1, MAX_LEN, PAPER_POLICY),
          f"rwkv: state bytes {cache_bytes} != {SERVE_SLOTS} x {per_slot} "
          f"or the state grows with max_len")
    prefill = _prefill_ms(params, cfg)
    mark("prefill")
    refusals = _refusals(params, cfg)
    peak = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(init, arch=cfg.name, runs={"eager_striped": dict(
                    eager_rep, new_tokens=EAGER_NEW_FAMILY),
                "graph_striped": rep},
                warmup=warm, prefill_ms=dict(prefill, tokens=MOE_PREFILL),
                replayed_step_ms_4x2048=replayed,
                state_bytes_per_slot=per_slot,
                engine_state_bytes=cache_bytes, refusals=refusals,
                peak_mem_bytes=peak,
                part_s={b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])})


def phase_serve_rwkv(state):
    """The attention-free family (rwkv6-3b) at full width: no KV cache, so
    neither kernel may run anywhere in the phase."""
    import gc
    import torch
    from repro_torch.kernels import launch_counts
    state.pop("params", None)
    gc.collect()
    torch.cuda.empty_cache()
    before = {"peak_bytes_so_far": torch.cuda.max_memory_allocated(),
              "allocated_after_free": torch.cuda.memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    counts = launch_counts()
    head = {"phase": "serve_rwkv", "gpu": state["gpu"]}
    emit(dict(head, part="wkv", before=before, **_wkv_gate()))
    model = _rwkv_model(state)
    delta = _no_kernel_launch(counts, "serve_rwkv")
    emit(dict(head, part="rwkv", max_len=MAX_LEN, slots=SERVE_SLOTS,
              steps_per_sync=SERVE_SPS, launch_delta=delta, **model))


# ---------------------------------------------- train (llama3.2-1b, f32)

TRAIN_BATCH, TRAIN_SEQS, TRAIN_STEPS = 8, (128, 512), (8, 4)
TRAIN_LR = 3e-3                  # the reference trainer CLI's default
REPEAT_STEPS = 4
REMAT_RTOL = 1e-5                # remat on vs off: loss, and grads (below)
REMAT_GRAD_TOL = 1e-4            # max |dg| over max |g|, leaf by leaf
CKPT_LAYERS, CKPT_STEP = 2, 2    # the round trip: full width, 2 layers


def _train_cfg(**kw):
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get("llama3p2_1b"), **kw)


def _lr_fn():
    import functools
    from repro_torch.training import warmup_cosine
    total = sum(TRAIN_STEPS) + REPEAT_STEPS
    return functools.partial(warmup_cosine, peak_lr=TRAIN_LR,
                             warmup=max(total // 10, 1), total=total)


def _timed_steps(step_fn, st, batches, what):
    """One synchronised train step on each of ``batches``: loss and grad
    norm finite at every step.  Returns (state, per-step metrics and
    ms)."""
    import math
    import torch
    rows = []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step_fn(st, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        row = {k: float(v) for k, v in m.items()}
        check(all(math.isfinite(row[k]) for k in ("loss", "nll",
                                                  "grad_norm")),
              f"train {what} step {i}: non-finite metrics {row}")
        rows.append(dict(row, ms=ms))
    return st, rows


def _loss(params, cfg, batch) -> float:
    """The train step's loss on ``batch``, forward only."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.training import loss_fn
    with torch.no_grad():
        logits, aux = T.forward_train(params, cfg, batch)
        return float(loss_fn(logits, batch["labels"], aux)[0])


def _loss_grads(params, cfg, batch):
    """The train step's loss and gradients, without the update."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.training import loss_fn
    from repro_torch.tree import leaves, unflatten
    flat = [x.detach().requires_grad_() for x in leaves(params)]
    logits, aux = T.forward_train(unflatten(params, flat), cfg, batch)
    loss, _ = loss_fn(logits, batch["labels"], aux)
    del logits
    return loss.detach(), torch.autograd.grad(loss, flat)


def _remat_check(params, batch):
    """Loss and gradients with per-block remat (``nothing`` and ``dots``)
    against remat off, on one batch: equal within the stated tolerances;
    the peak memory each run adds to what is held when it starts (the
    state, and under remat the kept gradients of the run without)."""
    import torch
    out = {}
    base_loss, base = None, None
    for policy in (None, "nothing", "dots"):
        cfg = _train_cfg() if policy is None else _train_cfg(
            remat=True, remat_policy=policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, grads = _loss_grads(params, cfg, batch)
        torch.cuda.synchronize()
        row = {"loss": float(loss), "ms": (time.perf_counter() - t0) * 1e3,
               "peak_above_start_bytes":
                   torch.cuda.max_memory_allocated() - held}
        if policy is None:
            base_loss, base = loss, grads
        else:
            rel = [float((g - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for g, b in zip(grads, base)]
            row.update(loss_rel=float((loss - base_loss).abs()
                                      / base_loss.abs()),
                       grad_rel_max=max(rel),
                       grads_bitwise=all(bool(torch.equal(g, b))
                                         for g, b in zip(grads, base)))
            check(row["loss_rel"] <= REMAT_RTOL
                  and row["grad_rel_max"] <= REMAT_GRAD_TOL,
                  f"train: remat {policy} against off: {row}")
        del grads
        out[policy or "off"] = row
    del base
    return out


def _tree_equal(a, b) -> bool:
    import torch
    from repro_torch.tree import leaves
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _ckpt_round_trip():
    """Full width, CKPT_LAYERS layers: CKPT_STEP steps, save, one more step
    (the uninterrupted run); restore the saved step into a fresh state and
    take the same step: params, moments, steps and metrics bitwise equal.
    Save and restore ms and bytes."""
    import gc
    import shutil
    import torch
    from repro_torch.checkpoint import load_latest, save_checkpoint
    from repro_torch.data import DataLoader, SyntheticCorpus
    from repro_torch.training import init_train_state, make_train_step
    cfg = _train_cfg(n_layers=CKPT_LAYERS)
    dev = torch.device("cuda")
    st = init_train_state(cfg, seed=0, device=dev)
    dl = DataLoader(SyntheticCorpus(cfg.vocab_size, seed=1), TRAIN_BATCH,
                    TRAIN_SEQS[0], device=dev)
    step_fn = make_train_step(cfg, lr_fn=_lr_fn())
    for i in range(CKPT_STEP):
        st, _ = step_fn(st, dl.batch_at(i))
    d = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = save_checkpoint(str(d), CKPT_STEP, st)
    save_ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    batch = dl.batch_at(CKPT_STEP)
    a, ma = step_fn(st, batch)
    del st
    gc.collect()
    t0 = time.perf_counter()
    got = load_latest(str(d), a, device=dev)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    check(got is not None and got["step"] == CKPT_STEP,
          f"train: the checkpoint did not load: {got and got['step']}")
    b, mb = step_fn(got["state"], batch)
    same = _tree_equal(a, b)
    same_m = all(bool(torch.equal(ma[k], mb[k])) for k in ma)
    check(same and same_m, f"train: the restored run is not bitwise the "
          f"uninterrupted one (state {same}, metrics {same_m})")
    del a, b, got
    shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": CKPT_LAYERS, "step": CKPT_STEP, "bytes": nbytes,
            "save_ms": save_ms, "restore_ms": load_ms, "bitwise": True}


def _train_model():
    """llama3.2-1b at full width in f32: TRAIN_STEPS steps at each of
    TRAIN_SEQS (batch 8), REPEAT_STEPS on one repeated batch (its loss
    must fall), remat on against off, peak memory."""
    import gc
    import torch
    from repro_torch.data import DataLoader, SyntheticCorpus
    from repro_torch.models import transformer as T
    from repro_torch.training import init_train_state, make_train_step
    cfg = _train_cfg()
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    st = init_train_state(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n = T.count_params(st["params"])
    corpus = SyntheticCorpus(cfg.vocab_size, seed=1)
    step_fn = make_train_step(cfg, lr_fn=_lr_fn())
    runs, start = {}, 0
    for seq, steps in zip(TRAIN_SEQS, TRAIN_STEPS):
        dl = DataLoader(corpus, TRAIN_BATCH, seq, device=dev)
        torch.cuda.reset_peak_memory_stats()
        st, rows = _timed_steps(step_fn, st, [
            dl.batch_at(start + i) for i in range(steps)], f"seq {seq}")
        start += steps
        tokens = TRAIN_BATCH * seq
        ms = spread([r["ms"] for r in rows[1:]])
        runs[f"{TRAIN_BATCH}x{seq}"] = {
            "steps": rows, "step_ms": ms, "tokens_per_step": tokens,
            "tokens_per_s": tokens / ms["mean"] * 1e3,
            "model_flops_per_step": 6 * n * tokens,
            "f32_peak_share": 6 * n * tokens / (ms["mean"] / 1e3)
            / F32_FLOP_PER_S,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    batch = DataLoader(corpus, TRAIN_BATCH, TRAIN_SEQS[0],
                       device=dev).batch_at(10_000)
    before = _loss(st["params"], cfg, batch)
    st, rows = _timed_steps(step_fn, st, [batch] * REPEAT_STEPS,
                            "repeated batch")
    after = _loss(st["params"], cfg, batch)
    check(after < before, f"train: the repeated batch's loss did not fall:"
          f" {before} -> {after}")
    remat = _remat_check(st["params"], batch)
    del st
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "params": n, "init_s": init_s,
            "precision": "f32 params, grads and moments; f32 matmuls at "
                         "torch's default precision (TF32 off)",
            "model_flops": "6 x params x tokens a step",
            "runs": runs, "repeated_batch": {"loss_before": before,
                                             "loss_after": after,
                                             "steps": rows},
            "remat": remat}


def phase_train(state):
    """The single-device training path at llama3.2-1b's full width: no KV
    cache on it, so neither kernel may run anywhere in the phase."""
    import gc
    import torch
    from repro_torch.kernels import launch_counts
    state.pop("params", None)
    gc.collect()
    torch.cuda.empty_cache()
    before = {"peak_bytes_so_far": torch.cuda.max_memory_allocated(),
              "allocated_after_free": torch.cuda.memory_allocated()}
    counts = launch_counts()
    head = {"phase": "train", "gpu": state["gpu"]}
    model = _train_model()
    ckpt = _ckpt_round_trip()
    delta = _no_kernel_launch(counts, "train")
    emit(dict(head, before=before, batch=TRAIN_BATCH, launch_delta=delta,
              checkpoint=ckpt, **model))


# ----------------------------------- distributed (llama3.2-1b, f32, mesh)

DIST_STEPS, DIST_TIMED = 2, 4    # gated steps; timed steps after them
DIST_RTOL = 1e-5                 # the training tests' STEP_RTOL
DIST_RANKS, DIST_MESH = 4, (2, 1, 2)
DIST_AXES = ("pod", "data", "model")
DIST_DEADLINE_S = 90             # a spawned world's time limit
PIPE_L, PIPE_B, PIPE_D, PIPE_MB = 8, 8, 16, 4    # the reference test's case
# gloo on CUDA tensors, the collectives the multi-rank cases would need
# that gloo refuses (``--gloo-probe`` shows each failing): DTensor's
# functional all-gather (the sharded train step) and send/recv (the
# pipeline's ring permute); those cases are left out of (b)
GLOO_LEFT_OUT = {
    "train_step": "DTensor redistribution's functional all_gather "
                  "(_c10d_functional.all_gather_into_tensor) on CUDA tensors",
    "pipeline_forward": "send/recv (dist.batch_isend_irecv) of CUDA tensors"}


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _pipe_inputs(dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    w = rng.normal(size=(PIPE_L, PIPE_D, PIPE_D)) * 0.3
    b = rng.normal(size=(PIPE_L, PIPE_D)) * 0.1
    x = rng.normal(size=(PIPE_B, PIPE_D))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    return {"w": t(w), "b": t(b)}, t(x)


def _pipe_block(h, p):
    import torch
    return torch.tanh(h @ p["w"] + p["b"])


def _dist_params_diff(sharded, plain):
    """Every param leaf's max |sharded - plain| and that over max |plain|."""
    from repro_torch.tree import leaves
    out = []
    for a, b in zip(leaves(sharded), leaves(plain)):
        d = float((a.full_tensor() - b).abs().max())
        out.append((d, d / max(float(b.abs().max()), 1e-30)))
    return out


def _dist_timed(fn, st, batch, n):
    """``n`` steps of ``fn``, each timed with CUDA events: (state, ms list,
    the largest peak above the memory held when a step started)."""
    import torch
    ms, peak = [], 0
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        a.record()
        st, _ = fn(st, batch)
        z.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(z))
        peak = max(peak, torch.cuda.max_memory_allocated() - held)
    return st, ms, peak


def _dist_world1():
    """(a) world 1 on NCCL (a TCP store on localhost), mesh (1, 1, 1):
    llama3.2-1b at full width in f32, 8 x 128 tokens, remat on; DIST_STEPS
    sharded steps (the state laid out by ``place_state``, the step under
    TRAIN_RULES) against as many plain steps from the same seed's state:
    loss, nll, grad norm and every param within DIST_RTOL (expected
    equal); after each run's gated steps, DIST_TIMED more (CUDA events)
    and the peak memory a step adds; DIST_STEPS sequence-parallel steps
    (SEQ_PARALLEL_TRAIN_RULES) gated the same way; ``int8_allreduce_pod``
    (a pod of one returns x) and ``pipeline_forward`` (one stage: every
    microbatch through the layers in order) equal to x and the sequential
    run, bitwise, and the pipeline's gradients in its params and input
    equal to sequential autograd's, bitwise.  One state (~14.8 GB with
    its moments) lives at a time: two and a step's transients do not fit
    in 80 GB."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.data import DataLoader, SyntheticCorpus
    from repro_torch.distributed.compression import int8_allreduce_pod
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.distributed.sharding import SEQ_PARALLEL_TRAIN_RULES
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.training import (init_train_state, make_train_step,
                                      place_state)
    dev = init_world(init_method=f"tcp://localhost:{_free_port()}",
                     world_size=1, rank=0)
    mesh = make_mesh((1, 1, 1), DIST_AXES)
    cfg = _train_cfg(remat=True)
    dl = DataLoader(SyntheticCorpus(cfg.vocab_size, seed=1), TRAIN_BATCH,
                    TRAIN_SEQS[0], device=dev)
    plain = make_train_step(cfg, lr_fn=_lr_fn())
    sharded = make_train_step(cfg, lr_fn=_lr_fn(), mesh=mesh)
    out = {"mesh": [1, 1, 1], "backend": "nccl", "remat": cfg.remat_policy,
           "steps": []}
    fresh = lambda: init_train_state(cfg, seed=0, device=dev)

    def run(fn, st, timed=DIST_TIMED):
        """DIST_STEPS gated steps, then ``timed`` timed ones: (the params
        after the gated steps, their metrics, ms, peak)."""
        rows = []
        for i in range(DIST_STEPS):
            st, m = fn(st, dl.batch_at(i))
            rows.append({k: float(v) for k, v in m.items()})
        params = st["params"]      # the steps build new tensors
        st, ms, peak = _dist_timed(fn, st, dl.batch_at(DIST_STEPS), timed)
        del st
        gc.collect()
        torch.cuda.empty_cache()
        return params, rows, ms, peak

    def against_plain(what, rows, params):
        """Each gated step's metrics and every param within DIST_RTOL of
        the plain run's: (the rows, the params' largest difference)."""
        diffs = _dist_params_diff(params, pp)
        steps = []
        for i in range(DIST_STEPS):
            a, b = rows[i], plain_rows[i]
            rel = {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                   for k in ("loss", "nll", "grad_norm")}
            steps.append({what: a, "plain": b, "rel": rel})
            check(max(rel.values()) <= DIST_RTOL,
                  f"distributed: world-1 {what} step {i} against plain: "
                  f"{rel}")
        check(max(r for _, r in diffs) <= DIST_RTOL,
              f"distributed: world-1 {what} params differ: {max(diffs)}")
        return steps, max(d for d, _ in diffs)

    pp, plain_rows, plain_ms, plain_peak = run(plain, fresh())
    sp, sharded_rows, sharded_ms, sharded_peak = run(
        sharded, place_state(fresh(), mesh))
    out["steps"], out["param_max_abs_diff"] = against_plain(
        "sharded", sharded_rows, sp)
    del sp
    out["params_bitwise"] = out["param_max_abs_diff"] == 0.0
    # the sequence-parallel step (the sequence over model), gated alone
    seqpar = make_train_step(cfg, lr_fn=_lr_fn(), mesh=mesh,
                             rules=SEQ_PARALLEL_TRAIN_RULES)
    qp, seqpar_rows, _, _ = run(seqpar, place_state(fresh(), mesh), timed=0)
    steps, diff = against_plain("seqpar", seqpar_rows, qp)
    out["seqpar"] = {"steps": steps, "param_max_abs_diff": diff}
    del pp, qp
    out["step_ms"] = {"sharded": spread(sharded_ms),
                      "plain": spread(plain_ms)}
    out["sharded_over_plain"] = (out["step_ms"]["sharded"]["mean"]
                                 / out["step_ms"]["plain"]["mean"])
    out["peak_bytes_above_state"] = {"sharded": sharded_peak,
                                     "plain": plain_peak}
    gc.collect()
    torch.cuda.empty_cache()
    x = torch.randn(4096, 33, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    y = int8_allreduce_pod(x, mesh)
    check(torch.equal(y, x), "distributed: a pod of one changed x")
    params, xp = _pipe_inputs(dev)
    got = pipeline_forward(_pipe_block, params, xp, mesh=mesh,
                           microbatches=PIPE_MB)
    want = []
    for mb in xp.reshape(PIPE_MB, -1, PIPE_D):
        for i in range(PIPE_L):
            mb = _pipe_block(mb, {"w": params["w"][i], "b": params["b"][i]})
        want.append(mb)
    want = torch.stack(want).reshape(PIPE_B, PIPE_D)
    check(torch.equal(got, want), "distributed: the one-stage pipeline is "
          "not the sequential run")
    whole = xp
    for i in range(PIPE_L):
        whole = _pipe_block(whole, {"w": params["w"][i], "b": params["b"][i]})
    # the gradient through the one-stage pipeline: sequential autograd's
    c = torch.randn(PIPE_B, PIPE_D, device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    leaves_ = [params["w"], params["b"], xp]

    def grads(run):
        ts = [t.clone().requires_grad_() for t in leaves_]
        loss = (run({"w": ts[0], "b": ts[1]}, ts[2]) * c).sum()
        return torch.autograd.grad(loss, ts)

    def sequential(p, h):
        outs = []
        for mb in h.reshape(PIPE_MB, -1, PIPE_D):
            for i in range(PIPE_L):
                mb = _pipe_block(mb, {"w": p["w"][i], "b": p["b"][i]})
            outs.append(mb)
        return torch.stack(outs).reshape(PIPE_B, PIPE_D)
    gp = grads(lambda p, h: pipeline_forward(_pipe_block, p, h, mesh=mesh,
                                             microbatches=PIPE_MB))
    gs = grads(sequential)
    check(all(torch.equal(a, b) for a, b in zip(gp, gs)),
          "distributed: the one-stage pipeline's gradients are not "
          "sequential autograd's")
    out.update(int8_pod_of_one_is_x=True, pipeline_bitwise=True,
               pipeline_grad_bitwise=True,
               pipeline_vs_whole_batch_max_abs=float(
                   (got - whole).abs().max()))
    dist.destroy_process_group()
    return out


def _dist_rank(rank, world, port, out):
    """(b) one rank of the gloo world on the card: ``int8_allreduce_pod``
    of its own seeded input over the pod group of a (2, 1, 2) mesh; each
    rank writes its input and result."""
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.distributed.compression import int8_allreduce_pod
    from repro_torch.launch.mesh import init_world, make_mesh
    init_world(init_method=f"tcp://localhost:{port}", world_size=world,
               rank=rank, backend="gloo")
    mesh = make_mesh(DIST_MESH, DIST_AXES)
    x = torch.randn(4096, 33, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(100 + rank)) * (1 + rank)
    y = int8_allreduce_pod(x, mesh)
    torch.cuda.synchronize()
    np.savez(Path(out) / f"rank_{rank}.npz", x=x.cpu().numpy(),
             y=y.cpu().numpy(), coords=np.asarray(mesh.get_coordinate()),
             device=np.asarray(str(y.device)))
    torch.distributed.destroy_process_group()


def _spawn_world(fn, world, *args):
    """``world`` ranks of ``fn`` (spawned), killed at DIST_DEADLINE_S:
    (ok, what went wrong)."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(world, _free_port(), *args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DIST_DEADLINE_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                return False, f"deadline {DIST_DEADLINE_S} s"
    except Exception as e:              # a rank raised or died
        return False, str(e)[-400:]
    return True, ""


def _numpy_int8_mean(xs):
    """The int8 wire's arithmetic in numpy (f32): per-tensor scale max|x|
    / 127, codes round-half-even clipped to +-127, dequantized, summed in
    gather order, divided by the count."""
    import numpy as np
    acc = None
    for x in xs:
        scale = np.maximum(np.abs(x).max() / np.float32(127.0),
                           np.float32(1e-20)).astype(np.float32)
        q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
        d = q.astype(np.float32) * scale
        acc = d if acc is None else (acc + d).astype(np.float32)
    return (acc / np.float32(len(xs))).astype(np.float32)


def _dist_gloo():
    """(b) DIST_RANKS ranks spawned on the one card over gloo with CUDA
    tensors, mesh DIST_MESH: pod 2 carries the int8 wire, model 2 would
    carry TP.  ``int8_allreduce_pod`` on distinct inputs a rank equals the
    numpy formula over its pod group, exactly; the cases whose collectives
    gloo refuses on CUDA tensors are left out and named."""
    import shutil
    import numpy as np
    d = ROOT / "build" / "dist_gloo"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    t0 = time.monotonic()
    ok, why = _spawn_world(_dist_rank, DIST_RANKS, str(d))
    check(ok, f"distributed: the gloo world failed: {why}")
    got = [dict(np.load(d / f"rank_{r}.npz")) for r in range(DIST_RANKS)]
    pods = {}
    for r, g in enumerate(got):
        pods.setdefault(tuple(g["coords"][1:]), []).append(
            (int(g["coords"][0]), r))
    err = 0.0
    for r, g in enumerate(got):
        members = [m for _, m in sorted(pods[tuple(g["coords"][1:])])]
        want = _numpy_int8_mean([got[m]["x"] for m in members])
        check(np.array_equal(g["y"], want),
              f"distributed: rank {r}'s int8 mean is not the numpy formula")
        check(str(g["device"]).startswith("cuda"),
              f"distributed: rank {r} computed on {g['device']}")
        err = max(err, float(np.abs(g["y"] - np.mean(
            [got[m]["x"] for m in members], axis=0)).max()))
    shutil.rmtree(d, ignore_errors=True)
    return {"ranks": DIST_RANKS, "mesh": list(DIST_MESH), "backend": "gloo",
            "tensors": "cuda", "int8_equals_numpy": True,
            "int8_max_abs_vs_f32_mean": err,
            "world_s": time.monotonic() - t0, "left_out": GLOO_LEFT_OUT}


def phase_distributed(state):
    """The distributed substrate on the card: (a) world 1 on NCCL at full
    width, (b) 4 ranks on the one card over gloo; neither kernel may
    launch."""
    import gc
    import torch
    from repro_torch.kernels import launch_counts
    gc.collect()
    torch.cuda.empty_cache()
    counts = launch_counts()
    t0 = time.monotonic()
    world1 = _dist_world1()
    world1["seconds"] = time.monotonic() - t0
    t1 = time.monotonic()
    gloo = _dist_gloo()
    gloo["seconds"] = time.monotonic() - t1
    delta = _no_kernel_launch(counts, "distributed")
    emit({"phase": "distributed", "gpu": state["gpu"],
          "arch": _train_cfg().name, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQS[0], "world1": world1, "gloo": gloo,
          "launch_delta": delta, "seconds": time.monotonic() - t0})


# the dry-run cells of (c): (arch, shape, variant)
ANALYTIC_CELLS = (("llama3p2_1b", "decode_32k", "base"),
                  ("gemma3_4b", "decode_32k", "unroll_local"))
_DRYRUN_CELLS = """
import sys
from repro_torch.launch import dryrun
out = sys.argv[1]
for i, (arch, shape, variant) in enumerate(%r):
    dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "single",
                 "--variant", variant, "--out", out]
                + (["--force"] if i == 0 else []))
"""


def _dryrun_cell():
    """(c) the full-width dry-run cells of ANALYTIC_CELLS one after the
    other in one process on the CPU (its fake process group of 256 ranks
    never meets this process's groups), started before the first phase so
    that it runs beside them; its rows and output go to
    ``build/analytic/``.  Returns (process, row file, log file)."""
    import os
    out = ROOT / "build" / "analytic" / "dryrun.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    log = out.with_suffix(".log")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", _DRYRUN_CELLS % (ANALYTIC_CELLS,),
             str(out)], env=env, stdout=f, stderr=subprocess.STDOUT,
            text=True)
    return proc, out, log


def _analytic_step(state):
    """(a), (b): one eager llama2-7b decode step at 4 x STEP_CONTEXT on
    the cuda backend under ``op_cost``'s counter."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import op_cost as OC
    from repro_torch.launch import roofline as RL
    from repro_torch.models import transformer as T
    dev = torch.device("cuda")
    cfg = configs.get("llama2_7b")
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(2)
    batch = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                         (SERVE_SLOTS, STEP_CONTEXT)),
                            device=dev)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, 1)),
                          device=dev)
    with torch.no_grad():
        _, caches = T.prefill_model(params, cfg, batch, PAPER_POLICY,
                                    max_len=MAX_LEN, backend="cuda")
        T.decode_step(params, cfg, tok, caches, PAPER_POLICY, backend="cuda")
        torch.cuda.synchronize()
        reset_launch_counts()                               # the step only
        with OC.OpCounter() as c:
            lg, _ = T.decode_step(params, cfg, tok, caches, PAPER_POLICY,
                                  backend="cuda")
        torch.cuda.synchronize()
    counts = launch_counts()
    del params, caches
    check(bool(torch.isfinite(lg).all()), "analytic step: logits not finite")
    n = cfg.n_layers
    check(counts["decode_attn"]["kernel"] == n
          and counts["kv_quant"]["append"] == n
          and counts["decode_attn"]["plain"] == 0
          and counts["kv_quant"]["append_plain"] == 0,
          f"analytic step: launches {counts}")
    for k in ("kernel:decode_attn", "kernel:kv_append"):
        check(c.counts.get(k, {}).get("ops") == n,
              f"analytic step: the counter saw {c.counts.get(k)} for {k}, "
              f"not {n} reports")
    rl = RL.from_counts(c.totals(), model_flops_per_device=RL.model_flops(
        cfg, "decode", SERVE_SLOTS, STEP_CONTEXT))
    replay = state.get("replay_ms")
    bound_ms = rl.bound_time * 1e3
    return {"arch": cfg.name, "slots": SERVE_SLOTS,
            "context": STEP_CONTEXT, "launches": counts,
            "by_category": c.counts, "totals": c.totals(),
            "t_compute_ms": rl.t_compute * 1e3,
            "t_memory_ms": rl.t_memory * 1e3, "bound_ms": bound_ms,
            "dominant": rl.dominant,
            "replayed_ms": replay,
            "roofline_share": bound_ms / replay if replay else None,
            "model_flops": rl.model_flops,
            "counter_matmul_flops": c.counts["matmul"]["flops"],
            "constants": {"bf16_peak": RL.PEAK_FLOPS, "hbm": RL.HBM_BW}}


def phase_analytic(state):
    """The analytic launch path on the card: (a) one eager llama2-7b step
    at 4 x 2048 counted by ``op_cost`` (both kernels report through their
    formula: 32 decode_attn and 32 kv_append reports), its roofline terms
    and the share of that bound the replayed step (serve_graph) reaches;
    (b) ``model_flops`` of the step beside the counter's matmul FLOPs; (c)
    two full-width dry-run cells (llama3.2-1b x decode_32k and gemma3-4b x
    decode_32k x unroll_local on 16 x 16 fake ranks) in a subprocess on
    the CPU, started before the first phase (``main``) and read here."""
    import gc
    import json as _json
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    proc, out, log = state.pop("dryrun", None) or _dryrun_cell()
    try:
        step = _analytic_step(state)
        step["seconds"] = time.monotonic() - t0
        proc.wait(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = log.read_text()
    check(proc.returncode == 0, f"analytic dry-run cells failed: "
          f"rc {proc.returncode}: {text[-2000:]}")
    rows, lines = [], []
    for arch, shape, variant in ANALYTIC_CELLS:
        row = next(r for r in _json.loads(out.read_text())
                   if (r["arch"], r["shape"], r["variant"])
                   == (arch, shape, variant))
        check(row["status"] == "ok", f"analytic dry-run cell: {row}")
        row.pop("trace", None)
        rows.append(row)
        lines.append(next(ln for ln in text.splitlines()
                          if ln.startswith(arch) and variant in ln))
    emit({"phase": "analytic", "gpu": state["gpu"], "step": step,
          "dryrun_cell": rows[0], "dryrun_line": lines[0],
          "dryrun_unroll_cell": rows[1], "dryrun_unroll_line": lines[1],
          "dryrun_trace_s": {f"{a} {s} {v}": r["compile_s"]
                             for (a, s, v), r in zip(ANALYTIC_CELLS, rows)},
          "seconds": time.monotonic() - t0})


def _gloo_probe_rank(rank, world, port, what):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_world, make_mesh
    init_world(init_method=f"tcp://localhost:{port}", world_size=world,
               rank=rank, backend="gloo")
    x = torch.ones(64, device="cuda") * (rank + 1)
    if what == "dtensor_all_gather":
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        mesh = make_mesh((world,), ("data",))
        t = distribute_tensor(x, mesh, [Shard(0)], src_data_rank=None)
        t.redistribute(mesh, [Replicate()]).to_local()
    else:
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
               dist.P2POp(dist.irecv, torch.empty_like(x),
                          (rank - 1) % world)]
        for r in dist.batch_isend_irecv(ops):
            r.wait()
    torch.cuda.synchronize()
    dist.barrier()
    dist.destroy_process_group()


def gloo_probe() -> int:
    """``--gloo-probe``: each collective of GLOO_LEFT_OUT in a 2-rank gloo
    world of CUDA tensors on the one card, alone; prints what happened."""
    for what in ("dtensor_all_gather", "send_recv"):
        ok, why = _spawn_world(_gloo_probe_rank, 2, what)
        emit({"gloo_probe": what, "ok": ok, "error": why})
    return 0


# kernel-name fragments of each kind, first match wins
KERNEL_KINDS = (
    ("port: decode_attn + merge", ("decode_attn_split", "merge_splits")),
    ("port: kv_quant + kv_append", ("kv_quant_kernel", "kv_append_kernel",
                                    "kv_quant_wide", "kv_quant_rows")),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass", "splitKreduce")),
    ("copy / cast", ("copy_kernel", "CatArrayBatchedCopy")),
    ("index / gather / scatter", ("index", "gather", "scatter")),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized")),
)


def _kind(name: str) -> str:
    """The KERNEL_KINDS kind of a kernel name."""
    return next((g for g, tags in KERNEL_KINDS if any(t in name for t in
                                                        tags)), "other")


def _profile_decode(step, n: int = 1):
    """Device time by kernel over ``n`` calls of ``step`` (torch.profiler,
    the device's kernels alone: no host op events, which cost more to
    collect than the kernels and are not read): busy share of the wall
    time, launches per call, top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:     # kernels only: aten ops
            continue                             # would count them twice
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.count, e.key))
    dev_us = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    ours = {}                    # the port's kernels, by source name
    for us, c, k in rows:
        for tag in ("decode_attn_split", "merge_splits", "kv_quant_kernel",
                    "kv_append_kernel"):
            if tag in k:
                e = ours.setdefault(tag, {"ms_per_step": 0.0,
                                          "calls_per_step": 0.0})
                e["ms_per_step"] += us / n / 1e3
                e["calls_per_step"] += c / n
    for e in ours.values():
        e["us_per_call"] = e["ms_per_step"] * 1e3 / e["calls_per_step"]
    groups = {}                  # device ms per step by kind of kernel
    for us, c, k in rows:
        e = groups.setdefault(_kind(k), {"ms_per_step": 0.0,
                                         "calls_per_step": 0.0})
        e["ms_per_step"] += us / n / 1e3
        e["calls_per_step"] += c / n
    return {"steps": n, "wall_ms_per_step": wall_us / n / 1e3,
            "device_ms_per_step": dev_us / n / 1e3,
            "device_busy_share": dev_us / wall_us if wall_us else None,
            "kernels_per_step": sum(r[1] for r in rows) / n,
            "port_kernels": ours, "by_kind": groups,
            "top": [{"name": k[:80], "ms_per_step": us / n / 1e3,
                     "calls_per_step": c / n} for us, c, k in rows[:8]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gloo-probe", action="store_true",
                    help="only run each collective gloo refuses on CUDA "
                         "tensors in a 2-rank world and print the outcome")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    if args.gloo_probe:
        return gloo_probe()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = {"dryrun": _dryrun_cell()}          # beside the phases (CPU)
    seconds = {}
    try:
        for phase in (phase_env, *(globals()[f"phase_{n}"] for n in EARLY),
                      phase_build, phase_kv_quant, phase_kv_append,
                      phase_decode_attn, phase_decode_attn_pooled,
                      phase_serve, phase_serve_pooled, phase_serve_graph,
                      phase_serve_chunked, phase_calibrate, phase_quality,
                      phase_serve_schedule, phase_serve_degrade,
                      phase_table6, phase_serve_families, phase_serve_moe,
                      phase_serve_hybrid, phase_serve_encdec,
                      phase_analytic):
            t0 = time.monotonic()
            phase(state)
            seconds[phase.__name__[6:]] = round(time.monotonic() - t0, 1)
    finally:
        if "dryrun" in state and state["dryrun"][0].poll() is None:
            state["dryrun"][0].kill()
            state["dryrun"][0].wait()
        if "build" in state:                     # a failed EARLY phase
            state["build"]["thread"].join()
        if "quality" in state:
            _quality_cleanup(state.pop("quality"))
    emit({"phase": "timing", "seconds": seconds})
    entries = []
    for name, src, rep in (
            ("decode_attn", "src/repro_torch/csrc/decode_attn.cu",
             "src/repro/kernels/decode_attn.py:137"),
            ("decode_attn_pooled", "src/repro_torch/csrc/decode_attn.cu",
             "src/repro/kernels/decode_attn.py:137 (block_table)"),
            ("kv_quant", "src/repro_torch/csrc/kv_quant.cu",
             "src/repro/kernels/kv_quant.py:78"),
            ("kv_append", "src/repro_torch/csrc/kv_quant.cu",
             "src/repro/kernels/kv_quant.py:78 + "
             "src/repro/core/kv_cache.py:471")):
        m = state[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep, "launches": state["launches"][name],
                 "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                 "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                 "bound_by": m["bound_by"],
                 "library_ms": m.get("library_ms")}
        entry.update({k: m[k] for k in KERNEL_EXTRAS if k in m})
        entries.append(entry)
    emit({"kernels": entries})
    print(state["gpu"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
