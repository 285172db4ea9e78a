"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--phases build,kernel,parity,serve,serve-profile,
                           train-parity,train,moe-train-parity,moe-train,
                           zero,sparse,offload,kvmove,observe,fleet,tp,seq]
                          [--out DIR]

Phases (every one raises on failure; nothing is caught and passed over):

1. build  — compile every CUDA kernel of the port from ``ops/csrc`` with
   nvcc for sm_90a, all sources at once, and print the build times.
2. kernel — hold each kernel against its plain PyTorch version on the card
   at the serving and training paths' shapes, and time the kernel, the
   plain version, a PyTorch yardstick and the kernel's bound:
   - K1, the paged-attention kernels (llama2-7b geometry and a GQA geometry;
     decode, a 256-token prefill chunk over several pool pages, a
     window-shaped stage; an empty slot and trash-padded block tables), in
     fp32 (max absolute error 1e-4) and bf16 (max absolute error over max
     |plain| 1e-2: p is rounded to bf16 before the PV product, in a
     different order than the plain version's). q is drawn at 3x the keys'
     spread so the softmax is peaked and a wrong score shows in the output.
     Each case names the kernel that served it (``kernel_plan``: the bf16
     chunk kernel on wgmma for more than 16 rows per (slot, KV head), the
     bf16 split kernel with its split count otherwise, the fp32 FMA
     kernel), is launched twice with identical bits required, and prints
     its TFLOP/s, GB/s and share of the bound. The phase first prints the
     bf16 kernels' registers, stack, spills, shared memory and any wgmma
     serialization (from the build's ``-Xptxas -v``), and the wrapper's
     host µs per call by kernel beside the fp32 kernel's one-launch path.
     Yardstick: one ``scaled_dot_product_attention`` call over the same K/V
     gathered dense.
   - K1's sliding-window, rolling-ring and tree-verify forms, in fp32, bf16
     and over an e4m3 pool with the same tolerances, judged on live slots:
     a decode-window step (8 slots, one empty) and a 256-token prefill
     chunk at mistral-7b geometry (H 32, KV 8, D 128) over ~6000-token
     contexts with the 4096-key window, on a linear table and on a wrapped
     69-page ring; tree verify of an 8-node branchy tree at llama2-7b (G 1)
     and mistral (G 4) geometry. Each is counted as its form. The bound
     counts only the keys some query row sees (inside the window or ring);
     the SDPA yardstick gets an explicit boolean mask of who sees what.
   - K1's e4m3-pool form at the same llama2-7b shapes over an e4m3 pool,
     against the plain version rounding p against the kernel's walk (64-key
     tiles; the split kernel's splits); judged by max |error| over max
     |plain| and mean |error| over
     mean |plain| (``K1_E4M3_TOL``: a p that lands within fp32 noise of an
     e4m3 rounding boundary may round the other way, one e4m3 step).
     Yardstick: the same SDPA call over the pages upcast.
   - K2, the quantized-weight product, for int8, int4 and e4m3 codes at
     decode M=8 and prefill M=256, on llama2-7b's wq, w_gate, w_down and
     unembed shapes plus a stacked [L, K, N] case at a non-zero layer;
     unit-normal x, weights whose scales differ by K-group and by column;
     judged by max |error| over max |plain| (``K2_TOL``), launched twice
     with identical bits required. Each case prints its route
     (``kernel_route``: bf16 takes the wgmma kernels, and must, with the
     token columns and K split of ``tc_split``; fp32 the FMA kernels); the
     phase first prints the wgmma kernels' registers, stack, spills,
     shared memory, ring stages and any wgmma serialization (from the
     build's ``-Xptxas -v``), then checks one-hot rows of x against the
     dequantized weight bit for bit, and last the wrapper's host µs per
     call. No single PyTorch call computes K2's function; the yardstick is
     ``torch.matmul`` with a dense bf16 weight of the same shape, the
     product K2 replaces. K1 and K2 also run at qwen2-moe-a2.7b's geometry
     (H = KV = 16) and shapes (its 2048 x 151936 unembedding).
   - K5, the grouped expert product, in bf16 and fp32, and K3, its
     quantized form, for int8, int4 and e4m3 codes (plus stacked codes at
     a non-zero layer), on qwen2-moe's expert w_gate [60,2048,1408] and
     w_down [60,1408,2048] and Mixtral's w_gate [8,4096,14336], at decode
     routing (8 tokens x top-k) and prefill routing (2048 x 4, 512 x 2),
     plus a skewed (all tokens on one expert's set) and an idle-expert
     routing, and K5's forward at one micro-batch of the moe-train phase
     (4096 tokens x top-4) on qwen2-moe's two shapes; judged by
     ``K2_TOL``, a second launch giving the same bits. Each K3 case names
     its route (bf16: the wgmma kernels with runs of ``grouped_run_tiles``
     32-row tiles). Each K5 case names
     its route (``gmm_route``: bf16 at block_m 128 takes the wgmma kernels,
     fp32 the FMA kernels); a wgmma case also times its forward with 64-
     and 128-row blocks beside the size ``gmm_block_rows`` picks; the
     phase first prints the wgmma kernels' registers, stack, spills,
     shared memory and any wgmma serialization (from the build's
     ``-Xptxas -v``). Bound: the x rows that hold routed
     tokens, each active expert's weights once and the routed output
     rows, or 2 x routed rows x K x N operations. Yardstick: one
     ``torch._grouped_mm`` call in bf16 over the same expert-aligned
     buffer (for K3 the bf16 product it replaces).
   - K5's backward, dx and dw, in bf16 and fp32, on qwen2-moe's expert
     w_gate and w_down at one micro-batch of the moe-train phase (2 x 2048
     tokens x top-4: 16384 routed rows, Tp 24064) and Mixtral's w_gate at
     512 x 2, under uniform, skewed (every token on 4 experts) and
     idle-expert routings, each counted on its route; judged by
     ``K2_TOL``, a second launch giving the same bits. Bound: dx reads the
     routed dy rows and each active expert's weights and writes the routed
     dx rows; dw reads the routed x and dy rows and writes every expert's
     [K, N]; 2 x routed rows x K x N operations. Yardsticks:
     ``torch._grouped_mm`` in bf16 (dx a 2d x 3d call with w transposed,
     dw the 2d x 2d call ragged over rows), and its forward + backward
     through autograd beside K5's forward + dx + dw.
   - K4, flash attention, forward (out and lse) and backward (dq, dk, dv
     from the plain forward's out and lse), in fp32 and bf16, at llama2-7b
     geometry (H = KV = 32, D = 128) at S = 1024 (where the Pallas
     backward is one block), 2048 (the train phase's shape) and 4096,
     mistral-7b's GQA (KV 8) at 2048, gpt2-1.3b's D = 64 at 1024, and a
     non-causal call; B = 1-4. Tolerances ``K4_TOL``: fp32 output by max
     |error| 1e-4, fp32 grads by max |error| over max |plain| 1e-3, bf16
     everything by max |error| over max |plain| 2e-2. Bound: the
     causally visible pairs' operations (4 x pairs x D forward, 10 x
     pairs x D backward) over 989 TFLOP/s (bf16) or 67 (fp32), against
     the bytes over 3.35 TB/s. Yardstick: one
     ``scaled_dot_product_attention(is_causal=...)`` call over K/V
     repeated per q head, forward and forward + backward. Each case
     prints the kernel's ms, TFLOP/s (the counted operations over its
     time) and share of the bound beside SDPA, and the host µs the bf16
     wrapper spent encoding its TMA tensor maps; the phase first prints
     the bf16 tensor-core kernels' registers, stack, spills (from the
     build's ``-Xptxas -v``) and dynamic shared memory, and last the
     train shape's bf16 times against PERF.md's (``K4_PERF_MD_MS``).
   - K6, block-sparse flash attention, forward (out and lse), dq and dk/dv
     (each timed alone and together), in bf16 and fp32, q at 3x the keys'
     spread: at bert-large-uncased width (H 16, D 64, B 2, S 4096, block
     128) under the Fixed, per-head BigBird, BSLongformer and Variable
     configs; at llama2-7b width (H 32, D 128, B 1, S 8192) under Fixed
     unidirectional with causal masking; a dense causal layout at K4's
     train shape (B 2, S 2048), also timed through K4; a random layout
     with an empty query row and a row that sees only a block above the
     diagonal (their outputs and dq must be 0); blocks of 256 (S 4096)
     and 192 (S 3072). Each case names its route (``kernel_route``: bf16
     at blocks that are a multiple of 128 takes K4's wgmma kernels over
     the layout's table, and must; fp32 and block 192 the FMA kernels), is
     launched twice with identical bits required, and prints its TFLOP/s
     and share of the bound beside SDPA and, on the dense layout, K4; the
     phase first prints the wgmma kernels' registers, stack, spills,
     shared memory and any wgmma serialization (from the build's
     ``-Xptxas -v``), and last the main case's forward + backward against
     masked SDPA's and the dense layout against K4. Tolerances
     ``K4_TOL``. Bound: K4's, over the visible token pairs of the layout.
     Yardstick: one ``scaled_dot_product_attention`` call with the
     boolean token mask ``[1, H, S, S]``, forward and forward + backward
     (bf16).
   - K7, the per-layer-slice paged attention over separate K/V pools, in
     fp32 and bf16 by ``K1_TOL`` with an empty slot and trash-padded
     tables: llama2-7b geometry (block 64) decode of 8 slots at 256-4000
     context and a 4 x 256 prefill chunk over 0-768 context; mistral-7b
     geometry with its 4096 window on a linear table and on a wrapped
     69-page ring, decode and a 4 x 256 chunk; in bf16 through the same
     chunk and split kernels as K1 (each case names its kernel and is
     launched twice, identical bits required). Bound: q, the output and
     the K/V rows some query row sees. Yardstick: SDPA over the gathered
     K/V with the boolean mask of who sees what.
   - The tp phase's per-rank shapes (``phase_tp_shards``), with the same
     tolerances, times and bounds: K1 at one rank's heads (llama2-7b 16 /
     16 and qwen2-moe 8 / 8 in bf16, default and e4m3 pools; mistral-7b 8
     / 2 in fp32 on its ring), K2 on per-shard codes (llama2-7b's w_gate,
     w_down and unembedding shards at TP 2 and 4, qwen2-moe's wq at TP
     2; every format where the last column block is padded or the group
     falls under 128), K3 on qwen2-moe's experts split in two (704).
3. parity — llama2-7b at full width with 4 layers in fp32: the engine's
   greedy streams against the dense ``TransformerLM.forward``
   teacher-forced on each stream (one forward over the prompt and the
   stream gives every step's logits). TF32 is off for matmuls and cuDNN. Streams
   must be identical and every sampled step's logits agree within 1e-3
   relative; the one allowed exception is a step where the oracle's top-2
   logit gap is below 1e-4 (a near-tie in random weights), printed as such.
   Every engine runs its async pipeline (``max_inflight`` 8) and replays a
   captured CUDA graph for every decode window and decode step (the
   programs also return their logits, which ride to the host with the
   tokens); llama2-7b serves a second time at ``max_inflight=0``, and its
   streams must equal the first's. Then the same with ``quant_bits`` 8, 4
   and "fp8", the oracle's weights being ``dequantize_weight`` of the
   engine's codes; and an e4m3-pool
   engine whose logits must stay within 0.5 (max) and 0.05 (mean) of the
   fp32-pool engine's while their streams agree (the JAX package's bound
   for its fp8 pool). Then Mixtral-8x7B (the capacity route, ``dropless``,
   ``quant_bits`` 8, 4 and "fp8") and qwen2-moe-a2.7b (``dropless``,
   ``quant_bits=8``) at full width with 4 layers, each against the model
   with no token dropped (eval capacity factor = number of experts), over
   the dequantized codes for the quantized routes. Then mistral-7b (4
   layers) served from its 69-page rolling ring: prompts of 4600 and 4700
   tokens (past the 4416-token ring) and 300, 32 new tokens, against the
   dense forward (which masks the window) under the same rule, and an
   e4m3-pool ring within the fp8 bound. Then llama2-7b (4 layers) with
   ``spec_decode``: "ngram" over motif prompts (at ``max_inflight=0``:
   prompt lookup reads the committed history, and its rounds are
   required here), "draft" with a same-weights
   draft (acceptance must exceed 0.9) and a differently seeded one, each
   stream identical to the spec-off engine's (a parting is allowed only at
   a near-tie of the dense model, as above); spec on a windowed model must
   raise ValueError. Each run asserts its K1 / K2 / K3 / K5 launches — K1's
   window and ring forms on every ring-served call, its tree form once per
   layer of every verify — counted per graph replay, 0 plain launches, and
   that every decode window and decode step replayed a graph.
4. serve  — llama2-7b at full width and depth in bf16 from seeded random
   weights: 8 requests of 256-1024 prompt tokens (a shared 128-token system
   prefix) and 64 new tokens each, through put/step/query/flush, with the
   async pipeline (``max_inflight`` 8) and every decode program captured
   before the timed serve (``warm_decode_windows``, ``warm_decode_step``;
   the serve must capture none). Prints output tok/s, p50 TTFT, decode
   ms/token-step (the decode tail's span on the stream, timed by CUDA
   events from where the work dispatched before it ends, over the
   token-steps dispatched in it; and the window steps' host time over
   their iterations, the measure of earlier runs), peak memory, the
   parameter bytes on the card, the captured graphs (count, capture
   seconds, pool bytes), their replays by key (every decode window and
   decode step must replay one), forced and opportunistic drains, host us
   a window dispatch, and the kernels' launches: K1 equals layers x
   forward dispatches (counted per replay), every one through the chunk or
   the split kernel, the plain versions' counts are 0. One more decode
   window is timed by CUDA events. The bf16 and int8 llama2-7b runs hold
   one window's graph replay against the same window run eagerly from the
   same state, bit for bit (tokens, pool pages, last tokens, launches).
   Every timed serve runs before any profiler: its CUPTI tracing stays
   subscribed in the process and slows every later launch from the host.
   Then, with the ``serve-profile`` phase (named on its own: ``--phases
   build,serve,serve-profile``; the default run leaves this record out,
   for the script's time limit), each configuration is built again alike,
   and a profiled decode
   window (the pipeline drained first) splits its device time by kernel
   and says whether the profiler named the replayed kernels; the next
   window's host time is printed beside the timed pass's.
   Run three times: bf16
   weights and pool; ``quant_bits=8`` with ``kv_cache_dtype="fp8"`` (K1's
   e4m3 form); ``quant_bits=4``. The quantized runs launch K2 225 times per
   forward (7 products x 32 layers + the unembedding) and hold at most 0.55x
   (int8) and 0.30x (int4) of the bf16 run's parameter bytes. Then
   qwen2-moe-a2.7b at full width and depth, the same three runs: bf16 with
   ``moe.dropless`` (K5 72 launches per forward: 3 expert products x 24
   layers, every one on the wgmma route), and the quantized runs (K3 72,
   K2 97 per forward), within 0.56x and 0.34x of the bf16 parameter
   bytes. Then mistral-7b at full
   width and depth from its rolling ring (block 64, max_seq_len 8192,
   chunk 256, prefix cache off): 8 requests of 64 new tokens, 4 with
   4608-6144-token prompts and 4 with 256-1024, in bf16 and with
   ``kv_cache_dtype="fp8"``; each asserts that the ring wrapped and that
   no sequence owned more than its 69 pages, and profiles one prefill step
   of 4 long prompts (256-row chunks past 4096 keys of context): wall,
   device busy, K1 and the matrix products. Then llama2-7b at full depth
   on motif prompts: spec-off, ``spec_decode="ngram"`` and "draft" with the
   model itself as the draft (at least one verify), printing verify
   rounds, acceptance, tokens per verify and K1's tree launches beside the
   spec-off run's tok/s and TTFT. Prompt lookup probes the committed
   history, which lags the pipeline by up to ``max_inflight`` dispatches,
   so the "ngram" run serves at ``max_inflight=0``; each spec run must make
   at least one verify round. Acceptance is held to 0.9 in the fp32
   parity phase only: in bf16 the draft's one-token decode and the
   target's 8-node verify round near-ties of the random model's flat
   logits differently.

5. train-parity — llama2-7b's width at 4 layers in fp32 (TF32 off), S =
   1024, 1 x 2 sequences, 3 AdamW steps from one seeded init and batch,
   trained through ``deepspeed_tpu_torch.initialize`` once with
   ``attn_impl="pallas"`` (K4) and once with ``"xla"`` (the plain route):
   losses within 1e-5 relative, parameters within 1e-4 of max |param|.
6. train — llama2-7b's width (E 4096, H 32, D 128, F 11008, vocab 32000)
   at 8 layers (~1.9 B parameters; the full depth with Adam on the card
   needs ~112 GB: the offload phase trains it) from seeded random fp32
   weights: bf16 with an
   fp32 master, AdamW, micro-batch 2 x gas 2 of 2048 tokens, remat
   "full", 5 steps on a repeated batch. Every loss finite and the last
   below the first; K4's forward launched layers x micro-batches x 2 per
   step (remat runs each layer's forward again), its backward layers x
   micro-batches, no plain version and no other kernel. Prints tokens/s,
   ms per step, peak memory and K4's share of a profiled step.
7. moe-train-parity — qwen2-moe-a2.7b's width at 2 layers in fp32 (TF32
   off), ``moe.dropless``, 1 x 2 x 1024 tokens, 3 AdamW steps from one
   seeded init and batch, trained once through K5's kernels (forward, dx,
   dw) and once through its plain versions on the card: losses within
   1e-6 relative, parameters within 1e-4 of max |param|, the runs'
   parameter changes within 1e-2 of the largest change.
8. moe-train — qwen2-moe-a2.7b's width (E 2048, 60 experts top-4 of 1408,
   shared expert 5632, vocab 151936) at 4 layers (~2.9 B parameters; its
   24 layers with Adam need ~230 GB), ``moe.dropless``, bf16 with an fp32
   master, AdamW, micro 2 x gas 2 x 2048 tokens, remat "full", 5 steps on
   a repeated batch: losses finite and falling; K5's forward launched 240
   times (3 products x 4 layers x 2 micro-batches x 2 under remat x 5
   steps), dx and dw 120 each, every one on the wgmma route, K4 80 / 40,
   nothing else. Prints ms per
   step, tokens/s, peak memory and a profiled step's split into K4, K5
   forward / dx / dw, cuBLAS, other and idle share.
9. zero — ZeRO over NCCL at world 1 (an in-process store), TF32 off:
   (a) llama2-7b width at 2 layers, bf16 with an fp32 master, AdamW, micro
   1 x gas 2 x 1024, remat "full", no clipping: stages 0, 1, 2 and 3 for 3
   steps each give bit-identical losses and master; clipping 1.0 at
   stages 0 and 3 within 1e-6 relative; K4 launched layers x micro-batches
   x 2 forward and x 1 backward a step, nothing else. (b) stage 3 saves at
   step 2 (crc32); a fresh stage-1 engine loads it and its step 3 is bit
   for bit stage 3's; ``get_fp32_state_dict_from_zero_checkpoint`` equals
   the master; prints free disk, bytes on disk, save / verify / load
   seconds. (c) a NaN injected at step 4 rewinds to the step-2 tag and the
   replayed steps 3-5 are bit for bit the clean run's. (d) two CPU gloo
   ranks (the pool of 2 the tp and seq phases use later, on the CPU
   here) train tiny-llama in fp32 at stage 3 and save; the card loads the
   tag at stage 1: the eval loss within 1e-5 relative, a further step
   finite. (e) stage 3 at the train phase's spec (8 layers, micro 2 x
   gas 2 x 2048, 5 steps) beside stage 0 timed alike in this phase (and
   the train phase's numbers): ms per step, tokens/s and peak memory, the
   same losses bit for bit, K4's launches equal to the train phase's, a
   profiled stage-3 step's split with ZeRO's own kernels apart. (f) qwen2-moe width at 2
   layers, dropless, bf16: stage 0 and stage 3 losses bit-identical over 2
   steps, every K5 launch on the wgmma route.

10. sparse — ``SparseSelfAttention`` end to end: the Fixed, per-head
   BigBird, BSLongformer, Variable and Fixed-unidirectional (causal)
   configs at block 128, each at bert-large width (B 2, S 4096) and
   llama2-7b width (B 1, S 8192), bf16, forward and ``.backward()`` of a
   sum-of-squares loss, one warm-up and 5 timed iterations: K6's forward
   and backward launched 6 times each, all on the wgmma route, nothing
   plain and no other kernel. Prints ms per forward + backward, tokens/s,
   peak memory, ``sparsity()``, K6's share of a profiled step and the
   time of the module's layout copies (the transposes between [B, S, H,
   D] and [B, H, S, D]). Then fp32 parity at S 2048 (BigBird at bert width,
   Fixed unidirectional at llama width): output and q/k/v gradients
   through K6 against the plain route on the card, by the fp32
   ``K4_TOL``. K6's launches in the record line are this phase's; K7 has
   no caller on any path, so its launches are the kernel phase's checked
   calls.

11. offload — first prints the card's name and power limit,
   MemAvailable, ``os.cpu_count()``, the host library's OpenMP threads and
   g++ build seconds (``ops/native.py``), and the free disk. (a) ZeRO-Offload
   on the main path: llama2-7b (E 4096, H 32, D 128, F 11008, vocab 32000)
   at its 32 layers, bf16 with an fp32 master, AdamW, micro 2 x gas 2 x
   2048, remat "full", ZeRO stage 2 at world 1 over NCCL,
   ``offload_optimizer.device="cpu"``, 2 steps on a repeated batch (the
   script's time limit on the slower machines). When
   MemAvailable cannot hold the host state (12 bytes a parameter) plus the
   pinned ring and 10 GB, the depth is cut to the deepest that fits and the
   record says so. Losses finite and falling, the device's peak under 80
   GB, K4 launched layers x 2 x 2 forward and layers x 2 backward a step,
   nothing plain. Prints ms per step, tokens/s and the last step's split:
   the device's forward + backward, the host step, the gradients' copy
   (GB/s and the share hidden behind the host), the host Adam (GB/s of 28
   bytes an element), the bf16 cast and the copy back. (b) The same width
   at 2 layers with ``device="nvme"`` under ``offload.tmp/`` in the
   checkout (free disk checked first, the files removed after), 2 steps:
   losses and master bit for bit a cpu-offload run's; GB read and written
   a step. (c) Twin-Flow ``ratio`` 0.5 against 1.0 at 2 layers: losses
   within 2e-3 relative (the device share updates in ``FusedAdam``'s
   order), both shares non-empty. (d) ZeRO-Infinity (``offload_param`` and
   ``offload_optimizer`` on "cpu", stage 3, ``buffer_count`` 2) at 8
   layers, 2 steps: the device's peak, counted from the first step (the
   fp32 model is made on the card from the seed, as the reference's, and
   moved to the host by ``initialize``), under the model's bf16 parameter
   bytes; losses within 1e-2 relative of (a)'s engine at 8 layers; staged
   bytes, staging hits and K4's launches (as (a)'s per layer). (e) (b)'s cpu
   engine saves at step 2 (integrity "size"); a fresh offload engine loads
   the tag and its step 3 is bit for bit (loss and master), a stage-1 engine
   without offload loads it within 1e-2 relative. (f) The train phase's
   8-layer spec for 3 steps with ``DS_TPU_FUSED_HEAD_CHUNK=8192``, then
   with the "offload" remat policy (7 products a block through pinned host
   memory): peak memory and ms per step beside the plain run's (the train
   phase's, or one made here), losses within 1e-2 relative. K4's launches
   of every run are added to the record line.

12. kvmove — KV movement and the live weight swap on the serve phase's
   llama2-7b (full width, 4 of its 32 layers since the tp phase joined
   the run, 16 since the fleet phase did — the script's time limit; all 32
   before — bf16, seeded random weights;
   block 64, max_seqs 8, chunk 256, ``max_inflight`` 8, decode graphs
   captured), the 8 requests of 256-1024 tokens behind the 128-token
   prefix. Work goes under ``kvmove.tmp/`` in the checkout (free disk
   checked first, removed after). Each leg resets the kernel counts before
   its main path and holds K1 to once per layer of every forward (chunk or
   split kernel), nothing plain. (a) Migration: engine A prefills the 8 to
   their first token and exports them; the bundles cross the wire form
   (8 MB raw chunks with crc32, delivered in reverse order to a
   ``BundleAssembler``); engine B, on A's weight tensors, imports them in
   uid order and decodes 64 tokens. B's imported pages are A's bit for bit,
   every stream is bit for bit the one engine R gives serving the same 8
   without migrating (driven alike: the same dispatches to the first
   tokens, the same decode plans), ``export_commit`` returns A's prefixes
   and both tries then serve the prefix. Prints pages and GB moved, export
   and import ms and GB/s and the time from the export's start to B's first
   decode. (b) ``export_prefix`` from A and ``import_prefix`` into a fresh
   engine: a request hits the whole pulled chain (pages bit for bit the
   source's); prefix-hit tokens and TTFT beside a cold engine. Then a
   3968-token prompt split at token 2048 through ``gang_prefill_segment``
   on two engines: the 62 merged pages and the first token bit for bit one
   engine's serving the whole prompt. (c) One engine with ``kv_tier`` (64 pages
   of RAM, a 256-page spill under ``kvmove.tmp/``) over a pool of ~1.15 x one
   wave's reserved blocks: wave 1 (8 prompts, 64 new tokens), wave 1 again
   (HBM prefix hits), wave 2 (8 other prompts behind another prefix,
   evicting wave 1's chains into the tier), wave 1 a third time
   (promoted; its promotes' own evictions demote wave 2's chains, which
   push the ring's oldest records into the spill): promoted pages bit for
   bit the demoted, its streams bit for bit the second wave's, some promote
   reading from the spill, ``kv_tier_fallbacks`` 0. Prints pages demoted
   and the demotions' seconds, RAM and NVMe residency, each promote with
   its ms and GB/s from RAM and from NVMe (less the demotions it ran),
   crc32's share of wave 2 and the promoted wave, ``measure_tier_rates``
   and the ``min_pages`` it would size, and each wave's p50 TTFT. (d)
   ``save_weights`` (6.9 GB), then ``swap_weights`` to that tag with the 8
   sequences 16 tokens into a 64-token decode, graphs live: every stream
   bit for bit an unswapped run's, graph replays rising with no recapture,
   the tensors at their addresses; save, verify (crc32), quiesce and swap
   seconds printed. The refusals — a torn tag (``integrity``), a 2-layer
   tag (``shape_mismatch``), a missing tag (``no_checkpoint``), a tag with
   a NaN leaf (``probe_failed``) — each leave the old weights serving the
   same stream. Then at 2 layers a swap to a second seed's weights: new
   requests equal a fresh engine's on them, the prefix cache flushed and
   the tier's records dropped.

13. observe — telemetry and HF import on llama2-7b at full depth. Its
   legs (a)-(d) run right after the kernel phase, before every other
   phase (once a profiler has run, CUPTI's tracing stays subscribed and
   every later launch costs more host time: the serve phase profiles), and
   (e) runs last of the whole run. (a) A
   seeded llama2-7b state dict in HF's names and layout
   (``model.layers.{i}.self_attn.q_proj.weight``, torch Linear ``[out,
   in]``, bf16, 32 layers, an untied ``lm_head``; 13.5 GB) sits in host
   memory with a ``SimpleNamespace`` of Llama-2-7B's published config.json
   values as its config; ``models.hf.from_hf_model`` converts it onto the
   card. The config equals the ``llama2-7b`` preset but dtype; every leaf is
   its source under the documented map bit for bit (transpose, heads, q and
   k's half-split → interleaved pairs; checked here with plain indexing);
   no source is left over. Prints conversion seconds and GB/s, peak host
   RSS and device memory, beside a plain copy of the same tensors to the
   card. (b) The imported weights serve the serve phase's traffic and
   settings (8 requests of 256-1024 tokens behind a 128-token
   prefix, 64 new tokens, block 64, ``max_seqs`` 8, chunk 256,
   ``max_inflight`` 8, decode graphs captured first) with ``telemetry=True``,
   ``reqtrace=True``, the HTTP endpoint on port 0 and the requests under two
   tenants, in three pairs (each with fresh suffixes behind the prefix; the
   order within a pair alternates; one untimed serve each first) with a
   second engine on the same weight tensors and telemetry off: streams bit
   for bit equal, graph replays, windows, plans, drains (forced plus
   opportunistic) and K1's launches equal (no plain launch, no capture in a
   serve); which drains wait is a readiness poll the host's timing against
   the device's decides, so the forced count is printed on and off, not
   held equal; ``/metrics`` scraped over 127.0.0.1 with the serve's exact counts
   (``serving_ttft_s`` 8, ``serving_tokens_total`` 512, queue waits 8), the
   occupancy histograms, the page gauge and both tenants' series;
   ``/healthz`` serving; 8 completed reqtrace timelines of lifecycle kinds
   from ``enqueue`` to ``release``, each TTFT within 5 ms of this script's
   own put → first-commit time; the Chrome trace holds ``admit``,
   ``dispatch`` and ``drain_block``. The first request's stream (from a tap
   engine serving the same, its stream checked equal) against the dense
   bf16 oracle (``attn_impl="xla"``): logits within OBSERVE_LOGITS_TOL
   relative, tokens equal but at near-ties (recorded). Prints, on against
   off: decode ms a token-step (CUDA events), host µs a window dispatch,
   p50 TTFT, and the added host work timed alone (the span, the dispatch
   recorder, a window's 8 lifecycle events). (c) Every plan of (b) was packed by ``dstpu_build_atoms``
   (the count printed); 1000 plans of (b)'s shapes packed both ways off
   the path give equal arrays; host µs a plan each. (d) The train phase's
   8-layer spec, 3 steps through K4, with the three below off, then with the
   telemetry section, the CSV monitor and the Prometheus backend: losses
   bit for bit; the MFU gauge (every step of the run) within 2% of this
   script's model FLOPs over its step times and PEAK_OPS[bf16]; a CSV row
   per step; the Prometheus backend's gauges on ``/metrics``. Prints MFU,
   the steady MFU of the steps after the first and goodput beside the
   card's name and power limit. (e) Last of the run: on the seeded
   llama2-7b, a 1 ms TTFT SLO with ``breach_profile_dir`` set makes the one
   request breach; the torch.profiler capture's trace names the
   ``dispatch`` ranges and the replayed K1 kernels. Work goes under ``observe.tmp/`` in the checkout
   and is removed.

14. fleet — the serving fleet on the card: the port's ``Router`` in this
   process, engine replicas spawned by its ``Fleet`` (``python -m
   deepspeed_tpu_torch.serving.replica``), each llama2-7b at full width and
   16 of its 32 layers (the script's time limit since the tp phase joined)
   in bf16 from one seed, at the serve phase's engine settings (block
   64, ``max_seqs`` 8, chunk 256, ``max_inflight`` 8, 256 blocks), serving
   the serve phase's traffic (8 requests of 256-1024 tokens behind a
   128-token prefix, 64 greedy tokens). The kernels and the host library are
   built here first, so replicas load them and never race a compiler. (a)
   Two mixed replicas, one request pinned to each first (its decode graphs
   captured); the traffic (under two tenants) with no fault, then again
   with a replica killed — slot 0, or the slot of the first request to
   stream a token where slot 0 has none: every request done exactly once
   with 0
   double commits, the killed slot respawned to READY, prefix-hit tokens
   above 0. Prints each slot's spawn → READY seconds, output tok/s and p50
   TTFT of the no-fault run, kill → replay-admit seconds, the replays'
   TTFT, respawn → READY seconds. (c) On the same router, telemetry, replica
   snapshots, fleet tracing and the watchtower are on: ``/metrics?aggregate
   =1`` over 127.0.0.1 merges the router and both replicas, its
   ``serving_ttft_s`` counting exactly the requests served; no critical
   alert fires in the no-fault run and the store holds series; fleettrace
   assembles every request's timeline from router to replica, the replays'
   with their retry and both placements; ``python -m
   deepspeed_tpu_torch.telemetry.console --once`` exits 0 and renders both
   replicas. (b) One ``prefill`` and one ``decode`` replica, the prefill
   replica's shared-memory ring sized from /dev/shm's free space (no ring,
   and every chunk on the relay, where it cannot hold one), the same
   traffic after one warm request: each request handed off and decoded on
   the decode replica, ``migrations_out == migrations_in`` = the requests
   served (an import commits only with every chunk's crc verified). Prints
   GB handed off, handoff ms (emit → ack) p50 / max and GB/s, chunks by
   transport, TTFT and tok/s. Every replica exits cleanly and logs its K1
   launches, forwards, capture seconds and peak device memory: K1 once per
   layer of every forward, all on the bf16 chunk or split kernel, nothing
   plain (the killed incarnation logs nothing); this process launches no
   kernel. Last, with the replicas gone, the teacher-forced oracle: the
   dense model (``attn_impl="xla"``, the same seed) over each prompt plus
   each stream; every token its argmax or within ``FLEET_TIE_GAP`` of its
   top logit (a near-tie, counted), for the final streams and the
   client-visible committed ones (a committed stream the router counted as
   a replay mismatch is reported). bf16 streams batched differently may
   part at a near-tie, so streams are not compared with each other. Work
   goes under ``fleet.tmp/`` in the checkout and is removed.

15. tp — tensor-parallel serving as rank processes sharing the one card
   over gloo (NCCL refuses two ranks on one device; tensors gloo cannot
   take from the card pass through pinned host memory, counted in
   ``comm.staged``): ``comm.spawn.RankPool`` ranks (the pools of 2 and 4
   ranks start before the zero phase, whose CPU ranks and the seq phase
   share the pool of 2; see :func:`start_pools`), each building
   ``InferenceEngineV2(..., topology=MeshTopology({"tensor": n}))`` from a
   meta model (each rank draws its slices of the seeded weights a block at
   a time), on the serve phase's engine settings with ``max_inflight`` 0
   (commits within each step; programs run eagerly over gloo, no graph).
   Legs: (a) llama2-7b at full width and depth in bf16 at TP 2, the serve
   phase's shared-prefix traffic (8 requests of 256-1024 tokens behind a
   128-token prefix, 64 new tokens), ``tp_overlap`` off and auto; (b) the
   same model with ``quant_bits=8`` and an e4m3 pool at TP 2, the same
   prompts and 32 new tokens; (c) qwen2-moe-a2.7b at full width, 4 layers,
   int8, TP 2, the same as (b); (d) mistral-7b, 8 layers, fp32, TP 4 (2 KV
   heads a rank, G 4, on its 4096-key rolling ring), ``tp_overlap=True``,
   4 prompts of 4608 / 256 / 384 / 512 tokens and 16 new (the depths and
   budgets: the script's time limit). Every rank's streams and ring counters
   must agree; per rank the phase prints output tok/s, p50 TTFT, decode ms
   per token-step (the eager windows' host time over their iterations),
   host seconds inside the collective calls, the ring counters, and each
   kernel's launches beside the TP-1 engine's on the same forwards: K1
   exactly once a layer of every forward on every rank (bf16: all on the
   chunk or split kernel; (d) all on the ring form), K2 / K3 once a
   quantized product blocking and once a ring step ringing (so at least
   the TP-1 count), no plain version and no other kernel. Streams: (a) the
   teacher-forced dense oracle of the fleet phase (every token its argmax
   or within ``FLEET_TIE_GAP``), (b) and (c) the same oracle over weights
   quantized and dequantized shard by shard as the engine does them
   (qwen2-moe routing every token), (d) the TP-1 engine's streams on the
   same weights, parting only at a near-tie (top-2 gap below 1e-4). These
   are ranks time-slicing one card over gloo: their times say nothing of
   tensor parallelism's speed. The pools' stores go under ``pools.tmp/``
   and are removed.
16. seq — sequence-parallel training as rank processes sharing the one
   card over gloo (the tp phase's pool of two ranks; the seq-1 references
   run in this process first, and it launches no kernel after them). (a) At
   the bf16 leg's shape, [1, 4096, 32, 128] from one seed on both ranks:
   ``ulysses_attention`` over the two ranks (K4 at 16 heads a rank, one
   forward and one backward launch each) against one K4 over the whole
   sequence, and ``ring_attention`` against plain attention in fp32,
   output and q/k/v gradients by max |error| over max |reference| within
   2e-2 (K4's bf16 bound). (b) llama2-7b's width (E 4096, H = KV = 32, D
   128, F 11008, V 32000), micro-batch 1 x 4096 tokens (2048 a rank),
   remat "full", ZeRO stage 0, AdamW at eps 1e-5, 3 steps on one batch,
   at ``{"seq": 2}`` against the same model at seq 1: fp32 at 2 layers
   (0.67 B parameters, 16 B each with the moments and gradients: ~11 GB a
   rank), losses within 1e-5 relative and every parameter within the train
   parity phase's bounds of the seq-1 master (through
   ``seq.tmp/fp32.master.pt``); bf16 with an fp32 master at 4 layers
   (1.07 B parameters at ~18 B each, ~19 GB a rank, ~38 GB for both),
   losses within 2e-3 relative (products over 2048 rows may round a bf16
   ulp apart from those over 4096). Depth is the only cut. Every rank's K4
   launches exactly layers x micro-batches x steps backward and twice
   that forward (remat), no plain launch and no other kernel, the ranks
   alike; the kernels line adds each seq-2 rank's own counts. Prints per
   rank the step times, the host seconds inside Ulysses' all-to-alls and
   the gradient reduction, peak memory and bytes staged through host
   memory: ranks time-slicing one card over gloo, no measure of sequence
   parallelism's speed. (c) Each leg again in the same two ranks at
   ``{"tensor": 2}`` (the model given on the meta device: each rank draws
   its 16 heads, 5504 FFN columns and 16000 vocab rows a block at a time),
   held against the same seq-1 run (the tensor-1 reference) by the same
   bounds; then the fp32 leg with ``tensor_parallel.overlap`` on, its
   losses within 1e-5 relative of the overlap-off run's. Each rank's K4
   launches exactly as in (b) and equal; the replicated parameters (the
   norms, compute and master) bit-identical on both ranks; the ring
   counters exact: none off, 2 a layer a forward on (remat's second
   forward included; 4096 rows divide 2), no fallback. Prints per rank
   the step times and the host seconds inside the Megatron all-reduces;
   the kernels line adds each tensor rank's own counts. Work goes under
   ``seq.tmp/`` and is removed.

The serving parity phase's dense oracles pass ``attn_impl="xla"``, so they
stay independent of the kernels under test.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import sys
import time

import torch

#: H100 SXM peaks (NVIDIA data sheet; dense, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
            torch.float8_e4m3fn: 1979e12}

ALL_PHASES = ("build", "kernel", "parity", "serve", "serve-profile",
              "train-parity", "train", "moe-train-parity", "moe-train", "zero",
              "sparse", "offload", "kvmove", "observe", "fleet", "tp", "seq")
#: the run with no ``--phases``: every path; the serve phase's profiling
#: pass (a record of where a window's device time goes, not a path) runs
#: only when named
DEFAULT_PHASES = tuple(p for p in ALL_PHASES if p != "serve-profile")

#: spread of the K1 cases' q against unit-normal K/V (see k1_case)
Q_SD = 3.0
#: K1 against its plain version: fp32 by absolute error; bf16 by the max
#: absolute error over max |plain|, since p and the output round to bf16
K1_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
#: K1's e4m3 form against its plain version: (max |error| / max |plain|,
#: mean |error| / mean |plain|). Both round p to e4m3 against the same
#: running max, but a p within fp32 noise of a rounding boundary (the two
#: order their sums and exps differently) may round one e4m3 step (12.5%)
#: apart, so the max allows one bf16 ulp of the largest output or such a
#: step, and the mean bounds how often it happens. Measured on the H100:
#: max 6.6e-7 (fp32) and 2.0e-3 (bf16), mean at most 5.7e-7
K1_E4M3_TOL = {torch.float32: (1e-2, 1e-5), torch.bfloat16: (1e-2, 1e-4)}
#: K2 against its plain version, max |error| over max |plain|: fp32 sums
#: over K in another order; bf16 outputs may round one ulp (<= 2^-7 of the
#: largest) apart
K2_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
#: weight shapes (K, N) on K2's path: llama2-7b's, and qwen2-moe-a2.7b's
#: attention projection and unembedding (N = 1187 x 128)
K2_SHAPES = {"wq": (4096, 4096), "w_gate": (4096, 11008),
             "w_down": (11008, 4096), "unembed": (4096, 32000),
             "qwen2-moe/wq": (2048, 2048),
             "qwen2-moe/unembed": (2048, 151936)}
#: K2's stacked case: (layers, K, N, the layer selected)
K2_STACKED = (4, 4096, 4096, 2)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3,
                 graph: bool = True) -> float:
    """Mean device time of ``fn()`` in ms: ``warmup`` calls, then ``iters``
    calls captured in one CUDA graph and replayed between two CUDA events.
    A replay issues the launches without the host's per-call cost, so a
    kernel shorter than its wrapper's host time (a decode-shaped K2 call)
    is timed by the device, not by how fast the host can issue it.
    ``graph=False`` times ``iters`` calls between two events without a
    graph, for a function that reads values back to the host (the grouped
    products' plain versions)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not graph:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# rank pools, shared by the phases that run ranks
# ---------------------------------------------------------------------------

#: where the pools' ``file://`` stores live (inside the checkout; removed)
POOL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "pools.tmp")
#: world size -> (``RankPool``, the thread running its warm-up, its error)
_POOLS: dict = {}


def warm_rank() -> None:
    """A pool's first task: the compiler stack that
    ``torch.utils.checkpoint`` imports at its first call (seconds a
    process), so that no timed step of a rank pays it."""
    import torch._dynamo  # noqa: F401


def start_pools(worlds) -> None:
    """Start a ``RankPool`` of each size in ``worlds`` now, its processes
    importing and warming up (:func:`warm_rank`) while this process runs
    other phases. zero's CPU ranks, the tp phase and the seq phase then
    share them, each task setting up its own mesh, as the CPU tests' pools
    run one case after another."""
    import threading

    from deepspeed_tpu_torch.comm.spawn import RankPool

    if not _POOLS:
        shutil.rmtree(POOL_DIR, ignore_errors=True)   # a stale store hangs
    for n in worlds:
        if n in _POOLS:
            continue
        os.makedirs(POOL_DIR, exist_ok=True)
        pool = RankPool(n, os.path.join(POOL_DIR, f"store{n}"))
        entry = [pool, None, None]

        def warm(entry=entry):
            try:
                entry[0].run(warm_rank, timeout=600)
            except BaseException as e:       # raised where the pool is used
                entry[2] = e
        entry[1] = threading.Thread(target=warm, daemon=True)
        entry[1].start()
        _POOLS[n] = entry


def rank_pool(n: int):
    """The pool of ``n`` ranks (started now if :func:`start_pools` did
    not), once its warm-up has ended."""
    start_pools([n])
    pool, thread, _ = _POOLS[n]
    thread.join()
    err = _POOLS[n][2]
    if err is not None:
        raise RuntimeError(f"the pool of {n} ranks did not start") from err
    if not pool.procs:
        raise RuntimeError(f"the pool of {n} ranks was closed by a failed "
                           f"task")
    return pool


def close_pools(worlds=None) -> None:
    """Stop the pools of the sizes in ``worlds`` (default: all), and remove
    their stores once none is left."""
    for n in list(_POOLS if worlds is None else worlds):
        entry = _POOLS.pop(n, None)
        if entry is not None:
            entry[0].close()
            entry[1].join(timeout=30)
    if not _POOLS:
        shutil.rmtree(POOL_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def ptxas_entries(text: str) -> dict:
    """``{mangled entry: {"regs", "stack", "spill_stores", "spill_loads",
    "wgmma_serialized"}}`` from ``nvcc -Xptxas -v`` output (the last is
    True where ptxas says it serialized the entry's wgmma instructions)."""
    import re

    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"wgmma\.mma_async instructions are serialized.*"
                      r"function '(\S+?)'", line)
        if m:
            out.setdefault(m.group(1), {})["wgmma_serialized"] = True
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["regs"] = int(m.group(1))
    return out


def phase_build() -> dict:
    from deepspeed_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    built = kernels.build_all()
    wall = time.perf_counter() - t0
    for name, rec in built.items():
        log(f"[build] {name}: {rec['seconds']:.1f}s -> {rec['path']}")
        for line in rec["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all kernels in {wall:.1f}s")
    return built


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def k1_case(name, *, H, KV, D, bs, T, Ts, ctx, dtype, dev, seed,
            window=False, nb=256, L=2, e4m3=False, sliding=None,
            ring_pages=None):
    """Inputs for one K1 case: ``ctx`` lists each slot's pool context
    (positions below stage_starts), -1 for an empty slot. Each live slot's
    stage holds its fresh rows: a ragged prefill chunk, the one decode
    token, or (``window``) 1-8 rows of a decode window whose query is the
    last of them. ``e4m3`` casts the pool to e4m3 codes. ``sliding`` adds a
    sliding window of that many keys; ``ring_pages`` makes each table a
    rolling ring of that many pages (``ring_tokens`` = pages x bs)."""
    from deepspeed_tpu_torch.ops.quant_matmul import to_e4m3

    g = torch.Generator(device=dev).manual_seed(seed)
    S = len(ctx)

    def rnd(*shape, sd=1.0):
        return (torch.randn(shape, generator=g, device=dev) * sd).to(dtype)

    pool = rnd(L, 2, KV, nb, bs, D)
    if e4m3:
        pool = to_e4m3(pool)
    # q at 3x the keys' spread: the scaled scores spread by about 3 units,
    # so the softmax is peaked and a wrong score moves the output
    q = rnd(S, T, H, D, sd=Q_SD)
    ks, vs = rnd(S, KV, Ts, D), rnd(S, KV, Ts, D)
    max_pages = ring_pages or max(-(-(c + Ts) // bs) for c in ctx) + 2
    tables = torch.zeros(S, max_pages, dtype=torch.int32)   # trash-padded
    lens, qst, sst = [], [], []
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    used = 0
    for s, c in enumerate(ctx):
        if c < 0:                                  # empty slot
            lens.append(0), qst.append(0), sst.append(0)
            continue
        n_pages = ring_pages or -(-(c + Ts) // bs)
        tables[s, :n_pages] = perm[used:used + n_pages].to(torch.int32)
        used += n_pages
        if window:
            # window stage: rows 0..w-1 filled, the query is the last one
            w = 1 + (s % Ts)
            lens.append(c + w), qst.append(c + w - 1), sst.append(c)
        else:
            n = T - (s % 3) * (T // 4) if T > 1 else 1   # ragged chunks
            lens.append(c + n), qst.append(c), sst.append(c)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return dict(name=name, q=q, pool=pool, k_stage=ks, v_stage=vs,
                block_tables=tables.to(dev), seq_lens=i32(lens),
                q_starts=i32(qst), stage_starts=i32(sst), block_size=bs,
                layer_index=L - 1, window=sliding,
                ring_tokens=ring_pages * bs if ring_pages else None)


#: the verify trees of the K1 tree cases: a root with two children, each
#: with two, then a chain — 8 nodes, depth 3 (the engine's spec_max_nodes)
TREE_PARENTS = (-1, 0, 0, 1, 1, 2, 3, 6)


def k1_tree_case(name, *, ctx, dtype, dev, seed, e4m3, **geom):
    """Tree verify over ``ctx`` committed tokens per slot (-1: empty): the
    8 nodes of ``TREE_PARENTS`` at positions root + depth, the ancestors
    mask, seq_lens = root + 1 + max depth (the engine's)."""
    T = len(TREE_PARENTS)
    case = k1_case(name, bs=64, T=T, Ts=T, ctx=ctx, dtype=dtype, dev=dev,
                   seed=seed, e4m3=e4m3, **geom)
    depth = [0] * T
    for i, p in enumerate(TREE_PARENTS):
        if p >= 0:
            depth[i] = depth[p] + 1
    S = len(ctx)
    pos = torch.zeros(S, T, dtype=torch.int32)
    mask = torch.zeros(S, T, T, dtype=torch.uint8)
    lens = torch.zeros(S, dtype=torch.int32)
    for s, c in enumerate(ctx):
        mask[s] = torch.eye(T, dtype=torch.uint8)
        if c < 0:
            continue
        pos[s] = torch.tensor([c + d for d in depth])
        for i in range(T):
            j = i
            while j >= 0:
                mask[s, i, j] = 1
                j = TREE_PARENTS[j]
        lens[s] = c + 1 + max(depth)
    case.update(seq_lens=lens.to(dev), q_starts=pos[:, 0].contiguous().to(
        dev), tree_positions=pos.to(dev), tree_mask=mask.to(dev))
    return case


def k1_options(case) -> dict:
    """The K1 options a case carries (window, ring, tree inputs)."""
    return {k: case[k] for k in ("window", "ring_tokens", "tree_positions",
                                 "tree_mask") if case.get(k) is not None}


def k1_visibility(case):
    """(key positions [S, C], visibility [S, T, C]) of the case's pool
    columns then stage rows: the plain version's own rule."""
    from deepspeed_tpu_torch.ops.paged_attention import key_visibility

    q = case["q"]
    cpos, _, mask = key_visibility(
        case["block_tables"], case["seq_lens"], case["q_starts"],
        case["stage_starts"], T=q.shape[1], Ts=case["k_stage"].shape[2],
        block_size=case["block_size"], **k1_options(case))
    # a slot with seq_lens 0 is empty: the kernel reads nothing for it
    return cpos, mask & (case["seq_lens"] > 0)[:, None, None]


def k1_work(case) -> tuple[float, float, float]:
    """(bytes, operations, seconds the operations need at the card's peak)
    on this case's data: q and the output once, and each K/V row that some
    query row of its slot sees (pool and stage; inside the window or ring)
    once per KV head; two multiply-adds per visible (query, key) pair and
    head dim element, the pool's at the e4m3 rate for an e4m3 pool."""
    q, pool = case["q"], case["pool"]
    S, T, H, D = q.shape
    KV = pool.shape[2]
    G = H // KV
    ctx = case["block_tables"].shape[1] * case["block_size"]
    el, pel = q.element_size(), pool.element_size()
    _, mask = k1_visibility(case)
    seen = mask.any(dim=1)                                   # [S, C]
    pool_keys = int(seen[:, :ctx].sum())
    stage_keys = int(seen[:, ctx:].sum())
    nbytes = 2 * q.numel() * el + 2 * KV * D * (pool_keys * pel
                                                + stage_keys * el)
    pairs_pool = int(mask[:, :, :ctx].sum()) * G * KV
    pairs_stage = int(mask[:, :, ctx:].sum()) * G * KV
    ops = 4.0 * D * (pairs_pool + pairs_stage)
    secs = 4.0 * D * (pairs_pool / PEAK_OPS[pool.dtype]
                      + pairs_stage / PEAK_OPS[q.dtype])
    return float(nbytes), ops, secs


def k1_library_call(case):
    """One scaled_dot_product_attention call over the case's K/V gathered
    dense (every pool column in table order, then the stage; an e4m3 pool
    upcast to q's dtype) with an explicit boolean mask of who sees what,
    timed as a yardstick beside the kernel."""
    import torch.nn.functional as F

    q, pool = case["q"], case["pool"].to(case["q"].dtype)
    S, T, H, D = q.shape
    KV, bs = pool.shape[2], case["block_size"]
    G = H // KV
    tables = case["block_tables"].long()
    ctx = tables.shape[1] * bs
    li = case["layer_index"]
    blocks = tables.repeat_interleave(bs, dim=1)
    offs = torch.arange(ctx, device=q.device) % bs
    k = torch.cat([pool[li, 0][:, blocks, offs[None]].permute(1, 0, 2, 3),
                   case["k_stage"]], dim=2).repeat_interleave(G, dim=1)
    v = torch.cat([pool[li, 1][:, blocks, offs[None]].permute(1, 0, 2, 3),
                   case["v_stage"]], dim=2).repeat_interleave(G, dim=1)
    _, mask = k1_visibility(case)
    mask = mask[:, None]                                  # [S, 1, T, C]
    qh = q.permute(0, 2, 1, 3)
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def bound_of(nbytes: float, ops_seconds: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_seconds * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_run_case(case, form: str, plain_graph: bool = True) -> dict:
    """Hold one K1 case against the plain version and time it. The call is
    launched twice and must give the same bits both times; each launch must
    be counted for its pool, ``form`` ("default", or the option it takes:
    "window", "ring", "tree") and, in bf16, the kernel that served it
    (``kernel_plan``: the chunk or the split kernel), with no plain launch;
    empty slots must be zeros; live slots are judged by the tolerances
    above (fp32 by max |error|, bf16 over max |plain|, an e4m3 pool also by
    mean |error| over mean |plain|, p rounded against the kernel's walk:
    64-key tiles and, for the split kernel, its splits). Then the kernel,
    the plain version (without a CUDA graph where its temporaries are
    large) and the SDPA yardstick are timed. Returns the record; raises
    past the tolerance."""
    from deepspeed_tpu_torch.ops.paged_attention import (
        KERNEL_KEY_TILE, counts, kernel_plan, paged_ragged_attention,
        paged_ragged_attention_reference)

    label, dtype = case["name"], case["q"].dtype
    e4m3 = case["pool"].dtype == torch.float8_e4m3fn
    args = [case[k] for k in ("q", "pool", "k_stage", "v_stage",
                              "block_tables", "seq_lens", "q_starts",
                              "stage_starts")]
    kw = dict(block_size=case["block_size"], layer_index=case["layer_index"],
              **k1_options(case))
    width = case["block_tables"].shape[1] * case["block_size"]
    route, split_cols = kernel_plan(case["q"], case["pool"].shape[2],
                                    case["block_tables"].shape[1],
                                    case["block_size"])
    splits = -(-width // split_cols) + 1 if split_cols else 0
    ref_kw = dict(kw, p_round_blocks=(KERNEL_KEY_TILE, KERNEL_KEY_TILE),
                  p_round_splits=split_cols or None)
    before = dict(vars(counts))
    got = paged_ragged_attention(*args, **kw)
    again = paged_ragged_attention(*args, **kw)
    torch.cuda.synchronize()
    bumped = {k: v - before[k] for k, v in vars(counts).items()
              if v != before[k]}
    want = {"kernel_e4m3" if e4m3 else "kernel": 2}
    if form != "default":
        want[f"kernel_{form}"] = 2
    if form == "ring":
        want["kernel_window"] = 2            # a ring runs with its window
    if route != "fma":
        want[f"kernel_{route}"] = 2
    if bumped != want:
        raise AssertionError(f"K1 {label}: counted {bumped}, not {want}")
    if not torch.equal(got, again):
        raise AssertionError(f"K1 {label}: a second launch gave other bits")
    ref = paged_ragged_attention_reference(*args, **ref_kw)
    live = case["seq_lens"] > 0
    if (~live).any() and got[~live].abs().max().item() != 0.0:
        raise AssertionError(f"{label}: empty slot not 0")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite output")
    diff = (got[live].float() - ref[live].float()).abs()
    err = diff.max().item()
    max_ref = ref[live].float().abs().max().item()
    judged_mean, tol_mean = None, None
    if e4m3:
        judged = err / max_ref
        judged_mean = (diff.mean() / ref[live].float().abs().mean()).item()
        tol, tol_mean = K1_E4M3_TOL[dtype]
        ok = judged <= tol and judged_mean <= tol_mean
    else:
        judged = err if dtype == torch.float32 else err / max_ref
        tol = K1_TOL[dtype]
        ok = judged <= tol
    if not ok:
        raise AssertionError(
            f"K1 {label} {dtype}: kernel against plain error {judged:.3e} "
            f"(tol {tol:.0e}), mean {judged_mean} (tol {tol_mean}); max abs "
            f"{err:.3e}")
    ms = cuda_time_ms(lambda: paged_ragged_attention(*args, **kw))
    plain_ms = cuda_time_ms(
        lambda: paged_ragged_attention_reference(*args, **ref_kw),
        iters=3 if plain_graph else 2, warmup=1, graph=plain_graph)
    lib_ms = cuda_time_ms(k1_library_call(case), iters=5, warmup=1)
    nbytes, ops, ops_s = k1_work(case)
    bound, by = bound_of(nbytes, ops_s)
    pool = "e4m3" if e4m3 else ("fp32" if dtype == torch.float32 else "bf16")
    rec = dict(case=label, form=form, pool=pool,
               dtype=str(dtype).replace("torch.", ""), kernel=route,
               splits=splits, max_abs_err=err,
               judged_err=judged, judged_mean_err=judged_mean,
               max_abs_ref=max_ref, tol=tol, tol_mean=tol_mean, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
               bound_by=by, bytes=nbytes, ops=ops,
               tflops=ops / ms * 1e-9, gb_s=nbytes / ms * 1e-6,
               bound_share=bound / ms)
    mean_txt = (f", mean {judged_mean:.2e} (tol {tol_mean:.0e})"
                if e4m3 else "")
    log(f"[kernel] K1 {label:<42} {rec['dtype']:<8} "
        f"[{route_text(route, splits)}] err {judged:.2e} (tol "
        f"{tol:.0e}{mean_txt}; max abs {err:.2e} of max |plain| "
        f"{max_ref:.2f})  kernel {ms:.4f} ms ({rec['tflops']:.1f} TFLOP/s, "
        f"{rec['gb_s']:.0f} GB/s, {rec['bound_share']:.1%} of bound)  plain "
        f"{plain_ms:.3f} ms  sdpa {lib_ms:.3f} ms  bound {bound:.4f} ms "
        f"({by})")
    return rec


def route_text(route: str, splits: int) -> str:
    """Which K1/K7 kernel served a case: the chunk kernel, the split kernel
    with its split count, or the fp32 FMA kernel."""
    return {"chunk": "chunk", "fma": "fp32 FMA"}.get(
        route, f"split x{splits}")


#: the bf16 K1 / K7 kernels, by kernel and C entry: (label, name in the
#: mangled entry, which for ``ds_paged_attention_smem``: 0 chunk, 1 split)
K1_TC_KERNELS = (("K1 chunk", "ragged_paged_attn_chunk_kernel", 0),
                 ("K1 split", "ragged_paged_attn_split_kernel", 1),
                 ("K1 merge", "ragged_paged_attn_merge_kernel", None),
                 ("K7 chunk", "paged_attn_kernel_chunk", 0),
                 ("K7 split", "paged_attn_kernel_split", 1),
                 ("K7 merge", "paged_attn_kernel_merge", None))


def k1_resources(built: dict) -> list:
    """The bf16 K1 / K7 kernels' registers, stack, spills and any wgmma
    serialization (ptxas's C7520 note) from the build's ``-Xptxas -v``
    output, and their dynamic shared memory. The register count is the
    launch's; the chunk kernel's consumer warpgroups raise theirs with
    setmaxnreg."""
    import re

    from deepspeed_tpu_torch.ops import kernels

    lib = kernels.load("paged_attention")
    entries = ptxas_entries(built.get("paged_attention", {}).get("ptxas", ""))
    rows = []
    for label, kern, which in K1_TC_KERNELS:
        for name, v in sorted(entries.items()):
            if kern not in name:
                continue
            d = re.search(r"ILi(\d+)E", name)
            fp8 = "ELb1E" in name
            D = int(d.group(1)) if d else None
            smem = (lib.ds_paged_attention_smem(which, D, int(fp8))
                    if which is not None and D else 0)
            row = dict(kernel=f"{label}<D {D}{', e4m3 pool' if fp8 else ''}>"
                       if D else label, smem_bytes=smem, **v)
            row.setdefault("wgmma_serialized", False)
            rows.append(row)
            log(f"[kernel] {row['kernel']:<28} registers "
                f"{row.get('regs', 'not reported')}, stack "
                f"{row.get('stack', '-')} B, spills "
                f"{row.get('spill_stores', '-')} / "
                f"{row.get('spill_loads', '-')} B, shared memory "
                f"{row['smem_bytes']} B, wgmma serialized "
                f"{row['wgmma_serialized']}")
    if not rows:
        log("[kernel] K1 / K7 ptxas report: not reported (library built "
            "before this run)")
    return rows


def k1_host_cost(dev) -> dict:
    """The host's cost per K1 call (µs, ``host_us_per_call``) by kernel:
    the split kernel (a llama2-7b decode-window step: the split plan, the
    scratch and two launches), the chunk kernel (a llama2-7b 4 x 256
    prefill chunk: three cached tensor maps) and, beside them, the fp32
    FMA kernel on the decode case — the wrapper path every bf16 call took
    before (one launch, no scratch, no maps)."""
    from deepspeed_tpu_torch.ops.paged_attention import paged_ragged_attention

    llama = dict(H=32, KV=32, D=128, bs=64)
    decode = dict(T=1, Ts=8, window=True,
                  ctx=[259, 400, 515, 614, 703, 836, 1025, -1])
    out = {}
    for label, dtype, shape in (
            ("split", torch.bfloat16, decode),
            ("chunk", torch.bfloat16, dict(T=256, Ts=256,
                                           ctx=[0, 192, 320, 768])),
            ("fp32 FMA", torch.float32, decode)):
        case = k1_case(f"host/{label}", dtype=dtype, dev=dev, seed=77,
                       **llama, **shape)
        args = [case[k] for k in ("q", "pool", "k_stage", "v_stage",
                                  "block_tables", "seq_lens", "q_starts",
                                  "stage_starts")]
        kw = dict(block_size=case["block_size"],
                  layer_index=case["layer_index"], **k1_options(case))
        out[label] = host_us_per_call(
            lambda: paged_ragged_attention(*args, **kw), n=200)
        del case, args
    log(f"[kernel] K1 host cost per call: split kernel {out['split']:.1f} "
        f"us, chunk kernel {out['chunk']:.1f} us, fp32 FMA kernel (the "
        f"one-launch path) {out['fp32 FMA']:.1f} us")
    return {"case": "K1 host cost per call (us)", **out}


def k1_summary(results, main_case: str) -> dict:
    """The record line's fields for a group of K1 cases: the worst errors
    in bf16 and fp32, and the times of ``main_case`` in bf16."""
    bf = [r for r in results if r["dtype"] == "bfloat16"]
    main = next(r for r in bf if r["case"] == main_case)
    return dict(max_abs_err=max(r["max_abs_err"] for r in bf),
                max_err_over_max_ref=max(r["judged_err"] for r in bf),
                max_abs_err_fp32=max(r["max_abs_err"] for r in results
                                     if r["dtype"] == "float32"),
                **{k: main[k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by")})


def phase_k1(dev) -> tuple[dict, dict, list]:
    """K1 in its default form and its e4m3-pool form against the plain
    version. Returns (default-form summary, e4m3-form summary, cases)."""
    from deepspeed_tpu_torch.ops.paged_attention import counts

    # the serving path's shapes (phase 4): 8 slots of ~256-1100 context,
    # one empty; prefill chunks of 256 over several 64-token pages
    decode_ctx = [256, 397, 512, 611, 700, 833, 1022, -1]
    chunk_ctx = [0, 192, 320, 768]
    geoms = {"llama2-7b": dict(H=32, KV=32, D=128),
             "gqa-32q/8kv": dict(H=32, KV=8, D=128),
             "qwen2-moe": dict(H=16, KV=16, D=128)}
    shapes = {"decode": dict(T=1, Ts=8, ctx=decode_ctx),
              "window": dict(T=1, Ts=8, window=True,
                             ctx=[c + 3 if c >= 0 else c
                                  for c in decode_ctx]),
              "prefill256": dict(T=256, Ts=256, ctx=chunk_ctx)}
    plan = [(dt, g, s, False) for dt in (torch.float32, torch.bfloat16)
            for g in geoms for s in shapes]
    plan += [(dt, "llama2-7b", s, True) for dt in (torch.float32,
                                                    torch.bfloat16)
             for s in shapes]
    results = []
    for seed, (dtype, gname, sname, e4m3) in enumerate(plan, start=1):
        label = f"{gname}/{sname}" + ("/e4m3-pool" if e4m3 else "")
        case = k1_case(label, bs=64, dtype=dtype, dev=dev, seed=seed,
                       e4m3=e4m3, **geoms[gname], **shapes[sname])
        results.append(k1_run_case(case, "default"))
        del case
    counts.reset()
    # each pool at the serving path's most frequent shape: a bf16
    # decode-window step of llama2-7b geometry
    main = "llama2-7b/window"
    return (k1_summary([r for r in results if r["pool"] != "e4m3"], main),
            k1_summary([r for r in results if r["pool"] == "e4m3"],
                       main + "/e4m3-pool"), results)


#: mistral-7b's attention geometry and its window; the serve phase's ring
#: (block 64, chunk 256, decode window 8): ceil((4096 + 256) / 64) + 1
MISTRAL = dict(H=32, KV=8, D=128)
MISTRAL_WINDOW, MISTRAL_RING_PAGES = 4096, 69


def phase_k1_forms(dev) -> tuple[dict, list]:
    """K1's sliding-window, rolling-ring and tree-verify forms against the
    plain version, in fp32, bf16 and over an e4m3 pool (the tolerances of
    phase_k1, judged on live slots). Returns ({form: summary}, cases)."""
    from deepspeed_tpu_torch.ops.paged_attention import counts

    # ~6000-token contexts: past the 4096-key window and past the 4416-token
    # ring (wrapped), as the mistral serve's long prompts reach them
    decode_ctx = [5800, 5905, 6000, 6100, 5999, 6050, 5877, -1]
    chunk_ctx = [5632, 5760, 5888, 6016]
    tree_ctx = [256, 397, 512, 611, 700, 833, 1022, -1]
    shapes = {"decode": dict(T=1, Ts=8, window=True, ctx=decode_ctx),
              "prefill256": dict(T=256, Ts=256, ctx=chunk_ctx)}
    plan = []
    for pool in ("fp32", "bf16", "e4m3"):
        for sname in shapes:
            plan.append(("window", "mistral-7b", sname, pool))
            plan.append(("ring", "mistral-7b", sname, pool))
        for gname in ("llama2-7b", "mistral-7b"):
            plan.append(("tree", gname, "verify-T8", pool))
    geoms = {"llama2-7b": dict(H=32, KV=32, D=128), "mistral-7b": MISTRAL}
    results = []
    for seed, (form, gname, sname, pool) in enumerate(plan, start=900):
        dtype = torch.float32 if pool == "fp32" else torch.bfloat16
        e4m3 = pool == "e4m3"
        label = f"{gname}/{form}-{sname}" + ("/e4m3-pool" if e4m3 else "")
        if form == "tree":
            case = k1_tree_case(label, ctx=tree_ctx, dtype=dtype, dev=dev,
                                seed=seed, e4m3=e4m3, **geoms[gname])
        else:
            ring = MISTRAL_RING_PAGES if form == "ring" else None
            sh = shapes[sname]
            nb = len(sh["ctx"]) * (ring or -(-(max(sh["ctx"]) + sh["Ts"])
                                              // 64) + 2) + 1
            case = k1_case(label, bs=64, dtype=dtype, dev=dev, seed=seed,
                           e4m3=e4m3, nb=nb, sliding=MISTRAL_WINDOW,
                           ring_pages=ring, **geoms[gname], **sh)
        # the plain version's temporaries over ~6500 keys are large: timed
        # without a graph
        results.append(k1_run_case(case, form, plain_graph=False))
        del case
        free_cuda()
    counts.reset()

    def summary(form, main_case):
        rs = [r for r in results if r["form"] == form]
        return dict(k1_summary([r for r in rs if r["pool"] != "e4m3"],
                               main_case),
                    max_err_over_max_ref_e4m3=max(
                        r["judged_err"] for r in rs if r["pool"] == "e4m3"))

    # each form at the serving path's most frequent shape: a bf16 decode
    # step of mistral-7b, a bf16 verify of llama2-7b
    return {"window": summary("window", "mistral-7b/window-decode"),
            "ring": summary("ring", "mistral-7b/ring-decode"),
            "tree": summary("tree", "llama2-7b/tree-verify-T8")}, results


#: the tp phase's per-rank shapes. K1: each leg's heads on one rank
#: (llama2-7b at TP 2, qwen2-moe-a2.7b at TP 2, mistral-7b at TP 4: G 4 on
#: its sliding-window ring). K2: the per-shard weights (llama2-7b's w_gate
#: columns at TP 2 / 4 — 43 x 128 and 21.5 x 128, the last padded — its
#: w_down rows, where int8's default group of 512 resolves to 128 / 64 on
#: the shard, the TP-4 unembedding's 8000 columns; qwen2-moe's wq at TP 2).
#: K3: qwen2-moe's expert FFN width 1408 split in two (704 = 5.5 x 128).
TP_K1_GEOMS = {"llama2-7b/tp2": dict(H=16, KV=16, D=128),
               "qwen2-moe/tp2": dict(H=8, KV=8, D=128),
               "mistral-7b/tp4": dict(H=8, KV=2, D=128)}
TP_K2_SHAPES = {"llama2/tp2/w_gate": (4096, 5504),
                "llama2/tp2/w_down": (5504, 4096),
                "llama2/tp4/w_gate": (4096, 2752),
                "llama2/tp4/w_down": (2752, 4096),
                "llama2/tp4/unembed": (4096, 8000),
                "qwen2-moe/tp2/wq": (2048, 1024)}
#: K2's shards with a padded last column block or a group under 128: every
#: code format there, int8 on the rest
TP_K2_RAGGED = ("llama2/tp4/w_gate", "llama2/tp4/w_down")
TP_K3_SHAPES = (("qwen2-moe/tp2/w_gate", 60, 2048, 704, 4, 2048),
                ("qwen2-moe/tp2/w_down", 60, 704, 2048, 4, 2048))


def phase_tp_shards(dev) -> list:
    """K1, K2 and K3 at the per-rank shapes of the tp phase against their
    plain versions, with the kernel phase's tolerances, times and bounds
    (``TP_K1_GEOMS``, ``TP_K2_SHAPES``, ``TP_K3_SHAPES``); K2 / K3 codes
    quantized per shard as the engine does. Returns the cases."""
    from deepspeed_tpu_torch.ops.paged_attention import counts
    from deepspeed_tpu_torch.ops.quant_matmul import (
        counts as qcounts, grouped_counts, quantize_grouped,
        quantize_weight)

    cases = []
    decode_ctx = [256, 397, 512, 611, 700, 833, 1022, -1]
    shapes = {"window": dict(T=1, Ts=8, window=True,
                             ctx=[c + 3 if c >= 0 else c
                                  for c in decode_ctx]),
              "prefill256": dict(T=256, Ts=256, ctx=[0, 192, 320, 768])}
    seed = 1300
    for gname, geom in TP_K1_GEOMS.items():
        mistral = gname.startswith("mistral")
        pools = ("fp32",) if mistral else ("bf16",) + (
            ("e4m3",) if gname.startswith("llama2") else ())
        for pool in pools:
            for sname, sh in shapes.items():
                seed += 1
                dtype = torch.float32 if pool == "fp32" else torch.bfloat16
                label = f"{gname}/{sname}" + ("/e4m3-pool" if pool == "e4m3"
                                              else "")
                kw = dict(bs=64, dtype=dtype, dev=dev, seed=seed,
                          e4m3=pool == "e4m3", **geom, **sh)
                if mistral:
                    # the leg's rolling ring under the 4096-key window
                    kw.update(sliding=MISTRAL_WINDOW,
                              ring_pages=MISTRAL_RING_PAGES,
                              nb=len(sh["ctx"]) * MISTRAL_RING_PAGES + 1)
                case = k1_case(label, **kw)
                cases.append(k1_run_case(case, "ring" if mistral
                                         else "default", plain_graph=False))
                del case
                free_cuda()
    counts.reset()
    for bits in (8, 4, "fp8"):
        for wname, (K, N) in TP_K2_SHAPES.items():
            # int4 and e4m3 at the shards whose N or group is ragged
            if bits != 8 and wname not in TP_K2_RAGGED:
                continue
            seed += 1
            qw = quantize_weight(k2_weight(K, N, dev, seed), bits=bits,
                                 shard=True)
            for M in (8, 256):
                x = torch.randn(M, K, device=dev,
                                generator=torch.Generator(
                                    device=dev).manual_seed(seed + M))
                k2_run(dev, cases, f"{bits}/{wname}/M={M}",
                       x.to(torch.bfloat16), qw)
                if bits == 8 and M == 8:
                    k2_run(dev, cases, f"{bits}/{wname}/M={M}", x, qw)
            del qw
            free_cuda()
    qcounts.reset()
    for label, n, K, N, k, T_pre in TP_K3_SHAPES:
        seed += 10
        g = torch.Generator(device=dev).manual_seed(seed)
        w32 = torch.randn(n, K, N, generator=g, device=dev) / K ** 0.5
        w_bf16 = w32.to(torch.bfloat16)
        for bits in (8, 4, "fp8"):
            qw = quantize_grouped(w32, bits=bits, shard=True)
            # every format at decode, int8 at prefill too
            for i, (phase, T) in enumerate((("decode", DECODE_TOKENS),
                                             ("prefill", T_pre))[
                                                 :2 if bits == 8 else 1]):
                buf, srt, cnt = grouped_case(T, k, n, K, K3_BLOCK_M,
                                             torch.bfloat16, dev, seed + i)
                k3_run(dev, cases, f"{bits}/{label}/{phase}/T={T}x{k}",
                       buf, srt, cnt, qw, w_bf16)
                del buf, srt
            del qw
            free_cuda()
        del w32, w_bf16
    grouped_counts.reset()
    return cases


def k2_weight(K, N, dev, seed) -> torch.Tensor:
    """A [K, N] fp32 weight whose quantization is not trivial: unit-normal
    entries scaled by e^U(-2,2) per row and e^U(-1,1) per column, so every
    K-group and column takes its own scale."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(K, N, generator=g, device=dev)
    w *= torch.empty(K, 1, device=dev).uniform_(-2, 2, generator=g).exp_()
    w *= torch.empty(1, N, device=dev).uniform_(-1, 1, generator=g).exp_()
    return w


def k2_bound(M, K, N, qw, dtype) -> tuple[float, str, float]:
    """(bound ms, what bounds it, bytes): codes K*N*bits/8, scales, x and
    the output moved once; 2*M*K*N operations at the compute dtype's
    peak."""
    Np = qw.data.shape[-1]
    bits = {8: 8, 4: 4, "fp8": 8}[qw.bits]
    el = torch.empty((), dtype=dtype).element_size()
    nbytes = (K * Np * bits / 8 + (K // qw.group_size) * Np * 4
              + M * K * el + M * N * el)
    bound, by = bound_of(nbytes, 2.0 * M * K * N / PEAK_OPS[dtype])
    return bound, by, nbytes


def k2_route(M, K, qw, dtype, dev) -> str:
    """The kernels a K2 call takes: on the wgmma route its token columns
    and K split (``tc_split``)."""
    from deepspeed_tpu_torch.ops import quant_matmul as qm

    route = qm.kernel_route(dtype, qw.bits)
    if route != "wgmma":
        return route
    bn, splits = qm.tc_split(M, K, qw.data.shape[-1], qm._sm_count(
        dev.index if dev.index is not None else 0))
    return f"wgmma BN {bn}" + (f" x{splits} splits" if splits > 1 else "")


def launch_twice(tag, fn, counts, wgmma: bool):
    """``fn()`` launched twice: the route's count moves by one a launch
    (``kernel_tc`` exactly when the call is on the wgmma route), and the
    second launch gives the first one's bits. Returns the first output."""
    before = (counts.kernel, counts.kernel_tc)
    got = fn()
    torch.cuda.synchronize()
    if (counts.kernel, counts.kernel_tc) != (before[0] + 1,
                                             before[1] + wgmma):
        raise AssertionError(f"{tag}: launch counts {before} -> "
                             f"{(counts.kernel, counts.kernel_tc)}")
    again = fn()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{tag}: a second launch gave other bits")
    return got


def k2_one_hot(dev, seed: int) -> list:
    """Rows of x that are one-hot pick weight rows: on the wgmma route each
    output row must equal the dequantized weight's row in bf16 bit for bit
    (the widening of the codes, exactly), for every code format, at a
    decode and a prefill shape."""
    from deepspeed_tpu_torch.ops.quant_matmul import (dequantize_weight,
                                                      quant_matmul,
                                                      quantize_weight)

    out = []
    K, N = K2_SHAPES["w_gate"]
    for bits in (8, 4, "fp8"):
        qw = quantize_weight(k2_weight(K, N, dev, seed).to(torch.bfloat16),
                             bits=bits)
        w = dequantize_weight(qw)
        for M in (16, 256):
            g = torch.Generator(device=dev).manual_seed(seed + M)
            ks = torch.randperm(K, generator=g, device=dev)[:M]
            x = torch.zeros(M, K, device=dev, dtype=torch.bfloat16)
            x[torch.arange(M, device=dev), ks] = 1
            got = quant_matmul(x, qw)
            torch.cuda.synchronize()
            if not torch.equal(got, w[ks]):
                raise AssertionError(f"K2 one-hot {bits} M={M}: rows differ "
                                     f"from the dequantized weight")
            out.append({"case": f"one-hot {bits}/w_gate/M={M}",
                        "bit_exact": True})
            log(f"[kernel] K2 one-hot rows {bits}/w_gate/M={M}: bit for bit "
                f"the dequantized weight's rows")
        del qw, w
    return out


def k2_resources(built: dict) -> list:
    """The wgmma route's kernels (K2 ``qmm_tc_kernel``, K3
    ``qgmm_tc_kernel``, each per code format and token columns BN):
    registers, stack, spills and wgmma serialization from the build's
    ``-Xptxas -v`` output, dynamic shared memory and ring stages (at group
    512). From BN 128 the consumer warpgroups raise their registers to 240
    (setmaxnreg); the count here is the launch's."""
    import ctypes

    from deepspeed_tpu_torch.ops import kernels

    lib = kernels.load("quant_matmul")
    entries = ptxas_entries(built.get("quant_matmul", {}).get("ptxas", ""))
    rows = []
    for kern, bns in (("qmm_tc_kernel", (8, 16, 32, 64, 128, 256)),
                      ("qgmm_tc_kernel", (32, 64, 128, 256))):
        for fmt, fname in ((0, "int8"), (1, "int4"), (2, "e4m3")):
            for bn in bns:
                mangled = f"{kern}ILi{fmt}ELi{bn}E"
                found = [v for name, v in entries.items() if mangled in name]
                stages = ctypes.c_int(0)
                smem = lib.ds_quant_matmul_tc_smem(fmt, bn, 512,
                                                   ctypes.byref(stages))
                row = dict(kernel=f"{kern}<{fname}, {bn}>", smem_bytes=smem,
                           stages=stages.value, **(found[0] if found else {}))
                row.setdefault("wgmma_serialized", False)
                rows.append(row)
                log(f"[kernel] K2/K3 {row['kernel']:<28} registers "
                    f"{row.get('regs', 'not reported')}, stack "
                    f"{row.get('stack', '-')} B, spills "
                    f"{row.get('spill_stores', '-')} / "
                    f"{row.get('spill_loads', '-')} B, shared memory "
                    f"{smem} B ({stages.value} stages), wgmma serialized "
                    f"{row['wgmma_serialized']}")
    return rows


def k2_run(dev, results: list, label, x, qw, layer_index=None) -> None:
    """One K2 case against its plain version, timed beside the plain
    version, a dense bf16 matmul and the bound; appended to ``results``."""
    from deepspeed_tpu_torch.ops.quant_matmul import (
        counts, kernel_route, quant_matmul, quant_matmul_reference)

    M, K = x.shape
    N = qw.shape[1]
    dtype = x.dtype
    route = k2_route(M, K, qw, dtype, dev)
    got = launch_twice(f"K2 {label} {dtype}", lambda: quant_matmul(
        x, qw, layer_index=layer_index), counts,
        kernel_route(dtype, qw.bits) == "wgmma")
    ref = quant_matmul_reference(x, qw, layer_index=layer_index)
    if got.shape != (M, N) or not torch.isfinite(got).all():
        raise AssertionError(f"K2 {label}: shape {tuple(got.shape)} or "
                             f"non-finite output")
    err = (got.float() - ref.float()).abs().max().item()
    judged = err / ref.float().abs().max().item()
    if judged > K2_TOL[dtype]:
        raise AssertionError(f"K2 {label} {dtype}: kernel against plain "
                             f"error {judged:.3e} > {K2_TOL[dtype]:.0e} "
                             f"(max abs {err:.3e})")
    ms = cuda_time_ms(lambda: quant_matmul(x, qw,
                                           layer_index=layer_index))
    plain_ms = cuda_time_ms(
        lambda: quant_matmul_reference(x, qw, layer_index=layer_index),
        iters=3, warmup=1)
    dense = torch.randn(K, N, device=dev, dtype=torch.bfloat16)
    xb = x.to(torch.bfloat16)
    dense_ms = cuda_time_ms(lambda: torch.matmul(xb, dense))
    bound, by, nbytes = k2_bound(M, K, N, qw, dtype)
    rec = dict(case=label, bits=str(qw.bits), M=M, K=K, N=N,
               dtype=str(dtype).replace("torch.", ""), route=route,
               max_abs_err=err,
               judged_err=judged, tol=K2_TOL[dtype],
               max_abs_ref=ref.float().abs().max().item(), ms=ms,
               plain_ms=plain_ms, dense_bf16_matmul_ms=dense_ms,
               bound_ms=bound, bound_by=by, bytes=nbytes)
    results.append(rec)
    log(f"[kernel] K2 {label:<30} {rec['dtype']:<8} {route:<20} err "
        f"{judged:.2e} (tol {K2_TOL[dtype]:.0e}; max abs {err:.2e})  "
        f"kernel "
        f"{ms:.4f} ms  plain {plain_ms:.3f} ms  dense bf16 matmul "
        f"{dense_ms:.4f} ms  bound {bound:.4f} ms ({by})")
    del got, ref, dense


def phase_k2(dev) -> tuple[dict, list]:
    """K2 against its plain version. Returns (summary, cases)."""
    from deepspeed_tpu_torch.ops.quant_matmul import (
        QuantLinear, counts, quant_matmul, quantize_weight)

    results = []

    def run(label, x, qw, layer_index=None):
        k2_run(dev, results, label, x, qw, layer_index)

    seed = 100
    for bits in (8, 4, "fp8"):
        for wname, (K, N) in K2_SHAPES.items():
            seed += 1
            qw = quantize_weight(k2_weight(K, N, dev, seed), bits=bits)
            for M in (8, 256):
                g = torch.Generator(device=dev).manual_seed(seed + M)
                x = torch.randn(M, K, generator=g, device=dev)
                dtypes = (torch.bfloat16,) + (
                    (torch.float32,) if wname == "wq" else ())
                for dtype in dtypes:
                    run(f"{bits}/{wname}/M={M}", x.to(dtype), qw)
            del qw
            free_cuda()
        # stacked [L, K, N] codes: one layer selected inside the kernel
        L, K, N, li = K2_STACKED
        layers = [quantize_weight(k2_weight(K, N, dev, seed + 50 + i),
                                  bits=bits) for i in range(L)]
        st = QuantLinear(torch.stack([q.data for q in layers]),
                         torch.stack([q.scale for q in layers]), bits,
                         layers[0].group_size, layers[0].shape,
                         layers[0].dtype)
        for M in (8, 256):
            x = torch.randn(M, K, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(
                                seed + 7 * M)).to(torch.bfloat16)
            run(f"{bits}/stacked-L{L}-layer{li}/M={M}", x, st,
                layer_index=li)
            # the selected layer is the one read
            if not torch.equal(quant_matmul(x, st, layer_index=li),
                               quant_matmul(x, layers[li])):
                raise AssertionError(f"K2 {bits}: stacked layer {li} "
                                     f"differs from the unstacked weight")
        del layers, st
        free_cuda()
    one_hot = k2_one_hot(dev, seed + 1)
    host = k2_host_overhead(dev)
    counts.reset()
    bf = [r for r in results if r["dtype"] == "bfloat16"]
    # the record line reports K2 at a decode call of w_gate in int8
    main = next(r for r in results if r["case"] == "8/w_gate/M=8")
    summary = dict(max_abs_err=max(r["max_abs_err"] for r in bf),
                   max_err_over_max_ref=max(r["judged_err"] for r in bf),
                   max_err_over_max_ref_fp32=max(
                       r["judged_err"] for r in results
                       if r["dtype"] == "float32"),
                   **{k: main[k] for k in ("ms", "plain_ms",
                                           "dense_bf16_matmul_ms",
                                           "bound_ms", "bound_by")})
    return summary, results + one_hot + [host]


def host_us_per_call(fn, n: int = 300) -> float:
    """Host time to issue one ``fn()``, in µs: ``n`` back-to-back calls on
    the host clock, synchronised only after the clock stops. With a call
    whose device time is a few µs this is the enqueue cost, the part of a
    decode step that the host pays for every product."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def k2_host_overhead(dev) -> dict:
    """The host's cost per product at a decode shape too small to keep the
    card busy: K2's wrapper and launch (bf16: the wgmma route, its tensor
    maps found in the library's cache) against ``torch.matmul`` with a
    dense bf16 weight, beside the stream lookup and ctypes call it
    includes."""
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.ops.quant_matmul import (quant_matmul,
                                                      quantize_weight)

    qw = quantize_weight(k2_weight(256, 128, dev, 9), bits=8)
    x = torch.randn(8, 256, device=dev).to(torch.bfloat16)
    dense = torch.randn(256, 128, device=dev, dtype=torch.bfloat16)
    lib = kernels.load("quant_matmul")
    rec = {"case": "host overhead (M=8, K=256, N=128, bf16)",
           "k2_wrapper_us": host_us_per_call(lambda: quant_matmul(x, qw)),
           "torch_matmul_us": host_us_per_call(lambda: torch.matmul(x,
                                                                    dense)),
           "current_stream_us": host_us_per_call(
               lambda: torch.cuda.current_stream(dev).cuda_stream),
           "ctypes_noop_launch_us": host_us_per_call(
               lambda: lib.ds_quant_matmul_tc(0, 0, 0, 0, 0, 0, 0, 256, 128,
                                              256, 0, 0, 0, 0, 8, 1, 0))}
    log(f"[kernel] host cost per call: K2 wrapper "
        f"{rec['k2_wrapper_us']:.1f} us, torch.matmul "
        f"{rec['torch_matmul_us']:.1f} us (of which stream lookup "
        f"{rec['current_stream_us']:.1f} us, a ctypes call that launches "
        f"nothing {rec['ctypes_noop_launch_us']:.1f} us)")
    return rec


#: MoE weight shapes on K5's and K3's path: (label, experts n, K, N, top-k,
#: prefill tokens) — qwen2-moe-a2.7b's expert w_gate and w_down, and
#: Mixtral-8x7B's expert w_gate
GROUPED_SHAPES = (("qwen2-moe/w_gate", 60, 2048, 1408, 4, 2048),
                  ("qwen2-moe/w_down", 60, 1408, 2048, 4, 2048),
                  ("mixtral/w_gate", 8, 4096, 14336, 2, 512))
#: tokens of one micro-batch of the moe-train phase (2 x 2048): K5's
#: forward at the train routing runs at qwen2-moe's shapes (16384 rows)
TRAIN_TOKENS = 4096
#: tokens of a decode step (8 slots, one token each)
DECODE_TOKENS = 8
#: sort alignment of the grouped products on the serving path: K5 under
#: ``moe.dropless`` (``dropless_block_m``), K3 under ``quant_bits``
K5_BLOCK_M, K3_BLOCK_M = 128, 32


def routing(kind: str, T: int, n: int, k: int, dev, seed: int):
    """[T, k] expert choices, k distinct experts per token: ``spread``
    draws them uniformly; ``skewed`` sends every token to the same k
    experts (expert 3 owns all T tokens); ``idle`` draws them from the
    first quarter of the experts, so the rest own no row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "skewed":
        row = (3 + torch.arange(k, device=dev)) % n
        return row.expand(T, k).to(torch.int32).contiguous()
    m = n if kind == "spread" else max(n // 4, k)
    scores = torch.rand(T, m, generator=g, device=dev)
    return scores.argsort(dim=1)[:, :k].to(torch.int32)


def grouped_case(T, k, n, K, block_m, dtype, dev, seed, kind="spread"):
    """(buf, sort, per-expert counts): T unit-normal token rows routed by
    ``routing(kind)`` into the expert-sorted buffer (zero padding rows)."""
    from deepspeed_tpu_torch.ops.grouped_matmul import sort_tokens_by_expert

    idx = routing(kind, T, n, k, dev, seed)
    srt = sort_tokens_by_expert(idx, n, block_m)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn(T, K, generator=g, device=dev).to(dtype)
    buf = x.new_zeros((srt.Tp, K)).index_copy_(
        0, srt.dst.long(), x.repeat_interleave(k, dim=0))
    e = idx.reshape(-1).long()
    counts = torch.zeros(n, dtype=torch.long, device=dev).scatter_add_(
        0, e, torch.ones_like(e))
    return buf, srt, counts


def grouped_bound(counts, K, N, dtype, weight_bytes_per_expert):
    """(bound ms, what bounds it, bytes, operations): the x rows that hold
    routed tokens, the weights of each expert that owns a routed row once,
    and the routed output rows; 2 * routed rows * K * N operations at the
    peak for x's dtype."""
    routed = int(counts.sum())
    active = int((counts > 0).sum())
    el = torch.empty((), dtype=dtype).element_size()
    nbytes = (routed * K * el + active * weight_bytes_per_expert
              + routed * N * el)
    ops = 2.0 * routed * K * N
    bound, by = bound_of(nbytes, ops / PEAK_OPS[dtype])
    return bound, by, float(nbytes), ops


def library_grouped_mm(buf, w_bf16, counts, block_m):
    """One ``torch._grouped_mm`` call over the same expert-aligned buffer
    in bf16 (group ends from the aligned counts), or None where this torch
    has no such call."""
    if not hasattr(torch, "_grouped_mm"):
        return None
    aligned = (counts + block_m - 1) // block_m * block_m
    offs = aligned.cumsum(0).to(torch.int32)
    xb = buf.to(torch.bfloat16)
    return lambda: torch._grouped_mm(xb, w_bf16, offs=offs)


def check_grouped(tag, got, ref, tp, N, dtype) -> tuple[float, float]:
    """(max |error|, max |error| / max |plain|), raising past ``K2_TOL``."""
    if got.shape != (tp, N) or not torch.isfinite(got).all():
        raise AssertionError(f"{tag}: shape {tuple(got.shape)} or "
                             f"non-finite output")
    err = (got.float() - ref.float()).abs().max().item()
    judged = err / ref.float().abs().max().item()
    if judged > K2_TOL[dtype]:
        raise AssertionError(f"{tag} {dtype}: kernel against plain error "
                             f"{judged:.3e} > {K2_TOL[dtype]:.0e} (max abs "
                             f"{err:.3e})")
    return err, judged


def phase_k5(dev) -> tuple[dict, list]:
    """K5's forward against its plain version at the MoE shapes, decode and
    prefill routings (and a skewed and an idle-expert routing), bf16 and
    fp32, and at a train micro-batch's routing (qwen2-moe, bf16). Each
    case names the route ``gmm_route`` gave it. Returns (summary,
    cases)."""
    from deepspeed_tpu_torch.ops.grouped_matmul import (
        counts, gmm_block_rows, gmm_route, grouped_matmul,
        grouped_matmul_reference)

    results = []
    seed = 300
    for label, n, K, N, k, T_pre in GROUPED_SHAPES:
        seed += 10
        g = torch.Generator(device=dev).manual_seed(seed)
        w32 = torch.randn(n, K, N, generator=g, device=dev) / K ** 0.5
        w_bf16 = w32.to(torch.bfloat16)
        plan = [("decode", DECODE_TOKENS, "spread", torch.bfloat16),
                ("decode", DECODE_TOKENS, "spread", torch.float32),
                ("prefill", T_pre, "spread", torch.bfloat16),
                ("prefill", T_pre, "spread", torch.float32)]
        if label == "qwen2-moe/w_gate":
            plan += [("prefill", T_pre, "skewed", torch.bfloat16),
                     ("prefill", T_pre, "idle", torch.bfloat16)]
        if label.startswith("qwen2-moe"):
            plan.append(("train", TRAIN_TOKENS, "spread", torch.bfloat16))
        for i, (phase, T, kind, dtype) in enumerate(plan):
            buf, srt, cnt = grouped_case(T, k, n, K, K5_BLOCK_M, dtype, dev,
                                         seed + i, kind)
            w = w_bf16 if dtype == torch.bfloat16 else w32
            args = (buf, w, srt.tile_expert, K5_BLOCK_M, srt.tile_rows)
            tag = f"K5 {label}/{phase}-{kind}/T={T}x{k}"
            route = gmm_route(dtype, K5_BLOCK_M)
            before = counts.kernel_tc
            got = grouped_matmul(*args)
            torch.cuda.synchronize()
            if counts.kernel_tc - before != (route == "wgmma"):
                raise AssertionError(f"{tag}: route {route} not counted")
            if not torch.equal(grouped_matmul(*args), got):
                raise AssertionError(f"{tag}: a second launch gave other "
                                     f"bits")
            ref = grouped_matmul_reference(*args)
            err, judged = check_grouped(tag, got, ref, srt.Tp, N, dtype)
            ms = cuda_time_ms(lambda: grouped_matmul(*args))
            plain_ms = cuda_time_ms(lambda: grouped_matmul_reference(*args),
                                    iters=3, warmup=1, graph=False)
            lib = (library_grouped_mm(buf, w_bf16, cnt, K5_BLOCK_M)
                   if dtype == torch.bfloat16 else None)
            lib_ms = cuda_time_ms(lib) if lib is not None else None
            el = w.element_size()
            bound, by, nbytes, ops = grouped_bound(cnt, K, N, dtype,
                                                   K * N * el)
            rec = dict(case=f"{label}/{phase}-{kind}/T={T}x{k}",
                       dtype=str(dtype).replace("torch.", ""), route=route,
                       Tp=srt.Tp, routed_rows=T * k,
                       active_experts=int((cnt > 0).sum()),
                       max_abs_err=err, judged_err=judged,
                       tol=K2_TOL[dtype], ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound, bound_by=by,
                       bytes=nbytes, ops=ops)
            rows_txt = ""
            if route == "wgmma":
                rec["block_rows"] = gmm_block_rows(srt.Tp, n, K5_BLOCK_M)
                rec["ms_by_block_rows"] = k5_block_rows_ms(buf, w, srt)
                rows_txt = (f"  (rows a block {rec['block_rows']}; 64 / 128: "
                            + " / ".join(f"{v:.4f}" for v in
                                         rec["ms_by_block_rows"].values())
                            + " ms)")
            results.append(rec)
            lib_txt = f"{lib_ms:.4f}" if lib_ms is not None else "none"
            log(f"[kernel] {tag:<44} {rec['dtype']:<8} {route:<5} err "
                f"{judged:.2e} "
                f"(tol {K2_TOL[dtype]:.0e}; max abs {err:.2e})  kernel "
                f"{ms:.4f} ms  plain {plain_ms:.3f} ms  _grouped_mm "
                f"{lib_txt} ms  bound {bound:.4f} ms ({by}){rows_txt}")
            del buf, srt, got, ref, args
        del w32, w_bf16
        free_cuda()
    counts.reset()
    summary = grouped_summary(results, "qwen2-moe/w_gate/decode-spread/T=8x4",
                              "bfloat16")
    summary["kernel_route"] = gmm_route(torch.bfloat16, K5_BLOCK_M)
    return summary, results


def k5_block_rows_ms(buf, w, srt) -> dict:
    """The wgmma forward's time with 64- and 128-row blocks on one call's
    inputs (``gmm_block_rows`` picks one from the shapes alone), through
    the C entry, so both sizes run on the same data in the same run."""
    from deepspeed_tpu_torch.ops import kernels

    lib = kernels.load("grouped_matmul")
    n, K, N = w.shape
    out = torch.empty(srt.Tp, N, dtype=buf.dtype, device=buf.device)
    te, tr = srt.tile_expert, srt.tile_rows

    def launch(rows):
        err = lib.ds_grouped_matmul_tc(
            buf.data_ptr(), w.data_ptr(), te.data_ptr(), tr.data_ptr(),
            out.data_ptr(), srt.Tp, K, N, n, K5_BLOCK_M, rows, 1,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ds_grouped_matmul_tc: error {err}")

    return {rows: cuda_time_ms(lambda: launch(rows)) for rows in (64, 128)}


def k5_resources(built: dict) -> list:
    """K5's wgmma kernels' registers, stack, spills and wgmma serialization
    from the build's ``-Xptxas -v`` output (empty when the library was
    already built) and their dynamic shared memory. The register count is
    the launch's: the forward / dx blocks (a producer warp beside the
    consumer warpgroups) keep it; dw's consumer warpgroups raise theirs to
    240 (setmaxnreg)."""
    from deepspeed_tpu_torch.ops import kernels

    lib = kernels.load("grouped_matmul")
    entries = ptxas_entries(built.get("grouped_matmul", {}).get("ptxas", ""))
    rows = []
    for label, kern, mangled, which in (
            ("gmm_tc_kernel<false, 2>", "gmm_tc_kernel", "ILb0ELi2E", 0),
            ("gmm_tc_kernel<false, 1>", "gmm_tc_kernel", "ILb0ELi1E", 1),
            ("gmm_tc_kernel<true, 2>", "gmm_tc_kernel", "ILb1ELi2E", 0),
            ("gmm_tc_kernel<true, 1>", "gmm_tc_kernel", "ILb1ELi1E", 1),
            ("gmm_dw_tc_kernel", "gmm_dw_tc_kernel", "", 2)):
        found = [v for name, v in entries.items()
                 if kern + (mangled if mangled else "") in name]
        row = dict(kernel=label, smem_bytes=lib.ds_grouped_matmul_tc_smem(
            which), **(found[0] if found else {}))
        row.setdefault("wgmma_serialized", False)
        rows.append(row)
        log(f"[kernel] K5 {label:<24} registers "
            f"{row.get('regs', 'not reported')}, stack "
            f"{row.get('stack', '-')} B, spills "
            f"{row.get('spill_stores', '-')} / "
            f"{row.get('spill_loads', '-')} B, shared memory "
            f"{row['smem_bytes']} B, wgmma serialized "
            f"{row['wgmma_serialized']}")
    return rows


def grouped_summary(results, main_case, main_dtype) -> dict:
    """The record line's fields: the worst errors, and the times of the
    serving path's most frequent call (a decode step's w_gate product)."""
    bf = [r for r in results if r["dtype"] == "bfloat16"]
    fp = [r for r in results if r["dtype"] == "float32"]
    main = next(r for r in results if r["case"] == main_case
                and r["dtype"] == main_dtype)
    return dict(max_abs_err=max(r["max_abs_err"] for r in bf),
                max_err_over_max_ref=max(r["judged_err"] for r in bf),
                max_err_over_max_ref_fp32=max(r["judged_err"] for r in fp),
                **{k: main[k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by")})


#: K5's backward on the MoE train path: (label, experts n, K, N, top-k,
#: tokens) — qwen2-moe's expert w_gate and w_down at one micro-batch of
#: the moe-train phase (2 x 2048 tokens x top-4: 16384 routed rows, Tp
#: 24064 at block_m 128), and Mixtral's w_gate at 512 x 2
GROUPED_BWD_SHAPES = (("qwen2-moe/w_gate", 60, 2048, 1408, 4, 4096),
                      ("qwen2-moe/w_down", 60, 1408, 2048, 4, 4096),
                      ("mixtral/w_gate", 8, 4096, 14336, 2, 512))


def grouped_bwd_bound(counts, n, K, N, dtype, which):
    """(bound ms, what bounds it, bytes, operations) of dx or dw: the routed
    rows of the two row operands read once (dy and x for dw; dy for dx) and
    dx's routed rows written (dx), or every expert's [K, N] written (dw,
    zeros included); the weights of each expert that owns a routed row read
    once (dx); 2 * routed rows * K * N operations either way."""
    routed = int(counts.sum())
    active = int((counts > 0).sum())
    el = torch.empty((), dtype=dtype).element_size()
    if which == "dx":
        nbytes = routed * N * el + active * K * N * el + routed * K * el
    else:
        nbytes = routed * K * el + routed * N * el + n * K * N * el
    ops = 2.0 * routed * K * N
    bound, by = bound_of(nbytes, ops / PEAK_OPS[dtype])
    return bound, by, float(nbytes), ops


def library_grouped_bwd(buf, dy, w_bf16, counts, block_m):
    """``torch._grouped_mm`` yardsticks in bf16 over the same expert-aligned
    buffer (group ends from the aligned counts): dx as a 2d x 3d call with
    w transposed (a view), dw as the 2d x 2d call ragged over rows, and the
    forward + backward through autograd. None where this torch has no such
    call."""
    if not hasattr(torch, "_grouped_mm"):
        return None
    aligned = (counts + block_m - 1) // block_m * block_m
    offs = aligned.cumsum(0).to(torch.int32)
    xb, dyb = buf.to(torch.bfloat16), dy.to(torch.bfloat16)
    wt = w_bf16.transpose(1, 2)
    xg = xb.detach().clone().requires_grad_()
    wg = w_bf16.detach().clone().requires_grad_()

    def fwd_bwd():
        torch._grouped_mm(xg, wg, offs=offs).backward(dyb)
        xg.grad = wg.grad = None

    return dict(dx=lambda: torch._grouped_mm(dyb, wt, offs=offs),
                dw=lambda: torch._grouped_mm(xb.t(), dyb, offs=offs),
                fwd_bwd=fwd_bwd)


def phase_k5_bwd(dev) -> tuple[dict, dict, list]:
    """K5's dx and dw kernels against their plain versions at the train
    path's shapes (``GROUPED_BWD_SHAPES``), under uniform, skewed (every
    token on 4 experts) and idle-expert routings, bf16 and fp32, judged by
    ``K2_TOL``; times of each kernel, its plain version, its bound and the
    ``torch._grouped_mm`` yardstick, and K5's forward + dx + dw beside
    ``_grouped_mm``'s forward + backward through autograd. Returns the dx
    and dw records' fields and the cases."""
    from deepspeed_tpu_torch.ops import grouped_matmul as gm

    results = []
    seed = 700
    for label, n, K, N, k, T in GROUPED_BWD_SHAPES:
        seed += 10
        g = torch.Generator(device=dev).manual_seed(seed)
        w32 = torch.randn(n, K, N, generator=g, device=dev) / K ** 0.5
        w_bf16 = w32.to(torch.bfloat16)
        for i, (kind, dtype) in enumerate(
                (kd, dt) for kd in ("spread", "skewed", "idle")
                for dt in (torch.bfloat16, torch.float32)):
            buf, srt, cnt = grouped_case(T, k, n, K, K5_BLOCK_M, dtype, dev,
                                         seed + i, kind)
            w = w_bf16 if dtype == torch.bfloat16 else w32
            gd = torch.Generator(device=dev).manual_seed(seed + 50 + i)
            dy = torch.randn(srt.Tp, N, generator=gd, device=dev).to(dtype)
            dx_args = (dy, w, srt.tile_expert, K5_BLOCK_M, srt.tile_rows)
            dw_args = (buf, dy, srt.tile_expert, n, K5_BLOCK_M,
                       srt.tile_rows)
            tag = f"K5 bwd {label}/train-{kind}/T={T}x{k}"
            route = gm.gmm_route(dtype, K5_BLOCK_M)
            tc = int(route == "wgmma")
            c = gm.counts
            before = (c.kernel_dx, c.kernel_dw, c.kernel_dx_tc, c.kernel_dw_tc)
            dx = gm.grouped_matmul_dx(*dx_args)
            dw = gm.grouped_matmul_dw(*dw_args)
            torch.cuda.synchronize()
            if (c.kernel_dx, c.kernel_dw, c.kernel_dx_tc, c.kernel_dw_tc) != (
                    before[0] + 1, before[1] + 1, before[2] + tc,
                    before[3] + tc):
                raise AssertionError(f"{tag}: the kernels were not counted "
                                     f"on route {route}")
            if not (torch.equal(gm.grouped_matmul_dx(*dx_args), dx) and
                    torch.equal(gm.grouped_matmul_dw(*dw_args), dw)):
                raise AssertionError(f"{tag}: a second launch gave other "
                                     f"bits")
            errs = {}
            for name, got, ref, shape in (
                    ("dx", dx, gm.grouped_matmul_dx_reference(*dx_args),
                     (srt.Tp, K)),
                    ("dw", dw, gm.grouped_matmul_dw_reference(*dw_args),
                     (n, K, N))):
                if tuple(got.shape) != shape or not torch.isfinite(got).all():
                    raise AssertionError(f"{tag} {name}: shape "
                                         f"{tuple(got.shape)} or non-finite")
                err = (got.float() - ref.float()).abs().max().item()
                judged = err / ref.float().abs().max().item()
                if judged > K2_TOL[dtype]:
                    raise AssertionError(
                        f"{tag} {name} {dtype}: kernel against plain error "
                        f"{judged:.3e} > {K2_TOL[dtype]:.0e} (max abs "
                        f"{err:.3e})")
                errs[name] = (err, judged)
                del ref
            rec = dict(case=f"{label}/train-{kind}/T={T}x{k}",
                       dtype=str(dtype).replace("torch.", ""), route=route,
                       Tp=srt.Tp,
                       routed_rows=T * k,
                       active_experts=int((cnt > 0).sum()),
                       tol=K2_TOL[dtype])
            lib = (library_grouped_bwd(buf, dy, w_bf16, cnt, K5_BLOCK_M)
                   if dtype == torch.bfloat16 else None)
            for name, fn, plain, args in (
                    ("dx", gm.grouped_matmul_dx,
                     gm.grouped_matmul_dx_reference, dx_args),
                    ("dw", gm.grouped_matmul_dw,
                     gm.grouped_matmul_dw_reference, dw_args)):
                bound, by, nbytes, ops = grouped_bwd_bound(cnt, n, K, N,
                                                           dtype, name)
                rec[name] = dict(
                    max_abs_err=errs[name][0], judged_err=errs[name][1],
                    ms=cuda_time_ms(lambda: fn(*args)),
                    plain_ms=cuda_time_ms(lambda: plain(*args), iters=2,
                                          warmup=1, graph=False),
                    library_ms=(cuda_time_ms(lib[name]) if lib is not None
                                else None),
                    bound_ms=bound, bound_by=by, bytes=nbytes, ops=ops)
            if lib is not None and kind == "spread":
                # K5's forward + dx + dw through autograd, and _grouped_mm's
                xg = buf.detach().clone().requires_grad_()
                wg = w.detach().clone().requires_grad_()

                def k5_fwd_bwd():
                    gm.grouped_matmul(xg, wg, srt.tile_expert, K5_BLOCK_M,
                                      srt.tile_rows).backward(dy)
                    xg.grad = wg.grad = None

                rec["fwd_bwd_ms"] = cuda_time_ms(k5_fwd_bwd, iters=5,
                                                 warmup=2, graph=False)
                rec["library_fwd_bwd_ms"] = cuda_time_ms(
                    lib["fwd_bwd"], iters=5, warmup=2, graph=False)
                del xg, wg
            results.append(rec)
            lib_txt = {nm: (f"{rec[nm]['library_ms']:.4f}"
                            if rec[nm]["library_ms"] is not None else "none")
                       for nm in ("dx", "dw")}
            log(f"[kernel] {tag:<44} {rec['dtype']:<8} {route:<5} "
                + "  ".join(
                    f"{nm} err {rec[nm]['judged_err']:.2e} kernel "
                    f"{rec[nm]['ms']:.4f} ms plain {rec[nm]['plain_ms']:.3f}"
                    f" _grouped_mm {lib_txt[nm]} bound "
                    f"{rec[nm]['bound_ms']:.4f} ({rec[nm]['bound_by']})"
                    for nm in ("dx", "dw"))
                + (f"  fwd+bwd K5 {rec['fwd_bwd_ms']:.3f} ms, _grouped_mm "
                   f"{rec['library_fwd_bwd_ms']:.3f} ms"
                   if "fwd_bwd_ms" in rec else ""))
            del buf, srt, dy, dx, dw, dx_args, dw_args, lib
        del w32, w_bf16
        free_cuda()
    gm.counts.reset()
    label, _, _, _, k, T = GROUPED_BWD_SHAPES[0]
    main = next(r for r in results if r["dtype"] == "bfloat16"
                and r["case"] == f"{label}/train-spread/T={T}x{k}")

    def summary(name):
        bf = [r[name] for r in results if r["dtype"] == "bfloat16"]
        fp = [r[name] for r in results if r["dtype"] == "float32"]
        out = dict(max_abs_err=max(r["max_abs_err"] for r in bf),
                   max_err_over_max_ref=max(r["judged_err"] for r in bf),
                   max_err_over_max_ref_fp32=max(r["judged_err"] for r in fp),
                   kernel_route=main["route"],
                   **{k: main[name][k] for k in ("ms", "plain_ms",
                                                 "library_ms", "bound_ms",
                                                 "bound_by")})
        return out

    dx_rec, dw_rec = summary("dx"), summary("dw")
    dw_rec.update(fwd_dx_dw_ms=main["fwd_bwd_ms"],
                  library_fwd_bwd_ms=main["library_fwd_bwd_ms"])
    return dx_rec, dw_rec, results


def k3_run(dev, results: list, tag, buf, srt, cnt, qw, w_bf16,
           layer_index=None) -> dict:
    """One K3 case against its plain version, timed beside the plain
    version, bf16 ``torch._grouped_mm`` and the bound; appended to
    ``results``."""
    from deepspeed_tpu_torch.ops.quant_matmul import (
        grouped_counts, grouped_run_tiles, kernel_route,
        quant_grouped_matmul, quant_grouped_matmul_reference)

    n, K, N = qw.shape
    dtype = buf.dtype
    kw = dict(layer_index=layer_index, block_m=K3_BLOCK_M,
              tile_rows=srt.tile_rows)
    route = kernel_route(dtype, qw.bits)
    if route == "wgmma":
        route += f" runs of {grouped_run_tiles(srt.Tp, n, K3_BLOCK_M)}"
    got = launch_twice(f"K3 {tag} {dtype}", lambda: quant_grouped_matmul(
        buf, qw, srt.tile_expert, **kw), grouped_counts,
        kernel_route(dtype, qw.bits) == "wgmma")
    ref = quant_grouped_matmul_reference(buf, qw, srt.tile_expert, **kw)
    err, judged = check_grouped(f"K3 {tag}", got, ref, srt.Tp, N, dtype)
    ms = cuda_time_ms(lambda: quant_grouped_matmul(
        buf, qw, srt.tile_expert, **kw))
    plain_ms = cuda_time_ms(lambda: quant_grouped_matmul_reference(
        buf, qw, srt.tile_expert, **kw), iters=3, warmup=1, graph=False)
    lib = library_grouped_mm(buf, w_bf16, cnt, K3_BLOCK_M)
    lib_ms = cuda_time_ms(lib) if lib is not None else None
    # one expert's codes and scales
    data, scale = qw.data, qw.scale
    if layer_index is not None:
        data, scale = data[layer_index], scale[layer_index]
    wbytes = data[0].numel() * data.element_size() + scale[0].numel() * 4
    bound, by, nbytes, ops = grouped_bound(cnt, K, N, dtype, wbytes)
    rec = dict(case=tag, bits=str(qw.bits),
               dtype=str(dtype).replace("torch.", ""), route=route,
               Tp=srt.Tp,
               active_experts=int((cnt > 0).sum()), max_abs_err=err,
               judged_err=judged, tol=K2_TOL[dtype], ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
               bound_by=by, bytes=nbytes, ops=ops)
    results.append(rec)
    lib_txt = f"{lib_ms:.4f}" if lib_ms is not None else "none"
    log(f"[kernel] K3 {tag:<46} {rec['dtype']:<8} {route:<14} err "
        f"{judged:.2e} (tol {K2_TOL[dtype]:.0e}; max abs {err:.2e})  "
        f"kernel "
        f"{ms:.4f} ms  plain {plain_ms:.3f} ms  bf16 _grouped_mm "
        f"{lib_txt} ms  bound {bound:.4f} ms ({by})")
    del got, ref
    return rec


def phase_k3(dev) -> tuple[dict, list]:
    """K3 against its plain version: int8, int4 and e4m3 codes at the MoE
    shapes, decode and prefill routings in bf16, skewed and idle-expert
    routings and fp32 x for int8, and stacked [L, n, ...] codes at a
    non-zero layer. Returns (summary, cases)."""
    from deepspeed_tpu_torch.ops.quant_matmul import (
        QuantGrouped, grouped_counts, quant_grouped_matmul,
        quantize_grouped)

    results = []

    def run(tag, buf, srt, cnt, qw, w_bf16, layer_index=None):
        return k3_run(dev, results, tag, buf, srt, cnt, qw, w_bf16,
                      layer_index)

    seed = 500
    for label, n, K, N, k, T_pre in GROUPED_SHAPES:
        seed += 10
        g = torch.Generator(device=dev).manual_seed(seed)
        w32 = torch.randn(n, K, N, generator=g, device=dev) / K ** 0.5
        w32 *= torch.empty(n, K, 1, device=dev).uniform_(
            -2, 2, generator=g).exp_()
        w_bf16 = w32.to(torch.bfloat16)
        for bits in (8, 4, "fp8"):
            qw = quantize_grouped(w32, bits=bits)
            plan = [("decode", DECODE_TOKENS, "spread", torch.bfloat16),
                    ("prefill", T_pre, "spread", torch.bfloat16)]
            if label == "qwen2-moe/w_gate" and bits == 8:
                plan += [("decode", DECODE_TOKENS, "spread", torch.float32),
                         ("prefill", T_pre, "skewed", torch.bfloat16),
                         ("prefill", T_pre, "idle", torch.bfloat16)]
            for i, (phase, T, kind, dtype) in enumerate(plan):
                buf, srt, cnt = grouped_case(T, k, n, K, K3_BLOCK_M, dtype,
                                             dev, seed + i, kind)
                run(f"{bits}/{label}/{phase}-{kind}/T={T}x{k}", buf, srt,
                    cnt, qw, w_bf16)
                del buf, srt
            del qw
            free_cuda()
        del w32, w_bf16
        free_cuda()
    # stacked [L, n, K, N] codes: one layer selected inside the kernel
    label, n, K, N, k, _ = GROUPED_SHAPES[0]
    L, li = 4, 2
    g = torch.Generator(device=dev).manual_seed(seed + 99)
    for bits in (8, 4):
        layers = [quantize_grouped(torch.randn(n, K, N, generator=g,
                                               device=dev), bits=bits)
                  for _ in range(L)]
        st = QuantGrouped(torch.stack([q.data for q in layers]),
                          torch.stack([q.scale for q in layers]), bits,
                          layers[0].group_size, layers[0].shape,
                          layers[0].dtype)
        buf, srt, cnt = grouped_case(DECODE_TOKENS, k, n, K, K3_BLOCK_M,
                                     torch.bfloat16, dev, seed + 7)
        w_bf16 = torch.randn(n, K, N, generator=g, device=dev,
                             dtype=torch.bfloat16)
        run(f"{bits}/{label}/stacked-L{L}-layer{li}/decode", buf, srt, cnt,
            st, w_bf16, layer_index=li)
        kw = dict(block_m=K3_BLOCK_M, tile_rows=srt.tile_rows)
        if not torch.equal(
                quant_grouped_matmul(buf, st, srt.tile_expert,
                                     layer_index=li, **kw),
                quant_grouped_matmul(buf, layers[li], srt.tile_expert,
                                     **kw)):
            raise AssertionError(f"K3 {bits}: stacked layer {li} differs "
                                 f"from the unstacked codes")
        del layers, st, buf, srt, w_bf16
        free_cuda()
    grouped_counts.reset()
    return grouped_summary(results,
                           "8/qwen2-moe/w_gate/decode-spread/T=8x4",
                           "bfloat16"), results


# ---------------------------------------------------------------------------
# phases 3 and 4: the engine
# ---------------------------------------------------------------------------

def tap_engine_class():
    """InferenceEngineV2 that keeps the logits of every committed token, per
    request, in stream order (for the parity phase only): its programs,
    captured graphs included, also return their rows' fp32 logits, which
    ride to the host beside the tokens and are kept at the commit."""
    from deepspeed_tpu_torch.inference import InferenceEngineV2

    class TapEngine(InferenceEngineV2):
        _keep_logits = True

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.taps: dict[int, list[torch.Tensor]] = {}

        def _commit_entry(self, entry, toks_h, emitted):
            logits = entry["out"][1]
            if entry["kind"] == "window":
                for uid, (sl, _) in entry["sched"].items():
                    if uid in self.state.seqs:
                        n = int((toks_h[:, sl] >= 0).sum())
                        self.taps.setdefault(uid, []).extend(
                            logits[i, sl].clone() for i in range(n))
            else:
                plan = entry["plan"]
                for r, uid in enumerate(plan.uids):
                    if uid >= 0 and plan.do_sample[r]:
                        self.taps.setdefault(uid, []).append(
                            logits[r].clone())
            super()._commit_entry(entry, toks_h, emitted)

    return TapEngine


def graph_replays(eng) -> dict:
    """Replays of an engine's captured programs by key."""
    return dict(eng._programs.stats()["replays"])


def check_replays(tag, eng, before: dict, st0: dict) -> dict:
    """Every decode window dispatched since ``before`` / ``st0`` (replays
    and stats snapshots) replayed its ``("win", W)`` graph, and every
    decode step plan the ``(1, max_seqs)`` graph: a capture or replay that
    failed would have raised, and no eager decode path exists on the card
    but ``decode_early_exit``. Returns the replays by key since."""
    now = graph_replays(eng)
    got = {k: n - before.get(k, 0) for k, n in now.items()
           if n != before.get(k, 0)}
    st = eng.stats
    windows = st["windows"] - st0.get("windows", 0)
    # a verify round counts as a decode step and runs eagerly
    steps = (st["decode_steps"] - st0.get("decode_steps", 0)
             - st["spec_rounds"] + st0.get("spec_rounds", 0))
    step_key = str((1, eng.state.max_seqs))
    won = sum(n for k, n in got.items() if "win" in k)
    if won != windows or got.get(step_key, 0) < steps:
        raise AssertionError(f"[{tag}] graph replays {got} for {windows} "
                             f"windows and {steps} decode steps")
    return got


def all_counts() -> dict:
    """Every kernel wrapper's launch counts."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import grouped_matmul as gm
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import quant_matmul as qm

    return {"k1": pa.counts.kernel, "k1_e4m3": pa.counts.kernel_e4m3,
            "k1_window": pa.counts.kernel_window,
            "k1_ring": pa.counts.kernel_ring,
            "k1_tree": pa.counts.kernel_tree,
            "k1_chunk": pa.counts.kernel_chunk,
            "k1_split": pa.counts.kernel_split,
            "k1_plain": pa.counts.plain, "k2": qm.counts.kernel,
            "k2_tc": qm.counts.kernel_tc, "k2_plain": qm.counts.plain,
            "k3": qm.grouped_counts.kernel,
            "k3_tc": qm.grouped_counts.kernel_tc,
            "k3_plain": qm.grouped_counts.plain, "k5": gm.counts.kernel,
            "k5_plain": gm.counts.plain, "k5_dx": gm.counts.kernel_dx,
            "k5_dw": gm.counts.kernel_dw, "k5_tc": gm.counts.kernel_tc,
            "k5_dx_tc": gm.counts.kernel_dx_tc,
            "k5_dw_tc": gm.counts.kernel_dw_tc,
            "k5_plain_dx": gm.counts.plain_dx,
            "k5_plain_dw": gm.counts.plain_dw, "k4_fwd": fa.counts.fwd,
            "k4_bwd": fa.counts.bwd, "k4_plain": fa.counts.plain,
            "k4_plain_bwd": fa.counts.plain_bwd, "k6_fwd": bsa.counts.fwd,
            "k6_bwd": bsa.counts.bwd, "k6_fwd_tc": bsa.counts.fwd_tc,
            "k6_bwd_tc": bsa.counts.bwd_tc, "k6_plain": bsa.counts.plain,
            "k6_plain_bwd": bsa.counts.plain_bwd,
            "k7": pa.prefill_counts.kernel,
            "k7_chunk": pa.prefill_counts.kernel_chunk,
            "k7_split": pa.prefill_counts.kernel_split,
            "k7_plain": pa.prefill_counts.plain}


def reset_counts() -> None:
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import grouped_matmul as gm
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import quant_matmul as qm

    bsa.counts.reset()
    pa.prefill_counts.reset()
    pa.counts.reset()
    qm.counts.reset()
    qm.grouped_counts.reset()
    gm.counts.reset()
    fa.counts.reset()


def forwards_of(eng) -> int:
    st = eng.stats
    return st["prefill_steps"] + st["decode_steps"] + st["window_iters_max"]


def want_launches(cfg, *, forwards, e4m3_pool, quant, ring=False,
                  verifies=0, draft_k1=0, bf16=False) -> dict:
    """The launches of every kernel wrapper an engine serving ``cfg`` makes
    in ``forwards`` forwards (see :func:`check_launches`); ``k1_routed`` is
    K1's chunk + split launches."""
    from deepspeed_tpu_torch.models.transformer import is_moe_layer

    L = cfg.num_layers
    moe_layers = sum(is_moe_layer(cfg, i) for i in range(L))
    ffn = 3 if cfg.activation == "silu_glu" else 2
    dense = 4 * L + ffn * (L - moe_layers) + 1
    experts = ffn * moe_layers
    dropless = cfg.moe is not None and cfg.moe.dropless
    f = forwards
    want = {"k1": (0 if e4m3_pool else L * f) + draft_k1,
            "k1_e4m3": L * f if e4m3_pool else 0,
            "k1_window": L * f if ring else 0,
            "k1_ring": L * f if ring else 0, "k1_tree": L * verifies,
            "k1_plain": 0,
            "k2": dense * f if quant else 0, "k2_plain": 0,
            "k3": experts * f if quant else 0, "k3_plain": 0,
            "k5": experts * f if dropless and not quant else 0,
            "k5_plain": 0, "k5_dx": 0, "k5_dw": 0, "k5_plain_dx": 0,
            "k5_plain_dw": 0, "k5_dx_tc": 0, "k5_dw_tc": 0, "k4_fwd": 0,
            "k4_bwd": 0, "k4_plain": 0, "k4_plain_bwd": 0, "k6_fwd": 0,
            "k6_bwd": 0, "k6_fwd_tc": 0, "k6_bwd_tc": 0, "k6_plain": 0,
            "k6_plain_bwd": 0, "k7": 0, "k7_chunk": 0, "k7_split": 0,
            "k7_plain": 0}
    for key in ("k2", "k3", "k5"):
        want[key + "_tc"] = want[key] if bf16 else 0
    want["k1_routed"] = want["k1"] + want["k1_e4m3"] if bf16 else 0
    return want


def check_launches(tag, got: dict, cfg, *, forwards, e4m3_pool, quant,
                   ring=False, verifies=0, draft_k1=0, bf16=False):
    """Per forward: K1 (over a pool of q's dtype or of e4m3 codes) once per
    layer, with the window and the ring on every one of a ring-served
    model's, and its tree form once per layer of each of the ``verifies``
    speculative verify forwards (which count among ``forwards``);
    ``draft_k1`` more launches of K1 by a draft engine (bf16 pool); when
    the weights are quantized, K2 once per dense weight product (q, k, v, o
    of every layer, a dense FFN's products, the unembedding) and K3 once per
    expert product of every MoE layer; K5 once per expert product under
    ``moe.dropless`` without quantization; never K4 (serving has no
    full-sequence attention), K6 or K7; no plain version at all. With
    ``bf16`` every K1 launch is one of the chunk or the split kernel's and
    every K2, K3 and K5 launch took the wgmma route (K5: the engine sorts
    at ``dropless_block_m`` 128); in fp32 none does."""
    want = want_launches(cfg, forwards=forwards, e4m3_pool=e4m3_pool,
                         quant=quant, ring=ring, verifies=verifies,
                         draft_k1=draft_k1, bf16=bf16)
    L = cfg.num_layers
    want_routed = want.pop("k1_routed")
    rest = dict(got)
    routed = rest.pop("k1_chunk") + rest.pop("k1_split")
    if forwards <= 0 or rest != want or routed != want_routed:
        raise AssertionError(f"[{tag}] launches {got} != {want}, K1 chunk + "
                             f"split {routed} != {want_routed} "
                             f"({L} layers x {forwards} forwards)")


def oracle_check(tag, eng, oracle, prompts, streams, new, dev):
    """Each stream against the dense ``oracle`` teacher-forced on it: one
    forward over the prompt and the stream gives every step's logits (a
    causal model's logits at a position read only the tokens up to it, so
    they are a greedy loop's over the same prefix); logits within 1e-3
    relative, tokens equal except at near-ties (top-2 gap below 1e-4).
    Returns (worst relative logits error, near-ties)."""
    worst, near_ties = 0.0, []
    with torch.no_grad():
        for uid, (prompt, got) in enumerate(zip(prompts, streams)):
            if len(got) != new:
                raise AssertionError(f"[{tag}] uid {uid}: {len(got)} tokens")
            ids = torch.tensor([list(prompt) + list(got[:-1])], device=dev)
            refs = oracle(ids)[0, len(prompt) - 1:].float().cpu()
            for k, tok in enumerate(got):
                ref = refs[k]
                top2 = torch.topk(ref, 2).values
                ours = eng.taps[uid][k]
                rel = ((ours - ref).abs().max() / ref.abs().max()).item()
                worst = max(worst, rel)
                if rel > 1e-3:
                    raise AssertionError(
                        f"[{tag}] uid {uid} step {k}: logits differ by "
                        f"{rel:.2e} relative (> 1e-3)")
                if int(ref.argmax()) != tok:
                    gap = (top2[0] - top2[1]).item()
                    if gap >= 1e-4:
                        raise AssertionError(
                            f"[{tag}] uid {uid} step {k}: engine token "
                            f"{tok} != oracle {int(ref.argmax())} (top-2 gap "
                            f"{gap:.3e})")
                    near_ties.append((uid, k, gap))
                    log(f"[{tag}] NEAR-TIE uid {uid} step {k}: oracle top-2 "
                        f"gap {gap:.2e} < 1e-4; streams part here by design")
    return worst, near_ties


def load_dequantized(model, params) -> None:
    """Overwrite ``model``'s matmul weights with ``dequantize_weight`` /
    ``dequantize_grouped`` of the engine's codes: the dense oracle of a
    quantized engine."""
    from deepspeed_tpu_torch.ops.quant_matmul import (
        QuantGrouped, QuantLinear, dequantize_grouped, dequantize_weight)

    with torch.no_grad():
        for name, p in model.named_parameters():
            node = params
            for part in name.split("."):
                node = node[part]
            if isinstance(node, QuantLinear):
                p.copy_(dequantize_weight(node).reshape(p.shape))
            elif isinstance(node, QuantGrouped):
                p.copy_(dequantize_grouped(node))


def no_drop_oracle(model) -> None:
    """Route ``model``'s MoE layers through the capacity route with an eval
    capacity factor of ``num_experts`` (capacity = tokens x k, so nothing
    drops) and not the dropless route: the oracle of an engine, which
    routes every token, independent of the grouped kernels."""
    from deepspeed_tpu_torch.moe import MoE

    for mod in model.modules():
        if isinstance(mod, MoE):
            mod.dropless, mod.drop_tokens = False, True
            mod.eval_capacity_factor = float(mod.num_experts)


#: the parity phase's models (full width, 4 layers) and the engine routes
#: each is held in: (label, engine options, MoE options)
PARITY = {
    "llama2-7b": (("dense", {}, {}), ("dense-sync", {"max_inflight": 0}, {}),
                  ("int8", {"quant_bits": 8}, {}),
                  ("int4", {"quant_bits": 4}, {}),
                  ("fp8-weights", {"quant_bits": "fp8"}, {}),
                  ("fp8-pool", {"kv_cache_dtype": "fp8"}, {})),
    "mixtral-8x7b": (("capacity", {}, {}),
                     ("dropless", {}, {"dropless": True}),
                     ("int8", {"quant_bits": 8}, {}),
                     ("int4", {"quant_bits": 4}, {}),
                     ("fp8-weights", {"quant_bits": "fp8"}, {})),
    "qwen2-moe-a2.7b": (("dropless", {}, {"dropless": True}),
                        ("int8", {"quant_bits": 8}, {})),
}


def phase_parity(dev) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {name: parity_model(dev, name, routes)
           for name, routes in PARITY.items()}
    out["mistral-7b ring"] = parity_ring(dev)
    out["llama2-7b spec"] = parity_spec(dev)
    return out


def parity_ring(dev) -> dict:
    """mistral-7b at full width x 4 layers in fp32 served from its rolling
    ring (69 pages of 64): two prompts past the 4416-token ring and a short
    one, 32 new tokens each, against the dense forward (which masks the
    4096-key window) under oracle_check's rule; then an
    e4m3-pool ring against the fp32 one within the JAX package's fp8 bound
    (max 0.5, mean 0.05 on the logits while the streams agree)."""
    from deepspeed_tpu_torch.models import build_model

    log("[parity] mistral-7b full width, 4 layers, fp32, rolling ring")
    model = build_model("mistral-7b", num_layers=4, dtype=torch.float32,
                        device=dev, seed=0, attn_impl="xla")
    vocab = model.config.vocab_size
    g = torch.Generator().manual_seed(2)
    lens = [4600, 4700, 300]
    prompts = [torch.randint(0, vocab, (n,), generator=g).tolist()
               for n in lens]
    new = 32
    cfg = dict(block_size=64, num_blocks=256, max_seqs=4, chunk=256,
               max_seq_len=8192, decode_window=8, dtype=torch.float32,
               device=dev)
    out = {"prompts": lens, "new_tokens": new}
    taps = streams = None
    for label, over in (("fp32-pool", {}),
                        ("e4m3-pool", {"kv_cache_dtype": "fp8"})):
        tag = f"parity mistral-7b ring {label}"
        eng = tap_engine_class()(model, config=dict(cfg, **over))
        ring = eng._ring_tokens
        if ring != MISTRAL_RING_PAGES * 64 or \
                eng._attn_decode_sel.path != "cuda" or eng._prefix_cache:
            raise AssertionError(f"[{tag}] ring {ring}, path "
                                 f"{eng._attn_decode_sel.path}, prefix "
                                 f"cache {eng._prefix_cache}")
        reset_counts()
        replays0 = graph_replays(eng)
        got = eng.generate(prompts, max_new_tokens=new)
        launches = all_counts()
        eng.state.audit()
        forwards = forwards_of(eng)
        check_launches(tag, launches, model.config, forwards=forwards,
                       e4m3_pool=bool(over), quant=False, ring=True)
        rec = {"launches": launches, "forwards": forwards,
               "ring_tokens": ring,
               "replays": check_replays(tag, eng, replays0, {})}
        if label == "fp32-pool":
            worst, near = oracle_check(tag, eng, model, prompts, got, new,
                                       dev)
            rec.update(max_rel_logits_err=worst, near_ties=near)
            log(f"[{tag}] {len(prompts)} greedy streams x {new} tokens past "
                f"the {ring}-token ring identical to the dense windowed "
                f"oracle ({len(near)} near-ties); max logits error "
                f"{worst:.2e} relative; launches {launches}")
            taps, streams = eng.taps, got
        else:
            rec.update(fp8_bound(tag, eng.taps, taps, got, streams, new))
        out[label] = rec
        del eng
        free_cuda()
    del model
    free_cuda()
    return out


def fp8_bound(tag, taps8, taps, streams8, streams, new) -> dict:
    """The e4m3-pool engine's logits against the fp32-pool engine's, while
    the two streams agree: max 0.5 and mean 0.05 (the JAX package's bound
    for its fp8 pool, tests/test_inference_v2.py)."""
    diffs = []
    for uid in range(len(streams)):
        for k in range(new):
            diffs.append((taps8[uid][k] - taps[uid][k]).abs())
            if streams8[uid][k] != streams[uid][k]:
                break
    d = torch.stack(diffs)
    rec = dict(max_abs_logits_diff=d.max().item(),
               mean_abs_logits_diff=d.mean().item(),
               steps_compared=len(diffs), streams_equal=streams8 == streams)
    if rec["max_abs_logits_diff"] > 0.5 or rec["mean_abs_logits_diff"] > 0.05:
        raise AssertionError(f"[{tag}] logits off the fp32 pool's: {rec}")
    log(f"[{tag}] e4m3 pool vs fp32 pool over {len(diffs)} sampled steps: "
        f"max |logits diff| {rec['max_abs_logits_diff']:.3e} (tol 0.5), mean "
        f"{rec['mean_abs_logits_diff']:.3e} (tol 0.05); streams equal: "
        f"{rec['streams_equal']}")
    return rec


def motif_prompts(vocab, g, lens=(300, 300, 300, 100)):
    """Prompts of a repeated random 12-token motif (prompt lookup proposes
    its continuation wherever the model's stream repeats its history), the
    last one random."""
    out = []
    for i, n in enumerate(lens):
        if i == len(lens) - 1:
            out.append(torch.randint(0, vocab, (n,), generator=g).tolist())
            continue
        motif = torch.randint(0, vocab, (12,), generator=g).tolist()
        out.append((motif * (n // len(motif) + 1))[:n])
    return out


def spec_stream_check(tag, got, want, oracle, prompts, dev) -> list:
    """Each spec stream against the spec-off stream; where they part, the
    dense oracle's top-2 gap there must be a near-tie (< 1e-4), as in
    oracle_check. Returns the near-ties."""
    near = []
    with torch.no_grad():
        for uid, (a, b) in enumerate(zip(got, want)):
            if a == b:
                continue
            k = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            ids = torch.tensor([prompts[uid] + b[:k]], device=dev)
            top2 = torch.topk(oracle(ids)[0, -1].float(), 2).values
            gap = (top2[0] - top2[1]).item()
            if gap >= 1e-4:
                raise AssertionError(f"[{tag}] uid {uid} step {k}: spec "
                                     f"token {a[k]} != spec-off {b[k]} "
                                     f"(top-2 gap {gap:.3e})")
            near.append((uid, k, gap))
            log(f"[{tag}] NEAR-TIE uid {uid} step {k}: top-2 gap {gap:.2e}")
    return near


def spec_stats(eng) -> dict:
    st = eng.stats
    return {k: st[k] for k in ("spec_rounds", "spec_verifies",
                               "spec_proposed", "spec_accepted",
                               "spec_steps_saved", "spec_accept_rate")} | {
        "tokens_per_verify": (st["spec_accepted"] + st["spec_verifies"])
        / max(st["spec_verifies"], 1)}


def draft_forwards(eng) -> int:
    return 0 if eng._draft_engine is None else forwards_of(eng._draft_engine)


def parity_spec(dev) -> dict:
    """llama2-7b at full width x 4 layers in fp32: speculative decoding
    ("ngram" over motif prompts; "draft" with a same-weights draft and a
    differently seeded one) against the spec-off engine in the same run.
    Every verify goes through K1's tree form; the strong draft's acceptance
    must exceed 0.9; spec with a windowed model raises ValueError."""
    from types import SimpleNamespace

    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.inference.weights import module_param_tree
    from deepspeed_tpu_torch.models import build_model

    log("[parity] llama2-7b full width, 4 layers, fp32, spec_decode")
    model = build_model("llama2-7b", num_layers=4, dtype=torch.float32,
                        device=dev, seed=0, attn_impl="xla")
    L, vocab = model.config.num_layers, model.config.vocab_size
    prompts = motif_prompts(vocab, torch.Generator().manual_seed(3))
    new = 24
    cfg = dict(block_size=64, num_blocks=64, max_seqs=4, chunk=128,
               max_seq_len=1024, decode_window=8, dtype=torch.float32,
               device=dev)
    base = InferenceEngineV2(model, config=cfg).generate(prompts, new)
    out = {"prompts": [len(p) for p in prompts], "new_tokens": new}
    weak = build_model("llama2-7b", num_layers=4, dtype=torch.float32,
                       device=dev, seed=7, attn_impl="xla")
    # prompt lookup probes the committed history, which lags the pipeline
    # by up to max_inflight dispatches (24 new tokens are 3 windows): the
    # "ngram" engine commits synchronously so that its rounds, which this
    # phase requires, see the stream; a draft always proposes, and its
    # engines drain the pipeline before each round
    for label, over, draft in (("ngram", {"spec_decode": "ngram",
                                          "max_inflight": 0}, None),
                               ("draft-strong", {"spec_decode": "draft"},
                                model),
                               ("draft-weak", {"spec_decode": "draft"},
                                weak)):
        tag = f"parity llama2-7b spec {label}"
        eng = InferenceEngineV2(model, config=dict(cfg, **over),
                                draft_model=draft)
        if eng._attn_tree_sel.path != "cuda":
            raise AssertionError(f"[{tag}] tree path "
                                 f"{eng._attn_tree_sel.path}")
        reset_counts()
        replays0 = graph_replays(eng)
        deng = eng._draft_engine
        draft0 = graph_replays(deng) if deng else {}
        got = eng.generate(prompts, new)
        launches = all_counts()
        eng.state.audit()
        check_replays(tag, eng, replays0, {})
        if deng:
            check_replays(tag + " draft", deng, draft0, {})
        st = spec_stats(eng)
        check_launches(tag, launches, model.config,
                       forwards=forwards_of(eng), e4m3_pool=False,
                       quant=False, verifies=st["spec_rounds"],
                       draft_k1=L * draft_forwards(eng))
        near = spec_stream_check(tag, got, base, model, prompts, dev)
        if st["spec_rounds"] == 0 or \
                eng.stats["attn_cuda_tree"] != st["spec_rounds"]:
            raise AssertionError(f"[{tag}] verifies {st} / "
                                 f"{eng.stats['attn_cuda_tree']}")
        if label == "draft-strong" and st["spec_accept_rate"] <= 0.9:
            raise AssertionError(f"[{tag}] acceptance {st}")
        out[label] = dict(st, launches=launches, near_ties=near)
        log(f"[{tag}] {len(prompts)} streams x {new} tokens identical to "
            f"spec-off ({len(near)} near-ties): {st['spec_rounds']} verify "
            f"rounds, acceptance {st['spec_accept_rate']:.3f}, "
            f"{st['tokens_per_verify']:.2f} tokens per verify; launches "
            f"{launches}")
        del eng
        free_cuda()
    # spec on a windowed model (its rolling ring) is refused
    windowed = SimpleNamespace(config=dataclasses.replace(
        model.config, sliding_window=MISTRAL_WINDOW))
    try:
        InferenceEngineV2(windowed, params=module_param_tree(model),
                          config=dict(cfg, max_seq_len=8192,
                                      spec_decode="ngram"))
    except ValueError as e:
        log(f"[parity] spec + sliding window refused: {e}")
    else:
        raise AssertionError("spec_decode on a windowed model did not raise")
    del model, weak
    free_cuda()
    return out


def parity_model(dev, name: str, routes) -> dict:
    from deepspeed_tpu_torch.models import build_model, get_model_config

    log(f"[parity] {name} full width, 4 layers, fp32; TF32 off for "
        f"matmuls and cuDNN")
    cfg = dict(block_size=64, num_blocks=64, max_seqs=4, chunk=128,
               max_seq_len=1024, decode_window=8, dtype=torch.float32,
               device=dev)
    vocab = get_model_config(name).vocab_size
    g = torch.Generator().manual_seed(0)
    lens = [300, 77, 150, 129, 200]            # chunks span pages
    prompts = [torch.randint(0, vocab, (n,), generator=g).tolist()
               for n in lens]
    new = 16
    out = {"prompts": lens, "new_tokens": new}
    dense_taps, dense_streams = None, None
    for label, over, moe_over in routes:
        tag = f"parity {name} {label}"
        mcfg = get_model_config(name)
        extra = ({"moe": dataclasses.replace(mcfg.moe, **moe_over)}
                 if moe_over else {})
        model = build_model(name, num_layers=4, dtype=torch.float32,
                            device=dev, seed=0, attn_impl="xla", **extra)
        eng = tap_engine_class()(model, config=dict(cfg, **over))
        if eng._attn_decode_sel.path != "cuda":
            raise AssertionError(f"[{tag}] attention path "
                                 f"{eng._attn_decode_sel.path}, not the "
                                 f"kernel")
        reset_counts()
        replays0 = graph_replays(eng)
        streams = eng.generate(prompts, max_new_tokens=new)
        launches = all_counts()
        eng.state.audit()
        forwards = forwards_of(eng)
        L = model.config.num_layers
        check_launches(tag, launches, model.config, forwards=forwards,
                       e4m3_pool="kv_cache_dtype" in over,
                       quant="quant_bits" in over)
        replays = check_replays(tag, eng, replays0, {})
        rec = {"launches": launches, "forwards": forwards,
               "max_inflight": eng.config.max_inflight, "replays": replays,
               "forced_drains": eng.stats["forced_drains"]}
        if label == "dense-sync":
            # the synchronous pipeline: the same streams as max_inflight 8
            if streams != dense_streams:
                raise AssertionError(f"[{tag}] streams at max_inflight 0 "
                                     f"differ from max_inflight 8's")
            log(f"[{tag}] streams at max_inflight 0 identical to "
                f"max_inflight 8's; replays {replays}")
        if label == "fp8-pool":
            rec.update(fp8_bound(tag, eng.taps, dense_taps, streams,
                                 dense_streams, new))
        else:
            if "quant_bits" in over:
                load_dequantized(model, eng.params)
            no_drop_oracle(model)
            worst, near = oracle_check(tag, eng, model, prompts, streams,
                                       new, dev)
            rec.update(max_rel_logits_err=worst, near_ties=near)
            log(f"[{tag}] {len(prompts)} greedy streams x {new} tokens "
                f"identical to the dense oracle ({len(near)} near-ties); max "
                f"logits error {worst:.2e} relative; launches {launches} "
                f"({L} layers x {forwards} forwards); max_inflight "
                f"{eng.config.max_inflight}, graph replays {replays}")
        if label == "dense":
            dense_taps, dense_streams = eng.taps, streams

        out[label] = rec
        del eng, model
        free_cuda()
    return out


def device_breakdown(run) -> dict:
    """Profile ``run()`` with torch.profiler and split the device's kernel
    time into K1, K2, K3, K4, K5 (forward, dx, dw), K6, matrix products and
    the rest, beside the host wall time (single stream, so busy time is the
    kernel time sum). K6's wgmma route runs K4's kernel bodies: its
    instantiations carry ``TableWalk`` in their names. Returns the numbers,
    or {"device": "not measured"} when the profiler saw no kernel time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    busy = sum(by_name.values())
    if busy <= 0:
        return {"device": "not measured", "wall_ms": wall_ms}

    def kind(name):
        low = name.lower()
        if "tablewalk" in low or "bsa_" in low:
            return "k6_ms"
        if "flash_" in low and "_kernel" in low:
            return "k4_ms"
        if "ragged_paged_attn" in low:
            return "k1_ms"
        if "qgmm_" in low:
            return "k3_ms"
        if "gmm_dw_" in low:
            return "k5_dw_ms"
        if "::gmm_" in low or low.startswith("gmm_"):
            # the forward and dx share a template on each route:
            # gmm_bf16_kernel<true> / gmm_tc_kernel<true, 2> are dx
            return "k5_dx_ms" if "kernel<true" in low else "k5_ms"
        if "qmm_" in low:
            return "k2_ms"
        if any(t in low for t in ("gemm", "xmma", "cutlass", "matmul",
                                  "nvjet")):
            return "gemm_ms"
        return "other_ms"

    out = {"wall_ms": wall_ms, "busy_ms": busy, "k1_ms": 0.0, "k2_ms": 0.0,
           "k3_ms": 0.0, "k4_ms": 0.0, "k5_ms": 0.0, "k5_dx_ms": 0.0,
           "k5_dw_ms": 0.0, "k6_ms": 0.0, "gemm_ms": 0.0, "other_ms": 0.0,
           "idle_share": max(0.0, 1 - busy / wall_ms)}
    for name, ms in by_name.items():
        out[kind(name)] += ms
    # ZeRO's gathers, gradient reduce-scatters and post-update gathers run
    # inside "zero.*" profiler ranges: their kernels (collectives, casts,
    # flat-buffer copies; none of K1-K6 or the matrix products) move from
    # "other" to "zero"
    zero = sum(getattr(e, "device_time_total", None) or e.cuda_time_total
               for e in prof.key_averages()
               if e.key.startswith("zero.")) / 1e3
    if zero:
        out["zero_ms"] = zero
        out["other_ms"] = max(0.0, out["other_ms"] - zero)
    out["top"] = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return out


#: the serve phase's traffic: (prompt lengths, shared system prefix, new
#: tokens per request, the engine's max_seq_len and num_blocks)
TRAFFIC = {
    # 8 requests of 256-1024 tokens behind a 128-token system prefix
    "shared-prefix": ((256, 384, 512, 640, 768, 896, 1024, 300), 128, 64,
                      2048, 256),
    # mistral past its window: 4 prompts of 4608-6144 tokens wrap the
    # 69-page ring, 4 of 256-1024 do not (8 x 69 pages fit 600 blocks)
    "long-window": ((4608, 5120, 5632, 6144, 256, 512, 768, 1024), 0, 64,
                    8192, 600),
    # prompts of a repeated motif (prompt lookup proposes where the model's
    # stream repeats its history)
    "motif": ((512, 384, 640, 256, 768, 320, 448, 576), 0, 64, 2048, 256),
}


def graph_vs_eager(tag, eng, dev) -> dict:
    """One decode window's graph replay against the same window run eagerly
    from the same state (the pipeline drained; the pool pages of the
    window's sequences, ``_last_tok`` restored in between): identical tokens,
    pool bits and last tokens, and the same kernel launches. The state is
    restored afterwards."""
    from deepspeed_tpu_torch.inference.programs import pack

    eng._drain(drain_all=True)
    W, arrays, live, _ = eng._window_plan()
    idx = torch.tensor(sorted({b for sq in live for b in sq.blocks}),
                       device=dev)
    pool = eng.kv_pool
    bits = pool.view(torch.uint8 if pool.element_size() == 1
                     else torch.int16)
    rows0, last0 = bits.index_select(3, idx), eng._last_tok.clone()
    flat = torch.from_numpy(pack(arrays)).to(dev)

    def launched(before):
        return {k: v - before[k] for k, v in all_counts().items()
                if v != before[k]}

    c0 = all_counts()
    eager = eng._window_body(W, flat.clone())[0].clone()
    torch.cuda.synchronize()
    eager_counts = launched(c0)
    rows_e, last_e = bits.index_select(3, idx), eng._last_tok.clone()
    bits.index_copy_(3, idx, rows0)
    eng._last_tok.copy_(last0)
    prog = eng._programs.get(("win", W), lambda x: eng._window_body(W, x),
                             flat.numel())
    prog.replays -= 1                  # a check, not a serving replay
    prog.inputs.copy_(flat)
    c0 = all_counts()
    replayed = prog.replay()[0].clone()
    torch.cuda.synchronize()
    graph_counts = launched(c0)
    same = {"tokens": torch.equal(eager, replayed),
            "pool": torch.equal(bits.index_select(3, idx), rows_e),
            "last_tok": torch.equal(eng._last_tok, last_e),
            "launches": eager_counts == graph_counts}
    bits.index_copy_(3, idx, rows0)
    eng._last_tok.copy_(last0)
    rec = {"W": W, "slots": len(live), "pool_blocks": int(idx.numel()),
           "identical": same, "launches": graph_counts}
    if not all(same.values()) or not bool((eager >= 0).any()):
        raise AssertionError(f"[{tag}] graph replay vs eager window: {rec}, "
                             f"eager counts {eager_counts}")
    log(f"[{tag}] window graph replay (W {W}, {len(live)} slots) identical "
        f"to the eager window bit for bit: tokens, {idx.numel()} pool "
        f"blocks, last tokens; launches {graph_counts} both ways")
    return rec


def serve_setup(dev, tag: str, name: str, layers: int | None, traffic: str,
                draft: bool, over: dict, quiet: bool = False):
    """Model ``name`` at full width (and ``layers`` deep, all of them by
    default) in bf16 from seeded random weights, and its engine under the
    options ``over``. An MoE model takes its dropless route (K5) unless
    ``quant_bits`` sends its experts through K3. ``draft`` serves
    ``spec_decode="draft"`` with the model itself as its draft (a second
    engine over the same weights). A first request publishes the shared
    system prefix (and warms the allocator and cuBLAS); then the prompts of
    ``TRAFFIC[traffic]`` are drawn, and every decode program of every
    engine — each window size and the decode step — is captured. The same
    arguments give the same weights, prompts and state."""
    from types import SimpleNamespace

    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.inference.weights import tree_nbytes
    from deepspeed_tpu_torch.models import build_model, get_model_config

    t0 = time.perf_counter()
    mcfg = get_model_config(name)
    extra = {} if layers is None else {"num_layers": layers}
    if mcfg.moe is not None:
        extra["moe"] = dataclasses.replace(mcfg.moe, dropless=True)
    model = build_model(name, dtype=torch.bfloat16, device=dev, seed=1,
                        **extra)
    cfg = model.config
    lens, sys_len, new, max_seq_len, num_blocks = TRAFFIC[traffic]
    eng = InferenceEngineV2(model, config=dict(
        block_size=64, num_blocks=num_blocks, max_seqs=8, chunk=256,
        max_seq_len=max_seq_len, decode_window=8, dtype=torch.bfloat16,
        device=dev, **over), draft_model=model if draft else None)
    # the engine holds what it serves; the model's own weights that the
    # engine quantized go with it
    del model
    free_cuda()
    torch.cuda.synchronize()
    # a draft engine serves the same weights from a pool of its own
    engines = [eng] + ([eng._draft_engine] if eng._draft_engine else [])
    pool_bytes = sum(e.kv_pool.numel() * e.kv_pool.element_size()
                     for e in engines)
    param_bytes = tree_nbytes(eng.params)
    resident = torch.cuda.memory_allocated(dev) - pool_bytes
    if not quiet:
        log(f"[{tag}] {name} ({cfg.num_layers} layers, bf16 compute, seeded "
            f"random weights, {over or 'no quantization'}) and "
            f"{pool_bytes / 1e9:.1f} GB {eng.kv_pool.dtype} "
            f"pool{'s' if len(engines) > 1 else ''} up in "
            f"{time.perf_counter() - t0:.1f}s; parameters "
            f"{param_bytes / 1e9:.2f} GB ({resident / 1e9:.2f} GB on the "
            f"card besides the pool); attention path "
            f"{eng._attn_decode_sel.path}")
    if resident > 1.02 * param_bytes + (256 << 20):
        raise AssertionError(f"[{tag}] {resident / 1e9:.2f} GB stays on the "
                             f"card for {param_bytes / 1e9:.2f} GB of "
                             f"parameters")
    vocab = cfg.vocab_size
    g = torch.Generator().manual_seed(1)
    system = torch.randint(0, vocab, (sys_len,), generator=g).tolist()
    eng.generate([system + torch.randint(0, vocab, (64,),
                                         generator=g).tolist()],
                 max_new_tokens=8)
    if traffic == "motif":
        prompts = motif_prompts(vocab, g, lens)
    else:
        prompts = [system + torch.randint(0, vocab, (n - sys_len,),
                                          generator=g).tolist()
                   for n in lens]
    # every decode program captured ahead of the timed serve: each window
    # size, and the step a budget's last single iteration dispatches
    for e in engines:
        e.warm_decode_windows()
        e.warm_decode_step()
    return SimpleNamespace(eng=eng, engines=engines, cfg=cfg, g=g,
                           system=system, prompts=prompts, lens=lens,
                           sys_len=sys_len, new=new, vocab=vocab,
                           pool_bytes=pool_bytes, param_bytes=param_bytes,
                           resident=resident)


def token_steps(eng) -> int:
    """Decode token-steps dispatched: window iterations and decode steps
    (a verify round counts as one), at dispatch."""
    return eng.stats["window_iters_dispatched"] + eng.stats["decode_steps"]


def short_requests(s, traffic: str) -> None:
    """8 requests of 16 new tokens past a shared-prefix prompt (motif
    traffic: the first 64 tokens of each prompt), stepped until each has
    only its decode left; the next dispatch decodes."""
    eng, vocab = s.eng, s.vocab
    short = [s.system + torch.randint(0, vocab, (64,), generator=s.g).tolist()
             for _ in range(8)]
    if traffic == "motif":
        short = [p[:64] for p in s.prompts]
    for uid, p in enumerate(short):
        eng.put(100 + uid, p, max_new_tokens=16)
    while any(eng.state.seqs[100 + u].pending_sched > 1 for u in range(8)):
        eng.step()


def finish_short(eng) -> None:
    while any(not eng.query(100 + u).get("done", True) for u in range(8)):
        eng.step()
    for uid in range(8):
        eng.flush(100 + uid)


def event_window(eng) -> dict:
    """One decode step (a window, or a verify round under spec_decode) with
    the pipeline drained first, timed by CUDA events on the stream and by
    the host's clock around ``step()``; no profiler."""
    eng._drain(drain_all=True)
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    steps0 = token_steps(eng)
    h0 = time.perf_counter()
    ev0.record()
    eng.step()
    ev1.record()
    host_ms = 1e3 * (time.perf_counter() - h0)
    torch.cuda.synchronize()
    eng._drain(drain_all=True)
    return {"iters": token_steps(eng) - steps0,
            "device_ms": ev0.elapsed_time(ev1), "host_step_ms": host_ms}


def serve_run(dev, name: str, label: str, layers: int | None = None,
              traffic: str = "shared-prefix", draft: bool = False,
              bitcheck: bool = False, **over) -> dict:
    """The timed serve of :func:`serve_setup`'s engine: 8 requests of
    ``TRAFFIC[traffic]`` through put/step/query/flush, with the default
    ``max_inflight`` (8) unless ``over`` says otherwise, every decode
    program captured beforehand (the serve must capture none). Then 8 short
    requests: ``bitcheck`` holds a window's graph replay against its eager
    run (:func:`graph_vs_eager`), and one decode window is timed by events
    (:func:`event_window`). No profiler runs here: its CUPTI tracing stays
    subscribed once it has run and slows every later launch from the host
    (:func:`serve_profile` profiles, after every timed serve)."""
    tag = f"serve {name} {label}"
    s = serve_setup(dev, tag, name, layers, traffic, draft, over)
    eng, engines, cfg, vocab = s.eng, s.engines, s.cfg, s.vocab
    L, prompts, new = cfg.num_layers, s.prompts, s.new
    graphs = {f"engine {i}": e._programs.stats()
              for i, e in enumerate(engines)}
    for key, g_st in graphs.items():
        log(f"[{tag}] {key}: {g_st['graphs']} captured programs "
            f"({sorted(g_st['replays'])}) in {g_st['capture_s']:.2f} s, "
            f"graph pool {g_st['pool_bytes'] / 1e6:.1f} MB")
    captured0 = [set(e._programs.programs) for e in engines]
    replays0 = [graph_replays(e) for e in engines]
    for e in engines:
        for k in list(e.stats):
            e.stats[k] = 0 if not isinstance(e.stats[k], float) else 0.0
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for uid, p in enumerate(prompts):
        eng.put(uid, p, max_new_tokens=new)
    first: dict[int, float] = {}
    out: dict[int, list[int]] = {u: [] for u in range(len(prompts))}
    window_s = verify_s = 0.0
    top_pos = most_blocks = 0        # the ring's reach, for a ring run
    # the decode tail (no prefill left to dispatch): an event on the stream
    # where the work dispatched before it ends, and the token-steps
    # dispatched since
    tail_ev, end_ev = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
    tail = None
    while any(not eng.query(u).get("done", True) for u in out):
        if tail is None and not eng.scheduler.pending_kinds()[0]:
            tail_ev.record()
            tail = token_steps(eng)
        w0, v0 = eng.stats["windows"], eng.stats["spec_rounds"]
        ts = time.perf_counter()
        emitted = eng.step()
        dt = time.perf_counter() - ts
        if eng.stats["windows"] > w0:
            window_s += dt
        if eng.stats["spec_rounds"] > v0:
            verify_s += dt
        for seq in eng.state.seqs.values():
            top_pos = max(top_pos, len(seq.tokens))
            most_blocks = max(most_blocks, len(seq.blocks))
        now = time.perf_counter() - t0
        for u, toks in emitted.items():
            if toks and u not in first:
                first[u] = now
            out[u].extend(toks)
    end_ev.record()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = all_counts()
    st = dict(eng.stats)
    window_iters = st["window_iters_max"]
    tail_steps = token_steps(eng) - tail if tail is not None else 0
    tail_ms = (tail_ev.elapsed_time(end_ev) / tail_steps if tail_steps
               else None)
    replays = [check_replays(tag + f" engine {i}", e, r0, {})
               for i, (e, r0) in enumerate(zip(engines, replays0))]
    for i, (e, keys) in enumerate(zip(engines, captured0)):
        if set(e._programs.programs) != keys:
            raise AssertionError(
                f"[{tag}] engine {i} captured "
                f"{sorted(set(e._programs.programs) - keys)} during the "
                f"timed serve")
    for u in out:
        if eng.flush(u) != out[u] or len(out[u]) != new:
            raise AssertionError(f"[{tag}] uid {u}: stream of {len(out[u])}")
        if not all(0 <= t < vocab for t in out[u]):
            raise AssertionError(f"[{tag}] uid {u}: token out of range")
    eng.state.audit()
    forwards = forwards_of(eng)
    ring = eng._ring_tokens
    check_launches(tag, launches, cfg, forwards=forwards,
                   e4m3_pool=over.get("kv_cache_dtype") == "fp8",
                   quant=bool(over.get("quant_bits")), ring=bool(ring),
                   verifies=st["spec_rounds"],
                   draft_k1=L * draft_forwards(eng), bf16=True)
    if st["prefix_hit_tokens"] < s.sys_len * len(prompts):
        raise AssertionError(f"[{tag}] prefix cache served "
                             f"{st['prefix_hit_tokens']} tokens")
    if ring:
        nwin = eng.state.max_blocks_per_seq
        if top_pos <= ring or most_blocks > nwin or \
                eng._prefix_cache is not None:
            raise AssertionError(f"[{tag}] ring of {ring} tokens: reached "
                                 f"position {top_pos}, {most_blocks} blocks "
                                 f"> {nwin}, or a prefix cache")
        log(f"[{tag}] ring of {nwin} pages ({ring} tokens): positions up to "
            f"{top_pos} served, at most {most_blocks} pages per sequence")
    spec = spec_stats(eng) if eng._spec is not None else None
    if spec is not None:
        # every verify through K1's tree form, and at least one round: a
        # draft always proposes; prompt lookup probes the committed
        # history, which the "ngram" run (max_inflight 0) keeps current
        if st["attn_cuda_tree"] != spec["spec_rounds"] or \
                spec["spec_rounds"] == 0:
            raise AssertionError(f"[{tag}] verifies {spec}")
        log(f"[{tag}] {spec['spec_rounds']} verify rounds, acceptance "
            f"{spec['spec_accept_rate']:.3f}, {spec['tokens_per_verify']:.2f}"
            f" tokens per verify, K1 tree launches {launches['k1_tree']}, "
            f"draft forwards {draft_forwards(eng)}")
    short_requests(s, traffic)
    bits = graph_vs_eager(tag, eng, dev) if bitcheck else None
    ew = event_window(eng)
    finish_short(eng)
    res = {"options": over, "max_inflight": eng.config.max_inflight,
           "requests": len(prompts),
           "prompt_tokens": sum(s.lens), "new_tokens": new, "wall_s": wall,
           "output_tok_s": len(prompts) * new / wall,
           "ttft_p50_s": statistics.median(first.values()),
           "ttft_max_s": max(first.values()),
           # the decode tail's span on the stream (from the end of the work
           # dispatched before it) over the token-steps dispatched in it
           "decode_ms_per_token": (tail_ms if tail_ms is not None else
                                   1e3 * window_s / max(window_iters, 1)),
           "tail_token_steps": tail_steps,
           # PR 13's measure: the window steps' host wall over their
           # iterations (the same thing while commits were synchronous)
           "window_step_ms_per_iter": 1e3 * window_s / max(window_iters, 1),
           "window_iters": window_iters,
           "window_dispatch_us": 1e6 * st["window_dispatch_s"]
           / max(st["windows"], 1),
           "forced_drains": st["forced_drains"],
           "opportunistic_drains": st["opportunistic_drains"],
           "drain_block_s": st["drain_block_s"],
           "graphs": graphs, "replays": replays, "graph_vs_eager": bits,
           "event_window": ew,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "param_bytes": s.param_bytes, "resident_param_bytes": s.resident,
           "pool_bytes": s.pool_bytes, "launches": launches,
           "forwards": forwards, "stats": st,
           "ring_tokens": ring, "top_position": top_pos,
           "most_blocks": most_blocks, "spec": spec,
           "ms_per_verify_round": (1e3 * verify_s / st["spec_rounds"]
                                   if st["spec_rounds"] else None)}
    log(f"[{tag}] {len(prompts)} requests ({sum(s.lens)} prompt tokens, "
        f"{st['prefix_hit_tokens']} from the prefix cache) x {new} new "
        f"tokens in {wall:.2f}s: {res['output_tok_s']:.1f} output tok/s, "
        f"p50 TTFT {res['ttft_p50_s']:.3f}s, decode "
        f"{res['decode_ms_per_token']:.2f} ms/token-step (the tail's span on "
        f"the stream over its {tail_steps} token-steps)"
        + (f", {res['ms_per_verify_round']:.2f} ms per verify round"
           if res["ms_per_verify_round"] else "")
        + f", peak memory {res['peak_mem_gb']:.1f} GB")
    log(f"[{tag}] pipeline: max_inflight {eng.config.max_inflight}, "
        f"{st['forced_drains']} forced / {st['opportunistic_drains']} "
        f"opportunistic drains ({st['drain_block_s']:.3f} s blocked), "
        f"{res['window_dispatch_us']:.0f} host us a window dispatch, "
        f"window steps {res['window_step_ms_per_iter']:.2f} ms an iteration; "
        f"replays {replays}; an event-timed window of "
        f"{ew['iters']} iterations: {ew['device_ms']:.2f} ms on the stream, "
        f"{ew['host_step_ms']:.2f} ms of host step()")
    log(f"[{tag}] launches {launches} for {L} layers x {forwards} forwards "
        f"({st['prefill_steps']} prefill steps, {st['decode_steps']} decode "
        f"steps, {st['window_iters_max']} window iterations); K1 by kernel: "
        f"chunk {launches['k1_chunk']}, split {launches['k1_split']}")
    del eng, engines, s
    free_cuda()
    return res


def serve_profile(dev, name: str, label: str, layers: int | None = None,
                  traffic: str = "shared-prefix", draft: bool = False,
                  bitcheck: bool = False, **over) -> dict:
    """Where the device time of :func:`serve_run`'s configuration goes, on
    an engine rebuilt alike (same weights, prompts and captures): one
    profiled decode step of the 8 short requests (a window, or a verify
    round under spec_decode), the pipeline drained first; whether the
    profiler named the kernels the graph replayed; then the next window
    timed by events as :func:`serve_run` times it, now with the profiler's
    tracing subscribed. For the long-window traffic also one profiled
    prefill step (:func:`profile_prefill_step`)."""
    tag = f"serve {name} {label}"
    s = serve_setup(dev, tag, name, layers, traffic, draft, over, quiet=True)
    eng = s.eng
    short_requests(s, traffic)
    eng._drain(drain_all=True)      # the window alone on the device
    torch.cuda.synchronize()
    steps0 = token_steps(eng)
    c0 = all_counts()
    prof = device_breakdown(eng.step)
    prof["window_iters"] = token_steps(eng) - steps0
    eng._drain(drain_all=True)
    c1 = all_counts()
    k1_n = c1["k1"] + c1["k1_e4m3"] - c0["k1"] - c0["k1_e4m3"]
    # kernels launched from a graph replay, attributed by name?
    prof["replay_kernels_named"] = bool(k1_n == 0 or prof.get("k1_ms"))
    if not prof["replay_kernels_named"]:
        log(f"[{tag}] the profiler did not attribute the replayed window's "
            f"kernels by name ({k1_n} K1 launches, no K1 time)")
    prof["event_window_after_profile"] = event_window(eng)
    finish_short(eng)
    if traffic == "long-window":
        # where a long-context prefill step's time goes: K1's chunk kernel
        # against the matrix products
        prof["prefill"] = profile_prefill_step(eng, s.vocab, s.g)
    del eng, s
    free_cuda()
    return prof


def log_profile(tag: str, res: dict) -> None:
    """:func:`serve_profile`'s record beside :func:`serve_run`'s event-timed
    window: the idle share of the stream without the profiler (the
    profiled window's busy time per iteration against the event-timed
    window's span)."""
    prof, ew = res["profiled_window"], res["event_window"]
    after = prof["event_window_after_profile"]
    if ew["iters"] and prof.get("busy_ms") and prof["window_iters"]:
        ew["idle_share_est"] = max(0.0, 1 - prof["busy_ms"]
                                   / prof["window_iters"] * ew["iters"]
                                   / ew["device_ms"])
    if "busy_ms" in prof:
        log(f"[{tag}] one profiled decode window ({prof['window_iters']} "
            f"iterations x 8 slots): wall "
            f"{prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} "
            f"ms (idle share {prof['idle_share']:.2f}; of the event-timed "
            f"window's span {ew.get('idle_share_est', float('nan')):.2f}): "
            f"K1 {prof['k1_ms']:.2f} ms, K2 {prof['k2_ms']:.2f} ms, K3 "
            f"{prof['k3_ms']:.2f} ms, K5 {prof['k5_ms']:.2f} ms, matrix "
            f"products {prof['gemm_ms']:.2f} ms, other kernels "
            f"{prof['other_ms']:.2f} ms")
        for name, ms in prof["top"]:
            log(f"[{tag}]   {ms:8.3f} ms  {name[:100]}")
    else:
        log(f"[{tag}] profiled decode window: device time not measured "
            f"(wall {prof['wall_ms']:.2f} ms)")
    log(f"[{tag}] host step() of an event-timed window: "
        f"{ew['host_step_ms']:.2f} ms before any profiler ran, "
        f"{after['host_step_ms']:.2f} ms after one profiled window "
        f"(windows of {ew['iters']} and {after['iters']} iterations: "
        f"{ew['device_ms']:.2f} and {after['device_ms']:.2f} ms on the "
        f"stream)")
    pp = prof.get("prefill")
    if pp is None:
        return
    if "busy_ms" in pp:
        log(f"[{tag}] one profiled prefill step (4 prompts x 256 rows "
            f"at {pp['context']} keys): wall {pp['wall_ms']:.2f} ms, "
            f"device busy {pp['busy_ms']:.2f} ms (idle share "
            f"{pp['idle_share']:.2f}): K1 {pp['k1_ms']:.2f} ms, matrix "
            f"products {pp['gemm_ms']:.2f} ms, other kernels "
            f"{pp['other_ms']:.2f} ms")
        for name, ms in pp["top"]:
            log(f"[{tag}]   {ms:8.3f} ms  {name[:100]}")
    else:
        log(f"[{tag}] profiled prefill step: device time not measured "
            f"(wall {pp['wall_ms']:.2f} ms)")


def profile_prefill_step(eng, vocab: int, g, lens=(4608, 5120, 5632, 6144),
                         chunk: int = 256, past: int = 4096) -> dict:
    """One prefill step of long prompts, profiled: the prompts are put (one
    new token each), the engine steps until every one has more than
    ``past`` keys scheduled and a full chunk still ahead, and the next step
    — one prefill step of len(lens) x ``chunk`` rows at that context — runs
    under ``device_breakdown``. Then the prompts finish and are flushed."""
    uids = [200 + i for i in range(len(lens))]
    for u, n in zip(uids, lens):
        eng.put(u, torch.randint(0, vocab, (n,), generator=g).tolist(),
                max_new_tokens=1)
    seqs = lambda: [eng.state.seqs[u] for u in uids]
    while min(sq.kv_next for sq in seqs()) <= past:
        eng.step()
    if min(sq.pending_sched for sq in seqs()) < chunk:
        raise AssertionError(f"prefill ran past the profiled chunk: "
                             f"{[sq.kv_next for sq in seqs()]}")
    context = [sq.kv_next for sq in seqs()]
    steps0 = eng.stats["prefill_steps"]
    prof = device_breakdown(eng.step)
    if eng.stats["prefill_steps"] != steps0 + 1:
        raise AssertionError("the profiled step was not one prefill step")
    prof["context"] = context
    while any(not eng.query(u).get("done", True) for u in uids):
        eng.step()
    for u in uids:
        eng.flush(u)
    return prof


#: the serve phase's models: (preset, depth — None serves every layer —,
#: the most parameter bytes the int8 and the int4 run may hold against the
#: bf16 run's). qwen2-moe keeps its shared expert and embedding in bf16,
#: so its quantized runs hold more than llama2-7b's (by arithmetic 0.545x
#: and 0.323x)
SERVE = (("llama2-7b", None, 0.55, 0.30),
         ("qwen2-moe-a2.7b", None, 0.56, 0.34))


def serve_runs() -> list[tuple[str, str, str, dict]]:
    """Every serve run: (record key, label, model, serve_run's keyword
    arguments)."""
    runs = []
    for name, layers, _, _ in SERVE:
        check = name == "llama2-7b"
        runs += [(name, "bf16", name, dict(layers=layers, bitcheck=check)),
                 (name, "int8+fp8-pool", name,
                  dict(layers=layers, bitcheck=check, quant_bits=8,
                       kv_cache_dtype="fp8")),
                 (name, "int4", name, dict(layers=layers, quant_bits=4))]
    # mistral-7b past its window, from the rolling ring (bf16 and e4m3
    # pools); llama2-7b's speculative decoding beside spec-off on the same
    # motif traffic. Prompt lookup probes the committed history, which
    # lags the pipeline by up to max_inflight dispatches: the "ngram" run
    # commits synchronously, so that it proposes
    runs += [("mistral-7b ring", "bf16", "mistral-7b",
              dict(traffic="long-window")),
             ("mistral-7b ring", "fp8-pool", "mistral-7b",
              dict(traffic="long-window", kv_cache_dtype="fp8")),
             ("llama2-7b spec", "spec-off", "llama2-7b",
              dict(traffic="motif")),
             ("llama2-7b spec", "ngram", "llama2-7b",
              dict(traffic="motif", spec_decode="ngram", max_inflight=0)),
             ("llama2-7b spec", "draft", "llama2-7b",
              dict(traffic="motif", draft=True, spec_decode="draft"))]
    return runs


def serve_label(key: str, label: str) -> str:
    return (f"{label} ring" if key == "mistral-7b ring" else
            f"motif {label}" if key == "llama2-7b spec" else label)


def phase_serve(dev, profile: bool = False) -> dict:
    """Every timed serve first, then (``profile``: the ``serve-profile``
    phase) every profile: once a profiler has run, its tracing stays
    subscribed in the process and slows every launch from the host, so no
    timed serve follows one."""
    out: dict = {}
    runs = serve_runs()
    for key, label, name, kw in runs:
        out.setdefault(key, {})[label] = serve_run(
            dev, name, serve_label(key, label), **kw)
    for key, label, name, kw in runs if profile else ():
        res = out[key][label]
        res["profiled_window"] = serve_profile(
            dev, name, serve_label(key, label), **kw)
        log_profile(f"serve {name} {serve_label(key, label)}", res)
    for name, _, lim8, lim4 in SERVE:
        runs_ = out[name]
        base = runs_["bf16"]["param_bytes"]
        for label, limit in (("int8+fp8-pool", lim8), ("int4", lim4)):
            ratio = runs_[label]["param_bytes"] / base
            runs_[label]["param_bytes_over_bf16"] = ratio
            log(f"[serve] {name} {label}: parameter bytes {ratio:.3f}x the "
                f"bf16 run's (limit {limit})")
            if ratio > limit:
                raise AssertionError(f"[serve] {name} {label} keeps "
                                     f"{ratio:.3f}x the bf16 parameter "
                                     f"bytes (> {limit})")
    spec = out["llama2-7b spec"]
    for label in ("ngram", "draft"):
        r, off = spec[label], spec["spec-off"]
        log(f"[serve] llama2-7b {label} (max_inflight {r['max_inflight']}) "
            f"vs spec-off (max_inflight {off['max_inflight']}): "
            f"{r['output_tok_s']:.1f} vs {off['output_tok_s']:.1f} output "
            f"tok/s, p50 TTFT {r['ttft_p50_s']:.3f} vs "
            f"{off['ttft_p50_s']:.3f} s, {r['spec']['tokens_per_verify']:.2f}"
            f" tokens per verify at acceptance "
            f"{r['spec']['spec_accept_rate']:.3f}")
    return out


# ---------------------------------------------------------------------------
# K4: flash attention, forward and backward (kernel phase)
# ---------------------------------------------------------------------------

#: K4 against its plain version: fp32 output by max |error| (1e-4), fp32
#: gradients by max |error| over max |plain| (1e-3: dq/dk/dv sum over S keys
#: in another order); bf16 output and gradients by max |error| over max
#: |plain| (2e-2: both round to bf16, the kernel's p never does)
K4_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}
#: (label, B, H, KV, S, D, causal): llama2-7b geometry where the Pallas
#: backward is one block (S = 1024, ``_dqkv_kernel``) and split (2048 — the
#: train phase's shape — and 4096), a seq-2 rank's shape in the seq phase
#: (llama2-7b's 32 heads over 2 ranks, the whole 4096 tokens), mistral-7b's
#: GQA, gpt2-1.3b's head dim 64, and one non-causal call
K4_CASES = (("llama2-7b S=1024", 2, 32, 32, 1024, 128, True),
            ("llama2-7b S=2048", 2, 32, 32, 2048, 128, True),
            ("llama2-7b S=4096", 1, 32, 32, 4096, 128, True),
            ("llama2-7b seq-2 rank S=4096", 1, 16, 16, 4096, 128, True),
            ("mistral-7b GQA S=2048", 2, 32, 8, 2048, 128, True),
            ("gpt2-1.3b S=1024", 4, 32, 32, 1024, 64, True),
            ("llama2-7b S=1024 non-causal", 1, 32, 32, 1024, 128, False))
K4_MAIN = "llama2-7b S=2048"
#: K4's bf16 forward and backward ms at ``K4_MAIN`` as PERF.md has them
#: (this script's kernel phase on an H100 80GB HBM3 at 700 W); the kernel
#: phase prints the run's times against them
K4_PERF_MD_MS = (0.190, 0.699)


def k4_work(B, H, KV, S, D, causal, dtype) -> dict:
    """Bytes and operations of one forward and one backward: each input read
    once and each output written once; 2 x 2 products over the (causally)
    visible query-key pairs forward, 2 x 5 backward (the scores again,
    dP, dV, dQ, dK)."""
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    e = torch.tensor([], dtype=dtype).element_size()
    q_el, kv_el, rows = B * H * S * D, B * KV * S * D, B * H * S
    fwd_bytes = e * (2 * q_el + 2 * kv_el) + 4 * rows
    bwd_bytes = e * (4 * q_el + 4 * kv_el) + 4 * rows
    ops_fwd, ops_bwd = 4.0 * pairs * D, 10.0 * pairs * D
    peak = PEAK_OPS[dtype]
    fwd = bound_of(fwd_bytes, ops_fwd / peak)
    bwd = bound_of(bwd_bytes, ops_bwd / peak)
    return dict(fwd_bytes=fwd_bytes, bwd_bytes=bwd_bytes, fwd_ops=ops_fwd,
                bwd_ops=ops_bwd, fwd_bound_ms=fwd[0], fwd_bound_by=fwd[1],
                bwd_bound_ms=bwd[0], bwd_bound_by=bwd[1])


def k4_run_case(label, B, H, KV, S, D, causal, dtype, dev, seed) -> dict:
    """One K4 case: the forward and backward kernels each counted once and
    no plain launch; out, lse and dq/dk/dv against the plain versions by
    ``K4_TOL``; then the kernel, the plain versions and the SDPA yardstick
    timed. Raises past the tolerance."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    q, k, v, do = rnd(B, H, S, D), rnd(B, KV, S, D), rnd(B, KV, S, D), \
        rnd(B, H, S, D)
    scale = 1.0 / (D ** 0.5)
    before = dict(vars(fa.counts))
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    bumped = {n: c - before[n] for n, c in vars(fa.counts).items()}
    if bumped != {"fwd": 1, "bwd": 1, "plain": 0, "plain_bwd": 0}:
        raise AssertionError(f"K4 {label}: counted {bumped}")
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal, scale)
    refs = fa.flash_bwd_plain(q, k, v, ref_out, ref_lse, do, causal, scale)
    out_tol, grad_tol = K4_TOL[dtype]
    errs = {}
    for name, got, ref in (("out", out, ref_out), ("dq", dq, refs[0]),
                           ("dk", dk, refs[1]), ("dv", dv, refs[2])):
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"K4 {label} {dtype}: non-finite {name}")
        err = (got.float() - ref.float()).abs().max().item()
        mref = ref.float().abs().max().item()
        judged = err if (name == "out" and dtype == torch.float32) \
            else err / mref
        tol = out_tol if name == "out" else grad_tol
        errs[name] = dict(max_abs_err=err, max_abs_ref=mref, judged=judged,
                          tol=tol)
        if judged > tol:
            raise AssertionError(f"K4 {label} {dtype}: {name} error "
                                 f"{judged:.3e} > {tol:.0e} (max abs {err:.3e}"
                                 f" of max |plain| {mref:.3e})")
    lse_err = (lse - ref_lse).abs().max().item()
    if lse_err > 1e-3:
        raise AssertionError(f"K4 {label} {dtype}: lse error {lse_err:.3e}")
    del ref_out, ref_lse, refs
    map_us = {}
    if dtype == torch.bfloat16:
        from deepspeed_tpu_torch.ops import kernels

        lib = kernels.load("flash_attention")
        fa.flash_fwd(q, k, v, causal, scale)
        map_us["fwd"] = lib.ds_flash_attention_map_us()
        fa.flash_bwd(q, k, v, out, lse, do, causal, scale)
        map_us["bwd"] = lib.ds_flash_attention_map_us()
    ms = cuda_time_ms(lambda: fa.flash_fwd(q, k, v, causal, scale), iters=10)
    bwd_ms = cuda_time_ms(
        lambda: fa.flash_bwd(q, k, v, out, lse, do, causal, scale), iters=10)
    plain_ms = cuda_time_ms(lambda: fa.flash_fwd_plain(q, k, v, causal, scale),
                            iters=2, warmup=1, graph=False)
    plain_bwd_ms = cuda_time_ms(
        lambda: fa.flash_bwd_plain(q, k, v, out, lse, do, causal, scale),
        iters=2, warmup=1, graph=False)
    # yardstick: one SDPA call over K/V repeated per q head, forward and
    # forward + backward
    kr = k.repeat_interleave(H // KV, dim=1).requires_grad_()
    vr = v.repeat_interleave(H // KV, dim=1).requires_grad_()
    qr = q.detach().clone().requires_grad_()
    sdpa = lambda: F.scaled_dot_product_attention(q, kr.detach(), vr.detach(),
                                                  is_causal=causal)
    lib_ms = cuda_time_ms(sdpa, iters=10)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal) \
            .backward(do)

    lib_fwd_bwd_ms = cuda_time_ms(sdpa_fwd_bwd, iters=5, warmup=2,
                                  graph=False)
    work = k4_work(B, H, KV, S, D, causal, dtype)
    rates = dict(fwd_tflops=work["fwd_ops"] / (ms * 1e9),
                 bwd_tflops=work["bwd_ops"] / (bwd_ms * 1e9),
                 fwd_bound_share=work["fwd_bound_ms"] / ms,
                 bwd_bound_share=work["bwd_bound_ms"] / bwd_ms)
    rec = dict(case=label, dtype=str(dtype).replace("torch.", ""), B=B, H=H,
               KV=KV, S=S, D=D, causal=causal, errors=errs, lse_err=lse_err,
               ms=ms, bwd_ms=bwd_ms, plain_ms=plain_ms,
               plain_bwd_ms=plain_bwd_ms, library_ms=lib_ms,
               library_fwd_bwd_ms=lib_fwd_bwd_ms, map_us=map_us, **rates,
               **work)
    maps = (f"; maps {map_us['fwd']:.1f} / {map_us['bwd']:.1f} us"
            if map_us else "")
    log(f"[kernel] K4 {label:<28} {rec['dtype']:<8} err out "
        f"{errs['out']['judged']:.2e} dq {errs['dq']['judged']:.2e} dk "
        f"{errs['dk']['judged']:.2e} dv {errs['dv']['judged']:.2e}  fwd "
        f"{ms:.3f} ms {rates['fwd_tflops']:.0f} TFLOP/s, "
        f"{rates['fwd_bound_share']:.1%} of bound {work['fwd_bound_ms']:.3f} "
        f"{work['fwd_bound_by']} (plain {plain_ms:.2f}, sdpa {lib_ms:.3f})  "
        f"bwd {bwd_ms:.3f} ms {rates['bwd_tflops']:.0f} TFLOP/s, "
        f"{rates['bwd_bound_share']:.1%} of bound {work['bwd_bound_ms']:.3f} "
        f"(plain {plain_bwd_ms:.2f}, sdpa fwd+bwd {lib_fwd_bwd_ms:.3f})"
        f"{maps}")
    return rec


def k4_resources(built: dict) -> list:
    """The bf16 tensor-core kernels' registers, stack and spills from the
    build's ``-Xptxas -v`` output (empty when the library was already
    built) and their dynamic shared memory. The register count is the
    launch's; the consumer warpgroups raise theirs to 240 (setmaxnreg)."""
    from deepspeed_tpu_torch.ops import kernels

    lib = kernels.load("flash_attention")
    entries = ptxas_entries(built.get("flash_attention", {}).get("ptxas", ""))
    rows = []
    for which, kern in enumerate(("flash_fwd_tc_kernel", "flash_dq_tc_kernel",
                                  "flash_dkv_tc_kernel")):
        for D in (64, 128, 256):
            found = [v for name, v in entries.items()
                     if kern in name and f"ILi{D}E" in name]
            row = dict(kernel=f"{kern}<{D}>",
                       smem_bytes=lib.ds_flash_attention_tc_smem(which, D),
                       **(found[0] if found else {}))
            rows.append(row)
            row.setdefault("wgmma_serialized", False)
            log(f"[kernel] K4 {row['kernel']:<26} registers "
                f"{row.get('regs', 'not reported')}, stack "
                f"{row.get('stack', '-')} B, spills "
                f"{row.get('spill_stores', '-')} / "
                f"{row.get('spill_loads', '-')} B, shared memory "
                f"{row['smem_bytes']} B, wgmma serialized "
                f"{row['wgmma_serialized']}")
    return rows


def phase_k4(dev, built: dict) -> tuple[dict, dict, list]:
    """K4's tensor-core kernels' resources (``k4_resources``), then K4 at
    every case of ``K4_CASES`` in fp32 and bf16. Returns the forward and
    backward records' fields (errors over every bf16 case and the worst
    fp32 one; times, bound and yardstick of ``K4_MAIN`` in bf16) and the
    cases, the resources first."""
    cases = [{"resources": k4_resources(built)}]
    for i, (label, B, H, KV, S, D, causal) in enumerate(K4_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            cases.append(k4_run_case(label, B, H, KV, S, D, causal, dtype,
                                     dev, seed=100 + i))
            free_cuda()
    bf = [c for c in cases if c.get("dtype") == "bfloat16"]
    f32 = [c for c in cases if c.get("dtype") == "float32"]
    main = next(c for c in bf if c["case"] == K4_MAIN)
    log(f"[kernel] K4 {K4_MAIN} bf16 against PERF.md (forward "
        f"{K4_PERF_MD_MS[0]} / backward {K4_PERF_MD_MS[1]} ms): forward "
        f"{main['ms']:.3f} ms ({main['ms'] / K4_PERF_MD_MS[0]:.3f}x), "
        f"backward {main['bwd_ms']:.3f} ms "
        f"({main['bwd_ms'] / K4_PERF_MD_MS[1]:.3f}x)")

    def errs(names):
        return dict(
            max_abs_err=max(c["errors"][n]["max_abs_err"] for c in bf
                            for n in names),
            max_err_over_max_ref=max(c["errors"][n]["judged"] for c in bf
                                     for n in names),
            max_abs_err_fp32=max(c["errors"][n]["max_abs_err"] for c in f32
                                 for n in names))

    fwd = dict(errs(("out",)), ms=main["ms"], plain_ms=main["plain_ms"],
               bound_ms=main["fwd_bound_ms"], bound_by=main["fwd_bound_by"],
               library_ms=main["library_ms"], tflops=main["fwd_tflops"])
    bwd = dict(errs(("dq", "dk", "dv")), ms=main["bwd_ms"],
               plain_ms=main["plain_bwd_ms"], bound_ms=main["bwd_bound_ms"],
               bound_by=main["bwd_bound_by"],
               library_ms=main["library_fwd_bwd_ms"],
               fwd_bwd_ms=main["ms"] + main["bwd_ms"],
               tflops=main["bwd_tflops"])
    return fwd, bwd, cases


# ---------------------------------------------------------------------------
# K6: block-sparse flash attention; K7: per-layer-slice paged attention
# ---------------------------------------------------------------------------

#: attention widths of the sparse cases: bert-large-uncased's (16 heads of
#: 64) and llama2-7b's (32 heads of 128), with the batch and length each
#: runs at
SPARSE_WIDTHS = {"bert-large": dict(H=16, D=64, B=2, S=4096),
                 "llama2-7b": dict(H=32, D=128, B=1, S=8192)}
#: the sparsity configurations DeepSpeed's sparse attention users pick, each
#: at block 128 with the config's defaults: (label, config, options); the
#: unidirectional one is causal
SPARSE_CONFIGS = (("fixed", "fixed", {}),
                  ("bigbird-per-head", "bigbird",
                   {"different_layout_per_head": True}),
                  ("bslongformer", "bslongformer", {}),
                  ("variable", "variable", {}),
                  ("fixed-causal", "fixed", {"attention": "unidirectional"}))
#: the sparse phase's fp32 parity runs: (width, config label) at S 2048
SPARSE_PARITY = (("bert-large", "bigbird-per-head"),
                 ("llama2-7b", "fixed-causal"))
SPARSE_BLOCK = 128
#: K6's record line reads this case (bf16)
K6_MAIN = "llama2-7b/fixed-causal S=8192"


def sparse_config(label: str, H: int, block: int = SPARSE_BLOCK):
    from deepspeed_tpu_torch.ops.sparse_attention import SPARSITY_CONFIGS

    name, kw = next((c, k) for lab, c, k in SPARSE_CONFIGS if lab == label)
    return SPARSITY_CONFIGS[name](num_heads=H, block=block, **kw)


def k6_holes_layout(H: int, n: int, seed: int):
    """A random layout (density ~0.3, not lower-triangular) with an empty
    query row (0) and a row (1) that sees only the last block, above the
    diagonal: under causal both must give zeros and no gradient."""
    import numpy as np

    layout = np.random.default_rng(seed).random((H, n, n)) < 0.3
    layout[:, 0] = False
    layout[:, 1] = False
    layout[:, 1, n - 1] = True
    return layout


def k6_cases() -> list[dict]:
    """K6's kernel-phase cases: each config of ``SPARSE_CONFIGS`` at
    bert-large width (the bidirectional four) and the causal one at
    llama2-7b width; a dense causal layout at K4's train shape; the holes
    layout; blocks of 256 and of 192."""
    import numpy as np

    cases = []
    bert, llama = SPARSE_WIDTHS["bert-large"], SPARSE_WIDTHS["llama2-7b"]
    for label, _, _ in SPARSE_CONFIGS[:4]:
        cases.append(dict(label=f"bert-large/{label} S={bert['S']}", **bert,
                          block=128, causal=False,
                          layout=sparse_config(label, bert["H"]).make_layout(
                              bert["S"])))
    cases.append(dict(label=K6_MAIN, **llama, block=128, causal=True,
                      layout=sparse_config("fixed-causal", llama["H"])
                      .make_layout(llama["S"])))
    n = 2048 // 128
    cases.append(dict(label="llama2-7b/dense-causal S=2048 (K4's shape)",
                      H=32, D=128, B=2, S=2048, block=128, causal=True,
                      layout=np.ones((32, n, n), bool)))
    cases.append(dict(label="llama2-7b/empty-and-above-diagonal S=2048",
                      H=32, D=128, B=1, S=2048, block=128, causal=True,
                      layout=k6_holes_layout(32, n, seed=11)))
    cases.append(dict(label="bert-large/bigbird-per-head block=256 S=4096",
                      **bert, block=256, causal=False,
                      layout=sparse_config("bigbird-per-head", bert["H"], 256)
                      .make_layout(bert["S"])))
    cases.append(dict(label="bert-large/fixed block=192 S=3072", H=16, D=64,
                      B=2, S=3072, block=192, causal=False,
                      layout=sparse_config("fixed", 16, 192).make_layout(
                          3072)))
    return cases


def k6_work(layout, block, B, H, S, D, causal, dtype) -> dict:
    """K4's convention over the visible token pairs of this layout: 4 x
    pairs x D operations forward, 10 x backward; each input read once and
    each output written once."""
    import numpy as np

    lay = np.asarray(layout, bool)
    n = lay.shape[1]
    if causal:
        qi, kb = np.arange(n)[:, None], np.arange(n)[None]
        per = np.where(kb < qi, block * block,
                       np.where(kb == qi, block * (block + 1) // 2, 0))
        pairs = B * int((lay * per[None]).sum())
    else:
        pairs = B * int(lay.sum()) * block * block
    e = torch.tensor([], dtype=dtype).element_size()
    el, rows = B * H * S * D, B * H * S
    fwd = bound_of(e * 4 * el + 4 * rows, 4.0 * pairs * D / PEAK_OPS[dtype])
    bwd = bound_of(e * 8 * el + 4 * rows, 10.0 * pairs * D / PEAK_OPS[dtype])
    return dict(pairs=pairs, fwd_ops=4.0 * pairs * D,
                bwd_ops=10.0 * pairs * D, fwd_bound_ms=fwd[0],
                fwd_bound_by=fwd[1], bwd_bound_ms=bwd[0], bwd_bound_by=bwd[1])


def k6_resources(built: dict) -> list:
    """K6's wgmma-route kernels (K4's tensor-core bodies instantiated over
    ``TableWalk`` in the block_sparse_attention library): registers, stack,
    spills and any wgmma serialization (ptxas's C7520 note) from the
    build's ``-Xptxas -v`` output (empty when the library was already
    built), and dynamic shared memory (K4's: the same body)."""
    from deepspeed_tpu_torch.ops import kernels

    lib = kernels.load("flash_attention")
    entries = ptxas_entries(
        built.get("block_sparse_attention", {}).get("ptxas", ""))
    rows = []
    for which, kern in enumerate(("flash_fwd_tc_kernel", "flash_dq_tc_kernel",
                                  "flash_dkv_tc_kernel")):
        for D in (64, 128, 256):
            found = [v for name, v in entries.items()
                     if kern in name and f"ILi{D}E" in name]
            row = dict(kernel=f"{kern}<{D}, TableWalk>",
                       smem_bytes=lib.ds_flash_attention_tc_smem(which, D),
                       **(found[0] if found else {}))
            row.setdefault("wgmma_serialized", False)
            rows.append(row)
            log(f"[kernel] K6 {row['kernel']:<37} registers "
                f"{row.get('regs', 'not reported')}, stack "
                f"{row.get('stack', '-')} B, spills "
                f"{row.get('spill_stores', '-')} / "
                f"{row.get('spill_loads', '-')} B, shared memory "
                f"{row['smem_bytes']} B, wgmma serialized "
                f"{row['wgmma_serialized']}")
    return rows


def k6_run_case(case, dtype, dev, seed) -> dict:
    """One K6 case: the forward and the backward (dq + dk/dv kernels) each
    counted once on the route ``kernel_route`` names, no plain launch; out,
    lse and dq/dk/dv against the plain versions by ``K4_TOL``; rows that
    see no key (under causal: none below the diagonal) zeros in out and
    dq; a second launch of each giving the same bits. Then the kernels
    (forward, dq, dk/dv apart and together), the plain versions and, in
    bf16, the SDPA yardstick with the boolean token mask timed, and on a
    dense layout K4 on the same inputs. Raises past the tolerance."""
    import numpy as np
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.sparse_attention import layout_to_mask

    label, layout, block, causal = (case["label"], case["layout"],
                                    case["block"], case["causal"])
    B, H, S, D = case["B"], case["H"], case["S"], case["D"]
    tables = bsa.device_tables(layout, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda sd=1.0: (torch.randn(B, H, S, D, generator=g, device=dev)
                          * sd).to(dtype)
    # q at Q_SD x the keys' spread: a peaked softmax, so a wrong score shows
    q, k, v, do = rnd(Q_SD), rnd(), rnd(), rnd()
    scale = D ** -0.5
    route = bsa.kernel_route(dtype, block)
    tc = int(route == "wgmma")
    before = dict(vars(bsa.counts))
    out, lse = bsa.block_sparse_fwd(q, k, v, tables, block, causal, scale)
    dq, dk, dv = bsa.block_sparse_bwd(q, k, v, out, lse, do, tables, block,
                                      causal, scale)
    torch.cuda.synchronize()
    bumped = {n: c - before[n] for n, c in vars(bsa.counts).items()}
    if bumped != {"fwd": 1, "bwd": 1, "fwd_tc": tc, "bwd_tc": tc,
                  "plain": 0, "plain_bwd": 0}:
        raise AssertionError(f"K6 {label}: counted {bumped} on the {route} "
                             f"route")
    again = bsa.block_sparse_fwd(q, k, v, tables, block, causal, scale)
    again += bsa.block_sparse_bwd(q, k, v, out, lse, do, tables, block,
                                  causal, scale)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), again,
                          (out, lse, dq, dk, dv)):
        if not torch.equal(a, b):
            raise AssertionError(f"K6 {label} {dtype}: a second launch "
                                 f"changed {name}")
    del again
    ref_out, ref_lse = bsa.block_sparse_fwd_plain(q, k, v, tables, block,
                                                  causal, scale)
    refs = bsa.block_sparse_bwd_plain(q, k, v, ref_out, ref_lse, do, tables,
                                      block, causal, scale)
    out_tol, grad_tol = K4_TOL[dtype]
    errs = {}
    for name, got, ref in (("out", out, ref_out), ("dq", dq, refs[0]),
                           ("dk", dk, refs[1]), ("dv", dv, refs[2])):
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"K6 {label} {dtype}: non-finite {name}")
        err = (got.float() - ref.float()).abs().max().item()
        mref = ref.float().abs().max().item()
        judged = err if (name == "out" and dtype == torch.float32) \
            else err / mref
        tol = out_tol if name == "out" else grad_tol
        errs[name] = dict(max_abs_err=err, max_abs_ref=mref, judged=judged,
                          tol=tol)
        if judged > tol:
            raise AssertionError(f"K6 {label} {dtype}: {name} error "
                                 f"{judged:.3e} > {tol:.0e} (max abs {err:.3e}"
                                 f" of max |plain| {mref:.3e})")
    lse_err = (lse - ref_lse).abs().max().item()
    if lse_err > 1e-3:
        raise AssertionError(f"K6 {label} {dtype}: lse error {lse_err:.3e}")
    # rows that see no key: no visible block (or, under causal, none at or
    # below the diagonal)
    lay = np.asarray(layout, bool)
    if causal:
        lay = lay & np.tril(np.ones(lay.shape[1:], bool))[None]
    dead = torch.as_tensor(~lay.any(-1), device=dev).repeat_interleave(
        block, dim=1)                                          # [H, S]
    n_dead = int(dead.sum())
    if n_dead and (out.abs().amax(dim=(0, 3))[dead].max().item() != 0.0
                   or dq.abs().amax(dim=(0, 3))[dead].max().item() != 0.0):
        raise AssertionError(f"K6 {label}: rows that see no key are not 0")
    del ref_out, ref_lse, refs
    dout_c, lse_c, delta = bsa.bwd_operands(q, k, v, out, lse, do)
    args = (tables, block, causal, scale)
    ms = cuda_time_ms(lambda: bsa.block_sparse_fwd(q, k, v, *args), iters=5)
    dq_ms = cuda_time_ms(lambda: bsa.launch_dq(q, k, v, dout_c, lse_c, delta,
                                               *args), iters=5)
    dkv_ms = cuda_time_ms(lambda: bsa.launch_dkv(q, k, v, dout_c, lse_c,
                                                 delta, *args), iters=5)
    bwd_ms = cuda_time_ms(lambda: bsa.block_sparse_bwd(q, k, v, out, lse, do,
                                                       *args), iters=5)
    plain_ms = cuda_time_ms(lambda: bsa.block_sparse_fwd_plain(q, k, v,
                                                               *args),
                            iters=2, warmup=1, graph=False)
    plain_bwd_ms = cuda_time_ms(
        lambda: bsa.block_sparse_bwd_plain(q, k, v, out, lse, do, *args),
        iters=2, warmup=1, graph=False)
    lib_ms = lib_fwd_bwd_ms = k4_ms = k4_bwd_ms = None
    if dtype == torch.bfloat16:
        # yardstick: one SDPA call with the boolean token mask [1, H, S, S]
        mask = layout_to_mask(layout, block, dev)
        if causal:
            mask &= torch.ones(S, S, dtype=torch.bool, device=dev).tril()
        mask = mask[None]
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), iters=5)
        qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask) \
                .backward(do)

        lib_fwd_bwd_ms = cuda_time_ms(sdpa_fwd_bwd, iters=3, warmup=1,
                                      graph=False)
        del mask, qr, kr, vr
        if np.asarray(layout, bool).all():
            # a dense layout is K4's work: K4 on the same inputs
            k4_ms = cuda_time_ms(lambda: fa.flash_fwd(q, k, v, causal, scale),
                                 iters=5)
            k4_bwd_ms = cuda_time_ms(lambda: fa.flash_bwd(
                q, k, v, out, lse, do, causal, scale), iters=5)
    work = k6_work(layout, block, B, H, S, D, causal, dtype)
    rates = dict(fwd_tflops=work["fwd_ops"] / (ms * 1e9),
                 bwd_tflops=work["bwd_ops"] / (bwd_ms * 1e9),
                 fwd_bound_share=work["fwd_bound_ms"] / ms,
                 bwd_bound_share=work["bwd_bound_ms"] / bwd_ms)
    rec = dict(case=label, dtype=str(dtype).replace("torch.", ""), B=B, H=H,
               S=S, D=D, block=block, causal=causal, route=route, **rates,
               density=float(np.asarray(layout, bool).mean()),
               max_blocks_per_row=int(np.asarray(layout, bool).sum(-1).max()),
               dead_rows=n_dead, errors=errs, lse_err=lse_err, ms=ms,
               dq_ms=dq_ms, dkv_ms=dkv_ms, bwd_ms=bwd_ms, plain_ms=plain_ms,
               plain_bwd_ms=plain_bwd_ms, library_ms=lib_ms,
               library_fwd_bwd_ms=lib_fwd_bwd_ms, k4_ms=k4_ms,
               k4_bwd_ms=k4_bwd_ms, **work)
    sdpa = (f", sdpa {lib_ms:.3f} / fwd+bwd {lib_fwd_bwd_ms:.3f} (K6 fwd+bwd "
            f"{(ms + bwd_ms) / lib_fwd_bwd_ms:.2f}x of it)"
            if lib_ms is not None else "")
    k4 = (f", K4 {k4_ms:.3f} / bwd {k4_bwd_ms:.3f} (K6 {ms / k4_ms:.2f}x / "
          f"{bwd_ms / k4_bwd_ms:.2f}x of K4)" if k4_ms is not None else "")
    log(f"[kernel] K6 {label:<44} {rec['dtype']:<8} {route:<5} density "
        f"{rec['density']:.3f} err out {errs['out']['judged']:.2e} dq "
        f"{errs['dq']['judged']:.2e} dk {errs['dk']['judged']:.2e} dv "
        f"{errs['dv']['judged']:.2e}  fwd {ms:.3f} ms "
        f"{rates['fwd_tflops']:.0f} TFLOP/s, {rates['fwd_bound_share']:.1%} "
        f"of bound {work['fwd_bound_ms']:.4f} {work['fwd_bound_by']} (plain "
        f"{plain_ms:.2f})  bwd {bwd_ms:.3f} ms (dq {dq_ms:.3f} + dkv "
        f"{dkv_ms:.3f}) {rates['bwd_tflops']:.0f} TFLOP/s, "
        f"{rates['bwd_bound_share']:.1%} of bound "
        f"{work['bwd_bound_ms']:.4f} (plain {plain_bwd_ms:.2f}){sdpa}{k4}")
    return rec


def phase_k6(dev, built: dict) -> tuple[dict, dict, list]:
    """K6's wgmma kernels' resources (``k6_resources``), then K6 at every
    case of :func:`k6_cases` in bf16 and fp32: every bf16 case at a block
    that is a multiple of 128 must take the wgmma route. Returns the
    forward and backward records' fields (errors over every case; times,
    bound and yardstick of ``K6_MAIN`` in bf16) and the cases, the
    resources first."""
    resources = k6_resources(built)
    results = []
    for i, case in enumerate(k6_cases()):
        for dtype in (torch.bfloat16, torch.float32):
            results.append(k6_run_case(case, dtype, dev, seed=300 + i))
            free_cuda()
    bf = [r for r in results if r["dtype"] == "bfloat16"]
    f32 = [r for r in results if r["dtype"] == "float32"]
    off = [r["case"] for r in bf if r["block"] % 128 == 0
           and r["route"] != "wgmma"]
    if off:
        raise AssertionError(f"K6 bf16 cases off the wgmma route: {off}")
    main = next(r for r in bf if r["case"] == K6_MAIN)
    dense = next(r for r in bf if r["k4_ms"] is not None)
    log(f"[kernel] K6 {K6_MAIN} bf16 forward + backward "
        f"{main['ms'] + main['bwd_ms']:.3f} ms against masked SDPA's "
        f"{main['library_fwd_bwd_ms']:.3f}; dense causal layout {dense['ms']:.3f}"
        f" / {dense['bwd_ms']:.3f} ms against K4's {dense['k4_ms']:.3f} / "
        f"{dense['k4_bwd_ms']:.3f}")

    def errs(names):
        return dict(
            max_abs_err=max(r["errors"][n]["max_abs_err"] for r in bf
                            for n in names),
            max_err_over_max_ref=max(r["errors"][n]["judged"] for r in bf
                                     for n in names),
            max_abs_err_fp32=max(r["errors"][n]["max_abs_err"] for r in f32
                                 for n in names))

    fwd = dict(errs(("out",)), ms=main["ms"], plain_ms=main["plain_ms"],
               bound_ms=main["fwd_bound_ms"], bound_by=main["fwd_bound_by"],
               library_ms=main["library_ms"], tflops=main["fwd_tflops"],
               kernel_route=main["route"])
    bwd = dict(errs(("dq", "dk", "dv")), ms=main["bwd_ms"],
               dq_ms=main["dq_ms"], dkv_ms=main["dkv_ms"],
               plain_ms=main["plain_bwd_ms"], bound_ms=main["bwd_bound_ms"],
               bound_by=main["bwd_bound_by"],
               library_ms=main["library_fwd_bwd_ms"],
               fwd_bwd_ms=main["ms"] + main["bwd_ms"],
               tflops=main["bwd_tflops"], kernel_route=main["route"])
    return fwd, bwd, [{"resources": resources}] + results


@contextlib.contextmanager
def k6_plain_route():
    """K6's wrappers swapped for its plain versions (on any device, counted
    as plain), for the sparse phase's parity reference."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa

    saved = bsa.block_sparse_fwd, bsa.block_sparse_bwd

    def fwd(*a):
        bsa.counts.plain += 1
        return bsa.block_sparse_fwd_plain(*a)

    def bwd(*a):
        bsa.counts.plain_bwd += 1
        return bsa.block_sparse_bwd_plain(*a)

    bsa.block_sparse_fwd, bsa.block_sparse_bwd = fwd, bwd
    try:
        yield
    finally:
        bsa.block_sparse_fwd, bsa.block_sparse_bwd = saved


def sparse_inputs(B, S, H, D, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn(B, S, H, D, generator=g, device=dev) * sd).to(dtype)
            .requires_grad_() for sd in (Q_SD, 1.0, 1.0)]


def phase_sparse(dev) -> dict:
    """``SparseSelfAttention`` end to end on the card: each config of
    ``SPARSE_CONFIGS`` at each width of ``SPARSE_WIDTHS``, bf16, forward and
    ``.backward()`` of a sum-of-squares loss, one warm-up then 5 timed
    iterations; K6 must be launched once forward and once backward per
    call (6 + 6), every launch on the wgmma route, no plain version and no
    other kernel. Prints ms per forward + backward, tokens/s, peak memory
    and ``sparsity()``, then one profiled step's split (K6's share of the
    device's busy time and of the step) and the module's six layout
    copies between [B, S, H, D] and [B, H, S, D] timed alone. Then the
    fp32 parity runs of ``SPARSE_PARITY`` at S 2048: the module's output
    and q/k/v grads through K6 (FMA route) against the plain route on the
    card, by the fp32 ``K4_TOL``."""
    from deepspeed_tpu_torch.ops.sparse_attention import SparseSelfAttention

    iters = 5
    runs = {}
    for wname, w in SPARSE_WIDTHS.items():
        B, S, H, D = w["B"], w["S"], w["H"], w["D"]
        for label, _, _ in SPARSE_CONFIGS:
            tag = f"sparse {wname}/{label} S={S}"
            module = SparseSelfAttention(sparse_config(label, H))
            q, k, v = sparse_inputs(B, S, H, D, torch.bfloat16, dev,
                                    seed=len(runs))
            free_cuda()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()

            def step():
                for t in (q, k, v):
                    t.grad = None
                module(q, k, v).float().square().sum().backward()

            step()                                    # warm-up
            times = []
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                step()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            launches = all_counts()
            want = {n: 0 for n in launches}
            # block 128 in bf16: every launch on the wgmma route
            want.update(k6_fwd=iters + 1, k6_bwd=iters + 1,
                        k6_fwd_tc=iters + 1, k6_bwd_tc=iters + 1)
            if launches != want:
                raise AssertionError(f"[{tag}] launches {launches} != {want}")
            if not all(torch.isfinite(t.grad.float()).all()
                       for t in (q, k, v)):
                raise AssertionError(f"[{tag}] non-finite gradients")
            ms = statistics.mean(times)
            peak = torch.cuda.max_memory_allocated()
            prof = device_breakdown(step)
            if prof.get("device") == "not measured":
                k6_share = "not measured"
            else:
                k6_share = dict(of_busy=prof["k6_ms"] / prof["busy_ms"],
                                of_step=prof["k6_ms"] / ms)
            flat = [t.detach() for t in (q, k, v)]
            flat += [t.transpose(1, 2).contiguous() for t in flat]
            copies_ms = cuda_time_ms(lambda: [t.transpose(1, 2).contiguous()
                                              for t in flat], iters=5)
            del flat
            rec = dict(B=B, S=S, H=H, D=D, ms=ms, times_ms=times,
                       tokens_per_s=B * S / (ms / 1e3), peak_mem_bytes=peak,
                       sparsity=module.sparsity(S), launches=launches,
                       profile=prof, k6_share=k6_share,
                       layout_copies_ms=copies_ms,
                       layout_copies_share=copies_ms / ms)
            runs[f"{wname}/{label}"] = rec
            share = ("not measured" if isinstance(k6_share, str) else
                     f"{k6_share['of_busy']:.1%} of the profiled step's busy "
                     f"time ({prof['k6_ms']:.3f} of {prof['busy_ms']:.3f} "
                     f"ms), {k6_share['of_step']:.1%} of the step")
            log(f"[{tag}] sparsity {rec['sparsity']:.3f}: {ms:.2f} ms per "
                f"forward + backward (B {B}), {rec['tokens_per_s']:.0f} "
                f"tokens/s, peak memory {rec['peak_mem_bytes'] / 1e9:.2f} "
                f"GB; K6 forward {launches['k6_fwd']}, backward "
                f"{launches['k6_bwd']} (wgmma {launches['k6_fwd_tc']} / "
                f"{launches['k6_bwd_tc']}), plain {launches['k6_plain']} / "
                f"{launches['k6_plain_bwd']}; K6 {share}; layout copies "
                f"{copies_ms:.3f} ms ({rec['layout_copies_share']:.1%} of "
                f"the step)")
            del q, k, v, module
    parity = {}
    out_tol, grad_tol = K4_TOL[torch.float32]
    for wname, label in SPARSE_PARITY:
        w = SPARSE_WIDTHS[wname]
        H, D, S = w["H"], w["D"], 2048
        tag = f"sparse-parity {wname}/{label} S={S} fp32"
        module = SparseSelfAttention(sparse_config(label, H))
        got = {}
        for route in ("kernel", "plain"):
            q, k, v = sparse_inputs(1, S, H, D, torch.float32, dev, seed=77)
            reset_counts()
            ctx = k6_plain_route() if route == "plain" else \
                contextlib.nullcontext()
            with ctx:
                out = module(q, k, v)
                out.square().sum().backward()
            torch.cuda.synchronize()
            c = all_counts()
            want = (1, 1, 0, 0) if route == "kernel" else (0, 0, 1, 1)
            if (c["k6_fwd"], c["k6_bwd"], c["k6_plain"],
                    c["k6_plain_bwd"]) != want or c["k6_fwd_tc"] or \
                    c["k6_bwd_tc"]:
                raise AssertionError(f"[{tag}] {route} route counted {c}")
            got[route] = [out.detach(), q.grad, k.grad, v.grad]
        errs = {}
        for name, a, b in zip(("out", "dq", "dk", "dv"), got["kernel"],
                              got["plain"]):
            err = (a - b).abs().max().item()
            judged = err if name == "out" else err / b.abs().max().item()
            tol = out_tol if name == "out" else grad_tol
            errs[name] = judged
            if not judged <= tol:
                raise AssertionError(f"[{tag}] {name} {judged:.3e} > "
                                     f"{tol:.0e}")
        parity[f"{wname}/{label}"] = errs
        log(f"[{tag}] K6 against the plain route on the card: out "
            f"{errs['out']:.2e} (max abs; tol {out_tol:.0e}), dq "
            f"{errs['dq']:.2e} dk {errs['dk']:.2e} dv {errs['dv']:.2e} (of "
            f"max |plain|; tol {grad_tol:.0e})")
        del got, module
        free_cuda()
    return {"runs": runs, "parity": parity,
            "k6_fwd": sum(r["launches"]["k6_fwd"] for r in runs.values()),
            "k6_bwd": sum(r["launches"]["k6_bwd"] for r in runs.values())}


#: K7's record line reads this case (bf16)
K7_MAIN = "llama2-7b/prefill256"


def k7_case(name, *, H, KV, D, bs, T, ctx, dtype, dev, seed, window=None,
            ring_pages=None):
    """Inputs for one K7 case: ``ctx`` lists each slot's context before its
    chunk (-1: an empty slot); the chunk's T tokens are already in the
    pools, so seq_lens = ctx + T and chunk_starts = ctx. Tables are padded
    with the trash page 0; ``ring_pages`` makes each a rolling ring of that
    many pages (``ring_tokens`` = pages x bs)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    S = len(ctx)
    max_pages = ring_pages or max(-(-(c + T) // bs) for c in ctx) + 2
    nb = S * max_pages + 1
    rnd = lambda *shape, sd=1.0: (torch.randn(shape, generator=g, device=dev)
                                  * sd).to(dtype)
    q = rnd(S, T, H, D, sd=Q_SD)
    kp, vp = rnd(KV, nb * bs, D), rnd(KV, nb * bs, D)
    tables = torch.zeros(S, max_pages, dtype=torch.int32)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    lens, starts, used = [], [], 0
    for s, c in enumerate(ctx):
        if c < 0:
            lens.append(0), starts.append(0)
            continue
        n = ring_pages or -(-(c + T) // bs)
        tables[s, :n] = perm[used:used + n].to(torch.int32)
        used += n
        lens.append(c + T), starts.append(c)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    return dict(name=name, q=q, k_pool=kp, v_pool=vp,
                block_tables=tables.to(dev), seq_lens=i32(lens),
                chunk_starts=i32(starts), block_size=bs, window=window,
                ring_tokens=ring_pages * bs if ring_pages else None)


def k7_run_case(case) -> dict:
    """Hold one K7 case against its plain version (counted once as a
    kernel launch of its form, no plain launch; empty slots zeros; live
    slots by ``K1_TOL``), then time the kernel, the plain version and SDPA
    over the gathered K/V with the boolean mask of who sees what. The bound
    counts q, the output and each K/V row some query row of its slot
    sees."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import paged_attention as pa

    label, q = case["name"], case["q"]
    dtype, (S, T, H, D) = q.dtype, q.shape
    KV, bs = case["k_pool"].shape[0], case["block_size"]
    G = H // KV
    args = [case[k] for k in ("q", "k_pool", "v_pool", "block_tables",
                              "seq_lens", "chunk_starts")]
    kw = dict(block_size=bs, window=case["window"],
              ring_tokens=case["ring_tokens"])
    decode = T == 1
    max_pages = case["block_tables"].shape[1]
    route, split_cols = pa.kernel_plan(q, KV, max_pages, bs)
    splits = -(-max_pages * bs // split_cols) if split_cols else 0

    def call():
        if decode:    # through the decode entry: starts = seq_lens - 1
            return pa.paged_decode_attention(q[:, 0], *args[1:5],
                                             **kw)[:, None]
        return pa.paged_prefill_attention(*args, **kw)

    before = dict(vars(pa.prefill_counts))
    got, again = call(), call()
    torch.cuda.synchronize()
    bumped = {n: c - before[n] for n, c in vars(pa.prefill_counts).items()}
    want = {"kernel": 2, "kernel_window": 2 * bool(kw["window"]),
            "kernel_ring": 2 * bool(kw["ring_tokens"]),
            "kernel_chunk": 2 * (route == "chunk"),
            "kernel_split": 2 * (route == "split"), "plain": 0}
    if bumped != want:
        raise AssertionError(f"K7 {label}: counted {bumped}, not {want}")
    if not torch.equal(got, again):
        raise AssertionError(f"K7 {label}: a second launch gave other bits")
    ref = pa.paged_prefill_attention_reference(*args, **kw)
    live = case["seq_lens"] > 0
    if (~live).any() and got[~live].abs().max().item() != 0.0:
        raise AssertionError(f"K7 {label}: empty slot not 0")
    if not torch.isfinite(got).all():
        raise AssertionError(f"K7 {label}: non-finite output")
    err = (got[live].float() - ref[live].float()).abs().max().item()
    max_ref = ref[live].float().abs().max().item()
    judged = err if dtype == torch.float32 else err / max_ref
    tol = K1_TOL[dtype]
    if judged > tol:
        raise AssertionError(f"K7 {label} {dtype}: kernel against plain "
                             f"error {judged:.3e} (tol {tol:.0e}); max abs "
                             f"{err:.3e}")
    del ref
    ms = cuda_time_ms(lambda: pa.paged_prefill_attention(*args, **kw))
    plain_ms = cuda_time_ms(
        lambda: pa.paged_prefill_attention_reference(*args, **kw), iters=2,
        warmup=1, graph=False)
    # SDPA over every table column gathered dense, under the mask of which
    # (run) column each row sees
    _, run, mask = pa.prefill_key_visibility(
        case["block_tables"], case["seq_lens"], case["chunk_starts"], T=T,
        block_size=bs, window=kw["window"], ring_tokens=kw["ring_tokens"])
    mask = mask & run[:, None]
    col = torch.arange(mask.shape[-1], device=q.device)
    rows = case["block_tables"].long()[:, col // bs] * bs + col % bs
    kd = case["k_pool"][:, rows].permute(1, 0, 2, 3).repeat_interleave(
        G, dim=1)
    vd = case["v_pool"][:, rows].permute(1, 0, 2, 3).repeat_interleave(
        G, dim=1)
    qh, m4 = q.permute(0, 2, 1, 3), mask[:, None]
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=m4), iters=5, warmup=1)
    seen = int((mask & live[:, None, None]).any(dim=1).sum())
    el = q.element_size()
    nbytes = 2 * q.numel() * el + 2 * KV * D * seen * el
    ops_s = 4.0 * D * int(mask.sum()) * G * KV / PEAK_OPS[dtype]
    bound, by = bound_of(nbytes, ops_s)
    ops = 4.0 * D * int(mask.sum()) * G * KV
    rec = dict(case=label, dtype=str(dtype).replace("torch.", ""),
               kernel=route, splits=splits,
               max_abs_err=err, judged_err=judged, max_abs_ref=max_ref,
               tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound, bound_by=by, bytes=nbytes, keys_seen=seen,
               tflops=ops / ms * 1e-9, gb_s=nbytes / ms * 1e-6,
               bound_share=bound / ms)
    log(f"[kernel] K7 {label:<34} {rec['dtype']:<8} "
        f"[{route_text(route, splits)}] err {judged:.2e} (tol "
        f"{tol:.0e}; max abs {err:.2e} of max |plain| {max_ref:.2f})  "
        f"kernel {ms:.4f} ms ({rec['tflops']:.1f} TFLOP/s, "
        f"{rec['gb_s']:.0f} GB/s, {rec['bound_share']:.1%} of bound)  plain "
        f"{plain_ms:.3f} ms  sdpa {lib_ms:.3f} ms  bound {bound:.4f} ms "
        f"({by})")
    return rec


def phase_k7(dev) -> tuple[dict, list]:
    """K7 against its plain version at llama2-7b geometry (decode of 8 slots
    at 256-4000 context, a 4 x 256 prefill chunk over 0-768) and mistral-7b
    geometry with its 4096 window, on a linear table and on a wrapped
    69-page ring (decode, a 4 x 256 chunk), in fp32 and bf16. Returns (the
    record's fields, cases); ``launches`` counts the checked calls."""
    llama = dict(H=32, KV=32, D=128)
    shapes = [
        ("llama2-7b/decode", llama, dict(
            T=1, ctx=[255, 700, 1023, 1500, 2047, 3000, 3999, -1])),
        ("llama2-7b/prefill256", llama, dict(T=256, ctx=[0, 256, 512, 768])),
        ("mistral-7b/window-decode", MISTRAL, dict(
            T=1, ctx=[5800, 5905, 6000, 6100, 5999, 6050, 5877, -1],
            window=MISTRAL_WINDOW)),
        ("mistral-7b/window-prefill256", MISTRAL, dict(
            T=256, ctx=[5632, 5760, 5888, 6016], window=MISTRAL_WINDOW)),
        ("mistral-7b/ring-decode", MISTRAL, dict(
            T=1, ctx=[5800, 5905, 6000, 6100, 5999, 6050, 5877, -1],
            window=MISTRAL_WINDOW, ring_pages=MISTRAL_RING_PAGES)),
        ("mistral-7b/ring-prefill256", MISTRAL, dict(
            T=256, ctx=[5632, 5760, 5888, 6016], window=MISTRAL_WINDOW,
            ring_pages=MISTRAL_RING_PAGES)),
    ]
    results = []
    for seed, (dtype, (label, geom, shape)) in enumerate(
            ((dt, s) for dt in (torch.float32, torch.bfloat16)
             for s in shapes), start=500):
        case = k7_case(label, bs=64, dtype=dtype, dev=dev, seed=seed,
                       **geom, **shape)
        results.append(k7_run_case(case))
        del case
        free_cuda()
    bf = [r for r in results if r["dtype"] == "bfloat16"]
    main = next(r for r in bf if r["case"] == K7_MAIN)
    summary = dict(max_abs_err=max(r["max_abs_err"] for r in bf),
                   max_err_over_max_ref=max(r["judged_err"] for r in bf),
                   max_abs_err_fp32=max(r["max_abs_err"] for r in results
                                        if r["dtype"] == "float32"),
                   launches=2 * len(results),
                   **{k: main[k] for k in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")})
    return summary, results


# ---------------------------------------------------------------------------
# train: one-process dense training through the port's engine
# ---------------------------------------------------------------------------

#: the train phase: llama2-7b's width (E 4096, H 32, D 128, F 11008, vocab
#: 32000) at 8 layers (~1.9 B parameters: the full depth with Adam on the
#: card needs ~112 GB of fp32 master, moments and grads; the offload phase
#: trains it with the optimizer state on the host), bf16
#: with an fp32 master, AdamW, micro-batch 2 x gas 2 of 2048 tokens, remat
#: "full", 5 steps on one repeated batch
TRAIN = dict(name="llama2-7b", layers=8, micro=2, gas=2, seq=2048, steps=5)
#: the train parity phase: the same width at 4 layers in fp32 (TF32 off),
#: 1 x 2 sequences of 1024 tokens, 3 steps, K4 against the plain route
TRAIN_PARITY = dict(name="llama2-7b", layers=4, micro=1, gas=2, seq=1024,
                    steps=3)


def train_config(spec: dict, **over) -> dict:
    cfg = {"train_micro_batch_size_per_gpu": spec["micro"],
           "gradient_accumulation_steps": spec["gas"],
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-4, "weight_decay": 0.01}},
           "steps_per_print": 10 ** 9}
    cfg.update(over)
    return cfg


def train_batch_of(spec: dict, vocab: int, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    B = spec["micro"] * spec["gas"]
    return {"input_ids": torch.randint(0, vocab, (B, spec["seq"]),
                                       generator=g)}


def phase_train(dev) -> dict:
    """``initialize`` the train model on the card and take ``TRAIN["steps"]``
    steps; every loss finite and the last below the first; K4's forward
    launched layers x micro-batches x 2 (remat runs each layer's forward
    again) per step, its backward layers x micro-batches, its plain
    versions and every other kernel never. Prints tokens/s and ms per step
    (steps after the first), peak memory, and K4's share of a profiled
    step."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model

    spec = TRAIN
    tag = f"train {spec['name']} x{spec['layers']}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(spec["name"], num_layers=spec["layers"],
                        dtype=torch.bfloat16, param_dtype=torch.float32,
                        device=dev, seed=0)
    engine, *_ = dst.initialize(model=model, config=train_config(
        spec, activation_checkpointing={"policy": "full"}))
    if engine.device != dev or not engine.bf16_enabled:
        raise AssertionError(f"[{tag}] engine on {engine.device}, bf16 "
                             f"{engine.bf16_enabled}")
    batch = train_batch_of(spec, model.config.vocab_size, seed=3)
    tokens = batch["input_ids"].numel()
    setup_s = time.perf_counter() - t0
    L, gas, steps = spec["layers"], spec["gas"], spec["steps"]
    reset_counts()
    losses, step_s = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        step_s.append(time.perf_counter() - ts)
    launches = all_counts()
    want = {k: 0 for k in launches}
    want.update(k4_fwd=L * gas * 2 * steps, k4_bwd=L * gas * steps)
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches} != {want}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] losses {losses}: not finite and "
                             f"falling on a repeated batch")
    peak = torch.cuda.max_memory_allocated()
    ms_step = statistics.mean(step_s[1:]) * 1e3
    prof = device_breakdown(lambda: engine.train_batch(batch))
    k4_share = (prof["k4_ms"] / prof["wall_ms"]
                if prof.get("device") != "not measured" else "not measured")
    rec = dict(params=engine.num_parameters(), tokens_per_step=tokens,
               losses=losses, step_s=step_s, ms_per_step=ms_step,
               tokens_per_s=tokens / (ms_step / 1e3), peak_mem_bytes=peak,
               setup_s=setup_s, launches=launches, profile=prof,
               k4_share_of_step=k4_share)
    log(f"[{tag}] {rec['params'] / 1e9:.2f} B parameters, {tokens} tokens a "
        f"step (micro {spec['micro']} x gas {gas} x {spec['seq']}): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; {ms_step:.1f} ms/step, "
        f"{rec['tokens_per_s']:.0f} tokens/s, peak memory {peak / 1e9:.1f} "
        f"GB; K4 {prof.get('k4_ms', 0.0):.1f} of {prof['wall_ms']:.1f} ms in "
        f"a profiled step (share {k4_share}); launches {launches}")
    engine.close()
    del engine, model
    free_cuda()
    return rec


def phase_train_parity(dev) -> dict:
    """The same width at 4 layers in fp32 with TF32 off, from one seeded
    init and one batch, trained ``TRAIN_PARITY["steps"]`` steps twice: with
    ``attn_impl="pallas"`` (K4, every attention counted) and ``"xla"`` (the
    plain route, K4 never launched). Losses within 1e-5 relative; every
    parameter after the last step within 1e-4 of the largest |parameter|,
    and the two runs' parameter changes within 1e-2 of the largest change
    that training made (three steps move an element by about 3e-4, so the
    first limit alone would pass a wrong update direction). AdamW with eps
    1e-5, so an element whose gradient sits within summation noise of zero
    (the two routes sum in other orders) cannot take a full-size step of
    opposite sign in the two runs."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model

    spec = TRAIN_PARITY
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    L, gas, steps = spec["layers"], spec["gas"], spec["steps"]
    flat = lambda t: [x for v in t.values() for x in
                      (flat(v) if isinstance(v, dict) else [v])]
    runs, masters = {}, {}
    for impl in ("pallas", "xla"):
        tag = f"train parity {spec['name']} x{L} fp32 {impl}"
        model = build_model(spec["name"], num_layers=L, dtype=torch.float32,
                            device=dev, seed=0, attn_impl=impl)
        engine, *_ = dst.initialize(model=model, config=train_config(
            spec, bf16={"enabled": False},
            optimizer={"type": "AdamW",
                       "params": {"lr": 1e-4, "eps": 1e-5,
                                  "weight_decay": 0.01}}))
        batch = train_batch_of(spec, model.config.vocab_size, seed=4)
        if impl == "xla":
            p0 = [x.clone() for x in flat(engine.master)]
        reset_counts()
        losses = [float(engine.train_batch(batch)) for _ in range(steps)]
        launches = all_counts()
        want = {k: 0 for k in launches}
        if impl == "pallas":
            want.update(k4_fwd=L * gas * steps, k4_bwd=L * gas * steps)
        if launches != want:
            raise AssertionError(f"[{tag}] launches {launches} != {want}")
        runs[impl] = dict(losses=losses, launches=launches)
        masters[impl] = engine.master
        log(f"[{tag}] losses {', '.join(f'{x:.6f}' for x in losses)}; "
            f"launches {launches}")
        engine.close()
        del engine, model
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(runs["pallas"]["losses"], runs["xla"]["losses"]))
    pk, px = flat(masters["pallas"]), flat(masters["xla"])
    diff = max((a - b).abs().max().item() for a, b in zip(pk, px))
    scale = max(b.abs().max().item() for b in px)
    moved = max((b - a).abs().max().item() for a, b in zip(p0, px))
    out = dict(runs=runs, max_rel_loss_diff=rel, max_param_diff=diff,
               max_abs_param=scale, max_param_change=moved,
               param_diff_over_change=diff / moved)
    log(f"[train parity] K4 against the plain route: losses within "
        f"{rel:.2e} relative (limit 1e-5), parameters within {diff:.2e} of "
        f"max |param| {scale:.3f} (limit 1e-4 of it); the largest change "
        f"training made is {moved:.3e}, the runs' changes differ by "
        f"{diff / moved:.2e} of it (limit 1e-2)")
    del masters, pk, px, p0
    free_cuda()
    if rel > 1e-5 or diff > 1e-4 * scale or diff > 1e-2 * moved:
        raise AssertionError(f"[train parity] losses {rel:.2e} relative, "
                             f"params {diff:.2e} apart, "
                             f"{diff / moved:.2e} of the largest change")
    return out


# ---------------------------------------------------------------------------
# moe-train: MoE training through the port's engine, K5 forward and backward
# ---------------------------------------------------------------------------

#: the moe-train phase: qwen2-moe-a2.7b's width (E 2048, H 16, 60 experts
#: top-4 of F 1408, a sigmoid-gated shared expert of 5632, vocab 151936, qkv
#: bias) at 4 layers (~2.9 B parameters: its 24 layers with Adam need ~230
#: GB), ``moe.dropless``, bf16 with an fp32 master, AdamW, micro-batch 2 x
#: gas 2 of 2048 tokens, remat "full", 5 steps on one repeated batch
MOE_TRAIN = dict(name="qwen2-moe-a2.7b", layers=4, micro=2, gas=2, seq=2048,
                 steps=5)
#: the moe-train parity phase: the same width at 2 layers in fp32 (TF32
#: off), 1 x 2 sequences of 1024 tokens, 3 steps, K5 against its plain route
MOE_TRAIN_PARITY = dict(name="qwen2-moe-a2.7b", layers=2, micro=1, gas=2,
                        seq=1024, steps=3)


def dropless_model(spec: dict, dev, **over):
    """``spec``'s preset at its depth with ``moe.dropless`` on, seeded."""
    from deepspeed_tpu_torch.models import build_model, get_model_config

    moe = dataclasses.replace(get_model_config(spec["name"]).moe,
                              dropless=True)
    return build_model(spec["name"], num_layers=spec["layers"], moe=moe,
                       device=dev, seed=0, **over)


@contextlib.contextmanager
def k5_plain_route():
    """K5's plain versions on the card, for the parity phase's reference
    run only: the wrappers' kernel launches (forward, dx, dw) swapped for
    the plain versions, counted as plain."""
    from deepspeed_tpu_torch.ops import grouped_matmul as gm

    def fwd(x, w, te, bm, tr):
        gm.counts.plain += 1
        return gm.grouped_matmul_reference(x, w, te, bm, tr)

    def dx(dy, w, te, bm, tr):
        gm.counts.plain_dx += 1
        return gm.grouped_matmul_dx_reference(dy, w, te, bm, tr)

    def dw(x, dy, te, n, bm, tr, dtype):
        gm.counts.plain_dw += 1
        return gm.grouped_matmul_dw_reference(x, dy, te, n, bm, tr, dtype)

    saved = gm._launch_kernel, gm._launch_dx, gm._launch_dw
    gm._launch_kernel, gm._launch_dx, gm._launch_dw = fwd, dx, dw
    try:
        yield
    finally:
        gm._launch_kernel, gm._launch_dx, gm._launch_dw = saved


def phase_moe_train_parity(dev) -> dict:
    """qwen2-moe's width at ``MOE_TRAIN_PARITY["layers"]`` layers in fp32
    (TF32 off) on the dropless route, from one seeded init and one batch,
    trained ``steps`` steps twice: through K5's kernels (forward, dx and dw
    each counted 3 x layers x micro-batches a step) and through K5's plain
    versions on the card (``k5_plain_route``; no K5 kernel launched). K4
    runs every attention in both. Losses within 1e-6 relative; every
    parameter within 1e-4 of the largest |parameter|, and the two runs'
    parameter changes within 1e-2 of the largest change training made.
    AdamW with eps 1e-5 (see ``phase_train_parity``)."""
    import deepspeed_tpu_torch as dst

    spec = MOE_TRAIN_PARITY
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    L, gas, steps = spec["layers"], spec["gas"], spec["steps"]
    flat = lambda t: [x for v in t.values() for x in
                      (flat(v) if isinstance(v, dict) else [v])]
    runs, masters = {}, {}
    for route in ("kernel", "plain"):
        tag = f"moe train parity {spec['name']} x{L} fp32 {route}"
        model = dropless_model(spec, dev, dtype=torch.float32)
        engine, *_ = dst.initialize(model=model, config=train_config(
            spec, bf16={"enabled": False},
            optimizer={"type": "AdamW",
                       "params": {"lr": 1e-4, "eps": 1e-5,
                                  "weight_decay": 0.01}}))
        batch = train_batch_of(spec, model.config.vocab_size, seed=5)
        if route == "plain":
            p0 = [x.clone() for x in flat(engine.master)]
        reset_counts()
        with (k5_plain_route() if route == "plain"
              else contextlib.nullcontext()):
            losses = [float(engine.train_batch(batch)) for _ in range(steps)]
        launches = all_counts()
        per = 3 * L * gas * steps
        want = {k: 0 for k in launches}
        want.update(k4_fwd=L * gas * steps, k4_bwd=L * gas * steps)
        if route == "kernel":
            want.update(k5=per, k5_dx=per, k5_dw=per)
        else:
            want.update(k5_plain=per, k5_plain_dx=per, k5_plain_dw=per)
        if launches != want:
            raise AssertionError(f"[{tag}] launches {launches} != {want}")
        runs[route] = dict(losses=losses, launches=launches)
        masters[route] = engine.master
        log(f"[{tag}] losses {', '.join(f'{x:.6f}' for x in losses)}; "
            f"launches {launches}")
        engine.close()
        del engine, model
        free_cuda()
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(runs["kernel"]["losses"], runs["plain"]["losses"]))
    pk, pp = flat(masters["kernel"]), flat(masters["plain"])
    diff = max((a - b).abs().max().item() for a, b in zip(pk, pp))
    scale = max(b.abs().max().item() for b in pp)
    moved = max((b - a).abs().max().item() for a, b in zip(p0, pp))
    out = dict(runs=runs, max_rel_loss_diff=rel, max_param_diff=diff,
               max_abs_param=scale, max_param_change=moved,
               param_diff_over_change=diff / moved)
    log(f"[moe train parity] K5 against its plain route: losses within "
        f"{rel:.2e} relative (limit 1e-6), parameters within {diff:.2e} of "
        f"max |param| {scale:.3f} (limit 1e-4 of it); the largest change "
        f"training made is {moved:.3e}, the runs' changes differ by "
        f"{diff / moved:.2e} of it (limit 1e-2)")
    del masters, pk, pp, p0
    free_cuda()
    if rel > 1e-6 or diff > 1e-4 * scale or diff > 1e-2 * moved:
        raise AssertionError(f"[moe train parity] losses {rel:.2e} relative, "
                             f"params {diff:.2e} apart, "
                             f"{diff / moved:.2e} of the largest change")
    return out


def phase_moe_train(dev) -> dict:
    """``initialize`` the ``MOE_TRAIN`` model on the card and take its steps;
    every loss finite and the last below the first. Launches per run: K5's
    forward 3 products x layers x micro-batches x 2 (remat runs each
    layer's forward again) x steps, its dx and dw 3 x layers x
    micro-batches x steps; K4's forward layers x micro-batches x 2 x steps,
    its backward layers x micro-batches x steps; no plain version and no
    other kernel. Prints ms per step, tokens/s, peak memory, the loss curve
    and one profiled step's split (K4, K5 forward / dx / dw, cuBLAS, other,
    idle share)."""
    import deepspeed_tpu_torch as dst

    spec = MOE_TRAIN
    tag = f"moe train {spec['name']} x{spec['layers']}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = dropless_model(spec, dev, dtype=torch.bfloat16,
                           param_dtype=torch.float32)
    engine, *_ = dst.initialize(model=model, config=train_config(
        spec, activation_checkpointing={"policy": "full"}))
    if engine.device != dev or not engine.bf16_enabled:
        raise AssertionError(f"[{tag}] engine on {engine.device}, bf16 "
                             f"{engine.bf16_enabled}")
    batch = train_batch_of(spec, model.config.vocab_size, seed=6)
    tokens = batch["input_ids"].numel()
    setup_s = time.perf_counter() - t0
    L, gas, steps = spec["layers"], spec["gas"], spec["steps"]
    reset_counts()
    losses, step_s = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        step_s.append(time.perf_counter() - ts)
    launches = all_counts()
    passes = L * gas * steps
    want = {k: 0 for k in launches}
    # every K5 launch of the bf16 run takes the wgmma route
    want.update(k5=3 * passes * 2, k5_dx=3 * passes, k5_dw=3 * passes,
                k5_tc=3 * passes * 2, k5_dx_tc=3 * passes,
                k5_dw_tc=3 * passes, k4_fwd=passes * 2, k4_bwd=passes)
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches} != {want}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] losses {losses}: not finite and "
                             f"falling on a repeated batch")
    peak = torch.cuda.max_memory_allocated()
    ms_step = statistics.mean(step_s[1:]) * 1e3
    prof = device_breakdown(lambda: engine.train_batch(batch))
    rec = dict(params=engine.num_parameters(), tokens_per_step=tokens,
               losses=losses, step_s=step_s, ms_per_step=ms_step,
               tokens_per_s=tokens / (ms_step / 1e3), peak_mem_bytes=peak,
               setup_s=setup_s, launches=launches, profile=prof)
    split = ("not measured" if prof.get("device") == "not measured" else
             ", ".join(f"{k[:-3]} {prof[k]:.1f}" for k in (
                 "k4_ms", "k5_ms", "k5_dx_ms", "k5_dw_ms", "gemm_ms",
                 "other_ms")) + f" of {prof['wall_ms']:.1f} ms wall, idle "
             f"{prof['idle_share']:.3f}")
    log(f"[{tag}] {rec['params'] / 1e9:.2f} B parameters, {tokens} tokens a "
        f"step (micro {spec['micro']} x gas {gas} x {spec['seq']}): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; {ms_step:.1f} ms/step, "
        f"{rec['tokens_per_s']:.0f} tokens/s, peak memory {peak / 1e9:.1f} "
        f"GB; profiled step (ms): {split}; launches {launches}")
    engine.close()
    del engine, model
    free_cuda()
    return rec


# ---------------------------------------------------------------------------
# zero: ZeRO stages 1-3 over NCCL, checkpoints that reshard, the rewind
# ---------------------------------------------------------------------------

#: (a)-(c): llama2-7b width at 2 layers, bf16 with an fp32 master, AdamW
#: (wd 0.01), micro 1 x gas 2 x 1024, remat "full"
ZERO_PARITY = dict(name="llama2-7b", layers=2, micro=1, gas=2, seq=1024,
                   steps=3)
#: (d): the two CPU ranks' run
ZERO_CPU = dict(name="tiny-llama", micro=2, gas=2, seq=32, steps=2)
#: (f): qwen2-moe width at 2 layers, dropless, bf16
ZERO_MOE = dict(name="qwen2-moe-a2.7b", layers=2, micro=1, gas=2, seq=1024,
                steps=2)
#: where (b) writes its checkpoint (inside the checkout; removed after)
ZERO_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "zero_ckpt.tmp")


def zero_config(spec: dict, stage: int, **over) -> dict:
    return train_config(
        spec, activation_checkpointing={"policy": "full"},
        zero_optimization={"stage": stage}, **over)


def zero_data(spec: dict, vocab: int, batches: int, seed: int) -> dict:
    """``batches`` global batches of seeded tokens, for a loader whose
    ``batch_for_step`` is the data position of a resume and a rewind."""
    g = torch.Generator().manual_seed(seed)
    rows = spec["micro"] * spec["gas"] * batches
    return {"input_ids": torch.randint(0, vocab, (rows, spec["seq"]),
                                       generator=g).numpy()}


def zero_engine(spec: dict, dev, stage: int, **over):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model

    model = build_model(spec["name"], num_layers=spec["layers"],
                        dtype=torch.bfloat16, param_dtype=torch.float32,
                        device=dev, seed=0)
    return dst.initialize(model=model, config=zero_config(spec, stage,
                                                          **over))[0]


def zero_steps(engine, loader, until: int) -> list[float]:
    """Train until ``global_steps == until`` on the loader's batches, the
    data position re-derived from ``global_steps`` (a rewind replays)."""
    losses = []
    while engine.global_steps < until:
        loss = float(engine.train_batch(
            loader.batch_for_step(engine.global_steps)))
        if engine.last_step_rewound:
            losses.append(("rewound", loss))
            continue
        losses.append(loss)
    return losses


def zero_check_launches(tag: str, got: dict, L: int, gas: int, steps: int,
                        **extra) -> None:
    want = {k: 0 for k in got}
    want.update(k4_fwd=L * gas * 2 * steps, k4_bwd=L * gas * steps, **extra)
    if got != want:
        raise AssertionError(f"[{tag}] launches {got} != {want}")


def zero_cpu_rank(d: str) -> float:
    """One of two CPU gloo ranks: tiny-llama in fp32 at stage 3 over
    ``{"fsdp": 2}``, ``ZERO_CPU["steps"]`` steps, saved to ``d``; returns
    the eval loss of the batch (d) evaluates on the card."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model

    spec = ZERO_CPU
    model = build_model(spec["name"], device="cpu", dtype=torch.float32,
                        seed=0)
    cfg = train_config(spec, bf16={"enabled": False},
                       zero_optimization={"stage": 3}, mesh={"fsdp": 2})
    engine = dst.initialize(model=model, config=cfg, device="cpu")[0]
    data = zero_data(dict(spec, micro=spec["micro"] * 2), 256, spec["steps"],
                     seed=11)
    loader = engine.deepspeed_io(data, shuffle=False)
    for step in range(spec["steps"]):
        engine.train_batch(loader.batch_for_step(step))
    engine.save_checkpoint(d)
    loss = float(engine.eval_batch(zero_data(spec, 256, 1, seed=12)))
    engine.close()
    return loss


def phase_zero(dev, train: dict | None = None) -> dict:
    """See the module docstring, phase 9. ``train`` is the train phase's
    record of this run, for (e)'s comparison."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.checkpoint import (
        get_fp32_state_dict_from_zero_checkpoint, tag_status)

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    comm.init_distributed()
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"[zero] process group {dist.get_backend()} of "
                             f"{dist.get_world_size()}")
    free_cuda()
    rec: dict = {"launches": {}}

    def add_launches(got):
        for k, v in got.items():
            rec["launches"][k] = rec["launches"].get(k, 0) + v

    # (a) stage parity, (b) the checkpoint, (c) the rewind ----------------
    spec = ZERO_PARITY
    L, gas, steps = spec["layers"], spec["gas"], spec["steps"]
    tag = f"zero {spec['name']} x{L}"
    vocab = 32000
    data = zero_data(spec, vocab, 6, seed=7)
    ref = None
    runs = {}
    shutil.rmtree(ZERO_CKPT, ignore_errors=True)
    os.makedirs(ZERO_CKPT)
    ckpt = {}
    for stage in (0, 1, 2, 3):
        engine = zero_engine(spec, dev, stage)
        loader = engine.deepspeed_io(data, shuffle=False)
        reset_counts()
        if stage == 3:
            # save at step 2, then take step 3
            losses = zero_steps(engine, loader, 2)
            ckpt["free_disk_bytes"] = shutil.disk_usage(ZERO_CKPT).free
            master2 = engine._full_master()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.save_checkpoint(ZERO_CKPT)
            ckpt["save_s"] = time.perf_counter() - t0
            losses += zero_steps(engine, loader, 3)
        else:
            losses = zero_steps(engine, loader, steps)
        launches = all_counts()
        zero_check_launches(f"{tag} stage {stage}", launches, L, gas, steps)
        add_launches(launches)
        master = engine._full_master()
        runs[stage] = losses
        if ref is None:
            ref = (losses, master)
        elif losses != ref[0] or not all(
                torch.equal(a, b) for a, b in zip(master, ref[1])):
            raise AssertionError(f"[{tag}] stage {stage} losses {losses} "
                                 f"against stage 0's {ref[0]}, or its "
                                 f"master differs")
        log(f"[{tag}] stage {stage}: losses "
            f"{', '.join(repr(x) for x in losses)} (bit for bit stage 0's); "
            f"launches k4 {launches['k4_fwd']} / {launches['k4_bwd']}")
        if stage != 3:
            engine.close()
            del engine, master
            free_cuda()
    stage3_master = ref[1]
    del ref, master
    engine.close()
    del engine
    free_cuda()
    rec["stages"] = runs
    clip = {}
    for stage in (0, 3):
        engine = zero_engine(spec, dev, stage, gradient_clipping=1.0)
        loader = engine.deepspeed_io(data, shuffle=False)
        reset_counts()
        clip[stage] = zero_steps(engine, loader, steps)
        got = all_counts()
        zero_check_launches(f"{tag} clipped stage {stage}", got, L, gas,
                            steps)
        add_launches(got)
        engine.close()
        del engine
        free_cuda()
    clip_rel = max(abs(a - b) / abs(b) for a, b in zip(clip[3], clip[0]))
    log(f"[{tag}] clipping 1.0: stage 0 {clip[0]}, stage 3 {clip[3]}: "
        f"{clip_rel:.2e} relative (limit 1e-6)")
    if clip_rel > 1e-6:
        raise AssertionError(f"[{tag}] clipped losses {clip_rel:.2e} apart")
    rec["clipping"] = {"losses": clip, "max_rel": clip_rel}

    # (b) a fresh stage-1 engine loads stage 3's step-2 tag
    path = os.path.join(ZERO_CKPT, "global_step2")
    ckpt["bytes"] = sum(os.path.getsize(os.path.join(dp, f))
                        for dp, _, fs in os.walk(path) for f in fs)
    t0 = time.perf_counter()
    status, why = tag_status(path, "crc32")
    ckpt["verify_s"] = time.perf_counter() - t0
    if status != "verified":
        raise AssertionError(f"[{tag}] saved tag {status}: {why}")
    sd = get_fp32_state_dict_from_zero_checkpoint(ZERO_CKPT)
    engine = zero_engine(spec, dev, 1)
    names = engine._names
    if set(sd) != set(names) or not all(
            torch.equal(torch.from_numpy(sd[n]).to(dev), m)
            for n, m in zip(names, master2)):
        raise AssertionError(f"[{tag}] zero_to_fp32 state differs from the "
                             f"step-2 master")
    del sd, master2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.load_checkpoint(ZERO_CKPT)
    torch.cuda.synchronize()
    ckpt["load_s"] = time.perf_counter() - t0
    loader = engine.deepspeed_io(data, shuffle=False)
    resumed = zero_steps(engine, loader, 3)
    if resumed != runs[3][2:] or not all(
            torch.equal(a, b) for a, b in zip(engine._full_master(),
                                              stage3_master)):
        raise AssertionError(f"[{tag}] resumed step 3 {resumed} against "
                             f"{runs[3][2:]}, or its master differs")
    clean = resumed + zero_steps(engine, loader, 5)
    engine.close()
    del engine, stage3_master
    free_cuda()
    log(f"[{tag}] checkpoint at step 2 (stage 3 → stage 1): "
        f"{ckpt['bytes'] / 1e9:.3f} GB on disk ({ckpt['free_disk_bytes'] / 1e9:.1f} "
        f"GB free before), save {ckpt['save_s']:.2f} s, crc32 verify "
        f"{ckpt['verify_s']:.2f} s, load {ckpt['load_s']:.2f} s; the resumed "
        f"step 3 is bit for bit stage 3's")
    rec["checkpoint"] = ckpt

    # (c) the rewind: a NaN at step 4 rewinds to the step-2 tag
    engine = zero_engine(spec, dev, 3, resilience={
        "fault_injection": {"nan_grads_step": 4}, "max_consecutive_bad": 1,
        "rewind_dir": ZERO_CKPT})
    engine.load_checkpoint(ZERO_CKPT)
    loader = engine.deepspeed_io(data, shuffle=False)
    trace = zero_steps(engine, loader, 5)
    counters = engine.resilience_counters
    replayed = [x for x in trace if not isinstance(x, tuple)]
    rewound = [x for x in trace if isinstance(x, tuple)]
    if counters["rewinds"] != 1 or len(rewound) != 1 or \
            replayed[-3:] != clean or engine.global_steps != 5:
        raise AssertionError(f"[{tag}] rewind: trace {trace}, counters "
                             f"{counters}, clean {clean}")
    log(f"[{tag}] rewind: steps {trace} (NaN at step 4 → back to step 2); "
        f"counters {counters}; steps 3-5 after it bit for bit the clean "
        f"run's {clean}")
    rec["rewind"] = {"trace": [list(x) if isinstance(x, tuple) else x
                               for x in trace], "clean": clean,
                     "counters": counters}
    engine.close()
    del engine
    free_cuda()
    shutil.rmtree(ZERO_CKPT)

    # (d) two CPU ranks save; the card loads -------------------------------
    with tempfile.TemporaryDirectory(dir=os.path.dirname(ZERO_CKPT)) as d:
        evals = rank_pool(2).run(zero_cpu_rank, os.path.join(d, "ck"))
        import deepspeed_tpu_torch as dst
        from deepspeed_tpu_torch.models import build_model

        model = build_model("tiny-llama", device=dev, dtype=torch.float32)
        engine = dst.initialize(model=model, config=train_config(
            ZERO_CPU, bf16={"enabled": False},
            zero_optimization={"stage": 1}))[0]
        engine.load_checkpoint(os.path.join(d, "ck"))
        got = float(engine.eval_batch(zero_data(ZERO_CPU, 256, 1, seed=12)))
        step = float(engine.train_batch(zero_data(ZERO_CPU, 256, 1,
                                                  seed=13)))
        rel = abs(got - evals[0]) / abs(evals[0])
        log(f"[zero cpu→card] 2 gloo ranks (stage 3, fsdp 2) saved at step "
            f"{engine.global_steps - 1}; eval loss {evals} on the CPU, "
            f"{got} on the card at stage 1 ({rel:.2e} relative, limit "
            f"1e-5); a further step's loss {step}")
        if evals[0] != evals[1] or rel > 1e-5 or not math.isfinite(step):
            raise AssertionError(f"[zero cpu→card] evals {evals} / {got}, "
                                 f"step {step}")
        rec["cpu_to_card"] = {"cpu_eval": evals, "card_eval": got,
                              "rel": rel, "next_step": step}
        engine.close()
        del engine, model

    # (e) stage 3 at the train phase's spec, beside stage 0 timed alike ----
    spec = TRAIN
    L, gas, steps = spec["layers"], spec["gas"], spec["steps"]
    tag = f"zero {spec['name']} x{L}"
    batch = train_batch_of(spec, vocab, seed=3)
    tokens = batch["input_ids"].numel()
    e_rec = {}
    for stage in (0, 3):
        free_cuda()
        before = torch.cuda.memory_allocated()
        engine = zero_engine(spec, dev, stage)
        state = torch.cuda.memory_allocated() - before
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, step_s = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            step_s.append(time.perf_counter() - ts)
        launches = all_counts()
        zero_check_launches(f"{tag} stage {stage}", launches, L, gas, steps)
        add_launches(launches)
        if train is not None and (launches["k4_fwd"], launches["k4_bwd"]) \
                != (train["launches"]["k4_fwd"], train["launches"]["k4_bwd"]):
            raise AssertionError(f"[{tag}] K4 launches differ from the train "
                                 f"phase's")
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"[{tag}] stage {stage} losses {losses}")
        # the steps' peak, less what was allocated before the engine
        peak = torch.cuda.max_memory_allocated() - before
        ms_step = statistics.mean(step_s[1:]) * 1e3
        r = dict(losses=losses, step_s=step_s, ms_per_step=ms_step,
                 tokens_per_s=tokens / (ms_step / 1e3), peak_mem_bytes=peak,
                 state_bytes=state, allocated_before=before,
                 launches=launches)
        if stage == 3:
            # profiled last: a profiler session slows later host work
            r["profile"] = prof = device_breakdown(
                lambda: engine.train_batch(batch))
            r["zero_counts"] = dict(engine._zero.counts)
            split = ("not measured" if prof.get("device") == "not measured"
                     else ", ".join(f"{k[:-3]} {prof.get(k, 0.0):.1f}"
                                    for k in ("k4_ms", "gemm_ms", "zero_ms",
                                              "other_ms"))
                     + f" of {prof['wall_ms']:.1f} ms wall, idle "
                     f"{prof['idle_share']:.3f}")
        log(f"[{tag}] stage {stage}: {tokens} tokens a step, losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}; {ms_step:.1f} "
            f"ms/step, {r['tokens_per_s']:.0f} tokens/s, peak memory "
            f"{peak / 1e9:.2f} GB in the steps (state after set-up "
            f"{state / 1e9:.2f} GB; {before / 1e9:.2f} GB held before it)"
            + (f"; profiled step (ms): {split}" if stage == 3 else ""))
        e_rec[stage] = r
        engine.close()
        del engine
    free_cuda()
    if e_rec[0]["losses"] != e_rec[3]["losses"]:
        raise AssertionError(f"[{tag}] stage 3 losses {e_rec[3]['losses']} "
                             f"against stage 0's {e_rec[0]['losses']}")
    if train is not None:
        log(f"[{tag}] the train phase (stage 0) of this run: "
            f"{train['ms_per_step']:.1f} ms/step, {train['tokens_per_s']:.0f} "
            f"tokens/s, peak {train['peak_mem_bytes'] / 1e9:.2f} GB")
    log(f"[{tag}] stage 3 / stage 0: ms/step x"
        f"{e_rec[3]['ms_per_step'] / e_rec[0]['ms_per_step']:.3f}, peak "
        f"memory {(e_rec[3]['peak_mem_bytes'] - e_rec[0]['peak_mem_bytes']) / 1e9:+.2f} GB")
    rec["stage3_train"] = e_rec

    # (f) MoE: stage 0 against stage 3 ---------------------------------------
    spec = ZERO_MOE
    L, gas, steps = spec["layers"], spec["gas"], spec["steps"]
    tag = f"zero {spec['name']} x{L} dropless"
    moe = {}
    for stage in (0, 3):
        import deepspeed_tpu_torch as dst

        model = dropless_model(spec, dev, dtype=torch.bfloat16,
                               param_dtype=torch.float32)
        engine = dst.initialize(model=model,
                                config=zero_config(spec, stage))[0]
        batch = train_batch_of(spec, model.config.vocab_size, seed=6)
        reset_counts()
        moe[stage] = [float(engine.train_batch(batch)) for _ in range(steps)]
        got = all_counts()
        per = 3 * L * gas * steps
        zero_check_launches(f"{tag} stage {stage}", got, L, gas, steps,
                            k5=per * 2, k5_tc=per * 2, k5_dx=per,
                            k5_dx_tc=per, k5_dw=per, k5_dw_tc=per)
        add_launches(got)
        engine.close()
        del engine, model
        free_cuda()
    log(f"[{tag}] stage 0 {moe[0]}, stage 3 {moe[3]}: bit for bit; every K5 "
        f"launch on the wgmma route")
    if moe[0] != moe[3]:
        raise AssertionError(f"[{tag}] losses {moe}")
    rec["moe"] = moe
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[zero] phase {rec['seconds']:.1f} s; launches {rec['launches']}")
    return rec


# ---------------------------------------------------------------------------
# phase 11: offload (ZeRO-Offload, ZeRO-Infinity, the fused head and the
# activation-offload remat policy)
# ---------------------------------------------------------------------------

#: (a): llama2-7b at full width and depth, bf16 with an fp32 master, AdamW,
#: micro 2 x gas 2 x 2048, remat "full", ZeRO stage 2 at world 1 over NCCL,
#: the optimizer state on the host, 2 steps on one repeated batch
OFFLOAD = dict(name="llama2-7b", layers=32, micro=2, gas=2, seq=2048,
               steps=2)
#: (b), (c), (e): the same width at 2 layers, 2 steps (then a third after
#: the checkpoint)
OFFLOAD_SMALL = dict(OFFLOAD, layers=2, steps=2)
#: (d): ZeRO-Infinity at 8 layers, 2 steps
OFFLOAD_STREAM = dict(OFFLOAD, layers=8, steps=2)
#: host memory kept free beyond the offloaded state
HOST_MARGIN = 10e9
#: where (b) swaps and (e) saves (inside the checkout; removed after)
OFFLOAD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "offload.tmp")


def mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def param_count(name: str, layers: int) -> int:
    """Parameters of a dense preset at ``layers`` layers, from its config."""
    from deepspeed_tpu_torch.models import get_model_config

    c = get_model_config(name)
    E, H, KV, D, F = (c.hidden_size, c.num_heads, c.kv_heads, c.head_dim,
                      c.ffn_size)
    block = 2 * E * H * D + 2 * E * KV * D + 3 * E * F + 2 * E
    root = c.vocab_size * E * (1 if c.tie_embeddings else 2) + E
    return layers * block + root


def vocab_of(spec: dict) -> int:
    from deepspeed_tpu_torch.models import get_model_config

    return get_model_config(spec["name"]).vocab_size


def offload_depth(spec: dict, avail: int) -> tuple[int, str]:
    """The deepest cut of ``spec`` whose host state (fp32 master and two
    moments, 12 bytes a parameter, plus the pinned staging ring) leaves
    ``HOST_MARGIN`` of MemAvailable: the full depth when it fits."""
    from deepspeed_tpu_torch.runtime.zero.offload import RING, TILE

    ring = RING * TILE * 6
    need = lambda L: 12 * param_count(spec["name"], L) + ring + HOST_MARGIN
    L = spec["layers"]
    while L > 1 and need(L) > avail:
        L -= 1
    why = (f"full depth: {need(L) / 1e9:.1f} GB of host state + margin fit "
           f"MemAvailable {avail / 1e9:.1f} GB") if L == spec["layers"] \
        else (f"cut from {spec['layers']} to {L} layers: MemAvailable "
              f"{avail / 1e9:.1f} GB holds {need(L) / 1e9:.1f} GB of host "
              f"state + margin, {spec['layers']} layers need "
              f"{need(spec['layers']) / 1e9:.1f} GB")
    return L, why


def offload_engine(spec: dict, dev, layers: int, zero: dict, **over):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model

    model = build_model(spec["name"], num_layers=layers,
                        dtype=torch.bfloat16, param_dtype=torch.float32,
                        device=dev, seed=0)
    cfg = train_config(spec, activation_checkpointing={"policy": "full"},
                       zero_optimization=zero, **over)
    return dst.initialize(model=model, config=cfg)[0]


def host_opt_split(ho, fwd_bwd_s: float) -> dict:
    """The host step's split (``HostOffloadOptimizer.last_step``) as rates
    and hidden shares: device-to-host gradients, the host Adam (28 bytes an
    element: p, m, v and g read, p, m, v written), the bf16 cast (6 bytes)
    and the host-to-device copies; a copy's hidden share is the part of its
    device time the host did not spend waiting for it."""
    st = dict(ho.last_step)
    n = st["host_elements"]
    d2h_s, h2d_s = st.get("d2h_ms", 0.0) / 1e3, st.get("h2d_ms", 0.0) / 1e3
    return {
        "device_fwd_bwd_s": fwd_bwd_s, "host_step_s": st["seconds"],
        "d2h_GB": st["d2h_bytes"] / 1e9, "d2h_s": d2h_s,
        "d2h_GBps": st["d2h_bytes"] / d2h_s / 1e9 if d2h_s else None,
        "d2h_hidden": 1 - st["wait_d2h"] / d2h_s if d2h_s else None,
        "adam_s": st["adam"], "adam_GBps": 28 * n / st["adam"] / 1e9,
        "cast_s": st["cast"], "cast_GBps": 6 * n / st["cast"] / 1e9,
        "h2d_GB": st["h2d_bytes"] / 1e9, "h2d_s": h2d_s,
        "h2d_GBps": st["h2d_bytes"] / h2d_s / 1e9 if h2d_s else None,
        "h2d_hidden": 1 - st["wait_h2d"] / h2d_s if h2d_s else None,
        "nvme_wait_s": st["nvme_wait"], "tiles": st["tiles"]}


def offload_steps(engine, batch, steps: int) -> tuple[list, list, list]:
    """``steps`` timed steps: (losses, wall seconds, host-step splits). The
    host optimizer's step is wrapped to mark where the device's forward
    and backward ended (a synchronize there costs nothing: the host step
    waits for the gradients' copies anyway)."""
    ho = engine._host_opt
    inner = ho.step
    mark = {}

    def timed(zero, lr):
        torch.cuda.synchronize()
        mark["host"] = time.perf_counter()
        inner(zero, lr)

    ho.step = timed
    losses, walls, splits = [], [], []
    try:
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            splits.append(host_opt_split(ho, mark["host"] - t0))
    finally:
        ho.step = inner
    return losses, walls, splits


def masters_equal(a: dict, b: dict) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(masters_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def host_copy(tree: dict) -> dict:
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def offload_main(dev, tag: str, layers: int) -> dict:
    """(a): see the module docstring, phase 11."""
    spec = OFFLOAD
    gas, steps = spec["gas"], spec["steps"]
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = offload_engine(spec, dev, layers, {
        "stage": 2, "offload_optimizer": {"device": "cpu"}})
    setup_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    ho = engine._host_opt
    if engine._zero.master.device.type != "cpu" or ho.device_elements():
        raise AssertionError(f"[{tag}] the fp32 master is not on the host")
    batch = train_batch_of(spec, vocab_of(spec), seed=3)
    tokens = batch["input_ids"].numel()
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, walls, splits = offload_steps(engine, batch, steps)
    launches = all_counts()
    peak = torch.cuda.max_memory_allocated()
    zero_check_launches(tag, launches, layers, gas, steps)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] losses {losses}: not finite and "
                             f"falling on a repeated batch")
    if peak >= 80e9:
        raise AssertionError(f"[{tag}] device peak {peak / 1e9:.1f} GB")
    ms = statistics.mean(walls[1:]) * 1e3
    split = splits[-1]
    rec = dict(layers=layers, params=engine.num_parameters(),
               host_elements=ho.host_elements(), tokens_per_step=tokens,
               losses=losses, step_s=walls, ms_per_step=ms,
               tokens_per_s=tokens / (ms / 1e3), peak_mem_bytes=peak,
               init_peak_mem_bytes=init_peak, setup_s=setup_s,
               splits=splits, launches=launches)
    log(f"[{tag}] {rec['params'] / 1e9:.2f} B parameters ({layers} layers), "
        f"{tokens} tokens a step: losses "
        f"{', '.join(repr(x) for x in losses)}; {ms:.1f} ms/step, "
        f"{rec['tokens_per_s']:.0f} tokens/s; device peak {peak / 1e9:.2f} GB "
        f"in the steps ({init_peak / 1e9:.2f} GB while the fp32 model moved "
        f"to the host); set-up {setup_s:.1f} s; K4 {launches['k4_fwd']} / "
        f"{launches['k4_bwd']}")
    num = lambda x, f: "not measured" if x is None else format(x, f)
    log(f"[{tag}] last step: device forward + backward "
        f"{split['device_fwd_bwd_s']:.3f} s; host step "
        f"{split['host_step_s']:.3f} s: gradients to the host "
        f"{split['d2h_GB']:.2f} GB at {num(split['d2h_GBps'], '.1f')} GB/s "
        f"({num(split['d2h_hidden'], '.0%')} hidden), host Adam "
        f"{split['adam_s']:.3f} s ({split['adam_GBps']:.1f} GB/s of 28 B an "
        f"element), bf16 cast {split['cast_s']:.3f} s "
        f"({split['cast_GBps']:.1f} GB/s), to the card "
        f"{split['h2d_GB']:.2f} GB at {num(split['h2d_GBps'], '.1f')} GB/s "
        f"({num(split['h2d_hidden'], '.0%')} hidden), {split['tiles']} "
        f"tiles")
    engine.close()
    del engine
    free_cuda()
    return rec


def offload_small(dev, tag: str) -> dict:
    """(b) NVMe bit for bit cpu, (c) Twin-Flow, (e) the checkpoint."""
    import shutil

    spec = OFFLOAD_SMALL
    L, steps = spec["layers"], spec["steps"]
    batch = train_batch_of(spec, vocab_of(spec), seed=5)
    rec: dict = {"launches": {}}
    shutil.rmtree(OFFLOAD_DIR, ignore_errors=True)
    os.makedirs(OFFLOAD_DIR)
    swap, ckpt = (os.path.join(OFFLOAD_DIR, d) for d in ("swap", "ckpt"))
    n = param_count(spec["name"], L)
    free = shutil.disk_usage(OFFLOAD_DIR).free
    need = 12 * n + 14 * n + 2e9         # the swap files, the checkpoint
    rec["free_disk_bytes"] = free
    log(f"[{tag}] free disk under {OFFLOAD_DIR}: {free / 1e9:.1f} GB "
        f"(needs {need / 1e9:.1f})")
    if free < need:
        raise AssertionError(f"[{tag}] {free / 1e9:.1f} GB free, "
                             f"{need / 1e9:.1f} GB needed")

    def add(got):
        for k, v in got.items():
            rec["launches"][k] = rec["launches"].get(k, 0) + v

    def run(zero, label, **over):
        free_cuda()
        engine = offload_engine(spec, dev, L, zero, **over)
        reset_counts()
        losses, walls, splits = offload_steps(engine, batch, steps)
        got = all_counts()
        zero_check_launches(f"{tag} {label}", got, L, spec["gas"], steps)
        add(got)
        return engine, losses, walls, splits

    # the cpu run: 2 steps, the step-2 tag, step 3
    cpu = {"stage": 2, "offload_optimizer": {"device": "cpu"}}
    ckpt_cfg = {"checkpoint": {"integrity": "size"}}
    engine, l_cpu, _, _ = run(cpu, "cpu", **ckpt_cfg)
    m_cpu = host_copy(engine.master)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.save_checkpoint(ckpt, tag="step2")
    save_s = time.perf_counter() - t0
    reset_counts()
    l3 = float(engine.train_batch(batch))
    add(all_counts())
    m3 = host_copy(engine.master)
    engine.close()
    del engine
    # (b) NVMe: the set-up spills the state once, each step reads and
    # writes it back
    t0 = time.perf_counter()
    engine = offload_engine(spec, dev, L, {
        "stage": 2, "offload_optimizer": {"device": "nvme",
                                          "nvme_path": swap}})
    ho = engine._host_opt
    spilled = ho.io_written_bytes
    reset_counts()
    l_nvme, walls, splits = offload_steps(engine, batch, steps)
    got = all_counts()
    zero_check_launches(f"{tag} nvme", got, L, spec["gas"], steps)
    add(got)
    io = {"spill_GB": spilled / 1e9,
          "read_GB_per_step": ho.io_read_bytes / 1e9 / steps,
          "written_GB_per_step": (ho.io_written_bytes - spilled) / 1e9
          / steps,
          "step_s": walls, "nvme_wait_s": [s["nvme_wait_s"] for s in splits],
          "files": len(ho.swap_files()),
          "seconds_with_setup": time.perf_counter() - t0}
    same = l_nvme == l_cpu and masters_equal(host_copy(engine.master), m_cpu)
    swap_dir = ho.nvme_dir
    engine.close()
    del engine
    shutil.rmtree(swap_dir)
    log(f"[{tag}] nvme: losses {l_nvme} (cpu {l_cpu}), master bit for bit: "
        f"{same}; {io['read_GB_per_step']:.2f} GB read and "
        f"{io['written_GB_per_step']:.2f} GB written a step (the set-up "
        f"spilled {io['spill_GB']:.2f} GB), step "
        f"{', '.join(f'{s:.2f}' for s in walls)} s, of which waiting on "
        f"the disk {', '.join(f'{s:.2f}' for s in io['nvme_wait_s'])} s; "
        f"{io['files']} swap files (removed)")
    if not same:
        raise AssertionError(f"[{tag}] NVMe differs from cpu offload")
    rec["nvme"] = dict(losses=l_nvme, **io)
    # (c) Twin-Flow
    engine, l_half, walls, splits = run(
        {"stage": 2, "offload_optimizer": {"device": "cpu", "ratio": 0.5}},
        "twin-flow")
    ho = engine._host_opt
    shares = (ho.host_elements(), ho.device_elements())
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_half, l_cpu))
    engine.close()
    del engine
    log(f"[{tag}] Twin-Flow ratio 0.5: losses {l_half} against ratio 1.0's "
        f"{l_cpu}: {rel:.2e} relative (limit 2e-3); host {shares[0]} / "
        f"device {shares[1]} elements; step "
        f"{', '.join(f'{s:.2f}' for s in walls)} s")
    if rel > 2e-3 or not all(shares):
        raise AssertionError(f"[{tag}] Twin-Flow {rel:.2e}, shares {shares}")
    rec["twin_flow"] = dict(losses=l_half, max_rel=rel, host_elements=shares[0],
                            device_elements=shares[1], step_s=walls)
    # (e) the checkpoint: a fresh offload engine, then stage 1 on the card
    free_cuda()
    engine = offload_engine(spec, dev, L, cpu, **ckpt_cfg)
    t0 = time.perf_counter()
    engine.load_checkpoint(ckpt, tag="step2")
    load_s = time.perf_counter() - t0
    reset_counts()
    r3 = float(engine.train_batch(batch))
    add(all_counts())
    same = r3 == l3 and masters_equal(host_copy(engine.master), m3)
    engine.close()
    del engine
    free_cuda()
    engine = offload_engine(spec, dev, L, {"stage": 1}, **ckpt_cfg)
    engine.load_checkpoint(ckpt, tag="step2")
    reset_counts()
    d3 = float(engine.train_batch(batch))
    add(all_counts())
    engine.close()
    del engine
    free_cuda()
    size = sum(os.path.getsize(os.path.join(dp, f))
               for dp, _, fs in os.walk(ckpt) for f in fs)
    shutil.rmtree(OFFLOAD_DIR)
    rel = abs(d3 - l3) / abs(l3)
    log(f"[{tag}] checkpoint at step 2 ({size / 1e9:.2f} GB, save "
        f"{save_s:.2f} s, load {load_s:.2f} s): the offload engine's step 3 "
        f"{r3!r} against {l3!r}, master bit for bit: {same}; a stage-1 "
        f"engine without offload {d3!r} ({rel:.2e} relative, limit 1e-2)")
    if not same or rel > 1e-2:
        raise AssertionError(f"[{tag}] checkpoint resume: {r3} / {d3} "
                             f"against {l3}")
    rec.update(cpu_losses=l_cpu + [l3], checkpoint=dict(
        bytes=size, save_s=save_s, load_s=load_s, resumed=r3,
        device_stage1=d3, device_rel=rel))
    return rec


def offload_stream(dev, tag: str) -> dict:
    """(d) ZeRO-Infinity against (a)'s engine at the same depth."""
    spec = OFFLOAD_STREAM
    L, gas, steps = spec["layers"], spec["gas"], spec["steps"]
    batch = train_batch_of(spec, vocab_of(spec), seed=9)
    free_cuda()
    engine = offload_engine(spec, dev, L, {
        "stage": 2, "offload_optimizer": {"device": "cpu"}})
    reset_counts()
    ref, ref_walls, _ = offload_steps(engine, batch, steps)
    got_ref = all_counts()
    zero_check_launches(f"{tag} reference", got_ref, L, gas, steps)
    engine.close()
    del engine
    free_cuda()
    t0 = time.perf_counter()
    engine = offload_engine(spec, dev, L, {
        "stage": 3, "offload_optimizer": {"device": "cpu"},
        "offload_param": {"device": "cpu", "buffer_count": 2}})
    setup_s = time.perf_counter() - t0
    ps = engine._param_stream
    if engine._zero is not None or next(engine.module.parameters()).is_cuda:
        raise AssertionError(f"[{tag}] parameters on the card")
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, walls = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        walls.append(time.perf_counter() - t1)
    got = all_counts()
    peak = torch.cuda.max_memory_allocated()
    zero_check_launches(tag, got, L, gas, steps)
    bf16_bytes = ps.total_param_bytes
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    ms = statistics.mean(walls[1:]) * 1e3
    rec = dict(layers=L, losses=losses, reference=ref, max_rel=rel,
               step_s=walls, ms_per_step=ms, reference_step_s=ref_walls,
               peak_mem_bytes=peak, param_bytes=bf16_bytes,
               peak_staged_bytes=ps.peak_staged_bytes,
               peak_hbm_bytes=ps.peak_hbm_bytes, stage_hits=ps.stage_hits,
               stage_misses=ps.stage_misses, setup_s=setup_s,
               launches={k: got[k] + got_ref[k] for k in got})
    log(f"[{tag}] losses {losses} against the offloaded device engine's "
        f"{ref}: {rel:.2e} relative (limit 1e-2); {ms:.1f} ms/step "
        f"(reference {statistics.mean(ref_walls[1:]) * 1e3:.1f}); device peak "
        f"{peak / 1e9:.2f} GB against {bf16_bytes / 1e9:.2f} GB of bf16 "
        f"parameters (staged peak {ps.peak_staged_bytes / 1e9:.2f} GB, with "
        f"the gradient queue {ps.peak_hbm_bytes / 1e9:.2f}); staging hits "
        f"{ps.stage_hits}, misses {ps.stage_misses}; K4 {got['k4_fwd']} / "
        f"{got['k4_bwd']}; set-up {setup_s:.1f} s (the fp32 model is made on "
        f"the card from the seed, as the reference's, and moved to the host "
        f"before the peak is reset)")
    if rel > 1e-2 or peak >= bf16_bytes:
        raise AssertionError(f"[{tag}] {rel:.2e} relative, peak {peak} "
                             f"against {bf16_bytes} parameter bytes")
    engine.close()
    del engine
    free_cuda()
    return rec


def offload_head(dev, tag: str, train: dict | None) -> dict:
    """(f) the train spec with ``DS_TPU_FUSED_HEAD_CHUNK=8192``, then with
    the "offload" remat policy, beside the plain run (the train phase's,
    or one made here)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.ops import remat

    spec = dict(TRAIN, steps=3)
    L, gas, steps = spec["layers"], spec["gas"], spec["steps"]
    batch = train_batch_of(spec, vocab_of(spec), seed=3)
    tokens = batch["input_ids"].numel()
    rec: dict = {"launches": {}}

    def run(label, policy, env):
        free_cuda()
        old = os.environ.pop("DS_TPU_FUSED_HEAD_CHUNK", None)
        if env:
            os.environ["DS_TPU_FUSED_HEAD_CHUNK"] = env
        try:
            model = build_model(spec["name"], num_layers=L,
                                dtype=torch.bfloat16,
                                param_dtype=torch.float32, device=dev, seed=0)
            engine, *_ = dst.initialize(model=model, config=train_config(
                spec, activation_checkpointing={"policy": policy}))
            free_cuda()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            before = dict(remat.offload_counts)
            losses, walls = [], []
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(engine.train_batch(batch)))
                walls.append(time.perf_counter() - t0)
            got = all_counts()
            zero_check_launches(f"{tag} {label}", got, L, gas, steps)
            for k, v in got.items():
                rec["launches"][k] = rec["launches"].get(k, 0) + v
            saved = remat.offload_counts["saved"] - before["saved"]
            out = dict(losses=losses, step_s=walls,
                       ms_per_step=statistics.mean(walls[1:]) * 1e3,
                       peak_mem_bytes=torch.cuda.max_memory_allocated(),
                       products_offloaded=saved,
                       offloaded_GB=(remat.offload_counts["bytes"]
                                     - before["bytes"]) / 1e9)
            engine.close()
            del engine, model
        finally:
            os.environ.pop("DS_TPU_FUSED_HEAD_CHUNK", None)
            if old is not None:
                os.environ["DS_TPU_FUSED_HEAD_CHUNK"] = old
        free_cuda()
        return out

    if train is not None:
        plain = dict(losses=train["losses"][:steps],
                     ms_per_step=train["ms_per_step"],
                     peak_mem_bytes=train["peak_mem_bytes"], source="train")
    else:
        plain = run("plain", "full", None)
    rec["plain"] = plain
    rec["fused_head"] = run("fused head", "full", "8192")
    rec["offload_policy"] = run("remat offload", "offload", None)
    # 7 products a block, each micro-batch's forward
    want_saved = 7 * L * gas * steps
    if rec["offload_policy"]["products_offloaded"] != want_saved:
        raise AssertionError(f"[{tag}] the offload policy saved "
                             f"{rec['offload_policy']['products_offloaded']} "
                             f"products, not {want_saved}")
    for key in ("fused_head", "offload_policy"):
        r = rec[key]
        r["max_rel"] = max(abs(a - b) / abs(b)
                           for a, b in zip(r["losses"], plain["losses"]))
        log(f"[{tag}] {key}: losses {r['losses']} ({r['max_rel']:.2e} "
            f"relative to the plain run's, limit 1e-2); {r['ms_per_step']:.1f} "
            f"ms/step ({tokens / r['ms_per_step'] * 1e3:.0f} tokens/s), peak "
            f"{r['peak_mem_bytes'] / 1e9:.2f} GB; plain "
            f"{plain['ms_per_step']:.1f} ms/step, peak "
            f"{plain['peak_mem_bytes'] / 1e9:.2f} GB"
            + (f"; {r['offloaded_GB']:.2f} GB of product outputs through "
               f"pinned host memory" if key == "offload_policy" else ""))
        if r["max_rel"] > 1e-2:
            raise AssertionError(f"[{tag}] {key} losses {r['losses']} "
                                 f"against {plain['losses']}")
    return rec


def host_build_seconds(scratch: str) -> float:
    """Seconds of a cold g++ build of the host library into a directory
    under ``scratch`` (removed after): the library the run loads may have
    been built by an earlier process."""
    import tempfile

    from deepspeed_tpu_torch.ops import native

    saved = native.BUILD_DIR, dict(native.build_info)
    with tempfile.TemporaryDirectory(prefix="host_build.", dir=scratch) as d:
        native.BUILD_DIR = d
        try:
            t0 = time.perf_counter()
            native.build_library()
            return time.perf_counter() - t0
        finally:
            native.BUILD_DIR = saved[0]
            native.build_info.clear()
            native.build_info.update(saved[1])


def host_copy_rate(gib: float = 1.0, reps: int = 3) -> float:
    """The host's memory rate for a plain copy on torch's threads (bytes
    read + written over seconds, best of ``reps``): the yardstick of the
    host step, which streams its state through memory once."""
    n = int(gib * 2 ** 30) // 4
    a = torch.ones(n)
    b = torch.empty(n)
    b.copy_(a)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        b.copy_(a)
        best = min(best, time.perf_counter() - t0)
    del a, b
    return 2 * n * 4 / best


def phase_offload(dev, train: dict | None = None) -> dict:
    """See the module docstring, phase 11."""
    import shutil

    import torch.distributed as dist

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.accelerator import card_name_and_power_limit
    from deepspeed_tpu_torch.ops import native

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    comm.init_distributed()
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"[offload] process group "
                             f"{dist.get_backend()} of "
                             f"{dist.get_world_size()}")
    t0 = time.perf_counter()
    native.load_library()
    load_s = time.perf_counter() - t0
    avail = mem_available()
    here = os.path.dirname(os.path.abspath(__file__))
    host = dict(card=card_name_and_power_limit(), mem_available_bytes=avail,
                cpu_count=os.cpu_count(),
                affinity=len(os.sched_getaffinity(0)),
                library_threads=native.library_threads(),
                library=native.build_info.get("path"),
                gxx_load_s=native.build_info.get("seconds"),
                gxx_built=native.build_info.get("built"),
                gxx_cold_build_s=host_build_seconds(here),
                load_s=load_s, free_disk_bytes=shutil.disk_usage(here).free,
                host_copy_GBps=host_copy_rate() / 1e9,
                torch_threads=torch.get_num_threads())
    log(f"[offload] {host['card']}; MemAvailable {avail / 1e9:.1f} GB, "
        f"os.cpu_count() {host['cpu_count']} (affinity {host['affinity']}), "
        f"host library {host['library_threads']} OpenMP threads, g++ build "
        f"{host['gxx_cold_build_s']:.1f} s cold (the loaded library "
        + (f"built in {host['gxx_load_s']:.1f} s" if host["gxx_built"]
           else "was cached") + "), "
        f"free disk under the checkout {host['free_disk_bytes'] / 1e9:.1f} "
        f"GB; host memory copy {host['host_copy_GBps']:.1f} GB/s (read + "
        f"written, torch's {host['torch_threads']} threads)")
    rec: dict = {"host": host}
    layers, why = offload_depth(OFFLOAD, avail)
    log(f"[offload] (a) depth: {why}")
    rec["depth"] = {"layers": layers, "reason": why}
    rec["main"] = offload_main(dev, f"offload {OFFLOAD['name']} x{layers}",
                               layers)
    rec["small"] = offload_small(dev, f"offload {OFFLOAD['name']} x2")
    rec["stream"] = offload_stream(dev, f"infinity {OFFLOAD['name']} x8")
    rec["head"] = offload_head(dev, f"offload {TRAIN['name']} x8", train)
    launches: dict = {}
    for part in (rec["main"], rec["small"], rec["stream"], rec["head"]):
        for k, v in part["launches"].items():
            launches[k] = launches.get(k, 0) + v
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[offload] phase {rec['seconds']:.1f} s; launches k4 "
        f"{launches['k4_fwd']} / {launches['k4_bwd']}")
    return rec


# ---------------------------------------------------------------------------
# phase 12: kvmove — KV movement and the live weight swap (4 layers)
# ---------------------------------------------------------------------------

#: the serve phase's model, from the same seed, at 4 of its 32 layers (the
#: whole script's time limit: 16 since the fleet phase joined, 4 since the
#: tp phase did; full depth before)
KVMOVE = dict(name="llama2-7b", layers=4, seed=1, new=64)
#: the tier run: new tokens a request of its waves generates, the RAM
#: ring's and the NVMe spill's budgets (64 and 256 pages of 4.2 MB: the
#: page counts of the full-depth runs)
KVMOVE_TIER = dict(new=64, ram=256 << 20, nvme=1 << 30)
KVMOVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "kvmove.tmp")
#: free disk the phase needs under the checkout: the 6.9 GB swap tag, two
#: 2-layer tags of ~1.3 GB, the tier's 8 GB spill budget, and margin
KVMOVE_DISK = 30e9


def kv_engine(model, dev, **over):
    """An engine over ``model``'s own weights (engines on one model share
    them, no copy) with the serve phase's settings, every decode program
    captured."""
    from deepspeed_tpu_torch.inference import InferenceEngineV2

    cfg = dict(block_size=64, num_blocks=256, max_seqs=8, chunk=256,
               max_seq_len=2048, decode_window=8, dtype=torch.bfloat16,
               device=dev)
    cfg.update(over)
    eng = InferenceEngineV2(model, config=cfg)
    eng.warm_decode_windows()
    eng.warm_decode_step()
    return eng


def kv_prompts(vocab: int, seed: int, lens=TRAFFIC["shared-prefix"][0],
               sys_len: int = TRAFFIC["shared-prefix"][1],
               system_seed: int = 1) -> list:
    """8 prompts of ``lens`` tokens behind a 128-token system prefix (the
    serve phase's from ``system_seed`` 1), their bodies drawn from
    ``seed``."""
    g = torch.Generator().manual_seed(system_seed)
    system = torch.randint(0, vocab, (sys_len,), generator=g).tolist()
    g = torch.Generator().manual_seed(seed)
    return [system + torch.randint(0, vocab, (n - sys_len,),
                                   generator=g).tolist() for n in lens]


def zero_stats(*engines) -> None:
    for eng in engines:
        for k in list(eng.stats):
            eng.stats[k] = 0 if not isinstance(eng.stats[k], float) else 0.0


def first_tokens(eng, uids) -> None:
    """Step until every uid has its first token scheduled. The stop reads
    the scheduled view, so the dispatches made do not depend on when
    readbacks land: two engines driven alike dispatch alike."""
    while any(eng.state.seqs[u].n_generated + eng.state.seqs[u].n_inflight
              < 1 for u in uids):
        eng.step()


def run_done(eng, uids, t0: float | None = None) -> tuple[dict, dict]:
    """Step until every uid is done, then flush: ``({uid: stream}, {uid:
    seconds from t0 to its first emitted token})``."""
    first: dict = {}
    while any(not eng.query(u).get("done", True) for u in uids):
        emitted = eng.step()
        if t0 is not None:
            now = time.perf_counter() - t0
            for u, toks in emitted.items():
                if toks and u not in first:
                    first[u] = now
    return {u: eng.flush(u) for u in uids}, first


def serve_wave(eng, prompts, new: int, uid0: int = 0) -> tuple[dict, float]:
    """Put every prompt and run them to the end: ``(streams by uid, p50
    TTFT)``."""
    uids = [uid0 + i for i in range(len(prompts))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for u, p in zip(uids, prompts):
        eng.put(u, p, max_new_tokens=new)
    streams, first = run_done(eng, uids, t0)
    return streams, statistics.median(first.values())


def pool_pages(eng, blocks) -> torch.Tensor:
    """Whole pool pages as bytes, ``[L, 2, KV, n, block_size, D x
    itemsize]`` (a copy)."""
    idx = torch.as_tensor(list(blocks), device=eng.device)
    return eng.kv_pool.view(torch.uint8).index_select(3, idx)


def wire(bundle):
    """The bundle through the wire form: raw chunks of 8 MB (crc32 each),
    delivered in reverse order to a ``BundleAssembler`` on the bundle's
    meta as JSON."""
    from deepspeed_tpu_torch.inference.migration import (BundleAssembler,
                                                         iter_chunks)

    chunks = iter_chunks(bundle, max_bytes=8 << 20, encode=False)
    asm = BundleAssembler(json.loads(json.dumps(bundle.meta())))
    for c in reversed(chunks):
        asm.add_raw(c, c["raw"])
    asm.eof(len(chunks))
    return asm.assemble()


def kv_launches(tag, cfg, engines) -> dict:
    """The kernels' launches since the last reset, held to K1 once per
    layer of every forward of ``engines`` (chunk or split kernel, bf16),
    nothing plain, no other kernel."""
    got = all_counts()
    forwards = sum(forwards_of(e) for e in engines)
    check_launches(tag, got, cfg, forwards=forwards, e4m3_pool=False,
                   quant=False, bf16=True)
    return {"k1": got["k1"], "k1_chunk": got["k1_chunk"],
            "k1_split": got["k1_split"], "forwards": forwards}


def kv_migration(dev, model, prompts, new) -> dict:
    """(a) Engine A prefills the 8 requests to their first token and
    exports them; the bundles cross the wire; engine B imports them in uid
    order and decodes. R serves the same 8 without migrating, driven alike
    (the same dispatches to the first tokens, then the same decode plans
    from committed state)."""
    tag = "kvmove (a)"
    cfg = model.config
    uids = list(range(len(prompts)))
    R, A, B = (kv_engine(model, dev) for _ in range(3))
    for u, p in enumerate(prompts):
        R.put(u, p, max_new_tokens=new)
    first_tokens(R, uids)
    R._drain(drain_all=True)            # decode from committed state, as B
    ref, _ = run_done(R, uids)
    del R
    free_cuda()
    zero_stats(A, B)
    replays0 = graph_replays(B)
    reset_counts()
    for u, p in enumerate(prompts):
        A.put(u, p, max_new_tokens=new)
    first_tokens(A, uids)
    torch.cuda.synchronize()
    t_exp = time.perf_counter()
    bundles = [A.export_migration(u, trace_id=f"kvmove-{u}") for u in uids]
    export_s = time.perf_counter() - t_exp
    t0 = time.perf_counter()
    wired = [wire(b) for b in bundles]
    wire_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for u, b in zip(uids, wired):
        if not B.can_import(len(b.tokens), b.max_new_tokens - b.n_generated):
            raise AssertionError(f"[{tag}] B cannot import uid {u}")
        B.import_reserve(u, b.meta())
        B.import_complete(u, b)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    B.step()
    torch.cuda.synchronize()
    to_decode_s = time.perf_counter() - t_exp
    # B's imported pages are the exported bytes, bit for bit
    for u, b in zip(uids, bundles):
        a_blocks, b_blocks = A.state.seqs[u].blocks, B.state.seqs[u].blocks
        n = b.n_full
        if n and not torch.equal(pool_pages(A, a_blocks[:n]),
                                 pool_pages(B, b_blocks[:n])):
            raise AssertionError(f"[{tag}] uid {u}: imported pages differ")
        if b.tail_rows and not torch.equal(
                pool_pages(A, [a_blocks[n]])[:, :, :, :, :b.tail_rows],
                pool_pages(B, [b_blocks[n]])[:, :, :, :, :b.tail_rows]):
            raise AssertionError(f"[{tag}] uid {u}: imported tail differs")
    got, _ = run_done(B, uids)
    torch.cuda.synchronize()
    launches = kv_launches(tag, cfg, (A, B))
    replays = check_replays(tag + " B", B, replays0, {})
    for u in uids:
        if got[u] != ref[u] or len(got[u]) != new:
            raise AssertionError(f"[{tag}] uid {u}: the migrated stream "
                                 f"differs from the unmigrated one")
        prefix = A.export_commit(u)
        if prefix != ref[u][:len(prefix)] or not prefix:
            raise AssertionError(f"[{tag}] uid {u}: export_commit gave "
                                 f"{len(prefix)} tokens")
    A.state.audit()
    B.state.audit()
    # both tries serve the prefix: the 1024-token prompt's 16 pages
    hits = []
    for eng in (A, B):
        eng.put(99, prompts[6] + [1], max_new_tokens=1)
        hits.append(eng.state.seqs[99].prefix_hit_tokens)
        eng.flush(99)
        eng.state.audit()
    if min(hits) < len(prompts[6]):
        raise AssertionError(f"[{tag}] prefix hits {hits} after the handoff")
    pages = sum(b.n_full for b in bundles)
    moved = sum(b.payload_bytes for b in bundles)
    rec = {"pages": pages, "tails": sum(bool(b.tail_rows) for b in bundles),
           "bytes": moved, "export_s": export_s, "wire_s": wire_s,
           "import_s": import_s, "export_GBps": moved / export_s / 1e9,
           "import_GBps": moved / import_s / 1e9,
           "export_to_first_decode_s": to_decode_s,
           "generated_on_A": [b.n_generated for b in bundles],
           "prefix_hits_after": hits, "launches": launches,
           "replays_B": replays}
    log(f"[{tag}] {len(uids)} sequences exported after their first tokens "
        f"({rec['generated_on_A']} generated on A): {pages} pages + "
        f"{rec['tails']} tails, {moved / 1e9:.3f} GB; export "
        f"{1e3 * export_s:.1f} ms ({rec['export_GBps']:.2f} GB/s), wire "
        f"(8 MB raw chunks, crc32, reverse order) {1e3 * wire_s:.1f} ms, "
        f"import {1e3 * import_s:.1f} ms ({rec['import_GBps']:.2f} GB/s); "
        f"export start to B's first decode {to_decode_s:.3f} s; imported "
        f"pages bit for bit, {new}-token streams bit for bit the unmigrated "
        f"engine's; prefix hits after {hits}; K1 {launches}")
    del A, B
    free_cuda()
    return rec


def kv_pull_and_gang(dev, model, prompts) -> dict:
    """(b) A pulled prefix chain against a cold engine, then a 3968-token
    prompt prefilled as two gang segments against one engine."""
    tag = "kvmove (b)"
    cfg = model.config
    A = kv_engine(model, dev)
    P = prompts[6] + [1]                     # 16 full pages + one token
    A.put(0, P, max_new_tokens=1)            # publishes P's pages
    run_done(A, [0])
    cold = kv_engine(model, dev)
    zero_stats(cold)
    reset_counts()
    cold_streams, cold_ttft = serve_wave(cold, [P], 16)
    cold_launches = kv_launches(tag + " cold", cfg, (cold,))
    del cold
    free_cuda()
    warm = kv_engine(model, dev)
    zero_stats(warm)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle = A.export_prefix(P, trace_id="kvmove-pull")
    export_s = time.perf_counter() - t0
    got = wire(bundle)
    t0 = time.perf_counter()
    pages = warm.import_prefix(got)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    warm_streams, warm_ttft = serve_wave(warm, [P], 16, uid0=5)
    hit = warm.stats["prefix_hit_tokens"]
    if pages != len(P) // 64 or hit != pages * 64:
        raise AssertionError(f"[{tag}] pulled {pages} pages, hit {hit}")
    launches = kv_launches(tag + " pull", cfg, (warm,))
    snap = warm.state.snapshot_prefix(P)
    src = A.state.snapshot_prefix(P)
    same = torch.equal(pool_pages(warm, snap["blocks"]),
                       pool_pages(A, src["blocks"]))
    warm.state.release_prefix(snap["handle"])
    A.state.release_prefix(src["handle"])
    if not same:
        raise AssertionError(f"[{tag}] pulled pages differ from the source")
    for s in (cold_streams, warm_streams):
        for toks in s.values():
            if len(toks) != 16 or not all(0 <= t < cfg.vocab_size
                                          for t in toks):
                raise AssertionError(f"[{tag}] stream {toks}")
    del A, warm
    free_cuda()
    pull = {"pages": pages, "bytes": bundle.payload_bytes,
            "export_s": export_s, "import_s": import_s,
            "prefix_hit_tokens": hit, "ttft_pulled_s": warm_ttft,
            "ttft_cold_s": cold_ttft,
            "streams_equal_cold": warm_streams[5] == cold_streams[0],
            "launches": launches, "launches_cold": cold_launches}
    log(f"[{tag}] pull: {pages} pages ({bundle.payload_bytes / 1e9:.3f} GB) "
        f"exported in {1e3 * export_s:.1f} ms, imported in "
        f"{1e3 * import_s:.1f} ms, bit for bit; a request of {len(P)} tokens "
        f"hits {hit} tokens: TTFT {warm_ttft:.3f} s pulled vs "
        f"{cold_ttft:.3f} s cold (streams "
        f"{'equal' if pull['streams_equal_cold'] else 'differ in bf16'}); "
        f"K1 {launches}")

    # gang prefill: segment 0 (2048 tokens, a multiple of the chunk) on
    # G1, the rest on G2 over G1's pages; S serves the whole prompt
    g = torch.Generator().manual_seed(7)
    prompt = prompts[0][:128] + torch.randint(
        0, cfg.vocab_size, (3968 - 128,), generator=g).tolist()
    over = dict(max_seq_len=4096, num_blocks=128)
    S, G1, G2 = (kv_engine(model, dev, **over) for _ in range(3))
    n_pages = len(prompt) // 64

    def prefill_one(eng, uid):
        while not eng.query(uid)["done"]:
            eng.step()
        eng._drain(drain_all=True)
        pages = pool_pages(eng, eng.state.seqs[uid].blocks[:n_pages])
        return eng.flush(uid), pages

    S.put(0, prompt, max_new_tokens=1)
    s_tok, s_pages = prefill_one(S, 0)
    del S
    free_cuda()
    zero_stats(G1, G2)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if G1.gang_prefill_segment(0, prompt[:2048], max_new_tokens=1) != 0:
        raise AssertionError(f"[{tag}] member 0 adopted pages")
    prefill_one(G1, 0)
    hop = wire(G1.export_prefix(prompt[:2048], trace_id="kvmove-gang"))
    adopted = G2.gang_prefill_segment(0, prompt, prefix_bundle=hop,
                                      max_new_tokens=1)
    hit = G2.state.seqs[0].prefix_hit_tokens
    g_tok, g_pages = prefill_one(G2, 0)
    torch.cuda.synchronize()
    gang_s = time.perf_counter() - t0
    launches = kv_launches(tag + " gang", cfg, (G1, G2))
    if adopted != 32 or hit != 2048 or g_tok != s_tok or \
            not torch.equal(g_pages, s_pages):
        raise AssertionError(f"[{tag}] gang: adopted {adopted}, hit {hit}, "
                             f"token {g_tok} vs {s_tok}, pages equal "
                             f"{torch.equal(g_pages, s_pages)}")
    del G1, G2, s_pages, g_pages
    free_cuda()
    gang = {"prompt": len(prompt), "split": 2048, "adopted_pages": adopted,
            "merged_pages": n_pages, "first_token": g_tok, "seconds": gang_s,
            "hop_bytes": hop.payload_bytes, "launches": launches}
    log(f"[{tag}] gang: a {len(prompt)}-token prompt split at 2048 over two "
        f"engines ({adopted} pages hopped, {hop.payload_bytes / 1e9:.3f} GB) "
        f"in {gang_s:.2f} s: {n_pages} merged pages and the first token "
        f"{g_tok} bit for bit one engine's; K1 {launches}")
    return {"pull": pull, "gang": gang}


class _TimedZlib:
    """kvtier's ``zlib`` with ``crc32`` timed (its share of the tier's
    admission work)."""

    def __init__(self, real):
        self.real, self.seconds, self.bytes = real, 0.0, 0

    def crc32(self, data, *a):
        t0 = time.perf_counter()
        out = self.real.crc32(data, *a)
        self.seconds += time.perf_counter() - t0
        self.bytes += len(data)
        return out


def kv_tier(dev, model, prompts, others) -> dict:
    """(c) One engine with the KV tier under a pool of ~1.15 waves: wave 1
    computed, wave 1 again from HBM prefix hits, wave 2 evicting wave 1's
    chains into RAM and NVMe, wave 1 a third time promoted."""
    from deepspeed_tpu_torch.inference import kvtier as kt

    tag = "kvmove (c)"
    cfg = model.config
    new = KVMOVE_TIER["new"]
    wave_blocks = sum(-(-(len(p) + new) // 64) for p in prompts)
    blocks = math.ceil(1.15 * wave_blocks) + 1
    nvme = os.path.join(KVMOVE_DIR, "nvme")
    rates = kt.measure_tier_rates(nvme_dir=nvme)
    page_bytes = 2 * cfg.num_layers * cfg.kv_heads * 64 * cfg.head_dim * 2
    auto = {"ram": kt.auto_min_pages(rates, page_bytes=page_bytes,
                                     block_size=64),
            "nvme": kt.auto_min_pages(rates, page_bytes=page_bytes,
                                      block_size=64, nvme=True)}
    T = kv_engine(model, dev, num_blocks=blocks, kv_tier=True,
                  kv_tier_ram_bytes=KVMOVE_TIER["ram"],
                  kv_tier_nvme_dir=nvme,
                  kv_tier_nvme_bytes=KVMOVE_TIER["nvme"],
                  kv_tier_min_pages=1)
    zero_stats(T)
    w1, ttft1 = serve_wave(T, prompts, new)
    w1b, ttft1b = serve_wave(T, prompts, new, uid0=10)
    hits1b = T.stats["prefix_hit_tokens"]
    # wave 1's prompt chains as they sit in HBM, kept on the card
    kept = []
    for p in prompts:
        snap = T.state.snapshot_prefix(p[:len(p) - 1])
        kept.append(pool_pages(T, snap["blocks"]))
        T.state.release_prefix(snap["handle"])
    timed = _TimedZlib(kt.zlib)
    kt.zlib = timed
    # demotions timed where they run: inside the evictions that admissions
    # and promotes make (the eviction sink, with the gathers it waits on)
    demotes = {"s": 0.0, "pages": 0}
    sink = T._prefix_cache.evict_sink

    def timed_sink(chains):
        p0 = T.stats["kv_tier_demoted_pages"]
        t = time.perf_counter()
        try:
            sink(chains)
        finally:
            demotes["s"] += time.perf_counter() - t
            demotes["pages"] += T.stats["kv_tier_demoted_pages"] - p0

    T._prefix_cache.evict_sink = timed_sink
    try:
        t0 = time.perf_counter()
        w2, ttft2 = serve_wave(T, others, new, uid0=20)
        wave2_s = time.perf_counter() - t0
        wave2_demote = dict(demotes)
        after2 = T.kv_tier_stats()
        if after2["demoted_pages"] == 0:
            raise AssertionError(f"[{tag}] wave 2 demoted {after2}")
        zero_stats(T)
        reset_counts()
        # a promote's pages read from the spill (the rest come from RAM)
        spill = T._kv_tier.spill
        reads: list = []
        spill_read = spill.read
        spill.read = lambda h: reads.append(h) or spill_read(h)
        promotes = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for u, p in enumerate(prompts):
            r0, d0 = len(reads), dict(demotes)
            t1 = time.perf_counter()
            n = T._tier_promote(p)
            torch.cuda.synchronize()
            promotes.append({"pages": n, "s": time.perf_counter() - t1,
                             "from_nvme": len(reads) - r0,
                             "demote_s": demotes["s"] - d0["s"],
                             "demoted": demotes["pages"] - d0["pages"]})
            T.put(30 + u, p, max_new_tokens=new)
        for u, p in enumerate(prompts):
            seq = T.state.seqs[30 + u]
            d = min(seq.n_shared_blocks, kept[u].shape[3])
            if d < kept[u].shape[3] or not torch.equal(
                    pool_pages(T, seq.blocks[:d]), kept[u][:, :, :, :d]):
                raise AssertionError(f"[{tag}] uid {30 + u}: promoted pages "
                                     f"differ from the demoted ({d} of "
                                     f"{kept[u].shape[3]})")
        w1c, first = run_done(T, [30 + u for u in range(len(prompts))], t0)
        ttft1c = statistics.median(first.values())
        tier_s = time.perf_counter() - t0 + wave2_s
    finally:
        kt.zlib = timed.real
        T._prefix_cache.evict_sink = sink
        del T._kv_tier.spill.read
    del kept
    launches = kv_launches(tag, cfg, (T,))
    st = T.kv_tier_stats()
    hits1c = T.stats["prefix_hit_tokens"]
    for u in range(len(prompts)):
        if w1c[30 + u] != w1b[10 + u]:
            raise AssertionError(f"[{tag}] uid {u}: the promoted wave's "
                                 f"stream differs from the HBM-hit wave's")
    if T.stats["kv_tier_fallbacks"] or hits1c != hits1b or \
            T.stats["kv_tier_promotes"] != sum(1 for p in promotes
                                               if p["pages"]) or \
            not any(p["from_nvme"] for p in promotes):
        raise AssertionError(f"[{tag}] fallbacks "
                             f"{T.stats['kv_tier_fallbacks']}, hits "
                             f"{hits1c} vs {hits1b}, {promotes}")
    T.state.audit()

    def rate(rows):
        """Promotes' pages over their time less the demotions their own
        evictions ran (reported apart)."""
        pages = sum(r["pages"] for r in rows)
        secs = sum(r["s"] - r["demote_s"] for r in rows)
        return {"promotes": len(rows), "pages": pages,
                "pages_read_from_nvme": sum(r["from_nvme"] for r in rows),
                "ms": 1e3 * secs,
                "demoted_meanwhile": sum(r["demoted"] for r in rows),
                "demote_ms": 1e3 * sum(r["demote_s"] for r in rows),
                "GBps": pages * page_bytes / secs / 1e9 if secs else None}

    rec = {"pool_blocks": blocks, "wave_blocks": wave_blocks,
           "after_wave2": after2, "stats": st, "promotes": promotes,
           "from_ram": rate([p for p in promotes if p["pages"]
                             and not p["from_nvme"]]),
           # a promote that read any page from the spill counts here
           "from_nvme": rate([p for p in promotes if p["from_nvme"]]),
           "wave2_demote": wave2_demote,
           "wave2_demote_GBps": wave2_demote["pages"] * page_bytes
           / wave2_demote["s"] / 1e9 if wave2_demote["s"] else None,
           "crc_s": timed.seconds, "crc_bytes": timed.bytes,
           "crc_share": timed.seconds / tier_s, "rates": rates,
           "auto_min_pages": auto, "ttft_s": {"wave1": ttft1,
                                              "wave1_again": ttft1b,
                                              "wave2": ttft2,
                                              "wave1_promoted": ttft1c},
           "prefix_hit_tokens": hits1c, "launches": launches,
           "streams_equal_cold": all(w1c[30 + u] == w1[u]
                                     for u in range(len(prompts)))}
    log(f"[{tag}] pool {blocks} blocks ({wave_blocks} a wave); wave 2 "
        f"demoted {after2['demoted_pages']} pages in "
        f"{wave2_demote['s']:.3f} s of its admissions "
        f"({rec['wave2_demote_GBps'] or 0:.2f} GB/s): RAM "
        f"{after2['ram_pages']} pages ({after2['ram_bytes'] / 1e9:.2f} GB), "
        f"NVMe {after2['nvme_pages']} ({after2['nvme_bytes'] / 1e9:.2f} "
        f"GB); wave 1 promoted in {len(promotes)} promotes: from RAM "
        f"{rec['from_ram']}, from NVMe {rec['from_nvme']}; crc32 "
        f"{timed.seconds:.3f} s over {timed.bytes / 1e9:.2f} GB, "
        f"{100 * rec['crc_share']:.1f}% of wave 2 + the promoted wave; "
        f"measure_tier_rates {rates}, auto min_pages {auto}; p50 TTFT wave "
        f"1 {ttft1:.3f} s, again {ttft1b:.3f} s, wave 2 {ttft2:.3f} s, "
        f"promoted {ttft1c:.3f} s; promoted streams bit for bit the HBM-hit "
        f"wave's, fallbacks 0; K1 {launches}")
    T._kv_tier.close()
    del T
    free_cuda()
    shutil.rmtree(nvme, ignore_errors=True)
    return rec


def nan_tag(root: str, src: str, dst: str, leaf: str) -> None:
    """A verified tag equal to ``src`` but for ``leaf``, whose first value
    is NaN: the state files are hard links to ``src``'s, the manifest is
    ``src``'s with that one entry's size and crc32 made anew."""
    import numpy as np

    from deepspeed_tpu_torch.checkpoint.manifest import file_crc32

    s, d = os.path.join(root, src), os.path.join(root, dst)
    os.makedirs(os.path.join(d, "state"))
    for f in os.listdir(os.path.join(s, "state")):
        os.link(os.path.join(s, "state", f), os.path.join(d, "state", f))
    shutil.copy(os.path.join(s, "meta.json"), os.path.join(d, "meta.json"))
    f = os.path.join(d, "state", leaf + ".npy")
    a = np.load(f)
    os.remove(f)                          # the link, not src's file
    flat = a.reshape(-1)
    flat[0] = 0x7FC0 if a.dtype == np.uint16 else np.nan   # bf16 NaN bits
    np.save(f, a)
    with open(os.path.join(s, "manifest.json")) as fh:
        man = json.load(fh)
    rel = os.path.join("state", leaf + ".npy")
    man["tag"] = dst
    man["entries"][rel] = {"size": os.path.getsize(f), "crc32": file_crc32(f)}
    with open(os.path.join(d, "manifest.json"), "w") as fh:
        json.dump(man, fh, indent=2)


def kv_swap(dev, model, prompts, new) -> dict:
    """(d) ``save_weights`` at full depth, ``swap_weights`` to it with the
    8 sequences mid-decode and graphs live, the four refusals; then, at 2
    layers, a swap to a second seed's weights."""
    from deepspeed_tpu_torch.checkpoint.manifest import tag_status
    from deepspeed_tpu_torch.inference.engine_v2 import WeightSwapError
    from deepspeed_tpu_torch.inference.weights import tree_tensors
    from deepspeed_tpu_torch.models import build_model

    tag = "kvmove (d)"
    cfg = model.config
    root = os.path.join(KVMOVE_DIR, "weights")
    W = kv_engine(model, dev)
    uids = list(range(len(prompts)))
    W.state.flush_prefix_cache()
    ref, _ = serve_wave(W, prompts, new)
    W.state.flush_prefix_cache()
    ref1, _ = serve_wave(W, prompts[7:], 16, uid0=50)
    t0 = time.perf_counter()
    path = W.save_weights(root, tag="full")
    save_s = time.perf_counter() - t0
    on_disk = sum(os.path.getsize(os.path.join(dp, f))
                  for dp, _, fs in os.walk(path) for f in fs)
    t0 = time.perf_counter()
    status = tag_status(path)
    verify_s = time.perf_counter() - t0
    if status[0] != "verified":
        raise AssertionError(f"[{tag}] tag {status}")
    # mid-decode: the 8 driven as for the reference, swapped at 16 tokens
    W.state.flush_prefix_cache()
    zero_stats(W)
    reset_counts()
    for u, p in enumerate(prompts):
        W.put(100 + u, p, max_new_tokens=new)
    while any(s.n_generated + s.n_inflight < 16
              for s in W.state.seqs.values()):
        W.step()
    progs0 = captured(W)
    replays0 = graph_replays(W)
    ptrs0 = [t.data_ptr() for t in tree_tensors(W.params)]
    inflight = len(W._inflight)
    info = W.swap_weights(root, "full")
    got, _ = run_done(W, [100 + u for u in uids])
    replays = {k: n - replays0.get(k, 0) for k, n in graph_replays(W).items()
               if n != replays0.get(k, 0)}
    if captured(W) != progs0 or not any("win" in k for k in replays) or \
            [t.data_ptr() for t in tree_tensors(W.params)] != ptrs0:
        raise AssertionError(f"[{tag}] after the swap: programs "
                             f"{sorted(captured(W) - progs0)} new, replays "
                             f"{replays}")
    for u in uids:
        if got[100 + u] != ref[u]:
            raise AssertionError(f"[{tag}] uid {u}: the swapped stream "
                                 f"differs from the unswapped one")
    launches = kv_launches(tag, cfg, (W,))
    log(f"[{tag}] save_weights {on_disk / 1e9:.2f} GB in {save_s:.1f} s, "
        f"verify (crc32) {verify_s:.1f} s; swap with {inflight} dispatches "
        f"in flight: quiesce {info['quiesce_s']:.3f} s, swap (load + probe "
        f"+ copy) {info['swap_s']:.2f} s; the 8 streams bit for bit the "
        f"unswapped run's, replays since {replays}, no recapture")
    # refusals, each leaving the old weights serving
    small = build_model(KVMOVE["name"], dtype=torch.bfloat16, device=dev,
                        seed=KVMOVE["seed"], num_layers=2)
    S2 = kv_engine(small, dev, num_blocks=16)
    S2.save_weights(root, tag="shallow")
    S2.save_weights(root, tag="torn")
    del S2
    torn = os.path.join(root, "torn", "state", "embed.npy")
    with open(torn, "r+b") as f:
        f.truncate(os.path.getsize(torn) - 64)
    nan_tag(root, "full", "nan", "ln_final.scale")
    refusals = {}
    wv = W.weight_version()
    for bad, reason in (("torn", "integrity"), ("shallow", "shape_mismatch"),
                        ("absent", "no_checkpoint"),
                        ("nan", "probe_failed")):
        t0 = time.perf_counter()
        try:
            W.swap_weights(root, bad)
        except WeightSwapError as e:
            if e.reason != reason:
                raise AssertionError(f"[{tag}] {bad}: {e.reason} != "
                                     f"{reason}")
        else:
            raise AssertionError(f"[{tag}] {bad}: the swap went through")
        secs = time.perf_counter() - t0
        W.state.flush_prefix_cache()
        again, _ = serve_wave(W, prompts[7:], 16, uid0=60)
        if again[60] != ref1[50] or W.weight_version() != wv or \
                [t.data_ptr() for t in tree_tensors(W.params)] != ptrs0:
            raise AssertionError(f"[{tag}] {bad}: the old weights no longer "
                                 f"serve")
        refusals[bad] = {"reason": reason, "s": secs}
    log(f"[{tag}] refusals {refusals}: each left the old weights serving "
        f"(same tensors, same stream)")
    del W
    free_cuda()
    shutil.rmtree(os.path.join(root, "nan"), ignore_errors=True)
    # 2 layers: a swap to a second seed's weights
    over = dict(num_blocks=96, kv_tier=True,
                kv_tier_ram_bytes=KVMOVE_TIER["ram"], kv_tier_min_pages=1)
    X = kv_engine(small, dev, **over)
    Y = kv_engine(build_model(KVMOVE["name"], dtype=torch.bfloat16,
                              device=dev, seed=KVMOVE["seed"] + 1,
                              num_layers=2), dev, **over)
    Y.save_weights(root, tag="seed2")
    serve_wave(X, prompts, 16)
    X.state.allocator.free(X.state._alloc(X.state.allocator.free_blocks
                                          + 16))
    before = (X.prefix_cache_stats()["cached_pages"],
              X.kv_tier_stats()["ram_pages"])
    info2 = X.swap_weights(root, "seed2")
    after = (X.prefix_cache_stats()["cached_pages"],
             X.kv_tier_stats()["ram_pages"] + X.kv_tier_stats()["nvme_pages"])
    mine, _ = serve_wave(X, prompts, 16)
    fresh, _ = serve_wave(Y, prompts, 16)
    if before[0] == 0 or before[1] == 0 or after != (0, 0) or mine != fresh:
        raise AssertionError(f"[{tag}] second seed: cache and tier {before} "
                             f"-> {after}, streams equal {mine == fresh}")
    log(f"[{tag}] 2 layers: a swap to the second seed's weights "
        f"({info2['swap_s']:.3f} s) flushed {before[0]} cached pages and "
        f"{before[1]} tier pages; new requests equal a fresh engine's")
    del X, Y
    free_cuda()
    return {"tag_bytes": on_disk, "save_s": save_s, "verify_s": verify_s,
            "quiesce_s": info["quiesce_s"], "swap_s": info["swap_s"],
            "inflight_at_swap": inflight, "replays_after": replays,
            "refusals": refusals, "launches": launches,
            "second_seed": {"flushed_pages": before[0],
                            "tier_pages": before[1],
                            "swap_s": info2["swap_s"]}}


def captured(eng) -> set:
    """The keys of an engine's captured programs."""
    return set(eng._programs.programs)


def phase_kvmove(dev) -> dict:
    """See the module docstring, phase 12."""
    from deepspeed_tpu_torch.accelerator import card_name_and_power_limit
    from deepspeed_tpu_torch.models import build_model

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    free = shutil.disk_usage(here).free
    card = card_name_and_power_limit()
    log(f"[kvmove] {card}; free disk under the checkout {free / 1e9:.1f} GB")
    if free < KVMOVE_DISK:
        raise AssertionError(f"[kvmove] {free / 1e9:.1f} GB free under the "
                             f"checkout, {KVMOVE_DISK / 1e9:.0f} GB needed")
    shutil.rmtree(KVMOVE_DIR, ignore_errors=True)
    os.makedirs(KVMOVE_DIR)
    try:
        t0 = time.perf_counter()
        extra = {} if KVMOVE["layers"] is None else {
            "num_layers": KVMOVE["layers"]}
        model = build_model(KVMOVE["name"], dtype=torch.bfloat16, device=dev,
                            seed=KVMOVE["seed"], **extra)
        cfg = model.config
        log(f"[kvmove] {KVMOVE['name']} ({cfg.num_layers} layers, bf16, "
            f"seeded random weights) up in {time.perf_counter() - t0:.1f} s")
        prompts = kv_prompts(cfg.vocab_size, 2)
        # the tier's second wave: other prompts behind another prefix
        others = kv_prompts(cfg.vocab_size, 3, system_seed=4)
        rec: dict = {"card": card, "layers": cfg.num_layers,
                     "free_disk_bytes": free}
        legs = (("migration", lambda: kv_migration(dev, model, prompts,
                                                  KVMOVE["new"])),
                ("pull_gang", lambda: kv_pull_and_gang(dev, model, prompts)),
                ("tier", lambda: kv_tier(dev, model, prompts, others)),
                ("swap", lambda: kv_swap(dev, model, prompts,
                                         KVMOVE["new"])))
        for key, leg in legs:
            t0 = time.perf_counter()
            rec[key] = leg()
            rec[key]["leg_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(KVMOVE_DIR, ignore_errors=True)
    launches = {"k1": 0, "k1_chunk": 0, "k1_split": 0}
    for part in (rec["migration"], rec["pull_gang"]["pull"],
                 rec["pull_gang"]["gang"], rec["tier"], rec["swap"]):
        for k in launches:
            launches[k] += part["launches"][k]
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[kvmove] phase {rec['seconds']:.1f} s ("
        + ", ".join(f"{k} {rec[k]['leg_s']:.1f} s" for k, _ in legs)
        + f"); K1 {launches}")
    return rec


# ---------------------------------------------------------------------------
# observe: telemetry and HF import (phase 13)
# ---------------------------------------------------------------------------

#: the observe phase: llama2-7b's HF-layout weights (seed), the serve's
#: tenants and alternations, and the plans packed off the path
OBSERVE = dict(name="llama2-7b", seed=5, serves=3,
               tenants=("tenant-a", "tenant-b"), plans=1000, train_steps=3)
#: Llama-2-7B's published config.json values (the HF hub's
#: meta-llama/Llama-2-7b-hf), as a loaded checkpoint's config carries them
LLAMA2_7B_CONFIG_JSON = dict(
    model_type="llama", architectures=["LlamaForCausalLM"],
    hidden_act="silu", hidden_size=4096, intermediate_size=11008,
    num_attention_heads=32, num_hidden_layers=32, num_key_value_heads=32,
    vocab_size=32000, rms_norm_eps=1e-5, rope_theta=10000.0,
    max_position_embeddings=4096, rope_scaling=None,
    tie_word_embeddings=False, torch_dtype="float16")
OBSERVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "observe.tmp")
#: the imported engine's first stream against the dense bf16 oracle:
#: logits by max |error| over max |oracle logit|, and a token may part from
#: the oracle's argmax only where the oracle's top-2 gap is within twice
#: that step's max |logits error| (a near-tie, recorded). K1 in bf16 is held
#: to 1e-2 of max |plain| per call (K1_TOL: p rounds to bf16 before the PV
#: product); through 32 layers that compounds to between sqrt(32) x 1e-2 ~
#: 0.06 (independent errors) and 32 x 1e-2 = 0.32 (aligned ones): 0.2
OBSERVE_LOGITS_TOL = 0.2
#: reqtrace's TTFT against this script's own put-to-first-commit time
OBSERVE_TTFT_TOL_S = 5e-3


def hf_llama_state_dict(cfg, dev, seed: int) -> dict:
    """Seeded weights for the llama-family ``cfg`` under HF's names and
    layout (torch Linear ``[out, in]``, bf16, an untied ``lm_head``), in
    host memory as a loaded checkpoint holds them: each tensor drawn on
    the card (N(0, 0.02), norms N(1, 0.05)) and copied to the host."""
    E, H, KV, D = cfg.hidden_size, cfg.num_heads, cfg.kv_heads, cfg.head_dim
    F, V = cfg.ffn_size, cfg.vocab_size
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def draw(*shape, mean=0.0, std=0.02):
        t = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return t.mul_(std).add_(mean).to(torch.bfloat16).cpu()

    sd = {"model.embed_tokens.weight": draw(V, E)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = draw(E, mean=1.0, std=0.05)
        sd[p + "self_attn.q_proj.weight"] = draw(H * D, E)
        sd[p + "self_attn.k_proj.weight"] = draw(KV * D, E)
        sd[p + "self_attn.v_proj.weight"] = draw(KV * D, E)
        sd[p + "self_attn.o_proj.weight"] = draw(E, H * D)
        sd[p + "post_attention_layernorm.weight"] = draw(E, mean=1.0,
                                                         std=0.05)
        sd[p + "mlp.gate_proj.weight"] = draw(F, E)
        sd[p + "mlp.up_proj.weight"] = draw(F, E)
        sd[p + "mlp.down_proj.weight"] = draw(E, F)
    sd["model.norm.weight"] = draw(E, mean=1.0, std=0.05)
    sd["lm_head.weight"] = draw(V, E)
    return sd


def check_hf_leaves(tag, params, sd, cfg, dev) -> int:
    """Every converted leaf against its source under the documented map, bit
    for bit, with plain indexing: Linear weights transposed and split into
    heads; q and k's head dims reordered from HF's half split to pairs
    (``out[..., 2j] = src[..., j]``, ``out[..., 2j + 1] = src[..., j +
    D/2]``); norms and the embedding as they are. Every source tensor is
    used once and every leaf checked. Returns the leaves checked."""
    from deepspeed_tpu_torch.inference.weights import flatten_tree

    E, H, KV, D = cfg.hidden_size, cfg.num_heads, cfg.kv_heads, cfg.head_dim
    flat = flatten_tree(params)
    used: set[str] = set()
    checked: set[str] = set()

    def src(key):
        used.add(key)
        return sd[key].to(dev)

    def heads(w, n, rope):
        x = w.T.reshape(E, n, D)
        if not rope:
            return x
        out = torch.empty_like(x)
        out[:, :, 0::2] = x[:, :, :D // 2]
        out[:, :, 1::2] = x[:, :, D // 2:]
        return out

    def same(name, want):
        leaf = flat[name]
        checked.add(name)
        if leaf.dtype != want.dtype or leaf.shape != want.shape \
                or not torch.equal(leaf, want):
            raise AssertionError(f"[{tag}] leaf {name} ({leaf.dtype} "
                                 f"{tuple(leaf.shape)}) is not its source "
                                 f"under the map")

    same("embed", src("model.embed_tokens.weight"))
    same("unembed", src("lm_head.weight").T)
    same("ln_final.scale", src("model.norm.weight"))
    for i in range(cfg.num_layers):
        p, q = f"model.layers.{i}.", f"layer_{i}."
        same(q + "ln_attn.scale", src(p + "input_layernorm.weight"))
        same(q + "ln_ffn.scale", src(p + "post_attention_layernorm.weight"))
        same(q + "attn.wq", heads(src(p + "self_attn.q_proj.weight"), H,
                                  True))
        same(q + "attn.wk", heads(src(p + "self_attn.k_proj.weight"), KV,
                                  True))
        same(q + "attn.wv", heads(src(p + "self_attn.v_proj.weight"), KV,
                                  False))
        same(q + "attn.wo", src(p + "self_attn.o_proj.weight").T
             .reshape(H, D, E))
        same(q + "ffn.w_gate", src(p + "mlp.gate_proj.weight").T)
        same(q + "ffn.w_up", src(p + "mlp.up_proj.weight").T)
        same(q + "ffn.w_down", src(p + "mlp.down_proj.weight").T)
    if used != set(sd) or checked != set(flat):
        raise AssertionError(
            f"[{tag}] sources unused {sorted(set(sd) - used)[:4]}, leaves "
            f"unchecked {sorted(set(flat) - checked)[:4]}")
    return len(checked)


def rss_bytes() -> int:
    """This process's resident set now (``VmRSS``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def observe_import(dev) -> tuple:
    """(a) llama2-7b from an HF-layout state dict in host memory, converted
    onto the card by ``models.hf.from_hf_model``. Returns (model, params,
    record)."""
    import resource
    from types import SimpleNamespace

    from deepspeed_tpu_torch.models import PRESETS
    from deepspeed_tpu_torch.models.hf import from_hf_model

    tag = "observe import"
    preset = PRESETS[OBSERVE["name"]]
    rss0 = rss_bytes()
    t0 = time.perf_counter()
    sd = hf_llama_state_dict(preset, dev, OBSERVE["seed"])
    rss_sd = rss_bytes()
    nbytes = sum(t.numel() * t.element_size() for t in sd.values())
    draw_s = time.perf_counter() - t0
    hf = SimpleNamespace(config=SimpleNamespace(**LLAMA2_7B_CONFIG_JSON),
                         state_dict=lambda: sd)
    # the yardstick: the same tensors copied to the card as they are
    free_cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in sd.values():
        t.to(dev)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    free_cuda()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model, params = from_hf_model(hf, device=dev)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    rss_converted = rss_bytes()
    peak_dev = torch.cuda.max_memory_allocated(dev) - base
    rss_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    if dataclasses.replace(model.config, dtype=preset.dtype) != preset:
        raise AssertionError(f"[{tag}] config {model.config} != the "
                             f"{OBSERVE['name']} preset")
    leaves = check_hf_leaves(tag, params, sd, model.config, dev)
    for name, p in model.named_parameters():
        if p.device != dev:
            raise AssertionError(f"[{tag}] {name} on {p.device}")
    rec = dict(source_bytes=nbytes, draw_s=draw_s, convert_s=convert_s,
               convert_GBps=nbytes / convert_s / 1e9, copy_s=copy_s,
               copy_GBps=nbytes / copy_s / 1e9, leaves=leaves,
               peak_host_rss_bytes=rss_peak, rss_before_bytes=rss0,
               rss_with_state_dict_bytes=rss_sd,
               rss_after_convert_bytes=rss_converted,
               peak_device_bytes_over_base=peak_dev,
               resident_device_bytes=torch.cuda.memory_allocated(dev) - base)
    log(f"[{tag}] {OBSERVE['name']} ({model.config.num_layers} layers) from "
        f"a {nbytes / 1e9:.2f} GB bf16 HF-layout state dict in host memory "
        f"(drawn in {draw_s:.1f} s): converted onto the card in "
        f"{convert_s:.2f} s, {rec['convert_GBps']:.2f} GB/s (the tensors "
        f"copied as they are: {copy_s:.2f} s, {rec['copy_GBps']:.2f} GB/s); "
        f"config equals "
        f"the preset but dtype; {leaves} leaves bit for bit their sources "
        f"under the map, no source left over; host RSS {rss0 / 1e9:.2f} GB "
        f"before, {rss_sd / 1e9:.2f} with the state dict, "
        f"{rss_converted / 1e9:.2f} after the conversion (the process's "
        f"peak {rss_peak / 1e9:.2f}); device peak {peak_dev / 1e9:.2f} GB "
        f"over the {rec['resident_device_bytes'] / 1e9:.2f} GB kept")
    del sd, hf
    gc.collect()
    return model, params, rec


def observe_prompts(vocab: int, serve: int) -> list:
    """The serve phase's traffic for serve number ``serve``: the shared
    128-token system prefix (the same every serve) and fresh suffixes to
    256-1024 tokens, so each serve prefills like the serve phase's first."""
    lens, sys_len = TRAFFIC["shared-prefix"][:2]
    system = torch.randint(0, vocab, (sys_len,),
                           generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(1000 + serve)
    return [system.tolist() + torch.randint(0, vocab, (n - sys_len,),
                                            generator=g).tolist()
            for n in lens]


def observe_engine(model, params, dev, cls=None, **over):
    """The serve phase's engine settings over the imported weights (shared,
    not copied), a first request publishing the system prefix and every
    decode program captured."""
    from deepspeed_tpu_torch.inference import InferenceEngineV2

    lens, sys_len, new, max_seq_len, num_blocks = TRAFFIC["shared-prefix"]
    eng = (cls or InferenceEngineV2)(model, params=params, config=dict(
        block_size=64, num_blocks=num_blocks, max_seqs=8, chunk=256,
        max_seq_len=max_seq_len, decode_window=8, dtype=torch.bfloat16,
        device=dev, **over))
    if eng.params["layer_0"]["attn"]["wq"].data_ptr() != \
            params["layer_0"]["attn"]["wq"].data_ptr():
        raise AssertionError("[observe] the engine copied the weights")
    first = observe_prompts(model.config.vocab_size, -1)[0][:sys_len + 64]
    eng.generate([first], max_new_tokens=8)
    eng.warm_decode_windows()
    eng.warm_decode_step()
    return eng


def telemetry_host_cost(eng, n: int = 2000) -> dict:
    """The host work telemetry adds to a window dispatch, timed alone
    (after the scrapes; its series are not checked again): the dispatch
    span (perf_counter pair, ring slot, ``record_function`` + NVTX range),
    the dispatch-side recorder, and the window's 8 lifecycle events (into
    the tracer's unattributed ring here). µs each."""
    telem, rt = eng._telem, eng._rt
    out = {}
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with telem.span("dispatch", kind="window", W=8):
            pass
    out["span_us"] = (time.perf_counter_ns() - t0) / n / 1e3
    t0 = time.perf_counter_ns()
    for _ in range(n):
        eng._record_dispatch_telemetry("decode_window", 8, 8, ())
    out["recorder_us"] = (time.perf_counter_ns() - t0) / n / 1e3
    t0 = time.perf_counter_ns()
    for _ in range(n):
        for _ in range(8):
            rt.event(-1, "decode_window", W=8, tokens=8)
    out["events_us"] = (time.perf_counter_ns() - t0) / n / 1e3
    return out


def observe_serve(tag, eng, prompts, new, record_plans=None) -> dict:
    """The 8 requests through put/step/flush under two tenants, every
    decode program captured beforehand. This script's own TTFT is put →
    the drain that hands the uid's first token to the host (the engine's
    commit, where both packages time TTFT), stamped by a wrapper around
    ``_drain`` that reads no telemetry; p50 TTFT as the serve phase takes
    it (from the serve's start to step()'s return)."""
    cfg = eng.mcfg
    captured0, replays0 = captured(eng), graph_replays(eng)
    for k in list(eng.stats):
        eng.stats[k] = 0 if not isinstance(eng.stats[k], float) else 0.0
    plans0 = eng.scheduler.native_plans
    committed: dict[int, float] = {}
    drain = eng._drain

    def stamped(*a, **kw):
        out = drain(*a, **kw)
        now = time.perf_counter()
        for u, toks in out.items():
            if toks and u not in committed:
                committed[u] = now
        return out

    eng._drain = stamped
    # every window dispatch timed whole (plan, dispatch, the recorders)
    window_us: list[float] = []
    dispatch_window = eng._try_dispatch_window

    def timed_window(*a, **kw):
        t = time.perf_counter_ns()
        ok = dispatch_window(*a, **kw)
        if ok:
            window_us.append((time.perf_counter_ns() - t) / 1e3)
        return ok

    eng._try_dispatch_window = timed_window
    native = eng.scheduler._native_build
    if record_plans is not None:
        from types import SimpleNamespace

        def recording(plan, T, entries, row_of):
            record_plans.append((plan.token_ids.shape[0], T, [
                (SimpleNamespace(uid=s.uid, slot=s.slot,
                                 blocks=list(s.blocks)), list(toks), start,
                 sample) for s, toks, start, sample in entries],
                dict(row_of)))
            return native(plan, T, entries, row_of)

        eng.scheduler._native_build = recording
    reset_counts()
    torch.cuda.synchronize()
    tail_ev, end_ev = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
    tail = None
    t_put: dict[int, float] = {}
    first: dict[int, float] = {}
    out: dict[int, list[int]] = {u: [] for u in range(len(prompts))}
    try:
        t0 = time.perf_counter()
        for uid, p in enumerate(prompts):
            t_put[uid] = time.perf_counter()
            eng.put(uid, p, max_new_tokens=new,
                    tenant=OBSERVE["tenants"][uid % 2])
        while any(not eng.query(u).get("done", True) for u in out):
            if tail is None and not eng.scheduler.pending_kinds()[0]:
                tail_ev.record()
                tail = token_steps(eng)
            emitted = eng.step()
            now = time.perf_counter() - t0
            for u, toks in emitted.items():
                if toks and u not in first:
                    first[u] = now
                out[u].extend(toks)
        end_ev.record()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        del eng._drain, eng._try_dispatch_window
        if record_plans is not None:
            del eng.scheduler._native_build
    launches = all_counts()
    st = dict(eng.stats)
    replays = check_replays(tag, eng, replays0, {})
    if captured(eng) != captured0:
        raise AssertionError(f"[{tag}] captured "
                             f"{sorted(captured(eng) - captured0)} in the "
                             f"serve")
    streams = {}
    for u in out:
        streams[u] = eng.flush(u)
        if streams[u] != out[u] or len(out[u]) != new:
            raise AssertionError(f"[{tag}] uid {u}: stream of "
                                 f"{len(out[u])}")
    eng.state.audit()
    check_launches(tag, launches, cfg, forwards=forwards_of(eng),
                   e4m3_pool=False, quant=False, bf16=True)
    plans = st["prefill_steps"] + st["decode_steps"]
    native_plans = eng.scheduler.native_plans - plans0
    if native_plans != plans or plans == 0:
        raise AssertionError(f"[{tag}] {native_plans} plans packed by "
                             f"dstpu_build_atoms for {plans} plans")
    tail_steps = token_steps(eng) - tail
    return dict(streams=streams, wall_s=wall,
                ttft_s={u: committed[u] - t_put[u] for u in out},
                ttft_p50_s=statistics.median(first.values()),
                decode_ms_per_token=tail_ev.elapsed_time(end_ev) / tail_steps,
                window_dispatch_s=st["window_dispatch_s"], window_us=window_us,
                windows=st["windows"], forced_drains=st["forced_drains"],
                opportunistic_drains=st["opportunistic_drains"],
                replays=replays, launches=launches, plans=plans,
                native_plans=native_plans)


def observe_scrape(tag, telem, port: int) -> dict:
    """/metrics and /healthz over 127.0.0.1: the serve's exact counts, the
    occupancy histograms, the page gauge and both tenants' series."""
    import urllib.request

    base = f"http://127.0.0.1:{port}"
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        text = r.read().decode()
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        health = json.loads(r.read().decode())
    n, new = len(TRAFFIC["shared-prefix"][0]), TRAFFIC["shared-prefix"][2]
    want = [f"serving_ttft_s_count {n}", f"serving_tokens_total {n * new}",
            f"serving_queue_wait_s_count {n}", f"serving_requests_total {n}",
            "serving_prefill_occupancy_count",
            "serving_decode_window_occupancy_count",
            "serving_kv_page_utilization "]
    for tenant in OBSERVE["tenants"]:
        want.append(f'serving_tenant_requests_total{{tenant="{tenant}"}} '
                    f'{n // 2}')
        want.append(f'serving_tenant_ttft_s_count{{tenant="{tenant}"}} '
                    f'{n // 2}')
    missing = [w for w in want if w not in text]
    if missing or health.get("serving") is not True:
        raise AssertionError(f"[{tag}] /metrics lacks {missing}; /healthz "
                             f"{health}")
    return dict(metrics_lines=text.count("\n"), health=health)


def observe_timelines(tag, rt, ttft: dict) -> dict:
    """8 completed timelines, every kind a lifecycle event, enqueue to
    release, each TTFT (its first commit after its enqueue) within
    OBSERVE_TTFT_TOL_S of this script's own."""
    from deepspeed_tpu_torch.telemetry import LIFECYCLE_EVENTS

    tls = rt.timelines()
    if sorted(tl["uid"] for tl in tls) != sorted(ttft):
        raise AssertionError(f"[{tag}] timelines for "
                             f"{sorted(tl['uid'] for tl in tls)}")
    worst = 0.0
    for tl in tls:
        kinds = [e["kind"] for e in tl["events"]]
        if kinds[0] != "enqueue" or kinds[-1] != "release" or \
                not set(kinds) <= set(LIFECYCLE_EVENTS) or \
                tl["events_dropped"]:
            raise AssertionError(f"[{tag}] uid {tl['uid']}: {kinds}")
        t_first = next(e["t"] for e in tl["events"] if e["kind"] == "commit")
        mine = t_first - tl["events"][0]["t"]
        worst = max(worst, abs(mine - ttft[tl["uid"]]))
    if worst > OBSERVE_TTFT_TOL_S:
        raise AssertionError(f"[{tag}] reqtrace TTFT {worst * 1e3:.2f} ms "
                             f"off this script's")
    return dict(timelines=len(tls), ttft_max_diff_s=worst)


def observe_oracle(tag, model, params, dev, want_stream) -> dict:
    """The first request's greedy stream on a tap engine (the same weights
    and serve, its programs also returning logits) equals the observed
    one, and is held against the dense oracle (``attn_impl="xla"``) in the
    parity phase's form at bf16 (OBSERVE_LOGITS_TOL)."""
    from deepspeed_tpu_torch.models.transformer import TransformerLM

    eng = observe_engine(model, params, dev, cls=tap_engine_class())
    prompts = observe_prompts(model.config.vocab_size, 0)
    new = TRAFFIC["shared-prefix"][2]
    eng.taps.clear()                  # the first request's
    got = eng.generate(prompts, max_new_tokens=new)
    taps = eng.taps[0]
    del eng
    free_cuda()
    if got[0] != want_stream:
        raise AssertionError(f"[{tag}] the tap engine's first stream is "
                             f"not the observed one")
    oracle = TransformerLM(dataclasses.replace(model.config,
                                               attn_impl="xla"),
                           device="meta", param_dtype=torch.bfloat16)
    from deepspeed_tpu_torch.inference.weights import flatten_tree

    oracle.load_state_dict(flatten_tree(params), strict=True, assign=True)
    worst, near, seq = 0.0, [], list(prompts[0])
    with torch.no_grad():
        for k, tok in enumerate(got[0]):
            ref = oracle(torch.tensor([seq], device=dev))[0, -1].float()
            ours = taps[k].to(dev)
            err = (ours - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            worst = max(worst, rel)
            if rel > OBSERVE_LOGITS_TOL:
                raise AssertionError(f"[{tag}] step {k}: logits {rel:.2e} "
                                     f"relative off the oracle's")
            if int(ref.argmax()) != tok:
                top2 = torch.topk(ref, 2).values
                gap = (top2[0] - top2[1]).item()
                if gap > 2 * err:
                    raise AssertionError(
                        f"[{tag}] step {k}: token {tok} != oracle "
                        f"{int(ref.argmax())}, top-2 gap {gap:.3e} > 2 x "
                        f"{err:.3e}")
                near.append((k, gap, err))
                log(f"[{tag}] NEAR-TIE step {k}: oracle top-2 gap "
                    f"{gap:.3e} within 2 x the step's logits error "
                    f"{err:.3e}")
            seq.append(tok)
    del oracle
    free_cuda()
    return dict(max_rel_logits_err=worst, near_ties=near, tokens=len(got[0]))


def observe_plans(tag, recorded) -> dict:
    """(c) The serve's plans, OBSERVE["plans"] of them cycled, packed by
    both packers into fresh arrays off the path: equal, with each one's
    host µs a plan."""
    import numpy as np

    from deepspeed_tpu_torch.inference.ragged import StateManager, StepPlan
    from deepspeed_tpu_torch.inference.scheduler import SplitFuseScheduler

    lens, sys_len, new, max_seq_len, num_blocks = TRAFFIC["shared-prefix"]
    st = StateManager(num_blocks, 64, 8, -(-max_seq_len // 64))
    sched = SplitFuseScheduler(st, 256)
    mb = st.max_blocks_per_seq
    names = ("token_ids", "positions", "slot_map", "active", "block_tables",
             "seq_lens", "sample_idx", "do_sample")

    def fresh(S, T):
        return StepPlan(
            kind="prefill", token_ids=np.zeros((S, T), np.int32),
            positions=np.zeros((S, T), np.int32),
            slot_map=np.zeros((S, T), np.int32),
            active=np.zeros((S, T), np.uint8),
            block_tables=np.zeros((S, mb), np.int32),
            seq_lens=np.zeros(S, np.int32),
            sample_idx=np.zeros(S, np.int32),
            do_sample=np.zeros(S, np.uint8))

    native_ns = python_ns = 0
    for i in range(OBSERVE["plans"]):
        S, T, entries, row_of = recorded[i % len(recorded)]
        a, b = fresh(S, T), fresh(S, T)
        t0 = time.perf_counter_ns()
        sched._native_build(a, T, entries, row_of)
        t1 = time.perf_counter_ns()
        sched._python_build(b, T, entries, row_of)
        t2 = time.perf_counter_ns()
        native_ns += t1 - t0
        python_ns += t2 - t1
        for n in names:
            if not np.array_equal(getattr(a, n), getattr(b, n)):
                raise AssertionError(f"[{tag}] plan {i}: {n} differs")
    n = OBSERVE["plans"]
    rec = dict(plans=n, distinct=len(recorded),
               native_us=native_ns / n / 1e3, python_us=python_ns / n / 1e3)
    log(f"[{tag}] {n} plans of the serve's {len(recorded)} shapes packed "
        f"both ways off the path, equal: dstpu_build_atoms "
        f"{rec['native_us']:.1f} host us a plan, the Python packer "
        f"{rec['python_us']:.1f}")
    return rec


def train_step_flops(spec: dict) -> float:
    """This script's own count of a train step's model FLOPs for ``spec``
    (a dense llama-family preset): 3 x the forward's 2 per weight of every
    product per token plus 4 x head_dim per query head and causal pair."""
    from deepspeed_tpu_torch.models import get_model_config

    c = get_model_config(spec["name"])
    E, H, KV, D, F, V = (c.hidden_size, c.num_heads, c.kv_heads, c.head_dim,
                         c.ffn_size, c.vocab_size)
    L, S = spec["layers"], spec["seq"]
    rows = spec["micro"] * spec["gas"]
    weights = L * (2 * E * H * D + 2 * E * KV * D + 3 * E * F) + V * E
    fwd = 2.0 * weights * rows * S + 4.0 * D * H * L * S * (S + 1) / 2 * rows
    return 3.0 * fwd


def observe_train(dev, telem, port: int, card: str) -> dict:
    """(d) The train phase's 8-layer spec, OBSERVE["train_steps"] steps
    through K4: with the three off (first, so that whatever the first step
    of a process loads is loaded), then with the telemetry section, the CSV
    monitor (under OBSERVE_DIR) and the Prometheus backend. Losses bit for
    bit; the MFU gauge — over every step of the run, the first included, as
    the tracker counts a run — within 2% of this script's FLOPs over its
    own step times and PEAK_OPS[bf16]; a CSV row per step; the Prometheus
    backend's gauges on /metrics. Also prints the steady MFU (the steps
    after the first, by this script's times)."""
    import urllib.request

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model

    spec = dict(TRAIN, steps=OBSERVE["train_steps"])
    tag = f"observe train {spec['name']} x{spec['layers']}"
    L, gas, steps = spec["layers"], spec["gas"], spec["steps"]
    runs = {}
    for label in ("off", "on"):
        over = dict(activation_checkpointing={"policy": "full"},
                    steps_per_print=1, wall_clock_breakdown=True)
        if label == "on":
            telem.reconfigure(enabled=True)
            telem.registry.reset()
            over.update(telemetry={"enabled": True},
                        csv_monitor={"enabled": True,
                                     "output_path": OBSERVE_DIR,
                                     "job_name": "train"},
                        prometheus={"enabled": True, "port": port})
        else:
            telem.reconfigure(enabled=False)
        free_cuda()
        model = build_model(spec["name"], num_layers=L,
                            dtype=torch.bfloat16, param_dtype=torch.float32,
                            device=dev, seed=0)
        engine, *_ = dst.initialize(model=model,
                                    config=train_config(spec, **over))
        batch = train_batch_of(spec, model.config.vocab_size, seed=3)
        reset_counts()
        losses, step_s = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            step_s.append(time.perf_counter() - ts)
        launches = all_counts()
        want = {k: 0 for k in launches}
        want.update(k4_fwd=L * gas * 2 * steps, k4_bwd=L * gas * steps)
        if launches != want:
            raise AssertionError(f"[{tag} {label}] launches {launches}")
        runs[label] = dict(losses=losses, step_s=step_s, launches=launches)
        if label == "on":
            snap = telem.registry.snapshot()
            m = snap["train_mfu"]["series"][0]["value"]
            g = snap["train_goodput"]["series"][0]["value"]
            own = train_step_flops(spec) * steps / (
                sum(step_s) * PEAK_OPS[torch.bfloat16])
            if abs(m - own) > 0.02 * own or g != m:
                raise AssertionError(f"[{tag}] MFU gauge {m:.6g}, goodput "
                                     f"{g:.6g}, own {own:.6g} (step "
                                     f"FLOPs {engine._step_flops:.6g}, this "
                                     f"script's {train_step_flops(spec):.6g}"
                                     f")")
            csv = os.path.join(OBSERVE_DIR, "train",
                               "Train_train_batch_ms.csv")
            with open(csv) as f:
                rows = f.read().strip().split("\n")[1:]
            if [r.split(",")[0] for r in rows] != \
                    [str(i + 1) for i in range(steps)]:
                raise AssertionError(f"[{tag}] CSV rows {rows}")
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                        timeout=30) as r:
                text = r.read().decode()
            if "Train_train_batch_ms " not in text or \
                    f"monitor_last_step {float(steps)}" not in text:
                raise AssertionError(f"[{tag}] /metrics lacks the "
                                     f"Prometheus backend's gauges")
            steady = train_step_flops(spec) / (
                statistics.mean(step_s[1:]) * PEAK_OPS[torch.bfloat16])
            runs[label].update(mfu=m, goodput=g, own_mfu=own,
                               steady_mfu=steady,
                               step_flops=engine._step_flops,
                               csv_rows=len(rows))
        engine.close()
        del engine, model
        free_cuda()
    if runs["on"]["losses"] != runs["off"]["losses"]:
        raise AssertionError(f"[{tag}] losses {runs['on']['losses']} with "
                             f"telemetry, {runs['off']['losses']} without")
    on = runs["on"]
    log(f"[{tag}] {card}: losses bit for bit with and without telemetry "
        f"({', '.join(f'{x:.4f}' for x in on['losses'])}); MFU "
        f"{on['mfu']:.4f} (this script's {on['own_mfu']:.4f}), goodput "
        f"{on['goodput']:.4f}, steady (steps 2-{steps}) "
        f"{on['steady_mfu']:.4f}; {on['csv_rows']} CSV rows; ms per step on "
        f"{statistics.mean(on['step_s'][1:]) * 1e3:.1f}, off "
        f"{statistics.mean(runs['off']['step_s'][1:]) * 1e3:.1f}; K4 "
        f"{on['launches']['k4_fwd']} / {on['launches']['k4_bwd']}")
    return runs


def observe_breach(dev, model, params, telem) -> dict:
    """(e) Last, once every timed leg of every phase has run (a profiler's
    CUPTI tracing stays subscribed): a 1 ms TTFT SLO with
    ``breach_profile_dir`` makes the one request breach; the capture's
    Chrome trace names the engine's ``dispatch`` ranges and the K1 kernels
    the decode graphs replayed."""
    import glob

    tag = "observe breach"
    rt = telem.reqtrace
    prof_dir = os.path.join(OBSERVE_DIR, "breach")
    telem.reconfigure(enabled=True, reqtrace=True)
    eng = observe_engine(model, params, dev, telemetry=True, reqtrace=True)
    prompts = observe_prompts(model.config.vocab_size, 0)
    new = TRAFFIC["shared-prefix"][2]
    # the SLO and the capture armed once the warm-up and the captures ran
    telem.reconfigure(slo_ttft_s=1e-3, breach_interval_s=0.0,
                      breach_profile_dir=prof_dir, breach_profile_s=0.3,
                      flight_recorder_path=os.path.join(OBSERVE_DIR,
                                                        "flight.json"))
    breaches0 = rt.breaches
    reset_counts()
    eng.generate(prompts[:1], max_new_tokens=new)
    rt.finish_profile()
    k1 = all_counts()["k1"]
    traces = sorted(glob.glob(os.path.join(prof_dir, "breach_*.json")))
    if rt.breaches - breaches0 != 1 or not traces:
        raise AssertionError(f"[{tag}] {rt.breaches - breaches0} breaches, "
                             f"traces {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    dispatch = sum(n == "dispatch" for n in names)
    k1_named = sum("ragged_paged_attn" in n for n in names)
    if not dispatch or not k1_named:
        raise AssertionError(f"[{tag}] the trace names {dispatch} dispatch "
                             f"ranges and {k1_named} K1 kernels")
    rt.slo_ttft_s = None
    rt.breach_profile_dir = None
    del eng
    free_cuda()
    rec = dict(breaches=1, trace_events=len(events), dispatch_ranges=dispatch,
               k1_kernels_named=k1_named, k1_launches=k1)
    log(f"[{tag}] one request past a 1 ms TTFT SLO: flight dump and a "
        f"torch.profiler capture of {len(events)} events naming {dispatch} "
        f"dispatch ranges and {k1_named} K1 kernel runs ({k1} K1 launches "
        f"in the serve)")
    return rec


def phase_observe(dev) -> dict:
    """See the module docstring, phase 13."""
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.accelerator import card_name_and_power_limit

    t_phase = time.perf_counter()
    card = card_name_and_power_limit()
    log(f"[observe] {card}")
    shutil.rmtree(OBSERVE_DIR, ignore_errors=True)
    os.makedirs(OBSERVE_DIR)
    telem = telemetry.get_telemetry()
    rec: dict = {"card": card}
    try:
        model, params, rec["import"] = observe_import(dev)
        # (b) the observed serve against the same weights without telemetry
        telem.reconfigure(enabled=True, reqtrace=True)
        port = telem.start_http(0)
        on = observe_engine(model, params, dev, telemetry=True,
                            reqtrace=True)
        off = observe_engine(model, params, dev, telemetry=False)
        if off._telem.enabled or off._rt.enabled or not on._rt.enabled:
            raise AssertionError("[observe] telemetry pins")
        vocab, new = model.config.vocab_size, TRAFFIC["shared-prefix"][2]
        # one untimed serve each first: the serve's shapes meet cuBLAS and
        # the kernels' caches once, before either timed serve
        for eng in (on, off):
            observe_serve("observe warm", eng, observe_prompts(vocab, -2),
                          new)
        serves = {"on": [], "off": []}
        recorded: list = []
        for i in range(OBSERVE["serves"]):
            prompts = observe_prompts(vocab, i)
            # the pair's order alternates: on first, then off first, ...
            order = (("on", on), ("off", off))[::1 if i % 2 == 0 else -1]
            for label, eng in order:
                tag = f"observe serve {label} {i + 1}"
                if label == "on":
                    telem.reset_metrics()
                    telem.tracer.clear()
                    telem.reqtrace.clear()
                res = observe_serve(tag, eng, prompts, new,
                                    recorded if (label, i) == ("on", 0)
                                    else None)
                if label == "on":
                    res["scrape"] = observe_scrape(tag, telem, port)
                    res["reqtrace"] = observe_timelines(tag, telem.reqtrace,
                                                        res["ttft_s"])
                    path = telem.export_chrome_trace(
                        os.path.join(OBSERVE_DIR, f"serve{i}.json"))
                    with open(path) as f:
                        names = {e["name"] for e in
                                 json.load(f)["traceEvents"]}
                    if not {"admit", "dispatch", "drain_block"} <= names:
                        raise AssertionError(f"[{tag}] spans {names}")
                serves[label].append(res)
            a, b = serves["on"][-1], serves["off"][-1]
            # the dispatches and their commits; which drain waits (forced)
            # is the host's timing against the device's (PERF.md §6)
            same = {k: a[k] == b[k] for k in ("streams", "replays",
                                               "windows", "plans")}
            same["drains"] = a["forced_drains"] + a["opportunistic_drains"] \
                == b["forced_drains"] + b["opportunistic_drains"]
            same["k1"] = a["launches"] == b["launches"]
            if not all(same.values()):
                raise AssertionError(
                    f"[observe] serve {i + 1}: on vs off {same}; forced / "
                    f"opportunistic drains {a['forced_drains']}/"
                    f"{a['opportunistic_drains']} vs {b['forced_drains']}/"
                    f"{b['opportunistic_drains']}")
        host_cost = telemetry_host_cost(on)
        first = serves["on"][0]["streams"][0]
        del on, off
        free_cuda()

        def med(label, key):
            return statistics.median(r[key] for r in serves[label])

        summary = {label: {
            "decode_ms_per_token": med(label, "decode_ms_per_token"),
            "ttft_p50_s": med(label, "ttft_p50_s"),
            # every window of the serves: their dispatch seconds summed
            "window_dispatch_us": 1e6 * sum(r["window_dispatch_s"]
                                            for r in serves[label])
            / sum(r["windows"] for r in serves[label]),
            # each window's whole dispatch call, the recorders included
            "window_call_us_p50": statistics.median(
                u for r in serves[label] for u in r["window_us"]),
            "window_call_us_mean": statistics.mean(
                u for r in serves[label] for u in r["window_us"])}
            for label in serves}
        rec["serve"] = {"summary": summary, "host_cost": host_cost,
                        "runs": {
            label: [{k: v for k, v in r.items() if k not in ("streams",
                                                             "ttft_s")}
                    for r in runs] for label, runs in serves.items()}}
        s_on, s_off = summary["on"], summary["off"]
        log(f"[observe serve] {card}: {OBSERVE['serves']} serves each, "
            f"streams, replays, windows, plans, drains and K1 launches "
            f"equal on and off (forced drains on / off "
            f"{[r['forced_drains'] for r in serves['on']]} / "
            f"{[r['forced_drains'] for r in serves['off']]}); "
            f"on / off: decode {s_on['decode_ms_per_token']:.3f} / "
            f"{s_off['decode_ms_per_token']:.3f} ms a token-step (medians), "
            f"{s_on['window_dispatch_us']:.1f} / "
            f"{s_off['window_dispatch_us']:.1f} host us a window dispatch "
            f"(every window; the whole dispatch call, recorders included: "
            f"median {s_on['window_call_us_p50']:.1f} / "
            f"{s_off['window_call_us_p50']:.1f}, mean "
            f"{s_on['window_call_us_mean']:.1f} / "
            f"{s_off['window_call_us_mean']:.1f}), p50 TTFT "
            f"{s_on['ttft_p50_s']:.4f} / "
            f"{s_off['ttft_p50_s']:.4f} s (medians); the added work timed "
            f"alone: span {host_cost['span_us']:.2f} us, recorder "
            f"{host_cost['recorder_us']:.2f} us, 8 events "
            f"{host_cost['events_us']:.2f} us; reqtrace TTFT within "
            f"{max(r['reqtrace']['ttft_max_diff_s'] for r in serves['on']) * 1e3:.2f}"
            f" ms of this script's; "
            f"{sum(r['native_plans'] for r in serves['on'])} plans of the "
            f"on-serves packed by dstpu_build_atoms")
        rec["oracle"] = observe_oracle("observe oracle", model, params, dev,
                                       first)
        log(f"[observe oracle] the first stream ({rec['oracle']['tokens']} "
            f"tokens) against the dense bf16 oracle: logits within "
            f"{rec['oracle']['max_rel_logits_err']:.2e} relative, "
            f"{len(rec['oracle']['near_ties'])} near-ties")
        rec["plans"] = observe_plans("observe plans", recorded)
        del model, params
        free_cuda()
        rec["train"] = observe_train(dev, telem, port, card)
        rec["launches"] = {
            "k1": sum(r["launches"]["k1"] for runs in serves.values()
                      for r in runs),
            "k4_fwd": sum(r["launches"]["k4_fwd"]
                          for r in rec["train"].values()),
            "k4_bwd": sum(r["launches"]["k4_bwd"]
                          for r in rec["train"].values())}
    finally:
        telem.stop_http()
        telem.reconfigure(enabled=False, reqtrace=False)
        shutil.rmtree(OBSERVE_DIR, ignore_errors=True)
        free_cuda()
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[observe] (a)-(d) {rec['seconds']:.1f} s; launches "
        f"{rec['launches']}")
    return rec


def phase_observe_breach(dev) -> dict:
    """Phase 13 (e), run last of all: the breach capture over the seeded
    llama2-7b (full depth, bf16), its telemetry set up as in (b)."""
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.inference.weights import module_param_tree
    from deepspeed_tpu_torch.models import build_model

    t_phase = time.perf_counter()
    shutil.rmtree(OBSERVE_DIR, ignore_errors=True)
    os.makedirs(OBSERVE_DIR)
    telem = telemetry.get_telemetry()
    try:
        model = build_model(OBSERVE["name"], dtype=torch.bfloat16,
                            device=dev, seed=OBSERVE["seed"])
        rec = observe_breach(dev, model, module_param_tree(model), telem)
        del model
    finally:
        telem.reconfigure(enabled=False, reqtrace=False)
        shutil.rmtree(OBSERVE_DIR, ignore_errors=True)
        free_cuda()
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


# ---------------------------------------------------------------------------
# fleet: the serving fleet behind the port's router (phase 14)
# ---------------------------------------------------------------------------

#: the fleet phase's replicas: llama2-7b at full width, 16 of its 32 layers
#: (the script's time limit since the tp phase joined), bf16, one seed;
#: ``overrides`` and ``device`` reach the replicas' configs (None on the
#: card: the CUDA device)
FLEET = dict(name="llama2-7b", seed=7, new=64,
             overrides={"num_layers": 16}, device=None)
#: the serve phase's engine settings
FLEET_ENGINE = {"block_size": 64, "num_blocks": 256, "max_seqs": 8,
                "chunk": 256, "max_inflight": 8, "max_seq_len": 2048}
#: the teacher-forced oracle's near-tie bound, in logits: a fleet token
#: that is not the dense oracle's argmax must sit within this of the top
#: logit. fp32 streams hold to 1e-4 (the parity phase); this engine in
#: bf16 at llama2-7b's 32 layers sat up to 0.48 off the same dense oracle
#: per step in the observe phase's chip runs, its near-ties' top-2
#: gaps up to 0.22: the bound is twice that error. A token drawn away from
#: the top (a wrong splice) sits ~4 of the random model's logit spreads
#: (~1.1) below it
FLEET_TIE_GAP = 1.0
FLEET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "fleet.tmp")
#: a handoff ring no larger than this share of /dev/shm's free space
FLEET_SHM_SHARE = 0.5
FLEET_SHM_MAX = 4 << 30


def fleet_router(tag: str, roles: list, per_slot: dict | None = None,
                 **rkw):
    """A router over ``len(roles)`` engine replicas spawned by the port's
    ``Fleet`` (logs under ``FLEET_DIR/<tag>``). A graph capture or an export
    blocks a replica's loop, its heartbeats and its reads (a full pipe
    blocks the router's sends), so the liveness and send deadlines sit
    above them, and the start deadline above a replica's start; the radix
    pulls, gang prefill and rebalancing stay off (their cost models run on
    the JAX package's guessed CPU rates; the CPU tests hold them)."""
    from deepspeed_tpu_torch.serving import FleetConfig, Router, RouterConfig

    replica = {"backend": "engine", "model": FLEET["name"],
               "seed": FLEET["seed"], "dtype": "bfloat16",
               "device": FLEET["device"],
               "overrides": dict(FLEET["overrides"]),
               "engine": dict(FLEET_ENGINE), "hb_interval_s": 0.05}
    fcfg = FleetConfig(
        n_replicas=len(roles), replica=replica, roles=list(roles),
        per_slot=per_slot or {}, hb_timeout_s=120.0, ready_timeout_s=600.0,
        send_timeout_s=30.0, log_dir=os.path.join(FLEET_DIR, tag),
        snapshot_dir=rkw.pop("snapshot_dir", None))
    return Router(RouterConfig(
        fleet=fcfg, request_timeout_s=300.0, max_retries=3, kv_pull=False,
        gang_prefill=False, rebalance=False, kv_rate_probe=False, **rkw))


def fleet_until(router, pred, deadline_s: float, what: str,
                each=None) -> float:
    """Poll ``router`` until ``pred()``; raise past ``deadline_s``. Returns
    the seconds it took. ``each()`` runs after every poll."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > deadline_s:
            raise AssertionError(f"[fleet] {what}: not within {deadline_s} s")
        router.poll()
        if each is not None:
            each()
    return time.perf_counter() - t0


def fleet_start(router, tag: str) -> dict:
    """Spawn the fleet; each slot's spawn → READY seconds."""
    from deepspeed_tpu_torch.serving.fleet import READY

    t0 = time.perf_counter()
    router.fleet.start()
    ready: dict = {}

    def note():
        for h in router.fleet.replicas:
            if h.state == READY and h.slot not in ready:
                ready[h.slot] = time.perf_counter() - t0

    fleet_until(router, lambda: len(ready) == len(router.fleet.replicas),
                600.0, f"{tag} replicas ready", note)
    log(f"[fleet {tag}] spawn -> READY s by slot: "
        + ", ".join(f"{s}: {t:.1f}" for s, t in sorted(ready.items())))
    return ready


def fleet_wait_digests(router) -> None:
    fleet_until(router, lambda: all(h.digest for h in router.fleet.replicas),
                60.0, "residency digests")


def fleet_serve(router, prompts, tag: str, kill: bool = False,
                warm: bool = False) -> dict:
    """Submit ``prompts`` (FLEET["new"] greedy tokens each, under two
    tenants) and poll to the end, watching each request: handoffs (emit →
    ack, bytes, chunks by transport) and, with ``kill``, the kill of the
    first replica (slot 0 where it is one of them) to have streamed a
    token for a request, each orphan's replay admit and the replay's first
    token on the survivor, and the slot's respawn to READY. Returns the
    router's results and what was watched."""
    from deepspeed_tpu_torch.serving.fleet import READY

    new = FLEET["new"]
    t0 = time.perf_counter()
    tids = [router.submit(p, max_new_tokens=new, trace_id=f"{tag}{i}",
                          tenant=f"tenant-{i % 2}")
            for i, p in enumerate(prompts)]
    reqs = {t: router._reqs[t] for t in tids}
    migs: dict = {}
    killed: dict = {}

    def watch():
        now = time.monotonic()
        for tid, r in reqs.items():
            m = r.mig
            if m is not None and tid not in migs:
                migs[tid] = {"m": m, "start": m.started_t}
            rec = migs.get(tid)
            if rec is not None and "ack_s" not in rec and r.migrated:
                rec["ack_s"] = now - rec["start"]
        if not kill:
            return
        if "t" not in killed:
            streaming = sorted(r.assigned_slot for r in reqs.values()
                               if r.status == "assigned" and r.committed)
            if streaming:
                slot = killed["slot"] = streaming[0]
                killed["orphans"] = {
                    tid: r.attempt for tid, r in reqs.items()
                    if r.status == "assigned" and r.assigned_slot == slot}
                killed["epoch"] = router.fleet.replicas[slot].epoch
                killed["t"] = time.monotonic()
                router.fleet.kill_replica(slot)
            return
        slot = killed["slot"]
        for tid, attempt in killed["orphans"].items():
            r = reqs[tid]
            if r.attempt > attempt and r.assigned_slot != slot:
                killed.setdefault("admit", {}).setdefault(
                    tid, r.assign_t - killed["t"])
                if r.last_activity_t > r.assign_t:
                    killed.setdefault("first", {}).setdefault(
                        tid, r.last_activity_t - r.assign_t)
        h = router.fleet.replicas[slot]
        if "ready_s" not in killed and h.state == READY \
                and h.epoch > killed["epoch"]:
            killed["ready_s"] = time.monotonic() - killed["t"]

    ended: list = []

    def done():
        if not ended and all(r.status not in ("queued", "assigned",
                                              "recovering", "gang")
                             for r in reqs.values()):
            ended.append(time.perf_counter())
        return bool(ended) and (not kill or "ready_s" in killed)

    fleet_until(router, done, 900.0, f"{tag} serve", watch)
    wall = ended[0] - t0
    res = {t: router.result(t) for t in tids}
    for t, info in res.items():
        if info["status"] != "done" or len(info["tokens"]) != new:
            raise AssertionError(f"[fleet {tag}] {t}: {info['status']} "
                                 f"{info['reason']}, {len(info['tokens'])} "
                                 f"tokens")
    if router.double_commits:
        raise AssertionError(f"[fleet {tag}] {router.double_commits} double "
                             f"commits")
    ttft = sorted(info["ttft_s"] for info in res.values())
    placed = collections.Counter(info["placed"][0] for info in res.values())
    out = {"results": res, "wall_s": wall, "placed": dict(placed),
           "committed": {t: list(r.committed) for t, r in reqs.items()},
           "tok_s": len(tids) * new / wall, "ttft_p50_s": ttft[len(ttft) // 2],
           "replay_mismatches": router.replay_mismatches}
    if migs:
        out["handoffs"] = [
            {"tid": t, "bytes": rec["m"].payload_bytes,
             "chunks": rec["m"].total, "ms": rec["ack_s"] * 1e3,
             "transport": "shm" if rec["m"].shm and not rec["m"].relayed
             else "relay"} for t, rec in migs.items() if "ack_s" in rec]
    if kill:
        orphans = sorted(killed["orphans"])
        if not orphans or set(killed.get("admit", {})) != set(orphans):
            raise AssertionError(f"[fleet {tag}] orphans {orphans}, replays "
                                 f"admitted {killed.get('admit')}")
        out["kill"] = {"slot": killed["slot"], "orphans": orphans,
                       "replay_admit_s": killed["admit"],
                       "replay_ttft_s": killed.get("first", {}),
                       "respawn_ready_s": killed["ready_s"]}
    if not warm:
        log(f"[fleet {tag}] {len(tids)} requests x {new} tokens in "
            f"{wall:.2f} s: {out['tok_s']:.1f} output tok/s, p50 TTFT "
            f"{out['ttft_p50_s']:.3f} s; first placed by slot "
            f"{dict(sorted(placed.items()))}; replay mismatches "
            f"{router.replay_mismatches}, double commits 0")
    return out


def fleet_reports(log_dir: str) -> dict:
    """Each replica incarnation's ``replica report`` (written at its clean
    exit) from the fleet's logs: ``{"<slot>.e<epoch>": report}``."""
    out = {}
    for name in sorted(os.listdir(log_dir)):
        if not name.endswith(".log"):
            continue
        with open(os.path.join(log_dir, name), encoding="utf-8",
                  errors="replace") as f:
            for line in f:
                if line.startswith("replica report "):
                    out[name[len("replica"):-len(".log")]] = json.loads(
                        line[len("replica report "):])
    return out


def check_fleet_launches(tag: str, reports: dict) -> dict:
    """Each replica's K1: one launch per layer of every forward it ran,
    every one on the bf16 chunk or split kernel, none plain; some replica
    ran forwards."""
    total = {"k1": 0, "k1_chunk": 0, "k1_split": 0}
    for key, rep in reports.items():
        k1 = rep["k1"]
        want = rep["layers"] * rep["forwards"]
        if k1["kernel"] != want or k1["plain"] or k1["kernel_e4m3"] \
                or k1["kernel_chunk"] + k1["kernel_split"] != want:
            raise AssertionError(f"[fleet {tag}] replica {key}: K1 {k1} != "
                                 f"{rep['layers']} layers x "
                                 f"{rep['forwards']} forwards")
        total["k1"] += k1["kernel"]
        total["k1_chunk"] += k1["kernel_chunk"]
        total["k1_split"] += k1["kernel_split"]
    if total["k1"] <= 0:
        raise AssertionError(f"[fleet {tag}] no K1 launch in {reports}")
    return total


def fleet_shutdown(router, tag: str) -> dict:
    """Shut every replica down cleanly and read their reports."""
    router.fleet.shutdown(deadline_s=120.0)
    codes = {h.slot: (h.proc.returncode if h.proc is not None else None)
             for h in router.fleet.replicas}
    router.close()
    if any(c != 0 for c in codes.values()):
        raise AssertionError(f"[fleet {tag}] replica exit codes {codes}")
    reports = fleet_reports(os.path.join(FLEET_DIR, tag))
    for key, rep in sorted(reports.items()):
        log(f"[fleet {tag}] replica {key}: built in {rep['build_s']:.1f} s, "
            f"{rep.get('graphs', 0)} graphs captured in "
            f"{rep.get('capture_s', 0.0):.2f} s, peak "
            f"{rep.get('peak_bytes', 0) / 1e9:.2f} GB, K1 "
            f"{rep['k1']['kernel']} over {rep['forwards']} forwards, "
            f"migrations out / in {rep['migrations_out']} / "
            f"{rep['migrations_in']}")
    return reports


def fleet_scrape(router, tag: str, served: int) -> dict:
    """(c): ``/metrics?aggregate=1`` over 127.0.0.1 merges the router and
    both replicas, ``serving_ttft_s`` counting exactly the requests the
    replicas served; the port's ds_top renders both replicas."""
    import re
    import subprocess
    import urllib.request

    telem = router._telem
    port = telem.start_http(0)
    url = f"http://127.0.0.1:{port}"
    try:
        body, count, peers = "", None, None

        def scraped():
            nonlocal body, count, peers
            body = urllib.request.urlopen(f"{url}/metrics?aggregate=1",
                                          timeout=10).read().decode()
            m = re.search(r"^serving_ttft_s_count(?:\{\})? (\S+)$", body,
                          re.M)
            p = re.search(r"^telemetry_aggregated_peers(?:\{\})? (\S+)$",
                          body, re.M)
            count = float(m.group(1)) if m else None
            peers = float(p.group(1)) if p else None
            return count == served and peers == 2

        fleet_until(router, scraped, 60.0,
                    f"{tag} aggregate scrape (serving_ttft_s {count}, "
                    f"peers {peers}, want {served} over 2)")
        out = subprocess.run(
            [sys.executable, "-m", "deepspeed_tpu_torch.telemetry.console",
             "--once", "--url", url], capture_output=True, text=True,
            timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
    finally:
        telem.stop_http()
    rows = re.findall(r"^ ([01])\s+ready\s+mixed", out.stdout, re.M)
    if out.returncode != 0 or sorted(rows) != ["0", "1"]:
        raise AssertionError(f"[fleet {tag}] ds_top exit {out.returncode}, "
                             f"rows {rows}:\n{out.stdout}\n{out.stderr}")
    log(f"[fleet {tag}] /metrics?aggregate=1: serving_ttft_s count "
        f"{count:.0f} = the {served} requests served, 2 replica peers; "
        f"ds_top --once rendered both replicas")
    return {"serving_ttft_s_count": count, "peers": peers,
            "ds_top_lines": len(out.stdout.splitlines())}


def fleet_timelines(router, tag: str, tids, orphans) -> dict:
    """(c): fleettrace assembles every request's timeline across the
    router and a replica; an orphan's holds its retry and both
    placements."""
    n_events = 0
    for tid in tids:
        tl = router._ftrace.assemble(tid)
        srcs = {e["src"] for e in (tl or {}).get("events", ())}
        kinds = [e["kind"] for e in (tl or {}).get("events", ())
                 if e["src"] == "router"]
        if "router" not in srcs or not any(s.startswith("replica")
                                           for s in srcs):
            raise AssertionError(f"[fleet {tag}] {tid}: timeline sources "
                                 f"{sorted(srcs)}")
        if tid in orphans and ("retry" not in kinds
                               or kinds.count("placed") < 2):
            raise AssertionError(f"[fleet {tag}] {tid}: the replay is not "
                                 f"in its timeline: {kinds}")
        n_events += len(tl["events"])
    log(f"[fleet {tag}] fleettrace: {len(tids)} timelines, router to "
        f"replica ({n_events} events), the {len(orphans)} replays in theirs")
    return {"timelines": len(tids), "events": n_events}


def fleet_oracle(dev, runs: dict, prompts: dict) -> dict:
    """Teacher forcing: the dense model (``attn_impl="xla"``, the replicas'
    seed) runs over each prompt plus the fleet's tokens; every token must
    be the oracle's argmax there, or sit within FLEET_TIE_GAP of its top
    logit (a near-tie, counted). Held for each final stream and each
    client-visible committed stream (a wrong splice shows as a token off
    the top past it); a committed stream the router counted as a replay
    mismatch is reported, its final stream held."""
    from deepspeed_tpu_torch.models import build_model

    oracle = build_model(FLEET["name"], dtype=torch.bfloat16, device=dev,
                         seed=FLEET["seed"], attn_impl="xla",
                         **FLEET["overrides"])
    out: dict = {}

    def check(tag, tid, prompt, toks) -> list:
        ids = torch.tensor([list(prompt) + list(toks[:-1])], device=dev)
        with torch.no_grad():
            logits = oracle(ids)[0, len(prompt) - 1:].float()
        top = logits.max(dim=-1).values
        got = logits[torch.arange(len(toks), device=dev),
                     torch.tensor(toks, device=dev)]
        gaps = (top - got).cpu().tolist()
        ties = [(k, g) for k, g in enumerate(gaps) if g > 0]
        bad = [(k, g) for k, g in ties if g > FLEET_TIE_GAP]
        if bad:
            raise AssertionError(f"[fleet {tag}] {tid}: tokens off the "
                                 f"oracle's top past the near-tie bound: "
                                 f"{bad[:4]}")
        return ties

    for tag, run in runs.items():
        ties, worst, forked = 0, 0.0, []
        for tid, info in run["results"].items():
            prompt = prompts[tag][tid]
            t = check(tag, tid, prompt, info["tokens"])
            ties += len(t)
            worst = max([worst] + [g for _, g in t])
            com = run["committed"][tid]
            if com and com != info["tokens"][:len(com)]:
                forked.append(tid)
                try:
                    check(tag, tid, prompt, com)
                except AssertionError as e:
                    log(f"[fleet {tag}] {tid}: committed stream (a counted "
                        f"replay mismatch) off the oracle: {e}")
            elif com:
                check(tag, tid, prompt, com)
        if len(forked) > run["replay_mismatches"]:
            raise AssertionError(f"[fleet {tag}] committed streams {forked} "
                                 f"part from their results, "
                                 f"{run['replay_mismatches']} mismatches "
                                 f"counted")
        out[tag] = {"near_ties": ties, "max_tie_gap": worst,
                    "forked": forked}
        log(f"[fleet {tag}] {len(run['results'])} streams pass the "
            f"teacher-forced oracle: {ties} near-ties of "
            f"{len(run['results']) * FLEET['new']} tokens (largest gap "
            f"{worst:.3f} <= {FLEET_TIE_GAP}); forked committed streams "
            f"{forked}")
    del oracle
    free_cuda()
    return out


def fleet_mixed(card: str, prompts: list, again: list,
                warm: list) -> dict:
    """(a) failover on two mixed replicas (the traffic ``prompts``, then
    ``again``: the same prefix, fresh suffixes) and (c) the fleet's
    telemetry on the same router."""
    from deepspeed_tpu_torch.serving.fleet import READY

    tag = "a"
    router = fleet_router(
        tag, ["mixed", "mixed"], telemetry=True,
        snapshot_dir=os.path.join(FLEET_DIR, "snap"), fleet_trace=True,
        fleet_trace_dir=os.path.join(FLEET_DIR, "blackbox"),
        watchtower=True, watchtower_dir=os.path.join(FLEET_DIR, "watch"))
    rec: dict = {}
    try:
        rec["ready_s"] = fleet_start(router, tag)
        # one request pinned to each replica first: its decode graphs
        # are captured before the timed runs
        for slot, p in enumerate(warm):
            router.submit(p, max_new_tokens=FLEET["new"],
                          trace_id=f"warm{slot}", pin_slot=slot)
        router.run(deadline_s=600.0)
        fleet_wait_digests(router)
        nofault = fleet_serve(router, prompts, "a-nofault")
        hit = router._telem.snapshot()[
            "serving_router_placement_prefix_tokens_total"]["series"][0][
            "value"]
        if hit <= 0:
            raise AssertionError(f"[fleet a] prefix placement hit {hit} "
                                 f"tokens")
        critical = [a.rule for a in router._alerts.firing("critical")]
        if critical or router._watch.stats().get("series", 0) <= 0:
            raise AssertionError(f"[fleet a] watchtower: critical alerts "
                                 f"{critical}, store {router._watch.stats()}")
        rec["scrape"] = fleet_scrape(router, tag, len(warm) + len(prompts))
        fault = fleet_serve(router, again, "a-kill", kill=True)
        k = fault["kill"]
        log(f"[fleet a-kill] slot {k['slot']} killed with "
            f"{len(k['orphans'])} "
            f"requests on it: replay admitted on the survivor "
            f"{max(k['replay_admit_s'].values()):.3f} s after the kill "
            f"(max), the replays' TTFT "
            + ", ".join(f"{v:.3f}" for v in k["replay_ttft_s"].values())
            + f" s; respawned to READY in {k['respawn_ready_s']:.1f} s")
        rec["trace"] = fleet_timelines(
            router, tag, list(nofault["results"]) + list(fault["results"]),
            set(k["orphans"]))
        rec["hit_tokens"] = hit
        rec["watch"] = router._watch.stats()
        rec["alerts_fired"] = [a.rule for a in router._alerts.firing()]
        if any(h.state != READY for h in router.fleet.replicas):
            raise AssertionError("[fleet a] the killed slot did not come "
                                 "back")
    finally:
        reports = fleet_shutdown(router, tag)
    rec.update(nofault=nofault, kill=fault, reports=reports,
               launches=check_fleet_launches(tag, reports))
    want = sorted(f"{s}.e{1 if s == k['slot'] else 0}" for s in (0, 1))
    if sorted(reports) != want:
        raise AssertionError(f"[fleet a] reports {sorted(reports)}, want "
                             f"{want}: the respawned slot and the survivor")
    log(f"[fleet a] {card}: no fault {nofault['tok_s']:.1f} tok/s, p50 TTFT "
        f"{nofault['ttft_p50_s']:.3f} s; prefix-hit tokens {hit:.0f}")
    return rec


def fleet_disagg(card: str, prompts: list, warm: list) -> dict:
    """(b) one prefill and one decode replica."""
    shm_free = shutil.disk_usage("/dev/shm").free
    ring = int(min(FLEET_SHM_MAX, shm_free * FLEET_SHM_SHARE))
    ring = ring if ring >= 64 << 20 else 0
    log(f"[fleet b] /dev/shm free {shm_free / 1e9:.2f} GB: the prefill "
        f"replica's ring {ring / 1e9:.2f} GB"
        + ("" if ring else " (none: every chunk rides the relay)"))
    tag = "b"
    router = fleet_router(tag, ["prefill", "decode"], telemetry=True,
                          per_slot={"0": {"shm_bytes": ring}})
    rec: dict = {"shm_free_bytes": shm_free, "ring_bytes": ring}
    try:
        rec["ready_s"] = fleet_start(router, tag)
        warm_run = fleet_serve(router, warm[:1], "bwarm", warm=True)
        run = fleet_serve(router, prompts, "b-disagg")
    finally:
        reports = fleet_shutdown(router, tag)
    served = 1 + len(prompts)
    for tid, info in run["results"].items():
        if not info["migrated"] or info["placed"][0] != 0:
            raise AssertionError(f"[fleet b] {tid}: placed {info['placed']}, "
                                 f"migrated {info['migrated']}")
    pre, dec = reports.get("0.e0"), reports.get("1.e0")
    if pre is None or dec is None or pre["migrations_out"] != served \
            or dec["migrations_in"] != served:
        raise AssertionError(f"[fleet b] migrations out / in "
                             f"{pre and pre['migrations_out']} / "
                             f"{dec and dec['migrations_in']}, want {served}")
    hand = run.get("handoffs", [])
    if len(hand) != len(prompts):
        raise AssertionError(f"[fleet b] {len(hand)} handoffs watched")
    ms = sorted(h["ms"] for h in hand)
    gb = sum(h["bytes"] for h in hand) / 1e9
    chunks = {"shm": 0, "relay": 0}
    for h in hand:
        chunks[h["transport"]] += h["chunks"]
    rate = gb / (sum(ms) / 1e3)
    log(f"[fleet b] {card}: {len(hand)} handoffs (+ the warm one), "
        f"{gb:.3f} GB handed off, handoff ms p50 {ms[len(ms) // 2]:.1f} / "
        f"max {ms[-1]:.1f}, {rate:.2f} GB/s over the handoffs' time; chunks "
        f"by transport {chunks} (every chunk's crc verified at import: "
        f"{served} imports committed); TTFT p50 {run['ttft_p50_s']:.3f} s, "
        f"{run['tok_s']:.1f} tok/s")
    rec.update(run=run, warm=warm_run, reports=reports, gb=gb,
               handoff_ms_p50=ms[len(ms) // 2], handoff_ms_max=ms[-1],
               GBps=rate, chunks=chunks,
               launches=check_fleet_launches(tag, reports))
    return rec


def phase_fleet(dev) -> dict:
    """See the module docstring, phase 14."""
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.accelerator import card_name_and_power_limit
    from deepspeed_tpu_torch.models import get_model_config
    from deepspeed_tpu_torch.ops import native

    t_phase = time.perf_counter()
    card = card_name_and_power_limit()
    native.load_library()        # built once here: replicas never race g++
    free_cuda()
    reset_counts()
    telem = telemetry.get_telemetry()
    telem.reset_metrics()
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    os.makedirs(FLEET_DIR)
    vocab = get_model_config(FLEET["name"], **FLEET["overrides"]).vocab_size
    prompts = kv_prompts(vocab, 21)
    again = kv_prompts(vocab, 23)
    warm = kv_prompts(vocab, 22)[:2]
    try:
        mixed = fleet_mixed(card, prompts, again, warm)
        disagg = fleet_disagg(card, prompts, warm)
    finally:
        telem.reconfigure(enabled=False)
        telem.reset_metrics()
        shutil.rmtree(FLEET_DIR, ignore_errors=True)
    parent = all_counts()
    if any(parent.values()):
        raise AssertionError(f"[fleet] the router's process launched "
                             f"kernels: {parent}")
    runs = {"a-nofault": mixed["nofault"], "a-kill": mixed["kill"],
            "b-disagg": disagg["run"]}
    by_tid = {tag: {f"{tag}{i}": p for i, p in enumerate(
        again if tag == "a-kill" else prompts)} for tag in runs}
    oracle = fleet_oracle(dev, runs, by_tid)
    launches = {k: mixed["launches"][k] + disagg["launches"][k]
                for k in mixed["launches"]}
    rec = {"card": card, "mixed": mixed, "disagg": disagg, "oracle": oracle,
           "launches": launches, "seconds": time.perf_counter() - t_phase}
    log(f"[fleet] {card}: phase {rec['seconds']:.1f} s; K1 in the replicas "
        f"{launches}; no fault {mixed['nofault']['tok_s']:.1f} tok/s, p50 "
        f"TTFT {mixed['nofault']['ttft_p50_s']:.3f} s; disaggregated "
        f"{disagg['run']['tok_s']:.1f} tok/s, p50 TTFT "
        f"{disagg['run']['ttft_p50_s']:.3f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 15: tensor-parallel serving, ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

#: every leg's engine: the serve phase's, committing within each step
TP_ENGINE = dict(block_size=64, num_blocks=256, max_seqs=8, chunk=256,
                 max_seq_len=2048, decode_window=8, max_inflight=0)
TP_SEED = 11
#: (tag, tensor ranks, model, its config overrides (depth), dtype, {run:
#: options}, traffic: prompt lengths, system prefix, new tokens; engine
#: overrides)
TP_LEGS = (
    ("llama2-7b/bf16", 2, "llama2-7b", {}, "bfloat16",
     {"off": {"tp_overlap": False}, "auto": {}},
     (TRAFFIC["shared-prefix"][0], 128, 64), {}),
    ("llama2-7b/int8+e4m3", 2, "llama2-7b", {}, "bfloat16",
     {"auto": {"quant_bits": 8, "kv_cache_dtype": "fp8"}},
     (TRAFFIC["shared-prefix"][0], 128, 32), {}),
    ("qwen2-moe-a2.7b/int8", 2, "qwen2-moe-a2.7b", {"num_layers": 4},
     "bfloat16",
     {"auto": {"quant_bits": 8}}, (TRAFFIC["shared-prefix"][0], 128, 32),
     {}),
    ("mistral-7b/fp32-ring", 4, "mistral-7b", {"num_layers": 8}, "float32",
     {"forced": {"tp_overlap": True}}, ((4608, 256, 384, 512), 0, 16),
     {"max_seq_len": 8192, "num_blocks": 600}),
)


class CollectiveTimer:
    """Host seconds and calls inside the port's collectives in this process
    (``comm.all_reduce``, ``comm.all_gather``, ``comm.ring_shift`` and the
    waits of its pending exchanges), host staging included."""

    def __init__(self):
        from deepspeed_tpu_torch import comm

        self.reset()

        def wrap(fn):
            def timed(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    self.seconds += time.perf_counter() - t0
                    self.calls += 1
            return timed

        for name in ("all_reduce", "all_gather", "ring_shift"):
            setattr(comm, name, wrap(getattr(comm, name)))
        comm.PendingExchange.wait = wrap(comm.PendingExchange.wait)

    def reset(self) -> None:
        self.seconds, self.calls = 0.0, 0


def tp_prompts(vocab: int, lens, sys_len: int, seed: int) -> tuple:
    """(a warm-up prompt that publishes the system prefix, the prompts)."""
    g = torch.Generator().manual_seed(seed)
    system = torch.randint(0, vocab, (sys_len,), generator=g).tolist()
    warm = system + torch.randint(0, vocab, (64,), generator=g).tolist()
    return warm, [system + torch.randint(0, vocab, (n - sys_len,),
                                         generator=g).tolist()
                  for n in lens]


def tp_rank_leg(leg: tuple, warm: list, prompts: list,
                device: str = "cuda") -> dict:
    """One rank of a tp leg (runs in a ``RankPool`` process) on ``device``:
    for each run, the engine from a meta model, a warm-up request, then the
    prompts served greedily; returns each run's streams, times, ring
    counters and launches."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.parallel.tensor import overlap_counters
    from deepspeed_tpu_torch.parallel.topology import MeshTopology

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag, tp, name, mover, dtype, runs, (lens, sys_len, new), over = leg
    cuda = device == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device(device)
    if cuda:
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if cuda else (lambda *a: None)
    dtype = getattr(torch, dtype)
    timer = CollectiveTimer()
    topo = MeshTopology({"tensor": tp})
    extra = dict(mover)
    out = {"rank": topo.rank_in("tensor"), "runs": {}}
    for run, opts in runs.items():
        t0 = time.perf_counter()
        model = build_model(name, device="meta", dtype=dtype, seed=TP_SEED,
                            **extra)
        eng = InferenceEngineV2(model, config=dict(
            TP_ENGINE, **over, dtype=dtype, device=dev, **opts),
            topology=topo)
        sync()
        build_s = time.perf_counter() - t0
        eng.generate([warm], max_new_tokens=8)
        reset_counts()
        zero_stats(eng)
        timer.reset()
        staged0 = {k: list(v) for k, v in comm.staged.items()}
        products0 = overlap_counters.products_snapshot()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for uid, p in enumerate(prompts):
            eng.put(uid, p, max_new_tokens=new)
        first: dict = {}
        while any(eng.query(u).get("live") and not eng.query(u)["done"]
                  for u in range(len(prompts))) or eng._inflight:
            for uid in eng.step():
                first.setdefault(uid, time.perf_counter() - t0)
        sync()
        wall = time.perf_counter() - t0
        streams = [eng.flush(u) for u in range(len(prompts))]
        st = eng.stats
        made = {k: [m - products0.get(k, (0, 0))[0],
                    b - products0.get(k, (0, 0))[1]]
                for k, (m, b) in overlap_counters.products_snapshot().items()}
        out["runs"][run] = dict(
            streams=streams, build_s=build_s, wall_s=wall,
            tok_s=sum(map(len, streams)) / wall,
            ttft_p50_s=statistics.median(first.values()),
            decode_ms_per_token_step=1e3 * st["window_dispatch_s"] / max(
                st["window_iters_dispatched"], 1),
            collective_s=timer.seconds, collective_calls=timer.calls,
            staged={k: [v[0] - staged0.get(k, [0, 0])[0],
                        v[1] - staged0.get(k, [0, 0])[1]]
                    for k, v in comm.staged.items()},
            ring={k: st[k] for k in ("tp_ring_matmuls", "tp_ring_steps",
                                     "tp_bytes_permuted", "tp_fallbacks")},
            ring_products=made,
            launches=all_counts(), forwards=forwards_of(eng),
            graphs_off_reason=eng.graphs_off_reason,
            peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda else 0)
        del eng, model
        free_cuda()
    return out


def load_shard_dequantized(model, bits, tp: int) -> None:
    """Overwrite ``model``'s quantized weights (attention and dense FFN
    products, routed experts, the unembedding) with their codes quantized
    shard by shard at ``tp`` ranks, as the engine quantizes them, and
    dequantized: the dense oracle of a quantized TP engine."""
    from deepspeed_tpu_torch.inference.weights import module_param_tree
    from deepspeed_tpu_torch.ops.quant_matmul import (
        dequantize_grouped, dequantize_weight, quantize_grouped,
        quantize_weight)
    from deepspeed_tpu_torch.runtime.zero.planner import (tensor_plan,
                                                          tensor_shard)

    tree = module_param_tree(model)
    products = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    with torch.no_grad():
        for path, (spec, _) in tensor_plan(tree, {"tensor": tp}).items():
            leaf = path[-1]
            if not ((leaf in products and ("attn" in path or "ffn" in path
                                           or "experts" in path))
                    or path == ("unembed",)):
                continue
            w = tree
            for k in path:
                w = w[k]
            parts = []
            for r in range(tp):
                sh = tensor_shard(w, spec, r, tp).float()
                if "experts" in path:
                    parts.append(dequantize_grouped(quantize_grouped(
                        sh, bits=bits, shard=tp > 1)))
                    continue
                K = sh.shape[0] * sh.shape[1] if leaf == "wo" else \
                    sh.shape[0]
                parts.append(dequantize_weight(quantize_weight(
                    sh.reshape(K, -1), bits=bits, shard=tp > 1)
                ).reshape(sh.shape))
            whole = torch.cat(parts, dim=spec.index("tensor")) \
                if "tensor" in spec else parts[0]
            w.copy_(whole.to(w.dtype))


def teacher_forced(oracle, prompt, toks, dev) -> list:
    """Per token of ``toks`` after ``prompt``: the oracle's top logit there
    minus the token's."""
    ids = torch.tensor([list(prompt) + list(toks[:-1])], device=dev)
    with torch.no_grad():
        logits = oracle(ids)[0, len(prompt) - 1:].float()
    got = logits[torch.arange(len(toks), device=dev),
                 torch.tensor(toks, device=dev)]
    return (logits.max(dim=-1).values - got).cpu().tolist()


def tp_oracle(tag, oracle, prompts, runs: dict, dev) -> dict:
    """Every token of every run's streams the teacher-forced oracle's argmax
    or within ``FLEET_TIE_GAP`` of its top logit (a near-tie, counted)."""
    out = {}
    for run, rec in runs.items():
        ties, worst = 0, 0.0
        for uid, (p, toks) in enumerate(zip(prompts, rec["streams"])):
            gaps = teacher_forced(oracle, p, toks, dev)
            bad = [(k, g) for k, g in enumerate(gaps) if g > FLEET_TIE_GAP]
            if bad:
                raise AssertionError(f"[tp {tag} {run}] uid {uid}: tokens "
                                     f"off the oracle's top past the "
                                     f"near-tie bound: {bad[:4]}")
            ties += sum(g > 0 for g in gaps)
            worst = max([worst] + gaps)
        out[run] = dict(near_ties=ties, max_tie_gap=worst)
        log(f"[tp {tag} {run}] {len(prompts)} streams pass the "
            f"teacher-forced oracle: {ties} near-ties (largest gap "
            f"{worst:.3f} <= {FLEET_TIE_GAP})")
    return out


def tp_tp1_streams(leg, prompts, warm, dev) -> tuple:
    """The TP-1 engine's streams and per-token logits on a leg's weights
    and traffic (the mistral leg's reference)."""
    from deepspeed_tpu_torch.models import build_model

    tag, tp, name, mover, dtype, runs, (lens, sys_len, new), over = leg
    dtype = getattr(torch, dtype)
    extra = dict(mover)
    model = build_model(name, device=dev, dtype=dtype, seed=TP_SEED, **extra)
    eng = tap_engine_class()(model, config=dict(TP_ENGINE, **over,
                                                dtype=dtype, device=dev))
    del model
    eng.generate([warm], max_new_tokens=8)
    eng.taps.clear()
    streams = eng.generate(prompts, max_new_tokens=new)
    taps = [[t.cpu() for t in eng.taps[u]] for u in range(len(prompts))]
    del eng
    free_cuda()
    return streams, taps


def tp_check_ranks(leg, recs: list) -> dict:
    """Every rank's streams, ring counters, ring products and launches equal
    rank 0's; each rank's launches equal the TP-1 engine's on the same
    forwards plus, where a ring ran, the local products it made beyond the
    blocking path's (an all-gather ring makes n products a weight, a
    two-way reduce-scatter ring 2n half products, the grouped ring n; the
    ring cores count them as they make them). Returns the per-run launches
    of every rank and the TP-1 figures."""
    from deepspeed_tpu_torch.models import get_model_config

    tag, tp, name, mover, dtype, runs, (lens, sys_len, new), over = leg
    extra = dict(mover)
    cfg = get_model_config(name, **extra)
    bf16 = dtype == "bfloat16"
    out = {}
    for run, opts in runs.items():
        r0 = recs[0]["runs"][run]
        for rec in recs[1:]:
            r = rec["runs"][run]
            if any(r[k] != r0[k] for k in ("streams", "ring", "ring_products",
                                           "forwards", "launches")):
                raise AssertionError(
                    f"[tp {tag} {run}] rank {rec['rank']} disagrees with "
                    f"rank 0: launches {r['launches']} vs {r0['launches']}, "
                    f"ring products {r['ring_products']} vs "
                    f"{r0['ring_products']}")
        if any(len(s) != new for s in r0["streams"]):
            raise AssertionError(f"[tp {tag} {run}] streams of "
                                 f"{[len(s) for s in r0['streams']]} tokens")
        quant = "quant_bits" in opts
        tp1 = want_launches(cfg, forwards=r0["forwards"],
                            e4m3_pool=opts.get("kv_cache_dtype") == "fp8",
                            quant=quant, ring=cfg.sliding_window is not None
                            and over.get("max_seq_len", 0) > cfg.sliding_window,
                            bf16=bf16)
        routed = tp1.pop("k1_routed")
        want = dict(tp1)
        for k, (made, blocking) in r0["ring_products"].items():
            want[k] += made - blocking
            if bf16:
                want[k + "_tc"] += made - blocking
        for rec in recs:
            got = dict(rec["runs"][run]["launches"])
            g_routed = got.pop("k1_chunk") + got.pop("k1_split")
            if got != want or g_routed != routed:
                raise AssertionError(
                    f"[tp {tag} {run}] rank {rec['rank']} launches {got} "
                    f"!= {want}: the TP-1 engine's {tp1} ({cfg.num_layers} "
                    f"layers x {r0['forwards']} forwards) plus the ring "
                    f"products {r0['ring_products']}; K1 chunk + split "
                    f"{g_routed} vs {routed}")
        out[run] = dict(per_rank={k: v for k, v in r0["launches"].items()
                                  if v}, tp1=dict(
                                      {k: v for k, v in tp1.items() if v},
                                      k1_routed=routed),
                        ring_products=r0["ring_products"],
                        by_rank={rec["rank"]: rec["runs"][run]["launches"]
                                 for rec in recs},
                        times={rec["rank"]: {k: rec["runs"][run][k] for k in (
                            "tok_s", "ttft_p50_s", "decode_ms_per_token_step",
                            "collective_s", "collective_calls")}
                               for rec in recs})
        r = r0
        per_rank = "; ".join(
            f"rank {k}: {t['tok_s']:.1f} tok/s, p50 TTFT "
            f"{t['ttft_p50_s']:.3f} s, decode "
            f"{t['decode_ms_per_token_step']:.2f} ms/token-step, "
            f"collectives {t['collective_s']:.2f} s in "
            f"{t['collective_calls']} calls"
            for k, t in out[run]["times"].items())
        log(f"[tp {tag} {run}] TP {tp} (ranks agree; eager): {per_rank}; "
            f"ring {r['ring']}, host-staged "
            f"{r['staged']}; launches a rank {out[run]['per_rank']}, equal "
            f"on all {tp} ranks (TP-1 engine on the same forwards: "
            f"{out[run]['tp1']}; ring products made / blocking "
            f"{out[run]['ring_products']}); build "
            f"{r['build_s']:.1f} s, peak {r['peak_bytes'] / 1e9:.1f} GB")
    return out


def phase_tp(dev) -> dict:
    """See the module docstring, phase 15."""
    from deepspeed_tpu_torch.accelerator import card_name_and_power_limit
    from deepspeed_tpu_torch.models import build_model, get_model_config
    from deepspeed_tpu_torch.ops import native

    t_phase = time.perf_counter()
    card = card_name_and_power_limit()
    native.load_library()        # built once here: ranks never race g++
    free_cuda()
    reset_counts()
    legs: dict = {}
    traffic: dict = {}
    for leg in TP_LEGS:
        tag, tp, name, mover, dtype, runs, (lens, sys_len, new), _ = leg
        traffic[tag] = tp_prompts(
            get_model_config(name, **mover).vocab_size, lens, sys_len, 31)
    for n in sorted({leg[1] for leg in TP_LEGS}):
        pool = rank_pool(n)
        for leg in (lg for lg in TP_LEGS if lg[1] == n):
            t0 = time.perf_counter()
            recs = pool.run(tp_rank_leg, leg, *traffic[leg[0]], dev.type,
                            timeout=900)
            legs[leg[0]] = dict(
                seconds=time.perf_counter() - t0,
                runs={run: {k: v for k, v in r.items() if k != "streams"}
                      for run, r in recs[0]["runs"].items()},
                streams={run: r["streams"]
                         for run, r in recs[0]["runs"].items()},
                launches=tp_check_ranks(leg, recs))
        if n != 2:
            close_pools([n])          # the seq phase shares the 2 ranks'
    parent = all_counts()
    if any(parent.values()):
        raise AssertionError(f"[tp] this process launched kernels: {parent}")
    # the oracles, with the ranks gone
    oracles = {}
    for leg in TP_LEGS:
        tag, tp, name, mover, dtype, runs, (lens, sys_len, new), _ = leg
        warm, prompts = traffic[tag]
        runs_got = {run: {"streams": s}
                    for run, s in legs[tag]["streams"].items()}
        if dtype == "float32":
            want, taps = tp_tp1_streams(leg, prompts, warm, dev)
            ties = []
            for uid, (a, b) in enumerate(zip(runs_got["forced"]["streams"],
                                             want)):
                k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         None)
                if k is None:
                    continue
                top2 = torch.topk(taps[uid][k], 2).values
                gap = (top2[0] - top2[1]).item()
                if gap >= 1e-4:
                    raise AssertionError(f"[tp {tag}] uid {uid} parts from "
                                         f"the TP-1 engine at token {k} "
                                         f"(top-2 gap {gap:.3e} >= 1e-4)")
                ties.append((uid, k, gap))
            oracles[tag] = dict(against="TP-1 engine", near_ties=ties)
            log(f"[tp {tag}] streams equal the TP-1 engine's"
                + (f" but at near-ties {ties}" if ties else ""))
            continue
        extra = dict(mover)
        oracle = build_model(name, dtype=torch.bfloat16, device=dev,
                             seed=TP_SEED, attn_impl="xla", **extra)
        quant = next(iter(runs.values())).get("quant_bits")
        if quant:
            load_shard_dequantized(oracle, quant, tp)
        if oracle.config.moe is not None:
            no_drop_oracle(oracle)
        oracles[tag] = tp_oracle(tag, oracle, prompts, runs_got, dev)
        del oracle
        free_cuda()
    rec = {"card": card, "legs": legs, "oracles": oracles,
           "seconds": time.perf_counter() - t_phase}
    log(f"[tp] {card}: phase {rec['seconds']:.1f} s (ranks time-slicing one "
        f"card over gloo: no measure of tensor parallelism's speed)")
    return rec


def tp_launches(rec: dict) -> dict:
    """Each kernel's launches summed over every rank of every tp run, as
    each rank counted them."""
    total: dict = collections.Counter()
    for leg in TP_LEGS:
        for run in leg[5]:
            for got in rec["legs"][leg[0]]["launches"][run]["by_rank"] \
                    .values():
                total.update(got)
    return {k: v for k, v in total.items() if v}


# ---------------------------------------------------------------------------
# phase 16: sequence-parallel training, ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

SEQ_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "seq.tmp")
#: llama2-7b's width, micro-batch 1 x 4096 tokens (2048 a rank at seq 2),
#: remat "full", ZeRO stage 0, AdamW at eps 1e-5 (see phase_train_parity)
SEQ = dict(name="llama2-7b", micro=1, gas=1, seq=4096, steps=3, seed=17)
#: (leg, layers, dtype): fp32 held by losses and parameters, bf16 with an
#: fp32 master by losses
SEQ_LEGS = (("fp32", 2, "float32"), ("bf16", 4, "bfloat16"))
#: seq 2 against seq 1, the losses' relative difference: fp32 (the products
#: split over 2048 rows sum in another order) and bf16 (products over 2048
#: rows may round a bf16 ulp apart from those over 4096)
SEQ_LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-3}


def seq_rank_leg(leg: tuple, sp: int, device: str = "cuda",
                 axis: str = "seq", overlap: bool = False) -> dict:
    """One rank of a seq or tensor leg (runs in a ``RankPool`` process;
    a size-1 reference in this one): the model from the seed,
    ``initialize`` at ``{axis: sp}`` on ``device``, the steps on one
    batch. At ``tensor`` > 1 the model is
    given on the meta device, so the engine draws its seeded weights a
    block at a time and keeps this rank's slices; ``overlap`` turns
    ``tensor_parallel.overlap`` on. At size 1 (the reference) an fp32 leg
    saves its master under ``SEQ_DIR``; at size 2 an fp32 leg holds its
    master (a tensor rank's slices against the reference's) against it
    here, a parameter at a time. Returns losses, step times, launches, the
    parameter comparison, a digest of the replicated parameters and the
    ring counters."""
    import hashlib

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.parallel.tensor import overlap_counters
    from deepspeed_tpu_torch.runtime.zero.planner import tensor_shard

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag, layers, dtype_name = leg
    dtype = getattr(torch, dtype_name)
    cuda = device == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device(device)
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    sync = torch.cuda.synchronize if cuda else (lambda *a: None)
    spec = SEQ
    tensor = axis == "tensor" and sp > 1
    model = build_model(spec["name"], num_layers=layers, dtype=dtype,
                        param_dtype=torch.float32,
                        device="meta" if tensor else dev, seed=spec["seed"])
    engine, *_ = dst.initialize(model=model, device=dev, config=train_config(
        spec, activation_checkpointing={"policy": "full"},
        mesh={axis: sp}, bf16={"enabled": dtype == torch.bfloat16},
        tensor_parallel={"overlap": overlap},
        optimizer={"type": "AdamW", "params": {"lr": 1e-4, "eps": 1e-5,
                                               "weight_decay": 0.01}}))
    batch = train_batch_of(spec, model.config.vocab_size, spec["seed"])
    staged0 = {k: list(v) for k, v in comm.staged.items()}
    # host seconds a step inside Ulysses' all-to-alls (forward, remat and
    # backward), in the gradient reduction (the all-reduce over seq) and
    # inside the tensor all-reduces of the Megatron layers (a blocking
    # gloo call waits for the device work before it)
    spent = {"all_to_all": 0.0, "grad_reduce": 0.0, "tensor": 0.0}

    def timed(key, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                sync()
                spent[key] += time.perf_counter() - t
        return call

    a2a = comm.comm._all_to_all
    comm.comm._all_to_all = timed("all_to_all", a2a)
    engine._finish_grads = timed("grad_reduce", engine._finish_grads)
    reset_counts()
    overlap_counters.reset()
    tensor0 = dict(comm.tensor_allreduce)
    losses, step_s, split = [], [], []
    try:
        for _ in range(spec["steps"]):
            sync()
            spent.update(all_to_all=0.0, grad_reduce=0.0)
            t_ar = comm.tensor_allreduce["seconds"]
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            step_s.append(time.perf_counter() - t0)
            spent["tensor"] = comm.tensor_allreduce["seconds"] - t_ar
            split.append(dict(spent))
    finally:
        comm.comm._all_to_all = a2a
    launches = all_counts()
    # the replicated parameters' digest, which tensor_check compares across
    # the tensor ranks (elsewhere every parameter is replicated: seconds of
    # hashing that nothing reads)
    rep_bytes = hashlib.sha256()
    for i, (n, p) in enumerate(zip(engine._names, engine._params)):
        if tensor and "tensor" not in (engine._tp_specs[i] or ()):
            for t in (p, engine._master[i]):
                rep_bytes.update(t.detach().contiguous().view(torch.uint8)
                                 .cpu().numpy().tobytes())
    out = dict(rank=engine.tp_rank if tensor else engine.sp_rank,
               losses=losses, step_s=step_s,
               ring=overlap_counters.snapshot(),
               replicated_sha256=rep_bytes.hexdigest() if tensor else None,
               tensor_allreduce={k: comm.tensor_allreduce[k] - tensor0[k]
                                 for k in tensor0},
               split_s=split, launches=launches,
               params=engine.num_parameters(),
               staged={k: [v[0] - staged0.get(k, [0, 0])[0],
                           v[1] - staged0.get(k, [0, 0])[1]]
                       for k, v in comm.staged.items()},
               peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda
               else 0)
    if dtype == torch.float32:
        path = os.path.join(SEQ_DIR, f"{tag}.master.pt")
        final = {n: p.detach() for n, p in zip(engine._names,
                                               engine._params)}
        if sp == 1:
            torch.save({n: p.cpu() for n, p in final.items()}, path)
            start = build_model(spec["name"], num_layers=layers,
                                dtype=dtype, device=dev, seed=spec["seed"])
            out["max_change"] = max(
                (final[n] - p.detach()).abs().max().item()
                for n, p in start.named_parameters())
            out["max_abs"] = max(p.abs().max().item()
                                 for p in final.values())
            del start
        else:
            ref = torch.load(path, mmap=True)
            specs = dict(zip(engine._names, engine._tp_specs))
            out["max_diff"] = max(
                (final[n] - tensor_shard(ref[n], specs[n] or (),
                                         engine.tp_rank, engine.tp_size)
                 .to(dev)).abs().max().item() for n in final)
            del ref
    engine.close()
    del engine, model
    free_cuda()
    return out


def seq_rank_attention(S: int, H: int, D: int, seed: int,
                       device: str = "cuda") -> dict:
    """One rank of the attention check at a leg's shape (bf16 [1, S, H, D]
    from one seed on both ranks, do too): ``ulysses_attention`` over the
    two ranks (K4 at [1, S, H/2, D] on each) against one rank's K4 over the
    whole sequence, and ``ring_attention`` against plain attention over
    the whole sequence in fp32: this rank's output rows and its q/k/v
    gradients' rows, errors over the reference's max |value|."""
    from deepspeed_tpu_torch.comm import set_topology
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.attention import plain_attention
    from deepspeed_tpu_torch.parallel import sequence as seqp
    from deepspeed_tpu_torch.parallel.topology import MeshTopology

    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    topo = MeshTopology({"seq": 2})
    set_topology(topo)
    r = topo.rank_in("seq")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((1, S, H, D), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    rows = slice(r * S // 2, (r + 1) * S // 2)

    def run(fn, inputs, grad_out):
        xs = [x.detach().clone().requires_grad_() for x in inputs]
        y = fn(*xs)
        y.backward(grad_out)
        return [y.detach()] + [x.grad for x in xs]

    def errors(got, want):
        return {name: ((a.float() - b.float()).abs().max()
                       / b.float().abs().max()).item()
                for name, a, b in zip(("out", "dq", "dk", "dv"), got, want)}

    mine = [x[:, rows] for x in (q, k, v)]
    before = fa.counts.fwd, fa.counts.bwd
    uly = run(lambda *a: seqp.ulysses_attention(*a), mine, do[:, rows])
    uly_launches = (fa.counts.fwd - before[0], fa.counts.bwd - before[1])
    full = run(lambda *a: fa.flash_attention(*a, causal=True), (q, k, v), do)
    res = dict(rank=r, ulysses_launches=uly_launches,
               ulysses=errors(uly, [t[:, rows] for t in full]))
    del uly, full
    ring = run(lambda *a: seqp.ring_attention(*a), mine, do[:, rows])
    ref = run(lambda *a: plain_attention(*a).to(torch.bfloat16),
              [x.float() for x in (q, k, v)], do)
    res["ring"] = errors(ring, [t[:, rows] for t in ref])
    del ring, ref
    free_cuda()
    return res


def seq_check(tag: str, ref: dict, recs: list, leg: tuple) -> dict:
    """The seq-2 ranks against each other and the seq-1 run: losses, the
    fp32 master, and each rank's K4 launches exactly layers x micro-batches
    x steps backward and twice that forward (remat runs each layer's
    forward again), no plain version and no other kernel."""
    _, layers, dtype_name = leg
    spec = SEQ
    n = spec["gas"] * spec["steps"]
    want = {k: 0 for k in ref["launches"]}
    want.update(k4_fwd=2 * layers * n, k4_bwd=layers * n)
    for rec in [ref] + recs:
        if rec["launches"] != want:
            raise AssertionError(f"[{tag}] rank {rec['rank']} launches "
                                 f"{rec['launches']} != {want}")
    if recs[0]["losses"] != recs[1]["losses"]:
        raise AssertionError(f"[{tag}] ranks' losses {recs[0]['losses']} "
                             f"vs {recs[1]['losses']}")
    losses = recs[0]["losses"]
    if not all(math.isfinite(x) for x in losses + ref["losses"]):
        raise AssertionError(f"[{tag}] losses {losses} / {ref['losses']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    out = dict(losses=losses, ref_losses=ref["losses"], max_rel_loss_diff=rel,
               loss_tol=SEQ_LOSS_TOL[dtype_name],
               launches_per_rank={k: v for k, v in want.items() if v})
    if rel > SEQ_LOSS_TOL[dtype_name]:
        raise AssertionError(f"[{tag}] losses {losses} against seq 1's "
                             f"{ref['losses']}: {rel:.2e} relative > "
                             f"{SEQ_LOSS_TOL[dtype_name]:.0e}")
    if dtype_name == "float32":
        diff = max(r["max_diff"] for r in recs)
        moved = ref["max_change"]
        out.update(max_param_diff=diff, max_abs_param=ref["max_abs"],
                   max_param_change=moved, param_diff_over_change=diff / moved)
        # the train parity phase's bounds
        if diff > 1e-4 * ref["max_abs"] or diff > 1e-2 * moved:
            raise AssertionError(f"[{tag}] parameters {diff:.2e} apart "
                                 f"(max |param| {ref['max_abs']:.3f}, largest "
                                 f"change {moved:.2e})")
    return out


def tensor_check(tag: str, ref: dict, recs: list, leg: tuple,
                 off: list | None = None) -> dict:
    """The tensor-2 ranks against the size-1 run as :func:`seq_check`
    holds the seq-2 ones, plus: the replicated parameters (compute and
    master) bit-identical on both ranks; ring counters exact. Without
    ``tensor_parallel.overlap`` no ring runs; with it (``off``: the
    overlap-off ranks, whose losses the overlap run's match within 1e-5
    relative) every ``wo`` and ``w_down`` forward rings (4096 rows divide
    2): 2 a layer a forward, remat's second forward included, no
    fallback. (Each ring's transposed ring in the backward is counted by
    no counter.)"""
    out = seq_check(tag, ref, recs, leg)
    digests = {r["replicated_sha256"] for r in recs}
    if len(digests) != 1:
        raise AssertionError(f"[{tag}] replicated parameters differ across "
                             f"the tensor ranks: {digests}")
    _, layers, _ = leg
    n = SEQ["gas"] * SEQ["steps"]
    want = {"tp_ring_matmuls": 2 * 2 * layers * n if off else 0,
            "tp_fallbacks": 0}
    for r in recs:
        got = {k: r["ring"][k] for k in want}
        if got != want:
            raise AssertionError(f"[{tag}] rank {r['rank']} ring counters "
                                 f"{r['ring']} != {want}")
    out["ring"] = recs[0]["ring"]
    if off:
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(recs[0]["losses"], off[0]["losses"]))
        out["max_rel_loss_diff_overlap_off"] = rel
        if rel > 1e-5:
            raise AssertionError(f"[{tag}] losses {recs[0]['losses']} "
                                 f"against overlap off "
                                 f"{off[0]['losses']}: {rel:.2e} > 1e-5")
    return out


def log_tensor_leg(tag: str, res: dict, recs: list, ref: dict) -> None:
    steps = "; ".join(
        f"rank {r['rank']}: {', '.join(f'{t:.2f}' for t in r['step_s'])} s"
        f" a step (host seconds inside the tensor all-reduces "
        f"{', '.join(f'{d['tensor']:.2f}' for d in r['split_s'])}; "
        f"{r['tensor_allreduce']['calls']} all-reduces, "
        f"{r['tensor_allreduce']['bytes'] / 1e9:.2f} GB in all), peak "
        f"{r['peak_bytes'] / 1e9:.1f} GB, staged {r['staged']}"
        for r in recs)
    log(f"[{tag}] {recs[0]['params'] / 1e9:.2f} B parameters, half a "
        f"rank: losses {', '.join(f'{x:.6f}' for x in res['losses'])} "
        f"against size 1's {', '.join(f'{x:.6f}' for x in ref['losses'])} "
        f"({res['max_rel_loss_diff']:.2e} relative, limit "
        f"{res['loss_tol']:.0e})"
        + (f"; parameters within {res['max_param_diff']:.2e} (max |param| "
           f"{res['max_abs_param']:.3f}, largest change "
           f"{res['max_param_change']:.2e})"
           if "max_param_diff" in res else "")
        + (f"; overlap off's losses within "
           f"{res['max_rel_loss_diff_overlap_off']:.2e}"
           if "max_rel_loss_diff_overlap_off" in res else "")
        + f"; replicated parameters bit-identical on both ranks; ring "
        f"counters {res['ring']}; K4 launches a rank "
        f"{res['launches_per_rank']}; {steps} (size 1: "
        f"{', '.join(f'{t:.2f}' for t in ref['step_s'])} s); ranks "
        f"time-slicing one card over gloo: no measure of tensor "
        f"parallelism's speed")


def phase_seq(dev) -> dict:
    """See the module docstring, phase 16."""
    from deepspeed_tpu_torch.accelerator import card_name_and_power_limit
    from deepspeed_tpu_torch.models import get_model_config

    t_phase = time.perf_counter()
    card = card_name_and_power_limit()
    free_cuda()
    shutil.rmtree(SEQ_DIR, ignore_errors=True)
    os.makedirs(SEQ_DIR)
    rec: dict = {"card": card, "legs": {}, "tensor": {}}
    try:
        # the size-1 references (seq 1 and tensor 1) in this process, then
        # every other run in the two ranks
        refs = {leg[0]: seq_rank_leg(leg, 1, dev.type) for leg in SEQ_LEGS}
        free_cuda()
        reset_counts()
        two = rank_pool(2)
        # (a) attention at the bf16 leg's shape
        cfg = get_model_config(SEQ["name"])
        att = two.run(seq_rank_attention, SEQ["seq"], cfg.num_heads,
                      cfg.head_dim, SEQ["seed"], dev.type, timeout=600)
        for a in att:
            if a["ulysses_launches"] != (1, 1):
                raise AssertionError(f"[seq attention] rank {a['rank']} "
                                     f"K4 launches {a['ulysses_launches']}")
            for what in ("ulysses", "ring"):
                bad = {k: v for k, v in a[what].items() if v > 2e-2}
                if bad:
                    raise AssertionError(
                        f"[seq attention] rank {a['rank']} {what}: "
                        f"{bad} over 2e-2 of max |reference|")
        rec["attention"] = att
        log(f"[seq attention] {card}: bf16 [1, {SEQ['seq']}, "
            f"{cfg.num_heads}, {cfg.head_dim}] over 2 ranks: Ulysses (K4 "
            f"at {cfg.num_heads // 2} heads a rank) against one K4 "
            f"over the whole sequence {[a['ulysses'] for a in att]}; "
            f"ring against fp32 plain attention "
            f"{[a['ring'] for a in att]} (errors over max |reference|, "
            f"limit 2e-2)")
        # (b) the legs at seq 2
        for leg in SEQ_LEGS:
            tag = f"seq {SEQ['name']} x{leg[1]} {leg[0]}"
            ref = refs[leg[0]]
            recs = two.run(seq_rank_leg, leg, 2, dev.type, timeout=600)
            res = seq_check(tag, ref, recs, leg)
            res.update(ranks=recs, ref=ref)
            rec["legs"][leg[0]] = res
            steps = "; ".join(
                f"rank {r['rank']}: {', '.join(f'{t:.2f}' for t in r['step_s'])} s"
                f" a step (all-to-alls / gradient reduction "
                f"{', '.join(f'{d['all_to_all']:.2f} / {d['grad_reduce']:.2f}' for d in r['split_s'])}"
                f" s), peak {r['peak_bytes'] / 1e9:.1f} GB, staged "
                f"{r['staged']}" for r in recs)
            log(f"[{tag}] {recs[0]['params'] / 1e9:.2f} B parameters, "
                f"{SEQ['seq']} tokens a step, {SEQ['seq'] // 2} a rank: "
                f"losses {', '.join(f'{x:.6f}' for x in res['losses'])} "
                f"against seq 1's "
                f"{', '.join(f'{x:.6f}' for x in ref['losses'])} "
                f"({res['max_rel_loss_diff']:.2e} relative, limit "
                f"{res['loss_tol']:.0e})"
                + (f"; parameters within {res['max_param_diff']:.2e} "
                   f"(max |param| {res['max_abs_param']:.3f}, largest "
                   f"change {res['max_param_change']:.2e})"
                   if "max_param_diff" in res else "")
                + f"; K4 launches a rank {res['launches_per_rank']}; "
                f"{steps} (seq 1: "
                f"{', '.join(f'{t:.2f}' for t in ref['step_s'])} s); "
                f"ranks time-slicing one card over gloo: no measure of "
                f"sequence parallelism's speed")
            # (c) the same leg at {"tensor": 2} against the same
            # reference; the fp32 leg again with the ring overlap on
            runs = [(leg[0], False)] + ([(f"{leg[0]} overlap", True)]
                                        if leg[1] == SEQ_LEGS[0][1]
                                        else [])
            off = None
            for name, overlap in runs:
                ttag = f"tensor {SEQ['name']} x{leg[1]} {name}"
                trecs = two.run(seq_rank_leg, leg, 2, dev.type, "tensor",
                                overlap, timeout=600)
                tres = tensor_check(ttag, ref, trecs, leg,
                                    off if overlap else None)
                tres.update(ranks=trecs)
                rec["tensor"][name] = tres
                log_tensor_leg(ttag, tres, trecs, ref)
                off = trecs
    finally:
        shutil.rmtree(SEQ_DIR, ignore_errors=True)
    parent = all_counts()
    if any(parent.values()):
        raise AssertionError(f"[seq] this process launched kernels: {parent}")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[seq] {card}: phase {rec['seconds']:.1f} s")
    return rec


def seq_launches(rec: dict) -> dict:
    """Each kernel's launches summed over the seq-2 and tensor-2 ranks of
    every leg, as each rank counted them."""
    total: dict = collections.Counter()
    for leg in list(rec["legs"].values()) + list(rec["tensor"].values()):
        for r in leg["ranks"]:
            total.update(r["launches"])
    return {k: v for k, v in total.items() if v}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    ap.add_argument("--out", default="chiprun_out",
                    help="directory for the full JSON record")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    bad = set(phases) - set(ALL_PHASES)
    if bad:
        ap.error(f"unknown phases {sorted(bad)}")
    if "serve-profile" in phases and "serve" not in phases:
        ap.error("serve-profile profiles the serve phase's runs: name both")
    if not torch.cuda.is_available():
        log("no CUDA device: this smoke run needs one NVIDIA GPU")
        return 2
    from deepspeed_tpu_torch.accelerator import (card_name_and_power_limit,
                                                 get_device)

    dev = get_device()
    card = card_name_and_power_limit()
    log(f"[device] {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    record: dict = {"card": card, "phases": {}}
    # wall seconds of each phase (the script's time limit is 1200 s)
    laps: dict = {}
    t_lap = [t_start]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name] = laps.get(name, 0.0) + now - t_lap[0]
        t_lap[0] = now
    k1 = {"name": "paged_ragged_attention", "route": "cuda",
          "source": "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
          "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:137",
          "launches": None}
    k1_e4m3 = {"name": "paged_ragged_attention (e4m3 pool)", "route": "cuda",
               "source": "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
               "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:517",
               "launches": None}
    # K1's forms, each counted apart (a ring launch is a window launch too)
    k1_forms = {form: {"name": f"paged_ragged_attention ({what})",
                       "route": "cuda",
                       "source": "deepspeed_tpu_torch/ops/csrc/"
                                 "paged_attention.cu",
                       "replaces": f"deepspeed_tpu/ops/pallas/"
                                   f"paged_attention.py:{line}",
                       "launches": None}
                for form, what, line in (
                    ("window", "sliding window", 242),
                    ("ring", "rolling ring", 264),
                    ("tree", "tree verify", 233))}
    k2 = {"name": "quant_matmul", "route": "cuda",
          "source": "deepspeed_tpu_torch/ops/csrc/quant_matmul.cu",
          "replaces": "deepspeed_tpu/ops/pallas/quant_matmul.py:136",
          "launches": None, "library_ms": None}
    k3 = {"name": "quant_grouped_matmul", "route": "cuda",
          "source": "deepspeed_tpu_torch/ops/csrc/quant_matmul.cu",
          "replaces": "deepspeed_tpu/ops/pallas/quant_matmul.py:455",
          "launches": None}
    k5 = {"name": "grouped_matmul", "route": "cuda",
          "source": "deepspeed_tpu_torch/ops/csrc/grouped_matmul.cu",
          "replaces": "deepspeed_tpu/ops/pallas/grouped_matmul.py:51",
          "launches": None}
    # K5's backward: dx is `_gmm_kernel` with transpose_rhs=True (called
    # from `_gmm_bwd` :188), dw `_dw_kernel` :130 (call :173)
    k5_dx = {"name": "grouped_matmul (backward dx)", "route": "cuda",
             "source": "deepspeed_tpu_torch/ops/csrc/grouped_matmul.cu",
             "replaces": "deepspeed_tpu/ops/pallas/grouped_matmul.py:51 "
                         "(transpose_rhs=True, :188)",
             "launches": None}
    k5_dw = {"name": "grouped_matmul (backward dw)", "route": "cuda",
             "source": "deepspeed_tpu_torch/ops/csrc/grouped_matmul.cu",
             "replaces": "deepspeed_tpu/ops/pallas/grouped_matmul.py:130",
             "launches": None}
    # K4's forward, and its backward (dq kernel + dk/dv kernel, counted once
    # a call). The backward's numbers come from the train shape, S = 2048,
    # where the Pallas package runs the split `_dq_kernel` / `_dkv_kernel`
    # (:275, :312); the same CUDA entry stands in for the merged
    # `_dqkv_kernel` (:356) at S <= 1024
    k4_fwd = {"name": "flash_attention (forward)", "route": "cuda",
              "source": "deepspeed_tpu_torch/ops/csrc/flash_attention.cu",
              "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:183",
              "launches": None}
    k4_bwd = {"name": "flash_attention (backward)", "route": "cuda",
              "source": "deepspeed_tpu_torch/ops/csrc/flash_attention.cu",
              "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:275 "
                          "and :312",
              "launches": None}
    # K6's forward, and its backward (dq kernel + dk/dv kernel, counted once
    # a call); their launches come from the sparse phase, all on the wgmma
    # route (K4's tensor-core bodies in flash_tc.cuh over the layout's
    # table). K7 has no caller on any path of either package: its launches
    # are the kernel phase's
    k6_fwd = {"name": "block_sparse_flash_attention (forward, wgmma route)",
              "route": "cuda",
              "source": "deepspeed_tpu_torch/ops/csrc/"
                        "block_sparse_attention.cu",
              "replaces": "deepspeed_tpu/ops/pallas/"
                          "block_sparse_attention.py:95",
              "launches": None}
    k6_bwd = {"name": "block_sparse_flash_attention (backward, wgmma "
                      "route)",
              "route": "cuda",
              "source": "deepspeed_tpu_torch/ops/csrc/"
                        "block_sparse_attention.cu",
              "replaces": "deepspeed_tpu/ops/pallas/"
                          "block_sparse_attention.py:180 and :215",
              "launches": None}
    k7 = {"name": "paged_prefill_attention", "route": "cuda",
          "source": "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
          "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:56",
          "launches": None}
    built = phase_build()          # every later phase runs the kernels
    record["phases"]["build"] = {n: r["seconds"] for n, r in built.items()}
    lap("build")
    if "kernel" in phases:
        k1_res = k1_resources(built)
        k1_host = k1_host_cost(dev)
        default, e4m3, cases = phase_k1(dev)
        cases = [{"resources": k1_res}, k1_host] + cases
        k1.update(default)
        k1_e4m3.update(e4m3)
        forms, form_cases = phase_k1_forms(dev)
        for form, summary in forms.items():
            k1_forms[form].update(summary)
        cases += form_cases
        k2_res = k2_resources(built)
        k2_summary, k2_cases = phase_k2(dev)
        k2_cases = [{"resources": k2_res}] + k2_cases
        k2.update(k2_summary)
        k5_res = k5_resources(built)
        k5_summary, k5_cases = phase_k5(dev)
        k5_cases = [{"resources": k5_res}] + k5_cases
        k5.update(k5_summary)
        k5_dx_summary, k5_dw_summary, k5_bwd_cases = phase_k5_bwd(dev)
        k5_dx.update(k5_dx_summary)
        k5_dw.update(k5_dw_summary)
        k5_cases += k5_bwd_cases
        k3_summary, k3_cases = phase_k3(dev)
        k3.update(k3_summary)
        k4f_summary, k4b_summary, k4_cases = phase_k4(dev, built)
        k4_fwd.update(k4f_summary)
        k4_bwd.update(k4b_summary)
        k6f_summary, k6b_summary, k6_cases = phase_k6(dev, built)
        k6_fwd.update(k6f_summary)
        k6_bwd.update(k6b_summary)
        k7_summary, k7_cases = phase_k7(dev)
        k7.update(k7_summary)
        record["phases"]["kernel"] = {"k1": cases, "k2": k2_cases,
                                      "k3": k3_cases, "k4": k4_cases,
                                      "k5": k5_cases, "k6": k6_cases,
                                      "k7": k7_cases,
                                      "tp_shards": phase_tp_shards(dev)}
    lap("kernel")
    if "observe" in phases:
        # telemetry and HF import: its timed legs before any profiler of
        # any phase runs (the serve phase profiles after its serves)
        observe = phase_observe(dev)
        record["phases"]["observe"] = observe
        summ = observe["serve"]["summary"]
        k1["observe"] = {
            "card": observe["card"],
            "import_GBps": observe["import"]["convert_GBps"],
            "decode_ms_per_token": [summ["on"]["decode_ms_per_token"],
                                    summ["off"]["decode_ms_per_token"]],
            "window_dispatch_us": [summ["on"]["window_dispatch_us"],
                                   summ["off"]["window_dispatch_us"]],
            "plan_us": [observe["plans"]["native_us"],
                        observe["plans"]["python_us"]],
            "mfu": observe["train"]["on"]["mfu"]}
    lap("observe")
    if "parity" in phases:
        record["phases"]["parity"] = phase_parity(dev)
    lap("parity")
    if "serve" in phases:
        serve = phase_serve(dev, profile="serve-profile" in phases)
        record["phases"]["serve"] = serve
        # each kernel's launches summed over the serve runs (each run's
        # counts start at 0)
        runs = [run for model in serve.values() for run in model.values()]
        for rec, key in ((k1, "k1"), (k1_e4m3, "k1_e4m3"),
                         (k1_forms["window"], "k1_window"),
                         (k1_forms["ring"], "k1_ring"),
                         (k1_forms["tree"], "k1_tree"), (k2, "k2"),
                         (k3, "k3"), (k5, "k5")):
            rec["launches"] = sum(run["launches"][key] for run in runs)
        # K2's and K3's launches on the wgmma route (every bf16 one)
        for rec, key in ((k2, "k2_tc"), (k3, "k3_tc")):
            rec["launches_wgmma"] = sum(run["launches"][key] for run in runs)
    lap("serve")
    if "train-parity" in phases:
        record["phases"]["train-parity"] = phase_train_parity(dev)
    lap("train-parity")
    if "train" in phases:
        train = phase_train(dev)
        record["phases"]["train"] = train
        k4_fwd["launches"] = train["launches"]["k4_fwd"]
        k4_bwd["launches"] = train["launches"]["k4_bwd"]
    lap("train")
    if "moe-train-parity" in phases:
        record["phases"]["moe-train-parity"] = phase_moe_train_parity(dev)
    lap("moe-train-parity")
    if "moe-train" in phases:
        moe_train = phase_moe_train(dev)
        record["phases"]["moe-train"] = moe_train
        got = moe_train["launches"]
        # K5's forward runs on the serving and the MoE training paths; K4
        # on both training paths
        k5["launches"] = (k5["launches"] or 0) + got["k5"]
        k5_dx["launches"] = got["k5_dx"]
        k5_dw["launches"] = got["k5_dw"]
        k4_fwd["launches"] = (k4_fwd["launches"] or 0) + got["k4_fwd"]
        k4_bwd["launches"] = (k4_bwd["launches"] or 0) + got["k4_bwd"]
    lap("moe-train")
    # the rank pools of zero's CPU ranks and the tp and seq phases start
    # here: their processes import and warm up while the phases up to the
    # fleet's run (idle, ~0.3 GB of host memory each)
    start_pools(([2] if {"zero", "tp", "seq"} & set(phases) else [])
                + ([4] if "tp" in phases else []))
    if "zero" in phases:
        zero = phase_zero(dev, record["phases"].get("train"))
        record["phases"]["zero"] = zero
        got = zero["launches"]
        # the ZeRO runs' K4 (dense and MoE) and K5 (MoE) launches
        for rec, key in ((k4_fwd, "k4_fwd"), (k4_bwd, "k4_bwd"), (k5, "k5"),
                         (k5_dx, "k5_dx"), (k5_dw, "k5_dw")):
            rec["launches"] = (rec["launches"] or 0) + got[key]
    lap("zero")
    if "sparse" in phases:
        sparse = phase_sparse(dev)
        record["phases"]["sparse"] = sparse
        k6_fwd["launches"] = sparse["k6_fwd"]
        k6_bwd["launches"] = sparse["k6_bwd"]
    lap("sparse")
    if "offload" in phases:
        offload = phase_offload(dev, record["phases"].get("train"))
        record["phases"]["offload"] = offload
        got = offload["launches"]
        for rec, key in ((k4_fwd, "k4_fwd"), (k4_bwd, "k4_bwd")):
            rec["launches"] = (rec["launches"] or 0) + got[key]
    lap("offload")
    if "kvmove" in phases:
        kvmove = phase_kvmove(dev)
        record["phases"]["kvmove"] = kvmove
        got = kvmove["launches"]
        # K1 (bf16 pool) on every migrated, pulled, gang-merged and
        # promoted sequence and through the swap; the phase's numbers ride
        # beside
        k1["launches"] = (k1["launches"] or 0) + got["k1"]
        mig, tier, swap = kvmove["migration"], kvmove["tier"], kvmove["swap"]
        k1["kvmove"] = {
            "launches": got, "card": kvmove["card"],
            "layers": kvmove["layers"],
            "migration": {k: mig[k] for k in (
                "pages", "bytes", "export_GBps", "import_GBps",
                "export_to_first_decode_s")},
            "pull_ttft_s": [kvmove["pull_gang"]["pull"]["ttft_pulled_s"],
                            kvmove["pull_gang"]["pull"]["ttft_cold_s"]],
            "tier_promote_GBps": [tier["from_ram"]["GBps"],
                                  tier["from_nvme"]["GBps"]],
            "tier_crc_share": tier["crc_share"],
            "swap_s": {k: swap[k] for k in ("save_s", "verify_s",
                                            "quiesce_s", "swap_s")}}
    lap("kvmove")
    if "fleet" in phases:
        fleet = phase_fleet(dev)
        record["phases"]["fleet"] = fleet
        # K1 in every engine replica that exited cleanly (their own
        # counts, from their logs); the phase's numbers ride beside
        k1["launches"] = (k1["launches"] or 0) + fleet["launches"]["k1"]
        mixed, disagg = fleet["mixed"], fleet["disagg"]
        k1["fleet"] = {
            "launches": fleet["launches"], "card": fleet["card"],
            "tok_s": [mixed["nofault"]["tok_s"], disagg["run"]["tok_s"]],
            "ttft_p50_s": [mixed["nofault"]["ttft_p50_s"],
                           disagg["run"]["ttft_p50_s"]],
            "respawn_ready_s": mixed["kill"]["kill"]["respawn_ready_s"],
            "handoff_GBps": disagg["GBps"],
            "near_ties": {k: v["near_ties"]
                          for k, v in fleet["oracle"].items()}}
    lap("fleet")
    if "tp" in phases:
        tp = phase_tp(dev)
        record["phases"]["tp"] = tp
        # K1 on every rank of every tp run, and K2 / K3 on the quantized
        # legs' (per-shard shapes, ring steps included)
        got = tp_launches(tp)
        for rec, key in ((k1, "k1"), (k1_e4m3, "k1_e4m3"),
                         (k1_forms["window"], "k1_window"),
                         (k1_forms["ring"], "k1_ring"), (k2, "k2"),
                         (k3, "k3")):
            rec["launches"] = (rec["launches"] or 0) + got.get(key, 0)
        k1["tp"] = {"card": tp["card"], "launches": got,
                    "legs": {tag: {run: {k: r[k] for k in (
                        "tok_s", "ttft_p50_s", "decode_ms_per_token_step",
                        "collective_s", "ring")}
                        for run, r in leg["runs"].items()}
                        for tag, leg in tp["legs"].items()}}
    lap("tp")
    if "seq" in phases:
        seq = phase_seq(dev)
        record["phases"]["seq"] = seq
        # K4 forward and backward on every seq-2 and tensor-2 rank of the
        # legs, each rank's own counts summed
        got = seq_launches(seq)
        for rec, key in ((k4_fwd, "k4_fwd"), (k4_bwd, "k4_bwd")):
            rec["launches"] = (rec["launches"] or 0) + got.get(key, 0)
        k4_fwd["seq"] = {"card": seq["card"], "launches": got,
                         "legs": {tag: {k: leg[k] for k in (
                             "losses", "ref_losses", "max_rel_loss_diff")}
                             for tag, leg in seq["legs"].items()},
                         "tensor_legs": {tag: {k: leg[k] for k in (
                             "losses", "ref_losses", "max_rel_loss_diff",
                             "ring")}
                             for tag, leg in seq["tensor"].items()}}
    close_pools()
    lap("seq")
    if "observe" in phases:
        # the breach capture (a profiler) last of all
        breach = phase_observe_breach(dev)
        observe["breach"] = breach
        # K1 on every forward of the observed serves (telemetry on and
        # off) and of the breach capture's; K4 in the observed training
        got = dict(observe["launches"])
        got["k1"] += breach["k1_launches"]
        for rec, key in ((k1, "k1"), (k4_fwd, "k4_fwd"), (k4_bwd, "k4_bwd")):
            rec["launches"] = (rec["launches"] or 0) + got[key]
    lap("observe-breach")
    record["phase_seconds"] = laps
    log(f"[time] seconds by phase: "
        f"{', '.join(f'{k} {v:.1f}' for k, v in laps.items())}")
    record["seconds"] = time.perf_counter() - t_start
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    log(f"[done] {record['seconds']:.1f}s")
    log(json.dumps({"kernels": [k1, k1_e4m3, *k1_forms.values(), k2, k3,
                                k4_fwd, k4_bwd, k5, k5_dx, k5_dw, k6_fwd,
                                k6_bwd, k7]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        close_pools()
