#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; none is caught):

1. build: compile every CUDA source of ``src/repro_torch/csrc`` with nvcc, all
   at once; log every kernel's registers, shared memory and spills (``ptxas
   -v``) and fail on a spill in the attention backward's wgmma instance;
2. kernels: run ``a2a_pack``, ``a2a_unpack``, ``grouped_matmul`` and
   ``flash_attention`` at the serving paths' prefill and decode shapes and at
   ragged ones, hold each against its plain PyTorch version (pack and unpack
   bit for bit, on every instance, bulk, vec and bytes, in f32, bf16 and
   int8, with a sentinel in the blocks unpack must not write;
   grouped_matmul within a relative error of 1e-5 in f32 and 2e-2 in bf16,
   on both of its bf16 instances, TMA + wgmma and WMMA; flash_attention
   within an absolute error of 2e-5 in f32 and 2e-2 in bf16, the
   reference's kernel tolerances, on contiguous tensors and on
   ``[B, S, H, D]`` views) and time each, its plain version and one PyTorch
   library call by device time (``cuda_ms``: CUDA events around runs of
   back-to-back launches, median of 20 runs), pack and unpack also one call
   per event pair (``call_ms``: host and device) and on each 16-byte
   instance; print the kernel to library ratios and each kernel's
   registers, shared memory and spills from ``ptxas -v``; then a small f32
   MoE layer on a (2, 2, 1) mesh against its one-rank path; then AdamW's
   two kernels (``phase_adamw``): ``sq_norm`` and ``adamw_step`` on 72
   ragged leaves of every (parameter, gradient) dtype pair, two launches
   each (more leaves than one table holds), three steps, clipped and not,
   against their plain versions (p, m and v within 1e-6 of the largest
   magnitude, a bf16 master within one bf16 ulp; each leaf's sum within a
   relative 1e-5), then at megatron-moe-32e's training leaves (``[32,
   2048, 8192]``, ``[32, 8192, 2048]``, ``[50304, 2048]``, ``[2048]``, f32):
   the norm bit-identical over two calls, each timed beside its bound (28
   B and 4 B a parameter), its plain version and PyTorch's
   ``_fused_adamw_`` and ``_foreach_norm`` (yardsticks only: the port
   never calls them); their launches are counted on every training path
   below (one each a step on megatron-moe-32e's);
3. megatron-moe-32e at its published widths (4 of 24 layers, random weights
   from a seed) on a local (pod 2, data 16, model 1) mesh, expert dispatch
   through the FAST plan: prefill of 32 prompts of 128 tokens, then 15
   decode steps, counting each kernel's launches; the same with ``direct``
   and a prefill with the config's ``flash`` (logits bit-identical to the
   plan's); then the plain versions (``use_kernel=False``): routing
   decisions that differ are counted, and the gates are the first attention
   layer and the first MoE layer on identical bf16 inputs (within 2e-2,
   routing equal) and the prefill in f32 (within a relative logit
   difference of 1e-4, no routing decision that differs);
4. mixtral-8x7b at its published widths (4 of 32 layers) on the same mesh,
   its 8 experts over ``pod`` alone: (a) 32 prompts of 1024 tokens and 15
   decode steps through ``plan``, then through the config's ``flash`` (the
   rotation schedule), bit-identical; (b) int8 dispatch through ``plan``,
   its first MoE layer within (0, 0.05) of exact on identical inputs, the
   prefill's logits and routing differences reported; (c) one prompt of
   8192 tokens through the 4096-token window and 15 decode steps on the
   4096-slot ring cache; the gates of phase 3 at mixtral's shapes; and a
   ``torch.profiler`` window over one (a) prefill and three decode steps:
   device time by kernel name and the device's idle share.

5. backward kernels: ``flash_attention``'s ``lse`` against the plain
   forward's, ``flash_attention_bwd`` against ``flash_attention_bwd_ref``
   (within 1e-5 in f32 and 2e-2 in bf16 of the largest reference gradient
   of the case) on 480 ragged shapes, bf16 through both instances (the
   rule's, wgmma, and simt forced), the rule's run twice and bit-identical
   (no atomics), at the training shape (q [32, 32, 512, 64], 8 kv heads,
   causal) and at mixtral's windowed shape (q [1, 32, 8192, 128], window
   4096), timed beside the simt instance, its plain version and SDPA's
   backward;
   grouped_matmul's backward products (dX and dW of the gate/up and down
   products, an operand read transposed in place) against the plain
   version and timed beside ``bmm`` at the training shapes, and beside the
   same product on contiguous copies of the transposes and those copies;
6. training megatron-moe-32e at its published widths (2 of 24 layers, f32
   masters, bf16 compute, remat) on the same mesh, EP over (pod, data)
   through the island and the config's ``flash`` exchange: 32 x 512 tokens
   a step, 4 AdamW steps with the kernels, each step's launches gated (per
   layer: 2 attention forwards under remat, 1 backward on its wgmma
   instance, 6 grouped_matmul forwards and 6 backward products, all on
   TMA; no pack or unpack), then
   the same 4 steps with ``use_kernel=False`` (step losses within 2e-2);
   the first attention and MoE layer's bf16 gradients on identical inputs
   within 2e-2 of plain, routing equal; one layer's forward run twice,
   bit-identical (remat recomputes it); an f32 run (1 layer, 32 x 128
   tokens) whose every gradient is within a relative norm of 1e-4 of the
   plain version's; the ``Trainer`` at smoke size with a checkpoint and a
   resume (within a relative 1e-6 of an unbroken run: the embedding's
   backward sums with atomics); and a ``torch.profiler`` window over one
   step.

7. the other stacks, no mesh, random weights from the seed, f32 parameters
   and bf16 compute: xlstm-125m (all 12 layers) and hymba-1.5b (all 32,
   scanned: full-size caches and no window in the prefill) serve 8 prompts
   of 1024 tokens and 15 decode steps (xlstm launches no attention kernel;
   hymba one flash_attention a layer in the prefill, none in decode); in
   f32 on 2 prompts of 256 tokens, each xlstm layer's prefill states and
   last output against a teacher-forced decode chain on identical inputs
   (relative 1e-4; the whole stack's chain reported) and hymba at 4
   layers against the plain versions (1e-4); hymba's first layer on
   identical bf16 inputs within 2e-2 of plain; a ``torch.profiler`` window
   over hymba's prefill (the recurrences' time loops' share); hymba trained
   at 2 layers (full, then windowed attention) on 4 x 2048 tokens, two
   AdamW steps with the kernels (every backward on wgmma) and two plain
   (losses within 2e-2), each layer's bf16 gradients on identical inputs
   within 2e-2; whisper-tiny (4 + 4 layers, 1500 frames) for 32 requests:
   the encoder and cross K/V, ``Model.prefill`` over a 64-token prompt, a
   teacher-forced decode chain over it and 15 greedy steps (the chain
   within 1e-4 of the forward in f32; the first encoder layer within 2e-2
   of plain in bf16); and the plan-serving daemon's device handoff
   (``--plan-server``).

8. one process per rank: megatron-moe-32e (4 of 24 layers, published
   widths) on a (pod 2, data 2, model 1) ``ProcessMesh`` of 4 processes
   started by ``launch/serve.serve_procs`` on the one card, exchanging
   through pinned host memory over gloo (4 processes sharing one GPU's SMs:
   no time here is a 4-GPU time).  The parent builds the f32 model once,
   serves it on ``LocalMesh((2, 2, 1))`` as the oracle (f32 prefill; bf16
   prefill and 15 decode steps; the first layer), and hands it to
   ``serve_procs``, which shares it with the children through CUDA IPC;
   each cuts its shard (its 8 rows of the 32 prompts of 128 tokens, its 8
   of the 32 experts), then the parent drops the whole before any serves.
   Each process then runs phase 8's per-rank hook: every collective of
   ``launch/mesh.py`` and ``comm/collectives.py`` and every exchange on its
   rows bit for bit against ``LocalMesh`` (``pmean`` within 1e-6),
   megatron's prefill dispatch buffer through ``plan`` with and without
   the kernels; ``serve_procs``' own f32 serve, its prefill gathered on
   rank 0 within 1e-4 of the oracle and its greedy tokens equal, where a
   routing decision may differ only at a near tie (each sequence's first
   difference at an oracle margin of at most ``NEAR_TIE``, 1e-5; two
   planted faults must fail that gate); the bf16 prefill and decode with
   each kernel's launches equal to the oracle's, at most
   ``PROC_BF16_APART_MAX`` (4) of the 32 sequences routed apart from the
   oracle and greedy tokens equal in every sequence routed alike;
   ``direct``, ``flash`` and ``hierarchical`` prefills bit-identical to
   the plan's; the first attention and MoE layer on identical inputs
   within 2e-2 of the oracle, routing equal (bit-identity reported);
   prefill ms, decode ms/step, peak memory and the exchange's share of a
   traced prefill (its ``procmesh.*`` ranges, host staging included).  Then
   one process on NCCL (a world of one) against ``LocalMesh((1, 1, 1))``,
   and ``backend="nccl"`` with two ranks on one card must raise.

9. training on one process per rank, on the same (pod 2, data 2, model 1)
   ``ProcessMesh`` of 4 gloo processes sharing the card (no time here is a
   4-GPU time): (a) megatron-moe-32e at its published widths (2 of 24
   layers, f32 masters, bf16 compute, remat, the config's ``flash``
   exchange), 32 x 512 tokens a step (8 x 512 a process), 3 AdamW steps
   through ``launch/train.train_procs``, the path of ``train --procs``: the
   parent builds the f32 model once and hands it to the processes through
   CUDA IPC, each cuts its shard (its 8 of the 32 experts), the parent
   drops the whole, and each process runs the CLI's own loop under a
   per-rank hook; the oracle is the same 3 steps on ``LocalMesh((2, 2,
   1))``, run first in the parent and freed.  Gated: each process's
   launches every step equal to the oracle's (grouped_matmul on TMA alone,
   the attention backward on wgmma alone, no pack or unpack), step losses
   within 2e-2 of the oracle's; reported: routing decisions that differ,
   step ms and tokens/s per process and for the oracle, each process's peak
   GB and the card's GB in use, and from the last step, traced, the shares
   of the forward's and backward's collectives (the exchange and the aux
   loss's mean, their ``procmesh.*`` ranges, host staging included) and of
   the gradient sync (``train.grad_sync``).  (b) The f32 gate: 1 layer, 32
   x 128 tokens, 2 steps on the 4 processes against the stacked oracle:
   metrics within a relative 1e-5, every gradient (each process's slice
   against the oracle's, combined over the processes) within a relative
   norm of 1e-4, every parameter after step 2 within 1e-5 of its tensor's
   largest value (an element whose oracle gradients lie at the f32 noise
   floor of the sums, within ``NOISE_GRAD`` of its slice's largest, within
   ``NOISE_STEP`` x the peak rate: Adam's step of such an element follows
   the noise; two planted controls, that class's update skipped and its
   sign flipped, must fail it), a routing difference only at a near tie
   (``NEAR_TIE``), launches equal; a planted fault, ``pmean``'s backward
   replaced by a local ``1 / n``, must fail the gradient gate.  (c) The ``Trainer`` on
   the 4 processes at smoke size (f32): 6 steps unbroken against 3, a
   checkpoint written by the 4 processes and a resume, within 1e-6; that
   checkpoint restored on ``LocalMesh((2, 2, 1))`` bit for bit, and
   trained there to step 6: its last loss within a relative 1e-5 of the
   processes' unbroken run, its parameters within a relative norm of
   1e-5.

10. the split island on one process per rank (the MoE with EP over one
   mesh axis or none), 6 or 3 gloo processes sharing the card through
   ``serve_procs`` and ``train_procs`` with phase 8's hand-off (no time here
   is a multi-GPU time); each oracle is the same work on a ``LocalMesh`` of
   the same shape, run first in the parent and freed.  (a) mixtral-8x7b at
   its published widths (2 of 32 layers) on (pod 2, data 3, model 1), where
   ``choose_ep_axes`` gives ``("pod",)`` (4 experts a process), the plan on
   ``ClusterSpec(2, 3)``: 24 prompts of 1024 tokens (4 a process) and 15
   decode steps through the plan, the rotation (``flash``, bit-identical to
   the plan) and int8 dispatch; gated: on an identical MoE input, each
   process's routing, token grid ``[E_loc, p * C, d]`` and exchanges bit for
   bit its slice of the stacked run's (plan, rotation, int8); the f32
   prefill (128-token prompts) within 1e-4 of the oracle, routing apart only
   at a near tie, greedy tokens equal; bf16 launches of every kernel equal
   to the oracle's (grouped_matmul on TMA, pack and unpack on the instance
   ``a2a_pack.variant`` picks), at most ``PROC_BF16_APART_MAX`` sequences
   routed apart and tokens equal in every sequence routed alike; the first
   attention and MoE layer within 2e-2; the first MoE layer under int8
   within (0, 0.05) of exact; reported per process: prefill ms, decode
   ms/step, peak GB, the card's GB, the exchange's share of a traced
   prefill.  (b) 1 layer at the same widths in f32, 12 prompts of 128
   tokens: EP over ``data`` alone on (3, 2, 1) (4 experts a process) and no
   EP on (1, 3, 1) (all 8 in each): prefill logits within 1e-4, routing
   apart only at a near tie, the grid and exchanges bit for bit, launches
   equal.  (c) the smoke mixtral (4 experts, f32) trained on (2, 3, 1):
   2 AdamW steps through ``train_procs`` against the stacked step, metrics
   within 1e-5, gradients within a relative norm of 1e-4, every expert's
   gradient nonzero, launches equal; then one step with int8 dispatch,
   reported;
11. tensor parallelism over "model" on one process per rank, under
   ``serve_procs`` and ``train_procs`` as in phases 8 to 10 (each process
   holds its heads, its slice of the FFN's and the experts' ``d_ff`` and
   of the vocabulary; the oracles run on a ``LocalMesh`` of the same DP
   shape, "model" at 1, whole weights).  (a) megatron-moe-32e at its
   published widths (4 of 24 layers) on (pod 2, data 2, model 2), 8
   processes, 32 prompts of 128 tokens and 15 decode steps through the
   plan; gated: on an identical MoE input each process's routing and grid
   bit for bit its slice of the stacked run's, model peers' outputs and
   residual streams bit-identical; the f32 prefill within 1e-4, routing
   apart only at a near tie, tokens equal; bf16 launches equal to the
   oracle's; held to the witness (``TPRounding``: the oracle with each
   row-parallel product rounded per peer before the sum, TP's rounding and
   nothing else of TP) at most ``PROC_BF16_APART_MAX`` sequences routed
   apart (the plain oracle, held alike, must fail), tokens apart only at a
   ``BF16_TOKEN_TIE`` of the witness (a planted token must fail), the MoE
   layer on the identical input bit for bit the witness's; against the
   plain oracle every first difference at a margin within
   ``TP_BF16_TIE``; the first attention and MoE layer within 2e-2.  (b)
   llama3.2-1b (16 layers) on (1, 2, 2): f32 logits within 1e-4, tokens
   equal, each process's cache gathered by heads within 1e-5; bf16
   launches equal, tokens held to the witness as in (a).  (c)
   megatron-moe-32e (1 layer) trained on (2, 2, 2): bf16 launches equal,
   losses within 2e-2, replicated leaves' gradients bit-identical on model
   peers (in (a)'s 8 processes after their serving, through
   ``train_procs``' per-rank path on the parent's shared model: one start
   of the processes for both); the f32 gate (metrics 1e-5, gradients a
   relative norm of 1e-4, parameters 1e-5) refusing a planted copy on the
   MoE's ``x``.  Reported
   per process: prefill ms, decode ms/step or step ms, peak GB, the shares
   of a traced prefill or step in the exchange and the sums over "model".
12. tensor parallelism over "model" where it cuts through the kv heads, on
   the reference's TP width: megatron-moe-32e at its published widths (32
   heads over 8 kv heads) on (pod 1, data 1, model 16), 16 processes
   through ``serve_procs`` and ``train_procs`` (each process projects its
   half of a kv head's key and value columns, gathers them over "model"
   and keeps the kv head its 2 query heads read; its oracles run on
   ``LocalMesh((1, 1, 1))``, whole weights).  (a) 2 of 24 layers, 32
   prompts of 128 tokens on every process and 15 decode steps: the f32
   prefill within 1e-4, routing apart only at a near tie, tokens equal,
   each process's decode cache (its one kv head) put together with its
   peers' within 1e-5 of the oracle's, the replicas bit-identical; the
   planted fault (each process reading the next kv head) must fail the f32
   gate; bf16 launches equal to the oracle's, streams and tokens
   bit-identical on model peers, held to the witness (``TPRounding`` over
   16 peers) at ``PROC_BF16_APART_MAX`` sequences routed apart (the plain
   oracle must fail that) and ``BF16_TOKEN_TIE``.  (b) 1 layer trained,
   8 x 512 tokens on every process, 3 steps (in (a)'s processes, as phase
   11 (c) in 11 (a)'s): launches equal, losses within 2e-2, replicated
   gradients bit-identical on model peers; the f32 gate
   of phases 9 and 11 on 8 x 128 tokens, refusing a planted fault (the kv
   gather's backward without its sum over "model").  Reported per
   process: prefill ms, decode ms/step, step ms, peak GB, the card's GB,
   the shares of a traced prefill in ``procmesh.tp_gather`` and
   ``procmesh.tp_sum``.
13. tensor parallelism over "model" where it cuts through a query head,
   each cell in one spawn of ``serve_procs`` whose per-rank hook serves,
   then trains a 1-layer model each process makes from the seed through
   ``train_procs``' per-rank path twice (bf16, then the f32 gate).  (a)
   internvl2-1b at its published widths (2 of 24 layers; 14 heads over 2
   kv heads of 64) on (1, 1, 16), 16 processes: 56 of a 64-wide head's
   columns a process, the peers' query columns gathered and the 1 or 2
   whole heads they touch computed, this process's columns of their
   output kept; 8 requests of its 256 patch positions + 128 tokens on
   every process and 15 decode steps.  (b) whisper-tiny (2 + 2 of its 4 +
   4 layers, 1500 frames; 6 heads: 1.5 a process) on (1, 2, 4), 8
   processes, served through ``serve_procs`` with the frames in
   ``extras`` (the encoder and cross K/V, then the decode step over an
   8-token prompt) and 15 decode steps.  Gated in each: the f32 prompt
   pass within 1e-4 of ``LocalMesh`` (whisper's teacher-forced forward
   too), tokens equal, the caches (and cross caches) by kv head within
   1e-5, the replicas bit-identical, the planted fault (each process
   keeping its neighbour's columns) refused; bf16 launches equal, each
   shared query head's output bit-identical on its peers, streams and
   tokens bit-identical on model peers, tokens held to the witness at
   ``BF16_TOKEN_TIE``; trained (internvl2-1b 1 layer, 1 x 384 positions;
   whisper 8 x 64 tokens), 2 steps: launches equal, losses within 2e-2,
   replicated gradients bit-identical, and the f32 gate refusing the same
   planted fault (a leaf initialised at zero, whisper's biases, is held
   in the noise class).  Reported per process as phase 12.
14. the recurrent and hybrid families over "model", and ``pure_dp``, each
   cell in one spawn of ``serve_procs`` whose per-rank hook serves, then
   trains models each process makes from the seed through ``train_procs``'
   per-rank path (bf16, then each f32 gate).  (a) hymba-1.5b at its
   published widths (2 of 32 layers, not scanned: layer 0 full, layer 1
   windowed) on (1, 1, 16), 16 processes: 100 of its 1600 Mamba channels a
   process (the peers' ``in_proj`` columns gathered, its own ``x`` and
   ``z`` channels kept; ``w_dt``, ``wb`` and ``wc`` in one row-parallel
   sum), 100 query columns (2 or 3 of its 25 heads of 64 touched); 8
   requests of 512 tokens on every process and 15 decode steps; trained at
   1 layer, 8 x 32.  (b) xlstm-125m (its first 4 layers, m m m s) on (1,
   1, 8): half an mLSTM head's columns and 96 sLSTM channels a process
   (``h`` gathered once a step); 8 x 256 tokens, 15 steps; trained 8 x
   32, its f32 gates on each block kind alone (1 layer of m, 1 of s).  (c) ``pure_dp`` on (1, 2, 2), 4 processes, weights whole and
   the prompts over every axis: megatron-moe-32e (1 layer) served through
   the plan, 32 x 128, each ``(pod, data)`` shard's two processes' rows
   gathered and routed together; qwen3-0.6b (4 of 28 layers) trained 8 x
   128.  Gated in each:
   the f32 prompt pass within 1e-4 of ``LocalMesh``, tokens equal, f32
   routing apart only at a near tie; the decode states and caches put
   together (``whole_states``, the replicas bit-identical; by rows under
   ``pure_dp``) within 1e-5 of the oracle's layer on the processes' own
   input of that layer (the whole stack's reported: the sLSTM's
   recurrence amplifies f32 rounding); the planted fault (a neighbour's
   channels, a peer's rows) refused; bf16 launches equal, streams and
   tokens bit-identical on model peers (the MoE's grids under
   ``pure_dp``), tokens held to the witness (the plain oracle under
   ``pure_dp``) at ``BF16_TOKEN_TIE``, at most ``PROC_BF16_APART_MAX``
   sequences routed apart; trained 2 steps: launches equal, losses within
   2e-2, replicated gradients bit-identical; the f32 gate refusing its
   planted fault (a neighbour's channels; the gathers' backward unsummed;
   ``_sync_grads`` skipping "model").  Reported per process: prompt-pass
   ms, decode ms/step, the shares of a traced prompt pass in
   ``procmesh.tp_*`` and in the scan loops (``ssm_scan``), step ms, peak
   and card GB.
15. sequence parallelism and FSDP on one process per rank, each cell in
   one spawn of ``serve_procs`` whose per-rank hook serves, then trains
   the 1-layer model the parent makes from the seed and shares through
   CUDA IPC (bf16, then the f32 gate).  (a) megatron-moe-32e with
   ``seq_shard_activations`` and ``fsdp`` on (1, 2, 4), 8 processes: the
   residual stream on a quarter of the sequence between the TP regions
   (``tp.gather_seq`` / ``scatter_seq``), every weight of two or more
   dims but the experts' stored over ``data`` and gathered at each
   block's start (``models/fsdp.py``); 2 of 24 layers served through the
   plan, 32 requests of 128 tokens and 15 decode steps; each process also
   cuts the 1-layer model for SP + FSDP and for the same mesh's TP with
   neither knob and holds their prompt passes bit for bit, in f32 and in
   bf16; trained at 1 layer, 8 x 128.  (b) qwen3-0.6b with ``pure_dp``
   and ``fsdp`` on (1, 2, 2), 4 processes (weights over ``data`` and
   "model", the batch over ``data``): 4 of 28 layers served 8 x 128 with
   4 decode steps and trained 8 x 128, its f32 gate at 1 layer.  Gated as
   phase 14 (the caches by kv head over the model peers in (a), the model
   peers' replicas bit-identical in (b)), and the planted faults refused:
   a ``scatter_seq`` keeping the neighbour's chunk and a ``fsdp_gather``
   joining the slices rolled (the f32 serving gate), the sync leaving the
   norms' chunk-partial gradients unsummed over "model" (the gradient gate
   and the model peers' bit-identity) and a ``fsdp_gather`` backward
   keeping its own gradient unsummed (the gradient gate).  Reported per
   process: each ``procmesh.*`` range's share of a traced prompt pass and
   step, f32 parameter and moment GB beside the whole model's, step ms,
   peak and card GB.
16. the roofline and the dry run (``launch/roofline.py``,
   ``launch/dryrun.py``).  (a) rank 0 of the multi-pod production mesh
   (2, 16, 16) dry-run at the published widths on meta tensors, on the
   host: mixtral-8x7b ``prefill_32k`` through the plan and
   megatron-moe-32e ``train_4k``; every key printed, ``params_total``,
   ``params_active`` and ``model_flops_total`` gated against the config's
   own counts.  (b) phase 8's megatron-moe-32e cell on its 4 processes:
   rank 0's prompt pass under ``count()`` must equal the dry run of the
   same cell and mesh exactly (FLOPs, bytes, kernels, collectives by op
   and tier), and must not with ``grouped_matmul``'s report removed in the
   processes (the planted fault).  (c) phase 4's stacked mixtral-8x7b
   plan prefill under ``count()``, beside the same step's count on meta
   tensors: its compute, memory and collective terms, the dominant one
   and its measured time.

Every bf16 serving and training run must launch grouped_matmul on its TMA +
wgmma instance alone (``grouped_matmul.launches_by_variant``), training its
attention backward on wgmma alone, and serving pack and unpack
on the instance ``a2a_pack.variant`` picks for the exchange's size: bulk for
mixtral's prefill exchanges, vec for the rest, never bytes.  The profiler
window also gives the median device time of a pack and an unpack launch in
the prefill and in decode.

The last lines are the card's name and power limit, one JSON line of kernel
results, and ``{"ok": true, "device": {...}}``.  Each kernel's ``launches``
there is its count on the port's main path, the MoE cells: the
megatron-moe-32e training run (4 steps) for grouped_matmul, flash_attention,
flash_attention_bwd, sq_norm and adamw_step, mixtral's plan run for pack
and unpack;
``launches_by_path`` lists every path's counts, phases 7's to 15's
too (phases 8's to 15's are rank 0's, equal in every process).  It exits
non-zero, printing no result, without a CUDA device or outside a checkout
of the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

ARCH, N_LAYERS = "megatron-moe-32e", 4
MIX_ARCH, MIX_LAYERS = "mixtral-8x7b", 4
MESH = (2, 16, 1)
BATCH, PROMPT, GEN = 32, 128, 16
MIX_PROMPT, LONG_PROMPT, F32_PROMPT = 1024, 8192, 128
SEED = 0
TIMED_RUNS = 20
RUN_MS, MAX_REPS = 2.0, 100    # cuda_ms: device time a timed run should fill
SLEEP_CYCLES_PER_MS = 2.0e6    # torch.cuda._sleep cycles a ms at <= 2 GHz
DEVICE = "cuda"
SERVE_KERNELS = ("a2a_pack", "a2a_unpack", "grouped_matmul",
                 "flash_attention")
KERNELS = SERVE_KERNELS + ("flash_attention_bwd",)
# AdamW's kernels: megatron-moe-32e's training leaves, the cell's largest
# (the expert stacks), the embedding's and the smallest (a norm's scale),
# f32 masters and gradients; and ragged leaves of every dtype pair, more
# than one launch's table holds
ADAMW_SHAPES = ((32, 2048, 8192), (32, 8192, 2048), (50304, 2048), (2048,))
ADAMW_RAGGED = (1, 7, 8, 9, 31, 4096, 32768, 32769, 100_003) * 8
ADAMW_CFG = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
ADAMW_KERNELS = ("sq_norm", "adamw_step")
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 32, 512, 4
F32_TRAIN_SEQ = 128
# phase 7: the recurrent, hybrid and encoder-decoder stacks, no mesh
XLSTM_ARCH, HYMBA_ARCH, WHISPER_ARCH = ("xlstm-125m", "hymba-1.5b",
                                        "whisper-tiny")
STACK_BATCH, STACK_PROMPT = 8, 1024
STACK_GATE_BATCH, STACK_GATE_PROMPT = 2, 256
HYMBA_F32_LAYERS = 4
HYMBA_TRAIN_LAYERS, HYMBA_TRAIN_BATCH, HYMBA_TRAIN_SEQ = 2, 4, 2048
WHISPER_BATCH, WHISPER_PROMPT = 32, 64
PLAN_SERVER_STEPS = 16
# phase 8: one process per rank of a (pod 2, data 2, model 1) mesh on the
# one card, exchanging through host memory (gloo)
PROC_MESH, PROC_BACKEND = (2, 2, 1), "gloo"
AXES = ("pod", "data", "model")
PROC_BATCH = 32                  # 8 prompts a process
PROC_TIMEOUT_S, PROC_JOIN_S = 120.0, 600.0
# a routing decision whose top-k and (k+1)-th router logits lie within this
# share of the token's largest logit is a near tie: f32 rounding of
# differently shaped products (1024 rows a process, 4096 stacked) can flip
# it.  The one such flip seen sat at 7.728e-07, where the logits differ by
# 4.4e-06 (PERF.md); near_tie_controls shows what the limit refuses
NEAR_TIE = 1e-5
# bf16 sequences routed apart from the stacked run (2 of 32 seen, PERF.md);
# in phase 11 from the witness (TPRounding)
PROC_BF16_APART_MAX = 4
# phases 10 and 11: a bf16 sequence routed alike may pick another greedy
# token only where the oracle's (phase 11: the witness's) logits of the two
# choices lie within this share of the row's largest logit (about twice the
# largest bf16 prefill difference seen between the processes and the
# stacked run, 5.6e-3, PERF.md)
BF16_TOKEN_TIE = 1e-2
PROC_PATH = "megatron-moe-32e procs (2,2,1)"
PROC_LABEL = ("4 processes sharing one GPU's SMs, exchanging through pinned "
              "host memory over gloo: not a 4-GPU time")
# phase 9: training on one process per rank of the same mesh
TRAIN_PROC_STEPS, F32_PROC_STEPS = 3, 2
TRAIN_PROC_PATH = "megatron-moe-32e train procs (2,2,1)"
TRAINER_PROC_STEPS = 6
# phase 10: the split island (EP over one axis or none) on processes
SPLIT_MESH, SPLIT_LAYERS = (2, 3, 1), 2
SPLIT_BATCH = 24                 # 4 prompts a process
SPLIT_PATH = "mixtral-8x7b procs (2,3,1)"
SPLIT_TRAIN_PATH = "mixtral-8x7b smoke train procs (2,3,1)"
SPLIT_LABEL = ("processes sharing one GPU's SMs, exchanging through pinned "
               "host memory over gloo: not a multi-GPU time")
# (b): form -> (mesh, the EP axes choose_ep_axes must give)
SPLIT_FORMS = {"data": ((3, 2, 1), ("data",)), "none": ((1, 3, 1), None)}
FORM_LAYERS, FORM_BATCH, FORM_PROMPT = 1, 12, 128
SPLIT_TRAIN_BATCH, SPLIT_TRAIN_SEQ, SPLIT_TRAIN_STEPS = 12, 64, 2
# phase 11: under TP each sum over "model" rounds its bf16 partial products
# once more than one product does, which flips routers' near ties and
# greedy near ties (about 1% of routing decisions a layer, PERF.md).  The
# witness (TPRounding: the stacked oracle with that rounding alone) holds
# the bf16 runs at PROC_BF16_APART_MAX and BF16_TOKEN_TIE.  Against the
# plain oracle a bf16 sequence may be routed apart, or pick another greedy
# token, only where it first differs at an oracle margin (router logits)
# or gap (vocabulary logits) within TP_BF16_TIE of the row's largest: the
# bf16 layer tolerance.  The first differences seen reached 9.9e-3
# (routing, megatron's 4 layers) and 1.48e-2 (tokens, llama3.2-1b's 16),
# the oracles' median choices lie at 7.6e-2 and 3.8e-2 (PERF.md); a control
# at that median must fail
TP_BF16_TIE = 2e-2
# phase 11: tensor parallelism over "model" on processes: megatron-moe-32e
# served (N_LAYERS layers) and trained (TP_TRAIN_LAYERS) on (2, 2, 2),
# whose DP shape is PROC_MESH's (the oracles'), llama3.2-1b served on
# (1, 2, 2), its f32 check on DENSE_F32_BATCH prompts
TP_MESH, TP_DENSE_MESH, TP_TRAIN_LAYERS = (2, 2, 2), (1, 2, 2), 1
DENSE_ARCH, DENSE_F32_BATCH = "llama3.2-1b", 8
TP_PATH = "megatron-moe-32e tp procs (2,2,2)"
TP_DENSE_PATH = "llama3.2-1b tp procs (1,2,2)"
TP_TRAIN_PATH = "megatron-moe-32e tp train procs (2,2,2)"
TP_LABEL = ("processes sharing one GPU's SMs, exchanging and summing over "
            "'model' through pinned host memory over gloo: not a multi-GPU "
            "time")
# phase 12: tensor parallelism over "model" where it cuts through the kv
# heads: megatron-moe-32e (32 heads over 8 kv heads) on (1, 1, 16), the
# reference's TP width, 16 processes sharing the card; served (KV_LAYERS
# layers, PROC_BATCH x PROMPT tokens on every process: no DP axis) and
# trained (1 layer, KV_TRAIN_BATCH x TRAIN_SEQ tokens, the rows a process
# of phase 11 (c); the f32 gate on KV_TRAIN_BATCH x F32_TRAIN_SEQ)
KV_MESH, KV_LAYERS, KV_TRAIN_BATCH = (1, 1, 16), 2, 8
KV_PATH = "megatron-moe-32e tp procs (1,1,16)"
KV_TRAIN_PATH = "megatron-moe-32e tp train procs (1,1,16)"
# phase 13: tensor parallelism over "model" where it cuts through a query
# head.  (a) internvl2-1b (14 heads over 2 kv heads of 64) on (1, 1, 16),
# the reference's TP width: 56 of a 64-wide head's columns a process, the
# 1 or 2 whole query heads they touch computed; served (HEAD_LAYERS of 24
# layers, HEAD_BATCH rows of its 256 patch positions + HEAD_TOKENS tokens
# on every process, no DP axis) and trained (1 layer, HEAD_TRAIN_BATCH x
# HEAD_TRAIN_SEQ, the f32 gate alike: the whole 151655-row embedding, its
# gradient and moments on every process, and a step's logits fill the
# card at 16 processes).  (b) whisper-tiny (6 heads of 64: 1.5 a process)
# at its published widths on (1, 2, 4), 8 processes, ENCDEC_LAYERS +
# ENCDEC_LAYERS of its 4 + 4 layers: served (ENCDEC_BATCH requests of
# ENCDEC_PROMPT tokens over 1500 frames: each prompt token is a decode
# step) and trained (ENCDEC_TRAIN_BATCH x ENCDEC_TRAIN_SEQ; a step's
# gradient sync over "data" is one host-staged gather a leaf).  Each cell
# is one spawn (head_cell_child): starting and ending 16 processes on the
# card takes about 45 s
HEAD_ARCH, HEAD_MESH, HEAD_LAYERS, HEAD_TRAIN_STEPS = ("internvl2-1b",
                                                       (1, 1, 16), 2, 2)
HEAD_BATCH, HEAD_TOKENS = 8, 128
HEAD_TRAIN_BATCH, HEAD_TRAIN_SEQ = 1, 384
ENCDEC_MESH, ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_LAYERS = (1, 2, 4), 8, 8, 2
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ = 8, 64
HEAD_PATH = "internvl2-1b tp procs (1,1,16)"
HEAD_TRAIN_PATH = "internvl2-1b tp train procs (1,1,16)"
ENCDEC_PATH = "whisper-tiny tp procs (1,2,4)"
ENCDEC_TRAIN_PATH = "whisper-tiny tp train procs (1,2,4)"
# phase 14: the recurrent and hybrid families over "model" and pure_dp,
# each cell one spawn of serve_procs whose per-rank hook serves, then
# trains REC_TRAIN_STEPS steps (bf16) and its f32 gates (phase 13's form).
# (a) hymba-1.5b at its published widths on (1, 1, 16): 100 of its 1600
# Mamba channels a process (the in_proj gathered), 100 query columns (2 or
# 3 of its 25 heads of 64 touched), REC_HYMBA_LAYERS of 32 layers (layer 0
# full, layer 1 windowed), REC_BATCH x REC_HYMBA_PROMPT tokens on every
# process; trained 1 layer.  (b) xlstm-125m on (1, 1, 8): half an mLSTM
# head (96 of 192 columns) and 96 sLSTM channels a process, the
# pattern's first REC_XLSTM_LAYERS layers (XLSTM_PATTERN).  (c) pure_dp
# on (1, 2, 2): megatron-moe-32e (PURE_DP_SERVE_LAYERS layer) served
# through the plan, each (pod, data) shard's two processes' rows routed
# together; qwen3-0.6b (PURE_DP_TRAIN_LAYERS of 28 layers) trained.
# Training shapes are (batch, seq)
REC_TRAIN_STEPS, REC_BATCH = 2, 8
REC_HYMBA_MESH, REC_HYMBA_LAYERS, REC_HYMBA_PROMPT = (1, 1, 16), 2, 512
REC_HYMBA_TRAIN = (8, 32)
REC_XLSTM_MESH, REC_XLSTM_LAYERS, REC_XLSTM_PROMPT = (1, 1, 8), 4, 256
REC_XLSTM_TRAIN = (8, 32)
XLSTM_PATTERN = ("m", "m", "m", "s")
PURE_DP_MESH = (1, 2, 2)
PURE_DP_SERVE_ARCH, PURE_DP_SERVE_LAYERS = "megatron-moe-32e", 1
PURE_DP_BATCH, PURE_DP_PROMPT = 32, 128
PURE_DP_TRAIN_ARCH, PURE_DP_TRAIN_LAYERS = "qwen3-0.6b", 4
PURE_DP_TRAIN = (8, 128)
REC_HYMBA_PATH = "hymba-1.5b tp procs (1,1,16)"
REC_HYMBA_TRAIN_PATH = "hymba-1.5b tp train procs (1,1,16)"
REC_XLSTM_PATH = "xlstm-125m tp procs (1,1,8)"
REC_XLSTM_TRAIN_PATH = "xlstm-125m tp train procs (1,1,8)"
PURE_DP_PATH = "megatron-moe-32e pure_dp procs (1,2,2)"
PURE_DP_TRAIN_PATH = "qwen3-0.6b pure_dp train procs (1,2,2)"
# phase 15: (a) megatron-moe-32e with seq_shard_activations and FSDP on
# (1, 2, 4): SP over a 4-way "model", FSDP over data, the experts over the
# EP axes choose_ep_axes picks; served through the plan at SPF_LAYERS of 24
# layers, SPF_BATCH x SPF_PROMPT tokens; trained at 1 layer, SPF_TRAIN.
# (b) qwen3-0.6b with pure_dp and FSDP on (1, 2, 2) (phase 14 (c)'s
# training cell with FSDP): FSDP_LAYERS of 28 layers, served FSDP_BATCH x
# FSDP_PROMPT and FSDP_STEPS decode steps (each gathers every weight
# through the host), trained FSDP_TRAIN
SPF_ARCH, SPF_MESH, SPF_LAYERS = "megatron-moe-32e", (1, 2, 4), 2
SPF_BATCH, SPF_PROMPT, SPF_TRAIN = 32, 128, (8, 128)
FSDP_ARCH, FSDP_MESH, FSDP_LAYERS = "qwen3-0.6b", (1, 2, 2), 4
FSDP_BATCH, FSDP_PROMPT, FSDP_TRAIN, FSDP_STEPS = 8, 128, (8, 128), 4
SPF_PATH = "megatron-moe-32e sp+fsdp procs (1,2,4)"
SPF_TRAIN_PATH = "megatron-moe-32e sp+fsdp train procs (1,2,4)"
FSDP_PATH = "qwen3-0.6b pure_dp+fsdp procs (1,2,2)"
FSDP_TRAIN_PATH = "qwen3-0.6b pure_dp+fsdp train procs (1,2,2)"
# phase 16: the roofline and the dry run.  (a) rank 0 of the multi-pod
# production mesh (2, 16, 16) at the published widths on meta tensors, the
# DRY_CELLS (arch, shape, exchange); (b) phase 8's megatron-moe-32e cell on
# its 4 processes, rank 0's prompt pass counted against the dry run of the
# same cell and mesh (ROOF_GEN - 1 decode steps served after); (c) phase
# 4's stacked mixtral-8x7b plan prefill counted, and timed over ROOF_RUNS
DRY_CELLS = (("mixtral-8x7b", "prefill_32k", "plan"),
             ("megatron-moe-32e", "train_4k", None))
ROOF_GEN, ROOF_RUNS = 3, 3
# phase 9's f32 gate: an element whose oracle gradient stays within
# NOISE_GRAD of its tensor slice's largest, every step, lies at the f32
# noise floor of the gradient sums (the processes' and the stacked mesh's
# differ by about 1e-7 of the largest, PERF.md), where Adam's normalised
# step follows the noise: it is held within NOISE_STEP x the peak rate,
# every other element within 1e-5 of its tensor's largest.  The strict
# class's worst is also reported at each of NOISE_GRAD_SCAN's thresholds;
# NOISE_GRAD is the smallest of them read 30% under its limit (PERF.md).
NOISE_GRAD = 5e-5
NOISE_STEP = 0.1
NOISE_GRAD_SCAN = (1e-5, 2e-5, 5e-5, 1e-4)
# the serving shapes' flash_attention device ms before the forward kernel
# could write lse (PERF.md, section 6), for the check that serving, which
# asks for none, kept its time
FLASH_MS_BEFORE_LSE = {"megatron-moe-32e prefill": 0.0491,
                 "mixtral-8x7b prefill": 1.6262,
                 "mixtral-8x7b long prefill": 1.9873}
# block sizes of the bulk-against-vec sweep, 64 blocks each: 8 KiB to 1280
# MiB moved, the serving exchanges' range
SWEEP_BLOCK_BYTES = (128, 64 << 10, 256 << 10, 512 << 10, 2 << 20, 8 << 20,
                     20 << 20)


def serve_config():
    """megatron-moe-32e at its published widths, depth cut to N_LAYERS."""
    from repro_torch.configs import get_config

    return get_config(ARCH, n_layers=N_LAYERS)


def train_config(**over):
    """megatron-moe-32e at its published widths, depth cut to
    TRAIN_LAYERS."""
    from repro_torch.configs import get_config

    return get_config(ARCH, **{"n_layers": TRAIN_LAYERS, **over})


def mixtral_config(**over):
    """mixtral-8x7b at its published widths, depth cut to MIX_LAYERS."""
    from repro_torch.configs import get_config

    return get_config(MIX_ARCH, n_layers=MIX_LAYERS, **over)


def stack_config(arch, **over):
    """xlstm-125m, hymba-1.5b or whisper-tiny at its published config."""
    from repro_torch.configs import get_config

    return get_config(arch, **over)


def log(*a):
    print(*a, flush=True)


def call_ms(torch, fn, runs=TIMED_RUNS, warmup=3) -> float:
    """Median time in ms of one call of ``fn`` between a CUDA-event pair,
    over ``runs`` pairs.  Where the host's work for a call outlasts the
    kernel, the device idles between the events while the host works, so
    this is host plus device: what one call costs a caller that waits."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def cuda_ms(torch, fn, runs=TIMED_RUNS, warmup=3) -> float:
    """Device time in ms of one call of ``fn``: the median over ``runs``
    CUDA-event pairs, each around a run of back-to-back calls (as many as
    fill about RUN_MS of device time, at most MAX_REPS), divided by the
    run's length.  A sleep kernel ahead of each pair holds the device while
    the host enqueues the run, so the host's time between calls does not
    enter.  The L2 is not flushed: the serving caller writes a kernel's
    input just before it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()                                  # the host's enqueue time of a call
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    one = call_ms(torch, fn, runs=1, warmup=0)
    reps = max(1, min(MAX_REPS, int(RUN_MS / max(one, 1e-3))))
    hold = min(2 * reps * host_ms + 0.1, 50.0) if reps > 1 else 0.0
    pairs = []
    for _ in range(runs):
        if hold:
            torch.cuda._sleep(int(hold * SLEEP_CYCLES_PER_MS))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) / reps for a, b in pairs)


def rel_err(torch, y, ref) -> float:
    y, ref = y.float(), ref.float()
    return ((y - ref).abs().max() / (ref.abs().max() + 1e-9)).item()


def max_abs(torch, y, ref) -> float:
    return (y.float() - ref.float()).abs().max().item()


def free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def kernel_names(path):
    """The ``__global__`` function names defined in a CUDA source."""
    import re

    return re.findall(
        r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
        path.read_text())


def template_args(rest):
    """The template arguments of a mangled kernel name, given what follows
    the kernel's own name: ints, ``f32`` and ``bf16``."""
    import re

    out = []
    a = rest[1:rest.find("EE") + 1] if rest.startswith("I") else ""
    while a:
        num = re.match(r"Li(\d+)E", a)
        if num:
            out.append(num.group(1))
            a = a[num.end():]
        elif a.startswith("13__nv_bfloat16"):
            out.append("bf16")
            a = a[len("13__nv_bfloat16"):]
        elif a.startswith("f"):
            out.append("f32")
            a = a[1:]
        elif re.match(r"S\d*_", a) and out:
            # a substitution: here always the argument before
            out.append(out[-1])
            a = a[re.match(r"S\d*_", a).end():]
        else:
            break
    return out


def ptxas_lines(_build):
    """One line per kernel of every source: registers, shared memory,
    spills, from the ``ptxas -v`` report of its build."""
    import re

    lines = []
    for path in sorted(_build.CSRC.glob("*.cu")):
        src = path.stem
        kernels = kernel_names(path)
        name = None
        for line in _build.ptxas_report(src).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:  # the source's name of the mangled kernel, its template
                # arguments (dtype, width, layout bits)
                name = max((k for k in kernels if k in m.group(1)), key=len,
                           default=m.group(1))
                targs = template_args(m.group(1).split(name, 1)[-1])
                name += f"<{', '.join(targs)}>" if targs else ""
                spill = ""
            elif name and "spill" in line:
                spill = line.strip()
            elif name and "Used" in line:
                lines.append(f"ptxas: {src}.cu {name}: "
                             f"{line.split(':', 1)[1].strip()}; {spill}")
                name = None
    return lines


# kernels that must build without a spill (ptxas -v)
NO_SPILL = ("bwd_prep_kernel", "bwd_dkdv_wgmma_kernel", "bwd_dq_wgmma_kernel",
            "sq_norm_kernel", "adamw_kernel")


def check_no_spill(lines):
    """Every instance of the NO_SPILL kernels in the ptxas lines reports no
    spill store or load; returns those lines."""
    import re

    mine = [line for line in lines
            if re.search(r"\b(" + "|".join(NO_SPILL) + r")<", line)]
    found = {k for k in NO_SPILL if any(f" {k}<" in line for line in mine)}
    bad = [line for line in mine
           if not ("0 bytes spill stores" in line
                   and "0 bytes spill loads" in line)]
    if found != set(NO_SPILL) or bad:
        raise AssertionError(f"ptxas: kernels {sorted(set(NO_SPILL) - found)} "
                             f"not reported, or spills: {bad}")
    return mine


def a2a_instance(moved_bytes):
    """The instance a serving exchange of aligned blocks should take: bulk
    from ``BULK_MIN_BYTES`` moved, vec below (``a2a_pack.variant``)."""
    from repro_torch.kernels.a2a_pack import BULK_MIN_BYTES

    return "bulk" if moved_bytes >= BULK_MIN_BYTES else "vec"


def forced_copy(torch, x, idx, block_rows, n_out, name, scatter):
    """Pack (or, with ``scatter``, unpack into ``n_out`` blocks) through
    instance ``name`` itself, bypassing the wrapper's rule and counts."""
    from repro_torch.kernels.a2a_pack.a2a_pack import _block_copy

    r, d = block_rows, x.shape[1]
    rows = max(idx.shape[0], n_out) if scatter else idx.shape[0]
    out = torch.empty((rows * r, d), dtype=x.dtype, device=x.device)
    _block_copy(x, out, idx, n_out if scatter else x.shape[0] // r,
                r * d * x.element_size(), scatter, name)
    return out


def check_pack(torch, k, x, idx, block_rows, name=None) -> float:
    """a2a_pack of ``x`` by ``idx`` against the plain version, bit for bit:
    through the wrapper (the rule's instance) or, with ``name``, through
    that instance itself.  Returns the measured max abs difference."""
    out = (k.a2a_pack(x, idx, block_rows=block_rows) if name is None else
           forced_copy(torch, x, idx, block_rows, 0, name, False))
    ref = k.a2a_pack_ref(x, idx, block_rows=block_rows)
    if not torch.equal(out, ref):
        raise AssertionError(f"a2a_pack ({name or 'rule'}) != plain: "
                             f"{tuple(x.shape)} r={block_rows}")
    return max_abs(torch, out, ref)


def check_unpack(torch, k, y, idx, block_rows, n_out, trash=None,
                 name=None) -> float:
    """a2a_unpack of ``y`` by ``idx`` against the plain version, bit for
    bit on the named blocks (``trash`` marks blocks written more than once,
    not compared), through the wrapper or, with ``name``, that instance
    itself.  The kernel also scatters into a buffer longer than its output,
    filled with a sentinel: unnamed blocks and every row after the output
    must still hold it.  Returns the measured max abs difference over the
    named blocks."""
    from repro_torch.kernels.a2a_pack.a2a_pack import _block_copy

    r, d, m = block_rows, y.shape[1], idx.shape[0]
    n_tot = max(m, n_out)
    out = (k.a2a_unpack(y, idx, n_out_blocks=n_out, block_rows=r)
           if name is None else
           forced_copy(torch, y, idx, r, n_out, name, True))
    ref = k.a2a_unpack_ref(y, idx, n_out_blocks=n_out, block_rows=r)
    ref = ref.reshape(n_tot, r, d)
    named = torch.unique(idx.long())
    if trash is not None:
        named = named[~trash[named]]
    got = out.reshape(n_tot, r, d)[named]
    if not torch.equal(got, ref[named]):
        raise AssertionError(f"a2a_unpack ({name or 'rule'}) != plain: "
                             f"{tuple(y.shape)} r={r}")
    err = max_abs(torch, got, ref[named])
    del out, got
    extra = 3
    big = torch.full(((n_tot + extra) * r, d), 7, dtype=y.dtype,
                     device=y.device)
    _block_copy(y, big, idx, n_tot, r * d * y.element_size(), True, name)
    blocks = big.reshape(n_tot + extra, r, d)
    unnamed = torch.ones(n_tot + extra, dtype=torch.bool, device=y.device)
    unnamed[idx.long()] = False
    if not bool((blocks[unnamed] == 7).all()):
        raise AssertionError("a2a_unpack wrote outside its named blocks")
    if not torch.equal(blocks[named], ref[named]):
        raise AssertionError("a2a_unpack into a longer buffer != plain")
    return err


def roofline():
    """The port's roofline module: the H100's rates and the kernels'
    formulas (operations and bytes of a call), which the bounds here and
    ``count()`` share."""
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    from repro_torch.launch import roofline as R

    return R


def hbm_bytes_per_s() -> float:
    return roofline().HBM_BW


def peak_ops_per_s() -> dict:
    """Dense peak operations a second by dtype name (no TF32)."""
    return roofline().PEAK_FLOPS_BY_DTYPE


def bound_of(cost, dtype_name="bfloat16"):
    """(bound ms, what bounds it) of a call of ``cost`` (operations,
    bytes): the larger of the operations at the dtype's peak and the bytes
    at the HBM rate."""
    flops, nbytes = cost
    t_ops = flops / peak_ops_per_s()[dtype_name] * 1e3
    t_bytes = nbytes / hbm_bytes_per_s() * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def gmm_bound(x, w):
    """(bound ms, what bounds it) of ``x [E, C, D] @ w [E, D, F]`` in bf16."""
    ee, c, dd = x.shape
    return bound_of(roofline().gmm_cost(ee, c, dd, w.shape[2], 2))


def band_pairs(s, causal, window) -> int:
    """Visible (query, key) pairs of one head of S tokens."""
    return roofline().band_pairs(s, causal, window)


def attn_bound(b, h, kv, s, d, causal, window, dtype_name, elem):
    """(bound ms, what bounds it) of one flash_attention call: 4 * D
    operations per visible pair and head; q, k, v read and o written once."""
    return bound_of(roofline().attn_cost(b, h, kv, s, d, causal, window,
                                         elem), dtype_name)


def exchange_rows(torch, mesh_shape, plan):
    """Global pack / unpack index rows of the plan exchange on
    ``mesh_shape`` (``plan_all_to_all``'s), and the unpack side's trash
    blocks."""
    from repro_torch.comm.plan_exec import _global_rows, lower_plan
    from repro_torch.launch.mesh import make_mesh

    dev = torch.device(DEVICE)
    p, i = mesh_shape[0], mesh_shape[1]
    n_ranks = p * i
    sched = lower_plan(plan, n_pods=p)
    pods = tuple(q for q in range(p) for _ in range(i))
    island = make_mesh(mesh_shape[:2], ("pod", "data"), dev)
    dst_idx = _global_rows(island, sched, pods, p, "dst_of", None, dev)
    src_idx = _global_rows(island, sched, pods, p + 1, "src_of", p, dev)
    n_out = n_ranks * (p + 1)
    trash = torch.zeros(max(n_out, src_idx.shape[0]), dtype=torch.bool,
                        device=dev)
    trash[torch.arange(n_ranks, device=dev) * (p + 1) + p] = True
    return sched, dst_idx, src_idx, n_out, trash


def copy_times(torch, k, x, idx, block, d, n_out, unpack):
    """Times of one pack or unpack: the kernel's, its plain version's and
    the library call's device ms (``cuda_ms``), and the kernel's and the
    library call's ms with one call per event pair (``call_ms``); and the
    two 16-byte instances' device ms, each launched itself."""
    dev = x.device
    n_blocks = idx.shape[0]
    il = idx.long()
    if unpack:
        out = torch.zeros((n_out * block, d), dtype=x.dtype, device=dev)
        xv, ov = x.view(n_blocks, block, d), out.view(n_out, block, d)
        fns = (lambda: k.a2a_unpack(x, idx, n_out_blocks=n_out,
                                    block_rows=block),
               lambda: k.a2a_unpack_ref(x, idx, n_out_blocks=n_out,
                                        block_rows=block),
               lambda: ov.index_copy_(0, il, xv))
    else:
        xv = x.view(-1, block, d)
        fns = (lambda: k.a2a_pack(x, idx, block_rows=block),
               lambda: k.a2a_pack_ref(x, idx, block_rows=block),
               lambda: torch.index_select(xv, 0, il))
    kernel, plain, lib = fns
    return {"ms": cuda_ms(torch, kernel), "plain_ms": cuda_ms(torch, plain),
            "library_ms": cuda_ms(torch, lib),
            "call_ms": call_ms(torch, kernel),
            "library_call_ms": call_ms(torch, lib),
            **{f"{name}_ms": cuda_ms(torch, lambda: forced_copy(
                torch, x, idx, block, n_out, name, unpack))
               for name in ("bulk", "vec")}}


def phase_kernels(torch):
    """a2a_pack, a2a_unpack and grouped_matmul against their plain versions
    on ragged shapes, then at megatron's and mixtral's exchange and expert
    products, with timings.  Returns the kernel result rows by name; each
    row's ``shapes`` lists every serving shape timed."""
    from repro_torch.kernels import a2a_pack as k
    from repro_torch.kernels.grouped_matmul import (
        grouped_matmul, grouped_matmul_ref)
    from repro_torch.launch.serve import flash_plan
    from repro_torch.models.moe import _capacity

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ragged shapes, every dtype the exchange may carry, each on contiguous
    # tensors and on views one element off 16-byte alignment, through the
    # wrappers (the rule: vec or bytes at these sizes) and, where the block
    # allows it, through bulk itself; every dtype must reach every instance
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        before = {kn: dict(getattr(k, kn).launches_by_variant)
                  for kn in ("a2a_pack", "a2a_unpack")}
        n_bulk = 0
        for d in (1, 5, 64, 130, 2048, 2056):
            for r in (1, 3, 8, 24):
                flat = (torch.randn((6 * r * d + 1,), generator=gen,
                                    device=dev) * 50).to(dt)
                aligned = r * d * flat.element_size() % 16 == 0
                for x, names in ((flat[: 6 * r * d].view(6 * r, d),
                                  (None, "bulk") if aligned else (None,)),
                                 (flat[1:].view(6 * r, d), (None,))):
                    for name in names:
                        idx = torch.randint(0, 6, (10,), generator=gen,
                                            device=dev, dtype=torch.int32)
                        check_pack(torch, k, x, idx, r, name)
                        perm = torch.randperm(9, generator=gen,
                                              device=dev)[:5]
                        check_unpack(torch, k, x[: 5 * r],
                                     perm.to(torch.int32), r, 9, name=name)
                        n_bulk += name == "bulk"
        torch.cuda.synchronize()
        hits = {kn: {v: n - before[kn][v] for v, n in
                     getattr(k, kn).launches_by_variant.items()}
                for kn in before}
        for kn, hit in hits.items():
            if not (hit["vec"] and hit["bytes"] and n_bulk):
                raise AssertionError(f"{kn}'s ragged {dt} checks missed an "
                                     f"instance: {hit}, bulk {n_bulk}")
        log(f"kernels: a2a_pack / a2a_unpack bit-exact on ragged {dt} shapes "
            f"(aligned and not); launches by instance {hits}, and {n_bulk} "
            f"shapes each through bulk")

    by_variant = dict(grouped_matmul.launches_by_variant)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for e, c, d, f in ((3, 37, 70, 45), (2, 100, 256, 513),
                           (4, 256, 1024, 512), (3, 37, 72, 200),
                           (2, 300, 136, 264)):
            x = torch.randn((e, c, d), generator=gen, device=dev).to(dt)
            w = torch.randn((e, d, f), generator=gen, device=dev).to(dt)
            cnt = torch.randint(0, c + 1, (e,), generator=gen, device=dev,
                                dtype=torch.int32)
            # the backward's forms too: x stored as x^T, w stored as w^T
            xt, wt = x.transpose(1, 2).contiguous(), \
                w.transpose(1, 2).contiguous()
            for counts in (None, cnt):
                ref = grouped_matmul_ref(x, w, counts)
                for kind, got in (
                        ("", lambda: grouped_matmul(x, w, counts)),
                        ("x^T ", lambda: grouped_matmul(
                            xt, w, counts, transpose_x=True)),
                        ("w^T ", lambda: grouped_matmul(
                            x, wt, counts, transpose_w=True)),
                        ("x^T w^T ", lambda: grouped_matmul(
                            xt, wt, counts, transpose_x=True,
                            transpose_w=True))):
                    err = rel_err(torch, got(), ref)
                    if not err < tol:
                        raise AssertionError(
                            f"grouped_matmul {kind}{dt} {(e, c, d, f)} "
                            f"counts={counts is not None}: rel err {err} >= "
                            f"{tol}")
    torch.cuda.synchronize()
    ragged = {k: n - by_variant[k]
              for k, n in grouped_matmul.launches_by_variant.items()}
    if not (ragged["wmma"] and ragged["tma"] and ragged["simt"]):
        raise AssertionError(f"grouped_matmul's ragged checks missed an "
                             f"instance: {ragged}")
    log(f"kernels: grouped_matmul within 1e-5 (f32) / 2e-2 (bf16) on ragged "
        f"shapes, with and without counts, x and w stored as given or "
        f"transposed; launches by instance {ragged}")

    bf16 = torch.bfloat16
    p, i = MESH[0], MESH[1]
    n_ranks = p * i
    plan = flash_plan(p, i, SEED)
    rows = {
        "a2a_pack": {"name": "a2a_pack", "route": "cuda",
                     "source": "src/repro_torch/csrc/a2a_block_copy.cu",
                     "replaces": "src/repro/kernels/a2a_pack/a2a_pack.py:73",
                     "max_abs_err": 0.0, "shapes": []},
        "a2a_unpack": {"name": "a2a_unpack", "route": "cuda",
                       "source": "src/repro_torch/csrc/a2a_block_copy.cu",
                       "replaces":
                       "src/repro/kernels/a2a_pack/a2a_pack.py:73",
                       "max_abs_err": 0.0, "shapes": []},
        "grouped_matmul": {
            "name": "grouped_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/grouped_matmul.cu",
            "replaces":
            "src/repro/kernels/grouped_matmul/grouped_matmul.py:76",
            "max_abs_err": 0.0, "max_err": 0.0, "shapes": []},
    }

    # The exchanges: megatron's EP over (pod, data) (one slot per stage of
    # i * E_loc * C rows), mixtral's over pod alone (E_loc * C rows a slot),
    # each at the prefill and the decode capacity.  Mixtral's int8 dispatch
    # exchanges int8 rows and f32 scale rows of width 1 as well.
    sched, dst_idx, src_idx, n_out, trash = exchange_rows(torch, MESH, plan)
    s = sched.n_stages
    for arch, cfg, fast in ((ARCH, serve_config(), True),
                            (MIX_ARCH, mixtral_config(), False)):
        e = cfg.moe.num_experts
        e_loc = e // (n_ranks if fast else p)
        prompt = PROMPT if arch == ARCH else MIX_PROMPT
        dtypes = ((bf16, cfg.d_model),) if fast else (
            (bf16, cfg.d_model), (torch.int8, cfg.d_model),
            (torch.float32, 1))
        for what, t in (("prefill", BATCH // n_ranks * prompt),
                        ("decode", BATCH // n_ranks)):
            cap = _capacity(cfg, t, e)
            block = (i if fast else 1) * e_loc * cap
            for dt, d in dtypes:
                x2 = (torch.randn((n_ranks * p * block, d), generator=gen,
                                  device=dev) * 50).to(dt)
                stack2 = (torch.randn((n_ranks * (s + 1) * block, d),
                                      generator=gen, device=dev) * 50).to(dt)
                bb = block * d * x2.element_size()
                want = {"a2a_pack": a2a_instance(dst_idx.shape[0] * bb),
                        "a2a_unpack": a2a_instance(src_idx.shape[0] * bb)}
                n_want = {kn: getattr(k, kn).launches_by_variant[v]
                          for kn, v in want.items()}
                errs = (check_pack(torch, k, x2, dst_idx, block),
                        check_unpack(torch, k, stack2, src_idx, block, n_out,
                                     trash))
                if any(getattr(k, kn).launches_by_variant[v] != n_want[kn] + 1
                       for kn, v in want.items()):
                    raise AssertionError(f"pack/unpack at the {arch} {what} "
                                         f"{dt} exchange did not take "
                                         f"{want}")
                for name in ("bulk", "vec"):  # each 16-byte instance itself
                    errs += (check_pack(torch, k, x2, dst_idx, block, name),
                             check_unpack(torch, k, stack2, src_idx, block,
                                          n_out, trash, name))
                for kname, err in zip(("a2a_pack", "a2a_unpack") * 3, errs):
                    rows[kname]["max_abs_err"] = max(
                        rows[kname]["max_abs_err"], err)
                torch.cuda.synchronize()
                name = str(dt).replace("torch.", "")
                log(f"kernels: pack/unpack bit-exact at the {arch} {what} "
                    f"exchange: {n_ranks} ranks x {s + 1} slots x {block} "
                    f"rows x {d} {name}, on {want} by the rule and on bulk "
                    f"and vec themselves")
                if dt is bf16:
                    for kname, x, idx, unpack in (
                            ("a2a_pack", x2, dst_idx, False),
                            ("a2a_unpack", stack2, src_idx, True)):
                        nbytes = idx.shape[0] * block * d * x.element_size()
                        entry = {
                            "path": f"{arch} {what}",
                            "shape": f"{idx.shape[0]} blocks x {block} x "
                                     f"{d} bf16",
                            **copy_times(torch, k, x, idx, block, d, n_out,
                                         unpack),
                            "bound_ms": bound_of(roofline().copy_cost(
                                nbytes))[0],
                            "bound_by": "bytes", "instance": want[kname]}
                        entry["ratio_to_library"] = (entry["ms"]
                                                     / entry["library_ms"])
                        entry["ratio_to_bound"] = (entry["ms"]
                                                   / entry["bound_ms"])
                        rows[kname]["shapes"].append(entry)
                        log("timing:", kname, json.dumps(entry))
                del x2, stack2
    free(torch)

    # bulk against vec by bytes moved: a pack of 64 int8 blocks in a random
    # order, each instance launched itself; BULK_MIN_BYTES rests on this
    sweep = []
    for blk in SWEEP_BLOCK_BYTES:
        x = torch.randint(-100, 100, (64, blk), generator=gen, device=dev,
                          dtype=torch.int8)
        idx = torch.randperm(64, generator=gen, device=dev).to(torch.int32)
        t = {name: cuda_ms(torch, lambda: forced_copy(
                 torch, x, idx, 1, 0, name, False))
             for name in ("bulk", "vec")}
        sweep.append({"moved_bytes": 64 * blk, "bulk_ms": t["bulk"],
                      "vec_ms": t["vec"], "rule": a2a_instance(64 * blk)})
        log(f"sweep: pack of 64 blocks x {blk} B ({64 * blk / 2**20:.3f} "
            f"MiB): bulk {t['bulk']:.4f} ms, vec {t['vec']:.4f} ms, "
            f"bulk/vec {t['bulk'] / t['vec']:.3f}; the rule picks "
            f"{sweep[-1]['rule']}")
        del x
    rows["a2a_pack"]["sweep"] = sweep
    free(torch)

    # grouped matmul at the expert products: gate/up [E, C, d] @ [E, d, f]
    # and down [E, C, f] @ [E, f, d], prefill and decode, counts=None (the
    # island's and the split island's groups hold many ranks' chunks)
    for arch, cfg in ((ARCH, serve_config()), (MIX_ARCH, mixtral_config())):
        e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
        prompt = PROMPT if arch == ARCH else MIX_PROMPT
        w_up = (torch.randn((e, d, f), generator=gen, device=dev)
                / d ** 0.5).to(bf16)
        w_dn = (torch.randn((e, f, d), generator=gen, device=dev)
                / f ** 0.5).to(bf16)
        for what, t in (("prefill", BATCH // n_ranks * prompt),
                        ("decode", BATCH // n_ranks)):
            # a group holds one expert's C rows from every rank
            c = n_ranks * _capacity(cfg, t, e)
            for kind, (x, w) in (
                    ("gate/up", (torch.randn((e, c, d), generator=gen,
                                             device=dev).to(bf16), w_up)),
                    ("down", (torch.randn((e, c, f), generator=gen,
                                          device=dev).to(bf16), w_dn))):
                n_tma = grouped_matmul.launches_by_variant["tma"]
                y, ref = grouped_matmul(x, w), grouped_matmul_ref(x, w)
                if grouped_matmul.launches_by_variant["tma"] != n_tma + 1:
                    raise AssertionError(
                        f"grouped_matmul at the {arch} {what} {kind} shape "
                        f"did not take the TMA + wgmma instance")
                err = rel_err(torch, y, ref)
                if not err < 2e-2:
                    raise AssertionError(
                        f"grouped_matmul bf16 at the {arch} {what} {kind} "
                        f"shape {tuple(x.shape)} @ {tuple(w.shape)}: rel err "
                        f"{err}")
                row = rows["grouped_matmul"]
                row["max_err"] = max(row["max_err"], err)
                row["max_abs_err"] = max(row["max_abs_err"],
                                         max_abs(torch, y, ref))
                del y, ref
                bound, by = gmm_bound(x, w)
                entry = {
                    "path": f"{arch} {what} {kind}",
                    "shape": f"{list(x.shape)} @ {list(w.shape)} bf16",
                    "ms": cuda_ms(torch, lambda: grouped_matmul(x, w)),
                    "plain_ms": cuda_ms(
                        torch, lambda: grouped_matmul_ref(x, w),
                        runs=TIMED_RUNS if arch == ARCH else 5, warmup=1),
                    "library_ms": cuda_ms(torch, lambda: torch.bmm(x, w)),
                    "bound_ms": bound, "bound_by": by, "instance": "tma"}
                entry["ratio_to_library"] = entry["ms"] / entry["library_ms"]
                entry["ratio_to_bound"] = entry["ms"] / bound
                row["shapes"].append(entry)
                log("timing: grouped_matmul", json.dumps(entry))
                del x
                free(torch)
        log(f"kernels: grouped_matmul bf16 within 2e-2 at the {arch} "
            f"prefill and decode products (gate/up and down)")
        del w_up, w_dn
        free(torch)
    log(f"kernels: grouped_matmul worst rel err "
        f"{rows['grouped_matmul']['max_err']:.3e}")
    return rows


def phase_flash_attention(torch):
    """flash_attention against its plain version on ragged shapes and at
    the serving paths' prefill shapes (f32 within 2e-5, bf16 within 2e-2,
    absolute), each on contiguous ``[B, H, S, D]`` tensors and on
    ``[B, S, H, D]`` memory seen as ``[B, H, S, D]`` (what attention_apply
    passes), then timings in bf16 beside the plain version and
    ``scaled_dot_product_attention``.  Returns the kernel's result row."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        attention_ref, flash_attention)

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

    def inputs(b, h, kv, s, d, dt, views=False):
        """q, k, v as [B, H, S, D]; with ``views``, [B, S, H, D] memory
        seen as [B, H, S, D], as attention_apply hands them over."""
        if views:
            return [torch.randn((b, s, n, d), generator=gen,
                                device=dev).to(dt).transpose(1, 2)
                    for n in (h, kv, kv)]
        return [torch.randn(shape, generator=gen, device=dev).to(dt)
                for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d))]

    def check(b, h, kv, s, d, causal, window, dt, views=False) -> float:
        q, k, v = inputs(b, h, kv, s, d, dt, views)
        out = flash_attention(q, k, v, causal=causal, window=window)
        ref = attention_ref(q, k, v, causal=causal, window=window)
        err = max_abs(torch, out, ref)
        if not (err <= tols[dt] and bool(torch.isfinite(out.float()).all())):
            raise AssertionError(
                f"flash_attention {dt} b{b} h{h} k{kv} s{s} d{d} causal="
                f"{causal} window={window} views={views}: max abs err {err} "
                f"> {tols[dt]}")
        return err

    worst = {dt: 0.0 for dt in tols}
    n = 0
    for dt in tols:
        for s in (1, 37, 130, 1000):
            for d in (8, 12, 16, 24, 40, 64, 128):
                for group in (1, 4):
                    for causal in (True, False):
                        for window in (None, 5, 100):
                            for views in (False, True):
                                worst[dt] = max(worst[dt], check(
                                    1, 2 * group, 2, s, d, causal, window,
                                    dt, views))
                                n += 1
    torch.cuda.synchronize()
    log(f"kernels: flash_attention within 2e-5 (f32) / 2e-2 (bf16) on {n} "
        f"ragged cases (S 1 to 1000, head dims 8 to 128, groups 1 and 4, "
        f"causal and not, windows none, 5, 100, contiguous and [B, S, H, D] "
        f"views): worst {worst[torch.float32]:.3e} / "
        f"{worst[torch.bfloat16]:.3e}")

    meg, mix = serve_config(), mixtral_config()
    shapes = [(f"{arch} {what}", batch, cfg.n_heads, cfg.n_kv_heads, s,
               cfg.resolved_head_dim, cfg.swa_window)
              for arch, cfg, what, batch, s in (
                  (ARCH, meg, "prefill", BATCH, PROMPT),
                  (MIX_ARCH, mix, "prefill", BATCH, MIX_PROMPT),
                  (MIX_ARCH, mix, "long prefill", 1, LONG_PROMPT))]
    entries = []
    for path, b, h, kv, s, d, w in shapes:
        for dt, views in ((torch.float32, False), (torch.bfloat16, False),
                          (torch.bfloat16, True)):
            err = check(b, h, kv, s, d, True, w, dt, views)
            worst[dt] = max(worst[dt], err)
            log(f"kernels: flash_attention at the {path} shape "
                f"[{b}, {h}, {s}, {d}] kv {kv} window {w} {dt}"
                f"{' on [B, S, H, D] views' if views else ''}: max abs err "
                f"{err:.3e}")
            free(torch)
        q, k, v = inputs(b, h, kv, s, d, torch.bfloat16)
        if w is not None and w < s:
            qi = torch.arange(s, device=dev)
            band = (qi[None, :] <= qi[:, None]) & (qi[None, :] > qi[:, None]
                                                   - w)
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=band, enable_gqa=True))
            del band
        else:
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        bound, by = attn_bound(b, h, kv, s, d, True, w, "bfloat16", 2)
        entry = {
            "path": path, "shape": f"q [{b}, {h}, {s}, {d}], kv heads {kv}, "
                                   f"causal, window {w}, bf16",
            "ms": cuda_ms(torch, lambda: flash_attention(
                q, k, v, causal=True, window=w)),
            "plain_ms": cuda_ms(torch, lambda: attention_ref(
                q, k, v, causal=True, window=w), runs=5, warmup=1),
            "library_ms": lib, "bound_ms": bound, "bound_by": by}
        entry["ratio_to_library"] = entry["ms"] / lib
        entry["ratio_to_bound"] = entry["ms"] / bound
        qv, kv_, vv = inputs(b, h, kv, s, d, torch.bfloat16, views=True)
        entry["ms_on_views"] = cuda_ms(torch, lambda: flash_attention(
            qv, kv_, vv, causal=True, window=w))
        del qv, kv_, vv
        entries.append(entry)
        log("timing: flash_attention", json.dumps(entry))
        if s == LONG_PROMPT:
            full = cuda_ms(torch, lambda: flash_attention(q, k, v,
                                                          causal=True))
            log(f"timing: flash_attention {path} without the window "
                f"(causal only): {full:.4f} ms against {entry['ms']:.4f} ms "
                f"with it; visible pairs {band_pairs(s, True, None)} against "
                f"{band_pairs(s, True, w)} (tiles outside the window are "
                f"skipped)")
        del q, k, v
        free(torch)
    main = entries[1]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces":
            "src/repro/kernels/flash_attention/flash_attention.py:122",
            "shape": main["shape"],
            "max_abs_err": max(worst.values()),
            "max_abs_err_f32": worst[torch.float32],
            "max_abs_err_bf16": worst[torch.bfloat16],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "library_ms": main["library_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "shapes": entries}


def adamw_args(count, lr=3e-4) -> dict:
    """``adamw_step``'s scalars at step ``count``, the bias corrections as
    ``optim.adamw_update`` computes them."""
    c = np.float32(count)
    return dict(ADAMW_CFG, lr=lr,
                bc1=float(np.float32(1) - np.float32(ADAMW_CFG["b1"]) ** c),
                bc2=float(np.float32(1) - np.float32(ADAMW_CFG["b2"]) ** c))


def adamw_leaves(torch, gen, dev, shapes, p_dtype, g_dtype):
    """Parameters, gradients and moments (v positive) of ``shapes``."""
    def randn(shape, scale, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)
    p = [randn(s, 0.02, p_dtype) for s in shapes]
    g = [randn(s, 1e-3, g_dtype) for s in shapes]
    m = [randn(s, 1e-3) for s in shapes]
    v = [torch.rand(s, generator=gen, device=dev) * 1e-6 for s in shapes]
    return p, g, m, v


def adamw_errs(torch, got, want):
    """f32: the largest difference over all leaves against the plain
    version's largest magnitude over all leaves; bf16: the largest
    difference in units of the bf16 spacing at the plain version's value."""
    if got[0].dtype == torch.bfloat16:
        worst = 0.0
        for a, b in zip(got, want):
            a, b = a.float(), b.float()
            ulp = torch.exp2(torch.floor(torch.log2(
                b.abs().clamp(min=torch.finfo(torch.float32).tiny))) - 7)
            worst = max(worst, ((a - b).abs() / ulp).max().item())
        return worst
    diff = max((a - b).abs().max().item() for a, b in zip(got, want))
    return diff / max(b.abs().max().item() for b in want)


def phase_adamw(torch):
    """AdamW's kernels against their plain versions: ragged leaves of every
    (parameter, gradient) dtype pair and megatron-moe-32e's training
    leaves, timed there beside their bounds, the plain versions and
    PyTorch's own multi-tensor calls (timed only as yardsticks); the norm
    bit-identical over two calls.  Returns the two kernels' result rows
    (their launches are the training runs', counted in ``main``)."""
    from repro_torch.kernels.adamw import (CAPACITY, adamw_step,
                                           adamw_step_ref, sq_norm,
                                           sq_norm_ref)

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = [(n,) for n in ADAMW_RAGGED]
    tables = -(-len(shapes) // CAPACITY)
    for p_dtype in (torch.float32, torch.bfloat16):
        for g_dtype in (torch.float32, torch.bfloat16):
            p, g, m, v = adamw_leaves(torch, gen, dev, shapes, p_dtype,
                                      g_dtype)
            sums = sq_norm(g)
            want = sq_norm_ref(g)
            err = ((sums - want).abs() / want.abs().clamp(min=1e-30)).max()
            if err.item() > 1e-5:
                raise AssertionError(f"sq_norm {g_dtype} on ragged leaves: "
                                     f"rel err {err.item()}")
            norm = torch.sqrt(sums.sum())
            for count, clip in ((1, 1.0), (2, None), (3, 1e-3)):
                ref = [[t.clone() for t in x] for x in (p, m, v)]
                before = adamw_step.launches
                adamw_step(p, g, m, v, **adamw_args(count), norm=norm,
                           clip_norm=clip)
                adamw_step_ref(ref[0], g, ref[1], ref[2],
                               **adamw_args(count), norm=norm, clip_norm=clip)
                torch.cuda.synchronize()
                if adamw_step.launches - before != tables:
                    raise AssertionError(
                        f"adamw_step: {adamw_step.launches - before} "
                        f"launches for {len(shapes)} leaves, want {tables}")
                errs = [adamw_errs(torch, a, b)
                        for a, b in zip((p, m, v), ref)]
                limit = 1.0 if p_dtype == torch.bfloat16 else 1e-6
                if errs[0] > limit or max(errs[1:]) > 1e-6:
                    raise AssertionError(
                        f"adamw_step {p_dtype} / {g_dtype} (clip {clip}, "
                        f"step {count}): p, m, v errors {errs}")
                del ref
            log(f"adamw: {p_dtype} masters, {g_dtype} gradients, "
                f"{len(shapes)} ragged leaves in {tables} launches: within "
                f"limits, norm rel err {err.item():.2e}")
            del p, g, m, v
    free(torch)

    # megatron-moe-32e's training leaves
    p, g, m, v = adamw_leaves(torch, gen, dev, ADAMW_SHAPES, torch.float32,
                              torch.float32)
    n = sum(t.numel() for t in p)
    shape = " ".join(str(list(s)) for s in ADAMW_SHAPES) + " f32"
    sums = sq_norm(g)
    again = sq_norm(g)
    if not torch.equal(sums.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"sq_norm differs between two calls: {sums} "
                             f"{again}")
    want = sq_norm_ref(g)
    norm_err = ((sums - want).abs() / want.abs()).max().item()
    if norm_err > 1e-5:
        raise AssertionError(f"sq_norm at the training leaves: rel err "
                             f"{norm_err}")
    norm = torch.sqrt(sums.sum())
    ref = [[t.clone() for t in x] for x in (p, m, v)]
    adamw_step(p, g, m, v, **adamw_args(1), norm=norm, clip_norm=1.0)
    adamw_step_ref(ref[0], g, ref[1], ref[2], **adamw_args(1), norm=norm,
                   clip_norm=1.0)
    errs = [adamw_errs(torch, a, b) for a, b in zip((p, m, v), ref)]
    if max(errs) > 1e-6:
        raise AssertionError(f"adamw_step at the training leaves: p, m, v "
                             f"errors {errs}")
    log(f"adamw: training leaves {shape}: norm bit-identical over two calls "
        f"(rel err {norm_err:.2e} to the plain sums), p, m, v errors {errs} "
        f"(clip scale {min(1.0, 1.0 / norm.item()):.4g})")
    del ref
    free(torch)

    steps = [torch.ones((), device=dev) for _ in p]
    hbm = hbm_bytes_per_s()
    rows = [{
        "name": "sq_norm", "shape": shape, "path": "megatron-moe-32e train",
        "ms": cuda_ms(torch, lambda: sq_norm(g)),
        "bound_ms": (4 * n + 4 * len(p)) / hbm * 1e3, "bound_by": "bytes",
        "plain_ms": cuda_ms(torch, lambda: sq_norm_ref(g), runs=5,
                            warmup=1),
        "library_ms": cuda_ms(torch, lambda: torch._foreach_norm(g)),
        "library": "torch._foreach_norm",
        "max_err": norm_err}, {
        "name": "adamw_step", "shape": shape, "path": "megatron-moe-32e train",
        "ms": cuda_ms(torch, lambda: adamw_step(
            p, g, m, v, **adamw_args(2), norm=norm, clip_norm=1.0)),
        "bound_ms": 28 * n / hbm * 1e3, "bound_by": "bytes",
        "plain_ms": cuda_ms(torch, lambda: adamw_step_ref(
            p, g, m, v, **adamw_args(2), norm=norm, clip_norm=1.0),
            runs=5, warmup=1),
        "library_ms": cuda_ms(torch, lambda: torch._fused_adamw_(
            p, g, m, v, [], steps, lr=3e-4, beta1=0.9, beta2=0.95,
            weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False)),
        "library": "torch._fused_adamw_",
        "max_err": max(errs)}]
    # the library's update on the port's bf16 state (bf16 masters, f32
    # gradients and moments), read and not gated
    mixed = [[torch.zeros(8, dtype=torch.bfloat16, device=dev)]] + [
        [torch.zeros(8, device=dev)] for _ in range(3)]
    try:
        torch._fused_adamw_(*mixed, [], steps[:1], lr=3e-4, beta1=0.9,
                            beta2=0.95, weight_decay=0.1, eps=1e-8,
                            amsgrad=False, maximize=False)
        torch.cuda.synchronize()
        rows[1]["library_mixed"] = "takes"
    except Exception as e:  # what the library says is the finding
        rows[1]["library_mixed"] = \
            f"refuses: {str(e).splitlines()[0][:160]}"
    log(f"adamw: torch._fused_adamw_ on bf16 masters with f32 gradients "
        f"and moments {rows[1]['library_mixed']}")
    for row in rows:
        row["ratio_to_bound"] = row["ms"] / row["bound_ms"]
        row["ratio_to_library"] = row["ms"] / row["library_ms"]
        log("timing: adamw", json.dumps(row))
    del p, g, m, v, steps, mixed
    free(torch)
    return rows


def phase_small_reference(torch):
    """A small f32 MoE layer: the island on a (2, 2, 1) mesh with the plan
    against the one-rank path, with a capacity that drops no token."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.registry import MoESpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import flash_plan, make_dist_context
    from repro_torch.models.moe import MoE, moe_apply

    cfg = dataclasses.replace(
        smoke_config(ARCH), compute_dtype="float32",
        moe=MoESpec(num_experts=4, top_k=2, capacity_factor=4.0))
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    moe = MoE(cfg, gen, torch.float32, dev)
    x = torch.randn((8, 16, cfg.d_model), generator=gen, device=dev) * 0.3
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), dev)
    dist = make_dist_context(cfg, mesh, "plan", flash_plan(2, 2, SEED))
    with torch.no_grad():
        y_loc, aux_loc = moe_apply(cfg, moe, x, None)
        y_mesh, _ = moe_apply(cfg, moe, x, dist)
    err = rel_err(torch, y_mesh, y_loc)
    if not (torch.isfinite(y_mesh).all() and err < 1e-4):
        raise AssertionError(f"f32 MoE island vs one-rank path: {err}")
    log(f"reference: f32 MoE island (plan, mesh 2x2x1) vs one-rank path "
        f"rel err {err:.3e}")


class RouteRecorder:
    """Records every MoE routing decision (the expert ids of each token's
    top-k, ``[G, T, k]`` sorted) while active; with ``margins``, also each
    token's gap between its k-th and (k+1)-th router logit over its largest
    logit's magnitude (``[G, T]``): how near a tie its decision was."""

    def __init__(self, margins=False):
        from repro_torch.models import moe
        self.moe, self.real, self.eids = moe, moe._route, []
        self.want_margins, self.margins = margins, []

    def __enter__(self):
        def spy(*args):
            out = self.real(*args)
            self.eids.append(out[1].sort(dim=-1).values)
            if self.want_margins:
                cfg, router_w, x_flat = args
                logits = x_flat.float() @ router_w
                top = logits.topk(cfg.moe.top_k + 1, dim=-1).values
                self.margins.append(
                    (top[..., -2] - top[..., -1])
                    / logits.abs().amax(-1).clamp(min=1e-30))
            return out
        self.moe._route = spy
        return self

    def __exit__(self, *exc):
        self.moe._route = self.real


def near_tie_flips(torch, oracle, routes, margins, batch):
    """Routing decisions of ``routes`` that differ from ``oracle``'s, and
    for each sequence the first layer where one does: (count, total, the
    largest oracle margin (``RouteRecorder(margins=True)``) among those
    first differences).  A first difference at a near tie is rounding
    (differently shaped products); the later ones of its sequence follow
    from it."""
    n_flip, worst = 0, 0.0
    differed = torch.zeros(batch, dtype=torch.bool)
    for a, b, m in zip(oracle, routes, margins):
        tok = (a.cpu() != b.cpu()).any(-1).reshape(batch, -1)
        n_flip += int(tok.sum())
        first = tok & ~differed[:, None]
        if first.any():
            worst = max(worst, float(m.cpu().reshape(batch, -1)[first]
                                     .max()))
        differed |= tok.any(-1)
    total = sum(a.shape[0] * a.shape[1] for a in oracle)
    return n_flip, total, worst


def near_tie_controls(torch, oracle, routes):
    """Two planted faults that phase 8's f32 routing gate must refuse, and
    how many of the oracle's decisions lie within ``NEAR_TIE`` (those a
    wrong route could flip unseen): ``routes`` with rank 0's and rank 1's
    rows swapped (a wrong batch offset), and the oracle's own routing with
    the decision at its median margin sent elsewhere."""
    b = PROC_BATCH // int(np.prod(PROC_MESH))
    swapped = []
    for e in routes:
        x = e.reshape(PROC_BATCH, -1, e.shape[-1]).clone()
        x[:b], x[b:2 * b] = x[b:2 * b].clone(), x[:b].clone()
        swapped.append(x.reshape(e.shape))
    m0 = oracle["margins"][0].cpu().reshape(-1)
    at = int(m0.argsort()[m0.numel() // 2])
    planted = [e.cpu().clone() for e in oracle["routes"]]
    flat = planted[0].reshape(-1, planted[0].shape[-1])
    flat[at, 0] = flat[at, 0] ^ 1
    ties = {name: near_tie_flips(torch, oracle["routes"], r,
                                 oracle["margins"], PROC_BATCH)[2]
            for name, r in (("rows swapped", swapped),
                            ("one decision at the median margin", planted))}
    margins = torch.cat([m.cpu().reshape(-1) for m in oracle["margins"]])
    within = int((margins <= NEAR_TIE).sum())
    log(f"procs[f32 controls]: the routing gate refuses "
        + "; ".join(f"{k} (first differences at margins up to {v:.3e})"
                    for k, v in ties.items())
        + f"; {within} of {margins.numel()} oracle decisions lie within "
        f"the near-tie limit {NEAR_TIE}")
    passed = [k for k, v in ties.items() if v <= NEAR_TIE]
    if passed:
        raise AssertionError(f"procs: the f32 routing gate passes planted "
                             f"faults {passed}")
    return {"first_difference_margin": ties, "decisions_within_limit":
            within, "decisions": int(margins.numel())}


def route_flips(torch, routes_a, routes_b, batch):
    """Routing decisions of two prefills that differ: (count, total, per
    layer, per sequence [B] bool).  Tokens are rank-major, which is
    sequence-major, so flat token ``j`` belongs to sequence ``j // S``."""
    if len(routes_a) != len(routes_b):
        raise AssertionError(f"recorded {len(routes_a)} and "
                             f"{len(routes_b)} routings")
    per_layer, per_seq = [], None
    for a, b in zip(routes_a, routes_b):
        tok = (a != b).any(-1).reshape(batch, -1)
        per_layer.append(int(tok.sum()))
        seq = tok.any(-1)
        per_seq = seq if per_seq is None else per_seq | seq
    total = sum(a.shape[0] * a.shape[1] for a in routes_a)
    return sum(per_layer), total, per_layer, per_seq


def reset_launches(kernels):
    for fn in kernels.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_variant"):
            fn.launches_by_variant = dict.fromkeys(fn.launches_by_variant, 0)


def read_launches(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def read_variants(kernels):
    """Launches by instance since the last reset, of each kernel that
    counts them (pack, unpack, grouped_matmul, flash_attention_bwd)."""
    return {name: dict(fn.launches_by_variant)
            for name, fn in kernels.items()
            if hasattr(fn, "launches_by_variant")}


def run_counts(run):
    """A run's launch counts by kernel and by instance."""
    return {"prefill": run["prefill_launches"],
            "decode": run["decode_launches"],
            "prefill_variants": run["prefill_variants"],
            "decode_variants": run["decode_variants"]}


# The pack and unpack instances of the serving runs, by part of the run:
# mixtral's prefill exchanges move 1280 MiB (bf16) and 640 MiB (int8 rows)
# and take bulk, its f32 scale rows and every decode exchange and all of
# megatron's vec.
MEGATRON_A2A = {"prefill": {"vec"}, "decode": {"vec"}}
MIXTRAL_A2A = {"prefill": {"bulk"}, "decode": {"vec"}}
MIXTRAL_INT8_A2A = {"prefill": {"bulk", "vec"}}


def check_variants(run, label, want="tma", a2a=None):
    """Every grouped_matmul launch of the run's prefill (and decode) went
    through instance ``want``; no pack or unpack launch through ``bytes``,
    and with ``a2a`` ({part: instances}) every one through those instances,
    each of them taken."""
    for part in ("prefill", "decode"):
        if f"{part}_variants" not in run:
            continue
        by_kernel, totals = run[f"{part}_variants"], run[f"{part}_launches"]
        by, total = by_kernel["grouped_matmul"], totals["grouped_matmul"]
        if not (total > 0 and by[want] == total):
            raise AssertionError(f"{label}: grouped_matmul's {part} launches "
                                 f"by instance {by}; expected all {total} "
                                 f"on {want!r}")
        allowed = (a2a or {}).get(part)
        for name in ("a2a_pack", "a2a_unpack"):
            by, total = by_kernel[name], totals[name]
            ok = by["bytes"] == 0 and (allowed is None or (
                total > 0 and sum(by[v] for v in allowed) == total
                and all(by[v] for v in allowed)))
            if not ok:
                raise AssertionError(
                    f"{label}: {name}'s {part} launches by instance {by}; "
                    f"expected {sorted(allowed) if allowed else 'none'} "
                    f"{'' if allowed else 'on bytes'}")


def serve(torch, cfg, params, mesh, impl, plan, prompts, kernels, *,
          use_kernel=True, decode=True, warmup=True, record=False,
          keep_logits=False, pick=None, extras=None):
    """Prefill (a warm-up, then timed) and greedy decode of GEN tokens
    through the serving step builders.  Returns logits, tokens, timings,
    launch counts (counts set to 0 just before the timed prefill and before
    decode), with ``record`` the timed prefill's routing decisions and with
    ``keep_logits`` every step's logits (the prefill's first).  ``pick``
    makes a step's tokens of its logits (default: their argmax; under TP
    ``tp_pick``, the argmax over the vocabulary shards).  ``extras`` joins
    the prompts in the batch (``patch_embeds``, ``frames``); an
    encoder-decoder's prefill is its serving's prompt pass (the encoder and
    cross K/V, then the decode step over the prompt)."""
    from repro_torch.launch.serve import (_encdec_prefill, make_prefill_step,
                                          make_serve_step)

    prompt = prompts.shape[1]
    total = prompt + GEN
    step = make_serve_step(cfg, mesh, impl, plan, use_kernel=use_kernel,
                           device=DEVICE)
    if cfg.encdec:
        def prefill(p, b):
            return _encdec_prefill(cfg, mesh, p, b, total, step)
    else:
        prefill = make_prefill_step(cfg, mesh, impl, plan, cache_len=total,
                                    use_kernel=use_kernel, device=DEVICE)
    batch = {"tokens": prompts, **(extras or {})}
    if warmup:
        prefill(params, batch)
    torch.cuda.synchronize()
    reset_launches(kernels)
    rec = RouteRecorder(margins=record == "margins")
    t0 = time.perf_counter()
    if record:
        with rec:
            logits, cache = prefill(params, batch)
    else:
        logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    res = {"logits": logits, "prefill_s": t_prefill, "routes": rec.eids,
           "margins": rec.margins,
           "prefill_launches": read_launches(kernels),
           "prefill_variants": read_variants(kernels),
           "cache_slots": cache[0]["k"].shape[1] if "k" in cache[0]
           else None}
    if not decode:
        return res
    pick = pick or (lambda lg: lg.argmax(-1))
    toks = pick(logits)
    out = [toks]
    kept = [logits]
    reset_launches(kernels)
    events = []
    t0 = time.perf_counter()
    for t in range(prompt, total - 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        lg, cache = step(params, cache, toks, t)
        toks = pick(lg)
        b.record()
        events.append((a, b))
        out.append(toks)
        if keep_logits:
            kept.append(lg)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in events]
    res.update(tokens=torch.stack(out, dim=1), decode_s=t_decode,
               decode_steps=GEN - 1, decode_launches=read_launches(kernels),
               decode_variants=read_variants(kernels),
               last_logits=lg, step_ms_median=statistics.median(step_ms),
               step_ms_max=max(step_ms))
    if keep_logits:
        res["step_logits"] = kept
    return res


def check_run(torch, run, cfg, batch, label, required, a2a=None,
              vocab=None):
    """Shape (``vocab`` columns, default the whole vocabulary) and
    finiteness of a run's logits; every kernel of ``required``
    launched in its prefill and decode, grouped_matmul on its TMA + wgmma
    instance alone, pack and unpack as ``check_variants`` asks,
    ``flash_attention`` once per layer per prefill and never in decode."""
    for t in (run["logits"], run["last_logits"]):
        if tuple(t.shape) != (batch, vocab or cfg.vocab) or \
                not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"{label}: bad logits {tuple(t.shape)}")
    pre, dec = run["prefill_launches"], run["decode_launches"]
    for name in required:
        if pre[name] <= 0:
            raise AssertionError(f"{label}: {name} never launched in the "
                                 f"prefill")
        if name != "flash_attention" and dec[name] <= 0:
            raise AssertionError(f"{label}: {name} never launched in decode")
    check_variants(run, label, a2a=a2a)
    if pre["flash_attention"] != cfg.n_layers or dec["flash_attention"]:
        raise AssertionError(
            f"{label}: flash_attention launched {pre['flash_attention']} "
            f"times in the prefill and {dec['flash_attention']} in decode; "
            f"expected {cfg.n_layers} and 0")


def log_run(run, label, batch):
    n_tok = batch * GEN
    tok_s = n_tok / (run["prefill_s"] + run["decode_s"])
    log(f"{label}: prefill {run['prefill_s'] * 1e3:.3f} ms; decode "
        f"{run['decode_s'] / run['decode_steps'] * 1e3:.3f} ms/step over "
        f"{run['decode_steps']} steps (median {run['step_ms_median']:.3f} "
        f"ms, max {run['step_ms_max']:.3f} ms on the device clock); "
        f"{tok_s:.1f} tokens/s ({n_tok} tokens); launches prefill "
        f"{run['prefill_launches']}, decode {run['decode_launches']}; "
        f"by instance: prefill {run['prefill_variants']}, decode "
        f"{run['decode_variants']}")


def plain_gates(torch, cfg, params, mesh, plan, prompts, run, kernels,
                label):
    """The plain versions against the kernels.  The full bf16 prefill is
    reported, not gated: the two round differently, so routers' near-ties
    flip from the first layer on (attention feeds it).  Gated: the first
    attention layer and the first MoE layer on identical bf16 inputs
    (within 2e-2, the MoE layer's routing equal)."""
    from repro_torch.launch.serve import make_dist_context
    from repro_torch.models.layers import attention_apply, norm_apply
    from repro_torch.models.moe import moe_apply
    from repro_torch.models.transformer import _embed_tokens, _window_args

    plain = serve(torch, cfg, params, mesh, "plan", plan, prompts, kernels,
                  use_kernel=False, decode=False, warmup=False, record=True)
    if any(plain["prefill_launches"].values()):
        raise AssertionError(f"{label}: use_kernel=False launched a kernel: "
                             f"{plain['prefill_launches']}")
    n_flip, n_dec, per_layer, per_seq = route_flips(
        torch, run["routes"], plain["routes"], prompts.shape[0])
    log(f"{label}[plain]: prefill {plain['prefill_s'] * 1e3:.3f} ms (no "
        f"warm-up); max rel logit diff kernels vs plain "
        f"{rel_err(torch, run['logits'], plain['logits']):.3e}; routing "
        f"differs in {n_flip} of {n_dec} (token, layer) decisions (per layer "
        f"{per_layer}), in {int(per_seq.sum())} of {prompts.shape[0]} "
        f"sequences")
    del plain

    blk = params.blocks[0]
    b, s = prompts.shape
    with torch.no_grad():
        x0 = _embed_tokens(cfg, params, prompts, None)
        h = norm_apply(cfg, blk.norm1, x0)
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x0.device).expand(b, s)
        window, use_window = _window_args(cfg, False)
        outs = [attention_apply(cfg, blk.attn, h, positions=positions,
                                window=window, use_window=use_window,
                                use_kernel=uk) for uk in (True, False)]
        attn_err = rel_err(torch, outs[0], outs[1])
        del outs, h
        h2 = norm_apply(cfg, blk.norm2, x0)
        dist = make_dist_context(cfg, mesh, "plan", plan)
        with RouteRecorder() as rec:
            ys = [moe_apply(cfg, blk.moe, h2, dist, use_kernel=uk)[0]
                  for uk in (True, False)]
    moe_err = rel_err(torch, ys[0], ys[1])
    same = torch.equal(rec.eids[0], rec.eids[1])
    log(f"{label}[plain]: first layer on identical bf16 inputs, kernels vs "
        f"plain: attention (window {window}) max rel diff {attn_err:.3e}; "
        f"MoE max rel diff {moe_err:.3e}, routing equal {same}")
    if not (attn_err < 2e-2 and moe_err < 2e-2 and same):
        raise AssertionError(f"{label}: first layer kernels vs plain: "
                             f"attention {attn_err}, MoE {moe_err}, routing "
                             f"equal {same}")
    del ys, h2, x0


def f32_gate(torch, cfg, mesh, plan, prompts, kernels, label):
    """The same prefill in f32 with fresh f32 weights from the seed: kernels
    against plain within a relative logit difference of 1e-4 (the f32
    serving tests' limit), no routing decision that differs."""
    from repro_torch.models import build_model

    dev = torch.device(DEVICE)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params32 = build_model(cfg32, dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    k32 = serve(torch, cfg32, params32, mesh, "plan", plan, prompts, kernels,
                decode=False, record=True)
    p32 = serve(torch, cfg32, params32, mesh, "plan", plan, prompts, kernels,
                use_kernel=False, decode=False, warmup=False, record=True)
    check_variants(k32, f"{label}[f32]", want="simt")
    n_flip, n_dec, per_layer, _ = route_flips(torch, k32["routes"],
                                              p32["routes"], prompts.shape[0])
    diff32 = rel_err(torch, k32["logits"], p32["logits"])
    log(f"{label}[f32]: prompt {prompts.shape[1]}: prefill kernels "
        f"{k32['prefill_s'] * 1e3:.3f} ms, plain {p32['prefill_s'] * 1e3:.3f} "
        f"ms (no warm-up); max rel logit diff {diff32:.3e}; routing differs in "
        f"{n_flip} of {n_dec} decisions (per layer {per_layer})")
    if n_flip or not diff32 < 1e-4:
        raise AssertionError(f"{label}: f32 kernel vs plain prefill: logits "
                             f"{diff32}, {n_flip} routing decisions differ")
    del params32, k32, p32
    free(torch)


def busy_us(intervals):
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def copy_durations(label, events, n_prefill):
    """Median device duration of the pack and unpack launches of a traced
    window, prefill and decode apart: ``events`` are the block-copy
    kernel's device events in start order, the first ``n_prefill`` of them
    the prefill's; each exchange launches pack, then unpack."""
    for part, evs in (("prefill", events[:n_prefill]),
                      ("decode", events[n_prefill:])):
        for kname, sub in (("a2a_pack", evs[0::2]), ("a2a_unpack", evs[1::2])):
            us = [e.time_range.elapsed_us() for e in sub]
            med = (f"{statistics.median(us) / 1e3:.4f} ms" if us
                   else "not measured")
            log(f"{label}: {kname} {part}: median device duration {med} "
                f"over {len(sub)} launches")


def device_time(prof, label, host_ms):
    """Log a trace's device time by kernel name (top 10) and the device's
    idle share over the window from the first device event's start to the
    last one's end.  Returns (device events, summary), the summary None and
    "not measured" logged where the trace holds no device event."""
    from torch.autograd import DeviceType

    # a profiler range (record_function) is traced on the device too, as
    # a span over the kernels it encloses: not a kernel
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not dev:
        log(f"{label}: device time by kernel: not measured (the trace holds "
            f"no device event); idle share: not measured; host window "
            f"{host_ms:.3f} ms")
        return dev, None
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    busy = busy_us(spans)
    by_name = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    total = sum(t for _, t in by_name.values())
    log(f"{label}: host window {host_ms:.3f} ms; device window "
        f"{window / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, idle share "
        f"{1 - busy / window:.4f}; {len(dev)} device events, "
        f"{total / 1e3:.3f} ms summed")
    for name, (n, t) in top:
        log(f"{label}: {t / 1e3:10.3f} ms {100 * t / total:6.2f}% {n:5d}x "
            f"{name[:110]}")
    return dev, {"idle_share": 1 - busy / window, "window_ms": window / 1e3,
                 "top": [(name, n, t / 1e3) for name, (n, t) in top]}


def profile_window(torch, cfg, params, mesh, plan, prompts, kernels,
                   steps=3):
    """One plan prefill and ``steps`` decode steps under torch.profiler:
    device time by kernel name (top 10), the device's idle share over the
    window from the first device event's start to the last one's end, and
    the median device duration of pack and unpack launches in the prefill
    and in decode.  Prints "not measured" where the trace holds no device
    event."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import _build
    from repro_torch.launch.serve import make_prefill_step, make_serve_step

    prompt = prompts.shape[1]
    prefill = make_prefill_step(cfg, mesh, "plan", plan,
                                cache_len=prompt + GEN)
    step = make_serve_step(cfg, mesh, "plan", plan)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n0 = kernels["a2a_pack"].launches + kernels["a2a_unpack"].launches
        logits, cache = prefill(params, {"tokens": prompts})
        n_prefill = (kernels["a2a_pack"].launches
                     + kernels["a2a_unpack"].launches - n0)
        toks = logits.argmax(-1)
        for t in range(prompt, prompt + steps):
            lg, cache = step(params, cache, toks, t)
            toks = lg.argmax(-1)
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    label = f"profile[mixtral plan, prefill + {steps} decode steps]"
    dev, summary = device_time(prof, label, host_ms)
    if summary is None:
        return None
    names = kernel_names(_build.CSRC / "a2a_block_copy.cu")
    copies = sorted((e for e in dev if any(k in e.name for k in names)),
                    key=lambda e: e.time_range.start)
    copy_durations(label, copies, n_prefill)
    return summary


def phase_megatron(torch, kernels):
    """megatron-moe-32e through the plan, direct and flash, then the gates
    against the plain versions.  Returns the plan run's launch counts."""
    from repro_torch.comm.plan_exec import lower_plan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import flash_plan
    from repro_torch.models import build_model

    cfg = serve_config()
    dev = torch.device(DEVICE)
    mesh = make_mesh(MESH, ("pod", "data", "model"), dev)
    plan = flash_plan(MESH[0], MESH[1], SEED)
    sched = lower_plan(plan, n_pods=MESH[0])
    params = build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)).to(dev)
    log(f"serve: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab} experts="
        f"{cfg.moe.num_experts} top{cfg.moe.top_k} layers={cfg.n_layers}/24 "
        f"mesh={MESH} batch={BATCH} prompt={PROMPT} gen={GEN}; plan "
        f"{sched.algorithm} n_plan_stages={sched.n_plan_stages} "
        f"n_fallback_stages={sched.n_fallback_stages}; params "
        f"{param_gb(params):.2f} GB")

    torch.cuda.reset_peak_memory_stats()
    run = serve(torch, cfg, params, mesh, "plan", plan, prompts, kernels,
                record=True)
    check_run(torch, run, cfg, BATCH, "serve[plan]", SERVE_KERNELS,
              MEGATRON_A2A)
    log_run(run, "serve[plan]", BATCH)
    log(f"serve[plan]: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # the exchange is pure data movement: direct and flash are bit-identical
    direct = serve(torch, cfg, params, mesh, "direct", None, prompts,
                   kernels)
    check_variants(direct, "serve[direct]")
    if not torch.equal(direct["logits"], run["logits"]):
        raise AssertionError("direct prefill logits differ from plan's")
    if not torch.equal(direct["tokens"], run["tokens"]):
        raise AssertionError("direct greedy tokens differ from plan's")
    log(f"serve[direct]: prefill logits bit-identical to plan, greedy "
        f"tokens equal; prefill {direct['prefill_s'] * 1e3:.3f} ms; decode "
        f"{direct['decode_s'] / direct['decode_steps'] * 1e3:.3f} ms/step "
        f"(median {direct['step_ms_median']:.3f} ms on the device clock)")
    del direct
    flash = serve(torch, cfg, params, mesh, "flash", None, prompts, kernels,
                  decode=False)
    check_variants(flash, "serve[flash]")
    if not torch.equal(flash["logits"], run["logits"]):
        raise AssertionError("flash prefill logits differ from plan's")
    log(f"serve[flash]: prefill logits bit-identical to plan; prefill "
        f"{flash['prefill_s'] * 1e3:.3f} ms")
    again = serve(torch, cfg, params, mesh, "plan", plan, prompts, kernels)
    check_variants(again, "serve[plan, again]", a2a=MEGATRON_A2A)
    log(f"serve[plan, again]: prefill {again['prefill_s'] * 1e3:.3f} ms; "
        f"decode {again['decode_s'] / again['decode_steps'] * 1e3:.3f} "
        f"ms/step (median {again['step_ms_median']:.3f} ms)")
    del flash, again

    plain_gates(torch, cfg, params, mesh, plan, prompts, run, kernels,
                "serve")
    launches = run_counts(run)
    del params, run
    free(torch)
    f32_gate(torch, cfg, mesh, plan, prompts, kernels, "serve")
    return launches


def phase_mixtral(torch, kernels):
    """mixtral-8x7b: (a) plan and flash, (b) int8 dispatch, (c) the long
    prompt, then the gates.  Returns the launch counts of (a)'s plan run
    and of (c)."""
    from repro_torch.comm.all_to_all import rotation_all_to_all
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import flash_plan, make_dist_context
    from repro_torch.models import build_model
    from repro_torch.models.layers import norm_apply
    from repro_torch.models.moe import _pod_ep_exchange, moe_apply
    from repro_torch.models.transformer import _embed_tokens

    cfg = mixtral_config()
    dev = torch.device(DEVICE)
    mesh = make_mesh(MESH, ("pod", "data", "model"), dev)
    plan = flash_plan(MESH[0], MESH[1], SEED)
    dist = make_dist_context(cfg, mesh)
    a2a = _pod_ep_exchange(cfg, dist, mesh.sub(dist.dp_axes), "pod", True)
    if dist.ep_axes != ("pod",) or a2a.func is not rotation_all_to_all:
        raise AssertionError(f"mixtral on {MESH}: EP axes {dist.ep_axes}, "
                             f"{cfg.a2a_impl!r} exchange {a2a}")
    t0 = time.perf_counter()
    params = build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    rng = np.random.default_rng(SEED)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (BATCH, MIX_PROMPT)).astype(np.int64)).to(dev)
    log(f"mixtral: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab} experts={cfg.moe.num_experts} top"
        f"{cfg.moe.top_k} window={cfg.swa_window} layers={cfg.n_layers}/32 "
        f"mesh={MESH} EP axes {dist.ep_axes} ({cfg.a2a_impl!r} resolves to "
        f"the rotation); params "
        f"{param_gb(params):.2f} GB, "
        f"initialised in {time.perf_counter() - t0:.1f} s")

    # (a) the plan, then the config's flash (the rotation schedule)
    torch.cuda.reset_peak_memory_stats()
    run = serve(torch, cfg, params, mesh, "plan", plan, prompts, kernels,
                record=True)
    check_run(torch, run, cfg, BATCH, "mixtral[plan]", SERVE_KERNELS,
              MIXTRAL_A2A)
    log_run(run, f"mixtral[plan] batch {BATCH} x prompt {MIX_PROMPT}", BATCH)
    log(f"mixtral[plan]: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    rot = serve(torch, cfg, params, mesh, "flash", None, prompts, kernels)
    check_run(torch, rot, cfg, BATCH, "mixtral[flash]",
              ("grouped_matmul", "flash_attention"))
    if not torch.equal(rot["logits"], run["logits"]):
        raise AssertionError("mixtral: flash (rotation) prefill logits "
                             "differ from plan's")
    if not torch.equal(rot["tokens"], run["tokens"]):
        raise AssertionError("mixtral: flash greedy tokens differ from "
                             "plan's")
    log_run(rot, "mixtral[flash]: prefill logits bit-identical to plan, "
            "greedy tokens equal", BATCH)
    del rot
    free(torch)
    profile_window(torch, cfg, params, mesh, plan, prompts, kernels)
    free(torch)

    # (b) int8 dispatch through the plan.  Gated where the reference's
    # test gates it, on one MoE layer (identical inputs); the prefill's
    # logits are reported: from the second layer on, routers' near-ties
    # flip under the int8 rounding, in every sequence of 1024 tokens.
    cfg_q = dataclasses.replace(cfg, quantized_dispatch=True)
    quant = serve(torch, cfg_q, params, mesh, "plan", plan, prompts, kernels,
                  decode=False, record=True)
    check_variants(quant, "mixtral[int8 dispatch]", a2a=MIXTRAL_INT8_A2A)
    n_flip, n_dec, per_layer, per_seq = route_flips(
        torch, run["routes"], quant["routes"], BATCH)
    q_err = rel_err(torch, quant["logits"], run["logits"])
    blk = params.blocks[0]
    with torch.no_grad():
        h2 = norm_apply(cfg, blk.norm2, _embed_tokens(cfg, params, prompts,
                                                      None))
        ys = [moe_apply(c, blk.moe, h2, make_dist_context(c, mesh, "plan",
                                                          plan))[0]
              for c in (cfg, cfg_q)]
    layer_err = rel_err(torch, ys[1], ys[0])
    del ys, h2
    log(f"mixtral[int8 dispatch]: prefill {quant['prefill_s'] * 1e3:.3f} ms, "
        f"launches {quant['prefill_launches']}, by instance "
        f"{quant['prefill_variants']}; first MoE layer on identical "
        f"inputs: max rel diff to exact {layer_err:.3e}; prefill logits: max "
        f"rel diff {q_err:.3e}; routing differs in {n_flip} of {n_dec} "
        f"decisions (per layer {per_layer}), in {int(per_seq.sum())} of "
        f"{BATCH} sequences")
    if not (0 < layer_err < 0.05 and q_err > 0):
        raise AssertionError(f"int8 dispatch: first MoE layer {layer_err}, "
                             f"prefill logits {q_err}")
    del quant

    plain_gates(torch, cfg, params, mesh, plan, prompts, run, kernels,
                "mixtral")
    launches = {"mixtral-8x7b plan": run_counts(run)}
    del run
    free(torch)

    # (c) one long prompt: B = 1 does not divide the 32 ranks, so the MoE
    # runs the local path; the prefill's window skips tiles and decode runs
    # on the ring cache
    prompt_long = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, LONG_PROMPT)).astype(np.int64)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    long = serve(torch, cfg, params, mesh, "plan", plan, prompt_long,
                 kernels)
    check_run(torch, long, cfg, 1, "mixtral[long]",
              ("grouped_matmul", "flash_attention"))
    if long["cache_slots"] != cfg.swa_window:
        raise AssertionError(f"mixtral[long]: decode cache of "
                             f"{long['cache_slots']} slots, expected the "
                             f"{cfg.swa_window}-slot ring")
    log_run(long, f"mixtral[long] 1 x prompt {LONG_PROMPT}, window "
            f"{cfg.swa_window}, ring cache of {long['cache_slots']} slots", 1)
    log(f"mixtral[long]: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    launches["mixtral-8x7b long"] = run_counts(long)
    del long, params
    free(torch)

    f32_gate(torch, cfg, mesh, plan, prompts[:, :F32_PROMPT], kernels,
             "mixtral")
    return launches


def attn_bwd_bound(b, h, kv, s, d, causal, window, dtype_name, elem):
    """(bound ms, what bounds it) of one flash_attention_bwd call: 10 * D
    operations per visible pair and head; q, o, dO, k, v and the f32 lse
    read once, dq, dk, dv written once."""
    return bound_of(roofline().attn_bwd_cost(b, h, kv, s, d, causal, window,
                                             elem), dtype_name)


def forced_bwd(q, k, v, o, lse, do, causal, window, name):
    """flash_attention_bwd through instance ``name`` itself, bypassing the
    wrapper's rule and counts."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        _bwd_call, _bwd_inputs)

    o, do, lse = _bwd_inputs(q, k, v, o, lse, do, window)
    return _bwd_call(q, k, v, o, lse, do, causal, window, name)


def phase_backward_kernels(torch):
    """The backward's kernels: flash_attention's lse and flash_attention_bwd
    against their plain versions on ragged shapes (bf16 through both
    instances, the rule's and simt forced; the rule's run twice,
    bit-identical), at the training shape and at mixtral's windowed shape,
    timed beside the simt instance, the plain version and SDPA's backward;
    then grouped_matmul's backward products at the training shapes, timed
    beside bmm.  Returns the flash_attention_bwd row and grouped_matmul's
    backward shape entries."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        attention_lse_ref, flash_attention, flash_attention_bwd,
        flash_attention_bwd_ref, rows_aligned, variant)
    from repro_torch.kernels.grouped_matmul import (
        grouped_matmul, grouped_matmul_ref)
    from repro_torch.models.moe import _capacity

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    tols = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    short = {torch.float32: "f32", torch.bfloat16: "bf16"}

    def inputs(b, h, kv, s, d, dt, views):
        if views:   # [B, S, H, D] memory seen as [B, H, S, D]
            return [torch.randn((b, s, n, d), generator=gen,
                                device=dev).to(dt).transpose(1, 2)
                    for n in (h, kv, kv, h)]
        return [torch.randn((b, n, s, d), generator=gen, device=dev).to(dt)
                for n in (h, kv, kv, h)]

    def check(b, h, kv, s, d, causal, window, dt, views):
        """{instance: backward err} and the lse max abs err: the backward's
        max abs difference over the largest reference gradient of the case
        (a gradient that cancels to ~0, dq and dk at S = 1, has no scale of
        its own), through the wrapper (the rule's instance, run twice and
        bit-identical) and, in bf16, through simt forced."""
        q, k, v, do = inputs(b, h, kv, s, d, dt, views)
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        _, lse_ref = attention_lse_ref(q, k, v, causal=causal, window=window)
        e_lse = max_abs(torch, lse, lse_ref)
        del lse_ref
        rule = variant(dt, d, rows_aligned(q, k, v, o, do))
        before = flash_attention_bwd.launches_by_variant[rule]
        got = {rule: flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                         window=window)}
        again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    window=window)
        took = flash_attention_bwd.launches_by_variant[rule] - before
        same = all(torch.equal(a, g) for a, g in zip(again, got[rule]))
        del again
        if dt == torch.bfloat16 and rule != "simt":
            got["simt"] = forced_bwd(q, k, v, o, lse, do, causal, window,
                                     "simt")
        ref = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                      window=window)
        scale = max(r.float().abs().max().item() for r in ref)
        errs = {name: max(max_abs(torch, g, r) for g, r in zip(out, ref))
                / (scale + 1e-30) for name, out in got.items()}
        finite = all(bool(torch.isfinite(g.float()).all())
                     for out in got.values() for g in out)
        if not (max(errs.values()) <= tols[dt] and e_lse <= 1e-4 and finite
                and same and took == 2):
            raise AssertionError(
                f"flash_attention_bwd {dt} b{b} h{h} k{kv} s{s} d{d} causal="
                f"{causal} window={window} views={views}: err {errs} > "
                f"{tols[dt]}, lse err {e_lse}, finite {finite}, run twice "
                f"bit-identical {same}, launches on {rule!r} {took} of 2")
        return errs, e_lse

    # the rule: bf16 rows TMA can address take wgmma, anything else simt
    x = torch.zeros((2, 8, 3, 64), dtype=torch.bfloat16, device=dev)
    rules = {"bf16 [B, S, H, D] view": variant(
                 x.dtype, 64, rows_aligned(x.transpose(1, 2))),
             "f32": variant(torch.float32, 64),
             "head dim 12": variant(x.dtype, 12),
             "base off 16 bytes": variant(
                 x.dtype, 8, rows_aligned(x[..., 1:9].transpose(1, 2)))}
    if list(rules.values()) != ["wgmma", "simt", "simt", "simt"]:
        raise AssertionError(f"flash_attention_bwd's instance rule: {rules}")
    del x

    worst = {"f32 simt": 0.0, "bf16 wgmma": 0.0, "bf16 simt": 0.0}
    e_lse = {dt: 0.0 for dt in tols}
    n = 0
    for dt in tols:
        for s in (1, 37, 130, 300):
            for d in (8, 16, 40, 64, 128):
                for group in (1, 4):
                    for causal in (True, False):
                        for window in (None, 5, 100):
                            errs, el = check(1, 2 * group, 2, s, d, causal,
                                             window, dt, views=n % 2 == 0)
                            for name, err in errs.items():
                                key = f"{short[dt]} {name}"
                                worst[key] = max(worst[key], err)
                            e_lse[dt] = max(e_lse[dt], el)
                            n += 1
    torch.cuda.synchronize()
    log(f"kernels: flash_attention_bwd within 1e-5 (f32) / 2e-2 (bf16) of "
        f"its plain version on {n} ragged cases (S 1 to 300, head dims 8 to "
        f"128, groups 1 and 4, causal and not, windows none, 5, 100, "
        f"contiguous and views), bf16 through wgmma (the rule's, run twice "
        f"bit-identical) and simt forced: worst "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f"; forward lse max abs err {e_lse[torch.float32]:.3e} / "
        f"{e_lse[torch.bfloat16]:.3e}")

    meg, mix = train_config(), mixtral_config()
    shapes = [("megatron-moe-32e train", TRAIN_BATCH, meg.n_heads,
               meg.n_kv_heads, TRAIN_SEQ, meg.resolved_head_dim, None),
              ("mixtral-8x7b long", 1, mix.n_heads, mix.n_kv_heads,
               LONG_PROMPT, mix.resolved_head_dim, mix.swa_window)]
    entries = []
    for path, b, h, kv, s, d, w in shapes:
        for dt in (torch.float32, torch.bfloat16):
            errs, el = check(b, h, kv, s, d, True, w, dt, views=True)
            for name, err in errs.items():
                key = f"{short[dt]} {name}"
                worst[key] = max(worst[key], err)
            e_lse[dt] = max(e_lse[dt], el)
            log(f"kernels: flash_attention_bwd at the {path} shape [{b}, "
                f"{h}, {s}, {d}] kv {kv} window {w} {dt}: err "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f" (the rule's run twice, bit-identical); lse max abs err "
                f"{el:.3e}")
            free(torch)
        q, k, v, do = inputs(b, h, kv, s, d, torch.bfloat16, True)
        o, lse = flash_attention(q, k, v, causal=True, window=w,
                                 return_lse=True)
        if variant(q.dtype, d, rows_aligned(q, k, v, o, do)) != "wgmma":
            raise AssertionError(f"flash_attention_bwd at the {path} shape "
                                 f"would not take wgmma")
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        if w is not None and w < s:
            qi = torch.arange(s, device=dev)
            mask = dict(attn_mask=(qi[None, :] <= qi[:, None])
                        & (qi[None, :] > qi[:, None] - w))
        else:
            mask = dict(is_causal=True)

        def sdpa():
            return F.scaled_dot_product_attention(qg, kg, vg,
                                                  enable_gqa=True, **mask)

        def sdpa_bwd():
            torch.autograd.grad(sdpa(), (qg, kg, vg), do)

        bound, by = attn_bwd_bound(b, h, kv, s, d, True, w, "bfloat16", 2)
        runs = TIMED_RUNS if s <= TRAIN_SEQ else 5
        entry = {
            "path": path, "shape": f"q [{b}, {h}, {s}, {d}], kv heads {kv}, "
                                   f"causal, window {w}, bf16",
            "ms": cuda_ms(torch, lambda: flash_attention_bwd(
                q, k, v, o, lse, do, causal=True, window=w), runs=runs),
            "instance": "wgmma",
            "simt_ms": cuda_ms(torch, lambda: forced_bwd(
                q, k, v, o, lse, do, True, w, "simt"), runs=5, warmup=1),
            "plain_ms": cuda_ms(torch, lambda: flash_attention_bwd_ref(
                q, k, v, o, lse, do, causal=True, window=w), runs=3,
                warmup=1),
            "library_ms": cuda_ms(torch, sdpa_bwd, runs=runs)
            - cuda_ms(torch, sdpa, runs=runs),
            "bound_ms": bound, "bound_by": by}
        entry["ratio_to_library"] = entry["ms"] / entry["library_ms"]
        entry["ratio_to_bound"] = entry["ms"] / bound
        entries.append(entry)
        log("timing: flash_attention_bwd", json.dumps(entry))
        del q, k, v, do, o, lse, qg, kg, vg, mask
        free(torch)
    main = entries[0]
    attn_row = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:"
                    "122 (forward only: the reference differentiates its "
                    "einsum attention)",
        "shape": main["shape"], "instance": "wgmma",
        "max_abs_err": max(worst.values()),
        "max_err_f32": worst["f32 simt"],
        "max_err_bf16": worst["bf16 wgmma"],
        "max_err_bf16_simt": worst["bf16 simt"],
        "lse_max_abs_err": max(e_lse.values()),
        "ms": main["ms"], "simt_ms": main["simt_ms"],
        "plain_ms": main["plain_ms"],
        "library_ms": main["library_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "shapes": entries}

    # grouped_matmul's backward products at the training island's shapes:
    # a group holds one expert's C rows from each of the 32 ranks
    cfg = train_config()
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    c = MESH[0] * MESH[1] * _capacity(
        cfg, TRAIN_BATCH // (MESH[0] * MESH[1]) * TRAIN_SEQ, e)
    bf16 = torch.bfloat16
    gmm_entries = []
    for kind, din, dout in (("gate/up", d, f), ("down", f, d)):
        x = torch.randn((e, c, din), generator=gen, device=dev).to(bf16)
        wt = (torch.randn((e, din, dout), generator=gen, device=dev)
              / din ** 0.5).to(bf16)
        dy = torch.randn((e, c, dout), generator=gen, device=dev).to(bf16)
        # what the autograd Function launches (an operand read transposed
        # in place), and the contiguous operands the copies would make
        products = (
            ("dX", lambda: grouped_matmul(dy, wt, transpose_w=True),
             lambda: (dy, wt.transpose(1, 2).contiguous())),
            ("dW", lambda: grouped_matmul(x, dy, transpose_x=True),
             lambda: (x.transpose(1, 2).contiguous(), dy)))
        for what, product, operands in products:
            a, bmat = operands()
            n_tma = grouped_matmul.launches_by_variant["tma"]
            y, ref = product(), grouped_matmul_ref(a, bmat)
            if grouped_matmul.launches_by_variant["tma"] != n_tma + 1:
                raise AssertionError(f"grouped_matmul's {what} of the {kind} "
                                     f"product did not take TMA + wgmma")
            err = rel_err(torch, y, ref)
            if not err < 2e-2:
                raise AssertionError(f"grouped_matmul {what} of the {kind} "
                                     f"product: rel err {err}")
            del y, ref
            bound, by = gmm_bound(a, bmat)
            entry = {
                "path": f"megatron-moe-32e train {kind} {what}",
                "shape": f"{list(a.shape)} @ {list(bmat.shape)} bf16",
                "ms": cuda_ms(torch, product),
                "contiguous_ms": cuda_ms(torch, lambda: grouped_matmul(
                    a, bmat)),
                "plain_ms": cuda_ms(torch, lambda: grouped_matmul_ref(
                    a, bmat), runs=5, warmup=1),
                "library_ms": cuda_ms(torch, lambda: torch.bmm(a, bmat)),
                "transpose_copy_ms": cuda_ms(torch, operands),
                "bound_ms": bound, "bound_by": by, "instance": "tma",
                "max_err": err}
            entry["ratio_to_library"] = entry["ms"] / entry["library_ms"]
            entry["ratio_to_bound"] = entry["ms"] / bound
            gmm_entries.append(entry)
            log("timing: grouped_matmul backward", json.dumps(entry))
            del a, bmat
            free(torch)
        del x, wt, dy
        free(torch)
    log("kernels: grouped_matmul's dX and dW products (an operand read "
        "transposed in place) within 2e-2 at the training shapes, all on "
        "TMA + wgmma")
    return attn_row, gmm_entries


def rel_norm(torch, a, b) -> float:
    """||a - b|| / ||b|| in f32."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / (b.norm() + 1e-30)).item()


def train_launches_per_step(n_layers):
    """Launches a training step must make, worked out from the code: under
    remat each layer's forward runs twice (attention once and the expert
    FFN's three products each time), the backward once (one attention
    backward, two products for each of the three expert products); AdamW's
    two kernels once each (megatron-moe-32e's 23 leaves share one dtype
    pair and fit one table)."""
    return {"flash_attention": 2 * n_layers,
            "flash_attention_bwd": n_layers,
            "grouped_matmul": (2 * 3 + 3 * 2) * n_layers,
            "a2a_pack": 0, "a2a_unpack": 0, "sq_norm": 1, "adamw_step": 1}


def train_batches(cfg, batch, seq, steps):
    from repro_torch.data import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=SEED), cfg)
    return [data.batch(i) for i in range(steps)]


def train_run(torch, cfg, mesh, batches, kernels, use_kernel=True,
              profile_extra=False):
    """TRAIN_STEPS AdamW steps (peak rate 3e-4 after one warm-up step) of
    fresh parameters from the seed, through ``make_train_step``; counts set
    to 0 just before each step and read just after.  Returns the metrics,
    step ms, launches and instances of each step, the launches of the whole
    run, and the peak device memory."""
    from repro_torch.launch.train import (TrainOptions, init_train_state,
                                          make_train_step)
    from repro_torch.models import build_model

    dev = torch.device(DEVICE)
    params = build_model(cfg, dev, train=True).init(
        torch.Generator(device=dev).manual_seed(SEED))
    state = init_train_state(params)
    step = make_train_step(cfg, mesh, TrainOptions(
        peak_lr=3e-4, warmup_steps=1, total_steps=len(batches)),
        use_kernel=use_kernel, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"metrics": [], "step_ms": [], "launches": [], "variants": []}
    total = dict.fromkeys(kernels, 0)
    for batch in batches:
        reset_launches(kernels)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["launches"].append(read_launches(kernels))
        out["variants"].append(read_variants(kernels))
        for k, n in out["launches"][-1].items():
            total[k] += n
    out["total_launches"] = total
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if profile_extra:
        out["profile"] = profile_train_step(torch, step, state, batches[-1])
    del state, params, step
    free(torch)
    return out


def profile_train_step(torch, step, state, batch):
    """One more training step under torch.profiler: device time by kernel
    name (top 10), the device's idle share over the window, and the
    attention backward's kernels' device time and share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    label = "profile[train step]"
    dev, summary = device_time(prof, label, host_ms)
    if summary is not None:
        bwd = [e.time_range.elapsed_us() for e in dev if "bwd_" in e.name]
        total = sum(e.time_range.elapsed_us() for e in dev)
        summary["attention_bwd_ms"] = sum(bwd) / 1e3
        summary["attention_bwd_share"] = sum(bwd) / total
        log(f"{label}: flash_attention_bwd's kernels {sum(bwd) / 1e3:.3f} ms "
            f"({100 * sum(bwd) / total:.2f}% of the device time), "
            f"{len(bwd)} kernel launches")
    return summary


def check_train_launches(run, n_layers, label):
    """Every step's launches as ``train_launches_per_step`` says, every
    grouped_matmul launch on TMA + wgmma and every attention backward on
    its wgmma instance."""
    want = train_launches_per_step(n_layers)
    for i, (got, by) in enumerate(zip(run["launches"], run["variants"])):
        bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        if bad:
            raise AssertionError(f"{label} step {i}: launches (got, "
                                 f"expected) {bad}")
        for name, inst in (("grouped_matmul", "tma"),
                           ("flash_attention_bwd", "wgmma")):
            if by[name][inst] != want[name]:
                raise AssertionError(f"{label} step {i}: {name} by "
                                     f"instance {by[name]}")


def layer_grads(torch, cfg, blk, fn, x, dy):
    """(output, gradients of the input and of every parameter of ``blk``)
    of ``fn(x)`` against the cotangent ``dy``; ``fn`` returns (y, aux) or
    y, and aux enters the loss as the model's does."""
    x = x.detach().requires_grad_()
    out = fn(x)
    y, aux = out if isinstance(out, tuple) else (out, None)
    loss = (y.float() * dy.float()).sum()
    if aux is not None:
        loss = loss + 0.01 * aux
    names = [n for n, _ in blk.named_parameters()]
    grads = torch.autograd.grad(loss, [x] + [p for _, p in
                                             blk.named_parameters()])
    return y.detach(), dict(zip(["input"] + names, grads))


def train_layer_gates(torch, mesh, kernels):
    """On one layer of fresh bf16-compute parameters and the cell's first
    batch: the first attention and MoE layer's outputs and gradients with
    the kernels against plain on identical inputs (relative norm 2e-2,
    routing equal), and the layer's forward run twice bit-identical (what
    remat recomputes)."""
    from repro_torch.launch.train import make_dist_context
    from repro_torch.models import build_model
    from repro_torch.models.layers import attention_apply, norm_apply
    from repro_torch.models.moe import moe_apply
    from repro_torch.models.transformer import _block_train, _embed_tokens

    dev = torch.device(DEVICE)
    cfg = train_config(n_layers=1)
    params = build_model(cfg, dev, train=True).init(
        torch.Generator(device=dev).manual_seed(SEED))
    batch = train_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 1)[0]
    tokens = torch.from_numpy(batch["tokens"]).long().to(dev)
    b, s = tokens.shape
    blk = params.blocks[0]
    dist = make_dist_context(cfg, mesh)
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    with torch.no_grad():
        x0 = _embed_tokens(cfg, params, tokens, None)
        h = norm_apply(cfg, blk.norm1, x0)
        h2 = norm_apply(cfg, blk.norm2, x0)
    dy = torch.randn(x0.shape, generator=gen, device=dev).to(x0.dtype)
    worst = {}
    for name, sub, fn_of, x in (
            ("attention", blk.attn, lambda uk: lambda t: attention_apply(
                cfg, blk.attn, t, positions=positions, use_kernel=uk), h),
            ("moe", blk.moe, lambda uk: lambda t: moe_apply(
                cfg, blk.moe, t, dist, use_kernel=uk), h2)):
        with RouteRecorder() as rec:
            runs = [layer_grads(torch, cfg, sub, fn_of(uk), x, dy)
                    for uk in (True, False)]
        (y_k, g_k), (y_p, g_p) = runs
        errs = {"output": rel_norm(torch, y_k, y_p)}
        errs.update({k: rel_norm(torch, g_k[k], g_p[k]) for k in g_k})
        same = name != "moe" or torch.equal(rec.eids[0], rec.eids[-1])
        log(f"train[identical inputs]: first {name} layer, bf16, kernels vs "
            f"plain, relative norms: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + (f"; routing equal {same}" if name == "moe" else ""))
        if not (max(errs.values()) < 2e-2 and same):
            raise AssertionError(f"train: first {name} layer kernels vs "
                                 f"plain: {errs}, routing equal {same}")
        worst[name] = max(errs.values())
        del runs, y_k, g_k, y_p, g_p
        free(torch)

    # remat runs each layer's forward again in the backward: the kernels'
    # forward must give the same bits, routing included
    with RouteRecorder() as rec:
        outs = [_block_train(cfg, blk, x0.detach().requires_grad_(),
                             positions=positions, dist=dist, kind="moe",
                             full_flag=False, use_kernel=True)
                for _ in range(2)]
    same = torch.equal(outs[0][0], outs[1][0]) and \
        torch.equal(outs[0][1], outs[1][1]) and \
        torch.equal(rec.eids[0], rec.eids[1])
    log(f"train[remat]: one layer's forward with the kernels run twice: "
        f"bit-identical {same}")
    if not same:
        raise AssertionError("train: the layer's forward is not "
                             "bit-identical when run again")
    del outs, params, x0, h, h2, dy
    free(torch)
    return worst


def train_f32_gate(torch, mesh, kernels):
    """An f32 step's gradients (1 layer, TRAIN_BATCH x F32_TRAIN_SEQ tokens)
    with the kernels against the plain versions, every parameter within a
    relative norm of 1e-4; returns the worst."""
    from repro_torch.launch.train import _on, make_dist_context
    from repro_torch.models import build_model

    dev = torch.device(DEVICE)
    cfg = train_config(n_layers=1, compute_dtype="float32")
    model = build_model(cfg, dev, train=True)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    batch = _on(dev, train_batches(cfg, TRAIN_BATCH, F32_TRAIN_SEQ, 1)[0])
    named = dict(params.named_parameters())
    grads, losses = [], []
    for uk in (True, False):
        dist = make_dist_context(cfg, mesh, use_kernel=uk)
        reset_launches(kernels)
        loss, _ = model.loss(params, batch, dist, uk)
        grads.append(torch.autograd.grad(loss, list(named.values())))
        losses.append(loss.item())
        if uk and not (kernels["flash_attention_bwd"].launches == 1 and
                       kernels["grouped_matmul"].launches == 12):
            raise AssertionError(f"train[f32]: launches "
                                 f"{read_launches(kernels)}")
    errs = {k: rel_norm(torch, a, b)
            for k, a, b in zip(named, grads[0], grads[1])}
    worst = max(errs, key=errs.get)
    log(f"train[f32]: 1 layer, {TRAIN_BATCH} x {F32_TRAIN_SEQ} tokens: loss "
        f"kernels {losses[0]:.6f}, plain {losses[1]:.6f}; gradients, "
        f"relative norm, worst {errs[worst]:.3e} ({worst}); "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if not errs[worst] < 1e-4:
        raise AssertionError(f"train[f32]: gradient {worst} kernels vs "
                             f"plain {errs[worst]}")
    del grads, params, model
    free(torch)
    return errs[worst]


def train_resume_gate(torch):
    """The Trainer at smoke size on the card: 6 steps unbroken, and 3 steps,
    a checkpoint and a resume to 6; parameters within a relative 1e-6
    (each tensor's largest value) of the unbroken run's."""
    import tempfile

    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import (TrainOptions, init_train_state,
                                          make_train_step)
    from repro_torch.models import build_model
    from repro_torch.runtime import Trainer, TrainerConfig

    dev = torch.device(DEVICE)
    cfg = smoke_config(ARCH)
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), dev)
    step = make_train_step(cfg, mesh, TrainOptions(
        peak_lr=5e-3, warmup_steps=2, total_steps=6))
    model = build_model(cfg, dev, train=True)
    batches = train_batches(cfg, 8, 32, 6)

    def init_state():
        return init_train_state(model.init(
            torch.Generator(device=dev).manual_seed(SEED)))

    with tempfile.TemporaryDirectory() as root:
        a = Trainer(TrainerConfig(total_steps=6, ckpt_dir=f"{root}/a",
                                  ckpt_every=100), step, init_state,
                    batches.__getitem__).run()
        Trainer(TrainerConfig(total_steps=3, ckpt_dir=f"{root}/b",
                              ckpt_every=3), step, init_state,
                batches.__getitem__).run()
        b = Trainer(TrainerConfig(total_steps=6, ckpt_dir=f"{root}/b",
                                  ckpt_every=100), step, init_state,
                    batches.__getitem__).run()
    errs = {k: ((p - q).abs().max() / q.abs().max()).item()
            for (k, p), (_, q) in zip(
                b["state"]["params"].named_parameters(),
                a["state"]["params"].named_parameters())}
    worst = max(errs, key=errs.get)
    n_equal = sum(v == 0 for v in errs.values())
    log(f"train[trainer]: smoke {cfg.name} on (2, 2, 1), 6 steps against 3 "
        f"+ checkpoint + resume 3: stopped at {b['stopped_at']}; parameters "
        f"bit-identical in {n_equal} of {len(errs)} tensors, worst relative "
        f"difference {errs[worst]:.3e} ({worst}); loss {a['metrics']['loss']:.6f}"
        f" and {b['metrics']['loss']:.6f}")
    if b["stopped_at"] != 6 or int(b["state"]["step"]) != 6 \
            or not errs[worst] <= 1e-6:
        raise AssertionError(f"train[trainer]: resume differs: {errs[worst]}")
    return errs[worst]


def phase_training(torch, kernels):
    """megatron-moe-32e trained at full width (the cell), then the gates.
    Returns the kernel run's launches over its TRAIN_STEPS steps and a
    summary."""
    from repro_torch.launch.mesh import make_mesh

    dev = torch.device(DEVICE)
    cfg = train_config()
    mesh = make_mesh(MESH, ("pod", "data", "model"), dev)
    batches = train_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS)
    log(f"train: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab} experts="
        f"{cfg.moe.num_experts} top{cfg.moe.top_k} layers={cfg.n_layers}/24 "
        f"mesh={MESH} batch={TRAIN_BATCH} seq={TRAIN_SEQ} steps="
        f"{TRAIN_STEPS}; {cfg.param_dtype} masters, {cfg.compute_dtype} "
        f"compute, remat={cfg.remat}, exchange {cfg.a2a_impl!r}")
    run = train_run(torch, cfg, mesh, batches, kernels, profile_extra=True)
    check_train_launches(run, cfg.n_layers, "train[kernels]")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = statistics.median(run["step_ms"][1:])
    for i, (m, ms) in enumerate(zip(run["metrics"], run["step_ms"])):
        log(f"train[kernels] step {i}: {ms:.3f} ms ({tokens / ms * 1e3:.1f} "
            f"tokens/s); " + ", ".join(f"{k} {v:.6f}" for k, v in m.items())
            + f"; launches {run['launches'][i]}")
    log(f"train[kernels]: steady step {steady:.3f} ms (median of steps 1 to "
        f"{TRAIN_STEPS - 1}), {tokens / steady * 1e3:.1f} tokens/s; peak "
        f"device memory {run['peak_gb']:.2f} GB; launches over the run "
        f"{run['total_launches']}")
    plain = train_run(torch, cfg, mesh, batches, kernels, use_kernel=False)
    if any(any(n.values()) for n in plain["launches"]):
        raise AssertionError(f"train[plain]: use_kernel=False launched a "
                             f"kernel: {plain['launches']}")
    diffs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
             for a, b in zip(run["metrics"], plain["metrics"])]
    log(f"train[plain]: step ms {[round(x, 3) for x in plain['step_ms']]}; "
        f"peak device memory {plain['peak_gb']:.2f} GB; step losses "
        f"kernels {[round(m['loss'], 6) for m in run['metrics']]}, plain "
        f"{[round(m['loss'], 6) for m in plain['metrics']]}; relative "
        f"differences {[f'{d:.3e}' for d in diffs]}")
    if not max(diffs) < 2e-2:
        raise AssertionError(f"train: step losses kernels vs plain {diffs}")
    by_instance = {name: {inst: sum(v[name][inst] for v in run["variants"])
                          for inst in run["variants"][0][name]}
                   for name in run["variants"][0]}
    summary = {"step_ms": steady, "tokens_per_s": tokens / steady * 1e3,
               "peak_gb": run["peak_gb"], "loss_diffs": diffs,
               "launches_by_variant": by_instance,
               "profile": run.get("profile")}
    summary["layers"] = train_layer_gates(torch, mesh, kernels)
    summary["f32_grad_err"] = train_f32_gate(torch, mesh, kernels)
    summary["resume_err"] = train_resume_gate(torch)
    return run["total_launches"], summary


# -- 7. the recurrent, hybrid and encoder-decoder stacks -----------------------

EXPERT_KERNELS = ("a2a_pack", "a2a_unpack", "grouped_matmul")


def stack_params(torch, cfg, train=False):
    """Fresh parameters from the seed on the device."""
    from repro_torch.models import build_model

    dev = torch.device(DEVICE)
    return build_model(cfg, dev, train=train).init(
        torch.Generator(device=dev).manual_seed(SEED))


def stack_prompts(torch, cfg, batch, prompt, seed=SEED):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt))
                            .astype(np.int64)).to(DEVICE)


def param_gb(params):
    return sum(t.numel() * t.element_size()
               for t in params.parameters()) / 1e9


def attn_counts(*parts, names=("flash_attention", "flash_attention_bwd")):
    """The launches of kernels ``names`` (default the attention kernels) of
    (name, launches dict) parts."""
    return {k: {part: counts[k] for part, counts in parts} for k in names}


def check_stack_launches(label, counts, want_attn, want_bwd=0):
    """``want_attn`` flash_attention launches, ``want_bwd`` attention
    backward ones and no expert kernel (none of the three stacks has
    experts)."""
    bad = {k: counts[k] for k in EXPERT_KERNELS if counts[k]}
    if counts["flash_attention"] != want_attn or bad or \
            counts["flash_attention_bwd"] != want_bwd:
        raise AssertionError(f"{label}: launches {counts}; expected "
                             f"{want_attn} flash_attention, {want_bwd} "
                             f"flash_attention_bwd and nothing else")


def check_stack_run(torch, run, cfg, batch, label, prefill_attn,
                    vocab=None):
    """Finite logits of the right shape (``vocab`` columns, default the
    whole vocabulary), ``prefill_attn`` flash_attention launches in the
    prefill and none in decode, nothing else launched."""
    for t in (run["logits"], run["last_logits"]):
        if tuple(t.shape) != (batch, vocab or cfg.vocab) or \
                not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"{label}: bad logits {tuple(t.shape)}")
    check_stack_launches(f"{label} prefill", run["prefill_launches"],
                         prefill_attn)
    check_stack_launches(f"{label} decode", run["decode_launches"], 0)


def run_summary(run, batch, peak_gb):
    """A serving run's numbers as ``log_run`` prints them."""
    return {"prefill_ms": run["prefill_s"] * 1e3,
            "decode_ms_per_step": run["decode_s"] / run["decode_steps"] * 1e3,
            "decode_ms_median_device": run["step_ms_median"],
            "tokens_per_s": batch * GEN / (run["prefill_s"]
                                           + run["decode_s"]),
            "peak_gb": peak_gb}


def chain_gate(torch, cfg, prompts, label):
    """In f32 with fresh f32 weights: the prefill's recurrent states and
    outputs against teacher-forced decode chains over the same prompt from
    the zero state.  Gated layer by layer on identical inputs (each layer's
    input in the prefill): the layer's final state and last output within a
    relative 1e-4 of its chain's.  Reported: the whole stack's chain
    against its prefill, where the rounding of the prompt pass's and
    decode's differently shaped products grows through the recurrences and
    the layers (the reference's own f32 chain drifts from its prefill as
    well)."""
    from repro_torch.models import build_model
    from repro_torch.models.transformer import (_block_decode, _block_prefill,
                                                _embed_tokens, layer_kinds)

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model = build_model(cfg32, torch.device(DEVICE))
    params = stack_params(torch, cfg32)
    b, s = prompts.shape
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": prompts},
                                      cache_len=s)
        chain = model.init_cache(b, s)
        for t in range(s):
            last, chain = model.decode_step(params, chain, prompts[:, t], t)
        stack = {"logits": rel_err(torch, last, logits)}
        for i, (a, c) in enumerate(zip(cache, chain)):
            for key, st in a["state"].items():
                stack[f"layer {i} {key}"] = rel_err(torch, c["state"][key],
                                                    st)
        del cache, chain
        x = _embed_tokens(cfg32, params, prompts, None)
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        errs = {}
        for i, (kind, blk) in enumerate(zip(layer_kinds(cfg32),
                                            params.blocks)):
            y, _, entry = _block_prefill(
                cfg32, blk, x, positions=positions, dist=None, kind=kind,
                full_flag=False, cache_len=s, use_kernel=True)
            step = model.init_cache(b, 1)[i]
            for t in range(s):
                y_t = _block_decode(cfg32, blk, step, x[:, t:t + 1], t,
                                    kind=kind, full_flag=False, dist=None,
                                    use_kernel=True)
            errs[f"layer {i} output"] = rel_err(torch, y_t[:, 0], y[:, -1])
            for key, st in entry["state"].items():
                errs[f"layer {i} {key}"] = rel_err(torch, step["state"][key],
                                                   st)
            x = y
    worst = max(errs, key=errs.get)
    stack_worst = max(stack, key=stack.get)
    log(f"{label}[f32 chain]: {b} x {s} tokens, each layer on identical "
        f"inputs: prefill against a teacher-forced decode chain, "
        f"{len(errs)} states and last outputs: worst relative difference "
        f"{errs[worst]:.3e} ({worst}); the whole stack (reported): last "
        f"logits {stack['logits']:.3e}, worst state {stack[stack_worst]:.3e} "
        f"({stack_worst})")
    if not errs[worst] < 1e-4:
        raise AssertionError(f"{label}: prefill vs decode chain {worst} "
                             f"{errs[worst]}")
    del params
    free(torch)
    return {"layer_worst": errs[worst], "stack_logits": stack["logits"],
            "stack_worst_state": stack[stack_worst]}


def scan_share(prof, label):
    """The ``ssm_scan`` ranges (the recurrences' time loops) in a traced
    window: their host time against the window's, and the device time of
    the kernels launched inside them against all kernels'."""
    import bisect

    from torch.autograd import DeviceType

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    scans = sorted((e.time_range.start, e.time_range.end) for e in cpu
                   if e.name == "ssm_scan")
    window = (max(e.time_range.end for e in cpu)
              - min(e.time_range.start for e in cpu))
    host_scan = busy_us(scans)
    starts = [a for a, _ in scans]
    in_scan = total = 0.0
    for e in cpu:
        if not e.kernels:
            continue
        dur = sum(k.duration for k in e.kernels)
        total += dur
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start <= scans[i][1]:
            in_scan += dur
    out = {"scans": len(scans), "host_scan_ms": host_scan / 1e3,
           "host_window_ms": window / 1e3,
           "host_share": host_scan / window if window else None,
           "device_scan_ms": in_scan / 1e3 if total else None,
           "device_ms": total / 1e3 if total else None,
           "device_share": in_scan / total if total else None}
    dev = (f"kernels launched inside them {in_scan / 1e3:.3f} ms of "
           f"{total / 1e3:.3f} ms of kernel time ({in_scan / total:.4f})"
           if total else "their device time: not measured (no kernel "
           "linked to a host op)")
    log(f"{label}: {len(scans)} scan loops (ssm_scan) take "
        f"{host_scan / 1e3:.3f} ms of the {window / 1e3:.3f} ms host window "
        f"({out['host_share']:.4f}, profiler overhead included); {dev}")
    return out


def profile_stack_prefill(torch, cfg, params, prompts, label):
    """One prefill under torch.profiler: device time by kernel name, the
    device's idle share and the scan loops' share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import make_prefill_step

    prefill = make_prefill_step(cfg, None, cache_len=prompts.shape[1] + GEN,
                                device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    _, summary = device_time(prof, label, host_ms)
    summary = dict(summary or {}, scan=scan_share(prof, label))
    del prof
    return summary


def phase_xlstm(torch, kernels):
    """xlstm-125m served at its published config; its f32 chain gate."""
    cfg = stack_config(XLSTM_ARCH)
    params = stack_params(torch, cfg)
    prompts = stack_prompts(torch, cfg, STACK_BATCH, STACK_PROMPT)
    log(f"xlstm: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} "
        f"(head dim {cfg.d_model // cfg.n_heads}) vocab={cfg.vocab} "
        f"layers={cfg.n_layers} pattern {''.join(cfg.block_pattern)}; "
        f"batch={STACK_BATCH} prompt={STACK_PROMPT} gen={GEN}; params "
        f"{param_gb(params):.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    run = serve(torch, cfg, params, None, None, None, prompts, kernels,
                warmup=False)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_stack_run(torch, run, cfg, STACK_BATCH, "xlstm", 0)
    log_run(run, f"xlstm batch {STACK_BATCH} x prompt {STACK_PROMPT} (no "
            f"warm-up)", STACK_BATCH)
    log(f"xlstm: peak device memory {peak:.2f} GB")
    summary = run_summary(run, STACK_BATCH, peak)
    counts = attn_counts(("prefill", run["prefill_launches"]),
                         ("decode", run["decode_launches"]))
    del params, run
    free(torch)
    summary["chain_err"] = chain_gate(
        torch, cfg, prompts[:STACK_GATE_BATCH, :STACK_GATE_PROMPT], "xlstm")
    return {f"{XLSTM_ARCH} serve": counts}, summary


def phase_hymba(torch, kernels):
    """hymba-1.5b served at its published config (scanned: full-size
    caches, no window in the prefill); a profiled prefill; the first hybrid
    layer against the plain attention on identical bf16 inputs; the f32
    prefill at HYMBA_F32_LAYERS layers against the plain versions."""
    from repro_torch.models.layers import attention_apply, norm_apply
    from repro_torch.models.transformer import _block_train, _embed_tokens

    cfg = stack_config(HYMBA_ARCH)
    params = stack_params(torch, cfg)
    prompts = stack_prompts(torch, cfg, STACK_BATCH, STACK_PROMPT)
    log(f"hymba: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
        f"ssm_state={cfg.ssm_state} window={cfg.swa_window} full layers "
        f"{cfg.full_attn_layers} vocab={cfg.vocab} layers={cfg.n_layers} "
        f"scan_layers={cfg.scan_layers}; batch={STACK_BATCH} "
        f"prompt={STACK_PROMPT} gen={GEN}; params {param_gb(params):.2f} GB "
        f"({sum(t.numel() for t in params.parameters()) / 1e9:.3f} B; "
        f"n_params() {cfg.n_params() / 1e9:.3f} B)")
    torch.cuda.reset_peak_memory_stats()
    run = serve(torch, cfg, params, None, None, None, prompts, kernels,
                warmup=False)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_stack_run(torch, run, cfg, STACK_BATCH, "hymba", cfg.n_layers)
    if run["cache_slots"] != STACK_PROMPT + GEN:
        raise AssertionError(f"hymba: {run['cache_slots']} cache slots; the "
                             f"scanned stack keeps full-size caches")
    log_run(run, f"hymba batch {STACK_BATCH} x prompt {STACK_PROMPT} (no "
            f"warm-up)", STACK_BATCH)
    log(f"hymba: peak device memory {peak:.2f} GB")
    summary = run_summary(run, STACK_BATCH, peak)
    counts = attn_counts(("prefill", run["prefill_launches"]),
                         ("decode", run["decode_launches"]))
    del run
    free(torch)
    summary["profile"] = profile_stack_prefill(
        torch, cfg, params, prompts, f"profile[hymba prefill {STACK_BATCH} "
        f"x {STACK_PROMPT}]")
    free(torch)

    # the first hybrid layer on identical bf16 inputs: only its attention
    # differs between the two runs
    blk = params.blocks[0]
    b, s = prompts.shape
    full = 0 in cfg.full_attn_layers
    with torch.no_grad():
        x0 = _embed_tokens(cfg, params, prompts, None)
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x0.device).expand(b, s)
        h = norm_apply(cfg, blk.norm1, x0)
        attn = [attention_apply(cfg, blk.attn, h, positions=positions,
                                window=None if full else cfg.swa_window,
                                use_kernel=uk) for uk in (True, False)]
        outs = [_block_train(cfg, blk, x0, positions=positions, dist=None,
                             kind="hybrid", full_flag=full,
                             use_kernel=uk)[0] for uk in (True, False)]
    errs = {"attention": rel_err(torch, attn[0], attn[1]),
            "block": rel_err(torch, outs[0], outs[1])}
    log(f"hymba[plain]: first hybrid layer on identical bf16 inputs, kernels "
        f"vs plain: attention max rel diff {errs['attention']:.3e}, the "
        f"block's output {errs['block']:.3e}")
    if not max(errs.values()) < 2e-2:
        raise AssertionError(f"hymba: first layer kernels vs plain {errs}")
    summary["first_layer_err"] = errs
    del params, attn, outs, x0, h
    free(torch)

    cfg32 = stack_config(HYMBA_ARCH, n_layers=HYMBA_F32_LAYERS,
                         compute_dtype="float32")
    params32 = stack_params(torch, cfg32)
    gate_prompts = stack_prompts(torch, cfg32, STACK_GATE_BATCH,
                                 STACK_GATE_PROMPT, SEED + 1)
    k32 = serve(torch, cfg32, params32, None, None, None, gate_prompts,
                kernels, decode=False, warmup=False)
    p32 = serve(torch, cfg32, params32, None, None, None, gate_prompts,
                kernels, use_kernel=False, decode=False, warmup=False)
    if k32["prefill_launches"]["flash_attention"] != cfg32.n_layers or \
            any(p32["prefill_launches"].values()):
        raise AssertionError(f"hymba[f32]: launches kernels "
                             f"{k32['prefill_launches']}, plain "
                             f"{p32['prefill_launches']}")
    diff = rel_err(torch, k32["logits"], p32["logits"])
    log(f"hymba[f32]: {cfg32.n_layers} layers, {STACK_GATE_BATCH} x "
        f"{STACK_GATE_PROMPT} tokens: prefill kernels vs plain, max rel "
        f"logit diff {diff:.3e}")
    if not diff < 1e-4:
        raise AssertionError(f"hymba[f32]: kernels vs plain {diff}")
    summary["f32_err"] = diff
    del params32, k32, p32
    free(torch)
    return {f"{HYMBA_ARCH} serve": counts}, summary


def phase_hymba_train(torch, kernels):
    """hymba-1.5b trained at its published widths, HYMBA_TRAIN_LAYERS
    layers (layer 0 full attention, layer 1 windowed): two AdamW steps with
    the kernels and two with the plain versions; then each layer's bf16
    outputs and gradients on identical inputs."""
    from repro_torch.models.transformer import _block_train, _embed_tokens

    dev = torch.device(DEVICE)
    cfg = stack_config(HYMBA_ARCH, n_layers=HYMBA_TRAIN_LAYERS)
    batches = train_batches(cfg, HYMBA_TRAIN_BATCH, HYMBA_TRAIN_SEQ, 2)
    windows = ["full" if i in cfg.full_attn_layers else cfg.swa_window
               for i in range(cfg.n_layers)]
    log(f"hymba train: {cfg.name} layers={cfg.n_layers}/32 (attention "
        f"{windows}) batch={HYMBA_TRAIN_BATCH} seq={HYMBA_TRAIN_SEQ}; "
        f"{cfg.param_dtype} masters, {cfg.compute_dtype} compute, "
        f"remat={cfg.remat}")
    run = train_run(torch, cfg, None, batches, kernels)
    n = cfg.n_layers
    for i, (got, by) in enumerate(zip(run["launches"], run["variants"])):
        check_stack_launches(f"hymba train step {i}", got, 2 * n, n)
        if by["flash_attention_bwd"]["wgmma"] != n:
            raise AssertionError(f"hymba train step {i}: attention "
                                 f"backward launches by instance "
                                 f"{by['flash_attention_bwd']}; expected all "
                                 f"{n} on wgmma")
    plain = train_run(torch, cfg, None, batches, kernels, use_kernel=False)
    if any(any(c.values()) for c in plain["launches"]):
        raise AssertionError(f"hymba train[plain]: use_kernel=False "
                             f"launched a kernel: {plain['launches']}")
    diffs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
             for a, b in zip(run["metrics"], plain["metrics"])]
    tokens = HYMBA_TRAIN_BATCH * HYMBA_TRAIN_SEQ
    step_ms = run["step_ms"][-1]
    log(f"hymba train[kernels]: step ms {[round(x, 3) for x in run['step_ms']]}"
        f" (the last after a warm-up step: {step_ms:.3f} ms, "
        f"{tokens / step_ms * 1e3:.1f} tokens/s); peak device memory "
        f"{run['peak_gb']:.2f} GB; launches a step {run['launches'][-1]}; "
        f"plain step ms {[round(x, 3) for x in plain['step_ms']]}, peak "
        f"{plain['peak_gb']:.2f} GB; step losses kernels "
        f"{[round(m['loss'], 6) for m in run['metrics']]}, plain "
        f"{[round(m['loss'], 6) for m in plain['metrics']]}; relative "
        f"differences {[f'{d:.3e}' for d in diffs]}")
    if not max(diffs) < 2e-2:
        raise AssertionError(f"hymba train: losses kernels vs plain {diffs}")
    summary = {"step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
               "peak_gb": run["peak_gb"], "plain_step_ms": plain["step_ms"],
               "loss_diffs": diffs}
    adamw_launches(run, "hymba train")
    counts = attn_counts(*(
        (f"step {i}", c) for i, c in enumerate(run["launches"])),
        names=("flash_attention", "flash_attention_bwd") + ADAMW_KERNELS)
    del plain

    params = stack_params(torch, cfg, train=True)
    tokens_t = torch.from_numpy(batches[0]["tokens"]).long().to(dev)
    b, s = tokens_t.shape
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    with torch.no_grad():
        x0 = _embed_tokens(cfg, params, tokens_t, None)
    dy = torch.randn(x0.shape, generator=torch.Generator(
        device=dev).manual_seed(SEED + 3), device=dev).to(x0.dtype)
    worst = {}
    for i, blk in enumerate(params.blocks):
        full = i in cfg.full_attn_layers
        (y_k, g_k), (y_p, g_p) = [layer_grads(
            torch, cfg, blk, lambda t, uk=uk: _block_train(
                cfg, blk, t, positions=positions, dist=None, kind="hybrid",
                full_flag=full, use_kernel=uk), x0, dy)
            for uk in (True, False)]
        errs = {"output": rel_norm(torch, y_k, y_p)}
        errs.update({k: rel_norm(torch, g_k[k], g_p[k]) for k in g_k})
        log(f"hymba train[identical inputs]: layer {i} "
            f"({'full' if full else f'window {cfg.swa_window}'}), bf16, "
            f"kernels vs plain, relative norms: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        if not max(errs.values()) < 2e-2:
            raise AssertionError(f"hymba train: layer {i} kernels vs plain "
                                 f"{errs}")
        worst[f"layer {i}"] = max(errs.values())
        del y_k, g_k, y_p, g_p
        free(torch)
    summary["layer_grad_err"] = worst
    del params, x0, dy, run
    free(torch)
    return {f"{HYMBA_ARCH} train (2 steps)": counts}, summary


def phase_whisper(torch, kernels):
    """whisper-tiny at its published config: the encoder and the cross K/V
    (``encdec_init_cache``), ``Model.prefill`` (the forward, which encodes
    again), a teacher-forced decode chain over the prompt and GEN - 1
    greedy steps; the chain against the forward in f32; the first encoder
    layer against the plain attention in bf16."""
    from repro_torch.launch.serve import make_serve_step
    from repro_torch.models import build_model
    from repro_torch.models.encdec import (encdec_decode_step,
                                           encdec_forward, encdec_init_cache)
    from repro_torch.models.layers import attention_apply, norm_apply

    dev = torch.device(DEVICE)
    cfg = stack_config(WHISPER_ARCH)
    model = build_model(cfg, dev)
    params = stack_params(torch, cfg)
    rng = np.random.default_rng(SEED)
    frames = torch.from_numpy((rng.standard_normal(
        (WHISPER_BATCH, cfg.encoder_len, cfg.d_model)) * 0.5).astype(
            np.float32)).to(dev)
    prompts = stack_prompts(torch, cfg, WHISPER_BATCH, WHISPER_PROMPT)
    total = WHISPER_PROMPT + GEN
    log(f"whisper: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab} layers {cfg.n_encoder_layers} + "
        f"{cfg.n_layers}, {cfg.encoder_len} frames; batch={WHISPER_BATCH} "
        f"prompt={WHISPER_PROMPT} gen={GEN}; params {param_gb(params):.2f} "
        f"GB")
    step = make_serve_step(cfg, None, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    with torch.no_grad():
        cache = encdec_init_cache(cfg, WHISPER_BATCH, total, frames, params)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    enc = read_launches(kernels)
    check_stack_launches("whisper init_cache", enc, cfg.n_encoder_layers)
    reset_launches(kernels)
    t0 = time.perf_counter()
    full, _ = model.prefill(params, {"tokens": prompts, "frames": frames})
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    fwd = read_launches(kernels)
    check_stack_launches("whisper prefill", fwd,
                         cfg.n_encoder_layers + cfg.n_layers)
    reset_launches(kernels)
    t0 = time.perf_counter()
    for t in range(WHISPER_PROMPT):
        logits, cache = step(params, cache, prompts[:, t], t)
    torch.cuda.synchronize()
    t_chain = time.perf_counter() - t0
    chain_err = rel_err(torch, logits, full[:, -1])
    toks = logits.argmax(-1)
    out, events = [toks], []
    t0 = time.perf_counter()
    for t in range(WHISPER_PROMPT, total - 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        logits, cache = step(params, cache, toks, t)
        toks = logits.argmax(-1)
        b.record()
        events.append((a, b))
        out.append(toks)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    dec = read_launches(kernels)
    check_stack_launches("whisper decode", dec, 0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    for t in (full[:, -1], logits):
        if tuple(t.shape) != (WHISPER_BATCH, cfg.vocab) or \
                not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"whisper: bad logits {tuple(t.shape)}")
    n_dec = len(events)
    prefill_s = t_enc + t_chain
    step_ms = [a.elapsed_time(b) for a, b in events]
    summary = {"encode_ms": t_enc * 1e3, "forward_ms": t_fwd * 1e3,
               "chain_ms_per_step": t_chain / WHISPER_PROMPT * 1e3,
               "prefill_ms": prefill_s * 1e3,
               "decode_ms_per_step": t_dec / n_dec * 1e3,
               "decode_ms_median_device": statistics.median(step_ms),
               "tokens_per_s": WHISPER_BATCH * GEN / (prefill_s + t_dec),
               "peak_gb": peak}
    log(f"whisper batch {WHISPER_BATCH}: encoder and cross K/V "
        f"(encdec_init_cache) {t_enc * 1e3:.3f} ms; Model.prefill (the "
        f"forward over {WHISPER_PROMPT} tokens, encoding again) "
        f"{t_fwd * 1e3:.3f} ms; teacher-forced chain over the prompt "
        f"{t_chain * 1e3:.3f} ms ({summary['chain_ms_per_step']:.3f} "
        f"ms/step; its last logits vs the forward's, bf16: max rel diff "
        f"{chain_err:.3e}); prefill (encoder + chain) "
        f"{prefill_s * 1e3:.3f} ms; decode {summary['decode_ms_per_step']:.3f}"
        f" ms/step over {n_dec} steps (median {summary['decode_ms_median_device']:.3f}"
        f" ms on the device clock); {summary['tokens_per_s']:.1f} tokens/s "
        f"({WHISPER_BATCH * GEN} tokens); peak device memory {peak:.2f} GB; "
        f"launches init_cache {enc}, prefill {fwd}, chain and decode {dec}")
    counts = attn_counts(("init_cache", enc), ("prefill", fwd),
                         ("decode", dec))
    del cache, full, logits
    free(torch)

    # the chain against the forward at every prompt position, in f32 (the
    # parameters are f32 whatever the compute dtype)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.no_grad():
        full32, _ = encdec_forward(cfg32, params, prompts, {"frames": frames})
        cache32 = encdec_init_cache(cfg32, WHISPER_BATCH, WHISPER_PROMPT,
                                    frames, params)
        errs = []
        for t in range(WHISPER_PROMPT):
            lg, cache32 = encdec_decode_step(cfg32, params, cache32,
                                             prompts[:, t], t)
            errs.append(rel_err(torch, lg, full32[:, t]))
    log(f"whisper[f32 chain]: decode chain vs encdec_forward at each of "
        f"{WHISPER_PROMPT} positions: worst max rel diff {max(errs):.3e} "
        f"(position {int(np.argmax(errs))})")
    if not max(errs) < 1e-4:
        raise AssertionError(f"whisper: f32 chain vs forward {max(errs)}")
    summary["f32_chain_err"] = max(errs)
    del full32, cache32, lg
    free(torch)

    blk = params.enc_blocks[0]
    compute = getattr(torch, cfg.compute_dtype)
    b, se = WHISPER_BATCH, cfg.encoder_len
    with torch.no_grad():
        x = frames.to(compute) + params.enc_pos.to(compute)[None]
        h = norm_apply(cfg, blk.norm1, x)
        positions = torch.arange(se, dtype=torch.int32,
                                 device=dev).expand(b, se)
        outs = [attention_apply(cfg, blk.attn, h, positions=positions,
                                causal=False, use_kernel=uk)
                for uk in (True, False)]
    err = rel_err(torch, outs[0], outs[1])
    log(f"whisper[plain]: first encoder layer's attention (non-causal, "
        f"S={se}) on identical bf16 inputs, kernel vs plain: max rel diff "
        f"{err:.3e}")
    if not err < 2e-2:
        raise AssertionError(f"whisper: first encoder layer {err}")
    summary["first_layer_err"] = err
    del params, frames, outs, x, h
    free(torch)
    return {f"{WHISPER_ARCH} serve": counts}, summary


def phase_plan_server():
    """The plan-serving daemon's device handoff, as ``--plan-server``
    runs it on the card's host."""
    from repro_torch.launch.serve import _plan_dispatch_schedules

    out = _plan_dispatch_schedules(PLAN_SERVER_STEPS, True)
    sys.stdout.flush()
    if not (out["schedules"] == PLAN_SERVER_STEPS
            and 0 < out["lowered"] <= PLAN_SERVER_STEPS
            and out["memoized"] == out["schedules"] - out["lowered"]):
        raise AssertionError(f"plan server: handoff {out}")
    return out


def phase_stacks(torch, kernels):
    """Phase 7.  Returns the attention kernels' launches by path and a
    summary."""
    launches, summary = {}, {}
    for name, fn in (("xlstm", phase_xlstm), ("hymba", phase_hymba),
                     ("hymba_train", phase_hymba_train),
                     ("whisper", phase_whisper)):
        t0 = time.perf_counter()
        counts, summary[name] = fn(torch, kernels)
        launches.update(counts)
        summary[name]["phase_s"] = time.perf_counter() - t0
        log(f"phase stacks[{name}]: {summary[name]['phase_s']:.1f} s")
    summary["plan_server"] = phase_plan_server()
    return launches, summary


# -- phase 8: one process per rank -----------------------------------------

def card_used_gb(torch) -> float:
    """Memory in use on the card by every process (``cudaMemGetInfo``)."""
    free_b, total = torch.cuda.mem_get_info()
    return (total - free_b) / 1e9


def proc_inputs(torch, cfg):
    """Every rank's inputs of phase 8's collectives, stacked ``[4, ...]``,
    made on the device from the seed (each process makes them all and
    keeps its own row): small f32, bf16 and int8 buffers, a gradient and
    its error carry, and megatron's prefill dispatch buffer ``[4, 4,
    E_loc * C, d_model]`` in bf16 (8 prompts of PROMPT tokens a rank)."""
    from repro_torch.models.moe import _capacity

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    r = int(np.prod(PROC_MESH[:2]))
    e_loc = cfg.moe.num_experts // r
    cap = _capacity(cfg, PROC_BATCH // r * PROMPT, cfg.moe.num_experts)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(r, 4, 8, 512)
    return {"x": x, "xb": (x * 3).to(torch.bfloat16),
            "xi": torch.randint(-127, 128, (r, 4, 8, 512), generator=gen,
                                device=dev).to(torch.int8),
            "xr": randn(r, 2, 8, 512), "g": randn(r, 64, 256),
            "err": randn(r, 64, 256) * 0.01,
            "buf": randn(r, 4, e_loc * cap, cfg.d_model).to(torch.bfloat16)}


PROC_A2A = {"a2a pod f32": (("pod",), "x"), "a2a data f32": (("data",), "x"),
            "a2a pod,data f32": (("pod", "data"), "x"),
            "a2a pod bf16": (("pod",), "xb"),
            "a2a pod,data bf16": (("pod", "data"), "xb"),
            "a2a data int8": (("data",), "xi"),
            "a2a pod,data int8": (("pod", "data"), "xi")}


def proc_collectives(torch, mesh, inp, plan):
    """Phase 8's collectives on ``mesh`` over the held ranks' rows of
    ``inp``: what ``LocalMesh`` and ``ProcessMesh`` must agree on."""
    from repro_torch.comm import all_to_all_by_name, plan_all_to_all
    from repro_torch.comm.all_to_all import rotation_all_to_all
    from repro_torch.comm.collectives import ef_compressed_psum, psum_bf16
    from repro_torch.launch import mesh as M

    out = {name: M.all_to_all(mesh, inp[key], axes)
           for name, (axes, key) in PROC_A2A.items()}
    out["ppermute pod swap"] = M.ppermute(mesh, inp["x"], "pod",
                                          [(0, 1), (1, 0)])
    out["ppermute data partial"] = M.ppermute(mesh, inp["x"], "data",
                                              [(0, 1)])
    for axis in ("pod", "data"):
        out[f"axis_index {axis}"] = M.axis_index(mesh, axis)
    out["pmean pod,data"] = M.pmean(mesh, inp["x"], ("pod", "data"))
    out["psum_bf16 pod"] = psum_bf16(mesh, inp["g"], "pod")
    out["ef_compressed_psum data"], out["ef_compressed_psum data error"] = \
        ef_compressed_psum(mesh, inp["g"], "data", inp["err"])
    for impl in ("direct", "flash", "hierarchical"):
        out[f"{impl} dispatch"] = all_to_all_by_name(impl)(
            inp["buf"], "pod", ("data",), mesh=mesh)
    out["rotation"] = rotation_all_to_all(inp["xr"], "pod", mesh=mesh)
    for uk in (True, False):
        out[f"plan dispatch use_kernel={uk}"] = plan_all_to_all(
            inp["buf"], "pod", ("data",), mesh=mesh, plan=plan,
            use_kernel=uk)
    return out


def first_layer(torch, cfg, params, mesh, plan, prompts):
    """The first attention layer and the first MoE layer (through the plan
    on ``mesh``) on the embedded prompts, with the kernels: (attention,
    MoE output, the MoE's routing).  On a process mesh with TP over
    "model", each on this process's slice, summed over "model"."""
    from repro_torch.launch.serve import make_dist_context
    from repro_torch.models.layers import attention_apply, norm_apply
    from repro_torch.models.moe import moe_apply
    from repro_torch.models.tp import tp_mesh
    from repro_torch.models.transformer import _embed_tokens, _window_args

    blk = params.blocks[0]
    b, s = prompts.shape
    dist = make_dist_context(cfg, mesh, "plan", plan)
    with torch.no_grad():
        x0 = _embed_tokens(cfg, params, prompts, None, tp_mesh(dist))
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x0.device).expand(b, s)
        window, use_window = _window_args(cfg, False)
        attn = attention_apply(cfg, blk.attn, norm_apply(cfg, blk.norm1, x0),
                               positions=positions, window=window,
                               use_window=use_window, tp=tp_mesh(dist))
        with RouteRecorder() as rec:
            y = moe_apply(cfg, blk.moe, norm_apply(cfg, blk.norm2, x0),
                          dist)[0]
    return attn, y, rec.eids[0]


def exchange_share(torch, prefill, params, batch):
    """One prefill under ``torch.profiler`` (host activity): the time
    inside the process mesh's collectives (their ``procmesh.*`` ranges,
    host staging included) over the prefill's host time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prefill(params, batch)
        torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) * 1e6
    spans = [e for e in prof.events() if e.name.startswith("procmesh.")]
    inside = sum(e.time_range.elapsed_us() for e in spans)
    return inside / host_us, len(spans), host_us / 1e3


def proc_child(mesh, cfg32, shards, rows, serve_cli, plan):
    """One rank of phase 8, the per-rank hook of ``serve_procs``: runs in
    each process once it holds its shard of the f32 parameters (cut from
    the parent's, shared through CUDA IPC) and the parent has dropped the
    whole.  The collectives on its rows, then ``serve_procs``' own serve of
    the f32 shard (prefill and 15 greedy steps, gathered on rank 0) with
    its routing recorded, the bf16 serving run, the other exchanges'
    prefills, the exchange's share and the first layer.  Returns host
    tensors."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.convert import recast
    from repro_torch.launch.serve import make_prefill_step

    kernels = proc_kernels()
    cfg = serve_config()
    r = mesh.rank
    out = {"rank": r, "device": str(mesh.device), "used_gb": {}}
    out["used_gb"]["after the parent's drop"] = card_used_gb(torch)
    out["shard_gb"] = param_gb(shards[0])

    full = proc_inputs(torch, cfg)
    own = {k: v[r:r + 1] for k, v in full.items()}
    out["collectives"] = {k: v.cpu() for k, v in
                          proc_collectives(torch, mesh, own, plan).items()}
    del full, own
    torch.cuda.reset_peak_memory_stats()

    with RouteRecorder() as rec:         # the prefill's, then each step's
        serve_cli()
    out["f32_routes"] = [e.cpu() for e in rec.eids[:len(rec.eids) // GEN]]

    shard = recast(shards.pop(), cfg)
    free(torch)
    run = serve(torch, cfg, shard, mesh, "plan", plan, rows, kernels,
                record=True)
    out["used_gb"]["serving"] = card_used_gb(torch)
    out["serve"] = {k: run[k] for k in (
        "prefill_s", "decode_s", "decode_steps", "step_ms_median",
        "step_ms_max", "prefill_launches", "decode_launches",
        "prefill_variants", "decode_variants")}
    out["serve"].update(logits=run["logits"].cpu(),
                        last_logits=run["last_logits"].cpu(),
                        tokens=run["tokens"].cpu(),
                        routes=[e.cpu() for e in run["routes"]])
    prefill = make_prefill_step(cfg, mesh, "plan", plan,
                                cache_len=PROMPT + GEN, device=DEVICE)
    out["exchange"] = exchange_share(torch, prefill, shard,
                                     {"tokens": rows})
    out["impl_equal"] = {}
    for impl in ("direct", "flash", "hierarchical"):
        other = serve(torch, cfg, shard, mesh, impl, None, rows, kernels,
                      decode=False, warmup=False)
        out["impl_equal"][impl] = bool(torch.equal(other["logits"],
                                                   run["logits"]))
    attn, y, eids = first_layer(torch, cfg, shard, mesh, plan, rows)
    out["first_layer"] = (attn.cpu(), y.cpu(), eids.cpu())
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def proc_nccl_checks(torch):
    """One process on NCCL (a world of one): ``all_to_all`` and ``pmean``
    against ``LocalMesh((1, 1, 1))``; then ``backend="nccl"`` with two
    ranks on the one card must raise."""
    import torch.distributed as torch_dist

    from repro_torch.launch import mesh as M
    from repro_torch.launch.procs import file_rendezvous, init_process_mesh

    dev = torch.device(DEVICE)
    x = torch.randn((1, 4, 8, 256), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    one = M.make_mesh((1, 1, 1), AXES, dev)
    with file_rendezvous() as rdv:
        mesh = init_process_mesh((1, 1, 1), AXES, "nccl", DEVICE, rdv,
                                 rank=0, world_size=1,
                                 timeout=PROC_TIMEOUT_S)
        try:
            got = {"all_to_all": M.all_to_all(mesh, x, ("pod", "data")),
                   "pmean": M.pmean(mesh, x, ("pod", "data"))}
            torch.cuda.synchronize()
        finally:
            torch_dist.destroy_process_group()
    want = {"all_to_all": M.all_to_all(one, x, ("pod", "data")),
            "pmean": M.pmean(one, x, ("pod", "data"))}
    for k in got:
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"procs[nccl, world of 1]: {k} differs "
                                 f"from LocalMesh((1, 1, 1))")
    log("procs[nccl, world of 1]: all_to_all and pmean on the NCCL process "
        "group bit-identical to LocalMesh((1, 1, 1))")
    try:
        with file_rendezvous() as rdv:
            init_process_mesh((2, 1, 1), AXES, "nccl", DEVICE, rdv, rank=0,
                              world_size=2)
    except ValueError as e:
        log(f"procs[nccl, 2 ranks on one card]: refused as it must be: {e}")
    else:
        raise AssertionError("nccl with two ranks on one card did not raise")


def phase_procs(torch, kernels):
    """Phase 8.  Returns the launch counts of rank 0's serving run and a
    summary."""
    from repro_torch.convert import recast
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import flash_plan, serve_procs

    cfg = serve_config()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    dev = torch.device(DEVICE)
    local = make_mesh(PROC_MESH, AXES, dev)
    plan = flash_plan(PROC_MESH[0], PROC_MESH[1], SEED)
    prompts = stack_prompts(torch, cfg, PROC_BATCH, PROMPT)
    summary = {"label": PROC_LABEL, "used_gb": {}}
    log(f"procs: {cfg.name} layers={cfg.n_layers}/24 at its published "
        f"widths on a {PROC_MESH} mesh of {int(np.prod(PROC_MESH))} "
        f"processes ({PROC_BACKEND}) on the one card; {PROC_BATCH} prompts "
        f"of {PROMPT} tokens ({PROC_BATCH // 4} a process), {GEN - 1} decode "
        f"steps; {PROC_LABEL}")

    # the oracles: LocalMesh((2, 2, 1)) on the whole model, f32 and bf16
    torch.cuda.reset_peak_memory_stats()
    params32 = stack_params(torch, cfg32)
    summary["f32_params_gb"] = param_gb(params32)
    loc32 = serve(torch, cfg32, params32, local, "plan", plan, prompts,
                  kernels, warmup=False, record="margins")
    params = recast(params32, cfg)
    loc = serve(torch, cfg, params, local, "plan", plan, prompts, kernels,
                record=True)
    check_run(torch, loc, cfg, PROC_BATCH, "procs[local oracle]",
              SERVE_KERNELS, MEGATRON_A2A)
    summary["oracle"] = {"prefill_ms": loc["prefill_s"] * 1e3,
                         "decode_ms_per_step": loc["decode_s"]
                         / loc["decode_steps"] * 1e3,
                         "decode_device_ms_median": loc["step_ms_median"]}
    log(f"procs[local oracle]: the same bf16 work stacked in one process: "
        f"prefill {summary['oracle']['prefill_ms']:.3f} ms; decode "
        f"{summary['oracle']['decode_ms_per_step']:.3f} ms/step (median "
        f"{loc['step_ms_median']:.3f} ms on the device clock)")
    loc_first = first_layer(torch, cfg, params, local, plan, prompts)
    del params
    free(torch)
    coll = {k: v.cpu() for k, v in proc_collectives(
        torch, local, proc_inputs(torch, cfg), plan).items()}
    summary["parent_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    summary["used_gb"]["parent, whole f32 model"] = card_used_gb(torch)
    log(f"procs[local oracle]: f32 parameters {summary['f32_params_gb']:.2f} "
        f"GB; parent peak {summary['parent_peak_gb']:.2f} GB")

    # the processes (serve_procs): each takes its shard of the parent's f32
    # parameters (CUDA IPC), then the parent drops them, then each serves
    holder = [params32]
    del params32
    t0 = time.perf_counter()
    res = serve_procs(cfg32, holder, prompts, PROC_MESH, PROC_BACKEND,
                      DEVICE, "plan", plan, GEN,
                      hook=functools.partial(proc_child, plan=plan),
                      timeout=PROC_TIMEOUT_S,
                      join_timeout=PROC_JOIN_S)
    summary["processes_s"] = time.perf_counter() - t0
    summary["used_gb"].update(res.get("card_used_gb", {}))
    outs = res["ranks"]

    # (a) the collectives: bit for bit, pmean within 1e-6
    for k, want in coll.items():
        got = torch.cat([o["collectives"][k] for o in outs])
        if k.startswith("pmean"):
            err = rel_err(torch, got, want)
            log(f"procs[collectives]: {k}: max rel diff {err:.3e} against "
                f"LocalMesh (the all_reduce's summation order)")
            if not err <= 1e-6:
                raise AssertionError(f"procs: {k} off by {err}")
        elif not torch.equal(got, want):
            raise AssertionError(f"procs: {k} differs from LocalMesh")
    log(f"procs[collectives]: {len(coll) - 1} collectives and exchanges "
        f"({', '.join(k for k in coll if not k.startswith('pmean'))}) "
        f"bit-identical to LocalMesh on the card's tensors; "
        f"{PROC_BACKEND} stages them through pinned host memory")

    # (b) serving: f32 logits and routing, bf16 tokens, launches, exchanges
    err32 = rel_err(torch, res["logits"][0], loc32["logits"].cpu())
    routes32 = [torch.cat([o["f32_routes"][i] for o in outs])
                for i in range(len(loc32["routes"]))]
    flips32, n_dec, tie = near_tie_flips(torch, loc32["routes"], routes32,
                                         loc32["margins"], PROC_BATCH)
    log(f"procs[f32]: serve_procs' prefill logits gathered on rank 0, max "
        f"rel diff {err32:.3e} against LocalMesh; {flips32} of {n_dec} "
        f"routing decisions differ, each sequence's first at an oracle "
        f"margin of at most {tie:.3e} (near-tie limit {NEAR_TIE})")
    controls = near_tie_controls(torch, loc32, routes32)
    same32 = bool(torch.equal(res["tokens"], loc32["tokens"].cpu()))
    log(f"procs[f32]: greedy tokens of the prefill and {GEN - 1} decode "
        f"steps, gathered on rank 0, equal to LocalMesh's: {same32}")
    summary["f32"] = {"max_rel_diff": err32, "routing_differs": flips32,
                      "first_difference_margin": tie, "tokens_equal": same32,
                      "controls": controls}
    if not (err32 < 1e-4 and tie <= NEAR_TIE and same32):
        raise AssertionError(f"procs: f32 prefill {err32}, {flips32} routing "
                             f"decisions differ, the first at a margin of "
                             f"{tie}; greedy tokens equal {same32}")
    # bf16: the products' shapes differ (8 rows of prompts a process, 32
    # stacked), so cuBLAS rounds them differently and routers' near ties
    # flip, as kernels against plain do (phase 3): a few sequences may be
    # routed apart, and every sequence routed alike keeps its tokens
    logits = torch.cat([o["serve"]["logits"] for o in outs])
    tokens = torch.cat([o["serve"]["tokens"] for o in outs])
    routes = [torch.cat([o["serve"]["routes"][i] for o in outs])
              for i in range(len(loc["routes"]))]
    n_flip, n_dec, per_layer, per_seq = route_flips(
        torch, [e.cpu() for e in loc["routes"]], routes, PROC_BATCH)
    same_tok = (tokens == loc["tokens"].cpu()).all(-1)
    alike_same = bool(same_tok[~per_seq].all())
    summary["bf16"] = {
        "max_rel_diff": rel_err(torch, logits, loc["logits"].cpu()),
        "bit_identical": bool(torch.equal(logits, loc["logits"].cpu())),
        "routing_differs": n_flip, "sequences_routed_apart":
        int(per_seq.sum()), "sequences_same_tokens": int(same_tok.sum()),
        "routed_alike_same_tokens": alike_same}
    log(f"procs[bf16]: prefill logits max rel diff "
        f"{summary['bf16']['max_rel_diff']:.3e} against LocalMesh "
        f"(bit-identical {summary['bf16']['bit_identical']}); routing "
        f"differs in {n_flip} of {n_dec} (token, layer) decisions (per layer "
        f"{per_layer}), in {int(per_seq.sum())} of {PROC_BATCH} sequences "
        f"(at most {PROC_BF16_APART_MAX}); greedy tokens equal in "
        f"{int(same_tok.sum())} of {PROC_BATCH} sequences, in every sequence "
        f"routed alike {alike_same}")
    if not (alike_same and int(per_seq.sum()) <= PROC_BF16_APART_MAX):
        raise AssertionError(
            f"procs: bf16 routed {int(per_seq.sum())} of {PROC_BATCH} "
            f"sequences apart (at most {PROC_BF16_APART_MAX}); tokens equal "
            f"in every sequence routed alike {alike_same}")
    want = run_counts(loc)
    for o in outs:
        got = {"prefill": o["serve"]["prefill_launches"],
               "decode": o["serve"]["decode_launches"]}
        for part in ("prefill", "decode"):
            for name in SERVE_KERNELS:
                n = got[part][name]
                if n != want[part][name] or (n <= 0 and not (
                        part == "decode" and name == "flash_attention")):
                    raise AssertionError(
                        f"procs: rank {o['rank']} launched {name} {n} times "
                        f"in the {part}; LocalMesh {want[part][name]}")
        check_variants(o["serve"], f"procs[rank {o['rank']}]",
                       a2a=MEGATRON_A2A)
        bad = [k for k, v in o["impl_equal"].items() if not v]
        if bad:
            raise AssertionError(f"procs: rank {o['rank']}'s {bad} prefill "
                                 f"differs from the plan's")
    log(f"procs: every process launched a2a_pack, a2a_unpack, "
        f"grouped_matmul and flash_attention as often as the LocalMesh run "
        f"(prefill {want['prefill']}, decode {want['decode']}); direct, "
        f"flash and hierarchical prefills bit-identical to the plan's in "
        f"every process")

    # first layer on identical inputs
    b = PROC_BATCH // len(outs)
    errs, bits, route_eq = [], [], []
    for o in outs:
        rows = slice(o["rank"] * b, (o["rank"] + 1) * b)
        attn, y, eids = o["first_layer"]
        want_attn, want_y = loc_first[0][rows].cpu(), loc_first[1][rows].cpu()
        errs.append((rel_err(torch, attn, want_attn),
                     rel_err(torch, y, want_y)))
        bits.append(bool(torch.equal(attn, want_attn))
                    and bool(torch.equal(y, want_y)))
        route_eq.append(bool(torch.equal(eids[0],
                                         loc_first[2][o["rank"]].cpu())))
    worst = tuple(max(e[i] for e in errs) for i in range(2))
    log(f"procs[first layer, bf16, identical inputs]: attention max rel diff "
        f"{worst[0]:.3e}, MoE {worst[1]:.3e} against LocalMesh; routing equal "
        f"{all(route_eq)}; bit-identical {all(bits)}")
    if not (worst[0] < 2e-2 and worst[1] < 2e-2 and all(route_eq)):
        raise AssertionError(f"procs: first layer {worst}, routing equal "
                             f"{route_eq}")

    for o in outs:
        sv = o["serve"]
        share, n_spans, host_ms = o["exchange"]
        log(f"procs[rank {o['rank']}]: prefill {sv['prefill_s'] * 1e3:.3f} "
            f"ms; decode {sv['decode_s'] / sv['decode_steps'] * 1e3:.3f} "
            f"ms/step host mean, {sv['step_ms_median']:.3f} ms device median "
            f"over {sv['decode_steps']} steps; exchange share of a traced "
            f"prefill {share:.4f} ({n_spans} collectives, {host_ms:.3f} ms, "
            f"host staging included); peak {o['peak_gb']:.2f} GB "
            f"(f32 shard {o['shard_gb']:.2f} GB); {PROC_LABEL}")
    card = dict(summary["used_gb"])
    for o in outs:
        for k, v in o["used_gb"].items():
            card[f"{k} (rank {o['rank']})"] = v
    summary["used_gb"] = card
    summary["card_peak_gb_seen"] = max(card.values())
    summary["ranks"] = [{
        "rank": o["rank"], "prefill_ms": o["serve"]["prefill_s"] * 1e3,
        "decode_ms_per_step": o["serve"]["decode_s"]
        / o["serve"]["decode_steps"] * 1e3,
        "decode_device_ms_median": o["serve"]["step_ms_median"],
        "peak_gb": o["peak_gb"], "exchange_share": o["exchange"][0]}
        for o in outs]
    log(f"procs: memory in use on the card (GB): "
        f"{json.dumps({k: round(v, 2) for k, v in card.items()})}; the most "
        f"seen {summary['card_peak_gb_seen']:.2f} GB")
    proc_nccl_checks(torch)
    counts = {"prefill": outs[0]["serve"]["prefill_launches"],
              "decode": outs[0]["serve"]["decode_launches"]}
    return counts, summary


# -- 9. training on one process per rank -------------------------------------

def proc_kernels():
    """The kernel wrappers (each keeps its launch count), in a process."""
    from repro_torch.kernels.a2a_pack import a2a_pack, a2a_unpack
    from repro_torch.kernels.adamw import adamw_step, sq_norm
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.grouped_matmul import grouped_matmul

    return {"a2a_pack": a2a_pack, "a2a_unpack": a2a_unpack,
            "grouped_matmul": grouped_matmul,
            "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "sq_norm": sq_norm, "adamw_step": adamw_step}


def proc_train_options(steps):
    """Phase 6's schedule: a warm-up step at rate 0, then the peak."""
    from repro_torch.launch.train import TrainOptions

    return TrainOptions(peak_lr=3e-4, warmup_steps=1, total_steps=steps)


def proc_data(cfg, batch, seq):
    """The ``SyntheticLM`` stream of ``train_batches`` (the same batches)."""
    from repro_torch.data import DataConfig

    return DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                      seed=SEED)


class GradSpy:
    """While active, each gradient dictionary ``make_train_step`` hands to
    AdamW is kept (copies), or with ``on_grads`` what ``on_grads(i,
    grads)`` makes of the ``i``-th; with ``update=False`` the update is
    skipped (parameters and moments stay as they were)."""

    def __init__(self, update=True, on_grads=None):
        from repro_torch.launch import train
        self.train, self.real, self.update, self.grads = \
            train, train.adamw_update, update, []
        self.on_grads = on_grads or (lambda i, grads: {
            k: g.detach().clone() for k, g in grads.items()})

    def __enter__(self):
        import torch

        def spy(grads, opt, params, lr, cfg, *rest):
            self.grads.append(self.on_grads(len(self.grads), grads))
            if self.update:
                return self.real(grads, opt, params, lr, cfg, *rest)
            return params, opt, torch.zeros(())
        self.train.adamw_update = spy
        return self

    def __exit__(self, *exc):
        self.train.adamw_update = self.real


def local_oracle(torch, cfg, batch, seq, steps, kernels, keep=False,
                 shape=PROC_MESH):
    """Phase 9's oracle: ``steps`` AdamW steps of fresh parameters from the
    seed on ``LocalMesh(shape)`` (default (2, 2, 1)), every rank stacked in
    this process; counts set to 0 just before each step and read just
    after.  With ``keep`` the gradients of each step, the final parameters
    and the routing margins stay (on the card)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import init_train_state, make_train_step

    mesh = make_mesh(shape, AXES, torch.device(DEVICE))
    params = stack_params(torch, cfg, train=True)
    state = init_train_state(params)
    step = make_train_step(cfg, mesh, proc_train_options(steps),
                           device=DEVICE)
    out = {"metrics": [], "step_ms": [], "launches": [], "variants": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spy = GradSpy(on_grads=None if keep else lambda i, grads: None)
    with spy, RouteRecorder(margins=keep) as rec:
        for b in train_batches(cfg, batch, seq, steps):
            reset_launches(kernels)
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["metrics"].append({k: float(v) for k, v in m.items()})
            out["launches"].append(read_launches(kernels))
            out["variants"].append(read_variants(kernels))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["routes"] = [e.cpu() for e in rec.eids]
    if keep:
        out["margins"] = [m.cpu() for m in rec.margins]
        out["grads"] = spy.grads
        out["final"] = {k: p.detach() for k, p in params.named_parameters()}
    del state, step, params, spy
    free(torch)
    return out


def traced_step(torch, run):
    """One training step ``run()`` under torch.profiler (host activity):
    the shares of its host time inside the process mesh's collectives of
    the forward and backward (the MoE exchange and the aux loss's mean,
    their ``procmesh.*`` ranges inside ``train.forward_backward``, the
    backward's ``.bwd`` ones included), inside the sums over "model" of a
    TP run (its ``procmesh.tp_*`` ranges there) and inside the gradient
    sync (``train.grad_sync``), host staging included."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = run()
        torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()

    def spans(pred):
        return [e for e in events if pred(e.name)]

    fb = spans(lambda n: n == "train.forward_backward")
    sync = spans(lambda n: n == "train.grad_sync")
    inside = [e for e in spans(lambda n: n.startswith("procmesh."))
              if any(r.time_range.start <= e.time_range.start
                     and e.time_range.end <= r.time_range.end for r in fb)]
    tp = [e for e in inside if e.name.startswith("procmesh.tp_")]
    inside = [e for e in inside if not e.name.startswith("procmesh.tp_")]
    ex_us = busy_us([(e.time_range.start, e.time_range.end) for e in inside])
    tp_us = busy_us([(e.time_range.start, e.time_range.end) for e in tp])
    sync_us = sum(e.time_range.elapsed_us() for e in sync)
    return res, {"spans": span_shares(events, host_us),
                 "host_ms": host_us / 1e3, "exchange_share": ex_us / host_us,
                 "tp_share": tp_us / host_us,
                 "tp_sums": sum(":" not in e.name for e in tp),
                 "sync_share": sync_us / host_us,
                 "collectives": len(inside),
                 "backward_collectives": sum(e.name.endswith(".bwd")
                                             for e in inside)}


def train_proc_child(mesh, cfg, shards, train, steps=TRAIN_PROC_STEPS):
    """One rank of phase 9 (a), the per-rank hook of ``train_procs``: the
    CLI's own training loop (``train()``) on this process's shard, each
    step's launches counted (the counts set to 0 just before the step and
    read just after), its routing recorded, the last of its ``steps``
    steps traced; the card's memory in use after each step."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = proc_kernels()
    out = {"rank": mesh.rank, "shard_gb": param_gb(shards[0]),
           "used_gb": {"after the parent's drop": card_used_gb(torch)},
           "launches": [], "variants": [], "card_gb": []}
    torch.cuda.reset_peak_memory_stats()

    def each(i, run):
        reset_launches(kernels)
        if i == steps - 1:
            res, out["trace"] = traced_step(torch, run)
        else:
            res = run()
            torch.cuda.synchronize()
        out["launches"].append(read_launches(kernels))
        out["variants"].append(read_variants(kernels))
        out["card_gb"].append(card_used_gb(torch))
        return res

    with RouteRecorder() as rec:
        out["train"] = train(each_step=each)
    out["routes"] = [e.cpu() for e in rec.eids]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def check_proc_launches(outs, oracle, n_layers, label):
    """Every process's launches each step equal to the oracle's (every rank
    stacked: one launch serves them all, as one serves a process's rank),
    grouped_matmul on TMA alone, the attention backward on wgmma alone, no
    pack or unpack."""
    check_train_launches(oracle, n_layers, f"{label}[local oracle]")
    for o in outs:
        check_train_launches(o, n_layers, f"{label}[rank {o['rank']}]")
        if o["launches"] != oracle["launches"]:
            raise AssertionError(f"{label}: rank {o['rank']} launched "
                                 f"{o['launches']}; the oracle "
                                 f"{oracle['launches']}")


def phase_train_procs(torch, kernels):
    """Phase 9 (a): megatron-moe-32e trained on 4 processes through
    ``train_procs`` against the same steps on the stacked mesh; then (b)
    the f32 gate and (c) the Trainer.  Returns rank 0's launches over its
    steps and a summary."""
    from repro_torch.launch.train import train_procs

    cfg = train_config()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"train-procs: {cfg.name} layers={cfg.n_layers}/24 at its published "
        f"widths on a {PROC_MESH} mesh of {int(np.prod(PROC_MESH))} "
        f"processes ({PROC_BACKEND}) on the one card through train_procs; "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step ({TRAIN_BATCH // 4} x "
        f"{TRAIN_SEQ} a process), {TRAIN_PROC_STEPS} AdamW steps, "
        f"{cfg.param_dtype} masters, {cfg.compute_dtype} compute, "
        f"remat={cfg.remat}, exchange {cfg.a2a_impl!r}; {PROC_LABEL}")
    oracle = local_oracle(torch, cfg, TRAIN_BATCH, TRAIN_SEQ,
                          TRAIN_PROC_STEPS, kernels)
    summary = {"label": PROC_LABEL, "oracle": {
        "step_ms": oracle["step_ms"], "peak_gb": oracle["peak_gb"],
        "tokens_per_s": tokens / statistics.median(oracle["step_ms"][1:])
        * 1e3}}
    log(f"train-procs[local oracle]: step ms "
        f"{[round(x, 3) for x in oracle['step_ms']]} "
        f"({summary['oracle']['tokens_per_s']:.1f} tokens/s at the median of "
        f"steps 1 to {TRAIN_PROC_STEPS - 1}); peak {oracle['peak_gb']:.2f} "
        f"GB; losses {[round(m['loss'], 6) for m in oracle['metrics']]}")

    params = stack_params(torch, cfg, train=True)
    holder = [params]
    del params
    # the 4 processes' states fill the card to within about 10 GB: their
    # allocators grow segments in place rather than leave gaps
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    res = train_procs(cfg, holder, proc_data(cfg, TRAIN_BATCH, TRAIN_SEQ),
                      PROC_MESH, PROC_BACKEND, DEVICE,
                      proc_train_options(TRAIN_PROC_STEPS), TRAIN_PROC_STEPS,
                      hook=train_proc_child, timeout=PROC_TIMEOUT_S,
                      join_timeout=PROC_JOIN_S)
    summary["processes_s"] = time.perf_counter() - t0
    outs = res["ranks"]
    check_proc_launches(outs, oracle, cfg.n_layers, "train-procs")
    diffs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
             for a, b in zip(res["metrics"], oracle["metrics"])]
    routes = [torch.cat([o["routes"][i] for o in outs])
              for i in range(len(oracle["routes"]))]
    n_flip, n_dec, per_layer, per_seq = route_flips(
        torch, oracle["routes"], routes, TRAIN_BATCH)
    log(f"train-procs: every process launched each kernel as often as the "
        f"oracle each step ({oracle['launches'][0]}), grouped_matmul on TMA "
        f"and the attention backward on wgmma alone; step losses "
        f"{[round(m['loss'], 6) for m in res['metrics']]} against the "
        f"oracle's, relative differences {[f'{d:.3e}' for d in diffs]} "
        f"(limit 2e-2); {n_flip} of {n_dec} routing decisions differ (per "
        f"forward {per_layer}), in {int(per_seq.sum())} of {TRAIN_BATCH} "
        f"sequences")
    if not max(diffs) < 2e-2:
        raise AssertionError(f"train-procs: step losses against the oracle "
                             f"{diffs}")
    summary.update(loss_diffs=diffs, routing_differs=n_flip,
                   sequences_routed_apart=int(per_seq.sum()),
                   card_used_gb=res.get("card_used_gb", {}), ranks=[])
    for o in outs:
        ms = o["train"]["step_ms"]
        r = {"rank": o["rank"], "step_ms": ms,
             "tokens_per_s": tokens / 4 / ms[1] * 1e3,
             "peak_gb": o["peak_gb"], "card_gb": max(o["card_gb"]),
             "shard_gb": o["shard_gb"], **o["trace"]}
        summary["ranks"].append(r)
        log(f"train-procs[rank {o['rank']}]: step ms "
            f"{[round(x, 3) for x in ms]} (step {TRAIN_PROC_STEPS - 1} "
            f"traced); {r['tokens_per_s']:.1f} tokens/s of its rows at step "
            f"1 ({tokens / ms[1] * 1e3:.1f} for the 4 processes); peak "
            f"{o['peak_gb']:.2f} GB (f32 shard {o['shard_gb']:.2f} GB); the "
            f"card {r['card_gb']:.2f} GB in use; traced step "
            f"{r['host_ms']:.3f} ms: exchange share {r['exchange_share']:.4f} "
            f"({r['collectives']} collectives, {r['backward_collectives']} "
            f"of them the backward's), gradient sync share "
            f"{r['sync_share']:.4f}; {PROC_LABEL}")
    log(f"train-procs: card memory in use (GB): "
        f"{json.dumps({k: round(v, 2) for k, v in summary['card_used_gb'].items()})}")
    counts = {k: sum(step[k] for step in outs[0]["launches"])
              for k in outs[0]["launches"][0]}
    summary["f32"] = train_procs_f32_gate(torch, kernels)
    summary["trainer"] = train_procs_trainer_gate(torch)
    del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
    return counts, summary


def grad_stats(torch, mesh, specs, got, want):
    """Per gradient: (squared norm of got - want's slice, squared norm of
    want's slice, whether the slices differ between processes)."""
    from repro_torch.launch.shardings import shard_tensor, sharded_axes

    out = {}
    for k, g in got.items():
        w = shard_tensor(want[k], specs[k], mesh).float()
        out[k] = (float((g.float() - w).square().sum()),
                  float(w.square().sum()),
                  bool(sharded_axes(mesh, specs[k])))
    return out


@contextlib.contextmanager
def pmean_local():
    """Phase 9 (b)'s planted fault: ``pmean``'s backward a local ``1 /
    n``."""
    from repro_torch.launch import mesh as M

    real = M._pmean_backward
    M._pmean_backward = lambda mesh_, g, axes: g / mesh_.axis_size(axes)
    try:
        yield
    finally:
        M._pmean_backward = real


def f32_proc_child(mesh, cfg, shards, train, want, plant=pmean_local,
                   batch=TRAIN_BATCH, noise_unit="process",
                   seq=F32_TRAIN_SEQ, fault_peers=False, watch=None):
    """One rank of phase 9 (b): the first step's gradients under the
    planted fault ``plant()`` (default: ``pmean``'s backward a local ``1 /
    n``; no update),
    then the sound steps through ``train()``; each step's gradients and the
    final parameters against the oracle's slices (``want``, shared from the
    parent through CUDA IPC).  Per parameter: the worst difference of the
    elements outside the noise class (also at each of NOISE_GRAD_SCAN's
    thresholds), of those inside it, and of two planted controls on that
    class, its update skipped (the initial value) and its sign flipped.
    With ``fault_peers`` also the digests of the faulty step's gradients
    of the leaves replicated over "model" (``fault_peers``).  With
    ``watch`` ((leaf, global index or None)) also, under ``"watch"`` of
    that leaf, one element's synced gradient each step beside the
    oracle's, and its update beside the oracle's: the element at the index,
    where this process holds it, or this process's worst strict element of
    the leaf."""
    import torch

    from repro_torch.launch.train import (init_train_state, make_train_step,
                                          train_specs)
    from repro_torch.launch.shardings import shard_tensor, sharded_axes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = proc_kernels()
    specs = train_specs(cfg, mesh)
    module = shards[0]
    whole = [k for k, spec in specs.items()
             if "model" not in sharded_axes(mesh, spec)]
    peers = []

    def faulty(i, g):
        if fault_peers:
            peers.append({k: digest(torch, g[k]) for k in whole})
        return grad_stats(torch, mesh, specs, g, want["grads"][0])

    with plant():
        state = init_train_state(module)
        step = make_train_step(cfg, mesh, proc_train_options(F32_PROC_STEPS),
                               device=DEVICE)
        with GradSpy(update=False, on_grads=faulty) as spy:
            step(state, train_batches(cfg, batch, seq, 1)[0])
        fault = spy.grads[0]
        del state, step, spy
    free(torch)
    # copies, also where the parameters already lie on the host
    init = {k: p.detach().to("cpu", copy=True)
            for k, p in module.named_parameters()}
    launches = []

    def each(i, run):
        reset_launches(kernels)
        res = run()
        torch.cuda.synchronize()
        launches.append(read_launches(kernels))
        return res

    watched = []

    def on_grads(i, g):
        if watch is not None:
            watched.append(g[watch[0]].detach().to("cpu", copy=True))
        return grad_stats(torch, mesh, specs, g, want["grads"][i])

    with GradSpy(on_grads=on_grads) as spy, RouteRecorder() as rec:
        res = train(each_step=each)
    grads, card = spy.grads, card_used_gb(torch)
    free(torch)   # the steps' cached blocks, before the reading below

    def worst(t, mask):
        # the largest of ``t`` (never negative) where ``mask`` holds, with
        # no index tensor (a boolean index takes 16 bytes an element)
        return float(torch.where(mask, t, torch.zeros_like(t)).max()) \
            if mask.any() else 0.0

    other = "dp" if noise_unit == "process" else "process"
    params = {}
    for k, p in module.named_parameters():
        w = shard_tensor(want["final"][k], specs[k], mesh)
        p = p.detach()
        x = init.pop(k)
        # a leaf initialised at zero (LayerNorm and MLP biases) holds its
        # updates alone, so its tensor's largest value is the rate's
        # scale, not a parameter's: a strict 1e-5 of it would hold Adam's
        # normalised step to 1e-5 of itself, below the f32 noise of the
        # gradient sums; its elements join the noise class (their ratio
        # read as 0) and their strict reading is kept apart
        zero = not bool(x.any())
        mine = [shard_tensor(g[k], specs[k], mesh) for g in want["grads"]]
        # each step's largest oracle gradient of the slice that is this
        # process's, or with ``noise_unit="dp"`` its DP rank's (its model
        # peers' slices together); no |g| copy of a whole
        unit = {"process": specs[k], "dp": tuple(
            None if e == "model" else e for e in specs[k])}
        tops = {u: [torch.maximum(*(lambda lo, hi: (hi, -lo))(
            *torch.aminmax(shard_tensor(g[k], spec, mesh)))).clamp(
                min=1e-30) for g in want["grads"]]
            for u, spec in unit.items()}
        lo, hi = torch.aminmax(w)
        e = {"strict": 0.0, "largest": float(torch.maximum(hi, -lo)),
             "noise": 0.0, "n_noise": 0, "n": p.numel(),
             "scan": dict.fromkeys(NOISE_GRAD_SCAN, 0.0),
             "strict_other_unit": 0.0, "skipped": 0.0, "flipped": 0.0,
             "zero_init": zero, "zero_init_strict": 0.0}
        best, at = -1.0, 0
        # elementwise, a block of rows at a time: a [151655, 896] table's
        # temporaries on 16 processes at once overflow the card (phase 13)
        row = p[0].numel()
        step = max(1, (1 << 22) // row)
        for r in range(0, p.shape[0], step):
            n = min(step, p.shape[0] - r)
            # each element's oracle gradient over its slice's largest, the
            # largest over the steps
            ratios = {u: torch.stack([m.narrow(0, r, n).abs() / top
                                      for m, top in zip(mine, tops[u])])
                      .amax(0) for u in unit}
            if zero:
                ratios = {u: torch.zeros_like(t) for u, t in ratios.items()}
            ratio = ratios[noise_unit]
            noise = ratio <= NOISE_GRAD
            pc, wc = p.narrow(0, r, n), w.narrow(0, r, n)
            xc = x.narrow(0, r, n).to(p.device)
            d = (pc - wc).abs()
            for key, t, mask in (
                    ("strict", d, ~noise), ("noise", d, noise),
                    ("strict_other_unit", d, ratios[other] > NOISE_GRAD),
                    ("skipped", (xc - wc).abs(), noise),
                    ("flipped", (2 * xc - pc - wc).abs(), noise)):
                e[key] = max(e[key], worst(t, mask))
            for t in NOISE_GRAD_SCAN:
                e["scan"][t] = max(e["scan"][t], worst(d, ratio > t))
            if zero:
                e["zero_init_strict"] = max(e["zero_init_strict"],
                                            float(d.max()))
            e["n_noise"] += int(noise.sum())
            # the worst strict element (the first of equals, as argmax)
            strict = torch.where(noise, torch.zeros_like(d), d).reshape(-1)
            i = int(strict.argmax())
            if float(strict[i]) > best:
                best, at = float(strict[i]), r * row + i
            del ratios, ratio, noise, pc, wc, xc, d, strict
        # the worst strict element: its gradient ratio, each step's oracle
        # gradient over its slice's largest, and the two updates
        idx = tuple(int(j) for j in np.unravel_index(at, tuple(p.shape)))
        e["worst_at"] = {
            "ratio": float(torch.stack([m[idx].abs() / top for m, top in
                                        zip(mine, tops[noise_unit])])
                           .amax()),
            "oracle_grads": [float(m[idx] / top) for m, top in
                             zip(mine, tops["process"])],
            "update": float(p[idx].cpu() - x[idx]),
            "oracle_update": float(w[idx].cpu() - x[idx])}
        if watch is not None and watch[0] == k:
            e["watch"] = watch_element(torch, mesh, specs[k], want, k, p, x,
                                       watched, watch[1], idx)
        params[k] = e
        del x, tops
    # release the parent's tensors now, not at this process's exit, so the
    # parent sees them released before it exits
    want.clear()
    w = mine = None
    gc.collect()
    return {"rank": mesh.rank, "metrics": res["metrics"], "grads": grads,
            "fault": fault, "fault_peers": peers, "coords": mesh.rank_coords,
            "params": params, "launches": launches,
            "routes": [e.cpu() for e in rec.eids], "card_gb": card}


def watch_element(torch, mesh, spec, want, k, p, x, watched, where, worst):
    """``f32_proc_child``'s watched element of leaf ``k``: its global
    index ``where`` (None: this process's worst strict element, local index
    ``worst``); its synced gradient each step (``watched``: this process's
    copies) beside the oracle's, its update beside the oracle's; None where
    this process does not hold it."""
    from repro_torch.launch.shardings import _slices

    full = tuple(want["final"][k].shape)
    starts = [sl.start or 0 for sl in _slices(full, spec, mesh,
                                              mesh.rank_coords)]
    where = tuple(a + i for a, i in zip(starts, worst)) if where is None \
        else tuple(int(i) for i in where)
    local = tuple(g - a for g, a in zip(where, starts))
    if not all(0 <= i < n for i, n in zip(local, p.shape)):
        return None
    return {"index": list(where), "rank": mesh.rank,
            "grads": [float(g[local]) for g in watched],
            "oracle_grads": [float(m[k][where]) for m in want["grads"]],
            "init": float(x[local]),
            "update": float(p[local].cpu() - x[local]),
            "oracle_update": float(want["final"][k][where].cpu() - x[local])}


def rel_norms(stats):
    """Each gradient's relative norm from every process's ``grad_stats``:
    sharded gradients summed over the processes, replicated ones rank
    0's."""
    out = {}
    for k, (d, w, sharded) in stats[0].items():
        if sharded:
            d, w = (sum(s[k][i] for s in stats) for i in (0, 1))
        out[k] = (d ** 0.5) / (w ** 0.5 + 1e-30)
    return out


def train_procs_f32_gate(torch, kernels, shape=PROC_MESH,
                         label="train-procs", plant=pmean_local,
                         fault_name="pmean's backward a local 1 / n",
                         batch=TRAIN_BATCH, noise_unit="process", cfg=None,
                         seq=F32_TRAIN_SEQ, watch=None, outs=None):
    """Phase 9 (b): 1 layer in f32 (``cfg``, default megatron-moe-32e's;
    phase 13's internvl2-1b and whisper-tiny), ``batch`` (TRAIN_BATCH) x
    ``seq`` (F32_TRAIN_SEQ) tokens, F32_PROC_STEPS steps on the processes
    of ``shape`` (phases 11 (c), 12 (b) and 13: with TP over "model", and
    their own planted faults ``plant``) against the stacked oracle on the
    same DP shape:
    metrics within a relative 1e-5, every gathered gradient within a
    relative norm of 1e-4, every parameter after the last step within 1e-5
    of its tensor's largest value (those at the gradients' noise floor,
    ``NOISE_GRAD`` of the largest of the slice that ``noise_unit`` names,
    within ``NOISE_STEP`` x the peak rate), a routing difference only at
    a near tie; the planted fault must fail the gradient gate and the two
    planted controls the parameter gate.  ``noise_unit`` is "process" (a
    process's slice: phases 9 and 11) or "dp" (a DP rank's, its model
    peers' slices together: phase 12, where a process's slice of the
    vocabulary is 1/16 of it); the other unit's reading is logged.  A
    leaf initialised at zero (an encoder-decoder's LayerNorm and MLP
    biases) holds its updates alone: its elements join the noise class
    (``f32_proc_child``), their strict reading is logged.  ``watch`` reaches
    ``f32_proc_child``; ``outs``, a list, receives the processes' results
    before the gates read them."""
    from repro_torch.launch.train import train_procs

    cfg = cfg or train_config(n_layers=1, compute_dtype="float32")
    oracle, want = f32_gate_oracle(torch, kernels, cfg, batch, seq, shape)
    res = train_procs(cfg, [stack_params(torch, cfg, train=True)],
                      proc_data(cfg, batch, seq), shape,
                      PROC_BACKEND, DEVICE,
                      proc_train_options(F32_PROC_STEPS), F32_PROC_STEPS,
                      hook=functools.partial(f32_proc_child, want=want,
                                             plant=plant, batch=batch,
                                             noise_unit=noise_unit, seq=seq,
                                             watch=watch),
                      timeout=PROC_TIMEOUT_S, join_timeout=PROC_JOIN_S)
    del want
    free(torch)
    torch.cuda.ipc_collect()  # the oracle's tensors the processes mapped
    if outs is not None:
        outs.append(res)
    return f32_gate_check(torch, oracle, res["ranks"], res["metrics"],
                          shape, label, fault_name, batch, seq, cfg,
                          noise_unit)


def f32_gate_oracle(torch, kernels, cfg, batch, seq, shape):
    """The f32 gate's stacked oracle on ``shape``'s DP shape, and ``want``
    (its gradients each step and final parameters, on the card), which
    ``f32_proc_child`` takes."""
    oracle = local_oracle(torch, cfg, batch, seq, F32_PROC_STEPS, kernels,
                          keep=True, shape=shape[:2] + (1,))
    return oracle, {"grads": oracle.pop("grads"),
                    "final": oracle.pop("final")}


def f32_gate_check(torch, oracle, outs, metrics, shape, label, fault_name,
                   batch, seq, cfg, noise_unit):
    """``train_procs_f32_gate``'s gates on the processes' ``outs``
    (``f32_proc_child``'s) and rank 0's step ``metrics``."""
    metric_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                     for a, b in zip(metrics, oracle["metrics"])
                     for k in ("loss", "nll", "aux", "grad_norm", "lr"))
    grad_errs = [rel_norms([o["grads"][i] for o in outs])
                 for i in range(F32_PROC_STEPS)]
    worst_grad = max(max(e.values()) for e in grad_errs)
    worst_key = max(grad_errs[0], key=grad_errs[0].get)
    fault = rel_norms([o["fault"] for o in outs])
    fault_key = max(fault, key=fault.get)

    def over_largest(get):
        return max(max(get(o["params"][k]) for o in outs)
                   / max(o["params"][k]["largest"] for o in outs)
                   for k in outs[0]["params"])

    def most(key):
        return max(o["params"][k][key] for o in outs for k in o["params"])

    param_err = over_largest(lambda e: e["strict"])
    other_err = over_largest(lambda e: e["strict_other_unit"])
    worst_param = max(((o["params"][k]["strict"] / o["params"][k]["largest"],
                        k, o["rank"], o["params"][k]["worst_at"])
                       for o in outs for k in o["params"]),
                      key=lambda e: e[0])
    scan = {t: over_largest(lambda e: e["scan"][t]) for t in NOISE_GRAD_SCAN}
    noise_err, skipped, flipped = most("noise"), most("skipped"), \
        most("flipped")
    n_noise = sum(o["params"][k]["n_noise"] for o in outs
                  for k in o["params"])
    n_elems = sum(o["params"][k]["n"] for o in outs for k in o["params"])
    rate = proc_train_options(F32_PROC_STEPS).peak_lr
    # one process of each DP rank (model peers route the same rows)
    routes = [torch.cat([o["routes"][i] for o in outs[::shape[2]]])
              for i in range(len(oracle["routes"]))]
    flips, n_dec, tie = near_tie_flips(torch, oracle["routes"], routes,
                                       oracle["margins"], batch)
    launches_equal = all(o["launches"] == oracle["launches"] for o in outs)
    zero = sorted({k for o in outs for k, e in o["params"].items()
                   if e["zero_init"]})
    zero_err = max((max(o["params"][k]["zero_init_strict"] for o in outs)
                    / max(o["params"][k]["largest"] for o in outs)
                    for k in zero), default=0.0)
    log(f"{label}[f32]: {cfg.name}, {cfg.n_layers} layer(s), {batch} x "
        f"{seq} tokens, "
        f"{F32_PROC_STEPS} steps on {len(outs)} processes {shape} against "
        f"the stacked oracle (the noise class measured against the largest "
        f"of {'a process' if noise_unit == 'process' else 'a DP rank'}'s "
        f"slice): "
        f"metrics max rel diff {metric_err:.3e} (limit 1e-5); gradients, "
        f"relative norm of the gathered whole, worst {worst_grad:.3e} "
        f"(limit 1e-4; step 0's worst {worst_key} "
        f"{grad_errs[0][worst_key]:.3e}); parameters after step "
        f"{F32_PROC_STEPS} within {param_err:.3e} of each tensor's largest "
        f"value (limit 1e-5), but the {n_noise} of {n_elems} elements "
        f"whose oracle gradients stay within {NOISE_GRAD} of their slice's "
        f"largest, within {noise_err:.3e} = {noise_err / rate:.4f} x the "
        f"peak rate (limit {NOISE_STEP})"
        + (f", {len(zero)} leaves initialised at zero among them (their "
           f"strict reading, over each tensor's largest: {zero_err:.3e})"
           if zero else "")
        + f"; {flips} of {n_dec} routing "
        f"decisions differ, "
        f"each sequence's first at an oracle margin of at most {tie:.3e} "
        f"(near-tie limit {NEAR_TIE}); launches equal to the oracle's "
        f"{launches_equal}; the card {max(o['card_gb'] for o in outs):.2f} "
        f"GB in use after the steps")
    log(f"{label}[f32 noise class]: the worst element outside it, over "
        "its tensor's largest, if NOISE_GRAD were " + ", ".join(
            f"{t}: {v:.3e}" for t, v in scan.items()) + " (limit 1e-5); "
        f"it lies in {worst_param[1]} (rank {worst_param[2]}) at "
        f"{worst_param[0]:.3e}: {json.dumps(worst_param[3])}; with the "
        f"class measured against the largest of "
        f"{'a DP rank' if noise_unit == 'process' else 'a process'}'s "
        f"slice instead of {'a process' if noise_unit == 'process' else 'a DP rank'}'s "
        f"(reported): {other_err:.3e}")
    refused = min(skipped, flipped) > NOISE_STEP * rate
    log(f"{label}[f32 planted controls]: the noise class's update "
        f"skipped {skipped / rate:.4f} x the rate, its sign flipped "
        f"{flipped / rate:.4f} x: the gate (limit {NOISE_STEP}) "
        f"{'refuses both' if refused else 'PASSES one'}")
    log(f"{label}[f32 planted fault]: {fault_name}: "
        f"step 0's worst gradient {fault_key} at a relative norm of "
        f"{fault[fault_key]:.3e}: the gate (1e-4) "
        f"{'refuses' if fault[fault_key] > 1e-4 else 'PASSES'} it")
    if not (metric_err <= 1e-5 and worst_grad <= 1e-4 and param_err <= 1e-5
            and noise_err <= NOISE_STEP * rate and tie <= NEAR_TIE
            and launches_equal):
        raise AssertionError(f"{label}[f32]: metrics {metric_err}, "
                             f"gradients {worst_grad}, parameters "
                             f"{param_err} (at the noise floor {noise_err}), "
                             f"routing tie {tie}, launches equal "
                             f"{launches_equal}")
    if not fault[fault_key] > 1e-4:
        raise AssertionError(f"{label}[f32]: the planted fault "
                             f"({fault_name}) passes the gradient gate")
    if not refused:
        raise AssertionError(f"{label}[f32]: a planted control on the "
                             f"noise class's update passes the parameter "
                             f"gate (skipped {skipped}, flipped {flipped})")
    return {"metric_err": metric_err, "grad_err": worst_grad,
            "param_err": param_err, "noise_floor_param_err": noise_err,
            "noise_floor_rate_share": noise_err / rate,
            "noise_floor_elements": n_noise,
            "zero_init_leaves": len(zero), "zero_init_strict_err": zero_err,
            "strict_err_by_noise_grad": {str(t): v for t, v in scan.items()},
            "planted_controls": {"skipped": skipped / rate,
                                 "flipped": flipped / rate},
            "routing_differs": flips,
            "first_difference_margin": tie,
            "planted_fault": {fault_key: fault[fault_key]}}


def state_tensors(state):
    """A train state's parameters and moments by ``params/``, ``m/`` and
    ``v/`` + parameter name."""
    out = {f"params/{k}": p for k, p in state["params"].named_parameters()}
    out.update({f"m/{k}": t for k, t in state["opt"].m.items()})
    out.update({f"v/{k}": t for k, t in state["opt"].v.items()})
    return out


def trainer_child(mesh, cfg, shards, train, root):
    """One rank of phase 9 (c): ``train()`` is the Trainer's unbroken run
    (``train_procs`` with a checkpoint directory); then the Trainer over
    the processes for half the steps (its checkpoint written by the 4
    processes) and a resume to the end, on a fresh shard of the same
    initial parameters.  Returns the largest difference of the two runs'
    parameters (over each slice's largest value) and, on rank 0, the
    unbroken run's parameters gathered."""
    from repro_torch.convert import recast
    from repro_torch.launch.shardings import gather_tensor
    from repro_torch.launch.train import (init_train_state, make_train_step,
                                          train_specs)
    from repro_torch.runtime import Trainer, TrainerConfig

    specs = train_specs(cfg, mesh)
    init = {k: v.detach().clone() for k, v in shards[0].named_parameters()}
    unbroken = shards[0]
    train()
    step = make_train_step(cfg, mesh, proc_train_options(TRAINER_PROC_STEPS),
                           device=DEVICE)
    batches = train_batches(cfg, 8, 32, TRAINER_PROC_STEPS)

    def init_state():
        return init_train_state(recast({k: v.clone() for k, v in
                                        init.items()}, cfg, train=True))

    def gathered(state):
        return {k: gather_tensor(t.detach(), specs[k.split("/", 1)[1]],
                                 mesh).cpu()
                for k, t in state_tensors(state).items()}

    half = TRAINER_PROC_STEPS // 2
    runs = [Trainer(TrainerConfig(total_steps=total, ckpt_dir=f"{root}/b",
                                  ckpt_every=every), step, init_state,
                    batches.__getitem__, mesh=mesh, specs=specs).run()
            for total, every in ((half, half), (TRAINER_PROC_STEPS, 100))]
    at_half, b = gathered(runs[0]["state"]), runs[1]
    fa = {k: p.detach() for k, p in unbroken.named_parameters()}
    errs = {k: float((p.detach() - fa[k]).abs().max() / fa[k].abs().max())
            for k, p in b["state"]["params"].named_parameters()}
    whole = {k: gather_tensor(p, specs[k], mesh).cpu() for k, p in fa.items()}
    return {"rank": mesh.rank, "stopped": (b["stopped_at"],
                                           int(b["state"]["step"])),
            "resume_err": max(errs.values()),
            "unbroken": whole if mesh.rank == 0 else None,
            "at_half": at_half if mesh.rank == 0 else None}


def train_procs_trainer_gate(torch):
    """Phase 9 (c): the Trainer on 4 processes at smoke size (f32): a
    checkpoint at half the steps, a resume, within 1e-6 of an unbroken run;
    that checkpoint restored on a LocalMesh bit for bit (the processes'
    state at half the steps, gathered) and trained to the end: its last
    loss within a relative 1e-5 of the processes' unbroken run and its
    parameters within a relative norm of 1e-5 (the meshes sum gradients in
    other orders, and Adam moves an element whose gradient lies at that
    noise floor by up to its step size)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import (init_train_state, make_train_step,
                                          train_procs)
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = smoke_config(ARCH, compute_dtype="float32")
    half = TRAINER_PROC_STEPS // 2

    def local_state():
        return init_train_state(stack_params(torch, cfg, train=True))

    with tempfile.TemporaryDirectory() as root:
        res = train_procs(cfg, [stack_params(torch, cfg, train=True)],
                          proc_data(cfg, 8, 32), PROC_MESH, PROC_BACKEND,
                          DEVICE, proc_train_options(TRAINER_PROC_STEPS),
                          TRAINER_PROC_STEPS, ckpt_dir=f"{root}/a",
                          hook=functools.partial(trainer_child, root=root),
                          timeout=PROC_TIMEOUT_S, join_timeout=PROC_JOIN_S)
        outs = res["ranks"]
        src = os.path.join(root, "b", f"step_{half:09d}")
        os.makedirs(f"{root}/c")
        shutil.copytree(src, os.path.join(root, "c", f"step_{half:09d}"))
        restored, at = restore_checkpoint(f"{root}/c", local_state())
        same = at == half and all(
            torch.equal(t.detach().cpu(), outs[0]["at_half"][k])
            for k, t in state_tensors(restored).items())
        del restored
        mesh = make_mesh(PROC_MESH, AXES, torch.device(DEVICE))
        step = make_train_step(cfg, mesh, proc_train_options(
            TRAINER_PROC_STEPS), device=DEVICE)
        batches = train_batches(cfg, 8, 32, TRAINER_PROC_STEPS)
        local = Trainer(TrainerConfig(total_steps=TRAINER_PROC_STEPS,
                                      ckpt_dir=f"{root}/c", ckpt_every=100),
                        step, local_state, batches.__getitem__,
                        mesh=mesh).run()
    want = outs[0]["unbroken"]
    got = {k: p.detach().cpu() for k, p in
           local["state"]["params"].named_parameters()}
    local_norm = max(float((got[k] - w).norm() / w.norm())
                     for k, w in want.items())
    local_max = max(float((got[k] - w).abs().max() / w.abs().max())
                    for k, w in want.items())
    loss_err = abs(local["metrics"]["loss"] - res["metrics"]["loss"]) \
        / abs(res["metrics"]["loss"])
    resume_err = max(o["resume_err"] for o in outs)
    stopped = {o["stopped"] for o in outs}
    log(f"train-procs[trainer]: smoke {cfg.name} (f32) on 4 processes, "
        f"{TRAINER_PROC_STEPS} steps unbroken against {half} + the 4 "
        f"processes' checkpoint + a resume: stopped at {sorted(stopped)} "
        f"(step, state step); parameters within {resume_err:.3e} of each "
        f"slice's largest value (limit 1e-6); that checkpoint restored on "
        f"LocalMesh{PROC_MESH} bit for bit {same}, trained to step "
        f"{local['stopped_at']}: last loss {local['metrics']['loss']:.6f} "
        f"against the processes' {res['metrics']['loss']:.6f} (relative "
        f"{loss_err:.3e}, limit 1e-5), parameters within a relative norm of "
        f"{local_norm:.3e} (limit 1e-5; largest element difference "
        f"{local_max:.3e} of its tensor's largest value)")
    if not (stopped == {(TRAINER_PROC_STEPS, TRAINER_PROC_STEPS)}
            and resume_err <= 1e-6 and same and loss_err <= 1e-5
            and local_norm <= 1e-5
            and local["stopped_at"] == TRAINER_PROC_STEPS):
        raise AssertionError(f"train-procs[trainer]: stopped {stopped}, "
                             f"resume {resume_err}, restored bit for bit "
                             f"{same}, loss {loss_err}, parameters "
                             f"{local_norm}")
    return {"resume_err": resume_err, "restored_bit_identical": same,
            "local_loss_err": loss_err, "local_param_norm_err": local_norm,
            "local_param_max_err": local_max}

# Ratios of the redesigned kernels to their library calls that the bf16
# serving and training shapes should stay under (reported, not gated: a
# card below its power limit moves them).  Pack and unpack: device time at most the
# library call's at every serving shape, at most 1.15x the bound at
# mixtral's prefill, and one call per event pair at most 1.2x the library
# call's at decode.
# -- 10. the split island on one process per rank -----------------------------

def split_config(**over):
    """mixtral-8x7b at its published widths, depth cut to SPLIT_LAYERS."""
    from repro_torch.configs import get_config

    return get_config(MIX_ARCH, **{"n_layers": SPLIT_LAYERS, **over})


def ranks_of(shape):
    return int(np.prod(shape))


def moe_input(torch, cfg, batch, prompt, dtype):
    """Phase 10's identical MoE input: every row made on the device from
    the seed (each process makes them all and keeps its own)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    return (torch.randn((batch, prompt, cfg.d_model), generator=gen,
                        device=DEVICE) * 0.3).to(dtype)


def digest(torch, t) -> str:
    """The sha256 of a tensor's bytes: two tensors with equal digests are
    equal bit for bit."""
    import hashlib

    raw = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()


class GridSpy:
    """While active, keeps every token grid ``_expert_ffn`` runs on and
    every output of the split island's exchanges (the dispatch, then the
    return trip)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.grids, self.exchanged = moe, [], []

    def __enter__(self):
        self.ffn, self.exchange = self.moe._expert_ffn, \
            self.moe._pod_ep_exchange

        def ffn(cfg, w_gate, w_up, w_down, tokens, *args, **kw):
            self.grids.append(tokens.detach().clone())
            return self.ffn(cfg, w_gate, w_up, w_down, tokens, *args, **kw)

        def exchange(*args):
            fn = self.exchange(*args)

            def run(buf):
                out = fn(buf)
                self.exchanged.append(out.detach().clone())
                return out
            return run

        self.moe._expert_ffn, self.moe._pod_ep_exchange = ffn, exchange
        return self

    def __exit__(self, *exc):
        self.moe._expert_ffn, self.moe._pod_ep_exchange = self.ffn, \
            self.exchange


def grid_slice(grid, n_exp, ep, shape, coords):
    """The ``LocalMesh`` grid ``[E, R * C, d]``'s rows of the rank at
    ``coords`` (pod, data, ...): its EP coordinate's ``E_loc`` experts and
    the block of its other DP coordinates, ``[E_loc, p * C, d]`` (the
    layout of ``models/moe._moe_pod_ep``)."""
    dp = ("pod", "data")
    sizes, where = dict(zip(dp, shape[:2])), dict(zip(dp, coords[:2]))
    others = [a for a in dp if a != ep]
    if ep:
        e_loc = n_exp // sizes[ep]
        experts = slice(where[ep] * e_loc, (where[ep] + 1) * e_loc)
    else:
        experts = slice(None)
    g = grid.reshape(n_exp, *[sizes[a] for a in others], -1, grid.shape[-1])
    return g[(experts, *[where[a] for a in others])]


def island_runs(torch, cfg, layer, x, mesh, plan, runs):
    """The first MoE layer on ``x`` through each of ``runs`` ({name: (impl,
    int8)}) on ``mesh``: per run the output, the routing, the token grid
    and the exchanges' outputs (kept, on the device)."""
    from repro_torch.launch.serve import make_dist_context
    from repro_torch.models.moe import moe_apply

    out = {}
    for name, (impl, quant) in runs.items():
        c = dataclasses.replace(cfg, quantized_dispatch=quant)
        dist = make_dist_context(c, mesh, impl, plan if impl == "plan"
                                 else None)
        with torch.no_grad(), GridSpy() as spy, RouteRecorder() as rec:
            y = moe_apply(c, layer, x, dist)[0]
        out[name] = {"y": y, "eids": rec.eids[0], "grid": spy.grids[0],
                     "exchanged": spy.exchanged}
    return out


def island_digests(torch, runs):
    """A process's ``island_runs``: its grids' and exchanges' digests, its
    routing, and its output's digest."""
    return {name: {"grid": digest(torch, r["grid"]),
                   "exchanged": [digest(torch, e) for e in r["exchanged"]],
                   "eids": r["eids"].cpu(), "y": digest(torch, r["y"]),
                   "grid_shape": tuple(r["grid"].shape)}
            for name, r in runs.items()}


def oracle_digests(torch, runs, n_exp, ep, shape):
    """The stacked ``island_runs``' digests of each rank's slice: {name:
    [per rank {grid, exchanged, eids, y}]}."""
    coords = np.stack(np.unravel_index(np.arange(ranks_of(shape)), shape),
                      axis=1)
    out = {}
    for name, r in runs.items():
        per = []
        b = r["y"].shape[0] // len(coords)
        for rank, c in enumerate(coords):
            g = grid_slice(r["grid"], n_exp, ep, shape, tuple(c))
            per.append({"grid": digest(torch, g),
                        "exchanged": [digest(torch, e[rank:rank + 1])
                                      for e in r["exchanged"]],
                        "eids": r["eids"][rank:rank + 1].cpu(),
                        "y": digest(torch, r["y"][rank * b:(rank + 1) * b]),
                        "grid_shape": tuple(g.shape)})
        out[name] = per
    return out


def check_island(outs, want, label, key="island"):
    """Every process's routing, token grid and exchanges (and, reported,
    its output) bit for bit against its slice of the stacked run's."""
    bits_y = True
    for o in outs:
        for name, mine in o[key].items():
            ref = want[name][o["rank"]]
            if not bool((mine["eids"] == ref["eids"]).all()):
                raise AssertionError(f"{label}: rank {o['rank']} routed the "
                                     f"identical input apart ({name})")
            if (mine["grid"], mine["grid_shape"]) != (ref["grid"],
                                                      ref["grid_shape"]):
                raise AssertionError(
                    f"{label}: rank {o['rank']}'s token grid "
                    f"{mine['grid_shape']} differs from the stacked grid's "
                    f"slice {ref['grid_shape']} ({name})")
            if mine["exchanged"] != ref["exchanged"]:
                raise AssertionError(f"{label}: rank {o['rank']}'s "
                                     f"exchanges differ from the stacked "
                                     f"ones ({name})")
            bits_y &= mine["y"] == ref["y"]
    first = outs[0][key]
    return {name: {"grid_shape": first[name]["grid_shape"],
                   "exchanges": len(first[name]["exchanged"])}
            for name in first}, bits_y


def split_child(mesh, cfg32, shards, rows, serve_cli, plan, runs):
    """One rank of phase 10 (a), the per-rank hook of ``serve_procs``: the
    f32 serve of its shard (``serve_procs``' own, prefill and 15 greedy
    steps on the short prompts) with its routing recorded; then the bf16
    serving of its 4 prompts of 1024 tokens through the plan, the rotation
    (``flash``) and int8 dispatch; the first MoE layer on the identical
    input through ``runs``; the exchange's share of a traced prefill and
    the first layer.  Returns host tensors and digests."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.convert import recast
    from repro_torch.launch.serve import make_prefill_step

    kernels = proc_kernels()
    cfg = split_config()
    r, n = mesh.rank, ranks_of(mesh.shape)
    out = {"rank": r, "used_gb": {}, "shard_gb": param_gb(shards[0]),
           "experts": int(shards[0].blocks[0].moe.w_gate.shape[0])}
    out["used_gb"]["after the parent's drop"] = card_used_gb(torch)
    torch.cuda.reset_peak_memory_stats()

    with RouteRecorder() as rec:         # the prefill's, then each step's
        serve_cli()
    out["f32_routes"] = [e.cpu() for e in rec.eids[:len(rec.eids) // GEN]]

    shard = recast(shards.pop(), cfg)
    free(torch)
    b = SPLIT_BATCH // n
    prompts = stack_prompts(torch, cfg, SPLIT_BATCH, MIX_PROMPT)[
        r * b:(r + 1) * b]
    run = serve(torch, cfg, shard, mesh, "plan", plan, prompts, kernels,
                record=True)
    out["used_gb"]["serving"] = card_used_gb(torch)
    keep = ("prefill_s", "decode_s", "decode_steps", "step_ms_median",
            "step_ms_max", "prefill_launches", "decode_launches",
            "prefill_variants", "decode_variants")
    out["serve"] = {k: run[k] for k in keep}
    out["serve"].update(logits=run["logits"].cpu(),
                        last_logits=run["last_logits"].cpu(),
                        tokens=run["tokens"].cpu(),
                        routes=[e.cpu() for e in run["routes"]])
    rot = serve(torch, cfg, shard, mesh, "flash", None, prompts, kernels,
                warmup=False)
    out["flash_equal"] = (bool(torch.equal(rot["logits"], run["logits"])),
                          bool(torch.equal(rot["tokens"], run["tokens"])))
    out["flash"] = {k: rot[k] for k in keep}
    del rot
    cfg_q = dataclasses.replace(cfg, quantized_dispatch=True)
    quant = serve(torch, cfg_q, shard, mesh, "plan", plan, prompts, kernels,
                  decode=False, record=True)
    out["int8"] = {"prefill_s": quant["prefill_s"],
                   "prefill_launches": quant["prefill_launches"],
                   "prefill_variants": quant["prefill_variants"],
                   "logits": quant["logits"].cpu(),
                   "routes": [e.cpu() for e in quant["routes"]]}
    del quant, run
    free(torch)

    x = moe_input(torch, cfg, SPLIT_BATCH, MIX_PROMPT, torch.bfloat16)[
        r * b:(r + 1) * b]
    isl = island_runs(torch, cfg, shard.blocks[0].moe, x, mesh, plan, runs)
    out["island"] = island_digests(torch, isl)
    exact, q = isl["plan"]["y"].float(), isl["int8"]["y"].float()
    out["int8_layer"] = (float((q - exact).abs().max()),
                         float(exact.abs().max()))
    del isl, x, exact, q
    free(torch)

    prefill = make_prefill_step(cfg, mesh, "plan", plan,
                                cache_len=MIX_PROMPT + GEN, device=DEVICE)
    out["exchange"] = exchange_share(torch, prefill, shard,
                                     {"tokens": prompts})
    attn, y, eids = first_layer(torch, cfg, shard, mesh, plan, prompts)
    out["first_layer"] = (attn.cpu(), y.cpu(), eids.cpu())
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def split_gates(torch, outs, loc32, loc, loc_first, res, label):
    """Phase 10 (a)'s gates on the processes' results against the stacked
    oracles: the f32 prefill and greedy tokens, bf16 routing and tokens,
    launches, the rotation against the plan, the first layer."""
    n = len(outs)
    b = SPLIT_BATCH // n
    err32 = rel_err(torch, res["logits"][0], loc32["logits"].cpu())
    routes32 = [torch.cat([o["f32_routes"][i] for o in outs])
                for i in range(len(loc32["routes"]))]
    flips32, n_dec, tie = near_tie_flips(torch, loc32["routes"], routes32,
                                         loc32["margins"], SPLIT_BATCH)
    same32 = bool(torch.equal(res["tokens"], loc32["tokens"].cpu()))
    log(f"{label}[f32]: serve_procs' prefill logits ({SPLIT_BATCH} x "
        f"{F32_PROMPT} tokens) gathered on rank 0, max rel diff "
        f"{err32:.3e} against LocalMesh (limit 1e-4); {flips32} of {n_dec} "
        f"routing decisions differ, each sequence's first at an oracle "
        f"margin of at most {tie:.3e} (near-tie limit {NEAR_TIE}); greedy "
        f"tokens of the prefill and {GEN - 1} decode steps equal {same32}")
    if not (err32 < 1e-4 and tie <= NEAR_TIE and same32):
        raise AssertionError(f"{label}: f32 prefill {err32}, {flips32} "
                             f"routing decisions differ, the first at a "
                             f"margin of {tie}; greedy tokens equal {same32}")
    summary = {"f32": {"max_rel_diff": err32, "routing_differs": flips32,
                       "first_difference_margin": tie,
                       "tokens_equal": same32}}

    logits = torch.cat([o["serve"]["logits"] for o in outs])
    tokens = torch.cat([o["serve"]["tokens"] for o in outs])
    routes = [torch.cat([o["serve"]["routes"][i] for o in outs])
              for i in range(len(loc["routes"]))]
    n_flip, n_dec, per_layer, per_seq = route_flips(
        torch, [e.cpu() for e in loc["routes"]], routes, SPLIT_BATCH)
    same_tok = (tokens == loc["tokens"].cpu()).all(-1)
    gaps = token_tie_gaps(torch, loc, tokens, per_seq)
    ties = 0
    for lg in loc["step_logits"]:
        top = lg.float().topk(2, dim=-1).values
        ties += int(((top[:, 0] - top[:, 1]) / lg.float().abs().amax(-1)
                     <= BF16_TOKEN_TIE).sum())
    summary["bf16"] = {
        "max_rel_diff": rel_err(torch, logits, loc["logits"].cpu()),
        "bit_identical": bool(torch.equal(logits, loc["logits"].cpu())),
        "routing_differs": n_flip,
        "sequences_routed_apart": int(per_seq.sum()),
        "sequences_same_tokens": int(same_tok.sum()),
        "routed_alike_token_gaps": gaps}
    log(f"{label}[bf16]: prefill logits max rel diff "
        f"{summary['bf16']['max_rel_diff']:.3e} against LocalMesh "
        f"(bit-identical {summary['bf16']['bit_identical']}); routing "
        f"differs in {n_flip} of {n_dec} (token, layer) decisions (per layer "
        f"{per_layer}), in {int(per_seq.sum())} of {SPLIT_BATCH} sequences "
        f"(at most {PROC_BF16_APART_MAX}); greedy tokens equal in "
        f"{int(same_tok.sum())} of {SPLIT_BATCH} sequences; each sequence "
        f"routed alike whose tokens differ (step, oracle gap over the row's "
        f"largest logit): {gaps} (limit {BF16_TOKEN_TIE}; {ties} of "
        f"{SPLIT_BATCH * GEN} oracle greedy choices lie within it of the "
        f"runner-up)")
    summary["bf16"]["oracle_choices_within_tie"] = ties
    if not (int(per_seq.sum()) <= PROC_BF16_APART_MAX
            and all(g <= BF16_TOKEN_TIE for _, _, g in gaps)):
        raise AssertionError(
            f"{label}: bf16 routed {int(per_seq.sum())} of {SPLIT_BATCH} "
            f"sequences apart (at most {PROC_BF16_APART_MAX}); sequences "
            f"routed alike whose tokens differ first at oracle gaps {gaps} "
            f"(limit {BF16_TOKEN_TIE})")

    want = run_counts(loc)
    a2a = {"prefill": {a2a_instance(split_moved_bytes(b * MIX_PROMPT))},
           "decode": {"vec"}}
    for o in outs:
        sv = o["serve"]
        check_run(torch, sv, split_config(), b, f"{label}[rank {o['rank']}]",
                  SERVE_KERNELS, a2a)
        for part in ("prefill", "decode"):
            got = sv[f"{part}_launches"]
            if got != want[part]:
                raise AssertionError(
                    f"{label}: rank {o['rank']} launched {got} in the "
                    f"{part}; LocalMesh {want[part]}")
        if o["flash_equal"] != (True, True):
            raise AssertionError(f"{label}: rank {o['rank']}'s rotation "
                                 f"(flash) logits and tokens equal to the "
                                 f"plan's {o['flash_equal']}")
        check_variants(o["int8"], f"{label}[rank {o['rank']} int8]",
                       a2a={"prefill": {"vec"}})
    log(f"{label}: every process launched each kernel as often as the "
        f"LocalMesh run (prefill {want['prefill']}, decode "
        f"{want['decode']}), grouped_matmul on TMA alone, pack and unpack on "
        f"{sorted(a2a['prefill'])} in the prefill and vec in decode; the "
        f"rotation's (flash) prefill logits and greedy tokens bit-identical "
        f"to the plan's in every process")

    errs, bits, route_eq = [], [], []
    for o in outs:
        rows = slice(o["rank"] * b, (o["rank"] + 1) * b)
        attn, y, eids = o["first_layer"]
        want_attn, want_y = loc_first[0][rows].cpu(), loc_first[1][rows].cpu()
        errs.append((rel_err(torch, attn, want_attn),
                     rel_err(torch, y, want_y)))
        bits.append(bool(torch.equal(attn, want_attn))
                    and bool(torch.equal(y, want_y)))
        route_eq.append(bool(torch.equal(eids[0],
                                         loc_first[2][o["rank"]].cpu())))
    worst = tuple(max(e[i] for e in errs) for i in range(2))
    log(f"{label}[first layer, bf16, identical inputs]: attention max rel "
        f"diff {worst[0]:.3e}, MoE {worst[1]:.3e} against LocalMesh (limit "
        f"2e-2); routing equal {all(route_eq)}; bit-identical {all(bits)}")
    if not (worst[0] < 2e-2 and worst[1] < 2e-2 and all(route_eq)):
        raise AssertionError(f"{label}: first layer {worst}, routing equal "
                             f"{route_eq}")
    summary["first_layer"] = {"attention": worst[0], "moe": worst[1],
                              "bit_identical": all(bits)}
    return summary


def token_tie_gaps(torch, oracle, tokens, skip):
    """For each sequence not in ``skip`` (a bool per sequence) whose greedy
    ``tokens`` differ from the oracle's: (sequence, the step of its first
    difference, the oracle's logit of its own choice there less its logit
    of the process's, over the row's largest magnitude).  Up to that step
    the two saw the same tokens, so the oracle's logits there score both
    choices: a small gap is a greedy near tie that rounding can flip."""
    want = oracle["tokens"].cpu()
    out = []
    for seq in range(want.shape[0]):
        differ = (tokens[seq] != want[seq]).nonzero()
        if bool(skip[seq]) or not len(differ):
            continue
        t = int(differ[0, 0])
        row = oracle["step_logits"][t][seq].float().cpu()
        gap = float(row[want[seq, t]] - row[tokens[seq, t]]) \
            / float(row.abs().max())
        out.append((seq, t, gap))
    return out


def split_moved_bytes(tokens):
    """The bytes one process's plan pack moves in the prefill: its block
    of each stage and its own block, ``E_loc * C`` bf16 rows each."""
    from repro_torch.models.moe import _capacity

    cfg = split_config()
    e_loc = cfg.moe.num_experts // SPLIT_MESH[0]
    cap = _capacity(cfg, tokens, cfg.moe.num_experts)
    return 2 * e_loc * cap * cfg.d_model * 2


def phase_split_serve(torch, kernels):
    """Phase 10 (a): mixtral-8x7b on 6 processes of (pod 2, data 3, model
    1), EP over ``pod`` alone, against ``LocalMesh((2, 3, 1))``.  Returns
    rank 0's launch counts and a summary."""
    from repro_torch.convert import recast
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import (flash_plan, make_dist_context,
                                          serve_procs)

    cfg = split_config()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    dev = torch.device(DEVICE)
    local = make_mesh(SPLIT_MESH, AXES, dev)
    ep = make_dist_context(cfg, local).ep_axes
    if ep != ("pod",):
        raise AssertionError(f"split[a]: EP axes {ep} on {SPLIT_MESH}")
    plan = flash_plan(SPLIT_MESH[0], SPLIT_MESH[1], SEED)
    n = ranks_of(SPLIT_MESH)
    label = "split[a]"
    log(f"{label}: {cfg.name} layers={cfg.n_layers}/32 at its published "
        f"widths (d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads, d_ff {cfg.d_ff}, {cfg.moe.num_experts} experts top"
        f"{cfg.moe.top_k}, window {cfg.swa_window}) on a {SPLIT_MESH} mesh "
        f"of {n} processes ({PROC_BACKEND}); choose_ep_axes gives {ep}, "
        f"{cfg.moe.num_experts // SPLIT_MESH[0]} experts a process; "
        f"{SPLIT_BATCH} prompts of {MIX_PROMPT} tokens ({SPLIT_BATCH // n} "
        f"a process) and {GEN - 1} decode steps; f32 on {F32_PROMPT}-token "
        f"prompts; {SPLIT_LABEL}")
    summary = {"label": SPLIT_LABEL, "used_gb": {}}

    torch.cuda.reset_peak_memory_stats()
    params32 = stack_params(torch, cfg32)
    summary["f32_params_gb"] = param_gb(params32)
    short = stack_prompts(torch, cfg, SPLIT_BATCH, F32_PROMPT)
    loc32 = serve(torch, cfg32, params32, local, "plan", plan, short,
                  kernels, warmup=False, record="margins")
    params = recast(params32, cfg)
    prompts = stack_prompts(torch, cfg, SPLIT_BATCH, MIX_PROMPT)
    loc = serve(torch, cfg, params, local, "plan", plan, prompts, kernels,
                record=True, keep_logits=True)
    check_run(torch, loc, cfg, SPLIT_BATCH, f"{label}[local oracle]",
              SERVE_KERNELS)
    summary["oracle"] = {"prefill_ms": loc["prefill_s"] * 1e3,
                         "decode_ms_per_step": loc["decode_s"]
                         / loc["decode_steps"] * 1e3,
                         "decode_device_ms_median": loc["step_ms_median"]}
    log(f"{label}[local oracle]: the same bf16 work stacked in one process: "
        f"prefill {summary['oracle']['prefill_ms']:.3f} ms; decode "
        f"{summary['oracle']['decode_ms_per_step']:.3f} ms/step (median "
        f"{loc['step_ms_median']:.3f} ms on the device clock)")
    loc_first = first_layer(torch, cfg, params, local, plan, prompts)
    runs = {"plan": ("plan", False), "flash": ("flash", False),
            "int8": ("plan", True)}
    x = moe_input(torch, cfg, SPLIT_BATCH, MIX_PROMPT, torch.bfloat16)
    isl = island_runs(torch, cfg, params.blocks[0].moe, x, local, plan, runs)
    want = oracle_digests(torch, isl, cfg.moe.num_experts, "pod", SPLIT_MESH)
    exact, q = isl["plan"]["y"].float(), isl["int8"]["y"].float()
    oracle_int8 = rel_err(torch, q, exact)
    del isl, x, exact, q, params
    free(torch)
    summary["parent_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    summary["used_gb"]["parent, whole f32 model"] = card_used_gb(torch)
    log(f"{label}[local oracle]: f32 parameters "
        f"{summary['f32_params_gb']:.2f} GB; parent peak "
        f"{summary['parent_peak_gb']:.2f} GB")

    holder = [params32]
    del params32
    t0 = time.perf_counter()
    res = serve_procs(cfg32, holder, short, SPLIT_MESH, PROC_BACKEND, DEVICE,
                      "plan", plan, GEN, hook=functools.partial(
                          split_child, plan=plan, runs=runs),
                      timeout=PROC_TIMEOUT_S, join_timeout=PROC_JOIN_S)
    summary["processes_s"] = time.perf_counter() - t0
    summary["used_gb"].update(res.get("card_used_gb", {}))
    outs = res["ranks"]
    if [o["experts"] for o in outs] != [cfg.moe.num_experts // 2] * n:
        raise AssertionError(f"{label}: experts a process "
                             f"{[o['experts'] for o in outs]}")

    island, bits_y = check_island(outs, want, label)
    log(f"{label}[identical input, bf16]: in every process the routing, the "
        f"token grid and both exchanges' outputs bit-identical to its slice "
        f"of the stacked run's, through {', '.join(island)} "
        f"({json.dumps(island)}); the layer's output bit-identical "
        f"{bits_y}")
    q_err = max(o["int8_layer"][0] for o in outs) \
        / max(o["int8_layer"][1] for o in outs)
    log(f"{label}[int8 dispatch]: first MoE layer on identical inputs, max "
        f"rel diff to exact {q_err:.3e} on the processes (limit (0, 0.05)); "
        f"the stacked run's own {oracle_int8:.3e}")
    if not 0 < q_err < 0.05:
        raise AssertionError(f"{label}: int8 first MoE layer {q_err}")
    summary.update(split_gates(torch, outs, loc32, loc, loc_first, res,
                               label))
    summary["island"] = {"runs": island, "output_bit_identical": bits_y,
                         "int8_layer_rel_diff": q_err}

    q_logits = torch.cat([o["int8"]["logits"] for o in outs])
    ex_logits = torch.cat([o["serve"]["logits"] for o in outs])
    qr = [torch.cat([o["int8"]["routes"][i] for o in outs])
          for i in range(len(outs[0]["int8"]["routes"]))]
    er = [torch.cat([o["serve"]["routes"][i] for o in outs])
          for i in range(len(qr))]
    n_flip, n_dec, per_layer, per_seq = route_flips(torch, er, qr,
                                                    SPLIT_BATCH)
    summary["int8"] = {"prefill_logits_rel_diff": rel_err(
        torch, q_logits, ex_logits), "routing_differs": n_flip,
        "sequences_routed_apart": int(per_seq.sum())}
    log(f"{label}[int8 dispatch]: prefill logits max rel diff to exact "
        f"{summary['int8']['prefill_logits_rel_diff']:.3e}; routing differs "
        f"in {n_flip} of {n_dec} decisions (per layer {per_layer}), in "
        f"{int(per_seq.sum())} of {SPLIT_BATCH} sequences (reported)")

    for o in outs:
        sv = o["serve"]
        share, n_spans, host_ms = o["exchange"]
        log(f"{label}[rank {o['rank']}]: prefill {sv['prefill_s'] * 1e3:.3f} "
            f"ms; decode {sv['decode_s'] / sv['decode_steps'] * 1e3:.3f} "
            f"ms/step host mean, {sv['step_ms_median']:.3f} ms device median "
            f"over {sv['decode_steps']} steps; rotation prefill "
            f"{o['flash']['prefill_s'] * 1e3:.3f} ms, int8 prefill "
            f"{o['int8']['prefill_s'] * 1e3:.3f} ms; exchange share of a "
            f"traced prefill {share:.4f} ({n_spans} collectives, "
            f"{host_ms:.3f} ms, host staging included); peak "
            f"{o['peak_gb']:.2f} GB (f32 shard {o['shard_gb']:.2f} GB); "
            f"{SPLIT_LABEL}")
    card = dict(summary["used_gb"])
    for o in outs:
        for k, v in o["used_gb"].items():
            card[f"{k} (rank {o['rank']})"] = v
    summary["used_gb"] = card
    summary["card_peak_gb_seen"] = max(card.values())
    summary["ranks"] = [{
        "rank": o["rank"], "prefill_ms": o["serve"]["prefill_s"] * 1e3,
        "decode_ms_per_step": o["serve"]["decode_s"]
        / o["serve"]["decode_steps"] * 1e3,
        "decode_device_ms_median": o["serve"]["step_ms_median"],
        "flash_prefill_ms": o["flash"]["prefill_s"] * 1e3,
        "int8_prefill_ms": o["int8"]["prefill_s"] * 1e3,
        "peak_gb": o["peak_gb"], "exchange_share": o["exchange"][0]}
        for o in outs]
    log(f"{label}: memory in use on the card (GB): "
        f"{json.dumps({k: round(v, 2) for k, v in card.items()})}; the most "
        f"seen {summary['card_peak_gb_seen']:.2f} GB")
    counts = {"prefill": outs[0]["serve"]["prefill_launches"],
              "decode": outs[0]["serve"]["decode_launches"]}
    return counts, summary


def form_child(mesh, cfg32, shards, rows, serve_cli, ep):
    """One rank of phase 10 (b): ``serve_procs``' own f32 prefill of its
    rows with the routing recorded, launches counted; then the first MoE
    layer on the identical input."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = proc_kernels()
    r, n = mesh.rank, ranks_of(mesh.shape)
    out = {"rank": r, "experts": int(shards[0].blocks[0].moe.w_gate.shape[0]),
           "shard_gb": param_gb(shards[0])}
    reset_launches(kernels)
    with RouteRecorder() as rec:
        serve_cli()
    out["launches"] = read_launches(kernels)
    out["variants"] = read_variants(kernels)
    out["routes"] = [e.cpu() for e in rec.eids]
    b = FORM_BATCH // n
    x = moe_input(torch, cfg32, FORM_BATCH, FORM_PROMPT, torch.float32)[
        r * b:(r + 1) * b]
    isl = island_runs(torch, cfg32, shards.pop().blocks[0].moe, x, mesh,
                      None, {"flash": ("flash", False)})
    out["island"] = island_digests(torch, isl)
    return out


def phase_split_forms(torch, kernels):
    """Phase 10 (b): EP over ``data`` alone on (3, 2, 1) and no EP on (1,
    3, 1), 1 layer at mixtral's published widths in f32, a prefill against
    each mesh's stacked oracle.  Returns each path's launches and a
    summary."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import make_dist_context, serve_procs

    cfg = split_config(n_layers=FORM_LAYERS, compute_dtype="float32")
    prompts = stack_prompts(torch, cfg, FORM_BATCH, FORM_PROMPT)
    launches, summary = {}, {}
    for form, (shape, want_ep) in SPLIT_FORMS.items():
        label = f"split[b, {form}]"
        local = make_mesh(shape, AXES, torch.device(DEVICE))
        ep = make_dist_context(cfg, local).ep_axes
        if ep != want_ep:
            raise AssertionError(f"{label}: EP axes {ep} on {shape}")
        n = ranks_of(shape)
        params = stack_params(torch, cfg)
        reset_launches(kernels)
        loc = serve(torch, cfg, params, local, "flash", None, prompts,
                    kernels, decode=False, warmup=False, record="margins")
        x = moe_input(torch, cfg, FORM_BATCH, FORM_PROMPT, torch.float32)
        isl = island_runs(torch, cfg, params.blocks[0].moe, x, local, None,
                          {"flash": ("flash", False)})
        want = oracle_digests(torch, isl, cfg.moe.num_experts,
                              ep[0] if ep else None, shape)
        del isl, x
        free(torch)
        holder = [params]
        del params
        t0 = time.perf_counter()
        res = serve_procs(cfg, holder, prompts, shape, PROC_BACKEND, DEVICE,
                          "flash", None, 1, hook=functools.partial(
                              form_child, ep=ep),
                          timeout=PROC_TIMEOUT_S, join_timeout=PROC_JOIN_S)
        seconds = time.perf_counter() - t0
        outs = res["ranks"]
        e_loc = cfg.moe.num_experts // (local.axis_size(ep) if ep else 1)
        if [o["experts"] for o in outs] != [e_loc] * n:
            raise AssertionError(f"{label}: experts a process "
                                 f"{[o['experts'] for o in outs]}")
        island, _ = check_island(outs, want, label)
        err = rel_err(torch, res["logits"][0], loc["logits"].cpu())
        routes = [torch.cat([o["routes"][i] for o in outs])
                  for i in range(len(loc["routes"]))]
        flips, n_dec, tie = near_tie_flips(torch, loc["routes"], routes,
                                           loc["margins"], FORM_BATCH)
        want_l = loc["prefill_launches"]
        same = all(o["launches"] == want_l for o in outs)
        log(f"{label}: 1 layer on {shape}, {n} processes, EP axes {ep} "
            f"({e_loc} experts a process, f32 shard "
            f"{outs[0]['shard_gb']:.2f} GB), {FORM_BATCH} prompts of "
            f"{FORM_PROMPT} tokens: prefill logits max rel diff {err:.3e} "
            f"against LocalMesh{shape} (limit 1e-4); {flips} of {n_dec} "
            f"routing decisions differ, the first at a margin of at most "
            f"{tie:.3e} (limit {NEAR_TIE}); routing, token grid "
            f"{island['flash']['grid_shape']} and "
            f"{island['flash']['exchanges']} exchanges bit-identical to the "
            f"stacked slices; launches equal to the oracle's {same} "
            f"({want_l}); {seconds:.1f} s with the processes' start-up")
        if not (err < 1e-4 and tie <= NEAR_TIE and same):
            raise AssertionError(f"{label}: prefill {err}, routing tie "
                                 f"{tie}, launches equal {same}")
        for o in outs:
            if o["variants"]["grouped_matmul"]["simt"] != \
                    o["launches"]["grouped_matmul"]:
                raise AssertionError(f"{label}: f32 grouped_matmul by "
                                     f"instance {o['variants']}")
        launches[f"mixtral-8x7b {form} procs "
                 f"({','.join(map(str, shape))})"] = {
            "prefill": outs[0]["launches"],
            "decode": dict.fromkeys(outs[0]["launches"], 0)}
        summary[form] = {"mesh": shape, "ep_axes": ep, "experts": e_loc,
                         "max_rel_diff": err, "routing_differs": flips,
                         "first_difference_margin": tie,
                         "grid_shape": island["flash"]["grid_shape"],
                         "processes_s": seconds}
        del res, outs, loc
        free(torch)
    return launches, summary


EXPERT_STACKS = ("w_gate", "w_up", "w_down")


def expert_grads_nonzero(grads):
    """Whether every expert of every expert stack has a nonzero gradient (a
    gradient cut by a collective comes back as zeros)."""
    return all(bool((g.reshape(g.shape[0], -1).abs().amax(-1) > 0).all())
               for k, g in grads.items()
               if ".moe." in k and k.rsplit(".", 1)[-1] in EXPERT_STACKS)


def split_train_child(mesh, cfg, shards, train, want):
    """One rank of phase 10 (c): ``train()`` (the smoke mixtral's f32
    steps) with each step's gradients held against the oracle's slices
    (``want``, shared through CUDA IPC) and its launches counted; then one
    step with int8 dispatch on a copy of the initial shard (reported)."""
    import torch

    from repro_torch.convert import recast
    from repro_torch.launch.train import (init_train_state, make_train_step,
                                          train_specs)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = proc_kernels()
    specs = train_specs(cfg, mesh)
    init = {k: p.detach().clone() for k, p in shards[0].named_parameters()}
    experts = int(shards[0].blocks[0].moe.w_gate.shape[0])
    launches = []

    def each(i, run):
        reset_launches(kernels)
        res = run()
        torch.cuda.synchronize()
        launches.append(read_launches(kernels))
        return res

    with GradSpy(on_grads=lambda i, g: (
            grad_stats(torch, mesh, specs, g, want["grads"][i]),
            expert_grads_nonzero(g))) as spy:
        res = train(each_step=each)
    # release the parent's tensors now, not at this process's exit
    want.clear()
    gc.collect()
    cfg_q = dataclasses.replace(cfg, quantized_dispatch=True)
    step = make_train_step(cfg_q, mesh, proc_train_options(
        SPLIT_TRAIN_STEPS), device=DEVICE)
    _, m = step(init_train_state(recast(init, cfg_q, train=True)),
                train_batches(cfg, SPLIT_TRAIN_BATCH, SPLIT_TRAIN_SEQ, 1)[0])
    return {"rank": mesh.rank, "metrics": res["metrics"], "experts": experts,
            "grads": [s for s, _ in spy.grads],
            "expert_grads_nonzero": all(z for _, z in spy.grads),
            "launches": launches,
            "int8": {k: float(v) for k, v in m.items()}}


def phase_split_train(torch, kernels):
    """Phase 10 (c): the smoke mixtral (4 experts, f32) trained on the 6
    processes of (2, 3, 1) through ``train_procs``, EP over ``pod`` alone,
    against the same steps on ``LocalMesh((2, 3, 1))``; then one step with
    int8 dispatch on each.  Returns rank 0's launches and a summary."""
    from repro_torch.configs import smoke_config
    from repro_torch.convert import recast
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import (init_train_state, make_dist_context,
                                          make_train_step, train_procs)

    label = "split[c]"
    cfg = dataclasses.replace(smoke_config(MIX_ARCH),
                              compute_dtype="float32")
    local = make_mesh(SPLIT_MESH, AXES, torch.device(DEVICE))
    ep = make_dist_context(cfg, local).ep_axes
    if ep != ("pod",):
        raise AssertionError(f"{label}: EP axes {ep} on {SPLIT_MESH}")
    batches = train_batches(cfg, SPLIT_TRAIN_BATCH, SPLIT_TRAIN_SEQ,
                            SPLIT_TRAIN_STEPS)
    init = {k: p.detach().clone() for k, p in
            stack_params(torch, cfg, train=True).named_parameters()}

    def fresh(c):
        return recast({k: v.clone() for k, v in init.items()}, c,
                      train=True)

    state = init_train_state(fresh(cfg))
    step = make_train_step(cfg, local, proc_train_options(SPLIT_TRAIN_STEPS),
                           device=DEVICE)
    oracle = {"metrics": [], "launches": []}
    with GradSpy() as spy:
        for b in batches:
            reset_launches(kernels)
            state, m = step(state, b)
            torch.cuda.synchronize()
            oracle["launches"].append(read_launches(kernels))
            oracle["metrics"].append({k: float(v) for k, v in m.items()})
    want = {"grads": spy.grads}
    cfg_q = dataclasses.replace(cfg, quantized_dispatch=True)
    _, m = make_train_step(cfg_q, local, proc_train_options(
        SPLIT_TRAIN_STEPS), device=DEVICE)(init_train_state(fresh(cfg_q)),
                                           batches[0])
    oracle_q = {k: float(v) for k, v in m.items()}
    del state, step
    t0 = time.perf_counter()
    res = train_procs(cfg, [fresh(cfg)], proc_data(cfg, SPLIT_TRAIN_BATCH,
                                                   SPLIT_TRAIN_SEQ),
                      SPLIT_MESH, PROC_BACKEND, DEVICE,
                      proc_train_options(SPLIT_TRAIN_STEPS),
                      SPLIT_TRAIN_STEPS, hook=functools.partial(
                          split_train_child, want=want),
                      timeout=PROC_TIMEOUT_S, join_timeout=PROC_JOIN_S)
    seconds = time.perf_counter() - t0
    del want, spy
    free(torch)
    torch.cuda.ipc_collect()  # the oracle's tensors the processes mapped
    outs = res["ranks"]
    metric_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                     for a, b in zip(res["metrics"], oracle["metrics"])
                     for k in ("loss", "nll", "aux", "grad_norm", "lr"))
    grad_errs = [rel_norms([o["grads"][i] for o in outs])
                 for i in range(SPLIT_TRAIN_STEPS)]
    worst_grad = max(max(e.values()) for e in grad_errs)
    worst_key = max(grad_errs[-1], key=grad_errs[-1].get)
    launches_equal = all(o["launches"] == oracle["launches"] for o in outs)
    nonzero = all(o["expert_grads_nonzero"] for o in outs)
    experts = [o["experts"] for o in outs]
    q_diff = {k: abs(outs[0]["int8"][k] - oracle_q[k])
              / max(abs(oracle_q[k]), 1e-6) for k in ("loss", "grad_norm")}
    log(f"{label}: smoke {cfg.name} (d_model {cfg.d_model}, "
        f"{cfg.moe.num_experts} experts, f32) trained on {SPLIT_MESH}, "
        f"{ranks_of(SPLIT_MESH)} processes through train_procs, EP axes "
        f"{ep} ({experts[0]} experts a process), {SPLIT_TRAIN_BATCH} x "
        f"{SPLIT_TRAIN_SEQ} tokens, {SPLIT_TRAIN_STEPS} AdamW steps against "
        f"LocalMesh{SPLIT_MESH}: metrics max rel diff {metric_err:.3e} "
        f"(limit 1e-5); gradients, relative norm of the gathered whole, "
        f"worst {worst_grad:.3e} (limit 1e-4; the last step's worst "
        f"{worst_key}); every expert's gradient nonzero in every process "
        f"{nonzero}; launches equal to the oracle's {launches_equal} "
        f"({oracle['launches'][0]}); {seconds:.1f} s with the processes' "
        f"start-up")
    log(f"{label}[int8 dispatch]: one step, loss "
        f"{outs[0]['int8']['loss']:.6f} and grad norm "
        f"{outs[0]['int8']['grad_norm']:.6f} on the processes, relative "
        f"differences to the stacked step's {json.dumps(q_diff)} "
        f"(reported)")
    if not (metric_err <= 1e-5 and worst_grad <= 1e-4 and launches_equal
            and nonzero and experts == [2] * ranks_of(SPLIT_MESH)):
        raise AssertionError(f"{label}: metrics {metric_err}, gradients "
                             f"{worst_grad}, launches equal "
                             f"{launches_equal}, expert gradients nonzero "
                             f"{nonzero}, experts {experts}")
    counts = {k: sum(s[k] for s in outs[0]["launches"])
              for k in outs[0]["launches"][0]}
    return counts, {"metric_err": metric_err, "grad_err": worst_grad,
                    "expert_grads_nonzero": nonzero,
                    "int8_step_rel_diff": q_diff, "processes_s": seconds}


def phase_split(torch, kernels):
    """Phase 10: (a) serving mixtral-8x7b on (2, 3, 1), (b) the other two
    forms, (c) training.  Returns each path's launches and a summary."""
    summary, launches = {}, {}
    t0 = time.perf_counter()
    launches[SPLIT_PATH], summary["a"] = phase_split_serve(torch, kernels)
    summary["a_s"] = time.perf_counter() - t0
    free(torch)
    t0 = time.perf_counter()
    forms, summary["b"] = phase_split_forms(torch, kernels)
    launches.update(forms)
    summary["b_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train, summary["c"] = phase_split_train(torch, kernels)
    summary["c_s"] = time.perf_counter() - t0
    return launches, train, summary


# -- 11. tensor parallelism over "model" on one process per rank ---------------

def tp_pick(cfg, mesh, impl, plan):
    """A step's greedy tokens under TP: the argmax over every process's
    vocabulary shard (``transformer.greedy_tokens``)."""
    from repro_torch.launch.serve import make_dist_context
    from repro_torch.models.transformer import greedy_tokens

    dist = make_dist_context(cfg, mesh, impl, plan)
    return lambda logits: greedy_tokens(cfg, logits, dist)


def dense_config():
    """llama3.2-1b at its published config (16 layers)."""
    from repro_torch.configs import get_config

    return get_config(DENSE_ARCH)


class StreamRecorder:
    """While active, the digest of the residual stream after each layer of
    a prefill (``transformer._block_prefill``'s output)."""

    def __init__(self, torch):
        from repro_torch.models import transformer
        self.torch, self.mod, self.digests = torch, transformer, []

    def __enter__(self):
        self.real = self.mod._block_prefill

        def spy(*args, **kw):
            out = self.real(*args, **kw)
            x = out[0]
            if kw.get("sp") is not None:   # SP: the chunks joined
                x = kw["sp"].gathered(x).whole
            self.digests.append(digest(self.torch, x))
            return out
        self.mod._block_prefill = spy
        return self

    def __exit__(self, *exc):
        self.mod._block_prefill = self.real


class TPRounding:
    """While active, each row-parallel product (``tp.row_parallel``:
    attention's ``wo``, the MLP's and the experts' ``w_down``) of a run on
    whole weights computes what ``parts`` model peers compute under TP:
    the product of each contiguous slice of the contraction, rounded to its
    dtype, the slices added in f32 in peer order and rounded once more
    (``tp.sum_out``).  The witness oracle: TP's rounding on the stacked
    mesh, and nothing else of TP.  The encoder-decoder's cross-attention
    and the recurrent blocks (``wo``, Mamba's ``out_proj`` and its f32
    product of ``w_dt``, ``wb`` and ``wc``) hold their own names for
    ``row_parallel``, patched alike."""

    def __init__(self, parts):
        from repro_torch.models import encdec, layers, moe, ssm
        self.mods, self.parts = (layers, moe, encdec, ssm), parts

    def __enter__(self):
        from repro_torch.launch.mesh import member_sum

        self.real = [m.row_parallel for m in self.mods]

        def split(tp, product, x, w, *extra, sp=None):
            if tp is not None or sp is not None:
                raise AssertionError("TPRounding runs on whole weights")
            n = w.shape[-2] // self.parts
            outs = [product(x[..., i * n:(i + 1) * n].contiguous(),
                            w[..., i * n:(i + 1) * n, :].contiguous(),
                            *extra) for i in range(self.parts)]
            return member_sum(o.float() for o in outs).to(outs[0].dtype)
        for m in self.mods:
            m.row_parallel = split
        return self

    def __exit__(self, *exc):
        for m, real in zip(self.mods, self.real):
            m.row_parallel = real


class GateSplit:
    """While active, for each MoE routing of a stacked run (``moe._route``
    on ``[R, T, d]``): how many of its bf16 gates differ from those of each
    rank's rows routed alone (``[1, T, d]``, as its process routes them).
    The f32 router products of the two shapes round otherwise."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.counts = moe, []

    def __enter__(self):
        self.real = self.moe._route

        def spy(cfg, router_w, x_flat):
            out = self.real(cfg, router_w, x_flat)
            self.counts.append(sum(
                int((self.real(cfg, router_w, x_flat[r:r + 1])[0]
                     != out[0][r:r + 1]).sum())
                for r in range(x_flat.shape[0])))
            return out
        self.moe._route = spy
        return self

    def __exit__(self, *exc):
        self.moe._route = self.real


def token_control(torch, oracle):
    """The oracle's greedy tokens with one choice planted: at the step and
    sequence where its top two logits lie at their median gap, its second
    choice.  ``token_tie_gaps`` reads that gap."""
    top = torch.stack([lg.float().cpu().topk(2, dim=-1).indices
                       for lg in oracle["step_logits"]])     # [T, B, 2]
    vals = torch.stack([lg.float().cpu().topk(2, dim=-1).values
                        for lg in oracle["step_logits"]])
    gaps = (vals[..., 0] - vals[..., 1]) / torch.stack(
        [lg.float().cpu().abs().amax(-1) for lg in oracle["step_logits"]])
    at = int(gaps.reshape(-1).argsort()[gaps.numel() // 2])
    t, seq = divmod(at, gaps.shape[1])
    planted = oracle["tokens"].cpu().clone()
    planted[seq, t] = top[t, seq, 1]
    return planted


def tp_shares(torch, prefill, params, batch):
    """One prefill under torch.profiler (host activity): the shares of its
    host time inside the exchanges (the ``procmesh.*`` ranges but the TP
    sums) and inside the operators over "model" (``procmesh.tp_*``), all
    and by range name (``procmesh.tp_sum``, ``procmesh.tp_gather``, ...;
    a sum's own ``:scatter`` and ``:gather`` ranges lie inside its range
    and are not counted apart), host staging included; and inside the
    recurrences' time loops (``ssm_scan``, whose per-step gathers lie in
    both)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prefill(params, batch)
        torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) * 1e6
    spans = [e for e in prof.events() if e.name.startswith("procmesh.")]
    tp = [e for e in spans if e.name.startswith("procmesh.tp_")]
    ex = [e for e in spans if not e.name.startswith("procmesh.tp_")]

    def busy(events):
        return busy_us([(e.time_range.start, e.time_range.end)
                        for e in events])

    tops = [e for e in tp if ":" not in e.name]
    names = sorted({e.name for e in tops})
    scans = [e for e in prof.events() if e.name == "ssm_scan"]
    return {"spans": span_shares(spans, host_us),
            "host_ms": host_us / 1e3, "exchange_share": busy(ex) / host_us,
            "tp_share": busy(tp) / host_us, "exchanges": len(ex),
            "tp_sums": len(tops), "scan_share": busy(scans) / host_us,
            "scans": len(scans),
            "tp_by_span": {n: {"share": busy([e for e in tops
                                              if e.name == n]) / host_us,
                               "calls": sum(e.name == n for e in tops)}
                           for n in names}}


def span_shares(events, host_us):
    """Each ``procmesh.*`` range's share of ``host_us`` by name (a range's
    own ``:scatter`` and ``:gather`` parts are not counted apart), and its
    calls."""
    tops = [e for e in events
            if e.name.startswith("procmesh.") and ":" not in e.name]
    return {n: {"share": busy_us([(e.time_range.start, e.time_range.end)
                                  for e in tops if e.name == n]) / host_us,
                "calls": sum(e.name == n for e in tops)}
            for n in sorted({e.name for e in tops})}


def dp_index(coords, shape):
    """A process's DP rank: its (pod, data) coordinates, row-major."""
    return coords[0] * shape[1] + coords[1]


def by_dp(outs, shape, get):
    """``get(o)`` of each DP rank's process at model coordinate 0, joined
    in DP order."""
    import torch

    firsts = sorted((o for o in outs if o["coords"][2] == 0),
                    key=lambda o: dp_index(o["coords"], shape))
    return torch.cat([get(o) for o in firsts])


def assemble(outs, shape, get, dim):
    """``get(o)`` of every process put together: model peers' slices
    joined along ``dim``, then the DP ranks' along 0."""
    import torch

    groups = {}
    for o in outs:
        groups.setdefault(dp_index(o["coords"], shape), []).append(o)
    return torch.cat([torch.cat([get(o) for o in sorted(
        g, key=lambda o: o["coords"][2])], dim=dim)
        for _, g in sorted(groups.items())])


def check_peers(outs, get, label, what):
    """``get(o)`` equal (``==``) on every model peer of each DP rank."""
    groups = {}
    for o in outs:
        groups.setdefault(tuple(o["coords"][:2]), []).append(get(o))
    for key, vals in groups.items():
        if any(v != vals[0] for v in vals[1:]):
            raise AssertionError(f"{label}: {what} differs between the "
                                 f"model peers of DP rank {key}")


def tp_child(mesh, cfg32, shards, rows, serve_cli, plan):
    """One rank of phase 11 (a), the per-rank hook of ``serve_procs``: the
    f32 serve of its shard (``serve_procs``' own: prefill and 15 greedy
    steps gathered over the DP axes and "model") with its routing
    recorded; the bf16 serving run; a prefill with the residual stream's
    digest after every layer; the exchange's and the TP sums' shares of a
    traced prefill; the first MoE layer on the identical input; the first
    attention and MoE layers.  Returns host tensors and digests."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.convert import recast
    from repro_torch.launch.serve import make_prefill_step

    kernels = proc_kernels()
    cfg = serve_config()
    out = {"rank": mesh.rank, "coords": mesh.rank_coords, "used_gb": {},
           "shard_gb": param_gb(shards[0]),
           "experts": tuple(shards[0].blocks[0].moe.w_gate.shape)}
    out["used_gb"]["after the parent's drop"] = card_used_gb(torch)
    torch.cuda.reset_peak_memory_stats()
    with RouteRecorder() as rec:         # the prefill's, then each step's
        serve_cli()
    out["f32_routes"] = [e.cpu() for e in rec.eids[:len(rec.eids) // GEN]]

    shard = recast(shards.pop(), cfg)
    free(torch)
    run = serve(torch, cfg, shard, mesh, "plan", plan, rows, kernels,
                record=True, pick=tp_pick(cfg, mesh, "plan", plan))
    out["used_gb"]["serving"] = card_used_gb(torch)
    out["serve"] = {k: run[k] for k in (
        "prefill_s", "decode_s", "decode_steps", "step_ms_median",
        "step_ms_max", "prefill_launches", "decode_launches",
        "prefill_variants", "decode_variants")}
    out["serve"].update(logits=run["logits"].cpu(),
                        last_logits=run["last_logits"].cpu(),
                        tokens=run["tokens"].cpu(),
                        routes=[e.cpu() for e in run["routes"]])
    del run
    prefill = make_prefill_step(cfg, mesh, "plan", plan,
                                cache_len=PROMPT + GEN, device=DEVICE)
    with torch.no_grad(), StreamRecorder(torch) as st:
        prefill(shard, {"tokens": rows})
    out["stream"] = st.digests
    out["shares"] = tp_shares(torch, prefill, shard, {"tokens": rows})

    b = rows.shape[0]
    dp = dp_index(mesh.rank_coords, TP_MESH)
    x = moe_input(torch, cfg, PROC_BATCH, PROMPT, torch.bfloat16)[
        dp * b:(dp + 1) * b]
    isl = island_runs(torch, cfg, shard.blocks[0].moe, x, mesh, plan,
                      {"plan": ("plan", False)})["plan"]
    out["island"] = {"grid": digest(torch, isl["grid"]),
                     "grid_shape": tuple(isl["grid"].shape),
                     "eids": isl["eids"].cpu(), "y": isl["y"].cpu(),
                     "y_digest": digest(torch, isl["y"])}
    del isl, x
    attn, y, eids = first_layer(torch, cfg, shard, mesh, plan, rows)
    out["first_layer"] = (attn.cpu(), y.cpu(), eids.cpu())
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def tp_report(outs, summary, label):
    """Each process's serving numbers and the card's memory, logged and
    kept in ``summary``."""
    card = dict(summary["used_gb"])
    for o in outs:
        for k, v in o["used_gb"].items():
            card[f"{k} (rank {o['rank']})"] = v
        sv, sh = o["serve"], o["shares"]
        log(f"{label}[rank {o['rank']} {tuple(o['coords'])}]: prefill "
            f"{sv['prefill_s'] * 1e3:.3f} ms; decode "
            f"{sv['decode_s'] / sv['decode_steps'] * 1e3:.3f} ms/step host "
            f"mean, {sv['step_ms_median']:.3f} ms device median over "
            f"{sv['decode_steps']} steps; traced prefill "
            f"{sh['host_ms']:.3f} ms: exchange share "
            f"{sh['exchange_share']:.4f} ({sh['exchanges']} collectives), "
            f"sums over 'model' {sh['tp_share']:.4f} ({sh['tp_sums']} "
            f"sums), host staging included; peak {o['peak_gb']:.2f} GB "
            f"(f32 shard {o['shard_gb']:.2f} GB); {TP_LABEL}")
    summary["used_gb"] = card
    summary["card_peak_gb_seen"] = max(card.values())
    summary["ranks"] = [{
        "rank": o["rank"], "coords": list(o["coords"]),
        "prefill_ms": o["serve"]["prefill_s"] * 1e3,
        "decode_ms_per_step": o["serve"]["decode_s"]
        / o["serve"]["decode_steps"] * 1e3,
        "decode_device_ms_median": o["serve"]["step_ms_median"],
        "peak_gb": o["peak_gb"], **o["shares"]} for o in outs]
    log(f"{label}: memory in use on the card (GB): "
        f"{json.dumps({k: round(v, 2) for k, v in card.items()})}; the most "
        f"seen {summary['card_peak_gb_seen']:.2f} GB")


def check_tp_launches(outs, want, label):
    """Every process launched each kernel as often as the oracle in its
    prefill and decode."""
    for o in outs:
        for part in ("prefill", "decode"):
            got = o["serve"][f"{part}_launches"]
            if got != want[part]:
                raise AssertionError(f"{label}: rank {o['rank']} launched "
                                     f"{got} in the {part}; the oracle "
                                     f"{want[part]}")


def witness_tokens(torch, wit, oracle, tokens, logits, skip):
    """A TP run's greedy ``tokens`` and prefill ``logits`` against the
    witness's (``TPRounding``), the plain oracle's tokens beside them, and
    the gaps ``check_witness_tokens`` holds."""
    batch = tokens.shape[0]
    gaps = token_tie_gaps(torch, wit, tokens, skip)
    control = token_tie_gaps(torch, wit, token_control(torch, wit),
                             torch.zeros(batch, dtype=torch.bool))[0][2]
    want = wit["tokens"].cpu()
    res = {"logits_rel_diff": rel_err(torch, logits, wit["logits"].cpu()),
           "logits_equal": bool(torch.equal(logits,
                                            wit["logits"].cpu())),
           "sequences_same_tokens": int((tokens == want).all(-1).sum()),
           "oracle_sequences_same_tokens": int(
               (oracle["tokens"].cpu() == want).all(-1).sum()),
           "token_gaps": gaps, "planted_token_gap": control}
    return res


def check_witness_tokens(label, res):
    """A sequence may pick another token than the witness only where the
    witness's top two lie within ``BF16_TOKEN_TIE`` of the row's largest;
    a token planted at the witness's median gap must fail that."""
    if not all(g <= BF16_TOKEN_TIE for _, _, g in res["token_gaps"]):
        raise AssertionError(f"{label}: bf16 tokens apart from the "
                             f"witness's at gaps {res['token_gaps']}")
    if not res["planted_token_gap"] > BF16_TOKEN_TIE:
        raise AssertionError(f"{label}: a token planted at the witness's "
                             f"median gap ({res['planted_token_gap']}) "
                             f"passes the gate")


def tp_witness(torch, label, outs, wit, loc, tokens, routes, logits, want,
               gates_apart):
    """Phase 11 (a)'s bf16 run held to the witness (``TPRounding``): at
    most ``PROC_BF16_APART_MAX`` sequences routed apart (the plain oracle,
    held to it alike, must fail that), tokens by ``check_witness_tokens``,
    and on the identical MoE input each process's output bit for bit its
    slice of the witness's.  ``gates_apart`` (``GateSplit``, per layer of
    the witness's prefill) is reported beside the logits."""
    w_routes = [e.cpu() for e in wit["routes"]]
    n_flip, n_dec, per_layer, per_seq = route_flips(torch, w_routes, routes,
                                                    PROC_BATCH)
    o_flip, _, o_layer, o_seq = route_flips(
        torch, w_routes, [e.cpu() for e in loc["routes"]], PROC_BATCH)
    ys = [(o["island"]["y"], want[dp_index(o["coords"], TP_MESH)]["wit_y"])
          for o in outs]
    res = {"routing_differs": n_flip, "per_layer": per_layer,
           "sequences_routed_apart": int(per_seq.sum()),
           "oracle_routing_differs": o_flip, "oracle_per_layer": o_layer,
           "oracle_sequences_routed_apart": int(o_seq.sum()),
           "moe_identical_input_equal": all(bool(torch.equal(a, w))
                                            for a, w in ys),
           "moe_identical_input_rel_diff": max(
               rel_err(torch, a.float(), w.float()) for a, w in ys),
           "stacked_gates_apart_per_layer": gates_apart}
    res.update(witness_tokens(torch, wit, loc, tokens, logits, per_seq))
    log(f"{label}[bf16 against the witness, the oracle with TP's rounding "
        f"of the row-parallel products alone]: routing differs in {n_flip} "
        f"of {n_dec} decisions (per layer {per_layer}), in "
        f"{res['sequences_routed_apart']} of {PROC_BATCH} sequences (limit "
        f"{PROC_BF16_APART_MAX}); the plain oracle against it: {o_flip} "
        f"decisions (per layer {o_layer}), {res['oracle_sequences_routed_apart']}"
        f" sequences; prefill logits max rel diff "
        f"{res['logits_rel_diff']:.3e} (bit-identical "
        f"{res['logits_equal']}; the bf16 gates of the stacked router "
        f"products that differ from each rank's own, per layer: "
        f"{gates_apart}); greedy tokens equal in "
        f"{res['sequences_same_tokens']} of {PROC_BATCH} (the plain "
        f"oracle's in {res['oracle_sequences_same_tokens']}); each sequence "
        f"routed alike whose tokens differ (sequence, step, witness gap): "
        f"{res['token_gaps']} (limit {BF16_TOKEN_TIE}; one planted at the "
        f"median gap reads {res['planted_token_gap']:.3e}); the MoE layer on "
        f"the identical input bit-identical to the witness's "
        f"{res['moe_identical_input_equal']} (max rel diff "
        f"{res['moe_identical_input_rel_diff']:.3e})")
    check_witness_tokens(label, res)
    if not (res["sequences_routed_apart"] <= PROC_BF16_APART_MAX
            and res["moe_identical_input_equal"]):
        raise AssertionError(f"{label}: {res['sequences_routed_apart']} "
                             f"sequences routed apart from the witness; MoE "
                             f"output on the identical input equal "
                             f"{res['moe_identical_input_equal']}")
    if not res["oracle_sequences_routed_apart"] > PROC_BF16_APART_MAX:
        raise AssertionError(f"{label}: the plain oracle passes the "
                             f"witness's routing gate")
    return res


def phase_tp_serve(torch, kernels):
    """Phase 11 (a): megatron-moe-32e on 8 processes of (pod 2, data 2,
    model 2), against ``LocalMesh((2, 2, 1))`` (the same DP shape, whole
    weights); the same processes then train (c)'s model
    (``tp_cell_child``).  Returns rank 0's launch counts, a summary and
    (c)'s processes and rank 0's step metrics."""
    from repro_torch.convert import recast
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import (flash_plan, make_prefill_step,
                                          serve_procs)

    cfg = serve_config()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    local = make_mesh(PROC_MESH, AXES, torch.device(DEVICE))
    plan = flash_plan(TP_MESH[0], TP_MESH[1], SEED)
    prompts = stack_prompts(torch, cfg, PROC_BATCH, PROMPT)
    n, tp = ranks_of(TP_MESH), TP_MESH[2]
    label = "tp[a]"
    log(f"{label}: {cfg.name} layers={cfg.n_layers}/24 at its published "
        f"widths on a {TP_MESH} mesh of {n} processes ({PROC_BACKEND}): "
        f"{cfg.n_heads // tp} of {cfg.n_heads} heads, "
        f"{cfg.moe.num_experts // 4} experts of [{cfg.d_model}, "
        f"{cfg.d_ff // tp}] and {cfg.vocab // tp} of {cfg.vocab} vocabulary "
        f"rows a process; {PROC_BATCH} prompts of {PROMPT} tokens "
        f"({PROC_BATCH // 4} a DP rank, on each of its {tp} model peers) "
        f"and {GEN - 1} decode steps; {TP_LABEL}")
    summary = {"label": TP_LABEL, "used_gb": {}}

    torch.cuda.reset_peak_memory_stats()
    params32 = stack_params(torch, cfg32)
    loc32 = serve(torch, cfg32, params32, local, "plan", plan, prompts,
                  kernels, warmup=False, record="margins")
    params = recast(params32, cfg)
    loc = serve(torch, cfg, params, local, "plan", plan, prompts, kernels,
                record="margins", keep_logits=True)
    check_run(torch, loc, cfg, PROC_BATCH, f"{label}[local oracle]",
              SERVE_KERNELS, MEGATRON_A2A)
    summary["oracle"] = {"prefill_ms": loc["prefill_s"] * 1e3,
                         "decode_ms_per_step": loc["decode_s"]
                         / loc["decode_steps"] * 1e3}
    loc_first = first_layer(torch, cfg, params, local, plan, prompts)
    x = moe_input(torch, cfg, PROC_BATCH, PROMPT, torch.bfloat16)
    isl = island_runs(torch, cfg, params.blocks[0].moe, x, local, plan,
                      {"plan": ("plan", False)})["plan"]
    e_loc = cfg.moe.num_experts // 4
    b = PROC_BATCH // 4
    # the witness: the same runs with TP's rounding of the row-parallel
    # products alone (TPRounding)
    with TPRounding(tp):
        wit = serve(torch, cfg, params, local, "plan", plan, prompts,
                    kernels, record="margins", keep_logits=True)
        wit_isl = island_runs(torch, cfg, params.blocks[0].moe, x, local,
                              plan, {"plan": ("plan", False)})["plan"]
        with GateSplit() as split_first:
            wit_first = first_layer(torch, cfg, params, local, plan, prompts)
        with GateSplit() as split, torch.no_grad():
            make_prefill_step(cfg, local, "plan", plan,
                              cache_len=PROMPT + GEN, device=DEVICE)(
                params, {"tokens": prompts})
    want = [{"grid": digest(torch, isl["grid"][r * e_loc:(r + 1) * e_loc]),
             "eids": isl["eids"][r:r + 1].cpu(),
             "y": isl["y"][r * b:(r + 1) * b].cpu(),
             "wit_y": wit_isl["y"][r * b:(r + 1) * b].cpu()}
            for r in range(4)]
    del isl, wit_isl, x, params
    free(torch)
    summary["used_gb"]["parent, whole f32 model"] = card_used_gb(torch)

    tcfg = train_config(n_layers=TP_TRAIN_LAYERS)
    train_holder = [{k: v.detach() for k, v in stack_params(
        torch, tcfg, train=True).named_parameters()}]
    holder = [params32]
    del params32
    # the children's allocator only: the parent's tensors they map through
    # CUDA IPC were allocated before
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    res = serve_procs(cfg32, holder, prompts, TP_MESH, PROC_BACKEND, DEVICE,
                      "plan", plan, GEN,
                      hook=functools.partial(tp_cell_child, plan=plan,
                                             train_holder=train_holder),
                      timeout=PROC_TIMEOUT_S, join_timeout=PROC_JOIN_S)
    summary["processes_s"] = time.perf_counter() - t0
    del os.environ["PYTORCH_CUDA_ALLOC_CONF"], train_holder
    free(torch)
    torch.cuda.ipc_collect()  # the training model the processes mapped
    summary["used_gb"].update(res.get("card_used_gb", {}))
    outs = res["ranks"]
    shapes = {o["experts"] for o in outs}
    if shapes != {(e_loc, cfg.d_model, cfg.d_ff // tp)}:
        raise AssertionError(f"{label}: expert stacks {shapes}")

    # identical MoE input: routing and grid bit for bit the stacked slice's
    for o in outs:
        w, isl = want[dp_index(o["coords"], TP_MESH)], o["island"]
        if not (bool(torch.equal(isl["eids"], w["eids"]))
                and isl["grid"] == w["grid"]):
            raise AssertionError(f"{label}: rank {o['rank']}'s routing or "
                                 f"token grid {isl['grid_shape']} differs "
                                 f"from its slice of the stacked run's")
    check_peers(outs, lambda o: o["island"]["y_digest"], label,
                "the MoE layer's output on the identical input")
    y_err = max(rel_err(torch, o["island"]["y"].float(),
                        want[dp_index(o["coords"], TP_MESH)]["y"].float())
                for o in outs)
    check_peers(outs, lambda o: o["stream"], label,
                "the residual stream's digest after a layer")
    log(f"{label}[identical MoE input, bf16]: every process's routing and "
        f"token grid {outs[0]['island']['grid_shape']} (the forward "
        f"exchange's output, transposed) bit-identical to its slice of the "
        f"stacked run's; the layer's output bit-identical on model peers "
        f"and within {y_err:.3e} of the stacked output (the sum over "
        f"'model' of two F/2 halves); the residual stream after each of the "
        f"{cfg.n_layers} layers bit-identical on model peers")
    if not y_err < 2e-2:
        raise AssertionError(f"{label}: MoE output on identical input "
                             f"{y_err}")

    # f32: serve_procs' gather against the oracle
    err32 = rel_err(torch, res["logits"][0], loc32["logits"].cpu())
    routes32 = [by_dp(outs, TP_MESH, lambda o: o["f32_routes"][i])
                for i in range(len(loc32["routes"]))]
    flips32, n_dec, tie = near_tie_flips(torch, loc32["routes"], routes32,
                                         loc32["margins"], PROC_BATCH)
    same32 = bool(torch.equal(res["tokens"], loc32["tokens"].cpu()))
    log(f"{label}[f32]: serve_procs' prefill logits gathered over the DP "
        f"axes and 'model', max rel diff {err32:.3e} against LocalMesh "
        f"(limit 1e-4); {flips32} of {n_dec} routing decisions differ, each "
        f"sequence's first at an oracle margin of at most {tie:.3e} "
        f"(near-tie limit {NEAR_TIE}); greedy tokens (the argmax over the "
        f"vocabulary shards) of the prefill and {GEN - 1} steps equal "
        f"{same32}")
    if not (err32 < 1e-4 and tie <= NEAR_TIE and same32):
        raise AssertionError(f"{label}: f32 prefill {err32}, routing tie "
                             f"{tie}, tokens equal {same32}")
    summary["f32"] = {"max_rel_diff": err32, "routing_differs": flips32,
                      "first_difference_margin": tie, "tokens_equal": same32}

    # bf16: launches, routing and tokens
    want_l = run_counts(loc)
    check_tp_launches(outs, want_l, label)
    for o in outs:
        check_run(torch, o["serve"], cfg, b, f"{label}[rank {o['rank']}]",
                  SERVE_KERNELS, MEGATRON_A2A, vocab=cfg.vocab // tp)
    check_peers(outs, lambda o: o["serve"]["tokens"].tolist(), label,
                "the greedy tokens")
    logits = assemble(outs, TP_MESH, lambda o: o["serve"]["logits"], -1)
    tokens = by_dp(outs, TP_MESH, lambda o: o["serve"]["tokens"])
    routes = [by_dp(outs, TP_MESH, lambda o: o["serve"]["routes"][i])
              for i in range(len(loc["routes"]))]
    oracle_routes = [e.cpu() for e in loc["routes"]]
    n_flip, n_dec, per_layer, per_seq = route_flips(
        torch, oracle_routes, routes, PROC_BATCH)
    _, _, tie = near_tie_flips(torch, oracle_routes, routes, loc["margins"],
                               PROC_BATCH)
    gaps = token_tie_gaps(torch, loc, tokens, per_seq)
    # the control: one oracle decision at the median margin sent elsewhere
    margins = torch.cat([m.cpu().reshape(-1) for m in loc["margins"]])
    planted = [e.clone() for e in oracle_routes]
    flat = planted[0].reshape(-1, planted[0].shape[-1])
    at = int(loc["margins"][0].cpu().reshape(-1).argsort()[
        flat.shape[0] // 2])
    flat[at, 0] = flat[at, 0] ^ 1
    control = near_tie_flips(torch, oracle_routes, planted, loc["margins"],
                             PROC_BATCH)[2]
    within = int((margins <= TP_BF16_TIE).sum())
    summary["bf16"] = {
        "max_rel_diff": rel_err(torch, logits, loc["logits"].cpu()),
        "routing_differs": n_flip, "first_difference_margin": tie,
        "sequences_routed_apart": int(per_seq.sum()),
        "sequences_same_tokens": int((tokens == loc["tokens"].cpu())
                                     .all(-1).sum()),
        "routed_alike_token_gaps": gaps,
        "decisions_within_route_tie": within,
        "planted_control_margin": control}
    log(f"{label}[bf16]: every process launched each kernel as often as the "
        f"oracle (prefill {want_l['prefill']}, decode {want_l['decode']}), "
        f"grouped_matmul on TMA alone at [{e_loc}, rows, {cfg.d_model}] @ "
        f"[{e_loc}, {cfg.d_model}, {cfg.d_ff // tp}], pack and unpack on "
        f"{sorted(MEGATRON_A2A['prefill'])}; prefill logits max rel diff "
        f"{summary['bf16']['max_rel_diff']:.3e}; routing differs in {n_flip} "
        f"of {n_dec} decisions (per layer {per_layer}), in "
        f"{int(per_seq.sum())} of {PROC_BATCH} sequences (reported: the "
        f"sums over 'model' round bf16 otherwise than one product), each "
        f"sequence's first at an oracle margin of at most {tie:.3e} (limit "
        f"{TP_BF16_TIE}; {within} of {margins.numel()} oracle decisions "
        f"lie within it; one decision planted at the median margin reads "
        f"{control:.3e}); greedy tokens equal in "
        f"{summary['bf16']['sequences_same_tokens']} of {PROC_BATCH}; each "
        f"sequence routed alike whose tokens differ (sequence, step, oracle "
        f"gap): {gaps} (limit {BF16_TOKEN_TIE})")
    if not (tie <= TP_BF16_TIE
            and all(g <= BF16_TOKEN_TIE for _, _, g in gaps)):
        raise AssertionError(f"{label}: bf16 routing's first differences at "
                             f"margins up to {tie}; token gaps {gaps}")
    if not control > TP_BF16_TIE:
        raise AssertionError(f"{label}: a decision planted at the median "
                             f"margin ({control}) passes the routing gate")

    summary["witness"] = tp_witness(torch, label, outs, wit, loc, tokens,
                                    routes, logits, want, split.counts)

    errs, route_eq, wit_errs = [], [], []
    for o in outs:
        dp = dp_index(o["coords"], TP_MESH)
        rows = slice(dp * b, (dp + 1) * b)
        attn, y, eids = o["first_layer"]
        errs.append((rel_err(torch, attn, loc_first[0][rows].cpu()),
                     rel_err(torch, y, loc_first[1][rows].cpu())))
        wit_errs.append((rel_err(torch, attn, wit_first[0][rows].cpu()),
                         rel_err(torch, y, wit_first[1][rows].cpu())))
        route_eq.append(bool(torch.equal(eids[0], loc_first[2][dp].cpu())))
    worst = tuple(max(e[i] for e in errs) for i in range(2))
    wit_worst = tuple(max(e[i] for e in wit_errs) for i in range(2))
    summary["witness"]["first_layer"] = {
        "attention": wit_worst[0], "moe": wit_worst[1],
        "stacked_gates_apart": split_first.counts[0]}
    log(f"{label}[first layer, bf16, identical inputs]: attention max rel "
        f"diff {worst[0]:.3e}, MoE {worst[1]:.3e} against LocalMesh (limit "
        f"2e-2); routing equal {all(route_eq)}; against the witness "
        f"(reported) {wit_worst[0]:.3e} and {wit_worst[1]:.3e}, where "
        f"{split_first.counts[0]} bf16 gates of the stacked router product "
        f"differ from each rank's own")
    if not (worst[0] < 2e-2 and worst[1] < 2e-2 and all(route_eq)):
        raise AssertionError(f"{label}: first layer {worst}, routing equal "
                             f"{route_eq}")
    summary["first_layer"] = {"attention": worst[0], "moe": worst[1]}
    summary["moe_identical_input_rel_diff"] = y_err
    tp_report(outs, summary, label)
    r0 = next(o for o in outs if o["rank"] == 0)
    trained = ([o["train"] for o in outs], r0["train_metrics"])
    return {"prefill": r0["serve"]["prefill_launches"],
            "decode": r0["serve"]["decode_launches"]}, summary, trained


def tp_cell_child(mesh, cfg32, shards, rows, serve_cli, plan,
                  train_holder):
    """One rank of phase 11 (a) and (c) in one spawn: ``tp_child``'s
    serving, then ``train_procs``' per-rank path (``launch/train.
    _train_rank``) on this process's shard of the TP_TRAIN_LAYERS-layer
    model in ``train_holder`` (shared by the parent through CUDA IPC),
    each step as ``tp_train_child`` reads it: one start of the 8
    processes for both."""
    import torch

    from repro_torch.launch.train import _train_rank

    out = tp_child(mesh, cfg32, shards, rows, serve_cli, plan)
    free(torch)
    cfg = train_config(n_layers=TP_TRAIN_LAYERS)
    res = _train_rank(mesh, cfg, train_holder,
                      proc_data(cfg, TRAIN_BATCH, TRAIN_SEQ),
                      proc_train_options(TRAIN_PROC_STEPS), TRAIN_PROC_STEPS,
                      True, None, hook=tp_train_child)
    out["train"], out["train_metrics"] = res["hook"], res["metrics"]
    return out


def dense_child(mesh, cfg32, shards, rows, serve_cli):
    """One rank of phase 11 (b): the f32 serve of its shard
    (``serve_procs``' own) and its f32 decode cache; then bf16 serving of
    its rows of the PROC_BATCH prompts, a prefill with the residual
    stream's digests and a traced prefill."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.convert import recast
    from repro_torch.launch.serve import make_prefill_step

    kernels = proc_kernels()
    cfg = dense_config()
    out = {"rank": mesh.rank, "coords": mesh.rank_coords, "used_gb": {},
           "shard_gb": param_gb(shards[0]),
           "kv_heads": shards[0].blocks[0].attn.wk.shape[-1]
           // cfg.resolved_head_dim}
    out["used_gb"]["after the parent's drop"] = card_used_gb(torch)
    torch.cuda.reset_peak_memory_stats()
    serve_cli()
    pre32 = make_prefill_step(cfg32, mesh, None, None,
                              cache_len=PROMPT + GEN, device=DEVICE)
    _, cache = pre32(shards[0], {"tokens": rows})
    out["cache"] = [(c["k"].cpu(), c["v"].cpu()) for c in cache]
    del cache
    shard = recast(shards.pop(), cfg)
    free(torch)
    dp = dp_index(mesh.rank_coords, TP_DENSE_MESH)
    b = PROC_BATCH // TP_DENSE_MESH[1]
    prompts = stack_prompts(torch, cfg, PROC_BATCH, PROMPT)[
        dp * b:(dp + 1) * b]
    run = serve(torch, cfg, shard, mesh, None, None, prompts, kernels,
                pick=tp_pick(cfg, mesh, None, None))
    out["used_gb"]["serving"] = card_used_gb(torch)
    out["serve"] = {k: run[k] for k in (
        "prefill_s", "decode_s", "decode_steps", "step_ms_median",
        "step_ms_max", "prefill_launches", "decode_launches")}
    out["serve"].update(logits=run["logits"].cpu(),
                        last_logits=run["last_logits"].cpu(),
                        tokens=run["tokens"].cpu())
    del run
    prefill = make_prefill_step(cfg, mesh, None, None,
                                cache_len=PROMPT + GEN, device=DEVICE)
    with torch.no_grad(), StreamRecorder(torch) as st:
        prefill(shard, {"tokens": prompts})
    out["stream"] = st.digests
    out["shares"] = tp_shares(torch, prefill, shard, {"tokens": prompts})
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def phase_tp_dense(torch, kernels):
    """Phase 11 (b): llama3.2-1b (all 16 layers) on 4 processes of (1, 2,
    2), against ``LocalMesh((1, 2, 1))``.  Returns rank 0's launch counts
    and a summary."""
    from repro_torch.convert import recast
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import make_prefill_step, serve_procs

    cfg = dense_config()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    local = make_mesh(TP_DENSE_MESH[:2] + (1,), AXES, torch.device(DEVICE))
    n, tp = ranks_of(TP_DENSE_MESH), TP_DENSE_MESH[2]
    label = "tp[b]"
    log(f"{label}: {cfg.name} layers={cfg.n_layers} at its published "
        f"config on a {TP_DENSE_MESH} mesh of {n} processes "
        f"({PROC_BACKEND}): {cfg.n_heads // tp} of {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads // tp} of {cfg.n_kv_heads} kv heads, FFN "
        f"{cfg.d_ff // tp} of {cfg.d_ff}, the tied embedding and head "
        f"{cfg.vocab // tp} of {cfg.vocab} rows a process; bf16 on "
        f"{PROC_BATCH} prompts of {PROMPT} tokens and {GEN - 1} decode "
        f"steps, f32 on {DENSE_F32_BATCH}; {TP_LABEL}")
    summary = {"label": TP_LABEL, "used_gb": {}}
    params32 = stack_params(torch, cfg32)
    short = stack_prompts(torch, cfg, DENSE_F32_BATCH, PROMPT)
    loc32 = serve(torch, cfg32, params32, local, None, None, short, kernels,
                  warmup=False)
    pre32 = make_prefill_step(cfg32, local, None, None,
                              cache_len=PROMPT + GEN, device=DEVICE)
    with torch.no_grad():
        _, cache = pre32(params32, {"tokens": short})
    want_cache = [(c["k"].cpu(), c["v"].cpu()) for c in cache]
    del cache
    params = recast(params32, cfg)
    prompts = stack_prompts(torch, cfg, PROC_BATCH, PROMPT)
    loc = serve(torch, cfg, params, local, None, None, prompts, kernels,
                keep_logits=True)
    check_stack_run(torch, loc, cfg, PROC_BATCH, f"{label}[local oracle]",
                    cfg.n_layers)
    summary["oracle"] = {"prefill_ms": loc["prefill_s"] * 1e3,
                         "decode_ms_per_step": loc["decode_s"]
                         / loc["decode_steps"] * 1e3}
    with TPRounding(tp):
        wit = serve(torch, cfg, params, local, None, None, prompts, kernels,
                    keep_logits=True)
    del params
    free(torch)
    summary["used_gb"]["parent, whole f32 model"] = card_used_gb(torch)
    holder = [params32]
    del params32
    t0 = time.perf_counter()
    res = serve_procs(cfg32, holder, short, TP_DENSE_MESH, PROC_BACKEND,
                      DEVICE, None, None, GEN, hook=dense_child,
                      timeout=PROC_TIMEOUT_S, join_timeout=PROC_JOIN_S)
    summary["processes_s"] = time.perf_counter() - t0
    summary["used_gb"].update(res.get("card_used_gb", {}))
    outs = res["ranks"]
    if {o["kv_heads"] for o in outs} != {cfg.n_kv_heads // tp}:
        raise AssertionError(f"{label}: kv heads a process "
                             f"{[o['kv_heads'] for o in outs]}")

    err32 = rel_err(torch, res["logits"][0], loc32["logits"].cpu())
    same32 = bool(torch.equal(res["tokens"], loc32["tokens"].cpu()))
    cache_err = 0.0
    for i, (k, v) in enumerate(want_cache):
        for j, w in enumerate((k, v)):
            got = assemble(outs, TP_DENSE_MESH, lambda o: o["cache"][i][j],
                           2)
            if got.shape != w.shape:
                raise AssertionError(f"{label}: layer {i}'s cache gathered "
                                     f"{tuple(got.shape)}, the oracle's "
                                     f"{tuple(w.shape)}")
            cache_err = max(cache_err, rel_err(torch, got, w))
    log(f"{label}[f32]: serve_procs' prefill logits gathered over 'data' "
        f"and 'model', max rel diff {err32:.3e} against LocalMesh (limit "
        f"1e-4); greedy tokens of the prefill and {GEN - 1} steps equal "
        f"{same32}; each process's decode cache ({cfg.n_kv_heads // tp} kv "
        f"heads), gathered by rows and heads, within {cache_err:.3e} of the "
        f"oracle's (limit 1e-5)")
    if not (err32 < 1e-4 and same32 and cache_err <= 1e-5):
        raise AssertionError(f"{label}: f32 {err32}, tokens equal {same32}, "
                             f"cache {cache_err}")
    summary["f32"] = {"max_rel_diff": err32, "tokens_equal": same32,
                      "cache_rel_diff": cache_err}

    want_l = run_counts(loc)
    check_tp_launches(outs, want_l, label)
    b = PROC_BATCH // TP_DENSE_MESH[1]
    for o in outs:
        for t in (o["serve"]["logits"], o["serve"]["last_logits"]):
            if tuple(t.shape) != (b, cfg.vocab // tp) or \
                    not bool(torch.isfinite(t.float()).all()):
                raise AssertionError(f"{label}: rank {o['rank']}'s logits "
                                     f"{tuple(t.shape)}")
    check_peers(outs, lambda o: o["serve"]["tokens"].tolist(), label,
                "the greedy tokens")
    check_peers(outs, lambda o: o["stream"], label,
                "the residual stream's digest after a layer")
    logits = assemble(outs, TP_DENSE_MESH, lambda o: o["serve"]["logits"],
                      -1)
    tokens = by_dp(outs, TP_DENSE_MESH, lambda o: o["serve"]["tokens"])
    gaps = token_tie_gaps(torch, loc, tokens,
                          torch.zeros(PROC_BATCH, dtype=torch.bool))
    # how near a tie the oracle's greedy choices are: the gate's reach, and
    # a control at their median that it must refuse
    top = torch.stack([lg.float().topk(2, dim=-1).values
                       for lg in loc["step_logits"]])
    oracle_gaps = ((top[..., 0] - top[..., 1])
                   / torch.stack([lg.float().abs().amax(-1)
                                  for lg in loc["step_logits"]])).reshape(-1)
    within = int((oracle_gaps <= TP_BF16_TIE).sum())
    control = float(oracle_gaps.median())
    summary["bf16"] = {
        "max_rel_diff": rel_err(torch, logits, loc["logits"].cpu()),
        "sequences_same_tokens": int((tokens == loc["tokens"].cpu())
                                     .all(-1).sum()),
        "token_gaps": gaps, "oracle_choices_within_tie": within,
        "median_oracle_gap": control}
    log(f"{label}[bf16]: every process launched flash_attention "
        f"{want_l['prefill']['flash_attention']} times in the prefill and "
        f"nothing else, as the oracle; the residual stream after each of "
        f"the {cfg.n_layers} layers bit-identical on model peers; prefill "
        f"logits max rel diff {summary['bf16']['max_rel_diff']:.3e}; greedy "
        f"tokens equal in {summary['bf16']['sequences_same_tokens']} of "
        f"{PROC_BATCH}; each sequence whose tokens differ (sequence, step, "
        f"oracle gap): {gaps} (limit {TP_BF16_TIE}; {within} of "
        f"{oracle_gaps.numel()} oracle choices lie within it, their median "
        f"gap {control:.3e})")
    w = summary["witness"] = witness_tokens(
        torch, wit, loc, tokens, logits,
        torch.zeros(PROC_BATCH, dtype=torch.bool))
    log(f"{label}[bf16 against the witness, the oracle with TP's rounding "
        f"of the row-parallel products alone]: prefill logits max rel diff "
        f"{w['logits_rel_diff']:.3e} (bit-identical {w['logits_equal']}); "
        f"greedy tokens equal in {w['sequences_same_tokens']} of "
        f"{PROC_BATCH} (the plain oracle's in "
        f"{w['oracle_sequences_same_tokens']}); each sequence whose tokens "
        f"differ (sequence, step, witness gap): {w['token_gaps']} (limit "
        f"{BF16_TOKEN_TIE}; one planted at the median gap reads "
        f"{w['planted_token_gap']:.3e})")
    check_witness_tokens(label, w)
    if not all(g <= TP_BF16_TIE for _, _, g in gaps):
        raise AssertionError(f"{label}: bf16 token gaps {gaps}")
    if not control > TP_BF16_TIE:
        raise AssertionError(f"{label}: a token at the oracle's median gap "
                             f"({control}) passes the token gate")
    tp_report(outs, summary, label)
    r0 = next(o for o in outs if o["rank"] == 0)
    return {"prefill": r0["serve"]["prefill_launches"],
            "decode": r0["serve"]["decode_launches"]}, summary


def tp_train_child(mesh, cfg, shards, train, steps=TRAIN_PROC_STEPS):
    """One rank of phase 11 (c): ``train_proc_child``'s loop, each step's
    gradients of the leaves replicated over "model" kept as digests."""
    import torch

    from repro_torch.launch.shardings import sharded_axes
    from repro_torch.launch.train import train_specs

    specs = train_specs(cfg, mesh)
    whole = [k for k, spec in specs.items()
             if "model" not in sharded_axes(mesh, spec)]
    with GradSpy(on_grads=lambda i, g: {k: digest(torch, g[k])
                                        for k in whole}) as spy:
        out = train_proc_child(mesh, cfg, shards, train, steps)
    out.update(coords=mesh.rank_coords, replicated=spy.grads)
    return out


@contextlib.contextmanager
def copy_on_x():
    """Phase 11 (c)'s planted fault: the copy into the TP region on the
    MoE's input ``x`` instead of its token grid (the grid still summed over
    "model"), which adds the router's share of ``dx`` once a model peer."""
    from repro_torch.models import moe, transformer
    from repro_torch.models.tp import copy_in, sum_out, tp_mesh

    real_apply, real_ffn = transformer.moe_apply, moe._expert_ffn

    def apply(cfg, p, x, dist=None, **kw):
        return real_apply(cfg, p, copy_in(tp_mesh(dist), x), dist, **kw)

    def ffn(cfg, w_gate, w_up, w_down, tokens, counts=None, use_kernel=True,
            tp=None):
        return sum_out(tp, real_ffn(cfg, w_gate, w_up, w_down, tokens,
                                    counts, use_kernel))

    transformer.moe_apply, moe._expert_ffn = apply, ffn
    try:
        yield
    finally:
        transformer.moe_apply, moe._expert_ffn = real_apply, real_ffn


def phase_tp_train(torch, kernels, outs, metrics):
    """Phase 11 (c): megatron-moe-32e (TP_TRAIN_LAYERS layer) trained on the
    8 processes of (2, 2, 2) (their ``tp_train_child`` results ``outs`` and
    rank 0's step ``metrics``, from (a)'s spawn) against the stacked oracle
    on (2, 2, 1); then the f32 gate with the planted copy on ``x``.
    Returns rank 0's launches over its steps and a summary."""
    cfg = train_config(n_layers=TP_TRAIN_LAYERS)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    label = "tp[c]"
    log(f"{label}: {cfg.name} layers={cfg.n_layers}/24 at its published "
        f"widths on a {TP_MESH} mesh of {ranks_of(TP_MESH)} processes "
        f"({PROC_BACKEND}) through train_procs' per-rank path, in (a)'s "
        f"processes; {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step, "
        f"{TRAIN_PROC_STEPS} AdamW steps; {TP_LABEL}")
    oracle = local_oracle(torch, cfg, TRAIN_BATCH, TRAIN_SEQ,
                          TRAIN_PROC_STEPS, kernels)
    summary = {"label": TP_LABEL, "oracle": {
        "step_ms": oracle["step_ms"], "peak_gb": oracle["peak_gb"]}}
    check_proc_launches(outs, oracle, cfg.n_layers, label)
    check_peers(outs, lambda o: o["replicated"], label,
                "a gradient of a leaf replicated over 'model'")
    diffs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
             for a, b in zip(metrics, oracle["metrics"])]
    n_whole = len(outs[0]["replicated"][0])
    log(f"{label}: every process launched each kernel as often as the "
        f"oracle each step ({oracle['launches'][0]}); the gradients of the "
        f"{n_whole} leaves replicated over 'model' bit-identical on model "
        f"peers every step; step losses "
        f"{[round(m['loss'], 6) for m in metrics]} against the "
        f"oracle's, relative differences {[f'{d:.3e}' for d in diffs]} "
        f"(limit 2e-2)")
    if not max(diffs) < 2e-2:
        raise AssertionError(f"{label}: step losses against the oracle "
                             f"{diffs}")
    summary.update(loss_diffs=diffs, ranks=[])
    for o in outs:
        ms = o["train"]["step_ms"]
        r = {"rank": o["rank"], "coords": list(o["coords"]), "step_ms": ms,
             "tokens_per_s": tokens / 4 / ms[1] * 1e3,
             "peak_gb": o["peak_gb"], "card_gb": max(o["card_gb"]),
             "shard_gb": o["shard_gb"], **o["trace"]}
        summary["ranks"].append(r)
        log(f"{label}[rank {o['rank']} {tuple(o['coords'])}]: step ms "
            f"{[round(x, 3) for x in ms]} (step {TRAIN_PROC_STEPS - 1} "
            f"traced); {r['tokens_per_s']:.1f} tokens/s of its DP rank's "
            f"rows at step 1; peak {o['peak_gb']:.2f} GB (f32 shard "
            f"{o['shard_gb']:.2f} GB); the card {r['card_gb']:.2f} GB in "
            f"use; traced step {r['host_ms']:.3f} ms: exchange share "
            f"{r['exchange_share']:.4f}, sums over 'model' "
            f"{r['tp_share']:.4f} ({r['tp_sums']} sums), gradient sync "
            f"{r['sync_share']:.4f}; {TP_LABEL}")
    counts = {k: sum(step[k] for step in outs[0]["launches"])
              for k in outs[0]["launches"][0]}
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    summary["f32"] = train_procs_f32_gate(
        torch, kernels, TP_MESH, label, copy_on_x,
        "the copy into the TP region on the MoE's x instead of its token "
        "grid")
    del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
    return counts, summary


def phase_tp(torch, kernels):
    """Phase 11: (a) megatron-moe-32e served on (2, 2, 2), (b) llama3.2-1b
    served on (1, 2, 2), (c) megatron-moe-32e trained on (2, 2, 2).
    Returns each serving path's launches, the training's and a summary."""
    summary, launches = {}, {}
    t0 = time.perf_counter()
    launches[TP_PATH], summary["a"], trained = phase_tp_serve(torch,
                                                              kernels)
    summary["a_s"] = time.perf_counter() - t0
    free(torch)
    t0 = time.perf_counter()
    launches[TP_DENSE_PATH], summary["b"] = phase_tp_dense(torch, kernels)
    summary["b_s"] = time.perf_counter() - t0
    free(torch)
    t0 = time.perf_counter()
    train, summary["c"] = phase_tp_train(torch, kernels, *trained)
    summary["c_s"] = time.perf_counter() - t0
    return launches, train, summary


def kv_config(**over):
    """megatron-moe-32e at its published widths, depth cut to KV_LAYERS."""
    from repro_torch.configs import get_config

    return get_config(ARCH, **{"n_layers": KV_LAYERS, **over})


class NextKVHead:
    """While active, every process reads the next kv head (cyclically) in
    place of each one its query heads read (``layers.kv_heads``): phase
    12's planted fault on the serving path."""

    def __init__(self):
        from repro_torch.models import layers
        self.layers = layers

    def __enter__(self):
        self.real = real = self.layers.kv_heads

        def shifted(n_heads, n_kv_heads, *place):
            return tuple((k + 1) % n_kv_heads
                         for k in real(n_heads, n_kv_heads, *place))
        self.layers.kv_heads = shifted
        return self

    def __exit__(self, *exc):
        self.layers.kv_heads = self.real


@contextlib.contextmanager
def gather_bwd_unsummed():
    """Phase 12 (b)'s planted fault on the training path: the backward of
    the keys' and values' gather over "model" (``tp.gather_cols``) keeps
    this process's own slice of the cotangent, without the peers' parts."""
    from repro_torch.models import tp

    real = tp._GatherCols.backward

    def local(ctx, g):
        c = g.shape[-1] // ctx.tp.axis_size("model")
        return None, g.narrow(-1, tp.model_coord(ctx.tp) * c, c).contiguous()

    tp._GatherCols.backward = staticmethod(local)
    try:
        yield
    finally:
        tp._GatherCols.backward = staticmethod(real)


def kv_child(mesh, cfg32, shards, rows, serve_cli):
    """One rank of phase 12 (a), the per-rank hook of ``serve_procs``: the
    f32 serve of its shard (``serve_procs``' own: prefill and 15 greedy
    steps gathered over "model") with its routing recorded; an f32 prefill
    for its decode cache (the kv heads its query heads read) and one under
    the planted fault (``NextKVHead``); the bf16 serving run; a prefill
    with the residual stream's digest after every layer; the shares of a
    traced prefill.  Returns host tensors and digests."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.convert import recast
    from repro_torch.launch.serve import make_prefill_step

    kernels = proc_kernels()
    cfg = kv_config()
    attn = shards[0].blocks[0].attn
    out = {"rank": mesh.rank, "coords": mesh.rank_coords, "used_gb": {},
           "shard_gb": param_gb(shards[0]),
           "widths": (attn.wq.shape[-1], attn.wk.shape[-1]),
           "experts": tuple(shards[0].blocks[0].moe.w_gate.shape)}
    out["used_gb"]["after the parent's drop"] = card_used_gb(torch)
    torch.cuda.reset_peak_memory_stats()
    with RouteRecorder() as rec:         # the prefill's, then each step's
        serve_cli()
    out["f32_routes"] = [e.cpu() for e in rec.eids[:len(rec.eids) // GEN]]
    pre32 = make_prefill_step(cfg32, mesh, None, None,
                              cache_len=PROMPT + GEN, device=DEVICE)
    with torch.no_grad():
        _, cache = pre32(shards[0], {"tokens": rows})
        out["cache"] = [(c["k"].cpu(), c["v"].cpu()) for c in cache]
        del cache
        with NextKVHead():
            out["fault"] = pre32(shards[0], {"tokens": rows})[0].cpu()

    shard = recast(shards.pop(), cfg)
    free(torch)
    run = serve(torch, cfg, shard, mesh, None, None, rows, kernels,
                record=True, pick=tp_pick(cfg, mesh, None, None))
    out["used_gb"]["serving"] = card_used_gb(torch)
    out["serve"] = {k: run[k] for k in (
        "prefill_s", "decode_s", "decode_steps", "step_ms_median",
        "step_ms_max", "prefill_launches", "decode_launches",
        "prefill_variants", "decode_variants")}
    out["serve"].update(logits=run["logits"].cpu(),
                        last_logits=run["last_logits"].cpu(),
                        tokens=run["tokens"].cpu(),
                        routes=[e.cpu() for e in run["routes"]])
    del run
    prefill = make_prefill_step(cfg, mesh, None, None,
                                cache_len=PROMPT + GEN, device=DEVICE)
    with torch.no_grad(), StreamRecorder(torch) as st:
        prefill(shard, {"tokens": rows})
    out["stream"] = st.digests
    out["shares"] = tp_shares(torch, prefill, shard, {"tokens": rows})
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def kv_cell_child(mesh, cfg32, shards, rows, serve_cli, train_holder):
    """One rank of phase 12 (a) and (b) in one spawn: ``kv_child``'s
    serving, then ``train_procs``' per-rank path (``launch/train.
    _train_rank``) on this process's shard of the 1-layer model in
    ``train_holder`` (shared by the parent through CUDA IPC), each step as
    ``tp_train_child`` reads it.  Starting and ending 16 processes on the
    card takes about 45 s, once for both."""
    import torch

    from repro_torch.launch.train import _train_rank

    out = kv_child(mesh, cfg32, shards, rows, serve_cli)
    free(torch)
    cfg = train_config(n_layers=1)
    res = _train_rank(mesh, cfg, train_holder,
                      proc_data(cfg, KV_TRAIN_BATCH, TRAIN_SEQ),
                      proc_train_options(TRAIN_PROC_STEPS), TRAIN_PROC_STEPS,
                      True, None, hook=tp_train_child)
    out["train"], out["train_metrics"] = res["hook"], res["metrics"]
    return out


def kv_report(outs, summary, label):
    """Each process's serving numbers, the shares of its traced prefill by
    range (the kv gather, ``procmesh.tp_gather``, and the sums,
    ``procmesh.tp_sum``) and the card's memory, logged and kept in
    ``summary``."""
    tp_report(outs, summary, label)
    for o, r in zip(outs, summary["ranks"]):
        spans = o["shares"]["tp_by_span"]
        r["tp_by_span"] = spans
        log(f"{label}[rank {o['rank']}]: traced prefill "
            f"{o['shares']['host_ms']:.3f} ms by range over 'model': " +
            "; ".join(f"{n} {v['share']:.4f} ({v['calls']} calls)"
                      for n, v in spans.items()) + f"; {TP_LABEL}")


def phase_kv_serve(torch, kernels):
    """Phase 12 (a): megatron-moe-32e (KV_LAYERS layers) on 16 processes of
    (1, 1, 16), where "model" cuts through the 8 kv heads, against
    ``LocalMesh((1, 1, 1))`` (whole weights); the same processes then train
    (b)'s 1-layer model (``kv_cell_child``).  Returns rank 0's launch
    counts, a summary and (b)'s oracle, processes and rank 0's step
    metrics."""
    from repro_torch.convert import recast
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import make_prefill_step, serve_procs
    from repro_torch.launch.shardings import whole_kv_heads
    from repro_torch.models.tp import kv_heads

    cfg = kv_config()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    local = make_mesh(KV_MESH[:2] + (1,), AXES, torch.device(DEVICE))
    prompts = stack_prompts(torch, cfg, PROC_BATCH, PROMPT)
    n, tp = ranks_of(KV_MESH), KV_MESH[2]
    dh = cfg.resolved_head_dim
    label = "kv[a]"
    log(f"{label}: {cfg.name} layers={cfg.n_layers}/24 at its published "
        f"widths on a {KV_MESH} mesh of {n} processes ({PROC_BACKEND}): "
        f"{cfg.n_heads // tp} of {cfg.n_heads} heads and "
        f"{cfg.n_kv_heads * dh // tp} of the {cfg.n_kv_heads * dh} key and "
        f"value columns ({cfg.n_kv_heads} kv heads of {dh}: half a head), "
        f"gathered over 'model' to the 1 kv head its heads read; "
        f"{cfg.moe.num_experts} experts of [{cfg.d_model}, "
        f"{cfg.d_ff // tp}] and {cfg.vocab // tp} of {cfg.vocab} vocabulary "
        f"rows a process; {PROC_BATCH} prompts of {PROMPT} tokens on every "
        f"process (no DP axis) and {GEN - 1} decode steps; {TP_LABEL}")
    summary = {"label": TP_LABEL, "used_gb": {}}

    torch.cuda.reset_peak_memory_stats()
    params32 = stack_params(torch, cfg32)
    loc32 = serve(torch, cfg32, params32, local, None, None, prompts,
                  kernels, warmup=False, record="margins")
    with torch.no_grad():
        _, cache = make_prefill_step(cfg32, local, None, None,
                                     cache_len=PROMPT + GEN, device=DEVICE)(
            params32, {"tokens": prompts})
    want_cache = [(c["k"].cpu(), c["v"].cpu()) for c in cache]
    del cache
    params = recast(params32, cfg)
    loc = serve(torch, cfg, params, local, None, None, prompts, kernels,
                record="margins", keep_logits=True)
    check_run(torch, loc, cfg, PROC_BATCH, f"{label}[local oracle]",
              ("grouped_matmul", "flash_attention"))
    summary["oracle"] = {"prefill_ms": loc["prefill_s"] * 1e3,
                         "decode_ms_per_step": loc["decode_s"]
                         / loc["decode_steps"] * 1e3}
    # the witness: the same run with TP's rounding of the row-parallel
    # products alone (TPRounding)
    with TPRounding(tp):
        wit = serve(torch, cfg, params, local, None, None, prompts,
                    kernels, record="margins", keep_logits=True)
    del params
    free(torch)
    summary["used_gb"]["parent, whole f32 model"] = card_used_gb(torch)

    tcfg = train_config(n_layers=1)
    train_holder = [{k: v.detach() for k, v in stack_params(
        torch, tcfg, train=True).named_parameters()}]
    holder = [params32]
    del params32
    # the children's allocator only: the parent's tensors they map through
    # CUDA IPC were allocated before
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    res = serve_procs(cfg32, holder, prompts, KV_MESH, PROC_BACKEND, DEVICE,
                      None, None, GEN,
                      hook=functools.partial(kv_cell_child,
                                             train_holder=train_holder),
                      timeout=PROC_TIMEOUT_S, join_timeout=PROC_JOIN_S)
    summary["processes_s"] = time.perf_counter() - t0
    del os.environ["PYTORCH_CUDA_ALLOC_CONF"], train_holder
    free(torch)
    torch.cuda.ipc_collect()  # the training model the processes mapped
    # (b)'s stacked oracle, once the card is free of the processes
    oracle = local_oracle(torch, tcfg, KV_TRAIN_BATCH, TRAIN_SEQ,
                          TRAIN_PROC_STEPS, kernels,
                          shape=KV_MESH[:2] + (1,))
    summary["used_gb"].update(res.get("card_used_gb", {}))
    outs = sorted(res["ranks"], key=lambda o: o["coords"][2])
    r0 = next(o for o in outs if o["rank"] == 0)
    trained = (oracle, [o["train"] for o in res["ranks"]],
               r0["train_metrics"])
    widths = {o["widths"] for o in outs}
    experts = {o["experts"] for o in outs}
    if widths != {(cfg.n_heads * dh // tp, cfg.n_kv_heads * dh // tp)} or \
            experts != {(cfg.moe.num_experts, cfg.d_model, cfg.d_ff // tp)}:
        raise AssertionError(f"{label}: wq/wk widths {widths}, expert "
                             f"stacks {experts}")

    # f32: serve_procs' gather against the oracle; the caches by kv head
    err32 = rel_err(torch, res["logits"][0], loc32["logits"].cpu())
    routes32 = [outs[0]["f32_routes"][i] for i in range(len(loc32["routes"]))]
    flips32, n_dec, tie = near_tie_flips(torch, loc32["routes"], routes32,
                                         loc32["margins"], PROC_BATCH)
    same32 = bool(torch.equal(res["tokens"], loc32["tokens"].cpu()))
    cache_err, held = 0.0, set()
    for o in outs:
        sel = kv_heads(cfg.n_heads, cfg.n_kv_heads, tp, o["coords"][2])
        held.add(sel)
        if {tuple(k.shape) for k, _ in o["cache"]} != {
                (PROC_BATCH, PROMPT + GEN, len(sel), dh)}:
            raise AssertionError(f"{label}: rank {o['rank']}'s cache "
                                 f"{[tuple(k.shape) for k, _ in o['cache']]}")
    for i, (k, v) in enumerate(want_cache):
        for j, w in enumerate((k, v)):
            # raises where two replicas of a kv head differ
            got = whole_kv_heads([o["cache"][i][j] for o in outs], cfg)
            cache_err = max(cache_err, rel_err(torch, got, w))
    fault = rel_err(torch, torch.cat([o["fault"] for o in outs], -1),
                    loc32["logits"].cpu())
    log(f"{label}[f32]: serve_procs' prefill logits gathered over 'model', "
        f"max rel diff {err32:.3e} against LocalMesh (limit 1e-4); {flips32} "
        f"of {n_dec} routing decisions differ, each sequence's first at an "
        f"oracle margin of at most {tie:.3e} (near-tie limit {NEAR_TIE}); "
        f"greedy tokens of the prefill and {GEN - 1} steps equal {same32}; "
        f"each process's decode cache holds kv heads "
        f"{sorted(held)} (one a process, each on the {tp // cfg.n_kv_heads} "
        f"peers whose heads read it, the replicas bit-identical), put "
        f"together within {cache_err:.3e} of the oracle's (limit 1e-5); "
        f"under the planted fault (every process reading the next kv head) "
        f"the logits lie {fault:.3e} apart: the gate (1e-4) "
        f"{'refuses' if fault > 1e-4 else 'PASSES'} it")
    if not (err32 < 1e-4 and tie <= NEAR_TIE and same32
            and cache_err <= 1e-5):
        raise AssertionError(f"{label}: f32 prefill {err32}, routing tie "
                             f"{tie}, tokens equal {same32}, cache "
                             f"{cache_err}")
    if not fault > 1e-4:
        raise AssertionError(f"{label}: the planted fault (the next kv "
                             f"head) passes the f32 gate ({fault})")
    summary["f32"] = {"max_rel_diff": err32, "routing_differs": flips32,
                      "first_difference_margin": tie, "tokens_equal": same32,
                      "cache_rel_diff": cache_err,
                      "planted_next_kv_head_rel_diff": fault}

    # bf16: launches, the peers alike, held to the witness
    want_l = run_counts(loc)
    check_tp_launches(outs, want_l, label)
    for o in outs:
        check_run(torch, o["serve"], cfg, PROC_BATCH,
                  f"{label}[rank {o['rank']}]",
                  ("grouped_matmul", "flash_attention"),
                  vocab=cfg.vocab // tp)
    check_peers(outs, lambda o: o["serve"]["tokens"].tolist(), label,
                "the greedy tokens")
    check_peers(outs, lambda o: o["stream"], label,
                "the residual stream's digest after a layer")
    logits = torch.cat([o["serve"]["logits"] for o in outs], -1)
    tokens = outs[0]["serve"]["tokens"]
    routes = outs[0]["serve"]["routes"]
    w_routes = [e.cpu() for e in wit["routes"]]
    n_flip, n_dec, per_layer, per_seq = route_flips(torch, w_routes, routes,
                                                    PROC_BATCH)
    o_flip, _, o_layer, o_seq = route_flips(
        torch, w_routes, [e.cpu() for e in loc["routes"]], PROC_BATCH)
    w = witness_tokens(torch, wit, loc, tokens, logits, per_seq)
    w.update(routing_differs=n_flip, per_layer=per_layer,
             sequences_routed_apart=int(per_seq.sum()),
             oracle_routing_differs=o_flip, oracle_per_layer=o_layer,
             oracle_sequences_routed_apart=int(o_seq.sum()),
             oracle_logits_rel_diff=rel_err(torch, logits,
                                            loc["logits"].cpu()))
    summary["witness"] = w
    log(f"{label}[bf16]: every process launched each kernel as often as the "
        f"oracle (prefill {want_l['prefill']}, decode {want_l['decode']}): "
        f"flash_attention on {cfg.n_heads // tp} heads over 1 kv head, "
        f"grouped_matmul on TMA alone at [{cfg.moe.num_experts}, rows, "
        f"{cfg.d_model}] @ [{cfg.moe.num_experts}, {cfg.d_model}, "
        f"{cfg.d_ff // tp}]; the residual stream after each of the "
        f"{cfg.n_layers} layers and the greedy tokens bit-identical on the "
        f"{tp} model peers; against the witness (the oracle with TP's "
        f"rounding of the row-parallel products alone): routing differs in "
        f"{n_flip} of {n_dec} decisions (per layer {per_layer}), in "
        f"{w['sequences_routed_apart']} of {PROC_BATCH} sequences (limit "
        f"{PROC_BF16_APART_MAX}); the plain oracle against it: {o_flip} "
        f"decisions (per layer {o_layer}), "
        f"{w['oracle_sequences_routed_apart']} sequences; prefill logits max "
        f"rel diff {w['logits_rel_diff']:.3e} (bit-identical "
        f"{w['logits_equal']}; {w['oracle_logits_rel_diff']:.3e} from the "
        f"plain oracle's); greedy tokens equal in "
        f"{w['sequences_same_tokens']} of {PROC_BATCH} (the plain oracle's "
        f"in {w['oracle_sequences_same_tokens']}); each sequence routed "
        f"alike whose tokens differ (sequence, step, witness gap): "
        f"{w['token_gaps']} (limit {BF16_TOKEN_TIE}; one planted at the "
        f"median gap reads {w['planted_token_gap']:.3e})")
    check_witness_tokens(label, w)
    if not w["sequences_routed_apart"] <= PROC_BF16_APART_MAX:
        raise AssertionError(f"{label}: {w['sequences_routed_apart']} "
                             f"sequences routed apart from the witness")
    if not w["oracle_sequences_routed_apart"] > PROC_BF16_APART_MAX:
        raise AssertionError(f"{label}: the plain oracle passes the "
                             f"witness's routing gate")
    kv_report(outs, summary, label)
    return {"prefill": r0["serve"]["prefill_launches"],
            "decode": r0["serve"]["decode_launches"]}, summary, trained


def phase_kv_train(torch, kernels, oracle, outs, metrics):
    """Phase 12 (b): megatron-moe-32e (1 layer) trained on the 16 processes
    of (1, 1, 16) (their ``tp_train_child`` results ``outs`` and rank 0's
    step ``metrics``, from (a)'s spawn) against the stacked oracle on (1,
    1, 1); then the f32 gate with the kv gather's backward unsummed
    planted.  Returns rank 0's launches over its steps and a summary."""
    cfg = train_config(n_layers=1)
    tokens = KV_TRAIN_BATCH * TRAIN_SEQ
    label = "kv[b]"
    log(f"{label}: {cfg.name} layers={cfg.n_layers}/24 at its published "
        f"widths on a {KV_MESH} mesh of {ranks_of(KV_MESH)} processes "
        f"({PROC_BACKEND}) through train_procs' per-rank path, in (a)'s "
        f"processes; {KV_TRAIN_BATCH} x {TRAIN_SEQ} tokens a step on every "
        f"process (no DP axis), {TRAIN_PROC_STEPS} AdamW steps; {TP_LABEL}")
    summary = {"label": TP_LABEL, "oracle": {
        "step_ms": oracle["step_ms"], "peak_gb": oracle["peak_gb"]}}
    check_proc_launches(outs, oracle, cfg.n_layers, label)
    check_peers(outs, lambda o: o["replicated"], label,
                "a gradient of a leaf replicated over 'model'")
    diffs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
             for a, b in zip(metrics, oracle["metrics"])]
    log(f"{label}: every process launched each kernel as often as the "
        f"oracle each step ({oracle['launches'][0]}); the gradients of the "
        f"{len(outs[0]['replicated'][0])} leaves replicated over 'model' "
        f"bit-identical on the {KV_MESH[2]} model peers every step; step "
        f"losses {[round(m['loss'], 6) for m in metrics]} against "
        f"the oracle's, relative differences {[f'{d:.3e}' for d in diffs]} "
        f"(limit 2e-2)")
    if not max(diffs) < 2e-2:
        raise AssertionError(f"{label}: step losses against the oracle "
                             f"{diffs}")
    summary.update(loss_diffs=diffs, ranks=[])
    for o in outs:
        ms = o["train"]["step_ms"]
        r = {"rank": o["rank"], "coords": list(o["coords"]), "step_ms": ms,
             "tokens_per_s": tokens / ms[1] * 1e3,
             "peak_gb": o["peak_gb"], "card_gb": max(o["card_gb"]),
             "shard_gb": o["shard_gb"], **o["trace"]}
        summary["ranks"].append(r)
        log(f"{label}[rank {o['rank']} {tuple(o['coords'])}]: step ms "
            f"{[round(x, 3) for x in ms]} (step {TRAIN_PROC_STEPS - 1} "
            f"traced); {r['tokens_per_s']:.1f} tokens/s at step 1; peak "
            f"{o['peak_gb']:.2f} GB (f32 shard {o['shard_gb']:.2f} GB); the "
            f"card {r['card_gb']:.2f} GB in use; traced step "
            f"{r['host_ms']:.3f} ms: operators over 'model' "
            f"{r['tp_share']:.4f} ({r['tp_sums']} calls), gradient sync "
            f"{r['sync_share']:.4f}; {TP_LABEL}")
    counts = {k: sum(step[k] for step in outs[0]["launches"])
              for k in outs[0]["launches"][0]}
    free(torch)
    torch.cuda.ipc_collect()
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    summary["f32"] = train_procs_f32_gate(
        torch, kernels, KV_MESH, label, gather_bwd_unsummed,
        "the kv gather's backward keeping its own cotangent slice, without "
        "the sum over 'model'", batch=KV_TRAIN_BATCH, noise_unit="dp")
    del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
    return counts, summary


def phase_kv(torch, kernels):
    """Phase 12: megatron-moe-32e on (1, 1, 16), where "model" cuts through
    the kv heads: (a) served, (b) trained.  Returns the serving launches,
    the training's and a summary."""
    summary = {}
    t0 = time.perf_counter()
    serving, summary["a"], trained = phase_kv_serve(torch, kernels)
    summary["a_s"] = time.perf_counter() - t0
    free(torch)
    t0 = time.perf_counter()
    train, summary["b"] = phase_kv_train(torch, kernels, *trained)
    summary["b_s"] = time.perf_counter() - t0
    return {KV_PATH: serving}, train, summary


# -- phase 13: TP over "model" where it cuts through a query head -------------

def head_config(**over):
    """internvl2-1b at its published widths, depth cut to HEAD_LAYERS."""
    from repro_torch.configs import get_config

    return get_config(HEAD_ARCH, **{"n_layers": HEAD_LAYERS, **over})


def encdec_config(**over):
    """whisper-tiny at its published widths, depth cut to ENCDEC_LAYERS +
    ENCDEC_LAYERS."""
    return stack_config(WHISPER_ARCH, **{"n_layers": ENCDEC_LAYERS,
                                         "n_encoder_layers": ENCDEC_LAYERS,
                                         **over})


def first_attn(params):
    """The first self-attention of a decoder-only stack or an
    encoder-decoder."""
    return params.enc_blocks[0].attn if hasattr(params, "enc_blocks") \
        else params.blocks[0].attn


class NeighbourColumns:
    """While active, each process keeps the columns next to its own of the
    touched query heads' output (``layers._own_cols`` of the output rolled
    by its width), for its ``wo`` rows: phase 13's planted fault, on the
    serving path and in the f32 training gate."""

    def __init__(self):
        from repro_torch.models import encdec, layers
        self.mods = (layers, encdec)

    def __enter__(self):
        self.real = real = self.mods[0]._own_cols

        def shifted(out, off, cols):
            return real(out.roll(-cols, -1), off, cols)
        for m in self.mods:
            m._own_cols = shifted
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m._own_cols = self.real


class HeadDigests:
    """While active, the digest of each query head's output in every
    ``flash_attention`` call (``layers.flash_attention``), by global head:
    ``heads`` is the range this process's columns touch."""

    def __init__(self, torch, heads):
        from repro_torch.models import layers
        self.torch, self.layers, self.heads, self.calls = \
            torch, layers, heads, []

    def __enter__(self):
        self.real = real = self.layers.flash_attention

        def spy(q, k, v, **kw):
            o = real(q, k, v, **kw)
            self.calls.append({h: digest(self.torch, o[:, j])
                               for j, h in enumerate(self.heads)})
            return o
        self.layers.flash_attention = spy
        return self

    def __exit__(self, *exc):
        self.layers.flash_attention = self.real


class EncdecStream:
    """While active, the digest of the encoder-decoder's residual stream at
    every norm's input (``encdec.norm_apply``): the encoder's, then each
    decode step's."""

    def __init__(self, torch):
        from repro_torch.models import encdec
        self.torch, self.mod, self.digests = torch, encdec, []

    def __enter__(self):
        self.real = real = self.mod.norm_apply

        def spy(cfg, p, x):
            self.digests.append(digest(self.torch, x))
            return real(cfg, p, x)
        self.mod.norm_apply = spy
        return self

    def __exit__(self, *exc):
        self.mod.norm_apply = self.real


def prompt_pass(cfg, mesh, total):
    """``(params, batch) -> (last logits, cache)``: the serving prompt pass
    with a cache of ``total`` slots (an encoder-decoder's: the encoder and
    cross K/V, then the decode step over the prompt)."""
    from repro_torch.launch.serve import (_encdec_prefill, make_prefill_step,
                                          make_serve_step)

    if not cfg.encdec:
        return make_prefill_step(cfg, mesh, cache_len=total, device=DEVICE)
    step = make_serve_step(cfg, mesh, device=DEVICE)
    return lambda p, b: _encdec_prefill(cfg, mesh, p, b, total, step)


def head_inputs(torch, cfg, batch, prompt):
    """Phase 13's prompts and extras (internvl2-1b's patch embeddings,
    whisper-tiny's frames), made on the device from the seed."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    prompts = stack_prompts(torch, cfg, batch, prompt)
    if cfg.encdec:
        return prompts, {"frames": torch.randn(
            (batch, cfg.encoder_len, cfg.d_model), generator=gen,
            device=DEVICE) * 0.5}
    return prompts, {"patch_embeds": torch.randn(
        (batch, cfg.frontend_len, cfg.d_model), generator=gen,
        device=DEVICE) * 0.02}


def head_child(mesh, cfg32, shards, rows, serve_cli, config):
    """One rank of phase 13's serving, the per-rank hook of
    ``serve_procs``: the f32 serve of its shard (``serve_procs``' own:
    the prompt pass and 15 greedy steps gathered over the DP axes); an f32
    prompt pass for its decode cache (and cross cache) and one under the
    planted fault (``NeighbourColumns``); whisper's f32 teacher-forced
    forward; the bf16 serving run; a prompt pass with the residual stream's
    and each touched query head's output digests; the shares of a traced
    prompt pass.  Returns host tensors and digests."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.convert import recast
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.models.tp import model_coord, q_heads

    kernels = proc_kernels()
    cfg = config()
    attn = first_attn(shards[0])
    heads = q_heads(cfg.n_heads, cfg.resolved_head_dim, attn.wq.shape[-1],
                    model_coord(mesh))[0]
    out = {"rank": mesh.rank, "coords": mesh.rank_coords, "used_gb": {},
           "shard_gb": param_gb(shards[0]),
           "widths": (attn.wq.shape[-1], attn.wk.shape[-1],
                      shards[0].embed.shape[0]),
           "heads": (heads.start, heads.stop)}
    out["used_gb"]["after the parent's drop"] = card_used_gb(torch)
    torch.cuda.reset_peak_memory_stats()
    stages, t0 = {}, time.perf_counter()
    serve_cli()
    stages["f32 serve"] = time.perf_counter() - t0
    batch = {"tokens": rows, **serve_cli.extras}
    total = rows.shape[1] + GEN
    pre32 = prompt_pass(cfg32, mesh, total)
    with torch.no_grad():
        _, cache = pre32(shards[0], batch)
        out["cache"] = [{k: v.cpu() for k, v in c.items()} for c in cache]
        del cache
        with NeighbourColumns():
            out["fault"] = pre32(shards[0], batch)[0].cpu()
        if cfg.encdec:
            out["fwd32"] = make_prefill_step(cfg32, mesh, device=DEVICE)(
                shards[0], batch)[0].cpu()
    stages["f32 passes"] = time.perf_counter() - t0 - sum(stages.values())

    shard = recast(shards.pop(), cfg)
    free(torch)
    run = serve(torch, cfg, shard, mesh, None, None, rows, kernels,
                pick=tp_pick(cfg, mesh, None, None),
                extras=serve_cli.extras)
    out["used_gb"]["serving"] = card_used_gb(torch)
    out["serve"] = {k: run[k] for k in (
        "prefill_s", "decode_s", "decode_steps", "step_ms_median",
        "step_ms_max", "prefill_launches", "decode_launches")}
    out["serve"].update(logits=run["logits"].cpu(),
                        last_logits=run["last_logits"].cpu(),
                        tokens=run["tokens"].cpu())
    del run
    stages["bf16 serve"] = time.perf_counter() - t0 - sum(stages.values())
    pre = prompt_pass(cfg, mesh, total)
    stream = EncdecStream(torch) if cfg.encdec else StreamRecorder(torch)
    with torch.no_grad(), stream, HeadDigests(torch, heads) as hd:
        pre(shard, batch)
    out["stream"], out["head_digests"] = stream.digests, hd.calls
    out["shares"] = tp_shares(torch, pre, shard, batch)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    stages["digests and trace"] = time.perf_counter() - t0 - sum(
        stages.values())
    out["stages_s"] = stages
    return out


def whole_logits(outs, shape, get, vocab):
    """``get(o)`` of every process as the whole batch's logits: one model
    peer's where the vocabulary is whole on each, else the peers' shards
    joined; the DP ranks' rows joined."""
    if get(outs[0]).shape[-1] == vocab:
        return by_dp(outs, shape, get)
    return assemble(outs, shape, get, -1)


def check_shared_heads(outs, shape, label):
    """Every query head's output digest, in every ``flash_attention`` call
    of a prompt pass, the same on each model peer whose columns touch it;
    returns how many (call, head) pairs two or more peers shared."""
    shared = 0
    groups = {}
    for o in outs:
        groups.setdefault(dp_index(o["coords"], shape), []).append(o)
    for dp, group in groups.items():
        n_calls = {len(o["head_digests"]) for o in group}
        if len(n_calls) != 1:
            raise AssertionError(f"{label}: DP rank {dp}'s peers made "
                                 f"{n_calls} attention calls")
        for i in range(n_calls.pop()):
            seen = {}
            for o in group:
                for h, d in o["head_digests"][i].items():
                    seen.setdefault(h, []).append(d)
            for h, ds in seen.items():
                if len(set(ds)) != 1:
                    raise AssertionError(f"{label}: query head {h}'s output "
                                         f"differs between the peers that "
                                         f"touch it (call {i}, DP rank "
                                         f"{dp})")
                shared += len(ds) > 1
    return shared


def head_serve_oracles(torch, kernels, config, shape, batch, prompt, label):
    """Phase 13's serving oracles: ``config()`` on ``LocalMesh`` of
    ``shape``'s DP shape (whole weights), in f32 and bf16, and the bf16
    witness (``TPRounding``).  Returns them with the inputs and the f32
    parameters the processes take."""
    from repro_torch.convert import recast
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import make_prefill_step

    cfg = config()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    local = make_mesh(shape[:2] + (1,), AXES, torch.device(DEVICE))
    n, tp = ranks_of(shape), shape[2]
    dh = cfg.resolved_head_dim
    n_dp = shape[0] * shape[1]
    prompts, extras = head_inputs(torch, cfg, batch, prompt)
    inputs = {"tokens": prompts, **extras}
    attn_layers = cfg.n_encoder_layers if cfg.encdec else cfg.n_layers
    rows = cfg.vocab // tp if cfg.vocab % tp == 0 else cfg.vocab
    what = (f"{cfg.n_encoder_layers} + {cfg.n_layers} layers, "
            f"{cfg.encoder_len} frames" if cfg.encdec else
            f"layers={cfg.n_layers}/24, {cfg.frontend_len} patch positions "
            f"+ {prompt - cfg.frontend_len} tokens")
    log(f"{label}: {cfg.name} ({what}) at its published widths on a "
        f"{shape} mesh of {n} processes ({PROC_BACKEND}): "
        f"{cfg.n_heads * dh // tp} of the {cfg.n_heads * dh} query columns "
        f"({cfg.n_heads} heads of {dh}: {cfg.n_heads / tp:g} a process, "
        f"gathered over 'model' to the whole heads they touch), "
        f"{cfg.n_kv_heads * dh // tp} of the {cfg.n_kv_heads * dh} key and "
        f"value columns, FFN {cfg.d_ff // tp} of {cfg.d_ff}, {rows} of "
        f"the tied embedding's {cfg.vocab} rows (the spec keeps a "
        f"vocabulary \"model\" does not divide whole); {batch} requests "
        f"of {prompt} positions "
        f"({batch // n_dp} a DP rank) and {GEN - 1} decode steps; "
        f"{TP_LABEL}")
    summary = {"label": TP_LABEL, "used_gb": {}}

    torch.cuda.reset_peak_memory_stats()
    params32 = stack_params(torch, cfg32)
    loc32 = serve(torch, cfg32, params32, local, None, None, prompts,
                  kernels, warmup=False, extras=extras)
    with torch.no_grad():
        _, cache = prompt_pass(cfg32, local, prompt + GEN)(params32, inputs)
        want_cache = [{k: v.cpu() for k, v in c.items()} for c in cache]
        del cache
        fwd32 = make_prefill_step(cfg32, local, device=DEVICE)(
            params32, inputs)[0].cpu() if cfg.encdec else None
    params = recast(params32, cfg)
    loc = serve(torch, cfg, params, local, None, None, prompts, kernels,
                keep_logits=True, extras=extras)
    check_stack_run(torch, loc, cfg, batch, f"{label}[local oracle]",
                    attn_layers)
    summary["oracle"] = {"prefill_ms": loc["prefill_s"] * 1e3,
                         "decode_ms_per_step": loc["decode_s"]
                         / loc["decode_steps"] * 1e3}
    with TPRounding(tp):
        wit = serve(torch, cfg, params, local, None, None, prompts, kernels,
                    keep_logits=True, extras=extras)
    del params
    free(torch)
    summary["used_gb"]["parent, whole f32 model"] = card_used_gb(torch)
    return {"cfg": cfg, "cfg32": cfg32, "prompts": prompts, "extras": extras,
            "loc32": loc32, "want_cache": want_cache, "fwd32": fwd32,
            "loc": loc, "wit": wit, "summary": summary, "params32": params32,
            "rows": rows, "attn_layers": attn_layers}


def head_serve_check(torch, ctx, res, shape, batch, prompt, label):
    """Phase 13's serving gates on ``serve_procs``' result ``res`` against
    ``head_serve_oracles``' ``ctx``.  Returns rank 0's launch counts and a
    summary."""
    from repro_torch.launch.shardings import whole_kv_heads
    from repro_torch.models.tp import kv_heads

    cfg, loc32, loc, wit = ctx["cfg"], ctx["loc32"], ctx["loc"], ctx["wit"]
    want_cache, fwd32, summary = ctx["want_cache"], ctx["fwd32"], \
        ctx["summary"]
    rows, attn_layers = ctx["rows"], ctx["attn_layers"]
    tp, dh = shape[2], cfg.resolved_head_dim
    n_dp = shape[0] * shape[1]
    summary["used_gb"].update(res.get("card_used_gb", {}))
    outs = sorted(res["ranks"], key=lambda o: (dp_index(o["coords"], shape),
                                               o["coords"][2]))
    widths = {o["widths"] for o in outs}
    if widths != {(cfg.n_heads * dh // tp, cfg.n_kv_heads * dh // tp,
                   rows)}:
        raise AssertionError(f"{label}: wq, wk and embed widths {widths}")

    # f32: serve_procs' gather against the oracle; the caches by kv head
    err32 = rel_err(torch, res["logits"][0], loc32["logits"].cpu())
    same32 = bool(torch.equal(res["tokens"], loc32["tokens"].cpu()))
    cache_err, held = 0.0, set()
    for o in outs:
        sel = kv_heads(cfg.n_heads, cfg.n_kv_heads, tp, o["coords"][2])
        held.add(sel)
        if {c["k"].shape[2] for c in o["cache"]} != {len(sel)}:
            raise AssertionError(f"{label}: rank {o['rank']}'s cache holds "
                                 f"{[c['k'].shape for c in o['cache']]}")
    groups = [[o for o in outs if dp_index(o["coords"], shape) == dp]
              for dp in range(n_dp)]
    for i, want in enumerate(want_cache):
        # raises where two replicas of a kv head differ
        got = [whole_kv_heads([o["cache"][i] for o in g], cfg)
               for g in groups]
        for k, w in want.items():
            cache_err = max(cache_err, rel_err(
                torch, torch.cat([c[k] for c in got]), w))
    fault = rel_err(torch, whole_logits(outs, shape, lambda o: o["fault"],
                                        cfg.vocab), loc32["logits"].cpu())
    fwd_err = rel_err(torch, whole_logits(
        outs, shape, lambda o: o["fwd32"], cfg.vocab), fwd32) \
        if cfg.encdec else 0.0
    log(f"{label}[f32]: serve_procs' prompt-pass logits gathered, max rel "
        f"diff {err32:.3e} against LocalMesh (limit 1e-4); greedy tokens of "
        f"the prompt pass and {GEN - 1} steps equal {same32}; "
        + (f"the teacher-forced forward ({prompt} positions) max rel diff "
           f"{fwd_err:.3e} (limit 1e-4); " if cfg.encdec else "")
        + f"each process's decode cache"
        + (" and cross cache" if cfg.encdec else "")
        + f" holds kv heads {sorted(held)} (the replicas bit-identical), "
        f"put together within {cache_err:.3e} of the oracle's (limit "
        f"1e-5); under the planted fault (every process keeping its "
        f"neighbour's columns) the logits lie {fault:.3e} apart: the gate "
        f"(1e-4) {'refuses' if fault > 1e-4 else 'PASSES'} it")
    if not (err32 < 1e-4 and same32 and cache_err <= 1e-5
            and fwd_err < 1e-4):
        raise AssertionError(f"{label}: f32 prompt pass {err32}, tokens "
                             f"equal {same32}, cache {cache_err}, forward "
                             f"{fwd_err}")
    if not fault > 1e-4:
        raise AssertionError(f"{label}: the planted fault (the neighbour's "
                             f"columns) passes the f32 gate ({fault})")
    summary["f32"] = {"max_rel_diff": err32, "tokens_equal": same32,
                      "cache_rel_diff": cache_err,
                      "forward_rel_diff": fwd_err,
                      "planted_neighbour_columns_rel_diff": fault}

    # bf16: launches, the peers alike, held to the witness
    want_l = run_counts(loc)
    check_tp_launches(outs, want_l, label)
    for o in outs:
        check_stack_run(torch, o["serve"], cfg, batch // n_dp,
                        f"{label}[rank {o['rank']}]", attn_layers, rows)
    check_peers(outs, lambda o: o["serve"]["tokens"].tolist(), label,
                "the greedy tokens")
    check_peers(outs, lambda o: o["stream"], label,
                "the residual stream's digest")
    shared = check_shared_heads(outs, shape, label)
    if not shared:
        raise AssertionError(f"{label}: no query head shared by two peers")
    logits = whole_logits(outs, shape, lambda o: o["serve"]["logits"],
                          cfg.vocab)
    tokens = by_dp(outs, shape, lambda o: o["serve"]["tokens"])
    w = summary["witness"] = witness_tokens(
        torch, wit, loc, tokens, logits, torch.zeros(batch,
                                                     dtype=torch.bool))
    w["shared_head_outputs"] = shared
    log(f"{label}[bf16]: every process launched flash_attention "
        f"{want_l['prefill']['flash_attention']} times in the prompt pass "
        f"and nothing else, as the oracle, on the "
        f"{len(range(*outs[0]['heads']))} to "
        f"{max(len(range(*o['heads'])) for o in outs)} whole query heads "
        f"its columns touch; each query head's output bit-identical on "
        f"the peers that touch it ({shared} shared (call, head) pairs); the "
        f"residual stream and the greedy tokens bit-identical on model "
        f"peers; against the witness (the oracle with TP's rounding of the "
        f"row-parallel products alone): prompt-pass logits max rel diff "
        f"{w['logits_rel_diff']:.3e} (bit-identical {w['logits_equal']}); "
        f"greedy tokens equal in {w['sequences_same_tokens']} of {batch} "
        f"(the plain oracle's in {w['oracle_sequences_same_tokens']}); each "
        f"sequence whose tokens differ (sequence, step, witness gap): "
        f"{w['token_gaps']} (limit {BF16_TOKEN_TIE}; one planted at the "
        f"median gap reads {w['planted_token_gap']:.3e})")
    check_witness_tokens(label, w)
    kv_report(outs, summary, label)
    r0 = next(o for o in outs if o["rank"] == 0)
    return {"prefill": r0["serve"]["prefill_launches"],
            "decode": r0["serve"]["decode_launches"]}, summary


def attn_train_launches(cfg):
    """A training step's launches of an attention-only stack: each layer's
    forward once, twice under remat (``transformer.lm_forward``; the
    encoder-decoder runs none), and one backward; no expert kernel."""
    if cfg.encdec:
        n = n_fwd = cfg.n_encoder_layers + cfg.n_layers
    else:
        n, n_fwd = cfg.n_layers, (2 if cfg.remat else 1) * cfg.n_layers
    return {"flash_attention": n_fwd, "flash_attention_bwd": n,
            "grouped_matmul": 0, "a2a_pack": 0, "a2a_unpack": 0}


def adamw_launches(run, label):
    """AdamW's two kernels' launches a step in ``run``: the same every step
    and at least one each (the update runs each step; the count is one a
    dtype pair and table, so it follows the stack's leaves)."""
    first = {k: run["launches"][0][k] for k in ADAMW_KERNELS}
    for i, got in enumerate(run["launches"]):
        mine = {k: got[k] for k in ADAMW_KERNELS}
        if mine != first or min(mine.values()) < 1:
            raise AssertionError(f"{label} step {i}: AdamW's launches "
                                 f"{mine}; step 0's {first}, at least 1 "
                                 f"each")
    return first


def check_attn_train_launches(outs, oracle, cfg, label):
    """Every process's launches each step equal to the oracle's and to
    ``attn_train_launches``, AdamW's as ``adamw_launches`` finds them in
    the oracle, every attention backward on wgmma."""
    want = dict(attn_train_launches(cfg),
                **adamw_launches(oracle, f"{label}[local oracle]"))
    for who, run in [("local oracle", oracle)] + [
            (f"rank {o['rank']}", o) for o in outs]:
        for i, (got, by) in enumerate(zip(run["launches"], run["variants"])):
            if got != want or by["flash_attention_bwd"]["wgmma"] != \
                    want["flash_attention_bwd"]:
                raise AssertionError(f"{label}[{who}] step {i}: launches "
                                     f"{got} by instance {by}; expected "
                                     f"{want}, the backward on wgmma")
    return want


def head_train_check(torch, oracle, outs, metrics, cfg, shape, batch, seq,
                     label):
    """Phase 13's bf16 training gates on the processes' ``outs``
    (``tp_train_child``'s) and rank 0's step ``metrics``, against the
    stacked ``oracle`` (``local_oracle``): launches equal each step, the
    gradients of the leaves replicated over "model" bit-identical on
    model peers, losses within 2e-2.  Returns rank 0's launches over its
    steps and a summary."""
    n_dp = shape[0] * shape[1]
    log(f"{label}: {cfg.name} ({cfg.n_layers} layers"
        + (f" + {cfg.n_encoder_layers} encoder layers" if cfg.encdec else "")
        + f") at its published widths on a {shape} mesh of "
        f"{ranks_of(shape)} processes ({PROC_BACKEND}) through "
        f"train_procs' per-rank path; {batch} x {seq} tokens a step "
        f"({batch // n_dp} rows a DP rank), {HEAD_TRAIN_STEPS} AdamW steps; "
        f"{TP_LABEL}")
    summary = {"label": TP_LABEL, "oracle": {
        "step_ms": oracle["step_ms"], "peak_gb": oracle["peak_gb"]}}
    want = check_attn_train_launches(outs, oracle, cfg, label)
    check_peers(outs, lambda o: o["replicated"], label,
                "a gradient of a leaf replicated over 'model'")
    diffs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
             for a, b in zip(metrics, oracle["metrics"])]
    log(f"{label}: every process launched each kernel as often as the "
        f"oracle each step ({want}); the gradients of the "
        f"{len(outs[0]['replicated'][0])} leaves replicated over 'model' "
        f"bit-identical on model peers every step; step losses "
        f"{[round(m['loss'], 6) for m in metrics]} against the "
        f"oracle's, relative differences {[f'{d:.3e}' for d in diffs]} "
        f"(limit 2e-2)")
    if not max(diffs) < 2e-2:
        raise AssertionError(f"{label}: step losses against the oracle "
                             f"{diffs}")
    summary.update(loss_diffs=diffs, ranks=[])
    tokens = batch * seq // n_dp
    for o in outs:
        ms = o["train"]["step_ms"]
        r = {"rank": o["rank"], "coords": list(o["coords"]), "step_ms": ms,
             "tokens_per_s": tokens / ms[-1] * 1e3,
             "peak_gb": o["peak_gb"], "card_gb": max(o["card_gb"]),
             "shard_gb": o["shard_gb"], **o["trace"]}
        summary["ranks"].append(r)
        log(f"{label}[rank {o['rank']} {tuple(o['coords'])}]: step ms "
            f"{[round(x, 3) for x in ms]} (step {HEAD_TRAIN_STEPS - 1} "
            f"traced); {r['tokens_per_s']:.1f} tokens/s of its DP rank's "
            f"rows at the traced step; peak {o['peak_gb']:.2f} GB (f32 shard "
            f"{o['shard_gb']:.2f} GB); the card {r['card_gb']:.2f} GB in "
            f"use; traced step {r['host_ms']:.3f} ms: operators over 'model' "
            f"{r['tp_share']:.4f} ({r['tp_sums']} calls), gradient sync "
            f"{r['sync_share']:.4f}; {TP_LABEL}")
    counts = {k: sum(step[k] for step in outs[0]["launches"])
              for k in outs[0]["launches"][0]}
    return counts, summary


def head_cell_child(mesh, cfg32, shards, rows, serve_cli, config,
                    train_config, batch, seq, noise_unit, want):
    """One rank of a phase 13 cell, the per-rank hook of ``serve_procs``:
    ``head_child``'s serving; then ``train_procs``' per-rank path
    (``launch/train._train_rank``) twice, on the 1-layer model of
    ``train_config`` that each process makes from the seed as the
    parent's oracles do: bf16 training (``tp_train_child``) and the f32
    gate (``f32_proc_child``, with the planted neighbour's columns, against
    the oracle's ``want`` shared through CUDA IPC).  One spawn a cell:
    starting 16 processes on the card takes about half a minute."""
    import torch

    from repro_torch.launch.train import _train_rank

    out = head_child(mesh, cfg32, shards, rows, serve_cli, config)
    free(torch)
    runs = (("train", train_config(), HEAD_TRAIN_STEPS,
             functools.partial(tp_train_child, steps=HEAD_TRAIN_STEPS)),
            ("f32", train_config(compute_dtype="float32"), F32_PROC_STEPS,
             functools.partial(f32_proc_child, want=want,
                               plant=NeighbourColumns, batch=batch,
                               noise_unit=noise_unit, seq=seq)))
    for key, cfg, steps, hook in runs:
        t0 = time.perf_counter()
        res = _train_rank(mesh, cfg, [stack_params(torch, cfg, train=True)],
                          proc_data(cfg, batch, seq),
                          proc_train_options(steps), steps, True, None,
                          hook=hook)
        out[key], out[f"{key}_metrics"] = res["hook"], res["metrics"]
        del res
        free(torch)
        out["stages_s"][f"{key} (with its model)"] = time.perf_counter() - t0
    return out


def phase_head_cell(torch, kernels, key, config, shape, prompt_shape,
                    train_config, train_shape, noise_unit):
    """One cell of phase 13: ``config()`` served on the processes of
    ``shape`` and the 1-layer ``train_config()`` trained there, in one
    spawn (``head_cell_child``), against the stacked oracles of its DP
    shape.  Returns the serving launches, the training's and a summary."""
    from repro_torch.launch.serve import serve_procs

    (batch, prompt), (tbatch, tseq) = prompt_shape, train_shape
    label, tlabel = f"head[{key}]", f"head[{key} train]"
    t0 = time.perf_counter()
    ctx = head_serve_oracles(torch, kernels, config, shape, batch, prompt,
                             label)
    tcfg, f32cfg = train_config(), train_config(compute_dtype="float32")
    oracle = local_oracle(torch, tcfg, tbatch, tseq, HEAD_TRAIN_STEPS,
                          kernels, shape=shape[:2] + (1,))
    oracle32, want = f32_gate_oracle(torch, kernels, f32cfg, tbatch, tseq,
                                     shape)
    t_oracles = time.perf_counter() - t0
    holder = [ctx.pop("params32")]
    # the children's allocator only: the parent's tensors they map through
    # CUDA IPC were allocated before
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    res = serve_procs(
        ctx["cfg32"], holder, ctx["prompts"], shape, PROC_BACKEND, DEVICE,
        None, None, GEN,
        hook=functools.partial(head_cell_child, config=config,
                               train_config=train_config, batch=tbatch,
                               seq=tseq, noise_unit=noise_unit, want=want),
        extras=ctx["extras"], timeout=PROC_TIMEOUT_S,
        join_timeout=PROC_JOIN_S)
    t_procs = time.perf_counter() - t0
    del os.environ["PYTORCH_CUDA_ALLOC_CONF"], want
    free(torch)
    torch.cuda.ipc_collect()  # the oracle's tensors the processes mapped
    ranks = res["ranks"]
    r0 = next(o for o in ranks if o["rank"] == 0)
    serving, summary = head_serve_check(torch, ctx, res, shape, batch,
                                        prompt, label)
    counts, summary["train"] = head_train_check(
        torch, oracle, [o["train"] for o in ranks], r0["train_metrics"],
        tcfg, shape, tbatch, tseq, tlabel)
    summary["train"]["f32"] = f32_gate_check(
        torch, oracle32, [o["f32"] for o in ranks], r0["f32_metrics"],
        shape, tlabel, "each process keeping its neighbour's columns of "
        "the touched query heads' output", tbatch, tseq, f32cfg, noise_unit)
    summary["oracles_s"], summary["processes_s"] = t_oracles, t_procs
    summary["rank0_stages_s"] = r0["stages_s"]
    log(f"phase head[{key}]: oracles {t_oracles:.1f} s, the processes "
        f"{t_procs:.1f} s (rank 0 from its shard on: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in r0["stages_s"].items()) + ")")
    return serving, counts, summary


def phase_head(torch, kernels):
    """Phase 13: TP over "model" where it cuts through a query head: (a)
    internvl2-1b on (1, 1, 16), (b) whisper-tiny on (1, 2, 4), each served
    and trained.  Returns the serving launches by path, the training's and
    a summary."""
    summary, serving, train = {}, {}, {}
    cells = (
        ("a", HEAD_PATH, HEAD_TRAIN_PATH, head_config, HEAD_MESH,
         (HEAD_BATCH, head_config().frontend_len + HEAD_TOKENS),
         functools.partial(head_config, n_layers=1),
         (HEAD_TRAIN_BATCH, HEAD_TRAIN_SEQ), "dp"),
        ("b", ENCDEC_PATH, ENCDEC_TRAIN_PATH, encdec_config, ENCDEC_MESH,
         (ENCDEC_BATCH, ENCDEC_PROMPT), encdec_config,
         (ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ), "process"))
    for key, path, train_path, config, shape, prompts, tcfg, tshape, unit \
            in cells:
        serving[path], train[train_path], summary[key] = phase_head_cell(
            torch, kernels, key, config, shape, prompts, tcfg, tshape, unit)
        free(torch)
    return serving, train, summary


def rec_config(arch, **over):
    """A phase 14 arch at its published widths (hymba-1.5b listed, not
    scanned, so that layer 0 attends fully and layer 1 through its
    window)."""
    from repro_torch.configs import get_config

    if arch == HYMBA_ARCH:
        over = {"scan_layers": False, **over}
    return get_config(arch, **over)


def to_cpu(tree):
    """A decode cache's tensors (nested dicts and lists) on the host."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.cpu()


def flat_tree(tree, prefix=""):
    """``{dotted path: tensor}`` of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flat_tree(v, f"{prefix}{k}."))
    return out


class NeighbourChannels:
    """While active, each process keeps its neighbour's channels of a
    gathered per-channel width (``ssm._own_channels``: Mamba's ``x`` and
    ``z`` after the ``in_proj`` gather, the sLSTM's gates): phase 14's
    planted fault for the recurrent cells."""

    def __init__(self):
        from repro_torch.models import ssm
        self.ssm = ssm

    def __enter__(self):
        self.real = real = self.ssm._own_channels

        def shifted(t, tp):
            n = tp.axis_size("model")
            return real(t.roll(-(t.shape[-1] // n), -1), tp)
        self.ssm._own_channels = shifted
        return self

    def __exit__(self, *exc):
        self.ssm._own_channels = self.real


class NeighbourRows:
    """While active, ``pure_dp``'s MoE keeps a model peer's rows of its
    ``(pod, data)`` shard's output in place of its own (the gathered rows
    rolled by one process's): phase 14 (c)'s serving fault."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe = moe

    def __enter__(self):
        self.real = real = self.moe.gather_rows

        def rolled(tp, x):
            return real(tp, x).roll(-x.shape[0], 0)
        self.moe.gather_rows = rolled
        return self

    def __exit__(self, *exc):
        self.moe.gather_rows = self.real


@contextlib.contextmanager
def sync_skipping_model():
    """Phase 14 (c)'s training fault: ``_sync_grads`` summing over the DP
    axes alone, not over "model" (each process keeps the mean over its own
    model coordinate's rows)."""
    from repro_torch.launch import train

    real = train._sync_grads

    def skip(grads, mesh, specs, axes=None):
        return real(grads, mesh, specs,
                    tuple(a for a in axes if a != "model"))
    train._sync_grads = skip
    try:
        yield
    finally:
        train._sync_grads = real


class GridDigests:
    """While active, the digest of every token grid ``moe._expert_ffn``
    runs on."""

    def __init__(self, torch):
        from repro_torch.models import moe
        self.torch, self.moe, self.digests = torch, moe, []

    def __enter__(self):
        self.real = real = self.moe._expert_ffn

        def spy(cfg, w_gate, w_up, w_down, tokens, *args, **kw):
            self.digests.append(digest(self.torch, tokens))
            return real(cfg, w_gate, w_up, w_down, tokens, *args, **kw)
        self.moe._expert_ffn = spy
        return self

    def __exit__(self, *exc):
        self.moe._expert_ffn = self.real


class LayerInputs:
    """While active, each layer's input of a prompt pass
    (``transformer._block_prefill``'s ``x``), on the host."""

    def __init__(self):
        from repro_torch.models import transformer
        self.mod, self.inputs = transformer, []

    def __enter__(self):
        self.real = real = self.mod._block_prefill

        def spy(cfg, p, x, **kw):
            whole = x if kw.get("sp") is None else kw["sp"].gathered(x).whole
            self.inputs.append(whole.detach().cpu())
            return real(cfg, p, x, **kw)
        self.mod._block_prefill = spy
        return self

    def __exit__(self, *exc):
        self.mod._block_prefill = self.real


def rec_widths(params):
    """The widths of a process's shard that phase 14 logs: the first
    block's recurrent or Mamba columns and channels, its attention's query
    columns, the embedding's rows."""
    blk = params.blocks[0]
    out = {"embed_rows": params.embed.shape[0]}
    if hasattr(blk, "mamba"):
        out.update(in_proj=blk.mamba.in_proj.shape[-1],
                   channels=blk.mamba.conv_w.shape[-1])
    if hasattr(blk, "mlstm"):
        out.update(mlstm_cols=blk.mlstm.wv.shape[-1],
                   wif=blk.mlstm.wif.shape[-1])
    if hasattr(blk, "attn"):
        out["wq"] = blk.attn.wq.shape[-1]
    return out


def rec_pass(cfg, mesh, total, impl, plan):
    """``(params, batch) -> (last logits, cache)``: the serving prompt pass
    through ``impl`` (and ``plan``) with a cache of ``total`` slots."""
    from repro_torch.launch.serve import make_prefill_step

    return make_prefill_step(cfg, mesh, impl, plan, cache_len=total,
                             device=DEVICE)


def rec_child(mesh, cfg32, shards, rows, serve_cli, config, plant, impl,
              plan):
    """One rank of a phase 14 cell's serving: the f32 serve of its shard
    (``serve_procs``' own: the prompt pass and 15 greedy steps gathered),
    an f32 prompt pass for its decode state and routing and one under the
    planted fault ``plant()``; the bf16 serving run (routing recorded); a
    prompt pass with the residual stream's and the MoE grids' digests; the
    shares of a traced prompt pass.  Returns host tensors and digests."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.convert import recast

    kernels = proc_kernels()
    cfg = config()
    out = {"rank": mesh.rank, "coords": mesh.rank_coords, "used_gb": {},
           "shard_gb": param_gb(shards[0]), "widths": rec_widths(shards[0])}
    out["used_gb"]["after the parent's drop"] = card_used_gb(torch)
    torch.cuda.reset_peak_memory_stats()
    stages, t0 = {}, time.perf_counter()
    serve_cli()
    stages["f32 serve"] = time.perf_counter() - t0
    batch = {"tokens": rows}
    pre32 = rec_pass(cfg32, mesh, rows.shape[1] + GEN, impl, plan)
    with torch.no_grad():
        # each layer's input, once a DP rank (model peers hold the same)
        keep = cfg.pure_dp or mesh.rank_coords[2] == 0
        with RouteRecorder() as rec, LayerInputs() as li:
            _, cache = pre32(shards[0], batch)
        out["routes32"] = [e.cpu() for e in rec.eids]
        out["cache"] = to_cpu(cache)
        if keep:
            out["inputs"] = li.inputs
        del cache, li
        with plant():
            out["fault"] = pre32(shards[0], batch)[0].cpu()
    stages["f32 passes"] = time.perf_counter() - t0 - sum(stages.values())
    shard = recast(shards.pop(), cfg)
    free(torch)
    run = serve(torch, cfg, shard, mesh, impl, plan, rows, kernels,
                pick=tp_pick(cfg, mesh, impl, plan), record=True)
    out["used_gb"]["serving"] = card_used_gb(torch)
    out["serve"] = {k: run[k] for k in (
        "prefill_s", "decode_s", "decode_steps", "step_ms_median",
        "step_ms_max", "prefill_launches", "decode_launches")}
    out["serve"].update(logits=run["logits"].cpu(),
                        last_logits=run["last_logits"].cpu(),
                        tokens=run["tokens"].cpu(),
                        routes=[e.cpu() for e in run["routes"]])
    del run
    stages["bf16 serve"] = time.perf_counter() - t0 - sum(stages.values())
    pre = rec_pass(cfg, mesh, rows.shape[1] + GEN, impl, plan)
    with torch.no_grad(), StreamRecorder(torch) as st, \
            GridDigests(torch) as gd:
        pre(shard, batch)
    out["stream"], out["grids"] = st.digests, gd.digests
    out["shares"] = tp_shares(torch, pre, shard, batch)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    stages["digests and trace"] = time.perf_counter() - t0 - sum(
        stages.values())
    out["stages_s"] = stages
    return out


def rec_cell_child(mesh, cfg32, shards, rows, serve_cli, config, plant,
                   impl, plan, train_config, gates, batch, seq, noise_unit,
                   wants, train_wholes=None, extra=None, fault_peers=False,
                   gen=None):
    """One rank of a phase 14 cell, the per-rank hook of ``serve_procs``:
    ``rec_child``'s serving; then ``train_procs``' per-rank path
    (``launch/train._train_rank``) on models each process makes from the
    seed as the parent's oracles do: bf16 training of ``train_config``
    (``tp_train_child``), and each f32 gate of ``gates`` ((key, config,
    planted fault, name) each; ``f32_proc_child`` against the oracle's
    ``wants[key]`` shared through CUDA IPC).  Phase 15: ``train_wholes``,
    ``{key: the trainable model the parent made from the seed}`` (shared
    through CUDA IPC), in place of each process's own; ``extra(mesh, rows,
    plan, train_wholes["train"])`` run after the serving, its result under
    ``"extra"``;
    ``fault_peers`` as ``f32_proc_child``'s; ``gen`` this process's
    ``GEN`` (the parent's ``decode_steps``)."""
    import torch

    from repro_torch.launch.train import _train_rank

    global GEN
    if gen is not None:
        GEN = gen

    entered = time.time()
    out = rec_child(mesh, cfg32, shards, rows, serve_cli, config, plant,
                    impl, plan)
    out["entered"] = entered
    free(torch)
    if extra is not None:
        t0 = time.perf_counter()
        out["extra"] = extra(mesh, rows, plan, train_wholes["train"])
        free(torch)
        out["stages_s"]["extra runs"] = time.perf_counter() - t0
    runs = [("train", train_config(), REC_TRAIN_STEPS,
             functools.partial(tp_train_child, steps=REC_TRAIN_STEPS))] + [
        (key, gate_config(), F32_PROC_STEPS, functools.partial(
            f32_proc_child, want=wants[key], plant=gate_plant, batch=batch,
            noise_unit=noise_unit, seq=seq, fault_peers=fault_peers))
        for key, gate_config, gate_plant, _ in gates]
    for key, cfg, steps, hook in runs:
        t0 = time.perf_counter()
        params = stack_params(torch, cfg, train=True) \
            if train_wholes is None else train_wholes[key]
        res = _train_rank(mesh, cfg, [params],
                          proc_data(cfg, batch, seq),
                          proc_train_options(steps), steps, True, None,
                          hook=hook)
        out[key], out[f"{key}_metrics"] = res["hook"], res["metrics"]
        del res
        free(torch)
        out["stages_s"][f"{key} (with its model)"] = time.perf_counter() - t0
    out["left"] = time.time()
    return out


def rec_rows(outs, shape, get, pure_dp, vocab=None):
    """``get(o)`` of every process as the whole batch's: under ``pure_dp``
    every process's rows in batch order (DP rank, then model coordinate),
    else ``whole_logits``' (``vocab`` given) or one model peer's rows of
    each DP rank (``by_dp``)."""
    import torch

    if pure_dp:
        return torch.cat([get(o) for o in sorted(
            outs, key=lambda o: (dp_index(o["coords"], shape),
                                 o["coords"][2]))])
    if vocab is not None:
        return whole_logits(outs, shape, get, vocab)
    return by_dp(outs, shape, get)


def rec_states(outs, shape, cfg, pure_dp):
    """The processes' decode states and caches put together, one
    ``{dotted path: tensor}`` a layer: by rows under ``pure_dp``; else each
    DP rank's model peers' by ``shardings.whole_states`` (which raises
    where two replicas differ), the DP ranks' rows joined."""
    import torch

    from repro_torch.launch.shardings import whole_states

    n_layers = len(outs[0]["cache"])
    if pure_dp:
        return [{k: rec_rows(outs, shape, lambda o: flat_tree(
            o["cache"][i])[k], True) for k in flat_tree(outs[0]["cache"][i])}
            for i in range(n_layers)]
    groups = {}
    for o in sorted(outs, key=lambda o: o["coords"][2]):
        groups.setdefault(dp_index(o["coords"], shape), []).append(o)
    layers = []
    for i in range(n_layers):
        parts = [flat_tree(whole_states([o["cache"][i] for o in g], cfg))
                 for _, g in sorted(groups.items())]
        layers.append({k: torch.cat([p[k] for p in parts])
                       for k in parts[0]})
    return layers


def state_errs(torch, got, want, label):
    """``{"layer i key": relative difference}`` of put-together states
    ``got`` (``rec_states``) against ``want`` (one cache dict a layer)."""
    errs = {}
    for i, (g, w) in enumerate(zip(got, want)):
        w = flat_tree(w)
        if set(g) != set(w):
            raise AssertionError(f"{label}: layer {i} state keys "
                                 f"{sorted(g)}; the oracle's {sorted(w)}")
        for k, t in w.items():
            if tuple(g[k].shape) != tuple(t.shape):
                raise AssertionError(f"{label}: layer {i} state {k}: "
                                     f"{tuple(g[k].shape)} put together, "
                                     f"{tuple(t.shape)} whole")
            errs[f"layer {i} {k}"] = rel_err(torch, g[k], t)
    return errs


def layer_oracle_states(torch, outs, shape, cfg32, total, pure_dp):
    """Each layer of the f32 oracle (whole weights from the seed, no mesh)
    run on the processes' own input of that layer (``LayerInputs``, the
    same for model peers): its decode state or cache, one dict a layer.
    The processes' states on identical inputs, layer by layer."""
    from repro_torch.models.transformer import (_block_prefill, _full_flag,
                                                layer_kinds)

    params = stack_params(torch, cfg32)
    holders = [o for o in outs if "inputs" in o]
    want = []
    with torch.no_grad():
        for i, kind in enumerate(layer_kinds(cfg32)):
            x = rec_rows(holders, shape, lambda o: o["inputs"][i],
                         pure_dp).to(DEVICE)
            b, s = x.shape[:2]
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device).expand(b, s)
            _, _, entry = _block_prefill(
                cfg32, params.blocks[i], x, positions=positions, dist=None,
                kind=kind, full_flag=_full_flag(cfg32, i), cache_len=total,
                use_kernel=True)
            want.append(to_cpu(entry))
            del x, entry
    del params
    free(torch)
    return want


def rec_oracles(torch, kernels, config, shape, batch, prompt, impl, plan,
                pure_dp):
    """Phase 14's serving oracles: ``config()`` on ``LocalMesh`` of
    ``shape``'s DP shape (whole weights), in f32 (routing margins kept)
    and bf16, and the bf16 witness (``TPRounding`` over "model"; the plain
    oracle itself under ``pure_dp``, which has no TP)."""
    from repro_torch.convert import recast
    from repro_torch.launch.mesh import make_mesh

    cfg = config()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    local = make_mesh(shape[:2] + (1,), AXES, torch.device(DEVICE))
    prompts = stack_prompts(torch, cfg, batch, prompt)
    summary = {"label": TP_LABEL, "used_gb": {}}
    torch.cuda.reset_peak_memory_stats()
    params32 = stack_params(torch, cfg32)
    loc32 = serve(torch, cfg32, params32, local, impl, plan, prompts,
                  kernels, warmup=False, record="margins")
    with torch.no_grad():
        _, cache = rec_pass(cfg32, local, prompt + GEN, impl, plan)(
            params32, {"tokens": prompts})
        want_cache = to_cpu(cache)
        del cache
    params = recast(params32, cfg)
    loc = serve(torch, cfg, params, local, impl, plan, prompts, kernels,
                keep_logits=True, record=True)
    summary["oracle"] = {"prefill_ms": loc["prefill_s"] * 1e3,
                         "decode_ms_per_step": loc["decode_s"]
                         / loc["decode_steps"] * 1e3}
    if pure_dp:
        wit = loc
    else:
        with TPRounding(shape[2]):
            wit = serve(torch, cfg, params, local, impl, plan, prompts,
                        kernels, keep_logits=True, record=True)
    del params
    free(torch)
    summary["used_gb"]["parent, whole f32 model"] = card_used_gb(torch)
    return {"cfg": cfg, "cfg32": cfg32, "prompts": prompts, "loc32": loc32,
            "want_cache": want_cache, "loc": loc, "wit": wit,
            "summary": summary, "params32": params32}


def rec_serve_check(torch, ctx, res, shape, batch, label, pure_dp):
    """Phase 14's serving gates on ``serve_procs``' result ``res`` against
    ``rec_oracles``' ``ctx``.  Returns rank 0's launch counts and a
    summary."""
    cfg, loc32, loc, wit = ctx["cfg"], ctx["loc32"], ctx["loc"], ctx["wit"]
    summary = ctx["summary"]
    summary["used_gb"].update(res.get("card_used_gb", {}))
    outs = sorted(res["ranks"], key=lambda o: (dp_index(o["coords"], shape),
                                               o["coords"][2]))
    firsts = [o for o in outs if o["coords"][2] == 0]
    err32 = rel_err(torch, res["logits"][0], loc32["logits"].cpu())
    same32 = bool(torch.equal(res["tokens"], loc32["tokens"].cpu()))
    got = rec_states(outs, shape, cfg, pure_dp)
    stack = state_errs(torch, got, ctx["want_cache"], label)
    layers = state_errs(torch, got, layer_oracle_states(
        torch, outs, shape, ctx["cfg32"], ctx["prompts"].shape[1] + GEN,
        pure_dp), label)
    state_err, stack_err = max(layers.values()), max(stack.values())
    worst, stack_worst = max(layers, key=layers.get), max(stack,
                                                           key=stack.get)
    vocab = None if pure_dp else cfg.vocab
    fault = rel_err(torch, rec_rows(outs, shape, lambda o: o["fault"],
                                    pure_dp, vocab), loc32["logits"].cpu())
    # f32 routing (the MoE cell): one process of each (pod, data) shard,
    # whose model peers route its rows together
    routes32 = [torch.cat([o["routes32"][i] for o in firsts])
                for i in range(len(loc32["routes"]))]
    flips, n_dec, tie = near_tie_flips(torch, loc32["routes"], routes32,
                                       loc32["margins"], batch)
    log(f"{label}[f32]: serve_procs' prompt-pass logits gathered, max rel "
        f"diff {err32:.3e} against LocalMesh (limit 1e-4); greedy tokens of "
        f"the prompt pass and {GEN - 1} steps equal {same32}; "
        + (f"{flips} of {n_dec} routing decisions differ, each sequence's "
           f"first at an oracle margin of at most {tie:.3e} (limit "
           f"{NEAR_TIE}); " if n_dec else "")
        + "the decode states and caches put together ("
        + ("by rows" if pure_dp else "whole_states over the model peers, "
           "the replicas bit-identical") + "), "
        f"each layer on identical inputs (the oracle's layer on the "
        f"processes' input of it), within {state_err:.3e} of the oracle's "
        f"({worst}; limit 1e-5); the whole stack's against the oracle's "
        f"prompt pass (reported): {stack_err:.3e} ({stack_worst}); under "
        f"the planted fault the logits lie {fault:.3e} apart: the gate "
        f"(1e-4) {'refuses' if fault > 1e-4 else 'PASSES'} it")
    log(f"{label}[f32 states]: on identical inputs " + ", ".join(
        f"{k} {v:.3e}" for k, v in layers.items()) + "; the whole stack "
        + ", ".join(f"{k} {v:.3e}" for k, v in stack.items()))
    if not (err32 < 1e-4 and same32 and state_err <= 1e-5
            and tie <= NEAR_TIE):
        raise AssertionError(f"{label}: f32 prompt pass {err32}, tokens "
                             f"equal {same32}, states {state_err}, routing "
                             f"tie {tie}")
    if not fault > 1e-4:
        raise AssertionError(f"{label}: the planted fault passes the f32 "
                             f"gate ({fault})")
    summary["f32"] = {"max_rel_diff": err32, "tokens_equal": same32,
                      "state_rel_diff": state_err, "state_worst": worst,
                      "stack_state_rel_diff": stack_err,
                      "stack_state_worst": stack_worst,
                      "routing_differs": flips,
                      "first_difference_margin": tie,
                      "planted_fault_rel_diff": fault}

    # bf16: launches, the peers alike, held to the witness
    want_l = run_counts(loc)
    check_tp_launches(outs, want_l, label)
    n_dp = shape[0] * shape[1]
    rows = batch // ranks_of(shape) if pure_dp else batch // n_dp
    for o in outs:
        if cfg.moe is None:
            check_stack_run(torch, o["serve"], cfg, rows,
                            f"{label}[rank {o['rank']}]",
                            want_l["prefill"]["flash_attention"],
                            o["serve"]["logits"].shape[-1])
    if cfg.moe is not None and not all(
            want_l["prefill"][k] for k in ("grouped_matmul", "flash_attention",
                                           "a2a_pack", "a2a_unpack")):
        raise AssertionError(f"{label}: the oracle launched "
                             f"{want_l['prefill']} in its prefill")
    if pure_dp:
        check_peers(outs, lambda o: o["grids"], label,
                    "a (pod, data) shard's MoE token grid")
    else:
        check_peers(outs, lambda o: o["serve"]["tokens"].tolist(), label,
                    "the greedy tokens")
        check_peers(outs, lambda o: o["stream"], label,
                    "the residual stream's digest")
    logits = rec_rows(outs, shape, lambda o: o["serve"]["logits"], pure_dp,
                      vocab)
    tokens = rec_rows(outs, shape, lambda o: o["serve"]["tokens"], pure_dp)
    w_routes = [e.cpu() for e in wit["routes"]]
    routes = [torch.cat([o["serve"]["routes"][i] for o in firsts])
              for i in range(len(w_routes))]
    n_flip, n_bf, _, per_seq = route_flips(torch, w_routes, routes, batch) \
        if w_routes else (0, 0, [], torch.zeros(batch, dtype=torch.bool))
    w = summary["witness"] = witness_tokens(torch, wit, loc, tokens, logits,
                                            per_seq)
    w.update(routing_differs=n_flip, sequences_routed_apart=int(
        per_seq.sum()))
    log(f"{label}[bf16]: every process launched each kernel as often as the "
        f"oracle in its prefill ({want_l['prefill']}) and decode, "
        + ("each (pod, data) shard's MoE grids bit-identical on its model "
           "peers" if pure_dp else "the residual stream and the greedy "
           "tokens bit-identical on model peers")
        + "; against the " + ("plain oracle (no TP under pure_dp)"
                              if pure_dp else "witness (the oracle with TP "
                              "rounding of the row-parallel products alone)")
        + ": "
        f"prompt-pass logits max rel diff {w['logits_rel_diff']:.3e} "
        f"(bit-identical {w['logits_equal']}); "
        + (f"routing differs in {n_flip} of {n_bf} decisions, "
           f"{w['sequences_routed_apart']} sequences apart (limit "
           f"{PROC_BF16_APART_MAX}); " if n_bf else "")
        + f"greedy tokens equal in {w['sequences_same_tokens']} of {batch} "
        f"(the plain oracle's in {w['oracle_sequences_same_tokens']}); "
        f"each sequence whose tokens differ (sequence, step, gap): "
        f"{w['token_gaps']} (limit {BF16_TOKEN_TIE}; one planted at the "
        f"median gap reads {w['planted_token_gap']:.3e})")
    check_witness_tokens(label, w)
    if not w["sequences_routed_apart"] <= PROC_BF16_APART_MAX:
        raise AssertionError(f"{label}: {w['sequences_routed_apart']} "
                             f"sequences routed apart in bf16")
    tp_report(outs, summary, label)
    for o, r in zip(outs, summary["ranks"]):
        sh = o["shares"]
        r.update(widths=o["widths"], scan_share=sh["scan_share"],
                 tp_by_span=sh["tp_by_span"])
        log(f"{label}[rank {o['rank']}]: shard {json.dumps(o['widths'])}; "
            f"traced prompt pass {sh['host_ms']:.3f} ms: operators over "
            f"'model' (procmesh.tp_*) {sh['tp_share']:.4f}, the scan loops "
            f"(ssm_scan) {sh['scan_share']:.4f} ({sh['scans']} loops); "
            f"{TP_LABEL}")
    r0 = next(o for o in outs if o["rank"] == 0)
    return {"prefill": r0["serve"]["prefill_launches"],
            "decode": r0["serve"]["decode_launches"]}, summary


def rec_train_launches(cfg):
    """A training step's launches: ``attn_train_launches`` of a stack with
    attention, none for xLSTM's."""
    want = attn_train_launches(cfg)
    return dict.fromkeys(want, 0) if cfg.family == "ssm" else want


def rec_train_check(torch, oracle, outs, metrics, cfg, shape, batch, seq,
                    label):
    """Phase 14's bf16 training gates on the processes' ``outs``
    (``tp_train_child``'s) and rank 0's step ``metrics``, against the
    stacked ``oracle``: launches equal each step (as ``rec_train_launches``
    and ``adamw_launches`` count them), the gradients of the leaves replicated over "model"
    bit-identical on model peers, losses within 2e-2.  Returns rank 0's
    launches over its steps and a summary."""
    want = dict(rec_train_launches(cfg),
                **adamw_launches(oracle, f"{label}[local oracle]"))
    for who, run in [("local oracle", oracle)] + [
            (f"rank {o['rank']}", o) for o in outs]:
        for i, got in enumerate(run["launches"]):
            if got != want:
                raise AssertionError(f"{label}[{who}] step {i}: launches "
                                     f"{got}; expected {want}")
    check_peers(outs, lambda o: o["replicated"], label,
                "a gradient of a leaf replicated over 'model'")
    diffs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
             for a, b in zip(metrics, oracle["metrics"])]
    log(f"{label}: {cfg.name} ({cfg.n_layers} layers) at its published "
        f"widths on a {shape} mesh of {ranks_of(shape)} processes "
        f"({PROC_BACKEND}); {batch} x {seq} tokens a step, "
        f"{REC_TRAIN_STEPS} AdamW steps: every process launched each "
        f"kernel as often as the oracle each step ({want}); the gradients "
        f"of the {len(outs[0]['replicated'][0])} leaves replicated over "
        f"'model' bit-identical on model peers every step; step losses "
        f"{[round(m['loss'], 6) for m in metrics]} against the oracle's, "
        f"relative differences {[f'{d:.3e}' for d in diffs]} (limit "
        f"2e-2); {TP_LABEL}")
    if not max(diffs) < 2e-2:
        raise AssertionError(f"{label}: step losses against the oracle "
                             f"{diffs}")
    summary = {"oracle": {"step_ms": oracle["step_ms"],
                          "peak_gb": oracle["peak_gb"]},
               "loss_diffs": diffs, "ranks": []}
    for o in outs:
        ms = o["train"]["step_ms"]
        r = {"rank": o["rank"], "coords": list(o["coords"]), "step_ms": ms,
             "peak_gb": o["peak_gb"], "card_gb": max(o["card_gb"]),
             "shard_gb": o["shard_gb"], **o["trace"]}
        summary["ranks"].append(r)
        log(f"{label}[rank {o['rank']} {tuple(o['coords'])}]: step ms "
            f"{[round(x, 3) for x in ms]} (the last traced); peak "
            f"{o['peak_gb']:.2f} GB (f32 shard {o['shard_gb']:.2f} GB); the "
            f"card {r['card_gb']:.2f} GB in use; traced step "
            f"{r['host_ms']:.3f} ms: operators over 'model' "
            f"{r['tp_share']:.4f} ({r['tp_sums']} calls), gradient sync "
            f"{r['sync_share']:.4f}")
    counts = {k: sum(step[k] for step in outs[0]["launches"])
              for k in outs[0]["launches"][0]}
    return counts, summary


def phase_rec_cell(torch, kernels, key, config, shape, prompt_shape,
                   plant, train_config, train_shape, gates, noise_unit,
                   impl=None, pure_dp=False):
    """One cell of phase 14: ``config()`` served on the processes of
    ``shape`` and ``train_config()`` trained there, and the f32 gates of
    ``gates`` ((key, f32 config, planted fault, its name) each), in one
    spawn (``rec_cell_child``), against the stacked oracles of its DP
    shape.  Returns the serving launches, the training's and a summary."""
    from repro_torch.launch.serve import flash_plan, serve_procs

    (batch, prompt), (tbatch, tseq) = prompt_shape, train_shape
    label, tlabel = f"rec[{key}]", f"rec[{key} train]"
    t0 = time.perf_counter()
    plan = flash_plan(shape[0], shape[1], SEED) if impl == "plan" else None
    ctx = rec_oracles(torch, kernels, config, shape, batch, prompt, impl,
                      plan, pure_dp)
    cfg = ctx["cfg"]
    log(f"{label}: {cfg.name} ({cfg.n_layers} layers"
        + (f", pattern {''.join(cfg.block_pattern)}" if cfg.block_pattern
           else "") + f") at its published widths on a {shape} mesh of "
        f"{ranks_of(shape)} processes ({PROC_BACKEND})"
        + (", pure_dp: weights whole, the prompts cut over every axis"
           if pure_dp else ", TP over 'model'")
        + f"; {batch} requests of {prompt} tokens and {GEN - 1} decode "
        f"steps" + (f" through the {impl}" if impl else "") + f"; {TP_LABEL}")
    tcfg = train_config()
    oracle = local_oracle(torch, tcfg, tbatch, tseq, REC_TRAIN_STEPS,
                          kernels, shape=shape[:2] + (1,))
    oracles32, wants = {}, {}
    for gkey, gate_config, _, _ in gates:
        oracles32[gkey], wants[gkey] = f32_gate_oracle(
            torch, kernels, gate_config(), tbatch, tseq, shape)
    t_oracles = time.perf_counter() - t0
    holder = [ctx.pop("params32")]
    # the children's allocator only: the parent's tensors they map through
    # CUDA IPC were allocated before
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0, wall0 = time.perf_counter(), time.time()
    res = serve_procs(
        ctx["cfg32"], holder, ctx["prompts"], shape, PROC_BACKEND, DEVICE,
        impl, plan, GEN,
        hook=functools.partial(rec_cell_child, config=config, plant=plant,
                               impl=impl, plan=plan,
                               train_config=train_config, gates=gates,
                               batch=tbatch, seq=tseq, noise_unit=noise_unit,
                               wants=wants),
        timeout=PROC_TIMEOUT_S, join_timeout=PROC_JOIN_S)
    t_procs, wall1 = time.perf_counter() - t0, time.time()
    del os.environ["PYTORCH_CUDA_ALLOC_CONF"], wants
    free(torch)
    torch.cuda.ipc_collect()  # the oracle's tensors the processes mapped
    ranks = res["ranks"]
    r0 = next(o for o in ranks if o["rank"] == 0)
    serving, summary = rec_serve_check(torch, ctx, res, shape, batch, label,
                                       pure_dp)
    counts, summary["train"] = rec_train_check(
        torch, oracle, [o["train"] for o in ranks], r0["train_metrics"],
        tcfg, shape, tbatch, tseq, tlabel)
    for gkey, gate_config, _, name in gates:
        summary["train"][gkey] = f32_gate_check(
            torch, oracles32[gkey], [o[gkey] for o in ranks],
            r0[f"{gkey}_metrics"], shape, tlabel if gkey == "f32" else
            f"{tlabel}[{gkey[4:]}]", name, tbatch,
            tseq, gate_config(), noise_unit)
    summary["oracles_s"], summary["processes_s"] = t_oracles, t_procs
    summary["rank0_stages_s"] = r0["stages_s"]
    start = max(o["entered"] for o in ranks) - wall0
    end = wall1 - max(o["left"] for o in ranks)
    summary["start_s"], summary["end_s"] = start, end
    log(f"phase rec[{key}]: oracles {t_oracles:.1f} s, the processes "
        f"{t_procs:.1f} s: the last to hold its shard after {start:.1f} s, "
        f"the spawn returned {end:.1f} s after the last finished (rank 0 "
        f"from its shard on: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in r0["stages_s"].items()) + ")")
    return serving, counts, summary


def phase_rec(torch, kernels):
    """Phase 14: the recurrent and hybrid families over "model" and
    ``pure_dp``: (a) hymba-1.5b on (1, 1, 16), (b) xlstm-125m on (1, 1,
    8), (c) megatron-moe-32e served and qwen3-0.6b trained with
    ``pure_dp`` on (1, 2, 2).  Returns the serving launches by path, the
    training's and a summary."""
    hymba = functools.partial(rec_config, HYMBA_ARCH)
    xlstm = functools.partial(rec_config, XLSTM_ARCH)
    pure_train = functools.partial(rec_config, PURE_DP_TRAIN_ARCH,
                                   n_layers=PURE_DP_TRAIN_LAYERS,
                                   pure_dp=True)
    channels = ("each process keeping its neighbour's channels after the "
                "gather (Mamba's in_proj, the sLSTM's gates)")
    f32 = {"compute_dtype": "float32"}
    cells = (
        ("a", REC_HYMBA_PATH, REC_HYMBA_TRAIN_PATH,
         functools.partial(hymba, n_layers=REC_HYMBA_LAYERS),
         REC_HYMBA_MESH, (REC_BATCH, REC_HYMBA_PROMPT), NeighbourChannels,
         functools.partial(hymba, n_layers=1), REC_HYMBA_TRAIN,
         [("f32", functools.partial(hymba, n_layers=1, **f32),
           NeighbourChannels, channels)], "dp", None, False),
        # the f32 gate on each block kind alone, on identical inputs (the
        # embedding): the stack's sLSTM amplifies the f32 rounding of its
        # input through the recurrence (PERF.md)
        ("b", REC_XLSTM_PATH, REC_XLSTM_TRAIN_PATH,
         functools.partial(xlstm, n_layers=REC_XLSTM_LAYERS,
                           block_pattern=XLSTM_PATTERN),
         REC_XLSTM_MESH, (REC_BATCH, REC_XLSTM_PROMPT), NeighbourChannels,
         functools.partial(xlstm, n_layers=REC_XLSTM_LAYERS,
                           block_pattern=XLSTM_PATTERN),
         REC_XLSTM_TRAIN,
         [("f32 m", functools.partial(xlstm, n_layers=1,
                                      block_pattern=("m",), **f32),
           gather_bwd_unsummed, "the gathers' backward without its sum "
           "over 'model' (the mLSTM's q, k and gates)"),
          ("f32 s", functools.partial(xlstm, n_layers=1,
                                      block_pattern=("s",), **f32),
           NeighbourChannels, channels)], "dp", None, False),
        ("c", PURE_DP_PATH, PURE_DP_TRAIN_PATH,
         functools.partial(rec_config, PURE_DP_SERVE_ARCH,
                           n_layers=PURE_DP_SERVE_LAYERS, pure_dp=True),
         PURE_DP_MESH, (PURE_DP_BATCH, PURE_DP_PROMPT), NeighbourRows,
         pure_train, PURE_DP_TRAIN,
         [("f32", functools.partial(pure_train, **f32), sync_skipping_model,
           "_sync_grads skipping 'model'")], "process", "plan", True))
    summary, serving, train = {}, {}, {}
    for (key, path, train_path, config, shape, prompts, plant, tcfg,
         tshape, gates, unit, impl, pure_dp) in cells:
        serving[path], train[train_path], summary[key] = phase_rec_cell(
            torch, kernels, key, config, shape, prompts, plant, tcfg, tshape,
            gates, unit, impl, pure_dp)
        free(torch)
    return serving, train, summary


# -- phase 15: sequence parallelism and FSDP on one process per rank ----------

@contextlib.contextmanager
def decode_steps(n):
    """``GEN`` at ``n + 1`` (the prompt pass's token and ``n`` decode
    steps) while active, in this process."""
    global GEN
    was, GEN = GEN, n + 1
    try:
        yield
    finally:
        GEN = was


def spf_config(arch, layers, **over):
    """A phase 15 arch at its published widths, ``layers`` deep."""
    from repro_torch.configs import get_config

    return get_config(arch, n_layers=layers, **over)


class NeighbourChunk:
    """While active, ``tp.scatter_seq`` keeps the next process's sequence
    chunk of the sum in place of its own (phase 15 (a)'s serving
    fault)."""

    def __init__(self):
        from repro_torch.models import tp
        self.tp = tp

    def __enter__(self):
        self.real = real = self.tp.scatter_seq

        def shifted(sp, x):
            return real(sp, x.roll(-sp.chunk, 1))
        self.tp.scatter_seq = shifted
        return self

    def __exit__(self, *exc):
        self.tp.scatter_seq = self.real


class NeighbourSlices:
    """While active, ``fsdp.fsdp_gather`` joins the peers' slices of a leaf
    rolled by one slice (phase 15 (b)'s serving fault)."""

    def __init__(self):
        from repro_torch.models import fsdp
        self.fsdp = fsdp

    def __enter__(self):
        self.real = real = self.fsdp.fsdp_gather

        def rolled(mesh, w, dim, axes):
            return real(mesh, w, dim, axes).roll(w.shape[dim], dim)
        self.fsdp.fsdp_gather = rolled
        return self

    def __exit__(self, *exc):
        self.fsdp.fsdp_gather = self.real


@contextlib.contextmanager
def norms_unsummed():
    """Phase 15 (a)'s training fault: under SP the sync leaving the
    gradients of the leaves used on a sequence chunk (the norms) as each
    process's chunk's part, unsummed over "model"."""
    from repro_torch.launch import train

    real = train._sum_seq_partial
    train._sum_seq_partial = lambda grads, mesh, names: grads
    try:
        yield
    finally:
        train._sum_seq_partial = real


@contextlib.contextmanager
def fsdp_bwd_unsummed():
    """Phase 15 (b)'s training fault: ``fsdp_gather``'s backward keeping
    this process's slice of its own gradient, without the sum over the
    FSDP peers."""
    from repro_torch.models import fsdp

    real = fsdp._FsdpGather.backward

    def own(ctx, g):
        mesh, j = ctx.mesh, 0
        for a in ctx.axes:
            j = j * mesh.axis_size(a) + \
                mesh.rank_coords[mesh.axis_names.index(a)]
        n = mesh.axis_size(ctx.axes)
        return None, g.chunk(n, ctx.dim)[j].contiguous(), None, None
    fsdp._FsdpGather.backward = staticmethod(own)
    try:
        yield
    finally:
        fsdp._FsdpGather.backward = staticmethod(real)


def spf_identity(mesh, rows, plan, whole):
    """Phase 15 (a)'s bit-identity runs, in each process: the 1-layer
    model ``whole`` (the parent's, shared through CUDA IPC) cut for SP +
    FSDP and for the same mesh's TP with neither knob, the prompt pass of
    this process's ``rows`` through the plan in f32 and in bf16: the
    logits and the caches of the two cuts, bit for bit."""
    import torch

    from repro_torch.convert import recast, shard_module
    from repro_torch.launch.serve import make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for dt in ("float32", "bfloat16"):
        got = {}
        for knobs in (True, False):
            cfg = spf_config(SPF_ARCH, 1, compute_dtype=dt,
                             seq_shard_activations=knobs, fsdp=knobs)
            shard = recast(shard_module(whole, cfg, mesh), cfg)
            prefill = make_prefill_step(cfg, mesh, "plan", plan,
                                        cache_len=rows.shape[1] + 1,
                                        device=DEVICE)
            with torch.no_grad():
                logits, cache = prefill(shard, {"tokens": rows})
            got[knobs] = (logits, cache)
            del shard
        (a, ca), (b, cb) = got[True], got[False]
        out[dt] = {"logits_equal": bool(torch.equal(a, b)),
                   "logits_max_abs": float((a.float() - b.float()).abs()
                                           .max()),
                   "cache_equal": all(torch.equal(x[k], y[k])
                                      for x, y in zip(ca, cb) for k in x)}
        del got
        free(torch)
    return out


def spf_states(outs, shape, cfg, replicas):
    """The processes' prefill caches put together, one ``{dotted path:
    tensor}`` a layer: each DP rank's model peers' by kv head
    (``whole_kv_heads``, which raises where replicas differ) or, with
    ``replicas`` (the model peers hold every head), one peer's after
    checking the others' bit for bit; the DP ranks' rows joined."""
    import torch

    from repro_torch.launch.shardings import whole_kv_heads

    groups = {}
    for o in sorted(outs, key=lambda o: o["coords"][2]):
        groups.setdefault(dp_index(o["coords"], shape), []).append(o)
    layers = []
    for i in range(len(outs[0]["cache"])):
        parts = []
        for _, g in sorted(groups.items()):
            caches = [o["cache"][i] for o in g]
            if replicas:
                for c in caches[1:]:
                    if any(not torch.equal(c[k], caches[0][k]) for k in c):
                        raise AssertionError(f"layer {i}: a model peer's "
                                             f"cache differs")
                parts.append(flat_tree(caches[0]))
            else:
                parts.append(flat_tree(whole_kv_heads(caches, cfg)))
        layers.append({k: torch.cat([p[k] for p in parts])
                       for k in parts[0]})
    return layers


def spf_serve_check(torch, ctx, res, shape, batch, label, replicas):
    """Phase 15's serving gates (``rec_serve_check``'s, each DP rank's
    rows served by its model peers): f32 within 1e-4 of the stacked
    oracle, tokens equal, routing apart only at near ties, the caches put
    together (``spf_states``) within 1e-5 of the oracle's layer on the
    processes' own input of it, the planted fault refused; bf16 launches
    equal, tokens and the residual stream (the whole sequence under SP)
    bit-identical on model peers, tokens held to the witness.  Returns
    rank 0's launch counts and a summary."""
    cfg, loc32, loc, wit = ctx["cfg"], ctx["loc32"], ctx["loc"], ctx["wit"]
    summary = ctx["summary"]
    summary["used_gb"].update(res.get("card_used_gb", {}))
    outs = sorted(res["ranks"], key=lambda o: (dp_index(o["coords"], shape),
                                               o["coords"][2]))
    firsts = [o for o in outs if o["coords"][2] == 0]
    err32 = rel_err(torch, res["logits"][0], loc32["logits"].cpu())
    same32 = bool(torch.equal(res["tokens"], loc32["tokens"].cpu()))
    got = spf_states(outs, shape, cfg, replicas)
    stack = state_errs(torch, got, ctx["want_cache"], label)
    layers = state_errs(torch, got, layer_oracle_states(
        torch, outs, shape, ctx["cfg32"], ctx["prompts"].shape[1] + GEN,
        False), label)
    state_err, stack_err = max(layers.values()), max(stack.values())
    fault = rel_err(torch, rec_rows(outs, shape, lambda o: o["fault"],
                                    False, cfg.vocab),
                    loc32["logits"].cpu())
    routes32 = [torch.cat([o["routes32"][i] for o in firsts])
                for i in range(len(loc32["routes"]))]
    flips, n_dec, tie = near_tie_flips(torch, loc32["routes"], routes32,
                                       loc32["margins"], batch) \
        if loc32["routes"] else (0, 0, 0.0)
    log(f"{label}[f32]: serve_procs' prompt-pass logits gathered, max rel "
        f"diff {err32:.3e} against LocalMesh (limit 1e-4); greedy tokens of "
        f"the prompt pass and {GEN - 1} steps equal {same32}; "
        + (f"{flips} of {n_dec} routing decisions differ, each sequence's "
           f"first at an oracle margin of at most {tie:.3e} (limit "
           f"{NEAR_TIE}); " if n_dec else "")
        + f"the caches put together ({'one model peer of each DP rank, '
        'the others bit-identical' if replicas else 'by kv head over the '
        'model peers, the replicas bit-identical'}), each layer on "
        f"identical inputs within {state_err:.3e} of the oracle's (limit "
        f"1e-5); the whole stack's against the oracle's prompt pass "
        f"(reported): {stack_err:.3e}; under the planted fault the logits "
        f"lie {fault:.3e} apart: the gate (1e-4) "
        f"{'refuses' if fault > 1e-4 else 'PASSES'} it")
    if not (err32 < 1e-4 and same32 and state_err <= 1e-5
            and tie <= NEAR_TIE):
        raise AssertionError(f"{label}: f32 prompt pass {err32}, tokens "
                             f"equal {same32}, states {state_err}, routing "
                             f"tie {tie}")
    if not fault > 1e-4:
        raise AssertionError(f"{label}: the planted fault passes the f32 "
                             f"gate ({fault})")
    summary["f32"] = {"max_rel_diff": err32, "tokens_equal": same32,
                      "state_rel_diff": state_err,
                      "stack_state_rel_diff": stack_err,
                      "routing_differs": flips,
                      "first_difference_margin": tie,
                      "planted_fault_rel_diff": fault}
    want_l = run_counts(loc)
    check_tp_launches(outs, want_l, label)
    if cfg.moe is not None and not all(
            want_l["prefill"][k] for k in ("grouped_matmul", "flash_attention",
                                           "a2a_pack", "a2a_unpack")):
        raise AssertionError(f"{label}: the oracle launched "
                             f"{want_l['prefill']} in its prefill")
    check_peers(outs, lambda o: o["serve"]["tokens"].tolist(), label,
                "the greedy tokens")
    check_peers(outs, lambda o: o["stream"], label,
                "the residual stream's digest")
    logits = rec_rows(outs, shape, lambda o: o["serve"]["logits"], False,
                      cfg.vocab)
    tokens = rec_rows(outs, shape, lambda o: o["serve"]["tokens"], False)
    w_routes = [e.cpu() for e in wit["routes"]]
    routes = [torch.cat([o["serve"]["routes"][i] for o in firsts])
              for i in range(len(w_routes))]
    n_flip, n_bf, _, per_seq = route_flips(torch, w_routes, routes, batch) \
        if w_routes else (0, 0, [], torch.zeros(batch, dtype=torch.bool))
    w = summary["witness"] = witness_tokens(torch, wit, loc, tokens, logits,
                                            per_seq)
    w.update(routing_differs=n_flip, sequences_routed_apart=int(
        per_seq.sum()))
    log(f"{label}[bf16]: every process launched each kernel as often as the "
        f"oracle in its prefill ({want_l['prefill']}) and decode; the "
        f"residual stream (the whole sequence) and the greedy tokens "
        f"bit-identical on model peers; against the "
        + ("plain oracle (no TP under pure_dp)" if replicas else
           "witness (the oracle with TP rounding of the row-parallel "
           "products alone)")
        + f": prompt-pass logits max rel diff {w['logits_rel_diff']:.3e} "
        f"(bit-identical {w['logits_equal']}); "
        + (f"routing differs in {n_flip} of {n_bf} decisions, "
           f"{w['sequences_routed_apart']} sequences apart (limit "
           f"{PROC_BF16_APART_MAX}); " if n_bf else "")
        + f"greedy tokens equal in {w['sequences_same_tokens']} of {batch} "
        f"(the plain oracle's in {w['oracle_sequences_same_tokens']}); "
        f"each sequence whose tokens differ (sequence, step, gap): "
        f"{w['token_gaps']} (limit {BF16_TOKEN_TIE}; one planted at the "
        f"median gap reads {w['planted_token_gap']:.3e})")
    check_witness_tokens(label, w)
    if not w["sequences_routed_apart"] <= PROC_BF16_APART_MAX:
        raise AssertionError(f"{label}: {w['sequences_routed_apart']} "
                             f"sequences routed apart in bf16")
    tp_report(outs, summary, label)
    for o, r in zip(outs, summary["ranks"]):
        r["shard_gb"] = o["shard_gb"]
        log(f"{label}[rank {o['rank']}]: traced prompt pass "
            f"{o['shares']['host_ms']:.3f} ms, each collective's share: "
            + ", ".join(f"{k} {v['share']:.4f} ({v['calls']})"
                        for k, v in o["shares"]["spans"].items()))
    r0 = next(o for o in outs if o["rank"] == 0)
    return {"prefill": r0["serve"]["prefill_launches"],
            "decode": r0["serve"]["decode_launches"]}, summary


def spf_train_check(torch, oracle, outs, metrics, cfg, shape, batch, seq,
                    label):
    """Phase 15's bf16 training gates: each process's launches each step
    equal to the stacked oracle's, the gradients of the leaves replicated
    over "model" bit-identical on model peers, losses within 2e-2.
    Returns rank 0's launches over its steps and a summary."""
    for o in outs:
        if o["launches"] != oracle["launches"]:
            raise AssertionError(f"{label}: rank {o['rank']} launched "
                                 f"{o['launches']}; the oracle "
                                 f"{oracle['launches']}")
    check_peers(outs, lambda o: o["replicated"], label,
                "a gradient of a leaf replicated over 'model'")
    diffs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
             for a, b in zip(metrics, oracle["metrics"])]
    log(f"{label}: {cfg.name} ({cfg.n_layers} layer(s)) at its published "
        f"widths on a {shape} mesh of {ranks_of(shape)} processes "
        f"({PROC_BACKEND}); {batch} x {seq} tokens a step, "
        f"{REC_TRAIN_STEPS} AdamW steps: every process launched each "
        f"kernel as often as the oracle each step ({oracle['launches']}); "
        f"the gradients of the {len(outs[0]['replicated'][0])} leaves "
        f"replicated over 'model' bit-identical on model peers every step; "
        f"step losses {[round(m['loss'], 6) for m in metrics]} against the "
        f"oracle's, relative differences {[f'{d:.3e}' for d in diffs]} "
        f"(limit 2e-2); the oracle's step 0 {oracle['step_ms'][0]:.1f} ms, "
        f"peak {oracle['peak_gb']:.2f} GB; {TP_LABEL}")
    if not max(diffs) < 2e-2:
        raise AssertionError(f"{label}: step losses against the oracle "
                             f"{diffs}")
    summary = {"oracle": {"step_ms": oracle["step_ms"],
                          "peak_gb": oracle["peak_gb"]},
               "loss_diffs": diffs, "ranks": []}
    for o in outs:
        ms = o["train"]["step_ms"]
        r = {"rank": o["rank"], "coords": list(o["coords"]), "step_ms": ms,
             "peak_gb": o["peak_gb"], "card_gb": max(o["card_gb"]),
             "shard_gb": o["shard_gb"], **o["trace"]}
        summary["ranks"].append(r)
        log(f"{label}[rank {o['rank']} {tuple(o['coords'])}]: step ms "
            f"{[round(x, 3) for x in ms]} (the last traced); peak "
            f"{o['peak_gb']:.2f} GB (f32 shard {o['shard_gb']:.2f} GB, "
            f"with its moments {3 * o['shard_gb']:.2f} GB); the card "
            f"{r['card_gb']:.2f} GB in use; traced step {r['host_ms']:.3f} "
            f"ms: gradient sync {r['sync_share']:.4f}, each collective: "
            + ", ".join(f"{k} {v['share']:.4f} ({v['calls']})"
                        for k, v in r["spans"].items()))
    counts = {k: sum(step[k] for step in outs[0]["launches"])
              for k in outs[0]["launches"][0]}
    return counts, summary


def spf_check_identity(outs, label):
    """Phase 15 (a)'s bit-identity gate: every process's 1-layer prompt
    pass with SP + FSDP bit for bit the knob-free TP run's, in f32 and
    bf16, logits and caches."""
    for dt in ("float32", "bfloat16"):
        got = [o["extra"][dt] for o in outs]
        log(f"{label}[identity {dt}]: 1 layer, the prompt pass with SP + "
            f"FSDP against the same mesh's TP with neither knob in the "
            f"same processes: logits bit-identical on "
            f"{sum(g['logits_equal'] for g in got)} of {len(got)} "
            f"processes (largest difference "
            f"{max(g['logits_max_abs'] for g in got):.3e}), caches on "
            f"{sum(g['cache_equal'] for g in got)}")
        if not all(g["logits_equal"] and g["cache_equal"] for g in got):
            raise AssertionError(f"{label}: SP + FSDP's {dt} prompt pass "
                                 f"is not the TP run's bits: {got}")
    return {dt: all(o["extra"][dt]["logits_equal"] for o in outs)
            for dt in ("float32", "bfloat16")}


def phase_spf_cell(torch, kernels, key, config, shape, prompt_shape, plant,
                   train_config, train_shape, gate, impl, replicas,
                   identity=False, steps=GEN - 1):
    """One cell of phase 15: ``config()`` served on the processes of
    ``shape`` and ``train_config()`` trained there with the f32 gate
    ``gate`` ((f32 config, planted fault, its name)), in one spawn
    (``rec_cell_child`` on the 1-layer trainable model the parent makes
    from the seed, shared through CUDA IPC; with ``identity`` also
    ``spf_identity`` on it), against the stacked oracles of its DP shape;
    ``steps`` decode steps.  Returns the serving launches, the training's
    and a summary."""
    with decode_steps(steps):
        return spf_cell(torch, kernels, key, config, shape, prompt_shape,
                        plant, train_config, train_shape, gate, impl,
                        replicas, identity)


def spf_cell(torch, kernels, key, config, shape, prompt_shape, plant,
             train_config, train_shape, gate, impl, replicas, identity):
    """``phase_spf_cell``'s run, ``GEN`` set."""
    from repro_torch.launch.serve import flash_plan, serve_procs
    from repro_torch.launch.shardings import named_params

    (batch, prompt), (tbatch, tseq) = prompt_shape, train_shape
    label, tlabel = f"spf[{key}]", f"spf[{key} train]"
    t0 = time.perf_counter()
    plan = flash_plan(shape[0], shape[1], SEED) if impl == "plan" else None
    # the witness: TP's rounding over "model" (SP's bits being TP's), or
    # the plain oracle where the model peers are replicas (no TP)
    ctx = rec_oracles(torch, kernels, config, shape, batch, prompt, impl,
                      plan, pure_dp=replicas)
    cfg = ctx["cfg"]
    log(f"{label}: {cfg.name} ({cfg.n_layers} layers) at its published "
        f"widths on a {shape} mesh of {ranks_of(shape)} processes "
        f"({PROC_BACKEND}), seq_shard_activations "
        f"{cfg.seq_shard_activations}, fsdp {cfg.fsdp}, pure_dp "
        f"{cfg.pure_dp}; {batch} requests of {prompt} tokens and {GEN - 1} "
        f"decode steps" + (f" through the {impl}" if impl else "")
        + f"; {TP_LABEL}")
    tcfg = train_config()
    oracle = local_oracle(torch, tcfg, tbatch, tseq, REC_TRAIN_STEPS,
                          kernels, shape=shape[:2] + (1,))
    gate_config, gate_plant, gate_name = gate
    oracle32, want = f32_gate_oracle(torch, kernels, gate_config(), tbatch,
                                     tseq, shape)
    wholes = {"train": {k: v.detach() for k, v in named_params(
        stack_params(torch, tcfg, train=True)).items()}}
    gcfg = gate_config()
    # one model for both where the f32 gate's has the bf16 run's depth
    wholes["f32"] = wholes["train"] if gcfg.n_layers == tcfg.n_layers \
        else {k: v.detach() for k, v in named_params(
            stack_params(torch, gcfg, train=True)).items()}
    whole_gb = sum(t.numel() * t.element_size()
                   for t in wholes["train"].values()) / 1e9
    t_oracles = time.perf_counter() - t0
    holder = [ctx.pop("params32")]
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0, wall0 = time.perf_counter(), time.time()
    res = serve_procs(
        ctx["cfg32"], holder, ctx["prompts"], shape, PROC_BACKEND, DEVICE,
        impl, plan, GEN,
        hook=functools.partial(
            rec_cell_child, config=config, plant=plant, impl=impl,
            plan=plan, train_config=train_config,
            gates=[("f32", gate_config, gate_plant, gate_name)],
            batch=tbatch, seq=tseq, noise_unit="dp", wants={"f32": want},
            train_wholes=wholes, extra=spf_identity if identity else None,
            fault_peers=True, gen=GEN),
        timeout=PROC_TIMEOUT_S, join_timeout=PROC_JOIN_S)
    t_procs, wall1 = time.perf_counter() - t0, time.time()
    del os.environ["PYTORCH_CUDA_ALLOC_CONF"], want, wholes
    free(torch)
    torch.cuda.ipc_collect()
    ranks = res["ranks"]
    r0 = next(o for o in ranks if o["rank"] == 0)
    serving, summary = spf_serve_check(torch, ctx, res, shape, batch, label,
                                       replicas)
    if identity:
        summary["bit_identical_to_tp"] = spf_check_identity(ranks, label)
    counts, summary["train"] = spf_train_check(
        torch, oracle, [o["train"] for o in ranks], r0["train_metrics"],
        tcfg, shape, tbatch, tseq, tlabel)
    shard_gb = [o["train"]["shard_gb"] for o in ranks]
    summary["train"]["whole_gb"] = whole_gb
    log(f"{tlabel}: each process holds {min(shard_gb):.3f} to "
        f"{max(shard_gb):.3f} GB of f32 parameters and twice that in AdamW "
        f"moments; the same model without FSDP and "
        + ("SP (the TP shard of each process: the whole's 1 / "
           f"{shape[2]} and more)" if not replicas else
           "(pure_dp: the whole on every process)")
        + f": the whole holds {whole_gb:.3f} GB, {3 * whole_gb:.3f} GB "
        f"with its moments")
    summary["train"]["f32"] = f32_gate_check(
        torch, oracle32, [o["f32"] for o in ranks], r0["f32_metrics"], shape,
        tlabel, gate_name, tbatch, tseq, gate_config(), "dp")
    # the faulty step's replicated gradients must also part model peers
    try:
        check_peers([o["f32"] for o in ranks], lambda o: o["fault_peers"],
                    tlabel, "a faulty step's gradient of a leaf replicated "
                    "over 'model'")
        apart = False
    except AssertionError:
        apart = True
    log(f"{tlabel}[f32 planted fault]: {gate_name}: the faulty step's "
        f"gradients of the leaves replicated over 'model' "
        f"{'differ between model peers: the peers gate refuses it' if apart else 'bit-identical on model peers'}")
    if replicas is False and not apart:
        raise AssertionError(f"{tlabel}: under the planted fault the model "
                             f"peers' replicated gradients stay equal")
    summary["train"]["f32"]["fault_parts_model_peers"] = apart
    summary["oracles_s"], summary["processes_s"] = t_oracles, t_procs
    summary["rank0_stages_s"] = r0["stages_s"]
    start = max(o["entered"] for o in ranks) - wall0
    end = wall1 - max(o["left"] for o in ranks)
    summary["start_s"], summary["end_s"] = start, end
    log(f"phase spf[{key}]: oracles {t_oracles:.1f} s, the processes "
        f"{t_procs:.1f} s: the last to hold its shard after {start:.1f} s, "
        f"the spawn returned {end:.1f} s after the last finished (rank 0 "
        f"from its shard on: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in r0["stages_s"].items()) + ")")
    return serving, counts, summary


def phase_spf(torch, kernels):
    """Phase 15: sequence parallelism and FSDP on one process per rank.
    (a) megatron-moe-32e with SP + FSDP on (1, 2, 4), served through the
    plan and trained, and a 1-layer prompt pass bit for bit the same
    mesh's TP run without either knob; (b) qwen3-0.6b with ``pure_dp`` +
    FSDP on (1, 2, 2), served and trained.  Returns the serving launches
    by path, the training's and a summary."""
    both = {"seq_shard_activations": True, "fsdp": True}
    pure = {"pure_dp": True, "fsdp": True}
    f32 = {"compute_dtype": "float32"}
    cells = (
        ("a", SPF_PATH, SPF_TRAIN_PATH,
         functools.partial(spf_config, SPF_ARCH, SPF_LAYERS, **both),
         SPF_MESH, (SPF_BATCH, SPF_PROMPT), NeighbourChunk,
         functools.partial(spf_config, SPF_ARCH, 1, **both), SPF_TRAIN,
         (functools.partial(spf_config, SPF_ARCH, 1, **both, **f32),
          norms_unsummed, "under SP the sync leaving the norms' "
          "chunk-partial gradients unsummed over 'model'"),
         "plan", False, True, GEN - 1),
        ("b", FSDP_PATH, FSDP_TRAIN_PATH,
         functools.partial(spf_config, FSDP_ARCH, FSDP_LAYERS, **pure),
         FSDP_MESH, (FSDP_BATCH, FSDP_PROMPT), NeighbourSlices,
         functools.partial(spf_config, FSDP_ARCH, FSDP_LAYERS, **pure),
         FSDP_TRAIN,
         (functools.partial(spf_config, FSDP_ARCH, 1, **pure, **f32),
          fsdp_bwd_unsummed, "fsdp_gather's backward keeping this "
          "process's slice of its own gradient, unsummed over its FSDP "
          "peers"),
         None, True, False, FSDP_STEPS))
    summary, serving, train = {}, {}, {}
    for (key, path, train_path, config, shape, prompts, plant, tcfg,
         tshape, gate, impl, replicas, identity, steps) in cells:
        t0 = time.perf_counter()
        serving[path], train[train_path], summary[key] = phase_spf_cell(
            torch, kernels, key, config, shape, prompts, plant, tcfg, tshape,
            gate, impl, replicas, identity, steps)
        summary[key]["cell_s"] = time.perf_counter() - t0
        free(torch)
    return serving, train, summary


@contextlib.contextmanager
def unreported(name):
    """Phase 16 (b)'s planted fault: kernel ``name``'s wrapper neither
    reports its formula to ``count()`` nor hides its own work (its launch
    goes unseen on the card)."""
    module = sys.modules[{
        "grouped_matmul": "repro_torch.kernels.grouped_matmul.grouped_matmul",
        "flash_attention":
            "repro_torch.kernels.flash_attention.flash_attention"}[name]]
    real = module._counted
    module._counted = lambda kernel, cost: contextlib.nullcontext() \
        if kernel == name else real(kernel, cost)
    try:
        yield
    finally:
        module._counted = real


def roofline_child(mesh, cfg, shards, rows, serve_cli, plan, cache_len):
    """One rank of phase 16 (b): this process's prompt pass (the step
    ``serve_procs`` runs) under ``count()``, then again with
    ``grouped_matmul``'s report removed (the planted fault), then the serve
    the hook owes."""
    from repro_torch.launch.roofline import count
    from repro_torch.launch.serve import make_prefill_step

    import torch

    step = make_prefill_step(cfg, mesh, "plan", plan, cache_len=cache_len)
    batch = {"tokens": rows}
    with count() as sound:
        step(shards[0], batch)
    torch.cuda.synchronize()
    with unreported("grouped_matmul"), count() as fault:
        step(shards[0], batch)
    torch.cuda.synchronize()
    serve_cli()
    return {"rank": mesh.rank, "counts": sound.summary(),
            "fault": fault.summary()}


def counted_ops(run):
    """``run()`` under ``count()``: the counts, and the bytes by aten op."""
    import collections

    from repro_torch.launch import roofline as R

    by_op, real = collections.Counter(), R._op_bytes

    def spy(func, args, kwargs, out, lifted=None):
        n = real(func, args, kwargs, out, lifted)
        by_op[str(func)] += n
        return n

    R._op_bytes = spy
    try:
        with R.count() as c:
            run()
    finally:
        R._op_bytes = real
    return c, by_op


def log_counts(label, c):
    coll = c["collectives"]
    log(f"{label}: FLOPs {c['flops']}, bytes {c['bytes']}; kernels "
        + ", ".join(f"{k} {v['calls']} calls ({v['flops']} FLOPs, "
                    f"{v['bytes']} bytes)" for k, v in c["kernels"].items())
        + f"; {coll['count']} collectives, wire bytes ici "
        f"{coll['ici_bytes']} dcn {coll['dcn_bytes']}, by op and tier "
        f"{json.dumps(coll['by_tier'])}")


def phase_dryrun_cells(torch):
    """Phase 16 (a): DRY_CELLS dry-run on rank 0 of the multi-pod
    production mesh; each key printed, ``params_total``, ``params_active``
    and ``model_flops_total`` gated against the config's own counts."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models import build_model

    out = {}
    for arch, shape_name, impl in DRY_CELLS:
        t0 = time.perf_counter()
        res = run_cell(arch, shape_name, "multi", impl)
        wall = time.perf_counter() - t0
        label = f"roofline[dry {arch} {shape_name} multi"
        label += f" {impl}]" if impl else "]"
        if res["status"] != "ok":
            raise AssertionError(f"{label}: {res.get('error')}\n"
                                 f"{res.get('traceback')}")
        cfg, shape = get_config(arch), SHAPES[shape_name]
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
        per_token = {"train": 6.0}.get(shape.kind, 2.0)
        want = {"params_total": cfg.n_params(),
                "params_active": cfg.n_active_params(),
                "model_flops_total": per_token * cfg.n_active_params()
                * tokens}
        module = sum(p.numel() for p in build_model(cfg, "meta").init(
            torch.Generator()).parameters())
        for key, value in res.items():
            if key not in ("arch", "shape", "mesh"):
                log(f"{label}: {key} = {json.dumps(value)}")
        log(f"{label}: {wall:.1f} s on the host; the module holds {module} "
            f"parameters (the config counts {cfg.n_params()}: norms "
            f"and biases aside)")
        bad = {k: (res[k], v) for k, v in want.items() if res[k] != v}
        if bad or res["flops_per_chip"] <= 0 or res["bytes_per_chip"] <= 0:
            raise AssertionError(f"{label}: against the config's counts "
                                 f"{bad}")
        out[f"{arch} {shape_name}"] = {
            "run_s": wall, "roofline": res["roofline"],
            "flops_per_chip": res["flops_per_chip"],
            "bytes_per_chip": res["bytes_per_chip"],
            "useful_flop_ratio": res["useful_flop_ratio"],
            "memory": res["memory"], "collectives": res["collectives"]}
    return out


def phase_roofline_procs(torch):
    """Phase 16 (b): phase 8's megatron-moe-32e cell on the processes of
    PROC_MESH sharing the card; rank 0's counted prompt pass must equal the
    dry run of the same cell and mesh exactly (FLOPs, bytes, kernels,
    collectives by op and tier), and with ``grouped_matmul``'s report
    removed in the processes must not."""
    from repro_torch.launch.dryrun import dry_counts
    from repro_torch.launch.serve import flash_plan, serve_procs

    cfg = serve_config()
    plan = flash_plan(PROC_MESH[0], PROC_MESH[1], SEED)
    prompts = stack_prompts(torch, cfg, PROC_BATCH, PROMPT)
    cache_len = PROMPT + ROOF_GEN
    t0 = time.perf_counter()
    want, _ = dry_counts(cfg, "prefill", PROMPT, PROC_BATCH, PROC_MESH,
                         AXES, "plan", plan, cache_len=cache_len)
    want = want.summary()
    t_dry = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = serve_procs(cfg, [stack_params(torch, cfg)], prompts, PROC_MESH,
                      PROC_BACKEND, DEVICE, "plan", plan, ROOF_GEN,
                      hook=functools.partial(roofline_child, plan=plan,
                                             cache_len=cache_len),
                      timeout=PROC_TIMEOUT_S, join_timeout=PROC_JOIN_S)
    t_procs = time.perf_counter() - t0
    free(torch)
    torch.cuda.ipc_collect()
    r0 = next(r for r in res["ranks"] if r["rank"] == 0)
    label = (f"roofline[procs {cfg.name} {cfg.n_layers} layers "
             f"{PROC_MESH}, {PROC_BATCH} x {PROMPT} prompt pass, rank 0]")
    log_counts(f"{label} on the card", r0["counts"])
    log_counts(f"{label} dry run", want)
    log_counts(f"{label} planted fault, grouped_matmul unreported",
               r0["fault"])
    tiers = {t for by in want["collectives"]["by_tier"].values()
             for t, v in by.items() if v}
    equal = r0["counts"] == want
    refused = r0["fault"] != want
    log(f"{label}: the card's counts {'equal' if equal else 'DIFFER FROM'} "
        f"the dry run's (tiers {sorted(tiers)}); the planted fault "
        f"{'is refused' if refused else 'PASSES'}; dry run {t_dry:.1f} s, "
        f"the processes {t_procs:.1f} s")
    if not equal:
        diff = {k: (r0["counts"][k], want[k]) for k in want
                if r0["counts"][k] != want[k]}
        raise AssertionError(f"{label}: the card's counts differ from the "
                             f"dry run's: {diff}")
    if not refused or tiers != {"ici", "dcn"}:
        raise AssertionError(f"{label}: planted fault refused {refused}, "
                             f"tiers {tiers}")
    return {"flops": want["flops"], "bytes": want["bytes"],
            "collectives": want["collectives"], "dry_s": t_dry,
            "processes_s": t_procs,
            "fault_flops": r0["fault"]["flops"]}


def phase_roofline_mixtral(torch, smi):
    """Phase 16 (c): phase 4's stacked mixtral-8x7b plan prefill (MESH on
    the card) under ``count()``: its roofline terms beside its measured
    time (host clock to a synchronize, after a warm-up; ROOF_RUNS runs)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.roofline import HW, count, roofline_terms
    from repro_torch.launch.serve import flash_plan, make_prefill_step

    cfg = mixtral_config()
    dev = torch.device(DEVICE)
    mesh = make_mesh(MESH, AXES, dev)
    plan = flash_plan(MESH[0], MESH[1], SEED)
    params = stack_params(torch, cfg)
    prompts = stack_prompts(torch, cfg, BATCH, MIX_PROMPT)
    step = make_prefill_step(cfg, mesh, "plan", plan,
                             cache_len=MIX_PROMPT + GEN)
    batch = {"tokens": prompts}
    step(params, batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(ROOF_RUNS):
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    c, by_op = counted_ops(lambda: step(params, batch))
    torch.cuda.synchronize()
    del params
    free(torch)
    # the same step on meta tensors, as the dry run would count it
    meta_mesh = make_mesh(MESH, AXES, "meta")
    meta = make_prefill_step(cfg, meta_mesh, "plan", plan,
                             cache_len=MIX_PROMPT + GEN, device="meta")
    from repro_torch.models import build_model

    meta_params = build_model(cfg, "meta").init(torch.Generator())
    m, meta_by_op = counted_ops(lambda: meta(meta_params, {
        "tokens": torch.empty(prompts.shape, dtype=prompts.dtype,
                              device="meta")}))
    terms = roofline_terms(c.flops, c.bytes, c.collectives, HW())
    label = (f"roofline[stacked {cfg.name} {cfg.n_layers} layers {MESH}, "
             f"plan prefill {BATCH} x {MIX_PROMPT}]")
    log_counts(label, c.summary())
    apart = {k: (by_op[k], meta_by_op[k]) for k in set(by_op) | set(
        meta_by_op) if by_op[k] != meta_by_op[k]}
    log(f"{label}: on meta tensors FLOPs {m.flops}, bytes {m.bytes}: "
        + ("the card's counts" if c.summary() == m.summary()
           else f"apart from the card's, by op (card, meta) "
                f"{json.dumps(apart)}"))
    bound_ms = max(terms["compute_s"], terms["memory_s"],
                   terms["collective_s"]) * 1e3
    log(f"{label}: compute_s {terms['compute_s']:.6f}, memory_s "
        f"{terms['memory_s']:.6f}, collective_s {terms['collective_s']:.6f} "
        f"(a stacked mesh's exchange is device copies: no process "
        f"collective), dominant {terms['dominant']}; measured prefill "
        f"{statistics.median(times):.3f} ms (median of {ROOF_RUNS}: "
        f"{', '.join(f'{t:.3f}' for t in times)}), "
        f"{statistics.median(times) / bound_ms:.3f}x the bound; on {smi}")
    return {"roofline": terms, "flops": c.flops, "bytes": c.bytes,
            "meta_equal": c.summary() == m.summary(),
            "prefill_ms": times, "bound_ms": bound_ms}


def phase_roofline(torch, smi):
    """Phase 16: the roofline and the dry run, (a) to (c)."""
    out = {}
    for key, fn in (("a", phase_dryrun_cells), ("b", phase_roofline_procs),
                    ("c", functools.partial(phase_roofline_mixtral,
                                            smi=smi))):
        t0 = time.perf_counter()
        out[key] = fn(torch)
        log(f"phase roofline ({key}): {time.perf_counter() - t0:.1f} s")
    return out


RATIO_LIMITS = {"grouped_matmul prefill": 2.5, "grouped_matmul decode": 3.0,
                "flash_attention mixtral-8x7b prefill": 3.5,
                "flash_attention mixtral-8x7b long prefill": 1.5,
                "flash_attention megatron-moe-32e prefill": 2.7,
                "flash_attention_bwd megatron-moe-32e train": 1.0,
                "flash_attention_bwd mixtral-8x7b long": 1.0,
                "a2a prefill": 1.0, "a2a decode": 1.0}
BOUND_LIMITS = {"a2a mixtral-8x7b prefill": 1.15}
CALL_LIMITS = {"a2a decode": 1.2}


def verdict(limit, ratio) -> str:
    if limit is None:
        return ""
    return f" (limit {limit}: {'within' if ratio <= limit else 'OVER'})"


def log_ratios(rows):
    """Each redesigned kernel's time over its library call's at every
    serving shape, beside the limit it should stay under; for pack and
    unpack also the ratio to the bound and the one-call-per-pair ratio."""
    for name in KERNELS:
        for e in rows[name]["shapes"]:
            what = e["path"].split()[-1]
            key = {"grouped_matmul": f"{name} {e['path'].split()[-2]}",
                   "flash_attention": f"{name} {e['path']}",
                   "flash_attention_bwd": f"{name} {e['path']}"}.get(
                       name, f"a2a {what}")
            bound = (verdict(BOUND_LIMITS.get(f"a2a {e['path']}"),
                             e["ratio_to_bound"])
                     if name.startswith("a2a") else "")
            log(f"ratio: {name} {e['path']}: {e['ms']:.4f} ms / library "
                f"{e['library_ms']:.4f} ms = {e['ratio_to_library']:.3f}"
                f"{verdict(RATIO_LIMITS.get(key), e['ratio_to_library'])}; "
                f"{e['ratio_to_bound']:.3f}x its bound {e['bound_ms']:.4f} "
                f"ms{bound}")
            if "call_ms" in e:
                ratio = e["call_ms"] / e["library_call_ms"]
                log(f"ratio: {name} {e['path']}, one call per event pair: "
                    f"{e['call_ms']:.4f} ms / library "
                    f"{e['library_call_ms']:.4f} ms = {ratio:.3f}"
                    f"{verdict(CALL_LIMITS.get(key), ratio)}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 checks in full f32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import _build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    lines = ptxas_lines(_build)
    for line in lines:
        log(line)
    log(f"build: no spill in the {len(check_no_spill(lines))} instances of "
        f"{', '.join(NO_SPILL)}")

    # 2. kernels against their plain versions; a small reference
    t0 = time.perf_counter()
    rows = phase_kernels(torch)
    rows["flash_attention"] = phase_flash_attention(torch)
    for e in rows["flash_attention"]["shapes"]:
        was = FLASH_MS_BEFORE_LSE[e["path"]]
        log(f"ratio: flash_attention {e['path']} against its time before "
            f"the lse store: {e['ms']:.4f} / {was:.4f} ms = "
            f"{e['ms'] / was:.3f} (the serving path writes no lse)")
    phase_small_reference(torch)
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    adamw_rows = phase_adamw(torch)
    log(f"phase adamw: {time.perf_counter() - t0:.1f} s")

    # 3. megatron-moe-32e; 4. mixtral-8x7b
    kernels = proc_kernels()
    t0 = time.perf_counter()
    launches = {"megatron-moe-32e plan": phase_megatron(torch, kernels)}
    log(f"phase megatron: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(phase_mixtral(torch, kernels))
    log(f"phase mixtral: {time.perf_counter() - t0:.1f} s")

    # 5. the backward's kernels; 6. training
    t0 = time.perf_counter()
    rows["flash_attention_bwd"], gmm_bwd = phase_backward_kernels(torch)
    rows["grouped_matmul"]["shapes"] += gmm_bwd
    log_ratios(rows)
    log(f"phase backward kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_launches, summary = phase_training(torch, kernels)
    log(f"phase training: {time.perf_counter() - t0:.1f} s; "
        f"{json.dumps(summary)}")

    # 7. the recurrent, hybrid and encoder-decoder stacks, and the plan
    # server
    t0 = time.perf_counter()
    stack_launches, stacks = phase_stacks(torch, kernels)
    log(f"phase stacks: {time.perf_counter() - t0:.1f} s; "
        f"{json.dumps(stacks)}")

    # 8. one process per rank on the card
    t0 = time.perf_counter()
    launches[PROC_PATH], procs = phase_procs(torch, kernels)
    log(f"phase procs: {time.perf_counter() - t0:.1f} s; "
        f"{json.dumps(procs)}")

    # 9. training on one process per rank on the card
    t0 = time.perf_counter()
    train_proc_launches, train_procs_summary = phase_train_procs(torch,
                                                                 kernels)
    log(f"phase train procs: {time.perf_counter() - t0:.1f} s; "
        f"{json.dumps(train_procs_summary)}")

    # 10. the split island on one process per rank: mixtral over pod, EP
    # over data alone, replicated experts; served and trained
    t0 = time.perf_counter()
    split_launches, split_train_launches, split = phase_split(torch, kernels)
    launches.update(split_launches)
    log(f"phase split: {time.perf_counter() - t0:.1f} s; "
        f"{json.dumps(split)}")

    # 11. tensor parallelism over "model" on one process per rank:
    # megatron-moe-32e served and trained, llama3.2-1b served
    t0 = time.perf_counter()
    tp_launches, tp_train_launches, tp = phase_tp(torch, kernels)
    launches.update(tp_launches)
    log(f"phase tp: {time.perf_counter() - t0:.1f} s; {json.dumps(tp)}")

    # 12. tensor parallelism over "model" where it cuts through the kv
    # heads: megatron-moe-32e on (1, 1, 16), served and trained
    t0 = time.perf_counter()
    kv_launches, kv_train_launches, kv = phase_kv(torch, kernels)
    launches.update(kv_launches)
    log(f"phase kv: {time.perf_counter() - t0:.1f} s; {json.dumps(kv)}")

    # 13. tensor parallelism over "model" where it cuts through a query
    # head: internvl2-1b on (1, 1, 16) and whisper-tiny on (1, 2, 4),
    # served and trained
    t0 = time.perf_counter()
    head_launches, head_train_launches, head = phase_head(torch, kernels)
    launches.update(head_launches)
    log(f"phase head: {time.perf_counter() - t0:.1f} s; {json.dumps(head)}")

    # 14. the recurrent and hybrid families over "model" and pure_dp:
    # hymba-1.5b on (1, 1, 16) and xlstm-125m on (1, 1, 8), served and
    # trained; megatron-moe-32e served and qwen3-0.6b trained with pure_dp
    # on (1, 2, 2)
    t0 = time.perf_counter()
    rec_launches, rec_train_launches_, rec = phase_rec(torch, kernels)
    launches.update(rec_launches)
    log(f"phase rec: {time.perf_counter() - t0:.1f} s; {json.dumps(rec)}")

    # 15. sequence parallelism and FSDP on one process per rank:
    # megatron-moe-32e with both on (1, 2, 4), qwen3-0.6b with pure_dp and
    # FSDP on (1, 2, 2), served and trained
    t0 = time.perf_counter()
    spf_launches, spf_train_launches, spf = phase_spf(torch, kernels)
    launches.update(spf_launches)
    log(f"phase spf: {time.perf_counter() - t0:.1f} s; {json.dumps(spf)}")

    # 16. the roofline and the dry run: two full-width cells on one rank of
    # the multi-pod production mesh, phase 8's cell counted on its
    # processes against the dry run, phase 4's plan prefill's terms
    t0 = time.perf_counter()
    roof = phase_roofline(torch, smi)
    log(f"phase roofline: {time.perf_counter() - t0:.1f} s; "
        f"{json.dumps(roof)}")

    # Each kernel's count is that of the megatron-moe-32e training cell for
    # grouped_matmul, both attention kernels and AdamW's two, mixtral's
    # plan run for pack and unpack, which training does not launch: the
    # main path of the port is the MoE cell, so PERF.md's launch column
    # keeps its meaning.  Every path's counts are listed beside them, phase
    # 7's stacks' too.
    serving = launches["mixtral-8x7b plan"]
    main_train = f"megatron-moe-32e train ({TRAIN_STEPS} steps)"

    def training_paths(name):
        by_path = {main_train: train_launches[name]}
        by_path[f"{TRAIN_PROC_PATH} ({TRAIN_PROC_STEPS} steps, each "
                f"process)"] = train_proc_launches[name]
        by_path[f"{SPLIT_TRAIN_PATH} ({SPLIT_TRAIN_STEPS} steps, each "
                f"process)"] = split_train_launches[name]
        by_path[f"{TP_TRAIN_PATH} ({TRAIN_PROC_STEPS} steps, rank 0)"] = \
            tp_train_launches[name]
        by_path[f"{KV_TRAIN_PATH} ({TRAIN_PROC_STEPS} steps, rank 0)"] = \
            kv_train_launches[name]
        for path, counts in head_train_launches.items():
            by_path[f"{path} ({HEAD_TRAIN_STEPS} steps, rank 0)"] = \
                counts[name]
        for path, counts in list(rec_train_launches_.items()) + list(
                spf_train_launches.items()):
            by_path[f"{path} ({REC_TRAIN_STEPS} steps, rank 0)"] = \
                counts[name]
        for path, counts in stack_launches.items():
            if name in counts:
                by_path[path] = counts[name]
        return by_path

    result = []
    for name in KERNELS:
        row = rows[name]
        if "ms" not in row:  # the first timed shape: megatron's prefill
            first = row["shapes"][0]
            row.update({key: first[key] for key in (
                "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "instance", "call_ms", "library_call_ms",
                "bulk_ms", "vec_ms", "ratio_to_library", "ratio_to_bound")
                if key in first})
        by_path = {p: {"prefill": c["prefill"][name],
                       "decode": c["decode"][name]}
                   for p, c in launches.items()}
        by_path.update(training_paths(name))
        if train_launches[name]:
            row = dict(row, launches=train_launches[name],
                       main_path=main_train)
            if name in summary["launches_by_variant"]:
                row["launches_by_variant"] = \
                    summary["launches_by_variant"][name]
        else:
            if name in serving["prefill_variants"]:
                row["launches_by_variant"] = {
                    part: serving[f"{part}_variants"][name]
                    for part in ("prefill", "decode")}
            row = dict(row, launches=serving["prefill"][name]
                       + serving["decode"][name],
                       main_path="mixtral-8x7b plan (serving)")
        row["launches_by_path"] = by_path
        result.append(row)
    for row in adamw_rows:   # the serving paths run no optimizer
        result.append(dict(row, launches=train_launches[row["name"]],
                           main_path=main_train,
                           launches_by_path=training_paths(row["name"])))
    from repro_torch.launch.procs import stop_fork_server

    stop_fork_server()
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": result}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
