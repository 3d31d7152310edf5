#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in one process (phases 16-17 add four rank processes of their own), each
printing its seconds; any failure ends the run with a non-zero exit:

1. Device: the card's name and power limit (``nvidia-smi``), then the build
   of every kernel from the checkout's sources, with ``-Xptxas -v``: nine
   ``nvcc`` runs at once (one per plane count and the C interface), then
   one link.
2. Kernels vs plain versions: both CUDA MMA kernels (unscaled, on the
   tensor cores, int32 out; scaled, with the fused dequant epilogue, float32
   out, on the tensor cores at every M) against
   their plain PyTorch versions on the card, bit for bit (``torch.equal``),
   on the reference's kernel sweep, every (planes, signed) variant, and the
   main paths' shapes (the U-Net's conv layers, Yi-6B's and OLMoE-1B-7B's
   decode linears; RWKV6-3B's and Zamba2-7B's at M 1-8 and 5 planes, and
   at M = 4 and 8 planes; the unscaled kernel at Zamba2's ``dt_proj``,
   M 1-8, K 3584, N 112, at 8 and 5 planes; the scaled kernel at phase
   18's decode shapes: Granite-20B's, H2O-Danube3-4B's and DBRX-132B's, M 1,
   4 and 8);
   for the unscaled kernel also its three staging paths (16-byte, 4-byte
   and byte copies, by K and N), operands whose base pointer is 1 or 4
   bytes off alignment, and ragged M on both block heights with every
   (planes, signed); for the scaled kernel, M 1-16 (one and two n8
   fragments) and M 17-512 (three and four n8 fragments, row tiles of 32)
   across K and N that give every staging path, every (planes, signed), the
   K split count forced to 1, 2 and ``max_splits``, views 1 and 4 bytes off
   alignment, and calls captured in a CUDA graph and replayed twice.
3. Forward: the full-width quantized U-Net (80x80x4, base 48, depth 3)
   under uniform 8 planes and a ``from_weights(0.05)`` schedule — the kernel
   path against the plain Horner path, every conv's int32 output equal; and
   the card against the CPU on a small input.
4. Segmentation serving (main path 1): ``SegEngine`` at full width with the
   ``from_weights`` schedule and content-adaptive budget classes serves four
   phantom images through ``run()`` and once through ``serve_stream()``.
   Unscaled-kernel launches must equal 7 per micro-batch; logits must match
   the same engine on the plain path.
5. LM serving (main path 2): Yi-6B at full width (32 layers, random int8
   weights drawn and quantized layer by layer on the card) under the
   ``from_weights(0.05)`` schedule of its ``w_up`` weights serves four
   requests through ``Engine.run``.  Scaled-kernel launches must equal 225
   per decode call (32 x 7 linears + the head); every scaled linear of one
   recorded decode call must equal the plain version bit for bit; that
   call's logits are held against the same call on the plain Horner path.
6. Times (both kernels and their library yardsticks from replays of a
   CUDA graph, so the host's launch rate is not what is timed; the plain
   versions by CUDA events): each kernel at each main-path shape and per
   unit of work (a 4-tile U-Net micro-batch; one LM decode call, the
   recorded call's 225 linears in one graph), at 8 planes and at fewer,
   its plain version, a ``torch._int_mm`` library yardstick (timed only;
   the port never calls it), the card's bound and, for the unscaled
   kernel, the plane-work floor (planes x 2MKN int8 operations at the
   tensor-core peak).  The scaled kernel's per-shape graphs rotate through
   copies of w that together exceed the 50 MB L2, so each call reads w
   from device memory as a decode call does.  Where the toolkit has
   ``cuobjdump``, the count of ``IMMA`` (integer tensor-core) instructions
   in the SASS of every instantiation of both kernels (32 unscaled, 64
   scaled: NF 1-4), none 0; and no ``mma_horner_kernel`` (the CUDA-core
   scaled kernel this design replaced) in the library.
7. Certified tuning: ``tune_unet`` on the calibrated U-Net of phase 3 with
   two phantom calibration images at target 0.05, through the kernel (the
   calibration sweep runs every plane count 1-8) and again through the
   plain Horner path on the card: the two plans must be equal.  The plan
   then serves phase 4's four images through ``engine_from_plan``: 7
   launches per micro-batch, logits and accounting equal to the plain-path
   plan engine's, and each tile's seven int32 conv outputs equal whether
   its image is served alone or among the others (per-tile activation
   scales).  Last, the measured rows of the Table 1 twin
   (``repro_torch.bench.table1``).
8. The serving gateway (main path 3): ``traces/gateway_burst.json`` (35
   requests: 20 interactive and 12 batch LM, 3 seg) replayed open-loop
   through ``Gateway`` (fair, preemptive) with ``LMAdapter`` serving
   minitron_4b at full width and depth (random int8 weights drawn and
   quantized on the card, ``from_weights(0.05)`` schedule, ``impl='kernel'``,
   batch 20: every LM linear is a scaled-kernel launch at M = 20, three
   n8 fragments in one pass) and ``SegAdapter`` serving phase 3's U-Net
   under phase 7's
   plan.  The trace's clock is scaled by the served LM's relation-(2) step
   price over the smoke LM's (``repro_torch.bench.gateway``).  Checks: every
   request completes (LM requests with their token budget, in the
   vocabulary); 225 scaled launches per decode call, 7 unscaled per seg
   micro-batch and none on the LM; every scaled linear of one recorded
   decode call equals the plain version bit for bit; every seg request's
   logits equal its image served alone; the exec events' cycles sum to the
   round clock's worked cycles.  Times the recorded call's 225 linears at
   M = 16, 20, 24, 32, 64 and (the layer linears only: the head's output
   alone is 262 MB) 256 against ``torch._int_mm`` + scale and the bound,
   its plain version at 16 and 20, and each distinct minitron_4b linear at
   M = 20 alone with w cold.

9. Precision-speculative decoding (main path 4) on phase 8's minitron_4b
   (full width and depth, ``impl='kernel'``): ``tune_lm`` at target 0.05 on
   one 16-token prompt (the Horner route, the repair loop capped at 8;
   re-measuring its planes gives its ``measured_rel_err`` to the last bit),
   ``tune_spec`` extending that plan on draft planes 2 and 4 x depth 2 and
   4, then four requests served through ``Gateway`` + ``SpecLMAdapter`` under
   the tuned v3 plan: every request completes, 225 scaled launches per
   decode call (draft calls at the draft budget, the others at the plan's
   planes, every head at 8), one recorded draft call and one verify call
   bit-exact against the plain version on all 225 linears, exec cycles
   equal to the round clock's, the draft/verify/accept events present, and
   the ``EnergyMeter`` armed beside the recording sink (verify work priced
   at the plan's planes, drafts at the draft budget: the paper's FPGA energy
   model) closes its spec account (useful + wasted pJ = draft + verify pJ,
   slot-level cycles = round-level cycles) and its whole ledger.
   The same requests through a greedy ``Engine`` and a ``SpecEngine`` on the
   kernel route: identical streams counted, not gated (one activation scale
   per tensor couples the slots); on the Horner route at 4 layers, gated:
   streams, lengths and live cache rows equal greedy's.  Times the recorded
   draft and verify calls' 225 linears (CUDA-graph replays, w cold) against
   ``torch._int_mm`` + scale and the bound.
10. The serving fabric (main path 5): ``traces/diurnal_smoke.json`` (51
   requests, each with a deadline: 35 interactive LM of 4+8 tokens, 11 batch
   of 24+4, 5 seg of 96x80) replayed open-loop through a ``Fabric`` of two
   phase-8 gateways (``deficit`` routing, work stealing, seed 0), the shards
   sharing phase 8's minitron_4b weights cut to their first
   ``FABRIC_LAYERS`` = 8 of 32 layers (views; its schedule cut alike, the
   clock scale k taken on the cut model) and phase 7's plan; the trace's
   stamps, deadlines and round budget, the interactive SLO's latency
   target and the monitor's burn windows all scaled by phase 8's k.  Armed:
   a ``RecordingSink``, an ``SloMonitor`` (the capacity bench's specs), an
   ``EnergyMeter`` (the served schedules' rates) and a ``CaptureSink``.
   Checks: every request completes (LM with its budget, in the vocabulary);
   the fleet ledger is additive; exec events reconcile with every shard's
   round clock and the fleet ledger; the monitor's misses and attribution
   equal the span-derived ones and ``stats()``'s; the meter's pJ ledger
   holds to the picojoule; every shard's ``stats()`` carries ``slo`` and
   ``energy`` blocks; the captured trace's requests equal the replayed
   trace's; 57 scaled launches per decode call and 7 unscaled per seg
   micro-batch; each shard's first decode-step call bit-exact against the
   plain version on all 57 linears; every seg request's logits equal its
   image served alone.  Prints the replay's host wall, decode calls and
   micro-batches per shard, routes and steals, per-class modeled
   latencies and misses, and metered and analytic GOPS/W (the FPGA model).
11. MoE serving (main path 6): OLMoE-1B-7B at full width and depth (16
   layers, 64 experts top-8; random weights from seed 0 drawn layer by layer
   on the card, the attention linears and the head quantized to int8, the
   router and the experts bf16) under the ``lm_schedule_from_params(0.05)``
   schedule of its ``wq`` weights serves four requests through
   ``Engine.run`` (batch 4, ``impl='kernel'``), after phase 8's weights are
   released.  Checks: every request completes in the vocabulary; 65 scaled
   launches per decode call (16 x 4 attention linears + the head) and no
   unscaled one; every scaled linear of one recorded decode call bit-exact
   against the plain version; that call's logits within ``LM_LOGIT_REL`` of
   the Horner route.  The MoE block on the card against the CPU, for the
   recorded call's last block (T = 4) and for layer 0 on T = 64 tokens
   from a numpy seed (cap 10 of 512 assignments: at least one drop): given
   the card's router logits, expert ids, positions, kept mask, token order,
   ``cap`` and the dispatch buffer equal the CPU's exactly, and the output is
   within ``MOE_REL`` of the CPU's experts and combine on that routing (the
   served block's output also equals ``moe_ffn`` on its input bit for bit).
   Times: the decode call's 16 MoE blocks as one CUDA graph against their
   bytes bound (every expert read: about 12.9 GB), the recorded call's 65
   linears, and the scaled kernel at OLMoE's decode shapes (M = 4; (2048,
   2048) and (2048, 50304), w cold) against ``torch._int_mm`` + scale and
   the bound.  Then the same weights served again at batch
   ``MOE_DROP_BATCH`` (20 requests of one prompt token in 20 slots): a
   decode call's 20 tokens
   meet cap 4 of 160 assignments per block.  The recorded call's 65 scaled
   linears bit-exact (its logits against the Horner route printed, not
   gated at this batch), and each of its 16 MoE blocks held as above:
   output equal to ``moe_ffn`` on its input, routing and dispatch buffer
   card = CPU, output within ``MOE_REL``; at least one assignment dropped
   over the 16, the drops per layer printed.
12. Recurrent-state serving (main path 7): RWKV6-3B at full width and depth
   (32 layers, d 2560, 40 heads of 64, d_ff 8960, vocab 65,536; random
   weights from seed 0 drawn and quantized to int8 layer by layer on the
   card), ``QuantConfig(mode="mma_int8", impl="kernel", planes=5)`` (the
   global knob: plane schedules are refused for this family), after phase
   11's weights are released: phase 5's four requests through
   ``Engine.run`` (batch 4, ``max_seq`` 64).  Checks: every request
   completes in the vocabulary; 257 scaled launches per decode call (32 x 8
   linears + the head; ``mix_lora_a`` takes the Horner route, uncounted)
   and no unscaled one; every kernel call of one recorded decode call
   bit-exact against its plain version; that call's logits against the
   same call on the Horner route from the same state, at 5 planes printed
   (quirk 1 at 5 planes: one activation scale per tensor against one per
   row, a gap that grows with depth past ``LM_LOGIT_REL`` on RWKV6) and at
   8 planes within ``LM_LOGIT_REL``; 32 int8 ``mix_lora_a`` calls per
   decode call on the Horner route (no kernel), counted; the call's last
   block repeated on the card bit for bit, and on the CPU from the card's
   inputs within ``RECURRENT_BLOCK_REL`` (output and new state).  Times:
   the recorded call's 257 kernel calls as one CUDA graph (w cold) against
   ``torch._int_mm`` + scale and the bytes bound, each distinct linear at
   M = 4 with w cold, and the host wall per decode call.
13. Hybrid serving (main path 8): Zamba2-7B at full width and depth (81
   Mamba2 layers in 13 groups of 6 and a tail of 3, d 3584, ssm_state 64,
   one weight-shared attention block on [h ; emb], 7168 wide, used 13
   times; vocab 32,000), the same traffic and checks, with 309 scaled
   launches per decode call (81 x z/xbc/out_proj, 13 x the shared block's
   wq/wk/wv/wo/proj, the head) and 81 unscaled (``dt_proj``, 3584 x 112,
   bf16, through ``mma_linear`` with per-row scales), every one of the
   recorded call's 390 kernel calls bit-exact; the block held card vs CPU
   is the last Mamba2 layer (output, conv window, SSM state).  Times as
   phase 12, plus the recorded call's 81 unscaled calls as one graph
   against ``torch._int_mm`` (x padded to 32 rows) and their bound.
14. Encoder-decoder serving (main path 9): Whisper-large-v3 at full width
   and depth (32 encoder and 32 decoder layers, d 1280, 20 heads, d_ff
   5120, vocab 51,866, 1500 frames; random weights from seed 0 drawn and
   quantized to int8 layer by layer on the card: every linear),
   ``QuantConfig(mode="mma_int8", impl="kernel", planes=5)`` (the global
   knob), after phase 13's weights are released: the encoder over four rows
   of numpy frames (seed 0), an ``Engine`` (batch 4, ``max_seq`` 64) that
   projects the cross K/V once from that memory, and phase 5's four requests
   through ``Engine.run``.  Checks: 192 scaled launches in the encoder and
   64 in the cross K/V pass, all at M = 6000; 256 per decode call (self
   attention q/k/v/o, cross attention q/o, the MLP; the head is the tied
   embedding, a bf16 product); none unscaled; every request completes in
   the vocabulary; bit for bit against the plain version: every scaled
   linear of one recorded decode call, encoder layer 0's six at M = 6000
   (one activation scale over all 6000 rows) and layer 0's cross k/v
   projections; the recorded call's logits against the same call on the
   Horner route (same cache, same cross K/V) at 5 planes printed and at 8
   within ``LM_LOGIT_REL``; the last decoder block repeated on the card bit
   for bit and on the CPU within ``RECURRENT_BLOCK_REL``, and encoder block
   0 on one row of 1500 frames card against CPU within it.  Times (CUDA
   graphs, w cold): the recorded call's 256 linears, each shape at M = 4
   and at M = 6000, the encoder's 192 and the cross K/V pass's 64 linears as
   one graph each, against ``torch._int_mm`` + scale, the bound and the
   plane-work floor; the encoder's and cross K/V pass's host walls, the
   host wall per decode call and the card's idle share over a second
   ``Engine.run`` under ``torch.profiler``.
15. Quantization-aware training (main path 10): Yi-6B at full width with its
   depth cut to 8 of 32 layers (1.908 G params, random bf16 weights from
   seed 0 on the card), ``QuantConfig(mode="mma_int8", impl="kernel",
   planes=8)``, Yi-6B's own ``microbatches=4`` and ``remat="full"``, TF32
   off; the data pipeline's synthetic batches (seed 0) of 8 x 512 tokens,
   so every unscaled-kernel call has M = 1024 rows; after phase 14's
   weights are released.  First one microbatch: every one of its 113
   unscaled calls bit-exact against the plain version, and its loss and
   every gradient leaf bit-equal to the same microbatch on the Horner
   route.  Then ``trainer.train`` for 2 steps, its one checkpoint at step
   2 (into ``chip_scratch/train``), and 2 more steps stepped as the
   trainer steps them without its final save: 452 unscaled launches per
   step (per microbatch 56 block linears, 56 again in remat's recompute,
   the head), 0 scaled, finite losses, the master params moved; peak
   memory printed.  Then the restart: the run killed after its step-2
   checkpoint (that step directory, ``LATEST`` naming it),
   ``trainer.resume``, the 2 more steps again, every final param
   bit-equal to the uninterrupted run's; beside it,
   ``python -m repro_torch.launch.train --arch yi_6b --smoke --steps 4
   --ckpt-every 2 --resume`` once as a subprocess (exit 0).  Then one more
   step under ``torch.profiler`` (host wall, device busy, idle share, the
   unscaled kernel's and the stock matmuls' device time) and the optimizer
   update alone.
   Times (CUDA graphs): the unscaled kernel at each training shape against
   ``torch._int_mm``, the bound and the plane-work floor, and the
   straight-through estimator's float32 products (forward ``x @ w``, the
   backward's ``g @ w.T`` and ``x.T @ g``) at the same shapes, each
   summed over a step's calls.
16. Parallel training (main path 11): Yi-6B at full width with its depth cut
   to 2 of 32 layers (0.870 G params, 12.2 GB of bf16 params and float32
   master, m and v), phase 15's settings (``mma_int8`` on the kernel, 8
   planes, 4 microbatches, full remat, TF32 off, 8 x 512 tokens per step).
   First one unsharded step in this process, the yardstick (its microbatch
   0's int32 products and its new params kept on the host, its weights
   freed).  Then 4 ranks in 4 processes on the one card
   (``torch.multiprocessing`` spawn, gloo: NCCL refuses two ranks on one
   device; the port's collectives stage CUDA tensors through pinned host
   memory), mesh (data 2, model 2), each loading phase 1's library, each
   printing its state bytes (together under ``PAR_STATE_LIMIT``).  Gates:
   microbatch 0's unscaled calls on each rank bit-exact against the plain
   version at the sharded shapes, and its int32 products (column-parallel:
   the rank's columns; row-parallel: after the all-reduce) equal to the
   yardstick's bit for bit; loss and grad_norm within ``PAR_LOSS_REL`` and
   ``PAR_NORM_REL``, the gathered params within one bf16 ulp of the
   yardstick's; ``par_launches`` unscaled launches per step per rank (116:
   every linear split, one call each); a third step with rank 0's under
   ``torch.profiler`` (host wall, device busy, idle share, the share in
   gloo); the state gathered and saved under
   (2, 2), restored under (1, 4) bit-equal and one step from it against the
   (2, 2) run's second step; GPipe PP 2 x DP 2 on Yi-6B at ``PP_LAYERS`` = 4
   layers (two per stage), the loss and its gradient: the loss within
   ``PAR_LOSS_REL`` of the port's unsharded ``loss_fn`` on the same params
   and batch (each row alone, as the stages meet them:
   ``pipeline_yardstick``), every leaf's gradient (the stage's two layers,
   the replicated embed, head and ln_f) within ``PP_GRAD_REL`` of the
   largest of the unsharded gradient's matching slice, both stages' block
   gradients non-zero, the collective-permutes and all-reduces equal to the
   dry run's count (``launch.dryrun_pp.count``), host wall and gloo share
   printed; ``compressed_psum_shardmap`` over the two data
   ranks once on one microbatch's gradients (within the int8 step); one
   OLMoE-1B-7B MoE layer at full width through ``moe_ffn_ep`` over model = 4
   (16 experts per rank, T = ``MOE_T``, dropless): routing card = CPU,
   output within ``MOE_REL`` of ``moe_ffn``.  Prints the host wall per
   sharded step, the collectives by kind per step (gloo over host memory,
   not NVLink: no claim is made from them) and their share of the step, and
   the unscaled kernel graph-timed at each sharded shape against
   ``torch._int_mm`` and the bound.  ``moe_ffn_ep`` also takes a gradient
   (of its output against random weights, for x and the rank's w_gate)
   against the plain version's, within ``MOE_REL``.
   (a) Before the ranks spawn, the dry run's own functions
   (``dry_prediction``: ``specs.sharded_bytes`` of the state shardings and
   the counting mode of the collectives on meta tensors over the
   shape-only (data 2, model 2) mesh) predict each rank's state bytes and
   one step's collectives; gated exactly against every rank's state bytes
   and live ``mesh.stats`` (Yi-6B's step 2, OLMoE's step).  The roofline
   bound of the step (H100 SXM data sheet's peaks) is printed beside the
   measured wall, not gated.
   (b) OLMoE-1B-7B at full width, 2 of 16 layers (1.045 G params, 14.63 GB
   of state), phase 15's settings with its config's 2 microbatches, on the
   same 4 ranks and mesh, experts over 'model' (32 per rank): one
   unsharded step in the parent first (the yardstick, ``yard_moe.pt``),
   then one sharded step on each rank: microbatch 0's 17 unscaled calls
   bit-exact against the plain version, its 9 int32 products equal to the
   yardstick's, loss and grad_norm within ``PAR_LOSS_REL`` /
   ``PAR_NORM_REL``, ``par_launches`` (34) unscaled launches per step per
   rank, state bytes and collectives equal to the dry run's; prints the
   host wall per step, the collectives by kind and their share, and the
   kernel graph-timed at OLMoE's sharded shapes against ``torch._int_mm``
   and the bound.  Then the same model unquantized, where the reference's
   ``moe_ffn_ep`` takes its expert-parallel body: one unsharded step in the
   parent whose MoE routes the (data, model) slabs alone (``moe_ep_plain``)
   and one sharded step on each rank (``sharded_lm._moe_ep``,
   ``moe.ep_slab`` with a gradient, 512-token slabs): loss and grad_norm
   within ``PAR_LOSS_REL`` / ``PAR_NORM_REL``, all-to-alls and no kernel
   launch, state bytes and collectives equal to the dry run's.
   (c) The ssm, hybrid, encdec and vlm families at full width on the same
   ranks (``PAR_FAMILIES``): RWKV6-3B at 2 of 32 layers, Zamba2-7B at 7
   of 81 (a group of 6 and a tail layer), Whisper-large-v3 at 2 encoder
   and 2 decoder layers over 1500 frames, on the (data 2, model 2) mesh;
   InternVL2-76B at 1 of 80 layers with its 256 patch embeddings before
   each sequence (``sharded_lm``'s vlm loss), on (data 1, model 4)
   (``par_mesh_shape``: its replicated state would not fit at model 2),
   8 sequences in its 8 microbatches; phase 15's settings with each
   config's microbatches.  For each, one unsharded step in the parent (the
   yardstick, ``yard_{arch}.pt``), the dry run's prediction, then one
   sharded step on each rank (``sharded_rwkv6``, ``sharded_zamba2``,
   ``sharded_whisper``, ``sharded_lm``; the ranks draw the whole tree one
   at a time): microbatch 0's unscaled calls (33 / 62 / 64 / 15)
   bit-exact against the plain version, its int32 products (17 / 34 / 32
   / 8) equal to the yardstick's, loss and grad_norm within
   ``PAR_LOSS_REL`` / ``PAR_NORM_REL``, the launches per step per rank (66
   / 248 / 128 / 120) and per kernel shape equal to ``par_shapes``'
   layout, state bytes and collectives equal to the dry run's; prints the
   host wall per step, the collectives by kind and their share, and the
   kernel graph-timed at each of the model's shapes against
   ``torch._int_mm`` and the bound.
17. Sharded serving (main path 12), in phase 16's four rank processes
   after their training state is freed: every LM family through
   ``serve_step.make_prefill`` / ``make_decode`` with the (data 2, model 2)
   mesh, the kernel route at 8 planes, int8 weights and KV cache
   (``SERVE_MODELS``): Yi-6B at full width and depth (32 layers, random
   weights from seed 0 quantized on the card, about 3 GB of int8 weights
   per rank), 8 prompts of ``SERVE_PROMPT`` tokens through one writing
   prefill and 8 greedy decode steps against a cache of ``SERVE_MAX_SEQ``
   (256 positions per rank); OLMoE-1B-7B, RWKV6-3B, Zamba2-7B and
   Whisper-large-v3 at phase 16's depth cuts, 4 rows, one writing prefill
   (Zamba2: the stateless prefill) and 4 greedy steps (Whisper's encoder
   and cross K/V first, sharded, over 4 x 1500 frames).  Then
   (``SERVE_MORE``): InternVL2-76B at 2 of 80 layers, a prefill of its 256
   patch embeddings and the prompt (``sharded_lm.serve_prefill`` with
   ``extras["patches"]``), then the writing prefill and 4 steps; Yi-6B at
   2 layers in the 2-D mode (``serve_step.TWO_D_BYTES`` lowered to 0; each
   rank holds a quarter of the weights and gathers them over 'data' every
   call); OLMoE-1B-7B at 2 layers unquantized through ``moe_ffn_ep``'s
   body (the writing prefill's (data, model) slabs, at decode each data
   rank's rows whole on every model rank; every slab's routing held
   against the plain route on the same float32 logits, ``RouteRecorder``;
   the yardstick routes as ``moe_ep_plain``, each rank's slab its slab
   there (layer 0's router logits within ``SLAB_ROUTER_REL``), the tokens
   routed otherwise than the yardstick within ``ROUTE_DIFFER_SHARE``, and
   the logits held against the yardstick run again with every slab routed
   as the ranks routed it, ``ep_replay``); the same at ``SERVE_DROP_ROWS``
   = 40 rows (a prompt of ``SERVE_DROP_PROMPT``), so that each data rank's
   decode slab of 20 tokens meets cap 4 and drops (at least one drop at
   decode, per rank and layer printed); OLMoE-1B-7B on the kernel
   route with a writing prefill of ``SERVE_LONG_PROMPT`` tokens into a
   cache of ``SERVE_LONG_SEQ`` (two 1024-key attention chunks); Zamba2-7B
   at 13 of 81 layers (two groups of 6 and a tail layer) and 2 rows, where
   ``cache_shardings`` splits the stacked group dim over 'data' and the
   step reshards the states to rows around each call (the layout gated,
   and the decode step's all-gathers above the same model's at 4 rows).
   Before the ranks
   spawn, each model's unsharded steps in this process (the yardstick:
   logits, tokens, the first layer's int32 products) and the dry run's
   prediction (``serve_prediction``: state bytes, one prefill's and one
   decode step's collectives, counted on meta tensors).  Gates: (a) each
   rank's params, cache and extras bytes and its prefill's and decode
   step's collectives equal the prediction; (b) launches per decode step
   per rank equal ``serve_launches`` (Yi-6B: 161 scaled + 64 unscaled);
   (c) every kernel call of one recorded decode step bit-exact against
   its plain version; (d) the prefill's and decode step 0's first-layer
   int32 products equal the yardstick's; (e) every call's logits within
   ``SERVE_LOGIT_REL`` of the yardstick's, greedy tokens equal up to the
   first near tie.  Prints the host wall per prefill and decode step per
   rank, the collectives and their share, the scaled kernel at Yi-6B's
   sharded decode shapes (w cold) against ``torch._int_mm`` + scale and
   the bound, and the unscaled kernel at its row-parallel linears (wo, K
   2048, and w_down, K 5504, N 4096) at a decode step's M = 4 and the
   writing prefill's M = 1024 (w cold) against ``torch._int_mm``, the bound
   and the plane-work floor, and summed over the 64 calls of a step.
18. The last LM configs and the long_500k cell (main path 13), after phases
   16-17's ranks have ended.  (a) Granite-20B at full width and depth (52
   layers, d 6144, 48 heads, one KV head, d_ff 24,576, the GELU MLP with
   biases, vocab 49,152; every linear int8: quantized at a min_dim of 128,
   so the MQA's 6144 x 128 wk/wv too) and (b) H2O-Danube3-4B at full width
   and depth (24 layers, d 3840, head_dim 120, 8 KV heads, window 4,096)
   serve phase 5's traffic through ``Engine.run`` with phase 5's checks
   (``lm_serving``): 313 and 169 scaled launches per decode call, the
   recorded call bit-exact, its logits within ``LM_LOGIT_REL`` of the
   Horner route; times as phase 6 (each decode shape with w cold, the
   recorded call as one graph, ``torch._int_mm`` + scale, the bound).  (c)
   DBRX-132B at full width, ``DBRX_LAYERS`` = 8 of its 40 layers (16
   experts top-4 of d_ff 10,752: 6.342 GB of bf16 experts per layer; the
   attention and the head of N = 100,352 int8; ``moe.ep`` falls back to
   ``moe_ffn`` on one card under ``mma_int8``, as in the reference), served
   as phase 11 serves OLMoE-1B-7B: 33 scaled launches per decode call, the
   recorded call bit-exact and its logits vs the Horner route, its last
   MoE block card vs CPU (``moe_card_vs_cpu``: routing exact, output within
   ``MOE_REL``), the decode call's 8 MoE blocks graph-timed against their
   bytes bound (50.7 GB), the times of (a).  (d) The long_500k cell on
   Danube at full depth: ``serve_step.init_serving_cache(cfg, 1, 524288)``
   (48.32 GB of bf16 K/V), a writing prefill of a ``LONG_PROMPT`` = 4,096
   token prompt through ``serve_step.make_decode``'s step at 524,288 - 4,096
   - 16 (the chunked attention walks the chunks its window reaches), then
   ``LONG_STEPS`` = 16 greedy decode steps, the last at position 524,287:
   169 scaled launches per call; the last step's linears bit-exact, the step
   repeated at its index bit-equal, its logits within ``LM_LOGIT_REL`` of
   the Horner route, and, after every cache position its query masks (k <=
   524,287 - 4,096) is overwritten with seeded noise in place, its logits
   bit-equal again.  (e) The long_500k cell on Zamba2-7B at
   ``LONG_ZAMBA_LAYERS`` = 18 of 81 layers (3 of 13 shared-attention
   groups, each K/V cache (1, 524,288, 32, 224) bf16: 45.1 GB), 5 planes,
   its whole state drawn from a seed (``seeded_state``), ``LONG_ZAMBA_STEPS``
   = 8 decode steps ending at 524,287: 70 scaled and 18 unscaled
   (``dt_proj``) launches per step, the last step's kernel calls bit-exact,
   and the last group's shared attention over all 524,288 keys on the CPU
   (q, K and V copied to the host) within ``LONG_ATTN_REL`` of the card's.
   (d) and (e) print the host wall per step and the device time of a step's
   attention calls against the cache's bytes bound.

The lines before the last three print each kernel's detail (per shape and
per path); the line before the last is a JSON object naming every kernel
with its launches on its main path and its times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import typing
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
TRACE = SRC.parent / "traces" / "gateway_burst.json"  # the gateway's canonical trace
DIURNAL = SRC.parent / "traces" / "diurnal_smoke.json"  # the fabric's: every request has a deadline

# NVIDIA H100 SXM data sheet, dense: HBM rate and the int8 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

TILES_PER_BATCH = 4  # the engine's micro-batch
LM_BATCH, LM_MAX_SEQ, LM_MAX_NEW = 4, 64, 4  # the LM engine's slots and budgets
SWEEP = [(4, 32, 8), (32, 128, 32), (128, 512, 128), (37, 100, 65),
         (1, 7, 3), (256, 1024, 256), (64, 300, 90)]
# the unscaled kernel's staging: K and N that give each operand 16-byte,
# 4-byte or byte copies; ragged M on both block heights
STAGING_K = (7, 36, 129, 300, 5184)
STAGING_N = (3, 48, 70, 192)
RAGGED_M = (1, 15, 16, 17, 33)
SERVED_PLANES = (8, 5, 1)  # the U-Net path's budgets: uniform, class 0, class 6
SCALED_SWEEP = [(16, 96, 40), (64, 256, 128), (3, 50, 7)]  # the reference's epilogue test
# the scaled kernel at decode shapes: M on one and two n8 fragments, K and N
# that give 16-byte, 4-byte and byte staging, one or many K tiles
NARROW_M = (1, 3, 4, 8, 9, 15, 16)
NARROW_K = (7, 129, 4096, 11008)
NARROW_N = (3, 70, 512, 4096)
# the scaled kernel above 16 rows: three and four n8 fragments in one pass,
# row tiles of 32 (ragged at 33 and 100); minitron_4b's K and N among them
WIDE_M = (17, 20, 24, 25, 32, 33, 64, 100, 512)
WIDE_K = (7, 129, 3072, 9216)
WIDE_N = (3, 70, 1024, 4096)
GATEWAY_M = (16, 20, 24, 32, 64, 256)  # phase 8's decode-call sweep
# phase 9: tune_lm on one 16-token prompt, the repair loop capped; tune_spec
# on the reference bench's trimmed grid; four 4-token requests served
SPEC_TARGET, SPEC_MAX_REPAIR, SPEC_TUNE_TOKENS = 0.05, 8, 16
SPEC_PLANE_GRID, SPEC_K_GRID = (2, 4), (2, 4)
SPEC_BATCH, SPEC_MAX_SEQ, SPEC_MAX_NEW, SPEC_PROMPT = 4, 48, 8, 4
SPEC_HORNER_LAYERS = 4  # the plain Horner route's identity gate runs at this depth
HEAD_OUT_M = 64  # above this many rows the sweep drops the head (256 rows: 262 MB out)
L2_BYTES = 50 * 2**20  # the H100's L2: per-shape timings read more w than this

# Logits of the kernel path and the plain path go through the same float
# head on bitwise-equal conv outputs: equal up to the card's reduction order.
LOGIT_ATOL = 1e-5
# The card against the CPU: same integers, float head summed in another order.
CPU_LOGIT_ATOL = 1e-4
# Scaled kernel vs the Horner path's epilogue on the same int32 product:
# (acc * xs) * ws against acc * (xs * ws), two roundings each — a few ulp.
EPILOGUE_RTOL = 5e-7
# LM logits, kernel path vs Horner path, relative to the largest logit.  The
# kernel path quantizes activations with one scale per tensor, the Horner
# path with one per batch row (as in the reference), so the two datapaths
# run on different int8 grids and truncate different digits: on Yi-shaped
# CPU models of 8 and 16 layers at 5 planes the gap was 0.31 and 0.36 of
# the largest logit.  0.6 still fails a path that has lost its signal (two
# unrelated logit vectors differ by more than 1).
LM_LOGIT_REL = 0.6
# The MoE block on the card against the CPU, relative to the block's largest
# output.  The CPU dispatches on the card's router logits, so the routing is
# the same (gated exactly); what differs is the bf16 expert products'
# summation order on the two devices and one bf16 rounding of each product.
MOE_REL = 1e-2
MOE_T = 64  # phase 11's wide MoE check: T = 64 tokens, cap 10 of 512 assignments
# Phase 11 serves OLMoE-1B-7B again at this batch: a decode call's 20 tokens
# meet cap max(int(20 * 8 / 64 * 1.25), 4) = 4 of 160 assignments per block,
# the batch from which its capacity drops (quirk 3: a token's drops depend
# on its batch mates)
MOE_DROP_BATCH, MOE_DROP_CAP = 20, 4
BF16_OPS_PER_S = 989e12  # the H100 SXM's dense bf16 tensor-core peak
# Phases 12-13 (the recurrent families) serve at the global plane knob:
# plane schedules are refused for them, as in the reference.
RECURRENT_PLANES = 5
# One recurrent block on the card against the CPU, relative to the largest
# output (or state) element.  The integer products are the same on both;
# a float op between them (an RMSNorm mean, an exp, a float32 sum of the
# recurrence) that rounds the other way on the card can move an int8 level
# of the next linear's per-tensor grid, and at 5 planes a truncated level
# weighs 2**3 of a full one (the bound test_torch_gpu.py's LM_LOGIT_REL
# holds a small LM's logits to).
RECURRENT_BLOCK_REL = 5e-2
# Phase 14 (Whisper, the encdec family) serves at the global plane knob too:
# plane schedules are refused for it, as in the reference.
WHISPER_PLANES = 5
# Phase 15 trains Yi-6B at full width with its depth cut to 8 of 32 layers:
# 1.92 G params, 26.7 GB of bf16 params and float32 master, m and v (all 32
# layers would need ~121 GB of state alone); 8 sequences of 512 tokens in
# Yi-6B's 4 microbatches, so every kernel call has 2 x 512 rows.  The run
# writes one checkpoint of that state (24.88 GiB), the one its restart
# reads: with phase 16's gathered one that is most of what the smoke writes
# to a disk that takes 45 GiB of writes per run, so a second could not be.
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH = 8, 512, 8
TRAIN_STEPS, TRAIN_CKPT_EVERY = 4, 2
F32_OPS_PER_S = 67e12  # the H100 SXM's float32 peak outside the tensor cores
# Phase 16 trains Yi-6B at full width, 2 of 32 layers (0.870 G params, 12.2 GB
# of state), sharded over 4 ranks on the one card: mesh (data 2, model 2).
PAR_LAYERS, PAR_WORLD, PAR_JOIN_S = 2, 4, 600
PAR_STATE_LIMIT = 60e9  # bytes of state of the four ranks together
# The sharded step against the unsharded one.  The int32 products are equal
# (gated bit for bit); the float paths differ by a row-parallel linear's
# float32 all-reduce and the vocab-parallel logsumexp's two partial sums,
# and a bf16 rounding that lands the other way moves one int8 level of the
# next linear.  Params after one step: each within two lr-sized steps and
# one bf16 ulp (AdamW's first step moves a param by about lr whatever its
# gradient's size, so a gradient near 0 whose sign the rounding flips moves
# it the other way), and at most PAR_PARAM_DIFFER of them differing at all.
PAR_LOSS_REL, PAR_NORM_REL, PAR_PARAM_DIFFER = 1e-3, 5e-3, 0.01
# GPipe PP 2 x DP 2 on the same ranks: Yi-6B at full width, PP_LAYERS of 32
# layers (two per stage), the loss and its gradient.  Each leaf's gradient
# (a stage's blocks, the replicated embed, head and ln_f) against the
# unsharded loss_fn's matching slice, relative to its largest element: the
# bound tests/test_torch_distributed.py holds the pipeline's gradients to
# and the reference holds its pipeline's loss to (tests/test_pipeline.py);
# autograd sums a leaf's bf16 gradient over the ticks in bf16.
PP_LAYERS, PP_GRAD_REL = 4, 2e-2
# Phase 16's second model: OLMoE-1B-7B at full width, 2 of 16 layers (1.045 G
# params, 14.6 GB of state), on the same 4 ranks and mesh: experts over
# 'model' (32 per rank).  Under mma_int8 the reference's moe_ffn_ep falls
# back to moe_ffn (global routing, a bf16 router that no quant setting
# reaches), which the unsharded yardstick runs too: the two route alike.
PAR_MOE_LAYERS = 2
# With quantization off the reference's moe_ffn_ep takes its expert-parallel
# body instead (each (data, model) slab routed alone on float32 router
# logits, two all-to-alls over 'model'): one more OLMoE step on the ranks
# runs that path, against an unsharded step that routes the same slabs
# alone (``moe_ep_plain``).
# Phase 16(c): the ssm, hybrid, encdec and vlm families at full width on the
# same ranks and mesh, depth cut: RWKV6-3B 2 of 32 layers, Zamba2-7B 7 of 81
# (one group of 6 and one tail layer, so both paths run), Whisper-large-v3 2
# encoder and 2 decoder layers over 1500 frames, InternVL2-76B 1 of 80 layers
# (2.96 G params: 1.05 G each of embedding and head, 0.86 G in the layer)
# with its 256 patch embeddings before each sequence.
PAR_FAMILIES = (("internvl2_76b", "InternVL2-76B", dict(n_layers=1)),
                ("rwkv6_3b", "RWKV6-3B", dict(n_layers=2)),
                ("zamba2_7b", "Zamba2-7B", dict(n_layers=7)),
                ("whisper_large_v3", "Whisper-large-v3", dict(n_layers=2, enc_layers=2)))
# Phase 17 serves every LM family sharded on phase 16's 4 ranks, mesh (data
# 2, model 2), the kernel route with int8 weights and KV cache at 8 planes
# (quirk 1: the LM phases gate at 8): (arch, label, depth, rows, decode
# steps).  Yi-6B at full width and depth, 8 prompts of SERVE_PROMPT tokens
# through one writing prefill and 8 greedy decode steps against a cache of
# SERVE_MAX_SEQ (each rank holds half the positions); the others at phase
# 16's depth cuts, 4 rows, one writing prefill (Zamba2: the stateless
# prefill; Mamba2 decodes one token per call) and 4 greedy steps.
SERVE_MAX_SEQ, SERVE_PROMPT = 512, 256
SERVE_MODELS = (("yi_6b", "Yi-6B", {}, 8, 8),
                ("olmoe_1b_7b", "OLMoE-1B-7B", dict(n_layers=2), 4, 4),
                ("rwkv6_3b", "RWKV6-3B", dict(n_layers=2), 4, 4),
                ("zamba2_7b", "Zamba2-7B", dict(n_layers=7), 4, 4),
                ("whisper_large_v3", "Whisper-large-v3", dict(n_layers=2, enc_layers=2), 4, 4))
# The sharded steps' logits against the unsharded yardstick's on the same
# tokens (the ranks are fed the yardstick's greedy tokens), relative to the
# largest.  On the CPU the port's sharded steps equal its unsharded ones bit
# for bit; on the card cuBLAS sums the unsharded attention's one pass over
# the cache in another order than the ranks' partial sums and their
# all-reduce, a bf16 rounding of the attention's output flips, and that
# moves an int8 level of wo's input (OLMoE-1B-7B's writing prefill: one
# row of one level), whose effect grows through the layers: Yi-6B's 32
# layers parted by 0.0546 of the largest logit on an H100 (PERF.md §6).
# test_torch_gpu.py holds the card against the CPU at 0.05 on 2 layers.
# The ranks' own greedy tokens must equal the yardstick's, or part where
# the yardstick's margin between the two is within twice the bound.
SERVE_LOGIT_REL = 0.1
# The unquantized moe_ffn_ep part: the ranks' float sums can flip a router
# near tie, and a flip moves the capacity's drops of the expert it enters.
# Its logits are held at SERVE_LOGIT_REL against the yardstick run again
# with every slab routed as the ranks routed it (``ep_replay``), and the
# tokens routed otherwise than the yardstick's own routing, summed over the
# layers, at most ROUTE_DIFFER_SHARE of the slab's tokens times the layers
# (20 of 512 at most seen on an H100).  Each rank's slab is the yardstick's
# at its place in the (data, model) partition: layer 0's router logits
# within SLAB_ROUTER_REL of the largest (other tokens part by about the
# largest).
ROUTE_DIFFER_SHARE, SLAB_ROUTER_REL = 0.1, 0.1
# each family's quantized products in its first layer: a transformer
# block's 7 (MoE: attention's 4), RWKV6's mix_lora_a, time mix 5 and channel
# mix 3, a Mamba2 layer's 4, Whisper's decoder block 8 (its cross K/V
# precomputed); and of them the ones before the first attention combine,
# held bit for bit against the yardstick's (the rest is reported): q, k, v
# (the recurrent layers have no attention)
SERVE_LAYER0 = {"dense": 7, "moe": 4, "vlm": 7, "ssm": 9, "hybrid": 4, "encdec": 8}
SERVE_PRE_ATTENTION = {"dense": 3, "moe": 3, "vlm": 3, "ssm": 9, "hybrid": 4, "encdec": 3}
# Phase 17's further parts, on the same ranks and mesh: (tag, arch, label,
# depth, rows, decode steps, options).  InternVL2-76B at 2 of 80 layers: a
# prefill with its 256 patch embeddings before the prompt, then the writing
# prefill and the decode steps.  Yi-6B at 2 of 32 layers in the 2-D serving
# mode (``serve_step.TWO_D_BYTES`` lowered to 0 in the ranks and the
# prediction: no full-width model that fits one card passes 10 GiB of
# TP-split weights per chip at model 2, so the mode would not switch on by
# itself).  OLMoE-1B-7B at 2 of 16 layers unquantized (the ``none`` route,
# ``moe.ep`` on), where the reference takes ``moe_ffn_ep``'s body: the
# writing prefill's (data, model) slabs, and at decode each data rank's
# rows whole on every model rank.  OLMoE-1B-7B on the kernel route with a
# writing prefill of ``SERVE_LONG_PROMPT`` tokens into a cache of
# ``SERVE_LONG_SEQ``: two attention chunks of 1024 keys, one on each model
# rank, so the sharded attention takes the unsharded pass's running max.
SERVE_LONG_SEQ, SERVE_LONG_PROMPT = 2048, 1104
# OLMoE-1B-7B unquantized through moe_ffn_ep at SERVE_DROP_ROWS rows: a data
# rank's decode slab is its 20 rows whole on every model rank, cap 4 of 160
# assignments (MOE_DROP_CAP), so the decode steps drop; a short prompt
# (SERVE_DROP_PROMPT into SERVE_DROP_SEQ positions) keeps its prefill small.
# Zamba2-7B at 13 of 81 layers (two groups of 6 and one tail layer) and 2
# rows: cache_shardings' rule marks the first dim equal to the batch, the
# stacked group dim, so the group states split over 'data' and
# sharded_lm.reshard gathers them to rows around each call.
SERVE_DROP_ROWS, SERVE_DROP_PROMPT, SERVE_DROP_SEQ = 40, 16, 64
SERVE_MORE = (("internvl2_76b", "internvl2_76b", "InternVL2-76B", dict(n_layers=2), 4, 4, {}),
              ("yi_6b_2d", "yi_6b", "Yi-6B 2-D mode", dict(n_layers=2), 4, 4, dict(two_d=True)),
              ("olmoe_1b_7b_ep", "olmoe_1b_7b", "OLMoE-1B-7B unquantized (moe_ffn_ep)",
               dict(n_layers=2), 4, 4, dict(quant="none")),
              ("olmoe_1b_7b_ep_drops", "olmoe_1b_7b",
               f"OLMoE-1B-7B unquantized (moe_ffn_ep) at {SERVE_DROP_ROWS} rows",
               dict(n_layers=2), SERVE_DROP_ROWS, 4,
               dict(quant="none", drops=True, prompt=SERVE_DROP_PROMPT, max_seq=SERVE_DROP_SEQ)),
              ("olmoe_1b_7b_long", "olmoe_1b_7b", "OLMoE-1B-7B long prefill", dict(n_layers=2),
               4, 4, dict(max_seq=SERVE_LONG_SEQ, prompt=SERVE_LONG_PROMPT)),
              ("zamba2_7b_b2", "zamba2_7b", "Zamba2-7B at 2 rows (groups over data)",
               dict(n_layers=13), 2, 4, dict(groups_over_data=True)))
# Phase 18: the last three LM configs at full width, phase 5's traffic each:
# Granite-20B (MQA, the GELU MLP with biases) and H2O-Danube3-4B at full
# depth; DBRX-132B (16 experts top-4, 6.342 GB of bf16 experts per layer)
# with its depth cut to 8 of 40 layers: 50.7 GB of experts (all 40 would be
# 254 GB), about 53 GB with the int8 attention, head and bf16 embedding.
DBRX_LAYERS = 8
# The long_500k cell (configs.base.SHAPES: 524,288 positions, batch 1,
# decode).  H2O-Danube3-4B at full depth: a cache of 524,288 positions (48.32
# GB of bf16 K/V), a writing prefill of one window of prompt (4,096 tokens)
# and LONG_STEPS decode steps, the last at position 524,287.  Zamba2-7B at
# 18 of 81 layers: 3 of its 13 shared-attention groups, each group's K/V
# cache (1, 524,288, 32, 224) bf16 x2, 15.03 GB (45.1 GB for 3; all 13 would
# be 195 GB), the state drawn from a seed (prefilling 524,288 tokens through
# the Mamba2 layers is not run), LONG_ZAMBA_STEPS decode steps.
LONG_SEQ, LONG_PROMPT, LONG_STEPS = 524_288, 4096, 16
LONG_ZAMBA_LAYERS, LONG_ZAMBA_STEPS = 18, 8
# One shared-attention call over 524,288 keys, card against CPU, relative to
# the largest output: the same function on the same bf16 q, K and V, rounded
# to bf16 four times on the way (the scores' einsum, p, the p @ v einsum,
# the output), each rounding free to land the other way where the card and
# the CPU sum in other orders: about four bf16 ulps (2**-8 each).
LONG_ATTN_REL = 2e-2
# Phase 10 replays the fabric on minitron_4b cut to its first 8 of 32 layers
# (views of phase 8's weights): a decode call's 57 scaled launches take
# about a quarter of the full depth's host and device time.
FABRIC_LAYERS = 8
# the keys of each kernel's entry in the kernels line; the rest of its
# summary is printed on a [detail] line before it
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
               "bound_ms", "bound_by", "library_ms")
SERVING_KEYS = ("serving", "serving_per_shape", "serving_step", "launches_serving", "phase17_s")
# substrings of stock matmul kernel names (cuBLAS, CUTLASS) in a profile
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def rand_i8(torch, g, shape, dev):
    return torch.randint(-128, 128, shape, dtype=torch.int8, generator=g).to(dev)


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def imma_counts(lib: Path, kernels):
    """IMMA instructions in each instantiation of each of ``kernels`` in the
    built library's SASS (one ``cuobjdump`` pass): {kernel: {name: count}},
    or None where the toolkit has no ``cuobjdump``."""
    from repro_torch.kernels import mma_matmul as mk

    tool = Path(mk._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {k: {} for k in kernels}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            for k in kernels:
                if k in name:
                    counts[k][name] = 0
        elif "IMMA" in line:
            for k in kernels:
                if name in counts[k]:
                    counts[k][name] += 1
    return counts


def decode_cases(torch, dev) -> tuple[int, int]:
    """The scaled kernel at decode shapes (M <= 16: one and two n8
    fragments) and above 16 rows (three and four, row tiles of 32) against
    its plain version, bit for bit; returns the number of cases of each.
    Fails on the first that differs."""
    from repro_torch.kernels import mma_matmul as mk

    g = torch.Generator(device=dev).manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_cases = 0

    def operands(m, k, n, offset=0):
        x = torch.randint(-128, 128, (m * k + offset,), dtype=torch.int8, device=dev, generator=g)
        w = torch.randint(-128, 128, (k * n + offset,), dtype=torch.int8, device=dev, generator=g)
        xs = torch.rand(1, device=dev, generator=g) * 0.1 + 1e-3
        ws = torch.rand(n, device=dev, generator=g) * 0.01 + 1e-4
        return x[offset:].view(m, k), w[offset:].view(k, n), xs, ws

    def case(x, w, xs, ws, planes=8, signed=True, splits=None, what=""):
        nonlocal n_cases
        got = mk._launch_scaled(x, w, xs, ws, planes, signed, splits=splits)
        want = mk.mma_matmul_scaled_plain(x, w, xs, ws, planes=planes, signed=signed)
        torch.cuda.synchronize()
        n_cases += 1
        check(torch.equal(got, want), f"scaled kernel != plain at M={x.shape[0]} K={w.shape[0]} "
              f"N={w.shape[1]} planes={planes} signed={signed} splits={splits} {what}")
        return got

    def graph_case(m, k, n):
        """One split call captured in a CUDA graph (its workspace zeroed
        inside it), replayed twice: equal outputs, equal to the plain
        version."""
        nonlocal n_cases
        x, w, xs, ws = operands(m, k, n)
        check(mk.split_k(m, k, n, sms) > 1, f"the graph case M={m} K={k} N={n} takes no K split")
        want = case(x, w, xs, ws, 5)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=5)
        outs = []
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            outs.append(out.clone())
        n_cases += 1
        check(torch.equal(outs[0], outs[1]) and torch.equal(outs[0], want),
              f"graph replays of the scaled kernel differ at M={m} K={k} N={n}")

    def sweep(ms, ks, ns, variant_shapes, variant_ms, split_ms, split_ks, split_ns,
              offset_shapes, graph_shapes):
        for k in ks:
            for n in ns:
                for m in ms:
                    case(*operands(m, k, n))
        for k, n in variant_shapes:
            for m in variant_ms:
                args = operands(m, k, n)
                for planes in range(1, 9):
                    for signed in (True, False):
                        case(*args, planes, signed)
        for k in split_ks:
            for n in split_ns:
                for m in split_ms:
                    args = operands(m, k, n)
                    for splits in sorted({1, min(2, -(-k // mk.SCALED_BK)), mk.max_splits(k)}):
                        case(*args, 5, True, splits)
        for offset in (1, 4):
            for m, k, n in offset_shapes:
                x, w, xs, ws = operands(m, k, n, offset)
                check(x.data_ptr() % 16 != 0 and w.data_ptr() % 16 != 0,
                      "views are 16-byte aligned")
                case(x, w, xs, ws, 5, True, what=f"offset={offset}")
        for m, k, n in graph_shapes:
            graph_case(m, k, n)

    sweep(NARROW_M, NARROW_K, NARROW_N, ((129, 70), (4096, 512)), (4, 9), (1, 4, 16),
          (129, 4096, 11008), (70, 4096), ((4, 4096, 512), (9, 129, 70), (16, 11008, 4096)),
          ((4, 4096, 512), (9, 11008, 4096)))
    n_decode, n_cases = n_cases, 0
    sweep(WIDE_M, WIDE_K, WIDE_N, ((129, 70), (3072, 1024)), (20, 40), (17, 20, 33, 64),
          (129, 3072, 9216), (70, 1024), ((20, 3072, 1024), (25, 129, 70), (40, 9216, 3072)),
          ((20, 3072, 1024), (40, 9216, 3072)))
    return n_decode, n_cases


def certified_tuning(torch, np, card, cfg, params, images):
    """Phase 7: tune a plan through the kernel and through the plain path,
    serve it, check it, and time the Table 1 twin's measured rows.  Returns
    what the kernels line reports of this path, and the plan."""
    from repro_torch import autotune
    from repro_torch.bench import table1
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.kernels import ops
    from repro_torch.models import unet
    from repro_torch.obs.events import RecordingSink
    from repro_torch.segserve.synth import phantom_image

    t_phase = time.perf_counter()
    calib = [phantom_image(160, 128, cfg.in_ch, seed=s) for s in (0, 1)]
    forward = unet.forward

    def tune(tcfg):
        """``tune_unet`` with its forwards counted; the plan, host wall and
        forward count."""
        n = [0]

        def counted(*a, **kw):
            n[0] += 1
            return forward(*a, **kw)

        unet.forward = counted
        try:
            t0 = time.perf_counter()
            plan = autotune.tune_unet(params, tcfg, calib, target_rel_err=0.05)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        finally:
            unet.forward = forward
        return plan, wall_s, n[0]

    mk.launches = 0
    mk.variant_launches.clear()
    plan, tune_s, n_fwd = tune(cfg)
    tune_launches, variants = mk.launches, dict(sorted(mk.variant_launches.items()))
    cert = plan.certificate
    print(f"[tune] {plan.describe()}")
    print(f"[tune] certificate: measured {cert['measured_rel_err']:.6g} <= cert "
          f"{cert['cert']:.6g} <= target {plan.target_rel_err:g} (holds {cert['holds']}); sound "
          f"bound {cert['sound_bound']:.6g}; repairs {cert['repairs']}, measure calls "
          f"{cert['measure_calls']}; class planes {[list(c) for c in plan.class_planes]}")
    print(f"[tune] {card} | tune_unet through the kernel: {tune_s:.2f} s host wall, {n_fwd} "
          f"forwards, {tune_launches} kernel launches by (planes, signed): {variants}")
    check(cert["measured_rel_err"] <= cert["cert"] <= plan.target_rel_err and cert["holds"],
          f"certificate does not hold: {cert}")
    check(sorted(p for p, _ in variants) == list(range(1, 9)),
          f"tuning launched the kernel at planes {sorted(variants)}, expected every count 1-8")
    check(tune_launches == sum(variants.values()), "launch counts disagree")

    mk.launches = 0
    plain, plain_s, plain_fwd = tune(dataclasses.replace(cfg, impl="horner"))
    check(mk.launches == 0, f"the plain path launched the kernel {mk.launches} times")
    for field in ("planes", "class_planes", "tile", "halo", "class_thresholds"):
        check(getattr(plan, field) == getattr(plain, field),
              f"plans differ in {field}: kernel {getattr(plan, field)}, plain "
              f"{getattr(plain, field)}")
    for key in ("repairs", "measure_calls"):
        check(cert[key] == plain.certificate[key], f"plans differ in {key}")
    d_meas = abs(cert["measured_rel_err"] - plain.certificate["measured_rel_err"])
    check(d_meas <= 1e-6, f"measured_rel_err kernel vs plain differ by {d_meas}")
    check(n_fwd == plain_fwd, f"{n_fwd} forwards through the kernel, {plain_fwd} plain")
    print(f"[tune] tune_unet through the plain path on the card: the same plan (planes, class "
          f"planes, tile, halo, thresholds, repairs, measure calls; measured rel err differs by "
          f"{d_meas:.3g}), {plain_s:.2f} s host wall, {plain_fwd} forwards")

    # serve the plan: launches per micro-batch, against the plain path
    engine = autotune.engine_from_plan(cfg, params, plan)
    engine.obs = RecordingSink()
    mk.launches = 0
    t0 = time.perf_counter()
    results = engine.run(images)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    serve_launches, batches = mk.launches, len(engine.obs)
    check(batches > 0 and serve_launches == 7 * batches,
          f"plan serving: {serve_launches} launches for {batches} micro-batches")
    ref = autotune.engine_from_plan(dataclasses.replace(cfg, impl="horner"), params, plan).run(images)
    for i, (r, p) in enumerate(zip(results, ref)):
        h, w = images[i].shape[:2]
        check(r.logits.shape == (h, w, cfg.n_classes) and bool(np.isfinite(r.logits).all()),
              f"plan image {i}: logits {r.logits.shape} not finite or of the wrong shape")
        diff = float(np.abs(r.logits - p.logits).max())
        check(diff <= LOGIT_ATOL, f"plan image {i}: logits kernel vs plain differ by {diff}")
        check((r.cycles, r.pj, r.class_counts) == (p.cycles, p.pj, p.class_counts),
              f"plan image {i}: accounting differs between datapaths")
        print(f"[plan] image {i} {h}x{w}: tiles {r.n_tiles} classes {r.class_counts} cycles "
              f"{r.cycles} pJ {r.pj} | paper's FPGA model: {r.time_ms:.3f} ms, "
              f"{r.gops_per_w:.2f} GOPS/W, metered {r.metered_gops_per_w:.2f} GOPS/W | logits vs "
              f"plain max diff {diff}")
    print(f"[plan] {card} | engine_from_plan run(): {len(images)} images, {batches} "
          f"micro-batches, {serve_launches} kernel launches (7 per micro-batch), {serve_ms:.1f} ms "
          f"host wall")

    # each tile's conv outputs alone and among the other images' tiles
    conv = ops.mma_conv2d

    def tiles(imgs):
        """Serve ``imgs``; every nonzero batch row's 7 int32 conv outputs,
        keyed by the row's input window, and each micro-batch's keys."""
        rows, batches, seen = {}, [], []

        def rec_conv(*a, **kw):
            out = conv(*a, **kw)
            seen.append(out)
            return out

        def rec_forward(p, x, fcfg, **kw):
            seen.clear()
            kw.pop("graphs", None)  # eager, so every conv is seen; replays equal it
            out = forward(p, x, fcfg, **kw)
            keys = []
            for b in range(x.shape[0]):
                if np.any(x[b]):
                    keys.append(x[b].tobytes())
                    rows[keys[-1]] = [c[b] for c in seen]
            batches.append(keys)
            return out

        unet.forward, ops.mma_conv2d = rec_forward, rec_conv
        try:
            autotune.engine_from_plan(cfg, params, plan).run(imgs)
            torch.cuda.synchronize()
        finally:
            unet.forward, ops.mma_conv2d = forward, conv
        return rows, batches

    together, together_batches = tiles(images)
    owner = {}
    for i, im in enumerate(images):
        alone, _ = tiles([im])
        for key, outs in alone.items():
            check(key in together and len(outs) == len(together[key]) == 7,
                  f"image {i}: a tile served alone has no counterpart among the others")
            for l, (a, b) in enumerate(zip(outs, together[key])):
                check(torch.equal(a, b),
                      f"image {i}: a tile's conv {l} int32 output depends on its batch mates")
            owner[key] = i
    check(len(owner) == len(together) == sum(r.n_tiles for r in results),
          f"{len(owner)} tiles served alone, {len(together)} among the others")
    mixed = sum(len({owner[k] for k in keys}) > 1 for keys in together_batches)
    check(mixed > 0, "no micro-batch mixed tiles of different images")
    print(f"[plan] per-tile scales: {len(owner)} tiles, each one's 7 int32 conv outputs equal "
          f"served alone and among the other images ({mixed} of {len(together_batches)} "
          f"micro-batches mixed images)")

    # the Table 1 twin's measured rows, the int8 row at the plan's planes
    rows = table1.measured_rows(planes=plan.planes)
    for name, us, derived in rows:
        check(us > 0, f"{name}: no time")
        print(f"[table1] {name},{us:.3f},{derived}")
    phase_s = time.perf_counter() - t_phase
    print(f"[tune] phase 7 took {phase_s:.1f} s")
    return dict(launches_tuning=tune_launches, launches_tuning_by_planes={
        f"{p}{'' if sg else 'u'}": n for (p, sg), n in variants.items()},
        launches_plan_serving=serve_launches, tune_s=tune_s, plan_serve_ms=serve_ms,
        phase7_s=phase_s), plan


def gateway_replay(torch, np, dev, card, ucfg, uparams, plan):
    """Phase 8: ``traces/gateway_burst.json`` replayed open-loop through the
    gateway at full width (minitron_4b at batch 20 and the calibrated U-Net
    under phase 7's plan), its checks, and the scaled kernel's times: one
    decode call's linears across M, and each distinct linear alone at the
    gateway's M = 20.  Returns what the kernels line reports of this
    path."""
    from repro_torch.autotune import engine_from_plan
    from repro_torch.bench import gateway as gwb
    from repro_torch.bench.table1 import graph_ms
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.kernels import ops
    from repro_torch.obs.events import RecordingSink
    from repro_torch.workload import Trace, replay_trace

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    cfg, params, sched = gwb.minitron(device=dev)
    torch.cuda.synchronize()
    blocks = params["blocks"]
    linears = [blocks["attn"][n] for n in ("wq", "wk", "wv", "wo")] + \
        [blocks["mlp"][n] for n in ("w_gate", "w_up", "w_down")] + [params["head"]]
    check(all("w_q" in p and "w" not in p for p in linears),
          "a minitron_4b linear stayed in float after quantize_params_int8")
    n_weights = sum(p["w_q"].numel() for p in linears)
    print(f"[gateway] minitron_4b params on the card in {time.perf_counter() - t0:.1f} s: "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{n_weights / 1e9:.3f} G int8 weights, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated; {sched.describe()}")
    k = gwb.clock_scale(cfg)
    base = Trace.load(TRACE)
    trace = gwb.scaled_trace(base, k)
    print(f"[gateway] clock scale k = {k}: a token step of the served LM is "
          f"{gwb.lm_step_cycles(cfg, cfg.quant.plane_schedule)} modeled cycles, of the smoke LM "
          f"at 8 planes {gwb.lm_step_cycles(get_smoke_config(gwb.SMOKE_LM))} (relation (2), "
          f"the paper's FPGA model); arrivals and the round budget x{k}: round budget "
          f"{trace.meta['round_budget']}, span {trace.span_cycles} cycles, {len(trace)} requests")

    sink = RecordingSink()
    gw, mats = gwb.build(cfg, params, ucfg, uparams, plan, trace, device=dev, sink=sink)
    lm_ad, seg_ad = gw.adapters["lm"], gw.adapters["seg"]
    check(lm_ad._step_cycles == gwb.lm_step_cycles(cfg, cfg.quant.plane_schedule),
          "the adapter prices a token step differently from the clock scale")
    plan_fp, served_fp = seg_ad.verify_info()
    check(plan_fp == served_fp, f"the plan's fingerprint {plan_fp} != served {served_fp}")

    # Record the first decode step's call (M = 20 rows, whatever the step's
    # class): every scaled-kernel call it makes.  Recording adds no launch.
    engine = lm_ad.engine
    rec = {"n": 0, "calls": [], "armed": False}
    decode, step, scaled = engine.decode_fn, engine.step, ops.mma_matmul_scaled

    def recording_scaled(x, w, xs, ws, **kw):
        out = scaled(x, w, xs, ws, **kw)
        rec["calls"].append((x, w, xs, ws, kw["planes"], out))
        return out

    def counted_decode(*args):
        rec["n"] += 1
        if not rec["armed"]:
            return decode(*args)
        rec["armed"] = False
        ops.mma_matmul_scaled = recording_scaled
        try:
            return decode(*args)
        finally:
            ops.mma_matmul_scaled = scaled

    def recording_step(only=None):
        if not rec["calls"]:
            rec["armed"] = True
            rec["live_rows"] = len(engine.ready_slots())
        return step(only=only)

    engine.decode_fn, engine.step = counted_decode, recording_step
    mk.launches = mk.scaled_launches = 0
    t0 = time.perf_counter()
    try:
        summary = replay_trace(gw, trace, mats, max_rounds=10_000)
        torch.cuda.synchronize()
    finally:
        engine.decode_fn, engine.step = decode, step
    wall_s = time.perf_counter() - t0
    launches, unscaled = mk.scaled_launches, mk.launches
    calls = rec["n"]
    seg_batches = sum(1 for e in sink.events if e.etype == "seg-batch")

    # 1. every request served
    reqs = gw.requests
    want_kinds = [r.kind for r in trace.requests]
    check([g.kind for g in reqs] == want_kinds and all(g.done for g in reqs),
          f"{sum(g.done for g in reqs)} of {len(trace)} requests completed")
    for g in reqs:
        if g.kind == "lm":
            out = g.handle.out
            check(len(out) == g.handle.max_new and all(0 <= t < cfg.vocab for t in out),
                  f"LM request {g.rid}: {len(out)} tokens of {g.handle.max_new}, or one outside "
                  f"the vocabulary")
        else:
            lg = g.handle.result.logits
            check(lg.shape == (*g.handle.image.shape[:2], ucfg.n_classes)
                  and bool(np.isfinite(lg).all()), f"seg request {g.rid}: logits {lg.shape}")
    st = gw.stats()
    counts = {c: (pc["n"], pc["completed"]) for c, pc in st["per_class"].items()}
    check(counts == {"interactive": (20, 20), "batch": (12, 12), "seg": (3, 3)},
          f"per-class counts {counts}")

    # 2. launches on this path
    per_call = scaled_linears(cfg)
    check(calls > 0 and launches == per_call * calls,
          f"{launches} scaled-kernel launches for {calls} decode calls, expected {per_call} each")
    check(seg_batches > 0 and unscaled == 7 * seg_batches,
          f"{unscaled} unscaled-kernel launches for {seg_batches} seg micro-batches (7 each, "
          f"none on the LM)")

    # 3. the recorded decode call, per linear, bit for bit
    check(len(rec["calls"]) == per_call, f"{len(rec['calls'])} scaled calls recorded")
    rows = set()
    for x, w, xs, ws, planes, out in rec["calls"]:
        kk, n = w.shape
        x2 = x.reshape(-1, kk)
        rows.add(x2.shape[0])
        want = mk.mma_matmul_scaled_plain(x2, w, xs, ws, planes=planes)
        check(torch.equal(out.reshape(-1, n), want),
              f"recorded M={x2.shape[0]} call: scaled linear K={kk} N={n} != plain")
    check(rows == {gwb.LM_BATCH}, f"recorded call rows {rows}, expected {gwb.LM_BATCH}")

    # 4. every seg request's logits equal its image served alone
    for i, (g, treq) in enumerate(zip(reqs, trace.requests)):
        if g.kind != "seg":
            continue
        image, _ = mats["seg"](treq, trace.seed, i)
        alone = engine_from_plan(ucfg, uparams, plan, batch=gwb.SEG_BATCH,
                                 device=dev).run([image])[0]
        check(np.array_equal(alone.logits, g.handle.result.logits),
              f"seg request {g.rid}: logits differ from the image served alone")
        check((alone.cycles, alone.pj) == (g.handle.result.cycles, g.handle.result.pj),
              f"seg request {g.rid}: accounting differs from the image served alone")

    # 5. the accounting closes
    exec_cycles = sum(e.data["cycles"] for e in sink.events if e.etype == "exec")
    worked = gw.round_clock.worked_total
    check(exec_cycles == worked, f"exec events sum to {exec_cycles} cycles, the round clock "
          f"worked {worked}")

    prefill_tokens = sum(e.data["tokens"] for e in sink.events if e.etype == "lm-prefill")
    steps = sum(1 for e in sink.events if e.etype == "lm-step")
    print(f"[gateway] {card} | replay of {base.name} (x{k}): {len(reqs)} requests, host wall "
          f"{wall_s:.2f} s; {calls} decode calls at M = {gwb.LM_BATCH} ({prefill_tokens} prefill "
          f"tokens, {steps} decode steps), {launches} scaled-kernel launches ({per_call} per "
          f"call); {seg_batches} seg micro-batches, {unscaled} unscaled launches (7 each); "
          f"{st['rounds']} rounds, {st['forced']} forced, {len(sink)} events")
    print(f"[gateway] recorded decode call (the first decode step, {rec['live_rows']} live rows "
          f"of {gwb.LM_BATCH}): {per_call} scaled linears bit-exact against the plain version; "
          f"3 seg requests' logits equal served alone; exec events {exec_cycles} cycles = round "
          f"clock worked {worked}")
    for c, pc in st["per_class"].items():
        print(f"[gateway] class {c}: {pc['completed']} of {pc['n']} done, modeled latency p50 "
              f"{pc['p50_ms']:.3f} ms p99 {pc['p99_ms']:.3f} ms (relation (2) clock, the "
              f"paper's FPGA model), deadline misses {pc['deadline_misses']}")
    print(f"[gateway] aggregate {st['gops_w']:.3f} GOPS/W over {st['total_ops']} ops "
          f"(the paper's FPGA model at its implied power, not the card)")

    # times: the recorded call's linears across M (x past the recorded 20
    # rows drawn at random: the kernel's work does not depend on the
    # values), each with the branch it takes, and each distinct linear at
    # the gateway's M alone with w cold
    recorded = [(x.reshape(-1, w.shape[0]), w, xs, ws, p) for x, w, xs, ws, p, _ in rec["calls"]]
    g = torch.Generator(device=dev).manual_seed(5)
    extra = {kk: torch.randint(-128, 128, (max(GATEWAY_M), kk), dtype=torch.int8, device=dev,
                               generator=g) for kk in {w.shape[0] for _, w, *_ in recorded}}
    times = {}
    for m in GATEWAY_M:
        mcalls = [(x[:m] if m <= x.shape[0] else torch.cat([x, extra[w.shape[0]][:m - x.shape[0]]]),
                   w, xs, ws, p) for x, w, xs, ws, p in recorded
                  if m <= HEAD_OUT_M or w.shape[1] != cfg.vocab]
        libs = [scaled_library(torch, *c) for c in mcalls]
        ms = graph_ms(torch, lambda: [mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=p)
                                      for x, w, xs, ws, p in mcalls], calls=1)
        lib_ms = graph_ms(torch, lambda: [f() for f in libs], calls=1)
        plain_ms = (time_ms(torch, lambda: [mk.mma_matmul_scaled_plain(x, w, xs, ws, planes=p)
                                            for x, w, xs, ws, p in mcalls], reps=1, warmup=1)
                    if m in (16, gwb.LM_BATCH) else None)
        b_ms, b_by, nbytes, nops = scaled_bound([(m, *w.shape) for _, w, *_ in mcalls])
        branch = (f"mma_tc_scaled_kernel, {min(4, -(-m // 8))} n8 fragments per pass, "
                  f"{mk.row_tiles(m)} row tile{'s' if mk.row_tiles(m) > 1 else ''}")
        times[m] = dict(ms=ms, library_ms=lib_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        branch=branch, linears=len(mcalls))
        what = "" if len(mcalls) == len(recorded) else ", the layer linears only"
        print(f"[time] {card} | mma_matmul_scaled one minitron_4b decode call at M = {m} "
              f"({branch}; {len(mcalls)} linears at the schedule's planes{what}, one CUDA "
              f"graph, {nbytes / 1e9:.3f} GB of distinct w: cold): kernel {ms:.4f} ms, plain "
              + ("not timed" if plain_ms is None else f"{plain_ms:.3f} ms")
              + f", torch._int_mm+scale {lib_ms:.4f} ms (M {m if m > 16 else 32} rows), bound "
              f"{b_ms:.4f} ms ({b_by}; {nops / 1e9:.1f} G int8 ops), {nbytes / ms / 1e6:.0f} GB/s")
    planes_of = {tuple(w.shape): p for _, w, _, _, p in recorded}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_shape = []
    m = gwb.LM_BATCH
    for name, kk, n in lm_decode_shapes(cfg):
        p = planes_of[(kk, n)]
        ms_planes, lib_ms, plain_ms, copies, gcalls = cold_shape_times(torch, dev, g, m, kk, n,
                                                                       (p,))
        b_ms, b_by, nbytes, _ = scaled_bound([(m, kk, n)])
        splits = mk.split_k(m, kk, n, sms)
        per_shape.append(dict(name=name, M=m, K=kk, N=n, planes=p, ms=ms_planes[p],
                              plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                              splits=splits, w_copies=copies))
        print(f"[time] {card} | mma_matmul_scaled minitron_4b {name} M={m} K={kk} N={n} planes "
              f"{p} ({splits} K splits; graph of {gcalls} calls over {copies} copies of w: cold): "
              f"kernel {ms_planes[p]:.5f} ms, plain {plain_ms:.4f} ms, torch._int_mm+scale "
              f"{lib_ms:.5f} ms, bound {b_ms:.5f} ms ({b_by}), {b_ms / ms_planes[p]:.3f} of the "
              f"bound, {nbytes / ms_planes[p] / 1e6:.0f} GB/s")
    phase_s = time.perf_counter() - t_phase
    print(f"[gateway] phase 8 took {phase_s:.1f} s")
    return dict(launches_gateway=launches, gateway_decode_calls=calls, gateway_wall_s=wall_s,
                gateway_clock_scale=k, gateway_seg_batches=seg_batches,
                gateway_m20=times[gwb.LM_BATCH], gateway_m16=times[16],
                gateway_m_sweep=times, gateway_m20_per_shape=per_shape,
                gateway_forced=st["forced"], gateway_rounds=st["rounds"], phase8_s=phase_s), \
        dict(launches_gateway=unscaled), (cfg, params)


def fabric_replay(torch, np, dev, card, ucfg, uparams, plan, cfg, params):
    """Phase 10: ``traces/diurnal_smoke.json`` replayed open-loop through a
    2-shard ``Fabric`` of phase 8's gateways at full width (one set of
    minitron_4b weights and the U-Net under phase 7's plan, shared by both
    shards), with a ``RecordingSink``, an ``SloMonitor``, an ``EnergyMeter``
    and a ``CaptureSink`` armed, and its checks.  Returns what the kernels
    line reports of this path."""
    from collections import Counter

    from repro_torch.autotune import engine_from_plan
    from repro_torch.bench import capacity as capb
    from repro_torch.bench import gateway as gwb
    from repro_torch.core import energy_model as em
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.kernels import ops
    from repro_torch.obs import (CaptureSink, EnergyMeter, RecordingSink, SloMonitor, TeeSink,
                                 assemble, attach_joules, reconcile)
    from repro_torch.workload import Trace, replay_trace

    t_phase = time.perf_counter()
    k = gwb.clock_scale(cfg)
    base = Trace.load(DIURNAL)
    trace = gwb.scaled_trace(base, k)
    check(all(r.deadline_cycles is not None for r in trace.requests)
          and [r.deadline_cycles for r in trace.requests]
          == [r.deadline_cycles * k for r in base.requests], "deadlines not scaled by k")
    # every cycle quantity of the traffic scales with k: the interactive
    # latency target (modeled ms) and the monitor's burn windows too
    specs = [dataclasses.replace(sp, latency_target_ms=sp.latency_target_ms * k)
             if sp.latency_target_ms is not None else sp for sp in capb.slo_specs()]
    windows = tuple(w * k for w in capb.WINDOWS)
    # pJ per worked cycle at the served schedules' widest budgets (the LM's
    # from_weights schedule, the U-Net plan's), as benchmarks/energy.py
    # prices its plans: the paper's FPGA energy model, not a card reading
    lm_planes, seg_planes = max(cfg.quant.plane_schedule), max(plan.planes)
    rates = {"lm": em.active_rate_pj(lm_planes), "seg": em.active_rate_pj(seg_planes)}
    rec, mon, meter, cap = RecordingSink(), SloMonitor(specs, windows=windows), \
        EnergyMeter(rates), CaptureSink()
    fab, mats = gwb.fabric(cfg, params, ucfg, uparams, plan, trace, device=dev,
                           sink=TeeSink([rec, mon, meter]))
    n = len(fab.shards)
    print(f"[fabric] {n} shards, router {fab.router}, steal {fab.steal}, seed {fab.seed}; "
          f"{base.name} x{k}: {len(trace)} requests "
          f"{dict(Counter(r.qos for r in trace.requests))}, round budget {fab.round_budget}, "
          f"span {trace.span_cycles} cycles, deadlines and the interactive latency target "
          f"({specs[0].latency_target_ms:.1f} modeled ms) x{k}; energy rates lm "
          f"{rates['lm']} pJ/cycle ({lm_planes} planes), seg {rates['seg']} ({seg_planes} planes)")
    lm_ads = [g.adapters["lm"] for g in fab.shards]
    seg_ads = [g.adapters["seg"] for g in fab.shards]
    leaves = [p["w_q"] for a in lm_ads for p in (a.engine.params["head"],
                                                  a.engine.params["blocks"]["mlp"]["w_up"])]
    check(len({t.data_ptr() for t in leaves}) == 2,
          "the shards' engines do not share one set of minitron_4b weights")
    for a in seg_ads:
        plan_fp, served_fp = a.verify_info()
        check(plan_fp == served_fp, f"the plan's fingerprint {plan_fp} != served {served_fp}")

    # per shard: decode calls counted, the first decode step's call recorded
    # (every scaled-kernel call it makes; recording adds no launch)
    scaled = ops.mma_matmul_scaled
    recs, saved = [], []
    for a in lm_ads:
        engine, r = a.engine, {"n": 0, "calls": [], "armed": False}
        decode, step = engine.decode_fn, engine.step

        def counted_decode(*args, r=r, decode=decode):
            r["n"] += 1
            if not r["armed"]:
                return decode(*args)
            r["armed"] = False

            def recording(x, w, xs, ws, **kw):
                out = scaled(x, w, xs, ws, **kw)
                r["calls"].append((x, w, xs, ws, kw["planes"], out))
                return out

            ops.mma_matmul_scaled = recording
            try:
                return decode(*args)
            finally:
                ops.mma_matmul_scaled = scaled

        def recording_step(only=None, r=r, step=step, engine=engine):
            if not r["calls"]:
                r["armed"] = True
                r["live_rows"] = len(engine.ready_slots())
            return step(only=only)

        saved.append((engine, decode, step))
        engine.decode_fn, engine.step = counted_decode, recording_step
        recs.append(r)
    mk.launches = mk.scaled_launches = 0
    t0 = time.perf_counter()
    try:
        summary = replay_trace(fab, trace, mats, max_rounds=10_000, capture=cap)
        torch.cuda.synchronize()
    finally:
        for engine, decode, step in saved:
            engine.decode_fn, engine.step = decode, step
    wall_s = time.perf_counter() - t0
    launches, unscaled = mk.scaled_launches, mk.launches
    calls = [r["n"] for r in recs]
    seg_batches = [sum(1 for e in rec.events if e.etype == "seg-batch" and e.data["shard"] == s)
                   for s in range(n)]

    # 1. every request served
    reqs = fab.requests
    check(len(reqs) == len(trace) and all(g.done for g in reqs),
          f"{sum(g.done for g in reqs)} of {len(trace)} requests completed")
    check(Counter(g.kind for g in reqs) == Counter(r.kind for r in trace.requests),
          "served kinds differ from the trace's")
    for g in reqs:
        if g.kind == "lm":
            out = g.handle.out
            check(len(out) == g.handle.max_new and all(0 <= t < cfg.vocab for t in out),
                  f"LM request {g.rid}: {len(out)} tokens of {g.handle.max_new}, or one outside "
                  f"the vocabulary")
        else:
            lg = g.handle.result.logits
            check(lg.shape == (*g.handle.image.shape[:2], ucfg.n_classes)
                  and bool(np.isfinite(lg).all()), f"seg request {g.rid}: logits {lg.shape}")
    st = fab.stats()
    counts = {c: (pc["n"], pc["completed"]) for c, pc in st["per_class"].items()}
    want = Counter(r.qos for r in trace.requests)
    check(counts == {c: (m, m) for c, m in want.items()}, f"per-class counts {counts}")

    # 2. the fleet ledger, spans, SLO and picojoule accounts close
    add = fab.additivity()
    check(add["holds"], f"fleet ledger additivity: {add}")
    recon = reconcile(rec.events, [g.round_clock for g in fab.shards], ledger=fab.ledger)
    check(recon["holds"], f"exec events {recon['total_exec']} != worked {recon['total_worked']} "
          f"(ledger {recon.get('ledger_worked')})")
    spans = attach_joules(assemble(rec.events), meter)
    slo_rec = mon.reconcile(spans)
    check(slo_rec["holds"], f"SLO online/offline misses: {slo_rec}")
    e_rec = meter.reconcile(spans)
    check(e_rec["holds"], f"energy ledger: {e_rec['checks']}")
    check(sum(sp.pj for sp in spans if sp.done) == e_rec["spans"]["online_pj"],
          "span joules differ from the meter's attribution")
    for s, g in enumerate(fab.shards):
        sst = g.stats()
        check("slo" in sst and "energy" in sst and sst["slo"]["scope"] == s
              and sst["energy"]["scope"] == s, f"shard {s} stats lack its slo/energy blocks")
    check("slo" in st and "energy" in st and summary["energy"] == st["energy"],
          "the fleet stats lack the slo/energy blocks")
    misses = {q: c["deadline_misses"] for q, c in st["per_class"].items() if c["deadline_misses"]}
    check(misses == mon.miss_counts(), f"stats() misses {misses} != monitor "
          f"{mon.miss_counts()}")

    # 3. the captured trace is the replayed one
    back = cap.to_trace("captured", seed=trace.seed, meta=dict(trace.meta))
    key = lambda r: (r.kind, r.qos, r.arrival_cycle, dict(r.payload), r.deadline_cycles)
    check([key(r) for r in back.requests] == [key(r) for r in trace.requests],
          "the captured trace's requests differ from the replayed trace's")

    # 4. launches on this path
    per_call = scaled_linears(cfg)
    check(min(calls) > 0 and launches == per_call * sum(calls),
          f"{launches} scaled-kernel launches for {calls} decode calls, expected {per_call} each")
    check(min(seg_batches) > 0 and unscaled == 7 * sum(seg_batches),
          f"{unscaled} unscaled-kernel launches for {seg_batches} seg micro-batches (7 each, "
          f"none on the LM)")

    # 5. each shard's recorded decode call, per linear, bit for bit
    for s, r in enumerate(recs):
        check(len(r["calls"]) == per_call, f"shard {s}: {len(r['calls'])} scaled calls recorded")
        for x, w, xs, ws, planes, out in r["calls"]:
            kk, nn = w.shape
            x2 = x.reshape(-1, kk)
            check(x2.shape[0] == gwb.LM_BATCH, f"shard {s}: recorded call of {x2.shape[0]} rows")
            check(torch.equal(out.reshape(-1, nn),
                              mk.mma_matmul_scaled_plain(x2, w, xs, ws, planes=planes)),
                  f"shard {s} recorded call: scaled linear K={kk} N={nn} != plain")

    # 6. every seg request's logits equal its image served alone
    n_seg = sum(1 for g in reqs if g.kind == "seg")
    for i, treq in enumerate(trace.requests):
        if treq.kind != "seg":
            continue
        g = next(g for g in reqs if g.kind == "seg" and g.arrival == treq.arrival_cycle)
        image, _ = mats["seg"](treq, trace.seed, i)
        alone = engine_from_plan(ucfg, uparams, plan, batch=gwb.SEG_BATCH,
                                 device=dev).run([image])[0]
        check(np.array_equal(alone.logits, g.handle.result.logits),
              f"seg request {g.rid}: logits differ from the image served alone")
        check((alone.cycles, alone.pj) == (g.handle.result.cycles, g.handle.result.pj),
              f"seg request {g.rid}: accounting differs from the image served alone")

    print(f"[fabric] {card} | replay of {base.name} (x{k}) through {n} shards: {len(reqs)} "
          f"requests, host wall {wall_s:.2f} s; decode calls per shard {calls} at M = "
          f"{gwb.LM_BATCH} ({launches} scaled launches, {per_call} per call), seg micro-batches "
          f"per shard {seg_batches} ({unscaled} unscaled launches, 7 each); {st['rounds']} "
          f"rounds, {st['forced']} forced, {len(rec)} events")
    print(f"[fabric] routes: dispatched per shard {st['dispatched']}, router {st['router_stats']};"
          f" steals {st['stolen']} (from {st['stolen_from']}, to {st['stolen_to']})")
    print(f"[fabric] each shard's recorded decode call (the first decode step; live rows "
          f"{[r['live_rows'] for r in recs]} of {gwb.LM_BATCH}): {per_call} scaled linears "
          f"bit-exact against the plain version; {n_seg} seg requests' logits "
          f"equal served alone; fleet additivity holds; exec events "
          f"{recon['total_exec']} cycles = worked {recon['total_worked']} = ledger; SLO misses "
          f"online {slo_rec['online']} = span-derived; pJ ledger holds "
          f"({e_rec['spans']['online_pj']} pJ attributed to completed requests); the captured "
          f"trace equals the replayed one")
    for c, pc in st["per_class"].items():
        sl = st["slo"]["per_class"].get(c, {})
        print(f"[fabric] class {c}: {pc['completed']} of {pc['n']} done, modeled latency p50 "
              f"{pc['p50_ms']:.3f} ms p99 {pc['p99_ms']:.3f} ms, deadline misses "
              f"{pc['deadline_misses']}, attribution {sl.get('attribution')} (relation (2) "
              f"clock, the paper's FPGA model)")
    eb = st["energy"]
    print(f"[fabric] metered {eb['metered_gops_w']:.4f} GOPS/W ({eb['total_mj']:.3f} mJ: active "
          f"{eb['active_mj']:.3f}, idle {eb['idle_mj']:.3f}), analytic {eb['analytic_gops_w']:.4f}"
          f" GOPS/W (both the paper's FPGA model at its modeled power, not the card)")
    phase_s = time.perf_counter() - t_phase
    print(f"[fabric] phase 10 took {phase_s:.1f} s")
    return dict(launches_fabric=launches, fabric_decode_calls=calls, fabric_wall_s=wall_s,
                fabric_seg_batches=seg_batches, fabric_rounds=st["rounds"],
                fabric_dispatched=st["dispatched"], fabric_stolen=st["stolen"],
                fabric_misses=misses, fabric_metered_gops_w=eb["metered_gops_w"],
                fabric_analytic_gops_w=eb["analytic_gops_w"], phase10_s=phase_s), \
        dict(launches_fabric=unscaled)


def _first_layers(tree, n: int):
    """The parameter tree with every stacked block leaf cut to its first
    ``n`` layers (views)."""
    if isinstance(tree, dict):
        return {k: _first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def spec_decoding(torch, np, dev, card, cfg, params):
    """Phase 9: precision-speculative decoding at full width on phase 8's
    minitron_4b — ``tune_lm``, ``tune_spec``, serving through ``Gateway`` +
    ``SpecLMAdapter``, kernel-route identity (measured), Horner-route
    identity at a cut depth (gated), and the recorded draft and verify
    calls timed.  Returns what the kernels line reports of this path."""
    from collections import Counter

    from repro_torch import autotune
    from repro_torch.bench.table1 import graph_ms
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.core import energy_model as em
    from repro_torch.obs import (EnergyMeter, RecordingSink, TeeSink, assemble, attach_joules,
                                 reconcile)
    from repro_torch.serve import Engine, Gateway, Request, SpecEngine, SpecLMAdapter

    t_phase = time.perf_counter()
    per_call = scaled_linears(cfg)
    n_lin = block_linears(cfg) * cfg.n_layers
    rng = np.random.default_rng(0)

    # ---- 1. tune_lm (the Horner route, as the reference builds it)
    tokens = rng.integers(0, cfg.vocab, (1, SPEC_TUNE_TOKENS)).astype(np.int32)
    forward, n_fwd = transformer.forward, [0]

    def counted(*a, **kw):
        n_fwd[0] += 1
        return forward(*a, **kw)

    transformer.forward = counted
    mk.scaled_launches = 0
    try:
        t0 = time.perf_counter()
        plan = autotune.tune_lm(params, cfg, tokens, target_rel_err=SPEC_TARGET,
                                max_repair=SPEC_MAX_REPAIR, device=dev)
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t0
    finally:
        transformer.forward = forward
    check(mk.scaled_launches == 0, f"tune_lm (Horner route) launched the scaled kernel "
          f"{mk.scaled_launches} times")
    cert = plan.certificate
    print(f"[spec] {card} | tune_lm target {SPEC_TARGET} on {tokens.size} tokens (seed 0), "
          f"max_repair {SPEC_MAX_REPAIR}: {n_fwd[0]} forwards, {cert['repairs']} repairs, "
          f"planes {list(plan.planes)}, measured_rel_err {cert['measured_rel_err']!r}, cert "
          f"{cert['cert']!r}, holds {cert['holds']}; {tune_s:.2f} s host wall (the plan's "
          f"two fingerprints, one pass over the weights, included)")
    check(cert["holds"] == (cert["cert"] <= plan.target_rel_err), f"holds disagrees: {cert}")

    def logits(schedule):
        qcfg = cfg.replace(quant=QuantConfig(mode="mma_int8", planes=8, plane_schedule=schedule))
        return transformer.forward(params, tokens, qcfg, device=dev).to(torch.float32)

    ref = logits(None)
    again = float((logits(tuple(plan.planes)) - ref).abs().max()) / max(float(ref.abs().max()),
                                                                         1e-8)
    check(again == cert["measured_rel_err"],
          f"re-measured rel err {again!r} != tune_lm's {cert['measured_rel_err']!r}")
    print(f"[spec] re-measured with the same forward on the same tokens: {again!r} (equal to the "
          f"last bit)")

    # ---- 2. tune_spec on the kernel route
    prompts2 = [rng.integers(0, cfg.vocab, SPEC_PROMPT).astype(np.int32) for _ in range(2)]
    mk.scaled_launches = 0
    mk.scaled_variant_launches.clear()
    t0 = time.perf_counter()
    splan = autotune.tune_spec(params, cfg, prompts2, plan=plan, batch=2, max_seq=SPEC_MAX_SEQ,
                               max_new=SPEC_MAX_NEW, k_candidates=SPEC_K_GRID,
                               plane_candidates=SPEC_PLANE_GRID, device=dev)
    torch.cuda.synchronize()
    tspec_s = time.perf_counter() - t0
    tspec_calls, tspec_launches = mk.scaled_launches // per_call, mk.scaled_launches
    check(tspec_launches == per_call * tspec_calls and tspec_calls > 0,
          f"tune_spec: {tspec_launches} scaled launches, not {per_call} per decode call")
    check(all((p, True) in mk.scaled_variant_launches for p in SPEC_PLANE_GRID),
          f"tune_spec launched the kernel at {sorted(mk.scaled_variant_launches)}")
    spec_rec = splan.modeled["spec"]
    for g in spec_rec["grid"]:
        print(f"[spec] tune_spec grid: draft planes {g['planes']} k {g['k']}: cycles {g['cycles']}"
              f" emitted {g['emitted']} accepted {g['accepted']} drafted {g['drafted']} "
              f"(relation (2), the paper's FPGA model)")
    print(f"[spec] {card} | tune_spec: best draft planes {spec_rec['best']['planes']} k "
          f"{spec_rec['best']['k']}, modeled speedup {spec_rec['speedup']:.4f} (relation (2), the "
          f"paper's FPGA model, not a card number); {tspec_s:.2f} s host wall, {tspec_calls} "
          f"decode calls ({tspec_launches} scaled launches)")

    # ---- 3. serve through the gateway: the spec main path
    prompts = [rng.integers(0, cfg.vocab, SPEC_PROMPT).astype(np.int32)
               for _ in range(SPEC_BATCH)]
    draft_planes = splan.spec_planes[0]
    sink = RecordingSink()
    # the meter prices verify work at the plan's widest budget and draft work
    # at the draft budget (the paper's FPGA energy model, not a card reading)
    meter = EnergyMeter({"lm": em.active_rate_pj(max(plan.planes))},
                        draft_rates={"lm": em.active_rate_pj(draft_planes)})
    adapter = SpecLMAdapter(cfg, params, batch=SPEC_BATCH, max_seq=SPEC_MAX_SEQ, plan=splan,
                            device=dev)
    budget = 2 * SPEC_BATCH * adapter._spec_slot_cycles(splan.spec_k)
    gw = Gateway([adapter], policy="fair", round_budget=budget, sink=TeeSink([sink, meter]))
    engine = adapter.engine
    rec = {"draft": [], "verify": [], "n_draft": 0, "n_decode": 0, "in_round": False}
    draft_fn, decode_fn, spec_step = engine.draft_fn, engine.decode_fn, engine.spec_step
    scaled = ops.mma_matmul_scaled

    def recorded(fn, into, *args):
        """``fn(*args)`` with every scaled-kernel call recorded into
        ``into``.  Recording adds no launch."""
        def recording(x, w, xs, ws, **kw):
            out = scaled(x, w, xs, ws, **kw)
            into.append((x, w, xs, ws, kw["planes"], out))
            return out

        ops.mma_matmul_scaled = recording
        try:
            return fn(*args)
        finally:
            ops.mma_matmul_scaled = scaled

    def counted_draft(*args):
        rec["n_draft"] += 1
        if rec["draft"]:
            return draft_fn(*args)
        return recorded(draft_fn, rec["draft"], *args)

    def counted_decode(*args):
        rec["n_decode"] += 1
        if rec["verify"] or not rec["in_round"]:
            return decode_fn(*args)
        return recorded(decode_fn, rec["verify"], *args)

    def marked_spec_step(only=None):
        rec["in_round"] = True
        try:
            return spec_step(only=only)
        finally:
            rec["in_round"] = False

    engine.draft_fn, engine.decode_fn, engine.spec_step = counted_draft, counted_decode, \
        marked_spec_step
    # the first submission hashes the served weights (params_fingerprint) and
    # refuses the plan unless they are the ones it was tuned on
    t0 = time.perf_counter()
    reqs = [gw.submit("lm", p, max_new=SPEC_MAX_NEW) for p in prompts]
    submit_s = time.perf_counter() - t0
    mk.scaled_launches = 0
    mk.scaled_variant_launches.clear()
    t0 = time.perf_counter()
    gw.drain(max_rounds=1_000)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches, by_planes = mk.scaled_launches, Counter(mk.scaled_variant_launches)
    check(all(r.done and len(r.handle.out) == SPEC_MAX_NEW
              and all(0 <= t < cfg.vocab for t in r.handle.out) for r in reqs),
          "a spec request did not complete with its budget in the vocabulary")
    n_draft, n_decode = rec["n_draft"], rec["n_decode"]
    check(launches == per_call * (n_draft + n_decode),
          f"{launches} scaled launches for {n_draft} draft and {n_decode} other decode calls, "
          f"expected {per_call} each")
    want = Counter({(draft_planes, True): n_lin * n_draft, (8, True): n_draft + n_decode})
    for p in plan.planes:
        want[(p, True)] += block_linears(cfg) * n_decode
    check(by_planes == want, f"launches by planes {dict(by_planes)}, expected {dict(want)}")
    for name, calls, planes in (("draft", rec["draft"], (draft_planes,) * cfg.n_layers),
                                ("verify", rec["verify"], tuple(plan.planes))):
        check(len(calls) == per_call, f"{len(calls)} scaled calls recorded in the {name} call")
        check([p for *_, p, _ in calls] == [p for p in planes for _ in range(block_linears(cfg))]
              + [8],
              f"the {name} call's linears ran at planes {[p for *_, p, _ in calls]}")
        for x, w, xs, ws, p, out in calls:
            x2 = x.reshape(-1, w.shape[0])
            check(torch.equal(out.reshape(-1, w.shape[1]),
                              mk.mma_matmul_scaled_plain(x2, w, xs, ws, planes=p)),
                  f"recorded {name} call: scaled linear K={w.shape[0]} N={w.shape[1]} != plain")
    recon = reconcile(sink.events, [gw.round_clock])
    check(recon["holds"], f"exec events {recon['total_exec']} != worked {recon['total_worked']}")
    etypes = Counter(e.etype for e in sink.events)
    check(all(etypes[e] for e in ("draft", "verify", "accept")), f"spec events {dict(etypes)}")
    # the spec energy account closes: useful + wasted pJ = draft + verify pJ,
    # and the slot-level cycles re-derive the round-level ones
    e_rec = meter.reconcile(attach_joules(assemble(sink.events), meter))
    e_spec = meter.spec_summary()
    check(e_spec is not None and e_spec["useful_pj"] + e_spec["wasted_pj"]
          == e_spec["draft_pj"] + e_spec["verify_pj"], f"spec pJ account: {e_spec}")
    check(e_rec["holds"] and all(v["cycles_close"] and v["pj_close"]
                                 for v in e_rec["spec"].values()),
          f"energy ledger: {e_rec['checks']}, spec {e_rec['spec']}")
    check("energy" in gw.stats(), "the spec gateway's stats lack the energy block")
    rounds = [e.data for e in sink.events if e.etype == "lm-spec"]
    print(f"[spec] {card} | Gateway(fair) + SpecLMAdapter (draft planes {draft_planes}, k "
          f"{splan.spec_k}, verify planes {list(plan.planes)}): {len(reqs)} requests, "
          f"{gw.rounds} rounds, {len(rounds)} spec rounds; {n_draft} draft calls + {n_decode} "
          f"prefill/verify calls, {launches} scaled launches ({per_call} per call; by (planes, "
          f"signed) {dict(sorted(by_planes.items()))}); {serve_s:.2f} s host wall; submitting, "
          f"params_fingerprint of the served weights included: {submit_s:.2f} s")
    print(f"[spec] energy (the paper's FPGA model): draft {e_spec['draft_pj']} pJ over "
          f"{e_spec['draft_cycles']} cycles at {draft_planes} planes, verify {e_spec['verify_pj']} "
          f"pJ over {e_spec['verify_cycles']} cycles; useful {e_spec['useful_pj']} + wasted "
          f"{e_spec['wasted_pj']} = draft + verify; slot-level cycles = round-level; "
          f"{e_spec['accepted']} of {e_spec['drafted']} drafts accepted")
    print(f"[spec] recorded draft and verify calls: {per_call} scaled linears each bit-exact "
          f"against the plain version; exec cycles {recon['total_exec']} = worked "
          f"{recon['total_worked']}; events draft {etypes['draft']} verify {etypes['verify']} "
          f"accept {etypes['accept']} rollback {etypes['rollback']}")
    engine.draft_fn, engine.decode_fn, engine.spec_step = draft_fn, decode_fn, spec_step
    del gw, adapter, engine

    # ---- 4. identity on the kernel route, measured and not gated
    qcfg = autotune.apply_plan_lm(cfg, splan)

    def serve(qc, prm, spec, k, draft):
        eng = (SpecEngine(qc, prm, batch=SPEC_BATCH, max_seq=SPEC_MAX_SEQ, draft_schedule=draft,
                          k=k, device=dev) if spec
               else Engine(qc, prm, batch=SPEC_BATCH, max_seq=SPEC_MAX_SEQ, device=dev))
        reqs = [Request(i, p, max_new=SPEC_MAX_NEW) for i, p in enumerate(prompts)]
        mk.scaled_launches = 0
        t0 = time.perf_counter()
        for r in reqs:
            check(eng.admit(r), "a slot was refused")
        while eng.ready_slots():
            eng.spec_step() if spec else eng.step()
        torch.cuda.synchronize()
        return eng, [list(r.out) for r in reqs], time.perf_counter() - t0, mk.scaled_launches

    _, gstreams, g_s, g_l = serve(qcfg, params, False, splan.spec_k, splan.spec_planes)
    emitted = SPEC_BATCH * SPEC_MAX_NEW
    print(f"[spec] {card} | greedy Engine: {g_s:.2f} s host wall, {g_l // per_call} decode "
          f"calls, {g_s / emitted * 1e3:.1f} ms per emitted token")
    tuned = splan.spec_planes[0]
    identity = {}
    # the tuned draft budget first, then the grid's others: a budget whose
    # drafts are accepted by some slots and not others is where one
    # activation scale per tensor can couple the slots
    for dp in [tuned] + [p for p in SPEC_PLANE_GRID if p != tuned]:
        seng, sstreams, s_s, s_l = serve(qcfg, params, True, splan.spec_k,
                                         (dp,) * cfg.n_layers)
        same = sum(a == b for a, b in zip(gstreams, sstreams))
        parts = [next(j for j, (a, b) in enumerate(zip(g, s)) if a != b)
                 for g, s in zip(gstreams, sstreams) if g != s]
        drafted = sum(r["drafted"] for r in seng.spec_trace)
        accepted = [sum(sl["accepted"] for r in seng.spec_trace for sl in r["slots"]
                        if sl["rid"] == i) for i in range(SPEC_BATCH)]
        identity[dp] = dict(identical=same, parts=parts, accepted=sum(accepted),
                            drafted=drafted, wall_s=s_s, calls=s_l // per_call)
        print(f"[spec] {card} | kernel route identity at draft planes {dp}, k {splan.spec_k} "
              f"(measured, not gated): {same} of {SPEC_BATCH} streams identical to greedy; the "
              f"others part at positions {parts}; accepted {sum(accepted)} of {drafted} drafts "
              f"(by request {accepted}) | SpecEngine: {s_s:.2f} s host wall, {s_l // per_call} "
              f"decode calls, {s_s / emitted * 1e3:.1f} ms per emitted token")
    same, parts = identity[tuned]["identical"], identity[tuned]["parts"]
    drafted, s_s = identity[tuned]["drafted"], identity[tuned]["wall_s"]
    accept = identity[tuned]["accepted"] / drafted if drafted else 0.0

    # ---- 5. identity on the Horner route (per-row scales), gated, at a cut depth
    hl = SPEC_HORNER_LAYERS
    hparams = dict(params, blocks=_first_layers(params["blocks"], hl))
    hcfg = cfg.replace(n_layers=hl, quant=QuantConfig(mode="mma_int8", impl="horner",
                                                      plane_schedule=tuple(plan.planes[:hl])))
    t0 = time.perf_counter()
    (geng, gh, _, gl), (heng, sh, _, sl) = [serve(hcfg, hparams, spec, 2, (2,) * hl)
                                            for spec in (False, True)]
    horner_s = time.perf_counter() - t0
    check(gl == sl == 0, "the Horner route launched the scaled kernel")
    check(sh == gh, f"Horner route: spec streams {sh} != greedy {gh}")
    check(np.array_equal(heng.lengths, geng.lengths), "Horner route: lengths differ")
    for i, n in enumerate(geng.lengths):
        for key in ("k", "v"):
            check(torch.equal(heng.cache[key][:, i, :n], geng.cache[key][:, i, :n]),
                  f"Horner route: slot {i}'s live {key} cache rows differ from greedy's")
    hdrafted = sum(r["drafted"] for r in heng.spec_trace)
    haccepted = sum(r["accepted"] for r in heng.spec_trace)
    print(f"[spec] {card} | Horner route identity at {hl} of {cfg.n_layers} layers (full width; "
          f"draft 2 planes, k 2): {SPEC_BATCH} streams equal greedy token for token, lengths "
          f"and live cache rows bit for bit; accepted {haccepted} of {hdrafted}; "
          f"{horner_s:.2f} s host wall")
    del geng, heng, hparams

    # ---- 6. the recorded draft and verify calls timed (CUDA-graph replays, w cold)
    times = {}
    for name in ("draft", "verify"):
        calls = [(x.reshape(-1, w.shape[0]), w, xs, ws, p) for x, w, xs, ws, p, _ in rec[name]]
        ms = graph_ms(torch, lambda: [mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=p)
                                      for x, w, xs, ws, p in calls], calls=1)
        libs = [scaled_library(torch, *c) for c in calls]
        lib_ms = graph_ms(torch, lambda: [f() for f in libs], calls=1)
        plain_ms = time_ms(torch, lambda: [mk.mma_matmul_scaled_plain(x, w, xs, ws, planes=p)
                                           for x, w, xs, ws, p in calls], reps=1, warmup=1)
        m = calls[0][0].shape[0]
        b_ms, b_by, nbytes, nops = scaled_bound([(x.shape[0], *w.shape) for x, w, *_ in calls])
        times[name] = dict(ms=ms, library_ms=lib_ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, M=m)
        print(f"[time] {card} | mma_matmul_scaled one minitron_4b {name} call at M = {m} "
              f"({len(calls)} linears at planes {sorted(set(p for *_, p in calls))}, one CUDA "
              f"graph, {nbytes / 1e9:.3f} GB of distinct w: cold): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, torch._int_mm+scale {lib_ms:.4f} ms (32 rows), bound "
              f"{b_ms:.4f} ms ({b_by}), {nbytes / ms / 1e6:.0f} GB/s")
    phase_s = time.perf_counter() - t_phase
    print(f"[spec] phase 9 took {phase_s:.1f} s")
    return dict(
        launches_spec=launches,
        launches_spec_by_planes={f"{p}{'' if sg else 'u'}": n for (p, sg), n in
                                 sorted(by_planes.items())},
        spec_draft_calls=n_draft, spec_other_calls=n_decode, spec_serve_wall_s=serve_s,
        spec_submit_s=submit_s, spec_tune_lm_s=tune_s, spec_tune_lm_planes=list(plan.planes),
        spec_tune_lm_holds=cert["holds"], spec_tune_spec_s=tspec_s,
        spec_tune_spec_calls=tspec_calls, spec_best=spec_rec["best"],
        spec_kernel_identical=same, spec_kernel_parts=parts, spec_accept_rate=accept,
        spec_kernel_identity_by_draft_planes=identity,
        spec_greedy_wall_s=g_s, spec_wall_s=s_s, spec_draft_call=times["draft"],
        spec_verify_call=times["verify"], spec_energy=e_spec, phase9_s=phase_s,
    )


def block_linears(cfg) -> int:
    """Scaled-kernel linears per block: the four attention projections and,
    in the dense family, the MLP's three (SwiGLU) or two (Granite's GELU
    MLP: up and down, with biases).  MoE experts and the router stay bf16:
    ``quantize_params_int8`` rewrites only ``{"w"}`` linears whose last two
    dims are both >= 256."""
    if cfg.moe.n_experts:
        return 4
    return 7 if cfg.act == "swiglu" else 6


def scaled_linears(cfg) -> int:
    """Scaled-kernel launches per LM decode call: every block's and the head."""
    return block_linears(cfg) * cfg.n_layers + 1


def distinct_shapes(lin):
    """(name, K, N) of every distinct shape among the linears ``lin``,
    linears of one shape named together."""
    names: dict[tuple[int, int], list[str]] = {}
    for name, k, n in lin:
        names.setdefault((k, n), []).append(name)
    return [("/".join(v), k, n) for (k, n), v in names.items()]


def lm_decode_shapes(cfg):
    """(name, K, N) of every distinct scaled linear of one LM decode call."""
    d, q, kv = cfg.d_model, cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    lin = [("wq", d, q), ("wo", q, d), ("wk", d, kv), ("wv", d, kv)]
    if not cfg.moe.n_experts:
        lin += [("w_gate", d, cfg.d_ff)] if cfg.act == "swiglu" else []
        lin += [("w_up", d, cfg.d_ff), ("w_down", cfg.d_ff, d)]
    return distinct_shapes(lin + [("head", d, cfg.vocab)])


def lm_serving(torch, np, dev, cfg, *, tag="lm", label="Yi-6B", expect=225, batch=LM_BATCH,
               params=None, prompt_len=(4, 9), int8_min_dim=256):
    """An LM at full width served through ``Engine.run``: main path 2
    (Yi-6B) and, for the moe family, main path 6 (OLMoE-1B-7B).  ``batch``
    requests of ``prompt_len`` (low, high: numpy's ``integers``) prompt
    tokens (numpy seed 0) in as many slots; ``params``: the model's weights
    already on the card (else drawn, every linear whose last two dims are
    both at least ``int8_min_dim`` quantized to int8).  The
    recorded call's logits are held to the Horner route's at ``LM_BATCH``
    (quirk 1: one activation scale per tensor against one per row, a gap
    that grows with the rows one scale spans) and printed at other batches.

    Returns what the times and phase 11 need: the recorded decode call's
    scaled-kernel calls (and, for MoE, each layer's MoE block input and
    output in that call), the params, and the path's launch counts."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core import bitplane
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer
    from repro_torch.obs.events import RecordingSink
    from repro_torch.serve import Engine, Request
    from repro_torch.serve.engine import lm_schedule_from_params

    t0 = time.perf_counter()
    if params is None:
        params = transformer.init_params(0, cfg, device=dev, int8_min_dim=int8_min_dim)
        torch.cuda.synchronize()
    blocks = params["blocks"]
    linears = [blocks["attn"][n] for n in ("wq", "wk", "wv", "wo")] + \
        [blocks["mlp"][n] for n in ("w_gate", "w_up", "w_down") if n in blocks.get("mlp", {})] + \
        [params["head"]]
    check(all("w_q" in p and "w" not in p for p in linears),
          f"a {label} linear stayed in float after quantize_params_int8")
    n_weights = sum(p["w_q"].numel() for p in linears)
    n_experts = 0
    if cfg.moe.n_experts:
        m = blocks["moe"]
        check(all(m[n].dtype == torch.bfloat16 for n in ("w_gate", "w_up", "w_down"))
              and set(m["router"]) == {"w"}, "the MoE experts or router left bf16")
        n_experts = sum(m[n].numel() for n in ("w_gate", "w_up", "w_down"))
    print(f"[{tag}] {label} params on the card in {time.perf_counter() - t0:.1f} s: "
          f"{n_weights / 1e9:.3f} G int8 weights"
          + (f", {n_experts / 1e9:.3f} G bf16 expert weights" if n_experts else "")
          + f", {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    sched = lm_schedule_from_params(params, cfg, 0.05)
    print(f"[{tag}] {sched.describe()}")
    kcfg = cfg.replace(quant=QuantConfig(mode="mma_int8", impl="kernel",
                                         plane_schedule=sched.planes))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(*prompt_len, batch)]
    engine = Engine(kcfg, params, batch=batch, max_seq=LM_MAX_SEQ, device=dev)
    engine.obs = RecordingSink()

    # Record the first decode step (every slot active, all prompts in the
    # cache): its inputs, a copy of the cache before it, every scaled-kernel
    # call it makes and every MoE block's input and output.  Recording adds
    # no launch.
    record_at = sum(len(p) for p in prompts)
    rec = {"moe": []}
    decode, moe_ffn = engine.decode_fn, moe_lib.moe_ffn

    def recording_moe(p, x, c):
        out = moe_ffn(p, x, c)
        rec["moe"].append((x, out))
        return out

    def counted_decode(p, toks, cache, idx, extras):
        n = rec.setdefault("n", 0)
        rec["n"] = n + 1
        if n != record_at:
            return decode(p, toks, cache, idx, extras)
        rec["args"] = (toks.copy(), {k: v.clone() for k, v in cache.items()}, idx.copy())
        moe_lib.moe_ffn = recording_moe
        try:
            with recorded_calls(rec):
                logits, cache = decode(p, toks, cache, idx, extras)
        finally:
            moe_lib.moe_ffn = moe_ffn
        rec["logits"] = logits.clone()
        return logits, cache

    engine.decode_fn = counted_decode
    mk.launches = 0
    mk.scaled_launches = 0
    t0 = time.perf_counter()
    done = engine.run([Request(i, p, max_new=LM_MAX_NEW) for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, unscaled = mk.scaled_launches, mk.launches
    calls = rec["n"]
    per_call = scaled_linears(cfg)
    check(per_call == expect, f"{per_call} linears per decode call, expected {expect}")
    check(launches == per_call * calls,
          f"{launches} scaled-kernel launches for {calls} decode calls, expected {per_call} each")
    check(unscaled == 0, f"{unscaled} unscaled-kernel launches: a linear missed quantization")
    check(len(done) == batch and all(r.done and len(r.out) == LM_MAX_NEW for r in done),
          "not every request finished with its token budget")
    check(all(0 <= t < cfg.vocab for r in done for t in r.out), "a token outside the vocabulary")
    steps = sum(1 for e in engine.obs.events if e.etype == "lm-step")
    print(f"[{tag}] Engine.run: {len(done)} requests, prompts {[len(p) for p in prompts]}, "
          f"{calls} decode calls ({record_at} prefill + {calls - record_at} step; "
          f"{steps} lm-step events), {launches} scaled-kernel launches "
          f"({launches // calls} per call), {wall_s:.2f} s host wall "
          f"({wall_s / calls * 1e3:.1f} ms per decode call)")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"[{tag}] request {r.rid}: prompt {r.prompt.tolist()} -> tokens {r.out}")

    # the recorded call: every scaled linear bit for bit against the plain
    # version, and within a few ulp of the Horner path's epilogue
    check(len(rec["scaled"]) == per_call, f"{len(rec['scaled'])} scaled calls recorded")
    check(len(rec["moe"]) == (cfg.n_layers if cfg.moe.n_experts else 0),
          f"{len(rec['moe'])} MoE blocks recorded")
    epi = 0.0
    for x, w, xs, ws, planes, out in rec["scaled"]:
        k, n = w.shape
        x2, o2 = x.reshape(-1, k), out.reshape(-1, n)
        want = mk.mma_matmul_scaled_plain(x2, w, xs, ws, planes=planes)
        check(torch.equal(o2, want), f"recorded call: scaled linear K={k} N={n} != plain")
        horner = bitplane.bitplane_matmul(x2, w, planes=planes).to(torch.float32) \
            * (xs.reshape(()) * ws.reshape(-1))
        epi = max(epi, float(((o2 - horner).abs() / horner.abs().clamp(min=1e-30)).max()))
    check(epi <= EPILOGUE_RTOL, f"recorded call: epilogue vs Horner order, rel {epi}")
    toks, cache, idx = rec["args"]
    hcfg = kcfg.replace(quant=dataclasses.replace(kcfg.quant, impl="horner"))
    lh, _ = transformer.decode_step(params, toks, cache, idx, hcfg, device=dev)
    lk = rec["logits"]
    check(lk.shape == (batch, 1, cfg.vocab) and bool(torch.isfinite(lk).all()),
          f"recorded call: logits {tuple(lk.shape)} not finite or of the wrong shape")
    lkf, lhf = lk.to(torch.float32), lh.to(torch.float32)
    rel = float((lkf - lhf).abs().max() / lhf.abs().max())
    agree = float((lkf.argmax(-1) == lhf.argmax(-1)).to(torch.float32).mean())
    check(batch != LM_BATCH or rel <= LM_LOGIT_REL,
          f"recorded call: logits kernel vs Horner differ by {rel} (rel)")
    print(f"[{tag}] recorded decode call: {per_call} scaled linears bit-exact against the plain "
          f"version, epilogue vs Horner order max rel {epi:.3g}; logits vs Horner path max rel "
          f"{rel:.4f} ({f'limit {LM_LOGIT_REL}' if batch == LM_BATCH else 'not gated'} at batch "
          f"{batch}), top-1 agreement {agree:.2f}, "
          f"max |logit| {float(lhf.abs().max()):.3f}")
    return dict(calls=rec["scaled"], moe=rec["moe"], params=params, launches=launches,
                unscaled=unscaled, wall_s=wall_s, decode_calls=calls, logits_rel=rel)


def scaled_library(torch, x, w, xs, ws, planes):
    """The scaled kernel's library yardstick: ``torch._int_mm`` on the
    truncated operand, then the same epilogue.  ``_int_mm`` wants M > 16, so
    up to 16 rows x is padded to 32 (those rows are computed and dropped);
    above 16 it runs at M."""
    from repro_torch.core import bitplane

    m, k = x.shape
    xp = torch.zeros((m if m > 16 else 32, k), dtype=torch.int8, device=x.device)
    xp[:m] = bitplane.truncate_to_planes(x, planes)
    return lambda: torch._int_mm(xp, w)[:m].to(torch.float32) * xs.reshape(()) * ws.reshape(-1)


def scaled_bound(shapes):
    """The scaled kernel's bound over ``(M, K, N)`` calls: each input read
    once (x, w, the scales), the float32 output written once, at the HBM
    rate; 2MKN int8 operations at the int8 tensor-core peak.  ``(ms, what
    bounds it, bytes, operations)``."""
    nbytes = sum(m * k + k * n + 4 * n + 4 + 4 * m * n for m, k, n in shapes)
    nops = sum(2 * m * k * n for m, k, n in shapes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes, nops


def rotating(fns):
    """One call per graph slot, cycling through ``fns``."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def cold_shape_times(torch, dev, g, m, k, n, planes):
    """The scaled kernel on one (m, k) @ (k, n) shape with w cold in L2, from
    CUDA-graph replays: a graph of calls cycling through enough copies of w
    that it never finds one in L2.  Returns the kernel's ms at each of
    ``planes``, ``torch._int_mm`` + scale's ms (at ``planes[0]``, checked
    equal to the kernel's output first), the plain version's ms, and the
    copies and calls per graph."""
    from repro_torch.bench.table1 import graph_ms
    from repro_torch.kernels import mma_matmul as mk

    copies = -(-2 * L2_BYTES // (k * n))
    calls = max(20, copies)
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=dev, generator=g)
    ws_ = [torch.randint(-128, 128, (k, n), dtype=torch.int8, device=dev, generator=g)
           for _ in range(copies)]
    xs = torch.full((1,), 0.01, device=dev)
    wsc = torch.rand(n, device=dev, generator=g) * 0.01 + 1e-4
    libs = [scaled_library(torch, x, w, xs, wsc, planes[0]) for w in ws_]
    check(torch.equal(libs[0](), mk.mma_matmul_scaled_kernel(x, ws_[0], xs, wsc,
                                                            planes=planes[0])),
          f"M={m} K={k} N={n}: library yardstick disagrees with the scaled kernel")
    ms_planes = {p: graph_ms(torch, rotating([
        lambda w=w, p=p: mk.mma_matmul_scaled_kernel(x, w, xs, wsc, planes=p) for w in ws_]),
        calls=calls) for p in planes}
    lib_ms = graph_ms(torch, rotating(libs), calls=calls)
    plain_ms = time_ms(torch, lambda: mk.mma_matmul_scaled_plain(x, ws_[0], xs, wsc,
                                                                 planes=planes[0]),
                       reps=3, warmup=1)
    return ms_planes, lib_ms, plain_ms, copies, calls


def cold_unscaled_times(torch, dev, g, m, k, n, planes=8) -> dict:
    """The unscaled kernel on one (m, k) @ (k, n) shape with w cold in L2, as
    ``cold_shape_times`` times the scaled kernel, against ``torch._int_mm``
    on the same operands (``_int_mm`` wants M > 16: up to 16 rows x is
    padded to 32, those rows computed and dropped), the bound (x and w read
    once, the int32 out written once; 2MKN int8 operations) and the
    plane-work floor (``planes`` x the operations)."""
    from repro_torch.bench.table1 import graph_ms
    from repro_torch.kernels import mma_matmul as mk

    copies = -(-2 * L2_BYTES // (k * n))
    calls = max(20, copies)
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=dev, generator=g)
    ws_ = [torch.randint(-128, 128, (k, n), dtype=torch.int8, device=dev, generator=g)
           for _ in range(copies)]
    xp = torch.zeros((m if m > 16 else 32, k), dtype=torch.int8, device=dev)
    xp[:m] = x
    check(torch.equal(torch._int_mm(xp, ws_[0])[:m], mk.mma_matmul_kernel(x, ws_[0], planes=8)),
          f"M={m} K={k} N={n}: library yardstick disagrees with the unscaled kernel")
    ms = graph_ms(torch, rotating([lambda w=w: mk.mma_matmul_kernel(x, w, planes=planes)
                                   for w in ws_]), calls=calls)
    lib_ms = graph_ms(torch, rotating([lambda w=w: torch._int_mm(xp, w)[:m] for w in ws_]),
                      calls=calls)
    nbytes, nops = m * k + k * n + 4 * m * n, 2 * m * k * n
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT8_OPS_PER_S * 1e3
    return dict(M=m, K=k, N=n, planes=planes, ms=ms, library_ms=lib_ms, bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations", plane_floor_ms=planes * t_o,
                w_copies=copies, calls=calls)


def lm_times(torch, dev, card, lm, decode_shapes, label="Yi-6B"):
    """The scaled kernel's times, from CUDA-graph replays: per decode shape
    at 8, 5 and 1 planes with w cold in L2, and per decode call, replaying
    the recorded call's kernel calls (225 for Yi-6B, 65 for OLMoE-1B-7B)."""
    from repro_torch.bench.table1 import graph_ms
    from repro_torch.kernels import mma_matmul as mk

    g = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_shape = []
    for name, k, n in decode_shapes:
        m = LM_BATCH
        ms_planes, lib_ms, plain_ms, copies, calls = cold_shape_times(torch, dev, g, m, k, n,
                                                                      (8, 5, 1))
        ms = ms_planes[8]
        b_ms, b_by, nbytes, nops = scaled_bound([(m, k, n)])
        splits = mk.split_k(m, k, n, sms)
        per_shape.append(dict(name=name, M=m, K=k, N=n, ms=ms, ms_planes=ms_planes,
                              plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                              bytes=nbytes, ops=nops, splits=splits, w_copies=copies))
        print(f"[time] {card} | mma_matmul_scaled {label} {name} M={m} K={k} N={n} ({splits} K splits; "
              f"graph of {calls} calls over {copies} copies of w, {calls * k * n / 2**20:.0f} MiB "
              f"of distinct w per replay, > the {L2_BYTES >> 20} MiB L2: cold) planes 8: kernel "
              f"{ms:.5f} ms, plain {plain_ms:.4f} ms, torch._int_mm+scale {lib_ms:.5f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}), {nbytes / ms / 1e6:.0f} GB/s | planes 5: "
              f"{ms_planes[5]:.5f} ms, planes 1: {ms_planes[1]:.5f} ms")

    calls = [(x.reshape(-1, w.shape[0]), w, xs, ws, planes) for x, w, xs, ws, planes, _ in lm["calls"]]
    libs = [scaled_library(torch, *c) for c in calls]
    ms = graph_ms(torch, lambda: [mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=p)
                                  for x, w, xs, ws, p in calls], calls=1)
    lib_ms = graph_ms(torch, lambda: [f() for f in libs], calls=1)
    plain_ms = time_ms(torch, lambda: [mk.mma_matmul_scaled_plain(x, w, xs, ws, planes=p)
                                       for x, w, xs, ws, p in calls], reps=1, warmup=1)
    b_ms, b_by, nbytes, nops = scaled_bound([(x.shape[0], w.shape[0], w.shape[1])
                                             for x, w, *_ in calls])
    print(f"[time] {card} | mma_matmul_scaled one {label} decode call ({len(calls)} linears, the "
          f"schedule's planes, one CUDA graph; {nbytes / 1e9:.3f} GB of distinct w: cold): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms, torch._int_mm+scale {lib_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}; {nops / 1e9:.1f} G int8 ops), {nbytes / ms / 1e6:.0f} GB/s | "
          f"Engine.run host wall {lm['wall_s']:.2f} s for {lm['decode_calls']} decode calls")
    return dict(
        name="mma_matmul_scaled", route="cuda", source="src/repro_torch/csrc/mma_matmul.cu",
        replaces="src/repro/kernels/mma_matmul.py:163", launches=lm["launches"],
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms,
        work=f"one {label} decode call at batch {LM_BATCH}: {len(calls)} linears at the "
             f"schedule's planes, replayed from the served run as one CUDA graph",
        lm_wall_s=lm["wall_s"], lm_decode_calls=lm["decode_calls"], per_shape=per_shape,
    )


def moe_card_vs_cpu(torch, p, x, cfg, y=None):
    """One MoE block on the card against the CPU.  The card's routing
    (``_local_dispatch`` on the card's router logits) must equal the CPU's
    on those logits copied over: expert ids, positions, kept mask, token
    order, ``cap`` and the dispatch buffer.  The card's ``moe_ffn`` output
    (and ``y``, the served block's output, bit for bit) must be within
    ``MOE_REL`` of the CPU's experts and combine on that routing."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer

    m, d = cfg.moe, cfg.d_model
    t = x.numel() // d
    cap = moe_lib.capacity(t, m)
    xf = x.reshape(t, d)
    out = moe_lib.moe_ffn(p, x, cfg).reshape(t, d)
    if y is not None:
        check(torch.equal(out, y.reshape(t, d)),
              "the served MoE block's output differs from moe_ffn on its input")
    logits = moe_lib.router_logits(p, xf)
    xe_g, meta_g = moe_lib._local_dispatch(xf, logits, m.n_experts, m.top_k, cap, xf.dtype)
    pc = transformer.params_to(p, "cpu")
    xe_c, meta_c = moe_lib._local_dispatch(xf.cpu(), logits.cpu(), m.n_experts, m.top_k, cap,
                                           xf.dtype)
    for i, what in ((0, "expert ids"), (1, "positions"), (2, "token order"), (4, "kept mask")):
        check(torch.equal(meta_g[i].cpu(), meta_c[i]), f"MoE T={t}: card {what} != CPU's")
    check(xe_g.shape == (m.n_experts, cap, d) and torch.equal(xe_g.cpu(), xe_c),
          f"MoE T={t}: the card's dispatch buffer != CPU's")
    gate_diff = float((meta_g[3].cpu() - meta_c[3]).abs().max())
    want = moe_lib._local_combine(moe_lib.expert_ffn(pc, xe_c), meta_c, t, cap, xf.dtype)
    wf = want.to(torch.float32)
    rel = float((out.cpu().to(torch.float32) - wf).abs().max() / wf.abs().max())
    check(bool(torch.isfinite(out).all()) and rel <= MOE_REL,
          f"MoE T={t}: card output vs CPU, max rel {rel} (limit {MOE_REL})")
    # not gated: the CPU's own bf16 router product against the card's
    own = moe_lib.router_logits(pc, xf.cpu())
    return dict(t=t, cap=cap, assignments=t * m.top_k, dropped=int((~meta_g[4]).sum()),
                rel=rel, gate_max_diff=gate_diff,
                router_logits_differ=int((own != logits.cpu()).sum()))


def moe_blocks_time(torch, card, cfg, moe_p, recorded, label):
    """Device time of one decode call's MoE blocks: the recorded call's
    blocks (``recorded``: each layer's (input, output)) replayed as one CUDA
    graph, against their bound: each block reads every expert's weights.
    Returns (ms, bound ms, bytes)."""
    from repro_torch.bench.table1 import graph_ms
    from repro_torch.models import moe as moe_lib

    m, d, f = cfg.moe, cfg.d_model, cfg.moe.expert_ff
    ms = graph_ms(torch, lambda: [moe_lib.moe_ffn(p, x, cfg) for p, (x, _) in
                                  zip(moe_p, recorded)], calls=1)
    t = recorded[0][0].numel() // d
    nbytes = cfg.n_layers * (3 * m.n_experts * d * f * 2 + d * m.n_experts * 2 + 2 * t * d * 2)
    nops = cfg.n_layers * (2 * t * d * m.n_experts + 3 * 2 * t * m.top_k * d * f)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / BF16_OPS_PER_S * 1e3
    b_ms = max(t_bytes, t_ops)
    print(f"[time] {card} | {label} MoE blocks of one decode call ({cfg.n_layers} blocks at "
          f"T={t}, one CUDA graph; stock PyTorch): {ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'}: {nbytes / 1e9:.3f} GB at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), {nbytes / ms / 1e6:.0f} GB/s")
    return ms, b_ms, nbytes


def moe_serving(torch, np, dev, card, cfg):
    """Phase 11, MoE serving (main path 6): OLMoE-1B-7B at full width and
    depth through ``Engine.run``, its MoE blocks on the card against the
    CPU, and its times."""
    from repro_torch.models import transformer

    t_phase = time.perf_counter()
    m = cfg.moe
    lm = lm_serving(torch, np, dev, cfg, tag="moe", label="OLMoE-1B-7B", expect=65)
    blocks = lm["params"]["blocks"]
    moe_p = [transformer.layer_params(blocks, l)["moe"] for l in range(cfg.n_layers)]

    # the recorded call's last MoE block (T = batch: dropless by the floor of 4)
    x_rec, y_rec = lm["moe"][-1]
    rec = moe_card_vs_cpu(torch, moe_p[-1], x_rec, cfg, y_rec)
    # layer 0 on T = 64 tokens from a numpy seed: cap 10 of 512 assignments
    x64 = torch.from_numpy(np.random.default_rng(MOE_T).standard_normal(
        (1, MOE_T, cfg.d_model)).astype(np.float32)).to(torch.bfloat16).to(dev)
    wide = moe_card_vs_cpu(torch, moe_p[0], x64, cfg)
    check(wide["cap"] == 10 and wide["assignments"] == 512 and wide["dropped"] >= 1,
          f"MoE T={MOE_T}: cap {wide['cap']}, {wide['assignments']} assignments, "
          f"{wide['dropped']} dropped (expected cap 10, 512, at least one drop)")
    for name, r in (("recorded call, last layer", rec), (f"layer 0 at T={MOE_T}", wide)):
        print(f"[moe] MoE block card vs CPU ({name}): T={r['t']} cap {r['cap']}, "
              f"{r['assignments']} assignments, {r['dropped']} dropped; routing and dispatch "
              f"buffer equal, gate weights max diff {r['gate_max_diff']:.3g}; output max rel "
              f"{r['rel']:.3g} (limit {MOE_REL}); the CPU's own router product differs from "
              f"the card's in {r['router_logits_differ']} of {r['t'] * cfg.moe.n_experts} logits "
              f"(not gated)")

    ms, b_ms, nbytes = moe_blocks_time(torch, card, cfg, moe_p, lm["moe"], "OLMoE-1B-7B")
    times = lm_times(torch, dev, card, lm, lm_decode_shapes(cfg), label="OLMoE-1B-7B")

    # the same weights at batch MOE_DROP_BATCH: the recorded decode call's 16
    # blocks route 20 tokens each at cap MOE_DROP_CAP, and drop.  Prompts of
    # one token: the engine prefills token by token, one call each
    drop_lm = lm_serving(torch, np, dev, cfg, tag="moe",
                         label=f"OLMoE-1B-7B at batch {MOE_DROP_BATCH}", expect=65,
                         batch=MOE_DROP_BATCH, params=lm["params"], prompt_len=(1, 2))
    drop_blocks = [moe_card_vs_cpu(torch, p, x, cfg, y)
                   for p, (x, y) in zip(moe_p, drop_lm["moe"])]
    per_layer = [r["dropped"] for r in drop_blocks]
    check(all(r["t"] == MOE_DROP_BATCH and r["cap"] == MOE_DROP_CAP
              and r["assignments"] == MOE_DROP_BATCH * m.top_k for r in drop_blocks)
          and sum(per_layer) >= 1,
          f"MoE at batch {MOE_DROP_BATCH}: blocks of T {[r['t'] for r in drop_blocks]}, cap "
          f"{[r['cap'] for r in drop_blocks]}, dropped per layer {per_layer} (expected T "
          f"{MOE_DROP_BATCH}, cap {MOE_DROP_CAP} and at least one drop)")
    print(f"[moe] {card} | OLMoE-1B-7B at batch {MOE_DROP_BATCH}, the recorded decode call's "
          f"{cfg.n_layers} MoE blocks (T={MOE_DROP_BATCH}, cap {MOE_DROP_CAP} of "
          f"{MOE_DROP_BATCH * m.top_k} assignments each): dropped per layer {per_layer}, "
          f"{sum(per_layer)} in all; every block's output equal to moe_ffn on its input bit for "
          f"bit; routing and dispatch buffer card = CPU on the card's router logits; output max "
          f"rel {max(r['rel'] for r in drop_blocks):.3g} (limit {MOE_REL}); the CPU's own router "
          f"product differs from the card's in "
          f"{sum(r['router_logits_differ'] for r in drop_blocks)} of "
          f"{cfg.n_layers * MOE_DROP_BATCH * m.n_experts} logits (not gated)")
    phase_s = time.perf_counter() - t_phase
    print(f"[moe] phase 11 took {phase_s:.1f} s")
    return dict(
        launches_moe=lm["launches"], moe_decode_calls=lm["decode_calls"],
        moe_wall_s=lm["wall_s"], moe_logits_rel=lm["logits_rel"], moe_call_ms=times["ms"],
        moe_call_plain_ms=times["plain_ms"], moe_call_library_ms=times["library_ms"],
        moe_call_bound_ms=times["bound_ms"], moe_per_shape=times["per_shape"],
        moe_blocks_ms=ms, moe_blocks_bound_ms=b_ms, moe_blocks_bytes=nbytes,
        moe_recorded=rec, moe_wide=wide, phase11_s=phase_s,
        launches_moe_drops=drop_lm["launches"], moe_drops_wall_s=drop_lm["wall_s"],
        moe_drops_decode_calls=drop_lm["decode_calls"], moe_drops_logits_rel=drop_lm["logits_rel"],
        moe_drops_per_layer=per_layer,
    )


def recurrent_launches(cfg) -> tuple[int, int, int]:
    """(scaled, unscaled, Horner) MMA calls per decode call of a recurrent
    family.  RWKV6: the time-mix's wr/wk/wv/wg/wo and the channel-mix's
    wk/wv/wr per layer, and the head, on the scaled kernel; ``mix_lora_a``
    (int8, called without the quant config) on the Horner route, one per
    layer.  Zamba2: z/xbc/out_proj per Mamba2 layer, the shared block's
    wq/wk/wv/wo/proj at each of its uses and the head on the scaled kernel;
    ``dt_proj`` (d_model x heads, below 256 wide: bf16) through
    ``mma_linear``, the unscaled kernel."""
    if cfg.family == "ssm":
        return 8 * cfg.n_layers + 1, 0, cfg.n_layers
    return 3 * cfg.n_layers + 5 * (cfg.n_layers // cfg.attn_every) + 1, cfg.n_layers, 0


def recurrent_decode_shapes(cfg):
    """(name, K, N) of every distinct scaled linear of a recurrent family's
    decode call."""
    d = cfg.d_model
    if cfg.family == "ssm":
        lin = [(n, d, d) for n in ("wr", "wk", "wv", "wg", "wo", "cm.wr")] + \
            [("cm.wk", d, cfg.d_ff), ("cm.wv", cfg.d_ff, d)]
    else:
        d_inner = cfg.ssm_expand * d
        lin = [("z_proj", d, d_inner), ("xbc_proj", d, d_inner + 2 * cfg.ssm_state),
               ("out_proj", d_inner, d)] + \
            [(f"shared.{n}", 2 * d, 2 * d) for n in ("wq", "wk", "wv", "wo")] + \
            [("shared.proj", 2 * d, d)]
    return distinct_shapes(lin + [("head", d, cfg.vocab)])


def unscaled_call_times(torch, card, calls, label):
    """The unscaled kernel over a decode call's recorded calls ``(x, w,
    planes)``, from CUDA-graph replays: the calls cycled over enough copies
    of their w that a replay reads more than the L2 holds (w cold), against
    ``torch._int_mm`` on the truncated operand (x padded to 32 rows: it
    wants M > 16) and the bound."""
    from repro_torch.bench.table1 import graph_ms
    from repro_torch.core import bitplane
    from repro_torch.kernels import mma_matmul as mk

    w_bytes = sum(w.numel() for _, w, _ in calls)
    copies = max(1, -(-2 * L2_BYTES // w_bytes))
    sets = [[(x, w.clone(), p) for x, w, p in calls] for _ in range(copies)]
    libs = []
    for x, w, p in calls:
        xp = torch.zeros((32, x.shape[1]), dtype=torch.int8, device=x.device)
        xp[:x.shape[0]] = bitplane.truncate_to_planes(x, p)
        check(torch.equal(torch._int_mm(xp, w)[:x.shape[0]], mk.mma_matmul_kernel(x, w, planes=p)),
              f"{label}: library yardstick disagrees with the unscaled kernel")
        libs.append(lambda xp=xp, w=w: torch._int_mm(xp, w))
    ms = graph_ms(torch, lambda: [mk.mma_matmul_kernel(x, w, planes=p)
                                  for cs in sets for x, w, p in cs], calls=1) / copies
    lib_ms = graph_ms(torch, lambda: [f() for f in libs], calls=1)
    plain_ms = time_ms(torch, lambda: [mk.mma_matmul_plain(x, w, planes=p) for x, w, p in calls],
                       reps=1, warmup=1)
    nbytes = sum(x.numel() + w.numel() + 4 * x.shape[0] * w.shape[1] for x, w, _ in calls)
    nops = sum(2 * x.shape[0] * w.shape[0] * w.shape[1] for x, w, _ in calls)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT8_OPS_PER_S * 1e3
    b_ms, b_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    m, k, n = calls[0][0].shape[0], calls[0][1].shape[0], calls[0][1].shape[1]
    print(f"[time] {card} | mma_matmul one {label} decode call ({len(calls)} calls at M={m} K={k} "
          f"N={n}, planes {calls[0][2]}; one CUDA graph over {copies} copies of w, "
          f"{copies * w_bytes / 2**20:.0f} MiB: cold): kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"torch._int_mm {lib_ms:.4f} ms (32 rows), bound {b_ms:.5f} ms ({b_by}), "
          f"{nbytes / ms / 1e6:.0f} GB/s")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, ops=nops, w_copies=copies)


def _rel(a, b) -> float:
    """max |a - b| over the largest |b|, in float32."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def recurrent_block_card_vs_cpu(torch, mod, rec, cfg):
    """The recorded call's block (RWKV6's last block; Zamba2's last Mamba2
    layer) on the CPU from the card's inputs: output and new state within
    ``RECURRENT_BLOCK_REL`` of the card's (the card's own call repeated on
    its inputs must give its recorded output bit for bit)."""
    from repro_torch.models import layers, mamba2, rwkv6

    p, x, state, out, new = rec
    if mod is rwkv6:
        def run(p_, x_, st_):
            return rwkv6.block(p_, x_, cfg, state=st_)
        names = ("tm_s", "tm_x", "cm_x")
    else:
        def run(p_, x_, st_):
            o, ns = mamba2.mamba_forward(p_, x_, cfg, state=st_)
            return o, (ns["conv"], ns["ssm"])
        state = dict(state)
        names = ("conv", "ssm")
    again, _ = run(p, x, state)
    check(torch.equal(again, out), "the card's block, repeated on its inputs, differs")
    cpu = layers.params_to
    st_c = tuple(t.cpu() for t in state) if isinstance(state, tuple) else cpu(state, "cpu")
    out_c, new_c = run(cpu(p, "cpu"), x.cpu(), st_c)
    rels = {"out": _rel(out.cpu(), out_c)}
    new = new if isinstance(new, tuple) else (new["conv"], new["ssm"])
    for name, g_, c_ in zip(names, new, new_c):
        rels[name] = _rel(g_.cpu(), c_)
    check(all(r <= RECURRENT_BLOCK_REL for r in rels.values()),
          f"block card vs CPU: max rel {rels} (limit {RECURRENT_BLOCK_REL})")
    return rels


def recurrent_serving(torch, np, dev, card, cfg, *, tag, label, phase):
    """Phases 12-13: a recurrent family (RWKV6-3B, Zamba2-7B) at full width
    and depth through ``Engine.run`` on the kernel route at
    ``RECURRENT_PLANES``, its checks and its times.  Returns the two
    kernels' entries for this path."""
    from repro_torch import models
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core import mma
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.models import layers, mamba2, rwkv6
    from repro_torch.obs.events import RecordingSink
    from repro_torch.serve import Engine, Request

    t_phase = time.perf_counter()
    mod = models.build(cfg)
    t0 = time.perf_counter()
    params = mod.init_params(0, cfg, device=dev, int8_min_dim=256)
    torch.cuda.synchronize()
    leaves = []
    layers.tree_map(leaves.append, params)
    n_int8 = sum(t.numel() for t in leaves if t.dtype == torch.int8)
    n_float = sum(t.numel() for t in leaves if t.dtype != torch.int8)
    print(f"[{tag}] {label} params on the card in {time.perf_counter() - t0:.1f} s: "
          f"{n_int8 / 1e9:.3f} G int8 weights, {n_float / 1e6:.1f} M float leaves, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    kcfg = cfg.replace(quant=QuantConfig(mode="mma_int8", impl="kernel", planes=RECURRENT_PLANES))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(4, 9, LM_BATCH)]
    engine = Engine(kcfg, params, batch=LM_BATCH, max_seq=LM_MAX_SEQ, device=dev)
    engine.obs = RecordingSink()

    # Record the first decode step (every slot active, all prompts in):
    # its inputs, a copy of the state before it, every kernel call it makes
    # and its last block's inputs and outputs.  Recording adds no launch.
    record_at = sum(len(p) for p in prompts)
    rec = {"n": 0}
    decode = engine.decode_fn
    block_fn = (rwkv6, "block") if mod is rwkv6 else (mamba2, "mamba_forward")
    inner_block = getattr(*block_fn)

    def recording_block(p, x, c, *, state=None):
        out, new = inner_block(p, x, c, state=state)
        rec["block"] = (p, x, state, out, new)
        return out, new

    def counted_decode(p, toks, cache, idx, extras):
        n = rec["n"]
        rec["n"] = n + 1
        if n != record_at:
            return decode(p, toks, cache, idx, extras)
        rec["args"] = (toks.copy(), layers.tree_map(torch.clone, cache), idx)
        setattr(*block_fn, recording_block)
        try:
            with recorded_calls(rec):
                logits, cache = decode(p, toks, cache, idx, extras)
        finally:
            setattr(*block_fn, inner_block)
        rec["logits"] = logits.clone()
        return logits, cache

    # the int8 linears on the Horner route (no kernel), counted
    dot, horner = mma.mma_dot, []

    def counted_dot(*a, **kw):
        if kw.get("impl") == "horner":
            horner.append(1)
        return dot(*a, **kw)

    engine.decode_fn = counted_decode
    mma.mma_dot = counted_dot
    mk.launches = 0
    mk.scaled_launches = 0
    t0 = time.perf_counter()
    try:
        done = engine.run([Request(i, p, max_new=LM_MAX_NEW) for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
    finally:
        mma.mma_dot = dot
    wall_s = time.perf_counter() - t0
    launches, launches_u = mk.scaled_launches, mk.launches
    calls = rec["n"]
    per_s, per_u, per_h = recurrent_launches(cfg)
    check(launches == per_s * calls and launches_u == per_u * calls and len(horner) == per_h * calls,
          f"{launches} scaled and {launches_u} unscaled launches and {len(horner)} Horner-route "
          f"linears for {calls} decode calls, expected {per_s}, {per_u} and {per_h} each")
    check(len(done) == LM_BATCH and all(r.done and len(r.out) == LM_MAX_NEW for r in done),
          "not every request finished with its token budget")
    check(all(0 <= t < cfg.vocab for r in done for t in r.out), "a token outside the vocabulary")
    print(f"[{tag}] Engine.run: {len(done)} requests, prompts {[len(p) for p in prompts]}, "
          f"{calls} decode calls ({record_at} prefill + {calls - record_at} step), {launches} "
          f"scaled and {launches_u} unscaled launches ({per_s} and {per_u} per call), "
          f"{len(horner)} int8 linears on the Horner route ({per_h} per call), "
          f"{wall_s:.2f} s host wall ({wall_s / calls * 1e3:.1f} ms per decode call)")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"[{tag}] request {r.rid}: prompt {r.prompt.tolist()} -> tokens {r.out}")

    # the recorded call: every kernel call bit for bit against the plain
    # version; its logits against the same call on the Horner route
    check(len(rec["scaled"]) == per_s and len(rec["unscaled"]) == per_u,
          f"{len(rec['scaled'])} scaled and {len(rec['unscaled'])} unscaled calls recorded")
    recorded_kernels_exact(torch, rec, "recorded call")
    # The recorded call's logits, kernel route vs Horner route from the same
    # state: at the served planes measured, not gated; at 8 planes gated
    # (quirk 1: the kernel route's one activation scale per tensor and the
    # Horner route's per-row scales are different int8 grids, and at 5
    # planes every level the truncation drops is 2**3 of a full one; on
    # RWKV6's squared-ReLU activations that gap grows with depth past
    # LM_LOGIT_REL)
    toks, state, idx = rec["args"]
    lk = rec["logits"]
    check(lk.shape == (LM_BATCH, 1, cfg.vocab) and bool(torch.isfinite(lk).all()),
          f"recorded call: logits {tuple(lk.shape)} not finite or of the wrong shape")
    gaps = {}
    for planes in (RECURRENT_PLANES, 8):
        q = dataclasses.replace(kcfg.quant, planes=planes)
        if planes != RECURRENT_PLANES:
            lk, _ = mod.decode_step(params, toks, layers.tree_map(torch.clone, state), idx,
                                    kcfg.replace(quant=q), device=dev)
        lh, _ = mod.decode_step(params, toks, layers.tree_map(torch.clone, state), idx,
                                kcfg.replace(quant=dataclasses.replace(q, impl="horner")),
                                device=dev)
        gaps[planes] = (_rel(lk, lh), float((lk.argmax(-1) == lh.argmax(-1)).float().mean()))
    rel = gaps[8][0]
    check(rel <= LM_LOGIT_REL, f"recorded call at 8 planes: logits kernel vs Horner differ by "
          f"{rel} (rel)")
    blk = recurrent_block_card_vs_cpu(torch, mod, rec["block"], kcfg)
    print(f"[{tag}] recorded decode call: {per_s} scaled and {per_u} unscaled kernel calls "
          f"bit-exact against the plain version; logits vs Horner route from its state, max rel "
          f"(top-1 agreement): at {RECURRENT_PLANES} planes {gaps[RECURRENT_PLANES][0]:.4f} "
          f"({gaps[RECURRENT_PLANES][1]:.2f}, not gated), at 8 planes {rel:.4f} ({gaps[8][1]:.2f}; "
          f"limit {LM_LOGIT_REL}); last block card vs CPU max rel "
          + ", ".join(f"{k} {v:.3g}" for k, v in blk.items()) + f" (limit {RECURRENT_BLOCK_REL})")

    lm = dict(calls=rec["scaled"], launches=launches, wall_s=wall_s, decode_calls=calls)
    times = lm_times(torch, dev, card, lm, recurrent_decode_shapes(cfg), label=label)
    out = {"scaled": {f"{tag}_{k}": times[k] for k in ("ms", "plain_ms", "library_ms",
                                                       "bound_ms", "per_shape")},
           "unscaled": {f"launches_{tag}": launches_u}}
    out["scaled"].update({f"launches_{tag}": launches, f"{tag}_wall_s": wall_s,
                          f"{tag}_decode_calls": calls,
                          f"{tag}_host_ms_per_call": wall_s / calls * 1e3,
                          f"{tag}_logits_rel": {p: g[0] for p, g in gaps.items()},
                          f"{tag}_block_rel": blk})
    if per_u:
        ut = unscaled_call_times(torch, card, [(x, w, p) for x, w, p, _ in rec["unscaled"]], label)
        out["unscaled"].update({f"{tag}_{k}": v for k, v in ut.items()})
    phase_s = time.perf_counter() - t_phase
    print(f"[{tag}] phase {phase} took {phase_s:.1f} s")
    out["scaled"][f"phase{phase}_s"] = phase_s
    return out


def whisper_launches(cfg) -> tuple[int, int, int]:
    """Scaled-kernel launches of Whisper's serving path: the encoder (six
    linears per layer: q/k/v/o and the MLP's up and down), the cross K/V
    projection (k and v of every decoder layer) and one decode call (eight
    per decoder layer: self-attention q/k/v/o, cross-attention q/o, the MLP;
    the head is the tied embedding, a bf16 product)."""
    return 6 * (cfg.enc_layers or cfg.n_layers), 2 * cfg.n_layers, 8 * cfg.n_layers


def whisper_shapes(cfg):
    """(name, K, N) of every distinct scaled linear of Whisper (no head: it
    is the tied embedding)."""
    d, q, kv = cfg.d_model, cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    return distinct_shapes([("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d),
                            ("w_up", d, cfg.d_ff), ("w_down", cfg.d_ff, d)])


def device_idle(torch, fn):
    """``fn`` run once under ``torch.profiler`` (device activity only):
    (host wall ms, device busy ms: the union of kernel and copy intervals,
    idle share, {kernel name: [count, device ms]})."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.bench.table1 import busy_us

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = defaultdict(lambda: [0, 0.0])
    intervals = []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        s, e = evt.time_range.start, evt.time_range.end
        intervals.append((s, e))
        by_name[evt.name][0] += 1
        by_name[evt.name][1] += (e - s) / 1e3
    check(bool(intervals), "the profiler recorded no device activity")
    busy_ms = busy_us(intervals) / 1e3
    return wall_ms, busy_ms, 1 - busy_ms / wall_ms, dict(by_name)


def wide_calls_times(torch, card, calls, label):
    """The scaled kernel over recorded calls at prefill-sized M, replayed as
    one CUDA graph (w of every call distinct: cold), against ``torch._int_mm``
    + scale (the first call's output checked equal to the kernel's first),
    the bound and the plane-work floor (planes x 2MKN int8 operations at the
    tensor-core peak)."""
    from repro_torch.bench.table1 import graph_ms
    from repro_torch.kernels import mma_matmul as mk

    cs = [(x, w, xs, ws, p) for x, w, xs, ws, p, _ in calls]
    libs = [scaled_library(torch, *c) for c in cs]
    check(torch.equal(libs[0](), mk.mma_matmul_scaled_kernel(*cs[0][:4], planes=cs[0][4])),
          f"{label}: library yardstick disagrees with the scaled kernel")

    def kernel_pass():
        for x, w, xs, ws, p in cs:
            mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=p)

    def library_pass():
        for f in libs:
            f()

    ms = graph_ms(torch, kernel_pass, calls=1, reps=3)
    lib_ms = graph_ms(torch, library_pass, calls=1, reps=3)
    shapes = [(x.shape[0], w.shape[0], w.shape[1]) for x, w, *_ in cs]
    b_ms, b_by, nbytes, nops = scaled_bound(shapes)
    floor_ms = cs[0][4] * nops / INT8_OPS_PER_S * 1e3
    print(f"[time] {card} | mma_matmul_scaled {label} ({len(cs)} linears at M={shapes[0][0]}, "
          f"planes {cs[0][4]}, one CUDA graph; {sum(k * n for _, k, n in shapes) / 1e9:.3f} GB "
          f"of distinct w): kernel {ms:.4f} ms, torch._int_mm+scale {lib_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}; {nops / 1e12:.2f} T int8 ops, {nbytes / 1e9:.3f} GB), "
          f"plane-work floor {floor_ms:.4f} ms, {nops / ms / 1e9:.1f} T int8 ops/s "
          f"({cs[0][4] * nops / ms / 1e9:.1f} T of plane work)")
    return dict(ms=ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, plane_floor_ms=floor_ms,
                bytes=nbytes, ops=nops, linears=len(cs))


def whisper_serving(torch, np, dev, card, cfg):
    """Phase 14: Whisper-large-v3 at full width and depth on the kernel
    route at ``WHISPER_PLANES``: the encoder over four rows of frames, the
    engine's cross K/V projection, ``Engine.run`` of phase 5's requests,
    the checks and the times.  Returns the scaled kernel's entries for this
    path."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.kernels import ops
    from repro_torch.models import layers, whisper
    from repro_torch.obs.events import RecordingSink
    from repro_torch.serve import Engine, Request

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    params = whisper.init_params(0, cfg, device=dev, int8_min_dim=256)
    torch.cuda.synchronize()
    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, tree

    check(not [p for p, _ in leaves(params) if p[-1] == "w"],
          "a Whisper linear stayed in bf16 after quantize_params_int8")
    n_enc, n_dec = (sum(t.numel() for _, t in leaves(params[part]) if t.dtype == torch.int8)
                    for part in ("enc_blocks", "dec_blocks"))
    n_bf16 = sum(t.numel() for _, t in leaves(params) if t.dtype == torch.bfloat16)
    print(f"[whisper] Whisper-large-v3 params on the card in {time.perf_counter() - t0:.1f} s: "
          f"{(n_enc + n_dec) / 1e9:.3f} G int8 weights (encoder {n_enc / 1e9:.3f}, decoder "
          f"{n_dec / 1e9:.3f}), {n_bf16 / 1e6:.1f} M bf16 (embedding, positions, norms), "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    kcfg = cfg.replace(quant=QuantConfig(mode="mma_int8", impl="kernel", planes=WHISPER_PLANES))
    frames = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (LM_BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)).to(dev).to(torch.bfloat16)
    per_enc, per_kv, per_call = whisper_launches(cfg)
    m_wide = LM_BATCH * cfg.enc_seq

    scaled = ops.mma_matmul_scaled

    def recording(into, keep):
        """Record every scaled call (int8 x as the kernel got it, w, scales,
        planes); the output of the first ``keep`` only."""
        def call(x, w, xs, ws, **kw):
            out = scaled(x, w, xs, ws, **kw)
            k = w.shape[0]
            into.append((x.reshape(-1, k), w, xs, ws, kw["planes"],
                         out.reshape(-1, w.shape[1]) if len(into) < keep else None))
            return out
        return call

    # the encoder, recorded (its first layer's outputs kept), then timed alone
    enc_calls, kv_calls = [], []
    mk.scaled_launches = 0
    ops.mma_matmul_scaled = recording(enc_calls, 6)
    try:
        memory = whisper.encode(params, frames, kcfg, device=dev)
        torch.cuda.synchronize()
    finally:
        ops.mma_matmul_scaled = scaled
    launches_enc = mk.scaled_launches
    check(launches_enc == per_enc == len(enc_calls)
          and all(x.shape[0] == m_wide for x, *_ in enc_calls),
          f"{launches_enc} scaled launches in the encoder ({len(enc_calls)} recorded), expected "
          f"{per_enc} at M = {m_wide}")
    check(memory.shape == (LM_BATCH, cfg.enc_seq, cfg.d_model) and memory.dtype == torch.bfloat16
          and bool(torch.isfinite(memory.float()).all()),
          f"encoder memory {tuple(memory.shape)} {memory.dtype} not finite or of the wrong shape")
    t0 = time.perf_counter()
    again = whisper.encode(params, frames, kcfg, device=dev)
    torch.cuda.synchronize()
    enc_wall_s = time.perf_counter() - t0
    check(torch.equal(again, memory), "the encoder, run again on the same frames, differs")
    del again

    # the engine projects the cross K/V once
    extras = {"memory": memory}
    mk.scaled_launches = 0
    ops.mma_matmul_scaled = recording(kv_calls, 2)
    try:
        t0 = time.perf_counter()
        engine = Engine(kcfg, params, batch=LM_BATCH, max_seq=LM_MAX_SEQ, extras=extras,
                        device=dev)
        torch.cuda.synchronize()
        kv_wall_s = time.perf_counter() - t0
    finally:
        ops.mma_matmul_scaled = scaled
    launches_kv = mk.scaled_launches
    ckv = extras["cross_kv"]
    check(launches_kv == per_kv == len(kv_calls) and all(x.shape[0] == m_wide for x, *_ in kv_calls),
          f"{launches_kv} scaled launches projecting the cross K/V, expected {per_kv}")
    check(ckv["k"].shape == (cfg.n_layers, LM_BATCH, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
          and ckv["v"].shape == ckv["k"].shape and ckv["k"].dtype == torch.bfloat16,
          f"cross K/V {tuple(ckv['k'].shape)} {ckv['k'].dtype}")
    print(f"[whisper] encoder: {launches_enc} scaled launches at M = {m_wide} "
          f"({per_enc // (cfg.enc_layers or cfg.n_layers)} per layer), host wall "
          f"{enc_wall_s * 1e3:.1f} ms | cross K/V: {launches_kv} launches at M = {m_wide}, "
          f"{2 * ckv['k'].numel() * 2 / 1e9:.3f} GB bf16, host wall {kv_wall_s * 1e3:.1f} ms")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(4, 9, LM_BATCH)]
    engine.obs = RecordingSink()
    # Record the first decode step (every slot active, all prompts in): its
    # inputs, a copy of the cache before it, every scaled-kernel call, and
    # the last decoder block's inputs (its cache rows copied before it
    # writes them) and output.  Recording adds no launch.
    record_at = sum(len(p) for p in prompts)
    rec = {"calls": [], "n": 0}
    decode, inner_block = engine.decode_fn, whisper.dec_block

    def recording_block(blk, x, mem, c, *, cache=None, cache_index=None, cross_kv=None):
        before = tuple(t.clone() for t in cache)
        out = inner_block(blk, x, mem, c, cache=cache, cache_index=cache_index,
                          cross_kv=cross_kv)
        rec["block"] = (blk, x, before, cache_index, cross_kv, out)
        return out

    def counted_decode(p, toks, cache, idx, ex):
        n = rec["n"]
        rec["n"] = n + 1
        if n != record_at:
            return decode(p, toks, cache, idx, ex)
        rec["args"] = (toks.copy(), layers.tree_map(torch.clone, cache), idx)
        ops.mma_matmul_scaled = recording(rec["calls"], per_call)
        whisper.dec_block = recording_block
        try:
            logits, cache = decode(p, toks, cache, idx, ex)
        finally:
            ops.mma_matmul_scaled, whisper.dec_block = scaled, inner_block
        rec["logits"] = logits.clone()
        return logits, cache

    engine.decode_fn = counted_decode
    mk.scaled_launches = 0
    t0 = time.perf_counter()
    done = engine.run([Request(i, p, max_new=LM_MAX_NEW) for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, calls = mk.scaled_launches, rec["n"]
    check(launches == per_call * calls,
          f"{launches} scaled launches for {calls} decode calls, expected {per_call} each")
    check(len(done) == LM_BATCH and all(r.done and len(r.out) == LM_MAX_NEW for r in done),
          "not every request finished with its token budget")
    check(all(0 <= t < cfg.vocab for r in done for t in r.out), "a token outside the vocabulary")
    steps = sum(1 for e in engine.obs.events if e.etype == "lm-step")
    print(f"[whisper] Engine.run: {len(done)} requests, prompts {[len(p) for p in prompts]}, "
          f"{calls} decode calls ({record_at} prefill + {calls - record_at} step; {steps} "
          f"lm-step events), {launches} scaled launches ({per_call} per call), {wall_s:.2f} s "
          f"host wall ({wall_s / calls * 1e3:.1f} ms per decode call)")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"[whisper] request {r.rid}: prompt {r.prompt.tolist()} -> tokens {r.out}")
    # the same requests again under the profiler: the card's idle share
    prof_wall, prof_busy, idle, _ = device_idle(torch, lambda: Engine(
        kcfg, params, batch=LM_BATCH, max_seq=LM_MAX_SEQ, extras=extras, device=dev).run(
        [Request(i, p, max_new=LM_MAX_NEW) for i, p in enumerate(prompts)]))
    print(f"[whisper] Engine.run under the profiler: host wall {prof_wall:.1f} ms, device busy "
          f"{prof_busy:.1f} ms, idle share {idle:.3f}")

    # every checked kernel call bit for bit against the plain version: the
    # recorded decode call's, the encoder's first layer (one activation scale
    # over all 6000 rows), the first layer's cross K/V projections
    check(len(rec["calls"]) == per_call, f"{len(rec['calls'])} scaled calls recorded")
    checked = rec["calls"] + enc_calls[:6] + kv_calls[:2]
    for x, w, xs, ws, planes, out in checked:
        want = mk.mma_matmul_scaled_plain(x, w, xs, ws, planes=planes)
        check(torch.equal(out, want),
              f"scaled linear M={x.shape[0]} K={w.shape[0]} N={w.shape[1]} != plain")
    # the recorded call's logits, kernel route vs Horner route from the same
    # cache and cross K/V: at the served planes printed, at 8 gated
    toks, cache, idx = rec["args"]
    lk = rec["logits"]
    check(lk.shape == (LM_BATCH, 1, cfg.vocab) and bool(torch.isfinite(lk.float()).all()),
          f"recorded call: logits {tuple(lk.shape)} not finite or of the wrong shape")
    gaps = {}
    for planes in (WHISPER_PLANES, 8):
        q = dataclasses.replace(kcfg.quant, planes=planes)
        if planes != WHISPER_PLANES:
            lk, _ = whisper.decode_step(params, toks, layers.tree_map(torch.clone, cache), idx,
                                        kcfg.replace(quant=q), memory=memory, cross_kv=ckv,
                                        device=dev)
        lh, _ = whisper.decode_step(params, toks, layers.tree_map(torch.clone, cache), idx,
                                    kcfg.replace(quant=dataclasses.replace(q, impl="horner")),
                                    memory=memory, cross_kv=ckv, device=dev)
        gaps[planes] = (_rel(lk, lh), float((lk.argmax(-1) == lh.argmax(-1)).float().mean()))
    check(gaps[8][0] <= LM_LOGIT_REL,
          f"recorded call at 8 planes: logits kernel vs Horner differ by {gaps[8][0]} (rel)")
    # the last decoder block (card again bit for bit; the CPU within
    # RECURRENT_BLOCK_REL) and the first encoder block on one row of frames
    blk, x, (ck, cv), ci, xkv, out = rec["block"]
    again = inner_block(blk, x, memory, kcfg, cache=(ck.clone(), cv.clone()), cache_index=ci,
                        cross_kv=xkv)
    check(torch.equal(again, out), "the last decoder block, repeated on its inputs, differs")
    cpu = layers.params_to
    dec_c = inner_block(cpu(blk, "cpu"), x.cpu(), memory.cpu(), kcfg,
                        cache=(ck.cpu(), cv.cpu()), cache_index=ci,
                        cross_kv=tuple(t.cpu() for t in xkv))
    blk0 = layers.layer_params(params["enc_blocks"], 0)
    x0 = frames[:1] + params["enc_pos"][None]
    enc_g = whisper.enc_block(blk0, x0, kcfg)
    enc_c = whisper.enc_block(cpu(blk0, "cpu"), x0.cpu(), kcfg)
    blk_rel = {"decoder": _rel(out.cpu(), dec_c), "encoder": _rel(enc_g.cpu(), enc_c)}
    check(all(r <= RECURRENT_BLOCK_REL for r in blk_rel.values()),
          f"blocks card vs CPU: max rel {blk_rel} (limit {RECURRENT_BLOCK_REL})")
    print(f"[whisper] bit-exact against the plain version: the recorded decode call's "
          f"{per_call} scaled linears, encoder layer 0's 6 at M = {m_wide}, layer 0's cross k/v; "
          f"logits vs Horner route from its cache, max rel (top-1 agreement): at "
          f"{WHISPER_PLANES} planes {gaps[WHISPER_PLANES][0]:.4f} ({gaps[WHISPER_PLANES][1]:.2f}, "
          f"not gated), at 8 planes {gaps[8][0]:.4f} ({gaps[8][1]:.2f}; limit {LM_LOGIT_REL}); "
          f"card vs CPU max rel: last decoder block {blk_rel['decoder']:.3g}, encoder block 0 on "
          f"one row of {cfg.enc_seq} frames {blk_rel['encoder']:.3g} (limit {RECURRENT_BLOCK_REL})")

    # times: the decode call's linears and each shape at M = 4 (w cold), each
    # shape at M = 6000, the encoder's and the cross K/V pass's linears
    lm = dict(calls=rec["calls"], launches=launches, wall_s=wall_s, decode_calls=calls)
    times = lm_times(torch, dev, card, lm, whisper_shapes(cfg), label="Whisper-large-v3")
    g = torch.Generator(device=dev).manual_seed(2)
    wide_shapes = []
    for name, k, n in whisper_shapes(cfg):
        ms_planes, lib_ms, plain_ms, copies, n_calls = cold_shape_times(
            torch, dev, g, m_wide, k, n, (WHISPER_PLANES, 8))
        b_ms, b_by, nbytes, nops = scaled_bound([(m_wide, k, n)])
        floor_ms = WHISPER_PLANES * nops / INT8_OPS_PER_S * 1e3
        wide_shapes.append(dict(name=name, M=m_wide, K=k, N=n, ms=ms_planes[WHISPER_PLANES],
                                ms_planes=ms_planes, plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=b_ms, bound_by=b_by, plane_floor_ms=floor_ms))
        print(f"[time] {card} | mma_matmul_scaled Whisper-large-v3 {name} M={m_wide} K={k} N={n} "
              f"(graph of {n_calls} calls over {copies} copies of w) planes {WHISPER_PLANES}: "
              f"kernel {ms_planes[WHISPER_PLANES]:.4f} ms, plain {plain_ms:.3f} ms, "
              f"torch._int_mm+scale {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), plane-work "
              f"floor {floor_ms:.4f} ms | planes 8: {ms_planes[8]:.4f} ms")
    enc_t = wide_calls_times(torch, card, enc_calls, "Whisper-large-v3 encoder")
    kv_t = wide_calls_times(torch, card, kv_calls, "Whisper-large-v3 cross K/V pass")
    print(f"[time] {card} | Whisper-large-v3: encoder host wall {enc_wall_s * 1e3:.1f} ms, cross "
          f"K/V host wall {kv_wall_s * 1e3:.1f} ms, Engine.run host wall {wall_s:.2f} s "
          f"({wall_s / calls * 1e3:.1f} ms per decode call), idle share {idle:.3f}")
    phase_s = time.perf_counter() - t_phase
    print(f"[whisper] phase 14 took {phase_s:.1f} s")
    out = {f"whisper_{k}": times[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                               "per_shape")}
    out.update(
        launches_whisper=launches, launches_whisper_encoder=launches_enc,
        launches_whisper_cross_kv=launches_kv, whisper_decode_calls=calls, whisper_wall_s=wall_s,
        whisper_host_ms_per_call=wall_s / calls * 1e3, whisper_idle_share=idle,
        whisper_encoder_wall_s=enc_wall_s, whisper_cross_kv_wall_s=kv_wall_s,
        whisper_logits_rel={p: gv[0] for p, gv in gaps.items()}, whisper_block_rel=blk_rel,
        whisper_wide_per_shape=wide_shapes, whisper_encoder=enc_t, whisper_cross_kv=kv_t,
        phase14_s=phase_s,
    )
    return out


def train_shapes(cfg):
    """The linears of one training microbatch, by shape: ``(name, K, N,
    linears, calls)``.  Each linear's forward is one unscaled-kernel call and
    a block linear's runs again in remat's recompute, so a block shape has
    twice as many calls as linears; each linear's backward is one pair of
    float32 products."""
    d, kv, ff, n = cfg.d_model, cfg.n_kv_heads * cfg.hd, cfg.d_ff, cfg.n_layers
    return [(name, k, nn, lin, 2 * lin if name != "head" else lin)
            for name, k, nn, lin in (("wq/wo", d, d, 2 * n), ("wk/wv", d, kv, 2 * n),
                                     ("w_gate/w_up", d, ff, 2 * n), ("w_down", ff, d, n),
                                     ("head", d, cfg.vocab, 1))]


def train_times(torch, dev, card, m, shapes, recorded):
    """Graph-timed products of a training step at M = ``m`` rows, by shape:
    the unscaled kernel at 8 planes (on the recorded call of that shape)
    against ``torch._int_mm``, the bound and the plane-work floor; and the
    straight-through estimator's float32 products, forward ``x @ w`` and the
    backward's ``g @ w.T`` and ``x.T @ g`` (TF32 off), against the card's
    float32 peak outside the tensor cores."""
    from repro_torch.bench.table1 import graph_ms
    from repro_torch.kernels import mma_matmul as mk

    g = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for name, k, n, linears, calls in shapes:
        x8, w8 = recorded[(k, n)]
        ms = graph_ms(torch, lambda: mk.mma_matmul_kernel(x8, w8, planes=8), calls=5, reps=5)
        check(torch.equal(torch._int_mm(x8, w8), mk.mma_matmul_kernel(x8, w8)),
              f"training {name}: library yardstick disagrees with the kernel")
        lib_ms = graph_ms(torch, lambda: torch._int_mm(x8, w8), calls=5, reps=5)
        plain_ms = time_ms(torch, lambda: mk.mma_matmul_plain(x8, w8, planes=8), reps=1,
                           warmup=1)
        x32 = torch.randn((m, k), device=dev, generator=g)
        w32 = torch.randn((k, n), device=dev, generator=g)
        g32 = torch.randn((m, n), device=dev, generator=g)
        fwd_ms = graph_ms(torch, lambda: x32 @ w32, calls=5, reps=5)
        bwd_ms = graph_ms(torch, lambda: (g32 @ w32.T, x32.T @ g32), calls=5, reps=5)
        del x32, w32, g32
        nbytes, nops = m * k + k * n + 4 * m * n, 2 * m * k * n
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT8_OPS_PER_S * 1e3
        row = dict(name=name, M=m, K=k, N=n, linears=linears, calls=calls, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   plane_floor_ms=8 * t_ops, ste_fwd_ms=fwd_ms, ste_bwd_ms=bwd_ms,
                   ste_floor_ms=nops / F32_OPS_PER_S * 1e3, ops=nops, bytes=nbytes)
        rows.append(row)
        print(f"[train] {card} | mma_matmul training {name} M={m} K={k} N={n} ({calls} per "
              f"microbatch), planes 8: kernel {ms:.4f} ms ({8 * nops / ms / 1e9:.1f} T plane "
              f"ops/s), plain {plain_ms:.3f} ms, torch._int_mm {lib_ms:.4f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}), plane-work floor "
              f"{row['plane_floor_ms']:.5f} ms | STE float32 products: x @ w {fwd_ms:.4f} ms, "
              f"backward pair {bwd_ms:.4f} ms ({3 * nops / (fwd_ms + bwd_ms) / 1e9:.1f} TFLOP/s)")
    return rows


def train_microbatch(torch, dev, cfg, hcfg, dcfg, shapes):
    """Phase 15's first check: Yi-6B's training params drawn on the card, and
    one microbatch's loss and gradients on the kernel route (``cfg``), every
    unscaled call held against the plain version bit for bit as it is made,
    then on the Horner route (``hcfg``): loss and every gradient leaf
    bit-equal.  Returns the params and the record (calls, max error, one
    ``(x, w)`` per shape)."""
    from repro_torch.checkpoint.ckpt import tree_leaves
    from repro_torch.data.pipeline import get_batch
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.train import train_step as ts

    m = dcfg.global_batch // cfg.microbatches * dcfg.seq_len
    per_mb = sum(c for *_, c in shapes)
    t0 = time.perf_counter()
    params = transformer.init_params(0, cfg, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    n_embed = params["embed"]["table"].numel() + params["head"]["w"].numel()
    torch.cuda.synchronize()
    print(f"[train] Yi-6B at full width, {cfg.n_layers} of 32 layers: {n_params / 1e9:.3f} G "
          f"params ({n_embed / 1e9:.3f} G embedding + head, "
          f"{(n_params - n_embed) / cfg.n_layers / 1e9:.3f} G per layer), bf16 on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    mb = {k: v[0] for k, v in get_batch(dcfg, 0).items()}
    inner = ops.mma_matmul
    rec = {"n": 0, "err": 0, "shapes": {}}

    def recording(x, w, **kw):
        out = inner(x, w, **kw)
        x2 = x.reshape(-1, x.shape[-1])
        want = mk.mma_matmul_plain(x2, w, planes=kw["planes"])
        rec["err"] = max(rec["err"], int((out.reshape(want.shape).to(torch.int64)
                                          - want.to(torch.int64)).abs().max()))
        check(torch.equal(out.reshape(want.shape), want),
              f"training call {rec['n']}: kernel != plain at {tuple(x2.shape)} @ {tuple(w.shape)}")
        rec["n"] += 1
        if tuple(w.shape) not in rec["shapes"]:
            rec["shapes"][tuple(w.shape)] = (x2.clone(), w.clone())
        return out

    mk.launches = mk.scaled_launches = 0
    ops.mma_matmul = recording
    t0 = time.perf_counter()
    try:
        (loss_k, _), grads_k = ts.value_and_grad(ts.make_loss_fn(cfg, device=dev), params, mb)
    finally:
        ops.mma_matmul = inner
    torch.cuda.synchronize()
    mb_kernel_s = time.perf_counter() - t0
    check(mk.launches == per_mb == rec["n"] and mk.scaled_launches == 0,
          f"one microbatch: {mk.launches} unscaled launches ({rec['n']} recorded), "
          f"{mk.scaled_launches} scaled, expected {per_mb} and 0")
    check(sorted(rec["shapes"]) == sorted((k, n) for _, k, n, _, _ in shapes),
          f"recorded shapes {sorted(rec['shapes'])}")
    t0 = time.perf_counter()
    (loss_h, _), grads_h = ts.value_and_grad(ts.make_loss_fn(hcfg, device=dev), params, mb)
    torch.cuda.synchronize()
    mb_horner_s = time.perf_counter() - t0
    check(mk.launches == per_mb, "the Horner route launched the kernel")
    check(bool(torch.isfinite(loss_k)) and torch.equal(loss_k, loss_h),
          f"one microbatch: loss kernel route {float(loss_k)} vs Horner route {float(loss_h)}")
    leaves_k, leaves_h = tree_leaves(grads_k), tree_leaves(grads_h)
    for i, (a, b) in enumerate(zip(leaves_k, leaves_h)):
        check(a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all()) and torch.equal(a, b),
              f"one microbatch: gradient leaf {i} {tuple(a.shape)}: kernel route != Horner route")
    print(f"[train] one microbatch (M = {m}): {rec['n']} unscaled calls, every one bit-exact "
          f"against the plain version (max_abs_err {rec['err']}); loss {float(loss_k):.6f} and "
          f"all {len(leaves_k)} gradient leaves bit-equal on the kernel and Horner routes | host "
          f"wall {mb_kernel_s:.2f} s with the checks, Horner route {mb_horner_s:.2f} s")
    return params, rec


def training(torch, np, dev, card):
    """Phase 15: quantization-aware training at Yi-6B's full width (depth cut
    to ``TRAIN_LAYERS``) through the trainer, every linear's forward on the
    unscaled kernel.  Checks and times as the module's docstring says;
    returns kernel 1's training entries."""
    import shutil

    from repro_torch.checkpoint.ckpt import tree_leaves, tree_unflatten
    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig
    from repro_torch.data.pipeline import DataConfig, get_batch
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts
    from repro_torch.train import trainer

    t_phase = time.perf_counter()
    # the straight-through estimator's float32 products in float32, as written
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(torch.get_float32_matmul_precision() == "highest", "float32 matmuls are not float32")
    cfg = get_config("yi_6b").replace(n_layers=TRAIN_LAYERS,
                                      quant=QuantConfig(mode="mma_int8", impl="kernel", planes=8))
    hcfg = cfg.replace(quant=dataclasses.replace(cfg.quant, impl="horner"))
    check(cfg.microbatches == 4 and cfg.remat == "full",
          f"Yi-6B trains at microbatches {cfg.microbatches}, remat {cfg.remat!r}")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      microbatches=cfg.microbatches, seed=0)
    m = TRAIN_BATCH // cfg.microbatches * TRAIN_SEQ  # rows of every kernel call
    shapes = train_shapes(cfg)
    per_mb = sum(c for *_, c in shapes)
    per_step = cfg.microbatches * per_mb
    check(per_mb == 2 * cfg.n_layers * 7 + 1 and per_step == 4 * (2 * 7 * TRAIN_LAYERS + 1),
          f"{per_step} unscaled calls per step")
    ckpt_root = SRC.parent / "chip_scratch" / "train"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()

    sections = {}  # seconds of host wall by part of the phase

    # ---- 1. one microbatch: every kernel call against the plain version,
    # the kernel route's loss and gradients against the Horner route's
    params, rec = train_microbatch(torch, dev, cfg, hcfg, dcfg, shapes)
    n_params = sum(p.numel() for p in tree_leaves(params))
    sections["microbatch"] = time.perf_counter() - t_phase

    # ---- 2. the main path: trainer.train to its one checkpoint (step
    # TRAIN_CKPT_EVERY, the one the restart reads), then the rest of
    # TRAIN_STEPS stepped as the trainer steps them (its batches, its step
    # function) without the trainer's final save, which no gate would read
    step_s, step_launches = [], []

    def step_fn(st, b):
        n0 = mk.launches
        t0 = time.perf_counter()
        out = ts.train_step(st, b, cfg, device=dev)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        step_launches.append(mk.launches - n0)
        return out

    def tcfg(name, steps):
        return trainer.TrainerConfig(total_steps=steps, ckpt_every=TRAIN_CKPT_EVERY, log_every=1,
                                     ckpt_dir=str(ckpt_root / name))

    def log(line):
        print(f"[train] {line}")

    def rest(st, start):
        losses = []
        for step in range(start, TRAIN_STEPS):
            st, met = step_fn(st, get_batch(dcfg, step))
            losses.append(float(met["loss"]))
        return st, losses

    half = TRAIN_CKPT_EVERY
    state = {"params": params, "opt": adamw.init(params)}
    mk.launches = mk.scaled_launches = 0
    t0 = time.perf_counter()
    state_a, m_a = trainer.train(state, step_fn, dcfg, tcfg("a", half), log=log)
    state_a, losses_a = rest(state_a, half)
    m_a["losses"] += losses_a
    train_s = time.perf_counter() - t0
    host_s = list(step_s)  # the main run's steps (the restart's run beside the launcher)
    launches, scaled = mk.launches, mk.scaled_launches
    peak = torch.cuda.max_memory_allocated()
    del state
    check(step_launches == [per_step] * TRAIN_STEPS and launches == per_step * TRAIN_STEPS,
          f"unscaled launches per step {step_launches}, expected {per_step}")
    check(scaled == 0, f"{scaled} scaled-kernel launches in training")
    check(len(m_a["losses"]) == TRAIN_STEPS and all(np.isfinite(m_a["losses"])),
          f"losses {m_a['losses']}")
    moved = max(float((a - b.to(torch.float32)).abs().max())
                for a, b in zip(tree_leaves(state_a["opt"].master), tree_leaves(params)))
    check(moved > 0, "the master params did not move")
    check(int(state_a["opt"].step) == TRAIN_STEPS, f"optimizer step {int(state_a['opt'].step)}")
    saved = sorted(p.name for p in (ckpt_root / "a").iterdir())
    check(saved == ["LATEST", f"step_{half:09d}"]
          and (ckpt_root / "a" / "LATEST").read_text() == f"step_{half:09d}",
          f"checkpoints written: {saved}")
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state_a))
    print(f"[train] {card} | trainer.train: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens in {cfg.microbatches} microbatches, losses "
          f"{[round(x, 4) for x in m_a['losses']]}, {launches} unscaled launches ({per_step} per "
          f"step), 0 scaled; host wall per step {[round(s, 3) for s in step_s]} s; "
          f"{train_s:.1f} s in all with {len(saved) - 1} checkpoints of "
          f"{state_bytes / 2**30:.2f} GiB; master moved by up to {moved:.3g}; peak "
          f"{peak / 2**30:.2f} GiB allocated (torch.cuda.max_memory_allocated)")
    sections["train"] = train_s

    # ---- 3. restart: kill the run after its step-`half` checkpoint (what it
    # had committed then: that step directory, LATEST naming it), resume,
    # run the rest again; every final param bit-equal
    t0 = time.perf_counter()
    final_a = [p.clone() for p in tree_leaves(state_a["params"])]
    like = tree_unflatten(state_a, [t.new_empty(()).expand(t.shape) for t in tree_leaves(state_a)])
    del state_a, params
    torch.cuda.empty_cache()
    # beside the restart, the launcher once, as a user runs it: a process of
    # its own on the card (its smoke model is small), its own checkpoints
    launch_dir = ckpt_root / "launch"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi_6b", "--smoke",
           "--steps", "4", "--ckpt-every", "2", "--resume", "--ckpt-dir", str(launch_dir)]
    proc = subprocess.Popen(cmd, env=dict(os.environ, PYTHONPATH=str(SRC)), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        t1 = time.perf_counter()
        resumed, start = trainer.resume(like, tcfg("a", TRAIN_STEPS))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        check(start == half and int(resumed["opt"].step) == half,
              f"resumed at step {start}, optimizer step {int(resumed['opt'].step)}")
        state_b, losses_b = rest(resumed, start)
        del resumed
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    restart_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"{' '.join(cmd[1:])} exited with {proc.returncode}:\n"
          f"{out[-2000:]}{err[-2000:]}")
    check("final loss" in out and (launch_dir / "LATEST").read_text() == "step_000000004",
          f"the launcher's output: {out[-2000:]}")
    print(f"[train] {' '.join(cmd[1:])}: exit 0 | " + " | ".join(out.strip().splitlines()[-2:]))
    check(losses_b == m_a["losses"][half:],
          f"resumed losses {losses_b} vs uninterrupted {m_a['losses'][half:]}")
    for i, (a, b) in enumerate(zip(final_a, tree_leaves(state_b["params"]))):
        check(torch.equal(a, b), f"restart: final param leaf {i} differs from the uninterrupted "
              "run's")
    sections["restart"] = restart_s
    print(f"[train] restart: killed after the step-{half} checkpoint, resumed ({restore_s:.1f} s "
          f"to restore {state_bytes / 2**30:.2f} GiB), {TRAIN_STEPS - half} more steps: every "
          f"final param bit-equal to the uninterrupted run's, losses equal | {restart_s:.1f} s "
          f"with the launcher beside it")
    shutil.rmtree(ckpt_root / "a")
    del final_a, like

    # ---- 4. where a step's time goes: one more step under the profiler
    batch = get_batch(dcfg, TRAIN_STEPS)
    holder = {}

    def one_step():
        holder["out"] = ts.train_step(state_b, batch, cfg, device=dev)

    t0 = time.perf_counter()
    wall_ms, busy_ms, idle, by_name = device_idle(torch, one_step)
    sections["profile"] = time.perf_counter() - t0
    state_b = holder.pop("out")[0]
    kernel_ms = sum(ms for name, (_, ms) in by_name.items() if "mma_tc_horner_kernel" in name)
    kernel_n = sum(n for name, (n, _) in by_name.items() if "mma_tc_horner_kernel" in name)
    check(kernel_n == per_step, f"profiled step: {kernel_n} unscaled kernels")
    gemm = {name: v for name, v in by_name.items()
            if "mma_tc" not in name and any(s in name.lower() for s in GEMM_NAMES)}
    gemm_ms = sum(ms for _, ms in gemm.values())
    print(f"[train] {card} | one step under the profiler: host wall {wall_ms:.1f} ms, device "
          f"busy {busy_ms:.1f} ms, idle share {idle:.3f}; unscaled kernel "
          f"{kernel_ms:.1f} ms ({kernel_n} launches, {kernel_ms / busy_ms:.3f} of device busy); "
          f"stock matmul kernels {gemm_ms:.1f} ms ({gemm_ms / busy_ms:.3f})")
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"[train] {ms:10.3f} ms {n:6d}x  {name[:110]}")

    # the optimizer update alone, on float32 gradients as the step hands them over
    grads = tree_unflatten(state_b["params"], [torch.zeros(p.shape, dtype=torch.float32,
                                                           device=dev)
                                               for p in tree_leaves(state_b["params"])])
    lr = torch.tensor(3e-4, device=dev)
    t0 = time.perf_counter()
    opt_ms = time_ms(torch, lambda: adamw.update(state_b["params"], grads, state_b["opt"], lr=lr),
                     reps=2, warmup=1)
    sections["optimizer"] = time.perf_counter() - t0
    opt_bytes = n_params * (4 * 4 + 3 * 4 + 2)  # read master, m, v, g; write them and params
    del grads, state_b
    torch.cuda.empty_cache()

    shutil.rmtree(ckpt_root, ignore_errors=True)

    # ---- 5. the step's products timed alone (CUDA graphs)
    t0 = time.perf_counter()
    rows = train_times(torch, dev, card, m, shapes, rec["shapes"])
    sections["times"] = time.perf_counter() - t0
    mbs = cfg.microbatches
    kernel_step = mbs * sum(r["calls"] * r["ms"] for r in rows)
    lib_step = mbs * sum(r["calls"] * r["library_ms"] for r in rows)
    plain_step = mbs * sum(r["calls"] * r["plain_ms"] for r in rows)
    bound_step = mbs * sum(r["calls"] * r["bound_ms"] for r in rows)
    floor_step = mbs * sum(r["calls"] * r["plane_floor_ms"] for r in rows)
    # every call's forward x @ w; the backward's pair once per linear
    fwd_step = mbs * sum(r["calls"] * r["ste_fwd_ms"] for r in rows)
    bwd_step = mbs * sum(r["linears"] * r["ste_bwd_ms"] for r in rows)
    ste_floor = mbs * sum((r["calls"] + 2 * r["linears"]) * r["ste_floor_ms"] for r in rows)
    phase_s = time.perf_counter() - t_phase
    print(f"[train] {card} | per step (from the graph-timed shapes x their calls): unscaled "
          f"kernel {kernel_step:.1f} ms (torch._int_mm {lib_step:.1f}, bound {bound_step:.2f}, "
          f"plane-work floor {floor_step:.1f}, plain {plain_step:.0f}); STE float32 products: "
          f"forward {fwd_step:.1f} ms, backward {bwd_step:.1f} ms (float32 floor {ste_floor:.1f}); "
          f"optimizer update "
          f"{opt_ms:.1f} ms (bytes bound {opt_bytes / HBM_BYTES_PER_S * 1e3:.1f} ms); host wall "
          f"per step {statistics.median(host_s) * 1e3:.0f} ms (median of {len(host_s)}), device "
          f"busy {busy_ms:.0f} ms (profiled step)")
    print(f"[train] phase 15 took {phase_s:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in sections.items()))
    return dict(
        launches_train=launches, launches_train_per_step=per_step, train_max_abs_err=rec["err"],
        train_per_shape=rows, train_step=dict(
            layers=cfg.n_layers, params=n_params, tokens=TRAIN_BATCH * TRAIN_SEQ, m=m,
            losses=m_a["losses"], host_s=host_s, busy_ms=busy_ms, profiled_wall_ms=wall_ms,
            kernel_ms_profiled=kernel_ms, gemm_ms_profiled=gemm_ms, kernel_ms=kernel_step,
            library_ms=lib_step, bound_ms=bound_step, plane_floor_ms=floor_step,
            plain_ms=plain_step, ste_fwd_ms=fwd_step, ste_bwd_ms=bwd_step,
            ste_floor_ms=ste_floor, optimizer_ms=opt_ms,
            optimizer_bound_ms=opt_bytes / HBM_BYTES_PER_S * 1e3, peak_bytes=peak,
            state_bytes=state_bytes, restore_s=restore_s, sections_s=sections),
        phase15_s=phase_s)


def parallel_cfgs():
    """Phase 16's model and data: Yi-6B at full width, ``PAR_LAYERS`` layers,
    QAT through the unscaled kernel at 8 planes, Yi-6B's 4 microbatches and
    full remat; 8 x 512 synthetic tokens per step (seed 0)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig
    from repro_torch.data.pipeline import DataConfig

    cfg = get_config("yi_6b").replace(n_layers=PAR_LAYERS,
                                      quant=QuantConfig(mode="mma_int8", impl="kernel", planes=8))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      microbatches=cfg.microbatches, seed=0)
    return cfg, dcfg


def parallel_moe_cfgs():
    """Phase 16's OLMoE-1B-7B: full width, ``PAR_MOE_LAYERS`` layers, QAT
    through the unscaled kernel at 8 planes, its config's 2 microbatches and
    ``moe.ep``, full remat; 8 x 512 synthetic tokens per step (seed 0)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig
    from repro_torch.data.pipeline import DataConfig

    cfg = get_config("olmoe_1b_7b").replace(
        n_layers=PAR_MOE_LAYERS, quant=QuantConfig(mode="mma_int8", impl="kernel", planes=8))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      microbatches=cfg.microbatches, seed=0)
    return cfg, dcfg


def parallel_moe_ep_cfgs():
    """Phase 16's OLMoE-1B-7B with quantization off: the expert-parallel
    path (``sharded_lm._moe_ep``, ``moe.ep_slab``) with a gradient."""
    from repro_torch.configs.base import QuantConfig

    cfg, dcfg = parallel_moe_cfgs()
    return cfg.replace(quant=QuantConfig(mode="none")), dcfg


def pipeline_cfgs():
    """Phase 16's GPipe model: ``parallel_cfgs``' Yi-6B at ``PP_LAYERS``
    layers, two per stage of PP 2, and its data."""
    cfg, dcfg = parallel_cfgs()
    return cfg.replace(n_layers=PP_LAYERS), dcfg


def pp_launches(cfg, n_stages: int = 2) -> int:
    """Unscaled launches of one rank's GPipe loss and gradient: every stage
    applies its layers at each of the n_micro + S - 1 ticks (7 linears
    each), again in remat's recompute, and the head at the n_micro ticks
    that emit a microbatch."""
    ticks = cfg.microbatches + n_stages - 1
    return 2 * ticks * (cfg.n_layers // n_stages) * block_mma_linears(cfg) + cfg.microbatches


def pipeline_yardstick(torch, dev, path: Path) -> tuple[float, float]:
    """The port's unsharded ``loss_fn`` and its gradient on GPipe's params
    (``pipeline_cfgs``, seed 0) and batch (step 0's 8 x 512 tokens), each
    row alone: PP 2 x DP 2 over Yi-6B's 4 microbatches gives each stage one
    row per call, so each row alone meets the same activation scales.  The
    loss is the rows' mean, as the pipeline's is; the gradient the rows'
    float32 mean, saved to ``path`` as bf16 leaves by top-level key.
    Returns the loss and the host wall."""
    from repro_torch.checkpoint.ckpt import tree_leaves
    from repro_torch.data.pipeline import get_batch
    from repro_torch.models import transformer

    cfg, dcfg = pipeline_cfgs()
    params = transformer.init_params(0, cfg, device=dev)
    named = [(k, t.requires_grad_()) for k in params for t in tree_leaves(params[k])]
    acc = [torch.zeros(t.shape, dtype=torch.float32, device=dev) for _, t in named]
    tokens = torch.as_tensor(get_batch(dcfg, 0)["tokens"]).reshape(TRAIN_BATCH, TRAIN_SEQ + 1)
    t0 = time.perf_counter()
    loss = 0.0
    for row in tokens:
        lr, _ = transformer.loss_fn(params, {"tokens": row[None]}, cfg, device=dev)
        for a, gr in zip(acc, torch.autograd.grad(lr, [t for _, t in named])):
            a += gr.float()
        loss += float(lr.detach())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {k: [] for k in params}
    for (k, _), a in zip(named, acc):
        out[k].append((a / TRAIN_BATCH).to(torch.bfloat16).cpu())
    torch.save(out, path)
    del params, named, acc
    torch.cuda.empty_cache()
    return loss / TRAIN_BATCH, wall


def pipeline_prediction(torch) -> dict:
    """The dry run's count of one rank's GPipe loss and gradient on meta
    tensors over the shape-only (data 2, model 2) mesh
    (``launch.dryrun_pp.count``): its products and collectives."""
    from repro_torch.launch import dryrun_pp
    from repro_torch.parallel.sharding import Mesh

    cfg, _ = pipeline_cfgs()
    batch = {"tokens": torch.empty((TRAIN_BATCH, TRAIN_SEQ + 1), dtype=torch.int32,
                                   device="meta")}
    return dryrun_pp.count(cfg, Mesh({"data": 2, "model": 2}, device="meta"), batch,
                           cfg.microbatches)


def replayed_dispatch(torch, xf, logits, chosen, n_experts: int, cap: int, dtype):
    """``moe._local_dispatch`` with each token's experts given: ``chosen``
    (T, k), as another run routed the slab.  The gate weights are this
    run's softmax of ``logits`` over those experts (largest first, as
    ``moe._top_k`` orders them), normalised; positions, drops and the
    dispatch buffer follow from the experts as there."""
    t, k = chosen.shape
    d = xf.shape[1]
    g = torch.softmax(logits, dim=-1).gather(1, chosen)
    gate, order = torch.sort(g, dim=-1, descending=True, stable=True)
    idx = chosen.gather(1, order)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    eid = idx.reshape(t * k)
    tok = torch.arange(t * k, device=xf.device) // k
    srt = torch.argsort(eid, stable=True)
    eid_s, tok_s, gw_s = eid[srt], tok[srt], gate.reshape(t * k)[srt]
    pos = torch.arange(t * k, device=xf.device) - torch.searchsorted(eid_s, eid_s, right=False)
    keep = pos < cap
    buf = torch.zeros((n_experts, cap + 1, d), dtype=dtype, device=xf.device)
    buf[eid_s, torch.where(keep, pos, cap)] = xf[tok_s].to(dtype)
    return buf[:, :cap], (eid_s, pos, tok_s, gw_s, keep)


def moe_ep_plain(torch, p: dict, x, cfg, forced=None):
    """The plain version of ``moe_ffn_ep`` over phases 16-17's (data 2,
    model 2) mesh, on one device with every expert: the rows split over
    'data' and the sequence over 'model' (whole where 'model' does not
    divide it: a decode step, where each model rank routes the data rank's
    rows whole), each slab routed alone (its own capacity, float32 router
    logits) through ``moe_ffn``'s dispatch, experts and combine.
    ``forced``: an iterator of each slab's experts (T, k) in this order,
    routed as given (``replayed_dispatch``)."""
    from repro_torch.models import moe as moe_lib

    m = cfg.moe
    b, s, d = x.shape
    n_seq = 2 if s % 2 == 0 else 1
    bl, sl = b // 2, s // n_seq
    cap = moe_lib.capacity(bl * sl, m)
    rows = []
    for i in range(2):
        slabs = []
        for j in range(n_seq):
            xf = x[i * bl:(i + 1) * bl, j * sl:(j + 1) * sl].reshape(bl * sl, d)
            logits = xf.to(torch.float32) @ p["router"]["w"].to(torch.float32)
            if forced is None:
                xe, meta = moe_lib._local_dispatch(xf, logits, m.n_experts, m.top_k, cap,
                                                   x.dtype)
            else:
                xe, meta = replayed_dispatch(torch, xf, logits, next(forced).to(x.device),
                                             m.n_experts, cap, x.dtype)
            y = moe_lib._local_combine(moe_lib.expert_ffn(p, xe), meta, bl * sl, cap, x.dtype)
            slabs.append(y.reshape(bl, sl, d))
        rows.append(torch.cat(slabs, dim=1))
    return torch.cat(rows, dim=0)


def par_mesh_shape(cfg) -> tuple[int, int]:
    """Phase 16's (data, model) mesh for ``cfg`` on the 4 ranks: (2, 2), but
    (1, 4) for the vlm.  Data ranks hold replicas of the params and
    optimizer state, so InternVL2-76B's one layer (2.96 G params, 41.4 GB
    of bf16 params, float32 master, m and v) would hold 20.7 GB per rank at
    model 2, 82.8 GB on the 80 GB card; at model 4, 10.35 GB."""
    return (1, 4) if cfg.family == "vlm" else (2, 2)


def par_global_batch(cfg) -> int:
    """Phase 16's sequences per step for ``cfg``: ``TRAIN_BATCH``, or the
    least multiple of the data axis x the config's microbatches above it,
    so that both divide it (InternVL2-76B: 8 sequences, its 8 microbatches
    of one row on its one data rank)."""
    per = par_mesh_shape(cfg)[0] * cfg.microbatches
    return max(TRAIN_BATCH, -(-TRAIN_BATCH // per) * per)


def par_m(cfg) -> int:
    """Decoder rows of each kernel call on one rank of the mesh: the rank's
    rows of a microbatch times the sequence, the vlm's patches before it
    included."""
    data = par_mesh_shape(cfg)[0]
    return par_global_batch(cfg) // cfg.microbatches // data * (TRAIN_SEQ + cfg.vlm_patches)


def parallel_family_cfgs():
    """Phase 16(c)'s models: ``(tag, label, cfg, data config)`` for each of
    ``PAR_FAMILIES`` at full width, QAT through the unscaled kernel at 8
    planes, each config's microbatches, full remat; ``par_global_batch`` x
    512 synthetic decoder tokens per step (seed 0), Whisper's frames and
    the vlm's patches drawn beside them."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig
    from repro_torch.data.pipeline import DataConfig

    out = []
    for tag, label, depth in PAR_FAMILIES:
        cfg = get_config(tag).replace(
            **depth, quant=QuantConfig(mode="mma_int8", impl="kernel", planes=8))
        extras = ({"frames": (cfg.enc_seq, cfg.d_model)} if cfg.family == "encdec" else
                  {"patches": (cfg.vlm_patches, cfg.d_model)} if cfg.family == "vlm" else None)
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=par_global_batch(cfg),
                          microbatches=cfg.microbatches, seed=0, extras=extras)
        out.append((tag, label, cfg, dcfg))
    return out


def block_mma_linears(cfg) -> int:
    """A transformer block's quantized linears: attention's four, and the
    MLP's three (an MoE block's experts and router are not quantized)."""
    return 4 if cfg.moe.n_experts else 7


def mb_linears(cfg) -> tuple[int, int]:
    """One microbatch's quantized linears: ``(forward, remat's recompute)``.
    RWKV6: 5 in the time mix and 3 in the channel mix per block; Zamba2: 4
    per Mamba2 layer (the in-projections and ``out_proj``) and 5 in the
    shared block (not rematerialised) per group; Whisper: 6 per encoder and
    10 per decoder block, its tied head a bf16 product; the others
    ``block_mma_linears`` per block; every head but Whisper's one more."""
    if cfg.family == "ssm":
        blocks = 8 * cfg.n_layers
        return blocks + 1, blocks
    if cfg.family == "hybrid":
        g = cfg.attn_every
        mamba = 4 * cfg.n_layers
        return mamba + 5 * (cfg.n_layers // g) + 1, mamba
    if cfg.family == "encdec":
        blocks = 6 * cfg.enc_layers + 10 * cfg.n_layers
        return blocks, blocks
    blocks = block_mma_linears(cfg) * cfg.n_layers
    return blocks + 1, blocks


def par_launches(cfg) -> int:
    """Unscaled launches per step on one rank, from the layout: every
    quantized linear is split over 'model' (column- or row-parallel), so
    each of a microbatch's linears (a rematerialised one twice) is one
    kernel call on each rank.  Unquantized: none."""
    if cfg.quant.mode == "none":
        return 0
    return cfg.microbatches * sum(mb_linears(cfg))


def par_batch(torch, cfg) -> dict:
    """Phase 16's batch as meta tensors: (microbatches, rows, 513) tokens
    (and Whisper's float32 frames, the vlm's float32 patches)."""
    rows = par_global_batch(cfg) // cfg.microbatches
    out = {"tokens": torch.empty((cfg.microbatches, rows, TRAIN_SEQ + 1), dtype=torch.int32,
                                 device="meta")}
    if cfg.family == "encdec":
        out["frames"] = torch.empty((cfg.microbatches, rows, cfg.enc_seq, cfg.d_model),
                                    dtype=torch.float32, device="meta")
    if cfg.family == "vlm":
        out["patches"] = torch.empty((cfg.microbatches, rows, cfg.vlm_patches, cfg.d_model),
                                     dtype=torch.float32, device="meta")
    return out


def dry_prediction(torch, cfg) -> dict:
    """What the dry run predicts for one rank of phase 16's mesh
    (``par_mesh_shape``): its state bytes (``specs.sharded_bytes``), the
    collectives of one step (the counting mode on meta tensors) and the
    step's roofline bound at the H100's data-sheet peaks (informative: the
    ranks share one card and exchange over gloo and host memory)."""
    from repro_torch.launch import dryrun, hlo_analysis, specs
    from repro_torch.parallel.sharding import Mesh
    from repro_torch.train import train_step as ts

    t0 = time.perf_counter()
    data, model = par_mesh_shape(cfg)
    mesh = Mesh({"data": data, "model": model}, device="meta")
    ab = ts.abstract_state(cfg)
    st_sh = ts.state_shardings(ab, cfg, mesh)
    counted = dryrun.count_train_step(cfg, mesh, par_batch(torch, cfg))
    mem = hlo_analysis.analytic_hbm_bytes(
        "train", **specs.train_mem_in(cfg, ab, st_sh, mesh, par_global_batch(cfg), TRAIN_SEQ))
    coll = counted["collectives"]
    roof = hlo_analysis.roofline(counted["census"]["flops"], mem["total"], coll["total_bytes"])
    return dict(state_bytes=specs.sharded_bytes(ab, st_sh, mesh), collectives=coll,
                mesh_shape=(data, model),
                census=counted["census"], hbm_bytes=mem["total"], roofline=roof,
                seconds=time.perf_counter() - t0)


def same_collectives(live: dict, predicted: dict) -> bool:
    return all(live[k] == predicted[k] for k in ("counts_by_kind", "bytes_by_kind"))


def par_shapes(cfg, m: int) -> list:
    """The unscaled kernel's shapes on one rank of the mesh
    (``par_mesh_shape``) at M = ``m`` decoder rows: ``(name, M, K, N, calls
    per step)``, from the layout (``sharded_lm`` and the family modules of
    ``repro_torch.parallel``)."""
    d, ff, v, n, mb = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers, cfg.microbatches
    ms = par_mesh_shape(cfg)[1]  # the model axis
    if cfg.family == "ssm":  # 2 x: remat's recompute
        return [("time-mix wr/wk/wv/wg, channel wr", m, d, d // ms, 2 * 5 * n * mb),
                ("time-mix wo", m, d // ms, d, 2 * n * mb),
                ("channel wk", m, d, ff // ms, 2 * n * mb),
                ("channel wv", m, ff // ms, d, 2 * n * mb), ("head", m, d, v // ms, mb)]
    if cfg.family == "hybrid":
        di, groups = 2 * d, n // cfg.attn_every
        heads = di // cfg.ssm_head_dim
        return [("z_proj", m, d // ms, di, 2 * n * mb),
                ("xbc_proj", m, d // ms, di + 2 * cfg.ssm_state, 2 * n * mb),
                ("dt_proj", m, d // ms, heads, 2 * n * mb),
                ("out_proj, shared proj", m, di // ms, d, (2 * n + groups) * mb),
                ("shared wq/wk/wv", m, 2 * d, d, 3 * groups * mb),
                ("shared wo", m, d, 2 * d, groups * mb), ("head", m, d, v // ms, mb)]
    if cfg.family == "encdec":
        me, le = m // TRAIN_SEQ * cfg.enc_seq, cfg.enc_layers
        return [("encoder wq/wk/wv, cross wk/wv", me, d, d // ms, 2 * (3 * le + 2 * n) * mb),
                ("encoder wo", me, d // ms, d, 2 * le * mb),
                ("encoder w_up", me, d, ff // ms, 2 * le * mb),
                ("encoder w_down", me, ff // ms, d, 2 * le * mb),
                ("decoder wq/wk/wv, cross wq", m, d, d // ms, 2 * 4 * n * mb),
                ("decoder wo, cross wo", m, d // ms, d, 2 * 2 * n * mb),
                ("decoder w_up", m, d, ff // ms, 2 * n * mb),
                ("decoder w_down", m, ff // ms, d, 2 * n * mb)]
    kv = cfg.n_kv_heads * cfg.hd
    shapes = [("wq", m, d, d // ms, 2 * n * mb), ("wk/wv", m, d, kv // ms, 4 * n * mb),
              ("wo", m, d // ms, d, 2 * n * mb)]
    if not cfg.moe.n_experts:
        shapes += [("w_gate/w_up", m, d, ff // ms, 4 * n * mb), ("w_down", m, ff // ms, d, 2 * n * mb)]
    return shapes + [("head", m, d, v // ms, mb)]


def parallel_rank(rank: int, world: int, root: str) -> None:
    """Phases 16 and 17's ranks: one process each on the card, gloo between
    them (NCCL refuses two ranks on one device); the phases to run are in
    ``root/phases.json``.  Writes ``root/rank{r}.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{root}/pg", rank=rank,
                            world_size=world)
    try:
        phases = json.loads((Path(root) / "phases.json").read_text())
        out = _parallel_rank(torch, np, dist, Path(root)) if 16 in phases else \
            {"rank": dist.get_rank(), "secs": {}}
        if 17 in phases:
            from repro_torch.kernels import mma_matmul as mk
            from repro_torch.launch.mesh import make_host_mesh

            mk.build()  # phase 1's library, found by its hash: not rebuilt
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            mk.launches = mk.scaled_launches = 0
            out["serving"] = _serving_rank(torch, np, dist, Path(root), make_host_mesh(model=2),
                                           torch.device("cuda"))
            out["serving_launches"] = [mk.scaled_launches, mk.launches]
            out["secs"]["serving"] = time.perf_counter() - t0
        (Path(root) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _parallel_rank(torch, np, dist, root: Path) -> dict:
    from functools import partial

    from repro_torch.bench.table1 import graph_ms
    from repro_torch.checkpoint.ckpt import Checkpointer, tree_leaves, tree_unflatten
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import get_batch
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.optim import grad_compress as gc
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import pipeline as pp
    from repro_torch.parallel import sharded_lm
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.sharding import Mesh, NamedSharding, P
    from repro_torch.train import train_step as ts
    from repro_torch.train import trainer

    dev = torch.device("cuda")
    rank = dist.get_rank()
    out, secs = {"rank": rank}, {}
    t_all = time.perf_counter()
    lib, _ = mk.build()  # phase 1's library, found by its hash: not rebuilt
    out["library"] = lib.name
    cfg, dcfg = parallel_cfgs()
    mesh = make_host_mesh(model=2)  # (data 2, model 2)
    mesh_b = Mesh.from_world((1, 4), ("data", "model"), device=dev)
    di, ri = mesh.index("data"), mesh.index("model")

    # ---- (c) RWKV6-3B, Zamba2-7B, Whisper-large-v3 and InternVL2-76B (on the
    # (1, 4) mesh): one sharded step each, first, while the ranks hold
    # nothing else (InternVL2-76B's state is 10.35 GB of each rank)
    family_shapes, out["families"] = {}, {}
    for tag, _, fcfg, fdcfg in parallel_family_cfgs():
        t0 = time.perf_counter()
        fmesh = mesh if par_mesh_shape(fcfg) == (2, 2) else mesh_b
        out["families"][tag], family_shapes[tag] = _model_rank(torch, root, fmesh, dev, fcfg, fdcfg,
                                                               f"yard_{tag}.pt")
        secs[tag] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ab = ts.abstract_state(cfg)
    st_sh = ts.state_shardings(ab, cfg, mesh)
    abatch = {"tokens": torch.empty((cfg.microbatches, TRAIN_BATCH // cfg.microbatches,
                                     TRAIN_SEQ + 1), dtype=torch.int32, device="meta")}
    step = ts.build_jitted_train_step(cfg, mesh, ab, abatch)
    params = transformer.init_params(0, cfg, device=dev)
    local = shd.shard_tree(params, st_sh["params"])
    del params
    state = {"params": local, "opt": adamw.init(local)}
    torch.cuda.synchronize()
    out["state_bytes"] = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    secs["setup"] = time.perf_counter() - t0
    yard = torch.load(root / "yard.pt", mmap=True, weights_only=True)
    m = TRAIN_BATCH // cfg.microbatches // mesh.size("data") * TRAIN_SEQ  # rows per call
    per_mb = 2 * 7 * cfg.n_layers + 1

    # ---- step 1: microbatch 0's kernel calls against the plain version, its
    # int32 products against the unsharded step's, then the whole step
    calls, products, shapes = [], [], {}
    inner_mm, inner_prod = ops.mma_matmul, sharded_lm.mma_product

    def recording_mm(x, w, **kw):
        o = inner_mm(x, w, **kw)
        if len(calls) < per_mb:
            x2 = x.reshape(-1, x.shape[-1])
            want = mk.mma_matmul_plain(x2, w, planes=kw["planes"])
            calls.append(bool(torch.equal(o.reshape(want.shape), want)))
            shapes.setdefault((x2.shape[0], x2.shape[1], w.shape[1]), (x2.clone(), w.clone()))
        return o

    def recording_prod(*a, **kw):
        acc = inner_prod(*a, **kw)
        if len(products) < len(yard["int32"]):
            products.append(acc)
        return acc

    mk.launches = 0
    ops.mma_matmul, sharded_lm.mma_product = recording_mm, recording_prod
    t0 = time.perf_counter()
    try:
        state, m1 = step(state, get_batch(dcfg, 0))
        torch.cuda.synchronize()
    finally:
        ops.mma_matmul, sharded_lm.mma_product = inner_mm, inner_prod
    secs["step1"] = time.perf_counter() - t0
    out["launches_step1"] = mk.launches
    out["calls_exact"] = [sum(calls), len(calls)]
    names = ["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"] * cfg.n_layers + ["head"]
    equal = []
    for name, got, want in zip(names, products, yard["int32"]):
        want = want[di:di + 1]  # microbatch 0's rows of this data rank
        if name not in ("wo", "w_down"):  # column-parallel: this rank's columns
            want = want[..., ri * got.shape[-1]:(ri + 1) * got.shape[-1]]
        equal.append(bool(torch.equal(got.cpu(), want)))
    out["int32_equal"] = [sum(equal), len(equal), len(yard["int32"])]
    del products
    out["loss1"], out["grad_norm1"] = float(m1["loss"]), float(m1["grad_norm"])
    t0 = time.perf_counter()
    worst, differ, n_el = 0.0, 0, 0
    lr = float(m1["lr"])
    for got, want, sh in zip(tree_leaves(state["params"]), tree_leaves(yard["params"]),
                             tree_leaves(st_sh["params"])):
        full = shd.gather(got, sh)
        if rank == 0:  # in units of (two lr-sized steps + one bf16 ulp of the value)
            g, w = full.float().cpu(), want.float()
            diff = (g - w).abs()
            allowed = 2 * lr + torch.finfo(torch.bfloat16).eps * w.abs()
            worst = max(worst, float((diff / allowed).max()))
            differ += int((diff > 0).sum())
            n_el += g.numel()
        del full
    out["param_worst"], out["param_differ"], out["param_n"] = worst, differ, n_el
    secs["check1"] = time.perf_counter() - t0

    # ---- the checkpoint: the state gathered to rank 0's host and saved; each
    # rank keeps the slices the (1, 4) mesh will hold, for the restore's check
    t0 = time.perf_counter()
    st_b = ts.state_shardings(ab, cfg, mesh_b)
    host, expect = [], []
    for t, sh, sh_b in zip(tree_leaves(state), tree_leaves(st_sh), tree_leaves(st_b)):
        full = shd.gather(t, sh)
        expect.append(shd.shard(full, sh_b).to("cpu", copy=True))
        if rank == 0:
            host.append(full.to("cpu", copy=True))
        del full
    ckpt_dir = root / "ckpt"
    if rank == 0:
        Checkpointer(ckpt_dir).save(1, {"state": tree_unflatten(state, host)})
    del host
    dist.barrier()
    secs["save"] = time.perf_counter() - t0

    # ---- step 2, the timed one: launches, collectives, host wall
    batch1 = get_batch(dcfg, 1)
    coll.reset_stats(mesh)
    mk.launches = 0
    dist.barrier()
    t0 = time.perf_counter()
    state, m2 = step(state, batch1)
    torch.cuda.synchronize()
    out["step2_s"] = time.perf_counter() - t0
    out["launches_step2"] = mk.launches
    out["collectives"] = coll.collective_stats(mesh)
    out["collective_s"] = coll.collective_seconds(mesh)
    out["loss2"], out["grad_norm2"] = float(m2["loss"]), float(m2["grad_norm"])

    # ---- step 3, rank 0's under torch.profiler (the others run it plainly):
    # host wall, device busy (rank 0's kernels and copies), idle share, and
    # the share of the wall in the gloo transport
    box = {}

    def step3():
        box["state"], _ = step(state, get_batch(dcfg, 2))

    coll.reset_stats(mesh)
    dist.barrier()
    if rank == 0:
        wall_ms, busy_ms, idle, by_name = device_idle(torch, step3)
        mma_ms = sum(v[1] for name, v in by_name.items() if "mma_tc_horner_kernel" in name)
        gemm_ms = sum(v[1] for name, v in by_name.items()
                      if any(x in name.lower() for x in GEMM_NAMES))
        out["profiled"] = dict(wall_ms=wall_ms, busy_ms=busy_ms, idle=idle, kernel_ms=mma_ms,
                               gemm_ms=gemm_ms,
                               gloo_share=sum(coll.collective_seconds(mesh).values()) * 1e3
                               / wall_ms)
    else:
        step3()
        torch.cuda.synchronize()
    state = box.pop("state")

    # ---- compressed gradient sync across the two data ranks, once, on one
    # microbatch's gradients of this rank
    t0 = time.perf_counter()
    mb = {"tokens": torch.as_tensor(batch1["tokens"][0])[di:di + 1]}
    with shd.use_mesh(mesh):
        _, grads = ts.value_and_grad(partial(sharded_lm.loss_fn, cfg=cfg, mesh=mesh, device=dev),
                                     state["params"], mb)
    f = gc.compressed_psum_shardmap(mesh, ("data",))
    err0 = tree_unflatten(grads, [torch.zeros(g.shape, dtype=torch.float32, device=dev)
                                  for g in tree_leaves(grads)])
    coll.reset_stats(mesh)
    synced, _ = f(grads, err0)
    gc_stats = coll.collective_stats(mesh)
    ratio = 0.0
    for g, s in zip(tree_leaves(grads), tree_leaves(synced)):
        exact = coll.all_reduce(g.float(), mesh, "data") / 2
        bound = coll.all_reduce(g.float().abs().amax(), mesh, "data", "max") / 127
        ratio = max(ratio, float((s - exact).abs().max() / bound))
    out["gc"] = {"ratio": ratio, "leaves": len(tree_leaves(grads)), "stats": gc_stats}
    del grads, synced, err0, state
    torch.cuda.empty_cache()
    secs["gc"] = time.perf_counter() - t0

    # ---- restore under (1, 4): bit-equal; then one step from it
    t0 = time.perf_counter()
    resumed, start = trainer.resume(ab, trainer.TrainerConfig(ckpt_dir=str(ckpt_dir)),
                                    shardings=st_b)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    out["restored_equal"] = start == 1 and all(
        torch.equal(a.cpu(), b) for a, b in zip(tree_leaves(resumed), expect))
    del expect
    step_b = ts.build_jitted_train_step(cfg, mesh_b, ab, abatch)
    resumed, mb2 = step_b(resumed, batch1)
    torch.cuda.synchronize()
    out["loss2_b"], out["grad_norm2_b"] = float(mb2["loss"]), float(mb2["grad_norm"])
    out["state_bytes_b"] = sum(t.numel() * t.element_size() for t in tree_leaves(resumed))
    del resumed
    torch.cuda.empty_cache()
    secs["restore"] = time.perf_counter() - t0

    # ---- GPipe: PP 2 (two layers per stage) x DP 2, the loss and its gradient
    # on step 1's batch, against the unsharded loss_fn's (``yard_pp.pt``)
    t0 = time.perf_counter()
    pcfg, _ = pipeline_cfgs()
    params = transformer.init_params(0, pcfg, device=dev)
    stage = shd.shard_tree(params, pp.stage_shardings(params, mesh))
    del params
    stage = layers.tree_map(lambda t: t.detach().requires_grad_(), stage)
    named = [(k, t) for k in stage for t in tree_leaves(stage[k])]
    tokens = get_batch(dcfg, 0)["tokens"].reshape(TRAIN_BATCH, TRAIN_SEQ + 1)
    coll.reset_stats(mesh)
    mk.launches = 0
    dist.barrier()
    t1 = time.perf_counter()
    with shd.use_mesh(mesh):
        loss_pp, _ = pp.pipelined_loss_fn(stage, {"tokens": tokens}, pcfg,
                                          n_micro=pcfg.microbatches, device=dev)
    grads = torch.autograd.grad(loss_pp, [t for _, t in named])
    torch.cuda.synchronize()
    out["pp_s"] = time.perf_counter() - t1
    out["pp_launches"] = mk.launches
    out["pp_collectives"] = coll.collective_stats(mesh)
    out["pp_collective_s"] = coll.collective_seconds(mesh)
    out["loss_pp"] = float(loss_pp.detach())
    out["pp_stage"] = stage_i = mesh.index("model")
    per = pcfg.n_layers // mesh.size("model")
    yard_pp = torch.load(root / "yard_pp.pt", mmap=True, weights_only=True)
    seen = {k: 0 for k in stage}
    rel, block_max = {}, []
    for (k, _), gr in zip(named, grads):
        want = yard_pp[k][seen[k]]
        seen[k] += 1
        if k == "blocks":  # this stage's layers of the stacked leaf
            want = want[stage_i * per:(stage_i + 1) * per]
            block_max.append(float(gr.abs().max()))
        want = want.to(dev).float()
        diff, scale = float((gr.float() - want).abs().max()), float(want.abs().max())
        rel[k] = max(rel.get(k, 0.0), diff / scale if scale > 0 else (0.0 if diff == 0 else
                                                                      float("inf")))
    out["pp_grad_rel"], out["pp_block_grad_max"] = rel, block_max
    del stage, named, grads, yard_pp
    torch.cuda.empty_cache()
    secs["pipeline"] = time.perf_counter() - t0

    # ---- expert parallelism: one OLMoE-1B-7B MoE layer at full width over
    # model = 4 (16 experts per rank), T = MOE_T tokens, dropless
    t0 = time.perf_counter()
    mcfg = get_config("olmoe_1b_7b")
    mcfg = mcfg.replace(moe=dataclasses.replace(mcfg.moe, capacity_factor=64.0))
    g = torch.Generator(device=dev).manual_seed(11)
    mp_full = moe_lib.init_moe(g, mcfg, device=dev)
    x = (torch.randn((1, MOE_T, mcfg.d_model), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    ex = NamedSharding(mesh_b, P("model", None, None))
    mp_local = {**mp_full, **{k: shd.shard(mp_full[k], ex) for k in ("w_gate", "w_up", "w_down")}}
    # with a gradient: of sum(y * wts) with respect to x and this rank's w_gate
    xg, wg = x.detach().requires_grad_(), mp_local["w_gate"].detach().requires_grad_()
    coll.reset_stats(mesh_b)
    with shd.use_mesh(mesh_b):
        y_ep = moe_lib.moe_ffn_ep({**mp_local, "w_gate": wg}, xg, mcfg)
    ep_stats = coll.collective_stats(mesh_b)
    wts = torch.randn(y_ep.shape, generator=g, device=dev)
    gx_ep, gw_ep = torch.autograd.grad((y_ep.float() * wts).sum(), [xg, wg])
    m_cfg = mcfg.moe
    sl = MOE_T // mesh_b.size("model")
    cap = moe_lib.capacity(sl, m_cfg)
    # the plain version: moe_ffn's dispatch, experts and combine on every
    # slab with the router logits the EP body takes (float32), every expert
    # on this rank; and moe_ffn itself (its router is bf16)
    xg1, wg1 = x.detach().requires_grad_(), mp_full["w_gate"].detach().requires_grad_()
    y_plain, sets_differ = [], 0
    for j in range(mesh_b.size("model")):
        xf = xg1[0, j * sl:(j + 1) * sl]
        logits = xf.float() @ mp_full["router"]["w"].float()
        xe, meta = moe_lib._local_dispatch(xf, logits, m_cfg.n_experts, m_cfg.top_k, cap,
                                           xf.dtype)
        y_plain.append(moe_lib._local_combine(moe_lib.expert_ffn({**mp_full, "w_gate": wg1}, xe),
                                              meta, sl, cap, xf.dtype))
        with torch.no_grad():
            top_bf16 = moe_lib._top_k(torch.softmax(moe_lib.router_logits(mp_full, xf), -1),
                                      m_cfg.top_k)[1]
            top_f32 = moe_lib._top_k(torch.softmax(logits, -1), m_cfg.top_k)[1]
            sets_differ += int((top_bf16.sort(-1)[0] != top_f32.sort(-1)[0]).any(-1).sum())
            if j == mesh_b.index("model"):  # this rank's slab: its routing, card vs CPU
                _, meta_cpu = moe_lib._local_dispatch(xf.cpu(), logits.cpu(), m_cfg.n_experts,
                                                      m_cfg.top_k, cap, xf.dtype)
                routing_equal = all(torch.equal(a.cpu(), b) for i, (a, b) in
                                    enumerate(zip(meta, meta_cpu)) if i != 3)
                kept = int(meta[4].sum())
    y_plain = torch.cat(y_plain)[None]
    gx1, gw1 = torch.autograd.grad((y_plain.float() * wts).sum(), [xg1, wg1])
    gw1 = shd.shard(gw1, ex)
    with torch.no_grad():
        y_ffn = moe_lib.moe_ffn(mp_full, x, mcfg)
    torch.cuda.synchronize()
    scale = y_plain.detach().float().abs().max()
    out["moe"] = {
        "routing_equal": routing_equal,
        "rel": float((y_ep.detach().float() - y_plain.detach().float()).abs().max() / scale),
        "rel_moe_ffn": float((y_ep.detach().float() - y_ffn.float()).abs().max() / scale),
        "grad_rel": [float((a.float() - b.float()).abs().max() / b.float().abs().max())
                     for a, b in ((gx_ep, gx1), (gw_ep, gw1))],
        "sets_differ": sets_differ, "kept": kept, "assignments": sl * m_cfg.top_k, "cap": cap,
        "experts_local": int(mp_local["w_gate"].shape[0]), "stats": ep_stats}
    del mp_full, mp_local, xg, wg, xg1, wg1, y_ep, y_plain, gx_ep, gw_ep, gx1, gw1
    torch.cuda.empty_cache()
    secs["moe"] = time.perf_counter() - t0

    # ---- OLMoE-1B-7B, 2 layers at full width: one sharded step
    t0 = time.perf_counter()
    moe_shapes = _olmoe_rank(torch, root, mesh, dev, out)
    secs["olmoe"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _olmoe_ep_rank(torch, mesh, dev, out)
    secs["olmoe_ep"] = time.perf_counter() - t0

    # ---- the unscaled kernel at this rank's shapes (rank 0, the others wait)
    t0 = time.perf_counter()
    dist.barrier()
    if rank == 0:
        mcfg, _ = parallel_moe_cfgs()
        out["times"] = _par_times(torch, graph_ms, mk, par_shapes(cfg, m), shapes)
        m_moe = TRAIN_BATCH // mcfg.microbatches // mesh.size("data") * TRAIN_SEQ
        out["moe_times"] = _par_times(torch, graph_ms, mk, par_shapes(mcfg, m_moe), moe_shapes)
        out["family_times"] = {}
        for tag, _, fcfg, _ in parallel_family_cfgs():
            out["family_times"][tag] = _par_times(torch, graph_ms, mk, par_shapes(fcfg, par_m(fcfg)),
                                                  family_shapes[tag])
    dist.barrier()
    secs["times"] = time.perf_counter() - t0
    secs["all"] = time.perf_counter() - t_all
    out["secs"] = secs
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if rank == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


def _par_times(torch, graph_ms, mk, par_rows, shapes) -> list:
    """The unscaled kernel graph-timed at each of a step's shapes on one
    rank, against ``torch._int_mm`` and the bound."""
    rows = []
    for name, mm, k, n, per_step in par_rows:
        x8, w8 = shapes[(mm, k, n)]
        ms = graph_ms(torch, lambda: mk.mma_matmul_kernel(x8, w8, planes=8), calls=5, reps=5)
        check(torch.equal(torch._int_mm(x8, w8), mk.mma_matmul_kernel(x8, w8)),
              f"parallel {name}: library yardstick disagrees with the kernel")
        lib_ms = graph_ms(torch, lambda: torch._int_mm(x8, w8), calls=5, reps=5)
        nbytes, nops = mm * k + k * n + 4 * mm * n, 2 * mm * k * n
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT8_OPS_PER_S * 1e3
        rows.append(dict(name=name, M=mm, K=k, N=n, calls=per_step, ms=ms, library_ms=lib_ms,
                         bound_ms=max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations",
                         plane_floor_ms=8 * t_o))
    return rows


def one_rank_at_a_time(dist, fn):
    """``fn()`` on each rank in turn, a barrier between: a rank's draw of a
    whole tree, of which it keeps its slices.  Four whole trees and their
    float32 draws do not fit on the one card beside each other
    (InternVL2-76B's: 5.9 GB of bf16 and a 4.2 GB float32 head each)."""
    import torch

    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            out = fn()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _model_rank(torch, root: Path, mesh, dev, cfg, dcfg, yard: str) -> tuple[dict, dict]:
    """One sharded step of ``cfg`` on this rank: microbatch 0's kernel calls
    against the plain version and its int32 products against the unsharded
    step's (``root/yard``), then the whole step's launches (by shape too),
    collectives, loss and grad_norm.  Returns the results and one (x, w) per
    kernel shape for the timings."""
    import collections

    import torch.distributed as dist

    from repro_torch import models
    from repro_torch.checkpoint.ckpt import tree_leaves
    from repro_torch.data.pipeline import get_batch
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharded_lm
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import train_step as ts

    di, ri = mesh.index("data"), mesh.index("model")
    allocated_before = torch.cuda.memory_allocated()
    ab = ts.abstract_state(cfg)
    st_sh = ts.state_shardings(ab, cfg, mesh)
    step = ts.build_jitted_train_step(cfg, mesh, ab, par_batch(torch, cfg))
    local = one_rank_at_a_time(dist, lambda: shd.shard_tree(
        models.build(cfg).init_params(0, cfg, device=dev), st_sh["params"]))
    state = {"params": local, "opt": adamw.init(local)}
    torch.cuda.synchronize()
    res = {"state_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(state)),
           "allocated_before": allocated_before}
    if cfg.moe.n_experts:
        res["experts_local"] = int(local["blocks"]["moe"]["w_gate"].shape[1])
    yard_int32 = torch.load(root / yard, weights_only=True)["int32"]
    per_mb = sum(mb_linears(cfg))
    calls, products, shapes, by_shape = [], [], {}, collections.Counter()
    inner_mm, inner_prod = ops.mma_matmul, sharded_lm.mma_product

    def recording_mm(x, w, **kw):
        o = inner_mm(x, w, **kw)
        x2 = x.reshape(-1, x.shape[-1])
        by_shape[(x2.shape[0], x2.shape[1], w.shape[1])] += 1
        if len(calls) < per_mb:
            # the plain version (float64 products) in blocks of columns: its
            # whole-head temporaries would not fit beside four ranks' state
            o2 = o.reshape(x2.shape[0], -1)
            calls.append(all(
                torch.equal(o2[:, j:j + 4096], mk.mma_matmul_plain(x2, w[:, j:j + 4096],
                                                                   planes=kw["planes"]))
                for j in range(0, w.shape[1], 4096)))
            shapes.setdefault((x2.shape[0], x2.shape[1], w.shape[1]), (x2.clone(), w.clone()))
        return o

    def recording_prod(*a, **kw):
        acc = inner_prod(*a, **kw)
        if len(products) < len(yard_int32):
            products.append(acc)
        return acc

    coll.reset_stats(mesh)
    mk.launches = 0
    ops.mma_matmul, sharded_lm.mma_product = recording_mm, recording_prod
    dist.barrier()
    t0 = time.perf_counter()
    try:
        state, met = step(state, get_batch(dcfg, 0))
        torch.cuda.synchronize()
    finally:
        ops.mma_matmul, sharded_lm.mma_product = inner_mm, inner_prod
    res["step_s"] = time.perf_counter() - t0
    res["launches"] = mk.launches
    res["launches_by_shape"] = [[*k, v] for k, v in sorted(by_shape.items())]
    res["collectives"] = coll.collective_stats(mesh)
    res["collective_s"] = coll.collective_seconds(mesh)
    res["calls_exact"] = [sum(calls), len(calls)]
    rows = par_global_batch(cfg) // cfg.microbatches // mesh.size("data")
    equal = []
    for got, want in zip(products, yard_int32):
        want = want[di * rows:(di + 1) * rows]  # microbatch 0's rows of this data rank
        if got.shape[-1] != want.shape[-1]:  # column-parallel: this rank's columns
            want = want[..., ri * got.shape[-1]:(ri + 1) * got.shape[-1]]
        equal.append(bool(torch.equal(got.cpu(), want)))
    res["int32_equal"] = [sum(equal), len(equal), len(yard_int32)]
    res["int32_differ"] = [i for i, e in enumerate(equal) if not e]
    res["loss"], res["grad_norm"] = float(met["loss"]), float(met["grad_norm"])
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    del state, local, products, yard_int32
    torch.cuda.empty_cache()
    return res, shapes


def _olmoe_rank(torch, root: Path, mesh, dev, out: dict) -> dict:
    """Phase 16's OLMoE step on this rank (``_model_rank``).  Returns one
    (x, w) per kernel shape for the timings."""
    cfg, dcfg = parallel_moe_cfgs()
    out["olmoe"], shapes = _model_rank(torch, root, mesh, dev, cfg, dcfg, "yard_moe.pt")
    return shapes


def _olmoe_ep_rank(torch, mesh, dev, out: dict) -> None:
    """Phase 16's unquantized OLMoE step on this rank (the expert-parallel
    path): its launches, collectives, loss and grad_norm."""
    import torch.distributed as dist

    from repro_torch.checkpoint.ckpt import tree_leaves
    from repro_torch.data.pipeline import get_batch
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import train_step as ts

    cfg, dcfg = parallel_moe_ep_cfgs()
    ab = ts.abstract_state(cfg)
    st_sh = ts.state_shardings(ab, cfg, mesh)
    step = ts.build_jitted_train_step(cfg, mesh, ab, par_batch(torch, cfg))
    params = transformer.init_params(0, cfg, device=dev)
    local = shd.shard_tree(params, st_sh["params"])
    del params
    state = {"params": local, "opt": adamw.init(local)}
    torch.cuda.synchronize()
    res = {"state_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(state))}
    coll.reset_stats(mesh)
    mk.launches = 0
    dist.barrier()
    t0 = time.perf_counter()
    state, met = step(state, get_batch(dcfg, 0))
    torch.cuda.synchronize()
    res["step_s"] = time.perf_counter() - t0
    res["launches"] = mk.launches
    res["collectives"] = coll.collective_stats(mesh)
    res["collective_s"] = coll.collective_seconds(mesh)
    res["loss"], res["grad_norm"] = float(met["loss"]), float(met["grad_norm"])
    out["olmoe_ep"] = res
    del state, local
    torch.cuda.empty_cache()


def parallel_training(torch, np, dev, card, phases=(16, 17)):
    """Phase 16: parallel training (main path 11), and phase 17: sharded
    serving (main path 12), on the same 4 ranks.  The unsharded steps in
    this process first (the yardsticks), their weights freed, and the dry
    run's predictions; then 4 ranks in 4 processes on the card
    (``parallel_rank``), their gates checked here.  ``phases``: both, or
    one of them.  Returns the kernels' entries of the phases run."""
    import torch.multiprocessing as mp

    from repro_torch import models
    from repro_torch.checkpoint.ckpt import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.core import mma
    from repro_torch.data.pipeline import get_batch
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.models import moe as moe_lib
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, dcfg = parallel_cfgs()
    root = SRC.parent / "chip_scratch" / "parallel"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    per_step = par_launches(cfg)

    def yardstick(c, dc_, moe_ep=None):
        """One unsharded step: microbatch 0's forward int32 products (on the
        host), the new params, loss, grad_norm, sizes and wall.  ``moe_ep``
        stands in for ``moe_ffn_ep`` during the step."""
        params = models.build(c).init_params(0, c, device=dev)
        n_params = sum(p.numel() for p in tree_leaves(params))
        state = {"params": params, "opt": adamw.init(params)}
        state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
        rec, inner = [], mma.mma_dot

        def recording(*a, **kw):
            acc = inner(*a, **kw)
            if len(rec) < mb_linears(c)[0]:
                rec.append(acc.cpu())
            return acc

        mk.launches = 0
        mma.mma_dot, inner_ep = recording, moe_lib.moe_ffn_ep
        if moe_ep is not None:
            moe_lib.moe_ffn_ep = moe_ep
        t0 = time.perf_counter()
        try:
            new, m1 = ts.train_step(state, get_batch(dc_, 0), c, device=dev)
            torch.cuda.synchronize()
        finally:
            mma.mma_dot, moe_lib.moe_ffn_ep = inner, inner_ep
        wall = time.perf_counter() - t0
        check(mk.launches == par_launches(c), f"unsharded {c.name} step: {mk.launches} unscaled "
              f"launches, expected {par_launches(c)}")
        out = dict(int32=rec, params=[p.cpu() for p in tree_leaves(new["params"])],
                   loss=float(m1["loss"]), grad_norm=float(m1["grad_norm"]), n_params=n_params,
                   state_bytes=state_bytes, wall=wall)
        del state, new, params
        torch.cuda.empty_cache()
        return out

    if 16 in phases:
        # ---- the yardsticks: one unsharded step of each model
        y = yardstick(cfg, dcfg)
        loss1, norm1 = y["loss"], y["grad_norm"]
        torch.save({"int32": y["int32"], "params": y["params"]}, root / "yard.pt")
        print(f"[parallel] {card} | Yi-6B at full width, {cfg.n_layers} of 32 layers: "
              f"{y['n_params'] / 1e9:.3f} G params, {y['state_bytes'] / 1e9:.2f} GB of state; the "
              f"unsharded step (the yardstick): loss {loss1:.6f}, grad_norm {norm1:.6f}, {per_step} "
              f"unscaled launches, host wall {y['wall']:.2f} s")
        del y
        mcfg, mdcfg = parallel_moe_cfgs()
        moe_per_step = par_launches(mcfg)
        ym = yardstick(mcfg, mdcfg)
        loss_m, norm_m = ym["loss"], ym["grad_norm"]
        torch.save({"int32": ym["int32"]}, root / "yard_moe.pt")
        print(f"[parallel] {card} | OLMoE-1B-7B at full width, {mcfg.n_layers} of 16 layers (64 "
              f"experts, top-8): {ym['n_params'] / 1e9:.3f} G params, {ym['state_bytes'] / 1e9:.2f} GB "
              f"of state; the unsharded step (the yardstick): loss {loss_m:.6f}, grad_norm "
              f"{norm_m:.6f}, {moe_per_step} unscaled launches, host wall {ym['wall']:.2f} s")
        del ym
        ecfg, edcfg = parallel_moe_ep_cfgs()
        ye = yardstick(ecfg, edcfg, moe_ep=lambda p, x, c: moe_ep_plain(torch, p, x, c))
        loss_e, norm_e = ye["loss"], ye["grad_norm"]
        print(f"[parallel] {card} | OLMoE-1B-7B unquantized, the same weights and batch: the "
              f"unsharded step with moe_ffn_ep's slabs (data 2 x model 2, each routed alone on "
              f"float32 logits): loss {loss_e:.6f}, grad_norm {norm_e:.6f}, host wall "
              f"{ye['wall']:.2f} s")
        del ye

        # ---- (c) the ssm, hybrid, encdec and vlm models' yardsticks
        fams = {}
        for tag, label, fcfg, fdcfg in parallel_family_cfgs():
            yf = yardstick(fcfg, fdcfg)
            torch.save({"int32": yf["int32"]}, root / f"yard_{tag}.pt")
            fams[tag] = dict(label=label, cfg=fcfg, loss=yf["loss"], grad_norm=yf["grad_norm"],
                             n_params=yf["n_params"], state_bytes=yf["state_bytes"], wall=yf["wall"])
            depth = (f"{fcfg.enc_layers} + {fcfg.n_layers} of 32 + 32 encoder + decoder layers, "
                     f"{fcfg.enc_seq} frames" if fcfg.family == "encdec"
                     else f"{fcfg.n_layers} of {get_config(tag).n_layers} layers")
            print(f"[parallel] {card} | {label} at full width, {depth}: {yf['n_params'] / 1e9:.3f} G "
                  f"params, {yf['state_bytes'] / 1e9:.2f} GB of state; the unsharded step (the "
                  f"yardstick): loss {yf['loss']:.6f}, grad_norm {yf['grad_norm']:.6f}, "
                  f"{par_launches(fcfg)} unscaled launches, host wall {yf['wall']:.2f} s")
            del yf

        # ---- GPipe's yardstick (the unsharded loss_fn and its gradient at
        # PP_LAYERS layers) and the dry run's count of one rank's pipeline step
        loss_pp1, pp_wall = pipeline_yardstick(torch, dev, root / "yard_pp.pt")
        pred_pp = pipeline_prediction(torch)
        pcfg, _ = pipeline_cfgs()
        print(f"[parallel] {card} | GPipe's yardstick: Yi-6B at full width, {pcfg.n_layers} of "
              f"32 layers, the unsharded loss_fn and its gradient, each of the {TRAIN_BATCH} rows "
              f"alone (as PP 2 x DP 2 over {pcfg.microbatches} microbatches meets them): loss "
              f"{loss_pp1:.6f}, host wall {pp_wall:.2f} s; dry run, one rank of PP 2 x DP 2 "
              f"(launch.dryrun_pp.count on meta tensors): the loss and its gradient make "
              f"{pred_pp['collectives']['counts_by_kind']} "
              f"({pred_pp['collectives']['total_bytes']} bytes)")

        # ---- the dry run's prediction of one rank of the (2, 2) mesh, each model
        pred, pred_m = dry_prediction(torch, cfg), dry_prediction(torch, mcfg)
        pred_e = dry_prediction(torch, ecfg)
        for f in fams.values():
            f["pred"] = dry_prediction(torch, f["cfg"])
        for label, p in (("Yi-6B", pred), ("OLMoE-1B-7B", pred_m),
                         ("OLMoE-1B-7B unquantized", pred_e),
                         *((f["label"], f["pred"]) for f in fams.values())):
            print(f"[parallel] dry run, {label}, one rank of (data {p['mesh_shape'][0]}, model "
                  f"{p['mesh_shape'][1]}), counted on meta "
                  f"tensors in {p['seconds']:.1f} s: state {p['state_bytes']} bytes; per step "
                  f"{p['collectives']['counts_by_kind']} ({p['collectives']['total_bytes']} bytes), "
                  f"{p['census']['products']} products ({p['census']['int8_products']} int8), "
                  f"{p['census']['flops']:.4e} FLOPs, {p['hbm_bytes']:.4e} bytes of HBM traffic "
                  f"(analytic); roofline bound {p['roofline']['step_time_lower_bound_s'] * 1e3:.2f} ms "
                  f"({p['roofline']['dominant']}) at the H100 SXM data sheet's peaks")

    # ---- phase 17: the unsharded serving steps (the yardsticks) and the dry
    # run's prediction of one rank's state and collectives, each model
    yards, preds = {}, {}
    if 17 in phases:
        t17 = time.perf_counter()
        for sm in serve_cfgs():
            tag = sm.tag
            yards[tag] = serving_yardstick(torch, np, dev, sm)
            int32_keys = [k for k in yards[tag] if k.startswith("int32_")]
            torch.save({k: yards[tag][k] for k in int32_keys + ["logits", "tokens", "prefix_logits",
                                                               "routing", "router"]
                        if k in yards[tag]}, root / f"yard_serve_{tag}.pt")
            for k in int32_keys + ["routing", "router"]:
                del yards[tag][k]
            preds[tag] = p17 = serve_prediction(torch, sm)
            prefix = (f"prefix prefill {p17['prefix']['counts_by_kind']} "
                      f"({p17['prefix']['total_bytes']} bytes), " if "prefix" in p17 else "")
            print(f"[serving] {card} | {sm.label}: the unsharded yardstick, {sm.rows} rows: "
                  f"{yards[tag]['launches']} (scaled, unscaled) launches per decode step; dry run, "
                  f"one rank of (data 2, model 2), {p17['mode']}, counted on meta tensors in "
                  f"{p17['seconds']:.1f} s: state {p17['param_bytes']} + {p17['cache_bytes']} + "
                  f"{p17['extras_bytes']} bytes (params, cache, extras; the whole tree's params "
                  f"{p17['tree_bytes']}); {prefix}prefill "
                  f"{p17['prefill']['counts_by_kind']} ({p17['prefill']['total_bytes']} bytes), "
                  f"decode step {p17['decode']['counts_by_kind']} "
                  f"({p17['decode']['total_bytes']} bytes)")
        prep17_s = time.perf_counter() - t17

    # ---- the ranks
    (root / "phases.json").write_text(json.dumps(list(phases)))
    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=parallel_rank, args=(r, PAR_WORLD, str(root)))
             for r in range(PAR_WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + PAR_JOIN_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    ranks_s = time.perf_counter() - t0
    check(not alive, f"ranks {alive} still running after {PAR_JOIN_S} s")
    check([p.exitcode for p in procs] == [0] * PAR_WORLD,
          f"rank exit codes {[p.exitcode for p in procs]}")
    outs = rank_outputs(torch, root)
    shutil.rmtree(root, ignore_errors=True)

    result = {}
    if 16 in phases:
        # ---- gates
        total_state = sum(o["state_bytes"] for o in outs)
        for o in outs:
            r, om = o["rank"], o["olmoe"]
            check(o["state_bytes"] == pred["state_bytes"] and om["state_bytes"] == pred_m["state_bytes"],
                  f"rank {r}: state bytes {o['state_bytes']}, {om['state_bytes']} against the dry "
                  f"run's {pred['state_bytes']}, {pred_m['state_bytes']}")
            check(same_collectives(o["collectives"], pred["collectives"]),
                  f"rank {r}: Yi-6B step's collectives {o['collectives']} against the dry run's "
                  f"{pred['collectives']}")
            check(same_collectives(om["collectives"], pred_m["collectives"]),
                  f"rank {r}: OLMoE step's collectives {om['collectives']} against the dry run's "
                  f"{pred_m['collectives']}")
            n_mb = 2 * block_mma_linears(mcfg) * mcfg.n_layers + 1
            check(om["calls_exact"][0] == om["calls_exact"][1] == n_mb,
                  f"rank {r}: OLMoE microbatch 0's kernel calls bit-exact {om['calls_exact']}")
            n_fwd = block_mma_linears(mcfg) * mcfg.n_layers + 1
            check(om["int32_equal"][0] == om["int32_equal"][1] == om["int32_equal"][2] == n_fwd,
                  f"rank {r}: OLMoE int32 products equal to the unsharded step's {om['int32_equal']}")
            check(om["launches"] == moe_per_step, f"rank {r}: OLMoE launches per step "
                  f"{om['launches']}, expected {moe_per_step}")
            check(om["experts_local"] == mcfg.moe.n_experts // 2,
                  f"rank {r}: {om['experts_local']} experts on the rank")
            for k, want, tol in (("loss", loss_m, PAR_LOSS_REL), ("grad_norm", norm_m, PAR_NORM_REL)):
                check(np.isfinite(om[k]) and abs(om[k] - want) <= tol * abs(want),
                      f"rank {r}: OLMoE {k} {om[k]} against {want} (rel tolerance {tol})")
            oe = o["olmoe_ep"]
            check(oe["state_bytes"] == pred_e["state_bytes"]
                  and same_collectives(oe["collectives"], pred_e["collectives"]),
                  f"rank {r}: unquantized OLMoE step's state bytes {oe['state_bytes']} and "
                  f"collectives {oe['collectives']} against the dry run's {pred_e['state_bytes']}, "
                  f"{pred_e['collectives']}")
            check(oe["collectives"]["counts_by_kind"].get("all-to-all", 0) > 0 and oe["launches"] == 0,
                  f"rank {r}: unquantized OLMoE step: {oe['collectives']['counts_by_kind']}, "
                  f"{oe['launches']} unscaled launches (the expert-parallel path has all-to-alls "
                  "and no kernel)")
            for k, want, tol in (("loss", loss_e, PAR_LOSS_REL), ("grad_norm", norm_e, PAR_NORM_REL)):
                check(np.isfinite(oe[k]) and abs(oe[k] - want) <= tol * abs(want),
                      f"rank {r}: unquantized OLMoE {k} {oe[k]} against {want} (rel tolerance {tol})")
        print(f"[parallel] 4 ranks on the card, mesh (data 2, model 2), gloo over host memory: "
              f"state bytes per rank {[o['state_bytes'] for o in outs]} "
              f"({total_state / 1e9:.2f} GB together), peak allocated per rank "
              f"{[round(o['peak_bytes'] / 1e9, 2) for o in outs]} GB; library {outs[0]['library']} "
              f"(phase 1's, not rebuilt)")
        check(total_state < PAR_STATE_LIMIT, f"the ranks' state is {total_state / 1e9:.2f} GB")
        for o in outs:
            r = o["rank"]
            check(o["calls_exact"][0] == o["calls_exact"][1] == 2 * 7 * cfg.n_layers + 1,
                  f"rank {r}: microbatch 0's kernel calls bit-exact {o['calls_exact']}")
            check(o["int32_equal"][0] == o["int32_equal"][1] == o["int32_equal"][2] == 7 * cfg.n_layers + 1,
                  f"rank {r}: int32 products equal to the unsharded step's {o['int32_equal']}")
            check(o["launches_step1"] == o["launches_step2"] == per_step,
                  f"rank {r}: launches per step {o['launches_step1']}, {o['launches_step2']}, "
                  f"expected {per_step}")
            for k, want, tol in (("loss1", loss1, PAR_LOSS_REL), ("grad_norm1", norm1, PAR_NORM_REL),
                                 ("loss_pp", loss_pp1, PAR_LOSS_REL),
                                 ("loss2_b", o["loss2"], PAR_LOSS_REL),
                                 ("grad_norm2_b", o["grad_norm2"], PAR_NORM_REL)):
                check(np.isfinite(o[k]) and abs(o[k] - want) <= tol * abs(want),
                      f"rank {r}: {k} {o[k]} against {want} (rel tolerance {tol})")
            check(o["restored_equal"], f"rank {r}: the (1, 4) restore differs from the saved state")
            check(sorted(o["pp_grad_rel"]) == ["blocks", "embed", "head", "ln_f"]
                  and max(o["pp_grad_rel"].values()) <= PP_GRAD_REL
                  and min(o["pp_block_grad_max"]) > 0 and o["pp_launches"] == pp_launches(pcfg),
                  f"rank {r}: GPipe's gradient against the unsharded one's matching slice "
                  f"{o['pp_grad_rel']} (PP_GRAD_REL {PP_GRAD_REL}), its block leaves' largest "
                  f"{o['pp_block_grad_max']} (none may be 0), {o['pp_launches']} kernel launches "
                  f"(expected {pp_launches(pcfg)})")
            check(same_collectives(o["pp_collectives"], pred_pp["collectives"]),
                  f"rank {r}: GPipe's collectives {o['pp_collectives']} against the dry run's "
                  f"{pred_pp['collectives']}")
            check(o["gc"]["ratio"] <= 1.01, f"rank {r}: compressed sync error {o['gc']['ratio']} of "
                  "the int8 step")
            check(o["moe"]["routing_equal"] and o["moe"]["rel"] <= MOE_REL
                  and max(o["moe"]["grad_rel"]) <= MOE_REL
                  and o["moe"]["kept"] == o["moe"]["assignments"] and o["moe"]["experts_local"] == 16,
                  f"rank {r}: moe_ffn_ep {o['moe']}")
        o0 = outs[0]
        check(o0["param_worst"] <= 1.0 and o0["param_differ"] <= PAR_PARAM_DIFFER * o0["param_n"],
              f"params after one step: {o0['param_differ']} of {o0['param_n']} differ, the worst by "
              f"{o0['param_worst']} of two lr steps + one bf16 ulp")
        print(f"[parallel] microbatch 0 on each rank: {o0['calls_exact'][1]} unscaled calls bit-exact "
              f"against the plain version at the sharded shapes; {o0['int32_equal'][1]} int32 "
              f"products (column-parallel: the rank's columns; row-parallel: all-reduced) equal to "
              f"the unsharded step's, bit for bit")
        print(f"[parallel] step 1: loss {[o['loss1'] for o in outs]} vs {loss1} unsharded; grad_norm "
              f"{[o['grad_norm1'] for o in outs]} vs {norm1}; gathered params: "
              f"{o0['param_differ']} of {o0['param_n']} elements differ, the worst by "
              f"{o0['param_worst']:.3f} of (two lr steps + one bf16 ulp)")
        print(f"[parallel] {card} | {o0['launches_step2']} unscaled launches per step per rank (as the layout "
              f"gives); host wall per sharded step {[round(o['step2_s'], 3) for o in outs]} s "
              f"(step 2; step 1 with its checks {[round(o['secs']['step1'], 3) for o in outs]} s)")
        for o in outs[:1]:
            cs = o["collectives"]
            share = sum(o["collective_s"].values()) / o["step2_s"]
            print(f"[parallel] rank 0, step 2, collectives (gloo over host memory, not NVLink: "
                  f"nothing is claimed from their times): counts {cs['counts_by_kind']}, bytes "
                  f"{cs['bytes_by_kind']} ({cs['total_bytes'] / 1e9:.3f} GB); host seconds in the "
                  f"transport {({k: round(v, 3) for k, v in o['collective_s'].items()})}, "
                  f"{share:.3f} of the step")
        print(f"[parallel] checkpoint saved under (2, 2), restored under (1, 4) in "
              f"{[round(o['restore_s'], 1) for o in outs]} s: every rank's slices bit-equal; one "
              f"step from it: loss {o0['loss2_b']} vs {o0['loss2']} under (2, 2), grad_norm "
              f"{o0['grad_norm2_b']} vs {o0['grad_norm2']}; state per rank under (1, 4) "
              f"{[o['state_bytes_b'] for o in outs]}")
        pp_rel = {k: max(o["pp_grad_rel"][k] for o in outs) for k in o0["pp_grad_rel"]}
        print(f"[parallel] GPipe PP 2 x DP 2 ({pcfg.n_layers // 2} layers per stage, "
              f"{pcfg.microbatches} microbatches), the loss and its gradient: loss "
              f"{[o['loss_pp'] for o in outs]} vs {loss_pp1} unsharded (PAR_LOSS_REL "
              f"{PAR_LOSS_REL}); each leaf's gradient against the unsharded one's matching slice, "
              f"worst over the ranks by key: "
              + ", ".join(f"{k} {v:.3e}" for k, v in pp_rel.items())
              + f" of the slice's largest (PP_GRAD_REL {PP_GRAD_REL}); stage "
              f"{[o['pp_stage'] for o in outs]} blocks' largest gradient "
              f"{[max(o['pp_block_grad_max']) for o in outs]}; {o0['pp_launches']} unscaled "
              f"launches per rank (as the schedule gives); collectives equal the dry run's on "
              f"every rank: "
              f"{o0['pp_collectives']['counts_by_kind']} "
              f"({o0['pp_collectives']['total_bytes'] / 1e9:.3f} GB)")
        print(f"[parallel] {card} | GPipe host wall per rank {[round(o['pp_s'], 3) for o in outs]} "
              f"s, in the gloo transport "
              f"{[round(sum(o['pp_collective_s'].values()) / o['pp_s'], 3) for o in outs]} of it")
        pf = o0["profiled"]
        print(f"[parallel] {card} | Yi-6B sharded step 3, rank 0 under torch.profiler: host wall "
              f"{pf['wall_ms']:.1f} ms, device busy {pf['busy_ms']:.1f} ms (rank 0's kernels and "
              f"copies), idle share {pf['idle']:.3f}, in the gloo transport "
              f"{pf['gloo_share']:.3f} of the wall; the unscaled kernel {pf['kernel_ms']:.1f} ms, "
              f"stock matmuls {pf['gemm_ms']:.1f} ms of device time")
        print(f"[parallel] compressed_psum_shardmap over 'data', {o0['gc']['leaves']} gradient "
              f"leaves: error at most {max(o['gc']['ratio'] for o in outs):.3f} of the int8 step; "
              f"{o0['gc']['stats']['counts_by_kind']}, {o0['gc']['stats']['total_bytes'] / 1e6:.1f} "
              f"MB crossed per rank")
        mo = o0["moe"]
        print(f"[parallel] moe_ffn_ep, OLMoE-1B-7B layer, mesh (1, 4), {mo['experts_local']} experts "
              f"per rank, T = {MOE_T}: routing card = CPU on every slab, {mo['kept']} of "
              f"{mo['assignments']} assignments kept (cap {mo['cap']}), output within "
              f"{max(o['moe']['rel'] for o in outs):.2e} of moe_ffn's dispatch on the same float32 "
              f"router logits (MOE_REL {MOE_REL}), its gradients (x, the rank's w_gate) within "
              f"{max(max(o['moe']['grad_rel']) for o in outs):.2e}; forward "
              f"{mo['stats']['counts_by_kind']} | moe_ffn itself "
              f"(bf16 router): {mo['sets_differ']} of {MOE_T} tokens pick another expert set, "
              f"output {mo['rel_moe_ffn']:.3f} of the largest away (not gated)")
        print(f"[parallel] dry run against the ranks: state bytes per rank equal the prediction "
              f"(Yi-6B {pred['state_bytes']}, OLMoE-1B-7B {pred_m['state_bytes']}, unquantized "
              f"{pred_e['state_bytes']}); one step's collectives on every rank equal the counted "
              f"ones (Yi-6B step 2: {pred['collectives']['total_count']}, OLMoE step 1: "
              f"{pred_m['collectives']['total_count']}, unquantized: "
              f"{pred_e['collectives']['total_count']}) | roofline bound "
              f"{pred['roofline']['step_time_lower_bound_s'] * 1e3:.2f} ms against "
              f"{[round(o['step2_s'] * 1e3, 1) for o in outs]} ms measured (Yi-6B); "
              f"{pred_m['roofline']['step_time_lower_bound_s'] * 1e3:.2f} ms against "
              f"{[round(o['olmoe']['step_s'] * 1e3, 1) for o in outs]} ms (OLMoE-1B-7B); not gated")
        om0 = o0["olmoe"]
        ocs = om0["collectives"]
        print(f"[parallel] {card} | OLMoE-1B-7B sharded step, mesh (data 2, model 2), "
              f"{om0['experts_local']} experts per rank (global moe_ffn routing: the reference's path "
              f"under mma_int8): loss {[o['olmoe']['loss'] for o in outs]} vs {loss_m} unsharded; "
              f"grad_norm {[o['olmoe']['grad_norm'] for o in outs]} vs {norm_m}; {om0['launches']} "
              f"unscaled launches per step per rank (as the layout gives); microbatch 0's {om0['calls_exact'][1]} kernel "
              f"calls bit-exact, {om0['int32_equal'][1]} int32 products equal to the unsharded "
              f"step's; state {om0['state_bytes']} bytes per rank, peak allocated "
              f"{[round(o['olmoe']['peak_bytes'] / 1e9, 2) for o in outs]} GB")
        print(f"[parallel] {card} | OLMoE-1B-7B host wall per sharded step "
              f"{[round(o['olmoe']['step_s'], 3) for o in outs]} s; rank 0's collectives (gloo over "
              f"host memory, not NVLink: nothing is claimed from their times): counts "
              f"{ocs['counts_by_kind']}, bytes {ocs['bytes_by_kind']} ({ocs['total_bytes'] / 1e9:.3f} "
              f"GB); host seconds in the transport "
              f"{({k: round(v, 3) for k, v in om0['collective_s'].items()})}, "
              f"{sum(om0['collective_s'].values()) / om0['step_s']:.3f} of the step")
        oe0 = o0["olmoe_ep"]
        print(f"[parallel] {card} | OLMoE-1B-7B unquantized sharded step (the expert-parallel "
              f"path: sharded_lm._moe_ep, moe.ep_slab with a gradient, slabs of "
              f"{TRAIN_BATCH // mcfg.microbatches // 2 * TRAIN_SEQ // 2} tokens): loss "
              f"{[o['olmoe_ep']['loss'] for o in outs]} vs {loss_e}; grad_norm "
              f"{[o['olmoe_ep']['grad_norm'] for o in outs]} vs {norm_e} (PAR_LOSS_REL "
              f"{PAR_LOSS_REL}, PAR_NORM_REL {PAR_NORM_REL}); host wall "
              f"{[round(o['olmoe_ep']['step_s'], 3) for o in outs]} s; rank 0's collectives "
              f"{oe0['collectives']['counts_by_kind']} ({oe0['collectives']['total_bytes'] / 1e9:.3f} "
              f"GB), {sum(oe0['collective_s'].values()) / oe0['step_s']:.3f} of the step in gloo")
        moe_rows = o0["moe_times"]
        for row in moe_rows:
            print(f"[parallel] {card} | mma_matmul OLMoE sharded {row['name']} M={row['M']} "
                  f"K={row['K']} N={row['N']} ({row['calls']} per step per rank), planes 8: kernel "
                  f"{row['ms']:.4f} ms, torch._int_mm {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
        moe_step_ms = sum(r["calls"] * r["ms"] for r in moe_rows)
        moe_lib_ms = sum(r["calls"] * r["library_ms"] for r in moe_rows)
        moe_bound_ms = sum(r["calls"] * r["bound_ms"] for r in moe_rows)
        print(f"[parallel] {card} | OLMoE per step per rank (graph-timed shapes x calls): kernel "
              f"{moe_step_ms:.1f} ms, torch._int_mm {moe_lib_ms:.1f} ms, bound {moe_bound_ms:.2f} ms")
        rows = o0["times"]
        for row in rows:
            print(f"[parallel] {card} | mma_matmul sharded {row['name']} M={row['M']} K={row['K']} "
                  f"N={row['N']} ({row['calls']} per step per rank), planes 8: kernel "
                  f"{row['ms']:.4f} ms, torch._int_mm {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.5f} ms ({row['bound_by']}), plane-work floor "
                  f"{row['plane_floor_ms']:.5f} ms")
        step_ms = sum(r["calls"] * r["ms"] for r in rows)
        lib_ms = sum(r["calls"] * r["library_ms"] for r in rows)
        bound_ms = sum(r["calls"] * r["bound_ms"] for r in rows)
        print(f"[parallel] {card} | per step per rank (graph-timed shapes x calls): kernel "
              f"{step_ms:.1f} ms, torch._int_mm {lib_ms:.1f} ms, bound {bound_ms:.2f} ms")
        families = {tag: parallel_family_gates(np, card, f, outs, tag) for tag, f in fams.items()}
    if 16 in phases:
        phase_s = time.perf_counter() - t_phase
        print(f"[parallel] phase 16 took {phase_s:.1f} s with phase 17's yardsticks and ranks "
              f"(ranks {ranks_s:.1f} s; rank 0: "
              + ", ".join(f"{k} {v:.1f}" for k, v in o0["secs"].items()) + ")")
        result.update(
            launches_parallel=sum(o["launches_step1"] + o["launches_step2"]
                                  + o["olmoe"]["launches"]
                                  + sum(f["launches"] for f in o["families"].values())
                                  for o in outs),
            launches_parallel_per_step_per_rank=o0["launches_step2"],
            parallel_per_shape=rows,
            parallel_step=dict(kernel_ms=step_ms, library_ms=lib_ms, bound_ms=bound_ms,
                               host_s=[o["step2_s"] for o in outs],
                               collectives=o0["collectives"],
                               collective_s=o0["collective_s"]),
            launches_parallel_moe_per_step_per_rank=om0["launches"],
            parallel_moe_per_shape=moe_rows,
            parallel_moe_step=dict(kernel_ms=moe_step_ms, library_ms=moe_lib_ms,
                                   bound_ms=moe_bound_ms,
                                   host_s=[o["olmoe"]["step_s"] for o in outs],
                                   collectives=ocs, collective_s=om0["collective_s"]),
            parallel_families=families, phase16_s=phase_s,
            launches_parallel_pipeline=sum(o["pp_launches"] for o in outs),
            parallel_pipeline=dict(layers=pcfg.n_layers, loss=[o["loss_pp"] for o in outs],
                                   loss_unsharded=loss_pp1, grad_rel=pp_rel,
                                   host_s=[o["pp_s"] for o in outs],
                                   collectives=o0["pp_collectives"],
                                   collective_s=o0["pp_collective_s"]),
            parallel_profiled=pf)
    if 17 in phases:
        t17 = time.perf_counter()
        got = serving_gates(torch, np, dev, card, outs, preds, yards)
        scaled = sum(o["serving_launches"][0] for o in outs)
        unscaled = sum(o["serving_launches"][1] for o in outs)
        result.update(got, launches_serving=scaled, launches_serving_unscaled=unscaled,
                      phase17_s=prep17_s + time.perf_counter() - t17
                      + max(o["secs"]["serving"] for o in outs))
        print(f"[serving] phase 17 took {result['phase17_s']:.1f} s: yardsticks and dry run "
              f"{prep17_s:.1f} s, ranks {[round(o['secs']['serving'], 1) for o in outs]} s, gates "
              f"and times {time.perf_counter() - t17:.1f} s; {scaled} scaled and {unscaled} "
              f"unscaled kernel launches on the four ranks (main path 12)")
    return result


def parallel_family_gates(np, card, f: dict, outs: list, tag: str) -> dict:
    """Phase 16(c)'s gates and prints for one model (``f``: its config,
    label, yardstick and dry-run prediction) over the ranks' results.
    Returns its kernel entries."""
    c, pred, label = f["cfg"], f["pred"], f["label"]
    n_fwd, n_mb = mb_linears(c)[0], sum(mb_linears(c))
    m = par_m(c)  # decoder rows per call
    layout = {}
    for _, mm, k, n, per_step in par_shapes(c, m):
        layout[(mm, k, n)] = layout.get((mm, k, n), 0) + per_step
    for o in outs:
        r, fo = o["rank"], o["families"][tag]
        check(fo["state_bytes"] == pred["state_bytes"],
              f"rank {r}: {label} state bytes {fo['state_bytes']} against the dry run's "
              f"{pred['state_bytes']}")
        check(same_collectives(fo["collectives"], pred["collectives"]),
              f"rank {r}: {label} step's collectives {fo['collectives']} against the dry run's "
              f"{pred['collectives']}")
        check(fo["calls_exact"][0] == fo["calls_exact"][1] == n_mb,
              f"rank {r}: {label} microbatch 0's kernel calls bit-exact {fo['calls_exact']}")
        check(fo["int32_equal"][0] == fo["int32_equal"][1] == fo["int32_equal"][2] == n_fwd,
              f"rank {r}: {label} int32 products equal to the unsharded step's "
              f"{fo['int32_equal']}, the products that differ {fo['int32_differ']}")
        by_shape = {tuple(x[:3]): x[3] for x in fo["launches_by_shape"]}
        check(fo["launches"] == par_launches(c) and by_shape == layout,
              f"rank {r}: {label} launches per step {fo['launches']} by shape {by_shape}, "
              f"expected {par_launches(c)}, {layout}")
        for k, tol in (("loss", PAR_LOSS_REL), ("grad_norm", PAR_NORM_REL)):
            check(np.isfinite(fo[k]) and abs(fo[k] - f[k]) <= tol * abs(f[k]),
                  f"rank {r}: {label} {k} {fo[k]} against {f[k]} (rel tolerance {tol})")
    fo0 = outs[0]["families"][tag]
    cs = fo0["collectives"]
    print(f"[parallel] {card} | {label} sharded step, mesh (data, model) {par_mesh_shape(c)}: loss "
          f"{[o['families'][tag]['loss'] for o in outs]} vs {f['loss']} unsharded; grad_norm "
          f"{[o['families'][tag]['grad_norm'] for o in outs]} vs {f['grad_norm']}; "
          f"{fo0['launches']} unscaled launches per step per rank (as the layout gives, shape by "
          f"shape); microbatch 0's {fo0['calls_exact'][1]} kernel calls bit-exact, "
          f"{fo0['int32_equal'][1]} int32 products equal to the unsharded step's; state "
          f"{fo0['state_bytes']} bytes per rank (the dry run's), peak allocated "
          f"{[round(o['families'][tag]['peak_bytes'] / 1e9, 2) for o in outs]} GB (allocated "
          f"before it {[round(o['families'][tag]['allocated_before'] / 1e9, 2) for o in outs]} GB)")
    print(f"[parallel] {card} | {label} host wall per sharded step "
          f"{[round(o['families'][tag]['step_s'], 3) for o in outs]} s; rank 0's collectives "
          f"(gloo over host memory, not NVLink: nothing is claimed from their times), the dry "
          f"run's: counts {cs['counts_by_kind']}, bytes {cs['bytes_by_kind']} "
          f"({cs['total_bytes'] / 1e9:.3f} GB); host seconds in the transport "
          f"{({k: round(v, 3) for k, v in fo0['collective_s'].items()})}, "
          f"{sum(fo0['collective_s'].values()) / fo0['step_s']:.3f} of the step")
    rows = outs[0]["family_times"][tag]
    for row in rows:
        print(f"[parallel] {card} | mma_matmul {label} sharded {row['name']} M={row['M']} "
              f"K={row['K']} N={row['N']} ({row['calls']} per step per rank), planes 8: kernel "
              f"{row['ms']:.4f} ms, torch._int_mm {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
    step = {k: sum(r["calls"] * r[key] for r in rows)
            for k, key in (("kernel_ms", "ms"), ("library_ms", "library_ms"),
                           ("bound_ms", "bound_ms"))}
    print(f"[parallel] {card} | {label} per step per rank (graph-timed shapes x calls): kernel "
          f"{step['kernel_ms']:.1f} ms, torch._int_mm {step['library_ms']:.1f} ms, bound "
          f"{step['bound_ms']:.2f} ms")
    return dict(launches_per_step_per_rank=fo0["launches"], per_shape=rows,
                step=dict(**step, host_s=[o["families"][tag]["step_s"] for o in outs],
                          collectives=cs, collective_s=fo0["collective_s"]))


# ------------------------------------------------------- 17. sharded serving


class ServeModel(typing.NamedTuple):
    """One model of phase 17: its key (``tag``), label, config, rows, decode
    steps, cache length, prompt length, whether it serves in the 2-D mode,
    whether its decode steps must drop MoE assignments at capacity, and
    whether its layout must split Zamba2's group states over 'data'.  The
    vlm's prefill takes ``cfg.vlm_patches`` patch embeddings."""
    tag: str
    label: str
    cfg: typing.Any
    rows: int
    steps: int
    max_seq: int = SERVE_MAX_SEQ
    prompt: int = SERVE_PROMPT
    two_d: bool = False
    drops: bool = False
    groups_over_data: bool = False


def serve_cfgs() -> list:
    """Phase 17's models (``SERVE_MODELS``, then ``SERVE_MORE``), each on
    the kernel route at 8 planes with int8 weights and KV cache, but the
    unquantized ``moe_ffn_ep`` part (bf16 weights and cache)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig

    q = QuantConfig(mode="mma_int8", impl="kernel", planes=8, weights_int8=True, kv_int8=True)
    out = [ServeModel(tag, label, get_config(tag).replace(**depth, quant=q), rows, steps)
           for tag, label, depth, rows, steps in SERVE_MODELS]
    for tag, arch, label, depth, rows, steps, opt in SERVE_MORE:
        cfg = get_config(arch).replace(**depth, quant=q)
        if opt.get("quant") == "none":  # unquantized, moe_ffn_ep's body
            cfg = cfg.replace(quant=QuantConfig(mode="none"),
                              moe=dataclasses.replace(cfg.moe, ep=True))
        out.append(ServeModel(tag, label, cfg, rows, steps,
                              max_seq=opt.get("max_seq", SERVE_MAX_SEQ),
                              prompt=opt.get("prompt", SERVE_PROMPT),
                              two_d=opt.get("two_d", False), drops=opt.get("drops", False),
                              groups_over_data=opt.get("groups_over_data", False)))
    return out


def serve_shardings(sm, abstract_params, mesh):
    """``serve_step.param_shardings`` for ``sm``: in the 2-D mode with
    ``TWO_D_BYTES`` lowered to 0 for the call."""
    from repro_torch.serve import serve_step as ss

    saved = ss.TWO_D_BYTES
    if sm.two_d:
        ss.TWO_D_BYTES = 0
    try:
        return ss.param_shardings(abstract_params, sm.cfg, mesh)
    finally:
        ss.TWO_D_BYTES = saved


def serve_layer0(cfg) -> int:
    """The first layer's quantized products of a serving call (none
    unquantized)."""
    return 0 if cfg.quant.mode == "none" else SERVE_LAYER0[cfg.family]


def serve_launches(cfg) -> tuple[int, int]:
    """Kernel launches ``(scaled, unscaled)`` per decode step on one rank of
    the (data 2, model 2) mesh, from the layout (``param_specs``' rules;
    every linear 256 or more wide on both dims int8): a column-parallel
    int8 linear is one scaled launch, a row-parallel one one unscaled launch
    (its int32 partial all-reduced), a float linear under ``mma_int8`` one
    unscaled launch.  Transformer block (dense, vlm): wq/wk/wv column, wo
    row, the MLP's w_gate/w_up column and w_down row (MoE: experts and
    router bf16); the head column.  RWKV6 block: time mix wr/wk/wv/wg
    column and wo row (``mix_lora_a`` on the Horner route, ``w_lora_a`` 64
    wide, a float product: no launch), channel mix wk/wr column and wv row.
    Zamba2: every Mamba2 layer's z_proj, xbc_proj, dt_proj (float, H wide)
    and out_proj row-parallel; the shared block's wq/wk/wv column, wo and
    proj row, once per group.  Whisper decoder block: self wq/wk/wv column
    and wo row, cross wq column and wo row (its K/V precomputed), w_up
    column and w_down row; its head is tied, bf16.  The 2-D mode gathers
    the weights and launches as TP does; unquantized, no launch."""
    n = cfg.n_layers
    if cfg.quant.mode == "none":
        return 0, 0
    if cfg.family == "ssm":
        return 6 * n + 1, 2 * n
    if cfg.family == "hybrid":
        groups = n // cfg.attn_every
        return 3 * groups + 1, 4 * n + 2 * groups
    if cfg.family == "encdec":
        return 5 * n, 3 * n
    if cfg.moe.n_experts:
        return 3 * n + 1, n
    return 5 * n + 1, 2 * n


def serve_tokens(np, sm):
    """Phase 17's prompts (numpy seed 0): ``(rows, sm.prompt)`` tokens, and
    the extras drawn after them: Whisper's ``(rows, enc_seq, d_model)``
    frames, the vlm's ``(rows, vlm_patches, d_model)`` patches (float32)."""
    cfg = sm.cfg
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (sm.rows, sm.prompt)).astype(np.int64)
    ext = {}
    if cfg.family == "encdec":
        ext["frames"] = rng.standard_normal((sm.rows, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        ext["patches"] = rng.standard_normal(
            (sm.rows, cfg.vlm_patches, cfg.d_model)).astype(np.float32)
    return tok, ext


class ProductRecorder:
    """The first ``n`` int32 products of each serving call: on the sharded
    side ``sharded_lm.mma_product``'s (a row-parallel one after its
    all-reduce) and ``mma.mma_dot``'s outside it (a LoRA's), on the
    unsharded side ``mma.mma_dot``'s; the scaled kernel's (fused: its int32
    is not returned) recomputed by the plain version on its operands.
    Kept on the host.  ``exact``: also hold every kernel call (scaled and
    unscaled) against its plain version, counting the equal ones."""

    def __init__(self, n: int, sharded: bool):
        self.n, self.sharded, self.calls = n, sharded, []
        self.exact = None

    def __enter__(self):
        import torch

        from repro_torch.core import mma
        from repro_torch.kernels import mma_matmul as mk
        from repro_torch.kernels import ops
        from repro_torch.parallel import sharded_lm

        self.saved = (sharded_lm.mma_product, mma.mma_dot, ops.mma_matmul_scaled,
                      ops.mma_matmul)
        inner_prod, inner_dot, inner_scaled, inner_mm = self.saved
        inside = []

        def keep(acc):
            if len(self.calls) < self.n:
                self.calls.append(acc.cpu())

        def prod(*a, **kw):
            inside.append(1)
            try:
                acc = inner_prod(*a, **kw)
            finally:
                inside.pop()
            keep(acc)
            return acc

        def dot(*a, **kw):
            acc = inner_dot(*a, **kw)
            if not inside:
                keep(acc)
            return acc

        def scaled(x, w, xs, ws, *, planes=8, **kw):
            out = inner_scaled(x, w, xs, ws, planes=planes, **kw)
            x2 = x.reshape(-1, x.shape[-1])
            if len(self.calls) < self.n:
                keep(mk.mma_matmul_plain(x2, w, planes=planes).reshape(*x.shape[:-1], -1))
            if self.exact is not None:
                want = mk.mma_matmul_scaled_plain(x2, w, xs.reshape(1), ws.reshape(-1),
                                                  planes=planes)
                self.exact.append(bool(torch.equal(out.reshape(want.shape), want)))
            return out

        def unscaled(x, w, *, planes=8, **kw):
            out = inner_mm(x, w, planes=planes, **kw)
            if self.exact is not None:
                x2 = x.reshape(-1, x.shape[-1])
                want = mk.mma_matmul_plain(x2, w, planes=planes)
                self.exact.append(bool(torch.equal(out.reshape(want.shape), want)))
            return out

        if self.sharded:
            sharded_lm.mma_product = prod
        mma.mma_dot, ops.mma_matmul_scaled, ops.mma_matmul = dot, scaled, unscaled
        return self

    def __exit__(self, *exc):
        from repro_torch.core import mma
        from repro_torch.kernels import ops
        from repro_torch.parallel import sharded_lm

        (sharded_lm.mma_product, mma.mma_dot, ops.mma_matmul_scaled,
         ops.mma_matmul) = self.saved


def _serve_model(torch, cfg, dev):
    from repro_torch import models

    return models.build(cfg).init_params(0, cfg, device=dev,
                                         int8_min_dim=256 if cfg.quant.weights_int8 else None)


@contextlib.contextmanager
def ep_plain_route(torch, cfg, forced=None):
    """The unsharded step's ``moe_ffn_ep`` as the (data 2, model 2) mesh
    routes it (``moe_ep_plain``, ``forced`` its replayed routing), where the
    reference takes its expert-parallel body (unquantized, ``moe.ep``);
    else nothing."""
    from repro_torch.models import moe as moe_lib

    inner = moe_lib.moe_ffn_ep
    if cfg.quant.mode == "none" and cfg.moe.ep:
        moe_lib.moe_ffn_ep = lambda p, x, c: moe_ep_plain(torch, p, x, c, forced)
    try:
        yield
    finally:
        moe_lib.moe_ffn_ep = inner


def serving_yardstick(torch, np, dev, sm, replay=None) -> dict:
    """Phase 17's unsharded steps of one model in this process: the vlm's
    prefill with its patches, the writing prefill (Zamba2: the stateless
    prefill) of the prompts, then ``sm.steps`` greedy decode steps.  Each
    call's last-position logits and greedy tokens, the first layer's int32
    products of the prefills and of decode step 0 (on the host), the
    launches per decode step and the host wall; where ``moe_ffn_ep`` routes,
    each slab's routing (``RouteRecorder``).  ``replay``: the ranks' run
    again, fed its ``tokens`` and each slab routed as ``chosen`` gives (one
    (T, k) per slab, in the order ``moe_ep_plain`` visits them)."""
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.models import whisper
    from repro_torch.serve import serve_step as ss

    cfg, rows = sm.cfg, sm.rows
    params = _serve_model(torch, cfg, dev)
    tok, ext = serve_tokens(np, sm)
    tok = torch.as_tensor(tok, device=dev)
    dec, _ = ss.make_decode(cfg, rows, sm.max_seq, device=dev)
    cache = ss.init_serving_cache(cfg, rows, sm.max_seq, device=dev,
                                  dtype=torch.int8 if cfg.quant.kv_int8 else torch.bfloat16)
    ex = {}
    if cfg.family == "encdec":
        with torch.no_grad():
            memory = whisper.encode(params, torch.as_tensor(ext["frames"], device=dev), cfg,
                                    device=dev)
            ex = {"memory": memory,
                  "cross_kv": whisper.precompute_cross_kv(params, memory, cfg, device=dev)}
    n0 = serve_layer0(cfg)
    out = {"logits": [], "tokens": [], "wall": [], "routing": []}
    idx = 0
    ep = cfg.quant.mode == "none" and cfg.moe.ep
    forced = iter(replay["chosen"]) if replay else None
    with torch.no_grad(), ep_plain_route(torch, cfg, forced), RouteRecorder(ep) as route:
        if "patches" in ext:  # the vlm: its patches before the prompt, no cache
            patches = torch.as_tensor(ext["patches"], device=dev).to(torch.bfloat16)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ProductRecorder(n0, False) as rec:
                lg = ss.make_prefill(cfg, device=dev)(params, tok, {"patches": patches})
                out["prefix_logits"] = lg[:, -1].float().cpu()
            out["prefix_wall"] = time.perf_counter() - t0
            out["int32_prefix"] = rec.calls
            del lg
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ProductRecorder(n0, False) as rec:
            if cfg.family == "hybrid":
                lg = ss.make_prefill(cfg, device=dev)(params, tok, {})
            else:
                lg, cache = dec(params, tok, cache, torch.tensor(idx, device=dev), ex)
                idx += tok.shape[1]
            lg = lg[:, -1].float()
            torch.cuda.synchronize()
        out["wall"].append(time.perf_counter() - t0)
        out["int32_prefill"] = rec.calls
        out["routing"].append(route.kept[:])
        out["router"] = [route.logits[:]]
        for i in range(sm.steps):
            nxt = replay["tokens"][i].to(dev) if replay else lg.argmax(-1)
            out["logits"].append(lg.cpu())
            out["tokens"].append(nxt.cpu())
            before = (mk.scaled_launches, mk.launches)
            n_kept = len(route.kept)
            t0 = time.perf_counter()
            with ProductRecorder(n0 if i == 0 else 0, False) as rec:
                lg, cache = dec(params, nxt[:, None], cache, torch.tensor(idx, device=dev), ex)
                lg = lg[:, -1].float()
                torch.cuda.synchronize()
            out["wall"].append(time.perf_counter() - t0)
            out["routing"].append(route.kept[n_kept:])
            out["router"].append(route.logits[n_kept:])
            out["launches"] = (mk.scaled_launches - before[0], mk.launches - before[1])
            if i == 0:
                out["int32_decode0"] = rec.calls
            idx += 1
        out["logits"].append(lg.cpu())
        out["tokens"].append(lg.argmax(-1).cpu())
    check(forced is None or next(forced, None) is None, "the replay left slabs unrouted")
    del params, cache, ex
    torch.cuda.empty_cache()
    return out


def serve_prediction(torch, sm) -> dict:
    """What the dry run predicts for one rank of phase 17's (data 2, model
    2) mesh: its state bytes (params, cache and Whisper's extras:
    ``specs.sharded_bytes``), the whole params tree's bytes, and the
    collectives of the vlm's prefill with its patches, of one writing
    prefill and of one decode step (the counting mode on meta tensors, the
    rank's step from ``serve_step.make_prefill`` / ``make_decode`` with the
    mesh)."""
    from repro_torch.checkpoint.ckpt import tree_leaves
    from repro_torch.launch import specs
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.sharding import Mesh
    from repro_torch.serve import serve_step as ss

    t0 = time.perf_counter()
    cfg, rows = sm.cfg, sm.rows
    mesh = Mesh({"data": 2, "model": 2}, device="meta")
    ab = specs._abstract_params(cfg)
    p_sh, mode = serve_shardings(sm, ab, mesh)
    dec, spec = ss.make_decode(cfg, rows, sm.max_seq, mesh=mesh, device="meta", shardings=p_sh)
    c_sh = ss.cache_shardings(spec, cfg, mesh, rows, sm.max_seq)
    params, cache = shd.shard_tree(ab, p_sh), shd.shard_tree(spec, c_sh)
    rl = rows // 2

    def meta(*shape, dtype=torch.int64):
        return torch.empty(shape, dtype=dtype, device="meta")

    ex, ex_bytes = {}, 0
    if cfg.family == "encdec":
        l, t, kvd = cfg.n_layers, cfg.enc_seq, (cfg.n_kv_heads, cfg.hd)
        ex = {"memory": meta(rl, t, cfg.d_model, dtype=torch.bfloat16),
              "cross_kv": {"k": meta(l, rl, t, *kvd, dtype=torch.bfloat16),
                           "v": meta(l, rl, t, *kvd, dtype=torch.bfloat16)}}
        ex_bytes = sum(x.numel() * x.element_size() for x in
                       (ex["memory"], ex["cross_kv"]["k"], ex["cross_kv"]["v"]))
    out = {}
    with torch.no_grad():
        if cfg.family == "vlm":
            coll.reset_stats(mesh)
            ss.make_prefill(cfg, mesh=mesh, device="meta", shardings=p_sh)(
                params, meta(rl, sm.prompt),
                {"patches": meta(rl, cfg.vlm_patches, cfg.d_model, dtype=torch.bfloat16)})
            out["prefix"] = coll.collective_stats(mesh)
        coll.reset_stats(mesh)
        if cfg.family == "hybrid":
            ss.make_prefill(cfg, mesh=mesh, device="meta", shardings=p_sh)(
                params, meta(rl, sm.prompt), {})
        else:
            dec(params, meta(rl, sm.prompt), cache, meta(), ex)
        prefill = coll.collective_stats(mesh)
        coll.reset_stats(mesh)
        dec(params, meta(rl, 1), cache, meta(), ex)
        decode = coll.collective_stats(mesh)
    # the mesh axis on the leading dim of Zamba2's stacked group states and
    # shared KV cache (the group dim): 'data' where the rule marks it
    lead = {k: sorted({str(tuple(sh.spec)[0]) for sh in tree_leaves(c_sh[k])})
            for k in ("groups", "attn_k", "attn_v") if k in c_sh}
    return dict(out, param_bytes=specs.sharded_bytes(ab, p_sh, mesh), lead=lead,
                cache_bytes=specs.sharded_bytes(spec, c_sh, mesh), extras_bytes=ex_bytes,
                tree_bytes=sum(t.numel() * t.element_size() for t in tree_leaves(ab)),
                prefill=prefill, decode=decode, mode=mode, seconds=time.perf_counter() - t0)


class RouteRecorder:
    """Each slab's routing of the unquantized ``moe_ffn_ep`` path
    (``moe._local_dispatch`` under ``moe.ep_slab``, or ``moe_ep_plain``)
    held against the plain route on the same float32 router logits, on the
    host: expert ids, positions, token order and kept mask equal.
    ``equal``: one bool per slab routed; on the host, as the run routed
    each slab: ``kept``, its (tokens, experts) mask of the assignments it
    kept, ``chosen``, each token's k experts (T, k) by expert id, and
    ``logits``, its float32 router logits."""

    def __init__(self, on: bool):
        self.on, self.equal, self.kept, self.chosen, self.logits = on, [], [], [], []

    def __enter__(self):
        import torch

        from repro_torch.models import moe as moe_lib

        self.inner = inner = moe_lib._local_dispatch
        if self.on:
            def recording(xf, logits, n_experts, top_k, cap, dtype):
                buf, meta = inner(xf, logits, n_experts, top_k, cap, dtype)
                _, want = inner(xf.cpu(), logits.cpu(), n_experts, top_k, cap, dtype)
                # every field but the gate weights (index 3, floats)
                self.equal.append(all(torch.equal(a.cpu(), b) for i, (a, b) in
                                      enumerate(zip(meta, want)) if i != 3))
                eid_s, _, tok_s, _, keep = (a.cpu() for a in meta)
                kept = torch.zeros((xf.shape[0], n_experts), dtype=torch.bool)
                kept[tok_s[keep], eid_s[keep]] = True
                self.kept.append(kept)
                # a stable sort by token keeps each token's experts in id order
                by_tok = torch.argsort(tok_s, stable=True)
                self.chosen.append(eid_s[by_tok].reshape(xf.shape[0], top_k))
                self.logits.append(logits.float().cpu())
                return buf, meta

            moe_lib._local_dispatch = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as moe_lib

        moe_lib._local_dispatch = self.inner


def _serving_rank(torch, np, dist, root: Path, mesh, dev) -> dict:
    """Phase 17 on this rank: every model of ``serve_cfgs`` served sharded
    (``serve_step.make_prefill`` / ``make_decode`` with the mesh): the
    vlm's prefill with its patches, the writing prefill of the rank's
    prompts, then greedy decode steps; the live state bytes, collectives,
    launches, the kernel calls of one recorded decode step against their
    plain versions, the first layer's int32 products, the unquantized
    ``moe_ffn_ep`` path's routing, each call's logits and tokens (the whole
    vocab, gathered outside the step) and host walls."""
    from repro_torch.checkpoint.ckpt import tree_leaves
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharded_lm, sharded_whisper
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve import serve_step as ss
    from repro_torch.launch import specs

    di, ri = mesh.index("data"), mesh.index("model")
    res = {}
    for sm in serve_cfgs():
        t_model = time.perf_counter()
        cfg, rows, tag = sm.cfg, sm.rows, sm.tag
        rl = rows // 2
        r0 = di * rl
        p_sh, _ = serve_shardings(sm, specs._abstract_params(cfg), mesh)
        params = one_rank_at_a_time(dist, lambda: shd.shard_tree(_serve_model(torch, cfg, dev),
                                                                 p_sh))
        dec, spec = ss.make_decode(cfg, rows, sm.max_seq, mesh=mesh, device=dev, shardings=p_sh)
        c_sh = ss.cache_shardings(spec, cfg, mesh, rows, sm.max_seq)
        cache = shd.shard_tree(ss.init_serving_cache(
            cfg, rows, sm.max_seq, device=dev,
            dtype=torch.int8 if cfg.quant.kv_int8 else torch.bfloat16), c_sh)
        tok, ext = serve_tokens(np, sm)
        tok = torch.as_tensor(tok[r0:r0 + rl], device=dev)
        yard = torch.load(root / f"yard_serve_{tag}.pt", weights_only=False)
        ex = {}
        with torch.no_grad():
            if cfg.family == "encdec":
                fr = torch.as_tensor(ext["frames"][r0:r0 + rl], device=dev)
                memory = sharded_whisper.encode(params, fr, cfg, mesh)
                ex = {"memory": memory,
                      "cross_kv": sharded_whisper.precompute_cross_kv(params, memory, cfg, mesh)}
        out = {"state_bytes": [sum(t.numel() * t.element_size() for t in tree_leaves(x))
                               for x in (params, cache, ex)],
               "logits": [], "tokens": [], "wall": []}
        n0 = serve_layer0(cfg)
        idx = 0

        def whole(lg):
            return sharded_lm.gathered_logits(lg, lg.shape[-1] != cfg.vocab, mesh)[:, -1].float()

        ep = cfg.quant.mode == "none" and cfg.moe.ep
        with torch.no_grad(), RouteRecorder(ep) as route:
            if "patches" in ext:  # the vlm: its patches before the prompt, no cache
                patches = torch.as_tensor(ext["patches"][r0:r0 + rl], device=dev).to(torch.bfloat16)
                coll.reset_stats(mesh)
                dist.barrier()
                t0 = time.perf_counter()
                with ProductRecorder(n0, True) as rec:
                    lg = ss.make_prefill(cfg, mesh=mesh, device=dev, shardings=p_sh)(
                        params, tok, {"patches": patches})
                    torch.cuda.synchronize()
                out["prefix_wall"] = time.perf_counter() - t0
                out["prefix_stats"] = coll.collective_stats(mesh)
                out["int32_prefix"] = rec.calls
                want = yard["prefix_logits"][r0:r0 + rl]
                out["prefix_rel"] = float((whole(lg).cpu() - want).abs().max() / want.abs().max())
                del lg
            coll.reset_stats(mesh)
            dist.barrier()
            t0 = time.perf_counter()
            with ProductRecorder(n0, True) as rec:
                if cfg.family == "hybrid":
                    lg = ss.make_prefill(cfg, mesh=mesh, device=dev, shardings=p_sh)(
                        params, tok, {})
                else:
                    lg, cache = dec(params, tok, cache, torch.tensor(idx, device=dev), ex)
                    idx += tok.shape[1]
                torch.cuda.synchronize()
            out["wall"].append(time.perf_counter() - t0)
            out["prefill_stats"] = coll.collective_stats(mesh)
            out["prefill_coll_s"] = sum(coll.collective_seconds(mesh).values())
            out["int32_prefill"] = rec.calls
            routing, chosen, router = [route.kept[:]], [route.chosen[:]], [route.logits[:]]
            lg = whole(lg)
            for i in range(sm.steps):
                # the yardstick's greedy token: every call on the same inputs
                nxt = yard["tokens"][i][r0:r0 + rl].to(dev)
                out["logits"].append(lg.cpu())
                out["tokens"].append(lg.argmax(-1).cpu())
                coll.reset_stats(mesh)
                before = (mk.scaled_launches, mk.launches)
                n_kept = len(route.kept)
                dist.barrier()
                t0 = time.perf_counter()
                with ProductRecorder(n0 if i == 0 else 0, True) as rec:
                    if i == 1:  # the recorded step: every kernel call against its plain version
                        rec.exact = []
                    lg, cache = dec(params, nxt[:, None], cache, torch.tensor(idx, device=dev), ex)
                    torch.cuda.synchronize()
                out["wall"].append(time.perf_counter() - t0)
                routing.append(route.kept[n_kept:])
                chosen.append(route.chosen[n_kept:])
                router.append(route.logits[n_kept:])
                out.setdefault("launches", []).append(
                    (mk.scaled_launches - before[0], mk.launches - before[1]))
                if i == 0:
                    out["int32_decode0"] = rec.calls
                    out["decode_stats"] = coll.collective_stats(mesh)
                    out["decode_coll_s"] = sum(coll.collective_seconds(mesh).values())
                if i == 1:
                    out["calls_exact"] = [sum(rec.exact), len(rec.exact)]
                idx += 1
                lg = whole(lg)
            out["logits"].append(lg.cpu())
            out["tokens"].append(lg.argmax(-1).cpu())
        out["routing_equal"] = [sum(route.equal), len(route.equal)]
        # each call's assignments dropped at capacity on this rank, per layer
        out["drops"] = [[g.shape[0] * cfg.moe.top_k - int(g.sum()) for g in call]
                        for call in routing] if ep else []
        # per call, the tokens whose kept experts differ from the yardstick's
        # in the same slab (the ranks' float sums can flip a router near tie,
        # and a flip moves the capacity's drops), and layer 0's router logits
        # against those of the yardstick's slab at this rank's place in
        # moe_ep_plain's (data, model) partition: the same tokens
        out["route_differ"], out["slab_rel"], out["route_tokens"] = [], [], []
        for got, want, lg_r, want_r in zip(routing, yard["routing"], router, yard["router"]) \
                if ep else ():
            n_slabs = len(want) // len(got)  # the yardstick routes every slab of a layer
            slab = di * (n_slabs // 2) + (ri if n_slabs == 4 else 0)
            out["route_differ"].append(sum(int((g != want[l * n_slabs + slab]).any(-1).sum())
                                           if g.shape == want[l * n_slabs + slab].shape
                                           else g.shape[0] for l, g in enumerate(got)))
            out["route_tokens"].append(sum(g.shape[0] for g in got))
            w0 = want_r[slab]
            out["slab_rel"].append(float((lg_r[0] - w0).abs().max() / w0.abs().max())
                                   if lg_r[0].shape == w0.shape else float("inf"))
        if ep:  # for the parent's replay of this rank's routing
            out["coord"] = [di, ri]
        eq, ndiff = [], []
        groups = ("int32_prefix",) * ("int32_prefix" in out) + ("int32_prefill", "int32_decode0")
        for which in groups:
            for got, want in zip(out.pop(which), yard[which]):
                want = want[r0:r0 + rl]
                if got.shape[-1] != want.shape[-1]:  # column-parallel: the rank's columns
                    want = want[..., ri * got.shape[-1]:(ri + 1) * got.shape[-1]]
                eq.append(got.shape == want.shape and bool(torch.equal(got, want)))
                ndiff.append(int((got != want).sum()) if got.shape == want.shape else -1)
        out["int32_groups"] = len(groups)
        out["int32_ndiff"] = ndiff
        out["int32_equal"] = [sum(eq), len(eq), sum(len(yard[w]) for w in groups)]
        out["int32_differ"] = [i for i, e in enumerate(eq) if not e]
        out["logit_rel"], out["tokens_equal"], out["margins"] = [], [], []
        if ep:  # held by the parent against the yardstick replaying this routing
            torch.save({"chosen": chosen, "logits": out["logits"]},
                       root / f"ep_{tag}_{di}{ri}.pt")
        for got, want, gt, wt in zip(out.pop("logits"), yard["logits"], out.pop("tokens"),
                                     yard["tokens"]):
            want, wt = want[r0:r0 + rl], wt[r0:r0 + rl]
            scale = want.abs().max()
            out["logit_rel"].append(float((got - want).abs().max() / scale))
            out["tokens_equal"].append(bool(torch.equal(gt, wt)))
            for row in torch.nonzero(gt != wt).flatten().tolist():
                # a parting: the yardstick's margin between its token and the rank's
                out["margins"].append(float((want[row, wt[row]] - want[row, gt[row]]) / scale))
        out["seconds"] = time.perf_counter() - t_model
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        res[tag] = out
        del params, cache, ex, yard
        torch.cuda.empty_cache()
    return res


def rank_outputs(torch, root: Path) -> list:
    """The ranks' ``rank{r}.json``, each ``moe_ffn_ep`` serving part's
    routing and logits (``ep_{tag}_{data}{model}.pt``) under its ``ep``
    key, for ``ep_replay``."""
    outs = [json.loads((root / f"rank{r}.json").read_text()) for r in range(PAR_WORLD)]
    for o in outs:
        for tag, so in o.get("serving", {}).items():
            if "coord" in so:
                so["ep"] = torch.load(root / f"ep_{tag}_{so['coord'][0]}{so['coord'][1]}.pt",
                                      weights_only=False)
    return outs


def ep_replay(torch, np, dev, sm, yard: dict, outs: list) -> None:
    """The unquantized ``moe_ffn_ep`` part's yardstick run again with every
    slab routed as the rank that routed it did (``moe_ep_plain``'s
    (data, model) partition: at a decode step the data rank's rows whole,
    model rank 0's routing, which model rank 1's must equal), fed the
    tokens the ranks were fed.  Adds to each rank's results ``replay_rel``,
    its logits against the replay's per call, and ``decode_alike``."""
    res = {tuple(o["serving"][sm.tag]["coord"]): o["serving"][sm.tag] for o in outs}
    by = {c: so.pop("ep") for c, so in res.items()}
    calls = [sm.prompt] + [1] * sm.steps
    forced, alike = [], True
    for c, s in enumerate(calls):
        n_seq = 2 if s % 2 == 0 else 1
        for l in range(sm.cfg.n_layers):
            for i in range(2):
                for j in range(n_seq):
                    forced.append(by[(i, j)]["chosen"][c][l])
                if n_seq == 1:
                    alike &= bool(torch.equal(by[(i, 0)]["chosen"][c][l],
                                              by[(i, 1)]["chosen"][c][l]))
    rep = serving_yardstick(torch, np, dev, sm, replay=dict(tokens=yard["tokens"], chosen=forced))
    rl = sm.rows // 2
    for (i, j), so in res.items():
        so["decode_alike"] = alike
        so["replay_rel"] = []
        for got, want in zip(by[(i, j)]["logits"], rep["logits"]):
            want = want[i * rl:(i + 1) * rl]
            so["replay_rel"].append(float((got - want).abs().max() / want.abs().max()))


def serving_gates(torch, np, dev, card, outs: list, preds: dict, yards: dict) -> dict:
    """Phase 17's gates over the ranks' results, its prints, and both
    kernels graph-timed at Yi-6B's sharded shapes (the scaled one at the
    column-parallel decode shapes, the unscaled one at the row-parallel
    ones).  Returns their phase-17 entries."""
    from repro_torch.models import moe as moe_lib

    g = torch.Generator(device=dev).manual_seed(17)
    entries = {}
    for sm in serve_cfgs():
        if sm.cfg.quant.mode == "none" and sm.cfg.moe.ep:
            ep_replay(torch, np, dev, sm, yards[sm.tag], outs)
    for sm in serve_cfgs():
        for o in outs:  # every rank's numbers first, whatever gate fails below
            so = o["serving"][sm.tag]
            print(f"[serving] {sm.label} rank {o['rank']}: int32 equal {so['int32_equal']} (differ "
                  f"{so['int32_differ']}, elements {so['int32_ndiff']}), logits rel {so['logit_rel']}"
                  f"{', prefix prefill ' + str(so['prefix_rel']) if 'prefix_rel' in so else ''}, "
                  f"tokens equal {so['tokens_equal']}, margins {so['margins']}, launches "
                  f"{so['launches'][:1]}, calls exact {so['calls_exact']}, slabs routed as the "
                  f"plain route {so['routing_equal']}, tokens routed otherwise than the "
                  f"yardstick per call {so['route_differ']} of {so['route_tokens']}, layer 0's "
                  f"router logits against the yardstick's slab {so['slab_rel']}"
                  + (f", logits against the yardstick replaying the ranks' routing "
                     f"{so['replay_rel']}" if "replay_rel" in so else ""))
    for sm in serve_cfgs():
        tag, label, cfg, rows, steps = sm.tag, sm.label, sm.cfg, sm.rows, sm.steps
        pred, yard = preds[tag], yards[tag]
        want_launches = serve_launches(cfg)
        for o in outs:
            r, so = o["rank"], o["serving"][tag]
            check(so["state_bytes"] == [pred["param_bytes"], pred["cache_bytes"],
                                        pred["extras_bytes"]],
                  f"rank {r}: {label} state bytes {so['state_bytes']} against the dry run's "
                  f"{[pred['param_bytes'], pred['cache_bytes'], pred['extras_bytes']]}")
            for which in ("prefix", "prefill", "decode") if "prefix" in pred else ("prefill", "decode"):
                check(same_collectives(so[f"{which}_stats"], pred[which]),
                      f"rank {r}: {label} {which} collectives {so[f'{which}_stats']} against the "
                      f"dry run's {pred[which]}")
            check(all(tuple(x) == want_launches for x in so["launches"]),
                  f"rank {r}: {label} launches per decode step {so['launches']}, expected "
                  f"{want_launches} (scaled, unscaled)")
            check(so["calls_exact"][0] == so["calls_exact"][1] == sum(want_launches),
                  f"rank {r}: {label} recorded decode step's kernel calls bit-exact "
                  f"{so['calls_exact']}")
            n0, npre = serve_layer0(cfg), SERVE_PRE_ATTENTION[cfg.family]
            n_all = so["int32_groups"] * n0
            pre = [i for i in range(n_all) if i % n0 < npre]  # each prefill's and decode 0's
            check(so["int32_equal"][1] == so["int32_equal"][2] == n_all
                  and not set(pre) & set(so["int32_differ"]),
                  f"rank {r}: {label} first layer's int32 products before the attention "
                  f"combine equal to the yardstick's: {so['int32_equal']}, differ "
                  f"{so['int32_differ']} (gated {pre})")
            # moe_ffn_ep: against the yardstick routed as the ranks routed
            held = so.get("replay_rel", so["logit_rel"])
            check(len(held) == steps + 1 and all(np.isfinite(x) and x <= SERVE_LOGIT_REL
                                                 for x in held),
                  f"rank {r}: {label} logits against the yardstick's {held} "
                  f"(SERVE_LOGIT_REL {SERVE_LOGIT_REL})")
            if "prefix" in pred:
                check(np.isfinite(so["prefix_rel"]) and so["prefix_rel"] <= SERVE_LOGIT_REL,
                      f"rank {r}: {label} prefill with the patches: logits against the "
                      f"yardstick's {so['prefix_rel']} (SERVE_LOGIT_REL {SERVE_LOGIT_REL})")
            check(all(m <= 2 * SERVE_LOGIT_REL for m in so["margins"]),
                  f"rank {r}: {label} greedy tokens part from the yardstick's at margins "
                  f"{so['margins']} of the largest logit")
            if cfg.quant.mode == "none" and cfg.moe.ep:
                # every layer's slab of the writing prefill and of each decode step
                n_slabs = cfg.n_layers * (1 + steps)
                check(len(so["route_differ"]) == len(so["slab_rel"]) == steps + 1
                      and all(d <= ROUTE_DIFFER_SHARE * n for d, n in
                              zip(so["route_differ"], so["route_tokens"]))
                      and all(x <= SLAB_ROUTER_REL for x in so["slab_rel"])
                      and so["decode_alike"],
                      f"rank {r}: {label} tokens routed otherwise than the yardstick per call "
                      f"{so['route_differ']} of {so['route_tokens']} (ROUTE_DIFFER_SHARE "
                      f"{ROUTE_DIFFER_SHARE}), layer 0's router logits against the yardstick's "
                      f"slab {so['slab_rel']} (SLAB_ROUTER_REL {SLAB_ROUTER_REL}), decode slabs "
                      f"routed alike on both model ranks: {so['decode_alike']}")
                check(so["routing_equal"][0] == so["routing_equal"][1] == n_slabs
                      and so["decode_stats"]["counts_by_kind"].get("all-to-all", 0) > 0
                      and so["prefill_stats"]["counts_by_kind"].get("all-to-all", 0) > 0,
                      f"rank {r}: {label} slabs routed as the plain route "
                      f"{so['routing_equal']} (expected {n_slabs}), all-to-alls in the prefill "
                      f"{so['prefill_stats']['counts_by_kind']} and the decode step "
                      f"{so['decode_stats']['counts_by_kind']}")
        if sm.drops:
            # each data rank's decode slab: its rows whole, SERVE_DROP_ROWS / 2
            # tokens at cap MOE_DROP_CAP; the drops per rank and layer, summed
            # over the decode steps
            slab = rows // 2
            dec = [[sum(call[l] for call in o["serving"][tag]["drops"][1:])
                    for l in range(cfg.n_layers)] for o in outs]
            pre = [o["serving"][tag]["drops"][0] for o in outs]
            check(all(o["serving"][tag]["route_tokens"][1:] == [cfg.n_layers * slab] * steps
                      for o in outs) and moe_lib.capacity(slab, cfg.moe) == MOE_DROP_CAP
                  and sum(map(sum, dec)) >= 1,
                  f"{label}: decode slabs of {[o['serving'][tag]['route_tokens'] for o in outs]} "
                  f"tokens (expected {slab} per layer at cap {MOE_DROP_CAP}), assignments dropped "
                  f"at decode per rank and layer {dec} (expected at least one)")
            print(f"[serving] {card} | {label}: each decode step routes a data rank's {slab} rows "
                  f"whole on every model rank at cap {MOE_DROP_CAP} of {slab * cfg.moe.top_k} "
                  f"assignments per layer: dropped at decode (the {steps} steps summed) per rank "
                  f"and layer {dec}; at the writing prefill per rank and layer {pre}")
        if sm.groups_over_data:
            # the rule's first dim equal to the batch is the stacked group dim:
            # the step reshards the group states to rows and back (all-gathers
            # over 'data' that the same model at 4 rows does not make)
            wide = serve_prediction(torch, sm._replace(rows=4))
            gathers = [p_["decode"]["counts_by_kind"].get("all-gather", 0) for p_ in (pred, wide)]
            check(pred["lead"] == {k: ["data"] for k in ("groups", "attn_k", "attn_v")}
                  and wide["lead"] == {k: ["None"] for k in ("groups", "attn_k", "attn_v")}
                  and gathers[0] > gathers[1],
                  f"{label}: the group states' leading axes {pred['lead']} (at 4 rows "
                  f"{wide['lead']}), decode all-gathers {gathers[0]} against {gathers[1]} at 4 rows")
            print(f"[serving] {card} | {label}: cache_shardings splits the stacked group dim of "
                  f"the group states and the shared KV cache over 'data' ({pred['lead']}); a "
                  f"decode step's all-gathers {gathers[0]} against {gathers[1]} for the same model "
                  f"at 4 rows (dry run): {gathers[0] - gathers[1]} of them the reshard's, counted "
                  f"and equal to the ranks' live ones")
        if sm.two_d:
            share = pred["param_bytes"] / pred["tree_bytes"]
            check(pred["mode"] == "2d" and share <= 0.26,
                  f"{label}: mode {pred['mode']}, each rank holds {share:.4f} of the weights")
        s0 = outs[0]["serving"][tag]
        walls = [o["serving"][tag]["wall"] for o in outs]
        dec_s = [statistics.median(w[1:]) for w in walls]
        ps, ds = s0["prefill_stats"], s0["decode_stats"]
        patch = f"patch prefill of {cfg.vlm_patches} + {sm.prompt}, " if cfg.family == "vlm" else ""
        print(f"[serving] {card} | {label} sharded ({cfg.n_layers} layers, {rows} rows, {patch}"
              f"{'stateless prefill' if cfg.family == 'hybrid' else 'writing prefill'} of "
              f"{sm.prompt} tokens, {steps} greedy decode steps, cache {sm.max_seq}, "
              f"{pred['mode']}, {cfg.quant.mode}): state per rank {s0['state_bytes']} bytes (params, "
              f"cache, extras: the dry run's; {s0['state_bytes'][0] / pred['tree_bytes']:.4f} of the "
              f"tree's params); {want_launches[0]} scaled + {want_launches[1]} unscaled launches "
              f"per decode step per rank (as the layout gives); the recorded step's "
              f"{s0['calls_exact'][1]} kernel calls bit-exact; {s0['int32_equal'][1]} first-layer "
              f"int32 products compared with the yardstick's")
        prefix = (f"; prefill with the patches {max(o['serving'][tag]['prefix_rel'] for o in outs):.3e}"
                  if "prefix" in pred else "")
        route = (f"; every slab's routing ({s0['routing_equal'][1]} per rank) equal to the plain "
                 f"route's on the same float32 logits; tokens routed otherwise than the "
                 f"yardstick per rank and call {[o['serving'][tag]['route_differ'] for o in outs]}"
                 f" of {s0['route_tokens']}; logits against the yardstick replaying the ranks' "
                 f"routing, per call: worst "
                 f"{max(max(o['serving'][tag]['replay_rel']) for o in outs):.3e} (gated; the "
                 f"figure before is against its own routing, not gated)"
                 if s0["routing_equal"][1] else "")
        print(f"[serving] {card} | {label} logits against the unsharded yardstick on its tokens, "
              f"per call: worst {max(max(o['serving'][tag]['logit_rel']) for o in outs):.3e} of "
              f"the largest (SERVE_LOGIT_REL {SERVE_LOGIT_REL}){prefix}; the ranks' greedy tokens "
              f"equal the yardstick's at {sum(sum(o['serving'][tag]['tokens_equal']) for o in outs)} "
              f"of {sum(len(o['serving'][tag]['tokens_equal']) for o in outs)} calls x ranks, "
              f"partings at margins {[m for o in outs for m in o['serving'][tag]['margins']]}; "
              f"first layer's int32 products equal: {s0['int32_equal'][0]} of "
              f"{s0['int32_equal'][1]} (those before the attention combine gated){route}")
        print(f"[serving] {card} | {label} host wall per rank: "
              + (f"prefill with the patches {[round(o['serving'][tag]['prefix_wall'], 3) for o in outs]} s "
                 f"(unsharded {yard['prefix_wall']:.3f} s), " if "prefix" in pred else "")
              + f"prefill {[round(w[0], 3) for w in walls]} s (unsharded {yard['wall'][0]:.3f} s), "
              f"decode step (median) {[round(x, 4) for x in dec_s]} s (unsharded "
              f"{statistics.median(yard['wall'][1:]):.4f} s); rank 0's collectives (gloo over "
              f"host memory, not NVLink: nothing is claimed from their times): prefill "
              f"{ps['counts_by_kind']} {ps['total_bytes']} bytes, {s0['prefill_coll_s'] / walls[0][0]:.3f} "
              f"of it in the transport; decode step {ds['counts_by_kind']} {ds['total_bytes']} "
              f"bytes, {s0['decode_coll_s'] / walls[0][1]:.3f} of the step")
        entries[tag] = dict(launches_per_decode_step_per_rank=list(want_launches),
                            prefill_s=[w[0] for w in walls], decode_step_s=dec_s,
                            unsharded_prefill_s=yard["wall"][0],
                            unsharded_decode_step_s=statistics.median(yard["wall"][1:]),
                            collectives_decode=ds, collectives_prefill=ps,
                            logit_rel=max(max(o["serving"][tag]["logit_rel"]) for o in outs),
                            mode=pred["mode"], max_seq=sm.max_seq, prompt=sm.prompt)
    # the scaled kernel at Yi-6B's sharded decode shapes: M = 4 rows per data
    # rank, the column-parallel linears' half of N
    ycfg, yrows = serve_cfgs()[0].cfg, serve_cfgs()[0].rows
    d, kv = ycfg.d_model, ycfg.n_kv_heads * ycfg.hd
    m = yrows // 2
    rows_t = []
    for name, k, n in (("wq", d, d // 2), ("wk/wv", d, kv // 2), ("w_gate/w_up", d, ycfg.d_ff // 2),
                       ("head", d, ycfg.vocab // 2)):
        ms_planes, lib_ms, plain_ms, copies, calls = cold_shape_times(torch, dev, g, m, k, n, (8,))
        b_ms, b_by, _, _ = scaled_bound([(m, k, n)])
        rows_t.append(dict(name=name, M=m, K=k, N=n, ms=ms_planes[8], library_ms=lib_ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        print(f"[serving] {card} | mma_matmul_scaled Yi-6B sharded {name} M={m} K={k} N={n} "
              f"(w cold: {copies} copies, graph of {calls} calls) planes 8: kernel "
              f"{ms_planes[8]:.5f} ms, torch._int_mm+scale {lib_ms:.5f} ms, plain {plain_ms:.4f} "
              f"ms, bound {b_ms:.5f} ms ({b_by})")
    per_step = {"wq": 1, "wk/wv": 2, "w_gate/w_up": 2, "head": 0}
    step = {key: sum(r[key] * per_step[r["name"]] for r in rows_t) * ycfg.n_layers
            + next(r[key] for r in rows_t if r["name"] == "head")
            for key in ("ms", "library_ms", "bound_ms")}
    print(f"[serving] {card} | Yi-6B one sharded decode step's 161 scaled calls per rank "
          f"(graph-timed shapes x calls): kernel {step['ms']:.3f} ms, torch._int_mm+scale "
          f"{step['library_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms")
    # the unscaled kernel at the row-parallel linears (wo, w_down: the rank's
    # half of K, every column; ``sharded_lm.wq_product``, its int32 partial
    # all-reduced), at a decode step's M = 4 rows per data rank and the
    # writing prefill's 4 x 256, 8 planes, w cold
    rows_u = []
    for mm in (m, m * SERVE_PROMPT):
        for name, k, n in (("wo", d // 2, d), ("w_down", ycfg.d_ff // 2, d)):
            r = dict(name=name, **cold_unscaled_times(torch, dev, g, mm, k, n))
            rows_u.append(r)
            print(f"[serving] {card} | mma_matmul Yi-6B sharded row-parallel {name} M={mm} K={k} "
                  f"N={n} (w cold: {r['w_copies']} copies, graph of {r['calls']} calls) planes 8: "
                  f"kernel {r['ms']:.5f} ms, torch._int_mm {r['library_ms']:.5f} ms"
                  f"{' (x padded to 32 rows)' if mm <= 16 else ''}, bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']}), "
                  f"plane-work floor {r['plane_floor_ms']:.5f} ms")
    by_m = {}
    for r in rows_u:  # 32 layers x (wo, w_down): 64 calls per call per rank
        tot = by_m.setdefault(r["M"], {"calls": 0})
        tot["calls"] += ycfg.n_layers
        for key in ("ms", "library_ms", "bound_ms", "plane_floor_ms"):
            tot[key] = tot.get(key, 0.0) + ycfg.n_layers * r[key]
    for mm, tot in by_m.items():
        print(f"[serving] {card} | Yi-6B {'one sharded decode step' if mm == m else 'the writing prefill'}"
              f"'s {tot['calls']} row-parallel unscaled calls per rank at M={mm} (graph-timed "
              f"shapes x calls): kernel {tot['ms']:.3f} ms, torch._int_mm {tot['library_ms']:.3f} "
              f"ms, bound {tot['bound_ms']:.4f} ms, plane-work floor {tot['plane_floor_ms']:.4f} ms")
    return dict(serving=entries, serving_per_shape=rows_t, serving_step=step,
                serving_unscaled=dict(per_shape=rows_u, decode_step=by_m[m],
                                      prefill=by_m[m * SERVE_PROMPT]))


def served_config(torch, np, dev, card, cfg, tag, label, int8_min_dim=256):
    """Phase 18(a)-(c): one LM config at full width served through
    ``Engine.run`` at phase 5's traffic with the recorded call's checks
    (``lm_serving``); for the moe family the recorded call's last MoE block
    card vs CPU and the decode call's MoE blocks graph-timed; the scaled
    kernel's times at its decode shapes and over the recorded call.
    Returns the scaled kernel's entries for this path, keyed by ``tag``."""
    from repro_torch.models import transformer

    t_part = time.perf_counter()
    lm = lm_serving(torch, np, dev, cfg, tag=tag, label=label, expect=scaled_linears(cfg),
                    int8_min_dim=int8_min_dim)
    out = {f"launches_{tag}": lm["launches"], f"{tag}_decode_calls": lm["decode_calls"],
           f"{tag}_wall_s": lm["wall_s"], f"{tag}_logits_rel": lm["logits_rel"]}
    if cfg.moe.n_experts:
        blocks = lm["params"]["blocks"]
        moe_p = [transformer.layer_params(blocks, l)["moe"] for l in range(cfg.n_layers)]
        x_rec, y_rec = lm["moe"][-1]
        rec = moe_card_vs_cpu(torch, moe_p[-1], x_rec, cfg, y_rec)
        print(f"[{tag}] MoE block card vs CPU (recorded call, last layer): T={rec['t']} cap "
              f"{rec['cap']}, {rec['assignments']} assignments, {rec['dropped']} dropped; "
              f"routing and dispatch buffer equal, gate weights max diff "
              f"{rec['gate_max_diff']:.3g}; output max rel {rec['rel']:.3g} (limit {MOE_REL}); "
              f"the CPU's own router product differs from the card's in "
              f"{rec['router_logits_differ']} of {rec['t'] * cfg.moe.n_experts} logits (not gated)")
        ms, b_ms, nbytes = moe_blocks_time(torch, card, cfg, moe_p, lm["moe"], label)
        out.update({f"{tag}_moe_recorded": rec, f"{tag}_moe_blocks_ms": ms,
                    f"{tag}_moe_blocks_bound_ms": b_ms, f"{tag}_moe_blocks_bytes": nbytes})
        del moe_p, blocks
    times = lm_times(torch, dev, card, lm, lm_decode_shapes(cfg), label=label)
    out.update({f"{tag}_call_{k}": times[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")})
    out[f"{tag}_per_shape"] = times["per_shape"]
    del lm
    torch.cuda.empty_cache()
    out[f"{tag}_s"] = time.perf_counter() - t_part
    print(f"[{tag}] {label} took {out[f'{tag}_s']:.1f} s")
    return out


@contextlib.contextmanager
def recorded_calls(rec: dict):
    """While open, every scaled- and unscaled-kernel call and every
    ``layers.flash_attention`` call is appended to ``rec`` (``scaled``: (x,
    w, xs, ws, planes, out); ``unscaled``: (x as 2-D, w, planes, out);
    ``attn``: (q, k, v, keywords, out)).  Recording adds no launch."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers

    scaled, unscaled, flash = ops.mma_matmul_scaled, ops.mma_matmul, layers.flash_attention
    for key in ("scaled", "unscaled", "attn"):
        rec.setdefault(key, [])

    def rec_scaled(x, w, xs, ws, **kw):
        out = scaled(x, w, xs, ws, **kw)
        rec["scaled"].append((x, w, xs, ws, kw["planes"], out))
        return out

    def rec_unscaled(x, w, **kw):
        out = unscaled(x, w, **kw)
        rec["unscaled"].append((x.reshape(-1, w.shape[0]), w, kw["planes"], out))
        return out

    def rec_flash(q, k, v, **kw):
        out = flash(q, k, v, **kw)
        rec["attn"].append((q, k, v, kw, out))
        return out

    ops.mma_matmul_scaled, ops.mma_matmul = rec_scaled, rec_unscaled
    layers.flash_attention = rec_flash
    try:
        yield rec
    finally:
        ops.mma_matmul_scaled, ops.mma_matmul = scaled, unscaled
        layers.flash_attention = flash


def recorded_kernels_exact(torch, rec: dict, what: str) -> None:
    """Every recorded scaled and unscaled kernel call bit for bit against
    its plain version."""
    from repro_torch.kernels import mma_matmul as mk

    for x, w, xs, ws, planes, out in rec["scaled"]:
        k, n = w.shape
        want = mk.mma_matmul_scaled_plain(x.reshape(-1, k), w, xs, ws, planes=planes)
        check(torch.equal(out.reshape(-1, n), want), f"{what}: scaled linear K={k} N={n} != plain")
    for x, w, planes, out in rec["unscaled"]:
        check(torch.equal(out.reshape(x.shape[0], -1), mk.mma_matmul_plain(x, w, planes=planes)),
              f"{what}: unscaled linear K={w.shape[0]} N={w.shape[1]} != plain")


def attention_times(torch, rec: dict, nbytes: int) -> tuple[float, float]:
    """Device time of a recorded step's attention calls over their caches,
    by CUDA events around the calls (each reads gigabytes, so the host's
    issue time is not what is timed), and their bytes bound: every cached
    key and value read once."""
    from repro_torch.models import layers

    calls = [(q, k, v, kw) for q, k, v, kw, _ in rec["attn"]]
    ms = time_ms(torch, lambda: [layers.flash_attention(q, k, v, **kw) for q, k, v, kw in calls],
                 reps=3, warmup=1)
    return ms, nbytes / HBM_BYTES_PER_S * 1e3


def long_danube(torch, np, dev, card) -> dict:
    """Phase 18(d): the long_500k cell on H2O-Danube3-4B at full width and
    depth (the module's docstring says what runs and what is gated).
    Returns the scaled kernel's entries for this path."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.models import transformer
    from repro_torch.serve import serve_step
    from repro_torch.serve.engine import lm_schedule_from_params

    t_part = time.perf_counter()
    cfg = get_config("h2o_danube_3_4b")
    win = cfg.swa_window
    params = transformer.init_params(0, cfg, device=dev, int8_min_dim=256)
    sched = lm_schedule_from_params(params, cfg, 0.05)
    kcfg = cfg.replace(quant=QuantConfig(mode="mma_int8", impl="kernel",
                                         plane_schedule=sched.planes))
    decode, spec = serve_step.make_decode(kcfg, 1, LONG_SEQ, device=dev)
    cache = serve_step.init_serving_cache(kcfg, 1, LONG_SEQ, device=dev)
    check({k: tuple(t.shape) for k, t in cache.items()}
          == {k: tuple(t.shape) for k, t in spec.items()}, "the cache is not make_decode's layout")
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    torch.cuda.synchronize()
    print(f"[long] H2O-Danube3-4B long_500k: {cfg.n_layers} layers, window {win}, cache "
          f"{tuple(cache['k'].shape)} x2 bf16, {cache_bytes / 1e9:.2f} GB; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; {sched.describe()}")
    rng = np.random.default_rng(LONG_SEQ)
    start = LONG_SEQ - LONG_PROMPT - LONG_STEPS
    prompt = rng.integers(0, cfg.vocab, (1, LONG_PROMPT)).astype(np.int32)
    mk.launches = mk.scaled_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = decode(params, prompt, cache, start, {})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    check(logits.shape == (1, LONG_PROMPT, cfg.vocab) and bool(torch.isfinite(logits).all()),
          f"long prefill: logits {tuple(logits.shape)} not finite or of the wrong shape")
    tok = int(logits[0, -1].float().argmax())
    del logits
    rec, step_s = {}, []
    for i in range(LONG_STEPS):
        idx, last = start + LONG_PROMPT + i, i == LONG_STEPS - 1
        x = np.array([[tok]], np.int32)
        if last:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recorded_calls(rec) if last else contextlib.nullcontext():
            lg, cache = decode(params, x, cache, idx, {})
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        tok = int(lg[0, -1].float().argmax())
    step_peak = torch.cuda.max_memory_allocated()
    launches, unscaled = mk.scaled_launches, mk.launches
    per_call = scaled_linears(cfg)
    check(idx == LONG_SEQ - 1, f"the last step at {idx}, not {LONG_SEQ - 1}")
    check(launches == per_call * (1 + LONG_STEPS) and unscaled == 0,
          f"{launches} scaled and {unscaled} unscaled launches for a prefill and {LONG_STEPS} "
          f"steps, expected {per_call} scaled per call")
    check(lg.shape == (1, 1, cfg.vocab) and bool(torch.isfinite(lg).all()),
          f"long decode: logits {tuple(lg.shape)} not finite or of the wrong shape")
    check(len(rec["scaled"]) == per_call and len(rec["attn"]) == cfg.n_layers,
          f"{len(rec['scaled'])} scaled and {len(rec['attn'])} attention calls recorded")
    recorded_kernels_exact(torch, rec, "long_500k recorded step")
    # the step again at its index (it rewrites its own position before it
    # reads the cache), on the Horner route, and with the positions its
    # query masks (k <= idx - window) overwritten by seeded noise in place
    again, _ = decode(params, x, cache, idx, {})
    check(torch.equal(again, lg), "the recorded step repeated at its index differs")
    hcfg = kcfg.replace(quant=dataclasses.replace(kcfg.quant, impl="horner"))
    lh, _ = transformer.decode_step(params, x, cache, idx, hcfg, device=dev)
    rel = _rel(lg, lh)
    check(rel <= LM_LOGIT_REL, f"long_500k recorded step: logits kernel vs Horner differ by {rel}")
    masked = idx - win + 1
    g = torch.Generator(device=dev).manual_seed(LONG_SEQ)
    for t in cache.values():
        t[:, :, :masked].normal_(generator=g)
    check(bool((cache["k"][:, :, 0] != 0).any()), "no noise written")
    noisy, _ = decode(params, x, cache, idx, {})
    check(torch.equal(noisy, lg), "logits moved when the positions outside the window changed")
    attn_ms, attn_bound = attention_times(torch, rec, cache_bytes)
    print(f"[long] {card} | H2O-Danube3-4B long_500k: prefill of {LONG_PROMPT} tokens at "
          f"{start} in {prefill_s:.2f} s host wall (peak {prefill_peak / 2**30:.2f} GiB), "
          f"{LONG_STEPS} decode steps at {start + LONG_PROMPT}..{idx}: host wall per step "
          f"{statistics.mean(step_s) * 1e3:.1f} ms (min {min(step_s) * 1e3:.1f}, max "
          f"{max(step_s) * 1e3:.1f}; the last step's peak {step_peak / 2**30:.2f} GiB), "
          f"{launches} scaled launches ({per_call} per call); the recorded step at {idx}: "
          f"{per_call} linears bit-exact against the plain version, repeated bit-equal, logits "
          f"vs Horner route max rel {rel:.4f} (limit {LM_LOGIT_REL}); positions 0..{masked - 1} "
          f"(outside the window) overwritten with noise: logits bit-equal; its "
          f"{len(rec['attn'])} attention calls over the cache {attn_ms:.3f} ms, bound "
          f"{attn_bound:.3f} ms (bytes: {cache_bytes / 1e9:.2f} GB at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    del rec, cache, params, again, lh, noisy, lg
    torch.cuda.empty_cache()
    part_s = time.perf_counter() - t_part
    print(f"[long] H2O-Danube3-4B long_500k took {part_s:.1f} s")
    return dict(launches_long_danube=launches, long_danube_prefill_s=prefill_s,
                long_danube_step_ms=[s * 1e3 for s in step_s], long_danube_logits_rel=rel,
                long_danube_attn_ms=attn_ms, long_danube_attn_bound_ms=attn_bound,
                long_danube_cache_bytes=cache_bytes, long_danube_peak_bytes=step_peak,
                long_danube_prefill_peak_bytes=prefill_peak, long_danube_s=part_s)


def seeded_state(state: dict, g) -> None:
    """A Zamba2 decode state filled in place from ``g``: the shared block's
    K/V caches and the conv windows standard normal, the float32 SSM states
    at 0.1 of it (the scales tests/test_torch_zamba2.py draws)."""
    for name, node in state.items():
        if isinstance(node, dict):
            seeded_state(node, g)
        else:
            node.normal_(0.0, 0.1 if name == "ssm" else 1.0, generator=g)


def long_zamba2(torch, np, dev, card) -> tuple[dict, dict]:
    """Phase 18(e): the long_500k cell on Zamba2-7B at full width, its depth
    cut (the module's docstring says what runs and what is gated).  Returns
    the scaled and unscaled kernels' entries for this path."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.models import layers, zamba2
    from repro_torch.serve import serve_step

    t_part = time.perf_counter()
    cfg = get_config("zamba2_7b").replace(n_layers=LONG_ZAMBA_LAYERS)
    params = zamba2.init_params(0, cfg, device=dev, int8_min_dim=256)
    kcfg = cfg.replace(quant=QuantConfig(mode="mma_int8", impl="kernel", planes=RECURRENT_PLANES))
    decode, _ = serve_step.make_decode(kcfg, 1, LONG_SEQ, device=dev)
    state = serve_step.init_serving_cache(kcfg, 1, LONG_SEQ, device=dev)
    seeded_state(state, torch.Generator(device=dev).manual_seed(LONG_SEQ))
    kv_bytes = sum(state[k].numel() * state[k].element_size() for k in ("attn_k", "attn_v"))
    torch.cuda.synchronize()
    groups = state["attn_k"].shape[0]
    print(f"[long] Zamba2-7B long_500k at {cfg.n_layers} of 81 layers ({groups} shared-attention "
          f"groups): KV caches {tuple(state['attn_k'].shape)} x2 bf16, {kv_bytes / 1e9:.2f} GB, "
          f"the state drawn from seed {LONG_SEQ}; {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB allocated")
    tok = int(np.random.default_rng(LONG_SEQ).integers(0, cfg.vocab))
    rec, step_s = {}, []
    mk.launches = mk.scaled_launches = 0
    for i in range(LONG_ZAMBA_STEPS):
        idx, last = LONG_SEQ - LONG_ZAMBA_STEPS + i, i == LONG_ZAMBA_STEPS - 1
        if last:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recorded_calls(rec) if last else contextlib.nullcontext():
            lg, state = decode(params, np.array([[tok]], np.int32), state, idx, {})
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        tok = int(lg[0, -1].float().argmax())
    peak = torch.cuda.max_memory_allocated()
    launches, unscaled = mk.scaled_launches, mk.launches
    per_s, per_u, _ = recurrent_launches(cfg)
    check(idx == LONG_SEQ - 1, f"the last step at {idx}, not {LONG_SEQ - 1}")
    check(launches == per_s * LONG_ZAMBA_STEPS and unscaled == per_u * LONG_ZAMBA_STEPS,
          f"{launches} scaled and {unscaled} unscaled launches for {LONG_ZAMBA_STEPS} steps, "
          f"expected {per_s} and {per_u} per step")
    check(lg.shape == (1, 1, cfg.vocab) and bool(torch.isfinite(lg).all()),
          f"long decode: logits {tuple(lg.shape)} not finite or of the wrong shape")
    check(len(rec["scaled"]) == per_s and len(rec["unscaled"]) == per_u
          and len(rec["attn"]) == groups,
          f"{len(rec['scaled'])} scaled, {len(rec['unscaled'])} unscaled and "
          f"{len(rec['attn'])} attention calls recorded")
    recorded_kernels_exact(torch, rec, "Zamba2 long_500k recorded step")
    attn_ms, attn_bound = attention_times(torch, rec, kv_bytes)
    # the last group's shared attention over all 524,288 keys on the CPU:
    # the same function on the same values, its keys and values copied
    # head-major (the CPU's einsum is ~20x faster on that layout)
    q, k, v, kw, out = rec["attn"][-1]
    check(k.shape[1] == LONG_SEQ, f"the attention call read {k.shape[1]} keys")
    t0 = time.perf_counter()
    kc, vc = (t.transpose(1, 2).contiguous().cpu().transpose(1, 2) for t in (k, v))
    copy_s = time.perf_counter() - t0
    kw_c = {a: (b.cpu() if torch.is_tensor(b) else b) for a, b in kw.items()}
    t0 = time.perf_counter()
    out_c = layers.flash_attention(q.cpu(), kc, vc, **kw_c)
    cpu_s = time.perf_counter() - t0
    attn_rel = _rel(out.cpu(), out_c)
    check(bool(torch.isfinite(out).all()) and attn_rel <= LONG_ATTN_REL,
          f"Zamba2 shared attention over {LONG_SEQ} keys, card vs CPU: max rel {attn_rel} "
          f"(limit {LONG_ATTN_REL})")
    print(f"[long] {card} | Zamba2-7B long_500k ({cfg.n_layers} layers): {LONG_ZAMBA_STEPS} "
          f"decode steps at {LONG_SEQ - LONG_ZAMBA_STEPS}..{idx}: host wall per step "
          f"{statistics.mean(step_s) * 1e3:.1f} ms (min {min(step_s) * 1e3:.1f}, max "
          f"{max(step_s) * 1e3:.1f}; the last step's peak {peak / 2**30:.2f} GiB), {launches} "
          f"scaled and {unscaled} unscaled launches ({per_s} and {per_u} per step); the "
          f"recorded step's {per_s} scaled and {per_u} unscaled calls bit-exact against the "
          f"plain version; its {groups} shared-attention calls over {LONG_SEQ} keys "
          f"{attn_ms:.3f} ms, bound {attn_bound:.3f} ms (bytes: {kv_bytes / 1e9:.2f} GB at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); the last group's call on the CPU (K/V copied "
          f"in {copy_s:.1f} s, {cpu_s:.1f} s there): max rel {attn_rel:.3g} of the largest "
          f"output (limit {LONG_ATTN_REL})")
    del rec, state, params, q, k, v, out, kc, vc, out_c, lg
    torch.cuda.empty_cache()
    part_s = time.perf_counter() - t_part
    print(f"[long] Zamba2-7B long_500k took {part_s:.1f} s")
    return (dict(launches_long_zamba2=launches, long_zamba2_step_ms=[s * 1e3 for s in step_s],
                 long_zamba2_attn_ms=attn_ms, long_zamba2_attn_bound_ms=attn_bound,
                 long_zamba2_attn_rel=attn_rel, long_zamba2_kv_bytes=kv_bytes,
                 long_zamba2_peak_bytes=peak, long_zamba2_s=part_s),
            dict(launches_long_zamba2=unscaled))


def last_configs(torch, np, dev, card) -> tuple[dict, dict]:
    """Phase 18: Granite-20B, H2O-Danube3-4B and DBRX-132B served at full
    width, then the long_500k cell on Danube and on Zamba2-7B.  Returns the
    scaled and unscaled kernels' entries for these paths."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    scaled = {}
    # Granite's MQA projections wk/wv are 6144 x 128: quantized at a
    # min_dim of 128, so every linear of the model is int8
    for arch, tag, label, over, min_dim in (
            ("granite_20b", "granite", "Granite-20B", {}, 128),
            ("h2o_danube_3_4b", "danube", "H2O-Danube3-4B", {}, 256),
            ("dbrx_132b", "dbrx", f"DBRX-132B ({DBRX_LAYERS} of 40 layers)",
             dict(n_layers=DBRX_LAYERS), 256)):
        scaled.update(served_config(torch, np, dev, card, get_config(arch).replace(**over), tag,
                                    label, min_dim))
    scaled.update(long_danube(torch, np, dev, card))
    s_z, unscaled = long_zamba2(torch, np, dev, card)
    scaled.update(s_z)
    scaled["phase18_s"] = time.perf_counter() - t_phase
    return scaled, unscaled


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing ({SRC / 'repro_torch'})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.bench.table1 import card_line, graph_ms
    from repro_torch.configs import get_config
    from repro_torch.core import bitplane
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.kernels import ops
    from repro_torch.models import unet
    from repro_torch.obs.events import RecordingSink
    from repro_torch.segserve import SegEngine
    from repro_torch.segserve.synth import phantom_image

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    laps = [time.perf_counter()]

    def lap(phase) -> None:
        """Print the seconds since the last phase ended."""
        laps.append(time.perf_counter())
        print(f"[phase] {phase} took {laps[-1] - laps[-2]:.1f} s")

    # ---------------------------------------------------- 1. device, build
    print(card)
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib, ptxas = mk.build()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in ptxas.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}")
    # the CUDA-core scaled kernel that the scaled kernel's rows above 16
    # ran on before it covered every M: gone from the library
    check(b"mma_horner_kernel" not in lib.read_bytes(), "mma_horner_kernel is in the library")
    imma = {}
    # (kernel, instantiations): the unscaled kernel's (planes, signed, block
    # rows) and the scaled kernel's (planes, signed, NF 1-4)
    instantiations = {"mma_tc_horner_kernel": 32, "mma_tc_scaled_kernel": 64}
    all_counts = imma_counts(lib, instantiations)
    if all_counts is None:
        print("[sass] no cuobjdump in the toolkit: IMMA count not taken")
    for kernel, n_inst in instantiations.items() if all_counts is not None else ():
        counts = all_counts[kernel]
        check(len(counts) == n_inst and min(counts.values()) > 0,
              f"{kernel}: IMMA instructions per instantiation: {sorted(counts.values())}")
        imma[kernel] = sum(counts.values())
        print(f"[sass] {kernel}: {len(counts)} instantiations, IMMA instructions "
              f"{imma[kernel]} in all, {min(counts.values())}..{max(counts.values())} each")
        if kernel == "mma_tc_scaled_kernel":
            # NF, the last template argument, in the mangled or the demangled name
            nf_of = {name: re.search(r"mma_tc_scaled_kernel(?:ILi\d+ELb[01]ELi(\d)E|"
                                     r"<\d+, (?:true|false), (\d)>)", name) for name in counts}
            by_nf = {nf: sorted(c for name, c in counts.items()
                                if nf_of[name] and str(nf) in nf_of[name].groups())
                     for nf in range(1, 5)}
            check(all(len(c) == 16 for c in by_nf.values()), f"instantiations by NF: {by_nf}")
            print("[sass] mma_tc_scaled_kernel IMMA by NF (16 instantiations each): " + ", ".join(
                f"NF {nf} {c[0]}..{c[-1]}" for nf, c in by_nf.items()))

    lap(1)

    # ------------------------------------------ 2. kernels vs plain versions
    cfg = unet.UNetConfig(quant_mode="mma_int8")  # calibrated width, kernel datapath
    # the KPB matmul of each 3x3 conv at one 80x80 window: (name, M, K, N)
    names = ([f"enc{d}" for d in range(cfg.depth)] + ["bottleneck"]
             + [f"dec{d}" for d in reversed(range(cfg.depth))])
    layers = [(nm, c.out_h * c.out_w, c.k * c.k * c.cin, c.cout)
              for nm, c in zip(names, cfg.conv_layers())]
    g = torch.Generator().manual_seed(0)
    max_err = 0
    n_cases = 0

    scaled_err = 0.0
    n_scaled = 0

    def compare(m, k, n, planes, signed=True, bm=None, offset=0):
        """``bm`` forces the block height; ``offset`` > 0 makes both
        operands views that many bytes into their storage."""
        nonlocal max_err, n_cases
        x = rand_i8(torch, g, (m * k + offset,), dev)[offset:].view(m, k)
        w = rand_i8(torch, g, (k * n + offset,), dev)[offset:].view(k, n)
        if offset:
            check(x.data_ptr() % 16 != 0 and w.data_ptr() % 16 != 0, "views are 16-byte aligned")
        got = (mk.mma_matmul_kernel(x, w, planes=planes, signed=signed) if bm is None
               else mk._launch(x, w, planes, signed, bm=bm))
        want = mk.mma_matmul_plain(x, w, planes=planes, signed=signed)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        n_cases += 1
        check(torch.equal(got, want), f"kernel != plain at M={m} K={k} N={n} planes={planes} "
              f"signed={signed} bm={bm} offset={offset}")

    def compare_scaled(m, k, n, planes, signed=True):
        nonlocal scaled_err, n_scaled
        x, w = rand_i8(torch, g, (m, k), dev), rand_i8(torch, g, (k, n), dev)
        xs = (torch.rand(1, generator=g) * 0.1 + 1e-3).to(dev)
        ws = (torch.rand(n, generator=g) * 0.01 + 1e-4).to(dev)
        got = mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=planes, signed=signed)
        want = mk.mma_matmul_scaled_plain(x, w, xs, ws, planes=planes, signed=signed)
        torch.cuda.synchronize()
        scaled_err = max(scaled_err, float((got - want).abs().max()) if got.numel() else 0.0)
        n_scaled += 1
        check(torch.equal(got, want),
              f"scaled kernel != plain at M={m} K={k} N={n} planes={planes} signed={signed}")

    for cmp in (compare, compare_scaled):
        for m, k, n in SWEEP:
            for planes in (8, 5, 2):
                cmp(m, k, n, planes)
        for planes in range(1, 9):
            for signed in (True, False):
                cmp(67, 129, 70, planes, signed)
                cmp(3, 129, 70, planes, signed)  # small M: the scaled kernel's decode path
    for m, k, n in SCALED_SWEEP:
        for planes in (8, 5):
            compare_scaled(m, k, n, planes)
    for _, m, k, n in layers:
        compare(m * TILES_PER_BATCH, k, n, 8)
        compare(m * TILES_PER_BATCH, k, n, 5)
    for k in STAGING_K:
        for n in STAGING_N:
            compare(67, k, n, 8)
    for offset in (1, 4):
        compare(67, 300, 48, 8, offset=offset)
        compare(45, 5184, 192, 5, offset=offset)
    for bm in (32, 64):
        for m in RAGGED_M:
            compare(m, 256, 80, 8, bm=bm)
        for planes in range(1, 9):
            for signed in (True, False):
                compare(33, 256, 80, planes, signed, bm=bm)
    lm_cfg = get_config("yi_6b")
    decode_shapes = lm_decode_shapes(lm_cfg)
    moe_cfg = get_config("olmoe_1b_7b")
    for _, k, n in decode_shapes + lm_decode_shapes(moe_cfg):
        compare_scaled(LM_BATCH, k, n, 8)
        compare_scaled(LM_BATCH, k, n, 5)
    # this slice's shapes: the scaled kernel at RWKV6-3B's and Zamba2-7B's
    # linears, M 1-8 at the served planes and M = 4 at 8; the unscaled one at
    # Zamba2's dt_proj.  w drawn once per shape on the card.
    rwkv_cfg, zamba_cfg = get_config("rwkv6_3b"), get_config("zamba2_7b")
    gd = torch.Generator(device=dev).manual_seed(3)
    for rcfg in (rwkv_cfg, zamba_cfg):
        for _, k, n in recurrent_decode_shapes(rcfg):
            w = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=dev, generator=gd)
            ws = torch.rand(n, device=dev, generator=gd) * 0.01 + 1e-4
            for m, planes in [(m, RECURRENT_PLANES) for m in range(1, 9)] + [(LM_BATCH, 8)]:
                x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=dev, generator=gd)
                xs = torch.rand(1, device=dev, generator=gd) * 0.1 + 1e-3
                got = mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=planes)
                want = mk.mma_matmul_scaled_plain(x, w, xs, ws, planes=planes)
                scaled_err = max(scaled_err, float((got - want).abs().max()))
                n_scaled += 1
                check(torch.equal(got, want),
                      f"scaled kernel != plain at M={m} K={k} N={n} planes={planes}")
    dt_k, dt_n = zamba_cfg.d_model, zamba_cfg.ssm_expand * zamba_cfg.d_model // zamba_cfg.ssm_head_dim
    for m in range(1, 9):
        for planes in (8, RECURRENT_PLANES):
            compare(m, dt_k, dt_n, planes)
    # phase 18's shapes: Granite-20B's (MQA: wk/wv at N = 128; w_down at K =
    # 24,576), H2O-Danube3-4B's (head_dim 120: K = 3840, wk/wv at N = 960)
    # and DBRX-132B's (wk/wv at N = 1024, the head at N = 100,352) decode
    # linears at M = 1, 4 and 8, 8 planes (and 5 at M = 4)
    last_shapes = sorted({(k, n) for arch in ("granite_20b", "h2o_danube_3_4b", "dbrx_132b")
                          for _, k, n in lm_decode_shapes(get_config(arch))})
    for k, n in last_shapes:
        w = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=dev, generator=gd)
        ws = torch.rand(n, device=dev, generator=gd) * 0.01 + 1e-4
        for m, planes in ((1, 8), (4, 8), (8, 8), (4, 5)):
            x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=dev, generator=gd)
            xs = torch.rand(1, device=dev, generator=gd) * 0.1 + 1e-3
            got = mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=planes)
            want = mk.mma_matmul_scaled_plain(x, w, xs, ws, planes=planes)
            scaled_err = max(scaled_err, float((got - want).abs().max()))
            n_scaled += 1
            check(torch.equal(got, want),
                  f"scaled kernel != plain at M={m} K={k} N={n} planes={planes}")
    del w
    print(f"[kernel] mma_matmul_scaled at phase 18's {len(last_shapes)} decode shapes "
          f"{last_shapes}, M 1, 4 and 8: bit-exact against the plain version")
    n_decode, n_wide = decode_cases(torch, dev)
    print(f"[kernel] mma_matmul: {n_cases} cases bit-exact against the plain version, "
          f"max_abs_err {max_err}")
    print(f"[kernel] mma_matmul_scaled: {n_scaled} cases plus {n_decode} decode cases (M <= 16) "
          f"and {n_wide} above 16 rows bit-exact against the plain version, max_abs_err "
          f"{scaled_err}")

    lap(2)

    # ------------------------------------------------------- 3. forward
    params = unet.init_params(0, cfg)
    sched = unet.schedule_from_params(params, 0.05)
    print(f"[forward] {sched.describe()}")
    x = np.random.default_rng(0).normal(size=(1, 80, 80, cfg.in_ch)).astype(np.float32)

    def conv_outputs(fcfg, xin, device=None):
        """Logits plus every conv's int32 output, recorded at the KPB conv."""
        seen = []
        inner = ops.mma_conv2d

        def recording(*a, **kw):
            out = inner(*a, **kw)
            seen.append(out)
            return out

        ops.mma_conv2d = recording
        try:
            logits = unet.forward(params, xin, fcfg, device=device)
        finally:
            ops.mma_conv2d = inner
        torch.cuda.synchronize()
        return logits, seen

    for name, fcfg in [("uniform-8", cfg),
                       ("from_weights(0.05)", dataclasses.replace(cfg, plane_schedule=sched.planes))]:
        lk, ck = conv_outputs(fcfg, x)
        lh, ch = conv_outputs(dataclasses.replace(fcfg, impl="horner"), x)
        check(len(ck) == len(ch) == 7, f"{len(ck)} convs recorded, expected 7")
        for i, (a, b) in enumerate(zip(ck, ch)):
            check(a.dtype == torch.int32 and torch.equal(a, b), f"{name}: conv {i} differs")
        diff = float((lk - lh).abs().max())
        check(lk.shape == (1, 80, 80, cfg.n_classes) and bool(torch.isfinite(lk).all()),
              f"{name}: logits {tuple(lk.shape)} not finite or of the wrong shape")
        check(diff <= LOGIT_ATOL, f"{name}: logits kernel vs plain differ by {diff}")
        print(f"[forward] {name}: 7 convs int32-equal kernel vs plain, logits max diff {diff}")
    xs = x[:, :16, :16]
    lg, cg = conv_outputs(dataclasses.replace(cfg, plane_schedule=sched.planes), xs)
    lc, cc = conv_outputs(dataclasses.replace(cfg, plane_schedule=sched.planes), xs, "cpu")
    for i, (a, b) in enumerate(zip(cg, cc)):
        check(torch.equal(a.cpu(), b), f"card vs CPU: conv {i} differs")
    diff = float((lg.cpu() - lc).abs().max())
    check(diff <= CPU_LOGIT_ATOL, f"card vs CPU logits differ by {diff}")
    print(f"[forward] 16x16 input, card vs CPU: 7 convs int32-equal, logits max diff {diff}")

    lap(3)

    # ------------------------------- 4. segmentation serving (main path 1)
    scfg = dataclasses.replace(cfg, plane_schedule=sched.planes)
    images = [phantom_image(160, 128, cfg.in_ch, seed=0), phantom_image(160, 128, cfg.in_ch, seed=1),
              phantom_image(80, 80, cfg.in_ch), phantom_image(200, 152, cfg.in_ch)]
    engine = SegEngine(scfg, params, adaptive=True)
    engine.obs = RecordingSink()
    mk.launches = 0
    t0 = time.perf_counter()
    results = engine.run(images)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    run_batches, run_launches = len(engine.obs), mk.launches
    stream_engine = SegEngine(scfg, params, adaptive=True)
    stream_engine.obs = RecordingSink()
    done_ms = {}
    t0 = time.perf_counter()
    for ev in stream_engine.serve_stream(images):
        if ev.done:
            torch.cuda.synchronize()
            done_ms[ev.rid] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    stream_ms = (time.perf_counter() - t0) * 1e3
    launches = mk.launches
    batches = run_batches + len(stream_engine.obs)
    check(run_launches == 7 * run_batches,
          f"run(): {run_launches} launches for {run_batches} micro-batches")
    check(launches == 7 * batches, f"{launches} launches for {batches} micro-batches")
    print(f"[serve] run(): {run_batches} micro-batches, {run_launches} kernel launches, "
          f"{run_ms:.1f} ms host wall | serve_stream(): {len(stream_engine.obs)} micro-batches, "
          f"{launches - run_launches} launches, {stream_ms:.1f} ms host wall")

    plain = SegEngine(dataclasses.replace(scfg, impl="horner"), params, adaptive=True).run(images)
    for i, (r, p) in enumerate(zip(results, plain)):
        h, w = images[i].shape[:2]
        check(r.logits.shape == (h, w, cfg.n_classes) and bool(np.isfinite(r.logits).all()),
              f"image {i}: logits {r.logits.shape} not finite or of the wrong shape")
        diff = float(np.abs(r.logits - p.logits).max())
        check(diff <= LOGIT_ATOL, f"image {i}: served logits kernel vs plain differ by {diff}")
        check((r.cycles, r.pj, r.class_counts) == (p.cycles, p.pj, p.class_counts),
              f"image {i}: accounting differs between datapaths")
        print(f"[serve] image {i} {h}x{w}: tiles {r.n_tiles} classes {r.class_counts} "
              f"cycles {r.cycles} pJ {r.pj} modeled {r.time_ms:.3f} ms "
              f"{r.metered_gops_per_w:.2f} GOPS/W | host wall to done {done_ms[i]:.1f} ms "
              f"(serve_stream) | logits vs plain max diff {diff}")

    lap(4)

    # ---------------------------------------- 5. LM serving (main path 2)
    lm = lm_serving(torch, np, dev, lm_cfg)

    lap(5)

    # ---------------------------------------------------------- 6. times
    per_shape = []
    for name, m1, k, n in layers:
        m = m1 * TILES_PER_BATCH
        x8, w8 = rand_i8(torch, g, (m, k), dev), rand_i8(torch, g, (k, n), dev)
        ms_planes = {p: graph_ms(torch, lambda: mk.mma_matmul_kernel(x8, w8, planes=p))
                     for p in SERVED_PLANES}
        ms = ms_planes[8]
        plain_ms = time_ms(torch, lambda: mk.mma_matmul_plain(x8, w8, planes=8), reps=3, warmup=1)
        # the library yardstick on the truncate_to_planes operand (identity at
        # 8 planes); _int_mm wants K and N multiples of 8, so pad K with zero
        # columns of x and zero rows of w — the same function
        kp = -(-k // 8) * 8
        xl = torch.zeros((m, kp), dtype=torch.int8, device=dev)
        xl[:, :k] = bitplane.truncate_to_planes(x8, 8)
        wl = torch.zeros((kp, n), dtype=torch.int8, device=dev)
        wl[:k] = w8
        check(torch.equal(torch._int_mm(xl, wl), mk.mma_matmul_kernel(x8, w8)),
              f"{name}: library yardstick disagrees with the kernel")
        lib_ms = graph_ms(torch, lambda: torch._int_mm(xl, wl))
        nbytes = m * k + k * n + 4 * m * n
        nops = 2 * m * k * n
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT8_OPS_PER_S * 1e3
        row = dict(name=name, M=m, K=k, N=n, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                   plane_floor_ms=8 * t_ops, ms_planes=ms_planes, bytes=nbytes, ops=nops,
                   block_rows=mk.tile_rows(m, n, torch.cuda.get_device_properties(0).multi_processor_count))
        per_shape.append(row)
        print(f"[time] {card} | mma_matmul {name} M={m} K={k} N={n} planes=8 (block rows "
              f"{row['block_rows']}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch._int_mm "
              f"{lib_ms:.4f} ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}), plane-work "
              f"floor {row['plane_floor_ms']:.5f} ms, {nops / ms / 1e6:.1f} GOP/s | planes 5: "
              f"{ms_planes[5]:.4f} ms, planes 1: {ms_planes[1]:.4f} ms")

    tot_bytes = sum(r["bytes"] for r in per_shape)
    tot_ops = sum(r["ops"] for r in per_shape)
    t_bytes, t_ops = tot_bytes / HBM_BYTES_PER_S * 1e3, tot_ops / INT8_OPS_PER_S * 1e3
    summary = dict(
        name="mma_matmul", route="cuda", source="src/repro_torch/csrc/mma_matmul.cu",
        replaces="src/repro/kernels/mma_matmul.py:127", launches=launches, max_abs_err=max_err,
        ms=sum(r["ms"] for r in per_shape), plain_ms=sum(r["plain_ms"] for r in per_shape),
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=sum(r["library_ms"] for r in per_shape),
        work="one 4-tile micro-batch: the 7 conv shapes of an 80x80 window, planes 8",
        ms_planes={p: sum(r["ms_planes"][p] for r in per_shape) for p in SERVED_PLANES},
        plane_floor_ms=8 * t_ops, imma=imma.get("mma_tc_horner_kernel"),
        launches_lm=lm["unscaled"], per_shape=per_shape,
    )
    print(f"[time] {card} | mma_matmul one 4-tile forward: kernel {summary['ms']:.4f} ms, "
          f"plain {summary['plain_ms']:.4f} ms, torch._int_mm {summary['library_ms']:.4f} ms, "
          f"bound {summary['bound_ms']:.5f} ms ({summary['bound_by']}), plane-work floor "
          f"{summary['plane_floor_ms']:.5f} ms | planes 5: {summary['ms_planes'][5]:.4f} ms, "
          f"planes 1: {summary['ms_planes'][1]:.4f} ms")
    scaled_summary = lm_times(torch, dev, card, lm, decode_shapes)
    scaled_summary["max_abs_err"] = scaled_err
    scaled_summary["imma"] = imma.get("mma_tc_scaled_kernel")
    del lm  # the recorded calls hold Yi-6B's weights
    torch.cuda.empty_cache()

    lap(6)

    # ------------------------------------------------ 7. certified tuning
    tuning, plan = certified_tuning(torch, np, card, cfg, params, images)
    summary.update(tuning)

    lap(7)

    # ------------------------------------------------- 8. the gateway
    scaled_gw, unscaled_gw, (lm_cfg, lm_params) = gateway_replay(torch, np, dev, card, cfg,
                                                                  params, plan)
    scaled_summary.update(scaled_gw)
    summary.update(unscaled_gw)

    lap(8)

    # --------------------------------------- 9. speculative decoding
    mk.launches = 0
    scaled_summary.update(spec_decoding(torch, np, dev, card, lm_cfg, lm_params))
    check(mk.launches == 0, f"phase 9 launched the unscaled kernel {mk.launches} times")

    lap(9)

    # -------------------------------------------- 10. the serving fabric
    fab_cfg = lm_cfg.replace(n_layers=FABRIC_LAYERS, quant=dataclasses.replace(
        lm_cfg.quant, plane_schedule=tuple(lm_cfg.quant.plane_schedule[:FABRIC_LAYERS])))
    fab_params = dict(lm_params, blocks=_first_layers(lm_params["blocks"], FABRIC_LAYERS))
    scaled_fab, unscaled_fab = fabric_replay(torch, np, dev, card, cfg, params, plan, fab_cfg,
                                             fab_params)
    scaled_summary.update(scaled_fab)
    summary.update(unscaled_fab)
    del lm_params, fab_params  # minitron_4b's weights: phase 11 serves OLMoE-1B-7B
    torch.cuda.empty_cache()

    lap(10)

    # ---------------------------------------------- 11. MoE serving
    mk.launches = 0
    scaled_summary.update(moe_serving(torch, np, dev, card, moe_cfg))
    check(mk.launches == 0, f"phase 11 launched the unscaled kernel {mk.launches} times")
    torch.cuda.empty_cache()

    lap(11)

    # ---------------------------------- 12-13. recurrent-state serving
    for phase, rcfg, tag, label in ((12, rwkv_cfg, "rwkv6", "RWKV6-3B"),
                                    (13, zamba_cfg, "zamba2", "Zamba2-7B")):
        got = recurrent_serving(torch, np, dev, card, rcfg, tag=tag, label=label, phase=phase)
        scaled_summary.update(got["scaled"])
        summary.update(got["unscaled"])
        torch.cuda.empty_cache()
        lap(phase)

    # ----------------------------------- 14. encoder-decoder serving
    mk.launches = 0
    scaled_summary.update(whisper_serving(torch, np, dev, card, get_config("whisper_large_v3")))
    check(mk.launches == 0, f"phase 14 launched the unscaled kernel {mk.launches} times")
    summary["launches_whisper"] = mk.launches
    torch.cuda.empty_cache()
    lap(14)

    # ----------------------------- 15. quantization-aware training
    summary.update(training(torch, np, dev, card))
    torch.cuda.empty_cache()
    lap(15)

    # ------------------ 16-17. parallel training and sharded serving
    par = parallel_training(torch, np, dev, card)
    scaled_summary.update({k: par.pop(k) for k in SERVING_KEYS})
    summary["launches_serving"] = par.pop("launches_serving_unscaled")
    summary.update(par)
    torch.cuda.empty_cache()
    lap("16-17")
    check(summary["launches_serving"] > 0 and scaled_summary["launches_serving"] > 0,
          f"phase 17 launched the kernels {summary['launches_serving']} (unscaled), "
          f"{scaled_summary['launches_serving']} (scaled) times")

    # --------- 18. the last LM configs at full width and the long_500k cell
    scaled_last, unscaled_last = last_configs(torch, np, dev, card)
    scaled_summary.update(scaled_last)
    summary.update(unscaled_last)
    torch.cuda.empty_cache()
    lap(18)
    # the per-shape and per-path detail first, so that the total, the kernels
    # line (one entry per kernel) and the last line land in the tail
    for k in (summary, scaled_summary):
        print(f"[detail] {k['name']} " + json.dumps({x: v for x, v in k.items()
                                                     if x not in KERNEL_KEYS}))
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s, the build included")
    print(json.dumps({"kernels": [
        {**{x: k[x] for x in KERNEL_KEYS},
         "launches_by_path": {x: v for x, v in k.items() if x.startswith("launches") and x !=
                              "launches" and isinstance(v, int)}}
        for k in (summary, scaled_summary)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
