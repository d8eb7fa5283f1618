#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's paths on one CUDA card through the entry points a
user calls, at full widths, and holds every hand-written kernel of those
paths against its plain PyTorch version on the card:

  * serving: the lattice-rescoring service at the acoustic model's output
    width (K = 6000 tied triphone states, utterances of up to T = 1000
    frames) and a streaming session;
  * training: NGHF lattice-MPE training of the paper's LSTM (input 80,
    hidden 1000, 2 LSTM layers + 1 FF, K = 6000; 19,335,000 parameters)
    through ``launch.train.train_sequence``, and through the training
    CLI ``launch.train.main`` for all five acoustic archs, with
    checkpoints, and the paper's example (CE -> NGHF vs SGD/Adam);
  * LM serving: recurrentgemma-9b at full width and depth (38 layers,
    10,444,771,328 parameters, random weights from a seed) through
    ``launch.steps.build_prefill_step`` and ``launch.serve.serve``;
  * LM training: whisper-base at full width and depth (6 + 6 layers,
    130,737,152 parameters) trained by NGHF with the fused CG kernel
    through the training CLI (``launch.steps.build_step``);
  * the dense ``attn`` archs: qwen2.5-3b (3,085,938,688 parameters, tied
    embeddings, q/k/v biases) served at full width and depth, with
    ``serve``'s long mode, and trained by NGHF with the fused CG kernel
    at full width and 8 of its 36 layers; stablelm-1.6b trained by Adam
    through the CLI; minitron-8b and stablelm-1.6b served;
  * the MoE archs: granite-moe-3b-a800m (3,298,793,472 parameters, 40
    experts top-8, tied) served at full width and depth, with long mode,
    trained by NGHF with the fused CG kernel and by Adam at full width
    and 8 of its 32 layers;
    mixtral-8x22b's windowed prefill at full width and 2 of its 56 layers
    (5,410,781,184 parameters) through the tensor-core attention kernel at
    its head geometry (G = 6, hd 128, window 4096);
  * the xLSTM arch: xlstm-125m (150,319,176 parameters, 9 mLSTM and 3
    sLSTM blocks, tied) served at full width and depth and trained by
    NGHF with the fused CG kernel at full width and 4 of its 12 layers;
  * training through the windowed attention: recurrentgemma-9b at full
    width and 3 of its 38 layers (2,753,638,400 parameters) trained by SGD
    through the attention's backward kernels; recurrentgemma-9b and
    mixtral-8x22b at their smoke configs trained by NGHF through the
    backward and jvp kernels;
  * distribution: the paper's data-parallel NGHF sequence training of
    the full-width LSTM on a mesh (``launch.mesh``), at world size 1
    over NCCL through ``train_sequence(mesh="1x1")`` and on two ranks
    of the one card over gloo; and the LM archs' FSDP storage
    (``launch.fsdp``): qwen2.5-3b trained by NGHF through
    ``train_lm(mesh="1x1")`` on the same NCCL group, and on two gloo
    ranks of the card, each storing its share of every parameter and
    θ-sized state leaf; and tensor-parallel compute over "model"
    (``launch.tensor_parallel``): qwen2.5-3b's NGHF update and
    recurrentgemma-9b's gradient and SGD step on two gloo ranks of a
    1x2 mesh, each computing its share of the heads, FFN and vocab;
    and serving on a mesh: qwen2.5-3b's prefill and decode at world size
    1 over NCCL, and qwen2.5-3b's, recurrentgemma-9b's and xlstm-125m's
    on two gloo ranks of a 1x2 mesh, each holding its share of the decode
    caches;
  * analysis: the port's kernel sanitizer over every launcher of the
    seven CUDA libraries (``repro_torch.analysis.sanitize_kernels``).

Phases:

  1. environment: the card, torch/CUDA versions, the kernels' build;
  2. each kernel against its plain version (``kernels/ref.py``) on the
     card: the DAG kernels on the five adversarial corpus cases, full-size
     B=8 random-DAG and sausage buckets and a streaming session's bucket
     (W = A), each bitwise on a repeat; all three also on each of the
     compacted design's four branches (the warp or the block-barrier
     chain, with the compact state in shared or global memory: each case
     logs the branch each kernel took, and every kernel must take all
     four), an utterance with no valid slot, rows of one entry, and
     neighbour rows into the slot's own, earlier and later levels; the
     sausage kernels at the training shapes (B=32 and B=8, S=50, A=3),
     at the example's (T = 32: B = 64, 16, 8 and 32, S = 8) with padded, fully masked, fractional-mask, S = 1, 33 and 250 (chunk
     edges of the forward and backward scan) and A=40 cases, each bitwise
     on a repeat; ``sausage_loss_only`` also on
     adversarial spans (zero-length, ending at T, label K-1, masked arcs
     with out-of-range labels, T = 1, T = 1000 with spans up to T, 16,000
     slots), and bitwise on a repeat; the fused CG
     update at the parameter count of each of the five *-asr archs (N =
     19,335,000 for the LSTM) and of whisper-base (N = 130,737,152) in
     f32 and bf16, and bitwise on a repeat;
     ``swa_attention`` on adversarial shapes (T = 1, T <= window, ragged
     T, window 0, a window past T, MHA/GQA/MQA, hd 32-256, f32 through
     the CUDA-core kernel and bf16 through the tensor-core kernel, whose
     tiles of 128 (query, head) rows take G = H / K of 1, 2, 3, 4 and 16)
     and at the prefill shape (B=2, T=32768, H=16, K=1, hd=256, window
     2048, bf16), and bitwise on a repeat;
  3. the service (``RescoringService.run``) over a Poisson mix of 48
     requests — every request ``ok``, results equal to the plain
     levelized path on the card, batch-mix independence bitwise, and
     ``dag_loss_only`` launched exactly once per dispatch;
  4. streaming: checkpoint half the levels of a T=1000 lattice, resume,
     bit-exact against from-scratch, ``dag_forward`` launched once per
     dispatch and ``dag_backward`` not (the session runs the forward
     recursion alone); the kernels held against their plain versions on
     the resume lattice, and the forward kernel's own final-arc fold
     bit-exact between resume and scratch; one whole session dispatch
     timed on the host clock and split into its stages;
  5. training: ``train_sequence(arch="lstm-asr", optimizer="nghf",
     loss="mpe", steps=3, batch=32, cg_batch=8, frames=200, kappa=0.5,
     cg_iters=6, ng_iters=2, cg_fused=True, device="cuda")`` — finite
     metrics, every accepted update below its Δθ=0 baseline, the launches
     per update of the sausage and CG kernels, each update timed and
     split into stages; one update through the plain path
     (``backend="levelized"``, ``cg_fused=False``) from the same
     parameters and batches makes the same decision as the kernel path
     (best iterate — or a tie within the paths' f32 spread, printed —
     and acceptance), and without candidate selection the two paths'
     last CG iterates agree; one update on
     general-DAG lattices runs the DAG kernels under training;
  6. times: each kernel against its plain version at its path's shapes
     (outputs compared, then timed with CUDA events), the bound from the
     bytes or operations it must do (the DAG kernels at all four DAG
     shapes, the service's, the session's and the DAG training's gradient
     and CG batches, with their time a level; every lattice kernel and
     the fused CG update also alone, one launch behind a busy stream; the
     sausage forward and backward also at S = 250, T = 1000),
     one ``{"kernels": [...]}`` line
     (``swa_attention``'s row is timed after phase 7, on a freed card,
     in turns with the CUDA-core kernel at the same bf16 shape, the plain
     version and ``scaled_dot_product_attention``, its library
     yardstick);
  7. LM serving, recurrentgemma-9b: parameters drawn on the card;
     ``build_prefill_step`` over B=2 prompts of T=32768 tokens (prefill_32k
     with its batch cut from 32 to 2) — logits (2, 1, 256000) finite,
     the tensor-core ``swa_attention`` kernel launched exactly 12 times
     (the 12 local layers) and the CUDA-core kernel never; the f32
     prefill launches the CUDA-core kernel 12 times, the plain path
     neither;
     the same prefill through the plain path on the card: at f32 compute
     (B=1) within relative L2 1e-4, at bf16 within a limit below a
     control's reading (the plain path with P rounded to bf16) and no
     farther from the f32 logits than the plain path's (x1.5); at f32
     compute,
     prefill's last logits against 64 decode
     steps within relative max 1e-3 (T = 64 <= window, where the
     reference's prefill and ring decode agree); ``serve`` over 8
     requests of 4-11 prompt tokens and 16 new tokens; prefill, layer and
     decode times, peak device memory;
  8. the training CLI, checkpoints and the example (run after phase 6,
     before phase 7): first the paper's example
     (``repro_torch.examples.train_asr_mpe.run_pipeline``) on the
     full-width LSTM with its frames (T = 32) and batches: CE pretraining,
     4 NGHF updates (8 before the script outgrew its time), SGD and Adam
     with 80 each, its table, each NGHF
     update's acceptance, best iterate and outer-CG vᵀBv; then the
     training CLI ``launch.train.main`` at the training phase's widths (T
     = 200, batch 32, CG batch 8, 6 CG and 2 NG iterations,
     ``--cg-fused``): ``lstm-asr`` with ``--warm-start --adapt-lam``
     resumed from the example's CE model saved as a params-only checkpoint
     (the reference's legacy format), 2 updates, then ``--resume`` to 3 —
     the resumed log starts at update 2, and the train state loaded from
     each checkpoint equals the state ``train_sequence`` held when it
     saved, bitwise on the card; an Adam train state of the same model
     saved and loaded the same way; one update from a random start for
     each of ``rnn-asr``, ``rnn-relu-asr``, ``tdnn-asr`` and
     ``tdnn-relu-asr`` with ``--preconditioner share_counts``, run twice
     and the second run timed; every update finite, the sausage
     statistics and fused CG kernels launched exactly as
     ``launches_per_update`` counts (in the example, plus one pass per
     SGD and Adam step and per held-out batch) and the loss-only kernel
     within its bounds; update, save and load times logged;
  9. LM training (run after phase 8, before phase 7, on a card freed with
     ``empty_cache``): the training CLI ``launch.train.main`` on
     whisper-base at full width and depth (130,737,152 parameters; B =
     16, T = 448, whisper's own text context, with train_4k's T 4096 and
     B 256 cut to what one card holds; 1500 encoder frames; CG batch 4;
     8 CG and 4 NG iterations, ``--cg-fused``): 2 updates with a
     checkpoint, then ``--resume`` to 3 — the resumed log starts at step
     2, the loaded train state equals the saved one bitwise, every metric
     finite, every accepted update below its Δθ=0 baseline,
     ``cg_fused_update`` launched exactly 12 times an update and no other
     kernel; one update from the CLI's start through the kernel path and
     through the plain path (``cg_fused=False``): the same decision (or a
     tie within the paths' spread) and, without candidate selection, the
     last iterate's Δθ within relative L2 2e-2 (the plain path's own
     repeat printed beside it), the update split by the stage timer;
     Adam through the same ``build_step`` for 3 steps, finite; at f32
     compute ``prefill_cache`` and 16 greedy ``decode_step``s against
     ``forward``'s logits within relative max 1e-3; peak device memory;
     ``cg_fused_update`` timed at N = 130,737,152 against its bound
     (the ``lm_*`` keys of its row in the kernels line);
 10. the dense archs (run after phase 9, before phase 7, on a card freed
     with ``empty_cache``): qwen2.5-3b at full width and depth, drawn on
     the card — ``build_prefill_step`` over B = 1 x T = 16384
     (prefill_32k, its batch cut from 32 to 1, its T halved) after a
     T = 4096 warm-up,
     logits (1, 1, 151936) finite, no kernel launched, the attention
     layers timed apart by CUDA events; ``serve`` over 8 requests against
     a 32768-slot cache (decode_32k, batch cut from 128 to 8), the B = 8
     step and its attention timed; at f32 compute the prefill's last
     logits against 64 decode steps within relative max 1e-3;
     ``input_specs("long_500k")``'s bounded cache (8192 slots, its bytes)
     and 16 long-mode decode steps at B = 1 from position 524,272, each
     writing slot ``pos % 8192``; then NGHF at full width and 8 of 36
     layers (927,782,912 parameters; full depth needs about 173 GB of
     θ-sized state) through ``build_step(..., cg_frac=4)``: B = 8, T =
     512, CG batch 2, 8 CG and 4 NG iterations, ``cg_fused=True``, 2
     updates — finite metrics, accepted updates below their Δθ=0
     baseline, ``cg_fused_update`` launched exactly 12 times an update
     and no other kernel — one update against the plain path (the same
     decision or a tie within the paths' spread, last-iterate Δθ within
     relative L2 2e-2, the plain path's repeat printed), the stage split,
     a device trace, peak memory; the CLI training stablelm-1.6b by Adam
     at full width and depth (3 steps, B 8, T 128); minitron-8b and
     stablelm-1.6b at full width and depth: a B = 1, T = 4096 prefill
     and ``serve`` of 4 requests x 8 new tokens; chameleon-34b's and
     qwen2-72b's parameter counts on the meta device; and
     ``cg_fused_update`` timed at N = 927,782,912 against its bound (the
     ``dense_*`` keys of its row);
 11. the MoE archs (run after phase 10, before phase 7, on a card freed
     with ``empty_cache``): granite-moe-3b-a800m served at full width and
     depth as phase 10's qwen2.5-3b (B = 1 x T = 16384 prefill, logits
     (1, 1, 49155) finite, no kernel launched, attention and expert FFN
     timed apart; ``serve`` over a 32768-slot cache, the B = 8 step split
     into attention, expert FFN and the FFN's per-step expert casts; f32
     prefill vs 64 decode steps; 16 long-mode steps over the 8192-slot
     ring); NGHF at full width and 8 of 32 layers (881,326,080
     parameters) through ``build_step(..., cg_frac=4)`` with phase 10's
     settings and checks, the aux term printed; Adam through the same
     ``build_step`` at those 8 layers (3 steps, B 8, T 128: at full depth
     the out-of-place Adam needs about 92 GB); mixtral-8x22b at full
     width and 2 of 56 layers (its 140,630,071,296 parameters counted on
     the meta device): a bf16 prefill of B = 1 x T = 32768 launching the
     tensor-core ``swa_attention`` exactly twice and the CUDA-core kernel
     never, the kernel held against its plain version on layer 0's q, k,
     v (one bf16 ulp, at most 1 % of the entries differing) and timed
     there (the ``moe_*`` keys of its row: 20 calls, alone, the plain
     version, SDPA with the band mask, the bound); an f32 prefill of T =
     8192 through the CUDA-core kernel against the plain path (relative L2
     1e-4) with the share of tokens whose top-2 experts differ; f32
     prefill vs 64 decode steps; ``moe_apply_dispatch`` at granite's full
     width on the card against the CPU (B 2, T 256, f32, relative L2
     1e-5) and timed against ``moe_apply`` (B 8, T 512, bf16); and
     ``cg_fused_update`` timed at N = 881,326,080 against its bound (the
     ``moe_*`` keys of its row);
 12. the xLSTM arch (run after phase 11, before phase 7, on a card freed
     with ``empty_cache``): xlstm-125m at full width and depth, drawn on
     the card — ``build_prefill_step`` over prefill_32k at its own B = 32
     x T = 32768 (halved only if it does not fit, the cut printed) after
     a T = 4096 warm-up, logits (B, 1, 50304) finite, no kernel launched,
     the mLSTM and sLSTM blocks timed apart by CUDA events, peak memory;
     a B = 128 decode step (decode_32k's batch: the state does not grow
     with the context) split into the two kinds of block; ``serve`` over
     8 requests; at f32 compute the prefill's last logits at T = 512
     against 512 decode steps within relative max 1e-3; 16 long_500k
     steps at B = 1 from position 524,272, the state's bytes against
     ``input_specs``; layer 0's chunkwise mLSTM against the step
     recurrence (f32, B 2, T 1024): the residual branch within relative L2
     1e-5, one vjp's parameter gradient and one jvp's tangent within 1e-4;
     layer 3's sLSTM with its loops as CUDA graphs against plain loops
     (the same, within 1e-6, bitwise printed); NGHF through the
     CLI at 4 of the 12 layers (``--layers 4``: one period, 3 mLSTM + 1
     sLSTM; 75,863,064 parameters; B 8, T 256, CG batch 2, 8 CG and 4 NG
     iterations, the share-counts preconditioner, ``--cg-fused``): 2
     updates with a
     checkpoint, then ``--resume`` to 3, with phase 9's checks (12
     ``cg_fused_update`` launches an update and no other kernel); one
     update through the kernel and the plain path (the same decision,
     last-iterate Δθ within relative L2 2e-2, the stage split, a device
     trace of one of its curvature products at T 256); Adam through the
     CLI, 3 steps (the update at train_4k's T 4096, 133-162 s, was cut
     when phase 14 came, the depth to 4 layers when phase 15 came, and T
     512 to 256 when phase 18 came, to keep the script near 1000 s);
     ``cg_fused_update`` timed at N =
     75,863,064 against its bound (the ``xlstm_*`` keys of its row);
 13. training recurrentgemma-9b and mixtral-8x22b (run after phase 12,
     before phase 7, on a card freed with ``empty_cache``): (a) the
     windowed attention's derivative kernels (dq and dk/dv: bf16 on the
     tensor cores, ``csrc/swa_attention_bwd_sm90.cu``, f32 on the CUDA
     cores, ``csrc/swa_attention_bwd.cu``; the jvp, ``csrc/swa_attention_
     bwd.cu``) against their plain versions on phase 2's adversarial
     shapes, recurrentgemma-9b's training shape (B 2, T 4096, H 16, K 1,
     hd 256, window 2048, bf16) and mixtral-8x22b's geometry (B 1, T 8192,
     H 48, K 8, hd 128, window 4096, bf16), each backward route on every
     shape (the CUDA-core pair on bf16 inputs too, the tensor-core pair on
     the f32 shapes' inputs in bf16), each route's launches counted: f32
     relative L2 1e-5 per tensor, bf16 within 1.5 x the plain bf16
     result's distance from the f32 one (+ 1e-6), bitwise on a repeat; at
     the two full shapes timed in turns with the CUDA-core pair on the
     same bf16 inputs, the plain versions and SDPA's backward with the
     band mask; (b) recurrentgemma-9b at full width and 3 layers
     trained by SGD through ``build_step``, 3 steps at B 2 x T 4096
     (train_4k with its batch cut from 256): finite loss, one forward, dq
     and dk/dv launch a step on the tensor cores (none on the CUDA cores),
     no jvp, the step time and peak memory; one
     step's gradient against the plain path (attention's plain version on
     the card) within relative L2 2e-2; (c) both archs' smoke configs
     (mixtral-8x22b's at 1 layer) trained by NGHF at T 64 past their window of 16, one update per
     curvature mode (``rematvp``, ``linearize``): the kernel path (the
     attention kernels, the tensor-core backward among them, fused CG)
     takes the plain path's decision (or a
     tie within the paths' spread), last-iterate Δθ within relative L2
     2e-2.  The three kernels' rows of the ``{"kernels": ...}`` line
     follow the TPU kernels'.
 14. the mesh (run after phase 13, before phase 7): (a)
     ``train_sequence(mesh="1x1")`` over NCCL at world size 1 with phase
     5's settings, 2 updates: finite metrics, the sausage kernels'
     launches as on one device and ``cg_fused_update`` once per leaf per
     CG iteration (``cg_fused_update_tree``), the collectives' share of
     the update time (each collective between two synchronizes); phase
     5's update 0 on the mesh takes the one-process kernel path's
     decision (or a tie within the paths' spread), last-iterate Δθ
     within relative L2 2e-2, and its time beside phase 5's; (b) two
     processes on the card, a 2x1 mesh over gloo, each running 16 of
     the 32 gradient rows and 4 of the 8 CG rows through the kernels:
     the two ranks' parameters bitwise equal, last-iterate Δθ within 2e-2
     of the one-process kernel path, each rank's launches; (c)
     ``cg_fused_update_tree`` at the LSTM's leaves against its plain
     per-leaf version (x, r bitwise, rr within 1e-6 relative), timed
     beside the flat call.  Its numbers join ``cg_fused_update``'s row
     (``tree_*`` and ``mesh_*`` keys).  Phase 14's NCCL group stays up
     for phase 15;
 15. the LM archs on a mesh under FSDP storage: (a) qwen2.5-3b at
     phase 10's width, 8 layers, B 8 x T 512 and settings through
     ``train_lm(mesh="1x1")`` in 2d storage over phase 14's NCCL group
     (no second group): 2 updates, ``cg_fused_update`` once per leaf per
     CG iteration (14 leaves x 12 = 168 an update), each update's time
     beside phase 10's; phase 10's update 0 on the mesh takes phase
     10's one-process decision (or a tie) with the last-iterate Δθ
     within 2e-2 (phase 10's limit); the group is destroyed after it;
     (b) two gloo processes on the card, a 2x1 mesh, qwen2.5-3b at full
     width and 2 layers, B 4 x T 512, NGHF with 2 CG and 1 NG
     iterations, warm start and the Fisher diagonal, each rank placing
     its share from the whole draw: replicated leaves bitwise equal
     across ranks, the split ones put together and the last-iterate Δθ
     within 2e-2 of the one-process update on the same CG batch, 42
     launches a rank, each rank's θ-sized bytes beside one process's,
     its peak memory and its update's seconds (``fsdp_*`` keys of
     ``cg_fused_update``'s row);
 16. tensor-parallel compute over "model" (run after phase 15, before
     phase 7): two gloo processes on the card, a 1x2 mesh, each rank
     computing its share of the heads, FFN columns and vocab.  (a)
     qwen2.5-3b at phase 15(b)'s settings: the one-process decision (or
     a tie), the last-iterate Δθ within 1e-2, replicated leaves bitwise
     equal, each rank's θ-sized bytes (about half one process's), peak
     memory and update time, the leaves used at their split shapes with
     no gather over "model", 42 launches a rank, layer 0's forward split
     against gathered whole (CUDA events); (b) recurrentgemma-9b at full
     width and 3 layers, B 2 x T 4096: each rank's gradient against the
     one-process plain path (rel-L2 2e-2) with the local layer's
     forward, dq and dk/dv kernels launched on its 8 query heads and
     the one kv head, then one SGD step timed; the windowed forward, dq,
     dk/dv and jvp kernels at that local shape against their plain
     versions (phase 2's and 13's tolerances), timed (``tp_*`` keys of
     rows 7-11); (c) xlstm-125m at 4 layers, B 8 x T 512, an NGHF update
     against one process's as (a)'s; (d) whisper-base at full size, its
     gradient against one process's (2e-2) and one Adam step; (e)
     granite-moe-3b-a800m at full width and 2 layers, the dispatch MoE
     at f32, its gradient against one process's (2e-2) and the pairs each
     layer drops the same.  The decoder-only cases run with the residual
     stream split over T between the units (sequence-parallel
     activations; whisper-base keeps it whole): each case prints whether
     it did, the stream's shape, the count and bytes of the all-gathers,
     reduce-scatters and all-reduces over "model", each rank's peak
     memory, a layer's forward whole, split and split with the stream
     split over T, and for (b) one gradient with the stream whole beside
     one with it split, beside what PERF.md records from before it;
 17. serving on a mesh (after phase 16, before phase 7): the prefill and
     decode steps with a mesh (``launch.steps.build_prefill_step(mesh=)``,
     ``build_serve_step(mesh=)``), each rank holding its share of the
     parameters and only its share of the decode caches, placed by
     ``input_shardings`` (``Model.init_cache(mesh=)``).  (a) World 1
     over NCCL: qwen2.5-3b at full width and 2 layers, a B 2 x T 4096
     prefill and 16 decode steps at B 8 over 32768 slots, bitwise equal
     to the no-mesh steps (prefill, decode logits and caches: no
     collective runs at world 1).  (b) Two gloo processes on the card, a
     1x2 mesh, against one process on the card: qwen2.5-3b's decode at
     f32, each rank holding 16384 slots, its 16 steps crossing from rank
     0's slots into rank 1's (both ranks write, both hold real keys);
     recurrentgemma-9b at 3 layers, its bf16 prefill at B 2 x T 4096
     (rel-L2 0.032; one ``swa_attention_sm90`` launch a rank, on its 8
     heads) and 16 f32 decode steps at B 8 past the local ring's length,
     crossing its rank boundary likewise; xlstm-125m at full depth, 16
     f32 decode steps at B 128:
     the logits within rel max 1e-3 of the largest, each rank's cache
     bytes half of one process's (xlstm's whole stabilisers aside), its
     peak memory, the ms a step (gloo: every collective staged through
     the host).
 18. the port's kernel sanitizer on the card
     (``repro_torch.analysis.sanitize_kernels``, run after every other
     phase): ``run_sanitize`` over the five adversarial corpus cases in f32
     and bf16 and the vector kernels (the attention forward, vjp and jvp
     on the tensor-core route at bf16, hd 64, and on the CUDA-core route at
     f32 and bf16; the fused CG at f32 and bf16), zero KS001-KS005
     failures; ``self_test``'s two seeded mutants (an off-by-one frontier
     into the real ``dag_forward``, bf16 loss-only sums) flagged by KS003
     and KS005; the captured records equal to the ``build.launch`` calls,
     and every launcher of the seven libraries run on its route (the
     tensor-core launchers at bf16, the CUDA-core ones at f32); the
     launches per launcher and the KS001 facts (threads, dynamic shared
     bytes, static shared bytes from ptxas) logged.  NVIDIA's
     ``compute-sanitizer`` is not run: on the H100 machine of the port's
     card runs its tools answer "Device not supported", even for a plain
     CUDA program (``scripts/compute_sanitizer_probe.sh``; ROADMAP 1.5.1).

The last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before it; without a card, or outside a checkout of the repo,
the script exits non-zero and prints no result.

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.acoustic import get_acoustic_config  # noqa: E402

SEED = 0
KAPPA = 0.5
# log-prob width K: the paper's LSTM acoustic model's tied triphone states
NUM_STATES = get_acoustic_config("lstm-asr").num_outputs
N_REQUESTS = 48
BATCH = 8
# Kernel vs plain version: |kernel - plain| <= ATOL + RTOL * |plain|.  Both
# are f32; they sum in different orders (sequential per slot in the
# kernel, PyTorch's reductions in the plain version), and the two fused
# loss-only kernels sum each span directly where the plain version takes
# a centred cumsum difference.  Scores reach |alpha| ~ 5e3 at T=1000,
# where one f32 ulp is 4.9e-4.
ATOL, RTOL = 1e-3, 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak rate
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
TPU_KERNELS = {
    "dag_forward": "src/repro/kernels/lattice_fb.py:419",
    "dag_backward": "src/repro/kernels/lattice_fb.py:465",
    "dag_loss_only": "src/repro/kernels/lattice_fb.py:563",
    "sausage_forward": "src/repro/kernels/lattice_fb.py:154",
    "sausage_backward": "src/repro/kernels/lattice_fb.py:610",
    "sausage_loss_only": "src/repro/kernels/lattice_fb.py:249",
    "cg_fused_update": "src/repro/kernels/cg_fused.py:43",
    "swa_attention": "src/repro/kernels/swa_attention.py:79",
}
SOURCES = {
    "dag_forward": "src/repro_torch/kernels/csrc/lattice_dag.cu",
    "dag_backward": "src/repro_torch/kernels/csrc/lattice_dag.cu",
    "dag_loss_only": "src/repro_torch/kernels/csrc/lattice_dag.cu",
    "sausage_forward": "src/repro_torch/kernels/csrc/lattice_sausage.cu",
    "sausage_backward": "src/repro_torch/kernels/csrc/lattice_sausage.cu",
    "sausage_loss_only": "src/repro_torch/kernels/csrc/lattice_sausage.cu",
    "cg_fused_update": "src/repro_torch/kernels/csrc/cg_fused.cu",
    "swa_attention": "src/repro_torch/kernels/csrc/swa_attention_sm90.cu",
}
# the training phase: the paper's LSTM at full width, cut in length
# (T = 200 frames) and in steps; synthetic sausages (seg_len 4, 3 arcs)
TRAIN = dict(arch="lstm-asr", optimizer="nghf", loss="mpe", steps=3,
             batch=32, cg_batch=8, frames=200, kappa=KAPPA, cg_iters=6,
             ng_iters=2, cg_fused=True)
LSTM_PARAMS = 19_335_000
# launches per NGHF update with TRAIN's settings (cold start, fixed
# budget): 1 gradient + ng_iters Fisher + cg_iters GN statistics passes,
# ng_iters + cg_iters fused CG updates; the loss-only kernel runs once per
# evaluated candidate plus the Δθ=0 baseline


def launches_per_update(cg_iters: int, ng_iters: int,
                        warm_start: bool = False,
                        adapt_lam: bool = False) -> dict:
    """Sausage statistics passes and fused CG updates per NGHF update; a
    warm start adds the residual's curvature product, adaptive λ the
    reduction ratio's.  ``loss_only_max``: every CG iterate evaluated,
    plus the Δθ=0 baseline."""
    passes = 1 + ng_iters + cg_iters + int(warm_start) + int(adapt_lam)
    return {"forward": passes, "backward": passes,
            "cg": ng_iters + cg_iters, "loss_only_max": cg_iters + 1}


PER_UPDATE = launches_per_update(6, 2)
# kernel path vs plain path, one update from the same parameters without
# candidate selection: the last CG iterate's Δθ, relative L2.  f32 on
# both paths with lattice sums in other orders, the rounding amplified
# through 8 curvature products of a badly scaled system (from a random
# initialisation the outer CG's vᵀBv grows by orders of magnitude per
# iteration); the plain path's autograd scatters with atomics, so even
# its own repeat differs, and the script logs that repeat beside this
# bound.  The CPU parity tests reach 1e-6 at smoke size.
DELTA_REL_L2 = 2e-2
# the fused CG update against its plain version: x, r bitwise in f32 (the
# same two roundings per element), rr within 1e-6 relative (a fixed tile
# tree against PyTorch's sum)
RR_RTOL = 1e-6
# LM serving: recurrentgemma-9b at full width and depth; prefill_32k's
# T = 32768 with its batch cut from 32 to 2; the server as serve.main
LM_ARCH = "recurrentgemma-9b"
LM_PARAMS = 10_444_771_328
PREFILL_BATCH, PREFILL_T = 2, 32768
LOCAL_LAYERS = 12                  # 38 layers of (rglru, rglru, local)
SERVE_REQUESTS, SERVE_NEW = 8, 16
DECODE_PROMPT = 64                 # < window: prefill and decode agree
# swa_attention against its plain version, |d| <= atol + rtol |plain|:
# f32, the same f32 arithmetic in another order (measured max 9e-7); bf16,
# both round to bf16 f32 values that differ in the last f32 bits, so an
# entry may differ by one bf16 ulp, at most 2^-7 |plain| (measured max
# 0.0039 at |o| ~ 1), plus an atol far above the f32 differences
SWA_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 2.0 ** -7)}
# and in bf16 at most this share of the entries differ at all: a flip
# needs an f32 value within ~1e-7 of a rounding midpoint (measured at
# most 0.00075 on the H100), while rounding P to bf16 before P.V (the
# control swa_p_bf16) makes 0.424 of the entries differ, by up to 0.0156,
# at the prefill shape (PERF.md)
SWA_BF16_DIFF_SHARE = 0.01
# the prefill's last logits, kernel path vs plain path (attention's plain
# version), relative L2.  At f32 compute (B=1, T=32768): 1e-4, the same
# f32 arithmetic in another order through 38 layers (measured 6.95e-6).
# At the config's bf16 the two paths' attention outputs differ by one ulp
# in 0.075 % of the entries, and 38 bf16 layers of a random model grow
# that to 0.03087, near half the bf16 noise floor (the plain path's own
# bf16 logits are 0.0707 from its f32 ones).  Any perturbation grows about
# as far: the control, P rounded to bf16 before P.V (0.424 of the entries
# differ), reaches 0.03351.  The limit lies between those two readings;
# both paths are deterministic (the kernel path's reading was the same in
# every run on the H100), and a kernel that sums in another order needs
# both taken anew.  The share check above is
# the one that tells the two apart by a wide margin.  The kernel path's
# bf16 logits must also be no farther from the f32 logits than the plain
# path's, within a factor PREFILL_BF16_FACTOR.
PREFILL_F32_REL_L2 = 1e-4
PREFILL_BF16_REL_L2 = 0.032
PREFILL_BF16_FACTOR = 1.5
# prefill vs decode at f32 compute (relative max)
DECODE_REL = 1e-3
# (B, T, H, K, hd, window) of the prefill's attention, and adversarial
# shapes for phase 2 (dtype per case)
SWA_FULL = (PREFILL_BATCH, PREFILL_T, 16, 1, 256, 2048)
SWA_CASES = (
    ((1, 1, 4, 4, 64, 16), torch.float32),        # T = 1
    ((2, 100, 4, 1, 64, 128), torch.float32),     # T <= window, MQA
    ((2, 333, 8, 2, 128, 64), torch.float32),     # ragged T, GQA
    ((1, 200, 2, 2, 256, 0), torch.float32),      # window 0
    ((1, 300, 4, 4, 32, 1000), torch.float32),    # window past T, hd 32
    ((1, 513, 4, 4, 80, 96), torch.bfloat16),     # hd 80, ragged, MHA
    ((2, 1000, 16, 1, 256, 200), torch.bfloat16),
    ((1, 4100, 16, 1, 256, 2048), torch.bfloat16),  # ragged past window
    ((1, 4100, 16, 1, 256, 2048), torch.float32),
    # the tensor-core kernel's tiles: G = H / K of 1 (128 queries x 1
    # head), 2, 3 (42 queries, two rows masked), 4 and 16 (8 x 16)
    ((1, 1, 4, 4, 64, 16), torch.bfloat16),       # T = 1, G = 1
    ((1, 7, 16, 1, 128, 0), torch.bfloat16),      # T < 8 queries, window 0
    ((2, 9, 32, 2, 256, 100), torch.bfloat16),    # ragged T, window past T
    ((1, 300, 6, 2, 64, 37), torch.bfloat16),     # G = 3
    ((2, 333, 8, 4, 128, 64), torch.bfloat16),    # G = 2
    ((1, 200, 2, 2, 256, 0), torch.bfloat16),     # MHA, window 0
    ((2, 100, 4, 1, 64, 128), torch.bfloat16),    # MQA, T <= window
)
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def log_probs(gen: torch.Generator, frames: int, dev) -> torch.Tensor:
    return torch.randn(frames, NUM_STATES, generator=gen,
                       device=dev).log_softmax(-1)


def compare(name: str, got, want, errs: dict, rel_errs: dict) -> None:
    """Hold kernel outputs against the plain version's; record the max
    abs error and the max relative error (over |plain| > ATOL) per case."""
    worst = worst_rel = 0.0
    for g, w in zip(got, want):
        diff = (g - w).abs()
        bad = diff > ATOL + RTOL * w.abs()
        check(not bool(bad.any()),
              f"{name}: {int(bad.sum())} entries outside |d| <= {ATOL} + "
              f"{RTOL}|ref| (max |d| {float(diff.max()):.3g})")
        if diff.numel():
            worst = max(worst, float(diff.max()))
        big = w.abs() > ATOL           # relative error where |plain| > ATOL
        if bool(big.any()):
            worst_rel = max(worst_rel,
                            float((diff[big] / w.abs()[big]).max()))
    errs[name] = max(errs.get(name, 0.0), worst)
    rel_errs[name] = max(rel_errs.get(name, 0.0), worst_rel)


def level_inputs(lat, lp):
    """The DAG kernels' level-major inputs for ``lat`` as the CUDA backend
    builds them: (forward args, backward args, frontiers)."""
    from repro_torch.lattice_engine.common import arc_scores
    from repro_torch.lattice_engine.cuda_backend import dag_level_tensors
    from repro_torch.losses.lattice import lattice_frontiers
    fr = lattice_frontiers(lat)
    own, corr, start, ok, final = dag_level_tensors(
        lat, arc_scores(lat, lp, KAPPA) + lat.lm, fr)
    return ((own, corr, start, ok, final, fr.pidx),
            (own, corr, final, ok, fr.sidx), fr)


def loss_only_inputs(lat, lp, fr):
    return (lp, lat.start_t, lat.end_t, lat.label, lat.lm, lat.corr,
            lat.arc_mask, lat.is_start, lat.is_final, lat.level_arcs,
            fr.pidx)


def check_dag(name: str, args, branch, errs: dict, rel_errs: dict,
              tag: str) -> list:
    """DAG kernel ``name`` against its plain version, and bitwise on a
    repeat; returns the sorted distinct (chain, state) branches its kernel
    took over the utterances (``lattice_fb.dag_branches`` on ``branch``:
    the skip flags, ok flags and row width)."""
    from repro_torch.kernels import lattice_fb as K
    from repro_torch.kernels import ref as R
    kw = {"kappa": KAPPA} if name == "dag_loss_only" else {}
    kern, plain = getattr(K, name), getattr(R, f"{name}_ref")
    got = kern(*args, **kw)
    compare(f"{name}[{tag}]", got, plain(*args, **kw), errs, rel_errs)
    again = kern(*args, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{name}[{tag}]: two launches gave other bits")
    return sorted(set(K.dag_branches(name, *branch)))


def check_dags(fwd, bwd, lo, errs: dict, rel_errs: dict, tag: str) -> dict:
    """The three DAG kernels (``check_dag``); {kernel: branches}.  The
    loss-only kernel's slots are the frontiers' ok / start flags."""
    branches = {
        "dag_forward": check_dag("dag_forward", fwd,
                                 (fwd[2], fwd[3], fwd[5].shape[-1]), errs,
                                 rel_errs, tag),
        "dag_backward": check_dag("dag_backward", bwd,
                                  (bwd[2], bwd[3], bwd[4].shape[-1]), errs,
                                  rel_errs, tag),
        "dag_loss_only": check_dag("dag_loss_only", lo,
                                   (fwd[2], fwd[3], lo[-1].shape[-1]), errs,
                                   rel_errs, tag)}
    torch.cuda.synchronize()
    return branches


def check_kernels(lat, lp, errs: dict, rel_errs: dict, tag: str) -> dict:
    """The three DAG kernels on ``lat`` as the CUDA backend feeds them."""
    fwd, bwd, fr = level_inputs(lat, lp)
    return check_dags(fwd, bwd, loss_only_inputs(lat, lp, fr), errs,
                      rel_errs, tag)


# the branch (chain, compact state) each case is built to take, the same
# for all three DAG kernels
DAG_BRANCH_CASES = {"wide_a40_t100": ("block", "shared"),
                    "global_a40_t1000": ("block", "global"),
                    "global_a20_t1000": ("warp", "global"),
                    "p1": ("warp", "shared")}


def dag_branch_cases(dev, rng, gen) -> dict:
    """tag -> (dag_forward, dag_backward, dag_loss_only inputs) for the
    branches of the compacted design: sausages of 40 alternatives (levels
    of 40 slots: the block-barrier chain) at T = 100 (state in shared
    memory) and T = 1000 (10,000 valid slots at P = S = 40: the
    global-memory state), sausages of 20 alternatives at T = 1000 (the
    warp chain on a global-memory state of about 5,000 slots at 20 a
    row), an utterance with no valid slot, rows of one entry, and random
    neighbour positions that reach the slot's own level, earlier and
    later levels and the dump slot (the plain versions read NEG / 0 where
    a level is not computed yet)."""
    from repro_torch.losses.lattice import (make_random_dag_lattice,
                                            make_sausage_lattice)
    from repro_torch.serving import packing
    cases = {}
    for tag, frames, n_alt in (("wide_a40_t100", 100, 40),
                               ("global_a40_t1000", 1000, 40),
                               ("global_a20_t1000", 1000, 20)):
        dicts = [make_sausage_lattice(rng, num_frames=frames - 8 * b,
                                      num_states=NUM_STATES, n_alt=n_alt)
                 for b in range(2)]
        spec = packing.derive_buckets(dicts, batch=2, tiers=1)[0]
        lat, _ = packing.pack_requests(dicts, spec, device=dev)
        lp = torch.stack([log_probs(gen, spec.num_frames, dev)
                          for _ in range(2)])
        fwd, bwd, fr = level_inputs(lat, lp)
        cases[tag] = (fwd, bwd, loss_only_inputs(lat, lp, fr))
    dicts = [make_random_dag_lattice(rng, num_frames=300,
                                     num_states=NUM_STATES)
             for _ in range(4)]
    spec = packing.derive_buckets(dicts, batch=4, tiers=1)[0]
    lat, _ = packing.pack_requests(dicts, spec, device=dev)
    lp = torch.stack([log_probs(gen, spec.num_frames, dev)
                      for _ in range(4)])
    fwd, bwd, fr = level_inputs(lat, lp)
    own, corr, start, ok, final, pidx = fwd
    sidx = bwd[4]
    lo = loss_only_inputs(lat, lp, fr)
    empty = ok.clone()
    empty[1] = 0.0
    mask = lat.arc_mask.clone()
    mask[1] = False
    cases["no_valid_slot"] = ((own, corr, start, empty, final, pidx),
                              (own, corr, final, empty, sidx),
                              lo[:6] + (mask,) + lo[7:])
    p1, s1 = pidx[..., :1].contiguous(), sidx[..., :1].contiguous()
    cases["p1"] = ((own, corr, start, ok, final, p1),
                   (own, corr, final, ok, s1), lo[:-1] + (p1,))
    B, L, W, P = pidx.shape
    wild = torch.randint(0, L * W + 1, (B, L, W, P), generator=gen,
                         device=dev, dtype=torch.int32)
    wild_s = torch.randint(0, L * W + 1, tuple(sidx.shape), generator=gen,
                           device=dev, dtype=torch.int32)
    cases["cross_level_rows"] = ((own, corr, start, ok, final, wild),
                                 (own, corr, final, ok, wild_s),
                                 lo[:-1] + (wild,))
    return cases


def full_width_workload(dev):
    """Poisson mix at K=6000: sausages of T=300 and T=1000 and random
    DAGs of T=1000 (up to 10 s of 10 ms frames, MGB-like lengths)."""
    from repro_torch.losses.lattice import (make_random_dag_lattice,
                                            make_sausage_lattice)
    from repro_torch.serving.service import RescoreRequest
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    reqs, clock = [], 0.0
    for rid in range(N_REQUESTS):
        clock += float(rng.exponential(1.0 / 200.0))
        kind = rid % 3
        if kind == 0:
            d = make_sausage_lattice(rng, num_frames=300,
                                     num_states=NUM_STATES)
        elif kind == 1:
            d = make_sausage_lattice(rng, num_frames=1000,
                                     num_states=NUM_STATES)
        else:
            d = make_random_dag_lattice(rng, num_frames=1000,
                                        num_states=NUM_STATES)
        lp = log_probs(gen, d["ref_states"].shape[0], dev).cpu().numpy()
        reqs.append(RescoreRequest(rid, d, lp, arrival_s=clock))
    return reqs


def cuda_time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(bytes_moved: float, flops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def forward_work(fwd) -> tuple:
    """(bytes, flops) the forward function must move/do on these inputs:
    ok flags of every slot, own/corr/start/final of valid slots, the
    predecessor rows of valid non-start slots; alpha/c_alpha written."""
    own, _, start, ok, _, pidx = fwd
    okb = ok > 0.5
    n_ok = int(okb.sum())
    n_rec = int((okb & ~(start > 0.5)).sum())
    P = pidx.shape[-1]
    slots = own.numel()
    byt = 4 * slots + 16 * n_ok + 4 * P * n_rec + 8 * slots + 8 * own.shape[0]
    return byt, 8 * P * n_rec + 4 * n_ok


def backward_work(bwd) -> tuple:
    own, _, final, ok, sidx = bwd
    okb = ok > 0.5
    n_ok = int(okb.sum())
    n_rec = int((okb & ~(final > 0.5)).sum())
    S = sidx.shape[-1]
    slots = own.numel()
    byt = 4 * slots + 12 * n_ok + 4 * S * n_rec + 8 * slots
    return byt, 10 * S * n_rec


def loss_only_work(lat, lp, fr) -> tuple:
    """(bytes, flops) the function must move / do on these inputs, then
    the same for the cumsum-grid design it replaced.  Now: the log-probs
    under the valid arcs' spans, the mask of every arc a slot names,
    start/end/label/lm/corr and the start/final flags of the valid ones,
    level_arcs, the predecessor rows of valid non-start slots, two (B,)
    outputs; an add per frame, the recursion's operations per row entry
    and per slot.  The grid design read every log-prob (its cumsum needs
    all of them) and every arc's fields."""
    B, A = lat.start_t.shape
    T = lp.shape[1]
    ids = lat.level_arcs.long().flatten(1)
    named = (ids >= 0) & (ids < A)
    safe = ids.clamp(0, max(A - 1, 0))
    valid = named & (lat.arc_mask.float().gather(1, safe) > 0.5)
    span = (lat.end_t.clamp(0, T) - lat.start_t.clamp(0, T)).abs().gather(
        1, safe)
    frames = int((span * valid).sum())
    n_ok = int(valid.sum())
    n_rec = int((fr.ok & ~fr.start).sum())
    P = fr.pidx.shape[-1]
    rows = 4 * lat.level_arcs.numel() + 4 * P * n_rec + 8 * B
    byt = (4 * frames + lat.arc_mask.element_size() * int(named.sum())
           + (20 + lat.is_start.element_size()
              + lat.is_final.element_size()) * n_ok + rows)
    flops = frames + 8 * P * n_rec + 10 * n_ok
    grid_byt = 4 * lp.numel() + B * A * (4 * 5 + 3) + rows
    return byt, flops, grid_byt, 4 * lp.numel() + 8 * P * n_rec + 10 * n_ok


def phase_kernels(dev, errs: dict) -> None:
    rel_errs: dict = {}
    from repro_torch.analysis.corpus import ADVERSARIAL_CASES
    from repro_torch.losses.lattice import (make_random_dag_lattice,
                                            make_sausage_lattice)
    from repro_torch.serving import packing
    from repro_torch.serving.streaming import session_bucket
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for name, case in sorted(ADVERSARIAL_CASES.items()):
        lat, T, Kc = case(SEED, device=dev)
        lp = torch.randn(lat.start_t.shape[0], T, Kc, generator=gen,
                         device=dev).log_softmax(-1)
        check_kernels(lat, lp, errs, rel_errs, name)
    rng = np.random.default_rng(SEED + 2)
    for tag, make in (
            ("dag_b8_t1000", lambda: make_random_dag_lattice(
                rng, num_frames=1000, num_states=NUM_STATES)),
            ("sausage_b8_t1000", lambda: make_sausage_lattice(
                rng, num_frames=1000, num_states=NUM_STATES))):
        dicts = [make() for _ in range(BATCH)]
        spec = packing.derive_buckets(dicts, batch=BATCH, tiers=1)[0]
        lat, _ = packing.pack_requests(dicts, spec, device=dev)
        lp = torch.stack([log_probs(gen, spec.num_frames, dev)
                          for _ in range(BATCH)])
        branches = check_kernels(lat, lp, errs, rel_errs, tag)
        log(f"kernels == plain, and bitwise on a repeat, at {tag}: bucket "
            f"{tuple(spec)}, branches {branches}")
    d = make_random_dag_lattice(rng, num_frames=1000, num_states=NUM_STATES)
    spec = session_bucket(d)
    lat, _ = packing.pack_requests([d], spec, device=dev)
    branches = check_kernels(lat, log_probs(gen, spec.num_frames, dev)[None],
                             errs, rel_errs, "stream_bucket")
    log(f"kernels == plain at the streaming bucket {tuple(spec)} "
        f"(W = A), branches {branches}")
    seen: dict = {}
    for tag, (fwd, bwd, lo) in dag_branch_cases(dev, rng, gen).items():
        branches = check_dags(fwd, bwd, lo, errs, rel_errs, tag)
        log(f"DAG kernels == plain, and bitwise on a repeat, at {tag}: "
            f"(B, L, W, P) {tuple(fwd[5].shape)}, S {bwd[4].shape[-1]}, "
            f"widest level {int((fwd[3] > 0.5).sum(-1).max())} valid "
            f"slots, branches {branches}")
        want = DAG_BRANCH_CASES.get(tag)
        for name, got in branches.items():
            seen.setdefault(name, set()).update(got)
            check(want is None or got == [want],
                  f"{tag}: {name} took {got}, not {want}")
    for name, got in seen.items():
        check(got >= set(DAG_BRANCH_CASES.values()),
              f"{name}'s branches {sorted(got)} miss one of "
              f"{sorted(DAG_BRANCH_CASES.values())}")
    torch.cuda.synchronize()
    log(f"every case within |kernel - plain| <= {ATOL} + {RTOL}|plain|; "
        f"max abs / max rel diff by case: "
        + ", ".join(f"{k} {v:.3g} / {rel_errs[k]:.3g}"
                    for k, v in sorted(errs.items())))


def phase_service(dev) -> dict:
    from repro_torch.kernels import lattice_fb as K
    from repro_torch.serving import packing
    from repro_torch.serving.service import RescoringService
    t0 = time.perf_counter()
    reqs = full_width_workload(dev)
    buckets = packing.derive_buckets([r.lattice for r in reqs],
                                     batch=BATCH, tiers=2)
    log(f"workload: {len(reqs)} requests made in "
        f"{time.perf_counter() - t0:.1f} s; buckets "
        + "; ".join(str(tuple(b)) for b in buckets))
    svc = RescoringService(buckets, kappa=KAPPA, device=dev)
    K.reset_launch_counts()
    reqs, metrics = svc.run(reqs)
    launches = K.dag_loss_only.launches
    check(all(r.status == "ok" for r in reqs),
          f"service: statuses {[r.status for r in reqs]}")
    check(all(c == 1 for c in svc.traces.values()),
          f"service: a bucket dispatched several shapes {svc.traces}")
    n_dispatch = metrics["dispatches"] + len(buckets)     # + warm-up
    check(launches == n_dispatch, f"service: dag_loss_only launched "
          f"{launches} times in {n_dispatch} dispatches, not once each")
    check(K.dag_forward.launches == 0 and K.dag_backward.launches == 0,
          "service: the loss-only path launched the full-statistics kernels")
    log(f"service on the card: {metrics['completed']}/{len(reqs)} ok, "
        f"{metrics['requests_per_s']:.2f} req/s, "
        f"p50 {metrics['latency_p50_s'] * 1e3:.3f} ms, "
        f"p99 {metrics['latency_p99_s'] * 1e3:.3f} ms, "
        f"slot_fill {metrics['slot_fill']:.3f}, "
        f"arc_fill {metrics['arc_fill']:.3f}, "
        f"{metrics['dispatches']} dispatches (+{len(buckets)} warm-up), "
        f"dag_loss_only launches {launches}")
    # per-request results against the plain levelized path on the card
    plain = RescoringService(buckets, kappa=KAPPA, backend="levelized",
                             device=dev).rescore(
        [r.lattice for r in reqs], [r.log_probs for r in reqs])
    worst = 0.0
    for r, p in zip(reqs, plain):
        for key in ("logZ", "c_avg"):
            d = abs(r.result[key] - p[key])
            check(d <= ATOL + RTOL * abs(p[key]),
                  f"service request {r.rid} {key}: kernel {r.result[key]} "
                  f"vs plain {p[key]}")
            worst = max(worst, d)
    log(f"service results == plain levelized path on the card "
        f"(max |d| {worst:.3g})")
    # batch-mix independence: the same requests in other mixes, bitwise
    spec = max(buckets, key=lambda b: b.cost)
    group = [r for r in reqs if packing.fits(r.dims, spec)][:spec.batch]
    base = svc.dispatch([r.lattice for r in group],
                        [r.log_probs for r in group], spec)
    rev = svc.dispatch([r.lattice for r in group[::-1]],
                       [r.log_probs for r in group[::-1]], spec)
    for k, r in enumerate(group):
        alone = svc.dispatch([r.lattice], [r.log_probs], spec)
        j = len(group) - 1 - k
        for i in range(2):
            check(base[i][k] == alone[i][0] == rev[i][j],
                  f"batch mix changed request {r.rid}'s bits")
    log(f"batch-mix independence: {len(group)} requests bitwise equal "
        f"alone, in order and reversed, bucket {tuple(spec)}")
    # where a full-bucket dispatch's time goes: the whole timed region
    # against the host-to-device copy of its log-probs alone
    lat, _ = packing.pack_requests([r.lattice for r in group], spec,
                                   device=dev)
    lp_host = packing.pack_log_probs([r.log_probs for r in group], spec)
    dispatch_ms = min(svc.dispatch([r.lattice for r in group],
                                   [r.log_probs for r in group], spec)[2]
                      for _ in range(3)) * 1e3
    copies = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp = torch.from_numpy(lp_host).to(dev)
        torch.cuda.synchronize()
        copies.append((time.perf_counter() - t0) * 1e3)
    h2d_ms = min(copies)
    log(f"full-bucket dispatch {dispatch_ms:.3f} ms (min of 3), of which "
        f"the log-prob copy to the card {h2d_ms:.3f} ms "
        f"({lp_host.nbytes / 1e6:.0f} MB from pageable host memory)")
    return {"metrics": metrics, "launches": launches,
            "dispatch_ms": dispatch_ms, "h2d_ms": h2d_ms,
            "launches_per_dispatch": launches / n_dispatch,
            "bucket": spec, "lat": lat, "lp": lp}


def phase_streaming(dev, errs: dict) -> dict:
    from repro_torch.kernels import lattice_fb as K
    from repro_torch.lattice_engine import lattice_stats
    from repro_torch.losses.lattice import (batch_lattices,
                                            make_random_dag_lattice)
    from repro_torch.serving.packing import (pack_log_probs, pack_requests,
                                             pad_to_bucket)
    from repro_torch.serving.streaming import (StreamSession,
                                               resume_lattice_dict,
                                               session_bucket,
                                               truncate_levels)
    rng = np.random.default_rng(SEED + 3)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    d = make_random_dag_lattice(rng, num_frames=1000, num_states=NUM_STATES)
    lp = log_probs(gen, d["ref_states"].shape[0], dev).cpu().numpy()
    spec = session_bucket(d)
    sess = StreamSession(spec, kappa=KAPPA, device=dev)
    cut = max(1, d["level_arcs"].shape[0] // 2)
    K.reset_launch_counts()
    sess.rescore(truncate_levels(d, cut), lp)
    half = sess.checkpoint
    resumed = sess.rescore(d, lp)
    launches = {"dag_forward": K.dag_forward.launches,
                "dag_backward": K.dag_backward.launches,
                "dag_loss_only": K.dag_loss_only.launches}
    check(launches == {"dag_forward": 2, "dag_backward": 0,
                       "dag_loss_only": 0},
          f"streaming: the session must run dag_forward alone, once per "
          f"dispatch (2 dispatches): {launches}")
    scratch = sess.rescore_from_scratch(d, lp)
    check(resumed.logZ == scratch.logZ and resumed.c_avg == scratch.c_avg,
          f"streaming resume ({resumed.logZ!r}, {resumed.c_avg!r}) != "
          f"from scratch ({scratch.logZ!r}, {scratch.c_avg!r})")
    check(sess.traces == 1, f"streaming dispatched {sess.traces} shapes")
    plain = StreamSession(spec, kappa=KAPPA, backend="levelized",
                          device=dev).rescore_from_scratch(d, lp)
    for key in ("logZ", "c_avg"):
        a, b = float(getattr(resumed, key)), float(getattr(plain, key))
        check(abs(a - b) <= ATOL + RTOL * abs(b),
              f"streaming {key}: kernel path {a} vs plain {b}")
    log(f"streaming on the card: cut {cut}/{d['level_arcs'].shape[0]} "
        f"levels, resume bit-exact vs from-scratch (logZ "
        f"{float(resumed.logZ)!r}, c_avg {float(resumed.c_avg)!r}), "
        f"== plain levelized path; launches {launches} over 2 session "
        f"dispatches")
    # The session's result goes through finalize_loss_only (arc layout),
    # as the JAX session's does.  Hold the kernels at the resume lattice
    # the second dispatch ran, and the forward kernel's own final-arc
    # fold (flat level-major order) bit-exact between resume and scratch.
    lp_dev = torch.from_numpy(pack_log_probs([lp], spec)).to(dev)
    rd = resume_lattice_dict(pad_to_bucket(d, spec), *half)
    lat_resume = batch_lattices([pad_to_bucket(rd, spec)], device=dev)
    rel_errs: dict = {}
    resume_branches = check_kernels(lat_resume, lp_dev, errs, rel_errs,
                                    "stream_resume")
    lat, _ = pack_requests([pad_to_bucket(d, spec)], spec, device=dev)
    folds = [lattice_stats(x, lp_dev, KAPPA, backend="cuda",
                           accumulators="full") for x in (lat_resume, lat)]
    for key in ("logZ", "c_avg"):
        a, b = (getattr(st, key) for st in folds)
        check(torch.equal(a, b),
              f"streaming: dag_forward's final fold {key} on the resume "
              f"lattice {a.tolist()} != from scratch {b.tolist()}")
    log(f"kernels == plain on the resume lattice (max |d| forward "
        f"{errs['dag_forward[stream_resume]']:.3g}, backward "
        f"{errs['dag_backward[stream_resume]']:.3g}, loss-only "
        f"{errs['dag_loss_only[stream_resume]']:.3g}; branches "
        f"{resume_branches}); dag_forward's own "
        f"final fold bit-exact resume vs scratch (logZ "
        f"{float(folds[0].logZ[0])!r}, c_avg {float(folds[0].c_avg[0])!r})")
    split = session_dispatch_split(sess, d, lp, dev)
    return {"launches": launches, "dispatches": 2, "bucket": spec,
            "lat": lat, "lp": lp_dev, "split": split}


def session_dispatch_split(sess, d, lp, dev) -> dict:
    """Host clock around one whole session dispatch (from scratch, ended
    by a synchronize), then its stages timed alone the same way, each
    the min of 3: packing and frontiers, the log-prob copy to the card,
    the arc scores and level tensors, the dag_forward launch, and the
    scatter back to arcs with the device-to-host copies."""
    from repro_torch.kernels import lattice_fb as K
    from repro_torch.lattice_engine.common import (arc_scores,
                                                   finalize_loss_only,
                                                   from_level_major)
    from repro_torch.lattice_engine.cuda_backend import dag_level_tensors
    from repro_torch.losses.lattice import batch_lattices, lattice_frontiers
    from repro_torch.serving.packing import pack_log_probs, pad_to_bucket
    spec = sess.spec
    n = K.dag_forward.launches

    def timed(fn):
        best, out = float("inf"), None
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best, out

    whole, _ = timed(lambda: sess.rescore_from_scratch(d, lp))
    t_pack, (lat, fr) = timed(lambda: (lambda lat: (
        lat, lattice_frontiers(lat)))(batch_lattices(
            [pad_to_bucket(d, spec)], device=dev)))
    t_copy, lp_dev = timed(lambda: torch.from_numpy(
        pack_log_probs([lp], spec)).to(dev))
    t_levels, lv = timed(lambda: dag_level_tensors(
        lat, arc_scores(lat, lp_dev, KAPPA) + lat.lm, fr))
    t_kernel, out = timed(lambda: K.dag_forward(*lv, fr.pidx))

    def back():
        A = lat.num_arcs
        alpha = from_level_major(out[0], fr.arc_pos, A, -1e30)
        c_alpha = from_level_major(out[1], fr.arc_pos, A, 0.0)
        fin = finalize_loss_only(lat, alpha, c_alpha)
        return (alpha[0].cpu().numpy(), c_alpha[0].cpu().numpy(),
                fin.logZ.cpu().numpy()[0], fin.c_avg.cpu().numpy()[0])
    t_back, _ = timed(back)
    K.dag_forward.launches = n       # timing launches are not the path's
    split = {"whole_ms": whole, "pack_frontiers_ms": t_pack,
             "log_prob_copy_ms": t_copy, "scores_levels_ms": t_levels,
             "dag_forward_ms": t_kernel, "back_to_host_ms": t_back}
    log(f"one session dispatch (bucket {tuple(spec)}, host clock, min of "
        f"3): {whole:.6g} ms whole; stages alone: "
        + ", ".join(f"{k[:-3]} {v:.6g} ms" for k, v in split.items()
                    if k != "whole_ms")
        + f" (sum {sum(split.values()) - whole:.6g} ms; the log-probs are "
        f"{lp.nbytes / 1e6:.3g} MB from pageable host memory)")
    return split


def dag_times(service: dict, stream: dict, training: dict,
              errs: dict) -> list:
    """The DAG kernels timed at every DAG path's shape: the service
    bucket, the streaming session's, the general-DAG training batch's and
    its CG batch's; each entry's main shape is that of the path its
    launches come from: ``dag_loss_only`` the service, ``dag_forward`` the
    session, ``dag_backward`` (no longer on the session's path) the
    training batch.  Each kernel also alone (``kernel_alone_ms``)."""
    from repro_torch.kernels import lattice_fb as K
    from repro_torch.kernels import ref as R
    rows = []
    rel_errs: dict = {}
    shapes = {"service": service, "session": stream,
              "dag_train": training["dag"], "dag_cg": training["dag_cg"]}
    for where in shapes:
        sh = shapes[where]
        lat, lp = sh["lat"], sh["lp"]
        fwd, bwd, fr = level_inputs(lat, lp)
        lo = loss_only_inputs(lat, lp, fr)
        lo_work = loss_only_work(lat, lp, fr)
        timed = {
            "dag_forward": (lambda: K.dag_forward(*fwd),
                            lambda: R.dag_forward_ref(*fwd),
                            forward_work(fwd)),
            "dag_backward": (lambda: K.dag_backward(*bwd),
                             lambda: R.dag_backward_ref(*bwd),
                             backward_work(bwd)),
            "dag_loss_only": (lambda: K.dag_loss_only(*lo, kappa=KAPPA),
                              lambda: R.dag_loss_only_ref(*lo, kappa=KAPPA),
                              lo_work[:2]),
        }
        for name, (kern, plain, (byt, flops)) in timed.items():
            compare(f"{name}[{where}]", kern(), plain(), errs, rel_errs)
            ms = cuda_time_ms(kern, 20)
            plain_ms = cuda_time_ms(plain, 3)
            b_ms, b_by = bound(byt, flops)
            row = {"name": name, "shape": where,
                   "B_L_W": list(lat.level_arcs.shape),
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "bytes": byt,
                   "kernel_alone_ms": kernel_alone_ms(kern)}
            rows.append(row)
            row["ms_per_level"] = ms / lat.level_arcs.shape[1]  # log only
            log(f"{name} == plain at the {where} shape {row['B_L_W']} "
                f"(max |d| {errs[f'{name}[{where}]']:.3g}, max rel "
                f"{rel_errs[f'{name}[{where}]']:.3g}); time: "
                + ", ".join(f"{k} {v:.6g}" for k, v in row.items()
                            if isinstance(v, float)))
        log(f"dag_loss_only bound of the old cumsum-grid design at the "
            f"{where} shape (every log-prob read; for comparison only): "
            f"{bound(*lo_work[2:])[0]:.6g} ms")
    main = {"dag_loss_only": "service", "dag_forward": "session",
            "dag_backward": "dag_train"}
    launches = {"dag_loss_only": (service["launches"],
                                  service["launches_per_dispatch"],
                                  "service dispatch"),
                "dag_forward": (stream["launches"]["dag_forward"],
                                stream["launches"]["dag_forward"]
                                / stream["dispatches"], "session dispatch"),
                "dag_backward": (training["dag"]["launches"]["dag_backward"],
                                 training["dag"]["launches"]["dag_backward"],
                                 "NGHF update on DAG lattices")}
    out = []
    for name in ("dag_forward", "dag_backward", "dag_loss_only"):
        row = next(r for r in rows
                   if r["name"] == name and r["shape"] == main[name])
        total, per, per_what = launches[name]
        err = max(v for k, v in errs.items() if k.startswith(name + "["))
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": TPU_KERNELS[name], "launches": total,
                 "max_abs_err": err, "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"], "library_ms": None,
                 "launches_per": per, "per": per_what,
                 "shape": f"{main[name]} B,L,W={row['B_L_W']}",
                 "kernel_alone_ms": row["kernel_alone_ms"]}
        for r in rows:             # its other paths' shapes too
            if r["name"] == name and r["shape"] != main[name]:
                entry[f"ms_{r['shape']}"] = r["ms"]
        log(f"{name} by shape: " + ", ".join(
            f"{r['shape']} {r['B_L_W']} {r['ms']:.6g} ms "
            f"({r['ms_per_level']:.6g} ms a level, alone "
            f"{r['kernel_alone_ms']:.6g})"
            for r in rows if r["name"] == name))
        out.append(entry)
    return out


# ---------------------------------------------------------------------------
# training: the sausage kernels, the fused CG update, NGHF on the LSTM
# ---------------------------------------------------------------------------

def sausage_tiles(lat, lp):
    """The sausage kernels' (S, W) inputs for ``lat`` as the CUDA backend
    builds them: (scores, corr, mask)."""
    from repro_torch.lattice_engine.common import arc_scores
    from repro_torch.kernels.ref import gather_sausage_ref
    from repro_torch.lattice_engine.common import NEG
    la = lat.level_arcs
    scores = gather_sausage_ref(arc_scores(lat, lp, KAPPA) + lat.lm, la, NEG)
    corr = gather_sausage_ref(lat.corr.float(), la, 0.0)
    mask = gather_sausage_ref(lat.arc_mask.float(), la, 0.0)
    return scores.contiguous(), corr.contiguous(), mask.contiguous()


def adversarial_tiles(dev, B, S, A, seed, fractional=False):
    """Padded tail segments, a fully masked segment, a fully masked
    utterance and ragged last alternatives; with ``fractional`` (A >= 3)
    masks of 0.3 and 0.7 in the last utterance."""
    from repro_torch.lattice_engine.common import NEG
    gen = torch.Generator(device=dev).manual_seed(seed)
    scores = torch.randn(B, S, A, generator=gen, device=dev) * 3.0
    corr = (torch.rand(B, S, A, generator=gen, device=dev) > 0.6).float()
    mask = torch.ones(B, S, A, device=dev)
    mask[0, S // 2:] = 0.0
    mask[1 % B, 1 % S] = 0.0
    mask[2 % B] = 0.0
    mask[:, :, A - 1] *= (torch.rand(B, S, generator=gen, device=dev)
                          > 0.3).float()
    if fractional:
        # 0.3 and 0.7 on one row: the 0.7 arc is valid and weighs 0.7, the
        # 0.3 arc is masked; a row of 0.3 only is a masked segment
        mask[-1, 1 % S] = torch.tensor([1.0, 0.3, 0.7] + [1.0] * (A - 3),
                                       device=dev)
        mask[-1, 2 % S] = 0.3
    return torch.where(mask > 0, scores, torch.full_like(scores, NEG)), \
        corr, mask


def sausage_lattice(dev, batch, frames, n_alt, seed):
    """Ragged sausages (every other one 8 frames shorter) packed into one
    bucket: padded arcs and padded trailing segments."""
    from repro_torch.losses.lattice import make_sausage_lattice
    from repro_torch.serving import packing
    rng = np.random.default_rng(seed)
    dicts = [make_sausage_lattice(rng, num_frames=frames - 8 * (b % 2),
                                  num_states=NUM_STATES, n_alt=n_alt)
             for b in range(batch)]
    spec = packing.derive_buckets(dicts, batch=batch, tiers=1)[0]
    return packing.pack_requests(dicts, spec, device=dev)[0]


def loss_only_args(lat, lp):
    return (lp, lat.start_t, lat.end_t, lat.label, lat.lm, lat.corr,
            lat.arc_mask, lat.level_arcs)


def span_case(gen, dev, B, T, S, W, *, max_span, float_mask=False):
    """Inputs of ``sausage_loss_only`` (kernel args, plain-version args)
    with adversarial arcs: zero-length spans, spans ending at frame T,
    label K-1, level slots of -1, a fully masked utterance, and masked
    arcs whose labels lie outside [0, K) (the plain version, whose
    gathers would fault on them, gets them clamped: a masked arc never
    reaches the recursion).  Spans up to ``max_span`` frames; with
    ``float_mask`` a float mask of 0 / 0.7 / 1 (0.7 weighs its arc)."""
    A = S * W
    r = lambda *shape: torch.rand(*shape, generator=gen, device=dev)  # noqa
    ri = lambda hi, *shape: torch.randint(  # noqa: E731
        0, hi, shape, generator=gen, device=dev, dtype=torch.int32)
    start = ri(T + 1, B, A)
    span = (r(B, A) ** 2 * (max_span + 1)).to(torch.int32)
    end = torch.minimum(start + span, torch.full_like(start, T))
    end[:, 1::7] = start[:, 1::7]                    # zero-length spans
    end[:, 2::7] = T                                 # arcs ending at T
    if max_span >= T:
        start[:, 3::11], end[:, 3::11] = 0, T        # whole-utterance arcs
    label = ri(NUM_STATES, B, A)
    label[:, ::5] = NUM_STATES - 1                   # the last column
    mask = r(B, A) > 0.15
    mask[B - 1] = False                              # an empty utterance
    bad = ~mask & (r(B, A) > 0.5)
    label_kernel = torch.where(bad, torch.where(
        r(B, A) > 0.5, label + NUM_STATES, -1 - label), label)
    lm = torch.randn(B, A, generator=gen, device=dev)
    corr = (r(B, A) > 0.6).float()
    la = torch.stack([torch.randperm(A, generator=gen, device=dev)
                      for _ in range(B)]).to(torch.int32).reshape(B, S, W)
    la[:, ::3, W - 1] = -1                           # padded slots
    if float_mask:
        mask = torch.where(mask, torch.where(r(B, A) > 0.5, 1.0, 0.7), 0.0)
    lp = torch.randn(B, T, NUM_STATES, generator=gen,
                     device=dev).log_softmax(-1)
    return ((lp, start, end, label_kernel, lm, corr, mask, la),
            (lp, start, end, label, lm, corr, mask, la))


def span_cases(dev, gen) -> dict:
    """tag -> ``span_case`` inputs: the CG batch's shape, T = 1, T = 1000
    with spans up to T (the warp-summed long spans), and 16,000 slots (the
    slots in global memory, not shared)."""
    return {
        "spans_t200": span_case(gen, dev, 8, 200, 50, 3, max_span=12),
        "spans_t1": span_case(gen, dev, 3, 1, 4, 3, max_span=1,
                              float_mask=True),
        "spans_t1000": span_case(gen, dev, 3, 1000, 6, 5, max_span=1000,
                                 float_mask=True),
        "spans_16000_slots": span_case(gen, dev, 2, 1000, 1000, 16,
                                       max_span=40),
    }


def check_loss_only(args, ref_args, errs, rel_errs, tag: str) -> None:
    """sausage_loss_only against its plain version, and bitwise on a
    repeat."""
    from repro_torch.kernels import lattice_fb as K
    from repro_torch.kernels import ref as R
    got = K.sausage_loss_only(*args, kappa=KAPPA)
    compare(f"sausage_loss_only[{tag}]", got,
            R.sausage_loss_only_ref(*ref_args, kappa=KAPPA), errs, rel_errs)
    again = K.sausage_loss_only(*args, kappa=KAPPA)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"sausage_loss_only[{tag}]: two launches gave other bits")


def check_sausage(tiles, errs, rel_errs, tag: str) -> None:
    """sausage_forward and sausage_backward against their plain versions,
    and each bitwise on a repeat launch."""
    from repro_torch.kernels import lattice_fb as K
    from repro_torch.kernels import ref as R
    for kern, plain in ((K.sausage_forward, R.sausage_forward_ref),
                        (K.sausage_backward, R.sausage_backward_ref)):
        got = kern(*tiles)
        compare(f"{kern.__name__}[{tag}]", got, plain(*tiles), errs,
                rel_errs)
        again = kern(*tiles)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{kern.__name__}[{tag}]: two launches gave other bits")


def phase_sausage_kernels(dev, errs: dict) -> None:
    from repro_torch.data.synthetic import asr_batch
    rel_errs: dict = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    frames = TRAIN["frames"]
    for tag, lat in (
            ("train_b32", asr_batch(SEED, batch=32, num_frames=frames,
                                    num_states=NUM_STATES, input_dim=80,
                                    device=dev)["lattice"]),
            ("train_b8", asr_batch(SEED + 1, batch=8, num_frames=frames,
                                   num_states=NUM_STATES, input_dim=80,
                                   device=dev)["lattice"]),
            ("ragged_a40", sausage_lattice(dev, 4, frames, 40, SEED + 2)),
            # the example's batches (T = 32): NGHF's gradient (64) and
            # CG (8) batches, the baselines' (16) and evaluate's (32)
            *((f"example_b{b}", asr_batch(SEED + b, batch=b,
                                          num_frames=EXAMPLE_FRAMES,
                                          num_states=NUM_STATES,
                                          input_dim=80,
                                          device=dev)["lattice"])
              for b in (64, 16, 8, 32))):
        lp = torch.randn(lat.start_t.shape[0], lat.num_frames, NUM_STATES,
                         generator=gen, device=dev).log_softmax(-1)
        check_sausage(sausage_tiles(lat, lp), errs, rel_errs, tag)
        args = loss_only_args(lat, lp)
        check_loss_only(args, args, errs, rel_errs, tag)
        torch.cuda.synchronize()
        log(f"sausage kernels == plain at {tag}: (B, S, W) "
            f"{tuple(lat.level_arcs.shape)}, T={lat.num_frames}, "
            f"K={NUM_STATES}")
    for shape in ((32, 50, 3), (8, 50, 3), (4, 7, 40), (4, 33, 3),
                  (4, 250, 3), (2, 1, 3)):
        tiles = adversarial_tiles(dev, *shape, seed=sum(shape))
        check_sausage(tiles, errs, rel_errs,
                      "masked_" + "x".join(map(str, shape)))
    check_sausage(adversarial_tiles(dev, 4, 9, 3, seed=16, fractional=True),
                  errs, rel_errs, "fractional_4x9x3")
    for tag, (args, ref_args) in span_cases(dev, gen).items():
        check_loss_only(args, ref_args, errs, rel_errs, tag)
        log(f"sausage_loss_only == plain, and bitwise on a repeat, at {tag}: "
            f"(B, T) {tuple(args[0].shape[:2])}, (S, W) "
            f"{tuple(args[7].shape[1:])}, spans up to "
            f"{int((args[2] - args[1]).max())} frames, mask "
            f"{args[6].dtype}")
    torch.cuda.synchronize()
    log("sausage kernels == plain (forward and backward also bitwise on a "
        "repeat) on padded, fully masked segment / utterance, fractional "
        "mask, S = 1, 33, 250 and A=40 tiles; max abs / max rel diff by "
        "case: "
        + ", ".join(f"{k} {v:.3g} / {rel_errs[k]:.3g}"
                    for k, v in sorted(errs.items())
                    if k.startswith("sausage")))
    for n in cg_sizes(dev):
        check_cg_fused(n, gen, dev, errs)
    torch.cuda.empty_cache()


def cg_sizes(dev) -> list:
    """The flat sizes the fused CG update meets on the driver paths: the
    parameter counts of the five *-asr archs and of whisper-base at full
    width."""
    from repro_torch.configs.acoustic import get_acoustic_config
    from repro_torch.models import acoustic
    sizes = set()
    from repro_torch.configs.base import get_config
    from repro_torch.models.registry import get_model
    for arch in ("lstm-asr",) + CLI_ARCHS:
        params = acoustic.init_params(get_acoustic_config(arch), 0,
                                      device=dev)
        sizes.add(acoustic.param_count(params))
        del params
    sizes.add(get_model(get_config(LM_TRAIN_ARCH)).param_count())
    check(LSTM_PARAMS in sizes and LM_TRAIN_PARAMS in sizes,
          f"parameter counts {sorted(sizes)}")
    return sorted(sizes)


def check_cg_fused(n: int, gen, dev, errs: dict) -> None:
    """cg_fused_update against its plain version at length ``n``, f32 and
    bf16: x and r bitwise, rr within RR_RTOL; bitwise on a repeat."""
    from repro_torch.kernels import cg_fused as CG
    from repro_torch.kernels import ref as R
    for dtype in (torch.float32, torch.bfloat16):
        x, v, r, bv = (torch.randn(n, generator=gen, device=dev).to(dtype)
                       for _ in range(4))
        alpha = torch.tensor(0.37, device=dev)
        got = CG.cg_fused_update(alpha, x, v, r, bv)
        want = R.cg_fused_update_ref(alpha, x, v, r, bv)
        again = CG.cg_fused_update(alpha, x, v, r, bv)
        for name, g, w in (("x", got[0], want[0]), ("r", got[1], want[1])):
            check(g.dtype == dtype and torch.equal(g, w),
                  f"cg_fused_update N={n} {dtype} {name}: not the plain "
                  f"version's bits (max |d| "
                  f"{float((g.float() - w.float()).abs().max()):.3g})")
        d_rr = abs(float(got[2]) - float(want[2]))
        check(d_rr <= RR_RTOL * float(want[2]),
              f"cg_fused_update N={n} {dtype} rr {float(got[2])} vs plain "
              f"{float(want[2])}")
        check(torch.equal(got[2], again[2]) and torch.equal(got[0],
                                                            again[0]),
              f"cg_fused_update N={n} {dtype}: two launches gave other "
              f"bits")
        key = f"cg_fused_update[{str(dtype)[6:]}]"
        errs[key] = max(errs.get(key, 0.0), d_rr)
        log(f"cg_fused_update == plain at N={n} {dtype}: x, r bitwise, "
            f"rr |d| {d_rr:.3g} of {float(want[2]):.6g}; a repeat launch "
            f"bitwise")
        del x, v, r, bv, got, want, again


def reset_counts() -> None:
    from repro_torch.kernels import cg_fused as CG
    from repro_torch.kernels import lattice_fb as K
    from repro_torch.kernels import swa_attention as SWA
    K.reset_launch_counts()
    CG.reset_launch_counts()
    SWA.reset_launch_counts()


def read_counts() -> dict:
    from repro_torch.kernels import cg_fused as CG
    from repro_torch.kernels import lattice_fb as K
    return {fn.__name__: fn.launches for fn in K.KERNELS + CG.KERNELS}


def delta_rel_l2(new_a: dict, new_b: dict, base: dict) -> float:
    num = sum(float(((new_a[k] - new_b[k]) ** 2).sum()) for k in base)
    den = sum(float(((new_b[k] - base[k]) ** 2).sum()) for k in base)
    return (num / max(den, 1e-30)) ** 0.5


def dag_asr_batch(seed: int, n: int, frames: int, input_dim: int, dev):
    """An ``asr_batch`` twin on random general-DAG lattices (packed into
    one bucket), features from the same class embeddings + noise."""
    from repro_torch.losses.lattice import make_random_dag_lattice
    from repro_torch.serving import packing
    rng = np.random.default_rng(seed)
    dicts = [make_random_dag_lattice(rng, num_frames=frames,
                                     num_states=NUM_STATES)
             for _ in range(n)]
    spec = packing.derive_buckets(dicts, batch=n, tiers=1)[0]
    lat, _ = packing.pack_requests(dicts, spec, device=dev)
    emb = np.random.default_rng(777).normal(
        size=(NUM_STATES, input_dim)).astype(np.float32)
    feats = emb[lat.ref_states.cpu().numpy()] + rng.normal(
        scale=1.2, size=(n, frames, input_dim)).astype(np.float32)
    return {"feats": torch.from_numpy(feats).to(dev),
            "labels": lat.ref_states, "lattice": lat}


def one_update(acfg, params, gb, cb, counts, backend, fused, mesh=None,
               **overrides):
    """One NGHF update from ``params`` through the optimiser's ``step``
    (all metrics, the CG histories included), on ``mesh`` (the state
    replicated) or one device; (new params, metrics as floats / lists,
    seconds)."""
    from repro_torch.launch.sharding import replicated_shardings
    from repro_torch.launch.steps import build_sequence_step
    ss = None if mesh is None else replicated_shardings(mesh, params)
    _, opt = build_sequence_step(
        acfg, "nghf", loss="mpe", kappa=KAPPA, backend=backend, mesh=mesh,
        state_sharding=ss, share_counts=counts, cg_iters=TRAIN["cg_iters"],
        ng_iters=TRAIN["ng_iters"], cg_fused=fused, **overrides)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, _, m = opt.step(params, opt.init(params, state_sharding=ss), gb, cb)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return new, {k: (v.tolist() if torch.is_tensor(v) else float(v))
                 for k, v in m.items()}, dt


def check_update(tag: str, m: dict) -> None:
    check(all(np.isfinite(v) for v in m.values()
              if isinstance(v, float)), f"{tag}: non-finite metrics {m}")
    if m["cg_accepted"]:
        check(m["cg_best_loss"] < m["cg_base_loss"],
              f"{tag}: accepted candidate {m['cg_best_loss']} not below "
              f"the Δθ=0 baseline {m['cg_base_loss']}")


def same_choice(tag: str, m_k: dict, m_p: dict) -> str:
    """The kernel and the plain path make the same decision.

    Acceptance must agree (the log prints the margin between the best
    candidate and the Δθ=0 baseline beside the paths' disagreement).
    The best iterate must agree too — unless the two picks tie within
    the paths' disagreement: far from the optimum the candidates' lattice
    posteriors saturate, the MPE loss then moves in steps of one arc's
    correctness, and an argmin between candidates a step or two apart is
    decided by f32 noise (the plain path's autograd also scatters with
    atomics, so it varies between runs).  Returns the log text."""
    i_k, i_p = int(m_k["cg_best_iter"]), int(m_p["cg_best_iter"])
    l_k, l_p = m_k["cg_losses"], m_p["cg_losses"]
    both = [j for j in range(len(l_k))
            if np.isfinite(l_k[j]) and np.isfinite(l_p[j])]
    spread = max((abs(l_k[j] - l_p[j]) for j in both), default=0.0)
    check(m_k["cg_accepted"] == m_p["cg_accepted"],
          f"{tag}: accepted {m_k['cg_accepted']} vs {m_p['cg_accepted']}")
    margin = min(abs(m["cg_best_loss"] - m.get("cg_base_loss", np.nan))
                 for m in (m_k, m_p))
    tie = i_k == i_p or (
        i_k in both and i_p in both
        and abs(l_k[i_k] - l_k[i_p]) <= 2 * spread
        and abs(l_p[i_k] - l_p[i_p]) <= 2 * spread)
    check(tie, f"{tag}: best iterate {i_k} (kernel path) vs {i_p} (plain "
          f"path); losses kernel {l_k}, plain {l_p}")
    return (f"best iterate {i_k} vs {i_p}"
            + ("" if i_k == i_p else " (a tie within the paths' spread)")
            + f", accepted {bool(m_k['cg_accepted'])} (best-to-baseline "
            f"margin {margin:.3g}); candidate losses kernel "
            f"{[round(x, 7) for x in l_k]}, plain "
            f"{[round(x, 7) for x in l_p]} (max spread {spread:.3g}, "
            f"baseline {m_k.get('cg_base_loss', float('nan')):.7f}); "
            f"vᵀBv per outer iteration {['%.3g' % c for c in m_k['cg_curv']]}"
            f", |Δθ| {m_k['update_norm']:.4g}")


def compare_paths(tag: str, acfg, params, gb, cb, counts) -> tuple:
    """The kernel path (``backend="auto"``, fused CG) against the plain
    path (``backend="levelized"``, unfused): the same decision
    (``same_choice``), and — without candidate selection, so that the
    returned step is the last CG iterate on both paths whatever an
    argmin or a rejection does — Δθ within ``DELTA_REL_L2``.  Returns
    the kernel path's {"metrics", "last" (its last-iterate parameters),
    "s" (its update's seconds)}."""
    _, m_k, t_k = one_update(acfg, params, gb, cb, counts, "auto", True)
    _, m_p, t_p = one_update(acfg, params, gb, cb, counts, "levelized",
                             False)
    text = same_choice(tag, m_k, m_p)
    new_k, m_n, _ = one_update(acfg, params, gb, cb, counts, "auto", True,
                               eval_candidates=False)
    new_p, _, _ = one_update(acfg, params, gb, cb, counts, "levelized",
                             False, eval_candidates=False)
    rel = delta_rel_l2(new_k, new_p, params)
    check(rel <= DELTA_REL_L2, f"{tag}: last-iterate Δθ kernel vs plain "
          f"path rel-L2 {rel:.3g}")
    # the plain path's own run-to-run spread, for scale
    new_p2, _, _ = one_update(acfg, params, gb, cb, counts, "levelized",
                              False, eval_candidates=False)
    rel_pp = delta_rel_l2(new_p2, new_p, params)
    log(f"{tag}: kernel path == plain path (levelized, unfused): {text}; "
        f"last-iterate Δθ rel-L2 {rel:.3g} (limit {DELTA_REL_L2}; the "
        f"plain path against its own repeat {rel_pp:.3g}; last-iterate "
        f"|Δθ| {m_n['update_norm']:.4g}); update {t_k * 1e3:.3f} ms vs "
        f"plain {t_p * 1e3:.3f} ms (untimed)")
    return {"metrics": m_k, "last": new_k, "s": t_k}


def phase_training(dev) -> dict:
    from repro_torch.configs.acoustic import get_acoustic_config
    from repro_torch.core.timing import StageTimer
    from repro_torch.data.synthetic import EpochPlan, asr_batch
    from repro_torch.lattice_engine import lattice_is_sausage
    from repro_torch.launch.train import train_sequence
    from repro_torch.models import acoustic
    acfg = get_acoustic_config(TRAIN["arch"])
    params0 = acoustic.init_params(acfg, SEED, device=dev)
    n_params = acoustic.param_count(params0)
    check(n_params == LSTM_PARAMS, f"LSTM has {n_params} parameters")
    timer = StageTimer(dev)
    reset_counts()
    t0 = time.perf_counter()
    _, logs = train_sequence(**TRAIN, init_params=params0, device=dev,
                             timer=timer, verbose=False)
    wall = time.perf_counter() - t0
    launches = read_counts()
    steps = TRAIN["steps"]
    for m in logs:
        check_update(f"update {m['step']}", m)
    evals = sum(int(m["cg_evaluated"]) + 1 for m in logs)
    want = {"sausage_forward": PER_UPDATE["forward"] * steps,
            "sausage_backward": PER_UPDATE["backward"] * steps,
            "sausage_loss_only": evals,
            "cg_fused_update": PER_UPDATE["cg"] * steps,
            "dag_forward": 0, "dag_backward": 0, "dag_loss_only": 0}
    check(launches == want, f"training launches {launches} != {want}")
    check(logs[-1]["mpe_acc"] > 0.0, "training: MPE accuracy is zero")
    for m in logs:
        stages = {k[6:-2]: v for k, v in m.items() if k.startswith("stage_")}
        rest = m["time_s"] - sum(stages.values())
        log(f"NGHF update {m['step']}: {m['time_s'] * 1e3:.3f} ms "
            + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in stages.items())
            + f", CG vector work and the rest {rest * 1e3:.3f} ms; "
            f"mpe_acc {m['mpe_acc']:.6f} loss {m['loss']:.6f} "
            f"best_iter {m['cg_best_iter']:.0f} accepted "
            f"{bool(m['cg_accepted'])} best {m['cg_best_loss']:.6f} "
            f"base {m['cg_base_loss']:.6f} host syncs "
            f"{m['cg_host_syncs']:.0f}; candidates evaluated "
            f"{m['cg_evaluated']:.0f} of {TRAIN['cg_iters']}, iterations "
            f"frozen by vᵀBv <= 0: {m['cg_negative_curvature']:.0f}")
    log(f"training: {steps} NGHF updates of the {LSTM_PARAMS}-parameter "
        f"LSTM in {wall:.3f} s; launches {launches} (per update: forward "
        f"{PER_UPDATE['forward']}, backward {PER_UPDATE['backward']}, "
        f"cg {PER_UPDATE['cg']}, loss-only = evaluated candidates + 1)")

    # the kernel path against the plain path, update 0's batches
    plan = EpochPlan(num_updates_per_epoch=steps, base_seed=SEED)
    kw = dict(num_frames=TRAIN["frames"], num_states=acfg.num_outputs,
              input_dim=acfg.input_dim, noise=1.2, device=dev)
    gb = asr_batch(plan.grad_seed(0, 0), batch=TRAIN["batch"], **kw)
    cb = asr_batch(plan.cg_seed(0, 0), batch=TRAIN["cg_batch"], **kw)
    counts = acoustic.share_counts(acfg, params0)
    kernel_path = compare_paths("update 0", acfg, params0, gb, cb, counts)

    # NGHF on general-DAG lattices: the DAG kernels under training
    dgb = dag_asr_batch(SEED + 7, 8, 100, acfg.input_dim, dev)
    dcb = dag_asr_batch(SEED + 8, 4, 100, acfg.input_dim, dev)
    check(not lattice_is_sausage(dgb["lattice"]),
          "the DAG training batch is a sausage")
    reset_counts()
    _, m_d, t_d = one_update(acfg, params0, dgb, dcb, counts, "auto", True)
    dag_launches = read_counts()
    check_update("DAG update", m_d)
    want = {"dag_forward": PER_UPDATE["forward"],
            "dag_backward": PER_UPDATE["backward"],
            "dag_loss_only": int(m_d["cg_evaluated"]) + 1,
            "cg_fused_update": PER_UPDATE["cg"],
            "sausage_forward": 0, "sausage_backward": 0,
            "sausage_loss_only": 0}
    check(dag_launches == want, f"DAG training launches {dag_launches} != "
          f"{want}")
    log(f"NGHF update on random-DAG lattices (B=8, T=100, bucket "
        f"{tuple(dgb['lattice'].level_arcs.shape)}): {t_d * 1e3:.3f} ms, "
        f"launches {dag_launches}")
    compare_paths("DAG update", acfg, params0, dgb, dcb, counts)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)

    def shape(lat):
        return {"lat": lat, "lp": torch.randn(
            lat.start_t.shape[0], 100, NUM_STATES, generator=gen,
            device=dev).log_softmax(-1)}
    return {"logs": logs, "launches": launches, "gb": gb, "cb": cb,
            "device": dev, "kernel_path": kernel_path,
            "dag": {"launches": dag_launches, **shape(dgb["lattice"])},
            "dag_cg": shape(dcb["lattice"])}


def sausage_work(tiles, backward: bool) -> tuple:
    """(bytes, flops) of the sausage statistics: scores, corr, mask read
    once, alpha/c_alpha (or beta/c_beta) written once, logZ/c_avg for
    the forward; per arc a max, an exp, a log share and a few adds."""
    scores = tiles[0]
    n = scores.numel()
    B = scores.shape[0]
    byt = 4 * 3 * n + 4 * 2 * n + (0 if backward else 8 * B)
    return byt, 12 * n


def loss_only_span_work(args) -> tuple:
    """(bytes, flops) the function must move / do on these inputs, then
    the same for the cumsum-grid design it replaced.  Now: the log-probs
    under the valid arcs' spans, the mask of every arc a slot names,
    start/end/label/lm/corr of the valid ones, level_arcs, two (B,)
    outputs; an add per frame and the recursion's ~12 operations a slot.
    The grid design read every log-prob (its cumsum needs all of them)."""
    lp, start, end, _, _, _, mask, la = args
    B, T, _ = lp.shape
    A = start.shape[1]
    ids = la.long().flatten(1)
    named = (ids >= 0) & (ids < A)
    safe = ids.clamp(0, max(A - 1, 0))
    valid = named & (mask.float().gather(1, safe) > 0.5)
    span = (end.clamp(0, T) - start.clamp(0, T)).abs().gather(1, safe)
    frames = int((span * valid).sum())
    n_named, n_valid = int(named.sum()), int(valid.sum())
    byt = (4 * frames + mask.element_size() * n_named + 20 * n_valid
           + 4 * la.numel() + 8 * B)
    grid_byt = (4 * lp.numel() + B * A * (4 * 5 + 1) + 4 * la.numel()
                + 8 * B)
    return (byt, frames + 2 * n_valid + 12 * la.numel(),
            grid_byt, 4 * lp.numel() + 12 * la.numel())


def kernel_alone_ms(fn, reps: int = 5) -> float:
    """One call of ``fn`` between two events queued behind a sleeping
    kernel, so that the host's enqueue cost is hidden: the device time of
    its launches alone (min over ``reps``)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return min(times)


def train_times(training: dict, errs: dict) -> list:
    from repro_torch.data.synthetic import asr_batch
    from repro_torch.kernels import cg_fused as CG
    from repro_torch.kernels import lattice_fb as K
    from repro_torch.kernels import ref as R
    rel_errs: dict = {}
    dev = training["device"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    gb, cb = training["gb"], training["cb"]
    frames = TRAIN["frames"]
    lat_g, lat_c = gb["lattice"], cb["lattice"]
    lp_g = torch.randn(lat_g.start_t.shape[0], frames, NUM_STATES,
                       generator=gen, device=dev).log_softmax(-1)
    lp_c = torch.randn(lat_c.start_t.shape[0], frames, NUM_STATES,
                       generator=gen, device=dev).log_softmax(-1)
    tiles = sausage_tiles(lat_g, lp_g)
    args = loss_only_args(lat_c, lp_c)
    x, v, r, bv = (torch.randn(LSTM_PARAMS, generator=gen, device=dev)
                   for _ in range(4))
    alpha = torch.tensor(0.37, device=dev)
    B_c = lat_c.start_t.shape[0]
    timed = {
        "sausage_forward": (lambda: K.sausage_forward(*tiles),
                            lambda: R.sausage_forward_ref(*tiles),
                            sausage_work(tiles, False),
                            f"gradient batch (B,S,W)="
                            f"{tuple(tiles[0].shape)}"),
        "sausage_backward": (lambda: K.sausage_backward(*tiles),
                             lambda: R.sausage_backward_ref(*tiles),
                             sausage_work(tiles, True),
                             f"gradient batch (B,S,W)="
                             f"{tuple(tiles[0].shape)}"),
        "sausage_loss_only": (lambda: K.sausage_loss_only(*args,
                                                          kappa=KAPPA),
                              lambda: R.sausage_loss_only_ref(*args,
                                                              kappa=KAPPA),
                              loss_only_span_work(args)[:2],
                              f"CG batch B={B_c}, T={frames}, "
                              f"K={NUM_STATES}, (S,W)="
                              f"{tuple(lat_c.level_arcs.shape[1:])}"),
        "cg_fused_update": (lambda: CG.cg_fused_update(alpha, x, v, r, bv),
                            lambda: R.cg_fused_update_ref(alpha, x, v, r,
                                                          bv),
                            (6 * 4 * LSTM_PARAMS, 6 * LSTM_PARAMS),
                            f"N={LSTM_PARAMS} f32"),
    }
    per_update = {"sausage_forward": PER_UPDATE["forward"],
                  "sausage_backward": PER_UPDATE["backward"],
                  "cg_fused_update": PER_UPDATE["cg"]}
    out = []
    for name, (kern, plain, (byt, flops), shape) in timed.items():
        compare(f"{name}[timed]", kern(), plain(), errs, rel_errs)
        ms = cuda_time_ms(kern, 20)
        plain_ms = cuda_time_ms(plain, 3)
        b_ms, b_by = bound(byt, flops)
        total = training["launches"][name]
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": TPU_KERNELS[name], "launches": total,
                 "max_abs_err": max(v for k, v in errs.items()
                                    if k.startswith(name + "[")),
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": None,
                 "launches_per": per_update.get(
                     name, total / TRAIN["steps"]),
                 "per": "NGHF update", "shape": shape}
        # the kernel alone, one launch between events behind a busy stream
        # (no host time in it)
        entry["kernel_alone_ms"] = kernel_alone_ms(kern)
        out.append(entry)
        log(f"{name} timed at {shape}: "
            + ", ".join(f"{k} {v:.6g}" for k, v in entry.items()
                        if isinstance(v, float)))
        if name == "sausage_loss_only":
            log(f"sausage_loss_only bound of the old cumsum-grid design "
                f"at {shape} (every log-prob read; for comparison only): "
                f"{bound(*loss_only_span_work(args)[2:])[0]:.6g} ms")
    # the sausage pair at S = 250 (T = 1000 sausages, the gradient batch)
    lat_l = asr_batch(SEED + 12, batch=32, num_frames=1000,
                      num_states=NUM_STATES, input_dim=80,
                      device=dev)["lattice"]
    lp_l = torch.randn(32, 1000, NUM_STATES, generator=gen,
                       device=dev).log_softmax(-1)
    tiles_l = sausage_tiles(lat_l, lp_l)
    del lp_l
    for kern, plain, backward in (
            (K.sausage_forward, R.sausage_forward_ref, False),
            (K.sausage_backward, R.sausage_backward_ref, True)):
        name = kern.__name__
        compare(f"{name}[timed_s250]", kern(*tiles_l), plain(*tiles_l),
                errs, rel_errs)
        b_ms, b_by = bound(*sausage_work(tiles_l, backward))
        log(f"{name} timed at (B,S,W)={tuple(tiles_l[0].shape)} (T=1000): "
            f"ms {cuda_time_ms(lambda: kern(*tiles_l), 20):.6g}, "
            f"kernel_alone_ms {kernel_alone_ms(lambda: kern(*tiles_l)):.6g}, "
            f"plain_ms {cuda_time_ms(lambda: plain(*tiles_l), 3):.6g}, "
            f"bound_ms {b_ms:.6g} ({b_by})")
    return out


# ---------------------------------------------------------------------------
# the training CLI, checkpoints and the paper's example
# ---------------------------------------------------------------------------

# the CLI at the training phase's widths and length, every *-asr arch;
# the RNNs and TDNNs with the Sec. 4.3 preconditioner for shared
# parameters (share counts), the LSTM with warm start and adaptive λ so
# that its checkpoint carries Δθ and λ
CLI_ARGS = ["--optimizer", "nghf", "--loss", "mpe", "--frames", "200",
               "--batch", "32", "--cg-batch", "8", "--cg-iters", "6",
               "--ng-iters", "2", "--cg-fused", "--device", "cuda"]
CLI_ARCHS = ("rnn-asr", "rnn-relu-asr", "tdnn-asr", "tdnn-relu-asr")
# NGHF updates of the example's pipeline on the full-width LSTM (SGD and
# Adam take 20x as many); its frames and batches are the example's, its
# updates cut from 8 to 4 to keep the script in its time
EXAMPLE_UPDATES = 4
EXAMPLE_FRAMES = 32
# held-out batches the example evaluates: 4 after each of its 4 stages,
# each one pass of the sausage statistics (forward and backward)
EXAMPLE_EVAL_BATCHES = 4 * 4


def update_text(m: dict) -> str:
    return (f"{m['time_s'] * 1e3:.3f} ms; mpe_acc {m['mpe_acc']:.6f} "
            f"accepted {bool(m['cg_accepted'])} best iterate "
            f"{m['cg_best_iter']:.0f} (best {m['cg_best_loss']:.6f}, "
            f"Δθ=0 {m['cg_base_loss']:.6f}), outer CG vᵀBv "
            f"{m['cg_curv_first']:.4g} -> {m['cg_curv_last']:.4g}, |Δθ| "
            f"{m['update_norm']:.4g}, grad norm {m['grad_norm']:.4g}, "
            f"logZ {m['logZ']:.4g}, candidates with a finite loss "
            f"{m['cg_evaluated']:.0f}")


def check_cli_updates(tag: str, log_: list, launches: dict,
                      want_per_update: dict, extra_stats: int = 0) -> None:
    """Log each update of ``log_``, then check: finite metrics, accepted
    updates below their baseline, the exact launches of the sausage
    statistics and fused CG kernels (``extra_stats`` statistics passes
    made outside the updates), and the loss-only kernel's between the
    candidates with a finite loss plus the baselines and one a CG
    iterate plus the baselines (an iterate frozen by vᵀBv <= 0 is not
    evaluated; one whose loss overflows is evaluated and not counted in
    ``cg_evaluated``)."""
    for m in log_:
        log(f"{tag} update {m['step']}: {update_text(m)}")
    log(f"{tag}: launches {launches} (per update: {want_per_update}, "
        f"{extra_stats} statistics passes besides)")
    for m in log_:
        check_update(f"{tag} update {m['step']}", m)
    n = len(log_)
    lo = sum(int(m["cg_evaluated"]) + 1 for m in log_)
    got = dict(launches)
    loss_only = got.pop("sausage_loss_only")
    want = {"sausage_forward": want_per_update["forward"] * n + extra_stats,
            "sausage_backward": want_per_update["backward"] * n
            + extra_stats,
            "cg_fused_update": want_per_update["cg"] * n,
            "dag_forward": 0, "dag_backward": 0, "dag_loss_only": 0}
    check(got == want and lo <= loss_only
          <= want_per_update["loss_only_max"] * n,
          f"{tag}: launches {launches}, want {want} and sausage_loss_only "
          f"in [{lo}, {want_per_update['loss_only_max'] * n}]")


def same_state(a, b) -> bool:
    """Two train-state trees equal bitwise, on the same device."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_state(a[k], b[k])
                                            for k in a)
    return a.dtype == b.dtype and a.device == b.device \
        and torch.equal(a, b)


def load_and_compare(tag: str, ck: str, params, opt_state,
                     step_want: int) -> float:
    """Load the train state at ``ck`` into the structure of ``(params,
    opt_state)``; it must equal them bitwise, on the card.  Returns the
    load's seconds."""
    from repro_torch.checkpoint.io import load_train_state
    t0 = time.perf_counter()
    p, st, step = load_train_state(ck, params, opt_state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(step == step_want and same_state(p, params)
          and same_state(st, opt_state),
          f"{tag}: the loaded train state differs from the saved one")
    return dt


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def ckpt_mb(ck: str) -> float:
    return sum(os.path.getsize(os.path.join(ck, f))
               for f in os.listdir(ck)) / 1e6


def phase_example(dev) -> dict:
    """Phase 8, part 1: the paper's example (CE -> NGHF vs SGD/Adam) on
    the full-width LSTM, with its frames and batches."""
    from repro_torch.configs.acoustic import get_acoustic_config
    from repro_torch.examples.train_asr_mpe import FRAMES, run_pipeline
    check(FRAMES == EXAMPLE_FRAMES, f"example: T = {FRAMES}")
    reset_counts()
    t0 = time.perf_counter()
    ex = run_pipeline(get_acoustic_config("lstm-asr"),
                      updates=EXAMPLE_UPDATES, device=dev, verbose=False)
    wall = time.perf_counter() - t0
    launches = read_counts()
    rows = ex["rows"]
    log(f"example (full-width LSTM, T = {EXAMPLE_FRAMES}, "
        f"{EXAMPLE_UPDATES} NGHF updates) in {wall:.3f} s; table: "
        + "; ".join(f"{k} {r['updates']} updates, MPE acc {r['acc']:.6f}, "
                    f"{r['wall_s']:.3f} s" for k, r in rows.items()))
    # NGHF without warm start, adaptive λ or the fused CG; besides its
    # updates, one statistics pass per SGD and Adam step and per held-out
    # batch (CE training runs no lattice)
    check_cli_updates("example NGHF", ex["nghf_log"], launches,
                      dict(launches_per_update(6, 2), cg=0),
                      extra_stats=2 * 20 * EXAMPLE_UPDATES
                      + EXAMPLE_EVAL_BATCHES)
    check(list(rows) == ["CE", "NGHF", "SGD", "Adam"]
          and all(np.isfinite(r["acc"]) for r in rows.values()),
          f"example: table {rows}")
    return ex


def phase_cli(dev) -> dict:
    """Phase 8: the paper's example on the full-width LSTM; the training
    CLI ``launch.train.main`` for every *-asr arch, the LSTM resumed from
    the example's CE model (a params-only checkpoint, the reference's
    legacy format), checkpointed and resumed again.  (A random start
    with warm start and adaptive λ diverges, in the reference as in the
    port: ``tests/test_torch_ce_start.py``; ROADMAP §3.2.)"""
    import logging
    import shutil
    import tempfile
    from repro_torch.checkpoint.io import save_checkpoint
    from repro_torch.launch import train as T

    ex = phase_example(dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    ck = os.path.join(tmp, "ck")
    saved = []
    real_save = T.save_train_state

    def save_and_keep(ckpt_dir, params, opt_state, *, step=0, extra=None,
                      **shardings):
        # keep what train_sequence held when it saved, cloned on the card
        kept = (step, clone_tree(params), clone_tree(opt_state))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_save(ckpt_dir, params, opt_state, step=step, extra=extra,
                  **shardings)
        saved.append(kept + (time.perf_counter() - t0,))

    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("[chip_smoke] checkpoint: "
                                           "%(message)s"))
    ck_log = logging.getLogger("repro_torch.checkpoint.io")
    ck_log.addHandler(handler)
    ck_log.setLevel(logging.INFO)
    T.save_train_state = save_and_keep
    out = {"example": ex, "archs": {}}
    try:
        # the LSTM from the CE model: 2 updates, checkpoint, resume to 3
        save_checkpoint(ck, ex["ce_params"], step=0)
        lstm_args = ["--arch", "lstm-asr", *CLI_ARGS, "--warm-start",
                     "--adapt-lam", "--ckpt-dir", ck, "--resume"]
        want = launches_per_update(6, 2, warm_start=True, adapt_lam=True)
        reset_counts()
        log2 = T.main(lstm_args + ["--steps", "2"])
        check_cli_updates("CLI lstm-asr from the CE model", log2,
                       read_counts(), want)
        check([m["step"] for m in log2] == [0, 1] and saved[-1][0] == 2,
              f"CLI lstm-asr: steps {[m['step'] for m in log2]}, "
              f"saved at {[s[0] for s in saved]}")
        _, params, opt_state, t_save = saved[-1]
        t_load = load_and_compare("CLI lstm-asr", ck, params, opt_state,
                                  2)
        log(f"CLI lstm-asr checkpoint at step 2 (params, Δθ, λ, "
            f"step; {ckpt_mb(ck):.3f} MB on disk): save "
            f"{t_save * 1e3:.3f} ms, load {t_load * 1e3:.3f} ms (host "
            f"clock, from and to the card); loaded == saved bitwise")
        reset_counts()
        log3 = T.main(lstm_args + ["--steps", "3"])
        check_cli_updates("CLI lstm-asr resumed", log3, read_counts(),
                       want)
        check([m["step"] for m in log3] == [2],
              f"CLI lstm-asr resume: steps {[m['step'] for m in log3]}")
        _, params, opt_state, _ = saved[-1]
        load_and_compare("CLI lstm-asr at step 3", ck, params, opt_state,
                         3)
        out["archs"]["lstm-asr"] = log2 + log3
        # the Adam train state of the same model (params, m, v, step)
        adam = {"m": {k: v * 0.5 for k, v in params.items()},
                "v": {k: v * v for k, v in params.items()},
                "step": torch.tensor(7, dtype=torch.int32, device=dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_save(ck, params, adam, step=1)
        t_save = time.perf_counter() - t0
        t_load = load_and_compare("Adam", ck, params, adam, 1)
        log(f"Adam train state (params, m, v, step; {ckpt_mb(ck):.3f} MB "
            f"on disk): save {t_save * 1e3:.3f} ms, load "
            f"{t_load * 1e3:.3f} ms; loaded == saved bitwise")
    finally:
        T.save_train_state = real_save
        ck_log.removeHandler(handler)
        shutil.rmtree(tmp, ignore_errors=True)

    # one update of each other arch through the CLI, from a random start;
    # run twice (the same seeds, so the same update), and the second run
    # timed: the first carries the arch's first-call costs
    want = launches_per_update(6, 2)
    for arch in CLI_ARCHS:
        runs = []
        for _ in range(2):
            reset_counts()
            runs.append(T.main(["--arch", arch, *CLI_ARGS, "--steps", "1",
                                "--preconditioner", "share_counts"]))
            check_cli_updates(f"CLI {arch} (share_counts), run "
                              f"{len(runs)}", runs[-1], read_counts(), want)
        # (not compared: training on the card is not bitwise reproducible)
        log(f"CLI {arch}: update time {runs[0][0]['time_s'] * 1e3:.3f} ms "
            f"first run, {runs[1][0]['time_s'] * 1e3:.3f} ms second run; "
            f"accepted {[bool(r[0]['cg_accepted']) for r in runs]}")
        out["archs"][arch] = runs[1]
    return out


# ---------------------------------------------------------------------------
# LM training: whisper-base at full width and depth
# ---------------------------------------------------------------------------

# whisper-base (6 + 6 layers, d 512, vocab 51865) trained by NGHF through
# the CLI with the fused CG kernel.  train_4k's shape (T 4096, B 256) is
# cut to what one card holds: T = 448, whisper's own text context, and
# B = 16 (the CG batch is B / 4 = 4, the CLI's cg_frac); every encoder
# input is 1500 frames.
LM_TRAIN_ARCH = "whisper-base"
LM_TRAIN_PARAMS = 130_737_152
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 16, 448
LM_CG_ITERS, LM_NG_ITERS = 8, 4
LM_TRAIN_ARGS = ["--arch", LM_TRAIN_ARCH, "--optimizer", "nghf",
                 "--batch", str(LM_TRAIN_BATCH), "--seq", str(LM_TRAIN_SEQ),
                 "--cg-iters", str(LM_CG_ITERS), "--ng-iters",
                 str(LM_NG_ITERS), "--cg-fused", "--device", "cuda"]
# kernel path vs plain path, one update from the same parameters without
# candidate selection: the last CG iterate's Δθ, relative L2.  The two
# paths run the same products and differ in the CG vector work: x and r
# are the same bits (phase 2), ⟨r, r⟩ sums in another order (about 1e-7
# relative).  The products run on bf16 activations, so a last-bit change
# of a direction flips bf16 roundings and moves Bv by about the bf16
# step (2^-8); 12 products carry that into Δθ (measured 0.0047 on the
# H100, while the plain path repeats its own bits).  The bound is phase
# 5's, set the same way; the CPU parity tests reach 1.3e-6 at smoke
# size and f32.
LM_DELTA_REL_L2 = 2e-2
# greedy decode at f32 compute against forward's logits (relative max)
LM_DECODE_STEPS, LM_DECODE_BATCH = 16, 2


def lm_update_text(m: dict) -> str:
    return (f"{m['time_s'] * 1e3:.3f} ms; ce {m['ce']:.6f} acc "
            f"{m['acc']:.6f}, accepted {bool(m['cg_accepted'])} best "
            f"iterate {m['cg_best_iter']:.0f} (best {m['cg_best_loss']:.6f},"
            f" Δθ=0 {m['cg_base_loss']:.6f}), outer CG vᵀBv "
            f"{m['cg_curv_first']:.4g} -> {m['cg_curv_last']:.4g}, |Δθ| "
            f"{m['update_norm']:.4g}, grad norm {m['grad_norm']:.4g}, "
            f"candidates with a finite loss {m['cg_evaluated']:.0f}, host "
            f"syncs {m['cg_host_syncs']:.0f}")


def swa_counts() -> tuple:
    from repro_torch.kernels import swa_attention as SWA
    return SWA.swa_attention.launches, SWA.swa_attention.cuda_core_launches


def check_lm_updates(tag: str, log_: list, launches: dict, swa: tuple,
                     steps: list, per_update: int) -> None:
    """Log each update; finite metrics, accepted updates below their
    Δθ=0 baseline, the logged steps, and exactly ``per_update``
    ``cg_fused_update`` launches an update and no other kernel's."""
    for m in log_:
        log(f"{tag} update {m['step']}: "
            + (lm_update_text(m) if "cg_curv_first" in m else
               f"{m['time_s'] * 1e3:.3f} ms; ce {m['ce']:.6f} acc "
               f"{m['acc']:.6f}, grad norm {m['grad_norm']:.4g}"))
    check([m["step"] for m in log_] == steps,
          f"{tag}: steps {[m['step'] for m in log_]}, want {steps}")
    for m in log_:
        if "cg_accepted" in m:
            check_update(f"{tag} update {m['step']}", m)
        check(all(np.isfinite(v) for v in m.values()),
              f"{tag} update {m['step']}: non-finite metrics {m}")
    want = {k: 0 for k in launches}
    want["cg_fused_update"] = per_update * len(log_)
    check(launches == want and swa == (0, 0),
          f"{tag}: launches {launches}, swa_attention {swa}; want {want}")
    log(f"{tag}: launches {launches} ({per_update} cg_fused_update an "
        f"update)")


def lm_one_update(cfg, params, batch, fused: bool, timer=None,
                  **overrides) -> tuple:
    """One NGHF update through ``build_step``'s optimiser (all metrics, the
    CG histories included); (new params, metrics, seconds)."""
    from repro_torch.launch.steps import build_step, cg_sub_batch
    _, opt = build_step(cfg, "nghf", cg_frac=4, cg_iters=LM_CG_ITERS,
                        ng_iters=LM_NG_ITERS, cg_fused=fused, **overrides)
    opt.timer = timer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, _, m = opt.step(params, opt.init(params), batch,
                         cg_sub_batch(batch, 4, 1))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return new, {k: (v.tolist() if torch.is_tensor(v) else float(v))
                 for k, v in m.items()}, dt


def lm_paths_compared(tag: str, cfg, params, batch, dev,
                      traced=None, keep: bool = False) -> dict:
    """One NGHF update from ``params`` through the kernel path (fused CG,
    split by the stage timer) and the plain path: the same decision (or
    a tie within the paths' spread) and, without candidate selection,
    the last iterate's Δθ within LM_DELTA_REL_L2, the plain path's own
    repeat printed beside it; then ``traced``, a (name, call) pair, under
    the profiler: by default one kernel-path update.  Returns {"stages",
    "timed_update_s", "trace"}; with ``keep``, also "kernel_path": the
    kernel path's {"metrics", "last" (its last-iterate parameters, on the
    host), "s"}."""
    from repro_torch.core.timing import StageTimer
    timer = StageTimer(dev)
    _, m_k, t_k = lm_one_update(cfg, params, batch, True, timer=timer)
    _, m_p, t_p = lm_one_update(cfg, params, batch, False)
    text = same_choice(f"{tag} NGHF", m_k, m_p)
    stages = dict(timer.totals)
    new_k, m_n, _ = lm_one_update(cfg, params, batch, True,
                                  eval_candidates=False)
    new_p, _, _ = lm_one_update(cfg, params, batch, False,
                                eval_candidates=False)
    rel = delta_rel_l2(new_k, new_p, params)
    kept = {"metrics": m_k, "s": t_k,
            "last": {k: v.cpu() for k, v in new_k.items()}} if keep else None
    del new_k
    new_p2, _, _ = lm_one_update(cfg, params, batch, False,
                                 eval_candidates=False)
    rel_pp = delta_rel_l2(new_p2, new_p, params)
    del new_p, new_p2
    check(rel <= LM_DELTA_REL_L2, f"{tag}: last-iterate Δθ kernel "
          f"vs plain path rel-L2 {rel:.3g}")
    log(f"{tag} NGHF: kernel path == plain path (unfused CG): "
        f"{text}; last-iterate Δθ rel-L2 {rel:.3g} (limit "
        f"{LM_DELTA_REL_L2}; the plain path against its own repeat "
        f"{rel_pp:.3g}; last-iterate |Δθ| {m_n['update_norm']:.4g}); "
        f"update {t_k * 1e3:.3f} ms with the stage timer's syncs, plain "
        f"path {t_p * 1e3:.3f} ms")
    rest = t_k - sum(stages.values())
    log(f"{tag} NGHF update split (stage timer, synced): "
        + ", ".join(f"{k} {v * 1e3:.3f} ms ({100 * v / t_k:.1f} %)"
                    for k, v in stages.items())
        + f", the rest (CG vector work, preconditioner, selection) "
        f"{rest * 1e3:.3f} ms ({100 * rest / t_k:.1f} %); curvature "
        f"products {timer.calls['curvature']}, candidate evaluations "
        f"{timer.calls['candidates']}")

    # one kernel-path update traced: the device's busy and idle share
    what, call = traced or (
        f"NGHF update (B x T = {tuple(batch['tokens'].shape)})",
        lambda: lm_one_update(cfg, params, batch, True))
    trace = device_trace(call)
    idle = 1.0 - trace["busy_s"] / trace["wall_s"]
    log(f"{tag} {what} under torch.profiler: "
        f"{trace['wall_s'] * 1e3:.3f} ms traced, device busy "
        f"{trace['busy_s'] * 1e3:.3f} ms "
        f"({trace['device_events']} device events, read in "
        f"{trace.get('post_s', 0.0):.3f} s), idle share "
        f"{idle:.3f}; most device time: "
        + "; ".join(f"{k[:90]} {ms:.3f} ms x {n}"
                    for k, ms, n in trace["top"]))
    out = {"stages": stages, "timed_update_s": t_k, "trace": trace}
    if keep:
        out["kernel_path"] = kept
    return out


def device_trace(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (device activity
    only): the device's busy time (the union of the intervals of its
    kernels and copies) against the traced call's wall time, and the
    kernels with the most device time.  The profiler's own cost lengthens
    the traced call, so the idle share it gives is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t_post = time.perf_counter()
    spans, by_name = [], {}
    # the raw events (ns): ``prof.events()`` would first build the tree of
    # every host op, 17 s for an LM update's events on a slow host
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns(), e.end_ns()
        if e.device_type() != DeviceType.CUDA or b <= a:
            continue
        spans.append((a, b))
        t, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (t + (b - a) * 1e-6, n + 1)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(b, end) - max(a, end)
        end = max(end, b)
    top = sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                 key=lambda t: -t[1])
    return {"wall_s": wall, "busy_s": busy * 1e-9, "device_events":
            len(spans), "top": top[:6],
            "post_s": time.perf_counter() - t_post}


def lm_train_batch(cfg, step: int, dev) -> dict:
    """The CLI's batch ``step`` (``train_lm``'s draws)."""
    from repro_torch.data.synthetic import lm_batch
    b = lm_batch(step, batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
                 vocab=cfg.vocab_size, device=dev)
    gen = torch.Generator(device=dev).manual_seed(step)
    b["encoder_input"] = torch.randn(
        LM_TRAIN_BATCH, cfg.encoder_frames, cfg.d_model, generator=gen,
        device=dev).to(cfg.cdtype)
    return b


def cli_checkpointed(tag: str, args: list, per_update: int) -> dict:
    """The training CLI with ``args``: 2 updates with a checkpoint, then
    ``--resume`` to 3 — the resumed log starts at step 2, the train state
    loaded from each checkpoint equals the one the CLI saved bitwise,
    every update checked by ``check_lm_updates``.  Returns the main
    path's ``cg_fused_update`` launches, the updates, the log and the
    peak memory."""
    import shutil
    import tempfile
    from repro_torch.launch import train as T
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    ck = os.path.join(tmp, "ck")
    saved = []
    real_save = T.save_train_state

    def save_and_keep(ckpt_dir, params, opt_state, *, step=0, extra=None,
                      **shardings):
        kept = (step, clone_tree(params), clone_tree(opt_state))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_save(ckpt_dir, params, opt_state, step=step, extra=extra,
                  **shardings)
        saved.append(kept + (time.perf_counter() - t0,))

    out = {}
    T.save_train_state = save_and_keep
    try:
        # the main path: counts at 0 just before, read just after
        reset_counts()
        log2 = T.main(args + ["--steps", "2", "--ckpt-dir", ck])
        launches = read_counts()
        check_lm_updates(tag, log2, launches, swa_counts(), [0, 1],
                         per_update)
        _, params, opt_state, t_save = saved[-1]
        t_load = load_and_compare(tag, ck, params, opt_state, 2)
        log(f"{tag} checkpoint at step 2 ({ckpt_mb(ck):.3f} MB on disk): "
            f"save {t_save * 1e3:.3f} ms, load {t_load * 1e3:.3f} ms; "
            f"loaded == saved bitwise")
        del params, opt_state, saved[:]
        reset_counts()
        log3 = T.main(args + ["--steps", "3", "--ckpt-dir", ck, "--resume"])
        launches3 = read_counts()
        check_lm_updates(f"{tag} resumed", log3, launches3, swa_counts(),
                         [2], per_update)
        _, params, opt_state, _ = saved[-1]
        load_and_compare(f"{tag} at step 3", ck, params, opt_state, 3)
        del params, opt_state, saved[:]
        out["launches"] = launches["cg_fused_update"] \
            + launches3["cg_fused_update"]
        out["updates"] = len(log2) + len(log3)
        out["log"] = log2 + log3
        out["peak_cli_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"{tag}: update times "
            f"{[round(m['time_s'], 3) for m in log2 + log3]} s, accepted "
            f"{[bool(m['cg_accepted']) for m in log2 + log3]}; peak device "
            f"memory {out['peak_cli_gb']:.3f} GB")
    finally:
        T.save_train_state = real_save
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_lm_train(dev) -> dict:
    """Phase 9: whisper-base at full width and depth trained by NGHF with
    ``--cg-fused`` through the CLI, checkpointed and resumed; one update
    through the kernel path against the plain path; Adam through the same
    ``build_step``; greedy decode against forward."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as T
    from repro_torch.models import encdec
    from repro_torch.models.registry import get_model
    cfg = get_config(LM_TRAIN_ARCH)
    model = get_model(cfg)
    n_params = model.param_count()
    check(n_params == LM_TRAIN_PARAMS,
          f"{LM_TRAIN_ARCH} has {n_params} parameters")
    log(f"{LM_TRAIN_ARCH}: {n_params} parameters ({len(model.param_shapes())}"
        f" leaves, f32, {4 * n_params / 1e9:.3f} GB); CLI "
        f"{' '.join(LM_TRAIN_ARGS)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = cli_checkpointed("CLI whisper-base", LM_TRAIN_ARGS,
                           LM_CG_ITERS + LM_NG_ITERS)

    # the kernel path against the plain path, from the CLI's start
    torch.cuda.empty_cache()
    params = model.init(0, device=dev)
    batch = lm_train_batch(cfg, 0, dev)
    out.update(lm_paths_compared("whisper-base", cfg, params, batch, dev))

    # Adam through the same build_step (the CLI), 3 steps
    reset_counts()
    adam = T.main(["--arch", LM_TRAIN_ARCH, "--optimizer", "adam",
                   "--batch", str(LM_TRAIN_BATCH), "--seq",
                   str(LM_TRAIN_SEQ), "--steps", "3", "--device", "cuda"])
    check_lm_updates("CLI whisper-base Adam", adam, read_counts(),
                     swa_counts(), [0, 1, 2], 0)

    # greedy decode at f32 compute against forward's logits
    cfg32 = cfg.replace(compute_dtype="float32")
    m32 = get_model(cfg32)
    with torch.no_grad():
        gen = torch.Generator(device=dev).manual_seed(SEED + 90)
        enc = torch.randn(LM_DECODE_BATCH, cfg.encoder_frames, cfg.d_model,
                          generator=gen, device=dev)
        cache = encdec.prefill_cache(cfg32, params, m32.init_cache(
            LM_DECODE_BATCH, LM_DECODE_STEPS, device=dev), enc)
        tok = torch.randint(0, cfg.vocab_size, (LM_DECODE_BATCH, 1),
                            generator=gen, device=dev)
        toks, outs = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(LM_DECODE_STEPS):
            toks.append(tok)
            lg, cache = m32.decode_step(params, cache, tok, t)
            outs.append(lg[:, 0])
            tok = lg[:, 0].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        dec_s = (time.perf_counter() - t0) / LM_DECODE_STEPS
        full, _ = m32.forward(params, {"tokens": torch.cat(toks, 1),
                                       "encoder_input": enc})
        dec = torch.stack(outs, 1)
        drel = float((dec - full).abs().max() / full.abs().max())
    check(bool(torch.isfinite(dec).all()) and drel <= DECODE_REL,
          f"whisper-base decode vs forward: relative max {drel:.3g}")
    log(f"whisper-base f32 greedy decode, B={LM_DECODE_BATCH}, "
        f"{LM_DECODE_STEPS} steps after prefill_cache: logits vs forward "
        f"relative max {drel:.3g} (limit {DECODE_REL}); "
        f"{dec_s * 1e3:.3f} ms a step (host clock)")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, batch, cache, enc, full, dec, outs
    torch.cuda.empty_cache()
    return out


def cg_times_at(n: int, launches: int, updates: int, prefix: str,
                label: str, dev) -> dict:
    """``cg_fused_update`` at length ``n`` (f32) against its plain
    version (x and r bitwise, ⟨r, r⟩ within RR_RTOL): the times of the
    kernel (through the wrapper and alone), the plain version and the
    bound, under keys ``<prefix>_*``, beside the main path's
    ``launches`` over ``updates`` updates."""
    from repro_torch.kernels import cg_fused as CG
    from repro_torch.kernels import ref as R
    gen = torch.Generator(device=dev).manual_seed(SEED + 91)
    x, v, r, bv = (torch.randn(n, generator=gen, device=dev)
                   for _ in range(4))
    alpha = torch.tensor(0.37, device=dev)
    got = CG.cg_fused_update(alpha, x, v, r, bv)
    want = R.cg_fused_update_ref(alpha, x, v, r, bv)
    d_rr = abs(float(got[2]) - float(want[2]))
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
          and d_rr <= RR_RTOL * float(want[2]),
          f"cg_fused_update N={n}: not the plain version's x, r bits or rr "
          f"|d| {d_rr:.3g} of {float(want[2]):.6g}")
    del got, want
    b_ms, b_by = bound(6 * 4 * n, 6 * n)
    t = {f"{prefix}_launches": launches,
         f"{prefix}_launches_per": launches / updates,
         f"{prefix}_ms": cuda_time_ms(
             lambda: CG.cg_fused_update(alpha, x, v, r, bv), 20),
         f"{prefix}_kernel_alone_ms": kernel_alone_ms(
             lambda: CG.cg_fused_update(alpha, x, v, r, bv)),
         f"{prefix}_plain_ms": cuda_time_ms(
             lambda: R.cg_fused_update_ref(alpha, x, v, r, bv), 3),
         f"{prefix}_bound_ms": b_ms, f"{prefix}_bound_by": b_by,
         f"{prefix}_rr_abs_err": d_rr,
         f"{prefix}_shape": f"N={n} f32 ({label})"}
    log(f"cg_fused_update timed at {t[f'{prefix}_shape']}: "
        + ", ".join(f"{k} {v:.6g}" for k, v in t.items()
                    if isinstance(v, float))
        + f"; {100 * b_ms / t[f'{prefix}_kernel_alone_ms']:.1f} % of the "
        f"bound alone")
    del x, v, r, bv
    torch.cuda.empty_cache()
    return t


def lm_cg_times(lm_train: dict, dev) -> dict:
    """``cg_fused_update`` at whisper-base's N, beside phase 9's
    launches."""
    return cg_times_at(LM_TRAIN_PARAMS, lm_train["launches"],
                       lm_train["updates"], "lm", LM_TRAIN_ARCH, dev)


# ---------------------------------------------------------------------------
# Phase 10: the dense attn archs (qwen2.5-3b served and trained, the CLIs)
# ---------------------------------------------------------------------------

# qwen2.5-3b at full width and depth for serving: prefill_32k with its
# batch cut from 32 to 1 and its T from 32768 to 16384 (after a T = 4096
# warm-up; no kernel runs there, and the plain causal attention took
# 40-47 s at T 32768 on a slow host), decode_32k's cache with its batch
# cut from 128 to 8, long_500k's bounded cache from the position 16 short
# of its end
DENSE_ARCH = "qwen2.5-3b"
DENSE_PARAMS = 3_085_938_688
DENSE_PREFILL_T, DENSE_WARM_T = 16384, 4096
DENSE_CACHE = 32768
DENSE_LONG_SLOTS, DENSE_LONG_STEPS = 8192, 16
DENSE_LONG_START = 524_288 - DENSE_LONG_STEPS
# NGHF training at full width with the depth cut to what one card holds:
# 36 layers need about 173 GB of θ-sized f32 state (ROADMAP 1.4)
DENSE_TRAIN_LAYERS = 8
DENSE_TRAIN_PARAMS = 927_782_912
DENSE_TRAIN_BATCH, DENSE_TRAIN_SEQ = 8, 512
DENSE_UPDATES = 2
# the CLI at full width and depth (its defaults: B 8, T 128), and the
# serving archs that fit one card at full width and depth
DENSE_CLI_ARCH = "stablelm-1.6b"
DENSE_SERVE_ARCHS = {"minitron-8b": 7_734_562_816,
                     "stablelm-1.6b": 1_644_367_872}
DENSE_SERVE_T, DENSE_SERVE_REQUESTS, DENSE_SERVE_NEW = 4096, 4, 8
# the archs one card cannot hold: their parameter counts on the meta device
DENSE_META = {"chameleon-34b": 34_293_436_416, "qwen2-72b": 72_706_203_648}


class timed_calls:
    """Within the block, every call of ``<module>.<name>`` (by default
    ``models.layers``) for each of ``names`` is bracketed by CUDA events
    (no synchronize on the path); after the caller synchronized,
    ``ms(name)`` sums a name's calls and ``text(total_ms)`` lists each
    name's sum, calls and share of ``total_ms``.  A name called inside
    another's calls is timed inside them too."""

    def __init__(self, names: tuple, module=None):
        self.names = names
        self.module = module

    def __enter__(self):
        if self.module is None:
            from repro_torch.models import layers
            self.module = layers
        self._saved = {n: getattr(self.module, n) for n in self.names}
        self.pairs = {n: [] for n in self.names}
        for name, fn in self._saved.items():
            setattr(self.module, name, self._wrap(fn, self.pairs[name]))
        return self

    @staticmethod
    def _wrap(fn, pairs: list):
        def wrapped(*args, **kwargs):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = fn(*args, **kwargs)
            t1.record()
            pairs.append((t0, t1))
            return out
        return wrapped

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.module, name, fn)

    def ms(self, name: str) -> float:
        return sum(a.elapsed_time(b) for a, b in self.pairs[name])

    def text(self, total_ms: float) -> str:
        return ", ".join(
            f"{n} {self.ms(n):.3f} ms over {len(self.pairs[n])} calls "
            f"({100 * self.ms(n) / total_ms:.1f} %)" for n in self.names)


def dense_serving(dev, arch: str, count: int) -> dict:
    """A global-attention arch with tied embeddings (qwen2.5-3b, or
    granite-moe-3b-a800m) at full width and depth: prefill, serve, prefill
    vs decode at f32, long_500k's ring.  The prefill's attention, and an
    MoE arch's expert FFN (and in decode its expert casts), are timed
    apart by CUDA events."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models.registry import get_model
    cfg = get_config(arch)
    model = get_model(cfg)
    moe = ("moe_apply",) if cfg.num_experts else ()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in params.values())
    check(n_params == count == model.param_count()
          and "embed.lm_head" not in params,
          f"{arch} has {n_params} parameters")
    log(f"{arch}: {n_params} parameters (f32, tied embeddings, "
        f"{4 * n_params / 1e9:.3f} GB) drawn on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED + 100)
    tokens = torch.randint(0, cfg.vocab_size, (1, DENSE_PREFILL_T),
                           generator=gen, device=dev)
    prefill = build_prefill_step(cfg)
    out = {}

    # prefill: a T = 4096 warm-up, then prefill_32k's T once
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(params, {"tokens": tokens[:, :DENSE_WARM_T]})
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reset_counts()
    with timed_calls(("causal_attention",) + moe) as parts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    out["attention_ms"] = parts.ms("causal_attention")
    check(read_counts() == {k: 0 for k in read_counts()}
          and swa_counts() == (0, 0), f"the {arch} prefill launched a kernel")
    check(tuple(logits.shape) == (1, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"prefill logits {tuple(logits.shape)}, finite "
          f"{bool(torch.isfinite(logits).all())}")
    log(f"{arch} prefill B=1 T={DENSE_PREFILL_T}: logits "
        f"{tuple(logits.shape)} finite; {out['prefill_ms']:.3f} ms (warm; "
        f"the T={DENSE_WARM_T} warm-up took {warm_s * 1e3:.3f} ms), of "
        f"which by CUDA events {parts.text(out['prefill_ms'])}; no kernel "
        f"launched (the reference's attention and MoE are jnp)")
    if moe:
        out["moe_ms"] = parts.ms("moe_apply")
    del logits
    torch.cuda.empty_cache()

    # the server: 8 requests against decode_32k's cache length
    reqs = make_requests(cfg, SERVE_REQUESTS, SERVE_NEW, seed=SEED)
    reqs, stats = serve(cfg, model, params, reqs, cache_len=DENSE_CACHE)
    check(all(r.done and len(r.generated) == SERVE_NEW for r in reqs)
          and all(0 <= t < cfg.vocab_size for r in reqs
                  for t in r.generated), "dense serve: a request failed")
    step = build_serve_step(cfg)
    cache = model.init_cache(SERVE_REQUESTS, DENSE_CACHE, device=dev)
    tok = tokens[:, :1].expand(SERVE_REQUESTS, 1).contiguous()
    out["decode_ms"] = cuda_time_ms(lambda: step(params, cache, tok, 100), 5)
    casts = ("_expert_matrices",) if moe else ()
    with timed_calls(("decode_attention",) + moe + casts) as parts:
        step(params, cache, tok, 100)
        torch.cuda.synchronize()
    out["decode_attention_ms"] = parts.ms("decode_attention")
    if moe:
        out["decode_moe_ms"] = parts.ms("moe_apply")
        out["decode_cast_ms"] = parts.ms("_expert_matrices")
    out["stats"] = stats
    log(f"{arch} serve: {len(reqs)} requests (prompts "
        f"{[len(r.prompt) for r in reqs]} tokens, {SERVE_NEW} new each), "
        f"cache of {DENSE_CACHE} slots, in {stats['steps']} steps, "
        f"{stats['wall_s'] * 1e3:.3f} ms: {stats['tokens_per_s']:.3f} "
        f"tokens/s, p50 {stats['latency_p50_s'] * 1e3:.3f} ms, p99 "
        f"{stats['latency_p99_s'] * 1e3:.3f} ms; decode step "
        f"B={SERVE_REQUESTS} over {DENSE_CACHE} slots {out['decode_ms']:.3f}"
        f" ms (CUDA events), of which (one step bracketed by events) "
        f"{parts.text(out['decode_ms'])}"
        + ("; the expert casts run inside moe_apply" if moe else ""))
    del cache
    torch.cuda.empty_cache()

    # prefill against decode at f32 compute, T = 64
    cfg32 = cfg.replace(compute_dtype="float32")
    prompt = tokens[:, :DECODE_PROMPT]
    want = build_prefill_step(cfg32)(params, {"tokens": prompt})
    step32 = build_serve_step(cfg32)
    cache = get_model(cfg32).init_cache(1, DECODE_PROMPT, device=dev)
    for t in range(DECODE_PROMPT):
        got, cache = step32(params, cache, prompt[:, t:t + 1], t)
    rel_max = float((got - want).abs().max() / want.abs().max())
    check(rel_max <= DECODE_REL, f"{arch} f32 prefill vs decode: "
          f"relative max {rel_max:.3g}")
    log(f"{arch} f32 compute: prefill's last logits == "
        f"{DECODE_PROMPT} decode steps' (relative max {rel_max:.3g}, limit "
        f"{DECODE_REL})")
    del cache, got, want

    # long_500k: the bounded ring cache, 16 steps from the end of the 500k
    specs = model.input_specs("long_500k")
    slots = {s[2] for s, _ in specs["cache"].values()}
    want_bytes = sum(math.prod(s) * torch.finfo(dt).bits // 8
                     for s, dt in specs["cache"].values())
    step_long = build_serve_step(cfg, long_mode=True)
    cache = model.init_cache(1, 524_288, long_mode=True, device=dev)
    got_bytes = sum(v.numel() * v.element_size() for v in cache.values())
    check(slots == {DENSE_LONG_SLOTS} and got_bytes == want_bytes
          == 2 * cfg.num_layers * DENSE_LONG_SLOTS * cfg.num_kv_heads
          * cfg.resolved_head_dim * 2,
          f"long_500k cache: slots {slots}, {got_bytes} bytes, specs "
          f"{want_bytes}")
    times, written = [], []
    for i in range(DENSE_LONG_STEPS):
        pos = DENSE_LONG_START + i
        before = cache["periods.slot0.k"][0].clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = step_long(params, cache, tokens[:, i:i + 1], pos)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        changed = (cache["periods.slot0.k"][0] != before).any(
            dim=(0, 2, 3)).nonzero().flatten().tolist()
        check(changed == [pos % DENSE_LONG_SLOTS]
              and bool(torch.isfinite(lg).all()),
              f"long_500k step at {pos}: wrote slots {changed}, finite "
              f"{bool(torch.isfinite(lg).all())}")
        written.append(changed[0])
    out["long_ms"] = 1e3 * sum(times[1:]) / (len(times) - 1)
    log(f"{arch} long_500k (long_mode): cache of {DENSE_LONG_SLOTS} "
        f"slots, {got_bytes} bytes (the specs' {want_bytes}); "
        f"{DENSE_LONG_STEPS} steps at B=1 from position {DENSE_LONG_START} "
        f"wrote slots {written[0]}..{written[-1]} (pos % "
        f"{DENSE_LONG_SLOTS}), logits finite; {out['long_ms']:.3f} ms a "
        f"step after the first (host clock, synced)")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"{arch} serving: peak device memory {out['peak_gb']:.3f} GB")
    del params, cache, tokens
    torch.cuda.empty_cache()
    return out


def dense_batch(cfg, step: int, dev) -> dict:
    from repro_torch.data.synthetic import lm_batch
    return lm_batch(step, batch=DENSE_TRAIN_BATCH, seq_len=DENSE_TRAIN_SEQ,
                    vocab=cfg.vocab_size, device=dev)


def dense_training(dev, arch: str, layers: int, count: int,
                   keep: bool = False) -> dict:
    """An arch (qwen2.5-3b, or granite-moe-3b-a800m) at full width and
    ``layers`` layers, trained by NGHF with the fused CG kernel through
    ``build_step``; one update against the plain path (``keep``: the
    kernel path's update is kept, "kernel_path", for phase 15)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.optim import config_for
    from repro_torch.launch.steps import build_step
    from repro_torch.models.registry import get_model
    full = get_config(arch)
    cfg = full.replace(num_layers=layers)
    model = get_model(cfg)
    check(model.param_count() == count,
          f"{arch} at {layers} layers has {model.param_count()} parameters")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = model.init(SEED, device=dev)
    per_update = LM_CG_ITERS + LM_NG_ITERS
    ocfg = config_for("nghf", cg_iters=LM_CG_ITERS, ng_iters=LM_NG_ITERS,
                      cg_fused=True)
    step, opt = build_step(cfg, ocfg, cg_frac=4)
    log(f"{arch} NGHF at full width, {layers} of {full.num_layers} "
        f"layers: {count} parameters ({4 * count / 1e9:.3f} GB f32); "
        f"B={DENSE_TRAIN_BATCH}, T={DENSE_TRAIN_SEQ}, CG batch "
        f"{DENSE_TRAIN_BATCH // 4}, {LM_CG_ITERS} CG and {LM_NG_ITERS} NG "
        f"iterations, fused CG, f32 state, {ocfg.preconditioner} "
        f"preconditioner")

    # the main path: counts at 0 just before, read just after
    params, opt_state, log_ = start, opt.init(start), []
    reset_counts()
    for i in range(DENSE_UPDATES):
        batch = dense_batch(cfg, i, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        torch.cuda.synchronize()
        m = {k: float(v) for k, v in m.items()}
        log_.append(dict(step=i, time_s=time.perf_counter() - t0, **m))
    launches = read_counts()
    check_lm_updates(f"{arch} NGHF", log_, launches, swa_counts(),
                     list(range(DENSE_UPDATES)), per_update)
    out = {"launches": launches["cg_fused_update"], "updates": len(log_),
           "log": log_,
           "peak_main_gb": torch.cuda.max_memory_allocated() / 1e9}
    aux = (f"; the aux term (loss - ce) "
           f"{[round(m['loss'] - m['ce'], 6) for m in log_]}"
           if cfg.num_experts else "")
    log(f"{arch} NGHF: update times "
        f"{[round(m['time_s'], 3) for m in log_]} s, accepted "
        f"{[bool(m['cg_accepted']) for m in log_]}{aux}; peak device "
        f"memory {out['peak_main_gb']:.3f} GB")
    del params, opt_state
    torch.cuda.empty_cache()

    # the kernel path against the plain path, from the same start
    batch = dense_batch(cfg, 0, dev)
    out.update(lm_paths_compared(arch, cfg, start, batch, dev, keep=keep))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"{arch} NGHF: peak device memory {out['peak_gb']:.3f} GB")
    del start, batch
    torch.cuda.empty_cache()
    return out


def dense_clis(dev) -> dict:
    """stablelm-1.6b trained by Adam through the CLI at full width and
    depth; minitron-8b and stablelm-1.6b served at full width and depth;
    the two archs one card cannot hold, by parameter count."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as T
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.registry import get_model
    out = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    adam = T.main(["--arch", DENSE_CLI_ARCH, "--optimizer", "adam",
                   "--steps", "3", "--device", "cuda"])
    check_lm_updates(f"CLI {DENSE_CLI_ARCH} Adam", adam, read_counts(),
                     swa_counts(), [0, 1, 2], 0)
    out["adam_s"] = [m["time_s"] for m in adam]
    log(f"CLI {DENSE_CLI_ARCH} Adam (full width and depth, B 8, T 128): "
        f"step times {[round(t, 3) for t in out['adam_s']]} s, ce "
        f"{[round(m['ce'], 4) for m in adam]}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    torch.cuda.empty_cache()
    for arch, count in DENSE_SERVE_ARCHS.items():
        cfg = get_config(arch)
        model = get_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        params = model.init(SEED, device=dev)
        check(sum(v.numel() for v in params.values()) == count
              == model.param_count(), f"{arch}: parameter count")
        gen = torch.Generator(device=dev).manual_seed(SEED + 101)
        toks = torch.randint(0, cfg.vocab_size, (1, DENSE_SERVE_T),
                             generator=gen, device=dev)
        prefill = build_prefill_step(cfg)
        prefill(params, {"tokens": toks[:, :512]})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        reqs = make_requests(cfg, DENSE_SERVE_REQUESTS, DENSE_SERVE_NEW,
                             seed=SEED)
        reqs, stats = serve(cfg, model, params, reqs)
        check(bool(torch.isfinite(lg).all())
              and all(r.done and len(r.generated) == DENSE_SERVE_NEW
                      for r in reqs), f"{arch}: prefill or serve failed")
        peak = torch.cuda.max_memory_allocated() / 1e9
        out[arch] = {"prefill_ms": pre_ms, "stats": stats, "peak_gb": peak}
        log(f"{arch} (full width and depth, {count} parameters): prefill "
            f"B=1 T={DENSE_SERVE_T} {pre_ms:.3f} ms, logits finite; serve "
            f"{DENSE_SERVE_REQUESTS} requests x {DENSE_SERVE_NEW} new in "
            f"{stats['steps']} steps, {stats['wall_s'] * 1e3:.3f} ms, "
            f"{stats['tokens_per_s']:.3f} tokens/s, p50 "
            f"{stats['latency_p50_s'] * 1e3:.3f} ms, p99 "
            f"{stats['latency_p99_s'] * 1e3:.3f} ms; peak device memory "
            f"{peak:.3f} GB")
        del params, lg, toks
        torch.cuda.empty_cache()
    for arch, count in DENSE_META.items():
        got = get_model(get_config(arch)).param_count()
        check(got == count, f"{arch}: {got} parameters, want {count}")
        log(f"{arch}: {got} parameters on the meta device "
            f"({4 * got / 1e9:.1f} GB f32: more than one card holds)")
    return out


def phase_dense(dev) -> dict:
    """Phase 10: the dense attn archs."""
    return {"serving": dense_serving(dev, DENSE_ARCH, DENSE_PARAMS),
            "training": dense_training(dev, DENSE_ARCH, DENSE_TRAIN_LAYERS,
                                       DENSE_TRAIN_PARAMS, keep=True),
            "clis": dense_clis(dev)}


def dense_cg_times(dense: dict, dev) -> dict:
    """``cg_fused_update`` at the dense training's N, beside phase 10's
    launches."""
    tr = dense["training"]
    return cg_times_at(DENSE_TRAIN_PARAMS, tr["launches"], tr["updates"],
                       "dense", f"{DENSE_ARCH}, {DENSE_TRAIN_LAYERS} layers",
                       dev)


# ---------------------------------------------------------------------------
# Phase 11: the MoE archs (granite-moe-3b-a800m served and trained,
# mixtral-8x22b's windowed prefill, the dispatch FFN)
# ---------------------------------------------------------------------------

# granite-moe-3b-a800m at full width and depth for serving (phase 10's
# cuts: prefill_32k's B 32 -> 1 and T 32768 -> 16384, decode_32k's B 128
# -> 8, long_500k's
# ring from the position 16 short of its end); NGHF at full width with the
# depth cut to what one card holds (32 layers need about 185 GB of
# θ-sized f32 state, ROADMAP 1.4), B 8, T 512
MOE_ARCH = "granite-moe-3b-a800m"
MOE_PARAMS = 3_298_793_472
MOE_TRAIN_LAYERS = 8
MOE_TRAIN_PARAMS = 881_326_080
# mixtral-8x22b at full width and 2 of its 56 layers: a bf16 prefill of
# B = 1 x T = 32768 (two tensor-core swa_attention launches at G = 6, hd
# 128, window 4096), an f32 one of T = 8192 (window < T: the band
# matters) through the CUDA-core kernel and through the plain path
MIXTRAL_ARCH = "mixtral-8x22b"
MIXTRAL_LAYERS = 2
MIXTRAL_PARAMS = 5_410_781_184
MIXTRAL_FULL_PARAMS = 140_630_071_296
MIXTRAL_T, MIXTRAL_F32_T = 32768, 8192
# moe_apply_dispatch at granite's full width: one layer on the card
# against the CPU at f32 (B, T), relative L2; then timed against
# moe_apply at bf16 (B, T)
DISPATCH_CHECK, DISPATCH_TIME = (2, 256), (8, 512)
DISPATCH_REL_L2 = 1e-5


class captured_calls:
    """Within the block, each call of ``models.layers.<name>`` appends
    ``keep(args, result)`` to ``self.seen`` and returns the result."""

    def __init__(self, name: str, keep):
        self.name, self.keep, self.seen = name, keep, []

    def __enter__(self):
        from repro_torch.models import layers
        self._saved = fn = getattr(layers, self.name)

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.seen.append(self.keep(args, out))
            return out
        setattr(layers, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        setattr(layers, self.name, self._saved)


def top_sets(args, out):
    """The sorted top-k expert indices of a ``layers._route`` call."""
    return torch.sort(out[2], dim=-1).values


def mixtral_prefill(dev, errs: dict) -> dict:
    """mixtral-8x22b at full width and 2 layers: the bf16 prefill of B = 1
    x T = 32768 through the tensor-core kernel, which is held against its
    plain version on layer 0's q, k, v and timed there (the ``moe_*`` keys
    of the kernels line's ``swa_attention`` row); the f32 prefill of T =
    8192 through the CUDA-core kernel and the plain path; f32 prefill
    against 64 decode steps."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import swa_attention as SWA
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models.registry import get_model
    full = get_config(MIXTRAL_ARCH)
    got = get_model(full).param_count()
    check(got == MIXTRAL_FULL_PARAMS, f"{MIXTRAL_ARCH}: {got} parameters")
    cfg = full.replace(num_layers=MIXTRAL_LAYERS)
    model = get_model(cfg)
    window = cfg.sliding_window
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in params.values())
    check(n_params == MIXTRAL_PARAMS == model.param_count(),
          f"{MIXTRAL_ARCH} at {MIXTRAL_LAYERS} layers has {n_params} "
          f"parameters")
    log(f"{MIXTRAL_ARCH}: {got} parameters at full depth (meta device, "
        f"{4 * got / 1e9:.1f} GB f32); {MIXTRAL_LAYERS} of "
        f"{full.num_layers} layers at full width: {n_params} parameters "
        f"({4 * n_params / 1e9:.3f} GB f32) drawn on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED + 110)
    tokens = torch.randint(0, cfg.vocab_size, (1, MIXTRAL_T), generator=gen,
                           device=dev)
    prefill = build_prefill_step(cfg)
    prefill(params, {"tokens": tokens[:, :DENSE_WARM_T]})
    out = {}

    # the main path: counts at 0 just before, read just after; layer 0's
    # q, k, v kept
    with captured_calls("swa_attention",
                        lambda a, o: tuple(t.clone() for t in a[:3])) as cap:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        launches = swa_counts()
    check(launches == (MIXTRAL_LAYERS, 0)
          and read_counts() == {k: 0 for k in read_counts()},
          f"{MIXTRAL_ARCH} bf16 prefill: swa_attention launches (tensor "
          f"core, CUDA core) {launches}, want ({MIXTRAL_LAYERS}, 0); "
          f"others {read_counts()}")
    check(tuple(logits.shape) == (1, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{MIXTRAL_ARCH} prefill logits {tuple(logits.shape)}, finite "
          f"{bool(torch.isfinite(logits).all())}")
    out["launches"] = launches[0]
    log(f"{MIXTRAL_ARCH} bf16 prefill B=1 T={MIXTRAL_T}: logits "
        f"{tuple(logits.shape)} finite, {out['prefill_ms']:.3f} ms (after "
        f"a T={DENSE_WARM_T} warm-up); tensor-core swa_attention launched "
        f"{launches[0]} times (one per swamoe layer), the CUDA-core "
        f"kernel {launches[1]}")
    q, k, v = cap.seen[0]
    del cap, logits
    # where the prefill's time goes: a second run, its attention and
    # expert FFN bracketed by CUDA events
    with timed_calls(("windowed_attention", "moe_apply")) as parts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        out["prefill_again_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"{MIXTRAL_ARCH} bf16 prefill again: {out['prefill_again_ms']:.3f}"
        f" ms, of which by CUDA events "
        f"{parts.text(out['prefill_again_ms'])}")
    shape = (*q.shape[:3], k.shape[2], q.shape[3], window)
    got = SWA.swa_attention(q, k, v, window)
    want = R.swa_attention_ref(q, k, v, window)
    err = compare_swa("mixtral_layer0_" + "x".join(map(str, shape)), got,
                      want, torch.bfloat16, errs)
    log(f"swa_attention == plain on {MIXTRAL_ARCH} layer 0's q, k, v "
        f"(B,T,H,K,hd,window)={shape} bf16: max |d| {err:.3g}, "
        f"{float((got != want).float().mean()):.3g} of the entries differ "
        f"(limits: one bf16 ulp, {SWA_BF16_DIFF_SHARE})")
    del got, want

    # the f32 prefill, T = 8192: the CUDA-core kernel against the plain
    # path, with the routing of each
    cfg32 = cfg.replace(compute_dtype="float32")
    prefill32 = build_prefill_step(cfg32)
    row = {"tokens": tokens[:, :MIXTRAL_F32_T]}
    n = swa_counts()
    with captured_calls("_route", top_sets) as kr:
        kern32 = prefill32(params, row)
    check(swa_counts() == (n[0], n[1] + MIXTRAL_LAYERS),
          f"the f32 prefill launched swa_attention {swa_counts()} from "
          f"{n}, want {MIXTRAL_LAYERS} CUDA-core launches")
    with plain_attention(), captured_calls("_route", top_sets) as pr:
        plain32 = prefill32(params, row)
    check(swa_counts() == (n[0], n[1] + MIXTRAL_LAYERS),
          "the plain f32 path launched a kernel")
    rel32 = rel_l2(kern32, plain32)
    flips = [float((a != b).any(-1).float().mean())
             for a, b in zip(kr.seen, pr.seen)]
    check(rel32 <= PREFILL_F32_REL_L2, f"{MIXTRAL_ARCH} f32 prefill kernel "
          f"vs plain path rel-L2 {rel32:.3g} > {PREFILL_F32_REL_L2}")
    out["f32_rel_l2"], out["top2_flips"] = rel32, flips
    log(f"{MIXTRAL_ARCH} f32 prefill B=1 T={MIXTRAL_F32_T} (window "
        f"{window} < T): kernel path (CUDA-core kernel) == plain path, "
        f"last-position logits rel-L2 {rel32:.3g} (limit "
        f"{PREFILL_F32_REL_L2}); share of tokens whose top-"
        f"{cfg.num_experts_per_tok} set differs between the paths, by "
        f"layer: {flips}")
    del kern32, plain32, kr, pr

    # prefill against decode at f32 compute, T = 64 <= window (past the
    # window the reference's prefill and ring decode differ, ROADMAP §3.3)
    n_dec = min(DECODE_PROMPT, window)
    prompt = tokens[:, :n_dec]
    want = prefill32(params, {"tokens": prompt})
    step32 = build_serve_step(cfg32)
    cache = get_model(cfg32).init_cache(1, n_dec, device=dev)
    for t in range(n_dec):
        got, cache = step32(params, cache, prompt[:, t:t + 1], t)
    rel_max = float((got - want).abs().max() / want.abs().max())
    check(rel_max <= DECODE_REL, f"{MIXTRAL_ARCH} f32 prefill vs decode: "
          f"relative max {rel_max:.3g}")
    log(f"{MIXTRAL_ARCH} f32 compute: prefill's last logits == {n_dec} "
        f"decode steps' (relative max {rel_max:.3g}, limit {DECODE_REL})")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"{MIXTRAL_ARCH}: peak device memory {out['peak_gb']:.3f} GB")
    del params, cache, got, want, tokens
    torch.cuda.empty_cache()
    out["swa"] = mixtral_swa_times(q, k, v, window, out["launches"])
    del q, k, v
    torch.cuda.empty_cache()
    return out


def mixtral_swa_times(q, k, v, window: int, launches: int) -> dict:
    """The tensor-core kernel on mixtral's layer-0 q, k, v: through the
    wrapper over 20 calls and alone, the plain version and SDPA with the
    band mask, and the bound from this run's shape; the ``moe_*`` keys of
    the ``swa_attention`` row."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import swa_attention as SWA
    n = swa_counts()
    lib_fn, lib_t, lib_d = sdpa_call(q, k, v, window)

    def kernel():
        return SWA.swa_attention(q, k, v, window)

    t = {"moe_launches": launches, "moe_launches_per": launches,
         "moe_ms": cuda_time_ms(kernel, 20),
         "moe_kernel_alone_ms": kernel_alone_ms(kernel),
         "moe_plain_ms": cuda_time_ms(
             lambda: R.swa_attention_ref(q, k, v, window), 2),
         "moe_library_ms": (cuda_time_ms(lib_fn, 2) if lib_fn else None)}
    # comparison and timing launches are not the main path's
    SWA.swa_attention.launches, SWA.swa_attention.cuda_core_launches = n
    shape = (*q.shape[:3], k.shape[2], q.shape[3], window)
    byt, flops = swa_work(shape, q.dtype)
    t["moe_bound_ms"], t["moe_bound_by"] = swa_bound(byt, flops)
    t["moe_per"] = f"{MIXTRAL_ARCH} prefill, {MIXTRAL_LAYERS} layers"
    t["moe_shape"] = f"B,T,H,K,hd,window={list(shape)} bf16"
    log(f"swa_attention timed at {MIXTRAL_ARCH}'s {t['moe_shape']}: "
        + ", ".join(f"{k} {v:.6g}" for k, v in t.items()
                    if isinstance(v, float))
        + f"; useful work {flops} flops, {byt} bytes, "
        f"{flops / t['moe_ms'] * 1e-9:.3f} TFLOP/s; "
        f"{100 * t['moe_bound_ms'] / t['moe_kernel_alone_ms']:.1f} % of the "
        f"bound alone; scaled_dot_product_attention (band mask) at "
        f"T={lib_t}, max |d| vs the kernel {lib_d}")
    return t


def dispatch_ffn(dev) -> dict:
    """``moe_apply_dispatch`` at granite's full width: one layer on the
    card against the same call on the CPU at f32, then timed against
    ``moe_apply`` at bf16 (a yardstick for a later speed PR)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers as L
    cfg = get_config(MOE_ARCH).replace(compute_dtype="float32")
    gen = torch.Generator().manual_seed(SEED + 120)
    p = L.init_moe(cfg, L.Init("cpu", gen))
    B, T = DISPATCH_CHECK
    x = torch.randn(B, T, cfg.d_model, generator=gen)
    want, waux = L.moe_apply_dispatch(cfg, p, x)
    pg = {k: v.to(dev) for k, v in p.items()}
    got, aux = L.moe_apply_dispatch(cfg, pg, x.to(dev))
    rel = rel_l2(got.cpu(), want)
    d_aux = abs(float(aux) - float(waux))
    check(got.device.type == dev.type and rel <= DISPATCH_REL_L2
          and d_aux <= DISPATCH_REL_L2 * float(waux),
          f"moe_apply_dispatch card vs CPU: rel-L2 {rel:.3g}, aux |d| "
          f"{d_aux:.3g}")
    out = {"rel_l2": rel}
    B, T = DISPATCH_TIME
    c16 = cfg.replace(compute_dtype="bfloat16")
    x16 = torch.randn(B, T, cfg.d_model, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(
                          SEED + 121)).to(torch.bfloat16)
    for fn in ("moe_apply", "moe_apply_dispatch"):
        out[fn + "_ms"] = cuda_time_ms(
            lambda fn=fn: getattr(L, fn)(c16, pg, x16), 5)
    log(f"moe_apply_dispatch at {MOE_ARCH}'s full width (d "
        f"{cfg.d_model}, {cfg.num_experts} experts of ff {cfg.d_ff}, top-"
        f"{cfg.num_experts_per_tok}): card == CPU at f32, B={DISPATCH_CHECK[0]}"
        f" T={DISPATCH_CHECK[1]}, rel-L2 {rel:.3g}, aux |d| {d_aux:.3g} "
        f"(limit {DISPATCH_REL_L2}); bf16 B={B} T={T}: dispatch "
        f"{out['moe_apply_dispatch_ms']:.3f} ms, dense "
        f"{out['moe_apply_ms']:.3f} ms (CUDA events, 5 calls)")
    del p, pg, x, x16, got, want
    torch.cuda.empty_cache()
    return out


def moe_adam(dev) -> list:
    """granite-moe-3b-a800m at full width and MOE_TRAIN_LAYERS layers
    trained by Adam through ``build_step`` (the CLI's step and its
    batches: B 8, T 128), 3 steps; the step times.  At full depth the
    port's out-of-place Adam holds θ, its gradient and the old and new m,
    v and θ, about 92 GB of f32 state (ROADMAP 1.4)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch.steps import build_step
    from repro_torch.models.registry import get_model
    cfg = get_config(MOE_ARCH).replace(num_layers=MOE_TRAIN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = get_model(cfg).init(SEED, device=dev)
    step, opt = build_step(cfg, "adam", lr=3e-4)
    state, log_ = opt.init(params), []
    reset_counts()
    for i in range(3):
        batch = lm_batch(i, batch=8, seq_len=128, vocab=cfg.vocab_size,
                         device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        log_.append(dict(step=i, time_s=time.perf_counter() - t0,
                         **{k: float(v) for k, v in m.items()}))
    check_lm_updates(f"{MOE_ARCH} Adam", log_, read_counts(), swa_counts(),
                     [0, 1, 2], 0)
    times = [m["time_s"] for m in log_]
    log(f"{MOE_ARCH} Adam through build_step (full width, "
        f"{MOE_TRAIN_LAYERS} layers, B 8, T 128): step times "
        f"{[round(t, 3) for t in times]} s, ce "
        f"{[round(m['ce'], 4) for m in log_]}, loss "
        f"{[round(m['loss'], 4) for m in log_]}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del params, state
    torch.cuda.empty_cache()
    return times


def phase_moe(dev, errs: dict) -> dict:
    """Phase 11: the MoE archs."""
    torch.cuda.empty_cache()
    return {"serving": dense_serving(dev, MOE_ARCH, MOE_PARAMS),
            "training": dense_training(dev, MOE_ARCH, MOE_TRAIN_LAYERS,
                                       MOE_TRAIN_PARAMS),
            "adam_s": moe_adam(dev),
            "mixtral": mixtral_prefill(dev, errs),
            "dispatch": dispatch_ffn(dev)}


def moe_cg_times(moe: dict, dev) -> dict:
    """``cg_fused_update`` at granite's training N, beside phase 11's
    launches."""
    tr = moe["training"]
    return cg_times_at(MOE_TRAIN_PARAMS, tr["launches"], tr["updates"],
                       "moe", f"{MOE_ARCH}, {MOE_TRAIN_LAYERS} layers", dev)


# ---------------------------------------------------------------------------
# Phase 12: the xLSTM arch (xlstm-125m served and trained at full width
# and depth)
# ---------------------------------------------------------------------------

XLSTM_ARCH = "xlstm-125m"
XLSTM_PARAMS = 150_319_176
# prefill_32k at its own batch (halved while it does not fit the card),
# after a T = 4096 warm-up; decode_32k at its own batch (the recurrent
# state does not grow with the context); long_500k natively
XLSTM_PREFILL_B, XLSTM_PREFILL_T, XLSTM_WARM_T = 32, 32768, 4096
XLSTM_DECODE_B = 128
XLSTM_DECODE_T = 512               # f32 prefill vs this many decode steps
XLSTM_LONG_START = 524_288 - 16
# the chunkwise mLSTM (layer 0) against the step recurrence on the card,
# f32: the block's output and one vjp's parameter gradient, relative L2
# (T 2048 -> 1024, 16 chunks of 64: the step recurrence took 23 s)
XLSTM_ORACLE_B, XLSTM_ORACLE_T = 2, 1024
XLSTM_ORACLE_L2, XLSTM_ORACLE_GRAD_L2 = 1e-5, 1e-4
# the sLSTM's loops as CUDA graphs against plain loops: the same kernels
# on the same inputs (relative L2; bitwise printed)
XLSTM_GRAPH_L2 = 1e-6
# NGHF through the CLI: train_4k's B 256 x T 4096 cut to B 8 x T 256 (CG
# batch 2), the share-counts preconditioner; depth 12 -> 4 (one period:
# 3 mLSTM + 1 sLSTM blocks): the host sets its updates' time (24-27 s
# each at full depth on an H100 80GB HBM3, 233 s of phase 12, and the
# script took 1157.6 s with phase 15 beside it; at T 512 the training
# took 62.5 s of a 1034.1 s script, so T went to 256 with phase 18)
XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ = 8, 256
XLSTM_TRAIN_LAYERS = 4
XLSTM_TRAIN_PARAMS = 75_863_064
XLSTM_TRAIN_ARGS = ["--arch", XLSTM_ARCH, "--optimizer", "nghf",
                    "--layers", str(XLSTM_TRAIN_LAYERS),
                    "--batch", str(XLSTM_TRAIN_BATCH), "--seq",
                    str(XLSTM_TRAIN_SEQ), "--cg-iters", str(LM_CG_ITERS),
                    "--ng-iters", str(LM_NG_ITERS), "--preconditioner",
                    "share_counts", "--cg-fused", "--device", "cuda"]


def xlstm_prefill(params, prefill, tokens) -> tuple:
    """prefill_32k at XLSTM_PREFILL_B, halved while the card runs out of
    memory (the cut printed): (logits, batch, ms, the blocks' timer)."""
    from repro_torch.models import blocks
    B = XLSTM_PREFILL_B
    while True:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            with timed_calls(("mlstm_block_apply", "slstm_block_apply"),
                             blocks) as parts:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = prefill(params, {"tokens": tokens[:B]})
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            return logits, B, ms, parts
        except torch.cuda.OutOfMemoryError:
            check(B > 1, "the xlstm-125m prefill does not fit at B = 1")
            log(f"{XLSTM_ARCH} prefill B={B} x T={XLSTM_PREFILL_T} does not "
                f"fit the card: B cut to {B // 2}")
            B //= 2


def xlstm_serving(dev) -> dict:
    """xlstm-125m at full width and depth: prefill_32k, decode_32k's step,
    ``serve``, f32 prefill against XLSTM_DECODE_T decode steps, long_500k;
    the mLSTM and sLSTM blocks timed apart by CUDA events."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models import blocks
    from repro_torch.models.registry import get_model
    cfg = get_config(XLSTM_ARCH)
    model = get_model(cfg)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = model.init(SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in params.values())
    check(n_params == XLSTM_PARAMS == model.param_count()
          and "embed.lm_head" not in params,
          f"{XLSTM_ARCH} has {n_params} parameters")
    log(f"{XLSTM_ARCH}: {n_params} parameters (f32, tied embeddings, "
        f"{4 * n_params / 1e9:.3f} GB; 9 mLSTM and 3 sLSTM blocks) drawn on "
        f"the card in {time.perf_counter() - t0:.3f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED + 120)
    tokens = torch.randint(0, cfg.vocab_size,
                           (XLSTM_PREFILL_B, XLSTM_PREFILL_T), generator=gen,
                           device=dev)
    prefill = build_prefill_step(cfg)
    out = {}

    # prefill: a T = 4096 warm-up, then prefill_32k once
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(params, {"tokens": tokens[:, :XLSTM_WARM_T]})
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reset_counts()
    logits, B, out["prefill_ms"], parts = xlstm_prefill(params, prefill,
                                                        tokens)
    out["prefill_batch"] = B
    out["prefill_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["mlstm_ms"] = parts.ms("mlstm_block_apply")
    out["slstm_ms"] = parts.ms("slstm_block_apply")
    check(read_counts() == {k: 0 for k in read_counts()}
          and swa_counts() == (0, 0), "the xlstm-125m prefill launched a "
          "kernel")
    check(tuple(logits.shape) == (B, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"prefill logits {tuple(logits.shape)}, finite "
          f"{bool(torch.isfinite(logits).all())}")
    log(f"{XLSTM_ARCH} prefill B={B} T={XLSTM_PREFILL_T}: logits "
        f"{tuple(logits.shape)} finite; {out['prefill_ms']:.3f} ms (warm; "
        f"the B={XLSTM_PREFILL_B} T={XLSTM_WARM_T} warm-up took "
        f"{warm_s * 1e3:.3f} ms), of which by CUDA events "
        f"{parts.text(out['prefill_ms'])}; peak device memory "
        f"{out['prefill_peak_gb']:.3f} GB; no kernel launched (the "
        f"reference's recurrences are jnp scans)")
    del logits, parts
    torch.cuda.empty_cache()

    # decode_32k's step at B = 128, split into the two kinds of block
    step = build_serve_step(cfg)
    cache = model.init_cache(XLSTM_DECODE_B, XLSTM_PREFILL_T, device=dev)
    state_mb = sum(v.numel() * v.element_size()
                   for v in cache.values()) / 1e6
    tok = tokens[:1, :1].expand(XLSTM_DECODE_B, 1).contiguous()
    out["decode_ms"] = cuda_time_ms(lambda: step(params, cache, tok, 100), 5)
    with timed_calls(("mlstm_block_decode", "slstm_block_decode"),
                     blocks) as parts:
        step(params, cache, tok, 101)
        torch.cuda.synchronize()
    out["decode_mlstm_ms"] = parts.ms("mlstm_block_decode")
    out["decode_slstm_ms"] = parts.ms("slstm_block_decode")
    log(f"{XLSTM_ARCH} decode step B={XLSTM_DECODE_B} (decode_32k's batch; "
        f"the state, {state_mb:.3f} MB, does not grow with the context): "
        f"{out['decode_ms']:.3f} ms (CUDA events, 5 steps), of which (one "
        f"step bracketed by events) {parts.text(out['decode_ms'])}")
    del cache, parts
    torch.cuda.empty_cache()

    # the server: 8 requests of 4-11 prompt tokens, 16 new tokens each
    reqs = make_requests(cfg, SERVE_REQUESTS, SERVE_NEW, seed=SEED)
    reqs, stats = serve(cfg, model, params, reqs)
    check(all(r.done and len(r.generated) == SERVE_NEW for r in reqs)
          and all(0 <= t < cfg.vocab_size for r in reqs
                  for t in r.generated), "xlstm serve: a request failed")
    out["stats"] = stats
    log(f"{XLSTM_ARCH} serve: {len(reqs)} requests (prompts "
        f"{[len(r.prompt) for r in reqs]} tokens, {SERVE_NEW} new each) in "
        f"{stats['steps']} steps, {stats['wall_s'] * 1e3:.3f} ms: "
        f"{stats['tokens_per_s']:.3f} tokens/s, p50 "
        f"{stats['latency_p50_s'] * 1e3:.3f} ms, p99 "
        f"{stats['latency_p99_s'] * 1e3:.3f} ms")

    # prefill against decode at f32 compute: no window limits T here
    cfg32 = cfg.replace(compute_dtype="float32")
    prompt = tokens[:1, :XLSTM_DECODE_T]
    want = build_prefill_step(cfg32)(params, {"tokens": prompt})
    step32 = build_serve_step(cfg32)
    cache = get_model(cfg32).init_cache(1, XLSTM_DECODE_T, device=dev)
    for t in range(XLSTM_DECODE_T):
        got, cache = step32(params, cache, prompt[:, t:t + 1], t)
    rel_max = float((got - want).abs().max() / want.abs().max())
    check(rel_max <= DECODE_REL, f"{XLSTM_ARCH} f32 prefill vs decode: "
          f"relative max {rel_max:.3g}")
    log(f"{XLSTM_ARCH} f32 compute: prefill's last logits at T="
        f"{XLSTM_DECODE_T} == {XLSTM_DECODE_T} decode steps' (relative max "
        f"{rel_max:.3g}, limit {DECODE_REL})")
    del cache, got, want

    # long_500k natively: the O(1) state, 16 steps from 16 short of the end
    specs = model.input_specs("long_500k")["cache"]
    want_bytes = sum(math.prod(s) * torch.finfo(dt).bits // 8
                     for s, dt in specs.values())
    cache = model.init_cache(1, 524_288, device=dev)
    got_bytes = sum(v.numel() * v.element_size() for v in cache.values())
    check(got_bytes == want_bytes, f"long_500k state {got_bytes} bytes, "
          f"specs {want_bytes}")
    times = []
    for i in range(16):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = step(params, cache, tokens[:1, i:i + 1],
                         XLSTM_LONG_START + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(lg).all()),
              f"long_500k step at {XLSTM_LONG_START + i}: non-finite logits")
    out["long_ms"] = 1e3 * sum(times[1:]) / (len(times) - 1)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"{XLSTM_ARCH} long_500k: the state is {got_bytes} bytes a "
        f"sequence (the specs' {want_bytes}) at any position; 16 steps at "
        f"B=1 from position {XLSTM_LONG_START}, logits finite, "
        f"{out['long_ms']:.3f} ms a step after the first (host clock, "
        f"synced); peak device memory since the prefill "
        f"{out['peak_gb']:.3f} GB")
    del params, cache, tokens
    torch.cuda.empty_cache()
    return out


def step_recurrence(q, k, v, log_i, log_f, time_chunk=64):
    """``mlstm_chunkwise``'s oracle: the reference's ``_mlstm_step`` loop
    from the zero state (f32)."""
    from repro_torch.models import blocks
    B, T, H, hd = q.shape
    carry = (q.new_zeros((B, H, hd, hd), dtype=torch.float32),
             q.new_zeros((B, H, hd), dtype=torch.float32),
             q.new_full((B, H), -1e30, dtype=torch.float32))
    hs = []
    for t in range(T):
        carry, h = blocks._mlstm_step(carry, (
            q[:, t].float(), k[:, t].float(), v[:, t].float(), log_i[:, t],
            log_f[:, t]))
        hs.append(h.to(q.dtype))
    return torch.stack(hs, 1)


def xlstm_oracle(dev) -> dict:
    """At full width, f32, B x T = XLSTM_ORACLE_B x XLSTM_ORACLE_T: layer
    0's ``mlstm_block_apply``, the chunkwise form against the step
    recurrence (``mlstm_chunkwise`` swapped for ``step_recurrence``), and
    layer 3's ``slstm_block_apply``, its loops as CUDA-graph chunks
    against plain loops (``blocks._scan`` with one chunk past T): the
    output, one ``torch.func.vjp``'s parameter gradient and one
    ``torch.func.jvp``'s tangent."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import blocks
    from repro_torch.models import transformer as TT
    cfg = get_config(XLSTM_ARCH).replace(compute_dtype="float32")
    torch.cuda.empty_cache()
    flat = TT.init_params(cfg.replace(num_layers=4), SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 121)
    x = torch.randn(XLSTM_ORACLE_B, XLSTM_ORACLE_T, cfg.d_model,
                    generator=gen, device=dev)
    c = torch.randn(x.shape, generator=gen, device=dev)

    def run(block, p):
        """The block's output, its vjp's parameter gradient and its jvp's
        tangent (on every parameter), the seconds and the peak."""
        f = lambda p_: block(cfg, p_, x, None)[0]           # noqa: E731
        gen_t = torch.Generator(device=dev).manual_seed(SEED + 122)
        tan = TT.nest({k: torch.randn(v.shape, generator=gen_t, device=dev)
                       for k, v in TT.flatten(p).items()}, "")
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, pull = torch.func.vjp(f, p)
        (g,) = pull(c)
        _, y_dot = torch.func.jvp(f, (p,), (tan,))
        torch.cuda.synchronize()
        g = torch.cat([t.flatten() for t in TT.flatten(g).values()])
        return (y, torch.cat([g, y_dot.flatten()]),
                time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() / 1e9)

    def swapped(name, fn, block, p):
        real = getattr(blocks, name)
        setattr(blocks, name, fn)
        try:
            return run(block, p)
        finally:
            setattr(blocks, name, real)

    p = TT.nest(flat, "periods.slot0.", 0)
    y, g, t_c, peak_c = run(blocks.mlstm_block_apply, p)
    y_o, g_o, t_o, peak_o = swapped("mlstm_chunkwise", step_recurrence,
                                    blocks.mlstm_block_apply, p)
    out = {"out_l2": rel_l2(y - x, y_o - x), "grad_l2": rel_l2(g, g_o)}
    check(out["out_l2"] <= XLSTM_ORACLE_L2
          and out["grad_l2"] <= XLSTM_ORACLE_GRAD_L2,
          f"chunkwise mLSTM vs the step recurrence: output {out['out_l2']:.3g}"
          f", derivatives {out['grad_l2']:.3g}")
    log(f"{XLSTM_ARCH} layer 0 mLSTM block, f32, B={XLSTM_ORACLE_B} "
        f"T={XLSTM_ORACLE_T}: chunkwise (chunks of 64) == the step "
        f"recurrence: residual branch rel-L2 {out['out_l2']:.3g} (limit "
        f"{XLSTM_ORACLE_L2}), vjp parameter gradient and jvp tangent "
        f"rel-L2 {out['grad_l2']:.3g} (limit {XLSTM_ORACLE_GRAD_L2}); "
        f"forward, vjp and jvp {t_c * 1e3:.3f} ms, peak {peak_c:.3f} GB "
        f"(the step recurrence: {t_o * 1e3:.3f} ms, peak {peak_o:.3f} GB)")

    real_scan = blocks._scan
    p = TT.nest(flat, "periods.slot3.", 0)
    y, g, t_g, _ = run(blocks.slstm_block_apply, p)
    y_p, g_p, t_p, _ = swapped("_scan", lambda *a, **k: real_scan(
        *a, **dict(k, chunk=XLSTM_ORACLE_T + 1)), blocks.slstm_block_apply, p)
    out["slstm_out_l2"] = rel_l2(y - x, y_p - x)
    out["slstm_grad_l2"] = rel_l2(g, g_p)
    same = torch.equal(y, y_p) and torch.equal(g, g_p)
    check(out["slstm_out_l2"] <= XLSTM_GRAPH_L2
          and out["slstm_grad_l2"] <= XLSTM_GRAPH_L2,
          f"sLSTM graphed vs plain loops: output {out['slstm_out_l2']:.3g}, "
          f"derivatives {out['slstm_grad_l2']:.3g}")
    log(f"{XLSTM_ARCH} layer 3 sLSTM block, f32, B={XLSTM_ORACLE_B} "
        f"T={XLSTM_ORACLE_T}: CUDA-graph chunks == plain loops: residual "
        f"branch rel-L2 {out['slstm_out_l2']:.3g}, vjp parameter gradient "
        f"and jvp tangent rel-L2 {out['slstm_grad_l2']:.3g} (limit "
        f"{XLSTM_GRAPH_L2}; bitwise {same}); forward, vjp and jvp "
        f"{t_g * 1e3:.3f} ms, plain loops {t_p * 1e3:.3f} ms")
    del flat, p, x, c, y, g, y_o, g_o, y_p, g_p
    torch.cuda.empty_cache()
    return out


def xlstm_training(dev) -> dict:
    """xlstm-125m at full width and XLSTM_TRAIN_LAYERS layers trained by
    NGHF with ``--cg-fused`` through the CLI, checkpointed and resumed;
    one update through the kernel path against the plain path; Adam
    through the CLI."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch import train as T
    from repro_torch.models.registry import get_model
    cfg = get_config(XLSTM_ARCH).replace(num_layers=XLSTM_TRAIN_LAYERS)
    model = get_model(cfg)
    check(model.param_count() == XLSTM_TRAIN_PARAMS,
          f"{XLSTM_ARCH} at {XLSTM_TRAIN_LAYERS} layers: "
          f"{model.param_count()} parameters")
    per_update = LM_CG_ITERS + LM_NG_ITERS
    log(f"{XLSTM_ARCH} NGHF at full width, {XLSTM_TRAIN_LAYERS} of 12 "
        f"layers ({XLSTM_TRAIN_PARAMS} parameters); CLI "
        f"{' '.join(XLSTM_TRAIN_ARGS)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = cli_checkpointed(f"CLI {XLSTM_ARCH}", XLSTM_TRAIN_ARGS, per_update)

    # the kernel path against the plain path, from the CLI's start
    torch.cuda.empty_cache()
    params = model.init(0, device=dev)
    batch = lm_batch(0, batch=XLSTM_TRAIN_BATCH, seq_len=XLSTM_TRAIN_SEQ,
                     vocab=cfg.vocab_size, device=dev)
    out.update(lm_paths_compared(XLSTM_ARCH, cfg, params, batch, dev,
                                 traced=curvature_product(cfg, params,
                                                          batch, dev)))
    del params, batch
    torch.cuda.empty_cache()

    # Adam through the CLI, 3 steps
    reset_counts()
    adam = T.main(["--arch", XLSTM_ARCH, "--optimizer", "adam",
                   "--layers", str(XLSTM_TRAIN_LAYERS), "--batch",
                   str(XLSTM_TRAIN_BATCH), "--seq", str(XLSTM_TRAIN_SEQ),
                   "--steps", "3", "--device", "cuda"])
    check_lm_updates(f"CLI {XLSTM_ARCH} Adam", adam, read_counts(),
                     swa_counts(), [0, 1, 2], 0)
    out["adam_s"] = [m["time_s"] for m in adam]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    return out


def curvature_product(cfg, params, batch, dev) -> tuple:
    """One Gauss-Newton product of an NGHF update on ``batch`` (a jvp and
    a vjp through the model on its CG batch, a quarter of ``batch``), as
    (name, call) for ``lm_paths_compared``'s trace.  An update at
    xlstm-125m's T 512 ran about 1.8 M kernels (the sLSTM's steps), each
    a profiler event that the host reads back one by one; a product is
    one of the update's 12 and most of its time."""
    from repro_torch.core.curvature import make_curvature_ops
    from repro_torch.launch.steps import build_step, cg_sub_batch
    _, opt = build_step(cfg, "nghf", cg_frac=4)
    cg = cg_sub_batch(batch, 4, 1)
    ops = make_curvature_ops(opt.forward_fn, opt.loss_spec, params, cg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 123)
    v = {k: torch.randn(p.shape, generator=gen, device=dev)
         for k, p in params.items()}
    return (f"curvature product (B x T = {tuple(cg['tokens'].shape)}, "
            f"the CG batch of the update above)", lambda: ops.gnvp(v))


def phase_xlstm(dev) -> dict:
    """Phase 12: the xLSTM arch; the seconds of its three parts."""
    out, t0 = {}, time.perf_counter()
    for name, part in (("serving", xlstm_serving), ("oracle", xlstm_oracle),
                       ("training", xlstm_training)):
        t = time.perf_counter()
        out[name] = part(dev)
        out[f"{name}_s"] = time.perf_counter() - t
    log(f"{XLSTM_ARCH} phase 12: "
        + ", ".join(f"{k} {out[f'{k}_s']:.3f} s"
                    for k in ("serving", "oracle", "training"))
        + f", total {time.perf_counter() - t0:.3f} s")
    return out


def xlstm_cg_times(xl: dict, dev) -> dict:
    """``cg_fused_update`` at xlstm-125m's N, beside phase 12's
    launches."""
    tr = xl["training"]
    return cg_times_at(XLSTM_TRAIN_PARAMS, tr["launches"], tr["updates"],
                       "xlstm", f"{XLSTM_ARCH}, {XLSTM_TRAIN_LAYERS} layers",
                       dev)


# ---------------------------------------------------------------------------
# phase 13: training recurrentgemma-9b and mixtral-8x22b — the windowed
# attention's derivative kernels and the differentiable RG-LRU scan
# ---------------------------------------------------------------------------

# the derivative kernels: no TPU kernel; the reference differentiates its
# jnp windowed_attention by autodiff.  dq, dk/dv and the jvp take bf16 on
# the tensor cores (BWD_SM90_SOURCE), f32 on the CUDA cores (BWD_SOURCE)
BWD_KERNELS = ("swa_attention_dq", "swa_attention_dkdv", "swa_attention_jvp")
BWD_SOURCE = "src/repro_torch/kernels/csrc/swa_attention_bwd.cu"
BWD_SM90_SOURCE = "src/repro_torch/kernels/csrc/swa_attention_bwd_sm90.cu"
BWD_REFERENCE = "src/repro/models/layers.py:232"
# recurrentgemma-9b's training shape (train_4k, B 256 -> 2) and mixtral-
# 8x22b's attention geometry at T 8192: (B, T, H, K, hd, window)
SWA_TRAIN = (2, 4096, 16, 1, 256, 2048)
SWA_MIXTRAL = (1, 8192, 48, 8, 128, 4096)
# kernel vs plain version, relative L2 per tensor: f32 1e-5 (the same f32
# arithmetic, sums in another order); bf16 no farther from the plain
# version on the inputs upcast to f32 than the plain version in bf16 is,
# x 1.5 (phase 7's rule), + 1e-6 (where the bf16 plain result is exact,
# as window 0's tangent tv is, the kernel keeps its f32 sums' rounding)
BWD_F32_REL_L2 = 1e-5
BWD_BF16_FACTOR = 1.5
BWD_BF16_FLOOR = 1e-6
# recurrentgemma-9b at full width, depth 38 -> 3 (rglru, rglru, local: the
# first depth with a windowed layer), trained by SGD at B 2 x T 4096
RG_TRAIN_LAYERS = 3
RG_TRAIN_PARAMS = 2_753_638_400
RG_TRAIN_BATCH, RG_TRAIN_SEQ, RG_TRAIN_STEPS = 2, 4096, 3
RG_TRAIN_LR = 0.3                  # launch.train's SGD default
# one step's gradient, kernel path vs plain path (attention's plain
# version), relative L2 over every leaf: both run bf16 activations, and
# the forward kernels' outputs differ from the plain version's by a bf16
# ulp in under 1 % of the entries (phase 2)
RG_GRAD_REL_L2 = 2e-2
# NGHF at the smoke configs (window 16) at T 64 > window, B 8 (CG batch 2);
# mixtral-8x22b's smoke depth cut from 2 layers to 1 (one windowed MoE
# layer still runs every derivative kernel) to keep the script in its time
SMOKE_TRAIN_ARCHS = ("recurrentgemma-9b", "mixtral-8x22b")
SMOKE_TRAIN_BATCH, SMOKE_TRAIN_SEQ = 8, 64
SMOKE_TRAIN_LAYERS = {"mixtral-8x22b": 1}


def bwd_counts() -> tuple:
    """(tensor-core dq, dk/dv, jvp, CUDA-core dq, dk/dv, jvp) launches so
    far."""
    from repro_torch.kernels import swa_attention as SWA
    f, j = SWA.swa_attention_vjp, SWA.swa_attention_jvp
    return (f.dq_launches, f.dkdv_launches, j.launches,
            f.cuda_core_dq_launches, f.cuda_core_dkdv_launches,
            j.cuda_core_launches)


def set_bwd_counts(n: tuple) -> None:
    from repro_torch.kernels import swa_attention as SWA
    f, j = SWA.swa_attention_vjp, SWA.swa_attention_jvp
    (f.dq_launches, f.dkdv_launches, j.launches, f.cuda_core_dq_launches,
     f.cuda_core_dkdv_launches, j.cuda_core_launches) = n


def bwd_rel(got, plain, plain32, dtype) -> tuple:
    """(kernel's relative L2, its limit) for one tensor: against the plain
    version in f32; against the f32 plain result in bf16."""
    if dtype == torch.float32:
        return rel_l2(got, plain), BWD_F32_REL_L2
    return (rel_l2(got, plain32),
            BWD_BF16_FACTOR * rel_l2(plain, plain32) + BWD_BF16_FLOOR)


def check_bwd_case(dev, shape, dtype, seed: int, errs: dict,
                   core: bool = False) -> dict:
    """The dq, dk/dv and jvp kernels (the CUDA-core ones if ``core``, else
    those the dtype routes to) against their plain versions at one shape,
    each bitwise on a repeat and counted on its route's counters; returns
    the inputs for timing."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import swa_attention as SWA
    q, k, v = swa_inputs(dev, shape, dtype, seed)
    g, tq, tk, tv = (torch.randn_like(x) for x in (q, q, k, v))
    w = shape[-1]
    tc = int(dtype == torch.bfloat16 and shape[4] % 8 == 0 and not core)
    route = "tensor-core" if tc else "CUDA-core"
    tag = "x".join(map(str, shape)) + f"_{str(dtype)[6:]}"
    n = bwd_counts()
    got, again = (SWA.swa_attention_vjp(q, k, v, g, w, core=core)
                  + (SWA.swa_attention_jvp(q, k, v, tq, tk, tv, w,
                                           core=core),)
                  for _ in range(2))
    plain = R.swa_attention_vjp_ref(q, k, v, g, w) \
        + (R.swa_attention_jvp_ref(q, k, v, tq, tk, tv, w),)
    check(bwd_counts() == tuple(c + 2 * (tc if i < 3 else 1 - tc)
                                for i, c in enumerate(n)),
          f"swa_attention derivatives[{tag}]: launches {bwd_counts()} from "
          f"{n}; want two of each {route} kernel")
    if dtype == torch.float32:
        plain32 = plain
    else:
        up = [x.float() for x in (q, k, v, g, tq, tk, tv)]
        plain32 = R.swa_attention_vjp_ref(*up[:4], w) \
            + (R.swa_attention_jvp_ref(*up[:3], *up[4:], w),)
    torch.cuda.synchronize()
    parts = []
    for name, a, b, p, p32 in zip(("dq", "dk", "dv", "dO"), got, again,
                                  plain, plain32):
        check(a.dtype == p.dtype == dtype and a.shape == p.shape
              and bool(torch.isfinite(a).all()),
              f"swa_attention {name}[{tag}]: {a.dtype} {tuple(a.shape)}, "
              f"plain {p.dtype} {tuple(p.shape)}, finite "
              f"{bool(torch.isfinite(a).all())}")
        check(torch.equal(a, b), f"swa_attention {name}[{tag}] {route}: two "
              f"launches gave other bits")
        rel, limit = bwd_rel(a, p, p32, dtype)
        check(rel <= limit, f"swa_attention {name}[{tag}] {route}: rel-L2 "
              f"{rel:.3g} > {limit:.3g}")
        kern = {"dq": BWD_KERNELS[0], "dk": BWD_KERNELS[1],
                "dv": BWD_KERNELS[1], "dO": BWD_KERNELS[2]}[name]
        if not tc:
            kern += "_cuda_core"
        d = float((a.float() - p.float()).abs().max()) if a.numel() else 0.0
        errs[f"{kern}[{tag}:{name}]"] = d
        parts.append(f"{name} {rel:.3g} (limit {limit:.3g}, max |d| {d:.3g})")
    log(f"swa_attention derivatives == plain at (B,T,H,K,hd,window)="
        f"{shape} {dtype}, {route} dq, dk/dv and jvp: rel-L2 "
        + ", ".join(parts)
        + "; a repeat launch bitwise")
    return {"q": q, "k": k, "v": v, "g": g, "tq": tq, "tk": tk, "tv": tv}


def bwd_work(shape, dtype) -> dict:
    """(bytes, flops) of each derivative kernel: every input read once and
    every output written once (dq's (B, H, T) f32 log-sum-exp and D
    included); the products over the band's (query, key) pairs, 2 hd
    flops each: dq S, dP and dS K (6 hd); dk/dv S, dP, dS^T q and P^T g
    (8 hd); jvp S, its tangent's two products, P V, (P ds) V and P tv
    (12 hd)."""
    B, T, H, K, hd, w = shape
    size = torch.finfo(dtype).bits // 8
    side = 8 * B * H * T
    pairs = swa_work(shape, dtype)[1] // (4 * B * H * hd)
    per = B * H * hd * pairs
    return {BWD_KERNELS[0]: (size * B * T * (3 * H + 2 * K) * hd + side,
                             6 * per),
            BWD_KERNELS[1]: (size * B * T * (2 * H + 4 * K) * hd + side,
                             8 * per),
            BWD_KERNELS[2]: (size * B * T * (3 * H + 4 * K) * hd, 12 * per)}


def sdpa_backward(x: dict, window: int):
    """``scaled_dot_product_attention``'s backward with the band mask (the
    yardstick, never on the port's path): a call computing (dq, dk, dv)
    for the cotangent g, or None where it does not run."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q, k, v, g = x["q"], x["k"], x["v"], x["g"]
    B, T, H, hd = q.shape
    G = H // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (t.transpose(1, 2).repeat_interleave(G, dim=1).detach()
              .requires_grad_() for t in (k, v))
    pos = torch.arange(T, device=q.device)
    mask = ((pos[None, :] <= pos[:, None])
            & (pos[None, :] >= pos[:, None] - window))
    gt = g.transpose(1, 2)
    try:
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)
        torch.cuda.synchronize()
    except RuntimeError as exc:
        log(f"scaled_dot_product_attention backward at {tuple(q.shape)}: "
            f"{str(exc).splitlines()[0][:200]}")
        return None
    return lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                       retain_graph=True)


def sdpa_jvp(x: dict, window: int, want):
    """``torch.func.jvp`` through ``scaled_dot_product_attention`` with the
    band mask, under its efficient and cuDNN backends (the yardstick,
    never on the port's path): a call computing the output's tangent for
    (tq, tk, tv), or None where PyTorch does not run it; its first result's
    relative L2 from ``want`` (the f32 plain jvp) is logged."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q, k, v = x["q"], x["k"], x["v"]
    B, T, H, hd = q.shape
    G = H // k.shape[2]
    heads = (lambda t: t.transpose(1, 2),
             lambda t: t.transpose(1, 2).repeat_interleave(G, dim=1))
    primals = tuple(heads[i > 0](x[n]) for i, n in enumerate("qkv"))
    tangents = tuple(heads[i > 0](x[n])
                     for i, n in enumerate(("tq", "tk", "tv")))
    pos = torch.arange(T, device=q.device)
    mask = ((pos[None, :] <= pos[:, None])
            & (pos[None, :] >= pos[:, None] - window))

    def f(a, b, c):
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            return F.scaled_dot_product_attention(a, b, c, attn_mask=mask)

    def call():
        return torch.func.jvp(f, primals, tangents)[1]

    try:
        out = call().transpose(1, 2)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        log(f"scaled_dot_product_attention jvp (torch.func.jvp, band mask) "
            f"at {tuple(q.shape)}: {type(exc).__name__}: "
            f"{str(exc).splitlines()[0][:200]}")
        return None
    log(f"scaled_dot_product_attention jvp (torch.func.jvp, band mask) at "
        f"{tuple(q.shape)}: rel-L2 {rel_l2(out, want):.4g} from the f32 "
        f"plain jvp")
    return call


def bwd_times(x: dict, shape) -> dict:
    """The derivative kernels on both routes timed in turns (ABC.. ..CBA,
    CUDA events) with their plain versions and SDPA's backward and jvp
    where PyTorch runs them, at one shape; the comparison launches are not
    counted."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import swa_attention as SWA
    n = bwd_counts()
    w = shape[-1]
    q, k, v, g = x["q"], x["k"], x["v"], x["g"]
    tq, tk, tv = x["tq"], x["tk"], x["tv"]
    _, lse, dd = SWA.launch_dq(q, k, v, g, w)
    _, lse_c, dd_c = SWA.launch_dq(q, k, v, g, w, True)
    fns = {BWD_KERNELS[0]: (lambda: SWA.launch_dq(q, k, v, g, w), 5),
           BWD_KERNELS[1]: (lambda: SWA.launch_dkdv(q, k, v, g, lse, dd,
                                                    w), 5),
           "cuda_core_dq": (lambda: SWA.launch_dq(q, k, v, g, w, True), 2),
           "cuda_core_dkdv": (lambda: SWA.launch_dkdv(q, k, v, g, lse_c,
                                                      dd_c, w, True), 2),
           BWD_KERNELS[2]: (lambda: SWA.swa_attention_jvp(q, k, v, tq, tk,
                                                          tv, w), 5),
           "cuda_core_jvp": (lambda: SWA.swa_attention_jvp(
               q, k, v, tq, tk, tv, w, core=True), 2),
           "plain_vjp": (lambda: R.swa_attention_vjp_ref(q, k, v, g, w), 1),
           "plain_jvp": (lambda: R.swa_attention_jvp_ref(q, k, v, tq, tk,
                                                         tv, w), 1),
           "library_vjp": (sdpa_backward(x, w), 2),
           "library_jvp": (sdpa_jvp(x, w, R.swa_attention_jvp_ref(
               *(x[n].float() for n in ("q", "k", "v", "tq", "tk", "tv")),
               w)), 2)}
    order = [name for name in fns if fns[name][0] is not None]
    turns: dict = {name: [] for name in order}
    for name in order + order[::-1]:
        fn, reps = fns[name]
        turns[name].append(cuda_time_ms(fn, reps))
    set_bwd_counts(n)
    t = {name: sum(ms) / len(ms) for name, ms in turns.items()}
    out = {}
    for name, (byt, flops) in bwd_work(shape, q.dtype).items():
        b_ms, b_by = swa_bound(byt, flops)
        kind = "jvp" if name == BWD_KERNELS[2] else "vjp"
        core = t["cuda_core_" + name.split("_")[-1]]
        out[name] = {"ms": t[name], "bound_ms": b_ms, "bound_by": b_by,
                     "plain_ms": t["plain_" + kind],
                     "library_ms": t.get("library_" + kind),
                     "tflops": flops / t[name] * 1e-9, "cuda_core_ms": core,
                     "cuda_core_tflops": flops / core * 1e-9}
    pair, core_pair = (t[BWD_KERNELS[0]] + t[BWD_KERNELS[1]],
                       t["cuda_core_dq"] + t["cuda_core_dkdv"])
    lib, lib_jvp = t.get("library_vjp"), t.get("library_jvp")
    jvp, core_jvp = t[BWD_KERNELS[2]], t["cuda_core_jvp"]
    log(f"swa_attention derivatives timed at (B,T,H,K,hd,window)={shape} "
        f"{q.dtype}: " + "; ".join(
            f"{k} {v['ms']:.4f} ms ({v['tflops']:.3f} TFLOP/s useful, "
            f"bound {v['bound_ms']:.4f} ms by {v['bound_by']})"
            + f", CUDA-core {v['cuda_core_ms']:.4f} ms"
            for k, v in out.items())
        + f"; tensor-core dq + dk/dv {pair:.4f} ms, CUDA-core "
        f"{core_pair:.4f} ms ({core_pair / pair:.2f}x), SDPA backward "
        + (f"{lib:.4f} ms ({lib / pair:.2f}x the pair)" if lib else "none")
        + f"; tensor-core jvp {jvp:.4f} ms, CUDA-core {core_jvp:.4f} ms "
        f"({core_jvp / jvp:.2f}x), SDPA jvp "
        + (f"{lib_jvp:.4f} ms ({lib_jvp / jvp:.2f}x)" if lib_jvp else "none")
        + f"; plain vjp {t['plain_vjp']:.4f} ms, plain jvp "
        f"{t['plain_jvp']:.4f} ms; turns (ms) "
        + ", ".join(f"{k} {[round(y, 3) for y in v]}"
                    for k, v in turns.items()))
    return out


def bwd_kernel_checks(dev, errs: dict) -> dict:
    """(a): phase 2's adversarial shapes, then the two full geometries,
    each checked on both backward routes; the full ones timed.  Returns
    {shape key: times}."""
    times = {}
    cases = SWA_CASES + ((SWA_TRAIN, torch.bfloat16),
                         (SWA_MIXTRAL, torch.bfloat16))
    for i, (shape, dtype) in enumerate(cases):
        x = check_bwd_case(dev, shape, dtype, SEED + 130 + i, errs)
        # the other backward route on the same shape: the CUDA-core pair
        # on the bf16 inputs, or the tensor-core pair on the f32 case's
        # shape in bf16
        if dtype == torch.bfloat16:
            check_bwd_case(dev, shape, dtype, SEED + 130 + i, errs, True)
        else:
            check_bwd_case(dev, shape, torch.bfloat16, SEED + 130 + i, errs)
        if shape in (SWA_TRAIN, SWA_MIXTRAL):
            times[shape] = bwd_times(x, shape)
        del x
        torch.cuda.empty_cache()
    return times


def rg_sgd_training(dev) -> dict:
    """(b): recurrentgemma-9b at full width and 3 layers trained by SGD
    through ``build_step``, 3 steps at B 2 x T 4096: finite loss, one
    forward, dq and dk/dv launch a step (the one local layer), no jvp;
    then one step's gradient through the kernels against the plain path."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.curvature import grad_and_loss
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import swa_attention as SWA
    from repro_torch.launch.steps import build_step, lm_forward
    from repro_torch.losses.chunked_lm import ChunkedCELoss
    from repro_torch.models.registry import get_model
    cfg = get_config(LM_ARCH).replace(num_layers=RG_TRAIN_LAYERS)
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(SEED, device=dev)
    n_params = sum(p.numel() for p in params.values())
    check(n_params == RG_TRAIN_PARAMS == model.param_count(),
          f"{LM_ARCH} at {RG_TRAIN_LAYERS} layers has {n_params} parameters")
    step, opt = build_step(cfg, "sgd", lr=RG_TRAIN_LR)
    state = opt.init(params)
    local = sum(k == "local" for k in (cfg.block_pattern * RG_TRAIN_LAYERS)
                [:RG_TRAIN_LAYERS])

    def batch(i):
        return lm_batch(i, batch=RG_TRAIN_BATCH, seq_len=RG_TRAIN_SEQ,
                        vocab=cfg.vocab_size, device=dev)

    # the main path: counts at 0 just before each step, read just after
    times, launches = [], {"fwd": 0, "dq": 0, "dkdv": 0, "jvp": 0}
    for i in range(RG_TRAIN_STEPS):
        b = batch(i)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        m = {k: float(v) for k, v in m.items()}
        n = (SWA.swa_attention.launches, SWA.swa_attention.cuda_core_launches)
        dq, dkdv, jvp, cdq, cdkdv, cjvp = bwd_counts()
        check(n == (local, 0) and (dq, dkdv, jvp, cdq, cdkdv, cjvp)
              == (local, local, 0, 0, 0, 0),
              f"{LM_ARCH} SGD step {i}: forward launches {n}, dq {dq}, "
              f"dk/dv {dkdv}, jvp {jvp}, CUDA-core dq {cdq}, dk/dv "
              f"{cdkdv}, jvp {cjvp}; want {local} tensor-core, {local} "
              f"tensor-core dq and dk/dv, no jvp, no CUDA-core kernel")
        check(read_counts() == {k: 0 for k in read_counts()},
              f"{LM_ARCH} SGD step {i}: lattice/CG launches {read_counts()}")
        check(np.isfinite(m["loss"]), f"{LM_ARCH} SGD step {i}: loss "
              f"{m['loss']}")
        for key, c in zip(("fwd", "dq", "dkdv", "jvp"), (n[0], dq, dkdv,
                                                         jvp)):
            launches[key] += c
        log(f"{LM_ARCH} ({RG_TRAIN_LAYERS} layers, {n_params} parameters) "
            f"SGD step {i} at B {RG_TRAIN_BATCH} x T {RG_TRAIN_SEQ}: "
            f"{times[-1] * 1e3:.3f} ms, loss {m['loss']:.6f}, acc "
            f"{m['acc']:.6f}, grad norm {m['grad_norm']:.4g}; launches: "
            f"forward {n[0]} (tensor-core), dq {dq}, dk/dv {dkdv} "
            f"(tensor-core), jvp {jvp}")
    peak = torch.cuda.max_memory_allocated()
    del state
    # one step's gradient, kernel path vs plain path, same parameters
    fwd, loss = lm_forward(cfg, model), ChunkedCELoss()
    b = dict(batch(RG_TRAIN_STEPS), labels=batch(RG_TRAIN_STEPS)["tokens"])
    l_k, _, g_k = grad_and_loss(fwd, loss, params, b)
    with plain_attention():
        n = bwd_counts()
        l_p, _, g_p = grad_and_loss(fwd, loss, params, b)
        check(bwd_counts() == n, "the plain path launched a derivative "
              "kernel")
    num = sum(float(((g_k[k].float() - g_p[k].float()) ** 2).sum())
              for k in g_p)
    den = sum(float((g_p[k].float() ** 2).sum()) for k in g_p)
    rel = (num / den) ** 0.5
    check(rel <= RG_GRAD_REL_L2, f"{LM_ARCH} gradient kernel vs plain path "
          f"rel-L2 {rel:.3g} > {RG_GRAD_REL_L2}")
    log(f"{LM_ARCH} gradient, kernel path == plain path (attention's plain "
        f"version under autograd on the card): rel-L2 {rel:.4g} over "
        f"{len(g_p)} leaves (limit {RG_GRAD_REL_L2}), loss {float(l_k):.6f} "
        f"vs {float(l_p):.6f}; SGD steps "
        f"{[round(t * 1e3, 3) for t in times]} ms, peak device memory "
        f"{peak / 1e9:.3f} GB")
    del params, g_k, g_p
    torch.cuda.empty_cache()
    return {"step_s": times, "peak": peak, "grad_rel": rel,
            "launches": launches}


def smoke_nghf(dev) -> dict:
    """(c): NGHF at the smoke configs (T 64 past the window of 16), one
    update per curvature mode: the kernel path (the attention kernels,
    fused CG) against the plain path (attention's plain version, unfused
    CG): the same decision, or a tie within the paths' spread, and the
    last iterate's Δθ within LM_DELTA_REL_L2.  In ``rematvp`` the kernel
    path also runs with the CUDA-core jvp (``cuda_core_jvp``), and its
    Δθ from both is printed: the spread of two f32-accurate jvps."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models.registry import get_model
    out = {"jvp": 0, "dq": 0, "dkdv": 0}
    for arch in SMOKE_TRAIN_ARCHS:
        cfg = get_config(arch).smoke()
        cfg = cfg.replace(num_layers=SMOKE_TRAIN_LAYERS.get(arch,
                                                            cfg.num_layers))
        params = get_model(cfg).init(SEED, device=dev)
        b = lm_batch(0, batch=SMOKE_TRAIN_BATCH, seq_len=SMOKE_TRAIN_SEQ,
                     vocab=cfg.vocab_size, device=dev)
        b = dict(b, labels=b["tokens"])
        for mode in ("rematvp", "linearize"):
            tag = f"{arch} smoke ({cfg.sliding_window} window, T " \
                  f"{SMOKE_TRAIN_SEQ}) NGHF {mode}"
            kw = {"curvature_mode": mode}
            reset_counts()
            _, m_k, t_k = lm_one_update(cfg, params, b, True, **kw)
            dq, dkdv, jvp, cdq, cdkdv, cjvp = bwd_counts()
            check(min(dq, dkdv, jvp) > 0 and cdq == cdkdv == cjvp == 0,
                  f"{tag}: derivative kernel launches dq {dq}, dk/dv "
                  f"{dkdv}, jvp {jvp} (tensor-core), CUDA-core dq {cdq}, "
                  f"dk/dv {cdkdv}, jvp {cjvp}")
            for key, c in zip(("dq", "dkdv", "jvp"), (dq, dkdv, jvp)):
                out[key] += c
            with plain_attention():
                _, m_p, t_p = lm_one_update(cfg, params, b, False, **kw)
            check(bwd_counts() == (dq, dkdv, jvp, cdq, cdkdv, cjvp),
                  f"{tag}: the plain path launched a derivative kernel")
            text = same_choice(tag, m_k, m_p)
            new_k, _, _ = lm_one_update(cfg, params, b, True,
                                        eval_candidates=False, **kw)
            with plain_attention():
                new_p, _, _ = lm_one_update(cfg, params, b, False,
                                            eval_candidates=False, **kw)
            rel = delta_rel_l2(new_k, new_p, params)
            check(rel <= LM_DELTA_REL_L2, f"{tag}: last-iterate Δθ kernel "
                  f"vs plain path rel-L2 {rel:.3g}")
            if mode == "rematvp":
                with cuda_core_jvp():
                    new_c, _, _ = lm_one_update(cfg, params, b, True,
                                                eval_candidates=False, **kw)
                text += (f"; with the CUDA-core jvp the kernel path's Δθ is "
                         f"{delta_rel_l2(new_c, new_p, params):.4g} from "
                         f"the plain path's, "
                         f"{delta_rel_l2(new_k, new_c, params):.4g} from "
                         f"the tensor-core jvp's")
            log(f"{tag}: kernel path == plain path: {text}; last-iterate "
                f"Δθ rel-L2 {rel:.3g} (limit {LM_DELTA_REL_L2}); kernel "
                f"update {t_k * 1e3:.3f} ms (tensor-core dq {dq}, dk/dv "
                f"{dkdv}, jvp {jvp} launches; CUDA-core none), plain "
                f"{t_p * 1e3:.3f} ms")
        del params
    return out


def phase_rg_train(dev, errs: dict) -> dict:
    t0 = time.perf_counter()
    times = bwd_kernel_checks(dev, errs)
    t1 = time.perf_counter()
    sgd = rg_sgd_training(dev)
    t2 = time.perf_counter()
    nghf = smoke_nghf(dev)
    t3 = time.perf_counter()
    log(f"phase 13: {t3 - t0:.3f} s (kernel checks and times "
        f"{t1 - t0:.3f}, {LM_ARCH} SGD {t2 - t1:.3f}, smoke NGHF "
        f"{t3 - t2:.3f})")
    return {"times": times, "sgd": sgd, "nghf": nghf}


def bwd_entries(rg: dict, errs: dict) -> list:
    """The derivative kernels' rows of the ``{"kernels": ...}`` line: time
    at recurrentgemma-9b's training shape, ``mixtral_*`` keys at mixtral's
    geometry; launches on phase 13's main paths (the SGD steps and the
    smoke NGHF kernel-path updates, bf16: the tensor-core kernels); the
    ``cuda_core_*`` keys time each one's CUDA-core kernel (f32's route) on
    the same bf16 inputs."""
    sgd, nghf = rg["sgd"]["launches"], rg["nghf"]
    launches = {BWD_KERNELS[0]: sgd["dq"] + nghf["dq"],
                BWD_KERNELS[1]: sgd["dkdv"] + nghf["dkdv"],
                BWD_KERNELS[2]: sgd["jvp"] + nghf["jvp"]}
    rows = []
    for name in BWD_KERNELS:
        t = rg["times"][SWA_TRAIN][name]
        mx = rg["times"][SWA_MIXTRAL][name]
        rows.append({
            "name": name, "route": "cuda", "source": BWD_SM90_SOURCE,
            "replaces": BWD_REFERENCE,
            "note": "no TPU kernel: the reference differentiates its jnp "
                    "windowed_attention by autodiff",
            "launches": launches[name],
            "max_abs_err": max(v for k, v in errs.items()
                               if k.startswith(name + "[")),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": f"B,T,H,K,hd,window={list(SWA_TRAIN)} bf16",
            "mixtral_ms": mx["ms"], "mixtral_plain_ms": mx["plain_ms"],
            "mixtral_bound_ms": mx["bound_ms"],
            "mixtral_library_ms": mx["library_ms"],
            "mixtral_shape": f"B,T,H,K,hd,window={list(SWA_MIXTRAL)} bf16",
            "cuda_core_source": BWD_SOURCE, "cuda_core_ms": t["cuda_core_ms"],
            "mixtral_cuda_core_ms": mx["cuda_core_ms"]})
    return rows


# ---------------------------------------------------------------------------
# LM serving: sliding-window attention and recurrentgemma-9b
# ---------------------------------------------------------------------------

def swa_inputs(dev, shape, dtype, seed: int):
    B, T, H, K, hd, _ = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, T, h, hd, generator=gen, device=dev).to(dtype)
            for h in (H, K, K)]


def compare_swa(tag: str, got, want, dtype, errs: dict) -> float:
    atol, rtol = SWA_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    bad = diff > atol + rtol * want.float().abs()
    check(got.dtype == want.dtype == dtype and got.shape == want.shape,
          f"swa_attention[{tag}]: {got.dtype} {tuple(got.shape)} vs plain "
          f"{want.dtype} {tuple(want.shape)}")
    check(not bool(bad.any()),
          f"swa_attention[{tag}]: {int(bad.sum())} entries outside |d| <= "
          f"{atol} + {rtol:.3g}|ref| (max |d| {float(diff.max()):.3g})")
    if dtype == torch.bfloat16:
        share = float((got != want).float().mean())
        check(share <= SWA_BF16_DIFF_SHARE,
              f"swa_attention[{tag}]: {share:.3g} of the bf16 entries differ "
              f"from the plain version's (limit {SWA_BF16_DIFF_SHARE})")
    err = float(diff.max())
    errs[f"swa_attention[{tag}]"] = err
    return err


def phase_swa_kernel(dev, errs: dict) -> None:
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import swa_attention as SWA
    for i, (shape, dtype) in enumerate(SWA_CASES + ((SWA_FULL,
                                                     torch.bfloat16),)):
        q, k, v = swa_inputs(dev, shape, dtype, SEED + 30 + i)
        window = shape[-1]
        got = SWA.swa_attention(q, k, v, window)
        again = SWA.swa_attention(q, k, v, window)
        want = R.swa_attention_ref(q, k, v, window)
        torch.cuda.synchronize()
        tag = "x".join(map(str, shape)) + f"_{str(dtype)[6:]}"
        err = compare_swa(tag, got, want, dtype, errs)
        check(torch.equal(got, again),
              f"swa_attention[{tag}]: two launches gave other bits")
        log(f"swa_attention == plain at (B,T,H,K,hd,window)={shape} "
            f"{dtype}: max |d| {err:.3g} (atol, rtol {SWA_TOL[dtype]}), "
            f"{float((got != want).float().mean()):.3g} of the entries "
            f"differ; a repeat launch bitwise")
    ctl = swa_p_bf16(q, k, v, window)
    log(f"control, the plain version with P rounded to bf16, at {shape}: "
        f"max |d| {float((ctl.float() - want.float()).abs().max()):.3g} "
        f"from the plain version, "
        f"{float((ctl != want).float().mean()):.3g} of the entries differ")
    del q, k, v, got, again, want, ctl
    torch.cuda.empty_cache()


def swa_p_bf16(q, k, v, window: int, *, q_chunk: int = 512,
               q_offset: int = 0):
    """A control, never on the port's path: ``ref.swa_attention_ref``
    with P rounded to bf16 before P.V, the bf16-only fault a faster
    kernel could make (the reference multiplies an f32 P)."""
    import math
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    for t0 in range(0, T, q_chunk):
        t1 = min(t0 + q_chunk, T)
        lo = max(0, q_offset + t0 - window)
        hi = min(S, q_offset + t1)
        qb = q[:, t0:t1].float().reshape(B, t1 - t0, K, H // K, hd)
        s = torch.einsum("bqkgd,bskd->bkgqs", qb, k[:, lo:hi].float()) \
            / math.sqrt(hd)
        qpos = q_offset + torch.arange(t0, t1, device=q.device)[:, None]
        kpos = torch.arange(lo, hi, device=q.device)[None, :]
        s = s.masked_fill((kpos > qpos) | (kpos <= qpos - window - 1), -1e30)
        p = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
        o = torch.einsum("bkgqs,bskd->bqkgd", p, v[:, lo:hi].float())
        out[:, t0:t1] = o.reshape(B, t1 - t0, H, hd).to(q.dtype)
    return out


class plain_attention:
    """Within the block, the model's windowed attention runs ``fn`` on
    the card, by default the kernel's plain version (the comparison paths
    only; the port's wrapper itself never falls back)."""

    def __init__(self, fn=None):
        self._fn = fn

    def __enter__(self):
        from repro_torch.kernels import ref as R
        from repro_torch.models import layers
        self._saved = layers.swa_attention
        layers.swa_attention = self._fn or R.swa_attention_ref

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers.swa_attention = self._saved


class cuda_core_jvp:
    """Within the block, the windowed attention's jvp launches the
    CUDA-core kernel whatever the dtype (a comparison path only: its
    launches are counted on the stand-in, not on the wrapper)."""

    def __enter__(self):
        from repro_torch.kernels import swa_attention as SWA
        self._saved = saved = SWA.swa_attention_jvp

        def core(*args, **kw):
            return saved(*args, **kw, core=True)

        core.launches = core.cuda_core_launches = 0
        SWA.swa_attention_jvp = core

    def __exit__(self, *exc):
        from repro_torch.kernels import swa_attention as SWA
        SWA.swa_attention_jvp = self._saved


def rel_l2(a, b) -> float:
    """||a - b|| / ||b||; 0 for two zero tensors, inf for b = 0 alone."""
    a, b = a.float(), b.float()
    num = float(torch.linalg.vector_norm(a - b))
    den = float(torch.linalg.vector_norm(b))
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def phase_lm(dev) -> dict:
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import swa_attention as SWA
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models import blocks
    from repro_torch.models import transformer as TT
    from repro_torch.models.registry import get_model
    cfg = get_config(LM_ARCH)
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in params.values())
    check(n_params == LM_PARAMS == model.param_count(),
          f"{LM_ARCH} has {n_params} parameters")
    log(f"{LM_ARCH}: {n_params} parameters (f32, "
        f"{4 * n_params / 1e9:.1f} GB) drawn on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_T),
                           generator=gen, device=dev)
    batch = {"tokens": tokens}
    prefill = build_prefill_step(cfg)

    # the main path: counts at 0 just before, read just after
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = SWA.swa_attention.launches
    check(launches == LOCAL_LAYERS,
          f"prefill launched the tensor-core swa_attention kernel "
          f"{launches} times, expected {LOCAL_LAYERS}")
    check(SWA.swa_attention.cuda_core_launches == 0,
          f"the bf16 prefill launched the CUDA-core swa_attention kernel "
          f"{SWA.swa_attention.cuda_core_launches} times")
    check(read_counts() == {k: 0 for k in read_counts()},
          f"prefill launched lattice/CG kernels {read_counts()}")
    check(tuple(logits.shape) == (PREFILL_BATCH, 1, cfg.vocab_size)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          f"prefill logits {tuple(logits.shape)} {logits.dtype}, finite "
          f"{bool(torch.isfinite(logits).all())}")
    log(f"prefill B={PREFILL_BATCH} T={PREFILL_T}: logits "
        f"{tuple(logits.shape)} finite, tensor-core swa_attention "
        f"launches {launches} (one per local layer), CUDA-core 0, first "
        f"call {first_s * 1e3:.3f} ms")

    # the plain path on the card, same parameters and tokens; then both
    # paths at f32 compute on the first prompt
    with plain_attention():
        t0 = time.perf_counter()
        plain = prefill(params, batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    cfg32 = cfg.replace(compute_dtype="float32")
    prefill32 = build_prefill_step(cfg32)
    row0 = {"tokens": tokens[:1]}
    check((SWA.swa_attention.launches,
           SWA.swa_attention.cuda_core_launches) == (launches, 0),
          "the plain bf16 path launched a kernel")
    kern32 = prefill32(params, row0)
    check((SWA.swa_attention.launches,
           SWA.swa_attention.cuda_core_launches) == (launches,
                                                      LOCAL_LAYERS),
          f"the f32 prefill launched the tensor-core kernel "
          f"{SWA.swa_attention.launches - launches} and the CUDA-core "
          f"kernel {SWA.swa_attention.cuda_core_launches} times, expected "
          f"0 and {LOCAL_LAYERS}")
    with plain_attention():
        plain32 = prefill32(params, row0)
    check((SWA.swa_attention.launches,
           SWA.swa_attention.cuda_core_launches) == (launches,
                                                      LOCAL_LAYERS),
          "the plain f32 path launched a kernel")
    rel32 = rel_l2(kern32, plain32)
    check(rel32 <= PREFILL_F32_REL_L2, f"f32 prefill logits kernel vs plain "
          f"path rel-L2 {rel32:.3g} > {PREFILL_F32_REL_L2}")
    rel = rel_l2(logits, plain)
    with plain_attention(swa_p_bf16):
        rel_ctl = rel_l2(prefill(params, batch), plain)
    k_f32, p_f32 = rel_l2(logits[:1], plain32), rel_l2(plain[:1], plain32)
    log(f"prefill kernel path == plain path (attention's plain version on "
        f"the card): at f32 compute (B=1) last-position logits rel-L2 "
        f"{rel32:.3g} (limit {PREFILL_F32_REL_L2}); at bf16 rel-L2 "
        f"{rel:.4g} kernel vs plain (limit {PREFILL_BF16_REL_L2}; the "
        f"control with P rounded to bf16: {rel_ctl:.4g}), max |d| "
        f"{float((logits - plain).abs().max()):.3g} of max |logit| "
        f"{float(plain.abs().max()):.3g}; from the f32 logits: kernel path "
        f"{k_f32:.4g}, plain path {p_f32:.4g} (limit {PREFILL_BF16_FACTOR}x"
        f"); plain bf16 prefill {plain_s * 1e3:.3f} ms")
    check(rel <= PREFILL_BF16_REL_L2, f"bf16 prefill logits kernel vs plain "
          f"path rel-L2 {rel:.4g} > {PREFILL_BF16_REL_L2}")
    check(k_f32 <= PREFILL_BF16_FACTOR * p_f32,
          f"bf16 prefill logits: kernel path {k_f32:.3g} from the f32 "
          f"logits, plain path {p_f32:.3g}")
    del kern32, plain32

    # warm prefill time and where it goes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        x = TT.nest(params, "embed.")["table"][tokens].to(cfg.cdtype)
        pos = torch.arange(PREFILL_T, device=dev)
        layer_ms = {}
        for slot, kind in enumerate(cfg.block_pattern[1:], start=1):
            p = TT.nest(params, f"periods.slot{slot}.", 0)
            layer_ms[kind] = cuda_time_ms(
                lambda: blocks.block_apply(cfg, kind, p, x, pos), 2)
        head = TT.head_matrix(cfg, params)
        layer_ms["head"] = cuda_time_ms(
            lambda: x[:, -1:] @ head.to(x.dtype), 2)
        del x
    n_rglru = cfg.num_layers - LOCAL_LAYERS
    log(f"prefill (warm) {prefill_ms:.3f} ms: rglru block "
        f"{layer_ms['rglru']:.3f} ms x {n_rglru} = "
        f"{layer_ms['rglru'] * n_rglru:.3f} ms, local block "
        f"{layer_ms['local']:.3f} ms x {LOCAL_LAYERS} = "
        f"{layer_ms['local'] * LOCAL_LAYERS:.3f} ms, LM head "
        f"{layer_ms['head']:.3f} ms")
    del logits, plain
    torch.cuda.empty_cache()

    # prefill against decode at f32 compute, T = 64 < window
    prompt = tokens[:1, :DECODE_PROMPT]
    want = prefill32(params, {"tokens": prompt})
    step32 = build_serve_step(cfg32)
    cache = get_model(cfg32).init_cache(1, DECODE_PROMPT, device=dev)
    for t in range(DECODE_PROMPT):
        got, cache = step32(params, cache, prompt[:, t:t + 1], t)
    rel_max = float((got - want).abs().max() / want.abs().max())
    check(rel_max <= DECODE_REL, f"f32 prefill vs {DECODE_PROMPT} decode "
          f"steps: relative max {rel_max:.3g} > {DECODE_REL}")
    log(f"f32 compute: prefill's last logits == {DECODE_PROMPT} decode "
        f"steps' (relative max {rel_max:.3g}, limit {DECODE_REL})")
    del cache, got, want

    # the server, as serve.main draws its requests
    reqs = make_requests(cfg, SERVE_REQUESTS, SERVE_NEW, seed=SEED)
    reqs, stats = serve(cfg, model, params, reqs)
    check(all(r.done and len(r.generated) == SERVE_NEW for r in reqs),
          "serve: a request did not finish")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "serve: a token out of range")
    log(f"serve: {len(reqs)} requests (prompts "
        f"{[len(r.prompt) for r in reqs]} tokens, {SERVE_NEW} new each) in "
        f"{stats['steps']} steps, {stats['wall_s'] * 1e3:.3f} ms: "
        f"{stats['tokens_per_s']:.3f} tokens/s, p50 "
        f"{stats['latency_p50_s'] * 1e3:.3f} ms, p99 "
        f"{stats['latency_p99_s'] * 1e3:.3f} ms")
    step = build_serve_step(cfg)
    cache = model.init_cache(SERVE_REQUESTS, 256, device=dev)
    tok = tokens[:1, :1].expand(SERVE_REQUESTS, 1).contiguous()
    decode_ms = cuda_time_ms(lambda: step(params, cache, tok, 0), 5)
    peak = torch.cuda.max_memory_allocated()
    log(f"decode step B={SERVE_REQUESTS}: {decode_ms:.3f} ms per token "
        f"step; peak device memory {peak / 1e9:.3f} GB")
    del params, cache
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_ms": prefill_ms,
            "layer_ms": layer_ms, "decode_ms": decode_ms, "peak": peak,
            "stats": stats}


def swa_bound(byt: float, flops: float) -> tuple:
    """(ms, "bytes" or "operations"): the bf16 attention's least time on
    the card, bytes over the HBM rate or operations over the bf16
    tensor-core peak, the larger."""
    t_bytes = byt / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def swa_work(shape, dtype) -> tuple:
    """(bytes, flops): q, k, v read once and o written once; QK^T and PV
    over the window + 1 keys each query sees (clipped at 0)."""
    B, T, H, K, hd, w = shape
    size = torch.finfo(dtype).bits // 8
    byt = size * B * T * (2 * H + 2 * K) * hd
    keys = (min(T, w) * (min(T, w) + 1) // 2) + (w + 1) * max(0, T - w)
    return byt, 4 * B * H * hd * keys


def sdpa_call(q, k, v, window: int) -> tuple:
    """``scaled_dot_product_attention`` with the band mask (the yardstick,
    never on the port's path) at the largest T from the prefill's down
    that runs; (a call of it, T, max |d| vs the kernel there), or
    (None, None, None)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import swa_attention as SWA
    B, T, H, hd = q.shape
    K = k.shape[2]
    # the kv heads to the H query heads: a view for K = 1, else a copy
    kh, vh = (x.transpose(1, 2).expand(B, H, T, hd) if K == 1
              else x.transpose(1, 2).repeat_interleave(H // K, dim=1)
              for x in (k, v))
    while T >= 1024:
        qt = q[:, :T].transpose(1, 2)
        kt, vt = kh[:, :, :T], vh[:, :, :T]
        pos = torch.arange(T, device=q.device)
        mask = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] >= pos[:, None] - window))

        def fn(qt=qt, kt=kt, vt=vt, mask=mask):
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                              SDPBackend.CUDNN_ATTENTION]):
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)
        try:
            out = fn().transpose(1, 2)
            torch.cuda.synchronize()
        except RuntimeError as exc:
            log(f"scaled_dot_product_attention at T={T}: "
                f"{str(exc).splitlines()[0][:200]}")
            T //= 2
            continue
        ref = SWA.swa_attention(q[:, :T].contiguous(), k[:, :T].contiguous(),
                                v[:, :T].contiguous(), window)
        return fn, T, float((out.float() - ref.float()).abs().max())
    return None, None, None


def swa_times(lm: dict, errs: dict, dev) -> dict:
    """The tensor-core kernel at the prefill shape, timed in turns (ABCD
    DCBA, in one call on one card) with the CUDA-core kernel at the same
    bf16 shape, the plain version and SDPA; each time the mean of its two
    turns."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import swa_attention as SWA
    dtype = torch.bfloat16
    q, k, v = swa_inputs(dev, SWA_FULL, dtype, SEED + 50)
    window = SWA_FULL[-1]
    n = (SWA.swa_attention.launches, SWA.swa_attention.cuda_core_launches)
    got = SWA.swa_attention(q, k, v, window)
    want = R.swa_attention_ref(q, k, v, window)
    compare_swa("timed", got, want, dtype, errs)
    core = SWA.cuda_core_swa_attention(q, k, v, window)
    core_d = float((core.float() - want.float()).abs().max())
    core_share = float((core != want).float().mean())
    del core, want
    lib_fn, lib_t, lib_d = sdpa_call(q, k, v, window)
    fns = {"kernel": (lambda: SWA.swa_attention(q, k, v, window), 5),
           "cuda_core": (lambda: SWA.cuda_core_swa_attention(q, k, v,
                                                             window), 2),
           "plain": (lambda: R.swa_attention_ref(q, k, v, window), 2),
           "library": (lib_fn, 2)}
    order = [name for name in fns if fns[name][0] is not None]
    turns: dict = {name: [] for name in order}
    for name in order + order[::-1]:
        fn, reps = fns[name]
        turns[name].append(cuda_time_ms(fn, reps))
    t = {name: sum(ms) / len(ms) for name, ms in turns.items()}
    # comparison and timing launches are not the main path's
    SWA.swa_attention.launches, SWA.swa_attention.cuda_core_launches = n
    byt, flops = swa_work(SWA_FULL, dtype)
    b_ms, b_by = swa_bound(byt, flops)
    entry = {"name": "swa_attention", "route": "cuda",
             "source": SOURCES["swa_attention"],
             "replaces": TPU_KERNELS["swa_attention"],
             "launches": lm["launches"],
             "max_abs_err": max(v for k, v in errs.items()
                                if k.startswith("swa_attention[")),
             "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": t.get("library"),
             "launches_per": lm["launches"],
             "per": f"{LM_ARCH} prefill (0 per decode token)",
             "shape": f"B,T,H,K,hd,window={list(SWA_FULL)} bf16"}
    log(f"swa_attention timed at {entry['shape']}: "
        + ", ".join(f"{k} {v:.6g}" for k, v in entry.items()
                    if isinstance(v, float))
        + f"; useful work {flops} flops, {byt} bytes, "
        f"{flops / t['kernel'] * 1e-9:.3f} TFLOP/s; CUDA-core kernel "
        f"(csrc/swa_attention.cu) at the same bf16 shape "
        f"{t['cuda_core']:.6g} ms ({flops / t['cuda_core'] * 1e-9:.3f} "
        f"TFLOP/s; max |d| {core_d:.3g} from the plain version, "
        f"{core_share:.3g} of the entries differ); turns (ms) "
        + ", ".join(f"{k} {[round(x, 3) for x in v]}"
                    for k, v in turns.items())
        + f"; scaled_dot_product_attention (band mask) at T={lib_t}, "
        f"max |d| vs the kernel {lib_d}")
    del q, k, v, got
    torch.cuda.empty_cache()
    return entry


# ---------------------------------------------------------------------------
# phase 14: the mesh — the paper's data-parallel NGHF sequence training
# ---------------------------------------------------------------------------

# the training phase's LSTM update on a mesh: world size 1 over NCCL (the
# script needs one card), and two ranks on the one card over gloo (NCCL puts
# no two ranks on one GPU; gloo reduces CUDA tensors through the host),
# each rank running 16 of the 32 gradient rows and 4 of the 8 CG rows
MESH_STEPS = 2
MESH_RANKS = 2
MESH_TIMEOUT_S = 300


def mesh_launches(n_leaves: int) -> dict:
    """Launches per NGHF update on a mesh with TRAIN's settings: the
    sausage kernels as on one device (on this rank's rows), and
    ``cg_fused_update`` once per leaf per CG iteration
    (``cg_fused_update_tree``)."""
    return {"sausage_forward": PER_UPDATE["forward"],
            "sausage_backward": PER_UPDATE["backward"],
            "cg_fused_update": PER_UPDATE["cg"] * n_leaves}


def timed_collectives():
    """Time every collective of an update (``core.curvature``'s
    ``all_reduce_sum``) between two synchronizes; returns (stats,
    restore)."""
    from repro_torch.core import curvature
    inner = curvature.all_reduce_sum
    stats = {"calls": 0, "s": 0.0}

    def timed(tree, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(tree, group)
        torch.cuda.synchronize()
        stats["calls"] += 1
        stats["s"] += time.perf_counter() - t0
        return out

    curvature.all_reduce_sum = timed
    return stats, lambda: setattr(curvature, "all_reduce_sum", inner)


def mesh_inputs(dev):
    """(config, parameters, share counts, gradient batch, CG batch) of
    the training phase's update 0, from the seed."""
    from repro_torch.configs.acoustic import get_acoustic_config
    from repro_torch.data.synthetic import EpochPlan, asr_batch
    from repro_torch.models import acoustic
    acfg = get_acoustic_config(TRAIN["arch"])
    params = acoustic.init_params(acfg, SEED, device=dev)
    plan = EpochPlan(num_updates_per_epoch=TRAIN["steps"], base_seed=SEED)
    kw = dict(num_frames=TRAIN["frames"], num_states=acfg.num_outputs,
              input_dim=acfg.input_dim, noise=1.2, device=dev)
    return (acfg, params, acoustic.share_counts(acfg, params),
            asr_batch(plan.grad_seed(0, 0), batch=TRAIN["batch"], **kw),
            asr_batch(plan.cg_seed(0, 0), batch=TRAIN["cg_batch"], **kw))


def mesh_rank(rank: int, world: int, tmp: str, device: str) -> None:
    """One of the gloo ranks on the card: the update of ``mesh_inputs``
    on a (world, 1) mesh without candidate selection; its launches,
    metrics and last-iterate parameters written to ``tmp``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
            rank=rank, world_size=world)
        mesh = make_debug_mesh(world, 1, device=dev, backend="gloo")
        acfg, params, counts, gb, cb = mesh_inputs(dev)
        reset_counts()
        new, m, dt = one_update(acfg, params, gb, cb, counts, "auto", True,
                                mesh=mesh, eval_candidates=False)
        launches = read_counts()
        dist.barrier()
        dist.destroy_process_group()
        np.savez(os.path.join(tmp, f"rank{rank}.npz"),
                 **{k: v.cpu().numpy() for k, v in new.items()})
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump({"metrics": m, "launches": launches, "s": dt,
                       "data_index": mesh.data_index}, f)
    except BaseException:
        import traceback
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def mesh_two_ranks(dev) -> list:
    """Start ``MESH_RANKS`` gloo ranks on ``dev``, wait for them (killed
    past ``MESH_TIMEOUT_S``), and return each rank's (parameters,
    record)."""
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=mesh_rank,
                             args=(r, MESH_RANKS, tmp, str(dev)))
                 for r in range(MESH_RANKS)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(MESH_TIMEOUT_S)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        errs = "".join(Path(tmp, f"rank{r}.err").read_text()
                       for r in range(MESH_RANKS)
                       if Path(tmp, f"rank{r}.err").exists())
        check(not hung and not errs and all(p.exitcode == 0 for p in procs),
              f"mesh ranks: {len(hung)} hung, exit codes "
              f"{[p.exitcode for p in procs]}\n{errs}")
        out = []
        for r in range(MESH_RANKS):
            with np.load(Path(tmp, f"rank{r}.npz")) as f:
                params = {k: torch.from_numpy(f[k]) for k in f.files}
            out.append((params, json.loads(Path(tmp,
                                                f"rank{r}.json").read_text())))
    return out


def mesh_tree_times(params: dict, errs: dict) -> dict:
    """``cg_fused_update_tree`` at the LSTM's leaves against its plain
    per-leaf version (x, r bitwise, rr within RR_RTOL), then timed beside
    the flat call over the same N."""
    from repro_torch.kernels import cg_fused as CG
    from repro_torch.kernels import ref as R
    gen = torch.Generator(device=params["out.w"].device).manual_seed(SEED + 14)
    x, v, r, bv = ({k: torch.randn(p.shape, generator=gen, device=p.device)
                    for k, p in params.items()} for _ in range(4))
    alpha = torch.tensor(0.37, device=params["out.w"].device)
    before = CG.cg_fused_update.launches
    got = CG.cg_fused_update_tree(alpha, x, v, r, bv)
    check(CG.cg_fused_update.launches - before == len(params),
          "cg_fused_update_tree: not one launch a leaf")
    want = R.cg_fused_update_tree_ref(alpha, x, v, r, bv)
    for name, g, w in (("x", got[0], want[0]), ("r", got[1], want[1])):
        check(all(torch.equal(g[k], w[k]) for k in params),
              f"cg_fused_update_tree {name}: not the plain version's bits")
    d_rr = abs(float(got[2]) - float(want[2]))
    check(d_rr <= RR_RTOL * float(want[2]),
          f"cg_fused_update_tree rr {float(got[2])} vs {float(want[2])}")
    errs["cg_fused_update[tree]"] = d_rr
    flat = [torch.cat([t[k].reshape(-1) for k in R.tree_order(t)])
            for t in (x, v, r, bv)]
    out = {"tree_ms": cuda_time_ms(
               lambda: CG.cg_fused_update_tree(alpha, x, v, r, bv), 20),
           "tree_plain_ms": cuda_time_ms(
               lambda: R.cg_fused_update_tree_ref(alpha, x, v, r, bv), 3),
           "tree_flat_ms": cuda_time_ms(
               lambda: CG.cg_fused_update(alpha, *flat), 20),
           "tree_kernel_alone_ms": kernel_alone_ms(
               lambda: CG.cg_fused_update_tree(alpha, x, v, r, bv)),
           "tree_leaves": len(params)}
    log(f"cg_fused_update_tree == plain per-leaf version at the LSTM's "
        f"{len(params)} leaves (N = {sum(p.numel() for p in params.values())}"
        f"): x, r bitwise, rr |d| {d_rr:.3g}; {out['tree_ms']:.6g} ms a "
        f"call ({len(params)} launches; "
        f"{out['tree_kernel_alone_ms']:.6g} ms of device time alone, "
        f"behind a busy stream) against the flat call's "
        f"{out['tree_flat_ms']:.6g} ms (one launch) and the plain per-leaf "
        f"version's {out['tree_plain_ms']:.6g} ms")
    return out


def phase_mesh(dev, errs: dict, kernel_path: dict) -> dict:
    """Phase 14: (a) ``train_sequence(mesh="1x1")`` over NCCL at world
    size 1, the training phase's settings, MESH_STEPS updates, launches
    counted and collectives timed; the update of the training phase's
    ``compare_paths`` (``kernel_path``: the one-process kernel path's
    metrics, last iterate and seconds) on the mesh (decision, last-
    iterate Δθ, time); (b) the same update on two gloo ranks on the card
    against the one-process kernel path; (c) ``cg_fused_update_tree``
    against its plain version."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import train_sequence
    t_phase = time.perf_counter()
    acfg, params0, counts, gb, cb = mesh_inputs(dev)
    n_leaves = len(params0)
    per = mesh_launches(n_leaves)

    # (a) the entry point at world size 1 over NCCL
    stats, restore = timed_collectives()
    reset_counts()
    try:
        _, logs = train_sequence(**dict(TRAIN, steps=MESH_STEPS),
                                 init_params=params0, device=dev,
                                 verbose=False, mesh="1x1")
    finally:
        restore()
    launches = read_counts()
    check(dist.is_initialized() and dist.get_backend() == "nccl"
          and dist.get_world_size() == 1, "mesh 1x1: not NCCL at world 1")
    for m in logs:
        check_update(f"mesh 1x1 update {m['step']}", m)
    want = {k: v * MESH_STEPS for k, v in per.items()}
    want["sausage_loss_only"] = sum(int(m["cg_evaluated"]) + 1 for m in logs)
    want.update(dag_forward=0, dag_backward=0, dag_loss_only=0)
    check(launches == want, f"mesh 1x1 launches {launches} != {want}")
    wall = sum(m["time_s"] for m in logs)
    log(f"mesh 1x1 (NCCL, world 1): {MESH_STEPS} NGHF updates through "
        f"train_sequence(mesh='1x1'): "
        + ", ".join(f"{m['time_s'] * 1e3:.3f} ms" for m in logs)
        + f"; collectives {stats['calls']} calls, {stats['s'] * 1e3:.3f} ms"
        f" ({100 * stats['s'] / wall:.2f} % of the updates, each timed "
        f"between two synchronizes); launches {launches}")

    # the training phase's update 0 on the mesh, against the one-process
    # kernel path's run of it in the training phase (decision, Δθ) and
    # here, just before (time)
    mesh = make_debug_mesh(1, 1, device=dev)
    m_p, new_p, t_p5 = (kernel_path[k] for k in ("metrics", "last", "s"))
    _, _, t_p = one_update(acfg, params0, gb, cb, counts, "auto", True)
    _, m_m, t_m = one_update(acfg, params0, gb, cb, counts, "auto", True,
                             mesh=mesh)
    text = same_choice("mesh 1x1 vs no mesh", m_m, m_p)
    new_m, _, _ = one_update(acfg, params0, gb, cb, counts, "auto", True,
                             mesh=mesh, eval_candidates=False)
    rel = delta_rel_l2(new_m, new_p, params0)
    check(rel <= DELTA_REL_L2, f"mesh 1x1: last-iterate Δθ vs no mesh "
          f"rel-L2 {rel:.3g}")
    log(f"mesh 1x1 vs no mesh, update 0: {text}; last-iterate Δθ rel-L2 "
        f"{rel:.3g} (limit {DELTA_REL_L2}); update {t_m * 1e3:.3f} ms on "
        f"the mesh vs {t_p * 1e3:.3f} ms without, just before it (the "
        f"training phase's run of it: {t_p5 * 1e3:.3f} ms)")
    # the NCCL group stays up: phase 15's world-1 mesh runs on it
    torch.cuda.empty_cache()

    # (b) two gloo ranks on the one card
    ranks = mesh_two_ranks(dev)
    first = ranks[0][0]
    for r, (new_r, rec) in enumerate(ranks):
        check(all(torch.equal(new_r[k], first[k]) for k in first),
              f"gloo rank {r}: other parameters than rank 0")
        check(rec["launches"] == dict(
            per, sausage_loss_only=0, dag_forward=0, dag_backward=0,
            dag_loss_only=0), f"gloo rank {r} launches {rec['launches']}")
    rel2 = delta_rel_l2({k: v.to(dev) for k, v in first.items()}, new_p,
                        params0)
    check(rel2 <= DELTA_REL_L2, f"gloo 2x1: last-iterate Δθ vs one "
          f"process rel-L2 {rel2:.3g}")
    log(f"gloo 2x1 on one card: data indices "
        f"{[rec['data_index'] for _, rec in ranks]}, ranks bitwise equal; "
        f"last-iterate Δθ vs the one-process kernel path rel-L2 "
        f"{rel2:.3g} (limit {DELTA_REL_L2}); vᵀBv per outer iteration "
        f"{['%.3g' % c for c in ranks[0][1]['metrics']['cg_curv']]} (one "
        f"process: {['%.3g' % c for c in m_p['cg_curv']]}); update "
        + ", ".join(f"{rec['s'] * 1e3:.3f}" for _, rec in ranks)
        + f" ms a rank, each rank's first, without candidates (one "
        f"process, with them: {t_p * 1e3:.3f} ms); launches a rank "
        f"{ranks[0][1]['launches']}")

    # (c) the per-leaf fused update alone
    out = mesh_tree_times(params0, errs)
    out.update(mesh_launches=launches["cg_fused_update"],
               mesh_launches_per=per["cg_fused_update"],
               mesh_update_ms=[m["time_s"] * 1e3 for m in logs],
               mesh_step_ms=t_m * 1e3, nomesh_step_ms=t_p * 1e3,
               mesh_collective_share=stats["s"] / wall,
               mesh_gloo_update_ms=[rec["s"] * 1e3 for _, rec in ranks])
    log(f"phase 14 (mesh) {time.perf_counter() - t_phase:.3f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 15: the LM archs on a mesh, FSDP storage (ROADMAP 1.4 part 2)
# ---------------------------------------------------------------------------

# (a) qwen2.5-3b at phase 10's width, depth, batch and settings through
# train_lm(mesh="1x1"), on the NCCL group phase 14 started; (b) two gloo
# ranks on the one card, a 2x1 mesh, at full width and 2 of its 36
# layers, each storing its share of every parameter and θ-sized state
# leaf (the 7 layer matrices split over "data", the tied table whole)
FSDP_STEPS = 2
FSDP_RANKS = 2
FSDP_RANK_LAYERS = 2
FSDP_RANK_PARAMS = 465_320_960
# (b) runs B 8 -> 4 (two ranks share the card: each peaked at 27.7 GB
# at B 4 on an H100 80GB HBM3) and the reference acceptance test's 2 CG
# and 1 NG iterations: on one card gloo stages every collective through
# the host (75 s an update at 8 and 4), and (b) shows the split and the
# parity, not speed
FSDP_RANK_BATCH = 4
FSDP_RANK_ITERS = dict(cg_iters=2, ng_iters=1)
# (b) keeps θ-sized state besides the parameters: the warm-start Δθ and
# the Fisher diagonal
FSDP_RANK_OPT = dict(warm_start=True, preconditioner="fisher_diag")
FSDP_TIMEOUT_S = 600


def fsdp_launches(n_leaves: int, cg_iters: int = LM_CG_ITERS,
                  ng_iters: int = LM_NG_ITERS) -> int:
    """``cg_fused_update`` launches per NGHF update on a mesh: one per
    leaf (this rank's share) per CG iteration."""
    return (cg_iters + ng_iters) * n_leaves


def fsdp_rank_batch(cfg, dev) -> dict:
    from repro_torch.data.synthetic import lm_batch
    return lm_batch(0, batch=FSDP_RANK_BATCH, seq_len=DENSE_TRAIN_SEQ,
                    vocab=cfg.vocab_size, device=dev)


def fsdp_one_update(cfg, params, batch, mesh=None, ss=None, min_cg=1,
                    cg_iters=LM_CG_ITERS, ng_iters=LM_NG_ITERS,
                    **overrides) -> tuple:
    """One NGHF update (``cg_iters``, ``ng_iters``, fused CG) from
    ``params`` (this rank's shares under ``ss`` on ``mesh``) through
    ``build_step``'s optimiser inside its FSDP context, all metrics; the
    CG batch is the first max(B // 4, ``min_cg``) rows (``train_lm``
    takes the data extent on a mesh).  (new params, metrics, seconds,
    this rank's θ-sized bytes: the parameters and every θ-sized state
    slot)."""
    from repro_torch.launch import fsdp
    from repro_torch.launch.steps import build_step, cg_sub_batch
    _, opt = build_step(cfg, "nghf", cg_iters=cg_iters, ng_iters=ng_iters,
                        cg_fused=True, mesh=mesh, state_sharding=ss,
                        **overrides)
    state = opt.init(params, state_sharding=ss)
    theta = [params] + [t for t in (state.get("delta"),
                                    state["precond"].get("d")) if t]
    nbytes = sum(v.numel() * v.element_size() for t in theta
                 for v in t.values())
    cg = cg_sub_batch(batch, 4, min_cg if mesh is None
                      else max(min_cg, mesh.data_extent))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with fsdp.step_context(cfg, mesh, ss):
        new, _, m = opt.step(params, state, batch, cg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return new, {k: (v.tolist() if torch.is_tensor(v) else float(v))
                 for k, v in m.items()}, dt, nbytes


def delta_rel_l2_to(new_a: dict, new_b: dict, base: dict) -> float:
    """``delta_rel_l2`` with ``new_b`` and ``base`` on another device
    than ``new_a`` (moved a leaf at a time)."""
    num = den = 0.0
    for k in base:
        a, b = new_a[k], new_b[k].to(new_a[k].device)
        num += float(((a - b) ** 2).sum())
        den += float(((b - base[k].to(a.device)) ** 2).sum())
    return (num / max(den, 1e-30)) ** 0.5


def fsdp_world1(dev, dense_path: dict, dense_log: list) -> dict:
    """(a) ``train_lm(mesh="1x1")`` over NCCL at phase 10's settings,
    launches counted; then phase 10's update 0 on the mesh against
    phase 10's one-process kernel path (``dense_path``): its decision (or
    a tie within the paths' spread), the last-iterate Δθ within
    LM_DELTA_REL_L2, the time beside phase 10's (``dense_log``)."""
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.launch.train import train_lm
    from repro_torch.models.registry import get_model
    check(dist.is_initialized() and dist.get_backend() == "nccl"
          and dist.get_world_size() == 1,
          "phase 15: phase 14's NCCL group (world 1) is not running")
    cfg = get_config(DENSE_ARCH).replace(num_layers=DENSE_TRAIN_LAYERS)
    model = get_model(cfg)
    per = fsdp_launches(len(model.param_shapes()))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _, log_ = train_lm(arch=DENSE_ARCH, num_layers=DENSE_TRAIN_LAYERS,
                       mesh="1x1", steps=FSDP_STEPS, batch=DENSE_TRAIN_BATCH,
                       seq=DENSE_TRAIN_SEQ, cg_iters=LM_CG_ITERS,
                       ng_iters=LM_NG_ITERS, cg_fused=True, device=dev,
                       verbose=False)
    launches = read_counts()
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          "phase 15: train_lm left phase 14's NCCL group")
    check_lm_updates(f"mesh 1x1 {DENSE_ARCH} NGHF (2d storage)", log_,
                     launches, swa_counts(), list(range(FSDP_STEPS)), per)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"mesh 1x1 {DENSE_ARCH} NGHF through train_lm(mesh='1x1'), "
        f"{DENSE_TRAIN_LAYERS} layers, B={DENSE_TRAIN_BATCH}, "
        f"T={DENSE_TRAIN_SEQ}: update times "
        f"{[round(m['time_s'], 3) for m in log_]} s against phase 10's "
        f"{[round(m['time_s'], 3) for m in dense_log]} s without a mesh; "
        f"{per} cg_fused_update launches an update "
        f"({per // (LM_CG_ITERS + LM_NG_ITERS)} leaves x "
        f"{LM_CG_ITERS + LM_NG_ITERS} iterations); peak device "
        f"memory {peak:.3f} GB")
    torch.cuda.empty_cache()

    # phase 10's update 0 on the mesh: decision and last iterate
    mesh = make_debug_mesh(1, 1, device=dev)
    start = model.init(SEED, device=dev)
    ss = param_shardings(cfg, mesh, start)
    batch = dense_batch(cfg, 0, dev)
    _, m_m, t_m, _ = fsdp_one_update(cfg, start, batch, mesh, ss)
    text = same_choice(f"mesh 1x1 vs no mesh ({DENSE_ARCH})", m_m,
                       dense_path["metrics"])
    new_m, _, _, _ = fsdp_one_update(cfg, start, batch, mesh, ss,
                                     eval_candidates=False)
    rel = delta_rel_l2_to(new_m, dense_path["last"], start)
    del new_m, start
    check(rel <= LM_DELTA_REL_L2, f"mesh 1x1 {DENSE_ARCH}: last-iterate Δθ "
          f"vs no mesh rel-L2 {rel:.3g}")
    log(f"mesh 1x1 vs no mesh, {DENSE_ARCH} update 0: {text}; last-iterate "
        f"Δθ rel-L2 {rel:.3g} (limit {LM_DELTA_REL_L2}); update "
        f"{t_m * 1e3:.3f} ms on the mesh (all metrics, no stage timer) vs "
        f"phase 10's {dense_path['s'] * 1e3:.3f} ms (its stage timer's "
        f"syncs) and {dense_log[0]['time_s'] * 1e3:.3f} ms (its main path)")
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"fsdp_launches": launches["cg_fused_update"],
            "fsdp_launches_per": per,
            "fsdp_update_ms": [m["time_s"] * 1e3 for m in log_],
            "fsdp_step_ms": t_m * 1e3, "fsdp_delta_rel_l2": rel,
            "fsdp_peak_gb": peak}


def fsdp_rank(rank: int, world: int, tmp: str, device: str) -> None:
    """One of the gloo ranks on the card: qwen2.5-3b at full width and
    FSDP_RANK_LAYERS layers on a (world, 1) mesh, its share of every
    leaf placed from the whole draw; one NGHF update without candidate
    selection; its shares, launches, metrics, seconds, θ-sized bytes and
    peak memory written to ``tmp``."""
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.models.registry import get_model
    try:
        dev = torch.device(device)
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
            rank=rank, world_size=world)
        mesh = make_debug_mesh(world, 1, device=dev, backend="gloo")
        cfg = get_config(DENSE_ARCH).replace(num_layers=FSDP_RANK_LAYERS)
        start = get_model(cfg).init(SEED, device=dev)
        ss = param_shardings(cfg, mesh, start)
        params = {k: ss[k].place(v) for k, v in start.items()}
        del start
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        batch = fsdp_rank_batch(cfg, dev)
        reset_counts()
        new, m, dt, nbytes = fsdp_one_update(cfg, params, batch, mesh, ss,
                                             eval_candidates=False,
                                             **FSDP_RANK_ITERS,
                                             **FSDP_RANK_OPT)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        dist.barrier()
        dist.destroy_process_group()
        torch.save({k: v.cpu() for k, v in new.items()},
                   os.path.join(tmp, f"rank{rank}.pt"))
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump({"metrics": m, "launches": launches, "s": dt,
                       "theta_bytes": nbytes, "peak": peak,
                       "data_index": mesh.data_index}, f)
    except BaseException:
        import traceback
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_ranks(target, n: int, dev, timeout_s: int, tmp: str) -> None:
    """Run ``target(rank, n, tmp, device)`` in ``n`` spawned processes;
    wait for them (killed past ``timeout_s``) and fail on any error."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, n, tmp, str(dev)))
             for r in range(n)]
    # the ranks share the card: their allocators map segments on demand
    # rather than caching whole blocks (the setting is read once, when a
    # process first allocates; this process's own is not touched)
    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        for p in procs:
            p.start()
    finally:
        if saved is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
    for p in procs:
        p.join(timeout_s)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    errs = "".join(Path(tmp, f"rank{r}.err").read_text() for r in range(n)
                   if Path(tmp, f"rank{r}.err").exists())
    check(not hung and not errs and all(p.exitcode == 0 for p in procs),
          f"ranks: {len(hung)} hung, exit codes "
          f"{[p.exitcode for p in procs]}\n{errs}")


def fsdp_two_ranks(dev) -> dict:
    """(b) the one-process update at FSDP_RANK_LAYERS layers, then the
    same update on two gloo ranks of the card: the ranks' replicated
    leaves bitwise equal, their split leaves put together and the
    last-iterate Δθ within LM_DELTA_REL_L2 of one process's, each rank's
    launches, θ-sized bytes (against one process's), peak memory and
    seconds."""
    import tempfile
    from types import SimpleNamespace
    from repro_torch.configs.base import get_config
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.models.registry import get_model
    cfg = get_config(DENSE_ARCH).replace(num_layers=FSDP_RANK_LAYERS)
    model = get_model(cfg)
    check(model.param_count() == FSDP_RANK_PARAMS,
          f"{DENSE_ARCH} at {FSDP_RANK_LAYERS} layers: "
          f"{model.param_count()} parameters")
    shapes = model.param_shapes()
    per = fsdp_launches(len(shapes), **FSDP_RANK_ITERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = model.init(SEED, device=dev)
    new_one, m_one, t_one, bytes_one = fsdp_one_update(
        cfg, start, fsdp_rank_batch(cfg, dev), min_cg=FSDP_RANKS,
        eval_candidates=False, **FSDP_RANK_ITERS, **FSDP_RANK_OPT)
    peak_one = torch.cuda.max_memory_allocated()
    start = {k: v.cpu() for k, v in start.items()}
    new_one = {k: v.cpu() for k, v in new_one.items()}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(fsdp_rank, FSDP_RANKS, dev, FSDP_TIMEOUT_S, tmp)
        recs = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                for r in range(FSDP_RANKS)]
        shares = [torch.load(Path(tmp, f"rank{r}.pt"))
                  for r in range(FSDP_RANKS)]
    order = sorted(range(FSDP_RANKS), key=lambda r: recs[r]["data_index"])
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": FSDP_RANKS, "model": 1})
    specs = {k: s.spec for k, s in param_shardings(cfg, mesh,
                                                    shapes).items()}
    whole, n_split = {}, 0
    for k in shapes:
        dims = [d for d, e in enumerate(specs[k]) if e == "data"]
        if dims:
            n_split += 1
            whole[k] = torch.cat([shares[r][k] for r in order], dims[0])
        else:
            check(all(torch.equal(sh[k], shares[0][k]) for sh in shares),
                  f"gloo 2x1 {DENSE_ARCH}: ranks differ on {k}")
            whole[k] = shares[0][k]
        check(tuple(whole[k].shape) == shapes[k][0],
              f"gloo 2x1 {DENSE_ARCH}: {k} put together as "
              f"{tuple(whole[k].shape)}")
    rel = delta_rel_l2(whole, new_one, start)
    by_leaf = sorted(((delta_rel_l2({k: whole[k]}, {k: new_one[k]},
                                    {k: start[k]}), k) for k in shapes),
                     reverse=True)
    hist = {k: (recs[0]["metrics"][k], m_one[k])
            for k in ("grad_norm", "update_norm", "ng_quad", "cg_curv",
                      "cg_quad", "cg_resid")}
    check(rel <= LM_DELTA_REL_L2, f"gloo 2x1 {DENSE_ARCH}: last-iterate Δθ "
          f"vs one process rel-L2 {rel:.3g}; by leaf {by_leaf[:6]}; rank 0 "
          f"vs one process {hist}")
    for r, rec in enumerate(recs):
        want = {k: 0 for k in rec["launches"]}
        want["cg_fused_update"] = per
        check(rec["launches"] == want,
              f"gloo rank {r} launches {rec['launches']}, want {want}")
    ratio = [rec["theta_bytes"] / bytes_one for rec in recs]
    log(f"gloo 2x1 on one card, {DENSE_ARCH} at full width and "
        f"{FSDP_RANK_LAYERS} layers, B={FSDP_RANK_BATCH}, "
        f"T={DENSE_TRAIN_SEQ} ({FSDP_RANK_PARAMS} parameters, "
        f"{n_split} of {len(shapes)} leaves split over 'data'), NGHF "
        f"({FSDP_RANK_ITERS['cg_iters']} CG, {FSDP_RANK_ITERS['ng_iters']} "
        f"NG iterations) with warm start and the Fisher diagonal, without "
        f"candidates: ranks "
        f"equal on every replicated leaf; last-iterate Δθ vs one process "
        f"rel-L2 {rel:.3g} (limit {LM_DELTA_REL_L2}); θ-sized bytes a rank "
        f"(parameters, Δθ, Fisher diagonal) "
        + ", ".join(f"{rec['theta_bytes']}" for rec in recs)
        + f" against one process's {bytes_one} (ratio "
        + ", ".join(f"{x:.4f}" for x in ratio)
        + "); peak device memory a rank "
        + ", ".join(f"{rec['peak'] / 1e9:.3f}" for rec in recs)
        + f" GB (one process {peak_one / 1e9:.3f} GB); update "
        + ", ".join(f"{rec['s']:.3f}" for rec in recs)
        + f" s a rank, each its first (one process {t_one:.3f} s); "
        f"launches a rank {recs[0]['launches']['cg_fused_update']}; vᵀBv "
        f"per outer iteration "
        f"{['%.3g' % c for c in recs[0]['metrics']['cg_curv']]} (one "
        f"process {['%.3g' % c for c in m_one['cg_curv']]})")
    return {"fsdp_gloo_update_s": [rec["s"] for rec in recs],
            "fsdp_gloo_theta_ratio": ratio,
            "fsdp_gloo_peak_gb": [rec["peak"] / 1e9 for rec in recs],
            "fsdp_gloo_delta_rel_l2": rel,
            "fsdp_gloo_launches_per": per}


def phase_fsdp(dev, dense_path: dict, dense_log: list) -> dict:
    """Phase 15: the LM archs on a mesh under FSDP storage, (a) at world
    size 1 over NCCL and (b) on two gloo ranks of the card."""
    t_phase = time.perf_counter()
    out = fsdp_world1(dev, dense_path, dense_log)
    out.update(fsdp_two_ranks(dev))
    log(f"phase 15 (LM on a mesh) {time.perf_counter() - t_phase:.3f} s")
    return out

# ---------------------------------------------------------------------------
# phase 16: tensor-parallel compute over "model" (two gloo ranks, 1x2)
# ---------------------------------------------------------------------------

# (a) qwen2.5-3b at phase 15(b)'s settings (full width, 2 layers, 2d
# storage, B 4 x T 512, 2 CG and 1 NG iterations, warm start, the Fisher
# diagonal) on a (1, 2) mesh: each rank computes its 8 of the 16 query
# heads (1 of the 2 kv heads), half the FFN's columns and half the vocab
TP_RANKS = 2
TP_DELTA_REL_L2 = 1e-2
TP_LAYER_REPS = 2                  # calls a turn (5 before; cut for time)
TP_TIMEOUT_S = 600
# the row-parallel products of (a)'s rank (``layers.partial_matmul``, bf16
# operands, an f32 result): against the f32 upcast's GEMM, the f32 result
# within this share of its largest entry, the bf16 gradients within one
# bf16 step (2^-7 of a value at most) of theirs
TP_PM_F32_REL, TP_PM_BF16_REL = 1e-5, 2.0 ** -7
# (b) recurrentgemma-9b at phase 13's full width, 3 layers (rglru, rglru,
# local), B 2 x T 4096, one SGD step: the local layer's windowed kernels
# on each rank's 8 query heads and the one kv head, G 8 (phase 13: 16, 1);
# the RG-LRU blocks on each rank's 2048 of the 4096 channels, their MLPs
# on half the columns
TP_RG_BATCH = 2
TP_RG_LOCAL = (TP_RG_BATCH, RG_TRAIN_SEQ, 16 // TP_RANKS, 1, 256, 2048)
# (c) xlstm-125m at full width (d 768, 4 heads), 4 layers (one period: 3
# mLSTM, 1 sLSTM, as phase 12's training), B 8 x T 512, one NGHF update at
# (a)'s settings: each rank computes 2 of the 4 heads of every block and
# half the vocab
TP_XL_BATCH, TP_XL_SEQ = 8, 512
# (d) whisper-base at full size (phase 9's B 16 x T 448): its gradient on
# the 1x2 mesh against one process's (the same bf16 arithmetic, the
# row-parallel sums in another order: phase 13's limit), and one Adam
# step; each rank computes 4 of the 8 heads of every attention, half of
# every MLP's columns and half of ``dec_pos``'s rows; the vocab (51865)
# does not divide, so its unit runs whole
TP_WH_GRAD_REL_L2 = RG_GRAD_REL_L2
TP_WH_ADAM_LR = 3e-4
# (e) granite-moe-3b-a800m at full width, 2 of its 32 layers, the
# capacity dispatch MoE (``moe_impl="dispatch"``), B 2 x T 64 at f32
# compute: each rank computes 20 of the 40 experts' buckets on the whole
# T, 12 of the 24 query heads, the 49155-token vocabulary whole (it does
# not divide), the stream split over T between the units; its gradient
# against one process's (phase 13's limit), and the pairs each layer
# drops past its capacity the same (f32, so that no near-tie of the
# router's top 8 falls another way; at S = 128 tokens an expert's bucket
# holds 32 of its about 26 pairs, so some overflow)
TP_GD_LAYERS = 2
TP_GD_BATCH, TP_GD_SEQ = 2, 64
TP_GD_GRAD_REL_L2 = RG_GRAD_REL_L2
# (a) to (d) under sequence-parallel activations: the decoder-only
# archs' residual stream holds T/2 a rank between the units; whisper-base
# (encoder-decoder) keeps it whole.  Beside each reading, what this phase
# showed on the card before the stream was split (PERF.md §5-6, NVIDIA
# H100 80GB HBM3, 700.00 W)
TP_BEFORE = {
    "a": "update 3.402-4.631 s a rank, peak 17.441 GB, layer 0 34.3-45.7 "
         "ms split",
    "b": "SGD step 3.396 / 4.511 s a rank, RG-LRU block 0 forward 380.8 / "
         "686.1 ms split vs 435.0 / 647.3 whole",
    "c": "update 4.567 / 5.999 s a rank, peak 3.314 GB, mLSTM layer 30.7 "
         "/ 51.7 ms split vs 32.4 / 55.4 whole, sLSTM 63.9 / 69.9 vs 42.7 "
         "/ 43.3",
    "d": "gradient 1.959-2.721 s a rank, Adam step 1.637-2.219 s",
}


def model_collectives(counts: dict, mesh) -> dict:
    """{kind: {"calls", "bytes", "ring_bytes"}} of ``fsdp.collective_log``
    counts over the model group: the whole tensors' bytes, and what a
    rank sends on a ring ((m - 1) / m of them for an all-gather or a
    reduce-scatter, twice that for an all-reduce)."""
    from repro_torch.launch import fsdp
    model = fsdp._group_id(mesh.group("model"))
    m = mesh.extent("model")
    out = {}
    for (kind, gid, shape, size), n in counts.items():
        if gid != model:
            continue
        c = out.setdefault(kind, {"calls": 0, "bytes": 0, "ring_bytes": 0})
        whole = math.prod(shape) * size * n
        c["calls"] += n
        c["bytes"] += whole
        c["ring_bytes"] += whole * (m - 1) // m * (
            2 if kind == "all_reduce" else 1)
    return out


class watched_gathers:
    """Within the block, the shapes each ``fsdp.gather_for_compute``
    result's leaves were used at (``used[path]``, a stacked leaf's period
    slice), the ``_Gather`` launches over the model group and over any
    group (``used["model_gathers"]``, ``used["gathers"]``), the q and
    k shapes of each windowed attention call (``used["swa"]``), the
    residual stream's shapes at the block boundaries (``used["stream"]``)
    and the collectives over the model group (``used["coll"]``,
    ``model_collectives``)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        from repro_torch.launch import fsdp
        from repro_torch.models import blocks, layers
        from repro_torch.models.transformer import flatten
        self.saved = (fsdp.gather_for_compute, fsdp._Gather.apply,
                      layers.swa_attention, blocks.block_apply)
        gather, apply, swa, block = self.saved
        model = fsdp._group_id(self.mesh.group("model"))
        used = self.used = {"model_gathers": 0, "gathers": 0, "swa": [],
                            "stream": []}

        def watched(tree, compute_dtype=None, prefix=""):
            got = gather(tree, compute_dtype, prefix)
            used.update({k: list(v.shape)
                         for k, v in flatten(got, prefix).items()})
            return got

        def counted(x, dim, gid, data):
            used["gathers"] += 1
            used["model_gathers"] += int(gid == model)
            return apply(x, dim, gid, data)

        def attention(q, k, v, window, **kw):
            used["swa"].append([list(q.shape), list(k.shape)])
            return swa(q, k, v, window, **kw)

        def block_apply(cfg, kind, p, x, positions):
            y, aux = block(cfg, kind, p, x, positions)
            for shape in (list(x.shape), list(y.shape)):
                if shape not in used["stream"]:
                    used["stream"].append(shape)
            return y, aux

        fsdp.gather_for_compute, fsdp._Gather.apply = watched, counted
        layers.swa_attention = attention
        blocks.block_apply = block_apply
        self.log = fsdp.collective_log()
        self.counts = self.log.__enter__()
        return used

    def __exit__(self, *exc):
        from repro_torch.launch import fsdp
        from repro_torch.models import blocks, layers
        (fsdp.gather_for_compute, fsdp._Gather.apply,
         layers.swa_attention, blocks.block_apply) = self.saved
        self.log.__exit__(*exc)
        self.used["coll"] = model_collectives(self.counts, self.mesh)


def tp_layer_times(cfg, mesh, ss, params, batch, prefix="periods.slot0.",
                   kind="attn") -> dict:
    """A layer's forward (period 0 of the ``kind`` block at ``prefix``)
    under CUDA events, in turns (whole, split, sp, sp, split, whole):
    gathered whole over "model" (phase 15's layer: storage only), on this
    rank's share of its unit with the whole stream (the layer before the
    stream was split), and so with the stream split over T ("sp": this
    rank's T/m rows in and out, the entry's all-gather and the exit's
    reduce-scatter); the
    outputs' rel-L2 (bf16 sums in another order), the sp layer's against
    its rows of the split one's."""
    from repro_torch.launch import fsdp
    from repro_torch.models import blocks as B
    from repro_torch.models.transformer import gathered
    specs = {k: s.spec for k, s in ss.items()}
    gen = torch.Generator(device=mesh.device).manual_seed(SEED + 160)
    T = batch["tokens"].shape[1]
    x = torch.randn(batch["tokens"].shape[0], T, cfg.d_model, generator=gen,
                    device=mesh.device).to(cfg.cdtype)
    pos = torch.arange(T, device=mesh.device)
    m = mesh.extent("model")
    r = dict(zip(mesh.axis_names, mesh.device_mesh.get_coordinate()))["model"]
    rows = slice(r * T // m, (r + 1) * T // m)
    x_rows = x[:, rows].contiguous()

    def layer(mode: str):
        with torch.no_grad(), fsdp.compute_specs(
                mesh, specs, cast=True, cfg=None if mode == "whole" else cfg):
            seq = fsdp.sequence_split(T) if mode == "sp" else None
            with fsdp.sequence_rows(seq):
                p = gathered(cfg, params, prefix, 0)
                return B.block_apply(cfg, kind, p,
                                     x_rows if seq else x, pos)[0]

    split = layer("split")
    rel = rel_l2(split, layer("whole"))
    sp = layer("sp")
    check(tuple(sp.shape) == tuple(x_rows.shape),
          f"phase 16 {kind} layer: the sequence-parallel layer gave "
          f"{tuple(sp.shape)}, want {tuple(x_rows.shape)}")
    sp_rel = rel_l2(sp, split[:, rows])
    del split, sp
    turns = {"whole": [], "split": [], "sp": []}
    for mode in ("whole", "split", "sp", "sp", "split", "whole"):
        turns[mode].append(cuda_time_ms(lambda: layer(mode), TP_LAYER_REPS))
    return {"split_ms": sum(turns["split"]) / 2,
            "whole_ms": sum(turns["whole"]) / 2,
            "sp_ms": sum(turns["sp"]) / 2, "rel": rel, "sp_rel": sp_rel,
            "turns": turns}


def tp_rank_qwen(mesh, dev, tmp: str, rank: int) -> dict:
    """(a) on this rank: its shares placed from the whole draw, layer 0's
    forward timed both ways, one NGHF update with candidates (counted,
    watched, timed) and one without (the last iterate, saved)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.models.registry import get_model
    cfg = get_config(DENSE_ARCH).replace(num_layers=FSDP_RANK_LAYERS)
    start = get_model(cfg).init(SEED, device=dev)
    ss = param_shardings(cfg, mesh, start)
    params = {k: ss[k].place(v) for k, v in start.items()}
    del start
    torch.cuda.empty_cache()
    batch = fsdp_rank_batch(cfg, dev)
    layer = tp_layer_times(cfg, mesh, ss, params, batch)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with watched_gathers(mesh) as used:
        _, m, dt, nbytes = fsdp_one_update(cfg, params, batch, mesh, ss,
                                           **FSDP_RANK_ITERS,
                                           **FSDP_RANK_OPT)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    new, _, dt_last, _ = fsdp_one_update(cfg, params, batch, mesh, ss,
                                         eval_candidates=False,
                                         **FSDP_RANK_ITERS, **FSDP_RANK_OPT)
    torch.save({k: v.cpu() for k, v in new.items()},
               os.path.join(tmp, f"rank{rank}_a.pt"))
    del params, new
    torch.cuda.empty_cache()
    return {"metrics": m, "launches": launches, "s": dt, "s_last": dt_last,
            "theta_bytes": nbytes, "peak": peak, "used": used,
            "layer": layer}


def tp_rank_rg(mesh, dev, tmp: str, rank: int) -> dict:
    """(b) on this rank: its shares placed from the whole draw; RG-LRU
    block 0's forward timed both ways; the gradient on the
    tensor-parallel kernel path (watched and counted) against the
    one-process plain path's (``tp_grad_rel`` on ``rg_plain``); then one
    SGD step through ``build_step`` on the mesh, counted and timed."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.curvature import grad_and_loss
    from repro_torch.core.optim.base import data_splits
    from repro_torch.launch import fsdp
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.launch.steps import build_step, lm_forward
    from repro_torch.losses.chunked_lm import ChunkedCELoss
    from repro_torch.models.registry import get_model
    cfg = get_config(LM_ARCH).replace(num_layers=RG_TRAIN_LAYERS)
    model = get_model(cfg)
    start = model.init(SEED, device=dev)
    ss = param_shardings(cfg, mesh, start)
    params = {k: ss[k].place(v) for k, v in start.items()}
    del start
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b = tp_rg_batch(cfg, dev)
    layer = tp_layer_times(cfg, mesh, ss, params, b, "periods.slot0.",
                           "rglru")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with watched_gathers(mesh) as used, fsdp.step_context(cfg, mesh, ss):
        loss, _, g = grad_and_loss(lm_forward(cfg, model), ChunkedCELoss(),
                                   params, b, mesh=mesh,
                                   data_split=data_splits(ss))
    grad_counts = bwd_counts()[:3]
    grad_fwd = swa_counts()
    grad_rel = tp_grad_rel(g, ss, tmp, "rg_plain", rank)
    del g
    ab = tp_stream_ab(cfg, model, params, b, mesh, ss)
    step, opt = build_step(cfg, "sgd", lr=RG_TRAIN_LR, mesh=mesh,
                           state_sharding=ss)
    state = opt.init(params, state_sharding=ss)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with fsdp.collective_log() as coll:
        params, state, m = step(params, state, b)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    out = {"grad_rel": grad_rel, "step_coll": model_collectives(coll, mesh),
           "ab": ab,
           "loss": float(loss), "grad_launches": list(grad_counts),
           "grad_forward": list(grad_fwd), "step_s": dt,
           "step_launches": list(bwd_counts()[:3]),
           "step_forward": list(swa_counts()),
           "step_loss": float(m["loss"]), "peak": peak, "used": used,
           "layer": layer}
    del params, state
    torch.cuda.empty_cache()
    return out


class whole_stream:
    """Within the block every forward keeps its residual stream whole on
    each rank (``fsdp.sequence_split`` gives None): the path before the
    stream was split, for a comparison in the same call only."""

    def __enter__(self):
        from repro_torch.launch import fsdp
        self.saved = fsdp.sequence_split
        fsdp.sequence_split = lambda T: None

    def __exit__(self, *exc):
        from repro_torch.launch import fsdp
        fsdp.sequence_split = self.saved


def tp_stream_ab(cfg, model, params, b, mesh, ss) -> dict:
    """One gradient with the residual stream whole, then one with it split
    over T (both after a first gradient, so both warm): the seconds, the
    peak device memory and the collectives over "model" of each."""
    import contextlib
    from repro_torch.core.curvature import grad_and_loss
    from repro_torch.core.optim.base import data_splits
    from repro_torch.launch import fsdp
    from repro_torch.launch.steps import lm_forward
    from repro_torch.losses.chunked_lm import ChunkedCELoss
    out = {}
    for mode in ("whole", "split"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (whole_stream() if mode == "whole" else contextlib.nullcontext()), \
                fsdp.step_context(cfg, mesh, ss), \
                fsdp.collective_log() as coll:
            g = grad_and_loss(lm_forward(cfg, model), ChunkedCELoss(), params,
                              b, mesh=mesh, data_split=data_splits(ss))[2]
        torch.cuda.synchronize()
        out[mode] = {"s": time.perf_counter() - t0,
                     "peak": torch.cuda.max_memory_allocated(),
                     "coll": model_collectives(coll, mesh)}
        del g
    return out


def tp_grad_rel(g: dict, ss: dict, tmp: str, stem: str, rank: int) -> float:
    """The relative L2 over every leaf of the gradient whose shares this
    rank holds (``g``) against one process's whole gradient, saved as
    ``<stem>.<key>.npy`` (memory-mapped, this rank's share placed from
    it); a leaf every rank holds whole counted once.  All ranks call
    it."""
    import torch.distributed as dist
    sums = torch.zeros(2, dtype=torch.float64)
    for k in g:
        if ss[k].pieces() == 1 and rank:
            continue
        whole = np.load(os.path.join(tmp, f"{stem}.{k}.npy"), mmap_mode="c")
        p = ss[k].place(torch.from_numpy(whole)).float()
        sums[0] += float(((g[k].float() - p) ** 2).sum())
        sums[1] += float((p ** 2).sum())
        del p, whole
    dist.all_reduce(sums)
    return float((sums[0] / sums[1]) ** 0.5)


def tp_xlstm_cfg():
    from repro_torch.configs.base import get_config
    return get_config(XLSTM_ARCH).replace(num_layers=XLSTM_TRAIN_LAYERS)


def tp_xlstm_batch(cfg, dev) -> dict:
    from repro_torch.data.synthetic import lm_batch
    return lm_batch(0, batch=TP_XL_BATCH, seq_len=TP_XL_SEQ,
                    vocab=cfg.vocab_size, device=dev)


def tp_rank_xlstm(mesh, dev, tmp: str, rank: int) -> dict:
    """(c) on this rank: its shares placed from the whole draw, an mLSTM
    layer's and the sLSTM layer's forward timed both ways, one NGHF update
    with candidates (counted, watched, timed) and one without (the last
    iterate, saved)."""
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.models.registry import get_model
    cfg = tp_xlstm_cfg()
    start = get_model(cfg).init(SEED, device=dev)
    ss = param_shardings(cfg, mesh, start)
    params = {k: ss[k].place(v) for k, v in start.items()}
    del start
    torch.cuda.empty_cache()
    batch = tp_xlstm_batch(cfg, dev)
    slot = {kind: f"periods.slot{cfg.block_pattern.index(kind)}."
            for kind in ("mlstm", "slstm")}
    layers = {kind: tp_layer_times(cfg, mesh, ss, params, batch, prefix,
                                   kind) for kind, prefix in slot.items()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with watched_gathers(mesh) as used:
        _, m, dt, nbytes = fsdp_one_update(cfg, params, batch, mesh, ss,
                                           **FSDP_RANK_ITERS,
                                           **FSDP_RANK_OPT)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    new, _, dt_last, _ = fsdp_one_update(cfg, params, batch, mesh, ss,
                                         eval_candidates=False,
                                         **FSDP_RANK_ITERS, **FSDP_RANK_OPT)
    torch.save({k: v.cpu() for k, v in new.items()},
               os.path.join(tmp, f"rank{rank}_c.pt"))
    del params, new
    torch.cuda.empty_cache()
    return {"metrics": m, "launches": launches, "s": dt, "s_last": dt_last,
            "theta_bytes": nbytes, "peak": peak, "used": used,
            "layers": layers}


def tp_whisper_batch(cfg, dev) -> dict:
    """Phase 9's batch 0 (B 16 x T 448 with its frame embeddings)."""
    return lm_train_batch(cfg, 0, dev)


def tp_rank_whisper(mesh, dev, tmp: str, rank: int) -> dict:
    """(d) on this rank: its shares placed from the whole draw; the
    gradient (watched, timed) against one process's (this rank's shares
    of the memory-mapped ``wh_one.<key>.npy``); then one Adam step
    through ``build_step`` on the mesh, timed."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.curvature import grad_and_loss
    from repro_torch.core.optim.base import data_splits
    from repro_torch.launch import fsdp
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.launch.steps import build_step, lm_forward
    from repro_torch.losses.chunked_lm import ChunkedCELoss
    from repro_torch.models.registry import get_model
    cfg = get_config(LM_TRAIN_ARCH)
    model = get_model(cfg)
    start = model.init(SEED, device=dev)
    ss = param_shardings(cfg, mesh, start)
    params = {k: ss[k].place(v) for k, v in start.items()}
    del start
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b = tp_whisper_batch(cfg, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with watched_gathers(mesh) as used, fsdp.step_context(cfg, mesh, ss):
        loss, _, g = grad_and_loss(lm_forward(cfg, model), ChunkedCELoss(),
                                   params, b, mesh=mesh,
                                   data_split=data_splits(ss))
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    grad_rel = tp_grad_rel(g, ss, tmp, "wh_one", rank)
    del g
    step, opt = build_step(cfg, "adam", lr=TP_WH_ADAM_LR, mesh=mesh,
                           state_sharding=ss)
    state = opt.init(params, state_sharding=ss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with fsdp.collective_log() as coll:
        params, state, m = step(params, state, b)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = {"step_coll": model_collectives(coll, mesh),
           "grad_rel": grad_rel, "loss": float(loss), "grad_s": grad_s,
           "step_s": dt, "step_loss": float(m["loss"]),
           "peak": torch.cuda.max_memory_allocated(), "used": used}
    del params, state
    torch.cuda.empty_cache()
    return out


def tp_granite_cfg():
    from repro_torch.configs.base import get_config
    return get_config(MOE_ARCH).replace(num_layers=TP_GD_LAYERS,
                                        moe_impl="dispatch",
                                        compute_dtype="float32")


def tp_granite_batch(cfg, dev) -> dict:
    from repro_torch.data.synthetic import lm_batch
    b = lm_batch(0, batch=TP_GD_BATCH, seq_len=TP_GD_SEQ,
                 vocab=cfg.vocab_size, device=dev)
    return dict(b, labels=b["tokens"])


def tp_rank_granite(mesh, dev, tmp: str, rank: int) -> dict:
    """(e) on this rank: its shares placed from the whole draw; the
    gradient (watched, timed, the dropped pairs of each dispatch layer
    counted) against one process's (this rank's shares of the
    memory-mapped ``gd_one.<key>.npy``)."""
    from repro_torch.core.curvature import grad_and_loss
    from repro_torch.core.optim.base import data_splits
    from repro_torch.launch import fsdp
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.launch.steps import lm_forward
    from repro_torch.losses.chunked_lm import ChunkedCELoss
    from repro_torch.models import layers
    from repro_torch.models.registry import get_model
    cfg = tp_granite_cfg()
    model = get_model(cfg)
    start = model.init(SEED, device=dev)
    ss = param_shardings(cfg, mesh, start)
    params = {k: ss[k].place(v) for k, v in start.items()}
    del start
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b = tp_granite_batch(cfg, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with watched_gathers(mesh) as used, fsdp.step_context(cfg, mesh, ss), \
            layers.dispatch_drops() as drops:
        loss, _, g = grad_and_loss(lm_forward(cfg, model), ChunkedCELoss(),
                                   params, b, mesh=mesh,
                                   data_split=data_splits(ss))
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    out = {"grad_rel": tp_grad_rel(g, ss, tmp, "gd_one", rank),
           "loss": float(loss), "grad_s": grad_s,
           "drops": [int(n) for n in drops],
           "peak": torch.cuda.max_memory_allocated(), "used": used}
    del params, g
    torch.cuda.empty_cache()
    return out


def tp_rank(rank: int, world: int, tmp: str, device: str) -> None:
    """One of the gloo ranks of phase 16 on the card, a (1, world) mesh:
    (a) to (e); its records written to ``tmp``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    try:
        dev = torch.device(device)
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
            rank=rank, world_size=world)
        mesh = make_debug_mesh(1, world, device=dev, backend="gloo")
        coord = dict(zip(mesh.axis_names,
                         mesh.device_mesh.get_coordinate()))
        rec = {"model_index": coord["model"], "seconds": {}}
        for key, fn in (("a", tp_rank_qwen), ("b", tp_rank_rg),
                        ("c", tp_rank_xlstm), ("d", tp_rank_whisper),
                        ("e", tp_rank_granite)):
            t0 = time.perf_counter()
            rec[key] = fn(mesh, dev, tmp, rank)
            rec["seconds"][key] = round(time.perf_counter() - t0, 3)
        dist.barrier()
        dist.destroy_process_group()
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    except BaseException:
        import traceback
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def tp_rg_batch(cfg, dev) -> dict:
    from repro_torch.data.synthetic import lm_batch
    b = lm_batch(RG_TRAIN_STEPS, batch=TP_RG_BATCH, seq_len=RG_TRAIN_SEQ,
                 vocab=cfg.vocab_size, device=dev)
    return dict(b, labels=b["tokens"])


def tp_one_process(dev, tmp: str) -> dict:
    """The one-process references: (a) qwen2.5-3b's update with
    candidates and without (the last iterate), on the card; (b)
    recurrentgemma-9b's gradient on the plain path (attention's plain
    version), saved to ``tmp`` for the ranks; (c) xlstm-125m's update as
    (a)'s; (d) whisper-base's gradient, saved for the ranks."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.curvature import grad_and_loss
    from repro_torch.launch.steps import lm_forward
    from repro_torch.losses.chunked_lm import ChunkedCELoss
    from repro_torch.models.registry import get_model
    cfg = get_config(DENSE_ARCH).replace(num_layers=FSDP_RANK_LAYERS)
    start = get_model(cfg).init(SEED, device=dev)
    batch = fsdp_rank_batch(cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    _, m_one, t_one, bytes_one = fsdp_one_update(
        cfg, start, batch, **FSDP_RANK_ITERS, **FSDP_RANK_OPT)
    peak_one = torch.cuda.max_memory_allocated()
    last_one, _, _, _ = fsdp_one_update(
        cfg, start, batch, eval_candidates=False, **FSDP_RANK_ITERS,
        **FSDP_RANK_OPT)
    out = {"a": {"start": {k: v.cpu() for k, v in start.items()},
                 "last": {k: v.cpu() for k, v in last_one.items()},
                 "metrics": m_one, "s": t_one, "theta_bytes": bytes_one,
                 "peak": peak_one}}
    del start, last_one
    torch.cuda.empty_cache()
    cfg = get_config(LM_ARCH).replace(num_layers=RG_TRAIN_LAYERS)
    model = get_model(cfg)
    params = model.init(SEED, device=dev)
    b = tp_rg_batch(cfg, dev)
    with plain_attention():
        n = bwd_counts()
        loss, _, g = grad_and_loss(lm_forward(cfg, model), ChunkedCELoss(),
                                   params, b)
        check(bwd_counts() == n, "phase 16: the plain path launched a "
              "derivative kernel")
    del params
    # one raw .npy file a leaf: torch.save's zip checksums the 11 GB
    t0 = time.perf_counter()
    for k, v in g.items():
        np.save(os.path.join(tmp, f"rg_plain.{k}.npy"), v.cpu().numpy())
    out["b"] = {"loss": float(loss), "save_s": time.perf_counter() - t0,
                "n_leaves": len(g)}
    del g
    torch.cuda.empty_cache()
    cfg = tp_xlstm_cfg()
    start = get_model(cfg).init(SEED, device=dev)
    batch = tp_xlstm_batch(cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    _, m_one, t_one, bytes_one = fsdp_one_update(
        cfg, start, batch, **FSDP_RANK_ITERS, **FSDP_RANK_OPT)
    peak_one = torch.cuda.max_memory_allocated()
    last_one, _, _, _ = fsdp_one_update(
        cfg, start, batch, eval_candidates=False, **FSDP_RANK_ITERS,
        **FSDP_RANK_OPT)
    out["c"] = {"start": {k: v.cpu() for k, v in start.items()},
                "last": {k: v.cpu() for k, v in last_one.items()},
                "metrics": m_one, "s": t_one, "theta_bytes": bytes_one,
                "peak": peak_one}
    del start, last_one
    torch.cuda.empty_cache()
    cfg = get_config(LM_TRAIN_ARCH)
    model = get_model(cfg)
    params = model.init(SEED, device=dev)
    b = tp_whisper_batch(cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _, g = grad_and_loss(lm_forward(cfg, model), ChunkedCELoss(),
                               params, b)
    torch.cuda.synchronize()
    out["d"] = {"loss": float(loss), "grad_s": time.perf_counter() - t0,
                "peak": torch.cuda.max_memory_allocated()}
    del params
    for k, v in g.items():
        np.save(os.path.join(tmp, f"wh_one.{k}.npy"), v.cpu().numpy())
    del g
    torch.cuda.empty_cache()
    out["e"] = tp_granite_one(dev, tmp)
    return out


def tp_granite_one(dev, tmp: str) -> dict:
    """(e)'s one-process gradient, saved for the ranks, and the pairs
    each dispatch layer dropped."""
    from repro_torch.core.curvature import grad_and_loss
    from repro_torch.launch.steps import lm_forward
    from repro_torch.losses.chunked_lm import ChunkedCELoss
    from repro_torch.models import layers
    from repro_torch.models.registry import get_model
    cfg = tp_granite_cfg()
    model = get_model(cfg)
    params = model.init(SEED, device=dev)
    b = tp_granite_batch(cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with layers.dispatch_drops() as drops:
        loss, _, g = grad_and_loss(lm_forward(cfg, model), ChunkedCELoss(),
                                   params, b)
    torch.cuda.synchronize()
    out = {"loss": float(loss), "grad_s": time.perf_counter() - t0,
           "drops": [int(n) for n in drops],
           "peak": torch.cuda.max_memory_allocated()}
    del params
    for k, v in g.items():
        np.save(os.path.join(tmp, f"gd_one.{k}.npy"), v.cpu().numpy())
    del g
    torch.cuda.empty_cache()
    return out


def tp_local_kernels(dev, errs: dict) -> dict:
    """The windowed forward, dq, dk/dv and jvp kernels at (b)'s local
    shape against their plain versions on the same tensors (phase 2's and
    phase 13's tolerances), then timed beside the plain versions (CUDA
    events; the comparison launches are not counted)."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import swa_attention as SWA
    shape, dt = TP_RG_LOCAL, torch.bfloat16
    tag = "x".join(map(str, shape)) + "_bfloat16"
    x = check_bwd_case(dev, shape, dt, SEED + 161, errs)
    q, k, v, w = x["q"], x["k"], x["v"], shape[-1]
    n, nb = swa_counts(), bwd_counts()
    got = SWA.swa_attention(q, k, v, w)
    err = compare_swa(tag, got, R.swa_attention_ref(q, k, v, w), dt, errs)
    check(swa_counts()[0] == n[0] + 1, "phase 16: the local-shape forward "
          "did not launch the tensor-core kernel")
    _, lse, dd = SWA.launch_dq(q, k, v, x["g"], w)
    fns = {"swa_attention": lambda: SWA.swa_attention(q, k, v, w),
           BWD_KERNELS[0]: lambda: SWA.launch_dq(q, k, v, x["g"], w),
           BWD_KERNELS[1]: lambda: SWA.launch_dkdv(q, k, v, x["g"], lse, dd,
                                                   w),
           BWD_KERNELS[2]: lambda: SWA.swa_attention_jvp(
               q, k, v, x["tq"], x["tk"], x["tv"], w),
           "plain_forward": lambda: R.swa_attention_ref(q, k, v, w),
           "plain_vjp": lambda: R.swa_attention_vjp_ref(q, k, v, x["g"], w),
           "plain_jvp": lambda: R.swa_attention_jvp_ref(
               q, k, v, x["tq"], x["tk"], x["tv"], w)}
    times = {name: cuda_time_ms(fn, 1 if name.startswith("plain") else 5)
             for name, fn in fns.items()}
    SWA.swa_attention.launches, SWA.swa_attention.cuda_core_launches = n
    set_bwd_counts(nb)
    work = dict(bwd_work(shape, dt), swa_attention=swa_work(shape, dt))
    out = {}
    for name, (byt, flops) in work.items():
        b_ms, b_by = swa_bound(byt, flops)
        out[name] = {"ms": times[name], "bound_ms": b_ms, "bound_by": b_by}
    log(f"phase 16 local shape (B,T,H,K,hd,window)={shape} bf16 (G "
        f"{shape[2] // shape[3]}): forward == plain, max |d| {err:.3g}; "
        + "; ".join(f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f} ms by "
                    f"{v['bound_by']})" for k, v in out.items())
        + f"; plain forward {times['plain_forward']:.4f} ms, plain vjp "
        f"{times['plain_vjp']:.4f} ms, plain jvp {times['plain_jvp']:.4f} ms")
    del x, q, k, v, got, lse, dd
    torch.cuda.empty_cache()
    return out


def tp_row_products(dev) -> dict:
    """(a)'s row-parallel products on one rank, ``wo``'s (B·T, H·hd/2) x
    (H·hd/2, d) and ``w_out``'s (B·T, d_ff/2) x (d_ff/2, d): the bf16
    GEMM with an f32 result (``layers.partial_matmul``) against the f32
    upcast's GEMM on the same inputs (forward and both gradients), then
    both timed, forward and forward + backward (CUDA events)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.layers import partial_matmul
    cfg = get_config(DENSE_ARCH)
    B, T, d = FSDP_RANK_BATCH, DENSE_TRAIN_SEQ, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(SEED + 162)
    out = {}
    for name, k in (("wo", cfg.num_heads * cfg.resolved_head_dim // TP_RANKS),
                    ("w_out", cfg.d_ff // TP_RANKS)):
        x, w, ct = (torch.randn(s, generator=gen, device=dev).to(
            torch.bfloat16) for s in ((B, T, k), (k, d), (B, T, d)))
        ct = ct.float()

        def upcast(a, b):
            return a.float() @ b.float()

        def both(f):
            a, b = (t.detach().requires_grad_(True) for t in (x, w))
            y = f(a, b)
            return (y,) + torch.autograd.grad(y, (a, b), ct)

        got, want = both(partial_matmul), both(upcast)
        check(got[0].dtype == torch.float32
              and got[1].dtype == got[2].dtype == torch.bfloat16,
              f"phase 16 {name} product: dtypes "
              f"{[t.dtype for t in got]}")
        errs = [float((g.detach().float() - v.detach().float()).abs().max()
                      / v.detach().float().abs().max())
                for g, v in zip(got, want)]
        check(errs[0] <= TP_PM_F32_REL and max(errs[1:]) <= TP_PM_BF16_REL,
              f"phase 16 {name} product vs the f32 upcast: rel max {errs}")
        rec = {"errs": errs, "shape": [B * T, k, d]}
        for form, f in (("bf16_f32", partial_matmul), ("f32", upcast)):
            rec[form + "_fwd_ms"] = cuda_time_ms(lambda: f(x, w), 20)
            rec[form + "_fwd_bwd_ms"] = cuda_time_ms(lambda: both(f), 20)
        out[name] = rec
    log("phase 16 row-parallel products (bf16 operands, f32 result) vs the "
        "f32 upcast's GEMM (TF32 off): " + "; ".join(
            f"{n} (M,K,N)={tuple(r['shape'])}: rel max y, dx, dw "
            + ", ".join(f"{e:.3g}" for e in r["errs"])
            + f" (limits {TP_PM_F32_REL}, {TP_PM_BF16_REL:.4g}); forward "
            f"{r['bf16_f32_fwd_ms']:.4f} vs {r['f32_fwd_ms']:.4f} ms, "
            f"forward + backward {r['bf16_f32_fwd_bwd_ms']:.4f} vs "
            f"{r['f32_fwd_bwd_ms']:.4f} ms" for n, r in out.items()))
    return out


def tp_put_together(cfg, shares: list, order: list, shapes: dict,
                    tag: str) -> dict:
    """The whole leaves from the ranks' shares (in "model" order) of a
    (1, TP_RANKS) mesh; a leaf no dim of which "model" splits is bitwise
    the same on every rank."""
    from types import SimpleNamespace
    from repro_torch.launch.sharding import param_shardings
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 1, "model": TP_RANKS})
    specs = {k: s.spec for k, s in param_shardings(cfg, mesh,
                                                    shapes).items()}
    whole = {}
    for k in shapes:
        dims = [d for d, e in enumerate(specs[k]) if e == "model"]
        if dims:
            whole[k] = torch.cat([shares[r][k] for r in order], dims[0])
        else:
            check(all(torch.equal(sh[k], shares[0][k]) for sh in shares),
                  f"{tag}: ranks differ on {k}")
            whole[k] = shares[0][k]
        check(tuple(whole[k].shape) == shapes[k][0],
              f"{tag}: {k} put together as {tuple(whole[k].shape)}")
    return whole


def phase_tp(dev, errs: dict) -> dict:
    """Phase 16: tensor-parallel compute over "model" on two gloo ranks
    of the card, a (1, 2) mesh: (a) qwen2.5-3b's NGHF update against one
    process's, (b) recurrentgemma-9b's gradient against one process's
    plain path and one SGD step, the windowed kernels at its local
    shape, (c) xlstm-125m's NGHF update against one process's, (d)
    whisper-base's gradient against one process's and one Adam step."""
    import tempfile
    from repro_torch.configs.base import get_config
    from repro_torch.models.registry import get_model
    t_phase = time.perf_counter()
    cfg = get_config(DENSE_ARCH).replace(num_layers=FSDP_RANK_LAYERS)
    model = get_model(cfg)
    shapes = model.param_shapes()
    per = fsdp_launches(len(shapes), **FSDP_RANK_ITERS)
    local = tp_local_kernels(dev, errs)
    rows = tp_row_products(dev)
    t_kern = time.perf_counter() - t_phase
    with tempfile.TemporaryDirectory() as tmp:
        one = tp_one_process(dev, tmp)
        t_one = time.perf_counter() - t_phase - t_kern
        spawn_ranks(tp_rank, TP_RANKS, dev, TP_TIMEOUT_S, tmp)
        recs = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                for r in range(TP_RANKS)]
        shares = [torch.load(Path(tmp, f"rank{r}_a.pt"))
                  for r in range(TP_RANKS)]
        shares_c = [torch.load(Path(tmp, f"rank{r}_c.pt"))
                    for r in range(TP_RANKS)]
    order = sorted(range(TP_RANKS), key=lambda r: recs[r]["model_index"])
    tag = f"gloo 1x2 {DENSE_ARCH}"
    # (a) the decision, the last iterate, the split, the launches
    a1, a = one["a"], [rec["a"] for rec in recs]
    text = same_choice(f"{tag} vs one process", a[0]["metrics"],
                       a1["metrics"])
    whole = tp_put_together(cfg, shares, order, shapes, tag)
    rel = delta_rel_l2(whole, a1["last"], a1["start"])
    check(rel <= TP_DELTA_REL_L2, f"{tag}: last-iterate Δθ vs one process "
          f"rel-L2 {rel:.3g}")
    H, hd, d = cfg.num_heads, cfg.resolved_head_dim, cfg.d_model
    want = {"periods.slot0.attn.wq": [d, H * hd // TP_RANKS],
            "periods.slot0.mlp.w_in": [d, cfg.d_ff // TP_RANKS],
            "periods.slot0.mlp.w_out": [cfg.d_ff // TP_RANKS, d],
            "embed.table": [cfg.vocab_size // TP_RANKS, d]}
    for r, rec in enumerate(a):
        check(all(rec["used"][k] == v for k, v in want.items())
              and rec["used"]["model_gathers"] == 0,
              f"{tag} rank {r}: leaves used at "
              f"{ {k: rec['used'][k] for k in want} }, "
              f"{rec['used']['model_gathers']} gathers over 'model'")
        launches = {k: 0 for k in rec["launches"]}
        launches["cg_fused_update"] = per
        check(rec["launches"] == launches,
              f"{tag} rank {r}: launches {rec['launches']}, want {launches}")
    ratio = [rec["theta_bytes"] / a1["theta_bytes"] for rec in a]
    lay = [rec["layer"] for rec in a]
    log(f"{tag} on one card, tensor-parallel compute (each rank "
        f"{H // TP_RANKS} of {H} query heads, {cfg.num_kv_heads // TP_RANKS} "
        f"of {cfg.num_kv_heads} kv heads, half the FFN columns and half the "
        f"tied vocab; leaves used at "
        + ", ".join(f"{k.split('.')[-1]} {tuple(v)}" for k, v in want.items())
        + ", no gather over 'model'), full width, "
        f"{FSDP_RANK_LAYERS} layers, B={FSDP_RANK_BATCH}, T="
        f"{DENSE_TRAIN_SEQ}, NGHF ({FSDP_RANK_ITERS['cg_iters']} CG, "
        f"{FSDP_RANK_ITERS['ng_iters']} NG iterations), warm start, Fisher "
        f"diagonal: vs one process {text}; last-iterate Δθ rel-L2 {rel:.4g} "
        f"(limit {TP_DELTA_REL_L2}); ranks equal on every replicated leaf; "
        f"θ-sized bytes a rank " + ", ".join(str(r["theta_bytes"]) for r in a)
        + f" against one process's {a1['theta_bytes']} (ratio "
        + ", ".join(f"{x:.4f}" for x in ratio) + "); peak device memory a "
        "rank " + ", ".join(f"{r['peak'] / 1e9:.3f}" for r in a)
        + f" GB (one process {a1['peak'] / 1e9:.3f} GB); update with "
        "candidates " + ", ".join(f"{r['s']:.3f}" for r in a)
        + " s a rank, without " + ", ".join(f"{r['s_last']:.3f}" for r in a)
        + f" s (one process {a1['s']:.3f} s); {per} cg_fused_update "
        "launches a rank; layer 0's forward split "
        + ", ".join(f"{x['split_ms']:.3f}" for x in lay) + " ms vs gathered "
        "whole (phase 15's layer) " + ", ".join(f"{x['whole_ms']:.3f}"
                                                 for x in lay)
        + " ms a rank (turns "
        + "; ".join(str({k: [round(t, 3) for t in v]
                         for k, v in x["turns"].items()}) for x in lay)
        + "), outputs rel-L2 " + ", ".join(f"{x['rel']:.3g}" for x in lay))
    # (b) the gradient, the local kernels on the main path, the step
    b1, b = one["b"], [rec["b"] for rec in recs]
    grad_rel = b[0]["grad_rel"]
    check(all(x["grad_rel"] == grad_rel for x in b)
          and grad_rel <= RG_GRAD_REL_L2,
          f"gloo 1x2 {LM_ARCH}: gradient vs the one-process plain path "
          f"rel-L2 {[x['grad_rel'] for x in b]} (limit {RG_GRAD_REL_L2})")
    geometry = [[list(TP_RG_LOCAL[:3]) + [TP_RG_LOCAL[4]],
                 list(TP_RG_LOCAL[:2]) + [1, TP_RG_LOCAL[4]]]]
    rg_cfg = get_config(LM_ARCH)
    rg_dim = rg_cfg.rglru_dim or rg_cfg.d_model
    want_b = {"periods.slot0.w_x": [rg_cfg.d_model, rg_dim // TP_RANKS],
              "periods.slot0.w_rec_gate": [rg_dim, rg_dim // TP_RANKS],
              "periods.slot0.w_out": [rg_dim // TP_RANKS, rg_cfg.d_model],
              "periods.slot0.mlp.w_in": [rg_cfg.d_model,
                                         rg_cfg.d_ff // TP_RANKS],
              "periods.slot0.conv_b": [rg_dim]}
    for r, rec in enumerate(b):
        check(all(rec["used"][k] == v for k, v in want_b.items())
              and rec["used"]["model_gathers"] == 0,
              f"gloo 1x2 {LM_ARCH} rank {r}: leaves used at "
              f"{ {k: rec['used'][k] for k in want_b} }, "
              f"{rec['used']['model_gathers']} gathers over 'model'")
        check(rec["grad_forward"] == [1, 0] and rec["grad_launches"]
              == [1, 1, 0] and rec["step_forward"] == [1, 0]
              and rec["step_launches"] == [1, 1, 0]
              and rec["used"]["swa"] == geometry,
              f"gloo 1x2 {LM_ARCH} rank {r}: windowed launches (forward "
              f"tensor-core, CUDA-core) {rec['grad_forward']}, (dq, dk/dv, "
              f"jvp) {rec['grad_launches']} for the gradient, "
              f"{rec['step_forward']} / {rec['step_launches']} for the "
              f"step; q, k shapes {rec['used']['swa']}, want {geometry}")
        check(np.isfinite(rec["step_loss"]), f"gloo 1x2 {LM_ARCH} rank {r}: "
              f"step loss {rec['step_loss']}")
    log(f"gloo 1x2 {LM_ARCH} on one card, full width, {RG_TRAIN_LAYERS} "
        f"layers, B {TP_RG_BATCH} x T {RG_TRAIN_SEQ}: the local layer's "
        f"attention on each rank's {TP_RG_LOCAL[2]} query heads and "
        f"{TP_RG_LOCAL[3]} kv head (forward, dq and dk/dv once a gradient, "
        f"tensor-core), the RG-LRU blocks on each rank's "
        f"{rg_dim // TP_RANKS} of {rg_dim} channels and their MLPs on half "
        f"the columns (leaves used at "
        + ", ".join(f"{k.split('.', 2)[-1]} {tuple(v)}"
                    for k, v in want_b.items())
        + f", {b[0]['used']['model_gathers']} gathers over 'model' a "
        f"gradient); gradient vs the one-process plain path rel-L2 "
        f"{grad_rel:.4g} (limit {RG_GRAD_REL_L2}), loss "
        + ", ".join(f"{x['loss']:.6f}" for x in b)
        + f" vs {b1['loss']:.6f}; SGD step " + ", ".join(
            f"{x['step_s'] * 1e3:.3f}" for x in b) + " ms a rank (phase "
        f"13's one process at B 2: about 790 ms), peak device memory a "
        f"rank " + ", ".join(f"{x['peak'] / 1e9:.3f}" for x in b)
        + f" GB; the plain gradient ({b1['n_leaves']} leaves) saved for "
        f"the ranks in {b1['save_s']:.3f} s; RG-LRU block 0's forward "
        "split " + ", ".join(f"{x['layer']['split_ms']:.3f}" for x in b)
        + " ms vs gathered whole " + ", ".join(
            f"{x['layer']['whole_ms']:.3f}" for x in b)
        + " ms a rank (turns " + "; ".join(
            str({k: [round(t, 3) for t in v]
                 for k, v in x["layer"]["turns"].items()}) for x in b)
        + "), outputs rel-L2 " + ", ".join(f"{x['layer']['rel']:.3g}"
                                           for x in b))
    xl = tp_check_xlstm(one["c"], [rec["c"] for rec in recs], shares_c,
                        order)
    wh = tp_check_whisper(one["d"], [rec["d"] for rec in recs])
    tp_check_granite(one["e"], [rec["e"] for rec in recs])
    card = card_line()
    for key, case, T, want_sp in (
            ("a", f"(a) {DENSE_ARCH}", DENSE_TRAIN_SEQ, True),
            ("b", f"(b) {LM_ARCH}", RG_TRAIN_SEQ, True),
            ("c", f"(c) {XLSTM_ARCH}", TP_XL_SEQ, True),
            ("d", f"(d) {LM_TRAIN_ARCH}", LM_TRAIN_SEQ, False),
            ("e", f"(e) {MOE_ARCH} dispatch", TP_GD_SEQ, True)):
        tp_sp_log(case, [rec[key] for rec in recs], T, want_sp, card,
                  TP_BEFORE.get(key))
    dt = time.perf_counter() - t_phase
    log(f"phase 16 (tensor-parallel compute, (a) to (e)) {dt:.3f} s (local "
        f"kernels and "
        f"row products {t_kern:.3f}, one process {t_one:.3f}, ranks "
        f"{dt - t_kern - t_one:.3f}; a rank's (a) to (e) "
        f"{[rec['seconds'] for rec in recs]})")
    tp_launches = {"dq": b[0]["grad_launches"][0] + b[0]["step_launches"][0],
                   "dkdv": b[0]["grad_launches"][1]
                   + b[0]["step_launches"][1],
                   "jvp": b[0]["grad_launches"][2]
                   + b[0]["step_launches"][2],
                   "forward": b[0]["grad_forward"][0]
                   + b[0]["step_forward"][0]}
    return {"cg": {"tp_gloo_update_s": [x["s"] for x in a],
                   "tp_gloo_theta_ratio": ratio,
                   "tp_gloo_peak_gb": [x["peak"] / 1e9 for x in a],
                   "tp_gloo_delta_rel_l2": rel,
                   "tp_gloo_launches_per": per, **xl},
            "local": local, "launches": tp_launches, "rows": rows,
            "grad_rel": grad_rel, "whisper": wh}


def coll_text(coll: dict) -> str:
    """``model_collectives``' counts as a phrase."""
    return ", ".join(
        f"{kind} {c['calls']} calls {c['bytes'] / 1e6:.3f} MB (a rank sends "
        f"{c['ring_bytes'] / 1e6:.3f} MB)"
        for kind, c in sorted(coll.items())) or "none"


def tp_sp_log(case: str, recs: list, T: int, want_sp: bool, card: str,
              before) -> None:
    """A phase 16 case's sequence-parallel reading: whether the stream was
    split over T between the blocks (checked against ``want_sp``), its
    shapes, the collectives over "model" of the watched update or
    gradient (and of the step, where there is one), each rank's peak, the
    layer's forward three ways, beside the figures from before the stream
    was split."""
    streams = [rec["used"]["stream"] for rec in recs]
    ran = bool(streams[0]) and all(
        all(shape[1] == T // TP_RANKS for shape in st) for st in streams)
    check(ran == want_sp, f"phase 16 {case}: residual stream shapes "
          f"{streams} at T {T}: sequence parallelism "
          f"{'ran' if ran else 'did not run'}")
    text = (f"phase 16 SP {case} on {card}: sequence-parallel activations "
            f"{'ran' if ran else 'did not run'}; residual stream "
            f"{streams[0] or 'not in blocks (encoder-decoder)'} a rank; "
            "over 'model', the watched update or gradient: "
            + "; ".join(f"rank {r}: {coll_text(rec['used']['coll'])}"
                        for r, rec in enumerate(recs)))
    if "step_coll" in recs[0]:
        text += "; the step: " + coll_text(recs[0]["step_coll"])
    if "ab" in recs[0]:
        text += "; a gradient with the stream whole, then split, a rank: " \
            + "; ".join(
                f"{mode} " + ", ".join(f"{rec['ab'][mode]['s']:.3f}"
                                       for rec in recs)
                + " s, peak " + ", ".join(
                    f"{rec['ab'][mode]['peak'] / 1e9:.3f}" for rec in recs)
                + f" GB, {coll_text(recs[0]['ab'][mode]['coll'])}"
                for mode in ("whole", "split"))
    text += "; peak a rank " + ", ".join(f"{rec['peak'] / 1e9:.3f}"
                                         for rec in recs) + " GB"
    lays = [rec["layer"] for rec in recs if "layer" in rec] + [
        lay for rec in recs for lay in rec.get("layers", {}).values()]
    if lays:
        text += "; layer forward whole / split / split with the stream " \
            "split (ms) " + ", ".join(
                f"{x['whole_ms']:.3f} / {x['split_ms']:.3f} / "
                f"{x['sp_ms']:.3f} (rel-L2 {x['sp_rel']:.3g})" for x in lays)
    if before:
        text += f"; before the stream was split, {before}"
    log(text)


def tp_check_granite(one: dict, e: list) -> None:
    """(e)'s checks: the gradient against one process's, every dispatch
    layer's dropped pairs the same, the experts used at their split
    shapes (20 of 40 a rank), the router and the odd vocabulary whole, no
    gather over "model"; the log line."""
    cfg = tp_granite_cfg()
    tag = f"gloo 1x2 {MOE_ARCH} (dispatch)"
    rel = e[0]["grad_rel"]
    check(all(x["grad_rel"] == rel for x in e) and rel <= TP_GD_GRAD_REL_L2,
          f"{tag}: gradient vs one process rel-L2 "
          f"{[x['grad_rel'] for x in e]} (limit {TP_GD_GRAD_REL_L2})")
    check(all(x["drops"] == one["drops"] for x in e)
          and len(one["drops"]) == TP_GD_LAYERS,
          f"{tag}: dropped pairs a layer {[x['drops'] for x in e]}, one "
          f"process {one['drops']}")
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.d_ff
    hq = cfg.num_heads * cfg.resolved_head_dim
    want = {"periods.slot0.moe.w_in": [E // TP_RANKS, d, ff],
            "periods.slot0.moe.w_out": [E // TP_RANKS, ff, d],
            "periods.slot0.moe.router": [d, E],
            "periods.slot0.attn.wq": [d, hq // TP_RANKS],
            "embed.table": [cfg.vocab_size, d]}
    for r, rec in enumerate(e):
        check(all(rec["used"][k] == v for k, v in want.items())
              and rec["used"]["model_gathers"] == 0,
              f"{tag} rank {r}: leaves used at "
              f"{ {k: rec['used'][k] for k in want} }, "
              f"{rec['used']['model_gathers']} gathers over 'model'")
    log(f"{tag} on one card, full width, {TP_GD_LAYERS} layers, B "
        f"{TP_GD_BATCH} x T {TP_GD_SEQ}, f32: each rank {E // TP_RANKS} of "
        f"{E} experts' buckets, {cfg.num_heads // TP_RANKS} of "
        f"{cfg.num_heads} query heads, the {cfg.vocab_size}-token vocab "
        f"whole; gradient vs one process rel-L2 {rel:.4g} (limit "
        f"{TP_GD_GRAD_REL_L2}), loss " + ", ".join(
            f"{x['loss']:.6f}" for x in e) + f" vs {one['loss']:.6f}; "
        f"dropped pairs a layer {e[0]['drops']} (one process "
        f"{one['drops']}); gradient " + ", ".join(
            f"{x['grad_s'] * 1e3:.3f}" for x in e)
        + f" ms a rank (one process {one['grad_s'] * 1e3:.3f} ms); peak "
        "a rank " + ", ".join(f"{x['peak'] / 1e9:.3f}" for x in e)
        + f" GB (one process {one['peak'] / 1e9:.3f} GB)")


def tp_check_xlstm(one: dict, c: list, shares: list, order: list) -> dict:
    """(c)'s checks against one process: the decision, the last-iterate
    Δθ, replicated leaves bitwise equal across ranks, the leaves used at
    their split shapes with no gather over "model", the CG launches; the
    log line; the ``cg_fused_update`` row's ``tp_xlstm_*`` keys."""
    from repro_torch.models.registry import get_model
    cfg = tp_xlstm_cfg()
    shapes = get_model(cfg).param_shapes()
    per = fsdp_launches(len(shapes), **FSDP_RANK_ITERS)
    tag = f"gloo 1x2 {XLSTM_ARCH}"
    text = same_choice(f"{tag} vs one process", c[0]["metrics"],
                       one["metrics"])
    whole = tp_put_together(cfg, shares, order, shapes, tag)
    rel = delta_rel_l2(whole, one["last"], one["start"])
    check(rel <= TP_DELTA_REL_L2, f"{tag}: last-iterate Δθ vs one process "
          f"rel-L2 {rel:.3g}")
    d, H = cfg.d_model, cfg.num_heads
    inner = int(cfg.proj_factor * d)
    s = cfg.block_pattern.index("slstm")
    want = {"periods.slot0.w_q": [inner, inner // TP_RANKS],
            "periods.slot0.w_up": [d, inner // TP_RANKS],
            "periods.slot0.w_if": [inner // TP_RANKS, 2 * H],
            "periods.slot0.w_down": [inner // TP_RANKS, d],
            f"periods.slot{s}.w_zifo": [d, 4 * d // TP_RANKS],
            f"periods.slot{s}.r_zifo": [4, H // TP_RANKS, d // H, d // H],
            f"periods.slot{s}.w_up": [d, inner // TP_RANKS],
            "embed.table": [cfg.vocab_size // TP_RANKS, d]}
    for r, rec in enumerate(c):
        check(all(rec["used"][k] == v for k, v in want.items())
              and rec["used"]["model_gathers"] == 0,
              f"{tag} rank {r}: leaves used at "
              f"{ {k: rec['used'][k] for k in want} }, "
              f"{rec['used']['model_gathers']} gathers over 'model'")
        launches = {k: 0 for k in rec["launches"]}
        launches["cg_fused_update"] = per
        check(rec["launches"] == launches,
              f"{tag} rank {r}: launches {rec['launches']}, want {launches}")
    ratio = [rec["theta_bytes"] / one["theta_bytes"] for rec in c]
    lay = {kind: [rec["layers"][kind] for rec in c]
           for kind in ("mlstm", "slstm")}
    log(f"{tag} on one card, tensor-parallel compute (each rank "
        f"{H // TP_RANKS} of {H} heads of every mLSTM and sLSTM block, half "
        f"the tied vocab; "
        f"leaves used at "
        + ", ".join(f"{k.split('.', 2)[-1]} {tuple(v)}"
                    for k, v in want.items())
        + ", no gather over 'model'), full width, "
        f"{XLSTM_TRAIN_LAYERS} layers, B={TP_XL_BATCH}, T={TP_XL_SEQ}, NGHF "
        f"({FSDP_RANK_ITERS['cg_iters']} CG, {FSDP_RANK_ITERS['ng_iters']} NG "
        f"iterations), warm start, Fisher diagonal: vs one process {text}; "
        f"last-iterate Δθ rel-L2 {rel:.4g} (limit {TP_DELTA_REL_L2}); ranks "
        f"equal on every replicated leaf; θ-sized bytes a rank "
        + ", ".join(str(r["theta_bytes"]) for r in c)
        + f" against one process's {one['theta_bytes']} (ratio "
        + ", ".join(f"{x:.4f}" for x in ratio) + "); peak device memory a "
        "rank " + ", ".join(f"{r['peak'] / 1e9:.3f}" for r in c)
        + f" GB (one process {one['peak'] / 1e9:.3f} GB); update with "
        "candidates " + ", ".join(f"{r['s']:.3f}" for r in c)
        + " s a rank, without " + ", ".join(f"{r['s_last']:.3f}" for r in c)
        + f" s (one process {one['s']:.3f} s); {per} cg_fused_update "
        "launches a rank; " + "; ".join(
            f"{kind} layer's forward split "
            + ", ".join(f"{x['split_ms']:.3f}" for x in v)
            + " ms vs gathered whole " + ", ".join(f"{x['whole_ms']:.3f}"
                                                   for x in v)
            + " ms a rank (turns " + "; ".join(
                str({k: [round(t, 3) for t in tt]
                     for k, tt in x["turns"].items()}) for x in v)
            + "), outputs rel-L2 " + ", ".join(f"{x['rel']:.3g}" for x in v)
            for kind, v in lay.items()))
    return {"tp_xlstm_gloo_update_s": [x["s"] for x in c],
            "tp_xlstm_gloo_theta_ratio": ratio,
            "tp_xlstm_gloo_peak_gb": [x["peak"] / 1e9 for x in c],
            "tp_xlstm_gloo_delta_rel_l2": rel,
            "tp_xlstm_gloo_launches_per": per}


def tp_check_whisper(one: dict, d_: list) -> dict:
    """(d)'s checks: the gradient against one process's, the leaves used
    at their split shapes (the vocab whole) with no gather over "model",
    a finite Adam step; the log line."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.encdec import DEC_POSITIONS
    cfg = get_config(LM_TRAIN_ARCH)
    tag = f"gloo 1x2 {LM_TRAIN_ARCH}"
    d, hq = cfg.d_model, cfg.num_heads * cfg.resolved_head_dim
    want = {"encoder.layer0.attn.wq": [d, hq // TP_RANKS],
            "decoder.layer0.self_attn.wo": [hq // TP_RANKS, d],
            "decoder.layer0.cross_attn.wq": [d, hq // TP_RANKS],
            "decoder.layer0.cross_attn.wk": [d, hq // TP_RANKS],
            "encoder.layer0.mlp.w_in": [d, cfg.d_ff // TP_RANKS],
            "dec_pos": [DEC_POSITIONS // TP_RANKS, d],
            "embed.lm_head": [d, cfg.vocab_size // TP_RANKS
                              if cfg.vocab_size % TP_RANKS == 0
                              else cfg.vocab_size]}
    rel = d_[0]["grad_rel"]
    check(all(x["grad_rel"] == rel for x in d_) and rel <= TP_WH_GRAD_REL_L2,
          f"{tag}: gradient vs one process rel-L2 "
          f"{[x['grad_rel'] for x in d_]} (limit {TP_WH_GRAD_REL_L2})")
    for r, rec in enumerate(d_):
        check(all(rec["used"][k] == v for k, v in want.items())
              and rec["used"]["model_gathers"] == 0,
              f"{tag} rank {r}: leaves used at "
              f"{ {k: rec['used'][k] for k in want} }, "
              f"{rec['used']['model_gathers']} gathers over 'model'")
        check(np.isfinite(rec["step_loss"]), f"{tag} rank {r}: Adam step "
              f"loss {rec['step_loss']}")
    log(f"{tag} on one card, tensor-parallel compute (each rank "
        f"{cfg.num_heads // TP_RANKS} of {cfg.num_heads} heads of every "
        f"attention, the cross attention's included, half of every MLP's "
        f"columns and of dec_pos's rows; the {cfg.vocab_size}-token vocab "
        + ("split" if cfg.vocab_size % TP_RANKS == 0 else "whole")
        + "; leaves used at "
        + ", ".join(f"{k} {tuple(v)}" for k, v in want.items())
        + ", no gather over 'model'), full size, B "
        f"{LM_TRAIN_BATCH} x T {LM_TRAIN_SEQ}: gradient vs one process "
        f"rel-L2 {rel:.4g} (limit {TP_WH_GRAD_REL_L2}), loss "
        + ", ".join(f"{x['loss']:.6f}" for x in d_)
        + f" vs {one['loss']:.6f}; gradient " + ", ".join(
            f"{x['grad_s'] * 1e3:.3f}" for x in d_)
        + f" ms a rank (one process {one['grad_s'] * 1e3:.3f} ms); Adam "
        "step " + ", ".join(f"{x['step_s'] * 1e3:.3f}" for x in d_)
        + " ms a rank, loss " + ", ".join(f"{x['step_loss']:.6f}" for x in d_)
        + "; peak device memory a rank " + ", ".join(
            f"{x['peak'] / 1e9:.3f}" for x in d_)
        + f" GB (one process's gradient {one['peak'] / 1e9:.3f} GB)")
    return {"grad_rel": rel, "grad_s": [x["grad_s"] for x in d_],
            "step_s": [x["step_s"] for x in d_]}


def tp_keys(row: dict, tp: dict, name: str, key: str) -> None:
    """Phase 16's keys of a windowed kernel's row: launches a rank on (b)'s
    main path, time and bound at the local shape."""
    t = tp["local"][name]
    row.update({"tp_launches": tp["launches"][key], "tp_ms": t["ms"],
                "tp_bound_ms": t["bound_ms"], "tp_bound_by": t["bound_by"],
                "tp_shape": f"B,T,H,K,hd,window={list(TP_RG_LOCAL)} bf16"})


# ---------------------------------------------------------------------------
# phase 17: serving on a mesh (prefill and decode steps with a mesh, each
# rank holding its share of the caches by ``input_shardings``)
# ---------------------------------------------------------------------------

# (a) world 1 over NCCL: qwen2.5-3b at full width and FSDP_RANK_LAYERS
# layers (2d storage, bf16), a B 2 x T 4096 prefill and 16 decode steps at
# B 8 over 32768 slots (the last 16 positions), each bitwise the no-mesh
# steps' on the same inputs
SM_PREFILL_B, SM_PREFILL_T = 2, 4096
SM_DECODE_B, SM_STEPS = 8, 16
SM_CACHE = DENSE_CACHE
# (b) two gloo ranks of the card on a (1, 2) mesh, against one process on
# the card, at f32 compute for the decode (PERF.md section 2's decode
# rule): qwen2.5-3b's decode over (a)'s 32768 slots, each rank holding
# 16384 of them; recurrentgemma-9b at 3 layers (one period: two RG-LRU
# blocks, a local layer's 2048-slot ring, 1024 a rank), its bf16 prefill
# at B 2 x T 4096 (the local layer's kernel on each rank's 8 heads) and
# 16 decode steps at B 8; each attention decode's 16 positions straddle
# its ring's rank boundary (qwen 16376..16391, recurrentgemma's ring
# slots 1016..1031 at positions 3064..3079, past the ring's length), so
# both ranks write and both combine real keys; xlstm-125m at full depth,
# 16 decode steps at B 128 from the zero state
SM_RANKS = 2
SM_TIMEOUT_S = 600
SM_RG_CACHE = 4096
SM_XL_CACHE = 16
SM_CACHE_SHARE_SLACK = 0.01     # xlstm's m, kept whole on every rank


def sm_cases() -> dict:
    """{name: (f32 config, decode batch, cache slots, first position)} of
    (b)'s decode cases."""
    from repro_torch.configs.base import get_config
    f32 = dict(compute_dtype="float32")
    rg = get_config(LM_ARCH).replace(num_layers=RG_TRAIN_LAYERS, **f32)
    return {
        DENSE_ARCH: (get_config(DENSE_ARCH).replace(
            num_layers=FSDP_RANK_LAYERS, **f32), SM_DECODE_B, SM_CACHE,
            SM_CACHE // SM_RANKS - SM_STEPS // 2),
        LM_ARCH: (rg, SM_DECODE_B, SM_RG_CACHE,
                  SM_RG_CACHE - rg.sliding_window // SM_RANKS
                  - SM_STEPS // 2),
        XLSTM_ARCH: (get_config(XLSTM_ARCH).replace(**f32), XLSTM_DECODE_B,
                     SM_XL_CACHE, 0)}


def sm_tokens(cfg, B: int, dev) -> torch.Tensor:
    """(SM_STEPS, B, 1) decode tokens from a numpy seed."""
    rng = np.random.default_rng(SEED + 17)
    return torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(SM_STEPS, B, 1))).to(dev)


def sm_prefill_batch(cfg, dev) -> dict:
    from repro_torch.data.synthetic import lm_batch
    return lm_batch(0, batch=SM_PREFILL_B, seq_len=SM_PREFILL_T,
                    vocab=cfg.vocab_size, device=dev)


def sm_decode(step, params, cache, tokens, start: int):
    """SM_STEPS decode steps from position ``start``: (logits (steps, B,
    V) f32, ms a step, each between two synchronizes)."""
    out, ms = [], []
    for t in range(tokens.shape[0]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = step(params, cache, tokens[t], start + t)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits[:, 0])
    return torch.stack(out), ms


def rel_max(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def cache_bytes(cache: dict) -> int:
    return sum(v.numel() * v.element_size() for v in cache.values())


def serve_world1(dev) -> dict:
    """(a): the prefill and decode steps on a world-1 NCCL mesh against
    the no-mesh steps on the same inputs."""
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import init_distributed, make_debug_mesh
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models.registry import get_model
    init_distributed(dev)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          "phase 17: no world-1 NCCL group")
    mesh = make_debug_mesh(1, 1, device=dev)
    cfg = get_config(DENSE_ARCH).replace(num_layers=FSDP_RANK_LAYERS)
    model = get_model(cfg)
    params = model.init(SEED, device=dev)
    ss = param_shardings(cfg, mesh, params)
    mine = {k: ss[k].place(v) for k, v in params.items()}
    batch = sm_prefill_batch(cfg, dev)
    plain = build_prefill_step(cfg)(params, batch)
    on = build_prefill_step(cfg, mesh=mesh)(mine, batch)
    check(on.shape == plain.shape == (SM_PREFILL_B, 1, cfg.vocab_size)
          and bool(torch.isfinite(on).all()), "phase 17 (a): prefill shape")
    rel_p = rel_max(on, plain)
    tokens = sm_tokens(cfg, SM_DECODE_B, dev)
    start = SM_CACHE - SM_STEPS
    c0 = model.init_cache(SM_DECODE_B, SM_CACHE, device=dev)
    d0, ms0 = sm_decode(build_serve_step(cfg), params, c0, tokens, start)
    c1 = model.init_cache(SM_DECODE_B, SM_CACHE, mesh=mesh)
    d1, ms1 = sm_decode(build_serve_step(cfg, mesh=mesh), mine, c1, tokens,
                        start)
    rel_d = rel_max(d1, d0)
    same = (torch.equal(on, plain), torch.equal(d1, d0),
            all(torch.equal(c1[k], c0[k]) for k in c0))
    check(all(same), f"phase 17 (a): the mesh's prefill, decode logits, "
          f"caches bitwise the no-mesh steps' {same} (rel max {rel_p:.3g}, "
          f"{rel_d:.3g})")
    log(f"phase 17 (a) world 1 over NCCL, {DENSE_ARCH} at full width and "
        f"{FSDP_RANK_LAYERS} layers (2d storage, bf16): prefill B="
        f"{SM_PREFILL_B} x T={SM_PREFILL_T} on the mesh bitwise the no-mesh "
        f"step's; {SM_STEPS} decode steps at B={SM_DECODE_B} over {SM_CACHE} "
        f"slots (positions {start}..{SM_CACHE - 1}): logits and caches "
        f"bitwise; ms a step on the mesh "
        f"{[round(x, 3) for x in ms1]}, without {[round(x, 3) for x in ms0]}")
    dist.destroy_process_group()
    del params, mine, c0, c1
    torch.cuda.empty_cache()
    return {"prefill_rel": rel_p, "decode_rel": rel_d,
            "ms_mesh": ms1, "ms_plain": ms0}


def serve_one_process(dev, tmp: str) -> dict:
    """(b)'s references on the card, saved to ``tmp``: each case's decode
    logits, and recurrentgemma-9b's bf16 prefill logits; the whole
    caches' bytes and the decode's ms a step."""
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models.registry import get_model
    out = {}
    for name, (cfg, B, slots, start) in sm_cases().items():
        model = get_model(cfg)
        params = model.init(SEED, device=dev)
        rec = {}
        if name == LM_ARCH:
            cfg16 = cfg.replace(compute_dtype="bfloat16")
            torch.save(build_prefill_step(cfg16)(
                params, sm_prefill_batch(cfg, dev)).cpu(),
                Path(tmp, f"{name}_prefill.pt"))
        cache = model.init_cache(B, slots, device=dev)
        logits, rec["ms"] = sm_decode(build_serve_step(cfg), params, cache,
                                      sm_tokens(cfg, B, dev), start)
        rec["cache_bytes"] = cache_bytes(cache)
        torch.save(logits.cpu(), Path(tmp, f"{name}_decode.pt"))
        out[name] = rec
        del params, cache, logits
        torch.cuda.empty_cache()
    return out


def serve_rank(rank: int, world: int, tmp: str, device: str) -> None:
    """One of (b)'s gloo ranks on the card, a (1, world) mesh: each case's
    parameters placed as its shares, recurrentgemma-9b's sharded bf16
    prefill (its kernel launches counted), each case's decode on its
    cache shares; logits, cache bytes, peak memory and ms a step written
    to ``tmp``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models.registry import get_model
    try:
        dev = torch.device(device)
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
            rank=rank, world_size=world)
        mesh = make_debug_mesh(1, world, device=dev, backend="gloo")
        recs = {}
        for name, (cfg, B, slots, start) in sm_cases().items():
            model = get_model(cfg)
            whole = model.init(SEED, device=dev)
            ss = param_shardings(cfg, mesh, whole)
            mine = {k: ss[k].place(v) for k, v in whole.items()}
            del whole
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            rec = {}
            if name == LM_ARCH:
                cfg16 = cfg.replace(compute_dtype="bfloat16")
                step = build_prefill_step(cfg16, mesh=mesh)
                batch = sm_prefill_batch(cfg, dev)
                step(mine, batch)                       # warm
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = step(mine, batch)
                torch.cuda.synchronize()
                rec["prefill_ms"] = (time.perf_counter() - t0) * 1e3
                rec["prefill_launches"] = list(swa_counts())
                torch.save(logits.cpu(), Path(tmp, f"{name}_prefill{rank}.pt"))
            cache = model.init_cache(B, slots, mesh=mesh)
            rec["cache_bytes"] = cache_bytes(cache)
            reset_counts()
            logits, rec["ms"] = sm_decode(build_serve_step(cfg, mesh=mesh),
                                          mine, cache, sm_tokens(cfg, B, dev),
                                          start)
            rec["decode_swa"] = list(swa_counts())
            rec["peak"] = torch.cuda.max_memory_allocated()
            torch.save(logits.cpu(), Path(tmp, f"{name}_decode{rank}.pt"))
            recs[name] = rec
            del mine, cache, logits
            torch.cuda.empty_cache()
        coord = dict(zip(mesh.axis_names, mesh.device_mesh.get_coordinate()))
        recs["model_index"] = coord["model"]
        dist.barrier()
        dist.destroy_process_group()
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(recs, f)
    except BaseException:
        import traceback
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def phase_serve_mesh(dev) -> dict:
    """Phase 17: the prefill and decode steps on a mesh, (a) at world 1
    over NCCL against the no-mesh steps, (b) on two gloo ranks of the card
    (1x2) against one process: logits, each rank's cache bytes against
    one process's, peak memory, ms a step (gloo: every collective staged
    through the host)."""
    import tempfile
    t_phase = time.perf_counter()
    out = {"world1": serve_world1(dev)}
    t_a = time.perf_counter() - t_phase
    with tempfile.TemporaryDirectory() as tmp:
        one = serve_one_process(dev, tmp)
        spawn_ranks(serve_rank, SM_RANKS, dev, SM_TIMEOUT_S, tmp)
        recs = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                for r in range(SM_RANKS)]
        logits = {name: ([torch.load(Path(tmp, f"{name}_decode{r}.pt"))
                          for r in range(SM_RANKS)],
                         torch.load(Path(tmp, f"{name}_decode.pt")))
                  for name in one}
        pre = ([torch.load(Path(tmp, f"{LM_ARCH}_prefill{r}.pt"))
                for r in range(SM_RANKS)],
               torch.load(Path(tmp, f"{LM_ARCH}_prefill.pt")))
    card = card_line()
    for name, (cfg, B, slots, start) in sm_cases().items():
        ranks, want = logits[name]
        rel = [rel_max(got, want) for got in ranks]
        ratio = [rec[name]["cache_bytes"] / one[name]["cache_bytes"]
                 for rec in recs]
        check(max(rel) <= DECODE_REL, f"phase 17 (b) {name}: decode logits "
              f"rel max {rel} against one process (limit {DECODE_REL})")
        check(all(0.5 <= x <= 0.5 + SM_CACHE_SHARE_SLACK for x in ratio),
              f"phase 17 (b) {name}: cache bytes a rank {ratio} of one "
              f"process's")
        check(all(rec[name]["decode_swa"] == [0, 0] or name == LM_ARCH
                  for rec in recs), f"phase 17 (b) {name}: a decode step "
              f"launched swa_attention")
        log(f"phase 17 (b) gloo 1x2 on one card [{card}], {name} "
            f"(f32 compute, {cfg.num_layers} layers), {SM_STEPS} decode "
            f"steps at B={B} from position {start} over {slots} slots: "
            f"logits vs one process rel max "
            + ", ".join(f"{x:.3g}" for x in rel)
            + f" (limit {DECODE_REL}); cache bytes a rank "
            + ", ".join(str(rec[name]["cache_bytes"]) for rec in recs)
            + f" against one process's {one[name]['cache_bytes']} (ratio "
            + ", ".join(f"{x:.4f}" for x in ratio)
            + "); peak device memory a rank "
            + ", ".join(f"{rec[name]['peak'] / 1e9:.3f}" for rec in recs)
            + " GB; gloo (host-staged) ms a step, median a rank "
            + ", ".join(f"{float(np.median(rec[name]['ms'])):.3f}"
                        for rec in recs)
            + f" (one process on the card "
            f"{float(np.median(one[name]['ms'])):.3f})")
        out[name] = {"rel": rel, "ratio": ratio,
                     "ms": [float(np.median(rec[name]["ms"]))
                            for rec in recs],
                     "peak_gb": [rec[name]["peak"] / 1e9 for rec in recs]}
    ranks, want = pre
    rel = [rel_max(got, want) for got in ranks]
    l2 = [float((got.float() - want.float()).norm() / want.float().norm())
          for got in ranks]
    launches = [rec[LM_ARCH]["prefill_launches"] for rec in recs]
    check(max(l2) <= PREFILL_BF16_REL_L2, f"phase 17 (b) {LM_ARCH}: bf16 "
          f"prefill on 1x2 vs one process rel-L2 {l2}")
    check(all(x == [RG_TRAIN_LAYERS // 3, 0] for x in launches),
          f"phase 17 (b) {LM_ARCH}: the sharded prefill's swa_attention "
          f"launches (tensor-core, CUDA-core) a rank {launches}")
    heads = sm_cases()[LM_ARCH][0].num_heads
    log(f"phase 17 (b) gloo 1x2, {LM_ARCH} bf16 prefill B={SM_PREFILL_B} x "
        f"T={SM_PREFILL_T} on each rank's {heads // SM_RANKS} of {heads} "
        f"heads, the stream split over T: logits vs one process rel-L2 "
        + ", ".join(f"{x:.3g}" for x in l2)
        + f" (limit {PREFILL_BF16_REL_L2}), rel max "
        + ", ".join(f"{x:.3g}" for x in rel)
        + f"; swa_attention launches (tensor-core, CUDA-core) a rank "
        f"{launches}; ms a rank (gloo) "
        + ", ".join(f"{rec[LM_ARCH]['prefill_ms']:.3f}" for rec in recs))
    out["prefill"] = {"rel_l2": l2, "launches": launches[0][0],
                      "ms": [rec[LM_ARCH]["prefill_ms"] for rec in recs]}
    dt = time.perf_counter() - t_phase
    log(f"phase 17 (serving on a mesh) {dt:.3f} s ((a) {t_a:.3f})")
    return out


# ---------------------------------------------------------------------------
# Phase 18: the kernel sanitizer on the card
# ---------------------------------------------------------------------------

def phase_sanitizer(dev) -> dict:
    """Phase 18: ``sanitize_kernels.run_sanitize`` and ``self_test`` on the
    card; every launcher run on its route (the tensor-core attention at
    hd_pad 64, 128 and 256, the DAG kernels with their state in global
    scratch, ``sausage_loss_only`` spilled), records equal to launches;
    the launches per launcher and the KS001 facts logged."""
    from repro_torch.analysis import rules_kernel, sanitize_kernels
    t0 = time.perf_counter()
    report, failures = sanitize_kernels.run_sanitize(dev)
    check(not failures, f"phase 18: {len(failures)} sanitizer failures, "
          f"first {failures[:3]}")
    problems = sanitize_kernels.self_test(dev)
    check(not problems, f"phase 18: {problems}")
    missing = sorted(set(rules_kernel.STEM_OF) - set(report["launches"]))
    check(not missing, f"phase 18: launchers never run: {missing}")
    check(report["records"] == report["build_launches"],
          f"phase 18: {report['records']} records, "
          f"{report['build_launches']} build.launch calls")
    for name, facts in report["ks001"].items():
        want = "bfloat16" if "sm90" in name else "float32"
        check(want in facts["dtype"],
              f"phase 18: {name} never ran at {want} ({facts['dtype']})")
    static = report["static_smem"]
    log(f"phase 18 kernel sanitizer on {card_line()}: 0 failures over "
        f"{len(report['cases'])} cases, {report['records']} captured "
        f"launches == {report['build_launches']} build.launch calls; "
        f"mutants flagged (KS003 off-by-one frontier, KS005 bf16 sums)")
    for name in sorted(rules_kernel.STEM_OF):
        facts = {k: v for k, v in report["ks001"][name].items()
                 if k != "dtype"}
        log(f"phase 18 {name} ({rules_kernel.STEM_OF[name]}): "
            f"{report['launches'][name]} launches at "
            f"{report['ks001'][name]['dtype']}; KS001 {facts}, static "
            f"shared bytes {static.get(name)} (ptxas)")
    dt = time.perf_counter() - t0
    log(f"phase 18 (kernel sanitizer) {dt:.3f} s")
    return {"s": dt, "launches": report["launches"]}


PHASE_S: dict = {}              # phase function -> its seconds in this run


def timed(fn, *args):
    """``fn(*args)``, its seconds kept in ``PHASE_S`` for the summary."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[fn.__name__[len("phase_"):]] = time.perf_counter() - t0
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("[chip_smoke] torch.cuda.is_available() is False: this "
              "script runs the port on a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for line in build.build_log("lattice_dag").splitlines():
        if any(w in line for w in ("registers", "spill", "entry function")):
            log(f"ptxas: {line.strip()}")
    for stem in ("lattice_sausage", "cg_fused", "swa_attention",
                 "swa_attention_sm90", "swa_attention_bwd",
                 "swa_attention_bwd_sm90"):
        for line in build.build_log(stem).splitlines():
            if any(w in line for w in ("registers", "spill", "C7519",
                                       "C7520", "wgmma")):
                log(f"ptxas {stem}: {line.strip()}")
    # the tensor-core derivatives: no spill, no serialised wgmma
    sm90_bwd = build.build_log("swa_attention_bwd_sm90")
    check(not re.search(r"\(C75(19|20)\)|\b[1-9][0-9]* bytes spill",
                        sm90_bwd),
          "ptxas: swa_attention_bwd_sm90 spills or serialises a wgmma")
    from repro_torch.kernels import swa_attention as SWA
    log("swa_attention_sm90 dynamic shared memory at hd_pad 64/128/256: "
        + "/".join(str(SWA.sm90_smem_bytes(p)) for p in (64, 128, 256))
        + " bytes")
    for kern in ("dq", "dkdv", "jvp"):
        log(f"swa_attention_bwd_sm90 {kern} dynamic shared memory at hd_pad "
            f"64/128/256: " + "/".join(
                str(SWA.sm90_bwd_smem_bytes(kern, p)) for p in (64, 128, 256))
            + " bytes")
    errs: dict = {}
    timed(phase_kernels, dev, errs)
    timed(phase_sausage_kernels, dev, errs)
    timed(phase_swa_kernel, dev, errs)
    service = timed(phase_service, dev)
    stream = timed(phase_streaming, dev, errs)
    training = timed(phase_training, dev)
    kernels = dag_times(service, stream, training, errs) \
        + train_times(training, errs)
    kernel_path = training["kernel_path"]
    del service, stream, training
    torch.cuda.empty_cache()
    timed(phase_cli, dev)
    torch.cuda.empty_cache()
    lm_train = timed(phase_lm_train, dev)
    cg_row = next(k for k in kernels if k["name"] == "cg_fused_update")
    cg_row.update(lm_cg_times(lm_train, dev))
    torch.cuda.empty_cache()
    dense = timed(phase_dense, dev)
    cg_row.update(dense_cg_times(dense, dev))
    dense_path = dense["training"].pop("kernel_path")
    dense_log = dense["training"]["log"]
    del dense
    torch.cuda.empty_cache()
    moe = timed(phase_moe, dev, errs)
    cg_row.update(moe_cg_times(moe, dev))
    swa_moe = moe["mixtral"]["swa"]
    del moe
    torch.cuda.empty_cache()
    xl = timed(phase_xlstm, dev)
    cg_row.update(xlstm_cg_times(xl, dev))
    del xl
    torch.cuda.empty_cache()
    rg = timed(phase_rg_train, dev, errs)
    torch.cuda.empty_cache()
    cg_row.update(timed(phase_mesh, dev, errs, kernel_path))
    cg_row.update(timed(phase_fsdp, dev, dense_path, dense_log))
    del dense_path
    torch.cuda.empty_cache()
    tp = timed(phase_tp, dev, errs)
    cg_row.update(tp["cg"])
    torch.cuda.empty_cache()
    served = timed(phase_serve_mesh, dev)
    cg_row["max_abs_err"] = max(v for k, v in errs.items()
                                if k.startswith("cg_fused_update["))
    torch.cuda.empty_cache()
    lm = timed(phase_lm, dev)
    kernels.append(swa_times(lm, errs, dev))
    kernels[-1].update(swa_moe)
    kernels += bwd_entries(rg, errs)
    tp_keys(kernels[-4], tp, "swa_attention", "forward")
    kernels[-4].update(serve_mesh_launches=served["prefill"]["launches"],
                       serve_mesh_prefill_ms=served["prefill"]["ms"])
    for row, key in zip(kernels[-3:], ("dq", "dkdv", "jvp")):
        tp_keys(row, tp, row["name"], key)
    torch.cuda.empty_cache()
    timed(phase_sanitizer, dev)
    check(len(kernels) == len(TPU_KERNELS) + len(BWD_KERNELS),
          "a kernel has no entry")
    log("phase seconds: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in PHASE_S.items()))
    log(f"total {time.perf_counter() - t_start:.3f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
